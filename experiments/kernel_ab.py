"""Each GPU kernel against the plain XLA formulation, end to end.

Device time of the batched 4-camera step (bench.measure_device_sustained:
scan-length differencing of the full device program, in-graph finishing
included) on the bench rig at resampling_factor 1.25, sparse and dense
scenes, with the named kernels switched on and XLA everywhere else.
Variants run in turns (forward, then reverse order), so each one is
measured twice.

    python experiments/kernel_ab.py [--factor 1.25] [--variants ...]
                                    [--out FILE.json]

Needs the GPU; exits non-zero on any other platform.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


VARIANTS = {  # name -> the kernels switched on
    "xla": (),
    "blob_response": ("blob_response",),
    "query_select": ("query_select",),
    "blob_response+query_select": ("blob_response", "query_select"),
}


def _select(kernels):
    """Switch the kernel gates: only ``kernels`` run, the rest is XLA."""
    import jax

    from vision_processor_tpu.ops import pipeline, topk

    pipeline.use_gpu_kernels = lambda: "blob_response" in kernels
    topk.use_gpu_kernels = lambda: "query_select" in kernels
    jax.clear_caches()


def _measure(name, rolls, rigs, refs, marks, results):
    import bench

    for scene in ("sparse", "dense"):
        rig = rigs[scene]
        ms, _, counts, aux = bench.measure_device_sustained(
            rolls, rig[0], rig[1], *rig[2:7], refs, marks)
        found, total = bench.bot_recall(aux["compact"], rig[9])
        results[name][f"{scene}_ms"].append(ms * 1e3)
        results[name][f"{scene}_recall"] = f"{found}/{total}"
        results[name][f"{scene}_blob_counts"] = counts
        print(f"{name:14s} {scene:6s} {ms * 1e3:8.4f} ms/frame-set "
              f"recall {found}/{total} blobs {counts} "
              f"inner {aux['ms_band_inner']}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--factor", type=float, default=1.25)
    ap.add_argument("--variants", nargs="+", choices=list(VARIANTS),
                    default=list(VARIANTS))
    ap.add_argument("--out", default="chiprun_out/kernel_ab.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from vision_processor_tpu.utils import setup_compile_cache

    setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"kernel_ab needs the GPU, found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; jax: {dev.device_kind} x{len(jax.devices())}",
          flush=True)

    import bench
    from vision_processor_tpu.models.colors import ColorState
    from vision_processor_tpu.models.device_finish import pack_field_marks

    rigs = {
        "sparse": bench.build_rig(resampling_factor=args.factor,
                                  return_scenes=True),
        "dense": bench.build_rig(dense=True, dense_blobs=1900,
                                 resampling_factor=args.factor,
                                 return_scenes=True),
    }
    cams = rigs["sparse"][8]
    n_cams = rigs["sparse"][0].n_cams
    marks_one = pack_field_marks(cams[0][1].field, 10.0)
    marks = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                         *([marks_one] * n_cams))
    refs = jnp.asarray(np.stack([ColorState().packed_refs()] * n_cams))

    order = args.variants + args.variants[::-1]
    results = {name: {"sparse_ms": [], "dense_ms": []}
               for name in args.variants}
    for name in order:
        _select(VARIANTS[name])
        t0 = time.perf_counter()
        try:
            rolls = bench.build_rollouts(rigs["sparse"][0])
            _measure(name, rolls, rigs, refs, marks, results)
        except Exception as exc:  # a variant that fails is reported, not fatal
            print(f"{name}: FAILED {type(exc).__name__}: {exc}", flush=True)
        print(f"{name:14s} wall incl. compile "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    summary = {
        "card": card, "device_kind": dev.device_kind,
        "resampling_factor": args.factor, "variants": results,
    }
    out = REPO / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1))
    for name, r in results.items():
        if r["sparse_ms"]:
            print(f"{name:14s} mean sparse {np.mean(r['sparse_ms']):.4f} "
                  f"dense {np.mean(r['dense_ms']):.4f} ms/frame-set")


if __name__ == "__main__":
    main()
