"""Smoke test of the production path on one GPU.

    python chip_smoke.py

Runs in one process, so only one process holds the card. Phases, one
line each, then one JSON line last:

* device — the card's name and power limit (nvidia-smi) and JAX's device.
  Any platform but ``gpu`` exits non-zero; there is no CPU fallback.
* kernels — every GPU kernel of the production path against its plain
  XLA formulation at the bench shapes (4 x 1080p RGGB cameras, Div-B
  field, max_blobs=2000, resampling_factor 1.25) on the dense scene,
  where compaction runs at full occupancy; the device camera projection
  against the float64 host model; the memory analysis of the compiled
  4-camera step.
* app — ``app/main.py:main`` in-process with four camera configs and a
  synthetic driver that replays the bench rig's frames. The rig's
  geometry is published on an isolated multicast group; a few frame-sets
  run in the pipelined and in the staggered dispatch mode, at
  resampling_factor 1.25 and 1.0, for the sparse and the dense scene.
  Every planted robot must arrive on the wire with its id within 30 mm,
  and each camera's ball within 40 mm (in the dense scene, where scatter
  balls merge with it, every ball on the wire within 40 mm of a planted
  ball).

A failed check raises: the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

FACTORS = (1.25, 1.0)
FRAMES_PER_RUN = 3
GROUP = "224.99.99.41"
PORT = 17641


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------


def device_phase():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"device: card {card}; jax {jax.devices()} kind {dev.device_kind}")
    return dev


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _xla_response(flat, th, o, r, dr):
    from vision_processor_tpu.ops import blob as B

    circ = B.circularity(B.summed_area_table(B.gradient_dot(flat, o)), r)
    ms, mean, count = B.blob_response(flat, circ, th, dr)
    return ms, circ, mean, count


def _compact(flat, circ, ms, mean, count, max_blobs):
    from vision_processor_tpu.ops import blob as B

    out = B.extract_blobs_scored(flat, circ, ms, mean, count,
                                 max_blobs=max_blobs)
    return {k: np.asarray(v) for k, v in out.items()}


def _disc_stats_f64(flat, iy, ix, radius):
    """Disc colour mean (K, 3) and channel sum of the disc stddev (K,) at
    pixels (iy, ix), in float64 (clamp-to-edge taps, ops/blob.disc_stats)."""
    from vision_processor_tpu.ops.blob import disc_offsets

    h, w = flat.shape[:2]
    offs = disc_offsets(radius)
    yy = np.clip(iy[:, None] + offs[None, :, 0], 0, h - 1)
    xx = np.clip(ix[:, None] + offs[None, :, 1], 0, w - 1)
    v = flat[yy, xx].astype(np.float64)  # (K, taps, 3)
    mean = v.mean(axis=1)
    var = np.maximum((v * v).mean(axis=1) - mean ** 2, 0.0)
    return mean, np.sqrt(var).sum(axis=-1)


def _circ_f64(flat, o, r):
    """ops/blob.py gradient_dot -> summed_area_table -> circularity in
    float64 (numpy), where the SAT's differences lose nothing."""
    f = np.asarray(flat, np.float64)
    h, w = f.shape[:2]
    p = np.pad(f, ((o, o), (o, o), (0, 0)), mode="edge")

    def sl(dy, dx):
        return p[o + dy:o + dy + h, o + dx:o + dx + w]

    g = ((sl(0, o) - sl(0, -o)) * (sl(o, 0) - sl(-o, 0))).sum(-1)
    ps = np.pad(g.cumsum(1).cumsum(0), r, mode="edge")

    def read(dx, dy):
        return ps[r + dy:r + dy + h, r + dx:r + dx + w]

    pp = read(r, r) - read(r, 1) - read(1, r) + read(1, 1)
    pn = read(r, -r) - read(r, -1) - read(1, -r) + read(1, -1)
    np_ = read(-r, r) - read(-r, 1) - read(-1, r) + read(-1, 1)
    nn = read(-r, -r) - read(-r, -1) - read(-1, -r) + read(-1, -1)
    return np.minimum(np.minimum(pp, nn), np.minimum(pn, np_)) / float(r * r)


def check_blob_response(rig) -> None:
    """Both formulations sum the same terms in another order
    (ops/blob_pallas.py), so each is held to float64 sums: circularity
    within 1e-5 of its range (f32 reassociation), disc means within 1e-5 of
    the 255 range, stddev sums within 0.05 dRGB at the kept pixels. The
    blob masks and the compacted blobs must be identical."""
    import jax

    from vision_processor_tpu.ops import frame as F
    from vision_processor_tpu.ops.blob_pallas import blob_response_fused
    from vision_processor_tpu.parallel.multicam import make_resample_grids

    cfg, raws, packed, scales, offsets = rig[:5]
    bm = cfg.bm
    o, r, dr = bm.grad_offset, bm.sat_radius, bm.disc_radius
    th = np.float32(15.0)
    grids = make_resample_grids(cfg, packed, 150.0, scales, offsets)
    resample = jax.jit(F.resample_flat_grid_raw, static_argnums=2)
    ref_fn = jax.jit(_xla_response, static_argnums=(2, 3, 4))
    worst = dict.fromkeys(("circ", "circ_xla", "mean", "mean_xla", "sigma",
                           "sigma_xla", "pos"), 0.0)
    n_blobs = []
    for c in range(cfg.n_cams):
        flat = resample(raws[c], jax.tree.map(lambda x: x[c], grids), bm.fmt)
        ms, circ, mean, count = blob_response_fused(flat, th, o, r, dr)
        with jax.default_matmul_precision("highest"):
            ms_r, circ_r, mean_r, count_r = ref_fn(flat, th, o, r, dr)
        c64 = _circ_f64(flat, o, r)
        for side, v in (("circ", circ), ("circ_xla", circ_r)):
            worst[side] = max(worst[side], float(
                np.abs(np.asarray(v) - c64).max() / (np.abs(c64).max() + 1)))
        a, b = np.asarray(ms), np.asarray(ms_r)
        if not np.array_equal(a > -np.inf, b > -np.inf):
            raise AssertionError(f"camera {c}: blob masks differ")
        # the disc statistics at the kept pixels: the XLA chain's
        # row-prefix sums of squares reach ~5e7, and for near-uniform discs
        # the variance cancellation (E[v^2] - E[v]^2) amplifies their
        # rounding (score = circ / stddev sum, dRGB units)
        keep = b > -np.inf
        iy, ix = np.nonzero(keep)
        mean64, sd64 = _disc_stats_f64(np.asarray(flat), iy, ix, dr)
        sides = {"": (np.stack([np.asarray(m)[keep] for m in mean], -1),
                      np.asarray(circ)[keep] / a[keep]),
                 "_xla": (np.asarray(mean_r)[keep],
                          np.asarray(circ_r)[keep] / b[keep])}
        for side, (mk, sd) in sides.items():
            worst["mean" + side] = max(worst["mean" + side], float(
                np.abs(mk - mean64).max(initial=0.0) / 255.0))
            worst["sigma" + side] = max(worst["sigma" + side], float(
                np.abs(sd - sd64).max(initial=0.0)))
        got = _compact(flat, circ, ms, mean, count, bm.max_blobs)
        ref = _compact(flat, circ_r, ms_r, mean_r, count_r, bm.max_blobs)
        if int(got["count"]) != int(ref["count"]):
            raise AssertionError(
                f"camera {c}: {got['count']} vs {ref['count']} candidates")
        gv, rv = got["valid"], ref["valid"]
        if gv.sum() != rv.sum():
            raise AssertionError(f"camera {c}: {gv.sum()} vs {rv.sum()} blobs")
        # slot order follows the score, so the sets are matched by
        # position. The sub-pixel peak divides circ differences (the SAT
        # chain's rounding: a few 1e-2 at magnitudes ~5e3) by the peak's
        # curvature, hence 0.01 px (0.06 mm on the field)
        d = np.linalg.norm(got["pos"][gv][:, None] - ref["pos"][rv][None],
                           axis=-1)
        dmax = max(d.min(0).max(), d.min(1).max()) if d.size else 0.0
        worst["pos"] = max(worst["pos"], float(dmax))
        if dmax > 0.01:
            raise AssertionError(
                f"camera {c}: compacted blobs differ by {dmax} px")
        n_blobs.append(int(gv.sum()))
    if worst["circ"] > 1e-5 or worst["mean"] > 1e-5 or worst["sigma"] > 0.05:
        raise AssertionError(f"blob response beyond tolerance: {worst}")
    log(f"kernels: blob_response vs XLA on {cfg.n_cams} cameras "
        f"{bm.flat_shape}, each against float64: circ {worst['circ']:.2e} "
        f"(XLA chain {worst['circ_xla']:.2e}), at kept pixels: mean "
        f"{worst['mean']:.2e} (XLA chain {worst['mean_xla']:.2e}), stddev "
        f"sum {worst['sigma']:.2e} (XLA chain {worst['sigma_xla']:.2e}); "
        f"compacted blobs identical "
        f"({n_blobs} per camera, positions within {worst['pos']:.1e} px)")


def check_query_select(rig) -> None:
    """Kernel indices identical to the XLA argmax passes on the dense
    scene's compacted blobs: anchor rings by rank and tracked-slot
    candidates by distance, at the detector's shapes."""
    import jax
    import jax.numpy as jnp

    from vision_processor_tpu.ops import topk as T

    cfg = rig[0]
    det = cfg.det
    blobs = _dense_blobs(rig)
    rng = np.random.default_rng(0)
    checked = []
    for c in range(cfg.n_cams):
        pos = jnp.asarray(blobs["field_pos"][c])
        valid = blobs["valid"][c]
        rank = jnp.asarray(np.where(valid, np.arange(len(valid)), np.inf),
                           jnp.float32)
        a = det.max_anchors
        anchors = pos[:a]
        queries = pos[: det.max_tracked * 5] + jnp.asarray(
            rng.normal(0, 8, (det.max_tracked * 5, 2)), jnp.float32)
        cases = [
            (anchors, jnp.full((a,), 90.0 ** 2), rank, det.ring_size, True),
            (queries, jnp.full((queries.shape[0],), 30.0 ** 2),
             jnp.where(jnp.asarray(valid), 0.0, jnp.inf),
             det.tracked_candidates, False),
        ]
        for q, r2, rk, m, by_rank in cases:
            kv, ki = jax.jit(T._query_select_kernel, static_argnums=(4, 5, 6))(
                q, r2, pos, rk, m, by_rank, False)
            with jax.default_matmul_precision("highest"):
                xv, xi = jax.jit(T._query_select_xla, static_argnums=(4, 5))(
                    q, r2, pos, rk, m, by_rank)
            kv, ki, xv, xi = map(np.asarray, (kv, ki, xv, xi))
            if not np.array_equal(ki, xi):
                raise AssertionError(f"camera {c}: query_select indices differ")
            ok = xv > -np.inf
            if not np.array_equal(kv > -np.inf, ok):
                raise AssertionError(f"camera {c}: query_select validity differs")
            np.testing.assert_allclose(kv[ok], xv[ok], rtol=1e-6, atol=1e-3)
            checked.append(int(ok.sum()))
    log(f"kernels: query_select_topk vs XLA on {cfg.n_cams} cameras "
        f"({det.max_anchors} anchors x {cfg.bm.max_blobs} blobs, m="
        f"{det.ring_size}; {det.max_tracked * 5} tracked slots, m="
        f"{det.tracked_candidates}): indices identical, "
        f"{sum(checked)} valid selections")


def _dense_blobs(rig):
    """Compacted blobs of the dense frame-set (production step)."""
    import jax

    from vision_processor_tpu.app.processor import TrackedArrays
    from vision_processor_tpu.parallel.multicam import (
        batched_step_host_tracked, make_resample_grids)

    cfg, raws, packed, scales, offsets, colors, params = rig[:7]
    grids = make_resample_grids(cfg, packed, 150.0, scales, offsets)
    tracked = TrackedArrays.build({}, 0.0, cfg.det.max_tracked).as_dict()
    blobs, _ = batched_step_host_tracked(cfg)(
        raws, packed, scales, offsets, colors, tracked, params, grids)
    return jax.device_get(blobs)


def check_detections(rig) -> None:
    """The production step (kernels) and the all-XLA step (reference,
    highest matmul precision) emit identical detections. Blob slots follow
    the score, whose last bits differ, so robots (id + world position) and
    balls (world position) are compared as sets, positions within 0.01 mm."""
    import jax

    from vision_processor_tpu.ops import pipeline, topk

    out = {"kernels": _detections(rig)}
    saved = pipeline.use_gpu_kernels, topk.use_gpu_kernels
    pipeline.use_gpu_kernels = topk.use_gpu_kernels = lambda: False
    jax.clear_caches()
    try:
        with jax.default_matmul_precision("highest"):
            out["xla"] = _detections(rig)
    finally:
        pipeline.use_gpu_kernels, topk.use_gpu_kernels = saved
        jax.clear_caches()
    k, x = out["kernels"], out["xla"]
    robots = balls = 0
    worst = 0.0
    for c in range(len(k["bot_valid"])):
        sets = []
        for f in (k, x):
            v, bv = f["bot_valid"][c], f["ball_valid"][c]
            sets.append((f["bot_id"][c][v], f["bot_world"][c][v][:, :2],
                         f["ball_world"][c][bv][:, :2]))
        (ik, rk, bk), (ix, rx, bx) = sets
        for kind, pk, px, same in (("robots", rk, rx, ik[:, None] == ix[None]),
                                   ("balls", bk, bx, True)):
            d = np.linalg.norm(pk[:, None] - px[None], axis=-1)
            d = np.where(same, d, np.inf)
            if len(pk) != len(px) or (d.size and max(
                    d.min(0).max(), d.min(1).max()) > 0.01):
                raise AssertionError(
                    f"camera {c}: {kind} differ from the XLA step "
                    f"({len(pk)} vs {len(px)})")
            if d.size:
                worst = max(worst, float(d.min(1).max()))
        robots += len(rk)
        balls += len(bk)
    log(f"kernels: detections identical to the all-XLA step on the dense "
        f"frame-set ({robots} robots with ids, {balls} balls; max position "
        f"diff {worst:.2e} mm)")


def _detections(rig):
    import jax

    from vision_processor_tpu.app.processor import TrackedArrays
    from vision_processor_tpu.parallel.multicam import (
        batched_step_host_tracked, make_resample_grids)

    cfg, raws, packed, scales, offsets, colors, params = rig[:7]
    refs, marks = _finish_inputs(rig)
    grids = make_resample_grids(cfg, packed, 150.0, scales, offsets)
    tracked = TrackedArrays.build({}, 0.0, cfg.det.max_tracked).as_dict()
    _, _, fin = batched_step_host_tracked(cfg)(
        raws, packed, scales, offsets, colors, tracked, params, grids,
        refs, marks)
    return {k: np.asarray(v) for k, v in jax.device_get(fin).items()}


def _finish_inputs(rig):
    import jax
    import jax.numpy as jnp

    from vision_processor_tpu.models.colors import ColorState
    from vision_processor_tpu.models.device_finish import pack_field_marks

    cfg, cams = rig[0], rig[8]
    marks_one = pack_field_marks(cams[0][1].field, 10.0)
    marks = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                         *([marks_one] * cfg.n_cams))
    refs = jnp.asarray(np.stack([ColorState().packed_refs()] * cfg.n_cams))
    return refs, marks


def check_projection(rig) -> None:
    """field2image_packed (f32, device) against the float64 host model over
    every flat-grid point of every camera: within 0.01 px, the f32
    rounding of ~1000 px image coordinates being ~1e-4 px."""
    import jax
    import jax.numpy as jnp

    from vision_processor_tpu.models.camera import field2image_packed

    cfg, packed, scales, offsets, cams = rig[0], rig[2], rig[3], rig[4], rig[8]
    hf, wf = cfg.bm.flat_shape
    project = jax.jit(field2image_packed)
    worst = 0.0
    for c, (model, _) in enumerate(cams):
        xs = offsets[c][0] + np.arange(wf) * scales[c]
        ys = offsets[c][1] + np.arange(hf) * scales[c]
        gx, gy = np.meshgrid(xs, ys)
        pts = np.stack([gx, gy, np.full_like(gx, 150.0)], axis=-1)
        dev = np.asarray(project(jnp.asarray(packed[c]),
                                 jnp.asarray(pts, jnp.float32)))
        host = model.field2image(pts.astype(np.float32).astype(np.float64))
        ok = np.isfinite(host).all(-1)
        worst = max(worst, float(np.abs(dev[ok] - host[ok]).max()))
    if worst > 0.01:
        raise AssertionError(f"device projection off by {worst} px")
    log(f"kernels: field2image_packed vs float64 host model over "
        f"{cfg.n_cams} x {hf}x{wf} grid points: max {worst:.2e} px "
        f"(limit 0.01)")


def memory_analysis(rig) -> None:
    import jax

    from vision_processor_tpu.app.processor import TrackedArrays
    from vision_processor_tpu.parallel.multicam import (
        batched_step_host_tracked, make_resample_grids)

    cfg, raws, packed, scales, offsets, colors, params = rig[:7]
    refs, marks = _finish_inputs(rig)
    grids = make_resample_grids(cfg, packed, 150.0, scales, offsets)
    tracked = TrackedArrays.build({}, 0.0, cfg.det.max_tracked).as_dict()
    t0 = time.perf_counter()
    compiled = batched_step_host_tracked(cfg).lower(
        raws, packed, scales, offsets, colors, tracked, params, grids,
        refs, marks).compile()
    log(f"kernels: 4-camera step compiled in {time.perf_counter() - t0:.1f} s;"
        f" memory {compiled.memory_analysis()}")


# ---------------------------------------------------------------------------
# app
# ---------------------------------------------------------------------------


def app_phase(rigs, tmp: Path) -> None:
    run = 0
    for factor in FACTORS:
        for scene in ("sparse", "dense"):
            for mode in ("pipelined", "staggered"):
                _run_app(rigs[scene, factor], factor, scene, mode,
                         PORT + 2 * run, tmp / f"run{run}")
                run += 1


def _run_app(rig, factor, scene_name, mode, port, tmp: Path) -> None:
    import yaml

    from vision_processor_tpu.app.main import main as app_main
    from vision_processor_tpu.io.camera import (
        CameraDriver, RawFrame, register_driver)
    from vision_processor_tpu.net.udp import UDPSocket
    from vision_processor_tpu.proto import SSL_WrapperPacket

    raws, cams, scenes = rig[1], rig[8], rig[9]
    n_cams = len(cams)

    class Replay(CameraDriver):
        """Serves one pre-rendered frame FRAMES_PER_RUN times."""

        def __init__(self, cam_cfg):
            self.raw = raws[cam_cfg.id]
            self.size = cams[cam_cfg.id][0].size
            self.idx = 0

        @property
        def fmt(self):
            return "RGGB"

        def expected_frametime(self):
            return 0.01

        def read_image(self):
            if self.idx >= FRAMES_PER_RUN:
                return None
            self.idx += 1
            return RawFrame(data=self.raw, fmt="RGGB",
                            width=int(self.size[0]), height=int(self.size[1]))

    register_driver("SMOKE_REPLAY", Replay)

    tmp.mkdir(parents=True)
    paths = []
    for c in range(n_cams):
        cfg = {
            "cam_id": c,
            "bot_heights_file": str(tmp / "none.yml"),
            "camera": {"driver": "SMOKE_REPLAY", "id": c},
            "network": {"vision_ip": GROUP, "vision_port": port,
                        "gc_ip": GROUP, "gc_port": port + 1},
            "stream": {"active": False},
            "debug": {"wait_for_geometry": True,
                      "debug_stream_interval_ms": 0},
            "thresholds": {"blobs": 2000, "resampling_factor": factor},
        }
        path = tmp / f"cam{c}.yml"
        path.write_text(yaml.safe_dump(cfg))
        paths.append(str(path))

    geometry = SSL_WrapperPacket()
    geometry.geometry.CopyFrom(rig[7])
    geometry.geometry.ClearField("calib")
    for c, (model, _) in enumerate(cams):
        geometry.geometry.calib.append(model.to_proto(c))

    detections = {c: [] for c in range(n_cams)}

    class Bus(UDPSocket):
        def _parse(self, data):
            wrapper = SSL_WrapperPacket()
            wrapper.ParseFromString(data)
            if wrapper.HasField("detection"):
                detections[wrapper.detection.camera_id].append(
                    wrapper.detection)

    bus = Bus(GROUP, port)
    stop = threading.Event()

    def publish():
        while not stop.is_set():
            bus.send(geometry)
            time.sleep(0.05)

    publisher = threading.Thread(target=publish, daemon=True)
    publisher.start()
    os.environ["VPTPU_PIPELINE"] = "1" if mode == "pipelined" else "0"
    t0 = time.perf_counter()
    try:
        app_main(paths)
        time.sleep(0.5)
    finally:
        stop.set()
        publisher.join()
        bus.close()
        os.environ.pop("VPTPU_PIPELINE", None)
    wall = time.perf_counter() - t0

    robots = balls = 0
    for c in range(n_cams):
        frames = sorted(detections[c], key=lambda d: d.frame_number)
        if [d.frame_number for d in frames] != list(
                range(1, FRAMES_PER_RUN + 1)):
            raise AssertionError(
                f"{scene_name} f{factor} {mode}: camera {c} sent frames "
                f"{[d.frame_number for d in frames]}")
        last = frames[-1]
        for bot in scenes[c].bots:
            team = (last.robots_yellow if bot.team == "yellow"
                    else last.robots_blue)
            if not any(r.robot_id == bot.bot_id
                       and np.hypot(r.x - bot.x, r.y - bot.y) < 30.0
                       for r in team):
                raise AssertionError(
                    f"{scene_name} f{factor} {mode}: camera {c} missed "
                    f"{bot.team} robot {bot.bot_id} at ({bot.x:.0f}, "
                    f"{bot.y:.0f})")
            robots += 1
        # the planted ball is checked where it stands alone; in the dense
        # scene scatter balls touch it and merge with it in the render,
        # so there every ball on the wire must lie on a planted ball
        planted = np.asarray([[b.x, b.y] for b in scenes[c].balls])
        wire = np.asarray([[b.x, b.y] for b in last.balls]).reshape(-1, 2)
        near = np.linalg.norm(planted[1:] - planted[0], axis=-1)
        if not len(near) or near.min() > 100.0:
            ok = len(wire) and np.linalg.norm(
                wire - planted[0], axis=-1).min() < 40.0
        else:
            ok = len(wire) and np.linalg.norm(
                wire[:, None] - planted[None], axis=-1).min(1).max() < 40.0
        if not ok:
            raise AssertionError(
                f"{scene_name} f{factor} {mode}: camera {c}: balls on the "
                f"wire {wire.round().tolist()[:8]} vs planted "
                f"{planted[0].round().tolist()}")
        balls += 1
    log(f"app: {scene_name} f{factor} {mode}: {robots}/16 planted robots "
        f"with ids and the balls of {balls}/{n_cams} cameras on the wire over "
        f"{FRAMES_PER_RUN} frame-sets ({wall:.1f} s incl. compile)")


# ---------------------------------------------------------------------------


def build_rigs():
    import bench

    rigs = {}
    for factor in FACTORS:
        rigs["sparse", factor] = bench.build_rig(
            resampling_factor=factor, return_scenes=True)
        rigs["dense", factor] = bench.build_rig(
            dense=True, dense_blobs=1900, resampling_factor=factor,
            return_scenes=True)
    return rigs


def main() -> int:
    from vision_processor_tpu.utils import setup_compile_cache

    setup_compile_cache()
    t0 = time.perf_counter()
    dev = device_phase()
    rigs = build_rigs()
    log(f"rigs: built in {time.perf_counter() - t0:.1f} s")
    dense = rigs["dense", FACTORS[0]]
    memory_analysis(dense)
    check_projection(dense)
    check_blob_response(dense)
    check_query_select(dense)
    check_detections(dense)
    with tempfile.TemporaryDirectory() as tmp:
        app_phase(rigs, Path(tmp))
    import jax

    log(f"smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
