"""Blob-response kernels (ops/blob_pallas.py) vs the XLA chain.

The GPU runs the three Triton-route stencil kernels; the CPU keeps the XLA
chain. These tests run the kernels through the Pallas interpreter at
non-power-of-two widths: the box sums add exactly the gradient entries the
SAT chain's clamped quadrant reads cover, border included, so the maps
match to f32 reassociation and the DETECTIONS on a rendered scene are
identical.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from vision_processor_tpu.ops import blob as B
from vision_processor_tpu.ops.blob_pallas import blob_response_fused


def _xla(flat, th, o, r, dr):
    circ = B.circularity(B.summed_area_table(B.gradient_dot(flat, o)), r)
    ms, mean, count = B.blob_response(flat, circ, th, dr)
    return ms, circ, mean, count


@pytest.mark.parametrize("h,w,o,r,dr", [(20, 770, 2, 4, 3), (12, 962, 1, 3, 2),
                                        (33, 257, 3, 5, 4)])
def test_interior_value_parity(h, w, o, r, dr):
    """Whole maps, border included: circularity to f32 reassociation, the
    same threshold + local-max mask, disc means to ~1e-5 of the range."""
    rng = np.random.default_rng(0)
    flat = jnp.asarray(rng.uniform(0, 255, (h, w, 3)).astype(np.float32))
    ms, circ, mean, count = blob_response_fused(flat, 15.0, o, r, dr,
                                                interpret=True)
    ms_r, circ_r, mean_r, count_r = _xla(flat, 15.0, o, r, dr)
    ref, got = np.asarray(circ_r), np.asarray(circ)
    assert got.shape == ref.shape == (h, w)
    rel = np.abs(ref - got).max() / (np.abs(ref).max() + 1.0)
    assert rel < 1e-5, f"relative error {rel:.2e}"
    np.testing.assert_array_equal(np.asarray(ms) > -np.inf,
                                  np.asarray(ms_r) > -np.inf)
    assert int(count) == int(count_r) > 0
    for c in range(3):
        np.testing.assert_allclose(np.asarray(mean[c]),
                                   np.asarray(mean_r)[..., c], atol=5e-3)


def test_r1_falls_back_exactly():
    """r = 1 leaves every quadrant box empty: circularity is exactly 0 on
    both sides, so nothing passes a positive threshold."""
    rng = np.random.default_rng(1)
    flat = jnp.asarray(rng.uniform(0, 255, (24, 140, 3)).astype(np.float32))
    ms, circ, _, count = blob_response_fused(flat, 15.0, 2, 1, 1,
                                             interpret=True)
    _, circ_r, _, count_r = _xla(flat, 15.0, 2, 1, 1)
    np.testing.assert_array_equal(np.asarray(circ), np.asarray(circ_r))
    assert int(count) == int(count_r) == 0


def test_detection_equivalence_on_scene(divb_field, overhead_model,
                                        monkeypatch):
    """Full blob machine with the kernels (interpreter) finds the same
    blobs as the XLA chain on a rendered scene."""
    import functools

    from vision_processor_tpu.io.synthetic import Scene, SceneBall, SceneBot, render_raw
    from vision_processor_tpu.models.perspective import Perspective
    from vision_processor_tpu.ops import pipeline as P
    from vision_processor_tpu.ops.pipeline import BlobMachine, BlobMachineConfig

    geometry = divb_field.geometry
    geometry.ClearField("calib")
    geometry.calib.append(overhead_model.to_proto(0))
    persp = Perspective(cam_id=0)
    assert persp.update_geometry(geometry, 1, 960, 720, 150.0, 1.0)
    scene = Scene(
        bots=[SceneBot(4, "yellow", -2700.0, 500.0, 0.8)],
        balls=[SceneBall(-3100.0, -900.0)],
    )
    raw = render_raw(overhead_model, geometry.field, scene, "RGGB")
    cfg = BlobMachineConfig.from_perspective(
        persp, "RGGB", raw.shape, max_blobs=128)

    ref = BlobMachine(cfg)(raw, overhead_model.packed(), 150.0, 15.0)

    monkeypatch.setattr(P, "use_gpu_kernels", lambda: True)
    monkeypatch.setattr(P, "blob_response_fused", functools.partial(
        blob_response_fused, interpret=True))
    got = BlobMachine(cfg)(raw, overhead_model.packed(), 150.0, 15.0)

    ref_valid = np.asarray(ref["valid"])
    got_valid = np.asarray(got["valid"])
    np.testing.assert_array_equal(ref_valid, got_valid)
    n = int(ref_valid.sum())
    assert n >= 6  # pattern blobs + ball landed
    assert int(got["count"]) == int(ref["count"])
    # slot order may differ for near-tied scores; compare as sets by pos
    rp = np.asarray(ref["pos"])[:n]
    gp = np.asarray(got["pos"])[:n]
    order_r = np.lexsort(rp.T)
    order_g = np.lexsort(gp.T)
    np.testing.assert_allclose(gp[order_g], rp[order_r], atol=1e-2)
    # score = circ / sum(stddev): for near-uniform discs the variance
    # cancellation amplifies the XLA chain's prefix-sum rounding in the
    # score domain — compare in the stddev domain instead
    rs = np.asarray(ref["circ"])[:n][order_r] / np.maximum(
        np.asarray(ref["score"])[:n][order_r], 1e-9)
    gs = np.asarray(got["circ"])[:n][order_g] / np.maximum(
        np.asarray(got["score"])[:n][order_g], 1e-9)
    np.testing.assert_allclose(gs, rs, atol=0.05)
