"""Device selection, compile cache, projection precision and the chip smoke
entry: the CPU-testable parts of running on the GPU."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform,want", [("gpu", True), ("cpu", False)])
def test_kernel_choice_by_platform(monkeypatch, platform, want):
    import jax

    from vision_processor_tpu.ops.platform import use_gpu_kernels

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert use_gpu_kernels() is want


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_kernel_choice_unknown_platform_raises(monkeypatch, platform):
    import jax

    from vision_processor_tpu.ops.platform import use_gpu_kernels

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match=platform):
        use_gpu_kernels()


def test_pipeline_selects_blob_kernel_on_gpu(monkeypatch):
    """With the GPU selected, the blob machine takes the kernel path (the
    kernel is stubbed here: a CPU cannot compile it)."""
    import jax.numpy as jnp

    from __graft_entry__ import _build_setup
    from vision_processor_tpu.ops import blob as B
    from vision_processor_tpu.ops import pipeline as P

    calls = []

    def stub(flat, th, o, r, dr):
        calls.append((flat.shape, o, r, dr))
        circ = B.circularity(B.summed_area_table(B.gradient_dot(flat, o)), r)
        ms, mean, count = B.blob_response(flat, circ, th, dr)
        return ms, circ, mean, count

    monkeypatch.setattr(P, "use_gpu_kernels", lambda: True)
    monkeypatch.setattr(P, "blob_response_fused", stub)
    _, cams, bm_cfg, _, params = _build_setup(size=(96, 72))
    model = cams[0][0]
    raw = np.zeros(bm_cfg.raw_shape, np.uint8)
    P.blob_machine(bm_cfg, jnp.asarray(raw), jnp.asarray(model.packed()),
                   params["max_bot_height"], params["min_circularity"])
    assert calls == [(bm_cfg.flat_shape + (3,), bm_cfg.grad_offset,
                      bm_cfg.sat_radius, bm_cfg.disc_radius)]


def test_query_select_selects_kernel_on_gpu(monkeypatch):
    import jax.numpy as jnp

    from vision_processor_tpu.ops import topk as T

    seen = []
    monkeypatch.setattr(T, "use_gpu_kernels", lambda: True)
    monkeypatch.setattr(T, "_query_select_kernel",
                        lambda *a: seen.append(a[-1]) or ("k", "k"))
    out = T.query_select_topk(jnp.zeros((3, 2)), jnp.ones(3),
                              jnp.zeros((5, 2)), jnp.zeros(5), 2, True)
    assert out == ("k", "k") and seen == [False]  # compiled, not interpreted


@pytest.mark.parametrize("mode", ["auto", "gather"])
def test_resample_mode_auto_is_gather(tmp_path, mode):
    """``thresholds.resample_mode`` "auto" (and "gather") load, and the
    sampling geometry is the XLA gather's on every platform."""
    import yaml

    from __graft_entry__ import _build_setup
    from vision_processor_tpu.utils.config import VisionConfig

    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump({"thresholds": {"resample_mode": mode}}))
    VisionConfig.load(str(path))
    _, cams, bm_cfg, _, params = _build_setup(size=(96, 72))
    grid = bm_cfg.make_resample_grid(cams[0][0].packed(),
                                     float(params["max_bot_height"]))
    assert set(grid) == {"idx", "ub", "vb"}


def test_resample_mode_warp_is_rejected(tmp_path):
    import yaml

    from vision_processor_tpu.utils.config import VisionConfig

    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump({"thresholds": {"resample_mode": "warp"}}))
    with pytest.raises(ValueError, match="resample_mode"):
        VisionConfig.load(str(path))


def test_compile_cache_env_set(monkeypatch, tmp_path):
    import jax

    from vision_processor_tpu.utils import setup_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    setup_compile_cache()
    # JAX reads the variable itself; the helper leaves the config alone
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch):
    import jax

    from vision_processor_tpu.utils import setup_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        setup_compile_cache()
        assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("tilt", [0.0, 0.15])
def test_field2image_packed_matches_host_f64(overhead_model, tilt):
    """The f32 device projection agrees with the float64 host model within
    0.01 px over a flat grid (f32 rounding of ~1000 px is ~1e-4 px)."""
    import dataclasses

    import jax.numpy as jnp

    from vision_processor_tpu.models.camera import field2image_packed

    quat = np.array([-1.0, tilt, 0.5 * tilt, 0.2 * tilt])
    model = dataclasses.replace(overhead_model,
                                quat=quat / np.linalg.norm(quat))
    xs, ys = np.meshgrid(np.linspace(-4000, -500, 64),
                         np.linspace(-2500, 2500, 48))
    pts = np.stack([xs, ys, np.full_like(xs, 150.0)], axis=-1)
    host = model.field2image(pts)
    dev = np.asarray(field2image_packed(jnp.asarray(model.packed()),
                                        jnp.asarray(pts, jnp.float32)))
    ok = np.isfinite(host).all(-1)
    assert ok.sum() > 1000
    assert np.abs(dev[ok] - host[ok]).max() < 0.01


def test_chip_smoke_fails_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_ball_painting_matches_full_image_test(overhead_model):
    """Bucketed ball painting marks exactly the pixels a whole-image d2
    test marks."""
    from vision_processor_tpu.io.synthetic import (
        BALL_ORANGE, SceneBall, _paint_balls)

    w, h = int(overhead_model.size[0]), int(overhead_model.size[1])
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    ground = overhead_model.image2field(np.stack([xs, ys], -1), 0.0)[..., :2]
    rng = np.random.default_rng(3)
    balls = [SceneBall(float(x), float(y))
             for x, y in zip(rng.uniform(-4500, 0, 300),
                             rng.uniform(-3000, 3000, 300))]
    got = np.zeros((h, w, 3))
    _paint_balls(got, ground, balls)
    want = np.zeros((h, w, 3))
    for b in balls:
        d2 = np.sum((ground - [b.x, b.y]) ** 2, axis=-1)
        want[d2 <= b.radius ** 2] = BALL_ORANGE
    np.testing.assert_array_equal(got, want)
    assert (want == BALL_ORANGE).all(-1).sum() > 1000


@pytest.mark.gpu
def test_blob_kernels_on_card(gpu):
    """Compiled kernels (no interpreter) against the XLA chain on the card."""
    import jax
    import jax.numpy as jnp

    from vision_processor_tpu.ops import blob as B
    from vision_processor_tpu.ops.blob_pallas import blob_response_fused

    rng = np.random.default_rng(0)
    flat = jnp.asarray(rng.uniform(0, 255, (432, 770, 3)).astype(np.float32))
    ms, circ, _, count = blob_response_fused(flat, 15.0, 1, 4, 3)
    with jax.default_matmul_precision("highest"):
        circ_r = B.circularity(B.summed_area_table(B.gradient_dot(flat, 1)), 4)
        ms_r, _, count_r = B.blob_response(flat, circ_r, 15.0, 3)
    rel = float(jnp.abs(circ - circ_r).max() / (jnp.abs(circ_r).max() + 1))
    assert rel < 1e-5
    assert int(count) == int(count_r)
    np.testing.assert_array_equal(np.asarray(ms) > -np.inf,
                                  np.asarray(ms_r) > -np.inf)
