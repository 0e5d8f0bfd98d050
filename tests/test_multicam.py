"""Multi-camera tests: vmap batch on one device and shard_map over the
virtual 8-device CPU mesh, including the mesh tracking exchange."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vision_processor_tpu.io.synthetic import Scene, SceneBall, SceneBot, render_raw
from vision_processor_tpu.models.camera import CameraModel
from vision_processor_tpu.models.detector import DetectorConfig
from vision_processor_tpu.models.perspective import Perspective
from vision_processor_tpu.ops.pipeline import BlobMachineConfig
from vision_processor_tpu.parallel import multicam as M

MAXH = 150.0


def make_rig(divb_field, n_cams):
    """n_cams identical-geometry cameras over different field cells."""
    geometry = divb_field.geometry
    cams = []
    for cam_id in range(n_cams):
        from vision_processor_tpu.models.camera import (
            visible_field_extent_estimation,
        )

        lo, hi = visible_field_extent_estimation(
            cam_id, n_cams, geometry.field, False
        )
        center = (lo + hi) / 2
        model = CameraModel(
            focal_length=900.0,
            principal_point=np.array([480.0, 360.0]),
            distortion_k2=0.02,
            pos=np.array([center[0], center[1], 4500.0]),
            size=np.array([960, 720]),
        )
        persp = Perspective(cam_id=cam_id)
        geometry.ClearField("calib")
        geometry.calib.append(model.to_proto(cam_id))
        assert persp.update_geometry(geometry, cam_id + 1, 960, 720, MAXH, 1.0)
        cams.append((model, persp))
    return cams


def build_cfg(cams, n_cams, raw_shape):
    """Shared static config: flat grid padded to the max over cameras."""
    hf = max(int(p.reprojected_field_size[1]) for _, p in cams)
    wf = max(int(p.reprojected_field_size[0]) for _, p in cams)
    ref = cams[0][1]
    bm = BlobMachineConfig(
        fmt="RGGB",
        raw_shape=raw_shape,
        flat_shape=(hf, wf),
        field_scale=float(ref.field_scale),
        field_offset=(0.0, 0.0),
        grad_offset=1,
        sat_radius=5,
        disc_radius=4,
        max_blobs=128,
    )
    det = DetectorConfig(max_blobs=128, max_anchors=128, max_tracked=32)
    return M.MultiCamConfig(bm=bm, det=det, n_cams=n_cams)


def params(dt=0.01):
    return {
        "max_bot_height": jnp.float32(MAXH),
        "min_circularity": jnp.float32(15.0),
        "max_robot_radius": jnp.float32(90.0),
        "min_tracking_radius": jnp.float32(20.0),
        "max_bot_acceleration": jnp.float32(6500.0),
        "min_confidence": jnp.float32(0.2),
        "clipping_tolerance": jnp.float32(10.0),
        "ball_radius": jnp.float32(21.5),
        "tracked_time_delta": jnp.float32(dt),
    }


@pytest.fixture(scope="module")
def rig2(divb_field):
    n = 2
    cams = make_rig(divb_field, n)
    scenes = [
        Scene(bots=[SceneBot(3, "yellow", -2800.0, 600.0, 0.7)],
              balls=[SceneBall(-3400.0, -1200.0)]),
        Scene(bots=[SceneBot(7, "blue", 2000.0, -800.0, -1.9)], balls=[]),
    ]
    raws = np.stack(
        [
            render_raw(model, divb_field.geometry.field, scene, "RGGB")
            for (model, _), scene in zip(cams, scenes)
        ]
    )
    cfg = build_cfg(cams, n, raws.shape[1:])
    packed = np.stack([m.packed() for m, _ in cams])
    scales = np.array([p.field_scale for _, p in cams], dtype=np.float32)
    offsets = np.stack(
        [
            np.array(
                [p.visible_field_extent[0], p.visible_field_extent[2]],
                dtype=np.float32,
            )
            for _, p in cams
        ]
    )
    colors = np.stack(
        [np.zeros((7, 3), dtype=np.float32) + _default_colors() for _ in range(n)]
    )
    return cfg, raws, packed, scales, offsets, colors


def _default_colors():
    from vision_processor_tpu.models.colors import ColorState

    return ColorState().packed()


def _check_outputs(cfg, blobs, det, summary):
    count = np.asarray(blobs["count"])
    assert count.shape == (cfg.n_cams,)
    assert count[0] >= 6  # bot + ball on cam 0
    assert count[1] >= 5
    bots0 = np.asarray(det["bot_valid"][0]).sum()
    bots1 = np.asarray(det["bot_valid"][1]).sum()
    assert bots0 == 1 and bots1 == 1
    ids = np.asarray(summary["id"])
    assert 3 in ids[0]
    assert 16 + 7 in ids[1]


def test_batched_vmap_step(rig2):
    cfg, raws, packed, scales, offsets, colors = rig2
    step = M.batched_step(cfg)
    prev = M.empty_summary(cfg)
    blobs, det, summary = step(raws, packed, scales, offsets, colors, prev, params())
    _check_outputs(cfg, blobs, det, summary)
    # second frame with feedback: tracked priors now active, same detections
    blobs, det, summary2 = step(raws, packed, scales, offsets, colors, summary, params())
    _check_outputs(cfg, blobs, det, summary2)


def test_sharded_step_8_devices(divb_field):
    n = len(jax.devices())
    assert n == 8, "conftest must provide 8 virtual cpu devices"
    cams = make_rig(divb_field, n)
    scenes = []
    for cam_id, (model, persp) in enumerate(cams):
        lo = persp.visible_field_extent
        cx = (lo[0] + lo[1]) / 2
        cy = (lo[2] + lo[3]) / 2
        scenes.append(
            Scene(bots=[SceneBot(cam_id, "yellow", cx, cy, 0.3 * cam_id)], balls=[])
        )
    raws = np.stack(
        [
            render_raw(model, divb_field.geometry.field, scene, "RGGB")
            for (model, _), scene in zip(cams, scenes)
        ]
    )
    cfg = build_cfg(cams, n, raws.shape[1:])
    packed = np.stack([m.packed() for m, _ in cams])
    scales = np.array([p.field_scale for _, p in cams], dtype=np.float32)
    offsets = np.stack(
        [
            np.array([p.visible_field_extent[0], p.visible_field_extent[2]],
                     dtype=np.float32)
            for _, p in cams
        ]
    )
    colors = np.stack([_default_colors() for _ in range(n)])

    mesh = M.make_camera_mesh()
    step = M.sharded_step(cfg, mesh)
    prev = M.empty_summary(cfg)
    blobs, det, gathered = step(raws, packed, scales, offsets, colors, prev, params())

    # every camera detected its bot, and the all_gather made every camera's
    # summary visible fleet-wide
    valid = np.asarray(det["bot_valid"]).reshape(n, -1)
    assert (valid.sum(axis=1) == 1).all()
    ids = np.asarray(gathered["id"])
    found = {int(i) for i in ids[ids >= 0]}
    assert found == set(range(n))

    # feedback round through the tracked path
    blobs, det, gathered2 = step(
        raws, packed, scales, offsets, colors, gathered, params()
    )
    valid = np.asarray(det["bot_valid"]).reshape(n, -1)
    assert (valid.sum(axis=1) == 1).all()


def test_sharded_step_two_cams_per_device(divb_field):
    """8 cameras sharded over a 4-device mesh (2 per chip): the production
    shape for a large rig on a small pod. Every camera's bot is detected
    and the all_gathered summary covers the whole fleet."""
    n_cams, n_dev = 8, 4
    cams = make_rig(divb_field, n_cams)
    scenes = []
    for cam_id, (model, persp) in enumerate(cams):
        lo = persp.visible_field_extent
        cx = (lo[0] + lo[1]) / 2
        cy = (lo[2] + lo[3]) / 2
        scenes.append(
            Scene(bots=[SceneBot(cam_id, "yellow", cx, cy, 0.2 * cam_id)], balls=[])
        )
    raws = np.stack(
        [
            render_raw(model, divb_field.geometry.field, scene, "RGGB")
            for (model, _), scene in zip(cams, scenes)
        ]
    )
    cfg = build_cfg(cams, n_cams, raws.shape[1:])
    packed = np.stack([m.packed() for m, _ in cams])
    scales = np.array([p.field_scale for _, p in cams], dtype=np.float32)
    offsets = np.stack(
        [
            np.array([p.visible_field_extent[0], p.visible_field_extent[2]],
                     dtype=np.float32)
            for _, p in cams
        ]
    )
    colors = np.stack([_default_colors() for _ in range(n_cams)])

    mesh = M.make_camera_mesh(jax.devices()[:n_dev])
    step = M.sharded_step(cfg, mesh)
    prev = M.empty_summary(cfg)
    blobs, det, gathered = step(
        raws, packed, scales, offsets, colors, prev, params())

    valid = np.asarray(det["bot_valid"]).reshape(n_cams, -1)
    assert (valid.sum(axis=1) == 1).all()
    ids = np.asarray(gathered["id"])
    assert ids.shape[:2] == (n_dev, n_cams // n_dev)
    found = {int(i) for i in ids[ids >= 0]}
    assert found == set(range(n_cams))


def test_per_camera_params(rig2):
    """Per-camera tunables as (N,) arrays: camera 1 gets an impossible
    min_circularity and must see zero blobs while camera 0 (normal
    threshold) still detects its bot — the reference's per-process config
    independence (reference src/Resources.cpp:188-214)."""
    cfg, raws, packed, scales, offsets, colors = rig2
    step = M.batched_step(cfg)
    prev = M.empty_summary(cfg)
    p = params()
    p["min_circularity"] = jnp.asarray([15.0, 1e9], dtype=jnp.float32)
    blobs, det, summary = step(raws, packed, scales, offsets, colors, prev, p)
    count = np.asarray(blobs["count"])
    assert count[0] >= 6  # cam 0 unaffected
    assert count[1] == 0  # cam 1's threshold filtered everything
    assert np.asarray(det["bot_valid"][0]).sum() == 1
    assert np.asarray(det["bot_valid"][1]).sum() == 0


def test_tracked_from_summaries_dedup_and_heights():
    """Overlap-region dedup: the same bot id observed by 3 cameras must
    occupy ONE tracked slot (best score wins) so distinct robots are not
    evicted; z comes from the GC team heights; vw is finite-differenced."""
    det = DetectorConfig(max_blobs=32, max_tracked=2)
    b = det.max_bots

    def summary(entries):
        out = {
            "pos": np.zeros((3, b, 2), np.float32),
            "orientation": np.zeros((3, b), np.float32),
            "score": np.zeros((3, b), np.float32),
            "id": np.full((3, b), -1, np.int32),
        }
        for cam, slot, i, x, y, sc, w in entries:
            out["pos"][cam, slot] = (x, y)
            out["orientation"][cam, slot] = w
            out["score"][cam, slot] = sc
            out["id"][cam, slot] = i
        return {k: jnp.asarray(v) for k, v in out.items()}

    # bot 5 (yellow) seen by all 3 cameras; bot 21 (blue) by one camera
    # with the LOWEST score of the four entries. max_tracked=2: without
    # dedup, bot 5's three observations evict bot 21 entirely.
    cur = summary([
        (0, 0, 5, 100.0, 200.0, 0.9, 0.50),
        (1, 0, 5, 101.0, 201.0, 0.95, 0.51),
        (2, 0, 5, 99.0, 199.0, 0.85, 0.49),
        (2, 1, 21, -500.0, 300.0, 0.4, -1.0),
    ])
    prev = summary([(1, 0, 5, 91.0, 191.0, 0.95, 0.31)])
    tr = M.tracked_from_summaries(
        det, cur, 0.02, prev_summaries=prev, bot_heights=(147.0, 139.0)
    )
    ids = sorted(int(i) for i in np.asarray(tr["id"]) if i >= 0)
    assert ids == [5, 21], f"dedup failed: tracked ids {ids}"
    i5 = list(np.asarray(tr["id"])).index(5)
    i21 = list(np.asarray(tr["id"])).index(21)
    # best-score observation of bot 5 wins (camera 1)
    assert np.asarray(tr["x"])[i5] == pytest.approx(101.0)
    # GC team heights: yellow id 5 -> 147, blue id 21 -> 139
    assert np.asarray(tr["z"])[i5] == pytest.approx(147.0)
    assert np.asarray(tr["z"])[i21] == pytest.approx(139.0)
    # angular velocity finite difference for the matched id
    assert np.asarray(tr["vw"])[i5] == pytest.approx((0.51 - 0.31) / 0.02)
    assert np.asarray(tr["vw"])[i21] == 0.0


def test_tracked_from_summaries_velocities():
    """With two consecutive summaries, the device-loop tracked prior gets
    per-id finite-difference velocities (the extrapolation input of the
    tracked search); unmatched or fresh ids stay at zero."""
    from vision_processor_tpu.models.detector import DetectorConfig

    det = DetectorConfig(max_blobs=32, max_tracked=8)
    b = det.max_bots

    def summary(entries):
        out = {
            "pos": np.zeros((2, b, 2), np.float32),
            "orientation": np.zeros((2, b), np.float32),
            "score": np.zeros((2, b), np.float32),
            "id": np.full((2, b), -1, np.int32),
        }
        for cam, slot, i, x, y in entries:
            out["pos"][cam, slot] = (x, y)
            out["score"][cam, slot] = 0.9
            out["id"][cam, slot] = i
        return {k: jnp.asarray(v) for k, v in out.items()}

    prev = summary([(0, 0, 5, 100.0, 200.0)])
    cur = summary([(0, 0, 5, 140.0, 180.0), (1, 0, 7, 0.0, 0.0)])
    tr = M.tracked_from_summaries(det, cur, 0.02, prev_summaries=prev)
    ids = np.asarray(tr["id"])
    i5 = list(ids).index(5)
    i7 = list(ids).index(7)
    assert np.asarray(tr["vx"])[i5] == pytest.approx((140.0 - 100.0) / 0.02)
    assert np.asarray(tr["vy"])[i5] == pytest.approx((180.0 - 200.0) / 0.02)
    assert np.asarray(tr["vx"])[i7] == 0.0  # id 7 is new: no history
    # without history: zero velocities
    tr0 = M.tracked_from_summaries(det, cur, 0.02)
    assert not np.asarray(tr0["vx"]).any()


def test_batched_step_consumes_params_bot_heights(rig2, monkeypatch):
    """Regression: every params producer emits the key "bot_heights_yb";
    the device-loop steps must pass it through to tracked_from_summaries
    (a mismatched key silently falls back to the 143 mm default — this
    shipped once as dead code for the GC team-heights feature)."""
    cfg, raws, packed, scales, offsets, colors = rig2
    captured = {}
    real = M.tracked_from_summaries

    def spy(det, summaries, dt, prev_summaries=None, bot_heights=None):
        captured["bot_heights"] = bot_heights
        return real(det, summaries, dt, prev_summaries=prev_summaries,
                    bot_heights=bot_heights)

    monkeypatch.setattr(M, "tracked_from_summaries", spy)
    p = params()
    p["bot_heights_yb"] = jnp.asarray([160.0, 155.0], dtype=jnp.float32)
    prev = M.empty_summary(cfg)
    # .lower() traces (invoking the spy) without paying XLA compilation
    M.batched_step(cfg).lower(
        raws, packed, scales, offsets, colors, prev, p)
    assert captured.get("bot_heights") is not None, (
        "params['bot_heights_yb'] did not reach tracked_from_summaries"
    )


def test_sharded_fused_matches_batched(divb_field, rig2):
    """sharded_step(fused=True) must produce the same finalized detections
    and finisher outputs as the single-chip batched fused step — the
    deferred NMS/id finalize and the per-shard param slicing are exercised
    with a per-camera clipping_tolerance array."""
    from vision_processor_tpu.models.colors import ColorState
    from vision_processor_tpu.models.device_finish import pack_field_marks

    cfg, raws, packed, scales, offsets, colors = rig2
    p = params()
    p.update({
        "min_score": jnp.float32(0.0),
        "min_cam_edge_distance": jnp.float32(170.0),
        "reference_force": jnp.float32(0.1),
        "history_force": jnp.float32(0.7),
        "bot_heights_yb": jnp.asarray([145.0, 145.0], dtype=jnp.float32),
        # per-camera tunable as an (N,) array -> exercises _shard_param
        "clipping_tolerance": jnp.asarray([10.0, 12.0], dtype=jnp.float32),
    })
    refs = jnp.asarray(np.stack([ColorState().packed_refs()] * cfg.n_cams))
    marks_one = pack_field_marks(divb_field.geometry.field, 10.0)
    marks = {k: jnp.asarray(v) for k, v in marks_one.items()}
    marks_b = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (cfg.n_cams,) + x.shape), marks
    )
    prev = M.empty_summary(cfg)

    bstep = M.batched_step(cfg)
    b_blobs, b_det, b_sum, b_fin = bstep(
        raws, packed, scales, offsets, colors, prev, p,
        None, None, refs, marks_b,
    )

    mesh = M.make_camera_mesh(jax.devices()[: cfg.n_cams])
    sstep = M.sharded_step(cfg, mesh, fused=True)
    s_blobs, s_det, s_gather, s_fin = sstep(
        raws, packed, scales, offsets, colors,
        jax.tree.map(lambda x: x[None], prev), p, refs, marks,
    )

    np.testing.assert_array_equal(
        np.asarray(b_det["bot_valid"]), np.asarray(s_det["bot_valid"]))
    np.testing.assert_array_equal(
        np.asarray(b_det["bot_id_est"]), np.asarray(s_det["bot_id_est"]))
    np.testing.assert_allclose(
        np.asarray(b_fin["colors7"]), np.asarray(s_fin["colors7"]),
        rtol=0, atol=0)
    np.testing.assert_array_equal(
        np.asarray(b_fin["bot_valid"]), np.asarray(s_fin["bot_valid"]))
    assert np.asarray(s_det["bot_valid"]).reshape(cfg.n_cams, -1).sum() == 2
