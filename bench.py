"""Headline benchmark: 4 x 1080p Bayer camera streams on one GPU.

Production configuration:

* ``max_blobs=2000`` — the reference's default per-frame blob budget
  (reference src/Resources.cpp:84) — with the detector's default anchor cap
  (512),
* a DENSE variant (~1500 real ball-sized blobs per camera) measured
  alongside the regular 4-bots+ball scenes,
* a real production loop: per-frame host->device upload, batched device
  step, device->host fetch, per-camera host finishing (colors, ids,
  filters, protobuf emit to a live multicast socket), measured with the
  one-frame pipeline overlap both off and on,
* device time by lax.scan length-differencing; upload and host finishing
  measured separately; the derived production number is their sum. The
  loop numbers as measured are reported too.

Prints ONE JSON line; `value` = derived production camera-fps per GPU.
Exits non-zero unless JAX's platform is ``gpu``.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def build_rig(n_cams=4, width=960, height=540, max_blobs=2000, dense=False,
              dense_blobs=200, resampling_factor=1.0, return_scenes=False):
    """4 cameras, one per field quadrant, 1080p Bayer each."""
    import jax.numpy as jnp

    from vision_processor_tpu.io.synthetic import (
        Scene,
        SceneBall,
        SceneBot,
        render_raw,
    )
    from vision_processor_tpu.models.camera import (
        CameraModel,
        visible_field_extent_estimation,
    )
    from vision_processor_tpu.models.colors import ColorState
    from vision_processor_tpu.models.detector import DetectorConfig
    from vision_processor_tpu.models.perspective import Perspective
    from vision_processor_tpu.net.geometry_io import geometry_from_dict
    from vision_processor_tpu.ops.pipeline import BlobMachineConfig
    from vision_processor_tpu.parallel.multicam import MultiCamConfig

    field_cfg = {
        "field": {
            "field_length": 9000, "field_width": 6000, "goal_width": 1000,
            "goal_depth": 180, "penalty_area_depth": 1000,
            "penalty_area_width": 2000, "boundary_width": 300,
            "center_circle_radius": 500, "line_thickness": 10,
            "ball_radius": 21.5, "max_robot_radius": 90.0,
        }
    }
    geometry = geometry_from_dict(field_cfg).geometry

    cams, raws = [], []
    rng = np.random.default_rng(7)
    scenes = []
    for cam_id in range(n_cams):
        lo, hi = visible_field_extent_estimation(cam_id, n_cams, geometry.field, False)
        center = (lo + hi) / 2
        model = CameraModel(
            focal_length=900.0,
            principal_point=np.array([width / 2, height / 2]),
            distortion_k2=0.02,
            pos=np.array([center[0], center[1], 4500.0]),
            size=np.array([width, height]),
        )
        persp = Perspective(cam_id=cam_id)
        geometry.ClearField("calib")
        geometry.calib.append(model.to_proto(cam_id))
        assert persp.update_geometry(
            geometry, cam_id + 1, width, height, 150.0, resampling_factor
        )
        cams.append((model, persp))

        # a realistic scene: 4 bots + ball per quadrant
        bots = []
        for i in range(4):
            bx = float(rng.uniform(lo[0] + 400, hi[0] - 400))
            by = float(rng.uniform(lo[1] + 400, hi[1] - 400))
            bots.append(
                SceneBot(
                    (cam_id * 4 + i) % 16,
                    "yellow" if i % 2 == 0 else "blue",
                    bx, by, float(rng.uniform(-3, 3)),
                )
            )
        balls = [SceneBall(float(center[0]), float(center[1]))]
        if dense:
            # adversarial clutter: extra ball-sized blobs per camera.
            # Scatter stays >=250 mm clear of the planted robots: a ball
            # rendered ON a pattern blob physically occludes it (no
            # implementation could detect that bot), and this variant
            # measures occupancy cost, not occlusion.
            placed = 0
            while placed < dense_blobs:
                bx = float(rng.uniform(lo[0] + 150, hi[0] - 150))
                by = float(rng.uniform(lo[1] + 150, hi[1] - 150))
                if any((bx - b.x) ** 2 + (by - b.y) ** 2 < 250.0 ** 2
                       for b in bots):
                    continue
                balls.append(SceneBall(bx, by))
                placed += 1
        scene = Scene(
            bots=bots,
            balls=balls,
            noise_sigma=1.5,
            seed=cam_id,
        )
        raws.append(render_raw(model, geometry.field, scene, "RGGB"))
        scenes.append(scene)

    raws = np.stack(raws)
    hf = max(int(p.reprojected_field_size[1]) for _, p in cams)
    wf = max(int(p.reprojected_field_size[0]) for _, p in cams)
    ref = cams[0][1]

    from vision_processor_tpu.ops import blob as B

    bm = BlobMachineConfig(
        fmt="RGGB",
        raw_shape=raws.shape[1:],
        flat_shape=(hf, wf),
        field_scale=float(ref.field_scale),
        field_offset=(0.0, 0.0),
        grad_offset=B.gradient_offset(ref.max_blob_radius, ref.field_scale),
        sat_radius=B.sat_radius(ref.min_blob_radius, ref.field_scale),
        disc_radius=B.disc_radius(ref.min_blob_radius, ref.field_scale),
        max_blobs=max_blobs,
    )
    det = DetectorConfig(max_blobs=max_blobs, max_tracked=32)
    cfg = MultiCamConfig(bm=bm, det=det, n_cams=n_cams)

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
    colors = np.stack([ColorState().packed() for _ in range(n_cams)])
    params = {
        "max_bot_height": jnp.float32(150.0),
        "min_circularity": jnp.float32(15.0),
        "max_robot_radius": jnp.float32(90.0),
        "min_tracking_radius": jnp.float32(20.0),
        "max_bot_acceleration": jnp.float32(6500.0),
        "min_confidence": jnp.float32(0.2),
        "clipping_tolerance": jnp.float32(10.0),
        "ball_radius": jnp.float32(21.5),
        "tracked_time_delta": jnp.float32(0.005),
        # in-graph finishing (models/device_finish.py)
        "min_score": jnp.float32(5.0),
        "min_cam_edge_distance": jnp.float32(170.0),
        "reference_force": jnp.float32(0.1),
        "history_force": jnp.float32(0.7),
        "bot_heights_yb": jnp.asarray([145.0, 145.0], dtype=jnp.float32),
        # opt-in untracked color veto: 0 = reference-parity default; a
        # runtime scalar so the veto-on variants re-use the compiled step
        "color_plausibility_veto": jnp.float32(0.0),
    }
    if return_scenes:
        return (cfg, raws, packed, scales, offsets, colors, params, geometry,
                cams, scenes)
    return cfg, raws, packed, scales, offsets, colors, params, geometry, cams


def build_rollouts(cfg):
    """Two scan rollouts (shared between the regular and dense rigs —
    identical static shapes, so the compiles are reused)."""
    from vision_processor_tpu.parallel import multicam as M

    step = M.batched_step(cfg)
    return {n: M.make_rollout(cfg, step, n) for n in (10, 50)}


def measure_device_sustained(rolls, cfg, raws, packed, scales, offsets,
                             colors, params, refs=None, marks=None):
    """Device-resident sustained rate via scan-length differencing.

    With ``refs``/``marks`` the scan includes the in-graph finisher with
    the production device-carried color chain — the sustained number then
    prices the FULL per-frame device program."""
    import jax

    packed_d = jax.device_put(packed)
    scales_d = jax.device_put(scales)
    offsets_d = jax.device_put(offsets)
    colors_d = jax.device_put(colors)
    n_bank = 4
    bank = jax.device_put(
        np.stack([np.roll(raws, (2 * i, 4 * i), axis=(1, 2)) for i in range(n_bank)])
    )

    compact = None

    def time_roll(n_frames):
        roll = rolls[n_frames]
        nonlocal compact
        out = roll(bank, packed_d, scales_d, offsets_d, colors_d, params,
                   refs, marks)
        jax.block_until_ready(out)  # compile (cached on reuse)
        t0 = time.perf_counter()
        out = roll(bank, packed_d, scales_d, offsets_d, colors_d, params,
                   refs, marks)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        compact = out[1]
        return dt

    # median of 5 differencing rounds: a single hiccup during either scan
    # corrupts one estimate; the median rejects it
    estimates = []
    for _ in range(5):
        t10 = time_roll(10)
        t50 = time_roll(50)
        estimates.append((t50 - t10) / 40.0)
    per_frameset = float(np.median(estimates))
    # detections from the last scanned frame
    bots_found = int(np.asarray(compact["bot_valid"][-1]).sum())
    blob_counts = np.asarray(compact["count"][-1]).tolist()
    inner = sorted(estimates)[1:-1]
    aux = {"compact": compact, "scan50_s": t50, "bank": bank,
           "args": (packed_d, scales_d, offsets_d, colors_d, params,
                    refs, marks),
           # round-to-round dispersion of THIS run's differencing rounds:
           # ms_band is the raw min/max of the 5 rounds, the inner band
           # drops the best and the worst round
           "ms_band": [float(min(estimates)) * 1e3,
                       float(max(estimates)) * 1e3],
           "ms_band_inner": [float(min(inner)) * 1e3,
                             float(max(inner)) * 1e3]}
    return per_frameset, bots_found, blob_counts, aux


def bot_recall(compact, scenes, tol_mm=40.0):
    """Recall of the planted robots in the LAST scanned frame: every scene
    bot must have an emitted valid bot within tol_mm (the frame bank rolls
    the raw by up to 3 px, so the tolerance absorbs that shift). Extra
    emitted bots are not counted against recall — with ~1500 scattered
    ball-like blobs, pattern-shaped noise constellations are hypotheses the
    reference's geometric-only detection scoring emits too (reference
    src/main.cpp:143-241)."""
    valid = np.asarray(compact["bot_valid"][-1])   # (n_cams, max_bots)
    pos = np.asarray(compact["bot_pos"][-1])       # (n_cams, max_bots, 2)
    found = total = 0
    for c, scene in enumerate(scenes):
        kept = pos[c][valid[c]]
        for bot in scene.bots:
            total += 1
            if len(kept) and np.min(
                np.linalg.norm(kept - [bot.x, bot.y], axis=-1)
            ) < tol_mm:
                found += 1
    return found, total


def measure_dense_precision(cfg, raws, packed, scales, offsets, colors,
                            params, scenes, refs, marks, tol_planted=40.0,
                            tol_match=20.0):
    """Dense-scene precision + uncapped-oracle agreement.

    Runs ONE untracked production step (the full device program incl. the
    in-graph finisher) on the dense frame-set, then runs the SAME blob sets
    through the uncapped host oracle of the reference's untracked emission
    (python/dense_oracle.py: every blob anchors, every cyclic 4-subset of
    ALL in-radius blobs, score filter, clipping NMS — reference
    src/main.cpp:43-79,143-241). Both paths are untracked, so the
    comparison isolates the detector's static caps (512 anchors, ring 8)
    and gates against the reference's enumeration on identical inputs.

    Returns per-fleet counts: device emissions, oracle emissions, planted
    robots matched by each (precision), and the device<->oracle agreement.
    """
    import sys as _sys
    from pathlib import Path

    import jax
    import jax.numpy as jnp

    _sys.path.insert(0, str(Path(__file__).parent / "python"))
    import dense_oracle as O

    from vision_processor_tpu.app.processor import TrackedArrays
    from vision_processor_tpu.parallel.multicam import (
        batched_step_host_tracked,
        make_resample_grids,
    )

    step = batched_step_host_tracked(cfg)
    grids = make_resample_grids(
        cfg, packed, float(params["max_bot_height"]), scales, offsets
    )
    tracked = TrackedArrays.build({}, 0.0, cfg.det.max_tracked).as_dict()
    raws_d = jnp.asarray(raws)
    step_args = (raws_d, jax.device_put(packed), jax.device_put(scales),
                 jax.device_put(offsets), jax.device_put(colors), tracked)
    blobs, det, fin = step(*step_args, params, grids, refs, marks)
    blobs, det, fin = jax.device_get((blobs, det, fin))
    # veto-on variant: same compiled step (the knob is a runtime scalar)
    params_veto = dict(params)
    params_veto["color_plausibility_veto"] = jnp.float32(1.0)
    _, det_v, _ = jax.device_get(
        step(*step_args, params_veto, grids, refs, marks))

    n_cams = cfg.n_cams
    dev_total = orc_total = 0
    dev_tp = orc_tp = planted_total = 0
    veto_total = veto_tp = 0
    matched_dev = 0
    hyp_total = 0
    min_conf = float(np.max(np.asarray(params["min_confidence"])))
    clip_tol = float(np.max(np.asarray(params["clipping_tolerance"])))
    for c in range(n_cams):
        kept = det["bot_valid"][c]
        dev_pos = det["bot_pos"][c][kept]
        em = O.emit_bots(
            blobs["field_pos"][c], blobs["valid"][c],
            float(params["max_robot_radius"]), min_conf, clip_tol,
        )
        dev_total += len(dev_pos)
        orc_total += len(em["pos"])
        hyp_total += em["n_hypotheses"]
        planted = np.asarray(
            [[b.x, b.y] for b in scenes[c].bots], dtype=np.float64
        ).reshape(-1, 2)
        planted_total += len(planted)
        dev_tp += O.match_sets(dev_pos.astype(np.float64), planted,
                               tol_planted)
        orc_tp += O.match_sets(em["pos"], planted, tol_planted)
        # legitimacy: device emissions matched against the oracle's
        # PRE-NMS hypothesis pool (a device emission can be NMS-shadowed
        # in the oracle by an extra noise constellation the capped
        # search never anchored)
        matched_dev += O.match_sets(dev_pos.astype(np.float64),
                                    em["all_pos"], tol_match)
        veto_pos = det_v["bot_pos"][c][det_v["bot_valid"][c]]
        veto_total += len(veto_pos)
        veto_tp += O.match_sets(veto_pos.astype(np.float64), planted,
                                tol_planted)
    return {
        "dense_bots_device_untracked": int(dev_total),
        "dense_bots_oracle": int(orc_total),
        "dense_oracle_hypotheses": int(hyp_total),
        "dense_bot_precision": round(dev_tp / max(dev_total, 1), 4),
        "dense_oracle_precision": round(orc_tp / max(orc_total, 1), 4),
        "dense_planted_recall_untracked": f"{dev_tp}/{planted_total}",
        # fraction of device emissions that are reference-scored
        # hypotheses of the uncapped enumeration (legitimacy; 1.0 = every
        # wire-visible bot, false positives included, is one the
        # reference's own geometric scoring produces too)
        "dense_oracle_agreement": round(matched_dev / max(dev_total, 1), 4),
        # device emission count relative to the oracle's post-NMS set:
        # <= 1 means the capped search emits no MORE noise than the
        # reference's exhaustive enumeration would
        "dense_device_to_oracle_ratio": round(
            dev_total / max(orc_total, 1), 4),
        # opt-in color-plausibility veto (thresholds.
        # color_plausibility_veto, off by default for parity): untracked
        # precision with the veto on — must beat the oracle's 0.089
        # decisively while keeping planted recall
        "dense_bots_device_veto": int(veto_total),
        "dense_bot_precision_veto": round(
            veto_tp / max(veto_total, 1), 4),
        "dense_planted_recall_veto": f"{veto_tp}/{planted_total}",
    }


def measure_dense_tracked(cfg, raws, packed, scales, offsets, colors,
                          params, cams, geometry, scenes, n_frames=24,
                          tol_planted=40.0, tol_persist=60.0,
                          veto=False, suffix=""):
    """Steady-state TRACKED precision on the dense scene.

    Runs the PRODUCTION loop — device step with tracking feedback through
    real multicast sockets (the tracker is the wire consumer's own state,
    net/udp.py detection_tracking), host finishing, emit — for n_frames
    on the static dense frame-set, and measures what a consumer of the
    wire experiences over time: per-frame precision/recall of the
    wire-visible robots against the planted ones, and whether the noise
    emissions persist (re-lock via the tracked tier), die out, or
    multiply.

    Noise persistence: a noise emission in frame k is 'persistent' if a
    noise emission of the same camera sat within tol_persist in frame
    k-1; chains surviving >= 5 frames are locked noise tracks.
    """
    import jax
    import jax.numpy as jnp

    from vision_processor_tpu.app.processor import TrackedArrays
    from vision_processor_tpu.parallel.multicam import (
        batched_step_host_tracked,
        make_resample_grids,
    )

    if veto:
        params = dict(params)
        params["color_plausibility_veto"] = jnp.float32(1.0)
    step = batched_step_host_tracked(cfg)
    procs, socks = build_processors(cfg, cams, geometry,
                                    group="224.99.77.13" if not veto
                                    else "224.99.77.14",
                                    port=17773 if not veto else 17774)

    from vision_processor_tpu.models.device_finish import pack_field_marks

    marks_one = pack_field_marks(
        procs[0].perspective.field, procs[0].config.geometry_tolerance
    )
    marks = jax.tree.map(
        lambda *xs: jnp.asarray(np.stack(xs)), *([marks_one] * len(procs))
    )
    refs = jnp.asarray(np.stack([p.colors.packed_refs() for p in procs]))

    packed_d = jax.device_put(packed)
    scales_d = jax.device_put(scales)
    offsets_d = jax.device_put(offsets)
    grids = make_resample_grids(
        cfg, packed, float(params["max_bot_height"]), scales, offsets
    )
    raws_d = jnp.asarray(raws)

    planted = [
        np.asarray([[b.x, b.y] for b in s.bots], dtype=np.float64)
        for s in scenes
    ]
    n_cams = cfg.n_cams

    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(len(procs))

    def one_frame(i):
        now = i * 0.01
        tracked = TrackedArrays.build(
            socks[0].get_tracked_objects(), now, cfg.det.max_tracked
        ).as_dict()
        colors_now = jnp.asarray(
            np.stack([p.colors.packed() for p in procs]))
        out = step(raws_d, packed_d, scales_d, offsets_d, colors_now,
                   tracked, params, grids, refs, marks)
        blobs, det, fin = jax.device_get(out)
        emitted = [None] * n_cams

        def finish(c):
            per_cam = ({k: v[c] for k, v in blobs.items()},
                       {k: v[c] for k, v in det.items()},
                       {k: v[c] for k, v in fin.items()})
            wrapper, _, _ = procs[c].finish_frame(per_cam, now, now)
            wrapper.detection.t_sent = time.time()
            socks[c].send(wrapper)
            pos = [(r.x, r.y) for r in
                   list(wrapper.detection.robots_yellow)
                   + list(wrapper.detection.robots_blue)]
            emitted[c] = np.asarray(pos, dtype=np.float64).reshape(-1, 2)

        list(pool.map(finish, range(n_cams)))
        # let the multicast loopback deliver before the next frame builds
        # its tracking state (the receiver thread parses asynchronously)
        time.sleep(0.02)
        return emitted

    one_frame(0)  # warm compile (step is cached from the sustained scan)
    per_frame = []
    prev_noise = [np.zeros((0, 2))] * n_cams
    chains = [np.zeros(0, dtype=np.int64)] * n_cams  # age per noise track
    locked_ages = []
    for i in range(n_frames):
        emitted = one_frame(i + 1)
        tp = emit = noise_n = persist_n = 0
        new_prev, new_chains = [], []
        for c in range(n_cams):
            pos = emitted[c]
            emit += len(pos)
            if len(pos) and len(planted[c]):
                d = np.linalg.norm(
                    pos[:, None, :] - planted[c][None, :, :], axis=-1)
                is_tp = d.min(axis=1) < tol_planted
                # recall counts planted robots matched by any emission
                tp += int((d.min(axis=0) < tol_planted).sum())
            else:
                is_tp = np.zeros(len(pos), dtype=bool)
            noise = pos[~is_tp]
            noise_n += len(noise)
            age = np.zeros(len(noise), dtype=np.int64)
            if len(noise) and len(prev_noise[c]):
                dn = np.linalg.norm(
                    noise[:, None, :] - prev_noise[c][None, :, :], axis=-1)
                j = dn.argmin(axis=1)
                hit = dn[np.arange(len(noise)), j] < tol_persist
                age[hit] = chains[c][j[hit]] + 1
                persist_n += int(hit.sum())
            new_prev.append(noise)
            new_chains.append(age)
        prev_noise, chains = new_prev, new_chains
        locked = sum(int((a >= 5).sum()) for a in chains)
        locked_ages.append(locked)
        planted_total = sum(len(p) for p in planted)
        per_frame.append({
            "emit": emit, "tp_recall": tp, "noise": noise_n,
            "persist": persist_n, "locked": locked,
            "precision": round((emit - noise_n) / max(emit, 1), 4),
            "recall": f"{tp}/{planted_total}",
        })

    for s in socks:
        s.close()
    last = per_frame[-1]
    noise_counts = [f["noise"] for f in per_frame]
    out = {
        "dense_tracked_frames": n_frames,
        "dense_precision_tracked_t20": last["precision"],
        "dense_recall_tracked_t20": last["recall"],
        "dense_noise_first_frame": per_frame[0]["noise"],
        "dense_noise_last_frame": last["noise"],
        "dense_noise_mean_per_frame": round(
            float(np.mean(noise_counts)), 1),
        # noise emissions whose track survived >= 5 consecutive frames at
        # the end of the rollout (tracked-tier lock-in on a noise
        # constellation)
        "dense_noise_locked_tracks_final": last["locked"],
        "dense_noise_persist_fraction": round(
            float(np.mean([f["persist"] / max(f["noise"], 1)
                           for f in per_frame[1:]])), 3),
    }
    return {k + suffix: v for k, v in out.items()}


def measure_staggered_serial(cfg, raws, packed, scales, offsets, colors,
                             params, refs, marks):
    """Staggered per-camera serial pipeline components.

    The batched program exposes the whole frame-set upload (all inputs
    resident before dispatch) and the whole host tail. The staggered plan
    dispatches camera c's CORE program (blob machine + hypothesis search,
    parallel/multicam.percam_core_step) as soon as its raw lands, then one
    small batched TAIL (NMS + ids + in-graph finisher) after the last
    core; uploads 1..n-1 and host finishing hide under compute.

    Returns (core_ms, tail_ms): scan-differenced device costs of the two
    program kinds; the caller assembles the corrected staggered latency.
    """
    import jax
    import jax.numpy as jnp

    from vision_processor_tpu.app.processor import TrackedArrays
    from vision_processor_tpu.models.device_finish import (
        finish_on_device_batched,
        stack_finish_params,
    )
    from vision_processor_tpu.parallel import multicam as M

    grids = M.make_resample_grids(
        cfg, packed, float(params["max_bot_height"]), scales, offsets
    )
    tracked = TrackedArrays.build({}, 0.0, cfg.det.max_tracked).as_dict()
    p0 = M.params_for_cam(params, 0)
    grid0 = jax.tree.map(lambda x: x[0], grids)
    packed_d = jax.device_put(packed)
    colors_d = jax.device_put(colors)

    def make_core_roll(n):
        def scan_fn(raw0, packed0, scale0, offset0, colors0):
            def body(carry, _):
                blobs, det = M._single_cam_step(
                    cfg, carry, packed0, scale0, offset0, colors0,
                    tracked, p0, rs_grid=grid0, finalize=False,
                )
                bump = (jnp.sum(det["bot_score"]) +
                        jnp.sum(blobs["count"].astype(jnp.float32)))
                return jnp.roll(carry, 2, axis=0), bump
            return jax.lax.scan(body, raw0, None, length=n)
        return jax.jit(scan_fn)

    raw0 = jax.device_put(raws[0])
    core_args = (raw0, packed_d[0], jnp.float32(scales[0]),
                 jnp.asarray(offsets[0]), colors_d[0])
    rolls = {n: make_core_roll(n) for n in (10, 50)}
    ests = []
    for _ in range(5):
        ts = {}
        for n in (10, 50):
            out = rolls[n](*core_args)
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            out = rolls[n](*core_args)
            jax.block_until_ready(out)
            ts[n] = time.perf_counter() - t0
        ests.append((ts[50] - ts[10]) / 40.0)
    core_ms = float(np.median(ests)) * 1e3

    # stacked core outputs for the tail measurement (content representative
    # of a production frame-set)
    core1 = jax.jit(lambda raw, pc, sc, of, co: M._single_cam_step(
        cfg, raw, pc, sc, of, co, tracked, p0, rs_grid=grid0,
        finalize=False))
    outs = [
        core1(jax.device_put(raws[c]), packed_d[c], jnp.float32(scales[c]),
              jnp.asarray(offsets[c]), colors_d[c])
        for c in range(cfg.n_cams)
    ]
    blobs0, det0 = (jax.tree.map(lambda *xs: jnp.stack(xs), *grp)
                    for grp in zip(*outs))
    fparams = stack_finish_params(params, cfg.n_cams)

    def make_tail_roll(n):
        def scan_fn(blobs, det):
            def body(carry, _):
                b, d = carry
                # finalize_batched adds keys to the det dict it is given;
                # pass a shallow copy so the scan carry keeps its pytree
                d2, _ = M.finalize_batched(
                    b, dict(d), colors_d, params["clipping_tolerance"],
                    params["ball_radius"],
                )
                fin = finish_on_device_batched(
                    b, d2, colors_d, refs, packed_d, marks, fparams
                )
                bump = jnp.sum(fin["bot_score"]) + jnp.sum(
                    fin["ball_valid"].astype(jnp.float32))
                # rotate the camera axis so no iteration is loop-invariant
                b = jax.tree.map(lambda x: jnp.roll(x, 1, axis=0), b)
                d = jax.tree.map(lambda x: jnp.roll(x, 1, axis=0), d)
                return (b, d), bump
            return jax.lax.scan(body, (blobs, det), None, length=n)
        return jax.jit(scan_fn)

    trolls = {n: make_tail_roll(n) for n in (10, 50)}
    ests = []
    for _ in range(5):
        ts = {}
        for n in (10, 50):
            out = trolls[n](blobs0, det0)
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            out = trolls[n](blobs0, det0)
            jax.block_until_ready(out)
            ts[n] = time.perf_counter() - t0
        ests.append((ts[50] - ts[10]) / 40.0)
    tail_ms = float(np.median(ests)) * 1e3
    return core_ms, tail_ms


def measure_upload_overlap(roll, bank_dev, bank_np, args, scan_s):
    """MEASURED H2D/compute overlap: dispatch the
    50-frame scan asynchronously, then stream framesets host->device while
    it runs. overlap = (t_scan + t_upload - t_both) / min(t_scan, t_upload),
    i.e. the fraction of the cheaper activity hidden under the other."""
    import jax

    # upload-alone: K framesets through device_put, K sized so upload and
    # scan take comparable wall time (else the fraction is noise)
    def upload(k):
        bufs = [jax.device_put(bank_np[i % len(bank_np)]) for i in range(k)]
        jax.block_until_ready(bufs)

    upload(2)  # warm any lazy handles
    t0 = time.perf_counter()
    upload(2)
    per_up = (time.perf_counter() - t0) / 2
    k = max(2, int(scan_s / max(per_up, 1e-4)))

    # median of 3 rounds: a single hiccup during either the upload-alone
    # or the concurrent phase swings the fraction by tens of percent
    fracs, per_ups = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        upload(k)
        t_up = time.perf_counter() - t0

        t0 = time.perf_counter()
        out = roll(bank_dev, *args)   # async dispatch
        upload(k)                     # stream uploads while the scan runs
        jax.block_until_ready(out)
        t_both = time.perf_counter() - t0

        denom = min(scan_s, t_up)
        fracs.append((scan_s + t_up - t_both) / max(denom, 1e-9))
        per_ups.append(t_up / k)
    return (float(np.clip(np.median(fracs), 0.0, 1.0)),
            float(np.median(per_ups)))


def build_processors(cfg, cams, geometry, group="224.99.77.11", port=17771):
    """Real per-camera host stacks + live multicast sockets."""
    from vision_processor_tpu.app.processor import Processor
    from vision_processor_tpu.net.udp import VisionSocket
    from vision_processor_tpu.utils.config import VisionConfig

    procs, socks = [], []
    for cam_id, (model, persp) in enumerate(cams):
        vc = VisionConfig()
        vc.cam_id = cam_id
        vc.max_blobs = cfg.bm.max_blobs
        sock = VisionSocket(group, port, cam_id, 150.0)
        proc = Processor(vc, sock, None, max_tracked=cfg.det.max_tracked)
        geometry.ClearField("calib")
        geometry.calib.append(model.to_proto(cam_id))
        proc.geometry_check(960, 540, geometry=geometry, version=cam_id + 1)
        procs.append(proc)
        socks.append(sock)
    return procs, socks


def measure_production(cfg, raws, packed, scales, offsets, colors, params,
                       cams, geometry, n_frames=20):
    """Real production loop: upload + device step + fetch + host finishing
    + emit. Returns (serial_ms list, pipelined_ms list, host_ms, upload_ms)."""
    import jax
    import jax.numpy as jnp

    from vision_processor_tpu.app.processor import TrackedArrays
    from vision_processor_tpu.parallel.multicam import (
        batched_step_host_tracked,
        make_resample_grids,
    )

    step = batched_step_host_tracked(cfg)
    procs, socks = build_processors(cfg, cams, geometry)

    # in-graph finishing inputs: packed field markings (leading cam axis)
    # and the per-camera reference colors (models/device_finish.py) — the
    # production path finishes on device; the host only assembles protobuf
    from vision_processor_tpu.models.device_finish import pack_field_marks

    marks_one = pack_field_marks(
        procs[0].perspective.field, procs[0].config.geometry_tolerance
    )
    marks = jax.tree.map(
        lambda *xs: jnp.asarray(np.stack(xs)), *([marks_one] * len(procs))
    )
    refs = jnp.asarray(np.stack([p.colors.packed_refs() for p in procs]))

    packed_d = jax.device_put(packed)
    scales_d = jax.device_put(scales)
    offsets_d = jax.device_put(offsets)
    # frame-invariant sampling geometry (cached across frames in production)
    grids = make_resample_grids(
        cfg, packed, float(params["max_bot_height"]), scales, offsets
    )
    bank = [np.roll(raws, (2 * i, 4 * i), axis=(1, 2)) for i in range(4)]

    def colors_now():
        return jnp.asarray(np.stack([p.colors.packed() for p in procs]))

    def tracked_now(now):
        return TrackedArrays.build(
            socks[0].get_tracked_objects(), now, cfg.det.max_tracked
        ).as_dict()

    def dispatch(i, now):
        raw_d = jnp.asarray(bank[i % 4])
        return step(raw_d, packed_d, scales_d, offsets_d, colors_now(),
                    tracked_now(now), params, grids, refs, marks)

    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(len(procs))

    def finish(out, now):
        blobs, det, fin = jax.device_get(out)

        def one(c):
            per_cam = ({k: v[c] for k, v in blobs.items()},
                       {k: v[c] for k, v in det.items()},
                       {k: v[c] for k, v in fin.items()})
            wrapper, _, _ = procs[c].finish_frame(per_cam, now, now)
            wrapper.detection.t_sent = time.time()
            socks[c].send(wrapper)

        list(pool.map(one, range(len(procs))))
        return blobs, det, fin

    # warm up compile + sockets
    out = dispatch(0, 0.0)
    blobs_h, det_h, fin_h = finish(out, 0.0)
    time.sleep(0.2)

    serial = []
    for i in range(n_frames):
        t0 = time.perf_counter()
        out = dispatch(i, t0)
        finish(out, t0)
        serial.append(time.perf_counter() - t0)

    pipelined = []
    pending = dispatch(0, 0.0)
    for i in range(n_frames):
        t0 = time.perf_counter()
        nxt = dispatch(i + 1, t0)
        finish(pending, t0)
        pending = nxt
        pipelined.append(time.perf_counter() - t0)
    jax.block_until_ready(pending)

    # host finishing alone (prefetched numpy; same threaded fan-out as the
    # production loop)
    def host_only(c):
        per_cam = ({k: v[c] for k, v in blobs_h.items()},
                   {k: v[c] for k, v in det_h.items()},
                   {k: v[c] for k, v in fin_h.items()})
        wrapper, _, _ = procs[c].finish_frame(per_cam, 0.0, 0.0)
        wrapper.detection.t_sent = time.time()
        socks[c].send(wrapper)

    # min of 3 medians over per-rep times: host finishing is deterministic
    # work, but outside CPU contention swings a single median between
    # runs (each median already rejects within-round spikes)
    def robust_ms(fn, reps=15, rounds=3):
        medians = []
        for _ in range(rounds):
            rep_times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                rep_times.append(time.perf_counter() - t0)
            medians.append(float(np.median(rep_times)))
            time.sleep(0.05)
        return min(medians) * 1e3

    host_ms = robust_ms(lambda: list(pool.map(host_only, range(len(procs)))))

    # one camera's host finishing alone, serial (what a per-camera-process
    # deployment pays — NOT host_ms / n: the pooled wall time above already
    # overlaps the cameras' numpy work)
    host_single_ms = robust_ms(lambda: host_only(0))

    # upload alone: K-differenced device_put of the 4-camera frameset
    def upload_k(k):
        t0 = time.perf_counter()
        bufs = [jax.device_put(bank[i % 4]) for i in range(k)]
        jax.block_until_ready(bufs)
        return time.perf_counter() - t0
    upload_k(4)
    upload_ms = (upload_k(24) - upload_k(4)) / 20 * 1e3

    for s in socks:
        s.close()
    return serial, pipelined, host_ms, host_single_ms, upload_ms


def main():
    import jax
    import jax.numpy as jnp

    from vision_processor_tpu.utils import setup_compile_cache

    setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench needs a GPU; JAX found {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"bench: device {device}", file=sys.stderr, flush=True)

    # The shipped default grid: resampling_factor 1.25, qualified by the
    # degraded-optics perturbation suite at the same recall bars as 1.0
    # (tests/test_perturbation.py; factor 1.5 fails the medium-profile ball
    # gate, so 1.25 is the ceiling). Factor-1.0 numbers reported alongside.
    FACTOR = 1.25
    print("bench: building rigs...", file=sys.stderr, flush=True)
    rig = build_rig(resampling_factor=FACTOR)
    rig_f1 = build_rig(resampling_factor=1.0)
    # high-occupancy variant: ~1500+ real rendered
    # ball-sized blobs per camera (1900 requested; close placements merge
    # in the render) — fills most of the 2000-slot budget and makes the
    # 512-anchor cap actually bind on device
    rig_dense = build_rig(dense=True, dense_blobs=1900,
                          resampling_factor=FACTOR, return_scenes=True)
    # dense at factor 1.0 too: deployments pinned to factor 1.0 for
    # small-ball fidelity need a worst-case-load number as well
    rig_dense_f1 = build_rig(dense=True, dense_blobs=1900,
                             resampling_factor=1.0, return_scenes=True)
    cfg, raws, packed, scales, offsets, colors, params, geometry, cams = rig
    print("bench: rigs ready", file=sys.stderr, flush=True)

    # in-graph finisher inputs: the sustained scans include finishing with
    # the device-carried color chain (the full production device program)
    import jax as _jax

    from vision_processor_tpu.models.colors import ColorState
    from vision_processor_tpu.models.device_finish import pack_field_marks

    marks_one = pack_field_marks(cams[0][1].field, 10.0)
    marks = _jax.tree.map(
        lambda *xs: jnp.asarray(np.stack(xs)), *([marks_one] * cfg.n_cams)
    )
    refs = jnp.asarray(
        np.stack([ColorState().packed_refs()] * cfg.n_cams)
    )

    rolls = build_rollouts(cfg)
    dev_ms, bots_found, blob_counts, aux = measure_device_sustained(
        rolls, cfg, raws, packed, scales, offsets, colors, params,
        refs, marks)
    print("bench: device sustained done", file=sys.stderr, flush=True)

    cfg_d, raws_d = rig_dense[0], rig_dense[1]
    dev_dense_ms, bots_dense, blob_counts_dense, aux_d = measure_device_sustained(
        rolls, cfg_d, raws_d, *rig_dense[2:7], refs, marks)
    dense_found, dense_total = bot_recall(aux_d["compact"], rig_dense[9])
    print(f"bench: dense sustained done (recall {dense_found}/{dense_total})",
          file=sys.stderr, flush=True)

    dense_quality = measure_dense_precision(
        cfg_d, raws_d, *rig_dense[2:7], rig_dense[9], refs, marks)
    print(f"bench: dense precision done ({dense_quality})",
          file=sys.stderr, flush=True)

    rolls_f1 = build_rollouts(rig_f1[0])
    dev_f1_ms, bots_f1, _, aux_f1 = measure_device_sustained(
        rolls_f1, rig_f1[0], rig_f1[1], *rig_f1[2:7], refs, marks)
    print("bench: factor-1.0 sustained done", file=sys.stderr, flush=True)

    # dense at factor 1.0 (same static shapes as rig_f1 -> compile reuse)
    dev_dense_f1_ms, _, _, aux_df1 = measure_device_sustained(
        rolls_f1, rig_dense_f1[0], rig_dense_f1[1], *rig_dense_f1[2:7],
        refs, marks)
    dense_f1_found, dense_f1_total = bot_recall(
        aux_df1["compact"], rig_dense_f1[9])
    print(f"bench: dense factor-1.0 sustained done "
          f"(recall {dense_f1_found}/{dense_f1_total})",
          file=sys.stderr, flush=True)

    dense_tracked = measure_dense_tracked(
        cfg_d, raws_d, *rig_dense[2:7], rig_dense[8], rig_dense[7],
        rig_dense[9])
    print(f"bench: dense tracked rollout done ({dense_tracked})",
          file=sys.stderr, flush=True)
    dense_tracked_veto = measure_dense_tracked(
        cfg_d, raws_d, *rig_dense[2:7], rig_dense[8], rig_dense[7],
        rig_dense[9], veto=True, suffix="_veto")
    print(f"bench: dense tracked veto rollout done ({dense_tracked_veto})",
          file=sys.stderr, flush=True)

    overlap_frac, upload_meas_s = measure_upload_overlap(
        rolls[50], aux["bank"],
        [np.roll(raws, (2 * i, 4 * i), axis=(1, 2)) for i in range(4)],
        aux["args"], aux["scan50_s"],
    )
    print(f"bench: upload overlap measured ({overlap_frac:.2f})",
          file=sys.stderr, flush=True)

    serial, pipelined, host_ms, host_single_ms, upload_ms = measure_production(
        cfg, raws, packed, scales, offsets, colors, params, cams, geometry)
    print("bench: production loop done", file=sys.stderr, flush=True)

    core_ms, tail_ms = measure_staggered_serial(
        cfg, raws, packed, scales, offsets, colors, params, refs, marks)
    print(f"bench: staggered components done (core {core_ms:.3f}, "
          f"tail {tail_ms:.3f})", file=sys.stderr, flush=True)

    n_cams = cfg.n_cams
    dev_frameset_ms = dev_ms * 1e3
    # upload cost: the measured device_put of one frame-set, discounted by
    # the measured H2D/compute overlap fraction (device_puts streamed
    # against a running scan)
    upload_eff_ms = (1.0 - overlap_frac) * upload_ms
    corrected_serial_ms = upload_ms + dev_frameset_ms + host_ms
    corrected_pipelined_ms = max(dev_frameset_ms + upload_eff_ms, host_ms)
    # STAGGERED serial (glass-to-wire for one frame-set, per-camera
    # dispatch plan): camera 0's upload is exposed; uploads 1..n-1 stream
    # while earlier cores compute (discounted by the measured overlap
    # fraction); the batched tail runs after the last core; only the LAST
    # camera's host finishing is exposed (earlier cameras finish while
    # later cores run). Program-boundary gaps are not modeled.
    upload_one_ms = upload_ms / n_cams
    staggered_device_ms = n_cams * core_ms + tail_ms
    corrected_staggered_ms = (
        upload_one_ms
        + (1.0 - overlap_frac) * (upload_ms - upload_one_ms)
        + staggered_device_ms
        + host_single_ms
    )
    fps_production = n_cams / (corrected_serial_ms / 1e3)
    fps_pipelined = n_cams / (corrected_pipelined_ms / 1e3)
    fps_device = n_cams / dev_ms

    # the band across THIS run's 5 differencing rounds, as fps; the inner
    # band drops the single best and worst round
    def band_to_fps(ms_band):
        return [
            round(n_cams / (max(ms + upload_eff_ms, host_ms) / 1e3), 1)
            for ms in sorted(ms_band, reverse=True)
        ]

    fps_band_rounds = band_to_fps(aux["ms_band"])
    fps_band_rounds_inner = band_to_fps(aux["ms_band_inner"])
    fps_band_rounds_f1 = band_to_fps(aux_f1["ms_band"])
    fps_band_rounds_f1_inner = band_to_fps(aux_f1["ms_band_inner"])

    result = {
        "metric": "production camera-fps/GPU (4x1080p Bayer, max_blobs=2000,"
                  " upload+device+host finishing+emit, 1-frame pipeline,"
                  " qualified resampling_factor=1.25)",
        "value": round(fps_pipelined, 1),
        "unit": "fps",
        "vs_baseline": round(fps_pipelined / 800.0, 3),
        "device": device,
        "detail": {
            "resampling_factor": 1.25,
            "factor_qualification": "ROBOT recall bars hold at factor 1.25 "
                                    "on light+medium degraded optics "
                                    "(tests/test_perturbation.py); BALL "
                                    "recall above factor 1.0 is grid-phase "
                                    "marginal for the ~3 px ball at "
                                    ">6 mm/px cameras (loss-only bar) — "
                                    "small-ball fidelity requires factor "
                                    "1.0, whose numbers are reported "
                                    "alongside (fps_pipelined_factor1)",
            "ms_per_4cam_frameset_device_sustained": round(dev_frameset_ms, 3),
            "ms_per_4cam_frameset_device_sustained_factor1": round(
                dev_f1_ms * 1e3, 3),
            "fps_pipelined_factor1": round(
                n_cams / (max(dev_f1_ms * 1e3 + upload_eff_ms, host_ms) / 1e3), 1),
            "fps_band_rounds_factor1": fps_band_rounds_f1,
            "fps_band_rounds_factor1_inner": fps_band_rounds_f1_inner,
            "bots_found_factor1": bots_f1,
            "ms_per_4cam_frameset_device_sustained_dense": round(dev_dense_ms * 1e3, 3),
            "ms_per_4cam_frameset_device_sustained_dense_factor1": round(
                dev_dense_f1_ms * 1e3, 3),
            "dense_bot_recall_factor1": f"{dense_f1_found}/{dense_f1_total}",
            "ms_host_finishing_per_frameset": round(host_ms, 3),
            "ms_upload_per_frameset": round(upload_ms, 3),
            "p50_frame_latency_ms_corrected_serial": round(corrected_serial_ms, 3),
            # staggered per-camera dispatch plan:
            # glass-to-wire for a 4-camera frame-set
            "p50_frame_latency_ms_corrected_serial_staggered": round(
                corrected_staggered_ms, 3),
            "ms_percam_core": round(core_ms, 3),
            "ms_staggered_tail": round(tail_ms, 3),
            "ms_staggered_device_total": round(staggered_device_ms, 3),
            "staggered_budget_ok": bool(corrected_staggered_ms < 5.0),
            # latency-optimal deployment is one process per camera like the
            # reference: the per-camera slice of upload+device (cameras are
            # unrolled, no shared stages) plus ONE camera's serial host
            # finishing (measured directly — the pooled host number
            # overlaps cameras and must not be divided)
            "p50_ms_per_camera_process_derived": round(
                (upload_ms + dev_frameset_ms) / n_cams
                + host_single_ms, 3),
            "ms_host_finishing_single_camera": round(host_single_ms, 3),
            "sustained_ms_corrected_pipelined": round(corrected_pipelined_ms, 3),
            "fps_serial_corrected": round(fps_production, 1),
            "fps_device_only": round(fps_device, 1),
            "p50_ms_serial_loop": round(
                float(np.percentile(serial, 50)) * 1e3, 3),
            "p50_ms_pipelined_loop": round(
                float(np.percentile(pipelined, 50)) * 1e3, 3),
            "bots_found_4cams": bots_found,
            "blob_counts": blob_counts,
            "bots_found_dense": bots_dense,
            "blob_counts_dense": blob_counts_dense,
            # high-occupancy correctness: ~1500 real rendered blobs/cam on
            # device with the 512-anchor cap binding — every planted robot
            # must still be emitted
            "dense_bot_recall": f"{dense_found}/{dense_total}",
            "dense_recall_ok": bool(dense_found == dense_total),
            # dense-scene quality vs the uncapped reference-enumeration
            # oracle on identical blob inputs:
            # precision of the wire-visible emissions against the planted
            # robots, plus the fraction of device emissions the oracle
            # also emits (and the reverse)
            **dense_quality,
            # steady-state tracked behavior on the dense scene: what a
            # wire consumer sees over a >=20-frame
            # production rollout with tracking feedback; the _veto set
            # repeats it with thresholds.color_plausibility_veto on
            **dense_tracked,
            **dense_tracked_veto,
            "fps_band_rounds": fps_band_rounds,
            "fps_band_rounds_inner": fps_band_rounds_inner,
            "upload_overlap_fraction_measured": round(overlap_frac, 3),
            "ms_upload_per_frameset_during_scan": round(
                upload_meas_s * 1e3, 3),
            "ms_upload_effective_after_measured_overlap": round(
                upload_eff_ms, 3),
            "max_blobs": cfg.bm.max_blobs,
            "detector_anchors": cfg.det.max_anchors,
            "baseline_target_fps": 800,
            "note": "derived numbers sum the scan-differenced device time, "
                    "host finishing and the measured frame-set upload "
                    "discounted by the measured H2D/compute overlap "
                    "fraction; loop numbers as measured included",
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
