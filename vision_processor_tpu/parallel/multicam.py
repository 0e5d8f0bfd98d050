"""Multi-camera scale-out: batched per-chip and sharded across a device mesh.

The reference runs one OS process per camera coordinated only by UDP
multicast packets, including cross-camera tracking input and clock sync
(reference README architecture, src/udpsocket.cpp:204-301). Here:

* one device, N cameras  -> one program with the camera axis unrolled
  (a vmapped camera axis has not been measured on the GPU)
* N devices              -> shard_map over a 1-D ``Mesh(("cam",))``; each
  device owns its camera's frame, and the cross-camera tracking exchange
  is a ``jax.lax.all_gather`` of compact detection summaries — the
  collective replacing the multicast bus (host UDP multicast is still
  emitted for external wire compatibility).

The device-resident loop carries (previous detections, timestamps) as scan
state so tracked-bot search feeds from all cameras without host round trips.
"""
from __future__ import annotations

from dataclasses import dataclass
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.detector import (
    TWO_PI, DetectorConfig, detect, estimate_bot_ids,
    finalize_detections_batched,
)
from ..ops.pipeline import BlobMachineConfig, blob_machine

CAM_AXIS = "cam"

# Tunables that may legitimately differ between cameras of one fleet — the
# reference's process-per-camera model gives every camera its own config
# (reference src/Resources.cpp:188-214). A params dict may carry these as
# scalars (shared) or as (n_cams,) arrays (per-camera); params_for_cam
# slices the per-camera form for one camera's unrolled step.
_PER_CAMERA_PARAM_KEYS = frozenset({
    "min_circularity",
    "min_tracking_radius",
    "max_bot_acceleration",
    "min_confidence",
    "clipping_tolerance",
    "color_plausibility_veto",
    # in-graph finishing tunables (models/device_finish.py)
    "min_score",
    "min_cam_edge_distance",
    "reference_force",
    "history_force",
})


def params_for_cam(params: dict, c: int) -> dict:
    """Slice camera ``c``'s view of a fleet params dict (scalars pass
    through; per-camera (n_cams,) arrays are indexed)."""
    return {
        k: v[c]
        if k in _PER_CAMERA_PARAM_KEYS and getattr(v, "ndim", 0) >= 1
        else v
        for k, v in params.items()
    }


def _shard_param(v, cam0, n_local: int):
    """This shard's (n_local,) window of a possibly-per-camera tunable.

    Replicated params carry GLOBAL (n_cams,) arrays; inside shard_map the
    shard's cameras start at traced ``cam0``. Scalars pass through."""
    if getattr(v, "ndim", 0) >= 1:
        return jax.lax.dynamic_slice_in_dim(v, cam0, n_local)
    return v


@dataclass(frozen=True)
class MultiCamConfig:
    bm: BlobMachineConfig
    det: DetectorConfig
    n_cams: int


def _single_cam_step(
    cfg: MultiCamConfig,
    raw,
    packed_cam,
    field_scale,
    field_offset,
    colors7,
    tracked,
    params,
    rs_grid=None,
    finalize: bool = True,
):
    """One camera's frame -> blob slots (+ detection summary).

    ``finalize=False`` returns ``(blobs, det)`` with PRE-suppression
    detections and no id estimate / summary — callers stacking several
    cameras complete them with ``finalize_batched`` instead. The deferred
    pieces (greedy clipping NMS, the 24-iteration guarded 2-means id
    estimate) are sequences of tiny-tensor ops, so one vmapped pass over
    the camera axis costs ~n_cams-fold fewer sequenced ops than per-camera
    unrolled copies.
    """
    blobs = blob_machine(
        cfg.bm,
        raw,
        packed_cam,
        params["max_bot_height"],
        params["min_circularity"],
        field_scale=field_scale,
        field_offset=field_offset,
        rs_grid=rs_grid,
    )
    det = detect(cfg.det, blobs, tracked, colors7[:6], packed_cam, params,
                 with_nms=finalize)
    out_blobs = {
        k: blobs[k]
        for k in ("field_pos", "color", "center", "circ", "score", "valid", "count")
    }
    if not finalize:
        return out_blobs, det
    bot_id = estimate_bot_ids(det, blobs["color"], colors7)
    det["bot_id_est"] = bot_id
    summary = {
        "pos": det["bot_pos"],
        "orientation": det["bot_orientation"],
        "score": jnp.where(det["bot_valid"], det["bot_score"], 0.0),
        "id": jnp.where(det["bot_valid"], bot_id, -1),
    }
    return out_blobs, det, summary


def finalize_batched(blobs, det, colors7, clipping_tolerance, ball_radius):
    """Complete ``_single_cam_step(finalize=False)`` outputs over the
    stacked camera axis: vmapped clipping NMS + ball-clip mask, batched id
    estimate, and the detection summary. Returns (det, summary) with
    results identical to the per-camera path."""
    det = finalize_detections_batched(
        det, blobs["field_pos"], blobs["valid"], clipping_tolerance,
        ball_radius,
    )
    bot_id = jax.vmap(estimate_bot_ids)(det, blobs["color"], colors7)
    det["bot_id_est"] = bot_id
    summary = {
        "pos": det["bot_pos"],
        "orientation": det["bot_orientation"],
        "score": jnp.where(det["bot_valid"], det["bot_score"], 0.0),
        "id": jnp.where(det["bot_valid"], bot_id, -1),
    }
    return det, summary


def tracked_from_summaries(det_cfg: DetectorConfig, summaries, time_delta,
                           prev_summaries=None, bot_heights=None):
    """Build tracked-bot arrays from (all cameras') detection summaries.

    summaries: dict of stacked (n_cams, B, ...) arrays from the previous
    frame. Entries are deduplicated by bot id first (an overlap-region
    robot appears once per camera that sees it — the host path dedups in
    TrackedArrays.build, reference src/udpsocket.cpp:204-256 keys its
    tracker on id), keeping the best-score observation per id, then the
    top ``max_tracked`` by score. With ``prev_summaries`` (the frame
    before that), per-id finite-difference velocities — linear AND
    angular — feed the tracked search's extrapolation, the device-loop
    analogue of the UDP tracker's velocities (reference
    src/udpsocket.cpp:236-249); without it velocities are zero.

    ``bot_heights``: optional (2,) [yellow, blue] tracking heights in mm
    (the GCSocket team heights, reference src/udpsocket.cpp:304-314);
    defaults to the reference's default_bot_height=143.
    """
    t = det_cfg.max_tracked
    pos = summaries["pos"].reshape(-1, 2)
    orient = summaries["orientation"].reshape(-1)
    score = summaries["score"].reshape(-1)
    ids = summaries["id"].reshape(-1)
    n = score.shape[0]
    valid = (score > 0.0) & (ids >= 0)

    # dedup by id: keep the single best-score entry per id (ties: lowest
    # slot). Without this, one robot seen by 3 overlapping cameras eats 3
    # of the max_tracked slots and can evict a distinct robot entirely.
    iid = jnp.where(valid, jnp.clip(ids, 0, 31), 32)
    sc = jnp.where(valid, score, -jnp.inf)
    best = jnp.full(33, -jnp.inf, score.dtype).at[iid].max(sc)
    is_max = valid & (sc == best[iid])
    slot = jnp.where(is_max, jnp.arange(n, dtype=jnp.int32), n)
    first = jnp.full(33, n, jnp.int32).at[iid].min(slot)
    valid &= is_max & (jnp.arange(n, dtype=jnp.int32) == first[iid])

    top_score, top_i = jax.lax.top_k(jnp.where(valid, score, -jnp.inf), t)
    keep = top_score > 0.0
    sel_ids = jnp.where(keep, ids[top_i], -1).astype(jnp.int32)
    sel_x = pos[top_i, 0]
    sel_y = pos[top_i, 1]
    sel_w = orient[top_i]
    zero = jnp.zeros(t, dtype=jnp.float32)
    vx = vy = vw = zero
    if prev_summaries is not None:
        ppos = prev_summaries["pos"].reshape(-1, 2)
        porient = prev_summaries["orientation"].reshape(-1)
        pscore = prev_summaries["score"].reshape(-1)
        pids = prev_summaries["id"].reshape(-1)
        pvalid = (pscore > 0.0) & (pids >= 0)
        # first previous-frame observation of each selected id
        match = (sel_ids[:, None] == pids[None, :]) & pvalid[None, :] & (
            sel_ids[:, None] >= 0
        )
        found = jnp.any(match, axis=1)
        j = jnp.argmax(match, axis=1)
        dt = jnp.maximum(jnp.float32(time_delta), 1e-4)
        vx = jnp.where(found, (sel_x - ppos[j, 0]) / dt, 0.0)
        vy = jnp.where(found, (sel_y - ppos[j, 1]) / dt, 0.0)
        dw = sel_w - porient[j]
        dw = dw - TWO_PI * jnp.round(dw / TWO_PI)  # shortest angular diff
        vw = jnp.where(found, dw / dt, 0.0)
    if bot_heights is None:
        z = jnp.full(t, 143.0, dtype=jnp.float32)
    else:
        heights = jnp.asarray(bot_heights, dtype=jnp.float32)
        z = jnp.where(sel_ids >= 16, heights[1], heights[0])
    return {
        "id": sel_ids,
        "x": sel_x,
        "y": sel_y,
        "z": z,
        "w": sel_w,
        "vx": vx,
        "vy": vy,
        "vw": vw,
        "time_delta": jnp.full(t, time_delta, dtype=jnp.float32),
        "valid": keep,
    }


# ---------------------------------------------------------------------------
# single chip: unrolled camera batch
# ---------------------------------------------------------------------------


def resample_grids_traced(
    cfg: MultiCamConfig, packed_cams, max_bot_height, field_scales, field_offsets
):
    """In-graph stacked per-camera sampling geometry (leading cam axis).

    jit-compatible (all inputs may be traced); unrolled over cameras like
    the step itself.
    """
    from ..ops import frame as F

    grids = [
        F.resample_grid(
            packed_cams[c],
            max_bot_height,
            field_scales[c],
            field_offsets[c],
            cfg.bm.flat_shape,
            cfg.bm.plane_shape,
        )
        for c in range(cfg.n_cams)
    ]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *grids)


def make_resample_grids(
    cfg: MultiCamConfig, packed_cams, max_bot_height, field_scales, field_offsets
):
    """Host-side cache entry point: stacked per-camera frame-invariant
    sampling geometry. Recompute on calibration / bot-height change only."""
    return jax.jit(
        lambda p, s, o: resample_grids_traced(
            cfg, p, jnp.float32(max_bot_height), s, o
        )
    )(
        jnp.asarray(np.asarray(packed_cams), dtype=jnp.float32),
        jnp.asarray(np.asarray(field_scales), dtype=jnp.float32),
        jnp.asarray(np.asarray(field_offsets), dtype=jnp.float32),
    )


def batched_step(cfg: MultiCamConfig):
    """Returns a jitted fn processing all cameras of one chip in one program.

    Inputs carry a leading camera axis; tracked priors are shared (every
    camera sees the fleet's previous detections). ``rs_grids`` (optional,
    from make_resample_grids) replays the cached projection geometry.
    """

    def step(raws, packed_cams, field_scales, field_offsets, colors7,
             prev_summary, params, rs_grids=None, prev_prev_summary=None,
             colors7_refs=None, marks=None):
        tracked = tracked_from_summaries(
            cfg.det, prev_summary, params["tracked_time_delta"],
            prev_summaries=prev_prev_summary,
            bot_heights=params.get("bot_heights_yb"),
        )
        # cameras are unrolled rather than vmapped, so each camera's
        # gathers (the resampling + hypothesis lookups) stay unbatched
        outs = [
            _single_cam_step(
                cfg, raws[c], packed_cams[c], field_scales[c],
                field_offsets[c], colors7[c], tracked,
                params_for_cam(params, c),
                rs_grid=None if rs_grids is None
                else jax.tree.map(lambda x: x[c], rs_grids),
                finalize=False,
            )
            for c in range(cfg.n_cams)
        ]
        blobs, det = (
            jax.tree.map(lambda *xs: jnp.stack(xs), *group) for group in zip(*outs)
        )
        det, summary = finalize_batched(
            blobs, det, colors7, params["clipping_tolerance"],
            params["ball_radius"],
        )
        if marks is None:
            return blobs, det, summary
        # in-graph finishing, BATCHED over cameras (see
        # batched_step_host_tracked for why vmap is right here)
        from ..models.device_finish import (
            finish_on_device_batched, stack_finish_params,
        )

        fin = finish_on_device_batched(
            blobs, det, colors7, colors7_refs, packed_cams, marks,
            stack_finish_params(params, cfg.n_cams),
        )
        return blobs, det, summary, fin

    return jax.jit(step)


def batched_step_host_tracked(cfg: MultiCamConfig):
    """Like ``batched_step`` but with the tracked prior supplied by the host.

    The production multi-camera app builds the tracked arrays from the UDP
    tracker every frame (full fleet state — own cameras' previous detections
    plus any external per-camera processes on the wire, with real
    finite-difference velocities, reference src/udpsocket.cpp:204-256), so
    the device loop's summary feedback is not used and host-side id
    assignment stays authoritative.
    """

    def step(raws, packed_cams, field_scales, field_offsets, colors7,
             tracked, params, rs_grids=None, colors7_refs=None, marks=None):
        outs = [
            _single_cam_step(
                cfg, raws[c], packed_cams[c], field_scales[c],
                field_offsets[c], colors7[c], tracked,
                params_for_cam(params, c),
                rs_grid=None if rs_grids is None
                else jax.tree.map(lambda x: x[c], rs_grids),
                finalize=False,
            )
            for c in range(cfg.n_cams)
        ]
        blobs, det = (
            jax.tree.map(lambda *xs: jnp.stack(xs), *group) for group in zip(*outs)
        )
        det, _ = finalize_batched(
            blobs, det, colors7, params["clipping_tolerance"],
            params["ball_radius"],
        )
        if marks is None:
            return blobs, det
        # in-graph finishing, BATCHED over cameras (vmap, not the unrolled
        # loop the blob machine needs): the finisher is op-dispatch-bound
        # small-tensor math with no image-scale gathers, so batching cuts
        # its device cost ~n_cams-fold; marks carry a leading cam axis so
        # per-camera geometry tolerances are honored
        from ..models.device_finish import (
            finish_on_device_batched, stack_finish_params,
        )

        fin = finish_on_device_batched(
            blobs, det, colors7, colors7_refs, packed_cams, marks,
            stack_finish_params(params, cfg.n_cams),
        )
        return blobs, det, fin

    return jax.jit(step)


def percam_core_step(cfg: MultiCamConfig):
    """One camera's blob machine + hypothesis search (finalize deferred) as
    a standalone jitted program — the unit of the STAGGERED serial
    pipeline: camera c's core dispatches as soon as ITS raw frame lands on
    device, so uploads 1..n-1 and the per-camera host work hide under
    compute instead of waiting for the whole frame-set (the batched
    program exposes the full upload because every input must be resident
    before dispatch).

    Callers slice per-camera tunables with ``params_for_cam`` first.
    """

    def step(raw, packed_cam, field_scale, field_offset, colors7, tracked,
             params, rs_grid=None):
        return _single_cam_step(
            cfg, raw, packed_cam, field_scale, field_offset, colors7,
            tracked, params, rs_grid=rs_grid, finalize=False,
        )

    return jax.jit(step)


def staggered_tail_step(cfg: MultiCamConfig):
    """The cross-stacked tail of the staggered pipeline: batched clipping
    NMS + ids (finalize_batched) and the in-graph finisher over the
    stacked per-camera core outputs. One small program dispatched after
    the last camera's core; its cost is amortized across cameras exactly
    like in the batched step.

    With ``marks=None`` (device_finish off) the tail is the batched
    finalize only and ``fin`` comes back None, mirroring
    ``batched_step_host_tracked``'s no-marks contract."""

    def tail(blobs, det, colors7, packed_cams, params, colors7_refs=None,
             marks=None):
        det, _ = finalize_batched(
            blobs, det, colors7, params["clipping_tolerance"],
            params["ball_radius"],
        )
        if marks is None:
            return det, None
        from ..models.device_finish import (
            finish_on_device_batched, stack_finish_params,
        )

        fin = finish_on_device_batched(
            blobs, det, colors7, colors7_refs, packed_cams, marks,
            stack_finish_params(params, cfg.n_cams),
        )
        return det, fin

    return jax.jit(tail)


# ---------------------------------------------------------------------------
# multi chip: shard_map over a camera mesh
# ---------------------------------------------------------------------------


def make_camera_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (CAM_AXIS,))


def sharded_step(cfg: MultiCamConfig, mesh: Mesh, fused: bool = False):
    """Returns a jitted fn sharding ``cfg.n_cams`` cameras over the mesh.

    Each device owns ``n_cams / n_devices`` cameras (the production shape
    for a large rig — e.g. 8 cameras on 4 GPUs) and runs their blob
    machines + hypothesis searches unrolled like the single-device
    batch. The detection summaries are all-gathered so every
    camera's next frame can track every robot on the field.

    With ``fused=True`` the in-graph finisher (models/device_finish.py)
    also runs per camera: the call takes two extra args — per-camera
    reference colors (sharded) and the packed field markings (replicated,
    same field) — and returns a fourth ``fin`` output sharded like the
    blobs.
    """
    n_dev = int(np.prod(mesh.devices.shape))
    if cfg.n_cams % n_dev:
        raise ValueError(
            f"n_cams={cfg.n_cams} must divide over {n_dev} devices"
        )
    n_local = cfg.n_cams // n_dev

    def per_device(raw, packed_cam, field_scale, field_offset, colors7,
                   prev_gathered, params, *fin_args):
        # inputs arrive with a leading local shard axis of size n_local.
        # params is REPLICATED (P()), so per-camera (n_cams,) tunable
        # arrays must be indexed by the GLOBAL camera id, not the local
        # shard offset.
        cam0 = jax.lax.axis_index(CAM_AXIS) * n_local
        tracked = tracked_from_summaries(
            cfg.det, prev_gathered, params["tracked_time_delta"],
            bot_heights=params.get("bot_heights_yb"),
        )
        outs = [
            _single_cam_step(
                cfg,
                raw[i],
                packed_cam[i],
                field_scale[i],
                field_offset[i],
                colors7[i],
                tracked,
                params_for_cam(params, cam0 + i),
                rs_grid=None,  # single-shot call: projection stays in-line
                finalize=False,
            )
            for i in range(n_local)
        ]
        blobs, det = (
            jax.tree.map(lambda *xs: jnp.stack(xs), *group)
            for group in zip(*outs)
        )
        det, summary = finalize_batched(
            blobs, det, colors7, _shard_param(params["clipping_tolerance"],
                                              cam0, n_local),
            params["ball_radius"],
        )
        # collective: share this shard's detections with the fleet
        gathered = jax.tree.map(
            lambda x: jax.lax.all_gather(x, CAM_AXIS), summary
        )
        if not fused:
            return blobs, det, gathered
        colors7_refs, marks = fin_args
        from ..models.device_finish import (
            finish_on_device_batched, stack_finish_params,
        )

        # finisher params: slice global per-camera tunables to this shard
        fparams = {
            k: _shard_param(v, cam0, n_local)
            if k in _PER_CAMERA_PARAM_KEYS else v
            for k, v in params.items()
        }
        marks_l = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (n_local,) + x.shape), marks
        )
        fin = finish_on_device_batched(
            blobs, det, colors7, colors7_refs, packed_cam, marks_l,
            stack_finish_params(fparams, n_local),
        )
        return blobs, det, gathered, fin

    spec_cam = P(CAM_AXIS)
    spec_rep = P()

    in_specs = [spec_cam, spec_cam, spec_cam, spec_cam, spec_cam, spec_rep,
                spec_rep]
    out_specs = [spec_cam, spec_cam, spec_rep]
    if fused:
        in_specs += [spec_cam, spec_rep]
        out_specs += [spec_cam]

    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=tuple(out_specs),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_rollout(cfg: MultiCamConfig, mesh: Mesh, n_frames: int):
    """Device-resident N-frame loop over the camera mesh.

    Each device scans its own camera's frames; after every frame the
    detection summaries are all_gathered so the next frame's
    tracked-bot search sees the whole fleet — the sustained form of the
    reference's cross-camera tracking exchange
    (reference src/udpsocket.cpp:204-256). Returns per-frame compact
    outputs (tracked ids, validity, the gathered summary ids) so handoff
    across camera boundaries is observable.
    """

    n_dev_r = int(np.prod(mesh.devices.shape))
    if cfg.n_cams % n_dev_r:
        raise ValueError(
            f"n_cams={cfg.n_cams} must divide over {n_dev_r} devices"
        )
    n_local = cfg.n_cams // n_dev_r

    def per_device(bank, packed_cam, field_scale, field_offset, colors7, params):
        # bank arrives (n_frames, n_local, ...) — this shard's cameras
        from ..ops import frame as F

        # frame-invariant sampling geometry, hoisted out of the scan
        grids = [
            F.resample_grid(
                packed_cam[i], params["max_bot_height"], field_scale[i],
                field_offset[i], cfg.bm.flat_shape, cfg.bm.plane_shape,
            )
            for i in range(n_local)
        ]

        # params is replicated: per-camera tunables index by GLOBAL cam id
        cam0 = jax.lax.axis_index(CAM_AXIS) * n_local

        def body(carry, raw):
            gathered, prev_gathered = carry
            tracked = tracked_from_summaries(
                cfg.det, gathered, params["tracked_time_delta"],
                prev_summaries=prev_gathered,
                bot_heights=params.get("bot_heights_yb"),
            )
            outs = [
                _single_cam_step(
                    cfg, raw[i], packed_cam[i], field_scale[i],
                    field_offset[i], colors7[i], tracked,
                    params_for_cam(params, cam0 + i),
                    rs_grid=grids[i],
                    finalize=False,
                )
                for i in range(n_local)
            ]
            blobs, det = (
                jax.tree.map(lambda *xs: jnp.stack(xs), *group)
                for group in zip(*outs)
            )
            det, summary = finalize_batched(
                blobs, det, colors7,
                _shard_param(params["clipping_tolerance"], cam0, n_local),
                params["ball_radius"],
            )
            nxt = jax.tree.map(
                lambda x: jax.lax.all_gather(x, CAM_AXIS), summary
            )
            out = {
                "bot_tracked_id": det["bot_tracked_id"],
                "bot_valid": det["bot_valid"],
                "bot_pos": det["bot_pos"],
                # flatten (n_dev, n_local, ...) -> (n_cams, ...) so the
                # observable summary shape is device-layout independent
                "summary_id": nxt["id"].reshape(cfg.n_cams, -1),
                "summary_pos": nxt["pos"].reshape(cfg.n_cams, -1, 2),
            }
            return (nxt, gathered), out

        empty = jax.tree.map(
            lambda x: jax.lax.all_gather(x, CAM_AXIS),
            _empty_summary_local(cfg, n_local),
        )
        _, outs = jax.lax.scan(body, (empty, empty), bank)
        return outs

    spec_cam = P(CAM_AXIS)
    spec_frames_cam = P(None, CAM_AXIS)
    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(spec_frames_cam, spec_cam, spec_cam, spec_cam, spec_cam, P()),
        out_specs={
            "bot_tracked_id": spec_frames_cam,
            "bot_valid": spec_frames_cam,
            "bot_pos": spec_frames_cam,
            "summary_id": P(),
            "summary_pos": P(),
        },
        check_vma=False,
    )
    return jax.jit(fn)


def _empty_summary_local(cfg: MultiCamConfig, n_local: int = 1) -> dict:
    b = cfg.det.max_bots
    return {
        "pos": jnp.zeros((n_local, b, 2), dtype=jnp.float32),
        "orientation": jnp.zeros((n_local, b), dtype=jnp.float32),
        "score": jnp.zeros((n_local, b), dtype=jnp.float32),
        "id": jnp.full((n_local, b), -1, dtype=jnp.int32),
    }


def empty_summary(cfg: MultiCamConfig) -> dict:
    b = cfg.det.max_bots
    n = cfg.n_cams
    return {
        "pos": jnp.zeros((n, b, 2), dtype=jnp.float32),
        "orientation": jnp.zeros((n, b), dtype=jnp.float32),
        "score": jnp.zeros((n, b), dtype=jnp.float32),
        "id": jnp.full((n, b), -1, dtype=jnp.int32),
    }


def make_rollout(cfg: MultiCamConfig, step_fn, n_frames: int):
    """Device-resident N-frame loop via lax.scan (for sustained-rate
    benchmarking): each iteration processes the next frame-set from a bank of
    distinct frames (so no stage is loop-invariant and the whole pipeline
    really runs every step) and feeds the previous detections back as
    tracking priors. Returns a jitted fn(raw_bank, packed, scales, offsets,
    colors, params[, colors7_refs, marks]) with raw_bank (K, n_cams, ...).

    With ``colors7_refs``/``marks`` the in-graph finisher runs every frame
    and the color table is carried through the scan exactly like the
    production device-carried chain (Processor._colors_dev) — so the
    sustained number prices the FULL production device program, finishing
    included."""

    def scan_fn(raw_bank, packed_cams, field_scales, field_offsets, colors7,
                params, colors7_refs=None, marks=None):
        n_bank = raw_bank.shape[0]
        # frame-invariant sampling geometry, computed once per rollout
        grids = resample_grids_traced(
            cfg, packed_cams, params["max_bot_height"], field_scales,
            field_offsets,
        )

        def body(carry, _):
            i, prev_summary, prev_prev, colors_c = carry
            raws = jax.lax.dynamic_index_in_dim(
                raw_bank, i % n_bank, axis=0, keepdims=False
            )
            if marks is None:
                blobs, det, summary = step_fn(
                    raws, packed_cams, field_scales, field_offsets, colors_c,
                    prev_summary, params, grids, prev_prev,
                )
                colors_next = colors_c
                n_balls = jnp.zeros(cfg.n_cams, dtype=jnp.int32)
            else:
                blobs, det, summary, fin = step_fn(
                    raws, packed_cams, field_scales, field_offsets, colors_c,
                    prev_summary, params, grids, prev_prev,
                    colors7_refs, marks,
                )
                colors_next = fin["colors7"]
                n_balls = jnp.sum(fin["ball_valid"], axis=-1).astype(jnp.int32)
            compact = {
                "count": blobs["count"],
                "bot_valid": det["bot_valid"],
                "bot_pos": det["bot_pos"],
                "n_balls": n_balls,
            }
            return (i + 1, summary, prev_summary, colors_next), compact

        init = (jnp.int32(0), empty_summary(cfg), empty_summary(cfg), colors7)
        return jax.lax.scan(body, init, None, length=n_frames)

    return jax.jit(scan_fn)
