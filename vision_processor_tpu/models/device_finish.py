"""In-graph frame finishing: color update, id recalculation, ball scoring,
filters, and emission projections — the device half of what the reference
does on the host after the GPU kernels return
(reference src/main.cpp:320-371, src/blobs/colorupdate.cpp:21-120,
src/blobs/hypothesis.cpp:83-94,208-270).

Why on device: the host finishing path is pure Python/numpy over tiny
arrays and holds the GIL, so four cameras' finishing on one process
serializes. Everything here is shape-static vectorized math, so
it fuses into the per-camera XLA program; the host keeps only protobuf
assembly over the handful of surviving detections.

Semantics parity with the host path (models/host_detect.py,
models/colors.py) is bit-level where integers are involved (blend
truncation, k-means integer mean division) and float32-level for
projections/score ratios; tests/test_device_finish.py asserts parity on
the bench scenes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .camera import field2image_packed, goal_boundary_width, image2field_packed
from .detector import estimate_bot_ids
from .pattern import PATTERNS

_BIG_I32 = jnp.int32(2**30)


# ---------------------------------------------------------------------------
# host-side static packing (per geometry version)
# ---------------------------------------------------------------------------


def pack_field_marks(field, geometry_tolerance: float) -> dict:
    """Static field-marking arrays for the in-graph ``balls_at_lines`` test
    (host counterpart: host_detect.balls_at_lines,
    reference src/blobs/colorupdate.cpp:21-40).

    Returns float32 arrays with geometry-static shapes: ``lines`` (L, 4) as
    x1,y1,x2,y2 and ``arcs`` (A, 5) as cx,cy,r,a1,a2, plus scalars the
    ball-emission filters need (max line distance, extended field half
    extents).
    """
    lines = np.asarray(
        [
            [line.p1.x, line.p1.y, line.p2.x, line.p2.y]
            for line in field.field_lines
        ],
        dtype=np.float32,
    ).reshape(-1, 4)
    arcs = np.asarray(
        [
            [arc.center.x, arc.center.y, arc.radius, arc.a1, arc.a2]
            for arc in field.field_arcs
        ],
        dtype=np.float32,
    ).reshape(-1, 5)
    return {
        "lines": lines,
        "arcs": arcs,
        "max_d": np.float32(field.line_thickness / 2 + geometry_tolerance),
        "half_len": np.float32(
            field.field_length / 2 + goal_boundary_width(field)
        ),
        "half_wid": np.float32(field.field_width / 2 + field.boundary_width),
    }


# ---------------------------------------------------------------------------
# masked guarded 2-means (single group, variable membership)
# ---------------------------------------------------------------------------


def masked_kmeans2(contrast, vals, mask, c1_init, c2_init, iters: int = 24):
    """Guarded 2-means over the masked rows of ``vals`` — the in-graph form
    of the host's scalar ``kmeans2`` (models/kmeans.py, reference
    src/blobs/kmeans.cpp:20-90), which runs over a variable-length color
    list (bot center blobs; ball candidates).

    All guards are preserved: <2 members, in-group tighter than the
    contrast distance, degenerate seeds, emptied cluster, weak split —
    each restores the initial centers. Integer mean division matches the
    host (non-negative dRGB values, floor == trunc). The fixed-point loop
    stops per the scalar rule (either center repeating) and is capped at
    ``iters`` like the host batch path (kmeans2_batch max_iters=24).

    contrast (3,), vals (N, 3), mask (N,), inits (3,) — all int32 except
    the boolean mask. Returns (ok, c1, c2).
    """
    vals = vals.astype(jnp.int32)
    contrast = contrast.astype(jnp.int32)
    c1_init = c1_init.astype(jnp.int32)
    c2_init = c2_init.astype(jnp.int32)
    n = vals.shape[0]
    m = jnp.sum(mask)

    d_out = jnp.sum((vals - contrast) ** 2, axis=-1)
    out_group = jnp.min(jnp.where(mask, d_out, _BIG_I32))

    # pairwise distances via the norm expansion: dRGB components are small
    # ints, so every product is exact in f32 and this runs as one tiny
    # matmul instead of an (N, N, 3) broadcast. The default precision may
    # run it in TF32 on the GPU; that stays exact because every integer
    # with |v| < 2048 fits TF32's 11 significand bits, and dRGB values are
    # bounded by 255 in magnitude
    vf = vals.astype(jnp.float32)
    nrm = jnp.sum(vf * vf, axis=-1)
    pair = nrm[:, None] + nrm[None, :] - 2.0 * (vf @ vf.T)
    pmask = mask[:, None] & mask[None, :] & ~jnp.eye(n, dtype=bool)
    in_group = jnp.min(jnp.where(pmask, pair, jnp.float32(2**30)))
    may_split = (in_group <= out_group.astype(jnp.float32)) & (m >= 2)

    d1i = jnp.sum((vals - c1_init) ** 2, axis=-1)
    d2i = jnp.sum((vals - c2_init) ** 2, axis=-1)
    c1 = vals[jnp.argmin(jnp.where(mask, d1i, _BIG_I32))]
    c2 = vals[jnp.argmin(jnp.where(mask, d2i, _BIG_I32))]
    degenerate = jnp.all(c1 == c2)

    ok = may_split & ~degenerate

    # early-exit fixed point: exact vs the full `iters` unroll (an
    # inactive iteration is a no-op — see detector._guarded_kmeans2), but
    # ~4x fewer sequenced tiny ops on typical 2-4-round convergence
    def _cond(carry):
        it, _c1, _c2, _ok, active = carry
        return (it < iters) & jnp.any(active)

    def _body(carry):
        it, c1, c2, ok, active = carry
        d1 = jnp.sum((vals - c1) ** 2, axis=-1)
        d2 = jnp.sum((vals - c2) ** 2, axis=-1)
        assign1 = (d1 < d2) & mask
        assign2 = mask & ~assign1
        n1 = jnp.sum(assign1)
        n2 = m - n1
        empty = (n1 == 0) | (n2 == 0)
        ok = ok & ~(empty & active)
        active = active & ~empty
        s1 = jnp.sum(jnp.where(assign1[:, None], vals, 0), axis=0)
        s2 = jnp.sum(jnp.where(assign2[:, None], vals, 0), axis=0)
        new1 = s1 // jnp.maximum(n1, 1)
        new2 = s2 // jnp.maximum(n2, 1)
        conv = jnp.all(new1 == c1) | jnp.all(new2 == c2)
        c1 = jnp.where(active, new1, c1)
        c2 = jnp.where(active, new2, c2)
        active = active & ~conv
        return it + 1, c1, c2, ok, active

    _, c1, c2, ok, _ = jax.lax.while_loop(
        _cond, _body, (jnp.int32(0), c1, c2, ok, ok)
    )

    split = jnp.sum((c1 - c2) ** 2).astype(jnp.float32)
    ok = ok & (split >= out_group.astype(jnp.float32) / 4.0)
    c1 = jnp.where(ok, c1, c1_init)
    c2 = jnp.where(ok, c2, c2_init)
    return ok, c1, c2


# ---------------------------------------------------------------------------
# color state update (ColorState.update + update_field_line, in-graph)
# ---------------------------------------------------------------------------


def _blend(ref, old, new, ref_force, hist_force):
    """Reference/history/update blend with the host's integer truncation
    (reference src/blobs/colorupdate.cpp:58-66; ColorState._blend)."""
    upd = 1.0 - ref_force - hist_force
    mixed = (
        ref_force * ref.astype(jnp.float32)
        + hist_force * old.astype(jnp.float32)
        + upd * new.astype(jnp.float32)
    )
    # boundary nudge (matches ColorState._blend): a stationary color's
    # mix lands exactly on the integer boundary, where f32 fusion-order
    # differences between compilations (batched vs unrolled) flip the
    # trunc by 1 and the color random-walks downward
    return jnp.trunc(mixed + 1e-3).astype(jnp.int32)


def balls_at_lines_device(marks, pos):
    """(N,) mask of field positions on a field marking — in-graph form of
    host_detect.balls_at_lines (reference src/blobs/colorupdate.cpp:21-40).

    marks: pack_field_marks output; pos (N, 2) float32.
    """
    max_d = marks["max_d"]
    hit = jnp.zeros(pos.shape[0], dtype=bool)
    lines = marks["lines"]
    if lines.shape[0]:
        p1 = lines[:, 0:2]  # (L, 2)
        v = lines[:, 2:4] - p1  # (L, 2)
        vv = jnp.sum(v * v, axis=-1)  # (L,)
        w = pos[:, None, :] - p1[None, :, :]  # (N, L, 2)
        t = jnp.sum(w * v[None], axis=-1) / jnp.maximum(vv, 1e-9)
        t = jnp.where(vv > 0, jnp.clip(t, 0.0, 1.0), 0.0)  # (N, L)
        d2 = jnp.sum((w - t[..., None] * v[None]) ** 2, axis=-1)
        hit |= jnp.any(d2 <= max_d * max_d, axis=-1)
    arcs = marks["arcs"]
    if arcs.shape[0]:
        rel = pos[:, None, :] - arcs[None, :, 0:2]  # (N, A, 2)
        ang = jnp.arctan2(rel[..., 1], rel[..., 0])
        ang = jnp.where(ang < 0, ang + 2 * jnp.pi, ang)
        r = jnp.sqrt(jnp.sum(rel * rel, axis=-1))
        hit |= jnp.any(
            (jnp.abs(r - arcs[None, :, 2]) <= max_d)
            & (ang >= arcs[None, :, 3])
            & (ang <= arcs[None, :, 4]),
            axis=-1,
        )
    return hit


def update_colors_device(
    colors7,
    colors7_ref,
    bot_valid,
    bot_id,
    c5,
    present,
    ball_center_colors,
    ball_mask,
    at_line_mask,
    blob_mean_colors,
    ref_force,
    hist_force,
):
    """One frame's adaptive color update, mirroring ColorState.update +
    update_field_line in order (reference src/blobs/colorupdate.cpp:42-120).

    colors7/colors7_ref: (7, 3) [orange, field, yellow, blue, green, pink,
    field_line]. c5 (B, 5, 3) int32 constellation colors with ``present``
    (B, 5) slot mask; ball_* over the blob slots. Returns the new (7, 3)
    int32 table.
    """
    ci = colors7.astype(jnp.int32)
    ri = colors7_ref.astype(jnp.int32)
    orange_o, field_o, yellow_o, blue_o, green_o, pink_o, line_o = (
        ci[0], ci[1], ci[2], ci[3], ci[4], ci[5], ci[6],
    )

    # green/pink accumulation over accepted side blobs by pattern bit
    pattern = jnp.asarray(PATTERNS, dtype=jnp.int32)[bot_id % 16]  # (B,)
    bits = (pattern[:, None] >> jnp.arange(3, -1, -1, dtype=jnp.int32)) & 1
    side_ok = present[:, 1:5] & bot_valid[:, None]
    green_m = side_ok & (bits == 1)
    pink_m = side_ok & (bits == 0)
    sides = c5[:, 1:5]
    green_sum = jnp.sum(jnp.where(green_m[..., None], sides, 0), axis=(0, 1))
    pink_sum = jnp.sum(jnp.where(pink_m[..., None], sides, 0), axis=(0, 1))
    green_n = jnp.sum(green_m)
    pink_n = jnp.sum(pink_m)

    pink_new = jnp.where(
        pink_n > 0,
        _blend(ri[5], pink_o, pink_sum // jnp.maximum(pink_n, 1), ref_force, hist_force),
        pink_o,
    )
    green_new = jnp.where(
        green_n > 0,
        _blend(ri[4], green_o, green_sum // jnp.maximum(green_n, 1), ref_force, hist_force),
        green_o,
    )

    # team colors from the center blobs (contrast: the just-updated pink)
    center_mask = bot_valid & present[:, 0]
    ok_yb, y, b = masked_kmeans2(pink_new, c5[:, 0], center_mask, yellow_o, blue_o)
    yellow_new = jnp.where(
        ok_yb, _blend(ri[2], yellow_o, y, ref_force, hist_force), yellow_o
    )
    blue_new = jnp.where(
        ok_yb, _blend(ri[3], blue_o, b, ref_force, hist_force), blue_o
    )

    # orange/field from the ball candidates' center-pixel colors
    # (contrast: the just-updated blue)
    ok_of, o, f = masked_kmeans2(
        blue_new, ball_center_colors, ball_mask, orange_o, field_o
    )
    orange_new = jnp.where(
        ok_of, _blend(ri[0], orange_o, o, ref_force, hist_force), orange_o
    )
    field_new = jnp.where(
        ok_of, _blend(ri[1], field_o, f, ref_force, hist_force), field_o
    )

    # field-line color: mean disc color of candidates on the markings
    n_line = jnp.sum(at_line_mask)
    line_sum = jnp.sum(
        jnp.where(at_line_mask[:, None], blob_mean_colors, 0), axis=0
    )
    line_new = jnp.where(n_line > 2, line_sum // jnp.maximum(n_line, 1), line_o)

    return jnp.stack(
        [orange_new, field_new, yellow_new, blue_new, green_new, pink_new, line_new]
    )


# ---------------------------------------------------------------------------
# post-update recalculation + filters
# ---------------------------------------------------------------------------


def ball_color_scores_device(colors7_i, blob_colors):
    """Vectorized ball color score (host ball_color_scores,
    reference src/blobs/hypothesis.cpp:83-94)."""
    c = blob_colors.astype(jnp.float32)
    false_orange = jnp.sum((c - colors7_i[1].astype(jnp.float32)) ** 2, axis=-1)
    orange = jnp.sum((c - colors7_i[0].astype(jnp.float32)) ** 2, axis=-1)
    field_line = jnp.sum((c - colors7_i[6].astype(jnp.float32)) ** 2, axis=-1)
    bad = (false_orange <= orange) | (field_line <= orange)
    score = 1.0 - orange / jnp.maximum(false_orange, 1e-9)
    return jnp.where(bad | (false_orange == 0), 0.0, score)


def tracked_veto_device(colors7_i, c5, present, bot_id, tracked_mask):
    """Per-bot color veto for tracked constellations (host
    tracked_color_veto, reference src/blobs/hypothesis.cpp:245-270):
    veto when fewer than 2 blobs are present or any present blob sits on
    the wrong side of its expected/opposite color pair."""
    blob_amount = jnp.sum(present, axis=-1)
    pattern = jnp.asarray(PATTERNS, dtype=jnp.int32)[bot_id % 16]
    is_blue = bot_id >= 16

    yellow, blue = colors7_i[2], colors7_i[3]
    green, pink = colors7_i[4], colors7_i[5]

    exp0 = jnp.where(is_blue[:, None], blue, yellow)  # (B, 3)
    opp0 = jnp.where(is_blue[:, None], yellow, blue)
    bits = (pattern[:, None] >> jnp.arange(3, -1, -1, dtype=jnp.int32)) & 1
    exps = jnp.where(bits[..., None] == 1, green, pink)  # (B, 4, 3)
    opps = jnp.where(bits[..., None] == 1, pink, green)
    expected = jnp.concatenate([exp0[:, None], exps], axis=1)  # (B, 5, 3)
    opposite = jnp.concatenate([opp0[:, None], opps], axis=1)

    d_exp = jnp.sum((c5 - expected) ** 2, axis=-1)
    d_opp = jnp.sum((c5 - opposite) ** 2, axis=-1)
    wrong = present & (d_opp - d_exp <= 0)
    veto = (blob_amount < 2) | jnp.any(wrong, axis=-1)
    return veto & tracked_mask


def camera_edge_cut(packed_cam, ball_img, ball_pos, marks, max_bot_height, min_cam_edge_distance):
    """Camera-edge ball filter (host filter_balls, reference
    src/main.cpp:160-192): cut balls whose camera-frame border, reprojected
    to the field, comes too close while staying inside the extended field."""
    w = packed_cam[16]
    h = packed_cam[17]
    n = ball_img.shape[0]
    zeros = jnp.zeros(n, dtype=jnp.float32)
    borders = jnp.stack(
        [
            jnp.stack([zeros, ball_img[:, 1]], axis=1),
            jnp.stack([jnp.full(n, w - 1.0), ball_img[:, 1]], axis=1),
            jnp.stack([ball_img[:, 0], zeros], axis=1),
            jnp.stack([ball_img[:, 0], jnp.full(n, h - 1.0)], axis=1),
        ],
        axis=1,
    )  # (N, 4, 2)
    bpos = image2field_packed(packed_cam, borders, max_bot_height)[..., :2]
    inside = (
        (jnp.abs(bpos[..., 0]) <= marks["half_len"])
        & (jnp.abs(bpos[..., 1]) <= marks["half_wid"])
        & jnp.all(jnp.isfinite(bpos), axis=-1)
    )
    d2 = jnp.sum((bpos - ball_pos[:, None, :]) ** 2, axis=-1)
    return jnp.any(inside & (d2 < min_cam_edge_distance**2), axis=1)


# ---------------------------------------------------------------------------
# the fused finisher
# ---------------------------------------------------------------------------


def finish_on_device(blobs, det, colors7, colors7_ref, packed_cam, marks, params):
    """Device-side frame finishing in the host path's exact order
    (Processor.finish_frame; reference src/main.cpp:320-371):

    1. assemble bots (tracked keep ids; fresh use the in-graph pre-update
       estimate) and ball candidates (valid, not bot-clipped)
    2. adaptive color update incl. field-line color from on-marking balls
    3. recalculate ids / tracked vetoes / ball scores with the new colors
    4. ball confidence / blob-score / camera-edge filters
    5. emission projections (pixel position at max bot height; world
       position re-projected at the object's own height)

    Returns the ``fin`` dict the host turns directly into an
    SSL_DetectionFrame, plus the updated color table.
    """
    max_bot_height = params["max_bot_height"]
    ball_radius = params["ball_radius"]

    blob_color = blobs["color"].astype(jnp.int32)  # disc mean dRGB
    blob_center = blobs["center"].astype(jnp.int32)  # center pixel dRGB

    bot_valid = det["bot_valid"]
    idx = det["bot_blob_idx"]
    present = idx >= 0
    safe = jnp.maximum(idx, 0)
    c5 = blob_color[safe]  # (B, 5, 3)
    bot_id = det["bot_id_est"].astype(jnp.int32)
    tracked_mask = det["bot_tracked_id"] >= 0

    ball_mask = blobs["valid"] & ~det["ball_clipped"]  # (N,)

    # ball projections at max bot height -> image; reprojected to the
    # ball's ground height (shared by the field-line test, the edge
    # filter, and emission — one projection pass for all three)
    ball_pos = blobs["field_pos"].astype(jnp.float32)
    pos3 = jnp.concatenate(
        [ball_pos, jnp.full((ball_pos.shape[0], 1), max_bot_height)], axis=-1
    )
    ball_img = field2image_packed(packed_cam, pos3)
    ball_world = image2field_packed(packed_cam, ball_img, ball_radius)
    ground = jnp.nan_to_num(ball_world[..., :2], nan=1e9)
    at_line = balls_at_lines_device(marks, ground) & ball_mask

    colors_new = update_colors_device(
        colors7,
        colors7_ref,
        bot_valid,
        bot_id,
        c5,
        present,
        blob_center,
        ball_mask,
        at_line,
        blob_color,
        params["reference_force"],
        params["history_force"],
    )
    colors_new_f = colors_new.astype(jnp.float32)

    # post-color-update recalculation
    bot_id_new = estimate_bot_ids(det, blobs["color"], colors_new_f).astype(jnp.int32)
    veto = tracked_veto_device(colors_new, c5, present, bot_id, tracked_mask)
    bot_score = jnp.where(veto, 0.0, det["bot_score"])
    ball_scores = ball_color_scores_device(colors_new, blob_color)

    # ball filters
    keep = (
        ball_mask
        & (ball_scores > params["min_confidence"])
        & (blobs["score"] > params["min_score"])
    )
    cut = camera_edge_cut(
        packed_cam, ball_img, ball_pos, marks, max_bot_height,
        params["min_cam_edge_distance"],
    )
    keep = keep & ~cut

    # bot emission projections: pixel at max bot height, world at the
    # team's GC height
    bpos3 = jnp.concatenate(
        [
            det["bot_pos"].astype(jnp.float32),
            jnp.full((bot_id.shape[0], 1), max_bot_height),
        ],
        axis=-1,
    )
    bot_img = field2image_packed(packed_cam, bpos3)
    heights = jnp.where(
        bot_id_new >= 16, params["bot_heights_yb"][1], params["bot_heights_yb"][0]
    )
    bot_world = image2field_packed(packed_cam, bot_img, heights)

    return {
        "colors7": colors_new_f,
        "bot_valid": bot_valid,
        "bot_id": bot_id_new,
        "bot_score": bot_score,
        "bot_orientation": det["bot_orientation"],
        "bot_world": bot_world,
        "bot_pixel": bot_img,
        "ball_valid": keep,
        "ball_score": ball_scores,
        "ball_world": ball_world,
        "ball_pixel": ball_img,
    }


# ---------------------------------------------------------------------------
# camera-batched finisher
# ---------------------------------------------------------------------------

_FIN_PARAM_KEYS = (
    "max_bot_height",
    "ball_radius",
    "reference_force",
    "history_force",
    "min_confidence",
    "min_score",
    "min_cam_edge_distance",
    "bot_heights_yb",
)


def stack_finish_params(params: dict, n_cams: int) -> dict:
    """Broadcast the finisher's params to a leading camera axis: shared
    scalars replicate; per-camera (N,) tunables pass through."""
    out = {}
    for k in _FIN_PARAM_KEYS:
        v = jnp.asarray(params[k])
        if k == "bot_heights_yb":
            out[k] = jnp.broadcast_to(v, (n_cams, 2))
        elif v.ndim == 0:
            out[k] = jnp.broadcast_to(v, (n_cams,))
        else:
            out[k] = v
    return out


def finish_on_device_batched(
    blobs, det, colors7, colors7_refs, packed_cams, marks, params
):
    """``finish_on_device`` vmapped over the camera axis.

    The finisher is small-tensor math (no image-scale gathers), so unlike
    the blob machine, whose camera loop is unrolled, batching it gives one
    op per stage instead of one per camera, which matters because the
    finisher's device cost is op-dispatch-bound (24 unrolled k-means
    iterations of tiny ops), not FLOP-bound.

    All array inputs carry a leading camera axis; ``params`` must come
    from ``stack_finish_params``.
    """
    return jax.vmap(finish_on_device)(
        blobs, det, colors7, colors7_refs, packed_cams, marks, params
    )
