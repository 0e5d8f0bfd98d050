"""Vectorized robot/ball hypothesis search — the device half of detection.

The reference enumerates candidate robots on the CPU with pointer-chasing
loops: per-anchor 4-subsets of angle-sorted neighbours
(reference src/main.cpp:43-79) and per-tracked-bot 5-way radius-search cross
products (reference src/main.cpp:81-141), scored by BotHypothesis
(reference src/blobs/hypothesis.cpp:97-271). Here the same search is a fixed
tensor program: static combo tables enumerated with masking, scored in
parallel on the VPU, reduced with argmax, and filtered with an in-graph
greedy clipping NMS. Blob count, ring size, combo counts are static; real
blob counts are handled by validity masks.

Everything in this module is jit-compatible; the host half
(host_detect.py) consumes the small result tensors.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from itertools import combinations

import jax
import jax.numpy as jnp
import numpy as np

from .camera import field2image_packed, image2field_packed
from .pattern import (
    MIN_ROBOT_FRONT_DISTANCE,
    MIN_ROBOT_OPENING_ANGLE,
    MIN_ROBOT_RADIUS,
    PATTERNS,
    PATTERN_ANGLES_B2B,
    PATTERN_LUT,
    PATTERN_POS,
)

TWO_PI = 2.0 * math.pi


@dataclass(frozen=True)
class DetectorConfig:
    """Static shape configuration of the hypothesis search."""

    max_blobs: int  # k blob slots from the blob machine
    max_anchors: int = 512  # anchors tested for detection hypotheses
    # occupancy-adaptive small anchor window (0 disables): when every
    # valid blob fits in the first `anchor_tier` slots, the hypothesis
    # search runs on that window only — exactly equivalent (valid slots
    # are a score-ordered prefix and hypotheses are per-anchor
    # independent) at ~1/5 the combo-scoring cost of the full window;
    # dense scenes where the window binds take the full ranked path
    max_anchors_tier: int = 128
    ring_size: int = 8  # neighbour ring per anchor (K)
    # SSL allows at most 11 robots per team on the field (22 total); 32
    # slots cover any legal scene with margin at half the search cost of 64
    max_tracked: int = 32  # tracked-object slots (T)
    # occupancy-adaptive tracked window (0 disables): when every tracked
    # ROBOT (valid, id >= 0) sits in the first `max_tracked_tier` slots,
    # the per-slot cross-product search runs on that window only — exactly
    # equivalent (per-slot searches are independent; excluded slots output
    # the same inert zeros either way) at half the slots. The condition is
    # EXACT (no qualifying slot beyond the window), not a prefix
    # assumption, so host-built tracked arrays with ball entries (-1)
    # interleaved stay correct.
    max_tracked_tier: int = 16
    tracked_candidates: int = 3  # blob candidates per pattern slot (M)
    max_bots: int = 64  # bot output slots (B)


# ---------------------------------------------------------------------------
# static combo tables
# ---------------------------------------------------------------------------


def detection_combo_table(ring_size: int) -> np.ndarray:
    """All 4-subsets of the ring in cyclic order, each in its 4 rotations.

    The reference's nested loops enumerate every 4-subset of the angle-sorted
    neighbour ring once per cyclic rotation (reference src/main.cpp:63-75) —
    the rotation decides which physical blob lands on which pattern slot.
    Returns (n_combos, 4) indices into the sorted ring.
    """
    rows = []
    for subset in combinations(range(ring_size), 4):
        for r in range(4):
            rows.append([subset[(j + r) % 4] for j in range(4)])
    return np.array(rows, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _detection_onehot_tables(ring_size: int):
    """Static one-hot matrices turning ring-level quantities into per-combo
    sums as matmuls (see detection_hypotheses). Per combo and slot pair,
    the orientation contribution cos/sin(angle(diff) - pattern_angle) is a
    fixed linear combination of the ordered ring-pair unit vectors, so the
    per-combo accumulation is a (A, 162) @ (162, C) matmul instead of
    (A, C, 4[, 2]) static-table gathers + a per-pair elementwise chain."""
    combos = detection_combo_table(ring_size)
    c = combos.shape[0]
    n9 = ring_size + 1  # ring slots + the anchor at index 0
    npair = n9 * n9

    w_cos = np.zeros((c, 2 * npair), dtype=np.float32)
    w_sin = np.zeros((c, 2 * npair), dtype=np.float32)
    count9 = np.zeros((c, n9), dtype=np.float32)
    onehot_slot = np.zeros((4, c, n9), dtype=np.float32)
    for ci in range(c):
        ring_of_slot = [0] + [int(combos[ci, s]) + 1 for s in range(4)]
        for p, (a, b) in enumerate(_PAIRS):
            i, j = ring_of_slot[a], ring_of_slot[b]
            k = i * n9 + j
            ca, sa = float(_PAIR_COS[p]), float(_PAIR_SIN[p])
            # cos(theta - lam) = ux*ca + uy*sa; sin = uy*ca - ux*sa
            w_cos[ci, k] += ca
            w_cos[ci, npair + k] += sa
            w_sin[ci, k] += -sa
            w_sin[ci, npair + k] += ca
        count9[ci, 0] += 1.0
        for s in range(4):
            j = int(combos[ci, s]) + 1
            count9[ci, j] += 1.0
            onehot_slot[s, ci, j] = 1.0
    combo_max = combos.max(axis=-1).astype(np.int32)
    return combos, w_cos.T, w_sin.T, count9.T, onehot_slot, combo_max


def tracked_combo_table(m_plus_null: int) -> np.ndarray:
    """Cartesian product of per-slot candidate choices, (n, 5) option indices.

    Option m_plus_null-1 denotes "no blob on this slot" (the reference pushes
    a nullptr candidate, reference src/main.cpp:104).
    """
    grids = np.meshgrid(*[np.arange(m_plus_null)] * 5, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1).astype(np.int32)


_PAIRS = [(a, b) for a in range(5) for b in range(a + 1, 5)]
_PAIR_A = np.array([p[0] for p in _PAIRS], dtype=np.int32)
_PAIR_B = np.array([p[1] for p in _PAIRS], dtype=np.int32)
# expected angle for each ordered pair (a -> b): PATTERN_ANGLES_B2B[b*5 + a]
_PAIR_ANGLE = PATTERN_ANGLES_B2B.reshape(5, 5)[_PAIR_B, _PAIR_A]


def _remainder_2pi(x):
    """IEEE remainder(x, 2*pi): result in [-pi, pi]."""
    return x - TWO_PI * jnp.round(x / TWO_PI)


def iter_top_k(scores, k: int):
    """Exact top-k on the last axis via k argmax passes.

    For the detector's tiny k (ring=8, candidates=3) this lowers to k cheap
    reductions instead of lax.top_k's per-row sort over the full 2000-blob
    axis. Ties pick the
    lower index, matching lax.top_k's stable order.

    CAUTION: once a row is exhausted (all remaining -inf), argmax repeats
    index 0, so — unlike lax.top_k — returned indices are NOT distinct on
    padding slots. Callers must derive slot validity from the returned
    VALUES (> -inf), never by re-gathering a mask at the indices.
    """
    vals, idxs = [], []
    cur = scores
    iota = jnp.arange(scores.shape[-1])
    for _ in range(k):
        i = jnp.argmax(cur, axis=-1)
        v = jnp.take_along_axis(cur, i[..., None], axis=-1)[..., 0]
        vals.append(v)
        idxs.append(i.astype(jnp.int32))
        cur = jnp.where(iota == i[..., None], -jnp.inf, cur)
    return jnp.stack(vals, axis=-1), jnp.stack(idxs, axis=-1)


def _rot2(angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return c, s


def _rotate(c, s, v):
    """Rotate vectors v (..., 2) by the angle whose cos/sin are c, s (...)."""
    x = c * v[..., 0] - s * v[..., 1]
    y = s * v[..., 0] + c * v[..., 1]
    return jnp.stack([x, y], axis=-1)


_PAIR_COS = np.cos(_PAIR_ANGLE).astype(np.float32)
_PAIR_SIN = np.sin(_PAIR_ANGLE).astype(np.float32)


def score_hypotheses(pos5, valid5):
    """Score a batch of 5-blob constellations.

    pos5: (..., 5, 2) blob field positions (slot 0 = center blob),
    valid5: (..., 5) slot occupancy.
    Returns (c, s, pos, offset_score, blob_amount) with reference semantics
    (reference src/blobs/hypothesis.cpp:156-205): (c, s) is the unit
    orientation vector (cos, sin) accumulated from pairwise angle deltas vs
    the pattern table, position the mean of back-rotated blob offsets,
    offset score min over slots of 1 / (1 + |offset/10mm|^2).

    The angle itself (atan2) is never formed here: per pair,
    cos/sin(atan2(dy,dx) - pair_angle) == (dx*ca + dy*sa, dy*ca - dx*sa)/r
    with static (ca, sa) per pair — pure mul/add + rsqrt on the VPU instead
    of three transcendentals per combo pair (the dominant detector cost at
    ~2M pairs per frame-set). Callers recover the angle with one atan2 on
    the selected winner only.
    """
    pa = pos5[..., _PAIR_A, :]
    pb = pos5[..., _PAIR_B, :]
    pair_valid = valid5[..., _PAIR_A] & valid5[..., _PAIR_B]
    diff = pb - pa
    r2 = jnp.sum(diff * diff, axis=-1)
    # coincident blobs (r2 == 0) contribute nothing; such pairs are either
    # masked (tracked distinctness) or belong to degenerate combos that
    # cannot win on offset score
    inv_r = jnp.where(pair_valid & (r2 > 0.0), jax.lax.rsqrt(r2), 0.0)
    dx = diff[..., 0] * inv_r
    dy = diff[..., 1] * inv_r
    o_cos = jnp.sum(dx * _PAIR_COS + dy * _PAIR_SIN, axis=-1)
    o_sin = jnp.sum(dy * _PAIR_COS - dx * _PAIR_SIN, axis=-1)

    blob_amount = jnp.sum(valid5, axis=-1)
    norm2 = o_cos * o_cos + o_sin * o_sin
    ok = (blob_amount > 1) & (norm2 > 0.0)
    inv_n = jnp.where(ok, jax.lax.rsqrt(jnp.maximum(norm2, 1e-30)), 0.0)
    c = jnp.where(ok, o_cos * inv_n, 1.0)
    s = o_sin * inv_n

    pattern = jnp.asarray(PATTERN_POS)  # (5, 2)
    rotated = _rotate(c[..., None], s[..., None], pattern)  # (..., 5, 2)
    offsets = pos5 - rotated
    pos = jnp.sum(
        jnp.where(valid5[..., None], offsets, 0.0), axis=-2
    ) / jnp.maximum(blob_amount, 1)[..., None]

    slot_off = (pos5 - (pos[..., None, :] + rotated)) / 10.0
    slot_score = 1.0 / (1.0 + jnp.sum(slot_off * slot_off, axis=-1))
    offset_score = jnp.min(
        jnp.where(valid5, slot_score, jnp.inf), axis=-1
    )
    offset_score = jnp.where(jnp.isfinite(offset_score), offset_score, 1.0)
    return c, s, pos, offset_score, blob_amount


# ---------------------------------------------------------------------------
# detection hypotheses (untracked anchors)
# ---------------------------------------------------------------------------


def detection_hypotheses(cfg: DetectorConfig, blob_pos, blob_valid, max_robot_radius,
                         blob_color=None, colors=None):
    """Best 5-blob constellation per anchor blob.

    Returns dict with per-anchor (A,) score/orientation, (A, 2) pos and
    (A, 5) global blob indices (slot 0 = the anchor itself).
    """
    # coerce to device arrays: the tier cond below traces the window
    # bodies, where numpy operands cannot be indexed by traced selections
    blob_pos = jnp.asarray(blob_pos)
    blob_valid = jnp.asarray(blob_valid)
    if blob_color is not None:
        blob_color = jnp.asarray(blob_color)
    if colors is not None:
        colors = jnp.asarray(colors)

    k_all = blob_pos.shape[0]
    a = min(cfg.max_anchors, k_all)

    # Ring-member ranking (anchor-independent): side-color plausibility —
    # distance to the nearer of the green/pink pattern colors — so
    # spurious off-color local maxima (noise, field texture, lines)
    # cannot crowd the true pattern blobs out of the ring in dense
    # scenes; ties fall back to extraction score order (blob slots
    # arrive score-sorted).
    blob_rank = jnp.arange(k_all, dtype=jnp.float32)
    if blob_color is not None and colors is not None:
        green, pink = colors[4], colors[5]
        d_side = jnp.minimum(
            jnp.sum((blob_color - green) ** 2, axis=-1),
            jnp.sum((blob_color - pink) ** 2, axis=-1),
        )  # (k_all,)
        rank = d_side + blob_rank * 1e-6
    else:
        rank = blob_rank

    n_valid = jnp.sum(blob_valid, dtype=jnp.int32)

    def full_window():
        # Anchor selection. The reference anchors EVERY blob (reference
        # src/main.cpp:63-75); max_anchors bounds the tensor shape. When
        # the cap binds, anchors are ranked by center-color plausibility
        # with extraction-score order as the tie-break. The ranking key
        # is the CLASSIFICATION MARGIN — distance to the nearer team
        # color minus distance to the nearest non-team table color
        # (orange/field/green/pink/line, the same nearest-class rule the
        # host classifier uses) — not the raw team-color distance: disc
        # means are diluted toward the carpet, which inflates a true
        # center's absolute distance while a dense field of orange balls
        # sits numerically closer to yellow than diluted yellow does.
        # The margin cancels the dilution (both terms shift together),
        # so team-colored blobs rank negative and everything else
        # positive. Plain score-order anchoring is adversarially
        # unsound: a dense scene can pack >max_anchors spurious
        # high-score blobs into the leading slots and starve every true
        # robot center out of the anchor window.
        if a < k_all and blob_color is not None and colors is not None:
            def ranked_anchors():
                yellow, blue = colors[2], colors[3]
                d_team = jnp.minimum(
                    jnp.sum((blob_color - yellow) ** 2, axis=-1),
                    jnp.sum((blob_color - blue) ** 2, axis=-1),
                )
                other_idx = [
                    i for i in range(colors.shape[0]) if i not in (2, 3)
                ]
                d_other = jnp.min(
                    jnp.stack([
                        jnp.sum((blob_color - colors[i]) ** 2, axis=-1)
                        for i in other_idx
                    ]),
                    axis=0,
                )
                a_rank = jnp.where(blob_valid, d_team - d_other, jnp.inf)
                # stable argsort: equal distances keep extraction-score
                # order
                return jnp.argsort(a_rank)[:a].astype(jnp.int32)

            # When the cap does NOT bind (valid blobs fit the anchor
            # window), the first `a` slots already contain every valid
            # blob (valid slots are a prefix), and hypotheses are
            # per-anchor independent — so the identity window is exactly
            # equivalent and the 2000-row ranking argsort only runs on
            # dense scenes where the cap bites.
            anchor_idx = jax.lax.cond(
                n_valid <= a,
                lambda: jnp.arange(a, dtype=jnp.int32),
                ranked_anchors,
            )
            anchor_pos = blob_pos[anchor_idx]
            anchor_valid = blob_valid[anchor_idx]
        else:
            anchor_idx = jnp.arange(a, dtype=jnp.int32)
            anchor_pos = blob_pos[:a]
            anchor_valid = blob_valid[:a]
        return _window_hypotheses(
            cfg, blob_pos, blob_valid, max_robot_radius, rank,
            anchor_idx, anchor_pos, anchor_valid,
        )

    # Occupancy-adaptive tier: when every valid blob fits the first
    # `max_anchors_tier` slots the identity window over that tier is
    # exactly equivalent to the full window (same prefix argument as the
    # ranked-anchors skip above — the extra full-window anchors would
    # all be invalid), at a quarter of the combo-scoring work (A=128 vs
    # 512) on sparse scenes; dense scenes take the full ranked path
    # unchanged.
    tier = cfg.max_anchors_tier
    if not (0 < tier < a):
        return full_window()

    def small_window():
        out = _window_hypotheses(
            cfg, blob_pos, blob_valid, max_robot_radius, rank,
            jnp.arange(tier, dtype=jnp.int32),
            blob_pos[:tier], blob_valid[:tier],
        )
        pad = a - tier
        return {
            "score": jnp.pad(out["score"], (0, pad)),
            "orientation": jnp.pad(out["orientation"], (0, pad)),
            "pos": jnp.pad(out["pos"], ((0, pad), (0, 0))),
            "blob_idx": jnp.pad(out["blob_idx"], ((0, pad), (0, 0))),
            "valid": jnp.pad(out["valid"], (0, pad)),
        }

    return jax.lax.cond(n_valid <= tier, small_window, full_window)


def _window_hypotheses(cfg, blob_pos, blob_valid, max_robot_radius, rank,
                       anchor_idx, anchor_pos, anchor_valid):
    """Hypothesis search over one anchor window (see detection_hypotheses).

    Highest-quality K in radius (the reference uses all in-radius
    neighbours, reference src/main.cpp:63-75; K bounds the tensor shape).
    The anchor itself is a candidate, mirroring rangeSearch returning the
    query blob. The radius test + rank top-K runs fused in a Pallas
    kernel on the GPU (ops/topk.py query_select_topk) so the (A, k_all)
    score map never materializes; the XLA form reproduces the masked
    iter_top_k exactly.
    """
    a = anchor_idx.shape[0]
    k = cfg.ring_size
    from ..ops.topk import query_select_topk

    sel_val, sel_idx = query_select_topk(
        anchor_pos,
        jnp.broadcast_to(max_robot_radius * max_robot_radius, (a,)),
        blob_pos,
        jnp.where(blob_valid, rank, jnp.inf),
        m=k,
        by_rank=True,
    )  # (A, K)
    # validity from the selected VALUES: exhausted slots repeat index 0
    # (iter_top_k semantics), so re-gathering the radius mask would
    # falsely validate padding whenever blob 0 is in range (inflating
    # ring_count past the reference's >=4-blob anchor gate). Invalid
    # anchors select real blobs here (the old code masked whole rows);
    # masking sel_valid keeps every downstream consumer identical.
    sel_valid = (sel_val > -jnp.inf) & anchor_valid[:, None]

    sel_diff = blob_pos[sel_idx] - anchor_pos[:, None, :]  # (A, K, 2)
    angle = jnp.arctan2(sel_diff[..., 1], sel_diff[..., 0])
    order = jnp.argsort(jnp.where(sel_valid, angle, jnp.inf), axis=-1)
    ring_idx = jnp.take_along_axis(sel_idx, order, axis=1)
    ring_valid = jnp.take_along_axis(sel_valid, order, axis=1)
    ring_count = jnp.sum(ring_valid, axis=-1)  # (A,)

    combos_np, w_cos, w_sin, count9, onehot_slot, combo_max = (
        _detection_onehot_tables(k)
    )
    combo_ok = jnp.asarray(combo_max)[None, :] < ring_count[:, None]  # (A, C)
    # reference: anchors need >= 4 in-radius blobs (incl. self)
    combo_ok &= (ring_count[:, None] >= 4) & anchor_valid[:, None]

    # gather each anchor's ring positions once (A*K indices); everything
    # per-combo is then one-hot contractions against the static combo
    # tables — no (A, C, ...) gathers. Scores match the pairwise form
    # within fp reassociation (~1e-5), so only exact score TIES between
    # combos (near-symmetric degenerate rings) can pick a different
    # rotation of the same constellation
    ring_pos = blob_pos[ring_idx]  # (A, K, 2)
    ring9 = jnp.concatenate([anchor_pos[:, None, :], ring_pos], axis=1)
    n9 = k + 1

    # ordered ring-pair unit vectors (A, n9*n9); coincident pairs -> 0
    d9 = ring9[:, None, :, :] - ring9[:, :, None, :]
    r2 = jnp.sum(d9 * d9, axis=-1)
    inv = jnp.where(r2 > 0.0, jax.lax.rsqrt(r2), 0.0)
    u2 = jnp.concatenate(
        [(d9[..., 0] * inv).reshape(a, n9 * n9),
         (d9[..., 1] * inv).reshape(a, n9 * n9)],
        axis=-1,
    )  # (A, 2*n9*n9)

    hi = jax.lax.Precision.HIGHEST
    pat = np.asarray(PATTERN_POS, dtype=np.float32)
    pbar = pat.sum(axis=0)

    dot = lambda x, w: jax.lax.dot_general(
        x, jnp.asarray(w), (((1,), (0,)), ((), ())), precision=hi
    )
    o_cos = dot(u2, w_cos)  # (A, C)
    o_sin = dot(u2, w_sin)
    norm2 = o_cos * o_cos + o_sin * o_sin
    ok_n = norm2 > 0.0
    inv_n = jnp.where(
        ok_n, jax.lax.rsqrt(jnp.maximum(norm2, 1e-30)), 0.0)
    cc = jnp.where(ok_n, o_cos * inv_n, 1.0)
    ss = o_sin * inv_n

    # position = mean over slots of (blob - rotated pattern)
    sum_x = dot(ring9[..., 0], count9)
    sum_y = dot(ring9[..., 1], count9)
    pos_x = (sum_x - (cc * pbar[0] - ss * pbar[1])) / 5.0
    pos_y = (sum_y - (ss * pbar[0] + cc * pbar[1])) / 5.0

    # min slot score (all 5 slots occupied on the detection path)
    offset_score = None
    for s5 in range(5):
        if s5 == 0:
            p5x = anchor_pos[:, 0:1]
            p5y = anchor_pos[:, 1:2]
        else:
            p5x = dot(ring9[..., 0], onehot_slot[s5 - 1].T)
            p5y = dot(ring9[..., 1], onehot_slot[s5 - 1].T)
        dx = (p5x - (pos_x + (cc * pat[s5, 0] - ss * pat[s5, 1]))) / 10.0
        dy = (p5y - (pos_y + (ss * pat[s5, 0] + cc * pat[s5, 1]))) / 10.0
        sc = 1.0 / (1.0 + dx * dx + dy * dy)
        offset_score = sc if offset_score is None else jnp.minimum(
            offset_score, sc
        )

    score = jnp.where(combo_ok, offset_score, 0.0)

    best = jnp.argmax(score, axis=-1)  # (A,)
    take = lambda arr: jnp.take_along_axis(
        arr, best[:, None], axis=1)[:, 0]
    best_score = take(score)
    # one atan2 per anchor, on the winning combo only
    best_orient = jnp.arctan2(take(ss), take(cc))
    best_pos = jnp.stack([take(pos_x), take(pos_y)], axis=-1)
    # winner side blobs: static combo lookup, then the winner's ring slots
    best_combo = jnp.asarray(combos_np)[best]  # (A, 4) ring slot indices
    best_sides = jnp.take_along_axis(ring_idx, best_combo, axis=1)

    blob_idx5 = jnp.concatenate(
        [anchor_idx[:, None], best_sides.astype(jnp.int32)], axis=-1
    )
    return {
        "score": best_score,
        "orientation": best_orient,
        "pos": best_pos,
        "blob_idx": blob_idx5,
        "valid": best_score > 0.0,
    }


# ---------------------------------------------------------------------------
# tracked hypotheses
# ---------------------------------------------------------------------------


def tracked_hypotheses(
    cfg: DetectorConfig,
    blob_pos,
    blob_color,
    blob_valid,
    tracked,  # dict of (T,) arrays: id, x, y, z, w, vx, vy, vw, time_delta, valid
    colors,  # (6, 3): orange, field, yellow, blue, green, pink (dRGB)
    packed_cam,
    max_bot_height,
    min_tracking_radius,
    max_bot_acceleration,
):
    """Best constellation per tracked object using small per-slot searches.

    Mirrors generateRadiusSearchTrackedBotHypotheses + TrackedBotHypothesis
    (reference src/main.cpp:81-141, src/blobs/hypothesis.cpp:230-271):
    reproject the tracked position into this camera, extrapolate by velocity,
    search blobs around each expected pattern-slot position, try every
    candidate assignment (including missing slots), score with the tracked
    offset/rotation penalty and blob-count factor, veto on contradicting
    pattern colors.

    Occupancy-adaptive window (``cfg.max_tracked_tier``): when no tracked
    ROBOT occupies a slot beyond the tier, the search runs on the tier
    window only — exactly equivalent, since per-slot searches are
    independent and a non-qualifying slot's outputs are the same inert
    values (score 0, blob_idx -1) the full window produces for it.
    """
    t = cfg.max_tracked
    tier = cfg.max_tracked_tier
    args = (blob_pos, blob_color, blob_valid, colors, packed_cam,
            max_bot_height, min_tracking_radius, max_bot_acceleration)
    if not (0 < tier < t):
        return _tracked_window(cfg, tracked, *args)

    tid_full = jnp.asarray(tracked["id"])
    qual = jnp.asarray(tracked["valid"]) & (tid_full >= 0)

    def small_window():
        sub = {k: jnp.asarray(v)[:tier] for k, v in tracked.items()}
        out = _tracked_window(cfg, sub, *args)
        pad = t - tier
        return {
            "score": jnp.pad(out["score"], (0, pad)),
            "orientation": jnp.pad(out["orientation"], (0, pad)),
            "pos": jnp.pad(out["pos"], ((0, pad), (0, 0))),
            "blob_idx": jnp.pad(out["blob_idx"], ((0, pad), (0, 0)),
                                constant_values=-1),
            "tracked_id": tid_full,
            "valid": jnp.pad(out["valid"], (0, pad)),
        }

    def full_window():
        return _tracked_window(cfg, tracked, *args)

    return jax.lax.cond(jnp.any(qual[tier:]), full_window, small_window)


def _tracked_window(
    cfg: DetectorConfig,
    tracked,
    blob_pos,
    blob_color,
    blob_valid,
    colors,
    packed_cam,
    max_bot_height,
    min_tracking_radius,
    max_bot_acceleration,
):
    """The tracked search over whatever slot count ``tracked`` carries
    (see tracked_hypotheses)."""
    t = jnp.asarray(tracked["id"]).shape[0]
    m = cfg.tracked_candidates

    tid = tracked["id"]
    tvalid = tracked["valid"]
    dt_raw = tracked["time_delta"]
    # clamp only the search radius growth (reference src/main.cpp:93-95)
    dt = jnp.clip(dt_raw, 0.0, 0.05)

    world = jnp.stack([tracked["x"], tracked["y"], tracked["z"]], axis=-1)
    img = field2image_packed(packed_cam, world)
    reproj = image2field_packed(packed_cam, img, max_bot_height)[..., :2]
    reproj = jnp.where(jnp.isfinite(reproj), reproj, 0.0)

    pred_xy = reproj + jnp.stack(
        [tracked["vx"], tracked["vy"]], axis=-1
    ) * dt_raw[..., None]
    pred_w = tracked["w"]

    search_radius = max_bot_acceleration * dt * dt + min_tracking_radius

    c, s = _rot2(pred_w)
    slot_pos = pred_xy[:, None, :] + _rotate(
        c[:, None], s[:, None], jnp.asarray(PATTERN_POS)[None]
    )  # (T, 5, 2)

    # nearest-M blobs per pattern slot; the (T*5, k) distance map fuses
    # into the Pallas select on the GPU (ops/topk.py), iter_top_k on CPU
    from ..ops.topk import query_select_topk

    cand_val, cand_idx = query_select_topk(
        slot_pos.reshape(t * 5, 2),
        jnp.repeat(search_radius * search_radius, 5),
        blob_pos,
        jnp.where(blob_valid, 0.0, jnp.inf),
        m=m,
        by_rank=False,
    )
    cand_val = cand_val.reshape(t, 5, m)  # (T, 5, M)
    cand_idx = cand_idx.reshape(t, 5, m)
    # value-derived validity (see iter_top_k: padding indices repeat 0)
    cand_valid = cand_val > -jnp.inf

    combos_np = tracked_combo_table(m + 1)  # (Ct, 5), m == null
    n_combo = combos_np.shape[0]

    # Expand per-slot candidate tables to all combos with static
    # (m+1)-way selects: the combo table is a compile-time constant, so
    # each slot's choice is a chain of m `where`s over tiny (T, 5, ...)
    # candidate tables — elementwise selects instead of the (T, Ct, 5, M)
    # broadcast gathers + (T*Ct*5)-index blob gathers.
    slot_range = jnp.arange(5)
    cand_pos = blob_pos[cand_idx]  # (T, 5, M, 2) — 5*M*T indices only
    pick = [
        jnp.asarray(combos_np == mi)[None, :, :] for mi in range(m)
    ]  # m x (1, Ct, 5)

    def expand(tab, null_val):
        """tab (T, 5, M[, D]) -> (T, Ct, 5[, D]): tab[..., chose], with the
        null choice (chose == m) mapped to null_val."""
        trailing = tab.ndim == 4
        out = jnp.full(
            (t, n_combo, 5) + tab.shape[3:], null_val, tab.dtype
        )
        for mi in range(m):
            p = pick[mi][..., None] if trailing else pick[mi]
            out = jnp.where(p, tab[:, None, :, mi], out)
        return out

    gidx = expand(cand_idx, -1)  # (T, Ct, 5); -1 on null slots
    gvalid = expand(cand_valid, False)

    # distinctness: no blob used twice (reference skips those combos)
    eq = (gidx[..., :, None] == gidx[..., None, :]) & (
        gvalid[..., :, None] & gvalid[..., None, :]
    )
    eq = eq & ~jnp.eye(5, dtype=bool)
    distinct = ~jnp.any(eq, axis=(-2, -1))

    pos5 = expand(cand_pos, 0.0)  # (T, Ct, 5, 2); masked by gvalid below
    oc, os_, pos, offset_score, blob_amount = score_hypotheses(pos5, gvalid)

    # remainder_2pi(orientation - pred_w) == atan2 of the relative rotation
    # (c, s) x (cw, sw); exact up to the +/-pi boundary, where rot_off is
    # squared anyway
    cw, sw = _rot2(pred_w[:, None])
    rot_off = jnp.arctan2(os_ * cw - oc * sw, oc * cw + os_ * sw) / math.pi
    delta = (pos - pred_xy[:, None, :]) / 10.0
    offset_score = offset_score / (
        1.0 + jnp.sum(delta * delta, axis=-1) + rot_off * rot_off
    )
    offset_score = offset_score * blob_amount / 5.0

    # color veto (reference src/blobs/hypothesis.cpp:245-270)
    yellow, blue, green, pink = colors[2], colors[3], colors[4], colors[5]
    pat = jnp.asarray(PATTERNS)[tid % 16]  # (T,)
    is_green = ((pat[:, None] >> (4 - slot_range[None, :])) & 1).astype(bool)
    is_blue_team = (tid >= 16)[:, None]
    exp_side = jnp.where(is_green[..., None], green, pink)  # (T, 5, 3)
    opp_side = jnp.where(is_green[..., None], pink, green)
    exp_center = jnp.where(is_blue_team[..., None], blue, yellow)  # (T, 1, 3)
    opp_center = jnp.where(is_blue_team[..., None], yellow, blue)
    center_slot = (slot_range == 0)[None, :, None]  # (1, 5, 1)
    expected = jnp.where(center_slot, exp_center, exp_side)  # (T, 5, 3)
    opposite = jnp.where(center_slot, opp_center, opp_side)

    # veto bit per (tracked, slot, candidate) — tiny — then combo-expanded
    cand_col = blob_color[cand_idx]  # (T, 5, M, 3)
    d_exp = jnp.sum((cand_col - expected[:, :, None]) ** 2, axis=-1)
    d_opp = jnp.sum((cand_col - opposite[:, :, None]) ** 2, axis=-1)
    veto_bit = cand_valid & (d_opp - d_exp <= 0.0)  # (T, 5, M)
    veto = jnp.any(expand(veto_bit, False), axis=-1)  # (T, Ct)

    score = jnp.where(
        distinct
        & ~veto
        & (blob_amount >= 2)
        & tvalid[:, None]
        & (tid[:, None] >= 0),
        offset_score,
        0.0,
    )

    best = jnp.argmax(score, axis=-1)
    take = lambda arr: jnp.take_along_axis(
        arr, best.reshape(-1, *([1] * (arr.ndim - 1))), axis=1
    ).squeeze(1)
    blob_idx = jnp.where(take(gvalid), take(gidx), -1).astype(jnp.int32)
    return {
        "score": take(score),
        "orientation": jnp.arctan2(take(os_), take(oc)),
        "pos": take(pos),
        "blob_idx": blob_idx,
        "tracked_id": tid,
        "valid": take(score) > 0.0,
    }


# ---------------------------------------------------------------------------
# clipping geometry + NMS + ball clip mask
# ---------------------------------------------------------------------------


def _front_distance(angle_to_other, fallback_radius):
    """Distance from the robot center to its hull towards angle_to_other
    (flat front within the opening angle, circle otherwise)."""
    front = jnp.abs(angle_to_other) < MIN_ROBOT_OPENING_ANGLE
    return jnp.where(
        front, MIN_ROBOT_FRONT_DISTANCE / jnp.cos(angle_to_other), fallback_radius
    )


def bot_bot_clipping(pos, orient, clipping_tolerance):
    """Pairwise clipping matrix (B, B) for bot hulls
    (reference src/blobs/hypothesis.cpp:106-124)."""
    diff = pos[None, :, :] - pos[:, None, :]  # diff[i, j] = pos_j - pos_i
    sqd = jnp.sum(diff * diff, axis=-1)
    diff_angle = jnp.arctan2(diff[..., 1], diff[..., 0])
    self_angle = _remainder_2pi(diff_angle - orient[:, None])
    other_angle = _remainder_2pi(diff_angle - orient[None, :])
    min_dist = (
        _front_distance(self_angle, MIN_ROBOT_RADIUS)
        + _front_distance(other_angle, MIN_ROBOT_RADIUS)
        - clipping_tolerance
    )
    early = sqd >= (2 * MIN_ROBOT_RADIUS) ** 2
    return ~early & (sqd < min_dist * min_dist)


def bot_ball_clipping(bot_pos, bot_orient, ball_pos, ball_radius, clipping_tolerance):
    """(B, k) mask: ball j clips into bot i
    (reference src/blobs/hypothesis.cpp:126-139)."""
    clipped_r = 0.48837 * ball_radius
    diff = ball_pos[None, :, :] - bot_pos[:, None, :]
    sqd = jnp.sum(diff * diff, axis=-1)
    min_dist = MIN_ROBOT_RADIUS + clipped_r
    outside = sqd >= min_dist * min_dist

    angle = _remainder_2pi(
        jnp.arctan2(diff[..., 1], diff[..., 0]) - bot_orient[:, None]
    )
    side = jnp.abs(angle) >= MIN_ROBOT_OPENING_ANGLE
    front_dist = (MIN_ROBOT_FRONT_DISTANCE + clipped_r) / jnp.cos(
        angle
    ) - clipping_tolerance
    front_clip = sqd < front_dist * front_dist
    return ~outside & (side | front_clip)


def clipping_nms(pos, orient, score, valid, clipping_tolerance):
    """Greedy clipping suppression by descending score.

    The reference removes every lower-score hypothesis whose hull clips a
    surviving higher-score one (reference src/main.cpp:195-223); greedy
    order-by-score is the stable formulation of that list surgery.
    Returns the kept mask.
    """
    n = pos.shape[0]
    clip = bot_bot_clipping(pos, orient, clipping_tolerance)
    order = jnp.argsort(-jnp.where(valid, score, -jnp.inf))
    # rank in descending-score order; ties are broken by slot position so
    # exact-duplicate hypotheses suppress each other (the reference removes
    # clipped hypotheses with score <= the survivor's)
    rank = jnp.zeros(n, dtype=jnp.int32).at[order].set(
        jnp.arange(n, dtype=jnp.int32)
    )

    def body(i, kept):
        idx = order[i]
        ok = kept[idx] & valid[idx]
        suppress = clip[idx] & (rank > rank[idx])
        return jnp.where(ok, kept & ~suppress, kept)

    # the greedy pass is inherently sequential; bound the trip count by the
    # number of valid candidates (invalid slots sort last and cannot
    # suppress), so the dependency chain is ~#bots deep, not max_bots deep
    n_valid = jnp.sum(valid.astype(jnp.int32))
    kept = jax.lax.fori_loop(0, n_valid, body, valid)
    return kept


def color_implausible(blob_color, blob_center, colors, blob_idx5):
    """(B, 5) constellation blob indices -> (B,) bool: the constellation
    is built from BALLS, not robot pattern blobs.

    Classify each blob by its nearest color in the 6-color table (orange,
    field, yellow, blue, green, pink — the same nearest-class rule the
    host classifier uses), using BOTH the disc-mean color and the center
    pixel color. A constellation is implausible iff the center blob is
    not team-classified in either table AND at least 3 of its 4 side
    blobs classify as ORANGE in both tables.

    The ball-colored-SIDES criterion is the load-bearing choice: in SSL
    nothing on a robot top is orange, so a hypothesis whose sides are
    balls is physically not a robot — while any rule keyed on sides
    looking PATTERN-colored is recall-unsafe before the adaptive colors
    settle (measured on the dense bench scene with reference colors:
    carpet-diluted yellow centers classify as orange — yellow->field
    dilution passes exactly through orange — and diluted green/pink
    sides classify as field, so a "sides must look green/pink" rule
    vetoed 8 of 16 planted robots on frame 0; the sides-are-orange rule
    vetoes 0 of 16 planted and all 90 ball-cluster noise constellations
    with either color table, adapted or not).

    Used by the OPT-IN untracked-emission veto
    (``thresholds.color_plausibility_veto``): the reference's
    DetectionBotHypothesis scores geometry only (reference
    src/blobs/hypothesis.cpp:97-205 — color enters detection scoring
    nowhere), so strict parity keeps this off; enabling it suppresses
    the ball-built noise constellations a dense scene produces
    (measured: oracle precision 0.089 on ~1430-blob scenes) without
    touching tracked emissions, whose color veto the reference already
    has (src/blobs/hypothesis.cpp:245-270). Non-ball clutter (field
    texture, line fragments) is deliberately NOT vetoed — those blobs
    are exactly what diluted true pattern blobs alias with.
    """
    safe = jnp.maximum(blob_idx5, 0)

    def classify(table):
        c = table[safe]                                      # (B, 5, 3)
        d = jnp.sum(
            (c[:, :, None, :] - colors[None, None, :, :]) ** 2, axis=-1
        )                                                    # (B, 5, 6)
        return jnp.argmin(d, axis=-1)                        # (B, 5)

    cls_d = classify(blob_color)
    cls_p = classify(blob_center)
    team_d = (cls_d[:, 0] == 2) | (cls_d[:, 0] == 3)
    team_p = (cls_p[:, 0] == 2) | (cls_p[:, 0] == 3)
    ball_side = (cls_d[:, 1:] == 0) & (cls_p[:, 1:] == 0)
    return ~(team_d | team_p) & (jnp.sum(ball_side, axis=-1) >= 3)


# ---------------------------------------------------------------------------
# full detector step
# ---------------------------------------------------------------------------


def detect(
    cfg: DetectorConfig,
    blobs,  # output dict of the blob machine (field_pos, color, valid, ...)
    tracked,
    colors,
    packed_cam,
    params,  # dict of scalars
    with_nms: bool = True,
):
    """Device detection step: blobs -> candidate bots + ball-clip mask.

    ``with_nms=False`` returns the merged candidates with ``bot_valid``
    holding the PRE-suppression validity and no ``ball_clipped`` key;
    callers batching several cameras run ``finalize_detections_batched``
    on the stacked outputs instead — the greedy clipping pass is a
    sequential loop of tiny-tensor steps, so one vmapped pass costs
    ~n_cams-fold fewer sequenced ops than per-camera unrolled copies.
    """
    blob_pos = blobs["field_pos"]
    blob_valid = blobs["valid"]
    blob_color = blobs["color"]

    det = detection_hypotheses(
        cfg, blob_pos, blob_valid, params["max_robot_radius"],
        blob_color=blob_color, colors=colors,
    )
    # opt-in color-plausibility veto on UNTRACKED hypotheses (see
    # color_implausible): the key's absence keeps the old pytree (no
    # retrace for existing callers); its value is a runtime 0/1 scalar so
    # toggling it never recompiles
    veto_knob = params.get("color_plausibility_veto")
    if veto_knob is not None:
        vetoed = (jnp.asarray(veto_knob) > 0.5) & color_implausible(
            blob_color, blobs["center"], colors, det["blob_idx"]
        )
        det = {
            **det,
            "score": jnp.where(vetoed, 0.0, det["score"]),
            "valid": det["valid"] & ~vetoed,
        }
    trk = tracked_hypotheses(
        cfg,
        blob_pos,
        blob_color,
        blob_valid,
        tracked,
        colors,
        packed_cam,
        params["max_bot_height"],
        params["min_tracking_radius"],
        params["max_bot_acceleration"],
    )

    # merge candidate pools and keep the top max_bots by score
    score = jnp.concatenate([trk["score"], det["score"]])
    pos = jnp.concatenate([trk["pos"], det["pos"]])
    orient = jnp.concatenate([trk["orientation"], det["orientation"]])
    blob_idx = jnp.concatenate([trk["blob_idx"], det["blob_idx"]])
    tracked_id = jnp.concatenate(
        [
            trk["tracked_id"],
            jnp.full(det["score"].shape, -1, dtype=trk["tracked_id"].dtype),
        ]
    )
    # score filter (reference keeps score > min_confidence)
    keep = score > params["min_confidence"]

    top_score, top_i = jax.lax.top_k(
        jnp.where(keep, score, -jnp.inf), cfg.max_bots
    )
    valid = top_score > 0.0
    pos_b = pos[top_i]
    orient_b = orient[top_i]
    score_b = jnp.where(valid, top_score, 0.0)

    det = {
        "bot_pos": pos_b,
        "bot_orientation": orient_b,
        "bot_score": score_b,
        "bot_blob_idx": blob_idx[top_i],
        "bot_tracked_id": tracked_id[top_i],
        "bot_valid": valid,
    }
    if not with_nms:
        return det

    kept = clipping_nms(
        pos_b, orient_b, score_b, valid, params["clipping_tolerance"]
    )

    ball_clip = bot_ball_clipping(
        pos_b,
        orient_b,
        blob_pos,
        params["ball_radius"],
        params["clipping_tolerance"],
    )
    det["bot_valid"] = kept
    det["ball_clipped"] = jnp.any(
        ball_clip & kept[:, None], axis=0
    ) & blob_valid
    return det


def finalize_detections_batched(det, blob_pos, blob_valid,
                                clipping_tolerance, ball_radius):
    """Vmapped clipping NMS + ball-clip mask over a stacked camera axis.

    Completes ``detect(..., with_nms=False)`` outputs: det arrays carry a
    leading (n_cams,) axis, ``clipping_tolerance`` is scalar or (n_cams,)
    (a per-camera tunable, cf. parallel/multicam._PER_CAMERA_PARAM_KEYS),
    ``ball_radius`` scalar. Returns det with post-suppression
    ``bot_valid`` and ``ball_clipped`` — identical to the per-camera
    path's results.
    """
    n = det["bot_pos"].shape[0]
    ct = jnp.broadcast_to(jnp.asarray(clipping_tolerance, jnp.float32), (n,))
    br = jnp.broadcast_to(jnp.asarray(ball_radius, jnp.float32), (n,))

    def one(pos, orient, score, valid, bpos, bvalid, tol, rad):
        kept = clipping_nms(pos, orient, score, valid, tol)
        bc = bot_ball_clipping(pos, orient, bpos, rad, tol)
        return kept, jnp.any(bc & kept[:, None], axis=0) & bvalid

    kept, ball_clip = jax.vmap(one)(
        det["bot_pos"], det["bot_orientation"], det["bot_score"],
        det["bot_valid"], blob_pos, blob_valid, ct, br,
    )
    det["bot_valid"] = kept
    det["ball_clipped"] = ball_clip
    return det


def _guarded_kmeans2(contrast, vals, c1_init, c2_init, iters: int = 24):
    """Vectorized guarded 2-means over the 4 side-blob colors of each bot.

    Mirrors the host kmeans2 / reference kMeans semantics exactly
    (reference src/blobs/kmeans.cpp:20-90): refuse to split when the
    tightest in-group pair is looser than the contrast distance, seed the
    centers from the nearest members, keep the previous centers on
    degenerate assignments or when the split is weaker than half the
    contrast distance. Integer (floor-toward-zero) mean division preserved.

    The iteration cap matches the host kmeans2_batch (24). The fixed point
    runs as a ``lax.while_loop`` that exits as soon as no row is active —
    bit-identical to the full 24-round unroll (a frozen row's update is a
    no-op: centers keep their value, ``ok`` cannot change once ``active``
    is False) but ~4x fewer sequenced tiny ops in the common case, which
    matters because this chain is op-dispatch-bound, not FLOP-bound.

    contrast (B, 3), vals (B, 4, 3), c1/c2 (3,) int32. Returns (B, 3) x2.
    """
    b = vals.shape[0]
    out_group = jnp.min(
        jnp.sum((vals - contrast[:, None, :]) ** 2, axis=-1), axis=-1
    )  # (B,)
    d = vals[:, :, None, :] - vals[:, None, :, :]
    pair = jnp.sum(d * d, axis=-1) + jnp.eye(4, dtype=vals.dtype) * jnp.asarray(
        2**30, vals.dtype
    )
    in_group = jnp.min(pair, axis=(-2, -1))
    may_split = in_group <= out_group

    c1 = vals[
        jnp.arange(b),
        jnp.argmin(jnp.sum((vals - c1_init) ** 2, axis=-1), axis=-1),
    ]
    c2 = vals[
        jnp.arange(b),
        jnp.argmin(jnp.sum((vals - c2_init) ** 2, axis=-1), axis=-1),
    ]
    degenerate = jnp.all(c1 == c2, axis=-1)

    ok = may_split & ~degenerate
    # fixed-point iteration with the scalar loop's stop rule: a row stops
    # updating as soon as EITHER center repeats (kmeans.py:41), so late
    # iterations cannot move a converged center's partner and diverge from
    # the host result. The reference's int division is Eigen Vector3i /
    # int = C++ trunc-toward-zero; dRGB values are non-negative so floor
    # == trunc here.
    def _cond(carry):
        it, _c1, _c2, _ok, active = carry
        return (it < iters) & jnp.any(active)

    def _body(carry):
        it, c1, c2, ok, active = carry
        d1 = jnp.sum((vals - c1[:, None, :]) ** 2, axis=-1)
        d2 = jnp.sum((vals - c2[:, None, :]) ** 2, axis=-1)
        assign1 = d1 < d2  # (B, 4)
        n1 = jnp.sum(assign1, axis=-1)
        n2 = 4 - n1
        empty = (n1 == 0) | (n2 == 0)
        ok = ok & ~(empty & active)
        active = active & ~empty
        s1 = jnp.sum(jnp.where(assign1[..., None], vals, 0), axis=1)
        s2 = jnp.sum(jnp.where(assign1[..., None], 0, vals), axis=1)
        new1 = s1 // jnp.maximum(n1, 1)[:, None]
        new2 = s2 // jnp.maximum(n2, 1)[:, None]
        conv = jnp.all(new1 == c1, axis=-1) | jnp.all(new2 == c2, axis=-1)
        c1 = jnp.where(active[:, None], new1, c1)
        c2 = jnp.where(active[:, None], new2, c2)
        active = active & ~conv
        return it + 1, c1, c2, ok, active

    _, c1, c2, ok, _ = jax.lax.while_loop(
        _cond, _body, (jnp.int32(0), c1, c2, ok, ok)
    )

    split = jnp.sum((c1 - c2) ** 2, axis=-1).astype(jnp.float32)
    weak = split < out_group.astype(jnp.float32) / 4.0
    ok = ok & ~weak
    c1 = jnp.where(ok[:, None], c1, c1_init)
    c2 = jnp.where(ok[:, None], c2, c2_init)
    return c1, c2


def estimate_bot_ids(det, blob_color, colors):
    """In-graph bot id estimate for device-resident multi-camera loops.

    Matches the host path's id logic (host_detect.calc_bot_id, reference
    src/blobs/hypothesis.cpp:208-227): a guarded per-bot 2-means refines the
    green/pink centers from the 4 side-blob colors (contrast = center blob)
    before classification; team by center-blob distance to yellow/blue.
    Tracked bots keep their known id.
    """
    yellow, blue, green, pink = colors[2], colors[3], colors[4], colors[5]
    idx = det["bot_blob_idx"]  # (B, 5)
    safe = jnp.maximum(idx, 0)
    c = blob_color[safe]  # (B, 5, 3)

    # host path truncates (np .astype), not rounds — keep bit-parity
    ci = c.astype(jnp.int32)
    g0 = green.astype(jnp.int32)
    p0 = pink.astype(jnp.int32)
    g_ref, p_ref = _guarded_kmeans2(ci[:, 0], ci[:, 1:5], g0, p0)

    d_green = jnp.sum((ci[:, 1:5] - g_ref[:, None, :]) ** 2, axis=-1)
    d_pink = jnp.sum((ci[:, 1:5] - p_ref[:, None, :]) ** 2, axis=-1)
    bits = (d_green < d_pink).astype(jnp.int32)
    mask = (
        bits[:, 0] * 8 + bits[:, 1] * 4 + bits[:, 2] * 2 + bits[:, 3]
    )
    base_id = jnp.asarray(PATTERN_LUT)[mask]
    d_blue = jnp.sum((c[:, 0] - blue) ** 2, axis=-1)
    d_yellow = jnp.sum((c[:, 0] - yellow) ** 2, axis=-1)
    team16 = jnp.where(d_blue < d_yellow, 16, 0)
    est = base_id + team16
    return jnp.where(det["bot_tracked_id"] >= 0, det["bot_tracked_id"], est)
