"""Blob response chain on the flat field grid.

Array-program equivalents of the reference's gradient/SAT/circularity/extraction
OpenCL kernels:

* gradient ring response  — kernel/gradientDot.cl:22-30
* summed-area table       — kernel/satHorizontal.cl + satVertical.cl, here two
                            `jnp.cumsum` calls (parallel scans instead of
                            one serial work-item per row/column)
* quadrant circularity    — kernel/satBlobCenter.cl:34-45, shifted-slice reads
* blob extraction         — kernel/blobList.cl:36-102; the atomic-append
                            compaction becomes a masked top-k into a fixed
                            `max_blobs`-slot tensor, disc color statistics
                            become an edge-padded depthwise convolution.

All shapes are static; geometry changes recompile (rare by design).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _shift2d(img: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """img[y + dy, x + dx] with clamp-to-edge, implemented as pad + slice."""
    h, w = img.shape[:2]
    pad_y = (max(dy, 0), max(-dy, 0))
    pad_x = (max(dx, 0), max(-dx, 0))
    pads = ((pad_y[1], pad_y[0]), (pad_x[1], pad_x[0])) + tuple(
        ((0, 0),) * (img.ndim - 2)
    )
    padded = jnp.pad(img, pads, mode="edge")
    return padded[
        (pad_y[1] + dy) : (pad_y[1] + dy + h),
        (pad_x[1] + dx) : (pad_x[1] + dx + w),
    ]


def gradient_dot(flat: jnp.ndarray, offset: int) -> jnp.ndarray:
    """Dot product of central-difference gradients over the dRGB channels.

    offset = ceil(max_blob_radius / field_scale) / 3 (integer division), the
    ring response scale. flat: (H, W, 3) f32 -> (H, W) f32.
    Pads once and takes static slices so XLA materializes one buffer.
    """
    o = offset
    h, w = flat.shape[:2]
    p = jnp.pad(flat, ((o, o), (o, o), (0, 0)), mode="edge")

    def sl(dy, dx):
        return p[o + dy : o + dy + h, o + dx : o + dx + w]

    gx = sl(0, o) - sl(0, -o)
    gy = sl(o, 0) - sl(-o, 0)
    return jnp.sum(gx * gy, axis=-1)


def summed_area_table(img: jnp.ndarray) -> jnp.ndarray:
    """Inclusive 2D prefix sum (summed-area table), f32."""
    return jnp.cumsum(jnp.cumsum(img, axis=1), axis=0)


def circularity(sat: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Blob circularity from quadrant box sums of the gradient-dot SAT.

    For each pixel, the four quadrant sums over [1, radius] offsets are read
    from the SAT; the positive-diagonal quadrants contribute positively and
    the negative-diagonal quadrants invert automatically through swapped
    rectangle corners; the response is the minimum of the four, normalized by
    radius^2 (reference kernel/satBlobCenter.cl:34-45).
    """
    r = radius
    h, w = sat.shape
    p = jnp.pad(sat, ((r, r), (r, r)), mode="edge")

    def read(dx, dy):
        return p[r + dy : r + dy + h, r + dx : r + dx + w]

    pp = read(r, r) - read(r, 1) - read(1, r) + read(1, 1)
    pn = read(r, -r) - read(r, -1) - read(1, -r) + read(1, -1)  # inverted
    np_ = read(-r, r) - read(-r, 1) - read(-1, r) + read(-1, 1)  # inverted
    nn = read(-r, -r) - read(-r, -1) - read(-1, -r) + read(-1, -1)
    return jnp.minimum(jnp.minimum(pp, nn), jnp.minimum(pn, np_)) / float(r * r)


def disc_offsets(radius: int) -> np.ndarray:
    """Integer offsets (dy, dx) with dx^2 + dy^2 <= radius^2."""
    out = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx * dx + dy * dy <= radius * radius:
                out.append((dy, dx))
    return np.array(out, dtype=np.int32)


def disc_stats(flat: jnp.ndarray, radius: int) -> tuple[jnp.ndarray, jnp.ndarray, int]:
    """Per-pixel disc sums of the flat image and its square.

    Returns (s1, s2, n): s1/s2 are (H, W, 3) disc sums of value and value^2
    over the disc of `radius` (clamp-to-edge at borders, matching the
    reference's CLK_ADDRESS_CLAMP_TO_EDGE reads), n is the disc pixel count.

    Implemented as a depthwise convolution with a 0/1 disc kernel on an
    edge-padded image; XLA lowers this onto the convolution units.
    """
    r = radius
    offs = disc_offsets(r)
    n = len(offs)
    mask = np.zeros((2 * r + 1, 2 * r + 1), dtype=np.float32)
    mask[offs[:, 0] + r, offs[:, 1] + r] = 1.0

    padded = jnp.pad(flat, ((r, r), (r, r), (0, 0)), mode="edge")
    x = jnp.moveaxis(padded, -1, 0)[None]  # NCHW, C=3
    kern = jnp.broadcast_to(mask, (3, 1, 2 * r + 1, 2 * r + 1))  # OIHW depthwise

    def conv(v):
        # HIGHEST precision: keep f32 products (the default may run in a
        # reduced precision and break parity with the reference's f32 sums)
        return jax.lax.conv_general_dilated(
            v,
            kern,
            window_strides=(1, 1),
            padding="VALID",
            feature_group_count=3,
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )

    s1 = jnp.moveaxis(conv(x)[0], 0, -1)
    s2 = jnp.moveaxis(conv(x * x)[0], 0, -1)
    return s1, s2, n


def disc_stats_sat(
    flat: jnp.ndarray, radius: int
) -> tuple[jnp.ndarray, jnp.ndarray, int]:
    """disc_stats via row prefix sums: the disc is a stack of 2r+1 row
    spans, each evaluated as one shifted difference of a row-cumsum —
    (2r+1) adds instead of a (2r+1)^2-tap convolution. Exact same result
    as disc_stats (clamp-to-edge padding)."""
    r = radius
    offs = disc_offsets(r)
    n = len(offs)
    half_w = {
        int(dy): int(np.max(offs[offs[:, 0] == dy, 1])) for dy in range(-r, r + 1)
    }

    padded = jnp.pad(flat, ((r, r), (r, r + 1), (0, 0)), mode="edge")
    both = jnp.concatenate([padded, padded * padded], axis=-1)  # (.., 6)
    # inclusive row cumsum with a leading zero column for clean differences
    csum = jnp.cumsum(both, axis=1)
    zeros = jnp.zeros_like(csum[:, :1])
    csum = jnp.concatenate([zeros, csum], axis=1)  # (H+2r, W+3r+2?, 6)

    h, w = flat.shape[:2]
    acc = None
    for dy in range(-r, r + 1):
        hw = half_w[dy]
        rows = csum[r + dy : r + dy + h]
        # row span [x - hw, x + hw] for output x -> padded cols
        hi = rows[:, r + hw + 1 : r + hw + 1 + w]
        lo = rows[:, r - hw : r - hw + w]
        span = hi - lo
        acc = span if acc is None else acc + span
    return acc[..., :3], acc[..., 3:], n


def local_max_mask(circ: jnp.ndarray) -> jnp.ndarray:
    """True where no 4-neighbor (clamp-to-edge) strictly exceeds the value."""
    h, w = circ.shape
    p = jnp.pad(circ, ((1, 1), (1, 1)), mode="edge")

    def sl(dy, dx):
        return p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    return (
        (sl(0, -1) <= circ)
        & (sl(0, 1) <= circ)
        & (sl(-1, 0) <= circ)
        & (sl(1, 0) <= circ)
    )


def subpixel_peak(neg: jnp.ndarray, center: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Quadratic interpolation of the peak position from 3 samples."""
    denom = neg - 2 * center + pos
    return jnp.where(denom != 0, 0.5 * (neg - pos) / denom, 0.0)


def disc_stats_at(flat: jnp.ndarray, iy: jnp.ndarray, ix: jnp.ndarray,
                  radius: int):
    """Disc sums of value and value^2 at K candidate pixels only.

    Direct gathers of the ~pi*r^2 disc taps per candidate (clamp-to-edge,
    matching the reference's CLK_ADDRESS_CLAMP_TO_EDGE reads,
    reference kernel/blobList.cl:58-75 — which also computes the stats
    only at surviving pixels, never over the full image). K*|disc| short
    gather rows move far fewer bytes than full-image span sums when
    K*|disc| << H*W.

    Returns (s1 (K,3), s2 (K,3), n)."""
    h, w = flat.shape[:2]
    offs = disc_offsets(radius)
    n = len(offs)
    yy = jnp.clip(iy[:, None] + offs[None, :, 0], 0, h - 1)  # (K, n)
    xx = jnp.clip(ix[:, None] + offs[None, :, 1], 0, w - 1)
    v = flat.reshape(-1, flat.shape[-1])[(yy * w + xx).reshape(-1)]
    v = v.reshape(iy.shape[0], n, flat.shape[-1])
    return jnp.sum(v, axis=1), jnp.sum(v * v, axis=1), n


def _compact_masked(masked, max_blobs: int):
    """Exact top-`max_blobs` over a (-inf)-masked response map.

    Fast path: per-row top-m, then global top-k over the h*m survivors,
    instead of one flat-map top_k. m is sized 4x above the uniform-spread
    average, so the row stage is lossless for every scene whose densest
    row holds <= m candidates. Exhausted rows repeat index 0, so validity
    comes from the VALUES, never the indices.

    Occupancy tiers (exact, keyed on the DENSEST ROW's candidate count —
    one cheap reduce over the mask that fuses into its producer):

    * densest row <= m_small (every realistic production scene, ~tens of
      blobs over hundreds of rows): a 6-lane row stage and a global
      ordering over h*m_small candidates — the global sort is the
      dominant extraction cost and shrinks ~m/m_small-fold;
    * densest row <= m: the classic m-lane path (dense bench scenes,
      ~1400 blobs/camera);
    * densest row > m (an adversarial wall of robots aligned on one flat
      row — the quiet-cap genre the detector's anchor window also
      guards): the exact flat-map top_k over the whole image.

    Every tier returns the identical exact selection; lax.switch executes
    only the taken branch. The reference's own truncation is arbitrary
    atomic-append order past maxBlobs (kernel/blobList.cl:87-91), so all
    tiers remain strictly stronger than its semantics
    (tests/test_blob_ops.py pins tier equality and the saturated-row
    fallback).
    """
    h, w = masked.shape
    m = min(w, max(16, -(-4 * max_blobs // h)))
    def stage(mm):
        row_scores, row_idx = jax.lax.top_k(masked, mm)  # (h, mm)
        cand_idx = (row_idx + (jnp.arange(h) * w)[:, None]).reshape(-1)
        vals, ci = jax.lax.top_k(row_scores.reshape(-1), max_blobs)
        return vals, cand_idx[ci]

    if m == w:  # row stage degenerate: every row fits entirely
        return stage(m)

    def flat_map(_):
        vals, idx = jax.lax.top_k(masked.reshape(-1), max_blobs)
        return vals, idx

    # densest-row occupancy: exact, so the tier choice is lossless
    max_row = jnp.max(jnp.sum(masked > -jnp.inf, axis=1))

    m_small = min(m, max(6, -(-max_blobs // h)))
    branches = [lambda _: stage(m), flat_map]
    index = (max_row > m).astype(jnp.int32)
    if m_small < m and h * m_small >= max_blobs:
        branches.insert(0, lambda _: stage(m_small))
        index = index + (max_row > m_small)
    return jax.lax.switch(index, branches, None)


@partial(jax.jit, static_argnames=("radius", "max_blobs"))
def extract_blobs(
    flat: jnp.ndarray,
    circ: jnp.ndarray,
    circ_threshold: jnp.ndarray,
    min_score: jnp.ndarray,
    radius: int,
    max_blobs: int,
):
    """Blob extraction and compaction.

    Thresholds the circularity map, keeps 4-neighbor local maxima, compacts
    the surviving pixels into `max_blobs` slots by descending circularity,
    computes disc color mean/stddev and score = circ / sum(stddev) at those
    candidates only (like the reference, which runs the disc loop only for
    pixels that survive the threshold + local-max test,
    reference kernel/blobList.cl:48-75), then orders the slots by
    descending score.

    When more pixels pass the filters than there are slots, the kept set is
    the circularity top-k — a deterministic, strictly stronger rule than
    the reference's arbitrary atomic-append truncation at maxBlobs
    (reference kernel/blobList.cl:87-91).

    Returns a dict:
      pos    (k, 2) f32 sub-pixel flat-grid coordinates (x, y)
      color  (k, 3) f32 disc mean color (dRGB)
      center (k, 3) f32 center pixel color (dRGB)
      circ   (k,)   f32 circularity response
      score  (k,)   f32 circ / sum(stddev)
      valid  (k,)   bool slot holds a real blob
      count  ()     i32 number of pixels passing threshold+local-max
    """
    h, w = circ.shape

    valid = (circ >= circ_threshold) & local_max_mask(circ)
    count = jnp.sum(valid, dtype=jnp.int32)

    masked = jnp.where(valid, circ, -jnp.inf)
    top_circ, idx = _compact_masked(masked, max_blobs)
    slot_valid = top_circ > -jnp.inf

    iy = idx // w
    ix = idx % w

    # candidate-local color statistics (reference blobList semantics)
    s1, s2, n = disc_stats_at(flat, iy, ix, radius)
    mean = s1 / n
    var = jnp.maximum(s2 / n - mean * mean, 0.0)
    stddev_sum = jnp.sum(jnp.sqrt(var), axis=-1)
    c0 = jnp.where(slot_valid, top_circ, 0.0)
    score = c0 / jnp.maximum(stddev_sum, 1e-12)
    slot_valid &= score >= min_score

    def gather2d(img, yy, xx):
        return img.reshape(-1, *img.shape[2:])[yy * w + xx]

    # all four sub-pixel neighbors in ONE gather (4K indices in a single
    # op instead of four 1K-index ops)
    nidx = jnp.stack(
        [
            iy * w + jnp.maximum(ix - 1, 0),
            iy * w + jnp.minimum(ix + 1, w - 1),
            jnp.maximum(iy - 1, 0) * w + ix,
            jnp.minimum(iy + 1, h - 1) * w + ix,
        ],
        axis=-1,
    )
    nv = circ.reshape(-1)[nidx.reshape(-1)].reshape(-1, 4)

    px = ix.astype(jnp.float32) + subpixel_peak(nv[:, 0], c0, nv[:, 1])
    py = iy.astype(jnp.float32) + subpixel_peak(nv[:, 2], c0, nv[:, 3])

    # downstream consumes slots in descending-score order (the detector's
    # ring/anchor tie-breaks key on slot position)
    sort_score, order = jax.lax.top_k(
        jnp.where(slot_valid, score, -jnp.inf), max_blobs
    )
    slot_valid = sort_score > -jnp.inf

    return {
        "pos": jnp.stack([px, py], axis=-1)[order],
        "color": mean[order],
        "center": gather2d(flat, iy, ix)[order],
        "circ": c0[order],
        "score": jnp.where(slot_valid, sort_score, 0.0),
        "valid": slot_valid,
        "count": count,
    }


def blob_response(flat, circ, circ_threshold, radius: int):
    """Full-map blob response: (masked score, mean color) per pixel.

    The score-first formulation of the reference's blobList semantics
    (reference kernel/blobList.cl:48-94): every pixel surviving the
    threshold + local-max test carries score = circ / sum(stddev) and the
    disc mean color; extraction then selects directly by score, so the
    compaction needs no second ordering pass and no candidate-local
    gathers. Span-sum based (disc_stats_sat); on the GPU the stencil
    kernels of ops/blob_pallas.py compute the same maps.

    Returns (masked_score (H, W) with -inf outside the mask, mean
    (H, W, 3), count scalar).
    """
    s1, s2, n = disc_stats_sat(flat, radius)
    mean = s1 / n
    var = jnp.maximum(s2 / n - mean * mean, 0.0)
    stddev_sum = jnp.sum(jnp.sqrt(var), axis=-1)
    score = circ / jnp.maximum(stddev_sum, 1e-12)
    keep = (circ >= circ_threshold) & local_max_mask(circ)
    return jnp.where(keep, score, -jnp.inf), mean, jnp.sum(
        keep, dtype=jnp.int32
    )


@partial(jax.jit, static_argnames=("max_blobs",))
def extract_blobs_scored(flat, circ, masked_score, mean, count,
                         max_blobs: int):
    """Blob compaction from a per-pixel response (see blob_response).

    Selection keys directly on the score — the slot order IS the score
    order, matching extract_blobs' output contract without its second
    top_k; the per-candidate work left is three small gathers (mean,
    center, circ+neighbors for the sub-pixel peak).
    """
    h, w = masked_score.shape
    top_score, idx = _compact_masked(masked_score, max_blobs)
    slot_valid = top_score > -jnp.inf

    iy = idx // w
    ix = idx % w

    def gather2d(img, yy, xx):
        return img.reshape(-1, *img.shape[2:])[yy * w + xx]

    # circ at the winner and its 4 neighbors in one gather (sub-pixel peak)
    nidx = jnp.stack(
        [
            iy * w + ix,
            iy * w + jnp.maximum(ix - 1, 0),
            iy * w + jnp.minimum(ix + 1, w - 1),
            jnp.maximum(iy - 1, 0) * w + ix,
            jnp.minimum(iy + 1, h - 1) * w + ix,
        ],
        axis=-1,
    )
    nv = circ.reshape(-1)[nidx.reshape(-1)].reshape(-1, 5)
    c0 = jnp.where(slot_valid, nv[:, 0], 0.0)
    px = ix.astype(jnp.float32) + subpixel_peak(nv[:, 1], c0, nv[:, 2])
    py = iy.astype(jnp.float32) + subpixel_peak(nv[:, 3], c0, nv[:, 4])

    if isinstance(mean, (tuple, list)):
        # channel planes (the fused kernel's output layout): per-plane
        # gathers beat materializing an (H, W, 3) interleaved copy
        color = jnp.stack([p.reshape(-1)[idx] for p in mean], axis=-1)
    else:
        color = gather2d(mean, iy, ix)

    return {
        "pos": jnp.stack([px, py], axis=-1),
        "color": color,
        "center": gather2d(flat, iy, ix),
        "circ": c0,
        "score": jnp.where(slot_valid, top_score, 0.0),
        "valid": slot_valid,
        "count": count,
    }


def blob_score_map(
    flat: jnp.ndarray,
    circ: jnp.ndarray,
    circ_threshold,
    radius: int,
) -> jnp.ndarray:
    """Image-space blob score map (-inf where filtered), the analogue of the
    benchmark-only blobScore kernel (reference kernel/blobScore.cl:23-66)."""
    s1, s2, n = disc_stats_sat(flat, radius)
    mean = s1 / n
    var = jnp.maximum(s2 / n - mean * mean, 0.0)
    stddev_sum = jnp.sum(jnp.sqrt(var), axis=-1)
    score = circ / jnp.maximum(stddev_sum, 1e-12)
    keep = (circ >= circ_threshold) & local_max_mask(circ)
    return jnp.where(keep, score, -jnp.inf)


def legacy_circularity(flat_channel: jnp.ndarray, max_radius: int) -> jnp.ndarray:
    """Direct (non-SAT) quadrant circularity, kept for parity/testing only —
    superseded by the SAT chain (reference kernel/blobCenter.cl:29-63)."""
    sq = (max_radius + 0.5) ** 2
    pp = jnp.zeros_like(flat_channel)
    pn = jnp.zeros_like(flat_channel)
    np_ = jnp.zeros_like(flat_channel)
    nn = jnp.zeros_like(flat_channel)
    count = 0
    for y in range(1, max_radius + 1):
        for x in range(1, max_radius + 1):
            if x * x + y * y <= sq:
                np_ = np_ + _shift2d(flat_channel, -x, y)
                pp = pp + _shift2d(flat_channel, x, y)
                nn = nn + _shift2d(flat_channel, -x, -y)
                pn = pn + _shift2d(flat_channel, x, -y)
                count += 1
    pp, pn, np_, nn = (v / count for v in (pp, pn, np_, nn))
    return jnp.minimum(jnp.minimum(pp, nn), jnp.minimum(-pn, -np_))


def gradient_offset(max_blob_radius: float, field_scale: float) -> int:
    """offset = ceil(max_blob_radius / field_scale) // 3 (integer division),
    matching the reference kernel invocation (reference src/Resources.cpp:160)."""
    return max(1, int(math.ceil(max_blob_radius / field_scale)) // 3)


def sat_radius(min_blob_radius: float, field_scale: float) -> int:
    """Quadrant radius = ceil(min_blob_radius / field_scale)
    (reference src/Resources.cpp:163)."""
    return max(1, int(math.ceil(min_blob_radius / field_scale)))


def disc_radius(min_blob_radius: float, field_scale: float) -> int:
    """Color-statistics disc radius = floor(min_blob_radius / field_scale)
    (reference src/main.cpp:289)."""
    return max(1, int(math.floor(min_blob_radius / field_scale)))
