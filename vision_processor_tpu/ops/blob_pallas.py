"""Blob response as tiled stencil kernels (Pallas, Triton route).

The XLA chain for the score-first response (ops/blob.py gradient_dot ->
summed_area_table -> circularity -> blob_response) materializes the
gradient, a two-cumsum SAT, the circularity map, the six-channel row
prefix sums of the disc statistics and their span differences as
full-map round trips. Here three stencil kernels replace it, each over
power-of-two 2-D tiles with every neighbour read as a clamped load at a
shifted offset (served by L1/L2), and no state carried across blocks:

1. ``_grad_kernel``: the gradient-dot map (clamped channel reads);
2. ``_circ_kernel``: the four quadrant box sums read straight from that
   map — the SAT never exists;
3. ``_response_kernel``: the 4-neighbour local-max test, the disc colour
   mean/stddev from direct tap loads, the score and the threshold mask.

Semantics: every box sum adds exactly the gradient entries the SAT
formulation's clamped quadrant reads cover, border included, and the disc
sums the same taps as the row-prefix spans; only the order of the
additions differs (local adds instead of global cumsum differences), so
values agree to f32 rounding (~1e-5 relative). The kernels are the more
accurate side: the SAT's and the row prefix sums' large-minus-large
differences round at the magnitude of whole rows, and the disc variance
is taken relative to the centre pixel.

Correspondence: reference kernel/gradientDot.cl:22-30,
kernel/satHorizontal.cl + satVertical.cl, kernel/satBlobCenter.cl:34-45,
kernel/blobList.cl:48-94.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

TH, TW = 8, 128  # output tile (rows, lanes) of every kernel here
NUM_WARPS = 4


def _rows_cols():
    """Row and column coordinates of this block's tile."""
    ys = pl.program_id(0) * TH + jnp.arange(TH, dtype=jnp.int32)
    xs = pl.program_id(1) * TW + jnp.arange(TW, dtype=jnp.int32)
    return ys, xs


def _at(ref, ys, xs, dy: int, dx: int, h: int, w: int):
    """ref[clip(ys + dy), clip(xs + dx)] as a (TH, TW) tile."""
    yy = jnp.clip(ys + dy, 0, h - 1)[:, None]
    xx = jnp.clip(xs + dx, 0, w - 1)[None, :]
    return plt.load(ref.at[yy, xx])


def _store(ref, val):
    """Write this block's tile (outputs are padded to whole tiles)."""
    plt.store(ref.at[pl.ds(pl.program_id(0) * TH, TH),
                     pl.ds(pl.program_id(1) * TW, TW)], val)


def _grad_kernel(c0_ref, c1_ref, c2_ref, g_ref, *, o: int, h: int, w: int):
    """ops/blob.gradient_dot: sum_c (c[y, x+o] - c[y, x-o]) *
    (c[y+o, x] - c[y-o, x]), channel reads clamped to the map."""
    ys, xs = _rows_cols()
    g = None
    for ref in (c0_ref, c1_ref, c2_ref):
        gx = _at(ref, ys, xs, 0, o, h, w) - _at(ref, ys, xs, 0, -o, h, w)
        gy = _at(ref, ys, xs, o, 0, h, w) - _at(ref, ys, xs, -o, 0, h, w)
        g = gx * gy if g is None else g + gx * gy
    _store(g_ref, g)


def _circ_kernel(g_ref, circ_ref, *, r: int, h: int, w: int):
    """ops/blob.circularity as direct box sums of the gradient map.

    The SAT quadrant read ``S[hi] - S[lo]`` with clamped indices sums the
    rows t with clip(y + lo) < t <= clip(y + hi), and likewise the
    columns; each quadrant here adds exactly those g entries, so only the
    order of the additions differs from the SAT chain."""
    ys, xs = _rows_cols()
    spans = {1: (1, r), -1: (-r, -1)}  # (lo, hi) offsets per side

    def inside(v, n, lo, hi, t):
        return (jnp.clip(v + lo, 0, n - 1) < t) & (t <= jnp.clip(v + hi, 0, n - 1))

    quad = {}
    for sy in (1, -1):
        rlo, rhi = spans[sy]
        for sx in (1, -1):
            clo, chi = spans[sx]
            acc = jnp.zeros((TH, TW), jnp.float32)
            for a in range(rlo + 1, rhi + 1):
                row_ok = inside(ys, h, rlo, rhi, ys + a)
                for b in range(clo + 1, chi + 1):
                    col_ok = inside(xs, w, clo, chi, xs + b)
                    t = _at(g_ref, ys, xs, a, b, h, w)
                    acc = acc + jnp.where(row_ok[:, None] & col_ok[None, :],
                                          t, 0.0)
            quad[sy, sx] = acc
    circ = jnp.minimum(
        jnp.minimum(quad[1, 1], quad[-1, -1]),
        jnp.minimum(-quad[1, -1], -quad[-1, 1]),
    ) / float(r * r)
    _store(circ_ref, circ)


def _response_kernel(th_ref, circ_ref, c0_ref, c1_ref, c2_ref, ms_ref,
                     m0_ref, m1_ref, m2_ref, *, taps, h: int, w: int):
    """Masked score and disc mean colour (ops/blob.blob_response)."""
    ys, xs = _rows_cols()
    circ = _at(circ_ref, ys, xs, 0, 0, h, w)
    lmax = (
        (_at(circ_ref, ys, xs, 0, -1, h, w) <= circ)
        & (_at(circ_ref, ys, xs, 0, 1, h, w) <= circ)
        & (_at(circ_ref, ys, xs, -1, 0, h, w) <= circ)
        & (_at(circ_ref, ys, xs, 1, 0, h, w) <= circ)
    )
    inv_n = 1.0 / float(len(taps))
    std_sum = None
    for ref, mean_ref in ((c0_ref, m0_ref), (c1_ref, m1_ref),
                          (c2_ref, m2_ref)):
        # taps summed relative to the centre pixel: E[d^2] - E[d]^2 then
        # cancels small numbers instead of squares of up to 255^2, which
        # keeps near-uniform discs' stddev accurate in f32
        center = _at(ref, ys, xs, 0, 0, h, w)
        s1 = s2 = jnp.zeros((TH, TW), jnp.float32)
        for dy, dx in taps:
            d = _at(ref, ys, xs, dy, dx, h, w) - center
            s1 = s1 + d
            s2 = s2 + d * d
        m = s1 * inv_n
        sd = jnp.sqrt(jnp.maximum(s2 * inv_n - m * m, 0.0))
        std_sum = sd if std_sum is None else std_sum + sd
        _store(mean_ref, center + m)
    score = circ / jnp.maximum(std_sum, 1e-12)
    keep = (circ >= plt.load(th_ref.at[0])) & lmax
    _store(ms_ref, jnp.where(keep, score, -jnp.inf))


def _call(kernel, out_hw, n_out: int, interpret: bool, name: str):
    """pallas_call over whole tiles covering ``out_hw``; the outputs keep
    that tile padding (callers slice)."""
    grid = (pl.cdiv(out_hw[0], TH), pl.cdiv(out_hw[1], TW))
    return pl.pallas_call(
        kernel,
        grid=grid,
        out_shape=[jax.ShapeDtypeStruct((grid[0] * TH, grid[1] * TW),
                                        jnp.float32)] * n_out,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name=name,
    )


@functools.partial(
    jax.jit,
    static_argnames=("grad_offset", "sat_radius", "disc_radius", "interpret"),
)
def blob_response_fused(flat, circ_threshold, grad_offset: int,
                        sat_radius: int, disc_radius: int,
                        interpret: bool = False):
    """flat (H, W, 3) -> (masked_score, circ, (mean0, mean1, mean2), count).

    The kernel form of ops/blob.py's gradient_dot + summed_area_table +
    circularity + blob_response (see the module docstring for the
    tolerance contract). ``interpret`` runs the kernels in the Pallas
    interpreter (CPU tests).
    """
    from .blob import disc_offsets

    o, r = int(grad_offset), int(sat_radius)
    h, w = flat.shape[:2]
    chans = [flat[:, :, c] for c in range(3)]
    (g,) = _call(
        functools.partial(_grad_kernel, o=o, h=h, w=w),
        (h, w), 1, interpret, "blob_grad",
    )(*chans)
    (circ,) = _call(
        functools.partial(_circ_kernel, r=r, h=h, w=w),
        (h, w), 1, interpret, "blob_circ",
    )(g)
    taps = tuple(map(tuple, np.asarray(disc_offsets(int(disc_radius)))))
    ms, m0, m1, m2 = _call(
        functools.partial(_response_kernel, taps=taps, h=h, w=w),
        (h, w), 4, interpret, "blob_response",
    )(jnp.asarray(circ_threshold, jnp.float32).reshape(1), circ, *chans)
    ms, circ, m0, m1, m2 = (x[:h, :w] for x in (ms, circ, m0, m1, m2))
    count = jnp.sum(ms > -jnp.inf, dtype=jnp.int32)
    return ms, circ, (m0, m1, m2), count
