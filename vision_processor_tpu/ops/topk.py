"""Masked row top-m selections: a Pallas kernel (Triton route) and XLA.

Two selection patterns follow the blob map:

* blob compaction: per-row top-m over the masked score map
  (ops/blob.py _compact_masked), which is ``lax.top_k`` over a map that
  exists anyway;
* neighbour-ring / tracked-candidate selection: top-m by rank or by
  distance over the blob axis per query (models/detector.py). The XLA
  form materializes the (queries, blobs) score map and rewrites it in
  each of the m argmax passes, because each pass depends on the last.

``query_select_topk``'s kernel keeps a block of query rows in registers,
computes the query<->blob distances there, and runs the m passes without
writing the map.

Semantics are EXACTLY ``lax.top_k`` on the masked score rows for slots
holding real values — descending values, ties broken toward the lower
index — with the iter_top_k caveat on exhausted slots (indices repeat
the first all-masked lane instead of staying distinct; validity MUST be
derived from the returned values, see models/detector.py iter_top_k).

The reference has no analogue — its blob list is an atomic append
(reference kernel/blobList.cl:87-91) and its neighbour search a k-d tree
(reference src/blobs/kdtree.cpp:18-37).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .platform import use_gpu_kernels

QBLK = 4        # query rows per block: a (4, 2048) f32 tile spreads to 32
NUM_WARPS = 8   # registers a thread over 8 warps


def _select_m(cur, m: int, mp: int):
    """m (max, lowest-index) passes over ``cur`` (rows, K); results in the
    first m columns of (rows, mp) value/index tiles."""
    rows, k = cur.shape
    iota = jax.lax.broadcasted_iota(jnp.int32, (rows, k), 1)
    col = jax.lax.broadcasted_iota(jnp.int32, (rows, mp), 1)
    vals = jnp.full((rows, mp), -jnp.inf, jnp.float32)
    idxs = jnp.zeros((rows, mp), jnp.int32)
    for j in range(m):
        v = jnp.max(cur, axis=1, keepdims=True)
        i = jnp.min(jnp.where(cur == v, iota, k), axis=1, keepdims=True)
        vals = jnp.where(col == j, v, vals)
        idxs = jnp.where(col == j, i, idxs)
        cur = jnp.where(iota == i, -jnp.inf, cur)
    return vals, idxs


def _query_topk_kernel(qx_ref, qy_ref, r2_ref, bx_ref, by_ref, rank_ref,
                       vals_ref, idx_ref, *, m: int, by_rank: bool):
    qx = qx_ref[...][:, None]
    qy = qy_ref[...][:, None]
    r2 = r2_ref[...][:, None]
    rank = rank_ref[...][None, :]
    dx = bx_ref[...][None, :] - qx
    dy = by_ref[...][None, :] - qy
    d2 = dx * dx + dy * dy
    ok = (d2 <= r2) & (rank < jnp.inf)
    cur = jnp.where(ok, -rank if by_rank else -d2, -jnp.inf)

    vals, idxs = _select_m(cur, m, vals_ref.shape[1])
    vals_ref[...] = vals
    idx_ref[...] = idxs


def _query_select_kernel(query_xy, radius2, blob_xy, rank, m: int,
                         by_rank: bool, interpret: bool):
    q, k = query_xy.shape[0], blob_xy.shape[0]
    qp = pl.cdiv(max(q, 1), QBLK) * QBLK
    kp = pl.next_power_of_2(max(k, 16))
    mp = pl.next_power_of_2(max(m, 16))

    def padq(v):
        # padded queries keep radius2 == 0 and are sliced off below
        return jnp.pad(v.astype(jnp.float32), (0, qp - q))

    def padk(v, fill):
        return jnp.pad(v.astype(jnp.float32), (0, kp - k),
                       constant_values=fill)

    qspec = pl.BlockSpec((QBLK,), lambda i: (i,))
    kspec = pl.BlockSpec((kp,), lambda i: (0,))
    ospec = pl.BlockSpec((QBLK, mp), lambda i: (i, 0))
    vals, idxs = pl.pallas_call(
        functools.partial(_query_topk_kernel, m=m, by_rank=by_rank),
        grid=(qp // QBLK,),
        in_specs=[qspec] * 3 + [kspec] * 3,
        out_specs=[ospec, ospec],
        out_shape=[
            jax.ShapeDtypeStruct((qp, mp), jnp.float32),
            jax.ShapeDtypeStruct((qp, mp), jnp.int32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="query_select_topk",
    )(padq(query_xy[:, 0]), padq(query_xy[:, 1]), padq(radius2),
      padk(blob_xy[:, 0], 0.0), padk(blob_xy[:, 1], 0.0),
      padk(rank, jnp.inf))
    return vals[:q, :m], idxs[:q, :m]


def _query_select_xla(query_xy, radius2, blob_xy, rank, m: int,
                      by_rank: bool):
    """The plain formulation: materialized (Q, K) score map, m argmax
    passes (exact; ties to the lower index)."""
    k = blob_xy.shape[0]
    diff = blob_xy[None, :, :] - query_xy[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    ok = (d2 <= radius2[:, None]) & (rank[None, :] < jnp.inf)
    score = jnp.where(ok, -rank[None, :] if by_rank else -d2, -jnp.inf)
    vals, idxs = [], []
    cur = score
    iota = jnp.arange(k)
    for _ in range(m):
        i = jnp.argmax(cur, axis=-1)
        v = jnp.take_along_axis(cur, i[..., None], axis=-1)[..., 0]
        vals.append(v)
        idxs.append(i.astype(jnp.int32))
        cur = jnp.where(iota == i[..., None], -jnp.inf, cur)
    return jnp.stack(vals, axis=-1), jnp.stack(idxs, axis=-1)


def query_select_topk(query_xy, radius2, blob_xy, rank, m: int,
                      by_rank: bool, interpret: bool = False):
    """Per query: top-m blobs within radius, best-ranked or nearest first.

    query_xy (Q, 2), radius2 (Q,) squared search radii, blob_xy (K, 2),
    rank (K,) — +inf marks an invalid blob; with ``by_rank`` the score is
    -rank (lowest rank wins), otherwise -d2 (nearest wins). Returns
    (scores (Q, m), indices (Q, m)); validity is score > -inf.

    The kernel runs on the GPU (and in the Pallas interpreter with
    ``interpret``); the CPU runs the XLA formulation.
    """
    if interpret or use_gpu_kernels():
        return _query_select_kernel(query_xy, radius2, blob_xy, rank, m,
                                    by_rank, interpret)
    return _query_select_xla(query_xy, radius2, blob_xy, rank, m, by_rank)
