"""Kernel-logic tests for ops/topk.py (Pallas interpreter on CPU).

The GPU runs the same kernel code compiled through Triton; the interpreter
executes it here, so these pin the selection semantics (exact lax.top_k
order, lowest-index ties, exhausted-row behavior, padding of the query,
blob and result axes to powers of two) without hardware. The XLA form
(what the rest of the CPU suite exercises) is asserted equal too.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vision_processor_tpu.models.detector import iter_top_k
from vision_processor_tpu.ops import topk as T


@pytest.mark.parametrize("by_rank", [True, False])
def test_query_select_matches_fallback(by_rank):
    rng = np.random.default_rng(7)
    q, k, m = 13, 257, 4
    qxy = jnp.asarray(rng.uniform(-1000, 1000, (q, 2)).astype(np.float32))
    bxy = jnp.asarray(rng.uniform(-1000, 1000, (k, 2)).astype(np.float32))
    r2 = jnp.asarray(rng.uniform(100, 400, (q,)).astype(np.float32) ** 2)
    rank = rng.uniform(0, 10, (k,)).astype(np.float32)
    rank[rng.uniform(size=k) < 0.2] = np.inf  # invalid blobs
    rank = jnp.asarray(rank)

    pv, pi = T.query_select_topk(qxy, r2, bxy, rank, m=m, by_rank=by_rank,
                                 interpret=True)
    fv, fi = T.query_select_topk(qxy, r2, bxy, rank, m=m, by_rank=by_rank)
    pv, fv = np.asarray(pv), np.asarray(fv)
    valid = fv > -np.inf
    np.testing.assert_array_equal(pv > -np.inf, valid)
    if by_rank:
        # rank scores pass through untouched -> bit-equal
        np.testing.assert_array_equal(pv, fv)
    else:
        # -d2 values may differ in the last ulp (XLA may contract
        # diff*diff sums to FMA; the interpreter keeps separate mul+add)
        np.testing.assert_allclose(pv[valid], fv[valid], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(pi)[valid], np.asarray(fi)[valid])

    # and the fallback itself is the masked iter_top_k it replaced
    diff = bxy[None, :, :] - qxy[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    ok = (d2 <= r2[:, None]) & (rank[None, :] < jnp.inf)
    score = jnp.where(ok, -rank[None, :] if by_rank else -d2, -jnp.inf)
    rv, ri = iter_top_k(score, m)
    np.testing.assert_array_equal(np.asarray(fv), np.asarray(rv))
    np.testing.assert_array_equal(np.asarray(fi), np.asarray(ri))


def test_query_select_exhausted_rows():
    # a query with nothing in radius yields -inf values; indices repeat 0
    qxy = jnp.zeros((2, 2), jnp.float32)
    bxy = jnp.asarray([[1000.0, 1000.0], [2000.0, 0.0]], jnp.float32)
    r2 = jnp.asarray([1.0, 10.0**7], jnp.float32)
    rank = jnp.zeros((2,), jnp.float32)
    v, i = T.query_select_topk(qxy, r2, bxy, rank, m=2, by_rank=False,
                               interpret=True)
    v = np.asarray(v)
    assert (v[0] == -np.inf).all()
    assert v[1, 0] > -np.inf and v[1, 1] > -np.inf
    assert np.asarray(i)[1, 0] == 0 and np.asarray(i)[1, 1] == 1


@pytest.mark.parametrize("k,m", [(770, 19), (962, 6)])
def test_query_select_widths(k, m):
    """Blob axes padded to the next power of two and m past one 16-lane
    result tile: indices identical to the XLA argmax passes."""
    rng = np.random.default_rng(k)
    q = 37
    bxy = jnp.asarray(rng.uniform(-500, 500, (k, 2)).astype(np.float32))
    qxy = bxy[:q] + 3.0
    r2 = jnp.full((q,), 150.0 ** 2, jnp.float32)
    rank = jnp.asarray(rng.permutation(k).astype(np.float32))
    pv, pi = T.query_select_topk(qxy, r2, bxy, rank, m=m, by_rank=True,
                                 interpret=True)
    fv, fi = T.query_select_topk(qxy, r2, bxy, rank, m=m, by_rank=True)
    assert pv.shape == pi.shape == (q, m)
    np.testing.assert_array_equal(np.asarray(pv), np.asarray(fv))
    np.testing.assert_array_equal(np.asarray(pi), np.asarray(fi))
    assert (np.asarray(fv) > -np.inf).sum() >= q * min(m, 6)
