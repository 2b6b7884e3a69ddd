"""Unit tests for distance/topk primitives — semantics must match the
reference's scalar implementations (reference src/hnsw/distance.rs:55-97)."""

import jax.numpy as jnp
import numpy as np
import pytest

from turdb_tpu.ops.distance import (
    Metric,
    gathered_distances,
    normalize_rows,
    pairwise_distances,
    prep_norms,
)
from turdb_tpu.ops.topk import mask_duplicates, member_mask, merge_topk, topk_smallest

RNG = np.random.default_rng(42)


def _np_l2sq(q, x):
    return ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)


def test_pairwise_l2_matches_numpy():
    q = RNG.standard_normal((7, 33)).astype(np.float32)
    x = RNG.standard_normal((19, 33)).astype(np.float32)
    d = np.asarray(pairwise_distances(jnp.asarray(q), jnp.asarray(x), Metric.L2))
    np.testing.assert_allclose(d, _np_l2sq(q, x), rtol=1e-4, atol=1e-3)


def test_pairwise_ip_and_cosine():
    q = RNG.standard_normal((5, 16)).astype(np.float32)
    x = RNG.standard_normal((11, 16)).astype(np.float32)
    d_ip = np.asarray(pairwise_distances(jnp.asarray(q), jnp.asarray(x), Metric.IP))
    np.testing.assert_allclose(d_ip, -(q @ x.T), rtol=1e-5, atol=1e-5)

    qn = np.asarray(normalize_rows(jnp.asarray(q)))
    xn = np.asarray(normalize_rows(jnp.asarray(x)))
    d_cos = np.asarray(
        pairwise_distances(jnp.asarray(qn), jnp.asarray(xn), Metric.COSINE)
    )
    expected = 1 - (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
        x / np.linalg.norm(x, axis=1, keepdims=True)
    ).T
    np.testing.assert_allclose(d_cos, expected, rtol=1e-4, atol=1e-5)


def test_gathered_matches_pairwise():
    q = RNG.standard_normal((4, 24)).astype(np.float32)
    x = RNG.standard_normal((50, 24)).astype(np.float32)
    idx = RNG.integers(0, 50, size=(4, 6))
    full = _np_l2sq(q, x)
    g = np.asarray(
        gathered_distances(jnp.asarray(q), jnp.asarray(x[idx]), Metric.L2)
    )
    np.testing.assert_allclose(
        g, np.take_along_axis(full, idx, axis=1), rtol=1e-4, atol=1e-3
    )


def test_prep_norms():
    x = RNG.standard_normal((9, 12)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(prep_norms(jnp.asarray(x))), (x**2).sum(-1), rtol=1e-5
    )


def test_topk_smallest_with_inf():
    d = jnp.asarray([[3.0, np.inf, 1.0, 2.0]])
    i = jnp.asarray([[10, 11, 12, 13]], dtype=jnp.int32)
    td, ti = topk_smallest(d, i, 3)
    assert np.asarray(ti).tolist() == [[12, 13, 10]]
    assert np.asarray(td)[0, 0] == 1.0


def test_merge_topk():
    da = jnp.asarray([[1.0, 4.0]])
    ia = jnp.asarray([[1, 4]], dtype=jnp.int32)
    db = jnp.asarray([[2.0, 3.0]])
    ib = jnp.asarray([[2, 3]], dtype=jnp.int32)
    d, i = merge_topk(da, ia, db, ib, 3)
    assert np.asarray(i).tolist() == [[1, 2, 3]]


def test_mask_duplicates():
    ids = jnp.asarray([[5, 3, 5, -1, 3]], dtype=jnp.int32)
    d = jnp.ones((1, 5), jnp.float32)
    mi, md = mask_duplicates(ids, d)
    assert np.asarray(mi).tolist() == [[5, 3, -1, -1, -1]]
    assert np.isinf(np.asarray(md)[0, 2:]).all()


def test_member_mask():
    ids = jnp.asarray([[1, 2, 3, -1]], dtype=jnp.int32)
    table = jnp.asarray([[2, 7, -1]], dtype=jnp.int32)
    m = np.asarray(member_mask(ids, table))
    assert m.tolist() == [[False, True, False, False]]


def test_topk_smallest_wide_exact():
    """Two-level wide top-k is EXACT (values AND index consistency) vs
    the full sort, across shapes incl. ties, +inf rows, and non-pow2
    widths — it replaces lax.top_k on the IVF cell probe's wide rows."""
    import numpy as np

    from turdb_tpu.ops.topk import topk_smallest_wide

    rng = np.random.default_rng(0)
    for n, k in ((16384, 8), (32768, 8), (1000, 10), (7, 3), (513, 5)):
        d = rng.standard_normal((17, n)).astype(np.float32)
        d[0, :5] = d[0, 5]          # ties
        d[1] = np.inf               # fully invalid row
        d[2, ::3] = np.inf          # sparse invalids
        v, i = topk_smallest_wide(jnp.asarray(d), k)
        ref = np.sort(d, axis=-1)[:, :k]
        assert np.allclose(np.asarray(v), ref, equal_nan=True)
        gat = np.take_along_axis(d, np.asarray(i), -1)
        assert np.allclose(gat, np.asarray(v), equal_nan=True)


@pytest.mark.parametrize("width", [1280, 8192, 32768])
def test_topk_smallest_matches_argsort(width):
    """topk_smallest on both sides of its 2048-lane routing threshold
    (single lax.top_k below, two-level selector above) equals a numpy
    sort: same values, and ids that carry those values."""
    rng = np.random.default_rng(width)
    d = rng.standard_normal((6, width)).astype(np.float32)
    d[1, ::2] = np.inf
    ids = rng.permutation(width * 6).reshape(6, width).astype(np.int32)
    k = 10
    v, i = topk_smallest(jnp.asarray(d), jnp.asarray(ids), k)
    order = np.argsort(d, axis=-1, kind="stable")[:, :k]
    assert np.array_equal(np.asarray(v), np.take_along_axis(d, order, -1))
    pos = {int(x): j for j, x in enumerate(ids.ravel())}
    for r in range(6):
        got = [d.ravel()[pos[int(x)]] for x in np.asarray(i)[r]]
        assert np.array_equal(got, np.asarray(v)[r])
