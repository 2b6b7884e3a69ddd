"""Serving-pack (packed-neighbor-block int8 beam + exact rerank) tests.

Reference behavior contract: hnsw search semantics (search.rs:311-350)
+ stepping-stone filtered search (mod.rs:62-68,1176-1273); the layout is
the batched redesign described in models/hnsw_serve.py.
"""

import numpy as np
import pytest

from turdb_tpu.models.flat import FlatIndex
from turdb_tpu.models.hnsw import HnswIndex
from turdb_tpu.ops.distance import Metric


def _clustered(rng, n, d, c=64):
    centers = rng.standard_normal((c, d)).astype(np.float32) * 4.0
    a = rng.integers(0, c, size=n)
    r = rng.uniform(0.3, 1.7, size=(n, 1)).astype(np.float32)
    return (centers[a] + r * rng.standard_normal((n, d)).astype(np.float32))


def _recall(ids, truth):
    return np.mean([
        len(set(p[p >= 0]) & set(t)) / len(t) for p, t in zip(ids, truth)
    ])


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(5)
    n, d = 9000, 32
    x = _clustered(rng, n + 64, d)
    base, queries = x[:n], x[n:]
    idx = HnswIndex(dim=d, capacity=n, bulk_threshold=4096)
    idx.add(base)
    flat = FlatIndex(dim=d, capacity=n)
    flat.add(base)
    _, truth = flat.search(queries, k=10)
    return idx, base, queries, truth


def test_serve_recall_matches_graph_path(built):
    idx, base, queries, truth = built
    d_g, i_g = idx.search(queries, k=10, ef=64)
    r_graph = _recall(i_g, truth)
    d_s, i_s = idx.search_serve(queries, k=10, ef=64)
    r_serve = _recall(i_s, truth)
    assert r_serve >= 0.9
    assert r_serve >= r_graph - 0.05
    # rerank distances are exact: compare against flat oracle distances
    flat_d = np.sum((queries[:, None, :] - base[truth]) ** 2, axis=-1)
    hit = i_s[:, 0] == truth[:, 0]
    assert hit.mean() > 0.7
    np.testing.assert_allclose(
        d_s[hit, 0], flat_d[hit, 0], rtol=1e-3, atol=1e-2
    )


def test_serve_filtered_mask(built):
    idx, base, queries, truth = built
    allowed = np.zeros(len(base), bool)
    allowed[::2] = True
    _, ids = idx.search_serve(queries, k=10, ef=96, allowed=allowed)
    got = ids[ids >= 0]
    assert len(got) > 0
    assert np.all(got % 2 == 0)


def test_serve_tombstones(built):
    idx, base, queries, truth = built
    victim = int(truth[0, 0])
    idx.delete([victim])
    try:
        _, ids = idx.search_serve(queries[:1], k=10, ef=64)
        assert victim not in set(ids[0].tolist())
    finally:
        idx._alive[victim] = True


def test_serve_invalidated_on_add(built):
    rng = np.random.default_rng(9)
    idx = HnswIndex(dim=16, capacity=2048)
    idx.add(rng.standard_normal((256, 16)).astype(np.float32))
    idx.pack_serving()
    assert idx.serve is not None
    idx.add(rng.standard_normal((8, 16)).astype(np.float32))
    assert idx.serve is None
    # repacks lazily and finds the new rows
    q = np.asarray(idx.state.vectors)[260][None, :]
    _, ids = idx.search_serve(q, k=1, ef=32)
    assert ids[0, 0] == 260


def test_serve_empty_and_cosine():
    idx = HnswIndex(dim=8, metric=Metric.COSINE, capacity=1024)
    d, ids = idx.search_serve(np.ones((2, 8), np.float32), k=3)
    assert (ids == -1).all()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((512, 8)).astype(np.float32)
    idx.add(x)
    _, ids = idx.search_serve(x[:4], k=1, ef=32)
    assert (ids[:, 0] == np.arange(4)).mean() >= 0.75


def test_serve_pack_m_memory_knob(built):
    """pack_m (round-4 verdict item #7): packing only the first pack_m
    diversity-first neighbors halves nbr_codes/nbr_meta; the beam still
    reaches gate-grade recall (the dropped edges are re-reachable
    through the remaining graph) at the same ef."""
    idx, base, queries, truth = built
    idx.pack_serving()
    full_m = idx.serve.nbr_codes.shape[1]
    _, i_full = idx.search_serve(queries, k=10, ef=64)
    r_full = _recall(i_full, truth)

    idx.pack_serving(pack_m=full_m // 2)
    assert idx.serve.nbr_codes.shape[1] == full_m // 2
    assert idx.serve.nbr_meta.shape[1] == full_m // 2
    _, i_half = idx.search_serve(queries, k=10, ef=64)
    r_half = _recall(i_half, truth)
    assert r_half >= 0.9
    assert r_half >= r_full - 0.05
    idx.serve = None   # don't leak the truncated pack to other tests
