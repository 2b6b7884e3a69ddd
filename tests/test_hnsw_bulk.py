"""Bulk (initial-load) HNSW build: clustered exact-kNN -> diversity graph.

Round-2 verdict item #3: the wave path pays a latency-bound beam search
per wave; the bulk path derives the graph from per-cluster all-pairs
distances (matmuls) + the reference diversity rule
(operations.rs:181-233) + reverse merge (mod.rs:1067-1077 semantics).
These tests assert recall parity with the exact oracle and that
incremental adds still work on top of a bulk-built graph.
"""

import numpy as np
import pytest

from turdb_tpu.models.flat import FlatIndex
from turdb_tpu.models.hnsw import HnswIndex


def _clustered(rng, n, dim, n_clusters=128):
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, size=n)
    radius = rng.uniform(0.3, 1.7, size=(n, 1)).astype(np.float32)
    return (
        centers[assign] + radius * rng.standard_normal((n, dim)).astype(np.float32)
    ).astype(np.float32)


def _recall(ids, truth):
    k = truth.shape[1]
    return float(
        np.mean([len(set(p[p >= 0]) & set(t)) / k for p, t in zip(ids, truth)])
    )


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    pool = _clustered(rng, 12_256, 32)
    x, q = pool[:12_000], pool[12_000:]
    flat = FlatIndex(dim=32, capacity=len(x))
    flat.add(x)
    _, truth = flat.search(q, k=10)
    return x, q, truth


def test_bulk_build_recall(data):
    x, q, truth = data
    idx = HnswIndex(dim=32, capacity=len(x), bulk_threshold=1000)
    slots = idx.add(x)
    assert len(idx) == len(x)
    assert slots[0] == 0 and slots[-1] == len(x) - 1
    _, ids = idx.search(q, k=10, ef=64)
    r = _recall(ids, truth)
    assert r >= 0.90, f"bulk recall {r}"


def test_bulk_then_incremental(data):
    x, q, truth = data
    idx = HnswIndex(dim=32, capacity=len(x), bulk_threshold=1000)
    idx.add(x[:10_000])
    idx.add(x[10_000:])  # below threshold -> wave path on bulk graph
    assert len(idx) == len(x)
    _, ids = idx.search(q, k=10, ef=64)
    r = _recall(ids, truth)
    assert r >= 0.88, f"bulk+incremental recall {r}"


def test_bulk_delete_tombstones(data):
    x, q, truth = data
    idx = HnswIndex(dim=32, capacity=len(x), bulk_threshold=1000)
    idx.add(x)
    victims = np.unique(truth[:, 0])
    idx.delete(victims)
    _, ids = idx.search(q, k=10, ef=64)
    assert not np.isin(np.asarray(ids).ravel(), victims).any()


def test_bulk_build_compile_count(tmp_path):
    """Guardrail for the round-3 compile diet: every eager jnp op between
    the scanned stage programs is a separate compile, and compiles are
    set-up time on every backend. A 20k build+pack must stay well under the pre-diet
    count (~157; post-diet ~55). Runs in a subprocess so the count is
    not polluted by previously cached programs."""
    import subprocess
    import sys

    code = r"""
import logging
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_log_compiles", True)
n = [0]
class F(logging.Filter):
    def filter(self, rec):
        if rec.getMessage().startswith("Compiling jit("):
            n[0] += 1
        return False
logging.getLogger("jax._src.interpreters.pxla").addFilter(F())
import numpy as np
from turdb_tpu.models.hnsw import HnswIndex
rng = np.random.default_rng(0)
x = rng.standard_normal((20000, 32)).astype(np.float32)
idx = HnswIndex(dim=32, ef_construction=100, capacity=len(x))
idx.add(x)
idx.pack_serving()
print("COMPILES", n[0])
assert 10 < n[0] <= 100, f"compile count {n[0]} outside (10, 100] - counting broken or regression"
"""
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, timeout=600,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=1"},
    )
    assert r.returncode == 0, (r.stdout.decode()[-300:]
                               + r.stderr.decode()[-500:])


def test_native_reverse_topk_matches_numpy():
    """hnsw_host.cpp turdb_reverse_topk must be bit-identical to the
    numpy packed-key stable-argsort path (incl. ties and inf)."""
    from turdb_tpu.models.hnsw import _bulk_reverse_lists
    from turdb_tpu.native.build import reverse_topk

    rng = np.random.default_rng(3)
    for _ in range(40):
        ns = int(rng.integers(2, 80))
        deg = int(rng.integers(1, 12))
        rcap = int(rng.integers(1, 9))
        slots = np.sort(
            rng.choice(300, size=ns, replace=False)
        ).astype(np.int64)
        adj = rng.choice(
            np.concatenate([slots, [-1, -1]]), size=(ns, deg)
        ).astype(np.int32)
        dist = (rng.integers(0, 4, size=(ns, deg)) * 0.5).astype(np.float32)
        dist[rng.random((ns, deg)) < 0.1] = np.inf
        pos = np.full(int(slots.max()) + 1, -1, np.int64)
        pos[slots] = np.arange(ns)
        nat = reverse_topk(slots, adj, dist, pos, rcap)
        if nat is None:
            pytest.skip("no native toolchain")
        # numpy reference: run the same helper with the native path
        # unavailable (monkeypatch via the module symbol)
        import turdb_tpu.native.build as B

        orig = B.reverse_topk
        B.reverse_topk = lambda *a, **k: None
        try:
            ref = _bulk_reverse_lists(slots, adj, dist, rcap)
        finally:
            B.reverse_topk = orig
        assert np.array_equal(nat, ref)
