"""Mesh-sharded index tests on the simulated 8-device CPU mesh —
multi-chip coverage the reference has no analog for (SURVEY.md §4)."""

import numpy as np
import pytest

from turdb_tpu.models.flat import FlatIndex
from turdb_tpu.parallel.mesh import make_mesh
from turdb_tpu.parallel.sharded import ShardedHnswIndex

RNG = np.random.default_rng(99)


def recall_at_k(pred, true):
    hits = 0
    for p, t in zip(pred, true):
        hits += len(set(p[p >= 0]) & set(t))
    return hits / true.size


@pytest.fixture(scope="module")
def data():
    x = RNG.standard_normal((3000, 32)).astype(np.float32)
    q = RNG.standard_normal((64, 32)).astype(np.float32)
    flat = FlatIndex(dim=32)
    flat.add(x)
    _, true_ids = flat.search(q, k=10)
    return x, q, true_ids


def test_sharded_recall_4shards(data):
    x, q, true_ids = data
    mesh = make_mesh(n_db=4, n_data=2)
    idx = ShardedHnswIndex(dim=32, mesh=mesh, ef_construction=64)
    gids = idx.add(x)
    assert len(idx) == 3000
    d, gi = idx.search(q, k=10, ef=64)
    # translate packed gids back to insertion order ids
    lut = {}
    for orig, g in enumerate(gids):
        lut[g] = orig
    pred = np.array([[lut.get(g, -1) for g in row] for row in gi])
    r = recall_at_k(pred, true_ids)
    assert r >= 0.93, f"sharded recall {r:.3f}"
    assert (d[:, 0] <= d[:, -1]).all()


def test_sharded_serve_pack(data):
    """Mesh serving pack: per-shard packed-block serve + two-level merge
    must match the graph path's recall and respect tombstones."""
    x, q, true_ids = data
    mesh = make_mesh(n_db=4, n_data=2)
    idx = ShardedHnswIndex(dim=32, mesh=mesh, ef_construction=64)
    gids = idx.add(x)
    idx.pack_serving()
    d, gi = idx.search_serve(q, k=10, ef=48)
    lut = {int(g): orig for orig, g in enumerate(gids)}
    pred = np.array([[lut.get(int(v), -1) for v in row] for row in gi])
    r = recall_at_k(pred, true_ids)
    assert r >= 0.9, f"mesh serve recall {r:.3f}"
    assert (d[:, 0] <= d[:, -1]).all()
    # tombstoned rows never surface through the filtered serve path
    idx.delete(gids[:1500])
    _, gi2 = idx.search_serve(q, k=10, ef=48)
    dead = set(int(g) for g in gids[:1500])
    assert not any(int(v) in dead for row in gi2 for v in row if v >= 0)
    # graph mutation invalidates the pack
    idx.add(x[:8])
    assert idx._serve is None


def test_sharded_balances(data):
    x, _, _ = data
    mesh = make_mesh(n_db=8, n_data=1)
    idx = ShardedHnswIndex(dim=32, mesh=mesh, ef_construction=32)
    idx.add(x[:1000])
    assert idx.sizes.sum() == 1000
    assert idx.sizes.max() - idx.sizes.min() <= 1


def test_sharded_delete(data):
    x, _, _ = data
    mesh = make_mesh(n_db=2, n_data=1)
    idx = ShardedHnswIndex(dim=32, mesh=mesh, ef_construction=32)
    gids = idx.add(x[:500])
    q = x[:3]
    _, gi = idx.search(q, k=1)
    assert gi[:, 0].tolist() == gids[:3].tolist()
    idx.delete(gids[:3])
    _, gi2 = idx.search(q, k=1)
    for j in range(3):
        assert gi2[j, 0] not in gids[:3]


def test_sharded_ivf(data):
    from turdb_tpu.parallel.sharded_ivf import ShardedIvfIndex

    x, q, true_ids = data
    mesh = make_mesh(n_db=4, n_data=2)
    idx = ShardedIvfIndex(dim=32, mesh=mesh, nprobe=16)
    gids = idx.add(x)
    idx.train()
    assert len(idx) == 3000
    d, gi = idx.search(q, k=10)
    lut = {g: i for i, g in enumerate(gids)}
    pred = np.array([[lut.get(g, -1) for g in row] for row in gi])
    r = recall_at_k(pred, true_ids)
    assert r >= 0.9, f"sharded ivf recall {r:.3f}"
    assert (d[:, 0] <= d[:, -1]).all()


def test_sharded_ivf_compact_store(data):
    """Per-shard compact stores (int8 probe + SQ16 rerank) keep recall on
    the mesh — the BASELINE 100M config's memory mode."""
    from turdb_tpu.parallel.sharded_ivf import ShardedIvfIndex

    x, q, true_ids = data
    mesh = make_mesh(n_db=4, n_data=2)
    idx = ShardedIvfIndex(
        dim=32, mesh=mesh, nprobe=16, sq8=True, keep_f32=False
    )
    gids = idx.add(x)
    idx.train()
    import jax.numpy as jnp

    assert all(s.state.pvecs.dtype == jnp.uint16 for s in idx.shards)
    d, gi = idx.search(q, k=10)
    lut = {g: i for i, g in enumerate(gids)}
    pred = np.array([[lut.get(g, -1) for g in row] for row in gi])
    r = recall_at_k(pred, true_ids)
    assert r >= 0.9, f"sharded compact ivf recall {r:.3f}"

def test_gid_stability_across_growth(data):
    """Packed gids must survive capacity growth (round-1 verdict weak #10:
    capacity-based packing invalidated stored gids on _ensure growth)."""
    x, _, _ = data
    mesh = make_mesh(n_db=2, n_data=1)
    idx = ShardedHnswIndex(dim=32, mesh=mesh, ef_construction=32,
                           capacity_per_shard=1024)
    gids = idx.add(x[:600])
    cap0 = idx.capacity
    # force growth past the initial per-shard capacity
    more = np.repeat(x[:300], 8, axis=0) + RNG.standard_normal(
        (2400, 32)
    ).astype(np.float32)
    idx.add(more)
    assert idx.capacity > cap0
    # old gids still resolve to the same vectors
    sh, sl = idx.unpack_ids(gids[:5])
    q = x[:5]
    _, gi = idx.search(q, k=1)
    for j in range(5):
        assert gi[j, 0] == gids[j], "stored gid no longer matches"

def test_multihost_two_level_merge(data):
    """(host, data, db) mesh: store sharded over host x db, search merges
    db inside a node, then host across nodes, with only [B,k] crossing the host
    axis. Results must match the exact oracle like the flat mesh does."""
    from turdb_tpu.parallel.mesh import make_multihost_mesh
    from turdb_tpu.parallel.sharded_ivf import ShardedIvfIndex

    x, q, true_ids = data
    mesh = make_multihost_mesh(n_host=2, n_db=2, n_data=2)
    idx = ShardedHnswIndex(dim=32, mesh=mesh, ef_construction=64)
    assert idx.n_shards == 4
    gids = idx.add(x)
    d, gi = idx.search(q, k=10, ef=64)
    lut = {g: i for i, g in enumerate(gids)}
    pred = np.array([[lut.get(g, -1) for g in row] for row in gi])
    r = recall_at_k(pred, true_ids)
    assert r >= 0.93, f"multihost hnsw recall {r:.3f}"

    ivf = ShardedIvfIndex(dim=32, mesh=mesh, nprobe=16)
    g2 = ivf.add(x)
    ivf.train()
    d2, gi2 = ivf.search(q, k=10)
    lut2 = {g: i for i, g in enumerate(g2)}
    pred2 = np.array([[lut2.get(g, -1) for g in row] for row in gi2])
    r2 = recall_at_k(pred2, true_ids)
    assert r2 >= 0.9, f"multihost ivf recall {r2:.3f}"


def test_mesh_parallel_train_recall(data):
    """Round-3: ShardedIvfIndex.train runs the k-means+assignment phase
    as ONE stacked mesh program (was host-serial per shard, round-2 weak
    #8) and per-shard finishing in threads; recall must match the
    serial build."""
    import time

    from turdb_tpu.parallel.mesh import make_mesh
    from turdb_tpu.parallel.sharded_ivf import ShardedIvfIndex

    x, q, truth_pos = data
    mesh = make_mesh(n_db=4, n_data=2)
    idx = ShardedIvfIndex(dim=32, mesh=mesh, nprobe=16)
    gids = idx.add(x)
    t0 = time.perf_counter()
    idx.train()
    build_s = time.perf_counter() - t0
    d, g = idx.search(q, k=10)
    truth_g = gids[truth_pos]
    rec = np.mean([
        len(set(g[i].tolist()) & set(truth_g[i].tolist())) / 10
        for i in range(len(q))
    ])
    assert rec >= 0.9, f"mesh-parallel build recall {rec:.3f} (in {build_s:.1f}s)"


def test_sharded_bulk_build_recall():
    """Round-3: the fast BULK path runs under the mesh (per-shard bulk
    derivation on device-pinned threads) with recall parity."""
    from turdb_tpu.parallel.mesh import make_mesh
    from turdb_tpu.parallel.sharded import ShardedHnswIndex

    rng = np.random.default_rng(3)
    centers = rng.standard_normal((64, 32)).astype(np.float32) * 4.0
    n = 4 * 8192
    x = (centers[rng.integers(0, 64, n)]
         + rng.standard_normal((n, 32)).astype(np.float32))
    q = (centers[rng.integers(0, 64, 48)]
         + rng.standard_normal((48, 32)).astype(np.float32))
    flat = FlatIndex(dim=32, capacity=n)
    flat.add(x)
    _, truth = flat.search(q, k=10)
    mesh = make_mesh(n_db=4, n_data=2)
    idx = ShardedHnswIndex(dim=32, mesh=mesh, capacity_per_shard=8192 + 16)
    gids = idx.add(x)
    assert idx._descent_ef == 32            # bulk path ran
    d, g = idx.search(q, k=10, ef=96)
    truth_g = gids[truth]
    rec = np.mean([
        len(set(g[i].tolist()) & set(truth_g[i].tolist())) / 10
        for i in range(len(q))
    ])
    assert rec >= 0.9, f"sharded bulk recall {rec:.3f}"
