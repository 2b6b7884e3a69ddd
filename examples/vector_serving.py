"""Standalone vector-index usage: exact, IVF, HNSW, and the mesh.

Runs on the CPU backend with 8 simulated devices by default so the mesh
path works anywhere; on a GPU host, drop the env pinning to run on the
cards.

Usage:  python examples/vector_serving.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from turdb_tpu.models import FlatIndex, HnswIndex
from turdb_tpu.models.ivf import IvfIndex
from turdb_tpu.parallel import ShardedIvfIndex, make_mesh


def recall(ids, truth):
    return np.mean([
        len(set(p[p >= 0]) & set(t)) / len(t) for p, t in zip(ids, truth)
    ])


def main():
    rng = np.random.default_rng(0)
    n, dim = 20_000, 64
    centers = rng.standard_normal((256, dim)).astype(np.float32) * 4.0
    x = (centers[rng.integers(0, 256, n)]
         + rng.standard_normal((n, dim)).astype(np.float32))
    q = (centers[rng.integers(0, 256, 100)]
         + rng.standard_normal((100, dim)).astype(np.float32))

    flat = FlatIndex(dim=dim, capacity=n)          # exact oracle
    flat.add(x)
    _, truth = flat.search(q, k=10)

    ivf = IvfIndex(dim=dim)                        # the throughput engine
    ivf.add(x)
    ivf.train()
    _, ids = ivf.search(q, k=10, nprobe=8)
    print(f"IVF   recall@10 = {recall(ids, truth):.4f}")

    hnsw = HnswIndex(dim=dim, capacity=n)          # the reference algorithm
    hnsw.add(x)
    _, ids = hnsw.search(q, k=10, ef=64)
    print(f"HNSW  recall@10 = {recall(ids, truth):.4f}")

    mesh = make_mesh(n_db=4, n_data=2)             # 8 devices: 4-shard store
    sivf = ShardedIvfIndex(dim=dim, mesh=mesh, nprobe=8)
    gids = sivf.add(x)
    sivf.train()
    _, sg = sivf.search(q, k=10)
    truth_g = gids[truth]
    r = np.mean([
        len(set(sg[i].tolist()) & set(truth_g[i].tolist())) / 10
        for i in range(len(q))
    ])
    print(f"mesh  recall@10 = {r:.4f}  (4 shards x 2-way query parallel)")


if __name__ == "__main__":
    main()
