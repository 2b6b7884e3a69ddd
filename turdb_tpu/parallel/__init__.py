"""Mesh parallelism: the device-mesh replacement for the reference's
shared-memory concurrency (SURVEY.md §2.9).

The reference scales one logical index with 64-way lock-sharded caches and
page locks inside one process (reference src/storage/cache.rs:31-42,
src/database/page_locks.rs). Here the same capability — concurrent
scale-out of one logical index — is mesh parallelism: vectors and graph
shards laid out over a `jax.sharding.Mesh` axis ("db"), query batches
data-parallel over a second axis ("data"), per-shard top-k merged with XLA
collectives (NCCL on GPUs) between the cards of a node.
"""

from turdb_tpu.parallel.mesh import make_mesh  # noqa: F401
from turdb_tpu.parallel.sharded import ShardedHnswIndex  # noqa: F401
from turdb_tpu.parallel.sharded_ivf import ShardedIvfIndex  # noqa: F401
