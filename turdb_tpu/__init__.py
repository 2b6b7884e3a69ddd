"""turdb_tpu — an embedded SQL database whose vector indexes run on an
accelerator through JAX, with the capabilities of kahflane/TurDB.

A new design, not a port: the reference's pointer-chasing Rust engine
(see SURVEY.md) becomes a columnar engine whose vector store lives in
device memory and is searched by batched JAX/XLA programs. The centerpiece
is the vector index-and-query engine (reference src/hnsw/): exact flat
search, IVF-Flat and fixed-degree HNSW graphs searched by batched beam
search whose distances are matrix products, sharded over a device mesh.
Around it: a PostgreSQL-flavored SQL layer, MVCC snapshot isolation, WAL
durability, secondary indexes, and a CLI — host-side, columnar-first.

Public API mirrors the reference's `Database` surface
(reference src/database/database.rs:127, src/lib.rs:98-101).
"""

__version__ = "0.1.0"

from turdb_tpu.ops.distance import Metric  # noqa: F401

__all__ = ["Metric", "Database", "connect", "RecoveryInfo",
           "CheckpointInfo", "__version__"]


def __getattr__(name):
    # Lazy: importing the SQL/database stack pulls in the full engine; keep
    # `import turdb_tpu` cheap for kernel-only users (ops/, models/).
    if name in ("Database", "connect", "RecoveryInfo", "CheckpointInfo"):
        from turdb_tpu.database import api

        return getattr(api, name)
    raise AttributeError(f"module 'turdb_tpu' has no attribute {name!r}")
