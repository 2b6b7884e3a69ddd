"""Flat (exact) k-NN over a columnar vector store.

This is the engine behind the SQL `ORDER BY vec <-> q LIMIT k` path — the
path the reference actually executes for SQL k-NN (table scan + per-row
distance + TopKExec; reference src/sql/predicate.rs:1074-1076,
src/sql/planner/physical.rs:229) — and the ground-truth oracle for HNSW
recall tests (replacing the reference's live-Qdrant harness,
tests/hnsw_qdrant_comparison.rs).

Design: one [B, d] x [d, N] matmul per chunk of the store, fused with
the L2 epilogue, then a running masked top-k merge over chunks via
lax.scan. Static shapes throughout; N is padded to the chunk size with
+inf sentinel rows.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from turdb_tpu.ops.distance import Metric, pairwise_distances, prep_norms
from turdb_tpu.ops.topk import merge_topk, topk_smallest

INVALID_ID = -1


@partial(jax.jit, static_argnames=("k", "metric", "chunk"))
def flat_search(
    queries: jax.Array,      # [B, d]
    vectors: jax.Array,      # [N, d] (N padded to multiple of chunk)
    norms: jax.Array,        # [N] precomputed ‖x‖² (inf for padding rows)
    valid: jax.Array,        # [N] bool — False for padding/deleted rows
    k: int,
    metric: Metric = Metric.L2,
    chunk: int = 131072,
):
    """Exact k-NN. Returns ([B, k] dists ascending, [B, k] ids)."""
    n = vectors.shape[0]
    chunk = min(chunk, n)
    assert n % chunk == 0, "store must be padded to a chunk multiple"
    b = queries.shape[0]
    qn = prep_norms(queries)

    vecs_c = vectors.reshape(n // chunk, chunk, vectors.shape[1])
    norms_c = norms.reshape(n // chunk, chunk)
    valid_c = valid.reshape(n // chunk, chunk)
    base_ids = jnp.arange(chunk, dtype=jnp.int32)

    init = (
        jnp.full((b, k), jnp.inf, jnp.float32),
        jnp.full((b, k), INVALID_ID, jnp.int32),
    )

    def step(carry, inp):
        best_d, best_i = carry
        cvecs, cnorms, cvalid, cidx = inp
        d = pairwise_distances(queries, cvecs, metric, x_norms=cnorms, q_norms=qn)
        d = jnp.where(cvalid[None, :], d, jnp.inf)
        cd, ci = topk_smallest(d, jnp.broadcast_to(base_ids + cidx * chunk, d.shape), k)
        return merge_topk(best_d, best_i, cd, ci, k), None

    (best_d, best_i), _ = jax.lax.scan(
        step,
        init,
        (vecs_c, norms_c, valid_c, jnp.arange(n // chunk, dtype=jnp.int32)),
    )
    best_i = jnp.where(jnp.isinf(best_d), INVALID_ID, best_i)
    return best_d, best_i


class FlatIndex:
    """Host-side handle over a device-resident padded vector store.

    Append-only with tombstone deletes — the columnar replacement for the
    reference's slotted-page vector rows. Capacity grows by doubling, so
    jit caches stay warm across size classes.
    """

    def __init__(self, dim: int, metric: Metric = Metric.L2, capacity: int = 4096):
        self.dim = dim
        self.metric = metric
        self.capacity = _round_pow2(max(capacity, 1024))
        self.size = 0
        self._vectors = jnp.zeros((self.capacity, dim), jnp.float32)
        self._norms = jnp.full((self.capacity,), jnp.inf, jnp.float32)
        self._valid = jnp.zeros((self.capacity,), bool)

    def __len__(self):
        return self.size

    def add(self, vecs: np.ndarray) -> np.ndarray:
        """Append rows; returns their slot ids."""
        vecs = np.asarray(vecs, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        n = vecs.shape[0]
        self._ensure(self.size + n)
        sl = jnp.arange(self.size, self.size + n)
        v = jnp.asarray(vecs)
        if self.metric is Metric.COSINE:
            from turdb_tpu.ops.distance import normalize_rows

            v = normalize_rows(v)
        self._vectors = self._vectors.at[sl].set(v)
        self._norms = self._norms.at[sl].set(prep_norms(v))
        self._valid = self._valid.at[sl].set(True)
        ids = np.arange(self.size, self.size + n)
        self.size += n
        return ids

    def delete(self, slot_ids) -> None:
        self._valid = self._valid.at[jnp.asarray(slot_ids)].set(False)

    def search(self, queries: np.ndarray, k: int, valid_mask=None):
        """Returns (dists [B, k], slot_ids [B, k]) as numpy arrays."""
        q = jnp.asarray(np.atleast_2d(np.asarray(queries, np.float32)))
        if self.metric is Metric.COSINE:
            from turdb_tpu.ops.distance import normalize_rows

            q = normalize_rows(q)
        valid = self._valid
        if valid_mask is not None:
            m = jnp.zeros((self.capacity,), bool).at[: len(valid_mask)].set(
                jnp.asarray(valid_mask)
            )
            valid = valid & m
        chunk = min(131072, self.capacity)
        d, i = flat_search(
            q, self._vectors, self._norms, valid, k, self.metric, chunk
        )
        return np.asarray(d), np.asarray(i)

    def get(self, slot_ids) -> np.ndarray:
        return np.asarray(self._vectors[jnp.asarray(slot_ids)])

    def _ensure(self, need: int):
        if need <= self.capacity:
            return
        new_cap = _round_pow2(need)
        self._vectors = _grow(self._vectors, new_cap)
        self._norms = _grow(self._norms, new_cap, fill=jnp.inf)
        self._valid = _grow(self._valid, new_cap)
        self.capacity = new_cap


def _round_pow2(n: int) -> int:
    p = 1024
    while p < n:
        p *= 2
    return p


def _grow(arr: jax.Array, cap: int, fill=0):
    pad = cap - arr.shape[0]
    extra = jnp.full((pad,) + arr.shape[1:], fill, arr.dtype)
    return jnp.concatenate([arr, extra], axis=0)
