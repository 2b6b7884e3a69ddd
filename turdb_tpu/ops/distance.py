"""Batched vector distance kernels.

Counterpart of reference src/hnsw/distance.rs (scalar + AVX2 + NEON
euclidean/cosine/inner-product with runtime CPU dispatch, :55-444). Here
every metric is expressed so the heavy term is a single matmul:

    L2²(q, x)  = ‖q‖² + ‖x‖² − 2·q·xᵀ
    cos(q, x)  = 1 − q̂·x̂ᵀ          (unit-normalized operands)
    ip(q, x)   = −q·xᵀ               (negated dot, matching distance.rs:93-97)

All metrics are "smaller is closer", as in the reference (DistanceFn
contract, distance.rs:361). Squared L2 is used for ordering — identical
ranking to true L2 and what the reference's graph code uses
(hnsw/mod.rs:1031,1118 hardcode euclidean_squared).
"""

from __future__ import annotations

import enum
from functools import partial

import jax
import jax.numpy as jnp


# Fine-grained distance matmuls MUST run at full f32 precision: at DEFAULT
# precision a GPU may run f32 matmuls in TF32 (10-bit mantissa; on other
# accelerators bf16 passes), and preferred_element_type only picks the
# accumulator. The resulting ~1e-3-of-magnitude error in q·x swamps
# near-neighbor distance gaps in the expanded L2 form and caps recall.
# These kernels are memory-bound, so full f32 costs little; coarse
# rankings (k-means assignment, centroid top-nprobe) keep the default.
PRECISE = jax.lax.Precision.HIGHEST


class Metric(enum.Enum):
    """Distance metric, matching reference hnsw DistanceFunction ids
    (reference src/hnsw/storage.rs header field `distance_fn`)."""

    L2 = 0          # squared euclidean
    COSINE = 1
    IP = 2          # inner product (negated dot)

    @classmethod
    def from_name(cls, name: str) -> "Metric":
        return {
            "l2": cls.L2,
            "euclidean": cls.L2,
            "cosine": cls.COSINE,
            "ip": cls.IP,
            "dot": cls.IP,
            "inner_product": cls.IP,
        }[name.lower()]


@jax.jit
def prep_norms(x: jax.Array) -> jax.Array:
    """Precomputed ‖x‖² per row — amortizes the L2 expansion's static
    term. Jitted: called eagerly between build stages, where each bare
    op would be a separate compile."""
    return jnp.sum(x.astype(jnp.float32) * x.astype(jnp.float32), axis=-1)


def normalize_rows(x: jax.Array, eps: float = 1e-30) -> jax.Array:
    n = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
    return x / jnp.maximum(n, eps)


def pairwise_distances(
    q: jax.Array,
    x: jax.Array,
    metric: Metric = Metric.L2,
    x_norms: jax.Array | None = None,
    q_norms: jax.Array | None = None,
) -> jax.Array:
    """[B, d] x [N, d] -> [B, N] distance matrix. The q @ x.T term is the
    matmul workhorse; everything else fuses into it as an epilogue."""
    q = q.astype(jnp.float32)
    dots = jax.lax.dot_general(
        q,
        x,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=PRECISE,
    )
    if metric is Metric.L2:
        qn = prep_norms(q) if q_norms is None else q_norms
        xn = prep_norms(x) if x_norms is None else x_norms
        d = qn[:, None] + xn[None, :] - 2.0 * dots
        return jnp.maximum(d, 0.0)
    if metric is Metric.COSINE:
        # callers pass unit-normalized x (and q) for the fast path; guard
        # against non-normalized input with explicit norms if provided
        return 1.0 - dots
    if metric is Metric.IP:
        return -dots
    raise ValueError(f"unknown metric {metric}")


def gathered_distances(
    q: jax.Array,
    vecs: jax.Array,
    metric: Metric = Metric.L2,
    vec_norms: jax.Array | None = None,
    q_norms: jax.Array | None = None,
) -> jax.Array:
    """Per-query gathered candidate distances: q [B, d], vecs [B, K, d]
    -> [B, K].

    This is the beam-search hot path (the reference's per-neighbor callback
    distance, hnsw/mod.rs:1097): a batched matvec rather than a
    pointer-chase + scalar SIMD loop.
    """
    q = q.astype(jnp.float32)
    vecs = vecs.astype(jnp.float32)
    dots = jnp.einsum(
        "bd,bkd->bk", q, vecs,
        preferred_element_type=jnp.float32, precision=PRECISE,
    )
    if metric is Metric.L2:
        qn = prep_norms(q) if q_norms is None else q_norms
        vn = jnp.sum(vecs * vecs, axis=-1) if vec_norms is None else vec_norms
        return jnp.maximum(qn[:, None] + vn - 2.0 * dots, 0.0)
    if metric is Metric.COSINE:
        return 1.0 - dots
    if metric is Metric.IP:
        return -dots
    raise ValueError(f"unknown metric {metric}")


@partial(jax.jit, static_argnames=("metric",))
def self_distances(x: jax.Array, metric: Metric = Metric.L2) -> jax.Array:
    """All-pairs [N, N] distances (used by the build's diversity pruning)."""
    return pairwise_distances(x, x, metric)
