"""SQ8 scalar quantization (4x compression) for the vector store.

Counterpart of reference src/hnsw/quantization.rs: per-vector min +
scale=(max-min)/255 with a u8 payload (:7-33), encode/decode (:89-147),
and distance over quantized codes. The u8 codes halve-again memory
traffic vs bf16 and feed a matmul after a cheap fused dequant; the
asymmetric path (f32 query vs SQ8 store) is the accuracy-preserving
default, mirroring the reference's SQ8 asymmetric kernel (:44-53).

    x ≈ min + scale * u,   u ∈ [0, 255]
    ‖q − x‖² = Σ (q_d − min − scale·u_d)²
             = ‖q−min‖² − 2·scale·(q−min)·u + scale²·‖u‖²
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from turdb_tpu.ops.topk import topk_smallest


def sq8_encode(x: jax.Array):
    """[N, d] f32 -> (codes u8 [N, d], mins [N], scales [N])."""
    x = x.astype(jnp.float32)
    mins = jnp.min(x, axis=-1)
    maxs = jnp.max(x, axis=-1)
    scales = (maxs - mins) / 255.0
    safe = jnp.where(scales == 0, 1.0, scales)
    codes = jnp.clip(
        jnp.round((x - mins[:, None]) / safe[:, None]), 0, 255
    ).astype(jnp.uint8)
    return codes, mins, scales


def sq8_decode(codes: jax.Array, mins: jax.Array, scales: jax.Array):
    return mins[:, None] + scales[:, None] * codes.astype(jnp.float32)


def int8_dot(qc: jax.Array, codes: jax.Array) -> jax.Array:
    """Per-query int8 inner products: qc [B, d] int8 against codes
    [B, ..., d] int8 -> [B, ...] int32. Operands stay s8 and the sum
    accumulates in s32, so the result is exact (|sum| <= d * 128 * 127
    fits int32 for any d below 132k). The IVF sq8 probe and the HNSW
    serving beam both score their gathered code blocks through it."""
    return jnp.einsum(
        "bd,b...d->b...", qc, codes, preferred_element_type=jnp.int32
    )


@partial(jax.jit, static_argnames=("k",))
def sq8_search(
    queries: jax.Array,   # [B, d] f32
    codes: jax.Array,     # [N, d] u8
    mins: jax.Array,      # [N]
    scales: jax.Array,    # [N]
    valid: jax.Array,     # [N] bool
    k: int,
):
    """Asymmetric L2² k-NN over the quantized store. The u8·f32 term is
    one matmul; the code-norm term Σu² is precomputable but cheap
    enough to fuse here. Returns ([B,k] dists asc, [B,k] ids)."""
    q = queries.astype(jnp.float32)
    u = codes.astype(jnp.float32)
    # d(q, x)² = ‖q‖² - 2 q·(min + s·u) + ‖min + s·u‖²
    qn = jnp.sum(q * q, axis=-1)                       # [B]
    q_dot_u = jax.lax.dot_general(
        q, u, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )                                                  # [B, N]
    q_sum = jnp.sum(q, axis=-1)                        # [B]
    u_sum = jnp.sum(u, axis=-1)                        # [N]
    u_sq = jnp.sum(u * u, axis=-1)                     # [N]
    d = q.shape[1]
    xn = (
        d * mins**2
        + 2.0 * mins * scales * u_sum
        + scales**2 * u_sq
    )                                                  # [N] = ‖x̂‖²
    q_dot_x = mins[None, :] * q_sum[:, None] + scales[None, :] * q_dot_u
    dist = qn[:, None] - 2.0 * q_dot_x + xn[None, :]
    dist = jnp.where(valid[None, :], jnp.maximum(dist, 0.0), jnp.inf)
    ids = jnp.broadcast_to(
        jnp.arange(dist.shape[1], dtype=jnp.int32)[None, :], dist.shape
    )
    return topk_smallest(dist, ids, k)
