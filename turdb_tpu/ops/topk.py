"""Masked top-k primitives (smallest-distance selection).

Replaces the reference's binary heaps (reference src/hnsw/search.rs:82-133
Candidate/ReverseCandidate BinaryHeap ordering) with fixed-width sorted
buffers: heaps are pointer-y and data-dependent; a top-k over a padded
candidate window is one fixed-shape selection the compiler maps onto the
device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# plain float: a jnp scalar here would initialize the device backend at
# import time (and a backend reserves most of the card's memory); jnp
# coerces it to f32 inside traced code where it's used
INF = float("inf")


def topk_smallest(dists: jax.Array, ids: jax.Array, k: int):
    """Select the k smallest distances (with ids) along the last axis.

    dists: [..., n] f32 (inf = invalid), ids: [..., n] int32.
    Returns ([..., k] dists, [..., k] ids), ascending.

    Wide rows (more than 2048 lanes, k at most 1/8 of them) route
    through the two-level exact selector, which beats lax.top_k on the
    GPU at every probe width measured (PERF.md, "top-k"); narrower rows
    keep the single lax.top_k.
    """
    n = dists.shape[-1]
    if n > 2048 and 8 * k <= n:
        vals, pos = topk_smallest_wide(dists, k)
        sel = jnp.take_along_axis(ids, pos, axis=-1)
        return vals, sel
    neg_d, idx = jax.lax.top_k(-dists, k)
    sel = jnp.take_along_axis(ids, idx, axis=-1)
    return -neg_d, sel


def topk_smallest_wide(dists: jax.Array, k: int, n_buckets: int | None = None):
    """EXACT k-smallest over a LARGE last axis, two-level.

    `lax.top_k` over a whole wide row is the costly part of the IVF cell
    probe: on an H100, at the 1M geometry's [1024, 24576] cell-scoring
    row with k=5, lax.top_k took 526 us and this selector 117 us (PERF.md,
    "top-k"). Two-level selection does one bucket-min pass + a top-k over
    bucket mins + a re-scan of only the winning buckets:

      level 1: reshape [..., n] -> [..., G, S], min over S (one pass);
      level 2: top-k over the G bucket mins -> k bucket ids; gather those
               buckets' S-slices; top-k over the [..., k*S] candidates.

    EXACT, not approximate: if the true k smallest entries occupy j <= k
    distinct buckets, each such bucket's min is <= its smallest member,
    so all j buckets rank within the k smallest bucket-mins and every
    true winner is in the re-scanned slices. (This differs from
    approx_max_k's bin partition, which keeps only ONE entry per bin.)

    Returns ([..., k] vals ascending, [..., k] int32 indices into the
    last axis). G defaults to the cost-balancing pow2 near sqrt(k*n).
    """
    n = dists.shape[-1]
    g = n_buckets or max(1, 1 << (int(k * n).bit_length() // 2))
    g = min(g, n)
    s = -(-n // g)
    if g * s != n:
        pad = jnp.full((*dists.shape[:-1], g * s - n), INF, dists.dtype)
        dists = jnp.concatenate([dists, pad], axis=-1)
    d3 = dists.reshape(*dists.shape[:-1], g, s)
    bmin = jnp.min(d3, axis=-1)                          # [..., G]
    _, bidx = jax.lax.top_k(-bmin, k)                    # [..., k]
    cand = jnp.take_along_axis(
        d3, bidx[..., None].astype(jnp.int32), axis=-2
    ).reshape(*dists.shape[:-1], k * s)                  # [..., k*S]
    neg, pos = jax.lax.top_k(-cand, k)
    which = pos // s                                     # index into bidx
    off = pos % s
    base = jnp.take_along_axis(bidx, which, axis=-1).astype(jnp.int32)
    return -neg, base * s + off.astype(jnp.int32)


def merge_topk(d_a, i_a, d_b, i_b, k: int):
    """Merge two top-k buffers into one, keeping the k smallest."""
    d = jnp.concatenate([d_a, d_b], axis=-1)
    i = jnp.concatenate([i_a, i_b], axis=-1)
    return topk_smallest(d, i, k)


def mask_duplicates(ids: jax.Array, dists: jax.Array, invalid_id: int = -1):
    """Within each row, keep the first occurrence of each id; set later
    duplicates' distances to +inf and ids to `invalid_id`.

    The fixed-shape replacement for the reference's VisitedSet dedup inside
    one merge window (search.rs:143-191): an O(n²) lane-parallel compare is
    cheaper than hashing at beam widths (n ≤ a few hundred).
    """
    n = ids.shape[-1]
    eq = ids[..., :, None] == ids[..., None, :]
    earlier = jnp.tril(jnp.ones((n, n), dtype=bool), k=-1)
    dup = jnp.any(eq & earlier, axis=-1)
    dup = dup | (ids == invalid_id)
    return (
        jnp.where(dup, invalid_id, ids),
        jnp.where(dup, INF, dists),
    )


def member_mask(ids: jax.Array, table: jax.Array, invalid_id: int = -1):
    """ids [..., n] vs table [..., m] -> bool [..., n]: True where ids[i]
    appears in table. invalid ids never match."""
    hit = jnp.any(ids[..., :, None] == table[..., None, :], axis=-1)
    return hit & (ids != invalid_id)
