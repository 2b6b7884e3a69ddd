"""HNSW serving layout: packed-neighbor-block int8 beam + exact rerank.

The plain graph beam gathers expand*deg scattered rows per step, a
latency-bound pattern in which narrower rows (u8 instead of f32) save
little. Gathering contiguous [M0, d] int8 blocks, one per expanded node,
moves the same candidates in far fewer, larger reads, and every
additional gather op adds a fixed cost to each step, so the per-neighbor
metadata rides in ONE fused array.

This module restructures the SEARCH-TIME memory layout so the beam
issues exactly TWO gathers per step (reference search.rs:311-350 is the
behavioral contract; the layout is ours):

  1. **Packed neighbor blocks**: for every node, the int8 (SQ8,
     centered) codes of its M0 neighbors are stored CONTIGUOUSLY as one
     [M0, d] block (`nbr_codes[cap, M0, d]`). One beam step gathers
     B*expand 4KB blocks instead of B*expand*deg scattered rows — 32x
     fewer gathers, each contiguous — and feeds one exact int8 product
     (`ops.quantize.int8_dot`).
     This is the CAGRA-style trade: 32x adjacency-side memory (int8
     makes it 8x vs an f32 store) for block-contiguity.
  2. **Fused neighbor metadata**: `nbr_meta[cap, M0, 4]` int32 packs
     (bitcast f32 dequant base/scale, bitcast f32 exact ‖x‖², raw int32
     neighbor id) so adjacency + dequant params + norms arrive in one
     gather (one array, one gather op); the floats ride as bit patterns
     of the int32 array.
  3. **Coarse-quantizer seeding**: the upper HNSW levels exist to find a
     good level-0 entry; a k-means centroid table does that job in ONE
     [B,d]x[d,C] matmul + a medoid lookup. The graph's upper levels
     remain in the build/DML path (models/hnsw.py); serving replaces
     the descent (mod.rs:1134-1145) with top-`nseed` cell medoids as
     beam seeds.
  4. **Exact rerank**: beam distances carry SQ8 quantization error (the
     round-2 finding: SQ8 serving recall dropped to 0.77 because graphs
     had no rerank stage). The final candidate buffer is re-scored
     against the exact f32 rows (the IVF engine's proven two-stage
     pattern, models/ivf.py) before top-k.

The serving state is DERIVED from a built HnswIndex (`pack_serving`):
graph mutation stays in models/hnsw.py; serving packs are rebuildable at
checkpoint/finalize time, the same separation the reference draws
between its insert path and its reusable search context (search.rs:193).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from turdb_tpu.ops.distance import PRECISE, Metric, prep_norms
from turdb_tpu.ops.quantize import int8_dot
from turdb_tpu.ops.topk import (
    mask_duplicates,
    member_mask,
    merge_topk,
    topk_smallest,
    topk_smallest_wide,
)

# plain Python scalars: jnp scalars at module scope would initialize the
# device backend at import time, and a backend reserves most of the
# card's memory; weak typing anchors them to the surrounding dtype inside
# traced code
NIL = -1
INF = float("inf")


class HnswServeState(NamedTuple):
    """Device-resident serving pack (a pytree)."""

    nbr_codes: jax.Array   # [cap, M0, d] int8 centered codes of neighbors
    nbr_meta: jax.Array    # [cap, M0, 4] int32: bitcast f32 (base, scale,
                           #   ‖x‖²) + raw id — one array, so the beam
                           #   fetches all of it with one gather
    centroids: jax.Array   # [C, d] f32
    cnorms: jax.Array      # [C] f32 (+inf for pad cells)
    cell_codes: jax.Array  # [C, L, d] int8 member codes, cell-packed
    cell_meta: jax.Array   # [C, L, 4] int32 (same encoding as nbr_meta)
    vectors: jax.Array     # [cap, d] f32 rerank store
    norms: jax.Array       # [cap] f32


def _meta_fields(meta):
    """Unpack a gathered int32 meta block: (base, scale, norm) f32 + ids
    int32. Floats ride as bit patterns inside the int32 array, so ids and
    dequant parameters arrive together from one gather."""
    base = jax.lax.bitcast_convert_type(meta[..., 0], jnp.float32)
    scale = jax.lax.bitcast_convert_type(meta[..., 1], jnp.float32)
    norm = jax.lax.bitcast_convert_type(meta[..., 2], jnp.float32)
    return base, scale, norm, meta[..., 3]


def _pack_meta(base, scale, norm, ids):
    return jnp.stack(
        [
            jax.lax.bitcast_convert_type(base, jnp.int32),
            jax.lax.bitcast_convert_type(scale, jnp.int32),
            jax.lax.bitcast_convert_type(norm, jnp.int32),
            ids,
        ],
        axis=-1,
    )


def _quant_query(q: jax.Array):
    """Symmetric per-row int8 query quantization (the IVF probe's scheme,
    models/ivf.py): q ≈ qs * qc with qc int8."""
    qmax = jnp.max(jnp.abs(q), axis=-1)
    qs = jnp.maximum(qmax, 1e-30) / 127.0
    qc = jnp.clip(jnp.round(q / qs[:, None]), -127, 127).astype(jnp.int8)
    return qc, qs


def _approx_dist(doti, base, scale, qn, qsum, qs, nnorm, metric: Metric):
    """Distance from int8 inner products: x̂ = base + scale*c, so
    q·x̂ = base*Σq + scale*qs*(qc·c). L2 uses the EXACT stored ‖x‖², so
    only the cross term carries quantization error."""
    q_dot_x = base * qsum + scale * (qs * doti.astype(jnp.float32))
    if metric is Metric.L2:
        return qn - 2.0 * q_dot_x + nnorm
    if metric is Metric.COSINE:
        return 1.0 - q_dot_x
    return -q_dot_x


@partial(
    jax.jit,
    static_argnames=(
        "metric", "k", "ef", "iters", "expand", "nprobe", "nseed", "rerank",
    ),
)
def serve_search_impl(
    state: HnswServeState,
    queries: jax.Array,
    allowed: jax.Array | None,
    *,
    metric: Metric,
    k: int,
    ef: int,
    iters: int,
    expand: int = 4,
    nprobe: int = 2,
    nseed: int = 32,
    rerank: int = 0,
):
    """Two-stage batched k-NN over the serving pack.

    Stage 1a (seeding): centroid matmul -> probe the `nprobe` nearest
    cells' packed member blocks (contiguous reads, the IVF
    access pattern) -> top-`nseed` rows seed the beam. This replaces the
    graph's upper-level descent: cell MEDOID seeding was measured to
    strand ~12% of queries (the medoid can sit far uphill of the query
    with every bulk-graph edge pointing away); probing the cell interior
    seeds the beam INSIDE the query's true neighborhood.
    Stage 1b (beam): fixed-shape beam over packed int8 neighbor blocks
    (reference beam semantics, search.rs:311-350, with the termination
    bound as a per-query done mask) — this is what recovers the
    cross-cell-boundary neighbors a pure nprobe=2 probe misses.
    Stage 2: exact f32 rerank of the top-`rerank` beam candidates
    (default ef), visibility mask applied at rerank (stepping-stone
    doctrine, mod.rs:62-68: traversal unrestricted, results masked).
    Returns ([B,k] exact dists asc, [B,k] slot ids, NIL-padded).
    """
    q = queries.astype(jnp.float32)
    b = q.shape[0]
    qn = prep_norms(q)
    qsum = jnp.sum(q, axis=-1)
    qc, qs = _quant_query(q)
    deg = state.nbr_codes.shape[1]
    loops = -(-iters // expand)
    exp_cap = loops * expand

    # ---- stage 1a: cell-probe seeding -----------------------------------
    d2c = qn[:, None] + state.cnorms[None, :] - 2.0 * jax.lax.dot_general(
        q, state.centroids, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    p = min(nprobe, state.centroids.shape[0])
    if d2c.shape[-1] > 1024:
        # two-level exact selection (ops/topk.py): faster than a
        # full-row lax.top_k at large C (PERF.md, "top-k")
        _, top = topk_smallest_wide(d2c, p)
    else:
        _, top = jax.lax.top_k(-d2c, p)                # [B, P]
    cb, cs, cn_, pids = _meta_fields(state.cell_meta[top])  # [B, P, L]
    doti = int8_dot(qc, state.cell_codes[top])          # [B, P, L]
    pd = _approx_dist(
        doti, cb, cs,
        qn[:, None, None], qsum[:, None, None], qs[:, None, None],
        cn_, metric,
    ).reshape(b, -1)
    pids = pids.reshape(b, -1)
    pd = jnp.where(pids >= 0, pd, INF)
    s = min(nseed, ef, pd.shape[-1])
    seed_d, seed_i = topk_smallest(pd, pids, s)
    seed_i = jnp.where(jnp.isinf(seed_d), NIL, seed_i)

    cand_i = jnp.full((b, ef), NIL, jnp.int32).at[:, :s].set(seed_i)
    cand_d = jnp.full((b, ef), INF, jnp.float32).at[:, :s].set(seed_d)
    exp_ids = jnp.full((b, exp_cap), NIL, jnp.int32)

    def cond(c):
        it, _, _, _, done = c
        return jnp.logical_and(it < loops, jnp.logical_not(jnp.all(done)))

    def body(c):
        it, cand_i, cand_d, exp_ids, done = c
        is_exp = member_mask(cand_i, exp_ids)
        avail = jnp.where(is_exp | (cand_i < 0), INF, cand_d)
        sel_d, sel_pos = topk_smallest(
            avail,
            jnp.broadcast_to(jnp.arange(ef, dtype=jnp.int32)[None, :], (b, ef)),
            expand,
        )
        sel_i = jnp.take_along_axis(cand_i, sel_pos, axis=-1)   # [B, E]
        worst = jnp.max(cand_d, axis=-1)
        newly_done = jnp.isinf(sel_d[:, 0]) | (sel_d[:, 0] > worst)
        done = done | newly_done
        live = jnp.logical_not(done)
        exp_ok = live[:, None] & jnp.logical_not(jnp.isinf(sel_d)) & (
            sel_d <= worst[:, None]
        )
        sel_i = jnp.where(exp_ok, sel_i, NIL)
        safe_sel = jnp.clip(sel_i, 0)

        # TWO gathers: codes block + fused meta block
        mb, ms, mn, nbrs = _meta_fields(state.nbr_meta[safe_sel])
        nbrs = nbrs.reshape(b, -1)                      # [B, E*deg]
        doti = int8_dot(qc, state.nbr_codes[safe_sel])   # [B, E, deg]
        nd = _approx_dist(
            doti, mb, ms,
            qn[:, None, None], qsum[:, None, None], qs[:, None, None],
            mn, metric,
        ).reshape(b, -1)

        ok = (nbrs >= 0) & jnp.repeat(exp_ok, deg, axis=-1)
        dup = member_mask(nbrs, cand_i) | member_mask(nbrs, exp_ids)
        ok = ok & jnp.logical_not(dup)
        nbrs_m = jnp.where(ok, nbrs, NIL)
        nbrs_m, _ = mask_duplicates(nbrs_m, jnp.zeros_like(nd))
        ok = ok & (nbrs_m >= 0)
        nd = jnp.where(ok, nd, INF)

        cand_d2, cand_i2 = merge_topk(cand_d, cand_i, nd, nbrs_m, ef)
        exp_ids = jax.lax.dynamic_update_slice_in_dim(
            exp_ids, sel_i, it * expand, axis=1
        )
        keep = live[:, None]
        return (
            it + 1,
            jnp.where(keep, cand_i2, cand_i),
            jnp.where(keep, cand_d2, cand_d),
            exp_ids,
            done,
        )

    init_done = (seed_i < 0).all(-1)
    _, cand_i, cand_d, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), cand_i, cand_d, exp_ids, init_done)
    )

    # ---- stage 2: exact rerank ------------------------------------------
    r = min(rerank or ef, ef)
    if r < ef:
        cand_d, cand_i = topk_smallest(cand_d, cand_i, r)
    safe = jnp.clip(cand_i, 0)
    vr = state.vectors[safe]                               # [B, R, d]
    dots = jnp.einsum(
        "bd,brd->br", q, vr,
        preferred_element_type=jnp.float32, precision=PRECISE,
    )
    if metric is Metric.L2:
        exact = qn[:, None] + state.norms[safe] - 2.0 * dots
    elif metric is Metric.COSINE:
        exact = 1.0 - dots
    else:
        exact = -dots
    bad = cand_i < 0
    if allowed is not None:
        bad = bad | jnp.logical_not(allowed[safe])
    exact = jnp.where(bad, INF, exact)
    d_out, i_out = topk_smallest(exact, cand_i, k)
    return d_out, jnp.where(jnp.isinf(d_out), NIL, i_out)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

@jax.jit
def _sq8_centered(x: jax.Array):
    """Per-row centered-int8 encode: x ≈ base + scale*c, c ∈ [-128, 127]
    (the IVF probe-code scheme: base = min + 128*scale). Jitted: one
    compile instead of ~8 eager-op compiles."""
    mins = jnp.min(x, axis=-1)
    maxs = jnp.max(x, axis=-1)
    scales = (maxs - mins) / 255.0
    safe = jnp.where(scales == 0, 1.0, scales)
    codes = (
        jnp.clip(jnp.round((x - mins[:, None]) / safe[:, None]), 0, 255)
        .astype(jnp.int16) - 128
    ).astype(jnp.int8)
    return codes, mins + 128.0 * scales, scales


@partial(jax.jit, static_argnames=("c",))
def _train_init(vectors, tr, seeds, c: int):
    """k-means training rows + zero-padded seed centroids, fused."""
    xt_raw = vectors[tr]
    init = xt_raw[seeds]
    pad = c - seeds.shape[0]
    if pad > 0:
        init = jnp.concatenate(
            [init, jnp.zeros((pad, vectors.shape[1]), jnp.float32)]
        )
    return xt_raw, init


@partial(jax.jit, static_argnames=("npad",))
def _live_rows(vectors, size, npad: int):
    """[npad, d] live rows (INF padding) — fused so the cold pack pays
    ONE compile for the arange/where/gather chain."""
    cap = vectors.shape[0]
    rows_all = jnp.arange(npad, dtype=jnp.int32)
    rows_all = jnp.where(rows_all < size, rows_all, cap - 1)
    live = (jnp.arange(npad) < size)[:, None]
    return jnp.where(live, vectors[rows_all], INF)


@jax.jit
def _pack_cells(codes, base, scale, norms, mem):
    """Gather the seeding cells' packed member codes + metadata (fused:
    one compile for the clip/where/gather/meta chain)."""
    msafe = jnp.clip(mem, 0)
    mok = mem >= 0
    cell_codes = jnp.where(mok[..., None], codes[msafe], 0)
    cell_meta = _pack_meta(
        jnp.where(mok, base[msafe], 0.0),
        jnp.where(mok, scale[msafe], 0.0),
        jnp.where(mok, norms[msafe], INF),
        mem,
    )
    return cell_codes, cell_meta


@partial(jax.jit, donate_argnums=(0, 1), static_argnames=("chunk",))
def _pack_block_chunk(nbr_codes, nbr_meta, s, e, adj0, codes, base,
                      scale, norms, chunk: int):
    """Scatter one chunk of packed neighbor blocks (donated accumulators:
    eager .at[].set would copy the multi-GB arrays per chunk). The chunk
    row window derives from (s, e) device scalars so every chunk shares
    ONE compile."""
    cap = nbr_codes.shape[0]
    rows = s + jnp.arange(chunk, dtype=jnp.int32)
    rows = jnp.where(rows < e, rows, cap - 1)
    adj_rows = adj0[rows]
    safe = jnp.clip(adj_rows, 0)
    ok = adj_rows >= 0
    nbr_codes = nbr_codes.at[rows].set(codes[safe])
    meta = _pack_meta(
        jnp.where(ok, base[safe], 0.0),
        jnp.where(ok, scale[safe], 0.0),
        jnp.where(ok, norms[safe], INF),
        adj_rows,
    )
    nbr_meta = nbr_meta.at[rows].set(meta)
    return nbr_codes, nbr_meta


def pack_serving(
    vectors: jax.Array,       # [cap, d] f32 (device)
    norms: jax.Array,         # [cap] f32 (INF for empty slots)
    adj0: jax.Array,          # [cap, M0] int32
    size: int,
    metric: Metric,
    n_centroids: int | None = None,
    chunk: int = 1 << 16,
    lane_cap: int | None = None,
    pack_m: int | None = None,
) -> HnswServeState:
    """Build the serving pack from a built graph's L0 + vector store.

    Memory (1M x 128d, M0=32): nbr_codes 4.1GB + nbr_meta 512MB +
    rerank f32 512MB — ~5.2GB of device memory, vs 0.64GB for the
    unpacked graph. The pack trades memory for block-contiguity; past a
    card's memory use the mesh (parallel/sharded.py) or the unpacked path.

    `pack_m` (round-4 verdict item #7, the memory knob): pack only each
    node's first `pack_m` L0 neighbors. Adjacency lists are emitted
    diversity-selected-first in ascending distance (hnsw.py
    _diversity_select), so truncation keeps the neighbors the reference
    heuristic ranked best; the beam re-reaches dropped neighbors through
    the remaining edges at slightly higher ef. pack_m=16 halves
    nbr_codes/nbr_meta (5.2GB -> 2.8GB at 1M x 128d), so one card packs
    about twice as many vectors.
    """
    from turdb_tpu.models.ivf import _assign_all, _kmeans, _pad_rows_dev, _KM_CHUNK

    cap, d = vectors.shape
    if pack_m is not None and pack_m < adj0.shape[-1]:
        adj0 = adj0[:, :pack_m]
    m0 = adj0.shape[-1]
    codes, base, scale = _sq8_centered(vectors)

    nbr_codes = jnp.zeros((cap, m0, d), jnp.int8)
    nbr_meta = jnp.full((cap, m0, 4), -1, jnp.int32)
    for s in range(0, size, chunk):
        e = min(size, s + chunk)
        nbr_codes, nbr_meta = _pack_block_chunk(
            nbr_codes, nbr_meta, s, e, adj0, codes, base, scale, norms,
            chunk=chunk,
        )

    # ---- coarse quantizer (seeding) -------------------------------------
    c = n_centroids or max(64, min(8192, size // 256))
    c = _pow2_at_least(min(c, max(1, size)), floor=64)
    rng = np.random.default_rng(0)
    n_train = min(size, max(c * 32, 65_536))
    tr = rng.choice(size, size=n_train, replace=False)
    seeds0 = rng.choice(n_train, size=min(c, n_train), replace=False)
    xt_raw, init = _train_init(
        vectors, jnp.asarray(tr.astype(np.int32)),
        jnp.asarray(seeds0.astype(np.int32)), c=c,
    )
    xt = _pad_rows_dev(xt_raw, _KM_CHUNK)
    cents = _kmeans(xt, init, iters=6)
    # assignment over all live rows -> per-cell medoid (nearest row)
    npad = -(-size // _KM_CHUNK) * _KM_CHUNK
    xall = _live_rows(vectors, size, npad=npad)
    assign_j = _assign_all(xall, cents)
    assign = np.asarray(assign_j)[:size]
    cn = np.asarray(prep_norms(cents))
    # balanced cell packing (the IVF layout): lane = rank within the
    # cell's sorted run; rows past the lane cap are dropped — seeding has
    # no completeness requirement (the beam recovers them via the graph)
    counts = np.bincount(assign, minlength=c)
    # lane_cap override: mesh callers pin one cap across shards whose
    # sizes differ by +-1 so the per-shard packs stack into one pytree
    lcap = lane_cap or _pow2_at_least(max(int(2 * size / max(c, 1)), 8), floor=8)
    members = np.full((c, lcap), -1, np.int64)
    order = np.argsort(assign, kind="stable")
    sa = assign[order]
    first = np.zeros(size, bool)
    if size:
        first[0] = True
        first[1:] = sa[1:] != sa[:-1]
    run_start = np.flatnonzero(first)
    start_of = np.zeros(c, np.int64)
    start_of[sa[run_start]] = run_start
    lane = np.arange(size) - start_of[sa]
    ok = lane < lcap
    members[sa[ok], lane[ok]] = order[ok]
    nonempty = counts > 0
    cnorms = jnp.asarray(np.where(nonempty, cn, np.inf).astype(np.float32))
    mem = jnp.asarray(members.astype(np.int32))
    cell_codes, cell_meta = _pack_cells(codes, base, scale, norms, mem)
    return HnswServeState(
        nbr_codes=nbr_codes,
        nbr_meta=nbr_meta,
        centroids=cents,
        cnorms=cnorms,
        cell_codes=cell_codes,
        cell_meta=cell_meta,
        vectors=vectors,
        norms=norms,
    )


def _pow2_at_least(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p
