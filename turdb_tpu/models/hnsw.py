"""HNSW: layered-graph ANN as batched, fixed-shape array programs.

Re-design of reference src/hnsw/ (mod.rs, search.rs, operations.rs,
distance.rs — ~3.4k LoC of pointer-chasing Rust) for batched
accelerator execution. The mapping (SURVEY.md §2.3, §3.4-3.5):

  reference                                   here
  ---------------------------------------------------------------------
  HnswNodeInline: 4 levels × {32,16,16,16}    adj0 int32[cap,32] +
    neighbor NodeIds (mod.rs:425-432)           3× adj_hi int32[cap,16]
  greedy descent loop (search.rs:259-309)     batched masked while_loop
  beam search w/ binary heaps + VisitedSet    fixed-width sorted candidate
    (search.rs:311-350,143-191)                 buffer + expanded-id list,
                                                merged by masked top-k
  per-neighbor distance callback              vector gather + batched dot
    (mod.rs:1097)                               (matmuls for build matrices)
  select_neighbors_heuristic                  vectorized masked scan over
    (operations.rs:181-233)                     pairwise distance matrix
  prune_neighbors keep-nearest                diversity re-select (the
    (operations.rs:235)                         keep-nearest rule shatters
                                                clustered graphs — see
                                                _prune_rows)
  level select floor(-ln(u)/ln(M)), u from    identical, splitmix64 hash
    row_id (operations.rs:76-83,                of row id
    database/dml/insert.rs:1219)
  deleted nodes as stepping stones,           `allowed` mask: traverse all,
    filtered from results (mod.rs:62-68)        mask results

Graph constants match the reference (mod.rs:125-127): MAX_LEVELS=4, M0=32,
M=16. Slots are dense int32 ids into the columnar store; -1 is the nil id
everywhere (adjacency padding, empty buffer entries).

Build is orchestrated as SMALL jitted stage programs (vector staging, one
per-level search+select program shared by all upper levels, forward scatter,
dense reverse update): XLA compile time grows superlinearly with program
size, and small stages let every upper level share one compiled program.
The fused variant (`build_wave_impl`) remains for shard_map'd mesh builds,
where it compiles once per mesh config.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from turdb_tpu import config as cfgmod
from turdb_tpu.ops.distance import (
    PRECISE,
    Metric,
    gathered_distances,
    normalize_rows,
    prep_norms,
)
from turdb_tpu.ops.topk import (
    mask_duplicates,
    member_mask,
    merge_topk,
    topk_smallest,
)

# plain Python scalars: jnp scalars at module scope would initialize the
# device backend at import time, and a backend reserves most of the
# card's memory; weak typing anchors them to the surrounding dtype inside
# traced code
NIL = -1
INF = float("inf")
GREEDY_CAP = 128  # descent step cap (reference caps at 1000, mod.rs:1139)


@dataclasses.dataclass(frozen=True)
class HnswConfig:
    """Static graph geometry — hashable so jitted fns key on it."""

    dim: int
    m0: int = cfgmod.HNSW_M0
    m: int = cfgmod.HNSW_M
    max_levels: int = cfgmod.HNSW_MAX_LEVELS
    metric: Metric = Metric.L2
    ef_construction: int = cfgmod.HNSW_DEFAULT_EF_CONSTRUCTION
    ef_search: int = cfgmod.HNSW_DEFAULT_EF_SEARCH

    @property
    def ml(self) -> float:
        return 1.0 / math.log(self.m)


class HnswState(NamedTuple):
    """Device-resident graph — a pytree, so it jits/shards/donates cleanly."""

    vectors: jax.Array   # [cap, d] f32 (unit-normalized when metric=COSINE)
    norms: jax.Array     # [cap] f32 ‖x‖²
    adj0: jax.Array      # [cap, M0] int32, NIL-padded
    adj_hi: tuple        # (max_levels-1) × [cap, M] int32, NIL-padded
    levels: jax.Array    # [cap] int32, -1 for empty slots
    entry: jax.Array     # scalar int32 (NIL when empty)
    max_level: jax.Array  # scalar int32 (-1 when empty)


@jax.tree_util.register_pytree_node_class
class Sq8Rows:
    """SQ8-in-HBM graph vector store (reference quantization.rs:7-33
    applied to the index, SURVEY §7 'SQ8-in-HBM + f32 rerank'): u8 codes
    plus per-row (min, scale), DEQUANTIZED ON GATHER. Ducks as the
    [cap, d] f32 vectors array inside every jitted search program —
    `rows[ids]` returns f32 — so the beam's scattered HBM reads move 4x
    fewer bytes and a 100M x 128d store takes 12.8GB of device memory
    instead of 51GB. Row norms stay EXACT f32 (computed before quantization, the
    same trick as IvfState.pnorms), so only the q·x cross term carries
    quantization error."""

    def __init__(self, codes, mins, scales):
        self.codes = codes      # [cap, d] uint8
        self.mins = mins        # [cap] f32
        self.scales = scales    # [cap] f32

    @property
    def shape(self):
        return self.codes.shape

    @property
    def dtype(self):
        return jnp.float32

    def __getitem__(self, ids):
        c = self.codes[ids]
        m = self.mins[ids]
        s = self.scales[ids]
        return m[..., None] + s[..., None] * c.astype(jnp.float32)

    def dense(self) -> jax.Array:
        return self[jnp.arange(self.codes.shape[0])]

    def tree_flatten(self):
        return (self.codes, self.mins, self.scales), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def init_state(cfg: HnswConfig, capacity: int) -> HnswState:
    return HnswState(
        vectors=jnp.zeros((capacity, cfg.dim), jnp.float32),
        norms=jnp.full((capacity,), INF, jnp.float32),
        adj0=jnp.full((capacity, cfg.m0), NIL, jnp.int32),
        adj_hi=tuple(
            jnp.full((capacity, cfg.m), NIL, jnp.int32)
            for _ in range(cfg.max_levels - 1)
        ),
        levels=jnp.full((capacity,), -1, jnp.int32),
        entry=jnp.asarray(-1, jnp.int32),
        max_level=jnp.asarray(-1, jnp.int32),
    )


# ---------------------------------------------------------------------------
# level selection — deterministic from row id
# ---------------------------------------------------------------------------

def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(
        0xFFFFFFFFFFFFFFFF
    )
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(
        0xFFFFFFFFFFFFFFFF
    )
    return x ^ (x >> np.uint64(31))


def select_levels(row_ids: np.ndarray, cfg: HnswConfig) -> np.ndarray:
    """floor(-ln(u)·ml) with u derived from a hash of the row id — same
    deterministic scheme as reference database/dml/insert.rs:1219 +
    operations.rs:76-83, capped to the graph's level range."""
    h = _splitmix64(np.asarray(row_ids, np.uint64))
    u = (h >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
    u = np.clip(u, 1e-18, 1.0 - 1e-18)
    lvl = np.floor(-np.log(u) * cfg.ml).astype(np.int32)
    return np.minimum(lvl, cfg.max_levels - 1)


# ---------------------------------------------------------------------------
# greedy descent (one level)
# ---------------------------------------------------------------------------

def _greedy_level(adj, vectors, norms, q, qn, cur_i, cur_d, metric):
    """Batched best-neighbor walk until no query improves.

    The reference's greedy_search_step loop (search.rs:259-309), with the
    per-query data-dependent exit replaced by a vectorized while_loop on
    "any query still moving"; converged queries are masked no-ops.
    """

    def cond(c):
        it, _, _, moved = c
        return jnp.logical_and(it < GREEDY_CAP, jnp.any(moved))

    def body(c):
        it, cur_i, cur_d, _ = c
        nbrs = adj[jnp.clip(cur_i, 0)]                       # [B, M]
        ok = nbrs >= 0
        safe = jnp.clip(nbrs, 0)
        nd = gathered_distances(
            q, vectors[safe], metric, vec_norms=norms[safe], q_norms=qn
        )
        nd = jnp.where(ok, nd, INF)
        j = jnp.argmin(nd, axis=-1)
        bd = jnp.take_along_axis(nd, j[:, None], axis=-1)[:, 0]
        bi = jnp.take_along_axis(nbrs, j[:, None], axis=-1)[:, 0]
        moved = bd < cur_d
        return (
            it + 1,
            jnp.where(moved, bi, cur_i),
            jnp.where(moved, bd, cur_d),
            moved,
        )

    _, cur_i, cur_d, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), cur_i, cur_d, jnp.ones(cur_i.shape, bool))
    )
    return cur_i, cur_d


# ---------------------------------------------------------------------------
# beam search (one level)
# ---------------------------------------------------------------------------

def _beam_level(
    adj,
    vectors,
    norms,
    q,
    qn,
    seed_i,
    seed_d,
    ef: int,
    iters: int,
    metric: Metric,
    active=None,
    allowed=None,
    k_res: int | None = None,
    expand: int = 4,
    return_expanded: bool = False,
):
    """Fixed-shape ef-beam search over one adjacency level.

    Replaces the reference's heap-driven beam (search.rs:311-350): the
    candidate min-heap and result max-heap collapse into ONE sorted buffer
    of width ef (`cand`), since top-of-results == worst of the buffer; the
    VisitedSet becomes an append-only list of expanded ids checked by
    lane-parallel compare (`member_mask`).

    Each loop step expands the `expand` best unexpanded candidates per
    query at once (multi-expansion beam): the sequential chain shrinks by
    ~expand× — the loop's step *latency* dominates, not its FLOPs — at
    equal total expansion budget (`iters`). The reference's termination
    bound (best candidate > worst result, search.rs:329-349) becomes the
    per-query `done` mask; the loop exits when all queries are done or the
    expansion budget is spent.

    With `allowed` (search_filtered semantics, mod.rs:1176-1273): all nodes
    are traversed as stepping stones, but only allowed nodes enter the
    separate result buffer (width k_res).
    """
    b = q.shape[0]
    deg = adj.shape[-1]
    filtered = allowed is not None
    if active is None:
        active = jnp.ones((b,), bool)
    loops = -(-iters // expand)
    exp_cap = loops * expand

    # seeds may be [B] (single) or [B, S] (multi-seed: the descent beam's
    # top candidates — crossing to the right basin is far likelier from S
    # diverse starts than from the single best, which the reference's
    # greedy hand-off forces, mod.rs:1134-1147)
    if seed_i.ndim == 1:
        seed_i = seed_i[:, None]
        seed_d = seed_d[:, None]
    s = min(seed_i.shape[1], ef)
    seed_i = jnp.where(active[:, None], seed_i[:, :s], NIL)
    seed_d = jnp.where(active[:, None], seed_d[:, :s], INF)
    cand_i = jnp.full((b, ef), NIL, jnp.int32).at[:, :s].set(seed_i)
    cand_d = jnp.full((b, ef), INF, jnp.float32).at[:, :s].set(seed_d)
    exp_ids = jnp.full((b, exp_cap), NIL, jnp.int32)
    if filtered:
        kr = k_res or ef
        sk = min(s, kr)
        seed_ok = allowed[jnp.clip(seed_i, 0)] & (seed_i >= 0)
        res_i = jnp.full((b, kr), NIL, jnp.int32).at[:, :sk].set(
            jnp.where(seed_ok, seed_i, NIL)[:, :sk]
        )
        res_d = jnp.full((b, kr), INF, jnp.float32).at[:, :sk].set(
            jnp.where(seed_ok, seed_d, INF)[:, :sk]
        )
    else:
        res_i = jnp.zeros((b, 0), jnp.int32)
        res_d = jnp.zeros((b, 0), jnp.float32)

    def cond(c):
        it, _, _, _, _, _, done = c
        return jnp.logical_and(it < loops, jnp.logical_not(jnp.all(done)))

    def body(c):
        it, cand_i, cand_d, exp_ids, res_i, res_d, done = c
        is_exp = member_mask(cand_i, exp_ids)
        avail = jnp.where(is_exp | (cand_i < 0), INF, cand_d)
        # top-`expand` unexpanded candidates per query
        sel_d, sel_pos = topk_smallest(
            avail,
            jnp.broadcast_to(
                jnp.arange(ef, dtype=jnp.int32)[None, :], (b, ef)
            ),
            expand,
        )
        sel_i = jnp.take_along_axis(cand_i, sel_pos, axis=-1)   # [B, E]
        # bound: query finished when even its best unexpanded candidate is
        # worse than the worst buffered distance (buffer full ⇒ finite max)
        worst = jnp.max(cand_d, axis=-1)
        newly_done = jnp.isinf(sel_d[:, 0]) | (sel_d[:, 0] > worst)
        done = done | newly_done
        live = jnp.logical_not(done)
        # within the selected set, only expand candidates under the bound
        exp_ok = live[:, None] & jnp.logical_not(jnp.isinf(sel_d)) & (
            sel_d <= worst[:, None]
        )
        sel_i = jnp.where(exp_ok, sel_i, NIL)

        nbrs = adj[jnp.clip(sel_i, 0)].reshape(b, expand * deg)
        ok = (nbrs >= 0) & jnp.repeat(exp_ok, deg, axis=-1)
        dup = member_mask(nbrs, cand_i) | member_mask(nbrs, exp_ids)
        ok = ok & jnp.logical_not(dup)
        nbrs_m = jnp.where(ok, nbrs, NIL)
        # neighbor lists of different expanded candidates can overlap
        nbrs_m, _ = mask_duplicates(nbrs_m, jnp.zeros_like(nbrs, jnp.float32))
        ok = ok & (nbrs_m >= 0)
        safe = jnp.clip(nbrs_m, 0)
        nd = gathered_distances(
            q, vectors[safe], metric, vec_norms=norms[safe], q_norms=qn
        )
        nd = jnp.where(ok, nd, INF)

        cand_d2, cand_i2 = merge_topk(cand_d, cand_i, nd, nbrs_m, ef)
        exp_ids = jax.lax.dynamic_update_slice_in_dim(
            exp_ids, sel_i, it * expand, axis=1
        )

        if filtered:
            n_ok = ok & allowed[safe]
            rd = jnp.where(n_ok, nd, INF)
            ri = jnp.where(n_ok, nbrs_m, NIL)
            res_d2, res_i2 = merge_topk(res_d, res_i, rd, ri, res_d.shape[-1])
            res_d = jnp.where(live[:, None], res_d2, res_d)
            res_i = jnp.where(live[:, None], res_i2, res_i)

        keep = live[:, None]
        return (
            it + 1,
            jnp.where(keep, cand_i2, cand_i),
            jnp.where(keep, cand_d2, cand_d),
            exp_ids,
            res_i,
            res_d,
            done,
        )

    init_done = jnp.logical_not(active) | (seed_i < 0).all(-1)
    _, cand_i, cand_d, exp_ids, res_i, res_d, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), cand_i, cand_d, exp_ids, res_i, res_d, init_done)
    )
    if filtered:
        return cand_d, cand_i, res_d, res_i
    if return_expanded:
        return cand_d, cand_i, exp_ids
    return cand_d, cand_i


def _seed_from_entry(vectors, norms, q, qn, entry, metric):
    b = q.shape[0]
    cur_i = jnp.full((b,), entry, jnp.int32)
    ed = gathered_distances(
        q,
        vectors[jnp.clip(entry, 0)][None, None, :].repeat(b, 0),
        metric,
        vec_norms=norms[jnp.clip(entry, 0)][None, None].repeat(b, 0),
        q_norms=qn,
    )[:, 0]
    return cur_i, jnp.where(entry >= 0, ed, INF)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

@partial(
    jax.jit,
    static_argnames=("cfg", "k", "ef", "iters", "filtered", "expand", "descent_ef"),
)
def hnsw_search_impl(
    state: HnswState,
    queries: jax.Array,
    allowed: jax.Array | None,
    *,
    cfg: HnswConfig,
    k: int,
    ef: int,
    iters: int,
    filtered: bool,
    expand: int = 4,
    descent_ef: int = 1,
):
    """Full k-NN query: descent max_level..1, ef-beam at level 0.

    Mirrors reference mod.rs:1092-1171 search / :1176 search_filtered.
    descent_ef=1 is the reference's single-path greedy descent
    (search.rs:259-309); >1 runs a narrow beam per upper level instead —
    bulk-built graphs (exact-kNN pools) need it because single-path greedy
    sticks in local minima that the incremental build's beam-derived
    long-range edges would have bridged.
    Returns ([B,k] dists asc, [B,k] slot ids, NIL-padded).
    """
    q = queries.astype(jnp.float32)
    qn = prep_norms(q)
    cur_i, cur_d = _seed_from_entry(
        state.vectors, state.norms, q, qn, state.entry, cfg.metric
    )
    seeds_i, seeds_d = cur_i[:, None], cur_d[:, None]
    for lvl in range(cfg.max_levels - 1, 0, -1):
        adj = state.adj_hi[lvl - 1]
        if descent_ef <= 1:
            cur_i, cur_d = _greedy_level(
                adj, state.vectors, state.norms, q, qn,
                seeds_i[:, 0], seeds_d[:, 0], cfg.metric,
            )
            seeds_i, seeds_d = cur_i[:, None], cur_d[:, None]
        else:
            # the beam is seeded with the incoming seeds, so its buffer
            # dominates them; hand the FULL sorted beam down — multi-
            # seeding the next level is what lets the search escape a
            # wrong-basin best-1 (the reference's greedy hand-off,
            # mod.rs:1134-1147, forces a single carry)
            seeds_d, seeds_i = _beam_level(
                adj, state.vectors, state.norms, q, qn, seeds_i, seeds_d,
                descent_ef, 2 * descent_ef, cfg.metric, expand=2,
            )

    if filtered:
        _, _, res_d, res_i = _beam_level(
            state.adj0, state.vectors, state.norms, q, qn, seeds_i, seeds_d,
            ef, iters, cfg.metric, allowed=allowed, k_res=max(k, 16),
            expand=expand,
        )
        return res_d[:, :k], res_i[:, :k]
    cand_d, cand_i = _beam_level(
        state.adj0, state.vectors, state.norms, q, qn, seeds_i, seeds_d,
        ef, iters, cfg.metric, expand=expand,
    )
    return topk_smallest(cand_d, cand_i, k)


# ---------------------------------------------------------------------------
# build: neighbor selection
# ---------------------------------------------------------------------------

def _select_neighbors_heuristic(
    cand_i, cand_d, cand_vecs, m_out: int, metric, alpha: float = 1.0
):
    """Vectorized diversity heuristic (reference operations.rs:181-233).

    cand_* sorted ascending by distance-to-query. A candidate is selected
    iff it is closer to the query than to every already-selected neighbor;
    skipped candidates backfill remaining slots in distance order. The
    reference's sequential loop becomes a masked scan over the candidate
    axis using the full pairwise distance matrix (one batched matmul).
    `alpha` > 1 relaxes the rule (DiskANN/Vamana style: keep j while
    d(q,j) < alpha*d(j,selected)) — retains mid-range edges, which pure
    exact-kNN candidate pools otherwise lack entirely.
    Returns (sel_i [B, m_out], sel_d [B, m_out]) NIL/INF-padded.
    """
    b, c = cand_i.shape
    valid = cand_i >= 0
    # pairwise distances among candidates: [B, C, C]
    dots = jnp.einsum(
        "bcd,bkd->bck", cand_vecs, cand_vecs,
        preferred_element_type=jnp.float32, precision=PRECISE,
    )
    if metric is Metric.L2:
        nrm = jnp.sum(cand_vecs * cand_vecs, axis=-1)
        pair = jnp.maximum(nrm[:, :, None] + nrm[:, None, :] - 2.0 * dots, 0.0)
    elif metric is Metric.COSINE:
        pair = 1.0 - dots
    else:
        pair = -dots

    def step(carry, j):
        sel_mask, min_sel, count = carry
        # candidate j is diverse if closer to the query than to any selected
        diverse = cand_d[:, j] < alpha * min_sel[:, j]
        take = valid[:, j] & diverse & (count < m_out)
        sel_mask = sel_mask.at[:, j].set(take)
        min_sel = jnp.where(take[:, None], jnp.minimum(min_sel, pair[:, :, j]), min_sel)
        return (sel_mask, min_sel, count + take.astype(jnp.int32)), None

    init = (
        jnp.zeros((b, c), bool),
        jnp.full((b, c), INF, jnp.float32),
        jnp.zeros((b,), jnp.int32),
    )
    (sel_mask, _, _), _ = jax.lax.scan(step, init, jnp.arange(c))

    # order: selected (asc dist) first, then skipped (asc dist) as backfill
    key = jnp.where(valid, cand_d, INF) + jnp.where(sel_mask, 0.0, 1e30)
    order = jnp.argsort(key, axis=-1)[:, :m_out]
    sel_i = jnp.take_along_axis(cand_i, order, axis=-1)
    sel_d = jnp.take_along_axis(jnp.where(valid, cand_d, INF), order, axis=-1)
    sel_i = jnp.where(jnp.isinf(sel_d), NIL, sel_i)
    return sel_i, sel_d


# ---------------------------------------------------------------------------
# build: stage cores (shared by the split single-device path and the fused
# shard_map path)
# ---------------------------------------------------------------------------

def _stage_vectors_core(vectors, norms, levels, vecs, slots, lvls, mask):
    q = vecs.astype(jnp.float32)
    qn = prep_norms(q)
    vectors = vectors.at[slots].set(q)
    norms = norms.at[slots].set(jnp.where(mask, qn, INF))
    levels = levels.at[slots].set(jnp.where(mask, lvls, -1))
    return vectors, norms, levels, q, qn


def _wave_level_core(
    adj, vectors, norms, q, qn, cur_i, cur_d, connect,
    *, metric, efc, iters, deg_out,
):
    """One level of the insert wave: greedy descent for nodes passing
    through, candidate beam + diversity selection for nodes connecting here
    (reference insert_descent_phase/insert_connection_phase,
    operations.rs:111-171). Returns (next seeds, selected neighbors)."""
    gi, gd = _greedy_level(adj, vectors, norms, q, qn, cur_i, cur_d, metric)
    cand_d, cand_i = _beam_level(
        adj, vectors, norms, q, qn, cur_i, cur_d, efc, iters, metric,
        active=connect,
    )
    cand_vecs = vectors[jnp.clip(cand_i, 0)]
    sel_i, sel_d = _select_neighbors_heuristic(
        jnp.where(cand_i >= 0, cand_i, NIL),
        jnp.where(cand_i >= 0, cand_d, INF),
        cand_vecs,
        deg_out,
        metric,
    )
    sel_i = jnp.where(connect[:, None], sel_i, NIL)
    sel_d = jnp.where(connect[:, None], sel_d, INF)
    nxt_i = jnp.where(connect, cand_i[:, 0], gi)
    nxt_d = jnp.where(connect, cand_d[:, 0], gd)
    return nxt_i, nxt_d, sel_i, sel_d


def _select_from_candidates(
    vectors, norms, targets, cand, deg: int, metric, alpha: float = 1.0
):
    """Diversity-select `deg` edges for each target from an explicit
    candidate list (duplicates / NIL / self allowed — they are masked).
    Candidates are sorted by exact distance-to-target, truncated to a
    bounded window (the heuristic scan is sequential in the candidate
    axis; entries past ~2.5×deg are effectively never selected — except
    under alpha-relaxation, which exists precisely to reach the wide
    pool), then run through the reference diversity rule
    (operations.rs:181-233). Returns (sel_i [U, deg], sel_d [U, deg])."""
    n = cand.shape[-1]
    eq = cand[:, :, None] == cand[:, None, :]
    earlier = jnp.tril(jnp.ones((n, n), bool), k=-1)
    dup = jnp.any(eq & earlier, axis=-1) | (cand == targets[:, None]) | (cand < 0)
    tvec = vectors[targets]
    tnorm = norms[targets]
    safe = jnp.clip(cand, 0)
    d = gathered_distances(
        tvec, vectors[safe], metric, vec_norms=norms[safe], q_norms=tnorm
    )
    d = jnp.where(dup, INF, d)
    order = jnp.argsort(d, axis=-1)
    sel_cap = n if alpha != 1.0 else min(n, max(2 * deg + deg // 2, 48))
    order = order[:, :sel_cap]
    cand_s = jnp.take_along_axis(jnp.where(dup, NIL, cand), order, axis=-1)
    d_s = jnp.take_along_axis(d, order, axis=-1)
    vecs_s = vectors[jnp.clip(cand_s, 0)]
    return _select_neighbors_heuristic(cand_s, d_s, vecs_s, deg, metric, alpha)


def _prune_rows(vectors, norms, targets, tmask, appends, adj, metric):
    """Gather each target's adjacency row, append new ids, dedup, and
    re-select `deg` neighbors with the DIVERSITY heuristic.

    The reference prunes overflow with keep-nearest (prune_neighbors,
    operations.rs:235). That is a recall trap on clustered data: once a
    cluster densifies, keep-nearest evicts every long-range edge and the
    graph shatters into islands (measured: 29/64 clusters unreachable).
    Re-running select_neighbors_heuristic on the merged list — what
    hnswlib's overflow path does — keeps the bridges. Returns the
    replacement rows [U, deg]."""
    deg = adj.shape[-1]
    old = adj[targets]                               # [U, deg]
    cand = jnp.concatenate([old, appends], axis=-1)  # [U, deg+R]
    kept, _ = _select_from_candidates(vectors, norms, targets, cand, deg, metric)
    return jnp.where(tmask[:, None], kept, old)


def _reverse_dense_core(
    adj, vectors, norms, targets, new_ids, dists, metric,
    rcap: int = 16, chunk: int = 2048,
):
    """Apply a whole wave's reverse (back) edges in one device pass.

    The reference appends the new node to each chosen neighbor's list under
    a per-node write lock (mod.rs:1067-1077). Batched, multiple new nodes
    target the same neighbor — a scatter with conflicts. Resolution, fully
    on device: lexsort the edge list by (target, distance), segment the
    sorted run into per-target groups, give each edge its rank within the
    group, and scatter into a dense [U, rcap] append matrix. Edges ranked
    past rcap are dropped — by construction they are the *farthest* ones,
    the first to be pruned anyway. Then each touched row is re-selected by
    `_prune_rows` in fixed-size chunks.

    targets/new_ids/dists: flat [E] edge list, NIL-padded.
    """
    cap = vectors.shape[0]
    e = targets.shape[0]
    scratch = cap - 1
    valid = targets >= 0
    t = jnp.where(valid, targets, scratch)
    d = jnp.where(valid, dists, INF)
    order = jnp.lexsort((d, t))
    t_s = t[order]
    n_s = jnp.where(valid[order], new_ids[order], NIL)

    first = jnp.concatenate([jnp.ones((1,), bool), t_s[1:] != t_s[:-1]])
    grp = jnp.cumsum(first.astype(jnp.int32)) - 1          # [E] group index
    pos = jnp.arange(e, dtype=jnp.int32)
    first_pos = jax.ops.segment_min(pos, grp, num_segments=e)
    rank = pos - first_pos[grp]

    uniq = jnp.full((e,), scratch, jnp.int32).at[grp].set(t_s)
    umask = jnp.zeros((e,), bool).at[grp].set(t_s != scratch)
    appends = jnp.full((e, rcap), NIL, jnp.int32)
    keep = (rank < rcap) & (n_s >= 0)
    # masked writes are redirected out of bounds and dropped
    appends = appends.at[
        jnp.where(keep, grp, e), jnp.where(keep, rank, 0)
    ].set(n_s, mode="drop")

    nchunks = -(-e // chunk)
    pad = nchunks * chunk - e
    if pad:
        uniq = jnp.concatenate([uniq, jnp.full((pad,), scratch, jnp.int32)])
        umask = jnp.concatenate([umask, jnp.zeros((pad,), bool)])
        appends = jnp.concatenate(
            [appends, jnp.full((pad, rcap), NIL, jnp.int32)]
        )

    def body(i, adj_acc):
        sl = i * chunk
        tg = jax.lax.dynamic_slice_in_dim(uniq, sl, chunk)
        tm = jax.lax.dynamic_slice_in_dim(umask, sl, chunk)
        ap = jax.lax.dynamic_slice_in_dim(appends, sl, chunk)
        rows = _prune_rows(vectors, norms, tg, tm, ap, adj_acc, metric)
        return adj_acc.at[tg].set(jnp.where(tm[:, None], rows, adj_acc[tg]))

    return jax.lax.fori_loop(0, nchunks, body, adj)


def _entry_update_core(entry, max_level, slots, lvls, mask):
    """Entry-point promotion (reference mod.rs:1079-1081) + empty-graph
    bootstrap."""
    wave_best = jnp.max(jnp.where(mask, lvls, -1))
    best_idx = jnp.argmax(jnp.where(mask, lvls, -1))
    promote = (wave_best > max_level) | (entry < 0)
    new_entry = jnp.where(promote & jnp.any(mask), slots[best_idx], entry)
    new_max = jnp.maximum(max_level, wave_best)
    return new_entry.astype(jnp.int32), new_max.astype(jnp.int32)


# ---------------------------------------------------------------------------
# build: small jitted stage programs (single-device path)
# ---------------------------------------------------------------------------

_stage_vectors_jit = jax.jit(_stage_vectors_core, donate_argnums=(0, 1, 2))

_seed_jit = jax.jit(_seed_from_entry, static_argnames=("metric",))

_wave_level_jit = jax.jit(
    _wave_level_core, static_argnames=("metric", "efc", "iters", "deg_out")
)


@partial(jax.jit, donate_argnums=(0,))
def _write_forward_jit(adj, slots, sel, mask):
    deg = adj.shape[-1]
    row = jnp.full((slots.shape[0], deg), NIL, jnp.int32)
    row = row.at[:, : sel.shape[1]].set(sel)
    return adj.at[slots].set(jnp.where(mask[:, None], row, adj[slots]))


_reverse_level_jit = jax.jit(
    _reverse_dense_core,
    donate_argnums=(0,),
    static_argnames=("metric", "rcap", "chunk"),
)

_entry_update_jit = jax.jit(_entry_update_core)


# ---------------------------------------------------------------------------
# build: fused whole-wave program (mesh/shard_map path)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg", "efc", "iters"))
def build_wave_impl(
    state: HnswState,
    new_vecs: jax.Array,
    new_slots: jax.Array,
    new_levels: jax.Array,
    wave_mask: jax.Array,
    *,
    cfg: HnswConfig,
    efc: int,
    iters: int,
) -> HnswState:
    """One fully-device insert wave: forward search + edges, then dense
    reverse updates per level. Jittable as a unit so the mesh-parallel
    build can shard it (SURVEY.md §2.9 "sharded graph build")."""
    vectors, norms, levels, q, qn = _stage_vectors_core(
        state.vectors, state.norms, state.levels,
        new_vecs, new_slots, new_levels, wave_mask,
    )
    state = state._replace(vectors=vectors, norms=norms, levels=levels)
    have_entry = state.entry >= 0
    cur_i, cur_d = _seed_from_entry(
        state.vectors, state.norms, q, qn, state.entry, cfg.metric
    )

    fwd = {}
    for lvl in range(cfg.max_levels - 1, -1, -1):
        adj = state.adj0 if lvl == 0 else state.adj_hi[lvl - 1]
        deg = cfg.m0 if lvl == 0 else cfg.m
        connect = wave_mask & (new_levels >= lvl) & have_entry
        cur_i, cur_d, sel_i, sel_d = _wave_level_core(
            adj, state.vectors, state.norms, q, qn, cur_i, cur_d, connect,
            metric=cfg.metric, efc=efc, iters=iters, deg_out=deg,
        )
        row = jnp.full((new_slots.shape[0], deg), NIL, jnp.int32)
        row = row.at[:, : sel_i.shape[1]].set(sel_i)
        new_adj = adj.at[new_slots].set(
            jnp.where(wave_mask[:, None], row, adj[new_slots])
        )
        if lvl == 0:
            state = state._replace(adj0=new_adj)
        else:
            hi = list(state.adj_hi)
            hi[lvl - 1] = new_adj
            state = state._replace(adj_hi=tuple(hi))
        fwd[lvl] = (sel_i, sel_d)

    for lvl in range(cfg.max_levels):
        sel_i, sel_d = fwd[lvl]
        deg = sel_i.shape[1]
        bi = new_slots.shape[0]
        src = jnp.repeat(new_slots, deg).reshape(bi, deg)
        src = jnp.where(wave_mask[:, None] & (sel_i >= 0), src, NIL)
        adj = state.adj0 if lvl == 0 else state.adj_hi[lvl - 1]
        new_adj = _reverse_dense_core(
            adj, state.vectors, state.norms,
            jnp.where(src >= 0, sel_i, NIL).reshape(-1),
            src.reshape(-1),
            sel_d.reshape(-1),
            cfg.metric,
        )
        if lvl == 0:
            state = state._replace(adj0=new_adj)
        else:
            hi = list(state.adj_hi)
            hi[lvl - 1] = new_adj
            state = state._replace(adj_hi=tuple(hi))

    entry, max_level = _entry_update_core(
        state.entry, state.max_level, new_slots, new_levels, wave_mask
    )
    return state._replace(entry=entry, max_level=max_level)


# ---------------------------------------------------------------------------
# bulk build (initial load): clustered exact-kNN -> diversity graph
#
# The incremental wave path pays a latency-bound beam search per wave.
# For an initial load the
# graph can instead be DERIVED from locally-exact kNN lists: cluster the
# vectors (k-means, ~1k/cluster, boundary rows REPLICATED into their
# runner-up cluster), compute per-cluster all-pairs distances as one
# matmul each, take top-R per row, then run the same diversity rule the
# reference applies (operations.rs:181-233) plus a reverse-edge merge
# (mod.rs:1067-1077 semantics) — no graph traversal during build at all.
# Upper levels run the same pipeline on the level subsets.
# ---------------------------------------------------------------------------

_BULK_MIN = 8192           # below this the wave path is fast enough
_BULK_BRUTE = 4096         # subsets up to this use one all-pairs matrix
_BULK_EXACT = 1 << 17      # subsets up to this get CHUNKED exact kNN:
                           # at 1M rows every upper layer (<= n/16 = 62.5k)
                           # stays exact — a 62.5k x 62.5k x 128d sweep is
                           # ~1 TFLOP, seconds of matmul — so the layers
                           # that do the NAVIGATING keep brute-force-grade
                           # long edges; only L0 uses clustered self-probe


@partial(jax.jit, static_argnames=("r", "metric"))
def _topr_vs_subset(xc, xcn, sub_vecs, sub_norms, r: int, metric):
    """Top-r nearest within a fixed SUBSET for a chunk of rows.
    Returns positions into the subset [B, r] (-1 pad)."""
    dots = jax.lax.dot_general(
        xc, sub_vecs, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32, precision=PRECISE,
    )
    if metric is Metric.IP:
        pair = -dots
    else:
        pair = xcn[:, None] + sub_norms[None, :] - 2.0 * dots
    # +inf-norm entries are padding under EVERY metric (IP's -dots would
    # otherwise rank a zero pad row above negative-dot candidates)
    pair = jnp.where(jnp.isinf(sub_norms)[None, :], INF, pair)
    nd, pos = jax.lax.top_k(-pair, r)
    return jnp.where(jnp.isinf(nd), NIL, pos.astype(jnp.int32))


@partial(jax.jit, static_argnames=("r", "metric"))
def _topr_subset_scan(qx, qn, sub_vecs, sub_norms, *, r, metric):
    """[M, B, d] query chunks vs one subset, scanned in ONE program
    instead of one dispatch per chunk."""

    def step(_, inp):
        xc, xcn = inp
        return 0, _topr_vs_subset(xc, xcn, sub_vecs, sub_norms, r, metric)

    _, out = jax.lax.scan(step, 0, (qx, qn))
    return out


_bulk_select_jit = jax.jit(
    _select_from_candidates, static_argnames=("deg", "metric", "alpha")
)


@partial(jax.jit, static_argnames=("cfg", "k", "nprobe"))
def _self_probe_scan(state, vec_dev, sslots_dev, ridx, *, cfg, k, nprobe):
    """Self-probe candidates fully in ONE program: [M, B] row-index
    chunks gather their query rows from the resident store, probe the
    temp IVF index, and map local ids back to global slots — the
    eager-op version materialized a 512MB query copy plus three
    [n, r]-sized mapping temps through separate dispatches."""
    from turdb_tpu.models.ivf import ivf_search_impl

    def step(_, rchunk):
        qb = vec_dev[sslots_dev[rchunk]]
        _, ids = ivf_search_impl(state, qb, None, cfg=cfg, k=k, nprobe=nprobe)
        cand = jnp.where(
            ids >= 0,
            sslots_dev[jnp.clip(ids, 0)].astype(jnp.int32),
            NIL,
        )
        return 0, cand

    _, out = jax.lax.scan(step, 0, ridx)
    return out


def _bulk_reverse_lists(sub_slots, adj, seld, rcap: int):
    """Host-side reverse-edge lists: for each node, the up-to-rcap NEAREST
    nodes that selected it as a forward edge (the batched analog of the
    reference's bidirectional edge write, mod.rs:1067-1077)."""
    from turdb_tpu.native.build import reverse_topk

    ns, deg = adj.shape
    sub_slots = np.ascontiguousarray(sub_slots, np.int64)
    pos_arr = np.full(int(sub_slots.max()) + 1, -1, np.int64)
    pos_arr[sub_slots] = np.arange(ns)
    # C single pass (hnsw_host.cpp): bounded insertion per target, no
    # 32M-element temps — ~10x the numpy radix path at the 1M build
    nat = reverse_topk(sub_slots, adj, seld, pos_arr, rcap)
    if nat is not None:
        return nat
    src = np.repeat(sub_slots, deg)
    tgt = adj.reshape(-1)
    dist = seld.reshape(-1)
    v = tgt >= 0
    src, tgt, dist = src[v], tgt[v], dist[v]
    rev = np.full((ns, rcap), -1, np.int32)
    if len(tgt) == 0:
        return rev
    # numpy fallback: (tgt, dist) two-key sort as ONE radix argsort over
    # a packed uint64 (slot << 32 | order-preserving f32 bits): 2.5x
    # lexsort at the 1M build's 32M entries (7.9s vs 19.8s measured)
    u = np.ascontiguousarray(dist, np.float32).view(np.uint32)
    flip = np.where(
        (u >> 31) != 0, np.uint32(0xFFFFFFFF), np.uint32(0x80000000)
    )
    key = (tgt.astype(np.uint64) << np.uint64(32)) | (u ^ flip).astype(
        np.uint64
    )
    order = np.argsort(key, kind="stable")
    t_s, s_s = tgt[order], src[order]
    first = np.zeros(len(t_s), bool)
    first[0] = True
    first[1:] = t_s[1:] != t_s[:-1]
    starts = np.flatnonzero(first)
    # rank within each target run
    run_id = np.cumsum(first) - 1
    rank = np.arange(len(t_s)) - starts[run_id]
    keep = rank < rcap
    rev[pos_arr[t_s[keep]], rank[keep]] = s_s[keep]
    return rev


def _bulk_layer_adj_host(sub_slots, x_sub, deg: int, metric,
                         rcap: int = 16, r_mult: int = 2,
                         alpha: float = 1.0):
    """Host mirror of the device layer build for TINY layers (n <= 4096,
    the upper navigating layers): at this size the whole layer is a
    fraction of a second of numpy, less than the device pipeline's
    per-stage dispatches (ROADMAP debt 4: measure, keep one path). Same
    candidate rule, diversity heuristic
    (reference operations.rs:181-233 + alpha relaxation), reverse quota,
    and union priority as the device path."""
    n = len(sub_slots)
    slots = np.asarray(sub_slots, np.int64)
    if n <= 1:
        return np.full((n, deg), NIL, np.int32)
    x = np.asarray(x_sub, np.float32)
    dots = x @ x.T
    if metric is Metric.COSINE:
        D = 1.0 - dots               # rows pre-normalized upstream
    elif metric is Metric.IP:
        D = -dots
    else:
        nrm = np.einsum("ij,ij->i", x, x)
        D = np.maximum(nrm[:, None] + nrm[None, :] - 2.0 * dots, 0.0)
    np.fill_diagonal(D, np.inf)
    r = min(r_mult * deg, n - 1)
    pos = np.argpartition(D, r - 1, axis=1)[:, :r]
    dr = np.take_along_axis(D, pos, axis=1).astype(np.float32)
    o = np.argsort(dr, axis=1, kind="stable")
    pos = np.take_along_axis(pos, o, axis=1)          # ascending by dist
    dr = np.take_along_axis(dr, o, axis=1)
    pair = D[pos[:, :, None], pos[:, None, :]]        # [n, r, r]
    # masked scan of the diversity rule, vectorized over rows
    min_sel = np.full((n, r), np.inf, np.float32)
    count = np.zeros(n, np.int64)
    sel = np.zeros((n, r), bool)
    for j in range(r):
        take = (dr[:, j] < alpha * min_sel[:, j]) & (count < deg)
        sel[:, j] = take
        min_sel = np.where(
            take[:, None], np.minimum(min_sel, pair[:, :, j]), min_sel
        )
        count += take
    # selected (asc dist) first, skipped backfill (asc dist) after
    key = dr + np.where(sel, np.float32(0.0), np.float32(1e30))
    order = np.argsort(key, axis=1, kind="stable")[:, :deg]
    adj = slots[np.take_along_axis(pos, order, axis=1)].astype(np.int32)
    seld = np.take_along_axis(dr, order, axis=1)
    if r < deg:
        adj = np.concatenate(
            [adj, np.full((n, deg - r), NIL, np.int32)], axis=1
        )
        seld = np.concatenate(
            [seld, np.full((n, deg - r), np.inf, np.float32)], axis=1
        )
    rev = _bulk_reverse_lists(slots, adj, seld, rcap)
    keep = max(deg - rcap, deg // 2)
    merged = np.concatenate([adj[:, :keep], rev, adj[:, keep:]], axis=1)
    w2 = merged.shape[1]
    eq = merged[:, :, None] == merged[:, None, :]
    earlier = np.tril(np.ones((w2, w2), bool), k=-1)
    dup = (eq & earlier).any(-1) | (merged < 0)
    keyu = np.where(dup, w2 + 1, np.arange(w2))
    orderu = np.argsort(keyu, axis=1, kind="stable")[:, :deg]
    out = np.take_along_axis(merged, orderu, axis=1)
    kept = np.take_along_axis(keyu, orderu, axis=1) <= w2
    return np.where(kept, out, NIL).astype(np.int32)


@jax.jit
def _stage_bulk(vectors, norms, levels, slots, jv, jl):
    """Bulk-load staging (vectors/norms/levels scatter) fused into one
    program: eagerly these are ~8 separate compiles."""
    return (
        vectors.at[slots].set(jv),
        norms.at[slots].set(prep_norms(jv)),
        levels.at[slots].set(jl),
    )


@jax.jit
def _scatter_rows(adj, idx, rows):
    """adj.at[idx].set(rows) as one compiled program per shape."""
    return adj.at[idx].set(rows)


@jax.jit
def _reverse_edges_prep(slots, mask, sel_i, sel_d):
    """Flattened (dst, src, dist) reverse-edge triples for one wave
    level, fused (was ~9 eager-op compiles per level)."""
    bi, deg = sel_i.shape
    src = jnp.repeat(slots, deg).reshape(bi, deg)
    src = jnp.where(mask[:, None] & (sel_i >= 0), src, NIL)
    dst = jnp.where(src >= 0, sel_i, NIL).reshape(-1)
    return dst, src.reshape(-1), sel_d.reshape(-1)


@partial(jax.jit, static_argnames=("m", "qb"))
def _gather_q(vec_dev, norm_dev, rows, m: int, qb: int):
    """Chunk-shaped query gathers for the exact-kNN scan (fused
    gather+reshape; shapes bucket on (m, qb))."""
    d = vec_dev.shape[-1]
    return (vec_dev[rows].reshape(m, qb, d),
            norm_dev[rows].reshape(m, qb))


@partial(jax.jit, static_argnames=("n",))
def _cand_from_pos(pos3, sslots, n: int):
    """Subset positions -> global candidate slot ids (NIL-masked)."""
    rr = pos3.shape[-1]
    pos = pos3.reshape(-1, rr)[:n]
    return jnp.where(
        pos >= 0, sslots[jnp.clip(pos, 0)].astype(jnp.int32), NIL
    )


@partial(jax.jit, static_argnames=("mm", "chunk"))
def _pad_chunks(sslots, cand, n, mm: int, chunk: int):
    """Pad (rows, candidates) to the chunk-scanned [mm, chunk, ·] shape
    in one program (was 5 eager-op compiles)."""
    pidx = jnp.clip(jnp.arange(mm * chunk), 0, n - 1)
    rows_pad = sslots[pidx].astype(jnp.int32).reshape(mm, chunk)
    cand_pad = cand[pidx].reshape(mm, chunk, cand.shape[1])
    return pidx, rows_pad, cand_pad


@partial(jax.jit, static_argnames=("n",))
def _unpad2(a, b, n: int):
    deg = a.shape[-1]
    return a.reshape(-1, deg)[:n], b.reshape(-1, deg)[:n]


@partial(jax.jit, static_argnames=("n",))
def _unpad1(a, n: int):
    return a.reshape(-1, a.shape[-1])[:n]


@partial(jax.jit, static_argnames=("keep", "mm", "chunk"))
def _merge_pad(adj, rev, pidx, keep: int, mm: int, chunk: int):
    """Priority-order merge (fwd head + reverse + fwd tail), re-padded
    for the union scan, in one program."""
    merged = jnp.concatenate([adj[:, :keep], rev, adj[:, keep:]], axis=1)
    return merged[pidx].reshape(mm, chunk, merged.shape[1])


def _bulk_layer_adj(
    vec_dev, norm_dev, sub_slots, x_sub, deg: int, metric,
    rcap: int = 16, chunk: int = 16384, r_mult: int = 2, alpha: float = 1.0,
):
    """Build one layer's adjacency for the subset `sub_slots` (global slot
    ids). vec_dev/norm_dev are the FULL device vector arrays so every
    jitted selection program is shared across layers. Returns
    [len(sub), deg] int32 rows of global slot ids.

    Upper layers pass r_mult=8 and alpha>1: a pure exact-kNN pool yields
    only short edges and greedy descent then sticks in local minima
    (measured: p90 landing distance 48x the true-NN distance); the wide
    pool + relaxed rule restores the mid-range edges the incremental
    build gets from its ef_construction beam."""
    import os as _os
    import sys as _sys
    import time as _time

    _dbg = _os.environ.get("TURDB_IVF_DEBUG") == "1"
    _t0 = _time.perf_counter()

    def _mark(lbl):
        nonlocal _t0
        if _dbg:
            t1 = _time.perf_counter()
            print(f"[bulk n={len(sub_slots)} deg={deg} {lbl}={t1 - _t0:.1f}s]",
                  file=_sys.stderr, flush=True)
            _t0 = t1

    n = len(sub_slots)
    r = r_mult * deg
    d = x_sub.shape[1]
    sslots = jnp.asarray(np.asarray(sub_slots, np.int64))
    # Everything below stays ON DEVICE end to end — candidates, selection,
    # reverse edges, union — with no intermediate host round-trips except
    # the reverse lists (below).
    if n <= _BULK_BRUTE:
        rows = _bulk_layer_adj_host(
            sub_slots, x_sub, deg, metric,
            rcap=rcap, r_mult=r_mult, alpha=alpha,
        )
        _mark("host-layer")
        return rows
    if n <= _BULK_EXACT:
        # chunked exact kNN against the whole (padded) subset: each chunk
        # is one [B, S] distance tile (a matmul), all chunks scanned in
        # ONE program; chunk count padded to pow2 so (m, spad) shapes
        # bucket and compiles are shared across layers/datasets
        spad = _pow2_at_least(n, floor=4096)
        # pad + norms on HOST (numpy): at <=128k rows this costs ~ms and
        # saves the zeros/.at.set/full/slice eager-compile chain — each
        # bare op is a separate compile on cold builds
        xp = np.zeros((spad, d), np.float32)
        xp[:n] = np.asarray(x_sub, np.float32)
        np_norms = np.full(spad, np.inf, np.float32)
        np_norms[:n] = np.einsum("ij,ij->i", xp[:n], xp[:n])
        sv = jnp.asarray(xp)
        sn = jnp.asarray(np_norms)
        rr = min(r, n - 1)
        qb = 4096
        m = _pow2_at_least((n + qb - 1) // qb, floor=1)
        ridx = np.clip(np.arange(m * qb), 0, n - 1)
        rows = jnp.asarray(np.asarray(sub_slots, np.int64)[ridx])
        qx, qn = _gather_q(vec_dev, norm_dev, rows, m=m, qb=qb)
        pos3 = _topr_subset_scan(qx, qn, sv, sn, r=rr, metric=metric)
        cand = _cand_from_pos(pos3, sslots, n=n)
    else:
        from turdb_tpu.models.ivf import IvfIndex

        # SELF-PROBE candidate generation: cluster the subset, then let
        # every row QUERY the clustered index (the measured IVF fast
        # path) for its top-r neighbors. Unlike the round-2a per-cluster
        # all-pairs scheme, candidates span the row's nearest CELLS, so
        # the graph gets the cross-cell-boundary edges whose absence
        # fragmented L0 into cluster islands (measured: 0.83 recall at
        # 200k however wide the intra-cell pool). nprobe=8: probe recall
        # caps graph recall (nprobe=4 saturated search at 0.926).
        # int8 probe codes (4x less gather traffic than the round-2 f32
        # tmp index) with NO rerank: candidates only need approximate
        # top-r membership — the diversity selection pass re-scores them
        # exactly. keep_f32=False skips the f32 packed copy entirely.
        tmp = IvfIndex(
            dim=d,
            metric=Metric.IP if metric is Metric.IP else Metric.L2,
            replicate=True, sq8=True, keep_f32=False,
        )
        tmp.rerank = 0
        tmp.add(x_sub)
        if tmp.state is None:
            tmp.train()
        qb = 4096
        m = (n + qb - 1) // qb
        ridx = jnp.clip(jnp.arange(m * qb), 0, n - 1).reshape(m, qb)
        # self hits come back as cand == target; the selection pass
        # masks them
        cand = _self_probe_scan(
            tmp.state, vec_dev, sslots, ridx, cfg=tmp.cfg, k=r, nprobe=8
        ).reshape(m * qb, r)[:n]
        del tmp
    jax.block_until_ready(cand)
    _mark("candidates")
    # forward diversity selection, scanned inside ONE program. Chunk
    # count padded to pow2 (floor 4) so the (mm, chunk, w) program shapes
    # bucket: every upper layer (n <= 128k) shares ONE select and ONE
    # union compile instead of recompiling per layer size.
    mm = _pow2_at_least((n + chunk - 1) // chunk, floor=4 if n > 1 else 1)
    pidx, rows_pad, cand_pad = _pad_chunks(sslots, cand, n, mm=mm,
                                           chunk=chunk)
    adj, seld = _select_scan(
        vec_dev, norm_dev, rows_pad, cand_pad,
        deg=deg, metric=metric, alpha=alpha,
    )
    adj, seld = _unpad2(adj, seld, n=n)
    jax.block_until_ready(adj)
    _mark("select")
    # reverse merge with a GUARANTEED quota (CAGRA-style union): the row
    # becomes fwd[:deg-rcap] + reverse-by-rank + remaining fwd, deduped in
    # that priority order, NO re-pruning. Re-running the diversity rule on
    # the merged list (round-2a) re-dropped exactly the incoming edges
    # that make a region escapable, leaving directed dead ends: recall
    # saturated at 0.914 however large ef, with the UNDIRECTED graph 99%
    # one component.
    # reverse lists stay HOST-side (native C pass, numpy fallback): a
    # device lexsort+scatter variant compiled for too long at 200k rows
    # (see git history); the host pass needs one adj+seld round-trip
    # (ROADMAP debt 4: re-time the device variant, keep one path)
    adj_h = np.asarray(adj)
    seld_h = np.asarray(seld)
    _mark("rev.download")
    rev_h = _bulk_reverse_lists(
        np.asarray(sub_slots, np.int64), adj_h, seld_h, rcap,
    )
    _mark("rev.host")
    rev = jnp.asarray(rev_h)
    keep = max(deg - rcap, deg // 2)
    merged_pad = _merge_pad(adj, rev, pidx, keep=keep, mm=mm, chunk=chunk)
    adj = _unpad1(_union_scan(merged_pad, deg=deg), n=n)
    jax.block_until_ready(adj)
    _mark("reverse")
    return adj


@partial(jax.jit, static_argnames=("deg", "metric", "alpha"))
def _select_scan(vectors, norms, rows, cand, *, deg, metric, alpha):
    """Chunk-scanned diversity selection: rows [M, B], cand [M, B, W] ->
    (adj [M, B, deg], seld [M, B, deg]), one device program."""

    def step(_, inp):
        rr, cc = inp
        ki, kd = _select_from_candidates(
            vectors, norms, rr, cc, deg, metric, alpha
        )
        return 0, (ki, kd)

    _, out = jax.lax.scan(step, 0, (rows, cand))
    return out


@partial(jax.jit, static_argnames=("deg",))
def _union_scan(cand, *, deg: int):
    """Chunk-scanned _union_rows_jit: [M, B, W] -> [M, B, deg]."""

    def step(_, cc):
        return 0, _union_rows(cc, deg)

    _, out = jax.lax.scan(step, 0, cand)
    return out


def _union_rows(cand, deg: int):
    """First-occurrence dedup + compact to `deg` lanes, preserving the
    given priority order (duplicates and NIL sink to the end)."""
    w = cand.shape[-1]
    eq = cand[:, :, None] == cand[:, None, :]
    earlier = jnp.tril(jnp.ones((w, w), bool), k=-1)
    dup = jnp.any(eq & earlier, axis=-1) | (cand < 0)
    key = jnp.where(dup, w + 1, jnp.arange(w, dtype=jnp.int32))
    order = jnp.argsort(key, axis=-1)
    out = jnp.take_along_axis(cand, order, axis=-1)[:, :deg]
    kept = jnp.take_along_axis(key, order, axis=-1)[:, :deg] <= w
    return jnp.where(kept, out, NIL)


_union_rows_jit = jax.jit(_union_rows, static_argnames=("deg",))


@partial(jax.jit, static_argnames=("deg", "ef", "iters", "metric"))
def _refine_chunk(adj, vectors, norms, rows, entry, *, deg, ef, iters, metric):
    """One refinement step for a chunk of layer nodes: beam-search each
    node through the CURRENT layer graph from the entry point, then
    alpha-select `deg` edges from (beam results ∪ expanded path nodes ∪
    current edges). The expanded path nodes are the point: they are the
    long-range candidates an exact-kNN pool cannot produce, and exactly
    what the reference's insert gets by searching the evolving graph
    (insert_connection_phase, operations.rs:135-171)."""
    q = vectors[rows]
    qn = norms[rows]
    seed_i, seed_d = _seed_from_entry(vectors, norms, q, qn, entry, metric)
    cand_d, cand_i, exp_ids = _beam_level(
        adj, vectors, norms, q, qn, seed_i, seed_d, ef, iters, metric,
        return_expanded=True,
    )
    cand = jnp.concatenate([cand_i, exp_ids, adj[rows]], axis=-1)
    return _select_from_candidates(
        vectors, norms, rows, cand, deg, metric, alpha=1.2
    )


def _refine_layer_adj(
    adj_full, vectors, norms, sub_slots, deg: int, metric, entry: int,
    rounds: int = 2, chunk: int = 4096, rcap: int = 16,
):
    """Vamana-style navigability refinement of one upper layer (round-2
    fix: bulk exact-kNN upper layers have only short edges, so greedy/
    narrow-beam descent sticks — measured 0.82 recall at 20k on blobby
    128-d data vs 0.96 for the incremental build). Each round searches
    every layer node through the current graph, re-selects edges from
    path-derived candidates, then re-applies the reverse merge. Jacobi
    order (all rows from the same snapshot) keeps it fully batched."""
    n = len(sub_slots)
    ef = max(2 * deg, 32)
    iters = ef + ef // 2
    gslots = np.asarray(sub_slots, np.int32)
    for _ in range(rounds):
        rows_out = np.full((n, deg), -1, np.int32)
        seld = np.full((n, deg), np.inf, np.float32)
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            ridx = np.full(chunk, int(gslots[s]), np.int32)
            ridx[: e - s] = gslots[s:e]
            ki, kd = _refine_chunk(
                adj_full, vectors, norms, jnp.asarray(ridx),
                jnp.asarray(int(entry), jnp.int32),
                deg=deg, ef=ef, iters=iters, metric=metric,
            )
            rows_out[s:e] = np.asarray(ki)[: e - s]
            seld[s:e] = np.asarray(kd)[: e - s]
        rev = _bulk_reverse_lists(
            gslots.astype(np.int64), rows_out, seld, rcap
        )
        # union with guaranteed reverse quota, no re-pruning (see
        # _bulk_layer_adj: re-pruning re-creates directed dead ends)
        keep = max(deg - rcap, deg // 2)
        merged = np.concatenate(
            [rows_out[:, :keep], rev, rows_out[:, keep:]], axis=1
        )
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            cd = np.full((chunk, merged.shape[1]), -1, np.int32)
            cd[: e - s] = merged[s:e]
            ki = _union_rows_jit(jnp.asarray(cd), deg=deg)
            rows_out[s:e] = np.asarray(ki)[: e - s]
        adj_full = _scatter_rows(adj_full, jnp.asarray(gslots),
                                 jnp.asarray(rows_out))
    return adj_full


# ---------------------------------------------------------------------------
# host-side handle
# ---------------------------------------------------------------------------

class HnswIndex:
    """Host orchestration over the functional device graph.

    Counterpart of reference PersistentHnswIndex (mod.rs:767): owns the
    device state, slot allocation, tombstones, and the wave-batched build
    loop. Persistence lives in turdb_tpu.storage (separate concern).

    The build runs as a pipeline of small jitted stage programs (see module
    docstring): the upper-level program is compiled ONCE and reused for all
    three upper levels, cutting compile time several-fold vs the fused
    whole-wave program.
    """

    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.L2,
        m: int = cfgmod.HNSW_M,
        ef_construction: int = cfgmod.HNSW_DEFAULT_EF_CONSTRUCTION,
        ef_search: int = cfgmod.HNSW_DEFAULT_EF_SEARCH,
        capacity: int = 4096,
        build_batch: int = cfgmod.HNSW_BUILD_BATCH,
        bulk_threshold: int = _BULK_MIN,
    ):
        self.cfg = HnswConfig(
            dim=dim,
            m0=2 * m,
            m=m,
            metric=metric,
            ef_construction=ef_construction,
            ef_search=ef_search,
        )
        self.capacity = _pow2(max(capacity, 1024))
        self.state = init_state(self.cfg, self.capacity)
        self.size = 0
        self.build_batch = build_batch
        self.bulk_threshold = bulk_threshold
        self._descent_ef = 1   # bulk-built graphs raise this (see add)
        self._alive = np.zeros(self.capacity, bool)  # tombstone mask (host)
        self.serve = None      # HnswServeState (see pack_serving)

    def __len__(self):
        return self.size

    # -- build ------------------------------------------------------------

    def add(self, vecs: np.ndarray, row_ids: np.ndarray | None = None) -> np.ndarray:
        """Insert vectors; returns slot ids. Levels are deterministic from
        row_ids (defaults to the slot id), as in the reference."""
        if isinstance(self.state.vectors, Sq8Rows):
            # writes need the f32 store; round-trip through dequantize
            self.dequantize()
        self.serve = None   # graph mutation invalidates the serving pack
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        n = vecs.shape[0]
        slots = np.arange(self.size, self.size + n, dtype=np.int32)
        if row_ids is None:
            row_ids = slots.astype(np.uint64)
        levels = select_levels(row_ids, self.cfg)
        self._ensure(self.size + n)
        if self.cfg.metric is Metric.COSINE:
            vecs = np.asarray(normalize_rows(jnp.asarray(vecs)))

        if self.size == 0 and n >= self.bulk_threshold:
            # initial load: clustered exact-kNN bulk build (no traversal)
            self._bulk_add(vecs, slots, levels)
            self._alive[slots] = True
            self.size += n
            # bulk graphs lack beam-path long edges, so greedy/narrow
            # descent sticks in local minima; 32 measured: 8 -> recall
            # 0.79, 32 -> the L0-candidate-quality ceiling
            self._descent_ef = 32
            return slots

        # Wave sizes grow 1, 2, 4, ... up to build_batch so every wave
        # connects into an existing graph at least as large as itself
        # (the reference inserts strictly sequentially, mod.rs:990; a wave
        # larger than the current graph would strand its nodes since
        # wave-mates are invisible to each other during the wave).
        bb = self.build_batch
        off = 0
        while off < n:
            have = self.size + off
            w = min(bb, n - off, max(1, have))
            cut = slice(off, off + w)
            self._insert_wave(vecs[cut], slots[cut], levels[cut])
            off += w
        self._alive[slots] = True
        self.size += n
        return slots

    def _bulk_add(self, vecs, slots, levels):
        """Initial-load bulk build (empty graph only): stage vectors, then
        build each layer's adjacency from clustered exact kNN + diversity
        selection + reverse merge. Produces the same fixed-degree layout
        the wave path does; search is unchanged."""
        cfg = self.cfg
        st = self.state
        jv = jnp.asarray(vecs)
        sv, sn, sl = _stage_bulk(st.vectors, st.norms, st.levels,
                                 jnp.asarray(slots), jv,
                                 jnp.asarray(levels))
        st = st._replace(vectors=sv, norms=sn, levels=sl)
        adj0 = st.adj0
        adj_hi = list(st.adj_hi)
        top = int(levels.max())
        for lvl in range(top + 1):
            sub = np.flatnonzero(levels >= lvl)
            deg = cfg.m0 if lvl == 0 else cfg.m
            rows = _bulk_layer_adj(
                st.vectors, st.norms, slots[sub].astype(np.int64),
                vecs[sub], deg, cfg.metric,
                r_mult=2 if lvl == 0 else 8,
                alpha=1.2,
            )
            if lvl == 0:
                adj0 = _scatter_rows(adj0, jnp.asarray(slots[sub]),
                                     jnp.asarray(rows))
            else:
                adj_hi[lvl - 1] = _scatter_rows(
                    adj_hi[lvl - 1], jnp.asarray(slots[sub]),
                    jnp.asarray(rows),
                )
        best = int(slots[int(np.argmax(levels))])
        # navigability refinement for the upper layers (not L0: the beam
        # there recovers on its own, and the refinement cost scales with n)
        for lvl in range(1, top + 1):
            sub = slots[np.flatnonzero(levels >= lvl)]
            if len(sub) < 4:
                continue
            adj_hi[lvl - 1] = _refine_layer_adj(
                adj_hi[lvl - 1], st.vectors, st.norms, sub, cfg.m,
                cfg.metric, best,
            )
        self.state = st._replace(
            adj0=adj0,
            adj_hi=tuple(adj_hi),
            entry=jnp.asarray(best, jnp.int32),
            max_level=jnp.asarray(top, jnp.int32),
        )

    def _insert_wave(self, vecs, slots, levels):
        nw = vecs.shape[0]
        # pad every wave to ONE static shape: a single compiled program set
        # regardless of wave size (masked lanes are done-at-entry in the
        # beam while_loop, so bootstrap waves of 1, 2, 4, ... cost little)
        bi = self.build_batch
        mask = np.zeros(bi, bool)
        mask[:nw] = True
        vpad = np.zeros((bi, self.cfg.dim), np.float32)
        vpad[:nw] = vecs
        spad = np.full(bi, self.capacity - 1, np.int32)  # scratch slot
        spad[:nw] = slots
        lpad = np.zeros(bi, np.int32)
        lpad[:nw] = levels

        cfg = self.cfg
        efc = cfg.ef_construction
        iters = efc + efc // 2
        st = self.state
        vecs_j, slots_j = jnp.asarray(vpad), jnp.asarray(spad)
        lvls_j, mask_j = jnp.asarray(lpad), jnp.asarray(mask)

        vectors, norms, lev, q, qn = _stage_vectors_jit(
            st.vectors, st.norms, st.levels, vecs_j, slots_j, lvls_j, mask_j
        )
        st = st._replace(vectors=vectors, norms=norms, levels=lev)
        have_entry = int(st.entry) >= 0
        cur_i, cur_d = _seed_jit(
            st.vectors, st.norms, q, qn, st.entry, metric=cfg.metric
        )

        fwd = {}
        for lvl in range(cfg.max_levels - 1, -1, -1):
            adj = st.adj0 if lvl == 0 else st.adj_hi[lvl - 1]
            deg = cfg.m0 if lvl == 0 else cfg.m
            connect = jnp.asarray(mask & (levels_ge := (lpad >= lvl)) & have_entry)
            cur_i, cur_d, sel_i, sel_d = _wave_level_jit(
                adj, st.vectors, st.norms, q, qn, cur_i, cur_d, connect,
                metric=cfg.metric, efc=efc, iters=iters, deg_out=deg,
            )
            new_adj = _write_forward_jit(adj, slots_j, sel_i, mask_j)
            if lvl == 0:
                st = st._replace(adj0=new_adj)
            else:
                hi = list(st.adj_hi)
                hi[lvl - 1] = new_adj
                st = st._replace(adj_hi=tuple(hi))
            fwd[lvl] = (sel_i, sel_d)

        for lvl in range(cfg.max_levels):
            sel_i, sel_d = fwd[lvl]
            adj = st.adj0 if lvl == 0 else st.adj_hi[lvl - 1]
            dst, src_f, d_f = _reverse_edges_prep(slots_j, mask_j, sel_i,
                                                  sel_d)
            new_adj = _reverse_level_jit(
                adj, st.vectors, st.norms, dst, src_f, d_f, cfg.metric,
            )
            if lvl == 0:
                st = st._replace(adj0=new_adj)
            else:
                hi = list(st.adj_hi)
                hi[lvl - 1] = new_adj
                st = st._replace(adj_hi=tuple(hi))

        entry, max_level = _entry_update_jit(
            st.entry, st.max_level, slots_j, lvls_j, mask_j
        )
        self.state = st._replace(entry=entry, max_level=max_level)

    # -- query ------------------------------------------------------------

    def search(
        self,
        queries: np.ndarray,
        k: int,
        ef: int | None = None,
        allowed: np.ndarray | None = None,
        out: str = "np",
    ):
        """Batched k-NN. `allowed`: bool[size] visibility mask — non-allowed
        nodes are traversed but excluded from results (reference
        mod.rs:62-68 doctrine). Tombstoned (deleted) nodes are always
        excluded. Returns (dists [B,k], slots [B,k]) numpy, NIL-padded."""
        is_dev = isinstance(queries, jax.Array)
        q = queries if is_dev else np.atleast_2d(np.asarray(queries, np.float32))
        if self.size == 0:
            b = q.shape[0]
            return (
                np.full((b, k), np.inf, np.float32),
                np.full((b, k), -1, np.int32),
            )
        if self.cfg.metric is Metric.COSINE:
            q = normalize_rows(jnp.asarray(q))
        ef = ef or max(self.cfg.ef_search, k)
        ef = max(ef, k)
        iters = ef + ef // 2
        mask = None
        filtered = False
        if allowed is not None or not self._alive[: self.size].all():
            m = np.zeros(self.capacity, bool)
            m[: self.size] = self._alive[: self.size]
            if allowed is not None:
                m[: len(allowed)] &= np.asarray(allowed, bool)
            mask = jnp.asarray(m)
            filtered = True
        d, i = hnsw_search_impl(
            self.state,
            jnp.asarray(q),
            mask,
            cfg=self.cfg,
            k=k,
            ef=ef,
            iters=iters,
            filtered=filtered,
            descent_ef=self._descent_ef,
        )
        if out == "jax":
            return d, i
        return np.asarray(d), np.asarray(i)

    def delete(self, slots) -> None:
        """Tombstone delete — node stays as a stepping stone until vacuum
        (reference VacuumQueue design, mod.rs:726-765)."""
        self._alive[np.asarray(slots)] = False

    def vacuum(self, row_ids=None) -> np.ndarray:
        """Compact the graph to its alive nodes. The reference's
        VacuumQueue (mod.rs:726-765) unlinks deleted nodes in place
        inside slotted pages; columnar state compacts by REBUILDING over
        the survivors — dead stepping stones stop inflating the search
        and their slots are reclaimed (without this, a delete-heavy
        workload grows the arrays without bound and survivor recall
        decays: measured 0.919 after 85% deletes at ef=64).

        Returns int32[old_size] old-slot → new-slot (-1 = dead).
        `row_ids` (per OLD slot) keeps level selection deterministic
        across the rebuild; defaults to the old slot ids."""
        if isinstance(self.state.vectors, Sq8Rows):
            self.dequantize()
        old_size = self.size
        alive = np.flatnonzero(self._alive[:old_size])
        mapping = np.full(old_size, -1, np.int32)
        vecs = np.asarray(self.state.vectors)[alive]
        rids = (np.asarray(row_ids, np.uint64)[alive]
                if row_ids is not None else alive.astype(np.uint64))
        # fresh state, same config; rebuild through the normal add path
        # (bulk pipeline when the survivor count warrants it)
        self.capacity = _pow2(max(len(alive), 1024))
        self.state = init_state(self.cfg, self.capacity)
        self.size = 0
        self._alive = np.zeros(self.capacity, bool)
        self._descent_ef = 1
        self.serve = None
        if len(alive):
            new_slots = self.add(vecs, row_ids=rids)
            mapping[alive] = new_slots
        return mapping

    # -- serving pack (two-stage int8 beam + exact rerank) ----------------

    def pack_serving(self, n_centroids: int | None = None,
                     pack_m: int | None = None) -> None:
        """Build the packed-neighbor-block serving layout (see
        models/hnsw_serve.py). Derived state: call again after mutations
        (graph writes invalidate it — `add`/`delete` clear `self.serve`).
        `pack_m` packs only each node's first pack_m (diversity-first)
        L0 neighbors — the HBM/recall knob (pack_m=16 halves the pack;
        a few extra ef points of beam buys the recall back)."""
        from turdb_tpu.models.hnsw_serve import pack_serving

        if self.size == 0:
            return
        if isinstance(self.state.vectors, Sq8Rows):
            self.dequantize()
        self.serve = pack_serving(
            self.state.vectors, self.state.norms, self.state.adj0,
            self.size, self.cfg.metric, n_centroids=n_centroids,
            pack_m=pack_m,
        )

    def search_serve(
        self,
        queries,
        k: int,
        ef: int | None = None,
        allowed: np.ndarray | None = None,
        nprobe: int = 2,
        nseed: int = 32,
        iters: int | None = None,
        expand: int = 4,
        rerank: int = 0,
        out: str = "np",
    ):
        """Serving-path k-NN (packs on first use). Same visibility
        semantics as `search`; distances returned are EXACT (rerank)."""
        from turdb_tpu.models.hnsw_serve import serve_search_impl

        if self.serve is None:
            self.pack_serving()
        if self.serve is None:   # empty index
            b = np.atleast_2d(queries).shape[0]
            return (np.full((b, k), np.inf, np.float32),
                    np.full((b, k), -1, np.int32))
        is_dev = isinstance(queries, jax.Array)
        q = queries if is_dev else np.atleast_2d(np.asarray(queries, np.float32))
        if self.cfg.metric is Metric.COSINE:
            q = normalize_rows(jnp.asarray(q))
        ef = max(ef or max(self.cfg.ef_search, k), k)
        iters = iters or (ef + ef // 2)
        mask = None
        if allowed is not None or not self._alive[: self.size].all():
            m = np.zeros(self.capacity, bool)
            m[: self.size] = self._alive[: self.size]
            if allowed is not None:
                m[: len(allowed)] &= np.asarray(allowed, bool)
            mask = jnp.asarray(m)
        d, i = serve_search_impl(
            self.serve, jnp.asarray(q), mask,
            metric=self.cfg.metric, k=k, ef=ef, iters=iters,
            expand=expand, nprobe=nprobe, nseed=nseed, rerank=rerank,
        )
        if out == "jax":
            return d, i
        return np.asarray(d), np.asarray(i)

    # -- quantization (reference quantization.rs; SQ8 for the GRAPH) ------

    def quantize_sq8(self) -> None:
        """Switch the vector store to SQ8-in-HBM serving mode (4x less
        HBM + gather bandwidth; see Sq8Rows). Search runs unchanged
        through the same jitted programs; add() transparently dequantizes
        first. Norms keep their exact f32 values.

        At-scale tradeoff (measured, 1M x 128d clustered): u8 codes cost
        real recall (0.77 vs 0.94 at ef=64 — beam DISTANCES carry the
        quantization error and there is no rerank stage in a graph
        search); quantize_sq16() keeps recall at f32 parity for 2x (not
        4x) memory."""
        self._quantize(8)

    def quantize_sq16(self) -> None:
        """16-bit variant: 2x less HBM at f32-parity recall (the 2^-16
        step is final-ordering-exact; same finding as the IVF SQ16
        rerank store)."""
        self._quantize(16)

    def _quantize(self, bits: int) -> None:
        s = self.state
        if isinstance(s.vectors, Sq8Rows):
            return
        x = s.vectors
        levels = (1 << bits) - 1
        mins = jnp.min(x, axis=-1)
        scales = (jnp.max(x, axis=-1) - mins) / levels
        safe = jnp.where(scales == 0, 1.0, scales)
        codes = jnp.clip(
            jnp.round((x - mins[:, None]) / safe[:, None]), 0, levels
        ).astype(jnp.uint8 if bits == 8 else jnp.uint16)
        self.state = s._replace(vectors=Sq8Rows(codes, mins, scales))

    def dequantize(self) -> None:
        """Expand SQ8 codes back to a dense f32 store (for writes)."""
        s = self.state
        if isinstance(s.vectors, Sq8Rows):
            self.state = s._replace(vectors=s.vectors.dense())

    # -- memory -----------------------------------------------------------

    def _ensure(self, need: int):
        # +1 headroom: the top slot is the masked-padding scratch target
        if need + 1 <= self.capacity:
            return
        new_cap = _pow2(need + 1)
        s = self.state
        pad = new_cap - self.capacity
        self.state = HnswState(
            vectors=jnp.concatenate(
                [s.vectors, jnp.zeros((pad, self.cfg.dim), jnp.float32)]
            ),
            norms=jnp.concatenate([s.norms, jnp.full((pad,), INF, jnp.float32)]),
            adj0=jnp.concatenate(
                [s.adj0, jnp.full((pad, self.cfg.m0), NIL, jnp.int32)]
            ),
            adj_hi=tuple(
                jnp.concatenate([a, jnp.full((pad, self.cfg.m), NIL, jnp.int32)])
                for a in s.adj_hi
            ),
            levels=jnp.concatenate([s.levels, jnp.full((pad,), -1, jnp.int32)]),
            entry=s.entry,
            max_level=s.max_level,
        )
        self._alive = np.concatenate([self._alive, np.zeros(pad, bool)])
        self.capacity = new_cap


def _pow2(n: int) -> int:
    p = 1024
    while p < n:
        p *= 2
    return p


def _pow2_at_least(n: int, floor: int = 32) -> int:
    p = floor
    while p < n:
        p *= 2
    return p
