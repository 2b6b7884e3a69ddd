"""IVF-Flat vector index: clustered, block-contiguous ANN.

Why this exists: graph ANN is pointer-chasing — each beam step gathers
scattered 512B rows, a latency-bound access pattern that uses a small
share of device-memory bandwidth however it is issued. Clustered search
replaces those gathers with CONTIGUOUS multi-KB block reads feeding
batched distance matmuls. This is the SURVEY.md §7 design stance applied
to its logical end: the reference's HNSW remains (models/hnsw.py) for
parity and incremental workloads; IVF is the throughput engine.

Layout:
    centroids   [C, d] f32
    members     [C, L] int32 slot ids, -1 padded   (packed, padded clusters)
    pvecs       [C, L, d] f32 packed vector copies
    pnorms      [C, L] f32 (+inf padding)
    alive       [C, L] bool (tombstones)
    codes/mins/scales (optional SQ8: 4x less probe bandwidth, f32 rerank)

Search: one [B,d]x[d,C] centroid matmul -> top-nprobe -> block gather
[B,P,L,d] -> fused distance + masked top-k (+ optional exact rerank).
Build: device k-means (Lloyd's = matmuls + segment sums) + host-side
balanced packing into fixed-width clusters.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from turdb_tpu.ops.distance import PRECISE, Metric, normalize_rows, prep_norms
from turdb_tpu.ops.quantize import int8_dot, sq8_encode
from turdb_tpu.ops.topk import (
    mask_duplicates,
    topk_smallest,
    topk_smallest_wide,
)

# plain Python scalars: jnp scalars at module scope would initialize the
# device backend at import time, and a backend reserves most of the
# card's memory; weak typing anchors them to the surrounding dtype inside
# traced code
NIL = -1
INF = float("inf")


@dataclasses.dataclass(frozen=True)
class IvfConfig:
    dim: int
    n_clusters: int
    cluster_cap: int
    metric: Metric = Metric.L2
    nprobe: int = 8
    sq8: bool = False
    rerank: int = 0          # exact-rerank candidate count (0 = off)
    replicated: bool = False  # boundary replicas present -> dedup at top-k
    dense: bool = False      # cells bin-packed into dense physical blocks
    copies: int = 2          # max physical copies per slot (1 + replica_rank):
                             # sizes the pre-dedup top-k window


class IvfState(NamedTuple):
    """Packed device state. Cells are LOGICAL (centroid-scored); storage
    rows live in physical blocks. Without dense packing block == cell and
    the storage arrays are [C, L, ...]; with `IvfConfig.dense` whole cells
    are bin-packed into [NB, L, ...] blocks at ~full occupancy (the
    split-cascade cells average well under half of `cluster_cap`, so the
    per-cell layout wastes most of every probe's gather on dead lanes —
    about 70% of lanes at the 1M x 128d geometry) and `cell_block` maps the
    probed cell to its block. A gathered block is scored WHOLE: rows of
    co-resident cells are legitimate extra candidates (locality-ordered
    packing makes them near-duplicates of SOAR replicas), and duplicate
    ids from shared blocks dedup at top-k exactly like replicas."""

    centroids: jax.Array   # [C, d]
    cnorms: jax.Array      # [C]
    members: jax.Array     # [NB, L] int32
    pvecs: jax.Array       # [NB, L, d] f32 (zeros when sq8-only)
    pnorms: jax.Array      # [NB, L]
    alive: jax.Array       # [NB, L] bool
    codes: jax.Array       # [NB, L, d] u8 (zeros when not sq8)
    mins: jax.Array        # [NB, L]
    scales: jax.Array      # [NB, L]
    cell_block: jax.Array | None = None  # [C] int32 (dense only)


# ---------------------------------------------------------------------------
# k-means (device Lloyd's iterations)
# ---------------------------------------------------------------------------

_KM_CHUNK = 4096  # assignment tile: [chunk, C] distance block stays <~512MB
_PAD_CENT = 1e15  # pad-centroid sentinel: finite (no inf*0 NaN in the
                  # distance matmuls), far beyond any real data, and its
                  # cnorm is masked to +inf so it never wins an argmin


def _cpad(c: int) -> int:
    """Centroid-count shape bucket: pow2 up to 8k, then multiples of 8k
    (a pure pow2 ladder would inflate 156k cells at 10M rows to 262k)."""
    return _pow2_at_least(c, floor=8) if c <= 8192 else -(-c // 8192) * 8192


@partial(jax.jit, static_argnames=("c_real",))
def _masked_cn(cents: jax.Array, c_real: int) -> jax.Array:
    """Centroid norms with pad cells at +inf (never assigned)."""
    cn = prep_norms(cents)
    if cents.shape[0] > c_real:
        cn = cn.at[c_real:].set(jnp.inf)
    return cn


def _assign_chunk(cents, cn, xc, xnc):
    # bf16 operands, f32 accumulate: assignment tolerates the rounding and
    # bf16 matmuls run at several times the f32 rate
    d = xnc[:, None] + cn[None, :] - 2.0 * jax.lax.dot_general(
        xc.astype(jnp.bfloat16), cents.astype(jnp.bfloat16),
        (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32,
    )
    return jnp.argmin(d, axis=1)


@partial(jax.jit, static_argnames=("iters",))
def _kmeans(x: jax.Array, centroids: jax.Array, iters: int):
    """Lloyd's with CHUNKED assignment: the full [N, C] distance matrix
    doesn't fit at scale (1M x 16k = 62GB), so assignment streams x in
    tiles — each tile is one matmul — and the update accumulates
    per-tile segment sums (scatter-adds: on a GPU their summation order
    varies run to run, so centroids are reproducible in recall, not in
    bits). x must be padded to a _KM_CHUNK multiple with
    +inf-norm rows (they assign to cluster argmin of garbage but carry
    zero weight via the valid mask)."""
    n = x.shape[0]
    assert n % _KM_CHUNK == 0
    xn = prep_norms(x)
    valid = jnp.isfinite(xn)
    # zero the padding rows: an inf row times weight 0 is NaN and one NaN
    # poisons its centroid, collapsing every later assignment to argmin's
    # NaN-propagation cluster
    x = jnp.where(valid[:, None], x, 0.0)
    xn = jnp.where(valid, xn, jnp.inf)
    xs = x.reshape(n // _KM_CHUNK, _KM_CHUNK, x.shape[1])
    xns = xn.reshape(n // _KM_CHUNK, _KM_CHUNK)
    vs = valid.reshape(n // _KM_CHUNK, _KM_CHUNK)
    c = centroids.shape[0]

    def step(cents, _):
        cn = prep_norms(cents)

        def tile(carry, inp):
            sums, counts = carry
            xc, xnc, vc = inp
            a = _assign_chunk(cents, cn, xc, xnc)
            w = vc.astype(jnp.float32)
            # segment_sum (scatter-add) instead of a one-hot matmul: the
            # [chunk, C] one-hot would move 0.5GB of device memory per
            # tile at C=32k
            counts = counts + jax.ops.segment_sum(w, a, num_segments=c)
            sums = sums + jax.ops.segment_sum(
                xc * w[:, None], a, num_segments=c
            )
            return (sums, counts), None

        (sums, counts), _ = jax.lax.scan(
            tile,
            (jnp.zeros((c, x.shape[1]), jnp.float32), jnp.zeros((c,), jnp.float32)),
            (xs, xns, vs),
        )
        new = sums / jnp.maximum(counts, 1.0)[:, None]
        new = jnp.where((counts > 0)[:, None], new, cents)
        return new, None

    centroids, _ = jax.lax.scan(step, centroids, None, length=iters)
    return centroids


@jax.jit
def _assign_all(x: jax.Array, centroids: jax.Array, cn: jax.Array | None = None):
    """Chunked nearest-centroid assignment. `cn` overrides the centroid
    norms — callers pass +inf entries to exclude (full) clusters."""
    n = x.shape[0]
    assert n % _KM_CHUNK == 0
    if cn is None:
        cn = prep_norms(centroids)
    xs = x.reshape(n // _KM_CHUNK, _KM_CHUNK, x.shape[1])
    xns = prep_norms(x).reshape(n // _KM_CHUNK, _KM_CHUNK)
    out = jax.lax.map(
        lambda inp: _assign_chunk(centroids, cn, inp[0], inp[1]), (xs, xns)
    )
    return out.reshape(n)


@partial(jax.jit, static_argnames=("k",))
def _assign_topk_all(x: jax.Array, centroids: jax.Array,
                     cn: jax.Array | None = None, *, k: int = 2):
    """Chunked top-k nearest-centroid assignment: ([n,k] ids, [n,k] d²).
    k=2 serves single-replica placement; higher k feeds the SOAR-style
    multi-rank replica waves (replica_rank > 1)."""
    n = x.shape[0]
    assert n % _KM_CHUNK == 0
    if cn is None:
        cn = prep_norms(centroids)
    xs = x.reshape(n // _KM_CHUNK, _KM_CHUNK, x.shape[1])
    xns = prep_norms(x).reshape(n // _KM_CHUNK, _KM_CHUNK)

    def tile(inp):
        xc, xnc = inp
        d = xnc[:, None] + cn[None, :] - 2.0 * jax.lax.dot_general(
            xc.astype(jnp.bfloat16), centroids.astype(jnp.bfloat16),
            (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32,
        )
        nd, ni = jax.lax.top_k(-d, k)
        return ni.astype(jnp.int32), -nd

    ids, ds = jax.lax.map(tile, (xs, xns))
    return ids.reshape(n, k), ds.reshape(n, k)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _first_unique(blk: jax.Array, u: int) -> jax.Array:
    """[B, P] -> [B, u]: the first `u` DISTINCT values per row, in first-
    occurrence order (later duplicates sink; if fewer than `u` distinct
    values exist the tail repeats duplicates — a wasted but harmless
    re-gather). Used by the dense probe: top-P cells often share physical
    blocks, so the gather list compacts to far fewer unique blocks."""
    p = blk.shape[-1]
    eq = blk[:, :, None] == blk[:, None, :]
    earlier = jnp.tril(jnp.ones((p, p), bool), k=-1)
    dup = jnp.any(eq & earlier, axis=-1)
    key = jnp.where(dup, p + 1, jnp.arange(p, dtype=jnp.int32))
    order = jnp.argsort(key, axis=-1)[:, :u]
    return jnp.take_along_axis(blk, order, axis=-1)


@partial(jax.jit, static_argnames=("cfg", "k", "nprobe", "nblocks"))
def ivf_search_impl(
    state: IvfState,
    queries: jax.Array,     # [B, d]
    allowed,                # [NB, L] bool or None (visibility mask)
    *,
    cfg: IvfConfig,
    k: int,
    nprobe: int,
    nblocks: int | None = None,
):
    """Fused probe: centroid matmul -> top-P clusters -> contiguous block
    gather -> distance matmul -> masked top-k (-> optional exact rerank).
    Returns ([B,k] dists asc, [B,k] slot ids)."""
    q = queries.astype(jnp.float32)
    b = q.shape[0]
    qn = prep_norms(q)
    # cell scoring takes f32 operands at DEFAULT precision (TF32 passes
    # on a GPU): a coarse ranking, checked by recall at the gate
    d2c = qn[:, None] + state.cnorms[None, :] - 2.0 * jax.lax.dot_general(
        q, state.centroids, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    if d2c.shape[-1] > 1024:
        # two-level EXACT top-k (ops/topk.py topk_smallest_wide):
        # bucket-min + re-scan of the winning buckets selects the same
        # cells as a full-row lax.top_k at a fraction of its time on
        # wide rows (PERF.md, "top-k")
        _, top = topk_smallest_wide(d2c, nprobe)
    else:
        _, top = jax.lax.top_k(-d2c, nprobe)        # [B, P]

    if cfg.dense:
        # logical cells -> physical blocks; co-blocked cells collapse to
        # one gather, so `nblocks` unique blocks can cover `nprobe` cells
        src = state.cell_block[top]                 # [B, P]
        if nblocks is not None and nblocks < nprobe:
            src = _first_unique(src, nblocks)
    else:
        src = top

    mem = state.members[src]                        # [B, P', L]
    live = (mem >= 0) & state.alive[src]
    if allowed is not None:
        live = live & allowed[src]

    if cfg.sq8:
        # int8 path: codes are CENTERED (c = u - 128, int8) and the query
        # is symmetric-quantized per row, so the inner product runs
        # s8 x s8 -> s32 (exact) and the probe moves 4x fewer bytes.
        #   x̂_d = m' + scale*c_d   with m' = min + 128*scale (stored in
        #   state.mins), so  q·x̂ = m'*Σq + scale*qs*(qc·c)
        codes = state.codes[src]                    # [B, P, L, d] int8
        qmax = jnp.max(jnp.abs(q), axis=-1)
        qs = jnp.maximum(qmax, 1e-30) / 127.0
        qc = jnp.clip(
            jnp.round(q / qs[:, None]), -127, 127
        ).astype(jnp.int8)
        doti = int8_dot(qc, codes)                  # [B, P, L] int32
        q_sum = jnp.sum(q, axis=-1)
        q_dot_x = (
            state.mins[src] * q_sum[:, None, None]
            + state.scales[src] * (qs[:, None, None] * doti.astype(jnp.float32))
        )
        # pnorms holds the exact ‖x‖²; quantization error lands in the
        # cross term only and the exact rerank pass absorbs it
        dist = qn[:, None, None] - 2.0 * q_dot_x + state.pnorms[src]
    else:
        blocks = state.pvecs[src]                   # [B, P, L, d]
        # PRECISE: the probe is memory-bound (2 flops/byte), so full f32
        # costs little; reduced-precision passes cap recall (distance.py)
        dots = jnp.einsum(
            "bd,bpld->bpl", q, blocks,
            preferred_element_type=jnp.float32, precision=PRECISE,
        )
        if cfg.metric is Metric.L2:
            dist = qn[:, None, None] + state.pnorms[src] - 2.0 * dots
        elif cfg.metric is Metric.COSINE:
            dist = 1.0 - dots
        else:
            dist = -dots

    pl_ = src.shape[1] * state.members.shape[1]
    dist = jnp.where(live, dist, INF).reshape(b, pl_)
    ids = mem.reshape(b, pl_)

    if cfg.rerank:
        # exact rerank: ONE ordering drives both the candidate ids and the
        # packed positions (a tie-inconsistent second sort would mismatch)
        r = min(cfg.rerank, pl_)
        if pl_ > 2048 and 8 * r <= pl_:
            # wide candidate rows (nprobe*L = 8k-32k lanes on the hard
            # cells): two-level exact selection instead of a full-row
            # sort (ops/topk.py)
            cd, pos = topk_smallest_wide(dist, r)     # [B, r] positions
        else:
            neg, pos = jax.lax.top_k(-dist, r)
            cd = -neg
        ci = jnp.take_along_axis(ids, pos, axis=-1)
        lcap = state.members.shape[1]
        cl = jnp.take_along_axis(
            jnp.repeat(src[:, :, None], lcap, 2).reshape(b, pl_), pos, axis=-1
        )
        ln = jnp.take_along_axis(
            jnp.broadcast_to(
                jnp.arange(pl_, dtype=jnp.int32)[None, :] % lcap, (b, pl_)
            ),
            pos, axis=-1,
        )
        flat_pos = cl * lcap + ln
        flat = state.pvecs.reshape(-1, cfg.dim)
        fnorm = state.pnorms.reshape(-1)
        if state.pvecs.dtype == jnp.uint16:
            # compact store: dequantize SQ16 from the row (min, scale)
            # the int8 codes already carry (mins holds m' = min+128*s8)
            mr = state.mins.reshape(-1)[flat_pos]
            sr = state.scales.reshape(-1)[flat_pos]
            base = mr - 128.0 * sr
            s16 = sr * (255.0 / 65535.0)
            vecs = (
                base[..., None]
                + s16[..., None] * flat[flat_pos].astype(jnp.float32)
            )
        else:
            vecs = flat[flat_pos].astype(jnp.float32)  # [B, r, d]
        dots = jnp.einsum(
            "bd,brd->br", q, vecs,
            preferred_element_type=jnp.float32, precision=PRECISE,
        )
        exact = qn[:, None] + fnorm[flat_pos] - 2.0 * dots
        exact = jnp.where(jnp.isinf(cd), INF, exact)
        if cfg.replicated or cfg.dense:
            ci, exact = mask_duplicates(ci, exact)
        return topk_smallest(exact, ci, k)
    if cfg.replicated or cfg.dense:
        # boundary replicas (and, under dense packing, shared blocks)
        # mean a slot can appear cfg.copies times in the probed lanes
        # with the SAME distance; narrow to copies*k candidates (enough
        # unique survivors), drop the later copies, re-select k
        m = min(max(2, cfg.copies) * k, pl_)
        d0, i0 = topk_smallest(dist, ids, m)
        i0, d0 = mask_duplicates(i0, d0)
        return topk_smallest(d0, i0, k)
    return topk_smallest(dist, ids, k)


# ---------------------------------------------------------------------------
# host-side handle
# ---------------------------------------------------------------------------

class IvfIndex:
    """Host orchestration: k-means training, balanced packing, incremental
    appends, tombstones. Slot ids are dense insertion indices (same
    contract as HnswIndex)."""

    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.L2,
        n_clusters: int | None = None,
        cluster_cap: int | None = None,
        nprobe: int = 8,
        sq8: bool = False,
        rerank: int | None = None,
        replicate: bool = True,
        replica_rank: int = 1,
        keep_f32: bool = True,
        dense_pack: bool = False,
        nblocks: int | None = None,
        fast_build: bool = False,
    ):
        self.dim = dim
        self.metric = metric
        # dense_pack: bin-pack whole cells into ~full physical blocks at
        # train() (IvfState.cell_block); nblocks caps how many UNIQUE
        # blocks each query gathers out of its top-nprobe cells (None =
        # gather one block per probed cell)
        self.dense_pack = dense_pack
        self.nblocks = nblocks
        # fast_build: candidate-generator profile (the HNSW bulk build's
        # throwaway self-probe index): fewer Lloyd's iterations on a
        # capped sample, NO split cascade (cap overflow spills to the
        # runner-up cell instead — tolerable there because every row
        # routes its OWN query and reverse edges re-connect it), fewer
        # rebalance rounds.
        self.fast_build = fast_build
        self._n_clusters = n_clusters
        self._cluster_cap = cluster_cap
        self.nprobe = nprobe
        self.sq8 = sq8
        # keep_f32=False stores int8 probe codes + a 16-BIT (SQ16) rerank
        # copy instead of the full f32 copy (3 bytes/dim vs 5). SQ16
        # shares the row (min, scale) the int8 codes already store, so no
        # extra metadata; its ~2^-16-of-range error leaves the final
        # ordering exact, where an 8-bit or bf16 rerank would not.
        self.keep_f32 = keep_f32 or not sq8
        # rerank=None -> auto (exact rerank is what keeps sq8 at the
        # recall gate); an EXPLICIT rerank=0 under sq8 selects the
        # probe-only store (no row copy at all — int8 codes only).
        if rerank is None:
            rerank = 64 if sq8 else 0
        self.rerank = rerank
        self.replicate = replicate
        # replica_rank: how many runner-up cells each row may replicate
        # into (SOAR-style multi-assignment). Rank 1 = the classic
        # boundary replica; higher ranks keep filling the free padding
        # lanes (split-cascade cells leave much of each block as padding,
        # and every filled lane is a probe-cost-free recall candidate)
        self.replica_rank = max(1, replica_rank)
        self.cfg: IvfConfig | None = None
        self.state: IvfState | None = None
        self.size = 0
        self._vectors_host: list[np.ndarray] = []   # staged until train
        self._alive_host = np.zeros(0, bool)
        # slot -> (cluster, lane) as flat int arrays (vectorized lookups);
        # _slot_extras holds one (cluster, lane) array pair per replica
        # rank (-1 = no copy at that rank)
        self._slot_cluster = np.zeros(0, np.int32)
        self._slot_lane = np.zeros(0, np.int32)
        self._slot_extras: list[tuple[np.ndarray, np.ndarray]] = []
        self._occupancy: np.ndarray | None = None
        self._cell_block_host: np.ndarray | None = None

    def __len__(self):
        return self.size

    # -- build -------------------------------------------------------------

    def add(self, vecs: np.ndarray, row_ids=None,
            train: bool = True) -> np.ndarray:
        """Stage (untrained) or append (trained) rows; returns their slots.
        An untrained index trains itself once enough rows are staged,
        unless `train=False` (the mesh build, parallel/sharded_ivf.py,
        trains every shard at once on its own device)."""
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        if self.metric is Metric.COSINE:
            vecs = np.asarray(normalize_rows(jnp.asarray(vecs)))
        n = vecs.shape[0]
        slots = np.arange(self.size, self.size + n)
        alive = np.ones(n, bool)
        self._alive_host = np.concatenate([self._alive_host, alive])
        if self.state is None:
            self._vectors_host.append(vecs)
            self.size += n
            if train and self.size >= 4 * max(64, int(np.sqrt(self.size))):
                self.train()
        else:
            self._append(vecs, slots)
            self.size += n
        return slots

    def train(self, iters: int | None = None, _pre=None):
        """K-means + packed layout build over all staged vectors.

        `_pre` (mesh-parallel builds, parallel/sharded_ivf.py): a
        (cents_padded, assign, xpj) triple computed by the STACKED
        per-shard k-means program — the per-shard finish (rebalance,
        split, pack, replicas) then runs here against the provided
        device arrays instead of re-running k-means."""
        import os

        from turdb_tpu.utils.timing import PhaseTimer

        dbg = os.environ.get("TURDB_IVF_DEBUG") == "1"
        pt = PhaseTimer(enabled=dbg)

        def mark(label, *arrays):
            pt.mark(label, *arrays)

        x = (
            np.concatenate(self._vectors_host)
            if self._vectors_host
            else np.zeros((0, self.dim), np.float32)
        )
        n = x.shape[0]
        if n == 0:
            return
        # sizing: the probe is gather-bound at scale, so the f32
        # row-store engine takes FEWER, BIGGER contiguous blocks at
        # >=500k rows: n//128 target cells (-> cap 256 via the 2n/c
        # rule) instead of n//64, at dim <= 256 only (block bytes scale
        # with L*dim). The sq8/compact store keeps the denser n//64
        # layout (its probe moves 4x fewer bytes, and doubling L doubles
        # its memory at 10M scale). Which geometry wins on a given device
        # is a measurement (ROADMAP Queue 1); test_headline_geometry pins
        # the current rule.
        big_blocks = n >= 500_000 and not self.sq8 and self.dim <= 256
        c = self._n_clusters or max(8, n // (128 if big_blocks else 64))
        c = min(c, max(8, n // 4))
        # pad the WORKING centroid count to the shape bucket up front, so
        # _kmeans and _assign_all compile once per bucket instead of once
        # per dataset. Pad cells sit at 1e15 (finite: bf16/f32 products
        # stay non-NaN) with +inf cnorms so they never win.
        c_work = _cpad(c)
        rng = np.random.default_rng(0)
        seed_idx = rng.choice(n, size=c, replace=False)
        # train on a sample (faiss-style), then assign everything chunked.
        # ~64 points/centroid minimum: round-1 capped this at 262k, which
        # left 16 pts/centroid at 1M/15.6k clusters — centroids too noisy,
        # cells overlap, recall saturated at 0.92 (the k-means matmuls are
        # ~4 TFLOP/iter at 1M x 15.6k x 128). The 4M ceiling keeps
        # 10M-scale trains at >=25 pts/centroid.
        n_train = min(n, max(c * 64, 100_000), 4_194_304)
        if iters is None:
            iters = 4 if self.fast_build else 8
        if self.fast_build:
            # candidate-generator profile: a 256k sample keeps centroids
            # good enough for top-r candidate membership at 1/4 the
            # Lloyd's cost (the diversity-selection pass re-scores every
            # candidate exactly downstream)
            n_train = min(n_train, 262_144)
        tr_idx = (
            rng.choice(n, size=n_train, replace=False) if n_train < n
            else np.arange(n)
        )
        # ONE host->device upload (not one each for the train sample,
        # assignment and packing); the train sample is a device gather
        if _pre is not None:
            cents, assign, xpj = _pre
            cents = jnp.asarray(cents)
            assign = np.asarray(assign)[:n]
            if xpj is None:
                xpj = jnp.asarray(_pad_rows(x, _KM_CHUNK))
            c_work = cents.shape[0]
            xtj = xpj if n_train == n else _pad_rows_dev(
                xpj[jnp.asarray(tr_idx)], _KM_CHUNK
            )
            mark("pre")
        else:
            xpj = jnp.asarray(_pad_rows(x, _KM_CHUNK))
            if n_train == n:
                xtj = xpj
            else:
                xtj = _pad_rows_dev(xpj[jnp.asarray(tr_idx)], _KM_CHUNK)
            init = jnp.concatenate([
                xpj[jnp.asarray(seed_idx)],
                jnp.full((c_work - c, self.dim), _PAD_CENT, jnp.float32),
            ]) if c_work > c else xpj[jnp.asarray(seed_idx)]
            cents = _kmeans(xtj, init, iters=iters)
            mark("kmeans", cents)
            assign = np.asarray(
                _assign_all(xpj, cents, _masked_cn(cents, c))
            )[:n]
            mark("assign")
        cap = self._cluster_cap or _pow2_at_least(
            max(int(2.0 * n / c), 16), floor=8
        )
        # balance repair (faiss-style): Lloyd's on blobby data leaves the
        # seed-count-per-blob Poisson variance in place — some centroids
        # swallow 2-3x the cap while others starve. Re-seed STARVED
        # centroids (not only empty ones — round-2a's empty-only loop left
        # ~40% of cells oversized and the split cascade then exploded the
        # cell count ~2.5x into 15-25-row cells, wasting ~85% of every
        # probe's bandwidth on padding) as perturbed copies of oversized
        # donors, then re-run a couple of device Lloyd iterations.
        for rnd in range(2 if self.fast_build else 6):
            counts = np.bincount(assign, minlength=c)
            over = np.flatnonzero(counts > cap)
            if len(over) == 0:
                break
            order = np.argsort(counts)
            starved = order[counts[order] < max(1, cap // 4)]
            starved = starved[starved < c]
            if len(starved) == 0:
                break
            cents_np = np.array(cents)
            # each donor contributes one seed per cap-multiple of excess
            want = np.maximum(counts[over] // cap, 1)
            donors = np.repeat(over, want)[: len(starved)]
            rloc = np.random.default_rng(7 + rnd)
            sigma = 1e-3 * (np.abs(cents_np[donors]).mean() + 1.0)
            cents_np[starved[: len(donors)]] = cents_np[donors] + sigma * (
                rloc.standard_normal((len(donors), self.dim)).astype(np.float32)
            )
            cents = _kmeans(xtj, jnp.asarray(cents_np), iters=2)
            assign = np.asarray(_assign_all(xpj, cents, _masked_cn(cents, c)))[:n]
        mark("rebalance")
        # split oversized clusters (local 2-means) instead of spilling rows
        # to far clusters: a spilled row is invisible to centroid probing
        # (measured: spill victims' clusters rank ~78-255th for their
        # queries, capping recall at ~0.946 however many probes)
        c0 = c
        if self.fast_build:
            # no split cascade: overflow rows spill to their runner-up
            # cell in _place_spill below. A spilled row is invisible to
            # probes of its TRUE cell, but in the self-probe build it
            # still issues its own query and reverse edges re-connect it
            cents_np = np.asarray(cents)[:c]
        else:
            cents_np, assign = _split_oversized(
                np.asarray(cents)[:c], assign, x, cap, xpj=xpj
            )
        c = cents_np.shape[0]
        # re-pad the working set after the split changed C
        c_work = _cpad(c)
        if c_work > c:
            cents_np = np.concatenate([
                cents_np,
                np.full((c_work - c, self.dim), _PAD_CENT, np.float32),
            ])
        cents = jnp.asarray(cents_np)
        mark(f"split({c0}->{c})")
        counts = np.bincount(assign, minlength=c)
        # balanced packing, fully vectorized: stable-sort by cluster, lane =
        # rank within the cluster run; lanes past the cap spill to the
        # nearest cluster with free lanes (rare with cap >= 2x mean)
        members = np.full((c, cap), -1, np.int64)
        occupancy = np.zeros(c, np.int64)
        order = np.argsort(assign, kind="stable")
        sa = assign[order]
        first = np.zeros(n, bool)
        first[0] = True
        first[1:] = sa[1:] != sa[:-1]
        run_start = np.flatnonzero(first)
        start_of = np.zeros(c, np.int64)
        start_of[sa[run_start]] = run_start
        lane = np.arange(n) - start_of[sa]
        ok = lane < cap
        members[sa[ok], lane[ok]] = order[ok]
        occupancy = np.minimum(np.bincount(assign, minlength=c), cap)
        spill = order[~ok]
        if len(spill):
            self._place_spill(
                np.asarray(spill), x, np.asarray(cents), members, occupancy,
                cap,
            )
        self._occupancy = occupancy
        mark("pack+spill")
        # slot -> (cluster, lane) as flat arrays (vectorized mask builds);
        # primaries first, BEFORE replicas land in members
        self._slot_cluster = np.full(n, -1, np.int32)
        self._slot_lane = np.full(n, -1, np.int32)
        self._slot_extras = [
            (np.full(n, -1, np.int32), np.full(n, -1, np.int32))
            for _ in range(self.replica_rank)
        ]
        mc, ml = np.nonzero(members >= 0)
        mslots = members[mc, ml]
        self._slot_cluster[mslots] = mc
        self._slot_lane[mslots] = ml
        replicated = False
        if self.replicate and n > c:
            replicated = self._place_replicas(
                x, cents_np, members, occupancy, cap, xpj=xpj
            )
        mark("replicas")
        cell_block_np = None
        if self.dense_pack:
            members, occupancy, cell_block_np = self._dense_remap(
                cents_np[:c], members[:c], occupancy[:c], cap,
            )
            mark(f"dense({c}->{members.shape[0]})")
        # pad the cluster count to a power of two: C is a STATIC shape in
        # every packed-state and search program, and the split outcome
        # varies per dataset — padding buckets the shapes so the scatter/
        # probe programs compile once per bucket, not once per train().
        # Pad centroids
        # are ZERO vectors whose cnorms are forced to +inf below (a +inf
        # centroid would turn q·c into inf*0 = NaN and poison the top-k);
        # members -1, occupancy full.
        c_real = c
        cpad = _cpad(c)
        if cpad != c:
            # cents_np is already cpad rows (working pad); zero the pad
            # rows for the stored state (cnorms force +inf below either
            # way, but zeros keep snapshots tidy)
            cents_np = np.array(cents_np[:cpad])
            cents_np[c:] = 0.0
            cents = jnp.asarray(cents_np)
            if cell_block_np is None:
                members = np.concatenate([
                    members, np.full((cpad - c, cap), -1, np.int64)
                ])
                occupancy = np.concatenate([
                    occupancy, np.full(cpad - c, cap, np.int64)
                ])
                self._occupancy = occupancy
            else:
                # pad cells map to block 0: cnorms=+inf keeps them out of
                # every top-nprobe, and a stray gather of a real block
                # only adds real rows as candidates (correct either way)
                cell_block_np = np.concatenate([
                    cell_block_np, np.zeros(cpad - c, np.int32)
                ])
            c = cpad
        self.cfg = IvfConfig(
            dim=self.dim, n_clusters=c, cluster_cap=cap, metric=self.metric,
            nprobe=self.nprobe, sq8=self.sq8, rerank=self.rerank,
            replicated=replicated or self.dense_pack,
            dense=self.dense_pack,
            copies=(self.replica_rank + 1) if replicated else 2,
        )
        mc, ml = np.nonzero(members >= 0)       # now includes replicas
        mslots = members[mc, ml]
        # pack CHUNKED with buffer DONATION — whole-array encodes
        # materialize several [n, d] f32 temporaries (tens of GB at
        # 10M x 128d). Above ~2.5GB of source data, additionally
        # FREE the padded device copy first and re-upload rows per chunk
        # from the host: the packed stores + the full f32 source cannot
        # coexist at 10M scale.
        stream = n * self.dim * 4 > 2_500_000_000
        if stream:
            # drop EVERY reference to the padded device copy (xtj aliases
            # it when the train sample is the whole set)
            xd = None
            xpj = None
            xtj = None
        else:
            xd = xpj
        mcj = jnp.asarray(mc)
        mlj = jnp.asarray(ml)
        mslj = jnp.asarray(mslots)
        nm = len(mslots)
        # probe-only: sq8 probe with no rerank never reads pvecs (the
        # search trace under cfg.rerank == 0 touches codes/mins/scales/
        # pnorms only) — skip the rerank row store entirely. This is the
        # HNSW bulk build's candidate-generation index, which never
        # reranks.
        probe_only = self.sq8 and not self.keep_f32 and not self.rerank
        nstore = members.shape[0]       # physical blocks (== c unless dense)
        if probe_only:
            jp = jnp.zeros((1, 1, 1), jnp.uint16)
        elif self.keep_f32:
            jp = jnp.zeros((nstore, cap, self.dim), jnp.float32)
        else:
            jp = jnp.zeros((nstore, cap, self.dim), jnp.uint16)
        if self.sq8:
            codes = jnp.zeros((nstore, cap, self.dim), jnp.int8)
            mins = jnp.zeros((nstore, cap), jnp.float32)
            scales = jnp.zeros((nstore, cap), jnp.float32)
        else:
            # placeholders: cfg.sq8 is STATIC, so the search trace never
            # touches these — full-shape zeros would waste ~C*L*d bytes of
            # HBM (640MB at 1M x 128d)
            codes = jnp.zeros((1, 1, 1), jnp.int8)
            mins = jnp.zeros((1, 1), jnp.float32)
            scales = jnp.zeros((1, 1), jnp.float32)
        pnorms = jnp.full((nstore, cap), INF, jnp.float32)
        ch = 1 << 20
        if stream:
            for s in range(0, nm, ch):
                e = min(nm, s + ch)  # tail chunk = one extra compile, ok
                jp, codes, mins, scales, pnorms = _pack_chunk(
                    jp, codes, mins, scales, pnorms,
                    jnp.asarray(x[mslots[s:e]]), mcj[s:e], mlj[s:e],
                    sq8=self.sq8, keep_f32=self.keep_f32,
                    probe_only=probe_only,
                )
        else:
            ch_eff = min(ch, nm)
            for s in range(0, nm, max(ch_eff, 1)):
                jp, codes, mins, scales, pnorms = _pack_chunk_idx(
                    jp, codes, mins, scales, pnorms,
                    xd, mslj, mcj, mlj, s,
                    sq8=self.sq8, keep_f32=self.keep_f32,
                    probe_only=probe_only, ch=ch_eff,
                )
        alive = np.zeros((nstore, cap), bool)
        alive[mc, ml] = self._alive_host[mslots]
        cn_full = prep_norms(jnp.asarray(cents))
        if c_real != c:
            # pad cells can never win a probe slot
            cn_full = cn_full.at[c_real:].set(jnp.inf)
        self.state = IvfState(
            centroids=jnp.asarray(cents),
            cnorms=cn_full,
            members=jnp.asarray(members.astype(np.int32)),
            pvecs=jp,
            pnorms=pnorms,
            alive=jnp.asarray(alive),
            codes=codes,
            mins=mins,
            scales=scales,
            cell_block=(
                None if cell_block_np is None else jnp.asarray(cell_block_np)
            ),
        )
        self._vectors_host = []
        if dbg:
            st = self.state
            mark("pack-store", st.pnorms, st.codes if self.sq8 else None,
                 None if probe_only else st.pvecs)
            import sys

            total = sum(s for _, s in pt.spans)
            print(f"[ivf.train n={n} C={c} L={cap} {total:.1f}s: "
                  f"{pt.table()}]", file=sys.stderr, flush=True)

    def _dense_remap(self, cents_np, members, occupancy, cap):
        """Bin-pack whole cells into dense physical blocks (cfg.dense).

        Cells stay the probe-SELECTION unit — fine centroids keep recall
        per scanned row (docs/PERF.md hard-distribution study: at equal
        scanned rows finer partitions win) — while storage blocks become
        the GATHER unit at ~full occupancy. Packing order is locality-
        aware (cells grouped by one nearest-center assignment pass over
        the centroids, first-fit-decreasing within a group), so a probed
        cell's block carries its spatial neighborhood: co-blocked rows
        act like SOAR replicas, and nearby cells collapse onto shared
        blocks, which is what lets `nblocks` unique gathers cover
        `nprobe` logical cells (ivf_search_impl / _first_unique).

        Remaps members [c, cap] -> [NBpad, cap], per-cell occupancy ->
        per-block fill, and the slot->(cluster, lane) bookkeeping to
        block coordinates. Returns (members, fill, cell_block)."""
        c = len(occupancy)
        occ = np.asarray(occupancy, np.int64)
        total = int(occ.sum())
        ng = _pow2_at_least(max(1, total // (8 * cap)), floor=1)
        if ng > 1 and c > ng:
            rngp = np.random.default_rng(11)
            pick = rngp.choice(c, size=ng, replace=False)
            gc = jnp.asarray(np.asarray(cents_np[pick], np.float32))
            xp = jnp.asarray(_pad_rows(np.asarray(cents_np, np.float32),
                                       _KM_CHUNK))
            ga = np.asarray(_assign_all(xp, gc, prep_norms(gc)))[:c]
        else:
            ga = np.zeros(c, np.int64)
        order = np.lexsort((-occ, ga))   # group asc, occupancy desc
        blk = np.zeros(c, np.int32)
        off = np.zeros(c, np.int64)
        cur, fill = 0, 0
        fills = [0]
        for cell in order:
            o = int(occ[cell])
            if fill + o > cap:
                cur += 1
                fill = 0
                fills.append(0)
            blk[cell] = cur
            off[cell] = fill
            fill += o
            fills[cur] = fill
        nb = cur + 1
        nbp = _cpad(nb)
        bm = np.full((nbp, cap), -1, np.int64)
        mc0, ml0 = np.nonzero(members >= 0)   # lanes contiguous per cell
        bm[blk[mc0], off[mc0] + ml0] = members[mc0, ml0]
        bfill = np.full(nbp, cap, np.int64)   # pad blocks: full
        bfill[:nb] = np.asarray(fills, np.int64)
        for sc, sl in ((self._slot_cluster, self._slot_lane),
                       *self._slot_extras):
            mk = sc >= 0
            sl[mk] = (off[sc[mk]] + sl[mk]).astype(np.int32)
            sc[mk] = blk[sc[mk]]
        self._occupancy = bfill
        self._cell_block_host = blk
        return bm, bfill, blk

    @staticmethod
    def _place_spill(spill, x, cents_np, members, occupancy, cap):
        """Capacity-respecting spill placement, vectorized in waves: each
        wave computes spill→centroid distances (full clusters masked out),
        sorts rows into their argmin cluster by distance, and accepts only
        as many as each cluster has free lanes; leftovers retry against the
        updated occupancy. Rounds are logarithmic in practice."""
        remaining = spill
        c = len(occupancy)
        cents_dev = jnp.asarray(cents_np)
        base_cn = (cents_np**2).sum(1)
        cw = len(cents_np)          # may exceed c by shape-bucket padding
        for _round in range(64):
            if len(remaining) == 0:
                return
            free = cap - occupancy
            if free.sum() < len(remaining):
                raise RuntimeError("IVF packing overflow; raise cluster_cap")
            # nearest FREE cluster, computed on device in chunks (a host
            # [S, C] matrix would be tens of GB at 1M scale)
            free_w = np.zeros(cw, np.int64)
            free_w[:c] = free
            cn = np.where(free_w > 0, base_cn, np.inf).astype(np.float32)
            xs_pad = _pad_rows(x[remaining], _KM_CHUNK)
            pick = np.asarray(
                _assign_all(jnp.asarray(xs_pad), cents_dev, jnp.asarray(cn))
            )[: len(remaining)]
            o = np.argsort(pick, kind="stable")
            sp, pk = remaining[o], pick[o]
            firsts = np.zeros(len(o), bool)
            firsts[0] = True
            firsts[1:] = pk[1:] != pk[:-1]
            starts = np.flatnonzero(firsts)
            start_of = np.zeros(c, np.int64)
            start_of[pk[starts]] = starts
            rank = np.arange(len(o)) - start_of[pk]
            accept = rank < free[pk]
            lanes = occupancy[pk[accept]] + rank[accept]
            members[pk[accept], lanes] = sp[accept]
            np.add.at(occupancy, pk[accept], 1)
            remaining = sp[~accept]
        raise RuntimeError("IVF spill placement did not converge")

    def _place_replicas(self, x, cents_np, members, occupancy, cap,
                        xpj=None) -> bool:
        """Boundary-row replication into FREE padding lanes (SOAR-style
        multi-assignment, memory- and probe-cost-free): every probe reads
        all `cap` lanes of a cluster whether occupied or not, so filling
        the padding with copies of the rows nearest the cell boundary —
        placed in their runner-up cluster(s) — recovers the recall that
        cell overlap loses, at zero extra search cost. Duplicated ids are
        dropped at top-k (ivf_search_impl, cfg.replicated). Fixes the
        round-1 1M jittered-data saturation at 0.92.

        replica_rank > 1 runs one acceptance wave per runner-up rank
        (nearest non-home cell first): about 70% of gathered
        block bytes at the big-block headline geometry were padding —
        later waves keep converting that padding into candidates."""
        n = x.shape[0]
        c = len(occupancy)
        ranks = self.replica_rank
        # keep cap//8 lanes per cluster free for incremental appends —
        # replicas in every lane would force a full retrain on first append
        free = np.maximum(cap - occupancy - max(1, cap // 8), 0)
        if free.sum() == 0:
            return False
        if xpj is None:
            xpj = jnp.asarray(_pad_rows(x, _KM_CHUNK))
        cents_j = jnp.asarray(cents_np)
        kk = min(ranks + 1, c)
        a12, d12 = _assign_topk_all(xpj, cents_j, _masked_cn(cents_j, c),
                                    k=kk)
        a12 = np.asarray(a12)[:n].astype(np.int64)
        d12 = np.asarray(d12)[:n]
        placed = self._slot_cluster[:n].astype(np.int64)
        # exact d² to the home centroid, chunked to bound temporaries
        # (split/spilled rows may live away from their argmin cell — those
        # benefit the most, so they rank first via the d_tgt/d_home prio)
        d_home = np.empty(n, np.float32)
        for s in range(0, n, 1 << 17):
            e = min(n, s + (1 << 17))
            diff = x[s:e] - cents_np[placed[s:e]]
            d_home[s:e] = np.einsum("ij,ij->i", diff, diff)
        d_home = np.maximum(d_home, 1e-12)
        # per-row ranked NON-HOME targets: drop the home column, keep
        # nearest-first order (each row's rank-r target is its (r+1)-th
        # nearest cell overall when rank 1..r-1 are all non-home)
        is_home = a12 == placed[:, None]
        key = np.where(is_home, np.inf, d12)
        order_cols = np.argsort(key, axis=1, kind="stable")
        placed_any = False
        for r in range(min(ranks, kk - 1)):
            col = order_cols[:, r]
            rows = np.arange(n)
            tgt = a12[rows, col]
            d_tgt = d12[rows, col]
            ok = np.isfinite(key[rows, col])
            prio = np.where(ok, d_tgt / d_home, np.inf)
            order = np.argsort(prio, kind="stable")
            order = order[ok[order]]
            # acceptance wave: rank rows within their target cluster in
            # priority order; accept rank < free lanes
            pk = tgt[order]
            o2 = np.argsort(pk, kind="stable")
            sp, pk = order[o2], pk[o2]
            if len(sp) == 0:
                break
            firsts = np.zeros(len(sp), bool)
            firsts[0] = True
            firsts[1:] = pk[1:] != pk[:-1]
            starts = np.flatnonzero(firsts)
            start_of = np.zeros(c, np.int64)
            start_of[pk[starts]] = starts
            rank = np.arange(len(sp)) - start_of[pk]
            accept = rank < free[pk]
            if not accept.any():
                continue
            lanes = occupancy[pk[accept]] + rank[accept]
            rslots = sp[accept]
            members[pk[accept], lanes] = rslots
            add = np.bincount(pk[accept], minlength=c)
            occupancy += add
            free -= add
            sc, sl = self._slot_extras[r]
            sc[rslots] = pk[accept]
            sl[rslots] = lanes
            placed_any = True
        return placed_any

    def _append(self, vecs: np.ndarray, slots: np.ndarray):
        """Incremental append: route each vector to its nearest cluster
        with a free lane (device assignment, host scatter bookkeeping)."""
        st = self.state
        cfg = self.cfg
        if st.pvecs.shape == (1, 1, 1) and self.sq8 and not self.keep_f32:
            raise RuntimeError(
                "probe-only IVF index (sq8, rerank=0, no row store) does "
                "not support incremental appends; rebuild with train()"
            )
        d2c = np.asarray(
            prep_norms(jnp.asarray(vecs))[:, None]
            + st.cnorms[None, :]
            - 2.0 * jnp.asarray(vecs) @ st.centroids.T
        )
        order = np.argsort(d2c, axis=1)
        cb = self._cell_block_host if cfg.dense else None
        cs, lanes = [], []
        for j in range(len(vecs)):
            placed = False
            for a in order[j]:
                # dense: a row "appends to cell a" by landing in ANY free
                # lane of a's physical block (blocks are gathered whole,
                # so lane position within the block is immaterial)
                if cb is not None:
                    if a >= len(cb):
                        continue        # pad cell (cnorms +inf)
                    a = int(cb[a])
                if self._occupancy[a] < cfg.cluster_cap:
                    cs.append(int(a))
                    lanes.append(int(self._occupancy[a]))
                    self._occupancy[a] += 1
                    placed = True
                    break
            if not placed:
                # all clusters full: retrain with everything. Pass the WHOLE
                # batch — vecs[:j] only reserved occupancy so far; no state
                # write has happened yet and train() rebuilds occupancy.
                self._retrain_with(vecs, slots)
                return
        cs = np.asarray(cs)
        lanes = np.asarray(lanes)
        jv = jnp.asarray(vecs)
        st = st._replace(
            members=st.members.at[cs, lanes].set(slots.astype(np.int32)),
            pnorms=st.pnorms.at[cs, lanes].set(prep_norms(jv)),
            alive=st.alive.at[cs, lanes].set(True),
        )
        if cfg.sq8:
            codes_u8, mins, scales = sq8_encode(jv)
            st = st._replace(
                codes=st.codes.at[cs, lanes].set(
                    (codes_u8.astype(jnp.int16) - 128).astype(jnp.int8)
                ),
                mins=st.mins.at[cs, lanes].set(mins + 128.0 * scales),
                scales=st.scales.at[cs, lanes].set(scales),
            )
            if st.pvecs.dtype == jnp.uint16:
                s16 = scales * (255.0 / 65535.0)
                safe16 = jnp.where(s16 == 0, 1.0, s16)
                u16 = jnp.clip(
                    jnp.round((jv - mins[:, None]) / safe16[:, None]),
                    0, 65535,
                ).astype(jnp.uint16)
                st = st._replace(pvecs=st.pvecs.at[cs, lanes].set(u16))
            else:
                st = st._replace(pvecs=st.pvecs.at[cs, lanes].set(jv))
        else:
            st = st._replace(pvecs=st.pvecs.at[cs, lanes].set(jv))
        self.state = st
        need = int(slots.max()) + 1
        if need > len(self._slot_cluster):
            grow = need - len(self._slot_cluster)
            pad = np.full(grow, -1, np.int32)
            self._slot_cluster = np.concatenate([self._slot_cluster, pad])
            self._slot_lane = np.concatenate([self._slot_lane, pad.copy()])
            self._slot_extras = [
                (np.concatenate([sc, pad.copy()]),
                 np.concatenate([sl, pad.copy()]))
                for sc, sl in self._slot_extras
            ]
        self._slot_cluster[slots] = cs
        self._slot_lane[slots] = lanes

    def _retrain_with(self, extra_vecs, extra_slots):
        # collect all live vectors + extras, retrain from scratch
        st0 = self.state
        if st0.pvecs.dtype == jnp.uint16:
            base = st0.mins - 128.0 * st0.scales
            s16 = st0.scales * (255.0 / 65535.0)
            flat = np.asarray(
                base[..., None]
                + s16[..., None] * st0.pvecs.astype(jnp.float32)
            ).reshape(-1, self.dim)
        else:
            flat = np.asarray(
                st0.pvecs.astype(jnp.float32)
            ).reshape(-1, self.dim)
        mem = np.asarray(self.state.members).reshape(-1)
        extra_slots = np.atleast_1d(np.asarray(extra_slots, np.int64))
        hi = int(extra_slots.max()) + 1 if len(extra_slots) else 0
        xs = np.zeros((max(self.size, hi), self.dim), np.float32)
        ok = mem >= 0
        xs[mem[ok]] = flat[ok]          # replica copies rewrite same data
        xs[extra_slots] = extra_vecs
        self._vectors_host = [xs]
        self.state = None
        self.train()

    # -- query -------------------------------------------------------------

    def search(self, queries, k: int, nprobe: int | None = None, allowed=None,
               out: str = "np"):
        """allowed: bool[size] slot-visibility mask. Returns (dists, slots).

        `queries` may be a device (jax) array — recommended for serving
        loops: host->device staging dominates otherwise. `out="jax"` keeps
        results on device for pipelining."""
        is_dev = isinstance(queries, jax.Array)
        q = queries if is_dev else jnp.asarray(
            np.atleast_2d(np.asarray(queries, np.float32))
        )
        if self.state is None:
            self.train()
        if self.state is None or self.size == 0:
            return (
                np.full((q.shape[0], k), np.inf, np.float32),
                np.full((q.shape[0], k), -1, np.int32),
            )
        if self.metric is Metric.COSINE:
            q = normalize_rows(q)
        p = min(nprobe or self.nprobe, self.cfg.n_clusters)
        nb_arg = self.nblocks if self.cfg.dense else None
        amask = None
        if allowed is not None:
            allowed = np.asarray(allowed, bool)
            # mask in PHYSICAL block coordinates (== cells unless dense)
            am = np.zeros(
                (self.state.members.shape[0], self.cfg.cluster_cap), bool
            )
            m = min(len(allowed), len(self._slot_cluster))
            sel = np.flatnonzero(allowed[:m] & (self._slot_cluster[:m] >= 0))
            am[self._slot_cluster[sel], self._slot_lane[sel]] = True
            for sc, sl in self._slot_extras:
                sel2 = np.flatnonzero(allowed[:m] & (sc[:m] >= 0))
                am[sc[sel2], sl[sel2]] = True
            amask = jnp.asarray(am)
        # cap the probe batch so the [B, P, L, d] gather (+ the int8
        # path's s32 widening) stays <=~512MB of program temp beside a
        # multi-GB index state (ROADMAP debt 7: derive from device memory)
        p_eff = min(p, nb_arg) if nb_arg else p
        bmax = max(
            64, (1 << 27) // (p_eff * self.cfg.cluster_cap * self.dim)
        )
        if q.shape[0] > bmax:
            parts = [
                ivf_search_impl(
                    self.state, q[s : s + bmax], amask,
                    cfg=self.cfg, k=k, nprobe=p, nblocks=nb_arg,
                )
                for s in range(0, q.shape[0] - bmax + 1, bmax)
            ]
            tail = q.shape[0] % bmax
            if tail:
                # pad the tail to the shared shape (no extra compile)
                qt = jnp.concatenate(
                    [q[-tail:], jnp.zeros((bmax - tail, q.shape[1]),
                                          q.dtype)]
                )
                td, ti = ivf_search_impl(
                    self.state, qt, amask, cfg=self.cfg, k=k, nprobe=p,
                    nblocks=nb_arg,
                )
                parts.append((td[:tail], ti[:tail]))
            d = jnp.concatenate([pd for pd, _ in parts])
            ids = jnp.concatenate([pi for _, pi in parts])
        else:
            d, ids = ivf_search_impl(
                self.state, q, amask, cfg=self.cfg, k=k, nprobe=p,
                nblocks=nb_arg,
            )
        if out == "jax":
            return d, ids
        return np.asarray(d), np.asarray(ids)

    def delete(self, slots):
        slots = np.atleast_1d(np.asarray(slots)).astype(np.int64)
        in_range = slots[slots < len(self._alive_host)]
        self._alive_host[in_range] = False
        if self.state is None:
            return
        m = in_range[in_range < len(self._slot_cluster)]
        m = m[self._slot_cluster[m] >= 0]
        if len(m):
            alive = self.state.alive.at[
                self._slot_cluster[m], self._slot_lane[m]
            ].set(False)
            for sc, sl in self._slot_extras:
                r = m[sc[m] >= 0]
                if len(r):
                    alive = alive.at[sc[r], sl[r]].set(False)
            self.state = self.state._replace(alive=alive)


@partial(jax.jit, static_argnames=("iters",))
def _two_means_batched(pts, valid, iters: int = 6):
    """2-means over MANY clusters at once: pts [O, L, d] (lane-padded),
    valid [O, L]. Seeds = lane 0 and the member farthest from it. Returns
    (labels [O, L] in {0,1}, c2 [O, 2, d]). Distances go through the
    dot-product identity so nothing [O, L, 2, d]-shaped materializes."""
    pn = jnp.where(valid, jnp.sum(pts * pts, axis=-1), jnp.inf)  # [O, L]
    a = pts[:, 0]                                                # [O, d]
    d0 = pn - 2.0 * jnp.einsum(
        "old,od->ol", pts, a, preferred_element_type=jnp.float32
    )
    far = jnp.argmax(jnp.where(valid, d0, -jnp.inf), axis=1)
    b = jnp.take_along_axis(pts, far[:, None, None], axis=1)[:, 0]
    c2 = jnp.stack([a, b], axis=1)                               # [O, 2, d]
    w = valid.astype(jnp.float32)

    def step(c2, _):
        cn = jnp.sum(c2 * c2, axis=-1)                           # [O, 2]
        d = pn[:, :, None] + cn[:, None, :] - 2.0 * jnp.einsum(
            "old,ogd->olg", pts, c2, preferred_element_type=jnp.float32
        )
        lab = jnp.argmin(d, axis=-1)                             # [O, L]
        w1 = w * lab.astype(jnp.float32)
        w0 = w - w1
        s0 = jnp.einsum("ol,old->od", w0, pts)
        s1 = jnp.einsum("ol,old->od", w1, pts)
        n0 = jnp.maximum(jnp.sum(w0, axis=1), 1.0)[:, None]
        n1 = jnp.maximum(jnp.sum(w1, axis=1), 1.0)[:, None]
        return jnp.stack([s0 / n0, s1 / n1], axis=1), None

    c2, _ = jax.lax.scan(step, c2, None, length=iters)
    cn = jnp.sum(c2 * c2, axis=-1)
    d = pn[:, :, None] + cn[:, None, :] - 2.0 * jnp.einsum(
        "old,ogd->olg", pts, c2, preferred_element_type=jnp.float32
    )
    return jnp.argmin(d, axis=-1).astype(jnp.int32), c2


_SPLIT_OCHUNK = 512  # oversized clusters per device batch


def _split_oversized(cents: np.ndarray, assign: np.ndarray, x: np.ndarray,
                     cap: int, max_rounds: int = 12, xpj=None):
    """Split clusters whose population exceeds the lane cap into two via
    local 2-means, repeating until everything fits (or rounds run out —
    leftovers then spill in packing, which only happens for pathological
    duplicates). Keeps every row NEAR its own centroid, which is what
    makes it reachable by centroid probing. All oversized clusters in a
    round run as ONE batched device 2-means (the same math as [O]
    simultaneous jobs of _two_means_batched) instead of a serial host
    loop."""
    cents = np.array(cents, np.float32)
    assign = np.array(assign)
    d = x.shape[1]
    lmax = 0
    for _ in range(max_rounds):
        counts = np.bincount(assign, minlength=len(cents))
        over = np.flatnonzero(counts > cap)
        if len(over) == 0:
            break
        # members of each oversized cluster, padded to a shared power-of-2
        # lane width; lmax never SHRINKS across rounds — populations only
        # drop after a split, and a fresh (smaller) shape would cost a new
        # compile per round
        order = np.argsort(assign, kind="stable")
        sa = assign[order]
        starts = np.searchsorted(sa, over, side="left")
        lmax = max(lmax, _pow2_at_least(int(counts[over].max()), floor=32))
        new_cents = []
        n_new = 0
        for s in range(0, len(over), _SPLIT_OCHUNK):
            e = min(len(over), s + _SPLIT_OCHUNK)
            oc, ost = over[s:e], starts[s:e]
            ocnt = counts[oc]
            o = len(oc)
            opad = o if o == _SPLIT_OCHUNK else _pow2_at_least(o, floor=8)
            idx = np.zeros((opad, lmax), np.int64)
            valid = np.zeros((opad, lmax), bool)
            lane = np.arange(lmax)
            vo = lane[None, :] < ocnt[:, None]
            # row ids: order[start + lane] where valid (clip keeps gathers
            # in-bounds; invalid lanes carry weight 0)
            flat = np.clip(ost[:, None] + lane[None, :], 0, len(order) - 1)
            idx[:o] = order[flat]
            valid[:o] = vo
            if xpj is not None:
                # gather member rows ON DEVICE instead of a host gather +
                # 512MB upload per chunk
                pts = xpj[jnp.asarray(idx)]
            else:
                pts = jnp.asarray(x[idx.reshape(-1)].reshape(opad, lmax, d))
            lab, c2 = _two_means_batched(pts, jnp.asarray(valid))
            lab = np.asarray(lab)[:o]
            c2 = np.asarray(c2)[:o]
            cents[oc] = c2[:, 0]
            move = valid[:o] & (lab == 1)
            # each oversized cluster's side-1 rows move to one new cluster;
            # unsplittable clusters (all-duplicate rows -> side 1 empty)
            # get no new centroid and fall through to packing spill
            nz = move.any(axis=1)
            new_ids = np.full(o, -1, np.int64)
            new_ids[nz] = len(cents) + n_new + np.arange(int(nz.sum()))
            rows = idx[:o][move]
            assign[rows] = np.repeat(new_ids, move.sum(axis=1))
            new_cents.append(c2[nz, 1])
            n_new += int(nz.sum())
        if new_cents:
            cents = np.concatenate([cents] + new_cents)
    return cents, assign


@partial(
    jax.jit,
    static_argnames=("sq8", "keep_f32", "probe_only"),
    donate_argnums=(0, 1, 2, 3, 4),
)
def _pack_chunk(jp, codes, mins, scales, pnorms, xb, mc_, ml_,
                *, sq8: bool, keep_f32: bool, probe_only: bool = False):
    """One packing chunk: quantize the gathered rows (when sq8) and
    scatter into the donated packed buffers. Donation keeps the big
    accumulators in-place — eager .at[].set would copy the multi-GB
    arrays per chunk. probe_only skips the rerank row store entirely
    (int8 probe codes are the only consumer when rerank == 0)."""
    return _pack_body(jp, codes, mins, scales, pnorms, xb, mc_, ml_,
                      sq8=sq8, keep_f32=keep_f32, probe_only=probe_only)


@partial(
    jax.jit,
    static_argnames=("sq8", "keep_f32", "probe_only", "ch"),
    donate_argnums=(0, 1, 2, 3, 4),
)
def _pack_chunk_idx(jp, codes, mins, scales, pnorms, xd, mslj, mcj, mlj,
                    s, *, sq8: bool, keep_f32: bool, probe_only: bool,
                    ch: int):
    """Packing chunk with the row gather fused in: the chunk window is a
    clamped dynamic slice from a DEVICE start scalar, so every chunk of
    a build shares ONE compile (an eager slice+gather per chunk would
    compile per chunk shape; clamp overlap rewrites identical values,
    which is idempotent)."""
    idx = jax.lax.dynamic_slice_in_dim(mslj, s, ch)
    mc_ = jax.lax.dynamic_slice_in_dim(mcj, s, ch)
    ml_ = jax.lax.dynamic_slice_in_dim(mlj, s, ch)
    return _pack_body(jp, codes, mins, scales, pnorms, xd[idx], mc_, ml_,
                      sq8=sq8, keep_f32=keep_f32, probe_only=probe_only)


def _pack_body(jp, codes, mins, scales, pnorms, xb, mc_, ml_,
               *, sq8: bool, keep_f32: bool, probe_only: bool):
    pnorms = pnorms.at[mc_, ml_].set(prep_norms(xb))
    if sq8:
        cu8, m8, s8 = sq8_encode(xb)
        codes = codes.at[mc_, ml_].set(
            (cu8.astype(jnp.int16) - 128).astype(jnp.int8)
        )
        mins = mins.at[mc_, ml_].set(m8 + 128.0 * s8)
        scales = scales.at[mc_, ml_].set(s8)
    if probe_only:
        pass
    elif keep_f32:
        jp = jp.at[mc_, ml_].set(xb)
    else:
        s16 = s8 * (255.0 / 65535.0)
        safe16 = jnp.where(s16 == 0, 1.0, s16)
        u16 = jnp.clip(
            jnp.round((xb - m8[:, None]) / safe16[:, None]), 0, 65535
        ).astype(jnp.uint16)
        jp = jp.at[mc_, ml_].set(u16)
    return jp, codes, mins, scales, pnorms


def _pad_rows_dev(x: jax.Array, mult: int) -> jax.Array:
    """Device-side analog of _pad_rows (+inf pad rows, zero k-means
    weight)."""
    n = x.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return x
    return jnp.concatenate(
        [x, jnp.full((pad, x.shape[1]), jnp.inf, jnp.float32)]
    )


def _pad_rows(x: np.ndarray, mult: int) -> np.ndarray:
    """Pad rows to a multiple of `mult` with +inf rows (zero-weight in
    k-means; see _kmeans valid mask)."""
    n = x.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return x
    return np.concatenate([x, np.full((pad, x.shape[1]), np.inf, np.float32)])


def _pow2_at_least(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p
