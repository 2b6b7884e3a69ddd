"""Mesh-sharded IVF: one logical clustered index over the device mesh.

Same mesh contract as sharded.py's HNSW (SURVEY.md §2.9): each db-axis
device owns an independent IVF sub-index over its partition of the
vectors; query batches are data-parallel over the `data` axis and
replicated over `db`; per-shard top-k merges with an all-gather across the
cards. This serves indexes larger than one card's memory: per-card IVF
probes are block-contiguous device-memory reads, and the only cross-card
traffic is the [S, B, k] result merge.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from turdb_tpu.config import MESH_AXIS_DATA, MESH_AXIS_DB, MESH_AXIS_HOST
from turdb_tpu.models.ivf import IvfConfig, IvfIndex, IvfState, ivf_search_impl
from turdb_tpu.ops.distance import Metric, normalize_rows
from turdb_tpu.ops.topk import topk_smallest


@jax.jit
def _stack_states(*states):
    """Stack per-shard state pytrees into [S, ...] leaves as ONE
    compiled program (the eager per-leaf stack was a compile per leaf)."""
    return jax.tree.map(lambda *leaves: jnp.stack(leaves), *states)


class ShardedIvfIndex:
    """Build: per-shard host IvfIndex (balanced round-robin routing), then
    the states stack into [S, ...] leaves laid out over the mesh. Search:
    shard_map(local probe) + all-gather merge. Global ids pack as
    shard * stride + slot."""

    def __init__(self, dim: int, mesh, metric: Metric = Metric.L2,
                 nprobe: int = 8, sq8: bool = False, rerank: int | None = None,
                 n_clusters: int | None = None, cluster_cap: int | None = None,
                 keep_f32: bool = True):
        self.mesh = mesh
        self.n_db = mesh.shape[MESH_AXIS_DB]
        self.n_host = mesh.shape.get(MESH_AXIS_HOST, 1)
        self.n_shards = self.n_host * self.n_db
        # the store shards over (host, db) combined; with one host this
        # degenerates to the plain db-axis layout
        self._store_spec = (
            P((MESH_AXIS_HOST, MESH_AXIS_DB)) if self.n_host > 1
            else P(MESH_AXIS_DB)
        )
        self.n_data = mesh.shape.get(MESH_AXIS_DATA, 1)
        self.dim = dim
        self.metric = metric
        # keep_f32=False: per-shard compact stores (int8 probe + SQ16
        # rerank, 3 bytes/dim instead of 5)
        self.shards = [
            IvfIndex(
                dim=dim, metric=metric, nprobe=nprobe, sq8=sq8, rerank=rerank,
                n_clusters=n_clusters, cluster_cap=cluster_cap,
                keep_f32=keep_f32,
            )
            for _ in range(self.n_shards)
        ]
        self.nprobe = nprobe
        self._stacked: IvfState | None = None
        self._cfg: IvfConfig | None = None
        self._fn_cache: dict = {}
        # gid = shard*stride + slot, computed in int32 on device: pick the
        # largest power-of-two stride with n_shards*stride <= 2^31 so the
        # packing can never alias (db=8 -> 268M slots/shard; the 100M-mesh
        # target is 12.5M/shard). add() asserts the per-shard bound.
        stride = 1 << 30
        while stride * self.n_shards > (1 << 31):
            stride >>= 1
        self.id_stride = stride

    def __len__(self):
        return sum(s.size for s in self.shards)

    def add(self, vecs: np.ndarray) -> np.ndarray:
        """Balanced routing (smallest shards fill first); returns packed
        global ids."""
        vecs = np.atleast_2d(np.asarray(vecs, np.float32))
        n = len(vecs)
        sizes = np.asarray([s.size for s in self.shards])
        order = np.argsort(sizes, kind="stable")
        gids = np.empty(n, np.int64)
        splits = np.array_split(np.arange(n), self.n_shards)
        for rank, s_idx in enumerate(order):
            idxs = splits[rank]
            if len(idxs) == 0:
                continue
            # stage only: train() then runs the mesh-parallel build
            # instead of each shard training on the default device
            slots = self.shards[int(s_idx)].add(vecs[idxs], train=False)
            if self.shards[int(s_idx)].size > self.id_stride:
                raise ValueError(
                    f"shard {int(s_idx)} exceeds id_stride={self.id_stride}; "
                    "packed gids would alias"
                )
            gids[idxs] = int(s_idx) * self.id_stride + np.asarray(slots)
        self._stacked = None
        return gids

    def train(self):
        untrained = [s for s in self.shards if s.state is None]
        if len(untrained) == self.n_shards and self.n_shards > 1:
            self._train_mesh()
            if self._stacked is not None:
                return
        for s in self.shards:
            if s.state is None:
                s.train()
        caps = {(s.cfg.n_clusters, s.cfg.cluster_cap) for s in self.shards}
        if len(caps) > 1:
            # re-train stragglers to the max geometry so states stack
            cmax = max(s.cfg.n_clusters for s in self.shards)
            lmax = max(s.cfg.cluster_cap for s in self.shards)
            for s in self.shards:
                if (s.cfg.n_clusters, s.cfg.cluster_cap) != (cmax, lmax):
                    s._n_clusters = cmax
                    s._cluster_cap = lmax
                    s._retrain_with(
                        np.zeros((0, self.dim), np.float32), np.zeros(0, np.int64)
                    )
        self._cfg = self.shards[0].cfg
        stacked = _stack_states(*[s.state for s in self.shards])
        self._stacked = jax.device_put(
            stacked, NamedSharding(self.mesh, self._store_spec)
        )

    def _train_mesh(self):
        """Mesh-parallel build (SURVEY §2.9 "sharded graph build"; round-2
        weak #8 trained the 8 sub-indexes host-SERIALLY): the k-means +
        assignment phase — the FLOP-dominant part of an IVF build — runs
        as ONE stacked [S, ...] program laid out over the mesh's db axis
        (every shard's Lloyd iterations execute simultaneously on its own
        device); the light per-shard finish (rebalance/split/pack/
        replicas) then runs in a thread pool, each thread pinned to its
        shard's device."""
        from concurrent.futures import ThreadPoolExecutor
        from functools import partial

        from turdb_tpu.models.ivf import (
            _KM_CHUNK,
            _PAD_CENT,
            _cpad,
            _kmeans,
            _masked_cn,
            _pad_rows,
        )

        S = self.n_shards
        xs = []
        ns = []
        for s in self.shards:
            x = (
                np.concatenate(s._vectors_host)
                if s._vectors_host
                else np.zeros((0, self.dim), np.float32)
            )
            ns.append(len(x))
            xs.append(x)
        n_max = max(ns)
        if n_max == 0:
            return
        npad = -(-n_max // _KM_CHUNK) * _KM_CHUNK
        stacked = np.full((S, npad, self.dim), np.inf, np.float32)
        for i, x in enumerate(xs):
            stacked[i, : len(x)] = x
        # shared geometry so the stacked program has ONE shape and the
        # states stack without a retrain pass
        c = max(8, min(n_max // 64, max(8, n_max // 4)))
        for s in self.shards:
            if s._n_clusters:
                c = s._n_clusters
                break
        c_work = _cpad(c)
        rng = np.random.default_rng(0)
        init = np.full((S, c_work, self.dim), _PAD_CENT, np.float32)
        for i, x in enumerate(xs):
            k = min(c, max(len(x), 1))
            sel = rng.choice(max(len(x), 1), size=k, replace=len(x) < k)
            init[i, :k] = x[sel] if len(x) else 0.0
        spec = NamedSharding(self.mesh, self._store_spec)
        xd = jax.device_put(stacked, spec)
        initd = jax.device_put(init, spec)

        kmeans_s = jax.jit(
            jax.vmap(partial(_kmeans, iters=8)),
            in_shardings=(spec, spec), out_shardings=spec,
        )
        cents = kmeans_s(xd, initd)                    # [S, c_work, d]

        from turdb_tpu.models.ivf import _assign_all

        def _assign_one(x, cc):
            return _assign_all(x, cc, _masked_cn(cc, c))

        assign = np.asarray(
            jax.jit(
                jax.vmap(_assign_one),
                in_shardings=(spec, spec), out_shardings=spec,
            )(xd, cents)
        )

        cents_np = np.asarray(cents)
        devices = list(self.mesh.devices.reshape(-1))

        def finish(i):
            s = self.shards[i]
            dev = devices[i % len(devices)]
            with jax.default_device(dev):
                s._n_clusters = c
                xpj = jax.device_put(stacked[i], dev)
                s.train(_pre=(cents_np[i], assign[i, : ns[i]], xpj))

        with ThreadPoolExecutor(max_workers=min(S, 8)) as pool:
            list(pool.map(finish, range(S)))

        caps = {(s.cfg.n_clusters, s.cfg.cluster_cap) for s in self.shards}
        if len(caps) > 1:
            cmax = max(s.cfg.n_clusters for s in self.shards)
            lmax = max(s.cfg.cluster_cap for s in self.shards)
            for s in self.shards:
                if (s.cfg.n_clusters, s.cfg.cluster_cap) != (cmax, lmax):
                    s._n_clusters = cmax
                    s._cluster_cap = lmax
                    s._retrain_with(
                        np.zeros((0, self.dim), np.float32),
                        np.zeros(0, np.int64),
                    )
        self._cfg = self.shards[0].cfg
        # per-shard states live on their build devices: stack via host
        # (same data volume the serial path moved through jnp.stack)
        stacked_st = jax.tree.map(
            lambda *leaves: np.stack([np.asarray(l) for l in leaves]),
            *[s.state for s in self.shards],
        )
        self._stacked = jax.device_put(
            stacked_st, NamedSharding(self.mesh, self._store_spec)
        )

    def search(self, queries, k: int, nprobe: int | None = None):
        """Returns (dists [B,k], packed gids [B,k]): gid = shard*stride+slot."""
        if self._stacked is None:
            self.train()
        q = np.atleast_2d(np.asarray(queries, np.float32))
        b0 = q.shape[0]
        bpad = -(-b0 // self.n_data) * self.n_data
        if bpad != b0:
            q = np.concatenate([q, np.zeros((bpad - b0, self.dim), np.float32)])
        if self.metric is Metric.COSINE:
            q = np.asarray(normalize_rows(jnp.asarray(q)))
        p = min(nprobe or self.nprobe, self._cfg.n_clusters)
        d, gi = self._search_fn(k, p)(self._stacked, jnp.asarray(q))
        return np.asarray(d)[:b0], np.asarray(gi, np.int64)[:b0]

    def unpack(self, gids):
        gids = np.asarray(gids)
        return gids // self.id_stride, gids % self.id_stride

    def _search_fn(self, k: int, nprobe: int):
        key = (k, nprobe, self.id_stride)
        if key in self._fn_cache:
            return self._fn_cache[key]
        cfg = self._cfg
        stride = self.id_stride

        multihost = self.n_host > 1
        n_db = self.n_db

        def local(state, q):
            state = jax.tree.map(lambda x: x[0], state)
            d, i = ivf_search_impl(state, q, None, cfg=cfg, k=k, nprobe=nprobe)
            shard = jax.lax.axis_index(MESH_AXIS_DB)
            if multihost:
                shard = shard + jax.lax.axis_index(MESH_AXIS_HOST) * n_db
            gi = jnp.where(i >= 0, shard.astype(jnp.int32) * stride + i, -1)
            # level 1: merge across the db axis (inside a node)
            ad = jax.lax.all_gather(d, MESH_AXIS_DB)
            ai = jax.lax.all_gather(gi, MESH_AXIS_DB)
            ad = jnp.moveaxis(ad, 0, 1).reshape(q.shape[0], -1)
            ai = jnp.moveaxis(ai, 0, 1).reshape(q.shape[0], -1)
            md, mi = topk_smallest(ad, ai, k)
            if not multihost:
                return md, mi
            # level 2: only [B, k] crosses nodes (two-level merge)
            hd = jax.lax.all_gather(md, MESH_AXIS_HOST)
            hi = jax.lax.all_gather(mi, MESH_AXIS_HOST)
            hd = jnp.moveaxis(hd, 0, 1).reshape(q.shape[0], -1)
            hi = jnp.moveaxis(hi, 0, 1).reshape(q.shape[0], -1)
            return topk_smallest(hd, hi, k)

        fn = jax.jit(
            jax.shard_map(
                local,
                mesh=self.mesh,
                in_specs=(self._store_spec, P(MESH_AXIS_DATA)),
                out_specs=(P(MESH_AXIS_DATA), P(MESH_AXIS_DATA)),
                check_vma=False,
            )
        )
        self._fn_cache[key] = fn
        return fn
