"""Pin the 1M ivf_f32 operating point: geometry and probe program.

An approximate top-k (approx_max_k) fused into the cell probe once cost
the 1M cell much of its throughput, and the geometry (cells x lanes) the
build picks decides how many bytes each probe gathers. These tests pin
(a) the default geometry the build picks at 1M and (b) the probe program
shape — two-level EXACT cell selection (ops/topk.py topk_smallest_wide),
never ApproxTopK. The real 1M build grows C via the split cascade.
Throughput itself is measured on the GPU (chip_smoke.py, bench.py); what
is CPU-checkable is that the program and geometry stay the ones that were
measured. Which geometry is best on the H100 is open (ROADMAP debt 8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from turdb_tpu.models.ivf import (
    IvfConfig,
    IvfState,
    _cpad,
    _pow2_at_least,
    ivf_search_impl,
)
from turdb_tpu.ops.distance import Metric


def headline_geometry(n=1_000_000, sq8=False, dim=128):
    """The pre-split (C_work, L) the default sizing picks at n rows —
    mirrors IvfIndex.train's sizing block (models/ivf.py). The split
    cascade then grows C data-dependently (1M make_pool: -> 24576)."""
    divisor = 128 if (n >= 500_000 and not sq8 and dim <= 256) else 64
    c = max(8, n // divisor)
    c = min(c, max(8, n // 4))
    c_work = _cpad(c)
    cap = _pow2_at_least(max(int(2.0 * n / c), 16), floor=8)
    return c_work, cap


def test_default_1m_geometry_pinned():
    """Big blocks (n//128 cells) for the f32 engine at 1M, dense blocks
    (n//64) for sq8 and for wide (384-d) rows."""
    assert headline_geometry(1_000_000) == (8192, 256)
    assert headline_geometry(1_000_000, sq8=True) == (16384, 128)
    assert headline_geometry(500_000, dim=384) == (8192, 128)
    assert headline_geometry(100_000) == (2048, 128)


def _probe_hlo(c, l, nprobe=8, dim=8):
    state = IvfState(
        centroids=jnp.zeros((c, dim)),
        cnorms=jnp.zeros((c,)),
        members=jnp.zeros((c, l), jnp.int32),
        pvecs=jnp.zeros((c, l, dim)),
        pnorms=jnp.zeros((c, l)),
        alive=jnp.ones((c, l), bool),
        codes=jnp.zeros((1, 1, 1), jnp.uint8),
        mins=jnp.zeros((1, 1)),
        scales=jnp.zeros((1, 1)),
    )
    cfg = IvfConfig(dim=dim, n_clusters=c, cluster_cap=l,
                    metric=Metric.L2, replicated=True)
    q = jnp.zeros((4, dim))
    return jax.jit(
        lambda st, qs: ivf_search_impl(st, qs, None, cfg=cfg, k=2,
                                       nprobe=nprobe)
    ).lower(state, q).as_text()


def test_probe_never_lowers_approx_topk():
    """The cell probe must stay EXACT at every C: the two-level exact
    selection (ops/topk.py topk_smallest_wide) replaces the full-row
    sort on wide rows — ApproxTopK must not lower at the 1M geometry
    NOR at the 10M-class one."""
    for c in (16384, 32768):
        hlo = _probe_hlo(c, 8)
        assert "ApproxTopK" not in hlo and "approx_max_k" not in hlo, c


def test_wide_cell_selection_end_to_end():
    """End-to-end probe at two-level widths (C > 1024): on clustered
    data the probe's recall vs a GLOBAL exact oracle stays high (the
    two-level selection finds the right cells), and returned distances
    are the exact f32 distances of the returned ids."""
    rng = np.random.default_rng(3)
    dim, l = 16, 8
    for c in (2048, 4096):
        n = c * l
        centers = rng.standard_normal((64, dim)).astype(np.float32) * 6.0
        a = rng.integers(0, 64, size=n)
        pts = (
            centers[a]
            + rng.standard_normal((n, dim)).astype(np.float32)
        )
        # pack rows into cells by k-means-free locality: sort by natural
        # cluster then chop into cells of l; centroid = cell mean
        order = np.argsort(a, kind="stable")
        pv = pts[order].reshape(c, l, dim)
        cents = pv.mean(axis=1)
        state = IvfState(
            centroids=jnp.asarray(cents),
            cnorms=jnp.sum(jnp.asarray(cents) ** 2, -1),
            members=jnp.arange(n, dtype=jnp.int32).reshape(c, l),
            pvecs=jnp.asarray(pv),
            pnorms=jnp.sum(jnp.asarray(pv) ** 2, -1),
            alive=jnp.ones((c, l), bool),
            codes=jnp.zeros((1, 1, 1), jnp.uint8),
            mins=jnp.zeros((1, 1)),
            scales=jnp.zeros((1, 1)),
        )
        cfg = IvfConfig(dim=dim, n_clusters=c, cluster_cap=l,
                        metric=Metric.L2)
        q = (
            centers[rng.integers(0, 64, 64)]
            + rng.standard_normal((64, dim)).astype(np.float32)
        )
        dd, ids = ivf_search_impl(state, jnp.asarray(q), None, cfg=cfg,
                                  k=5, nprobe=64)
        ours, od = np.asarray(ids), np.asarray(dd)
        flat = pv.reshape(-1, dim)
        dall = (
            (flat**2).sum(1)[None, :]
            - 2.0 * q @ flat.T
            + (q**2).sum(1)[:, None]
        )
        want = np.argsort(dall, axis=-1)[:, :5]
        hits = np.mean([
            len(set(w) & set(o)) / 5 for w, o in zip(want, ours)
        ])
        assert hits >= 0.9, (c, hits)
        # distance contract: reported dists = exact f32 dists of the ids
        got = np.take_along_axis(dall, ours, axis=-1)
        assert np.allclose(od, got, rtol=1e-3, atol=1e-2), c
