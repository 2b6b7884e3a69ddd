"""Benchmark: vector-query throughput on one GPU at the recall gate
(recall@10 >= 0.95, plus graph-build throughput), measured on MULTIPLE
data distributions, plus OLTP microbenchmarks.

    python bench.py     # needs a GPU; exits non-zero without one

Engines (see turdb_tpu/models/ivf.py for why both exist):
  - IVF-Flat   (clustered, block-contiguous — the throughput path)
  - HNSW       (the reference's algorithm; round-3 serving pack: packed
                neighbor blocks + int8 beam + exact rerank)

Datasets:
  - make_pool  (clustered synthetic, the round-1/2 headline continuity)
  - hard_pool  (imbalanced Zipf sizes + anisotropic cells + HELD-OUT
                queries — adversarially shaped, not builder-friendly)
  - pix_pool   (EXTERNAL data: deterministic multi-scale patch
                descriptors of the reference repo's 4096x4096 photo —
                the data-generating distribution is not builder-authored)
  - emb_pool   (384-d normalized embedding workload, cosine)
  - SIFT-1M    (real data via $TURDB_SIFT_PATH, TexMex fvecs layout)

Artifact contract: the current cumulative result JSON line is
RE-PRINTED to stdout after every section, so a timeout still leaves an
artifact carrying every section measured so far. The LAST printed line is
always the most complete, and names the device it ran on (platform,
device kind, count, and the card's name and power limit). A global
wall-clock budget (TURDB_BENCH_BUDGET_S, default 2000s) gates each section
on its cost estimate; skipped sections are recorded as skipped, not
silently lost.
"""

import json
import os
import sys
import time

import numpy as np

from turdb_tpu.utils.datasets import recall_of

N = int(os.environ.get("TURDB_BENCH_N", 1_000_000))   # the SIFT-1M-class gate
DIM = int(os.environ.get("TURDB_BENCH_DIM", 128))
K = 10
N_QUERIES = int(os.environ.get("TURDB_BENCH_Q", 16384))
RECALL_GATE = 0.95
BASELINE_QPS = 50_000.0  # BASELINE.json: >=50k QPS/chip at recall@10>=0.95
SKIP_HNSW = os.environ.get("TURDB_BENCH_SKIP_HNSW") == "1"
SKIP_HARD = os.environ.get("TURDB_BENCH_SKIP_HARD") == "1"
N_HARD = int(os.environ.get("TURDB_BENCH_N_HARD", N))
N_EMB = int(os.environ.get("TURDB_BENCH_N_EMB", min(N, 500_000)))
BUDGET_S = float(os.environ.get("TURDB_BENCH_BUDGET_S", 2000.0))
T0 = time.monotonic()

EXTRA: dict = {}
DEVICE: dict = {}
RESULTS: list = []   # (tag, qps, recall, build_rate)

_ANSI = None


def remaining() -> float:
    return BUDGET_S - (time.monotonic() - T0)


def sanitize(msg, limit=200):
    """Machine-readable artifact hygiene: strip ANSI escapes and
    newlines from error strings (BENCH_r03's ivf_hard error embedded
    raw escape sequences, flagged by the round-3 advisor)."""
    global _ANSI
    if _ANSI is None:
        import re

        _ANSI = re.compile(r"\x1b\[[0-9;]*[A-Za-z]|\x1b\].*?(\x07|\x1b\\)")
    s = _ANSI.sub("", str(msg)).replace("\n", " ").replace("\r", "")
    return " ".join(s.split())[:limit]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit():
    """Print the CURRENT cumulative artifact line to stdout. Called after
    every section: the last complete line on stdout is the artifact, so a
    timeout mid-run loses only unmeasured sections."""
    # derived build-ratio rows (BASELINE.json: build >= 10x the CPU
    # reference's vectors/sec) once both legs exist
    cpu = EXTRA.get("cpu_hnsw_baseline", {}).get("vps")
    if cpu:
        for eng in ("hnsw", "ivf_f32", "ivf_sq8"):
            vps = EXTRA.get(eng, {}).get("build_vps")
            if vps:
                EXTRA.setdefault("build_ratio", {})[eng] = round(vps / cpu, 2)
    EXTRA["elapsed_s"] = round(time.monotonic() - T0)
    if RESULTS:
        tag, qps_b, r_b, _ = max(RESULTS, key=lambda r: r[1])
        line = {
            "metric": (
                f"vector_qps_{N // 1000}k_{DIM}d_recall{RECALL_GATE}@{K}_{tag}"
            ),
            "value": round(qps_b, 1),
            "unit": "qps",
            "vs_baseline": round(qps_b / BASELINE_QPS, 4),
            "device": DEVICE,
            "extra": EXTRA,
        }
    else:
        line = {
            "metric": f"vector_qps_{N//1000}k_{DIM}d_recall{RECALL_GATE}@{K}",
            "value": 0.0, "unit": "qps", "vs_baseline": 0.0,
            "device": DEVICE, "extra": EXTRA,
        }
    print(json.dumps(line), flush=True)


def section(name: str, est_s: float, fn, *args, **kw):
    """Run one bench section under the global budget: skip (and record
    the skip) when the remaining budget can't cover the estimate; never
    let one section's failure lose the artifact; re-emit afterwards."""
    left = remaining()
    if left < est_s:
        EXTRA.setdefault(name, {})["skipped"] = (
            f"budget: {left:.0f}s left < ~{est_s:.0f}s estimated"
        )
        log(f"SKIP {name}: {EXTRA[name]['skipped']}")
        emit()
        return None
    log(f"[{time.monotonic() - T0:.0f}s] section {name} "
        f"(est {est_s:.0f}s, {left:.0f}s left)")
    try:
        out = fn(*args, **kw)
    except Exception as e:
        log(f"  {name}: FAILED ({sanitize(e, 160)})")
        EXTRA.setdefault(name, {})["error"] = sanitize(e)
        out = None
    emit()
    return out


def qps_device_slope(scan_fn, queries, batch=1024, m_lo=4, m_hi=16):
    """Honest device throughput: the batch loop runs INSIDE one jitted
    program (lax.scan over [M, B, d]) for two M values; the slope
    (T(m_hi)-T(m_lo))/(m_hi-m_lo) cancels dispatch/transfer overheads."""
    import jax.numpy as jnp

    if len(queries) < 2 * m_hi * batch:
        # smoke configs pass fewer queries than one slope pair needs;
        # reshape(-1) would silently fold rows into the feature dim
        reps = (2 * m_hi * batch) // len(queries) + 1
        queries = np.tile(queries, (reps, 1))

    def timed(m):
        qs = jnp.asarray(queries[: m * batch].reshape(m, batch, -1))
        # digest instead of downloading [m, B, k] ids: the download
        # scales with m, so the slope would not cancel it. jnp.sum runs
        # OUTSIDE the jitted scan, so the scan still materializes every
        # id on device (no DCE across the dispatch boundary).
        def run():
            return np.asarray(jnp.sum(scan_fn(qs)))

        run()                                          # warm/compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best

    while True:
        t_lo, t_hi = timed(m_lo), timed(m_hi)
        if t_hi - t_lo > 0.5 * t_lo or m_hi * 2 * batch > len(queries):
            break
        m_lo, m_hi = m_hi, m_hi * 2
    per_batch = max((t_hi - t_lo) / (m_hi - m_lo), 1e-9)
    return batch / per_batch


def probe_batch(cfg, nprobe, nblocks=None):
    """Largest safe QPS batch for one probe geometry: the [B, P, L, d]
    block gather (+ the int8 path's s32 widening) must stay within ~2GB
    of program temp (at nprobe=256 x L=128 x d=128 an uncapped B=1024
    scan gathers 4.3GB per step). IvfIndex.search() caps its own
    batches; the bench's hand-built scan does too."""
    p = min(nprobe, nblocks) if nblocks else nprobe
    bytes_per_q = p * cfg.cluster_cap * ((cfg.dim + 4) if cfg.sq8
                                         else 4 * cfg.dim)
    b = max(32, (2 << 30) // bytes_per_q)
    return min(1024, 1 << (b.bit_length() - 1))


def truth_for(x, sample, k=K, metric="l2"):
    from turdb_tpu.models.flat import FlatIndex
    from turdb_tpu.ops.distance import Metric

    flat = FlatIndex(dim=x.shape[1], capacity=len(x),
                     metric=Metric.from_name(metric))
    flat.add(x)
    _, truth = flat.search(sample, k=k)
    del flat
    return truth


def bench_ivf(tag, x, queries, truth, metric="l2",
              probes=(2, 4, 5, 6, 8, 16, 32, 64), truth50=None, **kw):
    """Build + recall sweep + device-slope QPS for one IVF config.
    Returns (qps, recall, build_rate) or None if the gate wasn't met.
    truth50: [S, 50] oracle ids — when given, also records recall@50 at
    the gate operating point and the nprobe needed for >=0.99@50 (the
    reference's asserted bar, hnsw_qdrant_comparison.rs:315-319)."""
    import jax as _jax

    from turdb_tpu.models.ivf import IvfIndex, ivf_search_impl
    from turdb_tpu.ops.distance import Metric

    sample = queries[:256]
    try:
        idx = IvfIndex(dim=x.shape[1], metric=Metric.from_name(metric), **kw)
        t0 = time.perf_counter()
        idx.add(x)           # trains once the staged rows warrant it
        idx.train()          # no-op when add() already trained
        build_s = time.perf_counter() - t0
        rate = len(x) / build_s
        log(f"{tag}: build {len(x)} in {build_s:.1f}s = {rate:,.0f} vec/s "
            f"(C={idx.cfg.n_clusters}, L={idx.cfg.cluster_cap})")
        star = None
        sweep = EXTRA.setdefault(tag, {})
        sweep["build_vps"] = round(rate)
        for nprobe in probes:
            _, ids = idx.search(sample, k=K, nprobe=nprobe)
            r = recall_of(ids, truth)
            log(f"  nprobe={nprobe}: recall@{K}={r:.4f}")
            # record the sweep AS IT RUNS: a failure mid-row must not
            # erase recalls already measured
            sweep.setdefault("sweep", {})[str(nprobe)] = round(r, 4)
            if r >= RECALL_GATE:
                star = (nprobe, r)
                break
        if star is None:
            EXTRA[tag].update({"recall": r, "gate": False})
            log(f"  {tag}: gate not reached")
            return None
        nprobe, r = star
        # the gate is MET at this point: record it before attempting the
        # QPS measurement, so a failure there can't erase the row's
        # partial result
        EXTRA[tag].update({
            "recall": round(r, 4), "nprobe": nprobe, "gate": True,
        })
        if truth50 is not None:
            _recall50_ivf(tag, idx, sample, truth50, nprobe, probes)
        cfg, state = idx.cfg, idx.state

        @_jax.jit
        def _scan(st, qs):
            def step(_, qb):
                _, i = ivf_search_impl(st, qb, None, cfg=cfg, k=K,
                                       nprobe=nprobe)
                return 0, i
            _, ids = _jax.lax.scan(step, 0, qs)
            return ids

        b = probe_batch(cfg, nprobe)
        while True:
            try:
                qps = qps_device_slope(lambda qs: _scan(state, qs),
                                       queries, batch=b)
                break
            except Exception as e:
                if b <= 32:
                    raise
                log(f"  {tag}: QPS scan at batch={b} failed "
                    f"({sanitize(e, 80)}); halving batch")
                b //= 2
        log(f"  {tag}: QPS={qps:,.0f} (device-slope, batch={b}) "
            f"@ nprobe={nprobe} recall={r:.4f}")
        EXTRA[tag]["qps"] = round(qps)
        EXTRA[tag]["qps_batch"] = b
        return qps, r, rate
    except Exception as e:
        log(f"  {tag}: FAILED ({sanitize(e, 160)})")
        EXTRA.setdefault(tag, {})["error"] = sanitize(e)
        return None


def _recall50_ivf(tag, idx, sample, truth50, gate_nprobe, probes):
    """Recall@50 rows (reference bar: avg recall@50 >= 0.99 asserted,
    tests/hnsw_qdrant_comparison.rs:38-40,315-319). Records (a) @50 at
    the @10 gate point and (b) the smallest swept nprobe reaching 0.99."""
    try:
        row = {}
        seen = sorted({gate_nprobe, *[p for p in probes if p >= gate_nprobe]})
        for p in seen:
            _, ids = idx.search(sample, k=50, nprobe=p)
            r50 = recall_of(ids, truth50)
            row.setdefault("sweep", {})[str(p)] = round(r50, 4)
            if p == gate_nprobe:
                row["at_gate"] = round(r50, 4)
            if r50 >= 0.99:
                row.update({"nprobe": p, "recall50": round(r50, 4),
                            "gate99": True})
                break
        EXTRA[tag]["recall50"] = row
        log(f"  {tag}: recall@50 {row}")
    except Exception as e:   # the parity row must not cost the main row
        EXTRA[tag]["recall50"] = {"error": sanitize(e)}


def bench_hnsw(tag, x, queries, truth, truth50=None):
    """HNSW: bulk build at FULL size + serving-pack QPS (round-3: the
    reference's own algorithm must clear the gate — verdict item #1)."""
    import jax as _jax

    from turdb_tpu.models.hnsw import HnswIndex
    from turdb_tpu.models.hnsw_serve import serve_search_impl

    sample = queries[:256]
    try:
        idx = HnswIndex(dim=x.shape[1], ef_construction=100, build_batch=512,
                        capacity=len(x))
        t0 = time.perf_counter()
        idx.add(x)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx.pack_serving()
        pack_s = time.perf_counter() - t0
        rate = len(x) / (build_s + pack_s)
        log(f"{tag}: build {len(x)} in {build_s:.1f}s + pack {pack_s:.1f}s "
            f"= {rate:,.0f} vec/s")
        star = None
        sweep = EXTRA.setdefault(tag, {})
        sweep["build_vps"] = round(rate)
        for ef, iters in ((32, 24), (48, 32), (64, 48), (96, 96)):
            _, ids = idx.search_serve(sample, k=K, ef=ef, iters=iters)
            r = recall_of(ids, truth)
            log(f"  serve ef={ef} iters={iters}: recall@{K}={r:.4f}")
            sweep.setdefault("sweep", {})[str(ef)] = round(r, 4)
            if r >= RECALL_GATE:
                star = (ef, iters, r)
                break
        if star is None:
            EXTRA[tag].update({"recall": r, "gate": False})
            return None
        ef, iters, r = star
        EXTRA[tag].update({  # gate met: record before the fragile QPS step
            "recall": round(r, 4), "ef": ef, "gate": True,
        })
        if truth50 is not None:
            _recall50_hnsw(tag, idx, sample, truth50, ef, iters)
        sv = idx.serve
        metric = idx.cfg.metric

        @_jax.jit
        def _scan(st, qs):
            def step(_, qb):
                _, i = serve_search_impl(
                    st, qb, None, metric=metric, k=K, ef=ef, iters=iters,
                )
                return 0, i
            _, out = _jax.lax.scan(step, 0, qs)
            return out

        qps = qps_device_slope(lambda qs: _scan(sv, qs), queries)
        log(f"  {tag}: QPS={qps:,.0f} (device-slope) @ ef={ef} recall={r:.4f}")
        EXTRA[tag]["qps"] = round(qps)

        def _pack_gb(s):
            return round(sum(
                a.size * a.dtype.itemsize for a in s if a is not None
            ) / 2**30, 2)

        EXTRA[tag]["pack_gb"] = _pack_gb(sv)
        emit()   # main row complete — persist before the optional sub-row
        if remaining() < 150:
            EXTRA[tag]["pack_m16"] = {"skipped": "budget"}
            return qps, r, rate
        try:
            # memory-knob sub-row (verdict r3 #7): pack only the first 16
            # diversity-ranked L0 neighbors per node — halves the
            # adjacency-side pack — and record the recall/QPS it serves at
            idx.pack_serving(pack_m=16)
            svm = idx.serve
            row = {"pack_gb": _pack_gb(svm)}
            for efm, itm in ((ef, iters), (ef + 16, iters + 16),
                             (ef + 32, iters + 32), (96, 96)):
                _, ids = idx.search_serve(sample, k=K, ef=efm, iters=itm)
                rm = recall_of(ids, truth)
                row.setdefault("sweep", {})[str(efm)] = round(rm, 4)
                if rm >= RECALL_GATE:
                    row.update({"recall": round(rm, 4), "ef": efm,
                                "gate": True})

                    @_jax.jit
                    def _scan_m(st, qs):
                        def step(_, qb):
                            _, i = serve_search_impl(
                                st, qb, None, metric=metric, k=K, ef=efm,
                                iters=itm,
                            )
                            return 0, i
                        _, o = _jax.lax.scan(step, 0, qs)
                        return o

                    row["qps"] = round(qps_device_slope(
                        lambda qs: _scan_m(svm, qs), queries))
                    break
            EXTRA[tag]["pack_m16"] = row
            log(f"  {tag}: pack_m=16 {row}")
        except Exception as e:  # the knob row must not cost the main row
            EXTRA[tag]["pack_m16"] = {"error": sanitize(e)}
        return qps, r, rate
    except Exception as e:
        log(f"  {tag}: FAILED ({sanitize(e, 160)})")
        EXTRA.setdefault(tag, {})["error"] = sanitize(e)
        return None


def _recall50_hnsw(tag, idx, sample, truth50, gate_ef, gate_iters):
    """HNSW recall@50 at the gate point + first ef reaching 0.99 (the
    reference's asserted bar)."""
    try:
        row = {}
        for ef, iters in ((gate_ef, gate_iters), (96, 96), (128, 128),
                          (192, 160)):
            if ef < 50:
                ef, iters = 64, max(iters, 48)   # beam must cover k=50
            _, ids = idx.search_serve(sample, k=50, ef=ef, iters=iters)
            r50 = recall_of(ids, truth50)
            row.setdefault("sweep", {})[str(ef)] = round(r50, 4)
            if "at_gate" not in row:
                row["at_gate"] = round(r50, 4)
            if r50 >= 0.99:
                row.update({"ef": ef, "recall50": round(r50, 4),
                            "gate99": True})
                break
        EXTRA[tag]["recall50"] = row
        log(f"  {tag}: recall@50 {row}")
    except Exception as e:
        EXTRA[tag]["recall50"] = {"error": sanitize(e)}


def bench_cpu_hnsw_baseline(x):
    """Measured CPU baseline for the >=10x build gate (BASELINE.json):
    the reference insert algorithm (greedy descent + ef_c beam +
    heuristic selection + bidirectional prune, reference
    src/hnsw/mod.rs:990-1084, operations.rs:135-233) implemented
    single-threaded in native/hnsw_cpu_baseline.cpp, same parameters as
    the device build (M=16, ef_construction=100). Run at 64k rows of the
    SAME pool (a full 1M CPU build would blow the bench budget; insert
    cost grows ~log n, so the 64k-rate OVERSTATES the CPU's 1M rate and
    the resulting ratio is a conservative lower bound — recorded as
    such). A recall probe over the built graph guards against the
    baseline being a sham."""
    from turdb_tpu.native.build import hnsw_cpu_build

    n = min(len(x), 65_536)
    out = hnsw_cpu_build(x[:n], m=16, ef_construction=100,
                         queries=x[:256], k=K)
    if out is None:
        EXTRA["cpu_hnsw_baseline"] = {"error": "native lib unavailable"}
        return
    EXTRA["cpu_hnsw_baseline"] = {
        "n": n, "vps": round(out["vps"]), "build_s": round(out["seconds"], 1),
        "recall_self@10": round(out["recall"], 4),
        "note": "single-thread C++, reference algorithm (M=16, efc=100); "
                "rate at 64k overstates the CPU 1M rate (log-n growth), "
                "so build_ratio is a lower bound",
    }
    log(f"cpu_hnsw_baseline: {EXTRA['cpu_hnsw_baseline']}")


def bench_oltp():
    """Single-row prepared inserts + point reads (reference
    TARGET_BENCH.md:27-33 / lib.rs:64-66) — host-side, no device. Also runs
    the same loop against the bundled sqlite3 (the reference's criterion
    benches compare against bundled rusqlite, benches/insertion.rs)."""
    import sqlite3
    import tempfile

    from turdb_tpu.database.api import Database

    out = {}
    lite = sqlite3.connect(tempfile.mkdtemp() + "/lite.db")
    lite.execute("PRAGMA journal_mode = off")
    lite.execute(
        "CREATE TABLE t(id INT PRIMARY KEY, a INT, b TEXT, c DOUBLE)"
    )
    n = 30000
    t0 = time.perf_counter()
    for i in range(n):
        lite.execute("INSERT INTO t VALUES (?, ?, ?, ?)",
                     (i, i * 2, f"name{i}", i * 0.5))
    out["sqlite_insert_rps"] = round(n / (time.perf_counter() - t0))
    lite.close()

    # INTERLEAVED repeat-and-best: BENCH_r03 recorded WAL-on faster
    # than WAL-off (physically backwards) because VM noise between
    # the two single-shot loops exceeded the WAL cost. Alternate the
    # modes 3x on fresh databases and keep each mode's best, the
    # same noise treatment qps_device_slope applies to device rows.
    n = 30000
    best = {False: 0.0, True: 0.0}
    best_read = float("inf")
    best_upd = 0.0
    best_del = 0.0
    for rep in range(3):
        for wal in (False, True):
            db = Database.create(
                tempfile.mkdtemp() + f"/oltp{wal}{rep}"
            )
            if not wal:
                db.execute("PRAGMA wal = off")
            db.execute("CREATE TABLE t(id INT PRIMARY KEY, a INT, "
                       "b TEXT, c DOUBLE)")
            stmt = db.prepare("INSERT INTO t VALUES ($1, $2, $3, $4)")
            for i in range(2000):
                stmt.execute([i, i * 2, f"name{i}", i * 0.5])
            t0 = time.perf_counter()
            for i in range(2000, 2000 + n):
                stmt.execute([i, i * 2, f"name{i}", i * 0.5])
            best[wal] = max(best[wal], n / (time.perf_counter() - t0))
            if not wal:
                q = db.prepare("SELECT b FROM t WHERE id = $1")
                for i in range(100):
                    q.query([i])
                t0 = time.perf_counter()
                for i in range(5000):
                    q.query([i * 3 % n])
                best_read = min(
                    best_read, (time.perf_counter() - t0) / 5000 * 1e6
                )
                # single-row UPDATE / DELETE lanes (reference ships
                # dedicated benches: update_benchmark.rs,
                # delete_benchmark.rs)
                u = db.prepare("UPDATE t SET a = $2, c = $3 WHERE id = $1")
                for i in range(200):
                    u.execute([i, i, i * 0.25])
                t0 = time.perf_counter()
                for i in range(10000):
                    u.execute([i % n, i, i * 0.25])
                best_upd = max(best_upd,
                               10000 / (time.perf_counter() - t0))
                dstmt = db.prepare("DELETE FROM t WHERE id = $1")
                t0 = time.perf_counter()
                for i in range(10000):
                    dstmt.execute([i])
                best_del = max(best_del,
                               10000 / (time.perf_counter() - t0))
            db.close()
    out["insert_wal_off_rps"] = round(best[False])
    out["insert_wal_on_rps"] = round(best[True])
    out["point_read_us"] = round(best_read, 2)
    out["update_rps"] = round(best_upd)
    out["delete_rps"] = round(best_del)
    log(f"oltp: {out}")
    EXTRA["oltp"] = out


def bench_analytic(n=1_000_000):
    """Sequential-scan / aggregation throughput at 1M rows (reference
    design target >1M rows/s sequential scan, lib.rs:65) vs the bundled
    sqlite3 — host columnar path, no device."""
    import sqlite3
    import tempfile

    from turdb_tpu.database.api import Database

    queries = [
        ("scan_agg", "SELECT sum(v), count(*) FROM t"),
        ("group_by", "SELECT grp, sum(v) FROM t GROUP BY grp"),
        ("filter_count",
         "SELECT count(*) FROM t WHERE v > 100000 AND grp < 500"),
    ]
    out = {}
    ids = np.arange(n)
    grps, vs = ids % 1000, (ids * 0.5).astype(np.float64)
    db = Database.create(tempfile.mkdtemp() + "/scan")
    db.execute("PRAGMA wal = off")
    db.execute("CREATE TABLE t (id INT, grp INT, v DOUBLE)")
    t0 = time.perf_counter()
    db.bulk_insert("t", {"id": ids, "grp": grps, "v": vs})
    out["bulk_load_rps"] = round(n / (time.perf_counter() - t0))
    lite = sqlite3.connect(tempfile.mkdtemp() + "/l.db")
    lite.execute("PRAGMA journal_mode = off")
    lite.execute("CREATE TABLE t (id INT, grp INT, v DOUBLE)")
    lite.executemany("INSERT INTO t VALUES (?,?,?)",
                     zip(ids.tolist(), grps.tolist(), vs.tolist()))
    for tag, sql in queries:
        db.query(sql)
        t0 = time.perf_counter()
        db.query(sql)
        out[f"{tag}_mrps"] = round(n / (time.perf_counter() - t0) / 1e6, 1)
        lite.execute(sql).fetchall()
        t0 = time.perf_counter()
        lite.execute(sql).fetchall()
        out[f"{tag}_sqlite_mrps"] = round(
            n / (time.perf_counter() - t0) / 1e6, 1
        )
    db.close()
    lite.close()
    log(f"analytic: {out}")
    EXTRA["analytic_1m"] = out


def main():
    from turdb_tpu.utils.compile_cache import use_compile_cache
    from turdb_tpu.utils.datasets import (
        emb_pool, hard_pool, make_pool, pix_pool, sift_dataset,
    )
    from turdb_tpu.utils.device import device_info, gpu_name_and_power

    use_compile_cache()
    DEVICE.update(device_info())
    if DEVICE["platform"] != "gpu":
        log(f"no GPU: JAX platform is {DEVICE['platform']!r}")
        return 1
    DEVICE["nvidia_smi"] = gpu_name_and_power()
    rng = np.random.default_rng(0)
    log(f"device: {DEVICE}")

    # ---- clustered pool (headline continuity) ---------------------------
    pool = make_pool(rng, N + N_QUERIES, DIM)
    x, queries = pool[:N], pool[N:]
    truth = truth_for(x, queries[:256])
    log("make_pool truth ready")

    def _headline():
        r = bench_ivf("ivf_f32", x, queries, truth)
        if r:
            RESULTS.append(("ivf_f32", *r))

    section("ivf_f32", 240, _headline)

    # host-only rows next, so a budget cut cannot lose them
    section("oltp", 130, bench_oltp)
    section("analytic_1m", 70, bench_analytic)
    section("cpu_hnsw_baseline", 150, bench_cpu_hnsw_baseline, x)

    def _sq8():
        r = bench_ivf("ivf_sq8", x, queries, truth, sq8=True, rerank=4 * K)
        if r:
            RESULTS.append(("ivf_sq8", *r))

    section("ivf_sq8", 190, _sq8)
    del pool

    # ---- hard distribution (adversarially shaped, held-out queries) -----
    if not SKIP_HARD:
        def _hard():
            xh, qh = hard_pool(rng, N_HARD, DIM, n_queries=N_QUERIES)
            th = truth_for(xh, qh[:256])
            log("hard_pool truth ready")
            # sq8 probe on the hard row: anisotropic Zipf cells defeat
            # centroid ranking, so the gate needs ~3% of cells probed;
            # int8 codes move 4x fewer bytes, buying the wider sweep at
            # equal memory traffic, and sq8+exact-rerank recall matches
            # f32 on this data.
            r = bench_ivf("ivf_hard", xh, qh, th, sq8=True, rerank=4 * K,
                          probes=(64, 128, 192, 256, 384, 512))
            if r:
                RESULTS.append(("ivf_hard", *r))

        section("ivf_hard", 280, _hard)

        # ---- natural-image patches (EXTERNAL data, deterministic) -------
        # the round-3 verdict's top validation gap: every recall/QPS
        # number was measured on builder-generated synthetics. pix_pool
        # derives ~240k multi-scale patch descriptors from the reference
        # repo's own 4096x4096 photo with no RNG anywhere — the data-
        # generating process escapes the builder (the image predates the
        # repo), the SIFT workload class (patch descriptors).
        def _pix():
            pix = pix_pool(n=min(240_000, N), n_queries=N_QUERIES)
            if pix is None:
                EXTRA["ivf_pix"] = {"error": "pix pool unavailable"}
                return
            xp, qp = pix
            tp = truth_for(xp, qp[:256])
            log("pix_pool truth ready")
            r = bench_ivf("ivf_pix", xp, qp, tp,
                          probes=(8, 16, 32, 64, 128))
            if r:
                RESULTS.append(("ivf_pix", *r))

        section("ivf_pix", 200, _pix)

    # ---- HNSW (reference-parity algorithm) at full size ------------------
    # ranked ABOVE the emb384 row: under a tight budget the
    # reference-parity engine's row must land (the emb384 build can eat
    # the whole remainder)
    if not SKIP_HNSW:
        def _hnsw():
            t50 = truth_for(x, queries[:256], k=50)
            r = bench_hnsw("hnsw", x, queries, truth, truth50=t50)
            if r:
                RESULTS.append(("hnsw", *r))

        section("hnsw", 420, _hnsw)

    if not SKIP_HARD:
        # ---- 384-d embedding workload (cosine) --------------------------
        def _emb():
            xe, qe = emb_pool(rng, N_EMB, n_queries=N_QUERIES)
            te = truth_for(xe, qe[:256], metric="cosine")
            te50 = truth_for(xe, qe[:256], k=50, metric="cosine")
            log("emb_pool truth ready")
            r = bench_ivf("ivf_emb384", xe, qe, te, metric="cosine",
                          probes=(4, 6, 8, 12, 16, 24, 32, 64),
                          truth50=te50, rerank=200)
            if r:
                RESULTS.append(("ivf_emb384", *r))

        section("ivf_emb384", 240, _emb)

    # ---- real SIFT-1M when provided -------------------------------------
    def _sift():
        sift = sift_dataset(max_n=N if N < 1_000_000 else None)
        if sift is None:
            return
        xs, qs, ts = sift
        if ts is None:
            ts = truth_for(xs, qs[:256])
        else:
            ts = ts[:256, :K]
        log(f"SIFT: base {xs.shape} queries {qs.shape}")
        qs_use = qs if len(qs) >= 4096 else np.tile(
            qs, (4096 // len(qs) + 1, 1))
        r = bench_ivf("ivf_sift", xs, qs_use, ts)
        if r:
            RESULTS.append(("ivf_sift", *r))

    if os.environ.get("TURDB_SIFT_PATH"):   # sift_dataset returns None otherwise
        section("ivf_sift", 240, _sift)

    if RESULTS:
        tag, qps_b, r_b, _ = max(RESULTS, key=lambda r: r[1])
        log(f"headline: {tag} {qps_b:,.0f} qps (recall {r_b:.4f})")
    emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
