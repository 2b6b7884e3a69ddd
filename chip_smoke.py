"""End-to-end smoke run of the vector engine and its SQL path on one GPU.

    python chip_smoke.py                 # one card, full size (1M x 128-d)
    python chip_smoke.py --four-cards    # sharded IVF + HNSW over 4 cards
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse   # tiny CPU rehearsal

Each phase prints one line and stops the run with a non-zero exit when its
check fails. The last line of a passing run is one JSON object naming the
device as JAX reports it. Without an accelerator the default run exits
non-zero and prints no result; `--rehearse` runs every phase at a tiny
size on whatever backend JAX has and reports that backend.

Data is a seeded clustered pool (the SIFT-1M class: 1M x 128-d f32 plus
16,384 queries); the plain reference for every index is exact search
(`FlatIndex`), itself checked against numpy float64.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from turdb_tpu.utils.datasets import make_pool, recall_of

K = 10
DIM = 128
RECALL_GATE = 0.95
SAMPLE = 256                  # recall queries
TIMED_BATCH = 1024
IVF_PROBES = (2, 4, 5, 6, 8, 16, 32, 64)
IVF_SQ8_PROBES = (4, 8, 16, 32, 64, 128)
HNSW_SWEEP = ((32, 24), (48, 32), (64, 48), (96, 96), (128, 160))


def fail(msg: str) -> None:
    raise SystemExit(f"FAILED: {msg}")


def say(line: str) -> None:
    print(line, flush=True)


class CompileClock:
    """Sums JAX's compile-event durations (tracing, lowering, backend
    compile) so a phase can report compile time apart from run time."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, secs, **_):
        if name.startswith("/jax/core/compile/"):
            self.total += secs

    def since(self, mark: float) -> float:
        return self.total - mark


def memory_note() -> str:
    """Peak device memory so far, per device (memory_stats is None on
    the CPU backend)."""
    import jax

    peaks = []
    for dev in jax.devices():
        stats = dev.memory_stats()
        peaks.append(str(stats.get("peak_bytes_in_use")) if stats else "n/a")
    return f"peak_bytes_in_use={','.join(peaks)}"


def timed_call(fn):
    """Wall seconds of fn() with every device result ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(args) -> dict:
    import jax

    from turdb_tpu.utils.device import device_info

    dev = device_info()
    want = 4 if args.four_cards else 1
    if not args.rehearse:
        if dev["platform"] != "gpu":
            say(f"ok: false (no GPU: JAX platform is {dev['platform']!r})")
            raise SystemExit(1)
        if dev["count"] < want:
            fail(f"need {want} GPUs, JAX sees {dev['count']}")
    say(f"phase device: ok platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']} jax={jax.__version__}")
    return dev


def phase_oracle(x, queries) -> np.ndarray:
    """Exact top-10 / top-50 for the recall sample; 32 queries checked
    against numpy float64. FlatIndex computes its distances in full f32
    (PRECISE = HIGHEST: no TF32 passes), so each reported distance must
    match float64 within the f32 rounding of the expanded L2 form,
    ‖q‖² + ‖x‖² − 2q·x: tol = 1e-5 · (‖q‖² + max‖x‖²)."""
    from turdb_tpu.models.flat import FlatIndex

    sample = queries[:SAMPLE]
    t0 = time.perf_counter()
    flat = FlatIndex(dim=x.shape[1], capacity=len(x))
    flat.add(x)
    _, truth = flat.search(sample, k=K)
    d50, truth50 = flat.search(sample, k=50)
    secs = time.perf_counter() - t0

    q64 = sample[:32].astype(np.float64)
    x64 = x.astype(np.float64)
    xn = np.einsum("ij,ij->i", x64, x64)
    ref = (np.einsum("ij,ij->i", q64, q64)[:, None] + xn[None, :]
           - 2.0 * q64 @ x64.T)
    tol = 1e-5 * (np.einsum("ij,ij->i", q64, q64) + xn.max())
    worst = 0.0
    for j in range(32):
        got_ids, got_d = truth50[j], d50[j]
        if (got_ids < 0).any():
            fail(f"oracle returned padding ids for query {j}")
        # each reported distance is the float64 distance of its id
        err_id = np.abs(ref[j, got_ids] - got_d).max()
        # nothing closer was missed: the reported k-th distance is the
        # float64 k-th smallest (ties within tol are fine)
        kth = np.partition(ref[j], 49)[:50].max()
        err_kth = abs(got_d[-1] - kth)
        worst = max(worst, float(max(err_id, err_kth) / tol[j]))
        if err_id > tol[j] or err_kth > tol[j]:
            fail(f"oracle query {j}: |err| {max(err_id, err_kth):.3g} "
                 f"> tol {tol[j]:.3g}")
    if not np.array_equal(truth, truth50[:, :K]):
        diff = int((truth != truth50[:, :K]).any(axis=1).sum())
        # a k=10 and a k=50 search may order exact ties differently
        if recall_of(truth, truth50[:, :K]) < 0.999:
            fail(f"top-10 and top-50 oracles disagree on {diff} queries")
    say(f"phase oracle: ok n={len(x)} queries={SAMPLE} k=10,50 "
        f"build+search={secs:.2f}s precision=HIGHEST(f32) "
        f"float64_check=32q worst_err/tol={worst:.3g} "
        f"tol=1e-5*(|q|^2+max|x|^2) {memory_note()}")
    del flat
    return truth


def _ivf_phase(tag, x, queries, truth, clock, probes, **kw):
    from turdb_tpu.models.ivf import IvfIndex

    import jax
    import jax.numpy as jnp

    sample = queries[:SAMPLE]
    mark = clock.total
    t0 = time.perf_counter()
    idx = IvfIndex(dim=x.shape[1], **kw)
    idx.add(x)          # trains once the staged rows warrant it
    idx.train()         # no-op when add() already trained
    jax.block_until_ready(idx.state.members)
    train_s = time.perf_counter() - t0
    compile_s = clock.since(mark)
    sweep = []
    star = None
    for nprobe in probes:
        _, ids = idx.search(sample, k=K, nprobe=nprobe)
        r = recall_of(ids, truth)
        sweep.append(f"{nprobe}:{r:.4f}")
        if r >= RECALL_GATE:
            star = (nprobe, r)
            break
    if star is None:
        fail(f"{tag}: recall@10 gate {RECALL_GATE} not reached "
             f"(sweep {' '.join(sweep)})")
    nprobe, r = star
    qb = jnp.asarray(queries[SAMPLE:SAMPLE + TIMED_BATCH])
    mark = clock.total
    first_s = timed_call(lambda: idx.search(qb, k=K, nprobe=nprobe, out="jax"))
    first_compile = clock.since(mark)
    batch_s = timed_call(lambda: idx.search(qb, k=K, nprobe=nprobe, out="jax"))
    cfg = idx.cfg
    say(f"phase {tag}: ok nprobe={nprobe} recall@10={r:.4f} "
        f"sweep=[{' '.join(sweep)}] C={cfg.n_clusters} L={cfg.cluster_cap} "
        f"train={train_s:.2f}s (compile {compile_s:.2f}s) "
        f"batch{qb.shape[0]}: first={first_s:.4f}s "
        f"(compile {first_compile:.2f}s) timed={batch_s:.4f}s "
        f"qps={qb.shape[0] / batch_s:.0f} {memory_note()}")
    return idx, nprobe


def int8_exactness(shape_codes) -> str:
    """The s8 x s8 -> s32 probe product at real widths vs numpy int32.
    Full-range operands (-128..127) so any lossy path would show."""
    import jax
    import jax.numpy as jnp

    from turdb_tpu.ops.quantize import int8_dot

    rng = np.random.default_rng(5)
    b, d = shape_codes[0], shape_codes[-1]
    qc = rng.integers(-128, 128, size=(b, d), dtype=np.int8)
    codes = rng.integers(-128, 128, size=shape_codes, dtype=np.int8)
    fn = jax.jit(int8_dot)
    compiled = fn.lower(jnp.asarray(qc), jnp.asarray(codes)).compile()
    got = np.asarray(compiled(jnp.asarray(qc), jnp.asarray(codes)))
    want = np.einsum("bd,b...d->b...", qc.astype(np.int32),
                     codes.astype(np.int32))
    if got.dtype != np.int32 or not np.array_equal(got, want):
        bad = int((got != want).sum())
        fail(f"int8_dot {shape_codes}: {bad} entries differ from numpy")
    mem = compiled.memory_analysis()
    temp = getattr(mem, "temp_size_in_bytes", "n/a") if mem else "n/a"
    return f"{'x'.join(map(str, shape_codes))}:exact(temp={temp})"


def phase_hnsw(x, queries, truth, clock) -> None:
    import jax
    import jax.numpy as jnp

    from turdb_tpu.models.hnsw import HnswIndex

    sample = queries[:SAMPLE]
    mark = clock.total
    t0 = time.perf_counter()
    idx = HnswIndex(dim=x.shape[1], ef_construction=100, build_batch=512,
                    capacity=len(x))
    idx.add(x)
    jax.block_until_ready(idx.state.adj0)
    build_s = time.perf_counter() - t0
    build_compile = clock.since(mark)
    mark = clock.total
    t0 = time.perf_counter()
    idx.pack_serving()
    jax.block_until_ready(idx.serve.nbr_codes)
    pack_s = time.perf_counter() - t0
    pack_compile = clock.since(mark)
    sweep = []
    star = None
    for ef, iters in HNSW_SWEEP:
        _, ids = idx.search_serve(sample, k=K, ef=ef, iters=iters)
        r = recall_of(ids, truth)
        sweep.append(f"{ef}/{iters}:{r:.4f}")
        if r >= RECALL_GATE:
            star = (ef, iters, r)
            break
    if star is None:
        fail(f"hnsw: recall@10 gate not reached (sweep {' '.join(sweep)})")
    ef, iters, r = star
    qb = jnp.asarray(queries[SAMPLE:SAMPLE + TIMED_BATCH])
    timed_call(lambda: idx.search_serve(qb, k=K, ef=ef, iters=iters,
                                        out="jax"))
    batch_s = timed_call(lambda: idx.search_serve(qb, k=K, ef=ef,
                                                  iters=iters, out="jax"))
    say(f"phase hnsw: ok n={len(x)} ef={ef} iters={iters} recall@10={r:.4f} "
        f"sweep=[{' '.join(sweep)}] build={build_s:.2f}s "
        f"(compile {build_compile:.2f}s) pack={pack_s:.2f}s "
        f"(compile {pack_compile:.2f}s) batch{qb.shape[0]}={batch_s:.4f}s "
        f"qps={qb.shape[0] / batch_s:.0f} {memory_note()}")


def phase_sql(x, queries, truth, nprobe) -> None:
    """The served path: SQL through `Database`, answered by the IVF
    index, must return the engine's own answer for each query."""
    from turdb_tpu.database.api import Database

    n = len(x)
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="turdb_smoke_") as tmp:
        db = Database.create(os.path.join(tmp, "db"))
        db.execute(f"CREATE TABLE items (id BIGINT PRIMARY KEY, "
                   f"emb VECTOR({x.shape[1]}))")
        t0 = time.perf_counter()
        db.bulk_insert("items", {"id": np.arange(n, dtype=np.int64),
                                 "emb": x})
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        db.execute(f"CREATE INDEX items_emb ON items USING IVF (emb) "
                   f"WITH (nprobe = {nprobe})")
        index_s = time.perf_counter() - t0
        stmt = db.prepare("SELECT id FROM items ORDER BY emb <-> $1 LIMIT 10")
        info = db.catalog["main"]["items"]
        h = info.hnsw["items_emb"]
        # the SQL ANN path over-fetches 4x and searches at
        # nprobe = max(index nprobe, ef // 8) with ef = max(64, 2 * fetch)
        fetch = min(max(K * db.ann_overfetch, K + 8), n)
        p_eff = max(h.index.nprobe, max(64, 2 * fetch) // 8)
        tbl = info.table
        order = np.argsort(tbl.rowids[:tbl.nversions], kind="stable")
        ids_by_pos = tbl.cols["id"][:tbl.nversions]
        got_all = []
        t0 = time.perf_counter()
        for j in range(8):
            q = queries[j]
            sql_ids = [r[0] for r in stmt.query([
                "[" + ",".join(repr(float(v)) for v in q) + "]"])]
            _, slots = h.index.search(q[None], k=K, nprobe=p_eff)
            rowids = h._slots_to_rowids(slots[0])
            pos = order[np.searchsorted(tbl.rowids[:tbl.nversions], rowids,
                                        sorter=order)]
            eng_ids = ids_by_pos[pos].tolist()
            if set(sql_ids) != set(eng_ids):
                fail(f"sql query {j}: SQL {sql_ids} != engine {eng_ids}")
            got_all.append(np.asarray(sql_ids))
        query_s = (time.perf_counter() - t0) / 8
        db.close()
    r = recall_of(np.stack(got_all), truth[:8])
    say(f"phase sql: ok rows={n} bulk_insert={load_s:.2f}s "
        f"create_index={index_s:.2f}s queries=8 equal_to_engine=8/8 "
        f"nprobe={p_eff} recall@10={r:.4f} per_query={query_s:.4f}s "
        f"total={time.perf_counter() - t_all:.2f}s {memory_note()}")


def _time_select(fn, rows, k, reps=5):
    """Median seconds per [B, W] selection, measured over a scan of
    `rows.shape[0]` distinct inputs inside one program."""
    import jax

    @jax.jit
    def run(xs):
        return jax.lax.map(lambda d: fn(d, k), xs)

    out = run(rows)
    jax.block_until_ready(out)
    times = []
    for _ in range(reps):
        times.append(timed_call(lambda: run(rows)) / rows.shape[0])
    return float(np.median(times)), out


def phase_topk(widths) -> None:
    """lax.top_k against the two-level selector at the widths the probes
    really use; both must select the same values."""
    import jax
    import jax.numpy as jnp

    from turdb_tpu.ops.topk import topk_smallest_wide

    def full(d, k):
        neg, pos = jax.lax.top_k(-d, k)
        return -neg, pos

    parts = []
    key = jax.random.PRNGKey(3)
    for name, b, w, k in widths:
        m = 8
        rows = jax.random.normal(key, (m, b, w), jnp.float32)
        t_full, (vf, _) = _time_select(full, rows, k)
        t_wide, (vw, _) = _time_select(topk_smallest_wide, rows, k)
        if not np.allclose(np.asarray(vf), np.asarray(vw)):
            fail(f"topk {name}: lax.top_k and topk_smallest_wide disagree")
        parts.append(f"{name}[{b}x{w},k={k}]: lax.top_k={t_full * 1e6:.1f}us "
                     f"wide={t_wide * 1e6:.1f}us")
    say(f"phase topk: ok {' ; '.join(parts)} {memory_note()}")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _shard_devices(tree) -> set:
    import jax

    devs = set()
    for leaf in jax.tree.leaves(tree):
        for s in leaf.addressable_shards:
            devs.add(s.device)
    return devs


def run_four_cards(x, queries, truth, clock) -> None:
    import jax

    from turdb_tpu.parallel.mesh import make_mesh
    from turdb_tpu.parallel.sharded import ShardedHnswIndex
    from turdb_tpu.parallel.sharded_ivf import ShardedIvfIndex

    n_dev = 4
    mesh = make_mesh(n_db=n_dev, devices=jax.devices()[:n_dev])
    sample = queries[:SAMPLE]

    mark = clock.total
    t0 = time.perf_counter()
    ivf = ShardedIvfIndex(dim=x.shape[1], mesh=mesh)
    gids = ivf.add(x)
    ivf.train()
    jax.block_until_ready(ivf._stacked)
    train_s = time.perf_counter() - t0
    devs = _shard_devices(ivf._stacked)
    if len(devs) != n_dev:
        fail(f"sharded IVF state sits on {len(devs)} devices, not {n_dev}")
    truth_g = gids[truth]
    sweep, star = [], None
    for nprobe in IVF_PROBES:
        _, g = ivf.search(sample, k=K, nprobe=nprobe)
        r = recall_of(g, truth_g)
        sweep.append(f"{nprobe}:{r:.4f}")
        if r >= RECALL_GATE:
            star = (nprobe, r)
            break
    if star is None:
        fail(f"sharded ivf: recall gate not reached ({' '.join(sweep)})")
    say(f"phase sharded_ivf: ok n={len(x)} shards={ivf.n_shards} "
        f"devices={sorted(d.id for d in devs)} nprobe={star[0]} "
        f"recall@10={star[1]:.4f} sweep=[{' '.join(sweep)}] "
        f"train={train_s:.2f}s (compile {clock.since(mark):.2f}s) "
        f"{memory_note()}")
    del ivf

    mark = clock.total
    t0 = time.perf_counter()
    hn = ShardedHnswIndex(dim=x.shape[1], mesh=mesh,
                          capacity_per_shard=-(-len(x) // n_dev) + 1)
    gids = hn.add(x)
    hn.pack_serving()
    jax.block_until_ready(hn._serve)
    build_s = time.perf_counter() - t0
    devs = _shard_devices(hn._serve)
    if len(devs) != n_dev:
        fail(f"sharded HNSW pack sits on {len(devs)} devices, not {n_dev}")
    truth_g = gids[truth]
    sweep, star = [], None
    for ef, iters in HNSW_SWEEP:
        _, g = hn.search_serve(sample, k=K, ef=ef, iters=iters)
        r = recall_of(g, truth_g)
        sweep.append(f"{ef}/{iters}:{r:.4f}")
        if r >= RECALL_GATE:
            star = (ef, iters, r)
            break
    if star is None:
        fail(f"sharded hnsw: recall gate not reached ({' '.join(sweep)})")
    say(f"phase sharded_hnsw: ok n={len(x)} shards={hn.n_shards} "
        f"devices={sorted(d.id for d in devs)} ef={star[0]} "
        f"recall@10={star[2]:.4f} sweep=[{' '.join(sweep)}] "
        f"build+pack={build_s:.2f}s (compile {clock.since(mark):.2f}s, "
        f"summed over build threads) {memory_note()}")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path over 4 cards")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on whatever backend JAX has (CPU tests)")
    ap.add_argument("--n", type=int, default=None,
                    help="vectors (default 1M per card; rehearse: 20k)")
    ap.add_argument("--queries", type=int, default=None,
                    help="query pool size (default 16384; rehearse: 2048)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="oracle,ivf_f32,ivf_sq8,hnsw,sql,topk",
                    help="comma list of one-card phases to run")
    args = ap.parse_args(argv)
    per_card = 20_000 if args.rehearse else 1_000_000
    if args.n is None:
        args.n = per_card * (4 if args.four_cards else 1)
    if args.queries is None:
        args.queries = 2048 if args.rehearse else 16_384
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    from turdb_tpu.utils.compile_cache import use_compile_cache
    from turdb_tpu.utils.device import gpu_name_and_power

    cache = use_compile_cache()
    clock = CompileClock()
    device = phase_device(args)
    smi = None if args.rehearse else gpu_name_and_power()
    say(f"nvidia-smi: {smi or 'not queried (rehearsal)'}")
    say(f"compile cache: {cache}")

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    pool = make_pool(rng, args.n + args.queries, DIM)
    x, queries = pool[:args.n], pool[args.n:]
    say(f"data: n={args.n} dim={DIM} queries={args.queries} "
        f"seed={args.seed} made in {time.perf_counter() - t0:.2f}s")

    truth = phase_oracle(x, queries)
    if args.four_cards:
        run_four_cards(x, queries, truth, clock)
    else:
        phases = set(args.phases.split(","))
        widths = []
        if "ivf_f32" in phases or "sql" in phases:
            idx, nprobe = _ivf_phase("ivf_f32", x, queries, truth, clock,
                                     IVF_PROBES)
            widths.append(("cell_scoring", TIMED_BATCH, idx.cfg.n_clusters,
                           nprobe))
            del idx
        if "ivf_sq8" in phases:
            idx, p8 = _ivf_phase("ivf_sq8", x, queries, truth, clock,
                                 IVF_SQ8_PROBES, sq8=True, rerank=4 * K)
            cfg = idx.cfg
            checks = [
                int8_exactness((64, 8, 256, DIM)),
                int8_exactness((64, 4, 32, DIM)),
            ]
            say(f"phase int8_dot: ok s8xs8->s32 vs numpy int32 "
                f"{' '.join(checks)}")
            widths.append(("sq8_cells", TIMED_BATCH, cfg.n_clusters, p8))
            widths.append(("sq8_rerank", TIMED_BATCH,
                           p8 * cfg.cluster_cap, cfg.rerank))
            del idx
        if "hnsw" in phases:
            phase_hnsw(x, queries, truth, clock)
        if "sql" in phases:
            phase_sql(x, queries, truth, nprobe)
        if "topk" in phases:
            widths.append(("flat_chunk", SAMPLE, min(131072, args.n), 50))
            phase_topk(widths)
    say(f"compile total: {clock.total:.2f}s")
    say(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
