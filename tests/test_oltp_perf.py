"""OLTP perf-as-test gates (reference tests/single_insert_benchmark.rs
pattern + design targets lib.rs:64-66). Thresholds are set well below
what an idle machine measures, so CI noise doesn't flake them; they
exist to catch order-of-magnitude regressions of the fast lanes."""

import tempfile
import time

import pytest

from turdb_tpu.database.api import Database


@pytest.fixture()
def db():
    d = Database.create(tempfile.mkdtemp() + "/perf")
    yield d
    d.close()


def test_prepared_single_insert_rate(db):
    db.execute("PRAGMA wal = off")
    db.execute("CREATE TABLE t(id INT PRIMARY KEY, a INT, b TEXT, c DOUBLE)")
    stmt = db.prepare("INSERT INTO t VALUES ($1, $2, $3, $4)")
    for i in range(2000):
        stmt.execute([i, i * 2, f"name{i}", i * 0.5])
    n = 20000
    rate = 0.0
    for trial in range(2):   # best-of-2: this VM is burst-throttled
        t0 = time.perf_counter()
        base = 2000 + trial * n
        for i in range(base, base + n):
            stmt.execute([i, i * 2, f"name{i}", i * 0.5])
        rate = max(rate, n / (time.perf_counter() - t0))
        if rate > 50_000:
            break
    # codegen fast lane measures ~100-120k rows/s; gate leaves CI headroom
    assert rate > 50_000, f"prepared single insert {rate:,.0f} rows/s"


def test_prepared_single_insert_wal_on_rate(db):
    db.execute("CREATE TABLE t(id INT PRIMARY KEY, a INT)")
    stmt = db.prepare("INSERT INTO t VALUES ($1, $2)")
    for i in range(1000):
        stmt.execute([i, i])
    n = 10000
    t0 = time.perf_counter()
    for i in range(1000, 1000 + n):
        stmt.execute([i, i])
    rate = n / (time.perf_counter() - t0)
    assert rate > 15_000, f"wal-on prepared insert {rate:,.0f} rows/s"


def test_prepared_update_delete_rate(db):
    """Single-row prepared UPDATE/DELETE run on the round-5 C fast lanes
    (native/oltp.c exec_dml via CachedUpdatePlan/CachedDeletePlan:
    O(1) clean-single probe + scalar MVCC walk + stamp/version writes +
    WAL frame pair, one C call per row — reference
    tests/update_benchmark.rs / delete_benchmark.rs pattern). The C
    lanes run several times faster than the interpreted Python lane;
    the bar is >=50k each — gated at 80k, best-of-3 to ride out CI
    burst-throttling."""
    db.execute("PRAGMA wal = off")
    db.execute("CREATE TABLE t(id INT PRIMARY KEY, title TEXT, v DOUBLE)")
    st = db.prepare("INSERT INTO t VALUES ($1, $2, $3)")
    for i in range(40000):
        st.execute([i, f"title{i}", i * 1.0])
    up = db.prepare("UPDATE t SET title = $1, v = $2 WHERE id = $3")
    for i in range(200):
        up.execute([f"u{i}", i * 1.5, i])
    n = 10000
    rate = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(n):
            up.execute([f"upd{i}", i * 1.5, i])
        rate = max(rate, n / (time.perf_counter() - t0))
        if rate > 80_000:
            break
    assert rate > 80_000, f"prepared update {rate:,.0f} rows/s"
    assert db.query("SELECT title FROM t WHERE id = 5") == [("upd5",)]
    de = db.prepare("DELETE FROM t WHERE id = $1")
    rate = 0.0
    for trial in range(3):
        t0 = time.perf_counter()
        base = trial * n
        for i in range(base, base + n):
            de.execute([i])
        rate = max(rate, n / (time.perf_counter() - t0))
        if rate > 80_000:
            break
    assert rate > 80_000, f"prepared delete {rate:,.0f} rows/s"
    assert db.query("SELECT count(*) FROM t WHERE id < 30000") \
        == [(30000 - (trial + 1) * n,)]


def test_point_read_latency(db):
    db.execute("CREATE TABLE t(id INT PRIMARY KEY, b TEXT)")
    stmt = db.prepare("INSERT INTO t VALUES ($1, $2)")
    for i in range(20000):
        stmt.execute([i, f"v{i}"])
    q = db.prepare("SELECT b FROM t WHERE id = $1")
    for i in range(100):
        q.query([i])
    n = 5000
    t0 = time.perf_counter()
    for i in range(n):
        q.query([i * 3 % 20000])
    us = (time.perf_counter() - t0) / n * 1e6
    # reference design target: <50µs disk (lib.rs:64)
    assert us < 80, f"point read {us:.1f} us"
    assert q.query([7]) == [("v7",)]


def test_fast_lane_equivalence(db):
    """The fast insert lane must be semantically identical to the
    generic pipeline: constraint errors, duplicate keys, NULLs,
    reopen durability."""
    db.execute("CREATE TABLE t(id INT PRIMARY KEY, a INT NOT NULL, b TEXT)")
    stmt = db.prepare("INSERT INTO t VALUES ($1, $2, $3)")
    stmt.execute([1, 10, "x"])
    stmt.execute([2, 20, None])
    with pytest.raises(Exception):
        stmt.execute([1, 30, "dup"])       # duplicate pk
    with pytest.raises(Exception):
        stmt.execute([3, None, "nn"])      # NOT NULL
    # big value: bails to generic path and TOASTs
    stmt.execute([4, 40, "z" * 5000])
    assert db.query("SELECT length(b) FROM t WHERE id = 4") == [(5000,)]
    p = db.path
    db.close()
    db2 = Database.open(p)
    assert sorted(db2.query("SELECT id, a FROM t")) == [
        (1, 10), (2, 20), (4, 40)
    ]
    assert db2.query("SELECT b FROM t WHERE id = 2") == [(None,)]
    db2.close()


def test_point_read_nonnumeric_keys(tmp_path):
    """The point-read fast lane re-verifies index hits by direct value
    compare (round-3 micro-opt dropped the _py normalization) — pin the
    non-numeric key types."""
    from turdb_tpu.database.api import Database

    db = Database.create(str(tmp_path / "tk"))
    db.execute("CREATE TABLE t (k TEXT PRIMARY KEY, v INT)")
    st = db.prepare("INSERT INTO t VALUES ($1, $2)")
    for i in range(50):
        st.execute([f"key{i}", i])
    q = db.prepare("SELECT v FROM t WHERE k = $1")
    assert q.query(["key7"]) == [(7,)]
    assert q.query(["nope"]) == []
    db.execute("UPDATE t SET v = 700 WHERE k = 'key7'")
    assert q.query(["key7"]) == [(700,)]
    db.execute("DELETE FROM t WHERE k = 'key7'")
    assert q.query(["key7"]) == []
    db.execute("CREATE TABLE b (k BLOB PRIMARY KEY, v INT)")
    db.execute("INSERT INTO b VALUES (x'BEEF', 1)")
    qb = db.prepare("SELECT v FROM b WHERE k = $1")
    assert qb.query([b"\xbe\xef"]) == [(1,)]
    db.close()


def test_point_read_toasted_key(tmp_path):
    """Review-found: the fast lane's key re-verify must detoast stored
    pointer values before comparing (big keys silently returned [])."""
    from turdb_tpu.database.api import Database

    db = Database.create(str(tmp_path / "toastk"))
    db.execute("CREATE TABLE t (k TEXT PRIMARY KEY, v INT)")
    big = "x" * 1500                     # > TOAST threshold (1000B)
    db.execute(f"INSERT INTO t VALUES ('{big}', 42)")
    q = db.prepare("SELECT v FROM t WHERE k = $1")
    assert q.query([big]) == [(42,)]
    assert q.query([big + "y"]) == []
    db.close()


def test_c_store_lane_semantics(tmp_path):
    """Round-3 C store lane (oltp.c store_row + autocommit stamps +
    fused WAL frame pair): interleave with explicit txns/rollbacks,
    coercion, and crash-replay durability must match the generic path."""
    path = str(tmp_path / "cstore")
    db = Database.create(path)
    db.execute("CREATE TABLE t(id INT PRIMARY KEY, a INT, c DOUBLE, "
               "d BOOL, b TEXT)")
    stmt = db.prepare("INSERT INTO t VALUES ($1, $2, $3, $4, $5)")
    stmt.execute([1, 10, 1.5, True, "x"])
    db.execute("BEGIN")
    db.execute("INSERT INTO t VALUES (2, 20, 2.5, false, 'y')")
    db.execute("ROLLBACK")
    stmt.execute([3, 30, 3, False, None])     # int->float coercion
    db.execute("BEGIN")
    stmt.execute([4, 40, 4.5, None, "w"])     # in-txn: generic path
    db.execute("ROLLBACK")
    stmt.execute([5, None, None, None, None])
    assert db.query("SELECT id, a, c, d FROM t ORDER BY id") == [
        (1, 10, 1.5, True), (3, 30, 3.0, False), (5, None, None, None),
    ]
    db.wal.flush()
    del db, stmt                               # crash: no checkpoint
    db2 = Database.open(path)
    assert db2.query("SELECT id, a, c, d FROM t ORDER BY id") == [
        (1, 10, 1.5, True), (3, 30, 3.0, False), (5, None, None, None),
    ]
    assert db2.query("SELECT b FROM t WHERE id = 1") == [("x",)]
    db2.close()


def test_wal_frame_pair_bytes():
    """wal_frame_pair must be byte-identical to two wal_frame calls
    (replay sees the same stream either way)."""
    from turdb_tpu.native.build import oltp

    nat = oltp()
    if nat is None or not hasattr(nat, "wal_frame_pair"):
        pytest.skip("no native toolchain")
    payload = b"\x07\x00rec" * 33
    assert nat.wal_frame_pair(3, 9, 77, 5, payload, 4) == (
        nat.wal_frame(3, 9, 77, 5, payload) + nat.wal_frame(4, 0, 78, 5, b"")
    )


def test_group_commit_scaling(tmp_path):
    """Concurrent committers at synchronous=FULL share fsyncs (group
    commit, reference group_commit.rs:8-30). Two assertions:
    - batching: 4 threads need strictly fewer fsyncs than rows (the
      leader's fsync covers every follower that wrote before it), and
    - throughput: with a deterministic 1ms simulated commit latency
      (real disks are 0.5-10ms; this box's buffer-cache fsync is an
      unrepresentative ~0.1ms) the 4-thread rate is >=2x one thread.
    """
    import os as _os
    import threading

    import turdb_tpu.storage.wal as walmod

    real_fsync = _os.fsync
    counts = {"n": 0}

    def slow_fsync(fd):
        counts["n"] += 1
        real_fsync(fd)
        time.sleep(0.001)

    walmod.os.fsync = slow_fsync
    try:
        def run(nthreads, n_per):
            db = Database.create(str(tmp_path / f"g{nthreads}"))
            db.execute("PRAGMA synchronous = FULL")
            stmts = []
            for t in range(nthreads):
                db.execute(f"CREATE TABLE t{t}(id BIGINT PRIMARY KEY, v TEXT)")
                stmts.append(db.prepare(f"INSERT INTO t{t} VALUES (?, ?)"))
                stmts[-1].execute([-1, "warm"])
            def work(t):
                st = stmts[t]
                for i in range(n_per):
                    st.execute([i, "x"])
            ths = [threading.Thread(target=work, args=(t,))
                   for t in range(nthreads)]
            c0 = counts["n"]
            t0 = time.perf_counter()
            for th in ths:
                th.start()
            for th in ths:
                th.join()
            dt = time.perf_counter() - t0
            for t in range(nthreads):
                assert db.query(f"SELECT count(*) FROM t{t}")[0] == (n_per + 1,)
            db.close()
            return nthreads * n_per / dt, counts["n"] - c0

        # best-of-2: on a loaded CI box the single-thread leg can run
        # artificially fast (its fsync sleeps overlap the noise) and the
        # ratio dips below 2x — a scheduling artifact, not a batching
        # regression; the fsync-sharing assertion is the hard invariant
        for attempt in range(2):
            r1, f1 = run(1, 300)
            r4, f4 = run(4, 300)
            assert f4 < 1200 * 0.75, f"4-thread fsyncs {f4} (no batching)"
            if r4 >= 2.0 * r1:
                break
            for t in range(2):
                p = tmp_path / f"g{1 if t == 0 else 4}"
                import shutil

                shutil.rmtree(p, ignore_errors=True)
        assert r4 >= 2.0 * r1, (
            f"group commit scaling {r4 / r1:.2f}x ({r1:,.0f} -> {r4:,.0f})"
        )
    finally:
        walmod.os.fsync = real_fsync
