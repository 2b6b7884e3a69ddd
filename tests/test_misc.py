"""TOAST chunking, parser robustness fuzz, perf-as-test throughput gates
(reference categories: toast.rs tests, fuzz targets, and the
single_insert/update/delete_benchmark.rs timing-assertion tests)."""

import random
import string
import time

import numpy as np
import pytest

from turdb_tpu.storage.toast import (
    ToastStore,
    is_pointer,
    maybe_detoast,
    maybe_toast,
)

random.seed(7)


class TestToast:
    def test_small_values_inline(self):
        st = ToastStore()
        v = b"x" * 100
        assert maybe_toast(st, v) == v

    def test_large_value_roundtrip(self):
        st = ToastStore()
        v = bytes(random.randbytes(10_000))
        p = maybe_toast(st, v)
        assert is_pointer(p) and len(p) == 17
        assert maybe_detoast(st, p) == v
        # chunk count: ceil(10000/4000) = 3
        assert len(st.chunks[1]) == 3

    def test_delete(self):
        st = ToastStore()
        p = st.toast(b"y" * 5000)
        st.delete(p)
        with pytest.raises(KeyError):
            st.detoast(p)


class TestParserFuzz:
    def test_random_garbage_never_crashes(self):
        """Any input must raise SqlError (with position), never another
        exception type — the reference enforces this via fuzz targets."""
        from turdb_tpu.sql.lexer import SqlError
        from turdb_tpu.sql.parser import parse_sql

        alphabet = string.printable
        for _ in range(500):
            sql = "".join(
                random.choice(alphabet) for _ in range(random.randint(1, 60))
            )
            try:
                parse_sql(sql)
            except SqlError:
                pass

    def test_mutated_valid_sql(self):
        from turdb_tpu.sql.lexer import SqlError
        from turdb_tpu.sql.parser import parse_sql

        base = (
            "SELECT a, COUNT(*) FROM t JOIN u ON t.id = u.id "
            "WHERE x BETWEEN 1 AND 5 GROUP BY a ORDER BY 2 DESC LIMIT 3"
        )
        for _ in range(300):
            chars = list(base)
            for _ in range(random.randint(1, 5)):
                i = random.randrange(len(chars))
                op = random.random()
                if op < 0.4:
                    chars[i] = random.choice(string.printable)
                elif op < 0.7:
                    del chars[i]
                else:
                    chars.insert(i, random.choice("()',;"))
            try:
                parse_sql("".join(chars))
            except SqlError:
                pass


class TestPerfGates:
    """Loose throughput floors (CPU venv): catch order-of-magnitude
    regressions, not absolute performance (that's bench.py on the GPU)."""

    def test_insert_throughput(self, tmp_path):
        from turdb_tpu.database.api import Database

        db = Database.create(str(tmp_path / "db"))
        db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v DOUBLE)")
        stmt = db.prepare("INSERT INTO t VALUES (?, ?)")
        n = 2000
        t0 = time.perf_counter()
        for i in range(n):
            stmt.execute([i, float(i)])
        dt = time.perf_counter() - t0
        rate = n / dt
        assert rate > 500, f"insert rate {rate:.0f}/s"
        db.close()

    def test_scan_throughput(self, tmp_path):
        from turdb_tpu.database.api import Database

        db = Database.create(str(tmp_path / "db"))
        db.execute("CREATE TABLE t (id BIGINT, v DOUBLE)")
        db.execute("PRAGMA wal_autoflush = false")
        for base in range(0, 20000, 1000):
            vals = ", ".join(f"({i}, {i}.5)" for i in range(base, base + 1000))
            db.execute(f"INSERT INTO t VALUES {vals}")
        t0 = time.perf_counter()
        rows = db.query("SELECT COUNT(*), SUM(v) FROM t WHERE id % 2 = 0")
        dt = time.perf_counter() - t0
        assert rows[0][0] == 10000
        # vectorized scan of 20k rows must be well under a second
        assert dt < 1.0, f"scan took {dt:.2f}s"
        db.close()

    def test_flat_knn_throughput(self):
        from turdb_tpu.models.flat import FlatIndex

        rng = np.random.default_rng(0)
        idx = FlatIndex(dim=64)
        idx.add(rng.standard_normal((20000, 64)).astype(np.float32))
        q = rng.standard_normal((64, 64)).astype(np.float32)
        idx.search(q, k=10)  # compile
        t0 = time.perf_counter()
        for _ in range(5):
            idx.search(q, k=10)
        dt = (time.perf_counter() - t0) / 5
        qps = 64 / dt
        assert qps > 300, f"flat knn {qps:.0f} qps"


class TestBulkInsert:
    def test_insert_batch_api(self, tmp_path):
        from turdb_tpu.database.api import ConstraintViolation, Database

        db = Database.create(str(tmp_path / "db"))
        db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v DOUBLE)")
        res = db.insert_batch("t", [{"id": i, "v": i * 0.5} for i in range(500)])
        assert res.rows_affected == 500
        assert db.query("SELECT COUNT(*), SUM(v) FROM t") == [(500, sum(i*0.5 for i in range(500)))]
        import pytest as _pt

        with _pt.raises(ConstraintViolation):
            db.insert_batch("t", [{"id": 1, "v": 0.0}])
        db.close()

    def test_bulk_insert_rate(self, tmp_path):
        from turdb_tpu.database.api import Database

        db = Database.create(str(tmp_path / "db"))
        db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, name TEXT, v DOUBLE)")
        rows = [{"id": i, "name": f"n{i}", "v": float(i)} for i in range(20000)]
        t0 = time.perf_counter()
        db.bulk_insert("t", rows)
        rate = 20000 / (time.perf_counter() - t0)
        # reference design target: >100K rows/s (src/lib.rs:66)
        assert rate > 5000, f"bulk rate {rate:,.0f}/s"
        assert db.query("SELECT COUNT(*) FROM t") == [(20000,)]
        db.close()

    def test_bulk_survives_reopen(self, tmp_path):
        from turdb_tpu.database.api import Database

        p = str(tmp_path / "db")
        db = Database.create(p)
        db.execute("CREATE TABLE t (a INT)")
        db.bulk_insert("t", [{"a": i} for i in range(100)])
        db.wal.flush()
        db2 = Database.open(p)  # crash-recovery path
        assert db2.query("SELECT COUNT(*) FROM t") == [(100,)]
        db2.close()
        db.close()


class TestSpill:
    def test_spilled_batch_roundtrip(self, tmp_path):
        import numpy as np
        from turdb_tpu.sql.expr import Batch, Col
        from turdb_tpu.sql.spill import SpilledBatch

        b = Batch(3)
        b.add("t", "a", Col(np.asarray([1, 2, 3], np.int64)))
        arr = np.empty(3, object)
        arr[:] = ["x", None, "z"]
        b.add("t", "s", Col(arr, np.asarray([False, True, False])))
        sp = SpilledBatch(b, str(tmp_path))
        b2 = sp.load()
        assert b2.n == 3 and b2.cols[0].values.tolist() == [1, 2, 3]
        assert b2.cols[1].values[2] == "z" and b2.cols[1].nulls[1]
        sp.close()

    def test_grace_join_under_tiny_budget(self, tmp_path):
        from turdb_tpu.database.api import Database

        db = Database.create(str(tmp_path / "db"))
        db.execute("CREATE TABLE a (id INT, v INT)")
        db.execute("CREATE TABLE b (id INT, w INT)")
        db.execute("PRAGMA wal_autoflush = false")
        rows_a = ", ".join(f"({i}, {i*2})" for i in range(2000))
        rows_b = ", ".join(f"({i}, {i*3})" for i in range(2000))
        db.execute(f"INSERT INTO a VALUES {rows_a}")
        db.execute(f"INSERT INTO b VALUES {rows_b}")
        # shrink the query pool so the grace path partitions
        db.budget.total = 40_000
        rows = db.query(
            "SELECT COUNT(*), SUM(a.v + b.w) FROM a JOIN b ON a.id = b.id"
        )
        assert rows == [(2000, sum(i * 5 for i in range(2000)))]
        db.close()


class TestPreparedPlans:
    """CachedInsertPlan (reference prepared.rs:106-158)."""

    def test_prepared_insert_plan(self, tmp_path):
        from turdb_tpu.database.api import Database

        db = Database.create(str(tmp_path / "pp"))
        db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v TEXT)")
        ps = db.prepare("INSERT INTO t VALUES ($1, $2)")
        for i in range(50):
            ps.execute([i, f"v{i}"])
        assert ps._plan  # the fast path actually engaged
        assert db.query("SELECT COUNT(*) FROM t") == [(50,)]
        # constraint still enforced through the plan
        import pytest as _pt

        with _pt.raises(Exception):
            ps.execute([0, "dup"])
        assert db.query("SELECT COUNT(*) FROM t") == [(50,)]

    def test_prepared_plan_survives_ddl(self, tmp_path):
        from turdb_tpu.database.api import Database

        db = Database.create(str(tmp_path / "pd"))
        db.execute("CREATE TABLE t (id BIGINT)")
        ps = db.prepare("INSERT INTO t (id) VALUES ($1)")
        ps.execute([1])
        db.execute("ALTER TABLE t ADD COLUMN extra TEXT")
        ps.execute([2])  # plan rebinds against the new TableInfo
        rows = db.query("SELECT id, extra FROM t ORDER BY id")
        assert rows == [(1, None), (2, None)]

    def test_prepared_faster_than_raw(self, tmp_path):
        import time

        from turdb_tpu.database.api import Database

        db = Database.create(str(tmp_path / "pf"))
        db.execute("PRAGMA wal_autoflush = false")
        db.execute("CREATE TABLE t (a BIGINT, b DOUBLE, c TEXT)")
        n = 2000
        t0 = time.perf_counter()
        for i in range(n):
            db.execute(f"INSERT INTO t VALUES ({i}, {i}.5, 'r{i}')")
        raw = time.perf_counter() - t0
        ps = db.prepare("INSERT INTO t VALUES ($1, $2, $3)")
        t0 = time.perf_counter()
        for i in range(n):
            ps.execute([i, i + 0.5, f"r{i}"])
        prep = time.perf_counter() - t0
        assert prep < raw, f"prepared {prep:.3f}s !< raw {raw:.3f}s"


class TestImportHygiene:
    def test_import_does_not_initialize_backend(self):
        """Importing the package (incl. the vector engines) must not
        create a device backend: module-scope jnp scalars would start
        one at import time, and a backend reserves most of the card's
        memory, so a second process on the card would fail (ops/topk.py
        INF regression)."""
        import subprocess
        import sys

        code = (
            "import turdb_tpu, turdb_tpu.models.ivf, turdb_tpu.models.hnsw,"
            "turdb_tpu.models.hnsw_serve, turdb_tpu.ops.topk\n"
            "from jax._src import xla_bridge\n"
            "assert not xla_bridge._backends, list(xla_bridge._backends)\n"
        )
        r = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, timeout=120,
        )
        assert r.returncode == 0, r.stderr.decode()[-500:]
