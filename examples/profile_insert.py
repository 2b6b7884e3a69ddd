"""Insert-path profiler (reference examples/profile_insert.rs).

Profiles the prepared single-row insert path using the phase timing
counters (turdb_tpu/utils/timing.py — the reference's database::timing
analog) plus a wall-clock rate, and prints the per-phase breakdown that
`PRAGMA timing_stats` exposes in SQL.

Usage:  JAX_PLATFORMS=cpu python examples/profile_insert.py [N_ROWS]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time  # noqa: E402

from turdb_tpu.database.api import Database
from turdb_tpu.utils import timing


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30_000
    db = Database.create(tempfile.mkdtemp() + "/profile")
    db.execute("PRAGMA wal = off")
    db.execute(
        "CREATE TABLE t (id INT PRIMARY KEY, a INT, b TEXT, c DOUBLE)"
    )
    stmt = db.prepare("INSERT INTO t VALUES ($1, $2, $3, $4)")
    for i in range(2000):                      # warm the fast lane
        stmt.execute([i, i * 2, f"name{i}", i * 0.5])
    timing.reset()

    t0 = time.perf_counter()
    for i in range(2000, 2000 + n):
        stmt.execute([i, i * 2, f"name{i}", i * 0.5])
    wall = time.perf_counter() - t0

    print(f"{n} prepared inserts in {wall:.3f}s = {n / wall:,.0f} rows/s "
          f"({wall / n * 1e9:,.0f} ns/row)")
    rows = timing.timing_stats()
    if rows:
        print(f"{'phase':<28}{'total_ms':>10}{'count':>10}{'avg_us':>9}")
        for phase, total_ms, count, avg_us in rows:
            print(f"{phase:<28}{total_ms:>10.2f}{count:>10}{avg_us:>9.2f}")
    else:
        print("(phase counters idle: the generated fast lane handles the "
              "whole row — see PRAGMA timing_stats for the generic path)")
    db.close()


if __name__ == "__main__":
    main()
