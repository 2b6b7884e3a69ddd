"""Global phase timing counters.

Counterpart of reference src/database/timing.rs:116-223 (atomic nanosecond
counters per phase: parse, insert breakdown, WAL, MVCC) — here a plain
dict of accumulators (GIL-serialized) with a context manager, queryable
via PRAGMA timing_stats. Device-side profiling uses jax.profiler traces
(`profile_trace`) — the device analog of the reference's flamegraph
workflow.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

TIMERS: dict[str, dict] = defaultdict(lambda: {"ns": 0, "count": 0})
_ENABLED = True


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def reset():
    TIMERS.clear()


@contextlib.contextmanager
def timed(name: str):
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        t = TIMERS[name]
        t["ns"] += time.perf_counter_ns() - t0
        t["count"] += 1


def timing_stats() -> list[tuple]:
    """(phase, total_ms, count, avg_us) rows, sorted by total time."""
    rows = []
    for name, t in TIMERS.items():
        avg_us = (t["ns"] / t["count"] / 1e3) if t["count"] else 0.0
        rows.append((name, round(t["ns"] / 1e6, 3), t["count"], round(avg_us, 2)))
    return sorted(rows, key=lambda r: -r[1])


class PhaseTimer:
    """Device-synchronized phase marks: mark(label, *device_arrays)
    waits for the given arrays (and so for the work that produced them)
    and records the wall span since the previous mark. The reference
    keeps an insert-cost breakdown table (TARGET_BENCH.md:230-247); this
    is the build-phase analog."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: list[tuple[str, float]] = []
        self._t0 = time.perf_counter()

    def mark(self, label: str, *arrays):
        if not self.enabled:
            return
        import jax

        jax.block_until_ready(arrays)
        t = time.perf_counter()
        self.spans.append((label, t - self._t0))
        self._t0 = t

    def table(self) -> str:
        total = sum(s for _, s in self.spans) or 1.0
        rows = [
            f"{lbl}={s:.1f}s({100 * s / total:.0f}%)"
            for lbl, s in self.spans
        ]
        return " ".join(rows)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a jax.profiler trace around a block (view with
    tensorboard/xprof) — device-side counterpart of the counters."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
