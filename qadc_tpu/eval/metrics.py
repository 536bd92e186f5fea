"""Phase metrics and CSV output.

Reference: query_metrics (query_common.hpp:21-56) — µs timers around the
index/rotate/table/scan phases, averaged over queries, emitted as a CSV row
(db_query_4.cpp:387-390). Here whole-pipeline phases are fused under jit, so
phase timing is measured by running the phases as separate jitted calls with
block_until_ready (used by the benchmark harness); production search uses the
fused path and reports end-to-end latency.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class QueryMetrics:
    """Accumulated per-phase microseconds (averaged like the reference)."""

    index_us: float = 0.0
    rotate_us: float = 0.0
    table_us: float = 0.0
    scan_us: float = 0.0
    count: int = 0

    HEADER = "index_us,rotate_us,table_us,scan_us"

    def add(self, index_us=0.0, rotate_us=0.0, table_us=0.0, scan_us=0.0):
        self.index_us += index_us
        self.rotate_us += rotate_us
        self.table_us += table_us
        self.scan_us += scan_us
        self.count += 1

    def averaged(self) -> "QueryMetrics":
        c = max(self.count, 1)
        return QueryMetrics(
            self.index_us / c, self.rotate_us / c, self.table_us / c, self.scan_us / c, 1
        )

    def csv_row(self) -> str:
        a = self.averaged()
        return f"{a.index_us:.0f},{a.rotate_us:.0f},{a.table_us:.0f},{a.scan_us:.0f}"


class PhaseTimer:
    """Context-style µs timer (reference ustime(), common.hpp:17-21)."""

    def __init__(self):
        self.start = time.perf_counter()

    def lap_us(self) -> float:
        now = time.perf_counter()
        us = (now - self.start) * 1e6
        self.start = now
        return us
