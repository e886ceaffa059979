"""Phase timers + per-operation statistics.

Port of `zkevm_prover_tpu/utils/timers.py`: a host copy, the same timers.

Reference: TimerStart/TimerStopAndLog macros (src/utils/timer.hpp:17-27) that
instrument every proving phase (STARK_STEP_1_LDE etc., the reference's de
facto benchmark mechanism) and TimeMetricStorage (src/utils/time_metric.cpp)
for aggregated per-op tables behind executorTimeStatistics.
"""

from __future__ import annotations

import contextlib
import threading
import time

from .zklog import zklog


class TimeMetricStorage:
    """Aggregated (count, total) per label; print() mirrors the reference's
    statistics tables."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._metrics: dict[str, tuple[int, float]] = {}

    def add(self, label: str, seconds: float) -> None:
        with self._lock:
            cnt, tot = self._metrics.get(label, (0, 0.0))
            self._metrics[label] = (cnt + 1, tot + seconds)

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {
                k: {"count": c, "total_s": t, "avg_s": t / c}
                for k, (c, t) in self._metrics.items()
            }

    def print(self) -> None:
        for label, row in sorted(
            self.snapshot().items(), key=lambda kv: -kv[1]["total_s"]
        ):
            zklog.info(
                f"{self.name} {label}: n={row['count']} "
                f"total={row['total_s']:.3f}s avg={row['avg_s'] * 1e3:.1f}ms"
            )


@contextlib.contextmanager
def timer(label: str, storage: TimeMetricStorage | None = None,
          log: bool = True):
    """with timer("STARK_STEP_1_LDE"): ... — TimerStart/TimerStopAndLog."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if storage is not None:
            storage.add(label, dt)
        if log:
            zklog.info(f"{label}: {dt:.3f} s")
