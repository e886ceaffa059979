"""Utilities / observability / config (L1).

Port of `zkevm_prover_tpu/utils/__init__.py`: host copies of the same modules.

Framework counterpart of the reference's src/utils + src/config (SURVEY.md
§2 L1, §5): zklog-style structured logging, TimerStart/TimerStopAndLog phase
timers with TimeMetricStorage aggregation, and the flat Config with JSON +
environment-variable overrides. The Watchdog comes with the aggregator
client, its one user.
"""

from .config import Config
from .timers import TimeMetricStorage, timer
from .zklog import zklog

__all__ = ["Config", "TimeMetricStorage", "timer", "zklog"]
