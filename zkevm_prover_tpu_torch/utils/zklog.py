"""zklog — mutex-guarded structured logging with PID prefix.

Port of `zkevm_prover_tpu/utils/zklog.py`: a host copy, the same logger.

Reference: src/utils/zklog.{hpp,cpp} — info/warning/error with pid+thread
prefix and optional JSON-lines output (config.jsonLogs, main.cpp:315-317),
plus per-request LogTags (zklog.hpp:18-24).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time


class _ZkLog:
    def __init__(self):
        self._lock = threading.Lock()
        self.json_logs = False
        self._pid = os.getpid()

    def set_json_logs(self, enabled: bool) -> None:
        self.json_logs = enabled

    def _emit(self, level: str, message: str, tags: dict | None) -> None:
        ts = time.strftime("%Y%m%d_%H%M%S", time.gmtime())
        with self._lock:
            if self.json_logs:
                rec = {"ts": ts, "pid": self._pid, "level": level,
                       "message": message}
                if tags:
                    rec.update(tags)
                print(json.dumps(rec), file=sys.stderr, flush=True)
            else:
                tag_str = (
                    " " + " ".join(f"{k}={v}" for k, v in tags.items())
                    if tags else ""
                )
                print(f"{ts} {self._pid} {level}: {message}{tag_str}",
                      file=sys.stderr, flush=True)

    def info(self, message: str, tags: dict | None = None) -> None:
        self._emit("info", message, tags)

    def warning(self, message: str, tags: dict | None = None) -> None:
        self._emit("warning", message, tags)

    def error(self, message: str, tags: dict | None = None) -> None:
        self._emit("error", message, tags)


zklog = _ZkLog()
