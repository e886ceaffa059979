"""Per-batch state write buffering & versioning.

Port of `zkevm_prover_tpu/hashdb/state_manager.py`: a host copy, the same
lifecycle.

Reference: src/hashdb/state_manager.cpp — uncommitted SMT writes are visible
to the executor before `flush`, tracked per batch UUID and per tx, so a batch
can be re-executed or discarded without touching the database. This
re-implementation keeps the same lifecycle: begin batch -> set/get through an
overlay -> semiFlush per tx -> flush(batchUUID) persists to the Database.
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class _BatchState:
    uuid: str
    nodes: dict = dataclasses.field(default_factory=dict)      # key str -> 12 fe
    programs: dict = dataclasses.field(default_factory=dict)   # key str -> bytes
    current_root: tuple = (0, 0, 0, 0)
    tx_roots: list = dataclasses.field(default_factory=list)   # semiFlush points
    cancelled: bool = False


class StateManager:
    """Singleton-style overlay store (reference: StateManager singleton)."""

    def __init__(self, db):
        self.db = db
        self._batches: dict[str, _BatchState] = {}
        self._lock = threading.Lock()
        self._flush_id = 0
        self._sent_flush_id = 0
        self._flush_marks: dict[int, int] = {0: 0}  # flush id -> db log mark

    # -- batch lifecycle -------------------------------------------------------

    def begin_batch(self, uuid: str, old_root=(0, 0, 0, 0)) -> None:
        with self._lock:
            self._batches[uuid] = _BatchState(uuid=uuid, current_root=tuple(old_root))

    def semi_flush(self, uuid: str, new_root) -> None:
        """Mark a tx boundary (reference: semiFlush per processed tx)."""
        with self._lock:
            b = self._batches[uuid]
            b.current_root = tuple(new_root)
            b.tx_roots.append(tuple(new_root))

    def cancel_batch(self, uuid: str) -> None:
        with self._lock:
            if uuid in self._batches:
                self._batches[uuid].cancelled = True

    def flush(self, uuid: str, new_state_root=None) -> tuple[int, int]:
        """Persist the batch overlay to the database; returns (flushId, lastSent).

        Reference: StateManager::flush(batchUUID, newStateRoot, persistence,
        db, flushId, lastSentFlushId) (state_manager.hpp:122).
        """
        with self._lock:
            b = self._batches.pop(uuid, None)
            self._flush_id += 1
            fid = self._flush_id
        if b is not None and not b.cancelled:
            self.db.multi_write(b.nodes, b.programs)
            with self._lock:
                self._sent_flush_id = fid
        with self._lock:
            if hasattr(self.db, "mark"):
                self._flush_marks[fid] = self.db.mark()
        return fid, self._sent_flush_id

    def get_flush_status(self) -> dict:
        with self._lock:
            return {
                "storedFlushId": self._sent_flush_id,
                "lastFlushId": self._flush_id,
                "pendingToFlushNodes": sum(
                    len(b.nodes) for b in self._batches.values()
                ),
            }

    # -- overlay node/program access (used by Smt via an overlay Database) ------

    def overlay_db(self, uuid: str):
        return _OverlayDatabase(self, uuid)


class _OverlayDatabase:
    """Database view: reads hit the overlay first, writes go to the overlay."""

    def __init__(self, manager: StateManager, uuid: str):
        self._m = manager
        self._uuid = uuid

    def _batch(self) -> _BatchState:
        return self._m._batches[self._uuid]

    def read(self, key):
        from .database import _k

        v = self._batch().nodes.get(_k(key))
        if v is not None:
            return list(v)
        return self._m.db.read(key)

    def write(self, key, value):
        from .database import _k

        self._batch().nodes[_k(key)] = [int(x) for x in value]

    def get_program(self, key):
        from .database import _k

        v = self._batch().programs.get(_k(key))
        return v if v is not None else self._m.db.get_program(key)

    def set_program(self, key, data: bytes):
        from .database import _k

        self._batch().programs[_k(key)] = bytes(data)
