"""StateManager64 — virtual vs consolidated state roots over hashdb64.

Port of `zkevm_prover_tpu/hashdb64/state64.py`: a host copy, the same roots
and reads.

Reference: src/hashdb64/state_manager_64.{hpp,cpp} (state_manager_64.hpp:
102-159): while batches execute, their state roots are VIRTUAL — write
sets buffered per batchUUID and chained in memory, visible to reads but
not persisted.  `consolidateState(virtualRoot)` (triggered by the ROM at
the consolidation zkPC, main_executor.hpp:81-82) walks the virtual chain
up to that root, persists each batch as one KeyValueHistory version, maps
every chained root to its version, and returns the consolidated root +
flushId.  Reads against a consolidated root take the versioned fast path
(no SMT walk); reads against a virtual root overlay the unconsolidated
chain on top of the last consolidated version.

The LevelTree tracks leaf depths for the executor's level/gas accounting.
"""

from __future__ import annotations

import dataclasses

from .key_value_history import KeyValueHistory
from .level_tree import LevelTree


def _r(root) -> tuple:
    return tuple(int(v) for v in root)


@dataclasses.dataclass
class _VirtualBatch:
    batch_uuid: str
    old_root: tuple
    new_root: tuple | None = None
    kvs: dict = dataclasses.field(default_factory=dict)


class StateManager64:
    def __init__(self, store):
        self.history = KeyValueHistory(store)
        self.levels = LevelTree()
        self._virtual: dict[str, _VirtualBatch] = {}     # by batchUUID
        self._by_root: dict[tuple, _VirtualBatch] = {}   # closed batches
        self._last_flush_id = 0

    # -- batch lifecycle (the executor's write path) -------------------------

    def start_batch(self, batch_uuid: str, old_root) -> None:
        if batch_uuid not in self._virtual:
            self._virtual[batch_uuid] = _VirtualBatch(batch_uuid, _r(old_root))

    def write(self, batch_uuid: str, key, value: int) -> int:
        """Buffer a write into the batch's virtual state; returns the key's
        SMT level (LevelTree insert, the reference's KeyValueTree)."""
        vb = self._virtual[batch_uuid]
        vb.kvs[tuple(int(v) for v in key)] = int(value)
        return self.levels.insert(key)

    def semi_flush(self, batch_uuid: str, new_root) -> None:
        """Close the batch under its VIRTUAL root (StateManager64::
        semiFlush): chained, readable, still unconsolidated."""
        vb = self._virtual[batch_uuid]
        vb.new_root = _r(new_root)
        self._by_root[vb.new_root] = vb

    # -- consolidation --------------------------------------------------------

    def _chain_to(self, root: tuple) -> list[_VirtualBatch]:
        """Virtual batches from the last consolidated state up to `root`
        (newest last); [] if the root is unknown/already consolidated."""
        chain = []
        cur = root
        while cur in self._by_root:
            vb = self._by_root[cur]
            chain.append(vb)
            cur = vb.old_root
        chain.reverse()
        return chain

    def consolidate_state(self, virtual_root) -> tuple[tuple, int]:
        """Persist the virtual chain ending at `virtual_root`; every root in
        the chain becomes consolidated (readable by version forever).
        Returns (consolidated_root, flush_id)."""
        root = _r(virtual_root)
        if self.history.get_root_version(root) is not None:
            return root, self._last_flush_id   # already consolidated
        chain = self._chain_to(root)
        if not chain:
            raise KeyError(f"unknown virtual root {root}")
        for vb in chain:
            self.history.write_batch(vb.kvs, vb.new_root)
            del self._by_root[vb.new_root]
            self._virtual.pop(vb.batch_uuid, None)
        self._last_flush_id += 1
        return root, self._last_flush_id

    # -- reads ----------------------------------------------------------------

    def read(self, root, key) -> int | None:
        """Value of key at `root` — consolidated (versioned fast path) or
        virtual (overlay walk down the unconsolidated chain)."""
        root = _r(root)
        key = tuple(int(v) for v in key)
        cur = root
        while cur in self._by_root:            # virtual segment
            vb = self._by_root[cur]
            if key in vb.kvs:
                return vb.kvs[key]
            cur = vb.old_root
        ver = self.history.get_root_version(cur)
        if ver is None:
            return None
        return self.history.read_kv(key, ver)

    def is_virtual(self, root) -> bool:
        return _r(root) in self._by_root

    def level(self, key) -> int:
        return self.levels.level(key)
