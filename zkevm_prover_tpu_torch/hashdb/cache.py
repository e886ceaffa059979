"""Database read caches.

Port of `zkevm_prover_tpu/hashdb/cache.py`: a host copy, the same caches.

Reference: src/hashdb/database_cache.cpp (DatabaseMTCache — an LRU map
bounded by total byte size) and src/hashdb/database_associative_cache.cpp
(DatabaseMTAssociativeCache — 2^n value slots addressed through an index
array by key bits, lock-free overwrite on collision), selected by
config.useAssociativeCache (src/main.cpp:408-417).

They sit between the SMT and a slow node store (PostgreSQL there; a file
or remote gRPC HashDB here) so repeated tree walks do not re-fetch hot
nodes.  Both are exact caches: a hit always returns the value that was
inserted for that full key (the associative cache stores the key beside
the value and verifies it on lookup — colliding keys evict, never alias).
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class LRUCache:
    """Byte-bounded LRU (DatabaseMTCache role).  Values are opaque; the
    accounting charges key + payload like the reference's addRecord."""

    def __init__(self, max_bytes: int = 1 << 24):
        self.max_bytes = max_bytes
        self._d: OrderedDict[str, object] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _size(key: str, value) -> int:
        if isinstance(value, (bytes, bytearray)):
            return len(key) + len(value)
        return len(key) + 8 * len(value)  # field-element lists

    def get(self, key: str):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def put(self, key: str, value) -> None:
        with self._lock:
            if key in self._d:
                self._bytes -= self._size(key, self._d.pop(key))
            self._d[key] = value
            self._bytes += self._size(key, value)
            while self._bytes > self.max_bytes and self._d:
                k, v = self._d.popitem(last=False)
                self._bytes -= self._size(k, v)

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._bytes = 0


class AssociativeCache:
    """Direct-indexed cache with 2^n_bits slots (DatabaseMTAssociativeCache
    role).  The slot comes from the key's low bits (the reference indexes
    by key words); a colliding insert overwrites; lookups verify the full
    key so a collision is a miss, never a wrong value."""

    def __init__(self, n_bits: int = 16):
        self.n_bits = n_bits
        self._slots: list[tuple[str, object] | None] = [None] * (1 << n_bits)
        self.hits = 0
        self.misses = 0

    def _slot(self, key: str) -> int:
        # keys are the 64-hex-char node hashes; their low bits are already
        # uniform (Poseidon output), matching the reference's key indexing
        return int(key[-16:], 16) & ((1 << self.n_bits) - 1)

    def get(self, key: str):
        e = self._slots[self._slot(key)]
        if e is not None and e[0] == key:
            self.hits += 1
            return e[1]
        self.misses += 1
        return None

    def put(self, key: str, value) -> None:
        self._slots[self._slot(key)] = (key, value)

    def __len__(self) -> int:
        return sum(1 for e in self._slots if e is not None)

    def clear(self) -> None:
        self._slots = [None] * (1 << self.n_bits)


def make_cache(kind: str | None, **kw):
    """Factory mirroring the config.useAssociativeCache switch."""
    if kind in (None, "", "none"):
        return None
    if kind == "lru":
        return LRUCache(**kw)
    if kind == "associative":
        return AssociativeCache(**kw)
    raise ValueError(f"unknown cache kind {kind!r}")
