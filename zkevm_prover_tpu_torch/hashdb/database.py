"""Node/program store behind the SMT.

Port of `zkevm_prover_tpu/hashdb/database.py`: a host copy, the same store.

Reference: src/hashdb/database.cpp (PostgreSQL nodes/program tables with an
in-memory cache and batched multiWrite). The TPU framework's default backend
is an in-process dict with optional file persistence — the role PostgreSQL
plays for the reference is out of scope for proving performance, and the
interface is factored so a real KV/SQL backend can be dropped in (the gRPC
HashDB service uses this same interface remotely).

Keys are 4-tuples of Goldilocks ints (node hashes); node values are lists of
12 field elements (8 data + 4 capacity flag, SURVEY.md App. D); programs are
byte strings keyed the same way.
"""

from __future__ import annotations

import json
import os
import threading


def _k(key) -> str:
    return "%016x%016x%016x%016x" % tuple(int(v) for v in key)


class Database:
    """Thread-safe node/program store with write-through file persistence.

    `backend` is an optional SLOW second-level store (the role PostgreSQL
    plays in the reference: any object with read/get_program) consulted on
    a local miss, fronted by `cache` ("lru" or "associative" — reference
    database_cache.cpp / database_associative_cache.cpp, selected by
    config.useAssociativeCache at main.cpp:408-417)."""

    def __init__(self, path: str | None = None, backend=None,
                 cache: str | None = None, **cache_kw):
        from .cache import make_cache

        self._nodes: dict[str, list[int]] = {}
        self._programs: dict[str, bytes] = {}
        self._log: list[tuple] = []  # (kind, key) write log for GetFlushData
        self._lock = threading.Lock()
        self._path = path
        self._backend = backend
        if backend is None and (cache is not None or cache_kw):
            raise ValueError(
                "cache/cache_kw have no effect without a backend: the cache "
                "fronts backend reads only (reference Database::read order)")
        self._cache = make_cache(cache, **cache_kw)
        if path and os.path.exists(path):
            self._load(path)

    # -- nodes ---------------------------------------------------------------

    def read(self, key) -> list[int] | None:
        ks = _k(key)
        with self._lock:
            v = self._nodes.get(ks)
            if v is not None:
                return list(v)
        if self._backend is None:
            return None
        # miss: cache -> backend -> cache (reference Database::read order)
        if self._cache is not None:
            v = self._cache.get(ks)
            if v is not None:
                return list(v)
        v = self._backend.read(key)
        if v is not None and self._cache is not None:
            self._cache.put(ks, list(v))
        return list(v) if v is not None else None

    def write(self, key, value: list[int]) -> None:
        # 12 = 8 inputs + 4 capacity; the reference's input-JSON db also
        # carries bare 8-element value preimages (capacity 0 implied)
        assert len(value) in (8, 12)
        if len(value) == 8:
            value = list(value) + [0, 0, 0, 0]
        with self._lock:
            ks = _k(key)
            self._nodes[ks] = [int(x) for x in value]
            self._log.append(("node", ks))

    # -- programs (contract bytecode keyed by poseidon linear hash) ----------

    def get_program(self, key) -> bytes | None:
        ks = _k(key)
        with self._lock:
            p = self._programs.get(ks)
            if p is not None:
                return p
        if self._backend is None:
            return None
        if self._cache is not None:
            p = self._cache.get("p:" + ks)
            if p is not None:
                return p
        p = self._backend.get_program(key)
        if p is not None and self._cache is not None:
            self._cache.put("p:" + ks, bytes(p))
        return p

    def set_program(self, key, data: bytes) -> None:
        with self._lock:
            ks = _k(key)
            self._programs[ks] = bytes(data)
            self._log.append(("program", ks))

    # -- write log (reference: flush-data replication feed) -------------------

    def mark(self) -> int:
        with self._lock:
            return len(self._log)

    def entries_since(self, mark: int) -> dict:
        with self._lock:
            nodes, programs = {}, {}
            for kind, ks in self._log[mark:]:
                if kind == "node":
                    nodes[ks] = list(self._nodes.get(ks, []))
                else:
                    programs[ks] = self._programs.get(ks, b"")
            return {"nodes": nodes, "programs": programs}

    def clear(self) -> None:
        with self._lock:
            self._nodes.clear()
            self._programs.clear()
            self._log.clear()

    # -- bulk / persistence ----------------------------------------------------

    def multi_write(self, nodes: dict, programs: dict | None = None) -> None:
        """Batched flush (reference: multiWrite, src/hashdb/multi_write.cpp)."""
        with self._lock:
            for key, value in nodes.items():
                ks = _k(key) if not isinstance(key, str) else key
                self._nodes[ks] = [int(x) for x in value]
                self._log.append(("node", ks))
            for key, data in (programs or {}).items():
                ks = _k(key) if not isinstance(key, str) else key
                self._programs[ks] = bytes(data)
                self._log.append(("program", ks))

    def save(self, path: str | None = None) -> None:
        path = path or self._path
        assert path, "no persistence path configured"
        with self._lock:
            blob = {
                "nodes": self._nodes,
                "programs": {k: v.hex() for k, v in self._programs.items()},
            }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f)
        os.replace(tmp, path)

    def _load(self, path: str) -> None:
        with open(path) as f:
            blob = json.load(f)
        self._nodes = {k: [int(x) for x in v] for k, v in blob["nodes"].items()}
        self._programs = {k: bytes.fromhex(v) for k, v in blob["programs"].items()}

    def __len__(self) -> int:
        return len(self._nodes)
