"""KeyValueHistory — versioned key/value state over the native page store.

Port of `zkevm_prover_tpu/hashdb64/key_value_history.py`: a host copy, the
same layout.

Reference: src/hashdb64/page/key_value_history_page.cpp +
version_data_page / root_version_page: hashdb64 answers "value of key K at
root R" without walking the SMT by keeping, per key, the list of
(version, value) writes, and a map from every state root to the version
that produced it (state_manager_64.hpp:102-159 drives it).

Layout over PageStore records (each entry its own record, blake2s-derived
record keys like database64's program chunks):

  kvc:<key>        u64 entry count for the key
  kvh:<key>:<i>    u64 version ‖ 32-byte value          (i < count)
  rv:<root>        u64 version of the root
  ver              u64 global version counter

Reads binary-search the per-key history for the newest entry with
version <= the root's version — the KeyValueHistoryPage lookup semantics.
"""

from __future__ import annotations

import hashlib
import struct

from .page_store import PageStore


def _rk(tag: bytes, key_b: bytes, idx: int | None = None) -> bytes:
    payload = tag + key_b
    if idx is not None:
        payload += struct.pack("<I", idx)
    return hashlib.blake2s(payload, digest_size=32).digest()


def _key_bytes(key) -> bytes:
    return b"".join(int(v).to_bytes(8, "big") for v in key)


class KeyValueHistory:
    def __init__(self, store: PageStore):
        self.store = store

    # -- version counter ----------------------------------------------------

    def _get_u64(self, rec: bytes, default: int = 0) -> int:
        raw = self.store.get(rec)
        return int.from_bytes(raw[:8], "little") if raw else default

    def _set_u64(self, rec: bytes, v: int) -> None:
        self.store.set(rec, int(v).to_bytes(8, "little"))

    def current_version(self) -> int:
        return self._get_u64(_rk(b"ver", b""))

    def next_version(self) -> int:
        v = self.current_version() + 1
        self._set_u64(_rk(b"ver", b""), v)
        return v

    # -- per-key history ----------------------------------------------------

    def write_kv(self, version: int, key, value: int) -> None:
        kb = _key_bytes(key)
        cnt_rec = _rk(b"kvc", kb)
        cnt = self._get_u64(cnt_rec)
        entry = (int(version).to_bytes(8, "little")
                 + int(value).to_bytes(32, "little"))
        self.store.set(_rk(b"kvh", kb, cnt), entry)
        self._set_u64(cnt_rec, cnt + 1)

    def read_kv(self, key, version: int) -> int | None:
        """Newest value written at a version <= `version` (None if the key
        had no write that early)."""
        kb = _key_bytes(key)
        cnt = self._get_u64(_rk(b"kvc", kb))
        # versions are appended in increasing order: binary search
        lo, hi, best = 0, cnt - 1, None
        while lo <= hi:
            mid = (lo + hi) // 2
            raw = self.store.get(_rk(b"kvh", kb, mid))
            ver = int.from_bytes(raw[:8], "little")
            if ver <= version:
                best = raw
                lo = mid + 1
            else:
                hi = mid - 1
        if best is None:
            return None
        return int.from_bytes(best[8:40], "little")

    # -- root <-> version ---------------------------------------------------

    def set_root_version(self, root, version: int) -> None:
        self._set_u64(_rk(b"rv", _key_bytes(root)), version)

    def get_root_version(self, root) -> int | None:
        raw = self.store.get(_rk(b"rv", _key_bytes(root)))
        return int.from_bytes(raw[:8], "little") if raw else None

    # -- the hashdb64 read path --------------------------------------------

    def read(self, root, key) -> int | None:
        """Value of `key` in the state identified by `root` — the
        KeyValueTree fast path (no SMT walk)."""
        ver = self.get_root_version(root)
        if ver is None:
            return None
        return self.read_kv(key, ver)

    def write_batch(self, kvs: dict, new_root) -> int:
        """Record one batch of writes as a new version tied to new_root."""
        ver = self.next_version()
        for key, value in kvs.items():
            self.write_kv(ver, key, value)
        self.set_root_version(new_root, ver)
        return ver
