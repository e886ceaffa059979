"""Database64 — the SMT node store over the native page file.

Port of `zkevm_prover_tpu/hashdb64/database64.py`: a host copy, the same
records.

Same interface as hashdb.Database (read/write/get_program/set_program/
multi_write), so hashdb.Smt and the StateManager overlay run unchanged on
the paged backend — the reference's StateManager64 / Database64 pairing
(src/hashdb64/state_manager_64.hpp:102-159).

Record encoding: node key = 4 GL elements big-endian packed to 32 bytes;
node value = 12 x 8-byte LE field elements (96 B). Programs are chunked
into <=128-byte records under key' = H(key ‖ chunk_idx) with a length
record at chunk 0xFFFF.
"""

from __future__ import annotations

import hashlib
import struct

from .page_store import PageStore


def _key_bytes(key) -> bytes:
    return b"".join(int(v).to_bytes(8, "big") for v in key)


_CHUNK = 128


def _prog_key(key_b: bytes, idx: int) -> bytes:
    return hashlib.blake2s(key_b + struct.pack("<I", idx), digest_size=32).digest()


class Database64:
    def __init__(self, path: str, bucket_bits: int = 10):
        self.store = PageStore(path, bucket_bits)

    # -- nodes (12 field elements) ------------------------------------------

    def read(self, key) -> list[int] | None:
        raw = self.store.get(_key_bytes(key))
        if raw is None:
            return None
        assert len(raw) == 96
        return [int.from_bytes(raw[8 * i : 8 * i + 8], "little") for i in range(12)]

    def write(self, key, value: list[int]) -> None:
        assert len(value) == 12
        raw = b"".join(int(v).to_bytes(8, "little") for v in value)
        self.store.set(_key_bytes(key), raw)

    # -- programs --------------------------------------------------------------

    def set_program(self, key, data: bytes) -> None:
        kb = _key_bytes(key)
        self.store.set(_prog_key(kb, 0xFFFFFFFF), struct.pack("<I", len(data)))
        for i in range(0, len(data), _CHUNK):
            self.store.set(_prog_key(kb, i // _CHUNK), data[i : i + _CHUNK])

    def get_program(self, key) -> bytes | None:
        kb = _key_bytes(key)
        ln = self.store.get(_prog_key(kb, 0xFFFFFFFF))
        if ln is None:
            return None
        (n,) = struct.unpack("<I", ln)
        out = bytearray()
        for i in range((n + _CHUNK - 1) // _CHUNK):
            chunk = self.store.get(_prog_key(kb, i))
            assert chunk is not None
            out += chunk
        return bytes(out[:n])

    # -- bulk -------------------------------------------------------------------

    def multi_write(self, nodes: dict, programs: dict | None = None) -> None:
        for key, value in nodes.items():
            if isinstance(key, str):
                key = tuple(int(key[i * 16 : (i + 1) * 16], 16) for i in range(4))
            self.write(key, value)
        for key, data in (programs or {}).items():
            if isinstance(key, str):
                key = tuple(int(key[i * 16 : (i + 1) * 16], 16) for i in range(4))
            self.set_program(key, data)
        self.store.flush()

    def __len__(self) -> int:
        return len(self.store)
