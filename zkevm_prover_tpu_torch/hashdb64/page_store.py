"""ctypes binding for the native page store (native/pagestore.cpp).

Port of `zkevm_prover_tpu/hashdb64/page_store.py`: the same binding, over
the port's own copy of `native/pagestore.cpp`. The library is compiled with
g++ at its first use (never at import) into the package's git-ignored
`build/pagestore-<hash>/`, keyed by a hash of the source and the flags, so
an edited source is rebuilt and the source tree stays clean; the C ABI and
ctypes are the binding path (no pybind11).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "native" / "pagestore.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "build"
_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]
_lock = threading.Lock()
_lib = None

KEY_LEN = 32
MAX_VAL = 160


def build_library(force: bool = False) -> str:
    """Compile the native library if it is not built yet; returns its
    path. The compiler writes a temporary file that is renamed into place,
    so processes that build at once never load a half-written library."""
    with _lock:
        h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
        lib = _BUILD / f"pagestore-{h.hexdigest()[:16]}" / "libpagestore.so"
        if lib.exists() and not force:
            return str(lib)
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
        return str(lib)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    lib.pagestore_open.restype = ctypes.c_void_p
    lib.pagestore_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.pagestore_close.argtypes = [ctypes.c_void_p]
    lib.pagestore_flush.argtypes = [ctypes.c_void_p]
    lib.pagestore_record_count.restype = ctypes.c_uint64
    lib.pagestore_record_count.argtypes = [ctypes.c_void_p]
    lib.pagestore_page_count.restype = ctypes.c_uint64
    lib.pagestore_page_count.argtypes = [ctypes.c_void_p]
    lib.pagestore_set.restype = ctypes.c_int
    lib.pagestore_set.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.pagestore_get.restype = ctypes.c_int
    lib.pagestore_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_char_p]
    _lib = lib
    return lib


class PageStore:
    """mmap'd 4 KB page KV store: 32-byte keys -> <=160-byte values."""

    def __init__(self, path: str, bucket_bits: int = 10):
        self._lib = _load()
        self._h = self._lib.pagestore_open(path.encode(), bucket_bits)
        if not self._h:
            raise OSError(f"cannot open page store {path}")
        self._local = threading.Lock()

    def set(self, key: bytes, value: bytes) -> None:
        assert len(key) == KEY_LEN and len(value) <= MAX_VAL
        with self._local:
            rc = self._lib.pagestore_set(self._h, key, value, len(value))
        if rc != 0:
            raise OSError("pagestore_set failed")

    def get(self, key: bytes) -> bytes | None:
        assert len(key) == KEY_LEN
        buf = ctypes.create_string_buffer(MAX_VAL)
        with self._local:
            n = self._lib.pagestore_get(self._h, key, buf)
        return None if n < 0 else buf.raw[:n]

    def flush(self) -> None:
        self._lib.pagestore_flush(self._h)

    def __len__(self) -> int:
        return self._lib.pagestore_record_count(self._h)

    @property
    def page_count(self) -> int:
        return self._lib.pagestore_page_count(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.pagestore_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
