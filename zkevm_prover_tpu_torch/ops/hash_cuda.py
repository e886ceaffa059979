"""Wrappers of the CUDA hash kernels: Keccak-f[1600], the SHA-256
compression and the Blake2b compression (csrc/hash.cu, one library,
`cuda_build.KERNELS["hash"]`).

Each wrapper takes int64 CUDA tensors, checks what its kernel takes and
raises on anything else, launches the kernel on the current stream and adds
one to `launches[name]`. Nothing falls back to the plain versions
(`keccak.keccak_f_plain`, `sha256.sha256_compress_plain`,
`blake.blake2b_compress_plain`): the callers in `ops/keccak.py`,
`ops/sha256.py` and `ops/blake.py` take the plain version for a CPU tensor
and these for a CUDA tensor. The kernel's note in csrc/hash.cu says what
TPU-side program each replaces and what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_build

LIBRARY = "hash"
launches = {"keccak_f": 0, "sha256_compress": 0, "blake2b_compress": 0}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_FUNCTIONS = {"hash_keccak_f": [_P, _P, _LL, _P],
              "hash_sha256_compress": [_P, _P, _P, _LL, _P],
              "hash_blake2b_compress": [_P, _P, _P, _P, _P, _LL, _P]}

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load(LIBRARY)
        for fn, args in _FUNCTIONS.items():
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(t: torch.Tensor, what: str, width: int | None,
           dtype=torch.int64) -> None:
    """A CUDA tensor of `dtype`, contiguous, (B, width) or (B,) for width
    None."""
    if not t.is_cuda:
        raise ValueError(f"hash_cuda: {what} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"hash_cuda: {what} must be {dtype}, not {t.dtype}")
    shape = "(B,)" if width is None else f"(B, {width})"
    if t.ndim != (1 if width is None else 2) or (
            width is not None and t.shape[1] != width):
        raise ValueError(f"hash_cuda: {what} must be {shape}, not "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"hash_cuda: {what} must be contiguous")


def _same_batch(first: torch.Tensor, *rest: torch.Tensor) -> None:
    for t in rest:
        if t.shape[0] != first.shape[0] or t.device != first.device:
            got = [(tuple(x.shape), str(x.device)) for x in (first, *rest)]
            raise ValueError("hash_cuda: the operands must be on one card "
                             f"with one batch, not {got}")


def _launch(fn: str, name: str, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(_library(), fn)(*args, stream)
    if err:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
    launches[name] += 1


def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] of (B, 25) int64 CUDA lanes (u64 bit patterns) through
    csrc/hash.cu keccak_f_kernel, any B."""
    _check(state, "state", 25)
    out = torch.empty_like(state)
    if state.shape[0]:
        _launch("hash_keccak_f", "keccak_f", state.device, state.data_ptr(),
                out.data_ptr(), state.shape[0])
    return out


def sha256_compress(state: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """SHA-256 compression of (B, 8) state words and (B, 16) message words
    (u32 values in int64 CUDA tensors; the kernel reads the low 32 bits)
    through csrc/hash.cu sha256_compress_kernel: the (B, 8) compressed
    states, zero-extended, any B."""
    _check(state, "state", 8)
    _check(words, "words", 16)
    _same_batch(state, words)
    out = torch.empty_like(state)
    if state.shape[0]:
        _launch("hash_sha256_compress", "sha256_compress", state.device,
                state.data_ptr(), words.data_ptr(), out.data_ptr(),
                state.shape[0])
    return out


def blake2b_compress(state: torch.Tensor, words: torch.Tensor,
                     counter: torch.Tensor,
                     last: torch.Tensor) -> torch.Tensor:
    """Blake2b compression of (B, 8) state words and (B, 16) message words
    with (B,) byte counters (u64 bit patterns in int64 CUDA tensors) and
    (B,) bool last-block flags through csrc/hash.cu
    blake2b_compress_kernel: the (B, 8) new states, any B."""
    _check(state, "state", 8)
    _check(words, "words", 16)
    _check(counter, "counter", None)
    _check(last, "last", None, torch.bool)
    _same_batch(state, words, counter, last)
    out = torch.empty_like(state)
    if state.shape[0]:
        _launch("hash_blake2b_compress", "blake2b_compress", state.device,
                state.data_ptr(), words.data_ptr(), counter.data_ptr(),
                last.data_ptr(), out.data_ptr(), state.shape[0])
    return out
