"""Wrappers of the CUDA hash kernels: Keccak-f[1600] and the SHA-256
compression (csrc/hash.cu, one library, `cuda_build.KERNELS["hash"]`).

Each wrapper takes int64 CUDA tensors, checks what its kernel takes and
raises on anything else, launches the kernel on the current stream and adds
one to `launches[name]`. Nothing falls back to the plain versions
(`keccak.keccak_f_plain`, `sha256.sha256_compress_plain`): the callers in
`ops/keccak.py` and `ops/sha256.py` take the plain version for a CPU tensor
and these for a CUDA tensor. The kernel's note in csrc/hash.cu says what
TPU-side program each replaces and what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_build

LIBRARY = "hash"
launches = {"keccak_f": 0, "sha256_compress": 0}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_FUNCTIONS = {"hash_keccak_f": [_P, _P, _LL, _P],
              "hash_sha256_compress": [_P, _P, _P, _LL, _P]}

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


def _check(t: torch.Tensor, what: str, width: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"hash_cuda: {what} must be a CUDA tensor")
    if t.dtype != torch.int64:
        raise TypeError(f"hash_cuda: {what} must be int64, not {t.dtype}")
    if t.ndim != 2 or t.shape[1] != width:
        raise ValueError(f"hash_cuda: {what} must be (B, {width}), not "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"hash_cuda: {what} must be contiguous")


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
    if words.shape[0] != state.shape[0] or words.device != state.device:
        raise ValueError("hash_cuda: state and words must be on one card "
                         f"with one batch, not {tuple(state.shape)} on "
                         f"{state.device} and {tuple(words.shape)} on "
                         f"{words.device}")
    out = torch.empty_like(state)
    if state.shape[0]:
        _launch("hash_sha256_compress", "sha256_compress", state.device,
                state.data_ptr(), words.data_ptr(), out.data_ptr(),
                state.shape[0])
    return out
