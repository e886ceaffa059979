"""Blake2b-256: the batched compression on the device, and the framing on
the host.

Port of `zkevm_prover_tpu/ops/blake.py`, the same functions. Reference:
tools/sm/blake/blake.cpp (Blake2b_256 over a gate list, the
Blake2b256_Test known-vector self-test of the unit runner).

`blake2b_compress` compresses a batch of blocks: (..., 8) state words,
(..., 16) message words, a (...) byte counter and a (...) last-block flag;
words are int64 tensors holding the u64 bit patterns, the flag a bool
tensor. On CUDA tensors it launches the kernel of csrc/hash.cu
(`hash_cuda.blake2b_compress`), on CPU tensors it runs
`blake2b_compress_plain`, the 12 rounds of G on the SIGMA schedule in torch
ops (logical shifts as an arithmetic shift and a mask). The sponge framing
(parameter block, counter, finalization flag) stays on the host, as in the
JAX package: `blake2b_256` chains one compression per 128-byte block,
`blake2b_256_many` digests single-block messages in one call.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

IV = np.array([
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179], dtype=np.uint64)

SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

# the IV as int64 bit patterns
_IV_I64 = [int(v) for v in IV.view(np.int64)]

# the G quarter-rounds of a round: (a, b, c, d) and the message slots
_G = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
      (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int64 words right by r (0 < r < 64): the right shift is
    arithmetic, so the bits it brings in are masked off."""
    return ((x >> r) & ((1 << (64 - r)) - 1)) | (x << (64 - r))


def blake2b_compress_plain(h: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
                           last: torch.Tensor) -> torch.Tensor:
    """The compression in torch ops: h (..., 8), m (..., 16) and t (...)
    int64 words, last (...) bool -> the new (..., 8) state. The plain twin
    of the CUDA kernel (and its oracle), on any device; sums wrap mod
    2^64 as int64 adds do."""
    hs = list(h.unbind(-1))
    ms = list(m.unbind(-1))
    v = hs + [torch.full_like(hs[0], iv) for iv in _IV_I64]
    v[12] = v[12] ^ t
    v[14] = v[14] ^ torch.where(last, -1, 0).to(torch.int64)
    for r in range(12):
        s = SIGMA[r % 10]
        for i, (a, b, c, d) in enumerate(_G):
            x, y = ms[s[2 * i]], ms[s[2 * i + 1]]
            v[a] = v[a] + v[b] + x
            v[d] = _rotr(v[d] ^ v[a], 32)
            v[c] = v[c] + v[d]
            v[b] = _rotr(v[b] ^ v[c], 24)
            v[a] = v[a] + v[b] + y
            v[d] = _rotr(v[d] ^ v[a], 16)
            v[c] = v[c] + v[d]
            v[b] = _rotr(v[b] ^ v[c], 63)
    return torch.stack([hs[i] ^ v[i] ^ v[i + 8] for i in range(8)], dim=-1)


def blake2b_compress(h: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
                     last: torch.Tensor) -> torch.Tensor:
    """Batched compression: h (..., 8), m (..., 16), t (...), last (...)
    on one device -> (..., 8). The CUDA kernel for CUDA tensors,
    `blake2b_compress_plain` for CPU ones."""
    batch = h.shape[:-1]
    if h.shape[-1] != 8 or m.shape != (*batch, 16) or t.shape != batch \
            or last.shape != batch:
        raise ValueError(
            f"blake2b_compress takes (..., 8), (..., 16), (...) and (...), "
            f"not {tuple(h.shape)}, {tuple(m.shape)}, {tuple(t.shape)} and "
            f"{tuple(last.shape)}")
    if not any(x.is_cuda for x in (h, m, t, last)):
        return blake2b_compress_plain(h, m, t, last)
    from . import hash_cuda

    out = hash_cuda.blake2b_compress(
        h.reshape(-1, 8).contiguous(), m.reshape(-1, 16).contiguous(),
        t.reshape(-1).contiguous(), last.reshape(-1).contiguous())
    return out.reshape(h.shape)


def _param_state() -> np.ndarray:
    """The IV with the parameter block folded in: digest 32, fanout 1."""
    h = IV.copy()
    h[0] ^= np.uint64(0x01010000 ^ 32)
    return h.view(np.int64)


def _digest(state: torch.Tensor) -> list[bytes]:
    """(B, 8) int64 states -> their 32-byte digests."""
    words = state.cpu().numpy().astype("<i8")
    return [row.tobytes()[:32] for row in words]


def blake2b_256(data: bytes, device=None) -> bytes:
    """Blake2b with a 32-byte digest, every compression on `device` (CUDA
    unless told otherwise): one call per 128-byte block."""
    dev = resolve_device(device)
    data = bytes(data)
    blocks = [data[i:i + 128] for i in range(0, len(data), 128)] or [b""]
    state = torch.as_tensor(_param_state()[None, :], device=dev)
    for bi, blk in enumerate(blocks):
        last = bi == len(blocks) - 1
        t = len(data) if last else (bi + 1) * 128
        m = np.frombuffer(blk.ljust(128, b"\0"), dtype="<i8")[None, :]
        state = blake2b_compress(
            state, torch.as_tensor(m.astype(np.int64), device=dev),
            torch.tensor([t], dtype=torch.int64, device=dev),
            torch.tensor([last], device=dev))
    return _digest(state)[0]


def blake2b_256_many(msgs: list[bytes], device=None) -> list[bytes]:
    """Digest single-block messages (<= 128 bytes each) in one call on
    `device` (CUDA unless told otherwise)."""
    if any(len(msg) > 128 for msg in msgs):
        raise ValueError("blake2b_256_many takes messages of at most 128 "
                         "bytes")
    if not msgs:
        return []
    dev = resolve_device(device)
    n = len(msgs)
    blocks = np.frombuffer(b"".join(bytes(msg).ljust(128, b"\0")
                                    for msg in msgs), dtype="<i8")
    states = np.broadcast_to(_param_state(), (n, 8))
    out = blake2b_compress(
        torch.as_tensor(np.ascontiguousarray(states), device=dev),
        torch.as_tensor(blocks.astype(np.int64).reshape(n, 16), device=dev),
        torch.tensor([len(msg) for msg in msgs], dtype=torch.int64,
                     device=dev),
        torch.ones(n, dtype=torch.bool, device=dev))
    return _digest(out)


def blake2b_256_test(device=None) -> bool:
    """The reference's self-test shape: the known vector of the empty
    message."""
    return (
        blake2b_256(b"", device).hex()
        == "0e5751c026e543b2e8ab2eb06099daa1d1e5df47778f7787faab45cdf12fe3a8"
    )
