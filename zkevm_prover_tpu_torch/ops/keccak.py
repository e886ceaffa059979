"""Keccak-256: batched Keccak-f[1600] on the device and the host sponge.

Port of `zkevm_prover_tpu/ops/keccak.py`, the same functions. Reference:
the XKCP compact Keccak (src/XKCP/Keccak-more-compact.cpp), used for tx
hashing, witness parsing and the fflonk transcript, and the hot path of the
Keccak SM pipeline (src/sm/keccak_f/).

Device half: `keccak_f` permutes a batch of (..., 25) lanes, int64 tensors
holding the u64 bit patterns. On a CUDA tensor it launches the kernel of
csrc/hash.cu (`hash_cuda.keccak_f`), on a CPU tensor it runs
`keccak_f_plain`, the same 24 rounds in torch ops (logical shifts as an
arithmetic shift and a mask). `keccak256_blocks` digests pre-padded
single-block messages through it.

Host half: `_keccak_f_host` and `keccak256`, the exact sponge over Python
ints (`hashdb`'s facade and the padding SMs call it).

State layout: 25 u64 lanes, lane index = x + 5*y (FIPS-202 order).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

# FIPS-202 round constants
_RC = np.array(
    [
        0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
        0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
        0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
        0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
        0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
        0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
        0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
        0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
    ],
    dtype=np.uint64,
)

# rotation offsets r[x + 5y]
_ROT = np.array(
    [
        0, 1, 62, 28, 27,
        36, 44, 6, 55, 20,
        3, 10, 43, 25, 39,
        41, 45, 15, 21, 8,
        18, 2, 61, 56, 14,
    ],
    dtype=np.uint64,
)

RATE_BYTES = 136  # keccak-256 rate (1088 bits)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int64 lanes left by r: the right shift is arithmetic, so the
    bits it brings in are masked off."""
    r = int(r) % 64
    if r == 0:
        return v
    return (v << r) | ((v >> (64 - r)) & ((1 << r) - 1))


# the round constants as int64 bit patterns
_RC_I64 = [int(v) for v in _RC.view(np.int64)]


def keccak_f_plain(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] of (..., 25) int64 lanes in torch ops: the plain twin
    of the CUDA kernel (and its oracle), on any device."""
    s = list(state.unbind(-1))
    for rnd in range(24):
        # theta
        c = [s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20]
             for x in range(5)]
        d = [c[(x + 4) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        s = [s[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(
                    s[x + 5 * y], int(_ROT[x + 5 * y]))
        # chi
        s = [b[i] ^ (~b[(i + 1) % 5 + 5 * (i // 5)]
                     & b[(i + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        # iota
        s[0] = s[0] ^ _RC_I64[rnd]
    return torch.stack(s, dim=-1)


def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] over (..., 25) int64 lanes (batched): the CUDA kernel
    for a CUDA tensor, `keccak_f_plain` for a CPU one."""
    if state.shape[-1] != 25:
        raise ValueError(f"keccak_f takes (..., 25) lanes, not "
                         f"{tuple(state.shape)}")
    if not state.is_cuda:
        return keccak_f_plain(state)
    from . import hash_cuda

    return hash_cuda.keccak_f(state.reshape(-1, 25).contiguous()).reshape(
        state.shape)


def keccak256_blocks(blocks, device=None) -> torch.Tensor:
    """Digest a batch of pre-padded single-block messages on the device.

    blocks: (B, RATE_BYTES) uint8 (numpy or a tensor), already
    keccak-padded (0x01 ... 0x80). Returns (B, 32) uint8 digests on the
    device: the tensor's own, else `device` (CUDA unless told otherwise).
    For longer messages use `keccak256`."""
    if not isinstance(blocks, torch.Tensor):
        blocks = torch.as_tensor(np.asarray(blocks, dtype=np.uint8))
        blocks = blocks.to(resolve_device(device))
    b = blocks.shape[0]
    lanes = _bytes_to_lanes(blocks.reshape(b, RATE_BYTES // 8, 8))
    state = torch.zeros((b, 25), dtype=torch.int64, device=blocks.device)
    state[:, :RATE_BYTES // 8] = lanes
    out = keccak_f(state)
    return _lanes_to_bytes(out[:, :4])


def _bytes_to_lanes(by: torch.Tensor) -> torch.Tensor:
    """(..., L, 8) uint8 -> (..., L) int64 little-endian lanes."""
    acc = by[..., 0].to(torch.int64)
    for i in range(1, 8):
        acc = acc | (by[..., i].to(torch.int64) << (8 * i))
    return acc


def _lanes_to_bytes(lanes: torch.Tensor) -> torch.Tensor:
    """(..., L) int64 lanes -> (..., L*8) uint8 little-endian."""
    parts = [((lanes >> (8 * i)) & 0xFF).to(torch.uint8) for i in range(8)]
    return torch.stack(parts, dim=-1).reshape(*lanes.shape[:-1],
                                              lanes.shape[-1] * 8)


def _keccak_f_host(lanes: list[int]) -> list[int]:
    M = (1 << 64) - 1
    rotl = lambda v, r: ((v << r) | (v >> (64 - r))) & M  # noqa: E731
    s = list(lanes)
    for rnd in range(24):
        c = [s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20] for x in range(5)]
        d = [c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1) for x in range(5)]
        s = [s[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(s[x + 5 * y], int(_ROT[x + 5 * y]))
        s = [
            b[i] ^ ((~b[(i + 1) % 5 + 5 * (i // 5)] & M) & b[(i + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        s[0] ^= int(_RC[rnd])
    return s


def keccak256(data: bytes) -> bytes:
    """Ethereum Keccak-256 of an arbitrary byte string (host, exact).

    Mirrors the reference's `Keccak()` entry (src/XKCP, pad 0x01/0x80).
    """
    state = [0] * 25
    msg = bytearray(data)
    msg.append(0x01)
    while len(msg) % RATE_BYTES:
        msg.append(0x00)
    msg[-1] |= 0x80
    for off in range(0, len(msg), RATE_BYTES):
        block = msg[off : off + RATE_BYTES]
        for i in range(RATE_BYTES // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = _keccak_f_host(state)
    out = b"".join(int(state[i]).to_bytes(8, "little") for i in range(4))
    return out
