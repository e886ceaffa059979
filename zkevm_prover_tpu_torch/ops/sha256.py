"""SHA-256: the batched compression function on the device, and the host
hash.

Port of `zkevm_prover_tpu/ops/sha256.py`, the same functions. Reference:
the scalar SHA256 of tools/sm/sha256/, feeding the PaddingSha256 and
Sha256F state machines (src/sm/sha256_f/).

`sha256_compress` compresses a batch of blocks: (..., 8) state words and
(..., 16) big-endian message words, u32 values in int64 tensors. On a CUDA
tensor it launches the kernel of csrc/hash.cu (`hash_cuda.sha256_compress`),
on a CPU tensor it runs `sha256_compress_plain`, the message schedule and
64 rounds in torch ops with every sum masked to 32 bits.
`sha256_blocks` digests pre-padded single-block messages through it;
`sha256(data)` (host) hashes arbitrary bytes with hashlib.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import resolve_device

_K = np.array([
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
], dtype=np.uint32)

IV = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
], dtype=np.uint32)

M32 = 0xFFFFFFFF


def _rotr(v: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate 32-bit words (in int64, below 2^32) right by r."""
    return ((v >> r) | (v << (32 - r))) & M32


def sha256_compress_plain(state: torch.Tensor,
                          words: torch.Tensor) -> torch.Tensor:
    """Batched compression in torch ops: state (..., 8), words (..., 16),
    u32 values in int64 (the low 32 bits are taken) -> (..., 8). The plain
    twin of the CUDA kernel (and its oracle), on any device."""
    s0 = [v & M32 for v in state.unbind(-1)]
    w = [v & M32 for v in words.unbind(-1)]
    for t in range(16, 64):
        s0_ = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1_ = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0_ + w[t - 7] + s1_) & M32)
    a, b, c, d, e, f, g, h = s0
    for t in range(64):
        big1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((~e & M32) & g)
        t1 = (h + big1 + ch + int(_K[t]) + w[t]) & M32
        big0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (big0 + maj) & M32
        h, g, f, e = g, f, e, (d + t1) & M32
        d, c, b, a = c, b, a, (t1 + t2) & M32
    return torch.stack([(x + y) & M32 for x, y in
                        zip((a, b, c, d, e, f, g, h), s0)], dim=-1)


def sha256_compress(state: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Batched compression: state (..., 8), words (..., 16) -> (..., 8), u32
    values in int64 tensors on one device. `words` are the 16 big-endian
    32-bit words of one 64-byte block. The CUDA kernel for CUDA tensors,
    `sha256_compress_plain` for CPU ones."""
    if state.shape[-1] != 8 or words.shape[-1] != 16 or \
            state.shape[:-1] != words.shape[:-1]:
        raise ValueError(f"sha256_compress takes (..., 8) and (..., 16), "
                         f"not {tuple(state.shape)} and {tuple(words.shape)}")
    if not (state.is_cuda or words.is_cuda):
        return sha256_compress_plain(state, words)
    from . import hash_cuda

    out = hash_cuda.sha256_compress(state.reshape(-1, 8).contiguous(),
                                    words.reshape(-1, 16).contiguous())
    return out.reshape(state.shape)


def sha256_blocks(blocks, device=None) -> torch.Tensor:
    """Digest a batch of pre-padded single-block messages on the device.

    blocks: (B, 64) uint8 (numpy or a tensor), already SHA-256-padded.
    Returns (B, 32) uint8 on the device: the tensor's own, else `device`
    (CUDA unless told otherwise)."""
    if not isinstance(blocks, torch.Tensor):
        blocks = torch.as_tensor(np.asarray(blocks, dtype=np.uint8))
        blocks = blocks.to(resolve_device(device))
    n = blocks.shape[0]
    by = blocks.reshape(n, 16, 4).to(torch.int64)
    words = (by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8) \
        | by[..., 3]
    state = torch.as_tensor(IV.astype(np.int64), device=blocks.device)
    out = sha256_compress(state.expand(n, 8).contiguous(), words)
    parts = [((out >> (24 - 8 * i)) & 0xFF).to(torch.uint8) for i in range(4)]
    return torch.stack(parts, dim=-1).reshape(n, 32)


def sha256(data: bytes) -> bytes:
    """Host SHA-256 of arbitrary bytes (reference: tools/sm/sha256
    SHA256())."""
    return hashlib.sha256(data).digest()
