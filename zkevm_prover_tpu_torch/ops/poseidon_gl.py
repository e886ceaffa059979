"""Batched Poseidon-Goldilocks permutation and hashing (torch).

Counterpart of `zkevm_prover_tpu/ops/poseidon_gl.py`. States are (..., 12)
int64 tensors. `permute` dispatches on the device: a CUDA tensor goes to the
hand-written kernel of `poseidon_cuda.MODE` (`ops/poseidon_cuda.py`), a CPU
tensor to `permute_plain`, the same permutation in plain torch ops, whatever
the mode. `permute_plain` runs on any device;
the tests and `chip_smoke.py` hold the kernel against it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import goldilocks as gl
from . import poseidon_constants as pc

WIDTH = pc.WIDTH
CAPACITY = 4
RATE = 8
HASH_SIZE = 4


@functools.lru_cache(maxsize=4)
def tables_host(source: str):
    """Host copies (numpy uint64) of (C (30, 12), M (12, 12)) for the active
    constant set."""
    C = np.array(pc.round_constants(), dtype=np.uint64).reshape(pc.N_ROUNDS, WIDTH)
    M = np.array(pc.mds_matrix(), dtype=np.uint64)
    return C, M


@functools.lru_cache(maxsize=4)
def mds_coeffs(source: str):
    """If every MDS entry is a small integer (<= 2^16 — true for the
    reference circulant, max entry 41), the coefficient matrix (host int64);
    else None."""
    _, M = tables_host(source)
    coeffs = np.zeros(M.shape, dtype=np.int64)
    for i in range(WIDTH):
        for j in range(WIDTH):
            v = int(M[i, j])
            if v == 0 or v > (1 << 16):
                return None
            coeffs[i, j] = v
    return coeffs


def _mds_small(s, coeffs):
    """MDS multiply for small-integer matrices: split each input lane into
    u32 halves, accumulate coefficient-scaled halves (max 12·2^16·2^32 <
    2^53, no overflow), recombine as a 128-bit value and reduce."""
    lo = s & gl.M32
    hi = gl._srl32(s)
    acc_lo = torch.zeros_like(s)
    acc_hi = torch.zeros_like(s)
    for j in range(WIDTH):
        cj = torch.as_tensor(coeffs[:, j], device=s.device)  # out-lane coeffs
        acc_lo = acc_lo + lo[..., j, None] * cj
        acc_hi = acc_hi + hi[..., j, None] * cj
    # total = acc_lo + acc_hi·2^32 with acc_lo, acc_hi < 2^53
    lo64 = acc_lo + ((acc_hi & gl.M32) << 32)
    carry = gl._ult(lo64, acc_lo).to(torch.int64)
    hi64 = (acc_hi >> 32) + carry
    return gl._reduce128(hi64, lo64)


def _modsum_last(x):
    """Mod-p sum along the last axis via a pairwise reduction tree."""
    n = x.shape[-1]
    while n > 1:
        half = n // 2
        lo = gl.add(x[..., :half], x[..., half:2 * half])
        if n % 2:
            lo = torch.cat([gl.add(lo[..., :1], x[..., -1:]), lo[..., 1:]], -1)
        x = lo
        n = half
    return x[..., 0]


def _sbox(x):
    x3 = gl.mul(gl.square(x), x)
    return gl.mul(gl.mul(x3, x3), x)


def mds(s):
    """(..., 12) states times the MDS of the active constant set."""
    coeffs = mds_coeffs(pc.source())
    if coeffs is not None:
        return _mds_small(s, coeffs)
    # generic MDS: out_i = sum_j M[i][j] * s_j
    M = gl.from_u64(tables_host(pc.source())[1], s.device)
    return _modsum_last(gl.mul(s[..., None, :], M))


def round_constants(device):
    """(30, 12) int64 round constants of the active set on `device`."""
    return gl.from_u64(tables_host(pc.source())[0], device)


def is_full_round(r: int) -> bool:
    half = pc.ROUNDS_F // 2
    return r < half or r >= half + pc.ROUNDS_P


def permute_plain(state):
    """The permutation in plain torch ops, on any device: 4 full, 22 partial
    and 4 full rounds, each adding the round constants, applying x^7 (all
    lanes, or lane 0 in partial rounds) and multiplying by the MDS."""
    C = round_constants(state.device)
    s = state
    for r in range(pc.N_ROUNDS):
        s = gl.add(s, C[r])
        if is_full_round(r):
            s = _sbox(s)
        else:
            s = torch.cat([_sbox(s[..., :1]), s[..., 1:]], dim=-1)
        s = mds(s)
    return s


def permute(state):
    """Poseidon permutation over (H, 12) int64 states.

    A CUDA tensor goes to the CUDA kernel of `poseidon_cuda.MODE` (every
    batch size; it raises for a constant set whose MDS the mode cannot take),
    a CPU tensor to `permute_plain`, whatever the mode."""
    if state.is_cuda:
        from . import poseidon_cuda

        return poseidon_cuda.permute(state)
    return permute_plain(state)


def _zeros(h, w, like):
    return torch.zeros((h, w), dtype=torch.int64, device=like.device)


def hash_n_to_4(inputs):
    """Single-permutation hash of (H, <=12) inputs (zero-padded)."""
    h, n = inputs.shape
    if n < WIDTH:
        inputs = torch.cat([inputs, _zeros(h, WIDTH - n, inputs)], dim=1)
    return permute(inputs)[:, :HASH_SIZE]


def linear_hash(rows, perm=permute):
    """Row-wise sponge hash: (H, W) -> (H, 4).

    Chunks of RATE elements, previous digest carried in the capacity. Rows of
    width <= 4 are zero-padded copies. `perm` is the permutation to use
    (`permute`, or `permute_plain` on any device)."""
    h, wdt = rows.shape
    if wdt <= HASH_SIZE:
        return torch.cat([rows, _zeros(h, HASH_SIZE - wdt, rows)], dim=1)
    return linear_hash_fold(rows, _zeros(h, HASH_SIZE, rows), perm)


def linear_hash_fold(rows, digest, perm=permute):
    """Continue a row-wise sponge from `digest` over more columns; folding
    a wide row block by block (blocks a RATE multiple) gives the same digest
    as one linear_hash."""
    h, wdt = rows.shape
    for off in range(0, wdt, RATE):
        chunk = rows[:, off:off + RATE]
        if chunk.shape[1] < RATE:
            chunk = torch.cat([chunk, _zeros(h, RATE - chunk.shape[1], rows)],
                              dim=1)
        digest = perm(torch.cat([chunk, digest], dim=1))[:, :HASH_SIZE]
    return digest


def hash_level(nodes, perm=permute):
    """One Merkle reduction level: (H, 4) -> (H/2, 4)."""
    h = nodes.shape[0]
    pairs = nodes.reshape(h // 2, 2 * HASH_SIZE)
    cap = _zeros(h // 2, WIDTH - 2 * HASH_SIZE, nodes)
    return perm(torch.cat([pairs, cap], dim=1))[:, :HASH_SIZE]
