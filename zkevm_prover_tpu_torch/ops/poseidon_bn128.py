"""Poseidon permutation over BN254 Fr — the recursiveF/final-stage hasher.

Copy of `zkevm_prover_tpu/ops/poseidon_bn128.py` (host-only, exact Python
ints), reading its own copy of the constants,
`zkevm_prover_tpu_torch/ops/data/poseidon_bn128.json.gz`.

Reference: src/poseidon_opt/ (`Poseidon_opt::hash`, poseidon_opt.cpp:9-62)
— the circomlib optimized Poseidon (x^5 S-box, 8 full rounds, width-dependent
partial rounds) used for the BN128 Merkle trees (16 inputs + 1 capacity,
BN128_ARITY 16, merkleTreeBN128.cpp:117-137) and the BN128 transcript.

Constants are the reference's own set, extracted from the checked-in
2.3 MB header src/poseidon_opt/constants_opt.hpp (`Constants_opt::{C,M,P,S}`
for widths t = 2..17, stored there as Montgomery-form ffiasm RawFr limbs)
by tools/extract_poseidon_bn128.py, which decodes them to canonical
integers in ops/data/poseidon_bn128.json.gz. The t=3 set reproduces the
canonical circomlib vector poseidon([1,2]) (tests/test_poseidon_reference.py),
pinning the Montgomery decode used for every width.

The optimized schedule (same output as the plain circomlib permutation):
initial ark; 3 full rounds against the MDS `M`; one full round against the
pre-sparse matrix `P`; nRoundsP partial rounds via the sparse row/column
pairs `S` (23 scalars per round at t=17... generally 2t-1); 3 more full
rounds and a final constant-less full round against `M`.

Host-side exact ints: the recursiveF stage hashes a few thousand nodes per
proof, far off the hot path (the bulk phases stay on GL / device).
"""

from __future__ import annotations

import functools
import gzip
import json
import os

from .bn254 import R

T = 17          # zkEVM state width (16 rate + 1 capacity)
ROUNDS_F = 8
# circomlib partial-round counts per width t = 2..17
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]
ROUNDS_P = N_ROUNDS_P[T - 2]

_DATA = os.path.join(os.path.dirname(__file__), "data", "poseidon_bn128.json.gz")


@functools.lru_cache(maxsize=1)
def _all_tables() -> dict:
    with gzip.open(_DATA, "rt") as f:
        return json.load(f)["widths"]


@functools.lru_cache(maxsize=20)
def _tables(t: int):
    w = _all_tables()[str(t)]
    C = [int(v) for v in w["C"]]
    M = [[int(v) for v in row] for row in w["M"]]
    P = [[int(v) for v in row] for row in w["P"]]
    S = [int(v) for v in w["S"]]
    return C, M, P, S, int(w["nRoundsP"])


def _sbox(x: int) -> int:
    x2 = x * x % R
    return x2 * x2 % R * x % R


def _mix(s: list[int], m: list[list[int]]) -> list[int]:
    # reference orientation (poseidon_opt.cpp::mix): out_i = Σ_j m[j][i]·s_j
    t = len(s)
    return [sum(m[j][i] * s[j] for j in range(t)) % R for i in range(t)]


def permute(state: list[int]) -> list[int]:
    """Full optimized Poseidon permutation; width = len(state) in 2..17."""
    t = len(state)
    C, M, P, S, rp = _tables(t)
    half = ROUNDS_F // 2
    s = [v % R for v in state]
    s = [(s[i] + C[i]) % R for i in range(t)]
    for r in range(half - 1):
        s = [_sbox(v) for v in s]
        s = [(s[i] + C[(r + 1) * t + i]) % R for i in range(t)]
        s = _mix(s, M)
    s = [_sbox(v) for v in s]
    s = [(s[i] + C[half * t + i]) % R for i in range(t)]
    s = _mix(s, P)
    for r in range(rp):
        s[0] = (_sbox(s[0]) + C[(half + 1) * t + r]) % R
        s0 = sum(S[(2 * t - 1) * r + j] * s[j] for j in range(t)) % R
        for j in range(1, t):
            s[j] = (s[j] + s[0] * S[(2 * t - 1) * r + t + j - 1]) % R
        s[0] = s0
    for r in range(half - 1):
        s = [_sbox(v) for v in s]
        s = [(s[i] + C[(half + 1) * t + rp + r * t + i]) % R for i in range(t)]
        s = _mix(s, M)
    s = [_sbox(v) for v in s]
    return _mix(s, M)


def source() -> str:
    return "reference:circomlib-opt"


def hash16(inputs: list[int], capacity: int = 0) -> int:
    """Arity-16 compression: capacity-first state [cap, in0..in15] -> Fr.

    Matches merkleTreeBN128.cpp:121-127 (elements[0] = carried digest,
    elements[1..16] = values, result = state[0])."""
    assert len(inputs) == 16
    return permute([capacity] + list(inputs))[0]


def hash_partial(inputs: list[int], capacity: int = 0) -> int:
    """Short-chunk compression at width len(inputs)+1 — the reference's
    variable-width tail hash (merkleTreeBN128.cpp:130-136)."""
    assert 1 <= len(inputs) <= 16
    return permute([capacity] + list(inputs))[0]


def linear_hash_fr(values: list[int]) -> int:
    """Sponge over chunks of 16 Fr with the digest carried at state[0];
    the final short chunk runs at the narrower width (reference linearHash,
    merkleTreeBN128.cpp:113-138)."""
    if not values:
        return 0
    digest = 0
    pending = len(values)
    off = 0
    while pending > 0:
        take = 16 if pending >= 16 else pending
        chunk = list(values[off : off + take])
        if take == 16:
            digest = hash16(chunk, digest)
        else:
            digest = hash_partial(chunk, digest)
        off += take
        pending -= take
    return digest


GL_P = 0xFFFFFFFF_00000001


def pack_gl(values) -> list[int]:
    """Pack GL elements 3-per-Fr (3·64 = 192 < 253 bits) — the reference's
    element conversion for BN128 trees (merkleTreeBN128.cpp:98-111)."""
    out = []
    for off in range(0, len(values), 3):
        chunk = values[off : off + 3]
        acc = 0
        for i, v in enumerate(chunk):
            acc |= int(v) << (64 * i)
        out.append(acc % R)
    return out


def pack_gl_row(values) -> int:
    """Raw limb pack of a narrow (<= 4 GL) row into one Fr — the reference's
    width<=4 leaf path (merkleTreeBN128.cpp:142-151: limbs v[0..3] then
    toMontgomery, i.e. the value is taken mod r)."""
    acc = 0
    for i, v in enumerate(values):
        acc |= int(v) << (64 * i)
    return acc % R
