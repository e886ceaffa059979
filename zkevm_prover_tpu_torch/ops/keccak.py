"""Keccak-256 on the host: the exact sponge over Python ints.

Port of the host half of `zkevm_prover_tpu/ops/keccak.py` (`_RC`, `_ROT`,
`RATE_BYTES`, `_keccak_f_host`, `keccak256`), the same function. Reference:
the XKCP compact Keccak (src/XKCP/Keccak-more-compact.cpp), used for tx
hashing, witness parsing and the fflonk transcript; here `hashdb`'s facade
calls it.

The device half of the JAX module (`keccak_f`, a batched keccak-f[1600]
over (..., 25) lanes, and `keccak256_blocks`) is not ported yet: it feeds
the Keccak state machines, which come with the hash-machine slice.

State layout: 25 u64 lanes, lane index = x + 5*y (FIPS-202 order).
"""

from __future__ import annotations

import numpy as np

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
