"""SMT key bit manipulation — splitKey / joinKey / removeKeyBits.

Port of `zkevm_prover_tpu/hashdb/key_utils.py`: a host copy, the same
functions.

Reference: src/utils/key_utils.hpp:10-25 and their use in src/hashdb/smt.cpp.
A key is 4 Goldilocks elements; the tree path consumes one bit per level,
round-robin across the 4 elements: path bit for level i is bit (i >> 2) of
key[i & 3] (the reference's splitKey interleaving).
"""

from __future__ import annotations

P = 0xFFFFFFFF_00000001


def split_key(key: tuple[int, int, int, int], levels: int = 256) -> list[int]:
    """Key -> path bits, bit i = bit (i>>2) of key[i&3]."""
    return [(key[i & 3] >> (i >> 2)) & 1 for i in range(levels)]


def join_key(bits: list[int], rkey: tuple[int, int, int, int]) -> tuple:
    """Re-attach `bits` (consumed path, root-first) on top of remaining key.

    Inverse of removing len(bits) levels: the remaining key's element j holds
    the tail bits; shift them up by the number of consumed bits for lane j and
    or-in the consumed bits at the bottom.
    """
    n = [0, 0, 0, 0]  # consumed bits per lane
    acc = [0, 0, 0, 0]
    for i, b in enumerate(bits):
        lane = i & 3
        acc[lane] |= b << n[lane]
        n[lane] += 1
    return tuple((rkey[j] << n[j] | acc[j]) & 0xFFFFFFFFFFFFFFFF for j in range(4))


def remove_key_bits(key: tuple, n_bits: int) -> tuple:
    """Drop the first n_bits path bits from the key (descend n_bits levels)."""
    full = n_bits >> 2
    out = []
    for j in range(4):
        shift = full + (1 if j < (n_bits & 3) else 0)
        out.append(key[j] >> shift)
    return tuple(out)
