"""Arity-16 Merkle tree over BN254 Fr for the recursiveF stage.

Copy of `zkevm_prover_tpu/ops/merkle_bn128.py` (host-only); `commit` also
takes an int64 tensor holding the u64 bit patterns (the port's sections),
copied to the host first.

Reference: src/starkpil/merkleTree/merkleTreeBN128.cpp (leaf rows of GL
values packed 3-per-Fr, Poseidon_opt linear hash, 16-ary tree reduce;
getGroupProof returns the row plus, per level, the 15 sibling hashes).

Host implementation with exact ints — recursiveF trees are small (the
final-stage trace), while the GL trees of the bulk stages stay on device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import goldilocks as gl
from . import poseidon_bn128 as pbn

ARITY = 16


def _leaf_hash(row) -> int:
    """Leaf for one source row: width <= 4 packs the raw GL limbs into a
    single Fr with no hash (reference linearHash else-branch,
    merkleTreeBN128.cpp:142-151); wider rows pack 3-per-Fr and sponge."""
    vals = [int(v) for v in row]
    if len(vals) <= 4:
        return pbn.pack_gl_row(vals)
    return pbn.linear_hash_fr(pbn.pack_gl(vals))


@dataclasses.dataclass
class MerkleTreeBN128:
    source: np.ndarray        # (H, W) uint64 GL values
    levels: list              # [leaf hashes (H ints)], ..., [root]

    @classmethod
    def commit(cls, source) -> "MerkleTreeBN128":
        if isinstance(source, torch.Tensor):
            source = gl.to_u64(source)
        src = np.asarray(source)
        h = src.shape[0]
        assert h & (h - 1) == 0, "height must be a power of two"
        leaves = [_leaf_hash(src[i]) for i in range(h)]
        levels = [leaves]
        while len(levels[-1]) > 1:
            cur = levels[-1]
            nxt = []
            for off in range(0, len(cur), ARITY):
                chunk = cur[off : off + ARITY]
                chunk = chunk + [0] * (ARITY - len(chunk))
                nxt.append(pbn.hash16(chunk))
            levels.append(nxt)
        return cls(source=src, levels=levels)

    def root(self) -> int:
        return self.levels[-1][0]

    def proof_length(self) -> int:
        return len(self.levels) - 1

    def get_group_proof(self, idx: int):
        """(row GL values, [[15 sibling Fr hashes] per level])."""
        row = np.asarray(self.source[idx])
        siblings = []
        i = idx
        for lvl in self.levels[:-1]:
            base = (i // ARITY) * ARITY
            sibs = []
            for k in range(ARITY):
                if base + k == i:
                    continue
                sibs.append(lvl[base + k] if base + k < len(lvl) else 0)
            siblings.append(sibs)
            i //= ARITY
        return row, siblings


def verify_group_proof(root: int, idx: int, row, siblings) -> bool:
    node = _leaf_hash(row)
    i = idx
    for sibs in siblings:
        pos = i % ARITY
        chunk = list(sibs[:pos]) + [node] + list(sibs[pos:])
        chunk = [int(v) for v in chunk] + [0] * (ARITY - len(chunk))
        node = pbn.hash16(chunk[:ARITY])
        i //= ARITY
    return node == int(root)
