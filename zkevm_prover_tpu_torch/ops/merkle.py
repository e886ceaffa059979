"""Poseidon Merkle trees over Goldilocks (arity 2) on the device.

Counterpart of `zkevm_prover_tpu/ops/merkle.py`, whose whole tree is one
XLA program. Here a CUDA source under `poseidon_cuda.MODE` "mxu96" is
committed by the fused kernel of csrc/poseidon_gl.cu
(`poseidon_cuda.merkle_levels`: row sponge and tree levels in a few
launches); under any other mode it takes the chunked path, one
`poseidon_gl.permute` launch per 8-column chunk and per level, through that
mode's kernel; a CPU source takes the chunked path through
`permute_plain`, which is also the plain twin of the fused kernel
(`merkelize_levels_plain`). Proofs are small gathers copied to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import goldilocks as gl
from . import poseidon_constants as pc
from . import poseidon_cuda
from . import poseidon_gl as pos
from . import refmodel as rm

HASH_SIZE = pos.HASH_SIZE


def merkelize_levels(source):
    """All tree levels for a (H, W) source; H must be a power of 2.

    Returns [leaves (H,4), ..., root_level (1,4)]: through the fused kernel
    for a CUDA source under mode mxu96, else chunked through
    `poseidon_gl.permute` (the mode's kernel, or plain on the CPU)."""
    if source.is_cuda and poseidon_cuda.MODE == "mxu96":
        return poseidon_cuda.merkle_levels(source)
    return merkelize_levels_chunked(source, pos.permute)


def merkelize_levels_plain(source):
    """The same levels chunked through `poseidon_gl.permute_plain`, on any
    device: the fused kernel's plain twin."""
    return merkelize_levels_chunked(source, pos.permute_plain)


def merkelize_levels_chunked(source, perm):
    """The levels as one `perm` call per 8-column chunk of the leaf sponge
    and one per tree level."""
    h = source.shape[0]
    assert h & (h - 1) == 0, "height must be a power of two"
    levels = [pos.linear_hash(source, perm)]
    while levels[-1].shape[0] > 1:
        levels.append(pos.hash_level(levels[-1], perm))
    return levels


@dataclasses.dataclass
class MerkleTree:
    """Committed source + hash levels. `source` layout is (height, width)."""

    source: torch.Tensor       # (H, W) int64
    levels: list               # [(H,4), (H/2,4), ..., (1,4)]

    @classmethod
    def commit(cls, source) -> "MerkleTree":
        return cls(source=source, levels=merkelize_levels(source))

    def root(self) -> np.ndarray:
        """The root as a numpy uint64 (4,) array."""
        return gl.to_u64(self.levels[-1][0])

    def proof_length(self) -> int:
        return len(self.levels) - 1

    def get_group_proof(self, idx: int):
        """Row values + sibling path for leaf `idx`, as numpy uint64."""
        row = gl.to_u64(self.source[idx])
        sibs = [lvl[(idx >> k) ^ 1] for k, lvl in enumerate(self.levels[:-1])]
        if not sibs:
            return row, np.zeros((0, HASH_SIZE), np.uint64)
        return row, gl.to_u64(torch.stack(sibs))


def verify_group_proof(root, idx: int, row, siblings, hasher=None) -> bool:
    """Host-side proof check (verifier oracle). `hasher` = refmodel.Poseidon."""
    if hasher is None:
        hasher = rm.Poseidon(pc.round_constants(), pc.mds_matrix())
    node = hasher.linear_hash([int(v) for v in row])
    i = idx
    for sib in siblings:
        s = [int(v) for v in sib]
        node = hasher.hash_pair(node, s) if i % 2 == 0 else hasher.hash_pair(s, node)
        i >>= 1
    return node == [int(v) for v in root]
