"""Commitment schemes of the eSTARK engine: GL (Poseidon-GL Merkle trees on
the device and the GL transcript) and BN128 (host).

Counterpart of `zkevm_prover_tpu/stark/scheme.py`. The reference's Starks
uses MerkleTreeGL + the GL Poseidon transcript, while StarkRecursiveF swaps
in MerkleTreeBN128 + TranscriptBN128 so the final proof is cheap to verify
inside a BN254 SNARK circuit (starkRecursiveF.cpp:151-170, starkInfo
verificationHashType). The prover commits and opens through whichever
scheme its setup names; the BN128 trees and transcript are host Python with
exact ints, as in the JAX package (a device Poseidon-BN128 is not ported).
"""

from __future__ import annotations

import numpy as np

from ..ops import merkle as merkle_gl
from ..ops import merkle_bn128
from ..ops import transcript as tr_gl
from ..ops.transcript_bn128 import TranscriptBN128


class GLScheme:
    name = "GL"
    Transcript = tr_gl.Transcript

    @staticmethod
    def commit(source):
        return merkle_gl.MerkleTree.commit(source)

    @staticmethod
    def root_ints(root) -> list[int]:
        # never np.asarray a python-int list here: values >= 2^63 make numpy
        # pick float64 and truncate them
        if isinstance(root, (list, tuple)):
            return [int(v) for v in root]
        return [int(v) for v in np.ravel(np.asarray(root))]

    @staticmethod
    def store_root(root):
        return np.asarray(root)


class BN128Scheme:
    name = "BN128"
    Transcript = TranscriptBN128

    @staticmethod
    def commit(source):
        """The arity-16 BN128 tree of a section (a device tensor is copied
        to the host first)."""
        return merkle_bn128.MerkleTreeBN128.commit(source)

    @staticmethod
    def root_ints(root) -> list[int]:
        return [root_int(root)]

    @staticmethod
    def store_root(root):
        return int(root)


def root_int(root) -> int:
    """A BN128 root as one int, however it is held (int, list or array)."""
    if isinstance(root, (int, np.integer)):
        return int(root)
    return int(np.ravel(np.asarray(root, dtype=object))[0])


SCHEMES = {"GL": GLScheme, "BN128": BN128Scheme}


def get(name: str):
    if name not in SCHEMES:
        raise ValueError(f"unknown commitment scheme {name!r}")
    return SCHEMES[name]
