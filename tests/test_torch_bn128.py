"""The port's BN128 commitment stack against the JAX package: twins of
tests/test_bn128_stage.py (Poseidon over BN254 Fr, the arity-16 Merkle
tree, the BN128 transcript, and a recursiveF-shaped STARK of the Fibonacci
AIR under BN128 commitments). The host pieces are compared value for value;
the STARK's proof JSON is held to a digest pinned from the JAX package's
proof, which the slow test recomputes (seconds of XLA compile):

    ZK_SLOW=1 python -m pytest -q -m slow tests/test_torch_bn128.py
"""

import functools
import hashlib

import numpy as np
import pytest

from zkevm_prover_tpu.ops import merkle_bn128 as jmerkle
from zkevm_prover_tpu.ops import poseidon_bn128 as jpbn
from zkevm_prover_tpu.ops.transcript_bn128 import TranscriptBN128 as JTranscript
from zkevm_prover_tpu_torch.ops import merkle_bn128, poseidon_bn128 as pbn
from zkevm_prover_tpu_torch.ops.bn254 import R
from zkevm_prover_tpu_torch.ops.transcript_bn128 import TranscriptBN128
from zkevm_prover_tpu_torch.stark import examples, scheme
from zkevm_prover_tpu_torch.stark.proof import StarkProof
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.setup import StarkSetup
from zkevm_prover_tpu_torch.stark.verifier import VerifyError, verify

# the JAX package's BN128 proof of tests/test_stark_e2e.py's Fibonacci AIR
# (4 queries, fold 2 bits): sha256 of its JSON and its verkey (one Fr)
FIB_BN128_PIN = (
    "1c7f81930a65192b2d7fb6d5e5cbf49d3a7f7cbfb11e12b48f9272f991393527",
    2015507565107542409580418556259617258945024827612737171043595032455193526464)


def test_poseidon_bn128_basic():
    out = pbn.permute([0] * pbn.T)
    assert len(out) == pbn.T and all(0 <= v < R for v in out)
    assert out == jpbn.permute([0] * jpbn.T)
    assert out != pbn.permute([1] + [0] * (pbn.T - 1))
    rng = np.random.default_rng(1)
    for t in (3, 9, 17):
        state = [int.from_bytes(rng.bytes(32), "little") % R
                 for _ in range(t)]
        assert pbn.permute(state) == jpbn.permute(state)
    h = pbn.hash16(list(range(16)))
    assert 0 <= h < R and h == jpbn.hash16(list(range(16)))
    assert pbn.linear_hash_fr(list(range(21))) == \
        jpbn.linear_hash_fr(list(range(21)))
    packed = pbn.pack_gl([1, 2, 3, 4])
    assert packed[0] == 1 | (2 << 64) | (3 << 128)
    assert packed[1] == 4
    assert pbn.pack_gl_row([5, 6]) == jpbn.pack_gl_row([5, 6])


def test_merkle_bn128_commit_and_verify():
    rng = np.random.default_rng(0)
    src = rng.integers(0, pbn.GL_P, size=(64, 9), dtype=np.uint64)
    t = merkle_bn128.MerkleTreeBN128.commit(src)
    assert t.root() == jmerkle.MerkleTreeBN128.commit(src).root()
    assert t.proof_length() == 2  # 64 leaves, arity 16 -> 2 levels
    for idx in (0, 17, 63):
        row, sibs = t.get_group_proof(idx)
        assert merkle_bn128.verify_group_proof(t.root(), idx, row, sibs)
        assert jmerkle.verify_group_proof(t.root(), idx, row, sibs)
    row, sibs = t.get_group_proof(5)
    row = row.copy()
    row[0] += 1
    assert not merkle_bn128.verify_group_proof(t.root(), 5, row, sibs)
    # narrow rows pack into one Fr without a hash; a tensor commits the same
    import torch

    from zkevm_prover_tpu_torch.ops import goldilocks as gl

    narrow = src[:16, :3]
    assert merkle_bn128.MerkleTreeBN128.commit(
        gl.from_u64(narrow, "cpu")).root() == \
        jmerkle.MerkleTreeBN128.commit(narrow).root()
    assert isinstance(gl.from_u64(narrow, "cpu"), torch.Tensor)


def test_transcript_bn128_matches_jax():
    a, b = TranscriptBN128(), JTranscript()
    for t in (a, b):
        t.put([1, 2, 3, R - 1] + list(range(20)))
    assert a.get_field3() == b.get_field3()
    assert a.get_fr() == b.get_fr()
    assert a.get_permutations(4, 5) == b.get_permutations(4, 5)
    c = TranscriptBN128()
    c.put([1, 2, 4])
    assert c.get_field3() != TranscriptBN128().get_field3()


@functools.lru_cache(maxsize=None)
def _fib_bn128():
    air, trace = examples.fib_air_trace()
    setup = StarkSetup(air, n_queries=4, fri_fold_bits=2, hash_type="BN128")
    prover = StarkProver(setup, device="cpu")
    return setup, prover, prover.prove(trace)


def test_recursivef_shaped_stark_roundtrip():
    setup, prover, proof = _fib_bn128()
    assert isinstance(prover.verkey, int)  # single Fr root
    assert proof.hash_type == "BN128"
    text = proof.to_json()
    assert (hashlib.sha256(text.encode()).hexdigest(), prover.verkey) == \
        FIB_BN128_PIN
    assert verify(setup, prover.verkey, proof, device="cpu")
    # JSON round-trip with big Fr roots/siblings
    assert verify(setup, prover.verkey, StarkProof.from_json(text),
                  device="cpu")
    bad = StarkProof.from_json(text)
    bad.fri[0].queries[0][0].siblings[0][0] += 1
    with pytest.raises(VerifyError, match="merkle"):
        verify(setup, prover.verkey, bad, device="cpu")
    bad = StarkProof.from_json(text)
    bad.fri[1].queries[0].values[0] += 1
    with pytest.raises(VerifyError):
        verify(setup, prover.verkey, bad, device="cpu")


def test_scheme_registry():
    assert scheme.get("BN128") is scheme.BN128Scheme
    assert scheme.BN128Scheme.root_ints(7) == [7]
    assert scheme.root_int([9]) == 9 and scheme.root_int(np.array([3])) == 3
    with pytest.raises(ValueError, match="unknown commitment scheme"):
        scheme.get("nonsense")


@pytest.mark.slow
def test_jax_bn128_proof_matches_pin_and_cross_verifies():
    from tests.test_stark_e2e import fib_air, fib_trace
    from zkevm_prover_tpu.stark.prover import StarkProver as JProver
    from zkevm_prover_tpu.stark.proof import StarkProof as JProof
    from zkevm_prover_tpu.stark.setup import StarkSetup as JSetup
    from zkevm_prover_tpu.stark.verifier import verify as jverify

    jsetup = JSetup(fib_air(), n_queries=4, fri_fold_bits=2,
                    hash_type="BN128")
    jp = JProver(jsetup)
    jproof = jp.prove(fib_trace())
    text = jproof.to_json()
    assert (hashlib.sha256(text.encode()).hexdigest(), int(jp.verkey)) == \
        FIB_BN128_PIN
    setup, prover, proof = _fib_bn128()
    assert jverify(jsetup, jp.verkey, JProof.from_json(proof.to_json()))
    assert verify(setup, prover.verkey, StarkProof.from_json(text),
                  device="cpu")
