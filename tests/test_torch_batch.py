"""The co-processor batch end to end: one mixed `BatchActions` with all seven
ported SMs at 2^9 rows (binary with 2-bit slices) through the port's
`Executor.prove_all` on the CPU. Each proof's JSON hashes to a digest pinned
from the JAX package's `Executor.prove_all` on the same actions; the slow
test recomputes those JAX proofs (minutes of XLA compile per SM, so it runs
only with ZK_SLOW=1):

    ZK_SLOW=1 python -m pytest -q -m slow tests/test_torch_batch.py
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

from zkevm_prover_tpu_torch.executor import BatchActions, Executor, examples
from zkevm_prover_tpu_torch.stark.proof import StarkProof
from zkevm_prover_tpu_torch.stark.verifier import VerifyError, verify

# every SM at the JAX package's default size except binary, cut from 2^13 to
# 2^9 as the JAX tests run it (2-bit slices)
N_BITS = {"binary": 9}

# sha256 of each SM's proof JSON, from the JAX package's Executor.prove_all
# on examples.mixed_batch() with the same n_bits
PINS = {
    "binary":
        "c9c060b626446895e506194d5396671c5f3d7d50f8c88f0742e2b8baccfaf5a1",
    "memory":
        "2ba91db1155ee95fc9d387a9e8f6bb7f37d72212cd14512116ce1b326fa7486e",
    "arith":
        "a50d4b8cc100664416f34c03eae04c3defeba1de67af16ef37c4eff6cc3dce13",
    "mem_align":
        "2489a79c078831c8117d34c946c1a3039339881b6ff9d4a2a66446a2e46d8d2e",
    "poseidon_g":
        "afa15c0f785e480948356edacebe159b684edeb350e2592077861c1034273d27",
    "padding_pg":
        "dffe5ab44033afe31f3b855360ba23470bd6d2f1c8efd06329614ceb9c2df917",
    "climb_key":
        "37b4c3b331a268a35fbe5af67fd5153b22103e774b70166ecea7750737bef7b9",
}


def proof_digests(proofs: dict) -> dict:
    return {name: hashlib.sha256(proof.to_json().encode()).hexdigest()
            for name, (_, proof) in proofs.items()}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The test workers share the cores with XLA's compiler threads; torch's
    intra-op thread pool slows down by orders of magnitude when
    oversubscribed, so the port's CPU prove runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _port():
    ex = Executor(n_bits=N_BITS, device="cpu")
    return ex, ex.prove_all(BatchActions(**examples.mixed_batch()))


def test_batch_proofs_match_pins():
    _, proofs = _port()
    assert proof_digests(proofs) == PINS


def test_batch_verifies():
    ex, proofs = _port()
    assert ex.verify_all(proofs)


def test_batch_tampered_proof_rejected():
    ex, proofs = _port()
    prover, proof = proofs["arith"]
    bad = StarkProof.from_json(proof.to_json())
    bad.fri[0].queries[0][0].values[0] += 1
    with pytest.raises(VerifyError):
        ex.verify_all({"arith": (prover, bad)})


@pytest.mark.slow
def test_jax_batch_proofs_match_pins_and_cross_verify():
    from zkevm_prover_tpu.executor import BatchActions as JActions
    from zkevm_prover_tpu.executor import Executor as JExecutor
    from zkevm_prover_tpu.stark.proof import StarkProof as JProof
    from zkevm_prover_tpu.stark.verifier import verify as jverify

    jproofs = JExecutor(n_bits=N_BITS).prove_all(
        JActions(**examples.mixed_batch()))
    assert proof_digests(jproofs) == PINS
    _, proofs = _port()
    for name, (jp, jproof) in jproofs.items():
        tp, tproof = proofs[name]
        np.testing.assert_array_equal(tp.verkey, jp.verkey)
        assert verify(tp.setup, tp.verkey,
                      StarkProof.from_json(jproof.to_json()), device="cpu")
        assert jverify(jp.setup, jp.verkey, JProof.from_json(tproof.to_json()))
