"""The slice end to end: PoseidonG actions through `Executor.prove_all` at
2^8 rows. The port's proof JSON hashes to a digest pinned from the JAX
package's proof of the same actions and its verkey equals the JAX
package's, pinned too; the port's verifier accepts that proof and rejects
a tampered one. The slow test recomputes the JAX proof and verifies each
side's proof with the other side's verifier (tens of seconds of XLA
compile):

    ZK_SLOW=1 python -m pytest -q -m slow tests/test_torch_slice.py
"""

import functools
import hashlib

import numpy as np
import pytest

from zkevm_prover_tpu_torch.executor import BatchActions, Executor
from zkevm_prover_tpu_torch.executor.sm import poseidon_g
from zkevm_prover_tpu_torch.stark.proof import StarkProof
from zkevm_prover_tpu_torch.stark.verifier import VerifyError, verify

N_BITS = 8

# the JAX package's Executor.prove_all on _actions() at 2^8: sha256 of the
# PoseidonG proof JSON, and the verkey
PROOF_PIN = "840430d2e99b405a81fa99d88fa7a7fafc92d396b2910cdf808537af67a8aeac"
VERKEY_PIN = [3135579921580711561, 2962354743026417310, 11598290296389631472,
              8101199838561613093]


def _actions():
    # tools/measure_baseline.py:116-120, cut to 2^8 rows
    rng = np.random.default_rng(2)
    return [{"state": [int(v) for v in rng.integers(0, 1 << 32, 12)]}
            for _ in range((1 << N_BITS) // poseidon_g.GROUP - 1)]


@functools.lru_cache(maxsize=None)
def _port():
    ex = Executor(n_bits={"poseidon_g": N_BITS}, device="cpu")
    return ex, ex.prove_all(BatchActions(poseidon_g=_actions()))


def test_trace_matches_jax():
    from zkevm_prover_tpu.executor.sm import poseidon_g as jpg

    acts = _actions()[:3]
    np.testing.assert_array_equal(poseidon_g.execute(acts, N_BITS),
                                  jpg.execute(acts, N_BITS))
    assert poseidon_g.result(acts[0]) == jpg.result(acts[0])
    tair, jair = poseidon_g.build_air(N_BITS), jpg.build_air(N_BITS)
    assert tair.const_names == jair.const_names
    for tc, jc in zip(tair.const_values, jair.const_values):
        np.testing.assert_array_equal(tc, jc)


def test_slice_proof_bytes_and_verkey_match_jax():
    _, proofs = _port()
    tp, tproof = proofs["poseidon_g"]
    assert [int(v) for v in np.ravel(tp.verkey)] == VERKEY_PIN
    assert hashlib.sha256(tproof.to_json().encode()).hexdigest() == PROOF_PIN


def test_slice_verifies_across_packages():
    """The port's verifier accepts the pinned proof bytes read back through
    `StarkProof.from_json` (the JAX package's verifier on the port's proof,
    and the port's on a freshly made JAX proof, run in the slow test)."""
    ex, proofs = _port()
    tp, tproof = proofs["poseidon_g"]
    assert ex.verify_all(proofs)
    text = tproof.to_json()
    assert hashlib.sha256(text.encode()).hexdigest() == PROOF_PIN
    assert verify(tp.setup, tp.verkey, StarkProof.from_json(text),
                  device="cpu")


def test_slice_tampered_proof_rejected():
    ex, proofs = _port()
    tp, tproof = proofs["poseidon_g"]
    bad = StarkProof.from_json(tproof.to_json())
    bad.fri[1].queries[0].values[0] += 1
    with pytest.raises(VerifyError):
        ex.verify_all({"poseidon_g": (tp, bad)})


@pytest.mark.slow
def test_jax_slice_proof_matches_pins_and_cross_verifies():
    from zkevm_prover_tpu.executor import BatchActions as JActions
    from zkevm_prover_tpu.executor import Executor as JExecutor
    from zkevm_prover_tpu.stark.proof import StarkProof as JProof
    from zkevm_prover_tpu.stark.verifier import verify as jverify

    jp, jproof = JExecutor(n_bits={"poseidon_g": N_BITS}).prove_all(
        JActions(poseidon_g=_actions()))["poseidon_g"]
    assert [int(v) for v in np.ravel(jp.verkey)] == VERKEY_PIN
    assert hashlib.sha256(jproof.to_json().encode()).hexdigest() == PROOF_PIN
    _, proofs = _port()
    tp, tproof = proofs["poseidon_g"]
    assert verify(tp.setup, tp.verkey, StarkProof.from_json(jproof.to_json()),
                  device="cpu")
    assert jverify(jp.setup, jp.verkey, JProof.from_json(tproof.to_json()))
