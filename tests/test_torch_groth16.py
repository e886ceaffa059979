"""The port's Groth16 (`snark/groth16.py`, `snark/r1cs.py`) against the JAX
package's on the CPU: the twins of tests/test_bn254_groth16.py.

The port computes the CRS's query vectors with the fixed-base twin, the
quotient with the NTT twin and the five MSMs with the MSM twin (the
kernels of csrc/bn254.cu on a card); its setup must equal the JAX
package's field by field, its seeded proof the JAX package's, and each
package's verifier must accept the other's proof.
"""

import random

import pytest
import torch

from zkevm_prover_tpu.ops import bn254 as jbn
from zkevm_prover_tpu.snark import R1CS as JR1CS
from zkevm_prover_tpu.snark import groth16 as jg
from zkevm_prover_tpu_torch.ops import msm
from zkevm_prover_tpu_torch.snark import R1CS
from zkevm_prover_tpu_torch.snark import groth16 as pg

R = jbn.R
FIELDS = ("domain_bits", "alpha1", "beta1", "beta2", "delta1", "delta2",
          "a_query", "b1_query", "b2_query", "l_query", "h_query", "gamma2",
          "ic")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cubic(builder):
    """tests/test_bn254_groth16.py's circuit: x^3 + x + 5 == out."""
    b = builder(n_public=1)
    x = b.alloc()
    x2 = b.mul(x, x)
    x3 = b.mul(x2, x)
    b.constrain({x3: 1, x: 1, 0: 5}, {0: 1}, {1: 1})
    return b.build()


def _witness(xv=7):
    out = (xv**3 + xv + 5) % R
    return [1, out, xv, xv * xv % R, pow(xv, 3, R)], out


# the port's Groth16 step seconds over the module's setup and proof
TIMES: dict = {}


@pytest.fixture(scope="module")
def setups():
    return pg.groth16_setup(_cubic(R1CS.builder), device="cpu",
                            times=TIMES), \
        jg.groth16_setup(_cubic(JR1CS.builder))


@pytest.fixture(scope="module")
def proofs(setups):
    w, _ = _witness()
    return pg.groth16_prove(setups[0], w, seed=b"twin", times=TIMES), \
        jg.groth16_prove(setups[1], w, seed=b"twin")


def test_setup_matches_jax_field_by_field(setups):
    mine, theirs = setups
    for f in FIELDS:
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.r1cs.constraints == theirs.r1cs.constraints
    assert (mine.r1cs.n_public, mine.r1cs.n_signals) == \
        (theirs.r1cs.n_public, theirs.r1cs.n_signals)
    assert isinstance(mine.a_query, msm.PointList)
    assert mine.device == torch.device("cpu")


def _random_circuit(builder, n_mul, seed):
    rng = random.Random(seed)
    b = builder(n_public=2)
    sigs = [1, 2]
    for _ in range(n_mul):
        x, y = rng.choice(sigs), rng.choice(sigs)
        z = b.alloc()
        b.constrain({x: rng.randrange(R), 0: 3}, {y: 1}, {z: 1})
        sigs.append(z)
    return b.build()


def test_qap_evals_and_quotient_match_jax():
    """The batched-inversion Lagrange basis and the device quotient against
    the JAX package's host loops, on a 40-constraint circuit (2^6)."""
    mine, theirs = (_random_circuit(bd, 40, 1)
                    for bd in (R1CS.builder, JR1CS.builder))
    tau = pg._rand_fr(b"t", b"tau")
    assert pg._qap_evals(mine, tau, 6) == jg._qap_evals(theirs, tau, 6)
    w = [random.Random(2).randrange(R) for _ in range(mine.n_signals)]
    w[0] = 1
    assert pg._quotient_coeffs(mine, w, 6, "cpu") == \
        jg._quotient_coeffs(theirs, w, 6)


def test_seeded_proof_matches_jax(proofs):
    mine, theirs = proofs
    assert mine == theirs
    assert set(mine) == {"pi_a", "pi_b", "pi_c"}


def test_verifiers_accept_each_others_proofs(setups, proofs):
    _, out = _witness()
    assert pg.groth16_verify(setups[0], [out], proofs[1])
    assert jg.groth16_verify(setups[1], [out], proofs[0])


def test_tampered_proofs_rejected(setups, proofs):
    _, out = _witness()
    assert not pg.groth16_verify(setups[0], [(out + 1) % R], proofs[0])
    bad = dict(proofs[0], pi_a=jbn.g1_add(proofs[0]["pi_a"], jbn.G1_GEN))
    assert not pg.groth16_verify(setups[0], [out], bad)
    assert not pg.groth16_verify(setups[0], [out], {"pi_a": None})


def test_bad_witness_refused(setups):
    w, _ = _witness()
    w[2] = 8
    with pytest.raises(AssertionError, match="does not satisfy"):
        pg.groth16_prove(setups[0], w, seed=b"twin")


def test_unseeded_proof_is_blinded_and_verifies(setups, proofs):
    """os.urandom blinding: another statement's proof, verified by the JAX
    package's verifier."""
    w, out = _witness(11)
    a = pg.groth16_prove(setups[0], w)
    assert a["pi_a"] != proofs[0]["pi_a"]
    assert jg.groth16_verify(setups[1], [out], a)


def test_step_times_are_recorded(setups, proofs):
    assert {"qap_evals", "crs_scalars", "pack", "crs", "unpack", "eval_lc",
            "ntt", "msm_a", "msm_b1", "msm_b2", "msm_c", "msm_h",
            "blind"} <= set(TIMES)
