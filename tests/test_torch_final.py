"""The port's final SNARK wrap (`Prover.gen_final_proof`,
`verify_final_proof`, `publics_digest`, `snark/stark_verifier_circuit.py`)
against the JAX package's on the CPU.

Two chained batches are joined with `gen_aggregated_proof`; the digest,
plonk and fflonk modes read only the joined publics, so the batches are
publics-only here (test_torch_aggregation.py proves the chaining over real
memory proofs). plonk and fflonk are deterministic: their final proofs
must equal the JAX package's; the digest Groth16 is blinded from
os.urandom: each package's verifier must accept the other's proof. The
stark-verify mode's circuit is compared constraint for constraint on the
port's BN128 Fibonacci proof (2^6), which the JAX side reads through
`StarkProof.from_json`; its Groth16 setup over the 764k-constraint circuit
of a memory batch runs on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 5d).
"""

import dataclasses

import pytest
import torch

from zkevm_prover_tpu.ops import bn254 as jbn
from zkevm_prover_tpu.prover import Prover as JProver
from zkevm_prover_tpu.prover import PublicInputs as JPublics
from zkevm_prover_tpu.prover.prover import BatchProof as JBatchProof
from zkevm_prover_tpu.prover.prover import FinalProof as JFinalProof
from zkevm_prover_tpu.snark import stark_verifier_circuit as jsvc
from zkevm_prover_tpu.stark.proof import StarkProof as JStarkProof
from zkevm_prover_tpu_torch.prover import Prover, PublicInputs
from zkevm_prover_tpu_torch.prover.prover import BatchProof, FinalProof
from zkevm_prover_tpu_torch.snark import stark_verifier_circuit as svc
from zkevm_prover_tpu_torch.stark import examples
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.setup import StarkSetup

R = jbn.R


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chained(publics_cls, batch_cls):
    """Two publics-only batch proofs, the second chained on the first."""
    a = publics_cls(old_state_root="0x" + "11" * 32,
                    new_state_root="0x" + "22" * 32,
                    old_acc_input_hash="0x" + "00" * 32,
                    new_acc_input_hash="0x" + "33" * 32,
                    old_batch_num=7, new_batch_num=8, chain_id=1000,
                    batch_l2_data="0xdead")
    b = dataclasses.replace(a, old_state_root=a.new_state_root,
                            new_state_root="0x" + "44" * 32,
                            old_acc_input_hash=a.new_acc_input_hash,
                            new_acc_input_hash="0x" + "55" * 32,
                            old_batch_num=8, new_batch_num=9)
    return [batch_cls(publics=p, sm_proofs={}, counters={}) for p in (a, b)]


@pytest.fixture(scope="module")
def provers():
    mine = Prover(n_bits=9, device="cpu")
    theirs = JProver(n_bits=9)
    agg = mine.gen_aggregated_proof(*_chained(PublicInputs, BatchProof))
    jagg = theirs.gen_aggregated_proof(*_chained(JPublics, JBatchProof))
    return mine, theirs, agg, jagg


def test_publics_digest_matches_jax(provers):
    mine, theirs, agg, jagg = provers
    assert dataclasses.asdict(agg.publics) == dataclasses.asdict(jagg.publics)
    assert mine.publics_digest(agg.publics) == \
        theirs.publics_digest(jagg.publics)
    assert 0 < mine.publics_digest(agg.publics) < R
    assert mine.final_snark == "stark-verify"


def _jax_final(fp):
    return JFinalProof(publics=JPublics(**dataclasses.asdict(fp.publics)),
                       groth16=fp.groth16, publics_digest=fp.publics_digest,
                       stark_publics=fp.stark_publics)


def test_digest_groth16_final_proof_cross_verifies(provers):
    mine, theirs, agg, jagg = provers
    fp = mine.gen_final_proof(agg, snark="digest")
    jfp = theirs.gen_final_proof(jagg, snark="digest")
    assert set(fp.groth16) == {"pi_a", "pi_b", "pi_c"}
    assert mine._final_circuit().ic == theirs._final_circuit().ic
    assert theirs.verify_final_proof(_jax_final(fp))
    assert mine.verify_final_proof(FinalProof(
        publics=agg.publics, groth16=jfp.groth16,
        publics_digest=jfp.publics_digest))
    fp.publics_digest ^= 1
    assert not mine.verify_final_proof(fp)


@pytest.mark.parametrize("snark", ["plonk", "fflonk"])
def test_plonk_and_fflonk_final_proofs_match_jax(provers, snark):
    mine, theirs, agg, jagg = provers
    fp = mine.gen_final_proof(agg, snark=snark)
    jfp = theirs.gen_final_proof(jagg, snark=snark)
    assert fp.groth16["system"] == snark
    assert fp.groth16 == jfp.groth16
    assert fp.publics_digest == jfp.publics_digest
    assert mine.verify_final_proof(fp)
    bad = dataclasses.replace(fp, publics_digest=fp.publics_digest ^ 1)
    assert not mine.verify_final_proof(bad)


@pytest.fixture(scope="module")
def fib_bn128():
    """The port's BN128 Fibonacci proof (2^6, one query) and the JAX
    package's setup of the same AIR, reading the port's proof bytes."""
    from tests.test_stark_e2e import fib_air
    from zkevm_prover_tpu.stark.setup import StarkSetup as JSetup

    air, trace = examples.fib_air_trace()
    setup = StarkSetup(air, n_queries=1, fri_fold_bits=2, hash_type="BN128")
    prover = StarkProver(setup, device="cpu")
    proof = prover.prove(trace)
    jsetup = JSetup(fib_air(), n_queries=1, fri_fold_bits=2,
                    hash_type="BN128")
    return (setup, int(prover.verkey), proof), \
        (jsetup, int(prover.verkey), JStarkProof.from_json(proof.to_json()))


def test_stark_verifier_circuit_matches_jax(fib_bn128):
    mine, theirs = fib_bn128
    r1cs, w, pubs = svc.build(*mine)
    jr1cs, jw, jpubs = jsvc.build(*theirs)
    assert r1cs.is_satisfied(w)
    assert (r1cs.n_public, r1cs.n_signals) == (jr1cs.n_public,
                                               jr1cs.n_signals)
    assert r1cs.constraints == jr1cs.constraints
    assert (w, pubs) == (jw, jpubs)


def test_stark_verifier_join_circuit_matches_jax(fib_bn128):
    mine, theirs = fib_bn128
    r1cs, w, pubs = svc.build_join([mine])
    jr1cs, jw, jpubs = jsvc.build_join([theirs])
    assert r1cs.constraints == jr1cs.constraints
    assert (r1cs.n_signals, w, pubs) == (jr1cs.n_signals, jw, jpubs)
    assert pubs[0] == mine[1]


@pytest.mark.slow
def test_final_proof_recursive_on_cpu():
    """The recursiveF wrap (`gen_final_proof_recursive`) of a recursive1
    node of the Fibonacci proof: the node's trace re-proved under BN128
    and verified inside one Groth16 circuit (hours on the CPU twins)."""
    from zkevm_prover_tpu_torch.prover.prover import RecursiveNode
    from zkevm_prover_tpu_torch.snark import groth16_verify
    from zkevm_prover_tpu_torch.stark.recursive import RecursiveProver

    air, trace = examples.fib_air_trace()
    setup = StarkSetup(air, n_queries=4, fri_fold_bits=2)
    inner = StarkProver(setup, device="cpu")
    proof = inner.prove(trace)
    pv = Prover(n_queries=4, device="cpu")
    pv._r1 = RecursiveProver(setup, n_bits=13, n_queries=4, device="cpu")
    rec = pv._r1.prove_one(inner.verkey, proof)
    node = RecursiveNode(proof=rec.proof, verkey=pv._r1.outer_prover.verkey,
                         publics=PublicInputs(), kind="r1",
                         wrap_args=(inner.verkey, proof))
    fp = pv.gen_final_proof(node)
    assert fp.groth16["system"] == "groth16-recursive"
    # the Fibonacci publics are not the batch layout that
    # verify_final_proof_recursive reads the state roots from: check the
    # circuit's verkey public and the Groth16 proof itself
    assert fp.stark_publics[0] == int(pv._rf["r1"].verkey)
    assert groth16_verify(pv._final_rec_g16["r1"], fp.stark_publics,
                          fp.groth16)
