"""The port's eSTARK prover and verifier against the JAX package's, on the
four AIRs of tests/test_stark_e2e.py (fibonacci, lookup, permutation,
connection): proof JSON, verkey and setup description hashed to digests
pinned from the JAX package's proofs, the port's verifier accepting the
pinned bytes, and tampered proofs rejected. The slow test recomputes the
JAX proofs and verifies each side's proof with the other side's verifier
(tens of seconds of XLA compile per AIR):

    ZK_SLOW=1 python -m pytest -q -m slow tests/test_torch_stark.py
"""

import dataclasses
import functools
import hashlib

import numpy as np
import pytest

import jax.numpy as jnp
import test_stark_e2e as jax_airs
from zkevm_prover_tpu.stark import prover as jprover
from zkevm_prover_tpu.stark.proof import StarkProof as JProof
from zkevm_prover_tpu.stark.setup import StarkSetup as JSetup
from zkevm_prover_tpu.stark.verifier import verify as jverify
from zkevm_prover_tpu_torch.ops import goldilocks as gl
from zkevm_prover_tpu_torch.stark import examples
from zkevm_prover_tpu_torch.stark import prover as tprover
from zkevm_prover_tpu_torch.stark.proof import StarkProof as TProof
from zkevm_prover_tpu_torch.stark.setup import StarkSetup as TSetup
from zkevm_prover_tpu_torch.stark.verifier import VerifyError
from zkevm_prover_tpu_torch.stark.verifier import verify as tverify

AIRS = ["fibonacci", "lookup", "permutation", "connection"]

# the JAX package's StarkProver on each AIR (n_queries 8, fold 2 bits):
# sha256 of the proof JSON, the verkey, sha256 of repr(setup.describe())
PINS = {
    "fibonacci": (
        "1282bfb756c78b82970b9e29fd749ca4598904d091ea9b937f5115a113518fd8",
        [795577548449717483, 17137232531653018047, 15692279676059554822,
         5372094768132972965],
        "11552d2fa319153e0923cfb8bb252cd55d3d6e3e9e0e418b2a0db3730e410a83"),
    "lookup": (
        "d5c411934af6588252f2ec3b6dfddddccf26825cbffe47ce5a7774deeaef3dcd",
        [10470141027275039409, 2685342031188988526, 11526436551242153935,
         2371388926532500063],
        "076ce9f8825cb61fbedf4229ff7c73c0c685076742d14154861889bcf15e5ff7"),
    "permutation": (
        "163c351cde235c115dfa572b3d2ade42de251388ca8712ccab786fd3c6dbcf94",
        [17595734851338256415, 14755103899730201611, 5377409718452357859,
         4200974445807697641],
        "0b9d1dbff53e99ef6b31f4712ccc54ef38381df73353b4c1e1e7ed437267748b"),
    "connection": (
        "cbe95c093b0749c2138bd35ef55eabbaf1a22e93c54246b21e61969d2020d1aa",
        [17317349717187819446, 9663331794646707286, 1733069152067957066,
         3928424911826512600],
        "06b974664b4ca5e3c644d3fb4575f9f18dfdaedf0ab4d5be285720b609179d64"),
}


def _pins(setup, prover, proof):
    return (hashlib.sha256(proof.to_json().encode()).hexdigest(),
            [int(v) for v in np.ravel(prover.verkey)],
            hashlib.sha256(repr(setup.describe()).encode()).hexdigest())


def _jax_air_trace(name):
    if name == "fibonacci":
        return jax_airs.fib_air(), jax_airs.fib_trace()
    if name == "lookup":
        return (jax_airs.lookup_air(),
                jax_airs.lookup_trace(np.random.default_rng(7)))
    if name == "permutation":
        return (jax_airs.permutation_air(),
                jax_airs.permutation_trace(np.random.default_rng(8)))
    return jax_airs.connection_air_trace(np.random.default_rng(9))


@functools.lru_cache(maxsize=None)
def _jax_proof(name):
    air, trace = _jax_air_trace(name)
    setup = JSetup(air, n_queries=8, fri_fold_bits=2)
    prover = jprover.StarkProver(setup)
    return setup, prover, prover.prove(trace)


@functools.lru_cache(maxsize=None)
def _port_proof(name):
    air, trace = examples.all_air_traces(jax_airs.N_BITS)[name]
    setup = TSetup(air, n_queries=8, fri_fold_bits=2)
    prover = tprover.StarkProver(setup, device="cpu")
    return setup, prover, prover.prove(trace)


@pytest.mark.parametrize("name", AIRS)
def test_proof_bytes_match_jax(name):
    assert _pins(*_port_proof(name)) == PINS[name]


@pytest.mark.parametrize("name", AIRS)
def test_verifiers_accept_each_other(name):
    """The port's verifier accepts the pinned proof bytes read back through
    `StarkProof.from_json` (the JAX package's verifier on the port's proof,
    and the port's on a freshly made JAX proof, run in the slow test)."""
    tsetup, tp, tproof = _port_proof(name)
    text = tproof.to_json()
    assert hashlib.sha256(text.encode()).hexdigest() == PINS[name][0]
    assert tverify(tsetup, tp.verkey, TProof.from_json(text), device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("name", AIRS)
def test_jax_proofs_match_pins_and_cross_verify(name):
    jsetup, jp, jproof = _jax_proof(name)
    assert _pins(jsetup, jp, jproof) == PINS[name]
    tsetup, tp, tproof = _port_proof(name)
    assert tsetup.describe() == jsetup.describe()
    assert tverify(tsetup, tp.verkey, TProof.from_json(jproof.to_json()),
                   device="cpu")
    assert jverify(jsetup, jp.verkey, JProof.from_json(tproof.to_json()))


def test_tampered_proof_rejected():
    setup, prover, proof = _port_proof("fibonacci")
    e = list(proof.evals)
    e[0] = ((e[0][0] + 1) % gl.P, e[0][1], e[0][2])
    with pytest.raises(VerifyError):
        tverify(setup, prover.verkey, dataclasses.replace(proof, evals=e),
                device="cpu")
    bad = TProof.from_json(proof.to_json())
    bad.fri[0].queries[0][0].values[0] += 1
    with pytest.raises(VerifyError, match="merkle"):
        tverify(setup, prover.verkey, bad, device="cpu")
    bad = TProof.from_json(proof.to_json())
    bad.final_pol[0, 0] = (int(bad.final_pol[0, 0]) + 1) % gl.P
    with pytest.raises(VerifyError):
        tverify(setup, prover.verkey, bad, device="cpu")


def test_tampered_trace_and_lookup_rejected():
    setup, prover, _ = _port_proof("fibonacci")
    trace = jax_airs.fib_trace()
    trace[5, 0] = (int(trace[5, 0]) + 1) % gl.P
    with pytest.raises(VerifyError):
        tverify(setup, prover.verkey, prover.prove(trace), device="cpu")
    _, lk_prover, _ = _port_proof("lookup")
    trace = jax_airs.lookup_trace(np.random.default_rng(7))
    trace[3, 0] = 1   # not a multiple of 3 -> not in the table
    with pytest.raises(ValueError, match="plookup violation"):
        lk_prover.prove(trace)


def test_h1h2_and_z_match_jax():
    rng = np.random.default_rng(3)
    n = 64
    for d in (1, 3):
        t = rng.integers(0, 50, (n, d)).astype(np.uint64)
        t[:4] = np.uint64(gl.P - 1)   # values above 2^63 sort as unsigned
        f = t[rng.integers(0, n, n)]
        jh1, jh2, jok = jprover.calculate_h1h2(jnp.asarray(f), jnp.asarray(t))
        th1, th2, tok = tprover.calculate_h1h2(gl.from_u64(f, "cpu"),
                                               gl.from_u64(t, "cpu"))
        assert tok and bool(jok)
        np.testing.assert_array_equal(gl.to_u64(th1), np.asarray(jh1))
        np.testing.assert_array_equal(gl.to_u64(th2), np.asarray(jh2))
    num = rng.integers(1, gl.P, (n, 3), dtype=np.uint64)
    den = np.roll(num, 1, axis=0)
    np.testing.assert_array_equal(
        gl.to_u64(tprover.calculate_z(gl.from_u64(num, "cpu"),
                                      gl.from_u64(den, "cpu"))),
        np.asarray(jprover.calculate_z(jnp.asarray(num), jnp.asarray(den))))
