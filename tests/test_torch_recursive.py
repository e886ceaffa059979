"""STARK-in-STARK recursion in the port against the JAX package: twins of
tests/test_recursive.py on the same Fibonacci AIR at 2^6 with 4 queries.

The port's inner proof is byte-identical to the JAX package's (pinned), so
the JAX synthesis reads the port's proof through `StarkProof.from_json` and
both packages' recursive1 circuits are compared cell for cell: gate list,
hash claims, publics, selector and sigma constants, and trace. The default
tier checks the compiled circuit with `check_constraints(quick=True)`, and
`Prover.verify_recursive`'s choice of outer circuit on stand-in proofs; the
outer proves (recursive1 at 2^13, recursive2 at 2^16, minutes on this CPU)
are the slow tier:

    ZK_SLOW=1 python -m pytest -q -m slow tests/test_torch_recursive.py
"""

import dataclasses
import functools
import hashlib

import numpy as np
import pytest
import torch

import test_recursive as jrec
from zkevm_prover_tpu.stark import gl_circuit as jglc
from zkevm_prover_tpu.stark import recursive as jrecursive
from zkevm_prover_tpu.stark.proof import StarkProof as JProof
from zkevm_prover_tpu.stark.setup import StarkSetup as JSetup
from zkevm_prover_tpu_torch.ops import goldilocks as gl
from zkevm_prover_tpu_torch.prover import Prover, PublicInputs
from zkevm_prover_tpu_torch.prover.prover import (RecursiveNode,
                                                  _fea_publics_hex)
from zkevm_prover_tpu_torch.stark import examples
from zkevm_prover_tpu_torch.stark import gl_circuit as glc
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.recursive import (Recursive2Prover,
                                                    RecursiveProver)
from zkevm_prover_tpu_torch.stark.setup import StarkSetup
from zkevm_prover_tpu_torch.stark.verifier import VerifyError, verify

REC_BITS = 13


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU proves run on one thread beside the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# sha256 of the JAX package's proof JSON: the Fibonacci inner proof
# (tests/test_recursive.py `_inner`) and its recursive1 wrap at 2^13
# (`test_recursive1_prove_verify` under ZK_SLOW, 68 min of XLA on the CPU),
# with the wrap's outer verkey; tests/test_torch_cuda.py holds the card's
# recursive1 proof to the same digest
INNER_PIN = "7156c412bf574b0e0996a0f27ae5307748496a250dada427e4ef777973d5b83c"
R1_PIN = "88481fcb3c16047377f4142e56834379635cdff6d058200594e9e49081ec378d"
R1_VERKEY = [5181393508720358174, 4995740246933196767, 6725803576731955069,
             791083831178626511]


@functools.lru_cache(maxsize=None)
def _inner():
    air, tr = examples.fib_air_trace(jrec.N_BITS)
    setup = StarkSetup(air, n_queries=4, fri_fold_bits=2)
    pv = StarkProver(setup, device="cpu")
    proof = pv.prove(tr)
    return setup, pv, proof


@functools.lru_cache(maxsize=None)
def _r1():
    setup, pv, proof = _inner()
    rp = RecursiveProver(setup, n_bits=REC_BITS, n_queries=4, device="cpu")
    s = rp._synth(pv.verkey, proof)
    cc = glc.compile_air(s, REC_BITS)
    opv = StarkProver(StarkSetup(cc.air, n_queries=4, fri_fold_bits=2),
                      device="cpu")
    return rp, s, cc, opv


@functools.lru_cache(maxsize=None)
def _jax_r1():
    """The JAX package's recursive1 circuit of the port's inner proof."""
    _, pv, proof = _inner()
    jsetup = JSetup(jrec._fib_air(), n_queries=4, fri_fold_bits=2)
    jproof = JProof.from_json(proof.to_json())
    rp = jrecursive.RecursiveProver(jsetup, n_bits=REC_BITS, n_queries=4)
    s = rp._synth(np.asarray(pv.verkey), jproof)
    cc = jglc.compile_air(s, REC_BITS)
    return s, cc, JSetup(cc.air, n_queries=4, fri_fold_bits=2)


def test_inner_proof_matches_jax():
    _, pv, proof = _inner()
    assert hashlib.sha256(proof.to_json().encode()).hexdigest() == INNER_PIN


def test_recursive1_circuit_equals_jax():
    _, s, cc, opv = _r1()
    js, jcc, jsetup = _jax_r1()
    assert [dataclasses.astuple(g) for g in s.gates] == \
        [dataclasses.astuple(g) for g in js.gates]
    assert s.hashes == js.hashes
    assert s.publics == js.publics
    assert s.vals == js.vals
    assert glc.rows_needed(s) == jglc.rows_needed(js)
    assert cc.layout == jcc.layout
    assert cc.air.cm_names == jcc.air.cm_names
    assert cc.air.const_names == jcc.air.const_names
    for name, a, b in zip(cc.air.const_names, cc.air.const_values,
                          jcc.air.const_values):
        assert np.array_equal(np.asarray(a, dtype=np.uint64),
                              np.asarray(b, dtype=np.uint64)), name
    assert opv.setup.describe() == jsetup.describe()
    ta, tb = cc.trace(s), jcc.trace(js)
    assert sorted(ta) == sorted(tb)
    for name in ta:
        assert np.array_equal(ta[name], np.asarray(tb[name])), name


def test_verifier_circuit_satisfied():
    _, s, cc, opv = _r1()
    stacked = cc.air.stack_traces(cc.trace(s))
    assert opv.check_constraints(stacked, quick=True) == []
    # the circuit publics are [inner publics..., inner verkey]
    _, pv, proof = _inner()
    pubs = [s.vals[sig] for sig in s.publics]
    assert pubs[0] == int(proof.publics[0])
    assert pubs[1:5] == [int(v) for v in np.ravel(np.asarray(pv.verkey))]


def test_verifier_circuit_rejects_forged_wire():
    _, s, cc, opv = _r1()
    stacked = cc.air.stack_traces(cc.trace(s)).copy()
    stacked[100, 3] = (int(stacked[100, 3]) + 1) % gl.P
    assert opv.check_constraints(stacked, quick=True) != []


def test_verifier_circuit_rejects_forged_hash_claim():
    _, s, cc, opv = _r1()
    traces = cc.trace(s)
    g = traces["gates"].copy()
    base = cc.layout["base"]
    # a Poseidon output lane on the first hash-claim row: the PoseidonG
    # lookup must reject it
    g[base, glc.N_WIRES + 12] = (int(g[base, glc.N_WIRES + 12]) + 1) % gl.P
    traces["gates"] = g
    stacked = cc.air.stack_traces(traces)
    assert opv.check_constraints(stacked, quick=True) != []


def test_bad_inner_proof_has_no_witness():
    """A tampered inner proof cannot even be witnessed: the transcript
    replay diverges and some gate/claim assertion fires."""
    setup, pv, proof = _inner()
    bad = dataclasses.replace(proof, publics=[int(proof.publics[0]) + 1])
    rp = RecursiveProver(setup, n_bits=REC_BITS, n_queries=4, device="cpu")
    with pytest.raises(AssertionError):
        rp._synth(pv.verkey, bad)


def test_recursive_provers_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    setup, _, _ = _inner()
    with pytest.raises(RuntimeError, match="CUDA"):
        RecursiveProver(setup, n_bits=REC_BITS)
    with pytest.raises(RuntimeError, match="CUDA"):
        Recursive2Prover(setup, [0] * 4, n_bits=15,
                         join_publics=lambda a, b: a, chain=[])


class _Outer:
    """Stands in for a RecursiveProver: only its outer prover is read."""

    def __init__(self, outer_prover):
        self.outer_prover = outer_prover


@functools.lru_cache(maxsize=None)
def _outer(tag: int, vk_in_publics: bool = True):
    """A small proof with the recursive nodes' 48 publics (column a's first
    48 rows; 32-bit limbs, and rows 44..47 its own verkey when asked), its
    verkey set apart by `tag`: it stands in for an outer circuit's proof."""
    from zkevm_prover_tpu_torch.stark.air import AIR

    n_bits = 6
    n = 1 << n_bits
    air = AIR("outer", n_bits)
    a, _ = air.committed("a", "b")
    tag_col = np.zeros(n, dtype=np.uint64)
    tag_col[0] = tag
    air.constant("TAG", tag_col)
    p0 = air.public("p0", a, 0)
    for i in range(1, 48):
        air.public(f"p{i}", a, i)
    air.require_zero(air.lagrange_first() * (a - p0))
    pv = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                     device="cpu")
    rng = np.random.default_rng(tag)
    trace = rng.integers(0, 1 << 32, size=(n, 2), dtype=np.uint64)
    if vk_in_publics:
        trace[44:48, 0] = np.ravel(np.asarray(pv.verkey))
    return pv, pv.prove(trace)


def _node(pv, proof, kind):
    pubs = [int(v) for v in proof.publics]
    return RecursiveNode(
        proof=proof, verkey=pv.verkey, kind=kind,
        publics=PublicInputs(old_state_root=_fea_publics_hex(pubs[0:8]),
                             new_state_root=_fea_publics_hex(pubs[19:27])))


def test_verify_recursive_reads_its_own_outer_prover():
    """Each Prover verifies a node against its own outer circuit of the
    node's kind, even after another Prover has made its own."""
    x, x_proof = _outer(1)
    y, y_proof = _outer(2)
    a, b = Prover(n_bits=9, device="cpu"), Prover(n_bits=9, device="cpu")
    with pytest.raises(ValueError, match="no r1 circuit"):
        a.verify_recursive(_node(x, x_proof, "r1"))
    a._r1 = _Outer(x)
    b._r1 = _Outer(y)
    b._r2 = _Outer(x)
    assert a.verify_recursive(_node(x, x_proof, "r1"))
    assert b.verify_recursive(_node(y, y_proof, "r1"))
    assert a.verify_recursive(_node(x, x_proof, "r1"))
    with pytest.raises(VerifyError):
        b.verify_recursive(_node(x, x_proof, "r1"))
    with pytest.raises(ValueError, match="no r2 circuit"):
        a.verify_recursive(_node(x, x_proof, "r2"))
    # an r2 node is read against recursive2's circuit, whose verkey must
    # stand in publics[44:48]
    assert b.verify_recursive(_node(x, x_proof, "r2"))
    z, z_proof = _outer(1, vk_in_publics=False)
    assert np.array_equal(np.asarray(z.verkey), np.asarray(x.verkey))
    b._r2 = _Outer(z)
    assert not b.verify_recursive(_node(z, z_proof, "r2"))
    # a node whose publics do not match its proof's is refused
    node = _node(x, x_proof, "r1")
    node.publics = dataclasses.replace(node.publics,
                                       old_state_root="0x" + "33" * 32)
    assert not a.verify_recursive(node)


@pytest.mark.slow
def test_recursive1_prove_verify():
    setup, pv, proof = _inner()
    rp = RecursiveProver(setup, n_bits=REC_BITS, n_queries=4, device="cpu")
    rec = rp.prove_one(pv.verkey, proof)
    opv = rp.outer_prover
    assert hashlib.sha256(rec.proof.to_json().encode()).hexdigest() == R1_PIN
    assert [int(v) for v in np.ravel(opv.verkey)] == R1_VERKEY
    assert verify(opv.setup, opv.verkey, rec.proof, device="cpu")
    assert [int(v) for v in rec.proof.publics[1:5]] == \
        [int(v) for v in np.ravel(np.asarray(pv.verkey))]


@pytest.mark.slow
def test_recursive2_pair_join():
    setup, pv, proof = _inner()
    rp = RecursiveProver(setup, n_bits=REC_BITS, n_queries=4, device="cpu")
    r1a = rp.prove_one(pv.verkey, proof)
    r1b = rp.prove_one(pv.verkey, proof)
    opv = rp.outer_prover
    # the join's circuit needs 58,758 rows: 2^16, not the JAX test's 2^15
    r2 = Recursive2Prover(
        opv.setup, opv.verkey, n_bits=16,
        join_publics=lambda p1, p2: [p1[0], p2[0]], chain=[], n_queries=4,
        device="cpu")
    outer = r2.prove_pair(r1a.proof, opv.verkey, r1b.proof, opv.verkey)
    o2 = r2.outer_prover
    assert verify(o2.setup, o2.verkey, outer, device="cpu")
    # the vk public carries recursive2's own verkey (the reference's
    # publics[44..47] invariant), the closure point of the tree
    got_vk = [int(v) for v in outer.publics[-4:]]
    assert got_vk == [int(v) for v in np.ravel(np.asarray(o2.verkey))]
