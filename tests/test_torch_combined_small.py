"""The port's small combined batch, `executor.examples.small_rom_batch`
(Main and the co-SMs `combined.default_include(9)` binds, at 2^9), split
from tests/test_torch_combined.py so that the two run on separate test
workers: its traces, actions, counters and AIR equal the JAX package's on
the same ROM JSON, input and pre-state; it satisfies the AIR; and its one
proof of the module, made through the entry point's ROM path, hashes to a
digest pinned from the JAX package's proof, verifies under the AIR built
here, carries the executor's roots in its publics, and is rejected when
tampered with.

The ROM path: `Prover.gen_batch_proof` of a `ProofInput` holding the
batch's pre-state nodes and no actions, with the batch's ROM written by
`Rom.to_json` as fork 9's rom.json of a temporary reference checkout
named by $ZKEVM_REFERENCE_ROOT. It proves the combined AIR and then
rejects the proof: the ROM ends with C = 0, so its newAccInputHash public
is not the keccak recurrence of the input, and the recurrence check of
the JAX package's `_gen_batch_proof_rom` raises alike (the JAX side is a
slow test). The slow tests recompute the JAX proof and the JAX ROM path
(about an hour of XLA compile and prove each on one CPU):

    ZK_SLOW=1 python -m pytest -q -m slow tests/test_torch_combined_small.py
"""

import functools
import hashlib
import importlib
import json
import os

import numpy as np
import pytest
import torch

from test_torch_combined import assert_airs_equal
from test_torch_main_sm import actions_of, plain
from zkevm_prover_tpu.executor import combined as jcombined
from zkevm_prover_tpu.executor import forks as jforks
from zkevm_prover_tpu.executor.rom import Rom as JRom
from zkevm_prover_tpu.hashdb.database import Database as JDatabase
from zkevm_prover_tpu.hashdb.smt import Smt as JSmt
from zkevm_prover_tpu.prover import ProofInput as JInput
from zkevm_prover_tpu.prover import Prover as JProver
from zkevm_prover_tpu.prover import PublicInputs as JPublics
from zkevm_prover_tpu.stark.prover import StarkProver as JStarkProver
from zkevm_prover_tpu.stark.setup import StarkSetup as JSetup
from zkevm_prover_tpu_torch.executor import combined, examples, forks
from zkevm_prover_tpu_torch.executor.sm import main_sm
from zkevm_prover_tpu_torch.hashdb import Database, Smt
from zkevm_prover_tpu_torch.prover import ProofInput, Prover, PublicInputs
from zkevm_prover_tpu_torch.stark.proof import StarkProof
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.setup import StarkSetup
from zkevm_prover_tpu_torch.stark.verifier import VerifyError, verify

# sha256 of the proof JSON of examples.small_rom_batch's combined AIR at
# 2^9, from the JAX package's StarkProver on the same ROM JSON, input and
# pre-state (the slow test recomputes it)
SMALL_PIN = \
    "be7127af2712c058c71c0c7e81f127d600211fc476bd49ad964c2224e3b85559"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's intra-op pool slows down by orders of magnitude beside the
    other test workers: the port's CPU proves run on one thread (module
    scope, for the module's one proof)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the slice's small batch: examples.small_rom_batch proved in one STARK
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _small():
    db, tree, batch = examples.small_rom_batch("cpu")
    res, traces = combined.execute_batch(
        batch.rom, batch.n_bits, input=batch.input, smt=Smt(db),
        include=batch.include, device="cpu")
    air = combined.build_batch_air(batch.rom, batch.n_bits,
                                   include=batch.include)
    prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device="cpu")
    return tree, batch, res, traces, prover


def _rom_input(port: bool):
    """small_rom_batch's ROM and a ProofInput of its input and pre-state:
    the old root, chain and fork ids in the publics, the tree's nodes in
    `db` and no actions (so gen_batch_proof takes the ROM path)."""
    db, tree, batch = examples.small_rom_batch("cpu")
    osr = sum(int(v) << (64 * i) for i, v in enumerate(tree.root))
    pub = (PublicInputs if port else JPublics)(
        old_state_root="0x" + osr.to_bytes(32, "big").hex(),
        chain_id=examples.CHAIN_ID, fork_id=examples.FORK_ID)
    nodes = {tuple(int(k[16 * i:16 * i + 16], 16) for i in range(4)): v
             for k, v in db._nodes.items()}
    return batch, (ProofInput if port else JInput)(publics=pub, db=nodes)


def _reference_checkout(root, rom) -> str:
    """`rom` as fork 9's rom.json of a reference checkout at `root`;
    returns the JSON text."""
    text = json.dumps(rom.to_json())
    path = root / "src" / "main_sm" / "fork_9" / "scripts" / "rom.json"
    path.parent.mkdir(parents=True)
    path.write_text(text)
    return text


@pytest.fixture(scope="module")
def rom_path(one_torch_thread, tmp_path_factory):
    """The module's one proof: gen_batch_proof's ROM path over the small
    batch, under a temporary $ZKEVM_REFERENCE_ROOT (`forks` re-read with
    it, and again without it afterwards). Returns the input, the proofs
    its StarkProver made and the error the recurrence check raised."""
    batch, inp = _rom_input(True)
    root = tmp_path_factory.mktemp("reference")
    _reference_checkout(root, batch.rom)
    proofs = []
    prove = StarkProver.prove

    def keep(self, *args, **kw):
        proofs.append(prove(self, *args, **kw))
        return proofs[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZKEVM_REFERENCE_ROOT", str(root))
        mp.setattr(StarkProver, "prove", keep)
        importlib.reload(forks)
        try:
            assert forks.supported_forks() == [9]
            with pytest.raises(RuntimeError) as err:
                Prover(rom_bits=9, device="cpu").gen_batch_proof(inp)
        finally:
            mp.undo()
            importlib.reload(forks)
    return inp, proofs, err.value


def _recurrence_error(inp) -> str:
    return (f"proof newAccInputHash 0x{'00' * 32} != recurrence "
            f"{inp.publics.acc_input_hash()}")


def _jax_small():
    """The JAX package's run of the same ROM JSON, input and pre-state
    (the tree's keys and values set one by one into a JAX Smt)."""
    tree, batch, _, _, _ = _small()
    jrom = JRom.from_json(json.loads(json.dumps(batch.rom.to_json())))
    jsmt = JSmt(JDatabase())
    r = (0, 0, 0, 0)
    for key, value in zip(tree.keys.tolist(), tree.values):
        r = jsmt.set(r, tuple(key), value).new_root
    assert tuple(r) == tree.root
    res, traces = jcombined.execute_batch(jrom, batch.n_bits,
                                          input=batch.input, smt=jsmt,
                                          include=batch.include)
    air = jcombined.build_batch_air(jrom, batch.n_bits,
                                    include=batch.include)
    return res, traces, air


def test_small_rom_batch_shape():
    """The generator's closing counter and fills, as the batch ran."""
    _, batch, res, traces, _ = _small()
    assert batch.include == combined.default_include(9)
    assert batch.closed_by in batch.fill
    used, cap = batch.fill[batch.closed_by]
    assert used <= cap
    assert batch.fill["arith"][0] == len(res.actions.arith)
    assert batch.fill["memory"][0] == len(res.actions.memory)
    assert batch.fill["mem_align"][0] == len(res.actions.mem_align) == 3
    assert [a["op"] for a in res.actions.mem_align] == ["rd", "wr", "wr8"]
    # execute_batch appended the storage walk's hashes and climbs
    assert batch.fill["poseidon_g"][0] == len(res.actions.poseidon_g)
    assert batch.fill["climb_key"][0] == len(res.actions.climb_key)
    assert res.counters["arith"] == batch.ops["arith"]
    assert res.counters["binary"] == batch.ops["binary"]
    assert traces["main"].shape == (512, len(main_sm.columns(9)))


def test_small_rom_batch_matches_jax():
    """Traces, actions, counters and the AIR of the small batch equal the
    JAX package's on the same ROM JSON, input and pre-state."""
    _, batch, res, traces, prover = _small()
    jres, jtraces, jair = _jax_small()
    assert list(traces) == list(jtraces)
    for name in traces:
        np.testing.assert_array_equal(traces[name],
                                      np.asarray(jtraces[name]),
                                      err_msg=name)
    assert actions_of(res) == actions_of(jres)
    assert res.counters == jres.counters
    assert plain(res.new_state_root) == plain(jres.new_state_root)
    assert_airs_equal(combined.build_batch_air(
        batch.rom, batch.n_bits, include=batch.include), jair)


def test_small_rom_batch_satisfied():
    _, _, _, traces, prover = _small()
    assert prover.check_constraints(
        prover.setup.air.stack_traces(traces), quick=True) == []


def test_small_rom_batch_proof_matches_pin(rom_path):
    _, proofs, _ = rom_path
    assert len(proofs) == 1
    digest = hashlib.sha256(proofs[0].to_json().encode()).hexdigest()
    assert digest == SMALL_PIN


def test_rom_path_rejects_the_recurrence(rom_path):
    """The ROM path's recurrence check: the proof's newAccInputHash public
    (C in the last row, 0) is not the keccak recurrence of the input."""
    inp, _, err = rom_path
    assert str(err) == _recurrence_error(inp)


def test_small_rom_batch_verifies_and_publics(rom_path):
    """verify accepts (under the AIR and setup built here); the chaining
    publics read out of the proof (as `Prover._gen_batch_proof_rom` reads
    them) are the executor's: the old root the batch started from and the
    new root it wrote."""
    tree, batch, res, _, prover = _small()
    proof = rom_path[1][0]
    assert verify(prover.setup, prover.verkey, proof, device="cpu")
    pv = [int(x) for x in proof.publics]
    assert main_sm._fea8_to_fe4(pv[0:8]) == tree.root
    assert main_sm._fea8_to_fe4(pv[19:27]) == res.new_state_root
    assert res.new_state_root != tree.root
    assert pv[17] == examples.CHAIN_ID and pv[18] == examples.FORK_ID


def test_small_rom_batch_tampered_proof_rejected(rom_path):
    _, _, _, _, prover = _small()
    bad = StarkProof.from_json(rom_path[1][0].to_json())
    bad.fri[0].queries[0][0].values[0] += 1
    with pytest.raises(VerifyError):
        verify(prover.setup, prover.verkey, bad, device="cpu")


@pytest.mark.slow
def test_jax_small_rom_batch_proof_matches_pin():
    _, traces, air = _jax_small()
    prover = JStarkProver(JSetup(air, n_queries=8, fri_fold_bits=2))
    proof = prover.prove(air.stack_traces(traces))
    assert hashlib.sha256(proof.to_json().encode()).hexdigest() == SMALL_PIN


@pytest.mark.slow
def test_jax_rom_path_rejects_the_recurrence_alike(tmp_path, monkeypatch):
    """The JAX package's ROM path on the same ROM JSON and input raises the
    same error (its fork ROM from the same rom.json text)."""
    batch, jinp = _rom_input(False)
    text = _reference_checkout(tmp_path, batch.rom)
    monkeypatch.setitem(jforks._CACHE, 9, JRom.from_json(json.loads(text)))
    with pytest.raises(RuntimeError) as err:
        JProver(rom_bits=9).gen_batch_proof(jinp)
    assert str(err.value) == _recurrence_error(jinp)


# ---------------------------------------------------------------------------
# the spine gate (tests/test_spine_e2e.py): the fork-9 ROM over the e2e
# vector, which needs the reference tree
# ---------------------------------------------------------------------------

_SPINE_VECTOR = os.path.join(os.path.dirname(os.path.dirname(
    jforks.REFERENCE_ROOT)), "testvectors", "e2e", "fork_9",
    "input_executor_0.json")


@pytest.mark.skipif(not os.path.exists(jforks.rom_path(9)),
                    reason="reference tree not mounted")
def test_spine_traces_match_jax_and_satisfy():
    from zkevm_prover_tpu.prover.input import ProofInput

    inp = ProofInput.from_file(_SPINE_VECTOR)
    jdb = JDatabase()
    inp.seed_database(jdb)
    db = Database()
    db._nodes.update(jdb._nodes)
    db._programs.update(jdb._programs)
    include = combined.default_include(14)
    rom = forks.rom_for_fork(9, jforks.REFERENCE_ROOT)
    res, traces = combined.execute_batch(
        rom, 14, input=inp.executor_input(), smt=Smt(db), include=include,
        device="cpu")
    jres, jtraces = jcombined.execute_batch(
        jforks.rom_for_fork(9), 14, input=inp.executor_input(),
        smt=JSmt(jdb), include=include)
    for name in jtraces:
        np.testing.assert_array_equal(traces[name],
                                      np.asarray(jtraces[name]))
    air = combined.build_batch_air(rom, 14, include=include)
    prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device="cpu")
    assert prover.check_constraints(air.stack_traces(traces),
                                    quick=True) == []
