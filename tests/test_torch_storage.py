"""The port's Storage SM, `StarkProver.check_constraints` and the storage
batch fixtures against the JAX package, bit for bit: the trace and the
emitted PoseidonG / ClimbKey lists of `storage.execute`, the violated
constraint lists on honest and forged traces, the root of `state_tree`,
and the 2^9 storage batch proved through the port's `Executor.prove_all`
on the CPU, each proof's JSON hashed to a digest pinned from the JAX
package's `Executor.prove_all` on the same actions. The slow test
recomputes those JAX proofs (minutes of XLA compile):

    ZK_SLOW=1 python -m pytest -q -m slow tests/test_torch_storage.py
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

from zkevm_prover_tpu.executor.sm import storage as jstorage
from zkevm_prover_tpu.hashdb.database import Database as JDatabase
from zkevm_prover_tpu.hashdb.smt import Smt as JSmt
from zkevm_prover_tpu.stark.prover import StarkProver as JProver
from zkevm_prover_tpu.stark.setup import StarkSetup as JSetup
from zkevm_prover_tpu_torch.executor import BatchActions, Executor, examples
from zkevm_prover_tpu_torch.executor.sm import climb_key, storage
from zkevm_prover_tpu_torch.hashdb import Database, Smt
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.setup import StarkSetup

N_BITS = 9
ZERO = (0, 0, 0, 0)

# the keys of the JAX package's tests/test_storage_sm.py: KEY1 and KEY2
# share low bits (insertFound path extension), KEY1 is updated, KEY2 read
# and deleted (leaf collapse), (9, 9, 9, 9) missed
KEY1 = (0b1010, 3, 5, 7)
KEY2 = (0b1010, 3, 5, 23)
KEY3 = (1, 1, 1, 1)

# sha256 of each SM's proof JSON, from the JAX package's
# Executor().prove_all on examples.small_storage_batch() (default sizes)
PINS = {
    "storage":
        "2d2e882842f2e0d9707f643c3a77b89a63ffc7b0c7ab8654dce6bbf4c1a4c353",
    "poseidon_g":
        "d7308821029115e7d12f1d4a9bb01372aa232a209031f90894c8d3c584845b2e",
    "climb_key":
        "eb60595f57a80a1675a13d83ce08d5eba9e0629636d050e80293ef5d33406ecb",
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU proves run on one thread: torch's intra-op pool slows
    down by orders of magnitude beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _actions(smt_cls, db_cls):
    """test_storage_sm's action stream over a fresh tree: four sets, a get
    that finds, a get that misses, and a delete that collapses."""
    smt = smt_cls(db_cls())
    acts, r = [], ZERO
    for key, val in ((KEY1, 111), (KEY2, 222), (KEY3, 333), (KEY1, 444)):
        res = smt.set(r, key, val)
        acts.append({"op": "set", "root": r, "key": key, "value": val,
                     "new_root": res.new_root})
        r = res.new_root
    for key in (KEY2, (9, 9, 9, 9)):
        acts.append({"op": "get", "root": r, "key": key,
                     "value": smt.get(r, key).value})
    acts.append({"op": "set", "root": r, "key": KEY2, "value": 0,
                 "new_root": smt.set(r, KEY2, 0).new_root})
    return smt, acts


@functools.lru_cache(maxsize=None)
def _traces():
    smt, acts = _actions(Smt, Database)
    jsmt, jacts = _actions(JSmt, JDatabase)
    assert acts == jacts
    return (storage.execute(acts, N_BITS, smt.db),
            jstorage.execute(jacts, N_BITS, jsmt.db))


@functools.lru_cache(maxsize=None)
def _provers():
    return (StarkProver(StarkSetup(storage.build_air(N_BITS), n_queries=8,
                                   fri_fold_bits=2), device="cpu"),
            JProver(JSetup(jstorage.build_air(N_BITS), n_queries=8,
                           fri_fold_bits=2)))


def test_columns_and_air_match_jax():
    assert storage.COLS == jstorage.COLS
    air, jair = storage.build_air(N_BITS), jstorage.build_air(N_BITS)
    assert air.n_cm1 == jair.n_cm1
    assert [repr(c) for c in air.constraints] == [repr(c) for c in
                                                  jair.constraints]


def test_trace_and_emitted_match_jax():
    (trace, emitted), (jtrace, jemitted) = _traces()
    np.testing.assert_array_equal(trace, jtrace)
    assert emitted == jemitted
    assert emitted["poseidon_g"] and emitted["climb_key"]


def test_emitted_climbs_stay_below_the_prime():
    """The emitted ClimbKey actions carry the remaining keys of real
    field-element keys: ClimbKey's own no-wrap check takes every one."""
    (_, emitted), _ = _traces()
    for act in emitted["climb_key"]:
        lane = act["level"] % 4
        assert act["key"][lane] <= climb_key.LIMIT_BEFORE_CLIMB - act["bit"]
    climb_key.execute(emitted["climb_key"], 12)


def test_hash_count_matches_jax():
    smt, acts = _actions(Smt, Database)
    jsmt, jacts = _actions(JSmt, JDatabase)
    counts = [storage.hash_count(a, smt.db) for a in acts]
    assert counts == [jstorage.hash_count(a, jsmt.db) for a in jacts]
    (_, emitted), _ = _traces()
    assert sum(counts) == len(emitted["poseidon_g"])


def _forge(trace, how):
    """test_storage_rejects_tampering's forgeries of an honest trace."""
    ci = {nm: i for i, nm in enumerate(storage.COLS)}
    t = trace.copy()
    rows = np.nonzero((t[:-1, ci["OACT"]] == 1) & (t[:-1, ci["LAST"]] == 0)
                      & (t[1:, ci["OACT"]] == 1))[0]
    r = int(rows[0])
    if how == "child_hash":
        side = "OR0" if t[r, ci["BIT"]] else "OL0"
        t[r, ci[side]] = (int(t[r, ci[side]]) + 1) % storage.P
    elif how == "remaining_key":
        t[r, ci["RKEY0"]] = (int(t[r, ci["RKEY0"]]) + 1) % storage.P
    elif how == "chain":
        chain_rows = np.nonzero(t[:, ci["CHAIN"]] == 1)[0]
        t[int(chain_rows[0]), ci["NROOT0"]] = np.uint64(12345)
    return t


@pytest.mark.parametrize("how", ["honest", "child_hash", "remaining_key",
                                 "chain"])
def test_check_constraints_matches_jax(how):
    (trace, _), _ = _traces()
    t = _forge(trace, how)
    prover, jprover = _provers()
    bad = prover.check_constraints(t, quick=True)
    assert bad == jprover.check_constraints(t, quick=True)
    assert (bad == []) == (how == "honest")


def test_check_constraints_reports_lookups_as_jax():
    """A ClimbKey trace whose chunk leaves its transition table: the
    violated list is held against the JAX package's, `plookup:` entries
    included."""
    from zkevm_prover_tpu.executor.sm import climb_key as jclimb_key

    acts = [{"key": [5, 7, 9, 11], "level": lvl, "bit": lvl & 1}
            for lvl in range(6)]
    trace = climb_key.execute(acts, 10)
    t = trace.copy()
    t[3, 6] = np.uint64(1 << 40)   # KIC out of its chunk table
    prover = StarkProver(StarkSetup(climb_key.build_air(10), n_queries=8,
                                    fri_fold_bits=2), device="cpu")
    jprover = JProver(JSetup(jclimb_key.build_air(10), n_queries=8,
                             fri_fold_bits=2))
    for tr in (trace, t):
        bad = prover.check_constraints(tr, quick=True)
        assert bad == jprover.check_constraints(tr, quick=True)
    assert any(str(b).startswith("plookup:") for b in bad)


@pytest.mark.parametrize("name", ["fibonacci", "lookup", "permutation",
                                  "connection"])
def test_check_constraints_with_the_transcript(name):
    """quick=False draws the challenges from the transcript, as a prove
    does (after the LDE and commits of stages 1 and 2): an honest toy trace
    satisfies every constraint, and a forged one breaks the same ones as
    under the fixed challenges."""
    from zkevm_prover_tpu_torch.stark import examples as toy

    air, trace = toy.all_air_traces()[name]
    prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device="cpu")
    assert prover.check_constraints(trace) == []
    bad = trace.copy()
    bad[5, 0] = np.uint64(int(bad[5, 0]) + 1)
    assert prover.check_constraints(bad) == prover.check_constraints(
        bad, quick=True) != []


@pytest.mark.parametrize("name", ["fibonacci", "lookup", "permutation",
                                  "connection"])
def test_transcript_challenges_are_the_proofs(name):
    """The challenges 0-3 that check_constraints(quick=False) evaluates
    under are the ones the proof's transcript gives: replayed with the JAX
    package's transcript from the verkey, the publics and the stage-1 and
    stage-2 roots of the port's proof of the same trace."""
    from zkevm_prover_tpu.ops.transcript import Transcript as JTranscript
    from zkevm_prover_tpu_torch.ops import goldilocks as gl
    from zkevm_prover_tpu_torch.stark import examples as toy

    air, trace = toy.all_air_traces()[name]
    prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device="cpu")
    proof = prover.prove(trace)
    publics = [int(trace[row, cid]) for (_, cid, row) in air.publics]
    cm1_n = gl.from_u64(np.asarray(trace, dtype=np.uint64), prover.device)
    publics_dev = gl.from_u64(np.array(publics, dtype=np.uint64),
                              prover.device)
    challenges = prover._stages_1_2(cm1_n, publics, publics_dev)[1]
    t = JTranscript()
    t.put([int(v) for v in np.ravel(prover.verkey)])
    t.put(publics)
    want = []
    for root in proof.roots[:2]:
        t.put([int(v) for v in np.ravel(root)])
        want += [t.get_field3(), t.get_field3()]
    np.testing.assert_array_equal(challenges[:4],
                                  np.array(want, dtype=np.uint64))


def test_state_tree_matches_sequential_jax_sets():
    db = Database()
    tree = examples.state_tree(db, 64, 11, "cpu")
    jsmt = JSmt(JDatabase())
    root = ZERO
    for key, value in zip(tree.keys.tolist(), tree.values):
        root = jsmt.set(root, tuple(key), value).new_root
    assert tuple(root) == tree.root
    smt = Smt(db)
    for key, value in zip(tree.keys.tolist()[:8], tree.values):
        assert smt.get(tree.root, tuple(key)).value == value
    assert smt.get(tree.root, (1, 2, 3, 4)).value == 0
    assert len(db) == tree.nodes


def test_storage_batch_chains_and_closes_on_capacity():
    db = Database()
    tree = examples.state_tree(db, 32, 3, "cpu")
    smt = Smt(db)
    acts, rows = examples.storage_batch(smt, tree.root, 5, 200)
    assert acts[0]["root"] == tree.root
    for a, b in zip(acts, acts[1:]):
        assert b["root"] == a.get("new_root", a["root"])
    used = sum(storage.hash_count(a, db) for a in acts)
    assert used <= 200
    trace, emitted = storage.execute(acts, 12, db)
    assert len(emitted["poseidon_g"]) == used
    assert int(trace[:, storage.COLS.index("LAST")][:rows].sum()) == len(acts)
    assert trace[rows:, storage.COLS.index("LAST")].all()


@functools.lru_cache(maxsize=None)
def _port_batch():
    db, acts = examples.small_storage_batch("cpu")
    ex = Executor(device="cpu")
    return ex, ex.prove_all(BatchActions(storage=acts), db=db)


def proof_digests(proofs: dict) -> dict:
    return {name: hashlib.sha256(proof.to_json().encode()).hexdigest()
            for name, (_, proof) in proofs.items()}


def test_storage_batch_proofs_match_pins():
    _, proofs = _port_batch()
    assert proof_digests(proofs) == PINS


@pytest.mark.slow
def test_jax_storage_batch_proofs_match_pins():
    from zkevm_prover_tpu.executor import BatchActions as JActions
    from zkevm_prover_tpu.executor import Executor as JExecutor

    from zkevm_prover_tpu.stark.proof import StarkProof as JProof
    from zkevm_prover_tpu.stark.verifier import verify as jverify
    from zkevm_prover_tpu_torch.stark.proof import StarkProof
    from zkevm_prover_tpu_torch.stark.verifier import verify

    db, acts = examples.small_storage_batch("cpu")
    jproofs = JExecutor().prove_all(JActions(storage=acts), db=db)
    assert proof_digests(jproofs) == PINS
    _, proofs = _port_batch()
    for name, (jp, jproof) in jproofs.items():
        tp, tproof = proofs[name]
        np.testing.assert_array_equal(tp.verkey, jp.verkey)
        assert verify(tp.setup, tp.verkey,
                      StarkProof.from_json(jproof.to_json()), device="cpu")
        assert jverify(jp.setup, jp.verkey, JProof.from_json(tproof.to_json()))
