"""The port's Main SM (`executor/sm/main_sm.py`) against the JAX package's,
on every ROM body of tests/test_main_sm.py that runs without the
reference tree (built in test_torch_rom.py): the trace bit for bit
(uint64), the emitted actions, the counters and the new state root; the
ROM table and the AIR (column and constant names and values, constraints,
lookups, publics); and `check_constraints(quick=True)` of the Main AIR,
empty on the honest trace and equal to the JAX package's list on each
tampered trace of test_main_sm.py."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_rom import build
from zkevm_prover_tpu.executor.sm import main_sm as jmain
from zkevm_prover_tpu.hashdb.database import Database as JDatabase
from zkevm_prover_tpu.hashdb.smt import Smt as JSmt
from zkevm_prover_tpu.stark.prover import StarkProver as JProver
from zkevm_prover_tpu.stark.setup import StarkSetup as JSetup
from zkevm_prover_tpu_torch.executor.sm import main_sm
from zkevm_prover_tpu_torch.hashdb import Database, Smt
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.setup import StarkSetup

N_BITS = 9

# test_main_sm.py's bodies :47-:218 (all but the rom.json loader, which
# needs the reference tree); storage_srd_swr runs over an empty tree
RUN_BODIES = ("selectors_setters_assert", "constl_and_rotl_c",
              "jumps_call_return_repeat",
              "free_input_command_and_memory_ops", "storage_srd_swr",
              "hash_keccak_pipeline", "binary_and_arith_actions",
              "arith_ec_ops", "air_program")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's intra-op pool slows down by orders of magnitude beside the
    other test workers: the port's CPU checks run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def plain(v):
    """Actions and counters as plain Python values (tuples for sequences,
    ints for integers), so both packages' outputs compare with ==."""
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, np.ndarray)):
        return tuple(plain(x) for x in v)
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return v


def actions_of(res) -> dict:
    return {f.name: plain(getattr(res.actions, f.name))
            for f in dataclasses.fields(res.actions)}


@functools.lru_cache(maxsize=None)
def _run(name: str):
    """(port result, JAX result) of body `name` at 2^9."""
    smts = (Smt(Database()), JSmt(JDatabase())) \
        if name == "storage_srd_swr" else (None, None)
    port = main_sm.MainExecutor(build(name), N_BITS).execute(smt=smts[0])
    jax_ = jmain.MainExecutor(build(name, port=False), N_BITS).execute(
        smt=smts[1])
    return port, jax_


@pytest.mark.parametrize("name", RUN_BODIES)
def test_trace_actions_counters_match_jax(name):
    port, jax_ = _run(name)
    assert port.trace.dtype == np.uint64
    np.testing.assert_array_equal(port.trace, np.asarray(jax_.trace))
    assert actions_of(port) == actions_of(jax_)
    assert port.counters == jax_.counters
    assert plain(port.new_state_root) == plain(jax_.new_state_root)
    assert port.last_step == jax_.last_step
    assert port.logs == jax_.logs


def test_semantics_as_test_main_sm_checks():
    """A few of test_main_sm.py's own readings, on the port's traces."""
    cols = main_sm.columns(N_BITS)

    def col(res, nm):
        return res.trace[:, cols.index(nm)]

    res, _ = _run("selectors_setters_assert")
    assert col(res, "C0")[3] == 12 and col(res, "D0")[6] == 7
    res, _ = _run("jumps_call_return_repeat")
    assert not (col(res, "E0") == 999).any()
    assert (col(res, "A0") == 206).any()
    res, _ = _run("binary_and_arith_actions")
    assert res.actions.arith == [{"op": "mul", "x1": 3, "y1": 5, "x2": 1}]
    assert res.counters["binary"] == 1 and res.counters["arith"] == 1
    res, _ = _run("storage_srd_swr")
    st = res.actions.storage
    assert [a["op"] for a in st] == ["set", "get"]
    assert res.new_state_root == st[0]["new_root"]
    direct = Smt(Database()).set((0, 0, 0, 0), st[0]["key"], 777)
    assert direct.new_root == st[0]["new_root"]


def test_failing_assert_raises_in_both():
    with pytest.raises(main_sm.ExecutorError, match="ASSERT"):
        main_sm.MainExecutor(build("failing_assert"), N_BITS).execute()
    with pytest.raises(jmain.ExecutorError, match="ASSERT"):
        jmain.MainExecutor(build("failing_assert", port=False),
                           N_BITS).execute()


@pytest.mark.parametrize("n_bits", [9, 13, 17])
def test_columns_match_jax(n_bits):
    assert main_sm.columns(n_bits) == jmain.columns(n_bits)


def test_rom_table_matches_jax():
    tt = main_sm.rom_table(build("air_program"), 1 << N_BITS)
    jt = jmain.rom_table(build("air_program", port=False), 1 << N_BITS)
    assert list(tt) == list(jt)
    for k in tt:
        np.testing.assert_array_equal(tt[k], np.asarray(jt[k]))


def test_build_air_matches_jax():
    ta = main_sm.build_air(build("air_program"), N_BITS)
    ja = jmain.build_air(build("air_program", port=False), N_BITS)
    assert ta.cm_names == ja.cm_names
    assert ta.const_names == ja.const_names
    for tv, jv in zip(ta.const_values, ja.const_values):
        np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv))
    assert ta.publics == ja.publics
    assert [repr(c) for c in ta.constraints] \
        == [repr(c) for c in ja.constraints]
    assert [(repr(lk.f), repr(lk.t), repr(lk.sel_f), repr(lk.sel_t))
            for lk in ta.lookups] \
        == [(repr(lk.f), repr(lk.t), repr(lk.sel_f), repr(lk.sel_t))
            for lk in ja.lookups]


@functools.lru_cache(maxsize=None)
def _provers():
    port = StarkProver(StarkSetup(main_sm.build_air(build("air_program"),
                                                    N_BITS),
                                  n_queries=8, fri_fold_bits=2),
                       device="cpu")
    jax_ = JProver(JSetup(jmain.build_air(build("air_program", port=False),
                                          N_BITS),
                          n_queries=8, fri_fold_bits=2))
    return port, jax_


def _tampered(kind: str) -> np.ndarray:
    """test_main_sm.py's three tampered traces of the AIR program."""
    res, _ = _run("air_program")
    cols = main_sm.columns(N_BITS)
    t = res.trace.copy()
    if kind == "register":     # C gets 13 instead of 12
        t[3:, cols.index("C0")] = np.uint64(13)
    elif kind == "jump":       # JMPN pretends not to take the branch
        r = int(np.argmax(t[:, cols.index("JMPN")]
                          * t[:, cols.index("ISNEG")]))
        t[r, cols.index("ISNEG")] = np.uint64(0)
        t[r, cols.index("DOJMP")] = np.uint64(0)
    elif kind == "selector":   # an instruction that is not in the ROM
        t[2, cols.index("inB")] = np.uint64(0)
        t[2, cols.index("OP0")] = np.uint64(7)
        t[3:, cols.index("C0")] = np.uint64(7)
    return t


def test_main_air_satisfied():
    res, _ = _run("air_program")
    port, jax_ = _provers()
    assert port.check_constraints(res.trace, quick=True) == []
    assert jax_.check_constraints(res.trace, quick=True) == []


@pytest.mark.parametrize("kind", ["register", "jump", "selector"])
def test_main_air_tampering_lists_match_jax(kind):
    t = _tampered(kind)
    port, jax_ = _provers()
    bad = port.check_constraints(t, quick=True)
    assert bad != []
    assert bad == jax_.check_constraints(t, quick=True)
    if kind == "selector":
        assert any(str(b).startswith("plookup") for b in bad)
