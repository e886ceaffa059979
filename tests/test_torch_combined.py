"""The port's combined batch AIR (`executor/combined.py`, `stark/compose.py`)
against the JAX package's, on the JAX tests' ROMs and sizes
(tests/test_combined_air.py at 2^9, tests/test_hash_pipeline.py at 2^13
and 2^11 with the reduced-round circuits): `execute_batch` traces bit for
bit, `build_batch_air` names, constants, publics, constraints, lookups and
permutations, and the `check_constraints(quick=True)` lists on the
satisfied traces and on every forgery of those tests. Also the twin of
tests/test_storage_sm.py's storage/ClimbKey binding (no JAX), the
ecrecover twins of tests/test_misc_components.py, hashp actions through
the `Executor`, and `examples.small_rom_batch`: its combined proof at 2^9
on the CPU, whose JSON hashes to a digest pinned from the JAX package's
proof of the same ROM JSON, input and tree. The slow test recomputes that
JAX proof (about an hour of XLA compile and prove on one CPU):

    ZK_SLOW=1 python -m pytest -q -m slow tests/test_torch_combined.py
"""

import functools
import hashlib
import json
import os
import random

import numpy as np
import pytest
import torch

from test_torch_main_sm import actions_of, plain
from test_torch_rom import build
from zkevm_prover_tpu.executor import Executor as JExecutor
from zkevm_prover_tpu.executor import BatchActions as JActions
from zkevm_prover_tpu.executor import combined as jcombined
from zkevm_prover_tpu.executor import forks as jforks
from zkevm_prover_tpu.executor.rom import Rom as JRom
from zkevm_prover_tpu.executor.sm import keccak_circuit as jkc
from zkevm_prover_tpu.executor.sm import sha256_circuit as jsc
from zkevm_prover_tpu.hashdb.database import Database as JDatabase
from zkevm_prover_tpu.hashdb.smt import Smt as JSmt
from zkevm_prover_tpu.ops import ecrecover as jecr
from zkevm_prover_tpu.stark.prover import StarkProver as JProver
from zkevm_prover_tpu.stark.setup import StarkSetup as JSetup
from zkevm_prover_tpu_torch.executor import BatchActions, Executor
from zkevm_prover_tpu_torch.executor import combined, examples, forks
from zkevm_prover_tpu_torch.executor.sm import (arith, climb_key,
                                                hash_bit, keccak_circuit,
                                                main_sm, mem_align, memory,
                                                padding_kk, padding_pg_byte,
                                                padding_sha256,
                                                sha256_circuit, storage)
from zkevm_prover_tpu_torch.hashdb import Database, Smt
from zkevm_prover_tpu_torch.ops import ecrecover as ecr
from zkevm_prover_tpu_torch.ops import keccak, poseidon_constants, refmodel
from zkevm_prover_tpu_torch.ops import sha256 as sha_mod
from zkevm_prover_tpu_torch.stark.compose import CombinedAIR
from zkevm_prover_tpu_torch.stark.proof import StarkProof
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.setup import StarkSetup
from zkevm_prover_tpu_torch.stark.verifier import VerifyError, verify

# the JAX tests' cases: ROM body (test_torch_rom.py), include, log2 rows and
# the hash pipeline's circuit (rounds, pack, limb bits)
CASES = {
    "memory_binary": ("combined_mb", ("memory", "binary"), 9, None),
    "mem_align": ("combined_ma", ("mem_align",), 9, None),
    "arith": ("combined_ar", ("arith",), 9, None),
    "storage": ("combined_storage", ("storage", "poseidon_g", "climb_key"),
                9, None),
    "keccak": ("hash_keccak", ("keccak",), 13, (1, 4, 2)),
    "sha256": ("hash_sha", ("sha256",), 13, (1, 4, 2)),
    "padding_pg": ("hash_pg", ("padding_pg",), 11, None),
}

# sha256 of the proof JSON of examples.small_rom_batch's combined AIR at
# 2^9, from the JAX package's StarkProver on the same ROM JSON, input and
# pre-state (the slow test recomputes it)
SMALL_PIN = \
    "be7127af2712c058c71c0c7e81f127d600211fc476bd49ad964c2224e3b85559"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's intra-op pool slows down by orders of magnitude beside the
    other test workers: the port's CPU proves run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(case: str, port: bool) -> dict:
    _, include, _, circ = CASES[case]
    if circ is None:
        return {}
    rounds, pack, limb_bits = circ
    if "keccak" in include:
        mod = keccak_circuit if port else jkc
        cfg = (combined if port else jcombined).keccak_pipeline_cfg(
            mod.build(rounds), pack, limb_bits)
        return {"keccak_cfg": cfg}
    mod = sha256_circuit if port else jsc
    cfg = (combined if port else jcombined).keccak_pipeline_cfg(
        mod.build(rounds), pack, limb_bits)
    return {"sha256_cfg": cfg}


@functools.lru_cache(maxsize=None)
def _case(case: str):
    """Both packages' ROM, execute_batch result and traces, AIR and
    prover for one case (the port's on the CPU)."""
    body, include, n_bits, _ = CASES[case]
    out = {}
    for port in (True, False):
        pkg = combined if port else jcombined
        rom = build(body, port=port)
        smt = None
        if "storage" in include:
            smt = Smt(Database()) if port else JSmt(JDatabase())
        kw = {"device": "cpu"} if port else {}
        res, traces = pkg.execute_batch(rom, n_bits, smt=smt,
                                        include=include,
                                        **_cfgs(case, port), **kw)
        air = pkg.build_batch_air(rom, n_bits, include=include,
                                  **_cfgs(case, port))
        if port:
            prover = StarkProver(StarkSetup(air, n_queries=8,
                                            fri_fold_bits=2), device="cpu")
        else:
            prover = JProver(JSetup(air, n_queries=8, fri_fold_bits=2))
        out["port" if port else "jax"] = dict(
            rom=rom, res=res, traces=traces, air=air, prover=prover,
            smt=smt)
    return out


def _checks(case: str, traces: dict) -> tuple[list, list]:
    """Both packages' check_constraints(quick=True) lists on the port's
    stacking of `traces`."""
    c = _case(case)
    stacked = c["port"]["air"].stack_traces(traces)
    np.testing.assert_array_equal(
        stacked, c["jax"]["air"].stack_traces(traces))
    return (c["port"]["prover"].check_constraints(stacked, quick=True),
            c["jax"]["prover"].check_constraints(stacked, quick=True))


def _exprs(items) -> list:
    return [tuple(repr(getattr(it, k)) for k in ("f", "t", "sel_f", "sel_t"))
            for it in items]


def assert_airs_equal(ta, ja):
    assert ta.name == ja.name and ta.n_bits == ja.n_bits
    assert ta.cm_names == ja.cm_names
    assert ta.const_names == ja.const_names
    assert len(ta.const_values) == len(ja.const_values)
    for tv, jv in zip(ta.const_values, ja.const_values):
        np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv))
    assert ta.publics == ja.publics
    assert [repr(c) for c in ta.constraints] \
        == [repr(c) for c in ja.constraints]
    assert _exprs(ta.lookups) == _exprs(ja.lookups)
    assert _exprs(ta.permutations) == _exprs(ja.permutations)
    assert [(repr(c.pols), repr(c.sigmas)) for c in ta.connections] \
        == [(repr(c.pols), repr(c.sigmas)) for c in ja.connections]


# ---------------------------------------------------------------------------
# the JAX tests' cases: traces, AIRs, satisfied lists
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_execute_batch_traces_match_jax(case):
    c = _case(case)
    tt, jt = c["port"]["traces"], c["jax"]["traces"]
    assert list(tt) == list(jt)
    for name in tt:
        assert tt[name].dtype == np.uint64, name
        np.testing.assert_array_equal(tt[name], np.asarray(jt[name]),
                                      err_msg=name)
    assert actions_of(c["port"]["res"]) == actions_of(c["jax"]["res"])
    assert c["port"]["res"].counters == c["jax"]["res"].counters


@pytest.mark.parametrize("case", list(CASES))
def test_build_batch_air_matches_jax(case):
    c = _case(case)
    assert_airs_equal(c["port"]["air"], c["jax"]["air"])


@pytest.mark.parametrize("case", list(CASES))
def test_satisfied_in_both(case):
    assert _checks(case, _case(case)["port"]["traces"]) == ([], [])


@pytest.mark.parametrize("n_bits", range(9, 24))
def test_default_include_matches_jax(n_bits):
    assert combined.default_include(n_bits) \
        == jcombined.default_include(n_bits)
    assert combined.DEFAULT_INCLUDE == jcombined.DEFAULT_INCLUDE


def test_keccak_pipeline_cfg_rejects_slack_lanes():
    circ = keccak_circuit.build(1)
    assert combined.keccak_pipeline_cfg(circ, 40, 10)["pack"] == 40
    with pytest.raises(AssertionError, match="whole number of limbs"):
        combined.keccak_pipeline_cfg(circ, 44, 10)


# ---------------------------------------------------------------------------
# forgeries: each tampers with one SM (kept internally consistent where the
# JAX test says so); both packages must flag the same constraints
# ---------------------------------------------------------------------------


def _sm_check(air, trace) -> list:
    return StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                       device="cpu").check_constraints(trace, quick=True)


def forge_cross_sm_memory(traces):
    """The Memory SM's copy of the second write says 8 (the Main trace
    says 7); no read observes it, so Memory alone stays consistent."""
    mem = traces["memory"].copy()
    rows = np.nonzero(mem[:, 0] == 9)[0]
    assert len(rows) == 1
    mem[rows[0], 6] = np.uint64(8)
    assert _sm_check(memory.build_air(9), mem) == []
    return {**traces, "memory": mem}


def forge_binary_carry(traces):
    cols = main_sm.columns(9)
    m = traces["main"].copy()
    r = int(np.nonzero(m[:, cols.index("BIN")] == 1)[0][-1])
    m[r, cols.index("CARRY")] ^= np.uint64(1)
    return {**traces, "main": m}


def forge_mem_align_write(traces):
    res = _case("mem_align")["port"]["res"]
    acts = [dict(a) for a in res.actions.mem_align]
    assert acts[0]["op"] == "wr"
    acts[0]["value"] ^= 0xFF << 128
    forged, _ = mem_align.execute(acts, 9)
    assert _sm_check(mem_align.build_air(9), forged) == []
    return {**traces, "mem_align": forged}


def forge_arith_operand(traces):
    res = _case("arith")["port"]["res"]
    acts = [dict(a) for a in res.actions.arith]
    assert acts[0]["op"] == "mul"
    acts[0]["x2"] = 8
    forged = arith.execute(acts, 9)
    assert _sm_check(arith.build_air(9), forged) == []
    return {**traces, "arith": forged}


def forge_storage_value(traces):
    ci = {nm: i for i, nm in enumerate(storage.COLS)}
    st = traces["storage"].copy()
    rows = np.nonzero((st[:, ci["VLOW0"]] == 777)
                      & (st[:, ci["SAME"]] == 1))[0]
    assert len(rows) > 0
    st[rows, ci["VLOW0"]] = np.uint64(778)
    return {**traces, "storage": st}


def forge_keccak_digest(traces):
    ci = {nm: i for i, nm in enumerate(padding_kk.COLS)}
    forged = traces["padding_kk"].copy()
    forged[forged[:, ci["ADDR"]] == 0x100, ci["DG3"]] ^= np.uint64(1)
    return {**traces, "padding_kk": forged}


def forge_keccak_stream_byte(traces):
    res = _case("keccak")["port"]["res"]
    acts = [dict(a) for a in res.actions.keccak]
    data = bytearray(acts[0]["data"])
    data[0] ^= 0x40
    acts[0]["data"] = bytes(data)
    n_cov = ((1 << 13) // keccak_circuit.build(1).n_rows) * 4
    forged, _, _ = padding_kk.execute(acts, 13, n_cov)
    ci = {nm: i for i, nm in enumerate(padding_kk.COLS)}
    for limb in range(8):
        forged[:, ci[f"DG{limb}"]] = traces["padding_kk"][:, ci[f"DG{limb}"]]
    return {**traces, "padding_kk": forged}


def forge_keccak_output_bit(traces):
    lay = hash_bit.keccak_layout()
    ci = {nm: i for i, nm in enumerate(hash_bit.COLS)}
    forged = traces["keccak_bit"].copy()
    forged[1 * lay.n_pos + 300, ci["SOUT"]] ^= np.uint64(1)
    return {**traces, "keccak_bit": forged}


def forge_sha256_digest(traces):
    ci = {nm: i for i, nm in enumerate(padding_sha256.COLS)}
    forged = traces["padding_sha256"].copy()
    forged[forged[:, ci["ADDR"]] == 0x40, ci["DG5"]] ^= np.uint64(1)
    return {**traces, "padding_sha256": forged}


def forge_hashp_digest(traces):
    ci = {nm: i for i, nm in enumerate(padding_pg_byte.COLS)}
    forged = traces["padding_pg_byte"].copy()
    forged[forged[:, ci["ADDR"]] == 0x30, ci["DG0"]] ^= np.uint64(1)
    return {**traces, "padding_pg_byte": forged}


FORGERIES = {
    "cross_sm_memory": ("memory_binary", forge_cross_sm_memory),
    "binary_carry": ("memory_binary", forge_binary_carry),
    "mem_align_write": ("mem_align", forge_mem_align_write),
    "arith_operand": ("arith", forge_arith_operand),
    "storage_value": ("storage", forge_storage_value),
    "keccak_digest": ("keccak", forge_keccak_digest),
    "keccak_stream_byte": ("keccak", forge_keccak_stream_byte),
    "keccak_output_bit": ("keccak", forge_keccak_output_bit),
    "sha256_digest": ("sha256", forge_sha256_digest),
    "hashp_digest": ("padding_pg", forge_hashp_digest),
}


@pytest.mark.parametrize("forgery", list(FORGERIES))
def test_forgery_flagged_alike(forgery):
    case, forge = FORGERIES[forgery]
    port, jax_ = _checks(case, forge(_case(case)["port"]["traces"]))
    assert port != [], f"the combined AIR accepted the {forgery} forgery"
    assert port == jax_


# ---------------------------------------------------------------------------
# the digest helpers (test_hash_pipeline.py)
# ---------------------------------------------------------------------------


def test_hash_bit_digest_matches_real_keccak():
    lay = hash_bit.keccak_layout()
    data = b"abc"
    padded = bytearray(data) + bytearray(136 - len(data))
    padded[len(data)] |= 0x01
    padded[-1] |= 0x80
    _, dlimbs, _ = hash_bit.execute(
        [{"bytes": bytes(padded), "first": True}], 11, lay,
        combined._host_keccak_perm)
    got = sum(limb << (32 * i) for i, limb in enumerate(dlimbs[0]))
    assert got == int.from_bytes(keccak.keccak256(data), "big")


def test_digest_helpers_match_real_hashes_and_jax():
    klay, slay = hash_bit.keccak_layout(), hash_bit.sha256_layout()
    for msg in (b"", b"hello!", bytes(range(200))):
        got = combined._sponge_digest(msg, klay, combined._host_keccak_perm)
        assert got == int.from_bytes(keccak.keccak256(msg), "big")
    for msg in (b"", b"abc", bytes(range(100))):
        got = combined._md_digest(msg, slay, combined._host_sha_perm)
        assert got == int.from_bytes(sha_mod.sha256(msg), "big")
    # the reduced-round oracles Main uses with the test circuits
    from zkevm_prover_tpu.executor.sm import hash_bit as jhash_bit
    for circ, jcirc, lay, jlay, digest, jdigest in (
            (keccak_circuit.build(1), jkc.build(1), klay,
             jhash_bit.keccak_layout(), combined._sponge_digest,
             jcombined._sponge_digest),
            (sha256_circuit.build(1), jsc.build(1), slay,
             jhash_bit.sha256_layout(), combined._md_digest,
             jcombined._md_digest)):
        perm = hash_bit.circuit_perm_bits(circ)
        jperm = jhash_bit.circuit_perm_bits(jcirc)
        for msg in (b"", bytes(range(150))):
            assert digest(msg, lay, perm) == jdigest(msg, jlay, jperm)


def test_padding_pg_byte_digest_matches_reference():
    pos = refmodel.Poseidon(poseidon_constants.round_constants(),
                            poseidon_constants.mds_matrix())
    for data in (b"", b"abc", bytes(range(150))):
        msgs = padding_pg_byte.layout([{"data": data, "addr": 5}], 11)
        assert msgs[0]["digest4"] == pos.linear_hash_bytes(data)


# ---------------------------------------------------------------------------
# the storage -> ClimbKey binding (tests/test_storage_sm.py:100), no JAX
# ---------------------------------------------------------------------------


def test_storage_climb_key_binding():
    """The no-wrap leg: every climb-down step must be a ClimbKey op. A
    storage+ClimbKey AIR with the lookup `build_batch_air` declares; a
    storage trace whose climb has no ClimbKey op is rejected."""
    smt = Smt(Database())
    acts, r = [], (0, 0, 0, 0)
    for key, val in (((2, 0, 0, 0), 5), ((3, 0, 0, 0), 6)):
        res = smt.set(r, key, val)
        acts.append({"op": "set", "root": r, "key": key, "value": val,
                     "new_root": res.new_root})
        r = res.new_root
    acts.append({"op": "get", "root": r, "key": (2, 0, 0, 0),
                 "value": smt.get(r, (2, 0, 0, 0)).value})
    st_tr, emitted = storage.execute(acts, 9, smt.db)
    ck_tr = climb_key.execute(emitted["climb_key"], 9)

    air = CombinedAIR("st_ck", 9)
    air.add("storage", storage.build_air(9))
    air.add("climb_key", climb_key.build_air(9))
    f = ([air.cm("storage", f"RKEY{j}") for j in range(4)]
         + [air.cm("storage", "LEVEL"), air.cm("storage", "BIT")])
    t = ([air.cm("climb_key", f"KEY{j}") for j in range(4)]
         + [air.cm("climb_key", "LEVEL"), air.cm("climb_key", "BIT")])
    air.lookup(f, t, sel_f=1 - air.cm("storage", "LAST"),
               sel_t=air.const("climb_key", "ISLAST"))
    prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device="cpu")
    stacked = air.stack_traces({"storage": st_tr, "climb_key": ck_tr})
    assert prover.check_constraints(stacked, quick=True) == []

    assert emitted["climb_key"], "the test needs at least one climb"
    ck_tr2 = climb_key.execute(emitted["climb_key"][1:], 9)
    stacked = air.stack_traces({"storage": st_tr, "climb_key": ck_tr2})
    assert any(str(b).startswith("plookup")
               for b in prover.check_constraints(stacked, quick=True))


# ---------------------------------------------------------------------------
# ecrecover (tests/test_misc_components.py:65-84)
# ---------------------------------------------------------------------------


def test_ecrecover_roundtrip():
    rng = random.Random(0)
    for _ in range(3):
        priv = rng.randrange(1, ecr.N)
        addr = ecr.pubkey_address(priv)
        assert addr == jecr.pubkey_address(priv)
        digest = keccak.keccak256(b"message-%d" % priv)
        k = rng.randrange(1, ecr.N)
        r, s, v = ecr.sign(digest, priv, k)
        assert (r, s, v) == jecr.sign(digest, priv, k)
        code, got = ecr.ecrecover(digest, r, s, v)
        assert code == ecr.ECR_NO_ERROR and got == addr
        assert (code, got) == jecr.ecrecover(digest, r, s, v)
        code2, got2 = ecr.ecrecover(keccak.keccak256(b"other"), r, s, v)
        assert code2 == ecr.ECR_NO_ERROR and got2 != addr


def test_ecrecover_error_codes():
    digest = keccak.keccak256(b"x")
    assert ecr.ecrecover(digest, 0, 1, 27)[0] == ecr.ECR_R_IS_ZERO
    assert ecr.ecrecover(digest, ecr.N, 1, 27)[0] == ecr.ECR_R_IS_TOO_BIG
    assert ecr.ecrecover(digest, 1, 0, 27)[0] == ecr.ECR_S_IS_ZERO
    assert ecr.ecrecover(digest, 1, ecr.N - 1, 27)[0] \
        == ecr.ECR_S_IS_TOO_BIG
    assert ecr.ecrecover(digest, 1, 1, 99)[0] == ecr.ECR_V_INVALID


# ---------------------------------------------------------------------------
# hashp actions through the Executor's action-list path
# ---------------------------------------------------------------------------


def _hashp_batch() -> dict:
    rng = random.Random(5)
    return dict(
        hashp=[{"data": bytes(range(70)), "addr": 3},
               {"data": b"abc", "addr": 4}],
        memory=[{"addr": 5, "step": 1, "wr": 1, "value": 77},
                {"addr": 5, "step": 2, "wr": 0, "value": 77}],
        padding_pg=[{"values": [rng.randrange(1 << 60) for _ in range(9)]}])


def test_executor_hashp_matches_jax():
    """hashp actions fill no trace in either package's `Executor.execute`
    (the combined AIR proves them); the other SMs' traces and the
    counters are the JAX package's."""
    port_ex, jax_ex = Executor(device="cpu"), JExecutor()
    tt = port_ex.execute(BatchActions(**_hashp_batch()))
    jt = jax_ex.execute(JActions(**_hashp_batch()))
    assert list(tt) == list(jt) == ["memory", "padding_pg"]
    for name in tt:
        np.testing.assert_array_equal(tt[name], np.asarray(jt[name]))
    tc = port_ex.counters(BatchActions(**_hashp_batch()))
    jc = jax_ex.counters(JActions(**_hashp_batch()))
    assert {k: tc[k] for k in jc} == jc


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


@functools.lru_cache(maxsize=None)
def _small_proof():
    _, _, _, traces, prover = _small()
    return prover.prove(prover.setup.air.stack_traces(traces))


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


def test_small_rom_batch_proof_matches_pin():
    digest = hashlib.sha256(_small_proof().to_json().encode()).hexdigest()
    assert digest == SMALL_PIN


def test_small_rom_batch_verifies_and_publics():
    """verify accepts; the chaining publics read out of the proof (as
    `Prover._gen_batch_proof_rom` reads them) are the executor's: the
    old root the batch started from and the new root it wrote."""
    tree, batch, res, _, prover = _small()
    proof = _small_proof()
    assert verify(prover.setup, prover.verkey, proof, device="cpu")
    pv = [int(x) for x in proof.publics]
    assert main_sm._fea8_to_fe4(pv[0:8]) == tree.root
    assert main_sm._fea8_to_fe4(pv[19:27]) == res.new_state_root
    assert res.new_state_root != tree.root
    assert pv[17] == examples.CHAIN_ID and pv[18] == examples.FORK_ID


def test_small_rom_batch_tampered_proof_rejected():
    _, _, _, _, prover = _small()
    bad = StarkProof.from_json(_small_proof().to_json())
    bad.fri[0].queries[0][0].values[0] += 1
    with pytest.raises(VerifyError):
        verify(prover.setup, prover.verkey, bad, device="cpu")


@pytest.mark.slow
def test_jax_small_rom_batch_proof_matches_pin():
    _, traces, air = _jax_small()
    prover = JProver(JSetup(air, n_queries=8, fri_fold_bits=2))
    proof = prover.prove(air.stack_traces(traces))
    assert hashlib.sha256(proof.to_json().encode()).hexdigest() == SMALL_PIN


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


def test_rom_for_fork_raises_without_the_reference(tmp_path):
    with pytest.raises(FileNotFoundError, match="no rom.json"):
        forks.rom_for_fork(9, str(tmp_path))
    assert forks.supported_forks(str(tmp_path)) == []
    with pytest.raises(FileNotFoundError, match="ZKEVM_REFERENCE_ROOT"):
        forks.rom_for_fork(9, None)
    assert forks.supported_forks(None) == []
