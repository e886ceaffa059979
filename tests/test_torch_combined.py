"""The port's combined batch AIR (`executor/combined.py`, `stark/compose.py`)
against the JAX package's, on the JAX tests' ROMs and sizes
(tests/test_combined_air.py at 2^9, tests/test_hash_pipeline.py at 2^13
and 2^11 with the reduced-round circuits): `execute_batch` traces bit for
bit, and `build_batch_air` names, constants, publics, constraints, lookups
and permutations. Also the digest helpers, `default_include`, the twin of
tests/test_storage_sm.py's storage/ClimbKey binding (no JAX), the
ecrecover twins of tests/test_misc_components.py and hashp actions through
the `Executor`.

The `check_constraints(quick=True)` lists of these cases, satisfied and
forged, are in tests/test_torch_combined_checks.py, and the small
combined batch (`examples.small_rom_batch`) and its pinned proof in
tests/test_torch_combined_small.py: split so that the three run on
separate test workers.
"""

import functools
import random

import numpy as np
import pytest
import torch

from test_torch_main_sm import actions_of
from test_torch_rom import build
from zkevm_prover_tpu.executor import Executor as JExecutor
from zkevm_prover_tpu.executor import BatchActions as JActions
from zkevm_prover_tpu.executor import combined as jcombined
from zkevm_prover_tpu.executor.sm import keccak_circuit as jkc
from zkevm_prover_tpu.executor.sm import sha256_circuit as jsc
from zkevm_prover_tpu.hashdb.database import Database as JDatabase
from zkevm_prover_tpu.hashdb.smt import Smt as JSmt
from zkevm_prover_tpu.ops import ecrecover as jecr
from zkevm_prover_tpu.stark.prover import StarkProver as JProver
from zkevm_prover_tpu.stark.setup import StarkSetup as JSetup
from zkevm_prover_tpu_torch.executor import BatchActions, Executor
from zkevm_prover_tpu_torch.executor import combined, forks
from zkevm_prover_tpu_torch.executor.sm import (climb_key, hash_bit,
                                                keccak_circuit,
                                                padding_pg_byte,
                                                sha256_circuit, storage)
from zkevm_prover_tpu_torch.hashdb import Database, Smt
from zkevm_prover_tpu_torch.ops import ecrecover as ecr
from zkevm_prover_tpu_torch.ops import keccak, poseidon_constants, refmodel
from zkevm_prover_tpu_torch.ops import sha256 as sha_mod
from zkevm_prover_tpu_torch.stark.compose import CombinedAIR
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.setup import StarkSetup

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
# the JAX tests' cases: traces and AIRs
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


def test_rom_for_fork_raises_without_the_reference(tmp_path):
    with pytest.raises(FileNotFoundError, match="no rom.json"):
        forks.rom_for_fork(9, str(tmp_path))
    assert forks.supported_forks(str(tmp_path)) == []
    with pytest.raises(FileNotFoundError, match="ZKEVM_REFERENCE_ROOT"):
        forks.rom_for_fork(9, None)
    assert forks.supported_forks(None) == []
