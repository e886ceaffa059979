"""The `check_constraints(quick=True)` lists of the port's combined batch
AIR against the JAX package's, on the cases of tests/test_torch_combined.py
(the JAX tests' ROMs and sizes, from which this file was split so that the
two run on separate test workers): both packages satisfied on the honest
traces, and every forgery of tests/test_combined_air.py and
tests/test_hash_pipeline.py flagged by the same constraints in both.
"""

import numpy as np
import pytest
import torch

from test_torch_combined import CASES, _case, _checks
from zkevm_prover_tpu_torch.executor.sm import (arith, hash_bit,
                                                keccak_circuit, main_sm,
                                                mem_align, memory,
                                                padding_kk, padding_pg_byte,
                                                padding_sha256, storage)
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.setup import StarkSetup


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's intra-op pool slows down by orders of magnitude beside the
    other test workers: the port's CPU checks run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", list(CASES))
def test_satisfied_in_both(case):
    assert _checks(case, _case(case)["port"]["traces"]) == ([], [])



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
