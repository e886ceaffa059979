"""The port's FullTracer (`executor/full_tracer.py`) against the JAX
package's: the opcode table for all 256 ids, `string_increment`,
`legacy_tx_hash`, and the `TraceConfig` a `ProofInput.make_full_tracer`
builds. The traced reference vectors (the twins of
tests/test_full_tracer.py) run the fork ROM over the reference test
vectors through both packages and compare the responses; like the JAX
tests they skip without the reference tree."""

import dataclasses
import json
import os

import numpy as np
import pytest

from zkevm_prover_tpu.executor import forks as jforks
from zkevm_prover_tpu.executor import full_tracer as jft
from zkevm_prover_tpu.executor.rom import Rom as JRom
from zkevm_prover_tpu.prover.input import ProofInput as JInput
from zkevm_prover_tpu_torch.executor import forks
from zkevm_prover_tpu_torch.executor import full_tracer as ft
from zkevm_prover_tpu_torch.executor.rom import Rom
from zkevm_prover_tpu_torch.prover.input import ProofInput


def test_opcode_name_matches_jax():
    for i in range(256):
        assert ft.opcode_name(i) == jft.opcode_name(i), f"id {i:#x}"
    assert ft.opcode_name(0x01) == (0x01, "ADD", 3)


@pytest.mark.parametrize("prev,cur", [
    (b"", b"abcd"), (b"abcd", b"abcd"), (b"abcd", b"abxd"),
    (b"abcd", b"abcdef"), (b"abcd", b"xbcdef"), (b"abcdef", b"ab"),
    (b"\x00" * 64, b"\x00" * 31 + b"\x01" + b"\x00" * 32)])
def test_string_increment_matches_jax(prev, cur):
    assert ft.string_increment(prev, cur) == jft.string_increment(prev, cur)


def test_legacy_tx_hash_matches_jax():
    rng = np.random.default_rng(90)
    cases = [("0x4d5cf5032b2a844602278b01199ed191a86c93ff", 10**18, 0,
              21000, 10**9, "0x", 0x1C8, 0x2A, 2037),
             ("0x", 0, 0, 0, 0, "0x", 0, 0, 0)]
    for _ in range(8):
        data = "0x" + rng.bytes(int(rng.integers(0, 120))).hex()
        to = "0x" + rng.bytes(20).hex()
        ints = [int.from_bytes(rng.bytes(int(rng.integers(1, 33))), "big")
                for _ in range(6)]
        cases.append((to, ints[0], ints[1] % 2**64, ints[2] % 2**64,
                      ints[3], data, ints[4], ints[5], 2037))
    for case in cases:
        assert ft.legacy_tx_hash(*case) == jft.legacy_tx_hash(*case)
    _, rlp = ft.legacy_tx_hash("0x", 0, 0, 0, 0, "0x", 0, 0, 0)
    assert rlp == bytes([0xC0 + 9] + [0x80] * 9)


@pytest.mark.parametrize("trace_config", (
    {}, {"enableMemory": True, "enableReturnData": True},
    {"disableStorage": True, "disableStack": True,
     "txHashToGenerateFullTrace": "0x01"}))
def test_make_full_tracer_matches_jax(trace_config):
    text = json.dumps({"traceConfig": trace_config, "noCounters": True,
                       "skipFirstChangeL2Block": True})
    mine = ProofInput.from_json(text).make_full_tracer(Rom([], {}))
    theirs = JInput.from_json(text).make_full_tracer(JRom([], {}))
    assert dataclasses.asdict(mine.cfg) == dataclasses.asdict(theirs.cfg)
    for flag in ("generate_storage", "generate_stack", "generate_memory",
                 "generate_return_data"):
        assert getattr(mine.cfg, flag) == getattr(theirs.cfg, flag)
    assert (mine.no_counters, mine.skip_first_change_l2_block) == \
        (theirs.no_counters, theirs.skip_first_change_l2_block) == \
        (True, True)


# ---------------------------------------------------------------------------
# the traced reference vectors (tests/test_full_tracer.py), which need the
# reference tree
# ---------------------------------------------------------------------------

_VECTORS = os.path.join(os.path.dirname(os.path.dirname(
    jforks.REFERENCE_ROOT)), "testvectors")


def _traced(path, trace_config, port: bool):
    from zkevm_prover_tpu.executor.sm.main_sm import MainExecutor as JMain
    from zkevm_prover_tpu.hashdb.database import Database as JDatabase
    from zkevm_prover_tpu.hashdb.smt import Smt as JSmt
    from zkevm_prover_tpu_torch.executor.sm.main_sm import MainExecutor
    from zkevm_prover_tpu_torch.hashdb import Database, Smt

    pi = (ProofInput if port else JInput).from_file(path)
    pi.trace_config = trace_config
    db = Database() if port else JDatabase()
    pi.seed_database(db)
    fork = int(pi.publics.fork_id)
    rom = (forks.rom_for_fork(fork, jforks.REFERENCE_ROOT) if port
           else jforks.rom_for_fork(fork))
    tracer = pi.make_full_tracer(rom)
    (MainExecutor if port else JMain)(rom, 23).execute(
        pi.executor_input(), smt=(Smt if port else JSmt)(db),
        process_batch=True, full_tracer=tracer)
    return pi, tracer


def _responses(tracer) -> dict:
    """The final trace without its wall-clock fields."""
    def strip(v):
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items() if "time" not in k}
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v
    return strip(dataclasses.asdict(tracer.final_trace))


@pytest.mark.skipif(not os.path.exists(jforks.rom_path(9)),
                    reason="reference tree not mounted")
@pytest.mark.parametrize("vector,trace_config", [
    ("e2e/fork_9/input_executor_0.json",
     {"enableMemory": True, "enableReturnData": True}),
    ("e2e/fork_9/input_executor_0.json", {}),
    ("timestampRecovery/block-info-batches-0-0-input.json",
     {"enableMemory": True, "enableReturnData": True})])
def test_traced_vector_matches_jax(vector, trace_config):
    path = os.path.join(_VECTORS, vector)
    pi, tracer = _traced(path, trace_config, port=True)
    _, jtracer = _traced(path, trace_config, port=False)
    assert _responses(tracer) == _responses(jtracer)
    assert tracer.final_trace.new_state_root == pi.publics.new_state_root
    assert sorted(tracer.read_write_addresses) == \
        sorted(jtracer.read_write_addresses)
