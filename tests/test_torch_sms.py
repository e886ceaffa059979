"""The port's six co-processor SMs (binary, memory, arith, mem_align,
padding_pg, climb_key) against the JAX package's, exactly: traces and second
return values of `execute`, the result oracles, the AIR tables, and the
executor's counters. Both sides are numpy on the host here, so nothing is
compiled; the proofs of these AIRs are held against the JAX package in
tests/test_torch_batch.py."""

import random

import numpy as np
import pytest

from zkevm_prover_tpu.executor import BatchActions as JActions
from zkevm_prover_tpu.executor import Executor as JExecutor
from zkevm_prover_tpu.executor.sm import arith as jarith
from zkevm_prover_tpu.executor.sm import binary as jbinary
from zkevm_prover_tpu.executor.sm import climb_key as jclimb_key
from zkevm_prover_tpu.executor.sm import mem_align as jmem_align
from zkevm_prover_tpu.executor.sm import memory as jmemory
from zkevm_prover_tpu.executor.sm import padding_pg as jpadding_pg
from zkevm_prover_tpu_torch.executor import BatchActions, Executor
from zkevm_prover_tpu_torch.executor.sm import (arith, binary, climb_key,
                                                mem_align, memory, padding_pg)

P = 0xFFFFFFFF00000001
M256 = (1 << 256) - 1
SMS = ["binary", "memory", "arith", "mem_align", "padding_pg", "climb_key"]
PORT = {"binary": binary, "memory": memory, "arith": arith,
        "mem_align": mem_align, "padding_pg": padding_pg,
        "climb_key": climb_key}
JAX = {"binary": jbinary, "memory": jmemory, "arith": jarith,
       "mem_align": jmem_align, "padding_pg": jpadding_pg,
       "climb_key": jclimb_key}
N_BITS = {"binary": 9, "memory": 9, "arith": 9, "mem_align": 9,
          "padding_pg": 9, "climb_key": 10}
BIN_SLICE = 2   # the slice width Executor.binary_slice_bits picks at 2^9


def _actions(sm: str) -> list:
    rng = random.Random(sum(map(ord, sm)))
    r256 = lambda: rng.getrandbits(256)  # noqa: E731
    if sm == "binary":
        return [{"op": op, "a": r256(), "b": r256()}
                for op in ("ADD", "SLT", "EQ", "XOR")]
    if sm == "memory":
        return [{"addr": rng.randrange(1 << 20), "step": s,
                 "wr": rng.randrange(2), "value": r256()}
                for s in range(1, 200)] + [
            {"addr": 5, "step": 300, "wr": 1, "fea": [P - 1] + [0] * 7}]
    if sm == "arith":
        gx = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
        gy = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
        x2, y2 = jarith.ec_result("dbl", gx, gy)
        a, b, c, d = (rng.randrange(jarith.PBN) for _ in range(4))
        return ([{"x1": r256(), "y1": r256(), "x2": r256()},
                 {"x1": M256, "y1": M256, "x2": M256},
                 {"op": "dbl", "x1": gx, "y1": gy},
                 {"op": "add", "x1": gx, "y1": gy, "x2": x2, "y2": y2}]
                + [{"op": op, "x1": a, "y1": b, "x2": c, "y2": d}
                   for op in ("mulfp2", "addfp2", "subfp2")]
                + [{"op": "mulfp2", "x1": M256, "y1": M256, "x2": M256,
                    "y2": M256}])
    if sm == "mem_align":
        return [{"op": "rd", "w0": r256(), "w1": r256(), "offset": 32},
                {"op": "wr", "w0": r256(), "w1": r256(),
                 "offset": rng.randrange(33), "value": r256()},
                {"op": "wr8", "w0": r256(), "w1": r256(), "offset": 63,
                 "value": r256()},
                {"w0": r256(), "w1": r256(), "offset": 0}]
    if sm == "padding_pg":
        return [{"values": [rng.randrange(P) for _ in range(ln)]}
                for ln in (20, 7, 5, 16, 33, 9)]
    return [{"key": [rng.randrange(P >> 2) for _ in range(4)],
             "level": lvl, "bit": rng.randrange(2)} for lvl in range(9)]


def _execute(mod, sm, acts):
    if sm == "binary":
        return mod.execute(acts, N_BITS[sm], BIN_SLICE)
    return mod.execute(acts, N_BITS[sm])


def _equal(a, b):
    """Exact equality of execute outputs: arrays, or tuples/lists of them
    and of Python ints."""
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("sm", SMS)
def test_execute_matches_jax(sm):
    acts = _actions(sm)
    _equal(_execute(PORT[sm], sm, acts), _execute(JAX[sm], sm, acts))


def test_padding_pg_execute_chunks_matches_jax():
    rng = random.Random(3)
    chunks = [{"values": [rng.randrange(P) for _ in range(8)],
               "cont_digest": [rng.randrange(P) for _ in range(4)] if i else
               [0] * 4, "cont": 1 if i else 0} for i in range(5)]
    _equal(padding_pg.execute_chunks(chunks, 9),
           jpadding_pg.execute_chunks(chunks, 9))


@pytest.mark.parametrize("sm", SMS)
def test_results_match_jax(sm):
    acts = _actions(sm)
    if sm == "binary":
        assert binary.results(acts) == jbinary.results(acts)
        assert [binary.result(a["op"], a["a"], a["b"]) for a in acts] == \
            [jbinary.result(a["op"], a["a"], a["b"]) for a in acts]
    elif sm == "memory":
        assert memory.execute(acts, 9)[1] == jmemory.execute(acts, 9)[1]
    elif sm == "arith":
        assert [arith.result(a) for a in acts] == \
            [jarith.result(a) for a in acts]
        for a in acts[2:]:
            op = a["op"]
            args = (op, a["x1"], a["y1"], a.get("x2"), a.get("y2"))
            if op in ("add", "dbl"):
                assert arith.ec_result(*args) == jarith.ec_result(*args)
            else:
                assert arith.fp2_result(*args) == jarith.fp2_result(*args)
    else:
        assert [PORT[sm].result(a) for a in acts] == \
            [JAX[sm].result(a) for a in acts]


def _air(mod, sm):
    if sm == "binary":
        return mod.build_air(N_BITS[sm], BIN_SLICE)
    return mod.build_air(N_BITS[sm])


@pytest.mark.parametrize("sm", SMS)
def test_air_tables_match_jax(sm):
    tair, jair = _air(PORT[sm], sm), _air(JAX[sm], sm)
    assert tair.cm_names == jair.cm_names
    assert tair.const_names == jair.const_names
    for tc, jc in zip(tair.const_values, jair.const_values, strict=True):
        assert tc.dtype == jc.dtype
        np.testing.assert_array_equal(tc, jc)
    assert len(tair.constraints) == len(jair.constraints)
    assert len(tair.lookups) == len(jair.lookups)
    assert len(tair.permutations) == len(jair.permutations)
    assert len(tair.connections) == len(jair.connections)


@pytest.mark.parametrize("bits", [9, 13])
def test_counters_and_slice_bits_match_jax(bits):
    kw = {sm: [{}] * 3 for sm in SMS + ["poseidon_g"]}
    n_bits = {sm: bits for sm in SMS + ["poseidon_g"]}
    t, j = Executor(n_bits=n_bits, device="cpu"), JExecutor(n_bits=n_bits)
    assert t.binary_slice_bits() == j.binary_slice_bits()
    jcounts = j.counters(JActions(**kw))
    counts = t.counters(BatchActions(**kw))
    assert {k: counts[k] for k in jcounts} == jcounts
    # the port also counts the padding SMs' blocks (the JAX package's
    # Executor has no counter for them)
    assert set(counts) - set(jcounts) == {
        "padding_kk", "padding_kk_capacity", "padding_sha256",
        "padding_sha256_capacity"}


def test_executor_traces_match_jax():
    acts = {sm: _actions(sm) for sm in SMS}
    n_bits = dict(N_BITS, binary=9)
    t = Executor(n_bits=n_bits, device="cpu").execute(BatchActions(**acts))
    j = JExecutor(n_bits=n_bits).execute(JActions(**acts))
    assert list(t) == list(j)
    for name in t:
        np.testing.assert_array_equal(t[name], j[name])


def test_climb_key_precondition_raises_in_both():
    acts = [{"key": [P >> 1, 0, 0, 0], "level": 0, "bit": 1}]
    for mod in (climb_key, jclimb_key):
        with pytest.raises(ValueError, match="prime"):
            mod.execute(acts, 10)
