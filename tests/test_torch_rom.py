"""The port's ROM (`executor/rom.py`) against the JAX package's, line by
line: every ROM of the JAX tests of the Main SM and the combined AIR
(tests/test_main_sm.py, tests/test_combined_air.py,
tests/test_hash_pipeline.py), written once here as a body over a
`RomBuilder`, built by both packages' `RomBuilder`; and `Rom.from_json` of one
JSON text in both packages. The other port test files of this slice
(test_torch_main_sm.py, test_torch_combined.py) build their ROMs from the
bodies here.
"""

import json

import pytest

from zkevm_prover_tpu.executor import rom as jrom
from zkevm_prover_tpu.executor.sm import arith as jarith
from zkevm_prover_tpu.executor.sm import mem_align as jmem_align
from zkevm_prover_tpu_torch.executor import examples
from zkevm_prover_tpu_torch.executor import rom as trom
from zkevm_prover_tpu_torch.executor.sm import arith as tarith
from zkevm_prover_tpu_torch.executor.sm import mem_align as tmem_align

GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G2X = 0xC6047F9441ED7D6D3045406E95C07CD85C778E4B8CEF3CA7ABAC09B95C709EE5


# ---------------------------------------------------------------------------
# the JAX tests' ROM bodies: body(rb, sm) appends lines to a RomBuilder; `sm`
# holds the package's arith and mem_align modules (for computed operands)
# ---------------------------------------------------------------------------


def selectors_setters_assert(rb, sm):
    rb.line("7 => A", CONST=7, setA=1)
    rb.line("5 => B", CONST=5, setB=1)
    rb.line("A + B => C", inA=1, inB=1, setC=1)
    rb.line("12 => A", CONST=12, setA=1)
    rb.line("C :ASSERT", inC=1, assert_=1)
    rb.line("A - B => D", inA=1, inB=-1, setD=1)


def failing_assert(rb, sm):
    rb.line(CONST=3, setA=1)
    rb.line(CONST=4, assert_=1)


def constl_and_rotl_c(rb, sm):
    big = int.from_bytes(bytes(range(1, 33)), "big")
    rb.line("CONSTL => C", CONSTL=big, setC=1)
    rb.line("C rotl => E", inROTL_C=1, setE=1)


def jumps_call_return_repeat(rb, sm):
    rb.line("3 => A", CONST=3, setA=1)
    rb.label("loop")
    rb.line("A - 1 => A :JMPN(done)", inA=1, CONST=-1, setA=1,
            JMPN=1, useJmpAddr=1, jmpAddr="done")
    rb.jmp("loop")
    rb.label("done")
    rb.call("sub")
    rb.call("sub")
    rb.line("5 => RCX", CONST=5, setRCX=1)
    rb.line("B + 1 => B :REPEAT", inB=1, CONST=1, setB=1, repeat=1)
    rb.line("206 => A", CONST=206, setA=1)
    rb.line("B :ASSERT", inB=1, assert_=1)
    rb.line(":JMPZ(iszero)", CONST=0, JMPZ=1, useJmpAddr=1,
            jmpAddr="iszero")
    rb.line(CONST=999, setE=1)
    rb.label("iszero")
    rb.jmp("end")
    rb.label("sub")
    rb.line("B + 100 => B", inB=1, CONST=100, setB=1)
    rb.ret()
    rb.label("end")


def free_input_command_and_memory_ops(rb, sm):
    val = 0xDEADBEEF_00112233_44556677_8899AABB_CCDDEEFF_01020304_05060708_090A0B0C  # noqa: E501
    rb.line("CONSTL => A", CONSTL=val, setA=1)
    rb.line("A :MSTORE(5)", inA=1, mOp=1, mWR=1, offset=5)
    rb.free({"op": "number", "num": "42"}, "${42} => D", setD=1)
    rb.line(":MLOAD(5) => B", inFREE=1, mOp=1, offset=5, setB=1)
    rb.line("A :ASSERT... via B", inB=1, assert_=1)
    rb.line("5 => E", CONST=5, setE=1)
    rb.line(":MLOAD(E) => C", inFREE=1, mOp=1, ind=1, setC=1)


def storage_srd_swr(rb, sm):
    rb.line(CONST=0x1234, setA=1)
    rb.line(CONST=3, setB=1)
    rb.line(CONST=7, setC=1)
    rb.line("777 => D", CONST=777, setD=1)
    rb.line("$ => SR :SSTORE", inFREE=1, sWR=1, setSR=1)
    rb.line("$ => E :SLOAD", inFREE=1, sRD=1, setE=1)
    rb.line("777 => A", CONST=777, setA=1)
    rb.line("E :ASSERT", inE=1, assert_=1)


def hash_keccak_pipeline(rb, sm):
    data = bytes(range(1, 40))
    rb.line("CONSTL => A", CONSTL=int.from_bytes(data[:32], "big"), setA=1)
    rb.line("32 => D", CONST=32, setD=1)
    rb.line("A :HASHK(0)", inA=1, hashK=1, offset=0)
    rb.line("CONSTL => A", CONSTL=int.from_bytes(data[32:], "big"), setA=1)
    rb.line("7 => D", CONST=7, setD=1)
    rb.line("A :HASHK(0)", inA=1, hashK=1, offset=0)
    rb.line("HASHPOS :HASHKLEN(0)", inHASHPOS=1, hashKLen=1, offset=0)
    rb.line("$ => B :HASHKDIGEST(0)", inFREE=1, hashKDigest=1,
            offset=0, setB=1)


def binary_and_arith_actions(rb, sm):
    rb.line(CONSTL=(1 << 256) - 5, setA=1)
    rb.line(CONSTL=9, setB=1)
    rb.line("$ => C :ADD :JMPC(carried)", inFREE=1, bin=1, binOpcode=0,
            setC=1, JMPC=1, useJmpAddr=1, jmpAddr="carried")
    rb.line(CONST=111, setE=1)
    rb.label("carried")
    rb.line(CONSTL=3, setA=1)
    rb.line(CONSTL=5, setB=1)
    rb.line(CONSTL=1, setC=1)
    rb.line(CONSTL=0, setD=1)
    rb.line("$ => E :ARITH", inFREE=1,
            free_in_tag={"op": "number", "num": "16"},
            arithEq0=1, setE=1)


def arith_ec_ops(rb, sm):
    def reg(name):
        return {"op": "getReg", "regName": name}

    rb.line(CONSTL=GX, setA=1)
    rb.line(CONSTL=GY, setB=1)
    rb.line(CONSTL=GX, setC=1)
    rb.line(CONSTL=GY, setD=1)
    rb.free({"op": "functionCall", "funcName": "xDblPointEc",
             "params": [reg("A"), reg("B")]}, setE=1)
    rb.line("$ => B :ARITH_ECDBL", inFREE=1, arithEq2=1, setB=1)
    rb.line("E => A", inE=1, setA=1)
    rb.line(CONSTL=G2X, assert_=0, setC=1)
    rb.line("A - C => D", inA=1, inC=-1, setD=1)


def air_program(rb, sm):
    """test_main_sm.py's AIR program (its `_air_program`)."""
    rb.line("7 => A", CONST=7, setA=1)
    rb.line("5 => B", CONST=5, setB=1)
    rb.line("A + B => C", inA=1, inB=1, setC=1)
    rb.line("12 => A", CONST=12, setA=1)
    rb.line("C :ASSERT", inC=1, assert_=1)
    rb.line("3 => RCX", CONST=3, setRCX=1)
    rb.line("D + 1 => D :REPEAT", inD=1, CONST=1, setD=1, repeat=1)
    rb.call("sub")
    rb.line("2 => A", CONST=2, setA=1)
    rb.label("loop")
    rb.line("A - 1 => A :JMPN(out)", inA=1, CONST=-1, setA=1,
            JMPN=1, useJmpAddr=1, jmpAddr="out")
    rb.jmp("loop")
    rb.label("sub")
    rb.line("E + 1 => E", inE=1, CONST=1, setE=1)
    rb.ret()
    rb.label("out")
    rb.line(":JMPZ(z, nz)", CONST=0, JMPZ=1, useJmpAddr=1, jmpAddr="z",
            useElseAddr=1, elseAddr="nz")
    rb.label("nz")
    rb.line(CONST=999, setB=1)
    rb.label("z")
    rb.line(CONSTL=3, setA=1)
    rb.line(CONSTL=5, setB=1)
    rb.line(CONSTL=1, setC=1)
    rb.line(CONSTL=0, setD=1)
    rb.line("$ => E :ARITH", inFREE=1, arithEq0=1, setE=1)
    rb.line("CNT_ARITH => B", inCntArith=1, setB=1)
    rb.line(CONST=1, setA=1)
    rb.line("B :ASSERT", inB=1, assert_=1)


def combined_mb(rb, sm):
    """test_combined_air.py's `_rom` (memory and binary)."""
    rb.line(CONSTL=0xCAFEBABE_12345678, setA=1)
    rb.line("A :MSTORE(3)", inA=1, mOp=1, mWR=1, offset=3)
    rb.line(":MLOAD(3) => B", inFREE=1, mOp=1, offset=3, setB=1)
    rb.line("A == B :ASSERT", inB=1, assert_=1)
    rb.line(CONSTL=7, setA=1)
    rb.line("A :MSTORE(9)", inA=1, mOp=1, mWR=1, offset=9)
    rb.line(CONSTL=(1 << 256) - 2, setA=1)
    rb.line(CONSTL=5, setB=1)
    rb.line("$ => C :ADD :JMPC(carried)", inFREE=1, bin=1, binOpcode=0,
            setC=1, JMPC=1, useJmpAddr=1, jmpAddr="carried")
    rb.line(CONST=123, setE=1)
    rb.label("carried")
    rb.line("$ => D :SLT", inFREE=1, bin=1, binOpcode=3, setD=1)


def combined_ma(rb, sm):
    """test_combined_air.py's `_ma_rom` (mem_align)."""
    m0 = 0x11223344_55667788_99AABBCC_DDEEFF00_A1A2A3A4_A5A6A7A8 << 64
    m1 = 0xB1B2B3B4 << 200 | 0xC5C6
    val = 0xDEADBEEF_CAFEF00D << 96 | 0x42
    off = 5
    nw0, nw1 = sm.mem_align.result(
        {"op": "wr", "w0": m1, "w1": m0, "offset": 32 - off, "value": val})
    rb.line(CONSTL=m0, setA=1)
    rb.line(CONSTL=m1, setB=1)
    rb.line(CONST=off, setC=1)
    rb.line(CONSTL=nw1, setD=1)
    rb.line(CONSTL=nw0, setE=1)
    rb.line("value :MEM_ALIGN_WR", CONSTL=val, memAlignWR=1)
    rb.line(CONST=9, setC=1)
    rb.line("$ => D :MEM_ALIGN_RD", inFREE=1, memAlignRD=1, setD=1)


def combined_ar(rb, sm):
    """test_combined_air.py's `_ar_rom` (arith: eq0, eq2, eq4)."""
    rb.line(CONSTL=3, setA=1)
    rb.line(CONSTL=5, setB=1)
    rb.line(CONSTL=7, setC=1)
    rb.line(CONSTL=0, setD=1)
    rb.line("A*B+C :ARITH", CONSTL=22, arithEq0=1)
    g2x, g2y = sm.arith.ec_result("dbl", GX, GY)
    rb.line(CONSTL=GX, setA=1)
    rb.line(CONSTL=GY, setB=1)
    rb.line(CONSTL=g2x, setE=1)
    rb.line("dbl :ARITH_ECADD_SAME", CONSTL=g2y, arithEq2=1)
    rb.line(CONSTL=11, setA=1)
    rb.line(CONSTL=22, setB=1)
    rb.line(CONSTL=33, setC=1)
    rb.line(CONSTL=44, setD=1)
    rb.line(CONSTL=44, setE=1)
    rb.line("addfp2 :ARITH_BN254_ADDFP2", CONSTL=66, arithEq4=1)


def combined_storage(rb, sm):
    """test_combined_air.py's `_storage_rom`."""
    rb.line(CONST=0x1234, setA=1)
    rb.line(CONST=3, setB=1)
    rb.line(CONST=7, setC=1)
    rb.line(CONST=777, setD=1)
    rb.line("$ => SR :SSTORE", inFREE=1, sWR=1, setSR=1)
    rb.line("$ => E :SLOAD", inFREE=1, sRD=1, setE=1)
    rb.line(CONST=777, setA=1)
    rb.line("E :ASSERT", inE=1, assert_=1)


def hash_keccak(rb, sm):
    """test_hash_pipeline.py's keccak `_rom`."""
    rb.line(CONST=5, setD=1)
    rb.line("0x68656C6C6F :HASHK(0x100)",
            CONSTL=int.from_bytes(b"hello", "big"), hashK=1, offset=0x100)
    rb.line("0x21 :HASHK1(0x100)", CONSTL=0x21, hashK1=1, offset=0x100)
    rb.line("6 :HASHKLEN(0x100)", CONSTL=6, hashKLen=1, offset=0x100)
    rb.line("$ => A :HASHKDIGEST(0x100)", inFREE=1, hashKDigest=1,
            offset=0x100, setA=1)
    rb.line("0 :HASHKLEN(0x200)", CONSTL=0, hashKLen=1, offset=0x200)
    rb.line("$ => B :HASHKDIGEST(0x200)", inFREE=1, hashKDigest=1,
            offset=0x200, setB=1)


def hash_sha(rb, sm):
    """test_hash_pipeline.py's `_sha_rom`."""
    rb.line(CONST=4, setD=1)
    rb.line("0xDEADBEEF :HASHS(0x40)", CONSTL=0xDEADBEEF, hashS=1,
            offset=0x40)
    rb.line("4 :HASHSLEN(0x40)", CONSTL=4, hashSLen=1, offset=0x40)
    rb.line("$ => A :HASHSDIGEST(0x40)", inFREE=1, hashSDigest=1,
            offset=0x40, setA=1)


def hash_pg(rb, sm):
    """test_hash_pipeline.py's `_pg_rom`."""
    rb.line(CONST=3, setD=1)
    rb.line("0xAABBCC :HASHP(0x30)", CONSTL=0xAABBCC, hashP=1, offset=0x30)
    rb.line("3 :HASHPLEN(0x30)", CONSTL=3, hashPLen=1, offset=0x30)
    rb.line("$ => A :HASHPDIGEST(0x30)", inFREE=1, hashPDigest=1,
            offset=0x30, setA=1)


# body -> ends with clear_registers() + finalize(), as the JAX tests build
# every ROM but the failing-assert one
BODIES = {f.__name__: f for f in (
    selectors_setters_assert, failing_assert, constl_and_rotl_c,
    jumps_call_return_repeat, free_input_command_and_memory_ops,
    storage_srd_swr, hash_keccak_pipeline, binary_and_arith_actions,
    arith_ec_ops, air_program, combined_mb, combined_ma, combined_ar,
    combined_storage, hash_keccak, hash_sha, hash_pg)}


class _Mods:
    def __init__(self, arith, mem_align):
        self.arith, self.mem_align = arith, mem_align


JAX_SM = _Mods(jarith, jmem_align)
TORCH_SM = _Mods(tarith, tmem_align)


def build(name: str, port: bool = True):
    """The ROM of body `name`, built by the port's RomBuilder (or the JAX
    package's), closed as the JAX tests close it."""
    rb = (trom if port else jrom).RomBuilder()
    BODIES[name](rb, TORCH_SM if port else JAX_SM)
    rb.clear_registers()
    rb.finalize()
    return rb.build()


def line_fields(rom) -> list:
    """Every line's attributes (the dataclass fields and the selector,
    flag and int fields set on it) as plain dicts."""
    return [dict(vars(ln)) for ln in rom.lines]


def assert_roms_equal(a, b):
    assert len(a) == len(b)
    assert line_fields(a) == line_fields(b)
    assert a.labels == b.labels
    assert a.constants == b.constants
    assert a.memory_map == b.memory_map


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(BODIES))
def test_rom_builder_matches_jax(name):
    assert_roms_equal(build(name), build(name, port=False))


@pytest.mark.parametrize("name", list(BODIES))
def test_to_json_loads_equal_in_both_packages(name):
    """The port's `Rom.to_json` text loads, through either package's
    `Rom.from_json`, to the ROM its `RomBuilder` made."""
    text = json.dumps(build(name).to_json())
    assert_roms_equal(trom.Rom.from_json(json.loads(text)), build(name))
    assert_roms_equal(jrom.Rom.from_json(json.loads(text)),
                      build(name, port=False))


def test_from_json_reference_schema():
    """One JSON text in the reference schema (negative selectors, string
    constants, renamed keywords, commands, display-only keys) loads to
    equal ROMs in both packages."""
    text = json.dumps({
        "program": [
            {"inA": "-1", "inB": "3", "setC": 1, "CONST": "-5",
             "lineStr": "B*3 - A - 5 => C", "fileName": "t.zkasm",
             "line": 4},
            {"CONSTL": str((1 << 256) + 7), "setA": 1,
             "cmdBefore": [{"op": "declareVar", "varName": "x"}]},
            {"freeInTag": {"op": "number", "num": "9"}, "inFREE": "1",
             "setD": 1, "offset": 3, "offsetLabel": "slot", "mOp": 1,
             "mWR": 1, "cmdAfter": [{"op": "getVar", "varName": "x"}]},
            {"assert": 1, "inA": "1"},
            {"return": 1, "JMPN": 1, "jmpAddr": 0, "jmpAddrLabel": "start",
             "useJmpAddr": 1, "freeInTag": {"op": ""}},
        ],
        "labels": {"start": 0, "end": 4},
        "constants": {"K": {"value": "12"}},
    })
    port = trom.Rom.from_json(json.loads(text))
    jax_ = jrom.Rom.from_json(json.loads(text))
    assert_roms_equal(port, jax_)
    assert port.memory_map == {"slot": 3}
    assert port.lines[0].inA == trom.P - 1 and port.lines[0].bConst


def test_small_rom_batch_rom_round_trips():
    """The straight-line ROM of `examples.small_rom_batch` (the pinned
    combined proof's program) loads equal in both packages from its
    JSON text."""
    _, _, batch = examples.small_rom_batch("cpu")
    text = json.dumps(batch.rom.to_json())
    assert_roms_equal(trom.Rom.from_json(json.loads(text)), batch.rom)
    assert line_fields(jrom.Rom.from_json(json.loads(text))) \
        == line_fields(batch.rom)
