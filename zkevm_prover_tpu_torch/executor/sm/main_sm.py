"""Main SM — the zk-ASM ROM interpreter and its AIR.

Port of `zkevm_prover_tpu/executor/sm/main_sm.py` (host-only numpy): the
same columns, ROM table, AIR, trace, actions and counters.

Reference: src/main_sm/fork_9/main/main_executor.cpp (fetch-decode-execute
loop at :297-5400, op-selector accumulation :452-755, jump logic
:5040-5230, setters :4700-5000) and the fork_9 main PIL semantics. The
executor walks the ROM one line per trace row: it accumulates
`op = Σ inX·X + CONST` across the register file, resolves free inputs
(command ASTs or flag-derived values: memory reads, SMT reads/writes, hash
digests), dispatches co-processor actions, applies the set* register
writebacks, and computes the next zkPC (JMP/JMPN/JMPC/JMPZ/call/return/
repeat).

Design notes (as in the JAX package):
  * The trace is generated on the host (it is inherently sequential and
    data-dependent — the same split the reference uses: C++ executor fills
    pols, GPU/AVX proves); the AIR constraint evaluation, LDE, Merkle and
    FRI run on the prover's device.
  * The ROM program is bound with ONE wide plookup: the committed per-row
    instruction columns (selectors, setters, jump flags, CONST limbs,
    addresses) must match some line of the ROM constant table at the row's
    zkPC. pil-stark reaches the same binding through main.pil's Rom lookup.
  * PIL intermediate expressions that would push constraint degree past the
    blowup budget (op, doJMP, stay, isRcxNZ, isOpZero) are materialized as
    committed columns with degree-2/3 defining identities — exactly the
    role of pil-stark's `im` polynomials.
  * The JMPN 32-bit range proof is domain-adaptive: lJmpnCondValue +
    hJmpnCondValueBit[9] (commit_pols.hpp:1470-1471) assume N = 2^23; here
    the condition value is decomposed into ceil(32/b) chunks of
    b = min(n_bits, 16) bits, each range-checked by plookup, so small test
    domains carry the same soundness.

Co-processor binding happens in the combined batch AIR
(executor/combined.py): memory/binary/storage/poseidon/climbkey/memalign/
arith permutations+lookups, the hash-pipeline chains, and the committed
incCounter (INCCNT) driving the in-circuit counter transitions. Publics
live in fixed trace cells and are boundary-constrained (reference publics
layout, prover.cpp:494-560).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...ops import goldilocks as gl
from ...ops import keccak as keccak_mod
from ...ops import refmodel as rm
from ...ops import sha256 as sha256_mod
from ...ops import poseidon_constants as pc
from ...stark import expr as ex
from ...stark.air import AIR
from .. import eval_command as evc
from ..rom import Rom

P = gl.P
MASK32 = 0xFFFFFFFF
MASK256 = (1 << 256) - 1

# address-space offsets (main_executor.cpp:841-866)
CTX_OFFSET = 0x40000
STACK_OFFSET = 0x10000
MEM_OFFSET = 0x20000

REGS8 = ("A", "B", "C", "D", "E", "SR")
SCALAR_REGS = ("CTX", "SP", "PC", "GAS", "RR", "HASHPOS", "RCX")

# committed instruction columns bound to the ROM table by the plookup,
# as (column name, rom-line attribute)
BOUND_FLAG_COLS = [
    ("inA", "inA"), ("inB", "inB"), ("inC", "inC"), ("inD", "inD"),
    ("inE", "inE"), ("inSR", "inSR"), ("inROTL_C", "inROTL_C"),
    ("inFREE", "inFREE"), ("inFREE0", "inFREE0"),
    ("inCTX", "inCTX"), ("inSP", "inSP"), ("inPC", "inPC"),
    ("inGAS", "inGAS"), ("inSTEP", "inSTEP"), ("inRR", "inRR"),
    ("inHASHPOS", "inHASHPOS"), ("inRCX", "inRCX"),
    ("setA", "setA"), ("setB", "setB"), ("setC", "setC"), ("setD", "setD"),
    ("setE", "setE"), ("setSR", "setSR"), ("setCTX", "setCTX"),
    ("setSP", "setSP"), ("setPC", "setPC"), ("setGAS", "setGAS"),
    ("setRR", "setRR"), ("setHASHPOS", "setHASHPOS"), ("setRCX", "setRCX"),
    ("JMP", "JMP"), ("JMPN", "JMPN"), ("JMPC", "JMPC"), ("JMPZ", "JMPZ"),
    ("CALL", "call"), ("RETURN", "return_"), ("REPEAT", "repeat"),
    ("useJmpAddr", "useJmpAddr"), ("useElseAddr", "useElseAddr"),
    ("useCTX", "useCTX"), ("isStack", "isStack"), ("isMem", "isMem"),
    ("mOp", "mOp"), ("mWR", "mWR"), ("ASSERT", "assert_"),
    ("BIN", "bin"), ("BINOP", "binOpcode"),
    ("SRD", "sRD"), ("SWR", "sWR"),
    ("MEMALIGNRD", "memAlignRD"), ("MEMALIGNWR", "memAlignWR"),
    ("MEMALIGNWR8", "memAlignWR8"),
    ("ARITHEQ0", "arithEq0"), ("ARITHEQ1", "arithEq1"),
    ("ARITHEQ2", "arithEq2"), ("ARITHEQ3", "arithEq3"),
    ("ARITHEQ4", "arithEq4"), ("ARITHEQ5", "arithEq5"),
    ("HASHK", "hashK"), ("HASHK1", "hashK1"),
    ("HASHKLEN", "hashKLen"), ("HASHKDIGEST", "hashKDigest"),
    ("HASHP", "hashP"), ("HASHP1", "hashP1"),
    ("HASHPLEN", "hashPLen"), ("HASHPDIGEST", "hashPDigest"),
    ("HASHS", "hashS"), ("HASHS1", "hashS1"),
    ("HASHSLEN", "hashSLen"), ("HASHSDIGEST", "hashSDigest"),
    ("inCntArith", "inCntArith"), ("inCntBinary", "inCntBinary"),
    ("inCntMemAlign", "inCntMemAlign"),
    ("inCntKeccakF", "inCntKeccakF"), ("inCntSha256F", "inCntSha256F"),
    ("inCntPoseidonG", "inCntPoseidonG"),
    ("inCntPaddingPG", "inCntPaddingPG"),
    ("jmpAddr", "jmpAddr"), ("elseAddr", "elseAddr"),
    ("OFFSET", "offset"), ("IND", "ind"), ("INDRR", "indRR"),
    ("INCSTACK", "incStack"),
]
CONST_COLS = [f"CONST{l}" for l in range(8)]

# instruction-count increments derived from the line's co-processor flags
# (these join the ROM table so the counter transitions are bound)
DERIVED_COLS = [
    ("INCA", lambda ln: 1 if (ln.arithEq0 or ln.arithEq1 or ln.arithEq2
                              or ln.arithEq3 or ln.arithEq4 or ln.arithEq5)
     else 0),
    ("INCB", lambda ln: 1 if ln.bin else 0),
    ("INCM", lambda ln: 1 if (ln.memAlignRD or ln.memAlignWR
                              or ln.memAlignWR8) else 0),
]
# counter registers with in-AIR transitions driven by ROM-derived
# increments
CNT_COLS = [("CNT_ARITH", "inCntArith", "INCA"),
            ("CNT_BINARY", "inCntBinary", "INCB"),
            ("CNT_MEMALIGN", "inCntMemAlign", "INCM")]

# counter registers whose increments are data-dependent: a committed
# incCounter column (INCCNT) joins the transition on the flagged rows and
# is bound in the combined AIR — to the padding SMs' per-message block
# count (BLKCNT) on hashXDigest rows, and to the Storage SM's PHC (+2 key
# hashes) on sRD/sWR rows. Reference: pols.incCounter + the cntKeccakF /
# cntPaddingPG / cntSha256F / cntPoseidonG updates,
# main_executor.cpp:5250-5330.
HASH_CNT_COLS = [
    ("CNT_KECCAK_F", "inCntKeccakF", ("HASHKDIGEST",)),
    ("CNT_PADDING_PG", "inCntPaddingPG", ("HASHPDIGEST",)),
    ("CNT_SHA256_F", "inCntSha256F", ("HASHSDIGEST",)),
    ("CNT_POSEIDON_G", "inCntPoseidonG", ("SRD", "SWR", "HASHPDIGEST")),
]


def _reg8_cols():
    return [f"{r}{l}" for r in REGS8 for l in range(8)]


def columns(n_bits: int) -> list[str]:
    """Committed column names, in trace order."""
    b = min(n_bits, 16)
    k = -(-32 // b)
    return (
        _reg8_cols()
        + list(SCALAR_REGS) + ["zkPC"]
        + [f"FREE{l}" for l in range(8)]
        + [f"OP{l}" for l in range(8)]
        + [c for c, _ in BOUND_FLAG_COLS]
        + CONST_COLS
        + ["ADDR", "CARRY", "ISNEG", "ISOPZ", "OP0INV", "RCXINV",
           "ISRCXNZ", "STAY", "DOJMP", "INCHASHPOS"]
        + [f"KI{j}" for j in range(4)] + [f"KEY{j}" for j in range(4)]
        + [name for name, _ in DERIVED_COLS]
        + [name for name, _, _ in CNT_COLS]
        + [name for name, _, _ in HASH_CNT_COLS] + ["INCCNT"]
        + [f"JMPN_CH{j}" for j in range(k)]
    )


def rom_table(rom: Rom, n: int) -> dict[str, np.ndarray]:
    """ROM constant columns over line index (zero-padded past the program)."""
    assert len(rom) <= n, f"program ({len(rom)} lines) exceeds domain ({n})"
    t = {"LINE": np.arange(n, dtype=np.uint64)}
    for col, attr in BOUND_FLAG_COLS:
        vals = np.zeros(n, dtype=np.uint64)
        for i, ln in enumerate(rom.lines):
            vals[i] = int(getattr(ln, attr)) % P
        t[col] = vals
    for l in range(8):
        vals = np.zeros(n, dtype=np.uint64)
        for i, ln in enumerate(rom.lines):
            vals[i] = _const_limb(ln, l)
        t[f"CONST{l}"] = vals
    for name, fn in DERIVED_COLS:
        vals = np.zeros(n, dtype=np.uint64)
        for i, ln in enumerate(rom.lines):
            vals[i] = fn(ln)
        t[name] = vals
    return t


def _const_limb(ln, l: int) -> int:
    if ln.bConstL:
        return (ln.CONSTL >> (32 * l)) & MASK32
    if ln.bConst and l == 0:
        return ln.CONST % P
    return 0


def build_air(rom: Rom, n_bits: int) -> AIR:
    n = 1 << n_bits
    air = AIR("main", n_bits)
    names = columns(n_bits)
    handles = air.committed(*names)
    c = dict(zip(names, handles))

    def nxt(col):
        return ex.Cm(c[col].id, True)

    STEP = air.constant("STEP", np.arange(n, dtype=np.uint64))
    l1 = air.lagrange_first()

    # -- ROM binding: one wide plookup ------------------------------------
    tbl = rom_table(rom, n)
    tcols = [air.constant(f"ROM_{k}", v) for k, v in tbl.items()]
    fcols = [c["zkPC"]] + [c[col] for col, _ in BOUND_FLAG_COLS] \
        + [c[col] for col in CONST_COLS] \
        + [c[name] for name, _ in DERIVED_COLS]
    air.lookup(fcols, tcols)

    # -- op accumulation (materialized im pols) ---------------------------
    for l in range(8):
        acc = ex.Number(0)
        for r in REGS8:
            acc = acc + c[f"in{r}"] * c[f"{r}{l}"]
        acc = acc + c["inROTL_C"] * c[f"C{(l + 7) % 8}"]
        acc = acc + c["inFREE"] * c[f"FREE{l}"]
        acc = acc + c[f"CONST{l}"]
        if l == 0:
            for s in SCALAR_REGS:
                acc = acc + c[f"in{s}"] * c[s]
            acc = acc + c["inSTEP"] * STEP
            acc = acc + c["inFREE0"] * c["FREE0"]
            for cname, insel, _ in CNT_COLS:
                acc = acc + c[insel] * c[cname]
            for cname, insel, _ in HASH_CNT_COLS:
                acc = acc + c[insel] * c[cname]
        air.require_zero(c[f"OP{l}"] - acc)

    # -- ASSERT: op == A --------------------------------------------------
    for l in range(8):
        air.require_zero(c["ASSERT"] * (c[f"OP{l}"] - c[f"A{l}"]))

    # -- register write-back (cyclic: row N-1 wraps onto row 0) -----------
    for r in REGS8:
        s = c[f"set{r}"]
        for l in range(8):
            air.require_zero(
                nxt(f"{r}{l}") - s * c[f"OP{l}"] - (1 - s) * c[f"{r}{l}"])
    for s_name, extra in (("CTX", None), ("PC", None), ("GAS", None)):
        s = c[f"set{s_name}"]
        air.require_zero(nxt(s_name) - s * c["OP0"] - (1 - s) * c[s_name])
    # SP' = setSP·op0 + (1-setSP)·(SP + incStack)
    s = c["setSP"]
    air.require_zero(
        nxt("SP") - s * c["OP0"] - (1 - s) * (c["SP"] + c["INCSTACK"]))
    # RR' = setRR·op0 + (1-setRR)·(call·(zkPC+1) + (1-call)·RR)
    s = c["setRR"]
    air.require_zero(
        nxt("RR") - s * c["OP0"]
        - (1 - s) * (c["CALL"] * (c["zkPC"] + 1) + (1 - c["CALL"]) * c["RR"]))
    # RCX' = setRCX·op0 + (1-setRCX)·(RCX - repeat·isRcxNZ)
    s = c["setRCX"]
    air.require_zero(
        nxt("RCX") - s * c["OP0"]
        - (1 - s) * (c["RCX"] - c["REPEAT"] * c["ISRCXNZ"]))
    # HASHPOS' = setHASHPOS·op0 + (1-setHASHPOS)·HASHPOS + incHashPos
    s = c["setHASHPOS"]
    air.require_zero(
        nxt("HASHPOS") - c["INCHASHPOS"] - s * c["OP0"]
        - (1 - s) * c["HASHPOS"])

    # -- RCX / OP0 zero-flag machinery ------------------------------------
    air.require_zero(c["ISRCXNZ"] - c["RCX"] * c["RCXINV"])
    air.require_zero(c["RCX"] * (1 - c["ISRCXNZ"]))
    air.require_zero(c["STAY"] - c["REPEAT"] * c["ISRCXNZ"])
    air.require_zero(
        c["JMPZ"] * (c["ISOPZ"] - (1 - c["OP0"] * c["OP0INV"])))
    air.require_zero(c["JMPZ"] * c["OP0"] * c["ISOPZ"])

    # -- JMPN: prove op0 in (-2^32, 2^32) ---------------------------------
    b = min(n_bits, 16)
    k = -(-32 // b)
    air.require_zero(c["ISNEG"] * (1 - c["ISNEG"]))
    air.require_zero((1 - c["JMPN"]) * c["ISNEG"])
    acc = ex.Number(0)
    for j in range(k):
        acc = acc + c[f"JMPN_CH{j}"] * (1 << (j * b))
    air.require_zero(
        acc - c["JMPN"] * (c["ISNEG"] * (1 << 32) + c["OP0"]))
    full = air.constant(
        "RANGE", np.arange(n, dtype=np.uint64) & ((1 << b) - 1))
    top_w = 32 - (k - 1) * b
    top = air.constant(
        "RANGE_TOP", np.arange(n, dtype=np.uint64) % (1 << top_w))
    for j in range(k):
        air.lookup([c[f"JMPN_CH{j}"]], [top if j == k - 1 else full],
                   sel_f=c["JMPN"])

    # -- carry (bound host-side to the Binary SM for now) -----------------
    air.require_zero(c["CARRY"] * (1 - c["CARRY"]))

    # -- hash-stream shape: INCHASHPOS is exactly the instruction's byte
    # count (D0 bytes, or 1 for the single-byte forms) and zero elsewhere;
    # hashXLen rows carry the length in op0 alone (reference main.pil's
    # incHashPos wiring, main_executor.cpp:2660-2758)
    air.require_zero(
        c["INCHASHPOS"]
        - (c["HASHK"] + c["HASHS"] + c["HASHP"]) * c["D0"]
        - (c["HASHK1"] + c["HASHS1"] + c["HASHP1"]))
    len_any = c["HASHKLEN"] + c["HASHSLEN"] + c["HASHPLEN"]
    for l in range(1, 8):
        air.require_zero(len_any * c[f"OP{l}"])

    # -- memAlign offset shape: C is a single sub-64 limb on memAlign rows
    # (the offset register; reference main_executor.cpp:4484-4520 reads C
    # as a scalar and requires <= 32)
    ma_any = c["MEMALIGNRD"] + c["MEMALIGNWR"] + c["MEMALIGNWR8"]
    for l in range(1, 8):
        air.require_zero(ma_any * c[f"C{l}"])

    # -- memory address ----------------------------------------------------
    air.require_zero(
        c["ADDR"] - (c["OFFSET"] + c["IND"] * c["E0"] + c["INDRR"] * c["RR"]
                     + c["isStack"] * c["SP"]
                     + c["useCTX"] * c["CTX"] * CTX_OFFSET
                     + c["isStack"] * STACK_OFFSET + c["isMem"] * MEM_OFFSET))

    # -- control flow ------------------------------------------------------
    air.require_zero(
        c["DOJMP"] - (c["JMP"] + c["CALL"] + c["JMPN"] * c["ISNEG"]
                      + c["JMPC"] * c["CARRY"] + c["JMPZ"] * c["ISOPZ"]))
    dest = c["useJmpAddr"] * c["jmpAddr"] + (1 - c["useJmpAddr"]) * c["ADDR"]
    els = c["useElseAddr"] * c["elseAddr"] \
        + (1 - c["useElseAddr"]) * (c["zkPC"] + 1)
    air.require_zero(
        nxt("zkPC") - c["RETURN"] * c["RR"]
        - (1 - c["RETURN"]) * (
            c["DOJMP"] * dest
            + (1 - c["DOJMP"]) * (c["STAY"] * c["zkPC"]
                                  + (1 - c["STAY"]) * els)))
    air.require_zero(l1 * c["zkPC"])

    # -- instruction counters (reset at the wrap; reference cntArith etc.) -
    last = np.zeros(n, dtype=np.uint64)
    last[n - 1] = 1
    LLAST = air.constant("__LLAST", last)
    for cname, _, inc in CNT_COLS:
        air.require_zero(
            nxt(cname) - (1 - LLAST) * (c[cname] + c[inc]))
    # data-dependent counters: the committed incCounter joins on the
    # flagged rows (its value is bound cross-SM in the combined AIR)
    for cname, _, flags in HASH_CNT_COLS:
        sel = c[flags[0]]
        for fl in flags[1:]:
            sel = sel + c[fl]
        air.require_zero(
            nxt(cname) - (1 - LLAST) * (c[cname] + sel * c["INCCNT"]))

    # -- publics: the batch-chaining values live in fixed trace cells
    # (reference publics layout, prover.cpp:494-560: oldStateRoot = B@0,
    # oldAccInputHash = C@0, oldBatchNum = SP@0, chainId = GAS@0,
    # forkid = CTX@0, newStateRoot = SR@lastN, newAccInputHash = D@lastN,
    # localExitRoot = E@lastN, newBatchNum = PC@lastN)
    lastN = n - 1
    for l in range(8):
        p = air.public(f"oldStateRoot{l}", c[f"B{l}"], 0)
        air.require_zero(l1 * (c[f"B{l}"] - p))
    for l in range(8):
        p = air.public(f"oldAccInputHash{l}", c[f"C{l}"], 0)
        air.require_zero(l1 * (c[f"C{l}"] - p))
    for nm, reg in (("oldBatchNum", "SP"), ("chainId", "GAS"),
                    ("forkid", "CTX")):
        p = air.public(nm, c[reg], 0)
        air.require_zero(l1 * (c[reg] - p))
    for l in range(8):
        p = air.public(f"newStateRoot{l}", c[f"SR{l}"], lastN)
        air.require_zero(LLAST * (c[f"SR{l}"] - p))
    for l in range(8):
        p = air.public(f"newAccInputHash{l}", c[f"D{l}"], lastN)
        air.require_zero(LLAST * (c[f"D{l}"] - p))
    for l in range(8):
        p = air.public(f"newLocalExitRoot{l}", c[f"E{l}"], lastN)
        air.require_zero(LLAST * (c[f"E{l}"] - p))
    p = air.public("newBatchNum", c["PC"], lastN)
    air.require_zero(LLAST * (c["PC"] - p))
    return air


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------


class ExecutorError(Exception):
    def __init__(self, msg, step=None, zk_pc=None, line=None):
        loc = f" step={step} zkPC={zk_pc}"
        if line is not None and line.line_str:
            loc += f" [{line.line_str.strip()}]"
        super().__init__(msg + loc)


@dataclasses.dataclass
class MainResult:
    trace: np.ndarray            # (N, n_columns) in `columns()` order
    actions: object              # executor.BatchActions
    counters: dict
    logs: list
    mem: dict
    new_state_root: tuple | None
    last_step: int = 0           # step at finalizeExecution (reference
    #                              ctx.lastStep; 0 = label never reached)


class _HashState:
    __slots__ = ("data", "length", "digest", "digest_called", "len_called",
                 "reads", "first_byte_written")

    def __init__(self):
        self.data = bytearray()
        self.length = None
        self.digest = None
        self.digest_called = False
        self.len_called = False
        self.reads = {}  # pos -> size (reference HashValue.reads)
        self.first_byte_written = False  # hashP byte-0 reservation


# binOpcode numbering (main_executor.cpp binary dispatch; 8 = LT4, the
# fork-7+ per-64-bit-chunk comparison, scalar.hpp:516-531)
BIN_OPS = {0: "ADD", 1: "SUB", 2: "LT", 3: "SLT", 4: "EQ", 5: "AND",
           6: "OR", 7: "XOR", 8: "LT4"}


def _bin_result(opname: str, a: int, b: int) -> tuple[int, int]:
    """(result, carry) with 256-bit EVM semantics."""
    if opname == "ADD":
        s = a + b
        return s & MASK256, s >> 256
    if opname == "SUB":
        return (a - b) & MASK256, 1 if a < b else 0
    if opname == "LT":
        return int(a < b), int(a < b)
    if opname == "SLT":
        sa = a - (1 << 256) if a >> 255 else a
        sb = b - (1 << 256) if b >> 255 else b
        return int(sa < sb), int(sa < sb)
    if opname == "EQ":
        return int(a == b), int(a == b)
    if opname == "AND":
        r = a & b
        return r, int(r != 0)
    if opname == "OR":
        return a | b, 0
    if opname == "XOR":
        return a ^ b, 0
    if opname == "LT4":
        m = (1 << 64) - 1
        r = int(all(((a >> (64 * i)) & m) < ((b >> (64 * i)) & m)
                    for i in range(4)))
        return r, r
    raise ValueError(opname)


@dataclasses.dataclass(frozen=True)
class _LinePlan:
    """Per-ROM-line precompiled execution plan — the interpreter-side
    analogue of the reference's generated main executor (mainGenerator
    emits one unrolled C++ block per line, main_generator.cpp:26-80; here
    the per-line work is folded into arrays/tuples once so the hot loop
    never formats f-strings or scans zero selectors)."""
    static_idx: np.ndarray   # trace columns fixed by the line (flags, ...)
    static_vals: np.ndarray
    const8: tuple            # CONST limb values
    in8: tuple               # ((sel, reg_name), ...) nonzero 8-limb sels
    in_rotl: int
    in_scal: tuple           # ((sel, scalar_name), ...)
    in_step: int
    in_cnt: tuple            # ((sel, counter_name), ...)
    set8: tuple              # reg names with set<reg>
    set_scal: tuple          # subset of ("CTX", "PC", "GAS") with set<s>
    derived: tuple           # (INCA, INCB, INCM) counter increments


def _build_plans(rom: Rom, col: dict) -> list[_LinePlan]:
    plans = []
    for zkpc, ln in enumerate(rom.lines):
        idx, vals = [col["zkPC"]], [zkpc]
        for cname, attr in BOUND_FLAG_COLS:
            idx.append(col[cname])
            vals.append(int(getattr(ln, attr)) % P)
        const8 = tuple(_const_limb(ln, l) for l in range(8))
        for l in range(8):
            idx.append(col[f"CONST{l}"])
            vals.append(const8[l])
        for name, fn in DERIVED_COLS:
            idx.append(col[name])
            vals.append(fn(ln))
        in8 = tuple((getattr(ln, f"in{r}"), r) for r in REGS8
                    if getattr(ln, f"in{r}"))
        in_scal = tuple((getattr(ln, f"in{s}"), s) for s in SCALAR_REGS
                        if getattr(ln, f"in{s}"))
        in_cnt = tuple(
            (getattr(ln, insel), name)
            for name, insel, _ in (CNT_COLS + HASH_CNT_COLS)
            if getattr(ln, insel))
        plans.append(_LinePlan(
            static_idx=np.array(idx, dtype=np.intp),
            static_vals=np.array(vals, dtype=np.uint64),
            const8=const8,
            in8=in8,
            in_rotl=ln.inROTL_C,
            in_scal=in_scal,
            in_step=ln.inSTEP,
            in_cnt=in_cnt,
            set8=tuple(r for r in REGS8 if getattr(ln, f"set{r}")),
            set_scal=tuple(s for s in ("CTX", "PC", "GAS")
                           if getattr(ln, f"set{s}")),
            derived=tuple(fn(ln) for _, fn in DERIVED_COLS),
        ))
    return plans


class MainExecutor:
    """Host-side fetch-decode-execute over a ROM; one trace row per step.

    `smt` is a hashdb.smt.Smt (or None to disallow sRD/sWR); `input` is the
    batch input dict (timestamp, batchL2Data, oldStateRoot as 4-tuple, ...).
    """

    def __init__(self, rom: Rom, n_bits: int):
        self.rom = rom
        self.n_bits = n_bits
        self.n = 1 << n_bits
        self.on_step = None  # optional debug hook: (step, zk_pc, ln, ctx)
        self._plans = None   # built lazily on first execute()

    def execute(self, input: dict | None = None, smt=None,
                process_batch: bool = False, full_tracer=None,
                hash_oracles: dict | None = None) -> MainResult:
        """Interpret the ROM.  With `process_batch` (the reference's
        bProcessBatch fast path, main_executor.cpp:5398-5409) the loop
        breaks as soon as the `finalizeExecution` label executes and no
        full trace is materialized — the mode ProcessBatch RPCs and
        executability checks use; proving requires the full-trace mode."""
        from ..executor import BatchActions

        rom, n = self.rom, self.n
        inp = dict(input or {})
        # digest oracles, overridable so reduced-round gate circuits stay
        # consistent end to end in tests (production: real keccak/sha)
        self._hash_oracles = hash_oracles or {}
        actions = BatchActions()
        names = columns(self.n_bits)
        col = {nm: i for i, nm in enumerate(names)}
        finalize_label = rom.labels.get("finalizeExecution")
        if process_batch:
            tr = np.zeros((1, len(names)), dtype=np.uint64)  # scratch row
        else:
            tr = np.zeros((n, len(names)), dtype=np.uint64)
        b = min(self.n_bits, 16)
        k_ch = -(-32 // b)

        # machine state
        regs8 = {r: [0] * 8 for r in REGS8}
        scal = {s: 0 for s in SCALAR_REGS}
        zk_pc = 0
        mem: dict[int, list[int]] = {}
        hash_k: dict[int, _HashState] = {}
        hash_p: dict[int, _HashState] = {}
        hash_s: dict[int, _HashState] = {}
        counters = {k: 0 for k in ("arith", "binary", "memAlign", "keccakF",
                                   "sha256F", "poseidonG", "paddingPG")}
        # bNoCounters (process-batch only): inSTEP reads 0 and the cnt*
        # registers never advance, so the ROM's out-of-counters JMPN checks
        # can't fire (reference main_executor.cpp:602 fork_7 / :507 fork_5,
        # and the !bNoCounters guards on every counter increment)
        no_counters = bool(inp.get("noCounters")) and process_batch
        cnt_regs = {name: 0 for name, _, _ in CNT_COLS}
        cnt_regs.update({name: 0 for name, _, _ in HASH_CNT_COLS})
        state_root = inp.get("oldStateRoot")
        if state_root is not None:
            regs8["SR"] = _fe4_to_fea8(state_root)
        if "oldStateRootScalar" in inp:
            # reference initial state (main_executor.cpp:5701-5714):
            # B=oldStateRoot, C=oldAccInputHash, SP=oldBatchNum,
            # GAS=chainID, CTX=forkID; SR stays 0 (the ROM assigns it)
            osr = inp["oldStateRootScalar"]
            regs8["B"] = _scalar_to_fea8(osr)
            regs8["C"] = _scalar_to_fea8(inp.get("oldAccInputHash", 0))
            scal["SP"] = inp.get("oldBatchNum", 0)
            scal["GAS"] = inp.get("chainID", 1000)
            scal["CTX"] = inp.get("forkID", 9)
            state_root = tuple(
                (osr >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4))

        ctx = _CmdCtx(self, inp, regs8, scal, mem, n)
        if full_tracer is not None:
            ctx.full_tracer = full_tracer
        last_step = 0

        # timestamp recovery (reference fork_7+ main_executor.cpp:249-289):
        # executing transaction-by-transaction across batches loses the
        # timestamp set by the skipped changeL2Block, so process-batch mode
        # pre-loads mem[timestamp] from the state — the system contract's
        # TIMESTAMP_STORAGE_POS slot (A=%ADDRESS_SYSTEM, B=%SMT_KEY_SC_STORAGE,
        # C=%TIMESTAMP_STORAGE_POS)
        if process_batch and inp.get("skipFirstChangeL2Block") and \
                smt is not None and "timestamp" in rom.memory_map:
            key = (13748230500842749409, 4428676446262882967,
                   12167292013585018040, 12161933621946006603)
            old_root = tuple(
                (inp.get("oldStateRootScalar", 0) >> (64 * i))
                & 0xFFFFFFFFFFFFFFFF for i in range(4))
            ts = smt.get(old_root, key).value
            mem[rom.memory_map["timestamp"]] = _scalar_to_fea8(ts)

        poseidon = rm.Poseidon(pc.round_constants(), pc.mds_matrix())

        if self._plans is None:
            self._plans = _build_plans(rom, col)
        plans = self._plans
        # dynamic row slots written from machine state every step, in one
        # fancy assignment: 48 reg limbs + 7 scalars + 7 counters
        dyn_idx = np.array(
            [col[f"{r}{l}"] for r in REGS8 for l in range(8)]
            + [col[s] for s in SCALAR_REGS]
            + [col[name] for name, _, _ in CNT_COLS]
            + [col[name] for name, _, _ in HASH_CNT_COLS], dtype=np.intp)
        tail_idx = np.array(
            [col[f"OP{l}"] for l in range(8)]
            + [col["ADDR"], col["CARRY"], col["ISNEG"], col["DOJMP"],
               col["ISRCXNZ"], col["STAY"], col["INCHASHPOS"],
               col["INCCNT"]], dtype=np.intp)

        n_rom = len(rom)
        rom_lines = rom.lines
        for step in range(n):
            if zk_pc >= n_rom:
                raise ExecutorError(f"zkPC {zk_pc} out of program", step, zk_pc)
            ln = rom_lines[zk_pc]
            pl = plans[zk_pc]
            ctx.step, ctx.zk_pc = step, zk_pc
            if self.on_step is not None:
                self.on_step(step, zk_pc, ln, ctx)
            row = tr[0] if process_batch else tr[step]

            # state snapshot for this row (two bulk assignments)
            row[pl.static_idx] = pl.static_vals
            dyn = (regs8["A"] + regs8["B"] + regs8["C"] + regs8["D"]
                   + regs8["E"] + regs8["SR"])
            dyn += [scal[s] for s in SCALAR_REGS]
            dyn += [cnt_regs[name] for name, _, _ in CNT_COLS]
            dyn += [cnt_regs[name] for name, _, _ in HASH_CNT_COLS]
            row[dyn_idx] = dyn
            inc_counter = 0  # this row's incCounter (INCCNT), when flagged

            for cmd in ln.cmd_before:
                evc.eval_command(ctx, cmd)

            # ---- op accumulation (mod p per limb) -----------------------
            op = list(pl.const8)
            for sel, r in pl.in8:
                rr = regs8[r]
                for l in range(8):
                    op[l] = (op[l] + sel * rr[l]) % P
            if pl.in_rotl:
                rc = regs8["C"]
                for l in range(8):
                    op[l] = (op[l] + pl.in_rotl * rc[(l + 7) % 8]) % P
            acc0 = op[0]
            for sel, s in pl.in_scal:
                acc0 = (acc0 + sel * scal[s]) % P
            if pl.in_step:
                acc0 = (acc0 + pl.in_step * (0 if no_counters else step)) % P
            for sel, name in pl.in_cnt:
                acc0 = (acc0 + sel * cnt_regs[name]) % P
            op[0] = acc0

            # input-flag op overrides at pinned labels (reference
            # main_executor.cpp:2235-2259): skipFirstChangeL2Block forces
            # the checkFirstTxType pendingTxs probe non-zero (continuation
            # batches start mid-block), skipWriteBlockInfoRoot zeroes the
            # root about to be SSTOREd; both replace op after free inputs
            op_override = None
            if zk_pc == rom.labels.get("checkFirstTxType", -1) and \
                    inp.get("skipFirstChangeL2Block"):
                op_override = [1] * 8
            if zk_pc == rom.labels.get("writeBlockInfoRoot", -1) and \
                    inp.get("skipWriteBlockInfoRoot"):
                op_override = [0] * 8

            # ---- memory address ----------------------------------------
            addr = ln.offset
            if ln.ind:
                addr += _to_s32(regs8["E"][0], "E0", step, zk_pc, ln)
            if ln.indRR:
                addr += _to_s32(scal["RR"], "RR", step, zk_pc, ln)
            if ln.isStack:
                addr += _to_s32(scal["SP"], "SP", step, zk_pc, ln)
            if addr < 0:
                raise ExecutorError(f"addrRel<0 ({addr})", step, zk_pc, ln)
            if ln.useCTX:
                addr += scal["CTX"] * CTX_OFFSET
            if ln.isStack:
                addr += STACK_OFFSET
            if ln.isMem:
                addr += MEM_OFFSET

            # ---- free input ---------------------------------------------
            free = [0] * 8
            if ln.inFREE or ln.inFREE0:
                free = self._free_input(
                    ctx, ln, addr, op, regs8, scal, mem,
                    hash_k, hash_p, hash_s, smt, poseidon, step, zk_pc)
                for l in range(8):
                    row[col[f"FREE{l}"]] = free[l]
                if ln.inFREE:
                    for l in range(8):
                        op[l] = (op[l] + ln.inFREE * free[l]) % P
                if ln.inFREE0:
                    op[0] = (op[0] + ln.inFREE0 * free[0]) % P

            if op_override is not None:
                op = list(op_override)

            # ---- assert -------------------------------------------------
            if ln.assert_:
                if op != regs8["A"]:
                    raise ExecutorError(
                        f"ASSERT failed op={op} A={regs8['A']}",
                        step, zk_pc, ln)

            # ---- memory op ----------------------------------------------
            if ln.mOp:
                if ln.mWR:
                    mem[addr] = list(op)
                else:
                    val = mem.get(addr, [0] * 8)
                    if op != val and op_override is None:
                        raise ExecutorError(
                            f"MLOAD mismatch op={op} mem={val}",
                            step, zk_pc, ln)
                actions.memory.append({
                    "addr": addr, "step": step, "wr": bool(ln.mWR),
                    "fea": tuple(op)})

            # ---- storage -------------------------------------------------
            if ln.sRD or ln.sWR:
                if smt is None:
                    raise ExecutorError("storage op without smt", step, zk_pc, ln)
                ki, key, kin0, kin1 = self._smt_key_full(regs8, poseidon)
                for j in range(4):
                    row[col[f"KI{j}"]] = ki[j]
                    row[col[f"KEY{j}"]] = key[j]
                actions.poseidon_g.append({"state": kin0})
                actions.poseidon_g.append({"state": kin1})
                old_root = _fea8_to_fe4(regs8["SR"])
                sem = {  # semantic key triple (A=addr, B=type, C=slot) —
                    # lets witness generators emit SMT_LEAF records
                    "addr": _fea8_to_scalar_lenient(regs8["A"]),
                    "key_type": _fea8_to_scalar_lenient(regs8["B"]),
                    "slot": _fea8_to_scalar_lenient(regs8["C"])}
                if ln.sRD:
                    res = smt.get(old_root, key)
                    actions.storage.append(
                        {"op": "get", "root": old_root, "key": key,
                         "value": res.value, **sem})
                    if full_tracer is not None:
                        full_tracer.add_read_write_address(
                            _fea8_to_scalar_lenient(regs8["A"]),
                            _fea8_to_scalar_lenient(regs8["B"]),
                            _fea8_to_scalar_lenient(regs8["C"]),
                            res.value, key)
                else:
                    value = _fea8_to_scalar_strict(
                        regs8["D"], step, zk_pc, ln)
                    # the free-input pass already ran this set (ctx.last_swrite
                    # mirrors the reference's ctx.lastSWrite memoization)
                    if ctx.last_swrite and ctx.last_swrite[0] == step:
                        res = ctx.last_swrite[1]
                    else:
                        res = smt.set(old_root, key, value)
                    state_root = res.new_root
                    actions.storage.append(
                        {"op": "set", "root": old_root, "key": key,
                         "value": value, "new_root": res.new_root, **sem})
                    if full_tracer is not None:
                        full_tracer.add_read_write_address(
                            _fea8_to_scalar_lenient(regs8["A"]),
                            _fea8_to_scalar_lenient(regs8["B"]),
                            _fea8_to_scalar_lenient(regs8["C"]),
                            value, key)
                # incCounter = tree-walk hashes + 2 key-derivation hashes
                # (reference proofHashCounter + 2, main_executor.cpp:1154)
                from . import storage as storage_sm
                inc_counter = storage_sm.hash_count(
                    actions.storage[-1], smt.db) + 2
                counters["poseidonG"] += inc_counter

            # ---- hash ops ------------------------------------------------
            inc_hash_pos = 0
            if ln.hashK or ln.hashK1:
                inc_hash_pos = self._hash_write(
                    hash_k, addr, op, scal, regs8, ln, ln.hashK1, step, zk_pc)
            if ln.hashKLen:
                self._hash_len(hash_k, addr, op, "K", step, zk_pc, ln,
                               actions=actions)
            if ln.hashKDigest:
                hs = hash_k.get(addr)
                if hs is None or hs.digest is None:
                    raise ExecutorError("hashKDigest before len", step, zk_pc, ln)
                if _fea8_to_scalar_strict(op, step, zk_pc, ln) != hs.digest:
                    raise ExecutorError("hashKDigest mismatch", step, zk_pc, ln)
                if hs.digest_called:
                    raise ExecutorError("hashKDigest called twice",
                                        step, zk_pc, ln)
                hs.digest_called = True
                inc_counter = len(hs.data) // 136 + 1
                counters["keccakF"] += inc_counter
            if ln.hashP or ln.hashP1:
                inc_hash_pos = self._hash_write(
                    hash_p, addr, op, scal, regs8, ln, ln.hashP1, step, zk_pc,
                    first_byte=True)
            if ln.hashPLen:
                self._hash_len(hash_p, addr, op, "P", step, zk_pc, ln,
                               poseidon=poseidon, actions=actions, smt=smt)
            if ln.hashPDigest:
                dg = _fea8_to_scalar_strict(op, step, zk_pc, ln)
                hs = hash_p.get(addr)
                if hs is None:
                    # first touch by digest: pull the program preimage from
                    # the DB (reference main_executor.cpp:3175-3207 —
                    # pHashDB->getProgram keyed by the digest fea)
                    hs = _HashState()
                    hs.digest = dg
                    prog = None
                    if smt is not None:
                        prog = smt.db.get_program(
                            tuple((dg >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
                                  for i in range(4)))
                    if prog is None:
                        raise ExecutorError(
                            f"hashPDigest: program {dg:#x} not in DB",
                            step, zk_pc, ln)
                    hs.data = bytearray(prog)
                    hash_p[addr] = hs
                    # digest-first touch still needs the padding stream
                    # for the Main<->PaddingPG binding
                    actions.hashp.append({"data": bytes(hs.data),
                                          "addr": addr, "reads": hs.reads})
                if hs.digest is None:
                    raise ExecutorError("hashPDigest before len", step, zk_pc, ln)
                if hs.digest_called:
                    raise ExecutorError("hashPDigest called twice",
                                        step, zk_pc, ln)
                hs.digest_called = True
                inc_counter = (len(hs.data) + 1 + 55) // 56
                counters["paddingPG"] += inc_counter
                counters["poseidonG"] += inc_counter
                if dg != hs.digest:
                    raise ExecutorError("hashPDigest mismatch", step, zk_pc, ln)
            if ln.hashS or ln.hashS1:
                inc_hash_pos = self._hash_write(
                    hash_s, addr, op, scal, regs8, ln, ln.hashS1, step, zk_pc)
            if ln.hashSLen:
                self._hash_len(hash_s, addr, op, "S", step, zk_pc, ln,
                               actions=actions)
            if ln.hashSDigest:
                hs = hash_s.get(addr)
                if hs is None or hs.digest is None:
                    raise ExecutorError("hashSDigest before len", step, zk_pc, ln)
                if _fea8_to_scalar_strict(op, step, zk_pc, ln) != hs.digest:
                    raise ExecutorError("hashSDigest mismatch", step, zk_pc, ln)
                if hs.digest_called:
                    raise ExecutorError("hashSDigest called twice",
                                        step, zk_pc, ln)
                hs.digest_called = True
                inc_counter = (len(hs.data) + 1 + 8 + 63) // 64
                counters["sha256F"] += inc_counter

            # ---- arith ---------------------------------------------------
            if ln.arithEq0:
                a = _fea8_to_scalar_strict(regs8["A"], step, zk_pc, ln)
                bb = _fea8_to_scalar_strict(regs8["B"], step, zk_pc, ln)
                cc = _fea8_to_scalar_strict(regs8["C"], step, zk_pc, ln)
                d = _fea8_to_scalar_strict(regs8["D"], step, zk_pc, ln)
                o = _fea8_to_scalar_strict(op, step, zk_pc, ln)
                if a * bb + cc != (d << 256) + o:
                    raise ExecutorError("arithEq0 A·B+C != D·2^256+op",
                                        step, zk_pc, ln)
                actions.arith.append({"op": "mul", "x1": a, "y1": bb,
                                      "x2": cc})
                counters["arith"] += 1
            elif ln.arithEq1 or ln.arithEq2:
                # secp256k1 point add (eq1) / double (eq2):
                # (A,B)+(C,D) = (E, op) — main_executor.cpp:3880-3975
                from . import arith as arith_sm

                x1 = _fea8_to_scalar_strict(regs8["A"], step, zk_pc, ln)
                y1 = _fea8_to_scalar_strict(regs8["B"], step, zk_pc, ln)
                x2 = _fea8_to_scalar_strict(regs8["C"], step, zk_pc, ln)
                y2 = _fea8_to_scalar_strict(regs8["D"], step, zk_pc, ln)
                x3 = _fea8_to_scalar_strict(regs8["E"], step, zk_pc, ln)
                y3 = _fea8_to_scalar_strict(op, step, zk_pc, ln)
                kind = "add" if ln.arithEq1 else "dbl"
                if kind == "add" and x1 == x2:
                    raise ExecutorError("arithEq1 with x1 == x2",
                                        step, zk_pc, ln)
                ex3, ey3 = arith_sm.ec_result(kind, x1, y1, x2, y2)
                if (x3, y3) != (ex3, ey3):
                    raise ExecutorError(
                        f"arith {kind} result mismatch", step, zk_pc, ln)
                # the SM action carries x2=x1, y2=y1 on doubling rows
                # (reference main_executor.cpp:3993-3994)
                actions.arith.append(
                    {"op": kind, "x1": x1, "y1": y1,
                     "x2": x1 if kind == "dbl" else x2,
                     "y2": y1 if kind == "dbl" else y2})
                counters["arith"] += 1
            elif ln.arithEq3 or ln.arithEq4 or ln.arithEq5:
                # BN254 Fp2 mul/add/sub: (A+iB) op (C+iD) = (E + i·op),
                # reference main_executor.cpp:3586-3857
                from . import arith as arith_sm

                x1 = _fea8_to_scalar_strict(regs8["A"], step, zk_pc, ln)
                y1 = _fea8_to_scalar_strict(regs8["B"], step, zk_pc, ln)
                x2 = _fea8_to_scalar_strict(regs8["C"], step, zk_pc, ln)
                y2 = _fea8_to_scalar_strict(regs8["D"], step, zk_pc, ln)
                x3 = _fea8_to_scalar_strict(regs8["E"], step, zk_pc, ln)
                y3 = _fea8_to_scalar_strict(op, step, zk_pc, ln)
                kind = ("mulfp2" if ln.arithEq3
                        else "addfp2" if ln.arithEq4 else "subfp2")
                if (x3, y3) != arith_sm.fp2_result(kind, x1, y1, x2, y2):
                    raise ExecutorError(
                        f"arith {kind} result mismatch", step, zk_pc, ln)
                actions.arith.append({"op": kind, "x1": x1, "y1": y1,
                                      "x2": x2, "y2": y2})
                counters["arith"] += 1

            # ---- binary --------------------------------------------------
            carry = 0
            if ln.bin:
                opname = BIN_OPS.get(ln.binOpcode)
                if opname is None:
                    raise ExecutorError(f"binOpcode {ln.binOpcode}",
                                        step, zk_pc, ln)
                a = _fea8_to_scalar_strict(regs8["A"], step, zk_pc, ln)
                bb = _fea8_to_scalar_strict(regs8["B"], step, zk_pc, ln)
                res, carry = _bin_result(opname, a, bb)
                if _fea8_to_scalar_strict(op, step, zk_pc, ln) != res:
                    raise ExecutorError(f"bin {opname} result mismatch",
                                        step, zk_pc, ln)
                actions.binary.append({"op": opname, "a": a, "b": bb})
                counters["binary"] += 1

            # ---- memAlign ------------------------------------------------
            # register convention (main_executor.cpp:4484-4620): A=m0, B=m1,
            # C=offset; reads put the value in op; writes take the value
            # from op and the new window from D (w0') and E (w1').
            # The SM's window is little-endian (w0 low), so the big-endian
            # m0||m1 maps as {w0: m1, w1: m0, offset: 32-off}.
            if ln.memAlignRD or ln.memAlignWR or ln.memAlignWR8:
                m0 = _fea8_to_scalar_strict(regs8["A"], step, zk_pc, ln)
                m1 = _fea8_to_scalar_strict(regs8["B"], step, zk_pc, ln)
                off = _fea8_to_scalar_strict(regs8["C"], step, zk_pc, ln)
                if off > 32:
                    raise ExecutorError(f"memAlign offset {off}", step, zk_pc, ln)
                if ln.memAlignRD:
                    actions.mem_align.append(
                        {"op": "rd", "w0": m1, "w1": m0, "offset": 32 - off})
                else:
                    from . import mem_align as ma_sm

                    val = _fea8_to_scalar_strict(op, step, zk_pc, ln)
                    w0n = _fea8_to_scalar_strict(regs8["D"], step, zk_pc, ln)
                    w1n = _fea8_to_scalar_strict(regs8["E"], step, zk_pc, ln)
                    kind = "wr" if ln.memAlignWR else "wr8"
                    # The SM window is little-endian bytes of the big-endian
                    # m0||m1, so the value's LSB lands at LE byte 64-off-span
                    # and the rest follow upward — the value itself is NOT
                    # byte-swapped (reference formula main_executor.cpp:4548:
                    # _W0 = (m0 & hi-mask) | (v >> 8*offset)). The action
                    # carries the FULL op value (the SM's span routing uses
                    # only the written bytes) so V == op in the AIR binding.
                    span = 32 if kind == "wr" else 1
                    v_le = val
                    act = {"op": kind, "w0": m1, "w1": m0,
                           "offset": 64 - off - span, "value": v_le}
                    nw_lo, nw_hi = ma_sm.result(act)
                    # WR8 touches one byte of the A word only; the reference
                    # checks D alone and never reads E on WR8 rows (fork_5
                    # ROM leaves E unrelated there — main_executor.cpp WR8
                    # branch), so the low-word check applies to WR only.
                    if nw_hi != w0n or (kind == "wr" and nw_lo != w1n):
                        raise ExecutorError(
                            f"memAlign {kind} result mismatch",
                            step, zk_pc, ln)
                    actions.mem_align.append(act)
                counters["memAlign"] += 1

            # ---- control flow -------------------------------------------
            do_jmp = False
            is_neg = 0
            if ln.JMPN:
                v = op[0]
                if v >= P - (1 << 32):
                    is_neg = 1
                    cond = v - (P - (1 << 32))  # op0 + 2^32 mod p
                    do_jmp = True
                elif v < (1 << 32):
                    cond = v
                else:
                    raise ExecutorError(f"JMPN op0 out of s32 ({v})",
                                        step, zk_pc, ln)
                for j in range(k_ch):
                    row[col[f"JMPN_CH{j}"]] = (cond >> (j * b)) & ((1 << b) - 1)
            elif ln.JMPC:
                do_jmp = bool(carry)
            elif ln.JMPZ:
                do_jmp = op[0] == 0
                row[col["ISOPZ"]] = int(op[0] == 0)
                if op[0] != 0:
                    row[col["OP0INV"]] = rm.inv(op[0])
            elif ln.JMP or ln.call:
                do_jmp = True

            rcx_nz = scal["RCX"] != 0
            if scal["RCX"]:
                row[col["RCXINV"]] = rm.inv(scal["RCX"])
            stay = bool(ln.repeat and rcx_nz)

            # per-step trace slots, one bulk assignment
            row[tail_idx] = op + [addr % P, carry, is_neg, int(do_jmp),
                                  int(rcx_nz), int(stay), inc_hash_pos,
                                  inc_counter]

            if ln.return_:
                next_pc = scal["RR"]
            elif do_jmp:
                next_pc = ln.jmpAddr if ln.useJmpAddr else addr
            elif stay:
                next_pc = zk_pc
            elif ln.useElseAddr:
                next_pc = ln.elseAddr
            else:
                next_pc = zk_pc + 1

            # ---- setters -------------------------------------------------
            for r in pl.set8:
                regs8[r] = list(op)
            for s in pl.set_scal:
                scal[s] = op[0]
            scal["SP"] = op[0] if ln.setSP else (scal["SP"] + ln.incStack) % P
            if ln.setRR:
                scal["RR"] = op[0]
            elif ln.call:
                scal["RR"] = zk_pc + 1
            if ln.setRCX:
                scal["RCX"] = op[0]
            elif ln.repeat and rcx_nz:
                scal["RCX"] = (scal["RCX"] - 1) % P
            if ln.setHASHPOS:
                scal["HASHPOS"] = (op[0] + inc_hash_pos) % P
            else:
                scal["HASHPOS"] = (scal["HASHPOS"] + inc_hash_pos) % P

            for cmd in ln.cmd_after:
                evc.eval_command(ctx, cmd)

            if not no_counters:
                if pl.derived[0]:
                    cnt_regs["CNT_ARITH"] += pl.derived[0]
                if pl.derived[1]:
                    cnt_regs["CNT_BINARY"] += pl.derived[1]
                if pl.derived[2]:
                    cnt_regs["CNT_MEMALIGN"] += pl.derived[2]
            if inc_counter and not no_counters:
                if ln.hashKDigest:
                    cnt_regs["CNT_KECCAK_F"] += inc_counter
                if ln.hashPDigest:
                    cnt_regs["CNT_PADDING_PG"] += inc_counter
                if ln.hashSDigest:
                    cnt_regs["CNT_SHA256_F"] += inc_counter
                if ln.sRD or ln.sWR or ln.hashPDigest:
                    cnt_regs["CNT_POSEIDON_G"] += inc_counter

            if zk_pc == finalize_label and last_step == 0:
                last_step = step
                if process_batch:
                    zk_pc = next_pc
                    break

            zk_pc = next_pc

        if process_batch:
            if last_step == 0:
                raise ExecutorError(
                    "execution did not reach finalizeExecution within "
                    f"{n} steps", n - 1, zk_pc)
            # the authoritative final root is the SR register at
            # finalizeExecution (reference reads pols.SR — the sWR-tracked
            # state_root would also absorb block-info-tree writes)
            return MainResult(trace=tr, actions=actions, counters=counters,
                              logs=ctx.logs, mem=mem,
                              new_state_root=_fea8_to_fe4(regs8["SR"]),
                              last_step=last_step)

        if zk_pc != 0:
            raise ExecutorError(
                f"trace does not close the cycle (final zkPC={zk_pc}); "
                "end the program with RomBuilder.finalize()", self.n - 1, zk_pc)
        for r in REGS8:
            first = [int(tr[0][col[f"{r}{l}"]]) for l in range(8)]
            if regs8[r] != first:
                raise ExecutorError(
                    f"register {r} not restored at wrap "
                    f"(final={regs8[r]}, initial={first})", self.n - 1, 0)
        for s in SCALAR_REGS:
            if scal[s] != int(tr[0][col[s]]):
                raise ExecutorError(
                    f"register {s} not restored at wrap "
                    f"(final={scal[s]}, initial={int(tr[0][col[s]])})",
                    self.n - 1, 0)

        return MainResult(trace=tr, actions=actions, counters=counters,
                          logs=ctx.logs, mem=mem,
                          new_state_root=state_root, last_step=last_step)

    # ------------------------------------------------------------------

    def _smt_key(self, regs8, poseidon):
        return self._smt_key_full(regs8, poseidon)[1]

    def _smt_key_full(self, regs8, poseidon):
        """Storage key = Poseidon(A0..A5,B0,B1 | Poseidon(C | 0))
        (main_executor.cpp:1080-1140). Returns (ki, key, kin0, kin1) — the
        intermediate hash and both permutation inputs, which the trace
        commits (sKeyI/sKey pols) and binds to PoseidonG."""
        kin0 = [regs8["C"][l] for l in range(8)] + [0, 0, 0, 0]
        h0 = poseidon.permute(kin0)[:4]
        kin1 = [regs8["A"][l] for l in range(6)] \
            + [regs8["B"][0], regs8["B"][1]] + list(h0)
        return (tuple(h0), tuple(poseidon.permute(kin1)[:4]),
                kin0, kin1)

    def _hash_write(self, pool, addr, op, scal, regs8, ln, one_byte,
                    step, zk_pc, first_byte=False):
        """Write-or-verify `size` bytes of op at HASHPOS (reference hashK/
        hashP instruction semantics, main_executor.cpp:2660-2758: appends
        when at the buffer tail, verifies equality when re-reading already
        materialized bytes, and rejects gaps).  `first_byte` enables the
        hashP byte-0 reservation protocol."""
        hs = pool.setdefault(addr, _HashState())
        size = 1 if one_byte else regs8["D"][0]
        if not (1 <= size <= 32):
            raise ExecutorError(f"hash size {size}", step, zk_pc, ln)
        pos = scal["HASHPOS"]
        val = _fea8_to_scalar_strict(op, step, zk_pc, ln)
        if val >> (8 * size):
            raise ExecutorError(f"hash value too big for size {size}",
                                step, zk_pc, ln)
        data = val.to_bytes(size, "big")
        for j, bm in enumerate(data):
            # hashP first-byte reservation (main_executor.cpp:2980-3010):
            # the l2TxHash scheme writes bytes 1.. first and patches the tx
            # type into byte 0 at the end
            if (first_byte and pos + j == 1 and not hs.data
                    and not hs.first_byte_written):
                hs.data.append(0)
                hs.reads.setdefault(0, 1)
            if (first_byte and pos + j == 0 and size == 1 and hs.data
                    and not hs.first_byte_written):
                hs.data[0] = bm
                hs.first_byte_written = True
            elif len(hs.data) == pos + j:
                hs.data.append(bm)
            elif len(hs.data) < pos + j:
                raise ExecutorError(
                    f"hash position {pos + j} beyond buffer "
                    f"{len(hs.data)}", step, zk_pc, ln)
            elif hs.data[pos + j] != bm:
                raise ExecutorError(
                    f"hash byte mismatch at {pos + j}: "
                    f"{bm} != {hs.data[pos + j]}", step, zk_pc, ln)
        prev = hs.reads.get(pos)
        if prev is not None and prev != size:
            raise ExecutorError(
                f"hash read at {pos} with size {size} != prior {prev}",
                step, zk_pc, ln)
        hs.reads[pos] = size
        return size

    def _hash_read_free(self, pool, addr, scal, regs8, ln, one_byte,
                        step, zk_pc):
        """Free-input read of `size` bytes from the hash buffer at HASHPOS
        (reference main_executor.cpp:1444-1508): data must already be
        materialized."""
        hs = pool.setdefault(addr, _HashState())
        size = 1 if one_byte else regs8["D"][0]
        if not (1 <= size <= 32):
            raise ExecutorError(f"hash free-in size {size}", step, zk_pc, ln)
        pos = scal["HASHPOS"]
        if pos + size > len(hs.data):
            raise ExecutorError(
                f"hash free-in read [{pos},{pos + size}) beyond buffer "
                f"{len(hs.data)}", step, zk_pc, ln)
        return _scalar_to_fea8(
            int.from_bytes(bytes(hs.data[pos:pos + size]), "big"))

    def _hash_len(self, pool, addr, op, kind, step, zk_pc, ln,
                  poseidon=None, actions=None, smt=None):
        hs = pool.setdefault(addr, _HashState())
        length = op[0]
        if hs.len_called:
            raise ExecutorError(f"hash{kind}Len called twice", step, zk_pc, ln)
        hs.len_called = True
        if length != len(hs.data):
            raise ExecutorError(
                f"hash len {length} != buffer {len(hs.data)}", step, zk_pc, ln)
        hs.length = length
        if kind == "P":
            # hashP: the reference linear poseidon over bytes — 0x01..0x80
            # padding, 7-byte little-endian elements, 56-byte blocks
            # (padding_pg_executor.cpp:38-41, :148-170)
            fresh = hs.digest is None  # digest-first touch already emitted
            vals = poseidon.pack_bytes(bytes(hs.data))
            digest4 = poseidon.linear_hash(vals)
            hs.digest = _fe4_to_scalar(digest4)
            if smt is not None:
                # persist the program preimage (reference hashPLen →
                # pHashDB->setProgram) so later digest-first touches load it
                smt.db.set_program(digest4, bytes(hs.data))
            if actions is not None and fresh and len(vals) > 4:
                actions.padding_pg.append({"values": vals})
            if actions is not None and fresh:
                actions.hashp.append({"data": bytes(hs.data),
                                      "addr": addr, "reads": hs.reads})
        elif kind == "K":
            oracle = getattr(self, "_hash_oracles", {}).get("K")
            hs.digest = oracle(bytes(hs.data)) if oracle else \
                int.from_bytes(keccak_mod.keccak256(bytes(hs.data)), "big")
            if actions is not None:
                # `reads` is the LIVE dict: later verify-reads extend the
                # chunk tiling the padding SM must expose to Main's lookup
                actions.keccak.append(
                    {"data": bytes(hs.data), "digest": hs.digest,
                     "addr": addr, "reads": hs.reads})
        else:
            oracle = getattr(self, "_hash_oracles", {}).get("S")
            hs.digest = oracle(bytes(hs.data)) if oracle else \
                int.from_bytes(sha256_mod.sha256(bytes(hs.data)), "big")
            if actions is not None:
                actions.sha256.append(
                    {"data": bytes(hs.data), "digest": hs.digest,
                     "addr": addr, "reads": hs.reads})

    def _free_input(self, ctx, ln, addr, op, regs8, scal, mem,
                    hash_k, hash_p, hash_s, smt, poseidon, step, zk_pc):
        tag = ln.free_in_tag
        if tag is not None:
            v = evc.eval_command(ctx, tag)
            if isinstance(v, tuple):
                return [x % P for x in v]
            if v is None:
                v = 0
            if not isinstance(v, int):
                raise ExecutorError(f"free input type {type(v)}", step, zk_pc, ln)
            # reference scalar2fea (scalar.hpp:299-318) truncates to 256
            # bits; GMP bitwise ops give negatives two's-complement
            # semantics — Python's & matches both behaviors
            return _scalar_to_fea8(v & MASK256)
        # flag-derived free value (main_executor.cpp:900-2000)
        if ln.mOp and not ln.mWR:
            return list(mem.get(addr, [0] * 8))
        if ln.sRD:
            key = self._smt_key(regs8, poseidon)
            res = smt.get(_fea8_to_fe4(regs8["SR"]), key)
            return _scalar_to_fea8(res.value)
        if ln.sWR:
            value = _fea8_to_scalar_strict(regs8["D"], step, zk_pc, ln)
            key = self._smt_key(regs8, poseidon)
            res = smt.set(_fea8_to_fe4(regs8["SR"]), key, value)
            ctx.last_swrite = (step, res)
            return _fe4_to_fea8(res.new_root)
        if ln.hashK or ln.hashK1:
            return self._hash_read_free(hash_k, addr, scal, regs8, ln,
                                        ln.hashK1, step, zk_pc)
        if ln.hashKDigest:
            hs = hash_k.get(addr)
            if hs is None or hs.digest is None:
                raise ExecutorError("hashKDigest before len", step, zk_pc, ln)
            return _scalar_to_fea8(hs.digest)
        if ln.hashP or ln.hashP1:
            return self._hash_read_free(hash_p, addr, scal, regs8, ln,
                                        ln.hashP1, step, zk_pc)
        if ln.hashPDigest:
            hs = hash_p.get(addr)
            if hs is None or hs.digest is None:
                raise ExecutorError("hashPDigest before len", step, zk_pc, ln)
            return _scalar_to_fea8(hs.digest)
        if ln.hashS or ln.hashS1:
            return self._hash_read_free(hash_s, addr, scal, regs8, ln,
                                        ln.hashS1, step, zk_pc)
        if ln.hashSDigest:
            hs = hash_s.get(addr)
            if hs is None or hs.digest is None:
                raise ExecutorError("hashSDigest before len", step, zk_pc, ln)
            return _scalar_to_fea8(hs.digest)
        if ln.memAlignRD:
            m0 = _fea8_to_scalar_strict(regs8["A"], step, zk_pc, ln)
            m1 = _fea8_to_scalar_strict(regs8["B"], step, zk_pc, ln)
            off = _fea8_to_scalar_strict(regs8["C"], step, zk_pc, ln)
            wb = (m0.to_bytes(32, "big") + m1.to_bytes(32, "big"))
            return _scalar_to_fea8(
                int.from_bytes(wb[off:off + 32], "big"))
        if ln.bin:
            opname = BIN_OPS.get(ln.binOpcode)
            if opname is None:
                raise ExecutorError(f"binOpcode {ln.binOpcode}", step, zk_pc, ln)
            a = _fea8_to_scalar_strict(regs8["A"], step, zk_pc, ln)
            bb = _fea8_to_scalar_strict(regs8["B"], step, zk_pc, ln)
            return _scalar_to_fea8(_bin_result(opname, a, bb)[0])
        if ln.arithEq0:
            a = _fea8_to_scalar_strict(regs8["A"], step, zk_pc, ln)
            bb = _fea8_to_scalar_strict(regs8["B"], step, zk_pc, ln)
            cc = _fea8_to_scalar_strict(regs8["C"], step, zk_pc, ln)
            return _scalar_to_fea8((a * bb + cc) & MASK256)
        if ln.arithEq1 or ln.arithEq2:
            from . import arith as arith_sm

            x1 = _fea8_to_scalar_strict(regs8["A"], step, zk_pc, ln)
            y1 = _fea8_to_scalar_strict(regs8["B"], step, zk_pc, ln)
            x2 = _fea8_to_scalar_strict(regs8["C"], step, zk_pc, ln)
            y2 = _fea8_to_scalar_strict(regs8["D"], step, zk_pc, ln)
            kind = "add" if ln.arithEq1 else "dbl"
            return _scalar_to_fea8(
                arith_sm.ec_result(kind, x1, y1, x2, y2)[1])
        if ln.arithEq3 or ln.arithEq4 or ln.arithEq5:
            from . import arith as arith_sm

            x1 = _fea8_to_scalar_strict(regs8["A"], step, zk_pc, ln)
            y1 = _fea8_to_scalar_strict(regs8["B"], step, zk_pc, ln)
            x2 = _fea8_to_scalar_strict(regs8["C"], step, zk_pc, ln)
            y2 = _fea8_to_scalar_strict(regs8["D"], step, zk_pc, ln)
            kind = ("mulfp2" if ln.arithEq3
                    else "addfp2" if ln.arithEq4 else "subfp2")
            return _scalar_to_fea8(
                arith_sm.fp2_result(kind, x1, y1, x2, y2)[1])
        raise ExecutorError("inFREE without tag or flag source",
                            step, zk_pc, ln)


class _CmdCtx:
    """Context object handed to eval_command."""

    def __init__(self, executor, inp, regs8, scal, mem, n):
        self.executor = executor
        self.input = inp
        self.regs8 = regs8
        self.scal = scal
        self.mem = mem
        self.n = n
        self.vars: dict = {}
        self.logs: list = []
        self.step = 0
        self.zk_pc = 0
        self.last_swrite = None  # (step, SmtSetResult) — reference lastSWrite

    def get_reg(self, name: str):
        if name in REGS8:
            return _fea8_to_scalar_lenient(self.regs8[name])
        if name in SCALAR_REGS:
            return self.scal[name]
        if name == "zkPC":
            return self.zk_pc
        if name == "STEP":
            return self.step
        raise evc.CommandError(f"getReg: unknown register {name!r}")

    def get_mem(self, offset: int, use_ctx: bool):
        addr = offset + (self.scal["CTX"] * CTX_OFFSET if use_ctx else 0)
        return _fea8_to_scalar_lenient(self.mem.get(addr, [0] * 8))

    def get_mem_raw(self, addr: int):
        """Absolute-address read for the MPdiv family (ref ctx.mem.find)."""
        return _fea8_to_scalar_lenient(self.mem.get(addr, [0] * 8))

    def get_txs(self, pos: int, length: int):
        data = self.input.get("batchL2Data", b"")
        chunk = bytes(data[pos:pos + length])
        chunk = chunk + b"\x00" * (length - len(chunk))
        return int.from_bytes(chunk, "big")


# ---------------------------------------------------------------------------
# limb conversions
# ---------------------------------------------------------------------------


def _scalar_to_fea8(v: int) -> list[int]:
    return [(v >> (32 * l)) & MASK32 for l in range(8)]


def _fea8_to_scalar_strict(fea, step, zk_pc, ln) -> int:
    out = 0
    for l, fe in enumerate(fea):
        fe = int(fe)
        if fe > MASK32:
            raise ExecutorError(
                f"fea2scalar: limb {l} = {fe} exceeds 32 bits", step, zk_pc, ln)
        out |= fe << (32 * l)
    return out


def _fea8_to_scalar_lenient(fea) -> int:
    out = 0
    for l, fe in enumerate(fea):
        fe = int(fe)
        if fe > MASK32:
            raise evc.CommandError(f"fea2scalar: limb {l} out of range")
        out |= fe << (32 * l)
    return out


def _fea8_to_fe4(fea8) -> tuple:
    return tuple((int(fea8[2 * i]) | (int(fea8[2 * i + 1]) << 32)) % P
                 for i in range(4))


def _fe4_to_fea8(fe4) -> list[int]:
    out = []
    for fe in fe4:
        fe = int(fe)
        out += [fe & MASK32, fe >> 32]
    return out


def _fe4_to_scalar(fe4) -> int:
    out = 0
    for i, fe in enumerate(fe4):
        out |= int(fe) << (64 * i)
    return out


def _bytes_to_u32_elems(data: bytes) -> list[int]:
    """hashP packing: 4 big-endian bytes per field element."""
    out = []
    for i in range(0, len(data), 4):
        out.append(int.from_bytes(data[i:i + 4], "big"))
    return out


def _to_s32(fe: int, what: str, step, zk_pc, ln) -> int:
    fe = int(fe)
    if fe < (1 << 31):
        return fe
    if fe > P - (1 << 31):
        return fe - P
    raise ExecutorError(f"{what} not a valid s32 ({fe})", step, zk_pc, ln)
