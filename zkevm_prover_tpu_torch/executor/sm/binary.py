"""Binary SM — 256-bit ADD/SUB/LT/SLT/EQ/AND/OR/XOR, slice-table proven.

Port of `zkevm_prover_tpu/executor/sm/binary.py` (host-only numpy):
the same AIR and trace.

Reference: src/sm/binary/binary_executor.cpp — byte-sliced 256-bit ops with
carry chaining, FACTOR/RESET accumulator registers (a[0..7], b, c as 32-bit
limbs rebuilt from the byte stream) and a "last byte" flag that gives SLT
its signed top-byte semantics. Opcode ids follow the Main SM's binOpcode
numbering (main_executor.cpp binary dispatch): ADD 0, SUB 1, LT 2, SLT 3,
EQ 4, AND 5, OR 6, XOR 7.

TPU-first redesign: slice width is a parameter (4-bit nibbles in
production — table 7.2k rows, 64 rows/op; 2-bit slices on test domains —
table 512 rows). The whole per-slice semantics (incl. AND's
result-nonzero carry and SLT's signed last slice) is ONE plookup of
(LAST, OPC, A, B, CIN, C, COUT); carry chaining and opcode constancy are
transition constraints; FACTOR constant columns accumulate the slices
into 8×32-bit limb registers whose group-end rows form the row-aligned
interface tuple for the Main SM binding (executor/combined.py):

    main:  BIN { BINOP, A0..7, B0..7, OP0..7, CARRY }
    here:  ACT·GLAST { OPC, AA0..7, BB0..7, CC0..7, COUT }
"""

from __future__ import annotations

import numpy as np

from ...stark import expr as ex
from ...stark.air import AIR

SLICE_BITS = 4               # production slice width
NIBBLES = 256 // SLICE_BITS  # rows per operation at the default width


def rows_per_op(slice_bits: int = SLICE_BITS) -> int:
    return 256 // slice_bits


# binOpcode numbering (shared with the Main SM)
OPS = {"ADD": 0, "SUB": 1, "LT": 2, "SLT": 3, "EQ": 4, "AND": 5,
       "OR": 6, "XOR": 7}
_INIT_CIN = {"ADD": 0, "SUB": 0, "LT": 0, "SLT": 0, "EQ": 1, "AND": 0,
             "OR": 0, "XOR": 0}
_HAS_CIN = ("ADD", "SUB", "LT", "SLT", "EQ", "AND")


def _signed(v: int, bits: int) -> int:
    return v - (1 << bits) if v >> (bits - 1) else v


def _op_semantics(op: str, a: int, b: int, cin: int, last: int,
                  slice_bits: int = SLICE_BITS) -> tuple[int, int]:
    """(c, cout) for one slice — the table row generator."""
    mask = (1 << slice_bits) - 1
    if op == "AND":
        c = a & b
        return c, 1 if (cin or c) else 0   # carry: result nonzero
    if op == "OR":
        return a | b, 0
    if op == "XOR":
        return a ^ b, 0
    if op == "ADD":
        s = a + b + cin
        return s & mask, s >> slice_bits
    if op == "SUB":
        d = a - b - cin
        return d & mask, 1 if d < 0 else 0
    if op == "LT":
        return 0, 1 if a < b else (cin if a == b else 0)
    if op == "SLT":
        if last:  # top slice compares signed (two's complement sign bit)
            sa, sb = _signed(a, slice_bits), _signed(b, slice_bits)
            return 0, 1 if sa < sb else (cin if sa == sb else 0)
        return 0, 1 if a < b else (cin if a == b else 0)
    if op == "EQ":
        return 0, cin & (1 if a == b else 0)
    raise ValueError(op)


_USE_CARRY = ("LT", "SLT", "EQ")  # result delivered through the carry chain


def _table_rows(slice_bits: int = SLICE_BITS):
    rows = []
    for op, opc in OPS.items():
        cins = (0, 1) if op in _HAS_CIN else (0,)
        uc = 1 if op in _USE_CARRY else 0
        for last in (0, 1):
            for a in range(1 << slice_bits):
                for b in range(1 << slice_bits):
                    for cin in cins:
                        c, cout = _op_semantics(op, a, b, cin, last,
                                                slice_bits)
                        rows.append((last, opc, a, b, cin, c, cout, uc))
    return rows


def build_air(n_bits: int, slice_bits: int = SLICE_BITS) -> AIR:
    n = 1 << n_bits
    group = rows_per_op(slice_bits)
    assert n % group == 0
    air = AIR("binary", n_bits)
    opc, a, b, c, cin, cout, act, usec = air.committed(
        "OPC", "A", "B", "C", "CIN", "COUT", "ACT", "USECARRY")
    aa = air.committed(*[f"AA{j}" for j in range(8)])
    bb = air.committed(*[f"BB{j}" for j in range(8)])
    cc = air.committed(*[f"CC{j}" for j in range(8)])

    # FIRST / GLAST: op-start and op-end rows
    first = np.zeros(n, dtype=np.uint64)
    first[::group] = 1
    FIRST = air.constant("FIRST", first)
    glast = np.zeros(n, dtype=np.uint64)
    glast[group - 1::group] = 1
    GLAST = air.constant("GLAST", glast)

    # FACTOR_j: weight of row k's slice inside 32-bit limb j
    factors = []
    for j in range(8):
        vals = np.zeros(n, dtype=np.uint64)
        for k in range(group):
            if (k * slice_bits) // 32 == j:
                vals[k::group] = 1 << ((k * slice_bits) % 32)
        factors.append(air.constant(f"FACTOR{j}", vals))

    # semantics table as constant columns, cyclically padded to N
    rows = _table_rows(slice_bits)
    assert len(rows) <= n, f"table ({len(rows)}) larger than domain ({n})"
    cols = list(zip(*rows))
    tcols = []
    for name, vals in zip(("TLAST", "TOP", "TA", "TB", "TCIN", "TC",
                           "TCOUT", "TUC"), cols):
        arr = np.array(
            [vals[i % len(rows)] for i in range(n)], dtype=np.uint64
        )
        tcols.append(air.constant(name, arr))

    # 1. per-row semantics (incl. the table-bound USECARRY attribute):
    #    (GLAST, OPC, A, B, CIN, C, COUT, USECARRY) in table
    air.lookup([ex.Const(GLAST.id), opc, a, b, cin, c, cout, usec],
               list(tcols))
    # 2. carry chaining inside an operation: (1 - FIRST') * (CIN' - COUT)
    FIRSTp = ex.Const(FIRST.id, True)
    air.require_zero((1 - FIRSTp) * (ex.Cm(cin.id, True) - cout))
    # 3. opcode/activity constant within an operation
    air.require_zero((1 - FIRSTp) * (ex.Cm(opc.id, True) - opc))
    air.require_zero((1 - FIRSTp) * (ex.Cm(act.id, True) - act))
    air.require_zero(act * (1 - act))
    # 4. limb accumulators: ACC' = (1-FIRST')·ACC + FACTOR'·slice'
    for regs, sl in ((aa, a), (bb, b), (cc, c)):
        slp = ex.Cm(sl.id, True)
        for j in range(8):
            Fp = ex.Const(factors[j].id, True)
            air.require_zero(
                ex.Cm(regs[j].id, True)
                - (1 - FIRSTp) * regs[j] - Fp * slp)
    return air


def execute(actions: list[dict], n_bits: int,
            slice_bits: int = SLICE_BITS) -> np.ndarray:
    """actions: [{op, a, b}] with a, b 256-bit ints. Returns (N, 32) trace."""
    n = 1 << n_bits
    group = rows_per_op(slice_bits)
    mask = (1 << slice_bits) - 1
    tr = np.zeros((n, 32), dtype=np.uint64)
    assert len(actions) * group <= n, "too many binary actions for domain"
    r = 0
    for act in actions:
        op = act["op"]
        opc = OPS[op]
        cin = _INIT_CIN[op]
        uc = 1 if op in _USE_CARRY else 0
        acc = [[0] * 8 for _ in range(3)]
        for k in range(group):
            an = (act["a"] >> (slice_bits * k)) & mask
            bn = (act["b"] >> (slice_bits * k)) & mask
            c, cout = _op_semantics(op, an, bn, cin, k == group - 1,
                                    slice_bits)
            j = (k * slice_bits) // 32
            w = 1 << ((k * slice_bits) % 32)
            for i, v in enumerate((an, bn, c)):
                acc[i][j] += w * v
            tr[r] = (opc, an, bn, c, cin, cout, 1, uc,
                     *acc[0], *acc[1], *acc[2])
            r += 1
            cin = cout
    # padding rows are zero (an ADD 0+0 slice, ACT=0)
    return tr


def result(op: str, a: int, b: int) -> tuple[int, int]:
    """(256-bit result, carry) oracle for one operation."""
    group = rows_per_op(SLICE_BITS)
    mask = (1 << SLICE_BITS) - 1
    cin = _INIT_CIN[op]
    out = 0
    for k in range(group):
        c, cin = _op_semantics(op, (a >> (SLICE_BITS * k)) & mask,
                               (b >> (SLICE_BITS * k)) & mask, cin,
                               k == group - 1, SLICE_BITS)
        out |= c << (SLICE_BITS * k)
    if op in ("LT", "SLT", "EQ"):
        out = cin  # comparison result rides the carry chain
    return out, cin


def results(actions: list[dict]) -> list[int]:
    return [result(a["op"], a["a"], a["b"])[0] for a in actions]
