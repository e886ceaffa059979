"""MemAlign SM — unaligned 256-bit reads and writes across two words.

Port of `zkevm_prover_tpu/executor/sm/mem_align.py` (host-only numpy):
the same AIR and trace, with the routing-factor constant columns filled by
numpy instead of a Python loop over rows.

Reference: src/sm/mem_align/ (unaligned read/write over a W0‖W1 64-byte
window with byte routing via factor/reset tables). TPU-first redesign: one
operation occupies a 128-row group —

  rows 0..63   window rows: B = byte i of W0‖W1 (little-endian),
               accumulated into the W0/W1 limb registers with CONSTANT
               factors (F = 256^(i%4) routed to limb i>>2); BO = byte i of
               the OUTPUT window (writes), accumulated into NM0/NM1
  rows 64..95  value rows: B = byte k of V, accumulated into the V limbs
  rows 96..127 idle

and the offset logic collapses into plookups: for reads, every value
row's pair (OFF + k, B) must appear among the window rows' (WPOS, B);
for writes, every in-range window row's (WPOS − OFF, BO) must appear
among the value rows' (KPOS, B), with the in-range indicator INS forced
to cover exactly [OFF, OFF+span) by a [0, span) position lookup plus a
counted total (span = 32, or 1 for the WR8 single-byte write). Window
positions are unique per group, so each routed byte is pinned to exactly
the right partner — no offset-dependent factor tables.

Committed: B, BO, OFF, INS, CNT, ISWR, ISWR8, the M0/M1/V/NM0/NM1
running limb accumulators (finals at the last group row), and ACT (the
active-group flag selecting interface rows for the Main binding).
"""

from __future__ import annotations

import numpy as np

from ...stark import expr as ex
from ...stark.air import AIR

GROUP = 128
WIN = 64     # window rows per group
VAL = 32     # value rows per group
N_LIMB = 8   # 32-bit limbs per 256-bit value


def build_air(n_bits: int) -> AIR:
    n = 1 << n_bits
    assert n % GROUP == 0
    air = AIR("mem_align", n_bits)
    b = air.committed("B")
    off = air.committed("OFF")
    m0 = air.committed(*[f"M0_{j}" for j in range(N_LIMB)])
    m1 = air.committed(*[f"M1_{j}" for j in range(N_LIMB)])
    v = air.committed(*[f"V_{j}" for j in range(N_LIMB)])
    bo = air.committed("BO")
    ins = air.committed("INS")
    cnt = air.committed("CNT")
    iswr, iswr8 = air.committed("ISWR", "ISWR8")
    nm0 = air.committed(*[f"NM0_{j}" for j in range(N_LIMB)])
    nm1 = air.committed(*[f"NM1_{j}" for j in range(N_LIMB)])
    act = air.committed("ACT")  # 1 on rows of an active operation group

    pos = np.arange(n, dtype=np.uint64) % GROUP
    wsel = (pos < WIN).astype(np.uint64)
    vsel = ((pos >= WIN) & (pos < WIN + VAL)).astype(np.uint64)
    clk0 = (pos == 0).astype(np.uint64)
    not_last = (pos != GROUP - 1).astype(np.uint64)

    WSEL = air.constant("WSEL", wsel)
    VSEL = air.constant("VSEL", vsel)
    CLK0 = air.constant("CLK0", clk0)
    NLG = air.constant("NOT_LAST_G", not_last)
    WPOS = air.constant("WPOS", np.where(pos < WIN, pos, 0).astype(np.uint64))
    KPOS = air.constant(
        "KPOS", np.where(vsel == 1, pos - WIN, 0).astype(np.uint64)
    )
    BYTERANGE = air.constant(
        "BYTERANGE", (np.arange(n, dtype=np.uint64) % 256)
    )
    OFFRANGE = air.constant(
        "OFFRANGE", (np.arange(n, dtype=np.uint64) % 64)
    )
    # group id scopes the index-byte binding to its own operation (the
    # lookup is a global multiset argument)
    GID = air.constant("GID", (np.arange(n, dtype=np.uint64) // GROUP))

    # routing factors (constant): window byte i -> W0/W1 limb (i>>2)%8 with
    # multiplier 256^(i%4); value byte k -> V limb k>>2 likewise
    def factor_col(name, active_of):
        # one group's pattern (rows depend only on pos), tiled over N
        cols = []
        for j in range(N_LIMB):
            group = np.zeros(GROUP, dtype=np.uint64)
            for p in range(GROUP):
                a = active_of(p)
                if a is not None and a[0] == j:
                    group[p] = a[1]
            cols.append(air.constant(f"{name}{j}", np.tile(group, n // GROUP)))
        return cols

    f0 = factor_col("F0_", lambda p: ((p >> 2), 1 << (8 * (p & 3)))
                    if p < 32 else None)
    f1 = factor_col("F1_", lambda p: (((p - 32) >> 2), 1 << (8 * (p & 3)))
                    if 32 <= p < 64 else None)
    fv = factor_col("FV_", lambda p: (((p - WIN) >> 2), 1 << (8 * ((p - WIN) & 3)))
                    if WIN <= p < WIN + VAL else None)

    # group-start resets and OFF constancy
    for col in (*m0, *m1, *v):
        air.require_zero(CLK0 * col)
    air.require_zero(NLG * (ex.Cm(off.id, True) - off))

    # accumulator transitions: X' = X + B·F (factors are zero off-rows)
    for j in range(N_LIMB):
        air.require_zero(
            NLG * (ex.Cm(m0[j].id, True) - (m0[j] + b * f0[j]))
        )
        air.require_zero(
            NLG * (ex.Cm(m1[j].id, True) - (m1[j] + b * f1[j]))
        )
        air.require_zero(
            NLG * (ex.Cm(v[j].id, True) - (v[j] + b * fv[j]))
        )

    # the offset semantics (reads): value rows' (GID, OFF + k, B) must
    # appear among window rows' (GID, WPOS, B); writes route the other way
    air.lookup([GID, off + KPOS, b], [GID, WPOS, b],
               sel_f=VSEL * (1 - iswr - iswr8), sel_t=WSEL)
    # byte and offset ranges
    air.lookup([b], [BYTERANGE])
    air.lookup([off], [OFFRANGE])

    # ---- write path ------------------------------------------------------
    wany = iswr + iswr8
    for f in (iswr, iswr8, ins):
        air.require_zero(f * (1 - f))
    air.require_zero(iswr * iswr8)
    air.require_zero(NLG * (ex.Cm(iswr.id, True) - iswr))
    air.require_zero(NLG * (ex.Cm(iswr8.id, True) - iswr8))
    air.require_zero(ins * (1 - ex.Const(WSEL.id)))  # INS only on window rows
    air.require_zero(ins * (1 - wany))               # and only on writes

    # INS covers exactly [OFF, OFF+span): positions in range + full count
    span_pos = np.zeros(n, dtype=np.uint64)  # table of [0, 32)
    span_pos[:] = np.arange(n, dtype=np.uint64) % 32
    SPAN32 = air.constant("SPAN32", span_pos)
    # for WR: INS rows have WPOS-OFF in [0,32); for WR8 the only INS row
    # sits exactly at OFF
    air.lookup([ex.Const(WPOS.id) - off], [SPAN32], sel_f=ins * iswr)
    air.require_zero(ins * iswr8 * (ex.Const(WPOS.id) - off))
    # CNT counts INS across the group; the window's end sees the full span
    air.require_zero(CLK0 * cnt)
    air.require_zero(NLG * (ex.Cm(cnt.id, True) - (cnt + ins)))
    WEND = air.constant(
        "WEND", (pos == WIN).astype(np.uint64))  # first value row
    air.require_zero(WEND * (cnt - iswr * 32 - iswr8))

    # output bytes: in-range rows take the value's byte (WR: byte WPOS-OFF;
    # WR8: byte 0 — KPOS 0 row), out-of-range rows copy the old byte
    air.lookup([GID, (1 - iswr8) * (ex.Const(WPOS.id) - off), bo],
               [GID, KPOS, b], sel_f=ins, sel_t=VSEL)
    air.require_zero(ex.Const(WSEL.id) * (1 - ins) * (bo - b))
    air.lookup([bo], [BYTERANGE])

    # NM accumulators mirror M with the output bytes
    for j in range(N_LIMB):
        air.require_zero(CLK0 * nm0[j])
        air.require_zero(CLK0 * nm1[j])
        air.require_zero(
            NLG * (ex.Cm(nm0[j].id, True) - (nm0[j] + bo * f0[j])))
        air.require_zero(
            NLG * (ex.Cm(nm1[j].id, True) - (nm1[j] + bo * f1[j])))

    # active-group flag: boolean, constant within a group — the interface
    # selector for the Main binding (one main memAlign row <-> one group)
    air.require_zero(act * (1 - act))
    air.require_zero(NLG * (ex.Cm(act.id, True) - act))
    return air


def execute(actions: list[dict], n_bits: int) -> tuple[np.ndarray, list]:
    """actions: [{op?: rd|wr|wr8, w0, w1, offset[, value]}].

    Returns the trace and per-action results: the read value for rd, the
    (new_w0, new_w1) pair for wr/wr8.
    """
    n = 1 << n_bits
    n_cols = 2 + 3 * N_LIMB + 5 + 2 * N_LIMB + 1
    tr = np.zeros((n, n_cols), dtype=np.uint64)
    assert len(actions) * GROUP <= n
    results = []
    for a_idx, act in enumerate(actions):
        op = act.get("op", "rd")
        w0, w1, offset = act["w0"], act["w1"], act["offset"]
        assert 0 <= offset <= (63 if op == "wr8" else 32)
        window = (w0 | (w1 << 256))
        if op == "rd":
            vbytes = [(window >> (8 * (offset + k))) & 0xFF
                      for k in range(VAL)]
            out_window = window
            results.append(
                sum(vb << (8 * k) for k, vb in enumerate(vbytes)))
            span = 0
        else:
            value = act["value"]
            vbytes = [(value >> (8 * k)) & 0xFF for k in range(VAL)]
            span = 1 if op == "wr8" else 32
            out_window = window
            for k in range(span):
                i = offset + k
                out_window = (out_window & ~(0xFF << (8 * i))) \
                    | (vbytes[k] << (8 * i))
            results.append((out_window & ((1 << 256) - 1),
                            out_window >> 256))
        iswr = 1 if op == "wr" else 0
        iswr8 = 1 if op == "wr8" else 0

        base = a_idx * GROUP
        m0 = [0] * N_LIMB
        m1 = [0] * N_LIMB
        vv = [0] * N_LIMB
        nm0 = [0] * N_LIMB
        nm1 = [0] * N_LIMB
        cntv = 0
        for p in range(GROUP):
            if p < WIN:
                byte = (window >> (8 * p)) & 0xFF
                obyte = (out_window >> (8 * p)) & 0xFF
                insv = 1 if (span and offset <= p < offset + span) else 0
            elif p < WIN + VAL:
                byte = vbytes[p - WIN]
                obyte = 0
                insv = 0
            else:
                byte = obyte = insv = 0
            tr[base + p] = ([byte, offset] + m0 + m1 + vv
                            + [obyte, insv, cntv, iswr, iswr8]
                            + nm0 + nm1 + [1])
            cntv += insv
            if p < 32:
                m0[p >> 2] += byte << (8 * (p & 3))
                nm0[p >> 2] += obyte << (8 * (p & 3))
            elif p < 64:
                m1[(p - 32) >> 2] += byte << (8 * ((p - 32) & 3))
                nm1[(p - 32) >> 2] += obyte << (8 * ((p - 32) & 3))
            elif p < WIN + VAL:
                k = p - WIN
                vv[k >> 2] += byte << (8 * (k & 3))
    return tr, results


def result(action: dict):
    window = action["w0"] | (action["w1"] << 256)
    op = action.get("op", "rd")
    if op == "rd":
        return (window >> (8 * action["offset"])) & ((1 << 256) - 1)
    span = 1 if op == "wr8" else 32
    for k in range(span):
        i = action["offset"] + k
        byte = (action["value"] >> (8 * k)) & 0xFF
        window = (window & ~(0xFF << (8 * i))) | (byte << (8 * i))
    return window & ((1 << 256) - 1), window >> 256
