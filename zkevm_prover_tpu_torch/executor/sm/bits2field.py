"""Bits2Field SM — pack per-block bits into the gate SMs' bit-sliced lanes.

Reference: src/sm/bits2field/bits2field_executor.cpp:7-44 — field element
i of the KeccakF input is built by accumulating bit j of 44 consecutive
hash instances into lane j (`field[i] |= bit << j` over 44 rows). This SM
is that role for both gate machines (KeccakF / Sha256F): rows are grouped
`pack` per (slot, bit-position) pair in instance-major order, so the
accumulators run row-locally; the final accumulator of each group is the
packed element the gate SM's input/output row must carry (bound by a
combined-AIR permutation on (SLOTID, POS, element)), and each row's
(block, pos, bitIn, bitOut) tuple is bound per-bit to the HashBit SM.

Committed: BITIN, BITOUT, ACCI, ACCO.

Port of `zkevm_prover_tpu/executor/sm/bits2field.py`, imports rewritten.
"""

from __future__ import annotations

import numpy as np

from ...stark import expr as ex
from ...stark.air import AIR

COLS = ["BITIN", "BITOUT", "ACCI", "ACCO"]


def capacity_slots(n_bits: int, n_pos: int, pack: int) -> int:
    """How many gate-SM slots this domain can pack."""
    return (1 << n_bits) // pack // n_pos


def build_air(n_bits: int, n_pos: int, out_bits: int, pack: int,
              n_slots: int, name: str = "bits2field") -> AIR:
    n = 1 << n_bits
    n_groups = n_slots * n_pos
    assert n_groups * pack <= n, "bits2field domain overflow"
    air = AIR(name, n_bits)
    bitin, bitout, acci, acco = air.committed(*COLS)

    used_rows = n_groups * pack
    sid = np.zeros(n, dtype=np.uint64)
    posg = np.zeros(n, dtype=np.uint64)
    jcol = np.zeros(n, dtype=np.uint64)
    p2j = np.zeros(n, dtype=np.uint64)
    outv = np.zeros(n, dtype=np.uint64)
    idx = np.arange(used_rows)
    grp = idx // pack
    jj = idx % pack
    sid[:used_rows] = grp // n_pos
    posg[:used_rows] = grp % n_pos
    jcol[:used_rows] = jj
    p2j[:used_rows] = 1 << jj.astype(np.uint64)
    outv[:used_rows] = (grp % n_pos < out_bits).astype(np.uint64)
    used = np.zeros(n, dtype=np.uint64)
    used[:used_rows] = 1
    jfirst = np.zeros(n, dtype=np.uint64)
    jfirst[:used_rows] = (jj == 0).astype(np.uint64)
    jlast = np.zeros(n, dtype=np.uint64)
    jlast[:used_rows] = (jj == pack - 1).astype(np.uint64)

    SID = air.constant("SID", sid)
    POSG = air.constant("POSG", posg)
    J = air.constant("J", jcol)
    P2J = air.constant("P2J", p2j)
    USED = air.constant("USED", used)
    JFIRST = air.constant("JFIRST", jfirst)
    air.constant("JLAST", jlast)
    OUTV = air.constant("OUTV", outv)
    # continuation gate: next row extends the current group
    G2 = air.constant("G2", (np.roll(used, -1)
                             * (1 - np.roll(jfirst, -1))).astype(np.uint64))
    # JLASTOUT = JLAST·OUTV folded for the output permutation selector
    air.constant("JLASTOUT", jlast * outv)

    for b in (bitin, bitout):
        air.require_zero(b * (1 - b))
    air.require_zero((1 - OUTV) * bitout)
    air.require_zero((1 - OUTV) * acco)
    air.require_zero((1 - USED) * bitin)
    air.require_zero((1 - USED) * acci)

    acci_p, acco_p = ex.Cm(acci.id, True), ex.Cm(acco.id, True)
    bitin_p, bitout_p = ex.Cm(bitin.id, True), ex.Cm(bitout.id, True)
    P2Jp = ex.Const(P2J.id, True)
    air.require_zero(JFIRST * (acci - bitin))
    air.require_zero(G2 * (acci_p - acci - bitin_p * P2Jp))
    air.require_zero(JFIRST * OUTV * (acco - bitout))
    air.require_zero(G2 * (acco_p - acco - bitout_p * P2Jp))

    _ = (SID, POSG, J)  # exposed for combined-AIR bindings
    return air


def execute(blocks_bits: list[tuple], n_bits: int, n_pos: int,
            out_bits: int, pack: int, n_slots: int) -> np.ndarray:
    """blocks_bits: [(sin_bits, sout_bits)] for the n_slots*pack blocks in
    pipeline order; sout_bits may be shorter than n_pos (out_bits)."""
    n = 1 << n_bits
    assert len(blocks_bits) == n_slots * pack
    tr = np.zeros((n, len(COLS)), dtype=np.uint64)
    ci = {nm: i for i, nm in enumerate(COLS)}
    row = 0
    for s in range(n_slots):
        for p in range(n_pos):
            acci = acco = 0
            for j in range(pack):
                sin, sout = blocks_bits[s * pack + j]
                bi = int(sin[p])
                acci += bi << j
                tr[row, ci["BITIN"]] = bi
                tr[row, ci["ACCI"]] = acci
                if p < out_bits:
                    bo = int(sout[p])
                    acco += bo << j
                    tr[row, ci["BITOUT"]] = bo
                    tr[row, ci["ACCO"]] = acco
                row += 1
    return tr
