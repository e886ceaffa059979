"""Memory SM — EVM memory access-log consistency.

Port of `zkevm_prover_tpu/executor/sm/memory.py` (host-only numpy):
the same AIR and trace.

Reference: src/sm/memory/memory_executor.cpp — the access trace ordered by
(addr, step); reads must return the last written value, fresh addresses read
zero. Committed columns:

  ADDR, STEP       access coordinates (sorted lexicographically)
  MOP              1 on real accesses, 0 on padding
  MWR              1 = write, 0 = read
  VAL0..VAL7       value as 8 x 32-bit chunks
  LASTA            1 when the NEXT row starts a different address

Constraints (with ' = next row):
  booleans:   MOP, MWR, LASTA in {0,1}
  write gate: MWR allowed only when MOP (padding is read-shaped zeros)
  continuity: within an address run (LASTA=0, MOP'=1), a read row' inherits
              the value: (1-LASTA)·MOP'·(1-MWR')·(VALi' - VALi) == 0
  fresh read: first access of an address that is a read sees zero:
              handled by requiring the first row of a run with MWR=0 to have
              VALi = 0 — encoded with the run-start selector START
              (START = LASTA of the previous row, materialized as a column)
  ordering:   (ADDR' - ADDR) · (1 - LASTA-flip consistency) — the sort order
              itself is enforced by a plookup of the increment into a range
              table: LASTA=0 -> STEP'-STEP-1 in [0,N); LASTA=1 -> ADDR'-ADDR-1
              in [0,N).
"""

from __future__ import annotations

import numpy as np

from ...stark import expr as ex
from ...stark.air import AIR

N_VAL = 8


def build_air(n_bits: int) -> AIR:
    n = 1 << n_bits
    air = AIR("memory", n_bits)
    addr, step, mop, mwr, lasta, start = air.committed(
        "ADDR", "STEP", "MOP", "MWR", "LASTA", "START"
    )
    vals = air.committed(*[f"VAL{i}" for i in range(N_VAL)])

    rng = air.constant("RANGE", np.arange(n, dtype=np.uint64))
    l1 = air.lagrange_first()
    not_last = np.ones(n, dtype=np.uint64)
    not_last[n - 1] = 0
    NL = air.constant("NOT_LAST", not_last)  # gates the cyclic wrap away

    for b in (mop, mwr, lasta, start):
        air.require_zero(b * (b - 1))
    air.require_zero(mwr * (1 - mop))

    # START' = LASTA (run starts after a run ends); row 0 starts a run if MOP
    air.require_zero(NL * (ex.Cm(start.id, True) - lasta))
    air.require_zero(l1 * (start - mop))

    # fresh read: START·(1-MWR)·VALi == 0
    for v in vals:
        air.require_zero(start * (1 - mwr) * v)

    # address constant within a run (pins LASTA=0 to addr'==addr)
    addr_p, step_p = ex.Cm(addr.id, True), ex.Cm(step.id, True)
    air.require_zero(NL * (1 - lasta) * (addr_p - addr))

    # read continuity within a run
    mop_p, mwr_p = ex.Cm(mop.id, True), ex.Cm(mwr.id, True)
    for v in vals:
        vp = ex.Cm(v.id, True)
        air.require_zero(NL * (1 - lasta) * mop_p * (1 - mwr_p) * (vp - v))

    # ordering via range plookup: within a run STEP strictly increases, on a
    # run boundary ADDR strictly increases. inc-1 must land in [0, N^2) —
    # two committed domain-sized limbs, because the zkEVM address space
    # (useCTX runs at 0x40000·CTX, main_executor.cpp:841-866) jumps by far
    # more than a small test domain between runs.
    ilo, ihi = air.committed("INCLO", "INCHI")
    inc = lasta * (addr_p - addr) + (1 - lasta) * (step_p - step)
    gate = NL * mop_p  # only transitions into real rows, never the wrap
    air.require_zero(gate * (inc - 1 - ilo - ihi * n))
    air.require_zero((1 - gate) * (ilo + ihi))
    air.lookup([ilo], [rng])
    air.lookup([ihi], [rng])
    return air


def execute(actions: list[dict], n_bits: int) -> tuple[np.ndarray, list]:
    """actions: [{addr, step, wr, value(256-bit int)}] in program order.

    Returns the (N, 14) sorted trace and the read results in program order.
    """
    n = 1 << n_bits
    mem: dict[int, tuple] = {}
    reads = []
    rows = []
    for a in actions:
        # limbs may be arbitrary field elements (the Main SM MSTOREs op
        # verbatim, e.g. -1 mod p from a JMPN guard) — carry the raw fea
        # when provided, else split the 256-bit scalar
        if "fea" in a:
            chunks = tuple(int(x) for x in a["fea"])
        else:
            v = a["value"] % (1 << 256)
            chunks = tuple((v >> (32 * k)) & 0xFFFFFFFF for k in range(N_VAL))
        if a["wr"]:
            mem[a["addr"]] = chunks
        else:
            chunks = mem.get(a["addr"], (0,) * N_VAL)
            reads.append(sum(c << (32 * k) for k, c in enumerate(chunks)))
        rows.append((a["addr"], a["step"], 1, 1 if a["wr"] else 0, chunks))
    rows.sort(key=lambda r: (r[0], r[1]))
    assert len(rows) <= n

    tr = np.zeros((n, 8 + N_VAL), dtype=np.uint64)
    for i, (ad, st, mop, mwr, chunks) in enumerate(rows):
        lasta = 1 if (i + 1 >= len(rows) or rows[i + 1][0] != ad) else 0
        start = 1 if (i == 0 or rows[i - 1][0] != ad) else 0
        tr[i] = (ad, st, mop, mwr, lasta, start, *chunks, 0, 0)
        if i + 1 < len(rows):
            inc = (rows[i + 1][0] - ad) if lasta else (rows[i + 1][1] - st)
            tr[i, 6 + N_VAL] = (inc - 1) % n
            tr[i, 7 + N_VAL] = (inc - 1) // n
    if rows:
        tr[len(rows) - 1, 4] = 1  # last real row ends its run
        tr[len(rows) - 1, 6 + N_VAL] = 0
        tr[len(rows) - 1, 7 + N_VAL] = 0
    # padding rows: all zeros (MOP=0); START of first padding row must equal
    # LASTA of the last real row per the transition constraint
    if len(rows) < n:
        tr[len(rows), 5] = tr[len(rows) - 1, 4] if rows else 0
    return tr, reads
