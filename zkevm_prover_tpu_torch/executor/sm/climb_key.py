"""ClimbKey SM — SMT key reconstruction while climbing the tree.

Port of `zkevm_prover_tpu/executor/sm/climb_key.py` (host-only numpy):
the same AIR and trace.

Reference: src/sm/climb_key/climb_key_executor.cpp — one operation proves
key[level % 4]' = 2·key[level % 4] + bit with the result guaranteed below
the Goldilocks prime, by decomposing the lane into chunks processed over a
group of clock rows with carry and less-than chains (GL_CHUNKS /
CHUNK_MASKS tables at climb_key_executor.cpp:14-16).

TPU-first formulation: the per-clock carry/lt update collapses into ONE
plookup against a transition table

    mid clocks:  (POS, KIC, CARRYLT, KOC, CARRYLT') ∈ T_mid
    last clock:  (KIC, CARRYLT, KOC) ∈ T_last   — T_last only contains
                 transitions whose exit state is carry=0, lt=1, which IS
                 the "result < p" guarantee

with KEYIN/KEYOUT running recompositions binding the chunks to the
selected key lane (KEYSEL one-hot, bound to LEVEL % 4 by a third lookup).
Chunk width is parametric: 4 bits × 16 clocks for small test domains,
16 bits × 4 clocks for production (the reference uses 18/18/18/10).
"""

from __future__ import annotations

import numpy as np

from ...ops import refmodel as rm
from ...stark import expr as ex
from ...stark.air import AIR

P = rm.P
LIMIT_BEFORE_CLIMB = P >> 1


def _p_chunks(b: int, k: int) -> list[int]:
    return [(P >> (b * c)) & ((1 << b) - 1) for c in range(k)]


def _step(chunk: int, carry: int, lt: int, pos: int, b: int, k: int):
    """One clock of the reference's carry/lt recurrence."""
    climbed = 2 * chunk + carry
    koc = climbed & ((1 << b) - 1)
    carry_out = 1 if climbed > ((1 << b) - 1) else 0
    pc = _p_chunks(b, k)[pos]
    lt_out = 1 if koc < pc else (lt if koc == pc else 0)
    return koc, carry_out, lt_out


def params_for(n_bits: int) -> tuple[int, int]:
    """(chunk_bits, clocks): largest chunk width whose mid-table fits."""
    for b in (16, 8, 4, 2):
        k = 64 // b
        if (k - 1) * 4 * (1 << b) <= (1 << n_bits):
            return b, k
    raise ValueError(f"domain 2^{n_bits} too small for the climb table")


def build_air(n_bits: int, chunk_bits: int | None = None) -> AIR:
    n = 1 << n_bits
    b = chunk_bits if chunk_bits is not None else params_for(n_bits)[0]
    k = 64 // b
    assert n % k == 0
    air = AIR("climb_key", n_bits)
    key = air.committed(*[f"KEY{j}" for j in range(4)])
    level, bit = air.committed("LEVEL", "BIT")
    kic, koc = air.committed("KIC", "KOC")
    keyin, keyout = air.committed("KEYIN", "KEYOUT")
    carrylt = air.committed("CARRYLT")
    keysel = air.committed(*[f"KEYSEL{j}" for j in range(4)])

    pos = np.arange(n, dtype=np.uint64) % k
    ISFIRST = air.constant("ISFIRST", (pos == 0).astype(np.uint64))
    ISLAST = air.constant("ISLAST", (pos == k - 1).astype(np.uint64))
    ISRES = air.constant("ISRES", (pos == k - 2).astype(np.uint64))
    ISMID = air.constant("ISMID", (pos < k - 1).astype(np.uint64))
    POS = air.constant("POS", pos)
    FACTOR = air.constant(
        "FACTOR", np.array([1 << (b * int(p)) for p in pos], dtype=np.uint64)
    )
    nlast = np.ones(n, dtype=np.uint64)
    nlast[n - 1] = 0
    NL = air.constant("CNL", nlast)

    # ---- transition tables (constant columns, cyclically padded)
    mid_rows = []
    for p_ in range(k - 1):
        for c in range(1 << b):
            for carry in (0, 1):
                for lt in (0, 1):
                    oc, co, lo = _step(c, carry, lt, p_, b, k)
                    mid_rows.append((p_, c, carry + 2 * lt, oc, co + 2 * lo))
    last_rows = []
    for c in range(1 << b):
        for carry in (0, 1):
            for lt in (0, 1):
                oc, co, lo = _step(c, carry, lt, k - 1, b, k)
                if co == 0 and lo == 1:  # exit condition: result < p
                    last_rows.append((c, carry + 2 * lt, oc))
    assert len(mid_rows) <= n, f"mid table {len(mid_rows)} > {n}"

    def table(name, rows):
        cols = list(zip(*rows))
        return [
            air.constant(f"{name}{i}",
                         np.array([col[r % len(rows)] for r in range(n)],
                                  dtype=np.uint64))
            for i, col in enumerate(cols)
        ]

    tm = table("TM", mid_rows)
    tl = table("TL", last_rows)
    # level % 4 binding table
    lvl_rows = [(l, l % 4) for l in range(256)]
    tlv = table("TLV", lvl_rows)

    # ---- chunk transition lookups
    cl_p = ex.Cm(carrylt.id, True)
    air.lookup([POS, kic, carrylt, koc, cl_p], list(tm), sel_f=ISMID)
    air.lookup([kic, carrylt, koc], list(tl), sel_f=ISLAST)

    # ---- value recomposition chains
    air.require_zero(ISFIRST * (keyin - kic))
    air.require_zero(ISFIRST * (keyout - koc))
    fac_p = ex.Const(FACTOR.id, True)
    air.require_zero(
        NL * ISMID * (ex.Cm(keyin.id, True) - keyin - ex.Cm(kic.id, True) * fac_p)
    )
    air.require_zero(
        NL * ISMID * (ex.Cm(keyout.id, True) - keyout - ex.Cm(koc.id, True) * fac_p)
    )

    # ---- op-constant values and boundary conditions
    for col in (level, bit):
        air.require_zero(NL * (1 - ISLAST) * (ex.Cm(col.id, True) - col))
    air.require_zero(bit * (bit - 1))
    air.require_zero(ISFIRST * (carrylt - bit))

    # ---- key selection and update (evaluated on the RESULT row, reaching
    # into the last row via primes: KEYIN'/KEYOUT' are complete there)
    for j in range(4):
        air.require_zero(keysel[j] * (keysel[j] - 1))
        air.require_zero((1 - ISLAST) * keysel[j])
        # key constant inside the op except the selected lane at the last row
        ksel_p = ex.Cm(keysel[j].id, True)
        air.require_zero(
            NL * ISMID * (ex.Cm(key[j].id, True) - key[j]
                          - ksel_p * (ex.Cm(keyout.id, True) - key[j]))
        )
    sel_sum = keysel[0] + keysel[1] + keysel[2] + keysel[3]
    air.require_zero(ISLAST * (sel_sum - 1))
    # the selected lane's original value is what the chunks decompose
    bind = None
    for j in range(4):
        term = ex.Cm(keysel[j].id, True) * key[j]
        bind = term if bind is None else bind + term
    air.require_zero(NL * ISRES * (bind - ex.Cm(keyin.id, True)))
    # KEYSEL encodes LEVEL % 4
    lane = keysel[1] + keysel[2] * 2 + keysel[3] * 3
    air.lookup([level, lane], list(tlv), sel_f=ISLAST)
    return air


def execute(actions: list[dict], n_bits: int,
            chunk_bits: int | None = None) -> np.ndarray:
    """actions: [{key: [4 GL ints], level, bit}]; k rows per op.

    Raises if 2·key[level%4] + bit would reach the prime (the reference's
    ClimbKeyHelper precondition, climb_key_executor.cpp:111-119).
    """
    n = 1 << n_bits
    b = chunk_bits if chunk_bits is not None else params_for(n_bits)[0]
    k = 64 // b
    n_cols = 15
    tr = np.zeros((n, n_cols), dtype=np.uint64)
    assert len(actions) * k <= n
    COL = {name: i for i, name in enumerate(
        ["K0", "K1", "K2", "K3", "LEVEL", "BIT", "KIC", "KOC",
         "KEYIN", "KEYOUT", "CARRYLT", "S0", "S1", "S2", "S3"])}

    for a_idx, act in enumerate(actions):
        keyv = [int(v) % P for v in act["key"]]
        lvl, bitv = int(act["level"]), int(act["bit"])
        z = lvl % 4
        value = keyv[z]
        if value > LIMIT_BEFORE_CLIMB - bitv:
            raise ValueError("climb would reach the field prime")
        climbed = 2 * value + bitv
        base = a_idx * k
        carry, lt = bitv, 0
        keyin = keyout = 0
        for c in range(k):
            chunk = (value >> (b * c)) & ((1 << b) - 1)
            oc, carry_out, lt_out = _step(chunk, carry, lt, c, b, k)
            keyin += chunk << (b * c)
            keyout += oc << (b * c)
            row = tr[base + c]
            newkey = list(keyv)
            if c == k - 1:
                newkey[z] = climbed
            row[COL["K0"]:COL["K3"] + 1] = newkey
            row[COL["LEVEL"]] = lvl
            row[COL["BIT"]] = bitv
            row[COL["KIC"]] = chunk
            row[COL["KOC"]] = oc
            row[COL["KEYIN"]] = keyin
            row[COL["KEYOUT"]] = keyout
            row[COL["CARRYLT"]] = carry + 2 * lt
            if c == k - 1:
                row[COL["S0"] + z] = 1
            carry, lt = carry_out, lt_out
        assert keyout == climbed and carry == 0 and lt == 1

    # padding ops (zero key, bit 0): the recurrence immediately proves
    # 0 < p, so CARRYLT = 2 from the second clock on; lane 0 selected
    for g in range(len(actions) * k, n, k):
        tr[g + 1 : g + k, COL["CARRYLT"]] = 2
        tr[g + k - 1, COL["S0"]] = 1
    return tr


def result(action: dict) -> list[int]:
    keyv = [int(v) % P for v in action["key"]]
    z = int(action["level"]) % 4
    keyv[z] = 2 * keyv[z] + int(action["bit"])
    assert keyv[z] < P
    return keyv
