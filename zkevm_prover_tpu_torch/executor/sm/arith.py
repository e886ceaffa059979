"""Arith SM — 256-bit mul-add, secp256k1 points, and BN254 Fp2 arithmetic.

Port of `zkevm_prover_tpu/executor/sm/arith.py` (host-only numpy):
the same AIR and trace.

Reference: src/sm/arith/ (sm_arith_eq0..eq10; selEq wiring in
arith_executor.cpp:230-505). Equations over 16-bit limb columns, one
operation per 32-row group, selectors choosing which identities are live:

  SELEQ0  (ref selEq0):   eq0   x1·y1 + x2 = y2·2^256 + y3
  SELADD  (ref selEq1&3): eq1   s·(x2-x1) ≡ y2-y1        (mod p_secp)
  SELDBL  (ref selEq2&3): eq2   2·s·y1 ≡ 3·x1²           (mod p_secp)
          (both):         eq3   x3 ≡ s² - x1 - x2'        (x2' = x1 on dbl)
                          eq4   y3 ≡ s·(x1-x3) - y1
  SELMUL2 (ref selEq4):   eq5   x3 ≡ x1·x2 - y1·y2       (mod p_bn254)
                          eq6   y3 ≡ y1·x2 + x1·y2
  SELADD2 (ref selEq5):   eq7/8   x3 ≡ x1+x2, y3 ≡ y1+y2 (mod p_bn254)
  SELSUB2 (ref selEq6):   eq9/10  x3 ≡ x1-x2, y3 ≡ y1-y2 (mod p_bn254)

Each modular identity is proven as an exact integer statement
E ± p·OFF = ±p·QHAT with a committed 17-limb nonnegative quotient and a
signed carry chain (range-checked in a shifted window); the constant
p·OFF's 2^512 limb, when present, is folded into row 31's carry-out slot.
The identities share three carry chains (slope / x3 / y3), CLK-muxed by
the selectors exactly like the reference's carry[0..2] sharing
(arith_executor.cpp:454-465 eqIndexToCarryIndex).

Soundness hardening beyond the bare chains:
  * every 16-bit limb column is range-proven: the 163 limb/quotient
    columns are checked round-robin over the 32 group rows by 6 "lanes",
    each lane decomposing the CLK-muxed limb into two byte chunks looked
    up in a BYTE constant column (2^16-entry tables don't exist at test
    domains, so limb = LO + 256·HI with LO committed and HI derived);
  * alias-free x3/y3: an MSB-first chunk scan proves x3 < p and y3 < p
    for every modular op (reference chunkLtPrime/valueLtPrime columns,
    arith_executor.cpp:432-442) — without it y3 + p would also satisfy
    the chains;
  * SELADD requires x2 ≠ x1: a chunk-difference inverse witness
    accumulates an "xAreDifferent" flag over rows 0..15 that must be 1
    (reference xDeltaChunkInverse/xAreDifferent, :420-429).

Row layout per group: limb/selector columns constant within the group;
row k carries the weight-2^16k balance of every live equation.
"""

from __future__ import annotations

import numpy as np

from ...stark import expr as ex
from ...stark.air import AIR

L = 16          # limbs per 256-bit operand
QL = 17         # quotient limbs (QHAT < 2^260 worst case)
W = 1 << 16     # limb base
GROUP = 32      # rows per operation
CARRY_BITS = 20       # eq0 carry < 16·2^16 (unsigned)
EC_CARRY_BITS = 27    # modular chains: |carry| < 2^26, window [0, 2^27)
EC_SHIFT = 1 << 26

FPEC = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
PBN = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
# quotient offsets per equation (derived from each E's exact range; the
# BN254 offsets are the reference's arith_executor.cpp:260,270 constants)
OFF_SLOPE = 3 * FPEC          # covers add (|q|<=p) and dbl (q in (-3p, 2p))
OFF_X3 = 4
OFF_Y3 = FPEC + 2
OFF_MUL2X = 1 << 259          # eq5:  x1·x2 - y1·y2 - x3 + p·q1 - p·2^259
OFF_BN8 = 8                   # eq6..10 use ±p·8

MASK256 = (1 << 256) - 1


def _limbs(v: int, count: int) -> list[int]:
    return [(v >> (16 * i)) & 0xFFFF for i in range(count)]


# constant D = p·OFF as 33 limbs; d[32] folds into row 31 of the chain
_D_SLOPE = _limbs(FPEC * OFF_SLOPE, 33)
_D_X3 = _limbs(FPEC * OFF_X3, 33)
_D_Y3 = _limbs(FPEC * OFF_Y3, 33)
_D_MUL2X = _limbs(PBN * OFF_MUL2X, 33)
_D_BN8 = _limbs(PBN * OFF_BN8, 33)
_P_LIMBS = _limbs(FPEC, L)
_PBN_LIMBS = _limbs(PBN, L)

N_RANGE_LANES = 6   # ceil(163 limb columns / 32 rows)
_INV256 = pow(256, 0xFFFFFFFF00000001 - 2, 0xFFFFFFFF00000001)


def carry_chunks(n_bits: int) -> int:
    return -(-CARRY_BITS // n_bits)


def ec_carry_chunks(n_bits: int) -> int:
    return -(-EC_CARRY_BITS // n_bits)


def _conv(a, b, k, la=L, lb=L):
    """Σ_{i+j=k} a_i·b_j as an expression (None when empty)."""
    acc = None
    for i in range(max(0, k - lb + 1), min(la, k + 1)):
        t = a[i] * b[k - i]
        acc = t if acc is None else acc + t
    return acc


def _conv_const(c, b, k, lb=QL):
    """Σ_{i+j=k} c_i·b_j with constant limbs c."""
    acc = None
    for i in range(max(0, k - lb + 1), min(L, k + 1)):
        if c[i] == 0:
            continue
        t = b[k - i] * int(c[i])
        acc = t if acc is None else acc + t
    return acc


def build_air(n_bits: int) -> AIR:
    n = 1 << n_bits
    assert n % GROUP == 0
    assert n_bits >= 8, "BYTE range table needs a 2^8 domain"
    air = AIR("arith", n_bits)
    x1 = air.committed(*[f"X1_{i}" for i in range(L)])
    y1 = air.committed(*[f"Y1_{i}" for i in range(L)])
    x2 = air.committed(*[f"X2_{i}" for i in range(L)])
    y2 = air.committed(*[f"Y2_{i}" for i in range(L)])
    y3 = air.committed(*[f"Y3_{i}" for i in range(L)])
    x3 = air.committed(*[f"X3_{i}" for i in range(L)])
    s = air.committed(*[f"S_{i}" for i in range(L)])
    q0 = air.committed(*[f"Q0_{i}" for i in range(QL)])
    q1 = air.committed(*[f"Q1_{i}" for i in range(QL)])
    q2 = air.committed(*[f"Q2_{i}" for i in range(QL)])
    sel0, seladd, seldbl = air.committed("SELEQ0", "SELADD", "SELDBL")
    selmul2, seladd2, selsub2 = air.committed("SELMUL2", "SELADD2",
                                              "SELSUB2")
    n0 = carry_chunks(n_bits)
    car0 = air.committed(*[f"CAR_{j}" for j in range(n0)])
    if n0 == 1:
        car0 = (car0,)
    ne = ec_carry_chunks(n_bits)
    cars = air.committed(*[f"CARS_{j}" for j in range(ne)])
    carx = air.committed(*[f"CARX_{j}" for j in range(ne)])
    cary = air.committed(*[f"CARY_{j}" for j in range(ne)])
    if ne == 1:
        cars, carx, cary = (cars,), (carx,), (cary,)
    rlo = air.committed(*[f"RLO_{j}" for j in range(N_RANGE_LANES)])
    ltc, vlt, ltlo = air.committed("LTC", "VLT", "LTLO")
    xdif, xinv, xt = air.committed("XDIF", "XINV", "XT")

    clk = []
    for k in range(GROUP):
        v = np.zeros(n, dtype=np.uint64)
        v[k::GROUP] = 1
        clk.append(air.constant(f"CLK{k}", v))
    rng = air.constant("RANGE", np.arange(n, dtype=np.uint64))
    byte = air.constant("BYTE", np.arange(n, dtype=np.uint64) & 255)

    # limb/selector columns constant within a group
    limb_cols = (*x1, *y1, *x2, *y2, *y3, *x3, *s, *q0, *q1, *q2)
    for col in (*limb_cols, sel0, seladd, seldbl, selmul2, seladd2,
                selsub2):
        air.require_zero((1 - clk[GROUP - 1]) * (ex.Cm(col.id, True) - col))
    for f in (sel0, seladd, seldbl, selmul2, seladd2, selsub2):
        air.require_zero(f * (1 - f))
    selsum = sel0 + seladd + seldbl + selmul2 + seladd2 + selsub2
    air.require_zero(selsum * (selsum - 1))
    selec = seladd + seldbl                      # secp256k1 point ops
    selbn = selmul2 + seladd2 + selsub2          # BN254 Fp2 ops
    selmod = selec + selbn                       # ops with reduced x3/y3

    # -- 16-bit limb range proof, round-robin over the group rows ---------
    # lane j, row k checks limb column j·32+k: limb = RLO + 256·HI with
    # both byte chunks in the BYTE table (HI derived as (limb-RLO)/256).
    for j in range(N_RANGE_LANES):
        mux = None
        for k in range(GROUP):
            idx = j * GROUP + k
            if idx >= len(limb_cols):
                break
            t = clk[k] * limb_cols[idx]
            mux = t if mux is None else mux + t
        if mux is None:
            continue
        air.lookup([rlo[j]], [byte])
        air.lookup([(mux - rlo[j]) * _INV256], [byte])

    def chain(cols, shift_bits):
        cur, nxt = None, None
        for j, c in enumerate(cols):
            t = c * (1 << (j * n_bits)) if j else c
            tp = (ex.Cm(c.id, True) * (1 << (j * n_bits)) if j
                  else ex.Cm(c.id, True))
            cur = t if cur is None else cur + t
            nxt = tp if nxt is None else nxt + tp
        if shift_bits:
            cur = cur - (1 << shift_bits)
            nxt = nxt - (1 << shift_bits)
        return cur, nxt

    # ---- eq0: x1·y1 + x2 = y2·2^256 + y3 (gated by SELEQ0) -------------
    car, carp = chain(car0, 0)
    e = car - carp * W
    for k in range(2 * L):
        body = _conv(x1, y1, k)
        body = body if body is not None else ex.Number(0)
        if k < L:
            body = body + x2[k] - y3[k]
        else:
            body = body - y2[k - L]
        e = e + clk[k] * sel0 * body
    air.require_zero(e)
    air.require_zero(clk[0] * car)
    for c in car0:
        air.lookup([c], [rng])

    # ---- muxed modular chains -------------------------------------------
    def ec_chain(cols, bodies_by_k, sel_gate):
        """One muxed signed-carry chain: Σ clk_k·body_k + gate·carry part."""
        cur, nxt = chain(cols, EC_CARRY_BITS - 1)
        e = sel_gate * (cur - (1 - clk[GROUP - 1]) * nxt * W)
        for k, body in bodies_by_k:
            e = e + clk[k] * body
        air.require_zero(e)
        air.require_zero(clk[0] * sel_gate * cur)
        for c in cols:
            air.lookup([c], [rng])

    # slope: add: s·x2 - s·x1 + y1 - y2 - p·q0 + p·OFF = 0
    #        dbl: 2·s·y1 - 3·x1·x1 - p·q0 + p·OFF = 0
    bodies = []
    for k in range(GROUP):
        a_body = _conv(s, x2, k)
        a2 = _conv(s, x1, k)
        a_body = (a_body if a_body is not None else ex.Number(0)) \
            - (a2 if a2 is not None else 0)
        if k < L:
            a_body = a_body + y1[k] - y2[k]
        d_body = _conv(s, y1, k)
        d_body = (d_body * 2 if d_body is not None else ex.Number(0))
        d2 = _conv(x1, x1, k)
        if d2 is not None:
            d_body = d_body - d2 * 3
        pq = _conv_const(_P_LIMBS, q0, k)
        common_a = a_body + int(_D_SLOPE[k])
        common_d = d_body + int(_D_SLOPE[k])
        if k == GROUP - 1:
            common_a = common_a + int(_D_SLOPE[32]) * W
            common_d = common_d + int(_D_SLOPE[32]) * W
        if pq is not None:
            common_a = common_a - pq
            common_d = common_d - pq
        bodies.append((k, seladd * common_a + seldbl * common_d))
    ec_chain(cars, bodies, selec)

    # x-chain, by op:
    #   EC:   s·s - x1 - x2' - x3 - p·q1 + p·OFF      (x2' = x1 on dbl)
    #   MUL2: x1·x2 - y1·y2 - x3 + p·q1 - p·2^259     (ref sm_arith_eq5)
    #   ADD2: x1 + x2 - x3 - p·q1 + p·8               (ref sm_arith_eq7)
    #   SUB2: x1 - x2 - x3 + p·q1 - p·8               (ref sm_arith_eq9)
    bodies = []
    for k in range(GROUP):
        pq = _conv_const(_P_LIMBS, q1, k)
        pqb = _conv_const(_PBN_LIMBS, q1, k)
        # EC
        ec = _conv(s, s, k)
        ec = ec if ec is not None else ex.Number(0)
        if pq is not None:
            ec = ec - pq
        ec = ec + int(_D_X3[k])
        if k == GROUP - 1:
            ec = ec + int(_D_X3[32]) * W
        # BN254 Fp2 x-legs
        m2 = _conv(x1, x2, k)
        m2 = m2 if m2 is not None else ex.Number(0)
        m2y = _conv(y1, y2, k)
        if m2y is not None:
            m2 = m2 - m2y
        if pqb is not None:
            m2 = m2 + pqb
        m2 = m2 - int(_D_MUL2X[k])
        a2b = (x1[k] + x2[k]) if k < L else ex.Number(0)
        s2b = (x1[k] - x2[k]) if k < L else ex.Number(0)
        if pqb is not None:
            a2b = a2b - pqb
            s2b = s2b + pqb
        a2b = a2b + int(_D_BN8[k])
        s2b = s2b - int(_D_BN8[k])
        if k == GROUP - 1:
            m2 = m2 - int(_D_MUL2X[32]) * W
            a2b = a2b + int(_D_BN8[32]) * W
            s2b = s2b - int(_D_BN8[32]) * W
        if k < L:
            common = ec - x1[k] - x3[k]
            ecterm = (seladd * (common - x2[k])
                      + seldbl * (common - x1[k]))
            m2 = m2 - x3[k]
            a2b = a2b - x3[k]
            s2b = s2b - x3[k]
        else:
            ecterm = selec * ec
        bodies.append((k, ecterm + selmul2 * m2 + seladd2 * a2b
                       + selsub2 * s2b))
    ec_chain(carx, bodies, selec + selbn)

    # y-chain, by op:
    #   EC:   s·x1 - s·x3 - y1 - y3 - p·q2 + p·OFF
    #   MUL2: y1·x2 + x1·y2 - y3 - p·q2 + p·8         (ref sm_arith_eq6)
    #   ADD2: y1 + y2 - y3 - p·q2 + p·8               (ref sm_arith_eq8)
    #   SUB2: y1 - y2 - y3 + p·q2 - p·8               (ref sm_arith_eq10)
    bodies = []
    for k in range(GROUP):
        pq = _conv_const(_P_LIMBS, q2, k)
        pqb = _conv_const(_PBN_LIMBS, q2, k)
        ec = _conv(s, x1, k)
        ec = ec if ec is not None else ex.Number(0)
        b2 = _conv(s, x3, k)
        if b2 is not None:
            ec = ec - b2
        if pq is not None:
            ec = ec - pq
        ec = ec + int(_D_Y3[k])
        m2 = _conv(y1, x2, k)
        m2 = m2 if m2 is not None else ex.Number(0)
        m2b = _conv(x1, y2, k)
        if m2b is not None:
            m2 = m2 + m2b
        a2b = (y1[k] + y2[k]) if k < L else ex.Number(0)
        s2b = (y1[k] - y2[k]) if k < L else ex.Number(0)
        if pqb is not None:
            m2 = m2 - pqb
            a2b = a2b - pqb
            s2b = s2b + pqb
        m2 = m2 + int(_D_BN8[k])
        a2b = a2b + int(_D_BN8[k])
        s2b = s2b - int(_D_BN8[k])
        if k == GROUP - 1:
            ec = ec + int(_D_Y3[32]) * W
            m2 = m2 + int(_D_BN8[32]) * W
            a2b = a2b + int(_D_BN8[32]) * W
            s2b = s2b - int(_D_BN8[32]) * W
        if k < L:
            ec = ec - y1[k] - y3[k]
            m2 = m2 - y3[k]
            a2b = a2b - y3[k]
            s2b = s2b - y3[k]
        bodies.append((k, selec * ec + selmul2 * m2 + seladd2 * a2b
                       + selsub2 * s2b))
    ec_chain(cary, bodies, selec + selbn)

    # -- alias-free x3/y3 < prime: MSB-first chunk scan --------------------
    # rows 0..15 scan x3 (chunk_k = x3[15-k]), rows 16..31 scan y3
    # (chunk_k = y3[31-k]); LTC marks the first strictly-smaller chunk,
    # VLT accumulates it; all chunks before it must equal the prime's.
    air.require_zero(ltc * (1 - ltc))
    air.require_zero(vlt * (1 - vlt))
    air.require_zero((clk[0] + clk[16]) * vlt)
    air.require_zero((1 - clk[15] - clk[31])
                     * (ex.Cm(vlt.id, True) - vlt - ltc))
    air.require_zero((clk[15] + clk[31]) * selmod * (vlt + ltc - 1))
    eq_scan = None
    lt_scan = None
    for k in range(GROUP):
        chunk = x3[15 - k] if k < 16 else y3[31 - k]
        idx = 15 - (k % 16)
        pterm = (selec * int(_P_LIMBS[idx])
                 + selbn * int(_PBN_LIMBS[idx]))
        # equality until the strict chunk: (1-VLT-LTC)·(chunk - prime)
        t = clk[k] * ((selec + selbn) * chunk - pterm) * (1 - vlt - ltc)
        eq_scan = t if eq_scan is None else eq_scan + t
        # strictness witness: LTC·(prime - 1 - chunk) must be 16-bit
        t2 = clk[k] * ltc * (pterm - 1 - (selec + selbn) * chunk)
        lt_scan = t2 if lt_scan is None else lt_scan + t2
    air.require_zero(eq_scan)
    air.lookup([ltlo], [byte])
    air.lookup([(lt_scan - ltlo) * _INV256], [byte])

    # -- SELADD: x2 != x1 (chunk-difference inverse accumulator) -----------
    # XT materializes delta_k·XINV to keep constraint degree <= 3; the
    # gadget forces XT = 1 exactly when the row's chunk differs, and the
    # XDIF accumulator ORs the 16 chunk flags — 1 at row 16 of add groups.
    air.require_zero(clk[0] * xdif)
    xtdef = None
    xtrans = None
    for k in range(16):
        delta = x2[k] - x1[k]
        d = clk[k] * (xt - delta * xinv)
        xtdef = d if xtdef is None else xtdef + d
        air.require_zero(clk[k] * seladd * xt * (1 - xt))
        air.require_zero(clk[k] * seladd * delta * (1 - xt))
        tr = clk[k] * seladd * (ex.Cm(xdif.id, True) - xdif
                                - (1 - xdif) * xt)
        xtrans = tr if xtrans is None else xtrans + tr
    air.require_zero(xtdef)
    air.require_zero(xtrans)
    air.require_zero(clk[16] * seladd * (xdif - 1))
    return air


N_LIMB_COLS = 7 * L + 3 * QL + 6  # limb + quotient + selector columns
N_AUX_COLS = N_RANGE_LANES + 3 + 3  # range lanes + LT scan + xdiff


def n_cols(n_bits: int) -> int:
    return (N_LIMB_COLS + carry_chunks(n_bits)
            + 3 * ec_carry_chunks(n_bits) + N_AUX_COLS)


def _ec_witness(op: str, x1v, y1v, x2v, y2v):
    p = FPEC
    if op == "dbl":
        sv = (3 * x1v * x1v) * pow(2 * y1v % p, p - 2, p) % p
        e_slope = 2 * sv * y1v - 3 * x1v * x1v
        x2e = x1v
    else:
        sv = (y2v - y1v) * pow((x2v - x1v) % p, p - 2, p) % p
        e_slope = sv * x2v - sv * x1v - y2v + y1v
        x2e = x2v
    assert e_slope % p == 0
    q0v = e_slope // p + OFF_SLOPE
    x3v = (sv * sv - x1v - x2e) % p
    e_x3 = sv * sv - x1v - x2e - x3v
    assert e_x3 % p == 0
    q1v = e_x3 // p + OFF_X3
    y3v = (sv * (x1v - x3v) - y1v) % p
    e_y3 = sv * x1v - sv * x3v - y1v - y3v
    assert e_y3 % p == 0
    q2v = e_y3 // p + OFF_Y3
    for q in (q0v, q1v, q2v):
        assert 0 <= q < (1 << (16 * QL))
    return sv, x3v, y3v, q0v, q1v, q2v


def _fp2_witness(op: str, x1v, y1v, x2v, y2v):
    """(x3, y3, q1, q2) for the BN254 Fp2 ops — reference quotient
    conventions from arith_executor.cpp:247-365."""
    p = PBN
    if op == "mulfp2":
        x3v = (x1v * x2v - y1v * y2v) % p
        y3v = (y1v * x2v + x1v * y2v) % p
        e1 = x1v * x2v - y1v * y2v - x3v
        e2 = y1v * x2v + x1v * y2v - y3v
        assert e1 % p == 0 and e2 % p == 0
        q1v = -(e1 // p) + OFF_MUL2X
        q2v = e2 // p + OFF_BN8
    elif op == "addfp2":
        x3v = (x1v + x2v) % p
        y3v = (y1v + y2v) % p
        q1v = (x1v + x2v - x3v) // p + OFF_BN8
        q2v = (y1v + y2v - y3v) // p + OFF_BN8
    else:  # subfp2
        x3v = (x1v - x2v) % p
        y3v = (y1v - y2v) % p
        q1v = -((x1v - x2v - x3v) // p) + OFF_BN8
        q2v = -((y1v - y2v - y3v) // p) + OFF_BN8
    for q in (q1v, q2v):
        assert 0 <= q < (1 << (16 * QL))
    return x3v, y3v, q1v, q2v


def ec_result(op: str, x1v, y1v, x2v=None, y2v=None) -> tuple[int, int]:
    """Oracle: (x3, y3) of add/dbl on secp256k1."""
    _, x3v, y3v, *_ = _ec_witness(op, x1v, y1v,
                                  x2v if x2v is not None else x1v,
                                  y2v if y2v is not None else y1v)
    return x3v, y3v


def fp2_result(op: str, x1v, y1v, x2v, y2v) -> tuple[int, int]:
    """Oracle: (x3, y3) of the BN254 Fp2 op (mulfp2/addfp2/subfp2)."""
    x3v, y3v, _, _ = _fp2_witness(op, x1v, y1v, x2v, y2v)
    return x3v, y3v


_SEL_BY_OP = {"mul": 0, "add": 1, "dbl": 2, "mulfp2": 3, "addfp2": 4,
              "subfp2": 5}


def execute(actions: list[dict], n_bits: int) -> np.ndarray:
    """actions: [{op?: mul|add|dbl|mulfp2|addfp2|subfp2, x1, y1, x2[, y2]}]
    — 32 rows each.

    The generator simulates every live carry chain and asserts the exact
    integer balance row by row (catching any witness bug before the AIR).
    """
    n = 1 << n_bits
    tr = np.zeros((n, n_cols(n_bits)), dtype=np.uint64)
    assert len(actions) * GROUP <= n
    for a_idx, act in enumerate(actions):
        op = act.get("op", "mul")
        base = a_idx * GROUP
        x1v, y1v = act["x1"], act["y1"]
        x2v = act.get("x2", 0)
        y2v = act.get("y2", 0)
        sv = x3v = 0
        q0v = q1v = q2v = 0
        if op == "mul":
            total = x1v * y1v + x2v
            y3v, y2v = total & MASK256, total >> 256
        elif op in ("add", "dbl"):
            sv, x3v, y3v, q0v, q1v, q2v = _ec_witness(
                op, x1v, y1v, x2v, y2v)
            if op == "dbl":
                # the SM (like the reference action, main_executor.cpp:
                # 3993-3994) carries x2=x1, y2=y1 on doubling rows
                x2v, y2v = x1v, y1v
        else:
            x3v, y3v, q1v, q2v = _fp2_witness(op, x1v, y1v, x2v, y2v)
        fill_group(tr, base, n_bits, op,
                   (x1v, y1v, x2v, y2v, x3v, y3v, sv, q0v, q1v, q2v))
    return tr


def fill_group(tr: np.ndarray, base: int, n_bits: int, op: str,
               vals: tuple, check: bool = True) -> None:
    """Fill one 32-row operation group from an explicit witness
    (x1, y1, x2, y2, x3, y3, s, q0, q1, q2). With check=True (the honest
    path) every carry-chain balance and reduction claim is asserted;
    check=False writes a best-effort forged trace for negative tests."""
    GLP = 0xFFFFFFFF00000001
    n0 = carry_chunks(n_bits)
    ne = ec_carry_chunks(n_bits)
    x1v, y1v, x2v, y2v, x3v, y3v, sv, q0v, q1v, q2v = vals
    sels = [0] * 6
    sels[_SEL_BY_OP[op]] = 1

    lx1, ly1, lx2, ly2, ly3, lx3, ls = (
        _limbs(v, L) for v in (x1v, y1v, x2v, y2v, y3v, x3v, sv))
    lq0, lq1, lq2 = (_limbs(v, QL) for v in (q0v, q1v, q2v))
    limb_flat = lx1 + ly1 + lx2 + ly2 + ly3 + lx3 + ls + lq0 + lq1 + lq2

    # per-row integer bodies for each live chain
    def conv(a, b, k, la=L, lb=L):
        return sum(a[i] * b[k - i]
                   for i in range(max(0, k - lb + 1), min(la, k + 1)))

    is_mod = op != "mul"
    prime_limbs = _P_LIMBS if op in ("add", "dbl") else _PBN_LIMBS

    carries = {"eq0": 0, "s": 0, "x": 0, "y": 0}
    vltv = ltcv = 0
    xdifv = 0
    for k in range(GROUP):
        row = []
        row += limb_flat
        row += sels
        # eq0 chunks (unsigned), then the three muxed chains (shifted)
        row += [(carries["eq0"] >> (j * n_bits)) & ((1 << n_bits) - 1)
                for j in range(n0)]
        live = {"s": op in ("add", "dbl"), "x": is_mod, "y": is_mod}
        for key in ("s", "x", "y"):
            enc = carries[key] + EC_SHIFT if live[key] else 0
            row += [(enc >> (j * n_bits)) & ((1 << n_bits) - 1)
                    for j in range(ne)]
        # range lanes: lane j checks limb j*32+k
        for j in range(N_RANGE_LANES):
            idx = j * GROUP + k
            v = limb_flat[idx] if idx < len(limb_flat) else 0
            row += [v & 255]
        # alias-free scan
        if k == 0 or k == 16:
            vltv = 0
        if is_mod:
            chunk = lx3[15 - k] if k < 16 else ly3[31 - k]
            pchunk = prime_limbs[15 - (k % 16)]
            ltcv = 1 if (not vltv and chunk < pchunk) else 0
            if check and not vltv and not ltcv:
                assert chunk == pchunk, "x3/y3 not reduced"
            ltlov = (pchunk - 1 - chunk) & 255 if ltcv else 0
        else:
            ltcv = ltlov = 0
        row += [ltcv, vltv, ltlov]
        # xAreDifferent accumulator (SELADD rows 0..15)
        xinvv = xtv = 0
        if op == "add" and k < 16:
            delta = (lx2[k] - lx1[k]) % GLP
            if delta:
                xinvv = pow(delta, GLP - 2, GLP)
                xtv = 1
            row += [xdifv, xinvv, xtv]
        else:
            row += [xdifv if op == "add" else 0, 0, 0]
        tr[base + k] = row
        vltv = vltv or ltcv
        if op == "add" and k < 16 and lx2[k] != lx1[k]:
            xdifv = 1

        if op == "mul":
            body = conv(lx1, ly1, k) + (lx2[k] if k < L else 0) \
                - (ly3[k] if k < L else ly2[k - L])
            live_bodies = (("eq0", body),)
        elif op in ("add", "dbl"):
            if op == "add":
                sb = conv(ls, lx2, k) - conv(ls, lx1, k) \
                    + ((ly1[k] - ly2[k]) if k < L else 0)
                x2e = lx2
            else:
                sb = 2 * conv(ls, ly1, k) - 3 * conv(lx1, lx1, k)
                x2e = lx1
            sb += _D_SLOPE[k] - conv(_P_LIMBS, lq0, k, L, QL)
            xb = conv(ls, ls, k) + _D_X3[k] \
                - conv(_P_LIMBS, lq1, k, L, QL) \
                - ((lx1[k] + x2e[k] + lx3[k]) if k < L else 0)
            yb = conv(ls, lx1, k) - conv(ls, lx3, k) + _D_Y3[k] \
                - conv(_P_LIMBS, lq2, k, L, QL) \
                - ((ly1[k] + ly3[k]) if k < L else 0)
            if k == GROUP - 1:
                sb += _D_SLOPE[32] * W
                xb += _D_X3[32] * W
                yb += _D_Y3[32] * W
            live_bodies = (("s", sb), ("x", xb), ("y", yb))
        else:
            if op == "mulfp2":
                xb = conv(lx1, lx2, k) - conv(ly1, ly2, k) \
                    + conv(_PBN_LIMBS, lq1, k, L, QL) - _D_MUL2X[k] \
                    - (lx3[k] if k < L else 0)
                yb = conv(ly1, lx2, k) + conv(lx1, ly2, k) \
                    - conv(_PBN_LIMBS, lq2, k, L, QL) + _D_BN8[k] \
                    - (ly3[k] if k < L else 0)
                if k == GROUP - 1:
                    xb -= _D_MUL2X[32] * W
                    yb += _D_BN8[32] * W
            elif op == "addfp2":
                xb = ((lx1[k] + lx2[k] - lx3[k]) if k < L else 0) \
                    - conv(_PBN_LIMBS, lq1, k, L, QL) + _D_BN8[k]
                yb = ((ly1[k] + ly2[k] - ly3[k]) if k < L else 0) \
                    - conv(_PBN_LIMBS, lq2, k, L, QL) + _D_BN8[k]
                if k == GROUP - 1:
                    xb += _D_BN8[32] * W
                    yb += _D_BN8[32] * W
            else:
                xb = ((lx1[k] - lx2[k] - lx3[k]) if k < L else 0) \
                    + conv(_PBN_LIMBS, lq1, k, L, QL) - _D_BN8[k]
                yb = ((ly1[k] - ly2[k] - ly3[k]) if k < L else 0) \
                    + conv(_PBN_LIMBS, lq2, k, L, QL) - _D_BN8[k]
                if k == GROUP - 1:
                    xb -= _D_BN8[32] * W
                    yb -= _D_BN8[32] * W
            live_bodies = (("x", xb), ("y", yb))
        for key, body in live_bodies:
            tot = body + carries[key]
            if check:
                if k == GROUP - 1:
                    assert tot == 0, f"{key} chain residue {tot} at row 31"
                else:
                    assert tot % W == 0, f"{key} chain unbalanced at row {k}"
                carries[key] = tot // W
                assert abs(carries[key]) < EC_SHIFT, \
                    f"{key} carry overflow at row {k}"
            else:
                # forged traces propagate whatever carry keeps the early
                # rows balanced so only the targeted defect is visible
                carries[key] = tot // W if tot % W == 0 else 0


def result(action: dict) -> tuple[int, int]:
    total = action["x1"] * action["y1"] + action.get("x2", 0)
    return total >> 256, total & MASK256
