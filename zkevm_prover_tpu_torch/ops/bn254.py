"""BN254 (alt_bn128) host arithmetic: fields, towers, curves, pairing, MSM.

Copy of `zkevm_prover_tpu/ops/bn254.py` (host-only, exact Python ints); in
the port it carries the BN128 scheme's field modulus `R`. Framework
counterpart of the reference's ffiasm layer (src/ffiasm/: circom-
generated Montgomery asm for Fq/Fr, AltBn128::Engine curve ops, Pippenger
ParallelMultiexp in multiexp.c.hpp, FFT<Field> for Groth16) — re-implemented
from the curve's public parameters with exact python ints. This is the
correctness layer; the JAX package's device Montgomery-limb MSM
(ops/bn254_device.py) is not ported yet.

The verifier-side optimal ate pairing replaces the reference's dependence on
external verification (snarkjs ffv) so Groth16 proofs are checked in-stack.
"""

from __future__ import annotations

import dataclasses

# curve parameters (EIP-196/197)
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
B = 3  # y^2 = x^3 + 3
CURVE_X = 4965661367192848881  # BN parameter x (t = 6x^2+1)

G1_GEN = (1, 2)
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


# --- Fr / Fq scalar helpers ----------------------------------------------------


def fr_inv(a: int) -> int:
    return pow(a, R - 2, R)


def fq_inv(a: int) -> int:
    return pow(a, P - 2, P)


# --- Fq2 = Fq[u]/(u^2+1) --------------------------------------------------------


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def f2_muls(a, s: int):
    return (a[0] * s % P, a[1] * s % P)


def f2_sq(a):
    return f2_mul(a, a)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_conj(a):
    return (a[0], (-a[1]) % P)


def f2_inv(a):
    d = fq_inv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * d % P, (-a[1] * d) % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
# xi = 9 + u, the sextic twist constant
XI = (9, 1)


# --- Fq6 = Fq2[v]/(v^3 - xi), Fq12 = Fq6[w]/(w^2 - v) ----------------------------


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul(XI, f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), f2_mul(XI, t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_muls2(a, s):  # multiply by Fq2 scalar
    return tuple(f2_mul(x, s) for x in a)


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul_v(a):  # multiply by v: (a0,a1,a2) -> (xi*a2, a0, a1)
    return (f2_mul(XI, a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sq(a0), f2_mul(XI, f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul(XI, f2_sq(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sq(a1), f2_mul(a0, a2))
    t = f2_inv(
        f2_add(
            f2_mul(a0, c0),
            f2_mul(XI, f2_add(f2_mul(a2, c1), f2_mul(a1, c2))),
        )
    )
    return (f2_mul(c0, t), f2_mul(c1, t), f2_mul(c2, t))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_v(t1))
    c1 = f6_sub(f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), t0), t1)
    return (c0, c1)


def f12_sq(a):
    return f12_mul(a, a)


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    a0, a1 = a
    t = f6_inv(f6_sub(f6_mul(a0, a0), f6_mul_v(f6_mul(a1, a1))))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_pow(a, e: int):
    r = F12_ONE
    b = a
    while e:
        if e & 1:
            r = f12_mul(r, b)
        b = f12_sq(b)
        e >>= 1
    return r


F12_ONE = (F6_ONE, F6_ZERO)


# --- G1 (affine/Jacobian over Fq) -------------------------------------------------

INF = None  # point at infinity


def g1_add(p1, p2):
    if p1 is INF:
        return p2
    if p2 is INF:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return INF
        return g1_double(p1)
    s = (y2 - y1) * fq_inv(x2 - x1) % P
    x3 = (s * s - x1 - x2) % P
    return (x3, (s * (x1 - x3) - y1) % P)


def g1_double(pt):
    if pt is INF:
        return INF
    x, y = pt
    if y == 0:
        return INF
    s = 3 * x * x * fq_inv(2 * y) % P
    x3 = (s * s - 2 * x) % P
    return (x3, (s * (x - x3) - y) % P)


def g1_neg(pt):
    return INF if pt is INF else (pt[0], (-pt[1]) % P)


# Jacobian coordinates for the scalar-multiplication hot paths: the affine
# formulas above pay one field inversion per addition (reference ffiasm
# works in projective space for the same reason); (X, Y, Z) with
# x = X/Z², y = Y/Z³, infinity encoded as Z = 0.

_JINF = (1, 1, 0)


def _jac_from_affine(pt):
    return _JINF if pt is INF else (pt[0], pt[1], 1)


def _jac_to_affine(j):
    X, Y, Z = j
    if Z == 0:
        return INF
    zi = fq_inv(Z)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 % P * zi % P)


def _jac_double(j):
    X, Y, Z = j
    if Z == 0 or Y == 0:
        return _JINF
    A = X * X % P
    B_ = Y * Y % P
    C = B_ * B_ % P
    D = 2 * ((X + B_) * (X + B_) - A - C) % P
    E = 3 * A % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y * Z % P
    return (X3, Y3, Z3)


def _jac_add(j1, j2):
    X1, Y1, Z1 = j1
    X2, Y2, Z2 = j2
    if Z1 == 0:
        return j2
    if Z2 == 0:
        return j1
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 % P * Z2Z2 % P
    S2 = Y2 * Z1 % P * Z1Z1 % P
    if U1 == U2:
        if S1 != S2:
            return _JINF
        return _jac_double(j1)
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    rr = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * S1 * J) % P
    Z3 = 2 * H % P * Z1 % P * Z2 % P
    return (X3, Y3, Z3)


def g1_mul(pt, k: int):
    k %= R
    if pt is INF or k == 0:
        return INF
    acc = _JINF
    add = _jac_from_affine(pt)
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        add = _jac_double(add)
        k >>= 1
    return _jac_to_affine(acc)


def g1_is_on_curve(pt) -> bool:
    if pt is INF:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


# --- G2 (over Fq2, twist curve y^2 = x^3 + 3/(9+u)) -------------------------------

B2 = f2_mul((3, 0), f2_inv(XI))


def g2_add(p1, p2):
    if p1 is INF:
        return p2
    if p2 is INF:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return INF
        return g2_double(p1)
    s = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sq(s), x1), x2)
    return (x3, f2_sub(f2_mul(s, f2_sub(x1, x3)), y1))


def g2_double(pt):
    if pt is INF:
        return INF
    x, y = pt
    if y == F2_ZERO:
        return INF
    s = f2_mul(f2_muls(f2_sq(x), 3), f2_inv(f2_muls(y, 2)))
    x3 = f2_sub(f2_sq(s), f2_muls(x, 2))
    return (x3, f2_sub(f2_mul(s, f2_sub(x, x3)), y))


def g2_neg(pt):
    return INF if pt is INF else (pt[0], f2_neg(pt[1]))


def g2_mul(pt, k: int):
    k %= R
    acc = INF
    add = pt
    while k:
        if k & 1:
            acc = g2_add(acc, add)
        add = g2_double(add)
        k >>= 1
    return acc


def g2_is_on_curve(pt) -> bool:
    if pt is INF:
        return True
    x, y = pt
    return f2_sub(f2_sq(y), f2_add(f2_mul(f2_sq(x), x), B2)) == F2_ZERO


def g1_validate(pt) -> bool:
    """Untrusted-input check: well-formed affine tuple, coords in Fq,
    on-curve (G1 has cofactor 1, so on-curve implies in-subgroup)."""
    if pt is INF:
        return True
    if not (isinstance(pt, (tuple, list)) and len(pt) == 2):
        return False
    x, y = pt
    if not (isinstance(x, int) and isinstance(y, int)):
        return False
    if not (0 <= x < P and 0 <= y < P):
        return False
    return g1_is_on_curve((x, y))


def g2_validate(pt) -> bool:
    """Untrusted-input check for G2: shape + Fq2 ranges + on-curve +
    r-torsion (the twist has a large cofactor, so subgroup must be checked
    explicitly: [r]P == O)."""
    if pt is INF:
        return True
    if not (isinstance(pt, (tuple, list)) and len(pt) == 2):
        return False
    try:
        (x0, x1), (y0, y1) = pt
    except (TypeError, ValueError):
        return False
    for c in (x0, x1, y0, y1):
        if not (isinstance(c, int) and 0 <= c < P):
            return False
    pt = ((x0, x1), (y0, y1))
    if not g2_is_on_curve(pt):
        return False
    return g2_mul(pt, R) is INF


# --- Pippenger MSM ------------------------------------------------------------------
# Reference: ParallelMultiexp (src/ffiasm/multiexp.c.hpp:37-115): bucket method
# with per-chunk accumulators and a final bucket collapse. Window size follows
# the same log(n)-driven heuristic.


# fixed-base windowed multiplication for the generators (SRS generation is
# tens of thousands of muls by G1/G2 — the reference precomputes in its
# zkey; here an 8-bit window table turns each mul into <=32 curve adds)

_FB_WINDOW = 8


class _FixedBaseG1:
    def __init__(self, pt):
        self.tables = []
        base = _jac_from_affine(pt)
        for _ in range(256 // _FB_WINDOW):
            row = [_JINF]
            cur = _JINF
            for _d in range((1 << _FB_WINDOW) - 1):
                cur = _jac_add(cur, base)
                row.append(cur)
            self.tables.append(row)
            for _i in range(_FB_WINDOW):
                base = _jac_double(base)

    def mul(self, k: int):
        k %= R
        acc = _JINF
        for w, row in enumerate(self.tables):
            d = (k >> (w * _FB_WINDOW)) & ((1 << _FB_WINDOW) - 1)
            if d:
                acc = _jac_add(acc, row[d])
        return _jac_to_affine(acc)


_fb_g1 = None


def g1_mul_gen(k: int):
    """k·G1 via the cached fixed-base table."""
    global _fb_g1
    if _fb_g1 is None:
        _fb_g1 = _FixedBaseG1(G1_GEN)
    return _fb_g1.mul(k)


# G2 Jacobian (over Fq2) — same formulas componentwise

_J2INF = ((1, 0), (1, 0), (0, 0))


def _jac2_from_affine(pt):
    return _J2INF if pt is INF else (pt[0], pt[1], (1, 0))


def _jac2_to_affine(j):
    X, Y, Z = j
    if Z == (0, 0):
        return INF
    zi = f2_inv(Z)
    zi2 = f2_mul(zi, zi)
    return (f2_mul(X, zi2), f2_mul(f2_mul(Y, zi2), zi))


def _jac2_double(j):
    X, Y, Z = j
    if Z == (0, 0) or Y == (0, 0):
        return _J2INF
    A = f2_mul(X, X)
    B_ = f2_mul(Y, Y)
    C = f2_mul(B_, B_)
    t = f2_add(X, B_)
    D = f2_muls(f2_sub(f2_sub(f2_mul(t, t), A), C), 2)
    E = f2_muls(A, 3)
    F = f2_mul(E, E)
    X3 = f2_sub(F, f2_muls(D, 2))
    Y3 = f2_sub(f2_mul(E, f2_sub(D, X3)), f2_muls(C, 8))
    Z3 = f2_muls(f2_mul(Y, Z), 2)
    return (X3, Y3, Z3)


def _jac2_add(j1, j2):
    X1, Y1, Z1 = j1
    X2, Y2, Z2 = j2
    if Z1 == (0, 0):
        return j2
    if Z2 == (0, 0):
        return j1
    Z1Z1 = f2_mul(Z1, Z1)
    Z2Z2 = f2_mul(Z2, Z2)
    U1 = f2_mul(X1, Z2Z2)
    U2 = f2_mul(X2, Z1Z1)
    S1 = f2_mul(f2_mul(Y1, Z2), Z2Z2)
    S2 = f2_mul(f2_mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 != S2:
            return _J2INF
        return _jac2_double(j1)
    H = f2_sub(U2, U1)
    I = f2_muls(f2_mul(H, H), 4)
    J = f2_mul(H, I)
    rr = f2_muls(f2_sub(S2, S1), 2)
    V = f2_mul(U1, I)
    X3 = f2_sub(f2_sub(f2_mul(rr, rr), J), f2_muls(V, 2))
    Y3 = f2_sub(f2_mul(rr, f2_sub(V, X3)), f2_muls(f2_mul(S1, J), 2))
    Z3 = f2_muls(f2_mul(f2_mul(H, Z1), Z2), 2)
    return (X3, Y3, Z3)


class _FixedBaseG2:
    def __init__(self, pt):
        self.tables = []
        base = _jac2_from_affine(pt)
        for _ in range(256 // _FB_WINDOW):
            row = [_J2INF]
            cur = _J2INF
            for _d in range((1 << _FB_WINDOW) - 1):
                cur = _jac2_add(cur, base)
                row.append(cur)
            self.tables.append(row)
            for _i in range(_FB_WINDOW):
                base = _jac2_double(base)

    def mul(self, k: int):
        k %= R
        acc = _J2INF
        for w, row in enumerate(self.tables):
            d = (k >> (w * _FB_WINDOW)) & ((1 << _FB_WINDOW) - 1)
            if d:
                acc = _jac2_add(acc, row[d])
        return _jac2_to_affine(acc)


_fb_g2 = None


def g2_mul_gen(k: int):
    """k·G2 via the cached fixed-base table."""
    global _fb_g2
    if _fb_g2 is None:
        _fb_g2 = _FixedBaseG2(G2_GEN)
    return _fb_g2.mul(k)


def g1_msm(points, scalars) -> tuple | None:
    """Pippenger over Jacobian accumulators (one inversion total)."""
    assert len(points) == len(scalars)
    n = len(points)
    if n == 0:
        return INF
    c = max(1, int.bit_length(n) - 1)  # window bits
    n_bits = 256
    windows = (n_bits + c - 1) // c
    jpts = [_jac_from_affine(p) for p in points]
    result = _JINF
    for w in range(windows - 1, -1, -1):
        if result[2] != 0:
            for _ in range(c):
                result = _jac_double(result)
        buckets = [_JINF] * (1 << c)
        for jp, s in zip(jpts, scalars):
            idx = (s >> (w * c)) & ((1 << c) - 1)
            if idx:
                buckets[idx] = _jac_add(buckets[idx], jp)
        running, acc = _JINF, _JINF
        for b in range(len(buckets) - 1, 0, -1):
            running = _jac_add(running, buckets[b])
            acc = _jac_add(acc, running)
        result = _jac_add(result, acc)
    return _jac_to_affine(result)


def g2_msm(points, scalars):
    acc = INF
    for pt, s in zip(points, scalars):
        if s % R:
            acc = g2_add(acc, g2_mul(pt, s))
    return acc


# --- FFT over Fr ---------------------------------------------------------------------
# Reference: FFT<Field> (src/ffiasm/fft.hpp) used by Groth16 for the quotient.

# 2-adicity of r-1 is 28; generator 5 is a quadratic nonresidue giving the tower
FR_TWO_ADICITY = 28
_FR_GEN = 5
FR_ROOT = pow(_FR_GEN, (R - 1) >> FR_TWO_ADICITY, R)  # order 2^28


def fr_w(n_bits: int) -> int:
    assert n_bits <= FR_TWO_ADICITY
    return pow(FR_ROOT, 1 << (FR_TWO_ADICITY - n_bits), R)


def fr_fft(xs: list[int], inverse: bool = False) -> list[int]:
    n = len(xs)
    n_bits = n.bit_length() - 1
    assert 1 << n_bits == n
    w = fr_w(n_bits)
    if inverse:
        w = pow(w, R - 2, R)
    out = list(xs)
    # iterative bit-reversed Cooley-Tukey
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            out[i], out[j] = out[j], out[i]
    m = 2
    while m <= n:
        wm = pow(w, n // m, R)
        for k in range(0, n, m):
            wj = 1
            for l in range(m // 2):
                t = wj * out[k + l + m // 2] % R
                u = out[k + l]
                out[k + l] = (u + t) % R
                out[k + l + m // 2] = (u - t) % R
                wj = wj * wm % R
        m <<= 1
    if inverse:
        n_inv = pow(n, R - 2, R)
        out = [v * n_inv % R for v in out]
    return out


# --- optimal ate pairing ----------------------------------------------------------
# Strategy: untwist G2 points into E(Fq12) (w^6 = xi in our tower, so the
# untwist is (x, y) -> (x·w^2, y·w^3) = (x·v, y·v·w)) and run the Miller loop
# with generic Fq12 line functions. This is the slow-but-transparent oracle —
# the role snarkjs verification plays for the reference (runtime/README.md).

ATE_LOOP_COUNT = 6 * CURVE_X + 2


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


F12_ZERO = (F6_ZERO, F6_ZERO)


def _f12_embed_fq(a: int):
    return (((a % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def _untwist(q):
    """G2 (affine over Fq2) -> affine point on E(Fq12)."""
    x, y = q
    return (
        ((F2_ZERO, x, F2_ZERO), F6_ZERO),        # x·v
        (F6_ZERO, (F2_ZERO, y, F2_ZERO)),        # y·v·w
    )


def _e12_add(p1, p2):
    if p1 is INF:
        return p2
    if p2 is INF:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f12_add(y1, y2) == F12_ZERO:
            return INF
        return _e12_double(p1)
    s = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sub(f12_sq(s), x1), x2)
    return (x3, f12_sub(f12_mul(s, f12_sub(x1, x3)), y1))


def _e12_double(pt):
    x, y = pt
    s = f12_mul(
        f12_mul(_f12_embed_fq(3), f12_sq(x)),
        f12_inv(f12_mul(_f12_embed_fq(2), y)),
    )
    x3 = f12_sub(f12_sq(s), f12_mul(_f12_embed_fq(2), x))
    return (x3, f12_sub(f12_mul(s, f12_sub(x, x3)), y))


def _e12_neg(pt):
    return INF if pt is INF else (pt[0], f12_sub(F12_ZERO, pt[1]))


def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 (E(Fq12)) at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
        return f12_sub(f12_mul(m, f12_sub(xt, x1)), f12_sub(yt, y1))
    if y1 == y2:
        m = f12_mul(
            f12_mul(_f12_embed_fq(3), f12_sq(x1)),
            f12_inv(f12_mul(_f12_embed_fq(2), y1)),
        )
        return f12_sub(f12_mul(m, f12_sub(xt, x1)), f12_sub(yt, y1))
    return f12_sub(xt, x1)  # vertical line


def _f12_frobenius(a, power: int = 1):
    """a^(p^power) via plain exponentiation (host oracle; not hot)."""
    return f12_pow(a, P**power)


def miller_loop(q, pt):
    """Optimal ate Miller loop; q in G2 (Fq2 affine), pt in G1 (Fq affine)."""
    if q is INF or pt is INF:
        return F12_ONE
    qq = _untwist(q)
    tt = (_f12_embed_fq(pt[0]), _f12_embed_fq(pt[1]))
    f = F12_ONE
    r_pt = qq
    for bch in bin(ATE_LOOP_COUNT)[3:]:
        f = f12_mul(f12_sq(f), _linefunc(r_pt, r_pt, tt))
        r_pt = _e12_double(r_pt)
        if bch == "1":
            f = f12_mul(f, _linefunc(r_pt, qq, tt))
            r_pt = _e12_add(r_pt, qq)
    # frobenius correction terms of the optimal ate pairing
    q1 = (_f12_frobenius(qq[0]), _f12_frobenius(qq[1]))
    nq2 = _e12_neg((_f12_frobenius(q1[0]), _f12_frobenius(q1[1])))
    f = f12_mul(f, _linefunc(r_pt, q1, tt))
    r_pt = _e12_add(r_pt, q1)
    f = f12_mul(f, _linefunc(r_pt, nq2, tt))
    return f


def final_exponentiation(f):
    """f^((p^12-1)/r) — plain big-int exponent (correctness model)."""
    e = (P**12 - 1) // R
    return f12_pow(f, e)


def pairing(pt, q):
    """e(P, Q) for P in G1, Q in G2."""
    return final_exponentiation(miller_loop(q, pt))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 (the Groth16 verification equation shape)."""
    f = F12_ONE
    for pt, q in pairs:
        f = f12_mul(f, miller_loop(q, pt))
    return final_exponentiation(f) == F12_ONE
