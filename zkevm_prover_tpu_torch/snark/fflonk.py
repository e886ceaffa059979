"""Fflonk over BN254 — the reference's default final SNARK.

Reference: src/rapidsnark/fflonk_prover.c.hpp (the snarkjs fflonk protocol;
round schedule at :532-550, C1 composition :796-814, C2 :860-870, the
xiSeed root tower :1188-1214, R0/R1/R2 openings :1273-1279, the W = F
commitment :1374-1400, L/ZTS2/W' :1417-1530) and the default
`final.fflonk.zkey` artifact selection (src/config/config.cpp:268).

Fflonk's trick over vanilla PLONK/KZG (snark/plonk.py): instead of one
KZG commitment per polynomial, each round commits ONE polynomial that
packs t polynomials by exponent interleaving

    C(X) = p_0(X^t) + X·p_1(X^t) + ... + X^{t-1}·p_{t-1}(X^t),

so C(h·w_t^j) = sum_k (h·w_t^j)^k · p_k(xi) for every t-th root h·w_t^j of
the evaluation point xi.  One opening of C at the t roots therefore opens
all t packed polynomials at xi.  The proof is 4 G1 points (C1, C2, W1, W2)
plus 15 field evaluations — smaller and cheaper to verify than PLONK's
9 points, with NO circuit-specific trusted setup (the SRS is universal).

Packing layout (identical to the reference zkey sections):
  C0 (preprocessed, committed at setup; t=8):
      ql, qr, qo, qm, qc, sigma1, sigma2, sigma3
  C1 (round 1; t=4):   a, b, c, T0            T0 = gate-constraint / Z_H
  C2 (round 2; t=3):   z, T1, T2              T1 = (z-1)·L1 / Z_H
                                              T2 = permutation / Z_H
Root tower (fflonk_prover.c.hpp:1188-1214): from the transcript seed s,
  h0 = s^3 (8th roots of xi), h1 = s^6 (4th roots), h2 = s^8 (3rd roots),
  xi = s^24, and h3 = h2 · w_n^(1/3) gives the 3rd roots of xi·w_n for the
  shifted openings z(xi·w), T1(xi·w), T2(xi·w).

The opening argument is shplonk: R_i = the low-degree interpolation of C_i
on its root set; W1 commits F = sum_i alpha^i (C_i - R_i)/Z_{S_i}; after a
fresh challenge y, W2 commits L/(ZTS2(y)·(X-y)) with
  L = preL0·(C0-R0(y)) + preL1·(C1-R1(y)) + preL2·(C2-R2(y)) - ZT(y)·F,
  preL0 = Z_{S1}(y)·Z_{S2}(y), preL1 = alpha·Z_{S0}(y)·Z_{S2}(y),
  preL2 = alpha^2·Z_{S0}(y)·Z_{S1}(y)   (computeL, :1460-1520).
Verification is ONE pairing equation on [L] reassembled from the proof.

Like plonk.py the SRS is a local deterministic ceremony and proofs carry
no blinding (the witness is derived from public proof data); the Keccak
transcript absorbs the verification key (via [C0]), the publics, and every
commitment/evaluation in the reference's round order.

Port of `zkevm_prover_tpu/snark/fflonk.py` on the setup's `device`, as
snark/plonk.py: the SRS from fixed-base products, the commitments through
`ops/msm.py`, the FFTs on the Fr NTT (the kernels of csrc/bn254.cu on a
CUDA device, their plain twins on the CPU). Setups and proofs equal the
JAX package's, byte for byte.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import bn254, bn254_device
from ..ops import msm as msm_mod
from . import plonk
from .plonk import (K1, K2, SHIFT, Builder, PlonkCircuit,  # noqa: F401
                    _coset_fft, _coset_ifft, _commit, _eval_poly,
                    _poly_from_evals, _rand_fr, _srs, _transcript_challenge)

R = bn254.R

# nontrivial cube root of unity in Fr (3 | r-1); 5 is a non-residue enough
# to have full 3-part order: w3^3 = 1, w3 != 1.
W3 = pow(5, (R - 1) // 3, R)
assert W3 != 1 and pow(W3, 3, R) == 1
W4 = bn254.fr_w(2)
W8 = bn254.fr_w(3)


def _w_cbrt(n_bits: int) -> int:
    """A cube root of the 2^n_bits domain generator w_n.  Cubing is a
    bijection on the order-2^k subgroup (gcd(3, 2^k) = 1), so
    w_n^(3^-1 mod n) is the in-subgroup root."""
    n = 1 << n_bits
    w = bn254.fr_w(n_bits)
    return pow(w, pow(3, -1, n), R)


# ---------------------------------------------------------------------------
# polynomial helpers
# ---------------------------------------------------------------------------


def _compose(polys: list[list[int]], n_each: int) -> list[int]:
    """C(X) = sum_k X^k p_k(X^t): exponent-interleave t coefficient lists."""
    t = len(polys)
    out = [0] * (t * max(n_each, max(len(p) for p in polys)))
    for k, p in enumerate(polys):
        for i, c in enumerate(p):
            out[t * i + k] = c % R
    return _trim(out)


def _div_by_zerofier(coeffs: list[int], k: int, v: int) -> list[int]:
    """Exact division by (X^k - v); asserts zero remainder
    (Polynomial::divByZerofier, the reference's opening-quotient op)."""
    d = len(coeffs) - 1
    if d < k:
        assert all(c % R == 0 for c in coeffs), "zerofier division: remainder"
        return [0]
    q = [0] * (d - k + 1)
    for i in range(d - k, -1, -1):
        hi = q[i + k] if i + k <= d - k else 0
        q[i] = (coeffs[i + k] + v * hi) % R
    for m in range(k):
        hi = q[m] if m <= d - k else 0
        assert (coeffs[m] + v * hi) % R == 0, "zerofier division: remainder"
    return q


def _lagrange_eval(points: list[tuple[int, int]], x: int) -> int:
    """Evaluate at x the unique degree-(k-1) polynomial through k points."""
    acc = 0
    for i, (xi, yi) in enumerate(points):
        num, den = 1, 1
        for j, (xj, _) in enumerate(points):
            if i == j:
                continue
            num = num * ((x - xj) % R) % R
            den = den * ((xi - xj) % R) % R
        acc = (acc + yi * num % R * pow(den, R - 2, R)) % R
    return acc


def _lagrange_coeffs(points: list[tuple[int, int]]) -> list[int]:
    """Coefficients of the interpolating polynomial (k is tiny: <= 6)."""
    k = len(points)
    out = [0] * k
    for i, (xi, yi) in enumerate(points):
        num = [1]
        den = 1
        for j, (xj, _) in enumerate(points):
            if i == j:
                continue
            num = _polymul(num, [(-xj) % R, 1])
            den = den * ((xi - xj) % R) % R
        s = yi * pow(den, R - 2, R) % R
        for d, c in enumerate(num):
            out[d] = (out[d] + s * c) % R
    return out


def _polymul(a: list[int], b: list[int]) -> list[int]:
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % R
    return out


def _polysub_scalar(p: list[int], s: int) -> list[int]:
    q = list(p)
    if not q:
        q = [0]
    q[0] = (q[0] - s) % R
    return q


def _polyaxpy(acc: list[int], p: list[int], s: int) -> list[int]:
    if len(p) > len(acc):
        acc = acc + [0] * (len(p) - len(acc))
    for i, c in enumerate(p):
        acc[i] = (acc[i] + s * c) % R
    return acc


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

C0_ORDER = ("ql", "qr", "qo", "qm", "qc")  # then sigma1..3


@dataclasses.dataclass
class FflonkSetup:
    circuit: PlonkCircuit
    n_bits: int
    n: int
    srs_g1: list
    x_g2: tuple
    q_polys: dict
    sigma_polys: list
    c0_poly: list
    com_c0: tuple
    device: object = None   # where the SRS lives and the prover runs


def fflonk_setup(circuit: PlonkCircuit,
                 seed: bytes = b"zkevm_prover_tpu/fflonk",
                 device=None) -> FflonkSetup:
    # reuse plonk's q/sigma preprocessing; extend the SRS to deg 9n
    # (C2 packs 3 polys of degree up to 3n -> deg(C2) <= 9n-10; the W2
    # quotient is asserted < 9n-1, fflonk_prover.c.hpp:1446)
    base = plonk.plonk_setup(circuit, seed=seed, device=device)
    dev = base.device
    n, n_bits = base.n, base.n_bits
    tau = _rand_fr(seed, b"tau")
    first = len(base.srs_g1)
    more = _srs(tau, first, 9 * n + 16 - first, dev)
    srs_g1 = msm_mod.PointList(torch.cat([base.srs_g1.tensor, more.tensor]),
                               g2=False)
    c0 = _compose([base.q_polys[k] for k in C0_ORDER] + base.sigma_polys, n)
    return FflonkSetup(
        circuit=circuit, n_bits=n_bits, n=n, srs_g1=srs_g1, x_g2=base.x_g2,
        q_polys=base.q_polys, sigma_polys=base.sigma_polys,
        c0_poly=c0, com_c0=_commit(srs_g1, c0, dev), device=dev)


# ---------------------------------------------------------------------------
# shared transcript / root-tower / opening math (prover & verifier)
# ---------------------------------------------------------------------------


def _roots(setup: FflonkSetup, xi_seed: int):
    """The fflonk root tower (fflonk_prover.c.hpp:1188-1214)."""
    s2 = xi_seed * xi_seed % R
    s3 = s2 * xi_seed % R
    h0 = s3                      # h0^8 = xi
    h1 = s3 * s3 % R             # h1^4 = xi
    h2 = h1 * s2 % R             # h2^3 = xi
    xi = h2 * h2 % R * h2 % R    # xi = seed^24
    h3 = h2 * _w_cbrt(setup.n_bits) % R   # h3^3 = xi * w_n
    S0 = [h0]
    for _ in range(7):
        S0.append(S0[-1] * W8 % R)
    S1 = [h1]
    for _ in range(3):
        S1.append(S1[-1] * W4 % R)
    S2 = [h2, h2 * W3 % R, h2 * W3 % R * W3 % R]
    S2w = [h3, h3 * W3 % R, h3 * W3 % R * W3 % R]
    return xi, S0, S1, S2, S2w


def _opening_scalars(alpha: int, y: int, S0, S1, S2, S2w):
    mul0 = 1
    for r in S0:
        mul0 = mul0 * ((y - r) % R) % R
    mul1 = 1
    for r in S1:
        mul1 = mul1 * ((y - r) % R) % R
    mul2 = 1
    for r in S2 + S2w:
        mul2 = mul2 * ((y - r) % R) % R
    pre0 = mul1 * mul2 % R
    pre1 = alpha * mul0 % R * mul2 % R
    pre2 = alpha * alpha % R * mul0 % R * mul1 % R
    zt_y = mul0 * mul1 % R * mul2 % R
    zts2_y = mul1 * mul2 % R
    return pre0, pre1, pre2, zt_y, zts2_y


def _r_polys(ev: dict, t0_xi: int, t1_xi: int, t2_xi: int,
             S2, S2w) -> tuple[list[int], list[int], list[int]]:
    """R_i = the interpolation of C_i on its root set.  For S0/S1 (all
    roots are t-th roots of the SAME xi) the interpolation IS the power
    form sum_k ev_k X^k; only R2 mixes xi and xi*w and needs Lagrange."""
    r0 = [ev[k] for k in C0_ORDER] + [ev["s1"], ev["s2"], ev["s3"]]
    r1 = [ev["a"], ev["b"], ev["c"], t0_xi]
    pts = [(r, (ev["z"] + r * t1_xi + r * r % R * t2_xi) % R) for r in S2]
    pts += [(r, (ev["zw"] + r * ev["t1w"] + r * r % R * ev["t2w"]) % R)
            for r in S2w]
    r2 = _lagrange_coeffs(pts)
    return r0, r1, r2


def _gate_t0_xi(setup: FflonkSetup, publics: list[int], ev: dict,
                xi: int) -> tuple[int, int, int, int]:
    """Recompute T0(xi), T1(xi), T2(xi) from the constraint equations
    (what makes the packed quotients sound), plus Z_H(xi)."""
    n = setup.n
    w = bn254.fr_w(setup.n_bits)
    zh = (pow(xi, n, R) - 1) % R
    zh_inv = pow(zh, R - 2, R)
    # L_i(xi) = w^i (xi^n - 1) / (n (xi - w^i)); PI(xi) = -sum pub_i L_i
    pi = 0
    wi = 1
    l1 = zh * pow(n * ((xi - 1) % R) % R, R - 2, R) % R
    for i in range(setup.circuit.n_public):
        li = wi * zh % R * pow(n * ((xi - wi) % R) % R, R - 2, R) % R
        pi = (pi - publics[i] * li) % R
        wi = wi * w % R
    t0 = ((ev["qm"] * ev["a"] % R * ev["b"] + ev["ql"] * ev["a"]
           + ev["qr"] * ev["b"] + ev["qo"] * ev["c"] + ev["qc"] + pi)
          % R * zh_inv % R)
    t1 = (ev["z"] - 1) % R * l1 % R * zh_inv % R
    num = ((ev["a"] + ev["qbeta"] * xi + ev["qgamma"])
           * (ev["b"] + ev["qbeta"] * K1 % R * xi + ev["qgamma"]) % R
           * (ev["c"] + ev["qbeta"] * K2 % R * xi + ev["qgamma"]) % R
           * ev["z"]) % R
    den = ((ev["a"] + ev["qbeta"] * ev["s1"] + ev["qgamma"])
           * (ev["b"] + ev["qbeta"] * ev["s2"] + ev["qgamma"]) % R
           * (ev["c"] + ev["qbeta"] * ev["s3"] + ev["qgamma"]) % R
           * ev["zw"]) % R
    t2 = (num - den) % R * zh_inv % R
    return t0, t1, t2, zh


EV_ORDER = ("ql", "qr", "qo", "qm", "qc", "s1", "s2", "s3",
            "a", "b", "c", "z", "zw", "t1w", "t2w")


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


def fflonk_prove(setup: FflonkSetup, assignment: list[int]) -> dict:
    c = setup.circuit
    n, n_bits = setup.n, setup.n_bits
    assert assignment[0] == 0
    w = bn254.fr_w(n_bits)

    def wire_evals(col_vars):
        return [assignment[col_vars[i]] % R if i < c.n_gates else 0
                for i in range(n)]

    a_ev, b_ev, c_ev = (wire_evals(v) for v in (c.a_var, c.b_var, c.c_var))
    a_p = _poly_from_evals(a_ev, n_bits, setup.device)
    b_p = _poly_from_evals(b_ev, n_bits, setup.device)
    c_p = _poly_from_evals(c_ev, n_bits, setup.device)
    pubs = [assignment[i + 1] % R for i in range(c.n_public)]
    pi_ev = [(-pubs[i]) % R if i < c.n_public else 0 for i in range(n)]
    pi_p = _poly_from_evals(pi_ev, n_bits, setup.device)

    # ROUND 1: T0 = gate / Z_H on a 4n coset; C1 = [a,b,c,T0] packed
    eb = n_bits + 2
    ne = 1 << eb

    def ext(p):
        return _coset_fft(p, eb, SHIFT, setup.device)

    A, B, C = ext(a_p), ext(b_p), ext(c_p)
    QM, QL, QR = (ext(setup.q_polys[k]) for k in ("qm", "ql", "qr"))
    QO, QC, PI = ext(setup.q_polys["qo"]), ext(setup.q_polys["qc"]), ext(pi_p)
    we = bn254.fr_w(eb)
    xs = [1] * ne
    for i in range(1, ne):
        xs[i] = xs[i - 1] * we % R
    xs = [SHIFT * x % R for x in xs]
    zh_inv = [pow((pow(x, n, R) - 1) % R, R - 2, R) for x in xs]
    T0ev = [(QM[i] * A[i] % R * B[i] + QL[i] * A[i] + QR[i] * B[i]
             + QO[i] * C[i] + QC[i] + PI[i]) % R * zh_inv[i] % R
            for i in range(ne)]
    t0_p = _trim(_coset_ifft(T0ev, SHIFT, setup.device))
    c1_p = _compose([a_p, b_p, c_p, t0_p], n)
    com_c1 = _commit(setup.srs_g1, c1_p, setup.device)

    # ROUND 2: beta/gamma, grand product Z, T1, T2; C2 = [z, T1, T2]
    beta = _transcript_challenge([setup.com_c0] + pubs + [com_c1], b"beta")
    gamma = _transcript_challenge([beta], b"gamma")
    dom = [1] * n
    for i in range(1, n):
        dom[i] = dom[i - 1] * w % R
    sig_ev = [bn254_device.fr_fft(sp, device=setup.device)
              for sp in setup.sigma_polys]
    z_ev = [1] * n
    for i in range(n - 1):
        num = ((a_ev[i] + beta * dom[i] + gamma)
               * (b_ev[i] + beta * K1 * dom[i] + gamma) % R
               * (c_ev[i] + beta * K2 * dom[i] + gamma)) % R
        den = ((a_ev[i] + beta * sig_ev[0][i] + gamma)
               * (b_ev[i] + beta * sig_ev[1][i] + gamma) % R
               * (c_ev[i] + beta * sig_ev[2][i] + gamma)) % R
        z_ev[i + 1] = z_ev[i] * num % R * pow(den, R - 2, R) % R
    z_p = _poly_from_evals(z_ev, n_bits, setup.device)
    l1_ev = [0] * n
    l1_ev[0] = 1
    L1 = ext(_poly_from_evals(l1_ev, n_bits, setup.device))
    Z = ext(z_p)
    Zw = ext([zc * pow(w, i, R) % R for i, zc in enumerate(z_p)])
    S1e, S2e, S3e = (ext(sp) for sp in setup.sigma_polys)
    T1ev = [(Z[i] - 1) % R * L1[i] % R * zh_inv[i] % R for i in range(ne)]
    T2ev = [(Z[i]
             * (A[i] + beta * xs[i] + gamma) % R
             * (B[i] + beta * K1 * xs[i] + gamma) % R
             * (C[i] + beta * K2 * xs[i] + gamma)
             - Zw[i]
             * (A[i] + beta * S1e[i] + gamma) % R
             * (B[i] + beta * S2e[i] + gamma) % R
             * (C[i] + beta * S3e[i] + gamma)) % R * zh_inv[i] % R
            for i in range(ne)]
    t1_p = _trim(_coset_ifft(T1ev, SHIFT, setup.device))
    t2_p = _trim(_coset_ifft(T2ev, SHIFT, setup.device))
    c2_p = _compose([z_p, t1_p, t2_p], n)
    com_c2 = _commit(setup.srs_g1, c2_p, setup.device)

    # ROUND 3: xi via the root tower; all 15 evaluations
    xi_seed = _transcript_challenge([gamma, com_c2], b"xiSeed")
    xi, S0, S1r, S2, S2w = _roots(setup, xi_seed)
    xiw = xi * w % R
    ev = {"ql": _eval_poly(setup.q_polys["ql"], xi),
          "qr": _eval_poly(setup.q_polys["qr"], xi),
          "qo": _eval_poly(setup.q_polys["qo"], xi),
          "qm": _eval_poly(setup.q_polys["qm"], xi),
          "qc": _eval_poly(setup.q_polys["qc"], xi),
          "s1": _eval_poly(setup.sigma_polys[0], xi),
          "s2": _eval_poly(setup.sigma_polys[1], xi),
          "s3": _eval_poly(setup.sigma_polys[2], xi),
          "a": _eval_poly(a_p, xi), "b": _eval_poly(b_p, xi),
          "c": _eval_poly(c_p, xi), "z": _eval_poly(z_p, xi),
          "zw": _eval_poly(z_p, xiw), "t1w": _eval_poly(t1_p, xiw),
          "t2w": _eval_poly(t2_p, xiw)}

    # ROUND 4: alpha; F = sum alpha^i (C_i - R_i)/Z_{S_i}; W1 = [F]
    alpha = _transcript_challenge([xi_seed] + [ev[k] for k in EV_ORDER],
                                  b"alpha")
    t0_xi = _eval_poly(t0_p, xi)
    t1_xi = _eval_poly(t1_p, xi)
    t2_xi = _eval_poly(t2_p, xi)
    r0_p, r1_p, r2_p = _r_polys(ev, t0_xi, t1_xi, t2_xi, S2, S2w)
    f0 = _div_by_zerofier(_polyaxpy(list(setup.c0_poly), r0_p, R - 1), 8, xi)
    f1 = _div_by_zerofier(_polyaxpy(list(c1_p), r1_p, R - 1), 4, xi)
    f2 = _div_by_zerofier(
        _div_by_zerofier(_polyaxpy(list(c2_p), r2_p, R - 1), 3, xi), 3, xiw)
    F = _polyaxpy(_polyaxpy(list(f0), f1, alpha), f2, alpha * alpha % R)
    com_w1 = _commit(setup.srs_g1, F, setup.device)

    # ROUND 5: y; L; W2 = L / (ZTS2(y) (X - y))
    y = _transcript_challenge([alpha, com_w1], b"y")
    pre0, pre1, pre2, zt_y, zts2_y = _opening_scalars(alpha, y, S0, S1r,
                                                      S2, S2w)
    r0y, r1y, r2y = (_eval_poly(p, y) for p in (r0_p, r1_p, r2_p))
    L = _polyaxpy([0], _polysub_scalar(setup.c0_poly, r0y), pre0)
    L = _polyaxpy(L, _polysub_scalar(c1_p, r1y), pre1)
    L = _polyaxpy(L, _polysub_scalar(c2_p, r2y), pre2)
    L = _polyaxpy(L, F, (-zt_y) % R)
    L = [cf * pow(zts2_y, R - 2, R) % R for cf in L]
    w2_p = _div_by_zerofier(L, 1, y)
    com_w2 = _commit(setup.srs_g1, w2_p, setup.device)

    return {"c1": com_c1, "c2": com_c2, "w1": com_w1, "w2": com_w2,
            **{f"ev_{k}": ev[k] for k in EV_ORDER}}


def _trim(coeffs: list[int]) -> list[int]:
    coeffs = list(coeffs)
    while len(coeffs) > 1 and coeffs[-1] == 0:
        coeffs.pop()
    return coeffs


# ---------------------------------------------------------------------------
# verifier
# ---------------------------------------------------------------------------


def _acc(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    return bn254.g1_add(p1, p2)


def _mul(p, k):
    if p is None or k % R == 0:
        return None
    return bn254.g1_mul(p, k % R)


def fflonk_verify(setup: FflonkSetup, publics: list[int],
                  proof: dict) -> bool:
    # untrusted proof: reject malformed / off-curve points and non-integer
    # evals with a clean False rather than undefined arithmetic
    try:
        for k in ("c1", "c2", "w1", "w2"):
            if not bn254.g1_validate(proof[k]):
                return False
        pubs = [int(p) % R for p in publics]
        ev = {k: int(proof[f"ev_{k}"]) % R for k in EV_ORDER}
    except (KeyError, TypeError, ValueError):
        return False

    beta = _transcript_challenge([setup.com_c0] + pubs + [proof["c1"]],
                                 b"beta")
    gamma = _transcript_challenge([beta], b"gamma")
    xi_seed = _transcript_challenge([gamma, proof["c2"]], b"xiSeed")
    xi, S0, S1r, S2, S2w = _roots(setup, xi_seed)
    alpha = _transcript_challenge([xi_seed] + [ev[k] for k in EV_ORDER],
                                  b"alpha")
    y = _transcript_challenge([alpha, proof["w1"]], b"y")

    ev2 = dict(ev)
    ev2["qbeta"], ev2["qgamma"] = beta, gamma
    t0_xi, t1_xi, t2_xi, zh = _gate_t0_xi(setup, pubs, ev2, xi)
    if zh == 0:
        return False
    r0_p, r1_p, r2_p = _r_polys(ev, t0_xi, t1_xi, t2_xi, S2, S2w)
    pre0, pre1, pre2, zt_y, zts2_y = _opening_scalars(alpha, y, S0, S1r,
                                                      S2, S2w)
    if zts2_y % R == 0:
        return False
    r0y, r1y, r2y = (_eval_poly(p, y) for p in (r0_p, r1_p, r2_p))

    # [L] = pre0 [C0] + pre1 [C1] + pre2 [C2] - (sum pre_i R_i(y)) G1
    #       - ZT(y) [W1];   check  e(ZTS2(y)[W2], [tau]_2)
    #                            = e([L] + y ZTS2(y) [W2], [1]_2)
    com_l = _acc(_mul(setup.com_c0, pre0), _mul(proof["c1"], pre1))
    com_l = _acc(com_l, _mul(proof["c2"], pre2))
    scal = (pre0 * r0y + pre1 * r1y + pre2 * r2y) % R
    com_l = _acc(com_l, _mul(bn254.G1_GEN, (-scal) % R))
    com_l = _acc(com_l, _mul(proof["w1"], (-zt_y) % R))

    lhs = _mul(proof["w2"], zts2_y)
    rhs = _acc(com_l, _mul(proof["w2"], y * zts2_y % R))
    if lhs is None or rhs is None:
        return lhs is None and rhs is None
    return bn254.pairing_check([
        (lhs, setup.x_g2),
        (_mul(rhs, R - 1), bn254.G2_GEN),
    ])
