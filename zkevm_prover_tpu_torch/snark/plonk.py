"""PLONK over BN254 with KZG commitments — the Fflonk-role final SNARK.

Reference: src/rapidsnark + the Fflonk prover (pilfflonk) — the alternative
final-proof system to Groth16, built on polynomial commitments instead of
a circuit-specific trusted setup. This module implements standard PLONK
(Gabizon–Williamson–Ciobotaru, the system Fflonk optimizes): selector
gates qM·ab + qL·a + qR·b + qO·c + qC + PI = 0, the permutation grand
product for copy constraints, a coset-FFT quotient, and batched KZG
openings at ζ and ζω verified with one pairing equation. Fflonk's
single-combined-commitment trick (C(X) = Σ p_i(X^t)·X^i) is a pending
optimization — the proving-system role and interface are the same.

The SRS comes from a local deterministic "ceremony" like groth16_setup
(powers of τ in G1, τ in G2). Proofs are NOT zero-knowledge (no blinding
scalars) — the prover's witness here is derived from public data anyway;
blinding is a two-line addition when needed.

Port of `zkevm_prover_tpu/snark/plonk.py` on the setup's `device` (CUDA
unless told otherwise): the SRS's powers of τ are fixed-base products
(`bn254_device.fixed_base`), every commitment an MSM through `ops/msm.py`
and every FFT an Fr NTT (`bn254_device.fr_fft`, `fr_ntt` with its coset
shift): the kernels of csrc/bn254.cu on a CUDA device, their plain twins on
the CPU. The transcript, the evaluations and the verifier's pairing stay
on the host. Setups and proofs equal the JAX package's, byte for byte.
"""

from __future__ import annotations

import dataclasses

from .. import resolve_device
from ..ops import bn254, bn254_device, keccak
from ..ops import msm as msm_mod

R = bn254.R
K1, K2 = 2, 3  # coset tags for the b/c wire position encodings


# ---------------------------------------------------------------------------
# circuit
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlonkCircuit:
    n_public: int
    qm: list
    ql: list
    qr: list
    qo: list
    qc: list
    a_var: list   # variable index feeding each gate's a/b/c slot
    b_var: list
    c_var: list
    n_vars: int

    @property
    def n_gates(self) -> int:
        return len(self.qm)


class Builder:
    """Gate-level circuit builder; copy constraints come from shared
    variable indices (the σ permutation is derived at setup)."""

    def __init__(self, n_public: int):
        self.n_public = n_public
        self.qm, self.ql, self.qr, self.qo, self.qc = [], [], [], [], []
        self.av, self.bv, self.cv = [], [], []
        self.n_vars = 1  # var 0 is the constant-zero variable
        # public-input rows: a = pub_i, gate: 1·a + PI = 0
        for _ in range(n_public):
            v = self.alloc()
            self._gate(qm=0, ql=1, qr=0, qo=0, qc=0, a=v, b=0, c=0)

    def alloc(self) -> int:
        v = self.n_vars
        self.n_vars += 1
        return v

    def _gate(self, qm, ql, qr, qo, qc, a, b, c):
        self.qm.append(qm % R)
        self.ql.append(ql % R)
        self.qr.append(qr % R)
        self.qo.append(qo % R)
        self.qc.append(qc % R)
        self.av.append(a)
        self.bv.append(b)
        self.cv.append(c)

    def mul(self, x: int, y: int) -> int:
        o = self.alloc()
        self._gate(1, 0, 0, R - 1, 0, x, y, o)   # x·y - o = 0
        return o

    def add(self, x: int, y: int) -> int:
        o = self.alloc()
        self._gate(0, 1, 1, R - 1, 0, x, y, o)   # x + y - o = 0
        return o

    def constant(self, x: int, value: int) -> None:
        """Pin variable x to a constant: x - value = 0."""
        self._gate(0, 1, 0, 0, (-value) % R, x, 0, 0)

    def assert_equal(self, x: int, y: int) -> None:
        self._gate(0, 1, R - 1, 0, 0, x, y, 0)   # x - y = 0

    def build(self) -> PlonkCircuit:
        return PlonkCircuit(self.n_public, self.qm, self.ql, self.qr,
                            self.qo, self.qc, self.av, self.bv, self.cv,
                            self.n_vars)


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------


def _poly_from_evals(evals: list[int], n_bits: int, device) -> list[int]:
    return bn254_device.fr_fft(list(evals), inverse=True, device=device)


def _eval_poly(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def _commit(srs_g1, coeffs: list[int], device):
    """sum c_i [tau^i]_1 (zero terms add nothing)."""
    n = min(len(srs_g1), len(coeffs))
    if not any(coeffs[:n]):
        return None  # point at infinity
    return msm_mod.g1_msm(srs_g1[:n], coeffs[:n], device)


@dataclasses.dataclass
class PlonkSetup:
    circuit: PlonkCircuit
    n_bits: int
    n: int
    srs_g1: list
    x_g2: tuple
    q_polys: dict        # name -> coeffs
    sigma_polys: list    # 3 coeff lists
    q_comms: dict
    sigma_comms: list
    device: object = None   # where the SRS lives and the prover runs


def _rand_fr(seed: bytes, label: bytes) -> int:
    return int.from_bytes(keccak.keccak256(seed + label), "big") % R


def _srs(tau: int, first: int, count: int, device) -> msm_mod.PointList:
    """[tau^i]_1 for first <= i < first + count (fixed-base products)."""
    pows, acc = [], pow(tau, first, R)
    for _ in range(count):
        pows.append(acc)
        acc = acc * tau % R
    return msm_mod.PointList(bn254_device.fixed_base(
        bn254_device.pack_fr(pows, device, reduced=True), g2=False), g2=False)


def plonk_setup(circuit: PlonkCircuit,
                seed: bytes = b"zkevm_prover_tpu/plonk",
                device=None) -> PlonkSetup:
    n = 1
    n_bits = 0
    while n < max(circuit.n_gates, 2):
        n <<= 1
        n_bits += 1
    dev = resolve_device(device)
    tau = _rand_fr(seed, b"tau")
    srs_g1 = _srs(tau, 0, 3 * n + 8, dev)
    x_g2 = bn254_device.unpack_g2(bn254_device.fixed_base(
        bn254_device.pack_fr([tau], dev), g2=True))[0]

    def pad(vals):
        return [v % R for v in vals] + [0] * (n - len(vals))

    q_polys = {nm: _poly_from_evals(pad(vals), n_bits, dev)
               for nm, vals in (("qm", circuit.qm), ("ql", circuit.ql),
                                ("qr", circuit.qr), ("qo", circuit.qo),
                                ("qc", circuit.qc))}

    # σ encodings: position tags X, k1·X, k2·X over H; same-variable
    # positions form cycles
    w = bn254.fr_w(n_bits)
    dom = [1] * n
    for i in range(1, n):
        dom[i] = dom[i - 1] * w % R
    tags = [[d % R for d in dom], [K1 * d % R for d in dom],
            [K2 * d % R for d in dom]]
    # positions per variable
    byvar: dict[int, list] = {}
    cols = (circuit.a_var, circuit.b_var, circuit.c_var)
    for col in range(3):
        for row in range(n):
            var = cols[col][row] if row < circuit.n_gates else 0
            byvar.setdefault(var, []).append((col, row))
    sigma_evals = [list(tags[0]), list(tags[1]), list(tags[2])]
    for positions in byvar.values():
        for i, (col, row) in enumerate(positions):
            ncol, nrow = positions[(i + 1) % len(positions)]
            sigma_evals[col][row] = tags[ncol][nrow]
    sigma_polys = [_poly_from_evals(ev, n_bits, dev) for ev in sigma_evals]

    return PlonkSetup(
        circuit=circuit, n_bits=n_bits, n=n, srs_g1=srs_g1, x_g2=x_g2,
        q_polys=q_polys, sigma_polys=sigma_polys,
        q_comms={nm: _commit(srs_g1, cf, dev) for nm, cf in q_polys.items()},
        sigma_comms=[_commit(srs_g1, cf, dev) for cf in sigma_polys],
        device=dev,
    )


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


def _transcript_challenge(parts: list, label: bytes) -> int:
    data = label
    for p in parts:
        if p is None:
            data += b"\x00" * 64
        elif isinstance(p, tuple):
            data += int(p[0]).to_bytes(32, "big") + \
                int(p[1]).to_bytes(32, "big")
        else:
            data += int(p).to_bytes(32, "big")
    return int.from_bytes(keccak.keccak256(data), "big") % R


def _transcript_init(setup: "PlonkSetup", publics: list[int]) -> int:
    """Bind the verification key and the public inputs into the transcript
    before any challenge is derived (the PLONK paper's schedule; omitting
    either is the "Frozen Heart" forgery pattern)."""
    parts: list = [setup.n, K1, K2]
    for name in sorted(setup.q_comms):
        parts.append(setup.q_comms[name])
    parts.extend(setup.sigma_comms)
    parts.extend(int(p) % R for p in publics)
    return _transcript_challenge(parts, b"init")


def _coset_fft(coeffs: list[int], n_bits_ext: int, shift: int,
               device) -> list[int]:
    """Evaluations on shift·<w> (the NTT's prologue multiplies c_i by
    shift^i)."""
    n_ext = 1 << n_bits_ext
    cs = list(coeffs) + [0] * (n_ext - len(coeffs))
    t = bn254_device.pack_fr(cs, device)
    return bn254_device.limbs_to_ints(bn254_device.fr_ntt(t, shift=shift))


def _coset_ifft(evals: list[int], shift: int, device) -> list[int]:
    """Coefficients from evaluations on shift·<w> (the epilogue multiplies
    c_i by shift^-i)."""
    t = bn254_device.pack_fr(list(evals), device)
    return bn254_device.limbs_to_ints(bn254_device.fr_ntt(
        t, inverse=True, post=pow(shift, R - 2, R)))


SHIFT = 7  # coset generator for quotient evaluation


def plonk_prove(setup: PlonkSetup, assignment: list[int]) -> dict:
    """assignment: value per variable (index 0 must be 0)."""
    c = setup.circuit
    n, n_bits = setup.n, setup.n_bits
    assert assignment[0] == 0

    def wire_evals(col_vars):
        return [assignment[col_vars[i]] % R if i < c.n_gates else 0
                for i in range(n)]

    a_ev, b_ev, c_ev = (wire_evals(v)
                        for v in (c.a_var, c.b_var, c.c_var))
    a_p = _poly_from_evals(a_ev, n_bits, setup.device)
    b_p = _poly_from_evals(b_ev, n_bits, setup.device)
    c_p = _poly_from_evals(c_ev, n_bits, setup.device)
    com_a = _commit(setup.srs_g1, a_p, setup.device)
    com_b = _commit(setup.srs_g1, b_p, setup.device)
    com_c = _commit(setup.srs_g1, c_p, setup.device)

    pubs = [assignment[i + 1] % R for i in range(c.n_public)]
    ts0 = _transcript_init(setup, pubs)
    beta = _transcript_challenge([ts0, com_a, com_b, com_c], b"beta")
    gamma = _transcript_challenge([ts0, com_a, com_b, com_c], b"gamma")

    # permutation grand product
    w = bn254.fr_w(n_bits)
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
    com_z = _commit(setup.srs_g1, z_p, setup.device)

    alpha = _transcript_challenge([com_z, beta, gamma], b"alpha")

    # public-input polynomial: PI = -Σ pub_i·L_i
    pi_ev = [(-pubs[i]) % R if i < c.n_public else 0 for i in range(n)]
    pi_p = _poly_from_evals(pi_ev, n_bits, setup.device)

    # quotient on a 4n coset
    eb = n_bits + 2
    ne = 1 << eb

    def ext(p):
        return _coset_fft(p, eb, SHIFT, setup.device)

    A, B, C = ext(a_p), ext(b_p), ext(c_p)
    QM, QL, QR = ext(setup.q_polys["qm"]), ext(setup.q_polys["ql"]), \
        ext(setup.q_polys["qr"])
    QO, QC = ext(setup.q_polys["qo"]), ext(setup.q_polys["qc"])
    PI = ext(pi_p)
    Z = ext(z_p)
    Zw = ext([zc * pow(w, i, R) % R
              for i, zc in enumerate(z_p)])  # z(ωX)
    S1, S2, S3 = (ext(sp) for sp in setup.sigma_polys)
    # L1 on the coset
    l1_ev = [0] * n
    l1_ev[0] = 1
    L1 = ext(_poly_from_evals(l1_ev, n_bits, setup.device))
    # x values on the coset
    we = bn254.fr_w(eb)
    xs = [1] * ne
    for i in range(1, ne):
        xs[i] = xs[i - 1] * we % R
    xs = [SHIFT * x % R for x in xs]
    # 1/Z_H on the coset
    zh_inv = [pow((pow(x, n, R) - 1) % R, R - 2, R) for x in xs]

    T = []
    for i in range(ne):
        gate = (QM[i] * A[i] % R * B[i] + QL[i] * A[i] + QR[i] * B[i]
                + QO[i] * C[i] + QC[i] + PI[i]) % R
        perm = (Z[i]
                * (A[i] + beta * xs[i] + gamma) % R
                * (B[i] + beta * K1 * xs[i] + gamma) % R
                * (C[i] + beta * K2 * xs[i] + gamma)
                - Zw[i]
                * (A[i] + beta * S1[i] + gamma) % R
                * (B[i] + beta * S2[i] + gamma) % R
                * (C[i] + beta * S3[i] + gamma)) % R
        start = (Z[i] - 1) * L1[i] % R
        T.append((gate + alpha * perm + alpha * alpha * start)
                 % R * zh_inv[i] % R)
    t_coeffs = _coset_ifft(T, SHIFT, setup.device)
    while t_coeffs and t_coeffs[-1] == 0:
        t_coeffs.pop()
    t_lo, t_mid, t_hi = (t_coeffs[:n], t_coeffs[n:2 * n], t_coeffs[2 * n:])
    com_tlo = _commit(setup.srs_g1, t_lo, setup.device)
    com_tmid = _commit(setup.srs_g1, t_mid, setup.device)
    com_thi = _commit(setup.srs_g1, t_hi, setup.device)

    zeta = _transcript_challenge([com_tlo, com_tmid, com_thi, alpha],
                                 b"zeta")

    ev_a = _eval_poly(a_p, zeta)
    ev_b = _eval_poly(b_p, zeta)
    ev_c = _eval_poly(c_p, zeta)
    ev_s1 = _eval_poly(setup.sigma_polys[0], zeta)
    ev_s2 = _eval_poly(setup.sigma_polys[1], zeta)
    ev_zw = _eval_poly(z_p, zeta * w % R)

    # linearization polynomial r(X)
    zh_z = (pow(zeta, n, R) - 1) % R
    l1_z = zh_z * pow(n * (zeta - 1) % R, R - 2, R) % R
    r = [0] * (3 * n + 8)

    def addp(coeffs, scalar):
        for i, cf in enumerate(coeffs):
            r[i] = (r[i] + cf * scalar) % R

    addp(setup.q_polys["qm"], ev_a * ev_b % R)
    addp(setup.q_polys["ql"], ev_a)
    addp(setup.q_polys["qr"], ev_b)
    addp(setup.q_polys["qo"], ev_c)
    addp(setup.q_polys["qc"], 1)
    addp(pi_p, 1)
    perm1 = ((ev_a + beta * zeta + gamma)
             * (ev_b + beta * K1 * zeta + gamma) % R
             * (ev_c + beta * K2 * zeta + gamma)) % R
    addp(z_p, alpha * perm1 % R)
    perm2 = ((ev_a + beta * ev_s1 + gamma)
             * (ev_b + beta * ev_s2 + gamma)) % R * alpha % R * ev_zw % R
    # -perm2·(c(X)... the σ3 side: -α·z̄ω·(ā+βσ̄1+γ)(b̄+βσ̄2+γ)·(c(X)+βσ3(X)+γ)
    addp(setup.sigma_polys[2], (-perm2) % R * beta % R)
    addp(c_p, (-perm2) % R)
    r[0] = (r[0] - perm2 * gamma) % R
    addp(z_p, alpha * alpha % R * l1_z % R)
    r[0] = (r[0] - alpha * alpha * l1_z) % R
    zn = pow(zeta, n, R)
    addp(t_lo, (-zh_z) % R)
    addp(t_mid, (-zh_z) * zn % R)
    addp(t_hi, (-zh_z) * zn % R * zn % R)
    # r(ζ) must be 0 by construction
    assert _eval_poly(r, zeta) == 0, "linearization sanity failed"

    v = _transcript_challenge([ev_a, ev_b, ev_c, ev_s1, ev_s2, ev_zw,
                               zeta], b"v")

    # batched opening at ζ: r + v·a + v²·b + v³·c + v⁴·σ1 + v⁵·σ2
    batch = list(r)
    vals = [(a_p, ev_a), (b_p, ev_b), (c_p, ev_c),
            (setup.sigma_polys[0], ev_s1), (setup.sigma_polys[1], ev_s2)]
    vp = 1
    for poly, ev in vals:
        vp = vp * v % R
        for i, cf in enumerate(poly):
            batch[i] = (batch[i] + vp * cf) % R
        batch[0] = (batch[0] - vp * ev) % R
    wz = _kzg_quotient(batch, zeta)
    com_wz = _commit(setup.srs_g1, wz, setup.device)
    # opening of z at ζω
    zshift = list(z_p)
    zshift[0] = (zshift[0] - ev_zw) % R
    wzw = _kzg_quotient(zshift, zeta * w % R)
    com_wzw = _commit(setup.srs_g1, wzw, setup.device)

    return {
        "a": com_a, "b": com_b, "c": com_c, "z": com_z,
        "tlo": com_tlo, "tmid": com_tmid, "thi": com_thi,
        "wz": com_wz, "wzw": com_wzw,
        "ev_a": ev_a, "ev_b": ev_b, "ev_c": ev_c,
        "ev_s1": ev_s1, "ev_s2": ev_s2, "ev_zw": ev_zw,
    }


def _kzg_quotient(coeffs: list[int], point: int) -> list[int]:
    """p(X) / (X - point) via synthetic division; p must vanish at point."""
    d = len(coeffs) - 1
    q = [0] * d
    q[d - 1] = coeffs[d] % R
    for i in range(d - 1, 0, -1):
        q[i - 1] = (coeffs[i] + point * q[i]) % R
    assert (coeffs[0] + point * q[0]) % R == 0, "non-zero remainder"
    return q


def plonk_verify(setup: PlonkSetup, publics: list[int],
                 proof: dict) -> bool:
    # untrusted proof: validate every point / eval before any arithmetic
    try:
        for k in ("a", "b", "c", "z", "tlo", "tmid", "thi", "wz", "wzw"):
            if not bn254.g1_validate(proof[k]):
                return False
        for k in ("ev_a", "ev_b", "ev_c", "ev_s1", "ev_s2", "ev_zw"):
            if not isinstance(proof[k], int):
                return False
    except KeyError:
        return False
    c = setup.circuit
    n = setup.n
    w = bn254.fr_w(setup.n_bits)

    ts0 = _transcript_init(setup, publics)
    beta = _transcript_challenge([ts0, proof["a"], proof["b"], proof["c"]],
                                 b"beta")
    gamma = _transcript_challenge([ts0, proof["a"], proof["b"], proof["c"]],
                                  b"gamma")
    alpha = _transcript_challenge([proof["z"], beta, gamma], b"alpha")
    zeta = _transcript_challenge([proof["tlo"], proof["tmid"],
                                  proof["thi"], alpha], b"zeta")
    v = _transcript_challenge([proof["ev_a"], proof["ev_b"], proof["ev_c"],
                               proof["ev_s1"], proof["ev_s2"],
                               proof["ev_zw"], zeta], b"v")
    u = _transcript_challenge([proof["wz"], proof["wzw"]], b"u")

    zh_z = (pow(zeta, n, R) - 1) % R
    l1_z = zh_z * pow(n * (zeta - 1) % R, R - 2, R) % R

    ev_a, ev_b, ev_c = proof["ev_a"], proof["ev_b"], proof["ev_c"]
    ev_s1, ev_s2, ev_zw = proof["ev_s1"], proof["ev_s2"], proof["ev_zw"]

    # [D]: the linearization commitment (mirrors the prover's r pieces that
    # live in commitments; the constant/PI parts fold into E)
    def acc_pt(p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        return bn254.g1_add(p1, p2)

    def mul_pt(p, k):
        if p is None or k % R == 0:
            return None
        return bn254.g1_mul(p, k % R)

    perm1 = ((ev_a + beta * zeta + gamma)
             * (ev_b + beta * K1 * zeta + gamma) % R
             * (ev_c + beta * K2 * zeta + gamma)) % R
    perm2 = ((ev_a + beta * ev_s1 + gamma)
             * (ev_b + beta * ev_s2 + gamma)) % R * alpha % R * ev_zw % R

    # [r]: every polynomial in the prover's linearization is either
    # committed or publicly recomputable (PI from the publics; the setup
    # object carries the SRS, so the verifier commits PI itself)
    pubs_padded = [publics[i] % R for i in range(c.n_public)]
    pi_ev = [(-pubs_padded[i]) % R if i < c.n_public else 0
             for i in range(n)]
    com_pi = _commit(setup.srs_g1,
                     _poly_from_evals(pi_ev, setup.n_bits, setup.device),
                     setup.device)

    D = None
    D = acc_pt(D, mul_pt(setup.q_comms["qm"], ev_a * ev_b % R))
    D = acc_pt(D, mul_pt(setup.q_comms["ql"], ev_a))
    D = acc_pt(D, mul_pt(setup.q_comms["qr"], ev_b))
    D = acc_pt(D, mul_pt(setup.q_comms["qo"], ev_c))
    D = acc_pt(D, mul_pt(setup.q_comms["qc"], 1))
    D = acc_pt(D, mul_pt(com_pi, 1))
    D = acc_pt(D, mul_pt(proof["z"], (alpha * perm1
                                      + alpha * alpha * l1_z) % R))
    D = acc_pt(D, mul_pt(setup.sigma_comms[2], (-perm2) * beta % R))
    D = acc_pt(D, mul_pt(proof["c"], (-perm2) % R))
    # the scalar pieces the prover folded into r's constant coefficient
    D = acc_pt(D, mul_pt(bn254.G1_GEN,
                         (-perm2 * gamma - alpha * alpha * l1_z) % R))
    zn = pow(zeta, n, R)
    D = acc_pt(D, mul_pt(proof["tlo"], (-zh_z) % R))
    D = acc_pt(D, mul_pt(proof["tmid"], (-zh_z) * zn % R))
    D = acc_pt(D, mul_pt(proof["thi"], (-zh_z) * zn % R * zn % R))

    # F = [r] + Σ v^k [p_k] + u[z];  E = (Σ v^k ev_k + u·ev_zw)·G1
    F = D
    e_scalar = 0
    vp = 1
    for com, ev in ((proof["a"], ev_a), (proof["b"], ev_b),
                    (proof["c"], ev_c), (setup.sigma_comms[0], ev_s1),
                    (setup.sigma_comms[1], ev_s2)):
        vp = vp * v % R
        F = acc_pt(F, mul_pt(com, vp))
        e_scalar = (e_scalar + vp * ev) % R
    F = acc_pt(F, mul_pt(proof["z"], u))
    e_scalar = (e_scalar + u * ev_zw) % R
    E = mul_pt(bn254.G1_GEN, e_scalar)

    lhs_pt = acc_pt(proof["wz"], mul_pt(proof["wzw"], u))
    rhs_pt = acc_pt(
        acc_pt(mul_pt(proof["wz"], zeta),
               mul_pt(proof["wzw"], u * (zeta * w % R) % R)),
        acc_pt(F, mul_pt(E, R - 1)))
    # e(W_ζ + u·W_ζω, [τ]₂) == e(ζ·W_ζ + uζω·W_ζω + F - E, [1]₂)
    return bn254.pairing_check([
        (lhs_pt, setup.x_g2),
        (mul_pt(rhs_pt, R - 1), bn254.G2_GEN),
    ])
