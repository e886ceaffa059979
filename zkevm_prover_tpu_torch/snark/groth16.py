"""Groth16 prover/verifier over BN254.

Port of `zkevm_prover_tpu/snark/groth16.py`, on `device` (CUDA unless told
otherwise). Re-implementation of the reference's rapidsnark Groth16 path
(src/rapidsnark/groth16.c.hpp:49-150: a/b/c linear-combination assembly,
quotient h via 6 coset FFTs, then 5 Pippenger MSMs for pi_a/pi_b1/pi_b2/pi_c/h)
from the Groth16 paper, with an in-process trusted setup replacing the .zkey
artifact (absent from the reference snapshot; the 75 GB archive ships it).

What runs where: the CRS's fixed-base products (every query vector, in one
G1 and one G2 batch) on `bn254_device.fixed_base`, the quotient's FFTs and
its pointwise step on `bn254_device.fr_ntt` / `fr_pointwise`, the five MSMs
through `ops/msm.py` (the kernels of csrc/bn254.cu on a CUDA device, their
plain twins on the CPU). The QAP evaluations at tau, the witness's linear
combinations and the verifier's pairing stay on the host. The query vectors
stay on the device as `msm.PointList`s, which compare equal to the JAX
package's lists of point tuples; the CRS, the quotient and the proofs are
the JAX package's, bit for bit.

Proof is ((A: G1), (B: G2), (C: G1)); verification is the standard pairing
equation e(A,B) = e(alpha,beta)·e(L_pub,gamma)·e(C,delta).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import time

import torch

from .. import resolve_device
from ..ops import bn254 as bn
from ..ops import bn254_device as bd
from ..ops import msm as msm_mod
from ..ops.bn254 import R
from .r1cs import R1CS

# the coset of the quotient's evaluation (the multiplicative generator)
COSET = 5


def _rand_fr(seed: bytes, label: bytes) -> int:
    return int.from_bytes(hashlib.shake_256(seed + label).digest(40), "little") % R


@dataclasses.dataclass
class Groth16Setup:
    r1cs: R1CS
    domain_bits: int
    # proving key
    alpha1: tuple
    beta1: tuple
    beta2: tuple
    delta1: tuple
    delta2: tuple
    a_query: list     # [x_i]_1 per signal: A_i(tau)
    b1_query: list    # B_i(tau) in G1
    b2_query: list    # B_i(tau) in G2
    l_query: list     # ((beta A_i + alpha B_i + C_i)/delta) for aux signals
    h_query: list     # (tau^i Z(tau)/delta) in G1
    # verification key
    gamma2: tuple
    ic: list          # ((beta A_i + alpha B_i + C_i)/gamma) for public signals
    device: object = None   # where the queries live and the prover runs


@contextlib.contextmanager
def _clock(times: dict | None, label: str, device):
    """Add the seconds of the block to times[label] (the device's queue
    drained at both ends, so that a card phase is its own); nothing when
    `times` is None."""
    if times is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times[label] = times.get(label, 0.0) + time.perf_counter() - t0


def _batch_inv(xs: list[int]) -> list[int]:
    """1/x mod r for each x (0 -> 0), one exponentiation (Montgomery's
    trick)."""
    pre, acc = [], 1
    for x in xs:
        pre.append(acc)
        if x:
            acc = acc * x % R
    inv = pow(acc, R - 2, R)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        if xs[i]:
            out[i] = inv * pre[i] % R
            inv = inv * xs[i] % R
    return out


def _qap_evals(r1cs: R1CS, tau: int, n_bits: int):
    """A_i(tau), B_i(tau), C_i(tau) per signal via Lagrange basis at tau
    (the constraints' basis polynomials, their inversions batched)."""
    n = 1 << n_bits
    m = len(r1cs.constraints)
    assert m <= n
    w = bn.fr_w(n_bits)
    # Lagrange L_j(tau) = (tau^n - 1)/n * w^j / (tau - w^j)
    zt = (pow(tau, n, R) - 1) % R
    n_inv = pow(n, R - 2, R)
    ws, wj = [], 1
    for _ in range(m):
        ws.append(wj)
        wj = wj * w % R
    inv = _batch_inv([(tau - x) % R for x in ws])
    zn = zt * n_inv % R
    lag = [zn * x % R * i % R for x, i in zip(ws, inv)]
    a_t = [0] * r1cs.n_signals
    b_t = [0] * r1cs.n_signals
    c_t = [0] * r1cs.n_signals
    for j, (a, b, c) in enumerate(r1cs.constraints):
        lj = lag[j]
        for i, v in a.items():
            a_t[i] = (a_t[i] + v * lj) % R
        for i, v in b.items():
            b_t[i] = (b_t[i] + v * lj) % R
        for i, v in c.items():
            c_t[i] = (c_t[i] + v * lj) % R
    return a_t, b_t, c_t, zt


def groth16_setup(r1cs: R1CS, seed: bytes = b"zkevm_prover_tpu/groth16",
                  device=None, times: dict | None = None) -> Groth16Setup:
    """Deterministic toy CRS (NOT a ceremony — the reference's zkey plays this
    role in production; the toxic waste here is derived from `seed`). The
    query vectors are fixed-base products on `device`, one G1 and one G2
    batch. `times` (optional) gets the seconds of each step: qap_evals,
    crs_scalars, pack, unpack (host), crs (card)."""
    dev = resolve_device(device)
    n_bits = max(1, (len(r1cs.constraints) - 1).bit_length())
    tau = _rand_fr(seed, b"tau")
    alpha = _rand_fr(seed, b"alpha")
    beta = _rand_fr(seed, b"beta")
    gamma = _rand_fr(seed, b"gamma")
    delta = _rand_fr(seed, b"delta")
    with _clock(times, "qap_evals", dev):
        a_t, b_t, c_t, zt = _qap_evals(r1cs, tau, n_bits)

    gamma_inv = pow(gamma, R - 2, R)
    delta_inv = pow(delta, R - 2, R)
    n_ic = r1cs.n_public + 1
    with _clock(times, "crs_scalars", dev):
        ks = [(beta * a + alpha * b + c) % R
              for a, b, c in zip(a_t, b_t, c_t)]
        ic_sc = [k * gamma_inv % R for k in ks[:n_ic]]
        l_sc = [k * delta_inv % R for k in ks[n_ic:]]
        n = 1 << n_bits
        tzd = zt * delta_inv % R
        h_sc, acc_t = [], 1
        for _ in range(n - 1):
            h_sc.append(acc_t * tzd % R)
            acc_t = acc_t * tau % R

    parts1 = ([alpha, beta, delta], a_t, b_t, l_sc, h_sc, ic_sc)
    with _clock(times, "pack", dev):
        s1 = bd.pack_fr([v for part in parts1 for v in part], dev,
                        reduced=True)
        s2 = bd.pack_fr([beta, delta, gamma] + b_t, dev, reduced=True)
    with _clock(times, "crs", dev):
        g1 = bd.fixed_base(s1, g2=False)
        g2 = bd.fixed_base(s2, g2=True)
    del s1, s2
    q1, at = [], 0
    for part in parts1:
        q1.append(msm_mod.PointList(g1[at:at + len(part)], g2=False))
        at += len(part)
    heads1, a_q, b1_q, l_q, h_q, ic = q1
    with _clock(times, "unpack", dev):
        alpha1, beta1, delta1 = heads1.tolist()
        beta2, delta2, gamma2 = bd.unpack_g2(g2[:3])
    return Groth16Setup(
        r1cs=r1cs,
        domain_bits=n_bits,
        alpha1=alpha1,
        beta1=beta1,
        beta2=beta2,
        delta1=delta1,
        delta2=delta2,
        a_query=a_q,
        b1_query=b1_q,
        b2_query=msm_mod.PointList(g2[3:], g2=True),
        l_query=l_q,
        h_query=h_q,
        gamma2=gamma2,
        ic=ic,
        device=dev,
    )


def _lc_evals(r1cs: R1CS, w: list[int]):
    """(A·w, B·w, C·w) per constraint."""
    a_e, b_e, c_e = [], [], []
    for a, b, c in r1cs.constraints:
        a_e.append(sum(v * w[i] for i, v in a.items()) % R)
        b_e.append(sum(v * w[i] for i, v in b.items()) % R)
        c_e.append(sum(v * w[i] for i, v in c.items()) % R)
    return a_e, b_e, c_e


def _quotient(a_e, b_e, c_e, n_bits: int, device, times=None):
    """h = (A·B - C)/Z as an (n - 1, 8) coefficient tensor on `device`, by
    the coset-FFT trick the reference uses (groth16.c.hpp:100-150: iFFT ->
    shift by coset -> FFT -> pointwise -> iFFT -> unshift)."""
    n = 1 << n_bits
    with _clock(times, "pack", device):
        evals = [bd.pack_fr(list(v) + [0] * (n - len(v)), device,
                            reduced=True) for v in (a_e, b_e, c_e)]
    with _clock(times, "ntt", device):
        a_s, b_s, c_s = (bd.fr_ntt(bd.fr_ntt(t, inverse=True), shift=COSET)
                         for t in evals)
        # h on coset = (AB - C) / Z, Z(gx) = g^n x^n - 1 constant on the
        # coset
        z_coset_inv = pow((pow(COSET, n, R) - 1) % R, R - 2, R)
        h_s = bd.fr_pointwise(a_s, b_s, c_s, z_coset_inv)
        h_c = bd.fr_ntt(h_s, inverse=True, post=pow(COSET, R - 2, R))
    return h_c[: n - 1]


def _quotient_coeffs(r1cs: R1CS, w: list[int], n_bits: int,
                     device=None) -> list[int]:
    """The JAX package's `_quotient_coeffs`: h's n - 1 coefficients."""
    h = _quotient(*_lc_evals(r1cs, w), n_bits, resolve_device(device))
    return bd.limbs_to_ints(h)


def groth16_prove(setup: Groth16Setup, witness: list[int],
                  seed: bytes | None = None,
                  times: dict | None = None) -> dict:
    """Produce proof {pi_a, pi_b, pi_c} for a full witness vector, on the
    setup's device. `times` (optional) gets the seconds of each step:
    eval_lc, pack, blind (host), ntt and the five msm_* (card).

    Blinding scalars default to fresh os.urandom entropy; a fixed seed
    (tests only) is mixed with the witness so distinct statements never
    reuse (r, s) — reuse makes pi_a differences leak witness relations.
    """
    r1cs = setup.r1cs
    dev = setup.device
    assert len(witness) == r1cs.n_signals and witness[0] == 1
    with _clock(times, "eval_lc", dev):
        lcs = _lc_evals(r1cs, witness)
        assert all(a * b % R == c for a, b, c in zip(*lcs)), \
            "witness does not satisfy the circuit"
    if seed is None:
        seed = os.urandom(32)
    else:
        wh = hashlib.shake_256(
            b"groth16/blind" + b"".join(int(v).to_bytes(32, "little")
                                        for v in witness)
        ).digest(32)
        seed = seed + wh
    r = _rand_fr(seed, b"r")
    s = _rand_fr(seed, b"s")

    h = _quotient(*lcs, setup.domain_bits, dev, times)

    # 5 MSMs (reference: ThreadA..ThreadH in groth16.c.hpp)
    with _clock(times, "pack", dev):
        w = bd.pack_fr(witness, dev)
    with _clock(times, "msm_a", dev):
        pi_a = msm_mod.g1_msm(setup.a_query, w, dev)
    with _clock(times, "msm_b1", dev):
        pi_b1 = msm_mod.g1_msm(setup.b1_query, w, dev)
    with _clock(times, "msm_b2", dev):
        pi_b2 = msm_mod.g2_msm(setup.b2_query, w, dev)
    with _clock(times, "msm_c", dev):
        pi_c0 = msm_mod.g1_msm(setup.l_query, w[r1cs.n_public + 1:], dev)
    with _clock(times, "msm_h", dev):
        pi_h = msm_mod.g1_msm(setup.h_query, h, dev)

    with _clock(times, "blind", dev):
        return _blind(setup, pi_a, pi_b1, pi_b2, pi_c0, pi_h, r, s)


def _blind(setup, pi_a, pi_b1, pi_b2, pi_c0, pi_h, r, s) -> dict:
    """The proof from the five MSMs and the blinding scalars r, s (host)."""
    pi_a = bn.g1_add(bn.g1_add(pi_a, setup.alpha1), bn.g1_mul(setup.delta1, r))
    pi_b = bn.g2_add(bn.g2_add(pi_b2, setup.beta2), bn.g2_mul(setup.delta2, s))
    pi_b1 = bn.g1_add(bn.g1_add(pi_b1, setup.beta1), bn.g1_mul(setup.delta1, s))
    pi_c = bn.g1_add(pi_c0, pi_h)
    pi_c = bn.g1_add(pi_c, bn.g1_mul(pi_a, s))
    pi_c = bn.g1_add(pi_c, bn.g1_mul(pi_b1, r))
    pi_c = bn.g1_add(pi_c, bn.g1_neg(bn.g1_mul(setup.delta1, r * s % R)))
    return {"pi_a": pi_a, "pi_b": pi_b, "pi_c": pi_c}


def groth16_verify(setup: Groth16Setup, publics: list[int], proof: dict) -> bool:
    """e(-A,B) · e(alpha,beta) · e(L_pub,gamma) · e(C,delta) == 1."""
    assert len(publics) == setup.r1cs.n_public
    # untrusted proof: reject malformed / off-curve / out-of-subgroup points
    try:
        if not (bn.g1_validate(proof["pi_a"]) and bn.g1_validate(proof["pi_c"])
                and bn.g2_validate(proof["pi_b"])):
            return False
    except KeyError:
        return False
    vk_x = setup.ic[0]
    for i, v in enumerate(publics):
        vk_x = bn.g1_add(vk_x, bn.g1_mul(setup.ic[i + 1], v))
    return bn.pairing_check([
        (bn.g1_neg(proof["pi_a"]), proof["pi_b"]),
        (setup.alpha1, setup.beta2),
        (vk_x, setup.gamma2),
        (proof["pi_c"], setup.delta2),
    ])
