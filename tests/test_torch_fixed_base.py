"""The algorithms of the redesigned fixed-base and Fr NTT kernels
(csrc/bn254.cu) on the CPU, against the JAX package's host BN254
(`zkevm_prover_tpu.ops.bn254`): the generator's signed c-bit table and the
fixed-base twin at small windows, with the scalars whose partial sums meet
a table entry or its negation (the kernel's doubling and cancelling
branches on the card); the window the cost model picks at the CRS's sizes;
the NTT's passes (`ntt_plan`) at small tiles, so that one, two and three
passes and every tile edge are crossed, in every form the Groth16 chain
calls. Every comparison is exact."""

import random

import pytest
import torch

from zkevm_prover_tpu.ops import bn254 as jbn
from zkevm_prover_tpu_torch.ops import bn254_cuda
from zkevm_prover_tpu_torch.ops import bn254_device as bd

R = jbn.R
CRS = {False: 6_641_164, True: 1_514_673}   # the 2^21 CRS's G1, G2 scalars


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def signed_digits(s: int, c: int) -> list[int]:
    """bd.signed_digits of one scalar below 2^254, in Python ints."""
    out, carry = [], 0
    for w in range(bd.msm_windows(c)):
        v = ((s >> (c * w)) & ((1 << c) - 1)) + carry
        carry = int(v > 1 << (c - 1))
        out.append(v - (carry << c))
    return out


def meets(s: int, c: int) -> int:
    """The window j at which the partial sum S_j = sum_(i<j) d_i 2^(c i)
    of s's digits is d_j 2^(c j) (the kernel's addition there is a
    doubling) or its negation (it cancels) mod r, else -1."""
    d = signed_digits(s, c)
    for j in range(1, len(d)):
        if d[j]:
            part = sum(v << (c * i) for i, v in enumerate(d[:j])) % R
            if part in (d[j] * pow(2, c * j, R) % R,
                        -d[j] * pow(2, c * j, R) % R):
                return j
    return -1


def hits(c: int) -> list[int]:
    """Scalars below 2^254 whose digits meet a partial sum: r itself (its
    top digit cancels the rest), and 2 d 2^(c j) mod r wherever its digit j
    is d (a doubling)."""
    out = [R]
    for j in range(bd.msm_windows(c) - 1, 0, -1):
        for d in range(1, (1 << (c - 1)) + 1):
            s = 2 * d * pow(2, c * j, R) % R
            if signed_digits(s, c)[j] == d:
                out.append(s)
    return out


@pytest.mark.parametrize("c", [3, 5, 8])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_fixed_base_table_rows(c, g2):
    """Entry [j][d - 1] of the c-bit table is d 2^(c j) G, at the first,
    a middle and the last window, for the first and the last d."""
    t = bd.fixed_base_table(g2, c)
    nwin, nb = bd.msm_windows(c), 1 << (c - 1)
    assert t.shape[:2] == (nwin, nb)
    unpack = bd.unpack_g2 if g2 else bd.unpack_g1
    mul = jbn.g2_mul_gen if g2 else jbn.g1_mul_gen
    for j in (0, nwin // 2, nwin - 1):
        for d in (1, nb):
            assert unpack(t[j, d - 1])[0] == mul(d << (c * j))


@pytest.mark.parametrize("c", [3, 5, 8])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_fixed_base_twin_at_window(c, g2):
    """The twin at window c == g*_mul_gen on 0, 1, r - 1, k beside r - k,
    a repeated scalar, random scalars and scalars whose digits meet a
    partial sum (r cancels, the others double)."""
    rng = random.Random(100 * c + g2)
    k = rng.randrange(R)
    ks = [0, 1, R - 1, k, R - k, k, 2, rng.randrange(R),
          rng.randrange(1 << 64)] + hits(c)[:3]
    mul = jbn.g2_mul_gen if g2 else jbn.g1_mul_gen
    got = bd.fixed_base_plain(bd.pack_fr(ks, "cpu", True), g2, c)
    want = [mul(v) for v in ks]
    assert (bd.unpack_g2 if g2 else bd.unpack_g1)(got) == want
    assert want[0] is jbn.INF and want[9] is jbn.INF and want[3] == \
        (jbn.g2_neg if g2 else jbn.g1_neg)(want[4])


def test_edge_scalars_meet_their_partial_sum():
    """What `hits` promises, at each window the tests use: r cancels, and
    at least one scalar doubles, every one of them below r."""
    for c in (3, 5, 8):
        found = hits(c)
        assert meets(R, c) > 0 and len(found) >= 2
        assert all(meets(s, c) > 0 and s < R for s in found[1:])


@pytest.mark.parametrize("n", [1, 1 << 10, 1 << 16, 1 << 22, CRS[False],
                               CRS[True]])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_fixed_base_window_is_the_cost_minimum(n, g2):
    """fixed_base_plan takes the window of least fixed_base_cost among the
    tables that fit, and its windows and entries follow from it."""
    costs = {c: bd.fixed_base_cost(n, c, g2)
             for c in range(2, bd.FB_MAX_WINDOW + 1)
             if bd.fixed_base_table_bytes(c, g2) <= bd.FB_TABLE_MAX}
    plan = bn254_cuda.fixed_base_plan(n, g2)
    assert costs[plan["c"]] == min(costs.values())
    assert plan["nwin"] == 254 // plan["c"] + 1
    assert plan["table_bytes"] == plan["nwin"] * plan["entries"] * (
        128 if g2 else 64)
    assert plan["c"] >= 16 or n < 1 << 20


def test_ntt_plan_passes():
    """2^21 and 2^22 take two passes of at most 2^11 points; every size
    up to Fr's 2^28 at most three; the lengths sum to log n."""
    for logn in range(0, 29):
        plan = bd.ntt_plan(logn)
        assert sum(p["lm"] for p in plan) == logn
        assert all(p["lm"] <= bd.NTT_TILE_LOG for p in plan)
        assert all(p["tiles"] << p["lm"] == 1 << logn for p in plan)
        assert len(plan) == (1 if logn <= 11 else 2 if logn <= 22 else 3)


@pytest.mark.parametrize("logn", range(1, 13))
def test_ntt_passes_match_fr_fft(logn):
    """The kernel's passes at tiles of 2^4 points (1 pass up to 2^4, 2 up
    to 2^8, 3 up to 2^12) == fr_fft in the chain's forms: inverse,
    forward, the coset forward (shift) and the inverse with the unshift
    (post)."""
    rng = random.Random(logn)
    xs = [0, 1, R - 1][:1 << logn] + [rng.randrange(R)
                                      for _ in range((1 << logn) - 3)]
    t = bd.pack_fr(xs, "cpu")
    tl = 4
    for inverse in (False, True):
        assert bd.limbs_to_ints(bd.fr_ntt_passes(t, inverse, tile_log=tl)) \
            == jbn.fr_fft(xs, inverse=inverse)
    g = 7
    shifted = [x * pow(g, i, R) % R for i, x in enumerate(xs)]
    assert bd.limbs_to_ints(bd.fr_ntt_passes(t, shift=g, tile_log=tl)) == \
        jbn.fr_fft(shifted)
    ginv = pow(g, R - 2, R)
    want = [y * pow(ginv, i, R) % R
            for i, y in enumerate(jbn.fr_fft(xs, inverse=True))]
    assert bd.limbs_to_ints(bd.fr_ntt_passes(t, True, post=ginv,
                                             tile_log=tl)) == want
