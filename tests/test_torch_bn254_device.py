"""The port's BN254 device layer (`ops/bn254_device.py`, `ops/msm.py`)
against the JAX package: the plain torch twins of the csrc/bn254.cu kernels
on the CPU.

The field twins are held against `zkevm_prover_tpu.ops.bn254_device` (its
jitted Fp and Fp2 products compile in about a second on a CPU); the group
law, whose jitted Jacobian addition takes about 12 s to compile there,
against the JAX package's host `ops/bn254.py`, as are the MSM, fixed-base
and NTT twins. Every comparison is exact.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zkevm_prover_tpu.ops import bn254 as jbn
from zkevm_prover_tpu.ops import bn254_device as jdev
from zkevm_prover_tpu_torch.ops import bn254_cuda
from zkevm_prover_tpu_torch.ops import bn254_device as bd
from zkevm_prover_tpu_torch.ops import msm

P, R = jbn.P, jbn.R


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _elements(n, seed, mod=P):
    rng = random.Random(seed)
    return ([0, 1, mod - 1] + [rng.randrange(mod) for _ in range(n - 3)])[:n]


def _lazy(xs):
    return bd.f_from_u32(torch.from_numpy(bd.ints_to_limbs(xs).copy()))


def _jax_limbs(xs):
    return jnp.asarray(np.stack([jdev.limbs_np(x) for x in xs]))


def _jax_ints(a):
    a = np.asarray(a)
    return [jdev.to_int(a[i]) for i in range(a.shape[0])]


def test_fp_ops_match_jax_device():
    """add, sub and the Montgomery product of 16 elements (0, 1, p - 1
    among them): the twin's lazily reduced limbs, canonicalised, against
    the JAX package's jitted CIOS on Montgomery limbs."""
    xs, ys = _elements(16, 1), _elements(16, 2)[::-1]
    a, b = _lazy(xs), _lazy(ys)
    ja, jb = (jax.jit(jdev.to_mont)(_jax_limbs(v)) for v in (xs, ys))
    out = jax.jit(lambda x, y: [jdev.from_mont(f(x, y)) for f in
                                (jdev.fp_add, jdev.fp_sub, jdev.fp_mul)])(
        ja, jb)
    for got, want in zip((bd.f_add(bd.FP, a, b), bd.f_sub(bd.FP, a, b),
                          bd.f_mul(bd.FP, a, b)), out):
        assert bd.limbs_to_ints(bd.f_to_u32(bd.FP, got)) == _jax_ints(want)
    # the JAX package's Montgomery round trip is the identity the twin keeps
    back = jax.jit(lambda x: jdev.from_mont(jdev.to_mont(x)))(_jax_limbs(xs))
    assert _jax_ints(back) == bd.limbs_to_ints(bd.f_to_u32(bd.FP, a)) == xs


def test_fp2_product_matches_jax_device():
    xs = _elements(16, 3)
    ys = _elements(16, 4)
    a = torch.stack([_lazy(xs[:8]), _lazy(xs[8:])], dim=-2)
    b = torch.stack([_lazy(ys[:8]), _lazy(ys[8:])], dim=-2)
    got = bd._Fp2.mul_many([(a, b)])[0]
    ja, jb = (jnp.stack([_jax_limbs(v[:8]), _jax_limbs(v[8:])], axis=-2)
              for v in (xs, ys))
    want = jax.jit(lambda x, y: jdev.from_mont(jdev._Fp2Ops.mul(
        jdev.to_mont(x), jdev.to_mont(y))))(ja, jb)
    want = np.asarray(want)
    assert bd.limbs_to_ints(bd.f_to_u32(bd.FP, got[:, 0])) == \
        _jax_ints(want[:, 0])
    assert bd.limbs_to_ints(bd.f_to_u32(bd.FP, got[:, 1])) == \
        _jax_ints(want[:, 1])


def test_fr_ops_and_inverse():
    xs = _elements(12, 5, R)
    a = _lazy(xs)
    inv = bd.limbs_to_ints(bd.f_to_u32(bd.FR, bd.f_pow(bd.FR, a, R - 2)))
    assert inv == [pow(x, R - 2, R) for x in xs]
    sq = bd.limbs_to_ints(bd.f_to_u32(bd.FR, bd.f_mul(bd.FR, a, a)))
    assert sq == [x * x % R for x in xs]


def _points(n, seed, g2=False):
    rng = random.Random(seed)
    mul = jbn.g2_mul_gen if g2 else jbn.g1_mul_gen
    return [mul(rng.randrange(1, R)) for _ in range(n)]


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_group_law_matches_host(g2):
    """The twins' complete projective addition and doubling against the
    host's affine law, with P + P, P + (-P) and infinity among the
    pairs."""
    F = bd._Fp2 if g2 else bd._Fp
    add, dbl, neg = ((jbn.g2_add, jbn.g2_double, jbn.g2_neg) if g2 else
                     (jbn.g1_add, jbn.g1_double, jbn.g1_neg))
    pack = bd.pack_g2 if g2 else bd.pack_g1
    unpack = bd.unpack_g2 if g2 else bd.unpack_g1
    ps = _points(6, 10 + g2, g2)
    qs = [ps[1], ps[0], neg(ps[2]), jbn.INF, ps[4], jbn.INF]
    ps[5] = jbn.INF
    p, q = bd._affine_in(F, pack(ps, "cpu")), bd._affine_in(F, pack(qs, "cpu"))
    assert unpack(bd._pt_affine_u32(F, bd.pt_add(F, p, q))) == \
        [add(a, b) for a, b in zip(ps, qs)]
    assert unpack(bd._pt_affine_u32(F, bd.pt_double(F, p))) == \
        [dbl(a) if a is not jbn.INF else jbn.INF for a in ps]


def _witness_scalars(n, seed):
    """Scalars shaped like a Groth16 witness: half 0 or 1, a quarter below
    2^64, a quarter dense."""
    rng = random.Random(seed)
    return [rng.randrange(2) if i % 4 < 2 else
            rng.randrange(1 << 64) if i % 4 == 2 else rng.randrange(R)
            for i in range(n)]


def _msm_inputs(n, seed, kind, g2=False):
    """(points, scalars): random scalars, or witness-like ones with every
    seventh point at infinity."""
    pts = _points(n, seed, g2)
    if kind == "random":
        return pts, [random.Random(seed + 1).randrange(R) for _ in range(n)]
    return ([jbn.INF if i % 7 == 3 else p for i, p in enumerate(pts)],
            _witness_scalars(n, seed + 1))


@pytest.mark.parametrize("n,kind", [(16, "random"), (64, "random"),
                                    (256, "random"), (64, "skewed")])
def test_g1_msm_twin_matches_host(n, kind):
    pts, sc = _msm_inputs(n, n, kind)
    got = bd.msm_plain(bd.pack_g1(pts, "cpu"), bd.pack_fr(sc, "cpu"), False)
    assert bd.unpack_g1(got)[0] == jbn.g1_msm(pts, sc)


@pytest.mark.parametrize("kind", ["random", "skewed"])
def test_g2_msm_twin_matches_host(kind):
    pts, sc = _msm_inputs(16, 7, kind, True)
    got = bd.msm_plain(bd.pack_g2(pts, "cpu"), bd.pack_fr(sc, "cpu"), True)
    assert bd.unpack_g2(got)[0] == jbn.g2_msm(pts, sc)


_CARRY = sum(((1 << 17) - 1) << (17 * w) for w in range(14))  # all ones


@pytest.mark.parametrize("c", [2, 5, 8, 13, 16, 17, 22])
def test_signed_digits_recode_the_scalar(c):
    """sum_w d_w 2^(c w) == s with |d_w| <= 2^(c-1), for random scalars
    and 0, 1, r - 1, 2^254 - 1, and windows of all ones whose carries run
    into the top window."""
    rng = random.Random(c)
    xs = [0, 1, R - 1, (1 << 254) - 1, _CARRY, (1 << 253) | _CARRY,
          ((1 << (c * (254 // c))) - 1)] + [rng.randrange(R)
                                            for _ in range(25)]
    d = bd.signed_digits(torch.from_numpy(bd.ints_to_limbs(xs).copy()), c)
    assert d.shape == (len(xs), bd.msm_windows(c))
    assert int(d.abs().max()) <= 1 << (c - 1)
    assert [sum(int(v) << (c * w) for w, v in enumerate(row))
            for row in d.tolist()] == xs


@pytest.mark.parametrize("n", [1, 1 << 10, 1 << 16, 1 << 20, 1 << 21,
                               1 << 22])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_msm_window_is_the_cost_minimum(n, g2):
    """msm_window(n) minimises the signed-digit Pippenger's Fp products,
    n mixed additions and 2^c full additions per window of
    floor(254 / c) + 1, over every width; the kernels' plan (msm_plan)
    takes it and fits its chunks, tree passes and reduction to it."""
    madd, add = bd.MSM_MADD[g2], bd.MSM_ADD[g2]
    cost = {c: (254 // c + 1) * (n * madd + (1 << c) * add)
            for c in range(2, 23)}
    c = bd.msm_window(n, g2)
    assert cost[c] == min(cost.values()) == bd.msm_cost(n, c, g2)
    assert c == {1: 2, 1 << 10: 8, 1 << 16: 13, 1 << 20: 16, 1 << 21: 17,
                 1 << 22: 17}[n]
    plan = bn254_cuda.msm_plan(n, g2)
    assert (plan["c"], plan["nwin"], plan["nb"]) == (c, 254 // c + 1,
                                                     1 << (c - 1))
    assert plan["nchunks"] * plan["L"] >= plan["nwin"] * n
    assert 8 ** plan["passes"] >= -(-n // plan["L"]) + 1   # any bucket
    assert plan["ls"] * plan["tr"] * plan["bw"] == plan["nb"]
    assert max(plan["bw"], plan["tr"]) <= bn254_cuda.REDUCE_MAX


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_msm_edge_cases(g2):
    """Zero scalars, scalars >= r, repeated points, a point beside its
    negation and the point at infinity, through ops/msm.py on the CPU."""
    ps = _points(4, 20, g2)
    neg = jbn.g2_neg if g2 else jbn.g1_neg
    pts = ps + [ps[0], ps[0], neg(ps[1]), jbn.INF]
    sc = [3, 0, R + 5, (1 << 256) - 1, 3, 7, 1, 9]
    f = msm.g2_msm if g2 else msm.g1_msm
    host_msm = jbn.g2_msm if g2 else jbn.g1_msm
    assert f(pts, sc, "cpu") == host_msm(pts, [s % R for s in sc])
    # P + (-P) alone is infinity; an empty MSM and all-zero scalars too
    assert f([ps[1], neg(ps[1])], [4, 4], "cpu") is jbn.INF
    assert f([], [], "cpu") is jbn.INF
    assert f(ps, [0] * 4, "cpu") is jbn.INF


def test_msm_takes_device_point_lists():
    pts = _points(12, 30)
    sc = [random.Random(31).randrange(R) for _ in range(12)]
    pl = msm.PointList(bd.pack_g1(pts, "cpu"), g2=False)
    assert pl == pts and pts == pl and len(pl) == 12 and pl[3] == pts[3]
    assert pl[-1] == pts[-1] and list(pl) == pts and pl[2:5] == pts[2:5]
    assert msm.g1_msm(pl, bd.pack_fr(sc, "cpu"), "cpu") == jbn.g1_msm(pts, sc)
    with pytest.raises(ValueError, match="points"):
        msm.g1_msm(pts, sc[:-1], "cpu")


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_fixed_base_twin_matches_host(g2):
    ks = _elements(10, 40 + g2, R)
    got = bd.fixed_base_plain(bd.pack_fr(ks, "cpu"), g2)
    mul = jbn.g2_mul_gen if g2 else jbn.g1_mul_gen
    assert (bd.unpack_g2 if g2 else bd.unpack_g1)(got) == [mul(k) for k in ks]
    # through the dispatcher on a CPU tensor
    assert torch.equal(bd.fixed_base(bd.pack_fr(ks, "cpu"), g2), got)


def test_fixed_base_table_matches_host():
    """The c-bit table (entry [j][d - 1] = d 2^(c j) G) at c = 4, and the
    Montgomery bases the card's table build starts from."""
    t = bd.fixed_base_table(False, 4)
    assert t.shape == (bd.msm_windows(4), 8, 2, 8)
    for j, d in ((0, 1), (0, 8), (17, 3), (63, 5)):
        assert bd.unpack_g1(t[j, d - 1])[0] == jbn.g1_mul_gen(d << (4 * j))
    t2 = bd.fixed_base_table(True, 4)
    assert bd.unpack_g2(t2[5, 6])[0] == jbn.g2_mul_gen(7 << 20)
    mont = bd.fixed_base_bases_mont(False, 4)
    assert bd.limbs_to_ints(mont[2, :1])[0] == \
        bd.limbs_to_ints(t[2, 0, :1])[0] * (1 << 256) % P


@pytest.mark.parametrize("logn", range(1, 11))
def test_ntt_twin_matches_fr_fft(logn):
    xs = _elements(1 << logn, logn, R)
    t = bd.pack_fr(xs, "cpu")
    for inverse in (False, True):
        assert bd.limbs_to_ints(bd.fr_ntt_plain(t, inverse)) == \
            jbn.fr_fft(xs, inverse=inverse)
    assert bd.fr_fft(xs, device="cpu") == jbn.fr_fft(xs)


def test_ntt_twin_shifts_and_pointwise():
    n = 16
    xs = _elements(n, 50, R)
    t = bd.pack_fr(xs, "cpu")
    shifted = [x * pow(5, i, R) % R for i, x in enumerate(xs)]
    assert bd.limbs_to_ints(bd.fr_ntt_plain(t, shift=5)) == \
        jbn.fr_fft(shifted)
    post = [y * pow(7, i, R) % R
            for i, y in enumerate(jbn.fr_fft(xs, inverse=True))]
    assert bd.limbs_to_ints(bd.fr_ntt_plain(t, True, post=7)) == post
    ys, zs = _elements(n, 51, R), _elements(n, 52, R)
    got = bd.fr_pointwise(t, bd.pack_fr(ys, "cpu"), bd.pack_fr(zs, "cpu"), 99)
    assert bd.limbs_to_ints(got) == [(x * y - z) * 99 % R
                                     for x, y, z in zip(xs, ys, zs)]
    with pytest.raises(ValueError, match="power of two"):
        bd.fr_ntt_plain(bd.pack_fr(xs[:3], "cpu"))


def test_limb_packing_round_trips():
    xs = [0, 1, (1 << 256) - 1, P - 1, 1 << 200]
    assert bd.limbs_to_ints(torch.from_numpy(bd.ints_to_limbs(xs).copy())) \
        == xs
    pts = _points(3, 60) + [jbn.INF]
    assert bd.unpack_g1(bd.pack_g1(pts, "cpu")) == pts
    pts2 = _points(2, 61, True) + [jbn.INF]
    assert bd.unpack_g2(bd.pack_g2(pts2, "cpu")) == pts2
    assert bd.limbs_to_ints(bd.pack_fr([R + 3, -1], "cpu")) == [3, R - 1]


def test_cuda_wrappers_reject_cpu_tensors():
    before = dict(bn254_cuda.launches)
    cpu = torch.zeros((4, 8), dtype=torch.int32)
    for call in (lambda: bn254_cuda.fixed_base(cpu, False),
                 lambda: bn254_cuda.fr_ntt(cpu),
                 lambda: bn254_cuda.fr_pointwise(cpu, cpu, cpu, 1),
                 lambda: bn254_cuda.msm(torch.zeros((4, 2, 8),
                                                    dtype=torch.int32), cpu,
                                        False)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert bn254_cuda.launches == before
