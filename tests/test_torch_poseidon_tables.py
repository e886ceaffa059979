"""The host side of csrc/poseidon_gl.cu, checked on the CPU before the card
sees it: the MDS compiled into the source, and its circulant + diagonal
form, equal the JAX package's; the derived constants
(`poseidon_cuda.fold_constants`, `sparse_constants`) run through a
Python-int model of the kernel's rounds and lazy reductions, with the dense
MDS of kernel 1 and with mode 2d's circulant form in the frequency domain
(every intermediate's range bounded), equal JAX
`poseidon_gl.permute` bit for bit; and the fused Merkle commit's launch
plan and buffer layout, run with the plain permutation, equal the chunked
tree. Mode mxu's model is in test_torch_poseidon_mxu.py."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkevm_prover_tpu.ops import poseidon_gl as jpgl
from zkevm_prover_tpu.ops import poseidon_pallas as jpp
from zkevm_prover_tpu_torch.ops import goldilocks as gl
from zkevm_prover_tpu_torch.ops import merkle
from zkevm_prover_tpu_torch.ops import poseidon_constants as pc
from zkevm_prover_tpu_torch.ops import poseidon_cuda
from zkevm_prover_tpu_torch.ops import poseidon_gl as pg

CSRC = Path(poseidon_cuda.__file__).resolve().parents[1] / "csrc"
P = gl.P
EPS = (1 << 32) - 1
U64 = 1 << 64


def compiled_circ_diag() -> tuple:
    """The circulant + diagonal form that poseidon_common.cuh compiles in,
    read from the source (circ_coeff's chain of k == i ? c, and
    diag_coeff's one nonzero entry, lane 0's)."""
    text = (CSRC / "poseidon_common.cuh").read_text()
    body = text[text.index("constexpr uint32_t circ_coeff"):]
    body = body[:body.index(";")]
    circ = [int(c) for _, c in re.findall(r"k == (\d+) \? (\d+)", body)]
    circ.append(int(re.search(r":\s*(\d+)\s*$", body).group(1)))
    diag0 = int(re.search(r"diag_coeff\(int i\) \{\s*return i == 0 \? "
                          r"(\d+) : 0;", text).group(1))
    return circ, [diag0] + [0] * (pg.WIDTH - 1)


def compiled_mds() -> np.ndarray:
    """The 12x12 MDS that poseidon_common.cuh compiles in (mds_coeff =
    circ_coeff + diag_coeff on the diagonal)."""
    circ, diag = compiled_circ_diag()
    w = pg.WIDTH
    return np.array([[circ[(j - i) % w] + (diag[i] if i == j else 0)
                      for j in range(w)] for i in range(w)])


# ---- a Python-int model of the kernel's lazy arithmetic -------------------
# Every value a register pair holds is checked to stay below 2^64, every
# accumulator below its stated bound, and every correction not to wrap.

def reduce_words(v: int) -> int:
    """goldilocks.cuh reduce_words on the 160-bit v (r4 < 2^31)."""
    r0, r1, r2, r3, r4 = ((v >> (32 * k)) & EPS for k in range(5))
    assert v >> 160 == 0 and r4 < 1 << 31
    t = ((r1 << 32) | r0) - ((r4 << 32) | r3)
    if t < 0:
        t += U64 - EPS
        assert 0 <= t < U64
    s = t + (r2 << 32) - r2
    if s >= U64:
        s += EPS - U64
        assert s < U64
    return s


def mul_lazy(a: int, b: int) -> int:
    assert 0 <= a < U64 and 0 <= b < U64
    return reduce_words(a * b)


def mul_add_lazy(a: int, b: int, c: int) -> int:
    assert 0 <= a < U64 and 0 <= b < U64 and 0 <= c < U64
    return reduce_words(a * b + c)


def add_lazy(a: int, c: int) -> int:
    assert 0 <= a < U64 and 0 <= c < P
    s = a + c
    return s - U64 + EPS if s >= U64 else s


def reduce96(v: int) -> int:
    """poseidon_common.cuh reduce96 on (w2:w1:w0), w2 < 2^31."""
    w2 = v >> 64
    assert w2 < 1 << 31
    s = (v & (U64 - 1)) + w2 * EPS
    if s >= U64:
        s += EPS - U64
        assert s < U64
    return s


LIMBS = ((0, 22), (22, 21), (43, 21))   # poseidon_common.cuh split_limbs


def fold_limb_sums(sums, c) -> int:
    """poseidon_common.cuh fold_limb_sums: each limb sum below 2^31,
    recombined with the constant c and reduced once."""
    assert all(0 <= x < 1 << 31 for x in sums)
    return reduce96(sums[0] + (sums[1] << 22) + (sums[2] << 43) + int(c))


def mds_fold_limbs(s, m, c):
    """poseidon_common.cuh mds_fold_limbs: the dense coefficients on the
    22/21/21-bit limbs."""
    return [fold_limb_sums([sum(int(m[i, j]) * ((s[j] >> sh) & ((1 << b) - 1))
                                for j in range(len(s))) for sh, b in LIMBS],
                           c[i])
            for i in range(len(s))]


def crt(a: int, b: int) -> int:
    """poseidon_gl_2d.cuh crt: the lane that is a mod 3 and b mod 4."""
    return (4 * a + 9 * b) % pg.WIDTH


def freq_constants(circ) -> tuple:
    """The DFT constants of poseidon_gl_2d.cuh circ_freq, derived from circ
    in exact integers: F0/4, F2/4 (real) and F1/2 (Gaussian, (re, im)),
    with F_f[a] = sum_b circ[crt(a, b)] i^(f b); each asserted exact."""
    def f(f_, a):
        re = im = 0
        for b in range(4):
            c, e = circ[crt(a, b)], f_ * b % 4
            re += c if e == 0 else -c if e == 2 else 0
            im += c if e == 1 else -c if e == 3 else 0
        return re, im
    out = {k: [f(k, a) for a in range(3)] for k in range(3)}
    assert all(im == 0 for k in (0, 2) for _, im in out[k])
    assert all(re % 4 == 0 for k in (0, 2) for re, _ in out[k])
    assert all(x % 2 == 0 for z in out[1] for x in z)
    return ([re // 4 for re, _ in out[0]], [re // 4 for re, _ in out[2]],
            [(re // 2, im // 2) for re, im in out[1]])


def circ_freq(x, consts, check=lambda v: v):
    """poseidon_gl_2d.cuh circ_freq, step for step: y = circ x on one limb
    array; `check` sees every intermediate."""
    F0, F2, F1 = consts
    s0, s2, s1r, s1i = [], [], [], []
    for a in range(3):
        xb = [x[crt(a, b)] for b in range(4)]
        e0, e1 = check(xb[0] + xb[2]), check(xb[1] + xb[3])
        s0.append(check(e0 + e1))
        s2.append(check(e0 - e1))
        s1r.append(check(xb[0] - xb[2]))
        s1i.append(check(xb[3] - xb[1]))
    y = [None] * len(x)
    for a in range(3):
        t0 = t2 = t1r = t1i = 0
        for k in range(3):
            j = (a + k) % 3
            t0 = check(t0 + F0[k] * s0[j])
            t2 = check(t2 + F2[k] * s2[j])
            t1r = check(t1r + check(F1[k][0] * s1r[j] - F1[k][1] * s1i[j]))
            t1i = check(t1i + check(F1[k][0] * s1i[j] + F1[k][1] * s1r[j]))
        u, v = check(t0 + t2), check(t0 - t2)
        y[crt(a, 0)], y[crt(a, 1)] = check(u + t1r), check(v - t1i)
        y[crt(a, 2)], y[crt(a, 3)] = check(u - t1r), check(v + t1i)
    return y


def mds_freq_limbs(s, circ, diag, c):
    """poseidon_gl_2d.cuh circulant::Mds: per limb array the circulant in
    the frequency domain (every intermediate asserted inside int32) plus
    diag_i l_i, then fold_limb_sums."""
    consts = freq_constants(circ)

    def check(v):
        assert -(1 << 31) <= v < 1 << 31
        return v

    ys, limbs = [], []
    for sh, b in LIMBS:
        limb = [(x >> sh) & ((1 << b) - 1) for x in s]
        limbs.append(limb)
        ys.append(circ_freq(limb, consts, check))
    return [fold_limb_sums([y[i] + diag[i] * limb[i]
                            for y, limb in zip(ys, limbs)], c[i])
            for i in range(len(s))]


def sbox(x: int) -> int:
    x3 = mul_lazy(mul_lazy(x, x), x)
    return mul_lazy(mul_lazy(x3, x3), x)


def sparse_rounds(s, fold, pre, w, v, m00):
    """csrc/poseidon_gl.cu partial_rounds: PRE on lanes 1..11, then each
    round [[m00, w], [v, I]] with its lane-0 constant, then the rest of the
    last round's constants."""
    half, n_p = pc.ROUNDS_F // 2, pc.ROUNDS_P
    s = [s[0]] + [reduce_words(sum(int(pre[i, j]) * s[1 + j]
                                   for j in range(11))) for i in range(11)]
    for k in range(n_p):
        x = sbox(s[0])
        acc = int(fold[half + k, 0]) + m00 * x + sum(
            int(w[k, j]) * s[1 + j] for j in range(11))
        s = [reduce_words(acc)] + [mul_add_lazy(int(v[k, j]), x, s[1 + j])
                                   for j in range(11)]
    last = fold[half + n_p - 1]
    return [s[0]] + [add_lazy(x, int(c)) for x, c in zip(s[1:], last[1:])]


def model_permute(state, rc0, fold, m, sparse, mds=None):
    """csrc/poseidon_lazy.cuh permute_lazy, round for round, then
    canonical; `sparse` = poseidon_cuda.sparse_constants(M), `mds(s, c)`
    the full rounds' MDS (default: kernel 1's mds_fold_limbs with m)."""
    half, n_p = pc.ROUNDS_F // 2, pc.ROUNDS_P
    mds = mds or (lambda s, c: mds_fold_limbs(s, m, c))
    s = [add_lazy(int(x), int(c)) for x, c in zip(state, rc0)]
    for r in range(pc.N_ROUNDS):
        if half <= r < half + n_p:
            if r == half:
                s = sparse_rounds(s, fold, *sparse, int(m[0, 0]))
            continue
        s = mds([sbox(x) for x in s], fold[r])
    return [x - P if x >= P else x for x in s]


def _jax_permute(states: np.ndarray) -> np.ndarray:
    return np.asarray(jpgl.permute(jnp.asarray(states)))


def test_compiled_mds_matches_jax():
    want = np.asarray(jpgl._mds_coeffs(pc.source()))
    np.testing.assert_array_equal(compiled_mds(), want)
    tab = poseidon_cuda._host_tables(pc.source())
    np.testing.assert_array_equal(tab["mds"], want)


def test_fold_constants_schedule():
    C, M = pg.tables_host(pc.source())
    rc0, fold = poseidon_cuda.fold_constants(C, M)
    assert rc0.shape == (12,) and fold.shape == (30, 12)
    assert rc0.dtype == fold.dtype == np.uint64
    np.testing.assert_array_equal(rc0, C[0])
    half, n_p = pc.ROUNDS_F // 2, pc.ROUNDS_P
    for r in list(range(half - 1)) + list(range(half + n_p, 29)):
        np.testing.assert_array_equal(fold[r], C[r + 1])   # full rounds as given
    for r in range(half - 1, half + n_p - 1):              # partial: lane 0 only
        assert not fold[r, 1:].any() and fold[r, 0] != 0
    assert not fold[29].any()
    assert all(int(v) < P for v in fold.reshape(-1))


def model_states(kind: str, n: int = 6) -> np.ndarray:
    """n test states of a kind: random canonical, the edges 0 and p - 1, or
    any u64 (at and above p, and 2^64 - 1)."""
    rng = np.random.default_rng({"random": 11, "edges": 12,
                                 "non_canonical": 13}[kind])
    if kind == "random":
        return rng.integers(0, P, (n, 12), dtype=np.uint64)
    if kind == "edges":
        rows = [np.zeros(12, np.uint64), np.full(12, P - 1, np.uint64),
                np.array([0, P - 1] * 6, np.uint64)]
        return np.stack([rows[i % 3] for i in range(n)])
    states = rng.integers(0, 1 << 64, (n, 12), dtype=np.uint64)
    states[0] = np.full(12, U64 - 1, np.uint64)
    states[1, ::2] = P
    return states


@pytest.mark.parametrize("kind", ["random", "edges", "non_canonical"])
def test_kernel_model_matches_jax(kind):
    states = model_states(kind, {"random": 6, "edges": 3,
                                 "non_canonical": 4}[kind])
    C, M = pg.tables_host(pc.source())
    rc0, fold = poseidon_cuda.fold_constants(C, M)
    m = compiled_mds()
    sp = poseidon_cuda.sparse_constants(M)
    got = np.array([model_permute(s, rc0, fold, m, sp) for s in states],
                   dtype=np.uint64)
    np.testing.assert_array_equal(got, _jax_permute(states))


def test_compiled_circ_diag_matches_jax():
    circ, diag = compiled_circ_diag()
    assert jpp._circ_diag(np.asarray(jpgl._mds_coeffs(pc.source()))) == (
        circ, diag)
    tab = poseidon_cuda._host_tables(pc.source())
    assert tab["circ"].tolist() == circ and tab["diag"].tolist() == diag


def test_2d_frequency_form_is_the_circulant():
    """circ_freq's constants from the JAX package's circ are the ones
    poseidon_gl_2d.cuh notes, and as linear forms its 12 outputs are the
    circulant's rows, every intermediate below 2^30 in magnitude on 22-bit
    limbs (the bound: the sum of |coefficients| times the largest limb)."""
    circ, _ = jpp._circ_diag(np.asarray(jpgl._mds_coeffs(pc.source())))
    consts = freq_constants(circ)
    assert consts == ([16, 16, 32], [-1, 2, 8], [(2, 1), (-16, 1), (-1, 4)])
    w, top = pg.WIDTH, (1 << 22) - 1
    largest = [0]

    def bound(v):
        largest[0] = max(largest[0], sum(abs(int(k)) for k in v) * top)
        return v

    forms = circ_freq([np.eye(w, dtype=np.int64)[j] for j in range(w)],
                      consts, bound)
    for i in range(w):
        assert forms[i].tolist() == [circ[(j - i) % w] for j in range(w)]
    assert largest[0] < 1 << 30


@pytest.mark.parametrize("kind", ["random", "edges", "non_canonical"])
def test_2d_model_matches_jax(kind):
    states = model_states(kind, 4)
    C, M = pg.tables_host(pc.source())
    rc0, fold = poseidon_cuda.fold_constants(C, M)
    circ, diag = compiled_circ_diag()
    sp = poseidon_cuda.sparse_constants(M)

    def mds(s, c):
        return mds_freq_limbs(s, circ, diag, c)

    got = np.array([model_permute(s, rc0, fold, compiled_mds(), sp, mds)
                    for s in states], dtype=np.uint64)
    np.testing.assert_array_equal(got, _jax_permute(states))


def test_fold_constants_of_another_set():
    """The derivations do not lean on the reference set: with the
    placeholder constants (another MDS) they still reproduce the plain
    permutation."""
    try:
        pc.load_constants("placeholder")
        C, M = pg.tables_host(pc.source())
        rc0, fold = poseidon_cuda.fold_constants(C, M)
        m = np.array(M, dtype=object)
        states = np.random.default_rng(14).integers(0, P, (2, 12),
                                                    dtype=np.uint64)
        want = gl.to_u64(pg.permute_plain(gl.from_u64(states, "cpu")))

        pre, w, v = poseidon_cuda.sparse_constants(M)

        def exact(state):   # the schedule in plain field arithmetic
            s = [(int(x) + int(c)) % P for x, c in zip(state, rc0)]
            for r in range(pc.N_ROUNDS):
                if pg.is_full_round(r):
                    s = [pow(x, 7, P) for x in s]
                    s = [(sum(int(m[i, j]) * s[j] for j in range(12))
                          + int(fold[r, i])) % P for i in range(12)]
                    if r == 3:   # the sparse rounds' dense factors
                        s = [s[0]] + [sum(int(pre[i, j]) * s[1 + j]
                                          for j in range(11)) % P
                                      for i in range(11)]
                    continue
                k, x = r - 4, pow(s[0], 7, P)
                s = [(int(m[0, 0]) * x + sum(int(w[k, j]) * s[1 + j]
                                             for j in range(11))) % P] + [
                    (s[1 + j] + int(v[k, j]) * x) % P for j in range(11)]
                s = [(y + int(c)) % P for y, c in zip(s, fold[r])]
            return s

        got = np.array([exact(s) for s in states], dtype=np.uint64)
        np.testing.assert_array_equal(got, want)
    finally:
        pc.load_constants(None)


@pytest.mark.parametrize("h,w", [(1, 3), (2, 9), (8, 17), (256, 8),
                                 (512, 48), (1 << 16, 4), (1 << 22, 189)])
def test_merkle_plan_covers_the_tree(h, w):
    plan = poseidon_cuda.merkle_plan(h, w)
    n_chunks = -(-w // 8) if w > 4 else 1
    leaf = [p for p in plan if p[1]]
    assert [p[5] for p in leaf] == list(range(n_chunks))
    assert all(p[:5] == (0, True, h, min(h, 128), 0) for p in leaf)
    built = 0                                    # highest level made so far
    for base, leaves, nodes, threads, more, _ in plan[len(leaf):]:
        assert not leaves and base == built and nodes == h >> (base + 1)
        assert threads & (threads - 1) == 0 and nodes % threads == 0
        assert threads <= poseidon_cuda.MERKLE_THREADS
        assert more == 0 or (threads == nodes and 1 << more == threads)
        built = base + 1 + more
    assert built == h.bit_length() - 1
    assert len(plan) - len(leaf) == (0 if h == 1
                                     else max(1, h.bit_length() - 8))


def _model_commit(source: torch.Tensor) -> list:
    """csrc/poseidon_gl.cu's commit, launch by launch as merkle_plan says,
    block by block into the (2H - 1, 4) buffer, with the plain
    permutation."""
    h, w = source.shape
    tree = torch.full((2 * h - 1, 4), -1, dtype=torch.int64)
    off = poseidon_cuda.level_offset
    for base, leaves, nodes, threads, more, chunk in poseidon_cuda.merkle_plan(
            h, w):
        if leaves and w <= 4:
            tree[:h] = pg.linear_hash(source, pg.permute_plain)
        elif leaves:   # the digest carried in level 0 between launches
            digest = (tree[:h] if chunk
                      else torch.zeros((h, 4), dtype=torch.int64))
            tree[:h] = pg.linear_hash_fold(source[:, 8 * chunk:8 * chunk + 8],
                                           digest.clone(), pg.permute_plain)
        if leaves:
            continue
        kids = tree[off(h, base):off(h, base) + 2 * nodes]
        made = pg.hash_level(kids, pg.permute_plain)
        tree[off(h, base + 1):off(h, base + 1) + nodes] = made
        for b in range(nodes // threads):          # then `more` per block
            below = made[b * threads:(b + 1) * threads]
            for lvl in range(1, more + 1):
                above = pg.hash_level(below, pg.permute_plain)
                at = off(h, base + 1 + lvl) + b * (threads >> lvl)
                tree[at:at + (threads >> lvl)] = above
                below = above
    assert not (tree == -1).all(dim=1).any()
    return poseidon_cuda.tree_levels(tree, h)


@pytest.mark.parametrize("h,w", [(1, 3), (2, 9), (256, 8), (512, 5), (8, 17),
                                 (8, 25), (16, 65)])
def test_merkle_model_matches_chunked(h, w):
    src = gl.from_u64(np.random.default_rng(h + w).integers(
        0, P, (h, w), dtype=np.uint64), "cpu")
    want = merkle.merkelize_levels_plain(src)
    got = _model_commit(src)
    assert [lv.shape for lv in got] == [lv.shape for lv in want]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
