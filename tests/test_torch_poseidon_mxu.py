"""Modes mxu and mxu24 (csrc/poseidon_gl_mxu.cuh, csrc/poseidon_gl_mxu24.cuh),
modelled on the CPU before the card sees them: the m16n8k32 u8 fragment
maps of the PTX ISA with each kernel's k-slot and column permutation
(`poseidon_cuda.mma_operands`), the byte-plane products (mxu: one plane per
MMA; mxu24: a plane pair side by side in k, packed by byte permutes) and
their recombination with the FOLD constants, the two layout changes through
the warp's shared tile, and the whole schedule (full rounds in fragment
layout, the sparse partial rounds one state per lane), held against JAX
`poseidon_gl.permute` bit for bit with a range assert on every
intermediate. Tolerance 0 throughout: the results are exact integers. The
operands themselves are held against the JAX package's I_8 (x) M and
I_8 (x) blockdiag(M, M) in test_torch_poseidon_modes.py."""

import numpy as np
import pytest

from test_torch_poseidon_tables import (EPS, P, _jax_permute, add_lazy,
                                        compiled_mds, model_states, reduce96,
                                        sbox, sparse_rounds)
from zkevm_prover_tpu_torch.ops import poseidon_constants as pc
from zkevm_prover_tpu_torch.ops import poseidon_cuda
from zkevm_prover_tpu_torch.ops import poseidon_gl as pg

W = pg.WIDTH
HALF, N_P = pc.ROUNDS_F // 2, pc.ROUNDS_P


# ---- the PTX ISA's fragment layouts of mma.m16n8k32 with .u8 operands ----
# lane = 4 g + t; A is 16 x 32 (row x k), B 32 x 8 (k x n), C 16 x 8.

def a_element(lane: int, reg: int, byte: int) -> tuple:
    """(row, k) of byte `byte` of A register `reg` (a0..a3) of a lane."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (reg & 1), 4 * t + byte + 16 * (reg >> 1)


def b_element(lane: int, reg: int, byte: int) -> tuple:
    """(k, n) of byte `byte` of B register `reg` (b0, b1) of a lane."""
    g, t = lane >> 2, lane & 3
    return 4 * t + byte + 16 * reg, g


def c_element(lane: int, reg: int) -> tuple:
    """(row, n) of C register `reg` (c0..c3) of a lane."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (reg >> 1), 2 * t + (reg & 1)


def mma(a: dict, b: dict) -> dict:
    """d = A B + 0 over one m16n8k32 u8 tile, from and to the 32 lanes'
    fragments: a[lane] four words, b[lane] two words; each element of A and
    B is set by exactly one lane."""
    A = np.full((16, 32), -1, dtype=np.int64)
    B = np.full((32, 8), -1, dtype=np.int64)
    for lane in range(32):
        for reg in range(4):
            for byte in range(4):
                at = a_element(lane, reg, byte)
                assert A[at] == -1
                A[at] = (a[lane][reg] >> (8 * byte)) & 0xFF
        for reg in range(2):
            for byte in range(4):
                at = b_element(lane, reg, byte)
                assert B[at] == -1
                B[at] = (b[lane][reg] >> (8 * byte)) & 0xFF
    assert (A >= 0).all() and (B >= 0).all()
    D = A @ B
    assert D.max() < 1 << 31   # s32, exact
    return {lane: [int(D[c_element(lane, reg)]) for reg in range(4)]
            for lane in range(32)}


# ---- the kernel, as csrc/poseidon_gl_mxu.cuh writes it -------------------
# v[lane][m][c] = lane 3t + c of state g + 8m of the warp.

def pack3(x0: int, x1: int, x2: int, p: int) -> int:
    """mxu::pack3: byte p of three lanes in bytes 0..2, byte 3 = byte 0."""
    b = [(x >> (8 * p)) & 0xFF for x in (x0, x1, x2)]
    return b[0] | b[1] << 8 | b[2] << 16 | b[0] << 24


def byte_perm(x: int, y: int, sel: int) -> int:
    """__byte_perm: byte n of the result is byte (sel >> 4n) & 7 of y:x."""
    xy = x | y << 32
    return sum(((xy >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def b_fragments(table: np.ndarray) -> dict:
    """Each lane's b0 of n8 tiles 0 and 1 from the (32, 16) operand, as
    the kernel reads MXU_B; the kernel passes b1 = 0, which the table's
    zero rows 16..31 make exact."""
    out = {}
    for lane in range(32):
        words = []
        for nt in range(2):
            b = [sum(int(table[k, 8 * nt + n]) << (8 * byte)
                     for byte in range(4)
                     for k, n in [b_element(lane, reg, byte)]) for reg in (0, 1)]
            assert b[1] == 0
            words.append(b[0])
        out[lane] = words
    return out


def plane_products(v: dict, b: dict, p: int) -> dict:
    """R_p of every value a lane holds: got[lane][m][c] = (M plane_p)_(3t+c)
    of state g + 8m, from 2 m16 tiles x 2 n8 tiles of MMAs."""
    got = {lane: [[None] * 3 for _ in range(4)] for lane in range(32)}
    for mt in range(2):
        a = {lane: [pack3(*v[lane][2 * mt], p), pack3(*v[lane][2 * mt + 1], p),
                    0, 0] for lane in range(32)}
        d0 = mma(a, {lane: [b[lane][0], 0] for lane in range(32)})
        d1 = mma(a, {lane: [b[lane][1], 0] for lane in range(32)})
        for lane in range(32):
            rows = [[d0[lane][0], d0[lane][1], d1[lane][0]],
                    [d0[lane][2], d0[lane][3], d1[lane][2]]]
            for row in range(2):
                got[lane][2 * mt + row] = rows[row]
    return got


def mxu_pairs(v: dict, b: dict) -> list:
    """Mode mxu's carry-free pairs G_q = R_2q + R_2q+1 2^8 of every value a
    lane holds, from the eight planes' products."""
    R = [plane_products(v, b, p) for p in range(8)]
    return [{lane: [[R[2 * q][lane][m][c] + (R[2 * q + 1][lane][m][c] << 8)
                     for c in range(3)] for m in range(4)]
             for lane in range(32)} for q in range(4)]


# ---- mode mxu24, as csrc/poseidon_gl_mxu24.cuh writes it -----------------

def pack_pair(x0: int, x1: int, x2: int, h: int, q: int) -> tuple:
    """mxu24::pack_pair: planes 4h + 2q and 4h + 2q + 1 of three lanes,
    each in bytes 0..2 of a word, by the kernel's three byte permutes."""
    w = [(x >> (32 * h)) & EPS for x in (x0, x1, x2)]
    e = 2 * q
    b01 = byte_perm(w[0], w[1], e | (4 + e) << 4 | (e + 1) << 8
                    | (5 + e) << 12)
    return (byte_perm(b01, w[2], 0x10 | (4 + e) << 8),
            byte_perm(b01, w[2], 0x32 | (5 + e) << 8))


def b24_fragments(table: np.ndarray) -> dict:
    """Each lane's [b0, b1] of n8 tiles 0..2 from the (32, 24) operand, as
    the kernel reads MXU24_B."""
    return {lane: [[sum(int(table[k, 8 * c + n]) << (8 * byte)
                        for byte in range(4)
                        for k, n in [b_element(lane, reg, byte)])
                    for reg in (0, 1)] for c in range(3)]
            for lane in range(32)}


def pair_products(v: dict, b: dict, h: int, q: int) -> dict:
    """G_2h+q of every value a lane holds, formed from the C words of
    2 m16 tiles x 3 n8 tiles of MMAs on the pair's 4-word A fragment:
    got[lane][m][c] for lane 3t + c of state g + 8m."""
    got = {lane: [[None] * 3 for _ in range(4)] for lane in range(32)}
    for mt in range(2):
        a = {}
        for lane in range(32):
            (e0, o0), (e1, o1) = (pack_pair(*v[lane][2 * mt + row], h, q)
                                  for row in range(2))
            a[lane] = [e0, e1, o0, o1]
        for c in range(3):
            d = mma(a, {lane: b[lane][c] for lane in range(32)})
            for lane in range(32):
                for row in range(2):
                    even, odd = d[lane][2 * row], d[lane][2 * row + 1]
                    assert even < 1 << 17 and odd < 1 << 17
                    got[lane][2 * mt + row][c] = even + (odd << 8)
    return got


def mxu24_pairs(v: dict, b: dict) -> list:
    return [pair_products(v, b, q // 2, q % 2) for q in range(4)]


# ---- what the two modes share --------------------------------------------

MODES = {"mxu": (0, b_fragments, mxu_pairs),
         "mxu24": (1, b24_fragments, mxu24_pairs)}


def recombine(k: int, lo: int, hi: int) -> int:
    """mxu::recombine: k + lo + hi 2^32 as three words (< 2^74), reduced."""
    assert lo < 1 << 42 and hi < 1 << 42
    total = k + lo + (hi << 32)
    assert total < 1 << 74
    return reduce96(total)


def full_mds(v: dict, b: dict, fold_r, mode: str = "mxu") -> dict:
    """The full round after the S-boxes (mxu::full_round, mxu24::Fragments
    ::full_round): the byte-plane products paired carry-free, joined in two
    64-bit halves, each output lane recombined with its FOLD constant and
    reduced once."""
    pairs = MODES[mode][2](v, b)
    out = {}
    for lane in range(32):
        t = lane & 3
        out[lane] = [[None] * 3 for _ in range(4)]
        for m in range(4):
            for c in range(3):
                pair = [pairs[q][lane][m][c] for q in range(4)]
                assert all(x < 1 << 25 for x in pair)
                half = [pair[0] + (pair[1] << 16), pair[2] + (pair[3] << 16)]
                out[lane][m][c] = recombine(int(fold_r[3 * t + c]), *half)
    return out


def to_rows(v: dict) -> list:
    """mxu::to_rows through the warp's (32, 12) tile: row L = state L."""
    tile = [None] * (32 * W)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for m in range(4):
            for c in range(3):
                at = (g + 8 * m) * W + 3 * t + c
                assert tile[at] is None
                tile[at] = v[lane][m][c]
    assert None not in tile
    return [tile[lane * W:(lane + 1) * W] for lane in range(32)]


def to_fragments(rows: list) -> dict:
    """mxu::to_fragments, the way back."""
    tile = [x for row in rows for x in row]
    return {lane: [[tile[((lane >> 2) + 8 * m) * W + 3 * (lane & 3) + c]
                    for c in range(3)] for m in range(4)]
            for lane in range(32)}


def fragments_of(states) -> dict:
    """The warp's 32 states as the kernel loads them (fragment layout)."""
    return {lane: [[int(states[(lane >> 2) + 8 * m][3 * (lane & 3) + c])
                    for c in range(3)] for m in range(4)]
            for lane in range(32)}


def model_permute(states: np.ndarray, mode: str) -> np.ndarray:
    """mxu::permute_kernel with the mode's fragments on a batch of any
    height: warps of 32 states, the ragged last one padded with zero states
    that are never stored."""
    C, M = pg.tables_host(pc.source())
    rc0, fold = poseidon_cuda.fold_constants(C, M)
    sp = poseidon_cuda.sparse_constants(M)
    operand, fragments, _ = MODES[mode]
    b = fragments(poseidon_cuda.mma_operands(compiled_mds())[operand])
    m00 = int(compiled_mds()[0, 0])
    n = len(states)
    out = np.zeros_like(states)
    for base in range(0, n, 32):
        warp = [states[i] if i < n else np.zeros(W, np.uint64)
                for i in range(base, base + 32)]
        v = fragments_of(warp)
        v = {lane: [[add_lazy(x, int(rc0[3 * (lane & 3) + c]))
                     for c, x in enumerate(row)] for row in v[lane]]
             for lane in range(32)}
        r = 0
        while r < pc.N_ROUNDS:
            v = {lane: [[sbox(x) for x in row] for row in v[lane]]
                 for lane in range(32)}
            v = full_mds(v, b, fold[r], mode)
            r += 1
            if r == HALF:
                rows = [sparse_rounds(s, fold, *sp, m00) for s in to_rows(v)]
                v = to_fragments(rows)
                r += N_P
        rows = to_rows(v)
        for i in range(base, min(base + 32, n)):
            out[i] = [x - P if x >= P else x for x in rows[i - base]]
    return out


# ---- the tests ----------------------------------------------------------

def test_fragment_maps_hand_each_output_to_its_holder():
    """(a) With the operand's k-slot and column permutation, every C
    element of both n8 tiles is an output lane of the row's state that the
    receiving lane holds in A (the next round's operand), every held value
    gets exactly one, and the unused columns are zero."""
    mxu, _ = poseidon_cuda.mma_operands(compiled_mds())
    for nt in range(2):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for reg in range(4):
                row, n = c_element(lane, reg)
                out_lane = poseidon_cuda.MXU_N_LANE[8 * nt + n]
                if out_lane is None:
                    assert not mxu[:, 8 * nt + n].any()
                    continue
                assert row in (g, g + 8)             # a state the lane holds
                assert out_lane // 3 == t             # a lane it holds
                assert (nt, reg, out_lane % 3) in {(0, 0, 0), (0, 1, 1),
                                                   (0, 2, 0), (0, 3, 1),
                                                   (1, 0, 2), (1, 2, 2)}
    # A: the lane's bytes at k-slots 4t..4t+2 are its input lanes 3t..3t+2
    for lane in range(32):
        t = lane & 3
        for reg in (0, 1):
            for byte in range(3):
                _, k = a_element(lane, reg, byte)
                assert poseidon_cuda.MXU_K_LANE[k] == 3 * t + byte
    # the k-slots the kernel leaves as garbage or zero meet zero rows
    unused = [k for k, i in enumerate(poseidon_cuda.MXU_K_LANE) if i is None]
    assert len(unused) == 20 and not mxu[unused].any()


def test_mxu24_fragment_maps_hand_each_output_to_its_holder():
    """(a) mxu24: every C element of the three n8 tiles is both planes of
    one output lane of a state the receiving lane holds (tile c: lane
    3t + c, c0 and c2 the even plane, c1 and c3 the odd), every held
    value's pair comes from one tile; A's four words carry the lane's input
    lanes 3t..3t+2 of the even plane (a0, a1) and the odd plane (a2, a3);
    B is zero across plane parities and on the unused k-slots."""
    _, mxu24 = poseidon_cuda.mma_operands(compiled_mds())
    for c in range(3):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for reg in range(4):
                row, n = c_element(lane, reg)
                assert row in (g, g + 8)
                assert poseidon_cuda.MXU24_N_LANE[8 * c + n] == (3 * t + c,
                                                                 reg & 1)
    for lane in range(32):
        t = lane & 3
        for reg in range(4):
            for byte in range(3):
                _, k = a_element(lane, reg, byte)
                assert poseidon_cuda.MXU24_K_LANE[k] == (3 * t + byte,
                                                         reg >> 1)
    unused = [k for k, i in enumerate(poseidon_cuda.MXU24_K_LANE) if i is None]
    assert len(unused) == 8 and not mxu24[unused].any()
    for k, kl in enumerate(poseidon_cuda.MXU24_K_LANE):
        for n, (_, e) in enumerate(poseidon_cuda.MXU24_N_LANE):
            if kl is not None and kl[1] != e:
                assert mxu24[k, n] == 0


def test_mxu24_pack_pair_puts_each_plane_on_its_slots():
    """mxu24::pack_pair's byte permutes: bytes 0..2 of the even and odd
    words are planes 4h + 2q and 4h + 2q + 1 of the three lanes, byte 3 the
    first lane's even plane."""
    xs = [int(x) for x in np.random.default_rng(23).integers(
        0, 1 << 64, 3, dtype=np.uint64)]
    for h in range(2):
        for q in range(2):
            even, odd = pack_pair(*xs, h, q)
            for word, p in ((even, 4 * h + 2 * q), (odd, 4 * h + 2 * q + 1)):
                want = [(x >> (8 * p)) & 0xFF for x in xs]
                want.append((xs[0] >> (8 * (4 * h + 2 * q))) & 0xFF)
                assert [(word >> (8 * i)) & 0xFF for i in range(4)] == want


@pytest.mark.parametrize("mode", ["mxu", "mxu24"])
@pytest.mark.parametrize("kind", ["random", "edges", "non_canonical"])
def test_plane_products_and_recombination(kind, mode):
    """(b) The byte-plane MMAs and the recombination with FOLD equal
    M s + fold mod p for the 32 states of a warp, every s32 below 2^31,
    every product sum below 2^17, every carry-free pair below 2^25 and
    every 3-word sum below 2^74."""
    states = model_states(kind, 32)
    C, M = pg.tables_host(pc.source())
    _, fold = poseidon_cuda.fold_constants(C, M)
    m = compiled_mds()
    operand, fragments, _ = MODES[mode]
    b = fragments(poseidon_cuda.mma_operands(m)[operand])
    v = fragments_of(states)
    got = to_rows(full_mds(v, b, fold[0], mode))
    for i, s in enumerate(states):
        want = [(sum(int(m[o, j]) * int(s[j]) for j in range(W))
                 + int(fold[0, o])) % P for o in range(W)]
        assert all(x < 1 << 64 for x in got[i])
        assert [x % P for x in got[i]] == want


def test_layout_changes_round_trip():
    """(c) fragment layout -> one state per lane -> fragment layout."""
    states = np.random.default_rng(21).integers(0, 1 << 64, (32, W),
                                                dtype=np.uint64)
    v = fragments_of(states)
    rows = to_rows(v)
    assert rows == [[int(x) for x in s] for s in states]
    assert to_fragments(rows) == v


@pytest.mark.parametrize("kind,n", [("random", 37), ("edges", 32),
                                    ("non_canonical", 33)])
def test_mxu_model_matches_jax(kind, n):
    """(d) The whole schedule, ragged warps included, bit for bit."""
    states = model_states(kind, n)
    np.testing.assert_array_equal(model_permute(states, "mxu"),
                                  _jax_permute(states))


@pytest.mark.parametrize("kind,n", [("random", 37), ("edges", 32),
                                    ("non_canonical", 33)])
def test_mxu24_model_matches_jax(kind, n):
    """(d) mxu24's whole schedule, ragged warps included, bit for bit."""
    states = model_states(kind, n)
    np.testing.assert_array_equal(model_permute(states, "mxu24"),
                                  _jax_permute(states))

