"""Mode mxu's kernel (csrc/poseidon_gl_mxu.cuh), modelled on the CPU before
the card sees it: the m16n8k32 u8 fragment maps of the PTX ISA with the
kernel's k-slot and column permutation (`poseidon_cuda.mma_operands`), the
byte-plane products and their recombination with the FOLD constants, the
two layout changes through the warp's shared tile, and the whole schedule
(full rounds in fragment layout, the sparse partial rounds one state per
lane), held against JAX `poseidon_gl.permute` bit for bit with a range
assert on every intermediate. Tolerance 0 throughout: the results are exact
integers. The operand itself is held against the JAX package's I_8 (x) M
in test_torch_poseidon_modes.py (test_mxu_operand_matches_jax)."""

import numpy as np
import pytest

from test_torch_poseidon_tables import (P, _jax_permute, add_lazy,
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


def recombine(k: int, lo: int, hi: int) -> int:
    """mxu::recombine: k + lo + hi 2^32 as three words (< 2^74), reduced."""
    assert lo < 1 << 42 and hi < 1 << 42
    total = k + lo + (hi << 32)
    assert total < 1 << 74
    return reduce96(total)


def full_mds(v: dict, b: dict, fold_r) -> dict:
    """mxu::full_round after the S-boxes: the byte-plane products paired
    carry-free, joined in two 64-bit halves, each output lane recombined
    with its FOLD constant and reduced once."""
    R = [plane_products(v, b, p) for p in range(8)]
    out = {}
    for lane in range(32):
        t = lane & 3
        out[lane] = [[None] * 3 for _ in range(4)]
        for m in range(4):
            for c in range(3):
                pair = [R[2 * q][lane][m][c] + (R[2 * q + 1][lane][m][c] << 8)
                        for q in range(4)]
                assert all(x < 1 << 26 for x in pair)
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


def model_permute_mxu(states: np.ndarray) -> np.ndarray:
    """mxu::permute_kernel on a batch of any height: warps of 32 states,
    the ragged last one padded with zero states that are never stored."""
    C, M = pg.tables_host(pc.source())
    rc0, fold = poseidon_cuda.fold_constants(C, M)
    sp = poseidon_cuda.sparse_constants(M)
    b = b_fragments(poseidon_cuda.mma_operands(compiled_mds())[0])
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
            v = full_mds(v, b, fold[r])
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


@pytest.mark.parametrize("kind", ["random", "edges", "non_canonical"])
def test_plane_products_and_recombination(kind):
    """(b) The byte-plane MMAs and the recombination with FOLD equal
    M s + fold mod p for the 32 states of a warp, every s32 below 2^31,
    every carry-free pair below 2^26 and every 3-word sum below 2^74."""
    states = model_states(kind, 32)
    C, M = pg.tables_host(pc.source())
    _, fold = poseidon_cuda.fold_constants(C, M)
    m = compiled_mds()
    b = b_fragments(poseidon_cuda.mma_operands(m)[0])
    v = fragments_of(states)
    got = to_rows(full_mds(v, b, fold[0]))
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
    np.testing.assert_array_equal(model_permute_mxu(states),
                                  _jax_permute(states))

