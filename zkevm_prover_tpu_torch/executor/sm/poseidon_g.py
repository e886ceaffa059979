"""PoseidonG SM — witness rows for Poseidon-GL permutations.

Port of `zkevm_prover_tpu/executor/sm/poseidon_g.py` (host-only): the same
AIR and trace, with the constant columns filled by numpy and the witness
computed for all permutations at once instead of one Python loop each.

Reference: src/sm/poseidon_g/ (witness rows for every Poseidon permutation
requested by Storage/PaddingPG, executor.cpp:600-603). One permutation
occupies a 32-row group: rows 0..29 hold the state entering round r, row 30
the final state, row 31 padding. The x^7 S-box is degree-reduced by
committing the cube and the S-box output per lane, keeping the max
constraint degree at 4:

  committed  S_0..11  state entering the row's round
             T_0..11  (S_j + C_j)^3            (cube witness)
             SB_0..11 S-box/bypass output feeding the MDS
  constant   CC_0..11 round constants by row, ACT (row%32 < 30),
             FULL (full-round rows), CLK0 (group starts)

  ACT·(T_j − (S_j+CC_j)^3) = 0
  ACT·( FULL_j·(SB_j − T_j²·(S_j+CC_j)) + (1−FULL_j)·(SB_j − (S_j+CC_j)) ) = 0
      (lane 0 is always S-boxed: FULL_0 covers partial rounds too)
  ACT·( S'_i − Σ_j M_ij·SB_j ) = 0        (MDS transition; M is the
                                            power-of-two circulant)

All-zero padding groups satisfy every gated constraint.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import goldilocks as gl
from ...ops import poseidon_constants as pc
from ...ops import poseidon_gl as pos
from ...ops import refmodel as rm
from ...stark import expr as ex
from ...stark.air import AIR

W = pc.WIDTH          # 12
GROUP = 32
ROUNDS = pc.N_ROUNDS  # 30
P = rm.P


def _full_round(r: int) -> bool:
    half = pc.ROUNDS_F // 2
    return r < half or r >= half + pc.ROUNDS_P


def add_permutation_constraints(air: AIR, s, t, sb, n: int):
    """The round identities shared with PaddingPG (which chains groups)."""
    C = pc.round_constants()
    M = pc.mds_matrix()

    # constant columns, vectorized over rows (row r of each 32-row group
    # carries round r's constants)
    r = np.arange(n) % GROUP
    active = r < ROUNDS
    C_tab = np.array(C, dtype=np.uint64).reshape(ROUNDS, W)
    cc = []
    for j in range(W):
        col = np.zeros(n, dtype=np.uint64)
        col[active] = C_tab[r[active], j]
        cc.append(air.constant(f"CC{j}", col))

    full_r = np.array([_full_round(k) for k in range(GROUP)])
    act = active.astype(np.uint64)
    full = (active & full_r[r]).astype(np.uint64)
    ACT = air.constant("ACT", act)
    FULL = air.constant("FULL", full)

    for j in range(W):
        x = s[j] + cc[j]
        air.require_zero(ACT * (t[j] - x * x * x))
        sboxed = t[j] * t[j] * x
        if j == 0:
            air.require_zero(ACT * (sb[j] - sboxed))
        else:
            # FULL ⊆ ACT, so ACT−FULL selects active partial-round rows;
            # written this way the constraint stays degree 4
            air.require_zero(
                FULL * (sb[j] - sboxed) + (ACT - FULL) * (sb[j] - x)
            )

    for i in range(W):
        acc = None
        for j in range(W):
            term = sb[j] * int(M[i][j])
            acc = term if acc is None else acc + term
        air.require_zero(ACT * (ex.Cm(s[i].id, True) - acc))
    return ACT, FULL


def build_air(n_bits: int) -> AIR:
    n = 1 << n_bits
    assert n % GROUP == 0
    air = AIR("poseidon_g", n_bits)
    s = air.committed(*[f"S{j}" for j in range(W)])
    t = air.committed(*[f"T{j}" for j in range(W)])
    sb = air.committed(*[f"SB{j}" for j in range(W)])
    add_permutation_constraints(air, s, t, sb, n)

    # interface: IN_j holds the group's input state on every row, so the
    # output row (row 30, where S is the final state) exposes the full
    # (input, hash) tuple {IN0..11, S0..3} for cross-SM lookups — the role
    # of the reference's hash0/hash1-latch readout in storage.pil
    inp = air.committed(*[f"IN{j}" for j in range(W)])
    gs = np.zeros(n, dtype=np.uint64)
    gs[::GROUP] = 1
    GS = air.constant("GS", gs)
    gout = np.zeros(n, dtype=np.uint64)
    gout[ROUNDS::GROUP] = 1
    air.constant("GOUT", gout)
    GSp = ex.Const(GS.id, True)
    for j in range(W):
        air.require_zero(GS * (inp[j] - s[j]))
        air.require_zero((1 - GSp) * (ex.Cm(inp[j].id, True) - inp[j]))
    return air


def execute(actions: list[dict], n_bits: int) -> np.ndarray:
    """actions: [{state: [12 ints]}]; 32 rows per permutation.

    Padding groups hold real permutations of the zero state — the ACT/CC
    constant columns are periodic, so every group must satisfy the round
    identities (the reference pads PoseidonG the same way). All groups run
    at once, round by round, through the port's field ops on host tensors."""
    n = 1 << n_bits
    assert len(actions) * GROUP <= n
    inputs = np.zeros((n // GROUP, W), dtype=np.uint64)
    for a_idx, act in enumerate(actions):
        st = [int(v) % P for v in act["state"]]
        assert len(st) == W
        inputs[a_idx] = st
    tr = np.zeros((n // GROUP, GROUP, 4 * W), dtype=np.uint64)
    tr[:, :, 3 * W:] = inputs[:, None, :]  # IN held through the group
    # final state row (ACT=0: no constraints)
    tr[:, ROUNDS, :W] = fill_rounds(tr, inputs)
    return tr.reshape(n, 4 * W)


def fill_rounds(tr: np.ndarray, inputs: np.ndarray) -> np.ndarray:
    """Write rows 0..29 (S, T, SB) of each (G, GROUP, >= 36) group in `tr`
    for the (G, 12) canonical input states, all groups at once, round by
    round through the port's field ops on host tensors; returns the (G, 12)
    permutation outputs."""
    C = pos.round_constants("cpu")
    st = gl.from_u64(inputs, "cpu")
    for r in range(ROUNDS):
        x = gl.add(st, C[r])
        cube = gl.mul(gl.square(x), x)
        sbox = gl.mul(gl.square(cube), x)
        out_sb = sbox if _full_round(r) else torch.cat([sbox[:, :1], x[:, 1:]], 1)
        tr[:, r, :3 * W] = gl.to_u64(torch.cat([st, cube, out_sb], 1))
        st = pos.mds(out_sb)
    return gl.to_u64(st)


def result(action: dict) -> list[int]:
    """Oracle: the permutation output (must equal ops/refmodel Poseidon)."""
    pos = rm.Poseidon(pc.round_constants(), pc.mds_matrix())
    return pos.permute([int(v) for v in action["state"]])
