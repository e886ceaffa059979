"""PaddingPG SM — Poseidon sponge linear hashes (program hashing).

Port of `zkevm_prover_tpu/executor/sm/padding_pg.py`: the same AIR and
trace, with the witness of all groups computed at once (as the port's
`poseidon_g.execute` does) and each message's digest chain batched across
messages.

Reference: src/sm/padding_pg/ (Poseidon-based linear hash padding feeding
PoseidonG, used for contract-bytecode hashing). This SM proves the
framework's `linear_hash` semantics (ops/poseidon_gl.py): chunks of 8 field
elements absorbed with the previous digest carried in the capacity.

Built on the PoseidonG permutation AIR (poseidon_g.add_permutation_
constraints) with chaining across 32-row groups:

  CONT (committed, boolean, group-constant): 1 when this group continues
  the previous group's message.
    fresh group:      CLK0·(1−CONT)·S_j = 0            for j in 8..11
    carried digest:   rows 30/31 copy the state (HOLD·(S'−S)=0 at rows
                      30,31 is gated to row 30 only; row 31 then holds the
                      final state), and at the 31→0 boundary
                      L31·CONT'·(S_j' − SB_{j-8-ish}) — concretely
                      L31·CONT'·(S'_{8+j} − S_j) = 0   for j in 0..3
  (the digest of a group is S_0..3 of its final-state row, which rows
  30→31 copy forward).

Digests are read at row 30 of each message's last group.
"""

from __future__ import annotations

import numpy as np

from ...ops import poseidon_constants as pc
from ...ops import refmodel as rm
from ...stark import expr as ex
from ...stark.air import AIR
from . import poseidon_g as pg

W = pg.W
GROUP = pg.GROUP
ROUNDS = pg.ROUNDS
RATE = 8
CAP = 4
P = rm.P


def build_air(n_bits: int) -> AIR:
    n = 1 << n_bits
    assert n % GROUP == 0
    air = AIR("padding_pg", n_bits)
    s = air.committed(*[f"S{j}" for j in range(W)])
    t = air.committed(*[f"T{j}" for j in range(W)])
    sb = air.committed(*[f"SB{j}" for j in range(W)])
    cont = air.committed("CONT")

    pg.add_permutation_constraints(air, s, t, sb, n)

    pos = np.arange(n, dtype=np.uint64) % GROUP
    CLK0 = air.constant("PCLK0", (pos == 0).astype(np.uint64))
    HOLD = air.constant("HOLD", (pos == ROUNDS).astype(np.uint64))  # row 30
    L31 = air.constant("L31", (pos == GROUP - 1).astype(np.uint64))
    air.constant("PGID", np.arange(n, dtype=np.uint64) // GROUP)
    nlast = np.ones(n, dtype=np.uint64)
    nlast[n - 1] = 0
    NL = air.constant("PNL", nlast)

    air.require_zero(cont * (cont - 1))
    # CONT group-constant
    air.require_zero(NL * (1 - L31) * (ex.Cm(cont.id, True) - cont))
    # rows 30 -> 31 copy the final state forward
    for j in range(W):
        air.require_zero(HOLD * (ex.Cm(s[j].id, True) - s[j]))
    # fresh groups start with zero capacity
    for j in range(RATE, W):
        air.require_zero(CLK0 * (1 - cont) * s[j])
    # continuing groups carry the previous digest into the capacity
    for j in range(CAP):
        air.require_zero(
            NL * L31 * ex.Cm(cont.id, True)
            * (ex.Cm(s[RATE + j].id, True) - s[j])
        )
    return air


def execute(actions: list[dict], n_bits: int) -> tuple[np.ndarray, list]:
    """actions: [{values: [field elements]}] — one linear hash each.

    Returns (trace, digests); each message occupies ceil(len/8) consecutive
    groups (min 1). Padding groups are fresh zero-chunk permutations. The
    digest chain runs chunk by chunk, each step over all messages at once.
    """
    n_groups = (1 << n_bits) // GROUP
    msgs = []
    for act in actions:
        vals = [int(v) % P for v in act["values"]]
        # the sponge branch of linear_hash; width <= 4 is a plain copy there
        assert len(vals) > 4, "PaddingPG proves sponge hashes (len > 4)"
        vals += [0] * (-len(vals) % RATE)
        msgs.append(np.array(vals, dtype=np.uint64).reshape(-1, RATE))
    counts = np.array([len(m) for m in msgs], dtype=np.int64)
    starts = np.cumsum(counts) - counts   # group of each message's chunk 0
    used = int(counts.sum())
    assert used <= n_groups, "too many chunks for domain"

    tr = np.zeros((n_groups, GROUP, 3 * W + 1), dtype=np.uint64)
    digests = np.zeros((len(msgs), CAP), dtype=np.uint64)
    for ci in range(int(counts.max(initial=0))):
        live = np.nonzero(counts > ci)[0]
        states = np.concatenate(
            [np.stack([msgs[m][ci] for m in live]), digests[live]], axis=1)
        cont = np.full(len(live), 1 if ci else 0, dtype=np.uint64)
        out = _fill_groups(tr, starts[live] + ci, states, cont)
        digests[live] = out[:, :CAP]
    pad = np.arange(used, n_groups)
    _fill_groups(tr, pad, np.zeros((len(pad), W), dtype=np.uint64),
                 np.zeros(len(pad), dtype=np.uint64))
    return (tr.reshape(n_groups * GROUP, 3 * W + 1),
            [[int(v) for v in d] for d in digests])


def execute_chunks(chunks: list[dict], n_bits: int) -> np.ndarray:
    """Combined-mode driver: lay the byte-front's per-block chunks at the
    group index equal to their block id (chunks: [{values(8),
    cont_digest(4), cont}] from padding_pg_byte.execute)."""
    n_groups = (1 << n_bits) // GROUP
    assert len(chunks) <= n_groups, "too many chunks for domain"
    states = np.zeros((n_groups, W), dtype=np.uint64)
    cont = np.zeros(n_groups, dtype=np.uint64)
    for g, c in enumerate(chunks):
        states[g] = list(c["values"]) + list(c["cont_digest"])
        cont[g] = int(c["cont"])
    tr = np.zeros((n_groups, GROUP, 3 * W + 1), dtype=np.uint64)
    _fill_groups(tr, np.arange(n_groups), states, cont)
    return tr.reshape(n_groups * GROUP, 3 * W + 1)


def _fill_groups(tr: np.ndarray, groups: np.ndarray, states: np.ndarray,
                 cont: np.ndarray) -> np.ndarray:
    """Fill the 32-row groups `groups` of the (G, GROUP, 37) trace from their
    (g, 12) input states and CONT flags; returns the permutation outputs.
    Row 30 holds the final state, row 31 its held copy."""
    sub = np.zeros((len(groups), GROUP, 3 * W + 1), dtype=np.uint64)
    out = pg.fill_rounds(sub, states)
    sub[:, ROUNDS, :W] = out
    sub[:, ROUNDS + 1, :W] = out
    sub[:, :, 3 * W] = cont[:, None]
    tr[groups] = sub
    return out


def result(action: dict) -> list[int]:
    """Oracle: must equal ops/poseidon_gl.linear_hash / refmodel."""
    pos = rm.Poseidon(pc.round_constants(), pc.mds_matrix())
    return pos.linear_hash([int(v) % P for v in action["values"]])
