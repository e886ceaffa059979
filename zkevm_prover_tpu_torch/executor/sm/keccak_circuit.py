"""Keccak-f[1600] as a gate circuit — XOR/ANDP wire graph.

Port of `zkevm_prover_tpu/executor/sm/keccak_circuit.py`: the same circuit
(ops and wiring row for row). Evaluation is vectorized: the rows are
grouped by their depth in the wire graph once per circuit (`_schedule`),
and each depth is evaluated for every slot of a trace at once with numpy,
where the JAX package walks the rows one by one over Python ints per slot;
the values are the same.

Reference: tools/sm/keccak_f/keccak.cpp + keccak_gen.cpp generate a JSON
"script" of XOR and ANDP gates (keccak-f as a 2-op circuit, ~155k gates,
slotSize 155,286 — keccak_f_executor.hpp:47-48) that the KeccakF SM
replays bit-sliced over 44 packed instances. Here the circuit is built
directly in Python (no offline JSON artifact): one wire per state bit,
gates emitted in topological row order, the rho/pi rotations free as wire
re-indexing.

Row layout of one slot (the KeccakF SM's unit):
  row 0              the ONE row: its a-position is the all-ones packed
                     constant (pinned by the SM), c = a XOR a = ZERO
  rows 1..1600       input rows: a carries state bit (x,y,z) of the packed
                     instances, b wired to ZERO, c = a (the bit's wire)
  rows 1601..        the 24-round gate sequence; the final state's 1600
                     output wires are recorded in `outputs`

`rounds` is parameterizable so tests can prove a reduced-round circuit on
a small domain (the gate count ~6.4k/round is fixed by keccak-f itself).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...ops.keccak import _RC, _ROT

XOR = 0
ANDP = 1
AND = 2   # used by the SHA-256 circuit (keccak needs only XOR/ANDP)

# wire reference: (column, row) with columns 0=a, 1=b, 2=c
A, B, C = 0, 1, 2


def gate_eval(op: int, a: int, b: int, mask: int) -> int:
    if op == XOR:
        return a ^ b
    if op == ANDP:
        return (a ^ mask) & b
    if op == AND:
        return a & b
    raise ValueError(op)


@dataclasses.dataclass
class Circuit:
    ops: np.ndarray          # (n_rows,) gate op per row
    a_src: list              # (col, row) source wire of each row's a
    b_src: list              # source wire of each row's b
    inputs: list             # rows whose a-position takes input bits
    outputs: list            # (col, row) wires of the final state
    one: tuple               # the all-ones wire position
    zero: tuple              # the all-zeros wire position
    rounds: int
    in_words: int = 25       # input layout: words × word_bits bits
    word_bits: int = 64
    out_words: int = 25

    @property
    def n_rows(self) -> int:
        return len(self.ops)


def build(rounds: int = 24) -> Circuit:
    ops: list[int] = []
    a_src: list[tuple] = []
    b_src: list[tuple] = []

    def gate(op, a, b) -> tuple:
        ops.append(op)
        a_src.append(a)
        b_src.append(b)
        return (C, len(ops) - 1)

    # row 0: a pinned to all-ones by the SM; c = a XOR a = 0
    one = (A, 0)
    zero = gate(XOR, one, one)

    # input rows: c = bit XOR 0 = bit
    inputs = []
    wires = [[None] * 64 for _ in range(25)]  # wires[x+5y][z]
    for i in range(25):
        for z in range(64):
            w = gate(XOR, (A, len(ops)), zero)  # a self-reference: input slot
            inputs.append(w[1])
            wires[i][z] = w

    def xor(a, b):
        return gate(XOR, a, b)

    def andp(a, b):
        return gate(ANDP, a, b)

    for rnd in range(rounds):
        # theta
        c = [[None] * 64 for _ in range(5)]
        for x in range(5):
            for z in range(64):
                t = xor(wires[x][z], wires[x + 5][z])
                t = xor(t, wires[x + 10][z])
                t = xor(t, wires[x + 15][z])
                c[x][z] = xor(t, wires[x + 20][z])
        d = [[None] * 64 for _ in range(5)]
        for x in range(5):
            for z in range(64):
                # D[x] = C[x-1] ^ rotl(C[x+1], 1): bit z of rotl1 = C[x+1][z-1]
                d[x][z] = xor(c[(x + 4) % 5][z], c[(x + 1) % 5][(z - 1) % 64])
        aw = [[None] * 64 for _ in range(25)]
        for x in range(5):
            for y in range(5):
                for z in range(64):
                    aw[x + 5 * y][z] = xor(wires[x + 5 * y][z], d[x][z])

        # rho + pi: pure re-wiring — bit z of B[y][2x+3y] = A[x][y] rot r
        bw = [[None] * 64 for _ in range(25)]
        for x in range(5):
            for y in range(5):
                r = int(_ROT[x + 5 * y])
                for z in range(64):
                    # rotl by r: output bit z = input bit (z - r) mod 64
                    bw[y + 5 * ((2 * x + 3 * y) % 5)][z] = \
                        aw[x + 5 * y][(z - r) % 64]

        # chi: A[x,y] = B[x,y] ^ (~B[x+1,y] & B[x+2,y])
        nw = [[None] * 64 for _ in range(25)]
        for x in range(5):
            for y in range(5):
                for z in range(64):
                    t = andp(bw[(x + 1) % 5 + 5 * y][z],
                             bw[(x + 2) % 5 + 5 * y][z])
                    nw[x + 5 * y][z] = xor(bw[x + 5 * y][z], t)
        wires = nw

        # iota: lane (0,0) ^= RC[rnd] (only the set bits cost a gate)
        rc = int(_RC[rnd])
        for z in range(64):
            if (rc >> z) & 1:
                wires[0][z] = xor(wires[0][z], one)

    outputs = [wires[i][z] for i in range(25) for z in range(64)]
    return Circuit(ops=np.array(ops, dtype=np.uint64), a_src=a_src,
                   b_src=b_src, inputs=inputs, outputs=outputs,
                   one=one, zero=zero, rounds=rounds)


def _schedule(circ: Circuit) -> dict:
    """The rows grouped by depth (cached on the circuit): a row's a and b
    wires are known once the rows they come from are evaluated, so every
    row of one depth can be evaluated together. A self-referencing a (row
    0's all-ones, the input rows) is set before any depth."""
    sched = circ.__dict__.get("_sched")
    if sched is not None:
        return sched
    n = circ.n_rows
    a_col = np.array([c for c, _ in circ.a_src], dtype=np.int64)
    a_row = np.array([r for _, r in circ.a_src], dtype=np.int64)
    b_col = np.array([c for c, _ in circ.b_src], dtype=np.int64)
    b_row = np.array([r for _, r in circ.b_src], dtype=np.int64)
    self_a = (a_col == A) & (a_row == np.arange(n))
    # a row's depth is one more than its sources' rows' (row 0 reads its
    # own a twice)
    level = [0] * n
    sa, ar, br = self_a.tolist(), a_row.tolist(), b_row.tolist()
    for r in range(n):
        level[r] = 1 + max(0 if sa[r] else level[ar[r]], level[br[r]])
    level = np.array(level, dtype=np.int64)
    order = np.argsort(level, kind="stable")
    bounds = np.searchsorted(level[order], np.arange(1, level.max() + 2))
    groups = [order[bounds[i]:bounds[i + 1]] for i in range(len(bounds) - 1)]
    sched = {"groups": groups, "self_a": self_a,
             "a_idx": a_col * n + a_row, "b_idx": b_col * n + b_row}
    circ.__dict__["_sched"] = sched
    return sched


def _pack_inputs(circ: Circuit, states: np.ndarray, n_slots: int,
                 pack: int) -> np.ndarray:
    """Bit-slice up to pack·n_slots instances: (len(inputs), n_slots), the
    element for input bit (word i, bit z) of slot s packs that bit of
    instances s·pack .. s·pack + pack - 1 into lanes 0..pack-1."""
    k = states.shape[0]
    assert k <= pack * n_slots
    st = np.zeros((n_slots * pack, circ.in_words), dtype=np.uint64)
    st[:k] = states
    z = np.arange(circ.word_bits, dtype=np.uint64)
    bits = (st[:, :, None] >> z) & np.uint64(1)     # (inst, word, bit)
    bits = bits.reshape(n_slots, pack, -1)            # (slot, lane, input)
    lanes = np.arange(pack, dtype=np.uint64)[None, :, None]
    packed = np.bitwise_or.reduce(bits << lanes, axis=1)
    return packed.T.copy()


def wire_values_slots(circ: Circuit, states: np.ndarray, pack: int,
                      n_slots: int) -> np.ndarray:
    """Packed wire assignment of n_slots slots, (n_rows, 3, n_slots)
    uint64: slot s packs instances s·pack .. s·pack + pack - 1 of
    `states` ((k, in_words) word arrays, k <= pack·n_slots; the rest zero)."""
    n = circ.n_rows
    sched = _schedule(circ)
    mask = np.uint64((1 << pack) - 1)
    vals = np.zeros((3 * n, n_slots), dtype=np.uint64)   # row col * n + r
    vals[A * n] = mask
    vals[A * n + np.array(circ.inputs)] = _pack_inputs(circ, states,
                                                       n_slots, pack)
    ops = circ.ops
    for rows in sched["groups"]:
        live = rows[~sched["self_a"][rows]]
        vals[A * n + live] = vals[sched["a_idx"][live]]
        vals[B * n + rows] = vals[sched["b_idx"][rows]]
        a, b = vals[A * n + rows], vals[B * n + rows]
        op = ops[rows][:, None]
        vals[C * n + rows] = np.where(
            op == XOR, a ^ b, np.where(op == ANDP, (a ^ mask) & b, a & b))
    return vals.reshape(3, n, n_slots).transpose(1, 0, 2)


def wire_values(circ: Circuit, states: np.ndarray, pack: int) -> np.ndarray:
    """Full (n_rows, 3) packed wire assignment — the SM trace payload.

    states: (k, in_words) word arrays, k <= pack.
    """
    return wire_values_slots(circ, states, pack, 1)[:, :, 0]


def evaluate(circ: Circuit, states: np.ndarray, pack: int) -> np.ndarray:
    """Run the circuit on bit-sliced instances, `pack` per slot.

    states: (k, in_words) word arrays. Returns (k, out_words) outputs.
    Used by the SM's digests() and as the oracle for tests.
    """
    k = states.shape[0]
    n_slots = max(-(-k // pack), 1)
    vals = wire_values_slots(circ, states, pack, n_slots)
    cols = np.array([c for c, _ in circ.outputs])
    rows = np.array([r for _, r in circ.outputs])
    v = vals[rows, cols]                                 # (out bits, slot)
    lanes = np.arange(pack, dtype=np.uint64)
    bits = (v[:, :, None] >> lanes) & np.uint64(1)       # (bit, slot, lane)
    bits = bits.reshape(circ.out_words, circ.word_bits, -1)
    z = np.arange(circ.word_bits, dtype=np.uint64)[None, :, None]
    out = np.bitwise_or.reduce(bits << z, axis=1)        # (word, instance)
    return out.T[:k].copy()
