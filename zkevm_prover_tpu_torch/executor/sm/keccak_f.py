"""KeccakF SM — bit-sliced keccak-f[1600] over packed instances.

Reference: src/sm/keccak_f/keccak_f_executor.cpp — replays the gate script
over 44-instance packed values stored as 4×11-bit limb commit pols
(setPol/getPol at keccak_f_executor.cpp:228-247), with the PIL enforcing
per-limb gate semantics via plookup into XOR/ANDP tables and the wire
graph via PLONK connection constants (the ConnectionKKGen sigmas).

This SM keeps that architecture — it is the density winner (one gate row
advances `pack` instances at once) — with both axes parameterized:

  pack        instances packed per element   (reference: 44)
  limb_bits   bits per committed limb        (reference: 11)

so the gate-semantics table (2·2^(2·limb_bits) rows) and the slot size
(~6.4k gates/round) can shrink to test domains (reduced-round circuits
from keccak_circuit.build(rounds)).

Port of `zkevm_prover_tpu/executor/sm/keccak_f.py`: the same AIR, sigmas
and trace. The host work is vectorized with numpy (and the identity tags'
powers of w with the port's field ops), where the JAX package loops over
rows and slots in Python: at production domains (2^21 - 2^23 rows) those
loops take tens of seconds.

Committed columns: a/b/c limbs (3·m, m = ceil(pack/limb_bits)). The wire
graph is enforced with ONE connection argument over the composed a, b, c
values; gate semantics with m plookups of (op, a_j, b_j, c_j); the
all-ones constant row is pinned by a selector constant.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import goldilocks as gl
from ...stark import expr as ex
from ...stark.air import AIR
from . import keccak_circuit as kc

P = gl.P


def _limbs(pack: int, limb_bits: int) -> int:
    return -(-pack // limb_bits)


def _id_tags(n_bits: int):
    """PLONK identity tags: position (col, row) -> k_col · w^row."""
    n = 1 << n_bits
    dom = torch.ones(n, dtype=torch.int64)
    step, size = gl.w(n_bits), 1
    while size < n:   # dom[size:2 size] = dom[:size] · w^size
        dom[size:2 * size] = gl.mul(dom[:size], gl.const(step, "cpu"))
        step, size = step * step % P, 2 * size
    ks = [1, gl.shift(), gl.shift() * gl.shift() % P]
    return gl.to_u64(dom), ks


def _net_cycles(circ: kc.Circuit) -> np.ndarray:
    """The copy-constraint cycle of one slot (cached on the circuit): next
    position (col · slot + row) of each position's net, its members in
    ascending order and the last back to the first; a position alone in
    its net maps to itself."""
    cyc = circ.__dict__.get("_net_cycles")
    if cyc is not None:
        return cyc
    slot = circ.n_rows
    # union-find over one slot's positions: idx = col * slot + row
    parent = list(range(3 * slot))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(x, y):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[rx] = ry

    def pidx(pos):
        col, row = pos
        return col * slot + row

    for r in range(slot):
        asrc = circ.a_src[r]
        if not (asrc[0] == kc.A and asrc[1] == r):  # not an input slot
            union(pidx((kc.A, r)), pidx(asrc))
        union(pidx((kc.B, r)), pidx(circ.b_src[r]))

    roots = np.array([find(x) for x in range(3 * slot)], dtype=np.int64)
    members = np.argsort(roots, kind="stable")   # nets, members ascending
    r = roots[members]
    first = np.r_[True, r[1:] != r[:-1]]
    last = np.r_[r[1:] != r[:-1], True]
    start = np.maximum.accumulate(np.where(first, np.arange(len(r)), 0))
    following = np.where(last, members[start], np.roll(members, -1))
    cyc = np.empty(3 * slot, dtype=np.int64)
    cyc[members] = following
    circ.__dict__["_net_cycles"] = cyc
    return cyc


def build_sigmas(circ: kc.Circuit, n_bits: int):
    """Copy-constraint sigma constants (Sa, Sb, Sc) for the tiled circuit.

    Reference: the ConnectionKk constant pols generated by keccak_gen. Nets
    are the wire equivalence classes; each net's positions form one cycle.
    """
    n = 1 << n_bits
    slot = circ.n_rows
    n_slots = n // slot

    dom, ks = _id_tags(n_bits)
    # identity everywhere (covers padding rows), then rotate each net cycle
    ident = np.stack([gl.to_u64(gl.mul(gl.from_u64(dom, "cpu"),
                                       gl.const(int(k), "cpu")))
                      for k in ks])
    sig = ident.copy()
    if n_slots:
        cyc = _net_cycles(circ)
        col_m, row_m = np.divmod(np.arange(3 * slot), slot)
        col_n, row_n = np.divmod(cyc, slot)
        off = (np.arange(n_slots) * slot)[:, None]
        sig[col_m, row_m + off] = ident[col_n, row_n + off]
    return [sig[col] for col in range(3)]


def _gate_table(limb_bits: int, table_ops=(kc.XOR, kc.ANDP)) -> np.ndarray:
    """(4^limb_bits · len(table_ops), 4) uint64 rows (op, x, y, gate(x, y)),
    x-major, then y, then op."""
    mask = np.uint64((1 << limb_bits) - 1)
    side = 1 << limb_bits
    n_ops = len(table_ops)
    idx = np.arange(side * side * n_ops, dtype=np.uint64)
    op = np.array(table_ops, dtype=np.uint64)[idx % np.uint64(n_ops)]
    xy = idx // np.uint64(n_ops)
    x, y = xy >> np.uint64(limb_bits), xy & mask
    c = np.where(op == kc.XOR, x ^ y,
                 np.where(op == kc.ANDP, (x ^ mask) & y, x & y))
    return np.stack([op, x, y, c], axis=1)


def build_air(n_bits: int, circ: kc.Circuit, pack: int,
              limb_bits: int, table_ops=(kc.XOR, kc.ANDP),
              name: str = "keccak_f") -> AIR:
    n = 1 << n_bits
    m = _limbs(pack, limb_bits)
    slot = circ.n_rows
    assert slot <= n, f"slot ({slot}) exceeds domain ({n})"
    n_slots = n // slot
    mask = (1 << pack) - 1

    air = AIR(name, n_bits)
    a_l = air.committed(*[f"A{j}" for j in range(m)])
    b_l = air.committed(*[f"B{j}" for j in range(m)])
    c_l = air.committed(*[f"C{j}" for j in range(m)])
    if m == 1:
        a_l, b_l, c_l = (a_l,), (b_l,), (c_l,)

    # gate op per row, tiled per slot (padding rows read as XOR)
    opvals = np.zeros(n, dtype=np.uint64)
    opvals[:n_slots * slot] = np.tile(circ.ops, n_slots)
    OP = air.constant("OP", opvals)

    # the all-ones pin on each slot's row 0
    fo = np.zeros(n, dtype=np.uint64)
    fo[np.arange(n_slots) * slot] = 1
    FIRSTONE = air.constant("FIRSTONE", fo)

    def composed(limbs):
        acc = ex.Number(0)
        for j, h in enumerate(limbs):
            acc = acc + h * (1 << (j * limb_bits))
        return acc

    a_e, b_e, c_e = composed(a_l), composed(b_l), composed(c_l)
    air.require_zero(FIRSTONE * (a_e - mask))

    # gate semantics, limb-sliced
    tab = _gate_table(limb_bits, table_ops)
    assert len(tab) <= n, f"gate table ({len(tab)}) exceeds domain"
    tcols = [air.constant(nm, np.resize(tab[:, k], n))
             for k, nm in enumerate(("TOP", "TA", "TB", "TC"))]
    for j in range(m):
        air.lookup([OP, a_l[j], b_l[j], c_l[j]], list(tcols))

    # wire graph: one PLONK connection over the composed values
    sig = build_sigmas(circ, n_bits)
    sa = air.constant("Sa", sig[0])
    sb = air.constant("Sb", sig[1])
    sc = air.constant("Sc", sig[2])
    air.connection([a_e, b_e, c_e], [sa, sb, sc])

    # -- packing interface (the Bits2Field binding surface) ---------------
    # Constant selectors exposing where each slot's packed input / output
    # elements live, so the combined AIR can bind them to the Bits2Field
    # accumulators (reference: bits2field_executor.cpp:7-44 feeds field[i]
    # straight into KeccakF's pol a at the input rows; outputs are read
    # back the same way). All output wires are C positions of distinct
    # gate rows (keccak_circuit.build emits one final gate per state bit).
    slotid = np.zeros(n, dtype=np.uint64)
    insel = np.zeros(n, dtype=np.uint64)
    inpos = np.zeros(n, dtype=np.uint64)
    outsel = np.zeros(n, dtype=np.uint64)
    outpos = np.zeros(n, dtype=np.uint64)
    out_rows = set()
    for p, (ocol, orow) in enumerate(circ.outputs):
        assert ocol == kc.C and orow not in out_rows, \
            "output wires must be distinct C positions"
        out_rows.add(orow)
    off = (np.arange(n_slots) * slot)[:, None]
    slotid[:n_slots * slot] = np.repeat(np.arange(n_slots), slot)
    in_rows = np.array(circ.inputs, dtype=np.int64)
    insel[off + in_rows] = 1
    inpos[off + in_rows] = np.arange(len(in_rows))
    out_rows = np.array([r for _, r in circ.outputs], dtype=np.int64)
    outsel[off + out_rows] = 1
    outpos[off + out_rows] = np.arange(len(out_rows))
    air.constant("SLOTID", slotid)
    air.constant("INSEL", insel)
    air.constant("INPOS", inpos)
    air.constant("OUTSEL", outsel)
    air.constant("OUTPOS", outpos)
    return air


def execute(actions: list[dict], n_bits: int, circ: kc.Circuit, pack: int,
            limb_bits: int) -> np.ndarray:
    """actions: [{state: (25,) uint64 lanes}] — one keccak-f input each.

    Instances are packed `pack` per slot; returns the (N, 3m) limb trace.
    """
    states = np.array([a["state"] for a in actions], dtype=np.uint64) \
        if actions else np.zeros((0, 25), dtype=np.uint64)
    return _trace(states, n_bits, circ, pack, limb_bits)


def _trace(states: np.ndarray, n_bits: int, circ: kc.Circuit, pack: int,
           limb_bits: int) -> np.ndarray:
    """The (N, 3m) limb trace of `states` packed into the slots (every
    slot evaluated, the unused ones on zero inputs)."""
    n = 1 << n_bits
    m = _limbs(pack, limb_bits)
    slot = circ.n_rows
    n_slots = n // slot
    tr = np.zeros((n, 3 * m), dtype=np.uint64)
    assert len(states) <= pack * n_slots, "too many keccak instances"
    if n_slots == 0:
        return tr
    vals = kc.wire_values_slots(circ, states, pack, n_slots)
    shifts = np.arange(m, dtype=np.uint64) * np.uint64(limb_bits)
    limbs = (vals[..., None] >> shifts) & np.uint64((1 << limb_bits) - 1)
    # (row, col, slot, limb) -> (slot, row, col, limb)
    tr[:n_slots * slot] = limbs.transpose(2, 0, 1, 3).reshape(
        n_slots * slot, 3 * m)
    return tr


def digests(circ: kc.Circuit, actions: list[dict], pack: int) -> np.ndarray:
    """Oracle: the circuit outputs, unpacked back to (k, 25) lanes."""
    states = np.array([a["state"] for a in actions], dtype=np.uint64)
    out = []
    for s in range(0, len(states), pack):
        out.append(kc.evaluate(circ, states[s:s + pack], pack))
    return np.concatenate(out) if out else np.zeros((0, 25), np.uint64)
