"""PLONKish circuits over Goldilocks, proven by the eSTARK engine itself.

The reference compiles its STARK verifiers to circom circuits and proves
them with pil-stark's C12A AIR — a 12-wire PLONK trace with custom
Poseidon gates and copy constraints (SURVEY §3.3: c12a -> recursive1 ->
recursive2). This module is that role:

  * `GLSynth` builds a straight-line circuit over the Goldilocks base
    field: 3-wire arithmetic gates (qL·a + qR·b + qM·a·b + qO·c + qC = 0)
    packed 4 per row into 12 wire columns, witness kept in lockstep.
  * equality is FREE: `assert_eq` merges signals union-find style and the
    copy relation is enforced by ONE connection argument (PLONK sigmas)
    over all wire + hash-lane columns — the engine chunks the wide
    grand product into partial-product columns (stark/setup.py).
  * Poseidon permutations are claims on 16 hash-lane columns (IN12|OUT4)
    looked up into a PoseidonG SM instance sharing the combined AIR —
    the custom-Poseidon-gate role without degree-7 wire constraints.
  * circuit publics are pinned cells on reserved rows with per-public
    Lagrange boundary constraints (the stark verifier reads them as
    STARK publics).

`compile_air(synth, n_bits)` -> CombinedAIR {"gates", "poseidon_g"};
`fill_trace(synth, air)` -> the satisfying trace dict.

Port of `zkevm_prover_tpu/stark/gl_circuit.py`. `GLSynth` is the same
Python builder (its Poseidon claims witnessed by `refmodel.Poseidon`).
`compile_air` and the trace fill give the same selectors, sigmas and trace
as the JAX package's per-gate and per-cell loops, computed on the host over
numpy arrays of the gate list and the copy cycles (the sigma tables' field
products through `goldilocks.mul` on host tensors), since a recursive
circuit over a full-width batch proof holds about 10^6 gates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..executor.sm import poseidon_g
from ..ops import goldilocks as gl
from ..ops import poseidon_constants as pc
from ..ops import refmodel as rm
from .air import AIR
from .compose import CombinedAIR

P = gl.P
N_WIRES = 12
N_SLOTS = 4          # arith gates per row (3 wires each)
N_HL = 24            # hash-claim lanes (Poseidon IN12 | OUT12)


@dataclasses.dataclass
class _Gate:
    ql: int
    qr: int
    qm: int
    qo: int
    qc: int
    a: int   # signal ids
    b: int
    c: int


class GLSynth:
    """Circuit builder + witness, in lockstep (snark.gadgets.Synthesizer
    shape, but over GL with PLONK gates instead of R1CS)."""

    def __init__(self):
        self.vals: list[int] = []
        self._parent: list[int] = []      # union-find over signals
        self.gates: list[_Gate] = []
        self.hashes: list[tuple] = []     # ([12 in sigs], [4 out sigs])
        self.publics: list[int] = []      # signal per public, in order
        self._poseidon = rm.Poseidon(pc.round_constants(), pc.mds_matrix())
        self._const_cache: dict[int, int] = {}
        self._zero = self.constant(0)

    # -- signals -----------------------------------------------------------

    def alloc(self, value: int) -> int:
        self.vals.append(int(value) % P)
        self._parent.append(len(self.vals) - 1)
        return len(self.vals) - 1

    def find(self, s: int) -> int:
        while self._parent[s] != s:
            self._parent[s] = self._parent[self._parent[s]]
            s = self._parent[s]
        return s

    def assert_eq(self, x: int, y: int) -> None:
        """Free: merges the copy classes (values must already agree)."""
        assert self.vals[x] == self.vals[y], \
            f"assert_eq witness mismatch: {self.vals[x]} != {self.vals[y]}"
        rx, ry = self.find(x), self.find(y)
        if rx != ry:
            self._parent[ry] = rx

    def constant(self, v: int) -> int:
        """A signal pinned to a constant by a gate (cached per value)."""
        v = int(v) % P
        if v not in self._const_cache:
            s = self.alloc(v)
            # 1·s + qC = 0  with qC = -v
            self.gates.append(_Gate(1, 0, 0, 0, (P - v) % P, s, s, s))
            self._const_cache[v] = s
        return self._const_cache[v]

    # -- gates ---------------------------------------------------------------

    def gate(self, ql, qr, qm, qo, qc, a, b, c) -> None:
        g = _Gate(ql % P, qr % P, qm % P, qo % P, qc % P, a, b, c)
        chk = (g.ql * self.vals[a] + g.qr * self.vals[b]
               + g.qm * self.vals[a] * self.vals[b]
               + g.qo * self.vals[c] + g.qc) % P
        assert chk == 0, "gate not satisfied by witness"
        self.gates.append(g)

    def mul(self, a: int, b: int) -> int:
        c = self.alloc(self.vals[a] * self.vals[b] % P)
        self.gate(0, 0, 1, P - 1, 0, a, b, c)
        return c

    def add(self, a: int, b: int) -> int:
        c = self.alloc((self.vals[a] + self.vals[b]) % P)
        self.gate(1, 1, 0, P - 1, 0, a, b, c)
        return c

    def sub(self, a: int, b: int) -> int:
        c = self.alloc((self.vals[a] - self.vals[b]) % P)
        self.gate(1, P - 1, 0, P - 1, 0, a, b, c)
        return c

    def muls(self, a: int, k: int) -> int:
        """a * constant."""
        c = self.alloc(self.vals[a] * (k % P) % P)
        self.gate(k % P, 0, 0, P - 1, 0, a, a, c)
        return c

    def mul_add(self, a: int, b: int, d: int) -> int:
        """a·b + d in ONE gate pair: c = a·b + d needs qM + linear d — use
        two wires for the product and fold d via qR."""
        c = self.alloc((self.vals[a] * self.vals[b] + self.vals[d]) % P)
        # qM·a·b + qR·b? d is a third signal — gate wires are (a, b, c);
        # route d through qL on a second gate: c2 = prod + d
        prod = self.mul(a, b)
        return self.add(prod, d)

    def lincomb(self, terms: list[tuple[int, int]], const: int = 0) -> int:
        """Σ k_i·s_i + const — chained 2-term gates: ceil((n-1)/1) gates."""
        if not terms:
            return self.constant(const)
        if len(terms) == 1 and const == 0 and terms[0][0] % P == 1:
            return terms[0][1]
        acc_val = const % P
        for k, s in terms:
            acc_val = (acc_val + (k % P) * self.vals[s]) % P
        # fold pairwise: acc = k0 s0 + k1 s1 + const, then acc += k_i s_i
        (k0, s0) = terms[0]
        if len(terms) == 1:
            out = self.alloc(acc_val)
            self.gate(k0, 0, 0, P - 1, const, s0, s0, out)
            return out
        (k1, s1) = terms[1]
        cur = self.alloc((k0 * self.vals[s0] + k1 * self.vals[s1] + const) % P)
        self.gate(k0, k1, 0, P - 1, const, s0, s1, cur)
        for k, s in terms[2:]:
            nxt = self.alloc((self.vals[cur] + (k % P) * self.vals[s]) % P)
            self.gate(1, k, 0, P - 1, 0, cur, s, nxt)
            cur = nxt
        return cur

    def assert_zero(self, a: int) -> None:
        self.gate(1, 0, 0, 0, 0, a, a, a)

    def assert_bool(self, a: int) -> None:
        # a·a - a = 0
        self.gate(P - 1, 0, 1, 0, 0, a, a, a)

    def bits(self, x: int, n: int) -> list[int]:
        """LSB-first bit decomposition; x must fit in n bits."""
        v = self.vals[x]
        assert v < (1 << n), f"bits({n}): value {v} out of range"
        bs = []
        for i in range(n):
            bi = self.alloc((v >> i) & 1)
            self.assert_bool(bi)
            bs.append(bi)
        acc = self.lincomb([(1 << i, b) for i, b in enumerate(bs)])
        self.assert_eq(acc, x)
        return bs

    def inv(self, a: int) -> int:
        """1/a, a != 0 enforced by a·inv = 1."""
        v = self.vals[a]
        assert v != 0, "inv(0)"
        iv = self.alloc(pow(v, P - 2, P))
        self.gate(0, 0, 1, 0, P - 1, a, iv, iv)  # a·inv - 1 = 0
        return iv

    def select(self, bit: int, t: int, f: int) -> int:
        """bit·t + (1-bit)·f = f + bit·(t - f)."""
        d = self.sub(t, f)
        prod = self.mul(bit, d)
        return self.add(f, prod)

    # -- Poseidon claims -----------------------------------------------------

    def poseidon(self, in12: list[int]) -> list[int]:
        """Full-width permutation claim: returns all 12 output signals
        (the transcript squeezes beyond the 4-element digest)."""
        assert len(in12) == 12
        out = self._poseidon.permute([self.vals[s] for s in in12])
        outs = [self.alloc(v) for v in out]
        self.hashes.append((list(in12), outs))
        return outs

    def poseidon4(self, in12: list[int]) -> list[int]:
        return self.poseidon(in12)[:4]

    # -- publics ---------------------------------------------------------------

    def set_public(self, sig: int) -> int:
        """Expose a signal as the next circuit public; returns its index."""
        self.publics.append(sig)
        return len(self.publics) - 1


# ---------------------------------------------------------------------------
# compilation: synth -> CombinedAIR {"gates", "poseidon_g"} + trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledCircuit:
    air: CombinedAIR
    n_bits: int
    layout: dict            # cells per signal root, rows used, etc.

    def trace(self, synth: GLSynth) -> dict:
        """Trace dict for `synth` (which must have the same gate/hash/public
        structure as the synth this circuit was compiled from — the FIXED
        circuit re-witnessed with another proof)."""
        return _fill_trace(synth, self)


def rows_needed(synth: GLSynth) -> int:
    n_pub_rows = len(synth.publics)
    gate_rows = -(-len(synth.gates) // N_SLOTS)
    hash_rows = len(synth.hashes)
    # poseidon_g sub-SM rows: GROUP per permutation
    pose_rows = (len(synth.hashes) + 1) * poseidon_g.GROUP
    return max(n_pub_rows + max(gate_rows, hash_rows), pose_rows)


def _powers(base: int, n: int) -> np.ndarray:
    """[1, base, ..., base^(n-1)] mod P as numpy uint64, by doubling."""
    out = torch.ones(1, dtype=torch.int64)
    while out.shape[0] < n:
        step = gl.const(pow(base, out.shape[0], P), "cpu")
        out = torch.cat([out, gl.mul(out, step)])
    return gl.to_u64(out[:n])


def _gate_table(synth: GLSynth) -> np.ndarray:
    """(n_gates, 8) uint64: ql, qr, qm, qo, qc and the a, b, c signals."""
    return np.array([(g.ql, g.qr, g.qm, g.qo, g.qc, g.a, g.b, g.c)
                     for g in synth.gates],
                    dtype=np.uint64).reshape(len(synth.gates), 8)


def _hash_table(synth: GLSynth) -> np.ndarray:
    """(n_hashes, 24) int64: each claim's 12 input and 12 output signals."""
    return np.array([list(ins) + list(outs) for ins, outs in synth.hashes],
                    dtype=np.int64).reshape(len(synth.hashes), N_HL)


def _cells(synth: GLSynth, base: int, gates: np.ndarray,
           hashes: np.ndarray):
    """Every wire and lane cell a signal occupies, in the order the JAX
    package touches them (publics, then each gate's a, b, c, then each
    claim's lanes): (signals, columns, rows) as int64 arrays."""
    n_pub, ng, nh = len(synth.publics), len(gates), len(hashes)
    grow = base + np.arange(ng) // N_SLOTS
    gcol = 3 * (np.arange(ng) % N_SLOTS)
    sig = [np.array(synth.publics, dtype=np.int64),
           gates[:, 5:8].astype(np.int64).ravel(), hashes.ravel()]
    col = [np.zeros(n_pub, dtype=np.int64),
           (gcol[:, None] + np.arange(3)).ravel(),
           np.tile(N_WIRES + np.arange(N_HL), nh)]
    row = [np.arange(n_pub), np.repeat(grow, 3),
           np.repeat(base + np.arange(nh), N_HL)]
    return (np.concatenate(sig), np.concatenate(col).astype(np.int64),
            np.concatenate(row).astype(np.int64))


def _roots(synth: GLSynth) -> np.ndarray:
    """The copy-class root of every signal (union-find, by pointer
    jumping over the parent array)."""
    parent = np.array(synth._parent, dtype=np.int64)
    while True:
        nxt = parent[parent]
        if np.array_equal(nxt, parent):
            return parent
        parent = nxt


def compile_air(synth: GLSynth, n_bits: int) -> CompiledCircuit:
    n = 1 << n_bits
    n_pub = len(synth.publics)
    gate_rows = -(-len(synth.gates) // N_SLOTS)
    hash_rows = len(synth.hashes)
    body_rows = max(gate_rows, hash_rows)
    assert n_pub + body_rows <= n, (
        f"circuit needs {n_pub + body_rows} rows > 2^{n_bits}")
    assert (len(synth.hashes) + 1) * poseidon_g.GROUP <= n, \
        "poseidon_g sub-SM overflow"

    gates_air = AIR("gates", n_bits)
    names = ([f"W{i}" for i in range(N_WIRES)]
             + [f"H{i}" for i in range(N_HL)])
    handles = gates_air.committed(*names)
    c = dict(zip(names, handles))

    # ---- selector constants -------------------------------------------
    gates = _gate_table(synth)
    hashes = _hash_table(synth)
    base = n_pub
    grow = base + np.arange(len(gates)) // N_SLOTS
    sel = {}
    for k in range(N_SLOTS):
        for q, nm in enumerate(("QL", "QR", "QM", "QO", "QC")):
            col = np.zeros(n, dtype=np.uint64)
            col[grow[k::N_SLOTS]] = gates[k::N_SLOTS, q]
            sel[f"{nm}{k}"] = col
    qpose = np.zeros(n, dtype=np.uint64)
    qpose[base:base + hash_rows] = 1
    selc = {nm: gates_air.constant(nm, v) for nm, v in sel.items()}
    QPOSE = gates_air.constant("QPOSE", qpose)

    # ---- gate equations -------------------------------------------------
    for k in range(N_SLOTS):
        a, b, o = c[f"W{3 * k}"], c[f"W{3 * k + 1}"], c[f"W{3 * k + 2}"]
        gates_air.require_zero(
            selc[f"QL{k}"] * a + selc[f"QR{k}"] * b
            + selc[f"QM{k}"] * a * b + selc[f"QO{k}"] * o
            + selc[f"QC{k}"])

    # ---- copy constraints: each signal's cells form one cycle -----------
    ncols = N_WIRES + N_HL
    shift = gl.shift()
    w_pows = gl.from_u64(_powers(gl.w(n_bits), n), "cpu")
    sigma = np.stack([gl.to_u64(gl.mul(w_pows, gl.const(pow(shift, j, P),
                                                        "cpu")))
                      for j in range(ncols)])
    sig, col, row = _cells(synth, base, gates, hashes)
    root = _roots(synth)[sig]
    order = np.argsort(root, kind="stable")
    r_sorted = root[order]
    m = len(order)
    first = np.ones(m, dtype=bool)
    first[1:] = r_sorted[1:] != r_sorted[:-1]
    start = np.maximum.accumulate(np.where(first, np.arange(m), 0))
    last = np.ones(m, dtype=bool)
    last[:-1] = first[1:]
    nxt = np.where(last, start, np.arange(m) + 1)
    src, dst = order, order[nxt]
    sigma[col[src], row[src]] = sigma[col[dst], row[dst]]
    sigmas = [gates_air.constant(f"SIG{j}", sigma[j]) for j in range(ncols)]
    gates_air.connection([c[nm] for nm in names], sigmas)

    # ---- publics ----------------------------------------------------------
    for i in range(n_pub):
        lrow = np.zeros(n, dtype=np.uint64)
        lrow[i] = 1
        L = gates_air.constant(f"LPUB{i}", lrow)
        p = gates_air.public(f"pub{i}", c["W0"], i)
        gates_air.require_zero(L * (c["W0"] - p))

    # ---- combined AIR with the PoseidonG hash table -----------------------
    air = CombinedAIR("recursive", n_bits)
    air.add("gates", gates_air)
    air.add("poseidon_g", poseidon_g.build_air(n_bits))
    f = [air.cm("gates", f"H{j}") for j in range(N_HL)]
    t = ([air.cm("poseidon_g", f"IN{j}") for j in range(12)]
         + [air.cm("poseidon_g", f"S{j}") for j in range(12)])
    air.lookup(f, t, sel_f=air.const("gates", "QPOSE"),
               sel_t=air.const("poseidon_g", "GOUT"))

    layout = {"n_pub": n_pub, "base": base, "gate_rows": gate_rows,
              "hash_rows": hash_rows}
    return CompiledCircuit(air=air, n_bits=n_bits, layout=layout)


def _fill_trace(synth: GLSynth, cc: CompiledCircuit) -> dict:
    n = 1 << cc.n_bits
    base = cc.layout["base"]
    vals = np.array(synth.vals, dtype=np.uint64)
    tr = np.zeros((n, N_WIRES + N_HL), dtype=np.uint64)
    tr[:len(synth.publics), 0] = vals[np.array(synth.publics, dtype=np.int64)]
    gates = _gate_table(synth)[:, 5:8].astype(np.int64)
    grow = base + np.arange(len(gates)) // N_SLOTS
    for k in range(N_SLOTS):
        for t in range(3):
            tr[grow[k::N_SLOTS], 3 * k + t] = vals[gates[k::N_SLOTS, t]]
    hashes = _hash_table(synth)
    tr[base:base + len(hashes), N_WIRES:] = vals[hashes]
    actions = [{"state": [int(v) for v in row]}
               for row in vals[hashes[:, :12]]]
    pose_tr = poseidon_g.execute(actions, cc.n_bits)
    return {"gates": tr, "poseidon_g": pose_tr}
