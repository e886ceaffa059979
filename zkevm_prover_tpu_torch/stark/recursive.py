"""The STARK verifier as a Goldilocks circuit — STARK-in-STARK recursion.

Reference roles (SURVEY §3.3, prover.cpp:612-800): c12a normalizes the
batch STARK into a PLONKish AIR, recursive1 proves its verifier, and
recursive2 proves a verifier of TWO recursive proofs — a constant-size
binary aggregation tree under ONE fixed setup per layer.

Here the verifier of a GL-scheme proof (stark/verifier.py, mirrored check
for check) is synthesized into a `gl_circuit.GLSynth` and proven by the
same eSTARK engine:

    build_verifier(setup, synth, vk_sigs, pub_sigs, proof)

adds constraints asserting `proof` verifies against the verkey/publics
SIGNALS — transcript replay (Poseidon claims), quotient identity at xi
(the inner c_combined DAG in gates), Merkle openings (Poseidon chains,
bit-keyed sibling order), the FRI fold chain and the final-polynomial
degree bound. Every Fiat-Shamir index keys multiplexers, so ONE circuit
(one outer setup, one verkey) verifies every proof of the inner shape.

`RecursiveProver` packages the outer proof production:
  prove_one(inner_proof)  -> recursive1-style wrap
  prove_two(p1, p2, ...)  -> recursive2-style 2->1 join with publics
                             chaining — applied in a binary tree this is
                             the reference's constant-size aggregation.

Port of `zkevm_prover_tpu/stark/recursive.py`: the same gadgets and
circuits on the port's `GLSynth`; both provers take `device=` (CUDA unless
told otherwise) for the `StarkProver` of their outer AIR, and record the
host seconds of each step of their last proof in `times` and the shape of
their circuit in `stats`. Their `n_bits` may be None: the outer domain is
then the smallest power of two that holds the circuit (`rows_needed`),
fixed at its compile.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .. import resolve_device
from ..ops import goldilocks as gl
from ..ops import refmodel as rm
from . import expr as ex
from . import gl_circuit as glc
from .gl_circuit import GLSynth

P = gl.P


# ---------------------------------------------------------------------------
# GL3 gadgets over GLSynth signals (triples)
# ---------------------------------------------------------------------------


def gl3_add(s: GLSynth, a, b):
    return [s.add(a[i], b[i]) for i in range(3)]


def gl3_sub(s: GLSynth, a, b):
    return [s.sub(a[i], b[i]) for i in range(3)]


def gl3_mul(s: GLSynth, a, b):
    """(x^3 = x + 1) product — mirrors refmodel.mul3."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    m00 = s.mul(a0, b0)
    m11 = s.mul(a1, b1)
    m22 = s.mul(a2, b2)
    # Karatsuba-style cross terms
    a01, b01 = s.add(a0, a1), s.add(b0, b1)
    a02, b02 = s.add(a0, a2), s.add(b0, b2)
    a12, b12 = s.add(a1, a2), s.add(b1, b2)
    m01 = s.mul(a01, b01)   # a0b1 + a1b0 + m00 + m11
    m02 = s.mul(a02, b02)   # a0b2 + a2b0 + m00 + m22
    m12 = s.mul(a12, b12)   # a1b2 + a2b1 + m11 + m22
    # c0 = m00 + (a1b2 + a2b1) = m00 + m12 - m11 - m22
    c0 = s.lincomb([(1, m00), (1, m12), (P - 1, m11), (P - 1, m22)])
    # c1 = (a0b1 + a1b0) + (a1b2 + a2b1) + a2b2
    c1 = s.lincomb([(1, m01), (P - 1, m00), (P - 1, m11),
                    (1, m12), (P - 1, m11), (P - 1, m22), (1, m22)])
    # c2 = (a0b2 + a2b0) + a1b1 + a2b2
    c2 = s.lincomb([(1, m02), (P - 1, m00), (P - 1, m22), (1, m11),
                    (1, m22)])
    return [c0, c1, c2]


def gl3_muls(s: GLSynth, a, k: int):
    return [s.muls(a[i], k) for i in range(3)]


def gl3_mul_base(s: GLSynth, a, b_sig: int):
    return [s.mul(a[i], b_sig) for i in range(3)]


def gl3_const(s: GLSynth, v) -> list[int]:
    t = v if isinstance(v, (tuple, list)) else (int(v) % P, 0, 0)
    return [s.constant(int(x) % P) for x in t]


def gl3_assert_eq(s: GLSynth, a, b) -> None:
    for i in range(3):
        s.assert_eq(a[i], b[i])


def gl3_inv(s: GLSynth, a):
    """Witness the inverse, constrain a·inv == 1."""
    av = tuple(s.vals[x] for x in a)
    iv = rm.inv3(av)
    inv = [s.alloc(v) for v in iv]
    prod = gl3_mul(s, a, inv)
    one = gl3_const(s, (1, 0, 0))
    gl3_assert_eq(s, prod, one)
    return inv


def gl3_select(s: GLSynth, bit: int, t, f):
    return [s.select(bit, t[i], f[i]) for i in range(3)]


def gl3_mux(s: GLSynth, bits: list[int], options: list):
    """Bit-keyed 2^k-way mux over GL3 signal triples."""
    opts = list(options)
    for b in bits:
        nxt = []
        for i in range(0, len(opts), 2):
            hi = opts[i + 1] if i + 1 < len(opts) else opts[i]
            nxt.append(gl3_select(s, b, hi, opts[i]))
        opts = nxt
    assert len(opts) == 1
    return opts[0]


def gl_pow_bits(s: GLSynth, base: int, bits: list[int]) -> int:
    """base^y for y given LSB-first as bit signals (fixed circuit)."""
    acc = s.constant(1)
    cur = base % P
    for b in bits:
        fac = s.select(b, s.constant(cur), s.constant(1))
        acc = s.mul(acc, fac)
        cur = cur * cur % P
    return acc


def gl_bits_canonical(s: GLSynth, x: int) -> list[int]:
    """64-bit LSB-first decomposition of a GL element with the canonical-
    representative guard: values in [p, 2^64) (top 32 bits all ones AND a
    nonzero low word) are rejected, so the prover cannot shift the
    Fiat-Shamir query indices by choosing the alias."""
    v = s.vals[x]
    bs = []
    for i in range(64):
        bi = s.alloc((v >> i) & 1)
        s.assert_bool(bi)
        bs.append(bi)
    acc = s.lincomb([(pow(2, i, P), b) for i, b in enumerate(bs)])
    s.assert_eq(acc, x)
    hi_all = bs[32]
    for b in bs[33:]:
        hi_all = s.mul(hi_all, b)
    lo_zero = s.sub(s.constant(1), bs[0])
    for b in bs[1:32]:
        lo_zero = s.mul(lo_zero, s.sub(s.constant(1), b))
    # hi_all · (1 - lo_zero) == 0
    guard = s.mul(hi_all, s.sub(s.constant(1), lo_zero))
    s.assert_zero(guard)
    return bs


# ---------------------------------------------------------------------------
# transcript replay (ops/transcript.py, exact schedule)
# ---------------------------------------------------------------------------


class _Transcript:
    PENDING, STATE, OUT = 8, 4, 12

    def __init__(self, s: GLSynth):
        self.s = s
        self.state = [s.constant(0)] * self.STATE
        self.pending: list[int] = []
        self.out: list[int] = []
        self.cursor = 0

    def put(self, sigs) -> None:
        for v in sigs:
            self.pending.append(v)
            self.cursor = 0
            if len(self.pending) == self.PENDING:
                self._permute()

    def _permute(self) -> None:
        z = self.s.constant(0)
        inputs = self.pending + [z] * (self.PENDING - len(self.pending)) \
            + self.state
        out12 = self.s.poseidon(inputs)
        self.out = list(out12)
        self.cursor = self.OUT
        self.pending = []
        self.state = out12[: self.STATE]

    def get_field1(self) -> int:
        if self.cursor == 0:
            self._permute()
        v = self.out[(self.OUT - self.cursor) % self.OUT]
        self.cursor -= 1
        return v

    def get_field3(self) -> list[int]:
        return [self.get_field1() for _ in range(3)]

    def get_permutation_bits(self, n: int, n_bits: int) -> list[list[int]]:
        total = n * n_bits
        n_fields = (total - 1) // 63 + 1
        bits: list[int] = []
        for _ in range(n_fields):
            bits.extend(gl_bits_canonical(self.s, self.get_field1())[:63])
        return [bits[i * n_bits:(i + 1) * n_bits] for i in range(n)]


# ---------------------------------------------------------------------------
# Merkle opening (ops/merkle.py semantics: linear_hash leaf, arity 2)
# ---------------------------------------------------------------------------


def _linear_hash(s: GLSynth, row_sigs: list[int]) -> list[int]:
    z = s.constant(0)
    if len(row_sigs) <= 4:
        return list(row_sigs) + [z] * (4 - len(row_sigs))
    digest = [z] * 4
    for off in range(0, len(row_sigs), 8):
        chunk = list(row_sigs[off:off + 8])
        chunk += [z] * (8 - len(chunk))
        digest = s.poseidon(chunk + digest)[:4]
    return digest


def _merkle_path(s: GLSynth, row_sigs, sib_sigs, idx_bits, root4) -> None:
    node = _linear_hash(s, row_sigs)
    z = s.constant(0)
    for lvl, sib in enumerate(sib_sigs):
        b = idx_bits[lvl]
        left = [s.select(b, sib[j], node[j]) for j in range(4)]
        right = [s.select(b, node[j], sib[j]) for j in range(4)]
        node = s.poseidon(left + right + [z] * 4)[:4]
    for j in range(4):
        s.assert_eq(node[j], root4[j])


# ---------------------------------------------------------------------------
# the DAG evaluator (stark_verifier_circuit._eval_dag shape)
# ---------------------------------------------------------------------------


def _eval_dag(s: GLSynth, e: ex.Expr, bind) -> list[int]:
    memo: dict[int, list[int]] = {}

    def rec(n) -> list[int]:
        k = id(n)
        if k in memo:
            return memo[k]
        if isinstance(n, ex.Add):
            v = gl3_add(s, rec(n.a), rec(n.b))
        elif isinstance(n, ex.Sub):
            v = gl3_sub(s, rec(n.a), rec(n.b))
        elif isinstance(n, ex.Mul):
            v = gl3_mul(s, rec(n.a), rec(n.b))
        elif isinstance(n, ex.Neg):
            v = gl3_sub(s, gl3_const(s, 0), rec(n.a))
        elif isinstance(n, ex.Number):
            v = gl3_const(s, n.value % P)
        else:
            v = bind(n)
        memo[k] = v
        return v

    return rec(e)


# ---------------------------------------------------------------------------
# the verifier statement
# ---------------------------------------------------------------------------


def build_verifier(s0, s: GLSynth, vk_sigs: list[int],
                   pub_sigs: list[int], proof) -> None:
    """Constrain: `proof` (of the GL-scheme setup `s0`) verifies against
    the verkey signals `vk_sigs` (4) and publics signals `pub_sigs`.
    Mirrors stark/verifier.py check for check."""
    assert getattr(s0, "hash_type", "GL") == "GL"
    steps = list(s0.fri_steps)
    z = s.constant(0)

    def alloc3(vals3) -> list[int]:
        return [s.alloc(int(v) % P) for v in vals3]

    roots = [[s.alloc(int(v)) for v in np.ravel(np.asarray(r))]
             for r in proof.roots]
    evals = [alloc3(e) for e in proof.evals]
    final_pol = [alloc3(row) for row in np.asarray(proof.final_pol)]

    # ---- 1. transcript replay -----------------------------------------
    t = _Transcript(s)
    t.put(vk_sigs)
    t.put(pub_sigs)
    challenges = [None] * 8
    t.put(roots[0])
    challenges[0] = t.get_field3()
    challenges[1] = t.get_field3()
    t.put(roots[1])
    challenges[2] = t.get_field3()
    challenges[3] = t.get_field3()
    t.put(roots[2])
    challenges[4] = t.get_field3()
    t.put(roots[3])
    challenges[7] = t.get_field3()
    for e in evals:
        t.put(e)
    challenges[5] = t.get_field3()
    challenges[6] = t.get_field3()
    fri_roots = [[s.alloc(int(v)) for v in np.ravel(np.asarray(
        proof.fri[si].root))] for si in range(1, len(steps))]
    special_xs = []
    for si in range(len(steps)):
        special_xs.append(t.get_field3())
        if si < len(steps) - 1:
            t.put(fri_roots[si])
        else:
            for row in final_pol:
                t.put(row)
    qbits = t.get_permutation_bits(s0.n_queries, steps[0])

    # ---- 2. quotient identity at xi -------------------------------------
    xi = challenges[7]
    ev_of = {}
    for k, e in enumerate(s0.ev_map):
        ev_of[(e.type, e.id, e.prime)] = evals[k]

    def bind_main(node):
        if isinstance(node, ex.Cm):
            return ev_of[("cm", node.id, node.prime)]
        if isinstance(node, ex.Const):
            return ev_of[("const", node.id, node.prime)]
        if isinstance(node, ex.Challenge):
            return challenges[node.idx]
        if isinstance(node, ex.Public):
            return [pub_sigs[node.idx], z, z]
        if isinstance(node, ex.X):
            return xi
        raise TypeError(f"unbound node {type(node)} in c_combined")

    c_at_xi = _eval_dag(s, s0.c_combined, bind_main)
    xi_pow = xi
    for _ in range(s0.n_bits):
        xi_pow = gl3_mul(s, xi_pow, xi_pow)
    q_at_xi = gl3_const(s, 0)
    acc = gl3_const(s, (1, 0, 0))
    for pi, qid in enumerate(s0.q_ids):
        q_at_xi = gl3_add(s, q_at_xi, gl3_mul(s, acc, ev_of[("cm", qid, False)]))
        if pi + 1 < len(s0.q_ids):
            acc = gl3_mul(s, acc, xi_pow)
    zh = gl3_sub(s, xi_pow, gl3_const(s, (1, 0, 0)))
    gl3_assert_eq(s, c_at_xi, gl3_mul(s, q_at_xi, zh))

    # ---- 3+4. Merkle openings + the FRI chain ---------------------------
    w_ext = gl.w(steps[0])
    shift = gl.shift()
    col_of = dict(enumerate(s0.cols))

    for qi in range(s0.n_queries):
        bits0 = qbits[qi]
        qrow = proof.fri[0].queries[qi]
        x_sig = gl_pow_bits(s, w_ext, bits0)
        x_sig = s.muls(x_sig, shift)
        x3 = [x_sig, z, z]

        tree_sigs = []
        for ti in range(5):
            mq = qrow[ti]
            row_sigs = [s.alloc(int(v)) for v in np.asarray(mq.values)]
            sib_sigs = [[s.alloc(int(x)) for x in np.asarray(level)]
                        for level in mq.siblings]
            root4 = roots[ti] if ti < 4 else vk_sigs
            _merkle_path(s, row_sigs, sib_sigs, bits0, root4)
            tree_sigs.append(row_sigs)

        def bind_fri(node, _ts=tree_sigs, _x3=x3, _xs=x_sig):
            if isinstance(node, ex.Cm):
                assert not node.prime
                info = col_of[node.id]
                vals = _ts[info.stage - 1]
                if info.dim == 1:
                    return [vals[info.pos], z, z]
                return vals[info.pos:info.pos + 3]
            if isinstance(node, ex.Const):
                assert not node.prime
                return [_ts[4][node.id], z, z]
            if isinstance(node, ex.Challenge):
                return challenges[node.idx]
            if isinstance(node, ex.Public):
                return [pub_sigs[node.idx], z, z]
            if isinstance(node, ex.X):
                return _x3
            if isinstance(node, ex.Eval):
                return evals[node.idx]
            if isinstance(node, ex.XDivXSubXi):
                d = gl3_sub(s, _x3, xi)
                return gl3_mul_base(s, gl3_inv(s, d), _xs)
            if isinstance(node, ex.XDivXSubWXi):
                wxi = gl3_muls(s, xi, gl.w(s0.n_bits))
                d = gl3_sub(s, _x3, wxi)
                return gl3_mul_base(s, gl3_inv(s, d), _xs)
            raise TypeError(f"unbound node {type(node)} in fri_exp")

        value = _eval_dag(s, s0.fri_exp, bind_fri)

        for si in range(1, len(steps)):
            mq = proof.fri[si].queries[qi]
            group = np.asarray(mq.values).reshape(-1, 3)
            group_sigs = [alloc3(row) for row in group]
            sib_sigs = [[s.alloc(int(x)) for x in np.asarray(level)]
                        for level in mq.siblings]
            y_bits = bits0[:steps[si]]
            _merkle_path(s, [x for row in group_sigs for x in row],
                         sib_sigs, y_bits, fri_roots[si - 1])
            pos_bits = bits0[steps[si]:steps[si - 1]]
            sel = gl3_mux(s, pos_bits, group_sigs)
            gl3_assert_eq(s, sel, value)
            value = _fold(s, group_sigs, steps[si - 1], steps[si],
                          y_bits, special_xs[si], s0.n_bits_ext)
        sel = gl3_mux(s, bits0[:steps[-1]], final_pol)
        gl3_assert_eq(s, sel, value)

    # ---- 5. final polynomial low-degree ---------------------------------
    last_bits = steps[-1]
    max_deg = 1 << (last_bits - (s0.n_bits_ext - s0.n_bits))
    m = 1 << last_bits
    w_inv = pow(gl.w(last_bits), P - 2, P)
    n_inv = pow(m, P - 2, P)
    for k in range(max_deg, m):
        for limb in range(3):
            terms = [(pow(w_inv, (j * k) % m, P) * n_inv % P,
                      final_pol[j][limb]) for j in range(m)]
            s.assert_zero(s.lincomb(terms))


def _fold(s: GLSynth, group_sigs, from_bits, to_bits, y_bits, special_x,
          n_bits_ext):
    """verifier._fold_point in gates: constant-coefficient INTT + Horner."""
    n_x = 1 << (from_bits - to_bits)
    w_sub_inv = pow(gl.w(from_bits - to_bits), P - 2, P)
    n_inv = pow(n_x, P - 2, P)
    coefs = []
    for j in range(n_x):
        limbs = []
        for limb in range(3):
            terms = [(pow(w_sub_inv, (k * j) % n_x, P) * n_inv % P,
                      group_sigs[k][limb]) for k in range(n_x)]
            limbs.append(s.lincomb(terms))
        coefs.append(limbs)
    s_inv = pow(gl.shift_inv(), 1 << (n_bits_ext - from_bits), P)
    w_from_inv = pow(gl.w(from_bits), P - 2, P)
    wg = gl_pow_bits(s, w_from_inv, y_bits)
    sg = s.muls(wg, s_inv)
    factor = gl3_mul_base(s, special_x, sg)
    acc = gl3_const(s, 0)
    for c in reversed(coefs):
        acc = gl3_add(s, gl3_mul(s, acc, factor), c)
    return acc


# ---------------------------------------------------------------------------
# recursive provers
# ---------------------------------------------------------------------------


class _Timer:
    """Writes the host seconds since the last call into `times[label]`."""

    def __init__(self, times: dict):
        self.times = times
        self.t0 = time.perf_counter()

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        self.times[label] = now - self.t0
        self.t0 = now


def _circuit_stats(s: GLSynth) -> dict:
    return {"gates": len(s.gates), "hashes": len(s.hashes),
            "publics": len(s.publics), "signals": len(s.vals),
            "rows_needed": glc.rows_needed(s)}


def _compile(s: GLSynth, rp, t: _Timer):
    """The outer circuit of `s` at 2^rp.n_bits (when None, the smallest
    power of two that holds it, then kept in rp.n_bits) and its prover on
    rp.device; `t` records compile_air's and the setup's seconds."""
    from .prover import StarkProver
    from .setup import StarkSetup

    if rp.n_bits is None:
        rp.n_bits = max(1, (glc.rows_needed(s) - 1).bit_length())
    cc = glc.compile_air(s, rp.n_bits)
    t("compile_air")
    pv = StarkProver(StarkSetup(cc.air, n_queries=rp.n_queries,
                                fri_fold_bits=rp.fri_fold_bits),
                     device=rp.device)
    t("setup")
    return cc, pv


@dataclasses.dataclass
class RecursiveProof:
    proof: object               # outer StarkProof
    publics: list[int]          # [inner publics..., inner verkey (4)]
    n_inner_publics: int


class RecursiveProver:
    """Wrap proofs of ONE fixed inner shape into recursive STARKs.

    The outer circuit (and so the outer setup + verkey) depends only on
    the INNER SHAPE — re-witnessing with another proof of that shape
    reuses everything (compile once, prove many)."""

    def __init__(self, inner_setup, n_bits: int, n_queries: int = 8,
                 fri_fold_bits: int = 2, device=None):
        self.inner = inner_setup
        self.n_bits = n_bits
        self.n_queries = n_queries
        self.fri_fold_bits = fri_fold_bits
        self.device = resolve_device(device)
        self._compiled = None   # (CompiledCircuit, StarkProver)
        self.times: dict[str, float] = {}
        self.stats: dict[str, int] = {}

    def _synth(self, verkey, proof, n_chain: int = 0):
        s = GLSynth()
        vk_vals = [int(v) for v in np.ravel(np.asarray(verkey))]
        pub_vals = [int(p) for p in proof.publics]
        pub_sigs = [s.alloc(v) for v in pub_vals]
        vk_sigs = [s.alloc(v) for v in vk_vals]
        for sig in pub_sigs:
            s.set_public(sig)
        for sig in vk_sigs:
            s.set_public(sig)
        build_verifier(self.inner, s, vk_sigs, pub_sigs, proof)
        return s

    def prove_one(self, verkey, proof) -> RecursiveProof:
        self.times = {}
        t = _Timer(self.times)
        s = self._synth(verkey, proof)
        t("synth")
        self.stats = _circuit_stats(s)
        if self._compiled is None:
            self._compiled = _compile(s, self, t)
        cc, pv = self._compiled
        traces = cc.trace(s)
        stacked = cc.air.stack_traces(traces)
        t("trace")
        outer = pv.prove(stacked)
        t("prove")
        return RecursiveProof(
            proof=outer, publics=[int(p) for p in outer.publics],
            n_inner_publics=len(proof.publics))

    @property
    def outer_prover(self):
        assert self._compiled is not None, "prove_one first"
        return self._compiled[1]


class Recursive2Prover:
    """The recursive2 role: ONE fixed circuit verifying TWO child proofs
    of the recursive shape, with publics chaining — applied pairwise it
    aggregates any number of batch proofs into a constant-size artifact
    under one setup (reference recursive2.circom, prover.cpp:676-800).

    Each child's verkey is constrained in-circuit to be EITHER the
    recursive1 verkey (a circuit constant) OR the `vk` PUBLIC — the
    caller passes this circuit's OWN verkey there, so recursive2 outputs
    feed recursive2 inputs and the tree closes (the reference's
    publics[44..47] = recursive2Verkey role). Both r1 and r2 circuits
    share the 48-public layout, so their proofs are shape-identical and
    ONE circuit covers every tree level.

    chain: [(idx_in_p1_publics, idx_in_p2_publics)] equalities;
    join_publics(p1_sigs, p2_sigs) -> the joined publics signals (44)."""

    def __init__(self, child_setup, r1_verkey, n_bits: int,
                 join_publics, chain: list[tuple[int, int]],
                 n_queries: int = 8, fri_fold_bits: int = 2, device=None):
        self.child = child_setup          # structural setup of child proofs
        self.r1_verkey = [int(v) for v in np.ravel(np.asarray(r1_verkey))]
        self.n_bits = n_bits
        self.join_publics = join_publics
        self.chain = chain
        self.n_queries = n_queries
        self.fri_fold_bits = fri_fold_bits
        self.device = resolve_device(device)
        self._compiled = None
        self.times: dict[str, float] = {}
        self.stats: dict[str, int] = {}

    def _child_vk(self, s: GLSynth, vk_pub: list[int], actual) -> list[int]:
        """The child-verkey choice: a committed bit picks the constant
        recursive1 verkey or the out-verkey public; the chosen value must
        hash-open the child's const tree (enforced downstream by
        build_verifier's Merkle checks)."""
        actual_v = [int(v) for v in np.ravel(np.asarray(actual))]
        is_r2 = 0 if actual_v == self.r1_verkey else 1
        bit = s.alloc(is_r2)
        s.assert_bool(bit)
        out = []
        for j in range(4):
            r1c = s.constant(self.r1_verkey[j])
            out.append(s.select(bit, vk_pub[j], r1c))
            assert s.vals[out[-1]] == actual_v[j], \
                "child verkey is neither recursive1's nor the vk public"
        return out

    def _synth_pair(self, proof1, vk1, proof2, vk2, out_vk):
        s = GLSynth()
        p1_sigs = [s.alloc(int(p)) for p in proof1.publics]
        p2_sigs = [s.alloc(int(p)) for p in proof2.publics]
        vk_pub = [s.alloc(int(v)) for v in np.ravel(np.asarray(out_vk))]
        for i1, i2 in self.chain:
            s.assert_eq(p1_sigs[i1], p2_sigs[i2])
        for sig in self.join_publics(p1_sigs, p2_sigs):
            s.set_public(sig)
        for sig in vk_pub:
            s.set_public(sig)
        vk1_sigs = self._child_vk(s, vk_pub, vk1)
        vk2_sigs = self._child_vk(s, vk_pub, vk2)
        build_verifier(self.child, s, vk1_sigs, p1_sigs, proof1)
        build_verifier(self.child, s, vk2_sigs, p2_sigs, proof2)
        return s

    def prepare(self, proof1, vk1, proof2, vk2):
        """Compile the fixed circuit from a throwaway witness (the vk
        public's VALUE does not shape the circuit — only the structure of
        the child proofs does), fixing this circuit's own verkey."""
        if self._compiled is not None:
            return
        t = _Timer(self.times)
        s = self._synth_pair(proof1, vk1, proof2, vk2, self.r1_verkey)
        t("prepare_synth")
        self._compiled = _compile(s, self, t)

    def prove_pair(self, proof1, vk1, proof2, vk2):
        """vk1/vk2: each child's actual verkey — recursive1's, or this
        circuit's own (an r2 output). The produced proof's vk public is
        always this circuit's own verkey (the reference's
        publics[44..47] = recursive2Verkey invariant)."""
        self.times = {}
        self.prepare(proof1, vk1, proof2, vk2)
        cc, pv = self._compiled
        t = _Timer(self.times)
        s = self._synth_pair(proof1, vk1, proof2, vk2, pv.verkey)
        t("synth")
        self.stats = _circuit_stats(s)
        stacked = cc.air.stack_traces(cc.trace(s))
        t("trace")
        outer = pv.prove(stacked)
        t("prove")
        return outer

    @property
    def outer_prover(self):
        assert self._compiled is not None, "prove_pair first"
        return self._compiled[1]
