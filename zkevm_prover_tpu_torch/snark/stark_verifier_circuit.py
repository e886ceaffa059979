"""The STARK verifier as a FIXED R1CS circuit — recursive compression.

Reference: the stark_verifier.circom templates the reference compiles per
starkinfo and wraps with Groth16/Fflonk (recursiveF -> final), and
recursive2.circom (one circuit verifying TWO child proofs — the
aggregation join, prover.cpp:676-800). This module synthesizes the same
statements over our R1CS for BN128-scheme STARKs (stark/scheme.py): the
Poseidon-BN128 transcript and arity-16 Merkle trees are native Fr
arithmetic, and the FRI/eval algebra runs through the Goldilocks-in-Fr
gadgets (snark/gadgets.py).

The circuit is FIXED per STARK shape: every Fiat-Shamir-derived index
drives bit-keyed multiplexers (gadgets.mux_tree — the circom Multiplexor
role), so ONE circuit (and one Groth16 setup) verifies every proof of
that shape; the verkey is a public input. This replaces round 1's
instance-specialized synthesis.

`build(setup, verkey, proof)` -> single-proof verifier.
`build_join(setup, verkey, proofs, chain)` -> the recursive2 role: K
child proofs verified in one circuit with publics-chaining constraints.

Mirrors stark/verifier.py check for check; kept deliberately parallel so
the host verifier remains the oracle for this circuit.

Copy of `zkevm_prover_tpu/snark/stark_verifier_circuit.py` (host Python)
over the port's StarkSetup, StarkProof and expression DAG.
"""

from __future__ import annotations

import numpy as np

from ..ops import bn254, poseidon_bn128 as pbn
from ..ops import goldilocks as gl
from ..ops import refmodel as rm
from ..stark import expr as ex
from . import gadgets as gd
from .gadgets import Synthesizer

R = bn254.R
P = gd.GL_P
ARITY = 16


class _Transcript:
    """TranscriptBN128 replayed in-circuit (ops/transcript_bn128.py)."""

    def __init__(self, s: Synthesizer):
        self.s = s
        self.zero = _zero(s)
        self.state = self.zero
        self.pending: list[int] = []
        self.out: list[int] = []
        self.out3: list[int] = []

    def put(self, sigs) -> None:
        for v in sigs:
            self.pending.append(v)
            self.out = []
            if len(self.pending) == pbn.T - 1:
                self._permute()

    def _permute(self) -> None:
        inputs = self.pending + [self.zero] * (pbn.T - 1 - len(self.pending))
        out = gd.poseidon_bn128_permute(self.s, [self.state] + inputs)
        self.pending = []
        self.out = list(out)
        self.out3 = []
        self.state = out[0]

    def get_fr(self) -> int:
        if not self.out:
            self._permute()
        return self.out.pop(0)

    def _get_limb(self) -> int:
        if not self.out3:
            self.out3 = gd.fr_to_limbs64(self.s, self.get_fr())
        return self.out3.pop(0)

    def get_field3(self) -> list[int]:
        return [self._get_limb() for _ in range(3)]

    def get_permutation_bits(self, n: int, n_bits: int) -> list[list[int]]:
        """Mirror of TranscriptBN128.get_permutations: fields are consumed
        253 bits each; returns per-index LSB-first bit signals."""
        total = n * n_bits
        n_fields = (total - 1) // 253 + 1
        bits = []
        for _ in range(n_fields):
            bits.extend(gd.fr_bits_canonical(self.s, self.get_fr())[:253])
        return [bits[i * n_bits : (i + 1) * n_bits] for i in range(n)]


def _const3(s: Synthesizer, v) -> list[int]:
    """Pin a GL3 constant as three signals."""
    t = v if isinstance(v, tuple) else (int(v) % P, 0, 0)
    out = []
    for limb in t:
        sig = s.alloc(int(limb) % P)
        s.b.constrain({sig: 1, 0: R - int(limb) % P}, {0: 1}, {0: 0})
        out.append(sig)
    return out


def _eval_dag(s: Synthesizer, e: ex.Expr, bind) -> list[int]:
    """ex.eval_point mirrored with GL3 signal triples."""
    memo: dict[int, list[int]] = {}
    consts: dict[int, list[int]] = {}

    def num3(v: int) -> list[int]:
        if v not in consts:
            consts[v] = _const3(s, v)
        return consts[v]

    def rec(n) -> list[int]:
        k = id(n)
        if k in memo:
            return memo[k]
        if isinstance(n, ex.Add):
            v = gd.gl3_add(s, rec(n.a), rec(n.b))
        elif isinstance(n, ex.Sub):
            v = gd.gl3_sub(s, rec(n.a), rec(n.b))
        elif isinstance(n, ex.Mul):
            v = gd.gl3_mul(s, rec(n.a), rec(n.b))
        elif isinstance(n, ex.Neg):
            v = gd.gl3_sub(s, num3(0), rec(n.a))
        elif isinstance(n, ex.Number):
            v = num3(n.value % P)
        else:
            v = bind(n)
        memo[k] = v
        return v

    return rec(e)


def _merkle_path(s: Synthesizer, row_sigs: list[int],
                 sib_sigs: list[list[int]], idx_bits: list[int],
                 root_sig: int) -> None:
    """verify_group_proof in-circuit (ops/merkle_bn128._leaf_hash): narrow
    rows (<= 4 GL) pack raw into one Fr with no hash; wider rows pack
    3-per-Fr and run the reference linearHash sponge, whose final short
    chunk hashes at the narrower width (merkleTreeBN128.cpp:113-151).
    The arity-16 climb slots the node among the 15 siblings by BIT-KEYED
    MULTIPLEXING on the next 4 index bits — no instance specialization."""
    if len(row_sigs) <= 4:
        if not row_sigs:
            node = _zero(s)
        else:
            node = s.lin({sig: 1 << (64 * i)
                          for i, sig in enumerate(row_sigs)})
    else:
        packed = []
        for off in range(0, len(row_sigs), 3):
            chunk = row_sigs[off:off + 3]
            lc = {sig: 1 << (64 * i) for i, sig in enumerate(chunk)}
            packed.append(s.lin(lc))
        digest = None
        for off in range(0, len(packed), 16):
            chunk = packed[off:off + 16]
            if len(chunk) == 16:
                digest = gd.poseidon_hash16(s, chunk, capacity=digest)
            else:
                digest = gd.poseidon_hash_partial(s, chunk, capacity=digest)
        node = digest
    bit_pos = 0
    zero = _zero(s)
    for sibs in sib_sigs:
        pos_bits = idx_bits[bit_pos:bit_pos + 4]
        while len(pos_bits) < 4:
            pos_bits.append(zero)
        bit_pos += 4
        children = []
        for k in range(ARITY):
            # child k = sib[k] when pos > k, node when pos == k,
            # sib[k-1] when pos < k
            cand = [sibs[k] if p > k else node if p == k else sibs[k - 1]
                    for p in range(ARITY)]
            children.append(gd.mux_sig(s, pos_bits, cand))
        node = gd.poseidon_hash16(s, children)
    s.assert_eq(node, root_sig)


def _verify_proof(s: Synthesizer, s0, VK: int, PUBS: list[int], proof):
    """Synthesize one proof's verification into `s` (shared by build /
    build_join). Returns nothing; all checks are constraints."""
    steps = list(s0.fri_steps)

    def alloc_gl(v: int) -> int:
        sig = s.alloc(int(v))
        s.bits(sig, 64)
        return sig

    # ---- proof witness signals -----------------------------------------
    roots = [s.alloc(int(r)) for r in proof.roots]
    evals = [[alloc_gl(x) for x in e] for e in proof.evals]
    final_pol = [[alloc_gl(x) for x in row]
                 for row in np.asarray(proof.final_pol)]

    # ---- 1. transcript replay ------------------------------------------
    t = _Transcript(s)
    t.put([VK])
    t.put(PUBS)
    challenges = [None] * 8
    t.put([roots[0]])
    challenges[0] = t.get_field3()
    challenges[1] = t.get_field3()
    t.put([roots[1]])
    challenges[2] = t.get_field3()
    challenges[3] = t.get_field3()
    t.put([roots[2]])
    challenges[4] = t.get_field3()
    t.put([roots[3]])
    challenges[7] = t.get_field3()
    for e in evals:
        t.put(e)
    challenges[5] = t.get_field3()
    challenges[6] = t.get_field3()
    fri_roots = [s.alloc(int(proof.fri[si].root))
                 for si in range(1, len(steps))]
    special_xs = []
    for si in range(len(steps)):
        special_xs.append(t.get_field3())
        if si < len(steps) - 1:
            t.put([fri_roots[si]])
        else:
            for row in final_pol:
                t.put(row)

    # query indices: bit signals straight from the transcript — they key
    # every multiplexer below (the FIXED-circuit route)
    qbits = t.get_permutation_bits(s0.n_queries, steps[0])

    # ---- 2. quotient identity at xi ------------------------------------
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
            # publics are u64-range field values carried as circuit publics
            return [PUBS[node.idx], _zero(s), _zero(s)]
        if isinstance(node, ex.X):
            return xi
        raise TypeError(f"unbound node {type(node)} in c_combined")

    c_at_xi = _eval_dag(s, s0.c_combined, bind_main)

    # xi^n by repeated squaring
    xi_pow = xi
    for _ in range(s0.n_bits):
        xi_pow = gd.gl3_mul(s, xi_pow, xi_pow)
    q_at_xi = _const3(s, 0)
    acc = _const3(s, 1)
    for pi, qid in enumerate(s0.q_ids):
        term = gd.gl3_mul(s, acc, ev_of[("cm", qid, False)])
        q_at_xi = gd.gl3_add(s, q_at_xi, term)
        if pi + 1 < len(s0.q_ids):
            acc = gd.gl3_mul(s, acc, xi_pow)
    zh = gd.gl3_sub(s, xi_pow, _const3(s, 1))
    gd.gl3_assert_eq(s, c_at_xi, gd.gl3_mul(s, q_at_xi, zh))

    # ---- 3+4. Merkle openings and the FRI chain ------------------------
    w_ext = gl.w(steps[0])
    shift = gl.shift()
    col_of = dict(enumerate(s0.cols))

    for qi in range(s0.n_queries):
        bits0 = qbits[qi]
        qrow = proof.fri[0].queries[qi]
        # x = shift · w^y as a bit-keyed power product
        x_sig = gd.gl_pow_bits(s, w_ext, bits0)
        x_sig = gd.gl_mul(s, x_sig, _const_sig(s, shift))
        x3 = [x_sig, _zero(s), _zero(s)]

        tree_sigs = []
        for ti in range(5):
            mq = qrow[ti]
            row_sigs = [alloc_gl(v) for v in np.asarray(mq.values)]
            sib_sigs = [[s.alloc(int(x)) for x in np.asarray(level)]
                        for level in mq.siblings]
            root_sig = roots[ti] if ti < 4 else VK
            _merkle_path(s, row_sigs, sib_sigs, bits0, root_sig)
            tree_sigs.append(row_sigs)

        def bind_fri(node, _tree_sigs=tree_sigs, _x3=x3, _xs=x_sig):
            if isinstance(node, ex.Cm):
                assert not node.prime
                info = col_of[node.id]
                vals = _tree_sigs[info.stage - 1]
                if info.dim == 1:
                    return [vals[info.pos], _zero(s), _zero(s)]
                return vals[info.pos:info.pos + 3]
            if isinstance(node, ex.Const):
                assert not node.prime
                return [_tree_sigs[4][node.id], _zero(s), _zero(s)]
            if isinstance(node, ex.Challenge):
                return challenges[node.idx]
            if isinstance(node, ex.Public):
                return [PUBS[node.idx], _zero(s), _zero(s)]
            if isinstance(node, ex.X):
                return _x3
            if isinstance(node, ex.Eval):
                return evals[node.idx]
            if isinstance(node, ex.XDivXSubXi):
                d = gd.gl3_sub(s, _x3, xi)
                return gd.gl3_mul_base_sig(s, gd.gl3_inv(s, d), _xs)
            if isinstance(node, ex.XDivXSubWXi):
                wxi = gd.gl3_muls(s, xi, gl.w(s0.n_bits))
                d = gd.gl3_sub(s, _x3, wxi)
                return gd.gl3_mul_base_sig(s, gd.gl3_inv(s, d), _xs)
            raise TypeError(f"unbound node {type(node)} in fri_exp")

        value = _eval_dag(s, s0.fri_exp, bind_fri)

        # FRI fold chain: group positions and fold points are bit-keyed
        for si in range(1, len(steps)):
            mq = proof.fri[si].queries[qi]
            group = np.asarray(mq.values).reshape(-1, 3)
            group_sigs = [[alloc_gl(v) for v in row] for row in group]
            sib_sigs = [[s.alloc(int(x)) for x in np.asarray(level)]
                        for level in mq.siblings]
            y_bits = bits0[:steps[si]]
            _merkle_path(s, [x for row in group_sigs for x in row],
                         sib_sigs, y_bits, fri_roots[si - 1])
            pos_bits = bits0[steps[si]:steps[si - 1] if si > 1
                             else steps[0]]
            sel = gd.gl3_mux(s, pos_bits, group_sigs)
            gd.gl3_assert_eq(s, sel, value)
            value = _fold_gadget(s, group_sigs, steps[si - 1], steps[si],
                                 y_bits, special_xs[si], s0.n_bits_ext)
        last_bits = bits0[:steps[-1]]
        sel = gd.gl3_mux(s, last_bits, final_pol)
        gd.gl3_assert_eq(s, sel, value)

    # ---- 5. final polynomial low-degree --------------------------------
    last_bits = steps[-1]
    max_deg = 1 << (last_bits - (s0.n_bits_ext - s0.n_bits))
    m = 1 << last_bits
    w_last = gl.w(last_bits)
    w_inv = pow(w_last, rm.P - 2, rm.P)
    n_inv = pow(m, rm.P - 2, rm.P)
    for k in range(max_deg, m):
        for limb in range(3):
            terms = [(pow(w_inv, (j * k) % m, rm.P) * n_inv % rm.P,
                      final_pol[j][limb]) for j in range(m)]
            gd.gl_assert_zero(s, gd.gl_lincomb(s, terms))


def build(setup, verkey, proof):
    """Synthesize the FIXED verifier circuit, witnessed with one proof.

    Returns (r1cs, witness, circuit_publics) with circuit_publics =
    [verkey, *stark_publics]. The r1cs depends only on the STARK shape —
    re-witnessing with another proof of the same shape reuses it."""
    s0 = setup
    assert getattr(s0, "hash_type", "GL") == "BN128", \
        "the recursive circuit verifies BN128-scheme proofs (recursiveF)"
    assert proof.hash_type == "BN128"
    n_pub = 1 + len(proof.publics)

    s = Synthesizer(n_public=n_pub)
    verkey_i = int(verkey)
    s.set_public(0, verkey_i)
    for i, p in enumerate(proof.publics):
        s.set_public(1 + i, int(p))
    VK = 1
    PUBS = [2 + i for i in range(len(proof.publics))]
    _verify_proof(s, s0, VK, PUBS, proof)
    r1cs, w = s.finish()
    return r1cs, w, [verkey_i] + [int(p) for p in proof.publics]


def build_join(items, chain: list | None = None):
    """The recursive2 role: ONE circuit verifying several child proofs,
    with optional publics-chaining equalities.

    items: [(setup, verkey, proof)] — setups may differ (multi-SM
    batches join all their machines in one circuit).
    chain: [(child_a, pub_idx_a, child_b, pub_idx_b)] — constrain
    items[a].publics[ia] == items[b].publics[ib] (the reference's
    newStateRoot/oldStateRoot etc chaining, prover.cpp:700-740).

    Circuit publics: [verkey_0, ..., verkey_{K-1}, *publics_0, ...].
    """
    for s0, _, proof in items:
        assert getattr(s0, "hash_type", "GL") == "BN128"
        assert proof.hash_type == "BN128"
    pubs_per = [list(p.publics) for (_, _, p) in items]
    n_pub = len(items) + sum(len(p) for p in pubs_per)
    s = Synthesizer(n_public=n_pub)
    VKS = []
    for k, (_, verkey, _) in enumerate(items):
        s.set_public(k, int(verkey))
        VKS.append(1 + k)
    PUBS_ALL = []
    off = len(items)
    for pp in pubs_per:
        for i, v in enumerate(pp):
            s.set_public(off + i, int(v))
        PUBS_ALL.append([1 + off + i for i in range(len(pp))])
        off += len(pp)
    for (s0, _, proof), VK, PUBS in zip(items, VKS, PUBS_ALL):
        _verify_proof(s, s0, VK, PUBS, proof)
    for (a, ia, b, ib) in (chain or []):
        s.assert_eq(PUBS_ALL[a][ia], PUBS_ALL[b][ib])
    r1cs, w = s.finish()
    publics = [int(vk) for (_, vk, _) in items] \
        + [int(v) for pp in pubs_per for v in pp]
    return r1cs, w, publics


_zero_cache: dict = {}


def _zero(s: Synthesizer) -> int:
    z = _zero_cache.get(id(s))
    if z is None:
        z = s.alloc(0)
        s.b.constrain({z: 1}, {0: 1}, {0: 0})
        _zero_cache[id(s)] = z
    return z


def _const_sig(s: Synthesizer, v: int) -> int:
    sig = s.alloc(int(v) % P)
    s.b.constrain({sig: 1, 0: R - int(v) % P}, {0: 1}, {0: 0})
    return sig


def _fold_gadget(s: Synthesizer, group_sigs, from_bits, to_bits, y_bits,
                 special_x, n_bits_ext):
    """verifier._fold_point with gadget arithmetic: tiny INTT as
    constant-coefficient lincombs, then Horner in special_x scaled by
    shift^{-1}·w^{-y} — the w^{-y} power is bit-keyed (fixed circuit)."""
    n_x = 1 << (from_bits - to_bits)
    w_sub = gl.w(from_bits - to_bits)
    w_sub_inv = pow(w_sub, rm.P - 2, rm.P)
    n_inv = pow(n_x, rm.P - 2, rm.P)
    coefs = []
    for j in range(n_x):
        limbs = []
        for limb in range(3):
            terms = [(pow(w_sub_inv, (k * j) % n_x, rm.P) * n_inv % rm.P,
                      group_sigs[k][limb]) for k in range(n_x)]
            limbs.append(gd.gl_lincomb(s, terms))
        coefs.append(limbs)
    s_inv = pow(gl.shift_inv(), 1 << (n_bits_ext - from_bits), rm.P)
    w_from_inv = pow(gl.w(from_bits), rm.P - 2, rm.P)
    wg = gd.gl_pow_bits(s, w_from_inv, y_bits)
    sg = gd.gl_mul(s, wg, _const_sig(s, s_inv))
    factor = gd.gl3_mul_base_sig(s, special_x, sg)
    acc = _const3(s, 0)
    for c in reversed(coefs):
        acc = gd.gl3_add(s, gd.gl3_mul(s, acc, factor), c)
    return acc
