"""R1CS gadgets for the recursive STARK-verifier circuit.

Copy of `zkevm_prover_tpu/snark/gadgets.py` (host Python) over the port's
BN128 Poseidon and reference model.

Reference: the recursive circom circuits (stark_verifier.circom templates
compiled into src/starkpil/starkRecursive*/ witness calculators). These
gadgets are their building blocks re-implemented over our R1CS builder:

  * Poseidon-BN128 permutation (native Fr arithmetic — the reason the
    recursiveF stage re-proves with the BN128 commitment scheme),
  * arity-16 Merkle path verification,
  * Goldilocks arithmetic embedded in Fr (mul with quotient/remainder
    decomposition and 64-bit range bits) for the FRI/eval algebra.

`Synthesizer` pairs the constraint builder with a witness vector so each
gadget both constrains and computes; circuits stay provable with
snark.groth16 / snark.plonk. Full verifier assembly (transcript replay,
query folding, composition check) is the recursion milestone tracked in
docs/RECURSION.md — these gadgets are its tested foundation.
"""

from __future__ import annotations

from ..ops import bn254, poseidon_bn128 as pbn
from .r1cs import R1CS

R = bn254.R
GL_P = 0xFFFFFFFF_00000001


class Synthesizer:
    """R1CS builder + witness values, kept in lockstep."""

    def __init__(self, n_public: int):
        self.b = R1CS.builder(n_public)
        self.w: list[int] = [1] + [0] * n_public

    def set_public(self, i: int, value: int) -> None:
        self.w[1 + i] = value % R

    def alloc(self, value: int) -> int:
        idx = self.b.alloc()
        assert idx == len(self.w)
        self.w.append(value % R)
        return idx

    def _lc_val(self, lc: dict) -> int:
        return sum(c * self.w[i] for i, c in lc.items()) % R

    def mul_lc(self, a: dict, b: dict) -> int:
        """z = (Σa)(Σb) — linear combinations are free in R1CS."""
        z = self.alloc(self._lc_val(a) * self._lc_val(b) % R)
        self.b.constrain(a, b, {z: 1})
        return z

    def lin(self, lc: dict) -> int:
        """Materialize a linear combination as a signal (1 constraint)."""
        z = self.alloc(self._lc_val(lc))
        self.b.constrain(lc, {0: 1}, {z: 1})
        return z

    def assert_eq(self, x: int, y: int) -> None:
        self.b.constrain({x: 1, y: R - 1}, {0: 1}, {0: 0})

    def assert_bool(self, x: int) -> None:
        self.b.constrain({x: 1}, {x: 1, 0: R - 1}, {0: 0})

    def bits(self, x: int, n: int) -> list[int]:
        """Decompose x into n bits (n+1 constraints); x must fit."""
        v = self.w[x]
        bs = []
        lc = {}
        for i in range(n):
            bi = self.alloc((v >> i) & 1)
            self.assert_bool(bi)
            bs.append(bi)
            lc[bi] = 1 << i
        lc[x] = R - 1
        self.b.constrain(lc, {0: 1}, {0: 0})
        return bs

    def finish(self):
        return self.b.build(), list(self.w)


# ---------------------------------------------------------------------------
# Poseidon-BN128 permutation gadget
# ---------------------------------------------------------------------------


def poseidon_bn128_permute(s: Synthesizer, state: list[int]) -> list[int]:
    """Constrain one Poseidon permutation (width = len(state), the
    reference's circomlib-opt schedule, ops/poseidon_bn128.permute);
    state = signal ids.  Only the x^5 S-boxes cost constraints
    (3 each; (8·t + nRoundsP)·3 total — 612 at t=17): the ark / MDS /
    sparse-partial layers stay in linear-combination space."""
    t = len(state)
    C, M, Pm, S, rp = pbn._tables(t)
    half = pbn.ROUNDS_F // 2

    def sbox_lc(lc: dict) -> int:
        x2 = s.mul_lc(lc, lc)
        x4 = s.mul_lc({x2: 1}, {x2: 1})
        return s.mul_lc({x4: 1}, lc)

    def lc_add_const(lc: dict, c: int) -> dict:
        out = dict(lc)
        out[0] = (out.get(0, 0) + c) % R
        return out

    def lc_scale_into(acc: dict, lc: dict, m: int) -> None:
        for sig, coef in lc.items():
            acc[sig] = (acc.get(sig, 0) + m * coef) % R

    def mix(cur: list[dict], matrix) -> list[dict]:
        # reference orientation: out_i = Σ_j matrix[j][i]·s_j
        nxt = []
        for i in range(t):
            acc: dict = {}
            for j in range(t):
                lc_scale_into(acc, cur[j], matrix[j][i])
            nxt.append(acc)
        return nxt

    cur: list[dict] = [{sig: 1} for sig in state]
    cur = [lc_add_const(cur[i], C[i]) for i in range(t)]
    for r in range(half - 1):
        cur = [{sbox_lc(lc): 1} for lc in cur]
        cur = [lc_add_const(cur[i], C[(r + 1) * t + i]) for i in range(t)]
        cur = mix(cur, M)
    cur = [{sbox_lc(lc): 1} for lc in cur]
    cur = [lc_add_const(cur[i], C[half * t + i]) for i in range(t)]
    cur = mix(cur, Pm)
    for r in range(rp):
        s0 = lc_add_const({sbox_lc(cur[0]): 1}, C[(half + 1) * t + r])
        new0: dict = {}
        lc_scale_into(new0, s0, S[(2 * t - 1) * r])
        for j in range(1, t):
            lc_scale_into(new0, cur[j], S[(2 * t - 1) * r + j])
        nxt = [new0]
        for j in range(1, t):
            acc = dict(cur[j])
            lc_scale_into(acc, s0, S[(2 * t - 1) * r + t + j - 1])
            nxt.append(acc)
        cur = nxt
    for r in range(half - 1):
        cur = [{sbox_lc(lc): 1} for lc in cur]
        cur = [lc_add_const(cur[i], C[(half + 1) * t + rp + r * t + i])
               for i in range(t)]
        cur = mix(cur, M)
    cur = [{sbox_lc(lc): 1} for lc in cur]
    cur = mix(cur, M)
    return [s.lin(lc) for lc in cur]


def poseidon_hash16(s: Synthesizer, inputs: list[int],
                    capacity: int | None = None) -> int:
    """Arity-16 compression gadget: 16 signals (+ capacity signal) -> 1."""
    cap = capacity if capacity is not None else s.alloc(0)
    if capacity is None:
        s.b.constrain({cap: 1}, {0: 1}, {0: 0})  # capacity pinned to 0
    # capacity-first state, matching merkleTreeBN128.cpp:121-127
    return poseidon_bn128_permute(s, [cap] + list(inputs))[0]


def poseidon_hash_partial(s: Synthesizer, inputs: list[int],
                          capacity: int | None = None) -> int:
    """Short-chunk compression at width len(inputs)+1 — the reference's
    variable-width tail hash (merkleTreeBN128.cpp:130-136,
    ops/poseidon_bn128.hash_partial)."""
    assert 1 <= len(inputs) <= 16
    cap = capacity if capacity is not None else s.alloc(0)
    if capacity is None:
        s.b.constrain({cap: 1}, {0: 1}, {0: 0})
    return poseidon_bn128_permute(s, [cap] + list(inputs))[0]


def merkle_path_arity16(s: Synthesizer, leaf: int, siblings: list[list[int]],
                        positions: list[int], root: int) -> None:
    """Verify an arity-16 Merkle path (the BN128 tree of ops/merkle_bn128).

    siblings[l] = 15 sibling signals at level l; positions[l] = the static
    child slot of the running hash (query indices are public in the STARK
    verifier, so the slots specialize the circuit instance).
    """
    cur = leaf
    for sibs, pos in zip(siblings, positions):
        children = list(sibs)
        children.insert(pos, cur)
        cur = poseidon_hash16(s, children)
    s.assert_eq(cur, root)


# ---------------------------------------------------------------------------
# Goldilocks arithmetic embedded in Fr
# ---------------------------------------------------------------------------


def gl_mul(s: Synthesizer, a: int, b: int) -> int:
    """r = a·b mod p_GL with committed quotient: a·b = q·p + r,
    q and r range-checked to 64 bits (~132 constraints).

    Note: r < 2^64 (not the canonical r < p) — canonicalize at circuit
    boundaries the way the reference's circom GL templates do.
    """
    t = s.w[a] * s.w[b] % R
    q_v, r_v = divmod(t, GL_P)
    q = s.alloc(q_v)
    r = s.alloc(r_v)
    # a·b - q·p - r = 0
    s.b.constrain({a: 1}, {b: 1}, {q: GL_P, r: 1})
    s.bits(q, 64)
    s.bits(r, 64)
    return r


def gl_add(s: Synthesizer, a: int, b: int) -> int:
    """r = a+b mod p_GL (one conditional subtraction via a carry bit)."""
    t = s.w[a] + s.w[b]
    carry_v, r_v = divmod(t, GL_P)
    carry = s.alloc(carry_v)
    r = s.alloc(r_v)
    s.assert_bool(carry)
    s.b.constrain({a: 1, b: 1, carry: R - GL_P, r: R - 1}, {0: 1}, {0: 0})
    s.bits(r, 64)
    return r


def gl3_mul(s: Synthesizer, a: list[int], b: list[int]) -> list[int]:
    """Cubic-extension mul (x³ = x + 1), nine gl_muls + reduction adds."""
    p = [[gl_mul(s, a[i], b[j]) for j in range(3)] for i in range(3)]
    # (a0+a1x+a2x²)(b0+b1x+b2x²) mod (x³ - x - 1)
    c0 = gl_add(s, p[0][0], gl_add(s, p[1][2], p[2][1]))
    c1 = gl_add(s, gl_add(s, p[0][1], p[1][0]),
                gl_add(s, gl_add(s, p[1][2], p[2][1]), p[2][2]))
    c2 = gl_add(s, gl_add(s, p[0][2], p[1][1]),
                gl_add(s, p[2][0], p[2][2]))
    return [c0, c1, c2]


def gl_lincomb(s: Synthesizer, terms: list, const: int = 0) -> int:
    """r = (const + Σ c_i·v_i) mod p_GL, one reduction for the whole sum.

    terms: [(coeff_int, signal)]. Total < (1+len)·p² keeps the quotient
    within 64+log2(len)+1 bits.
    """
    t = (const + sum(c * s.w[v] for c, v in terms)) % R
    q_v, r_v = divmod(t, GL_P)
    q = s.alloc(q_v)
    r = s.alloc(r_v)
    lc = {v: c % R for c, v in terms}
    lc[q] = (lc.get(q, 0) + R - GL_P) % R
    lc[r] = (lc.get(r, 0) + R - 1) % R
    lc[0] = (lc.get(0, 0) + const) % R
    s.b.constrain(lc, {0: 1}, {0: 0})
    qbits = 65 + max(1, len(terms)).bit_length()
    s.bits(q, qbits)
    s.bits(r, 64)
    return r


def gl_sub(s: Synthesizer, a: int, b: int) -> int:
    return gl_lincomb(s, [(1, a), (GL_P - 1, b)])


def gl3_add(s: Synthesizer, a: list[int], b: list[int]) -> list[int]:
    return [gl_add(s, a[i], b[i]) for i in range(3)]


def gl3_sub(s: Synthesizer, a: list[int], b: list[int]) -> list[int]:
    return [gl_sub(s, a[i], b[i]) for i in range(3)]


def gl3_muls(s: Synthesizer, a: list[int], c: int) -> list[int]:
    """GL3 times a constant base-field scalar."""
    return [gl_lincomb(s, [(c % GL_P, a[i])]) for i in range(3)]


def gl_assert_zero(s: Synthesizer, a: int) -> None:
    """a ≡ 0 mod p_GL for a < 2^64: a ∈ {0, p} ⟺ a·(a-p) = 0."""
    s.b.constrain({a: 1}, {a: 1, 0: R - GL_P}, {0: 0})


def gl_assert_eq(s: Synthesizer, a: int, b: int) -> None:
    gl_assert_zero(s, gl_sub(s, a, b))


def gl3_assert_eq(s: Synthesizer, a: list[int], b: list[int]) -> None:
    for i in range(3):
        gl_assert_eq(s, a[i], b[i])


def gl_inv(s: Synthesizer, a: int) -> int:
    """Witness inverse with in-circuit check a·ai ≡ 1 (a nonzero)."""
    v = s.w[a] % GL_P
    ai = s.alloc(pow(v, GL_P - 2, GL_P))
    s.bits(ai, 64)
    one = gl_mul(s, a, ai)
    gl_assert_zero(s, gl_lincomb(s, [(1, one)], GL_P - 1))  # one - 1 ≡ 0
    return ai


def gl3_inv(s: Synthesizer, a: list[int]) -> list[int]:
    """Witness GL3 inverse checked by a full gl3_mul == (1,0,0)."""
    from ..ops import refmodel as rm

    av = tuple(s.w[x] % GL_P for x in a)
    iv = rm.inv3(av)
    inv = [s.alloc(int(v)) for v in iv]
    for x in inv:
        s.bits(x, 64)
    prod = gl3_mul(s, a, inv)
    gl_assert_zero(s, gl_lincomb(s, [(1, prod[0])], GL_P - 1))
    gl_assert_zero(s, prod[1])
    gl_assert_zero(s, prod[2])
    return inv


def mux_tree(s: Synthesizer, bits: list[int], values: list) -> dict:
    """2^k-way multiplexer as a binary select tree keyed on LSB-first bit
    signals — the fixed-circuit replacement for instance-specialized
    indices (reference: circom's Multiplexor over query bits).

    values: signal ids or lc dicts; len must be 2^len(bits). Returns the
    selected value as an lc dict (2^k - 1 mul constraints, no lins)."""
    cur = [v if isinstance(v, dict) else {v: 1} for v in values]
    assert len(cur) == 1 << len(bits)
    for b in bits:
        nxt = []
        for j in range(0, len(cur), 2):
            lo, hi = cur[j], cur[j + 1]
            diff = dict(hi)
            for k, c in lo.items():
                diff[k] = (diff.get(k, 0) - c) % R
            t = s.mul_lc({b: 1}, diff)  # b·(hi - lo)
            out = dict(lo)
            out[t] = (out.get(t, 0) + 1) % R
            nxt.append(out)
        cur = nxt
    return cur[0]


def mux_sig(s: Synthesizer, bits: list[int], values: list) -> int:
    return s.lin(mux_tree(s, bits, values))


def gl3_mux(s: Synthesizer, bits: list[int], triples: list) -> list[int]:
    return [mux_sig(s, bits, [t[l] for t in triples]) for l in range(3)]


def gl3_mul_base_sig(s: Synthesizer, a: list[int], b: int) -> list[int]:
    """GL3 × base-field SIGNAL (gl3_muls takes a constant)."""
    return [gl_mul(s, a[l], b) for l in range(3)]


def gl_pow_bits(s: Synthesizer, base: int, bits: list[int]) -> int:
    """base^y for a constant GL base and LSB-first bit signals: the
    product of per-bit factors (1 + b_j·(base^{2^j} - 1)), each a free
    linear combination feeding one gl-reduced multiply."""
    acc = None
    cur = base % GL_P
    for b in bits:
        factor = s.lin({0: 1, b: (cur - 1) % R})
        acc = factor if acc is None else gl_mul(s, acc, factor)
        cur = cur * cur % GL_P
    if acc is None:
        acc = s.lin({0: 1})
    return acc


def gl_canon(s: Synthesizer, a: int) -> int:
    """Reduce a (< 2^64) to the canonical residue < p_GL."""
    return gl_lincomb(s, [(1, a)])


def fr_bits_canonical(s: Synthesizer, v: int) -> list[int]:
    """Decompose v into 254 bits AND constrain the bit string to be the
    canonical representative (< r) — circom's Num2Bits_strict role.

    Without the comparison, any v with v + r < 2^254 (~32% of field
    elements) admits a second valid decomposition (the bits of v + r), so
    a malicious witness could substitute alternate transcript challenges
    and query-index bits.  Big-endian comparator chain against r - 1:
    maintain eq = "prefix equal so far" and lt = "already strictly less";
    final constraint lt + eq = 1.
    """
    bs = s.bits(v, 254)
    c = R - 1
    eq_lc: dict = {0: 1}          # starts true (constant 1)
    lt_terms: list[int] = []      # one-hot contribution signals
    for i in range(253, -1, -1):
        ci = (c >> i) & 1
        if ci:
            # lt += eq AND (NOT x_i);  eq &= x_i
            lt_terms.append(s.mul_lc(eq_lc, {0: 1, bs[i]: R - 1}))
            eq_lc = {s.mul_lc(eq_lc, {bs[i]: 1}): 1}
        else:
            # eq &= NOT x_i (x_i = 1 here can only mean "greater")
            eq_lc = {s.mul_lc(eq_lc, {0: 1, bs[i]: R - 1}): 1}
    final = dict(eq_lc)
    for t in lt_terms:
        final[t] = (final.get(t, 0) + 1) % R
    final[0] = (final.get(0, 0) + R - 1) % R
    s.b.constrain(final, {0: 1}, {0: 0})
    return bs


def gl_reduce_bits(s: Synthesizer, limb_bits: list[int]) -> int:
    """Canonical reduction of a 64-bit value (given as bit signals) mod
    p_GL: r = x - q·p with q ∈ {0,1} and r < p.  The r < p check uses
    p = 2^64 - 2^32 + 1: r < p ⟺ NOT(top-32 bits all ones AND low 32
    bits nonzero)."""
    assert len(limb_bits) == 64
    x = 0
    for i, b in enumerate(limb_bits):
        x |= (s.w[b] & 1) << i
    q_v = 1 if x >= GL_P else 0
    q = s.alloc(q_v)
    s.assert_bool(q)
    rem = s.alloc(x - q_v * GL_P)
    lc = {b: 1 << i for i, b in enumerate(limb_bits)}
    lc[q] = (lc.get(q, 0) + R - GL_P) % R
    lc[rem] = (lc.get(rem, 0) + R - 1) % R
    s.b.constrain(lc, {0: 1}, {0: 0})
    rbs = s.bits(rem, 64)
    allhi_lc: dict = {rbs[63]: 1}
    for i in range(62, 31, -1):
        allhi_lc = {s.mul_lc(allhi_lc, {rbs[i]: 1}): 1}
    lo_lc = {rbs[i]: 1 << i for i in range(32)}
    s.b.constrain(allhi_lc, lo_lc, {0: 0})
    return rem


def fr_to_limbs64(s: Synthesizer, v: int) -> list[int]:
    """TranscriptBN128 limb carving in-circuit (getFields1,
    transcriptBN128.cpp:53-73): the squeezed Fr element yields its three
    low 64-bit limbs, each reduced canonically mod p_GL."""
    bs = fr_bits_canonical(s, v)
    return [gl_reduce_bits(s, bs[64 * k : 64 * k + 64]) for k in range(3)]
