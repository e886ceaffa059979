"""SHA-256 compression as an XOR/AND/ANDP gate circuit.

Reference: tools/sm/sha256/ (sha256_gen.cpp + the generated
config/scripts/sha256_gates.json script replayed by Sha256FExecutor). Like
the keccak circuit, it is built directly in Python: one wire per bit,
rotations/shifts free as re-indexing, 32-bit modular adders as ripple-carry
full-adder chains (5 gates/bit, the carry out of bit 31 dropped), round
constants as free ONE/ZERO wire references.

Input layout (Circuit.in_words=24, word_bits=32):
  words 0..7    the running hash state a..h
  words 8..23   the 16-word message block
Output: the 8 compressed state words (already including the feed-forward
state addition), so chaining blocks is output -> next state input.

`rounds` (≤ 64) scales the circuit down for test domains; the message
schedule is built only as far as the rounds need.

Port of `zkevm_prover_tpu/executor/sm/sha256_circuit.py`: the same circuit.
"""

from __future__ import annotations

import numpy as np

from ...ops.sha256 import _K, IV as _IV
from . import keccak_circuit as kc

W = 32  # word width


def build(rounds: int = 64) -> kc.Circuit:
    ops: list[int] = []
    a_src: list[tuple] = []
    b_src: list[tuple] = []

    def gate(op, a, b) -> tuple:
        ops.append(op)
        a_src.append(a)
        b_src.append(b)
        return (kc.C, len(ops) - 1)

    one = (kc.A, 0)
    zero = gate(kc.XOR, one, one)

    inputs = []
    in_words = []
    for i in range(24):
        word = [None] * W
        for z in range(W):
            w = gate(kc.XOR, (kc.A, len(ops)), zero)
            inputs.append(w[1])
            word[z] = w
        in_words.append(word)

    def xor(x, y):
        return gate(kc.XOR, x, y)

    def and_(x, y):
        return gate(kc.AND, x, y)

    def andp(x, y):
        return gate(kc.ANDP, x, y)

    def xor_w(x, y):
        return [xor(x[z], y[z]) for z in range(W)]

    def rotr(x, r):
        return [x[(z + r) % W] for z in range(W)]

    def shr(x, r):
        return [x[z + r] if z + r < W else zero for z in range(W)]

    def add_w(x, y):
        """32-bit modular add, ripple carry (bit z of the sum)."""
        out = [None] * W
        carry = None
        for z in range(W):
            t = xor(x[z], y[z])
            if carry is None:
                out[z] = t
                carry = and_(x[z], y[z])
            else:
                out[z] = xor(t, carry)
                if z < W - 1:
                    g = and_(x[z], y[z])
                    p = and_(t, carry)
                    carry = xor(g, p)
        return out

    def const_w(v: int):
        return [one if (v >> z) & 1 else zero for z in range(W)]

    state = in_words[:8]
    block = in_words[8:]

    # message schedule
    w = list(block)
    for t in range(16, rounds):
        s0 = xor_w(xor_w(rotr(w[t - 15], 7), rotr(w[t - 15], 18)),
                   shr(w[t - 15], 3))
        s1 = xor_w(xor_w(rotr(w[t - 2], 17), rotr(w[t - 2], 19)),
                   shr(w[t - 2], 10))
        w.append(add_w(add_w(w[t - 16], s0), add_w(w[t - 7], s1)))

    a, b, c, d, e, f, g, h = state
    for t in range(rounds):
        S1 = xor_w(xor_w(rotr(e, 6), rotr(e, 11)), rotr(e, 25))
        ch = [xor(and_(e[z], f[z]), andp(e[z], g[z])) for z in range(W)]
        t1 = add_w(add_w(add_w(h, S1), add_w(ch, const_w(int(_K[t])))),
                   w[t])
        S0 = xor_w(xor_w(rotr(a, 2), rotr(a, 13)), rotr(a, 22))
        maj = [xor(xor(and_(a[z], b[z]), and_(a[z], c[z])),
                   and_(b[z], c[z])) for z in range(W)]
        t2 = add_w(S0, maj)
        h, g, f, e = g, f, e, add_w(d, t1)
        d, c, b, a = c, b, a, add_w(t1, t2)

    final = [add_w(x, y) for x, y in zip((a, b, c, d, e, f, g, h), state)]
    outputs = [final[i][z] for i in range(8) for z in range(W)]
    return kc.Circuit(ops=np.array(ops, dtype=np.uint64), a_src=a_src,
                      b_src=b_src, inputs=inputs, outputs=outputs,
                      one=one, zero=zero, rounds=rounds,
                      in_words=24, word_bits=W, out_words=8)


def initial_state() -> np.ndarray:
    return np.array(_IV, dtype=np.uint64)
