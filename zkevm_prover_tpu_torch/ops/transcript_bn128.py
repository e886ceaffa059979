"""Fiat-Shamir transcript over BN254 Fr (the recursiveF stage transcript).

Copy of `zkevm_prover_tpu/ops/transcript_bn128.py` (host-only).

Reference: src/starkpil/transcript/transcriptBN128.cpp — a 16-wide sponge
over Fr with Poseidon_opt at t=17.  Exact reference semantics:

  * `_updateState` permutes [state, p0..p15] (capacity FIRST,
    transcriptBN128.cpp:76-92) and keeps the WHOLE 17-element output as the
    squeezable buffer; state[0] is the new carried capacity.
  * GL challenges: each squeezed Fr yields its three low 64-bit limbs
    (getFields1, transcriptBN128.cpp:53-73); a 3-element cubic challenge
    is three limb pops (getField:34-39).
  * Query indices: fields are consumed 253 bits each
    (getPermutations:95-130).
"""

from __future__ import annotations

from . import poseidon_bn128 as pbn

P_GL = 0xFFFFFFFF_00000001
PENDING = 16


class TranscriptBN128:
    def __init__(self):
        self.state = 0
        self.pending: list[int] = []
        self.out: list[int] = []
        self.out3: list[int] = []

    def put(self, values) -> None:
        for v in values:
            self._add1(int(v) % pbn.R)

    def _update_state(self) -> None:
        inputs = self.pending + [0] * (PENDING - len(self.pending))
        self.out = pbn.permute([self.state] + inputs)
        self.pending = []
        self.out3 = []
        self.state = self.out[0]

    def _add1(self, v: int) -> None:
        self.pending.append(v)
        self.out = []
        if len(self.pending) == PENDING:
            self._update_state()

    def get_fr(self) -> int:
        """One 253-bit field element (reference getFields253)."""
        if not self.out:
            self._update_state()
        return self.out.pop(0)

    def _get_limb(self) -> int:
        """One 64-bit limb challenge (reference getFields1)."""
        if self.out3:
            return self.out3.pop(0)
        v = self.get_fr()
        self.out3 = [
            v & ((1 << 64) - 1),
            (v >> 64) & ((1 << 64) - 1),
            (v >> 128) & ((1 << 64) - 1),
        ]
        return self._get_limb()

    def get_field3(self) -> tuple[int, int, int]:
        """One GL cubic-extension challenge: three limb pops (getField)."""
        return (
            self._get_limb() % P_GL,
            self._get_limb() % P_GL,
            self._get_limb() % P_GL,
        )

    def get_permutations(self, n: int, n_bits: int) -> list[int]:
        total_bits = n * n_bits
        n_fields = (total_bits - 1) // 253 + 1
        fields = [self.get_fr() for _ in range(n_fields)]
        res = []
        cur_field = 0
        cur_bit = 0
        for _ in range(n):
            a = 0
            for j in range(n_bits):
                if (fields[cur_field] >> cur_bit) & 1:
                    a |= 1 << j
                cur_bit += 1
                if cur_bit == 253:
                    cur_bit = 0
                    cur_field += 1
            res.append(a)
        return res
