"""R1CS circuit representation and witness evaluation.

Copy of `zkevm_prover_tpu/snark/r1cs.py` (host Python).

Plays the role of the circom artifacts the reference loads (.r1cs/.dat and the
generated Circom_CalcWit witness calculators, src/starkpil/recursivefinal/
main.final.cpp:329): constraints (A·w)(B·w) = (C·w) over BN254 Fr with
w = (1, publics..., aux...).
"""

from __future__ import annotations

import dataclasses

from ..ops.bn254 import R


@dataclasses.dataclass
class R1CS:
    """Sparse R1CS: each constraint is three {signal_index: coeff} maps."""

    n_public: int                 # public inputs (excluding the constant 1)
    n_signals: int                # total signals incl. slot 0 == constant 1
    constraints: list             # [(A: dict, B: dict, C: dict)]

    @classmethod
    def builder(cls, n_public: int):
        return _Builder(n_public)

    def eval_lc(self, lc: dict, w: list[int]) -> int:
        return sum(c * w[i] for i, c in lc.items()) % R

    def is_satisfied(self, w: list[int]) -> bool:
        assert len(w) == self.n_signals and w[0] == 1
        for a, b, c in self.constraints:
            if self.eval_lc(a, w) * self.eval_lc(b, w) % R != self.eval_lc(c, w):
                return False
        return True


class _Builder:
    """Tiny circuit builder (allocate signals, add constraints)."""

    def __init__(self, n_public: int):
        self.n_public = n_public
        self.n_signals = 1 + n_public  # slot 0 = const 1, then publics
        self.constraints: list = []

    def alloc(self) -> int:
        idx = self.n_signals
        self.n_signals += 1
        return idx

    def constrain(self, a: dict, b: dict, c: dict) -> None:
        self.constraints.append((
            {i: v % R for i, v in a.items()},
            {i: v % R for i, v in b.items()},
            {i: v % R for i, v in c.items()},
        ))

    def mul(self, x: int, y: int) -> int:
        """z = x·y with one constraint; returns the new signal index."""
        z = self.alloc()
        self.constrain({x: 1}, {y: 1}, {z: 1})
        return z

    def build(self) -> R1CS:
        return R1CS(self.n_public, self.n_signals, list(self.constraints))
