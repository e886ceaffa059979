"""AIR composition — prove several state machines in ONE eSTARK.

Port of `zkevm_prover_tpu/stark/compose.py` over the port's `AIR`.

Reference: the zkEVM proves a single 2^23-row trace holding every SM's
columns side by side (pols_generated/commit_pols.hpp packs Main, Memory,
Binary, ... into one buffer), which is what makes *inter-SM* plookup /
permutation arguments possible: they need shared transcript challenges.

`CombinedAIR` merges sub-AIRs built at a common domain size: committed and
constant columns are concatenated (ids remapped through the expression
DAG), constraints and in-SM arguments carried over, and the caller then
declares the cross-SM bindings (e.g. Main's mOp rows ≙ Memory's access
rows) as ordinary lookups/permutations over the merged handles — exactly
the reference's `sel {cols} is sel' {cols'}` PIL idioms.
"""

from __future__ import annotations

import numpy as np

from . import expr as ex
from .air import AIR


def _remap(e: ex.Expr, cm_off: int, const_off: int, pub_off: int) -> ex.Expr:
    if isinstance(e, ex.Cm):
        return ex.Cm(e.id + cm_off, e.prime)
    if isinstance(e, ex.Const):
        return ex.Const(e.id + const_off, e.prime)
    if isinstance(e, ex.Public):
        return ex.Public(e.idx + pub_off)
    if isinstance(e, ex.Add):
        return ex.Add(_remap(e.a, cm_off, const_off, pub_off),
                      _remap(e.b, cm_off, const_off, pub_off))
    if isinstance(e, ex.Sub):
        return ex.Sub(_remap(e.a, cm_off, const_off, pub_off),
                      _remap(e.b, cm_off, const_off, pub_off))
    if isinstance(e, ex.Mul):
        return ex.Mul(_remap(e.a, cm_off, const_off, pub_off),
                      _remap(e.b, cm_off, const_off, pub_off))
    if isinstance(e, ex.Neg):
        return ex.Neg(_remap(e.a, cm_off, const_off, pub_off))
    return e  # Number / X / challenges are position-free


class CombinedAIR(AIR):
    """An AIR assembled from named sub-AIRs sharing one domain."""

    def __init__(self, name: str, n_bits: int):
        super().__init__(name, n_bits)
        self._spans: dict[str, tuple[int, int]] = {}  # name -> (cm_off, n_cm)

    def add(self, name: str, sub: AIR) -> None:
        assert sub.n_bits == self.n_bits, \
            f"{name}: domain 2^{sub.n_bits} != combined 2^{self.n_bits}"
        cm_off = len(self.cm_names)
        const_off = len(self.const_names)
        pub_off = len(self.publics)
        self._spans[name] = (cm_off, len(sub.cm_names))

        self.cm_names += [f"{name}.{nm}" for nm in sub.cm_names]
        self.const_names += [f"{name}.{nm}" for nm in sub.const_names]
        self.const_values += list(sub.const_values)
        self.publics += [(f"{name}.{nm}", cid + cm_off, row)
                         for (nm, cid, row) in sub.publics]

        r = lambda e: _remap(e, cm_off, const_off, pub_off)
        self.constraints += [r(c) for c in sub.constraints]
        for lk in sub.lookups:
            self.lookup([r(f) for f in lk.f], [r(t) for t in lk.t],
                        sel_f=r(lk.sel_f) if lk.sel_f is not None else None,
                        sel_t=r(lk.sel_t) if lk.sel_t is not None else None)
        for pe in sub.permutations:
            self.permutation(
                [r(f) for f in pe.f], [r(t) for t in pe.t],
                sel_f=r(pe.sel_f) if pe.sel_f is not None else None,
                sel_t=r(pe.sel_t) if pe.sel_t is not None else None)
        for cn in sub.connections:
            self.connection([r(p) for p in cn.pols],
                            [r(s) for s in cn.sigmas])

    def cm(self, sm: str, col: str) -> ex.Cm:
        """Handle to sub-AIR `sm`'s committed column `col`."""
        return ex.Cm(self.cm_names.index(f"{sm}.{col}"))

    def const(self, sm: str, col: str) -> ex.Const:
        return ex.Const(self.const_names.index(f"{sm}.{col}"))

    def stack_traces(self, traces: dict[str, np.ndarray]) -> np.ndarray:
        """Horizontally assemble sub-SM traces in registration order."""
        n = 1 << self.n_bits
        out = np.zeros((n, len(self.cm_names)), dtype=np.uint64)
        for name, (off, width) in self._spans.items():
            tr = traces[name]
            assert tr.shape == (n, width), \
                f"{name}: trace {tr.shape} != ({n}, {width})"
            out[:, off:off + width] = tr
        return out
