"""proof2zkin — convert a STARK proof into recursion-circuit input JSON.

Copy of `zkevm_prover_tpu/stark/proof2zkin.py` (host-only).

Reference: src/starkpil/fri/proof2zkinStark.cpp:6-60 — the zkin JSON feeds
the circom verifier circuit of the next recursion layer: per FRI step s,
s{i}_root / s{i}_vals{tree} / s{i}_siblings{tree}, plus evals, publics and
the final polynomial. publics2zkin (src/prover/proof2zkin.cpp) adds the
aggregator fields (rootC).
"""

from __future__ import annotations

import numpy as np


def proof2zkin(proof) -> dict:
    """StarkProof -> zkin dict (the reference's JSON field naming)."""
    zkin: dict = {}
    q0 = proof.fri[0].queries
    n_trees = len(q0[0]) if q0 else 0
    for t in range(n_trees):
        zkin[f"s0_vals{t + 1}"] = [
            [int(v) for v in q[t].values] for q in q0
        ]
        zkin[f"s0_siblings{t + 1}"] = [
            [[int(x) for x in sib] for sib in q[t].siblings] for q in q0
        ]
    for i, r in enumerate(proof.roots):
        zkin[f"root{i + 1}"] = [int(v) for v in r]
    for si in range(1, len(proof.fri)):
        layer = proof.fri[si]
        zkin[f"s{si}_root"] = [int(v) for v in np.asarray(layer.root)]
        zkin[f"s{si}_vals"] = [[int(v) for v in q.values] for q in layer.queries]
        zkin[f"s{si}_siblings"] = [
            [[int(x) for x in sib] for sib in q.siblings] for q in layer.queries
        ]
    zkin["evals"] = [list(e) for e in proof.evals]
    zkin["finalPol"] = [[int(v) for v in row] for row in np.asarray(proof.final_pol)]
    zkin["publics"] = [int(p) for p in proof.publics]
    return zkin


def publics2zkin(zkin: dict, publics: list[int], root_c: list[int]) -> dict:
    """Attach aggregator verification-key root (reference publics2zkin)."""
    out = dict(zkin)
    out["publics"] = [int(p) for p in publics]
    out["rootC"] = [int(v) for v in root_c]
    return out
