"""Sha256F SM — bit-sliced SHA-256 compression over packed instances.

Reference: src/sm/sha256_f/ (gate-script replay generated by
tools/sm/sha256). Identical architecture to the KeccakF SM — per-limb gate
plookups (XOR/AND/ANDP here) + one PLONK connection for the wire graph —
so this module is a thin configuration of that machinery over the SHA
circuit (sha256_circuit.build).

Production parameters: pack 40 instances, 10-bit limbs (the 3-op table is
3·2^20 rows, fitting the 2^23 domain the full 124k-gate circuit needs).

Port of `zkevm_prover_tpu/executor/sm/sha256_f.py`: the same AIR and
trace, filled by keccak_f's vectorized slot evaluation.
"""

from __future__ import annotations

import numpy as np

from ...stark.air import AIR
from . import keccak_circuit as kc
from . import keccak_f as gate_sm

TABLE_OPS = (kc.XOR, kc.ANDP, kc.AND)


def build_air(n_bits: int, circ: kc.Circuit, pack: int,
              limb_bits: int) -> AIR:
    return gate_sm.build_air(n_bits, circ, pack, limb_bits,
                             table_ops=TABLE_OPS, name="sha256_f")


def execute(actions: list[dict], n_bits: int, circ: kc.Circuit, pack: int,
            limb_bits: int) -> np.ndarray:
    """actions: [{state: (8,) u32 words, block: (16,) u32 words}]."""
    states = _to_words(actions)
    n_slots = (1 << n_bits) // circ.n_rows
    assert len(states) <= pack * n_slots, "too many sha256 instances"
    return gate_sm._trace(states, n_bits, circ, pack, limb_bits)


def _to_words(actions) -> np.ndarray:
    if not actions:
        return np.zeros((0, 24), dtype=np.uint64)
    return np.array(
        [list(a["state"]) + list(a["block"]) for a in actions],
        dtype=np.uint64)


def digests(circ: kc.Circuit, actions: list[dict], pack: int) -> np.ndarray:
    """Oracle: compressed states, (k, 8) u32 words."""
    states = _to_words(actions)
    out = []
    for s in range(0, len(states), pack):
        out.append(kc.evaluate(circ, states[s:s + pack], pack))
    return np.concatenate(out) if out else np.zeros((0, 8), np.uint64)
