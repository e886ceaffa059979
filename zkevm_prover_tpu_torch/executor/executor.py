"""Executor coordinator — run the co-processor SMs over an action batch and
prove each one with its own eSTARK.

Counterpart of `zkevm_prover_tpu/executor/executor.py` (reference:
src/executor/executor.cpp:487-610). hashp actions fill no trace here, as in
the JAX package: their byte stream (PaddingPGByte) is proved only inside
the combined AIR (`executor/combined.py`), bound to Main and PaddingPG.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .. import resolve_device
from ..stark.prover import StarkProver
from ..stark.setup import StarkSetup
from ..stark.verifier import verify
from .sm import (arith, binary, climb_key, keccak_circuit, keccak_f,
                 mem_align, memory, padding_kk, padding_pg, padding_sha256,
                 poseidon_g, sha256_circuit, sha256_f, storage)


@dataclasses.dataclass
class BatchActions:
    """The "required actions" a main-execution pass emits for co-processors
    (reference: MainExecRequired vectors, main_executor.cpp)."""

    binary: list = dataclasses.field(default_factory=list)
    memory: list = dataclasses.field(default_factory=list)
    arith: list = dataclasses.field(default_factory=list)
    mem_align: list = dataclasses.field(default_factory=list)
    poseidon_g: list = dataclasses.field(default_factory=list)
    padding_pg: list = dataclasses.field(default_factory=list)
    climb_key: list = dataclasses.field(default_factory=list)
    storage: list = dataclasses.field(default_factory=list)
    keccak: list = dataclasses.field(default_factory=list)
    sha256: list = dataclasses.field(default_factory=list)
    hashp: list = dataclasses.field(default_factory=list)


# in execution order: storage first, since it emits poseidon_g and climb_key
# actions; then the padding SMs, as in the JAX package
_SM_MODULES = {"storage": storage, "padding_kk": padding_kk,
               "padding_sha256": padding_sha256, "binary": binary,
               "memory": memory, "arith": arith, "mem_align": mem_align,
               "poseidon_g": poseidon_g, "padding_pg": padding_pg,
               "climb_key": climb_key}

# the BatchActions field each SM takes, where it is not the SM's name
_ACTION_FIELD = {"padding_kk": "keccak", "padding_sha256": "sha256"}

# the gate SM each padding SM emits its permutation inputs for
_GATE_SM = {"padding_kk": "keccak_f", "padding_sha256": "sha256_f"}

# each gate SM's module and the function that builds its circuit
_GATES = {"keccak_f": (keccak_f, keccak_circuit.build),
          "sha256_f": (sha256_f, sha256_circuit.build)}

# per-SM trace degree (the JAX package's defaults for the ported SMs); binary's
# nibble-semantics table needs 2816 rows
DEFAULT_BITS = {"binary": 13, "memory": 9, "arith": 9, "mem_align": 9,
                "poseidon_g": 9, "padding_pg": 9, "climb_key": 10,
                "main": 9, "storage": 9, "padding_kk": 11,
                "padding_sha256": 11}


class Executor:
    """Owns one AIR/setup/prover per SM (built lazily), all on `device`.

    `gates` configures the gate SMs that prove the padding SMs' emitted
    permutations ({"keccak_f" or "sha256_f": {"rounds", "pack",
    "limb_bits"}}, each with its log2 rows in `n_bits`): `execute_gates`
    fills their traces, and `prove_traces` and `verify_all` take them like
    any other SM. The JAX package's Executor has no gate SMs: it proves
    them in the combined AIR."""

    def __init__(self, n_bits: int | dict | None = None, n_queries: int = 8,
                 device=None, gates: dict | None = None):
        if n_bits is None:
            self.n_bits = dict(DEFAULT_BITS)
        elif isinstance(n_bits, int):
            self.n_bits = {k: n_bits for k in DEFAULT_BITS}
        else:
            self.n_bits = {**DEFAULT_BITS, **n_bits}
        self.n_queries = n_queries
        self.device = resolve_device(device)
        self.gates = dict(gates or {})
        self._provers: dict[str, StarkProver] = {}
        self._circuits: dict[str, object] = {}
        self.execute_times: dict[str, float] = {}
        self.air_times: dict[str, float] = {}
        self.emitted: dict[str, list] = {}
        self.digests: dict[str, list] = {}
        self._message_blocks: dict[str, int] = {}

    def binary_slice_bits(self) -> int:
        """Largest slice width whose semantics table fits the binary domain
        (28·4^s rows): 4-bit nibbles from 2^13 up, 2-bit below."""
        n = 1 << self.n_bits["binary"]
        s = 1
        while 28 * (4 ** (s + 1)) <= n and s < 4:
            s += 1
        return s

    def circuit(self, gate: str):
        """The gate circuit of a configured gate SM (built once)."""
        if gate not in self._circuits:
            self._circuits[gate] = _GATES[gate][1](self.gates[gate]["rounds"])
        return self._circuits[gate]

    def gate_capacity(self, gate: str) -> int:
        """Permutations a configured gate SM holds: pack per slot."""
        slots = (1 << self.n_bits[gate]) // self.circuit(gate).n_rows
        return slots * self.gates[gate]["pack"]

    def prover(self, name: str, hash_type: str = "GL") -> StarkProver:
        """The SM's prover under the `hash_type` commitment scheme, its AIR
        and setup built at first use (the AIR's host seconds in
        `air_times`)."""
        key = name if hash_type == "GL" else f"{name}:{hash_type}"
        if key not in self._provers:
            t0 = time.perf_counter()
            if name == "binary":
                air = binary.build_air(self.n_bits[name],
                                       self.binary_slice_bits())
            elif name in self.gates:
                cfg = self.gates[name]
                air = _GATES[name][0].build_air(
                    self.n_bits[name], self.circuit(name), cfg["pack"],
                    cfg["limb_bits"])
            else:
                air = _SM_MODULES[name].build_air(self.n_bits[name])
            self.air_times[name] = time.perf_counter() - t0
            setup = StarkSetup(air, n_queries=self.n_queries, fri_fold_bits=2,
                               hash_type=hash_type)
            self._provers[key] = StarkProver(setup, device=self.device)
        return self._provers[key]

    def execute(self, actions: BatchActions,
                db=None) -> dict[str, np.ndarray]:
        """Fill each SM's committed columns (reference: Executor::execute).

        Runs the Storage SM first: its tree-walk replay emits PoseidonG /
        ClimbKey requests that join the batch before those SMs fill their
        traces (the reference's Storage→ClimbKey / →PoseidonG dependency
        joins, executor.cpp:648-701). `db` is the hashdb database holding
        the trees the storage actions walk. Of the last call,
        `execute_times` holds the seconds of each SM's witness, `emitted`
        the gate-SM inputs the padding SMs emit ("keccak_f": Keccak-f
        inputs, "sha256_f": compressions, one per active block; as in the
        JAX package they are proved apart, by `keccak_f` and `sha256_f` at
        their own domains) and `digests` the padding SMs' message digests.
        hashp actions take no trace here (the combined AIR proves them).
        """
        if actions.storage and db is None:
            raise ValueError("storage actions require the hashdb database "
                             "(pass db=smt.db)")
        out = {}
        self.execute_times, self.emitted, self.digests = {}, {}, {}
        for name, mod in _SM_MODULES.items():   # storage first
            acts = getattr(actions, _ACTION_FIELD.get(name, name))
            if not acts:
                continue
            t0 = time.perf_counter()
            if name == "storage":
                out[name], emitted = storage.execute(acts, self.n_bits[name],
                                                     db)
                actions.poseidon_g = actions.poseidon_g + emitted["poseidon_g"]
                actions.climb_key = actions.climb_key + emitted["climb_key"]
            elif name in _GATE_SM:
                kw = {"device": self.device} if name == "padding_sha256" \
                    else {}
                out[name], self.emitted[_GATE_SM[name]], \
                    self.digests[name] = mod.execute(acts, self.n_bits[name],
                                                     **kw)
                self._message_blocks[_GATE_SM[name]] = sum(
                    mod.message_blocks(a["data"]) for a in acts)
            elif name == "binary":
                out[name] = binary.execute(acts, self.n_bits[name],
                                           self.binary_slice_bits())
            else:
                res = mod.execute(acts, self.n_bits[name])
                out[name] = res[0] if isinstance(res, tuple) else res
            self.execute_times[name] = time.perf_counter() - t0
        return out

    def execute_gates(self) -> dict[str, np.ndarray]:
        """Traces of the configured gate SMs from the permutation inputs the
        padding SMs emitted in the last `execute`: the blocks of the
        messages (not the filler blocks after them), up to the gate SM's
        capacity. `execute_times` gains each one's seconds."""
        out = {}
        for gate in self.gates:
            if gate not in self.emitted:
                continue
            t0 = time.perf_counter()
            used = min(self._message_blocks[gate], self.gate_capacity(gate))
            cfg = self.gates[gate]
            out[gate] = _GATES[gate][0].execute(
                self.emitted[gate][:used], self.n_bits[gate],
                self.circuit(gate), cfg["pack"], cfg["limb_bits"])
            self.execute_times[gate] = time.perf_counter() - t0
        return out

    def counters(self, actions: BatchActions) -> dict[str, int]:
        """SM usage counters (reference: batch resource counters,
        main.cpp:193-216) — drive upstream batch-capacity limits."""
        nb = self.n_bits
        return {
            "binary": len(actions.binary),
            "binary_capacity": (1 << nb["binary"])
            // binary.rows_per_op(self.binary_slice_bits()),
            "memory": len(actions.memory),
            "memory_capacity": 1 << nb["memory"],
            "arith": len(actions.arith),
            "arith_capacity": (1 << nb["arith"]) // arith.GROUP,
            "mem_align": len(actions.mem_align),
            "mem_align_capacity": (1 << nb["mem_align"]) // mem_align.GROUP,
            "poseidon_g": len(actions.poseidon_g),
            "poseidon_g_capacity": (1 << nb["poseidon_g"]) // poseidon_g.GROUP,
            "padding_pg": len(actions.padding_pg),
            "padding_pg_capacity": (1 << nb["padding_pg"]) // padding_pg.GROUP,
            "climb_key": len(actions.climb_key),
            "climb_key_capacity": (1 << nb["climb_key"])
            // (64 // climb_key.params_for(nb["climb_key"])[0]),
            # padding blocks the messages take (their data and the pad)
            "padding_kk": sum(padding_kk.message_blocks(a["data"])
                              for a in actions.keccak),
            "padding_kk_capacity": (1 << nb["padding_kk"]) // padding_kk.BLOCK,
            "padding_sha256": sum(padding_sha256.message_blocks(a["data"])
                                  for a in actions.sha256),
            "padding_sha256_capacity": (1 << nb["padding_sha256"])
            // padding_sha256.BLOCK,
        }

    def prove_all(self, actions: BatchActions,
                  db=None) -> dict[str, object]:
        """Prove every active SM; returns {name: (prover, proof)}."""
        return self.prove_traces(self.execute(actions, db=db))

    def prove_traces(self, traces: dict[str, np.ndarray],
                     hash_type: str = "GL") -> dict[str, object]:
        """Prove pre-computed commit pols (the resume half of the
        commit-pols checkpoint) under the `hash_type` scheme."""
        return {name: (self.prover(name, hash_type),
                       self.prover(name, hash_type).prove(tr))
                for name, tr in traces.items()}

    def prove_recursive(self, actions: BatchActions,
                        db=None) -> dict[str, object]:
        """The StarkRecursiveF role: re-prove every active SM under the
        BN128 commitment scheme so the proofs are verifiable inside the
        final SNARK circuit (reference starkRecursiveF, prover.cpp:868)."""
        return self.prove_traces(self.execute(actions, db=db),
                                 hash_type="BN128")

    # -- Main SM (ROM) path ------------------------------------------------

    def run_rom(self, rom, input: dict | None = None, smt=None):
        """Execute a zk-ASM ROM program (reference: fork_9 MainExecutor) —
        fills the Main trace and emits the co-processor action batch."""
        from .sm import main_sm

        return main_sm.MainExecutor(
            rom, self.n_bits["main"]).execute(input=input, smt=smt)

    def main_prover(self, rom) -> StarkProver:
        """Prover for the Main AIR bound to `rom` (cached per ROM object)."""
        from .sm import main_sm

        key = ("main", id(rom))
        if key not in self._provers:
            air = main_sm.build_air(rom, self.n_bits["main"])
            self._provers[key] = StarkProver(
                StarkSetup(air, n_queries=self.n_queries, fri_fold_bits=2),
                device=self.device)
        return self._provers[key]

    def prove_rom_batch(self, rom, input: dict | None = None,
                        smt=None) -> tuple[object, dict]:
        """Full batch proof from a ROM: Main proof + all dispatched co-SM
        proofs (reference: Executor::execute + Prover::genBatchProof)."""
        res = self.run_rom(rom, input=input, smt=smt)
        prover = self.main_prover(rom)
        proofs = {"main": (prover, prover.prove(res.trace))}
        proofs.update(self.prove_all(
            res.actions, db=smt.db if smt is not None else None))
        return res, proofs

    def verify_all(self, proofs: dict) -> bool:
        return all(verify(prover.setup, prover.verkey, proof,
                          device=self.device)
                   for prover, proof in proofs.values())
