"""The Prover — request queue + proof pipeline orchestration.

Port of `zkevm_prover_tpu/prover/prover.py` less the final SNARK wrap:
`BatchProof`, `AggregatedProof`, `RecursiveNode`, `ProverRequest`, the
request queue (`submit_request`, `wait_for_request`, its thread),
`process_batch`, `gen_batch_proof` (the action-list path and the ROM path),
`gen_batch_proof_from_commit`, `compress_proof` (the batch re-proved under
BN128 commitments), the aggregation (`gen_aggregated_proof`,
`aggregate_tree`, `verify_aggregated_proof`), the recursion
(`wrap_batch_recursive`, `aggregate_recursive`, `verify_recursive`) and
`verify_batch_proof`, on `device` (CUDA unless told otherwise).
genFinalProof needs the SNARK wrap, not ported yet: its request raises.
`metrics` times each stage under the JAX package's labels
(EXECUTOR_EXECUTE_BATCH_PROOF, STARK_PROOF_BATCH_PROOF,
STARK_RECURSIVE_1_PROOF, STARK_RECURSIVE_2_PROOF, STARK_RECURSIVE_F_PROOF,
PROVER_<REQUEST TYPE>) and, in the port, the checkpoint's write
(SAVE_CM_POLS_BATCH_PROOF).

Two aggregation pipelines, as in the JAX package:

  * RECURSIVE (the reference architecture, constant size):
    gen_batch_proof (ROM path: ONE combined-AIR proof with publics)
      -> wrap_batch_recursive   (recursive1: the batch proof verified
                                 inside a fixed-shape recursive STARK)
      -> aggregate_recursive    (recursive2: binary tree of 2->1 joins
                                 with in-circuit publics chaining)
  * the host join (genAggregatedProof): gen_aggregated_proof checks that
    two proofs chain and carries both children verbatim.

Reference: src/prover/prover.cpp — pending/current/completed request maps
served by a proverThread (prover.cpp:182-260), genBatchProof (:392),
genAggregatedProof with publics-chaining checks (:676, :700-740),
processBatch fast path (:351).
"""

from __future__ import annotations

import dataclasses
import threading
import uuid as uuidlib

import numpy as np

from .. import resolve_device
from ..executor import Executor
from ..stark.verifier import verify as stark_verify
from ..utils import TimeMetricStorage, timer, zklog
from .input import ProofInput, PublicInputs

# request types whose stages are not ported yet, and the JAX package's
# modules they need
UNPORTED = {
    "genFinalProof": "the SNARK wrap (snark/, ops/bn254_device.py, "
                     "ops/msm.py)",
}


def _fea_publics_hex(limbs: list[int]) -> str:
    """8x 32-bit fea publics -> 0x-prefixed 32-byte big-endian hex
    (reference fea2scalar on the publics cells)."""
    v = sum(int(limbs[i]) << (32 * i) for i in range(8))
    return "0x" + v.to_bytes(32, "big").hex()


@dataclasses.dataclass
class BatchProof:
    publics: PublicInputs
    sm_proofs: dict            # name -> (prover, StarkProof)
    counters: dict
    actions: object = None     # the batch's actions (None when resumed)
    recursive: dict = None     # name -> (prover, BN128 proof), lazy
    db: object = None          # hashdb Database (the ROM path's)


@dataclasses.dataclass
class AggregatedProof:
    publics: PublicInputs
    children: list             # [BatchProof | AggregatedProof]


# the reference publics layout (prover.cpp:494-560): recursive2 chains the
# left proof's new side to the right proof's old side
RECURSIVE2_CHAIN = (
    [(19 + j, 0 + j) for j in range(8)]      # newStateRoot == oldStateRoot'
    + [(27 + j, 8 + j) for j in range(8)]    # newAccInputHash chains
    + [(43, 16), (17, 17), (18, 18)]         # batchNum / chainId / forkId
)


def _recursive2_join(p1_sigs, p2_sigs):
    """Joined 44 publics: the left proof's old side + the right's new."""
    return p1_sigs[0:19] + p2_sigs[19:44]


@dataclasses.dataclass
class RecursiveNode:
    """One node of the recursive aggregation tree (recursive1 leaf wrap
    or a recursive2 join) — constant size regardless of subtree width."""
    proof: object              # outer GL-scheme StarkProof (48 publics)
    verkey: object             # the outer circuit's const root (4 GL)
    publics: PublicInputs
    kind: str                  # "r1" | "r2"
    wrap_args: tuple = None    # what re-synthesizes this node's circuit


@dataclasses.dataclass
class ProverRequest:
    type: str                  # genBatchProof / genAggregatedProof /
    #                            processBatch / UNPORTED
    payload: object
    uuid: str = dataclasses.field(default_factory=lambda: str(uuidlib.uuid4()))
    result: object = None
    error: str | None = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)


def _has_actions(inp: ProofInput) -> bool:
    return any(getattr(inp.actions, f.name)
               for f in dataclasses.fields(inp.actions))


def _takes_rom_path(inp: ProofInput) -> bool:
    """A reference-schema input (batchL2Data / db present, no pre-cooked
    action lists) runs the fork ROM."""
    return not _has_actions(inp) and (
        inp.publics.batch_l2_data not in ("", "0x") or bool(inp.db))


class Prover:
    def __init__(self, n_bits: int | dict | None = None,
                 n_queries: int = 8, rom_bits: int = 14,
                 rom_include: tuple | None = None, device=None):
        """rom_bits: trace domain for ROM-path batch proofs (the reference
        fixes 2^23; the fork_9 ROM itself needs >= 2^14). rom_include: the
        SM set of the combined batch AIR (None = combined.default_include
        (rom_bits)). Every SM's executor and prover, and the ROM path's
        combined prover, run on `device` (CUDA unless told otherwise)."""
        self.device = resolve_device(device)
        self.executor = Executor(n_bits=n_bits, n_queries=n_queries,
                                 device=self.device)
        self.rom_bits = rom_bits
        self.rom_include = rom_include
        self._rom_provers: dict = {}
        self._r1 = None             # RecursiveProver, made at the first wrap
        self._r2 = None             # Recursive2Prover, at the first join
        self.metrics = TimeMetricStorage("prover")
        self._pending: list[ProverRequest] = []
        self._completed: dict[str, ProverRequest] = {}
        self.current: ProverRequest | None = None
        self._sem = threading.Semaphore(0)
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._prover_thread,
                                        daemon=True)
        self._thread.start()

    # -- request queue (reference: submitRequest/waitForRequestToComplete) --

    def submit_request(self, req: ProverRequest) -> str:
        with self._lock:
            self._pending.append(req)
        self._sem.release()
        return req.uuid

    def wait_for_request(self, uuid: str, timeout: float | None = None):
        with self._lock:
            req = self._completed.get(uuid) or next(
                (r for r in self._pending if r.uuid == uuid),
                self.current if self.current and self.current.uuid == uuid
                else None,
            )
        if req is None:
            raise KeyError(f"unknown request {uuid}")
        req.done.wait(timeout)
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def _prover_thread(self):
        while True:
            self._sem.acquire()
            with self._lock:
                req = self._pending.pop(0)
                self.current = req
            try:
                with timer(f"PROVER_{req.type.upper()}", self.metrics,
                           log=False):
                    req.result = self._dispatch(req)
            except Exception as e:  # noqa: BLE001 — report to the requester
                req.error = f"{type(e).__name__}: {e}"
                zklog.error(f"request {req.uuid} failed: {req.error}")
            finally:
                with self._lock:
                    self.current = None
                    self._completed[req.uuid] = req
                req.done.set()

    def _dispatch(self, req: ProverRequest):
        if req.type == "genBatchProof":
            return self.gen_batch_proof(req.payload)
        if req.type == "genAggregatedProof":
            return self.gen_aggregated_proof(*req.payload)
        if req.type == "processBatch":
            return self.process_batch(req.payload)
        if req.type in UNPORTED:
            raise NotImplementedError(
                f"{req.type} needs {UNPORTED[req.type]}, not ported yet")
        raise ValueError(f"unknown request type {req.type}")

    # -- pipeline stages ----------------------------------------------------

    def process_batch(self, inp: ProofInput) -> dict:
        """Fast path: execute without proving (reference: Executor::
        process_batch -> MainExecutor only, 2-row pols, executor.cpp:20).

        With a reference-schema input (batchL2Data / db present) this runs
        the real fork ROM through the interpreter with a FullTracer and
        returns the block/tx/log responses; the pre-cooked action path
        returns the SM counters."""
        if _takes_rom_path(inp):
            return self._process_batch_rom(inp)
        counters = self.executor.counters(inp.actions)
        pub = dataclasses.replace(inp.publics)
        pub.new_acc_input_hash = pub.acc_input_hash()
        pub.new_batch_num = pub.old_batch_num + 1
        return {"publics": pub, "counters": counters}

    def _process_batch_rom(self, inp: ProofInput) -> dict:
        from ..executor import forks
        from ..executor.sm.main_sm import MainExecutor
        from ..hashdb import Database, Smt

        db = Database()
        inp.seed_database(db)
        smt = Smt(db)
        rom = forks.rom_for_fork(int(inp.publics.fork_id))
        tracer = inp.make_full_tracer(rom)
        res = MainExecutor(rom, 23).execute(
            inp.executor_input(), smt=smt, process_batch=True,
            full_tracer=tracer)
        if res.new_state_root is not None:
            tracer.fill_in_read_write_addresses(smt, res.new_state_root)
        ft = tracer.final_trace
        pub = dataclasses.replace(inp.publics)
        pub.new_state_root = ft.new_state_root or pub.old_state_root
        pub.new_acc_input_hash = ft.new_acc_input_hash
        pub.new_local_exit_root = ft.new_local_exit_root
        pub.new_batch_num = pub.old_batch_num + 1
        counters = dict(res.counters)
        counters["steps"] = res.last_step
        return {"publics": pub, "counters": counters,
                "tracer": tracer, "last_step": res.last_step}

    def gen_batch_proof(self, inp: ProofInput,
                        save_cm_pols: str | None = None) -> BatchProof:
        """save_cm_pols: checkpoint the executed commit pols to this path
        before proving (reference config.zkevmCmPolsAfterExecutor).

        A reference-schema input (batchL2Data / db present, no pre-cooked
        action lists) takes the ROM path: execute the fork ROM full-trace
        and prove Main + all co-SMs in ONE combined AIR with in-circuit
        bindings and the chaining publics (reference genBatchProof,
        prover.cpp:392-612). An action-list input proves each active SM
        with its own STARK."""
        if _takes_rom_path(inp):
            return self._gen_batch_proof_rom(inp, save_cm_pols)
        with timer("EXECUTOR_EXECUTE_BATCH_PROOF", self.metrics, log=False):
            counters = self.executor.counters(inp.actions)
            traces = self.executor.execute(inp.actions)
        if save_cm_pols:
            from . import checkpoint

            with timer("SAVE_CM_POLS_BATCH_PROOF", self.metrics, log=False):
                checkpoint.save_commit_pols(
                    save_cm_pols, traces,
                    publics=dataclasses.asdict(inp.publics),
                    meta={"counters": counters})
        with timer("STARK_PROOF_BATCH_PROOF", self.metrics, log=False):
            sm_proofs = self.executor.prove_traces(traces)
        pub = dataclasses.replace(inp.publics)
        pub.new_acc_input_hash = pub.acc_input_hash()
        pub.new_batch_num = pub.old_batch_num + 1
        if pub.new_state_root == "0x" + "00" * 32:
            pub.new_state_root = pub.old_state_root
        return BatchProof(publics=pub, sm_proofs=sm_proofs,
                          counters=counters, actions=inp.actions)

    def _rom_prover(self, fork_id: int, rom, include: tuple,
                    keccak_cfg=None, sha256_cfg=None):
        """Cached StarkProver over the combined batch AIR for one fork."""
        from ..executor import combined
        from ..stark.prover import StarkProver
        from ..stark.setup import StarkSetup

        key = (fork_id, self.rom_bits, tuple(include))
        if key not in self._rom_provers:
            air = combined.build_batch_air(
                rom, self.rom_bits, include=include,
                keccak_cfg=keccak_cfg, sha256_cfg=sha256_cfg)
            self._rom_provers[key] = StarkProver(
                StarkSetup(air, n_queries=self.executor.n_queries,
                           fri_fold_bits=2), device=self.device)
        return self._rom_provers[key]

    def _gen_batch_proof_rom(self, inp: ProofInput,
                             save_cm_pols: str | None = None) -> BatchProof:
        """The spine: one combined-AIR proof of the full ROM execution.
        Reference: Prover::genBatchProof = Executor::execute (all SMs into
        one trace) + Starks::genProof (prover.cpp:392-612)."""
        from ..executor import combined, forks
        from ..hashdb import Database, Smt

        db = Database()
        inp.seed_database(db)
        smt = Smt(db)
        fork_id = int(inp.publics.fork_id)
        rom = forks.rom_for_fork(fork_id)
        include = self.rom_include
        if include is None:
            include = combined.default_include(self.rom_bits)
        kcfg = scfg = None
        if "keccak" in include:
            from ..executor.sm import keccak_circuit
            kcfg = combined.keccak_pipeline_cfg(
                keccak_circuit.build(24), 44, 11)
        if "sha256" in include:
            from ..executor.sm import sha256_circuit
            scfg = combined.keccak_pipeline_cfg(
                sha256_circuit.build(64), 44, 11)
        prover = self._rom_prover(fork_id, rom, include, kcfg, scfg)

        with timer("EXECUTOR_EXECUTE_BATCH_PROOF", self.metrics, log=False):
            res, traces = combined.execute_batch(
                rom, self.rom_bits, input=inp.executor_input(), smt=smt,
                include=include, keccak_cfg=kcfg, sha256_cfg=scfg,
                device=self.device)
        stacked = prover.setup.air.stack_traces(traces)
        if save_cm_pols:
            from . import checkpoint

            with timer("SAVE_CM_POLS_BATCH_PROOF", self.metrics, log=False):
                checkpoint.save_commit_pols(
                    save_cm_pols, {"batch": stacked},
                    publics=dataclasses.asdict(inp.publics),
                    meta={"counters": dict(res.counters)})
        with timer("STARK_PROOF_BATCH_PROOF", self.metrics, log=False):
            proof = prover.prove(stacked)

        # the chaining publics come OUT of the proof (reference publics
        # layout, prover.cpp:494-560) — not from host bookkeeping
        pub = dataclasses.replace(inp.publics)
        pv = [int(x) for x in proof.publics]
        pub.new_state_root = _fea_publics_hex(pv[19:27])
        pub.new_acc_input_hash = _fea_publics_hex(pv[27:35])
        pub.new_local_exit_root = _fea_publics_hex(pv[35:43])
        pub.new_batch_num = pv[43]
        expect_acc = inp.publics.acc_input_hash()
        if pub.new_acc_input_hash != expect_acc:
            raise RuntimeError(
                f"proof newAccInputHash {pub.new_acc_input_hash} != "
                f"recurrence {expect_acc}")
        counters = dict(res.counters)
        counters["steps"] = res.last_step
        return BatchProof(publics=pub,
                          sm_proofs={"batch": (prover, proof)},
                          counters=counters, actions=res.actions, db=db)

    def gen_batch_proof_from_commit(self, path: str) -> BatchProof:
        """Resume proving from a commit-pols checkpoint — the STARK-only
        path (reference test/prover/main.cpp: load zkevm.commit + publics,
        run Starks::genProof, no executor). The checkpoint stores commit
        pols only, so the resumed BatchProof has actions=None."""
        from . import checkpoint

        traces, hdr = checkpoint.load_commit_pols(path)
        pub = PublicInputs(**hdr["publics"]) if hdr["publics"] \
            else PublicInputs()
        with timer("STARK_PROOF_BATCH_PROOF", self.metrics, log=False):
            sm_proofs = self.executor.prove_traces(traces)
        if pub.new_acc_input_hash == "0x" + "00" * 32:
            pub.new_acc_input_hash = pub.acc_input_hash()
        if pub.new_batch_num == 0:
            pub.new_batch_num = pub.old_batch_num + 1
        if pub.new_state_root == "0x" + "00" * 32:
            pub.new_state_root = pub.old_state_root
        return BatchProof(publics=pub, sm_proofs=sm_proofs,
                          counters=hdr["meta"].get("counters", {}),
                          actions=None)

    def compress_proof(self, bp: BatchProof) -> dict:
        """The recursiveF role: the batch's SM traces re-proven under the
        BN128 scheme so the final circuit can verify them (cached on the
        BatchProof)."""
        if bp.recursive is None:
            if bp.actions is None:
                raise RuntimeError(
                    "batch proof lacks actions (resumed from a commit-pols "
                    "checkpoint?) — only a full gen_batch_proof result can "
                    "be compressed/finalized")
            with timer("STARK_RECURSIVE_F_PROOF", self.metrics, log=False):
                bp.recursive = self.executor.prove_recursive(
                    bp.actions, db=bp.db)
        return bp.recursive

    # -- aggregation (the host join, genAggregatedProof) ---------------------

    def aggregate_tree(self, proofs: list) -> "AggregatedProof | BatchProof":
        """Binary-tree reduction over an ordered batch-proof list — the
        fan-in the external aggregator drives (SURVEY.md §3.3: recursive2
        verifies two children, enabling a binary aggregation tree)."""
        assert proofs, "nothing to aggregate"
        layer = list(proofs)
        while len(layer) > 1:
            nxt = []
            for i in range(0, len(layer) - 1, 2):
                nxt.append(self.gen_aggregated_proof(layer[i], layer[i + 1]))
            if len(layer) % 2:
                nxt.append(layer[-1])
            layer = nxt
        return layer[0]

    def gen_aggregated_proof(self, p1, p2) -> AggregatedProof:
        """Join two proofs; mirrors the consistency checks of
        Prover::genAggregatedProof (prover.cpp:700-740)."""
        a, b = p1.publics, p2.publics
        if a.new_state_root != b.old_state_root:
            raise ValueError("aggregation: state roots do not chain")
        if a.new_acc_input_hash != b.old_acc_input_hash:
            raise ValueError("aggregation: acc input hashes do not chain")
        if a.new_batch_num != b.old_batch_num:
            raise ValueError("aggregation: batch numbers do not chain")
        if a.chain_id != b.chain_id or a.fork_id != b.fork_id:
            raise ValueError("aggregation: chain/fork mismatch")
        pub = dataclasses.replace(a)
        pub.new_state_root = b.new_state_root
        pub.new_acc_input_hash = b.new_acc_input_hash
        pub.new_batch_num = b.new_batch_num
        pub.new_local_exit_root = b.new_local_exit_root
        return AggregatedProof(publics=pub, children=[p1, p2])

    # -- recursive aggregation (recursive1/recursive2 roles) ----------------

    def _recursive1(self, batch_prover, rec_bits: int):
        from ..stark.recursive import RecursiveProver

        if self._r1 is None:
            self._r1 = RecursiveProver(
                batch_prover.setup, n_bits=rec_bits,
                n_queries=self.executor.n_queries, device=self.device)
        return self._r1

    def _recursive2(self, child_setup, r1_verkey, rec_bits: int):
        from ..stark.recursive import Recursive2Prover

        if self._r2 is None:
            self._r2 = Recursive2Prover(
                child_setup, r1_verkey, n_bits=rec_bits,
                join_publics=_recursive2_join, chain=RECURSIVE2_CHAIN,
                n_queries=self.executor.n_queries, device=self.device)
        return self._r2

    def wrap_batch_recursive(self, bp: BatchProof,
                             rec_bits: int = 18) -> RecursiveNode:
        """recursive1: the ROM-path batch proof verified inside a fixed-
        shape recursive STARK (reference STARK_RECURSIVE_1_PROOF,
        prover.cpp:612-660)."""
        prover, proof = bp.sm_proofs["batch"]
        r1 = self._recursive1(prover, rec_bits)
        with timer("STARK_RECURSIVE_1_PROOF", self.metrics, log=False):
            rec = r1.prove_one(prover.verkey, proof)
        return RecursiveNode(proof=rec.proof,
                             verkey=r1.outer_prover.verkey,
                             publics=bp.publics, kind="r1",
                             wrap_args=(prover.verkey, proof))

    def aggregate_recursive(self, nodes: list, rec_bits: int = 18
                            ) -> RecursiveNode:
        """Binary-tree recursive2 reduction: any number of chained nodes
        -> ONE constant-size proof under ONE circuit (reference
        genAggregatedProof + recursive2, prover.cpp:676-800)."""
        assert nodes, "nothing to aggregate"
        layer = list(nodes)
        r1pv = self._r1.outer_prover
        r2 = self._recursive2(r1pv.setup, r1pv.verkey, rec_bits)
        while len(layer) > 1:
            nxt = []
            for i in range(0, len(layer) - 1, 2):
                a, b = layer[i], layer[i + 1]
                if a.publics.new_state_root != b.publics.old_state_root:
                    raise ValueError("aggregation: state roots do not chain")
                with timer("STARK_RECURSIVE_2_PROOF", self.metrics,
                           log=False):
                    proof = r2.prove_pair(a.proof, a.verkey,
                                          b.proof, b.verkey)
                pub = dataclasses.replace(a.publics)
                pub.new_state_root = b.publics.new_state_root
                pub.new_acc_input_hash = b.publics.new_acc_input_hash
                pub.new_batch_num = b.publics.new_batch_num
                pub.new_local_exit_root = b.publics.new_local_exit_root
                nxt.append(RecursiveNode(
                    proof=proof, verkey=r2.outer_prover.verkey,
                    publics=pub, kind="r2",
                    wrap_args=(a.proof, a.verkey, b.proof, b.verkey)))
            if len(layer) % 2:
                nxt.append(layer[-1])
            layer = nxt
        return layer[0]

    # -- verification (the oracle path) -------------------------------------

    def verify_batch_proof(self, bp: BatchProof) -> bool:
        return all(
            stark_verify(prover.setup, prover.verkey, proof,
                         device=self.device)
            for prover, proof in bp.sm_proofs.values()
        )

    def verify_aggregated_proof(self, ap) -> bool:
        if isinstance(ap, BatchProof):
            return self.verify_batch_proof(ap)
        return all(self.verify_aggregated_proof(c) for c in ap.children)

    def verify_recursive(self, node: RecursiveNode) -> bool:
        """The node's proof against this Prover's own outer circuit of the
        node's kind (never a verkey the node carries), its state roots
        against its publics, and for an r2 node publics[44:48] == the
        recursive2 verkey (the tree-closure invariant, reference
        prover.cpp:556-560)."""
        rp = self._r2 if node.kind == "r2" else self._r1
        if rp is None:
            raise ValueError(f"no {node.kind} circuit made by this Prover")
        pv = rp.outer_prover
        if not stark_verify(pv.setup, pv.verkey, node.proof,
                            device=self.device):
            return False
        pubs = [int(v) for v in node.proof.publics]
        if _fea_publics_hex(pubs[0:8]) != node.publics.old_state_root:
            return False
        if _fea_publics_hex(pubs[19:27]) != node.publics.new_state_root:
            return False
        if node.kind == "r2":
            own = [int(v) for v in np.ravel(np.asarray(pv.verkey))]
            if pubs[44:48] != own:
                return False
        return True
