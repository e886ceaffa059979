"""The Prover — request queue + proof pipeline orchestration.

Port of `zkevm_prover_tpu/prover/prover.py`: `BatchProof`,
`AggregatedProof`, `RecursiveNode`, `FinalProof`, `ProverRequest`, the
request queue (`submit_request`, `wait_for_request`, its thread) serving
every request type, `process_batch`, `gen_batch_proof` (the action-list
path and the ROM path), `gen_batch_proof_from_commit`, `compress_proof`
(the batch re-proved under BN128 commitments), the aggregation
(`gen_aggregated_proof`, `aggregate_tree`, `verify_aggregated_proof`), the
recursion (`wrap_batch_recursive`, `aggregate_recursive`,
`verify_recursive`), the final SNARK wrap (`gen_final_proof` in the
stark-verify, digest, plonk and fflonk modes, `gen_final_proof_recursive`,
`verify_final_proof`, `verify_final_proof_recursive`) and
`verify_batch_proof`, on `device` (CUDA unless told otherwise): the SNARKs'
CRS, FFTs and MSMs run on the kernels of csrc/bn254.cu there.
`metrics` times each stage under the JAX package's labels
(EXECUTOR_EXECUTE_BATCH_PROOF, STARK_PROOF_BATCH_PROOF,
STARK_RECURSIVE_1_PROOF, STARK_RECURSIVE_2_PROOF, STARK_RECURSIVE_F_PROOF,
STARK_FINAL_CIRCUIT, RAPID_SNARK, PROVER_<REQUEST TYPE>) and, in the port,
the checkpoint's write (SAVE_CM_POLS_BATCH_PROOF) and the final wrap's
Groth16 setup (GROTH16_SETUP_FINAL_PROOF).

Two aggregation pipelines, as in the JAX package:

  * RECURSIVE (the reference architecture, constant size):
    gen_batch_proof (ROM path: ONE combined-AIR proof with publics)
      -> wrap_batch_recursive   (recursive1: the batch proof verified
                                 inside a fixed-shape recursive STARK)
      -> aggregate_recursive    (recursive2: binary tree of 2->1 joins
                                 with in-circuit publics chaining)
      -> gen_final_proof_recursive (recursiveF: the root trace re-proven
                                 under BN128 commitments + ONE fixed
                                 Groth16 over its verifier circuit)
  * the host join (genAggregatedProof): gen_aggregated_proof checks that
    two proofs chain and carries both children verbatim;
    gen_final_proof wraps it (stark-verify: one Groth16 whose circuit
    verifies every leaf's STARKs re-proven under BN128).

Reference: src/prover/prover.cpp — pending/current/completed request maps
served by a proverThread (prover.cpp:182-260), genBatchProof (:392),
genAggregatedProof with publics-chaining checks (:676, :700-740),
genFinalProof SNARK wrap (:827), processBatch fast path (:351).
"""

from __future__ import annotations

import dataclasses
import threading
import uuid as uuidlib

import numpy as np

from .. import resolve_device
from ..executor import Executor
from ..ops import bn254, keccak
from ..snark import R1CS, groth16_prove, groth16_setup, groth16_verify
from ..stark.verifier import verify as stark_verify
from ..utils import TimeMetricStorage, timer, zklog
from .input import ProofInput, PublicInputs


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
class FinalProof:
    publics: PublicInputs
    groth16: dict              # pi_a/pi_b/pi_c
    publics_digest: int
    stark_publics: list = None  # [verkeys..., stark publics...] when the
    #                             final circuit verifies the STARKs


@dataclasses.dataclass
class ProverRequest:
    type: str                  # genBatchProof / genAggregatedProof /
    #                            genFinalProof / processBatch
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
                 rom_include: tuple | None = None,
                 final_snark: str = "stark-verify", device=None):
        """rom_bits: trace domain for ROM-path batch proofs (the reference
        fixes 2^23; the fork_9 ROM itself needs >= 2^14). rom_include: the
        SM set of the combined batch AIR (None = combined.default_include
        (rom_bits)). Every SM's executor and prover, the ROM path's
        combined prover and the final SNARKs run on `device` (CUDA unless
        told otherwise).

        final_snark: the default final-proof mode — like the reference,
        where the final protocol comes from config (the final zkey path,
        config.cpp:268). "stark-verify" (production default: ONE Groth16
        whose circuit verifies the leaf STARKs, the final.circom role) |
        "digest" / "plonk" / "fflonk" (digest-binding circuits, test-
        scale)."""
        self.device = resolve_device(device)
        self.executor = Executor(n_bits=n_bits, n_queries=n_queries,
                                 device=self.device)
        self.rom_bits = rom_bits
        self.rom_include = rom_include
        self.final_snark = final_snark
        self._final_setup = None    # the digest circuit's Groth16 setup
        self._final_plonk = None
        self._final_fflonk = None
        self._join_g16: dict = {}   # stark-verify setups by shape
        self._rf: dict = {}         # recursiveF BN128 provers by node kind
        self._final_rec_g16: dict = {}
        # the Groth16 steps' seconds, summed over this Prover's final wraps
        # (groth16_setup's and groth16_prove's `times`)
        self.snark_times: dict = {}
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
        if req.type == "genFinalProof":
            return self.gen_final_proof(req.payload)
        if req.type == "processBatch":
            return self.process_batch(req.payload)
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

    # -- the final SNARK wrap (genFinalProof) -------------------------------

    def gen_final_proof_recursive(self, node: RecursiveNode) -> FinalProof:
        """The recursiveF + final roles: the root recursive trace is
        re-proven under the BN128 commitment scheme and THAT proof is
        verified inside ONE fixed Groth16 circuit (reference
        starkRecursiveF + final.circom, prover.cpp:827-940). Constant
        size for any aggregation width; one setup per node kind."""
        from ..snark import stark_verifier_circuit as svc
        from ..stark.prover import StarkProver
        from ..stark.setup import StarkSetup

        if node.kind == "r2":
            r2 = self._r2
            a_proof, a_vk, b_proof, b_vk = node.wrap_args
            s = r2._synth_pair(a_proof, a_vk, b_proof, b_vk,
                               r2.outer_prover.verkey)
            cc = r2._compiled[0]
        else:
            s = self._r1._synth(*node.wrap_args)
            cc = self._r1._compiled[0]
        stacked = cc.air.stack_traces(cc.trace(s))
        if node.kind not in self._rf:
            self._rf[node.kind] = StarkProver(StarkSetup(
                cc.air, n_queries=self.executor.n_queries,
                fri_fold_bits=2, hash_type="BN128"), device=self.device)
        rf = self._rf[node.kind]
        with timer("STARK_RECURSIVE_F_PROOF", self.metrics, log=False):
            bn_proof = rf.prove(stacked)
        with timer("STARK_FINAL_CIRCUIT", self.metrics, log=False):
            r1cs, w, pubs = svc.build(rf.setup, rf.verkey, bn_proof)
        if node.kind not in self._final_rec_g16:
            with timer("GROTH16_SETUP_FINAL_PROOF", self.metrics, log=False):
                self._final_rec_g16[node.kind] = groth16_setup(
                    r1cs, device=self.device, times=self.snark_times)
        g16 = self._final_rec_g16[node.kind]
        digest = self.publics_digest(node.publics)
        with timer("RAPID_SNARK", self.metrics, log=False):
            proof = groth16_prove(g16, w, times=self.snark_times)
        proof = {"system": "groth16-recursive", "kind": node.kind, **proof}
        return FinalProof(publics=node.publics, groth16=proof,
                          publics_digest=digest, stark_publics=pubs)

    def verify_final_proof_recursive(self, fp: FinalProof) -> bool:
        if fp.publics_digest != self.publics_digest(fp.publics):
            return False
        kind = fp.groth16.get("kind")
        if kind not in self._final_rec_g16:
            return False
        rf = self._rf[kind]
        # the circuit publics open with the recursiveF verkey, and the
        # batch publics ride inside the STARK publics section
        if fp.stark_publics[0] != int(rf.verkey):
            return False
        pubs = [int(v) for v in fp.stark_publics[1:45]]
        if _fea_publics_hex(pubs[0:8]) != fp.publics.old_state_root:
            return False
        if _fea_publics_hex(pubs[19:27]) != fp.publics.new_state_root:
            return False
        return groth16_verify(self._final_rec_g16[kind], fp.stark_publics,
                              fp.groth16)

    def publics_digest(self, pub: PublicInputs) -> int:
        payload = (
            bytes.fromhex(pub.old_state_root[2:])
            + bytes.fromhex(pub.new_state_root[2:])
            + bytes.fromhex(pub.old_acc_input_hash[2:])
            + bytes.fromhex(pub.new_acc_input_hash[2:])
            + pub.old_batch_num.to_bytes(8, "big")
            + pub.new_batch_num.to_bytes(8, "big")
            + pub.chain_id.to_bytes(8, "big")
        )
        return int.from_bytes(keccak.keccak256(payload), "big") % bn254.R

    def _final_circuit(self):
        """Digest-binding circuit: public = digest, witness = (s, inv) with
        s·(s·inv - 1) = 0 ∧ s = digest (the final.circom role, minimal)."""
        if self._final_setup is None:
            b = R1CS.builder(n_public=1)
            s = b.alloc()
            inv = b.alloc()
            t = b.mul(s, inv)        # t = s·inv
            b.constrain({s: 1}, {t: 1}, {s: 1})   # s·t = s
            b.constrain({s: 1}, {0: 1}, {1: 1})   # s == digest (public slot 1)
            self._final_setup = groth16_setup(b.build(), device=self.device)
        return self._final_setup

    def _final_circuit_plonk(self):
        """The digest-binding statement as a PLONK circuit (the Fflonk-role
        alternative final SNARK, snark/plonk.py)."""
        if self._final_plonk is None:
            from ..snark import plonk

            b = plonk.Builder(n_public=1)
            s = b.alloc()
            inv = b.alloc()
            t = b.mul(s, inv)
            b._gate(1, bn254.R - 1, 0, 0, 0, s, t, 0)  # s·t - s = 0
            b.assert_equal(s, 1)                        # s == digest public
            self._final_plonk = plonk.plonk_setup(b.build(),
                                                  device=self.device)
        return self._final_plonk

    def _final_circuit_fflonk(self):
        """The digest-binding statement under fflonk combined commitments —
        the reference's DEFAULT final SNARK (final.fflonk.zkey,
        config.cpp:268; prover.cpp:931 dispatch)."""
        if self._final_fflonk is None:
            from ..snark import fflonk

            b = fflonk.Builder(n_public=1)
            s = b.alloc()
            inv = b.alloc()
            t = b.mul(s, inv)
            b._gate(1, bn254.R - 1, 0, 0, 0, s, t, 0)  # s·t - s = 0
            b.assert_equal(s, 1)                        # s == digest public
            self._final_fflonk = fflonk.fflonk_setup(b.build(),
                                                     device=self.device)
        return self._final_fflonk

    def _leaf_batches(self, node) -> list:
        if isinstance(node, BatchProof):
            return [node]
        out = []
        for c in node.children:
            out += self._leaf_batches(c)
        return out

    def gen_final_proof_stark(self, agg) -> FinalProof:
        """The production-shape final wrap: ONE Groth16 proof whose
        circuit VERIFIES every leaf batch's STARKs (re-proven under the
        BN128 scheme — the recursiveF role) — reference final.circom over
        the recursivef verifier (prover.cpp:827-940). The publics
        chaining between leaves stays checked at aggregation time
        (gen_aggregated_proof); the digest binds the joined publics."""
        from ..snark import stark_verifier_circuit as svc

        leaves = self._leaf_batches(agg)
        items, names = [], []
        for bp in leaves:
            rec = self.compress_proof(bp)
            for name in sorted(rec):
                prover, proof = rec[name]
                items.append((prover.setup, int(prover.verkey), proof))
                names.append(name)
        with timer("STARK_FINAL_CIRCUIT", self.metrics, log=False):
            r1cs, w, pubs = svc.build_join(items)
        key = tuple(
            (nm, st.n_bits, st.n_queries, tuple(st.fri_steps))
            for nm, (st, _, _) in zip(names, items))
        if key not in self._join_g16:
            # the FIXED circuit: one Groth16 setup per shape tuple
            with timer("GROTH16_SETUP_FINAL_PROOF", self.metrics, log=False):
                self._join_g16[key] = groth16_setup(
                    r1cs, device=self.device, times=self.snark_times)
        g16 = self._join_g16[key]
        digest = self.publics_digest(agg.publics)
        with timer("RAPID_SNARK", self.metrics, log=False):
            proof = groth16_prove(g16, w, times=self.snark_times)
        proof = {"system": "groth16-stark", "sm_names": names, **proof}
        return FinalProof(publics=agg.publics, groth16=proof,
                          publics_digest=digest, stark_publics=pubs)

    def gen_final_proof(self, agg, snark: str | None = None) -> FinalProof:
        """Final SNARK wrap. snark=None takes the prover's configured
        default (self.final_snark) — "stark-verify" unless overridden, the
        production path: the Groth16 circuit VERIFIES the STARKs rather
        than a host-checked digest (reference final.circom over the
        recursivef verifier, prover.cpp:827-940). A RecursiveNode (from
        the recursive1/recursive2 aggregation tree) routes to the
        recursiveF re-proof wrap."""
        if snark is None:
            snark = self.final_snark
        if isinstance(agg, RecursiveNode):
            return self.gen_final_proof_recursive(agg)
        if snark == "stark-verify":
            return self.gen_final_proof_stark(agg)
        digest = self.publics_digest(agg.publics)
        s = digest
        inv = pow(s, bn254.R - 2, bn254.R) if s else 0
        if snark == "plonk":
            from ..snark import plonk

            setup = self._final_circuit_plonk()
            assign = [0, digest, s, inv, s * inv % bn254.R]
            with timer("RAPID_SNARK", self.metrics, log=False):
                proof = plonk.plonk_prove(setup, assign)
            proof = {"system": "plonk", **proof}
        elif snark == "fflonk":
            from ..snark import fflonk

            setup = self._final_circuit_fflonk()
            assign = [0, digest, s, inv, s * inv % bn254.R]
            with timer("RAPID_SNARK", self.metrics, log=False):
                proof = fflonk.fflonk_prove(setup, assign)
            proof = {"system": "fflonk", **proof}
        else:
            setup = self._final_circuit()
            w = [1, digest, s, inv, s * inv % bn254.R]
            with timer("RAPID_SNARK", self.metrics, log=False):
                proof = groth16_prove(setup, w)
        return FinalProof(publics=agg.publics, groth16=proof,
                          publics_digest=digest)

    def verify_final_proof(self, fp: FinalProof) -> bool:
        if fp.publics_digest != self.publics_digest(fp.publics):
            return False
        if isinstance(fp.groth16, dict) and \
                fp.groth16.get("system") == "groth16-stark":
            names = fp.groth16["sm_names"]
            # the circuit publics must open with OUR verkeys — a proof
            # against junk trees would verify otherwise
            expected = [int(self.executor.prover(n, "BN128").verkey)
                        for n in names]
            if fp.stark_publics[:len(expected)] != expected:
                return False
            key = None
            for k in self._join_g16:
                if tuple(nm for nm, *_ in k) == tuple(names):
                    key = k
            if key is None:
                return False
            return groth16_verify(self._join_g16[key], fp.stark_publics,
                                  fp.groth16)
        if isinstance(fp.groth16, dict) and \
                fp.groth16.get("system") == "plonk":
            from ..snark import plonk

            return plonk.plonk_verify(self._final_circuit_plonk(),
                                      [fp.publics_digest], fp.groth16)
        if isinstance(fp.groth16, dict) and \
                fp.groth16.get("system") == "fflonk":
            from ..snark import fflonk

            return fflonk.fflonk_verify(self._final_circuit_fflonk(),
                                        [fp.publics_digest], fp.groth16)
        return groth16_verify(self._final_circuit(), [fp.publics_digest],
                              fp.groth16)
