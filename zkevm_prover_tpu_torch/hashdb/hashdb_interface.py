"""HashDB facade — the interface the executor and the gRPC service consume.

Port of `zkevm_prover_tpu/hashdb/hashdb_interface.py`: a host copy, the same
facade (Keccak from the port's host `ops/keccak`).

Reference: HashDBInterface (src/hashdb/hashdb_interface.hpp: set/get/
setProgram/getProgram/flush/getFlushStatus/consolidateState/...) and its local
implementation (src/service/hashdb/hashdb.cpp). The factory local/remote
switch (hashdb_factory.cpp:13-27) is mirrored by services/hashdb_client.py.

Persistence modes follow the reference enum: CACHE (batch overlay only),
DATABASE (write-through), TEMPORARY.
"""

from __future__ import annotations

from ..ops import keccak as _keccak
from ..ops import poseidon_constants as pc
from ..ops import refmodel as rm
from .database import Database
from .smt import Smt, SmtGetResult, SmtSetResult
from .state_manager import StateManager

PERSISTENCE_CACHE = 0
PERSISTENCE_DATABASE = 1
PERSISTENCE_TEMPORARY = 2


class HashDB:
    def __init__(self, db: Database | None = None):
        self.db = db if db is not None else Database()
        self.state = StateManager(self.db)
        self._poseidon = rm.Poseidon(pc.round_constants(), pc.mds_matrix())
        self._latest_root = (0, 0, 0, 0)

    # -- SMT state --------------------------------------------------------------

    def set(self, batch_uuid: str, tx: int, old_root, key, value: int,
            persistence: int = PERSISTENCE_CACHE) -> SmtSetResult:
        smt = Smt(self._db_for(batch_uuid, persistence))
        res = smt.set(tuple(old_root), tuple(key), int(value))
        self._latest_root = tuple(int(v) for v in res.new_root)
        return res

    def get(self, batch_uuid: str, root, key) -> SmtGetResult:
        smt = Smt(self._db_for(batch_uuid, PERSISTENCE_CACHE))
        return smt.get(tuple(root), tuple(key))

    # -- program (contract bytecode) ---------------------------------------------

    def set_program(self, batch_uuid: str, key, data: bytes,
                    persistence: int = PERSISTENCE_CACHE) -> None:
        self._db_for(batch_uuid, persistence).set_program(key, data)

    def get_program(self, batch_uuid: str, key) -> bytes | None:
        return self._db_for(batch_uuid, PERSISTENCE_CACHE).get_program(key)

    # -- batch lifecycle -----------------------------------------------------------

    def begin_batch(self, batch_uuid: str, old_root=(0, 0, 0, 0)) -> None:
        self.state.begin_batch(batch_uuid, old_root)

    def semi_flush(self, batch_uuid: str, new_root) -> None:
        self.state.semi_flush(batch_uuid, new_root)

    def flush(self, batch_uuid: str, new_state_root=None) -> tuple[int, int]:
        return self.state.flush(batch_uuid, new_state_root)

    def get_flush_status(self) -> dict:
        return self.state.get_flush_status()

    def cancel_batch(self, batch_uuid: str) -> None:
        self.state.cancel_batch(batch_uuid)

    # -- extended surface (reference hashdb_service.cpp RPCs) -----------------

    def get_latest_state_root(self) -> tuple:
        return self._latest_root

    def load_db(self, nodes: dict, persistence: int = PERSISTENCE_DATABASE):
        """Bulk-load node preimages {hash4: [12 values]} (LoadDB RPC)."""
        for h, value in nodes.items():
            self.db.write(tuple(int(v) for v in h),
                          [int(x) for x in value])

    def load_program_db(self, programs: dict):
        """Bulk-load programs {key4: bytes} (LoadProgramDB RPC)."""
        for k, data in programs.items():
            self.db.set_program(tuple(int(v) for v in k), bytes(data))

    def start_block(self, batch_uuid: str, old_root) -> None:
        """Block boundary marker within a batch (StartBlock RPC)."""
        if batch_uuid not in self.state._batches:
            self.state.begin_batch(batch_uuid, tuple(old_root))
        self.state.semi_flush(batch_uuid, tuple(old_root))

    def finish_block(self, batch_uuid: str, new_root) -> None:
        self.state.semi_flush(batch_uuid, tuple(new_root))

    def finish_tx(self, batch_uuid: str, new_root,
                  persistence: int = PERSISTENCE_CACHE) -> None:
        """Tx boundary marker within a batch (FinishTx RPC; reference
        StateManager::finishTx, src/hashdb/state_manager.cpp): record the
        post-tx state root so the overlay history tracks tx granularity."""
        self.state.semi_flush(batch_uuid, tuple(new_root))

    def purge(self, batch_uuid: str, new_root,
              persistence: int = PERSISTENCE_CACHE) -> None:
        """Drop superseded overlay history, keeping the chain up to
        new_root (reference StateManager::purge). Content-addressed
        storage keeps every reachable node, so this only trims batch
        bookkeeping."""
        self.state.semi_flush(batch_uuid, tuple(new_root))

    def consolidate_state(self, virtual_root,
                          persistence: int = PERSISTENCE_DATABASE):
        """Consolidate a virtual state root: commit every open batch
        overlay into the base database. Returns (consolidated_root,
        flush_id, stored_flush_id) — with one content-addressed store the
        consolidated root IS the virtual root (the reference re-keys
        virtual nodes; here hashes are already final)."""
        for uuid in list(self.state._batches):
            self.state.flush(uuid)
        status = self.state.get_flush_status()
        self._latest_root = tuple(int(v) for v in virtual_root)
        return (self._latest_root, status["lastFlushId"],
                status["storedFlushId"])

    def get_flush_data(self, flush_id: int) -> dict:
        """Nodes/programs persisted since `flush_id` (GetFlushData RPC,
        which feeds the external DB replicator)."""
        mark = self.state._flush_marks.get(flush_id, 0)
        return self.db.entries_since(mark)

    def read_tree(self, root, keys: list) -> list:
        """Read values + proof levels for `keys` under `root`
        (ReadTree RPC)."""
        smt = Smt(self.db)
        out = []
        for key in keys:
            res = smt.get(tuple(root), tuple(key))
            out.append({"key": tuple(key), "value": res.value,
                        "level": max(res.siblings) + 1 if res.siblings
                        else 0})
        return out

    def reset_db(self) -> None:
        self.db.clear()
        self.state = StateManager(self.db)
        self._latest_root = (0, 0, 0, 0)

    # -- helpers --------------------------------------------------------------------

    def _db_for(self, batch_uuid: str, persistence: int):
        if batch_uuid and batch_uuid in self.state._batches:
            return self.state.overlay_db(batch_uuid)
        return self.db

    def hash_program(self, data: bytes) -> tuple:
        """Poseidon linear hash of padded bytecode (program key derivation,
        reference: hashContractBytecode)."""
        return tuple(self._poseidon.linear_hash_bytes(data))

    @staticmethod
    def keccak256(data: bytes) -> bytes:
        return _keccak.keccak256(data)
