"""HashDB — the state layer (counterpart of `zkevm_prover_tpu/hashdb`).

Host copies of the JAX package's modules, with their imports rewritten to
the port: a Poseidon sparse Merkle tree (`smt`), a node/program store with
an in-memory map and optional file persistence (`database`, fronted by the
read caches of `cache`), per-batch write buffering with versioning
(`state_manager`), and the `HashDB` facade that the executor and the
services call (`hashdb_interface`). Single get/set calls hash on the host
(a handful of permutations each, latency-bound), as in the JAX package;
bulk tree builds hash through the Poseidon kernel
(`executor/examples.state_tree`).
"""

from .database import Database
from .smt import Smt, SmtGetResult, SmtSetResult
from .state_manager import StateManager
from .hashdb_interface import HashDB

__all__ = [
    "Database", "Smt", "SmtGetResult", "SmtSetResult", "StateManager", "HashDB",
]
