"""Config — flat JSON config with per-field environment overrides.

Port of `zkevm_prover_tpu/utils/config.py`: a host copy, the same fields
and load order.

Reference: src/config/config.{hpp,cpp} (~200 fields; ParseString(config,
jsonKey, ENV_NAME, field, default) pattern at config.cpp:235-268; check()
validates artifact existence at config.cpp:535-646; printed at startup).

Fields cover the run-mode booleans, service ports, artifact paths and tuning
knobs this framework consumes; unknown JSON keys are kept in `extra` so
reference config files load without error.
"""

from __future__ import annotations

import dataclasses
import json
import os

from .zklog import zklog

_FIELDS: list[tuple[str, str, object]] = [
    # (jsonKey / attr, ENV_NAME, default)
    ("runAggregatorClient", "RUN_AGGREGATOR_CLIENT", False),
    ("runAggregatorServer", "RUN_AGGREGATOR_SERVER", False),
    ("runExecutorServer", "RUN_EXECUTOR_SERVER", False),
    ("runHashDBServer", "RUN_HASHDB_SERVER", False),
    ("runFileGenBatchProof", "RUN_FILE_GEN_BATCH_PROOF", ""),
    ("runFileGenAggregatedProof", "RUN_FILE_GEN_AGGREGATED_PROOF", ""),
    ("runFileGenFinalProof", "RUN_FILE_GEN_FINAL_PROOF", ""),
    ("runProverTest", "RUN_PROVER_TEST", False),
    ("aggregatorClientHost", "AGGREGATOR_CLIENT_HOST", "127.0.0.1"),
    ("aggregatorClientPort", "AGGREGATOR_CLIENT_PORT", 50081),
    ("aggregatorServerPort", "AGGREGATOR_SERVER_PORT", 50081),
    ("aggregatorClientWatchdogTimeout", "AGGREGATOR_CLIENT_WATCHDOG_TIMEOUT", 60_000_000),
    ("aggregatorClientMaxStreams", "AGGREGATOR_CLIENT_MAX_STREAMS", 0),
    ("executorServerPort", "EXECUTOR_SERVER_PORT", 50071),
    ("hashDBServerPort", "HASHDB_SERVER_PORT", 50061),
    ("hashDBURL", "HASHDB_URL", "local"),
    ("databaseURL", "DATABASE_URL", "local"),
    ("dbNodesTableName", "DB_NODES_TABLE_NAME", "state.nodes"),
    ("dbProgramTableName", "DB_PROGRAM_TABLE_NAME", "state.program"),
    ("stateManager", "STATE_MANAGER", True),
    ("useAssociativeCache", "USE_ASSOCIATIVE_CACHE", False),
    ("inputFile", "INPUT_FILE", ""),
    ("outputPath", "OUTPUT_PATH", "output"),
    ("configPath", "CONFIG_PATH", "config"),
    ("proverName", "PROVER_NAME", "zkevm-prover-tpu"),
    ("proofDomainBits", "PROOF_DOMAIN_BITS", 16),
    ("proofQueries", "PROOF_QUERIES", 32),
    ("proofFoldBits", "PROOF_FOLD_BITS", 4),
    ("meshShape", "MESH_SHAPE", ""),
    ("saveProofToFile", "SAVE_PROOF_TO_FILE", True),
    ("saveInputToFile", "SAVE_INPUT_TO_FILE", False),
    ("saveOutputToFile", "SAVE_OUTPUT_TO_FILE", True),
    ("jsonLogs", "JSON_LOGS", False),
    ("maxExecutorThreads", "MAX_EXECUTOR_THREADS", 20),
    ("maxProverThreads", "MAX_PROVER_THREADS", 8),
    ("maxHashDBThreads", "MAX_HASHDB_THREADS", 8),
]


@dataclasses.dataclass
class Config:
    extra: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for key, _env, default in _FIELDS:
            if not hasattr(self, key):
                setattr(self, key, default)

    @classmethod
    def load(cls, path: str | None = None) -> "Config":
        """JSON file -> env overrides -> defaults (reference load order)."""
        cfg = cls()
        data = {}
        if path:
            with open(path) as f:
                data = json.load(f)
        for key, env, default in _FIELDS:
            val = data.get(key, default)
            if env in os.environ:
                raw = os.environ[env]
                if isinstance(default, bool):
                    val = raw.lower() in ("1", "true", "yes")
                elif isinstance(default, int):
                    val = int(raw)
                else:
                    val = raw
            setattr(cfg, key, val)
        known = {k for k, _, _ in _FIELDS}
        cfg.extra = {k: v for k, v in data.items() if k not in known}
        return cfg

    def check(self) -> list[str]:
        """Validate (reference: Config::check); returns error strings."""
        errors = []
        if self.runFileGenBatchProof and not os.path.exists(self.runFileGenBatchProof):
            errors.append(f"runFileGenBatchProof file not found: {self.runFileGenBatchProof}")
        if self.proofDomainBits < 4 or self.proofDomainBits > 30:
            errors.append(f"proofDomainBits out of range: {self.proofDomainBits}")
        for port_key in ("aggregatorServerPort", "executorServerPort", "hashDBServerPort"):
            port = getattr(self, port_key)
            if not (0 < int(port) < 65536):
                errors.append(f"{port_key} invalid: {port}")
        return errors

    def print(self) -> None:
        for key, _env, _d in _FIELDS:
            zklog.info(f"config.{key} = {getattr(self, key)}")

    def to_json(self) -> str:
        d = {k: getattr(self, k) for k, _, _ in _FIELDS}
        d.update(self.extra)
        return json.dumps(d, indent=2)
