"""CLI — the zkProver process shell.

Port of `zkevm_prover_tpu/__main__.py`: the same options and the same
`batch_proof.json` layout, plus `--device` (CUDA unless told otherwise;
without CUDA the CLI exits nonzero unless given `cpu`). The server and
client run modes (the gRPC services) are not ported yet and raise.

Reference: src/main.cpp (`zkProver [-c config.json]`, main.cpp:293-845):
load config, construct the Prover, then launch servers / clients /
file-runners per the config's run-mode booleans.

Usage:
    python -m zkevm_prover_tpu_torch -c config.json
    python -m zkevm_prover_tpu_torch --prove input.json -o proof_dir/ \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

# config run modes that start a gRPC server or client
_SERVICE_MODES = ("runHashDBServer", "runExecutorServer",
                  "runAggregatorClient")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zkevm-prover-tpu-torch")
    ap.add_argument("-c", "--config", help="config JSON (reference schema)")
    ap.add_argument("--prove", help="one-shot: prove an input JSON file")
    ap.add_argument("-o", "--output", default="output", help="output dir")
    ap.add_argument("--device", default="cuda",
                    help="torch device to prove on (default cuda)")
    ap.add_argument("-v", "--version", action="store_true")
    args = ap.parse_args(argv)

    from . import __version__, resolve_device

    if args.version:
        print(f"zkevm-prover-tpu-torch {__version__}")
        return 0

    from .prover import ProofInput, Prover
    from .utils import Config, zklog

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        zklog.error(str(e))
        return 2
    cfg = Config.load(args.config)
    errors = cfg.check()
    if errors:
        for e in errors:
            zklog.error(e)
        return 1
    zklog.set_json_logs(cfg.jsonLogs)
    cfg.print()

    if args.prove or cfg.runFileGenBatchProof:
        prover = Prover(device=device)
        path = args.prove or cfg.runFileGenBatchProof
        with open(path) as f:
            inp = ProofInput.from_json(f.read())
        zklog.info(f"genBatchProof: {path} on {device}")
        t0 = time.time()
        bp = prover.gen_batch_proof(inp)
        ok = prover.verify_batch_proof(bp)
        zklog.info(f"batch proof done in {time.time() - t0:.1f}s "
                   f"verified={ok}")
        os.makedirs(args.output, exist_ok=True)
        out = {
            "publics": dataclasses.asdict(bp.publics),
            "counters": bp.counters,
            "proofs": {
                name: proof.to_json()
                for name, (prv, proof) in bp.sm_proofs.items()
            },
        }
        out_path = os.path.join(args.output, "batch_proof.json")
        with open(out_path, "w") as f:
            json.dump(out, f)
        zklog.info(f"proof written to {out_path}")
        return 0 if ok else 1

    modes = [m for m in _SERVICE_MODES if getattr(cfg, m)]
    if modes:
        raise NotImplementedError(
            f"{', '.join(modes)}: the gRPC services (services/ of the JAX "
            "package) are not ported yet")
    zklog.warning("nothing to run (no run-mode flags set)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
