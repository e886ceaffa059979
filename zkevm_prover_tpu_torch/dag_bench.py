"""Time the row-program interpreter (csrc/stark.cu dag_eval_kernel) on the
main path's programs over random sections on the card, each checked bit for
bit against `dag.run_plain`:

    python3 -m zkevm_prover_tpu_torch.dag_bench [--root DIR ...]

The small combined AIR's programs (`executor.examples.small_rom_batch`: the
combined AIR's constraint set and section widths) at the combined prove's
rows (2^17 trace rows, blowup 8): C * Zi and the FRI sums at 2^20 rows,
f/t and num/den at 2^17 and num/den again at 2^17 + 37; then arith's C * Zi
(the program of most slots on the main path) at its prove's 2^21 extended
rows. Each `--root` names a checkout whose package is imported in its own
process, in turn, so that two trees compare in one call (ABBA: give
parent, change, change, parent). Prints one JSON line per tree and
program: instructions, slots, rows, kernel ms (CUDA events over 5 launches
after one warm-up), equal to the twin, and the launch's shared memory per
block and grid where the tree's wrapper plans one; then the card's name."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPS = 5


def _programs():
    from zkevm_prover_tpu_torch.executor import combined, examples
    from zkevm_prover_tpu_torch.executor.sm import arith
    from zkevm_prover_tpu_torch.stark.prover import StarkProver
    from zkevm_prover_tpu_torch.stark.setup import StarkSetup

    def prover(air):
        return StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                           device="cpu")

    _, _, batch = examples.small_rom_batch("cpu")
    rom = prover(combined.build_batch_air(batch.rom, batch.n_bits,
                                          include=batch.include))
    ari = prover(arith.build_air(9))
    n = 1 << 17
    return {"quotient": (rom, rom._prog_q, 8 * n, 8),
            "fri": (rom, rom._prog_fri, 8 * n, 8),
            "f_t": (rom, rom._prog_ft[0], n, 1),
            "num_den": (rom, rom._prog_num_den[0], n, 1),
            "num_den_ragged": (rom, rom._prog_num_den[0], n + 37, 1),
            "arith_quotient": (ari, ari._prog_q, 16 * n, 8)}


def run(tag: str) -> None:
    import numpy as np
    import torch

    from zkevm_prover_tpu_torch.ops import goldilocks as gl
    from zkevm_prover_tpu_torch.ops import stark_cuda
    from zkevm_prover_tpu_torch.stark import dag

    rng = np.random.default_rng(31)

    def u(*shape):
        return gl.from_u64(rng.integers(0, gl.P, shape, dtype=np.uint64),
                           "cuda")

    for name, (prover, prog, rows, stride) in _programs().items():
        setup = prover.setup
        ch = rng.integers(0, gl.P, (8, 3), dtype=np.uint64)
        pub = [int(v) for v in rng.integers(0, gl.P, len(setup.air.publics),
                                            dtype=np.uint64)]
        ev = rng.integers(0, gl.P, (len(setup.ev_map), 3), dtype=np.uint64)
        secs = {k: u(rows, w) for k, w in setup.section_width.items()}
        secs.update(const=u(rows, setup.air.n_constants), x=u(rows),
                    zi=u(rows))
        uni = prog.uniform_values(ch, pub, ev)
        width = max(o.col + 3 for o in prog.outputs)
        out = torch.full((rows, width), -1, dtype=torch.int64, device="cuda")
        want = out.clone()

        def launch():
            dag.run(prog, secs, uni, out, rows=rows, prime_stride=stride)

        launch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            launch()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / REPS
        dag.run_plain(prog, secs, uni, want, rows=rows, prime_stride=stride)
        line = {"tree": tag, "program": name, "rows": rows,
                "instructions": prog.n_ops, "slots": prog.n_slots, "ms": ms,
                "equal": bool(torch.equal(out, want))}
        if hasattr(stark_cuda, "dag_plan"):   # trees before it plan none
            plan = stark_cuda.dag_plan(prog, rows)
            line.update(smem=plan["smem"], grid=plan["grid"])
        print(json.dumps(line), flush=True)
        del secs, out, want
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=[],
                    help="a checkout to time (default: this one)")
    roots = ap.parse_args().root
    rc = 0
    if not roots:
        run("this tree")
    for root in roots:
        rc |= subprocess.run(
            [sys.executable, "-c",
             "import runpy, sys; sys.path.insert(0, sys.argv[1]); "
             "runpy.run_path(sys.argv[2])['run'](sys.argv[3])",
             str(Path(root).resolve()), __file__, root], cwd=root).returncode
    import torch
    print(torch.cuda.get_device_name(0))
    return rc


if __name__ == "__main__":
    sys.exit(main())
