"""Time the grand products (csrc/stark.cu's grand-product kernel through
`stark.prover.grand_products`) on the card, optionally against another
checkout's kernel in the same process:

    python3 -m zkevm_prover_tpu_torch.gp_bench [--parent DIR] [--rounds 1]
        [--profile]

Two sets. "air": every argument of the small combined AIR
(`executor.examples.small_rom_batch`: the combined AIR's lookups,
permutations and connections, 68 GL3 arguments), num and den from its
num/den program run by dag_eval_kernel over random sections at 2^17 rows,
z into column views of one section, as `StarkProver._phase3` lays them
out, in one call (two launches: 64 arguments, then 4).
"single": one argument of random base (1, 1) or GL3 (3, 3) operands at
2^10, 2^17, 2^20 and 2^20 + 37 rows. Every call's z is checked against
`calculate_z` on the card.

`--parent DIR` loads DIR's `zkevm_prover_tpu_torch` package under another
name beside this one (its own build, library and counters) and times the
two in turns, parent, this, this, parent, for each of `--rounds`; a turn
is `REPS` calls (CUDA events after a warm-up) and also gives the host's
seconds to enqueue one call. `--profile` runs one call of
each case (of each tree) under torch.profiler and prints the device ms by
kernel. Prints one JSON line per measurement, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

from .card_bench import device_profile
from .msm_bench import load_tree

REPS = 10
SINGLE = [(bits, dims) for bits in (10, 17, 20, "20+37")
          for dims in ((1, 1), (3, 3))]


def _rows(bits) -> int:
    return (1 << 20) + 37 if bits == "20+37" else 1 << bits


def _air_args(torch, n: int):
    """(args, dims) of the small combined AIR's grand products at n rows:
    num and den views of its num/den program's output over random
    sections, z views of one (n, 3 * args) section."""
    from .executor import combined, examples
    from .ops import goldilocks as gl
    from .stark import dag
    from .stark.prover import StarkProver
    from .stark.setup import StarkSetup

    _, _, batch = examples.small_rom_batch("cpu")
    prover = StarkProver(StarkSetup(
        combined.build_batch_air(batch.rom, batch.n_bits,
                                 include=batch.include),
        n_queries=8, fri_fold_bits=2), device="cpu")
    setup = prover.setup
    prog, width, layout = prover._prog_num_den
    rng = np.random.default_rng(17)

    def u(*shape):
        return gl.from_u64(rng.integers(0, gl.P, shape, dtype=np.uint64),
                           "cuda")

    secs = {k: u(n, w) for k, w in setup.section_width.items()}
    secs.update(const=u(n, setup.air.n_constants), x=u(n), zi=u(n))
    ch = rng.integers(0, gl.P, (8, 3), dtype=np.uint64)
    pub = [int(v) for v in rng.integers(0, gl.P, len(setup.air.publics),
                                        dtype=np.uint64)]
    ev = rng.integers(0, gl.P, (len(setup.ev_map), 3), dtype=np.uint64)
    nd = torch.zeros((n, width), dtype=torch.int64, device="cuda")
    dag.run(prog, secs, prog.uniform_values(ch, pub, ev), nd, rows=n,
            prime_stride=1)
    del secs
    z = torch.full((n, 3 * len(layout)), -1, dtype=torch.int64,
                   device="cuda")
    args, dims = [], []
    for k, (nc, ndim, dc, ddim) in enumerate(layout):
        args.append((nd[:, nc] if ndim == 1 else nd[:, nc:nc + 3],
                     nd[:, dc] if ddim == 1 else nd[:, dc:dc + 3],
                     z[:, 3 * k:3 * k + 3]))
        dims.append((ndim, ddim))
    return args, dims


def _single_args(torch, n: int, dims):
    from .ops import goldilocks as gl

    rng = np.random.default_rng(n + dims[1])
    shape = lambda d: (n,) if d == 1 else (n, 3)
    num = gl.from_u64(rng.integers(0, gl.P, shape(dims[0]),
                                   dtype=np.uint64), "cuda")
    den = gl.from_u64(rng.integers(1, gl.P, shape(dims[1]),
                                   dtype=np.uint64), "cuda")
    z = torch.full((n, 3), -1, dtype=torch.int64, device="cuda")
    return [(num, den, z)], [dims]


def _time(torch, fn) -> tuple[float, float]:
    """(device-side ms a call over REPS calls by CUDA events, host ms to
    enqueue one call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS, host


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another checkout to time against")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gp_bench: needs a CUDA card", file=sys.stderr)
        return 1
    from .stark import prover as sp

    trees = {"this": sp}
    if opts.parent:
        alias = "gp_parent_tree"
        load_tree(opts.parent, alias)
        import importlib

        trees["parent"] = importlib.import_module(f"{alias}.stark.prover")
    order = (["parent", "this", "this", "parent"] if opts.parent
             else ["this"])
    cases = [("air", 17, None)] + [("single", b, d) for b, d in SINGLE]
    rc = 0
    for kind, bits, dims in cases:
        n = _rows(bits)
        if kind == "air":
            args, all_dims = _air_args(torch, n)
        else:
            args, all_dims = _single_args(torch, n, dims)
        want = [sp.calculate_z(num, den) for num, den, _ in args]
        name = f"{kind}:{bits}" + (f":{dims[0]}{dims[1]}" if dims else "")
        for rnd in range(opts.rounds):
            for tree in order:
                prover = trees[tree]
                for _, _, z in args:
                    z.fill_(-1)
                ms, host = _time(torch, lambda: prover.grand_products(args))
                equal = all(torch.equal(z, w)
                            for (_, _, z), w in zip(args, want))
                rc |= 0 if equal else 1
                print(json.dumps({"case": name, "tree": tree, "round": rnd,
                                  "rows": n, "arguments": len(args),
                                  "dims": sorted(set(all_dims)), "ms": ms,
                                  "host_ms": host, "equal": equal}),
                      flush=True)
        if opts.profile:
            for tree in dict.fromkeys(order):
                prover = trees[tree]
                prof = device_profile(
                    torch, lambda: prover.grand_products(args))
                print(json.dumps({"case": name, "tree": tree,
                                  "profile": prof}), flush=True)
        del args, want
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi or torch.cuda.get_device_name(0))
    return rc


if __name__ == "__main__":
    sys.exit(main())
