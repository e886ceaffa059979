"""Time one mode's kernel from several builds of the poseidon_gl library in
one process, in turns, so that two sources compare on one card:

    python3 -m zkevm_prover_tpu_torch.kernel_ab MODE LIB.so [LIB.so ...]
        [--bits 20 22] [--rounds 2] [--reps 10]

Each LIB.so is a build of the poseidon_gl library with this tree's C
interface (say `cuda_build.build(["poseidon_gl"])` run in a copy of the
package whose csrc/ holds a variant, or an older source). Each is loaded
with ctypes and given the active constant set as `poseidon_cuda` gives it,
its MODE kernel's output is held against `poseidon_gl.permute_plain` bit
for bit, and the kernel is timed alone on a batch already in its layout
with CUDA events (warm-up, then `--reps` launches), the libraries in the
order 1 .. n n .. 1 for each of `--rounds`. Prints the card, then one line
per library, size and turn.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from .ops import goldilocks as gl
from .ops import poseidon_constants as pc
from .ops import poseidon_cuda
from .ops import poseidon_gl as pg


def load(path: str) -> ctypes.CDLL:
    """A poseidon_gl library with the active constant set loaded."""
    lib = ctypes.CDLL(path)
    for fn, args in poseidon_cuda._FUNCTIONS["poseidon_gl"].items():
        f = getattr(lib, fn)
        f.argtypes = args
        f.restype = ctypes.c_int
    tab = poseidon_cuda._host_tables(pc.source())
    err = lib.poseidon_gl_set_constants(
        *[tab[k].ctypes.data for k in poseidon_cuda.GL_CONSTANTS])
    if err:
        raise RuntimeError(f"{path}: poseidon_gl_set_constants: {err}")
    return lib


def time_ms(run, reps: int) -> float:
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=sorted(poseidon_cuda._GL_PERMUTE))
    ap.add_argument("libs", nargs="+")
    ap.add_argument("--bits", type=int, nargs="+", default=[20, 22])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = [load(p) for p in args.libs]
    fn = poseidon_cuda._GL_PERMUTE[args.mode]
    stream = torch.cuda.current_stream().cuda_stream
    for bits in args.bits:
        states = np.random.default_rng(bits).integers(
            0, gl.P, size=(1 << bits, pg.WIDTH), dtype=np.uint64)
        x = gl.from_u64(states, "cuda")
        plain = pg.permute_plain(x)
        laid = x.T.contiguous() if args.mode == "1d" else x
        out = torch.empty_like(laid)

        def run(lib):
            err = getattr(lib, fn)(laid.data_ptr(), out.data_ptr(), 1 << bits,
                                   stream)
            if err:
                raise RuntimeError(f"{fn}: cudaError {err}")

        for path, lib in zip(args.libs, libs):
            run(lib)
            got = out.T if args.mode == "1d" else out
            if not torch.equal(got, plain):
                print(f"FAIL: {path} {args.mode} != plain at 2^{bits}")
                return 1
        order = list(range(len(libs)))
        for turn in range(args.rounds):
            for i in order + order[::-1]:
                ms = time_ms(lambda: run(libs[i]), args.reps)
                print(f"{args.mode} 2^{bits} turn {turn} lib {i} "
                      f"{args.libs[i]}: {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
