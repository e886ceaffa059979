"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel library is one source under `csrc/` (with the headers it
includes) and a plain C interface. It is compiled for sm_90a into a shared
library under `build/`, in a directory
keyed by a hash of every file in `csrc/` and of the flags, so an edited
source is rebuilt and an unchanged one is built once. Nothing is built when
a module is imported: `load` builds at the first launch, and `build` starts
one nvcc per kernel, all at once, and waits for them together.
`sass_counts` reads a built library's SASS with cuobjdump:

    python -m zkevm_prover_tpu_torch.cuda_build [NAME | LIBRARY.so ...]

builds the named kernels (default: all) and prints nvcc's register and
spill log and the SASS instruction counts of each kernel in each library.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

# kernel library name -> its source under csrc/ (poseidon_gl.cu includes
# the 2d, mxu, mxu24, blocked and 1d kernels: one translation unit, one
# constant set; hash.cu holds Keccak-f and the SHA-256 and Blake2b
# compressions; bn254.cu the SNARK wrap's G1 MSM and fixed-base kernels
# and the Fr NTT, bn254_g2.cu the same source's G2 kernels, built apart so
# that the two nvcc runs overlap; stark.cu the STARK prover's row-program
# interpreter and grand products)
KERNELS = {"poseidon_gl": "poseidon_gl.cu", "hash": "hash.cu",
           "bn254": "bn254.cu", "bn254_g2": "bn254_g2.cu",
           "stark": "stark.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _tool(name: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (cuda_home and os.path.join(cuda_home, "bin", name),
                 shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found: the CUDA kernels need the CUDA "
                       "toolkit")


def nvcc() -> str:
    return _tool("nvcc")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD / f"{name}-{_key()}" / f"lib{name}.so"


def log_path(name: str) -> Path:
    """nvcc's output for the build (with -Xptxas -v: registers, spills)."""
    return library_path(name).with_name("build.log")


def build(names=None) -> dict[str, Path]:
    """Build the named kernels (default: all) that are not built yet, one
    nvcc process each, all started together. Raises if any build fails."""
    names = list(KERNELS) if names is None else list(names)
    running = []
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / KERNELS[name])]
        log = open(log_path(name), "w")
        running.append((name, lib, tmp, log,
                         subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT)))
    failed = []
    for name, lib, tmp, log, proc in running:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name}: nvcc exit {rc}\n{log_path(name).read_text()}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    return ctypes.CDLL(str(build([name])[name]))


# SASS opcode classes counted by sass_counts (an instruction counts in each
# class whose prefix its opcode has; "all" counts every instruction)
SASS_CLASSES = ("IMAD", "IMAD.WIDE", "IMAD.HI", "IMAD.X", "IADD3", "ISETP",
                "SEL", "LOP3", "SHF", "LDC", "LEA", "MOV", "BRA", "BAR",
                "LDG", "STG", "LDS", "STS")
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_counts(path: Path) -> dict[str, dict]:
    """Per kernel of the built library (cuobjdump -sass): the count of each
    SASS_CLASSES prefix and of all instructions ("counts"), its loops (a
    backward branch and the code it jumps back over) and its guarded
    blocks (a predicated forward branch and the code it skips, kept only
    where that code holds a loop), each as (first, last instruction index,
    size, the span's counts). A span's code runs once per trip or pass, so
    a kernel's per-thread instruction count is its counts with each span
    weighted by its trips."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(path)],
                         capture_output=True, text=True, check=True).stdout
    kernels: dict[str, dict] = {}
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name = part.split("\n", 1)[0].strip()
        insts = [(int(a, 16), pred, op, rest) for a, pred, op, rest in
                 _SASS_LINE.findall(part)]
        index = {addr: i for i, (addr, *_) in enumerate(insts)}
        loops, guarded = [], []
        for i, (addr, pred, op, rest) in enumerate(insts):
            m = re.search(r"0x([0-9a-f]+)", rest)
            if not (op.startswith("BRA") and m):
                continue
            to = index.get(int(m.group(1), 16))
            if to is not None and to <= i:
                loops.append((to, i, i - to + 1, _count(insts[to:i + 1])))
            elif to is not None and pred:
                guarded.append((i + 1, to - 1, to - i - 1,
                                _count(insts[i + 1:to])))
        guarded = [g for g in guarded
                   if any(g[0] <= lp[0] and lp[1] <= g[1] for lp in loops)]
        kernels[name] = {"counts": _count(insts), "loops": loops,
                         "guarded": guarded}
    return kernels


def _count(insts) -> dict:
    """SASS_CLASSES counts, "all", and "op:BASE" for each base opcode."""
    counts = collections.Counter()
    for _, _, op, _ in insts:
        if op == "NOP":
            continue
        counts["all"] += 1
        counts["op:" + op.split(".")[0]] += 1
        for cls in SASS_CLASSES:
            if op == cls or op.startswith(cls + "."):
                counts[cls] += 1
    return dict(counts)


def main(argv) -> int:
    for arg in argv or list(KERNELS):
        if arg.endswith(".so"):
            path = Path(arg)
        else:
            path = build([arg])[arg]
            print(log_path(arg).read_text().strip())
        for kernel, info in sass_counts(path).items():
            print(f"{path.name} {kernel}: {info['counts']}")
            for kind in ("loops", "guarded"):
                for first, last, size, counts in info[kind]:
                    print(f"  {kind[:-1] if kind == 'loops' else kind} "
                          f"[{first}, {last}] {size} instructions: {counts}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
