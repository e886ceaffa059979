"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one source under `csrc/` with a plain C interface. It is
compiled for sm_90a into a shared library under `build/`, in a directory
keyed by a hash of every file in `csrc/` and of the flags, so an edited
source is rebuilt and an unchanged one is built once. Nothing is built when
a module is imported: `load` builds at the first launch, and `build` starts
one nvcc per kernel, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

# kernel name -> its source under csrc/
KERNELS = {"poseidon_gl": "poseidon_gl.cu",
           "poseidon_gl_blocked": "poseidon_gl_blocked.cu",
           "poseidon_gl_soa": "poseidon_gl_soa.cu",
           "poseidon_gl_mma": "poseidon_gl_mma.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


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
