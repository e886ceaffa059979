"""Commit-pols checkpoint / resume.

Reference: the commit-pols arena can be file-mapped (config.zkevmCmPols,
prover.cpp:98-106) or saved right after execution
(config.zkevmCmPolsAfterExecutor, config.hpp:120-121), and the standalone
STARK test resumes proving from a saved commit file without re-running
the executor (test/prover/main.cpp:6-50).  These are the reference's only
checkpoints: execution and proving are decoupled at the commit-pols
boundary.

Port of `zkevm_prover_tpu/prover/checkpoint.py`: the same file format,
byte for byte. Here the "arena" is the executor's {sm_name: (N, n_cols)}
trace dict: uint64 ndarrays, or int64 tensors holding the u64 bit patterns
on the card or the CPU (copied to the host as they are written). The
file layout is mmap-friendly: a 4 KiB JSON header (names, shapes,
publics, format version) followed by each array raw
little-endian uint64, each section 4 KiB-aligned, so `load_commit_pols`
can hand the prover zero-copy views of a 50 GB production file.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

MAGIC = "zkevm-tpu-cmpols"
VERSION = 1
ALIGN = 4096


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def _host_u64(trace) -> np.ndarray:
    """A trace as a contiguous host uint64 array (an int64 tensor's bit
    patterns reinterpreted, not converted)."""
    if isinstance(trace, torch.Tensor):
        if trace.dtype != torch.int64:
            raise TypeError(f"a trace tensor must be int64, not "
                            f"{trace.dtype}")
        return np.ascontiguousarray(trace.cpu().numpy()).view(np.uint64)
    return np.ascontiguousarray(trace, dtype=np.uint64)


def save_commit_pols(path: str, traces: dict,
                     publics: dict | None = None,
                     meta: dict | None = None) -> None:
    """Write the executor's per-SM commit columns as one resumable file."""
    names = sorted(traces)
    sections = []
    offset = ALIGN  # header page
    for name in names:
        arr = _host_u64(traces[name])
        sections.append((name, arr, offset))
        offset = _align(offset + arr.nbytes)
    header = {
        "magic": MAGIC, "version": VERSION,
        "publics": publics or {}, "meta": meta or {},
        "sections": [
            {"name": name, "offset": off, "shape": list(arr.shape)}
            for name, arr, off in sections],
    }
    hdr = json.dumps(header).encode()
    assert len(hdr) < ALIGN, "header exceeds one page"
    with open(path, "wb") as f:
        f.write(hdr.ljust(ALIGN, b"\x00"))
        for _, arr, off in sections:
            f.seek(off)
            f.write(arr.astype("<u8", copy=False).tobytes())
        f.truncate(offset)


def load_commit_pols(path: str, mmap: bool = True
                     ) -> tuple[dict[str, np.ndarray], dict]:
    """Load a checkpoint; with mmap=True the arrays are zero-copy views
    (the reference's mmapped arena, prover.cpp:98-106)."""
    with open(path, "rb") as f:
        hdr = json.loads(f.read(ALIGN).rstrip(b"\x00").decode())
    if hdr.get("magic") != MAGIC:
        raise ValueError(f"{path}: not a commit-pols checkpoint")
    if hdr.get("version") != VERSION:
        raise ValueError(f"{path}: unsupported version {hdr.get('version')}")
    size = os.path.getsize(path)
    traces = {}
    for sec in hdr["sections"]:
        shape = tuple(sec["shape"])
        nbytes = 8 * int(np.prod(shape))
        if sec["offset"] + nbytes > size:
            raise ValueError(f"{path}: truncated section {sec['name']}")
        if mmap:
            traces[sec["name"]] = np.memmap(
                path, dtype="<u8", mode="r", offset=sec["offset"],
                shape=shape)
        else:
            with open(path, "rb") as f:
                f.seek(sec["offset"])
                traces[sec["name"]] = np.frombuffer(
                    f.read(nbytes), dtype="<u8").reshape(shape).copy()
    return traces, hdr
