"""Wrappers of the STARK prover's CUDA kernels: the row-program interpreter
and the grand products (csrc/stark.cu, one library,
`cuda_build.KERNELS["stark"]`).

Each wrapper takes int64 CUDA tensors, checks what its kernel takes and
raises on anything else, launches on the current stream and adds one to
`launches[name]`. Nothing falls back to the plain versions
(`stark.dag.run_plain`, `stark.prover.calculate_z`): the callers in
`stark/dag.py` (`run`) and `stark/prover.py` (`grand_products`) take the
plain version for a CPU tensor and these for a CUDA tensor. The kernels'
note in csrc/stark.cu says what TPU-side programs they replace and what
bounds them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build

LIBRARY = "stark"
launches = {"dag_eval": 0, "grand_product": 0}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_FUNCTIONS = {
    "stark_dag_eval": [_P, _I, _P, _P, _P, _I, _P, _LL, _P, _LL, _LL, _P],
    "stark_grand_product": [_P, _I, _LL, _P, _P, _P],
}
GP_ROWS = 1024   # rows of one grand-product block (csrc/stark.cu GP_ROWS)

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load(LIBRARY)
        for fn, args in _FUNCTIONS.items():
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(t: torch.Tensor, what: str, rows: int, widths=(1, 3)) -> None:
    """A CUDA int64 tensor of `rows` rows: (rows,), any row stride, or
    (rows, w) for w in `widths` (None: any) with unit column stride."""
    if not t.is_cuda:
        raise ValueError(f"stark_cuda: {what} must be a CUDA tensor")
    if t.dtype != torch.int64:
        raise TypeError(f"stark_cuda: {what} must be int64, not {t.dtype}")
    if t.ndim == 1:
        ok = widths is None or 1 in widths
    elif t.ndim == 2:
        ok = (widths is None or t.shape[1] in widths) and (
            t.shape[1] <= 1 or t.stride(1) == 1)
    else:
        ok = False
    if not ok or t.shape[0] != rows:
        raise ValueError(f"stark_cuda: {what} must be ({rows},) or ({rows}, "
                         f"{widths or 'w'}) with unit column stride, not "
                         f"{tuple(t.shape)} strides {t.stride()}")


def _dim(t: torch.Tensor) -> int:
    return t.shape[1] if t.ndim == 2 else 1


def _launch(fn: str, name: str, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(_library(), fn)(*args, stream)
    if err:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
    launches[name] += 1


def dag_eval(prog, sections: list, uniforms: np.ndarray, out: torch.Tensor,
             flags: torch.Tensor | None, *, rows: int,
             prime_stride: int) -> None:
    """Run `prog` (a `stark.dag.Program`) over `rows` rows through
    csrc/stark.cu dag_eval_kernel: `sections` the tensors its loads name,
    in `prog.sections` order ((rows,) or (rows, w)), `uniforms` its
    (n, 3) uint64 table, `out` (rows, w) int64 and `flags` (int32, one
    per flag output) on the same card."""
    dev = out.device
    _check(out, "out", rows, None)
    if len(sections) != len(prog.sections):
        raise ValueError(f"stark_cuda: {len(prog.sections)} sections, "
                         f"{len(sections)} given")
    for key, s in zip(prog.sections, sections):
        _check(s, f"section {key}", rows, None)
        if s.device != dev:
            raise ValueError(f"stark_cuda: section {key} on {s.device}, "
                             f"out on {dev}")
    if prog.n_flags:
        if flags is None or not flags.is_cuda or flags.device != dev or \
                flags.dtype != torch.int32 or flags.numel() < prog.n_flags:
            raise ValueError(f"stark_cuda: the program raises "
                             f"{prog.n_flags} flags: give an int32 tensor "
                             f"of that many on {dev}")
    table = np.asarray(uniforms, dtype=np.uint64).reshape(-1, 3)
    if len(table) != len(prog.uniform_roots):
        raise ValueError(f"stark_cuda: {len(prog.uniform_roots)} uniform "
                         f"values, {len(table)} given")
    if not rows or not prog.n_ops:
        return
    uni = torch.from_numpy(
        (table if len(table) else np.zeros((1, 3), np.uint64))
        .view(np.int64)).to(dev)
    code = prog.device_code(dev)
    ptrs = (ctypes.c_void_p * len(sections))(
        *[s.data_ptr() for s in sections])
    strides = (ctypes.c_longlong * len(sections))(
        *[s.stride(0) for s in sections])
    _launch("stark_dag_eval", "dag_eval", dev, code.data_ptr(), prog.n_ops,
            uni.data_ptr(), ptrs, strides, len(sections), out.data_ptr(),
            out.stride(0), flags.data_ptr() if flags is not None else None,
            rows, prime_stride % rows)


def grand_product(args) -> None:
    """z of every (num, den, z) in `args` through csrc/stark.cu's three
    grand-product passes, one launch of each over all the arguments: num
    and den (N,) or (N, 3), z an (N, 3) view, all int64 on one card with
    one N; z_0 = 1, z_i = prod_{j<i} num_j / den_j, and z = (1, 0, 0, ...)
    for an argument with a zero den (calculate_z's batch inversion)."""
    if not args:
        raise ValueError("stark_cuda: grand_product of no arguments")
    dev = args[0][2].device
    n = args[0][2].shape[0]
    table = []
    for i, (num, den, z) in enumerate(args):
        _check(num, f"num {i}", n)
        _check(den, f"den {i}", n)
        _check(z, f"z {i}", n, (3,))
        for t in (num, den, z):
            if t.device != dev:
                raise ValueError("stark_cuda: the arguments must be on one "
                                 f"card, not {t.device} and {dev}")
        table.append([num.data_ptr(), num.stride(0), _dim(num),
                      den.data_ptr(), den.stride(0), _dim(den),
                      z.data_ptr(), z.stride(0)])
    if not n:
        return
    n_blocks = -(-n // GP_ROWS)
    gp = torch.tensor(table, dtype=torch.int64).to(dev)
    totals = torch.empty((len(args), n_blocks, 3), dtype=torch.int64,
                         device=dev)
    flags = torch.zeros(len(args), dtype=torch.int32, device=dev)
    _launch("stark_grand_product", "grand_product", dev, gp.data_ptr(),
            len(args), n, totals.data_ptr(), flags.data_ptr())
