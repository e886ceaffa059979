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
from . import gl3
from . import goldilocks as gl

LIBRARY = "stark"
launches = {"dag_eval": 0, "grand_product": 0}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_FUNCTIONS = {
    "stark_dag_plan": [_I, _LL, _P, _P, _P],
    "stark_dag_eval": [_P, _I, _P, _I, _P, _I, _P, _I, _P, _LL, _P, _LL, _LL,
                       _P],
    "stark_grand_product": [_P, _I, _LL, _P, _P],
    "stark_grand_product_plan": [_P],
}
DAG_ROWS = 256   # rows of one dag_eval_kernel tile (csrc/stark.cu TILE)
# csrc/stark.cu's grand-product kernel: a block is GP_LANES lanes, each
# running GP_RUN consecutive rows, of one argument; a launch takes
# GP_MAX_ARGS arguments; its scratch is GP_HEAD words and GP_ENTRY words a
# tile of each argument
GP_LANES = 32
GP_RUN = 16
GP_MAX_ARGS = 64
GP_HEAD = 4 + GP_MAX_ARGS
GP_ENTRY = 8
GP_LOOK = 4      # entries a lane reads a look-back step

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


def dag_plan(prog, rows: int) -> dict:
    """dag_eval_kernel's launch for `prog` over `rows` rows on the current
    card: its shared memory per block (`smem` bytes), its persistent grid,
    the leaf words of one gather step, and the scratch (`scratch` bytes:
    each block's [leaf word][tile row] region)."""
    smem, grid, stage = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
    err = _library().stark_dag_plan(prog.n_slots, max(rows, 1),
                                    ctypes.byref(smem), ctypes.byref(grid),
                                    ctypes.byref(stage))
    if err:
        raise RuntimeError(f"stark_dag_plan failed: cudaError {err}")
    return {"smem": smem.value, "grid": grid.value, "stage": stage.value,
            "scratch": 8 * grid.value * len(prog.leaves) * DAG_ROWS}


def dag_eval(prog, sections: list, uniforms: np.ndarray, out: torch.Tensor,
             flags: torch.Tensor | None, *, rows: int,
             prime_stride: int) -> None:
    """Run `prog` (a `stark.dag.Program`) over `rows` rows through
    csrc/stark.cu dag_eval_kernel: `sections` the tensors its leaves name,
    in `prog.sections` order ((rows,) or (rows, w), any row stride),
    `uniforms` its (n, 3) uint64 table, `out` (rows, w) int64 and `flags`
    (int32, one per flag output) on the same card. The kernel's leaf
    scratch (`dag_plan`) is allocated here for the launch."""
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
    with torch.cuda.device(dev):
        plan = dag_plan(prog, rows)
    uni = torch.from_numpy(
        (table if len(table) else np.zeros((1, 3), np.uint64))
        .view(np.int64)).to(dev)
    code = prog.device_code(dev)
    sec, col, nxt = (prog.leaves.astype(np.int64).T if len(prog.leaves)
                     else np.zeros((3, 1), np.int64))
    ptrs = np.array([s.data_ptr() for s in sections] or [0], np.int64)
    strides = np.array([s.stride(0) for s in sections] or [0], np.int64)
    leaves = torch.from_numpy(np.stack(
        [ptrs[sec] + 8 * col, strides[sec], nxt], axis=1)).to(dev)
    scratch = torch.empty(max(plan["scratch"] // 8, 1), dtype=torch.int64,
                          device=dev)
    _launch("stark_dag_eval", "dag_eval", dev, code.data_ptr(), prog.n_ops,
            uni.data_ptr(), prog.n_slots,
            leaves.data_ptr(), len(prog.leaves), scratch.data_ptr(),
            plan["grid"], out.data_ptr(), out.stride(0),
            flags.data_ptr() if flags is not None else None, rows,
            prime_stride % rows)


def grand_product_plan() -> dict:
    """The grand-product kernel's build and launch shape on the current
    card: rows of a tile, threads and registers of a block's thread, its
    stack bytes, a GL3 block's shared bytes and the GL3 blocks an SM
    holds."""
    out = (ctypes.c_int * 8)()
    err = _library().stark_grand_product_plan(out)
    if err:
        raise RuntimeError(f"stark_grand_product_plan failed: cudaError {err}")
    keys = ("tile", "threads", "registers", "local_bytes", "smem",
            "blocks_per_sm", "head", "entry")
    return dict(zip(keys, out))


# one look-back scratch per (card, stream): the kernel leaves it ready for
# its next launch, so it is zeroed only when it is allocated
_gp_scratch: dict = {}


def grand_product(args) -> None:
    """z of every (num, den, z) in `args` through csrc/stark.cu's
    grand-product kernel, one launch for up to GP_MAX_ARGS arguments: num
    and den (N,) or (N, 3), z an (N, 3) view, all int64 on one card with
    one N; z_0 = 1, z_i = prod_{j<i} num_j / den_j, and z = (1, 0, 0, ...)
    for an argument with a zero den (calculate_z's batch inversion). The
    argument table is the launch's parameter; the look-back scratch is
    cached per card and stream."""
    if not args:
        raise ValueError("stark_cuda: grand_product of no arguments")
    dev = args[0][2].device
    n = args[0][2].shape[0]
    table = np.empty((len(args), 8), np.int64)
    for i, (num, den, z) in enumerate(args):
        _check(num, f"num {i}", n)
        _check(den, f"den {i}", n)
        _check(z, f"z {i}", n, (3,))
        if num.device != dev or den.device != dev or z.device != dev:
            raise ValueError("stark_cuda: the arguments must be on one card, "
                             f"not {num.device}, {den.device} and {dev}")
        table[i] = (num.data_ptr(), num.stride(0), _dim(num),
                    den.data_ptr(), den.stride(0), _dim(den),
                    z.data_ptr(), z.stride(0))
    if not n:
        return
    tiles = -(-n // (GP_LANES * GP_RUN))
    words = GP_HEAD + min(len(args), GP_MAX_ARGS) * tiles * GP_ENTRY
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    scratch = _gp_scratch.get(key)
    if scratch is None or scratch.numel() < words:
        scratch = torch.zeros(words, dtype=torch.int64, device=dev)
        _gp_scratch[key] = scratch
    _launch("stark_grand_product", "grand_product", dev, table.ctypes.data,
            len(args), n, scratch.data_ptr())


def _field_mul(a, da: int, b, db: int):
    """a * b of dims da, db ((..., d) tensors), of dim max(da, db)."""
    if da == 3 and db == 3:
        return gl3.mul(a, b)
    if da == 3 or db == 3:
        return gl3.mul_base(a, b[..., 0]) if da == 3 else \
            gl3.mul_base(b, a[..., 0])
    return gl.mul(a, b)


def _field_one(shape, d: int):
    one = torch.zeros((*shape, d), dtype=torch.int64)
    one[..., 0] = 1
    return one


def grand_product_model(num, den, *, lanes: int = GP_LANES,
                        run: int = GP_RUN, look: int = GP_LOOK,
                        in_flight: int = 0):
    """z of one argument (num, den (N,) or (N, 3) int64 CPU tensors) by the
    grand-product kernel's decomposition in plain torch, at `lanes` lanes
    of `run` rows a tile: csrc/stark.cu's index maps (lane l of tile t runs
    rows t * lanes * run + l * run + k, rows past N read as 1), each run's
    forward products, one inverse and backward sweep, the lanes'
    Hillis-Steele scan of the runs' ratios (shfl_up), the tiles'
    aggregates and their look-back over windows of `look` * `lanes` tiles
    (each lane's own product of what it read, the lanes' product once at
    the end, in as many butterfly steps as lanes hold a value), where the `in_flight` tiles before each tile show only their
    aggregate (as when they are still running), and the zero flag's
    rewrite. Nothing on the main path calls it; tests hold it against
    calculate_z."""
    n = num.shape[0]
    nd, dd = _dim(num), _dim(den)
    rd = 3 if 3 in (nd, dd) else 1
    rows = lanes * run
    tiles = -(-n // rows)
    # 1. lane l of tile t runs rows t * rows + l * run + k, k < run; rows
    # past n read as num = den = 1
    r = (torch.arange(tiles)[:, None, None] * rows
         + torch.arange(lanes)[None, :, None] * run
         + torch.arange(run)[None, None, :])
    live = (r < n)[..., None]
    rc = r.clamp(max=n - 1)
    numv = torch.where(live, num.reshape(n, nd)[rc], _field_one((), nd))
    denv = torch.where(live, den.reshape(n, dd)[rc], _field_one((), dd))
    # 2. forward over each run; slot k keeps N_k
    den_p, num_p = _field_one((tiles, lanes), dd), _field_one((tiles, lanes),
                                                             nd)
    prefix = torch.empty_like(numv)
    for k in range(run):
        den_p = _field_mul(den_p, dd, denv[:, :, k], dd)
        num_p = _field_mul(num_p, nd, numv[:, :, k], nd)
        prefix[:, :, k] = num_p
    zero = bool((den_p == 0).all(-1).any())
    inv = gl3.inv(den_p) if dd == 3 else gl.inv(den_p)
    incl = _field_mul(num_p, nd, inv, dd)
    # 3. the lanes' inclusive scan
    off = 1
    while off < lanes:
        incl = torch.cat([incl[:, :off], _field_mul(incl[:, :-off], rd,
                                                    incl[:, off:], rd)], 1)
        off *= 2
    excl = torch.cat([_field_one((tiles, 1), rd), incl[:, :-1]], 1)
    agg = incl[:, -1]
    # 4. each tile's exclusive prefix by look-back: lane i reads tiles
    # base - i - lanes j (j < look); tiles before 0 read as an inclusive
    # prefix of 1; each lane keeps its own product until the walk ends
    window = look * lanes
    lane_ids = torch.arange(lanes)
    offset = lane_ids[:, None] + lanes * torch.arange(look)[None, :]
    one = _field_one((lanes, look), rd)
    inclusive = torch.empty((tiles, rd), dtype=torch.int64)
    carries = _field_one((tiles,), rd)
    inclusive[0] = agg[0]
    for t in range(1, tiles):
        acc = _field_one((lanes,), rd)
        base, span = t - 1, 0
        while True:
            idx = base - offset
            inc = (idx < 0) | (idx < t - in_flight)
            stop = int(offset[inc].min()) if bool(inc.any()) else window
            at = idx.clamp(min=0)
            v = torch.where(inc[..., None], inclusive[at], agg[at])
            v = torch.where(((idx < 0) | (offset > stop))[..., None], one, v)
            for j in range(look):
                acc = _field_mul(acc, rd, v[:, j], rd)
            if stop < window:
                span = max(span, min(stop + 1, lanes))
                break
            span = lanes
            base -= window
        step = 1
        while step < span:              # the warp's xor butterfly, only
            acc = _field_mul(acc, rd, acc[lane_ids ^ step], rd)
            step *= 2                   # over the lanes holding a value
        carries[t] = acc[0]
        inclusive[t] = _field_mul(carries[t], rd, agg[t], rd)
    # 5. backward over each run from its carry: S_k = S_(k+1) d_k is
    # carry / D_(k-1), z_k = N_(k-1) S_k
    carry = _field_mul(carries[:, None], rd, excl, rd)
    s = _field_mul(carry, rd, inv, dd)
    s = _field_mul(s, rd, denv[:, :, run - 1], dd)
    z = torch.zeros((tiles, lanes, run, 3), dtype=torch.int64)
    for k in range(run - 2, 0, -1):
        z[:, :, k + 1, :rd] = _field_mul(prefix[:, :, k], nd, s, rd)
        s = _field_mul(s, rd, denv[:, :, k], dd)
    if run > 1:
        z[:, :, 1, :rd] = _field_mul(prefix[:, :, 0], nd, s, rd)
    z[:, :, 0, :rd] = carry
    # 6. the rows past n dropped; the last block's rewrite under a zero flag
    z = z.reshape(tiles * rows, 3)[:n].clone()
    if zero:
        z.zero_()
        z[0, 0] = 1
    return z
