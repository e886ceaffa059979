"""Wrappers of the BN254 kernels of the SNARK wrap (csrc/bn254.cu, built
as two libraries: `cuda_build.KERNELS["bn254"]`, the G1 kernels and the Fr
NTT, and `["bn254_g2"]`, the G2 kernels): the Pippenger MSM over G1 and
G2, the fixed-base products k * G of the Groth16 CRS and the Fr NTT with
its pointwise quotient step.

Each wrapper takes int32 CUDA tensors of 32-bit limbs in ordinary form (the
layouts of `bn254_device`), checks what its kernels take and raises on
anything else, launches them on the current stream, raises if a launch
returns an error, and adds one to `launches[name]`. Nothing falls back to
the plain twins: `bn254_device` takes them for CPU tensors and these for
CUDA tensors. The note in csrc/bn254.cu says what TPU-side program or host
loop each kernel replaces and what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_build
from . import bn254_device as bd
from . import bn254 as host
from .bn254 import R

LIBRARIES = {False: "bn254", True: "bn254_g2"}   # by group: G2 or not
launches = {"g1_msm": 0, "g2_msm": 0, "g1_fixed_base": 0, "g2_fixed_base": 0,
            "fr_ntt": 0, "fr_pointwise": 0}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# every library's functions, then the G1 library's Fr functions
_FUNCTIONS = {
    "bn254_params": [_P],
    "bn254_msm_sort": [_P, _P, _LL, _I, _I] + [_P] * 8,
    "bn254_msm_sum": [_P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _I]
                     + [_P] * 9,
    "bn254_fixed_base_table": [_P, _I, _I, _P, _P, _P],
    "bn254_fixed_base": [_P, _P, _LL, _I, _I, _P, _P],
}
_FR_FUNCTIONS = {
    "bn254_fr_powers": [_P, _LL, _P, _P, _P],
    "bn254_fr_ntt": [_P, _P, _P, _P, _P, _I] + [_P, _P, _I] * 3
                    + [_P, _I, _P],
    "bn254_fr_pointwise": [_P, _P, _P, _P, _P, _LL, _P],
}

_libs: dict = {}
_tables: dict = {}   # (g2, c, device) -> the fixed-base table on the card
_powers: dict = {}   # (base, count, scale, device) -> Montgomery powers
_ntt: dict = {}      # (logn, inverse, shift, post, device) -> kernel args


def _library(g2: bool):
    if g2 not in _libs:
        lib = cuda_build.load(LIBRARIES[g2])
        functions = dict(_FUNCTIONS, **({} if g2 else _FR_FUNCTIONS))
        for fn, args in functions.items():
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = ctypes.c_int
        params = (ctypes.c_int * 6)()
        lib.bn254_params(params)
        if tuple(params) != (FB_RUN, FB_THREADS[g2], bd.NTT_TILE_LOG,
                             2 if g2 else 1, REDUCE_MAX,
                             len(bd.NTT_PLAN_FIELDS)):
            raise RuntimeError(f"{LIBRARIES[g2]}'s parameters "
                               f"{tuple(params)} do not match bn254_device's")
        _libs[g2] = lib
    return _libs[g2]


def _check(t: torch.Tensor, what: str, tail: tuple) -> None:
    """An int32 CUDA tensor, contiguous, (N,) + tail."""
    if not t.is_cuda:
        raise ValueError(f"bn254_cuda: {what} must be a CUDA tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"bn254_cuda: {what} must be int32, not {t.dtype}")
    if t.dim() != 1 + len(tail) or tuple(t.shape[1:]) != tail:
        raise ValueError(f"bn254_cuda: {what} must be (N,) + {tail}, not "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"bn254_cuda: {what} must be contiguous")


def _u8(x: int):
    """A host array of the 8 limbs of x (a kernel argument by value)."""
    return (ctypes.c_uint32 * 8)(*[(x >> (32 * i)) & 0xFFFFFFFF
                                   for i in range(8)])


def _mont(x: int) -> int:
    return x * (1 << 256) % R


def _call(fn: str, device, *args, g2: bool = False) -> None:
    """Launch through the group's library (the Fr functions: G1's)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(_library(g2), fn)(*args, stream)
    if err:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")


def _point_tail(g2: bool) -> tuple:
    return (2, 2, 8) if g2 else (2, 8)


# csrc/bn254.cu: the reduce and window kernels' largest block, the scan's
# tile; the reduction aims at about this many threads over the card (512
# on each of 132 SMs)
REDUCE_MAX = 64
SCAN_TILE = 4096
REDUCE_THREADS = 1 << 16
# the fixed-base table build's entries a thread and the fixed-base block,
# by group (G2 or not)
FB_RUN = 32
FB_THREADS = {False: 256, True: 128}


def msm_plan(n: int, g2: bool) -> dict:
    """The MSM's shape for n points, fixed by n alone (no sync reads the
    data): the window c (`bd.msm_window`), its windows and buckets; the
    chunk length L (every chunk of the bucket-ordered entries equally
    long, short enough that nwin * n / L chunks fill the card, 4 to 64)
    and the chunks' count; the tree passes that join a bucket's chunks (a
    bucket of every point spans n / L + 1 chunks, 8 joined a pass); the
    reduction's runs of `ls` buckets a thread, `tr` threads a block and
    `bw` blocks a window (each at most REDUCE_MAX); the scan's tiles."""
    c = bd.msm_window(n, g2)
    nwin = bd.msm_windows(c)
    nb = 1 << (c - 1)
    nb_all = nwin * nb
    L = 4
    while L < 64 and 2 * L * (1 << 17) <= nwin * n:
        L *= 2
    passes = 1
    while 8 ** passes < -(-n // L) + 1:
        passes += 1
    ls = 1
    while nb_all // ls > REDUCE_THREADS and ls < nb:
        ls *= 2
    while nb // (ls * min(REDUCE_MAX, nb // ls)) > REDUCE_MAX:
        ls *= 2
    tr = min(REDUCE_MAX, nb // ls)
    return {"c": c, "nwin": nwin, "nb": nb, "nb_all": nb_all, "L": L,
            "nchunks": -(-nwin * n // L), "passes": passes, "ls": ls,
            "tr": tr, "bw": nb // (ls * tr),
            "tiles": -(-nb_all // SCAN_TILE)}


def _msm_check(points: torch.Tensor, scalars: torch.Tensor, g2: bool) -> int:
    _check(points, "points", _point_tail(g2))
    _check(scalars, "scalars", (8,))
    n = points.shape[0]
    if scalars.shape[0] != n or scalars.device != points.device:
        raise ValueError("bn254_cuda: points and scalars must be on one card "
                         f"with one length, not {n} and {scalars.shape[0]}")
    if points.data_ptr() % 16 or scalars.data_ptr() % 16:
        raise ValueError("bn254_cuda: points and scalars must be 16-byte "
                         "aligned")
    if n >= 1 << 31 or bd.msm_windows(bd.msm_window(n, g2)) * n >= 1 << 32:
        raise ValueError(f"bn254_cuda: {n} points are more than the MSM's "
                         "32-bit entry indices hold")
    return n


def _msm_sort(points: torch.Tensor, scalars: torch.Tensor, g2: bool,
              plan: dict) -> dict:
    """Launch the MSM's first half: the buffers it fills."""
    dev = points.device
    n = points.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    buf = {"pts_mont": torch.empty_like(points),
           "inf": torch.empty(n, dtype=torch.uint8, device=dev),
           "counts": torch.empty(plan["nb_all"], **i32),
           "tile_sums": torch.empty(plan["tiles"], **i32),
           "offsets": torch.empty(plan["nb_all"] + 1, **i32),
           "cursor": torch.empty(plan["nb_all"], **i32),
           "sorted": torch.empty(plan["nwin"] * n, **i32)}
    _call("bn254_msm_sort", dev, points.data_ptr(), scalars.data_ptr(), n,
          plan["c"], plan["nwin"],
          *(buf[k].data_ptr() for k in ("pts_mont", "inf", "counts",
                                        "tile_sums", "offsets", "cursor",
                                        "sorted")), g2=g2)
    return buf


def msm(points: torch.Tensor, scalars: torch.Tensor, g2: bool) -> torch.Tensor:
    """sum s_i * P_i over (N, 2, [2,] 8) affine points and (N, 8) scalars
    below r: the signed-digit bucket sort (`bn254_msm_sort`), then the
    chunk sums, the tree passes, the reduction and the Horner pass
    (`bn254_msm_sum`), every launch on the current stream with no sync
    between them, every buffer shaped by `msm_plan(N, g2)`. Returns the
    (2, [2,] 8) affine sum, zeros for infinity."""
    n = _msm_check(points, scalars, g2)
    dev = points.device
    if n == 0:
        return torch.zeros(points.shape[1:], dtype=torch.int32, device=dev)
    out = torch.empty(points.shape[1:], dtype=torch.int32, device=dev)
    plan = msm_plan(n, g2)
    buf = _msm_sort(points, scalars, g2, plan)
    del buf["counts"], buf["cursor"], buf["tile_sums"], buf["inf"]
    xyzz = 4 * points[0, 0].numel()
    i32 = dict(dtype=torch.int32, device=dev)
    bucket_sum = torch.empty((plan["nb_all"], xyzz), **i32)
    head = torch.empty((plan["nchunks"], xyzz), **i32)
    tail = torch.empty((plan["nchunks"], xyzz), **i32)
    tail_key = torch.empty(plan["nchunks"], **i32)
    more = torch.empty(plan["passes"] + 1, **i32)
    # three XYZZ points a reduce block, one Jacobian point a window
    partials = torch.empty((plan["nwin"] * plan["bw"] * 3, xyzz), **i32)
    windows = torch.empty((plan["nwin"], xyzz // 4 * 3), **i32)
    _call("bn254_msm_sum", dev, buf["pts_mont"].data_ptr(),
          buf["sorted"].data_ptr(), buf["offsets"].data_ptr(), plan["c"],
          plan["nwin"], plan["L"], plan["nchunks"], plan["passes"],
          plan["ls"], plan["tr"], plan["bw"], bucket_sum.data_ptr(),
          head.data_ptr(), tail.data_ptr(), tail_key.data_ptr(),
          more.data_ptr(), partials.data_ptr(), windows.data_ptr(),
          out.data_ptr(), g2=g2)
    launches["g2_msm" if g2 else "g1_msm"] += 1
    return out


def msm_buckets(points: torch.Tensor, scalars: torch.Tensor, g2: bool):
    """The MSM's first half alone, for checking its digits: (plan, sorted,
    offsets), where the entries sorted[offsets[k]:offsets[k + 1]] are the
    points of bucket k = w * 2^(c-1) + |d| - 1 (window w, digit d), each
    entry a point's index with the digit's sign in bit 31. Not counted in
    `launches`: it sums nothing, and only checks call it."""
    n = _msm_check(points, scalars, g2)
    if n == 0:
        raise ValueError("bn254_cuda: msm_buckets needs a point")
    plan = msm_plan(n, g2)
    buf = _msm_sort(points, scalars, g2, plan)
    return plan, buf["sorted"], buf["offsets"]


def fixed_base_plan(n: int, g2: bool) -> dict:
    """The fixed-base kernel's shape for n scalars: the window c
    (`bd.fixed_base_window`, the least Fp products of the additions and
    the table's build, a table read past the L2 cache at its bytes'
    time), its windows, entries a row and the table's bytes."""
    c = bd.fixed_base_window(n, g2)
    return {"c": c, "nwin": bd.msm_windows(c), "entries": 1 << (c - 1),
            "table_bytes": bd.fixed_base_table_bytes(c, g2)}


def fixed_base_table(g2: bool, c: int, device) -> torch.Tensor:
    """The generator's c-bit table on the card, (nwin, 2^(c-1), 2[, 2], 8)
    int32 affine d 2^(c j) G in Montgomery form, built there from the host's
    nwin bases 2^(c j) G (`bn254_fixed_base_table`) on first use and cached
    by (group, c, device) until `clear_fixed_base_tables`."""
    key = (g2, c, str(device))
    if key not in _tables:
        bases = torch.from_numpy(bd.fixed_base_bases_mont(g2, c)).to(device)
        nwin, nb = bd.msm_windows(c), 1 << (c - 1)
        tail = _point_tail(g2)
        xyzz = torch.empty((nwin * nb, 2) + tail, dtype=torch.int32,
                           device=device)
        table = torch.empty((nwin, nb) + tail, dtype=torch.int32,
                            device=device)
        _call("bn254_fixed_base_table", device, bases.data_ptr(), c, nwin,
              xyzz.data_ptr(), table.data_ptr(), g2=g2)
        _tables[key] = table
    return _tables[key]


def clear_fixed_base_tables() -> None:
    """Drop the cached tables, so that the next call builds its own (a cold
    timing)."""
    _tables.clear()


def fixed_base(scalars: torch.Tensor, g2: bool) -> torch.Tensor:
    """k_i * G1 (or G2) for (N, 8) scalars below 2^256 (s * G = (s mod r)
    * G): (N, 2, [2,] 8) affine points, ordinary form, zeros where
    k_i = 0 mod r. The table of `fixed_base_plan(N, g2)`'s window (built
    on the first call that needs it), then one `fixed_base_kernel`
    launch."""
    _check(scalars, "scalars", (8,))
    n = scalars.shape[0]
    dev = scalars.device
    if scalars.data_ptr() % 16:
        raise ValueError("bn254_cuda: scalars must be 16-byte aligned")
    if n >= 1 << 31:
        raise ValueError(f"bn254_cuda: {n} scalars are more than the "
                         "fixed-base kernel's grid holds")
    out = torch.empty((n,) + _point_tail(g2), dtype=torch.int32, device=dev)
    if n:
        plan = fixed_base_plan(n, g2)
        table = fixed_base_table(g2, plan["c"], dev)
        _call("bn254_fixed_base", dev, table.data_ptr(), scalars.data_ptr(),
              n, plan["c"], plan["nwin"], out.data_ptr(), g2=g2)
        launches["g2_fixed_base" if g2 else "g1_fixed_base"] += 1
    return out


def _fr_powers(base: int, count: int, scale: int, device) -> torch.Tensor:
    """(count, 8) Montgomery scale * base^j, j < count, on the card (cached;
    `bn254_fr_powers`)."""
    key = (base, count, scale, str(device))
    if key not in _powers:
        t = torch.empty((count, 8), dtype=torch.int32, device=device)
        _call("bn254_fr_powers", device, t.data_ptr(), count,
              _u8(_mont(base)), _u8(_mont(scale)))
        _powers[key] = t
    return _powers[key]


def _pow_pair(base: int, logn: int, device, scale: int = 1) -> tuple:
    """The kernel's two tables of base^e for e < 2^logn: lo[e mod 2^h]
    = base^(e mod 2^h), hi[e >> h] = scale base^((e >> h) 2^h), h about
    logn / 2; (lo, hi, h) as its arguments."""
    h = (logn + 1) // 2
    lo = _fr_powers(base, 1 << h, 1, device)
    hi = _fr_powers(pow(base, 1 << h, R), 1 << (logn - h), scale, device)
    return lo.data_ptr(), hi.data_ptr(), h


def _ntt_args(logn: int, inverse: bool, shift, post, device) -> tuple:
    """bn254_fr_ntt's arguments after the buffers for one form of the
    transform (the plan, the twiddles, the twist's, shift's and post's
    tables, the scale), and the plan; cached, so that a call's host work
    is a lookup."""
    key = (logn, inverse, shift, post, str(device))
    if key not in _ntt:
        n = 1 << logn
        plan = bd.ntt_plan(logn)
        fields = [p[k] for p in plan for k in bd.NTT_PLAN_FIELDS]
        w_t, w_n = host.fr_w(bd.NTT_TILE_LOG), host.fr_w(logn)
        if inverse:
            w_t, w_n = pow(w_t, R - 2, R), pow(w_n, R - 2, R)
        twiddles = _fr_powers(w_t, 1 << (bd.NTT_TILE_LOG - 1), 1, device)
        none = (None, None, 0)
        scale = pow(n, R - 2, R) if inverse else 1
        tw = _pow_pair(w_n, logn, device) if len(plan) > 1 else none
        ip = _pow_pair(shift % R, logn, device) if shift is not None else none
        op = (_pow_pair(post % R, logn, device, scale) if post is not None
              else none)
        _ntt[key] = ((twiddles.data_ptr(),
                      (ctypes.c_longlong * len(fields))(*fields), len(plan),
                      *tw, *ip, *op, _u8(_mont(scale)),
                      int(inverse and post is None)), plan)
    return _ntt[key]


def fr_ntt(x: torch.Tensor, inverse: bool = False, shift: int | None = None,
           post: int | None = None) -> torch.Tensor:
    """bn254.fr_fft of (n, 8) Fr elements, n a power of two: x_i * shift^i
    before the transform, y_i * post^i after it (and 1/n when `inverse`).
    One counted launch chain: the passes of `bd.ntt_plan(log n)` (two at
    2^12 to 2^22), their power tables cached on the card."""
    _check(x, "x", (8,))
    n = x.shape[0]
    logn = n.bit_length() - 1
    if n == 0 or 1 << logn != n:
        raise ValueError(f"bn254_cuda: fr_ntt needs a power of two, not {n}")
    if logn > host.FR_TWO_ADICITY:
        raise ValueError(f"bn254_cuda: Fr has no root of unity of order {n}")
    if x.data_ptr() % 16:
        raise ValueError("bn254_cuda: x must be 16-byte aligned")
    dev = x.device
    args = _ntt_args(logn, inverse, shift, post, dev)
    plan = args[1]
    work = torch.empty_like(x) if len(plan) > 1 else x
    out = torch.empty_like(x)
    _call("bn254_fr_ntt", dev, x.data_ptr(), out.data_ptr(),
          work.data_ptr(), *args[0])
    launches["fr_ntt"] += 1
    return out


def fr_pointwise(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 z: int) -> torch.Tensor:
    """(a_i * b_i - c_i) * z over (n, 8) Fr elements."""
    for t, what in ((a, "a"), (b, "b"), (c, "c")):
        _check(t, what, (8,))
        if t.shape != a.shape or t.device != a.device:
            raise ValueError("bn254_cuda: fr_pointwise's operands must be "
                             "on one card with one length")
    out = torch.empty_like(a)
    if a.shape[0]:
        _call("bn254_fr_pointwise", a.device, a.data_ptr(), b.data_ptr(),
              c.data_ptr(), _u8(z % R * pow(2, 512, R) % R), out.data_ptr(),
              a.shape[0])
        launches["fr_pointwise"] += 1
    return out
