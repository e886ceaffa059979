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
    "bn254_msm_prep": [_P, _P, _LL, _I, _I, _P, _P, _P],
    "bn254_msm_bucket": [_P, _P, _P, _P, _LL, _LL, _P, _P, _LL, _P, _P],
    "bn254_msm_reduce": [_P, _I, _I, _P, _P, _P],
    "bn254_fixed_base": [_P, _P, _LL, _P, _P],
}
_FR_FUNCTIONS = {
    "bn254_fr_twiddles": [_P, _LL, _P, _P],
    "bn254_fr_ntt": [_P, _P, _P, _P, _LL, _I, _P, _I, _P, _P, _I, _P],
    "bn254_fr_pointwise": [_P, _P, _P, _P, _P, _LL, _P],
}

_libs: dict = {}
_tables: dict = {}     # (g2, device) -> the fixed-base table on the card
_twiddles: dict = {}   # (n, inverse, device) -> n/2 Montgomery powers


def _library(g2: bool):
    if g2 not in _libs:
        lib = cuda_build.load(LIBRARIES[g2])
        functions = dict(_FUNCTIONS, **({} if g2 else _FR_FUNCTIONS))
        for fn, args in functions.items():
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = ctypes.c_int
        params = (ctypes.c_int * 5)()
        lib.bn254_params(params)
        if (params[0], params[1], params[4]) != (bd.FB_BITS, bd.FB_WINDOWS,
                                                 2 if g2 else 1):
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


def _chunks(offsets: torch.Tensor):
    """Cut each bucket's segment [offsets[b], offsets[b + 1]) of the sorted
    keys into chunks of at most L points, L = max(256, longest / 1024):
    the chunks' starts and ends, and each bucket's first chunk (nb + 1)."""
    lens = offsets[1:] - offsets[:-1]
    most = int(lens.max()) if lens.numel() else 0
    size = max(256, -(-most // 1024))
    per = (lens + size - 1) // size
    chunk_off = torch.zeros(lens.numel() + 1, dtype=torch.int64,
                            device=offsets.device)
    torch.cumsum(per, 0, out=chunk_off[1:])
    total = int(chunk_off[-1])
    bucket = torch.repeat_interleave(
        torch.arange(lens.numel(), device=offsets.device), per,
        output_size=total)
    starts = offsets[bucket] + (torch.arange(total, device=offsets.device)
                                - chunk_off[bucket]) * size
    ends = torch.minimum(starts + size, offsets[bucket + 1])
    return starts, ends, chunk_off


def msm(points: torch.Tensor, scalars: torch.Tensor, g2: bool) -> torch.Tensor:
    """sum s_i * P_i over (N, 2, [2,] 8) affine points and (N, 8) scalars
    (below r): the prep, bucket, reduce and combine kernels, the keys
    ordered by torch.sort and the segments cut into chunks between them
    (plumbing). Returns the (2, [2,] 8) affine sum, zeros for infinity."""
    _check(points, "points", _point_tail(g2))
    _check(scalars, "scalars", (8,))
    n = points.shape[0]
    if scalars.shape[0] != n or scalars.device != points.device:
        raise ValueError("bn254_cuda: points and scalars must be on one card "
                         f"with one length, not {n} and {scalars.shape[0]}")
    dev = points.device
    out = torch.zeros(points.shape[1:], dtype=torch.int32, device=dev)
    if n == 0:
        return out
    c = bd.msm_window(n)
    nwin = bd.msm_windows(c)
    nbuckets = nwin << c
    keys = torch.empty(nwin * n, dtype=torch.int64, device=dev)
    pts_mont = torch.empty_like(points)
    _call("bn254_msm_prep", dev, points.data_ptr(), scalars.data_ptr(), n, c,
          nwin, keys.data_ptr(), pts_mont.data_ptr(), g2=g2)
    keys, order = torch.sort(keys)
    offsets = torch.searchsorted(
        keys, torch.arange(nbuckets + 1, dtype=torch.int64, device=dev))
    del keys
    starts, ends, chunk_off = _chunks(offsets)
    words = points[0, 0].numel()
    partials = torch.empty((starts.numel(), 3 * words), dtype=torch.int32,
                           device=dev)
    buckets = torch.empty((nbuckets, 3 * words), dtype=torch.int32,
                          device=dev)
    _call("bn254_msm_bucket", dev, pts_mont.data_ptr(), order.data_ptr(),
          starts.data_ptr(), ends.data_ptr(), starts.numel(), n,
          partials.data_ptr(), chunk_off.data_ptr(), nbuckets,
          buckets.data_ptr(), g2=g2)
    del partials
    windows = torch.empty((nwin, 3 * words), dtype=torch.int32, device=dev)
    _call("bn254_msm_reduce", dev, buckets.data_ptr(), c, nwin,
          windows.data_ptr(), out.data_ptr(), g2=g2)
    launches["g2_msm" if g2 else "g1_msm"] += 1
    return out


def _table(g2: bool, device) -> torch.Tensor:
    key = (g2, str(device))
    if key not in _tables:
        _tables[key] = torch.from_numpy(bd.fixed_base_table_mont(g2)).to(
            device)
    return _tables[key]


def fixed_base(scalars: torch.Tensor, g2: bool) -> torch.Tensor:
    """k_i * G1 (or G2) for (N, 8) scalars below r: (N, 2, [2,] 8) affine
    points, ordinary form, zeros for k_i = 0."""
    _check(scalars, "scalars", (8,))
    n = scalars.shape[0]
    dev = scalars.device
    out = torch.empty((n,) + _point_tail(g2), dtype=torch.int32, device=dev)
    if n:
        _call("bn254_fixed_base", dev, _table(g2, dev).data_ptr(),
              scalars.data_ptr(), n, out.data_ptr(), g2=g2)
        launches["g2_fixed_base" if g2 else "g1_fixed_base"] += 1
    return out


def _twiddle_table(n: int, inverse: bool, device) -> torch.Tensor:
    key = (n, inverse, str(device))
    if key not in _twiddles:
        w = bd.host.fr_w(n.bit_length() - 1)
        if inverse:
            w = pow(w, R - 2, R)
        half = max(1, n // 2)
        tw = torch.empty((half, 8), dtype=torch.int32, device=device)
        _call("bn254_fr_twiddles", device, tw.data_ptr(), half,
              _u8(_mont(w)))
        _twiddles[key] = tw
    return _twiddles[key]


def fr_ntt(x: torch.Tensor, inverse: bool = False, shift: int | None = None,
           post: int | None = None) -> torch.Tensor:
    """bn254.fr_fft of (n, 8) Fr elements, n a power of two: x_i * shift^i
    before the transform, y_i * post^i after it (and 1/n when `inverse`).
    One counted launch chain: prologue, shared-memory stages, one launch
    per later stage, epilogue."""
    _check(x, "x", (8,))
    n = x.shape[0]
    logn = n.bit_length() - 1
    if n == 0 or 1 << logn != n:
        raise ValueError(f"bn254_cuda: fr_ntt needs a power of two, not {n}")
    dev = x.device
    tw = _twiddle_table(n, inverse, dev)
    work = torch.empty_like(x)
    out = torch.empty_like(x)
    scale = pow(n, R - 2, R) if inverse else 1
    _call("bn254_fr_ntt", dev, x.data_ptr(), out.data_ptr(), work.data_ptr(),
          tw.data_ptr(), n, logn, _u8(_mont(shift or 0)),
          int(shift is not None),
          _u8(_mont(scale)), _u8(_mont(post or 0)), int(post is not None))
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
