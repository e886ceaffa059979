"""Wrappers of the CUDA Poseidon-GL kernels, one per mode of the TPU package.

`MODE` takes the six names of `poseidon_pallas.MODE` in the JAX package and
selects which kernel `permute` launches; `tools/bench_poseidon.py` switches
that module constant per run, and a caller of the port sets this one the
same way. Each mode has its own entry point, lays the (H, 12) int64 batch
out as its kernel takes it, pads it to its own tile, and adds one to
`launches[mode]` each time it launches its kernel:

  mode      kernel (csrc/)            layout it takes              pad to
  mxu96     poseidon_gl.cu            (H, 12) row-major            1
  blocked   poseidon_gl_blocked.cu    (H, 12) row-major            16384
  1d, 2d    poseidon_gl_soa.cu        (12, H) lane-major           512
  mxu       poseidon_gl_mma.cu        (12, H) lane-major           1024
  mxu24     poseidon_gl_mma.cu        (24, H/2): two halves stacked 2048

The padding multiples are the JAX package's (`poseidon_pallas.permute`),
except mxu96, whose kernel takes any H. Every entry point checks what its
kernel takes and raises on anything else, and `permute` raises on an
unknown mode: nothing falls back to another mode or to the plain version.
Each kernel's note says what TPU kernel it replaces and what bounds it; the
plain twin of all of them is `poseidon_gl.permute_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_build
from . import poseidon_constants as pc
from . import poseidon_gl as pg

MODES = ("1d", "2d", "blocked", "mxu", "mxu24", "mxu96")
MODE = "mxu96"

launches = {mode: 0 for mode in MODES}

PAD = {"1d": 512, "2d": 512, "blocked": 8 * 2048, "mxu": 1024,
       "mxu24": 2 * 1024, "mxu96": 1}

# kernel library of each mode (cuda_build.KERNELS names)
LIBRARY = {"1d": "poseidon_gl_soa", "2d": "poseidon_gl_soa",
           "blocked": "poseidon_gl_blocked", "mxu": "poseidon_gl_mma",
           "mxu24": "poseidon_gl_mma", "mxu96": "poseidon_gl"}

_P = ctypes.c_void_p
_ARGTYPES = {  # (permute, set_constants) argument types of each library
    "poseidon_gl": ([_P, _P, ctypes.c_longlong, _P], [_P] * 4),
    "poseidon_gl_blocked": ([_P, _P, ctypes.c_longlong, _P], [_P] * 4),
    "poseidon_gl_soa": ([_P, _P, ctypes.c_longlong, ctypes.c_int, _P],
                        [_P] * 4),
    "poseidon_gl_mma": ([_P, _P, ctypes.c_longlong, ctypes.c_int, _P],
                        [_P] * 6),
}

_libs: dict = {}
_constants_source: dict = {}


def circ_diag(coeffs: np.ndarray):
    """M as circulant + diagonal, (circ, diag) with M[i][j] =
    circ[(j-i)%12] + diag[i]·δ_ij, or None if M has no such shape (the
    decomposition of `poseidon_pallas._circ_diag`)."""
    w = pg.WIDTH
    circ = [int(coeffs[1, (k + 1) % w]) for k in range(w)]
    diag = [int(coeffs[i, i]) - circ[0] for i in range(w)]
    if diag[1] != 0:
        return None
    for i in range(w):
        if diag[i] < 0:
            return None
        for j in range(w):
            want = circ[(j - i) % w] + (diag[i] if i == j else 0)
            if int(coeffs[i, j]) != want:
                return None
    return circ, diag


def mma_operands(coeffs: np.ndarray):
    """The fixed u8 tensor-core operands of the mxu kernels: mxu's
    A = M padded to (16, 32) (row = output lane, column = input lane) and
    mxu24's B = blockdiag(M^T, M^T) padded to (32, 24) (row = k, column =
    n). None if an entry does not fit u8."""
    if int(coeffs.max()) > 255:
        return None
    w = pg.WIDTH
    a = np.zeros((16, 32), dtype=np.uint8)
    a[:w, :w] = coeffs
    b = np.zeros((32, 24), dtype=np.uint8)
    b[:w, :w] = coeffs.T
    b[w:2 * w, w:2 * w] = coeffs.T
    return a, b


@functools.lru_cache(maxsize=4)
def _host_tables(source: str):
    coeffs = pg.mds_coeffs(source)
    if coeffs is None:
        raise ValueError("the CUDA Poseidon kernels need a small-integer MDS "
                         f"(<= 2^16); constant set {source!r} has none")
    C, _ = pg.tables_host(source)
    cd = circ_diag(coeffs)
    circ, diag = cd if cd is not None else ([0] * pg.WIDTH, [0] * pg.WIDTH)
    return {"rc": np.ascontiguousarray(C.reshape(-1), dtype=np.uint64),
            "mds": np.ascontiguousarray(coeffs, dtype=np.uint32),
            "circ": np.array(circ, dtype=np.uint32),
            "diag": np.array(diag, dtype=np.uint32),
            "has_circ_diag": cd is not None,
            "mma": mma_operands(coeffs)}


def _library(mode: str):
    """The mode's kernel library with the active constant set loaded."""
    name = LIBRARY[mode]
    if name not in _libs:
        lib = cuda_build.load(name)
        permute_args, const_args = _ARGTYPES[name]
        for fn, args in (("permute", permute_args),
                         ("set_constants", const_args)):
            f = getattr(lib, f"{name}_{fn}")   # cached on lib, unlike lib[...]
            f.argtypes = args
            f.restype = ctypes.c_int
        _libs[name] = lib
    lib = _libs[name]
    source = pc.source()
    tab = _host_tables(source)
    if mode == "2d" and not tab["has_circ_diag"]:
        raise ValueError(f"mode 2d needs a circulant + diagonal MDS; constant "
                         f"set {source!r} has none")
    if mode in ("mxu", "mxu24") and tab["mma"] is None:
        raise ValueError(f"mode {mode} needs MDS entries below 256")
    if _constants_source.get(name) != source:
        ptrs = [tab[k].ctypes.data for k in ("rc", "mds", "circ", "diag")]
        if name == "poseidon_gl_mma":
            ptrs += [op.ctypes.data for op in tab["mma"]]
        err = getattr(lib, f"{name}_set_constants")(*ptrs)
        if err:
            raise RuntimeError(f"{name}_set_constants failed: cudaError {err}")
        _constants_source[name] = source
    return lib


def _check(states: torch.Tensor) -> None:
    if not states.is_cuda:
        raise ValueError("poseidon_cuda.permute takes a CUDA tensor")
    if states.dtype != torch.int64:
        raise TypeError(f"states must be int64, not {states.dtype}")
    if states.ndim != 2 or states.shape[1] != pg.WIDTH:
        raise ValueError(f"states must be (H, 12), not {tuple(states.shape)}")
    if not states.is_contiguous():
        raise ValueError("states must be contiguous")


def _padded(states: torch.Tensor, mode: str) -> torch.Tensor:
    """The batch zero-padded to the mode's multiple, in a fresh (so 16-byte
    aligned) tensor unless it is one already."""
    pad = (-states.shape[0]) % PAD[mode]
    if pad:
        return torch.cat([states, states.new_zeros((pad, pg.WIDTH))])
    return states if states.data_ptr() % 16 == 0 else states.clone()


def _launch(mode: str, states: torch.Tensor, fn) -> torch.Tensor:
    """Check, lay out (fn: (lib, stream, states) -> out, launching once),
    count."""
    _check(states)
    lib = _library(mode)
    if states.shape[0] == 0:
        return torch.empty_like(states)
    stream = torch.cuda.current_stream(states.device).cuda_stream
    with torch.cuda.device(states.device):
        out, err = fn(lib, stream, states)
    if err:
        raise RuntimeError(f"{LIBRARY[mode]}_permute ({mode}) launch failed: "
                           f"cudaError {err}")
    launches[mode] += 1
    return out


def permute_mxu96(states: torch.Tensor) -> torch.Tensor:
    """(H, 12) states through csrc/poseidon_gl.cu, row-major, any H."""
    def run(lib, stream, x):
        out = torch.empty_like(x)
        return out, lib.poseidon_gl_permute(x.data_ptr(), out.data_ptr(),
                                            x.shape[0], stream)
    return _launch("mxu96", states, run)


def permute_blocked(states: torch.Tensor) -> torch.Tensor:
    """(H, 12) states through csrc/poseidon_gl_blocked.cu: row-major, padded
    to the blocked multiple."""
    def run(lib, stream, x):
        h = x.shape[0]
        x = _padded(x, "blocked")
        out = torch.empty_like(x)
        err = lib.poseidon_gl_blocked_permute(x.data_ptr(), out.data_ptr(),
                                              x.shape[0], stream)
        return out[:h], err
    return _launch("blocked", states, run)


def _lane_major(mode: str, fn):
    """Run fn(lib, stream, xt) -> (out_t, err) on the padded (12, B)
    transpose and return the (H, 12) result."""
    def run(lib, stream, x):
        h = x.shape[0]
        xt = _padded(x, mode).T.contiguous()
        out_t, err = fn(lib, stream, xt)
        return out_t.T[:h].contiguous(), err
    return run


def _permute_soa(states: torch.Tensor, mode: str) -> torch.Tensor:
    def run(lib, stream, xt):
        out = torch.empty_like(xt)
        return out, lib.poseidon_gl_soa_permute(
            xt.data_ptr(), out.data_ptr(), xt.shape[1], int(mode == "2d"),
            stream)
    return _launch(mode, states, _lane_major(mode, run))


def permute_1d(states: torch.Tensor) -> torch.Tensor:
    """(H, 12) states through csrc/poseidon_gl_soa.cu with the dense MDS:
    (12, H) lane-major, padded to 512."""
    return _permute_soa(states, "1d")


def permute_2d(states: torch.Tensor) -> torch.Tensor:
    """(H, 12) states through csrc/poseidon_gl_soa.cu with the circulant +
    diagonal MDS: (12, H) lane-major, padded to 512."""
    return _permute_soa(states, "2d")


def permute_mxu(states: torch.Tensor) -> torch.Tensor:
    """(H, 12) states through csrc/poseidon_gl_mma.cu, MDS as M (x) byte
    planes: (12, H) lane-major, padded to 1024."""
    def run(lib, stream, xt):
        out = torch.empty_like(xt)
        return out, lib.poseidon_gl_mma_permute(
            xt.data_ptr(), out.data_ptr(), xt.shape[1], 0, stream)
    return _launch("mxu", states, _lane_major("mxu", run))


def permute_mxu24(states: torch.Tensor) -> torch.Tensor:
    """(H, 12) states through csrc/poseidon_gl_mma.cu, byte-plane pairs
    against blockdiag(M^T, M^T): the (12, H) transpose padded to 2048 with
    its two halves stacked as (24, H/2)."""
    def run(lib, stream, xt):
        half = xt.shape[1] // 2
        stacked = torch.cat([xt[:, :half], xt[:, half:]], dim=0)
        out = torch.empty_like(stacked)
        err = lib.poseidon_gl_mma_permute(
            stacked.data_ptr(), out.data_ptr(), xt.shape[1], 1, stream)
        return torch.cat([out[:pg.WIDTH], out[pg.WIDTH:]], dim=1), err
    return _launch("mxu24", states, _lane_major("mxu24", run))


ENTRY = {"1d": permute_1d, "2d": permute_2d, "blocked": permute_blocked,
         "mxu": permute_mxu, "mxu24": permute_mxu24, "mxu96": permute_mxu96}


def permute(states: torch.Tensor) -> torch.Tensor:
    """Poseidon-GL permutation of (H, 12) int64 CUDA states by the kernel of
    `MODE`."""
    if MODE not in ENTRY:
        raise ValueError(f"unknown Poseidon mode {MODE!r}; one of {MODES}")
    return ENTRY[MODE](states)
