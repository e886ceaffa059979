"""Wrappers of the CUDA Poseidon-GL kernels, one per mode of the TPU package.

`MODE` takes the six names of `poseidon_pallas.MODE` in the JAX package and
selects which kernel `permute` launches; `tools/bench_poseidon.py` switches
that module constant per run, and a caller of the port sets this one the
same way. Each mode has its own entry point, lays the (H, 12) int64 batch
out as its kernel takes it, and adds one to `launches[mode]` each time it
launches its kernel:

  mode      kernel (csrc/)            layout it takes
  mxu96     poseidon_gl.cu            (H, 12) row-major
  2d        poseidon_gl_2d.cuh        (H, 12) row-major
  mxu       poseidon_gl_mxu.cuh       (H, 12) row-major
  mxu24     poseidon_gl_mxu24.cuh     (H, 12) row-major
  blocked   poseidon_gl_blocked.cuh   (H, 12) row-major
  1d        poseidon_gl_1d.cuh        (12, H) lane-major

All six are one library (`poseidon_gl.cu` includes the other five sources)
on one lazy permutation body (`poseidon_lazy.cuh`): the reference MDS
compiled in, the tables derived here (`fold_constants`, `sparse_constants`,
`circ_diag`, `mma_operands`), loaded once for all of them, and a constant
set with another MDS refused. Every kernel takes any H (`PAD` is 1 for
each, where the JAX package pads to its tiles); `launch` runs one of them
on a batch already in its layout. Every entry point checks what its kernel
takes and raises on anything else, and `permute` raises on an unknown mode:
nothing falls back to another mode or to the plain version. Each
kernel's note says what TPU kernel it replaces and what bounds it; the
plain twin of all of them is `poseidon_gl.permute_plain`.

The poseidon_gl library also holds the fused Merkle commit, `merkle_levels`
(`ops/merkle.py` takes it under mode mxu96; its plain twin is
`merkle.merkelize_levels_plain`), counted in `launches["merkle"]`, apart
from the modes.
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
launches["merkle"] = 0

PAD = {mode: 1 for mode in MODES}

# kernel library of each mode (cuda_build.KERNELS names)
LIBRARY = {mode: "poseidon_gl" for mode in MODES}

# the poseidon_gl library's permutation entry points, each (in, out, n,
# stream) on its mode's own layout
_GL_PERMUTE = {"mxu96": "poseidon_gl_permute",
               "2d": "poseidon_gl_2d_permute",
               "mxu": "poseidon_gl_mxu_permute",
               "mxu24": "poseidon_gl_mxu24_permute",
               "blocked": "poseidon_gl_blocked_permute",
               "1d": "poseidon_gl_1d_permute"}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# poseidon_gl_merkle(src, row_stride, col_stride, width, tree, h, base,
#                    leaves, nodes, threads, more, chunk, stream)
_MERKLE_ARGTYPES = [_P, _LL, _LL, _LL, _P, _LL, _I, _I, _LL, _I, _I, _I, _P]
_FUNCTIONS = {  # argument types of each library's entry points
    "poseidon_gl": {**{fn: [_P, _P, _LL, _P] for fn in _GL_PERMUTE.values()},
                    "poseidon_gl_set_constants": [_P] * 10,
                    "poseidon_gl_merkle": _MERKLE_ARGTYPES},
}
# the host tables poseidon_gl_set_constants takes, in its order
GL_CONSTANTS = ("rc0", "fold", "mds", "circ", "diag", "sp_pre", "sp_w",
                "sp_v", "mxu_b", "mxu24_b")
MERKLE_THREADS = 128   # csrc/poseidon_gl.cu THREADS
_MDS_MISMATCH = -1     # csrc/poseidon_gl.cu POSEIDON_GL_MDS_MISMATCH

_libs: dict = {}
_constants_source: dict = {}


def fold_constants(C, M):
    """The mxu96 kernel's constant schedule, from the round constants C
    (30, 12) and the MDS M (12, 12), in exact field arithmetic: (rc0, fold)
    as uint64, rc0 (12,) added before round 0 and fold (30, 12) added after
    round r's MDS. fold[r] is C[r + 1], except that every partial round keeps
    only its lane-0 constant: the rest, u, is pushed through that round's
    MDS into the next round's constants (M (S(x + a e0) + u) = M S(x + a e0)
    + M u, since the S-box touches lane 0 alone), down to the first full
    round after the partial ones. fold[r, 1:] is zero for r in 4..24, and
    fold[29] is zero."""
    p, w = pc.P, pg.WIDTH
    C = [[int(v) for v in row] for row in C]
    M = [[int(v) for v in row] for row in M]
    half = pc.ROUNDS_F // 2
    for r in range(half, half + pc.ROUNDS_P):
        u = [0] + C[r][1:]
        C[r] = [C[r][0]] + [0] * (w - 1)
        C[r + 1] = [(C[r + 1][i] + sum(M[i][j] * u[j] for j in range(w))) % p
                    for i in range(w)]
    fold = C[1:] + [[0] * w]
    return (np.array(C[0], dtype=np.uint64),
            np.array(fold, dtype=np.uint64))


def _mat_inv(a: list, p: int) -> list:
    """Inverse of the square matrix a (Python ints) mod p, Gauss-Jordan."""
    n = len(a)
    m = [[int(v) % p for v in row] + [int(i == j) for j in range(n)]
         for i, row in enumerate(a)]
    for c in range(n):
        piv = next(r for r in range(c, n) if m[r][c])
        m[c], m[piv] = m[piv], m[c]
        inv = pow(m[c][c], p - 2, p)
        m[c] = [v * inv % p for v in m[c]]
        for r in range(n):
            if r != c and m[r][c]:
                f = m[r][c]
                m[r] = [(x - f * y) % p for x, y in zip(m[r], m[c])]
    return [row[n:] for row in m]


def _mat_mul(a: list, b: list, p: int) -> list:
    return [[sum(x * y for x, y in zip(row, col)) % p for col in zip(*b)]
            for row in a]


def sparse_constants(M):
    """The sparse factorisation of the 22 partial rounds' MDS (the Poseidon
    paper's appendix B), from the last partial round back: each round's
    matrix B = [[b00, b0], [bc, B^]] is B'' B' with B' = [[1, 0], [0, B^]]
    acting on lanes 1..11 only, so B' commutes with the lane-0 S-box and
    with the lane-0 constants (fold_constants leaves no other in these
    rounds) and moves into the round before: B_{r-1} = B'_r M. What is
    left of each round is B'' = [[m00, w], [v, I]]. Returns (pre, w, v):
    pre (11, 11) the first partial round's B^, which lands on the last full
    round (applied to lanes 1..11 after its MDS); w, v (22, 11) per partial
    round, in order, as uint64. B'' keeps m00 = M[0][0] in every round."""
    p, n = pc.P, pg.WIDTH
    M = [[int(x) % p for x in row] for row in M]
    ws, vs = [], []
    B = M
    for _ in range(pc.ROUNDS_P):
        hat = [row[1:] for row in B[1:]]
        hat_inv = _mat_inv(hat, p)
        # B'' = B B'^-1: row 0 = [b00, b0 hat^-1], rows 1.. = [bc, I]
        w = [sum(B[0][1 + k] * hat_inv[k][j] for k in range(n - 1)) % p
             for j in range(n - 1)]
        v = [B[1 + j][0] for j in range(n - 1)]
        assert B[0][0] == M[0][0]
        ws.append(w)
        vs.append(v)
        prime = [[int(i == j) if i == 0 or j == 0 else hat[i - 1][j - 1]
                  for j in range(n)] for i in range(n)]
        B = _mat_mul(prime, M, p)
    pre = hat   # B^ of the first partial round, left for the full round
    # ws / vs were made from the last round back
    return (np.array(pre, dtype=np.uint64),
            np.array(ws[::-1], dtype=np.uint64),
            np.array(vs[::-1], dtype=np.uint64))


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


# mode mxu's k-slots and n columns (csrc/poseidon_gl_mxu.cuh): lane (g, t)
# of a warp holds input lanes 3t..3t+2 at k-slots 4t..4t+2 of its A
# fragment, and the C fragment gives it columns 2t, 2t+1 of n8 tile 0 and
# 2t of tile 1, which are made its output lanes 3t, 3t+1 and 3t+2.
MXU_K_LANE = [3 * (k // 4) + k % 4 if k < 16 and k % 4 < 3 else None
              for k in range(32)]
MXU_N_LANE = ([3 * (n // 2) + n % 2 for n in range(8)]
              + [3 * (n // 2) + 2 if n % 2 == 0 else None for n in range(8)])
# mode mxu24's (csrc/poseidon_gl_mxu24.cuh), as (lane, plane parity): the
# A fragment of a plane pair holds the even plane of input lanes 3t..3t+2
# at k-slots 4t..4t+2 and the odd plane at 16+4t..16+4t+2; in n8 tile c,
# columns 2u and 2u+1 are output lane 3u + c of the even and the odd plane,
# so the C fragment gives lane (g, t) both planes of output lane 3t + c.
MXU24_K_LANE = [(3 * (k % 16 // 4) + k % 4, k // 16) if k % 4 < 3 else None
                for k in range(32)]
MXU24_N_LANE = [(3 * (n % 8 // 2) + n // 8, n % 2) for n in range(24)]


def mma_operands(coeffs: np.ndarray):
    """The fixed u8 tensor-core operands, each M^T with its k-slots and
    columns permuted: mode mxu's (32, 16) (B[k, n] = M[MXU_N_LANE[n],
    MXU_K_LANE[k]], zero where either is None) and mode mxu24's (32, 24)
    blockdiag(M^T, M^T) (B[k, n] = M[o, i] for MXU24_K_LANE[k] = (i, e) and
    MXU24_N_LANE[n] = (o, e), zero across plane parities and where the
    k-slot is None). None if an entry does not fit u8."""
    if int(coeffs.max()) > 255:
        return None
    mxu = np.zeros((32, 16), dtype=np.uint8)
    for k, i in enumerate(MXU_K_LANE):
        for n, o in enumerate(MXU_N_LANE):
            if i is not None and o is not None:
                mxu[k, n] = coeffs[o, i]
    mxu24 = np.zeros((32, 24), dtype=np.uint8)
    for k, ki in enumerate(MXU24_K_LANE):
        for n, (o, e) in enumerate(MXU24_N_LANE):
            if ki is not None and ki[1] == e:
                mxu24[k, n] = coeffs[o, ki[0]]
    return mxu, mxu24


@functools.lru_cache(maxsize=4)
def _host_tables(source: str):
    coeffs = pg.mds_coeffs(source)
    if coeffs is None:
        raise ValueError("the CUDA Poseidon kernels need a small-integer MDS "
                         f"(<= 2^16); constant set {source!r} has none")
    C, M = pg.tables_host(source)
    cd = circ_diag(coeffs)
    circ, diag = cd if cd is not None else ([0] * pg.WIDTH, [0] * pg.WIDTH)
    rc0, fold = fold_constants(C, M)
    pre, w, v = sparse_constants(M)
    mma = mma_operands(coeffs)
    # a set whose MDS does not fit u8 passes zeros, refused with its MDS
    mxu, mxu24 = mma if mma is not None else (np.zeros((32, 16), np.uint8),
                                              np.zeros((32, 24), np.uint8))
    return {"rc0": rc0, "fold": np.ascontiguousarray(fold.reshape(-1)),
            "sp_pre": np.ascontiguousarray(pre.reshape(-1)),
            "sp_w": np.ascontiguousarray(w.reshape(-1)),
            "sp_v": np.ascontiguousarray(v.reshape(-1)),
            "mds": np.ascontiguousarray(coeffs, dtype=np.uint32),
            "circ": np.array(circ, dtype=np.uint32),
            "diag": np.array(diag, dtype=np.uint32),
            "mxu_b": mxu, "mxu24_b": mxu24}


def _library(mode: str):
    """The mode's kernel library with the active constant set loaded."""
    name = LIBRARY[mode]
    if name not in _libs:
        lib = cuda_build.load(name)
        for fn, args in _FUNCTIONS[name].items():
            f = getattr(lib, fn)   # cached on lib, unlike lib[...]
            f.argtypes = args
            f.restype = ctypes.c_int
        _libs[name] = lib
    lib = _libs[name]
    source = pc.source()
    tab = _host_tables(source)
    if _constants_source.get(name) != source:
        # a set with no circulant + diagonal form passes zeros, refused
        err = getattr(lib, f"{name}_set_constants")(
            *[tab[k].ctypes.data for k in GL_CONSTANTS])
        if err == _MDS_MISMATCH:
            raise ValueError(f"constant set {source!r} does not have the MDS "
                             "compiled into csrc/poseidon_gl.cu (every mode's "
                             "kernel and the fused Merkle commit)")
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


def launch(mode: str, x: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of the poseidon_gl library's `mode` kernel from x into
    out, both already in that kernel's layout: (H, 12) row-major, or (12, H)
    lane-major for 1d; int64, contiguous and 16-byte aligned on one card. Counted in launches[mode]. The mode's
    entry point lays the batch out and calls this."""
    if mode not in _GL_PERMUTE:
        raise ValueError(f"launch takes the modes {tuple(_GL_PERMUTE)}, "
                         f"not {mode!r}")
    for t in (x, out):
        if not t.is_cuda:
            raise ValueError("poseidon_cuda.launch takes CUDA tensors")
        if t.dtype != torch.int64:
            raise TypeError(f"states must be int64, not {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("states must be contiguous and 16-byte aligned")
    lanes = 0 if mode == "1d" else 1    # the axis of the 12 lanes
    if (x.ndim != 2 or x.shape[lanes] != pg.WIDTH or out.shape != x.shape
            or out.device != x.device):
        layout = "(12, H)" if lanes == 0 else "(H, 12)"
        raise ValueError(f"mode {mode} takes a {layout} batch and an output "
                         f"like it, not {tuple(x.shape)} -> "
                         f"{tuple(out.shape)}")
    lib = _library(mode)
    n = x.shape[1 - lanes]
    if n == 0:
        return
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = getattr(lib, _GL_PERMUTE[mode])(x.data_ptr(), out.data_ptr(),
                                              n, stream)
    if err:
        raise RuntimeError(f"{_GL_PERMUTE[mode]} ({mode}) launch failed: "
                           f"cudaError {err}")
    launches[mode] += 1


def _permute_gl(mode: str, states: torch.Tensor) -> torch.Tensor:
    _check(states)
    x = states if states.data_ptr() % 16 == 0 else states.clone()
    if mode == "1d":
        x = x.T.contiguous()
    out = torch.empty_like(x)
    launch(mode, x, out)
    return out.T.contiguous() if mode == "1d" else out


def permute_mxu96(states: torch.Tensor) -> torch.Tensor:
    """(H, 12) states through csrc/poseidon_gl.cu, row-major, any H."""
    return _permute_gl("mxu96", states)


def permute_blocked(states: torch.Tensor) -> torch.Tensor:
    """(H, 12) states through csrc/poseidon_gl_blocked.cuh: row-major tiles
    staged by bulk copies, any H."""
    return _permute_gl("blocked", states)


def permute_1d(states: torch.Tensor) -> torch.Tensor:
    """(H, 12) states through csrc/poseidon_gl_1d.cuh: transposed to (12, H)
    lane-major and back, any H."""
    return _permute_gl("1d", states)


def permute_2d(states: torch.Tensor) -> torch.Tensor:
    """(H, 12) states through csrc/poseidon_gl_2d.cuh: row-major, the full
    rounds' MDS in its circulant + diagonal form, any H."""
    return _permute_gl("2d", states)


def permute_mxu(states: torch.Tensor) -> torch.Tensor:
    """(H, 12) states through csrc/poseidon_gl_mxu.cuh: row-major, the full
    rounds' MDS as byte-plane products on the tensor cores, any H."""
    return _permute_gl("mxu", states)


def permute_mxu24(states: torch.Tensor) -> torch.Tensor:
    """(H, 12) states through csrc/poseidon_gl_mxu24.cuh: row-major, the
    full rounds' MDS as byte-plane pairs on the tensor cores, any H."""
    return _permute_gl("mxu24", states)


ENTRY = {"1d": permute_1d, "2d": permute_2d, "blocked": permute_blocked,
         "mxu": permute_mxu, "mxu24": permute_mxu24, "mxu96": permute_mxu96}


def permute(states: torch.Tensor) -> torch.Tensor:
    """Poseidon-GL permutation of (H, 12) int64 CUDA states by the kernel of
    `MODE`."""
    if MODE not in ENTRY:
        raise ValueError(f"unknown Poseidon mode {MODE!r}; one of {MODES}")
    return ENTRY[MODE](states)


def merkle_plan(h: int, w: int) -> list:
    """The fused commit's launches for a (h, w) source, as (base, leaves,
    nodes, threads, more, chunk): `nodes` threads in blocks of `threads`,
    each making one digest (of 8-column chunk `chunk` of a source row when
    `leaves`, else of a parent of level `base`), then `more` levels within
    each block. The rows first, one launch per chunk (measured faster on
    the H100 than several chunks, or the whole row, per launch: PERF.md);
    then one launch per level while it has more than MERKLE_THREADS
    parents; then one block for the remaining levels."""
    n_chunks = -(-w // 8) if w > 4 else 1
    threads = min(MERKLE_THREADS, h)
    plan = [(0, True, h, threads, 0, c) for c in range(n_chunks)]
    base, nodes = 0, h
    while nodes > 1:
        parents = nodes // 2
        if parents > MERKLE_THREADS:
            plan.append((base, False, parents, MERKLE_THREADS, 0, 0))
            base, nodes = base + 1, parents
        else:
            plan.append((base, False, parents, parents,
                         parents.bit_length() - 1, 0))
            nodes = 1
    return plan


def level_offset(h: int, k: int) -> int:
    """Row of tree level k in the (2h - 1, 4) buffer (csrc/poseidon_gl.cu
    level_offset): after the h + h/2 + ... nodes of the levels below."""
    return 2 * h - 2 * (h >> k)


def tree_levels(tree: torch.Tensor, h: int) -> list:
    """[leaves (h, 4), ..., root (1, 4)]: views into the (2h - 1, 4) buffer."""
    return [tree[level_offset(h, k):level_offset(h, k) + (h >> k)]
            for k in range(h.bit_length())]


def merkle_levels(source: torch.Tensor) -> list:
    """Every level of the Merkle tree of a (H, W) int64 CUDA source (H a
    power of two, any strides) through the fused commit of
    csrc/poseidon_gl.cu: [leaves (H, 4), ..., root (1, 4)], views into one
    (2H - 1, 4) buffer, equal to `merkle.merkelize_levels_plain`. Launches
    as `merkle_plan` says, each counted in launches["merkle"]."""
    if not source.is_cuda:
        raise ValueError("poseidon_cuda.merkle_levels takes a CUDA tensor")
    if source.dtype != torch.int64:
        raise TypeError(f"source must be int64, not {source.dtype}")
    if source.ndim != 2:
        raise ValueError(f"source must be (H, W), not {tuple(source.shape)}")
    h, w = source.shape
    if h < 1 or h & (h - 1):
        raise ValueError(f"height must be a power of two, not {h}")
    lib = _library("mxu96")
    tree = torch.empty((2 * h - 1, pg.HASH_SIZE), dtype=torch.int64,
                       device=source.device)
    row_stride, col_stride = source.stride()
    stream = torch.cuda.current_stream(source.device).cuda_stream
    with torch.cuda.device(source.device):
        for base, leaves, nodes, threads, more, chunk in merkle_plan(h, w):
            err = lib.poseidon_gl_merkle(
                source.data_ptr(), row_stride, col_stride, w, tree.data_ptr(),
                h, base, int(leaves), nodes, threads, more, chunk, stream)
            if err:
                raise RuntimeError(f"poseidon_gl_merkle launch failed: "
                                   f"cudaError {err}")
            launches["merkle"] += 1
    return tree_levels(tree, h)
