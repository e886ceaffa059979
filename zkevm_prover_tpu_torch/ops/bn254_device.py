"""BN254 on the device: the SNARK wrap's MSM, fixed-base products and Fr NTT.

Port of `zkevm_prover_tpu/ops/bn254_device.py` (its XLA-fused Pippenger
`_msm_device` :390), widened to the two host loops of the Groth16 wrap that
the JAX package leaves on the host: the CRS's fixed-base products
(`snark/groth16.py:89-119`) and the quotient's Fr FFTs (`bn254.fr_fft`,
`_quotient_coeffs` :123).

Every function takes and returns int32 tensors of 32-bit limbs in ordinary
form (not Montgomery), little-endian: an Fp or Fr element (..., 8), a G1
point (x, y) (N, 2, 8), a G2 point ((x0, x1), (y0, y1)) (N, 2, 2, 8); the
point at infinity is all zeros ((0, 0) lies on neither curve). On a CUDA
tensor each launches its kernel of csrc/bn254.cu (`bn254_cuda`); on a CPU
tensor it runs its plain twin here, the same function in torch ops:

  * field elements as 18 limbs of 16 bits in int64, kept lazily reduced
    (every limb below 2^18, the value congruent mod p but not reduced):
    a product is one outer product, its columns split into 16-bit chunks
    and the columns above 2^288 folded back with the constants
    2^(16k) mod p; a difference adds a limb-wise multiple of p larger
    than any operand limb. `_canon` reduces exactly (two Montgomery
    reductions with R = 2^288) for the outputs;
  * the curves in homogeneous projective coordinates with the complete
    formulas of Renes, Costello and Batina (2016), algorithms 7 and 9
    (a = 0): no special case for the point at infinity (0 : 1 : 0), for
    P + P or for P + (-P). The kernels use Jacobian coordinates with
    branches; the affine results agree because the affine point is
    unique.

`pack_*` / `unpack_*` convert between Python ints (the host's points,
`bn254.INF` for infinity) and these tensors through `int.to_bytes` and
`numpy.frombuffer`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import bn254 as host
from .bn254 import INF, P, R

LIMBS = 18          # 16-bit limbs of a twin element (288 bits)
_M16 = 0xFFFF

# fixed-base window table: 64 windows of 4 bits (csrc/bn254.cu FB_BITS)
FB_BITS = 4
FB_WINDOWS = 256 // FB_BITS
FB_ENTRIES = (1 << FB_BITS) - 1


def msm_window(n: int) -> int:
    """Pippenger window bits for n points, as g1_msm_device :416."""
    return max(2, min(13, n.bit_length() - 1))


def msm_windows(c: int) -> int:
    return -(-254 // c)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def ints_to_limbs(xs) -> np.ndarray:
    """(len(xs), 8) int32 limbs of ints in [0, 2^256)."""
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u4").reshape(-1, 8).view(np.int32)


def limbs_to_ints(t) -> list[int]:
    """Ints of (..., 8) int32 limbs, flattened in order."""
    a = t.detach().cpu().contiguous().numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t)
    buf = np.ascontiguousarray(a, dtype=np.int32).astype("<i4").tobytes()
    return [int.from_bytes(buf[i:i + 32], "little")
            for i in range(0, len(buf), 32)]


def pack_fr(xs, device, reduced: bool = False) -> torch.Tensor:
    """Scalars as an (n, 8) tensor on `device`, reduced mod r (`reduced`:
    the caller's ints are below r already)."""
    if not reduced:
        xs = [int(x) % R for x in xs]
    return torch.from_numpy(ints_to_limbs(xs).copy()).to(device)


def pack_g1(points, device) -> torch.Tensor:
    flat = []
    for p in points:
        flat += (0, 0) if p is INF else (p[0], p[1])
    return torch.from_numpy(ints_to_limbs(flat).reshape(-1, 2, 8).copy()
                            ).to(device)


def pack_g2(points, device) -> torch.Tensor:
    flat = []
    for p in points:
        flat += (0, 0, 0, 0) if p is INF else (p[0][0], p[0][1], p[1][0],
                                               p[1][1])
    return torch.from_numpy(ints_to_limbs(flat).reshape(-1, 2, 2, 8).copy()
                            ).to(device)


def unpack_g1(t) -> list:
    v = limbs_to_ints(t)
    return [INF if v[i] == 0 and v[i + 1] == 0 else (v[i], v[i + 1])
            for i in range(0, len(v), 2)]


def unpack_g2(t) -> list:
    v = limbs_to_ints(t)
    return [INF if not any(v[i:i + 4]) else
            ((v[i], v[i + 1]), (v[i + 2], v[i + 3]))
            for i in range(0, len(v), 4)]


# ---------------------------------------------------------------------------
# the fixed-base window table of the generators (host ints)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def fixed_base_table(g2: bool) -> np.ndarray:
    """(FB_WINDOWS, FB_ENTRIES, 2[, 2], 8) int32: entry [j][d - 1] is the
    affine d * 2^(4 j) * G, ordinary form."""
    add, gen = (host.g2_add, host.G2_GEN) if g2 else (host.g1_add,
                                                       host.G1_GEN)
    pack = pack_g2 if g2 else pack_g1
    rows, base = [], gen
    for _ in range(FB_WINDOWS):
        cur = base
        for _d in range(FB_ENTRIES):
            rows.append(cur)
            cur = add(cur, base)
        base = cur   # 16 * base
    t = pack(rows, "cpu").numpy()
    return t.reshape((FB_WINDOWS, FB_ENTRIES) + t.shape[1:])


@functools.lru_cache(maxsize=None)
def fixed_base_table_mont(g2: bool) -> np.ndarray:
    """The same table in Montgomery form (x * 2^256 mod p), the kernel's."""
    t = fixed_base_table(g2)
    v = [x * (1 << 256) % P for x in limbs_to_ints(t)]
    return ints_to_limbs(v).reshape(t.shape).copy()


# ---------------------------------------------------------------------------
# plain twins: lazily reduced 16-bit-limb field arithmetic
# ---------------------------------------------------------------------------

def _limbs16(x: int, n: int = LIMBS) -> list[int]:
    return [(x >> (16 * i)) & _M16 for i in range(n)]


def _chunk_matrix(n_limbs: int, fold: dict) -> list:
    """Rows: the 4 16-bit chunks of each of n_limbs limbs, chunk j of limb k
    (row 4 k + j, the order of the limbs' int16 view) at position k + j;
    below LIMBS it is that limb, above it folds back as the limbs of
    2^(16 (k + j)) mod p."""
    rows = []
    for k in range(n_limbs):
        for j in range(4):
            pos = k + j
            if pos < LIMBS:
                rows.append([int(i == pos) for i in range(LIMBS)])
            else:
                rows.append(fold[pos])
    return rows


class _Field:
    """Constants of the twin arithmetic mod `mod` (per device, cached)."""

    def __init__(self, mod: int):
        self.mod = mod
        fold = {k: _limbs16(pow(2, 16 * k, mod), LIMBS)
                for k in range(LIMBS, 2 * LIMBS + 3)}
        self._chunk_cols = _chunk_matrix(2 * LIMBS - 1, fold)
        self._chunk_limbs = _chunk_matrix(LIMBS, fold)
        # a limb-wise multiple of p with every limb in [2^26, 2^26 + 2^16)
        c = sum((1 << 26) << (16 * i) for i in range(LIMBS))
        self._sub = [v + (1 << 26) for v in _limbs16((-c) % mod)]
        self.n16 = (-pow(mod, -1, 1 << 16)) % (1 << 16)
        self._p = _limbs16(mod, 16)
        self._k = _limbs16(pow(2, 2 * 16 * LIMBS, mod), 16)  # 2^576 mod p
        self._cache: dict = {}

    def c(self, device) -> dict:
        key = str(device)
        if key not in self._cache:
            i = torch.arange(LIMBS)
            f64, i64 = torch.float64, torch.int64
            self._cache[key] = {
                "chunk_cols": torch.tensor(self._chunk_cols, dtype=f64,
                                           device=device),
                "chunk_limbs": torch.tensor(self._chunk_limbs, dtype=f64,
                                            device=device),
                "sub": torch.tensor(self._sub, dtype=i64, device=device),
                "p": torch.tensor(self._p, dtype=i64, device=device),
                "k": torch.tensor(self._k, dtype=i64, device=device),
                "col": (i[:, None] + i[None, :]).reshape(-1).to(device),
            }
        return self._cache[key]


FP = _Field(P)
FR = _Field(R)

# Bounds (every limb >= 0): a product's inputs below 2^26 (its columns stay
# below 2^62); a difference's `b` below 2^26, its `a` below 2^36; products
# and differences come out below 2^20; sums and small multiples are not
# carried (the curve formulas keep them inside those bounds). The float64
# products below are exact: each output is a sum of at most 140 terms
# below 2^32.


def _chunks(t: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Cut every limb of t (>= 0, below 2^63) into its 4 16-bit chunks (its
    uint16 view) and place or fold each by `mat`."""
    return (t.contiguous().view(torch.uint16).double() @ mat).long()


def _ln(f: _Field, t: torch.Tensor) -> torch.Tensor:
    """Two carry passes, each a _chunks of the limbs: after the first,
    limbs 16 and 17 are below 2^18 (no fold lands there) and the others
    below 2^35; after the second, all are below 2^20."""
    mat = f.c(t.device)["chunk_limbs"]
    return _chunks(_chunks(t, mat), mat)


def f_add(f, a, b):
    return a + b


def f_sub(f, a, b):
    return _ln(f, a + f.c(a.device)["sub"] - b)


def f_small(f, a, k: int):
    """a * k for a small constant k (not carried)."""
    return a * k


# elements a product handles at once (its 18 x 18 limb products take
# 2.6 KB each)
_MUL_BATCH = 1 << 18


def f_mul(f, a, b):
    """a * b (broadcastable): the 18 x 18 limb products summed into 35
    columns, each column cut into its 16-bit chunks that one float64
    product places or folds back mod p (below 2^40), then carried."""
    if max(a.numel(), b.numel()) > _MUL_BATCH * LIMBS:
        shape = torch.broadcast_shapes(a.shape, b.shape)
        a = a.expand(shape).reshape(-1, LIMBS)
        b = b.expand(shape).reshape(-1, LIMBS)
        return torch.cat([f_mul(f, a[i:i + _MUL_BATCH], b[i:i + _MUL_BATCH])
                          for i in range(0, a.shape[0], _MUL_BATCH)]
                         ).reshape(shape)
    c = f.c(a.device)
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)
    shape = prod.shape[:-2]
    cols = prod.new_zeros(shape + (2 * LIMBS - 1,)).index_add_(
        -1, c["col"], prod.reshape(shape + (-1,)))
    return _ln(f, _chunks(cols, c["chunk_cols"]))


def f_from_u32(x: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 limbs -> (..., 18) int64 16-bit limbs."""
    w = x.to(torch.int64) & 0xFFFFFFFF
    out = torch.stack([w & _M16, w >> 16], dim=-1).reshape(
        x.shape[:-1] + (16,))
    return torch.nn.functional.pad(out, (0, LIMBS - 16))


def _normalize(t: torch.Tensor) -> torch.Tensor:
    """Exact carries: every limb but the last below 2^16 (t >= 0)."""
    t = t.clone()
    for i in range(t.shape[-1] - 1):
        t[..., i + 1] += t[..., i] >> 16
        t[..., i] &= _M16
    return t


def _redc(f, t: torch.Tensor) -> torch.Tensor:
    """t * 2^-288 mod p, below 2p for t < p * 2^288, exact limbs (19)."""
    c = f.c(t.device)
    t = torch.nn.functional.pad(t, (0, 2 * LIMBS + 1 - t.shape[-1]))
    for i in range(LIMBS):
        m = ((t[..., i] & _M16) * f.n16) & _M16
        t[..., i:i + 16] += m[..., None] * c["p"]
        t[..., i + 1] += t[..., i] >> 16
    return _normalize(t[..., LIMBS:])


def _canon(f, t: torch.Tensor) -> torch.Tensor:
    """The exact residue in [0, p), 16 limbs of 16 bits."""
    c = f.c(t.device)
    w = _redc(f, _normalize(t))                  # t * 2^-288, below 2p
    prod = (w[..., :, None] * c["k"]).reshape(w.shape[:-1] + (-1,))
    idx = (torch.arange(w.shape[-1])[:, None]
           + torch.arange(16)[None, :]).reshape(-1).to(t.device)
    cols = torch.zeros(w.shape[:-1] + (w.shape[-1] + 15,), dtype=torch.int64,
                       device=t.device).index_add_(-1, idx, prod)
    v = _redc(f, cols)[..., :LIMBS]              # t mod p, below 2p
    d = v.clone()
    d[..., :16] -= c["p"]
    borrow = torch.zeros(d.shape[:-1], dtype=torch.int64, device=t.device)
    for i in range(LIMBS):
        d[..., i] -= borrow
        borrow = (d[..., i] < 0).to(torch.int64)
        d[..., i] += borrow << 16
    return torch.where((borrow == 0)[..., None], d, v)[..., :16]


def f_to_u32(f, t: torch.Tensor) -> torch.Tensor:
    """Lazy (..., 18) -> exact (..., 8) int32 limbs in ordinary form."""
    v = _canon(f, t)
    w = v[..., 0::2] | (v[..., 1::2] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def f_is_zero(f, t: torch.Tensor) -> torch.Tensor:
    return (_canon(f, t) == 0).all(-1)


def f_pow(f, a, e: int):
    acc = torch.zeros_like(a)
    acc[..., 0] = 1
    for bit in bin(e)[2:]:
        acc = f_mul(f, acc, acc)
        if bit == "1":
            acc = f_mul(f, acc, a)
    return acc


def f_const(f, x: int, device) -> torch.Tensor:
    return torch.tensor(_limbs16(x % f.mod), dtype=torch.int64,
                        device=device)


# Fp2 = Fp[u]/(u^2 + 1) over (..., 2, 18)

def _stack_pairs(pairs):
    """The left and the right operands of the pairs, each stacked (a
    constant operand broadcast to the others' shape)."""
    shape = max((x.shape for pair in pairs for x in pair), key=len)
    a = torch.stack([x if x.shape == shape else x.expand(shape)
                     for x, _ in pairs])
    b = torch.stack([y if y.shape == shape else y.expand(shape)
                     for _, y in pairs])
    return a, b


def _mul_many(f, pairs):
    """The products of (a, b) pairs, all in one stacked product."""
    a, b = _stack_pairs(pairs)
    return list(f_mul(f, a, b).unbind(0))


class _Fp:
    """The curve formulas' field: Fp on (..., 18) limbs."""

    @staticmethod
    def mul_many(pairs):
        return _mul_many(FP, pairs)

    @staticmethod
    def add(a, b):
        return f_add(FP, a, b)

    @staticmethod
    def sub(a, b):
        return f_sub(FP, a, b)

    @staticmethod
    def small(a, k):
        return f_small(FP, a, k)

    @staticmethod
    def mul_b3(a):
        return f_small(FP, a, 3 * host.B)

    @staticmethod
    def zero(shape, device):
        return torch.zeros(shape + (LIMBS,), dtype=torch.int64, device=device)

    @classmethod
    def one(cls, shape, device):
        z = cls.zero(shape, device)
        z.view(shape + (-1,))[..., 0] = 1    # limb 0 (of c0 in Fp2)
        return z

    @staticmethod
    def inv(a):
        return f_pow(FP, a, P - 2)

    @staticmethod
    def is_zero(a):
        return f_is_zero(FP, a)

    @staticmethod
    def to_u32(a):
        return f_to_u32(FP, a)

    @staticmethod
    def from_u32(x):
        return f_from_u32(x)


def _fp2_mul_many(pairs):
    """Karatsuba products of Fp2 pairs, all in one stacked Fp product."""
    a, b = _stack_pairs(pairs)
    a0, a1 = a[..., 0, :], a[..., 1, :]
    b0, b1 = b[..., 0, :], b[..., 1, :]
    m = f_mul(FP, torch.stack([a0, a1, f_add(FP, a0, a1)]),
              torch.stack([b0, b1, f_add(FP, b0, b1)]))
    re = f_sub(FP, m[0], m[1])
    im = f_sub(FP, f_sub(FP, m[2], m[0]), m[1])
    return list(torch.stack([re, im], dim=-2).unbind(0))


class _Fp2(_Fp):
    """Fp2 = Fp[u]/(u^2 + 1) on (..., 2, 18) limbs: Fp's sums, differences
    and conversions limb-wise, its own products, constants and inverse."""
    B3 = host.f2_muls(host.B2, 3)

    mul_many = staticmethod(_fp2_mul_many)

    @staticmethod
    def mul_b3(a):
        b3 = torch.stack([f_const(FP, _Fp2.B3[0], a.device),
                          f_const(FP, _Fp2.B3[1], a.device)])
        return _fp2_mul_many([(a, b3)])[0]

    @staticmethod
    def zero(shape, device):
        return torch.zeros(shape + (2, LIMBS), dtype=torch.int64,
                           device=device)

    @staticmethod
    def inv(a):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        n = f_add(FP, f_mul(FP, a0, a0), f_mul(FP, a1, a1))
        ni = f_pow(FP, n, P - 2)
        return torch.stack([f_mul(FP, a0, ni),
                            f_sub(FP, torch.zeros_like(a1),
                                  f_mul(FP, a1, ni))], dim=-2)

    @staticmethod
    def is_zero(a):
        return f_is_zero(FP, a).all(-1)


def _plain(fn):
    """Run a twin without autograd's bookkeeping (its cost is per torch
    op, and a twin is thousands of small ops) and hand back an ordinary
    tensor."""
    @functools.wraps(fn)
    def run(*args, **kw):
        with torch.inference_mode():
            out = fn(*args, **kw)
        return out.clone()
    return run


# ---------------------------------------------------------------------------
# plain twins: the curves (homogeneous projective, complete formulas)
# ---------------------------------------------------------------------------

def pt_add(F, p, q):
    """RCB algorithm 7 (a = 0): p + q for any p, q."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0, t1, t2, t3, t4, x3 = F.mul_many([
        (X1, X2), (Y1, Y2), (Z1, Z2),
        (F.add(X1, Y1), F.add(X2, Y2)), (F.add(Y1, Z1), F.add(Y2, Z2)),
        (F.add(X1, Z1), F.add(X2, Z2))])
    t3 = F.sub(t3, F.add(t0, t1))
    t4 = F.sub(t4, F.add(t1, t2))
    y3 = F.sub(x3, F.add(t0, t2))
    t0 = F.small(t0, 3)
    t2 = F.mul_b3(t2)
    z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    y3 = F.mul_b3(y3)
    a, b, c, d, e, g = F.mul_many([(t4, y3), (t3, t1), (y3, t0), (t1, z3),
                                   (t0, t3), (z3, t4)])
    return (F.sub(b, a), F.add(d, c), F.add(g, e))


def pt_double(F, p):
    """RCB algorithm 9 (a = 0): 2p for any p."""
    X, Y, Z = p
    t0, t1, t2, t3 = F.mul_many([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
    z3 = F.small(t0, 8)
    t2 = F.mul_b3(t2)
    y3 = F.add(t0, t2)
    t0 = F.sub(t0, F.small(t2, 3))
    x3, z3, y3, x3b = F.mul_many([(t2, z3), (t1, z3), (t0, y3), (t0, t3)])
    return (F.small(x3b, 2), F.add(x3, y3), z3)


def _pt_inf(F, shape, device):
    return (F.zero(shape, device), F.one(shape, device), F.zero(shape, device))


def _pt_select(mask, p, q):
    """p where mask else q (mask over the leading dims)."""
    out = []
    for a, b in zip(p, q):
        m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
        out.append(torch.where(m, a, b))
    return tuple(out)


def _pt_index(p, idx):
    return tuple(a[idx] for a in p)


def _pt_affine_u32(F, p) -> torch.Tensor:
    """(..., 2, 8 | 2, 8) int32 affine ordinary form; infinity -> zeros."""
    X, Y, Z = p
    inf = F.is_zero(Z)
    zi = F.inv(Z)
    x, y = F.mul_many([(X, zi), (Y, zi)])
    out = torch.stack([F.to_u32(x), F.to_u32(y)], dim=len(inf.shape))
    m = inf.reshape(inf.shape + (1,) * (out.dim() - inf.dim()))
    return torch.where(m, torch.zeros_like(out), out)


def _affine_in(F, pts: torch.Tensor):
    """(N, 2, ...) int32 affine -> projective (X, Y, 1), infinity (0:1:0)."""
    x = F.from_u32(pts[:, 0])
    y = F.from_u32(pts[:, 1])
    inf = (pts.reshape(pts.shape[0], -1) == 0).all(-1)
    one = F.one((pts.shape[0],), pts.device)
    zero = F.zero((pts.shape[0],), pts.device)
    return _pt_select(inf, (zero, one, zero), (x, y, one))


def _scalar_digits(scalars: torch.Tensor, bits: int, n_windows: int
                   ) -> torch.Tensor:
    """(N, n_windows) int64 digits of `bits` bits of (N, 8) int32 scalars."""
    s = torch.nn.functional.pad(scalars.to(torch.int64) & 0xFFFFFFFF, (0, 1))
    w = torch.arange(n_windows, device=scalars.device) * bits
    word, sh = w >> 5, w & 31
    lo = s[:, word] >> sh
    hi = (s[:, (word + 1).clamp(max=8)] << (32 - sh)) & 0xFFFFFFFF
    hi = torch.where(sh == 0, torch.zeros_like(hi), hi)
    return (lo | hi) & ((1 << bits) - 1)


def _segment_sums(F, pts, seg: torch.Tensor):
    """Sum the points of each run of equal `seg` (sorted), pairing
    neighbours within a run until one point per run is left."""
    while True:
        m = seg.shape[0]
        if m == 0:
            return pts, seg
        first = torch.ones(m, dtype=torch.bool, device=seg.device)
        first[1:] = seg[1:] != seg[:-1]
        if bool(first.all()):
            return pts, seg
        ar = torch.arange(m, device=seg.device)
        start = torch.cummax(torch.where(first, ar, torch.zeros_like(ar)),
                             0).values
        pos = ar - start
        keep = (pos % 2) == 0
        nxt = torch.zeros(m, dtype=torch.bool, device=seg.device)
        nxt[:-1] = ~first[1:]
        pair = keep & nxt
        ki = ar[keep]
        pi = ar[pair]
        new = [a[ki].clone() for a in pts]
        summed = pt_add(F, _pt_index(pts, pi), _pt_index(pts, pi + 1))
        slot = pair[keep]
        for a, s in zip(new, summed):
            a[slot] = s
        pts, seg = tuple(new), seg[ki]


@_plain
def msm_plain(points: torch.Tensor, scalars: torch.Tensor,
              g2: bool) -> torch.Tensor:
    """sum s_i * P_i, the plain twin of the MSM kernel pair: (N, 2, [2,] 8)
    affine points, (N, 8) scalars below 2^256 reduced mod r by the caller;
    the affine sum (2, [2,] 8). Pippenger as the kernels: digits, a sort by
    (window, digit), segment sums, a suffix scan and sum per window, the
    windows joined by doublings; the window is at most 5 bits, since each
    step here is one tensor-wide addition whose size grows with 2^c."""
    F = _Fp2 if g2 else _Fp
    dev = points.device
    n = points.shape[0]
    if n == 0:
        return torch.zeros(points.shape[1:], dtype=torch.int32, device=dev)
    c = min(msm_window(n), 5)
    nwin = msm_windows(c)
    nb = 1 << c
    digits = _scalar_digits(scalars, c, nwin)                  # (N, nwin)
    inf = (points.reshape(n, -1) == 0).all(-1)
    keys = (torch.arange(nwin, device=dev) << c)[None, :] | digits
    valid = (digits != 0) & ~inf[:, None]
    keys, order = torch.sort(keys[valid], stable=True)
    idx = torch.arange(n, device=dev)[:, None].expand(n, nwin)[valid][order]
    proj = _affine_in(F, points)
    sums, seg = _segment_sums(F, _pt_index(proj, idx), keys)
    buckets = _pt_inf(F, (nwin * nb,), dev)
    buckets = tuple(b.index_copy(0, seg, s) for b, s in zip(buckets, sums))
    buckets = tuple(b.reshape((nwin, nb) + b.shape[1:]) for b in buckets)
    # suffix sums S_b = sum_{b' >= b} B_b' (Hillis-Steele), then sum_{b>=1}
    d = 1
    while d < nb:
        ident = _pt_inf(F, (nwin, d), dev)
        shifted = tuple(torch.cat([b[:, d:], i], dim=1)
                        for b, i in zip(buckets, ident))
        buckets = pt_add(F, buckets, shifted)
        d *= 2
    ident = _pt_inf(F, (nwin, 1), dev)
    buckets = tuple(torch.cat([i, b[:, 1:]], dim=1)
                    for b, i in zip(buckets, ident))
    while buckets[0].shape[1] > 1:
        even = (slice(None), slice(0, None, 2))
        odd = (slice(None), slice(1, None, 2))
        buckets = pt_add(F, _pt_index(buckets, even), _pt_index(buckets, odd))
    wins = tuple(b[:, 0] for b in buckets)                      # (nwin,)
    acc = _pt_index(wins, slice(nwin - 1, nwin))
    for w in range(nwin - 2, -1, -1):
        for _ in range(c):
            acc = pt_double(F, acc)
        acc = pt_add(F, acc, _pt_index(wins, slice(w, w + 1)))
    return _pt_affine_u32(F, acc)[0]


@_plain
def fixed_base_plain(scalars: torch.Tensor, g2: bool) -> torch.Tensor:
    """k_i * G (the plain twin of fixed_base_kernel): (N, 8) scalars below
    r -> (N, 2, [2,] 8) affine points, from the same window table."""
    F = _Fp2 if g2 else _Fp
    dev = scalars.device
    n = scalars.shape[0]
    table = torch.from_numpy(fixed_base_table(g2)).to(dev)
    tx = F.from_u32(table[:, :, 0])
    ty = F.from_u32(table[:, :, 1])
    digits = _scalar_digits(scalars, FB_BITS, FB_WINDOWS)
    acc = _pt_inf(F, (n,), dev)
    one = F.one((n,), dev)
    for j in range(FB_WINDOWS):
        d = digits[:, j]
        e = (d - 1).clamp(min=0)
        q = _pt_select(d == 0, _pt_inf(F, (n,), dev),
                       (tx[j, e], ty[j, e], one))
        acc = pt_add(F, acc, q)
    return _pt_affine_u32(F, acc)


# ---------------------------------------------------------------------------
# plain twins: the Fr NTT and the quotient's pointwise step
# ---------------------------------------------------------------------------

def _fr_powers(base: int, n: int, device) -> torch.Tensor:
    """(n, 18) lazy base^i, i < n, by the bits of i."""
    e = torch.arange(n, device=device)
    acc = torch.zeros((n, LIMBS), dtype=torch.int64, device=device)
    acc[:, 0] = 1
    b = f_const(FR, base, device)
    for k in range(max(1, (n - 1).bit_length())):
        bit = ((e >> k) & 1).bool()[:, None]
        acc = torch.where(bit, f_mul(FR, acc, b), acc)
        b = f_mul(FR, b, b)
    return acc


def _bitrev(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    i = torch.arange(n, device=device)
    r = torch.zeros_like(i)
    for k in range(bits):
        r |= ((i >> k) & 1) << (bits - 1 - k)
    return r


@_plain
def fr_ntt_plain(x: torch.Tensor, inverse: bool = False,
                 shift: int | None = None,
                 post: int | None = None) -> torch.Tensor:
    """bn254.fr_fft of (n, 8) Fr elements (n a power of two): each x_i
    times shift^i first, each output times post^i last (and 1/n when
    `inverse`)."""
    n = x.shape[0]
    logn = n.bit_length() - 1
    if 1 << logn != n:
        raise ValueError(f"fr_ntt needs a power of two, not {n}")
    dev = x.device
    a = f_from_u32(x)
    if shift is not None:
        a = f_mul(FR, a, _fr_powers(shift, n, dev))
    a = a[_bitrev(n, dev)]
    w = host.fr_w(logn)
    if inverse:
        w = pow(w, R - 2, R)
    tw = _fr_powers(w, max(1, n // 2), dev)
    for s in range(1, logn + 1):
        h = 1 << (s - 1)
        a = a.reshape(n // (2 * h), 2, h, LIMBS)
        t = f_mul(FR, a[:, 1], tw[torch.arange(h, device=dev) << (logn - s)])
        a = torch.stack([_ln(FR, a[:, 0] + t), f_sub(FR, a[:, 0], t)], 1)
    a = a.reshape(n, LIMBS)
    if inverse:
        a = f_mul(FR, a, f_const(FR, pow(n, R - 2, R), dev))
    if post is not None:
        a = f_mul(FR, a, _fr_powers(post, n, dev))
    return f_to_u32(FR, a)


@_plain
def fr_pointwise_plain(a, b, c, z: int) -> torch.Tensor:
    """(a * b - c) * z elementwise over (n, 8) Fr elements."""
    t = f_sub(FR, f_mul(FR, f_from_u32(a), f_from_u32(b)), f_from_u32(c))
    return f_to_u32(FR, f_mul(FR, t, f_const(FR, z, a.device)))


# ---------------------------------------------------------------------------
# dispatch: the kernel on a CUDA tensor, the twin on a CPU tensor
# ---------------------------------------------------------------------------

def g1_msm(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    if points.is_cuda:
        from . import bn254_cuda
        return bn254_cuda.msm(points, scalars, g2=False)
    return msm_plain(points, scalars, g2=False)


def g2_msm(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    if points.is_cuda:
        from . import bn254_cuda
        return bn254_cuda.msm(points, scalars, g2=True)
    return msm_plain(points, scalars, g2=True)


def fixed_base(scalars: torch.Tensor, g2: bool) -> torch.Tensor:
    """k_i * G1 (or G2) for (N, 8) scalars below r."""
    if scalars.is_cuda:
        from . import bn254_cuda
        return bn254_cuda.fixed_base(scalars, g2)
    return fixed_base_plain(scalars, g2)


def fr_ntt(x: torch.Tensor, inverse: bool = False, shift: int | None = None,
           post: int | None = None) -> torch.Tensor:
    if x.is_cuda:
        from . import bn254_cuda
        return bn254_cuda.fr_ntt(x, inverse, shift, post)
    return fr_ntt_plain(x, inverse, shift, post)


def fr_pointwise(a, b, c, z: int) -> torch.Tensor:
    if a.is_cuda:
        from . import bn254_cuda
        return bn254_cuda.fr_pointwise(a, b, c, z)
    return fr_pointwise_plain(a, b, c, z)


def fr_fft(xs: list[int], inverse: bool = False, device=None) -> list[int]:
    """bn254.fr_fft on `device` (the tensor path): ints in, ints out."""
    from .. import resolve_device

    t = pack_fr(xs, resolve_device(device))
    return limbs_to_ints(fr_ntt(t, inverse))
