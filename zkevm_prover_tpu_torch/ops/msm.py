"""MSM dispatch: the BN254 Pippenger of `bn254_device` on `device`.

Port of `zkevm_prover_tpu/ops/msm.py`. There, a size cutover
(`DEVICE_THRESHOLD`) and the `ZK_DEVICE_MSM` variable chose between the
host Pippenger and the device program, to hide XLA's compile time. The
port has no compile to hide: on a CUDA device every MSM with a term
launches the kernels of csrc/bn254.cu, on the CPU it runs their plain torch
twin. Reference: src/ffiasm/multiexp.c.hpp.

`points` is a list of affine tuples (`bn254.INF` for infinity) or a
`PointList` (a CRS query kept on the device); `scalars` a list of ints or
an (n, 8) limb tensor. The result is an affine tuple, or `bn254.INF`.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from .. import resolve_device
from . import bn254_device as bd
from .bn254 import INF


class PointList(Sequence):
    """Affine points kept as an (N, 2, [2,] 8) int32 limb tensor (ordinary
    form, zeros for infinity), read as a list of the host's point tuples:
    `len`, indexing and iteration unpack them, and it compares equal to a
    list of tuples that holds the same points."""

    def __init__(self, tensor: torch.Tensor, g2: bool):
        self.tensor = tensor
        self.g2 = g2

    def _unpack(self, t):
        return (bd.unpack_g2 if self.g2 else bd.unpack_g1)(t)

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PointList(self.tensor[i], self.g2)
        return self._unpack(self.tensor[i].unsqueeze(0))[0]

    def __iter__(self):
        return iter(self.tolist())

    def tolist(self) -> list:
        return self._unpack(self.tensor)

    def __eq__(self, other) -> bool:
        if isinstance(other, PointList):
            return self.g2 == other.g2 and torch.equal(
                self.tensor.cpu(), other.tensor.cpu())
        if isinstance(other, (list, tuple)):
            return len(other) == len(self) and self.tolist() == list(other)
        return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return f"PointList({len(self)} {'G2' if self.g2 else 'G1'} points)"


def _operands(points, scalars, g2: bool, device):
    if isinstance(points, PointList):
        pts = points.tensor.to(device)
    else:
        pts = (bd.pack_g2 if g2 else bd.pack_g1)(list(points), device)
    if isinstance(scalars, torch.Tensor):
        sc = scalars.to(device)
    else:
        sc = bd.pack_fr(list(scalars), device)
    if pts.shape[0] != sc.shape[0]:
        raise ValueError(f"msm: {pts.shape[0]} points, {sc.shape[0]} "
                         "scalars")
    return pts, sc


def g1_msm(points, scalars, device=None):
    """sum s_i * P_i in G1 on `device` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    pts, sc = _operands(points, scalars, False, dev)
    if pts.shape[0] == 0:
        return INF
    return bd.unpack_g1(bd.g1_msm(pts, sc))[0]


def g2_msm(points, scalars, device=None):
    """sum s_i * Q_i in G2 on `device` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    pts, sc = _operands(points, scalars, True, dev)
    if pts.shape[0] == 0:
        return INF
    return bd.unpack_g2(bd.g2_msm(pts, sc))[0]
