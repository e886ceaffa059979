"""The port's Poseidon modes against the JAX package's `poseidon_pallas`
modes: the same six names, the same host tables from the same constant set,
the same padding multiples, and the wrappers' refusals. The kernels
themselves run only on the card (tests/test_torch_cuda.py holds each against
the plain permutation there)."""

import inspect
import re

import numpy as np
import pytest
import torch

from zkevm_prover_tpu.ops import poseidon_gl as jpgl
from zkevm_prover_tpu.ops import poseidon_pallas as jpp
from zkevm_prover_tpu_torch.ops import goldilocks as gl
from zkevm_prover_tpu_torch.ops import poseidon_constants as pc
from zkevm_prover_tpu_torch.ops import poseidon_cuda
from zkevm_prover_tpu_torch.ops import poseidon_gl as pg


@pytest.fixture(autouse=True)
def restore_mode():
    mode = poseidon_cuda.MODE
    yield
    poseidon_cuda.MODE = mode


def _jax_coeffs():
    return np.asarray(jpgl._mds_coeffs(pc.source()))


def _jax_operand(mode):
    """The MXU matrix the JAX package hands its `mode` kernel."""
    run = jpp._permute_call(pc.source(), True, mode)
    return np.asarray(inspect.getclosurevars(run).nonlocals["a_np"])


def test_mode_names_match_pallas():
    line = next(ln for ln in inspect.getsource(jpp).splitlines()
                if ln.startswith("MODE ="))
    names = re.findall(r'"([^"]+)"', line.split("#", 1)[1])
    assert sorted(names) == sorted(poseidon_cuda.MODES)
    assert poseidon_cuda.MODE == jpp.MODE == "mxu96"


def test_dense_mds_matches_jax():
    coeffs = pg.mds_coeffs(pc.source())
    np.testing.assert_array_equal(coeffs, _jax_coeffs())
    tab = poseidon_cuda._host_tables(pc.source())
    np.testing.assert_array_equal(tab["mds"], _jax_coeffs())
    C, _ = jpgl._tables_host(pc.source())
    np.testing.assert_array_equal(pg.tables_host(pc.source())[0],
                                  np.asarray(C))


def test_circ_diag_matches_jax():
    coeffs = pg.mds_coeffs(pc.source())
    assert poseidon_cuda.circ_diag(coeffs) == jpp._circ_diag(_jax_coeffs())
    tab = poseidon_cuda._host_tables(pc.source())
    circ, diag = jpp._circ_diag(_jax_coeffs())
    assert tab["circ"].tolist() == circ and tab["diag"].tolist() == diag
    # a matrix of no such shape has none in both packages
    bad = coeffs.copy()
    bad[3, 5] += 1
    assert poseidon_cuda.circ_diag(bad) is None
    assert jpp._circ_diag(bad) is None


def test_mxu_operand_matches_jax():
    b, _ = poseidon_cuda.mma_operands(pg.mds_coeffs(pc.source()))
    jax_a = _jax_operand("mxu")      # I_8 (x) M padded to 128
    w = pg.WIDTH
    # B = M^T on the kernel's k-slots (rows) and output columns
    k = [i for i, lane in enumerate(poseidon_cuda.MXU_K_LANE) if lane is not None]
    n = [i for i, lane in enumerate(poseidon_cuda.MXU_N_LANE) if lane is not None]
    ins = [poseidon_cuda.MXU_K_LANE[i] for i in k]
    outs = [poseidon_cuda.MXU_N_LANE[i] for i in n]
    assert sorted(ins) == sorted(outs) == list(range(w))
    assert b.shape == (32, 16) and b.sum() == b[np.ix_(k, n)].sum()
    for t in range(jpp.N_LIMB8):
        block = jax_a[t * w:(t + 1) * w, t * w:(t + 1) * w]
        np.testing.assert_array_equal(b[np.ix_(k, n)],
                                      block[np.ix_(outs, ins)].T)


def test_mxu24_operand_matches_jax():
    _, b = poseidon_cuda.mma_operands(pg.mds_coeffs(pc.source()))
    jax_a = _jax_operand("mxu24")    # I_8 (x) blockdiag(M, M) padded to 256
    w = pg.WIDTH
    # B = blockdiag(M^T, M^T) on the kernel's k-slots (rows) and output
    # columns, each an (input or output lane, plane parity): index
    # 12 parity + lane of JAX's 24 x 24 block
    k = [i for i, kl in enumerate(poseidon_cuda.MXU24_K_LANE) if kl is not None]
    ins = [w * e + lane for lane, e in
           (poseidon_cuda.MXU24_K_LANE[i] for i in k)]
    outs = [w * e + lane for lane, e in poseidon_cuda.MXU24_N_LANE]
    assert sorted(ins) == sorted(outs) == list(range(2 * w))
    assert b.shape == (32, 24) and b.sum() == b[k].sum()
    for t in range(jpp.N_LIMB8):
        block = jax_a[t * 24:(t + 1) * 24, t * 24:(t + 1) * 24]
        np.testing.assert_array_equal(b[k], block[np.ix_(outs, ins)].T)


def test_padding_multiples_match_jax():
    # the JAX package pads mxu24's batch to two of its 1024-lane tiles
    # (its two halves stacked); every kernel of the port's one library, on
    # the lazy body, takes any H
    assert 2 * jpp.MXU_LANES == 2048
    for mode in poseidon_cuda.MODES:
        assert poseidon_cuda.PAD[mode] == 1
        assert poseidon_cuda.LIBRARY[mode] == "poseidon_gl"


@pytest.mark.parametrize("mode", poseidon_cuda.MODES)
def test_wrappers_refuse_cpu_tensors(mode):
    before = dict(poseidon_cuda.launches)
    x = torch.zeros((5, 12), dtype=torch.int64)
    poseidon_cuda.MODE = mode
    with pytest.raises(ValueError, match="CUDA tensor"):
        poseidon_cuda.permute(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        poseidon_cuda.ENTRY[mode](x)
    assert poseidon_cuda.launches == before


@pytest.mark.parametrize("mode", ["mxu96", "2d", "mxu", "mxu24", "blocked",
                                  "1d"])
def test_launch_refuses_cpu_tensors(mode):
    before = dict(poseidon_cuda.launches)
    x = torch.zeros((12, 12), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        poseidon_cuda.launch(mode, x, torch.empty_like(x))
    assert poseidon_cuda.launches == before


@pytest.mark.parametrize("mode", ["mxu128"])
def test_launch_takes_only_the_lazy_library(mode):
    x = torch.zeros((12, 12), dtype=torch.int64)
    with pytest.raises(ValueError, match="launch takes the modes"):
        poseidon_cuda.launch(mode, x, torch.empty_like(x))


def test_unknown_mode_raises():
    poseidon_cuda.MODE = "mxu128"
    with pytest.raises(ValueError, match="unknown Poseidon mode"):
        poseidon_cuda.permute(torch.zeros((5, 12), dtype=torch.int64))


@pytest.mark.parametrize("mode", poseidon_cuda.MODES + ("mxu128",))
def test_cpu_permute_ignores_mode(mode):
    states = np.random.default_rng(9).integers(0, gl.P, (7, 12),
                                               dtype=np.uint64)
    x = gl.from_u64(states, "cpu")
    want = pg.permute_plain(x)
    poseidon_cuda.MODE = mode
    assert torch.equal(pg.permute(x), want)
