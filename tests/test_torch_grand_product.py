"""The grand product's plain twin (`stark.prover.calculate_z`, which
`prover.grand_products` runs for CPU tensors in place of csrc/stark.cu's
grand-product kernel) against the JAX package's
`zkevm_prover_tpu.stark.prover.calculate_z`, bit for bit: base and GL3
operands at n = 1, 2 and 2^10, and an argument with a zero den, where the
batch inversion's total inverse is inv(0) = 0 and z = (1, 0, 0, ...).
The kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3e)."""

import numpy as np
import pytest

from zkevm_prover_tpu.stark import prover as jprover
from zkevm_prover_tpu_torch.ops import goldilocks as gl
from zkevm_prover_tpu_torch.ops import stark_cuda
from zkevm_prover_tpu_torch.stark import prover as tprover


def _operands(n: int, num_dim: int, den_dim: int, seed: int):
    rng = np.random.default_rng(seed)
    shape = lambda d: (n,) if d == 1 else (n, 3)
    return (rng.integers(0, gl.P, shape(num_dim), dtype=np.uint64),
            rng.integers(1, gl.P, shape(den_dim), dtype=np.uint64))


def _both(num: np.ndarray, den: np.ndarray):
    """(the port's z through grand_products, the JAX package's z)."""
    n = num.shape[0]
    z = gl.from_u64(np.zeros((n, 3), np.uint64), "cpu")
    tprover.grand_products([(gl.from_u64(num, "cpu"),
                             gl.from_u64(den, "cpu"), z)])
    return gl.to_u64(z), np.asarray(jprover.calculate_z(num, den))


@pytest.mark.parametrize("n", [1, 2, 1 << 10])
@pytest.mark.parametrize("num_dim,den_dim", [(1, 1), (3, 3), (1, 3), (3, 1)])
def test_grand_product_twin_matches_jax(n, num_dim, den_dim):
    num, den = _operands(n, num_dim, den_dim, n * 10 + num_dim + den_dim)
    port, jax_ = _both(num, den)
    np.testing.assert_array_equal(port, jax_)
    assert port[0].tolist() == [1, 0, 0]


@pytest.mark.parametrize("den_dim", [1, 3])
def test_grand_product_zero_den_matches_jax(den_dim):
    num, den = _operands(1 << 10, 3, den_dim, 5)
    den[517] = 0
    port, jax_ = _both(num, den)
    np.testing.assert_array_equal(port, jax_)
    want = np.zeros_like(port)
    want[0, 0] = 1
    np.testing.assert_array_equal(port, want)


def test_grand_products_write_every_argument():
    """Several arguments in one call, z into strided views of one section,
    equal to calculate_z of each."""
    args = [_operands(64, d, e, 40 + k)
            for k, (d, e) in enumerate([(1, 1), (3, 3), (3, 1)])]
    sec = gl.from_u64(np.zeros((64, 9), np.uint64), "cpu")
    tprover.grand_products([(gl.from_u64(num, "cpu"), gl.from_u64(den, "cpu"),
                             sec[:, 3 * k:3 * k + 3])
                            for k, (num, den) in enumerate(args)])
    for k, (num, den) in enumerate(args):
        np.testing.assert_array_equal(
            gl.to_u64(sec[:, 3 * k:3 * k + 3]),
            np.asarray(jprover.calculate_z(num, den)))


# The kernel's decomposition (ops/stark_cuda.grand_product_model: its index
# maps, runs, lane scan, tile aggregates and look-back, at tiny tiles)
# against the JAX package's calculate_z. (n, lanes, run, look, in_flight):
# one tile and less, a tile's edges, look-backs that end on an inclusive
# prefix 2 and 4 tiles back (the butterfly's steps) and walks over several
# windows (in_flight tiles before each still without their inclusive
# prefix), and 2^12 rows over 64 tiles.
MODEL_CASES = [(1, 4, 2, 2, 0), (7, 4, 2, 2, 0), (8, 4, 2, 2, 1),
               (9, 4, 2, 2, 1), (75, 4, 2, 2, 2), (163, 4, 2, 2, 10),
               (1 << 12, 8, 8, 4, 4)]


@pytest.mark.parametrize("n,lanes,run,look,in_flight", MODEL_CASES)
@pytest.mark.parametrize("num_dim,den_dim", [(1, 1), (3, 3), (1, 3), (3, 1)])
def test_grand_product_model_matches_jax(n, lanes, run, look, in_flight,
                                         num_dim, den_dim):
    num, den = _operands(n, num_dim, den_dim, 7 * n + num_dim + den_dim)
    z = stark_cuda.grand_product_model(
        gl.from_u64(num, "cpu"), gl.from_u64(den, "cpu"), lanes=lanes,
        run=run, look=look, in_flight=in_flight)
    np.testing.assert_array_equal(gl.to_u64(z),
                                  np.asarray(jprover.calculate_z(num, den)))


@pytest.mark.parametrize("den_dim", [1, 3])
@pytest.mark.parametrize("row", [0, 162, 100])
def test_grand_product_model_zero_den_matches_jax(den_dim, row):
    """A zero den in row 0, in the last row and in a later tile than the
    first: the zero flag's rewrite, z = (1, 0, 0, ...)."""
    num, den = _operands(163, 3, den_dim, 11 + row)
    den[row] = 0
    z = gl.to_u64(stark_cuda.grand_product_model(
        gl.from_u64(num, "cpu"), gl.from_u64(den, "cpu"), lanes=4, run=2,
        look=2, in_flight=10))
    np.testing.assert_array_equal(z, np.asarray(jprover.calculate_z(num,
                                                                    den)))
    assert z[0].tolist() == [1, 0, 0] and not z[1:].any()
