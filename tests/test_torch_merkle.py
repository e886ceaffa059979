"""The port's Merkle trees against the JAX package's: same roots, same group
proofs, and a tampered path is rejected. Widths cover the sponge's chunk
boundaries (8, 9) and the JAX package's LEAF_COLS blocking (64, 65, and
189, arith's stage-1 width)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from zkevm_prover_tpu.ops import merkle as jmerkle
from zkevm_prover_tpu_torch.ops import goldilocks as gl
from zkevm_prover_tpu_torch.ops import merkle as tmerkle
from zkevm_prover_tpu_torch.ops import poseidon_cuda


@pytest.mark.parametrize("height,width", [
    (1, 3), (16, 4), (64, 13),
    *[(h, w) for h in (1, 2, 256) for w in (8, 9, 64, 65, 189)]])
def test_root_and_group_proofs_match_jax(height, width):
    rng = np.random.default_rng(height * 100 + width)
    src = rng.integers(0, gl.P, (height, width), dtype=np.uint64)
    jt = jmerkle.MerkleTree.commit(jnp.asarray(src))
    tt = tmerkle.MerkleTree.commit(gl.from_u64(src, "cpu"))
    np.testing.assert_array_equal(tt.root(), jt.root())
    assert tt.proof_length() == jt.proof_length()
    for idx in sorted({0, height // 2, height - 1}):
        trow, tsib = tt.get_group_proof(idx)
        jrow, jsib = jt.get_group_proof(idx)
        np.testing.assert_array_equal(trow, jrow)
        np.testing.assert_array_equal(tsib, jsib)
        assert tmerkle.verify_group_proof(tt.root(), idx, trow, tsib)


def _jax_levels_leaf_blocked(src: np.ndarray) -> list:
    """The JAX package's column-blocked route (its CPU route for big
    sources): the leaf sponge folded LEAF_COLS columns at a time, then the
    levels."""
    h, w = src.shape
    x = jnp.asarray(src)
    digest = jnp.zeros((h, jmerkle.HASH_SIZE), dtype=jnp.uint64)
    for off in range(0, w, jmerkle.LEAF_COLS):
        blk = x[:, off:off + jmerkle.LEAF_COLS]
        digest = jmerkle._leaf_fold_jit(h, blk.shape[1])(blk, digest)
    return [np.asarray(lv) for lv in jmerkle._levels_jit(h)(digest)]


@pytest.mark.parametrize("width", [65, 189])
def test_levels_match_jax_leaf_blocked_route(width):
    src = np.random.default_rng(width).integers(0, gl.P, (256, width),
                                                dtype=np.uint64)
    want = _jax_levels_leaf_blocked(src)
    got = tmerkle.merkelize_levels(gl.from_u64(src, "cpu"))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(gl.to_u64(a), b)


@pytest.mark.parametrize("height,width", [(1, 0), (2, 1), (8, 4), (8, 5),
                                          (32, 17)])
def test_plain_levels_equal_dispatched_levels_on_cpu(height, width):
    src = gl.from_u64(np.random.default_rng(height + width).integers(
        0, gl.P, (height, width), dtype=np.uint64), "cpu")
    got = tmerkle.merkelize_levels(src)
    want = tmerkle.merkelize_levels_plain(src)
    assert len(got) == len(want) == height.bit_length()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fused_commit_refuses_cpu_tensors():
    before = dict(poseidon_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        poseidon_cuda.merkle_levels(torch.zeros((4, 9), dtype=torch.int64))
    assert poseidon_cuda.launches == before


def test_tampered_path_rejected():
    rng = np.random.default_rng(3)
    src = rng.integers(0, gl.P, (32, 9), dtype=np.uint64)
    tree = tmerkle.MerkleTree.commit(gl.from_u64(src, "cpu"))
    row, sib = tree.get_group_proof(5)
    bad_row = row.copy()
    bad_row[0] ^= np.uint64(1)
    assert not tmerkle.verify_group_proof(tree.root(), 5, bad_row, sib)
    bad_sib = sib.copy()
    bad_sib[2, 3] ^= np.uint64(1)
    assert not tmerkle.verify_group_proof(tree.root(), 5, row, bad_sib)
    assert not tmerkle.verify_group_proof(tree.root(), 4, row, sib)
