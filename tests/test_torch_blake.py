"""The port's Blake2b (`zkevm_prover_tpu_torch/ops/blake.py`) against the
JAX package's `ops/blake.py` and hashlib: the plain twin of the CUDA
compression equals the jitted JAX compression bit for bit (both `last`
values, the counter's edges), and the host framing gives hashlib's
digests across block boundaries. The card's kernel is held to the same
twin in tests/test_torch_cuda.py and chip_smoke.py."""

import hashlib

import numpy as np
import pytest
import torch

from zkevm_prover_tpu.ops import blake as jblake
from zkevm_prover_tpu_torch.ops import blake

# the lengths of the JAX pipeline test and the block edges around them
LENGTHS = (0, 1, 3, 55, 127, 128, 129, 255, 256, 300, 1000)


def _instances(n: int, seed: int):
    """n random (h, m, t, last) with the counter's edges and both flags."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 1 << 64, (n, 8), dtype=np.uint64)
    m = rng.integers(0, 1 << 64, (n, 16), dtype=np.uint64)
    t = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    t[:3] = [0, 128, (1 << 64) - 1]
    last = rng.integers(0, 2, n).astype(bool)
    last[:2] = [False, True]
    return h, m, t, last


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a.view(np.int64))


def test_compress_plain_matches_jax():
    h, m, t, last = _instances(64, 70)
    want = np.asarray(jblake.blake2b_compress(h, m, t, last))
    got = blake.blake2b_compress_plain(_t(h), _t(m), _t(t),
                                       torch.as_tensor(last))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    # the dispatcher takes the plain twin for CPU tensors, batch shape kept
    again = blake.blake2b_compress(_t(h).reshape(8, 8, 8),
                                   _t(m).reshape(8, 8, 16),
                                   _t(t).reshape(8, 8),
                                   torch.as_tensor(last).reshape(8, 8))
    assert torch.equal(again.reshape(64, 8), got)


def test_compress_rejects_mismatched_shapes():
    h, m, t, last = (torch.as_tensor(x) for x in _instances(4, 71))
    with pytest.raises(ValueError, match="blake2b_compress takes"):
        blake.blake2b_compress(h.view(torch.int64), m.view(torch.int64)[:3],
                               t.view(torch.int64), last)


@pytest.mark.parametrize("n", LENGTHS)
def test_blake2b_256_matches_hashlib_and_jax(n):
    data = (bytes(range(min(n, 256))) + bytes(max(0, n - 256)))[:n]
    want = hashlib.blake2b(data, digest_size=32).digest()
    assert blake.blake2b_256(data, device="cpu") == want
    assert jblake.blake2b_256(data) == want


def test_blake2b_256_many_matches_hashlib_and_jax():
    rng = np.random.default_rng(72)
    msgs = [b"", b"abc", bytes(range(128))] + [
        rng.bytes(int(k)) for k in rng.integers(0, 129, 61)]
    want = [hashlib.blake2b(msg, digest_size=32).digest() for msg in msgs]
    assert blake.blake2b_256_many(msgs, device="cpu") == want
    assert jblake.blake2b_256_many(msgs) == want
    assert blake.blake2b_256_many([], device="cpu") == []
    with pytest.raises(ValueError, match="at most 128"):
        blake.blake2b_256_many([bytes(129)], device="cpu")


def test_blake2b_256_test():
    assert blake.blake2b_256_test(device="cpu")
    assert jblake.blake2b_256_test()


def test_blake2b_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        blake.blake2b_256(b"abc")
