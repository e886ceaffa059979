"""The port's hash functions against the JAX package, bit for bit, and the
small hash batch end to end on the CPU.

`ops/keccak.py` and `ops/sha256.py`: the constants, the plain Keccak-f and
SHA-256 compression (the CUDA kernels' twins) against the jitted JAX
functions on random inputs, the single-block digests against the JAX
package, the host Keccak and hashlib.

The small hash batch (`executor/examples.small_hash_batch`: PaddingKK,
PaddingSha256, KeccakF and Sha256F) proved through the port's `Executor`
on the CPU: each proof's JSON hashes to a digest pinned from the JAX
package's proofs of the same traces. The slow test recomputes those JAX
proofs and cross-verifies both ways (minutes of XLA compile):

    ZK_SLOW=1 python -m pytest -q -m slow tests/test_torch_hashes.py
"""

import functools
import hashlib

import jax
import numpy as np
import pytest
import torch

from zkevm_prover_tpu.ops import keccak as jkeccak
from zkevm_prover_tpu.ops import sha256 as jsha256
from zkevm_prover_tpu_torch.executor import examples
from zkevm_prover_tpu_torch.ops import hash_cuda, keccak, sha256
from zkevm_prover_tpu_torch.stark.proof import StarkProof
from zkevm_prover_tpu_torch.stark.verifier import VerifyError

# sha256 of each SM's proof JSON, from the JAX package's proofs of
# examples.small_hash_batch(): PaddingKK and PaddingSha256 through its
# Executor.prove_all, KeccakF and Sha256F through StarkProver on the traces
# of the first 4 emitted blocks (the slow test below)
PINS = {
    "padding_kk":
        "366befb05b861925b7e7e0fc1b5c924fdf70ea446f53322e0785df900e92636d",
    "padding_sha256":
        "ed9de49e72318cdfdbea616bee15adf0d482b9a5e57dabe885e260725cfa77a4",
    "keccak_f":
        "772121f946e815107375d149e238f42bc0963c22e1910fdde7b08f0438b512c4",
    "sha256_f":
        "2c732b4edefa92adb306387c4fd5a2539e0e9a13ccbfaddf6295c1fa8ecd317d",
}


def _i64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def test_constants_match_jax():
    np.testing.assert_array_equal(keccak._RC, jkeccak._RC)
    np.testing.assert_array_equal(keccak._ROT, jkeccak._ROT)
    assert keccak.RATE_BYTES == jkeccak.RATE_BYTES
    np.testing.assert_array_equal(sha256._K, jsha256._K)
    np.testing.assert_array_equal(sha256.IV, jsha256.IV)
    assert sha256._K.dtype == jsha256._K.dtype
    assert sha256.IV.dtype == jsha256.IV.dtype


def test_keccak_f_matches_jax_and_host():
    states = np.random.default_rng(40).integers(0, 1 << 64, (64, 25),
                                                dtype=np.uint64)
    want = np.asarray(jax.jit(jkeccak.keccak_f)(states))
    got = keccak.keccak_f(_i64(states))
    np.testing.assert_array_equal(_u64(got), want)
    np.testing.assert_array_equal(_u64(keccak.keccak_f_plain(_i64(states))),
                                  want)
    for row in states[:4]:
        assert [int(v) for v in _u64(keccak.keccak_f(_i64(row)))] == \
            keccak._keccak_f_host([int(v) for v in row])
    # any batch shape
    np.testing.assert_array_equal(
        _u64(keccak.keccak_f(_i64(states.reshape(4, 16, 25)))),
        want.reshape(4, 16, 25))


def _keccak_blocks(msgs):
    blocks = np.zeros((len(msgs), keccak.RATE_BYTES), dtype=np.uint8)
    for i, m in enumerate(msgs):
        blocks[i, :len(m)] = bytearray(m)
        blocks[i, len(m)] ^= 0x01
        blocks[i, -1] ^= 0x80
    return blocks


def test_keccak256_blocks_matches_jax_and_host():
    rng = np.random.default_rng(41)
    msgs = [b"abc", b"", b"hello world", bytes(135)] + [
        rng.bytes(int(n)) for n in rng.integers(0, 136, 12)]
    blocks = _keccak_blocks(msgs)
    got = keccak.keccak256_blocks(blocks, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (len(msgs), 32)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.jit(jkeccak.keccak256_blocks)(blocks)))
    for i, m in enumerate(msgs):
        assert bytes(got[i].numpy()) == keccak.keccak256(m) == \
            jkeccak.keccak256(m)


def test_sha256_compress_matches_jax():
    rng = np.random.default_rng(42)
    state = rng.integers(0, 1 << 32, (64, 8), dtype=np.uint64)
    words = rng.integers(0, 1 << 32, (64, 16), dtype=np.uint64)
    want = np.asarray(jax.jit(jsha256.sha256_compress)(
        state.astype(np.uint32), words.astype(np.uint32)))
    for fn in (sha256.sha256_compress, sha256.sha256_compress_plain):
        got = fn(_i64(state), _i64(words))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # the words' low 32 bits are taken, as the kernel reads them
    high = _i64(words | np.uint64(0xABCD << 32))
    np.testing.assert_array_equal(
        sha256.sha256_compress(_i64(state), high).numpy(),
        want.astype(np.int64))


def test_sha256_blocks_matches_jax_and_hashlib():
    rng = np.random.default_rng(43)
    msgs = [b"abc", b"", b"The quick brown fox jumps over the lazy dog"] + [
        rng.bytes(int(n)) for n in rng.integers(0, 56, 12)]
    blocks = np.zeros((len(msgs), 64), dtype=np.uint8)
    for i, m in enumerate(msgs):
        blocks[i, :len(m)] = bytearray(m)
        blocks[i, len(m)] = 0x80
        blocks[i, 56:] = np.frombuffer((8 * len(m)).to_bytes(8, "big"),
                                       dtype=np.uint8)
    got = sha256.sha256_blocks(blocks, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.jit(jsha256.sha256_blocks)(blocks)))
    for i, m in enumerate(msgs):
        assert bytes(got[i].numpy()) == hashlib.sha256(m).digest() == \
            sha256.sha256(m)


def test_kernel_wrappers_refuse_cpu_tensors():
    before = dict(hash_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hash_cuda.keccak_f(torch.zeros((4, 25), dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        hash_cuda.sha256_compress(torch.zeros((4, 8), dtype=torch.int64),
                                  torch.zeros((4, 16), dtype=torch.int64))
    assert hash_cuda.launches == before


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        keccak.keccak256_blocks(_keccak_blocks([b"abc"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sha256.sha256_blocks(np.zeros((1, 64), dtype=np.uint8))


def test_shapes_are_checked():
    with pytest.raises(ValueError, match="25"):
        keccak.keccak_f(torch.zeros((4, 24), dtype=torch.int64))
    with pytest.raises(ValueError, match="16"):
        sha256.sha256_compress(torch.zeros((4, 8), dtype=torch.int64),
                               torch.zeros((4, 15), dtype=torch.int64))


# ---------------------------------------------------------------------------
# the small hash batch, proved
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU proves run on one thread: torch's intra-op pool slows
    down by orders of magnitude beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _port():
    batch = examples.small_hash_batch()
    ex = batch.executor("cpu")
    traces = ex.execute(batch.actions())
    traces.update(ex.execute_gates())
    return ex, ex.prove_traces(traces)


def proof_digests(proofs: dict) -> dict:
    return {name: hashlib.sha256(proof.to_json().encode()).hexdigest()
            for name, (_, proof) in proofs.items()}


@pytest.mark.parametrize("sm", sorted(PINS))
def test_small_hash_batch_proofs_match_pins(sm):
    _, proofs = _port()
    assert proof_digests({sm: proofs[sm]}) == {sm: PINS[sm]}


def test_small_hash_batch_verifies_and_rejects_tampering():
    ex, proofs = _port()
    assert list(proofs) == ["padding_kk", "padding_sha256", "keccak_f",
                            "sha256_f"]
    assert ex.verify_all(proofs)
    # the gate SM's proof, the one with a connection argument
    prover, proof = proofs["keccak_f"]
    bad = StarkProof.from_json(proof.to_json())
    bad.fri[0].queries[0][0].values[0] += 1
    with pytest.raises(VerifyError):
        ex.verify_all({"keccak_f": (prover, bad)})


@pytest.mark.slow
def test_jax_small_hash_batch_proofs_match_pins_and_cross_verify():
    from zkevm_prover_tpu.executor import BatchActions as JActions
    from zkevm_prover_tpu.executor import Executor as JExecutor
    from zkevm_prover_tpu.executor.sm import keccak_circuit as jkc
    from zkevm_prover_tpu.executor.sm import keccak_f as jkeccak_f
    from zkevm_prover_tpu.executor.sm import padding_kk as jpadding_kk
    from zkevm_prover_tpu.executor.sm import padding_sha256 as jpadding_sha
    from zkevm_prover_tpu.executor.sm import sha256_circuit as jsc
    from zkevm_prover_tpu.executor.sm import sha256_f as jsha256_f
    from zkevm_prover_tpu.stark.proof import StarkProof as JProof
    from zkevm_prover_tpu.stark.prover import StarkProver as JProver
    from zkevm_prover_tpu.stark.setup import StarkSetup as JSetup
    from zkevm_prover_tpu.stark.verifier import verify as jverify
    from zkevm_prover_tpu_torch.stark.verifier import verify

    batch = examples.small_hash_batch()
    nb = batch.n_bits
    jproofs = JExecutor(n_bits=nb).prove_all(
        JActions(keccak=batch.keccak, sha256=batch.sha256))
    _, kacts, _ = jpadding_kk.execute(batch.keccak, nb["padding_kk"])
    _, sacts, _ = jpadding_sha.execute(batch.sha256, nb["padding_sha256"])
    ex, proofs = _port()
    blocks = ex.counters(batch.actions())
    for gate, pad, mod, build, acts in (
            ("keccak_f", "padding_kk", jkeccak_f, jkc.build, kacts),
            ("sha256_f", "padding_sha256", jsha256_f, jsc.build, sacts)):
        cfg = batch.gates[gate]
        circ = build(cfg["rounds"])
        used = min(blocks[pad], ex.gate_capacity(gate))
        trace = mod.execute(acts[:used], nb[gate], circ, cfg["pack"],
                            cfg["limb_bits"])
        prover = JProver(JSetup(mod.build_air(nb[gate], circ, cfg["pack"],
                                              cfg["limb_bits"]),
                                n_queries=8, fri_fold_bits=2))
        jproofs[gate] = (prover, prover.prove(trace))
    assert proof_digests(jproofs) == PINS
    for name, (jp, jproof) in jproofs.items():
        tp, tproof = proofs[name]
        np.testing.assert_array_equal(tp.verkey, jp.verkey)
        assert verify(tp.setup, tp.verkey,
                      StarkProof.from_json(jproof.to_json()), device="cpu")
        assert jverify(jp.setup, jp.verkey, JProof.from_json(tproof.to_json()))
