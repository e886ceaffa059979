"""Tests of the port that need an NVIDIA card (marker `cuda`; they skip
where CUDA is absent). The file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Each mode's kernel is held bit for bit against the plain torch permutation,
the fused Merkle commit against the chunked plain tree, the Keccak-f and
SHA-256 kernels against their plain twins and the host oracles, and proofs
made on the card against the port's CPU proofs (which the other
test_torch_* files hold against the JAX package)."""

import numpy as np
import pytest
import torch

from zkevm_prover_tpu_torch.executor import BatchActions, Executor
from zkevm_prover_tpu_torch.ops import goldilocks as gl
from zkevm_prover_tpu_torch.ops import hash_cuda, keccak, sha256
from zkevm_prover_tpu_torch.ops import merkle
from zkevm_prover_tpu_torch.ops import poseidon_constants as pc
from zkevm_prover_tpu_torch.ops import poseidon_cuda
from zkevm_prover_tpu_torch.ops import poseidon_gl as pos
from zkevm_prover_tpu_torch.ops import stark_cuda
from zkevm_prover_tpu_torch.stark import examples
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.setup import StarkSetup
from zkevm_prover_tpu_torch.stark.verifier import verify

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the port's kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("h", [1, 127, 515, 1 << 16])
def test_kernel_matches_plain(card, h):
    # any u64 input, canonical or not
    states = np.random.default_rng(h).integers(0, 1 << 64, (h, 12),
                                               dtype=np.uint64)
    x = gl.from_u64(states, card)
    before = poseidon_cuda.launches["mxu96"]
    out = pos.permute(x)
    assert poseidon_cuda.launches["mxu96"] == before + 1
    assert torch.equal(out, pos.permute_plain(x))


# Every mode at two heights; every mode but mxu96, which
# test_kernel_matches_plain covers, also at ragged ones (blocked's tiles of
# 128 states, 2d's and 1d's blocks of 128 threads, mxu's and mxu24's warps
# of 32 states in two m16 tiles): 31 and 33 a part-filled warp and m16 tile
# of mxu and mxu24, the last giving blocked's persistent grid
# (132 SMs x 5 blocks on the H100) more tiles than blocks, so each block
# reuses its ring slots.
RAGGED = [1, 31, 33, 127, 129, 16385, (1 << 16) + 3, 3 * (1 << 17) + 5]


@pytest.mark.parametrize("mode,h", [(m, h) for m in poseidon_cuda.MODES
                                    for h in (517, 1 << 16)]
                         + [(m, h) for m in ("blocked", "1d", "2d", "mxu",
                                             "mxu24")
                            for h in RAGGED])
def test_mode_kernel_matches_plain(card, mode, h):
    rng = np.random.default_rng(h)
    states = rng.integers(0, gl.P, (h, 12), dtype=np.uint64)
    edges = np.stack([np.zeros(12, np.uint64),
                      np.full(12, gl.P - 1, np.uint64)])[:h]
    states[h - len(edges):] = edges
    x = gl.from_u64(states, card)
    before = dict(poseidon_cuda.launches)
    out = poseidon_cuda.ENTRY[mode](x)
    assert poseidon_cuda.launches[mode] == before[mode] + 1
    assert {m: n for m, n in poseidon_cuda.launches.items() if m != mode} == \
        {m: n for m, n in before.items() if m != mode}
    assert out.shape == x.shape and out.is_contiguous()
    assert torch.equal(out, pos.permute_plain(x))


def test_kernel_rejects_what_it_does_not_take(card):
    before = dict(poseidon_cuda.launches)
    x = torch.zeros((8, 12), dtype=torch.int64, device=card)
    with pytest.raises(TypeError):
        poseidon_cuda.permute(x.to(torch.int32))
    with pytest.raises(ValueError):
        poseidon_cuda.permute(x[:, :11])
    with pytest.raises(ValueError):
        poseidon_cuda.permute(torch.zeros((12, 8), dtype=torch.int64,
                                          device=card).T)
    assert poseidon_cuda.launches == before


def _same_levels(got, want):
    assert [lv.shape for lv in got] == [lv.shape for lv in want]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("w", [1, 4, 5, 8, 9, 48, 189])
@pytest.mark.parametrize("h", [1, 2, 256, 1 << 16])
def test_fused_merkle_matches_plain(card, h, w):
    src = gl.from_u64(np.random.default_rng(h * 1000 + w).integers(
        0, gl.P, (h, w), dtype=np.uint64), card)
    before = dict(poseidon_cuda.launches)
    got = merkle.merkelize_levels(src)      # MODE mxu96: the fused kernel
    after = dict(poseidon_cuda.launches)
    assert after["merkle"] - before["merkle"] == len(
        poseidon_cuda.merkle_plan(h, w))
    assert {m: n for m, n in after.items() if m != "merkle"} == \
        {m: n for m, n in before.items() if m != "merkle"}
    _same_levels(got, merkle.merkelize_levels_plain(src))


def test_fused_merkle_takes_strided_sources(card):
    full = gl.from_u64(np.random.default_rng(5).integers(
        0, 1 << 64, (256, 60), dtype=np.uint64), card)   # any u64
    for src in (full[:, 7:56], full[:, 3:5], full.T.contiguous().T,
                full[:, ::3]):
        _same_levels(merkle.merkelize_levels(src),
                     merkle.merkelize_levels_plain(src))


def test_merkle_other_modes_take_the_chunked_path(card):
    src = gl.from_u64(np.random.default_rng(6).integers(
        0, gl.P, (64, 13), dtype=np.uint64), card)
    want = merkle.merkelize_levels_plain(src)
    mode = poseidon_cuda.MODE
    try:
        poseidon_cuda.MODE = "mxu24"
        before = dict(poseidon_cuda.launches)
        got = merkle.merkelize_levels(src)
        assert poseidon_cuda.launches["merkle"] == before["merkle"]
        assert poseidon_cuda.launches["mxu24"] > before["mxu24"]
    finally:
        poseidon_cuda.MODE = mode
    _same_levels(got, want)


def test_fused_merkle_rejects_what_it_does_not_take(card):
    before = dict(poseidon_cuda.launches)
    x = torch.zeros((8, 5), dtype=torch.int64, device=card)
    with pytest.raises(TypeError):
        poseidon_cuda.merkle_levels(x.to(torch.int32))
    with pytest.raises(ValueError, match="power of two"):
        poseidon_cuda.merkle_levels(x[:6])
    with pytest.raises(ValueError):
        poseidon_cuda.merkle_levels(x[:, 0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        poseidon_cuda.merkle_levels(x.cpu())
    assert poseidon_cuda.launches == before


def test_kernel_refuses_another_mds(card):
    x = torch.zeros((8, 12), dtype=torch.int64, device=card)
    lazy = ("mxu96", "2d", "mxu", "mxu24", "blocked", "1d")   # poseidon_gl's
    before = dict(poseidon_cuda.launches)
    try:
        pc.load_constants("placeholder")
        for mode in lazy:
            with pytest.raises(ValueError, match="compiled into"):
                poseidon_cuda.ENTRY[mode](x)
        with pytest.raises(ValueError, match="compiled into"):
            poseidon_cuda.merkle_levels(x)
    finally:
        pc.load_constants(None)
    assert poseidon_cuda.launches == before
    for mode in lazy:
        assert torch.equal(poseidon_cuda.ENTRY[mode](x), pos.permute_plain(x))


@pytest.mark.parametrize("mode", ["mxu96", "2d", "mxu", "mxu24", "blocked",
                                  "1d"])
def test_launch_takes_the_laid_out_batch(card, mode):
    states = np.random.default_rng(11).integers(0, gl.P, (300, 12),
                                                dtype=np.uint64)
    x = gl.from_u64(states, card)
    laid = x.T.contiguous() if mode == "1d" else x
    out = torch.empty_like(laid)
    before = poseidon_cuda.launches[mode]
    poseidon_cuda.launch(mode, laid, out)
    assert poseidon_cuda.launches[mode] == before + 1
    got = out.T if mode == "1d" else out
    assert torch.equal(got, pos.permute_plain(x))
    with pytest.raises(ValueError):   # the other layout
        poseidon_cuda.launch(mode, laid.T.contiguous(), out.T.contiguous())
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.empty(laid.numel() + 1, dtype=torch.int64, device=card)
        poseidon_cuda.launch(mode, laid, flat[1:].view(laid.shape))
    assert poseidon_cuda.launches[mode] == before + 1


@pytest.mark.parametrize("mode", ["mxu96", "2d", "mxu", "mxu24", "blocked",
                                  "1d"])
def test_failed_launch_raises_uncounted(card, mode, monkeypatch):
    x = torch.zeros((8, 12), dtype=torch.int64, device=card)
    poseidon_cuda.ENTRY[mode](x)   # the library is loaded
    lib = poseidon_cuda._libs["poseidon_gl"]
    fn = poseidon_cuda._GL_PERMUTE[mode]
    monkeypatch.setattr(lib, fn, lambda *args: 1)   # cudaErrorInvalidValue
    before = dict(poseidon_cuda.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        poseidon_cuda.ENTRY[mode](x)
    assert poseidon_cuda.launches == before


def test_blocked_kernel_refuses_unaligned_pointers(card):
    x = torch.zeros((9, 12), dtype=torch.int64, device=card)
    poseidon_cuda.permute_blocked(x)   # the library is loaded
    lib = poseidon_cuda._libs["poseidon_gl"]
    stream = torch.cuda.current_stream().cuda_stream
    # cudaErrorInvalidValue, nothing launched
    assert lib.poseidon_gl_blocked_permute(x.data_ptr() + 8, x.data_ptr(), 8,
                                           stream) == 1


@pytest.mark.parametrize("name", ["fibonacci", "lookup", "permutation",
                                  "connection"])
def test_toy_air_card_proof_matches_cpu(card, name):
    air, trace = examples.all_air_traces()[name]
    setup = StarkSetup(air, n_queries=8, fri_fold_bits=2)
    prover = StarkProver(setup, device=card)
    proof = prover.prove(trace)
    cpu = StarkProver(setup, device="cpu").prove(trace)
    assert proof.to_json() == cpu.to_json()
    assert verify(setup, prover.verkey, proof, device=card)


def test_slice_card_proof_matches_cpu(card):
    rng = np.random.default_rng(2)
    actions = [{"state": [int(v) for v in rng.integers(0, 1 << 32, 12)]}
               for _ in range(7)]
    jsons = {}
    for dev in (card, "cpu"):
        ex = Executor(n_bits={"poseidon_g": 8}, device=dev)
        proofs = ex.prove_all(BatchActions(poseidon_g=list(actions)))
        assert ex.verify_all(proofs)
        jsons[str(dev)] = proofs["poseidon_g"][1].to_json()
    assert jsons["cuda"] == jsons["cpu"]


def test_state_tree_card_root_matches_cpu(card, monkeypatch):
    from zkevm_prover_tpu_torch.executor import examples as batches
    from zkevm_prover_tpu_torch.hashdb import Database

    monkeypatch.setattr(poseidon_cuda, "MODE", "mxu96")
    before = poseidon_cuda.launches["mxu96"]
    tree = batches.state_tree(Database(), 1 << 10, 3, card)
    # one launch per hash batch: the keys' two, values, leaves, each level
    assert poseidon_cuda.launches["mxu96"] - before == tree.depth + 4
    cpu = batches.state_tree(Database(), 1 << 10, 3, "cpu")
    assert tree.root == cpu.root
    assert np.array_equal(tree.registers, cpu.registers)


def test_storage_batch_card_proof_matches_cpu(card):
    from zkevm_prover_tpu_torch.executor import examples as batches

    jsons = {}
    for dev in (card, "cpu"):
        db, actions = batches.small_storage_batch(dev)
        ex = Executor(device=dev)
        proofs = ex.prove_all(BatchActions(storage=actions), db=db)
        assert sorted(proofs) == ["climb_key", "poseidon_g", "storage"]
        if dev == card:
            assert ex.verify_all(proofs)
        jsons[str(dev)] = {name: proof.to_json()
                           for name, (_, proof) in proofs.items()}
    assert jsons["cuda"] == jsons["cpu"]


def test_page_store_builds_into_the_build_directory(card, tmp_path):
    import pathlib

    from zkevm_prover_tpu_torch.hashdb64 import PageStore, page_store

    lib = pathlib.Path(page_store.build_library())
    assert lib.parent.parent.name == "build" and lib.exists()
    ps = PageStore(str(tmp_path / "kv.pages"))
    ps.set(bytes(range(32)), b"value")
    assert ps.get(bytes(range(32))) == b"value"
    ps.close()


# batches: 1, a part-filled first block, a whole block of 128 threads, one
# past it, and ragged sizes over many blocks
HASH_SIZES = [1, 31, 128, 129, 515, (1 << 16) + 3]


@pytest.mark.parametrize("h", HASH_SIZES)
def test_keccak_kernel_matches_plain(card, h):
    states = np.random.default_rng(h).integers(0, 1 << 64, (h, 25),
                                               dtype=np.uint64)
    x = gl.from_u64(states, card)
    before = dict(hash_cuda.launches)
    out = keccak.keccak_f(x)
    assert hash_cuda.launches["keccak_f"] == before["keccak_f"] + 1
    assert hash_cuda.launches["sha256_compress"] == before["sha256_compress"]
    assert out.shape == x.shape and out.is_contiguous()
    assert torch.equal(out, keccak.keccak_f_plain(x))


@pytest.mark.parametrize("h", HASH_SIZES)
def test_sha256_kernel_matches_plain(card, h):
    rng = np.random.default_rng(h)
    state = gl.from_u64(rng.integers(0, 1 << 32, (h, 8), dtype=np.uint64),
                        card)
    words = gl.from_u64(rng.integers(0, 1 << 32, (h, 16), dtype=np.uint64),
                        card)
    before = dict(hash_cuda.launches)
    out = sha256.sha256_compress(state, words)
    assert hash_cuda.launches["sha256_compress"] == \
        before["sha256_compress"] + 1
    assert hash_cuda.launches["keccak_f"] == before["keccak_f"]
    want = sha256.sha256_compress_plain(state, words)
    assert torch.equal(out, want)
    # the kernel reads the low 32 bits of each word, as the plain twin
    assert torch.equal(sha256.sha256_compress(state, words | (7 << 40)),
                       want)


def test_hash_kernels_match_host_oracles(card):
    import hashlib

    states = np.random.default_rng(7).integers(0, 1 << 64, (64, 25),
                                               dtype=np.uint64)
    out = gl.to_u64(keccak.keccak_f(gl.from_u64(states, card)))
    for row, got in zip(states, out):
        assert [int(v) for v in got] == keccak._keccak_f_host(
            [int(v) for v in row])
    rng = np.random.default_rng(8)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 56, 64)]
    blocks = np.zeros((len(msgs), 64), dtype=np.uint8)
    for i, m in enumerate(msgs):
        blocks[i, :len(m)] = bytearray(m)
        blocks[i, len(m)] = 0x80
        blocks[i, 56:] = np.frombuffer((8 * len(m)).to_bytes(8, "big"),
                                       dtype=np.uint8)
    digests = sha256.sha256_blocks(blocks, device=card).cpu().numpy()
    for m, d in zip(msgs, digests):
        assert bytes(d) == hashlib.sha256(m).digest()


def test_hash_kernels_reject_what_they_do_not_take(card):
    before = dict(hash_cuda.launches)
    x = torch.zeros((4, 25), dtype=torch.int64, device=card)
    with pytest.raises(TypeError):
        hash_cuda.keccak_f(x.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        hash_cuda.keccak_f(torch.zeros((25, 4), dtype=torch.int64,
                                       device=card).T)
    with pytest.raises(ValueError, match="one card"):
        hash_cuda.sha256_compress(
            torch.zeros((4, 8), dtype=torch.int64, device=card),
            torch.zeros((3, 16), dtype=torch.int64, device=card))
    assert hash_cuda.launches == before
    empty = torch.zeros((0, 25), dtype=torch.int64, device=card)
    assert hash_cuda.keccak_f(empty).shape == (0, 25)
    assert hash_cuda.launches == before


def test_small_hash_batch_card_proof_matches_cpu(card):
    from zkevm_prover_tpu_torch.executor import examples as batches

    jsons = {}
    for dev in (card, "cpu"):
        batch = batches.small_hash_batch()
        ex = batch.executor(dev)
        before = hash_cuda.launches["sha256_compress"]
        traces = ex.execute(batch.actions())
        traces.update(ex.execute_gates())
        if dev == card:
            # one compression launch per active PaddingSha256 block
            assert hash_cuda.launches["sha256_compress"] - before == \
                ex.counters(batch.actions())["padding_sha256_capacity"]
        proofs = ex.prove_traces(traces)
        if dev == card:
            assert ex.verify_all(proofs)
        jsons[str(dev)] = {name: proof.to_json()
                           for name, (_, proof) in proofs.items()}
    assert jsons["cuda"] == jsons["cpu"]


def test_small_rom_batch_card_proof_matches_cpu(card):
    """The combined batch AIR of `small_rom_batch` (Main and the co-SMs
    `default_include(9)` binds) proved on the card equals the CPU proof,
    which tests/test_torch_combined.py holds to the JAX package's."""
    from zkevm_prover_tpu_torch.executor import combined
    from zkevm_prover_tpu_torch.executor import examples as batches
    from zkevm_prover_tpu_torch.hashdb import Smt

    jsons = {}
    for dev in (card, "cpu"):
        db, _, batch = batches.small_rom_batch(dev)
        _, traces = combined.execute_batch(
            batch.rom, batch.n_bits, input=batch.input, smt=Smt(db),
            include=batch.include, device=dev)
        air = combined.build_batch_air(batch.rom, batch.n_bits,
                                       include=batch.include)
        prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                             device=dev)
        proof = prover.prove(air.stack_traces(traces))
        if dev == card:
            assert verify(prover.setup, prover.verkey, proof, device=dev)
        jsons[str(dev)] = proof.to_json()
    assert jsons["cuda"] == jsons["cpu"]


def _blake_inputs(h: int, device):
    """h random (state, words, counter, last) with the counter's edges and
    both flags, as int64 (u64 bit patterns) and bool tensors."""
    rng = np.random.default_rng(h + 100)
    state = rng.integers(0, 1 << 64, (h, 8), dtype=np.uint64)
    words = rng.integers(0, 1 << 64, (h, 16), dtype=np.uint64)
    counter = rng.integers(0, 1 << 64, h, dtype=np.uint64)
    counter[:3] = [0, 128, (1 << 64) - 1][:h]
    last = rng.integers(0, 2, h).astype(bool)
    last[:2] = [True, False][:h]
    return (gl.from_u64(state, device), gl.from_u64(words, device),
            gl.from_u64(counter, device), torch.as_tensor(last, device=device))


@pytest.mark.parametrize("h", HASH_SIZES)
def test_blake2b_kernel_matches_plain(card, h):
    from zkevm_prover_tpu_torch.ops import blake

    args = _blake_inputs(h, card)
    before = dict(hash_cuda.launches)
    out = blake.blake2b_compress(*args)
    assert hash_cuda.launches == {**before, "blake2b_compress":
                                  before["blake2b_compress"] + 1}
    assert out.shape == (h, 8) and out.is_contiguous()
    assert torch.equal(out, blake.blake2b_compress_plain(*args))


def test_blake2b_kernel_matches_hashlib(card):
    import hashlib

    from zkevm_prover_tpu_torch.ops import blake

    for n in (0, 1, 127, 128, 129, 1000):
        data = bytes((7 * i + 3) & 0xFF for i in range(n))
        before = hash_cuda.launches["blake2b_compress"]
        assert blake.blake2b_256(data, device=card) == hashlib.blake2b(
            data, digest_size=32).digest()
        # one compression per 128-byte block
        assert hash_cuda.launches["blake2b_compress"] - before == \
            max(1, -(-n // 128))
    rng = np.random.default_rng(9)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 129, 64)]
    assert blake.blake2b_256_many(msgs, device=card) == [
        hashlib.blake2b(m, digest_size=32).digest() for m in msgs]
    assert blake.blake2b_256_test(device=card)


def test_blake2b_kernel_rejects_what_it_does_not_take(card):
    state, words, counter, last = _blake_inputs(4, card)
    before = dict(hash_cuda.launches)
    with pytest.raises(TypeError, match="torch.bool"):
        hash_cuda.blake2b_compress(state, words, counter, last.to(torch.int64))
    with pytest.raises(ValueError, match="one card"):
        hash_cuda.blake2b_compress(state, words, counter[:3], last[:3])
    with pytest.raises(ValueError, match="CUDA tensor"):
        hash_cuda.blake2b_compress(state, words, counter.cpu(), last)
    assert hash_cuda.launches == before
    empty = [x[:0] for x in (state, words, counter, last)]
    assert hash_cuda.blake2b_compress(*empty).shape == (0, 8)
    assert hash_cuda.launches == before


def _memory_input():
    """tests/test_prover_pipeline.py's input: two memory actions."""
    from zkevm_prover_tpu_torch.prover import ProofInput, PublicInputs

    return ProofInput(
        publics=PublicInputs(batch_l2_data="0xdead"),
        actions=BatchActions(memory=[
            {"addr": 1, "step": 1, "wr": 1, "value": 5},
            {"addr": 1, "step": 2, "wr": 0, "value": 0}]))


def test_gen_batch_proof_card_matches_cpu(card, tmp_path):
    """Prover.gen_batch_proof on the card (checkpoint, resume, the request
    queue) gives the CPU proof bytes, which tests/test_torch_prover.py
    holds to the JAX package's."""
    from zkevm_prover_tpu_torch.prover import Prover, ProverRequest

    cpu = Prover(n_bits=9, device="cpu").gen_batch_proof(_memory_input())
    want = cpu.sm_proofs["memory"][1].to_json()
    prover = Prover(n_bits=9, device=card)
    path = str(tmp_path / "batch.commit")
    bp = prover.gen_batch_proof(_memory_input(), save_cm_pols=path)
    assert bp.sm_proofs["memory"][1].to_json() == want
    assert prover.verify_batch_proof(bp)
    assert bp.publics == cpu.publics
    resumed = prover.gen_batch_proof_from_commit(path)
    assert resumed.sm_proofs["memory"][1].to_json() == want
    uid = prover.submit_request(ProverRequest("genBatchProof",
                                              _memory_input()))
    assert prover.wait_for_request(uid, timeout=300).sm_proofs[
        "memory"][1].to_json() == want


def test_cli_on_card_matches_cpu(card, tmp_path):
    import json
    import pathlib
    import subprocess
    import sys

    inp = tmp_path / "input.json"
    inp.write_text(_memory_input().to_json())
    root = pathlib.Path(__file__).resolve().parent.parent
    out = {}
    for dev in ("cuda", "cpu"):
        res = subprocess.run(
            [sys.executable, "-m", "zkevm_prover_tpu_torch", "--prove",
             str(inp), "-o", str(tmp_path / dev), "--device", dev],
            cwd=root, capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr
        out[dev] = json.loads((tmp_path / dev / "batch_proof.json")
                              .read_text())
    assert out["cuda"] == out["cpu"]


def _fib_inner(device):
    """The Fibonacci AIR at 2^6 with 4 queries, proved on `device`: the
    inner proof of the JAX package's recursion tests."""
    air, trace = examples.fib_air_trace()
    setup = StarkSetup(air, n_queries=4, fri_fold_bits=2)
    prover = StarkProver(setup, device=device)
    return setup, prover, prover.prove(trace)


# sha256 of the Fibonacci proof's recursive1 wrap at 2^13 (4 queries),
# pinned from the JAX package's proof; tests/test_torch_recursive.py holds
# the port's CPU proof to the same digest (its slow tier)
R1_FIB_PIN = \
    "88481fcb3c16047377f4142e56834379635cdff6d058200594e9e49081ec378d"


def test_recursive1_card_proof_matches_jax_pin(card):
    """The Fibonacci proof's recursive1 wrap at 2^13 (the JAX recursion
    test's sizes) on the card has the JAX package's proof bytes (pinned:
    the CPU prove takes minutes), verifies on the card, and commits through
    the fused Merkle kernel."""
    import hashlib

    from zkevm_prover_tpu_torch.stark.recursive import RecursiveProver

    setup, inner, proof = _fib_inner(card)
    rp = RecursiveProver(setup, n_bits=13, n_queries=4, device=card)
    before = poseidon_cuda.launches["merkle"]
    rec = rp.prove_one(inner.verkey, proof)
    opv = rp.outer_prover
    assert poseidon_cuda.launches["merkle"] > before
    assert verify(opv.setup, opv.verkey, rec.proof, device=card)
    assert [int(v) for v in rec.proof.publics[1:5]] == \
        [int(v) for v in np.ravel(np.asarray(inner.verkey))]
    assert hashlib.sha256(rec.proof.to_json().encode()).hexdigest() == \
        R1_FIB_PIN


def test_recursive2_pair_join_on_card(card):
    """Two recursive1 wraps joined by one recursive2 proof (the JAX
    recursion test's pair, no publics chained) at 2^16: the join's circuit
    needs 58,758 rows, more than the JAX test's 2^15. The join's vk
    public is its own verkey, and a tampered join is rejected."""
    from zkevm_prover_tpu_torch.stark.proof import StarkProof
    from zkevm_prover_tpu_torch.stark.recursive import (Recursive2Prover,
                                                        RecursiveProver)
    from zkevm_prover_tpu_torch.stark.verifier import VerifyError

    setup, inner, proof = _fib_inner(card)
    rp = RecursiveProver(setup, n_bits=13, n_queries=4, device=card)
    r1a = rp.prove_one(inner.verkey, proof)
    r1b = rp.prove_one(inner.verkey, proof)
    opv = rp.outer_prover
    r2 = Recursive2Prover(opv.setup, opv.verkey, n_bits=16,
                          join_publics=lambda p1, p2: [p1[0], p2[0]],
                          chain=[], n_queries=4, device=card)
    outer = r2.prove_pair(r1a.proof, opv.verkey, r1b.proof, opv.verkey)
    o2 = r2.outer_prover
    assert verify(o2.setup, o2.verkey, outer, device=card)
    assert [int(v) for v in outer.publics[-4:]] == \
        [int(v) for v in np.ravel(np.asarray(o2.verkey))]
    bad = StarkProof.from_json(outer.to_json())
    bad.fri[0].queries[0][0].values[0] += 1
    with pytest.raises(VerifyError):
        verify(o2.setup, o2.verkey, bad, device=card)


def test_prover_recursive_chain_on_card(card):
    """`Prover.wrap_batch_recursive` and `aggregate_recursive` over two
    chained small combined batches (small_rom_batch, then the generator's
    next ROM over the state it left) on the card: both r1 nodes and the r2
    root pass `verify_recursive`, and the reversed pair raises."""
    import dataclasses

    from zkevm_prover_tpu_torch.executor import combined
    from zkevm_prover_tpu_torch.executor import examples as batches
    from zkevm_prover_tpu_torch.hashdb import Smt
    from zkevm_prover_tpu_torch.prover import Prover, PublicInputs
    from zkevm_prover_tpu_torch.prover.prover import (BatchProof,
                                                      _fea_publics_hex)

    db, tree, batch = batches.small_rom_batch(card)
    smt = Smt(db)
    bps = []
    for k in range(2):
        if k:
            tree = dataclasses.replace(tree, root=tuple(
                int(v) for v in res.new_state_root))
            batch = batches.rom_batch(9, smt, tree, 10)
        res, traces = combined.execute_batch(
            batch.rom, 9, input=batch.input, smt=smt, include=batch.include,
            device=card)
        air = combined.build_batch_air(batch.rom, 9, include=batch.include)
        sp = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device=card)
        proof = sp.prove(air.stack_traces(traces))
        pv = [int(x) for x in proof.publics]
        pub = PublicInputs(
            old_state_root=_fea_publics_hex(pv[0:8]), old_batch_num=pv[16],
            new_state_root=_fea_publics_hex(pv[19:27]),
            new_batch_num=pv[43])
        bps.append(BatchProof(publics=pub, sm_proofs={"batch": (sp, proof)},
                              counters={}))
    assert bps[0].publics.new_state_root == bps[1].publics.old_state_root
    prover = Prover(device=card)
    nodes = [prover.wrap_batch_recursive(bp, rec_bits=18) for bp in bps]
    root = prover.aggregate_recursive(nodes, rec_bits=18)
    assert root.kind == "r2"
    assert all(prover.verify_recursive(n) for n in (*nodes, root))
    assert root.publics.old_state_root == bps[0].publics.old_state_root
    assert root.publics.new_state_root == bps[1].publics.new_state_root
    with pytest.raises(ValueError, match="chain"):
        prover.aggregate_recursive(nodes[::-1], rec_bits=18)


def test_compress_proof_card_matches_cpu(card):
    """`Prover.compress_proof` (the batch's SMs re-proved under BN128
    commitments) of the memory batch on the card equals the CPU's and
    verifies."""
    from zkevm_prover_tpu_torch.prover import Prover

    jsons = {}
    for dev in ("cpu", card):
        prover = Prover(n_bits=9, device=dev)
        bp = prover.gen_batch_proof(_memory_input())
        got = prover.compress_proof(bp)
        assert prover.compress_proof(bp) is got       # cached on the proof
        (pv, proof), = got.values()
        assert proof.hash_type == "BN128" and isinstance(pv.verkey, int)
        if dev == card:
            assert verify(pv.setup, pv.verkey, proof, device=dev)
        jsons[str(dev)] = proof.to_json()
    assert jsons["cuda"] == jsons["cpu"]


def test_prove_rom_batch_on_card(card):
    """`Executor.prove_rom_batch` of small_rom_batch's ROM (Main alone,
    then each co-SM it feeds) on the card; every proof verifies, and
    Main's equals the CPU's."""
    from zkevm_prover_tpu_torch.executor import examples as batches
    from zkevm_prover_tpu_torch.hashdb import Smt

    mains = {}
    for dev in ("cpu", card):
        db, _, batch = batches.small_rom_batch(dev)
        ex = Executor(device=dev)
        if dev == "cpu":
            res = ex.run_rom(batch.rom, input=batch.input, smt=Smt(db))
            mains["cpu"] = ex.main_prover(batch.rom).prove(
                res.trace).to_json()
            continue
        res, proofs = ex.prove_rom_batch(batch.rom, input=batch.input,
                                         smt=Smt(db))
        assert "main" in proofs and ex.verify_all(proofs)
        mains["cuda"] = proofs["main"][1].to_json()
    assert mains["cuda"] == mains["cpu"]


# -- the SNARK wrap's BN254 kernels (csrc/bn254.cu) ---------------------------

def _fr(n, seed, device):
    """(n, 8) int32 scalars below r (the top limb below r's)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint64)
    x[:, 7] %= 0x30644E72
    return torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(device)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("n", [1, 3, 100, 1 << 12, 4133])
def test_bn254_fixed_base_matches_plain(card, g2, n):
    from zkevm_prover_tpu_torch.ops import bn254_cuda
    from zkevm_prover_tpu_torch.ops import bn254_device as bd

    k = _fr(n, n, card)
    k[0] = 0
    key = "g2_fixed_base" if g2 else "g1_fixed_base"
    before = bn254_cuda.launches[key]
    out = bd.fixed_base(k, g2)
    assert bn254_cuda.launches[key] == before + 1
    assert torch.equal(out, bd.fixed_base_plain(k, g2))


def _signed_digits(s, c):
    """ops/bn254_device.signed_digits of one scalar, in Python ints."""
    from zkevm_prover_tpu_torch.ops import bn254_device as bd

    out, carry = [], 0
    for w in range(bd.msm_windows(c)):
        v = ((s >> (c * w)) & ((1 << c) - 1)) + carry
        carry = int(v > 1 << (c - 1))
        out.append(v - (carry << c))
    return out


def _doubling_scalars(c, count):
    """Scalars 2 d 2^(c j) mod r whose digit j is d: at window j the
    kernel's running sum equals the table entry it adds (a doubling)."""
    from zkevm_prover_tpu_torch.ops import bn254_device as bd
    from zkevm_prover_tpu_torch.ops.bn254 import R

    out = []
    for j in range(bd.msm_windows(c) - 1, 0, -1):
        for d in range(1, (1 << (c - 1)) + 1):
            s = 2 * d * pow(2, c * j, R) % R
            if _signed_digits(s, c)[j] == d:
                out.append(s)
                if len(out) == count:
                    return out
    return out


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_bn254_fixed_base_edges_cold_and_warm(card, g2):
    """Zero, one, r - 1, k beside r - k, repeated scalars, r itself (its
    top digit cancels the rest), scalars >= r and >= 2^254 (reduced), and
    scalars whose digits double the running sum at the kernel's own window,
    against the host; a cold call (the table built inside it) == a warm
    one."""
    from zkevm_prover_tpu_torch.ops import bn254 as host
    from zkevm_prover_tpu_torch.ops import bn254_cuda
    from zkevm_prover_tpu_torch.ops import bn254_device as bd

    R = host.R
    rng = np.random.default_rng(5 + g2)
    rand = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(289)]
    k = rand[0]
    edge = [0, 1, R - 1, k, R - k, k, R, R + 5, (1 << 256) - 1,
            (1 << 254) + 3, 2 * R + 1]
    n = len(edge) + len(rand) + 8
    c = bn254_cuda.fixed_base_plan(n, g2)["c"]
    dbl = _doubling_scalars(c, 8)
    ks = edge + dbl + rand[:n - len(edge) - len(dbl)]
    scalars = torch.from_numpy(bd.ints_to_limbs(ks).copy()).to(card)
    bn254_cuda.clear_fixed_base_tables()
    cold = bd.fixed_base(scalars, g2)
    warm = bd.fixed_base(scalars, g2)
    assert torch.equal(cold, warm)
    mul = host.g2_mul_gen if g2 else host.g1_mul_gen
    assert (bd.unpack_g2 if g2 else bd.unpack_g1)(cold) == \
        [mul(v % R) for v in ks]
    assert len(dbl) > 0


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("n", [1, 17, 1 << 10, 1 << 14])
def test_bn254_msm_matches_plain(card, g2, n):
    from zkevm_prover_tpu_torch.ops import bn254_cuda
    from zkevm_prover_tpu_torch.ops import bn254_device as bd

    pts = bd.fixed_base(_fr(n, 2 * n, card), g2)
    s = _fr(n, 2 * n + 1, card)
    if n > 2:
        s[1] = 0                      # a zero scalar
        pts[2] = pts[0]               # a repeated point
    key = "g2_msm" if g2 else "g1_msm"
    before = bn254_cuda.launches[key]
    out = (bd.g2_msm if g2 else bd.g1_msm)(pts, s)
    assert bn254_cuda.launches[key] == before + 1
    assert torch.equal(out, bd.msm_plain(pts, s, g2))


def test_bn254_msm_skewed_scalars_and_edges(card):
    """A witness of bits (one bucket holds half the points, cut into
    chunks), P beside -P, infinity and scalars >= r, against the host."""
    from zkevm_prover_tpu_torch.ops import bn254 as host
    from zkevm_prover_tpu_torch.ops import bn254_device as bd
    from zkevm_prover_tpu_torch.ops import msm

    n = 1 << 17
    k = [int(v) for v in np.random.default_rng(7).integers(1, 1 << 62, n)]
    bits = [int(v) for v in np.random.default_rng(8).integers(0, 2, n)]
    pts = bd.fixed_base(bd.pack_fr(k, card), False)
    got = bd.unpack_g1(bd.g1_msm(pts, bd.pack_fr(bits, card)))[0]
    assert got == host.g1_mul_gen(sum(a * b for a, b in zip(k, bits)))
    p, q = host.g1_mul_gen(5), host.g1_mul_gen(9)
    edge = [p, host.g1_neg(p), q, q, host.INF]
    sc = [3, 3, host.R + 2, (1 << 256) - 1, 4]
    want = host.INF
    for pt, v in zip(edge, sc):
        want = host.g1_add(want, host.g1_mul(pt, v) if pt else host.INF)
    assert msm.g1_msm(edge, sc, card) == want


@pytest.mark.parametrize("logn", [0, 1, 5, 10, 11, 16, 2, 3, 4, 6, 7, 8, 9,
                                  12, 13, 21])
def test_bn254_ntt_matches_plain(card, logn):
    from zkevm_prover_tpu_torch.ops import bn254_cuda
    from zkevm_prover_tpu_torch.ops import bn254_device as bd

    x = _fr(1 << logn, logn, card)
    for kw in ({}, {"shift": 5}, {"post": 7}, {"shift": 3, "post": 11}):
        for inverse in (False, True):
            before = bn254_cuda.launches["fr_ntt"]
            out = bd.fr_ntt(x, inverse, **kw)
            assert bn254_cuda.launches["fr_ntt"] == before + 1
            assert torch.equal(out, bd.fr_ntt_plain(x, inverse, **kw))
    assert torch.equal(bd.fr_ntt(bd.fr_ntt(x), inverse=True), x)


def test_bn254_pointwise_matches_plain(card):
    from zkevm_prover_tpu_torch.ops import bn254_device as bd

    a, b, c = (_fr(1 << 12, 40 + i, card) for i in range(3))
    assert torch.equal(bd.fr_pointwise(a, b, c, 12345),
                       bd.fr_pointwise_plain(a, b, c, 12345))


def test_bn254_kernels_reject_what_they_do_not_take(card):
    from zkevm_prover_tpu_torch.ops import bn254_cuda

    before = dict(bn254_cuda.launches)
    cpu = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bn254_cuda.fixed_base(cpu, False)
    with pytest.raises(TypeError, match="int32"):
        bn254_cuda.fr_ntt(cpu.to(card).long())
    with pytest.raises(ValueError, match="power of two"):
        bn254_cuda.fr_ntt(torch.zeros((3, 8), dtype=torch.int32,
                                      device=card))
    with pytest.raises(ValueError, match="one length"):
        bn254_cuda.msm(torch.zeros((4, 2, 8), dtype=torch.int32, device=card),
                       torch.zeros((3, 8), dtype=torch.int32, device=card),
                       False)
    assert bn254_cuda.launches == before


def _final_memory_publics():
    from zkevm_prover_tpu_torch.prover import ProofInput, PublicInputs

    return ProofInput(
        publics=PublicInputs(batch_l2_data="0xdead"),
        actions=BatchActions(memory=[
            {"addr": 1, "step": 1, "wr": 1, "value": 5},
            {"addr": 1, "step": 2, "wr": 0, "value": 0}]))


def test_snark_proofs_card_match_cpu(card):
    """A seeded Groth16 proof over the digest circuit, the plonk and the
    fflonk final proofs of the memory batch: card == CPU."""
    import dataclasses

    from zkevm_prover_tpu_torch.ops.bn254 import R
    from zkevm_prover_tpu_torch.prover import Prover
    from zkevm_prover_tpu_torch.prover.prover import AggregatedProof
    from zkevm_prover_tpu_torch.snark import groth16_prove

    pub = dataclasses.replace(_final_memory_publics().publics,
                              new_state_root="0x" + "22" * 32)
    got = {}
    for dev in ("cuda", "cpu"):
        pv = Prover(n_bits=9, device=dev)
        agg = AggregatedProof(pub, [])
        d = pv.publics_digest(pub)
        inv = pow(d, R - 2, R)
        got[dev] = [groth16_prove(pv._final_circuit(), [1, d, d, inv, 1],
                                  seed=b"card")]
        for snark in ("plonk", "fflonk"):
            fp = pv.gen_final_proof(agg, snark=snark)
            assert pv.verify_final_proof(fp)
            got[dev].append(fp.groth16)
    assert got["cuda"] == got["cpu"]


def test_stark_verify_final_wrap_on_card(card):
    """The stark-verify wrap of one memory batch (2^6, 3 queries: the
    JAX package's final-proof test shape, about 764k constraints) on the
    card: every BN254 kernel family launched, verify_final_proof true."""
    import dataclasses

    from zkevm_prover_tpu_torch.ops import bn254_cuda
    from zkevm_prover_tpu_torch.prover import Prover

    pv = Prover(n_bits={"memory": 6}, n_queries=3, device=card)
    bp = pv.gen_batch_proof(_final_memory_publics())
    before = dict(bn254_cuda.launches)
    fp = pv.gen_final_proof(pv.aggregate_tree([bp]))
    assert fp.groth16["system"] == "groth16-stark"
    ran = {k: bn254_cuda.launches[k] - before[k] for k in before}
    assert all(ran.values()), ran
    assert pv.verify_final_proof(fp)
    assert not pv.verify_final_proof(dataclasses.replace(
        fp, stark_publics=[fp.stark_publics[0] + 1] + fp.stark_publics[1:]))


def test_final_proof_request_on_card(card):
    """genFinalProof through the request queue on the card (digest mode)."""
    from zkevm_prover_tpu_torch.prover import Prover, ProverRequest

    pv = Prover(n_bits=9, final_snark="digest", device=card)
    bp = pv.gen_batch_proof(_final_memory_publics())
    req = ProverRequest("genFinalProof", pv.aggregate_tree([bp]))
    pv.submit_request(req)
    fp = pv.wait_for_request(req.uuid, timeout=600)
    assert pv.verify_final_proof(fp)
    fp.publics_digest ^= 1
    assert not pv.verify_final_proof(fp)


# ---------------------------------------------------------------------------
# the STARK prover's kernels (csrc/stark.cu): the row-program interpreter
# against its twin `dag.run_plain`, the grand product against
# `calculate_z`, both on the card's tensors
# ---------------------------------------------------------------------------


def _stark_programs(prover):
    """(program, extended domain?) of each of the prover's programs."""
    out = [(prover._prog_ft[0], False), (prover._prog_num_den[0], False),
           (prover._prog_q, True), (prover._prog_fri, True),
           (prover._prog_check, False)]
    if prover._prog_aux is not None:
        out.append((prover._prog_aux, False))
    return [(p, e) for p, e in out if p.n_ops]


def _stark_inputs(setup, rows: int, seed: int, device):
    rng = np.random.default_rng(seed)
    u = lambda *shape: gl.from_u64(
        rng.integers(0, gl.P, shape, dtype=np.uint64), device)
    secs = {k: u(rows, w) for k, w in setup.section_width.items()}
    secs.update(const=u(rows, setup.air.n_constants), x=u(rows), zi=u(rows))
    ch = rng.integers(0, gl.P, (8, 3), dtype=np.uint64)
    pub = [int(v) for v in rng.integers(0, gl.P, len(setup.air.publics),
                                        dtype=np.uint64)]
    ev = rng.integers(0, gl.P, (len(setup.ev_map), 3), dtype=np.uint64)
    return secs, ch, pub, ev


def _dag_both(prog, secs, ch, pub, ev, rows, stride, device):
    """(kernel out, twin out, kernel flags, twin flags) on the card."""
    from zkevm_prover_tpu_torch.ops import stark_cuda
    from zkevm_prover_tpu_torch.stark import dag

    width = max((o.col + 3 for o in prog.outputs if o.flag is None),
                default=0)
    uni = prog.uniform_values(ch, pub, ev)
    res = []
    for run in (dag.run, dag.run_plain):
        out = torch.full((rows, width), -1, dtype=torch.int64, device=device)
        flags = torch.zeros(max(prog.n_flags, 1), dtype=torch.int32,
                            device=device)
        before = stark_cuda.launches["dag_eval"]
        run(prog, secs, uni, out, flags, rows=rows, prime_stride=stride)
        assert stark_cuda.launches["dag_eval"] == before + (run is dag.run)
        res.append((out, flags))
    torch.cuda.synchronize()
    return res[0][0], res[1][0], res[0][1], res[1][1]


@pytest.mark.parametrize("name", ["fibonacci", "lookup", "permutation",
                                  "connection"])
def test_dag_kernel_matches_plain(card, name):
    """Every program of a toy AIR's prover through dag_eval_kernel equals
    its twin on the card, on its domain and on a ragged 1,000 rows."""
    air, _ = examples.all_air_traces(6)[name]
    prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device=card)
    s = prover.setup
    for k, (prog, extended) in enumerate(_stark_programs(prover)):
        for rows, stride in (((s.n_ext, prover.blowup) if extended
                              else (s.n, 1)), (1000, 3)):
            secs, ch, pub, ev = _stark_inputs(s, rows, k, card)
            out, want, flags, want_flags = _dag_both(prog, secs, ch, pub, ev,
                                                     rows, stride, card)
            assert torch.equal(out, want), (name, k, rows)
            assert torch.equal(flags, want_flags), (name, k, rows)


def test_dag_kernel_matches_plain_on_the_small_combined_air(card):
    """The small combined AIR's (1,001 constraints) f/t, num/den and FRI
    programs, kernel == twin on the card; its check program flags every
    constraint on random sections, as the twin does."""
    from zkevm_prover_tpu_torch.executor import combined
    from zkevm_prover_tpu_torch.executor import examples as batches

    _, _, batch = batches.small_rom_batch("cpu")
    air = combined.build_batch_air(batch.rom, batch.n_bits,
                                   include=batch.include)
    prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device=card)
    s = prover.setup
    for k, (prog, extended) in enumerate(
            [(prover._prog_ft[0], False), (prover._prog_num_den[0], False),
             (prover._prog_fri, True), (prover._prog_check, False)]):
        rows, stride = (s.n_ext, prover.blowup) if extended else (s.n, 1)
        secs, ch, pub, ev = _stark_inputs(s, rows, 10 + k, card)
        out, want, flags, want_flags = _dag_both(prog, secs, ch, pub, ev,
                                                 rows, stride, card)
        assert torch.equal(out, want) and torch.equal(flags, want_flags), k


def _gp_operands(n, num_dim, den_dim, seed, device):
    rng = np.random.default_rng(seed)
    shape = lambda d: (n,) if d == 1 else (n, 3)
    return (gl.from_u64(rng.integers(0, gl.P, shape(num_dim),
                                     dtype=np.uint64), device),
            gl.from_u64(rng.integers(1, gl.P, shape(den_dim),
                                     dtype=np.uint64), device))


# rows of one grand-product tile (a block): sizes that cross the tiles and
# the look-back's windows of GP_LOOK * GP_LANES tiles
GP_TILE = stark_cuda.GP_LANES * stark_cuda.GP_RUN
GP_SIZES = [GP_TILE - 1, GP_TILE, GP_TILE + 1, 3 * GP_TILE + 37,
            300 * GP_TILE + 37, (1 << 20) + 37]


@pytest.mark.parametrize("n", list(dict.fromkeys(
    [1, 2, 1000, 1024, 1025, (1 << 14) + 37] + GP_SIZES)))
@pytest.mark.parametrize("num_dim,den_dim", [(1, 1), (3, 3), (1, 3), (3, 1)])
def test_grand_product_kernel_matches_calculate_z(card, n, num_dim, den_dim):
    from zkevm_prover_tpu_torch.ops import stark_cuda
    from zkevm_prover_tpu_torch.stark import prover as sp

    num, den = _gp_operands(n, num_dim, den_dim, n + num_dim + 3 * den_dim,
                            card)
    z = torch.full((n, 3), -1, dtype=torch.int64, device=card)
    before = stark_cuda.launches["grand_product"]
    sp.grand_products([(num, den, z)])
    assert stark_cuda.launches["grand_product"] == before + 1
    assert torch.equal(z, sp.calculate_z(num, den))


@pytest.mark.parametrize("den_dim", [1, 3])
def test_grand_product_kernel_zero_den_and_batches(card, den_dim):
    """A zero den gives z = (1, 0, 0, ...) as calculate_z's batch
    inversion does; several arguments in one launch, z into strided views
    of one section, each equal to calculate_z."""
    from zkevm_prover_tpu_torch.stark import prover as sp

    n = (1 << 12) + 5
    args = [_gp_operands(n, 3, den_dim, 70 + k, card) for k in range(4)]
    args[2][1][n - 1] = 0
    args[3][1][0] = 0
    sec = torch.full((n, 15), -1, dtype=torch.int64, device=card)
    sp.grand_products([(num, den, sec[:, 3 * k:3 * k + 3])
                       for k, (num, den) in enumerate(args)])
    for k, (num, den) in enumerate(args):
        assert torch.equal(sec[:, 3 * k:3 * k + 3], sp.calculate_z(num, den))
    for k in (2, 3):
        assert sec[0, 3 * k:3 * k + 3].tolist() == [1, 0, 0]
        assert not bool(sec[1:, 3 * k:3 * k + 3].any())
    assert bool((sec[:, 12:] == -1).all())


@pytest.mark.parametrize("den_dim", [1, 3])
@pytest.mark.parametrize("where", ["first", "last", "later_tile"])
def test_grand_product_kernel_zero_den_positions(card, den_dim, where):
    """A zero den in row 0, in the last row or in a tile after the first
    gives z = (1, 0, 0, ...) over every row, the rows of the tiles before
    it too; the arguments beside it in the launch are untouched."""
    from zkevm_prover_tpu_torch.stark import prover as sp

    n = 5 * GP_TILE + 3
    row = {"first": 0, "last": n - 1, "later_tile": 3 * GP_TILE + 7}[where]
    args = [_gp_operands(n, 3, den_dim, 90 + k, card) for k in range(2)]
    args[0][1][row] = 0
    zs = [torch.full((n, 3), -1, dtype=torch.int64, device=card)
          for _ in args]
    sp.grand_products([(num, den, z) for (num, den), z in zip(args, zs)])
    want = torch.zeros((n, 3), dtype=torch.int64, device=card)
    want[0, 0] = 1
    assert torch.equal(zs[0], want)
    assert torch.equal(zs[0], sp.calculate_z(*args[0]))
    assert torch.equal(zs[1], sp.calculate_z(*args[1]))


def test_grand_product_kernel_mixed_dims_one_launch(card):
    """All four (num dim, den dim) pairs in one launch, each equal to
    calculate_z."""
    from zkevm_prover_tpu_torch.stark import prover as sp

    n = 7 * GP_TILE + 11
    dims = [(1, 1), (3, 3), (1, 3), (3, 1)] * 2
    args = [_gp_operands(n, d, e, 110 + k, card)
            for k, (d, e) in enumerate(dims)]
    before = stark_cuda.launches["grand_product"]
    zs = [torch.full((n, 3), -1, dtype=torch.int64, device=card)
          for _ in args]
    sp.grand_products([(num, den, z) for (num, den), z in zip(args, zs)])
    assert stark_cuda.launches["grand_product"] == before + 1
    for (num, den), z in zip(args, zs):
        assert torch.equal(z, sp.calculate_z(num, den))


def test_grand_product_kernel_section_views_back_to_back(card):
    """_phase3's layout: 68 arguments (more than one launch's 64) as
    column views of one num/den section, z into views of another; two calls
    back to back on other data, each equal to calculate_z (the look-back
    scratch is reused: its counters and epoch must be ready again)."""
    from zkevm_prover_tpu_torch.stark import prover as sp

    n, k_args = 9 * GP_TILE + 5, 68
    rng = np.random.default_rng(7)
    for turn in range(2):
        nd = gl.from_u64(rng.integers(1, gl.P, (n, 6 * k_args),
                                      dtype=np.uint64), card)
        cm3 = torch.full((n, 3 * k_args + 2), -1, dtype=torch.int64,
                         device=card)
        args = [(nd[:, 6 * k:6 * k + 3], nd[:, 6 * k + 3:6 * k + 6],
                 cm3[:, 3 * k:3 * k + 3]) for k in range(k_args)]
        sp.grand_products(args)
        for num, den, z in args:
            assert torch.equal(z, sp.calculate_z(num, den)), turn
        assert bool((cm3[:, -2:] == -1).all())


def test_stark_kernels_reject_what_they_do_not_take(card):
    from zkevm_prover_tpu_torch.ops import stark_cuda

    air, _ = examples.all_air_traces(6)["lookup"]
    prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device=card)
    s = prover.setup
    prog = prover._prog_check
    secs, ch, pub, ev = _stark_inputs(s, s.n, 1, card)
    uni = prog.uniform_values(ch, pub, ev)
    args = [secs[k] for k in prog.sections]
    out = torch.zeros((s.n, 0), dtype=torch.int64, device=card)
    flags = torch.zeros(prog.n_flags, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):      # a section on the CPU
        stark_cuda.dag_eval(prog, [a.cpu() for a in args], uni, out, flags,
                            rows=s.n, prime_stride=1)
    with pytest.raises(ValueError):      # a section of other rows
        stark_cuda.dag_eval(prog, [a[:-1] for a in args], uni, out, flags,
                            rows=s.n, prime_stride=1)
    with pytest.raises(ValueError):      # no flags for a flag program
        stark_cuda.dag_eval(prog, args, uni, out, None, rows=s.n,
                            prime_stride=1)
    with pytest.raises(ValueError):      # a short uniform table
        stark_cuda.dag_eval(prog, args, uni[:-1], out, flags, rows=s.n,
                            prime_stride=1)
    with pytest.raises(TypeError):       # int32 sections
        stark_cuda.dag_eval(prog, [a.int() for a in args], uni, out, flags,
                            rows=s.n, prime_stride=1)
    num, den = _gp_operands(64, 3, 3, 1, card)
    z = torch.zeros((64, 3), dtype=torch.int64, device=card)
    with pytest.raises(ValueError):      # z of two columns
        stark_cuda.grand_product([(num, den, z[:, :2])])
    with pytest.raises(ValueError):      # den of other rows
        stark_cuda.grand_product([(num, den[:-1], z)])
    with pytest.raises(ValueError):      # num on the CPU
        stark_cuda.grand_product([(num.cpu(), den, z)])
    with pytest.raises(ValueError):
        stark_cuda.grand_product([])


# dag_eval_kernel's forms: slot files of 2, 9 and 32 slots, ragged rows
# with next-row reads wrapping past the last rows, sections given as
# strided views, flags, the FRI program's 1,834 uniform entries, more tiles
# than the persistent grid has blocks, and a block past the card's shared
# memory (the wrapper raises).


def _slot_outputs(setup, k: int):
    """Two Horner chains over k shared products of committed columns, the
    second in reverse order, so that all k stay live between them."""
    from zkevm_prover_tpu_torch.stark import dag
    from zkevm_prover_tpu_torch.stark import expr as ex

    w = setup.section_width[1]
    cm = [ex.Cm(i) for i in range(w)]
    shared = [cm[j % w] * cm[(j + 1) % w] + j for j in range(k)]
    up, down = shared[0], shared[-1]
    for t in shared[1:]:
        up = up * ex.Challenge(4) + t
    for t in shared[-2::-1]:
        down = down * ex.Challenge(3) + t
    return [dag.Output(up, col=0, ext=True), dag.Output(down, col=3, ext=True)]


def _slot_program(prover, slots: int):
    """A program of exactly `slots` slots, uncut: the first chain alone or
    both."""
    from zkevm_prover_tpu_torch.stark import dag

    for k in range(1, 40):
        outs = _slot_outputs(prover.setup, k)
        for o in (outs[:1], outs):
            prog = dag.compile_program(o, prover._leaf, max_slots=slots)
            if prog.n_slots == slots and prog.chunk is None:
                return prog
    raise AssertionError(f"no program of {slots} slots")


@pytest.mark.parametrize("slots", [2, 9, 32])
def test_dag_kernel_slot_counts(card, slots):
    air, _ = examples.all_air_traces(6)["permutation"]
    prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device=card)
    prog = _slot_program(prover, slots)
    for rows, stride in ((1 << 12, 1), ((1 << 12) + 37, 5)):
        secs, ch, pub, ev = _stark_inputs(prover.setup, rows, slots, card)
        out, want, _, _ = _dag_both(prog, secs, ch, pub, ev, rows, stride,
                                    card)
        assert torch.equal(out, want), (slots, rows)


def _small_combined(card):
    from zkevm_prover_tpu_torch.executor import combined
    from zkevm_prover_tpu_torch.executor import examples as batches

    _, _, batch = batches.small_rom_batch("cpu")
    air = combined.build_batch_air(batch.rom, batch.n_bits,
                                   include=batch.include)
    return StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                       device=card)


def test_dag_kernel_ragged_strided_views_and_wrap(card):
    """The small combined AIR's C * Zi at 2^12 + 37 rows with next-row
    reads at a stride of 8 (the last 8 rows wrap to the first), over
    sections that are column slices of wider tensors (row stride above
    the width): kernel == twin, and == the kernel on contiguous copies.
    Also the FRI program, whose uniform table has 1,834 entries."""
    prover = _small_combined(card)
    s = prover.setup
    rows = (1 << 12) + 37
    secs, ch, pub, ev = _stark_inputs(s, rows, 41, card)
    views = {}
    for k, v in secs.items():
        wide = torch.full((rows, (v.shape[1] if v.ndim == 2 else 1) + 7), -1,
                          dtype=torch.int64, device=card)
        if v.ndim == 2:
            wide[:, 3:3 + v.shape[1]] = v
            views[k] = wide[:, 3:3 + v.shape[1]]
        else:
            wide[:, 3] = v
            views[k] = wide[:, 3]
        assert views[k].stride(0) > (v.shape[1] if v.ndim == 2 else 1)
    prog = prover._prog_q
    out, want, _, _ = _dag_both(prog, views, ch, pub, ev, rows, 8, card)
    plain, _, _, _ = _dag_both(prog, secs, ch, pub, ev, rows, 8, card)
    assert torch.equal(out, want) and torch.equal(out, plain)
    fri = prover._prog_fri
    assert len(fri.uniform_roots) == 1834
    out, want, _, _ = _dag_both(fri, views, ch, pub, ev, rows, 8, card)
    assert torch.equal(out, want)


def test_dag_kernel_flags_at_the_last_row(card):
    """A flag program: a flag that is zero everywhere stays down, one that
    is not zero on the last row only (a ragged tile's last live thread) is
    raised, and so is one not zero on every row."""
    from zkevm_prover_tpu_torch.stark import dag
    from zkevm_prover_tpu_torch.stark import expr as ex

    air, _ = examples.all_air_traces(6)["lookup"]
    prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device=card)
    s = prover.setup
    rows = (1 << 10) + 37
    secs, ch, pub, ev = _stark_inputs(s, rows, 7, card)
    secs[1][:, 0] = 0
    secs[1][-1, 0] = 5
    a, b = ex.Cm(0), ex.Cm(1)
    prog = dag.compile_program(
        [dag.Output(b - b, flag=0), dag.Output(a * ex.Challenge(1), flag=1),
         dag.Output(b * b + 1, flag=2), dag.Output(a - a, flag=3)],
        prover._leaf)
    out, want, flags, want_flags = _dag_both(prog, secs, ch, pub, ev, rows,
                                             1, card)
    assert torch.equal(flags, want_flags)
    assert flags.tolist() == [0, 1, 1, 0]
    secs[1][-1, 0] = 0
    _, _, flags, _ = _dag_both(prog, secs, ch, pub, ev, rows, 1, card)
    assert flags.tolist() == [0, 0, 1, 0]


def test_dag_kernel_more_tiles_than_blocks(card):
    """Rows for twice the persistent grid's tiles and 37 more: each block
    takes several tiles through its one scratch region."""
    from zkevm_prover_tpu_torch.ops import stark_cuda

    air, _ = examples.all_air_traces(6)["permutation"]
    prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device=card)
    prog = prover._prog_num_den[0]
    grid = stark_cuda.dag_plan(prog, 1 << 30)["grid"]
    rows = 2 * grid * stark_cuda.DAG_ROWS + 37
    assert stark_cuda.dag_plan(prog, rows)["grid"] == grid
    secs, ch, pub, ev = _stark_inputs(prover.setup, rows, 9, card)
    out, want, _, _ = _dag_both(prog, secs, ch, pub, ev, rows, 1, card)
    assert torch.equal(out, want)


def test_dag_kernel_32_slots_and_a_wide_uniform_table(card):
    """32 slots beside 1,400 uniform entries: the slot file takes a
    block's largest shared memory and the table, read from device memory,
    has no size limit; the kernel equals the twin bit for bit."""
    from zkevm_prover_tpu_torch.ops import stark_cuda
    from zkevm_prover_tpu_torch.stark import dag
    from zkevm_prover_tpu_torch.stark import expr as ex

    air, _ = examples.all_air_traces(6)["permutation"]
    prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device=card)
    s = prover.setup
    wide = ex.Cm(0) * ex.Number(2)
    for j in range(3, 1403):
        wide = wide + ex.Cm(0) * ex.Number(j)
    outs = _slot_outputs(s, 30) + [dag.Output(wide, col=6, ext=True)]
    prog = dag.compile_program(outs, prover._leaf)
    assert prog.n_slots == 32 and len(prog.uniform_roots) > 1400
    assert stark_cuda.dag_plan(prog, s.n)["smem"] == 8 * (96 + 2) * 256
    rows = s.n + 37
    secs, ch, pub, ev = _stark_inputs(s, rows, 2, card)
    out, want, _, _ = _dag_both(prog, secs, ch, pub, ev, rows, 1, card)
    assert torch.equal(out, want)
