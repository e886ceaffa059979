"""Tests of the port that need an NVIDIA card (marker `cuda`; they skip
where CUDA is absent). The file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Each mode's kernel is held bit for bit against the plain torch permutation,
the fused Merkle commit against the chunked plain tree, and proofs made on
the card against the port's CPU proofs (which the other test_torch_* files
hold against the JAX package)."""

import numpy as np
import pytest
import torch

from zkevm_prover_tpu_torch.executor import BatchActions, Executor
from zkevm_prover_tpu_torch.ops import goldilocks as gl
from zkevm_prover_tpu_torch.ops import merkle
from zkevm_prover_tpu_torch.ops import poseidon_constants as pc
from zkevm_prover_tpu_torch.ops import poseidon_cuda
from zkevm_prover_tpu_torch.ops import poseidon_gl as pos
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
