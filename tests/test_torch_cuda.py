"""Tests of the port that need an NVIDIA card (marker `cuda`; they skip
where CUDA is absent). The file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Each mode's kernel is held bit for bit against the plain torch permutation,
and proofs made on the card against the port's CPU proofs (which the other
test_torch_* files hold against the JAX package)."""

import numpy as np
import pytest
import torch

from zkevm_prover_tpu_torch.executor import BatchActions, Executor
from zkevm_prover_tpu_torch.ops import goldilocks as gl
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


@pytest.mark.parametrize("mode", poseidon_cuda.MODES)
@pytest.mark.parametrize("h", [517, 1 << 16])
def test_mode_kernel_matches_plain(card, mode, h):
    rng = np.random.default_rng(h)
    states = rng.integers(0, gl.P, (h, 12), dtype=np.uint64)
    states[-2:] = [np.zeros(12, np.uint64), np.full(12, gl.P - 1, np.uint64)]
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
