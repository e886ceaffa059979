"""The port's aggregation (`Prover.gen_aggregated_proof`, `aggregate_tree`,
`verify_aggregated_proof`, the genAggregatedProof request) against the JAX
package's: twins of tests/test_prover_pipeline.py :66 and of the
aggregation halves of :48 and :103, up to `verify_aggregated_proof`, on
the JAX pipeline test's memory batch at 2^9, proved on the CPU. The JAX
side joins batch proofs that carry the port's publics (its chaining checks
read publics only), so no JAX prover is compiled here.
"""

import dataclasses
import functools

import pytest
import torch

from zkevm_prover_tpu.prover import Prover as JProver
from zkevm_prover_tpu.prover import PublicInputs as JPublics
from zkevm_prover_tpu.prover.prover import BatchProof as JBatchProof
from zkevm_prover_tpu_torch.executor import BatchActions
from zkevm_prover_tpu_torch.prover import (ProofInput, Prover,
                                           ProverRequest, PublicInputs)
from zkevm_prover_tpu_torch.prover.prover import (RECURSIVE2_CHAIN,
                                                  AggregatedProof,
                                                  BatchProof,
                                                  _recursive2_join)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU proves run on one thread beside the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _prover():
    return Prover(n_bits=9, device="cpu")


def _input(old_root="0x" + "00" * 32, old_acc="0x" + "00" * 32, num=0):
    pub = PublicInputs(old_state_root=old_root, old_acc_input_hash=old_acc,
                       old_batch_num=num, batch_l2_data="0xdead")
    actions = BatchActions(
        memory=[{"addr": 1, "step": 1, "wr": 1, "value": 5},
                {"addr": 1, "step": 2, "wr": 0, "value": 0}])
    return ProofInput(publics=pub, actions=actions)


@functools.lru_cache(maxsize=None)
def _chain(n: int) -> tuple:
    """n batch proofs of the memory batch, each chained on the one before
    (made once, at n = 4, for every test)."""
    bps = []
    root = acc = "0x" + "00" * 32
    for i in range(n):
        bp = _prover().gen_batch_proof(_input(old_root=root, old_acc=acc,
                                              num=i))
        root, acc = bp.publics.new_state_root, bp.publics.new_acc_input_hash
        bps.append(bp)
    return tuple(bps)


def _jax_twin(p):
    """The JAX package's proof tree with `p`'s publics and no proofs."""
    if isinstance(p, BatchProof):
        return JBatchProof(publics=JPublics(**dataclasses.asdict(p.publics)),
                           sm_proofs={}, counters={})
    return [_jax_twin(c) for c in p.children]


@functools.lru_cache(maxsize=None)
def _jax_prover():
    return JProver(n_bits=9, final_snark="digest")


def test_full_pipeline_batch_agg():
    prover = _prover()
    bp1, bp2 = _chain(4)[:2]
    assert prover.verify_batch_proof(bp1)
    agg = prover.gen_aggregated_proof(bp1, bp2)
    assert isinstance(agg, AggregatedProof) and agg.children == [bp1, bp2]
    assert agg.publics.old_batch_num == 0 and agg.publics.new_batch_num == 2
    assert prover.verify_aggregated_proof(agg)
    jagg = _jax_prover().gen_aggregated_proof(_jax_twin(bp1), _jax_twin(bp2))
    assert dataclasses.asdict(agg.publics) == dataclasses.asdict(jagg.publics)


def test_aggregation_rejects_broken_chain():
    prover = _prover()
    bp1 = _chain(4)[0]
    # batch numbers skip (and the acc input hash breaks first, as in the
    # JAX test): the publics `process_batch` gives, and a proved batch
    res = prover.process_batch(_input(num=7))
    skip = BatchProof(publics=res["publics"], sm_proofs={},
                      counters=res["counters"])
    for bp_wrong in (skip, _chain(4)[2]):
        with pytest.raises(ValueError, match="chain") as got:
            prover.gen_aggregated_proof(bp1, bp_wrong)
        with pytest.raises(ValueError) as want:
            _jax_prover().gen_aggregated_proof(_jax_twin(bp1),
                                               _jax_twin(bp_wrong))
        assert str(got.value) == str(want.value)
    # each chaining check, with the JAX package's message
    for field, value in (("new_state_root", "0x" + "11" * 32),
                         ("new_acc_input_hash", "0x" + "22" * 32),
                         ("chain_id", 7), ("fork_id", 3)):
        a = dataclasses.replace(_chain(4)[0])
        a.publics = dataclasses.replace(a.publics, **{field: value})
        b = _chain(4)[1]
        with pytest.raises(ValueError) as got:
            prover.gen_aggregated_proof(a, b)
        with pytest.raises(ValueError) as want:
            _jax_prover().gen_aggregated_proof(_jax_twin(a), _jax_twin(b))
        assert str(got.value) == str(want.value)


def test_aggregate_tree_four_batches():
    prover = _prover()
    bps = list(_chain(4))
    agg = prover.aggregate_tree(bps)
    assert agg.publics.old_batch_num == 0
    assert agg.publics.new_batch_num == 4
    assert prover.verify_aggregated_proof(agg)
    jagg = _jax_prover().aggregate_tree([_jax_twin(bp) for bp in bps])
    assert dataclasses.asdict(agg.publics) == dataclasses.asdict(jagg.publics)
    # an odd count carries the last proof up a level, as the JAX package
    agg3 = prover.aggregate_tree(bps[:3])
    assert agg3.children[1] is bps[2]
    assert agg3.publics.new_batch_num == 3
    assert prover.aggregate_tree(bps[:1]) is bps[0]


def test_aggregated_request_through_the_queue():
    prover = _prover()
    bp1, bp2 = _chain(4)[:2]
    uid = prover.submit_request(ProverRequest("genAggregatedProof",
                                              (bp1, bp2)))
    agg = prover.wait_for_request(uid, timeout=60)
    assert agg.publics == prover.gen_aggregated_proof(bp1, bp2).publics
    bad = ProverRequest("genAggregatedProof", (bp2, bp1))
    prover.submit_request(bad)
    with pytest.raises(RuntimeError, match="ValueError: aggregation"):
        prover.wait_for_request(bad.uuid, timeout=60)


def test_recursive2_chain_layout():
    """The in-circuit chaining of recursive2 follows the publics layout of
    prover.cpp:494-560, as in the JAX package."""
    from zkevm_prover_tpu.prover import prover as jpm

    assert RECURSIVE2_CHAIN == jpm.RECURSIVE2_CHAIN
    p1, p2 = list(range(48)), list(range(100, 148))
    assert _recursive2_join(p1, p2) == jpm._recursive2_join(p1, p2)
