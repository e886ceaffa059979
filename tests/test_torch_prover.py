"""The port's batch-proof entry point (`zkevm_prover_tpu_torch/prover/`,
`__main__.py`) against the JAX package's `prover/` and CLI: the twins of
tests/test_prover_pipeline.py (the batch part) and tests/test_checkpoint.py.

`ProofInput` JSON text, the accInputHash recurrence, `process_batch`'s
counters and publics and checkpoint files equal the JAX package's; each
package reads the other's JSON and checkpoints. `gen_batch_proof`,
`gen_batch_proof_from_commit`, the request queue and the CLI prove the
JAX pipeline test's memory batch at 2^9 on the CPU, and each proof's JSON
hashes to a digest pinned from the JAX package's proof of the same batch
(the slow tests recompute the JAX side). The ROM path is tested over the
small combined batch in tests/test_torch_combined_small.py.

    ZK_SLOW=1 python -m pytest -q -m slow tests/test_torch_prover.py
"""

import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch

from zkevm_prover_tpu.executor import BatchActions as JActions
from zkevm_prover_tpu.prover import ProofInput as JInput
from zkevm_prover_tpu.prover import Prover as JProver
from zkevm_prover_tpu.prover import PublicInputs as JPublics
from zkevm_prover_tpu.prover import checkpoint as jcheckpoint
from zkevm_prover_tpu.prover.input import L1Data as JL1Data
from zkevm_prover_tpu_torch import __main__ as cli
from zkevm_prover_tpu_torch.executor import BatchActions
from zkevm_prover_tpu_torch.prover import (ProofInput, Prover,
                                           ProverRequest, PublicInputs,
                                           checkpoint)
from zkevm_prover_tpu_torch.prover.input import L1Data
from zkevm_prover_tpu_torch.prover.prover import AggregatedProof
from zkevm_prover_tpu_torch.stark.proof import StarkProof
from zkevm_prover_tpu_torch.stark.verifier import VerifyError

# sha256 of the memory SM's proof JSON of the JAX pipeline test's batch
# (two memory actions) at 2^9, from the JAX package's
# Prover(n_bits=9).gen_batch_proof (the slow test recomputes it)
MEMORY_PIN = \
    "9d49f0c7a69ed8d75d2630d35a06ae2a5831ff1eaf0507580f9ef2719297948e"

MEMORY = [{"addr": 1, "step": 1, "wr": 1, "value": 5},
          {"addr": 1, "step": 2, "wr": 0, "value": 0}]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's intra-op pool slows down by orders of magnitude beside the
    other test workers: the port's CPU proves run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _input(port: bool = True, old_root="0x" + "00" * 32,
           old_acc="0x" + "00" * 32, num=0):
    """tests/test_prover_pipeline.py's input: two memory actions."""
    pub = (PublicInputs if port else JPublics)(
        old_state_root=old_root, old_acc_input_hash=old_acc,
        old_batch_num=num, batch_l2_data="0xdead")
    acts = (BatchActions if port else JActions)(memory=list(MEMORY))
    return (ProofInput if port else JInput)(publics=pub, actions=acts)


def _full_input(port: bool):
    """An input with every field `to_json` writes: publics, the three
    action lists, db, bytecode, an l1InfoTree entry and the skip flag."""
    pub = (PublicInputs if port else JPublics)(
        old_state_root="0x" + "12" * 32, old_acc_input_hash="0x" + "34" * 32,
        old_batch_num=41, chain_id=1101, fork_id=9,
        batch_l2_data="0x0b0000000100000000", l1_info_root="0x" + "56" * 32,
        timestamp_limit=1700000000, sequencer_addr="0x" + "ab" * 20)
    acts = (BatchActions if port else JActions)(
        binary=[{"op": "add", "a": 1, "b": 2}], memory=list(MEMORY),
        arith=[{"x1": 3, "y1": 4, "x2": 5}])
    l1 = (L1Data if port else JL1Data)(
        global_exit_root=7, block_hash_l1=8, min_timestamp=9,
        smt_proof=[10, 11])
    return (ProofInput if port else JInput)(
        publics=pub, actions=acts, db={"0x05": ["0x1"] * 12},
        contracts_bytecode={"0x06": "0x6001"}, l1_info_tree={3: l1},
        skip_verify_l1_info_root=True)


def _digest(proof) -> str:
    return hashlib.sha256(proof.to_json().encode()).hexdigest()


@pytest.fixture(scope="module")
def prover():
    return Prover(n_bits=9, device="cpu")


@pytest.fixture(scope="module")
def batch(prover, tmp_path_factory):
    """One gen_batch_proof of the memory batch, checkpointed on the way."""
    path = str(tmp_path_factory.mktemp("cm") / "batch.commit")
    return prover.gen_batch_proof(_input(), save_cm_pols=path), path


# -- input ------------------------------------------------------------------


def test_input_json_text_matches_jax():
    text = _full_input(True).to_json()
    assert text == _full_input(False).to_json()
    # each package reads the other's text back to the same input
    mine, theirs = ProofInput.from_json(text), JInput.from_json(text)
    assert mine.to_json() == theirs.to_json() == text
    assert dataclasses.asdict(mine.publics) == \
        dataclasses.asdict(theirs.publics)
    assert mine.executor_input() == theirs.executor_input()
    again = ProofInput.from_json(_input().to_json())
    assert again.publics == _input().publics
    assert again.actions.memory == MEMORY


@pytest.mark.parametrize("fork_id", (6, 9))
def test_acc_input_hash_matches_jax(fork_id):
    kw = dict(old_acc_input_hash="0x" + "9a" * 32, fork_id=fork_id,
              batch_l2_data="0x" + "ee" * 70, l1_info_root="0x" + "01" * 32,
              timestamp_limit=1234, sequencer_addr="0x" + "cd" * 20,
              forced_blockhash_l1="0x" + "02" * 32,
              global_exit_root="0x" + "03" * 32, timestamp=99)
    assert PublicInputs(**kw).acc_input_hash() == \
        JPublics(**kw).acc_input_hash()


# -- the action-list path ---------------------------------------------------


def test_process_batch_matches_jax(prover):
    res = prover.process_batch(_input())
    jres = JProver(n_bits=9).process_batch(_input(port=False))
    assert dataclasses.asdict(res["publics"]) == \
        dataclasses.asdict(jres["publics"])
    assert res["publics"].new_batch_num == 1
    # the JAX package's counters, key by key (the port adds the padding
    # SMs' four)
    assert {k: res["counters"][k] for k in jres["counters"]} == \
        jres["counters"]
    assert res["counters"]["memory"] == 2


def test_gen_batch_proof_matches_pin(batch):
    bp, _ = batch
    assert list(bp.sm_proofs) == ["memory"]
    assert _digest(bp.sm_proofs["memory"][1]) == MEMORY_PIN
    assert bp.publics.new_batch_num == 1
    assert bp.publics.new_acc_input_hash == _input().publics.acc_input_hash()
    assert bp.publics.new_state_root == bp.publics.old_state_root


def test_verify_batch_proof_accepts_and_rejects_tampered(prover, batch):
    bp, _ = batch
    assert prover.verify_batch_proof(bp)
    prv, proof = bp.sm_proofs["memory"]
    bad = StarkProof.from_json(proof.to_json())
    bad.fri[0].queries[0][0].values[0] += 1
    with pytest.raises(VerifyError):
        prover.verify_batch_proof(dataclasses.replace(
            bp, sm_proofs={"memory": (prv, bad)}))


def test_request_queue(prover, batch):
    req = ProverRequest("processBatch", _input())
    uid = prover.submit_request(req)
    assert prover.wait_for_request(uid, timeout=60)[
        "publics"].new_batch_num == 1
    uid = prover.submit_request(ProverRequest("genBatchProof", _input()))
    bp = prover.wait_for_request(uid, timeout=300)
    assert bp.sm_proofs["memory"][1].to_json() == \
        batch[0].sm_proofs["memory"][1].to_json()
    assert prover.metrics.snapshot()["PROVER_GENBATCHPROOF"]["count"] == 1

    bad = ProverRequest("nonsense", None)
    prover.submit_request(bad)
    with pytest.raises(RuntimeError, match="unknown request type"):
        prover.wait_for_request(bad.uuid, timeout=30)
    with pytest.raises(KeyError, match="unknown request"):
        prover.wait_for_request("no-such-uuid", timeout=1)


def test_final_proof_request_served():
    """genFinalProof through the request queue: the digest wrap of two
    chained publics, its Groth16 proof verified and a tampered digest
    rejected."""
    a = PublicInputs(old_state_root="0x" + "11" * 32,
                     new_state_root="0x" + "22" * 32,
                     new_acc_input_hash="0x" + "33" * 32,
                     old_batch_num=7, new_batch_num=8, chain_id=1000)
    b = dataclasses.replace(a, old_state_root=a.new_state_root,
                            new_state_root="0x" + "44" * 32,
                            old_acc_input_hash=a.new_acc_input_hash,
                            new_acc_input_hash="0x" + "55" * 32,
                            old_batch_num=8, new_batch_num=9)
    prover = Prover(n_bits=9, final_snark="digest", device="cpu")
    agg = prover.gen_aggregated_proof(AggregatedProof(a, []),
                                      AggregatedProof(b, []))
    req = ProverRequest("genFinalProof", agg)
    prover.submit_request(req)
    fp = prover.wait_for_request(req.uuid, timeout=300)
    assert fp.publics_digest == prover.publics_digest(agg.publics)
    assert prover.verify_final_proof(fp)
    fp.publics_digest ^= 1
    assert not prover.verify_final_proof(fp)
    assert prover.metrics.snapshot()["PROVER_GENFINALPROOF"]["count"] == 1


def test_prover_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Prover()


# -- checkpoints --------------------------------------------------------------


def _traces():
    rng = np.random.default_rng(80)
    return {"memory": rng.integers(0, 1 << 64, (4, 8), dtype=np.uint64),
            "binary": np.ones((8, 3), dtype=np.uint64)}


def test_checkpoint_bytes_match_jax(tmp_path):
    traces = _traces()
    kw = dict(publics={"chain_id": 7}, meta={"counters": {"memory": 2}})
    jcheckpoint.save_commit_pols(str(tmp_path / "jax"), traces, **kw)
    checkpoint.save_commit_pols(str(tmp_path / "np"), traces, **kw)
    # the port's traces as int64 tensors: the same bytes
    checkpoint.save_commit_pols(
        str(tmp_path / "torch"),
        {k: torch.as_tensor(v.view(np.int64)) for k, v in traces.items()},
        **kw)
    want = (tmp_path / "jax").read_bytes()
    assert (tmp_path / "np").read_bytes() == want
    assert (tmp_path / "torch").read_bytes() == want


@pytest.mark.parametrize("mmap", (True, False))
def test_checkpoint_each_loads_the_others(tmp_path, mmap):
    traces = _traces()
    jcheckpoint.save_commit_pols(str(tmp_path / "jax"), traces,
                                 publics={"chain_id": 7})
    checkpoint.save_commit_pols(str(tmp_path / "port"), traces,
                                meta={"counters": {"memory": 2}})
    for load, path in ((checkpoint.load_commit_pols, "jax"),
                       (jcheckpoint.load_commit_pols, "port")):
        loaded, hdr = load(str(tmp_path / path), mmap=mmap)
        assert sorted(loaded) == ["binary", "memory"]
        for k in traces:
            np.testing.assert_array_equal(np.asarray(loaded[k]), traces[k])
        assert isinstance(loaded["memory"], np.memmap) == mmap
    assert checkpoint.load_commit_pols(str(tmp_path / "jax"))[1][
        "publics"] == {"chain_id": 7}


def _truncated(tmp_path, save):
    path = str(tmp_path / "bad.commit")
    save(path, {"memory": np.zeros((64, 8), dtype=np.uint64)})
    with open(path, "r+b") as f:
        f.truncate(4096 + 64)  # cut into the section
    return path


def _junk(tmp_path, save):
    path = str(tmp_path / "junk")
    with open(path, "wb") as f:
        f.write(b"{}" + b"\x00" * 4094)
    return path


def _other_version(tmp_path, save):
    path = str(tmp_path / "v2.commit")
    save(path, {"memory": np.zeros((4, 8), dtype=np.uint64)})
    with open(path, "r+b") as f:
        hdr = f.read(4096).rstrip(b"\x00").replace(b'"version": 1',
                                                   b'"version": 2')
        f.seek(0)
        f.write(hdr.ljust(4096, b"\x00"))
    return path


@pytest.mark.parametrize("make", (_truncated, _junk, _other_version),
                         ids=("truncated", "not_a_checkpoint", "version"))
def test_checkpoint_rejections_match_jax(tmp_path, make):
    path = make(tmp_path, checkpoint.save_commit_pols)
    with pytest.raises(ValueError) as mine:
        checkpoint.load_commit_pols(path)
    with pytest.raises(ValueError) as theirs:
        jcheckpoint.load_commit_pols(path)
    assert str(mine.value) == str(theirs.value)
    assert any(w in str(mine.value) for w in
               ("truncated", "not a commit-pols", "unsupported version"))


def test_checkpoint_of_gen_batch_proof(batch):
    """The checkpoint gen_batch_proof wrote holds the executed trace and
    the input's publics, and the JAX package reads it."""
    bp, path = batch
    traces, hdr = checkpoint.load_commit_pols(path)
    jtraces, jhdr = jcheckpoint.load_commit_pols(path)
    assert list(traces) == ["memory"] and hdr == jhdr
    np.testing.assert_array_equal(np.asarray(traces["memory"]),
                                  np.asarray(jtraces["memory"]))
    assert hdr["publics"] == dataclasses.asdict(_input().publics)
    assert hdr["meta"]["counters"] == bp.counters


def test_resume_proves_identically(batch):
    """gen_batch_proof_from_commit on a FRESH prover: the same proof bytes,
    publics and counters as gen_batch_proof."""
    bp, path = batch
    fresh = Prover(n_bits=9, device="cpu")
    bp2 = fresh.gen_batch_proof_from_commit(path)
    assert bp2.actions is None
    assert sorted(bp2.sm_proofs) == sorted(bp.sm_proofs)
    assert bp2.sm_proofs["memory"][1].to_json() == \
        bp.sm_proofs["memory"][1].to_json()
    assert bp2.publics.new_acc_input_hash == bp.publics.new_acc_input_hash
    assert bp2.publics.new_batch_num == 1
    assert bp2.counters == bp.counters
    assert fresh.verify_batch_proof(bp2)


# -- the CLI ------------------------------------------------------------------


def test_cli_prove_matches_pin(tmp_path):
    path = tmp_path / "input.json"
    path.write_text(_input().to_json())
    out = tmp_path / "out"
    assert cli.main(["--prove", str(path), "-o", str(out),
                     "--device", "cpu"]) == 0
    got = json.loads((out / "batch_proof.json").read_text())
    assert sorted(got) == ["counters", "proofs", "publics"]
    assert {k: hashlib.sha256(v.encode()).hexdigest()
            for k, v in got["proofs"].items()} == {"memory": MEMORY_PIN}
    pub = _input(port=False).publics
    assert got["publics"]["new_acc_input_hash"] == pub.acc_input_hash()
    assert got["publics"]["new_batch_num"] == 1
    assert got["counters"]["memory"] == 2


def test_cli_needs_cuda_unless_told(tmp_path, monkeypatch):
    path = tmp_path / "input.json"
    path.write_text(_input().to_json())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--prove", str(path), "-o", str(tmp_path)]) == 2
    assert not (tmp_path / "batch_proof.json").exists()
    assert cli.main(["--version"]) == 0


def test_cli_service_modes_raise(tmp_path):
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"runHashDBServer": True}))
    with pytest.raises(NotImplementedError, match="runHashDBServer"):
        cli.main(["-c", str(cfg), "--device", "cpu"])
    assert cli.main(["--device", "cpu"]) == 0  # nothing to run


# -- the JAX side of the pins -------------------------------------------------


@pytest.mark.slow
def test_jax_gen_batch_proof_matches_pin(tmp_path):
    path = str(tmp_path / "batch.commit")
    jp = JProver(n_bits=9)
    bp = jp.gen_batch_proof(_input(port=False), save_cm_pols=path)
    assert _digest(bp.sm_proofs["memory"][1]) == MEMORY_PIN
    bp2 = JProver(n_bits=9).gen_batch_proof_from_commit(path)
    assert _digest(bp2.sm_proofs["memory"][1]) == MEMORY_PIN
