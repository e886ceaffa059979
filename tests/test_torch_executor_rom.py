"""The port's `Executor` ROM-path helpers (`run_rom`, `main_prover`,
`prove_rom_batch`) against the JAX package's, on the ROM of
`executor.examples.small_rom_batch` (its input and its 4-key pre-state):
the Main trace, the emitted actions, the counters and the Main setup equal
the JAX package's. `prove_rom_batch` proves Main and every co-SM it feeds,
minutes on this CPU; its slow test holds every proof to the JAX
package's:

    ZK_SLOW=1 python -m pytest -q -m slow tests/test_torch_executor_rom.py
"""

import json

import numpy as np
import pytest
import torch

from test_torch_main_sm import actions_of
from zkevm_prover_tpu.executor import Executor as JExecutor
from zkevm_prover_tpu.executor.rom import Rom as JRom
from zkevm_prover_tpu.executor.sm import main_sm as jmain_sm
from zkevm_prover_tpu.hashdb.database import Database as JDatabase
from zkevm_prover_tpu.hashdb.smt import Smt as JSmt
from zkevm_prover_tpu.stark.setup import StarkSetup as JSetup
from zkevm_prover_tpu_torch.executor import Executor, examples
from zkevm_prover_tpu_torch.hashdb import Smt


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU proves run on one thread beside the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port():
    """A fresh pre-state (the ROM writes storage) and the batch."""
    db, tree, batch = examples.small_rom_batch("cpu")
    return Smt(db), tree, batch


def _jax(tree, batch):
    """The JAX package's ROM from the same JSON and its Smt over the same
    keys and values."""
    jrom = JRom.from_json(json.loads(json.dumps(batch.rom.to_json())))
    jsmt = JSmt(JDatabase())
    r = (0, 0, 0, 0)
    for key, value in zip(tree.keys.tolist(), tree.values):
        r = jsmt.set(r, tuple(key), value).new_root
    assert tuple(r) == tree.root
    return jrom, jsmt


def test_run_rom_matches_jax():
    smt, tree, batch = _port()
    ex = Executor(device="cpu")
    assert ex.n_bits["main"] == batch.n_bits == 9
    res = ex.run_rom(batch.rom, input=batch.input, smt=smt)
    jrom, jsmt = _jax(tree, batch)
    jres = JExecutor().run_rom(jrom, input=batch.input, smt=jsmt)
    np.testing.assert_array_equal(res.trace, np.asarray(jres.trace))
    assert actions_of(res) == actions_of(jres)
    assert res.counters == jres.counters
    assert res.last_step == jres.last_step


def test_main_prover_matches_jax():
    _, tree, batch = _port()
    ex = Executor(device="cpu")
    pv = ex.main_prover(batch.rom)
    assert ex.main_prover(batch.rom) is pv      # cached per ROM object
    assert pv.device == torch.device("cpu")
    jrom, _ = _jax(tree, batch)
    jsetup = JSetup(jmain_sm.build_air(jrom, 9), n_queries=8,
                    fri_fold_bits=2)
    assert pv.setup.describe() == jsetup.describe()


@pytest.mark.slow
def test_prove_rom_batch_matches_jax():
    smt, tree, batch = _port()
    ex = Executor(device="cpu")
    res, proofs = ex.prove_rom_batch(batch.rom, input=batch.input, smt=smt)
    assert ex.verify_all(proofs)
    jrom, jsmt = _jax(tree, batch)
    jres, jproofs = JExecutor().prove_rom_batch(jrom, input=batch.input,
                                                smt=jsmt)
    assert sorted(proofs) == sorted(jproofs)
    for name in proofs:
        assert proofs[name][1].to_json() == jproofs[name][1].to_json(), name
