"""The port's `stark/stark_info.py` and `stark/proof2zkin.py` against the
JAX package's: twins of tests/test_misc_components.py :17, :40 and :50 (the
starkinfo.json round trip, `StarkInfo.from_setup`, and the zkin dict of a
proof), each compared with the JAX package's result on the same input."""

import dataclasses
import json

from zkevm_prover_tpu.stark import proof2zkin as jp2z
from zkevm_prover_tpu.stark.proof import StarkProof as JProof
from zkevm_prover_tpu.stark.setup import StarkSetup as JSetup
from zkevm_prover_tpu.stark.stark_info import StarkInfo as JStarkInfo
from zkevm_prover_tpu_torch.stark import examples
from zkevm_prover_tpu_torch.stark.proof2zkin import proof2zkin, publics2zkin
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.setup import StarkSetup
from zkevm_prover_tpu_torch.stark.stark_info import StarkInfo

INFO = {
    "starkStruct": {"nBits": 10, "nBitsExt": 11, "nQueries": 8,
                    "verificationHashType": "GL",
                    "steps": [{"nBits": 11}, {"nBits": 7}]},
    "nConstants": 3, "nPublics": 1,
    "nCm1": 5, "nCm2": 2, "nCm3": 3, "nCm4": 6,
    "qDeg": 2, "qDim": 3,
    "evMap": [{"type": "cm", "id": 0, "prime": False},
              {"type": "const", "id": 1, "prime": True}],
}


def test_starkinfo_roundtrip(tmp_path):
    info = StarkInfo.load(INFO)
    assert info.starkStruct.nBitsExt == 11
    assert info.mapTotalN > 0
    assert info.mapOffsets["cm1_n"] == 0
    assert info.mapOffsets["cm1_2ns"] == 5 * (1 << 10)
    p = tmp_path / "x.starkinfo.json"
    info.save(str(p))
    again = StarkInfo.load(str(p))
    assert again.mapTotalN == info.mapTotalN
    assert again.evMap[1].prime is True
    # the same memory map and the same file text as the JAX package's
    jinfo = JStarkInfo.load(INFO)
    assert info.save() == jinfo.save()
    q = tmp_path / "j.starkinfo.json"
    jinfo.save(str(q))
    assert p.read_text() == q.read_text()
    assert dataclasses.asdict(StarkInfo.load(str(q))) == \
        dataclasses.asdict(again)


def test_starkinfo_from_setup():
    air, _ = examples.fib_air_trace()
    setup = StarkSetup(air, n_queries=8, fri_fold_bits=2)
    info = StarkInfo.from_setup(setup)
    assert info.starkStruct.nBits == setup.n_bits
    assert info.nCm1 == setup.section_width[1]
    from test_stark_e2e import fib_air

    jinfo = JStarkInfo.from_setup(JSetup(fib_air(), n_queries=8,
                                         fri_fold_bits=2))
    assert info.save() == jinfo.save()


def test_proof2zkin_shape():
    air, trace = examples.fib_air_trace()
    setup = StarkSetup(air, n_queries=8, fri_fold_bits=2)
    proof = StarkProver(setup, device="cpu").prove(trace)
    zkin = proof2zkin(proof)
    assert "s0_vals1" in zkin and "s0_siblings1" in zkin
    assert len(zkin["s0_vals1"]) == setup.n_queries
    assert "root1" in zkin and len(zkin["root1"]) == 4
    assert len(zkin["evals"]) == len(setup.ev_map)
    z2 = publics2zkin(zkin, proof.publics, [1, 2, 3, 4])
    assert z2["rootC"] == [1, 2, 3, 4]
    json.dumps(z2)  # serializable
    # the JAX package's zkin of the same proof bytes
    jproof = JProof.from_json(proof.to_json())
    assert zkin == jp2z.proof2zkin(jproof)
    assert z2 == jp2z.publics2zkin(jp2z.proof2zkin(jproof), jproof.publics,
                                   [1, 2, 3, 4])


# the recursion slice's modules, imported and driven on their host half
# in a process where neither `jax` nor `zkevm_prover_tpu` can be imported
_RECURSION_DRIVE = """
import sys
sys.modules['jax'] = None
sys.modules['jaxlib'] = None
sys.modules['zkevm_prover_tpu'] = None
import torch
torch.set_num_threads(1)
from zkevm_prover_tpu_torch.ops import bn254, merkle_bn128, poseidon_bn128
from zkevm_prover_tpu_torch.ops import transcript_bn128
from zkevm_prover_tpu_torch.stark import examples, gl_circuit, proof2zkin
from zkevm_prover_tpu_torch.stark import recursive, stark_info
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.setup import StarkSetup
air, trace = examples.fib_air_trace()
setup = StarkSetup(air, n_queries=4, fri_fold_bits=2)
pv = StarkProver(setup, device="cpu")
proof = pv.prove(trace)
rp = recursive.RecursiveProver(setup, n_bits=None, n_queries=4,
                               device="cpu")
s = rp._synth(pv.verkey, proof)
cc = gl_circuit.compile_air(s, (gl_circuit.rows_needed(s) - 1).bit_length())
assert sorted(cc.trace(s)) == ["gates", "poseidon_g"]
assert poseidon_bn128.hash16(list(range(16))) < bn254.R
assert stark_info.StarkInfo.from_setup(setup).nCm1 == 2
assert proof2zkin.proof2zkin(proof)["publics"] == [1]
assert not any(k == "zkevm_prover_tpu" or k.startswith("zkevm_prover_tpu.")
               or k.split(".")[0] == "jax" for k in sys.modules
               if sys.modules[k] is not None)
"""


def test_recursion_modules_stand_alone():
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", _RECURSION_DRIVE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
