"""The PyTorch port stands alone: it imports without JAX, never imports the
JAX package, and its entry points refuse to run without CUDA unless asked
for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "zkevm_prover_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import zkevm_prover_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'zkevm_prover_tpu' or k.startswith('zkevm_prover_tpu.')"
        " for k in sys.modules), 'JAX package imported'\n"
        "print(' '.join(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 42
    sms = ("binary", "memory", "arith", "mem_align", "padding_pg",
           "climb_key", "poseidon_g", "storage", "keccak_circuit", "keccak_f",
           "sha256_circuit", "sha256_f", "padding_stream", "padding_kk",
           "padding_sha256", "hash_bit", "bits2field", "padding_pg_byte")
    assert {f"zkevm_prover_tpu_torch.executor.sm.{sm}" for sm in sms} <= names
    assert {"zkevm_prover_tpu_torch.executor.examples",
            "zkevm_prover_tpu_torch.executor.executor",
            "zkevm_prover_tpu_torch.ops.poseidon_cuda",
            "zkevm_prover_tpu_torch.ops.keccak",
            "zkevm_prover_tpu_torch.ops.sha256",
            "zkevm_prover_tpu_torch.ops.hash_cuda"} <= names
    assert {"zkevm_prover_tpu_torch.executor.rom",
            "zkevm_prover_tpu_torch.executor.eval_command",
            "zkevm_prover_tpu_torch.executor.sm.main_sm",
            "zkevm_prover_tpu_torch.executor.combined",
            "zkevm_prover_tpu_torch.executor.forks",
            "zkevm_prover_tpu_torch.ops.ecrecover",
            "zkevm_prover_tpu_torch.stark.compose"} <= names
    hashdb = ("key_utils", "cache", "database", "smt", "state_manager",
              "hashdb_interface")
    hashdb64 = ("page_store", "database64", "key_value_history",
                "level_tree", "state64")
    assert {f"zkevm_prover_tpu_torch.hashdb.{m}" for m in hashdb} <= names
    assert {f"zkevm_prover_tpu_torch.hashdb64.{m}" for m in hashdb64} <= names
    assert {f"zkevm_prover_tpu_torch.{m}" for m in ENTRY_MODULES} <= names
    assert {f"zkevm_prover_tpu_torch.{m}" for m in SNARK_MODULES} <= names


# the modules of the Main SM and combined-AIR slice
SLICE_MODULES = ("executor.rom", "executor.eval_command", "ops.ecrecover",
                 "executor.sm.main_sm", "stark.compose", "executor.combined",
                 "executor.forks")


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_imports_without_jax_or_jax_package(module):
    """Each module imports, and runs its entry point's host half, in a
    process where neither `jax` nor `zkevm_prover_tpu` can be imported."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['zkevm_prover_tpu'] = None\n"
        f"m = importlib.import_module('zkevm_prover_tpu_torch.{module}')\n"
        "from zkevm_prover_tpu_torch.executor import combined, rom\n"
        "rb = rom.RomBuilder()\n"
        "rb.line(CONSTL=7, setA=1)\n"
        "rb.line('A :MSTORE(3)', inA=1, mOp=1, mWR=1, offset=3)\n"
        "rb.clear_registers(); rb.finalize()\n"
        "r = rb.build()\n"
        "res, tr = combined.execute_batch(r, 9, include=('memory',),"
        " device='cpu')\n"
        "air = combined.build_batch_air(r, 9, include=('memory',))\n"
        "assert air.stack_traces(tr).shape == (512, len(air.cm_names))\n"
        "assert not any(k == 'zkevm_prover_tpu' or"
        " k.startswith('zkevm_prover_tpu.') or k.split('.')[0] == 'jax'"
        " for k in sys.modules if sys.modules[k] is not None)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# the modules of the batch-proof entry point's slice
ENTRY_MODULES = ("utils", "utils.zklog", "utils.timers", "utils.config",
                 "ops.blake", "prover", "prover.input",
                 "prover.checkpoint", "prover.witness", "prover.datastream",
                 "prover.prover", "executor.full_tracer", "__main__")

# the memory batch through gen_batch_proof with a checkpoint, its resume,
# the CLI, the parsers and Blake2b on the CPU
_ENTRY_DRIVE = """
import hashlib, json, os, sys, tempfile
import torch
torch.set_num_threads(1)
from zkevm_prover_tpu_torch.__main__ import main
from zkevm_prover_tpu_torch.executor import BatchActions
from zkevm_prover_tpu_torch.ops import blake
from zkevm_prover_tpu_torch.prover import ProofInput, Prover, PublicInputs
from zkevm_prover_tpu_torch.prover import checkpoint, datastream, witness
tmp = tempfile.mkdtemp()
inp = ProofInput(publics=PublicInputs(batch_l2_data="0xdead"),
                 actions=BatchActions(memory=[
                     {"addr": 1, "step": 1, "wr": 1, "value": 5},
                     {"addr": 1, "step": 2, "wr": 0, "value": 0}]))
prover = Prover(n_bits=9, device="cpu")
bp = prover.gen_batch_proof(inp, save_cm_pols=os.path.join(tmp, "cm"))
assert prover.verify_batch_proof(bp)
traces, hdr = checkpoint.load_commit_pols(os.path.join(tmp, "cm"))
assert list(traces) == ["memory"] and hdr["meta"]["counters"]["memory"] == 2
again = prover.gen_batch_proof_from_commit(os.path.join(tmp, "cm"))
want = bp.sm_proofs["memory"][1].to_json()
assert again.sm_proofs["memory"][1].to_json() == want
with open(os.path.join(tmp, "in.json"), "w") as f:
    f.write(inp.to_json())
assert main(["--prove", os.path.join(tmp, "in.json"), "-o", tmp,
             "--device", "cpu"]) == 0
with open(os.path.join(tmp, "batch_proof.json")) as f:
    assert json.load(f)["proofs"]["memory"] == want
batch = datastream.DataStreamBatch(batch_number=1, fork_id=9, chain_id=1)
assert datastream.parse(datastream.encode(batch)).blocks == []
leaf = (b"\\x01\\x07\\x00" + witness._enc_major(0, 5)
        + witness._enc_major(0, 1))
assert witness.witness_to_db(leaf)[1] != (0, 0, 0, 0)
assert blake.blake2b_256(b"abc", "cpu") == hashlib.blake2b(
    b"abc", digest_size=32).digest()
assert not any(k == "zkevm_prover_tpu" or k.startswith("zkevm_prover_tpu.")
               or k.split(".")[0] == "jax"
               for k in sys.modules if sys.modules[k] is not None)
"""


def test_entry_modules_import_and_run_without_jax_or_jax_package():
    """Each module of the slice imports, and the entry point runs, in a
    process where neither `jax` nor `zkevm_prover_tpu` can be imported."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "sys.modules['zkevm_prover_tpu'] = None\n"
            f"for m in {ENTRY_MODULES!r}:\n"
            "    importlib.import_module('zkevm_prover_tpu_torch.' + m)\n"
            + _ENTRY_DRIVE)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


# the modules of the SNARK wrap's slice
SNARK_MODULES = ("ops.bn254_device", "ops.bn254_cuda", "ops.msm", "snark",
                 "snark.r1cs", "snark.groth16", "snark.gadgets",
                 "snark.stark_verifier_circuit", "snark.plonk",
                 "snark.fflonk", "snark.export")

# the digest circuit's Groth16 and a plonk proof on the CPU twins
_SNARK_DRIVE = """
import torch
torch.set_num_threads(1)
from zkevm_prover_tpu_torch.prover import Prover, PublicInputs
from zkevm_prover_tpu_torch.prover.prover import AggregatedProof
prover = Prover(n_bits=9, device="cpu")
agg = AggregatedProof(publics=PublicInputs(new_state_root="0x" + "22" * 32),
                      children=[])
for snark in ("digest", "plonk"):
    fp = prover.gen_final_proof(agg, snark=snark)
    assert prover.verify_final_proof(fp), snark
assert not any(k == "zkevm_prover_tpu" or k.startswith("zkevm_prover_tpu.")
               or k.split(".")[0] == "jax"
               for k in sys.modules if sys.modules[k] is not None)
"""


def test_snark_modules_import_and_run_without_jax_or_jax_package():
    """Each module of the SNARK slice imports, and the final wrap's digest
    and plonk modes prove and verify, in a process where neither `jax` nor
    `zkevm_prover_tpu` can be imported."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "sys.modules['zkevm_prover_tpu'] = None\n"
            f"for m in {SNARK_MODULES!r}:\n"
            "    importlib.import_module('zkevm_prover_tpu_torch.' + m)\n"
            + _SNARK_DRIVE)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def _file_id(path):
    """The file's name; under the entry point's packages, whose prover.py
    shares stark/prover.py's name, its path in the port."""
    if path.parent.name in ("prover", "utils"):
        return str(path.relative_to(PORT))
    return path.name


@pytest.mark.parametrize("path", _port_files(), ids=_file_id)
def test_port_file_imports_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "zkevm_prover_tpu"), \
                f"{path.name} imports {name}"


def test_entry_points_raise_without_cuda(monkeypatch):
    from zkevm_prover_tpu_torch import resolve_device
    from zkevm_prover_tpu_torch.executor import Executor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Executor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_cuda_wrapper_rejects_cpu_tensor():
    from zkevm_prover_tpu_torch.ops import poseidon_cuda

    before = dict(poseidon_cuda.launches)
    for mode in poseidon_cuda.MODES:
        with pytest.raises(ValueError, match="CUDA tensor"):
            poseidon_cuda.ENTRY[mode](torch.zeros((4, 12), dtype=torch.int64))
    assert poseidon_cuda.launches == before


def test_executor_refuses_unported_actions():
    from zkevm_prover_tpu_torch.executor import BatchActions, Executor

    ex = Executor(device="cpu")
    # hashp is proved only inside the combined AIR (executor/combined.py):
    # as in the JAX package, the action-list path fills no trace for it
    assert ex.execute(BatchActions(hashp=[{"data": b"a"}])) == {}
    # keccak and sha256 are ported: they fill the padding SMs
    out = ex.execute(BatchActions(keccak=[{"data": b"a"}],
                                  sha256=[{"data": b"a"}]))
    assert list(out) == ["padding_kk", "padding_sha256"]
    # storage is ported: it needs the database its trees live in
    with pytest.raises(ValueError, match="db="):
        ex.execute(BatchActions(storage=[{"op": "get"}]))
