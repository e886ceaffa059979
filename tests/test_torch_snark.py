"""The port's PLONK, fflonk, gadgets and snarkjs-style export against the
JAX package's on the CPU: twins of tests/test_plonk.py, test_fflonk.py,
test_gadgets.py and test_export.py at their sizes.

Both setups are seeded and deterministic and both proof systems carry no
blinding, so the port's setups and proofs (its SRS from the fixed-base
twin, its commitments from the MSM twin, its FFTs from the NTT twin: the
kernels of csrc/bn254.cu on a card) must equal the JAX package's byte for
byte. The gadget circuits are compared constraint for constraint; the
Groth16 round trip over the Merkle gadget's circuit (about 5,000
constraints) runs on the card (tests/test_torch_cuda.py) or with
ZK_SLOW=1 here.
"""

import json
import random

import pytest
import torch

from zkevm_prover_tpu.ops import poseidon_bn128 as jpbn
from zkevm_prover_tpu.prover.input import PublicInputs as JPublics
from zkevm_prover_tpu.prover.prover import AggregatedProof as JAgg
from zkevm_prover_tpu.prover.prover import Prover as JProver
from zkevm_prover_tpu.snark import export as jexport
from zkevm_prover_tpu.snark import fflonk as jf
from zkevm_prover_tpu.snark import gadgets as jgadgets
from zkevm_prover_tpu.snark import plonk as jp
from zkevm_prover_tpu_torch.ops import bn254 as bn
from zkevm_prover_tpu_torch.ops import poseidon_bn128 as pbn
from zkevm_prover_tpu_torch.ops import refmodel as rm
from zkevm_prover_tpu_torch.prover import Prover, PublicInputs
from zkevm_prover_tpu_torch.prover.prover import AggregatedProof
from zkevm_prover_tpu_torch.snark import export, fflonk, gadgets, plonk

R = bn.R
P = gadgets.GL_P


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- PLONK (tests/test_plonk.py) ----------------------------------------------

def _plonk_circuit(mod):
    b = mod.Builder(n_public=2)
    x = b.alloc()
    y = b.alloc()
    m = b.mul(x, y)
    s = b.add(x, y)
    b.assert_equal(m, 1)   # public 0 = x·y
    b.assert_equal(s, 2)   # public 1 = x+y
    return b.build()


def _plonk_assign(xv, yv):
    return [0, xv * yv % R, (xv + yv) % R, xv, yv, xv * yv % R,
            (xv + yv) % R]


@pytest.fixture(scope="module")
def plonk_pair():
    mine = plonk.plonk_setup(_plonk_circuit(plonk), device="cpu")
    theirs = jp.plonk_setup(_plonk_circuit(jp))
    return mine, theirs, plonk.plonk_prove(mine, _plonk_assign(3, 5)), \
        jp.plonk_prove(theirs, _plonk_assign(3, 5))


def test_plonk_setup_and_proof_match_jax(plonk_pair):
    mine, theirs, proof, jproof = plonk_pair
    for f in ("n_bits", "n", "srs_g1", "x_g2", "q_polys", "sigma_polys",
              "q_comms", "sigma_comms"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert proof == jproof


def test_plonk_verifies_and_rejects_tampering(plonk_pair):
    mine, theirs, proof, _ = plonk_pair
    assert plonk.plonk_verify(mine, [15, 8], proof)
    assert jp.plonk_verify(theirs, [15, 8], proof)
    assert not plonk.plonk_verify(mine, [16, 8], proof)
    bad = dict(proof, z=bn.g1_add(proof["z"], bn.G1_GEN))
    assert not plonk.plonk_verify(mine, [15, 8], bad)


def test_plonk_unsatisfied_witness_fails_to_prove(plonk_pair):
    bad = _plonk_assign(3, 5)
    bad[3] = 4
    with pytest.raises(AssertionError):
        plonk.plonk_prove(plonk_pair[0], bad)


# -- fflonk (tests/test_fflonk.py) ---------------------------------------------

def _fflonk_circuit(mod):
    b = mod.Builder(n_public=2)
    x, out = 1, 2
    x2 = b.mul(x, x)
    x3 = b.mul(x2, x)
    s = b.add(x3, x)
    five = b.alloc()
    b.constant(five, 5)
    s2 = b.add(s, five)
    b.assert_equal(s2, out)
    return b.build()


def _fflonk_assign(x):
    out = (x * x * x + x + 5) % R
    x2 = x * x % R
    x3 = x2 * x % R
    s = (x3 + x) % R
    return [0, x, out, x2, x3, s, 5, (s + 5) % R], out


@pytest.fixture(scope="module")
def fflonk_pair():
    mine = fflonk.fflonk_setup(_fflonk_circuit(fflonk), device="cpu")
    theirs = jf.fflonk_setup(_fflonk_circuit(jf))
    a, _ = _fflonk_assign(3)
    return mine, theirs, fflonk.fflonk_prove(mine, a), jf.fflonk_prove(
        theirs, a)


def test_fflonk_setup_and_proof_match_jax(fflonk_pair):
    mine, theirs, proof, jproof = fflonk_pair
    for f in ("n_bits", "n", "srs_g1", "x_g2", "q_polys", "sigma_polys",
              "c0_poly", "com_c0"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert proof == jproof
    points = [k for k in proof if isinstance(proof[k], tuple)]
    assert sorted(points) == ["c1", "c2", "w1", "w2"]
    assert len([k for k in proof if k.startswith("ev_")]) == 15


def test_fflonk_verifies_and_rejects_tampering(fflonk_pair):
    mine, theirs, proof, _ = fflonk_pair
    out = _fflonk_assign(3)[1]
    assert fflonk.fflonk_verify(mine, [3, out], proof)
    assert jf.fflonk_verify(theirs, [3, out], proof)
    assert not fflonk.fflonk_verify(mine, [3, out ^ 1], proof)
    bad = dict(proof, w2=bn.g1_add(proof["w2"], bn.G1_GEN))
    assert not fflonk.fflonk_verify(mine, [3, out], bad)


# -- gadgets (tests/test_gadgets.py) -------------------------------------------

def test_poseidon_gadget_matches_host_and_jax():
    rng = random.Random(0)
    vals = [rng.randrange(R) for _ in range(pbn.T)]
    s, js = gadgets.Synthesizer(n_public=0), jgadgets.Synthesizer(n_public=0)
    out = gadgets.poseidon_bn128_permute(s, [s.alloc(v) for v in vals])
    jout = jgadgets.poseidon_bn128_permute(js, [js.alloc(v) for v in vals])
    r1cs, w = s.finish()
    jr1cs, jw = js.finish()
    assert r1cs.is_satisfied(w)
    assert [w[o] for o in out] == pbn.permute(vals) == jpbn.permute(vals)
    assert (r1cs.constraints, w, out) == (jr1cs.constraints, jw, jout)
    w2 = list(w)
    w2[out[0]] = (w2[out[0]] + 1) % R
    assert not r1cs.is_satisfied(w2)


def test_gl_arithmetic_gadgets_match_jax():
    def build(mod):
        rng = random.Random(1)
        a_v, b_v = rng.randrange(P), rng.randrange(P)
        s = mod.Synthesizer(n_public=0)
        a, b = s.alloc(a_v), s.alloc(b_v)
        m = mod.gl_mul(s, a, b)
        ad = mod.gl_add(s, a, b)
        a3 = [s.alloc(rng.randrange(P)) for _ in range(3)]
        b3 = [s.alloc(rng.randrange(P)) for _ in range(3)]
        c3 = mod.gl3_mul(s, a3, b3)
        return s.finish(), (a_v, b_v, m, ad, a3, b3, c3)

    (r1cs, w), (a_v, b_v, m, ad, a3, b3, c3) = build(gadgets)
    (jr1cs, jw), _ = build(jgadgets)
    assert r1cs.is_satisfied(w)
    assert w[m] == a_v * b_v % P and w[ad] == (a_v + b_v) % P
    assert tuple(w[x] for x in c3) == tuple(rm.mul3(
        tuple(w[x] for x in a3), tuple(w[x] for x in b3)))
    assert (r1cs.constraints, w) == (jr1cs.constraints, jw)


def _merkle_circuit(mod, pmod):
    rng = random.Random(2)
    leaves = [rng.randrange(R) for _ in range(256)]
    level1 = [pmod.hash16(leaves[i * 16:(i + 1) * 16]) for i in range(16)]
    root_v = pmod.hash16(level1)
    idx = 37
    l0, l1 = idx % 16, idx // 16
    s = mod.Synthesizer(n_public=1)
    s.set_public(0, root_v)
    leaf = s.alloc(leaves[idx])
    sib0 = [s.alloc(leaves[l1 * 16 + j]) for j in range(16) if j != l0]
    sib1 = [s.alloc(level1[j]) for j in range(16) if j != l1]
    mod.merkle_path_arity16(s, leaf, [sib0, sib1], [l0, l1], root=1)
    r1cs, w = s.finish()
    return r1cs, w, root_v


def test_merkle_gadget_circuit_matches_jax():
    r1cs, w, root_v = _merkle_circuit(gadgets, pbn)
    jr1cs, jw, jroot = _merkle_circuit(jgadgets, jpbn)
    assert r1cs.is_satisfied(w)
    assert (r1cs.constraints, r1cs.n_public, r1cs.n_signals, w, root_v) == \
        (jr1cs.constraints, jr1cs.n_public, jr1cs.n_signals, jw, jroot)


@pytest.mark.slow
def test_merkle_gadget_groth16_roundtrip():
    """Groth16 over the Merkle gadget's circuit on the CPU twins (minutes:
    the slow tier, ZK_SLOW=1)."""
    from zkevm_prover_tpu_torch.snark import (groth16_prove, groth16_setup,
                                              groth16_verify)

    r1cs, w, root_v = _merkle_circuit(gadgets, pbn)
    setup = groth16_setup(r1cs, device="cpu")
    proof = groth16_prove(setup, w)
    assert groth16_verify(setup, [root_v], proof)
    assert not groth16_verify(setup, [(root_v + 1) % R], proof)


# -- export (tests/test_export.py) ---------------------------------------------

def _publics(mod):
    return mod(old_state_root="0x" + "11" * 32,
               new_state_root="0x" + "22" * 32,
               old_acc_input_hash="0x" + "00" * 32,
               new_acc_input_hash="0x" + "33" * 32,
               old_batch_num=7, new_batch_num=8, chain_id=1000)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The digest final proof of test_export.py's publics, exported by both
    packages."""
    tmp = tmp_path_factory.mktemp("export")
    pv = Prover(n_bits=9, final_snark="digest", device="cpu")
    fp = pv.gen_final_proof(AggregatedProof(publics=_publics(PublicInputs),
                                            children=[]))
    export.export_final_proof(pv, fp, str(tmp / "proof.json"),
                              str(tmp / "vkey.json"))
    jpv = JProver(n_bits=9, final_snark="digest")
    jfp = jpv.gen_final_proof(JAgg(publics=_publics(JPublics), children=[]))
    jexport.export_final_proof(jpv, jfp, str(tmp / "jproof.json"),
                               str(tmp / "jvkey.json"))
    return tmp


def test_export_matches_jax_and_cross_verifies(exported):
    t = exported
    assert json.loads((t / "vkey.json").read_text()) == \
        json.loads((t / "jvkey.json").read_text())
    mine = json.loads((t / "proof.json").read_text())
    theirs = json.loads((t / "jproof.json").read_text())
    assert {k: v for k, v in mine.items() if not k.startswith("pi_")} == \
        {k: v for k, v in theirs.items() if not k.startswith("pi_")}
    assert export.verify_final_proof_file(str(t / "proof.json"),
                                          str(t / "vkey.json"))
    assert jexport.verify_final_proof_file(str(t / "proof.json"),
                                           str(t / "jvkey.json"))
    assert export.verify_final_proof_file(str(t / "jproof.json"),
                                          str(t / "vkey.json"))


@pytest.mark.parametrize("tamper", ["public", "point", "vkey", "malformed"])
def test_export_rejects_tampering(exported, tamper, tmp_path):
    pj, vj = tmp_path / "proof.json", tmp_path / "vkey.json"
    p = json.loads((exported / "proof.json").read_text())
    v = json.loads((exported / "vkey.json").read_text())
    if tamper == "public":
        p["publics"]["newStateRoot"] = "0x" + "44" * 32
    elif tamper == "point":
        p["pi_a"][0] = str(int(p["pi_a"][0]) + 1)
    elif tamper == "vkey":
        v["IC"][0][0] = str(int(v["IC"][0][0]) + 1)
    else:
        assert not export.groth16_verify_vkey({"protocol": "plonk"}, [], {})
        v = {"protocol": "groth16", "nPublic": 1}
    pj.write_text(json.dumps(p))
    vj.write_text(json.dumps(v))
    assert not export.verify_final_proof_file(str(pj), str(vj))
