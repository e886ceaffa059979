"""Exportable verification — snarkjs-style JSON artifacts.

Copy of `zkevm_prover_tpu/snark/export.py` (host Python).

The reference ships verification keys (`final.fflonk.verkey.json`,
runtime/README.md) so a FinalProof verifies under snarkjs with no prover
state. This module serializes our Groth16 verification keys and
FinalProofs to JSON in the snarkjs field layout (vk_alpha_1 / vk_beta_2 /
vk_gamma_2 / vk_delta_2 / IC; G1 = [x, y, 1], G2 = [[x0,x1],[y0,y1],[1,0]],
big ints as decimal strings) and verifies from the files alone —
`verify_final_proof_file(proof.json, vkey.json)` needs no live Prover.
"""

from __future__ import annotations

import json

from ..ops import bn254 as bn


def _g1_json(p) -> list:
    if p is None:
        return ["0", "1", "0"]
    return [str(p[0]), str(p[1]), "1"]


def _g1_load(v):
    if str(v[2]) == "0":
        return None
    return (int(v[0]), int(v[1]))


def _g2_json(p) -> list:
    if p is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    (x0, x1), (y0, y1) = p
    return [[str(x0), str(x1)], [str(y0), str(y1)], ["1", "0"]]


def _g2_load(v):
    if str(v[2][0]) == "0" and str(v[2][1]) == "0":
        return None
    return ((int(v[0][0]), int(v[0][1])), (int(v[1][0]), int(v[1][1])))


def groth16_vkey(setup) -> dict:
    """snarkjs verification_key.json shape for a Groth16Setup."""
    return {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": setup.r1cs.n_public,
        "vk_alpha_1": _g1_json(setup.alpha1),
        "vk_beta_2": _g2_json(setup.beta2),
        "vk_gamma_2": _g2_json(setup.gamma2),
        "vk_delta_2": _g2_json(setup.delta2),
        "IC": [_g1_json(p) for p in setup.ic],
    }


def groth16_verify_vkey(vkey: dict, publics: list[int], proof: dict) -> bool:
    """The pairing check from the JSON vkey alone (no Groth16Setup)."""
    try:
        if vkey.get("protocol") != "groth16":
            return False
        ic = [_g1_load(p) for p in vkey["IC"]]
        if len(publics) != int(vkey["nPublic"]) or len(ic) != len(publics) + 1:
            return False
        pi_a = proof["pi_a"] if isinstance(proof["pi_a"], tuple) \
            else _g1_load(proof["pi_a"])
        pi_c = proof["pi_c"] if isinstance(proof["pi_c"], tuple) \
            else _g1_load(proof["pi_c"])
        pi_b = proof["pi_b"] if isinstance(proof["pi_b"], tuple) \
            else _g2_load(proof["pi_b"])
        if not (bn.g1_validate(pi_a) and bn.g1_validate(pi_c)
                and bn.g2_validate(pi_b)):
            return False
        alpha1 = _g1_load(vkey["vk_alpha_1"])
        beta2 = _g2_load(vkey["vk_beta_2"])
        gamma2 = _g2_load(vkey["vk_gamma_2"])
        delta2 = _g2_load(vkey["vk_delta_2"])
    except (KeyError, TypeError, ValueError, IndexError):
        return False
    vk_x = ic[0]
    for i, v in enumerate(publics):
        vk_x = bn.g1_add(vk_x, bn.g1_mul(ic[i + 1], int(v) % bn.R))
    return bn.pairing_check([
        (bn.g1_neg(pi_a), pi_b),
        (alpha1, beta2),
        (vk_x, gamma2),
        (pi_c, delta2),
    ])


def final_proof_json(fp) -> dict:
    """Serialize a prover.FinalProof (Groth16 systems)."""
    g16 = fp.groth16
    d = {
        "system": g16.get("system", "groth16") if isinstance(g16, dict)
        else "groth16",
        "pi_a": _g1_json(g16["pi_a"]),
        "pi_b": _g2_json(g16["pi_b"]),
        "pi_c": _g1_json(g16["pi_c"]),
        "publicsDigest": str(fp.publics_digest),
        "publics": {
            "oldStateRoot": fp.publics.old_state_root,
            "newStateRoot": fp.publics.new_state_root,
            "oldAccInputHash": fp.publics.old_acc_input_hash,
            "newAccInputHash": fp.publics.new_acc_input_hash,
            "oldBatchNum": fp.publics.old_batch_num,
            "newBatchNum": fp.publics.new_batch_num,
            "chainId": fp.publics.chain_id,
        },
    }
    if fp.stark_publics is not None:
        d["starkPublics"] = [str(v) for v in fp.stark_publics]
        d["smNames"] = list(g16.get("sm_names", []))
        if "kind" in g16:
            d["kind"] = g16["kind"]
    return d


def export_final_proof(prover, fp, proof_path: str, vkey_path: str) -> None:
    """Write proof.json + verification_key.json for a FinalProof produced
    by `prover` (the Prover instance that holds the circuit setups)."""
    with open(proof_path, "w") as f:
        json.dump(final_proof_json(fp), f, indent=1)
    setup = _setup_for(prover, fp)
    with open(vkey_path, "w") as f:
        json.dump(groth16_vkey(setup), f, indent=1)


def _setup_for(prover, fp):
    g16 = fp.groth16
    if isinstance(g16, dict) and g16.get("system") == "groth16-stark":
        names = tuple(g16["sm_names"])
        for k, setup in getattr(prover, "_join_g16", {}).items():
            if tuple(nm for nm, *_ in k) == names:
                return setup
        raise KeyError("no join setup for this proof's SM names")
    if isinstance(g16, dict) and g16.get("system") == "groth16-recursive":
        return prover._final_rec_g16[g16["kind"]]
    return prover._final_circuit()


def verify_final_proof_file(proof_path: str, vkey_path: str) -> bool:
    """Third-party verification: files only, no prover state.

    Recomputes the publics digest from the carried publics and checks the
    Groth16 proof against the JSON vkey. For the stark-verify system the
    circuit publics are the starkPublics list (verkeys + STARK publics)."""
    from ..ops import keccak

    with open(proof_path) as f:
        pj = json.load(f)
    with open(vkey_path) as f:
        vkey = json.load(f)
    pub = pj["publics"]
    payload = (
        bytes.fromhex(pub["oldStateRoot"][2:])
        + bytes.fromhex(pub["newStateRoot"][2:])
        + bytes.fromhex(pub["oldAccInputHash"][2:])
        + bytes.fromhex(pub["newAccInputHash"][2:])
        + int(pub["oldBatchNum"]).to_bytes(8, "big")
        + int(pub["newBatchNum"]).to_bytes(8, "big")
        + int(pub["chainId"]).to_bytes(8, "big")
    )
    digest = int.from_bytes(keccak.keccak256(payload), "big") % bn.R
    if digest != int(pj["publicsDigest"]):
        return False
    proof = {"pi_a": pj["pi_a"], "pi_b": pj["pi_b"], "pi_c": pj["pi_c"]}
    if pj.get("system") in ("groth16-stark", "groth16-recursive"):
        publics = [int(v) for v in pj["starkPublics"]]
    else:
        publics = [digest]
    if pj.get("system") == "groth16-recursive":
        # the batch publics ride INSIDE the circuit publics (the STARK's
        # 44-public layout after the recursiveF verkey) — the carried
        # "publics" block must match them, or the file's human-readable
        # roots would be unbound to the proof
        def _fea(limbs):
            return "0x" + sum(
                int(v) << (32 * i) for i, v in enumerate(limbs)
            ).to_bytes(32, "big").hex()

        if len(publics) < 45:
            return False
        if _fea(publics[1:9]) != pub["oldStateRoot"]:
            return False
        if _fea(publics[20:28]) != pub["newStateRoot"]:
            return False
    return groth16_verify_vkey(vkey, publics, proof)
