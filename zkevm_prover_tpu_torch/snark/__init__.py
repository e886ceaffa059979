"""SNARK wrap (L5) — BN254 Groth16 over R1CS.

Port of `zkevm_prover_tpu/snark/` (r1cs, groth16, gadgets,
stark_verifier_circuit, plonk, fflonk, export): the CRS, the FFTs and the
MSMs on the kernels of csrc/bn254.cu through `ops/bn254_device.py` and
`ops/msm.py`, the circuits, witnesses and pairings on the host.

Framework counterpart of the reference's rapidsnark (src/rapidsnark/:
Groth16::Prover with zkey-driven a/b/c assembly, 6x BN254 FFT and 5 Pippenger
MSMs, SURVEY.md §2.5) plus the circuit/witness role that circom-generated
calcwit code plays (src/starkpil/*/witness). The reference consumes opaque
.zkey/.dat artifacts from an external toolchain; this framework carries its
own circuit representation (r1cs), setup, prover and in-stack pairing
verifier, so the final proof stage is self-contained.
"""

from .r1cs import R1CS
from .groth16 import Groth16Setup, groth16_prove, groth16_setup, groth16_verify

__all__ = [
    "R1CS", "Groth16Setup", "groth16_setup", "groth16_prove", "groth16_verify",
]
