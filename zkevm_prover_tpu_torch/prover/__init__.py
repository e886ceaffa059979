"""Prover orchestration (L6).

Port of `zkevm_prover_tpu/prover` (the batch half): the Prover owns the
executor and the STARK engines, runs a request queue on a background thread
(submitRequest / waitForRequestToComplete), and exposes genBatchProof,
processBatch, the commit-pols checkpoint and its resume; beside it the
proof input (`input.py`) and the witness and datastream parsers.
"""

from .input import ProofInput, PublicInputs
from .prover import BatchProof, Prover, ProverRequest

__all__ = ["BatchProof", "Prover", "ProverRequest", "ProofInput",
           "PublicInputs"]
