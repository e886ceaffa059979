"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--bits N] [--arith-bits N]

Phases (any failure exits nonzero; no phase catches and continues):

 1. card line: name and power limit from nvidia-smi;
 2. build every CUDA kernel of the port from `zkevm_prover_tpu_torch/csrc`
    (one nvcc per library source, all at once: the poseidon_gl library,
    the hash library, csrc/hash.cu, the BN254 libraries, csrc/bn254.cu
    and bn254_g2.cu, and the STARK library, csrc/stark.cu); from here on
    `expr.eval_array` over card tensors and `prover.calculate_z` of card
    tensors are counted, and must not run outside phase 3e's comparisons;
 3. every Poseidon mode's kernel (`poseidon_cuda.MODES`) against the plain
    torch permutation on the card, bit for bit: the r05 batch (pinned
    checksum), 515 random + 2 edge states, 2^22 states and a ragged
    2^20 + 37; each timed through its entry point at 2^10, 2^16, 2^20 and
    2^22 states beside the plain time and the bound (`poseidon_bound`: the
    S-boxes' IMADs, the MDS on the tensor cores), and each kernel also
    alone, through `poseidon_cuda.launch` on a batch already in its layout
    (for 1d the difference is the entry point's two transposes), each
    beside mxu96 alone in the same process (2d, mxu and mxu24 differ from
    it in the full rounds' MDS form alone) and mxu24 beside mxu alone (the
    same kernel body, one plane or a plane pair per MMA); then the pinned
    r05 LDE checksum
    (2^23 -> 2^24 x 4, plain torch);
 3b. the fused Merkle commit (`poseidon_cuda.merkle_levels`, the second
    kernel of csrc/poseidon_gl.cu) bit for bit against the plain tree
    (`merkle.merkelize_levels_plain`) at 2^22 x 48 and against the chunked
    tree through kernel 1 at 2^21 x 189 (arith's stage-1 section), every
    level; fused, chunked and plain timed beside `merkle_bound`;
 3d. (after 3c) the BN254 kernels (csrc/bn254.cu, `check_bn254`): the
    fixed-base products at 2^22 scalars, 1,024 sampled against the host's
    g1_mul_gen / g2_mul_gen, timed cold (the cached table dropped, built
    inside the call) and warm at 2^16, 2^20, 2^22 and the CRS's sizes
    (`FB_CRS`), each cold result == the warm one; the G1 MSM at 2^10 .. 2^22 points and the G2
    MSM at 2^10 .. 2^20 against g*_mul_gen(sum s_i k_i mod r) (their
    bases k_i * G from the fixed-base kernel), the witness-like skewed
    sets (G1 2^21, G2 2^20) the same way, the host MSM at 2^10 (G2
    2^6), the plain twins at 2^10 and 2^16, the edge cases (zero
    scalars, scalars >= r, repeated points, P beside -P, infinity) and
    the MSM sort's signed digits at 2^16 against `signed_digits`, then one
    line each of the per-kernel device time of a G1 2^22 and a G2 2^20
    MSM under torch.profiler; the
    Fr NTT at 2^10 .. 2^22 against its twin (2^10, 2^16), inverse after
    forward and host Horner evaluations at 2^22, and the Groth16 chain's
    three forms at 2^21 (inverse; coset forward; inverse with the
    unshift) against the twin, each timed beside its own bound; the
    pointwise step
    against its twin; each timed beside its bound (`msm_bound`: the least
    over windows of the signed-digit Pippenger's batch-affine additions,
    logged beside the MSM's times before its redesign; `fixed_base_bound`:
    the least over windows of the signed-digit additions, batch-affine or
    mixed Jacobian, with the table's build, logged beside the kernel's
    times before its redesign, `FIXED_BASE_MS_BEFORE`; `ntt_bound` per
    form, beside `FR_NTT_MS_BEFORE`; `pointwise_bound`: 32-bit multiply-adds
    of its Montgomery products at the IMAD rate against its bytes) and its
    twin's time (at 2^16; the NTT and pointwise also at 2^22; the
    pointwise kernel also timed at 2^21, the final wrap's size);
    the kernels line gives ms, plain_ms and bound_ms at one size
    (`log2_size`: 2^16 for the MSMs and the fixed base, 2^22 for the NTT
    and the pointwise step) and every size in its maps;
 3c. the hash kernels (csrc/hash.cu): Keccak-f, the SHA-256 compression
    and the Blake2b compression against their plain torch twins on the
    card, bit for bit, on 515 random instances and on 2^20 + 37 (Blake2b's
    with both last-block flags and the counter at 0, 128 and 2^64 - 1);
    against the host oracles (`_keccak_f_host` on 64 states, hashlib on
    `sha256_blocks` of 64 single-block messages, on `blake2b_256_many` of
    64 single-block messages and on `blake2b_256` of 0, 1, 127, 128, 129
    and 1,000 bytes); each timed at 2^10, 2^16, 2^20 and 2^22 instances
    beside the plain time and its bound (`keccak_bound`, `sha256_bound`,
    `blake2b_bound`: 32-bit logic, shift, byte-permute and add operations
    at the integer rate against the bytes at 3.35 TB/s);
 4b. the state tree: `executor.examples.state_tree` at 2^12 keys on the
    card gives the CPU's root; then at 2^20 keys (`TREE_BITS`) on the
    card, its permutations through the mxu96 kernel (counters zeroed just
    before, read just after: one launch per hash batch), host and device
    seconds, nodes, depth, and `Smt.get` of 64 present keys and 16 absent
    ones. The keys are those the Main SM derives from random key registers
    (two of the hash batches), so that phase 5b's ROM reads and writes
    them;
 4c. the storage batch at full width over that tree:
    `executor.examples.storage_batch` closed on PoseidonG's capacity at
    2^`--bits`, proved through `Executor.prove_all(actions, db=smt.db)`
    (storage at the smallest power of two that holds its rows, its emitted
    PoseidonG and ClimbKey at 2^`--bits`), per-SM executor and prove
    seconds and phases, peak device memory, the emitted counts against
    their capacities; `verify_all`, and a tampered storage proof must be
    rejected. Counters zeroed just before `prove_all` and read after
    `verify_all`: the fused Merkle kernel and mxu96 must have run, and no
    other mode's kernel;
 4d. the hash batch at full width (`executor.examples.hash_batch`): Keccak
    messages through PaddingKK and KeccakF (24 rounds, pack 40, 2^21, 520
    permutations), SHA-256 messages through PaddingSha256 (its compression
    chain on the sha256_compress kernel, one launch per block) and Sha256F
    (64 rounds, pack 40, 2^22, 1,320 compressions): per SM the AIR's host
    seconds, the executor's, the prove's and its phases, peak device
    memory; `verify_all`, a tampered proof of each SM rejected, and the
    digests of PaddingKK's single-block messages equal to
    `keccak256_blocks` of them on the card (the keccak_f kernel). Counters
    zeroed just before and read just after: the fused Merkle kernel,
    mxu96, sha256_compress and keccak_f must have run, and no other
    Poseidon mode;
 4e. (run last, after phase 6, so that the CPU child's proofs overlap the
    card's phases) small proofs on the card against the port's CPU proofs
    (made by a child process from the start), byte for byte: the four toy AIRs,
    PoseidonG at 2^8, the mixed batch of the seven co-processor SMs at 2^9
    through `Executor.prove_all`, the small storage batch (storage 2^9 with
    its emitted PoseidonG 2^9 and ClimbKey 2^10,
    `executor.examples.small_storage_batch`) and the small hash batch
    (`executor.examples.small_hash_batch`);
 4f. among those small proofs, the combined batch AIR of
    `executor.examples.small_rom_batch` (Main and the seven co-SMs that
    `combined.default_include(9)` binds, 2^9): `combined.execute_batch`,
    `build_batch_air`, one proof, card bytes == CPU bytes, and it
    verifies on the card; and the JAX pipeline test's memory batch
    through `Prover`'s request queue (`submit_request(ProverRequest(
    "genBatchProof", ...))`, `wait_for_request`); then the CLI,
    `python -m zkevm_prover_tpu_torch --prove` of that batch's input JSON
    on the card in a subprocess, whose batch_proof.json must equal the
    child's CLI run on the CPU; the final SNARKs of that memory batch (a
    Groth16 proof with a fixed seed over `Prover._final_circuit`, the
    plonk and the fflonk final proofs), card == CPU; and the recursion
    slice's small proofs:
    the Fibonacci AIR under BN128 commitments, `Prover.compress_proof` of
    the memory batch (its SM re-proved under BN128) and the Fibonacci
    proof's recursive1 wrap at 2^13 (`stark.recursive.RecursiveProver`),
    each card == CPU, byte for byte, and each verified on the card;
 5b. the combined batch at full width: `executor.examples.rom_batch` at
    2^`ROM_BITS` (17) over the 2^20-key tree, its ROM at the fork-9
    e2e vector's per-step op rates, closed on the scarcest bound SM;
    `combined.execute_batch` (host seconds of Main and each co-SM),
    `build_batch_air(rom, 17, include=default_include(17))` (695
    committed columns: Main and the eight bound co-SMs), `StarkSetup`,
    one `StarkProver.prove` (its phases, peak device memory) and
    `verify`; each SM's fill and the counter that closed the batch; a
    tampered proof rejected; a cross-SM forgery (a Memory write's value
    changed where Memory alone stays consistent) flagged by
    `check_constraints(quick=True)` on the card, in the Main-Memory
    permutation's constraints and no other; the chaining publics read
    out of the proof equal the executor's old and new state roots.
    Counters zeroed just before the prove and read after `verify`: the
    fused Merkle kernel, mxu96 and the two STARK kernels must have run,
    and no other mode's kernel;
 3e. (after 5b) the STARK kernels (csrc/stark.cu, `check_stark`) on the
    combined AIR of 5b's prover over random sections: C * Zi and the FRI
    sums at the extended rows, the lookups' f/t and the num/den at the
    trace rows and num/den at 2^17 + 37 rows, each through
    dag_eval_kernel against `dag.run_plain` on the card, bit for bit, C *
    Zi also against `expr.eval_array`; the grand product of all the AIR's
    arguments in one launch against `calculate_z` of each, and of random
    base and GL3 operands at 2^10, 2^17, 2^20 and 2^20 + 37, at the
    tiles' and look-back windows' edges (all four dim pairs a launch) and
    with a zero den in the first, the last and a later tile's row; each
    timed beside its twin and its bound (`dag_bound`,
    `grand_product_bound`), the grand product also beside its time
    before the redesign (`GP_MS_BEFORE`) with its registers and launch
    shape;
 5c. the recursion over it (`run_recursion`): batch B, the generator's
    next ROM (seed `ROM_SEED` + 1) over the state batch A (phase 5b's)
    left, executed and proved under torch.profiler (its prove's seconds,
    phases, device events, busy time, idle share and top device ops
    beside A's first prove) and verified, its publics chained on A's;
    then `Prover(device="cuda")`:
    `wrap_batch_recursive` of A and of B (recursive1, its circuit at the
    smallest power of two that holds it, `gl_circuit.rows_needed`) and
    `aggregate_recursive` of the two nodes (recursive2, the publics
    chained in the circuit); `verify_recursive` true for both r1 nodes
    and the r2 root, a tampered r1 and a tampered r2 proof rejected, the
    reversed pair raising ValueError. Logged: each circuit's gates, hash
    claims, publics and rows; the host seconds of synthesis, compile_air,
    setup and trace; each outer prove's seconds, phases and peak device
    memory; the proof sizes. Counters zeroed before the first wrap, read
    after the last verify: the fused Merkle kernel, mxu96 and the two
    STARK kernels must have run, and no other mode's kernel;
 5d. the SNARK wrap (`run_final_wrap`) at the JAX package's final-proof
    test shape: two chained memory batches through `Prover(n_bits=
    {"memory": 6}, n_queries=3, device="cuda")`, `gen_aggregated_proof`,
    then `gen_final_proof(agg)` (stark-verify) under torch.profiler:
    `compress_proof` of each batch (BN128), `build_join` (one R1CS that
    verifies both STARKs), `groth16_setup` (its CRS on the fixed-base
    kernel) and `groth16_prove` (the quotient on the Fr NTT kernels, five
    MSMs on the MSM kernels); `verify_final_proof` true, a proof with
    stark_publics[0] + 1 and one with pi_a + G1 rejected. Logged: the
    circuit's constraints, signals and domain, the host seconds (compress,
    build_join, `_qap_evals`, the CRS scalars, `eval_lc`, the packing) and
    the card seconds (CRS, NTTs, each MSM), device busy and idle share,
    peak memory. Counters zeroed just before gen_final_proof: the four
    BN254 kernel families must have run;
 5. the co-processor batch at 2^`--bits` (17 since the SNARK wrap
    joined, 18 since the recursion joined, 19 before, 20 until the
    combined batch joined, each cut to keep the run inside its time
    limit; arith at 2^`--arith-bits`, 18 since the
    SNARK wrap joined, 19 before) under
    `poseidon_cuda.MODE = "mxu96"` — every ported SM filled to its capacity
    less one group (`executor.examples.full_batch`) in a `ProofInput`,
    executed, checkpointed and proved through the entry point,
    `Prover(n_bits=..., device="cuda").gen_batch_proof(inp,
    save_cm_pols=PATH)`, then `verify_batch_proof`; the publics
    (new batch number = old + 1; newAccInputHash = what
    `PublicInputs.acc_input_hash()` gives, the entry point's plumbing, and
    = the JAX package's value pinned for these publics, the recurrence)
    checked and a tampered proof of each SM rejected; the Prover's timers
    (EXECUTOR_EXECUTE_BATCH_PROOF, STARK_PROOF_BATCH_PROOF,
    SAVE_CM_POLS_BATCH_PROOF) beside the script's clock, the checkpoint's
    size, and per SM its AIR's host seconds, its setup's, its prove's wall
    and phases and its peak device memory. Every kernel counter (the
    hash kernels' too, on every path) is zeroed just before the
    `gen_batch_proof` and read just after `verify_batch_proof`: the fused
    Merkle kernel (every commit) and the mxu96 permutation (the verifier's
    paths) must both have run, and no other mode's kernel;
 6. the checkpoint: `load_commit_pols(PATH)` gives back every SM's trace,
    equal to the traces proved; then every mode on the path: mem_align's
    full-width trace resumed from a mem_align-only checkpoint through
    `gen_batch_proof_from_commit` under mxu96 (commits through the fused
    Merkle kernel) and re-proved under every other mode (through that
    mode's permutation and never the fused kernel), counters zeroed before
    and read after each; every proof must equal phase 5's byte for byte;
 7. no plain chain ran on the card's paths; a kernels line (JSON: each
    mode's kernel, the fused Merkle kernel, the three hash kernels, the
    six BN254 kernel families and the two STARK kernels, its launches on
    the main paths, summed and by path (the co-processor batch, the state
    tree, the storage batch, the hash batch, the combined batch, the
    recursion; the BN254 kernels' on the final wrap, the STARK kernels'
    there too; Blake2b's are 0 on every path, since nothing calls it
    outside its checks), its time, its bound and its plain version's
    time) and a final line {"ok": true, "device": {...}}. Every path that
    proves a STARK must read launches of both STARK kernels.

It needs the CUDA toolkit (nvcc) and one card; without CUDA it exits
nonzero before printing anything.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): 3.35 TB/s HBM; 1,979 TOP/s
# int8 on the tensor cores; 67 TFLOP/s float32 outside them = 128
# FMA/clk/SM x 132 SMs x 1.98 GHz. sm_90 runs 32-bit integer multiply-adds
# at half the FMA rate (64/clk/SM, NVIDIA's throughput table for compute
# capability 9.0): 16.75e12 IMAD/s.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 2 / 2
INT8_OPS_PER_S = 1979e12

# The least work of one Poseidon-GL permutation on this card, the same for
# every mode since every mode computes the same function. The MDS runs on
# the tensor cores (as the mxu and mxu24 kernels show), so the CUDA cores
# need integer multiplies for the S-boxes alone: 118 S-boxes x (2 squarings
# of 3 widening 32x32 products + 2 products of 4), 2 IMAD each. The MDS as
# exact u8 products of the 8 byte planes of a 64-bit lane, with the sparse
# partial-round factorisation: 8 full rounds x 144 plus 22 partial rounds x
# 23 multiply-adds per plane, 2 operations each. The two units run at once.
POSEIDON_IMAD = 118 * (2 * 3 + 2 * 4) * 2
POSEIDON_TENSOR_OPS = (8 * 144 + 22 * 23) * 8 * 2


def _bound(perms: int, n_bytes: int) -> tuple[float, str]:
    ops_s = max(perms * POSEIDON_IMAD / IMAD_PER_S,
                perms * POSEIDON_TENSOR_OPS / INT8_OPS_PER_S)
    bytes_s = n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


# The least work of the hash kernels (csrc/hash.cu): 32-bit logic, shift
# and add operations, at the rate of sm_90's 32-bit integer pipe (64
# operations/clk/SM, the IMAD rate above). Keccak-f per round: theta's
# column parities 5 lanes x 2 halves x 2 three-input XORs, its rotations by
# one 5 x 2 funnel shifts and its application 25 x 2 three-input XORs, rho
# 24 x 2 funnel shifts, chi 25 x 2 LOP3s, iota 2 XORs: 180, x 24 rounds.
# SHA-256: the schedule's 48 words x (sigma0 and sigma1 each 2 rotations, a
# shift and a three-input XOR; 2 three-input adds), 64 rounds x (Sigma1 and
# Sigma0 each 3 rotations and a three-input XOR, Ch and Maj one LOP3 each,
# 4 three-input adds), 8 feed-forward adds. Every word moves as an int64:
# Keccak 25 in and 25 out, SHA-256 24 in and 8 out.
# Blake2b, per G quarter-round: two three-operand 64-bit sums (an
# add-with-carry pair each), two two-operand sums (a pair each), four
# 64-bit XORs (one LOP3 per half), the rotations by 24 and 16 one PRMT per
# half, by 63 one funnel shift per half, by 32 none (a swap of the
# halves): 22; 8 G per round, 12 rounds; the counter's XOR (2), the flag's
# negation and XOR (4), the output's three-input XORs 8 x 2. Words move as
# int64s: h 8, m 16, t 1 in, 8 out, and the flag's byte.
INT_OPS_PER_S = IMAD_PER_S
KECCAK_OPS = 24 * (5 * 2 * 2 + 5 * 2 + 25 * 2 + 24 * 2 + 25 * 2 + 2)
SHA256_OPS = 48 * (2 * 4 + 2) + 64 * (2 * 4 + 2 + 4) + 8
BLAKE2B_OPS = 12 * 8 * (2 * 2 + 2 * 2 + 4 * 2 + 3 * 2) + 2 + 4 + 8 * 2
KECCAK_BYTES = 25 * 8 * 2
SHA256_BYTES = (8 + 16 + 8) * 8
BLAKE2B_BYTES = (8 + 16 + 1 + 8) * 8 + 1


def _int_bound(n: int, ops: int, n_bytes: int) -> tuple[float, str]:
    ops_s = n * ops / INT_OPS_PER_S
    bytes_s = n * n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def keccak_bound(n: int) -> tuple[float, str]:
    """(least ms, what bounds it) for n Keccak-f permutations."""
    return _int_bound(n, KECCAK_OPS, KECCAK_BYTES)


def sha256_bound(n: int) -> tuple[float, str]:
    """(least ms, what bounds it) for n SHA-256 compressions."""
    return _int_bound(n, SHA256_OPS, SHA256_BYTES)


def blake2b_bound(n: int) -> tuple[float, str]:
    """(least ms, what bounds it) for n Blake2b compressions."""
    return _int_bound(n, BLAKE2B_OPS, BLAKE2B_BYTES)


def poseidon_bound(h: int) -> tuple[float, str]:
    """(least ms, what bounds it) for h permutations: each state read and
    written once against the slower unit's operations."""
    return _bound(h, h * 12 * 8 * 2)


def merkle_perms(h: int, w: int) -> int:
    """Permutations in the Merkle tree of a (h, w) source: ceil(w / 8) per
    row when w > 4 (narrower rows are copied), and h - 1 for the levels."""
    return h * (-(-w // 8) if w > 4 else 0) + h - 1


def merkle_bound(h: int, w: int) -> tuple[float, str]:
    """(least ms, what bounds it) for the tree of a (h, w) source: its
    permutations against the source read once and 2h - 1 digests written."""
    return _bound(merkle_perms(h, w), h * w * 8 + 32 * (2 * h - 1))


# The least work of the STARK kernels (csrc/stark.cu), in 32-bit multiply-
# adds at the IMAD rate: a field product is a widening 64 x 64 product,
# four 32 x 32 products of 2 IMADs (lo and hi) each; a GL3 product at
# least 6 of them (Karatsuba), a base x GL3 one 3. A row program's
# products per row are its MUL instructions so counted; its bytes every
# column it loads read once and every output column written once, per
# row. A grand-product element needs at least 3 products of den's field
# for the batch inversion (Montgomery's trick), one for num / den and one
# for the running product, against num, den and z moved once.
FIELD_PRODUCT_IMAD = 4 * 2


def _products(da: int, db: int) -> int:
    """Base-field products in the least product of a dim-da and a dim-db
    value."""
    return {(1, 1): 1, (1, 3): 3, (3, 1): 3, (3, 3): 6}[(da, db)]


# dag_eval_kernel's times in phase 3e before its Hopper redesign (the
# interpreter with per-thread slots in local memory and strided section
# loads, NVIDIA H100 80GB HBM3 at 700 W), logged beside this run's
DAG_MS_BEFORE = {"quotient": 529.70, "fri": 66.90, "f_t": 4.58,
                 "num_den": 8.41, "num_den_ragged": 8.44}
# grand_product's time in phase 3e on the AIR's 64 arguments before its
# Hopper redesign (three passes, a Fermat inverse an element; NVIDIA H100
# 80GB HBM3 at 700 W), logged beside this run's
GP_MS_BEFORE = 2.806


def dag_bound(prog, rows: int) -> tuple[float, str]:
    """(least ms, what bounds it) for `prog` (a stark.dag.Program) over
    `rows` rows: the products of its MUL and fused instructions; every
    (section, column)
    among its leaf words read once, whether on the row or the next one."""
    from zkevm_prover_tpu_torch.stark import dag

    products, out_cols = 0, 0
    for op in prog.code[:, 0].tolist():
        dims = dag.product_dims(op)
        if dims is not None:
            products += _products(*dims)
        elif op in (dag.STORE1, dag.STORE3, dag.STORE13):
            out_cols += 1 if op == dag.STORE1 else 3
    cols = {(s, c) for s, c, _ in prog.leaves.tolist()}
    ops_s = rows * products * FIELD_PRODUCT_IMAD / IMAD_PER_S
    bytes_s = rows * (len(cols) + out_cols) * 8 / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


def grand_product_bound(n: int, dims) -> tuple[float, str]:
    """(least ms, what bounds it) for grand products of n rows, one per
    (num dim, den dim) in `dims`."""
    products = sum(3 * _products(dd, dd) + _products(nd, dd)
                   + _products(3, max(nd, dd)) for nd, dd in dims)
    n_bytes = sum(nd + dd + 3 for nd, dd in dims) * 8
    ops_s = n * products * FIELD_PRODUCT_IMAD / IMAD_PER_S
    bytes_s = n * n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                       else "bytes")


# log2 keys of the storage batch's pre-state tree: a state of a million
# accounts and storage slots
TREE_BITS = 20
# log2 rows of the combined batch AIR (phase 5b; reference: 23; 17 binds
# the same SMs as 16 and is the widest that fits the card) and its seed
ROM_BITS = 17
ROM_SEED = 23

# artifacts/bench/measure_baseline_r05.json: exact field results
R05_CHECKSUM = 16096883102802302962   # poseidon, default_rng(1) (2^20, 12)
R05_NTT_CHECKSUM = 8023521091960532272  # extend_pol, default_rng(0) (2^23, 4)


_T0 = time.perf_counter()


def _counters() -> tuple:
    """Every kernel counter a proving path reads: the Poseidon modes' and
    the fused commit's, the hash kernels', the STARK kernels'."""
    from zkevm_prover_tpu_torch.ops import hash_cuda, poseidon_cuda, stark_cuda

    return poseidon_cuda.launches, hash_cuda.launches, stark_cuda.launches


def _stark_kernels_ran(path: str, launches: dict) -> None:
    """A proving path must have evaluated its phases' programs through
    dag_eval_kernel and its grand products through grand_product."""
    if launches["dag_eval"] == 0 or launches["grand_product"] == 0:
        _fail(f"{path}: the STARK kernels did not run: {launches}")


def _log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _time_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# pallas_call builder each mode's kernel replaces, and its source
MODE_KERNELS = {
    "mxu96": ("zkevm_prover_tpu/ops/poseidon_pallas.py:314",
              "zkevm_prover_tpu_torch/csrc/poseidon_gl.cu"),
    "mxu24": ("zkevm_prover_tpu/ops/poseidon_pallas.py:159",
              "zkevm_prover_tpu_torch/csrc/poseidon_gl_mxu24.cuh"),
    "mxu": ("zkevm_prover_tpu/ops/poseidon_pallas.py:594",
            "zkevm_prover_tpu_torch/csrc/poseidon_gl_mxu.cuh"),
    "blocked": ("zkevm_prover_tpu/ops/poseidon_pallas.py:532",
                "zkevm_prover_tpu_torch/csrc/poseidon_gl_blocked.cuh"),
    "1d": ("zkevm_prover_tpu/ops/poseidon_pallas.py:75",
           "zkevm_prover_tpu_torch/csrc/poseidon_gl_1d.cuh"),
    "2d": ("zkevm_prover_tpu/ops/poseidon_pallas.py:450",
           "zkevm_prover_tpu_torch/csrc/poseidon_gl_2d.cuh"),
}
# m16n8k32 MMAs per permutation and their useful share of multiply-adds:
# mxu (csrc/poseidon_gl_mxu.cuh) 8 full rounds x 8 planes x 2 n8 tiles / 16
# states, 16 x 144 of 2 x 4096; mxu24 (csrc/poseidon_gl_mxu24.cuh) 8 full
# rounds x 4 plane pairs x 3 n8 tiles / 16 states, 16 x 2 x 144 of
# 3 x 4096
MMA_PER_PERM = {"mxu": (8.0, 2304 / 8192), "mxu24": (6.0, 4608 / 12288)}


def check_poseidon(torch, gl, pg, pcu) -> dict:
    """Every mode's kernel against plain on the card; returns the kernels-line
    entry of each mode (without `launches`)."""
    rng = np.random.default_rng(1)   # the r05 input, tools/measure_baseline.py
    r05 = rng.integers(0, gl.P, size=(1 << 20, 12), dtype=np.uint64)
    small = np.random.default_rng(3).integers(0, gl.P, size=(515, 12),
                                              dtype=np.uint64)
    edges = np.stack([np.zeros(12, np.uint64), np.full(12, gl.P - 1, np.uint64)])
    # the main path's largest batch: one leaf chunk of a 2^22-row section
    big = np.random.default_rng(4).integers(0, gl.P, size=(1 << 22, 12),
                                            dtype=np.uint64)
    ragged = np.random.default_rng(5).integers(
        0, gl.P, size=((1 << 20) + 37, 12), dtype=np.uint64)
    cases = [("r05 (2^20, 12)", r05), ("515 random + edge states",
                                       np.concatenate([small, edges])),
             ("(2^22, 12)", big), ("ragged (2^20 + 37, 12)", ragged)]
    for what, states_np in cases:
        x = gl.from_u64(states_np, "cuda")
        plain = pg.permute_plain(x)
        for mode in pcu.MODES:
            k = pcu.ENTRY[mode](x)
            torch.cuda.synchronize()
            if not torch.equal(k, plain):
                bad = (k != plain).any(dim=1).nonzero()[:4, 0].tolist()
                _fail(f"poseidon {mode} kernel != plain on {what}, rows {bad}")
            if states_np is r05:
                got = int(gl.to_u64(k[0, 0:1])[0])
                if got != R05_CHECKSUM:
                    _fail(f"{mode}: r05 checksum {got} != {R05_CHECKSUM}")
            del k
        del x, plain
    _log(f"poseidon: every mode's kernel ({', '.join(pcu.MODES)}) == plain "
         f"on r05, 515+2, 2^22 and 2^20 + 37 states; r05 out[0,0] = "
         f"{R05_CHECKSUM}")
    for mode, (mmas, useful) in MMA_PER_PERM.items():
        _log(f"poseidon {mode}: {mmas} m16n8k32 MMAs per permutation, "
             f"{100 * useful:.1f} % of their multiply-adds useful")
    _log(f"poseidon bound per permutation, every mode: {POSEIDON_IMAD} IMAD "
         f"(S-boxes, CUDA cores), {POSEIDON_TENSOR_OPS} int8 operations "
         "(MDS, tensor cores), 192 bytes")

    times = {mode: {} for mode in pcu.MODES}
    alone = {mode: {} for mode in pcu.MODES}
    plain_times = {}
    for bits in (10, 16, 20, 22):
        x = gl.from_u64(big[:1 << bits], "cuda")
        bound_ms, bound_by = poseidon_bound(1 << bits)
        plain_times[bits] = _time_ms(lambda: pg.permute_plain(x), reps=2)
        line = []
        for mode in pcu.MODES:
            fn = pcu.ENTRY[mode]
            times[mode][bits] = _time_ms(lambda: fn(x))
            line.append(f"{mode} {times[mode][bits]:.4f} "
                        f"({100 * bound_ms / times[mode][bits]:.1f} %)")
        _log(f"poseidon 2^{bits} states, ms (share of bound): "
             f"{', '.join(line)}; plain {plain_times[bits]:.3f}; bound "
             f"{bound_ms:.4f} ({bound_by})")
        line = []
        for mode in pcu.MODES:
            laid = x.T.contiguous() if mode == "1d" else x
            out = torch.empty_like(laid)
            alone[mode][bits] = _time_ms(lambda: pcu.launch(mode, laid, out))
            ms = alone[mode][bits]
            line.append(f"{mode} {ms:.4f} ({100 * bound_ms / ms:.1f} %; "
                        f"entry - alone {times[mode][bits] - ms:.4f})")
            del laid, out
        _log(f"poseidon 2^{bits} states, kernel alone on its own layout, ms "
             f"(share of bound; entry point - alone): {', '.join(line)}")
        ratios = [f"{mode} {alone[mode][bits] / alone['mxu96'][bits]:.4f}"
                  for mode in pcu.MODES if mode != "mxu96"]
        _log(f"poseidon 2^{bits} states, kernel alone / mxu96 alone: "
             f"{', '.join(ratios)}; mxu24 alone / mxu alone: "
             f"{alone['mxu24'][bits] / alone['mxu'][bits]:.4f}")
    entries = {}   # at 2^22 states, the last size timed
    for mode in pcu.MODES:
        replaces, source = MODE_KERNELS[mode]
        entries[mode] = {
            "name": f"poseidon_gl_permute_{mode}", "route": "cuda",
            "source": source, "replaces": replaces, "max_abs_err": 0,
            "ms": times[mode][22], "plain_ms": plain_times[22],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_imad_per_perm": POSEIDON_IMAD,
            "bound_int8_ops_per_perm": POSEIDON_TENSOR_OPS,
            "library_ms": None, "kernel_alone_ms": alone[mode][22]}
    return entries


def check_merkle(torch, gl, pcu) -> dict:
    """The fused Merkle commit on the card: every level bit for bit against
    the plain tree at 2^22 x 48 and against the chunked tree through kernel
    1 at 2^21 x 189, each timed; returns the kernels-line entry (without
    `launches`), at 2^22 x 48."""
    from zkevm_prover_tpu_torch.ops import merkle

    def chunked(src):
        return merkle.merkelize_levels_chunked(src, pcu.permute_mxu96)

    entry = None
    for (bits, w), against in (((22, 48), "plain"), ((21, 189), "chunked")):
        h = 1 << bits
        src = gl.from_u64(np.random.default_rng(bits + w).integers(
            0, gl.P, size=(h, w), dtype=np.uint64), "cuda")
        before = pcu.launches["merkle"]
        fused = pcu.merkle_levels(src)
        torch.cuda.synchronize()
        plan = pcu.merkle_plan(h, w)
        if pcu.launches["merkle"] - before != len(plan):
            _fail(f"merkle 2^{bits} x {w}: {pcu.launches['merkle'] - before} "
                  f"launches, plan {plan}")
        ref = (merkle.merkelize_levels_plain if against == "plain"
               else chunked)(src)
        if len(fused) != len(ref) or not all(
                torch.equal(a, b) for a, b in zip(fused, ref)):
            _fail(f"merkle 2^{bits} x {w}: fused levels != {against} levels")
        del fused, ref
        fused_ms = _time_ms(lambda: pcu.merkle_levels(src), reps=5)
        chunked_ms = _time_ms(lambda: chunked(src), reps=3)
        plain_ms = (_time_ms(lambda: merkle.merkelize_levels_plain(src),
                             reps=1) if against == "plain" else None)
        bound_ms, bound_by = merkle_bound(h, w)
        plain_txt = f"{plain_ms:.2f}" if plain_ms is not None else "not timed"
        _log(f"merkle 2^{bits} x {w}: fused == {against} on every level; "
             f"fused {fused_ms:.4f} ms ({len(plan)} launches, "
             f"{100 * bound_ms / fused_ms:.1f} % of bound), chunked through "
             f"kernel 1 {chunked_ms:.4f} ms, plain {plain_txt} ms; bound "
             f"{bound_ms:.4f} ms ({bound_by}, {merkle_perms(h, w)} "
             "permutations)")
        if fused_ms >= chunked_ms:
            _fail(f"merkle 2^{bits} x {w}: fused {fused_ms:.4f} ms is not "
                  f"faster than chunked {chunked_ms:.4f} ms")
        if entry is None:
            entry = {
                "name": "poseidon_gl_merkle", "route": "cuda",
                "source": "zkevm_prover_tpu_torch/csrc/poseidon_gl.cu",
                "replaces": "zkevm_prover_tpu/ops/merkle.py:39",
                "max_abs_err": 0, "ms": fused_ms, "plain_ms": plain_ms,
                "chunked_ms": chunked_ms, "shape": [h, w],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}
        del src
        torch.cuda.empty_cache()
    return entry


def check_ntt(torch, gl) -> None:
    """The LDE (plain torch on the card) at the reference's unit, 2^23 -> 2^24
    rows x 4 columns, against the pinned r05 checksum."""
    from zkevm_prover_tpu_torch.ops import ntt

    rng = np.random.default_rng(0)   # tools/measure_baseline.py:61-85
    x = gl.from_u64(rng.integers(0, gl.P, size=(1 << 23, 4), dtype=np.uint64),
                    "cuda")
    ntt.extend_pol(x, 23, 24)   # warm-up: twiddle tables, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e = ntt.extend_pol(x, 23, 24)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = int(gl.to_u64(e[0, 0:1])[0])
    if got != R05_NTT_CHECKSUM:
        _fail(f"extend_pol r05 checksum {got} != {R05_NTT_CHECKSUM}")
    _log(f"extend_pol 2^23 -> 2^24 x 4 (plain torch): {secs * 1e3:.1f} ms; "
         f"e[0,0] = {got}")


# the program each hash kernel replaces (XLA-fused on the TPU, no
# pallas_call), and its source
HASH_KERNELS = {
    "keccak_f": ("zkevm_prover_tpu/ops/keccak.py:56", keccak_bound),
    "sha256_compress": ("zkevm_prover_tpu/ops/sha256.py:40", sha256_bound),
    "blake2b_compress": ("zkevm_prover_tpu/ops/blake.py:93", blake2b_bound),
}


def check_hash(torch, gl) -> dict:
    """The Keccak-f, SHA-256 and Blake2b kernels against their plain twins
    on the card (515 random and 2^20 + 37 instances; Blake2b's with both
    flags and the counter at 0, 128 and 2^64 - 1) and the host oracles,
    each timed at 2^10, 2^16, 2^20 and 2^22 instances; returns the
    kernels-line entry of each (without `launches`)."""
    import hashlib

    from zkevm_prover_tpu_torch.ops import blake, keccak, sha256

    def inputs(name, n, seed):
        rng = np.random.default_rng(seed)
        if name == "keccak_f":
            return (gl.from_u64(rng.integers(0, 1 << 64, (n, 25),
                                             dtype=np.uint64), "cuda"),)
        if name == "blake2b_compress":
            t = rng.integers(0, 1 << 64, n, dtype=np.uint64)
            t[:3] = (0, 128, (1 << 64) - 1)
            last = rng.integers(0, 2, n).astype(bool)
            last[:2] = (False, True)
            return tuple(gl.from_u64(rng.integers(0, 1 << 64, (n, w),
                                                  dtype=np.uint64), "cuda")
                         for w in (8, 16)) + (
                gl.from_u64(t, "cuda"), torch.as_tensor(last, device="cuda"))
        return tuple(gl.from_u64(rng.integers(0, 1 << 32, (n, w),
                                              dtype=np.uint64), "cuda")
                     for w in (8, 16))

    fns = {"keccak_f": (keccak.keccak_f, keccak.keccak_f_plain),
           "sha256_compress": (sha256.sha256_compress,
                               sha256.sha256_compress_plain),
           "blake2b_compress": (blake.blake2b_compress,
                                blake.blake2b_compress_plain)}
    for name, (kernel, plain) in fns.items():
        for n, seed in ((515, 60), ((1 << 20) + 37, 61)):
            args = inputs(name, n, seed)
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).any(dim=1).nonzero()[:4, 0].tolist()
                _fail(f"{name} kernel != plain on {n} instances, rows {bad}")
            del args, got, want
    states = np.random.default_rng(62).integers(0, 1 << 64, (64, 25),
                                                dtype=np.uint64)
    out = gl.to_u64(keccak.keccak_f(gl.from_u64(states, "cuda")))
    for row, got in zip(states, out):
        if [int(v) for v in got] != keccak._keccak_f_host(
                [int(v) for v in row]):
            _fail("keccak_f kernel != _keccak_f_host")
    rng = np.random.default_rng(63)
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 56, 64)]
    blocks = np.zeros((64, 64), dtype=np.uint8)
    for i, m in enumerate(msgs):
        blocks[i, :len(m)] = bytearray(m)
        blocks[i, len(m)] = 0x80
        blocks[i, 56:] = np.frombuffer((8 * len(m)).to_bytes(8, "big"),
                                       dtype=np.uint8)
    digests = sha256.sha256_blocks(blocks, device="cuda").cpu().numpy()
    if any(bytes(d) != hashlib.sha256(m).digest()
           for m, d in zip(msgs, digests)):
        _fail("sha256_blocks on the card != hashlib")
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 129, 64)]
    if blake.blake2b_256_many(msgs, device="cuda") != [
            hashlib.blake2b(m, digest_size=32).digest() for m in msgs]:
        _fail("blake2b_256_many on the card != hashlib")
    for n in (0, 1, 127, 128, 129, 1000):
        data = rng.bytes(n)
        if blake.blake2b_256(data, device="cuda") != hashlib.blake2b(
                data, digest_size=32).digest():
            _fail(f"blake2b_256 of {n} bytes on the card != hashlib")
    _log("hash: keccak_f, sha256_compress and blake2b_compress kernels == "
         "plain on 515 and 2^20 + 37 instances; keccak_f == _keccak_f_host "
         "on 64 states, sha256_blocks == hashlib on 64 single-block "
         "messages, blake2b_256_many == hashlib on 64 single-block "
         "messages and blake2b_256 on 0, 1, 127, 128, 129 and 1000 bytes")
    _log(f"hash bounds per instance: keccak_f {KECCAK_OPS} 32-bit "
         f"operations, {KECCAK_BYTES} bytes; sha256_compress {SHA256_OPS} "
         f"operations, {SHA256_BYTES} bytes; blake2b_compress "
         f"{BLAKE2B_OPS} operations, {BLAKE2B_BYTES} bytes; "
         f"{INT_OPS_PER_S:.4g} operations/s, 3.35 TB/s")

    entries = {}
    for name, (kernel, plain) in fns.items():
        replaces, bound = HASH_KERNELS[name]
        times, plain_times, bounds = {}, {}, {}
        for bits in (10, 16, 20, 22):
            args = inputs(name, 1 << bits, 64 + bits)
            times[bits] = _time_ms(lambda: kernel(*args))
            plain_times[bits] = _time_ms(lambda: plain(*args), reps=2)
            bounds[bits] = bound(1 << bits)
            _log(f"{name} 2^{bits} instances: kernel {times[bits]:.4f} ms "
                 f"({100 * bounds[bits][0] / times[bits]:.1f} % of bound), "
                 f"plain {plain_times[bits]:.3f} ms; bound "
                 f"{bounds[bits][0]:.4f} ms ({bounds[bits][1]})")
            del args
        entries[name] = {
            "name": f"hash_{name}", "route": "cuda",
            "source": "zkevm_prover_tpu_torch/csrc/hash.cu",
            "replaces": replaces, "max_abs_err": 0, "ms": times[22],
            "plain_ms": plain_times[22], "bound_ms": bounds[22][0],
            "bound_by": bounds[22][1], "library_ms": None,
            "ms_by_log2_size": times, "plain_ms_by_log2_size": plain_times}
    torch.cuda.empty_cache()
    return entries


# The least work of the BN254 kernels (csrc/bn254.cu), in 32-bit
# multiply-adds at the IMAD rate. One Montgomery product (bn254.cuh fmul,
# CIOS over 8 limbs) is 8 outer steps of 8 + 8 (a_i * b, lo and hi
# chains) + 1 (m) + 8 + 8 (m * p) = 264; a Montgomery reduction alone
# (the exit from Montgomery form) is 8 * (1 + 8 + 8) = 136. A mixed
# Jacobian + affine addition (madd-2007-bl) is 7 products and 4 squarings,
# a full one (add-2007-bl) 11 and 5. Over Fp2 a product is 3 Fp products
# (Karatsuba) and a squaring 2 (complex squaring), so the mixed addition
# is 29 Fp products and the full one 43, though bn254.cuh squares Fp2
# with its product. An Fp inversion is counted as the Fermat power, 256
# squarings and one product per set bit of p - 2 (bn254.cuh's binary
# extended Euclid runs about an eighth of those instructions; the bounds
# take few inversions); an Fp2 one adds 2 squarings and 2 products.
BN_MONT_IMAD = 8 * (8 + 8 + 1 + 8 + 8)
BN_REDC_IMAD = 8 * (1 + 8 + 8)
BN_MADD = {False: 7 + 4, True: 7 * 3 + 4 * 2}
BN_JADD = {False: 11 + 5, True: 11 * 3 + 5 * 2}
BN_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN_INV = 256 + bin(BN_P - 2).count("1")


def _bn_bound(products: float, n_bytes: float, redcs: float = 0
              ) -> tuple[float, str]:
    return _int_bound(1, products * BN_MONT_IMAD + redcs * BN_REDC_IMAD,
                      n_bytes)


# The least work of an MSM takes batch-affine additions (the kernels add
# in XYZZ coordinates, bn254_device.MSM_MADD / MSM_ADD, which cost more):
# lambda = (y2 - y1) / (x2 - x1), x3 = lambda^2 - x1 - x2,
# y3 = lambda (x1 - x3) - y1 is 2 products and a squaring, and an
# addition's share of its batch's inversion by Montgomery's trick 3
# products, so 6 Fp products; over Fp2 5 products and a squaring, 17. Each
# batch adds one inversion (BN_INV; over Fp2 4 more).
BN_AFFINE_ADD = {False: 5 + 1, True: 5 * 3 + 2}
# the MSM's times in phase 3d before its Hopper redesign (unsigned
# windows of at most 13 bits, torch.sort of 64-bit keys, one block a window
# in the reduction; NVIDIA H100 80GB HBM3 at 700 W), each logged beside
# this run's bound
MSM_MS_BEFORE = {"g1_msm": {10: 4.7104, 16: 11.3367, 20: 23.2291,
                            22: 62.0796},
                 "g2_msm": {10: 22.6662, 16: 45.082, 20: 89.6142}}


def msm_bound(scalars, points, g2: bool) -> tuple[float, str, int]:
    """(least ms, what bounds it, the window it takes) for an MSM over
    `points` with `scalars` (card tensors): the least over window widths c
    of the signed-digit Pippenger's products, from this run's digits. Each
    bucket sums its points (the nonzero digits of points not at infinity)
    as a pairwise tree of batch-affine additions, k points in k - 1
    additions, one batch a level; the running sums take 2 additions a
    bucket, in XYZZ with no inversion or batch-affine with one batch a
    bucket across the windows, whichever is less. Against the points and
    scalars read once."""
    import torch

    from zkevm_prover_tpu_torch.ops import bn254_device as bd

    n = scalars.shape[0]
    live = scalars[(points.reshape(n, -1) != 0).any(-1)]
    add, inv = BN_AFFINE_ADD[g2], BN_INV + (4 if g2 else 0)
    best = None
    for c in range(2, bd.MSM_MAX_WINDOW + 1):
        nwin, nb = bd.msm_windows(c), 1 << (c - 1)
        base = torch.arange(nwin, device=scalars.device) * nb - 1
        counts = torch.zeros(nwin * nb, dtype=torch.int64,
                             device=scalars.device)
        for i in range(0, live.shape[0], 1 << 19):
            d = bd.signed_digits(live[i:i + (1 << 19)], c)
            counts += torch.bincount((base + d.abs())[d != 0],
                                     minlength=nwin * nb)
        acc = ((int(counts.sum()) - int((counts > 0).sum())) * add
               + (int(counts.max()) - 1).bit_length() * inv)
        sums = min(2 * nb * nwin * bd.MSM_ADD[g2],
                   2 * nb * nwin * add + nb * inv)
        if best is None or acc + sums < best[0]:
            best = (acc + sums, c)
    ms, by = _bn_bound(best[0], n * ((128 if g2 else 64) + 32))
    return ms, by, best[1]


# the fixed-base kernel's times in phase 3d before its Hopper redesign (64
# unsigned 4-bit windows, mixed Jacobian additions, the table in shared
# memory; NVIDIA H100 80GB HBM3 at 700 W), each logged beside this run's
# bound: at 2^16 / 2^20 / 2^22 scalars from the last full run before it,
# at the CRS's sizes ("crs") from the same-process A/B against that tree
# (msm_bench --parent)
FIXED_BASE_MS_BEFORE = {
    "g1_fixed_base": {16: 13.038, 20: 25.1022, 22: 101.1254,
                      "crs": 162.9311},
    "g2_fixed_base": {16: 37.7058, 20: 75.7357, 22: 302.9566,
                      "crs": 112.8172}}
# the Fr NTT's times before its redesign (a prologue, 10 shared-memory
# stages, one launch per later stage, an epilogue): the forward at
# 2^10 / 2^16 / 2^20 / 2^22 from the last full run before it; the chain's
# forms at 2^21 ("form:21") from the same-process A/B against that tree
FR_NTT_MS_BEFORE = {10: 0.1084, 16: 0.1282, 20: 1.0441, 22: 4.1327,
                    "intt:21": 2.2072, "ntt_coset:21": 3.6957,
                    "intt_post:21": 4.0521}
# the 2^21 CRS's scalars in phase 5d: every G1 query (3 + 3 x 1,514,670
# signals + 2^21 - 1), the b2 query and three points
FB_CRS = {False: 6_641_164, True: 1_514_673}


def fixed_base_bound(scalars, g2: bool) -> tuple[float, str, int]:
    """(least ms, what bounds it, the window it takes) for the fixed-base
    products of `scalars` (card tensors below r): the least over window
    widths c (2 to 24) of signed c-bit digits added from a table of the
    generator's multiples d 2^(c j) G, d = 1 .. 2^(c-1), a row a window.
    Each scalar takes one addition per nonzero digit after its first (this
    run's digits), the table (2^(c-1) - 1) additions a row and the rows'
    bases c doublings each (counted as additions); each addition
    batch-affine (BN_AFFINE_ADD, one inversion a batch: a window step
    across the scalars, a level of the table's build, a doubling of the
    bases) or mixed Jacobian (BN_MADD) with the normalisation of each
    output and table point (6 products and a squaring; 20 over Fp2) and one
    inversion, whichever is less; the outputs' exit from Montgomery form.
    Against the scalars read, the points written, one table point read per
    addition and the table written."""
    import torch

    from zkevm_prover_tpu_torch.ops import bn254_device as bd

    n = scalars.shape[0]
    pt = 128 if g2 else 64
    live = int((scalars != 0).any(-1).sum())
    add, inv = BN_AFFINE_ADD[g2], BN_INV + (4 if g2 else 0)
    norm = 6 * 3 + 2 if g2 else 7
    best = None
    for c in range(2, 25):
        nwin, nb = bd.msm_windows(c), 1 << (c - 1)
        nz = 0
        for i in range(0, n, 1 << 18):
            nz += int((bd.signed_digits(scalars[i:i + (1 << 18)], c) != 0)
                      .sum())
        adds = nz - live + nwin * (nb - 1) + c * (nwin - 1)
        affine = adds * add + (nwin + c + c * (nwin - 1)) * inv
        jac = adds * BN_MADD[g2] + (n + nwin * nb) * norm + inv
        ms, by = _bn_bound(min(affine, jac),
                           n * (32 + pt) + (nz - live) * pt + nwin * nb * pt,
                           (4 if g2 else 2) * n)
        if best is None or ms < best[0]:
            best = (ms, by, c)
    return best


def ntt_bound(n: int, inverse: bool = False, shift: bool = False,
              post: bool = False) -> tuple[float, str]:
    """(least ms, what bounds it) for one Fr NTT of n elements in the form
    the call takes: (n/2) log n butterflies of one product (twiddles kept
    in Montgomery form give ordinary-form products), and an element's
    product for each of the shift and the post and one for each one's
    power series, and one for the inverse's 1/n unless a post carries it
    (its series folds the constant in); against n elements read and
    written."""
    logn = n.bit_length() - 1
    per = 2 * shift + 2 * post + (inverse and not post)
    return _bn_bound(n // 2 * logn + n * per, n * 64)


def pointwise_bound(n: int) -> tuple[float, str]:
    """(a * b - c) * z: 2 products and 1 reduction an element (a b / R,
    c / R, then times z R^2), 3 elements read, 1 written."""
    return _bn_bound(2 * n, n * 128, n)


# what each BN254 kernel replaces: the JAX package's device program, or
# the host loop the port moved onto the card
BN254_KERNELS = {
    "g1_msm": "zkevm_prover_tpu/ops/bn254_device.py:390",
    "g2_msm": "zkevm_prover_tpu/ops/bn254_device.py:390",
    "g1_fixed_base": "zkevm_prover_tpu/snark/groth16.py:90",
    "g2_fixed_base": "zkevm_prover_tpu/snark/groth16.py:110",
    "fr_ntt": "zkevm_prover_tpu/ops/bn254.py:590",
    "fr_pointwise": "zkevm_prover_tpu/snark/groth16.py:151",
}


def _bn_entry(name: str, times: dict, plain: dict, bounds: dict,
              at: int) -> dict:
    """The kernels-line entry: ms, plain_ms and bound_ms at one size, 2^at
    (the largest at which the twin was timed), every size in the maps."""
    return {"name": f"bn254_{name}", "route": "cuda",
            "source": "zkevm_prover_tpu_torch/csrc/bn254.cu",
            "replaces": BN254_KERNELS[name], "max_abs_err": 0,
            "log2_size": at, "ms": times[at], "plain_ms": plain[at],
            "bound_ms": bounds[at][0], "bound_by": bounds[at][1],
            "library_ms": None, "ms_by_log2_size": times,
            "plain_ms_by_log2_size": plain,
            "bound_ms_by_log2_size": {k: v[0] for k, v in bounds.items()}}


def check_bn254(torch) -> dict:
    """The BN254 kernels (csrc/bn254.cu) against their plain twins on the
    card and the host oracles (ops/bn254.py), exact: the fixed-base
    products at 2^22 scalars (1,024 sampled against g1_mul_gen and
    g2_mul_gen), cold (the table built in the call) == warm at 2^16, 2^20,
    2^22 and the CRS's sizes; the G1 MSM at 2^10, 2^16, 2^20 and 2^22 points and the G2
    MSM at 2^10, 2^16 and 2^20, their bases k_i * G from the fixed-base
    kernel, so that the oracle is one g1_mul_gen(sum s_i k_i mod r); the
    MSMs against the host Pippenger at 2^10 (G2: the host's at 2^6) and the
    plain twins at 2^10 and 2^16, with zero scalars, scalars >= r,
    repeated points and a point beside its negation; the skewed sets; the
    sort's digits (`check_msm_digits`); the Fr NTT at 2^10,
    2^16, 2^20 and 2^22 (the plain twin at 2^10 and 2^16 with and without
    the coset shifts, inverse after forward the identity at every size,
    outputs at 2^22 against host Horner evaluations, the Groth16 chain's
    three forms at 2^21 against the twin); the pointwise step
    against its twin. Each timed beside its bound and its twin's time (at
    2^16, and the NTT and the pointwise step at 2^22; the MSM and
    fixed-base twins' tensor-wide steps make larger sizes slow); library
    time: none (no PyTorch call computes these). Returns the kernels-line
    entry of each (without `launches`), its ms, plain_ms and bound_ms at
    the largest size its twin was timed at."""
    from zkevm_prover_tpu_torch import card_bench
    from zkevm_prover_tpu_torch.ops import bn254 as host
    from zkevm_prover_tpu_torch.ops import bn254_cuda as bcu
    from zkevm_prover_tpu_torch.ops import bn254_device as bd
    from zkevm_prover_tpu_torch.ops import msm as msm_ops

    t_start = time.perf_counter()
    entries = {}
    R = host.R
    rng = np.random.default_rng(12)

    def ints(t):
        return bd.limbs_to_ints(t)

    # the CRS kernel: 2^22 scalars, 1,024 sampled indices on the host
    big = 22
    k = card_bench.random_fr(torch, 1 << big, 1)
    k[:3] = torch.from_numpy(bd.ints_to_limbs([0, 1, R - 1]).copy()).cuda()
    idx = torch.from_numpy(np.concatenate(
        [[0, 1, 2], rng.choice(1 << big, 1021, replace=False)])).cuda()
    kidx = ints(k[idx])
    for g2, name in ((False, "g1_fixed_base"), (True, "g2_fixed_base")):
        bcu.clear_fixed_base_tables()
        pts = bd.fixed_base(k, g2)
        torch.cuda.synchronize()
        got = (bd.unpack_g2 if g2 else bd.unpack_g1)(pts[idx])
        mul = host.g2_mul_gen if g2 else host.g1_mul_gen
        t0 = time.perf_counter()
        if got != [mul(v) for v in kidx]:
            _fail(f"{name}: a sampled point != the host's")
        host_s = time.perf_counter() - t0
        small = k[:1 << 10]
        if not torch.equal(bd.fixed_base(small, g2),
                           bd.fixed_base_plain(small, g2)):
            _fail(f"{name} != its plain twin at 2^10")
        crs = card_bench.random_fr(torch, FB_CRS[g2], 3 + g2)
        times, cold, plain, bounds = {}, {}, {}, {}
        for bits in (16, 20, 22, "crs"):
            kb = crs if bits == "crs" else k[:1 << bits]
            cold[bits], out = card_bench.cold_ms(
                torch, lambda: bd.fixed_base(kb, g2),
                bcu.clear_fixed_base_tables, reps=3)
            if not torch.equal(out, bd.fixed_base(kb, g2)):
                _fail(f"{name} {bits}: a cold call != a warm one")
            del out
            times[bits] = _time_ms(lambda: bd.fixed_base(kb, g2),
                                   reps=3 if bits in (22, "crs") else 10)
            bounds[bits] = fixed_base_bound(kb, g2)
        del crs
        kb = k[:1 << 16]
        plain[16] = _time_ms(lambda: bd.fixed_base_plain(kb, g2), reps=1)
        before = FIXED_BASE_MS_BEFORE[name]
        plan = {b: bcu.fixed_base_plan(FB_CRS[g2] if b == "crs" else 1 << b,
                                       g2)["c"] for b in times}
        _log(f"{name}: 2^22 scalars, 1,024 sampled == the host's "
             f"({host_s:.1f} s host), 2^10 == the plain twin; sizes 2^16, "
             f"2^20, 2^22 and the CRS's {FB_CRS[g2]}; kernel ms warm "
             + json.dumps({b: round(v, 4) for b, v in times.items()})
             + ", cold (table built in the call) " + json.dumps(
                 {b: round(v, 4) for b, v in cold.items()})
             + ", the kernel's window " + json.dumps(plan)
             + ", bound ms, by, window " + json.dumps(
                 {b: [round(v[0], 4), v[1], v[2]] for b, v in bounds.items()})
             + ", share of the bound cold, warm " + json.dumps(
                 {b: [round(bounds[b][0] / cold[b], 4),
                      round(bounds[b][0] / v, 4)] for b, v in times.items()})
             + ", before the redesign ms and share " + json.dumps(
                 {b: [v, round(bounds[b][0] / v, 4) if v else None]
                  for b, v in before.items()})
             + f", plain 2^16 {plain[16]:.1f} ms")
        entries[name] = _bn_entry(name, times, plain, bounds, 16)
        entries[name]["cold_ms_by_log2_size"] = cold
        if g2:
            bases2 = pts[:1 << 20].clone()
        else:
            bases1 = pts
        del pts
    torch.cuda.empty_cache()

    # the MSMs over those bases: s random, the oracle sum s_i k_i mod r
    # (the plain twins' Fr products on the card, summed exactly)
    s = card_bench.random_fr(torch, 1 << big, 2)

    def fr_dot(a, b):
        prod = bd.f_mul(bd.FR, bd.f_from_u32(a), bd.f_from_u32(b))
        return ints(bd.f_to_u32(bd.FR, prod.sum(0, keepdim=True)))[0]

    for g2, name, sizes, skew in ((False, "g1_msm", (10, 16, 20, 22), 21),
                                  (True, "g2_msm", (10, 16, 20), 20)):
        bases = bases2 if g2 else bases1
        msm = bd.g2_msm if g2 else bd.g1_msm
        unpack = bd.unpack_g2 if g2 else bd.unpack_g1
        mul = host.g2_mul_gen if g2 else host.g1_mul_gen
        times, plain, bounds = {}, {}, {}
        for bits in sizes:
            n = 1 << bits
            got = unpack(msm(bases[:n], s[:n]))[0]
            want = mul(fr_dot(k[:n], s[:n]))
            if got != want:
                _fail(f"{name} 2^{bits} != g*_mul_gen(sum s_i k_i)")
            if bits in (10, 16):
                p = msm_plain_checked(torch, bd, bases[:n], s[:n], g2, got,
                                      name, bits)
                if bits == 16:
                    plain[bits] = p
            times[bits] = _time_ms(lambda: msm(bases[:n], s[:n]),
                                   reps=3 if bits >= 20 else 10)
            bounds[bits] = msm_bound(s[:n], bases[:n], g2)
        check_msm_digits(torch, bd, bases[:1 << 16], s[:1 << 16], g2, name)
        # the witness-like skewed set (card_bench.skewed_scalars: half the
        # scalars 0 or 1, a quarter below 2^64, a quarter dense), about one
        # base in 64 at infinity (k_i = 0)
        ks = card_bench.skewed_bases_k(torch, 1 << skew, 70 + skew)
        ss = card_bench.skewed_scalars(torch, 1 << skew, 80 + skew)
        bs = bd.fixed_base(ks, g2)
        if unpack(msm(bs, ss))[0] != mul(fr_dot(ks, ss)):
            _fail(f"{name} skewed 2^{skew} != g*_mul_gen(sum s_i k_i)")
        skew_ms = _time_ms(lambda: msm(bs, ss), reps=3)
        skew_bound = msm_bound(ss, bs, g2)
        del ks, ss, bs
        # the host's own MSM at a small size, and the edge cases through
        # ops/msm.py with Python ints (scalars >= r reduced there)
        hn = 6 if g2 else 10
        pts = unpack(bases[:1 << hn])
        sc = ints(s[:1 << hn])
        if unpack(msm(bases[:1 << hn], s[:1 << hn]))[0] != \
                (host.g2_msm if g2 else host.g1_msm)(pts, sc):
            _fail(f"{name} 2^{hn} != the host's MSM")
        edge_p = pts[:12] + [pts[0], pts[0], pts[1],
                             (host.g2_neg if g2 else host.g1_neg)(pts[1]),
                             pts[2], host.INF]
        edge_s = sc[:12] + [sc[0], sc[0], 7, 7, 0, 5]
        edge_s[3] = 0
        edge_s[4] = R + 11
        edge_s[5] = (1 << 256) - 1
        got = (msm_ops.g2_msm if g2 else msm_ops.g1_msm)(edge_p, edge_s,
                                                        "cuda")
        want = host.INF
        for pt, sv in zip(edge_p, edge_s):
            term = (host.g2_mul if g2 else host.g1_mul)(pt, sv) \
                if pt is not host.INF else host.INF
            want = (host.g2_add if g2 else host.g1_add)(want, term)
        if got != want:
            _fail(f"{name}: the edge cases (zero scalars, scalars >= r, "
                  "repeated points, P beside -P, infinity) != the host's")
        _log(f"{name}: == g*_mul_gen(sum s_i k_i mod r) at 2^"
             + ", 2^".join(str(b) for b in sizes)
             + f" and on the skewed set at 2^{skew}, == the host MSM at "
             f"2^{hn}, == the plain twin at 2^10 and 2^16, the edge cases "
             "== the host's, the sort's digits at 2^16 == signed_digits; "
             "kernel ms " + json.dumps({b: round(v, 4)
                                        for b, v in times.items()})
             + ", bound ms, by, window " + json.dumps(
                 {b: [round(v[0], 4), v[1], v[2]] for b, v in bounds.items()})
             + ", share of the bound " + json.dumps(
                 {b: round(bounds[b][0] / v, 4) for b, v in times.items()})
             + ", before the redesign ms and share " + json.dumps(
                 {b: [v, round(bounds[b][0] / v, 4)]
                  for b, v in MSM_MS_BEFORE[name].items()})
             + f"; skewed 2^{skew} {skew_ms:.4f} ms, bound "
             f"{skew_bound[0]:.4f} ms (window {skew_bound[2]}), share "
             f"{skew_bound[0] / skew_ms:.4f}; plain 2^16 {plain[16]:.1f} ms")
        # the per-stage device time of one call at the largest size
        top = sizes[-1]
        prof = card_bench.device_profile(
            torch, lambda: msm(bases[:1 << top], s[:1 << top]))
        _log(f"{name} 2^{top} stages (torch.profiler, one call): "
             + json.dumps(prof))
        entries[name] = _bn_entry(name, times, plain, bounds, 16)
    del bases1, bases2
    torch.cuda.empty_cache()

    # the Fr NTT: the plain forward at 2^10 .. 2^22, then the Groth16
    # chain's three forms at 2^21
    times, plain, bounds = {}, {}, {}
    for bits in (10, 16, 20, 22):
        n = 1 << bits
        x = card_bench.random_fr(torch, n, 30 + bits)
        y = bd.fr_ntt(x)
        if not torch.equal(bd.fr_ntt(y, inverse=True), x):
            _fail(f"fr_ntt 2^{bits}: inverse after forward != identity")
        if bits in (10, 16):
            for kw in ({}, {"shift": 5}, {"post": 7}):
                for inv in (False, True):
                    if not torch.equal(bd.fr_ntt(x, inv, **kw),
                                       bd.fr_ntt_plain(x, inv, **kw)):
                        _fail(f"fr_ntt 2^{bits} {kw} inverse={inv} != "
                              "the plain twin")
        if bits == 22:
            coeffs = ints(x)
            w = host.fr_w(bits)
            w1, w2 = pow(w, 1, R), pow(w, 12345, R)
            acc1 = acc2 = 0
            for cf in reversed(coeffs):
                acc1 = (acc1 * w1 + cf) % R
                acc2 = (acc2 * w2 + cf) % R
            if ints(y[1:2])[0] != acc1 or ints(y[12345:12346])[0] != acc2:
                _fail("fr_ntt 2^22 outputs 1 and 12,345 != the host's Horner")
        times[bits] = _time_ms(lambda: bd.fr_ntt(x))
        if bits in (16, 22):
            plain[bits] = _time_ms(lambda: bd.fr_ntt_plain(x),
                                   reps=2 if bits == 16 else 1)
        bounds[bits] = ntt_bound(n)
    from zkevm_prover_tpu_torch.snark.groth16 import COSET

    chain = {"intt": {"inverse": True}, "ntt_coset": {"shift": COSET},
             "intt_post": {"inverse": True, "post": pow(COSET, R - 2, R)}}
    x = card_bench.random_fr(torch, 1 << 21, 51)
    forms = {}
    for form, kw in chain.items():
        if not torch.equal(bd.fr_ntt(x, **kw), bd.fr_ntt_plain(x, **kw)):
            _fail(f"fr_ntt 2^21 {form} != the plain twin")
        bound = ntt_bound(1 << 21, kw.get("inverse", False), "shift" in kw,
                          "post" in kw)
        ms = _time_ms(lambda: bd.fr_ntt(x, **kw))
        forms[form] = [round(ms, 4), round(bound[0], 4), bound[1],
                       round(bound[0] / ms, 4),
                       FR_NTT_MS_BEFORE.get(f"{form}:21")]
    del x
    _log("fr_ntt: == the plain twin at 2^10 and 2^16 (forward, inverse, "
         "shifted) and at 2^21 in the chain's three forms, inverse after "
         "forward == identity at 2^10..2^22, outputs 1 and 12,345 at 2^22 "
         "== host Horner; passes " + json.dumps(
             {b: len(bd.ntt_plan(b)) for b in times})
         + "; forward kernel ms "
         + json.dumps({b: round(v, 4) for b, v in times.items()})
         + ", bound ms " + json.dumps(
             {b: [round(v[0], 4), v[1]] for b, v in bounds.items()})
         + ", share " + json.dumps(
             {b: round(bounds[b][0] / v, 4) for b, v in times.items()})
         + ", before the redesign ms and share " + json.dumps(
             {b: [FR_NTT_MS_BEFORE[b], round(bounds[b][0]
                                             / FR_NTT_MS_BEFORE[b], 4)]
              for b in times})
         + "; the chain's forms at 2^21 [ms, bound ms, by, share, before ms] "
         + json.dumps(forms)
         + f"; plain 2^16 {plain[16]:.1f} ms, 2^22 {plain[22]:.1f} ms")
    entries["fr_ntt"] = _bn_entry("fr_ntt", times, plain, bounds, 22)
    entries["fr_ntt"]["chain_forms_2_21"] = forms
    times, plain, bounds = {}, {}, {}
    for bits in (16, 21, 22):   # 2^21: the final wrap's size
        a, b, c = (card_bench.random_fr(torch, 1 << bits, 50 + i)
                   for i in range(3))
        if bits == 16:
            if not torch.equal(bd.fr_pointwise(a, b, c, 12345),
                               bd.fr_pointwise_plain(a, b, c, 12345)):
                _fail("fr_pointwise != its plain twin at 2^16")
        if bits != 21:
            plain[bits] = _time_ms(
                lambda: bd.fr_pointwise_plain(a, b, c, 12345),
                reps=2 if bits == 16 else 1)
        times[bits] = _time_ms(lambda: bd.fr_pointwise(a, b, c, 12345))
        bounds[bits] = pointwise_bound(1 << bits)
    entries["fr_pointwise"] = _bn_entry("fr_pointwise", times, plain, bounds,
                                        22)
    _log("fr_pointwise: == the plain twin at 2^16; kernel ms "
         + json.dumps({b: round(v, 4) for b, v in times.items()})
         + ", bound ms " + json.dumps(
             {b: [round(v[0], 4), v[1]] for b, v in bounds.items()})
         + ", share " + json.dumps(
             {b: round(bounds[b][0] / v, 4) for b, v in times.items()})
         + f", plain 2^16 {plain[16]:.1f} ms, 2^22 {plain[22]:.1f} ms; "
         f"BN254 checks "
         f"{time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    return entries


def check_msm_digits(torch, bd, points, scalars, g2, name) -> None:
    """The MSM's sort (count, scan, scatter: `bn254_cuda.msm_buckets`)
    put each point of each nonzero digit in its bucket once, with its
    sign: the digits read back from the buckets == `bd.signed_digits` (zero
    for a point at infinity)."""
    from zkevm_prover_tpu_torch.ops import bn254_cuda as bcu

    plan, entries, offsets = bcu.msm_buckets(points, scalars, g2)
    n, nb = points.shape[0], plan["nb"]
    off = offsets.long()
    total = int(off[-1])
    ent = entries[:total].long() & 0xFFFFFFFF
    idx, neg = ent & 0x7FFFFFFF, (ent >> 31).bool()
    key = torch.searchsorted(off, torch.arange(total, device=off.device),
                             right=True) - 1
    mag = key % nb + 1
    got = torch.zeros((n, plan["nwin"]), dtype=torch.int64,
                      device=off.device)
    got[idx, key // nb] = torch.where(neg, -mag, mag)
    want = bd.signed_digits(scalars, plan["c"])
    want[(points.reshape(n, -1) == 0).all(-1)] = 0
    if int((got != 0).sum()) != total or not torch.equal(got, want):
        _fail(f"{name}: the sort's digits at {n} points != signed_digits")


def msm_plain_checked(torch, bd, bases, scalars, g2, want, name, bits):
    """The plain twin's MSM on the card == the kernels' result `want`;
    returns the twin's ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bd.msm_plain(bases, scalars, g2)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    got = (bd.unpack_g2 if g2 else bd.unpack_g1)(out)[0]
    if got != want:
        _fail(f"{name} 2^{bits} != its plain twin")
    return ms


def _chain_input(old_root="0x" + "00" * 32, old_acc="0x" + "00" * 32, num=0):
    """tests/test_prover_pipeline.py's `_input`: the memory batch with its
    publics chained on a previous batch."""
    from zkevm_prover_tpu_torch.prover import ProofInput, PublicInputs

    inp = memory_input()
    return ProofInput(publics=PublicInputs(
        old_state_root=old_root, old_acc_input_hash=old_acc,
        old_batch_num=num, batch_l2_data="0xdead"), actions=inp.actions)


def run_final_wrap(torch, pcu, hcu):
    """Phase 5d, the SNARK wrap at the JAX package's final-proof test shape
    (tests/test_prover_pipeline.py:119-185): two chained memory batches
    through `Prover(n_bits={"memory": 6}, n_queries=3, device="cuda")`,
    `gen_aggregated_proof`, then `gen_final_proof(agg)` in the default
    stark-verify mode under torch.profiler (its device busy time and idle
    share): `compress_proof` of each (BN128), `build_join`,
    `groth16_setup` (the CRS on the fixed-base kernel) and `groth16_prove`
    (the quotient on the NTT kernels, the five MSMs); `verify_final_proof`
    true, a proof whose stark_publics[0] is raised by one and one whose
    pi_a is replaced by pi_a + G1 rejected. Logs the circuit's
    constraints, signals and domain, the host and card seconds of each
    step, the peak device memory and each kernel's launches, counted with
    every counter zeroed just before gen_final_proof. Returns them."""
    from zkevm_prover_tpu_torch.ops import stark_cuda as scu
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zkevm_prover_tpu_torch.ops import bn254 as host
    from zkevm_prover_tpu_torch.ops import bn254_cuda as bcu
    from zkevm_prover_tpu_torch.prover import Prover

    t_start = time.perf_counter()
    prover = Prover(n_bits={"memory": 6}, n_queries=3, device="cuda")
    bp1 = prover.gen_batch_proof(_chain_input())
    bp2 = prover.gen_batch_proof(_chain_input(
        bp1.publics.new_state_root, bp1.publics.new_acc_input_hash, 1))
    agg = prover.gen_aggregated_proof(bp1, bp2)
    if not prover.verify_aggregated_proof(agg):
        _fail("final wrap: the two memory batches do not verify")
    batches_s = time.perf_counter() - t_start
    for counters in (*_counters(), bcu.launches):
        for k in counters:
            counters[k] = 0
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fp = prover.gen_final_proof(agg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {**pcu.launches, **hcu.launches, **bcu.launches,
                **scu.launches}
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e9
    if fp.groth16.get("system") != "groth16-stark":
        _fail(f"final wrap: system {fp.groth16.get('system')}")
    key = next(iter(prover._join_g16))
    g16 = prover._join_g16[key]
    r1cs = g16.r1cs
    t0 = time.perf_counter()
    if not prover.verify_final_proof(fp):
        _fail("verify_final_proof rejected the stark-verify final proof")
    verify_s = time.perf_counter() - t0
    bad = dataclasses.replace(
        fp, stark_publics=[fp.stark_publics[0] + 1] + fp.stark_publics[1:])
    if prover.verify_final_proof(bad):
        _fail("a final proof with stark_publics[0] + 1 verified")
    bad = dataclasses.replace(fp, groth16={
        **fp.groth16, "pi_a": host.g1_add(fp.groth16["pi_a"], host.G1_GEN)})
    if prover.verify_final_proof(bad):
        _fail("a final proof with pi_a + G1 verified")
    for k in ("g1_msm", "g2_msm", "g1_fixed_base", "g2_fixed_base",
              "fr_ntt", "fr_pointwise"):
        if launches[k] == 0:
            _fail(f"final wrap: the {k} kernel did not run: {launches}")
    _stark_kernels_ran("final wrap", launches)
    m = prover.metrics.snapshot()
    host_s = {k: round(m[k]["total_s"], 3) for k in ("STARK_RECURSIVE_F_PROOF",
                                      "STARK_FINAL_CIRCUIT",
                                      "GROTH16_SETUP_FINAL_PROOF",
                                      "RAPID_SNARK")}
    st = {k: round(v, 3) for k, v in prover.snark_times.items()}
    _log(f"final wrap: two chained memory batches (2^6, 3 queries) proved "
         f"and aggregated in {batches_s:.1f} s; the stark-verify circuit "
         f"{len(r1cs.constraints)} constraints, {r1cs.n_signals} signals, "
         f"{r1cs.n_public} publics, domain 2^{g16.domain_bits}; "
         f"gen_final_proof {wall:.1f} s wall (device busy {busy:.3f} s, "
         f"idle share {1 - busy / wall:.3f}), peak {peak:.2f} GiB; timers "
         + json.dumps(host_s) + "; Groth16 steps (s): " + json.dumps(st)
         + f"; the card CRS {st.get('crs')} s and the NTTs {st.get('ntt')} s "
         "(before the fixed-base and NTT redesigns: 0.293-0.313 s "
         "and 0.024 s)")
    _log(f"final wrap: verify_final_proof true ({verify_s:.1f} s), "
         "stark_publics[0] + 1 and pi_a + G1 rejected; kernel launches "
         + json.dumps(launches)
         + f"; phase {time.perf_counter() - t_start:.1f} s")
    return launches


def small_snark_proofs(device: str, prover, bp) -> dict:
    """The final SNARKs of the request queue's memory batch `bp` on
    `device`: a Groth16 proof with a fixed seed over the digest circuit
    (`Prover._final_circuit`), and the plonk and fflonk final proofs
    (deterministic); each card proof must verify."""
    from zkevm_prover_tpu_torch.ops.bn254 import R
    from zkevm_prover_tpu_torch.snark import groth16_prove, groth16_verify

    out = {}
    t0 = time.perf_counter()
    digest = prover.publics_digest(bp.publics)
    inv = pow(digest, R - 2, R) if digest else 0
    setup = prover._final_circuit()
    proof = groth16_prove(setup, [1, digest, digest, inv, digest * inv % R],
                          seed=b"chip_smoke")
    if device == "cuda" and not groth16_verify(setup, [digest], proof):
        _fail("the seeded digest Groth16 proof does not verify")
    out["groth16 digest"] = json.dumps(proof, sort_keys=True)
    for snark in ("plonk", "fflonk"):
        fp = prover.gen_final_proof(bp, snark=snark)
        if device == "cuda" and not prover.verify_final_proof(fp):
            _fail(f"the {snark} final proof does not verify")
        out[f"{snark} final"] = json.dumps(fp.groth16, sort_keys=True)
    _log(f"small SNARK proofs on {device}: {time.perf_counter() - t0:.1f} s")
    return out


def memory_input():
    """tests/test_prover_pipeline.py's batch: two memory actions."""
    from zkevm_prover_tpu_torch.executor import BatchActions
    from zkevm_prover_tpu_torch.prover import ProofInput, PublicInputs

    return ProofInput(
        publics=PublicInputs(batch_l2_data="0xdead"),
        actions=BatchActions(memory=[
            {"addr": 1, "step": 1, "wr": 1, "value": 5},
            {"addr": 1, "step": 2, "wr": 0, "value": 0}]))


def small_proofs(device: str) -> dict:
    """Proof JSON of the toy AIRs, PoseidonG at 2^8, the mixed batch of
    the seven co-processor SMs at 2^9, the small storage batch (storage
    2^9 with its emitted PoseidonG 2^9 and ClimbKey 2^10), the small
    hash batch (PaddingKK, PaddingSha256, KeccakF, Sha256F), the small
    combined batch (Main and its bound co-SMs in one AIR at 2^9) and the
    memory batch through `Prover`'s request queue, proved on `device`;
    each card proof must also verify."""
    from zkevm_prover_tpu_torch.executor import (BatchActions, Executor,
                                                 combined)
    from zkevm_prover_tpu_torch.executor.examples import (
        mixed_batch, small_hash_batch, small_rom_batch, small_storage_batch)
    from zkevm_prover_tpu_torch.hashdb import Smt
    from zkevm_prover_tpu_torch.prover import Prover, ProverRequest
    from zkevm_prover_tpu_torch.stark import examples
    from zkevm_prover_tpu_torch.stark.prover import StarkProver
    from zkevm_prover_tpu_torch.stark.setup import StarkSetup
    from zkevm_prover_tpu_torch.stark.verifier import verify

    out = {}
    for name, (air, trace) in examples.all_air_traces().items():
        setup = StarkSetup(air, n_queries=8, fri_fold_bits=2)
        prover = StarkProver(setup, device=device)
        proof = prover.prove(trace)
        if device == "cuda" and not verify(setup, prover.verkey, proof,
                                           device=device):
            _fail(f"{name}: proof does not verify")
        out[f"toy {name}"] = proof.to_json()
    rng = np.random.default_rng(2)
    actions = [{"state": [int(v) for v in rng.integers(0, 1 << 32, 12)]}
               for _ in range(7)]
    out["poseidon_g 2^8"] = Executor(
        n_bits={"poseidon_g": 8}, device=device).prove_all(
        BatchActions(poseidon_g=actions))["poseidon_g"][1].to_json()
    ex = Executor(n_bits={"binary": 9}, device=device)
    proofs = ex.prove_all(BatchActions(**mixed_batch()))
    if device == "cuda" and not ex.verify_all(proofs):
        _fail("the mixed batch does not verify")
    for name, (_, proof) in proofs.items():
        out[f"mixed batch {name} 2^9"] = proof.to_json()
    db, actions = small_storage_batch(device)
    ex = Executor(device=device)
    proofs = ex.prove_all(BatchActions(storage=actions), db=db)
    if device == "cuda" and not ex.verify_all(proofs):
        _fail("the small storage batch does not verify")
    for name, (prover, proof) in proofs.items():
        out[f"storage batch {name} 2^{prover.setup.n_bits}"] = proof.to_json()
    batch = small_hash_batch()
    ex = batch.executor(device)
    traces = ex.execute(batch.actions())
    traces.update(ex.execute_gates())
    proofs = ex.prove_traces(traces)
    if device == "cuda" and not ex.verify_all(proofs):
        _fail("the small hash batch does not verify")
    for name, (prover, proof) in proofs.items():
        out[f"hash batch {name} 2^{prover.setup.n_bits}"] = proof.to_json()
    db, _, rom_batch = small_rom_batch(device)
    _, traces = combined.execute_batch(
        rom_batch.rom, rom_batch.n_bits, input=rom_batch.input, smt=Smt(db),
        include=rom_batch.include, device=device)
    air = combined.build_batch_air(rom_batch.rom, rom_batch.n_bits,
                                   include=rom_batch.include)
    setup = StarkSetup(air, n_queries=8, fri_fold_bits=2)
    prover = StarkProver(setup, device=device)
    proof = prover.prove(air.stack_traces(traces))
    if device == "cuda" and not verify(setup, prover.verkey, proof,
                                       device=device):
        _fail("the small combined batch does not verify")
    out[f"rom batch combined 2^{rom_batch.n_bits}"] = proof.to_json()
    prover = Prover(n_bits=9, device=device)
    uid = prover.submit_request(ProverRequest("genBatchProof",
                                              memory_input()))
    bp = prover.wait_for_request(uid, timeout=600)
    if device == "cuda" and not prover.verify_batch_proof(bp):
        _fail("the request queue's memory batch does not verify")
    out["prover queue memory 2^9"] = bp.sm_proofs["memory"][1].to_json()
    out.update(small_snark_proofs(device, prover, bp))
    out.update(small_recursion_proofs(device, prover, bp))
    return out


def small_recursion_proofs(device: str, prover, bp) -> dict:
    """The recursion slice's small proofs on `device`: the Fibonacci AIR
    under BN128 commitments (the JAX stage test's recursiveF shape),
    `compress_proof` of the request queue's memory batch `bp` (its SM
    re-proved under BN128) and the Fibonacci proof's recursive1 wrap at
    2^13 (the JAX recursion test's sizes); each card proof must verify,
    and each one's host seconds are logged."""
    from zkevm_prover_tpu_torch.stark import examples
    from zkevm_prover_tpu_torch.stark.prover import StarkProver
    from zkevm_prover_tpu_torch.stark.recursive import RecursiveProver
    from zkevm_prover_tpu_torch.stark.setup import StarkSetup
    from zkevm_prover_tpu_torch.stark.verifier import verify

    out, secs = {}, {}
    air, trace = examples.fib_air_trace()
    t0 = time.perf_counter()
    setup = StarkSetup(air, n_queries=4, fri_fold_bits=2, hash_type="BN128")
    bn = StarkProver(setup, device=device)
    proof = bn.prove(trace)
    secs["bn128 fib 2^6"] = time.perf_counter() - t0
    if device == "cuda" and not verify(setup, bn.verkey, proof,
                                       device=device):
        _fail("the BN128 Fibonacci proof does not verify")
    out["bn128 fib 2^6"] = proof.to_json()
    t0 = time.perf_counter()
    compressed = prover.compress_proof(bp)
    secs["compress memory 2^9"] = time.perf_counter() - t0
    for name, (pv, proof) in compressed.items():
        if proof.hash_type != "BN128":
            _fail(f"compress_proof: {name} is a {proof.hash_type} proof")
        if device == "cuda" and not verify(pv.setup, pv.verkey, proof,
                                           device=device):
            _fail(f"compress_proof: {name}'s BN128 proof does not verify")
        out[f"compress {name} 2^9"] = proof.to_json()
    air, trace = examples.fib_air_trace()
    setup = StarkSetup(air, n_queries=4, fri_fold_bits=2)
    inner = StarkProver(setup, device=device)
    inner_proof = inner.prove(trace)
    t0 = time.perf_counter()
    rp = RecursiveProver(setup, n_bits=13, n_queries=4, device=device)
    rec = rp.prove_one(inner.verkey, inner_proof)
    secs["recursive1 fib 2^13"] = time.perf_counter() - t0
    opv = rp.outer_prover
    if device == "cuda" and not verify(opv.setup, opv.verkey, rec.proof,
                                       device=device):
        _fail("the Fibonacci recursive1 proof does not verify")
    out["recursive1 fib 2^13"] = rec.proof.to_json()
    _log(f"small recursion proofs on {device} (host s): "
         + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    return out


def _cli_path(path: str, name: str) -> str:
    """A file of the CLI check beside the CPU proofs' file: its input JSON
    ("cli_input.json") or the output directory of its run on a device
    ("cli_cuda", "cli_cpu")."""
    import os

    return os.path.join(os.path.dirname(path), name)


def start_cpu_proofs(path: str):
    """The CPU side of the small proofs and of the CLI run, in a child
    process that runs while the card works (it sees no card); the CLI's
    input JSON is written first, for both sides."""
    import os

    with open(_cli_path(path, "cli_input.json"), "w") as f:
        f.write(memory_input().to_json())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, __file__, "--cpu-proofs", path],
                            env=env)


def cpu_proofs(path: str) -> None:
    """The child's work: the small proofs on the CPU into `path`, and the
    CLI, in this process, on the CPU."""
    from zkevm_prover_tpu_torch.__main__ import main as cli_main

    with open(path, "w") as f:
        json.dump(small_proofs("cpu"), f)
    if cli_main(["--prove", _cli_path(path, "cli_input.json"), "-o",
                 _cli_path(path, "cli_cpu"), "--device", "cpu"]) != 0:
        raise RuntimeError("the CLI failed on the CPU")


def check_cli(path: str) -> None:
    """`python -m zkevm_prover_tpu_torch --prove` on the card in a
    subprocess: its batch_proof.json (publics, counters, proofs) == the CPU
    child's."""
    import os

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "zkevm_prover_tpu_torch",
                          "--prove", _cli_path(path, "cli_input.json"),
                          "-o", _cli_path(path, "cli_cuda")],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        _fail(f"the CLI on the card exited with {res.returncode}: "
              f"{res.stderr[-2000:]}")
    got = {}
    for device in ("cuda", "cpu"):
        with open(os.path.join(_cli_path(path, f"cli_{device}"),
                               "batch_proof.json")) as f:
            got[device] = json.load(f)
    if got["cuda"] != got["cpu"]:
        _fail("the CLI's batch_proof.json on the card != the CPU's")
    _log(f"CLI --prove on the card (a subprocess, {wall:.1f} s wall): "
         f"batch_proof.json == the CPU child's; proofs "
         f"{sorted(got['cuda']['proofs'])}, new batch "
         f"{got['cuda']['publics']['new_batch_num']}")


def check_small_proofs(child, path: str) -> None:
    """Card proof bytes == the child's CPU proof bytes, for each proof; then
    the CLI on the card against the child's CLI run."""
    t0 = time.perf_counter()
    card = small_proofs("cuda")
    t1 = time.perf_counter()
    if child.wait() != 0:
        _fail(f"the CPU proofs' process exited with {child.returncode}")
    with open(path) as f:
        cpu = json.load(f)
    if sorted(cpu) != sorted(card) or \
            len(card) != 4 + 1 + 7 + 3 + 4 + 1 + 1 + 3 + 3:
        _fail(f"proved {sorted(card)} on the card, {sorted(cpu)} on the CPU")
    for name, text in card.items():
        if text != cpu[name]:
            _fail(f"{name}: card proof differs from CPU proof")
    _log(f"small proofs ({', '.join(card)}): card proof JSON == CPU proof "
         f"JSON; card {t1 - t0:.1f} s, then {time.perf_counter() - t1:.1f} s "
         "waiting for the CPU")
    check_cli(path)


# newAccInputHash of `batch_input`'s publics, pinned from the JAX package's
# `PublicInputs.acc_input_hash` (zkevm_prover_tpu/prover/input.py :89) for
# the same publics
BATCH_ACC_INPUT_HASH = ("0x6e9e1118f5e6b65f254cae5858431230"
                        "e187407f7f155ea6ec46238e7de412c1")


def batch_input(ex):
    """The co-processor batch as a `ProofInput`: every ported SM of `ex`
    filled to its capacity less one group (`examples.full_batch`), under
    publics from np.random.default_rng(3) (a 512-byte batchL2Data: the
    checkpoint keeps the publics in its 4 KiB header page). Built in
    memory: `ProofInput.from_json` reads binary, memory and arith actions
    only, as in the JAX package."""
    from zkevm_prover_tpu_torch.executor import BatchActions, examples
    from zkevm_prover_tpu_torch.prover import ProofInput, PublicInputs

    rng = np.random.default_rng(3)
    pub = PublicInputs(
        old_state_root="0x" + rng.bytes(32).hex(),
        old_acc_input_hash="0x" + rng.bytes(32).hex(), old_batch_num=41,
        chain_id=1101, fork_id=9, batch_l2_data="0x" + rng.bytes(512).hex(),
        l1_info_root="0x" + rng.bytes(32).hex(), timestamp_limit=1700000000,
        sequencer_addr="0x" + rng.bytes(20).hex())
    return ProofInput(publics=pub,
                      actions=BatchActions(**examples.full_batch(ex)))


def run_batch(torch, pcu, hcu, bits: int, arith_bits: int, path: str):
    """The co-processor batch at full width under MODE mxu96 through
    `Prover.gen_batch_proof(inp, save_cm_pols=path)`, then
    `verify_batch_proof`, the publics and a tampered proof of each SM;
    returns the prover, the BatchProof, the traces it proved (kept by
    wrapping its executor's `prove_traces`) and the launches of every kernel
    in the prove and the verification. Each SM's AIR build and setup, its
    prove's wall and its peak device memory are read by wrapping the
    executor's `prover` for the one call."""
    from zkevm_prover_tpu_torch.ops import stark_cuda as scu
    import os

    from zkevm_prover_tpu_torch.prover import Prover
    from zkevm_prover_tpu_torch.stark.proof import StarkProof
    from zkevm_prover_tpu_torch.stark.verifier import VerifyError, verify

    sizes = {name: bits for name in
             ("binary", "memory", "mem_align", "poseidon_g", "padding_pg",
              "climb_key")}
    sizes["arith"] = arith_bits
    prover = Prover(n_bits=sizes, device="cuda")
    ex = prover.executor
    _log(f"batch sizes (log2 rows): {json.dumps(ex.n_bits)}; binary slice "
         f"{ex.binary_slice_bits()} bits")
    pcu.MODE = "mxu96"
    t_batch = time.perf_counter()
    inp = batch_input(ex)
    _log(f"batch input made: {time.perf_counter() - t_batch:.1f} s")
    proved, built, walls, peaks = {}, {}, {}, {}
    prove_traces, make_prover = ex.prove_traces, ex.prover

    def keep(traces):
        proved.update(traces)
        return prove_traces(traces)

    def timed_prover(name, hash_type="GL"):
        if name in built or hash_type != "GL":
            return make_prover(name, hash_type)
        t0 = time.perf_counter()
        sm_prover = make_prover(name)
        torch.cuda.synchronize()
        built[name] = time.perf_counter() - t0
        prove = sm_prover.prove

        def timed_prove(trace):
            peaks.setdefault("before the proves",
                             torch.cuda.max_memory_allocated() / 2**30)
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            proof = prove(trace)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t1
            peaks[name] = torch.cuda.max_memory_allocated() / 2**30
            return proof

        sm_prover.prove = timed_prove
        return sm_prover

    ex.prove_traces, ex.prover = keep, timed_prover
    for counters in _counters():
        for k in counters:
            counters[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bp = prover.gen_batch_proof(inp, save_cm_pols=path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del ex.prove_traces, ex.prover
    for sm_prover, _ in bp.sm_proofs.values():
        del sm_prover.prove
    peak = max(peaks.values())
    timers = {k: round(v["total_s"], 3)
              for k, v in prover.metrics.snapshot().items()}
    _log(f"batch Prover.gen_batch_proof: {wall:.2f} s on the script's "
         f"clock; Prover timers (s) {json.dumps(timers)}; checkpoint "
         f"{os.path.getsize(path) / 2**30:.3f} GiB; peak device memory "
         f"{peak:.2f} GiB ({peaks['before the proves']:.2f} before the "
         f"proves); kernel launches in the proofs "
         f"{json.dumps({**pcu.launches, **hcu.launches})}")
    for name, (sm_prover, _) in bp.sm_proofs.items():
        air_s = ex.air_times[name]
        _log(f"batch {name} 2^{ex.n_bits[name]} "
             f"({len(getattr(inp.actions, name))} actions, "
             f"{sm_prover.setup.air.n_cm1} committed cols): executor "
             f"{ex.execute_times[name]:.2f} s, AIR (host) {air_s:.2f} s, "
             f"setup {built[name] - air_s:.2f} s, prove {walls[name]:.2f} s "
             f"({sm_prover.setup.n / walls[name] / 1e6:.4f} Mrow/s; its "
             f"phases {sum(sm_prover.phase_times.values()):.2f} s), peak "
             f"device memory {peaks[name]:.2f} GiB")
        _log(f"batch {name} phases (s): " + json.dumps(
            {k: round(v, 4) for k, v in sm_prover.phase_times.items()}))
    _log(f"batch: AIR + setup + prove summed over the SMs "
         f"{sum(built.values()) + sum(walls.values()):.2f} s of "
         f"STARK_PROOF_BATCH_PROOF's {timers['STARK_PROOF_BATCH_PROOF']:.2f}"
         f" s; {time.perf_counter() - t_batch:.1f} s in all")

    t0 = time.perf_counter()
    if not prover.verify_batch_proof(bp):
        _fail("verify_batch_proof rejected the batch")
    torch.cuda.synchronize()
    launches = dict(pcu.launches)
    _log(f"batch verify_batch_proof: true ({time.perf_counter() - t0:.2f} "
         f"s); kernel launches in proofs + verify "
         f"{json.dumps({**launches, **hcu.launches})}")
    if launches["merkle"] == 0:
        _fail("the fused Merkle kernel was not launched on the main path")
    if launches["mxu96"] == 0:
        _fail("the mxu96 kernel was not launched on the main path")
    _stark_kernels_ran("batch", scu.launches)
    if any(n for mode, n in launches.items() if mode not in ("mxu96",
                                                             "merkle")):
        _fail(f"another mode's kernel ran under MODE mxu96: {launches}")
    old = inp.publics
    if bp.publics.new_batch_num != old.old_batch_num + 1:
        _fail(f"batch publics: new batch {bp.publics.new_batch_num}, old "
              f"{old.old_batch_num}")
    # the plumbing: gen_batch_proof hands on what PublicInputs computes
    if bp.publics.new_acc_input_hash != old.acc_input_hash():
        _fail(f"batch publics: newAccInputHash "
              f"{bp.publics.new_acc_input_hash} != PublicInputs."
              f"acc_input_hash() {old.acc_input_hash()}")
    # the recurrence: the JAX package's value for the same publics
    if bp.publics.new_acc_input_hash != BATCH_ACC_INPUT_HASH:
        _fail(f"batch publics: newAccInputHash "
              f"{bp.publics.new_acc_input_hash} != the JAX package's "
              f"{BATCH_ACC_INPUT_HASH}")
    for name, (sm_prover, proof) in bp.sm_proofs.items():
        bad = StarkProof.from_json(proof.to_json())
        bad.fri[0].queries[0][0].values[0] += 1
        try:
            verify(sm_prover.setup, sm_prover.verkey, bad, device="cuda")
        except VerifyError:
            continue
        _fail(f"a tampered {name} proof verified")
    _log(f"batch: new batch {bp.publics.new_batch_num} == old + 1, "
         f"newAccInputHash {bp.publics.new_acc_input_hash} == "
         "PublicInputs.acc_input_hash() (the entry point's plumbing) == the "
         "JAX package's pinned value (the recurrence); a tampered proof of "
         f"each of the {len(bp.sm_proofs)} SMs rejected")
    return prover, bp, proved, {**launches, **hcu.launches, **scu.launches}


def check_checkpoint(path: str, proved: dict) -> dict:
    """`load_commit_pols` of phase 5's checkpoint gives back every SM's
    trace, equal to the traces proved; returns them (memory-mapped)."""
    from zkevm_prover_tpu_torch.prover import checkpoint

    t0 = time.perf_counter()
    traces, hdr = checkpoint.load_commit_pols(path)
    if sorted(traces) != sorted(proved):
        _fail(f"checkpoint holds {sorted(traces)}, proved {sorted(proved)}")
    for name, trace in traces.items():
        if not np.array_equal(np.asarray(trace), proved[name]):
            _fail(f"checkpoint: {name}'s trace differs from the proved one")
    _log(f"checkpoint: load_commit_pols gave back the {len(traces)} proved "
         f"traces, equal ({time.perf_counter() - t0:.2f} s to load and "
         f"compare); publics {len(hdr['publics'])} fields, counters "
         f"{len(hdr['meta']['counters'])}")
    return traces


def run_modes(torch, pcu, prover, bp, traces, path: str) -> dict:
    """mem_align's full-width trace re-proved under every mode: under mxu96
    by `gen_batch_proof_from_commit` of a mem_align-only checkpoint (at
    `path`), under the others by its prover; each proof must equal phase
    5's byte for byte. Returns each mode's launches in its prove (under
    mxu96, the fused Merkle kernel's)."""
    from zkevm_prover_tpu_torch.prover import checkpoint

    sm_prover, proof = bp.sm_proofs["mem_align"]
    ref = proof.to_json()
    checkpoint.save_commit_pols(path, {"mem_align": traces["mem_align"]})
    trace = np.asarray(traces["mem_align"])
    launches, times = {}, {}
    try:
        for mode in ("mxu96", "1d", "2d", "blocked", "mxu", "mxu24"):
            pcu.MODE = mode
            for m in pcu.launches:
                pcu.launches[m] = 0
            t0 = time.perf_counter()
            if mode == "mxu96":
                resumed = prover.gen_batch_proof_from_commit(path)
                got = resumed.sm_proofs["mem_align"][1].to_json()
            else:
                got = sm_prover.prove(trace).to_json()
            torch.cuda.synchronize()
            times[mode] = time.perf_counter() - t0
            # mxu96 commits through the fused kernel, the others chunked
            key = "merkle" if mode == "mxu96" else mode
            launches[mode] = pcu.launches[key]
            if launches[mode] == 0:
                _fail(f"mode {mode}: its kernel ({key}) was not launched")
            if any(n for m, n in pcu.launches.items()
                   if m not in (key, mode)):
                _fail(f"mode {mode}: another kernel ran: {pcu.launches}")
            if got != ref:
                _fail(f"mode {mode}: mem_align proof differs from phase "
                      "5's")
    finally:
        pcu.MODE = "mxu96"
    _log(f"modes: mem_align 2^{sm_prover.setup.n_bits} resumed from a "
         "mem_align-only checkpoint (gen_batch_proof_from_commit, mxu96) "
         "and re-proved under every other mode == phase 5's proof; "
         f"launches {json.dumps(launches)}")
    _log("modes: steady mem_align prove (s; mxu96's with the checkpoint's "
         "load): " + json.dumps({m: round(t, 3) for m, t in times.items()}))
    return launches


def _device_seconds(prof) -> float:
    """Summed duration of the device events (kernels and copies) of a
    torch.profiler run."""
    from torch.autograd import DeviceType

    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e9


def _kernel_label(name: str) -> str:
    """A device event's kernel without its template arguments: the last
    functor or kernel function its name holds (MulFunctor,
    bitwise_and_kernel_cuda, dag_eval_kernel, ...), else its first 60
    characters."""
    found = re.findall(r"(\w+(?:Functor|_kernel_cuda|_kernel))\b", name)
    return found[-1] if found else name[:60]


def _rss_gib() -> float:
    """This process's resident memory now."""
    import os

    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30


def run_state_tree(torch, pcu, hcu, bits: int):
    """The storage batch's pre-state: `examples.state_tree` at 2^12 keys on
    the card against the CPU's plain twin (the same root), then at 2^`bits`
    keys on the card, its permutations through the mxu96 kernel (one launch
    per batch: the keys' two, value preimages, leaves, each branch level),
    timed on the host clock and on the device (torch.profiler), and read
    back through `Smt.get`. The keys are those the Main SM derives from
    random key registers. Returns the tree's Smt, the tree and the
    launches."""
    from zkevm_prover_tpu_torch.ops import stark_cuda as scu
    from torch.profiler import ProfilerActivity, profile

    from zkevm_prover_tpu_torch.executor import examples
    from zkevm_prover_tpu_torch.hashdb import Database, Smt

    pcu.MODE = "mxu96"
    small = {dev: examples.state_tree(Database(), 1 << 12, 12, dev)
             for dev in ("cuda", "cpu")}
    if small["cuda"].root != small["cpu"].root:
        _fail("state_tree 2^12: card root != CPU root")
    _log(f"state tree 2^12 keys: card root == CPU root {small['cpu'].root}")

    db = Database()
    for counters in _counters():
        for k in counters:
            counters[k] = 0
    rss0 = _rss_gib()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tree = examples.state_tree(db, 1 << bits, 20, "cuda")
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    launches = dict(pcu.launches)
    if launches["mxu96"] != tree.depth + 4:
        _fail(f"state tree: {launches['mxu96']} mxu96 launches, expected "
              f"{tree.depth + 4} (the keys' two, values, leaves, "
              f"{tree.depth} levels)")
    if any(n for mode, n in launches.items() if mode != "mxu96"):
        _fail(f"state tree: another kernel ran: {launches}")
    smt = Smt(db)
    rng = np.random.default_rng(21)
    for i in rng.choice(len(tree.values), 64, replace=False):
        key = tuple(int(v) for v in tree.keys[i])
        if smt.get(tree.root, key).value != tree.values[i]:
            _fail(f"state tree: Smt.get of key {i} lost its value")
    for key in rng.integers(0, 0xFFFFFFFF00000001, (16, 4), dtype=np.uint64):
        if smt.get(tree.root, tuple(int(v) for v in key)).value != 0:
            _fail("state tree: Smt.get of an absent key is not 0")
    _log(f"state tree 2^{bits} keys: {tree.nodes} nodes, deepest leaf at "
         f"level {tree.depth}; host {host_s:.2f} s (hashing, the Database "
         f"fill and the profiler), device {_device_seconds(prof):.4f} s; "
         f"{launches['mxu96']} mxu96 launches; host RSS {rss0:.2f} -> "
         f"{_rss_gib():.2f} GiB; Smt.get of 64 present "
         "keys gave their values, of 16 absent keys 0")
    return smt, tree, {**launches, **hcu.launches, **scu.launches}


def run_storage_batch(torch, pcu, hcu, smt, tree, bits: int) -> dict:
    """The storage batch at full width over the state tree: the actions of
    `examples.storage_batch`, closed on the PoseidonG capacity of a
    2^`bits` PoseidonG SM, proved through `Executor.prove_all` with storage
    at the smallest power of two that holds its rows and PoseidonG and
    ClimbKey at 2^`bits`; then `verify_all`, and a tampered storage proof
    must be rejected. Returns the launches of the proofs and the
    verification."""
    from zkevm_prover_tpu_torch.ops import stark_cuda as scu
    from zkevm_prover_tpu_torch.executor import BatchActions, Executor
    from zkevm_prover_tpu_torch.executor import examples
    from zkevm_prover_tpu_torch.stark.proof import StarkProof
    from zkevm_prover_tpu_torch.stark.verifier import VerifyError, verify

    sizes = {"poseidon_g": bits, "climb_key": bits}
    cap = Executor(n_bits=sizes, device="cuda").counters(
        BatchActions())["poseidon_g_capacity"] - 1
    t0 = time.perf_counter()
    actions, rows = examples.storage_batch(smt, tree.root, 22, cap)
    make_s = time.perf_counter() - t0
    ops = {}
    for a in actions:
        kind = a["op"] if a["op"] == "get" else (
            "delete" if a["value"] == 0 else "set")
        ops[kind] = ops.get(kind, 0) + 1
    ex = Executor(n_bits={"storage": max(rows - 1, 1).bit_length(), **sizes},
                  device="cuda")
    _log(f"storage batch: {len(actions)} actions {json.dumps(ops)}, "
         f"{rows} storage rows (2^{ex.n_bits['storage']}), made in "
         f"{make_s:.2f} s (host Smt.set/get); PoseidonG capacity {cap}")

    batch = BatchActions(storage=actions)
    for counters in _counters():
        for k in counters:
            counters[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proofs = ex.prove_all(batch, db=smt.db)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = ex.counters(batch)
    _log(f"storage batch prove_all: {wall:.2f} s; peak device memory "
         f"{peak:.2f} GiB; emitted PoseidonG {counts['poseidon_g']} of "
         f"{counts['poseidon_g_capacity']}, ClimbKey {counts['climb_key']} of "
         f"{counts['climb_key_capacity']}; kernel launches in the proofs "
         f"{json.dumps(pcu.launches)}")
    rest = wall - sum(ex.execute_times.values())
    for name, (prover, _) in proofs.items():
        prove_s = sum(prover.phase_times.values())
        rest -= prove_s
        _log(f"storage batch {name} 2^{prover.setup.n_bits} "
             f"({prover.setup.air.n_cm1} committed cols): executor "
             f"{ex.execute_times[name]:.2f} s, prove {prove_s:.2f} s (its "
             "phases)")
        _log(f"storage batch {name} phases (s): " + json.dumps(
            {k: round(v, 4) for k, v in prover.phase_times.items()}))
    _log(f"storage batch prove_all: {rest:.2f} s outside the executors and "
         "the phases (the three AIRs, their constants and setups)")
    t0 = time.perf_counter()
    if not ex.verify_all(proofs):
        _fail("verify_all rejected the storage batch")
    torch.cuda.synchronize()
    launches = dict(pcu.launches)
    if launches["merkle"] == 0 or launches["mxu96"] == 0:
        _fail(f"storage batch: a kernel of the path did not run: {launches}")
    _stark_kernels_ran("storage batch", scu.launches)
    if any(n for mode, n in launches.items() if mode not in ("mxu96",
                                                             "merkle")):
        _fail(f"storage batch: another mode's kernel ran: {launches}")
    prover, proof = proofs["storage"]
    bad = StarkProof.from_json(proof.to_json())
    bad.fri[0].queries[0][0].values[0] += 1
    try:
        verify(prover.setup, prover.verkey, bad, device="cuda")
    except VerifyError:
        pass
    else:
        _fail("a tampered storage proof verified")
    _log(f"storage batch verify_all: true ({time.perf_counter() - t0:.2f} "
         f"s); a tampered storage proof rejected; kernel launches in proofs "
         f"+ verify {json.dumps({**launches, **hcu.launches})}")
    return {**launches, **hcu.launches, **scu.launches}


def run_hash_batch(torch, pcu, hcu) -> dict:
    """The hash batch at full width (`examples.hash_batch`): the padding SMs
    through `Executor.execute`, the gate SMs through `execute_gates` from
    their emitted permutations, each proved and timed; then `verify_all`, a
    tampered proof of each SM rejected, and the single-block messages'
    PaddingKK digests against `keccak256_blocks` on the card. Returns the
    launches of every kernel on this path (counters zeroed just before)."""
    from zkevm_prover_tpu_torch.ops import stark_cuda as scu
    from zkevm_prover_tpu_torch.executor import examples
    from zkevm_prover_tpu_torch.ops import keccak
    from zkevm_prover_tpu_torch.stark.proof import StarkProof
    from zkevm_prover_tpu_torch.stark.verifier import VerifyError, verify

    batch = examples.hash_batch()
    ex = batch.executor("cuda")
    counts = ex.counters(batch.actions())
    _log(f"hash batch: {len(batch.keccak)} Keccak messages in "
         f"{counts['padding_kk']} blocks (KeccakF capacity "
         f"{ex.gate_capacity('keccak_f')}), {len(batch.sha256)} SHA-256 "
         f"messages in {counts['padding_sha256']} blocks (Sha256F capacity "
         f"{ex.gate_capacity('sha256_f')}); sizes (log2 rows) "
         f"{json.dumps(batch.n_bits)}; gates {json.dumps(batch.gates)}")
    pcu.MODE = "mxu96"
    for counters in _counters():
        for k in counters:
            counters[k] = 0
    t_batch = time.perf_counter()
    traces = ex.execute(batch.actions())
    traces.update(ex.execute_gates())
    torch.cuda.synchronize()
    _log(f"hash batch executors: {time.perf_counter() - t_batch:.2f} s; "
         + json.dumps({k: round(v, 3) for k, v in ex.execute_times.items()})
         + f"; sha256_compress launches {hcu.launches['sha256_compress']}")
    proofs, peak = {}, 0.0
    for name, trace in traces.items():
        t0 = time.perf_counter()
        prover = ex.prover(name)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        proof = prover.prove(trace)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        gib = torch.cuda.max_memory_allocated() / 2**30
        peak = max(peak, gib)
        proofs[name] = (prover, proof)
        air = prover.setup.air
        _log(f"hash batch {name} 2^{ex.n_bits[name]} ({air.n_cm1} committed"
             f" / {len(air.const_names)} constant cols, {len(air.lookups)} "
             f"lookups, {len(air.connections)} connections): AIR (host) "
             f"{ex.air_times[name]:.2f} s, setup "
             f"{t1 - t0 - ex.air_times[name]:.2f} s, executor "
             f"{ex.execute_times[name]:.2f} s, prove {t2 - t1:.2f} s "
             f"({prover.setup.n / (t2 - t1) / 1e6:.4f} Mrow/s), peak device "
             f"memory {gib:.2f} GiB")
        _log(f"hash batch {name} phases (s): " + json.dumps(
            {k: round(v, 4) for k, v in prover.phase_times.items()}))
    _log(f"hash batch: {time.perf_counter() - t_batch:.1f} s in all; peak "
         f"device memory {peak:.2f} GiB")

    t0 = time.perf_counter()
    if not ex.verify_all(proofs):
        _fail("verify_all rejected the hash batch")
    torch.cuda.synchronize()
    _log(f"hash batch verify_all: true ({time.perf_counter() - t0:.2f} s)")
    # PaddingKK's digests (the host sponge) of the single-block messages
    # against keccak256_blocks of them on the card (the keccak_f kernel);
    # the messages' addresses follow their order, so digest i is message i
    single = [i for i, m in enumerate(batch.keccak)
              if len(m["data"]) < keccak.RATE_BYTES]
    blocks = np.zeros((len(single), keccak.RATE_BYTES), dtype=np.uint8)
    for row, i in enumerate(single):
        data = batch.keccak[i]["data"]
        blocks[row, :len(data)] = bytearray(data)
        blocks[row, len(data)] ^= 0x01
        blocks[row, -1] ^= 0x80
    got = keccak.keccak256_blocks(blocks, device="cuda").cpu().numpy()
    for row, i in enumerate(single):
        if int.from_bytes(bytes(got[row]), "big") != \
                ex.digests["padding_kk"][i]:
            _fail(f"keccak256_blocks of message {i} != its PaddingKK digest")
    torch.cuda.synchronize()
    launches = {**pcu.launches, **hcu.launches, **scu.launches}
    _log(f"hash batch: PaddingKK digests of the {len(single)} single-block "
         "messages == keccak256_blocks on the card; kernel launches in "
         f"proofs + verify + digests {json.dumps(launches)}")
    for kernel in ("merkle", "mxu96", "keccak_f", "sha256_compress"):
        if launches[kernel] == 0:
            _fail(f"hash batch: the {kernel} kernel was not launched")
    _stark_kernels_ran("hash batch", launches)
    if launches["sha256_compress"] != counts["padding_sha256_capacity"]:
        _fail(f"hash batch: {launches['sha256_compress']} sha256_compress "
              f"launches, not one per PaddingSha256 block "
              f"({counts['padding_sha256_capacity']})")
    if any(launches[mode] for mode in pcu.MODES if mode != "mxu96"):
        _fail(f"hash batch: another mode's kernel ran: {launches}")
    for name, (prover, proof) in proofs.items():
        bad = StarkProof.from_json(proof.to_json())
        bad.fri[0].queries[0][0].values[0] += 1
        try:
            verify(prover.setup, prover.verkey, bad, device="cuda")
        except VerifyError:
            continue
        _fail(f"a tampered {name} proof verified")
    _log(f"hash batch: a tampered proof of each of the {len(proofs)} SMs "
         "rejected")
    del traces, proofs
    torch.cuda.empty_cache()
    return launches


def run_rom_batch(torch, pcu, hcu, smt, tree, bits: int):
    """Phase 5b, the combined batch at full width: `examples.rom_batch` at
    2^`bits` over the state tree, executed through `combined.execute_batch`
    and proved in one STARK over `build_batch_air(rom, bits,
    include=default_include(bits))`, then `verify`; a tampered proof must
    be rejected, a cross-SM forgery flagged on the card, and the publics
    must carry the executor's state roots. Returns the batch, the
    executor's result, the prover, its proof, the launches of every kernel
    in the prove and `verify`, and the prove's seconds."""
    from zkevm_prover_tpu_torch.ops import stark_cuda as scu
    from zkevm_prover_tpu_torch.executor import combined, examples
    from zkevm_prover_tpu_torch.executor.sm import main_sm, memory
    from zkevm_prover_tpu_torch.stark.proof import StarkProof
    from zkevm_prover_tpu_torch.stark.prover import StarkProver
    from zkevm_prover_tpu_torch.stark.setup import StarkSetup
    from zkevm_prover_tpu_torch.stark.verifier import VerifyError, verify

    pcu.MODE = "mxu96"
    t0 = time.perf_counter()
    batch = examples.rom_batch(bits, smt, tree, ROM_SEED)
    gen_s = time.perf_counter() - t0
    fill = {sm: f"{used} of {cap} ({100 * used / cap:.1f} %)"
            for sm, (used, cap) in batch.fill.items()}
    _log(f"rom batch 2^{bits}: a ROM of {len(batch.rom)} lines made in "
         f"{gen_s:.2f} s (host; its storage ops' Smt.get/set included); ops "
         f"{json.dumps(batch.ops)}; closed by {batch.closed_by}; fill (used "
         f"of capacity less one group; main in steps) {json.dumps(fill)}")

    times: dict = {}
    t0 = time.perf_counter()
    res, traces = combined.execute_batch(
        batch.rom, bits, input=batch.input, smt=smt, include=batch.include,
        device="cuda", times=times)
    exec_s = time.perf_counter() - t0
    _log(f"rom batch executors: {exec_s:.2f} s (host); by SM (s) "
         + json.dumps({k: round(v, 3) for k, v in times.items()})
         + f"; Main counters {json.dumps(res.counters)}")
    t0 = time.perf_counter()
    air = combined.build_batch_air(batch.rom, bits, include=batch.include)
    air_s = time.perf_counter() - t0
    shape = (f"{air.n_cm1} committed / {len(air.const_names)} constant "
             f"cols, {len(air.constraints)} constraints, {len(air.lookups)} "
             f"lookups, {len(air.permutations)} permutations, "
             f"{len(air.publics)} publics")
    t0 = time.perf_counter()
    setup = StarkSetup(air, n_queries=8, fri_fold_bits=2)
    prover = StarkProver(setup, device="cuda")
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stacked = air.stack_traces(traces)
    stack_s = time.perf_counter() - t0
    _log(f"rom batch AIR: include {json.dumps(batch.include)}; {shape}; "
         f"build_batch_air {air_s:.2f} s, StarkSetup + StarkProver "
         f"{setup_s:.2f} s, stack_traces {stack_s:.2f} s (host)")

    for counters in _counters():
        for k in counters:
            counters[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = prover.prove(stacked)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    _log(f"rom batch prove 2^{bits}: {prove_s:.2f} s "
         f"({setup.n / prove_s / 1e6:.4f} Mrow/s); peak device memory "
         f"{peak:.2f} GiB; kernel launches {json.dumps(pcu.launches)}")
    _log("rom batch phases (s): " + json.dumps(
        {k: round(v, 4) for k, v in prover.phase_times.items()}))
    _log("rom batch peak device memory at each phase's end (GiB): "
         + json.dumps({k: round(v, 2)
                       for k, v in prover.phase_peak_gib.items()}))
    t0 = time.perf_counter()
    if not verify(setup, prover.verkey, proof, device="cuda"):
        _fail("verify rejected the combined batch")
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    launches = {**pcu.launches, **hcu.launches, **scu.launches}
    _log(f"rom batch verify: true ({verify_s:.2f} s); kernel launches in "
         f"prove + verify {json.dumps(launches)}")
    if launches["merkle"] == 0 or launches["mxu96"] == 0:
        _fail(f"rom batch: a kernel of the path did not run: {launches}")
    _stark_kernels_ran("rom batch", launches)
    if any(launches[mode] for mode in pcu.MODES if mode != "mxu96"):
        _fail(f"rom batch: another mode's kernel ran: {launches}")

    bad = StarkProof.from_json(proof.to_json())
    bad.fri[0].queries[0][0].values[0] += 1
    try:
        verify(setup, prover.verkey, bad, device="cuda")
    except VerifyError:
        pass
    else:
        _fail("a tampered combined proof verified")

    # the chaining publics come out of the proof, as Prover reads them
    pv = [int(x) for x in proof.publics]
    old_root = main_sm._fea8_to_fe4(pv[0:8])
    new_root = main_sm._fea8_to_fe4(pv[19:27])
    if old_root != tree.root or new_root != tuple(res.new_state_root):
        _fail(f"rom batch publics: old root {old_root}, new root "
              f"{new_root}; the executor's {tree.root}, "
              f"{res.new_state_root}")
    if new_root == tree.root:
        _fail("rom batch: the batch wrote no storage")

    # cross-SM forgery: a Memory write that no later access reads gets
    # another value; Memory alone stays consistent, Main still says the old
    mem = traces["memory"].copy()
    rows = np.nonzero((mem[:, 3] == 1) & (mem[:, 4] == 1))[0]
    if len(rows) == 0:
        _fail("rom batch: no memory write ends its address's run")
    mem[rows[0], 6] = (int(mem[rows[0], 6]) + 1) & 0xFFFFFFFF
    t0 = time.perf_counter()
    mem_prover = StarkProver(StarkSetup(memory.build_air(bits), n_queries=8,
                                        fri_fold_bits=2), device="cuda")
    if mem_prover.check_constraints(mem, quick=True) != []:
        _fail("rom batch: the forged Memory trace is not consistent alone")
    forged = air.stack_traces({**traces, "memory": mem})
    flagged = prover.check_constraints(forged, quick=True)
    # the Main-Memory permutation's two constraints (Z's first row and its
    # step) follow the AIR's own and two per lookup, as StarkSetup lists them
    pi = next(i for i, pe in enumerate(air.permutations)
              if pe.sel_t == air.cm("memory", "MOP"))
    first = (len(air.constraints) + 2 * len(air.lookups)
             + sum(len(p.aux) + 2 for p in setup.permutations[:pi]))
    if not flagged or not set(flagged) <= {first, first + 1}:
        _fail(f"rom batch: the forged Memory value flagged {flagged}, not "
              f"the Main-Memory permutation's constraints {first}, "
              f"{first + 1} alone")
    _log(f"rom batch: a tampered proof rejected; publics old root "
         f"{old_root} == the tree's, new root {new_root} == the "
         f"executor's; a forged Memory value (Memory alone consistent) "
         f"flagged on the card by check_constraints(quick=True): "
         f"{flagged}, the Main-Memory permutation's (permutation {pi}) "
         f"({time.perf_counter() - t0:.2f} s for the two "
         "checks)")
    del mem_prover, traces, forged, stacked
    return batch, res, prover, proof, launches, prove_s


# the JAX package's domain of the recursion's outer circuits
# (`Prover.wrap_batch_recursive`, `aggregate_recursive`); phase 5c gives
# them rec_bits=None instead, the smallest power of two that holds each
REC_DEFAULT_BITS = 18


def _chain_publics(proof):
    """A combined batch proof's chaining publics, read out of the proof
    as `Prover` reads them (the reference layout, prover.cpp:494-560)."""
    from zkevm_prover_tpu_torch.prover import PublicInputs
    from zkevm_prover_tpu_torch.prover.prover import _fea_publics_hex

    pv = [int(x) for x in proof.publics]
    return PublicInputs(
        old_state_root=_fea_publics_hex(pv[0:8]),
        old_acc_input_hash=_fea_publics_hex(pv[8:16]),
        old_batch_num=pv[16], chain_id=pv[17], fork_id=pv[18],
        new_state_root=_fea_publics_hex(pv[19:27]),
        new_acc_input_hash=_fea_publics_hex(pv[27:35]),
        new_local_exit_root=_fea_publics_hex(pv[35:43]),
        new_batch_num=pv[43])


def _log_outer(what: str, rp, wall: float, peak: float, node) -> None:
    """One outer prove of the recursion: the circuit's shape and domain,
    the host seconds of each step, the prove's phases, the peak and the
    proof's size."""
    pv = rp.outer_prover
    _log(f"{what} at 2^{rp.n_bits}: {wall:.2f} s in all; circuit "
         f"{json.dumps(rp.stats)} (the JAX default domain "
         f"2^{REC_DEFAULT_BITS}); host s " + json.dumps(
             {k: round(v, 2) for k, v in rp.times.items()})
         + f"; peak device memory {peak:.2f} GiB; outer AIR "
         f"{pv.setup.air.n_cm1} committed / {len(pv.setup.air.const_names)}"
         f" constant cols; proof {len(node.proof.to_json())} bytes of JSON")
    _log(f"{what} phases (s): " + json.dumps(
        {k: round(v, 4) for k, v in pv.phase_times.items()}))


# The plain chains the STARK kernels replace, counted where they run on the
# card: the proving paths must not reach them (phase 3e calls the
# originals, kept in _PLAIN, to compare).
PLAIN_CALLS = {"eval_array": 0, "calculate_z": 0}
_PLAIN: dict = {}


def _guard_plain_chains() -> None:
    """Count `expr.eval_array` over card tensors and `prover.calculate_z`
    of card tensors in PLAIN_CALLS."""
    from zkevm_prover_tpu_torch.stark import expr, prover

    def counted(name, on_card):
        fn = _PLAIN[name]

        def wrapper(*args, **kw):
            if on_card(*args, **kw):
                PLAIN_CALLS[name] += 1
            return fn(*args, **kw)
        return wrapper

    _PLAIN.update(eval_array=expr.eval_array, calculate_z=prover.calculate_z)
    expr.eval_array = counted(
        "eval_array", lambda e, b: str(b.device).startswith("cuda"))
    prover.calculate_z = counted("calculate_z", lambda num, den: num.is_cuda)


def check_stark(torch, prover) -> dict:
    """Phase 3e, the STARK kernels (csrc/stark.cu) on the combined AIR of
    phase 5b's prover (2^`ROM_BITS` rows), over random sections: each of
    its row programs (C * Zi and the FRI sums on the extended rows, the
    lookups' f/t and the num/den on the trace rows, num/den again on a
    ragged 2^bits + 37) through dag_eval_kernel against its twin
    `dag.run_plain` on the card, bit for bit, and C * Zi also against
    `expr.eval_array`; the grand product of every argument (num and den
    from that num/den run, one launch) against `calculate_z` of each, and
    of random base and GL3 operands at 2^10, 2^17, 2^20 and 2^20 + 37, at
    the tiles' edges (1, 2, a tile - 1, a tile, a tile + 1, 5 tiles + 37,
    300 tiles + 37: more than two look-back windows) in all four dim
    pairs a launch, and with a zero den in row 0, the last row and a later
    tile's row. Each timed beside its twin and its bound (`dag_bound`,
    `grand_product_bound`); no PyTorch call computes either, so the
    library time is none. Returns the kernels-line entries (without
    `launches`)."""
    from zkevm_prover_tpu_torch.ops import goldilocks as gl
    from zkevm_prover_tpu_torch.ops import stark_cuda as scu
    from zkevm_prover_tpu_torch.stark import dag
    from zkevm_prover_tpu_torch.stark import expr as ex
    from zkevm_prover_tpu_torch.stark import prover as sp

    s = prover.setup
    rng = np.random.default_rng(31)

    def u(*shape):
        return gl.from_u64(rng.integers(0, gl.P, shape, dtype=np.uint64),
                           "cuda")

    ch = rng.integers(0, gl.P, (8, 3), dtype=np.uint64)
    pub = [int(v) for v in rng.integers(0, gl.P, len(s.air.publics),
                                        dtype=np.uint64)]
    ev = rng.integers(0, gl.P, (len(s.ev_map), 3), dtype=np.uint64)
    progs = {"quotient": (prover._prog_q, s.n_ext, prover.blowup),
             "fri": (prover._prog_fri, s.n_ext, prover.blowup),
             "f_t": (prover._prog_ft[0], s.n, 1),
             "num_den": (prover._prog_num_den[0], s.n, 1),
             "num_den_ragged": (prover._prog_num_den[0], s.n + 37, 1)}
    times, plain, bounds = {}, {}, {}
    for name, (prog, rows, stride) in progs.items():
        secs = {k: u(rows, w) for k, w in s.section_width.items()}
        secs.update(const=u(rows, s.air.n_constants), x=u(rows), zi=u(rows))
        uni = prog.uniform_values(ch, pub, ev)
        width = max(o.col + 3 for o in prog.outputs)
        out = torch.full((rows, width), -1, dtype=torch.int64, device="cuda")
        want = out.clone()
        times[name] = _time_ms(lambda: dag.run(
            prog, secs, uni, out, rows=rows, prime_stride=stride), reps=5)
        t0 = time.perf_counter()
        dag.run_plain(prog, secs, uni, want, rows=rows, prime_stride=stride)
        torch.cuda.synchronize()
        plain[name] = 1e3 * (time.perf_counter() - t0)
        if not torch.equal(out, want):
            _fail(f"dag_eval {name} at {rows} rows != dag.run_plain")
        bounds[name] = dag_bound(prog, rows)
        note = ""
        if name == "quotient":
            b = ex.ArrayBindings(
                cm=lambda cid: prover._col(secs, cid),
                const=lambda i: secs["const"][:, i], device="cuda",
                challenges=gl.from_u64(ch, "cuda"),
                publics=gl.from_u64(np.array(pub, np.uint64), "cuda"),
                x=secs["x"], zi=secs["zi"], prime_stride=stride)
            t0 = time.perf_counter()
            ref = _PLAIN["eval_array"](s.c_combined * ex.Zi(), b)
            torch.cuda.synchronize()
            eval_ms = 1e3 * (time.perf_counter() - t0)
            if not torch.equal(out, ref):
                _fail("dag_eval C * Zi != eval_array")
            del ref, b
            note = f"; == eval_array ({eval_ms:.1f} ms)"
        if name == "num_den":
            nd = out
        plan = scu.dag_plan(prog, rows)
        tiles = -(-rows // scu.DAG_ROWS)
        _log(f"dag_eval {name} ({prog.n_ops} instructions, {prog.n_slots} "
             f"slots, chunk {prog.chunk}, {len(prog.leaves)} leaf words, "
             f"{prog.leaf_reads} leaf reads a row, "
             f"{len(prog.uniform_roots)} uniform entries) at {rows} rows: "
             f"kernel {times[name]:.3f} ms "
             f"({100 * bounds[name][0] / times[name]:.2f} % of bound; before "
             f"the redesign {DAG_MS_BEFORE[name]} ms, "
             f"{100 * bounds[name][0] / DAG_MS_BEFORE[name]:.2f} %), == "
             f"run_plain ({plain[name]:.1f} ms){note}; bound "
             f"{bounds[name][0]:.4f} ms ({bounds[name][1]}); shared memory "
             f"{plan['smem']} B a block, grid {plan['grid']} blocks of "
             f"{scu.DAG_ROWS} rows over {tiles} tiles (up to "
             f"{-(-tiles // plan['grid'])} a block), leaf scratch "
             f"{plan['scratch']} B")
        del secs, out, want
        torch.cuda.empty_cache()

    # kernel B on every argument of the AIR, num and den from the kernel
    _, _, layout = prover._prog_num_den
    z = torch.full((s.n, 3 * len(layout)), -1, dtype=torch.int64,
                   device="cuda")
    args, dims = [], []
    for k, (nc, ndim, dc, ddim) in enumerate(layout):
        args.append((nd[:, nc] if ndim == 1 else nd[:, nc:nc + 3],
                     nd[:, dc] if ddim == 1 else nd[:, dc:dc + 3],
                     z[:, 3 * k:3 * k + 3]))
        dims.append((ndim, ddim))
    gp_ms = _time_ms(lambda: sp.grand_products(args), reps=5)
    t0 = time.perf_counter()
    want = [_PLAIN["calculate_z"](num, den) for num, den, _ in args]
    torch.cuda.synchronize()
    gp_plain = 1e3 * (time.perf_counter() - t0)
    if any(not torch.equal(zk, w) for (_, _, zk), w in zip(args, want)):
        _fail("grand_product of the AIR's arguments != calculate_z")
    gp_bound = grand_product_bound(s.n, dims)
    gp_plan = scu.grand_product_plan()
    _log(f"grand_product: {len(args)} arguments at 2^{s.n_bits} in one "
         f"launch {gp_ms:.3f} ms ({100 * gp_bound[0] / gp_ms:.2f} % of "
         f"bound; before the redesign {GP_MS_BEFORE} ms, "
         f"{100 * gp_bound[0] / GP_MS_BEFORE:.2f} %), == calculate_z of "
         f"each ({gp_plain:.1f} ms); bound {gp_bound[0]:.4f} ms "
         f"({gp_bound[1]}); tile {gp_plan['tile']} rows, "
         f"{gp_plan['threads']} threads a block, {gp_plan['registers']} "
         f"registers, {gp_plan['local_bytes']} B of stack, "
         f"{gp_plan['smem']} B of shared memory and "
         f"{gp_plan['blocks_per_sm']} blocks an SM (GL3)")
    del nd, z, args, want
    sizes = {}
    for n in (1 << 10, 1 << 17, 1 << 20, (1 << 20) + 37):
        for nd_, dd in ((1, 1), (3, 3)):
            num = u(n) if nd_ == 1 else u(n, 3)
            den = u(n) if dd == 1 else u(n, 3)
            zz = torch.empty((n, 3), dtype=torch.int64, device="cuda")
            ms = _time_ms(lambda: sp.grand_products([(num, den, zz)]))
            if not torch.equal(zz, _PLAIN["calculate_z"](num, den)):
                _fail(f"grand_product ({nd_}, {dd}) at {n} != calculate_z")
            sizes[f"{n}:{nd_}{dd}"] = ms
    # the tiles' and the look-back windows' edges, all four dim pairs in
    # one launch (not timed)
    tile = gp_plan["tile"]
    edges = [1, 2, tile - 1, tile, tile + 1, 5 * tile + 37,
             300 * tile + 37]
    for n in edges:
        ops = [(u(n) if nd_ == 1 else u(n, 3), u(n) if dd == 1 else u(n, 3),
                torch.empty((n, 3), dtype=torch.int64, device="cuda"))
               for nd_, dd in ((1, 1), (3, 3), (1, 3), (3, 1))]
        sp.grand_products(ops)
        for num, den, zz in ops:
            if not torch.equal(zz, _PLAIN["calculate_z"](num, den)):
                _fail(f"grand_product at {n} rows ({num.ndim}, {den.ndim} "
                      "dims) != calculate_z")
    n = 1 << 17
    for dd in (1, 3):
        for row in (0, n - 1, 12345):
            num, den = u(n, 3), (u(n) if dd == 1 else u(n, 3))
            den[row] = 0
            zz = torch.empty((n, 3), dtype=torch.int64, device="cuda")
            sp.grand_products([(num, den, zz)])
            if not torch.equal(zz, _PLAIN["calculate_z"](num, den)) or \
                    zz[0].tolist() != [1, 0, 0] or bool(zz[1:].any()):
                _fail(f"grand_product with a zero den in row {row} (dim "
                      f"{dd}) != calculate_z's (1, 0, 0, ...)")
    _log("grand_product == calculate_z on random base and GL3 operands at "
         "2^10, 2^17, 2^20 and 2^20 + 37 (ms " + json.dumps(
             {k: round(v, 4) for k, v in sizes.items()}) + "), at the "
         f"tiles' edges {edges} in all four dim pairs a launch, and with a "
         "zero den in the first, the last and a later tile's row (z = (1, "
         "0, 0, ...))")
    torch.cuda.empty_cache()
    return {
        "dag_eval": {
            "name": "stark_dag_eval", "route": "cuda",
            "source": "zkevm_prover_tpu_torch/csrc/stark.cu",
            "replaces": "zkevm_prover_tpu/stark/prover.py:416",
            "max_abs_err": 0, "ms": times["quotient"],
            "plain_ms": plain["quotient"], "bound_ms": bounds["quotient"][0],
            "bound_by": bounds["quotient"][1], "library_ms": None,
            "ms_by_program": times, "plain_ms_by_program": plain,
            "bound_ms_by_program": {k: v[0] for k, v in bounds.items()}},
        "grand_product": {
            "name": "stark_grand_product", "route": "cuda",
            "source": "zkevm_prover_tpu_torch/csrc/stark.cu",
            "replaces": "zkevm_prover_tpu/stark/prover.py:125",
            "max_abs_err": 0, "ms": gp_ms, "plain_ms": gp_plain,
            "bound_ms": gp_bound[0], "bound_by": gp_bound[1],
            "library_ms": None, "arguments": len(layout),
            "log2_rows": s.n_bits, "ms_by_size": sizes,
            "ms_before": GP_MS_BEFORE, "plan": gp_plan}}


def run_recursion(torch, pcu, hcu, smt, tree, batch_a, res_a, prover_a,
                  proof_a, first_s: float) -> dict:
    """Phase 5c, the recursion over the full-width combined batch: batch A
    is phase 5b's proof; batch B is the generator's next ROM
    (`rom_batch(bits, smt, tree at A's new root, ROM_SEED + 1)`) over the
    state A left, proved under torch.profiler (device events, busy time,
    idle share, top device ops) and verified. Each is wrapped by `Prover(device="cuda").
    wrap_batch_recursive` (recursive1), the two nodes joined by
    `aggregate_recursive` (recursive2, the publics chained in the
    circuit); `verify_recursive` must accept both r1 nodes and the r2
    root, reject a tampered r1 and r2 proof, and the reversed pair must
    raise ValueError. Logs each circuit's shape, the host seconds of its
    synthesis, compile_air and setup, each outer prove's seconds, phases
    and peak device memory, and the proof sizes. Counters zeroed before
    the first wrap, read after the last verify: the fused Merkle kernel
    and mxu96 must have run, and no other mode's kernel. Returns them."""
    from zkevm_prover_tpu_torch.ops import stark_cuda as scu
    from zkevm_prover_tpu_torch.executor import combined, examples
    from zkevm_prover_tpu_torch.prover import Prover
    from zkevm_prover_tpu_torch.prover.prover import BatchProof
    from zkevm_prover_tpu_torch.stark.proof import StarkProof
    from zkevm_prover_tpu_torch.stark.prover import StarkProver
    from zkevm_prover_tpu_torch.stark.setup import StarkSetup
    from zkevm_prover_tpu_torch.stark.verifier import VerifyError, verify

    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bits = batch_a.n_bits
    pcu.MODE = "mxu96"
    post = dataclasses.replace(
        tree, root=tuple(int(v) for v in res_a.new_state_root))
    t0 = time.perf_counter()
    batch_b = examples.rom_batch(bits, smt, post, ROM_SEED + 1)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_b, traces = combined.execute_batch(
        batch_b.rom, bits, input=batch_b.input, smt=smt,
        include=batch_b.include, device="cuda")
    exec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    air_b = combined.build_batch_air(batch_b.rom, bits,
                                     include=batch_b.include)
    prover_b = StarkProver(StarkSetup(air_b, n_queries=8, fri_fold_bits=2),
                           device="cuda")
    setup_s = time.perf_counter() - t0
    if prover_b.setup.describe() != prover_a.setup.describe() or \
            len(air_b.constraints) != len(prover_a.setup.air.constraints):
        _fail("rom batch B: its AIR's shape differs from batch A's")
    stacked = air_b.stack_traces(traces)
    del traces
    _log(f"rom batch B 2^{bits}: a ROM of {len(batch_b.rom)} lines over "
         f"batch A's post-state made in {gen_s:.2f} s, closed by "
         f"{batch_b.closed_by}, ops {json.dumps(batch_b.ops)}; "
         f"execute_batch {exec_s:.2f} s, AIR + setup {setup_s:.2f} s "
         "(host); the same AIR shape as batch A")
    for counters in _counters():
        for k in counters:
            counters[k] = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proof_b = prover_b.prove(stacked)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in events) / 1e9
    top: dict = {}
    for e in events:
        label = _kernel_label(e.name())
        top[label] = top.get(label, 0) + e.duration_ns() / 1e9
    top = sorted(top.items(), key=lambda kv: -kv[1])[:10]
    walk_s = time.perf_counter() - t0
    _log(f"combined batch B 2^{bits} first prove under torch.profiler: "
         f"{wall:.3f} s (batch A's {first_s:.3f} s, not profiled); "
         f"{len(events)} device events, device busy {busy:.3f} s, idle "
         f"share {1 - busy / wall:.3f}; launches {json.dumps(scu.launches)}"
         f"; top device ops (s) " + json.dumps(
             [(name, round(t, 4)) for name, t in top])
         + f"; the event walk {walk_s:.1f} s; phases (s): " + json.dumps(
             {k: round(v, 4) for k, v in prover_b.phase_times.items()}))
    del prof, events
    del stacked
    if not verify(prover_b.setup, prover_b.verkey, proof_b, device="cuda"):
        _fail("verify rejected the combined batch B")
    bp_a = BatchProof(publics=_chain_publics(proof_a),
                      sm_proofs={"batch": (prover_a, proof_a)},
                      counters=dict(res_a.counters))
    bp_b = BatchProof(publics=_chain_publics(proof_b),
                      sm_proofs={"batch": (prover_b, proof_b)},
                      counters=dict(res_b.counters))
    a, b = bp_a.publics, bp_b.publics
    if (a.new_state_root, a.new_acc_input_hash, a.new_batch_num) != \
            (b.old_state_root, b.old_acc_input_hash, b.old_batch_num):
        _fail(f"rom batch B does not chain on A: {a} / {b}")
    if b.new_state_root == b.old_state_root:
        _fail("rom batch B wrote no storage")
    _log(f"rom batch B verifies and chains on A: A {a.old_state_root} -> "
         f"{a.new_state_root}, B -> {b.new_state_root}")

    prover = Prover(device="cuda")
    for counters in _counters():
        for k in counters:
            counters[k] = 0
    nodes = []
    for name, bp in (("A", bp_a), ("B", bp_b)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        nodes.append(prover.wrap_batch_recursive(bp, rec_bits=None))
        torch.cuda.synchronize()
        _log_outer(f"recursive1 of batch {name}", prover._r1,
                   time.perf_counter() - t0,
                   torch.cuda.max_memory_allocated() / 2**30, nodes[-1])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    root = prover.aggregate_recursive(nodes, rec_bits=None)
    torch.cuda.synchronize()
    _log_outer("recursive2 join of A and B", prover._r2,
               time.perf_counter() - t0,
               torch.cuda.max_memory_allocated() / 2**30, root)
    _log("recursion Prover timers: " + json.dumps(
        {k: v for k, v in prover.metrics.snapshot().items()
         if "RECURSIVE" in k}, default=str))

    t0 = time.perf_counter()
    for node in (*nodes, root):
        if not prover.verify_recursive(node):
            _fail(f"verify_recursive rejected the {node.kind} node")
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    launches = {**pcu.launches, **hcu.launches, **scu.launches}
    _log(f"recursion: verify_recursive true for both r1 nodes and the r2 "
         f"root ({verify_s:.2f} s); root publics old root "
         f"{root.publics.old_state_root} -> new {root.publics.new_state_root}"
         f"; kernel launches {json.dumps(launches)}")
    if launches["merkle"] == 0 or launches["mxu96"] == 0:
        _fail(f"recursion: a kernel of the path did not run: {launches}")
    _stark_kernels_ran("recursion", launches)
    if any(launches[mode] for mode in pcu.MODES if mode != "mxu96"):
        _fail(f"recursion: another mode's kernel ran: {launches}")

    for node in (nodes[0], root):
        bad = StarkProof.from_json(node.proof.to_json())
        bad.fri[0].queries[0][0].values[0] += 1
        try:
            ok = prover.verify_recursive(dataclasses.replace(node, proof=bad))
        except VerifyError:
            ok = False
        if ok:
            _fail(f"a tampered {node.kind} proof verified")
    try:
        prover.aggregate_recursive(nodes[::-1])
    except ValueError as e:
        broken = str(e)
    else:
        _fail("aggregate_recursive joined a pair that does not chain")
    _log(f"recursion: a tampered r1 and a tampered r2 proof rejected; the "
         f"reversed pair raised ValueError ({broken})")
    # the Prover's request thread keeps it alive: drop its outer circuits
    prover._r1 = prover._r2 = None
    return launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=17,
                    help="log2 rows of every SM but arith in the "
                         "co-processor and storage batches (reference: 23)")
    ap.add_argument("--arith-bits", type=int, default=18,
                    help="log2 rows of arith (reference: 23)")
    ap.add_argument("--cpu-proofs", metavar="PATH",
                    help=argparse.SUPPRESS)  # the child of start_cpu_proofs
    args = ap.parse_args()

    import torch

    if args.cpu_proofs:
        torch.set_num_threads(5)
        cpu_proofs(args.cpu_proofs)
        return 0

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    tmp = tempfile.TemporaryDirectory()
    cpu_path = f"{tmp.name}/cpu_proofs.json"
    child = start_cpu_proofs(cpu_path)
    try:
        return run(args, torch, child, cpu_path)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        tmp.cleanup()


def run(args, torch, child, cpu_path) -> int:
    import os

    from zkevm_prover_tpu_torch import cuda_build
    from zkevm_prover_tpu_torch.ops import goldilocks as gl
    from zkevm_prover_tpu_torch.ops import hash_cuda as hcu
    from zkevm_prover_tpu_torch.ops import poseidon_cuda as pcu
    from zkevm_prover_tpu_torch.ops import poseidon_gl as pg

    tmp_dir = os.path.dirname(cpu_path)   # the checkpoints go here too
    _guard_plain_chains()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    cuda_build.build()
    _log(f"build: {time.perf_counter() - t0:.2f} s")
    for name in cuda_build.KERNELS:
        _log(cuda_build.log_path(name).read_text().strip())

    entries = check_poseidon(torch, gl, pg, pcu)
    entries["merkle"] = check_merkle(torch, gl, pcu)
    entries.update(check_hash(torch, gl))
    entries.update(check_bn254(torch))
    check_ntt(torch, gl)
    smt, tree, tree_launches = run_state_tree(torch, pcu, hcu, TREE_BITS)
    storage_launches = run_storage_batch(torch, pcu, hcu, smt, tree,
                                         args.bits)
    hash_launches = run_hash_batch(torch, pcu, hcu)
    batch_a, res_a, rom_prover, rom_proof, rom_launches, rom_s = \
        run_rom_batch(torch, pcu, hcu, smt, tree, ROM_BITS)
    entries.update(check_stark(torch, rom_prover))
    rec_launches = run_recursion(torch, pcu, hcu, smt, tree, batch_a, res_a,
                                 rom_prover, rom_proof, rom_s)
    del smt, tree, rom_prover, rom_proof, batch_a, res_a
    torch.cuda.empty_cache()
    final_launches = run_final_wrap(torch, pcu, hcu)
    torch.cuda.empty_cache()
    ckpt = f"{tmp_dir}/batch.commit"
    prover, bp, proved, main_launches = run_batch(
        torch, pcu, hcu, args.bits, args.arith_bits, ckpt)
    # each main path read with the counters zeroed just before it
    paths = {"coprocessor_batch": main_launches, "state_tree": tree_launches,
             "storage_batch": storage_launches, "hash_batch": hash_launches,
             "combined_batch": rom_launches, "recursion": rec_launches}
    for kernel in ("mxu96", "merkle", "keccak_f", "sha256_compress",
                   "blake2b_compress"):
        entries[kernel]["launches_by_path"] = {
            path: counts[kernel] for path, counts in paths.items()}
        entries[kernel]["launches"] = sum(
            entries[kernel]["launches_by_path"].values())
    # the STARK kernels run wherever a STARK is proved, the final wrap's
    # BN128 re-proofs too
    for kernel in ("dag_eval", "grand_product"):
        entries[kernel]["launches_by_path"] = {
            path: counts[kernel] for path, counts in
            {**paths, "final_wrap": final_launches}.items()}
        entries[kernel]["launches"] = sum(
            entries[kernel]["launches_by_path"].values())
    # the BN254 kernels run on the final wrap's path alone
    for kernel in BN254_KERNELS:
        entries[kernel]["launches_by_path"] = {
            "final_wrap": final_launches[kernel]}
        entries[kernel]["launches"] = final_launches[kernel]
    traces = check_checkpoint(ckpt, proved)
    del proved
    for mode, n in run_modes(torch, pcu, prover, bp, traces,
                             f"{tmp_dir}/mem_align.commit").items():
        if mode != "mxu96":
            entries[mode]["launches"] = n
    del prover, bp, traces
    torch.cuda.empty_cache()
    check_small_proofs(child, cpu_path)
    if any(PLAIN_CALLS.values()):
        _fail(f"the plain chains ran on the card's paths: {PLAIN_CALLS}")
    _log(f"plain chains on the card's paths: {json.dumps(PLAIN_CALLS)}")

    _log("chip_smoke: done")
    print(json.dumps({"kernels": [entries[m] for m in
                                  ("mxu96", "merkle", "mxu24", "mxu",
                                   "blocked", "1d", "2d", "keccak_f",
                                   "sha256_compress", "blake2b_compress",
                                   *BN254_KERNELS, "dag_eval",
                                   "grand_product")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
