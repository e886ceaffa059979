"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--bits N] [--arith-bits N]

Phases (any failure exits nonzero; no phase catches and continues, except
that an SM whose full-width proof runs out of device memory is stepped down
one bit at a time, each cut printed with its reason):

 1. card line: name and power limit from nvidia-smi;
 2. build every CUDA kernel of the port from `zkevm_prover_tpu_torch/csrc`
    (one nvcc per library source, all at once: today the one poseidon_gl
    library);
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
 4. small proofs on the card against the port's CPU proofs, byte for byte:
    the four toy AIRs, PoseidonG at 2^8, and the mixed batch of all seven
    ported SMs at 2^9 through `Executor.prove_all`;
 5. the main path: the co-processor batch at full width under
    `poseidon_cuda.MODE = "mxu96"` — every ported SM filled to its capacity
    less one group (`executor.examples.full_batch`), each executed and
    proved through `Executor.execute` / `prove_traces` (the halves of
    `prove_all`), then `verify_all`, and a tampered proof of each SM must be
    rejected. The kernel launch counters are zeroed just before the proofs
    and read just after `verify_all`: the fused Merkle kernel (every commit)
    and the mxu96 permutation (the verifier's paths) must both have run,
    and no other mode's kernel;
 6. every other mode on the path: mem_align's full-width trace re-proved
    under each mode, counters zeroed before and read after: under mxu96 the
    commits go through the fused Merkle kernel, under every other mode
    through that mode's permutation and never the fused kernel; each proof
    must equal the mxu96 proof byte for byte;
 7. a steady re-prove of arith (the widest AIR), timed alone and under
    torch.profiler (device busy time, idle share, the Poseidon kernels'
    share, the top device ops);
 8. a kernels line (JSON: each mode's kernel and the fused Merkle kernel,
    its launches on the path, its time, its bound and its plain version's
    time) and a final line {"ok": true, "device": {...}}.

It needs the CUDA toolkit (nvcc) and one card; without CUDA it exits
nonzero before printing anything.
"""

from __future__ import annotations

import argparse
import json
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


# artifacts/bench/measure_baseline_r05.json: exact field results
R05_CHECKSUM = 16096883102802302962   # poseidon, default_rng(1) (2^20, 12)
R05_NTT_CHECKSUM = 8023521091960532272  # extend_pol, default_rng(0) (2^23, 4)


_T0 = time.perf_counter()


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


def small_proofs(device: str) -> dict:
    """Proof JSON of the toy AIRs, PoseidonG at 2^8 and the mixed batch of
    every ported SM at 2^9, proved on `device`; each card proof must also
    verify."""
    from zkevm_prover_tpu_torch.executor import BatchActions, Executor
    from zkevm_prover_tpu_torch.executor.examples import mixed_batch
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
    return out


def start_cpu_proofs(path: str):
    """The CPU side of the small proofs, in a child process that runs while
    the card works (it sees no card)."""
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, __file__, "--cpu-proofs", path],
                            env=env)


def check_small_proofs(child, path: str) -> None:
    """Card proof bytes == the child's CPU proof bytes, for each proof."""
    t0 = time.perf_counter()
    card = small_proofs("cuda")
    t1 = time.perf_counter()
    if child.wait() != 0:
        _fail(f"the CPU proofs' process exited with {child.returncode}")
    with open(path) as f:
        cpu = json.load(f)
    if sorted(cpu) != sorted(card) or len(card) != 4 + 1 + 7:
        _fail(f"proved {sorted(card)} on the card, {sorted(cpu)} on the CPU")
    for name, text in card.items():
        if text != cpu[name]:
            _fail(f"{name}: card proof differs from CPU proof")
    _log(f"small proofs ({', '.join(card)}): card proof JSON == CPU proof "
         f"JSON; card {t1 - t0:.1f} s, then {time.perf_counter() - t1:.1f} s "
         "waiting for the CPU")


def _prove_sm(torch, ex, name, actions):
    """Execute and prove one SM's actions; returns (trace, prover, proof,
    executor s, prove s, peak GiB)."""
    from zkevm_prover_tpu_torch.executor import BatchActions

    t0 = time.perf_counter()
    trace = ex.execute(BatchActions(**{name: actions}))[name]
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    prover, proof = ex.prove_traces({name: trace})[name]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (trace, prover, proof, t1 - t0, t2 - t1,
            torch.cuda.max_memory_allocated() / 2**30)


def run_batch(torch, pcu, bits: int, arith_bits: int) -> dict:
    """The co-processor batch at full width under MODE mxu96, proved and
    verified; returns {name: (trace, prover, proof)} and the launches of
    each kernel in it."""
    import gc

    from zkevm_prover_tpu_torch.executor import Executor, examples
    from zkevm_prover_tpu_torch.stark.proof import StarkProof
    from zkevm_prover_tpu_torch.stark.verifier import VerifyError, verify

    sizes = {name: bits for name in
             ("binary", "memory", "mem_align", "poseidon_g", "padding_pg",
              "climb_key")}
    sizes["arith"] = arith_bits
    ex = Executor(n_bits=sizes, device="cuda")
    _log(f"batch sizes (log2 rows): {json.dumps(ex.n_bits)}; binary slice "
         f"{ex.binary_slice_bits()} bits")
    pcu.MODE = "mxu96"
    for mode in pcu.launches:
        pcu.launches[mode] = 0
    out, peak = {}, 0.0
    t_batch = time.perf_counter()
    batch = examples.full_batch(ex)
    _log(f"batch actions made: {time.perf_counter() - t_batch:.1f} s")
    for name in ("binary", "memory", "arith", "mem_align", "poseidon_g",
                 "padding_pg", "climb_key"):
        while True:
            actions = batch[name]
            try:
                trace, prover, proof, t_ex, t_pr, gib = _prove_sm(
                    torch, ex, name, actions)
                break
            except torch.cuda.OutOfMemoryError as e:
                reason = str(e).splitlines()[0]
            ex._provers.pop(name, None)
            gc.collect()
            torch.cuda.empty_cache()
            if ex.n_bits[name] <= 16:
                _fail(f"{name}: out of device memory at 2^{ex.n_bits[name]}")
            _log(f"cut: {name} 2^{ex.n_bits[name]} -> 2^{ex.n_bits[name] - 1}"
                 f": out of device memory ({reason})")
            ex.n_bits[name] -= 1
            batch = examples.full_batch(ex)
        peak = max(peak, gib)
        out[name] = (trace, prover, proof)
        n = prover.setup.n
        _log(f"batch {name} 2^{ex.n_bits[name]} ({len(actions)} actions, "
             f"{prover.setup.air.n_cm1} committed cols): executor {t_ex:.2f} "
             f"s, prove {t_pr:.2f} s ({n / t_pr / 1e6:.4f} Mrow/s), peak "
             f"device memory {gib:.2f} GiB")
        _log(f"batch {name} phases (s): " + json.dumps(
            {k: round(v, 4) for k, v in prover.phase_times.items()}))
    torch.cuda.synchronize()
    _log(f"batch: {time.perf_counter() - t_batch:.1f} s in all; peak device "
         f"memory {peak:.2f} GiB; kernel launches in the proofs "
         f"{json.dumps(pcu.launches)}")

    t0 = time.perf_counter()
    proofs = {name: (prover, proof) for name, (_, prover, proof) in out.items()}
    if not ex.verify_all(proofs):
        _fail("verify_all rejected the batch")
    torch.cuda.synchronize()
    launches = dict(pcu.launches)
    _log(f"batch verify_all: true ({time.perf_counter() - t0:.2f} s); kernel "
         f"launches in proofs + verify {json.dumps(launches)}")
    if launches["merkle"] == 0:
        _fail("the fused Merkle kernel was not launched on the main path")
    if launches["mxu96"] == 0:
        _fail("the mxu96 kernel was not launched on the main path")
    if any(n for mode, n in launches.items() if mode not in ("mxu96",
                                                             "merkle")):
        _fail(f"another mode's kernel ran under MODE mxu96: {launches}")
    for name, (prover, proof) in proofs.items():
        bad = StarkProof.from_json(proof.to_json())
        bad.fri[0].queries[0][0].values[0] += 1
        try:
            verify(prover.setup, prover.verkey, bad, device="cuda")
        except VerifyError:
            continue
        _fail(f"a tampered {name} proof verified")
    _log(f"batch: a tampered proof of each of the {len(proofs)} SMs rejected")
    return out, launches


def run_modes(torch, pcu, trace, prover, proof) -> dict:
    """mem_align's full-width trace re-proved under every mode, mxu96 first
    for its steady time; returns each mode's launches in its prove (under
    mxu96, the fused Merkle kernel's)."""
    ref = proof.to_json()
    launches, times = {}, {}
    try:
        for mode in ("mxu96", "1d", "2d", "blocked", "mxu", "mxu24"):
            pcu.MODE = mode
            for m in pcu.launches:
                pcu.launches[m] = 0
            t0 = time.perf_counter()
            got = prover.prove(trace).to_json()
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
                _fail(f"mode {mode}: mem_align proof differs from mxu96's")
    finally:
        pcu.MODE = "mxu96"
    _log(f"modes: mem_align 2^{prover.setup.n_bits} proof under every mode "
         f"== the mxu96 proof; launches {json.dumps(launches)}")
    _log("modes: steady mem_align prove (s): " + json.dumps(
        {m: round(t, 3) for m, t in times.items()}))
    return launches


def profile_prove(torch, name, prover, trace) -> None:
    """A steady prove of the trace, timed alone and then under
    torch.profiler: device busy time, the Poseidon kernels' share of it, the
    device's idle share of the profiled wall time, and the top device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    prover.prove(trace)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    # device activity only, summed from the raw events: the prove launches
    # about a million kernels, and key_averages() takes ~0.3 ms per event
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prover.prove(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    n_kernels = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
            n_kernels += 1
    if not by_name:
        _fail("torch.profiler recorded no device events")
    busy_s = sum(by_name.values()) / 1e9
    pos_s = sum(v for k, v in by_name.items()
                if ("permute" in k or "merkle" in k) and "_kernel" in k) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    top = [(k.removeprefix("void ").removeprefix("at::native::")[:110], v)
           for k, v in top]
    _log(f"{name} steady prove: {steady:.3f} s "
         f"({prover.setup.n / steady / 1e6:.4f} Mrow/s); profiled wall "
         f"{wall:.3f} s, {n_kernels} device events, device busy "
         f"{busy_s:.3f} s (idle share "
         f"{1 - busy_s / wall:.3f}), poseidon kernels {pos_s:.4f} s "
         f"({100 * pos_s / busy_s:.1f} % of busy)")
    _log(f"{name} top device time (s): " + json.dumps(
        [[k, round(v / 1e9, 4)] for k, v in top]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=20,
                    help="log2 rows of every SM but arith (reference: 23)")
    ap.add_argument("--arith-bits", type=int, default=19,
                    help="log2 rows of arith (reference: 23)")
    ap.add_argument("--cpu-proofs", metavar="PATH",
                    help=argparse.SUPPRESS)  # the child of start_cpu_proofs
    args = ap.parse_args()

    import torch

    if args.cpu_proofs:
        torch.set_num_threads(6)
        with open(args.cpu_proofs, "w") as f:
            json.dump(small_proofs("cpu"), f)
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
    from zkevm_prover_tpu_torch import cuda_build
    from zkevm_prover_tpu_torch.ops import goldilocks as gl
    from zkevm_prover_tpu_torch.ops import poseidon_cuda as pcu
    from zkevm_prover_tpu_torch.ops import poseidon_gl as pg

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
    check_ntt(torch, gl)
    check_small_proofs(child, cpu_path)
    batch, main_launches = run_batch(torch, pcu, args.bits, args.arith_bits)
    entries["mxu96"]["launches"] = main_launches["mxu96"]
    entries["merkle"]["launches"] = main_launches["merkle"]
    trace, prover, proof = batch["mem_align"]
    for mode, n in run_modes(torch, pcu, trace, prover, proof).items():
        if mode != "mxu96":
            entries[mode]["launches"] = n
    trace, prover, _ = batch["arith"]
    profile_prove(torch, "arith", prover, trace)

    _log("chip_smoke: done")
    print(json.dumps({"kernels": [entries[m] for m in
                                  ("mxu96", "merkle", "mxu24", "mxu",
                                   "blocked", "1d", "2d")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
