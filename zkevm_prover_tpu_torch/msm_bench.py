"""Time and profile the BN254 MSM (csrc/bn254.cu through
`ops/bn254_cuda.msm`) and, on request, the Fr NTT and pointwise step on
the card, optionally against another checkout's kernels in the same
process:

    python3 -m zkevm_prover_tpu_torch.msm_bench [--parent DIR] [--profile]
        [--rounds 1] [--cases g1:22 g2_skewed:20 fr_ntt:22 ...]

The default cases: G1 at 2^10, 2^20 and 2^22 points and G2 at 2^10 and
2^20 with random scalars below r, and the witness-like skewed sets at G1
2^21 and G2 2^20 (`card_bench.skewed_scalars`: half of the scalars 0 or 1,
a quarter below 2^64, a quarter dense, about one point in 64 at
infinity). The bases are k_i * G from this tree's fixed-base kernel, so
every MSM is checked against g*_mul_gen(sum s_i k_i mod r) on the host.
`fr_ntt:B` (a forward NTT of 2^B random elements), the Groth16 chain's
forms `fr_intt:B` (inverse), `fr_ntt_coset:B` (forward after the coset
shift) and `fr_intt_post:B` (inverse, then the unshift) and
`fr_pointwise:B` ((a b - c) z over 2^B) are checked against their plain
twins on the card. The fixed-base cases `g1_fb:B` / `g2_fb:B` (2^B random
scalars) and `g1_fb_crs` / `g2_fb_crs` (the 2^21 CRS's 6,641,164 G1 and
1,514,673 G2 scalars) are checked against g*_mul_gen on 1,024 sampled
scalars and timed warm (`ms`) and cold (`cold_ms`: the tree's cached
table dropped before each call, so that the call builds its own).

`--parent DIR` loads DIR's `zkevm_prover_tpu_torch` package under another
name beside this one, so that its libraries and wrappers run in this
process, and times the two in turns, parent, this, this, parent, for each
of `--rounds`, each result equal to the other's. A turn times `REPS` calls
at 2^20 and above, `SMALL_REPS` below. `--profile` runs one call of each
case (of each tree) under torch.profiler and prints the device time of
every kernel and torch op, the device's busy time, the span from the
first to the last device event and the gaps in it (the host's syncs and
launch waits). Prints one JSON line per measurement, then the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

from .card_bench import (cold_ms, device_profile, random_fr,
                         skewed_bases_k, skewed_scalars)
from .ops.bn254 import R

CASES = (("g1", 10), ("g1", 20), ("g1", 22), ("g2", 10), ("g2", 20),
         ("g1_skewed", 21), ("g2_skewed", 20))
# the 2^21 CRS's fixed-base scalars (chip_smoke.FB_CRS)
CRS = {"g1_fb_crs": 6_641_164, "g2_fb_crs": 1_514_673}
# the Groth16 chain's NTT forms (snark/groth16.py _quotient_coeffs, its
# coset shift COSET = 5 and the unshift by 1/5)
FR_FORMS = {"fr_ntt": {}, "fr_intt": {"inverse": True},
            "fr_ntt_coset": {"shift": 5},
            "fr_intt_post": {"inverse": True, "post": pow(5, R - 2, R)}}
REPS = 3          # timed calls a turn at 2^20 and above
SMALL_REPS = 10   # below 2^20


def load_tree(root: str, alias: str):
    """The bn254_cuda and bn254_device modules of the checkout at `root`,
    its package imported as `alias` (its own build directory, libraries
    and counters)."""
    pkg = Path(root).resolve() / "zkevm_prover_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{alias}.ops.bn254_cuda"),
            importlib.import_module(f"{alias}.ops.bn254_device"))


def _case(torch, bd, group: str, bits):
    """(run, check) of a case: run(cu) calls one tree's wrapper (cu, its
    bn254_cuda) on the case's inputs, check(out) says whether a result is
    right."""
    from .ops import bn254 as host

    n = CRS[group] if bits is None else 1 << bits
    if group.startswith("fr_"):
        a, b, c = (random_fr(torch, n, 40 + bits + i) for i in range(3))
        if group in FR_FORMS:
            kw = FR_FORMS[group]
            want = bd.fr_ntt_plain(a, **kw)
            return ((lambda cu: cu.fr_ntt(a, **kw)),
                    (lambda o: torch.equal(o, want)))
        want = bd.fr_pointwise_plain(a, b, c, 12345)
        return ((lambda cu: cu.fr_pointwise(a, b, c, 12345)),
                (lambda o: torch.equal(o, want)))
    g2 = group.startswith("g2")
    if "_fb" in group:
        k = random_fr(torch, n, 60 + n % 97)
        idx = torch.randperm(n, device=k.device,
                             generator=torch.Generator(k.device)
                             .manual_seed(n))[:1024]
        mul = host.g2_mul_gen if g2 else host.g1_mul_gen
        want = [mul(v) for v in bd.limbs_to_ints(k[idx])]
        unpack = bd.unpack_g2 if g2 else bd.unpack_g1
        return ((lambda cu: cu.fixed_base(k, g2)),
                (lambda o: unpack(o[idx]) == want))
    if group.endswith("skewed"):
        k = skewed_bases_k(torch, n, 70 + bits)
        s = skewed_scalars(torch, n, 80 + bits)
    else:
        k = random_fr(torch, n, 10 + bits)
        s = random_fr(torch, n, 20 + bits)
    pts = bd.fixed_base(k, g2)
    prod = bd.f_mul(bd.FR, bd.f_from_u32(k), bd.f_from_u32(s))
    dot = bd.limbs_to_ints(bd.f_to_u32(bd.FR, prod.sum(0, keepdim=True)))[0]
    want = (host.g2_mul_gen if g2 else host.g1_mul_gen)(dot)
    unpack = bd.unpack_g2 if g2 else bd.unpack_g1
    return ((lambda cu: cu.msm(pts, s, g2)),
            (lambda o: unpack(o)[0] == want))


def _clear_tables(cu) -> None:
    """Drop a tree's cached fixed-base tables (this tree's by its
    function, an older tree's dict)."""
    getattr(cu, "clear_fixed_base_tables", cu._tables.clear)()


def _time_ms(torch, fn, reps: int) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout to time beside this one")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--cases", nargs="*", default=None,
                    help="group:bits or a CRS case, e.g. g1:22 "
                         "g2_skewed:20 fr_ntt:22 g1_fb:22 g1_fb_crs")
    args = ap.parse_args(argv)

    import torch

    from .ops import bn254_cuda, bn254_device as bd

    if not torch.cuda.is_available():
        print("msm_bench: CUDA is not available", file=sys.stderr)
        return 2
    trees = {"this": (bn254_cuda, bd)}
    if args.parent:
        trees = {"parent": load_tree(args.parent, "msm_bench_parent"),
                 **trees}
    cases = CASES if args.cases is None else [
        (c.split(":")[0], int(c.split(":")[1]) if ":" in c else None)
        for c in args.cases]
    rc = 0
    for group, bits in cases:
        run, check = _case(torch, bd, group, bits)
        results = {}
        for tag, (cu, _) in trees.items():
            results[tag] = run(cu)
            torch.cuda.synchronize()
            if not check(results[tag]):
                print(json.dumps({"tree": tag, "case": group, "bits": bits,
                                  "error": "wrong result"}), flush=True)
                rc = 1
        if len(results) == 2 and not torch.equal(*results.values()):
            rc = 1
        order = list(trees) + list(trees)[::-1]
        for rnd in range(args.rounds):
            for turn, tag in enumerate(order):
                cu = trees[tag][0]
                reps = REPS if bits is None or bits >= 20 else SMALL_REPS
                line = {"tree": tag, "case": group, "bits": bits,
                        "round": rnd, "turn": turn}
                if "_fb" in group:
                    line["cold_ms"] = cold_ms(
                        torch, lambda: run(cu), lambda: _clear_tables(cu),
                        reps)[0]
                line["ms"] = _time_ms(torch, lambda: run(cu), reps)
                print(json.dumps(line), flush=True)
        if args.profile:
            for tag, (cu, _) in trees.items():
                line = {"tree": tag, "case": group, "bits": bits,
                        "profile": device_profile(torch, lambda: run(cu))}
                print(json.dumps(line), flush=True)
        del run, check, results
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
