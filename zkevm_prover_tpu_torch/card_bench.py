"""Inputs and device timing shared by `chip_smoke.py` and `msm_bench`:
random Fr scalars on the card, the witness-like skewed scalar sets of the
MSM's checks, a cold call's time (a cache dropped before it) and one
call's device time by kernel under torch.profiler. Nothing here runs
without a card."""

from __future__ import annotations

import time


def random_fr(torch, n: int, seed: int, device="cuda"):
    """(n, 8) int32 scalars below r (the top limb below r's)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-(1 << 31), 1 << 31, (n, 8), dtype=torch.int32,
                      device=device, generator=g)
    x[:, 7] = torch.randint(0, 0x30644E72, (n,), dtype=torch.int32,
                            device=device, generator=g)
    return x


def skewed_scalars(torch, n: int, seed: int, device="cuda"):
    """Scalars shaped like a Groth16 witness: half of them 0 or 1 (bits and
    flags), a quarter below 2^64 (bytes, counters, limbs), a quarter dense
    (field elements), the classes mixed by a seeded permutation."""
    g = torch.Generator(device=device).manual_seed(seed)
    s = random_fr(torch, n, seed + 1, device)
    half, quarter = n // 2, n // 4
    s[:half] = 0
    s[:half, 0] = torch.randint(0, 2, (half,), dtype=torch.int32,
                                device=device, generator=g)
    s[half:half + quarter, 2:] = 0
    return s[torch.randperm(n, device=device, generator=g)].contiguous()


def skewed_bases_k(torch, n: int, seed: int, device="cuda"):
    """The bases' discrete logs k_i for a skewed set: random, with about
    one in 64 zero, so that k_i * G is the point at infinity."""
    g = torch.Generator(device=device).manual_seed(seed)
    k = random_fr(torch, n, seed + 1, device)
    k[torch.randint(0, 64, (n,), device=device, generator=g) == 0] = 0
    return k


def cold_ms(torch, fn, clear, reps: int = 3) -> tuple:
    """(mean ms, the last output) of `reps` calls of fn, each after
    clear() (a cached table dropped, so that the call builds its own), by
    CUDA events around the call alone; one untimed call first, so that
    the host's own caches (a table's bases) are warm."""
    fn()
    total = 0.0
    for _ in range(reps):
        clear()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps, out


def short_name(name: str) -> str:
    """A kernel's name without its template arguments, anonymous
    namespaces and parameter list."""
    out, depth = [], 0
    for ch in name.replace("(anonymous namespace)::", ""):
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and ch != ">":
            out.append(ch)
    return "".join(out).split("(")[0].removeprefix("void ")[:80]


def device_profile(torch, fn) -> dict:
    """One call of fn under torch.profiler: device ms by kernel name,
    the busy time, the span of the device events, the gaps in it (the
    host's syncs and launch waits) and the host wall. A short spin kernel
    (torch.cuda._sleep) goes first and is left out: the trace can miss the
    first kernels after the profiler starts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1 << 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or "spin" in e.name():
            continue
        name = short_name(e.name())
        cnt, ns = by_name.get(name, (0, 0))
        by_name[name] = (cnt + 1, ns + e.duration_ns())
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    spans.sort()
    busy = gaps = 0
    end = spans[0][0] if spans else 0
    for a, b in spans:
        if a > end:
            gaps += a - end
        busy += max(0, b - max(a, end))
        end = max(end, b)
    span = (spans[-1][1] - spans[0][0]) if spans else 0
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy / 1e6,
            "device_span_ms": span / 1e6, "device_gaps_ms": gaps / 1e6,
            "kernels": {k: [c, ns / 1e6] for k, (c, ns) in
                        sorted(by_name.items(), key=lambda kv: -kv[1][1])}}
