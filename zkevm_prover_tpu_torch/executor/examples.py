"""Seeded action batches for the ported co-processor SMs.

`mixed_batch` is a small batch with every op kind of every ported SM (its
proofs at the JAX package's test sizes are pinned in
tests/test_torch_batch.py); `full_batch` fills each SM of an `Executor` to
its capacity less one group. That is a synthetic capacity fill (every op
kind in turn, uniform random operands), not a traffic mix measured on real
batches: it sizes the traces as a full batch does, but its op mix is a
guess. Both return keyword arguments of `BatchActions`.
"""

from __future__ import annotations

import functools
import random

import numpy as np

from .executor import BatchActions
from .sm import arith, binary, climb_key

P = 0xFFFFFFFF00000001
# secp256k1 generator G and 2G
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G2X = 0xC6047F9441ED7D6D3045406E95C07CD85C778E4B8CEF3CA7ABAC09B95C709EE5
G2Y = 0x1AE168FEA63DC339A3C58419466CEAEEF7F632653266D0E1236431A950CFE52A


def mixed_batch() -> dict:
    """A few actions of every kind, from random.Random(20)."""
    rng = random.Random(20)
    r256 = functools.partial(rng.getrandbits, 256)
    a, b, c, d = (rng.randrange(arith.PBN) for _ in range(4))
    return dict(
        binary=[{"op": op, "a": r256(), "b": r256()}
                for op in ("ADD", "SUB", "SLT", "AND")],
        memory=[{"addr": rng.randrange(64), "step": s, "wr": rng.randrange(2),
                 "value": r256()} for s in range(1, 41)],
        arith=[{"x1": r256(), "y1": r256(), "x2": r256()},
               {"op": "dbl", "x1": GX, "y1": GY},
               {"op": "add", "x1": GX, "y1": GY, "x2": G2X, "y2": G2Y},
               {"op": "mulfp2", "x1": a, "y1": b, "x2": c, "y2": d},
               {"op": "addfp2", "x1": a, "y1": b, "x2": c, "y2": d},
               {"op": "subfp2", "x1": a, "y1": b, "x2": c, "y2": d}],
        mem_align=[{"op": "rd", "w0": r256(), "w1": r256(), "offset": 9},
                   {"op": "wr", "w0": r256(), "w1": r256(), "offset": 5,
                    "value": r256()},
                   {"op": "wr8", "w0": r256(), "w1": r256(), "offset": 40,
                    "value": r256()}],
        poseidon_g=[{"state": [rng.randrange(P) for _ in range(12)]}
                    for _ in range(5)],
        padding_pg=[{"values": [rng.randrange(P) for _ in range(ln)]}
                    for ln in (20, 7, 9)],
        climb_key=[{"key": [rng.randrange(P >> 2) for _ in range(4)],
                    "level": rng.randrange(256), "bit": rng.randrange(2)}
                   for _ in range(6)],
    )


def _ints(rng: np.random.Generator, count: int, bits: int) -> list[int]:
    """`count` uniform `bits`-bit Python ints."""
    words = rng.integers(0, 1 << 32, size=(count, -(-bits // 32)),
                         dtype=np.uint64).astype(np.uint32)
    return [int.from_bytes(w.tobytes(), "little") >> (-bits % 32)
            for w in words]


def full_batch(executor, seed: int = 2) -> dict:
    """Every ported SM of `executor` filled to its capacity (by
    `Executor.counters`) less one group, from np.random.default_rng(seed):
    random operands for every op kind, in turn."""
    rng = np.random.default_rng(seed)
    cap = executor.counters(BatchActions())
    out = {}

    n = cap["binary_capacity"] - 1
    ops = list(binary.OPS)
    a, b = _ints(rng, n, 256), _ints(rng, n, 256)
    out["binary"] = [{"op": ops[i % len(ops)], "a": a[i], "b": b[i]}
                     for i in range(n)]

    n = cap["memory_capacity"] - 1
    addr = rng.integers(0, 1 << 24, n)
    wr = rng.integers(0, 2, n)
    vals = _ints(rng, n, 256)
    out["memory"] = [{"addr": int(addr[i]), "step": i + 1, "wr": int(wr[i]),
                      "value": vals[i]} for i in range(n)]

    n = cap["arith_capacity"] - 1
    kinds = ("mul", "add", "dbl", "mulfp2", "addfp2", "subfp2")
    x1, y1, x2, y2 = (_ints(rng, n, 255) for _ in range(4))
    acts = []
    for i in range(n):
        op = kinds[i % len(kinds)]
        if op == "mul":
            acts.append({"x1": x1[i], "y1": y1[i], "x2": x2[i]})
        elif op in ("add", "dbl"):
            p = arith.FPEC
            u1, v1, u2 = x1[i] % p, y1[i] % p or 1, x2[i] % p
            if u2 == u1:
                u2 = (u1 + 1) % p
            acts.append({"op": op, "x1": u1, "y1": v1, "x2": u2,
                         "y2": y2[i] % p} if op == "add"
                        else {"op": op, "x1": u1, "y1": v1})
        else:
            acts.append({"op": op, "x1": x1[i], "y1": y1[i], "x2": x2[i],
                         "y2": y2[i]})
    out["arith"] = acts

    n = cap["mem_align_capacity"] - 1
    w0, w1, val = (_ints(rng, n, 256) for _ in range(3))
    kind = rng.integers(0, 3, n)
    off = rng.integers(0, 64, n)
    acts = []
    for i in range(n):
        op = ("rd", "wr", "wr8")[kind[i]]
        act = {"op": op, "w0": w0[i], "w1": w1[i],
               "offset": int(off[i]) if op == "wr8" else int(off[i]) % 33}
        if op != "rd":
            act["value"] = val[i]
        acts.append(act)
    out["mem_align"] = acts

    n = cap["poseidon_g_capacity"] - 1
    states = rng.integers(0, P, (n, 12), dtype=np.uint64)
    out["poseidon_g"] = [{"state": [int(v) for v in s]} for s in states]

    left = cap["padding_pg_capacity"] - 1   # groups: ceil(len / 8) each
    msgs = []
    while left > 0:
        chunks = min(left, int(rng.integers(1, 6)))
        ln = 8 * chunks - int(rng.integers(0, 4 if chunks > 1 else 3))
        msgs.append({"values": [int(v) for v in
                                rng.integers(0, P, ln, dtype=np.uint64)]})
        left -= chunks
    out["padding_pg"] = msgs

    n = cap["climb_key_capacity"] - 1
    keys = rng.integers(0, climb_key.LIMIT_BEFORE_CLIMB, (n, 4),
                        dtype=np.uint64)
    level = rng.integers(0, 256, n)
    bit = rng.integers(0, 2, n)
    out["climb_key"] = [{"key": [int(v) for v in keys[i]],
                         "level": int(level[i]), "bit": int(bit[i])}
                        for i in range(n)]
    return out

