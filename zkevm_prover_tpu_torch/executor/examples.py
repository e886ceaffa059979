"""Seeded action batches for the ported co-processor SMs.

`mixed_batch` is a small batch with every op kind of every ported SM (its
proofs at the JAX package's test sizes are pinned in
tests/test_torch_batch.py); `full_batch` fills each SM of an `Executor` to
its capacity less one group. That is a synthetic capacity fill (every op
kind in turn, uniform random operands), not a traffic mix measured on real
batches: it sizes the traces as a full batch does, but its op mix is a
guess. Both return keyword arguments of `BatchActions`.

`state_tree` builds the pre-state of a storage batch: a canonical sparse
Merkle tree of random keys, hashed level by level in batches through the
Poseidon kernel; `storage_batch` draws a chained stream of storage actions
over it, closed on the PoseidonG counter.

`hash_batch` is the hash machines' batch at full width (Keccak and SHA-256
messages closed on the KeccakF and Sha256F capacities), `small_hash_batch`
its reduced twin on the JAX package's test messages; both run through an
`Executor` made by `HashBatch.executor`.
"""

from __future__ import annotations

import dataclasses
import functools
import random

import numpy as np

from .. import resolve_device
from ..hashdb import key_utils as ku
from ..hashdb.smt import ZERO4, fea8_to_scalar
from ..ops import goldilocks as gl
from ..ops import poseidon_gl
from .executor import BatchActions
from .sm import (arith, binary, climb_key, keccak_circuit, padding_kk,
                 padding_sha256, sha256_circuit, storage)

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



# ---------------------------------------------------------------------------
# storage: the pre-state tree and a batch of actions over it
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StateTree:
    """What `state_tree` built: the root, the keys ((n, 4) uint64) and
    their values, the number of nodes written and the deepest leaf's
    level."""

    root: tuple
    keys: np.ndarray
    values: list
    nodes: int
    depth: int


def _path_words(keys: np.ndarray) -> np.ndarray:
    """The first 64 path bits of each key as one uint64, path bit 0 the
    most significant (path bit i is bit i >> 2 of lane i & 3, as
    `key_utils.split_key`): sorting these words orders keys as the tree
    does."""
    w = np.zeros(len(keys), np.uint64)
    for i in range(64):
        bit = (keys[:, i & 3] >> np.uint64(i >> 2)) & np.uint64(1)
        w |= bit << np.uint64(63 - i)
    return w


def _clz64(x: np.ndarray) -> np.ndarray:
    """Leading zeros of nonzero uint64 values."""
    n = np.zeros(x.shape, np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        z = (x >> np.uint64(64 - s)) == 0
        n += z * s
        x = np.where(z, x << np.uint64(s), x)
    return n


def _hash_batch(states: np.ndarray, device) -> np.ndarray:
    """Digests (lanes 0..3) of a batch of (m, 12) uint64 preimages through
    `poseidon_gl.permute`: the kernel of `poseidon_cuda.MODE` on a CUDA
    device, the plain twin on the CPU."""
    out = poseidon_gl.permute(gl.from_u64(states, device))
    return gl.to_u64(out[:, :4])


def state_tree(db, n_keys: int, seed: int, device=None) -> StateTree:
    """The canonical sparse Merkle tree of `n_keys` random keys (4 field
    elements each) with random 256-bit values, from
    np.random.default_rng(seed), written into `db` (`Database.multi_write`).

    The tree is `hashdb.Smt`'s: its root depends only on the key/value
    set, so it equals the root of sequential `Smt.set` inserts. A leaf sits
    one level below the longest path prefix its key shares with any other
    key, holding `key_utils.remove_key_bits` of its key; a branch with one
    empty side hashes against (0, 0, 0, 0). The hashes run in batches,
    value preimages first, then the leaves, then each branch level bottom
    up, one batch per level, through `poseidon_gl.permute` on `device`.
    Leaves deeper than 64 levels (two keys sharing 64 path bits) are
    refused."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, gl.P, (n_keys, 4), dtype=np.uint64)
    limbs = rng.integers(0, 1 << 32, (n_keys, 8), dtype=np.uint64)
    words = _path_words(keys)
    order = np.argsort(words, kind="stable")
    keys, limbs, words = keys[order], limbs[order], words[order]
    diff = words[1:] ^ words[:-1]
    if not diff.all():
        raise ValueError("two keys share 64 path bits")
    lcp = _clz64(diff)
    depth = np.zeros(n_keys, np.int64)
    if n_keys > 1:
        depth[:-1] = lcp
        depth[1:] = np.maximum(depth[1:], lcp)
        depth += 1

    zeros4 = np.zeros((n_keys, 4), np.uint64)
    value_pre = np.concatenate([limbs, zeros4], axis=1)
    value_h = _hash_batch(value_pre, dev)
    lanes = np.arange(4)
    shift = (depth[:, None] >> 2) + (lanes[None, :] < (depth[:, None] & 3))
    rkey = keys >> shift.astype(np.uint64)
    cap_leaf = np.zeros((n_keys, 4), np.uint64)
    cap_leaf[:, 0] = 1
    leaf_pre = np.concatenate([rkey, value_h, cap_leaf], axis=1)
    leaf_h = _hash_batch(leaf_pre, dev)
    hashes, preimages = [value_h, leaf_h], [value_pre, leaf_pre]

    # bottom up: the nodes of level L are the branches made from level L+1
    # and the leaves at depth L, each named by its L-bit path prefix
    d_max = int(depth.max())
    prefix = np.zeros(0, np.uint64)
    node_h = np.zeros((0, 4), np.uint64)
    for level in range(d_max, 0, -1):
        at = depth == level
        prefix = np.concatenate([prefix,
                                 words[at] >> np.uint64(64 - level)])
        node_h = np.concatenate([node_h, leaf_h[at]])
        parent, inv = np.unique(prefix >> np.uint64(1), return_inverse=True)
        right = (prefix & np.uint64(1)).astype(bool)
        pre = np.zeros((len(parent), 12), np.uint64)
        pre[inv[~right], 0:4] = node_h[~right]
        pre[inv[right], 4:8] = node_h[right]
        prefix, node_h = parent, _hash_batch(pre, dev)
        hashes.append(node_h)
        preimages.append(pre)
    root_h = node_h if d_max else leaf_h
    assert len(root_h) == 1

    hashes = np.concatenate(hashes)
    preimages = np.concatenate(preimages)
    hexed = hashes.astype(">u8").tobytes().hex()
    db.multi_write(dict(zip(
        (hexed[i:i + 64] for i in range(0, len(hexed), 64)),
        preimages.tolist())))
    values = [fea8_to_scalar(row) for row in limbs.tolist()]
    return StateTree(tuple(int(v) for v in root_h[0]), keys, values,
                     len(hashes), d_max)


def _present_key(db, root: tuple, rng: np.random.Generator) -> tuple:
    """A key of the tree under `root`, found by a random walk from the root
    to a leaf (a branch's empty side is never taken)."""
    if root == ZERO4:
        raise ValueError("the tree is empty: no key to draw")
    bits, r = [], root
    while True:
        node = db.read(r)
        if node[8] == 1:   # leaf capacity marker
            return ku.join_key(bits, tuple(node[0:4]))
        bit = int(rng.integers(0, 2))
        if tuple(node[4 * bit:4 * bit + 4]) == ZERO4:
            bit = 1 - bit
        bits.append(bit)
        r = tuple(node[4 * bit:4 * bit + 4])


def storage_batch(smt, root, seed: int,
                  poseidon_capacity: int) -> tuple[list, int]:
    """A chained stream of storage actions over the tree of `root` (the
    `new_root` of action k is the `root` of action k + 1), from
    np.random.default_rng(seed), in the mix of the SLOAD/SSTORE, balance
    and nonce traffic of a batch of ERC-20 and ETH transfers:

      30 % get of a key in the tree, 10 % get of an absent key,
      50 % set updating a key in the tree, 8 % set inserting a fresh key,
      2 % set to 0 (a delete).

    Sets run through `smt.set`, which writes their nodes into `smt.db`. The
    batch closes on the PoseidonG counter, as the reference closes a batch
    on its resource counters: actions are added while the sum of their
    `storage.hash_count` stays within `poseidon_capacity`. Returns the
    actions and the storage rows they take."""
    rng = np.random.default_rng(seed)
    db = smt.db
    root = tuple(int(v) for v in root)
    actions, rows, used = [], 0, 0

    def fresh_key():
        return tuple(int(v) for v in rng.integers(0, gl.P, 4,
                                                  dtype=np.uint64))

    def fresh_value():
        return int.from_bytes(rng.bytes(32), "little") or 1

    while True:
        u = rng.random()
        if u < 0.40:
            key = _present_key(db, root, rng) if u < 0.30 else fresh_key()
            act = {"op": "get", "root": root, "key": key,
                   "value": smt.get(root, key).value}
        else:
            if u < 0.90:
                key, value = _present_key(db, root, rng), fresh_value()
            elif u < 0.98:
                key, value = fresh_key(), fresh_value()
            else:
                key, value = _present_key(db, root, rng), 0
            act = {"op": "set", "root": root, "key": key, "value": value,
                   "new_root": smt.set(root, key, value).new_root}
        cost = storage.hash_count(act, db)
        if used + cost > poseidon_capacity:
            return actions, rows
        used += cost
        rows += storage.rows(act, db)
        actions.append(act)
        root = act.get("new_root", root)


def small_storage_batch(device=None) -> tuple:
    """The 2^9 storage batch of the CPU tests: `storage_batch` (seed 7)
    over a 4-key `state_tree` (seed 7), closed on the PoseidonG capacity
    of an `Executor` at its default sizes, the JAX package's. Returns the
    database holding the trees and the actions."""
    from ..hashdb import Database, Smt
    from .executor import Executor

    db = Database()
    tree = state_tree(db, 4, 7, device)
    cap = Executor(device=device).counters(
        BatchActions())["poseidon_g_capacity"] - 1
    actions, _ = storage_batch(Smt(db), tree.root, 7, cap)
    return db, actions


# ---------------------------------------------------------------------------
# the hash machines: Keccak and SHA-256 messages through the padding SMs and
# the gate SMs they feed
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HashBatch:
    """Keccak and SHA-256 messages ([{"data": bytes}], the `keccak` and
    `sha256` fields of `BatchActions`), the log2 rows of each SM and the
    gate SMs' circuits ({"rounds", "pack", "limb_bits"})."""

    keccak: list
    sha256: list
    n_bits: dict
    gates: dict

    def actions(self) -> BatchActions:
        return BatchActions(keccak=list(self.keccak), sha256=list(self.sha256))

    def executor(self, device=None):
        from .executor import Executor

        return Executor(n_bits=self.n_bits, gates=self.gates, device=device)


def _pad_bits(blocks: int, block_bytes: int) -> int:
    """The smallest log2 rows of a padding SM that hold `blocks` blocks."""
    bits = 1
    while (1 << bits) // block_bytes < blocks:
        bits += 1
    return bits


# the Keccak message mix of `hash_batch`: (share, least, most bytes)
KECCAK_MIX = ((0.55, 64, 64),        # mapping-slot keys
              (0.15, 32, 32),
              (0.20, 100, 300),      # transaction RLP
              (0.08, 300, 1000),
              (0.02, 1024, 8192))    # code hashing


def _close(rng, draw, blocks_of, capacity: int) -> list:
    """Messages from `draw(rng)` while their blocks fit `capacity`: the
    batch closes on the first one that does not, as the reference closes a
    batch on its scarcest counter."""
    msgs, used = [], 0
    while True:
        data = draw(rng)
        if used + blocks_of(data) > capacity:
            return msgs
        used += blocks_of(data)
        msgs.append({"data": data})


def hash_batch(keccak_seed: int = 30, sha256_seed: int = 31) -> HashBatch:
    """The hash machines at full width, their reference parameters cut to
    one card. KeccakF: the 24-round circuit, pack 40 on 10-bit limbs (4
    limbs, 12 committed columns as production's 44 on 11 bits), at 2^21,
    the smallest domain that holds its 2·2^20-row gate table: 13 slots,
    520 permutations. Sha256F: the 64-round circuit at production's pack
    40 and 10-bit limbs, at 2^22, the smallest domain that holds its
    3·2^20-row table: 33 slots, 1,320 compressions. The messages
    (synthetic, random bytes) close on those capacities: Keccak from
    default_rng(keccak_seed) in the `KECCAK_MIX` of lengths, SHA-256 (the
    0x02 precompile) from default_rng(sha256_seed), 32-512 bytes uniform.
    The padding SMs get the smallest power of two that holds their
    blocks."""
    gates = {"keccak_f": {"rounds": 24, "pack": 40, "limb_bits": 10},
             "sha256_f": {"rounds": 64, "pack": 40, "limb_bits": 10}}
    n_bits = {"keccak_f": 21, "sha256_f": 22}
    cap = {"keccak_f": (1 << 21) // keccak_circuit.build(24).n_rows * 40,
           "sha256_f": (1 << 22) // sha256_circuit.build(64).n_rows * 40}
    shares = np.cumsum([m[0] for m in KECCAK_MIX])

    def keccak_message(rng):
        _, lo, hi = KECCAK_MIX[int(np.searchsorted(shares, rng.random(),
                                                   side="right"))]
        return rng.bytes(int(rng.integers(lo, hi + 1)))

    def sha256_message(rng):
        return rng.bytes(int(rng.integers(32, 513)))

    keccak = _close(np.random.default_rng(keccak_seed), keccak_message,
                    padding_kk.message_blocks, cap["keccak_f"])
    sha = _close(np.random.default_rng(sha256_seed), sha256_message,
                 padding_sha256.message_blocks, cap["sha256_f"])
    n_bits["padding_kk"] = _pad_bits(
        sum(padding_kk.message_blocks(m["data"]) for m in keccak),
        padding_kk.BLOCK)
    n_bits["padding_sha256"] = _pad_bits(
        sum(padding_sha256.message_blocks(m["data"]) for m in sha),
        padding_sha256.BLOCK)
    return HashBatch(keccak, sha, n_bits, gates)


def small_hash_batch() -> HashBatch:
    """The reduced hash batch of the CPU tests and of the card's small
    proofs: the JAX package's test messages (tests/test_padding_kk_sm.py,
    tests/test_sha256_sm.py) through PaddingKK at 2^10 and PaddingSha256 at
    2^9 (the smallest that hold their 5 and 6 blocks), KeccakF with 1 round
    at 2^13 and Sha256F with 1 round at 2^12 (one slot each), both pack 4
    on 2-bit limbs as the JAX tests run them: each gate SM takes the first
    4 message blocks, its capacity."""
    keccak = [{"data": b"hello keccak padding"},
              {"data": bytes(range(200))},      # spans two blocks
              {"data": b""},                    # empty message
              {"data": bytes([7] * 135)}]       # 0x81 coincident pad byte
    sha = [{"data": b"hello sha"},
           {"data": bytes(range(100))},         # pad spills into a second block
           {"data": b""},
           {"data": bytes([5] * 56)}]           # suffix forces an extra block
    return HashBatch(
        keccak, sha,
        n_bits={"padding_kk": 10, "padding_sha256": 9, "keccak_f": 13,
                "sha256_f": 12},
        gates={"keccak_f": {"rounds": 1, "pack": 4, "limb_bits": 2},
               "sha256_f": {"rounds": 1, "pack": 4, "limb_bits": 2}})
