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
from . import combined
from .executor import BatchActions
from .rom import RomBuilder
from .sm import (arith, binary, climb_key, keccak_circuit, mem_align,
                 padding_kk, padding_pg_byte, padding_sha256, poseidon_g,
                 sha256_circuit, storage)

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
    """What `state_tree` built: the root, the keys ((n, 4) uint64), each
    key's register limbs ((n, 16) uint64: A0..A5, B0, B1, C0..C7, see
    `smt_keys`) and the values, the number of nodes written and the
    deepest leaf's level."""

    root: tuple
    keys: np.ndarray
    registers: np.ndarray
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


def account_registers(rng: np.random.Generator, count: int) -> np.ndarray:
    """`count` random state keys as the Main SM's key registers, (count, 16)
    uint64 32-bit limbs A0..A5, B0, B1, C0..C7: A a 160-bit address, B the
    key type (0 balance, 1 nonce, 3 storage slot: 15 %, 15 %, 70 %), C the
    slot (a random 256-bit slot for storage keys, else 0)."""
    regs = rng.integers(0, 1 << 32, (count, 16), dtype=np.uint64)
    regs[:, 5] = 0
    kind = rng.choice(np.array([0, 1, 3], np.uint64), size=count,
                      p=[0.15, 0.15, 0.70])
    regs[:, 6], regs[:, 7] = kind, 0
    regs[kind != 3, 8:16] = 0
    return regs


def smt_keys(registers: np.ndarray, device) -> np.ndarray:
    """The SMT keys the Main SM derives on sRD/sWR rows from key registers
    ((m, 16) limbs, as `account_registers` makes them): KEY = H(A0..A5,
    B0, B1 | H(C0..C7 | 0)), lanes 0..3 of each permutation (`main_sm`'s
    `_smt_key_full`), in two batches through `poseidon_gl.permute` on
    `device`."""
    m = len(registers)
    kin0 = np.concatenate([registers[:, 8:16], np.zeros((m, 4), np.uint64)],
                          axis=1)
    kin1 = np.concatenate([registers[:, 0:8], _hash_batch(kin0, device)],
                          axis=1)
    return _hash_batch(kin1, device)


def state_tree(db, n_keys: int, seed: int, device=None) -> StateTree:
    """The canonical sparse Merkle tree of `n_keys` keys with random 256-bit
    values, from np.random.default_rng(seed), written into `db`
    (`Database.multi_write`). The keys are those the Main SM derives from
    random key registers (`account_registers`, `smt_keys`), kept in
    `StateTree.registers`, so that a ROM can read and write them.

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
    # an unused draw, kept so that each seed's tree (and the proofs pinned
    # over it) stays what it was
    rng.integers(0, gl.P, (n_keys, 4), dtype=np.uint64)
    limbs = rng.integers(0, 1 << 32, (n_keys, 8), dtype=np.uint64)
    regs = account_registers(rng, n_keys)
    keys = smt_keys(regs, dev)
    words = _path_words(keys)
    order = np.argsort(words, kind="stable")
    keys, limbs, words, regs = (keys[order], limbs[order], words[order],
                                regs[order])
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
    return StateTree(tuple(int(v) for v in root_h[0]), keys, regs, values,
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


# ---------------------------------------------------------------------------
# the Main SM and the combined batch AIR: a straight-line ROM at the op rates
# of a measured batch
# ---------------------------------------------------------------------------

# counters of the fork-9 e2e vector per 7,115 Main steps
# (artifacts/spine_fork9_2e14/meta.json); poseidonG counts the sRD/sWR rows'
# incCounter (the storage walk's hashes + 2 key hashes) and the hashP digests
SPINE_STEPS = 7115
SPINE_COUNTERS = {"arith": 487, "binary": 670, "keccakF": 6, "paddingPG": 3,
                  "poseidonG": 292}
# rates meta.json does not give, chosen: memory accesses (MLOAD / MSTORE)
# per step, and mem_align ops per step (the spine has none; rd, wr and wr8
# in turn, the first three placed at once, so that each binding runs)
MEMORY_RATE = 0.25
MEM_ALIGN_RATE = 1 / 2000
# the Storage SM's action mix (`storage_batch`): get present, get absent,
# update, insert, delete, as cumulative shares
STORAGE_MIX = (0.30, 0.40, 0.90, 0.98)
# hashP message bytes (contract bytecode pieces), uniform: chosen
HASHP_BYTES = (32, 300)
# the ROM's closing lines: restore B, zero the rest, CTX, GAS; the final
# wait spins at least once and its jump back to line 0 takes the last row
_CLOSE_LINES = 6
CHAIN_ID, FORK_ID = 1000, 9

_ARITH_KINDS = ("mul", "add", "dbl", "mulfp2", "addfp2", "subfp2")
_MEM_ALIGN_KINDS = ("rd", "wr", "wr8")


@dataclasses.dataclass
class RomBatch:
    """A batch for the Main SM: its ROM and input, the SMs bound in the
    combined AIR (`include`), each bound SM's fill ({sm: (used, capacity
    less one group)}, Main's in steps), the counter that closed the batch
    and the ops of each kind."""

    rom: object
    input: dict
    n_bits: int
    include: tuple
    fill: dict
    closed_by: str
    ops: dict


def _capacities(n_bits: int, include: tuple) -> dict:
    """Each bound SM's capacity less one group, in the units the batch
    fills it with; "main" is the body's steps."""
    n = 1 << n_bits
    cap = {"main": n - _CLOSE_LINES - 2}
    if "memory" in include:
        cap["memory"] = n - 1
    if "binary" in include:
        slice_bits = combined._slice_bits(n_bits)
        cap["binary"] = n // binary.rows_per_op(slice_bits) - 1
    if "arith" in include:
        cap["arith"] = n // arith.GROUP - 1
    if "mem_align" in include:
        cap["mem_align"] = n // mem_align.GROUP - 1
    if "storage" in include:
        cap["storage"] = n - 1
    if "poseidon_g" in include:
        cap["poseidon_g"] = n // poseidon_g.GROUP - 1
    if "climb_key" in include:
        cap["climb_key"] = n // (64 // climb_key.params_for(n_bits)[0]) - 1
    if "padding_pg" in include:
        cap["padding_pg"] = n // padding_pg_byte.BLOCK - 1
    return cap


def _scalar(limbs) -> int:
    """A register's value from its 32-bit limbs."""
    return sum(int(v) << (32 * i) for i, v in enumerate(limbs))


def rom_batch(n_bits: int, smt, tree: StateTree, seed: int) -> RomBatch:
    """A straight-line ROM for the Main SM (one line per step, every
    operand its own, from np.random.default_rng(seed)) with its input, at
    the per-step rates of the fork-9 e2e vector's counters
    (`SPINE_COUNTERS`): arith (its six equations in turn), binary (its
    eight opcodes in turn), keccakF (hashK messages in `KECCAK_MIX`
    lengths) and paddingPG (hashP messages) per step as there, sRD/sWR at
    the rate that makes the PoseidonG counter per step match the spine's,
    in `STORAGE_MIX` over the keys of `tree` (a `state_tree` whose nodes
    are in `smt.db`); memory and mem_align at the
    chosen `MEMORY_RATE` and `MEM_ALIGN_RATE`. At each step the op whose
    counter is furthest behind its rate is placed; a step with none behind
    is a no-op line.

    The batch closes when the next op would overflow a bound SM (those of
    `combined.default_include(n_bits)`, and Main's steps) past its
    capacity less one group, as the reference closes a batch on its
    scarcest counter. The input starts from the tree's root
    (`oldStateRootScalar`; the first line copies B into SR) and the ROM
    closes by restoring the input registers, spinning to the last row and
    zeroing SR on the jump back to line 0, so that SR holds the new state
    root in the last row (the `newStateRoot` public). Sets run through
    `smt.set` while the batch is drawn, so `smt.db` holds the trees the
    Main SM will walk."""
    include = combined.default_include(n_bits)
    rng = np.random.default_rng(seed)
    db = smt.db
    cap = _capacities(n_bits, include)
    used = {sm: 0 for sm in cap}
    used["main"] = 1               # the first line, B => SR
    rates = {k: v / SPINE_STEPS for k, v in SPINE_COUNTERS.items()}
    rates.update(memory=MEMORY_RATE, memAlign=MEM_ALIGN_RATE)
    counters = {k: 0 for k in rates}
    ops = {"arith": 0, "binary": 0, "memory": 0, "mem_align": 0,
           "storage_get": 0, "storage_set": 0, "keccak": 0, "hashp": 0,
           "nop": 0}
    root = tuple(int(v) for v in tree.root)
    osr = sum(v << (64 * i) for i, v in enumerate(root))
    n_tree = len(tree.keys)
    present = list(range(n_tree))
    extra: list = []           # (registers, key) of inserted keys
    written: list = []         # memory addresses written so far
    rb = RomBuilder()
    rb.line("B => SR", inB=1, setSR=1)

    def key_of(regs) -> tuple:
        return tuple(int(v) for v in smt_keys(regs[None], "cpu")[0])

    def entry(i):
        if i < n_tree:
            return tree.registers[i], tuple(int(v) for v in tree.keys[i])
        return extra[i - n_tree]

    def key_lines(regs) -> list:
        return [("A", _scalar(regs[0:6])), ("B", _scalar(regs[6:8])),
                ("C", _scalar(regs[8:16]))]

    def set_lines(pairs) -> list:
        return [(f"{v:#x} => {r}", {"CONSTL": v, f"set{r}": 1})
                for r, v in pairs]

    def storage_op():
        u = rng.random()
        kind = ("get", "get", "update", "insert", "delete")[
            int(np.searchsorted(STORAGE_MIX, u, side="right"))]
        pick = None
        if kind == "insert" or (kind == "get" and u >= STORAGE_MIX[0]):
            regs = account_registers(rng, 1)[0]
            key = key_of(regs)
        else:
            pick = int(rng.integers(len(present)))
            regs, key = entry(present[pick])
        if kind == "get":
            act = {"op": "get", "root": root, "key": key,
                   "value": smt.get(root, key).value}
            lines = set_lines(key_lines(regs)) + [
                ("$ => E :SLOAD", {"inFREE": 1, "sRD": 1, "setE": 1})]
        else:
            value = 0 if kind == "delete" else \
                int.from_bytes(rng.bytes(32), "little") or 1
            act = {"op": "set", "root": root, "key": key, "value": value,
                   "new_root": smt.set(root, key, value).new_root}
            lines = set_lines(key_lines(regs) + [("D", value)]) + [
                ("$ => SR :SSTORE", {"inFREE": 1, "sWR": 1, "setSR": 1})]
        hashes = storage.hash_count(act, db) + 2
        rows = storage.rows(act, db)
        delta = {"storage": rows, "poseidon_g": hashes,
                 "climb_key": rows - 1}

        def commit():
            nonlocal root
            ops["storage_" + act["op"]] += 1
            counters["poseidonG"] += hashes
            root = act.get("new_root", root)
            if kind == "delete":
                present[pick] = present[-1]
                present.pop()
            elif kind == "insert":
                extra.append((regs, key))
                present.append(n_tree + len(extra) - 1)
        return lines, delta, commit

    def hash_op(kind: str):
        if kind == "K":
            _, lo, hi = KECCAK_MIX[int(np.searchsorted(
                np.cumsum([m[0] for m in KECCAK_MIX]), rng.random(),
                side="right"))]
        else:
            lo, hi = HASHP_BYTES
        data = rng.bytes(int(rng.integers(lo, hi + 1)))
        addr = ops["keccak"] + ops["hashp"]     # one address per message
        lines = [("0 => HASHPOS", {"CONST": 0, "setHASHPOS": 1})]
        for p in range(0, len(data), 32):
            chunk = data[p:p + 32]
            lines += [(f"{len(chunk)} => D", {"CONST": len(chunk),
                                              "setD": 1}),
                      ("chunk => A", {"CONSTL": int.from_bytes(chunk, "big"),
                                      "setA": 1}),
                      (f"A :HASH{kind}({addr})",
                       {"inA": 1, f"hash{kind}": 1, "offset": addr})]
        lines += [(f"HASHPOS :HASH{kind}LEN({addr})",
                   {"inHASHPOS": 1, f"hash{kind}Len": 1, "offset": addr}),
                  (f"$ => B :HASH{kind}DIGEST({addr})",
                   {"inFREE": 1, f"hash{kind}Digest": 1, "offset": addr,
                    "setB": 1})]
        if kind == "K":
            blocks = padding_kk.message_blocks(data)
            delta = {}
        else:
            blocks = (len(data) + 1 + 55) // 56
            delta = {"padding_pg": blocks}

        def commit():
            if kind == "K":
                ops["keccak"] += 1
                counters["keccakF"] += blocks
            else:
                ops["hashp"] += 1
                counters["paddingPG"] += blocks
                counters["poseidonG"] += blocks
        return lines, delta, commit

    def arith_op():
        kind = _ARITH_KINDS[ops["arith"] % len(_ARITH_KINDS)]
        # the free input (the result's low word or y3) lands in E for the
        # multiplication, in A for the others (whose x3 E holds)
        flag = {f"arithEq{_ARITH_KINDS.index(kind)}": 1, "inFREE": 1,
                "setE" if kind == "mul" else "setA": 1}
        if kind == "mul":
            x1, y1, x2 = _ints(rng, 3, 256)
            regs = [("A", x1), ("B", y1), ("C", x2),
                    ("D", (x1 * y1 + x2) >> 256)]
        elif kind in ("add", "dbl"):
            p = arith.FPEC
            x1, y1, x2, y2 = (v % p for v in _ints(rng, 4, 256))
            y1 = y1 or 1
            if kind == "add":
                x2 = x2 if x2 != x1 else (x1 + 1) % p
                x3, _ = arith.ec_result("add", x1, y1, x2, y2)
                regs = [("A", x1), ("B", y1), ("C", x2), ("D", y2),
                        ("E", x3)]
            else:
                x3, _ = arith.ec_result("dbl", x1, y1)
                regs = [("A", x1), ("B", y1), ("E", x3)]
        else:
            x1, y1, x2, y2 = (v % arith.PBN for v in _ints(rng, 4, 256))
            x3, _ = arith.fp2_result(kind, x1, y1, x2, y2)
            regs = [("A", x1), ("B", y1), ("C", x2), ("D", y2), ("E", x3)]
        lines = set_lines(regs) + [(f"$ :ARITH {kind}", flag)]

        def commit():
            ops["arith"] += 1
            counters["arith"] += 1
        return lines, {"arith": 1}, commit

    def binary_op():
        names = list(binary.OPS)
        name = names[ops["binary"] % len(names)]
        a, b = _ints(rng, 2, 256)
        lines = set_lines([("A", a), ("B", b)]) + [
            (f"$ => C :{name}", {"inFREE": 1, "bin": 1,
                                 "binOpcode": binary.OPS[name],
                                 "setC": 1})]

        def commit():
            ops["binary"] += 1
            counters["binary"] += 1
        return lines, {"binary": 1}, commit

    def mem_align_op():
        kind = _MEM_ALIGN_KINDS[ops["mem_align"] % len(_MEM_ALIGN_KINDS)]
        m0, m1 = _ints(rng, 2, 256)
        # a byte write stays inside the A word (offset < 32), as MSTORE8
        off = int(rng.integers(0, 32 if kind == "wr8" else 33))
        regs = [("A", m0), ("B", m1), ("C", off)]
        if kind == "rd":
            lines = set_lines(regs) + [
                ("$ => D :MEM_ALIGN_RD", {"inFREE": 1, "memAlignRD": 1,
                                          "setD": 1})]
        else:
            span = 32 if kind == "wr" else 1
            val = _ints(rng, 1, 8 * span)[0]
            lo, hi = mem_align.result({"op": kind, "w0": m1, "w1": m0,
                                       "offset": 64 - off - span,
                                       "value": val})
            regs += [("D", hi)] + ([("E", lo)] if kind == "wr" else [])
            flag = "memAlignWR" if kind == "wr" else "memAlignWR8"
            lines = set_lines(regs) + [
                (f"value :{flag.upper()}", {"CONSTL": val, flag: 1})]

        def commit():
            ops["mem_align"] += 1
            counters["memAlign"] += 1
        return lines, {"mem_align": 1}, commit

    def memory_op():
        write = not written or rng.random() >= 0.5
        if write:
            addr = int(rng.integers(0, 1 << 16))
            lines = [(f"A :MSTORE({addr})", {"inA": 1, "mOp": 1, "mWR": 1,
                                             "offset": addr})]
        else:
            addr = written[int(rng.integers(len(written)))]
            lines = [(f"$ => E :MLOAD({addr})", {"inFREE": 1, "mOp": 1,
                                                  "offset": addr,
                                                  "setE": 1})]

        def commit():
            ops["memory"] += 1
            counters["memory"] += 1
            if write:
                written.append(addr)
        return lines, {"memory": 1}, commit

    def nop():
        return [("nop", {})], {}, lambda: ops.update(nop=ops["nop"] + 1)

    kinds = (("poseidonG", storage_op), ("keccakF", lambda: hash_op("K")),
             ("paddingPG", lambda: hash_op("P")),
             ("memAlign", mem_align_op), ("arith", arith_op),
             ("binary", binary_op), ("memory", memory_op))
    while True:
        # the op whose counter fell furthest behind its rate (the earliest
        # step its next unit was due); mem_align's first three at once
        due = sorted(
            (0.0 if ctr == "memAlign"
             and counters[ctr] < len(_MEM_ALIGN_KINDS)
             else counters[ctr] / rates[ctr], i, make)
            for i, (ctr, make) in enumerate(kinds)
            if counters[ctr] < rates[ctr] * (used["main"] + 1)
            or (ctr == "memAlign" and counters[ctr] < len(_MEM_ALIGN_KINDS)))
        lines, delta, commit = (due[0][2] if due else nop)()
        delta = {"main": len(lines),
                 **{sm: k for sm, k in delta.items() if sm in cap}}
        over = [sm for sm, k in delta.items() if used[sm] + k > cap[sm]]
        if over:
            closed_by = over[0]
            break
        for line_str, kw in lines:
            rb.line(line_str, **kw)
        for sm, k in delta.items():
            used[sm] += k
        commit()

    # close: restore the input registers (B = the old root, CTX, GAS), zero
    # the rest, spin to the last row and zero SR on the jump to line 0
    rb.line("old root => B", CONSTL=osr, setB=1)
    rb.line("0 => A,C,D,E,SP,PC,RR,HASHPOS,RCX", CONST=0,
            **{f"set{r}": 1 for r in ("A", "C", "D", "E", "SP", "PC", "RR",
                                       "HASHPOS", "RCX")})
    rb.line(f"{FORK_ID} => CTX", CONST=FORK_ID, setCTX=1)
    rb.line(f"{CHAIN_ID} => GAS", CONST=CHAIN_ID, setGAS=1)
    rb.label("finalWait")
    rb.free({"op": "functionCall", "funcName": "beforeLast", "params": []},
            JMPN=1, useJmpAddr=1, jmpAddr="finalWait")
    rb.jmp(0, setSR=1)
    rom = rb.build()
    inp = {"oldStateRootScalar": osr, "oldAccInputHash": 0,
           "oldBatchNum": 0, "chainID": CHAIN_ID, "forkID": FORK_ID}
    fill = {sm: (used[sm], cap[sm]) for sm in cap}
    return RomBatch(rom, inp, n_bits, include, fill, closed_by, ops)


def small_rom_batch(device=None) -> tuple:
    """The ROM batch of the CPU tests and of the card's small proof:
    `rom_batch` (seed 9) at 2^9 over a 4-key `state_tree` (seed 9, main
    keys), the JAX package's default sizes. Returns the database holding
    the trees, the tree and the batch."""
    from ..hashdb import Database, Smt

    db = Database()
    tree = state_tree(db, 4, 9, device)
    return db, tree, rom_batch(9, Smt(db), tree, 9)
