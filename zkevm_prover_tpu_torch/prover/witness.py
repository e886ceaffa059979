"""Erigon witness parser — rebuild the SMT database for stateless proving.

Port of `zkevm_prover_tpu/prover/witness.py`: a host copy, the same parser
and encoder (on the port's `hashdb`, `poseidon_constants` and `refmodel`).

Reference: src/prover/witness.cpp (witness2db / calculateWitnessHash): the
witness is a depth-first encoding of the touched part of the state SMT —
BRANCH nodes with a presence mask, HASH placeholders for untouched
subtrees, SMT_LEAF records carrying (nodeType, address[, storageKey],
value), and CODE blobs for touched contracts. Parsing recomputes every
node hash bottom-up (our hashdb Poseidon/SMT node rules), stores the
preimages into a Database, and returns the state root.

CBOR usage is the reference's subset (cbor.cpp): unsigned ints and byte
strings, with the >24 length forms.
"""

from __future__ import annotations

from ..hashdb import key_utils as ku
from ..hashdb.database import Database
from ..hashdb.smt import Smt, scalar_to_fea8
from ..ops import keccak as keccak_mod
from ..ops import poseidon_constants as pc
from ..ops import refmodel as rm

# SMT_LEAF node types (main_sm storage key derivation's B register)
SC_STORAGE = 0x03


class WitnessError(Exception):
    pass


def _cbor_uint(data: bytes, p: int) -> tuple[int, int]:
    """Decode a CBOR unsigned int or byte string as a scalar."""
    if p >= len(data):
        raise WitnessError("cbor: out of data")
    ib = data[p]
    p += 1
    major, info = ib >> 5, ib & 0x1F
    if info < 24:
        arg = info
    elif info == 24:
        arg = data[p]
        p += 1
    elif info == 25:
        arg = int.from_bytes(data[p:p + 2], "big")
        p += 2
    elif info == 26:
        arg = int.from_bytes(data[p:p + 4], "big")
        p += 4
    elif info == 27:
        arg = int.from_bytes(data[p:p + 8], "big")
        p += 8
    else:
        raise WitnessError(f"cbor: unsupported info {info}")
    if major == 0:       # unsigned int
        return arg, p
    if major == 2:       # byte string -> big-endian scalar
        if p + arg > len(data):
            raise WitnessError("cbor: byte string out of data")
        v = int.from_bytes(data[p:p + arg], "big")
        return v, p + arg
    raise WitnessError(f"cbor: unsupported major type {major}")


def _cbor_bytes(data: bytes, p: int) -> tuple[bytes, int]:
    ib = data[p]
    if ib >> 5 != 2:
        raise WitnessError(f"cbor: expected byte string, got major {ib >> 5}")
    p += 1
    info = ib & 0x1F
    if info < 24:
        n = info
    elif info == 24:
        n = data[p]
        p += 1
    elif info == 25:
        n = int.from_bytes(data[p:p + 2], "big")
        p += 2
    elif info == 26:
        n = int.from_bytes(data[p:p + 4], "big")
        p += 4
    else:
        raise WitnessError("cbor: byte string too long")
    if p + n > len(data):
        raise WitnessError("cbor: byte string out of data")
    return data[p:p + n], p + n


class _Ctx:
    def __init__(self, witness: bytes, smt: Smt):
        self.w = witness
        self.p = 0
        self.level = 0
        self.smt = smt
        self.programs: dict[int, bytes] = {}
        self.poseidon = rm.Poseidon(pc.round_constants(), pc.mds_matrix())


def _leaf_key(ctx: _Ctx, node_type: int, address: int,
              storage_key: int) -> tuple:
    """The zkEVM storage-key derivation (main_executor.cpp:1080-1140):
    key = H(addr||type limbs | H(storageKey | 0))."""
    c_fea = scalar_to_fea8(storage_key)
    kin0 = list(c_fea) + [0, 0, 0, 0]
    h0 = ctx.poseidon.permute(kin0)[:4]
    a_fea = scalar_to_fea8(address)
    kin1 = a_fea[:6] + [node_type, 0] + list(h0)
    return tuple(ctx.poseidon.permute(kin1)[:4])


def _parse_node(ctx: _Ctx):
    """Parse one subtree; returns its 4-element hash (ZERO4 for absent)."""
    if ctx.p >= len(ctx.w):
        raise WitnessError("run out of witness data")
    opcode = ctx.w[ctx.p]
    ctx.p += 1

    if opcode == 0x02:  # BRANCH (binary SMT: 2-bit mask)
        mask, ctx.p = _cbor_uint(ctx.w, ctx.p)
        children = []
        for bit in (0, 1):
            if mask & (1 << bit):
                ctx.level += 1
                children.append(_parse_node(ctx))
                ctx.level -= 1
            else:
                children.append((0, 0, 0, 0))
        return ctx.smt.branch_node(children[0], children[1])

    if opcode == 0x03:  # HASH: untouched subtree
        h = ctx.w[ctx.p:ctx.p + 32]
        ctx.p += 32
        v = int.from_bytes(h, "big")
        return tuple((v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4))

    if opcode == 0x04:  # CODE blob, followed by its SMT_LEAF
        code, ctx.p = _cbor_bytes(ctx.w, ctx.p)
        h = int.from_bytes(keccak_mod.keccak256(bytes(code)), "big")
        ctx.programs[h] = bytes(code)
        return _parse_node(ctx)

    if opcode == 0x07:  # SMT_LEAF
        node_type = ctx.w[ctx.p]
        ctx.p += 1
        address, ctx.p = _cbor_uint(ctx.w, ctx.p)
        storage_key = 0
        if node_type == SC_STORAGE:
            storage_key, ctx.p = _cbor_uint(ctx.w, ctx.p)
        value, ctx.p = _cbor_uint(ctx.w, ctx.p)
        key = _leaf_key(ctx, node_type, address, storage_key)
        rkey = ku.remove_key_bits(key, ctx.level)
        return ctx.smt.leaf_node(rkey, ctx.smt.hash_value(value))

    if opcode == 0xBB:  # NEW_TRIE marker
        return _parse_node(ctx)

    raise WitnessError(f"unsupported witness opcode 0x{opcode:02x}")


def witness_to_db(witness: bytes) -> tuple[Database, tuple, dict]:
    """Parse a witness blob; returns (db, state_root4, programs)."""
    if not witness:
        raise WitnessError("empty witness")
    if witness[0] != 1:
        raise WitnessError(f"unsupported witness header {witness[0]}")
    db = Database()
    smt = Smt(db)
    ctx = _Ctx(bytes(witness), smt)
    ctx.p = 1
    root = _parse_node(ctx)
    return db, tuple(int(v) for v in root), ctx.programs


# -- encoder (for tests and round-tripping our own state) -------------------


def _cbor_enc_uint(v: int) -> bytes:
    b = v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")
    return _cbor_enc_bytes(b) if v >= (1 << 64) else _enc_major(0, v)


def _enc_major(major: int, arg: int) -> bytes:
    if arg < 24:
        return bytes([major << 5 | arg])
    for info, size in ((24, 1), (25, 2), (26, 4), (27, 8)):
        if arg < (1 << (8 * size)):
            return bytes([major << 5 | info]) + arg.to_bytes(size, "big")
    raise WitnessError("cbor: arg too large")


def _cbor_enc_bytes(b: bytes) -> bytes:
    return _enc_major(2, len(b)) + bytes(b)


def db_to_witness(db: Database, root: tuple, programs: dict | None = None,
                  leaves: dict | None = None, _level: int = 0) -> bytes:
    """Encode the touched subtree under `root` as a witness blob (inverse
    of witness_to_db for SMT-shaped tries).

    `leaves` maps full leaf key (fe4 tuple) -> (node_type, address,
    storage_key, value): leaves listed there are emitted as semantic
    SMT_LEAF records (opcode 0x07) so the receiver can re-derive and READ
    them — the form a sequencer's witness generator produces, where the
    (address, key) semantics are known.  Unlisted leaves degrade to HASH
    placeholders (opaque, proving membership only)."""
    out = b"\x01" if _level == 0 else b""
    out += _encode_node(db, tuple(int(v) for v in root), _level,
                        leaves or {})
    return out


def _encode_node(db: Database, node_hash: tuple, level: int,
                 leaves: dict) -> bytes:
    if node_hash == (0, 0, 0, 0):
        raise WitnessError("cannot encode an absent subtree directly")
    node = db.read(node_hash)
    if node is None:
        # untouched: emit a HASH placeholder
        v = sum(int(node_hash[i]) << (64 * i) for i in range(4))
        return b"\x03" + v.to_bytes(32, "big")
    if node[8] == 1:  # leaf
        rkey = tuple(int(x) for x in node[:4])
        for key, (node_type, address, storage_key, value) in leaves.items():
            if ku.remove_key_bits(tuple(int(k) for k in key),
                                  level) == rkey:
                out = b"\x07" + bytes([node_type])
                out += _cbor_enc_uint(int(address))
                if node_type == SC_STORAGE:
                    out += _cbor_enc_uint(int(storage_key))
                out += _cbor_enc_uint(int(value))
                return out
        # semantics unknown: opaque placeholder
        v = sum(int(node_hash[i]) << (64 * i) for i in range(4))
        return b"\x03" + v.to_bytes(32, "big")
    mask = 0
    parts = b""
    for bit in (0, 1):
        child = tuple(int(x) for x in node[4 * bit:4 * bit + 4])
        if child != (0, 0, 0, 0):
            mask |= 1 << bit
            parts += _encode_node(db, child, level + 1, leaves)
    return b"\x02" + _enc_major(0, mask) + parts
