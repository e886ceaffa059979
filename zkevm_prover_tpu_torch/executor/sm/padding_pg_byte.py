"""PaddingPGByte SM — hashP byte stream: pad, pack 7-byte elements.

Reference: src/sm/padding_pg/padding_pg_executor.cpp:38-41,148-170 — the
contract-bytecode hash pads the byte stream like keccak's pad10*1 but
over 56-byte blocks (append 0x01, zero-fill, OR 0x80 into the final
byte), packs 7 little-endian bytes per field element (8 elements per
block), and feeds each block to one PoseidonG permutation with the
previous digest chained through the capacity (the PaddingPG SM,
executor/sm/padding_pg.py, proves that part).

This SM is the byte-level front: the pad shape, Main's chunk-read
binding columns (padding_stream.add_binding — hashP rows use exactly the
hashK machinery), the 7-byte element accumulators whose finals are bound
positionally (block id == PoseidonG group id) into PaddingPG's state
rows, and the digest limbs Main's hashPDigest rows read
(scalar = sum fe_i << 64 i, so limb pairs recompose the fe4).

Port of `zkevm_prover_tpu/executor/sm/padding_pg_byte.py`, imports rewritten
(the port's `poseidon_constants` and `refmodel`).
"""

from __future__ import annotations

import numpy as np

from ...ops import goldilocks as gl
from ...ops import poseidon_constants as pc
from ...ops import refmodel as rm
from ...stark import expr as ex
from ...stark.air import AIR
from . import padding_stream as ps

P = gl.P
BLOCK = 56
EB = 7          # bytes per element
NELEM = 8       # elements per block

COLS = ["BYTE", "REM", "PAD", "PADFIRST", "LASTH", "ELEM"] + ps.BIND_COLS


def build_air(n_bits: int) -> AIR:
    n = 1 << n_bits
    n_blocks = n // BLOCK
    air = AIR("padding_pg_byte", n_bits)
    byte, rem, pad, padfirst, lasth, elem = air.committed(*COLS[:6])

    poslast = np.zeros(n, dtype=np.uint64)
    inblock = np.zeros(n, dtype=np.uint64)
    for b in range(n_blocks):
        poslast[b * BLOCK + BLOCK - 1] = 1
        inblock[b * BLOCK:(b + 1) * BLOCK] = 1
    PL = air.constant("POSLAST", poslast)
    IB = air.constant("INBLOCK", inblock)

    for f in (pad, padfirst, lasth):
        air.require_zero(IB * f * (1 - f))
    air.require_zero(padfirst * (1 - pad))

    mend = PL * lasth
    nIB = ex.Const(IB.id, True)
    G = IB * nIB * (1 - mend)
    pad_p = ex.Cm(pad.id, True)
    padfirst_p = ex.Cm(padfirst.id, True)
    rem_p = ex.Cm(rem.id, True)
    lasth_p = ex.Cm(lasth.id, True)

    air.require_zero(G * (pad_p - pad - padfirst_p))
    air.require_zero(IB * nIB * mend * (pad_p - padfirst_p))
    air.require_zero(IB * nIB * (1 - PL) * (lasth_p - lasth))

    # pad shape: 0x01 at the rise, zeros, 0x80 at the end (0x81 combined)
    not_end = 1 - mend
    air.require_zero(padfirst * not_end * (byte - 0x01))
    air.require_zero(IB * pad * (1 - padfirst) * not_end * byte)
    air.require_zero(IB * mend * (1 - pad))
    air.require_zero(mend * (byte - 0x80 - padfirst * 0x01))

    air.require_zero(G * (1 - pad_p) * (rem_p - rem + 1))
    air.require_zero(IB * pad * rem)
    air.require_zero(G * padfirst_p * (rem - 1) * (1 - pad))

    # 7-byte little-endian element accumulator
    pos_in = np.zeros(n, dtype=np.uint64)
    pos_in[:n_blocks * BLOCK] = np.tile(
        np.arange(BLOCK, dtype=np.uint64), n_blocks)
    epow = np.zeros(n, dtype=np.uint64)
    epow[:n_blocks * BLOCK] = np.tile(
        np.array([1 << (8 * (i % EB)) for i in range(BLOCK)],
                 dtype=np.uint64), n_blocks)
    estart = (inblock * (pos_in % EB == 0)).astype(np.uint64)
    # ECONTN[i] = 1 when row i+1 continues row i's element
    econtn = (inblock * np.roll(inblock * (pos_in % EB != 0), -1)
              ).astype(np.uint64)
    econtn[-1] = 0
    EPOW = air.constant("EPOW", epow)
    ESTART = air.constant("ESTART", estart)
    ECONTN = air.constant("ECONTN", econtn)
    for j in range(NELEM):
        efin = (inblock * (pos_in == EB * j + EB - 1)).astype(np.uint64)
        air.constant(f"EFIN{j}", efin)
    elem_p = ex.Cm(elem.id, True)
    byte_p = ex.Cm(byte.id, True)
    air.require_zero(ESTART * (elem - byte))
    air.require_zero(ECONTN * (elem_p - elem
                               - byte_p * ex.Const(EPOW.id, True)))

    ps.add_binding(air, byte=byte, pad=pad, padfirst=padfirst,
                   lasth=lasth, poslast=poslast, inblock=inblock,
                   block_bytes=BLOCK, n_bits=n_bits)
    return air


def layout(actions: list[dict], n_bits: int,
           n_active: int | None = None) -> list:
    """Sorted message plan; every block maps to the PoseidonG group with
    the same index, so no separate block list is needed."""
    n = 1 << n_bits
    n_blocks = n // BLOCK
    if n_active is None:
        n_active = n_blocks
    msgs = []
    auto_addr = 0
    for a in actions:
        msgs.append({"data": bytes(a["data"]),
                     "addr": int(a.get("addr", auto_addr)),
                     "reads": a.get("reads")})
        auto_addr = msgs[-1]["addr"] + 1
    msgs.sort(key=lambda m: m["addr"])
    assert all(a["addr"] < b["addr"] for a, b in zip(msgs, msgs[1:])), \
        "duplicate hash address"
    next_addr = msgs[-1]["addr"] + 1 if msgs else 0

    blocks_used = sum((len(m["data"]) + 1 + BLOCK - 1) // BLOCK
                      for m in msgs)
    assert blocks_used <= n_active, "padding_pg_byte active overflow"
    while blocks_used < n_blocks:
        msgs.append({"data": b"", "addr": next_addr, "reads": None})
        next_addr += 1
        blocks_used += 1

    pos = rm.Poseidon(pc.round_constants(), pc.mds_matrix())
    for m in msgs:
        data = m["data"]
        nb = (len(data) + 1 + BLOCK - 1) // BLOCK
        m["nb"] = nb
        padded = bytearray(data)
        padded.append(0x01)
        padded += bytearray(nb * BLOCK - len(padded))
        padded[-1] |= 0x80
        m["padded"] = bytes(padded)
        # per-block chunk elements + running digest (PoseidonG oracle)
        digest = [0, 0, 0, 0]
        m["chunks"] = []
        for b in range(nb):
            vals = [int.from_bytes(padded[b * BLOCK + EB * j:
                                          b * BLOCK + EB * j + EB],
                                   "little") for j in range(NELEM)]
            m["chunks"].append((vals, list(digest)))
            digest = pos.permute(vals + digest)[:4]
        m["digest4"] = digest
    return msgs


def execute(actions: list[dict], n_bits: int, n_active: int | None = None,
            msgs: list | None = None) -> tuple[np.ndarray, list, list]:
    """Returns (trace, PaddingPG chunk actions in block order, per-message
    fe4 digests in stream order)."""
    n = 1 << n_bits
    n_blocks = n // BLOCK
    if n_active is None:
        n_active = n_blocks
    if msgs is None:
        msgs = layout(actions, n_bits, n_active)
    ci = {nm: i for i, nm in enumerate(COLS)}
    bind_off = 6

    tr = np.zeros((n, len(COLS)), dtype=np.uint64)
    pg_actions = []
    digests = []
    filler = ps.BindFiller(P, n_bits, BLOCK)

    row = 0
    bid = 0
    for m in msgs:
        msg, padded, nb = m["data"], m["padded"], m["nb"]
        scalar = sum(int(v) << (64 * i) for i, v in enumerate(m["digest4"]))
        limbs = [(scalar >> (32 * l)) & 0xFFFFFFFF for l in range(8)]
        filler.start_message(m["addr"], len(msg), m["reads"], limbs)
        for b in range(nb):
            last = b == nb - 1
            active = 1 if bid < n_active else 0
            elem_acc = 0
            for i in range(BLOCK):
                g = b * BLOCK + i
                t = tr[row]
                t[ci["BYTE"]] = padded[g]
                t[ci["REM"]] = max(len(msg) - g, 0)
                t[ci["PAD"]] = 1 if g >= len(msg) else 0
                t[ci["PADFIRST"]] = 1 if g == len(msg) else 0
                t[ci["LASTH"]] = 1 if last else 0
                if i % EB == 0:
                    elem_acc = 0
                elem_acc += padded[g] << (8 * (i % EB))
                t[ci["ELEM"]] = elem_acc
                vals = filler.row(row, padded[g], g >= len(msg),
                                  last and i == BLOCK - 1, active,
                                  1 if b == 0 else 0)
                t[bind_off:bind_off + len(vals)] = vals
                row += 1
            if active:
                chunk_vals, prev_digest = m["chunks"][b]
                pg_actions.append({"values": chunk_vals,
                                   "cont_digest": prev_digest,
                                   "cont": 1 if b else 0})
            bid += 1
        digests.append(list(m["digest4"]))
    filler.finalize(tr, lambda nm: ci[nm])
    return tr, pg_actions, digests


def digest_of(data: bytes) -> list[int]:
    """Oracle: the reference linear_hash_bytes fe4."""
    pos = rm.Poseidon(pc.round_constants(), pc.mds_matrix())
    return pos.linear_hash_bytes(bytes(data))
