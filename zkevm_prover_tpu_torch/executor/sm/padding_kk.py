"""PaddingKK SM — keccak byte-stream padding (pad10*1 over 136-byte blocks).

Reference: src/sm/padding_kk/padding_kk_executor.cpp — one row per padded
byte; tracks remaining message length, enforces the pad10*1 shape
(0x01 first pad byte, zeros, 0x80 on the block's last byte, 0x81 when they
coincide), and hands each 136-byte block to the bit-decomposition /
packing stages (PaddingKKBit → Bits2Field → KeccakF).

Committed columns:
  BYTE       padded byte value
  REM        remaining unpadded message bytes (counts down on data rows)
  PAD        1 on padding bytes
  PADFIRST   1 on the first padding byte of a message
  LASTH      1 on every row of a message's last block
plus the Main-facing binding block shared with PaddingSha256
(padding_stream.add_binding): ADDR / POSREG / ILEN / chunk-read
accumulators / held digest limbs / ACTIVE / FIRSTBLK.

Constant columns: POSLAST (1 on byte 135 of each complete block),
INBLOCK (0 on the domain tail where 2^n mod 136 rows cannot hold a block).

The blocks of the first `n_active` padding blocks are mirrored into the
HashBit SM (executor/sm/hash_bit.py) by combined-AIR lookups keyed on the
constant block ids; message digests flow back the same way.

Port of `zkevm_prover_tpu/executor/sm/padding_kk.py`, imports rewritten:
the absorb chain and the digests use the port's host Keccak
(`ops/keccak.py` `_keccak_f_host`, `keccak256`).
"""

from __future__ import annotations

import numpy as np

from ...ops import goldilocks as gl
from ...ops import keccak as keccak_mod
from ...stark import expr as ex
from ...stark.air import AIR
from . import padding_stream as ps

P = gl.P
BLOCK = 136  # keccak-256 rate in bytes

COLS = ["BYTE", "REM", "PAD", "PADFIRST", "LASTH"] + ps.BIND_COLS


def message_blocks(data: bytes) -> int:
    """Padded blocks of a message: its data, then at least the pad byte."""
    return len(data) // BLOCK + 1


def build_air(n_bits: int) -> AIR:
    n = 1 << n_bits
    n_blocks = n // BLOCK
    air = AIR("padding_kk", n_bits)
    byte, rem, pad, padfirst, lasth = air.committed(*COLS[:5])

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

    # message end = last byte of a LASTH block; G gates in-message rows
    mend = PL * lasth
    nIB = ex.Const(IB.id, True)
    G = IB * nIB * (1 - mend)       # transition stays inside one message
    pad_p = ex.Cm(pad.id, True)
    padfirst_p = ex.Cm(padfirst.id, True)
    rem_p = ex.Cm(rem.id, True)
    lasth_p = ex.Cm(lasth.id, True)

    # padding is sticky within a message, and PADFIRST marks exactly the rise
    air.require_zero(G * (pad_p - pad - padfirst_p))
    # at a message boundary the next row starts fresh: a pad there can only
    # be an empty message's first pad byte
    air.require_zero(IB * nIB * mend * (pad_p - padfirst_p))
    # LASTH constant within a block (it flags the whole last block)
    air.require_zero(IB * nIB * (1 - PL) * (lasth_p - lasth))

    # pad byte shapes
    not_end = 1 - mend
    air.require_zero(padfirst * not_end * (byte - 0x01))
    air.require_zero(IB * pad * (1 - padfirst) * not_end * byte)
    air.require_zero(IB * mend * (1 - pad))                  # end is padding
    air.require_zero(mend * (byte - 0x80 - padfirst * 0x01))  # 0x80 / 0x81

    # remaining-length accounting: data rows count down to 1, the pad rise
    # consumes the last unit, pad rows hold zero
    air.require_zero(G * (1 - pad_p) * (rem_p - rem + 1))
    air.require_zero(IB * pad * rem)
    air.require_zero(G * padfirst_p * (rem - 1) * (1 - pad))

    ps.add_binding(air, byte=byte, pad=pad, padfirst=padfirst,
                   lasth=lasth, poslast=poslast, inblock=inblock,
                   block_bytes=BLOCK, n_bits=n_bits)
    return air


def layout(actions: list[dict], n_bits: int,
           n_active: int | None = None) -> tuple[list, list]:
    """Lay messages into blocks.

    Returns (msgs, blocks): msgs = [{data, addr, reads, nb}] padded with
    filler empty messages so the first `n_active` blocks are fully
    tiled; blocks = [{"bytes", "first"}] for those n_active blocks, in
    pipeline (block-id) order — the HashBit mirror's input.
    """
    n = 1 << n_bits
    n_blocks = n // BLOCK
    if n_active is None:
        n_active = n_blocks
    assert n_active <= n_blocks

    # stream order is strictly-increasing ADDR order (the AIR's addr
    # monotonicity; one hash per addr, like the reference's ctx.hashK map)
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
    blocks_used = sum(len(m["data"]) // BLOCK + 1 for m in msgs)
    assert blocks_used <= n_active, "padding_kk active-region overflow"
    while blocks_used < n_blocks:
        # fillers continue the strictly-increasing addr sequence; Main's
        # lookups can't reach them anyway (selectors carry ACTIVE)
        msgs.append({"data": b"", "addr": next_addr, "reads": None})
        next_addr += 1
        blocks_used += 1

    blocks = []
    for m in msgs:
        data = m["data"]
        nb = len(data) // BLOCK + 1
        m["nb"] = nb
        padded = bytearray(data) + bytearray(nb * BLOCK - len(data))
        padded[len(data)] |= 0x01
        padded[-1] |= 0x80
        m["padded"] = bytes(padded)
        for b in range(nb):
            if len(blocks) < n_active:
                blocks.append({"bytes": padded[b * BLOCK:(b + 1) * BLOCK],
                               "first": b == 0})
    return msgs, blocks


def execute(actions: list[dict], n_bits: int, n_active: int | None = None,
            dlimbs: list | None = None,
            msgs_blocks: tuple | None = None) -> tuple[np.ndarray, list, list]:
    """actions: [{data, addr?, reads?}] (Main's actions.keccak).

    Returns (trace, keccak-f absorb actions for the active blocks,
    per-message digests). `dlimbs` (per active block, from
    hash_bit.execute) supplies the digest limbs; without it the host
    keccak sponge is the oracle (standalone mode).
    """
    n = 1 << n_bits
    n_blocks = n // BLOCK
    if n_active is None:
        n_active = n_blocks
    msgs, _blocks = msgs_blocks if msgs_blocks is not None \
        else layout(actions, n_bits, n_active)
    ci = {nm: i for i, nm in enumerate(COLS)}
    bind_off = 5

    tr = np.zeros((n, len(COLS)), dtype=np.uint64)
    keccak_actions = []
    digests = []
    filler = ps.BindFiller(P, n_bits, BLOCK)

    row = 0
    bid = 0
    for m in msgs:
        msg, padded, nb = m["data"], m["padded"], m["nb"]
        state = [0] * 25
        # digest limbs for this message: from the bit pipeline when
        # supplied, else the host sponge at the end of the loop
        first_bid = bid
        host_digest = None
        if dlimbs is None or first_bid + nb - 1 >= n_active:
            host_digest = int.from_bytes(
                keccak_mod.keccak256(bytes(msg)), "big")
            limbs = [(host_digest >> (32 * l)) & 0xFFFFFFFF
                     for l in range(8)]
        else:
            limbs = dlimbs[first_bid + nb - 1]
        filler.start_message(m["addr"], len(msg), m["reads"], limbs)
        for b in range(nb):
            last = b == nb - 1
            active = 1 if bid < n_active else 0
            for i in range(BLOCK):
                g = b * BLOCK + i
                t = tr[row]
                t[ci["BYTE"]] = padded[g]
                t[ci["REM"]] = max(len(msg) - g, 0)
                t[ci["PAD"]] = 1 if g >= len(msg) else 0
                t[ci["PADFIRST"]] = 1 if g == len(msg) else 0
                t[ci["LASTH"]] = 1 if last else 0
                vals = filler.row(row, padded[g], g >= len(msg),
                                  last and i == BLOCK - 1, active,
                                  1 if b == 0 else 0)
                t[bind_off:bind_off + len(vals)] = vals
                row += 1
            if active:
                for j in range(BLOCK // 8):
                    lane = int.from_bytes(padded[b * BLOCK + 8 * j:
                                                 b * BLOCK + 8 * j + 8],
                                          "little")
                    state[j] ^= lane
                keccak_actions.append(
                    {"state": np.array(state, dtype=np.uint64)})
                state = [int(v) for v in keccak_mod._keccak_f_host(state)]
            bid += 1
        digests.append(sum(l << (32 * i) for i, l in enumerate(limbs)))
    filler.finalize(tr, lambda nm: ci[nm])
    return tr, keccak_actions, digests


def digest_of(data: bytes) -> int:
    """Oracle: keccak-256 digest as the Main SM's scalar convention."""
    return int.from_bytes(keccak_mod.keccak256(bytes(data)), "big")
