"""PaddingSha256 SM — SHA-256 byte-stream padding over 64-byte blocks.

Reference: src/sm/padding_sha256/ (+ padding_sha256bit): one row per
padded byte; the pad is 0x80, zero filler, and an 8-byte big-endian BIT
length suffix. The suffix is bound to the message's actual length with a
held ILEN column (set at message start from the initial REM) and a LENACC
accumulator over the suffix region, so a prover cannot claim a different
length than the byte count the REM countdown proves.

Carries the same Main-facing binding block as PaddingKK
(padding_stream.add_binding): ADDR / position / chunk-read accumulators /
held digest limbs / ACTIVE / FIRSTBLK, mirrored into the sha256 HashBit
pipeline by the combined AIR. Note ILEN here is the binding module's
(latched at the pad rise); the suffix accumulator checks LENACC == 8·ILEN.

Port of `zkevm_prover_tpu/executor/sm/padding_sha256.py`: the emitted
compression chain runs through the port's `sha256_compress` on the
executor's device (`execute(..., device=)`), one launch of the CUDA kernel
per block on the card, where the JAX package calls its jitted compression
and `jax.device_get`.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import resolve_device
from ...ops import goldilocks as gl
from ...ops import sha256 as sha_mod
from ...stark import expr as ex
from ...stark.air import AIR
from . import padding_stream as ps
from . import sha256_circuit

P = gl.P
BLOCK = 64
SUFFIX = 8  # length-suffix bytes

COLS = ["BYTE", "REM", "PAD", "PADFIRST", "LASTH", "LENACC"] + ps.BIND_COLS


def message_blocks(data: bytes) -> int:
    """Padded blocks of a message: its data, the 0x80 byte and the 8-byte
    length suffix."""
    return (len(data) + SUFFIX) // BLOCK + 1


def build_air(n_bits: int) -> AIR:
    n = 1 << n_bits
    n_blocks = n // BLOCK
    air = AIR("padding_sha256", n_bits)
    byte, rem, pad, padfirst, lasth, lenacc = air.committed(*COLS[:6])

    poslast = np.zeros(n, dtype=np.uint64)
    inblock = np.zeros(n, dtype=np.uint64)
    insuffix = np.zeros(n, dtype=np.uint64)
    for b in range(n_blocks):
        poslast[b * BLOCK + BLOCK - 1] = 1
        inblock[b * BLOCK:(b + 1) * BLOCK] = 1
        insuffix[b * BLOCK + BLOCK - SUFFIX:(b + 1) * BLOCK] = 1
    PL = air.constant("POSLAST", poslast)
    IB = air.constant("INBLOCK", inblock)
    SUF = air.constant("INSUFFIX", insuffix)

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
    lenacc_p = ex.Cm(lenacc.id, True)

    air.require_zero(G * (pad_p - pad - padfirst_p))
    air.require_zero(IB * nIB * mend * (pad_p - padfirst_p))
    air.require_zero(IB * nIB * (1 - PL) * (lasth_p - lasth))

    # pad shape: 0x80 at the rise, zero filler through the non-suffix pad
    air.require_zero(padfirst * (byte - 0x80))
    air.require_zero(IB * pad * (1 - padfirst) * (1 - SUF * lasth) * byte)

    # REM countdown (same scheme as PaddingKK)
    air.require_zero(G * (1 - pad_p) * (rem_p - rem + 1))
    air.require_zero(IB * pad * rem)
    air.require_zero(G * padfirst_p * (rem - 1) * (1 - pad))

    bind = ps.add_binding(air, byte=byte, pad=pad, padfirst=padfirst,
                          lasth=lasth, poslast=poslast, inblock=inblock,
                          block_bytes=BLOCK, n_bits=n_bits)
    ilen = bind["ILEN"]

    # BYTE is a byte (the suffix accumulator's injectivity needs it)
    air.lookup([byte], [air.constant(
        "BYTETAB", np.arange(n, dtype=np.uint64) % 256)], sel_f=IB)

    # LENACC: big-endian byte accumulator over the last block's suffix;
    # at the message end it must equal the bit length 8·ILEN
    air.require_zero((1 - SUF) * lenacc)
    suf_first = np.zeros(n, dtype=np.uint64)
    for b in range(n_blocks):
        suf_first[b * BLOCK + BLOCK - SUFFIX] = 1
    SUFF = air.constant("SUFFIRST", suf_first)
    nSUF = ex.Const(SUF.id, True)
    nSUFF = ex.Const(SUFF.id, True)
    byte_p = ex.Cm(byte.id, True)
    air.require_zero(
        lasth_p * nSUF * (1 - nSUFF) * (lenacc_p - lenacc * 256 - byte_p))
    air.require_zero(lasth * SUFF * (lenacc - byte))
    air.require_zero(IB * mend * (lenacc - ilen * 8))
    # non-final blocks carry data in the suffix region: no LENACC meaning
    air.require_zero(SUF * (1 - lasth) * lenacc)
    return air


def layout(actions: list[dict], n_bits: int,
           n_active: int | None = None) -> tuple[list, list]:
    """Lay messages into blocks; returns (msgs, blocks) like
    padding_kk.layout (blocks in strictly-increasing-ADDR stream order,
    each {"bytes", "first"} for the HashBit mirror)."""
    n = 1 << n_bits
    n_blocks = n // BLOCK
    if n_active is None:
        n_active = n_blocks
    assert n_active <= n_blocks

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

    blocks_used = sum((len(m["data"]) + SUFFIX) // BLOCK + 1 for m in msgs)
    assert blocks_used <= n_active, "padding_sha256 active-region overflow"
    while blocks_used < n_blocks:
        # fillers continue the strictly-increasing addr sequence; Main's
        # lookups can't reach them anyway (selectors carry ACTIVE)
        msgs.append({"data": b"", "addr": next_addr, "reads": None})
        next_addr += 1
        blocks_used += 1

    blocks = []
    for m in msgs:
        data = m["data"]
        nb = (len(data) + SUFFIX) // BLOCK + 1
        m["nb"] = nb
        padded = bytearray(data) + bytearray(nb * BLOCK - len(data))
        padded[len(data)] = 0x80
        padded[-SUFFIX:] = (8 * len(data)).to_bytes(SUFFIX, "big")
        m["padded"] = bytes(padded)
        for b in range(nb):
            if len(blocks) < n_active:
                blocks.append({"bytes": padded[b * BLOCK:(b + 1) * BLOCK],
                               "first": b == 0})
    return msgs, blocks


def execute(actions: list[dict], n_bits: int, n_active: int | None = None,
            dlimbs: list | None = None, msgs_blocks: tuple | None = None,
            device=None) -> tuple[np.ndarray, list, list]:
    """actions: [{data, addr?, reads?}] (Main's actions.sha256). Returns
    (trace, Sha256F actions for the active blocks, per-message digests in
    stream order). The compression chain of the active blocks runs on
    `device` (CUDA unless told otherwise)."""
    device = resolve_device(device)
    n = 1 << n_bits
    n_blocks = n // BLOCK
    if n_active is None:
        n_active = n_blocks
    msgs, _blocks = msgs_blocks if msgs_blocks is not None \
        else layout(actions, n_bits, n_active)
    ci = {nm: i for i, nm in enumerate(COLS)}
    bind_off = 6

    tr = np.zeros((n, len(COLS)), dtype=np.uint64)
    sha_actions = []
    digests = []
    filler = ps.BindFiller(P, n_bits, BLOCK)

    row = 0
    bid = 0
    for m in msgs:
        msg, padded, nb = m["data"], m["padded"], m["nb"]
        state = [int(v) for v in sha256_circuit.initial_state()]
        first_bid = bid
        if dlimbs is None or first_bid + nb - 1 >= n_active:
            host = int.from_bytes(sha_mod.sha256(bytes(msg)), "big")
            limbs = [(host >> (32 * l)) & 0xFFFFFFFF for l in range(8)]
        else:
            limbs = dlimbs[first_bid + nb - 1]
        filler.start_message(m["addr"], len(msg), m["reads"], limbs)
        lenacc = 0
        for b in range(nb):
            last = b == nb - 1
            active = 1 if bid < n_active else 0
            block_words = [int.from_bytes(
                padded[b * BLOCK + 4 * wi:b * BLOCK + 4 * wi + 4], "big")
                for wi in range(16)]
            for i in range(BLOCK):
                g = b * BLOCK + i
                t = tr[row]
                t[ci["BYTE"]] = padded[g]
                t[ci["REM"]] = max(len(msg) - g, 0)
                t[ci["PAD"]] = 1 if g >= len(msg) else 0
                t[ci["PADFIRST"]] = 1 if g == len(msg) else 0
                t[ci["LASTH"]] = 1 if last else 0
                if last and i >= BLOCK - SUFFIX:
                    lenacc = lenacc * 256 + padded[g]
                    t[ci["LENACC"]] = lenacc
                vals = filler.row(row, padded[g], g >= len(msg),
                                  last and i == BLOCK - 1, active,
                                  1 if b == 0 else 0)
                t[bind_off:bind_off + len(vals)] = vals
                # the binding ILEN is latched at the pad rise = len(msg) ✓
                row += 1
            if active:
                sha_actions.append({"state": list(state),
                                    "block": block_words})
                state = _compress_host(state, block_words, device)
            bid += 1
        digests.append(sum(l << (32 * i) for i, l in enumerate(limbs)))
    filler.finalize(tr, lambda nm: ci[nm])
    return tr, sha_actions, digests


def _compress_host(state, block_words, device) -> list[int]:
    """One block's compression through `sha256_compress` on `device` (the
    CUDA kernel on the card), back on the host as 8 ints."""
    out = sha_mod.sha256_compress(
        torch.tensor([state], dtype=torch.int64, device=device),
        torch.tensor([block_words], dtype=torch.int64, device=device))
    return [int(v) for v in out[0].tolist()]


def digest_of(data: bytes) -> int:
    return int.from_bytes(sha_mod.sha256(bytes(data)), "big")
