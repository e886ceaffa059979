"""HashBit SM — per-bit absorb/chain/digest rows for the hash pipelines.

Reference: src/sm/padding_kk_bit/padding_kk_bit_executor.cpp and
src/sm/padding_sha256bit/ — the stage between the byte-stream padding SMs
and the packed gate machines. The reference lays one row per state bit of
each permutation call and proves, row-locally:

  * byte composition   (8 consecutive bit rows recompose each padded byte)
  * the absorb XOR     sIn = sPrev XOR rBit          (keccak sponge)
    / state injection  sIn = sPrev, block bits pass  (sha Merkle-Damgard)
  * block chaining     sPrev of block g = sOut of block g-1 (same message)
  * digest assembly    output bits -> bytes -> the 8 x 32-bit limbs Main's
                       hashKDigest/hashSDigest rows read

This SM is the same role, generic over a `BitLayout` (keccak and sha256
are two instances): blocks occupy `n_pos` consecutive rows (one per
permutation-input bit), all structure (block ids, byte runs, digest limb
weights) is constant columns, and the packing into the gate SM's bit-sliced
elements is delegated to the instance-major Bits2Field SM
(executor/sm/bits2field.py) via a per-bit permutation on
(block, pos, sIn, sOut) tuples.

Committed: RBIT (stream bit), SPREV (chained state bit), SOUT (output
bit), FIRSTB (block starts a message), BACC (stream-byte accumulator),
OBACC (output-byte accumulator), D0..D7 (digest limbs).

Port of `zkevm_prover_tpu/executor/sm/hash_bit.py`, imports rewritten.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...stark import expr as ex
from ...stark.air import AIR


@dataclasses.dataclass
class BitLayout:
    """Per-position structure of one permutation block.

    Arrays are length n_pos; `byte_idx[p] == -1` marks non-stream
    positions. Byte runs must be 8 consecutive positions (LSB-first in
    run order is NOT assumed — `byte_w` carries each bit's weight).
    """

    name: str
    n_pos: int                 # rows per block (= permutation input bits)
    out_bits: int              # positions carrying output bits
    byte_idx: np.ndarray       # stream-byte index per position (-1 = none)
    byte_w: np.ndarray         # bit weight within its byte
    sprev_mask: np.ndarray     # 1 where SPREV is live (chained state)
    iv_bit: np.ndarray         # FIRSTB seed for SPREV
    obyte_idx: np.ndarray      # output-byte index per position (-1 = none)
    obyte_w: np.ndarray
    dg_limb: np.ndarray        # digest limb fed at obyte-final rows (-1 =.)
    dg_w: np.ndarray           # 256-power weight of that byte in its limb
    n_stream_bytes: int

    def xor_absorb(self) -> bool:
        return bool((self.sprev_mask * (self.byte_idx >= 0)).any())


def keccak_layout() -> BitLayout:
    """keccak-256 sponge: rate 136 bytes, capacity zero-bits, digest =
    first 32 output bytes big-endian (Main's scalar convention)."""
    n_pos = 1600
    byte_idx = np.full(n_pos, -1, dtype=np.int64)
    byte_w = np.zeros(n_pos, dtype=np.uint64)
    obyte_idx = np.full(n_pos, -1, dtype=np.int64)
    obyte_w = np.zeros(n_pos, dtype=np.uint64)
    dg_limb = np.full(n_pos, -1, dtype=np.int64)
    dg_w = np.zeros(n_pos, dtype=np.uint64)
    for p in range(1088):                      # rate bits, LSB-first bytes
        byte_idx[p] = p // 8
        byte_w[p] = 1 << (p % 8)
    for p in range(256):                       # digest: output bytes 0..31
        obyte_idx[p] = p // 8
        obyte_w[p] = 1 << (p % 8)
        if p % 8 == 7:
            k = p // 8                         # byte k weight 256^(31-k)
            dg_limb[p] = (31 - k) // 4
            dg_w[p] = 1 << (8 * ((31 - k) % 4))
    return BitLayout(
        name="keccak", n_pos=n_pos, out_bits=n_pos,
        byte_idx=byte_idx, byte_w=byte_w,
        sprev_mask=np.ones(n_pos, dtype=np.uint64),
        iv_bit=np.zeros(n_pos, dtype=np.uint64),
        obyte_idx=obyte_idx, obyte_w=obyte_w,
        dg_limb=dg_limb, dg_w=dg_w, n_stream_bytes=136)


def sha256_layout() -> BitLayout:
    """SHA-256 compression: inputs = 8 state words || 16 block words
    (32-bit, big-endian bytes), digest = the 8 output words."""
    n_pos = 24 * 32
    byte_idx = np.full(n_pos, -1, dtype=np.int64)
    byte_w = np.zeros(n_pos, dtype=np.uint64)
    sprev_mask = np.zeros(n_pos, dtype=np.uint64)
    obyte_idx = np.full(n_pos, -1, dtype=np.int64)
    obyte_w = np.zeros(n_pos, dtype=np.uint64)
    dg_limb = np.full(n_pos, -1, dtype=np.int64)
    dg_w = np.zeros(n_pos, dtype=np.uint64)
    iv = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
          0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
    iv_bit = np.zeros(n_pos, dtype=np.uint64)
    sprev_mask[:256] = 1
    for w in range(8):
        for z in range(32):
            iv_bit[32 * w + z] = (iv[w] >> z) & 1
    for w in range(16):                        # block words: bytes BE
        for z in range(32):
            p = 256 + 32 * w + z
            byte_idx[p] = 4 * w + (3 - z // 8)
            byte_w[p] = 1 << (z % 8)
    for w in range(8):                         # digest words: scalar =
        for z in range(32):                    # sum st_w << 32*(7-w)
            p = 32 * w + z
            obyte_idx[p] = 4 * w + (3 - z // 8)
            obyte_w[p] = 1 << (z % 8)
            if z % 8 == 7:
                dg_limb[p] = 7 - w
                dg_w[p] = 1 << (8 * (z // 8))
    return BitLayout(
        name="sha256", n_pos=n_pos, out_bits=256,
        byte_idx=byte_idx, byte_w=byte_w, sprev_mask=sprev_mask,
        iv_bit=iv_bit, obyte_idx=obyte_idx, obyte_w=obyte_w,
        dg_limb=dg_limb, dg_w=dg_w, n_stream_bytes=64)


COLS = ["RBIT", "SPREV", "SOUT", "FIRSTB", "BACC", "OBACC"] + \
    [f"D{l}" for l in range(8)]


def n_blocks(n_bits: int, lay: BitLayout, covered: int | None = None) -> int:
    cap = (1 << n_bits) // lay.n_pos
    if covered is not None:
        assert covered <= cap, "hash_bit domain overflow"
        return covered
    return cap


def _tile(lay_arr, n, n_pos, n_cov, fill=0):
    out = np.full(n, fill, dtype=np.uint64)
    out[:n_cov * n_pos] = np.tile(np.asarray(lay_arr, dtype=np.uint64),
                                  n_cov)
    return out


def build_air(n_bits: int, lay: BitLayout, n_covered: int,
              name: str | None = None) -> AIR:
    """n_covered: blocks bound into the pipeline (= gate-SM capacity)."""
    n = 1 << n_bits
    n_pos = lay.n_pos
    assert n_covered * n_pos <= n
    air = AIR(name or f"{lay.name}_bit", n_bits)
    rbit, sprev, sout, firstb, bacc, obacc = air.committed(*COLS[:6])
    d = air.committed(*COLS[6:])

    cov_rows = n_covered * n_pos
    pos_tile = np.arange(n_pos, dtype=np.uint64)
    bidc = np.zeros(n, dtype=np.uint64)
    for g in range(n_covered):
        bidc[g * n_pos:(g + 1) * n_pos] = g
    covered = np.zeros(n, dtype=np.uint64)
    covered[:cov_rows] = 1
    COV = air.constant("COVERED", covered)
    BID = air.constant("BIDC", bidc)
    POS = air.constant("POSC", _tile(pos_tile, n, n_pos, n_covered))
    blast = (pos_tile == n_pos - 1).astype(np.uint64)
    bfirst = (pos_tile == 0).astype(np.uint64)
    BLAST = air.constant("BLAST", _tile(blast, n, n_pos, n_covered))
    BFIRST = air.constant("BFIRST", _tile(bfirst, n, n_pos, n_covered))

    streamm = (lay.byte_idx >= 0).astype(np.uint64)
    rs = np.zeros(n_pos, dtype=np.uint64)
    rc = np.zeros(n_pos, dtype=np.uint64)
    bfin = np.zeros(n_pos, dtype=np.uint64)
    for p in range(n_pos):
        if lay.byte_idx[p] < 0:
            continue
        rs[p] = 1 if (p == 0 or lay.byte_idx[p - 1] != lay.byte_idx[p]) \
            else 0
        rc[p] = 1 - rs[p]
        bfin[p] = 1 if (p == n_pos - 1
                        or lay.byte_idx[p + 1] != lay.byte_idx[p]) else 0
    outm = np.zeros(n_pos, dtype=np.uint64)
    outm[:lay.out_bits] = 1
    ors = np.zeros(n_pos, dtype=np.uint64)
    orc = np.zeros(n_pos, dtype=np.uint64)
    for p in range(n_pos):
        if lay.obyte_idx[p] < 0:
            continue
        ors[p] = 1 if (p == 0 or lay.obyte_idx[p - 1] != lay.obyte_idx[p]) \
            else 0
        orc[p] = 1 - ors[p]

    STRM = air.constant("STREAMM", _tile(streamm, n, n_pos, n_covered))
    BW = air.constant("BW", _tile(lay.byte_w, n, n_pos, n_covered))
    RS = air.constant("RS", _tile(rs, n, n_pos, n_covered))
    RC = air.constant("RC", _tile(rc, n, n_pos, n_covered))
    BFIN = air.constant("BFIN", _tile(bfin, n, n_pos, n_covered))
    BYIDX = air.constant(
        "BYIDX", _tile(np.maximum(lay.byte_idx, 0), n, n_pos, n_covered))
    SPM = air.constant("SPREVM", _tile(lay.sprev_mask, n, n_pos, n_covered))
    IVB = air.constant("IVBIT", _tile(lay.iv_bit, n, n_pos, n_covered))
    OUTM = air.constant("OUTM", _tile(outm, n, n_pos, n_covered))
    OSTRM = air.constant(
        "OSTREAMM",
        _tile((lay.obyte_idx >= 0).astype(np.uint64), n, n_pos, n_covered))
    OBW = air.constant("OBW", _tile(lay.obyte_w, n, n_pos, n_covered))
    ORS = air.constant("ORS", _tile(ors, n, n_pos, n_covered))
    ORC = air.constant("ORC", _tile(orc, n, n_pos, n_covered))
    dgw = [air.constant(
        f"DGW{l}",
        _tile(np.where(lay.dg_limb == l, lay.dg_w, 0), n, n_pos, n_covered))
        for l in range(8)]

    # booleans + structural masks (zero tail rows satisfy everything)
    for b in (rbit, sprev, sout, firstb):
        air.require_zero(b * (1 - b))
    air.require_zero(rbit * (1 - STRM))
    air.require_zero(sprev * (1 - SPM))
    air.require_zero(sout * (1 - OUTM))
    air.require_zero((1 - STRM) * bacc)
    air.require_zero((1 - OSTRM) * obacc)

    # FIRSTB block-constant; first-block state seeded with the IV
    firstb_p = ex.Cm(firstb.id, True)
    air.require_zero(COV * (1 - BLAST) * (firstb_p - firstb))
    air.require_zero(firstb * SPM * (sprev - IVB))

    # stream-byte accumulator over each 8-bit run
    rbit_p, bacc_p = ex.Cm(rbit.id, True), ex.Cm(bacc.id, True)
    air.require_zero(RS * (bacc - rbit * BW))
    air.require_zero(ex.Const(RC.id, True)
                     * (bacc_p - bacc - rbit_p * ex.Const(BW.id, True)))

    # output-byte accumulator
    sout_p, obacc_p = ex.Cm(sout.id, True), ex.Cm(obacc.id, True)
    air.require_zero(ORS * (obacc - sout * OBW))
    air.require_zero(ex.Const(ORC.id, True)
                     * (obacc_p - obacc - sout_p * ex.Const(OBW.id, True)))

    # digest limbs: accumulate completed output bytes, hold to block end.
    # DGATE[i] = COVERED[i+1]·(1-BFIRST[i+1]) precomputed so the hold
    # constraint stays degree-3.
    cov_next = np.roll(covered, -1)
    bfirst_tiled = _tile(bfirst, n, n_pos, n_covered)
    DGATE = air.constant(
        "DGATE", (cov_next * (1 - np.roll(bfirst_tiled, -1))
                  ).astype(np.uint64))
    for l in range(8):
        dl, dl_p = d[l], ex.Cm(d[l].id, True)
        air.require_zero(BFIRST * dl)
        air.require_zero(
            DGATE * (dl_p - dl - ex.Const(dgw[l].id, True) * obacc_p))

    # chaining: a non-first block's SPREV bits are the previous block's
    # SOUT bits at the same state position — positional plookup, unique
    # because (BIDC, POSC) pins one row. Constant products are folded to
    # keep the selector degrees low.
    CSPM = air.constant(
        "CSPM", covered * _tile(lay.sprev_mask, n, n_pos, n_covered))
    COUTM = air.constant("COUTM", covered * _tile(outm, n, n_pos,
                                                  n_covered))
    air.lookup([BID - 1, POS, sprev], [BID, POS, sout],
               sel_f=CSPM * (1 - firstb), sel_t=COUTM)
    return air


def sin_expr(air, sm: str):
    """SIN = SPREV XOR RBIT (masks make this the plain injection for sha)
    as a combined-AIR expression for the Bits2Field binding."""
    sprev, rbit = air.cm(sm, "SPREV"), air.cm(sm, "RBIT")
    return sprev + rbit - 2 * sprev * rbit


def bits_to_words(bits, word_bits: int, n_words: int) -> list[int]:
    """Position-order bits -> circuit words (p = word_bits*w + z)."""
    return [sum(int(bits[word_bits * w + z]) << z for z in range(word_bits))
            for w in range(n_words)]


def words_to_bits(words, word_bits: int) -> list[int]:
    return [(int(w) >> z) & 1 for w in words for z in range(word_bits)]


def circuit_perm_bits(circ):
    """perm_bits callable backed by a gate circuit (keccak_circuit.py) —
    the oracle that keeps reduced-round test circuits consistent across
    the padding / bit / packing / gate SMs."""
    import numpy as np

    from . import keccak_circuit as kc

    def perm(sin_bits):
        words = bits_to_words(sin_bits, circ.word_bits, circ.in_words)
        out = kc.evaluate(circ, np.array([words], dtype=np.uint64), pack=1)
        return words_to_bits(out[0], circ.word_bits)

    return perm


def execute(blocks: list[dict], n_bits: int, lay: BitLayout,
            perm_bits) -> tuple[np.ndarray, list[list[int]], list[tuple]]:
    """blocks: [{bytes: stream bytes, first: bool}] in pipeline (BID)
    order; perm_bits(sin_bits) -> out_bits runs the gate circuit's
    semantics on one block's n_pos input bits.

    Returns (trace, per-block digest limbs [D0..D7], per-block
    (sin_bits, sout_bits) for the Bits2Field / gate-SM traces)."""
    n = 1 << n_bits
    n_pos = lay.n_pos
    ci = {nm: i for i, nm in enumerate(COLS)}
    tr = np.zeros((n, len(COLS)), dtype=np.uint64)
    digests = []
    bits = []
    prev_out = None
    for g, blk in enumerate(blocks):
        data = bytes(blk["bytes"])
        assert len(data) == lay.n_stream_bytes
        first = bool(blk["first"])
        base = g * n_pos
        sprev = [0] * n_pos
        for p in range(n_pos):
            if lay.sprev_mask[p]:
                sprev[p] = int(lay.iv_bit[p]) if first else prev_out[p]
        rbit = [0] * n_pos
        for p in range(n_pos):
            bi = int(lay.byte_idx[p])
            if bi >= 0:
                w = int(lay.byte_w[p])
                rbit[p] = (data[bi] >> w.bit_length() - 1) & 1
        sin = [sprev[p] ^ rbit[p] for p in range(n_pos)]
        out = list(perm_bits(sin))
        assert len(out) >= lay.out_bits
        bacc = obacc = 0
        dlimb = [0] * 8
        for p in range(n_pos):
            row = tr[base + p]
            so = int(out[p]) if p < lay.out_bits else 0
            row[ci["RBIT"]] = rbit[p]
            row[ci["SPREV"]] = sprev[p]
            row[ci["SOUT"]] = so
            row[ci["FIRSTB"]] = 1 if first else 0
            if lay.byte_idx[p] >= 0:
                if p == 0 or lay.byte_idx[p - 1] != lay.byte_idx[p]:
                    bacc = 0
                bacc += rbit[p] * int(lay.byte_w[p])
                row[ci["BACC"]] = bacc
            if lay.obyte_idx[p] >= 0:
                if p == 0 or lay.obyte_idx[p - 1] != lay.obyte_idx[p]:
                    obacc = 0
                obacc += so * int(lay.obyte_w[p])
                row[ci["OBACC"]] = obacc
                if int(lay.dg_limb[p]) >= 0:
                    dlimb[int(lay.dg_limb[p])] += obacc * int(lay.dg_w[p])
            for l in range(8):
                row[ci[f"D{l}"]] = dlimb[l]
        digests.append(dlimb)
        bits.append((sin, [out[p] if p < lay.out_bits else 0
                           for p in range(lay.out_bits)]))
        prev_out = out
    return tr, digests, bits
