"""Shared byte-stream binding machinery for the padding SMs.

Reference: the addr/position/read-chunk/digest column block that
src/sm/padding_kk/padding_kk_executor.cpp and padding_sha256 share —
`addr` (strictly increasing per message, Main's hash address), `len`,
the crOffset/crLen/crF/crV chunk-read accumulators Main's hashK/hashS
rows look up, and the held digest limbs Main's hashXDigest rows read.

One instance of `add_binding` per padding SM adds:

  ADDR       Main's hash address, held per message, strictly increasing
             across messages (delta range-proven in two domain-sized limbs)
  POSREG     byte position within the message
  ILEN       message length, latched at the pad rise (POSREG there)
  ACTIVE     block-level flag: this block is mirrored into the bit
             pipeline (monotone prefix; inactive blocks' digests are
             unreadable because every Main-facing selector is ANDed in)
  FIRSTBLK   block starts a message (handed to HashBit's FIRSTB)
  DG0..7     digest limbs, held per message, bound to HashBit's D0..7
  chunk cols CSTART/CREND/CINV/CCONT/CRLEN/CSIZE/CRSP/F0..7/V0..7 —
             the data region is tiled into Main-write-sized chunks whose
             big-endian values accumulate into 32-bit limbs; the
             chunk-final tuple (ADDR, CRSP, CSIZE, V0..7) is Main's
             hash-write lookup target (selector CRXEND)
  MENDACT    materialized message-end·ACTIVE selector for the len/digest
             lookup targets

Port of `zkevm_prover_tpu/executor/sm/padding_stream.py`, imports rewritten.
"""

from __future__ import annotations

import numpy as np

from ...stark import expr as ex

MAX_CHUNK = 32


def add_binding(air, *, byte, pad, padfirst, lasth, poslast, inblock,
                block_bytes: int, n_bits: int) -> dict:
    """Register binding columns + constraints; returns handles by name."""
    n = 1 << n_bits
    addr = air.committed("ADDR")
    alo, ahi = air.committed("ALO", "AHI")
    posreg, ilen = air.committed("POSREG", "ILEN")
    active, firstblk = air.committed("ACTIVE", "FIRSTBLK")
    dg = air.committed(*[f"DG{l}" for l in range(8)])
    cstart, crend, cinv, ccont = air.committed(
        "CSTART", "CREND", "CINV", "CCONT")
    crlen, csize, crsp = air.committed("CRLEN", "CSIZE", "CRSP")
    f = air.committed(*[f"F{l}" for l in range(8)])
    v = air.committed(*[f"V{l}" for l in range(8)])
    crxend, mendact = air.committed("CRXEND", "MENDACT")
    blkcnt = air.committed("BLKCNT")

    # folded structural constants (the wrap row n-1 -> 0 is never a valid
    # stream transition: break it so power-of-two block sizes, which leave
    # no tail, don't chain the last block onto the first)
    ibib = inblock * np.roll(inblock, -1)
    ibib[-1] = 0
    gblk = (ibib * (1 - poslast)).astype(np.uint64)      # in-block, not last
    plib = (ibib * poslast).astype(np.uint64)            # block boundary
    n_blocks = n // block_bytes
    bidc = np.zeros(n, dtype=np.uint64)
    for b in range(n_blocks):
        bidc[b * block_bytes:(b + 1) * block_bytes] = b
    byteidx = np.zeros(n, dtype=np.uint64)
    byteidx[:n_blocks * block_bytes] = np.tile(
        np.arange(block_bytes, dtype=np.uint64), n_blocks)
    IBIB = air.constant("IBIB", ibib.astype(np.uint64))
    GBLK = air.constant("GBLK", gblk)
    PLIB = air.constant("PLIB", plib)
    BIDC = air.constant("BIDC", bidc)
    BYTEIDXC = air.constant("BYTEIDXC", byteidx)
    RT = air.constant("RT", np.arange(n, dtype=np.uint64))
    IBC = ex.Const(air.const_names.index("INBLOCK"))     # reuse module's IB

    # chunk factor table: crlen 1..32 -> the one-hot 256-power per limb
    tlen = np.zeros(n, dtype=np.uint64)
    tf = np.zeros((8, n), dtype=np.uint64)
    for s in range(1, MAX_CHUNK + 1):
        tlen[s - 1] = s
        tf[(s - 1) // 4][s - 1] = 1 << (8 * ((s - 1) % 4))
    TLEN = air.constant("TLEN", tlen)
    TF = [air.constant(f"TF{l}", tf[l]) for l in range(8)]
    ftsel = np.zeros(n, dtype=np.uint64)
    ftsel[:MAX_CHUNK] = 1
    FTSEL = air.constant("FTSEL", ftsel)

    nx = lambda h: ex.Cm(h.id, True)
    mend_nx = ex.Cm(lasth.id, True)  # unused; kept for clarity of naming
    del mend_nx
    l1 = air.lagrange_first()
    data = (1 - pad)

    # ---- ACTIVE / FIRSTBLK block flags ----------------------------------
    air.require_zero(active * (1 - active))
    air.require_zero(GBLK * (nx(active) - active))
    air.require_zero(PLIB * nx(active) * (1 - active))
    air.require_zero(firstblk * (1 - firstblk))
    air.require_zero(l1 * (firstblk - 1))
    air.require_zero(GBLK * (nx(firstblk) - firstblk))
    air.require_zero(PLIB * (nx(firstblk) - lasth))

    # ---- ADDR: held per message, strictly increasing across -------------
    not_mend = 1 - lasth  # on PLIB rows, mend == lasth
    air.require_zero(GBLK * (nx(addr) - addr))
    air.require_zero(PLIB * not_mend * (nx(addr) - addr))
    air.require_zero(
        PLIB * lasth * (nx(addr) - addr - 1 - alo - ahi * (1 << n_bits)))
    air.lookup([alo], [RT])
    air.lookup([ahi], [RT])

    # ---- POSREG / ILEN ---------------------------------------------------
    air.require_zero(l1 * posreg)
    air.require_zero(PLIB * lasth * nx(posreg))
    air.require_zero(GBLK * (nx(posreg) - posreg - 1))
    air.require_zero(PLIB * not_mend * (nx(posreg) - posreg - 1))
    air.require_zero(padfirst * (ilen - posreg))
    air.require_zero(GBLK * (nx(ilen) - ilen))
    air.require_zero(PLIB * not_mend * (nx(ilen) - ilen))

    # ---- digest limbs held per message -----------------------------------
    for l in range(8):
        air.require_zero(GBLK * (nx(dg[l]) - dg[l]))
        air.require_zero(PLIB * not_mend * (nx(dg[l]) - dg[l]))

    # ---- BLKCNT: 1-based block index within the message --------------------
    # At the message-end row BLKCNT is exactly the number of permutation
    # blocks the message occupies — the reference's incCounter the Main SM's
    # hashXDigest rows commit and main.pil binds through this very lookup
    # (ceil((len+pad)/BLOCK), main_executor.cpp:2906/3219/3478). The pad
    # structure already pins the message extent, so the count is sound.
    air.require_zero(l1 * (blkcnt - 1))
    air.require_zero(GBLK * (nx(blkcnt) - blkcnt))
    air.require_zero(PLIB * not_mend * (nx(blkcnt) - blkcnt - 1))
    air.require_zero(PLIB * lasth * (nx(blkcnt) - 1))

    # ---- chunk tiling of the data region ---------------------------------
    for b in (cstart, crend):
        air.require_zero(b * (1 - b))
    # CREND <-> CRLEN == 1 (on data rows)
    air.require_zero(IBC * data * ((crlen - 1) * cinv - (1 - crend)))
    air.require_zero(IBC * data * crend * (crlen - 1))
    # CCONT materializes data·(1-CSTART) so holds stay low-degree
    air.require_zero(IBC * (ccont - data * (1 - cstart)))
    air.require_zero((1 - IBC) * ccont)
    # chunk starts: message-start data row, or data row after a chunk end
    air.require_zero(l1 * data * (cstart - 1))
    air.require_zero(PLIB * lasth * (1 - nx(pad)) * (nx(cstart) - 1))
    air.require_zero(
        IBIB * (1 - lasth * ex.Const(air.const_names.index("POSLAST")))
        * (1 - nx(pad)) * (nx(cstart) - crend))
    # a chunk may not run into the pad region
    air.require_zero(IBIB * data * nx(pad) * (1 - crend))
    # countdown + held size/start-pos + value limbs
    air.require_zero(IBIB * nx(ccont) * (nx(crlen) - crlen + 1))
    air.require_zero(cstart * (csize - crlen))
    air.require_zero(IBIB * nx(ccont) * (nx(csize) - csize))
    air.require_zero(cstart * (crsp - posreg))
    air.require_zero(IBIB * nx(ccont) * (nx(crsp) - crsp))
    for l in range(8):
        air.require_zero(cstart * (v[l] - byte * f[l]))
        air.require_zero(
            IBIB * nx(ccont) * (nx(v[l]) - v[l] - nx(byte) * nx(f[l])))
    air.lookup([crlen] + list(f), [TLEN] + TF, sel_f=IBC * data,
               sel_t=FTSEL)

    # ---- materialized Main-facing selectors -------------------------------
    air.require_zero(IBC * (crxend - data * crend * active))
    air.require_zero((1 - IBC) * crxend)
    air.require_zero(
        IBC * ex.Const(air.const_names.index("POSLAST"))
        * (mendact - lasth * active))
    air.require_zero(
        (1 - IBC * ex.Const(air.const_names.index("POSLAST"))) * mendact)

    return {"ADDR": addr, "POSREG": posreg, "ILEN": ilen,
            "ACTIVE": active, "FIRSTBLK": firstblk, "DG": dg,
            "CSTART": cstart, "CREND": crend, "CRLEN": crlen,
            "CSIZE": csize, "CRSP": crsp, "V": v, "CRXEND": crxend,
            "MENDACT": mendact, "BLKCNT": blkcnt,
            "BIDC": BIDC, "BYTEIDXC": BYTEIDXC}


BIND_COLS = (["ADDR", "ALO", "AHI", "POSREG", "ILEN", "ACTIVE", "FIRSTBLK"]
             + [f"DG{l}" for l in range(8)]
             + ["CSTART", "CREND", "CINV", "CCONT", "CRLEN", "CSIZE",
                "CRSP"]
             + [f"F{l}" for l in range(8)] + [f"V{l}" for l in range(8)]
             + ["CRXEND", "MENDACT", "BLKCNT"])


def default_reads(length: int) -> dict:
    """Greedy 32-byte tiling for actions without Main write history."""
    reads = {}
    pos = 0
    while pos < length:
        reads[pos] = min(MAX_CHUNK, length - pos)
        pos += reads[pos]
    return reads


def chunk_plan(length: int, reads: dict | None) -> list[tuple[int, int]]:
    """[(start, size)] tiling [0, length); validates Main's read set."""
    if not reads:
        return list(default_reads(length).items())
    tiles = sorted(reads.items())
    pos = 0
    for start, size in tiles:
        assert start == pos and 1 <= size <= MAX_CHUNK, \
            f"hash reads are not a tiling at {start} (expected {pos})"
        pos += size
    assert pos == length, f"hash reads cover {pos} of {length} bytes"
    return tiles


class BindFiller:
    """Per-row binding-column values for one padding trace.

    Drive with `start_message` / `row` in stream order (rows arrive
    exactly as the padding module lays them out), then `finalize` to
    patch the inter-message address-delta limbs.
    """

    def __init__(self, gl_p: int, n_bits: int, block_bytes: int = 0):
        self.p = gl_p
        self.n_bits = n_bits
        self.bb = block_bytes
        self.blkcnt = 1
        self.addr = 0
        self.pos = 0
        self.ilen = 0
        self.dg = [0] * 8
        self.chunks: list[tuple[int, int]] = []
        self.ci = 0
        self.crlen = 0
        self.csize = 0
        self.crsp = 0
        self.vv = [0] * 8
        self._mends: list[tuple[int, int]] = []  # (global row, addr)

    def start_message(self, addr: int, length: int,
                      reads: dict | None, dg_limbs: list[int]):
        self.addr = addr
        self.pos = 0
        self.ilen = length
        self.dg = [int(x) % self.p for x in dg_limbs]
        self.chunks = chunk_plan(length, reads)
        self.ci = 0
        self.crlen = 0
        self.blkcnt = 1

    def row(self, global_row: int, byte_val: int, is_pad: bool,
            is_mend: bool, active: int, firstblk: int) -> list[int]:
        """Values for BIND_COLS at this stream row."""
        p = self.p
        cstart = crend = 0
        ff = [0] * 8
        if not is_pad:
            if self.crlen == 0:
                start, size = self.chunks[self.ci]
                assert start == self.pos
                cstart = 1
                self.ci += 1
                self.crlen = size
                self.csize = size
                self.crsp = start
                self.vv = [0] * 8
            k = self.crlen - 1
            ff[k // 4] = 1 << (8 * (k % 4))
            self.vv[k // 4] += byte_val * ff[k // 4]
            crend = 1 if self.crlen == 1 else 0
        cinv = pow(self.crlen - 1, p - 2, p) if (not is_pad
                                                 and self.crlen > 1) else 0
        ccont = 1 if (not is_pad and not cstart) else 0
        if is_mend:
            self._mends.append((global_row, self.addr))
        out = ([self.addr % p, 0, 0, self.pos, self.ilen, active,
                firstblk]
               + self.dg
               + [cstart, crend, cinv, ccont,
                  self.crlen if not is_pad else 0,
                  self.csize if not is_pad else 0,
                  self.crsp if not is_pad else 0]
               + ff + (list(self.vv) if not is_pad else [0] * 8)
               + [crend * active, (1 if is_mend else 0) * active,
                  self.blkcnt])
        self.pos += 1
        if not is_pad:
            self.crlen -= 1
        if self.bb and (global_row % self.bb) == self.bb - 1:
            self.blkcnt = 1 if is_mend else self.blkcnt + 1
        return out

    def finalize(self, tr: np.ndarray, col_of) -> None:
        """Patch ALO/AHI on each message-end row from the next message's
        address (the last message's end row carries no delta constraint
        when it closes the stream)."""
        for (r, a), (_, a_next) in zip(self._mends, self._mends[1:]):
            d = a_next - a - 1
            assert d >= 0, "hash addresses must strictly increase"
            lo = d & ((1 << self.n_bits) - 1)
            hi = d >> self.n_bits
            assert hi < (1 << self.n_bits), "hash address delta too large"
            tr[r, col_of("ALO")] = lo
            tr[r, col_of("AHI")] = hi
