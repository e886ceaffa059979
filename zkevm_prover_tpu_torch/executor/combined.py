"""Batch AIR — Main SM + co-processors in one proof with PROVEN bindings.

Port of `zkevm_prover_tpu/executor/combined.py`: the same combined AIR
(names, constants, constraints, bindings) and traces, over the port's SMs.

Reference: the zkEVM's single-trace architecture (every SM's columns in one
2^23-row buffer) makes the PIL inter-SM arguments sound, e.g. main.pil's

    mOp { addr, STEP, mWR, op0..7 } is Mem.{ addr, step, mWr, val0..7 }

Here `build_batch_air` composes the per-SM AIRs (stark.compose.CombinedAIR)
at one domain and declares those bindings as permutation/plookup arguments
over the merged columns, replacing the host-side action checks for the
covered machines. Coverage grows machine by machine; `BINDINGS` documents
what is proven vs still host-bound.

Current proven bindings:
  main <-> memory      every mOp row IS a Memory access row (permutation)
  main <-> binary      every BIN row IS a Binary op-end interface row:
                       operands from the A/B registers, result in op (or in
                       carry for LT/SLT/EQ via the table-bound USECARRY)
  main  -> poseidon_g  the sRD/sWR key derivation (both Poseidon
                       permutations of the C / A,B key inputs)
  main  -> storage     every sRD/sWR row looks up a storage action start
                       (root, key, value, new root, get/set kind)
  storage -> poseidon_g every claimed node/value preimage hashes to its
                       root (the ONODE/NNODE-flagged rows)
  storage -> climb_key every climb-down step is a ClimbKey op (no-wrap)
  main <-> mem_align   every memAlign row IS an active SM operation group:
                       window from A/B, value from op, new window from D/E,
                       offset from C0 (permutation on group-final rows)

  main <-> arith       every arithEq row IS an SM operation group:
                       operands from A/B/C/D, results from E/op, the op
                       kind pinned by the six selector legs (permutation
                       on group-final rows)

  main <-> padding_kk  every hashK write/len/digest row looks up the byte
                       chunk / length / digest the padding stream proves
                       (lookups keyed by the strictly-increasing ADDR)
  padding_kk <-> keccak_bit <-> keccak_b2f <-> keccak_f
                       bytes decompose to bits, absorb-XOR and block
                       chaining run row-local, bits pack instance-major
                       into the gate SM's bit-sliced elements (the full
                       Bits2Field role, ref bits2field_executor.cpp:7-44)
  main <-> padding_sha256 <-> sha256_bit/b2f/f   the same machinery for
                       hashS (Merkle-Damgard state injection + IV seed)
  main <-> padding_pg_byte <-> padding_pg        hashP byte stream packed
                       into 7-byte elements, bound positionally into the
                       PoseidonG permutation groups, fe4 digest read back

  main  -> padding_*   every hashXDigest row's committed incCounter
                       (INCCNT) equals the padded message's block count
                       (BLKCNT), driving the in-circuit cntKeccakF /
                       cntSha256F / cntPaddingPG / cntPoseidonG
                       transitions (reference incCounter, main.pil)
  main  -> storage     every sRD/sWR row's INCCNT - 2 equals the
                       Storage SM's per-action PoseidonG count (PHC)
  storage              foreign-leaf key-inequality witnesses: a leaf
                       row without FOUND must exhibit a differing key
                       lane (smt.cpp get-on-missing semantics)
"""

from __future__ import annotations

import time

import numpy as np

from ..stark import expr as ex
from ..stark.compose import CombinedAIR
from .sm import (arith, binary, bits2field, climb_key, hash_bit,
                 keccak_f, main_sm, mem_align, memory, padding_kk,
                 padding_pg, padding_pg_byte, padding_sha256, poseidon_g,
                 sha256_f, storage)

DEFAULT_INCLUDE = ("memory", "binary", "storage", "poseidon_g",
                   "climb_key", "mem_align", "arith")


def default_include(n_bits: int) -> tuple:
    """The SM set a batch proof at this domain can bind in-circuit.

    The Binary SM needs 64 rows/op at its largest affordable nibble width;
    a production batch's ~700 binary ops only fit from 2^16 up (the
    reference sizes everything at 2^23). The keccak/sha256 gate pipelines
    need >= 2^18 (one 24-round keccak slot = 155,286 rows,
    keccak_f_executor.hpp:47-48)."""
    inc = ("memory", "storage", "poseidon_g", "climb_key", "mem_align",
           "arith", "padding_pg")
    if n_bits >= 16:
        inc += ("binary",)
    if n_bits >= 18:
        inc += ("keccak", "sha256")
    return inc


def keccak_pipeline_cfg(circ, pack: int, limb_bits: int) -> dict:
    """Pipeline parameters for the keccak side ("keccak" in include).
    Production: (keccak_circuit.build(24), 44, 11) at 2^23."""
    m = -(-pack // limb_bits)
    assert m * limb_bits == pack, \
        "pack must be a whole number of limbs (slack lanes are unsound)"
    return {"circ": circ, "pack": pack, "limb_bits": limb_bits}


def build_batch_air(rom, n_bits: int,
                    include: tuple = DEFAULT_INCLUDE,
                    binary_slice_bits: int | None = None,
                    keccak_cfg: dict | None = None,
                    sha256_cfg: dict | None = None) -> CombinedAIR:
    air = CombinedAIR("batch", n_bits)
    air.add("main", main_sm.build_air(rom, n_bits))
    if "memory" in include:
        air.add("memory", memory.build_air(n_bits))
    if "binary" in include:
        sb = binary_slice_bits or _slice_bits(n_bits)
        air.add("binary", binary.build_air(n_bits, sb))
    if "storage" in include:
        assert "poseidon_g" in include, "storage binding needs poseidon_g"
        air.add("storage", storage.build_air(n_bits))
    if "poseidon_g" in include:
        air.add("poseidon_g", poseidon_g.build_air(n_bits))
    if "climb_key" in include:
        air.add("climb_key", climb_key.build_air(n_bits))
    if "mem_align" in include:
        air.add("mem_align", mem_align.build_air(n_bits))
    if "arith" in include:
        air.add("arith", arith.build_air(n_bits))
    if "keccak" in include:
        assert keccak_cfg is not None, "keccak needs keccak_pipeline_cfg"
        circ, pack = keccak_cfg["circ"], keccak_cfg["pack"]
        lay = hash_bit.keccak_layout()
        n_slots = (1 << n_bits) // circ.n_rows
        assert n_slots >= 1, "domain smaller than one keccak slot"
        n_cov = n_slots * pack
        air.add("padding_kk", padding_kk.build_air(n_bits))
        air.add("keccak_bit", hash_bit.build_air(n_bits, lay, n_cov,
                                                 name="keccak_bit"))
        air.add("keccak_b2f", bits2field.build_air(
            n_bits, lay.n_pos, lay.out_bits, pack, n_slots,
            name="keccak_b2f"))
        air.add("keccak_f", keccak_f.build_air(
            n_bits, circ, pack, keccak_cfg["limb_bits"]))
    if "sha256" in include:
        assert sha256_cfg is not None, "sha256 needs keccak_pipeline_cfg"
        circ, pack = sha256_cfg["circ"], sha256_cfg["pack"]
        lay = hash_bit.sha256_layout()
        n_slots = (1 << n_bits) // circ.n_rows
        assert n_slots >= 1, "domain smaller than one sha256 slot"
        n_cov = n_slots * pack
        air.add("padding_sha256", padding_sha256.build_air(n_bits))
        air.add("sha256_bit", hash_bit.build_air(n_bits, lay, n_cov,
                                                 name="sha256_bit"))
        air.add("sha256_b2f", bits2field.build_air(
            n_bits, lay.n_pos, lay.out_bits, pack, n_slots,
            name="sha256_b2f"))
        air.add("sha256_f", sha256_f.build_air(
            n_bits, circ, pack, sha256_cfg["limb_bits"]))
    if "padding_pg" in include:
        air.add("padding_pg_byte", padding_pg_byte.build_air(n_bits))
        air.add("padding_pg", padding_pg.build_air(n_bits))

    Z = ex.Number(0)

    def pos_iface():
        """PoseidonG (input12, hash4) tuple on its output rows."""
        t = ([air.cm("poseidon_g", f"IN{j}") for j in range(12)]
             + [air.cm("poseidon_g", f"S{j}") for j in range(4)])
        return t, air.const("poseidon_g", "GOUT")

    if "memory" in include:
        # main.mOp rows are exactly Memory's access rows (main.pil's Mem
        # permutation); STEP on the main side is the row index constant
        f = ([air.cm("main", "ADDR"), air.const("main", "STEP"),
              air.cm("main", "mWR")]
             + [air.cm("main", f"OP{l}") for l in range(8)])
        t = ([air.cm("memory", "ADDR"), air.cm("memory", "STEP"),
              air.cm("memory", "MWR")]
             + [air.cm("memory", f"VAL{i}") for i in range(8)])
        air.permutation(f, t, sel_f=air.cm("main", "mOp"),
                        sel_t=air.cm("memory", "MOP"))

    if "binary" in include:
        # main.BIN rows are exactly Binary's op-end rows (main.pil's Binary
        # permutation): operands are the A/B register files; the result
        # sits in op, except comparison ops whose result is the final carry
        # (USECARRY is bound by the Binary semantics table, so the op side
        # cannot lie about which shape applies)
        uc = air.cm("binary", "USECARRY")
        icc0 = (uc * air.cm("binary", "COUT")
                + (1 - uc) * air.cm("binary", "CC0"))
        f = ([air.cm("main", "BINOP")]
             + [air.cm("main", f"A{l}") for l in range(8)]
             + [air.cm("main", f"B{l}") for l in range(8)]
             + [air.cm("main", f"OP{l}") for l in range(8)]
             + [air.cm("main", "CARRY")])
        t = ([air.cm("binary", "OPC")]
             + [air.cm("binary", f"AA{j}") for j in range(8)]
             + [air.cm("binary", f"BB{j}") for j in range(8)]
             + [icc0] + [(1 - uc) * air.cm("binary", f"CC{j}")
                         for j in range(1, 8)]
             + [air.cm("binary", "COUT")])
        air.permutation(
            f, t, sel_f=air.cm("main", "BIN"),
            sel_t=air.cm("binary", "ACT") * air.const("binary", "GLAST"))

    if "poseidon_g" in include:
        tpos, gout = pos_iface()
        srd, swr = air.cm("main", "SRD"), air.cm("main", "SWR")
        s_sel = srd + swr
        # key derivation (main_executor.cpp:1080-1140): KI = H(C | 0),
        # KEY = H(A0..5,B0,B1 | KI)
        f1 = ([air.cm("main", f"C{l}") for l in range(8)] + [Z] * 4
              + [air.cm("main", f"KI{j}") for j in range(4)])
        air.lookup(f1, tpos, sel_f=s_sel, sel_t=gout)
        f2 = ([air.cm("main", f"A{l}") for l in range(6)]
              + [air.cm("main", "B0"), air.cm("main", "B1")]
              + [air.cm("main", f"KI{j}") for j in range(4)]
              + [air.cm("main", f"KEY{j}") for j in range(4)])
        air.lookup(f2, tpos, sel_f=s_sel, sel_t=gout)

    if "storage" in include:
        tpos, gout = pos_iface()
        # node hashes: every flagged preimage (children8 | leaf-cap) hashes
        # to the row's root — for both trees
        for pre in ("O", "N"):
            f = ([air.cm("storage", f"{pre}L{j}") for j in range(4)]
                 + [air.cm("storage", f"{pre}R{j}") for j in range(4)]
                 + [air.cm("storage", f"{pre}LEAF"), Z, Z, Z]
                 + [air.cm("storage", f"{pre}ROOT{j}") for j in range(4)])
            air.lookup(f, tpos, sel_f=air.cm("storage", f"{pre}NODE"),
                       sel_t=gout)
        # value preimage at a matching new leaf: NR = H(VLOW|VHIGH | 0)
        fv = ([air.cm("storage", f"VLOW{j}") for j in range(4)]
              + [air.cm("storage", f"VHIGH{j}") for j in range(4)]
              + [Z] * 4
              + [air.cm("storage", f"NR{j}") for j in range(4)])
        air.lookup(fv, tpos, sel_f=air.cm("storage", "FOUNDN"),
                   sel_t=gout)

        # main sRD/sWR rows look up a storage action start: the SR register
        # (as 4 field elements), the derived key, the value (op for reads,
        # D for writes), the resulting root (op for writes), and the kind
        srd, swr = air.cm("main", "SRD"), air.cm("main", "SWR")
        srfe = [air.cm("main", f"SR{2 * i}")
                + air.cm("main", f"SR{2 * i + 1}") * (1 << 32)
                for i in range(4)]
        opfe = [air.cm("main", f"OP{2 * i}")
                + air.cm("main", f"OP{2 * i + 1}") * (1 << 32)
                for i in range(4)]
        val = [srd * air.cm("main", f"OP{l}") + swr * air.cm("main", f"D{l}")
               for l in range(8)]
        nr = [srd * srfe[i] + swr * opfe[i] for i in range(4)]
        f = (srfe + [air.cm("main", f"KEY{j}") for j in range(4)]
             + val + nr + [srd]
             # incCounter = PHC + 2 key-derivation hashes (the reference's
             # proofHashCounter + 2 committed on sRD/sWR rows)
             + [air.cm("main", "INCCNT") - 2])
        t = ([air.cm("storage", f"OROOT{j}") for j in range(4)]
             + [air.cm("storage", f"RKEY{j}") for j in range(4)]
             + [air.cm("storage", f"VLOW{j}") for j in range(4)]
             + [air.cm("storage", f"VHIGH{j}") for j in range(4)]
             + [air.cm("storage", f"ANROOT{j}") for j in range(4)]
             + [air.cm("storage", "SAME")]
             + [air.cm("storage", "PHC")])
        air.lookup(f, t, sel_f=srd + swr,
                   sel_t=air.cm("storage", "START")
                   * air.cm("storage", "OACT"))

    if "mem_align" in include:
        # main memAlign rows are exactly the SM's active operation groups
        # (main.pil's MemAlign permutation): window m0||m1 from A/B, value
        # from op, new window in D/E (writes) — in window coordinates
        # w0 == B, w1 == A, and the SM's little-endian limbs equal the
        # registers' 32-bit limbs directly. OFF maps as 32-C0 (RD/WR,
        # span 32 at big-endian offset C) / 63-C0 (WR8).
        rd = air.cm("main", "MEMALIGNRD")
        wr = air.cm("main", "MEMALIGNWR")
        wr8 = air.cm("main", "MEMALIGNWR8")
        sel = rd + wr + wr8
        off_f = 32 - air.cm("main", "C0") + wr8 * 31
        # reads leave the window untouched (the SM forces NM == M), so the
        # new-window legs mux to A/B on RD rows. WR8 only rewrites one byte
        # of the A word (w1): the reference checks D alone and leaves E
        # unconstrained on WR8 rows (main_executor.cpp fork_5..9 WR8 branch
        # reads only pols.D), so the unchanged low word muxes back to B.
        new1 = [rd * air.cm("main", f"A{l}")
                + (wr + wr8) * air.cm("main", f"D{l}") for l in range(8)]
        new0 = [(rd + wr8) * air.cm("main", f"B{l}")
                + wr * air.cm("main", f"E{l}") for l in range(8)]
        f = ([wr, wr8, off_f]
             + [air.cm("main", f"A{l}") for l in range(8)]
             + [air.cm("main", f"B{l}") for l in range(8)]
             + [air.cm("main", f"OP{l}") for l in range(8)]
             + new1 + new0)
        t = ([air.cm("mem_align", "ISWR"), air.cm("mem_align", "ISWR8"),
              air.cm("mem_align", "OFF")]
             + [air.cm("mem_align", f"M1_{j}") for j in range(8)]
             + [air.cm("mem_align", f"M0_{j}") for j in range(8)]
             + [air.cm("mem_align", f"V_{j}") for j in range(8)]
             + [air.cm("mem_align", f"NM1_{j}") for j in range(8)]
             + [air.cm("mem_align", f"NM0_{j}") for j in range(8)])
        glast = 1 - air.const("mem_align", "NOT_LAST_G")
        air.permutation(f, t, sel_f=sel,
                        sel_t=air.cm("mem_align", "ACT") * glast)

    if "arith" in include:
        # main arith rows are exactly the SM's operation groups (main.pil's
        # Arith permutation): operands from A/B/C/D, results in E/op. The
        # SM's 16-bit limb pairs recompose to the registers' 32-bit limbs.
        # Muxes mirror the reference action building (main_executor.cpp:
        # 3993-3994): doubling carries x2=x1 (=A), y2=y1 (=B); eq0 has no
        # x3 (the SM commits zeros there).
        eqf = [air.cm("main", f"ARITHEQ{i}") for i in range(6)]
        sel_f = eqf[0] + eqf[1] + eqf[2] + eqf[3] + eqf[4] + eqf[5]
        use_cd = eqf[0] + eqf[1] + eqf[3] + eqf[4] + eqf[5]
        use_e = eqf[1] + eqf[2] + eqf[3] + eqf[4] + eqf[5]
        x2mux = [use_cd * air.cm("main", f"C{l}")
                 + eqf[2] * air.cm("main", f"A{l}") for l in range(8)]
        y2mux = [use_cd * air.cm("main", f"D{l}")
                 + eqf[2] * air.cm("main", f"B{l}") for l in range(8)]
        x3mux = [use_e * air.cm("main", f"E{l}") for l in range(8)]
        f = (eqf
             + [air.cm("main", f"A{l}") for l in range(8)]
             + [air.cm("main", f"B{l}") for l in range(8)]
             + x2mux + y2mux + x3mux
             + [air.cm("main", f"OP{l}") for l in range(8)])

        def pairs(col):
            return [air.cm("arith", f"{col}_{2 * l}")
                    + air.cm("arith", f"{col}_{2 * l + 1}") * (1 << 16)
                    for l in range(8)]

        sels_t = [air.cm("arith", nm) for nm in
                  ("SELEQ0", "SELADD", "SELDBL", "SELMUL2", "SELADD2",
                   "SELSUB2")]
        t = (sels_t + pairs("X1") + pairs("Y1") + pairs("X2")
             + pairs("Y2") + pairs("X3") + pairs("Y3"))
        selsum_t = (sels_t[0] + sels_t[1] + sels_t[2] + sels_t[3]
                    + sels_t[4] + sels_t[5])
        air.permutation(f, t, sel_f=sel_f,
                        sel_t=air.const("arith", "CLK31") * selsum_t)

    if "keccak" in include:
        _bind_hash_pipeline(
            air, flag_prefix="HASHK", padding="padding_kk",
            bit="keccak_bit", b2f="keccak_b2f", gate="keccak_f",
            pack=keccak_cfg["pack"],
            limb_bits=keccak_cfg["limb_bits"],
            m=-(-keccak_cfg["pack"] // keccak_cfg["limb_bits"]))

    if "sha256" in include:
        _bind_hash_pipeline(
            air, flag_prefix="HASHS", padding="padding_sha256",
            bit="sha256_bit", b2f="sha256_b2f", gate="sha256_f",
            pack=sha256_cfg["pack"],
            limb_bits=sha256_cfg["limb_bits"],
            m=-(-sha256_cfg["pack"] // sha256_cfg["limb_bits"]))

    if "padding_pg" in include:
        # Main hashP rows -> the byte front (same machinery as hashK)
        _bind_main_padding(air, "HASHP", "padding_pg_byte")
        # byte-front elements / flags / digests -> the PoseidonG groups
        # (positional: byte block id == PaddingPG group id)
        bidc = air.const("padding_pg_byte", "BIDC")
        act = air.cm("padding_pg_byte", "ACTIVE")
        pgid = air.const("padding_pg", "PGID")
        pclk0 = air.const("padding_pg", "PCLK0")
        for j in range(8):
            air.lookup([bidc, air.cm("padding_pg_byte", "ELEM")],
                       [pgid, air.cm("padding_pg", f"S{j}")],
                       sel_f=air.const("padding_pg_byte", f"EFIN{j}")
                       * act, sel_t=pclk0)
        air.lookup([bidc, air.cm("padding_pg_byte", "FIRSTBLK")],
                   [pgid, 1 - air.cm("padding_pg", "CONT")],
                   sel_f=air.const("padding_pg_byte", "POSLAST") * act,
                   sel_t=pclk0)
        fes = [air.cm("padding_pg_byte", f"DG{2 * i}")
               + air.cm("padding_pg_byte", f"DG{2 * i + 1}") * (1 << 32)
               for i in range(4)]
        air.lookup([bidc] + fes,
                   [pgid] + [air.cm("padding_pg", f"S{i}")
                             for i in range(4)],
                   sel_f=air.cm("padding_pg_byte", "MENDACT"),
                   sel_t=air.const("padding_pg", "HOLD"))

    if "climb_key" in include and "storage" in include:
        # every storage climb-down step must be a ClimbKey operation: the
        # climb table's result row carries the PARENT key (the climbed
        # lane, K@ISLAST = 2·child+bit without wrap), so binding the
        # current row's RKEY proves the parent lane is reachable by a
        # non-wrapping climb — the guarantee the storage AIR's modular
        # climb equation (RKEY = 2·RKEY' + BIT mod p) cannot give itself
        f = ([air.cm("storage", f"RKEY{j}") for j in range(4)]
             + [air.cm("storage", "LEVEL"), air.cm("storage", "BIT")])
        t = ([air.cm("climb_key", f"KEY{j}") for j in range(4)]
             + [air.cm("climb_key", "LEVEL"), air.cm("climb_key", "BIT")])
        air.lookup(f, t, sel_f=1 - air.cm("storage", "LAST"),
                   sel_t=air.const("climb_key", "ISLAST"))
    return air


def _bind_main_padding(air: CombinedAIR, flag_prefix: str,
                       padding: str) -> None:
    """Main's hash write/len/digest rows -> padding stream tuples
    (reference main.pil's hashK/hashS/hashP lookups)."""
    # 1. Main hash-write rows -> padding chunk tuples
    #    (addr, start pos, byte count, 256-bit value in 32-bit limbs)
    w, w1 = air.cm("main", flag_prefix), air.cm("main", f"{flag_prefix}1")
    size = w * air.cm("main", "D0") + w1
    f = ([air.cm("main", "ADDR"), air.cm("main", "HASHPOS"), size]
         + [air.cm("main", f"OP{l}") for l in range(8)])
    t = ([air.cm(padding, "ADDR"), air.cm(padding, "CRSP"),
          air.cm(padding, "CSIZE")]
         + [air.cm(padding, f"V{l}") for l in range(8)])
    air.lookup(f, t, sel_f=w + w1, sel_t=air.cm(padding, "CRXEND"))

    # 2. Main hashLen / hashDigest rows -> padding message-end tuples.
    # The digest row also binds its committed incCounter (INCCNT) to the
    # message's block count — the reference main.pil hashKDigest lookup
    # carrying incCounter into PaddingKK (main_executor.cpp:5252-5257).
    air.lookup([air.cm("main", "ADDR"), air.cm("main", "OP0")],
               [air.cm(padding, "ADDR"), air.cm(padding, "ILEN")],
               sel_f=air.cm("main", f"{flag_prefix}LEN"),
               sel_t=air.cm(padding, "MENDACT"))
    air.lookup([air.cm("main", "ADDR"), air.cm("main", "INCCNT")]
               + [air.cm("main", f"OP{l}") for l in range(8)],
               [air.cm(padding, "ADDR"), air.cm(padding, "BLKCNT")]
               + [air.cm(padding, f"DG{l}") for l in range(8)],
               sel_f=air.cm("main", f"{flag_prefix}DIGEST"),
               sel_t=air.cm(padding, "MENDACT"))


def _bind_hash_pipeline(air: CombinedAIR, *, flag_prefix: str,
                        padding: str, bit: str, b2f: str, gate: str,
                        pack: int, limb_bits: int, m: int) -> None:
    """The four binding layers of one hash pipeline (reference main.pil's
    hashK/hashS lookups + the paddingbit/bits2field/gate PIL chain)."""
    _bind_main_padding(air, flag_prefix, padding)

    # 3. padding blocks -> bit rows: bytes, message-start flags, digests
    #    (positional lookups — (block id, index) constants pin one row)
    cov_bfin = air.const(bit, "COVERED") * air.const(bit, "BFIN")
    cov_blast = air.const(bit, "COVERED") * air.const(bit, "BLAST")
    air.lookup([air.const(padding, "BIDC"), air.const(padding, "BYTEIDXC"),
                air.cm(padding, "BYTE")],
               [air.const(bit, "BIDC"), air.const(bit, "BYIDX"),
                air.cm(bit, "BACC")],
               sel_f=air.const(padding, "INBLOCK")
               * air.cm(padding, "ACTIVE"),
               sel_t=cov_bfin)
    air.lookup([air.const(padding, "BIDC"), air.cm(padding, "FIRSTBLK")],
               [air.const(bit, "BIDC"), air.cm(bit, "FIRSTB")],
               sel_f=air.const(padding, "POSLAST")
               * air.cm(padding, "ACTIVE"),
               sel_t=cov_blast)
    air.lookup([air.const(padding, "BIDC")]
               + [air.cm(padding, f"DG{l}") for l in range(8)],
               [air.const(bit, "BIDC")]
               + [air.cm(bit, f"D{l}") for l in range(8)],
               sel_f=air.cm(padding, "MENDACT"), sel_t=cov_blast)

    # 4. bit rows <-> packer rows (every covered (block, pos) bit pair),
    #    and packed accumulators <-> the gate SM's input/output elements
    air.permutation(
        [air.const(b2f, "SID") * pack + air.const(b2f, "J"),
         air.const(b2f, "POSG"), air.cm(b2f, "BITIN"),
         air.cm(b2f, "BITOUT")],
        [air.const(bit, "BIDC"), air.const(bit, "POSC"),
         hash_bit.sin_expr(air, bit), air.cm(bit, "SOUT")],
        sel_f=air.const(b2f, "USED"), sel_t=air.const(bit, "COVERED"))

    def composed(col_prefix):
        acc = ex.Number(0)
        for j in range(m):
            acc = acc + air.cm(gate, f"{col_prefix}{j}") \
                * (1 << (j * limb_bits))
        return acc

    air.permutation(
        [air.const(b2f, "SID"), air.const(b2f, "POSG"),
         air.cm(b2f, "ACCI")],
        [air.const(gate, "SLOTID"), air.const(gate, "INPOS"),
         composed("A")],
        sel_f=air.const(b2f, "USED") * air.const(b2f, "JLAST"),
        sel_t=air.const(gate, "INSEL"))
    air.permutation(
        [air.const(b2f, "SID"), air.const(b2f, "POSG"),
         air.cm(b2f, "ACCO")],
        [air.const(gate, "SLOTID"), air.const(gate, "OUTPOS"),
         composed("C")],
        sel_f=air.const(b2f, "JLASTOUT"),
        sel_t=air.const(gate, "OUTSEL"))


def _slice_bits(n_bits: int) -> int:
    n = 1 << n_bits
    s = 1
    while 28 * (4 ** (s + 1)) <= n and s < 4:
        s += 1
    return s


def execute_batch(rom, n_bits: int, input: dict | None = None, smt=None,
                  include: tuple = DEFAULT_INCLUDE,
                  binary_slice_bits: int | None = None,
                  keccak_cfg: dict | None = None,
                  sha256_cfg: dict | None = None, device=None,
                  times: dict | None = None):
    """Run the Main interpreter, fill every bound SM's trace, and stack the
    combined trace. Returns (MainResult, traces dict). Only PaddingSha256's
    compression chain touches a device (`device`, CUDA unless told
    otherwise); everything else runs on the host. `times`, when given,
    gets the host seconds of Main and of each SM's witness (a hash
    pipeline's under "keccak" / "sha256")."""
    times = {} if times is None else times
    clock = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        times[name] = now - clock[0]
        clock[0] = now

    hash_oracles = {}
    if "keccak" in include and keccak_cfg["circ"].rounds < 24:
        # reduced-round test circuit: keep Main's digest oracle consistent
        # with what the gate pipeline will actually prove
        lay_k = hash_bit.keccak_layout()
        perm_k = hash_bit.circuit_perm_bits(keccak_cfg["circ"])
        hash_oracles["K"] = lambda data: _sponge_digest(data, lay_k, perm_k)
    if "sha256" in include and sha256_cfg["circ"].rounds < 64:
        lay_s = hash_bit.sha256_layout()
        perm_s = hash_bit.circuit_perm_bits(sha256_cfg["circ"])
        hash_oracles["S"] = lambda data: _md_digest(data, lay_s, perm_s)
    res = main_sm.MainExecutor(rom, n_bits).execute(
        input=input, smt=smt, hash_oracles=hash_oracles or None)
    traces = {"main": res.trace}
    mark("main")
    if "memory" in include:
        traces["memory"], _ = memory.execute(res.actions.memory, n_bits)
        mark("memory")
    if "mem_align" in include:
        traces["mem_align"], _ = mem_align.execute(
            res.actions.mem_align, n_bits)
        mark("mem_align")
    if "binary" in include:
        sb = binary_slice_bits or _slice_bits(n_bits)
        traces["binary"] = binary.execute(res.actions.binary, n_bits, sb)
        mark("binary")
    if "arith" in include:
        traces["arith"] = arith.execute(res.actions.arith, n_bits)
        mark("arith")
    if "storage" in include:
        traces["storage"], emitted = storage.execute(
            res.actions.storage, n_bits,
            smt.db if smt is not None else None)
        res.actions.poseidon_g += emitted["poseidon_g"]
        res.actions.climb_key += emitted["climb_key"]
        mark("storage")
    if "poseidon_g" in include:
        traces["poseidon_g"] = poseidon_g.execute(
            res.actions.poseidon_g, n_bits)
        mark("poseidon_g")
    if "climb_key" in include:
        traces["climb_key"] = climb_key.execute(
            res.actions.climb_key, n_bits)
        mark("climb_key")
    if "keccak" in include:
        circ, pack = keccak_cfg["circ"], keccak_cfg["pack"]
        lb = keccak_cfg["limb_bits"]
        lay = hash_bit.keccak_layout()
        n_slots = (1 << n_bits) // circ.n_rows
        n_cov = n_slots * pack
        perm = hash_bit.circuit_perm_bits(circ) if circ.rounds < 24 \
            else _host_keccak_perm
        msgs_blocks = padding_kk.layout(res.actions.keccak, n_bits, n_cov)
        blocks = msgs_blocks[1]
        traces["keccak_bit"], dlimbs, bits = hash_bit.execute(
            blocks, n_bits, lay, perm)
        traces["padding_kk"], _, _ = padding_kk.execute(
            res.actions.keccak, n_bits, n_cov, dlimbs,
            msgs_blocks=msgs_blocks)
        traces["keccak_b2f"] = bits2field.execute(
            bits, n_bits, lay.n_pos, lay.out_bits, pack, n_slots)
        kc_actions = [
            {"state": np.array(hash_bit.bits_to_words(sin, 64, 25),
                               dtype=np.uint64)} for sin, _ in bits]
        traces["keccak_f"] = keccak_f.execute(
            kc_actions, n_bits, circ, pack, lb)
        mark("keccak")
    if "sha256" in include:
        circ, pack = sha256_cfg["circ"], sha256_cfg["pack"]
        lb = sha256_cfg["limb_bits"]
        lay = hash_bit.sha256_layout()
        n_slots = (1 << n_bits) // circ.n_rows
        n_cov = n_slots * pack
        perm = hash_bit.circuit_perm_bits(circ) if circ.rounds < 64 \
            else _host_sha_perm
        msgs_blocks = padding_sha256.layout(res.actions.sha256, n_bits,
                                            n_cov)
        blocks = msgs_blocks[1]
        traces["sha256_bit"], dlimbs, bits = hash_bit.execute(
            blocks, n_bits, lay, perm)
        traces["padding_sha256"], _, _ = padding_sha256.execute(
            res.actions.sha256, n_bits, n_cov, dlimbs,
            msgs_blocks=msgs_blocks, device=device)
        traces["sha256_b2f"] = bits2field.execute(
            bits, n_bits, lay.n_pos, lay.out_bits, pack, n_slots)
        sha_actions = []
        for sin, _ in bits:
            words = hash_bit.bits_to_words(sin, 32, 24)
            sha_actions.append({"state": words[:8], "block": words[8:]})
        traces["sha256_f"] = sha256_f.execute(
            sha_actions, n_bits, circ, pack, lb)
        mark("sha256")
    if "padding_pg" in include:
        traces["padding_pg_byte"], pg_acts, _ = padding_pg_byte.execute(
            res.actions.hashp, n_bits)
        traces["padding_pg"] = padding_pg.execute_chunks(pg_acts, n_bits)
        mark("padding_pg")
    return res, traces


def _host_keccak_perm(sin_bits):
    from ..ops import keccak as keccak_mod

    lanes = hash_bit.bits_to_words(sin_bits, 64, 25)
    out = keccak_mod._keccak_f_host(lanes)
    return hash_bit.words_to_bits(out, 64)


def _host_sha_perm(sin_bits):
    """sha256_compress on the (state || block) input bit layout (the plain
    twin on the host, as the JAX package computes it there)."""
    from .sm import padding_sha256 as psha

    words = hash_bit.bits_to_words(sin_bits, 32, 24)
    out = psha._compress_host(words[:8], words[8:], "cpu")
    return hash_bit.words_to_bits(out, 32)


def _md_digest(data: bytes, lay, perm_bits) -> int:
    """Merkle-Damgard digest (sha256 shape) over a permutation oracle."""
    rate = lay.n_stream_bytes
    nb = (len(data) + 8) // rate + 1
    padded = bytearray(data) + bytearray(nb * rate - len(data))
    padded[len(data)] = 0x80
    padded[-8:] = (8 * len(data)).to_bytes(8, "big")
    prev = None
    for b in range(nb):
        block = padded[b * rate:(b + 1) * rate]
        sin = [0] * lay.n_pos
        for p in range(lay.n_pos):
            if lay.sprev_mask[p]:
                sin[p] = int(lay.iv_bit[p]) if b == 0 else prev[p]
            bi = int(lay.byte_idx[p])
            if bi >= 0:
                w = int(lay.byte_w[p]).bit_length() - 1
                sin[p] = (block[bi] >> w) & 1
        prev = perm_bits(sin)
    words = hash_bit.bits_to_words(prev, 32, 8)
    return sum(words[w] << (32 * (7 - w)) for w in range(8))


def _sponge_digest(data: bytes, lay, perm_bits) -> int:
    """keccak-shape sponge over an arbitrary permutation oracle (test
    circuits); digest = first 32 output-stream bytes, big-endian."""
    rate = lay.n_stream_bytes
    nb = len(data) // rate + 1
    padded = bytearray(data) + bytearray(nb * rate - len(data))
    padded[len(data)] |= 0x01
    padded[-1] |= 0x80
    out = None
    prev = [0] * lay.n_pos
    for b in range(nb):
        block = padded[b * rate:(b + 1) * rate]
        sin = list(prev)
        for p in range(lay.n_pos):
            bi = int(lay.byte_idx[p])
            if bi >= 0:
                w = int(lay.byte_w[p]).bit_length() - 1
                sin[p] ^= (block[bi] >> w) & 1
        out = perm_bits(sin)
        prev = out
    digest = 0
    for p in range(256):
        if p % 8 == 7:
            byte = sum(((out[p - 7 + i]) << i) for i in range(8))
            digest |= byte << (8 * (31 - p // 8))
    return digest
