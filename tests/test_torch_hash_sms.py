"""The port's hash machines against the JAX package, bit for bit (numpy on
the host on both sides; exact, since everything is integer): the gate
circuits of Keccak-f and SHA-256, the KeccakF and Sha256F AIRs, sigmas and
traces, the padding SMs (PaddingKK, PaddingSha256, PaddingPGByte and their
shared binding block), HashBit and Bits2Field for the Keccak and SHA-256
layouts, the Executor's keccak and sha256 actions, and
`check_constraints` on honest and tampered traces. Sizes are the JAX
tests' (tests/test_keccak_f_sm.py, test_sha256_sm.py,
test_padding_kk_sm.py)."""

import functools

import numpy as np
import pytest

from zkevm_prover_tpu.executor import BatchActions as JActions
from zkevm_prover_tpu.executor import Executor as JExecutor
from zkevm_prover_tpu.executor.sm import bits2field as jbits2field
from zkevm_prover_tpu.executor.sm import hash_bit as jhash_bit
from zkevm_prover_tpu.executor.sm import keccak_circuit as jkc
from zkevm_prover_tpu.executor.sm import keccak_f as jkeccak_f
from zkevm_prover_tpu.executor.sm import padding_kk as jpadding_kk
from zkevm_prover_tpu.executor.sm import padding_pg_byte as jpadding_pg_byte
from zkevm_prover_tpu.executor.sm import padding_sha256 as jpadding_sha256
from zkevm_prover_tpu.executor.sm import padding_stream as jpadding_stream
from zkevm_prover_tpu.executor.sm import sha256_circuit as jsc
from zkevm_prover_tpu.executor.sm import sha256_f as jsha256_f
from zkevm_prover_tpu.ops import keccak as jkeccak
from zkevm_prover_tpu.stark.prover import StarkProver as JProver
from zkevm_prover_tpu.stark.setup import StarkSetup as JSetup
from zkevm_prover_tpu_torch.executor import BatchActions, Executor
from zkevm_prover_tpu_torch.executor.sm import (bits2field, hash_bit,
                                                keccak_f, padding_kk,
                                                padding_pg_byte,
                                                padding_sha256,
                                                padding_stream, sha256_f)
from zkevm_prover_tpu_torch.executor.sm import keccak_circuit as kc
from zkevm_prover_tpu_torch.executor.sm import sha256_circuit as sc
from zkevm_prover_tpu_torch.ops import keccak
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.setup import StarkSetup

M64 = (1 << 64) - 1
PACK, LIMB_BITS = 4, 2
# gate SM -> (port module, JAX module, port circuit build, JAX build,
# rounds, log2 rows, words per instance, word mask): the JAX tests' sizes
GATES = {
    "keccak_f": (keccak_f, jkeccak_f, kc.build, jkc.build, 1, 14, 25, M64),
    "sha256_f": (sha256_f, jsha256_f, sc.build, jsc.build, 8, 14, 24,
                 (1 << 32) - 1),
}

KECCAK_MSGS = [{"data": b"hello keccak padding"},
               {"data": bytes(range(200))},             # two blocks
               {"data": b""},
               {"data": bytes([7] * 135)},              # 0x81 pad byte
               {"data": bytes(range(40)), "addr": 9,    # Main's reads
                "reads": {0: 32, 32: 5, 37: 3}}]
SHA_MSGS = [{"data": b"hello sha"},
            {"data": bytes(range(100))},                # pad spills over
            {"data": b""},
            {"data": bytes([5] * 56)},                  # suffix block
            {"data": bytes(range(70)), "addr": 11,
             "reads": {0: 32, 32: 32, 64: 6}}]
PG_MSGS = [{"data": b"contract bytecode"}, {"data": bytes(range(120))},
           {"data": b""}, {"data": bytes([3] * 55)}]
PADDING = {  # name -> (port module, JAX module, messages, log2 rows)
    "padding_kk": (padding_kk, jpadding_kk, KECCAK_MSGS, 10),
    "padding_sha256": (padding_sha256, jpadding_sha256, SHA_MSGS, 10),
    "padding_pg_byte": (padding_pg_byte, jpadding_pg_byte, PG_MSGS, 10),
}


def _circuit_fields(c):
    return (c.ops.tolist(), c.a_src, c.b_src, c.inputs, c.outputs, c.one,
            c.zero, c.rounds, c.in_words, c.word_bits, c.out_words)


@functools.lru_cache(maxsize=None)
def _circuits(kind: str, rounds: int):
    if kind == "keccak":
        return kc.build(rounds), jkc.build(rounds)
    return sc.build(rounds), jsc.build(rounds)


@pytest.mark.parametrize("kind,rounds", [("keccak", 1), ("keccak", 24),
                                         ("sha256", 1), ("sha256", 8)])
def test_circuits_match_jax(kind, rounds):
    circ, jcirc = _circuits(kind, rounds)
    assert _circuit_fields(circ) == _circuit_fields(jcirc)
    assert circ.ops.dtype == jcirc.ops.dtype


@pytest.mark.parametrize("gate", sorted(GATES))
def test_wire_values_and_evaluate_match_jax(gate):
    _, _, build, jbuild, rounds, _, words, mask = GATES[gate]
    circ, jcirc = build(rounds), jbuild(rounds)
    states = np.random.default_rng(50).integers(
        0, M64, (PACK - 1, words), dtype=np.uint64) & np.uint64(mask)
    want = jkc.wire_values(jcirc, states, PACK)
    np.testing.assert_array_equal(kc.wire_values(circ, states, PACK),
                                  want.astype(np.uint64))
    np.testing.assert_array_equal(kc.evaluate(circ, states, PACK),
                                  jkc.evaluate(jcirc, states, PACK))


def test_full_circuits_compute_keccak_f_and_sha256():
    circ = _circuits("keccak", 24)[0]
    states = np.random.default_rng(3).integers(0, 1 << 63, (3, 25),
                                               dtype=np.uint64)
    out = kc.evaluate(circ, states, pack=44)
    for k in range(3):
        assert [int(v) for v in out[k]] == keccak._keccak_f_host(
            [int(v) for v in states[k]])
    # one pre-padded block of "abc" through the 64-round circuit
    padded = bytearray(b"abc") + bytearray(61)
    padded[3] = 0x80
    padded[-8:] = (8 * 3).to_bytes(8, "big")
    block = [int.from_bytes(padded[4 * i:4 * i + 4], "big")
             for i in range(16)]
    acts = [{"state": [int(v) for v in sc.initial_state()], "block": block}]
    out = sha256_f.digests(sc.build(64), acts, pack=40)
    assert b"".join(int(w).to_bytes(4, "big") for w in out[0]) == \
        bytes.fromhex("ba7816bf8f01cfea414140de5dae2223"
                      "b00361a396177a9cb410ff61f20015ad")


@pytest.mark.parametrize("limb_bits,ops", [(2, (kc.XOR, kc.ANDP)),
                                           (3, sha256_f.TABLE_OPS)])
def test_gate_table_and_tags_match_jax(limb_bits, ops):
    np.testing.assert_array_equal(
        keccak_f._gate_table(limb_bits, ops),
        np.array(jkeccak_f._gate_table(limb_bits, ops), dtype=np.uint64))
    dom, ks = keccak_f._id_tags(limb_bits + 8)
    jdom, jks = jkeccak_f._id_tags(limb_bits + 8)
    np.testing.assert_array_equal(dom, jdom)
    assert ks == jks


@functools.lru_cache(maxsize=None)
def _gate_air(gate):
    mod, jmod, build, jbuild, rounds, n_bits, _, _ = GATES[gate]
    return (mod.build_air(n_bits, build(rounds), PACK, LIMB_BITS),
            jmod.build_air(n_bits, jbuild(rounds), PACK, LIMB_BITS))


def _assert_air_equal(air, jair):
    assert air.name == jair.name
    assert air.cm_names == jair.cm_names
    assert air.const_names == jair.const_names
    for tc, jc in zip(air.const_values, jair.const_values, strict=True):
        assert tc.dtype == jc.dtype
        np.testing.assert_array_equal(tc, jc)
    assert [repr(c) for c in air.constraints] == \
        [repr(c) for c in jair.constraints]
    for kind in ("lookups", "permutations", "connections"):
        assert repr(getattr(air, kind)) == repr(getattr(jair, kind))


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_sm_air_and_sigmas_match_jax(gate):
    _assert_air_equal(*_gate_air(gate))
    mod, jmod, build, jbuild, rounds, n_bits, _, _ = GATES[gate]
    for s, js in zip(keccak_f.build_sigmas(build(rounds), n_bits),
                     jkeccak_f.build_sigmas(jbuild(rounds), n_bits),
                     strict=True):
        np.testing.assert_array_equal(s, js)


def _gate_actions(gate, count, seed):
    rng = np.random.default_rng(seed)
    if gate == "keccak_f":
        return [{"state": rng.integers(0, M64, 25, dtype=np.uint64)}
                for _ in range(count)]
    return [{"state": rng.integers(0, 1 << 32, 8, dtype=np.uint64),
             "block": rng.integers(0, 1 << 32, 16, dtype=np.uint64)}
            for _ in range(count)]


@functools.lru_cache(maxsize=None)
def _gate_traces(gate):
    mod, jmod, build, jbuild, rounds, n_bits, _, _ = GATES[gate]
    # keccak: one more than a slot holds, into the second slot
    acts = _gate_actions(gate, PACK + 1 if gate == "keccak_f" else 3, 5)
    return (mod.execute(acts, n_bits, build(rounds), PACK, LIMB_BITS),
            jmod.execute(acts, n_bits, jbuild(rounds), PACK, LIMB_BITS),
            acts)


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_sm_trace_and_digests_match_jax(gate):
    trace, jtrace, acts = _gate_traces(gate)
    np.testing.assert_array_equal(trace, jtrace)
    mod, jmod, build, jbuild, rounds, *_ = GATES[gate]
    np.testing.assert_array_equal(mod.digests(build(rounds), acts, PACK),
                                  jmod.digests(jbuild(rounds), acts, PACK))


@pytest.mark.parametrize("name", sorted(PADDING))
def test_padding_sm_air_matches_jax(name):
    mod, jmod, _, n_bits = PADDING[name]
    assert mod.COLS == jmod.COLS
    _assert_air_equal(mod.build_air(n_bits), jmod.build_air(n_bits))


def _execute(mod, msgs, n_bits, **kw):
    if mod is padding_sha256:
        kw["device"] = "cpu"
    return mod.execute(msgs, n_bits, **kw)


@functools.lru_cache(maxsize=None)
def _padding(name, n_active=None):
    mod, jmod, msgs, n_bits = PADDING[name]
    return (_execute(mod, msgs, n_bits, n_active=n_active),
            jmod.execute(msgs, n_bits, n_active=n_active))


@pytest.mark.parametrize("name,n_active", [(n, None) for n in PADDING]
                         + [("padding_kk", 7), ("padding_sha256", 9)])
def test_padding_sm_execute_matches_jax(name, n_active):
    (trace, emitted, digests), (jtrace, jemitted, jdigests) = _padding(
        name, n_active)
    np.testing.assert_array_equal(trace, jtrace)
    assert digests == jdigests
    assert len(emitted) == len(jemitted)
    for a, b in zip(emitted, jemitted):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k], dtype=np.uint64),
                                          np.asarray(b[k], dtype=np.uint64))
    mod, jmod, msgs, n_bits = PADDING[name]
    for m, d in zip(msgs, digests):
        assert d == mod.digest_of(m["data"]) == jmod.digest_of(m["data"])


def test_padding_stream_plans_match_jax():
    for length in (0, 1, 31, 32, 33, 100):
        assert padding_stream.default_reads(length) == \
            jpadding_stream.default_reads(length)
        assert padding_stream.chunk_plan(length, None) == \
            jpadding_stream.chunk_plan(length, None)
    reads = {0: 32, 32: 5, 37: 3}
    assert padding_stream.chunk_plan(40, reads) == \
        jpadding_stream.chunk_plan(40, reads)
    assert padding_stream.BIND_COLS == jpadding_stream.BIND_COLS
    with pytest.raises(AssertionError, match="tiling"):
        padding_stream.chunk_plan(40, {0: 32, 33: 7})


# hash_bit / bits2field: layout -> (port layout, JAX layout, port padding,
# JAX padding, messages, rounds of the circuit)
LAYOUTS = {"keccak": (hash_bit.keccak_layout, jhash_bit.keccak_layout,
                      padding_kk, jpadding_kk, KECCAK_MSGS, 1),
           "sha256": (hash_bit.sha256_layout, jhash_bit.sha256_layout,
                      padding_sha256, jpadding_sha256, SHA_MSGS, 1)}
BIT_BITS = 14     # the hash_bit / bits2field domain of these tests
ACTIVE = 8        # blocks bound into the pipeline: two gate slots of PACK


@functools.lru_cache(maxsize=None)
def _bits(kind):
    """HashBit of the padding SM's ACTIVE blocks through the reduced
    circuit, in both packages."""
    lay_fn, jlay_fn, mod, jmod, msgs, rounds = LAYOUTS[kind]
    circ, jcirc = _circuits(kind, rounds)
    lay, jlay = lay_fn(), jlay_fn()
    _, blocks = mod.layout(msgs, 11, ACTIVE)
    _, jblocks = jmod.layout(msgs, 11, ACTIVE)
    return (lay, jlay, blocks, jblocks,
            hash_bit.execute(blocks, BIT_BITS, lay,
                             hash_bit.circuit_perm_bits(circ)),
            jhash_bit.execute(jblocks, BIT_BITS, jlay,
                              jhash_bit.circuit_perm_bits(jcirc)))


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_hash_bit_matches_jax(kind):
    lay, jlay, blocks, jblocks, out, jout = _bits(kind)
    for field in ("name", "n_pos", "out_bits", "byte_idx", "byte_w",
                  "sprev_mask", "iv_bit", "obyte_idx", "obyte_w", "dg_limb",
                  "dg_w", "n_stream_bytes"):
        np.testing.assert_array_equal(getattr(lay, field),
                                      getattr(jlay, field))
    assert lay.xor_absorb() == jlay.xor_absorb()
    assert [(bytes(b["bytes"]), b["first"]) for b in blocks] == \
        [(bytes(b["bytes"]), b["first"]) for b in jblocks]
    (trace, dlimbs, bits), (jtrace, jdlimbs, jbits) = out, jout
    np.testing.assert_array_equal(trace, jtrace)
    assert dlimbs == jdlimbs
    assert [(list(map(int, s)), list(map(int, o))) for s, o in bits] == \
        [(list(map(int, s)), list(map(int, o))) for s, o in jbits]
    _assert_air_equal(hash_bit.build_air(BIT_BITS, lay, ACTIVE),
                      jhash_bit.build_air(BIT_BITS, jlay, ACTIVE))


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_bits2field_matches_jax(kind):
    lay, _, _, _, (_, _, bits), (_, _, jbits) = _bits(kind)
    assert bits2field.COLS == jbits2field.COLS
    assert bits2field.capacity_slots(BIT_BITS, lay.n_pos, PACK) == \
        jbits2field.capacity_slots(BIT_BITS, lay.n_pos, PACK)
    slots = ACTIVE // PACK
    np.testing.assert_array_equal(
        bits2field.execute(bits, BIT_BITS, lay.n_pos, lay.out_bits, PACK,
                           slots),
        jbits2field.execute(jbits, BIT_BITS, lay.n_pos, lay.out_bits, PACK,
                            slots))
    _assert_air_equal(
        bits2field.build_air(BIT_BITS, lay.n_pos, lay.out_bits, PACK, slots),
        jbits2field.build_air(BIT_BITS, lay.n_pos, lay.out_bits, PACK,
                              slots))


def test_executor_hash_actions_match_jax():
    kw = {"keccak": KECCAK_MSGS, "sha256": SHA_MSGS}
    n_bits = {"padding_kk": 10, "padding_sha256": 10}
    ex = Executor(n_bits=n_bits, device="cpu")
    traces = ex.execute(BatchActions(**kw))
    jtraces = JExecutor(n_bits=n_bits).execute(JActions(**kw))
    assert list(traces) == list(jtraces) == ["padding_kk", "padding_sha256"]
    for name in traces:
        np.testing.assert_array_equal(traces[name], jtraces[name])
    (_, emitted, digests), _ = _padding("padding_kk")
    assert len(ex.emitted["keccak_f"]) == len(emitted)
    assert ex.digests["padding_kk"] == digests
    counts = ex.counters(BatchActions(**kw))
    assert counts["padding_kk"] == 1 + 2 + 1 + 1 + 1
    assert counts["padding_kk_capacity"] == 1024 // 136
    assert counts["padding_sha256"] == 1 + 2 + 1 + 2 + 2
    assert counts["padding_sha256_capacity"] == 1024 // 64


# the gate SMs' forgeries are checked on one slot of the small hash batch's
# circuits: (rounds, log2 rows)
CHECKED = {"keccak_f": (1, 13), "sha256_f": (1, 12)}


@functools.lru_cache(maxsize=None)
def _checked(gate):
    """Honest trace and provers of a gate SM on one slot of CHECKED."""
    mod, jmod, build, jbuild, _, _, _, _ = GATES[gate]
    rounds, n_bits = CHECKED[gate]
    trace = mod.execute(_gate_actions(gate, PACK, 6), n_bits, build(rounds),
                        PACK, LIMB_BITS)
    air = mod.build_air(n_bits, build(rounds), PACK, LIMB_BITS)
    jair = jmod.build_air(n_bits, jbuild(rounds), PACK, LIMB_BITS)
    return (trace,
            StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                        device="cpu"),
            JProver(JSetup(jair, n_queries=8, fri_fold_bits=2)))


@functools.lru_cache(maxsize=None)
def _provers(name):
    if name in GATES:
        return _checked(name)[1:]
    mod, jmod, _, n_bits = PADDING[name]
    air, jair = mod.build_air(n_bits), jmod.build_air(n_bits)
    return (StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                        device="cpu"),
            JProver(JSetup(jair, n_queries=8, fri_fold_bits=2)))


def _tampered(name, trace):
    """The JAX tests' forgeries: a gate's c limb flipped (gate semantics),
    a gate's a and c limbs flipped together (the wire graph), non-zero
    filler in a pad region, a lie in the SHA-256 length suffix."""
    t = trace.copy()
    m = keccak_f._limbs(PACK, LIMB_BITS)
    if name == "keccak_f":
        t[2000, 2 * m] ^= np.uint64(1)
        t2 = trace.copy()
        t2[2001, 0] ^= np.uint64(1)
        t2[2001, 2 * m] ^= np.uint64(1)
        return [t, t2]
    if name == "sha256_f":
        circ = _circuits("sha256", CHECKED[name][0])[0]
        t[int(np.nonzero(circ.ops == kc.AND)[0][0]), 2 * m] ^= np.uint64(1)
        return [t]
    ci = {nm: i for i, nm in enumerate(PADDING[name][0].COLS)}
    pad_rows = np.nonzero((t[:, ci["PAD"]] == 1) & (t[:, ci["PADFIRST"]] == 0)
                          & (t[:, ci["BYTE"]] == 0))[0]
    t[int(pad_rows[0]), ci["BYTE"]] = np.uint64(0xFF)
    if name == "padding_kk":
        return [t]
    t2 = trace.copy()
    r = int(np.nonzero((t2[:, ci["LASTH"]] == 1)
                       & (t2[:, ci["LENACC"]] > 0))[0][-1])
    t2[r, ci["LENACC"]] += np.uint64(8)
    t2[r, ci["BYTE"]] += np.uint64(1)
    return [t, t2]


@pytest.mark.parametrize("name", ["padding_kk", "padding_sha256",
                                  "keccak_f", "sha256_f"])
def test_check_constraints_matches_jax(name):
    trace = _checked(name)[0] if name in GATES else _padding(name)[0][0]
    prover, jprover = _provers(name)
    assert prover.check_constraints(trace, quick=True) == []
    for bad in _tampered(name, trace):
        violated = prover.check_constraints(bad, quick=True)
        assert violated != []
        assert violated == jprover.check_constraints(bad, quick=True)


def test_hash_batch_closes_on_the_gate_capacities():
    """The full-width hash batch (proved on the card): its messages fill
    KeccakF's 520 permutations and Sha256F's 1,320 compressions as far as
    whole messages go, and each padding SM gets the smallest power of two
    that holds its blocks."""
    from zkevm_prover_tpu_torch.executor import examples

    batch = examples.hash_batch()
    assert batch.gates == {
        "keccak_f": {"rounds": 24, "pack": 40, "limb_bits": 10},
        "sha256_f": {"rounds": 64, "pack": 40, "limb_bits": 10}}
    ex = Executor(n_bits=batch.n_bits, gates=batch.gates, device="cpu")
    assert (ex.gate_capacity("keccak_f"),
            ex.gate_capacity("sha256_f")) == (520, 1320)
    counts = ex.counters(batch.actions())
    for pad, gate, slack in (("padding_kk", "keccak_f", 0),
                             ("padding_sha256", "sha256_f", 2)):
        assert counts[pad] == ex.gate_capacity(gate) - slack
        bits = batch.n_bits[pad]
        assert counts[pad] <= counts[f"{pad}_capacity"]
        mod = PADDING[pad][0]
        assert (1 << (bits - 1)) // mod.BLOCK < counts[pad]
    lengths = [len(m["data"]) for m in batch.keccak]
    assert min(lengths) >= 32 and max(lengths) <= 8192
    assert all(32 <= len(m["data"]) <= 512 for m in batch.sha256)
