"""The port's witness and datastream parsers (`prover/witness.py`,
`prover/datastream.py`) against the JAX package's: the twins of
tests/test_parsers.py. The same state encodes to the same witness bytes,
each package's parser rebuilds the same root and nodes from them, and the
port's round-trips against its own `Smt`; the same batch encodes to the
same stream and batchL2Data bytes, and both parsers reject the same
inconsistencies with the same messages."""

import dataclasses

import pytest

from zkevm_prover_tpu.hashdb.database import Database as JDatabase
from zkevm_prover_tpu.hashdb.smt import Smt as JSmt
from zkevm_prover_tpu.prover import datastream as jdatastream
from zkevm_prover_tpu.prover import witness as jwitness
from zkevm_prover_tpu_torch.hashdb import Database, Smt
from zkevm_prover_tpu_torch.prover import datastream, witness

# (node type, address, storage key, value): balance, nonce, a storage slot
# and a second account's balance (tests/test_parsers.py), and a value
# above 2^64 (a CBOR byte string)
LEAVES = ((0, 0xAABB, 0, 111), (1, 0xAABB, 0, 5), (3, 0xAABB, 0x77, 999),
          (0, 0xCCDD, 0, 42), (3, 0xCCDD, 0x1234, (1 << 100) + 7))


def _state(port: bool):
    """The LEAVES set one by one into an empty tree: (smt, root, leaves by
    key) in the port's or the JAX package's hashdb."""
    mod = witness if port else jwitness
    smt = Smt(Database()) if port else JSmt(JDatabase())
    root = (0, 0, 0, 0)
    by_key = {}
    for node_type, address, skey, value in LEAVES:
        key = mod._leaf_key(mod._Ctx(b"", smt), node_type, address, skey)
        root = smt.set(root, key, value).new_root
        by_key[key] = (node_type, address, skey, value)
    return smt, tuple(int(v) for v in root), by_key


@pytest.mark.parametrize("semantic", (False, True),
                         ids=("hash_placeholders", "leaf_records"))
def test_db_to_witness_bytes_match_jax(semantic):
    smt, root, leaves = _state(True)
    jsmt, jroot, jleaves = _state(False)
    assert root == jroot and list(leaves) == list(jleaves)
    blob = witness.db_to_witness(smt.db, root,
                                 leaves=leaves if semantic else None)
    assert blob == jwitness.db_to_witness(
        jsmt.db, jroot, leaves=jleaves if semantic else None)
    # each package's parser rebuilds the same root, nodes and programs
    db, got_root, programs = witness.witness_to_db(blob)
    jdb, jgot_root, jprograms = jwitness.witness_to_db(blob)
    assert got_root == jgot_root == root
    assert db._nodes == jdb._nodes and programs == jprograms == {}


def test_witness_roundtrip_against_smt():
    smt, root, leaves = _state(True)
    blob = witness.db_to_witness(smt.db, root, leaves=leaves)
    db, root2, _ = witness.witness_to_db(blob)
    assert root2 == root
    # the leaf records carry their semantics: every value reads back
    for key, (_, _, _, value) in leaves.items():
        assert Smt(db).get(root2, key).value == value
    # one direct SMT_LEAF record (tests/test_parsers.py)
    leaf_blob = (b"\x01\x07\x00" + witness._enc_major(0, 0xAABB)
                 + witness._enc_major(0, 111))
    db3, root3, _ = witness.witness_to_db(leaf_blob)
    key = witness._leaf_key(witness._Ctx(b"", Smt(Database())), 0, 0xAABB, 0)
    direct = Smt(Database()).set((0, 0, 0, 0), key, 111).new_root
    assert root3 == tuple(int(v) for v in direct)
    assert Smt(db3).get(root3, key).value == 111
    assert jwitness.witness_to_db(leaf_blob)[1] == root3


def test_witness_code_blob_matches_jax():
    code = bytes(range(40))
    blob = (b"\x01\x04" + witness._cbor_enc_bytes(code) + b"\x07\x00"
            + witness._enc_major(0, 0xAABB) + witness._enc_major(0, 1))
    _, root, programs = witness.witness_to_db(blob)
    _, jroot, jprograms = jwitness.witness_to_db(blob)
    assert root == jroot and programs == jprograms and len(programs) == 1


@pytest.mark.parametrize("blob", (b"", b"\x02\x07", b"\x01\x09",
                                  b"\x01\x02", b"\x01\x07\x00\x19\x01",
                                  b"\x01\x07\x00\x1c"),
                         ids=("empty", "header", "opcode", "out_of_data",
                              "short_uint", "cbor_info"))
def test_witness_rejections_match_jax(blob):
    with pytest.raises(witness.WitnessError) as mine:
        witness.witness_to_db(blob)
    with pytest.raises(jwitness.WitnessError) as theirs:
        jwitness.witness_to_db(blob)
    assert str(mine.value) == str(theirs.value)


def _batch(mod, numbers=(100, 101), fork_ids=(9, 9), chain_ids=(1101, 1101)):
    """tests/test_parsers.py's two-block batch in `mod`'s classes."""
    batch = mod.DataStreamBatch(batch_number=7, fork_id=9, chain_id=1101)
    for i, (num, fork, chain) in enumerate(zip(numbers, fork_ids,
                                               chain_ids)):
        block = mod.DataStreamBlock(
            block_number=num, timestamp=1700000000 + 12 * i,
            delta_timestamp=12, l1_info_tree_index=3 + i,
            l1_block_hash=bytes([0x11 + i]) * 32,
            global_exit_root=b"\x22" * 32, coinbase=b"\x33" * 20,
            fork_id=fork, chain_id=chain, l2_block_hash=b"\x88" * 32,
            state_root=b"\x99" * 32)
        block.txs.append(mod.DataStreamTx(
            gas_price_percentage=255 - i, is_valid=1,
            state_root=b"\x44" * 32,
            encoded_tx=b"\xf8\x65" + bytes([0x55 + i]) * 10))
        batch.blocks.append(block)
    return batch


def test_datastream_matches_jax():
    stream = datastream.encode(_batch(datastream))
    assert stream == jdatastream.encode(_batch(jdatastream))
    parsed, jparsed = datastream.parse(stream), jdatastream.parse(stream)
    assert dataclasses.asdict(parsed) == dataclasses.asdict(jparsed)
    assert parsed.batch_number == 7 and parsed.fork_id == 9
    assert [b.block_number for b in parsed.blocks] == [100, 101]
    l2 = datastream.batch_to_l2_data(parsed)
    assert l2 == jdatastream.batch_to_l2_data(jparsed)
    assert l2[0] == 0x0B and l2[1:5] == (12).to_bytes(4, "big")
    # bookmarks and padding packets are skipped alike
    extra = datastream._entry(datastream.ENTRY_BOOKMARK, 0, b"\x01" * 9)
    padding = bytes([datastream.PACKET_PADDING]) + extra[1:]
    again = datastream.parse(extra + padding + stream)
    assert dataclasses.asdict(again) == dataclasses.asdict(parsed)


def _stream(mod, **kw) -> bytes:
    return mod.encode(_batch(mod, **kw))


CORRUPT = {
    "non_consecutive": lambda mod: _stream(mod, numbers=(5, 9)),
    "fork_change": lambda mod: _stream(mod, fork_ids=(9, 8)),
    "chain_change": lambda mod: _stream(mod, chain_ids=(1101, 1)),
    "zero_block": lambda mod: _stream(mod, numbers=(0, 1)),
    "truncated": lambda mod: _stream(mod)[:-5],
    "short_length": lambda mod: b"\x02" + (16).to_bytes(4, "big") + bytes(20),
    "packet_type": lambda mod: b"\x07" + _stream(mod)[1:],
    "tx_first": lambda mod: mod._entry(mod.ENTRY_L2_TX, 0, bytes(40)),
    "end_first": lambda mod: mod._entry(mod.ENTRY_END_L2_BLOCK, 0,
                                        bytes(72)),
    "entry_type": lambda mod: mod._entry(9, 0, b""),
}


@pytest.mark.parametrize("make", list(CORRUPT))
def test_datastream_rejections_match_jax(make):
    stream = CORRUPT[make](datastream)
    assert stream == CORRUPT[make](jdatastream)
    with pytest.raises(datastream.DataStreamError) as mine:
        datastream.parse(stream)
    with pytest.raises(jdatastream.DataStreamError) as theirs:
        jdatastream.parse(stream)
    assert str(mine.value) == str(theirs.value)
