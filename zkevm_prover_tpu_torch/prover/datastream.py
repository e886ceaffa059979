"""DataStream parser — reconstruct a batch from the sequencer stream.

Port of `zkevm_prover_tpu/prover/datastream.py`: a host copy, the same
parser and encoder.

Reference: src/prover/data_stream.cpp (dataStream2batch /
dataStreamBatch2batchL2Data): the stream is a sequence of framed entries
(packetType u8, length u32BE, type u32BE, number u64BE, payload); entry
types are bookmarks (skipped), start-L2-block, L2 transaction, and
end-L2-block. `batch_to_l2_data` re-encodes the parsed batch into the
batchL2Data byte stream the ROM consumes (0x0b changeL2Block markers,
delta timestamp, L1 info tree index, then each transaction's RLP with its
gas-price percentage suffix).
"""

from __future__ import annotations

import dataclasses


class DataStreamError(Exception):
    pass


@dataclasses.dataclass
class DataStreamTx:
    gas_price_percentage: int
    is_valid: int
    state_root: bytes
    encoded_tx: bytes


@dataclasses.dataclass
class DataStreamBlock:
    block_number: int
    timestamp: int
    delta_timestamp: int
    l1_info_tree_index: int
    l1_block_hash: bytes
    global_exit_root: bytes
    coinbase: bytes
    fork_id: int
    chain_id: int
    txs: list = dataclasses.field(default_factory=list)
    l2_block_hash: bytes = b""
    state_root: bytes = b""


@dataclasses.dataclass
class DataStreamBatch:
    batch_number: int = 0
    fork_id: int = 0
    chain_id: int = 0
    blocks: list = dataclasses.field(default_factory=list)


PACKET_PADDING = 0
PACKET_DATA = 2
ENTRY_BOOKMARK = 0xB0
ENTRY_START_L2_BLOCK = 1
ENTRY_L2_TX = 2
ENTRY_END_L2_BLOCK = 3


def parse(stream: bytes) -> DataStreamBatch:
    """dataStream2batch: frame and assemble the batch with the reference's
    consistency rules (consecutive block numbers, one fork/chain id)."""
    batch = DataStreamBatch()
    p = 0
    n = len(stream)
    while p < n:
        packet_type = stream[p]
        p += 1
        if p + 4 > n:
            raise DataStreamError("truncated length")
        length = int.from_bytes(stream[p:p + 4], "big")
        p += 4
        if length < 17:
            raise DataStreamError(f"entry length {length} < 17")
        entry_type = int.from_bytes(stream[p:p + 4], "big")
        p += 4
        p += 8  # entry number
        data_len = length - 17
        if p + data_len > n:
            raise DataStreamError("truncated entry data")
        payload = stream[p:p + data_len]
        p += data_len

        if packet_type == PACKET_PADDING:
            continue
        if packet_type != PACKET_DATA:
            raise DataStreamError(f"unsupported packet type {packet_type}")
        if entry_type == ENTRY_BOOKMARK:
            continue
        if entry_type == ENTRY_START_L2_BLOCK:
            q = 0
            batch_number = int.from_bytes(payload[q:q + 8], "big"); q += 8
            block = DataStreamBlock(
                block_number=int.from_bytes(payload[q:q + 8], "big"),
                timestamp=int.from_bytes(payload[q + 8:q + 16], "big"),
                delta_timestamp=int.from_bytes(payload[q + 16:q + 20], "big"),
                l1_info_tree_index=int.from_bytes(payload[q + 20:q + 24],
                                                  "big"),
                l1_block_hash=payload[q + 24:q + 56],
                global_exit_root=payload[q + 56:q + 88],
                coinbase=payload[q + 88:q + 108],
                fork_id=int.from_bytes(payload[q + 108:q + 110], "big"),
                chain_id=int.from_bytes(payload[q + 110:q + 114], "big"),
            )
            if block.block_number == 0 or block.fork_id == 0:
                raise DataStreamError("invalid start-block fields")
            if not batch.blocks:
                batch.batch_number = batch_number
                batch.fork_id = block.fork_id
                batch.chain_id = block.chain_id
            else:
                if block.fork_id != batch.fork_id:
                    raise DataStreamError("fork id changed mid-batch")
                if block.chain_id != batch.chain_id:
                    raise DataStreamError("chain id changed mid-batch")
                if block.block_number != batch.blocks[-1].block_number + 1:
                    raise DataStreamError("non-consecutive block numbers")
            batch.blocks.append(block)
        elif entry_type == ENTRY_L2_TX:
            if not batch.blocks:
                raise DataStreamError("transaction before any block")
            q = 0
            gpp = payload[q]; q += 1
            is_valid = payload[q]; q += 1
            state_root = payload[q:q + 32]; q += 32
            tx_len = int.from_bytes(payload[q:q + 4], "big"); q += 4
            if q + tx_len > len(payload):
                raise DataStreamError("truncated transaction")
            batch.blocks[-1].txs.append(DataStreamTx(
                gas_price_percentage=gpp, is_valid=is_valid,
                state_root=state_root,
                encoded_tx=payload[q:q + tx_len]))
        elif entry_type == ENTRY_END_L2_BLOCK:
            if not batch.blocks:
                raise DataStreamError("end-block before any block")
            q = 0
            bn = int.from_bytes(payload[q:q + 8], "big"); q += 8
            if bn != batch.blocks[-1].block_number:
                raise DataStreamError("end-block number mismatch")
            batch.blocks[-1].l2_block_hash = payload[q:q + 32]
            batch.blocks[-1].state_root = payload[q + 32:q + 64]
        else:
            raise DataStreamError(f"unsupported entry type {entry_type}")
    return batch


def batch_to_l2_data(batch: DataStreamBatch) -> bytes:
    """dataStreamBatch2batchL2Data: the ROM-facing byte stream — one
    0x0b changeL2Block marker per block (delta timestamp u32, L1 info
    index u32), then each tx's RLP followed by its gas-price percentage."""
    out = bytearray()
    for block in batch.blocks:
        out.append(0x0B)
        out += block.delta_timestamp.to_bytes(4, "big")
        out += block.l1_info_tree_index.to_bytes(4, "big")
        for tx in block.txs:
            out += tx.encoded_tx
            out.append(tx.gas_price_percentage)
    return bytes(out)


# -- encoder (tests / local streams) ----------------------------------------


def _entry(entry_type: int, number: int, payload: bytes) -> bytes:
    return (bytes([PACKET_DATA])
            + (17 + len(payload)).to_bytes(4, "big")
            + entry_type.to_bytes(4, "big")
            + number.to_bytes(8, "big") + payload)


def encode(batch: DataStreamBatch) -> bytes:
    """Inverse of parse() (reference streams come from the sequencer; this
    serves tests and local tooling)."""
    out = bytearray()
    num = 0
    for block in batch.blocks:
        payload = (batch.batch_number.to_bytes(8, "big")
                   + block.block_number.to_bytes(8, "big")
                   + block.timestamp.to_bytes(8, "big")
                   + block.delta_timestamp.to_bytes(4, "big")
                   + block.l1_info_tree_index.to_bytes(4, "big")
                   + block.l1_block_hash.ljust(32, b"\0")
                   + block.global_exit_root.ljust(32, b"\0")
                   + block.coinbase.ljust(20, b"\0")
                   + block.fork_id.to_bytes(2, "big")
                   + block.chain_id.to_bytes(4, "big"))
        out += _entry(ENTRY_START_L2_BLOCK, num, payload)
        num += 1
        for tx in block.txs:
            payload = (bytes([tx.gas_price_percentage, tx.is_valid])
                       + tx.state_root.ljust(32, b"\0")
                       + len(tx.encoded_tx).to_bytes(4, "big")
                       + tx.encoded_tx)
            out += _entry(ENTRY_L2_TX, num, payload)
            num += 1
        payload = (block.block_number.to_bytes(8, "big")
                   + block.l2_block_hash.ljust(32, b"\0")
                   + block.state_root.ljust(32, b"\0"))
        out += _entry(ENTRY_END_L2_BLOCK, num, payload)
        num += 1
    return bytes(out)
