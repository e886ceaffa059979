"""FullTracer — EVM-level trace collection driven by ROM events.

Port of `zkevm_prover_tpu/executor/full_tracer.py`: a host copy, the same
tracer (on the port's host `keccak256`).

The reference zkROM fires `eventLog` free-input commands at protocol
boundaries (batch/block/tx start+finish, per-opcode, storage updates,
log stores, errors); the executor's FullTracer consumes them to build
the block/tx/log response payloads every ProcessBatch RPC returns
(reference: src/main_sm/fork_9/main/full_tracer.cpp, 2.4k LoC, and the
response classes in src/prover/full_tracer_interface.hpp).

This is the TPU-native counterpart: tracing is sequential, data-dependent
bookkeeping, so it stays host-side Python (the reference keeps it on the
CPU beside the interpreter for the same reason) and reads the interpreter
state through the same surfaces eval_command uses — registers, the ctx
memory dict, and the ROM's variable offset map (rom.memory_map, built
from each line's offsetLabel like the reference's Rom::getMemoryOffset,
rom.cpp:32-81).

Event routing parity (full_tracer.cpp:319-387):
  * `eventLog(onError, <tag>)`, `(onProcessTx)`, `(onFinishTx)`,
    `(onStartBlock)`, `(onFinishBlock)`, `(onStartBatch, C)`,
    `(onFinishBatch)` — varName-tagged lifecycle events;
  * `eventLog(onOpcode(RR))` / `eventLog(onUpdateStorage(C, D|E))` —
    nested functionCall events, consumed un-evaluated;
  * `storeLog(B, isTopic, A|C)` — a sibling functionCall routed to the
    tracer (full_tracer.cpp:321-325).
"""

from __future__ import annotations

import dataclasses
import time

from ..ops import keccak as keccak_mod

CTX_OFFSET = 0x40000   # main_executor.cpp address-space layout
STACK_OFFSET = 0x10000
MEM_OFFSET = 0x20000

MASK32 = 0xFFFFFFFF

# SMT leaf key types (full_tracer.cpp:2162-2166)
SMT_KEY_BALANCE = 0
SMT_KEY_NONCE = 1
SMT_KEY_SC_CODE = 2
SMT_KEY_SC_STORAGE = 3
SMT_KEY_SC_LENGTH = 4

# ---------------------------------------------------------------------------
# opcode table (opcode_name.cpp — standard EVM names/base gas; undefined
# slots resolve to INVALID=0xfe; 0xff is the zkEVM's SENDALL)
# ---------------------------------------------------------------------------

_SIMPLE_OPS = {
    0x00: ("STOP", 0), 0x01: ("ADD", 3), 0x02: ("MUL", 5), 0x03: ("SUB", 3),
    0x04: ("DIV", 5), 0x05: ("SDIV", 5), 0x06: ("MOD", 5), 0x07: ("SMOD", 5),
    0x08: ("ADDMOD", 8), 0x09: ("MULMOD", 8), 0x0A: ("EXP", 10),
    0x0B: ("SIGNEXTEND", 5),
    0x10: ("LT", 3), 0x11: ("GT", 3), 0x12: ("SLT", 3), 0x13: ("SGT", 3),
    0x14: ("EQ", 3), 0x15: ("ISZERO", 3), 0x16: ("AND", 3), 0x17: ("OR", 3),
    0x18: ("XOR", 3), 0x19: ("NOT", 3), 0x1A: ("BYTE", 3), 0x1B: ("SHL", 3),
    0x1C: ("SHR", 3), 0x1D: ("SAR", 3),
    0x20: ("SHA3", 30),
    0x30: ("ADDRESS", 2), 0x31: ("BALANCE", 100), 0x32: ("ORIGIN", 2),
    0x33: ("CALLER", 2), 0x34: ("CALLVALUE", 2), 0x35: ("CALLDATALOAD", 3),
    0x36: ("CALLDATASIZE", 2), 0x37: ("CALLDATACOPY", 3),
    0x38: ("CODESIZE", 2), 0x39: ("CODECOPY", 3), 0x3A: ("GASPRICE", 2),
    0x3B: ("EXTCODESIZE", 100), 0x3C: ("EXTCODECOPY", 100),
    0x3D: ("RETURNDATASIZE", 2), 0x3E: ("RETURNDATACOPY", 3),
    0x3F: ("EXTCODEHASH", 100),
    0x40: ("BLOCKHASH", 20), 0x41: ("COINBASE", 2), 0x42: ("TIMESTAMP", 2),
    0x43: ("NUMBER", 2), 0x44: ("DIFFICULTY", 2), 0x45: ("GASLIMIT", 2),
    0x46: ("CHAINID", 2), 0x47: ("SELFBALANCE", 5), 0x48: ("BASEFEE", 2),
    0x50: ("POP", 2), 0x51: ("MLOAD", 3), 0x52: ("MSTORE", 3),
    0x53: ("MSTORE8", 3), 0x54: ("SLOAD", 100), 0x55: ("SSTORE", 100),
    0x56: ("JUMP", 8), 0x57: ("JUMPI", 10), 0x58: ("PC", 2),
    0x59: ("MSIZE", 2), 0x5A: ("GAS", 2), 0x5B: ("JUMPDEST", 1),
    0x5F: ("PUSH0", 3),
    0xF0: ("CREATE", 32000), 0xF1: ("CALL", 100), 0xF2: ("CALLCODE", 100),
    0xF3: ("RETURN", 0), 0xF4: ("DELEGATECALL", 100),
    0xF5: ("CREATE2", 32000), 0xFA: ("STATICCALL", 100),
    0xFD: ("REVERT", 0), 0xFF: ("SENDALL", 5000),
}
_LOG_GAS = {0xA0 + n: (f"LOG{n}", 375 * (n + 1)) for n in range(5)}


def _build_opcode_table() -> dict:
    table = dict(_SIMPLE_OPS)
    table.update({0x60 + n: (f"PUSH{n + 1}", 3) for n in range(32)})
    table.update({0x80 + n: (f"DUP{n + 1}", 3) for n in range(16)})
    table.update({0x90 + n: (f"SWAP{n + 1}", 3) for n in range(16)})
    table.update(_LOG_GAS)
    return table


OPCODE_INFO = _build_opcode_table()


def opcode_name(code_id: int) -> tuple[int, str, int]:
    """(canonical op, name, base gas) for a raw code id; undefined slots
    are INVALID (opcode_name.cpp pads with {0xfe, "INVALID", 0})."""
    entry = OPCODE_INFO.get(code_id & 0xFF)
    if entry is None:
        return 0xFE, "INVALID", 0
    return code_id & 0xFF, entry[0], entry[1]


# opcode-name groups steering gas-cost attribution (full_tracer.cpp:23-44)
OP_INC_CONTEXT = {"CALL", "STATICCALL", "DELEGATECALL", "CALLCODE",
                  "CREATE", "CREATE2"}
OP_CALL = {"CALL", "STATICCALL", "DELEGATECALL", "CALLCODE"}
OP_CREATE = {"CREATE", "CREATE2"}
ZERO_COST_OP = {"STOP", "REVERT", "RETURN"}

# error classification sets (full_tracer.cpp:46-98)
OOC_ERRORS = {"OOCS", "OOCK", "OOCB", "OOCM", "OOCA", "OOCPA", "OOCPO"}
RESPONSE_ERRORS = OOC_ERRORS | {
    "OOCSH",
    "intrinsic_invalid_signature", "intrinsic_invalid_chain_id",
    "intrinsic_invalid_nonce", "intrinsic_invalid_gas_limit",
    "intrinsic_invalid_gas_overflow", "intrinsic_invalid_balance",
    "intrinsic_invalid_batch_gas_limit", "intrinsic_invalid_sender_code",
    "invalid_change_l2_block_limit_timestamp",
    "invalid_change_l2_block_min_timestamp",
    "invalidRLP", "invalidDecodeChangeL2Block",
    "invalidNotFirstTxChangeL2Block", "invalid_l1_info_tree_index"}
INVALID_BATCH_ERRORS = OOC_ERRORS | {
    "OOCSH",
    "invalid_change_l2_block_limit_timestamp",
    "invalid_change_l2_block_min_timestamp",
    "invalidRLP", "invalidDecodeChangeL2Block",
    "invalidNotFirstTxChangeL2Block", "invalid_l1_info_tree_index"}
CHANGE_BLOCK_ERRORS = {"invalid_change_l2_block_limit_timestamp",
                       "invalid_change_l2_block_min_timestamp",
                       "invalid_l1_info_tree_index"}


# ---------------------------------------------------------------------------
# response data structures (full_tracer_interface.hpp)
# ---------------------------------------------------------------------------


def _h(v: int, nibbles: int) -> str:
    return "0x" + format(v, "x").zfill(nibbles)


@dataclasses.dataclass
class TraceConfig:
    """Input traceConfig flags (trace_config.hpp:4-44; JSON keys parsed by
    Input::loadGlobals, input.cpp:549-590)."""

    enabled: bool = False
    disable_storage: bool = False
    disable_stack: bool = False
    enable_memory: bool = False
    enable_return_data: bool = False
    tx_hash_to_generate_full_trace: str = ""
    generate_full_trace: bool = True  # reference default (ctor :30)

    @property
    def generate_storage(self):
        return self.enabled and not self.disable_storage

    @property
    def generate_stack(self):
        return self.enabled and not self.disable_stack

    @property
    def generate_memory(self):
        return self.enabled and self.enable_memory

    @property
    def generate_return_data(self):
        return self.enabled and self.enable_return_data

    @classmethod
    def from_json(cls, d: dict | None) -> "TraceConfig":
        if not d:
            return cls()
        return cls(
            enabled=True,
            disable_storage=bool(d.get("disableStorage", False)),
            disable_stack=bool(d.get("disableStack", False)),
            enable_memory=bool(d.get("enableMemory", False)),
            enable_return_data=bool(d.get("enableReturnData", False)),
            tx_hash_to_generate_full_trace=str(
                d.get("txHashToGenerateFullTrace", "")),
        )


@dataclasses.dataclass
class OpcodeContract:
    address: str = ""
    caller: str = ""
    value: int = 0
    data: str = ""
    gas: int = 0
    type: str = ""


@dataclasses.dataclass
class OpcodeTrace:
    """One full-trace step (class Opcode, full_tracer_interface.hpp:26)."""

    gas: int = 0
    gas_cost: int = 0
    state_root: str = ""
    depth: int = 0
    pc: int = 0
    op: int = 0
    opcode: str = ""
    gas_refund: int = 0
    error: str = ""
    contract: OpcodeContract = dataclasses.field(default_factory=OpcodeContract)
    stack: list = dataclasses.field(default_factory=list)
    memory: str = ""
    memory_size: int = 0
    memory_offset: int = 0
    storage: dict = dataclasses.field(default_factory=dict)
    return_data: list = dataclasses.field(default_factory=list)
    start_time: float = 0.0
    duration: int = 0


@dataclasses.dataclass
class LogTrace:
    """class LogV2 (full_tracer_interface.hpp:64)."""

    address: str = ""
    block_number: int = 0
    block_hash: str = ""
    tx_hash: str = ""
    tx_hash_l2: str = ""
    tx_index: int = 0
    batch_hash: str = ""
    index: int = 0
    data: list = dataclasses.field(default_factory=list)
    topics: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TxContext:
    """class TxTraceContextV2 (full_tracer_interface.hpp:101)."""

    type: str = ""
    from_: str = ""
    to: str = ""
    data: str = ""
    gas: int = 0
    gas_used: int = 0
    value: int = 0
    output: str = ""
    gas_price: int = 0
    chain_id: int = 0
    old_state_root: str = ""
    execution_time: int = 0
    error: str = ""
    tx_index: int = 0


@dataclasses.dataclass
class TxResponse:
    """class ResponseV2 (full_tracer_interface.hpp:159)."""

    context: TxContext = dataclasses.field(default_factory=TxContext)
    steps: list = dataclasses.field(default_factory=list)   # [OpcodeTrace]
    tx_hash: str = ""
    tx_hash_l2: str = ""
    block_hash: str = ""
    block_number: int = 0
    rlp_tx: bytes = b""
    type: int = 0
    return_value: str = ""
    gas_left: int = 0
    gas_used: int = 0
    gas_refunded: int = 0
    cumulative_gas_used: int = 0
    error: str = ""
    create_address: str = ""
    state_root: str = ""
    logs: list = dataclasses.field(default_factory=list)
    effective_gas_price: str = ""
    effective_percentage: int = 0
    has_gasprice_opcode: bool = False
    has_balance_opcode: bool = False
    status: int = 0


@dataclasses.dataclass
class BlockResponse:
    """class Block (full_tracer_interface.hpp:201)."""

    parent_hash: str = ""
    coinbase: str = ""
    gas_limit: int = 0
    gas_used: int = 0
    block_hash: str = ""
    block_number: int = 0
    receipts_root: str = ""
    timestamp: int = 0
    ger: str = ""
    block_info_root: str = ""
    block_hash_l1: str = ""
    responses: list = dataclasses.field(default_factory=list)
    logs: list = dataclasses.field(default_factory=list)
    initialized: bool = False
    error: str = ""
    ctx: int = 0


@dataclasses.dataclass
class InfoReadWrite:
    """Per-address touched-state summary (full_tracer_interface.hpp:240)."""

    nonce: str = ""
    nonce_key: tuple = (0, 0, 0, 0)
    balance: str = ""
    balance_key: tuple = (0, 0, 0, 0)
    sc_code: str = ""
    sc_storage: dict = dataclasses.field(default_factory=dict)
    sc_length: str = ""


@dataclasses.dataclass
class FinalTrace:
    """class FinalTraceV2 (full_tracer_interface.hpp:223)."""

    initialized: bool = False
    new_state_root: str = ""
    new_acc_input_hash: str = ""
    new_local_exit_root: str = ""
    num_batch: int = 0
    cumulative_gas_used: int = 0
    gas_used: int = 0
    block_responses: list = dataclasses.field(default_factory=list)
    invalid_batch: bool = False
    error: str = ""


# ---------------------------------------------------------------------------
# rlp encoding for the legacy tx hash (full_tracer.cpp:268-313, rlp.hpp)
# ---------------------------------------------------------------------------


def _rlp_bytes(b: bytes) -> bytes:
    if len(b) == 1 and b[0] < 0x80:
        return b
    return _rlp_len(len(b), 0x80) + b


def _rlp_int(v: int) -> bytes:
    if v == 0:
        return b"\x80"
    return _rlp_bytes(v.to_bytes((v.bit_length() + 7) // 8, "big"))


def _rlp_len(n: int, base: int) -> bytes:
    if n < 56:
        return bytes([base + n])
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([base + 55 + len(nb)]) + nb


def legacy_tx_hash(to: str, value: int, nonce: int, gas_limit: int,
                   gas_price: int, data: str, r: int, s: int,
                   v: int) -> tuple[str, bytes]:
    """RLP-encode a signed legacy transaction and keccak it — the response
    tx_hash (getTransactionHash, full_tracer.cpp:268-313).  `to`/`data`
    are 0x-hex strings; empty `to` encodes as an empty byte string."""
    to_b = bytes.fromhex(to.removeprefix("0x")) if to.removeprefix("0x") \
        else b""
    payload = (_rlp_int(nonce) + _rlp_int(gas_price) + _rlp_int(gas_limit)
               + _rlp_bytes(to_b) + _rlp_int(value)
               + _rlp_bytes(bytes.fromhex(data.removeprefix("0x")))
               + _rlp_int(v) + _rlp_int(r) + _rlp_int(s))
    rlp_tx = _rlp_len(len(payload), 0xC0) + payload
    return "0x" + keccak_mod.keccak256(rlp_tx).hex(), rlp_tx


def string_increment(prev: bytes, cur: bytes) -> tuple[int, int]:
    """(offset, length) of the changed window between two byte strings —
    used for incremental memory traces (utils.cpp getStringIncrement)."""
    if prev == cur:
        return 0, 0
    first = 0
    limit = min(len(prev), len(cur))
    while first < limit and prev[first] == cur[first]:
        first += 1
    last = len(cur)
    if len(prev) == len(cur):
        while last > first and prev[last - 1] == cur[last - 1]:
            last -= 1
    return first, last - first


# ---------------------------------------------------------------------------
# interpreter-state accessors
# ---------------------------------------------------------------------------


def _fea8_scalar(fea8) -> int:
    out = 0
    for i, limb in enumerate(fea8):
        out |= (int(limb) & MASK32) << (32 * i)
    return out


class FullTracer:
    """Event-driven trace builder over the Main SM interpreter context.

    `rom` must expose `memory_map` (var name -> ctx-relative offset) and
    `constants` (for BLOCK_GAS_LIMIT).  The produced `final_trace` carries
    the block/tx/log payloads the executor service returns.
    """

    def __init__(self, rom, trace_config: TraceConfig | None = None,
                 no_counters: bool = False,
                 skip_first_change_l2_block: bool = False):
        self.rom = rom
        self.cfg = trace_config or TraceConfig()
        self.no_counters = no_counters
        self.skip_first_change_l2_block = skip_first_change_l2_block

        self.final_trace = FinalTrace()
        self.current_block = BlockResponse()
        self.full_trace: list[OpcodeTrace] = []   # steps of the current tx
        self.logs: dict[int, dict[int, LogTrace]] = {}  # CTX -> index -> log
        self.delta_storage: dict[str, dict[str, str]] = {}
        self.read_write_addresses: dict[str, InfoReadWrite] = {}
        self.call_data: dict[int, str] = {}       # CTX -> context type
        self.tx_gas: dict[int, dict] = {}         # depth -> {forwarded,remaining}
        self.depth = 1
        self.prev_ctx = 0
        self.tx_index = 0
        self.tx_time = 0.0
        self.acc_batch_gas = 0
        self.last_error = ""
        self.num_opcodes_in_tx = 0
        self.last_error_opcode = 0
        self.has_gasprice_opcode = False
        self.has_balance_opcode = False
        self.is_forced = False
        self.previous_memory = b""
        self.return_from_create: dict | None = None

    # -- ctx readers --------------------------------------------------------

    def _var(self, ctx, global_: bool, name: str, context: int | None = None):
        """getVarFromCtx (full_tracer.cpp:173-197): read the 256-bit ROM
        variable `name` from global (ctx 0) or per-context memory.
        Variables absent from the fork's ROM read as 0 — the reference
        getVarFromCtx returns 0 when the label is missing (older forks
        lack etrog-era vars like isForced/blockInfoRoot)."""
        off = self.rom.memory_map.get(name)
        if off is None:
            return 0
        if global_:
            base = 0
        else:
            base = (context if context is not None
                    else ctx.scal["CTX"]) * CTX_OFFSET
        return ctx.get_mem_raw(base + off)

    @staticmethod
    def _sr(ctx) -> int:
        return _fea8_scalar(ctx.regs8["SR"])

    def _memory_bytes(self, ctx, offset: int, length: int,
                      context: int | None = None) -> bytes:
        """getFromMemory (full_tracer.cpp:105-170): byte range from the
        32-byte-word ctx memory region."""
        base = ((context if context is not None else ctx.scal["CTX"])
                * CTX_OFFSET + MEM_OFFSET)
        if length <= 0:
            return b""
        first_word, first_byte = divmod(offset, 32)
        out = bytearray()
        w = first_word
        while len(out) < first_byte + length:
            out += _fea8_scalar(ctx.mem.get(base + w, [0] * 8)
                                ).to_bytes(32, "big")
            w += 1
        return bytes(out[first_byte:first_byte + length])

    # -- event dispatch (handleEvent, full_tracer.cpp:319-387) --------------

    def handle_event(self, ctx, cmd: dict) -> None:
        p0 = cmd["params"][0]
        tag = p0.get("varName")
        if tag == "onError":
            self.on_error(ctx, cmd["params"][1]["varName"])
        elif tag == "onProcessTx":
            self.on_process_tx(ctx)
        elif tag == "onFinishTx":
            self.on_finish_tx(ctx)
        elif tag == "onStartBlock":
            self.on_start_block(ctx)
        elif tag == "onFinishBlock":
            self.on_finish_block(ctx)
        elif tag == "onStartBatch":
            self.on_start_batch(ctx)
        elif tag == "onFinishBatch":
            self.on_finish_batch(ctx)
        elif p0.get("op") == "functionCall" and p0["funcName"] == "onOpcode":
            self.on_opcode(ctx, p0["params"][0])
        elif p0.get("op") == "functionCall" and \
                p0["funcName"] == "onUpdateStorage":
            self.on_update_storage(ctx, p0["params"])
        else:
            raise ValueError(f"unknown eventLog tag {p0!r}")

    # -- lifecycle events ---------------------------------------------------

    def on_start_batch(self, ctx) -> None:
        """full_tracer.cpp:1378-1412."""
        if self.final_trace.initialized:
            return
        self.is_forced = bool(self._var(ctx, True, "isForced"))
        self.final_trace.block_responses = []
        self.final_trace.initialized = True

    def on_finish_batch(self, ctx) -> None:
        """full_tracer.cpp:1414-1470."""
        ft = self.final_trace
        ft.gas_used = self.acc_batch_gas
        ft.new_state_root = _h(self._sr(ctx), 64)
        ft.new_acc_input_hash = _h(
            self._var(ctx, True, "newAccInputHash"), 64)
        ft.new_local_exit_root = _h(
            self._var(ctx, True, "newLocalExitRoot"), 64)

    def on_start_block(self, ctx) -> None:
        """full_tracer.cpp:611-686."""
        blk = self.current_block = BlockResponse()
        block_number = self._var(ctx, True, "blockNum")
        if not self.skip_first_change_l2_block:
            block_number += 1  # var not yet updated at this point (:636-639)
        blk.block_number = block_number
        blk.coinbase = _h(self._var(ctx, True, "sequencerAddr"), 40)
        const = self.rom.constants.get("BLOCK_GAS_LIMIT", {})
        blk.gas_limit = int(const.get("value", 2**50))
        blk.ctx = ctx.scal["CTX"]
        blk.initialized = True

    def on_finish_block(self, ctx) -> None:
        """full_tracer.cpp:692-829."""
        blk = self.current_block
        blk.ger = _h(self._var(ctx, False, "gerL1InfoTree",
                               context=blk.ctx), 64)
        blk.block_hash_l1 = _h(self._var(ctx, False, "blockHashL1InfoTree",
                                         context=blk.ctx), 64)
        blk.parent_hash = _h(self._var(ctx, True, "previousBlockHash"), 64)
        blk.block_number = self._var(ctx, True, "blockNum")
        blk.timestamp = self._var(ctx, True, "timestamp")
        blk.gas_used = self._var(ctx, True, "cumulativeGasUsed")
        blk.block_info_root = _h(self._var(ctx, True, "blockInfoSR"), 64)
        blk.block_hash = _h(self._sr(ctx), 64)

        # back-fill block hash/number into tx responses + order block logs
        blk.logs = []
        aux: dict[int, LogTrace] = {}
        for resp in blk.responses:
            resp.block_hash = blk.block_hash
            resp.block_number = blk.block_number
            for log in resp.logs:
                log.block_hash = blk.block_hash
                aux[log.index] = log
        blk.logs = [aux[i] for i in sorted(aux)]

        self.final_trace.block_responses.append(blk)
        blk.initialized = False
        self.logs.clear()

    def on_process_tx(self, ctx) -> None:
        """full_tracer.cpp:832-1094."""
        resp = TxResponse()
        c = resp.context
        self.tx_index = self._var(ctx, True, "txIndex")

        if self._var(ctx, False, "isCreateContract"):
            c.type = "CREATE"
            c.to = "0x"
        else:
            c.type = "CALL"
            c.to = _h(self._var(ctx, False, "txDestAddr"), 40)
        calldata_ctx = self._var(ctx, False, "calldataCTX")
        calldata_off = self._var(ctx, False, "calldataOffset")
        calldata_len = self._var(ctx, False, "txCalldataLen")
        c.data = "0x" + self._memory_bytes(
            ctx, calldata_off, calldata_len, context=calldata_ctx).hex()
        c.gas = self._var(ctx, False, "txGasLimit")
        c.value = self._var(ctx, False, "txValue")
        c.old_state_root = _h(self._sr(ctx), 64)
        c.gas_price = self._var(ctx, False, "txGasPriceRLP")
        c.chain_id = self._var(ctx, False, "txChainId")
        c.tx_index = self.tx_index

        cur_ctx = ctx.scal["CTX"]
        self.call_data = {cur_ctx: "CALL"}
        self.prev_ctx = cur_ctx

        r = self._var(ctx, False, "txR")
        s = self._var(ctx, False, "txS")
        v_raw = self._var(ctx, False, "txV")
        v = v_raw if c.chain_id == 0 else v_raw - 27 + c.chain_id * 2 + 35
        nonce = self._var(ctx, False, "txNonce")
        resp.tx_hash, resp.rlp_tx = legacy_tx_hash(
            c.to, c.value, nonce, c.gas, c.gas_price, c.data, r, s, v)
        resp.gas_left = c.gas
        resp.state_root = c.old_state_root
        resp.tx_hash_l2 = _h(self._var(ctx, False, "l2TxHash"), 64)
        resp.effective_percentage = self._var(
            ctx, False, "effectivePercentageRLP")

        if self.skip_first_change_l2_block and \
                not self.current_block.initialized:
            self.on_start_block(ctx)
        self.current_block.responses.append(resp)

        self.full_trace = []
        self.previous_memory = b""
        self.tx_time = time.time()
        self.depth = 1
        self.delta_storage = {}
        self.tx_gas[self.depth] = {"forwarded": 0, "remaining": c.gas}
        self.last_error = ""

    def on_finish_tx(self, ctx) -> None:
        """full_tracer.cpp:1154-1376."""
        if not self.current_block.responses:
            return  # first tx was a changeL2Block / empty block (:1160-1171)
        resp = self.current_block.responses[-1]
        resp.context.from_ = _h(
            self._var(ctx, True, "txSrcOriginAddr"), 40)
        resp.effective_gas_price = hex(self._var(ctx, True, "txGasPrice"))
        resp.cumulative_gas_used = self._var(
            ctx, True, "cumulativeGasUsed")
        pols_gas = ctx.scal["GAS"]
        resp.gas_used = resp.gas_left if pols_gas > resp.gas_left \
            else resp.gas_left - pols_gas
        resp.context.gas_used = resp.gas_used
        self.acc_batch_gas += resp.gas_used

        ret_off = self._var(ctx, False, "retDataOffset")
        ret_len = self._var(ctx, False, "retDataLength")
        resp.return_value = "0x" + self._memory_bytes(
            ctx, ret_off, ret_len).hex()
        if self.cfg.generate_full_trace:
            resp.context.output = resp.return_value

        if resp.context.to == "0x":
            resp.create_address = format(
                self._var(ctx, False, "txDestAddr"), "x").zfill(40)
        resp.gas_left -= resp.gas_used
        resp.state_root = _h(self._sr(ctx), 64)
        resp.status = self._var(ctx, False, "txStatus")

        if self.cfg.generate_full_trace and self.full_trace:
            last = self.full_trace[-1]
            if (len(self.full_trace) > 1 and last.op != 0x00
                    and not last.error and resp.context.to != "0x"):
                last.gas_cost = last.gas - ctx.scal["GAS"] + last.gas_refund
            resp.steps = self.full_trace
            if not resp.error:
                resp.error = last.error
        elif self.no_counters and self.full_trace:
            if not resp.error:
                resp.error = self.full_trace[-1].error
        if (not self.cfg.generate_full_trace
                and self.num_opcodes_in_tx != 0
                and self.last_error_opcode != self.num_opcodes_in_tx):
            resp.error = ""

        resp.has_gasprice_opcode = self.has_gasprice_opcode
        resp.has_balance_opcode = self.has_balance_opcode

        # order logs from all contexts by index (:1341-1360)
        aux: dict[int, LogTrace] = {}
        for per_ctx in self.logs.values():
            for log in per_ctx.values():
                aux[log.index] = log
        resp.logs = [aux[i] for i in sorted(aux)]
        self.logs.clear()

        self.full_trace = []
        self.call_data = {}
        self.num_opcodes_in_tx = 0
        self.last_error_opcode = 0

    def on_error(self, ctx, error: str) -> None:
        """full_tracer.cpp:389-504."""
        self.last_error = error
        self.last_error_opcode = self.num_opcodes_in_tx

        if error in INVALID_BATCH_ERRORS:
            self.final_trace.invalid_batch = True
            self.final_trace.error = error
            if not self.current_block.initialized:
                return
        if error in CHANGE_BLOCK_ERRORS:
            self.current_block.error = error
            return
        if error in INVALID_BATCH_ERRORS and not self.current_block.responses:
            self.current_block.error = error
            return
        if error in RESPONSE_ERRORS or not self.full_trace:
            if not self.current_block.responses:
                raise ValueError(
                    f"onError({error}) with no tx response in block")
            self.current_block.responses[-1].error = error
            return
        if self.full_trace:
            self.full_trace[-1].error = error

        # revert logs of the erroring context range (:479-495)
        cur_ctx = ctx.scal["CTX"]
        last_ctx_used = self._var(ctx, True, "lastCtxUsed")
        for i in range(cur_ctx, last_ctx_used + 1):
            self.logs.pop(i, None)

    # -- storage / log events -----------------------------------------------

    def on_store_log(self, ctx, index_log: int, is_topic: int,
                     data: int) -> None:
        """full_tracer.cpp:506-608; the data length rides in C."""
        cur_ctx = ctx.scal["CTX"]
        log = self.logs.setdefault(cur_ctx, {}).setdefault(
            index_log, LogTrace())
        if is_topic:
            log.topics.append(format(data, "x").zfill(64))
        else:
            size = min(ctx.get_reg("C"), 32)
            log.data.append(format(data, "x").zfill(64)[:size * 2])
        log.address = _h(self._var(ctx, False, "storageAddr"), 40)
        log.block_number = self._var(ctx, True, "blockNum")
        if not self.current_block.responses:
            raise ValueError("storeLog with no tx response in block")
        log.tx_hash = self.current_block.responses[-1].tx_hash
        log.tx_hash_l2 = self.current_block.responses[-1].tx_hash_l2
        log.tx_index = self.tx_index
        log.index = index_log

    def on_update_storage(self, ctx, params) -> None:
        """full_tracer.cpp:1097-1151; key in C, value in D (or E)."""
        if not (self.cfg.generate_storage and self.cfg.generate_full_trace):
            return
        key = format(ctx.get_reg(params[0]["regName"]), "x")
        value = format(ctx.get_reg(params[1]["regName"]), "x")
        addr = _h(self._var(ctx, False, "storageAddr"), 64)
        self.delta_storage.setdefault(addr, {})[key] = value
        if self.full_trace:
            self.full_trace[-1].storage = dict(self.delta_storage[addr])

    # -- per-opcode event (full_tracer.cpp:1472-2160) ------------------------

    def on_opcode(self, ctx, code_param: dict) -> None:
        self.num_opcodes_in_tx += 1
        cur_ctx = ctx.scal["CTX"]
        if self.prev_ctx > cur_ctx:
            self.depth -= 1
        elif self.prev_ctx < cur_ctx:
            self.depth += 1
        self.prev_ctx = cur_ctx

        info = OpcodeTrace()
        if self.no_counters:
            self.full_trace.append(info)
            return

        if code_param.get("op") == "number":
            raw_id = int(code_param["num"])
        else:
            raw_id = ctx.get_reg(code_param["regName"])
        code_id, name, base_gas = opcode_name(raw_id)
        info.opcode = name
        info.op = code_id
        if code_id == 0x3A:
            self.has_gasprice_opcode = True
        if code_id == 0x31:
            self.has_balance_opcode = True
        info.depth = self.depth

        prev = self.full_trace[-1] if self.full_trace else None

        # LOG0 with no data/topics never fires storeLog — record it here
        # (:1560-1624)
        if code_id == 0xA0:
            index_log = self._var(ctx, True, "currentLogIndex")
            log = self.logs.setdefault(cur_ctx, {}).setdefault(
                index_log, LogTrace())
            log.data = []
            log.address = _h(self._var(ctx, False, "storageAddr"), 40)
            log.block_number = self._var(ctx, True, "blockNum")
            if not self.current_block.responses:
                raise ValueError("LOG0 with no tx response in block")
            log.tx_hash = self.current_block.responses[-1].tx_hash
            log.tx_hash_l2 = self.current_block.responses[-1].tx_hash_l2
            log.tx_index = self.tx_index
            log.index = index_log

        if self.cfg.generate_memory:
            mem_len = ctx.get_mem_raw(
                cur_ctx * CTX_OFFSET + self.rom.memory_map["memLength"])
            n_words = -(-mem_len // 32)
            ba = b"".join(
                _fea8_scalar(ctx.mem.get(
                    cur_ctx * CTX_OFFSET + MEM_OFFSET + i, [0] * 8)
                ).to_bytes(32, "big")
                for i in range(n_words))
            if not self.full_trace:
                info.memory_offset = 0
                info.memory = ba.hex()
            elif ba != self.previous_memory:
                off, length = string_increment(self.previous_memory, ba)
                if length > 0:
                    info.memory_offset = off
                    info.memory = ba[off:off + length].hex()
                self.previous_memory = ba
            info.memory_size = len(ba)

        if self.cfg.generate_stack:
            base = cur_ctx * CTX_OFFSET + STACK_OFFSET
            info.stack = [
                _fea8_scalar(ctx.mem[base + i])
                for i in range(ctx.scal["SP"]) if base + i in ctx.mem]

        if self.cfg.generate_full_trace:
            info.pc = ctx.scal["PC"]
            info.gas = ctx.scal["GAS"]
            info.gas_cost = base_gas
            info.start_time = time.time()
            info.gas_refund = self._var(ctx, False, "gasRefund")
            info.state_root = _h(self._sr(ctx), 64)
            info.contract.address = format(
                self._var(ctx, False, "txDestAddr"), "x").zfill(40)
            info.contract.caller = format(
                self._var(ctx, False, "txSrcAddr"), "x").zfill(40)
            info.contract.value = self._var(ctx, False, "txValue")
            if prev is not None and (prev.opcode in OP_INC_CONTEXT
                                     or prev.opcode in ZERO_COST_OP):
                calldata_ctx = self._var(ctx, False, "calldataCTX")
                calldata_off = self._var(ctx, False, "calldataOffset")
                calldata_len = self._var(ctx, False, "txCalldataLen")
                info.contract.data = "0x" + self._memory_bytes(
                    ctx, calldata_off, calldata_len,
                    context=calldata_ctx).hex()
            info.contract.gas = self.tx_gas.get(
                self.depth, {"remaining": 0})["remaining"]
            info.contract.type = "CALL"

        # gas spent by the previous opcode (:1837-1954)
        if prev is not None:
            gas_cost = prev.gas - ctx.scal["GAS"]
            if prev.opcode in ZERO_COST_OP:
                prev.gas_cost = 0
            elif prev.opcode in OP_CREATE:
                if prev.error:
                    gas_call = self._var(ctx, True, "gasCall")
                    prev.gas_cost = gas_cost - gas_call + ctx.scal["GAS"]
                else:
                    origin_ctx = self._var(ctx, False, "originCTX")
                    gas_ctx = self._var(ctx, False, "gasCTX",
                                        context=origin_ctx)
                    prev.gas_cost = gas_cost - gas_ctx
            elif prev.opcode in OP_CALL and prev.depth != info.depth:
                origin_ctx = self._var(ctx, False, "originCTX")
                gas_ctx = self._var(ctx, False, "gasCTX", context=origin_ctx)
                prev.gas_cost = prev.gas - gas_ctx
            elif prev.depth != info.depth:
                if prev.error:
                    prev.gas_cost = prev.gas
            else:
                prev.gas_cost = gas_cost
            if prev.gas_cost < 0:
                if len(self.full_trace) > 2:
                    prev.gas_cost = self.full_trace[-2].gas - prev.gas
                else:
                    raise ValueError("negative gas cost with short trace")
            gas_refund = self._var(ctx, False, "gasRefund")
            if gas_refund > 0:
                info.gas_refund = gas_refund
                if prev.op == 0x55:  # SSTORE
                    prev.gas_refund = gas_refund
            prev.duration = int((info.start_time - prev.start_time) * 1e6) \
                if prev.start_time else 0

        if self.cfg.generate_return_data:
            self._return_data(ctx, info)

        # call-context bookkeeping (:2080-2121)
        if prev is not None and prev.opcode in OP_INC_CONTEXT \
                and prev.depth != info.depth:
            self.call_data[cur_ctx] = prev.opcode
            gas_call = self._var(ctx, True, "gasCall")
            self.tx_gas[self.depth] = {"forwarded": 0, "remaining": gas_call}
            if self.cfg.generate_full_trace:
                info.contract.gas = gas_call
        info.contract.type = self.call_data.get(cur_ctx, "CALL")
        if info.contract.type == "DELEGATECALL":
            info.contract.caller = format(
                self._var(ctx, False, "storageAddr"), "x").zfill(40)

        # suppress STOP of a bare ether transfer / empty create (:2123-2138)
        add_opcode = True
        if info.op == 0x00 and (prev is None or (
                prev.opcode in OP_CREATE and prev.gas_cost <= 32000)):
            if self._var(ctx, False, "bytecodeLength") == 0:
                add_opcode = False
        if add_opcode and self.cfg.generate_full_trace:
            self.full_trace.append(info)

    def _return_data(self, ctx, info: OpcodeTrace) -> None:
        """Return-data tracking incl. the CREATE special case
        (full_tracer.cpp:1956-2071)."""
        rfc = self.return_from_create
        if rfc is not None and rfc["enabled"]:
            if not rfc["return_value"]:
                ret_ctx = rfc["create_ctx"]
                off = self._var(ctx, False, "retDataOffset", context=ret_ctx)
                length = self._var(ctx, False, "retDataLength",
                                   context=ret_ctx)
                rfc["return_value"].append(
                    self._memory_bytes(ctx, off, length,
                                       context=ret_ctx).hex())
            current_ctx = self._var(ctx, True, "currentCTX")
            if rfc["origin_ctx"] == current_ctx:
                info.return_data = list(rfc["return_value"])
            else:
                rfc["enabled"] = False

        if self._var(ctx, False, "isCreate"):
            if info.opcode == "RETURN":
                self.return_from_create = {
                    "enabled": True,
                    "origin_ctx": self._var(ctx, False, "originCTX"),
                    "create_ctx": ctx.scal["CTX"],
                    "return_value": []}
        else:
            ret_data_ctx = self._var(ctx, False, "retDataCTX")
            if ret_data_ctx != 0:
                off = self._var(ctx, False, "retDataOffset",
                                context=ret_data_ctx)
                length = self._var(ctx, False, "retDataLength",
                                   context=ret_data_ctx)
                info.return_data.append(
                    self._memory_bytes(ctx, off, length,
                                       context=ret_data_ctx).hex())

    # -- touched-state summary (full_tracer.cpp:2175-2349) -------------------

    def add_read_write_address(self, address: int, key_type: int,
                               storage_key: int, value: int,
                               key: tuple) -> None:
        """Record a state-tree access; called from the Main SM at sRD/sWR
        (reference call sites in main_executor.cpp SMT_GET/SMT_SET)."""
        addr_hex = _h(address, 40)
        info = self.read_write_addresses.setdefault(addr_hex, InfoReadWrite())
        if key_type == SMT_KEY_BALANCE:
            info.balance = str(value)
            info.balance_key = tuple(key)
        elif key_type == SMT_KEY_NONCE:
            info.nonce = str(value)
            info.nonce_key = tuple(key)
        elif key_type == SMT_KEY_SC_CODE:
            info.sc_code = format(value, "x")
        elif key_type == SMT_KEY_SC_STORAGE:
            info.sc_storage[format(storage_key, "x")] = format(value, "x")
        elif key_type == SMT_KEY_SC_LENGTH:
            info.sc_length = str(value)

    def fill_in_read_write_addresses(self, smt, new_state_root: tuple) -> None:
        """Re-read balances/nonces at the final root so the summary reflects
        end-of-batch state (full_tracer.cpp:2307-2349)."""
        for info in self.read_write_addresses.values():
            if info.balance and any(info.balance_key):
                info.balance = str(
                    smt.get(new_state_root, info.balance_key).value)
            if info.nonce and any(info.nonce_key):
                info.nonce = str(
                    smt.get(new_state_root, info.nonce_key).value)

    # -- interface getters (FullTracerInterface) ----------------------------

    @property
    def block_responses(self):
        return self.final_trace.block_responses

    @property
    def error(self):
        return self.final_trace.error

    @property
    def invalid_batch(self):
        return self.final_trace.invalid_batch
