"""Command-AST evaluation for ROM free inputs and cmdBefore/cmdAfter.

Port of `zkevm_prover_tpu/executor/eval_command.py` (host-only): the same
command evaluation; it takes only `P` from the port's `ops/goldilocks.py`.

Reference: src/main_sm/fork_9/main/eval_command.cpp (3.8k LoC) — commands are
small ASTs attached to ROM lines (freeInTag, cmdBefore, cmdAfter) that the
executor evaluates on the host to produce free-input values and side effects
(variables, logs). The AST JSON schema is the rom.json one: {"op": ...} with
op ∈ {number, declareVar/setVar/getVar, getReg, functionCall, add..shr, if,
getMemValue} (rom_command.hpp:78-108).

Values are Python ints (the reference's mpz scalars; intermediates may be
negative) or, for fea-returning functions, an 8-tuple of field elements.
Function calls dispatch through `FUNCS`; the implemented subset covers the
control/arithmetic helpers plus the secp256k1 field helpers used by the
ecrecover flow — others can be registered by callers.
"""

from __future__ import annotations

from ..ops import goldilocks as gl

P = gl.P
MASK256 = (1 << 256) - 1

# secp256k1 parameters (for inverseFpEc/inverseFnEc/sqrtFpEc/point helpers)
FPEC = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
FNEC = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

# BN254 (alt_bn128) base field, for the ARITH_BN254_* / fpBN254inv /
# fp2InvBN254 free-input helpers (ref eval_command.cpp:3416-3801, RawFq)
FQBN = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# Mock SMT-proof leaf returned when input.bSkipVerifyL1InfoRoot is set
# (ref eval_command.cpp:2689 MOCK_VALUE_SMT_PROOF)
MOCK_VALUE_SMT_PROOF = 0xD4E56740F876AEF8C010B86A40D5F56745A118D0906A34E69AEC8C0DB1CB8FA3


class CommandError(Exception):
    pass


def _scalar(v) -> int:
    """Collapse an fea result to a scalar where a scalar is required."""
    if isinstance(v, tuple):
        out = 0
        for i, fe in enumerate(v):
            out |= int(fe) << (32 * i)
        return out
    return v


def eval_command(ctx, cmd: dict):
    """Evaluate one command AST; returns int | 8-tuple (fea) | None."""
    op = cmd["op"]
    f = _OPS.get(op)
    if f is None:
        raise CommandError(f"unimplemented command op {op!r}")
    return f(ctx, cmd)


def _values(ctx, cmd, n=None):
    vals = [_scalar(eval_command(ctx, v)) for v in cmd["values"]]
    if n is not None and len(vals) != n:
        raise CommandError(f"{cmd['op']}: expected {n} operands")
    return vals


# -- core ops ---------------------------------------------------------------

def _op_number(ctx, cmd):
    return int(cmd["num"])


def _op_declare_var(ctx, cmd):
    ctx.vars[cmd["varName"]] = 0
    return 0


def _op_set_var(ctx, cmd):
    name = cmd["values"][0]["varName"]
    v = eval_command(ctx, cmd["values"][1])
    ctx.vars[name] = v
    return v


def _op_get_var(ctx, cmd):
    try:
        return ctx.vars[cmd["varName"]]
    except KeyError:
        raise CommandError(f"undeclared var {cmd['varName']!r}") from None


def _op_get_reg(ctx, cmd):
    return ctx.get_reg(cmd["regName"])


def _op_function_call(ctx, cmd):
    name = cmd["funcName"]
    if name == "eventLog":
        # params are event-tag ASTs (e.g. getVar onStartBatch), consumed
        # raw by FullTracer::handleEvent (eval_command.cpp eval_eventLog)
        tracer = getattr(ctx, "full_tracer", None)
        if tracer is not None:
            tracer.handle_event(ctx, cmd)
        return (0,) * 8
    fn = FUNCS.get(name)
    if fn is None:
        raise CommandError(f"unimplemented function {name!r}")
    return fn(ctx, [eval_command(ctx, p) for p in cmd.get("params", ())])


def _op_if(ctx, cmd):
    c = _scalar(eval_command(ctx, cmd["values"][0]))
    return eval_command(ctx, cmd["values"][1 if c else 2])


def _op_get_mem_value(ctx, cmd):
    return ctx.get_mem(int(cmd["offset"]), bool(cmd.get("useCTX", 0)))


_BINOPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a // b,
    "mod": lambda a, b: a % b,
    "or": lambda a, b: int(bool(a) or bool(b)),
    "and": lambda a, b: int(bool(a) and bool(b)),
    "gt": lambda a, b: int(a > b),
    "ge": lambda a, b: int(a >= b),
    "lt": lambda a, b: int(a < b),
    "le": lambda a, b: int(a <= b),
    "eq": lambda a, b: int(a == b),
    "ne": lambda a, b: int(a != b),
    "bitand": lambda a, b: a & b,
    "bitor": lambda a, b: a | b,
    "bitxor": lambda a, b: a ^ b,
    "shl": lambda a, b: (a << b) & MASK256,
    "shr": lambda a, b: a >> b,
}

_OPS = {
    "number": _op_number,
    "declareVar": _op_declare_var,
    "setVar": _op_set_var,
    "getVar": _op_get_var,
    "getReg": _op_get_reg,
    "functionCall": _op_function_call,
    "if": _op_if,
    "getMemValue": _op_get_mem_value,
    "neg": lambda ctx, cmd: -_values(ctx, cmd, 1)[0],
    "not": lambda ctx, cmd: int(not _values(ctx, cmd, 1)[0]),
    "bitnot": lambda ctx, cmd: _values(ctx, cmd, 1)[0] ^ MASK256,
}
for _name, _fn in _BINOPS.items():
    _OPS[_name] = (lambda ctx, cmd, _f=_fn:
                   _f(*_values(ctx, cmd, 2)))


# -- function-call registry ---------------------------------------------------

def _f_before_last(ctx, params):
    # fea: -1 until step N-2, then 0 — drives the finalWait JMPN spin
    # (eval_command.cpp:1578-1605)
    fe0 = 0 if ctx.step >= ctx.n - 2 else P - 1
    return (fe0, 0, 0, 0, 0, 0, 0, 0)


def _f_cond(ctx, params):
    # returns fea -1 if param != 0 else 0 (used as JMPN condition)
    v = _scalar(params[0])
    return (P - 1 if v else 0, 0, 0, 0, 0, 0, 0, 0)


def _f_exp(ctx, params):
    a, b = _scalar(params[0]), _scalar(params[1])
    return pow(a, b)  # unbounded, like mpz_pow


def _f_store_log(ctx, params):
    vals = tuple(_scalar(p) for p in params)
    ctx.logs.append(vals)
    # storeLog is routed to the tracer like an event (reference handleEvent's
    # f_storeLog branch, full_tracer.cpp:321-325): (indexLog, isTopic, data)
    tracer = getattr(ctx, "full_tracer", None)
    if tracer is not None:
        tracer.on_store_log(ctx, vals[0], vals[1], vals[2])
    return 0


def _mem_align_write(m0: int, m1: int, value: int, offset: int):
    """Write 32 bytes of `value` at byte `offset` of the 64-byte window
    M0‖M1 (big-endian byte addressing); returns the new (M0, M1)."""
    wb = bytearray(m0.to_bytes(32, "big") + m1.to_bytes(32, "big"))
    vb = value.to_bytes(32, "big")
    wb[offset:offset + 32] = vb
    return int.from_bytes(wb[:32], "big"), int.from_bytes(wb[32:], "big")


def _f_mem_align_wr_w0_full(ctx, params):
    m0, value, offset = (_scalar(p) % (1 << 256) for p in params)
    # W1 content does not affect W0's result
    return _mem_align_write(m0, 0, value, offset)[0]


def _f_mem_align_wr_w1_full(ctx, params):
    m1, value, offset = (_scalar(p) % (1 << 256) for p in params)
    w0, w1 = _mem_align_write(0, m1, value, offset)
    return w1


def _f_mem_align_wr8_w0(ctx, params):
    m0, value, offset = (_scalar(p) % (1 << 256) for p in params)
    wb = bytearray(m0.to_bytes(32, "big"))
    wb[offset] = value & 0xFF
    return int.from_bytes(wb, "big")


def _f_inverse_fp_ec(ctx, params):
    a = _scalar(params[0]) % FPEC
    if a == 0:
        raise CommandError("inverseFpEc: zero")
    return pow(a, FPEC - 2, FPEC)


def _f_inverse_fn_ec(ctx, params):
    a = _scalar(params[0]) % FNEC
    if a == 0:
        raise CommandError("inverseFnEc: zero")
    return pow(a, FNEC - 2, FNEC)


def _f_sqrt_fp_ec(ctx, params):
    a = _scalar(params[0]) % FPEC
    r = pow(a, (FPEC + 1) // 4, FPEC)
    if r * r % FPEC != a:
        # non-residue sentinel, mirrors eval_command's sqrtFpEc contract
        return MASK256
    return min(r, FPEC - r)


def _f_sqrt_fp_ec_parity(ctx, params):
    a = _scalar(params[0]) % FPEC
    parity = _scalar(params[1]) & 1
    r = pow(a, (FPEC + 1) // 4, FPEC)
    if r * r % FPEC != a:
        return MASK256
    return r if (r & 1) == parity else FPEC - r


def _ec_add(x1, y1, x2, y2):
    if x1 == x2 and (y1 + y2) % FPEC == 0:
        raise CommandError("ec point at infinity")
    if x1 == x2 and y1 == y2:
        s = (3 * x1 * x1) * pow(2 * y1, FPEC - 2, FPEC) % FPEC
    else:
        s = (y2 - y1) * pow(x2 - x1, FPEC - 2, FPEC) % FPEC
    x3 = (s * s - x1 - x2) % FPEC
    y3 = (s * (x1 - x3) - y1) % FPEC
    return x3, y3


def _f_x_add_point_ec(ctx, params):
    x1, y1, x2, y2 = (_scalar(p) % FPEC for p in params)
    return _ec_add(x1, y1, x2, y2)[0]


def _f_y_add_point_ec(ctx, params):
    x1, y1, x2, y2 = (_scalar(p) % FPEC for p in params)
    return _ec_add(x1, y1, x2, y2)[1]


# -- multi-precision division (MPdiv family) ---------------------------------
#
# The ROM divides big integers held in memory as little-endian arrays of
# 256-bit words.  The reference implements schoolbook long division over
# base-2^256 limbs (eval_command.cpp:2980-3028 _MPdiv, :3029-3049
# _MPdiv_short) and parks quotient/remainder in ctx for the receive* calls.
# Exact arbitrary-precision ints make the limb dance unnecessary: divide,
# then re-limb.  `trim` semantics (eval_command.cpp:2785): zero == [].

def _mp_limbs(v: int) -> list[int]:
    out = []
    while v:
        out.append(v & MASK256)
        v >>= 256
    return out


def _read_mp(ctx, addr: int, length: int) -> int:
    out = 0
    for i in range(length):
        out |= ctx.get_mem_raw(addr + i) << (256 * i)
    return out


def _f_mpdiv(ctx, params):
    addr1, len1, addr2, len2 = (_scalar(p) for p in params)
    a = _read_mp(ctx, addr1, len1)
    b = _read_mp(ctx, addr2, len2)
    if b == 0:
        raise CommandError("MPdiv: division by zero")
    ctx.mp_quotient = _mp_limbs(a // b)
    ctx.mp_remainder = _mp_limbs(a % b)
    return 0


def _f_mpdiv_short(ctx, params):
    addr1, len1, b = (_scalar(p) for p in params)
    a = _read_mp(ctx, addr1, len1)
    if b == 0:
        raise CommandError("MPdiv_short: division by zero")
    ctx.mp_quotient_short = _mp_limbs(a // b)
    ctx.mp_remainder_short = a % b
    return 0


def _f_receive_len(ctx, params):
    # max floor(log2(k)) over non-zero params (eval_command.cpp:3380-3413)
    length = 0
    for p in params:
        k = _scalar(p)
        if k:
            length = max(length, k.bit_length() - 1)
    return length


def _mp_chunk(limbs: list[int], pos: int, what: str) -> int:
    if pos >= len(limbs):
        raise CommandError(f"{what}: position {pos} >= len {len(limbs)}")
    return limbs[pos]


# -- BN254 base-field / Fp2 helpers (ref eval_command.cpp ARITH_BN254_*) -----

def _f_bn254_addfp2(ctx, params):
    # 2 params — one Fp2 component per call (the ROM invokes it for x and y
    # separately; ref eval_command.cpp eval_ARITH_BN254_ADDFP2)
    x1, x2 = (_scalar(p) % FQBN for p in params)
    return (x1 + x2) % FQBN


def _f_bn254_subfp2(ctx, params):
    x1, x2 = (_scalar(p) % FQBN for p in params)
    return (x1 - x2) % FQBN


def _f_bn254_mulfp2_x(ctx, params):
    x1, y1, x2, y2 = (_scalar(p) % FQBN for p in params)
    return (x1 * x2 - y1 * y2) % FQBN


def _f_bn254_mulfp2_y(ctx, params):
    x1, y1, x2, y2 = (_scalar(p) % FQBN for p in params)
    return (x1 * y2 + y1 * x2) % FQBN


def _f_fpbn254_inv(ctx, params):
    a = _scalar(params[0]) % FQBN
    if a == 0:
        raise CommandError("fpBN254inv: zero")
    return pow(a, FQBN - 2, FQBN)


def _fp2_inv(x: int, y: int) -> tuple[int, int]:
    den = (x * x + y * y) % FQBN
    if den == 0:
        raise CommandError("fp2InvBN254: zero")
    d = pow(den, FQBN - 2, FQBN)
    return (x * d) % FQBN, (-y * d) % FQBN


def _f_fp2inv_bn254_x(ctx, params):
    x, y = (_scalar(p) % FQBN for p in params)
    return _fp2_inv(x, y)[0]


def _f_fp2inv_bn254_y(ctx, params):
    x, y = (_scalar(p) % FQBN for p in params)
    return _fp2_inv(x, y)[1]


# -- L1 info tree getters (ref eval_command.cpp:2524-2689) -------------------
#
# Input schema: ctx.input["l1InfoTree"] = {index: {"globalExitRoot": int,
# "blockHashL1": int, "minTimestamp": int, "smtProof": [int, ...]}} —
# mirrors Input::loadGlobals (input.cpp:460-537).

def _scalar_fea(v: int):
    return tuple((v >> (32 * i)) & 0xFFFFFFFF for i in range(8))


def _l1_data(ctx, index: int) -> dict:
    tree = ctx.input.get("l1InfoTree", {})
    data = tree.get(index)
    if data is None:
        raise CommandError(
            f"invalid L1 info tree index {index}")  # ZKR_..._INVALID_L1_INFO_TREE_INDEX
    return data


def _f_get_l1_info_root(ctx, params):
    return _scalar_fea(ctx.input.get("l1InfoRoot", 0))


def _f_get_l1_info_ger(ctx, params):
    return _scalar_fea(_l1_data(ctx, _scalar(params[0]))["globalExitRoot"])


def _f_get_l1_info_block_hash(ctx, params):
    return _scalar_fea(_l1_data(ctx, _scalar(params[0]))["blockHashL1"])


def _f_get_l1_info_timestamp(ctx, params):
    return _scalar_fea(_l1_data(ctx, _scalar(params[0]))["minTimestamp"])


def _f_get_timestamp_limit(ctx, params):
    return _scalar_fea(ctx.input.get("timestampLimit", 0))


def _f_get_forced_block_hash_l1(ctx, params):
    return _scalar_fea(ctx.input.get("forcedBlockHashL1", 0))


def _f_get_smt_proof(ctx, params):
    index, level = (_scalar(p) for p in params)
    if ctx.input.get("skipVerifyL1InfoRoot", False):
        return _scalar_fea(MOCK_VALUE_SMT_PROOF)
    proof = _l1_data(ctx, index).get("smtProof", [])
    if level >= len(proof):
        raise CommandError(
            f"getSmtProof: level {level} >= proof len {len(proof)}")
    return _scalar_fea(proof[level])


# -- FullTracer hooks --------------------------------------------------------

def _f_on_opcode(ctx, params):
    # normally consumed raw via eventLog -> FullTracer.handle_event; this
    # evaluated path only fires if a ROM calls onOpcode outside eventLog
    tracer = getattr(ctx, "full_tracer", None)
    if tracer is not None:
        tracer.on_opcode(ctx, {"op": "number", "num": str(_scalar(params[0]))})
    return 0


def _f_on_update_storage(ctx, params):
    # see _f_on_opcode: the eventLog path hands the tracer the raw ASTs
    return 0


def _f_x_dbl_point_ec(ctx, params):
    x1, y1 = (_scalar(p) % FPEC for p in params)
    return _ec_add(x1, y1, x1, y1)[0]


def _f_y_dbl_point_ec(ctx, params):
    x1, y1 = (_scalar(p) % FPEC for p in params)
    return _ec_add(x1, y1, x1, y1)[1]


FUNCS = {
    "beforeLast": _f_before_last,
    "cond": _f_cond,
    "exp": _f_exp,
    "log": lambda ctx, params: 0,
    "storeLog": _f_store_log,
    "eventLog": lambda ctx, params: 0,
    "loadScalar": lambda ctx, params: _scalar(params[0]),
    "getTimestamp": lambda ctx, params: ctx.input.get("timestamp", 0),
    "getTxs": lambda ctx, params: ctx.get_txs(_scalar(params[0]),
                                              _scalar(params[1])),
    "getTxsLen": lambda ctx, params: len(ctx.input.get("batchL2Data", b"")),
    "getSequencerAddr": lambda ctx, params: ctx.input.get("sequencerAddr", 0),
    "getGlobalExitRoot": lambda ctx, params: ctx.input.get("globalExitRoot", 0),
    "bitwise_and": lambda ctx, params: _scalar(params[0]) & _scalar(params[1]),
    "bitwise_or": lambda ctx, params: _scalar(params[0]) | _scalar(params[1]),
    "bitwise_xor": lambda ctx, params: _scalar(params[0]) ^ _scalar(params[1]),
    "bitwise_not": lambda ctx, params: _scalar(params[0]) ^ MASK256,
    "comp_lt": lambda ctx, params: int(_scalar(params[0]) < _scalar(params[1])),
    "comp_gt": lambda ctx, params: int(_scalar(params[0]) > _scalar(params[1])),
    "comp_eq": lambda ctx, params: int(_scalar(params[0]) == _scalar(params[1])),
    "memAlignWR_W0": _f_mem_align_wr_w0_full,
    "memAlignWR_W1": _f_mem_align_wr_w1_full,
    "memAlignWR8_W0": _f_mem_align_wr8_w0,
    "inverseFpEc": _f_inverse_fp_ec,
    "inverseFnEc": _f_inverse_fn_ec,
    "sqrtFpEc": _f_sqrt_fp_ec,
    "sqrtFpEcParity": _f_sqrt_fp_ec_parity,
    "xAddPointEc": _f_x_add_point_ec,
    "yAddPointEc": _f_y_add_point_ec,
    "xDblPointEc": _f_x_dbl_point_ec,
    "yDblPointEc": _f_y_dbl_point_ec,
    # multi-precision division scratch machine
    "MPdiv": _f_mpdiv,
    "MPdiv_short": _f_mpdiv_short,
    "receiveLen": _f_receive_len,
    "receiveLenQuotient":
        lambda ctx, params: len(getattr(ctx, "mp_quotient", [])),
    "receiveLenRemainder":
        lambda ctx, params: len(getattr(ctx, "mp_remainder", [])),
    "receiveQuotientChunk":
        lambda ctx, params: _mp_chunk(getattr(ctx, "mp_quotient", []),
                                      _scalar(params[0]),
                                      "receiveQuotientChunk"),
    "receiveRemainderChunk":
        lambda ctx, params: _mp_chunk(getattr(ctx, "mp_remainder", []),
                                      _scalar(params[0]),
                                      "receiveRemainderChunk"),
    "receiveLenQuotient_short":
        lambda ctx, params: len(getattr(ctx, "mp_quotient_short", [])),
    "receiveQuotientChunk_short":
        lambda ctx, params: _mp_chunk(getattr(ctx, "mp_quotient_short", []),
                                      _scalar(params[0]),
                                      "receiveQuotientChunk_short"),
    "receiveRemainderChunk_short":
        lambda ctx, params: getattr(ctx, "mp_remainder_short", 0),
    # BN254 base-field / Fp2 helpers
    "ARITH_BN254_ADDFP2": _f_bn254_addfp2,
    "ARITH_BN254_SUBFP2": _f_bn254_subfp2,
    "ARITH_BN254_MULFP2_X": _f_bn254_mulfp2_x,
    "ARITH_BN254_MULFP2_Y": _f_bn254_mulfp2_y,
    "fpBN254inv": _f_fpbn254_inv,
    "fp2InvBN254_x": _f_fp2inv_bn254_x,
    "fp2InvBN254_y": _f_fp2inv_bn254_y,
    # L1 info tree
    "getL1InfoRoot": _f_get_l1_info_root,
    "getL1InfoGER": _f_get_l1_info_ger,
    "getL1InfoBlockHash": _f_get_l1_info_block_hash,
    "getL1InfoTimestamp": _f_get_l1_info_timestamp,
    "getTimestampLimit": _f_get_timestamp_limit,
    "getForcedBlockHashL1": _f_get_forced_block_hash_l1,
    "getSmtProof": _f_get_smt_proof,
    # FullTracer hooks
    "onOpcode": _f_on_opcode,
    "onUpdateStorage": _f_on_update_storage,
}
