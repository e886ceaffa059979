"""zk-ASM ROM — program representation for the Main SM.

Port of `zkevm_prover_tpu/executor/rom.py` (host-only): the same `Line`,
`Rom`, `Rom.from_json` and `RomBuilder`.

Reference: src/main_sm/fork_9/main/rom_line.hpp:15-117 (per-line fields),
rom.cpp (JSON loading of scripts/rom.json produced by zkasmcom). The same
JSON schema is accepted by `Rom.from_json`, so a ROM compiled for the
reference loads here unchanged; `RomBuilder` is an eDSL for writing small
ROMs directly in Python (tests, micro-programs) without the offline
assembler.

Field conventions follow the reference JSON: selector/`CONST` values are
decimal strings (possibly negative — reduced mod p here), flags are 0/1
ints, `jmpAddr`/`elseAddr`/`offset` are line numbers resolved from labels.
"""

from __future__ import annotations

import dataclasses
import json

P = 0xFFFFFFFF_00000001

# selector fields (field-element valued)
IN_FIELDS = (
    "inA", "inB", "inC", "inD", "inE", "inSR", "inCTX", "inSP", "inPC",
    "inGAS", "inSTEP", "inFREE", "inFREE0", "inRR", "inHASHPOS", "inRCX",
    "inROTL_C", "inCntArith", "inCntBinary", "inCntMemAlign", "inCntKeccakF",
    "inCntSha256F", "inCntPoseidonG", "inCntPaddingPG",
)
# 0/1 flag fields
FLAG_FIELDS = (
    "setA", "setB", "setC", "setD", "setE", "setSR", "setCTX", "setSP",
    "setPC", "setGAS", "setRR", "setHASHPOS", "setRCX",
    "JMP", "JMPC", "JMPN", "JMPZ", "call", "return_", "repeat",
    "useJmpAddr", "useElseAddr", "useCTX", "isStack", "isMem",
    "mOp", "mWR", "sRD", "sWR", "assert_",
    "arithEq0", "arithEq1", "arithEq2", "arithEq3", "arithEq4", "arithEq5",
    "bin", "ind", "indRR",
    "hashK", "hashK1", "hashKLen", "hashKDigest",
    "hashP", "hashP1", "hashPLen", "hashPDigest",
    "hashS", "hashS1", "hashSLen", "hashSDigest",
    "memAlignRD", "memAlignWR", "memAlignWR8",
)
# small-int fields
INT_FIELDS = ("binOpcode", "incStack", "offset", "jmpAddr", "elseAddr")

# JSON name -> python field name (reserved words)
_JSON_RENAME = {"return": "return_", "assert": "assert_"}


@dataclasses.dataclass
class Line:
    """One ROM line; every field defaults to 'not present'."""

    # populated dynamically below — dataclass fields declared via make below
    line_str: str = ""
    file_name: str = ""
    line_no: int = 0
    CONST: int = 0               # field element, already reduced mod p
    bConst: bool = False
    CONSTL: int = 0              # 256-bit scalar (spread over op0..7)
    bConstL: bool = False
    cmd_before: tuple = ()
    cmd_after: tuple = ()
    free_in_tag: dict | None = None

    def __post_init__(self):
        for f in IN_FIELDS:
            if not hasattr(self, f):
                setattr(self, f, 0)
        for f in FLAG_FIELDS + INT_FIELDS:
            if not hasattr(self, f):
                setattr(self, f, 0)

    def __repr__(self):
        on = [f"{k}={getattr(self, k)}" for k in IN_FIELDS + FLAG_FIELDS + INT_FIELDS
              if getattr(self, k, 0)]
        if self.bConst:
            on.append(f"CONST={self.CONST}")
        if self.bConstL:
            on.append(f"CONSTL={self.CONSTL}")
        return f"Line({' '.join(on)})"


def _make_line(**kw) -> Line:
    ln = Line(
        line_str=kw.pop("line_str", ""), file_name=kw.pop("file_name", ""),
        line_no=kw.pop("line_no", 0),
        CONST=kw.pop("CONST", 0), bConst=kw.pop("bConst", False),
        CONSTL=kw.pop("CONSTL", 0), bConstL=kw.pop("bConstL", False),
        cmd_before=tuple(kw.pop("cmd_before", ())),
        cmd_after=tuple(kw.pop("cmd_after", ())),
        free_in_tag=kw.pop("free_in_tag", None),
    )
    for k, v in kw.items():
        if k not in IN_FIELDS and k not in FLAG_FIELDS and k not in INT_FIELDS:
            raise TypeError(f"unknown ROM line field {k!r}")
        setattr(ln, k, v)
    return ln


class Rom:
    """A loaded program: lines + label map + named constants."""

    def __init__(self, lines: list[Line], labels: dict[str, int] | None = None,
                 constants: dict | None = None,
                 memory_map: dict[str, int] | None = None):
        self.lines = lines
        self.labels = dict(labels or {})
        self.constants = dict(constants or {})
        # var name -> ctx-memory offset (reference Rom::memoryMap, built
        # from each line's offsetLabel; used by FullTracer's getVarFromCtx)
        self.memory_map = dict(memory_map or {})

    def __len__(self):
        return len(self.lines)

    def __getitem__(self, i) -> Line:
        return self.lines[i]

    @classmethod
    def from_json(cls, src) -> "Rom":
        """Load a reference-format rom.json (path, file object, or dict).

        Schema: {"program": [line...], "labels": {...}, "constants": {...}}
        as produced by zkasmcom and consumed by fork_9/main/rom.cpp.
        """
        if isinstance(src, str):
            with open(src) as f:
                obj = json.load(f)
        elif isinstance(src, dict):
            obj = src
        else:
            obj = json.load(src)
        lines = []
        memory_map: dict[str, int] = {}
        for j in obj["program"]:
            if isinstance(j.get("offsetLabel"), str) and "offset" in j:
                memory_map[j["offsetLabel"]] = int(j["offset"])
            kw: dict = {}
            for k, v in j.items():
                k = _JSON_RENAME.get(k, k)
                if k in IN_FIELDS:
                    kw[k] = int(v) % P
                elif k in FLAG_FIELDS:
                    kw[k] = int(v)
                elif k in INT_FIELDS:
                    kw[k] = int(v)
                elif k == "CONST":
                    kw["CONST"] = int(v) % P
                    kw["bConst"] = True
                elif k == "CONSTL":
                    kw["CONSTL"] = int(v) % (1 << 256)
                    kw["bConstL"] = True
                elif k == "freeInTag":
                    if v.get("op", "") != "":
                        kw["free_in_tag"] = v
                elif k == "cmdBefore":
                    kw["cmd_before"] = v
                elif k == "cmdAfter":
                    kw["cmd_after"] = v
                elif k == "lineStr":
                    kw["line_str"] = v
                elif k == "fileName":
                    kw["file_name"] = v
                elif k == "line":
                    kw["line_no"] = int(v)
                # offsetLabel / jmpAddrLabel / elseAddrLabel are display-only
            lines.append(_make_line(**kw))
        return cls(lines, obj.get("labels"), obj.get("constants"),
                   memory_map)

    def to_json(self) -> dict:
        """The program in the reference rom.json schema, so that
        `Rom.from_json` (of this package or of the JAX package) loads an
        equal ROM: selectors and CONST/CONSTL as decimal strings, the fields
        that are zero or absent left out."""
        rename = {v: k for k, v in _JSON_RENAME.items()}
        program = []
        for ln in self.lines:
            j: dict = {}
            for f in IN_FIELDS:
                if getattr(ln, f):
                    j[f] = str(getattr(ln, f))
            for f in FLAG_FIELDS + INT_FIELDS:
                if getattr(ln, f):
                    j[rename.get(f, f)] = int(getattr(ln, f))
            if ln.bConst:
                j["CONST"] = str(ln.CONST)
            if ln.bConstL:
                j["CONSTL"] = str(ln.CONSTL)
            if ln.free_in_tag is not None:
                j["freeInTag"] = ln.free_in_tag
            if ln.cmd_before:
                j["cmdBefore"] = list(ln.cmd_before)
            if ln.cmd_after:
                j["cmdAfter"] = list(ln.cmd_after)
            if ln.line_str:
                j["lineStr"] = ln.line_str
            if ln.file_name:
                j["fileName"] = ln.file_name
            if ln.line_no:
                j["line"] = ln.line_no
            program.append(j)
        return {"program": program, "labels": dict(self.labels),
                "constants": dict(self.constants)}


class RomBuilder:
    """eDSL for writing ROM programs in Python.

    >>> rb = RomBuilder()
    >>> rb.line(inSTEP=1, setA=1)                 # STEP => A
    >>> rb.label("loop"); rb.line(JMP=1, jmpAddr="loop", useJmpAddr=1)
    >>> rom = rb.build()

    Label references (strings) in jmpAddr/elseAddr/offset are resolved at
    build time; `finalize()` appends the reference ROM's canonical ending
    (spin on ${beforeLast()} :JMPN, then jump to line 0 to close the cycle
    — main.zkasm's finalWait idiom).
    """

    def __init__(self):
        self._lines: list[tuple[dict, str]] = []
        self.labels: dict[str, int] = {}

    def label(self, name: str) -> int:
        assert name not in self.labels, f"duplicate label {name}"
        self.labels[name] = len(self._lines)
        return self.labels[name]

    def line(self, line_str: str = "", *, CONST=None, CONSTL=None, **kw):
        if CONST is not None:
            kw["CONST"] = int(CONST) % P
            kw["bConst"] = True
        if CONSTL is not None:
            kw["CONSTL"] = int(CONSTL) % (1 << 256)
            kw["bConstL"] = True
        for f in IN_FIELDS:
            if f in kw:
                kw[f] = int(kw[f]) % P
        self._lines.append((kw, line_str))
        return len(self._lines) - 1

    # -- common idioms ------------------------------------------------------

    def free(self, tag: dict, line_str: str = "", **kw):
        """${tag} => reg : one free-input line (inFREE=1 unless overridden)."""
        kw.setdefault("inFREE", 1)
        return self.line(line_str, free_in_tag=tag, **kw)

    def jmp(self, target, **kw):
        return self.line(JMP=1, useJmpAddr=1, jmpAddr=target, **kw)

    def call(self, target, **kw):
        return self.line(call=1, useJmpAddr=1, jmpAddr=target, **kw)

    def ret(self, **kw):
        return self.line(return_=1, **kw)

    def clear_registers(self):
        """0 => A,B,...,RCX — restore the zero state so the cyclic register
        constraints close at the wrap row (main.zkasm's finalizeExecution)."""
        return self.line(
            "0 => A,B,C,D,E,SR,CTX,SP,PC,GAS,RR,HASHPOS,RCX",
            **{f: 1 for f in ("setA", "setB", "setC", "setD", "setE",
                              "setSR", "setCTX", "setSP", "setPC", "setGAS",
                              "setRR", "setHASHPOS", "setRCX")})

    def finalize(self, start: int | str = 0):
        """Append the cyclic ending: spin until the second-to-last row, then
        jump back to `start` so row N-1 wraps to row 0."""
        self.label("__finalWait")
        self.free({"op": "functionCall", "funcName": "beforeLast",
                   "params": []}, JMPN=1, useJmpAddr=1, jmpAddr="__finalWait")
        self.jmp(start)

    def build(self) -> Rom:
        lines = []
        for kw, s in self._lines:
            kw = dict(kw)
            for f in ("jmpAddr", "elseAddr", "offset"):
                v = kw.get(f)
                if isinstance(v, str):
                    kw[f] = self.labels[v]
            lines.append(_make_line(line_str=s, **kw))
        return Rom(lines, self.labels)
