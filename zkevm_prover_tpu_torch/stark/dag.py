"""Constraint-expression DAGs compiled to one program for an interpreter
kernel, and the program's plain twin.

`compile_program` turns `expr.Expr` outputs into a `Program`: a list of
four-int instructions over per-row value slots. `dag_eval_kernel`
(csrc/stark.cu, bound in `ops/stark_cuda.py`) runs it with one thread per
row; `run_plain` runs the same instructions with one torch op (of
`ops/goldilocks` and `ops/gl3`) per instruction over all rows. `run` picks
the kernel for a CUDA output and the twin for a CPU one. Both give what
`expr.eval_array` gives, bit for bit: every operation is the canonical
field operation that `eval_array` applies to the same operand kinds
(base + ext promotes the base, base x ext is `gl3.mul_base`, negation is
componentwise, a row-invariant value broadcasts over the rows).

The compiler:
  * evaluates row-invariant subtrees (challenges, publics, numbers, evals
    and what they make) once on the host, in `Program.uniform_values`: the
    program reads them from a small table;
  * orders the row-varying nodes by Sethi-Ullman need (the child that needs
    more slots first), so a Horner sum over a thousand constraints keeps
    its accumulator and one constraint's values live, where
    `eval_array`'s order keeps every constraint's value live until the
    chain's bottom is reached;
  * evaluates a node shared by identity once, and loads a leaf column
    (committed, constant, x, Zi) again at each use, right before the
    instruction that reads it;
  * gives slots by last use (a freed slot is taken again by the next
    result);
  * cuts the reuse of shared nodes every `chunk` Horner terms or outputs
    when the slots would pass `max_slots`: a later chunk computes a shared
    node again rather than keeping it live. The role of the JAX package's
    `_C_CHUNK` (stark/prover.py `_phase4_chunk_fns`); here the chunks stay
    in one program and one launch, and the Horner chain itself runs on
    unchanged, so the result is the same field element by construction.

Instructions are `(op, dst, a, b)` int32s. An operand `a`/`b` >= 0 is a
slot, < 0 the uniform table's entry `-1 - operand`. Loads take a section
index and a column in `a` and `b`; stores and flags an operand in `a` and
an output column or flag index in `b`.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from ..ops import gl3
from ..ops import goldilocks as gl
from . import expr as ex

# opcodes (csrc/stark.cu `Op`)
LOAD1, LOAD3, LOAD1_NEXT, LOAD3_NEXT = 0, 1, 2, 3
STORE1, STORE3, STORE13 = 4, 5, 6     # STORE13: a base value as (v, 0, 0)
FLAG1, FLAG3 = 7, 8
NEG1, NEG3 = 9, 10
ADD, SUB, MUL = 16, 20, 24            # + 2 * (a is ext) + (b is ext)

# the slot array of one thread in dag_eval_kernel (csrc/stark.cu MAX_SLOTS)
MAX_SLOTS = 32
# the sections one program reads (csrc/stark.cu MAX_SECTIONS)
MAX_SECTIONS = 8

_LEAVES = (ex.Cm, ex.Const, ex.X, ex.Zi)
_UNIFORM_LEAVES = (ex.Challenge, ex.Public, ex.Number, ex.Eval)
_BINARY = {ex.Add: ADD, ex.Sub: SUB, ex.Mul: MUL}


@dataclasses.dataclass(frozen=True)
class Output:
    """One output of a program: the expression stored at column `col` of
    the output (as 1 or 3 columns; `ext` promotes a base value to 3), or,
    with `flag` set, a flag raised where the value is not zero."""

    expr: ex.Expr
    col: int | None = None
    ext: bool = False
    flag: int | None = None


@dataclasses.dataclass
class Program:
    """A compiled program: its `outputs`, `code` (n, 4) int32
    instructions, the section keys its loads name by index, the
    row-invariant roots whose values fill the uniform table, the slots it
    needs, the chunk it was cut at (None: not cut) and its flag count."""

    outputs: list
    code: np.ndarray
    sections: list
    uniform_roots: list
    n_slots: int
    chunk: int | None
    n_flags: int
    _device_code: dict = dataclasses.field(default_factory=dict, repr=False)

    def uniform_values(self, challenges=None, publics=None,
                       evals=None) -> np.ndarray:
        """The uniform table, (n, 3) uint64 (a base value in column 0):
        each root evaluated with exact host integers (`expr.eval_point`)."""
        def ints(rows):
            return None if rows is None else [
                tuple(int(x) for x in r) for r in np.asarray(rows, np.uint64)]

        b = ex.PointBindings(
            cm=None, const=None, challenges=ints(challenges),
            publics=None if publics is None else [int(v) for v in publics],
            evals=ints(evals))
        table = np.zeros((len(self.uniform_roots), 3), dtype=np.uint64)
        for i, r in enumerate(self.uniform_roots):
            v = ex.eval_point(r, b)
            table[i] = v if isinstance(v, tuple) else (v, 0, 0)
        return table

    def device_code(self, device) -> torch.Tensor:
        """The instructions as an int32 tensor on `device` (copied once)."""
        key = str(device)
        if key not in self._device_code:
            self._device_code[key] = torch.from_numpy(self.code).to(device)
        return self._device_code[key]

    @property
    def n_ops(self) -> int:
        return len(self.code)


class _Compiler:
    def __init__(self, leaf_info):
        self.leaf_info = leaf_info
        self.uniform: dict[int, bool] = {}
        self.dim: dict[int, int] = {}
        self.need: dict[int, int] = {}
        self.sections: list = []
        self.uniform_roots: list = []
        self.uniform_index: dict = {}
        self.ops: list = []          # (op, dst vreg, a, b), operands vregs
        self.memo: dict[int, int] = {}
        self.n_vregs = 0

    # -- analysis ------------------------------------------------------------

    def analyse(self, e):
        """Uniformity, dim and Sethi-Ullman need of every node of `e`
        (post-order, iterative: Horner chains run a thousand deep)."""
        stack = [(e, False)]
        while stack:
            n, done = stack.pop()
            k = id(n)
            if k in self.dim:
                continue
            kids = ex._children(n)
            if not done:
                stack.append((n, True))
                stack.extend((c, False) for c in kids if id(c) not in self.dim)
                continue
            if isinstance(n, _UNIFORM_LEAVES):
                if isinstance(n, ex.Number) and not 0 <= n.value < gl.P:
                    raise ValueError(f"non-canonical number {n.value}")
                u, d = True, (3 if isinstance(n, (ex.Challenge, ex.Eval))
                              else 1)
                need = 0
            elif isinstance(n, _LEAVES):
                u, d, need = False, self.leaf_info(n)[2], 1
            elif isinstance(n, (ex.Neg, *_BINARY)):
                u = all(self.uniform[id(c)] for c in kids)
                d = max(self.dim[id(c)] for c in kids)
                needs = sorted((self.need[id(c)] for c in kids), reverse=True)
                if u:
                    need = 0
                elif len(needs) == 1 or needs[0] != needs[1]:
                    need = max(needs[0], 1)
                else:
                    need = needs[0] + 1
            else:
                raise TypeError(f"{type(n).__name__} has no row binding")
            self.uniform[k], self.dim[k], self.need[k] = u, d, need

    # -- emission ------------------------------------------------------------

    def _vreg(self) -> int:
        self.n_vregs += 1
        return self.n_vregs - 1

    def _section(self, key) -> int:
        if key not in self.sections:
            self.sections.append(key)
        return self.sections.index(key)

    def operand(self, n):
        """The uniform table entry of a uniform node: one per leaf value
        (a thousand `Number(1)`s share one), one per inner node."""
        k = id(n)
        if isinstance(n, _UNIFORM_LEAVES):
            k = (type(n).__name__, dataclasses.astuple(n))
        if k not in self.uniform_index:
            self.uniform_index[k] = len(self.uniform_roots)
            self.uniform_roots.append(n)
        return ("u", self.uniform_index[k])

    def load(self, n):
        key, col, dim = self.leaf_info(n)
        nxt = getattr(n, "prime", False)
        op = (LOAD3 if dim == 3 else LOAD1) + (2 if nxt else 0)
        v = self._vreg()
        self.ops.append((op, v, ("s", self._section(key)), ("i", col)))
        return ("v", v)

    def emit(self, n):
        """Operand holding node `n`'s value, emitting what computes it."""
        k = id(n)
        if self.uniform[k]:
            return self.operand(n)
        if isinstance(n, _LEAVES):
            return self.load(n)
        if k in self.memo:
            return ("v", self.memo[k])
        kids = ex._children(n)
        # inner children by need first, then the leaves, loaded last
        inner = sorted((c for c in kids if not isinstance(c, _LEAVES)),
                       key=lambda c: -self.need[id(c)])
        got = {}
        for c in inner:
            got[id(c)] = self.emit(c)
        for c in kids:
            if id(c) not in got:
                got[id(c)] = self.emit(c)
        return self.op(n, got[id(n.a)], got.get(id(getattr(n, "b", None))))

    def op(self, n, a, b):
        """Emit node `n`'s operation on operands a (and b); memoize it."""
        v = self._vreg()
        if isinstance(n, ex.Neg):
            op = NEG3 if self.dim[id(n)] == 3 else NEG1
            self.ops.append((op, v, a, ("i", 0)))
        else:
            op = (_BINARY[type(n)] + 2 * (self.dim[id(n.a)] == 3)
                  + (self.dim[id(n.b)] == 3))
            self.ops.append((op, v, a, b))
        self.memo[id(n)] = v
        return ("v", v)

    def chain(self, n):
        """A Horner chain `((t0 * u + t1) * u + t2) ...` under `n` with a
        uniform `u`: (t0, [(mul node, add node, term), ...] from t1 on)."""
        levels = []
        while (isinstance(n, ex.Add) and isinstance(n.a, ex.Mul)
               and not self.uniform[id(n)] and self.uniform[id(n.a.b)]
               and not self.uniform[id(n.a.a)]):
            levels.append((n.a, n, n.b))
            n = n.a.a
        return n, levels[::-1]

    def emit_chunked(self, n, chunk):
        """`emit(n)`, with the memo of shared nodes dropped every `chunk`
        terms of a Horner chain at `n`, or under an operation at `n` whose
        one row-varying inner operand is such a chain (C * Zi)."""
        if chunk is None or self.uniform[id(n)] or isinstance(n, _LEAVES):
            return self.emit(n)
        base, levels = self.chain(n)
        if not levels:
            kids = ex._children(n)
            inner = [c for c in kids
                     if not self.uniform[id(c)] and not isinstance(c, _LEAVES)]
            if len(inner) != 1 or len(kids) != len(set(map(id, kids))):
                return self.emit(n)
            got = {id(inner[0]): self.emit_chunked(inner[0], chunk)}
            for c in kids:
                if id(c) not in got:
                    got[id(c)] = self.emit(c)
            return self.op(n, got[id(n.a)],
                           got.get(id(getattr(n, "b", None))))
        acc = self.emit(base)
        for i, (mul, add, term) in enumerate(levels):
            if (i + 1) % chunk == 0:
                self.memo.clear()
            m = self.op(mul, acc, self.operand(mul.b))
            acc = self.op(add, m, self.emit(term))
        return acc


def _allocate(ops, n_vregs):
    """Slots by last use: (code (n, 4) int32, slots used)."""
    last = [-1] * n_vregs
    for i, (_, _, a, b) in enumerate(ops):
        for x in (a, b):
            if x[0] == "v":
                last[x[1]] = i
    free: list[int] = []
    slot_of = {}
    top = 0
    code = np.zeros((len(ops), 4), dtype=np.int32)

    def enc(x):
        kind, v = x
        if kind == "v":
            return slot_of[v]
        if kind == "u":
            return -1 - v
        return v

    for i, (op, dst, a, b) in enumerate(ops):
        code[i, 0] = op
        code[i, 2], code[i, 3] = enc(a), enc(b)
        for x in {a, b}:
            if x[0] == "v" and last[x[1]] == i:
                heapq.heappush(free, slot_of[x[1]])
        if dst is None:
            continue
        if last[dst] < 0:
            raise AssertionError("a value nothing reads")
        if free:
            s = heapq.heappop(free)
        else:
            s, top = top, top + 1
        slot_of[dst] = s
        code[i, 1] = s
    return code, top


def compile_program(outputs, leaf_info, *,
                    max_slots: int = MAX_SLOTS) -> Program:
    """Compile `outputs` (a list of `Output`) to one program.

    `leaf_info(node)` gives a row leaf's (section key, column, dim): a Cm's
    committed section, position and dim, a Const's constant section and
    id, x's and Zi's own one-column sections. When the slots would pass
    `max_slots`, the shared nodes' reuse is cut every 256, 64, 16, 4, 1
    terms or outputs until they fit; raises if even 1 does not."""
    for ch in (None, 256, 64, 16, 4, 1):
        c = _Compiler(leaf_info)
        for o in outputs:
            c.analyse(o.expr)
        for i, o in enumerate(outputs):
            if ch is not None and len(outputs) > 1 and i % ch == 0:
                c.memo.clear()
            src = c.emit_chunked(o.expr, ch)
            dim = c.dim[id(o.expr)]
            if o.flag is not None:
                op, arg = (FLAG3 if dim == 3 else FLAG1), o.flag
            else:
                op = STORE3 if dim == 3 else (STORE13 if o.ext else STORE1)
                arg = o.col
            c.ops.append((op, None, src, ("i", arg)))
        code, slots = _allocate(c.ops, c.n_vregs)
        if slots <= max_slots:
            if len(c.sections) > MAX_SECTIONS:
                raise ValueError(f"{len(c.sections)} sections, at most "
                                 f"{MAX_SECTIONS}")
            n_flags = 1 + max((o.flag for o in outputs
                               if o.flag is not None), default=-1)
            return Program(list(outputs), code, list(c.sections),
                           c.uniform_roots, slots, ch, n_flags)
    raise ValueError(f"the program needs {slots} slots at chunk {ch}, more "
                     f"than {max_slots}")


def expr_dim(e: ex.Expr, leaf_info) -> int:
    """1 for a base-field expression, 3 for an extension one (the dim of
    `eval_array`'s result)."""
    c = _Compiler(leaf_info)
    c.analyse(e)
    return c.dim[id(e)]


# ---------------------------------------------------------------------------
# the twin and the dispatch
# ---------------------------------------------------------------------------


def run_plain(prog: Program, sections: dict, uniforms: np.ndarray, out,
              flags=None, *, rows: int, prime_stride: int = 1) -> None:
    """The program over all rows, one torch op per instruction (ops/
    goldilocks, ops/gl3): writes the outputs into `out` ((rows, w) int64)
    and raises `flags[i]` (int32) where flag output i is not zero."""
    dev = out.device
    secs = [sections[k] for k in prog.sections]
    table = gl.from_u64(uniforms, dev) if len(uniforms) else None
    slots: list = [None] * max(prog.n_slots, 1)

    def arg(x, ext):
        if x >= 0:
            return slots[x]
        row = table[-1 - x]
        return row if ext else row[0]

    for op, dst, a, b in prog.code.tolist():
        if op <= LOAD3_NEXT:
            s = secs[a]
            ext = op & 1
            if ext:
                v = s[:, b:b + 3]
            else:
                v = s[:, b] if s.ndim == 2 else s
            if op >= LOAD1_NEXT:
                v = torch.roll(v, -prime_stride, dims=0)
            slots[dst] = v
        elif op in (STORE1, STORE3, STORE13):
            v = arg(a, op == STORE3)
            if op == STORE1:
                out[:, b] = v
            elif op == STORE3:
                out[:, b:b + 3] = v
            else:
                out[:, b] = v
                out[:, b + 1:b + 3] = 0
        elif op in (FLAG1, FLAG3):
            if bool((arg(a, op == FLAG3) != 0).any()):
                flags[b] = 1
        elif op in (NEG1, NEG3):
            slots[dst] = gl.neg(arg(a, op == NEG3))
        else:
            kind, ea, eb = op & ~3, bool(op & 2), bool(op & 1)
            x, y = arg(a, ea), arg(b, eb)
            if kind == MUL:
                if ea and eb:
                    v = gl3.mul(x, y)
                elif ea:
                    v = gl3.mul_base(x, y)
                elif eb:
                    v = gl3.mul_base(y, x)
                else:
                    v = gl.mul(x, y)
            else:
                if ea != eb:
                    x = x if ea else gl3.from_base(x)
                    y = y if eb else gl3.from_base(y)
                v = gl.add(x, y) if kind == ADD else gl.sub(x, y)
            slots[dst] = v


def run(prog: Program, sections: dict, uniforms: np.ndarray, out,
        flags=None, *, rows: int, prime_stride: int = 1) -> None:
    """`prog` over `rows` rows: `dag_eval_kernel` for a CUDA `out`,
    `run_plain` for a CPU one."""
    if out.is_cuda:
        from ..ops import stark_cuda

        stark_cuda.dag_eval(prog, [sections[k] for k in prog.sections],
                            uniforms, out, flags, rows=rows,
                            prime_stride=prime_stride)
    else:
        run_plain(prog, sections, uniforms, out, flags, rows=rows,
                  prime_stride=prime_stride)
