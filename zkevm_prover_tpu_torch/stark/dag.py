"""Constraint-expression DAGs compiled to one program for an interpreter
kernel, and the program's plain twin.

`compile_program` turns `expr.Expr` outputs into a `Program`: a list of
five-int instructions over per-row value slots and leaf words.
`dag_eval_kernel` (csrc/stark.cu, bound in `ops/stark_cuda.py`) runs it
with one thread per row; `run_plain` runs the same instructions with one
torch op (of `ops/goldilocks` and `ops/gl3`) per instruction over all
rows. `run` picks the kernel for a CUDA output and the twin for a CPU one.
Both give what `expr.eval_array` gives, bit for bit: every operation is the
canonical field operation that `eval_array` applies to the same operand
kinds (base + ext promotes the base, base x ext is `gl3.mul_base`,
negation is componentwise, a row-invariant value broadcasts over the
rows).

The compiler:
  * evaluates row-invariant subtrees (challenges, publics, numbers, evals
    and what they make) once on the host, in `Program.uniform_values`: the
    program reads them from a small table;
  * lists the program's leaf columns (committed, constant, x, Zi, each on
    its row or on the next one) once, as `Program.leaves`: one entry per
    word, a GL3 column's three words side by side, sorted by section, next
    row and column. The kernel gathers a tile of rows of these words into
    a column-major scratch, and an instruction reads a leaf as an operand
    where it is used: no instruction loads it and no slot holds it;
  * orders the row-varying nodes by Sethi-Ullman need (the child that needs
    more slots first), so a Horner sum over a thousand constraints keeps
    its accumulator and one constraint's values live, where
    `eval_array`'s order keeps every constraint's value live until the
    chain's bottom is reached;
  * evaluates a node shared by identity once;
  * gives slots by last use (a freed slot is taken again by the next
    result), and one forwarding slot to every result that only the next
    instruction reads;
  * cuts the reuse of shared nodes every `chunk` Horner terms or outputs
    when the slots would pass `max_slots`: a later chunk computes a shared
    node again rather than keeping it live. The role of the JAX package's
    `_C_CHUNK` (stark/prover.py `_phase4_chunk_fns`); here the chunks stay
    in one program and one launch, and the Horner chain itself runs on
    unchanged, so the result is the same field element by construction.

Instructions are `(op, dst, a, b, c)` int32s. An operand in
[0, MAX_SLOTS) is a slot, >= MAX_SLOTS the leaf word `operand - MAX_SLOTS`
(a GL3 operand its three words from there), < 0 the uniform table's entry
`-1 - operand`. A MUL whose one reader is the ADD or SUB right after it
fuses with it (MADD a * b + c, MSUB a * b - c, SUBM c - a * b; the compiler
puts such a product's multiply right before its sum where that holds no
more slots). Stores and flags take an operand in `a` and an output column
or flag index in `b`. The kernel reads each instruction as one 64-bit word
(`Program.words`): op and dst 6 bits each, a, b and c 17-bit two's
complement fields.
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
STORE1, STORE3, STORE13 = 4, 5, 6     # STORE13: a base value as (v, 0, 0)
FLAG1, FLAG3 = 7, 8
NEG1, NEG3 = 9, 10
ADD, SUB, MUL = 16, 20, 24            # + 2 * (a is ext) + (b is ext)
# a product and a sum in one instruction: a * b + c, a * b - c, c - a * b
# (+ 4 * (a is ext) + 2 * (b is ext) + (c is ext))
MADD, MSUB, SUBM = 32, 40, 48

# the slots of one row in dag_eval_kernel's shared slot file
# (csrc/stark.cu MAX_SLOTS); operands from here on name leaf words
MAX_SLOTS = 32
# an operand's field in the kernel's 64-bit instruction word
_FIELD = 1 << 17

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
    """A compiled program: its `outputs`, `code` (n, 5) int32
    instructions, the section keys its leaves name by index, its leaf
    words `leaves` (w, 3) int32 (section index, column, next row?), the
    row-invariant roots whose values fill the uniform table, the slots it
    needs, the chunk it was cut at (None: not cut) and its flag count."""

    outputs: list
    code: np.ndarray
    sections: list
    leaves: np.ndarray
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

    @property
    def words(self) -> np.ndarray:
        """The instructions as the kernel reads them, one uint64 each:
        op | dst << 6 | (a mod 2^17) << 12 | (b mod 2^17) << 29 |
        (c mod 2^17) << 46."""
        c = (self.code.astype(np.int64) % _FIELD).astype(np.uint64)
        return (c[:, 0] | c[:, 1] << 6 | c[:, 2] << 12 | c[:, 3] << 29
                | c[:, 4] << 46)

    def device_code(self, device) -> torch.Tensor:
        """`words` as an int64 tensor on `device` (copied once)."""
        key = str(device)
        if key not in self._device_code:
            self._device_code[key] = torch.from_numpy(
                self.words.view(np.int64)).to(device)
        return self._device_code[key]

    @property
    def n_ops(self) -> int:
        return len(self.code)

    @property
    def leaf_reads(self) -> int:
        """Leaf words the instructions read per row (a GL3 operand three)."""
        n = 0
        for ins in self.code.tolist():
            for x, ext in operands(*ins):
                n += (3 if ext else 1) if x >= MAX_SLOTS else 0
        return n


def operands(op, dst, a, b, c):
    """(operand, is ext) of each value an instruction reads."""
    if op in (STORE1, STORE3, STORE13, FLAG1, FLAG3, NEG1, NEG3):
        return ((a, op in (STORE3, FLAG3, NEG3)),)
    if op >= MADD:
        return ((a, bool(op & 4)), (b, bool(op & 2)), (c, bool(op & 1)))
    return ((a, bool(op & 2)), (b, bool(op & 1)))


def product_dims(op) -> tuple[int, int] | None:
    """The dims of the product an instruction forms (MUL and the fused
    ops), or None."""
    if op >= MADD:
        return (3 if op & 4 else 1, 3 if op & 2 else 1)
    if op & ~3 == MUL:
        return (3 if op & 2 else 1, 3 if op & 1 else 1)
    return None


class _Compiler:
    def __init__(self, leaf_info):
        self.leaf_info = leaf_info
        self.uniform: dict[int, bool] = {}
        self.dim: dict[int, int] = {}
        self.need: dict[int, int] = {}
        self.sections: list = []
        self.uniform_roots: list = []
        self.uniform_index: dict = {}
        self.leaf_items: dict = {}   # (section, next, col, dim) -> index
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
                u, d, need = False, self.leaf_info(n)[2], 0
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

    def leaf(self, n):
        """The leaf item of a row leaf: one per (section, next row?,
        column, dim), however often it is read."""
        key, col, dim = self.leaf_info(n)
        item = (self._section(key), int(getattr(n, "prime", False)), col,
                dim)
        return ("l", self.leaf_items.setdefault(item, len(self.leaf_items)))

    def leaf_words(self):
        """(each item's first word, the (w, 3) word table): items sorted
        by section, next row and column, a GL3 item's words side by
        side, so that a tile's gather reads runs of adjacent columns."""
        first, words = {}, []
        for item in sorted(self.leaf_items):
            sec, nxt, col, dim = item
            first[self.leaf_items[item]] = len(words)
            words += [(sec, col + k, nxt) for k in range(dim)]
        return first, np.array(words, dtype=np.int32).reshape(-1, 3)

    def emit(self, n):
        """Operand holding node `n`'s value, emitting what computes it."""
        k = id(n)
        if self.uniform[k]:
            return self.operand(n)
        if isinstance(n, _LEAVES):
            return self.leaf(n)
        if k in self.memo:
            return ("v", self.memo[k])
        kids = ex._children(n)
        # inner children by need first (leaves and uniform values emit
        # nothing)
        inner = sorted((c for c in kids if not isinstance(c, _LEAVES)),
                       key=lambda c: -self.need[id(c)])
        defer = self.deferred_product(n, inner)
        got = {}
        for c in inner:
            if c is defer:
                ops = {id(k): self.emit(k) for k in sorted(
                    ex._children(c), key=lambda k: -self.need[id(k)])}
            else:
                got[id(c)] = self.emit(c)
        if defer is not None:
            got[id(defer)] = self.op(defer, ops[id(defer.a)],
                                     ops[id(defer.b)])
        for c in kids:
            if id(c) not in got:
                got[id(c)] = self.emit(c)
        return self.op(n, got[id(n.a)], got.get(id(getattr(n, "b", None))))

    def deferred_product(self, n, inner):
        """The product operand of a sum `n` whose multiply can wait until
        right before the sum (its operands emitted in their turn), so that
        the two fuse: not yet computed, and holding at most one slot for its
        operands, as its result would."""
        if not isinstance(n, (ex.Add, ex.Sub)):
            return None
        for c in reversed(inner):
            if isinstance(c, ex.Mul) and not self.uniform[id(c)] \
                    and id(c) not in self.memo and sum(
                    not self.uniform[id(k)] and not isinstance(k, _LEAVES)
                    for k in ex._children(c)) <= 1:
                return c
        return None

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
            t = self.emit(term)     # first, so that the multiply and the
            m = self.op(mul, acc, self.operand(mul.b))  # sum fuse
            acc = self.op(add, m, t)
        return acc


def _fuse(ops):
    """Each MUL whose one reader is the ADD or SUB right after it, with
    that ADD or SUB, as one MADD, MSUB or SUBM; every op as (op, dst, a, b,
    c), c None but for a fused op."""
    uses: dict = {}
    for _, _, a, b in ops:
        for x in (a, b):
            if x[0] == "v":
                uses[x[1]] = uses.get(x[1], 0) + 1
    out, i = [], 0
    while i < len(ops):
        op, dst, a, b = ops[i]
        if op & ~3 == MUL and i + 1 < len(ops) and uses[dst] == 1:
            op2, dst2, a2, b2 = ops[i + 1]
            m = ("v", dst)
            if op2 & ~3 in (ADD, SUB) and m in (a2, b2):
                kind = MADD if op2 & ~3 == ADD else (
                    MSUB if a2 == m else SUBM)
                z, ez = (b2, op2 & 1) if a2 == m else (a2, op2 >> 1 & 1)
                out.append((kind + 2 * (op & 3) + ez, dst2, a, b, z))
                i += 2
                continue
        out.append((op, dst, a, b, None))
        i += 1
    return out


def _allocate(ops, n_vregs, leaf_word):
    """Slots by last use: (code (n, 5) int32, slots used). A result that
    only the next instruction reads goes to one forwarding slot, the last
    (each such value is read before the next one is written); a leaf
    item's operand is MAX_SLOTS + its first word (`leaf_word`)."""
    last = [-1] * n_vregs
    readers: dict = {}
    for i, (_, _, *xs) in enumerate(ops):
        for x in xs:
            if x is not None and x[0] == "v":
                last[x[1]] = i
                readers.setdefault(x[1], set()).add(i)
    free: list[int] = []
    slot_of = {}
    top = 0
    forward = -1 - _FIELD           # placeholder for the forwarding slot
    code = np.zeros((len(ops), 5), dtype=np.int32)

    def enc(x):
        if x is None:
            return 0
        kind, v = x
        if kind == "v":
            return slot_of[v]
        if kind == "u":
            return -1 - v
        if kind == "l":
            return MAX_SLOTS + leaf_word[v]
        return v

    for i, (op, dst, *xs) in enumerate(ops):
        code[i, 0] = op
        code[i, 2:] = [enc(x) for x in xs]
        for x in set(xs):
            if x is not None and x[0] == "v" and last[x[1]] == i \
                    and slot_of[x[1]] != forward:
                heapq.heappush(free, slot_of[x[1]])
        if dst is None:
            continue
        if last[dst] < 0:
            raise AssertionError("a value nothing reads")
        if readers[dst] == {i + 1}:
            s = forward
        elif free:
            s = heapq.heappop(free)
        else:
            s, top = top, top + 1
        slot_of[dst] = s
        code[i, 1] = s
    used = code[:, 1:] == forward
    if used.any():
        code[:, 1:][used] = top
        top += 1
    return code, top


def compile_program(outputs, leaf_info, *,
                    max_slots: int = MAX_SLOTS) -> Program:
    """Compile `outputs` (a list of `Output`) to one program.

    `leaf_info(node)` gives a row leaf's (section key, column, dim): a Cm's
    committed section, position and dim, a Const's constant section and
    id, x's and Zi's own one-column sections. When the slots would pass
    `max_slots` (at most MAX_SLOTS: operands from there on name leaf
    words), the shared nodes' reuse is cut every 256, 64, 16, 4, 1 terms
    or outputs until they fit; raises if even 1 does not."""
    max_slots = min(max_slots, MAX_SLOTS)
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
        first, leaves = c.leaf_words()
        code, slots = _allocate(_fuse(c.ops), c.n_vregs, first)
        if slots <= max_slots:
            if len(code) and not (-_FIELD // 2 <= code[:, 2:].min()
                                  and code[:, 2:].max() < _FIELD // 2):
                raise ValueError("an operand, output column or flag past "
                                 "the instruction word's 17-bit fields")
            n_flags = 1 + max((o.flag for o in outputs
                               if o.flag is not None), default=-1)
            return Program(list(outputs), code, list(c.sections), leaves,
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
    leaves = prog.leaves.tolist()

    def arg(x, ext):
        if x >= MAX_SLOTS:
            sec, col, nxt = leaves[x - MAX_SLOTS]
            s = secs[sec]
            if ext:
                v = s[:, col:col + 3]
            else:
                v = s[:, col] if s.ndim == 2 else s
            return torch.roll(v, -prime_stride, dims=0) if nxt else v
        if x >= 0:
            return slots[x]
        row = table[-1 - x]
        return row if ext else row[0]

    def product(x, y, ea, eb):
        if ea and eb:
            return gl3.mul(x, y)
        if ea:
            return gl3.mul_base(x, y)
        if eb:
            return gl3.mul_base(y, x)
        return gl.mul(x, y)

    def total(x, y, ea, eb, sub):
        if ea != eb:
            x = x if ea else gl3.from_base(x)
            y = y if eb else gl3.from_base(y)
        return gl.sub(x, y) if sub else gl.add(x, y)

    for op, dst, a, b, c in prog.code.tolist():
        if op in (STORE1, STORE3, STORE13):
            v = arg(a, op == STORE3)
            if op == STORE1:
                out[:, b] = v
            elif op == STORE3:
                out[:, b:b + 3] = v
            else:
                out[:, b] = v
                out[:, b + 1:b + 3] = 0
            continue
        if op in (FLAG1, FLAG3):
            if bool((arg(a, op == FLAG3) != 0).any()):
                flags[b] = 1
            continue
        if op in (NEG1, NEG3):
            v = gl.neg(arg(a, op == NEG3))
        elif op >= MADD:
            kind = op & ~7
            ea, eb, ec = bool(op & 4), bool(op & 2), bool(op & 1)
            m = product(arg(a, ea), arg(b, eb), ea, eb)
            z = arg(c, ec)
            if kind == SUBM:
                v = total(z, m, ec, ea or eb, True)
            else:
                v = total(m, z, ea or eb, ec, kind == MSUB)
        else:
            kind, ea, eb = op & ~3, bool(op & 2), bool(op & 1)
            x, y = arg(a, ea), arg(b, eb)
            if kind == MUL:
                v = product(x, y, ea, eb)
            else:
                v = total(x, y, ea, eb, kind == SUB)
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
