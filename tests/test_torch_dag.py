"""The STARK prover's compiled row programs (`stark/dag.py`) against the
JAX package's `zkevm_prover_tpu.stark.expr.eval_array`, bit for bit, on
numpy inputs from `numpy.random.default_rng`: `dag.run_plain` (the twin
that the prover runs on the CPU in place of csrc/stark.cu's
`dag_eval_kernel`) executes each program of a `StarkProver` (the lookups'
f and t, the partial products, num and den, C * Zi, the FRI polynomial's
two sums) over random sections, and each output must equal `eval_array`
of its expression, translated node for node (sharing kept) into the JAX
package's IR. The AIRs: the four toy AIRs, and the small combined batch
AIR (`executor.examples.small_rom_batch`, 2^9: 1,001 constraints) with
C * Zi on 2^12 random extended rows. Also a forced small slot cap, under
which the compiler cuts the reuse of shared nodes into chunks and the
output stays the same. The kernel itself is held against the twin on the
card (tests/test_torch_cuda.py, chip_smoke.py phase 3e)."""

import functools

import re

import numpy as np
import pytest
import torch

from zkevm_prover_tpu.stark import expr as jex
from zkevm_prover_tpu_torch.executor import combined, examples
from zkevm_prover_tpu_torch.ops import goldilocks as gl
from zkevm_prover_tpu_torch.stark import dag
from zkevm_prover_tpu_torch.stark import examples as toy
from zkevm_prover_tpu_torch.stark import expr as ex
from zkevm_prover_tpu_torch.stark.prover import StarkProver
from zkevm_prover_tpu_torch.stark.setup import StarkSetup


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's intra-op pool slows down by orders of magnitude beside the
    other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_jax(e: ex.Expr, memo: dict):
    """`e` as the JAX package's IR, node for node, shared nodes shared."""
    stack = [(e, False)]
    while stack:
        n, done = stack.pop()
        if id(n) in memo:
            continue
        if not done:
            stack.append((n, True))
            stack.extend((c, False) for c in ex._children(n)
                         if id(c) not in memo)
            continue
        kw = {f: getattr(n, f) for f in n.__dataclass_fields__}
        kw = {k: memo[id(v)] if isinstance(v, ex.Expr) else v
              for k, v in kw.items()}
        memo[id(n)] = getattr(jex, type(n).__name__)(**kw)
    return memo[id(e)]


class Inputs:
    """Random sections of a setup over `rows` rows, with challenges,
    publics and evals, as numpy (the JAX side) and torch (the port's)."""

    def __init__(self, setup, rows: int, seed: int):
        rng = np.random.default_rng(seed)
        u = lambda *shape: rng.integers(0, gl.P, shape, dtype=np.uint64)
        self.rows = rows
        self.np = {k: u(rows, w) for k, w in setup.section_width.items()}
        self.np["const"] = u(rows, setup.air.n_constants)
        self.np["x"] = u(rows)
        self.np["zi"] = u(rows)
        self.challenges = u(8, 3)
        self.publics = [int(v) for v in u(len(setup.air.publics))]
        self.evals = u(len(setup.ev_map), 3)
        self.torch = {k: gl.from_u64(v, "cpu") for k, v in self.np.items()}
        self.setup = setup

    def jax_bindings(self, prime_stride: int):
        cols = self.setup.cols

        def cm(cid):
            c = cols[cid]
            a = self.np[c.stage]
            return a[:, c.pos] if c.dim == 1 else a[:, c.pos:c.pos + 3]

        return jex.ArrayBindings(
            cm=cm, const=lambda cid: self.np["const"][:, cid],
            challenges=self.challenges,
            publics=np.array(self.publics, np.uint64), x=self.np["x"],
            zi=self.np["zi"], evals=self.evals, prime_stride=prime_stride)


def run_twin(prog, inp: Inputs, width: int, prime_stride: int):
    out = torch.zeros((inp.rows, width), dtype=torch.int64)
    dag.run(prog, inp.torch, prog.uniform_values(inp.challenges, inp.publics,
                                                 inp.evals), out,
            rows=inp.rows, prime_stride=prime_stride)
    return gl.to_u64(out)


def assert_program_matches_jax(prog, inp: Inputs, prime_stride: int):
    """Every stored output of `prog` equals eval_array of its expression
    (a base value stored as (v, 0, 0) where the output promotes it; a
    row-invariant value broadcast over the rows)."""
    width = max((o.col + 3 for o in prog.outputs), default=0)
    got = run_twin(prog, inp, width, prime_stride)
    memo: dict = {}
    b = inp.jax_bindings(prime_stride)
    for o in prog.outputs:
        want = np.asarray(jex.eval_array(to_jax(o.expr, memo), b),
                          dtype=np.uint64)
        ext = want.ndim >= 1 and want.shape[-1] == 3
        if not ext and o.ext:
            want = np.stack([np.broadcast_to(want, (inp.rows,)),
                             np.zeros(inp.rows, np.uint64),
                             np.zeros(inp.rows, np.uint64)], axis=1)
        w = 3 if (ext or o.ext) else 1
        want = np.broadcast_to(want.reshape(-1, w) if want.ndim else want,
                               (inp.rows, w))
        np.testing.assert_array_equal(got[:, o.col:o.col + w], want,
                                      err_msg=str(o.col))


def programs(prover: StarkProver):
    """The prover's programs: (name, program, extended domain?)."""
    out = [("ft", prover._prog_ft[0], False),
           ("num_den", prover._prog_num_den[0], False),
           ("q", prover._prog_q, True), ("fri", prover._prog_fri, True)]
    if prover._prog_aux is not None:
        out.append(("aux", prover._prog_aux, False))
    return [(n, p, e) for n, p, e in out if p.n_ops]


@pytest.mark.parametrize("name", ["fibonacci", "lookup", "permutation",
                                  "connection"])
def test_toy_air_programs_match_jax(name):
    air, _ = toy.all_air_traces(5)[name]
    prover = StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                         device="cpu")
    s = prover.setup
    for kind, prog, extended in programs(prover):
        rows = s.n_ext if extended else s.n
        inp = Inputs(s, rows, hash(kind) & 0xFFFF)
        assert_program_matches_jax(prog, inp,
                                   prover.blowup if extended else 1)


@functools.lru_cache(maxsize=None)
def _combined():
    _, _, batch = examples.small_rom_batch("cpu")
    air = combined.build_batch_air(batch.rom, batch.n_bits,
                                   include=batch.include)
    return StarkProver(StarkSetup(air, n_queries=8, fri_fold_bits=2),
                       device="cpu")


def test_combined_quotient_matches_jax():
    """C * Zi of the small combined AIR (1,001 constraints folded by
    challenge 4) on 2^12 random extended rows: a program of a few slots
    where eval_array's order keeps about a thousand values live."""
    prover = _combined()
    s = prover.setup
    assert len(s.constraints) == 1001 and s.n_ext == 1 << 12
    prog = prover._prog_q
    assert prog.n_slots <= dag.MAX_SLOTS and prog.chunk is None
    assert_program_matches_jax(prog, Inputs(s, s.n_ext, 1), prover.blowup)


@pytest.mark.parametrize("kind", ["ft", "num_den", "fri"])
def test_combined_programs_match_jax(kind):
    """The small combined AIR's lookup f/t (65 lookups), num/den (68
    grand products) on the trace domain and the FRI sums over its evMap
    with random evals on the extended one."""
    prover = _combined()
    s = prover.setup
    prog = {k: p for k, p, _ in programs(prover)}[kind]
    extended = kind == "fri"
    inp = Inputs(s, s.n_ext if extended else s.n, 2)
    assert_program_matches_jax(prog, inp, prover.blowup if extended else 1)


def test_forced_slot_cap_chunks_and_matches():
    """A Horner chain whose terms reuse ten shared products keeps them
    live across the chain; under a small slot cap the compiler cuts their
    reuse into chunks (recomputing them), and every output stays equal to
    the uncut program's and to eval_array's."""
    air, _ = toy.all_air_traces(5)["permutation"]
    s = StarkSetup(air, n_queries=8, fri_fold_bits=2)
    prover = StarkProver(s, device="cpu")
    cm = [ex.Cm(i) for i in range(s.section_width[1])]
    shared = [cm[j % len(cm)] * cm[(j + 1) % len(cm)] + j for j in range(10)]
    terms = [shared[k % 10] * shared[(3 * k + 1) % 10] - cm[k % len(cm)]
             for k in range(40)]
    chain = terms[0]
    for t in terms[1:]:
        chain = chain * ex.Challenge(4) + t
    outs = [dag.Output(chain, col=0, ext=True),
            dag.Output(shared[0] * ex.Challenge(2), col=3)]
    free = dag.compile_program(outs, prover._leaf, max_slots=64)
    assert free.chunk is None and free.n_slots > 6
    capped = dag.compile_program(outs, prover._leaf, max_slots=6)
    assert capped.chunk is not None and capped.n_slots <= 6
    assert capped.n_ops > free.n_ops      # shared products recomputed
    with pytest.raises(ValueError, match="at chunk 1") as err:
        dag.compile_program(outs, prover._leaf, max_slots=1)
    finest = int(re.search(r"needs (\d+) slots", str(err.value)).group(1))
    assert dag.compile_program(outs, prover._leaf,
                               max_slots=finest).n_slots <= finest
    with pytest.raises(ValueError):       # just below the finest cut's
        dag.compile_program(outs, prover._leaf, max_slots=finest - 1)
    inp = Inputs(s, s.n, 3)
    np.testing.assert_array_equal(run_twin(capped, inp, 6, 1),
                                  run_twin(free, inp, 6, 1))
    assert_program_matches_jax(capped, inp, 1)


def _decode(words: np.ndarray) -> np.ndarray:
    """Program.words back to (op, dst, a, b, c), the kernel's decoding."""
    w = words.astype(np.uint64)

    def field(shift, bits, signed):
        x = ((w >> np.uint64(shift)) & np.uint64((1 << bits) - 1)).astype(
            np.int64)
        return np.where(signed & (x >= 1 << (bits - 1)), x - (1 << bits), x)

    return np.stack([field(0, 6, False), field(6, 6, False),
                     field(12, 17, True), field(29, 17, True),
                     field(46, 17, True)], axis=1)


def test_leaf_table_and_instruction_words():
    """The small combined AIR's C * Zi: no load instructions; each leaf
    word listed once, sorted by (section, next row, column); a GL3 leaf
    operand names three side-by-side words of one column triple; every
    operand names a slot below n_slots, a word of the table or an entry of
    the uniform table; the last slot forwards: each value written there is
    read by the next instruction, and only there; most products are fused
    with the sum that reads them; the 64-bit words decode to the code."""
    prog = _combined()._prog_q
    binary = {k + e for k in (dag.ADD, dag.SUB, dag.MUL) for e in range(4)}
    fused = {k + e for k in (dag.MADD, dag.MSUB, dag.SUBM) for e in range(8)}
    unary = {dag.NEG1, dag.NEG3}
    sinks = {dag.STORE1, dag.STORE3, dag.STORE13, dag.FLAG1, dag.FLAG3}
    code = prog.code.tolist()
    assert {c[0] for c in code} <= binary | fused | unary | sinks
    assert sum(c[0] in fused for c in code) > len(code) // 3
    leaves = [tuple(r) for r in prog.leaves.tolist()]
    assert len(set(leaves)) == len(leaves)
    assert leaves == sorted(leaves, key=lambda r: (r[0], r[2], r[1]))
    n_uni, n_words = len(prog.uniform_roots), len(leaves)
    gl3_uses = 0
    fwd = prog.n_slots - 1
    writes = [i for i, c in enumerate(code) if c[0] not in sinks
              and c[1] == fwd]
    reads = [i for i, c in enumerate(code)
             if fwd in [x for x, _ in dag.operands(*c)]]
    assert writes and [i + 1 for i in writes] == reads
    for i, (op, dst, a, b, c) in enumerate(code):
        if op not in sinks:
            assert 0 <= dst < prog.n_slots
        for x, ext in dag.operands(op, dst, a, b, c):
            if x >= dag.MAX_SLOTS:
                w = x - dag.MAX_SLOTS
                assert w + (3 if ext else 1) <= n_words
                if ext:
                    gl3_uses += 1
                    (s0, c0, n0), (s1, c1, n1), (s2, c2, n2) = \
                        leaves[w:w + 3]
                    assert s0 == s1 == s2 and n0 == n1 == n2
                    assert (c1, c2) == (c0 + 1, c0 + 2)
            elif x >= 0:
                assert x < prog.n_slots
            else:
                assert -1 - x < n_uni
    assert gl3_uses and prog.leaf_reads > n_words
    np.testing.assert_array_equal(_decode(prog.words),
                                  prog.code.astype(np.int64))


def test_leaf_operands_match_jax():
    """Leaves as direct operands: bare base and GL3 leaves stored, on the
    row and on the next one (wrapping past the last rows at a stride of
    3 on a ragged row count), negated, in products with uniform values and
    each other, and a row-invariant output; run_plain == eval_array."""
    air, _ = toy.all_air_traces(5)["permutation"]
    s = StarkSetup(air, n_queries=8, fri_fold_bits=2)
    prover = StarkProver(s, device="cpu")
    base = [c for c in range(len(s.cols)) if s.cols[c].dim == 1]
    ext3 = [c for c in range(len(s.cols)) if s.cols[c].dim == 3]
    a, b, z = ex.Cm(base[0]), ex.Cm(base[1], prime=True), \
        ex.Cm(ext3[0], prime=True)
    outs = [dag.Output(a, col=0), dag.Output(b, col=1),
            dag.Output(z, col=2), dag.Output(-b, col=5, ext=True),
            dag.Output(a * b - z * ex.Challenge(2), col=8),
            dag.Output(z * z + ex.Const(0, prime=True), col=11),
            dag.Output(ex.Challenge(1) + 7, col=14)]
    prog = dag.compile_program(outs, prover._leaf)
    assert prog.n_slots <= 2 and len(prog.leaves) == 2 + 3 + 1
    assert_program_matches_jax(prog, Inputs(s, 1000, 4), 3)


def test_program_of_32_slots_matches_jax():
    """A program whose 30 shared products stay live across two Horner
    chains needs MAX_SLOTS = 32 slots (the products, the chain and the
    forwarding slot), uncut; under a cap of 31 the compiler cuts it; both
    equal eval_array."""
    air, _ = toy.all_air_traces(5)["permutation"]
    s = StarkSetup(air, n_queries=8, fri_fold_bits=2)
    prover = StarkProver(s, device="cpu")
    outs = slot_outputs(s, 30)
    full = dag.compile_program(outs, prover._leaf)
    assert full.n_slots == dag.MAX_SLOTS and full.chunk is None
    cut = dag.compile_program(outs, prover._leaf, max_slots=31)
    assert cut.chunk is not None and cut.n_slots <= 31
    inp = Inputs(s, s.n, 5)
    assert_program_matches_jax(full, inp, 1)
    assert_program_matches_jax(cut, inp, 1)


def slot_outputs(setup, k: int):
    """Two Horner chains over k shared products of committed columns, the
    second in reverse order, so that all k stay live between them."""
    w = setup.section_width[1]
    cm = [ex.Cm(i) for i in range(w)]
    shared = [cm[j % w] * cm[(j + 1) % w] + j for j in range(k)]
    up, down = shared[0], shared[-1]
    for t in shared[1:]:
        up = up * ex.Challenge(4) + t
    for t in shared[-2::-1]:
        down = down * ex.Challenge(3) + t
    return [dag.Output(up, col=0, ext=True), dag.Output(down, col=3, ext=True)]
