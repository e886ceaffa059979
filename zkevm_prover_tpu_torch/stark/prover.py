"""The 5-phase eSTARK prover on the device (torch).

Counterpart of `zkevm_prover_tpu/stark/prover.py` (reference:
Starks::genProof, src/starkpil/starks.cpp:9-395):

  phase 1  commit the stage-1 trace        (LDE + Merkle)
  phase 2  plookup h1/h2                   (sort/segment pipeline)
  phase 3  grand products z                (batch inverse + prefix products)
  phase 4  quotient on the extended coset
  phase 5  openings at xi / w·xi + FRI pol
  FRI      fold/commit/query

Sections are int64 tensors on one device; the Fiat-Shamir transcript stays
on the host. The transcript schedule and every field value match the JAX
prover, so the proof JSON is byte-identical. Each phase evaluates its whole
expression in one pass (`expr.eval_array` frees intermediates as it goes),
where the JAX prover splits phases into chunks to bound XLA's programs.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops import gl3
from ..ops import goldilocks as gl
from ..ops import ntt as nttmod
from . import expr as ex
from . import fri as frimod
from . import scheme as schememod
from .proof import LayerQueries, MerkleQuery, StarkProof
from .setup import StarkSetup


# ---------------------------------------------------------------------------
# device building blocks
# ---------------------------------------------------------------------------


def _lexsort(keys: torch.Tensor) -> torch.Tensor:
    """Row order sorting (R, d) u64 keys lexicographically, the LAST column
    primary (np.lexsort of the columns): chained stable sorts from the least
    significant column up, on keys mapped to signed order."""
    order = torch.arange(keys.shape[0], device=keys.device)
    for i in range(keys.shape[1]):
        _, perm = torch.sort(keys[order, i] ^ gl._SIGN, stable=True)
        order = order[perm]
    return order


def calculate_h1h2(f, t):
    """Plookup h1/h2: (N, d) f/t -> ((N, d), (N, d), ok_flag).

    Semantics of Polinomial::calculateH1H2_ (polinomial.hpp:304-347): the
    multiset t ∪ f ordered by the t-index of each value, split alternately.
    Sort the combined array, propagate the canonical (last) t-occurrence
    through equal-value runs with segment maxima, count f-hits per t-row,
    then rebuild the interleaved sequence with a searchsorted over the
    cumulative counts.
    """
    n, _ = t.shape
    dev = t.device
    comb = torch.cat([t, f], dim=0)
    zeros = torch.zeros(n, dtype=torch.int64, device=dev)
    is_f = torch.cat([zeros, torch.ones(n, dtype=torch.int64, device=dev)])
    tidx = torch.cat([torch.arange(n, device=dev), zeros])
    order = _lexsort(comb)
    sc = comb[order]
    sf = is_f[order]
    sti = tidx[order]
    boundary = torch.cat([torch.ones(1, dtype=torch.int64, device=dev),
                          (sc[1:] != sc[:-1]).any(dim=1).to(torch.int64)])
    seg = torch.cumsum(boundary, 0) - 1
    t_or_neg = torch.where(sf == 1, -1, sti)
    seg_max = torch.full((2 * n,), -1, dtype=torch.int64, device=dev)
    seg_max = seg_max.scatter_reduce(0, seg, t_or_neg, "amax")
    canon = seg_max[seg]
    ok = bool(((sf == 0) | (canon >= 0)).all())  # every f value is in t
    f_cnt = zeros.scatter_add(0, canon.clamp(min=0), sf)
    cum = torch.cumsum(1 + f_cnt, 0)
    j = torch.arange(2 * n, device=dev)
    src = torch.searchsorted(cum, j, right=True)
    seq = t[src]
    return seq[0::2], seq[1::2], ok


def calculate_z(num, den):
    """Grand product z[0]=1, z[i]=prod_{j<i} num_j/den_j as (N, 3).

    Reference: Polinomial::calculateZ (polinomial.hpp:586) — sequential
    there, a batch inversion + log-depth inclusive scan + shift here."""
    num3 = num if num.ndim == 2 else gl3.from_base(num)
    den3 = den if den.ndim == 2 else gl3.from_base(den)
    ratio = gl3.mul(num3, gl3.batch_inverse(den3, axis=0))
    incl = gl.scan_mul(ratio, axis=0, op=gl3.mul)
    return torch.cat([gl3.one((1,), incl.device), incl[:-1]], dim=0)


def _geom3(base3, n):
    """[(1,0,0), base, base^2, ...] for an extension base — (n, 3), built
    by doubling."""
    out = gl3.one((1,), base3.device)
    b = base3
    while out.shape[0] < n:
        out = torch.cat([out, gl3.mul(out, b)], dim=0)
        b = gl3.square(b)
    return out[:n]


def _ext_rows(v, rows: int):
    """An evaluated expression as (rows, 3) extension values."""
    if ex._dim(v) == 1:
        v = gl3.from_base(v)
    return v.expand(rows, 3)


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


class StarkProver:
    """Holds the setup + preprocessed constants; `prove` runs the pipeline.

    Reference analogue: the Starks object, which preloads const pols and
    their Merkle tree at startup (src/starkpil/starks.hpp:75-140).
    `phase_times` holds the seconds of each phase of the last prove, by the
    JAX prover's `_t` labels."""

    def __init__(self, setup: StarkSetup, device=None):
        self.device = resolve_device(device)
        self.setup = setup
        self.scheme = schememod.get(getattr(setup, "hash_type", "GL"))
        s = setup
        self.blowup = 1 << (s.n_bits_ext - s.n_bits)
        self._const_np = (
            np.stack(s.air.const_values, axis=1)
            if s.air.const_values
            else np.zeros((s.n, 0), dtype=np.uint64)
        )
        # x and 1/Z_H on the extended coset (reference: x_2ns, ZhInv)
        self._x_2ns = gl.mul(
            nttmod.geometric_powers(gl.w(s.n_bits_ext), s.n_ext, self.device),
            gl.shift())
        zi_vals = []
        sn = pow(gl.shift(), s.n, gl.P)
        wn = pow(gl.w(s.n_bits_ext), s.n, gl.P)
        for m in range(self.blowup):
            zh = (sn * pow(wn, m, gl.P) - 1) % gl.P
            zi_vals.append(pow(zh, gl.P - 2, gl.P))
        self._zi_2ns = gl.from_u64(np.tile(np.array(zi_vals, np.uint64), s.n),
                                   self.device)
        self.phase_times: dict[str, float] = {}
        self._t_last = None

    # -- preprocessed commitment (lazy) --------------------------------------

    @functools.cached_property
    def const_n(self):
        return gl.from_u64(self._const_np, self.device)

    @functools.cached_property
    def const_2ns(self):
        if not self._const_np.shape[1]:
            return self._zeros(self.setup.n_ext, 0)
        return self._extend(self.const_n)

    @functools.cached_property
    def const_tree(self):
        return self.scheme.commit(self.const_2ns)

    @property
    def verkey(self):
        return self.const_tree.root()

    # -- helpers -------------------------------------------------------------

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=torch.int64, device=self.device)

    def _extend(self, v):
        s = self.setup
        return nttmod.extend_pol(v, s.n_bits, s.n_bits_ext)

    def _col(self, sections, cid):
        info = self.setup.cols[cid]
        arr = sections[info.stage]
        if info.dim == 1:
            return arr[:, info.pos]
        return arr[:, info.pos:info.pos + 3]

    def _bindings(self, sections, consts, challenges, publics, *, ext: bool,
                  x=None, zi=None, evals=None, cm=None):
        return ex.ArrayBindings(
            cm=cm or (lambda cid: self._col(sections, cid)),
            const=lambda cid: consts[:, cid],
            device=self.device,
            challenges=challenges,
            publics=publics,
            x=x,
            zi=zi,
            evals=evals,
            prime_stride=self.blowup if ext else 1,
        )

    def _t(self, label: str):
        """Record the seconds since the previous mark under `label` (the
        reference's TimerStopAndLog(STARK_STEP_*)); waits for the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._t_last is not None:
            self.phase_times[label] = now - self._t_last
        self._t_last = now

    # -- phases --------------------------------------------------------------

    def _phase2(self, cm1_n, challenges, publics):
        """h1/h2 of every lookup; returns (cm2, one ok flag per lookup)."""
        s = self.setup
        b = self._bindings({1: cm1_n}, self.const_n, challenges, publics,
                           ext=False)
        cols, oks = [], []
        for plan in s.lookups:
            fv = ex.eval_array(plan.f_exp, b)
            tv = ex.eval_array(plan.t_exp, b)
            fv = fv[:, None] if fv.ndim == 1 else fv
            tv = tv[:, None] if tv.ndim == 1 else tv
            h1, h2, ok = calculate_h1h2(fv, tv)
            cols += [h1, h2]
            oks.append(ok)
        cm2 = torch.cat(cols, dim=1) if cols else self._zeros(s.n, 0)
        return cm2, oks

    def _phase3(self, cm1_n, cm2_n, challenges, publics):
        s = self.setup
        plans = s.lookups + s.permutations + s.connections
        if not plans:
            return self._zeros(s.n, 0)
        sections = {1: cm1_n, 2: cm2_n}
        aux_vals: dict = {}

        def cm_bind(cid):
            if cid in aux_vals:
                return aux_vals[cid]
            return self._col(sections, cid)

        b = self._bindings(
            sections, self.const_n, challenges, publics, ext=False,
            x=nttmod.geometric_powers(gl.w(s.n_bits), s.n, self.device),
            cm=cm_bind)
        cols = []
        for plan in plans:
            # wide-connection partial products precede their z
            for cid, e in getattr(plan, "aux", []):
                v = ex.eval_array(e, b)
                v = v if v.ndim == 2 else gl3.from_base(v)
                aux_vals[cid] = v
                cols.append(v)
            num = ex.eval_array(plan.num, b)
            den = ex.eval_array(plan.den, b)
            cols.append(calculate_z(num, den))
        return torch.cat(cols, dim=1)

    def _phase4(self, sections_2ns, challenges, publics):
        """Quotient: C = Horner(constraints, challenge 4) on the coset, times
        1/Z_H, split into qDeg degree-<N polynomials each evaluated on the
        coset (reference: INTT -> per-chunk shift^{-pN} scale -> NTT,
        starks.cpp:262-287)."""
        s = self.setup
        b = self._bindings(sections_2ns, self.const_2ns, challenges, publics,
                           ext=True, x=self._x_2ns, zi=self._zi_2ns)
        c_val = _ext_rows(ex.eval_array(s.c_combined, b), s.n_ext)
        q = gl3.mul(c_val, gl3.from_base(self._zi_2ns))
        coefs = nttmod.intt(q, s.n_bits_ext)  # \hat c_j = c_j shift^j
        del q
        shift_in = pow(gl.shift_inv(), s.n, gl.P)
        pad = self._zeros(s.n_ext - s.n, 3)
        chunks = []
        for p in range(s.q_deg):
            c = gl.mul(coefs[p * s.n:(p + 1) * s.n], pow(shift_in, p, gl.P))
            chunks.append(nttmod.ntt(torch.cat([c, pad]), s.n_bits_ext))
        return torch.cat(chunks, dim=1)  # (NExt, 3*qDeg)

    def _phase5_evals(self, sections_2ns, xi):
        """Openings at xi and w·xi: Lagrange-at-xi weights over the strided
        coset rows (starks.cpp:302-330), LEv = INTT(geom(xi/shift))."""
        s = self.setup
        shift_i = gl.shift_inv()
        xi_s = gl3.mul_base(xi, shift_i)
        w_xi_s = gl3.mul_base(gl3.mul_base(xi, gl.w(s.n_bits)), shift_i)
        lev = nttmod.intt(_geom3(xi_s, s.n), s.n_bits)
        lpev = nttmod.intt(_geom3(w_xi_s, s.n), s.n_bits)
        out = []
        for e in s.ev_map:
            if e.type == "cm":
                vals = self._col(sections_2ns, e.id)
            else:
                vals = self.const_2ns[:, e.id]
            vals = vals[::self.blowup]
            weights = lpev if e.prime else lev
            if vals.ndim == 1:
                prod = gl.mul(weights, vals[:, None])  # (N, 3)
            else:
                prod = gl3.mul(weights, vals)
            out.append(gl.modsum(prod, 0))
        return torch.stack(out)  # (nEv, 3)

    @functools.cached_property
    def _fri_exprs(self):
        """Horner combinations of the evMap terms: (non-prime with v1, prime
        with v2)."""
        V1, V2 = ex.Challenge(5), ex.Challenge(6)
        e1 = e2 = None
        for k, e in enumerate(self.setup.ev_map):
            leaf = ex.Cm(e.id) if e.type == "cm" else ex.Const(e.id)
            term = leaf - ex.Eval(k)
            if e.prime:
                e2 = term if e2 is None else e2 * V2 + term
            else:
                e1 = term if e1 is None else e1 * V1 + term
        return e1, e2

    def _phase5_fri(self, sections_2ns, challenges, publics, evals):
        s = self.setup
        bnd = self._bindings(sections_2ns, self.const_2ns, challenges, publics,
                             ext=True, x=self._x_2ns, zi=self._zi_2ns,
                             evals=evals)
        accs = [self._zeros(s.n_ext, 3) if e is None
                else _ext_rows(ex.eval_array(e, bnd), s.n_ext)
                for e in self._fri_exprs]
        self._t("ph5_fri_chunk0")
        x = self._x_2ns
        xi3 = challenges[7]
        wxi3 = gl3.mul_base(xi3, gl.w(s.n_bits))
        xs = gl3.sub(gl3.from_base(x), xi3)
        xws = gl3.sub(gl3.from_base(x), wxi3)
        # paired inversion: one gl3.inv for both divisors
        pair_inv = gl3.inv(gl3.mul(xs, xws))
        xdxx = gl3.mul_base(gl3.mul(pair_inv, xws), x)
        xdwx = gl3.mul_base(gl3.mul(pair_inv, xs), x)
        out = gl3.add(gl3.mul(accs[0], xdxx), gl3.mul(accs[1], xdwx))
        self._t("ph5_fri_finish")
        return out

    def _fold(self, from_bits: int, to_bits: int, vals, special_x):
        s = self.setup
        si = s.fri_steps.index(to_bits)
        shift_inv = frimod.coset_shift_inv_at(si, s.n_bits_ext, s.fri_steps)
        w_inv = pow(gl.w(from_bits), gl.P - 2, gl.P)
        return frimod.fold_layer(vals, from_bits - to_bits, special_x,
                                 shift_inv, w_inv)

    def _stages_1_2(self, cm1_n, publics, publics_dev,
                    mark=lambda label: None):
        """Phases 1 and 2 under the Fiat-Shamir transcript, shared by prove()
        and check_constraints(quick=False) so that both draw the same
        challenges: seed the transcript with the verkey and publics, extend
        and commit stage 1, draw challenges 0-1, h1/h2, extend and commit
        stage 2, draw challenges 2-3. `mark(label)` is called after each
        step (prove's phase timer). Returns (transcript, challenges (8, 3)
        uint64, cm1_2ns, tree1, cm2_n, lookup ok flags, cm2_2ns, tree2)."""
        s = self.setup
        transcript = self.scheme.Transcript()
        transcript.put(self.scheme.root_ints(self.verkey))
        transcript.put(publics)
        mark("setup_const_tree")

        challenges = np.zeros((8, 3), dtype=np.uint64)

        # ---- phase 1
        cm1_2ns = self._extend(cm1_n)
        mark("ph1_extend")
        tree1 = self.scheme.commit(cm1_2ns)
        transcript.put(self.scheme.root_ints(tree1.root()))
        mark("ph1_commit")

        # ---- phase 2
        challenges[0] = transcript.get_field3()
        challenges[1] = transcript.get_field3()
        cm2_n, oks = self._phase2(cm1_n, gl.from_u64(challenges, self.device),
                                  publics_dev)
        mark("ph2_h1h2")
        cm2_2ns = (self._extend(cm2_n) if s.section_width[2]
                   else self._zeros(s.n_ext, 0))
        tree2 = self.scheme.commit(cm2_2ns)
        transcript.put(self.scheme.root_ints(tree2.root()))
        mark("ph2_commit")
        challenges[2] = transcript.get_field3()
        challenges[3] = transcript.get_field3()
        return (transcript, challenges, cm1_2ns, tree1, cm2_n, oks, cm2_2ns,
                tree2)

    # -- satisfiability check --------------------------------------------------

    def check_constraints(self, cm1_values, publics=None,
                          quick: bool = False) -> list:
        """Diagnostic: run phases 1-3 and evaluate every constraint on the
        trace domain; returns the indices of violated constraints, then
        `"plookup:i"` for each lookup i whose f values are not all in t
        (empty = ok). The role of the reference's zkassert in calculateZ
        (polinomial.hpp:606).

        quick=True takes the JAX package's fixed pseudo-random challenges
        (`default_rng(0xC0FFEE)`) instead of the transcript's and skips the
        LDE and Merkle commits: identities that hold for the honest
        transcript hold identically in the challenge variables, so this is
        a sound satisfiability check, and both packages return the same
        list for the same trace. Runs on the prover's device."""
        s = self.setup
        dev = self.device
        cm1_values = np.asarray(cm1_values, dtype=np.uint64)
        if publics is None:
            publics = [
                int(cm1_values[row, cid]) for (_, cid, row) in s.air.publics
            ]
        publics_dev = gl.from_u64(np.array(publics, dtype=np.uint64), dev)
        cm1_n = gl.from_u64(cm1_values, dev)
        if quick:
            rng = np.random.default_rng(0xC0FFEE)
            challenges = rng.integers(1, 1 << 63, size=(8, 3)).astype(
                np.uint64)
            ch = gl.from_u64(challenges, dev)
            cm2_n, oks = self._phase2(cm1_n, ch, publics_dev)
        else:
            stages = self._stages_1_2(cm1_n, publics, publics_dev)
            challenges, cm2_n, oks = stages[1], stages[4], stages[5]
            ch = gl.from_u64(challenges, dev)
        cm3_n = self._phase3(cm1_n, cm2_n, ch, publics_dev)
        b = self._bindings(
            {1: cm1_n, 2: cm2_n, 3: cm3_n}, self.const_n, ch, publics_dev,
            ext=False,
            x=nttmod.geometric_powers(gl.w(s.n_bits), s.n, dev))
        bad: list = [i for i, c in enumerate(s.constraints)
                     if bool((ex.eval_array(c, b) != 0).any())]
        bad += [f"plookup:{i}" for i, ok in enumerate(oks) if not ok]
        return bad

    # -- main entry ------------------------------------------------------------

    def prove(self, cm1_values, publics=None) -> StarkProof:
        """Generate a proof for stage-1 trace `cm1_values` ((N, nCm1) uint64
        numpy)."""
        s = self.setup
        dev = self.device
        cm1_values = np.asarray(cm1_values, dtype=np.uint64)
        assert cm1_values.shape == (s.n, s.air.n_cm1)
        if publics is None:
            publics = [
                int(cm1_values[row, cid]) for (_, cid, row) in s.air.publics
            ]
        publics_dev = gl.from_u64(np.array(publics, dtype=np.uint64), dev)
        self.phase_times = {}
        self._t_last = None
        self._t("start")
        cm1_n = gl.from_u64(cm1_values, dev)

        (transcript, challenges, cm1_2ns, tree1, cm2_n, oks, cm2_2ns,
         tree2) = self._stages_1_2(cm1_n, publics, publics_dev, self._t)
        if not all(oks):
            raise ValueError("plookup violation: f value not present in t")

        # ---- phase 3
        ch = gl.from_u64(challenges, dev)
        cm3_n = self._phase3(cm1_n, cm2_n, ch, publics_dev)
        self._t("ph3_z")
        del cm2_n, cm1_n   # trace-domain copies are dead once cm3 exists
        cm3_2ns = (self._extend(cm3_n) if s.section_width[3]
                   else self._zeros(s.n_ext, 0))
        del cm3_n
        tree3 = self.scheme.commit(cm3_2ns)
        transcript.put(self.scheme.root_ints(tree3.root()))
        self._t("ph3_commit")

        # ---- phase 4
        challenges[4] = transcript.get_field3()
        ch = gl.from_u64(challenges, dev)
        sections_2ns = {1: cm1_2ns, 2: cm2_2ns, 3: cm3_2ns}
        cm4_2ns = self._phase4(sections_2ns, ch, publics_dev)
        self._t("ph4_quotient")
        tree4 = self.scheme.commit(cm4_2ns)
        transcript.put(self.scheme.root_ints(tree4.root()))
        self._t("ph4_commit")

        # ---- phase 5
        challenges[7] = transcript.get_field3()
        ch = gl.from_u64(challenges, dev)
        sections_2ns[4] = cm4_2ns
        evals_dev = self._phase5_evals(sections_2ns, ch[7])
        evals_np = gl.to_u64(evals_dev)
        self._t("ph5_evals")
        for e in evals_np:
            transcript.put([int(v) for v in e])
        challenges[5] = transcript.get_field3()
        challenges[6] = transcript.get_field3()
        ch = gl.from_u64(challenges, dev)
        fri_pol = self._phase5_fri(sections_2ns, ch, publics_dev, evals_dev)

        # ---- FRI fold/commit
        # The reference squeezes special_x at the top of EVERY step iteration
        # (including the si=0 copy, friProve.cpp:29-30); special_xs[si] folds
        # layer si-1 -> si for si >= 1.
        steps = s.fri_steps
        layers = [fri_pol]
        layer_trees = [None]
        layer_roots = [None]
        special_xs = []
        for si in range(len(steps)):
            special_xs.append(transcript.get_field3())
            if si > 0:
                sx = gl.from_u64(np.array(special_xs[si], np.uint64), dev)
                layers.append(self._fold(steps[si - 1], steps[si],
                                         layers[si - 1], sx))
            if si < len(steps) - 1:
                t = self.scheme.commit(
                    frimod.group_for_tree(layers[si], steps[si + 1]))
                layer_trees.append(t)
                layer_roots.append(t.root())
                transcript.put(self.scheme.root_ints(t.root()))
            else:
                for row in gl.to_u64(layers[si]):
                    transcript.put([int(v) for v in row])
        self._t("fri_folds")

        # ---- queries
        ys = transcript.get_permutations(s.n_queries, steps[0])
        trees0 = [tree1, tree2, tree3, tree4, self.const_tree]
        q0 = [[MerkleQuery(*t.get_group_proof(int(y))) for t in trees0]
              for y in ys]
        fri_layers = [LayerQueries(None, q0)]
        cur = list(ys)
        for si in range(1, len(steps)):
            cur = [y % (1 << steps[si]) for y in cur]
            qs = [MerkleQuery(*layer_trees[si].get_group_proof(int(y)))
                  for y in cur]
            fri_layers.append(
                LayerQueries(self.scheme.store_root(layer_roots[si]), qs))
        self._t("queries")

        return StarkProof(
            roots=[self.scheme.store_root(t.root())
                   for t in (tree1, tree2, tree3, tree4)],
            evals=[tuple(int(v) for v in e) for e in evals_np],
            fri=fri_layers,
            final_pol=gl.to_u64(layers[-1]),
            publics=list(publics),
            n_queries=s.n_queries,
            fri_steps=list(steps),
            hash_type=self.scheme.name,
        )
