"""Full STARK verifier (counterpart of `zkevm_prover_tpu/stark/verifier.py`).

Plays the role the JS pil-stark verifier plays for the reference C++ prover
(SURVEY.md §4.6: proofs are checked against an independent stack). Checks:

  1. Fiat-Shamir replay (identical schedule to the prover / reference,
     SURVEY.md App. B) — challenges, FRI special_x, query indices
  2. the quotient identity at xi:  C(evals) == q(xi) · Z_H(xi)
  3. Merkle openings of all five layer-0 trees + every FRI layer tree
     (GL: device-batched Poseidon — every path of a tree in one batch per
     level; BN128: the host's arity-16 paths, `merkle_bn128`)
  4. the FRI fold chain per query down to the final polynomial
  5. low-degree of the final polynomial

Raises VerifyError with a reason on the first failed check; returns True.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops import goldilocks as gl
from ..ops import merkle_bn128
from ..ops import poseidon_gl as pos
from ..ops import refmodel as rm
from . import expr as ex
from . import scheme as schememod
from .proof import StarkProof
from .setup import StarkSetup


class VerifyError(AssertionError):
    pass


def _check(cond: bool, what: str):
    if not cond:
        raise VerifyError(what)


# ---------------------------------------------------------------------------
# batched Merkle path verification (device)
# ---------------------------------------------------------------------------


def _roots_from_paths(rows, siblings, idx):
    """rows (Q, W), siblings (Q, L, 4), idx (Q,) -> computed roots (Q, 4)."""
    node = pos.linear_hash(rows)
    q = rows.shape[0]
    zeros = torch.zeros((q, 4), dtype=torch.int64, device=rows.device)
    for lvl in range(siblings.shape[1]):
        sib = siblings[:, lvl]
        left_is_node = (((idx >> lvl) & 1) == 0)[:, None]
        left = torch.where(left_is_node, node, sib)
        right = torch.where(left_is_node, sib, node)
        node = pos.permute(torch.cat([left, right, zeros], dim=1))[:, :4]
    return node


def _verify_tree_queries(root, queries, idxs, what: str, device,
                         hash_type: str = "GL"):
    if len(queries) == 0:
        return
    if hash_type == "BN128":
        root_int = schememod.root_int(root)
        for q, i in zip(queries, idxs):
            _check(merkle_bn128.verify_group_proof(root_int, int(i), q.values,
                                                   q.siblings),
                   f"merkle root mismatch: {what}")
        return
    rows = gl.from_u64(np.stack([np.asarray(q.values) for q in queries]),
                       device)
    sibs = gl.from_u64(np.stack([np.asarray(q.siblings) for q in queries]),
                       device)
    idx = torch.tensor([int(i) for i in idxs], dtype=torch.int64,
                       device=device)
    got = gl.to_u64(_roots_from_paths(rows, sibs, idx))
    want = np.asarray(root, dtype=np.uint64)
    _check(bool(np.all(got == want[None, :])), f"merkle root mismatch: {what}")


# ---------------------------------------------------------------------------
# main verify
# ---------------------------------------------------------------------------


def verify(setup: StarkSetup, verkey, proof: StarkProof, device=None) -> bool:
    """Check `proof` against the setup and verkey; Merkle paths are hashed on
    `device` (CUDA unless asked otherwise)."""
    device = resolve_device(device)
    s = setup
    n, n_ext = s.n, s.n_ext
    steps = s.fri_steps
    sch = schememod.get(getattr(s, "hash_type", "GL"))
    _check(proof.hash_type == sch.name, "hash type mismatch")
    _check(list(proof.fri_steps) == list(steps), "fri step schedule mismatch")
    _check(len(proof.evals) == len(s.ev_map), "evals length mismatch")

    # ---- 0. proof shape (malformed proofs must fail verification, not
    # surface as IndexError/zip-truncation silently verifying fewer
    # openings) ------------------------------------------------------------
    final_pol_arr = np.asarray(proof.final_pol)
    _check(final_pol_arr.ndim == 2 and final_pol_arr.shape == (1 << steps[-1], 3),
           "final_pol shape mismatch")
    _check(len(proof.fri) == len(steps), "fri layer count mismatch")
    for li, layer in enumerate(proof.fri):
        _check(len(layer.queries) == s.n_queries,
               f"fri layer {li} query count mismatch")
        for q in layer.queries:
            if li == 0:
                _check(len(q) == 5, "layer-0 query must open 5 trees")
            else:
                group = 1 << (steps[li - 1] - steps[li])
                _check(np.asarray(q.values).size == 3 * group,
                       f"fri layer {li} group width mismatch")

    # ---- 1. transcript replay --------------------------------------------
    t = sch.Transcript()
    t.put(sch.root_ints(verkey))
    t.put(proof.publics)
    challenges = [None] * 8
    t.put(sch.root_ints(proof.roots[0]))
    challenges[0] = t.get_field3()
    challenges[1] = t.get_field3()
    t.put(sch.root_ints(proof.roots[1]))
    challenges[2] = t.get_field3()
    challenges[3] = t.get_field3()
    t.put(sch.root_ints(proof.roots[2]))
    challenges[4] = t.get_field3()
    t.put(sch.root_ints(proof.roots[3]))
    challenges[7] = t.get_field3()
    for e in proof.evals:
        t.put(list(e))
    challenges[5] = t.get_field3()
    challenges[6] = t.get_field3()
    special_xs = []
    for si in range(len(steps)):
        special_xs.append(t.get_field3())
        if si < len(steps) - 1:
            t.put(sch.root_ints(proof.fri[si + 1].root))
        else:
            for row in np.asarray(proof.final_pol):
                t.put([int(v) for v in row])
    ys = t.get_permutations(s.n_queries, steps[0])

    # ---- 2. quotient identity at xi ----------------------------------------
    xi = challenges[7]
    ev_of = {("cm", e.id, e.prime): proof.evals[k] for k, e in enumerate(s.ev_map)
             if e.type == "cm"}
    ev_of.update({("const", e.id, e.prime): proof.evals[k]
                  for k, e in enumerate(s.ev_map) if e.type == "const"})

    pb = ex.PointBindings(
        cm=lambda cid, prime: ev_of[("cm", cid, prime)],
        const=lambda cid, prime: ev_of[("const", cid, prime)],
        challenges=challenges,
        publics=[int(p) for p in proof.publics],
        x=tuple(xi),
    )
    c_at_xi = ex.eval_point(s.c_combined, pb)
    if not isinstance(c_at_xi, tuple):
        c_at_xi = (c_at_xi % rm.P, 0, 0)

    xi_pow_n = rm.pow3(tuple(xi), n)
    q_at_xi = (0, 0, 0)
    acc = (1, 0, 0)
    for p, qid in enumerate(s.q_ids):
        q_at_xi = rm.add3(q_at_xi, rm.mul3(acc, ev_of[("cm", qid, False)]))
        acc = rm.mul3(acc, xi_pow_n)
    zh = rm.sub3(xi_pow_n, (1, 0, 0))
    _check(c_at_xi == rm.mul3(q_at_xi, zh), "quotient identity fails at xi")

    # ---- 3. Merkle openings -------------------------------------------------
    for ti in range(4):
        _verify_tree_queries(
            proof.roots[ti], [q[ti] for q in proof.fri[0].queries], ys,
            f"cm{ti + 1} tree", device, sch.name,
        )
    _verify_tree_queries(verkey, [q[4] for q in proof.fri[0].queries], ys,
                         "const tree", device, sch.name)
    cur = list(ys)
    for si in range(1, len(steps)):
        cur = [y % (1 << steps[si]) for y in cur]
        _verify_tree_queries(proof.fri[si].root, proof.fri[si].queries, cur,
                             f"fri layer {si} tree", device, sch.name)

    # ---- 4. FRI chain per query ---------------------------------------------
    w_ext = gl.w(steps[0])
    shift = gl.shift()
    # f(y) from layer-0 openings via the FRI-polynomial expression at a point
    col_of = {}
    for cid, info in enumerate(s.cols):
        col_of[cid] = info

    def fri_value_at(qrow, y):
        x = shift * pow(w_ext, y, rm.P) % rm.P

        def cm_bind(cid, prime):
            assert not prime
            info = col_of[cid]
            vals = qrow[info.stage - 1].values  # trees 0..3 = stages 1..4
            if info.dim == 1:
                return int(vals[info.pos])
            return tuple(int(v) for v in vals[info.pos : info.pos + 3])

        def const_bind(cid, prime):
            assert not prime
            return int(qrow[4].values[cid])

        xmxi = rm.sub3((x, 0, 0), tuple(xi))
        wxi = rm.mul3s(tuple(xi), gl.w(s.n_bits))
        xmwxi = rm.sub3((x, 0, 0), wxi)
        pbq = ex.PointBindings(
            cm=cm_bind,
            const=const_bind,
            challenges=challenges,
            publics=[int(p) for p in proof.publics],
            x=x,
            xdivxsubxi=rm.mul3s(rm.inv3(xmxi), x),
            xdivxsubwxi=rm.mul3s(rm.inv3(xmwxi), x),
            evals=list(proof.evals),
        )
        v = ex.eval_point(s.fri_exp, pbq)
        return v if isinstance(v, tuple) else (v % rm.P, 0, 0)

    final_pol = np.asarray(proof.final_pol)
    for qi, y0 in enumerate(ys):
        value = fri_value_at(proof.fri[0].queries[qi], y0)
        y_prev = y0
        for si in range(1, len(steps)):
            y = y0 % (1 << steps[si])
            group_vals = np.asarray(proof.fri[si].queries[qi].values).reshape(-1, 3)
            pos_in_group = y_prev >> steps[si]
            _check(
                tuple(int(v) for v in group_vals[pos_in_group]) == value,
                f"fri chain broken at layer {si}, query {qi}",
            )
            value = _fold_point(group_vals, steps[si - 1], steps[si], y,
                                special_xs[si], s.n_bits_ext)
            y_prev = y
        y_last = y0 % (1 << steps[-1])
        _check(
            tuple(int(v) for v in final_pol[y_last]) == value,
            f"final polynomial mismatch at query {qi}",
        )

    # ---- 5. final polynomial low-degree --------------------------------------
    last_bits = steps[-1]
    max_deg = 1 << (last_bits - (s.n_bits_ext - s.n_bits))
    w_last = gl.w(last_bits)
    for limb in range(3):
        coefs = rm.intt([int(v) for v in final_pol[:, limb]], w_last)
        _check(
            all(c == 0 for c in coefs[max_deg:]),
            "final polynomial exceeds degree bound",
        )
    return True


def _fold_point(group_vals, from_bits: int, to_bits: int, g: int,
                special_x, n_bits_ext: int) -> tuple:
    """Verifier-side single-point FRI fold (mirrors fri.fold_layer math)."""
    n_x = 1 << (from_bits - to_bits)
    assert group_vals.shape == (n_x, 3)
    w_sub = gl.w(from_bits - to_bits)
    coefs = list(
        zip(*[rm.intt([int(v) for v in group_vals[:, l]], w_sub) for l in range(3)])
    )
    shift_inv_e = 1 << (n_bits_ext - from_bits)
    s_inv = pow(gl.shift_inv(), shift_inv_e, rm.P)
    w_inv = pow(gl.w(from_bits), rm.P - 2, rm.P)
    sg = s_inv * pow(w_inv, g, rm.P) % rm.P
    acc = (0, 0, 0)
    factor = rm.mul3s(tuple(special_x), sg)
    for c in reversed(coefs):
        acc = rm.add3(rm.mul3(acc, factor), tuple(c))
    return acc
