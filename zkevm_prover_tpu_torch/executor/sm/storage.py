"""Storage SM — SMT get/set walk replay.

Port of `zkevm_prover_tpu/executor/sm/storage.py` (host-only numpy): the
same AIR, trace and emitted PoseidonG / ClimbKey actions.

Reference: src/sm/storage/storage_executor.cpp (1.3k LoC) — a micro-ROM
machine (config/scripts/storage_sm_rom.json) that replays SmtActions,
emitting Poseidon requests for node hashes and ClimbKey requests for key
reconstruction, with per-mode code paths (isSetUpdate / isSetInsertFound /
isSetDeleteFound / ... selected by free-input functions,
storage_executor.cpp:77-170).

TPU-first redesign: instead of a micro-ROM with mode dispatch, the trace is
a *double tree walk*. Every action (get or set) contributes one row per
level: the OLD tree and the NEW tree are walked simultaneously from their
roots along the key's path bits, reading node preimages from the
content-addressed database (both trees' nodes coexist there, so update /
insertFound / deleteFound shapes fall out of the walk itself — no case
analysis). Per-row constraints enforce:

  * parent→child chaining for both trees (the committed child hash selected
    by the path bit becomes the next row's root),
  * untouched-sibling equality (the non-path child is identical in OLD and
    NEW parents) — the write only changes the path,
  * key-bit consumption (RKEY climbs down one bit per level, lane selected
    by a rotating one-hot; the no-wrap side is delegated to the ClimbKey SM
    via emitted actions, reference climb_key_executor.cpp),
  * leaf shape (leaf preimage lanes carry the remaining key + value hash),
  * get-actions force NEW == OLD,
  * root chaining across actions (new_root of action k = old_root of k+1).

Node-hash correctness (root = Poseidon(children|cap)) is emitted as
PoseidonG actions and host-bound, pending the cross-SM lookup milestone —
the same binding status as the Main SM's co-processor dispatches.
"""

from __future__ import annotations

import numpy as np

from ...ops import goldilocks as gl
from ...stark import expr as ex
from ...stark.air import AIR
from ...hashdb import key_utils as ku

P = gl.P
ZERO4 = (0, 0, 0, 0)
CAP_LEAF = (1, 0, 0, 0)

# committed columns, in trace order
COLS = (
    [f"RKEY{j}" for j in range(4)]
    + ["BIT", "LEVEL"]
    + [f"LSEL{j}" for j in range(4)]
    + [f"OROOT{j}" for j in range(4)] + [f"NROOT{j}" for j in range(4)]
    + [f"OL{j}" for j in range(4)] + [f"OR{j}" for j in range(4)]
    + [f"NL{j}" for j in range(4)] + [f"NR{j}" for j in range(4)]
    + [f"VLOW{j}" for j in range(4)] + [f"VHIGH{j}" for j in range(4)]
    + [f"ANROOT{j}" for j in range(4)]   # action-level new root, held
    + ["OACT", "NACT", "OLEAF", "NLEAF", "FOUNDO", "FOUNDN",
       "ONODE", "NNODE", "SAME", "LAST", "START", "CHAIN"]
    # foreign-leaf key-inequality witnesses (one set per tree side): a
    # leaf row without FOUND must exhibit a lane where the leaf's
    # remaining key differs from the query's (smt.cpp get semantics — a
    # mismatched leaf proves absence only if its key actually differs)
    + [f"OKNEQ{j}" for j in range(4)] + ["OKINV"]
    + [f"NKNEQ{j}" for j in range(4)] + ["NKINV"]
    # PHC: suffix count of the PoseidonG permutations this action consumes
    # (node hashes + found-leaf value preimages); at START it equals the
    # action total — the reference's proofHashCounter whose +2 completion
    # is the Main SM's incCounter (main_executor.cpp:1154,1393)
    + ["PHC"]
)


def build_air(n_bits: int) -> AIR:
    n = 1 << n_bits
    air = AIR("storage", n_bits)
    handles = air.committed(*COLS)
    c = dict(zip(COLS, handles))

    def nxt(name):
        return ex.Cm(c[name].id, True)

    l1 = air.lagrange_first()
    NL = 1 - c["LAST"]  # gates every within-action transition

    for f in ("BIT", "OACT", "NACT", "OLEAF", "NLEAF", "FOUNDO", "FOUNDN",
              "ONODE", "NNODE", "SAME", "LAST", "START", "CHAIN",
              "LSEL0", "LSEL1", "LSEL2", "LSEL3"):
        air.require_zero(c[f] * (1 - c[f]))

    # START mirrors LAST of the previous row (cyclic; padding rows carry
    # LAST=1 so the wrap lands on START=1)
    air.require_zero(nxt("START") - c["LAST"])
    air.require_zero(l1 * (1 - c["START"]))

    # action-start shape: level 0, lane selector at lane 0
    air.require_zero(c["START"] * c["LEVEL"])
    air.require_zero(c["START"] * (c["OACT"] + c["NACT"])
                     * (1 - c["LSEL0"]))
    # one-hot lane selector, rotating one lane per level
    air.require_zero(
        c["LSEL0"] + c["LSEL1"] + c["LSEL2"] + c["LSEL3"] - 1)
    for j in range(4):
        air.require_zero(NL * (nxt(f"LSEL{(j + 1) % 4}") - c[f"LSEL{j}"]))
    air.require_zero(NL * (nxt("LEVEL") - c["LEVEL"] - 1))

    # a chain can only continue out of a non-leaf row
    air.require_zero(NL * nxt("OACT") * c["OLEAF"])
    air.require_zero(NL * nxt("NACT") * c["NLEAF"])

    # parent -> child chaining: the path-side child becomes the next root
    for j in range(4):
        oc = c["BIT"] * c[f"OR{j}"] + (1 - c["BIT"]) * c[f"OL{j}"]
        nc = c["BIT"] * c[f"NR{j}"] + (1 - c["BIT"]) * c[f"NL{j}"]
        air.require_zero(NL * nxt("OACT") * (nxt(f"OROOT{j}") - oc))
        air.require_zero(NL * nxt("NACT") * (nxt(f"NROOT{j}") - nc))

    # the write only touches the path: the off-path child is shared between
    # OLD and NEW parents (only meaningful while both chains are branches)
    both = c["OACT"] * c["NACT"] * (1 - c["OLEAF"]) * (1 - c["NLEAF"])
    for j in range(4):
        off = (c["BIT"] * (c[f"NL{j}"] - c[f"OL{j}"])
               + (1 - c["BIT"]) * (c[f"NR{j}"] - c[f"OR{j}"]))
        air.require_zero(both * off)

    # get actions: the new tree IS the old tree
    for j in range(4):
        air.require_zero(c["SAME"] * (c[f"NROOT{j}"] - c[f"OROOT{j}"]))
        air.require_zero(c["SAME"] * (c[f"NL{j}"] - c[f"OL{j}"]))
        air.require_zero(c["SAME"] * (c[f"NR{j}"] - c[f"OR{j}"]))
    air.require_zero(c["SAME"] * (c["NACT"] - c["OACT"]))
    air.require_zero(c["SAME"] * (c["NLEAF"] - c["OLEAF"]))
    # SAME is an action-level attribute
    air.require_zero(NL * (nxt("SAME") - c["SAME"]))

    # key-bit consumption: selected lane climbs down (parent = 2*child+bit;
    # the no-wrap range side rides the ClimbKey SM actions)
    for j in range(4):
        sel = c[f"LSEL{j}"]
        climb = sel * (c[f"RKEY{j}"] - 2 * nxt(f"RKEY{j}") - c["BIT"])
        keep = (1 - sel) * (c[f"RKEY{j}"] - nxt(f"RKEY{j}"))
        air.require_zero(NL * (climb + keep))

    # leaf shape: a *matching* leaf's preimage lanes carry the remaining key
    # (a FOUND=0 leaf is a foreign leaf met on the path — insertFound /
    # mismatched-get; its key-inequality proof is a pending refinement)
    for j in range(4):
        air.require_zero(
            c["OLEAF"] * c["FOUNDO"] * (c[f"OL{j}"] - c[f"RKEY{j}"]))
        air.require_zero(
            c["NLEAF"] * c["FOUNDN"] * (c[f"NL{j}"] - c[f"RKEY{j}"]))
    air.require_zero(c["FOUNDO"] * (1 - c["OLEAF"]))
    air.require_zero(c["FOUNDN"] * (1 - c["NLEAF"]))

    # ONODE/NNODE flag rows that carry a node preimage; an active row
    # without one can only be a zero subtree (its root is pinned to zero),
    # so the node-hash lookups in the combined AIR cover every real node
    air.require_zero(c["ONODE"] * (1 - c["OACT"]))
    air.require_zero(c["NNODE"] * (1 - c["NACT"]))
    for j in range(4):
        air.require_zero((c["OACT"] - c["ONODE"]) * c[f"OROOT{j}"])
        air.require_zero((c["NACT"] - c["NNODE"]) * c[f"NROOT{j}"])
    air.require_zero(c["OLEAF"] * (1 - c["ONODE"]))
    air.require_zero(c["NLEAF"] * (1 - c["NNODE"]))

    # the action's value is a single attribute: held across rows, so the
    # START-row tuple Main looks up IS the value the leaf row proves
    for j in range(4):
        air.require_zero(NL * (nxt(f"VLOW{j}") - c[f"VLOW{j}"]))
        air.require_zero(NL * (nxt(f"VHIGH{j}") - c[f"VHIGH{j}"]))
    # a new-tree walk that ends without a matching leaf (foreign leaf or
    # zero subtree) proves value == 0 — the get-on-missing-key semantics
    for j in range(4):
        for v in (f"VLOW{j}", f"VHIGH{j}"):
            air.require_zero(c["NLEAF"] * (1 - c["FOUNDN"]) * c[v])
            air.require_zero((c["NACT"] - c["NNODE"]) * c[v])

    # foreign-leaf key inequality: FOUND=0 at a leaf requires a committed
    # one-hot lane pick + inverse witness showing the leaf's remaining key
    # differs from the query's remaining key in that lane
    for pre, leafc, foundc in (("O", "OLEAF", "FOUNDO"),
                               ("N", "NLEAF", "FOUNDN")):
        for j in range(4):
            air.require_zero(c[f"{pre}KNEQ{j}"] * (1 - c[f"{pre}KNEQ{j}"]))
        foreign = c[leafc] * (1 - c[foundc])
        air.require_zero(
            foreign * (c[f"{pre}KNEQ0"] + c[f"{pre}KNEQ1"]
                       + c[f"{pre}KNEQ2"] + c[f"{pre}KNEQ3"] - 1))
        for j in range(4):
            air.require_zero(
                c[f"{pre}KNEQ{j}"]
                * ((c[f"{pre}L{j}"] - c[f"RKEY{j}"]) * c[f"{pre}KINV"] - 1))

    # PHC: per-row permutation weight summed as a suffix within the action
    # (weight mirrors execute()'s PoseidonG emissions)
    w_row = (c["ONODE"] + c["FOUNDO"]
             + (1 - c["SAME"]) * (c["NNODE"] + c["FOUNDN"]))
    air.require_zero(c["LAST"] * (c["PHC"] - w_row))
    air.require_zero(NL * (c["PHC"] - w_row - nxt("PHC")))

    # cross-action root chaining: new_root of this action = old_root of the
    # next (CHAIN set on LAST rows of chained sequences). The action's
    # level-0 new root is held in ANROOT through every row so the LAST row
    # can compare it against the next action's START root.
    air.require_zero(c["CHAIN"] * (1 - c["LAST"]))
    for j in range(4):
        air.require_zero(c["START"] * (c[f"ANROOT{j}"] - c[f"NROOT{j}"]))
        air.require_zero(NL * (nxt(f"ANROOT{j}") - c[f"ANROOT{j}"]))
        air.require_zero(c["CHAIN"] * (nxt(f"OROOT{j}") - c[f"ANROOT{j}"]))
    return air


class StorageError(Exception):
    pass


def _walk(db, root: tuple, path_bits: list[int]):
    """Walk one tree from `root` along `path_bits`.

    Returns (rows, depth): rows[l] = (root, node12|None, is_leaf); the walk
    stops at a leaf or a zero subtree.
    """
    rows = []
    r = tuple(int(v) for v in root)
    level = 0
    while True:
        if r == ZERO4:
            rows.append((r, None, False))
            return rows
        node = db.read(r)
        if node is None:
            raise StorageError(f"missing node {r}")
        if node[8] == 1:  # leaf capacity marker (smt.py _is_leaf)
            rows.append((r, node, True))
            return rows
        rows.append((r, node, False))
        r = tuple(node[4:8]) if path_bits[level] else tuple(node[0:4])
        level += 1


def _walks(act: dict, db):
    """One action's two walks: (key, path bits, same, old walk, new walk,
    depth). A get walks its one tree (`same`); the action takes one trace
    row per level of the deeper walk."""
    key = tuple(int(v) for v in act["key"])
    bits = ku.split_key(key)
    same = act["op"] == "get"
    ow = _walk(db, act["root"], bits)
    nw = ow if same else _walk(db, act["new_root"], bits)
    return key, bits, same, ow, nw, max(len(ow), len(nw))


def rows(act: dict, db) -> int:
    """Storage trace rows this action takes."""
    return _walks(act, db)[5]


def hash_count(act: dict, db) -> int:
    """PoseidonG permutations this action's trace rows consume — the value
    the PHC column carries at the action's START row. The Main SM commits
    incCounter = hash_count + 2 (key-derivation hashes) on sRD/sWR rows
    (reference proofHashCounter role, main_executor.cpp:1154,1393), and the
    combined AIR binds it to PHC through the storage START lookup."""
    key, bits, same, ow, nw, _ = _walks(act, db)

    def side(walk):
        cnt = 0
        rkey = key
        for l, (r, node, is_leaf) in enumerate(walk):
            if node is not None:
                cnt += 1
                if is_leaf and tuple(node[0:4]) == tuple(
                        v % P for v in rkey):
                    cnt += 1
            lane = l % 4
            child = list(rkey)
            child[lane] = (child[lane] - bits[l]) >> 1
            rkey = tuple(child)
        return cnt

    return side(ow) + (0 if same else side(nw))


def execute(actions: list[dict], n_bits: int, db) -> tuple[np.ndarray, dict]:
    """actions: the Main SM's `actions.storage` stream
    ({op: get|set, root, key, value[, new_root]}); `db` the hashdb database
    holding both trees' nodes. Returns (trace, emitted) where emitted has
    poseidon_g / climb_key action lists for the co-SMs.
    """
    n = 1 << n_bits
    ncol = len(COLS)
    ci = {nm: i for i, nm in enumerate(COLS)}
    tr = np.zeros((n, ncol), dtype=np.uint64)
    emitted = {"poseidon_g": [], "climb_key": []}

    row = 0
    for ai, act in enumerate(actions):
        key, bits, same, ow, nw, depth = _walks(act, db)
        old_root = tuple(int(v) for v in act["root"])
        new_root = (tuple(int(v) for v in act["new_root"])
                    if act["op"] == "set" else old_root)
        if row + depth > n:
            raise StorageError("storage trace overflow")

        # remaining query key per level (RKEY climbs one bit per level)
        rkeys = [key]
        for l in range(depth - 1):
            lane = l % 4
            child = list(rkeys[-1])
            child[lane] = (child[lane] - bits[l]) >> 1
            rkeys.append(tuple(child))

        # value at the new leaf — zero unless the leaf's key matches
        # (get-on-missing / foreign-leaf actions prove a zero value)
        vfea = [0] * 8
        lf = len(nw) - 1
        if nw[lf][2] and tuple(nw[lf][1][0:4]) == tuple(
                v % P for v in rkeys[lf]):
            vh = tuple(nw[lf][1][4:8])
            leaf_val = db.read(vh)
            if leaf_val is not None:
                vfea = [int(x) for x in leaf_val[:8]]

        weights = [0] * depth
        rkey = key
        for l in range(depth):
            t = tr[row + l]
            t[ci["START"]] = 1 if l == 0 else 0
            t[ci["LAST"]] = 1 if l == depth - 1 else 0
            t[ci["LEVEL"]] = l
            t[ci["BIT"]] = bits[l] if l < depth - 1 else 0
            t[ci[f"LSEL{l % 4}"]] = 1
            t[ci["SAME"]] = 1 if same else 0
            for j in range(4):
                t[ci[f"RKEY{j}"]] = rkey[j]
                t[ci[f"VLOW{j}"]] = vfea[j]
                t[ci[f"VHIGH{j}"]] = vfea[4 + j]
                t[ci[f"ANROOT{j}"]] = new_root[j]

            for prefix, walk in (("O", ow), ("N", nw)):
                if l >= len(walk):
                    continue  # inactive: zeros, ACT stays 0
                r, node, is_leaf = walk[l]
                t[ci[f"{prefix}ACT"]] = 1
                for j in range(4):
                    t[ci[f"{prefix}ROOT{j}"]] = r[j]
                if node is not None:
                    t[ci[f"{prefix}NODE"]] = 1
                    for j in range(4):
                        t[ci[f"{prefix}L{j}"]] = node[j]
                        t[ci[f"{prefix}R{j}"]] = node[4 + j]
                    t[ci[f"{prefix}LEAF"]] = 1 if is_leaf else 0
                    found = is_leaf and tuple(node[0:4]) == tuple(
                        (rkey[j]) % P for j in range(4))
                    if found:
                        t[ci[f"FOUND{prefix}"]] = 1
                    elif is_leaf:
                        # foreign leaf: witness a differing key lane
                        for j in range(4):
                            d = (int(node[j]) - rkey[j]) % P
                            if d:
                                t[ci[f"{prefix}KNEQ{j}"]] = 1
                                t[ci[f"{prefix}KINV"]] = pow(d, P - 2, P)
                                break
                        else:
                            raise StorageError(
                                "leaf key matches but FOUND not set")
                    if prefix == "N" and same:
                        continue  # identical walk: O already emitted it
                    cap = CAP_LEAF if is_leaf else ZERO4
                    emitted["poseidon_g"].append(
                        {"state": list(node[:8]) + list(cap)})
                    weights[l] += 1
                    if found:
                        # value preimage: vh = H(value fea8 | cap0)
                        vh = tuple(node[4:8])
                        leaf_val = db.read(vh)
                        if leaf_val is None:
                            raise StorageError(f"missing value node {vh}")
                        emitted["poseidon_g"].append(
                            {"state": [int(x) for x in leaf_val[:8]]
                             + list(ZERO4)})
                        weights[l] += 1

            if l < depth - 1:
                # climb-down bookkeeping + the ClimbKey no-wrap proof of the
                # inverse climb-up (climb_key_executor.cpp semantics)
                lane = l % 4
                child = list(rkey)
                child[lane] = (child[lane] - bits[l]) >> 1
                emitted["climb_key"].append(
                    {"key": child, "level": l, "bit": bits[l]})
                rkey = tuple(child)

        # PHC: suffix sums of the per-row permutation weights
        acc = 0
        for l in range(depth - 1, -1, -1):
            acc += weights[l]
            tr[row + l, ci["PHC"]] = acc

        # chain to the next action when its old root continues this new root
        if ai + 1 < len(actions):
            nxt_root = tuple(int(v) for v in actions[ai + 1]["root"])
            if nxt_root == new_root:
                tr[row + depth - 1, ci["CHAIN"]] = 1
        row += depth

    # padding: LAST=1 stops transitions; LSEL0 satisfies the one-hot sum
    for r in range(row, n):
        tr[r, ci["LAST"]] = 1
        tr[r, ci["START"]] = 1
        tr[r, ci["LSEL0"]] = 1
    if row < n:
        tr[row, ci["START"]] = 1  # follows a LAST row
    return tr, emitted
