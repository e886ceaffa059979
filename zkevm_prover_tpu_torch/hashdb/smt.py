"""Poseidon sparse Merkle tree — the zkEVM state tree.

Port of `zkevm_prover_tpu/hashdb/smt.py`: a host copy, the same tree and
hashing (through the port's `ops/refmodel.Poseidon` and
`ops/poseidon_constants`).

Re-implementation of the reference's Smt (src/hashdb/smt.cpp: `Smt::set`
insert/update/delete with node splitting and leaf collapse, `Smt::get`) with
the exact node hashing rules of SURVEY.md App. D:

  value hash  V = Poseidon(value8,              capacity [0,0,0,0])[:4]
  leaf node   L = Poseidon(rkey4 ‖ V,           capacity [1,0,0,0])[:4]
  branch node B = Poseidon(left4 ‖ right4,      capacity [0,0,0,0])[:4]
  empty subtree = (0,0,0,0)

The database stores the 12-element preimage (8 inputs + 4 capacity) under the
4-element hash (reference: hashSave, src/hashdb/smt.hpp:56-79). Values are
256-bit ints split into 8 little-endian 32-bit limbs (utils/scalar.hpp
scalar2fea convention).

Set modes mirror the reference exactly: update, insertFound (leaf split),
insertNotFound, deleteFound (leaf collapse), deleteNotFound, deleteLast,
zeroToZero — smt.cpp:11-870.
"""

from __future__ import annotations

import dataclasses

from ..ops import poseidon_constants as pc
from ..ops import refmodel as rm
from . import key_utils as ku
from .database import Database

ZERO4 = (0, 0, 0, 0)
CAP_LEAF = (1, 0, 0, 0)
CAP_BRANCH = (0, 0, 0, 0)
MAX_LEVELS = 256


def scalar_to_fea8(v: int) -> list[int]:
    """256-bit scalar -> 8 x 32-bit limbs (reference scalar2fea)."""
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def fea8_to_scalar(fe: list[int]) -> int:
    return sum(int(fe[i]) << (32 * i) for i in range(8))


@dataclasses.dataclass
class SmtSetResult:
    old_root: tuple
    new_root: tuple
    key: tuple
    new_value: int
    old_value: int
    mode: str
    siblings: dict  # level -> 12-element node preimage read on the way down
    ins_key: tuple | None = None
    ins_value: int = 0
    is_old0: bool = True


@dataclasses.dataclass
class SmtGetResult:
    root: tuple
    key: tuple
    value: int
    ins_key: tuple | None
    ins_value: int
    is_old0: bool
    siblings: dict
    proof_hash_counter: int = 0


class Smt:
    """One state tree over a Database (reference: one Smt per HashDB)."""

    def __init__(self, db: Database):
        self.db = db
        self._poseidon = rm.Poseidon(pc.round_constants(), pc.mds_matrix())

    # -- hashing ---------------------------------------------------------------

    def _hash_save(self, inputs8, capacity4) -> tuple:
        h = tuple(self._poseidon.permute(list(inputs8) + list(capacity4))[:4])
        self.db.write(h, list(inputs8) + list(capacity4))
        return h

    def hash_value(self, value: int) -> tuple:
        return self._hash_save(scalar_to_fea8(value), CAP_BRANCH)

    def leaf_node(self, rkey, value_hash) -> tuple:
        return self._hash_save(list(rkey) + list(value_hash), CAP_LEAF)

    def branch_node(self, left, right) -> tuple:
        return self._hash_save(list(left) + list(right), CAP_BRANCH)

    @staticmethod
    def _is_leaf(node12) -> bool:
        return node12[8] == 1

    # -- get ---------------------------------------------------------------------

    def get(self, root: tuple, key: tuple) -> SmtGetResult:
        keys = ku.split_key(key)
        r = tuple(int(v) for v in root)
        level = 0
        siblings = {}
        ins_key, ins_value, is_old0, value = None, 0, True, 0
        while r != ZERO4:
            node = self.db.read(r)
            assert node is not None, f"missing node {r}"
            siblings[level] = node
            if self._is_leaf(node):
                rkey = tuple(node[0:4])
                value_hash = tuple(node[4:8])
                leaf = self.db.read(value_hash)
                assert leaf is not None
                found_key = ku.join_key(keys[:level], rkey)
                if found_key == tuple(key):
                    value = fea8_to_scalar(leaf[:8])
                else:
                    ins_key, ins_value, is_old0 = found_key, fea8_to_scalar(leaf[:8]), False
                break
            r = tuple(node[4:8]) if keys[level] else tuple(node[0:4])
            level += 1
        return SmtGetResult(tuple(root), tuple(key), value, ins_key, ins_value,
                            is_old0, siblings)

    # -- set ---------------------------------------------------------------------

    def set(self, old_root: tuple, key: tuple, value: int) -> SmtSetResult:
        keys = ku.split_key(key)
        key = tuple(int(v) for v in key)
        r = tuple(int(v) for v in old_root)
        level = 0
        siblings: dict[int, list[int]] = {}

        # descend to leaf / empty
        found_key, found_value, found_rkey = None, 0, None
        while r != ZERO4:
            node = self.db.read(r)
            assert node is not None, f"missing node {r}"
            if self._is_leaf(node):
                rkey = tuple(node[0:4])
                leaf = self.db.read(tuple(node[4:8]))
                found_key = ku.join_key(keys[:level], rkey)
                found_value = fea8_to_scalar(leaf[:8])
                found_rkey = rkey
                break
            siblings[level] = node
            r = tuple(node[4:8]) if keys[level] else tuple(node[0:4])
            level += 1

        mode = ""
        new_root = tuple(old_root)
        old_value = 0
        ins_key, ins_value, is_old0 = None, 0, True

        if value != 0:
            if found_key == key:
                mode = "update"
                old_value = found_value
                new_root = self.leaf_node(
                    ku.remove_key_bits(key, level), self.hash_value(value)
                )
            elif found_key is not None:
                mode = "insertFound"
                ins_key, ins_value, is_old0 = found_key, found_value, False
                # descend while path bits agree
                found_bits = ku.split_key(found_key)
                l2 = level
                while keys[l2] == found_bits[l2]:
                    l2 += 1
                old_leaf = self.leaf_node(
                    ku.remove_key_bits(found_key, l2 + 1),
                    self.hash_value(found_value),
                )
                new_leaf = self.leaf_node(
                    ku.remove_key_bits(key, l2 + 1), self.hash_value(value)
                )
                if keys[l2]:
                    node = self.branch_node(old_leaf, new_leaf)
                else:
                    node = self.branch_node(new_leaf, old_leaf)
                # single-child branches up to the split level
                for l in range(l2 - 1, level - 1, -1):
                    if keys[l]:
                        node = self.branch_node(ZERO4, node)
                    else:
                        node = self.branch_node(node, ZERO4)
                new_root = node
            else:
                mode = "insertNotFound"
                new_root = self.leaf_node(
                    ku.remove_key_bits(key, level), self.hash_value(value)
                )
        else:
            if found_key == key:
                old_value = found_value
                if level == 0:
                    mode = "deleteLast"
                    new_root = ZERO4
                else:
                    # inspect the sibling recorded on the way down
                    parent = siblings[level - 1]
                    sib = tuple(parent[0:4]) if keys[level - 1] else tuple(parent[4:8])
                    if sib == ZERO4:
                        mode = "deleteNotFound"  # zero sibling: subtree vanishes
                        new_root = ZERO4
                    else:
                        sib_node = self.db.read(sib)
                        if self._is_leaf(sib_node):
                            # collapse: sibling leaf climbs while its new
                            # sibling is zero (reference deleteFound)
                            mode = "deleteFound"
                            sib_rkey = tuple(sib_node[0:4])
                            up = level - 1
                            sib_key = ku.join_key(
                                keys[:up] + [1 - keys[up]], sib_rkey
                            )
                            # remove parent level; climb while sibling is zero
                            while up > 0:
                                parent2 = siblings[up - 1]
                                other = (tuple(parent2[0:4]) if keys[up - 1]
                                         else tuple(parent2[4:8]))
                                if other != ZERO4:
                                    break
                                up -= 1
                            new_root = self.leaf_node(
                                ku.remove_key_bits(sib_key, up), self._vh(sib_node)
                            )
                            level = up
                            siblings = {l: siblings[l] for l in range(up)}
                        else:
                            mode = "deleteFound:branch"
                            new_root = ZERO4
            else:
                mode = "zeroToZero"
                if found_key is not None:
                    ins_key, ins_value, is_old0 = found_key, found_value, False
                return SmtSetResult(tuple(old_root), tuple(old_root), key, 0, 0,
                                    mode, siblings, ins_key, ins_value, is_old0)

        # bubble the new subtree hash up through the recorded siblings
        for l in range(level - 1, -1, -1):
            node = siblings[l]
            left, right = tuple(node[0:4]), tuple(node[4:8])
            if keys[l]:
                right = new_root
            else:
                left = new_root
            if left == ZERO4 and right == ZERO4:
                new_root = ZERO4
            else:
                new_root = self.branch_node(left, right)

        return SmtSetResult(tuple(old_root), new_root, key, value, old_value,
                            mode, siblings, ins_key, ins_value, is_old0)

    def _vh(self, leaf_node12):
        return tuple(leaf_node12[4:8])
