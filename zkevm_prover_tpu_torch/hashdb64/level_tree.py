"""LevelTree — the depth at which each key's leaf sits in the binary SMT.

Port of `zkevm_prover_tpu/hashdb64/level_tree.py`: a host copy, the same trie.

Reference: src/hashdb64/level_tree.hpp / key_value_tree (the "USE_NEW_KVTREE"
backend, definitions.hpp:76): hashdb64 answers `level(key)` — how many path
bits an SMT walk consumes before the key's leaf — WITHOUT materializing
Poseidon nodes, by keeping the key population in a radix tree over the
split-key bit order (utils/key_utils.hpp:10).  The executor uses the level
for SMT gas/counter accounting (GetKey/level RPC responses).

Here: a binary trie over split_key bits.  Each internal node is a dict
{0: child, 1: child}; a leaf holds the full key.  Inserting a key that
shares a prefix with an existing leaf pushes both down until they diverge —
exactly the SMT's leaf-split rule (hashdb/smt.py set modes), so
`level(key)` equals the depth of the leaf in the equivalent SMT.
"""

from __future__ import annotations

from ..hashdb.key_utils import split_key


class LevelTree:
    def __init__(self):
        self._root = {}          # trie node: {} empty, {"leaf": key} leaf,
        self._count = 0          # {0:..., 1:...} branch

    @staticmethod
    def _bits(key):
        return split_key(tuple(int(v) for v in key))

    def insert(self, key) -> int:
        """Insert (idempotent) and return the key's resulting level
        (depth of its leaf after any splits)."""
        key = tuple(int(v) for v in key)
        bits = self._bits(key)
        node, depth = self._root, 0
        while True:
            if "leaf" in node:
                other = node["leaf"]
                if other == key:
                    return depth
                # split: push the resident leaf down until paths diverge
                obits = self._bits(other)
                del node["leaf"]
                while bits[depth] == obits[depth]:
                    child = {}
                    node[bits[depth]] = child
                    node, depth = child, depth + 1
                node[obits[depth]] = {"leaf": other}
                node[bits[depth]] = {"leaf": key}
                self._count += 1
                return depth + 1
            if not node:          # empty slot: place the leaf here
                node["leaf"] = key
                self._count += 1
                return depth
            b = bits[depth]
            if b not in node:
                node[b] = {}
            node, depth = node[b], depth + 1

    def level(self, key) -> int:
        """Level of the key if present, or the level its leaf WOULD get
        (the walk depth — what the executor charges for a miss too)."""
        key = tuple(int(v) for v in key)
        bits = self._bits(key)
        node, depth = self._root, 0
        while True:
            if "leaf" in node:
                if node["leaf"] == key:
                    return depth
                obits = self._bits(node["leaf"])
                d = depth
                while bits[d] == obits[d]:
                    d += 1
                return d + 1
            if not node:
                return depth
            b = bits[depth]
            if b not in node:
                # a new leaf would hang one level below this branch —
                # matches insert()'s return for the same key
                return depth + 1
            node, depth = node[b], depth + 1

    def __contains__(self, key) -> bool:
        key = tuple(int(v) for v in key)
        bits = self._bits(key)
        node, depth = self._root, 0
        while True:
            if "leaf" in node:
                return node["leaf"] == key
            b = bits[depth] if depth < 256 else 0
            if b not in node:
                return False
            node, depth = node[b], depth + 1

    def __len__(self) -> int:
        return self._count
