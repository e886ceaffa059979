"""The port's host Keccak and `hashdb` (key_utils, Smt, Database with its
caches, StateManager, HashDB) against the JAX package's on the same inputs,
exactly: digests, roots, every field of the get/set results, cache hits,
flush ids and read_tree answers."""

import dataclasses
import random

import numpy as np
import pytest

from zkevm_prover_tpu.hashdb import HashDB as JHashDB
from zkevm_prover_tpu.hashdb import key_utils as jku
from zkevm_prover_tpu.hashdb.database import Database as JDatabase
from zkevm_prover_tpu.hashdb.smt import Smt as JSmt
from zkevm_prover_tpu.ops.keccak import keccak256 as jkeccak256
from zkevm_prover_tpu_torch.hashdb import Database, HashDB, Smt
from zkevm_prover_tpu_torch.hashdb import key_utils as ku
from zkevm_prover_tpu_torch.ops.keccak import keccak256

P = 0xFFFFFFFF00000001
ZERO = (0, 0, 0, 0)


@pytest.mark.parametrize("length", [0, 135, 136, 300])
def test_keccak256_matches_jax(length):
    data = np.random.default_rng(length).integers(
        0, 256, length, dtype=np.uint8).tobytes()
    assert keccak256(data) == jkeccak256(data)


def test_keccak256_known_digest():
    # Keccak-256 of the empty string (the Ethereum empty-code hash)
    assert keccak256(b"").hex() == ("c5d2460186f7233c927e7db2dcc703c0"
                                    "e500b653ca82273b7bfad8045d85a470")


def test_key_utils_match_jax():
    rng = np.random.default_rng(0)
    for key in rng.integers(0, P, (16, 4), dtype=np.uint64).tolist():
        key = tuple(key)
        bits = ku.split_key(key)
        assert bits == jku.split_key(key)
        for level in (0, 1, 5, 32, 255):
            rkey = ku.remove_key_bits(key, level)
            assert rkey == jku.remove_key_bits(key, level)
            assert ku.join_key(bits[:level], rkey) == key


def _ops(seed: int, n: int = 40) -> list:
    """n mixed SMT operations from default_rng(seed): inserts of fresh keys,
    updates and deletes of live keys, and gets that hit or miss."""
    rng = np.random.default_rng(seed)
    live, ops = [], []
    for _ in range(n):
        u = rng.random()
        fresh = tuple(rng.integers(0, P, 4, dtype=np.uint64).tolist())
        value = int.from_bytes(rng.bytes(32), "little") or 1
        if not live or u < 0.35:
            ops.append(("set", fresh, value))
            live.append(fresh)
        elif u < 0.55:
            ops.append(("set", live[int(rng.integers(len(live)))], value))
        elif u < 0.70:
            ops.append(("set", live.pop(int(rng.integers(len(live)))), 0))
        elif u < 0.85:
            ops.append(("get", live[int(rng.integers(len(live)))], 0))
        else:
            ops.append(("get", fresh, 0))
    return ops


def _run(smt) -> list:
    root, out = ZERO, []
    for op, key, value in _ops(1):
        if op == "set":
            res = smt.set(root, key, value)
            root = res.new_root
        else:
            res = smt.get(root, key)
        out.append(dataclasses.asdict(res))
    return out


def test_smt_results_match_jax():
    port, jax_side = _run(Smt(Database())), _run(JSmt(JDatabase()))
    assert port == jax_side
    modes = {r["mode"] for r in port if "mode" in r}
    assert {"insertNotFound", "insertFound", "update"} <= modes
    assert any(m.startswith("delete") for m in modes)
    assert any(r.get("value") == 0 and "mode" not in r for r in port)


@pytest.mark.parametrize("kind", ["lru", "associative"])
def test_database_cache_in_front_of_backend_matches_jax(kind):
    def run(db_cls):
        backend = db_cls()
        for i in range(8):
            backend.write((i, 7 * i + 1, 13 * i + 2, 31 * i + 3), [i] * 12)
        backend.set_program((1, 8, 15, 34), b"\x60\x00")
        db = db_cls(backend=backend, cache=kind, n_bits=3) \
            if kind == "associative" else db_cls(backend=backend, cache=kind,
                                                 max_bytes=4 * 160)
        reads = [db.read((i, 7 * i + 1, 13 * i + 2, 31 * i + 3))
                 for i in (0, 1, 2, 0, 1, 2, 5, 6, 7, 0, 9, 3, 8, 6, 5, 2)]
        smt = Smt(db) if db_cls is Database else JSmt(db)
        root = ZERO
        for i in range(6):
            root = smt.set(root, (i, i, i, i), 1000 + i).new_root
        return (reads, db.get_program((1, 8, 15, 34)), db._cache.hits,
                db._cache.misses, len(db._cache), root,
                smt.get(root, (3, 3, 3, 3)).value)

    port = run(Database)
    assert port == run(JDatabase)
    assert port[2] > 0 and port[-1] == 1003


def test_database_refuses_a_cache_without_backend():
    with pytest.raises(ValueError, match="without a backend"):
        Database(cache="lru")


def _hashdb_lifecycle(hashdb_cls):
    """HashDB set/get inside a batch overlay, flush, programs, flush data
    and read_tree."""
    rng = random.Random(4)
    hdb = hashdb_cls()
    keys = [tuple(rng.getrandbits(64) % P for _ in range(4)) for _ in range(5)]
    hdb.begin_batch("b1")
    root, out = ZERO, []
    for i, key in enumerate(keys):
        res = hdb.set("b1", 0, root, key, 100 + i)
        root = res.new_root
        out.append((res.mode, res.new_root, hdb.get("b1", root, key).value))
    out.append(len(hdb.db))                      # nothing flushed yet
    hdb.semi_flush("b1", root)
    out.append(hdb.flush("b1"))
    out.append(hdb.get_flush_status())
    out.append(len(hdb.get_flush_data(0)["nodes"]))
    code = bytes(range(100))
    pkey = hdb.hash_program(code)
    hdb.set_program("", pkey, code)
    out += [pkey, hdb.get_program("", pkey)]
    out.append(hdb.read_tree(root, keys + [(1, 2, 3, 4)]))
    out.append(hdb.get_latest_state_root())
    out.append(hdb.keccak256(b"hashdb"))
    hdb.begin_batch("bX")
    hdb.set("bX", 0, root, (9, 9, 9, 9), 7)
    hdb.cancel_batch("bX")
    out.append(hdb.flush("bX"))
    out.append(len(hdb.db))
    return out


def test_hashdb_lifecycle_matches_jax():
    port = _hashdb_lifecycle(HashDB)
    assert port == _hashdb_lifecycle(JHashDB)
    assert [v for _, _, v in port[:5]] == [100, 101, 102, 103, 104]
    assert port[5] == 0


def test_database_save_and_load(tmp_path):
    db = Database(path=str(tmp_path / "db.json"))
    smt = Smt(db)
    root = smt.set(ZERO, (1, 2, 3, 4), 5).new_root
    db.set_program((1, 1, 1, 1), b"\x01\x02")
    db.save()
    again = Database(path=str(tmp_path / "db.json"))
    assert Smt(again).get(root, (1, 2, 3, 4)).value == 5
    assert again.get_program((1, 1, 1, 1)) == b"\x01\x02"
