"""The port's hashdb64 (the native page store, Database64, KeyValueHistory,
LevelTree, StateManager64) against the JAX package's on the same inputs:
record CRUD with overflow and reopen, the SMT over the paged backend giving
the JAX roots, versioned reads and leaf levels. The port builds its own copy
of native/pagestore.cpp into the package's git-ignored build/ directory."""

import pathlib
import random

import pytest

from zkevm_prover_tpu.hashdb import Database as JDatabase
from zkevm_prover_tpu.hashdb import Smt as JSmt
from zkevm_prover_tpu.hashdb64 import Database64 as JDatabase64
from zkevm_prover_tpu.hashdb64 import PageStore as JPageStore
from zkevm_prover_tpu.hashdb64.key_value_history import \
    KeyValueHistory as JKeyValueHistory
from zkevm_prover_tpu.hashdb64.level_tree import LevelTree as JLevelTree
from zkevm_prover_tpu.hashdb64.state64 import StateManager64 as JStateManager64
from zkevm_prover_tpu_torch.hashdb import Smt
from zkevm_prover_tpu_torch.hashdb64 import Database64, PageStore, page_store
from zkevm_prover_tpu_torch.hashdb64.key_value_history import KeyValueHistory
from zkevm_prover_tpu_torch.hashdb64.level_tree import LevelTree
from zkevm_prover_tpu_torch.hashdb64.state64 import StateManager64

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "zkevm_prover_tpu_torch"
ZERO = (0, 0, 0, 0)


def test_library_builds_into_the_build_directory():
    lib = pathlib.Path(page_store.build_library())
    assert lib.is_relative_to(PORT / "build")
    assert lib.name == "libpagestore.so" and lib.exists()
    assert not list((PORT / "hashdb64").rglob("*.so"))
    assert (PORT / "hashdb64/native/pagestore.cpp").read_bytes() == (
        ROOT / "zkevm_prover_tpu/hashdb64/native/pagestore.cpp").read_bytes()


def _store_ops(store_cls, path):
    """Set, resize, overflow (4 buckets) and reopen; returns what was read."""
    ps = store_cls(path, bucket_bits=2)
    k1 = bytes(range(32))
    out = [ps.get(k1)]
    ps.set(k1, b"hello")
    out.append(ps.get(k1))
    ps.set(k1, b"resized value!")
    out.append(ps.get(k1))
    rng = random.Random(0)
    items = {rng.randbytes(32): rng.randbytes(rng.randrange(1, 100))
             for _ in range(300)}
    for k, v in items.items():
        ps.set(k, v)
    out += [len(ps), ps.page_count]
    ps.flush()
    ps.close()
    ps = store_cls(path, bucket_bits=2)
    out += [len(ps), ps.page_count, ps.get(k1)]
    out.append(all(ps.get(k) == v for k, v in items.items()))
    ps.close()
    return out


def test_pagestore_crud_and_reopen_match_jax(tmp_path):
    port = _store_ops(PageStore, str(tmp_path / "port.pages"))
    assert port == _store_ops(JPageStore, str(tmp_path / "jax.pages"))
    assert port[0] is None and port[-1] is True and port[4] > 5
    assert (tmp_path / "port.pages").read_bytes() == \
        (tmp_path / "jax.pages").read_bytes()


def test_smt_on_paged_backend_gives_jax_roots(tmp_path):
    smt = Smt(Database64(str(tmp_path / "state.pages")))
    jsmt = JSmt(JDatabase())
    rng = random.Random(1)
    root = jroot = ZERO
    pairs = []
    for _ in range(24):
        k = tuple(rng.getrandbits(63) for _ in range(4))
        v = rng.getrandbits(255) + 1
        pairs.append((k, v))
        root = smt.set(root, k, v).new_root
        jroot = jsmt.set(jroot, k, v).new_root
        assert root == jroot
    for k, v in pairs:
        assert smt.get(root, k).value == v
    for k, _ in pairs[:8]:
        root = smt.set(root, k, 0).new_root
        jroot = jsmt.set(jroot, k, 0).new_root
        assert root == jroot


def test_database64_programs_match_jax(tmp_path):
    code = bytes(range(256)) * 3   # several 128-byte chunks
    out = []
    for cls, name in ((Database64, "port"), (JDatabase64, "jax")):
        db = cls(str(tmp_path / f"{name}.pages"))
        db.set_program((1, 2, 3, 4), code)
        db.write((5, 6, 7, 8), list(range(12)))
        out.append((db.get_program((1, 2, 3, 4)),
                    db.get_program((9, 9, 9, 9)), db.read((5, 6, 7, 8)),
                    db.read((1, 1, 1, 1)), len(db)))
    assert out[0] == out[1]
    assert out[0][0] == code and out[0][1] is None


def test_key_value_history_matches_jax(tmp_path):
    def run(store_cls, kvh_cls, path):
        kvh = kvh_cls(store_cls(path))
        k1, k2 = (1, 2, 3, 4), (5, 6, 7, 8)
        r1, r2, r3 = (11, 0, 0, 0), (22, 0, 0, 0), (33, 0, 0, 0)
        vers = [kvh.write_batch({k1: 100}, r1),
                kvh.write_batch({k1: 200, k2: 7}, r2),
                kvh.write_batch({k2: 9}, r3)]
        reads = [kvh.read(r, k) for r in (r1, r2, r3, (99, 0, 0, 0))
                 for k in (k1, k2)]
        kvh.store.flush()
        kvh.store.close()
        again = kvh_cls(store_cls(path))
        out = (vers, reads, again.read(r2, k1), again.current_version())
        again.store.close()
        return out

    port = run(PageStore, KeyValueHistory, str(tmp_path / "port.pages"))
    assert port == run(JPageStore, JKeyValueHistory,
                       str(tmp_path / "jax.pages"))
    assert port[1][:4] == [100, None, 200, 7] and port[3] == 3


def test_level_tree_matches_jax():
    rng = random.Random(7)
    keys = [(rng.getrandbits(6), rng.getrandbits(6), 0, 0)
            for _ in range(40)] + [(0, 0, 0, 0), (1, 0, 0, 0), (1, 1, 0, 0)]
    t, jt = LevelTree(), JLevelTree()
    assert [t.insert(k) for k in keys] == [jt.insert(k) for k in keys]
    probes = keys + [(9, 9, 9, 9), (63, 63, 1, 1)]
    assert [t.level(k) for k in probes] == [jt.level(k) for k in probes]
    assert [k in t for k in probes] == [k in jt for k in probes]
    assert len(t) == len(jt)


@pytest.mark.parametrize("consolidate", [False, True])
def test_state_manager64_matches_jax(tmp_path, consolidate):
    def run(store_cls, sm_cls, path):
        store = store_cls(path)
        sm = sm_cls(store)
        out = []
        sm.start_batch("b1", ZERO)
        out += [sm.write("b1", (1, 0, 0, 0), 100),
                sm.write("b1", (0, 0, 0, 0), 200)]
        sm.semi_flush("b1", (1, 1, 1, 1))
        sm.start_batch("b2", (1, 1, 1, 1))
        out.append(sm.write("b2", (1, 0, 0, 0), 111))
        sm.semi_flush("b2", (2, 2, 2, 2))
        if consolidate:
            out.append(sm.consolidate_state((2, 2, 2, 2)))
            out.append(sm.consolidate_state((2, 2, 2, 2)))
        out += [sm.is_virtual((1, 1, 1, 1)), sm.is_virtual((2, 2, 2, 2))]
        out += [sm.read(r, k) for r in ((1, 1, 1, 1), (2, 2, 2, 2))
                for k in ((1, 0, 0, 0), (0, 0, 0, 0), (9, 9, 9, 9))]
        out.append(sm.level((0, 0, 0, 0)))
        with pytest.raises(KeyError):
            sm.consolidate_state((7, 7, 7, 7))
        store.close()
        return out

    port = run(PageStore, StateManager64, str(tmp_path / "port.pages"))
    assert port == run(JPageStore, JStateManager64,
                       str(tmp_path / "jax.pages"))
    assert port[-7:-1] == [100, 200, None, 111, 200, None]
