"""The port's checkpoint manager, held to the reference's cases and
checked across the two packages (CPU).

``repro_torch.checkpoint`` against the cases of ``tests/test_checkpoint.py``
(round trip, packed leaves, retention, torn and corrupt directories,
typed errors naming the leaf, async errors, retry, the newest commit kept
mid-save), plus: a nested-dict tree saved by either package is restored
by the other, with the same manifest leaf names and files; a flipped byte
is a ``LeafCorruptError`` naming the leaf whichever package wrote the
file; ``save_async`` copies every leaf before it returns.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_tree as j_restore
from repro.checkpoint import save_tree as j_save
from repro_torch.checkpoint import (CheckpointError, CheckpointManager,
                                    CheckpointWriteError, LeafCorruptError,
                                    LeafMismatchError, restore_tree,
                                    save_tree)
from repro_torch.core.packed import pack, unpack


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's small tensors: the suite runs
    several test processes at once, and torch's thread pools in each of
    them would otherwise wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed):
    g = np.random.default_rng(seed)
    return {"a": torch.from_numpy(g.standard_normal((16, 8), np.float32)),
            "nested": {"b": torch.from_numpy(
                g.standard_normal(4).astype(np.float32)),
                "step": torch.tensor(7, dtype=torch.int32)}}


def _plus(t, s):
    return {"a": t["a"] + s, "nested": {"b": t["nested"]["b"] + s,
                                        "step": t["nested"]["step"] + s}}


def _leaves(t):
    return [t["a"], t["nested"]["b"], t["nested"]["step"]]


def _assert_equal(got, want):
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["leaves"]


def test_save_restore_roundtrip(tmp_path):
    t = _tree(0)
    save_tree(t, str(tmp_path / "ck"))
    _assert_equal(restore_tree(t, str(tmp_path / "ck")), t)
    meta = torch.empty((16, 8), device="meta")
    r = restore_tree(dict(t, a=meta), str(tmp_path / "ck"))
    assert r["a"].device.type == "cpu"
    np.testing.assert_array_equal(r["a"].numpy(), t["a"].numpy())


def test_packed_arrays_roundtrip(tmp_path):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (32, 8), np.float32))
    t = {"w": pack(x, 12, torch.tensor(-8.0))}
    save_tree(t, str(tmp_path / "ck"))
    r = restore_tree(t, str(tmp_path / "ck"))
    assert torch.equal(unpack(r["w"]), unpack(t["w"]))
    assert r["w"].mantissa.dtype == torch.int16 and r["w"].width == 12
    assert [m["name"] for m in _manifest(tmp_path / "ck")] == \
        ["w/mantissa", "w/exp"]


def test_manager_latest_retention_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree(2)
    for s in (10, 20, 30):
        mgr.save(s, _plus(t, s))
    assert mgr.latest() == 30
    assert mgr.all_steps() == [20, 30]  # retention pruned step 10
    _assert_equal(mgr.restore(t), _plus(t, 30))


def test_uncommitted_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(10, _tree(3))
    os.makedirs(tmp_path / "step_00000020")     # a torn save
    assert mgr.latest() == 10


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(5, _tree(4))
    mgr.wait()
    assert mgr.latest() == 5


def test_save_async_copies_every_leaf_before_it_returns(tmp_path):
    """The writer thread never reads the caller's tensors: writing them
    in place right after ``save_async`` returns does not reach the
    checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(16)
    want = _plus(t, 0)
    mgr.save_async(5, t)
    for x in _leaves(t):
        x.add_(100)
    mgr.wait()
    _assert_equal(mgr.restore(want), want)


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore({"a": torch.zeros(3)})


def test_leaf_count_mismatch_names_counts(tmp_path):
    save_tree(_tree(5), str(tmp_path / "ck"))
    with pytest.raises(LeafMismatchError, match="3 leaves"):
        restore_tree({"a": torch.zeros((16, 8))}, str(tmp_path / "ck"))


def test_shape_and_dtype_mismatch_name_the_leaf(tmp_path):
    t = _tree(6)
    save_tree(t, str(tmp_path / "ck"))
    with pytest.raises(LeafMismatchError, match="'a'.*shape"):
        restore_tree(dict(t, a=torch.zeros((2, 2))), str(tmp_path / "ck"))
    bad = {"a": t["a"], "nested": dict(t["nested"], step=torch.tensor(0.0))}
    with pytest.raises(LeafMismatchError, match="'nested/step'.*dtype"):
        restore_tree(bad, str(tmp_path / "ck"))


def _corrupt_one_leaf(ckpt_dir):
    leaf = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npy"))[0]
    p = os.path.join(ckpt_dir, leaf)
    with open(p, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    return leaf


def test_crc_corruption_is_a_typed_error_naming_the_leaf(tmp_path):
    t = _tree(7)
    save_tree(t, str(tmp_path / "ck"))
    _corrupt_one_leaf(str(tmp_path / "ck"))
    names = [m["name"] for m in _manifest(tmp_path / "ck")]
    with pytest.raises(LeafCorruptError, match=f"'{names[0]}'.*CRC32"):
        restore_tree(t, str(tmp_path / "ck"))


def test_crc_corrupted_newest_falls_back_to_previous(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(8)
    mgr.save(10, t)
    mgr.save(20, _plus(t, 1))
    _corrupt_one_leaf(str(tmp_path / "step_00000020"))
    tree, step = mgr.restore_latest(t)
    assert step == 10
    _assert_equal(tree, t)
    assert mgr.all_steps() == [10]              # quarantined, not retried
    assert any(d.startswith("corrupt_") for d in os.listdir(tmp_path))


def test_stripped_committed_falls_back_to_previous(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(9)
    mgr.save(10, t)
    mgr.save(20, _plus(t, 1))
    os.remove(tmp_path / "step_00000020" / "_COMMITTED")
    _, step = mgr.restore_latest(t)
    assert step == 10


def test_all_corrupt_raises_checkpoint_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree(10)
    mgr.save(10, t)
    _corrupt_one_leaf(str(tmp_path / "step_00000010"))
    with pytest.raises(CheckpointError, match="failed verification"):
        mgr.restore_latest(t)


def test_async_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retries=0, backoff_s=0.0)
    t = _tree(11)
    mgr.inject_failure()
    mgr.save_async(5, t)
    with pytest.raises(CheckpointWriteError, match="injected"):
        mgr.wait()
    mgr.save_async(6, t)                        # the error was consumed
    mgr.wait()
    assert mgr.latest() == 6


def test_async_error_surfaces_on_next_save_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retries=0, backoff_s=0.0)
    t = _tree(12)
    mgr.inject_failure()
    mgr.save_async(5, t)
    time.sleep(0.2)
    with pytest.raises(CheckpointWriteError):
        mgr.save_async(6, t)


def test_save_retry_survives_transient_failure(tmp_path):
    mgr = CheckpointManager(str(tmp_path), retries=2, backoff_s=0.0)
    mgr.inject_failure(count=1)                 # first attempt dies
    mgr.save(5, _tree(13))
    assert mgr.latest() == 5
    assert not os.path.exists(tmp_path / "step_00000005.tmp")


def test_retention_never_deletes_newest_committed_mid_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, retries=0, backoff_s=0.0)
    t = _tree(14)
    mgr.save(10, t)
    mgr.inject_failure()
    with pytest.raises(CheckpointWriteError):
        mgr.save(20, t)
    assert mgr.latest() == 10
    _, step = mgr.restore_latest(t)
    assert step == 10


def test_weird_dir_names_do_not_crash_all_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(10, _tree(15))
    os.makedirs(tmp_path / "step_00000020.tmp")
    open(tmp_path / "step_00000020.tmp" / "_COMMITTED", "w").close()
    os.makedirs(tmp_path / "step_junk")
    assert mgr.all_steps() == [10]


# ------------------------------------------------------ across the packages

def _jtree(t):
    return jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)


def _spec(t):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), t)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_the_packages(tmp_path, writer):
    """A nested-dict tree saved by one package is restored by the other:
    the same values and dtypes, the same manifest leaf names and files;
    a flipped byte is a ``LeafCorruptError`` naming the leaf."""
    t = _tree(17)
    path = str(tmp_path / "ck")
    if writer == "reference":
        j_save(_jtree(t), path)
        got = restore_tree(t, path)
    else:
        save_tree(t, path)
        got = jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                           j_restore(_spec(_jtree(t)), path))
    _assert_equal(got, t)
    other = str(tmp_path / "other")
    (save_tree(t, other) if writer == "reference"
     else j_save(_jtree(t), other))
    assert [(m["name"], m["file"], m["dtype"]) for m in _manifest(path)] == \
        [(m["name"], m["file"], m["dtype"]) for m in _manifest(other)] == \
        [("a", "leaf_00000.npy", "float32"),
         ("nested/b", "leaf_00001.npy", "float32"),
         ("nested/step", "leaf_00002.npy", "int32")]
    _corrupt_one_leaf(path)
    with pytest.raises(LeafCorruptError, match="'a'"):
        restore_tree(t, path)


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "granite_moe_1b"])
def test_family_params_cross_the_packages(tmp_path, arch):
    """A hybrid model's parameters (its ``"shared"`` blocks) and an MoE
    model's, saved by the reference, restore into the port's tree bit for
    bit, with the leaf names and files the port writes itself."""
    from repro import configs as jconfigs
    from repro.models import transformer as JT
    from repro_torch import configs as tconfigs
    from repro_torch.models import transformer as TT
    jp = JT.init_params(jconfigs.get_smoke(arch), jax.random.PRNGKey(3))
    tp = TT.init_params(tconfigs.get_smoke(arch), 3, device="cpu")
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    j_save(jp, ref)
    save_tree(tp, port)
    got = restore_tree(tp, ref)
    flat = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat) == len(_manifest(ref))
    for (path, want), m in zip(flat, _manifest(ref)):
        d = got
        for k in path:
            d = d[k.key]
        np.testing.assert_array_equal(d.numpy(), np.asarray(want), m["name"])
    assert [(m["name"], m["file"]) for m in _manifest(ref)] == \
        [(m["name"], m["file"]) for m in _manifest(port)]
    if arch == "zamba2_1p2b":
        assert any("/shared/" in m["name"] for m in _manifest(port))
