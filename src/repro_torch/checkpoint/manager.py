"""Fault-tolerant checkpointing — ``repro.checkpoint.manager``.

Layout per step, the reference's own, so either package reads the
other's checkpoints::

    <dir>/step_00000100/
        manifest.json      # leaf names, shape/dtype/CRC32/file per leaf
        leaf_00000.npy     # one .npy per leaf
        _COMMITTED         # written last: restore ignores torn checkpoints

A tree is nested dicts (keys visited in sorted order, as ``jax.tree``
visits them), lists, tuples and dataclasses (``TrainState``,
``ScaleState``, ``PackedArray``: their tensor fields in declaration
order; an ``int`` field such as ``PackedArray.width`` is structure, not a
leaf) over tensor leaves.  A leaf's name is its path joined by ``/``, so
the manifest of a nested-dict tree names and orders its leaves exactly as
the reference's does.

  * **Integrity**: every leaf file carries a CRC32 in the manifest,
    verified on restore; a flipped byte on disk is a typed
    :class:`LeafCorruptError` naming the leaf.
  * **Durability**: every leaf file and the manifest are fsync'd, then
    the directory, the tmp dir is renamed into place, the parent fsync'd,
    and only then is ``_COMMITTED`` written and fsync'd.
  * **Async**: :meth:`CheckpointManager.save_async` copies every leaf to
    host memory *before* it returns (a synchronising ``.cpu()`` copy per
    card leaf, a copy of each CPU leaf), so the writer thread never reads
    a tensor that later work may write; a background failure is re-raised
    on the next :meth:`~CheckpointManager.wait` / ``save_async``.
  * **Retry** (``retries``/``backoff_s``) and **retention** (``keep``;
    the newest committed directory is never deleted).

Restore puts each leaf on the device of the template's leaf (or on
``device``).  **Elastic restore**, as the reference's: a checkpoint
holds whole leaves, so any mesh can restore it.  With ``shardings`` —
the entry tree of :class:`repro_torch.dist.ShardingRules` for the
template, on the ambient mesh (a :class:`~repro_torch.launch.mesh.
BoundMesh` over the current ``torch.distributed`` world, set by
``use_mesh``) — each rank reads and verifies every
whole leaf and keeps its own block (:func:`repro_torch.dist.sharding.
shard_local`).  Saving a tree sharded so gathers each sharded leaf along
its mesh axes on every rank; the world's first rank writes, and every
rank returns once it knows the checkpoint committed, or raises.  The
files are byte for byte those of a one-process save of the whole tree.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """Base class for checkpoint integrity/IO failures."""


class LeafMismatchError(CheckpointError):
    """Checkpoint structure does not match the restore template
    (leaf count, or a leaf's shape/dtype), naming the offending leaf."""


class LeafCorruptError(CheckpointError):
    """A leaf file's bytes do not match the manifest CRC32."""


class CheckpointWriteError(CheckpointError):
    """A (possibly background) checkpoint write failed after retries."""


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16, torch.int8: np.int8,
              torch.int16: np.int16, torch.int32: np.int32,
              torch.int64: np.int64, torch.uint8: np.uint8,
              torch.bool: np.bool_}


# -- trees ---------------------------------------------------------------
def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) or (
        dataclasses.is_dataclass(x) and not isinstance(x, type))


def _is_data(x) -> bool:
    return _is_node(x) or isinstance(x, (torch.Tensor, np.ndarray,
                                         np.generic))


def _fields(x):
    return [f.name for f in dataclasses.fields(x)
            if _is_data(getattr(x, f.name))]


def flatten(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``[(name, leaf)]`` in the reference's leaf order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten(v, path + (str(i),))]
    if _is_node(tree):
        return [item for n in _fields(tree)
                for item in flatten(getattr(tree, n), path + (n,))]
    return [("/".join(path) or "<root>", tree)]


def unflatten(template, leaves):
    """``template``'s structure over ``leaves`` (in :func:`flatten`'s
    order); dicts keep the template's own key order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        if _is_node(t):
            return dataclasses.replace(t, **{n: build(getattr(t, n))
                                             for n in _fields(t)})
        return next(it)

    return build(template)


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that no later work on ``leaf`` can change
    (``.cpu()`` of a card tensor waits for the kernels writing it)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NP_DTYPES:
            raise TypeError(f"cannot checkpoint a {leaf.dtype} leaf")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _spec(leaf) -> Tuple[tuple, np.dtype]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), np.dtype(_NP_DTYPES[leaf.dtype])
    a = np.asarray(leaf)
    return a.shape, a.dtype


def _place(arr: np.ndarray, tmpl, device, entries=None, mesh=None):
    if entries:
        from repro_torch.dist.sharding import shard_local
        arr = shard_local(torch.from_numpy(arr), entries, mesh).numpy()
    if isinstance(tmpl, np.ndarray):
        return arr
    dev = device
    if dev is None and isinstance(tmpl, torch.Tensor) and \
            tmpl.device.type != "meta":
        dev = tmpl.device
    return torch.from_numpy(arr).to(dev or "cpu")


# -- sharded trees ---------------------------------------------------------
def _entries(template, shardings) -> list:
    """The entries of ``shardings`` at ``template``'s leaves, in
    :func:`flatten`'s order (an entry is a tuple, so the walk follows the
    template's structure, not the entries')."""
    if isinstance(template, dict):
        return [e for k in sorted(template)
                for e in _entries(template[k], shardings[k])]
    if isinstance(template, (list, tuple)):
        return [e for t, sh in zip(template, shardings)
                for e in _entries(t, sh)]
    if _is_node(template):
        return [e for n in _fields(template)
                for e in _entries(getattr(template, n), getattr(shardings, n))]
    return [tuple(shardings)]


def _mesh():
    """The ambient mesh, whose axes ``shardings`` name."""
    from repro_torch.launch.mesh import ambient_mesh
    mesh = ambient_mesh()
    if mesh is None:
        raise ValueError("shardings name mesh axes: run under "
                         "repro_torch.launch.mesh.use_mesh(mesh)")
    return mesh


def _agreed(mesh, err: Optional[BaseException], what: str, cls):
    """Every rank's outcome of one collective step, gathered over the
    world, and the same verdict on every rank: ``(None, False)`` when the
    step succeeded everywhere, else ``(e, fatal)``, where ``e`` is this
    rank's own error or, on a rank that succeeded, a ``cls`` error naming
    the first rank that failed and its error, and ``fatal`` says that
    some rank's error was not a :class:`CheckpointError`."""
    msgs = mesh.gather_objects(
        None if err is None else (isinstance(err, CheckpointError),
                                  f"{type(err).__name__}: {err}"))
    failed = [(r, m) for r, m in enumerate(msgs) if m is not None]
    if not failed:
        return None, False
    if err is None:
        r, (_, m) = failed[0]
        err = cls(f"{what} failed on rank {r}: {m}")
    return err, not all(ok for _, (ok, _) in failed)


def _save_sharded(tree, shardings, write: Callable, what: str) -> None:
    """Collective save of a tree sharded by ``shardings`` on the ambient
    mesh: each sharded leaf all-gathered along its axes (every rank takes
    part), ``write(whole host leaves)`` on the world's first rank, and
    every rank raises if any rank failed.  A rank's error stops only its
    own work, never its part in a collective, so no peer waits on it."""
    mesh = _mesh()
    writer = mesh.rank == 0
    err, leaves = None, []
    for (name, x), ent in zip(flatten(tree), _entries(tree, shardings)):
        axes = [(dim, e) for dim, e in enumerate(ent)
                if e is not None and mesh.axis_size(e) > 1]
        for dim, e in axes:
            names = (e,) if isinstance(e, str) else tuple(e)
            if names != tuple(a for a in mesh.axis_names if a in names):
                raise ValueError(f"leaf {name!r}: axes {names} are not in "
                                 f"the mesh's order {mesh.axis_names}")
            x = mesh.all_gather(torch.as_tensor(x), e, dim)
        if writer and err is None:
            try:
                leaves.append((name, _host(x)))
            except Exception as e:      # raised on every rank below
                err = e
    if writer and err is None:
        try:
            write(leaves)
        except Exception as e:
            err = e
    err, _ = _agreed(mesh, err, what, CheckpointWriteError)
    if err is not None:
        raise err


# -- files ---------------------------------------------------------------
def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _save_host(leaves: List[Tuple[str, np.ndarray]], path: str, *,
               fail_hook: Optional[Callable] = None) -> None:
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"treedef": f"{len(leaves)} leaves", "leaves": []}
    for i, (name, arr) in enumerate(leaves):
        if fail_hook is not None:
            fail_hook(i)
        fname = f"leaf_{i:05d}.npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, arr)
        with open(fpath, "rb") as f:
            crc = zlib.crc32(f.read())
        _fsync_file(fpath)
        manifest["leaves"].append(
            {"file": fname, "name": name, "shape": list(arr.shape),
             "dtype": str(arr.dtype), "crc32": crc})
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    cpath = os.path.join(path, "_COMMITTED")
    with open(cpath, "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(path)


def save_tree(tree: Any, path: str, *,
              fail_hook: Optional[Callable] = None,
              shardings: Any = None) -> None:
    """Synchronous atomic save of a tree of tensors.

    Write ordering (the durability contract): leaves and manifest into a
    ``.tmp`` dir, fsync every file, fsync the dir, ``os.replace`` into
    place, fsync the parent, and only then write and fsync
    ``_COMMITTED``.  ``fail_hook(i)``, called before leaf ``i`` is
    written, may raise to simulate a writer dying mid-save.

    With ``shardings`` (the entry tree ``tree``'s local blocks were cut
    by, on the ambient mesh) the call is collective over the world: the
    whole leaves are gathered, the first rank writes them, and every
    rank raises if the write failed."""
    if shardings is None:
        _save_host([(n, _host(x)) for n, x in flatten(tree)], path,
                   fail_hook=fail_hook)
        return
    _save_sharded(tree, shardings,
                  lambda leaves: _save_host(leaves, path,
                                            fail_hook=fail_hook),
                  f"checkpoint save to {path}")


def restore_tree(template: Any, path: str, shardings: Any = None, *,
                 device=None, verify: bool = True) -> Any:
    """Restore into ``template``'s structure; with ``shardings``, this
    rank's block of each leaf.

    Each leaf lands on ``device``, or on the device of the template's
    tensor (the CPU for a ``meta`` one); a numpy template leaf gives a
    numpy array.  ``template`` holds the whole leaves' shapes;
    ``shardings`` (the entry tree :class:`repro_torch.dist.ShardingRules`
    gives for it, or ``None``) names axes of the ambient mesh
    (:func:`repro_torch.launch.mesh.use_mesh`): each leaf is read,
    verified and checked whole, and
    :func:`repro_torch.dist.sharding.shard_local` of it is kept — pass
    the *new* mesh's entries to reshard elastically.  Raises
    :class:`LeafMismatchError` on a leaf-count, shape or dtype mismatch
    and :class:`LeafCorruptError` when a leaf file fails its manifest
    CRC32 (``verify=False`` skips the CRC pass), each naming the leaf."""
    leaves_t = [x for _, x in flatten(template)]
    ents, mesh = [None] * len(leaves_t), None
    if shardings is not None:
        ents, mesh = _entries(template, shardings), _mesh()
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if len(manifest["leaves"]) != len(leaves_t):
        raise LeafMismatchError(
            f"checkpoint {path} has {len(manifest['leaves'])} leaves, "
            f"template has {len(leaves_t)}")
    out = []
    for meta, tmpl, ent in zip(manifest["leaves"], leaves_t, ents):
        name = meta.get("name", meta["file"])
        fpath = os.path.join(path, meta["file"])
        try:
            with open(fpath, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise LeafCorruptError(
                f"leaf {name!r}: cannot read {fpath}: {e}") from e
        if verify and "crc32" in meta:
            crc = zlib.crc32(raw)
            if crc != meta["crc32"]:
                raise LeafCorruptError(
                    f"leaf {name!r}: CRC32 mismatch in {fpath} "
                    f"(manifest {meta['crc32']:#010x}, file {crc:#010x})")
        try:
            arr = np.load(io.BytesIO(raw))
        except Exception as e:
            raise LeafCorruptError(
                f"leaf {name!r}: {fpath} is not a loadable .npy: {e}") from e
        shape, dtype = _spec(tmpl)
        if tuple(arr.shape) != shape:
            raise LeafMismatchError(
                f"leaf {name!r}: checkpoint shape {tuple(arr.shape)} != "
                f"template shape {shape}")
        if np.dtype(meta["dtype"]) != dtype:
            raise LeafMismatchError(
                f"leaf {name!r}: checkpoint dtype {meta['dtype']} != "
                f"template dtype {dtype}")
        out.append(_place(arr, tmpl, device, ent, mesh))
    return unflatten(template, out)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, *, retries: int = 2,
                 backoff_s: float = 0.05):
        self.dir = directory
        self.keep = keep
        self.retries = retries
        self.backoff_s = backoff_s
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._inject_fail_saves = 0     # chaos harness: fail next N attempts

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self):
        steps = []
        for d in os.listdir(self.dir):
            if not d.startswith("step_"):
                continue
            try:
                step = int(d.split("_", 1)[1])
            except ValueError:
                continue               # .tmp / quarantined dirs
            if os.path.exists(os.path.join(self.dir, d, "_COMMITTED")):
                steps.append(step)
        return sorted(steps)

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- fault injection (train/faults.CkptTear) ---------------------------
    def inject_failure(self, count: Optional[int] = None) -> None:
        """Make the next ``count`` save *attempts* die mid-write (default:
        enough to exhaust the retry budget, so the failure surfaces)."""
        self._inject_fail_saves = (count if count is not None
                                   else self.retries + 1)

    def _fail_hook(self, leaf_i: int) -> None:
        if self._inject_fail_saves > 0 and leaf_i == 1:
            self._inject_fail_saves -= 1
            raise CheckpointWriteError(
                "injected writer death mid-save (chaos harness)")

    # -- save/restore ------------------------------------------------------
    def _save_with_retry(self, step: int, leaves) -> None:
        path = self._step_dir(step)
        for attempt in range(self.retries + 1):
            try:
                _save_host(leaves, path, fail_hook=self._fail_hook)
                return
            except Exception as e:
                shutil.rmtree(path + ".tmp", ignore_errors=True)
                if attempt == self.retries:
                    raise CheckpointWriteError(
                        f"checkpoint save of step {step} failed after "
                        f"{attempt + 1} attempts: {e}") from e
                time.sleep(self.backoff_s * (2 ** attempt))

    def save(self, step: int, tree: Any, shardings: Any = None) -> None:
        """Save ``step``; with ``shardings``, collectively, as
        :func:`save_tree` (the first rank writes and prunes)."""
        if shardings is None:
            self._save_with_retry(step, [(n, _host(x))
                                         for n, x in flatten(tree)])
            self._gc()
            return

        def write(leaves):
            self._save_with_retry(step, leaves)
            self._gc()
        _save_sharded(tree, shardings, write,
                      f"checkpoint save of step {step}")

    def save_async(self, step: int, tree: Any) -> None:
        """Copy every leaf to host memory now; write in the background.

        Raises any pending error from the *previous* background write
        (via the implicit :meth:`wait`) before starting the new one."""
        self.wait()
        leaves = [(n, _host(x)) for n, x in flatten(tree)]

        def _bg():
            try:
                self._save_with_retry(step, leaves)
                self._gc()
            except BaseException as e:          # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_bg, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join any in-flight background save; re-raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _restore_agreed(self, template, step: int, shardings, device):
        """``(tree, err, fatal)``: :func:`restore_tree` of ``step`` on
        every rank of the world, and their agreement (:func:`_agreed`):
        a step that failed on any rank fails on all."""
        path = self._step_dir(step)
        try:
            tree, err = restore_tree(template, path, shardings,
                                     device=device), None
        except Exception as e:          # agreed on by every rank below
            tree, err = None, e
        err, fatal = _agreed(_mesh(), err, path, CheckpointError)
        return tree, err, fatal

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None, *, device=None) -> Any:
        """Restore ``step`` (raises on any integrity error), or — with
        ``step=None`` — the newest committed step that verifies
        (:meth:`restore_latest`); ``shardings`` as :func:`restore_tree`,
        and then every rank raises if the restore failed on any."""
        if step is None:
            tree, _ = self.restore_latest(template, shardings, device=device)
            return tree
        if shardings is None:
            return restore_tree(template, self._step_dir(step),
                                device=device)
        tree, err, _ = self._restore_agreed(template, step, shardings,
                                            device)
        if err is not None:
            raise err
        return tree

    def restore_latest(self, template: Any, shardings: Any = None, *,
                       device=None):
        """Restore the newest committed checkpoint that verifies clean.

        Returns ``(tree, step)``.  A committed dir that fails restore is
        quarantined — renamed to ``corrupt_<name>`` so it is never retried
        but the evidence survives — and the walk falls back to the
        previous committed step.  With ``shardings`` the world's first
        rank lists the steps for every rank, every rank tries each step
        and they agree before going on: a step that failed with a
        :class:`CheckpointError` on any rank fails on all and the first
        rank alone quarantines it; any other error on any rank is raised
        on every rank.  Raises ``FileNotFoundError`` when no committed
        checkpoint exists and :class:`CheckpointError` when all of them
        are corrupt."""
        steps = self.all_steps()
        if shardings is not None:
            # a step that commits while the ranks list would otherwise
            # give them different steps to restore
            steps = _mesh().gather_objects(steps)[0]
        if not steps:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        last_err: Optional[BaseException] = None
        for s in reversed(steps):
            path = self._step_dir(s)
            if shardings is None:
                try:
                    return restore_tree(template, path,
                                        device=device), s
                except CheckpointError as e:
                    last_err = e
            else:
                tree, err, fatal = self._restore_agreed(template, s,
                                                        shardings, device)
                if err is None:
                    return tree, s
                if fatal:
                    raise err
                last_err = err
            if shardings is None or _mesh().rank == 0:
                quarantine = os.path.join(
                    self.dir, f"corrupt_{os.path.basename(path)}")
                shutil.rmtree(quarantine, ignore_errors=True)
                try:
                    os.replace(path, quarantine)
                except OSError:
                    shutil.rmtree(path, ignore_errors=True)
        raise CheckpointError(
            f"all {len(steps)} committed checkpoints in {self.dir} failed "
            f"verification; newest error: {last_err}")

    def _gc(self) -> None:
        """Prune to the newest ``keep`` committed steps; the newest
        committed dir is never deleted (an uncommitted successor is
        invisible to :meth:`all_steps`)."""
        if not self.keep:
            return
        steps = self.all_steps()
        for s in steps[:-max(self.keep, 1)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
