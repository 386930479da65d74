"""Meshes and collectives by axis name over ``torch.distributed``.

The port of ``repro.launch.mesh``.  The reference builds ``jax`` meshes
and lets GSPMD place the work; the port runs SPMD instead: one process
per mesh position, every process taking the same host decisions, and
the collectives written out where the reference's ``shard_map`` bodies
name them.  A mesh comes in two forms:

* :class:`AbstractMesh` — axis names and sizes only, ``.shape`` a dict
  like a ``jax`` mesh's.  :func:`make_production_mesh` (16×16 or
  2×16×16) and :func:`make_debug_mesh` return it;
  :class:`repro_torch.dist.ShardingRules` reads nothing else.
* :class:`BoundMesh` — an abstract mesh over the current
  ``torch.distributed`` world: this rank's coordinates and one process
  group per set of axes, with the collectives the reference calls as
  ``jax.lax.psum(x, axis_name)`` and friends as methods
  (:meth:`~BoundMesh.psum`, :meth:`~BoundMesh.pmax`,
  :meth:`~BoundMesh.all_gather`, :meth:`~BoundMesh.all_to_all`,
  :meth:`~BoundMesh.axis_index`).  :func:`make_serve_mesh` returns it.

Code that runs under a mesh finds it as the reference finds its ambient
mesh: :func:`use_mesh` sets it for a block, :func:`ambient_mesh` reads
it (``None`` outside any).  The ported layers (attention, MoE, the CP
merge) keep the reference's signatures, which name axes, not meshes;
the block restores the previous mesh on exit.

The backend rule (:data:`BACKEND_RULE`, printed by every card phase that
starts a world): NCCL when each rank has a card of its own; gloo when
ranks share a card or run on the CPU.  Gloo takes CPU tensors here, so a
collective on a CUDA tensor copies it to the host, runs, and copies the
result back: that copy is the collective's transport, the kernels and
the math stay on the card.  NCCL takes CUDA tensors only, so a host
tensor crosses it on the rank's card (:meth:`BoundMesh.wire_device`).

Sums and maxima are gathered and reduced in rank order on every rank
(:meth:`BoundMesh.psum`), so each rank holds the same bits and takes the
same host decisions from them.
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import math
import os
import tempfile
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from repro_torch.dist.context import MeshConfigError

Tensor = torch.Tensor

BACKEND_RULE = ("nccl when each rank has a card of its own; gloo when ranks "
                "share a card or run on the CPU (a CUDA tensor crosses gloo "
                "through host memory)")

_AMBIENT: list = []


class AbstractMesh:
    """Axis names and sizes: ``.shape`` is ``{name: size}`` in axis order."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        if len(sizes) != len(names):
            raise ValueError("one size per axis name")
        self.axis_names: Tuple[str, ...] = tuple(names)
        self.axis_sizes: Tuple[int, ...] = tuple(int(s) for s in sizes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def axis_size(self, axes) -> int:
        """Product of the sizes of ``axes`` (a name or a tuple of names)."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in names)

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


class BoundMesh(AbstractMesh):
    """A mesh over the ranks of the current ``torch.distributed`` world.

    Rank ``r`` of the world sits in replica ``r // size`` at row-major
    coordinates of ``r % size``; each replica of the mesh has its own
    groups.  Without a world (one process) every axis has size 1 and the
    collectives are identities.
    """

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        super().__init__(sizes, names)
        self.backend: Optional[str] = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        n = self.size
        if tdist.is_available() and tdist.is_initialized():
            world, rank = tdist.get_world_size(), tdist.get_rank()
            self.backend = tdist.get_backend()
        else:
            world, rank = 1, 0
        self.rank = rank
        base, local = (rank // n) * n, rank % n
        self.coords: Dict[str, int] = {}
        for name, sz, stride in zip(self.axis_names, self.axis_sizes,
                                    _strides(self.axis_sizes)):
            self.coords[name] = (local // stride) % sz
        if world == 1:
            return
        # every rank creates every group in the same order
        # (torch.distributed.new_group is collective over the world)
        for axes in _axis_subsets(self.axis_names):
            for rep in range(world // n):
                for ranks in _group_ranks(self.axis_names, self.axis_sizes,
                                          axes):
                    ranks = [rep * n + r for r in ranks]
                    g = tdist.new_group(ranks)
                    if rep * n == base and rank in ranks:
                        self._groups[axes] = g

    # -- coordinates -------------------------------------------------------
    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major over a tuple)."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in names:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def _group(self, axes):
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        names = tuple(a for a in self.axis_names if a in names)
        if self.axis_size(names) == 1:
            return None, names
        return self._groups[names], names

    # -- collectives -------------------------------------------------------
    def wire_device(self, x: Tensor) -> torch.device:
        """Where the backend moves ``x``: gloo the host, NCCL the rank's
        card (a host tensor, such as the scheduler's clock, crosses NCCL
        on the card).  The result comes back to ``x``'s device."""
        if self.backend == "gloo":
            return torch.device("cpu")
        if self.backend == "nccl" and not x.is_cuda:
            return torch.device("cuda")         # the rank's current card
        return x.device

    def gather_list(self, x: Tensor, axes) -> list:
        """Every rank's ``x`` along ``axes``, in axis order."""
        g, names = self._group(axes)
        if g is None:
            return [x]
        n = self.axis_size(names)
        src = x.detach().contiguous().to(self.wire_device(x))
        out = [torch.empty_like(src) for _ in range(n)]
        tdist.all_gather(out, src, group=g)
        return [t.to(x.device) for t in out]

    def psum(self, x: Tensor, axes) -> Tensor:
        """Sum over ``axes``, added in rank order on every rank."""
        parts = self.gather_list(torch.as_tensor(x), axes)
        acc = parts[0]
        for t in parts[1:]:
            acc = acc + t
        return acc

    def pmax(self, x: Tensor, axes) -> Tensor:
        parts = self.gather_list(torch.as_tensor(x), axes)
        acc = parts[0]
        for t in parts[1:]:
            acc = torch.maximum(acc, t)
        return acc

    def all_gather(self, x: Tensor, axes, dim: int) -> Tensor:
        """Tiled all-gather: the ranks' ``x`` concatenated along ``dim``."""
        parts = self.gather_list(x, axes)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

    def all_to_all(self, x: Tensor, axes, split: int, concat: int) -> Tensor:
        """Tiled all-to-all: ``x`` cut into ``n`` pieces along ``split``,
        piece ``j`` sent to rank ``j``; the received pieces concatenated
        along ``concat`` in rank order (``jax.lax.all_to_all(...,
        tiled=True)``)."""
        g, names = self._group(axes)
        if g is None:
            return x
        n = self.axis_size(names)
        if x.shape[split] % n:
            raise ValueError(f"all_to_all: dim {split} of {tuple(x.shape)} "
                             f"does not split {n} ways")
        inp = torch.stack(torch.chunk(x.detach(), n, dim=split)).contiguous()
        inp = inp.to(self.wire_device(x))
        out = torch.empty_like(inp)
        tdist.all_to_all_single(out, inp, group=g)
        return torch.cat(out.to(x.device).unbind(0), dim=concat)


def _strides(sizes):
    out, s = [], 1
    for sz in reversed(sizes):
        out.append(s)
        s *= sz
    return list(reversed(out))


def _axis_subsets(names):
    return [c for r in range(1, len(names) + 1)
            for c in itertools.combinations(names, r)]


def _group_ranks(names, sizes, axes):
    """The rank lists (within one replica) of the groups along ``axes``:
    one group per coordinate of the other axes."""
    strides = dict(zip(names, _strides(sizes)))
    shape = dict(zip(names, sizes))
    others = [a for a in names if a not in axes]
    groups = []
    for oc in itertools.product(*(range(shape[a]) for a in others)):
        base = sum(c * strides[a] for a, c in zip(others, oc))
        ranks = [base + sum(c * strides[a] for a, c in zip(axes, ac))
                 for ac in itertools.product(*(range(shape[a])
                                               for a in axes))]
        groups.append(sorted(ranks))
    return groups


# -- ambient mesh ------------------------------------------------------------

@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh for the block (``None`` clears it),
    as ``jax.set_mesh`` does for the reference."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def ambient_mesh():
    """The mesh set by the innermost :func:`use_mesh`, else ``None``."""
    return _AMBIENT[-1] if _AMBIENT else None


# -- factories ---------------------------------------------------------------

def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16×16 single-pod or 2×16×16 two-pod mesh (shapes only)."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_debug_mesh(n_data: int = 2, n_model: int = 2) -> AbstractMesh:
    """Small ``data`` × ``model`` mesh (shapes only)."""
    return AbstractMesh((n_data, n_model), ("data", "model"))


def world_size() -> int:
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


def make_serve_mesh(*, tp: int = 1, cp: int = 1) -> BoundMesh:
    """``(cp, tp)`` serving mesh over the current world: ``data`` (CP
    window shards) × ``model`` (KV-head TP shards), matching
    :func:`repro_torch.dist.serve_pod_ctx`.

    Size-1 axes are kept (a 1×1 mesh is a valid one-process "sharded"
    engine).  Raises :class:`repro_torch.dist.MeshConfigError` up front
    when the request exceeds the world, instead of a late failure inside
    a collective.  A world larger than ``tp·cp`` holds replicas of the
    mesh, each with its own groups; it must be a multiple of ``tp·cp``.
    """
    if tp < 1 or cp < 1:
        raise MeshConfigError(f"tp={tp} and cp={cp} must be >= 1")
    have = world_size()
    if tp * cp > have:
        raise MeshConfigError(
            f"serve mesh needs tp*cp = {tp * cp} devices but only {have} "
            f"are visible (start a torch.distributed world of that many "
            f"ranks: launch.mesh.spawn, or torchrun)")
    if have % (tp * cp):
        raise MeshConfigError(
            f"a world of {have} ranks does not hold whole replicas of a "
            f"tp*cp = {tp * cp} serve mesh")
    return BoundMesh((cp, tp), ("data", "model"))


# -- worlds -----------------------------------------------------------------

def backend_for(device, nprocs: int) -> str:
    """:data:`BACKEND_RULE`: ``nccl`` when each of ``nprocs`` ranks has a
    card of its own, else ``gloo``."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= nprocs:
        return "nccl"
    return "gloo"


def init_world(rank: int, nprocs: int, init_method: str, backend: str, *,
               timeout_s: float = 300.0) -> None:
    """Join a world of ``nprocs`` ranks at ``init_method`` (``file://`` or
    ``tcp://localhost:PORT``); a collective that waits longer than
    ``timeout_s`` raises instead of hanging."""
    tdist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=nprocs,
        timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(rank, nprocs, init_method, backend, timeout_s, threads, fn,
               args, queue):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_world(rank, nprocs, init_method, backend, timeout_s=timeout_s)
        out = fn(rank, *args)
        queue.put((rank, "ok", out))
    except BaseException as e:          # reported to the parent, which fails
        import traceback
        queue.put((rank, "error", f"{type(e).__name__}: {e}\n"
                                  f"{traceback.format_exc()}"))
        raise
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def spawn(fn, nprocs: int, *args, backend: str = "gloo",
          timeout_s: float = 300.0, threads: int = 0) -> list:
    """Run ``fn(rank, *args)`` on ``nprocs`` fresh ranks of one world and
    return their results in rank order.

    The ranks rendezvous through a file in a fresh temporary directory
    (no port to collide with another world), each collective times out
    after ``timeout_s``, and ``threads`` > 0 sets each rank's torch
    thread count.  ``fn`` must be importable by name (the ranks start
    with ``spawn``); CUDA tensors in ``args`` reach the ranks through
    CUDA IPC and must stay alive in the caller until this returns.  A
    rank that fails, dies or outlives the whole world's deadline fails
    the call: every rank is stopped before it raises.
    """
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_world_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, nprocs, init, backend, timeout_s,
                                   threads, fn, args, q), daemon=True)
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        results: Dict[int, object] = {}
        errors = []
        deadline = time.monotonic() + timeout_s + 60.0
        try:
            while len(results) < nprocs and not errors:
                try:
                    rank, status, out = q.get(timeout=1.0)
                except queue_mod.Empty:
                    codes = [p.exitcode for p in procs]
                    lost = [r for r, c in enumerate(codes)
                            if c not in (None, 0) and r not in results]
                    if lost:
                        errors.append(f"ranks {lost} died (exit codes "
                                      f"{codes})")
                    elif time.monotonic() > deadline:
                        errors.append(f"world of {nprocs} ranks timed out "
                                      f"(exit codes {codes})")
                    continue
                if status == "ok":
                    results[rank] = out
                else:
                    errors.append(f"rank {rank}: {out}")
        finally:
            for p in procs:
                p.join(timeout=30.0 if not errors else 2.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(nprocs)]
