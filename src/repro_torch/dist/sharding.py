"""ShardingRules — logical param/activation names → partition entries.

The port of ``repro.dist.sharding``.  One place resolves the layout of
every tree (train state, inference params, batches, decode caches, serve
pools) from leaf *names* and shapes, so model code never hard-codes axis
names and a mesh can be swapped freely.  The reference returns
``NamedSharding``s; here an entry is the tuple the reference builds its
``PartitionSpec`` from — one mesh axis (a name, a tuple of names, or
``None``) per dimension, trailing ``None``s dropped — and
:func:`shard_local` cuts this rank's block of a tensor by it.  The rules
read only ``mesh.shape``, so an abstract mesh (the 16×16 and 2×16×16
production shapes) and a bound one resolve alike.

Axis roles (matching :mod:`repro_torch.dist.context`):
  * ``dp``   — batch/token axis: ``data``, or ``("pod", "data")`` across
    pods;
  * ``tp``   — ``model``: tensor-parallel feature/vocab/head shards and
    the expert-parallel axis for MoE banks;
  * ``fsdp`` — ``data``: parameter sharding, always within a pod.

Resolution is name-aware (embed/head/MoE/down-vs-up projections) with a
divisibility guard: an axis whose size doesn't evenly divide the
dimension is dropped (replicated).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

# 2D weights whose *first* dim is the contraction (fan-in) feature axis that
# upstream tensor parallelism already sharded → shard dim0 over tp.
_DOWN_PROJ = {"w_down", "w_out", "wo", "out_proj"}


def _children(tree):
    """``[(key, child)]`` of a tree node, or ``None`` for a leaf: dicts in
    sorted key order, sequences by index, dataclasses by their array
    fields (``jax.tree`` paths: dict keys, indices, attribute names)."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)
                if _is_data(getattr(tree, f.name))]
    return None


def _is_data(x) -> bool:
    return hasattr(x, "shape") or isinstance(x, (dict, list, tuple)) or \
        (dataclasses.is_dataclass(x) and not isinstance(x, type))


def map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree, keeping dicts (in their own key
    order), sequences and dataclasses."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (str(k),))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return dataclasses.replace(tree, **{
        k: map_with_path(fn, v, path + (k,)) for k, v in kids})


def leaves_with_path(tree, path: Tuple[str, ...] = ()):
    """``[(path, leaf)]`` in ``jax.tree`` order."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    return [item for k, v in kids for item in leaves_with_path(v, path + (k,))]


def spec_str(entries: tuple) -> str:
    """``str(PartitionSpec(*entries))`` as ``jax`` prints it."""
    return f"PartitionSpec{tuple(entries)!r}"


class ShardingRules:
    def __init__(self, mesh, *, multi_pod: bool = False,
                 shard_batch: bool = True, seq_shard_cache: bool = False):
        self.mesh = mesh
        self.multi_pod = multi_pod
        self.shard_batch = shard_batch
        self.seq_shard_cache = seq_shard_cache
        self.dp = ("pod", "data") if multi_pod else "data"
        self.tp = "model"
        self.fsdp = "data"
        # context-parallel KV-window axis: in-pod only, matching
        # DistCtx.cp_axis (pods hold replicas of a long cache)
        self.cp = "data"

    # -- helpers ----------------------------------------------------------
    def _axis_size(self, entry) -> int:
        if entry is None:
            return 1
        names = entry if isinstance(entry, tuple) else (entry,)
        return math.prod(self.mesh.shape[n] for n in names)

    def _guard(self, entries, shape) -> tuple:
        """Drop axes that don't divide their dim; the spec's entries."""
        out = []
        for i, e in enumerate(tuple(entries)[:len(shape)]):
            ok = e is not None and self._axis_size(e) > 0 and \
                shape[i] % self._axis_size(e) == 0
            out.append(e if ok else None)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    # -- parameters / train state -----------------------------------------
    def _param_entries(self, parts: Tuple[str, ...], shape) -> tuple:
        leaf = parts[-1]
        stacked = "stacked" in parts          # leading scan-layer axis
        base = shape[1:] if stacked and len(shape) > 1 else shape
        nd = len(base)
        in_moe = any(p.endswith(":moe") for p in parts) and \
            "shared" not in parts

        if nd < 2:                              # norms, biases, scalars
            ent: tuple = (None,) * nd
        elif "embed" in parts:                  # [V, D] — vocab TP
            ent = (self.tp, None)
        elif "head" in parts:                   # [D, V]
            ent = (None, self.tp)
        elif in_moe and leaf in ("w_gate", "w_up") and nd == 3:
            ent = (self.tp, self.fsdp, None)    # [E, D, F]: EP × FSDP
        elif in_moe and leaf == "w_down" and nd == 3:
            ent = (self.tp, None, self.fsdp)    # [E, F, D]
        elif in_moe and leaf == "router":
            ent = (None,) * nd                  # routing is replicated
        elif nd == 2 and leaf in _DOWN_PROJ:
            ent = (self.tp, self.fsdp)
        elif nd == 2:
            ent = (self.fsdp, self.tp)          # up-projections / qkv
        elif nd == 3 and leaf == "w":
            ent = (None, self.fsdp, self.tp)    # maxout [k, D, F]
        else:
            ent = (None,) * nd
        if stacked and len(shape) > nd:
            ent = (None,) + ent
        return ent

    def params_shardings(self, params):
        """Entry tree of a bare parameter tree."""
        return map_with_path(
            lambda p, leaf: self._guard(
                self._param_entries(p, tuple(leaf.shape)), leaf.shape),
            params)

    def state_shardings(self, state):
        """Entry tree of a whole ``TrainState``: optimizer state mirrors
        the parameter tree; scale state and the step counter replicate."""
        def spec(parts, leaf):
            if parts and parts[0] in ("scale", "step"):
                return ()
            return self._guard(self._param_entries(parts, tuple(leaf.shape)),
                               leaf.shape)
        return map_with_path(spec, state)

    # -- batches -----------------------------------------------------------
    def batch_shardings(self, batch):
        """Token batches: batch dim over ``dp`` (M-RoPE positions carry the
        batch on axis 1)."""
        def spec(parts, leaf):
            nd = len(leaf.shape)
            if not self.shard_batch or nd == 0:
                ent: tuple = (None,) * nd
            elif parts and parts[-1] == "positions" and nd == 3:
                ent = (None, self.dp) + (None,) * (nd - 2)
            else:
                ent = (self.dp,) + (None,) * (nd - 1)
            return self._guard(ent, leaf.shape)
        return map_with_path(spec, batch)

    # -- decode caches ------------------------------------------------------
    def cache_shardings(self, cache):
        """Decode caches: stacked-layer leaves [L, B, ...] shard the batch;
        with ``seq_shard_cache`` the KV ring *window* axis shards over
        ``cp`` instead (context parallelism)."""
        bdim = self.dp if self.shard_batch else None

        def spec(parts, leaf):
            leafname = parts[-1] if parts else ""
            nd = len(leaf.shape)
            if leafname == "enc_memory":
                ent: tuple = (bdim,) + (None,) * (nd - 1)
            elif (self.seq_shard_cache and nd >= 3
                  and leafname in ("k", "v", "pos")):
                ent = (None, None, self.cp) + (None,) * (nd - 3)
            elif nd >= 2:
                ent = (None, bdim) + (None,) * (nd - 2)
            else:
                ent = (None,) * nd
            return self._guard(ent, leaf.shape)
        return map_with_path(spec, cache)

    # -- serve KV pools -----------------------------------------------------
    def pool_shardings(self, pool):
        """Entry tree of a serve KV pool (raw, slot-major or paged).

        * K/V storage (``k``/``v`` raw, ``k_m``/``v_m`` mantissas) shards
          the **kv-head** axis over ``tp`` — slot-major ``[L, B, W, K,
          hd]`` and paged arenas ``[L, n_pages, P, K, hd]`` both carry it
          at axis 3.  Per-head attention never contracts across heads, so
          a head-sharded pool is exact;
        * with ``seq_shard_cache`` (context parallelism), slot-major
          storage and ``pos`` also shard the ring **window** axis over
          ``cp``.  Paged pools never CP-shard (the combination is refused
          upstream);
        * exponents, §5 counters, block tables and every non-attention
          entry replicate — per-slot/per-page scalars the controller
          must see whole.

        The divisibility guard applies as everywhere else: an axis that
        does not divide its dim (4-way ``tp`` over 2 kv heads) drops to
        replicated, and the attention kernels then run their unsharded
        call on the same condition.
        """
        tp = self.tp if self.tp in self.mesh.shape else None
        cp = self.cp if (self.seq_shard_cache
                         and self.cp in self.mesh.shape) else None

        def replicate(sub):
            return map_with_path(lambda p, x: (), sub)

        def entry_specs(entry):
            paged = "bt" in entry
            out = {}
            for name, leaf in entry.items():
                nd = len(leaf.shape)
                if name in ("k", "v", "k_m", "v_m") and nd == 5:
                    win = None if paged else cp
                    ent: tuple = (None, None, win, tp, None)
                elif not paged and name == "pos" and nd == 3:
                    ent = (None, None, cp)
                else:
                    ent = (None,) * nd
                out[name] = self._guard(ent, leaf.shape)
            return out

        def is_attn(e):
            return isinstance(e, dict) and "pos" in e and \
                ("k" in e or "k_m" in e)

        return {sname: {bkey: entry_specs(e) if is_attn(e) else replicate(e)
                        for bkey, e in sc.items()}
                for sname, sc in pool.items()}

    # -- introspection ------------------------------------------------------
    def describe(self, tree) -> Dict[str, str]:
        """Human-readable ``{path: spec}`` map of a parameter tree."""
        return {"/".join(p): spec_str(self._guard(
                    self._param_entries(p, tuple(leaf.shape)), leaf.shape))
                for p, leaf in leaves_with_path(tree)}


def shard_local(x: torch.Tensor, entries: tuple, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``entries``:
    each sharded dim cut to the rank's contiguous slice (row-major over a
    tuple of axes), as a new contiguous tensor."""
    for dim, e in enumerate(entries):
        if e is None:
            continue
        n = mesh.axis_size(e)
        if n == 1:
            continue
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(e) * size, size)
    return x.contiguous()


def shard_tree(tree, specs, mesh):
    """:func:`shard_local` over a tree and its entry tree."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard_local(tree, specs, mesh)
