"""Multi-pod dry run of the port: trace every (arch × shape × mesh) cell.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell's real ``jit`` program for 512 forced host devices and runs it
on none; the port builds each cell's real step (the train step of
:func:`repro_torch.train.make_train_step` for train shapes, prefill or
one decode step for inference shapes) at its **global** shapes on the
**meta** device (tensors with a shape and a dtype, no data), so it
never touches a card, and lays the step's trees out by
:class:`repro_torch.dist.ShardingRules` on the 16×16 single-pod (256
chips) and 2×16×16 two-pod (512 chips) abstract meshes.  One JSON line a
cell, with the reference's keys:

  * ``per_device.{argument,output,alias}_bytes`` — exact: the bytes of
    rank 0's block of every leaf under the rules' entries;
  * ``flops`` (per device, ``flops_global / chips``), ``bytes_accessed``
    and ``transcendentals`` — counted over one trace of the step by
    :class:`OpCounter` (one microbatch traced and counted ``microbatches``
    times: the reference's ``known_trip_count``);
  * ``per_device.temp_bytes`` — the trace's peak of live non-argument
    bytes, divided by chips;
  * ``collectives`` — implied by the rules (:func:`implied_collectives`);
  * ``loop_aware`` — the same counts under ``benchmarks.hlo_cost``'s names.

PyTorch has no partitioner and no HLO, so ``lower_s``/``compile_s``
become ``trace_s``, the gzipped HLO becomes ``ops`` (a census of the
trace's aten operations), and ``basis`` says in words how each figure
was found.  The trace runs the plain PyTorch routes of K1 and K2: a
counter cannot see into a launched kernel.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--out results.jsonl]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gzip
import json
import math
import os
import time
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, ShapeSpec, input_specs
from repro_torch.core import quant
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist.context import DistCtx, multi_pod_ctx, single_pod_ctx
from repro_torch.dist.sharding import ShardingRules, leaves_with_path
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim.opt import OptConfig, adamw_init, sgd_init
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train import step as train_step

Tensor = torch.Tensor
aten = torch.ops.aten

# Per-arch dry-run settings, the reference's (``dryrun.py:44-58``):
# paper-faithful DFXP (10/12) everywhere; float16 containers hold the
# DFXP grid exactly (≤12 bits) at half the memory of f32 where f32
# activations/storage cannot fit; llama4's 400B params additionally need
# packed int16 storage.
ARCH_SETTINGS = {
    "zamba2_1p2b": dict(compute="float32", storage="sim", microbatches=8),
    "llama3_8b": dict(compute="float32", storage="sim", microbatches=8),
    "qwen3_14b": dict(compute="float32", storage="sim", microbatches=8),
    "phi3_medium_14b": dict(compute="float32", storage="sim", microbatches=8),
    "gemma3_27b": dict(compute="float16", storage="sim", microbatches=16),
    "seamless_m4t_medium": dict(compute="float32", storage="sim",
                                microbatches=8),
    "llama4_maverick_400b": dict(compute="float16", storage="packed",
                                 microbatches=16),
    "granite_moe_1b": dict(compute="float32", storage="sim", microbatches=8),
    "mamba2_370m": dict(compute="float32", storage="sim", microbatches=8),
    "qwen2_vl_72b": dict(compute="float16", storage="sim", microbatches=16),
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

OVERRIDES: dict = {}

BASIS = {
    "argument_bytes": "exact: rank 0's block of every input leaf under "
                      "ShardingRules (train: state and batch, no key: the "
                      "rounding is deterministic; prefill: params, batch, "
                      "exponents; decode: params, cache, tokens, position, "
                      "exponents)",
    "output_bytes": "exact: rank 0's block of every output leaf (train: "
                    "state and three scalar metrics; prefill and decode: "
                    "the last logits over (dp, model) and the cache)",
    "alias_bytes": "exact: the donated state (train) or cache (decode)",
    "temp_bytes": "counted: the peak of live non-argument bytes over one "
                  "trace of the step at global shapes, divided by chips "
                  "(one process's schedule, no fusion; not held to the "
                  "reference's)",
    "flops": "counted: 2*M*N*K per matrix product (torch.utils."
             "flop_counter's formulas) over the trace, the microbatch "
             "body counted once per microbatch; flops = flops_global / "
             "chips (an even split); MoE capacity at the global token "
             "count",
    "bytes_accessed": "counted: operand and result bytes of every aten op "
                      "but views, unfused (an upper bound of XLA's fused "
                      "figure), divided by chips; not held to the "
                      "reference's",
    "transcendentals": "counted: output elements of exp, log, tanh, rsqrt, "
                       "sqrt, sigmoid, erf, pow, softmax, silu, gelu and "
                       "kin, divided by chips; not held to the reference's",
    "collectives": "implied by the rules, per device and per step: output "
                   "bytes of each collective (implied_collectives)",
    "loop_aware": "the same counts under benchmarks.hlo_cost's keys "
                  "(collective_bytes = collectives.total_bytes)",
}


def policy_for(arch: str) -> PrecisionPolicy:
    s = ARCH_SETTINGS[arch]
    return PrecisionPolicy("dfxp", comp_width=10, update_width=12,
                           update_interval=100, storage=s["storage"],
                           compute_dtype=OVERRIDES.get("compute",
                                                       s["compute"]),
                           a2a_compress_bits=OVERRIDES.get("a2a_bits", 0))


# ---------------------------------------------------------------------------
# counting one trace
# ---------------------------------------------------------------------------

_TRANSCENDENTAL = {
    aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p, aten.log2,
    aten.log10, aten.tanh, aten.sigmoid, aten.rsqrt, aten.sqrt, aten.erf,
    aten.erfinv, aten.erfc, aten.sin, aten.cos, aten.pow, aten._softmax,
    aten._log_softmax, aten.silu, aten.silu_backward, aten.gelu,
    aten.gelu_backward, aten.softplus, aten.logsumexp}


def _tensors(obj):
    if isinstance(obj, Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class OpCounter(TorchDispatchMode):
    """Counts one trace: matrix-product flops (``flop_registry``), the
    operand and result bytes of every non-view op, transcendental
    elements, a census ``{op and input shapes: [count, flops]}``, and the
    peak of live bytes allocated inside the trace.

    Live bytes follow storages: each new storage adds its bytes and a
    ``weakref.finalize`` on it takes them off when the last tensor on it
    dies (a meta storage's Python object is kept with it, so the callback
    fires when the storage does, saved tensors of the autograd graph
    included).  Storages that exist before the trace (the arguments)
    count nothing (:meth:`known`).  :meth:`repeat` multiplies the counts
    of a block (not its memory); :meth:`paused` counts only memory."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.census: Dict[str, list] = {}
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        self._mult = 1
        self._paused = False

    def known(self, tree) -> None:
        """Mark the storages of ``tree``'s tensors as present already."""
        for t in _tensors(tree):
            self._note(t.untyped_storage(), 0)

    def _note(self, st, nbytes: int) -> None:
        k = id(st)
        if k in self._sizes:
            return
        self._sizes[k] = nbytes
        weakref.finalize(st, self._free, k)
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _free(self, k: int) -> None:
        self.live -= self._sizes.pop(k, 0)

    @contextlib.contextmanager
    def repeat(self, n: int):
        old, self._mult = self._mult, self._mult * n
        try:
            yield
        finally:
            self._mult = old

    @contextlib.contextmanager
    def paused(self):
        old, self._paused = self._paused, True
        try:
            yield
        finally:
            self._paused = old

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in _tensors(out):
            st = t.untyped_storage()
            self._note(st, st.nbytes())
        if self._paused:
            return out
        m = self._mult
        pkt = func.overloadpacket
        fl = 0.0
        if pkt in flop_registry:
            fl = float(flop_registry[pkt](*args, **kwargs, out_val=out))
            self.flops += m * fl
        if not _is_view(func) and "empty" not in str(pkt):
            self.bytes += m * sum(t.numel() * t.element_size()
                                  for t in (*_tensors(args),
                                            *_tensors(kwargs),
                                            *_tensors(out)))
        if pkt in _TRANSCENDENTAL:
            self.transcendentals += m * sum(t.numel()
                                            for t in _tensors(out))
        key = f"{func} " + ",".join(
            f"{str(t.dtype)[6:]}{list(t.shape)}" for t in _tensors(args))
        c = self.census.setdefault(key, [0, 0.0])
        c[0] += m
        c[1] += m * fl
        return out


def _template(obj):
    if isinstance(obj, Tensor):
        return ("tensor", tuple(obj.shape), obj.dtype)
    if isinstance(obj, dict):
        return {k: _template(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_template(v) for v in obj)
    return obj


def _fresh(tmpl, device):
    if isinstance(tmpl, tuple) and tmpl and tmpl[0] == "tensor":
        return torch.empty(tmpl[1], dtype=tmpl[2], device=device)
    if isinstance(tmpl, dict):
        return {k: _fresh(v, device) for k, v in tmpl.items()}
    if isinstance(tmpl, (list, tuple)):
        return type(tmpl)(_fresh(v, device) for v in tmpl)
    return tmpl


@contextlib.contextmanager
def _step_counted(counter: OpCounter, cell: dict, *,
                  every_microbatch: bool = False):
    """The process-wide state a trace changes, in one place and restored
    after: K1 off (:func:`repro_torch.core.quant.plain_quantize`; the
    policy of :func:`make_cell` leaves K2 off), and the train step's
    ``train.step.loss_and_grads`` wrapped.  The wrapper traces the first
    microbatch's forward and backward counted ``n`` times and gives the
    other ``n - 1`` calls fresh tensors of its results' shapes, counted
    for memory only: the reference's ``known_trip_count``.  The
    accumulation across microbatches runs and counts as it is.
    ``every_microbatch`` traces each call instead.  Raises unless the
    step called the wrapper once a microbatch (a train step) or never
    (prefill, decode): the count of ``n`` holds only then."""
    n = cell["microbatches"]
    want = n if cell["shape"].kind == "train" else 0
    orig = train_step.loss_and_grads
    first = []
    calls = 0

    def counted(*args, **kwargs):
        nonlocal calls
        calls += 1
        if every_microbatch:
            return orig(*args, **kwargs)
        if first:
            with counter.paused():
                return _fresh(first[0], "meta")
        with counter.repeat(n):
            res = orig(*args, **kwargs)
        first.append(_template(res))
        return res

    train_step.loss_and_grads = counted
    try:
        with quant.plain_quantize():
            yield
    finally:
        train_step.loss_and_grads = orig
    if calls != want:
        raise RuntimeError(f"the step called train.step.loss_and_grads "
                           f"{calls} times, not {want}: its microbatches "
                           f"were not counted")


# ---------------------------------------------------------------------------
# per-device bytes
# ---------------------------------------------------------------------------

def leaf_specs(tree, specs) -> list:
    """``[(tensor, entries)]`` of a tree and its entry tree."""
    if isinstance(tree, Tensor):
        return [(tree, specs)]
    if isinstance(tree, dict):
        return [p for k in tree for p in leaf_specs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [p for a, b in zip(tree, specs) for p in leaf_specs(a, b)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [p for f in dataclasses.fields(tree)
                for p in leaf_specs(getattr(tree, f.name),
                                    getattr(specs, f.name))]
    return []


def block_bytes(t: Tensor, entries, mesh) -> int:
    """Bytes of one device's block of ``t`` under ``entries`` (an uneven
    split pads, as XLA's does)."""
    shape = list(t.shape)
    for d, e in enumerate(tuple(entries or ())[:len(shape)]):
        if e is not None:
            shape[d] = -(-shape[d] // mesh.axis_size(e))
    return math.prod(shape) * t.element_size()


def tree_bytes(tree, specs, mesh) -> int:
    return sum(block_bytes(t, e, mesh) for t, e in leaf_specs(tree, specs))


def replicated(tree):
    """The entry tree of a replicated tree."""
    if isinstance(tree, Tensor):
        return ()
    if isinstance(tree, dict):
        return {k: replicated(v) for k, v in tree.items()}
    return type(tree)(replicated(v) for v in tree)


# ---------------------------------------------------------------------------
# collectives implied by the rules
# ---------------------------------------------------------------------------

def _has(entry, axis: str) -> bool:
    if entry is None:
        return False
    return axis in (entry if isinstance(entry, tuple) else (entry,))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def _param_leaves(params, pspecs):
    """``[(path, tensor, entries)]`` of the parameter tree."""
    out = []

    def walk(t, s, path):
        if isinstance(t, Tensor):
            out.append((path, t, s))
        elif isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], path + (k,))
        elif dataclasses.is_dataclass(t):     # a packed leaf: its mantissa
            walk(t.mantissa, s.mantissa, path)
    walk(params, pspecs, ())
    return out


def param_gathers(params, pspecs, mesh, rules, *, passes: int) -> list:
    """All-gather over ``fsdp`` of every parameter leaf the rules shard
    over ``fsdp``, ``passes`` times a step (train: the forward and the
    backward of each microbatch; inference: once), one a layer of a
    layer-stacked leaf.  Output bytes: the layer's block whole over
    ``fsdp``."""
    n = mesh.axis_size(rules.fsdp)
    out = []
    for path, t, ent in _param_leaves(params, pspecs):
        if any(_has(e, rules.fsdp) for e in ent):
            layers = t.shape[0] if "stacked" in path else 1
            out.append(("all-gather",
                        block_bytes(t, ent, mesh) * n // layers,
                        passes * layers))
    return out


def grad_reductions(params, pspecs, mesh, rules, grad_dtype) -> list:
    """Once a step: a reduce-scatter over ``fsdp`` of the gradient of
    every leaf the rules shard over ``fsdp`` (output: its block) — and
    across pods an all-reduce of that block over ``pod``, which the
    in-pod ``fsdp`` leaves out — and an all-reduce over the ``dp`` axes
    of every other leaf's gradient block."""
    dp = rules.dp if isinstance(rules.dp, tuple) else (rules.dp,)
    pods = tuple(a for a in dp if a != rules.fsdp)
    out = []
    for _, t, ent in _param_leaves(params, pspecs):
        b = block_bytes(t, ent, mesh) // t.element_size() * \
            _itemsize(grad_dtype)
        if any(_has(e, rules.fsdp) for e in ent):
            out.append(("reduce-scatter", b, 1))
            if pods and mesh.axis_size(pods) > 1:
                out.append(("all-reduce", b, 1))
        elif mesh.axis_size(dp) > 1:
            out.append(("all-reduce", b, 1))
    return out


def _matmul_weights(cfg, blk, decode: bool) -> tuple:
    """The 2-D weights a sub-block multiplies by (not the MoE banks);
    a decode step's cross-attention reads its cached K/V, not wk/wv."""
    w, _ = T.block_sites(cfg, blk)
    return tuple(n for n in w
                 if not (blk.kind == "moe" and "/" not in n)
                 and not (decode and blk.kind == "xattn"
                          and n in ("wk", "wv")))


def tp_activations(cfg, params, pspecs, rules, *, tokens: int,
                   src_tokens: int, act_dtype, train: bool, decode: bool,
                   fwd_passes: int) -> list:
    """All-reduce over ``model`` of each use's output wherever the rules
    put ``tp`` on a weight's contraction dimension (the ``_DOWN_PROJ``
    weights, the vocab-sharded embedding's lookup), ``fwd_passes`` times
    (a recomputed forward counts again), and in training of each use's
    input gradient wherever they put it on the output dimension (the
    up-projections, the vocab-sharded head).  ``tokens``/``src_tokens``:
    this device's tokens of one microbatch (decoder / encoder; a decode
    step runs no encoder); bytes: ``tokens × width × act_dtype``.  Counts
    per microbatch."""
    tp = rules.tp
    isz = _itemsize(act_dtype)
    out = []
    leaves = {"/".join(p): (t, e) for p, t, e in _param_leaves(params,
                                                             pspecs)}

    def use(t, ent, n_tok, times, stacked):
        base = tuple(ent[1:] if stacked else ent)
        base = base + (None,) * (2 - len(base))
        d_in, d_out = t.shape[-2], t.shape[-1]
        if _has(base[0], tp):
            out.append(("all-reduce", n_tok * d_out * isz,
                        fwd_passes * times))
        if train and _has(base[1], tp):
            out.append(("all-reduce", n_tok * d_in * isz, times))

    for stage in T.build_stages(cfg):
        if decode and not stage.decoder:
            continue
        for i, blk in enumerate(stage.blocks):
            bkey = f"{i}:{blk.kind}"
            sub = "shared" if blk.shared else "stacked"
            for w in _matmul_weights(cfg, blk, decode):
                path = f"stages/{stage.name}/{sub}/{bkey}/{w}"
                if path not in leaves:
                    continue
                t, ent = leaves[path]
                n_tok = tokens if stage.name != "enc" else src_tokens
                if blk.kind == "xattn" and w in ("wk", "wv"):
                    n_tok = src_tokens
                use(t, ent, n_tok, stage.count, not blk.shared)
    if "embed" in leaves:                 # the lookup contracts over vocab
        t, ent = leaves["embed"]
        if _has(ent[0] if ent else None, tp):
            out.append(("all-reduce", tokens * t.shape[1] * isz,
                        fwd_passes))
    head = leaves.get("head") or (leaves.get("embed") if cfg.tied
                                  else None)
    if head is not None and train:        # the head's input gradient
        t, ent = head
        vdim = 0 if cfg.tied else 1
        ent = tuple(ent) + (None,) * (2 - len(ent))
        if _has(ent[vdim], tp):
            out.append(("all-reduce", tokens * cfg.d_model * isz, 1))
    return out


def _moe_layers(cfg) -> int:
    return sum(st.count for st in T.build_stages(cfg) for b in st.blocks
               if b.kind == "moe")


def experts(cfg, dist: DistCtx, mesh, *, tokens_global: int, act_dtype,
            a2a_bits: int, decode: bool, passes: int) -> list:
    """Two all-to-alls over ``ep`` of the local ``[E, C, D]`` per MoE
    layer, dispatch and combine, ``passes`` times a step (forward, a
    recomputed forward, backward), each element in ``a2a_bits`` integer
    lanes when set; ``C`` is the capacity of a rank's tokens over
    ``dist.token_axes`` (decode: dropless).  The stationary decode
    (``moe_stationary``) adds two all-reduces over ``fsdp`` of ``[E, C,
    F]`` (the gate and up partial products) and an all-gather of ``[E, C,
    D]`` per layer, where its banks stay in place."""
    n_layers = _moe_layers(cfg)
    if not n_layers or not dist.ep_axis or \
            mesh.axis_size(dist.ep_axis) == 1:
        return []
    spec = cfg.moe_spec
    t_local = tokens_global // mesh.axis_size(tuple(dist.token_axes) or ())
    C = M.capacity(t_local, spec, dropless=decode)
    E, D, F = spec.num_experts, spec.d_model, spec.d_ff
    isz = _itemsize(act_dtype)
    lane = isz if not a2a_bits else (1 if a2a_bits <= 8 else
                                     2 if a2a_bits <= 16 else 4)
    out = [("all-to-all", E * C * D * lane, 2 * passes * n_layers)]
    if decode and dist.moe_stationary and dist.fsdp_axis:
        out += [("all-reduce", E * C * F * isz, 2 * n_layers),
                ("all-gather", E * C * D * isz, n_layers)]
    return out


def cp_merge(batch: int, heads: int, head_dim: int) -> list:
    """The exact merge of one CP decode attention call
    (``dist/cp_attention.py:60-63``): a pmax of the ``[B, H]`` maxima and
    psums of the ``[B, H]`` sums and the ``[B, H, hd]`` outputs, f32 —
    three all-reduces."""
    return [("all-reduce", batch * heads * 4, 2),
            ("all-reduce", batch * heads * head_dim * 4, 1)]


def long_context(cfg, dist: DistCtx, cache, cspecs, mesh) -> list:
    """Per decode step, each attention layer whose ring the rules shard
    over ``cp`` (``seq_shard_cache``): a global layer merges its partial
    softmax exactly (:func:`cp_merge`); a windowed layer gathers its
    ring's k, v and pos over ``cp`` first (``KVShard.gather_window``)."""
    if not (dist.cp_decode and dist.cp_axis):
        return []
    out = []
    H, hd = cfg.num_heads, cfg.head_dim
    for stage in T.decoder_stages(cfg):
        for i, blk in enumerate(stage.blocks):
            bkey = f"{i}:{blk.kind}"
            if blk.kind != "attn":
                continue
            entry, espec = cache[stage.name][bkey], cspecs[stage.name][bkey]
            ent = tuple(espec["k"]) + (None,) * 3
            if not _has(ent[2], dist.cp_axis):
                continue
            B = entry["pos"].shape[1]           # the batch is whole here
            n = stage.count
            if blk.window:
                n_cp = mesh.axis_size(ent[2])
                for name in ("k", "v", "pos"):
                    out.append(("all-gather", block_bytes(
                        entry[name], espec[name], mesh) * n_cp, n))
            else:
                out += [(k, b, c * n) for k, b, c in cp_merge(B, H, hd)]
    return out


def implied_collectives(cell: dict) -> dict:
    """Per device and per step: ``{"bytes", "count"}`` by the reference's
    five kinds, ``total_bytes``, and ``by_rule`` (the bytes of each rule
    above).  Bytes are each collective's output bytes, as the reference's
    ``collective_bytes`` counts them."""
    cfg, shape, mesh = cell["cfg"], cell["shape"], cell["mesh"]
    rules, dist, policy = cell["rules"], cell["dist"], cell["policy"]
    params, pspecs = cell["params"], cell["param_specs"]
    cdtype = getattr(torch, policy.compute_dtype)
    train = shape.kind == "train"
    decode = shape.kind == "decode"
    mb = cell["microbatches"]
    remat = cell["remat"] != "none"
    B = shape.global_batch // mb
    S = 1 if decode else shape.seq_len
    dp = mesh.axis_size(rules.dp) if rules.shard_batch else 1
    tokens = B * S // dp
    src = (B * shape.seq_len // dp) if cfg.encoder_layers else 0
    fwd = 2 if (train and remat) else 1
    rule = {
        "param_gathers": param_gathers(params, pspecs, mesh, rules,
                                       passes=2 * mb if train else 1),
        "grad_reductions": grad_reductions(
            params, pspecs, mesh, rules,
            cdtype if policy.storage == "packed" else torch.float32)
        if train else [],
        "tp_activations": [
            (k, b, c * (mb if train else 1)) for k, b, c in tp_activations(
                cfg, params, pspecs, rules, tokens=tokens, src_tokens=src,
                act_dtype=cdtype, train=train, decode=decode,
                fwd_passes=fwd)],
        "experts": experts(cfg, dist, mesh, tokens_global=B * S,
                           act_dtype=cdtype,
                           a2a_bits=policy.a2a_compress_bits, decode=decode,
                           passes=(fwd + 1) * mb if train else 1),
        "long_context": long_context(cfg, dist, cell["cache"],
                                     cell["cache_specs"], mesh)
        if decode else [],
    }
    by_kind = {k: 0.0 for k in COLLECTIVES}
    count = {k: 0 for k in COLLECTIVES}
    by_rule = {}
    for name, items in rule.items():
        by_rule[name] = float(sum(b * c for _, b, c in items))
        for kind, b, c in items:
            by_kind[kind] += b * c
            count[kind] += c
    return {"bytes": by_kind, "count": count,
            "total_bytes": sum(by_kind.values()), "by_rule": by_rule}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.axis_sizes)


def _dist_for(multi_pod: bool, long_ctx: bool) -> DistCtx:
    dist = multi_pod_ctx() if multi_pod else single_pod_ctx()
    if OVERRIDES.get("attn_seq_shard"):
        dist = dataclasses.replace(dist, attn_seq_shard=True)
    if OVERRIDES.get("moe_stationary"):
        dist = dataclasses.replace(dist, moe_stationary=True)
    if long_ctx:
        # the KV window is sharded (seq_shard_cache below): decode
        # attention runs the context-parallel exact merge over it
        dist = dataclasses.replace(dist, cp_decode=True)
    return dist


def build_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """One cell of the reference's matrix: the arch's full config, the
    shape, the production mesh and its rules (``dryrun.py:125-153``)."""
    cfg = configs.get(arch)
    if OVERRIDES.get("ssm_chunk"):
        cfg = dataclasses.replace(cfg, ssm_chunk=OVERRIDES["ssm_chunk"])
    shape = SHAPES[shape_name]
    long_ctx = shape_name == "long_500k"
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = ShardingRules(mesh, multi_pod=multi_pod,
                          shard_batch=not long_ctx,
                          seq_shard_cache=long_ctx)
    mb = 1
    if shape.kind == "train":
        mb = OVERRIDES.get("microbatches",
                           ARCH_SETTINGS[arch]["microbatches"])
        if multi_pod:
            mb = min(mb, shape.global_batch // (2 * 16))
    return make_cell(cfg, shape, policy_for(arch), mesh, rules,
                     _dist_for(multi_pod, long_ctx), microbatches=mb,
                     remat=OVERRIDES.get("remat", "full"),
                     ce_chunk=OVERRIDES.get("ce_chunk", 512))


@functools.lru_cache(maxsize=4)
def _meta_params(cfg):
    """A config's parameter tree on the meta device (read only: every
    cell of the config shares it)."""
    return T.init_params(cfg, 0, device="meta")


@functools.lru_cache(maxsize=2)
def _meta_state(cfg, policy: PrecisionPolicy, opt_kind: str):
    """The train state the step starts from, on the meta device (the step
    is functional: it returns a new state and leaves this one be)."""
    params = _meta_params(cfg)
    opt = sgd_init(params) if opt_kind == "sgd" else adamw_init(params)
    return init_train_state(params, opt, T.group_shapes(cfg), policy,
                            init_exp=-8.0)


def make_cell(cfg, shape: ShapeSpec, policy: PrecisionPolicy, mesh, rules,
              dist: Optional[DistCtx] = None, *, microbatches: int = 1,
              remat: str = "none", ce_chunk: int = 0,
              opt: Optional[OptConfig] = None) -> dict:
    """A cell's trees on the meta device and its step, ready to
    :func:`trace` (any config and shape: the chip smoke's cells and the
    tests' smoke cells use it directly).  The step runs one process's
    math at global shapes (``dist`` is read by the collective rules
    only), through the plain routes of K1 and K2 whatever the policy
    asks (``fused_matmul`` and ``fused_decode`` off)."""
    # the plain routes: a counter cannot see into a kernel's launch
    policy = dataclasses.replace(policy, fused_matmul=False,
                                 fused_decode=False)
    gs = T.group_shapes(cfg)
    cdtype = getattr(torch, policy.compute_dtype)
    specs = input_specs(cfg, shape)
    cell = dict(cfg=cfg, shape=shape, policy=policy, mesh=mesh, rules=rules,
                dist=dist or DistCtx(), microbatches=microbatches,
                remat=remat, ce_chunk=ce_chunk, cache=None, cache_specs=None)
    params = _meta_params(cfg)
    if shape.kind == "train":
        opt = opt or OptConfig(kind="sgd", lr=0.01, lr_decay_steps=100_000)
        state = _meta_state(cfg, policy, opt.kind)
        batch = specs["batch"]

        def loss(p, b, s, e):
            return T.loss_fn(cfg, policy, p, b, e, s, ce_chunk=ce_chunk,
                             remat=remat)

        step = make_train_step(loss, gs, policy, opt,
                               microbatches=microbatches,
                               compute_dtype=cdtype)
        state_specs = rules.state_shardings(state)
        metrics = {k: torch.empty((), device="meta")
                   for k in ("loss", "grad_norm", "step")}
        cell.update(
            params=state.params, param_specs=state_specs.params,
            args={"state": (state, state_specs),
                  "batch": (batch, rules.batch_shardings(batch))},
            outputs={"state": (state, state_specs),
                     "metrics": (metrics, replicated(metrics))},
            donated="state", run=lambda: step(state, batch))
        return cell

    exps = {n: torch.zeros(s, device="meta") for n, s in gs.items()}
    pspecs = rules.params_shardings(params)
    cell.update(params=params, param_specs=pspecs)
    dp = rules.dp if rules.shard_batch else None
    B, S = shape.global_batch, shape.seq_len
    src = S if cfg.encoder_layers else 0
    logits = (torch.empty((B, cfg.vocab_size), dtype=cdtype, device="meta"),
              (dp, "model"))                    # the reference's, unguarded
    if shape.kind == "prefill":
        batch = specs["batch"]

        def run():
            with torch.no_grad():
                logits, _, cache = T.prefill(cfg, policy, params, batch,
                                             exps, max_cache_len=S)
            return logits, cache

        cache = T.init_cache(cfg, B, S, src_len=src, device="meta",
                             dtype=cdtype)
        cell.update(args={"params": (params, pspecs),
                          "batch": (batch, rules.batch_shardings(batch)),
                          "exps": (exps, replicated(exps))},
                    outputs={"logits": logits,
                             "cache": (cache, rules.cache_shardings(cache))},
                    donated=None, run=run)
        return cell

    cache = T.init_cache(cfg, B, S, src_len=src, device="meta", dtype=cdtype)
    cspecs = rules.cache_shardings(cache)
    tok, pos = specs["tokens"], specs["pos"]
    tok_specs = ((dp,) if cfg.input_mode == "tokens" else (dp, None, None)) \
        if rules.shard_batch else ()        # the reference's, unguarded

    def run():
        with torch.no_grad():
            logits, _, out = T.decode_step(cfg, policy, params, cache, tok,
                                           pos.expand(B), exps)
        return logits, out

    cell.update(args={"params": (params, pspecs), "cache": (cache, cspecs),
                      "tokens": (tok, tok_specs),
                      "pos": (pos, ()), "exps": (exps, replicated(exps))},
                outputs={"logits": logits, "cache": (cache, cspecs)},
                donated="cache", run=run, cache=cache, cache_specs=cspecs)
    return cell


def _leaf_types(tree) -> list:
    return [(tuple(t.shape), t.dtype) for _, t in leaves_with_path(tree)]


def _check_outputs(cell: dict, out) -> None:
    """The step's outputs are the declared ones, leaf for leaf (shape
    and dtype): the output bytes are counted on the declared trees."""
    for name, got in zip(cell["outputs"], out):
        want = _leaf_types(cell["outputs"][name][0])
        have = _leaf_types(got)
        if have != want:
            bad = [(h, w) for h, w in zip(have, want) if h != w][:3]
            raise ValueError(f"the step's {name} is not the declared tree "
                             f"({len(have)} vs {len(want)} leaves; {bad})")


def trace(cell: dict, *, every_microbatch: bool = False) -> dict:
    """Run the cell's step once under :class:`OpCounter`: its counts
    (global) and the trace's seconds; the outputs are checked against the
    declared trees.  A train step's first microbatch is traced and
    counted once a microbatch; ``every_microbatch`` traces them all
    (slower; the same counts)."""
    counter = OpCounter()
    for tree, _ in cell["args"].values():
        counter.known(tree)
    t0 = time.perf_counter()
    with counter, _step_counted(counter, cell,
                                every_microbatch=every_microbatch):
        out = cell["run"]()
    trace_s = time.perf_counter() - t0
    _check_outputs(cell, out)
    return {"flops": counter.flops, "bytes": counter.bytes,
            "transcendentals": counter.transcendentals,
            "peak": counter.peak, "census": counter.census,
            "trace_s": trace_s}


def cell_bytes(cell: dict) -> dict:
    """Per-device ``argument_bytes``, ``output_bytes`` and
    ``alias_bytes`` of a cell, and the arguments by leaf group (params,
    optimizer, scales, step, batch, cache, exponents, token inputs)."""
    mesh = cell["mesh"]
    groups: Dict[str, int] = {}
    for name, (tree, specs) in cell["args"].items():
        if name == "state":
            for f in ("params", "opt", "scale", "step"):
                groups[f] = tree_bytes(getattr(tree, f), getattr(specs, f),
                                       mesh)
        else:
            groups[name] = tree_bytes(tree, specs, mesh)
    donated = cell["donated"]
    return {"argument_bytes": sum(groups.values()),
            "output_bytes": sum(tree_bytes(t, sp, mesh) for t, sp in
                                cell["outputs"].values()),
            "alias_bytes": tree_bytes(*cell["args"][donated], mesh)
            if donated else 0, "groups": groups}


def record(cell: dict, traced: dict, *, arch: str, shape_name: str,
           ops_dir: str = "") -> dict:
    """One cell's record, the reference's keys and the port's own."""
    mesh = cell["mesh"]
    chips = mesh.size
    mem = cell_bytes(cell)
    temp = int(traced["peak"] / chips)
    coll = implied_collectives(cell)
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh),
           "ok": True, "trace_s": round(traced["trace_s"], 2),
           "per_device": {"argument_bytes": mem["argument_bytes"],
                          "output_bytes": mem["output_bytes"],
                          "temp_bytes": temp,
                          "alias_bytes": mem["alias_bytes"]},
           "memory_groups": {**mem["groups"], "temp": temp},
           "flops_global": traced["flops"],
           "flops": traced["flops"] / chips,
           "bytes_accessed": traced["bytes"] / chips,
           "transcendentals": traced["transcendentals"] / chips,
           "collectives": coll,
           "microbatches": cell["microbatches"], "remat": cell["remat"],
           "cuda_initialized": torch.cuda.is_initialized(),
           "basis": BASIS}
    rec["loop_aware"] = {
        "flops": rec["flops"], "traffic_bytes": rec["bytes_accessed"],
        "collective_bytes": coll["total_bytes"],
        "collective_by_kind": {k: v for k, v in coll["bytes"].items()
                               if v}}
    if ops_dir:
        os.makedirs(ops_dir, exist_ok=True)
        fname = f"{ops_dir}/{arch}_{shape_name}_{rec['mesh']}.ops.json.gz"
        census = [{"op": k, "count": c, "flops": f}
                  for k, (c, f) in sorted(traced["census"].items())]
        with gzip.open(fname, "wt") as f:
            json.dump(census, f)
        rec["ops"] = fname
    return rec


_TRACES: dict = {}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             ops_dir: str = "dryrun_ops") -> dict:
    """Build, trace and record one cell.  The trace is shared with the
    other mesh's cell where the microbatch shape is the same (the counts
    are global; only the layout differs): ``trace_shared`` then names the
    cell that traced it."""
    cell = build_cell(arch, shape_name, multi_pod)
    key = (arch, shape_name, cell["microbatches"],
           json.dumps(OVERRIDES, sort_keys=True))
    traced = _TRACES.get(key)
    shared = traced is not None
    if not shared:
        traced = trace(cell)
        traced["mesh"] = _mesh_name(cell["mesh"])
        _TRACES.clear()                 # one cached trace at a time
        _TRACES[key] = traced
    rec = record(cell, traced, arch=arch, shape_name=shape_name,
                 ops_dir=ops_dir)
    if shared:
        rec["trace_shared"] = traced["mesh"]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--ops-dir", default="dryrun_ops",
                    help="where each cell's op census goes ('' for none)")
    # perf-iteration overrides (recorded via --tag)
    ap.add_argument("--tag", default="")
    ap.add_argument("--compute", default="")
    ap.add_argument("--remat", default="")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--a2a-bits", type=int, default=0)
    ap.add_argument("--ce-chunk", type=int, default=0)
    ap.add_argument("--ssm-chunk", type=int, default=0)
    ap.add_argument("--attn-seq-shard", action="store_true")
    ap.add_argument("--moe-stationary", action="store_true")
    args = ap.parse_args(argv)
    for name in ("ssm_chunk", "compute", "remat", "microbatches",
                 "a2a_bits", "ce_chunk"):
        if getattr(args, name):
            OVERRIDES[name] = getattr(args, name)
    for name in ("attn_seq_shard", "moe_stationary"):
        if getattr(args, name):
            OVERRIDES[name] = True

    def write(rec):
        if args.tag:
            rec["tag"] = args.tag
            rec["overrides"] = dict(OVERRIDES)
        line = json.dumps(rec)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        write(run_cell(args.arch, args.shape, args.multi_pod,
                       ops_dir=args.ops_dir))
        return 0

    done = set()
    try:
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    except FileNotFoundError:
        pass
    for a in configs.ARCHS:
        for s in configs.cells(a):
            for mp in (False, True):
                mesh_name = "2x16x16" if mp else "16x16"
                if (a, s, mesh_name) in done:
                    print(f"skip (done): {a} {s} {mesh_name}", flush=True)
                    continue
                print(f"=== {a} {s} {mesh_name}", flush=True)
                try:
                    rec = run_cell(a, s, mp, ops_dir=args.ops_dir)
                except Exception as e:  # a cell that raises is recorded
                    rec = {"arch": a, "shape": s, "mesh": mesh_name,
                           "ok": False, "error": str(e)[:200]}
                write(rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
