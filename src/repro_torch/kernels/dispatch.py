"""Kernel dispatch (``repro.kernels.dispatch``): the differentiable fused
DFXP matmul on K2, and the launch plans of K2, K3 and K4 from a
shape-bucketed measured cache.

**The fused matmul.** :func:`fused_dot` is one ``torch.autograd.Function``
whose three passes are launches of the quantized matmul kernel K2
(:func:`repro_torch.kernels.qmatmul.ops.qmm`):

  * forward  ``y = q(a) @ q(b)``        (layout ``nn``; ``nt`` under
    ``transpose_b``);
  * dgrad    ``da = q_g(ct) @ q(b)^T``  (``nt``; ``nn`` under
    ``transpose_b``);
  * wgrad    ``db = q(a)^T @ q_g(ct)``  (``tn``; under ``transpose_b``
    ``db = q_g(ct)^T @ q(a)``, the operand roles swapped).

Gradients pass straight through the operand rounding, with the rounded
co-operand, and ``q_g`` is the optional cotangent rounding
(``grad_width``) — the reference's custom VJP (``dispatch.py:611-628``).
The backward skips the pass of an input that needs no gradient (the
network's input, say).  Leading dims of ``a`` collapse to 2-D around the
kernel.  Each pass takes its plan from :func:`blocks_for`.

**Plan selection** (the reference's ``dispatch.py:56-560``).  On the
card the first call of a key times the candidate plans of its kernel on
the call's own operands — the rule's plan first — and caches the
fastest, unless it beats the rule's by less than :data:`_MARGIN` (a
near-tie keeps the rule's plan, so noise does not pick it); a later call
of the key takes the cached plan, fitted to its own shape.  Keys hold
everything the rule reads, so the rule's plan is a function of the key:

  * K2 ``(kind, R̂, Ĉ, D̂, products)`` → ``(bn, splits)``, the dims
    bucketed (:func:`_bucket`: powers of two from 8); ``per`` comes
    from the call's own ``D`` (``qmatmul.ops.fit_plan``); ``products``
    is the number of TF32 products of the operands' widths (1–3);
  * K3 ``("attn", B·K, Ŵ, G, hd, width, windowed)`` → ``(splits,)``,
    capped by the call's tiles, the tiles per split from its ``W``
    (``attn.ops.ring_plan``; the rule ``attn.ops.ring_rule``);
  * K4 ``("prefill", B·K, Ŵ, C, G, hd, width, windowed)`` → ``(warps,
    splits)``, the splits capped by the call's own tile list (the rule
    ``attn.ops.prefill_rule``).

``B·K`` is exact (the engine's slots and the model's kv heads fix it), so
these rules are ``attn.ops.ring_splits`` and ``prefill_plan`` at every
shape; ``K`` is the whole kv-head count also on a tensor-parallel rank,
so a rank splits its heads as the unsharded engine does; ``windowed``
says a window hides part of the ring.  In a bound world
(:func:`repro_torch.launch.mesh.ambient_mesh`) the first call of each
key gathers the mesh's first rank's plan, hit or miss, and every rank
runs it.  Measurement launches go through the kernels' C entry points
into scratch outputs and workspaces with guard bands; every candidate
runs once, the inputs' fingerprints and the guard bands checked, before
any is timed.  They do not count as launches of the wrappers.  With
``set_autotune(measure=False)`` the rule's plan is cached instead.

A plan sets the f32 summation order.  Two processes that should give the
same bits (a trainer and its resumed run) read one cache file, or run
with ``measure=False``.

On the CPU the plain versions run and take no plan: selection returns
the exact shape, as the reference's interpret mode does, and the
profile records it under the reference's ``interp`` keys.

**Persistence.**  Measured entries — only those, never the rule's — are
written to ``.cache/autotune_torch.json`` (``REPRO_TORCH_AUTOTUNE_CACHE``
overrides the path; the reference's file is never touched) and loaded at
import.  A save merges with the file under a lock and replaces it
atomically.  Loading skips entries whose plan is out of the kernel's
bounds and entries measured on another card (``torch.cuda
.get_device_name``); a missing or corrupt file loads nothing.

**Profile** (``launch.serve --profile``): per key, selection calls (eager
calls, where the reference counts jit traces), hits, misses,
``compiles`` (candidate plans timed: nothing compiles per plan on the
card), the wall µs spent measuring, and the plan.  With profiling off a
record costs one dict check.
"""
from __future__ import annotations

import fcntl
import json
import os
import tempfile
import time
import weakref
from typing import Callable, Dict, Optional, Set, Tuple

import torch

from repro_torch.kernels.attn import ops as A
from repro_torch.kernels.qmatmul import ops as Q
from repro_torch.kernels.qmatmul.ops import qmm
from repro_torch.launch.mesh import BoundMesh, ambient_mesh

Tensor = torch.Tensor

# Candidate split counts of the measured K2, K3 and K4 plans (each fitted
# to the call's shape and deduplicated; the rule's plan is tried first).
_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
# K2's workspace holds splits x R x C floats: a candidate past this many
# (64 MiB) is not tried unless it is the rule's
_MAX_WS = 1 << 24
_GUARD = 256                    # floats of guard band after a scratch buffer
_SPIN_S = [2e-4]                # spin before a timed launch: 3x the host's
#                                 longest time to queue one, at most 2 ms
_CANARY = 0x7FC0DEAD            # a NaN's bits
# a candidate replaces the rule's plan only when it is faster by more than
# this share, the spread of one key's times from run to run (on an H100,
# K3's 5 and 7 splits traded places within 4% over three runs): a
# near-tie keeps the rule's plan in every process
_MARGIN = 0.05

_AUTOTUNE: Dict[str, object] = {"measure": True, "reps": 3}
_BLOCK_CACHE: Dict[tuple, Tuple[int, ...]] = {}
_MEASURED: Set[tuple] = set()   # keys whose plans came from a real timing
_RECORDS: Dict[tuple, dict] = {}  # key -> device, rule, times of its entry
_UNCHECKED: Set[tuple] = set()  # loaded before the card's name was known
_DEVICE: list = [None]
# per bound mesh: the plans its ranks agreed on, {key: plan}
_AGREED: "weakref.WeakKeyDictionary[BoundMesh, Dict[tuple, tuple]]" = \
    weakref.WeakKeyDictionary()

# -- dispatch profiling (behind --profile; one dict check when off) ----------
_PROFILE: Dict[str, bool] = {"enabled": False}
_PROF: Dict[tuple, dict] = {}
_COMPILES = [0]                 # bumped by the measurement loop


def profile_enable(on: bool = True) -> None:
    """Turn dispatch profiling on/off (``launch.serve --profile``)."""
    _PROFILE["enabled"] = bool(on)


def reset_profile() -> None:
    _PROF.clear()
    _COMPILES[0] = 0


def profile_stats() -> Dict[tuple, dict]:
    """Copy of the per-bucket profile: ``{key: {calls, hits, misses,
    compiles, measure_us, blocks}}`` (empty unless profiling ran).
    ``calls`` counts eager calls (the reference counts jit traces);
    ``compiles`` counts the candidate plans timed."""
    return {k: dict(v) for k, v in _PROF.items()}


def _prof(key: tuple, *, hit: bool, blocks=None, measure_us: float = 0.0,
          compiles: int = 0) -> None:
    if not _PROFILE["enabled"]:
        return
    d = _PROF.get(key)
    if d is None:
        d = _PROF[key] = {"calls": 0, "hits": 0, "misses": 0,
                          "compiles": 0, "measure_us": 0.0, "blocks": None}
    d["calls"] += 1
    if hit:
        d["hits"] += 1
    else:
        d["misses"] += 1
    d["compiles"] += compiles
    d["measure_us"] += measure_us
    if blocks is not None:
        d["blocks"] = tuple(blocks)


def profile_table() -> str:
    """The dispatch profile as an aligned text table (one row per bucket)."""
    rows = [("bucket", "calls", "hit", "miss", "compiles", "measure_ms",
             "blocks")]
    for key in sorted(_PROF, key=str):
        d = _PROF[key]
        rows.append(("|".join(map(str, key)), str(d["calls"]),
                     str(d["hits"]), str(d["misses"]), str(d["compiles"]),
                     f"{d['measure_us'] / 1e3:.2f}",
                     "x".join(map(str, d["blocks"] or ()))))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                     for r in rows)


def profile_trace_counters(tracer) -> None:
    """Dump the profile onto a :class:`repro_torch.obs.Tracer` as counter
    events (one multi-series counter per bucket, on the ``dispatch``
    track)."""
    for key in sorted(_PROF, key=str):
        d = _PROF[key]
        tracer.counter("dispatch/" + "|".join(map(str, key)),
                       {"calls": d["calls"], "hits": d["hits"],
                        "misses": d["misses"], "compiles": d["compiles"],
                        "measure_us": d["measure_us"]}, tid="dispatch")


def _bucket(n: int) -> int:
    """Round up to the next power of two (min 8) — the cache granularity."""
    return max(8, 1 << (n - 1).bit_length())


def autotune_cache() -> Dict[tuple, Tuple[int, ...]]:
    """The live ``{key: plan}`` cache (mutable; card calls only — the
    plain versions take no plan)."""
    return _BLOCK_CACHE


def autotune_records() -> Dict[tuple, dict]:
    """Copy of what each measured entry records: ``{key: {"plan",
    "device", "rule", "us", "rule_us"}}`` (µs a launch of the chosen and
    of the rule's plan; loaded entries carry what their file holds)."""
    return {k: {**v, "plan": list(_BLOCK_CACHE[k])}
            for k, v in _RECORDS.items() if k in _MEASURED}


def reset_autotune() -> None:
    _BLOCK_CACHE.clear()
    _MEASURED.clear()
    _RECORDS.clear()
    _UNCHECKED.clear()
    _AGREED.clear()


def set_autotune(measure: Optional[bool] = None,
                 reps: Optional[int] = None) -> None:
    if measure is not None:
        _AUTOTUNE["measure"] = measure
    if reps is not None:
        _AUTOTUNE["reps"] = reps


# -- persistence ------------------------------------------------------------

_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_CACHE_DEFAULT = os.path.join(".cache", "autotune_torch.json")


def _cache_path(path: Optional[str] = None) -> str:
    return path or os.environ.get(_CACHE_ENV) or _CACHE_DEFAULT


def _device_name() -> Optional[str]:
    """The name of the card plans are measured on; ``"cpu"`` without one;
    None while CUDA is not initialized (reading the name would create a
    context, which importing this module must not)."""
    if _DEVICE[0] is None:
        if not torch.cuda.is_available():
            return "cpu"
        if not torch.cuda.is_initialized():
            return None
        _DEVICE[0] = torch.cuda.get_device_name()
    return _DEVICE[0]


def _write_merged(entries: Dict[str, dict], p: str) -> None:
    """Merge ``entries`` into the file at ``p`` under an exclusive lock,
    through a temporary file and ``os.replace``: a concurrent save waits,
    then keeps this one's entries; a reader sees the old or the new file,
    never part of one."""
    d = os.path.dirname(p) or "."
    os.makedirs(d, exist_ok=True)
    with open(p + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            try:
                with open(p) as f:
                    on_disk = json.load(f)
                if isinstance(on_disk, dict):
                    entries = {**on_disk, **entries}
            except (OSError, ValueError):
                pass
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".autotune.",
                                       suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(entries, f, indent=1, sort_keys=True)
                os.replace(tmp, p)
            except BaseException:
                os.unlink(tmp)
                raise
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def save_autotune(path: Optional[str] = None) -> Optional[str]:
    """Write the *measured* entries to the autotune cache file.

    Called whenever a measurement lands in the cache; the rule's entries
    are left out (they cost nothing to recompute and would shadow a later
    measurement).  Entries already on disk are merged, not clobbered.
    Returns the path written, or None when nothing measured is cached.
    """
    entries = {"|".join(map(str, key)):
               {**_RECORDS.get(key, {}), "plan": list(_BLOCK_CACHE[key])}
               for key in sorted(_MEASURED, key=str) if key in _BLOCK_CACHE}
    if not entries:
        return None
    p = _cache_path(path)
    _write_merged(entries, p)
    return p


def _pow2(n) -> bool:
    return isinstance(n, int) and n >= 8 and n & (n - 1) == 0


def _valid_entry(key: tuple, plan: tuple) -> bool:
    """Arity and bounds of a persisted entry for its kernel: guards
    against hand-edited files, entries of another version and plans no
    kernel accepts (a loaded entry counts as measured, so nothing would
    measure its bucket again)."""
    if not all(isinstance(x, int) and x > 0 for x in plan):
        return False
    if key[0] in ("nn", "nt", "tn"):
        return (len(key) == 5 and all(map(_pow2, key[1:4]))
                and 1 <= key[4] <= 3 and len(plan) == 2
                and plan[0] in (32, 64)
                and plan[1] <= max(1, -(-key[3] // Q.BK)))
    # attention keys: ("attn", B·K, Ŵ, G, hd, width, windowed) and
    # ("prefill", B·K, Ŵ, C, G, hd, width, windowed); the width is 0 (an
    # f32 pool) or an int8/int16 container's
    head = {"attn": 7, "prefill": 8}.get(key[0])
    if head is None or len(key) != head or not (
            all(x > 0 for x in key[1:-2]) and 0 <= key[-2] <= 16
            and key[-1] in (0, 1) and _pow2(key[2]) and key[-4] <= 32
            and key[-3] <= 256):
        return False
    if key[0] == "attn":
        return len(plan) == 1 and plan[0] <= 65535
    return (len(plan) == 2 and plan[0] == (8 if key[-3] <= 128 else 2)
            and plan[1] <= 65535)


def load_autotune(path: Optional[str] = None) -> int:
    """Load persisted measurements into the live cache (run at import).

    Returns the number of entries loaded; a missing or corrupt file loads
    0, and entries that fail :func:`_valid_entry` or were measured on
    another card are skipped (a stale cache must never break dispatch —
    worst case the bucket is measured again).
    """
    p = _cache_path(path)
    if not os.path.exists(p):
        return 0
    try:
        with open(p) as f:
            data = json.load(f)
        items = [((parts[0],) + tuple(int(x) for x in parts[1:]),
                  tuple(int(b) for b in rec["plan"]), rec)
                 for ks, rec in data.items() for parts in [ks.split("|")]]
        for _, _, rec in items:
            str(rec["device"])
    except Exception:   # wrong shape, truncated, hand-edited, unreadable —
        return 0        # a stale cache must never break dispatch
    here = _device_name()
    n = 0
    for key, plan, rec in items:
        if not _valid_entry(key, plan) or (here is not None
                                           and rec["device"] != here):
            continue
        _BLOCK_CACHE[key] = plan
        _MEASURED.add(key)
        _RECORDS[key] = {**rec, "plan": plan}
        if here is None:
            _UNCHECKED.add(key)
        n += 1
    return n


# -- selection ------------------------------------------------------------

class _Scratch:
    """Outputs and workspaces of measurement launches, each followed by a
    guard band of NaNs checked after the launches."""

    def __init__(self, device):
        self.device, self.bufs = device, []

    def __call__(self, *shape) -> Tensor:
        n = 1
        for s in shape:
            n *= s
        buf = torch.full((n + _GUARD,), _CANARY, dtype=torch.int32,
                         device=self.device).view(torch.float32)
        self.bufs.append(buf)
        return buf[:n].view(*shape)

    def intact(self) -> bool:
        return all(bool((b[-_GUARD:].view(torch.int32) == _CANARY).all())
                   for b in self.bufs)


def _digest(t: Tensor) -> Tensor:
    """A fingerprint of ``t``'s bytes on its device: the sum and the sum
    of squares (wrapping int64) of its 32-bit words (bytes where they do
    not divide into words), in slices of 2^24, so that a probe of a
    model-sized operand costs no copy of it."""
    flat = t.detach().reshape(-1)
    if flat.numel() == 1 and flat.stride(0) != 1:   # one element of a
        flat = flat.new_empty(1).copy_(flat)        # row, say: any stride
    raw = flat.view(torch.uint8)
    words = raw.view(torch.int32) if raw.numel() % 4 == 0 else raw
    acc = torch.zeros(2, dtype=torch.int64, device=t.device)
    for part in words.split(1 << 24):
        part = part.to(torch.int64)
        acc[0] += part.sum()
        acc[1] += (part * part).sum()
    return acc


def _time_plan(run: Callable, plan: tuple) -> float:
    """µs one launch of ``run(plan)`` takes on the card, between CUDA
    events queued behind a spin kernel that outlasts the host's time to
    queue them: the events then time the device, not the host (a small
    kernel launches slower than it runs, and a plan of two launches would
    pay the gap twice)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_SPIN_S[0] * 2e9))     # cycles, at <= 2 GHz
    t0 = time.perf_counter()
    start.record()
    run(plan)
    end.record()
    _SPIN_S[0] = min(2e-3, max(_SPIN_S[0], 3 * (time.perf_counter() - t0)))
    end.synchronize()
    return start.elapsed_time(end) * 1e3


def _measure(cands, inputs, make_run) -> Tuple[Optional[tuple], dict]:
    """Time every candidate plan (the rule's first) on the call's own
    ``inputs``; ``make_run(scratch, *inputs)`` returns ``run(plan)``,
    which launches the kernel on those inputs into buffers drawn from
    ``scratch``.  Each candidate first runs once: a plan the kernel
    rejects is dropped, and a launch that wrote outside its output and
    workspace (an input's :func:`_digest` moved, or a scratch buffer's
    guard band) raises before any is timed.  Then ``reps`` rounds launch
    every plan once; a plan's time is its least.  Returns the fastest
    plan (the first of equal times) and ``{plan: µs}``."""
    scratch = _Scratch(inputs[0].device)
    before = [_digest(t) for t in inputs]
    run, accepted = make_run(scratch, *inputs), []
    for plan in cands:
        try:
            run(plan)
        except RuntimeError:            # a plan the kernel rejects: skip
            continue
        accepted.append(plan)
    if not scratch.intact() or not all(
            torch.equal(d, _digest(t)) for d, t in zip(before, inputs)):
        raise RuntimeError(f"a launch of plans {accepted} wrote outside "
                           f"its output and workspace")
    times = {}
    for _ in range(max(1, int(_AUTOTUNE["reps"]))):
        for plan in accepted:           # rounds interleave the plans, so a
            t = _time_plan(run, plan)   # clock ramping up favours none
            times[plan] = min(t, times.get(plan, t))
    _COMPILES[0] += len(accepted)
    if not scratch.intact():
        raise RuntimeError(f"a launch of plans {accepted} wrote past its "
                           f"output and workspace")
    if not times:
        return None, times
    best = min(times, key=times.get)
    rule = cands[0]
    if rule in times and times[best] >= (1 - _MARGIN) * times[rule]:
        best = rule                     # a near-tie keeps the rule's plan
    return best, times


def _mesh() -> Optional[BoundMesh]:
    """The ambient bound mesh when it spans more than one rank."""
    mesh = ambient_mesh()
    return mesh if isinstance(mesh, BoundMesh) and mesh.size > 1 else None


def _hit(key: tuple) -> Optional[tuple]:
    """The cached plan of ``key`` where a lookup is all it takes (no
    bound mesh of more than one rank, an entry checked against this
    card), its hit recorded; None where :func:`_select` must decide."""
    plan = _BLOCK_CACHE.get(key)
    if plan is None or key in _UNCHECKED or _mesh() is not None:
        return None
    _prof(key, hit=True, blocks=plan)
    return plan


def _select(key: tuple, rule: tuple, cands: Callable, fit: Callable,
            launch: Optional[Callable]) -> tuple:
    """The cached plan of ``key`` (stored form), measured on a miss.

    ``rule``: the rule's plan of the key; ``cands()``: the stored forms
    of the candidates (the rule's first); ``fit(stored)``: the full plan
    at the call's shape; ``launch()``: ``(inputs, make_run)`` of the call
    (see :func:`_measure`), built on a miss only, or None to cache the
    rule's plan.

    On a bound mesh of more than one rank the first call of each key
    goes through one gather whether it hits or misses, so the ranks'
    collectives pair up whatever each rank's cache holds: the mesh's
    first rank proposes its cached or measured plan (the others measure
    nothing), every rank runs it, and later calls take it with no
    collective."""
    mesh = _mesh()
    agreed = None if mesh is None else _AGREED.setdefault(mesh, {})
    if agreed is not None and key in agreed:
        _prof(key, hit=True, blocks=agreed[key])
        return agreed[key]
    plan = _BLOCK_CACHE.get(key)
    if key in _UNCHECKED:
        _UNCHECKED.discard(key)
        if _RECORDS[key]["device"] != _device_name():   # another card's
            del _BLOCK_CACHE[key], _RECORDS[key]
            _MEASURED.discard(key)
            plan = None
    n0, t0 = _COMPILES[0], time.perf_counter()
    hit, measured, times = plan is not None, None, {}
    if not hit:
        if (_AUTOTUNE["measure"] and launch is not None
                and (mesh is None or mesh.rank % mesh.size == 0)):
            full = {}
            for c in cands():
                full.setdefault(fit(c), c)     # one stored form a fitted plan
            best, ftimes = _measure(list(full), *launch())
            if best is not None:
                measured = full[best]
                times = {full[f]: t for f, t in ftimes.items()}
        plan = measured or rule
    if mesh is not None:
        got = mesh.gather_list(torch.tensor(plan, dtype=torch.int64),
                               tuple(mesh.axis_names))[0]
        first = tuple(int(x) for x in got)
        agreed[key] = first
        if first != plan:                   # the first rank's plan wins
            hit, measured, plan = False, None, first
            _MEASURED.discard(key)
            _RECORDS.pop(key, None)
    if hit:
        _prof(key, hit=True, blocks=plan)
        return plan
    _prof(key, hit=False, blocks=plan,
          measure_us=(time.perf_counter() - t0) * 1e6,
          compiles=_COMPILES[0] - n0)
    _BLOCK_CACHE[key] = plan
    if measured:
        _MEASURED.add(key)
        _RECORDS[key] = {"device": _device_name(), "rule": list(rule),
                         "us": times[plan], "rule_us": times.get(rule)}
        save_autotune()
    return plan


def mm_candidates(rule: tuple, R: int, C: int) -> list:
    """K2's candidate plans, stored form ``(bn, splits)``: the rule's,
    then both tile widths at each of :data:`_SPLITS` whose workspace fits
    :data:`_MAX_WS`."""
    out = [rule]
    for bn in (64, 32):
        out += [(bn, s) for s in _SPLITS
                if (bn, s) != rule and (s == 1 or s * R * C <= _MAX_WS)]
    return out


def attn_candidates(rule: tuple, W: int) -> list:
    """K3's candidate split counts for a ring of ``W`` slots: the rule's,
    then each of :data:`_SPLITS` up to the ring's tiles."""
    return [rule] + [(s,) for s in _SPLITS if s <= -(-W // 32)]


def prefill_candidates(rule: tuple) -> list:
    """K4's candidate ``(warps, splits)``: the rule's, then the rule's
    warps (the only instance a head dim has) at each of :data:`_SPLITS`
    (capped by the call's tile list when fitted)."""
    return [rule] + [(rule[0], s) for s in _SPLITS]


def _mm_launch(kind, R, C, widths, operands):
    """``(inputs, make_run)`` of a K2 call on its live operands."""
    a, b, e_a, e_b = operands
    steps = Q.step_tensor(e_a, e_b, *widths, device=a.device)

    def make_run(scratch, a, b, steps):
        out, ws = scratch(R, C), {}

        def run(plan):
            s = plan[1]
            if s > 1 and s not in ws:
                ws[s] = scratch(s, R, C)
            Q.launch(a, b, steps, out, ws.get(s), kind=kind,
                     width_a=widths[0], width_b=widths[1], plan=plan)
        return run
    return (a, b, steps), make_run


def blocks_for(kind: str, R: int, C: int, D: int, *, interpret: bool,
               width=10, widths: Optional[tuple] = None,
               operands: Optional[tuple] = None) -> tuple:
    """K2's plan ``(bn, splits, per)`` for a ``kind`` product ``[R, D] x
    [D, C]``, cached per bucket ``(kind, R̂, Ĉ, D̂, products)``.

    ``widths``: the operands' ``(width_a, width_b)`` (default ``(width,
    width)``); ``operands``: the call's card operands ``(a, b, e_a,
    e_b)``, on which the candidates are timed (without them the rule's
    plan is cached).  ``interpret``: the operands lie on the CPU, where
    the plain version runs: the exact dims ``(R, C, D)`` come back, as
    in the reference's interpret mode.
    """
    if interpret:
        _prof(("mm", kind, "interp"), hit=True, blocks=(R, C, D))
        return R, C, D
    wa, wb = widths if widths is not None else (width, width)
    key = (kind, _bucket(R), _bucket(C), _bucket(D), Q.products(wa, wb))
    stored = _hit(key)
    if stored is None:
        rule = Q.plan(*key[1:4])[:2]
        stored = _select(
            key, rule, lambda: mm_candidates(rule, R, C),
            lambda p: Q.fit_plan(D, *p),
            None if operands is None
            else lambda: _mm_launch(kind, R, C, (wa, wb), operands))
    return Q.fit_plan(D, *stored)


def _windowed(window, W: int) -> int:
    """1 when a window hides part of a ring of ``W`` slots (a windowed
    call visits other tiles, so it keys apart)."""
    return int(bool(window) and window < W)


def attn_blocks_for(W: int, G: int, hd: int, *, width=None,
                    interpret: bool, B: int = 1, K: int = 8, window=None,
                    launch: Optional[Callable] = None) -> int:
    """K3's split count for a ring of ``W`` slots (at most its tiles),
    cached per key ``("attn", B·K, Ŵ, G, hd, width, windowed)``: the rule
    (``attn.ops.ring_rule``) reads the exact ``B·K`` (the engine's slots
    and the model's kv heads fix it), and ``K`` is the whole kv-head
    count, also on a TP rank.  ``launch()``: ``(inputs, make_run)`` of
    the call (:func:`repro_torch.kernels.attn.ops.flash_decode` passes
    it), without which the rule's split count is cached.  The tiles per
    split come from the call's ``W`` (``attn.ops.ring_plan``).

    Interpret mode (the plain version, on the CPU) returns the whole
    window, as the reference's does.
    """
    if interpret:
        _prof(("attn", "interp"), hit=True, blocks=(W,))
        return W
    key = ("attn", B * K, _bucket(W), G, hd, width or 0,
           _windowed(window, W))
    stored = _hit(key)
    if stored is None:
        rule = A.ring_rule(B * K)
        stored = _select(key, rule, lambda: attn_candidates(rule, W),
                         lambda p: A.ring_plan(W, p[0]), launch)
    return A.ring_plan(W, stored[0])[0]


def prefill_blocks_for(W: int, C: int, G: int, hd: int, *, width=None,
                       interpret: bool, B: int = 1, K: int = 8, window=None,
                       launch: Optional[Callable] = None):
    """K4's plan ``(warps, splits)`` for a ``C``-row chunk over a ring of
    ``W`` slots, cached per key ``("prefill", B·K, Ŵ, C, G, hd, width,
    windowed)`` (the reference leaves ``W`` out; here the splits are cut
    from the ring's tiles, so a ring of another size keys apart); the
    stored splits are capped by the call's tile list
    (``attn.ops.prefill_fit``).  ``K`` and ``launch`` as
    :func:`attn_blocks_for`.

    Interpret mode returns the whole window, as the reference's does.
    """
    if interpret:
        _prof(("prefill", "interp"), hit=True, blocks=(W,))
        return W
    key = ("prefill", B * K, _bucket(W), C, G, hd, width or 0,
           _windowed(window, W))
    stored = _hit(key)
    if stored is None:
        rule = A.prefill_rule(B * K, C, G, hd)
        stored = _select(key, rule, lambda: prefill_candidates(rule),
                         lambda p: A.prefill_fit(B, C, W, p), launch)
    return A.prefill_fit(B, C, W, stored)


def paged_attn_blocks_for(P: int, G: int, hd: int, *, width=None,
                          interpret: bool) -> int:
    """Split size of the paged flash-decode kernel K5 — the page; nothing
    to tune (the pages split as ``attn.ops.decode_splits`` says).  The
    dispatch layer's validation hook: a page the kernel cannot take
    raises here, at the first call, naming the page size.  The plain
    version (interpret mode) takes any page.
    """
    _prof(("paged_attn", P, G, hd, width or 0), hit=True, blocks=(P,))
    if not interpret:
        from repro_torch.kernels.attn import ops as A
        if P % A.TILE or G > 32 or hd > 256:
            raise ValueError(
                f"page_size {P} (G={G}, hd={hd}, width={width}): the paged "
                f"flash-decode kernel takes a page size that is a multiple "
                f"of {A.TILE}, G <= 32 and hd <= 256; use another "
                "--page-size")
    return P


def paged_prefill_blocks_for(P: int, C: int, G: int, hd: int, *, width=None,
                             interpret: bool) -> int:
    """Split size of the paged flash-prefill kernel K6 — the page; the
    same contract as :func:`paged_attn_blocks_for` (the splits are
    ``attn.ops.prefill_paged_plan``'s)."""
    _prof(("paged_prefill", P, C, G, hd, width or 0), hit=True, blocks=(P,))
    if not interpret:
        from repro_torch.kernels.attn import ops as A
        if P % A.TILE or hd > 256:
            raise ValueError(
                f"page_size {P} (C={C}, G={G}, hd={hd}, width={width}): the "
                f"paged flash-prefill kernel takes a page size that is a "
                f"multiple of {A.TILE} and hd <= 256; use another "
                "--page-size")
    return P


# ---------------------------------------------------------------------------
# differentiable fused matmul
# ---------------------------------------------------------------------------

def _qmm_auto(a, b, e_a, e_b, *, kind, width_a, width_b):
    """qmm under the plan :func:`blocks_for` selects for its shapes."""
    R, C, D = Q.shapes(kind, a.shape, b.shape)
    plan = blocks_for(kind, R, C, D, interpret=a.device.type == "cpu",
                      width=width_a or width_b, widths=(width_a, width_b),
                      operands=(a, b, e_a, e_b))
    return qmm(a, b, e_a, e_b, kind=kind, width_a=width_a, width_b=width_b,
               plan=plan)


class _FusedDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, e_a, e_b, e_g, width_a, width_b, grad_width,
                transpose_b):
        ctx.save_for_backward(a, b, e_a, e_b, e_g)
        ctx.cfg = (width_a, width_b, grad_width, transpose_b)
        return _qmm_auto(a, b, e_a, e_b, kind="nt" if transpose_b else "nn",
                         width_a=width_a, width_b=width_b)

    @staticmethod
    def backward(ctx, ct):
        a, b, e_a, e_b, e_g = ctx.saved_tensors
        width_a, width_b, grad_width, transpose_b = ctx.cfg
        need_a, need_b = ctx.needs_input_grad[:2]
        ct = ct.contiguous()
        da = db = None
        if transpose_b:
            # y[M,V] = qa[M,D] @ qb[V,D]^T
            if need_a:
                da = _qmm_auto(ct, b, e_g, e_b, kind="nn",
                               width_a=grad_width, width_b=width_b)
            if need_b:
                db = _qmm_auto(ct, a, e_g, e_a, kind="tn",
                               width_a=grad_width, width_b=width_a)
        else:
            # y[M,N] = qa[M,K] @ qb[K,N]
            if need_a:
                da = _qmm_auto(ct, b, e_g, e_b, kind="nt",
                               width_a=grad_width, width_b=width_b)
            if need_b:
                db = _qmm_auto(a, ct, e_a, e_g, kind="tn", width_a=width_a,
                               width_b=grad_width)
        return da, db, None, None, None, None, None, None, None


def fused_dot(a: Tensor, b: Tensor, e_a, e_b, *, width: int,
              grad_width: Optional[int] = None, e_g=0.0, quant_a: bool = True,
              quant_b: bool = True, transpose_b: bool = False) -> Tensor:
    """Differentiable fused DFXP matmul ``q(a) @ q(b)[^T]`` on K2.

    ``a``: [..., K] float32 (leading dims collapsed around the kernel),
    ``b``: [K, N] (or [N, K] with ``transpose_b``).  ``grad_width`` rounds
    the cotangent (exponent ``e_g``) in both backward passes;
    ``quant_a=False`` / ``quant_b=False`` pass that operand through raw —
    the straight-through composite contract used by ``QTape.dot``."""
    dev = a.device

    def exp(e):
        return torch.as_tensor(e, dtype=torch.float32, device=dev)

    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1]).contiguous()
    y = _FusedDot.apply(a2, b.contiguous(), exp(e_a), exp(e_b), exp(e_g),
                        width if quant_a else None,
                        width if quant_b else None, grad_width, transpose_b)
    return y.reshape(*lead, y.shape[-1])


def tape_dot(x: Tensor, w: Tensor, e_w, *, width: int,
             transpose_b: bool = False) -> Tensor:
    """The ``QTape.dot`` fused path: raw activations × quantized weight.

    The same function as ``matmul(x, ste_quant(w))``: the activation
    operand and the backward cotangent are *not* re-rounded here (the
    surrounding ``tape.act`` sites already hold them on the DFXP grid),
    and the weight gradient passes straight through, like ``ste_quant``'s
    identity backward (``dispatch.py:661-673``)."""
    return fused_dot(x, w, 0.0, e_w, width=width, quant_a=False,
                     transpose_b=transpose_b)


__all__ = ["fused_dot", "tape_dot", "blocks_for", "attn_blocks_for",
           "prefill_blocks_for", "paged_attn_blocks_for",
           "paged_prefill_blocks_for", "autotune_cache", "autotune_records",
           "reset_autotune", "set_autotune", "save_autotune",
           "load_autotune", "profile_enable", "reset_profile",
           "profile_stats", "profile_table", "profile_trace_counters"]

load_autotune()   # persisted measurements survive process restarts
