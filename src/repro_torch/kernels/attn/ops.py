"""Wrappers of the hand-written attention kernels K3, K4, K5 and K6.

``flash_decode``, ``flash_prefill`` and their paged variants
``flash_decode_paged`` and ``flash_prefill_paged`` keep the signatures of
``repro.kernels.attn.ops`` (minus ``block_w``, ``interpret`` and
``force_split``: the CUDA kernels tile by the warp width and have no
interpret mode).  For tensors on the CPU they compute
the plain versions in :mod:`.ref`; for tensors on the card they check
device, dtype, shape and contiguity, launch the kernel on the current
stream, and raise if the launch fails.  There is no fallback from one to
the other.  The block tables' entries are not read on the host (that
would cost a device sync per call): they must name pages of the arena,
as the engine's allocator guarantees.

Launch plans: K3 takes its split count from
:func:`repro_torch.kernels.dispatch.attn_blocks_for` and K4 its
``(warps, splits)`` from :func:`~repro_torch.kernels.dispatch.
prefill_blocks_for` (a shape-bucketed cache, measured on the card on the
call's own inputs; :func:`ring_splits` and :func:`prefill_plan` are the
rules the measurement starts from).  K5 and K6 split by the fixed rules
:func:`decode_splits` and :func:`prefill_paged_plan`, after the
dispatch layer's validation hooks (``paged_attn_blocks_for``,
``paged_prefill_blocks_for``) have checked the page.  On the CPU each
wrapper records its selection in the dispatch profile, as the
reference's interpret mode does.

``LAUNCHES`` counts calls per wrapper — incremented where a call launches
its kernel (K3, K4, K5: and, after a split, the kernel that merges the
splits) and nowhere else (not in ``launch_*``, which the plan
measurement and the sweeps call) — so a run can show that its main path
went through the kernels.

Serving tensor parallelism (``tp_axis``): with ``tp_axis`` naming a live
axis of the ambient mesh whose size divides the kv-head count ``K``
(:func:`tp_shard`, the reference's divisibility guard), the pool's
``k``/``v`` are this rank's ``K/tp`` contiguous kv heads; the wrapper
takes the matching query heads (and chunk K/V) of its full-head
arguments, runs the same kernel on the slice, and returns the rank's
head slice — GQA never contracts across kv heads, so per-head numbers are
untouched.  The split plan is the one of the whole ``K``, so each head's
tiles merge in the unsharded order.  Where ``tp`` does not divide ``K``
the pool is replicated and the call is the unsharded one.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core.packed import container_dtype
from repro_torch.core.quant import exact_pow2

from .. import build, dispatch
from . import ref as R

Tensor = torch.Tensor

LAUNCHES: Dict[str, int] = {"flash_decode": 0, "flash_prefill": 0,
                             "flash_decode_paged": 0,
                             "flash_prefill_paged": 0}
TILE = 32          # keys per kernel tile; a page size must be a multiple
SMS = 132          # streaming multiprocessors of an H100 SXM

_DTYPE_CODE = {torch.int8: 0, torch.int16: 1, torch.float32: 2}


def tp_shard(tp_axis: Optional[str], n_kv_heads: int):
    """``(tp, index)``: the live TP degree of ``tp_axis`` in the ambient
    mesh and this rank's index along it, when the axis exists, is larger
    than 1 and divides ``n_kv_heads``; ``(0, 0)`` otherwise (the
    unsharded call, the pool replicated by the sharding guard under the
    same condition)."""
    if not tp_axis:
        return 0, 0
    from repro_torch.launch.mesh import ambient_mesh
    mesh = ambient_mesh()
    if mesh is None or tp_axis not in mesh.shape:
        return 0, 0
    size = int(mesh.shape[tp_axis])
    if size > 1 and n_kv_heads % size == 0:
        return size, mesh.axis_index(tp_axis)
    return 0, 0


def local_heads(x: Tensor, tp_axis: Optional[str], dim: int) -> Tensor:
    """This rank's contiguous slice of the kv-head dim ``dim`` of ``x``
    under :func:`tp_shard`; ``x`` itself when the call is unsharded."""
    tp, idx = tp_shard(tp_axis, x.shape[dim])
    if not tp:
        return x
    n = x.shape[dim] // tp
    return x.narrow(dim, idx * n, n).contiguous()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _storage_dtype(width: Optional[int]) -> torch.dtype:
    return torch.float32 if width is None else container_dtype(width)


def _check(name: str, t: Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _steps(n: int, k_exp, v_exp, width: Optional[int], device) -> Tensor:
    """Dequant steps [n, 2] = [2**k_e, 2**v_e] per slot (K3, K4) or per
    page (K5, K6); ones for f32."""
    if width is None:
        return torch.ones((n, 2), dtype=torch.float32, device=device)
    ke = torch.as_tensor(k_exp, dtype=torch.float32, device=device)
    ve = torch.as_tensor(v_exp, dtype=torch.float32, device=device)
    return torch.stack([exact_pow2(ke), exact_pow2(ve)], dim=-1).contiguous()


def _ptr(t: Optional[Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _workspace(splits: int, rows: int, hd: int, device) -> Optional[Tensor]:
    """The f32 partials ``(acc, m, l)`` of ``splits`` splits of ``rows``
    query rows, merged by a kernel's second launch; None for one split."""
    if splits == 1:
        return None
    return torch.empty(splits * rows * (hd + 2), dtype=torch.float32,
                       device=device)


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def flash_decode(q: Tensor, k: Tensor, v: Tensor, pos: Tensor, q_pos: Tensor,
                 k_exp=None, v_exp=None, *, width: Optional[int] = None,
                 scale: float, window: Optional[int] = None,
                 causal: bool = True, tp_axis: Optional[str] = None
                 ) -> Tensor:
    """Single-query GQA attention over a (packed) KV ring buffer — K3.

    ``q``: f32 [B, K, G, hd] kv-head-major query groups · ``k``/``v``:
    [B, W, K, hd] int8/int16 mantissas (``width=8|16``) or f32
    (``width=None``) · ``pos``: int32 [B, W] ring positions (-1 = empty)
    · ``q_pos``: int32 [B] · ``k_exp``/``v_exp``: f32 [B] log2-steps.
    Returns f32 [B, K, G, hd]; numerics are
    :func:`repro_torch.kernels.attn.ref.decode_attention_ref` (on the card
    split over the ring as :func:`ring_splits` says, and merged as
    :func:`repro_torch.kernels.attn.ref.decode_split_ref` does).  Under
    ``tp_axis`` (module docstring) ``k``/``v`` hold the rank's kv heads
    and the result is the rank's head slice.
    """
    K_all = q.shape[1]
    q = local_heads(q, tp_axis, 1)
    if q.device.type == "cpu":
        dispatch.attn_blocks_for(k.shape[1], q.shape[2], q.shape[3],
                                 width=width, interpret=True)
        return R.decode_attention_ref(q, k, v, pos, q_pos, k_exp=k_exp,
                                      v_exp=v_exp, width=width, scale=scale,
                                      window=window, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cpu or cuda, not {q.device}")
    B, K, G, hd = q.shape
    W = k.shape[1]
    dev, sdt = q.device, _storage_dtype(width)
    _check("q", q, (B, K, G, hd), torch.float32, dev)
    _check("k", k, (B, W, K, hd), sdt, dev)
    _check("v", v, (B, W, K, hd), sdt, dev)
    _check("pos", pos, (B, W), torch.int32, dev)
    _check("q_pos", q_pos, (B,), torch.int32, dev)
    if G > 32 or hd > 256:
        raise ValueError(f"flash_decode takes G <= 32 and hd <= 256, got "
                         f"G={G}, hd={hd}")
    steps = _steps(B, k_exp, v_exp, width, dev)
    splits = dispatch.attn_blocks_for(
        W, G, hd, width=width, interpret=False, B=B, K=K_all, window=window,
        launch=lambda: ((q, k, v, pos, q_pos, steps), _decode_runner(
            width, scale, window, causal)))
    out = launch_decode(q, k, v, pos, q_pos, steps, width=width, scale=scale,
                        window=window, causal=causal,
                        plan=ring_plan(W, splits))
    LAUNCHES["flash_decode"] += 1
    return out


def launch_decode(q, k, v, pos, q_pos, steps, *, width, scale, window,
                  causal, plan, out=None, ws=None) -> Tensor:
    """One K3 call under ``plan`` = ``(splits, tps)`` (:func:`ring_splits`'
    form) on checked card tensors; ``steps`` [B, 2]; into ``out`` and
    ``ws`` when given (fresh buffers otherwise).  Counts nothing: the
    wrapper does, and the plan measurement and the plan sweep
    (``tools/attn_plan_sweep.py``) call this directly."""
    B, K, G, hd = q.shape
    W = k.shape[1]
    splits, tps = plan
    out = torch.empty_like(q) if out is None else out
    if ws is None:
        ws = _workspace(splits, B * K * G, hd, q.device)
    fn = build.library("flash_decode").flash_decode_launch
    rc = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(pos), _ptr(q_pos), _ptr(steps),
            _ptr(out), _ptr(ws), B, W, K, G, hd,
            _DTYPE_CODE[_storage_dtype(width)], float(scale),
            int(window or 0), int(causal), splits, tps, _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed (plan "
                           f"{plan}): CUDA error {rc}")
    return out


def _decode_runner(width, scale, window, causal):
    """``make_run`` of a K3 call's plan measurement
    (:func:`repro_torch.kernels.dispatch._measure`): launches into a
    scratch output and one scratch workspace per split count."""
    def make_run(scratch, q, k, v, pos, q_pos, steps):
        B, K, G, hd = q.shape
        out, ws = scratch(*q.shape), {1: None}

        def run(p):
            if p[0] not in ws:
                ws[p[0]] = scratch(p[0] * B * K * G * (hd + 2))
            launch_decode(q, k, v, pos, q_pos, steps, width=width,
                          scale=scale, window=window, causal=causal, plan=p,
                          out=out, ws=ws[p[0]])
        return run
    return make_run


def flash_prefill(q: Tensor, k_new: Tensor, v_new: Tensor, k: Tensor,
                  v: Tensor, pos: Tensor, p0: Tensor, n_valid: Tensor,
                  k_exp=None, v_exp=None, *, width: Optional[int] = None,
                  scale: float, window: Optional[int] = None,
                  causal: bool = True, tp_axis: Optional[str] = None
                  ) -> Tensor:
    """Chunked-prefill GQA attention over a (packed) KV ring buffer — K4.

    ``q``: f32 [B, C, K, G, hd] query groups of a chunk starting at
    ``p0`` [B] · ``k_new``/``v_new``: f32 [B, C, K, hd], the chunk's own
    K/V · ``k``/``v``: [B, W, K, hd] pool history (int8/int16 mantissas
    or f32), masked to ``0 <= pos < p0`` · ``n_valid``: int32 [B] valid
    chunk rows.  Returns f32 [B, C, K, G, hd]; numerics are
    :func:`repro_torch.kernels.attn.ref.prefill_attention_ref` (on the card
    on TF32 tensor cores at f32 accuracy, split as :func:`prefill_plan`
    says: :func:`repro_torch.kernels.attn.ref.prefill_tf32_emulated`).
    Under ``tp_axis`` ``k``/``v`` hold the rank's kv heads; ``q``,
    ``k_new`` and ``v_new`` are cut to them and the result is the rank's
    head slice.
    """
    K_all = q.shape[2]
    q = local_heads(q, tp_axis, 2)
    k_new = local_heads(k_new, tp_axis, 2)
    v_new = local_heads(v_new, tp_axis, 2)
    if q.device.type == "cpu":
        dispatch.prefill_blocks_for(k.shape[1], q.shape[1], q.shape[3],
                                    q.shape[4], width=width, interpret=True)
        return R.prefill_attention_ref(q, k, v, pos, k_new, v_new, p0,
                                       n_valid, k_exp=k_exp, v_exp=v_exp,
                                       width=width, scale=scale,
                                       window=window, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill runs on cpu or cuda, not {q.device}")
    B, C, K, G, hd = q.shape
    W = k.shape[1]
    dev, sdt = q.device, _storage_dtype(width)
    _check("q", q, (B, C, K, G, hd), torch.float32, dev)
    _check("k_new", k_new, (B, C, K, hd), torch.float32, dev)
    _check("v_new", v_new, (B, C, K, hd), torch.float32, dev)
    _check("k", k, (B, W, K, hd), sdt, dev)
    _check("v", v, (B, W, K, hd), sdt, dev)
    _check("pos", pos, (B, W), torch.int32, dev)
    _check("p0", p0, (B,), torch.int32, dev)
    _check("n_valid", n_valid, (B,), torch.int32, dev)
    if hd > 256 or B > 65535 or K > 65535:
        raise ValueError(f"flash_prefill takes hd <= 256 and B, K <= 65535, "
                         f"got hd={hd}, B={B}, K={K}")
    steps = _steps(B, k_exp, v_exp, width, dev)
    plan = dispatch.prefill_blocks_for(
        W, C, G, hd, width=width, interpret=False, B=B, K=K_all,
        window=window,
        launch=lambda: ((q, k_new, v_new, k, v, pos, p0, n_valid, steps),
                        _prefill_runner(width, scale, window, causal)))
    out = launch_prefill(q, k_new, v_new, k, v, pos, p0, n_valid, steps,
                         width=width, scale=scale, window=window,
                         causal=causal, plan=plan)
    LAUNCHES["flash_prefill"] += 1
    return out


def _prefill_runner(width, scale, window, causal):
    """``make_run`` of a K4 call's plan measurement, as
    :func:`_decode_runner`."""
    def make_run(scratch, q, k_new, v_new, k, v, pos, p0, n_valid, steps):
        rows, hd = q.shape[:-1].numel(), q.shape[-1]
        out, ws = scratch(*q.shape), {1: None}

        def run(p):
            if p[1] not in ws:
                ws[p[1]] = scratch(p[1] * rows * (hd + 2))
            launch_prefill(q, k_new, v_new, k, v, pos, p0, n_valid, steps,
                           width=width, scale=scale, window=window,
                           causal=causal, plan=p, out=out, ws=ws[p[1]])
        return run
    return make_run


def prefill_rule(BK: int, C: int, G: int, hd: int):
    """The stored form ``(warps, S)`` of :func:`prefill_plan` for ``BK =
    B·K`` blocks of rows: as many splits as fit one wave, before the cap
    by the tile list that :func:`prefill_fit` applies."""
    warps = 8 if hd <= 128 else 2
    row_tiles = -(-C * G // (16 * warps))
    return warps, max(1, SMS // (row_tiles * BK))


def prefill_fit(B: int, C: int, W: int, plan):
    """``(warps, splits)`` of a K4 call from a stored plan: the splits
    capped by the tiles a block's list holds and by the grid (``B·S <=
    65535``)."""
    warps, splits = plan
    n_list = -(-W // TILE) + -(-C // TILE)
    return warps, max(1, min(n_list, splits, 65535 // B))


def prefill_plan(B: int, C: int, W: int, K: int, G: int, hd: int):
    """``(warps, splits)`` of a K4 call: blocks of ``16·warps`` query rows
    (8 warps up to hd = 128, else 2, for shared memory), each block's list
    of the ring's and the chunk's 32-key tiles that its rows see cut into
    ``splits`` even parts, as many as fit in one wave of :data:`SMS`
    blocks (a block takes most of an SM's shared memory, so a second wave
    would run after the first), at most one per tile: S = 4, 128 blocks,
    at B=1, C=128, W=400, K=8, G=4, hd=128."""
    return prefill_fit(B, C, W, prefill_rule(B * K, C, G, hd))


def launch_prefill(q, k_new, v_new, k, v, pos, p0, n_valid, steps, *,
                   width, scale, window, causal, plan, out=None,
                   ws=None) -> Tensor:
    """One K4 call under ``plan`` (:func:`prefill_plan`'s form) on checked
    card tensors; ``steps`` [B, 2]; into ``out`` and ``ws`` when given.
    Counts nothing: the wrapper does, and the plan measurement and the
    plan sweep (``tools/attn_plan_sweep.py``) call this directly."""
    B, C, K, G, hd = q.shape
    W = k.shape[1]
    warps, splits = plan
    out = torch.empty_like(q) if out is None else out
    if ws is None:
        ws = _workspace(splits, B * C * K * G, hd, q.device)
    fn = build.library("flash_prefill").flash_prefill_launch
    rc = fn(_ptr(q), _ptr(k_new), _ptr(v_new), _ptr(k), _ptr(v), _ptr(pos),
            _ptr(p0), _ptr(n_valid), _ptr(steps), _ptr(out), _ptr(ws), B, C,
            W, K, G, hd, _DTYPE_CODE[_storage_dtype(width)], float(scale),
            int(window or 0), int(causal), warps, splits,
            _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed (plan "
                           f"{plan}): CUDA error {rc}")
    return out


def _check_paged(k: Tensor, v: Tensor, bt: Tensor, pos: Tensor, B: int,
                 K: int, hd: int, width: Optional[int], dev):
    """Check the arenas, block table and positions of a paged call;
    returns ``(n_pages, P, nblocks)``."""
    n_pages, P = k.shape[:2]
    nblocks = bt.shape[1] if bt.ndim == 2 else -1
    sdt = _storage_dtype(width)
    _check("k", k, (n_pages, P, K, hd), sdt, dev)
    _check("v", v, (n_pages, P, K, hd), sdt, dev)
    _check("bt", bt, (B, nblocks), torch.int32, dev)
    _check("pos", pos, (B, nblocks * P), torch.int32, dev)
    return n_pages, P, nblocks


def ring_plan(W: int, splits: int):
    """``(splits', tps)`` of a K3 call over a ring of ``W`` slots cut into
    at most ``splits`` contiguous ranges of ``tps`` 32-slot tiles: a
    stored split count fitted to the call's ``W``."""
    n = -(-W // TILE)
    tps = -(-n // min(max(1, splits), n))
    return -(-n // tps), tps


def ring_rule(BK: int):
    """The stored form ``(splits,)`` of K3's rule for ``BK = B·K`` blocks
    of query groups: as many splits as bring the blocks to a wave of
    :data:`SMS`, before :func:`ring_plan` caps them by the ring's tiles."""
    return (-(-SMS // BK),)


def ring_splits(B: int, K: int, W: int):
    """``(splits, tps)`` of a K3 call by the rule: the ring's ``ceil(W /
    32)`` tiles cut into ``splits`` contiguous ranges of ``tps`` tiles (the
    last may be shorter), so that ``K·B·splits`` blocks fill a wave of
    :data:`SMS` where there are tiles enough (S = 5 of 3 tiles, 160
    blocks, at B=4, K=8, W=400)."""
    return ring_plan(W, ring_rule(B * K)[0])


def decode_splits(B: int, K: int, nblocks: int):
    """``(splits, pps)`` of a K5 call: the block table's ``nblocks``
    entries cut into ``splits`` contiguous ranges of ``pps`` entries
    (the last may be shorter), so that ``K·B·splits`` blocks fill a wave
    of :data:`SMS` where there are pages enough."""
    want = min(nblocks, -(-SMS // (B * K)))
    pps = -(-nblocks // want)
    return -(-nblocks // pps), pps


def flash_decode_paged(q: Tensor, k: Tensor, v: Tensor, bt: Tensor,
                       pos: Tensor, q_pos: Tensor, k_exp=None, v_exp=None, *,
                       width: Optional[int] = None, scale: float,
                       window: Optional[int] = None,
                       causal: bool = True, tp_axis: Optional[str] = None
                       ) -> Tensor:
    """Single-query GQA attention through a per-request block table — K5.

    ``q``: f32 [B, K, G, hd] · ``k``/``v``: [n_pages, P, K, hd] page
    arenas (int8/int16 mantissas or f32) · ``bt``: int32 [B, nblocks]
    block tables (0 = null page; every entry names a page of the arena)
    · ``pos``: int32 [B, nblocks·P] logical positions (-1 = empty) ·
    ``q_pos``: int32 [B] · ``k_exp``/``v_exp``: f32 [n_pages] per-PAGE
    log2-steps.  On the card ``P`` must be a multiple of 32.
    Returns f32 [B, K, G, hd]; numerics are
    :func:`repro_torch.kernels.attn.ref.paged_decode_attention_ref` (on the
    card split over the pages as :func:`decode_splits` says, and merged as
    :func:`repro_torch.kernels.attn.ref.paged_decode_split_ref` does).
    Under ``tp_axis`` the arenas hold the rank's kv heads inside every
    page and the result is the rank's head slice.
    """
    K_all = q.shape[1]
    q = local_heads(q, tp_axis, 1)
    dispatch.paged_attn_blocks_for(k.shape[1], q.shape[2], q.shape[3],
                                   width=width,
                                   interpret=q.device.type == "cpu")
    if q.device.type == "cpu":
        return R.paged_decode_attention_ref(
            q, k, v, bt, pos, q_pos, k_exp=k_exp, v_exp=v_exp, width=width,
            scale=scale, window=window, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged runs on cpu or cuda, not "
                         f"{q.device}")
    B, K, G, hd = q.shape
    dev = q.device
    _check("q", q, (B, K, G, hd), torch.float32, dev)
    _check("q_pos", q_pos, (B,), torch.int32, dev)
    n_pages, P, nblocks = _check_paged(k, v, bt, pos, B, K, hd, width, dev)
    if G > 32:
        raise ValueError(f"flash_decode_paged takes G <= 32, got G={G}")
    steps = _steps(n_pages, k_exp, v_exp, width, dev)
    _check("steps", steps, (n_pages, 2), torch.float32, dev)
    out = torch.empty_like(q)
    splits, pps = decode_splits(B, K_all, nblocks)
    ws = _workspace(splits, B * K * G, hd, dev)
    fn = build.library("flash_decode_paged").flash_decode_paged_launch
    rc = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bt), _ptr(pos), _ptr(q_pos),
            _ptr(steps), _ptr(out), _ptr(ws), B,
            nblocks, P, K, G, hd, _DTYPE_CODE[_storage_dtype(width)],
            float(scale), int(window or 0), int(causal), splits, pps,
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"flash_decode_paged kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["flash_decode_paged"] += 1
    return out


def flash_prefill_paged(q: Tensor, k_new: Tensor, v_new: Tensor, k: Tensor,
                        v: Tensor, bt: Tensor, pos: Tensor, p0: Tensor,
                        n_valid: Tensor, k_exp=None, v_exp=None, *,
                        width: Optional[int] = None, scale: float,
                        window: Optional[int] = None,
                        causal: bool = True, tp_axis: Optional[str] = None
                        ) -> Tensor:
    """Chunked-prefill GQA attention through a block table — K6.

    ``q``: f32 [B, C, K, G, hd] chunk queries starting at ``p0`` [B] ·
    ``k_new``/``v_new``: f32 [B, C, K, hd] the chunk's own K/V ·
    ``k``/``v``: [n_pages, P, K, hd] page arenas · ``bt``: int32
    [B, nblocks] · ``pos``: int32 [B, nblocks·P] · ``n_valid``: int32 [B]
    · ``k_exp``/``v_exp``: f32 [n_pages] per-PAGE log2-steps.  On the
    card ``P`` must be a multiple of 32.  Returns f32 [B, C, K, G, hd];
    numerics are
    :func:`repro_torch.kernels.attn.ref.paged_prefill_attention_ref` (on
    the card K4's TF32 route over the pages, split as
    :func:`prefill_paged_plan` says:
    :func:`repro_torch.kernels.attn.ref.paged_prefill_tf32_emulated`).
    Under ``tp_axis`` as :func:`flash_prefill`.
    """
    K_all = q.shape[2]
    q = local_heads(q, tp_axis, 2)
    k_new = local_heads(k_new, tp_axis, 2)
    v_new = local_heads(v_new, tp_axis, 2)
    dispatch.paged_prefill_blocks_for(k.shape[1], q.shape[1], q.shape[3],
                                      q.shape[4], width=width,
                                      interpret=q.device.type == "cpu")
    if q.device.type == "cpu":
        return R.paged_prefill_attention_ref(
            q, k, v, bt, pos, k_new, v_new, p0, n_valid, k_exp=k_exp,
            v_exp=v_exp, width=width, scale=scale, window=window,
            causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_paged runs on cpu or cuda, not "
                         f"{q.device}")
    B, C, K, G, hd = q.shape
    dev = q.device
    _check("q", q, (B, C, K, G, hd), torch.float32, dev)
    _check("k_new", k_new, (B, C, K, hd), torch.float32, dev)
    _check("v_new", v_new, (B, C, K, hd), torch.float32, dev)
    _check("p0", p0, (B,), torch.int32, dev)
    _check("n_valid", n_valid, (B,), torch.int32, dev)
    n_pages, P, nblocks = _check_paged(k, v, bt, pos, B, K, hd, width, dev)
    if B > 65535 or K > 65535:
        raise ValueError(f"flash_prefill_paged takes B, K <= 65535, got "
                         f"B={B}, K={K}")
    steps = _steps(n_pages, k_exp, v_exp, width, dev)
    _check("steps", steps, (n_pages, 2), torch.float32, dev)
    out = launch_prefill_paged(
        q, k_new, v_new, k, v, bt, pos, p0, n_valid, steps, width=width,
        scale=scale, window=window, causal=causal,
        plan=prefill_paged_plan(B, C, nblocks, P, K_all, G, hd))
    LAUNCHES["flash_prefill_paged"] += 1
    return out


def prefill_paged_plan(B: int, C: int, nblocks: int, P: int, K: int, G: int,
                       hd: int):
    """``(warps, splits)`` of a K6 call: K4's plan (:func:`prefill_plan`)
    over the ``nblocks·P`` logical rows of a block-table row."""
    return prefill_plan(B, C, nblocks * P, K, G, hd)


def launch_prefill_paged(q, k_new, v_new, k, v, bt, pos, p0, n_valid, steps,
                         *, width, scale, window, causal, plan) -> Tensor:
    """One K6 call under ``plan`` (:func:`prefill_paged_plan`'s form) on
    checked card tensors; ``steps`` [n_pages, 2].  Counts nothing: the
    wrapper does, and the plan sweep (``tools/attn_plan_sweep.py``) calls
    this directly."""
    B, C, K, G, hd = q.shape
    P = k.shape[1]
    nblocks = bt.shape[1]
    warps, splits = plan
    out = torch.empty_like(q)
    ws = _workspace(splits, B * C * K * G, hd, q.device)
    fn = build.library("flash_prefill_paged").flash_prefill_paged_launch
    rc = fn(_ptr(q), _ptr(k_new), _ptr(v_new), _ptr(k), _ptr(v), _ptr(bt),
            _ptr(pos), _ptr(p0), _ptr(n_valid), _ptr(steps), _ptr(out),
            _ptr(ws), B, C, nblocks, P, K, G, hd,
            _DTYPE_CODE[_storage_dtype(width)], float(scale),
            int(window or 0), int(causal), warps, splits,
            _stream(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_prefill_paged kernel launch failed (plan "
                           f"{plan}): CUDA error {rc}")
    return out
