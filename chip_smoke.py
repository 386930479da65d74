"""Smoke run of the PyTorch port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build all six kernels — flash-decode (K3), flash-prefill (K4), their
   paged variants (K5, K6), the fused quantize (K1) and the quantized
   matmul (K2) — from the ``csrc`` directories under
   ``src/repro_torch/kernels`` with ``nvcc`` (one process per source, in
   parallel) and print each kernel's registers and shared memory;
3. hold each kernel against its plain PyTorch version on card tensors at
   the serving slices' shapes (K3: B=4 slots, W=400, K=8, G=4, hd=128 for
   int8, int16, f32 and sliding windows that leave splits with no key,
   and hd=48 over a ragged ring; K4: C=128 with ragged n_valid and p0 > 0,
   a window, and hd=48; K5: B=4 slots over 64-row pages, 8 blocks, null
   pages, a shared page, an empty slot, splits that see no key, and
   hd=40, 48, 72; K6: C=64 at p0=384, a ragged chunk, a window, hd=48
   over 32-row pages, every split count up to its plan's, timed), hold K5
   against K3 and K6 against K4 on the same data laid out as a ring
   (K6 = K4 bit for bit), check that two calls of K3, K4, K5 and K6 give
   the same bits, and time kernel (every launch of a call: the split pass
   and the merge of K3, K4, K5 and K6), plain version and a library
   yardstick;
4. smoke-size parity: the port's model on the card (kernels) against the
   same model on the CPU (plain versions), slot-major and paged (engine
   logits with prefix sharing, and a tight arena that preempts);
5. the main path: ``repro_torch.launch.serve`` at full llama3-8B width,
   DFXP-10, int8 pool, fused decode, chunked prefill (6 requests, 4
   slots, 16 tokens each); every request must end OK and both kernels
   must have launched, K3 once per layer per decode step;
6. the paged main path on the same weights: P = C = 64, int8 pages,
   fused decode, 6 requests with a shared 256-token prefix and two
   identical prompts; K5 and K6 must launch once per layer per decode
   step and per chunk, K3 and K4 not at all, and the allocator's
   counters must equal their arithmetic;
7. one profiled decode step and prefill chunk of each layout;
8. a whole-prompt run (``prefill_chunk=0``) on the same weights;
9. K1 bit-exact and K2 within ``rtol=1e-5, atol=1e-5·sqrt(D)`` against
   their plain versions (maxout sites and shapes, every K2 layout and
   width pairing, widths past TF32's 11 bits up to 32, ragged sizes,
   f16/bf16, views at element offsets 1-3 (K1's scalar path),
   NaN/±inf, exponents ±30, the llama3-8B ``w_up`` weight and chunk
   product), K2 bit-exact on an on-grid product and the same bits in two
   calls of a split-K plan, timed (K1: the kernel alone, and the whole
   call with the number of device operations it puts on the stream; K2:
   its split pass and its reduction) beside
   ``torch.fake_quantize_per_tensor_affine`` / eager ``fixed_round`` and
   ``torch.matmul``;
10. training parity at smoke size: DFXP-10/12 maxout on the card (K1,
    K2) against the CPU (plain versions), 10 steps, and 5 steps computing
    at width 31 (K2 at width 31);
11. the training main path: ``repro_torch.examples.quickstart`` at the
    paper's full PI-MNIST width (the four Table-3 rows, DFXP calibrated,
    150 steps each, fused matmul and kernel quantize on); K1 and K2 must
    launch exactly as often as the rounding sites and products give,
    every row must reach 0.99 eval accuracy, DFXP's loss must end below
    fixed 20/20's and within 10x of float32's (mean of the last 10
    steps), its parameters on their grids, and an exponent must have
    moved; then 20 conv-maxout steps at the conv defaults;
12. one profiled full-width DFXP training step.

The ``kernels`` JSON gives each attention kernel's device time per call
inside the profiled serving step (``in_step_ms_per_call``) beside its
isolated rows.  The line before the last is the ``kernels`` JSON; the
last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the rest
of the repository, it exits non-zero and prints no result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TOL = 1e-4                      # kernel vs plain, outputs of size O(1..16)
K6_TOL = 1e-5                   # K6 on K4's TF32 route vs plain (atol, rtol)
SERVE_ARGS = ["--arch", "llama3_8b", "--num-requests", "6", "--slots", "4",
              "--prompt-len", "96,200,384", "--max-new", "16",
              "--cache-bits", "8", "--fused-decode", "--prefill-chunk",
              "128"]
PAGE = 64                       # the paged run's page size and chunk
MIN_SIZE = 1 << 14              # enable_pallas_quantize's threshold (K1)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n_iter: int = 50) -> float:
    """Mean ms of ``fn()`` over ``n_iter`` calls, CUDA events, warmed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def _device_time_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _on_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def device_ms(fn, match=None, n_iter: int = 20):
    """Mean device time per call of ``fn()`` in ms and its source: the
    ``torch.profiler`` time of the kernels whose name contains ``match``
    (every kernel the call launches when ``match`` is None), host-side
    launch gaps excluded.  Some profiler sessions on the card record no
    device activity at all; after three such sessions the time is taken
    with CUDA events instead (:func:`cuda_ms`, the call as the stream
    sees it), and the source says so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_iter):
                fn()
            torch.cuda.synchronize()
        us = sum(_device_time_us(e) for e in prof.key_averages()
                 if _on_device(e) and (match is None or match in e.key))
        if us > 0:
            return us / 1e3 / n_iter, "profiler"
    return cuda_ms(fn, n_iter), "cuda_events"


def rotating(fn_of_case, cases_list):
    """A call that walks a ring of input copies (more bytes than the 50 MB
    L2), so each launch reads its operands from device memory, as a layer
    of the model does."""
    it = {"i": 0}

    def call():
        a = cases_list[it["i"] % len(cases_list)]
        it["i"] += 1
        return fn_of_case(a)
    return call


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.attn import ops as attn_ops
    from repro_torch.kernels.qmatmul import ops as k2_ops
    from repro_torch.kernels.qmatmul.ref import is_split
    report = build.build_all(force=True)
    for name, r in report.items():
        info = [ln.strip() for ln in r["ptxas"].splitlines()
                if "registers" in ln or "Compiling entry" in ln
                or "smem" in ln]
        log(f"built {name} in {r['seconds']:.1f}s")
        for ln in info:
            log("  ", ln)
    # K3 and K5 (decode_common.cuh smem_bytes): a ring of raw K and V
    # tiles, 32 rows of hd values padded by 16 bytes (3 stages, f32: 2),
    # the query rows and a vote and an index per tile of the block's range
    k3_splits, tps = attn_ops.ring_splits(4, 8, 400)
    splits, pps = attn_ops.decode_splits(4, 8, 8)
    for tag, size in (("int8", 1), ("int16", 2), ("f32", 4)):
        stages = 2 if size == 4 else 3
        ring = stages * 2 * 32 * (128 * size + 16) + 4 * 128 * 4 + 16
        log(f"  flash_decode {tag}: {ring + tps * 8} bytes of dynamic "
            f"shared memory per block at hd=128, G=4, W=400 ({k3_splits} "
            f"splits of {tps} tiles)")
        log(f"  flash_decode_paged {tag}: {ring + pps * (PAGE // 32) * 8} "
            f"bytes of dynamic shared memory per block at hd=128, G=4, "
            f"P={PAGE} ({splits} splits of {pps} pages)")
    # K4 and K6 (prefill_common.cuh PGeo)
    warps, p_splits = attn_ops.prefill_plan(1, 128, 400, 8, 4, 128)
    log(f"  flash_prefill: {prefill_smem(128, 400, 128)} bytes of dynamic "
        f"shared memory per block at hd=128, W=400, C=128 ({16 * warps}-row "
        f"blocks, {p_splits} splits at B=1)")
    warps, p_splits = attn_ops.prefill_paged_plan(1, PAGE, 8, PAGE, 8, 4, 128)
    log(f"  flash_prefill_paged: {prefill_smem(128, 8 * PAGE, PAGE)} bytes "
        f"of dynamic shared memory per block at hd=128, P={PAGE}, 8 blocks, "
        f"C={PAGE} ({16 * warps}-row blocks, {p_splits} splits at B=1)")
    # K2 (qmatmul.cu Smem): 3 stages of a 64x32 A tile and a 32 x bn B tile,
    # rows padded by 4 (k contiguous) or 8 floats, and two lo planes of
    # each split operand; the main path's widths (raw x 10 bits; the wgrad
    # raw x raw)
    for kind, (R, C, D), wb in (("nn", (64, 1200, 784), 10),
                                ("nt", (64, 240, 1200), 10),
                                ("tn", (784, 1200, 64), None)):
        bn, splits, per = k2_ops.plan(R, C, D)
        sa = 64 * 36 if kind != "tn" else 32 * 72
        sb = bn * 36 if kind == "nt" else 32 * (bn + 8)
        lo = sa + (sb if is_split(wb) else 0)
        log(f"  qmatmul {kind} [{R},{C}] D={D}: tiles 64x{bn}, {splits} "
            f"splits of {per} slices, {(3 * (sa + sb) + 2 * lo) * 4} bytes "
            f"of dynamic shared memory per block")
    # static shared memory (the "smem" lines above): K1 two per-warp count
    # arrays
    log(f"  dfxp_quantize: {2 * 8 * 4} bytes of static shared memory per "
        f"block")


def prefill_smem(hd: int, W: int, C: int) -> int:
    """Dynamic shared memory of a K4 / K6 block (prefill_common.cuh PGeo):
    a 2-stage ring of K and V tiles at f32's padded rows, the block's
    query rows as TF32 hi and lo planes (HD + 4 floats a row), a list
    entry and a vote per tile of the history and the chunk."""
    warps = 8 if hd <= 128 else 2
    HD = 32 * -(-hd // 32)
    row = 4 * (HD + (4 - HD % 32 + 32) % 32)
    n_list = -(-W // 32) + -(-C // 32)
    return (2 * 2 * 32 * row + 2 * 16 * warps * (HD + 4) * 4 + n_list * 8
            + 16)


def phase_kernels():
    """K3-K6 against their plain versions; timings and bounds."""
    from repro_torch.kernels.attn import cases, ops, ref
    dev = torch.device("cuda")
    B, W, K, G, HD, C = 4, 400, 8, 4, 128, 128
    NBLK = 8                    # paged: 464-token max_len over 64-row pages

    def k3(a):
        return ops.flash_decode(a["q"], a["k"], a["v"], a["pos"], a["q_pos"],
                                a["k_exp"], a["v_exp"], width=a["width"],
                                scale=a["scale"], window=a["window"])

    def k3_plain(a):
        return ref.decode_attention_ref(
            a["q"], a["k"], a["v"], a["pos"], a["q_pos"], k_exp=a["k_exp"],
            v_exp=a["v_exp"], width=a["width"], scale=a["scale"],
            window=a["window"])

    def k4(a):
        return ops.flash_prefill(a["q"], a["k_new"], a["v_new"], a["k"],
                                 a["v"], a["pos"], a["p0"], a["n_valid"],
                                 a["k_exp"], a["v_exp"], width=a["width"],
                                 scale=a["scale"], window=a["window"])

    def k4_plain(a):
        return ref.prefill_attention_ref(
            a["q"], a["k"], a["v"], a["pos"], a["k_new"], a["v_new"],
            a["p0"], a["n_valid"], k_exp=a["k_exp"], v_exp=a["v_exp"],
            width=a["width"], scale=a["scale"], window=a["window"])

    def sdpa_decode(a):
        # the same function in one library call: f32 K/V, boolean mask
        valid = ref.valid_mask(a["pos"], a["q_pos"], window=a["window"],
                               causal=True)[:, None, None, :]
        k, v = a["k"].permute(0, 2, 1, 3), a["v"].permute(0, 2, 1, 3)
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            a["q"], k, v, attn_mask=valid, scale=a["scale"])

    def sdpa_prefill(a):
        # f32 history + self K/V concatenated and the joint mask built
        # outside the timed call
        Bq, Cq = a["q"].shape[:2]
        vh, vs = cases.prefill_valid(a)
        mask = torch.cat([vh, vs], dim=-1)                     # [B, C, W+C]
        mask = mask.repeat_interleave(G, dim=1)[:, None]       # [B,1,CG,W+C]
        q = a["q"].permute(0, 2, 1, 3, 4).reshape(Bq, K, Cq * G, HD)
        kc = torch.cat([a["k"], a["k_new"]], 1).permute(0, 2, 1, 3)
        vc = torch.cat([a["v"], a["v_new"]], 1).permute(0, 2, 1, 3)
        kc, vc = kc.contiguous(), vc.contiguous()
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask, scale=a["scale"])

    def k5(a):
        return ops.flash_decode_paged(
            a["q"], a["k"], a["v"], a["bt"], a["pos"], a["q_pos"],
            a["k_exp"], a["v_exp"], width=a["width"], scale=a["scale"],
            window=a["window"])

    def k5_plain(a):
        return ref.paged_decode_attention_ref(
            a["q"], a["k"], a["v"], a["bt"], a["pos"], a["q_pos"],
            k_exp=a["k_exp"], v_exp=a["v_exp"], width=a["width"],
            scale=a["scale"], window=a["window"])

    def k6(a):
        return ops.flash_prefill_paged(
            a["q"], a["k_new"], a["v_new"], a["k"], a["v"], a["bt"],
            a["pos"], a["p0"], a["n_valid"], a["k_exp"], a["v_exp"],
            width=a["width"], scale=a["scale"], window=a["window"])

    def k6_plain(a):
        return ref.paged_prefill_attention_ref(
            a["q"], a["k"], a["v"], a["bt"], a["pos"], a["k_new"],
            a["v_new"], a["p0"], a["n_valid"], k_exp=a["k_exp"],
            v_exp=a["v_exp"], width=a["width"], scale=a["scale"],
            window=a["window"])

    def gathered(a):
        """A paged f32 case with its pages gathered into slot-major K/V
        (outside any timed call), for the library yardstick."""
        g = dict(a)
        g["k"] = ref.gather_pages(a["k"], None, a["bt"], None)
        g["v"] = ref.gather_pages(a["v"], None, a["bt"], None)
        return g

    results = {}

    def check(name, fn, plain, a, tol=TOL):
        out, want = fn(a), plain(a)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        bad = not torch.allclose(out, want, atol=tol, rtol=tol)
        log(f"{name}: max_abs_err {err:.3e}" + ("  FAIL" if bad else ""))
        if bad:
            raise SystemExit(f"{name} disagrees with its plain version")
        return err

    def timed(name, kernel, fn, plain, make, cost, library=None, info=None):
        # the library yardstick runs on the first case, as built by
        # ``library`` (its inputs made outside the timed call)
        copies = [make(seed) for seed in range(24)]
        lib = None
        if library is not None:
            call = library(copies[0])
            lib = lambda a: call()
        return time_row(name, kernel, fn, plain, copies, cost, lib, info=info)

    def same_bits(name, fn, a):
        if not torch.equal(fn(a), fn(a)):
            raise SystemExit(f"{name}: two calls differ")

    errs = {"flash_decode": [], "flash_prefill": []}
    decode_rows = {}
    k3_splits = ops.ring_splits(B, K, W)
    for width, tag in ((8, "int8"), (16, "int16"), (None, "f32")):
        for window in (None, 128, 40):
            # window 40 at the slots' last position: the early splits of
            # the ring see no key (m = -inf); slot 3 holds one key
            a = cases.decode_case(B, W, K, G, HD, width, window=window,
                                  fill=[W, 3 * W // 2, 37, 1], seed=1,
                                  device=dev)
            errs["flash_decode"].append(
                check(f"K3 {tag} window={window} ({k3_splits[0]} splits of "
                      f"{k3_splits[1]} tiles)", k3, k3_plain, a))
            same_bits(f"K3 {tag} window={window}", k3, a)
        a = cases.decode_case(3, 333, 2, G, 48, width, window=200,
                              fill=[333, 400, 0], seed=2, device=dev)
        errs["flash_decode"].append(check(
            f"K3 {tag} hd=48 W=333 ({ops.ring_splits(3, 2, 333)[0]} "
            f"splits)", k3, k3_plain, a))
        if not torch.all(k3(a)[2] == 0):
            raise SystemExit("K3: an empty slot is not 0")
    log(f"K3 (B={B}, K={K}, W={W}): {k3_splits[0]} splits of "
        f"{k3_splits[1]} tiles; two calls bit-identical (int8, int16, f32)")
    for width, tag in ((8, "int8"), (16, "int16"), (None, "f32")):
        decode_rows[tag] = timed(
            f"K3 {tag} timing ({k3_splits[0]} splits)",
            "flash_decode_kernel", k3, k3_plain,
            lambda s, w=width: cases.decode_case(B, W, K, G, HD, w, seed=s,
                                                 device=dev),
            cases.decode_cost, sdpa_decode if width is None else None,
            info={"splits": k3_splits[0], "tiles_per_split": k3_splits[1]})
    prefill_rows = {}
    plan = ops.prefill_plan(1, C, W, K, G, HD)
    for width, tag in ((8, "int8"), (16, "int16"), (None, "f32")):
        a = cases.prefill_case(2, C, W, K, G, HD, width, p0=[256, 0],
                               n_valid=[100, C], seed=3, device=dev)
        errs["flash_prefill"].append(
            check(f"K4 {tag} B=2 p0=[256,0] nv=[100,128]", k4, k4_plain, a))
        a = cases.prefill_case(1, C, W, K, G, HD, width, p0=[256],
                               n_valid=[C], window=128, seed=4, device=dev)
        errs["flash_prefill"].append(
            check(f"K4 {tag} window=128 (plan {plan})", k4, k4_plain, a))
        same_bits(f"K4 {tag} window=128", k4, a)
        a = cases.prefill_case(2, 40, 75, 2, 3, 48, width, p0=[60, 0],
                               n_valid=[40, 23], seed=5, device=dev)
        errs["flash_prefill"].append(
            check(f"K4 {tag} hd=48 C=40 W=75", k4, k4_plain, a))
    log(f"K4 (B=1, C={C}, W={W}, hd={HD}): plan (warps, splits) {plan}; "
        f"two calls bit-identical (int8, int16, f32)")
    for width, tag in ((8, "int8"), (16, "int16"), (None, "f32")):
        make = (lambda s, w=width: cases.prefill_case(
            1, C, W, K, G, HD, w, p0=[256], n_valid=[C], seed=s, device=dev))
        bounds = cases.prefill_bounds(make(0))
        prefill_rows[tag] = timed(
            f"K4 {tag} timing (B=1, C=128, p0=256, W=400)",
            "flash_prefill_kernel", k4, k4_plain, make,
            cases.prefill_route_cost, sdpa_prefill if width is None else None,
            info={"plan": dict(zip(("warps", "splits"), plan)),
                  "products": bounds["products"],
                  "f32_bound_ms": bounds["f32_bound_ms"],
                  "f32_bound_by": bounds["f32_bound_by"]})
    # K5 / K6: the paged run's shapes (4 slots over 8 blocks of 64 rows;
    # one 64-row chunk against a 384-row history)
    errs["flash_decode_paged"], errs["flash_prefill_paged"] = [], []
    for width, tag in ((8, "int8"), (16, "int16"), (None, "f32")):
        for window in (None, 128):
            a = cases.decode_paged_case(B, PAGE, NBLK, K, G, HD, width,
                                        fill=[NBLK * PAGE, 257, 96, 0],
                                        window=window, seed=6, device=dev)
            errs["flash_decode_paged"].append(
                check(f"K5 {tag} window={window}", k5, k5_plain, a))
            if not torch.all(k5(a)[3] == 0):
                raise SystemExit("K5: a slot with no pages is not 0")
        # K6 on K4's route: held to 1e-5 (K6_TOL), as K4's route is on
        # the CPU (tests/test_torch_paged_split.py)
        a = cases.prefill_paged_case(2, PAGE, PAGE, NBLK, K, G, HD, width,
                                     p0=[384, 64], n_valid=[PAGE, 37],
                                     seed=7, device=dev)
        errs["flash_prefill_paged"].append(
            check(f"K6 {tag} B=2 p0=[384,64] nv=[64,37]", k6, k6_plain, a,
                  K6_TOL))
        a = cases.prefill_paged_case(1, PAGE, PAGE, NBLK, K, G, HD, width,
                                     p0=[384], n_valid=[PAGE], window=128,
                                     seed=8, device=dev)
        errs["flash_prefill_paged"].append(check(
            f"K6 {tag} window=128 (plan "
            f"{ops.prefill_paged_plan(1, PAGE, NBLK, PAGE, K, G, HD)})", k6,
            k6_plain, a, K6_TOL))
        same_bits(f"K6 {tag} window=128", k6, a)
        a = cases.prefill_paged_case(2, 40, 32, 5, 2, 3, 48, width,
                                     p0=[100, 0], n_valid=[40, 23],
                                     seed=10, device=dev)
        errs["flash_prefill_paged"].append(check(
            f"K6 {tag} hd=48 C=40 P=32", k6, k6_plain, a, K6_TOL))
        # K6 against K4 on the same data: each slot's ring one page (P = W
        # = 384) with the slot's steps; one code, one plan: the same bits
        a = cases.prefill_case(2, PAGE, 384, K, G, HD, width, p0=[256, 100],
                               n_valid=[PAGE, 37], seed=13, device=dev)
        zero, e0 = torch.zeros_like(a["k"][:1]), torch.zeros(1, device=dev)
        paged = dict(a, k=torch.cat([zero, a["k"]]),
                     v=torch.cat([zero, a["v"]]),
                     bt=torch.tensor([[1], [2]], dtype=torch.int32,
                                     device=dev),
                     k_exp=None if width is None
                     else torch.cat([e0, a["k_exp"]]),
                     v_exp=None if width is None
                     else torch.cat([e0, a["v_exp"]]))
        if not torch.equal(k6(paged), k4(a)):
            raise SystemExit(f"K6 and K4 differ on the same data ({tag})")
    log("K6 vs K4 on the same data (int8, int16, f32; one page per slot): "
        "bit-identical")
    # K5 against K3 on the same data: the pages gathered into a ring,
    # one exponent per slot; at hd = 128 and at hd = 48, a head dim that
    # is not a multiple of 32 (both on their generic-hd path)
    k5_vs_k3 = 0.0
    for width, hd in ((8, HD), (16, HD), (None, HD), (8, 48), (None, 48)):
        a = cases.decode_paged_case(B, PAGE, NBLK, K, G, hd, width,
                                    fill=[NBLK * PAGE, 257, 96, 0],
                                    share=False, seed=9, device=dev)
        slot_e = None
        if width is not None:
            slot_e = torch.arange(B, dtype=torch.float32, device=dev) \
                + 1 - width
            for name in ("k_exp", "v_exp"):
                e = torch.zeros_like(a[name])
                for b in range(B):
                    e[a["bt"][b].long()] = slot_e[b]
                e[0] = 0.0
                a[name] = e
        idx = a["bt"].long()
        ring = dict(a, k=a["k"][idx].reshape(B, NBLK * PAGE, K, hd)
                    .contiguous(),
                    v=a["v"][idx].reshape(B, NBLK * PAGE, K, hd)
                    .contiguous(), k_exp=slot_e, v_exp=slot_e)
        d = float((k5(a) - k3(ring)).abs().max())
        k5_vs_k3 = max(k5_vs_k3, d)
        if d > TOL:
            raise SystemExit(f"K5 and K3 disagree on the same data at "
                             f"hd={hd}: {d}")
    log(f"K5 vs K3 on the same data (int8, int16, f32 at hd=128; int8, "
        f"f32 at hd=48): max_abs_diff {k5_vs_k3:.3e}")
    # K5 splits the pages and merges the splits in a fixed order: the same
    # bits from two calls; and splits that see no key (one slot and two kv
    # heads give a split per page; a window leaves the early splits empty)
    splits = ops.decode_splits(B, K, NBLK)
    for width, tag in ((8, "int8"), (16, "int16"), (None, "f32")):
        a = cases.decode_paged_case(B, PAGE, NBLK, K, G, HD, width,
                                    fill=[NBLK * PAGE, 257, 96, 0], seed=11,
                                    device=dev)
        if not torch.equal(k5(a), k5(a)):
            raise SystemExit(f"K5 {tag}: two calls differ")
        errs["flash_decode_paged"].append(check(
            f"K5 {tag} window=40 (3 of {splits[0]} splits masked)", k5,
            k5_plain, dict(a, window=40)))
        a = cases.decode_paged_case(2, PAGE, NBLK, 2, G, HD, width,
                                    fill=[PAGE + 5, 1], seed=12, device=dev)
        errs["flash_decode_paged"].append(check(
            f"K5 {tag} B=2 K=2 ({ops.decode_splits(2, 2, NBLK)[0]} splits, "
            f"2 live pages)", k5, k5_plain, a))
    for hd in (40, 48, 72):
        a = cases.decode_paged_case(B, PAGE, NBLK, K, G, hd, 8,
                                    fill=[NBLK * PAGE, 257, 96, 0],
                                    window=100, seed=15, device=dev)
        errs["flash_decode_paged"].append(
            check(f"K5 int8 hd={hd} window=100", k5, k5_plain, a))
    log(f"K5 (B={B}, K={K}, nblocks={NBLK}): {splits[0]} splits of "
        f"{splits[1]} pages; two calls bit-identical (int8, int16, f32)")
    decode_paged_rows, prefill_paged_rows = {}, {}
    fills = [320, 384, 448, 200]      # the paged run's prompt lengths
    for width, tag in ((8, "int8"), (16, "int16"), (None, "f32")):
        decode_paged_rows[tag] = timed(
            f"K5 {tag} timing (B=4, P=64, nblocks=8, fill={fills}, "
            f"{splits[0]} splits)",
            "flash_decode_paged_kernel", k5, k5_plain,
            lambda s, w=width: cases.decode_paged_case(
                B, PAGE, NBLK, K, G, HD, w, fill=fills, seed=s, device=dev),
            cases.decode_paged_cost,
            (lambda a: sdpa_decode(gathered(a))) if width is None else None)
        decode_paged_rows[tag]["splits"] = splits[0]
    k6_plan = ops.prefill_paged_plan(1, PAGE, NBLK, PAGE, K, G, HD)
    sweep = k6_sweep(k6_plain, dev, NBLK, K, G, HD)
    log(f"K6 (B=1, C={PAGE}, P={PAGE}, nblocks={NBLK}, hd={HD}): plan "
        f"(warps, splits) {k6_plan}; fastest in this run's sweep: "
        f"{sweep['fastest']} splits ({json.dumps(sweep['us'])} us, int8)")
    for width, tag in ((8, "int8"), (16, "int16"), (None, "f32")):
        make = (lambda s, w=width: cases.prefill_paged_case(
            1, PAGE, PAGE, NBLK, K, G, HD, w, p0=[384], n_valid=[PAGE],
            seed=s, device=dev))
        bounds = cases.prefill_paged_bounds(make(0))
        prefill_paged_rows[tag] = timed(
            f"K6 {tag} timing (B=1, C=64, p0=384, P=64, nblocks=8)",
            "flash_prefill_paged_kernel", k6, k6_plain, make,
            cases.prefill_paged_route_cost,
            (lambda a: sdpa_prefill(gathered(a))) if width is None else None,
            info={"plan": dict(zip(("warps", "splits"), k6_plan)),
                  "products": bounds["products"],
                  "f32_bound_ms": bounds["f32_bound_ms"],
                  "f32_bound_by": bounds["f32_bound_by"]})
    prefill_paged_rows["int8"]["sweep"] = sweep
    results["flash_decode"] = dict(rows=decode_rows,
                                   max_abs_err=max(errs["flash_decode"]))
    results["flash_prefill"] = dict(rows=prefill_rows,
                                    max_abs_err=max(errs["flash_prefill"]))
    results["flash_decode_paged"] = dict(
        rows=decode_paged_rows, max_abs_err=max(errs["flash_decode_paged"]),
        k5_vs_k3_max_abs_diff=k5_vs_k3)
    results["flash_prefill_paged"] = dict(
        rows=prefill_paged_rows,
        max_abs_err=max(errs["flash_prefill_paged"]))
    return results


def k6_sweep(plain, dev, nblocks, K, G, hd) -> dict:
    """K6 int8 at the paged run's chunk (B=1, C=P=64, p0=384) under every
    split count up to its plan's, each checked against the plain version
    (K6_TOL) and for the same bits twice, and timed (device µs per call,
    both launches, on 24 inputs past the L2)."""
    from repro_torch.kernels.attn import cases, ops
    copies = [cases.prefill_paged_case(1, PAGE, PAGE, nblocks, K, G, hd, 8,
                                       p0=[384], n_valid=[PAGE], seed=s,
                                       device=dev) for s in range(24)]
    for a in copies:
        a["steps"] = ops._steps(a["k"].shape[0], a["k_exp"], a["v_exp"], 8,
                                dev)
    warps, top = ops.prefill_paged_plan(1, PAGE, nblocks, PAGE, K, G, hd)
    us = {}
    for s in range(1, top + 1):
        def run(a, s=s):
            return ops.launch_prefill_paged(
                a["q"], a["k_new"], a["v_new"], a["k"], a["v"], a["bt"],
                a["pos"], a["p0"], a["n_valid"], a["steps"], width=8,
                scale=a["scale"], window=None, causal=True, plan=(warps, s))
        out = run(copies[0])
        if not (torch.allclose(out, plain(copies[0]), atol=K6_TOL,
                               rtol=K6_TOL)
                and torch.equal(out, run(copies[0]))):
            raise SystemExit(f"K6 with {s} splits disagrees with its plain "
                             f"version or with itself")
        us[s] = device_ms(rotating(run, copies),
                          "flash_prefill_paged_kernel")[0] * 1e3
    return {"us": us, "fastest": min(us, key=us.get), "plan": top}


def phase_parity():
    """Smoke-size model on the card (kernels) vs the CPU (plain)."""
    from repro_torch import configs
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.core.scale import ScaleState
    from repro_torch.models import transformer as T
    from repro_torch.serve import kv_pool

    cfg = configs.get_smoke("llama3_8b")
    pol = PrecisionPolicy("float32", fused_decode=True)
    logits = {}
    for dev in ("cuda", "cpu"):
        params = _to(T.init_params(cfg, 7, device="cpu"), dev)
        exps = ScaleState.create(T.group_shapes(cfg), -6.0, device=dev).exps
        # an f32 pool: quantizing K/V that differ by an ulp between the
        # two devices could move a mantissa by a step at a rounding tie
        kvp = kv_pool.make_kv_pool(cfg, pol, max_slots=1, max_len=48,
                                   device=dev)
        g = torch.Generator().manual_seed(11)
        toks = torch.randint(0, cfg.vocab_size, (1, 40), generator=g)
        out = []
        for p0 in (0, 16, 32):
            n = min(16, 40 - p0)
            t = torch.zeros((1, 16), dtype=torch.int32)
            t[0, :n] = toks[0, p0:p0 + n]
            lg, _, _ = T.prefill_chunk_step(
                cfg, pol, params, kvp.pool, t.to(dev),
                torch.tensor([p0], dtype=torch.int32, device=dev),
                torch.tensor([n], dtype=torch.int32, device=dev), exps,
                kv_codec=kvp.codec)
            out.append(lg.cpu())
        for step in range(4):
            lg, _, _ = T.decode_step(
                cfg, pol, params, kvp.pool, toks[:, step].to(dev),
                torch.tensor([40 + step], dtype=torch.int32, device=dev),
                exps, kv_codec=kvp.codec)
            out.append(lg.cpu())
        logits[dev] = torch.stack(out)
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    log(f"smoke parity card vs cpu: logits {tuple(logits['cpu'].shape)} "
        f"max_abs_err {err:.3e}")
    if not (torch.isfinite(logits["cuda"]).all() and err < TOL):
        raise SystemExit("the port on the card disagrees with the CPU")


def phase_parity_paged():
    """Smoke-size paged engine on the card (K5/K6) vs the CPU (plain):
    the logits of every chunk and decode step under prefix sharing, at
    float32 arithmetic over f32 pages; and a tight arena that preempts,
    whose statuses and preemption count must match."""
    from repro_torch import configs
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.launch.serve import prompt
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineOptions, ServeEngine

    cfg = configs.get_smoke("llama3_8b")
    P = 32
    pol = PrecisionPolicy("float32", fused_decode=True, page_size=P)
    shared = prompt(200, 2 * P, cfg.vocab_size)
    pa, pb = (np.concatenate([shared, prompt(201 + i, 16, cfg.vocab_size)])
              for i in range(2))

    def run(dev, prompts, slots, max_new, n_pages=None):
        params = _to(T.init_params(cfg, 7, device="cpu"), dev)
        eng = ServeEngine(cfg, pol, params, max_slots=slots,
                          max_len=len(pa) + max_new,
                          options=EngineOptions(n_pages=n_pages), device=dev)
        seen, sample = [], eng._sample

        def spy(logits):                 # every chunk's and step's logits
            seen.append(logits.cpu())
            return sample(logits)
        eng._sample = spy
        for p in prompts:
            eng.submit(p, max_new=max_new)
        eng.run()
        return eng, seen

    logits = {}
    for dev in ("cuda", "cpu"):
        eng, seen = run(dev, [pa, pb, shared], 2, 6)
        st = eng.stats()
        if not (st["page_cache_hits"] > 0 and st["page_cow_forks"] > 0):
            raise SystemExit("paged parity run shared no page")
        logits[dev] = torch.cat(seen)
    if logits["cuda"].shape != logits["cpu"].shape:
        raise SystemExit("paged parity: the card and the CPU took "
                         "different schedules")
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    log(f"paged smoke parity card vs cpu: logits "
        f"{tuple(logits['cpu'].shape)} max_abs_err {err:.3e}")
    if not (torch.isfinite(logits["cuda"]).all() and err < TOL):
        raise SystemExit("the paged port on the card disagrees with the CPU")
    tight = {}
    for dev in ("cuda", "cpu"):
        eng, _ = run(dev, [pa, pb], 2, 20, n_pages=5)
        tight[dev] = ([s.value for s in eng.statuses.values()],
                      eng.stats()["preemptions"])
    log(f"paged tight arena (4 pages): card {tight['cuda']} cpu "
        f"{tight['cpu']}")
    if tight["cuda"] != tight["cpu"] or tight["cuda"][1] < 1:
        raise SystemExit("the tight-arena run differs between the card and "
                         "the CPU, or did not preempt")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _check_served(eng, n_layers, max_new, decode_kernel, prefill_kernel):
    """All requests OK with ``max_new`` in-vocabulary tokens; the run's
    decode kernel launched once per layer per decode step, its prefill
    kernel (None: whole-prompt) once per layer per chunk, and no other
    attention kernel at all."""
    from repro_torch.kernels.attn import ops
    st = eng.stats()
    statuses = [s.value for s in eng.statuses.values()]
    lens = [r.size for r in eng.results.values()]
    launches = dict(ops.LAUNCHES)
    log(f"statuses {statuses} tokens {lens} launches {launches}")
    log(f"decode_steps {st['decode_steps']} prefill_chunks "
        f"{st['prefill_chunks']} tok/s {st['tok_per_s']:.2f} "
        f"ttft_mean_s {st['ttft_mean_s']:.3f} ttft_max_s "
        f"{st['ttft_max_s']:.3f} wall_s {st['wall_s']:.2f}")
    if any(train_launches().values()):
        raise SystemExit(f"serving launched a training kernel: "
                         f"{train_launches()}")
    vocab = eng.cfg.vocab_size
    want = {name: 0 for name in launches}
    want[decode_kernel] = n_layers * st["decode_steps"]
    if prefill_kernel is not None:
        want[prefill_kernel] = n_layers * st["prefill_chunks"]
    ok = (all(s == "ok" for s in statuses)
          and all(n == max_new for n in lens)
          and all(((r >= 0) & (r < vocab)).all()
                  for r in eng.results.values())
          and launches == want and launches[decode_kernel] > 0
          and (prefill_kernel is None or launches[prefill_kernel] > 0))
    if not ok:
        raise SystemExit(f"serving run failed its checks (launches "
                         f"{launches}, expected {want})")
    return st, launches


def phase_serve():
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    eng = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st, launches = _check_served(eng, eng.cfg.num_layers, 16,
                                 "flash_decode", "flash_prefill")
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: {wall:.1f}s including weight init; peak memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated)")
    return eng, st, launches, peak


def paged_prompts(vocab: int):
    """The paged run's six prompts: three that share one 256-token prefix
    (4 pages) followed by 64, 128 and 192 tokens of their own, one of 200
    tokens (a partial tail page), and two identical 256-token prompts
    (the second maps all four pages and, its last row capped out of the
    match, forks the fourth copy-on-write)."""
    from repro_torch.launch.serve import prompt
    prefix = prompt(100, 256, vocab)
    own = [np.concatenate([prefix, prompt(101 + i, n, vocab)])
           for i, n in enumerate((64, 128, 192))]
    twin = prompt(110, 256, vocab)
    return own + [prompt(104, 200, vocab), twin, twin.copy()]


def paged_expected(prompts, max_new: int, P: int):
    """(prefill chunks, pages allocated, prefix page hits, forks) that the
    allocator's arithmetic gives for :func:`paged_prompts` served in
    order with a full-residency arena: each request maps the registered
    pages of its longest page-aligned prefix (capped at ``L - 1``
    tokens), prefills the rest in P-token chunks, allocates a page for
    every block it writes that it does not map, and forks a shared page
    it writes into.  Its decode writes rows ``L .. L + max_new - 2``."""
    import hashlib
    index, chunks, pages, hits, forks = set(), 0, 0, 0, 0
    for toks in prompts:
        L = len(toks)
        h, matched = hashlib.sha1(), 0
        for i in range(L // P):
            h.update(np.asarray(toks[i * P:(i + 1) * P], np.int64).tobytes())
            if h.hexdigest() not in index:
                break
            matched += 1
        shared = min(matched * P, L - 1)
        hits += matched
        chunks += -(-(L - shared) // P)
        last = (L + max_new - 2) // P              # last block written
        pages += last + 1 - matched                # fresh blocks
        if shared < matched * P:                   # writes a shared page
            pages, forks = pages + 1, forks + 1
        h = hashlib.sha1()
        for i in range(L // P):
            h.update(np.asarray(toks[i * P:(i + 1) * P], np.int64).tobytes())
            index.add(h.hexdigest())
    return chunks, pages, hits, forks


def serve_paged(cfg, params, device, max_new: int = 16, P: int = PAGE):
    """The paged main path: 4 slots, DFXP-10, int8 pages, fused decode,
    P = C, the :func:`paged_prompts` requests.  Returns the drained
    engine."""
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.serve import EngineOptions, ServeEngine
    prompts = paged_prompts(cfg.vocab_size)
    pol = PrecisionPolicy("dfxp", fused_decode=True, page_size=P)
    eng = ServeEngine(cfg, pol, params, max_slots=4,
                      max_len=max(map(len, prompts)) + max_new,
                      options=EngineOptions(cache_bits=8), device=device)
    for p in prompts:
        eng.submit(p, max_new=max_new)
    eng.run()
    return eng


def phase_paged(eng):
    """The paged main path at full width on the serving run's weights."""
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    peng = serve_paged(eng.cfg, eng.params, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st, launches = _check_served(peng, eng.cfg.num_layers, 16,
                                 "flash_decode_paged", "flash_prefill_paged")
    chunks, pages, hits, forks = paged_expected(
        paged_prompts(eng.cfg.vocab_size), 16, PAGE)
    counters = {k: st[k] for k in ("prefill_chunks", "pages_allocated",
                                   "page_cache_hits", "page_cow_forks",
                                   "pages_in_use_peak", "pages_registered",
                                   "page_evictions", "preemptions")}
    peak = torch.cuda.max_memory_allocated()
    log(f"paged path: {wall:.1f}s; counters {counters}; expected chunks "
        f"{chunks} pages {pages} hits {hits} forks {forks}; arena "
        f"{peng.kv.total_pages} pages x {peng.kv.nblocks} blocks; peak "
        f"memory {peak / 1e9:.2f} GB (max_memory_allocated)")
    if (st["prefill_chunks"], st["pages_allocated"], st["page_cache_hits"],
            st["page_cow_forks"]) != (chunks, pages, hits, forks) \
            or not hits > 0 or not forks >= 1:
        raise SystemExit("the paged run's page counters disagree with the "
                         "allocator's arithmetic")
    return peng, st, launches, peak


def phase_whole_prompt(eng):
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.launch.serve import prompt
    from repro_torch.serve import EngineOptions, ServeEngine
    pol = PrecisionPolicy("dfxp", fused_decode=True)
    whole = ServeEngine(eng.cfg, pol, eng.params, max_slots=4, max_len=208,
                        options=EngineOptions(cache_bits=8, prefill_chunk=0),
                        device="cuda")
    for i, n in enumerate((96, 96, 200, 200)):
        whole.submit(prompt(i, n, eng.cfg.vocab_size), max_new=8)
    reset_all_launches()
    whole.run()
    torch.cuda.synchronize()
    st, launches = _check_served(whole, eng.cfg.num_layers, 8,
                                 "flash_decode", None)
    return st, launches


def _kind(name: str) -> str:
    for kernel, label in (("flash_decode_kernel", "flash_decode (K3)"),
                          ("flash_prefill_kernel", "flash_prefill (K4)"),
                          ("flash_decode_paged_kernel",
                           "flash_decode_paged (K5)"),
                          ("flash_prefill_paged_kernel",
                           "flash_prefill_paged (K6)"),
                          ("dfxp_quantize_kernel", "dfxp_quantize (K1)"),
                          ("qmm_kernel", "qmatmul (K2)")):
        if kernel in name:
            return label
    if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "gemv")):
        return "matmul"
    return "elementwise/reduction"


def _profile(name, fn):
    """Device time of one call of ``fn`` by kind, from ``torch.profiler``;
    device idle share = 1 - device time / host wall time of the call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):        # some sessions record no device activity
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        by_kind, total = {}, 0.0
        for evt in prof.key_averages():
            if not _on_device(evt):
                continue           # host-side ops; their kernels count below
            us = _device_time_us(evt)
            if us <= 0:
                continue
            total += us
            k = _kind(evt.key)
            by_kind[k] = by_kind.get(k, 0.0) + us / 1e3
        if total > 0:
            break
    row = {"wall_ms": wall, "device_ms": total / 1e3,
           "device_ms_by_kind": by_kind}
    if total > 0:
        row["device_idle_share"] = 1.0 - total / 1e3 / wall
    else:
        row["device_ms"] = "not measured (no device time in the trace)"
    log(f"profile {name}: {json.dumps(row)}")
    return row


def phase_profile(eng, peng):
    """Where one decode step (4 slots at position 300) and one prefill
    chunk spend device time at full width, slot-major (``eng``, C=128 at
    p0=128) and paged (``peng``, C=64 at p0=128 over mapped pages)."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import paged
    cfg, pol, params = eng.cfg, eng.policy, eng.params
    B = eng.max_slots
    dev = torch.device("cuda")
    tok = torch.zeros(B, dtype=torch.int32, device=dev)
    pos = torch.full((B,), 300, dtype=torch.int32, device=dev)

    def steps(e, C):
        toks = torch.zeros((1, C), dtype=torch.int32, device=dev)
        one = paged.slice_slot(e.kv.pool, 0)

        def decode():
            T.decode_step(cfg, e.policy, params, e.kv.pool, tok, pos,
                          e.exps, kv_codec=e.codec)

        def chunk():
            T.prefill_chunk_step(
                cfg, e.policy, params, one, toks,
                torch.tensor([128], dtype=torch.int32, device=dev),
                torch.tensor([C], dtype=torch.int32, device=dev), e.exps,
                kv_codec=e.codec)
        return decode, chunk

    # the drained paged engine's arena: every slot maps 8 private pages
    # with rows 0..299 live, so both steps attend real history
    nb = peng.kv.nblocks
    for slot in range(B):
        row = 1 + slot * nb + np.arange(nb)
        paged.reset_slot(peng.kv.pool, slot, 300, row, 300.0)
    out = {}
    for tag, e, C in (("", eng, 128), ("paged_", peng, PAGE)):
        decode, chunk = steps(e, C)
        out[f"{tag}decode_step"] = _profile(f"{tag}decode_step", decode)
        out[f"{tag}prefill_chunk"] = _profile(f"{tag}prefill_chunk", chunk)
    return out


# ---------------------------------------------------------------------------
# training slice: K1 (fused quantize) and K2 (quantized matmul)
# ---------------------------------------------------------------------------

def train_launches() -> dict:
    from repro_torch.kernels.dfxp import ops as k1
    from repro_torch.kernels.qmatmul import ops as k2
    return {"dfxp_quantize": k1.LAUNCHES["dfxp_quantize"],
            "qmatmul": k2.launches()}


def reset_all_launches() -> None:
    from repro_torch.kernels.attn import ops
    from repro_torch.kernels.dfxp import ops as k1
    from repro_torch.kernels.qmatmul import ops as k2
    for m in (ops, k1, k2):
        m.reset_launches()


def device_ops(fn) -> int:
    """Device operations (kernels, copies, memsets) that one call of
    ``fn`` puts on the stream, from ``torch.profiler``, after a warm-up
    call; a session that records no device activity is taken again, up
    to three times (0 if none records any)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    n = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages() if _on_device(e))
        if n > 0:
            break
    return n


def time_row(name, kernel, fn, plain, copies, cost, library=None,
             extra=None, info=None):
    """A timing row on ``copies`` (a ring of inputs larger than the 50 MB
    L2, or one input larger than it).  ``ms`` / ``plain_ms`` /
    ``library_ms`` (and ``extra``'s keys): device time per call from the
    profiler (or CUDA events where ``timers`` says so), of the kernel
    named ``kernel`` for ``ms`` and of every device operation of the call
    for the others; ``*_call_ms``:
    CUDA-event time per call in a loop, host gaps included; ``bound_ms``
    from this case's bytes and operations (at ``cost``'s third item, a
    rate in flop/s, where it gives one; else float32's); ``info``: more
    keys printed with the row."""
    from repro_torch.kernels.attn import cases
    nbytes, flops, *rate = cost(copies[0])
    bound, bound_by = cases.bound_ms(nbytes, flops, *rate)
    timers = {}
    row = dict(bound_ms=bound, bound_by=bound_by, bytes=nbytes, flops=flops,
               timers=timers, **(info or {}))
    row["ms"], timers["ms"] = device_ms(rotating(fn, copies), kernel)
    row["call_ms"] = cuda_ms(rotating(fn, copies))
    row["plain_ms"], timers["plain_ms"] = device_ms(rotating(plain, copies))
    row["plain_call_ms"] = cuda_ms(rotating(plain, copies), 10)
    if library is not None:
        row["library_ms"], timers["library_ms"] = device_ms(
            rotating(library, copies))
    for key, f in (extra or {}).items():
        row[key], timers[key] = device_ms(rotating(f, copies))
    log(f"{name}: {json.dumps(row)}")
    return row


def phase_train_kernels():
    """K1 bit-exact and K2 within tolerance against their plain versions
    on card tensors; timings and bounds at the main path's shapes and at
    llama3-8B's."""
    from repro_torch.core.quant import fixed_round
    from repro_torch.kernels.dfxp import cases as qc
    from repro_torch.kernels.dfxp import ops as k1
    from repro_torch.kernels.attn.cases import H100_TF32_FLOPS
    from repro_torch.kernels.dfxp.ref import dfxp_quantize_ref
    from repro_torch.kernels.qmatmul import cases as mc
    from repro_torch.kernels.qmatmul import ops as k2
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref, round_operand
    dev = torch.device("cuda")

    def k1_call(a):
        return k1.dfxp_quantize(a["x"], a["e"], width=a["width"])

    def k1_plain(a):
        return dfxp_quantize_ref(a["x"], a["e"], width=a["width"])

    def k1_eager(a):
        return fixed_round(a["x"], a["width"], a["e"])

    def k1_library(a):
        # one PyTorch call of the same rounding (no overflow counts)
        q = 2 ** (a["width"] - 1)
        return torch.fake_quantize_per_tensor_affine(
            a["x"], 2.0 ** a["e"], 0, -q, q - 1)

    k1_cases = {
        "64x1200 f32 (maxout pre-activation site)": dict(shape=(64, 1200)),
        "784x1200 f32 (maxout fc0 weight)": dict(shape=(784, 1200), e=-11.0,
                                                 scale=0.05),
        "1000003 f32 (ragged tail)": dict(shape=(1000003,)),
        "64x1200 f16": dict(shape=(64, 1200), dtype=torch.float16, e=-3.0,
                            scale=10.0),
        "64x1200 bf16": dict(shape=(64, 1200), dtype=torch.bfloat16, e=-3.0,
                             scale=10.0),
        "17x31 NaN, +-inf, ties": dict(shape=(17, 31), e=-2.0,
                                       specials=True),
        "32x130 e=-30": dict(shape=(32, 130), e=-30.0, scale=2.0 ** -22),
        "32x130 e=+30": dict(shape=(32, 130), e=30.0, scale=2.0 ** 38),
        "4096x14336 f32 (llama3-8B w_up)": dict(shape=(4096, 14336), e=-12.0,
                                                scale=0.02),
        "1000003 f32 view at offset 1": dict(shape=(1000004,), offset=1),
        "4099 f32 view at offset 2": dict(shape=(4101,), offset=2),
        "8197 f32 view at offset 3": dict(shape=(8200,), offset=3),
        "76805 f16 (8 a vector, tail 5)": dict(shape=(76805,),
                                               dtype=torch.float16, e=-3.0,
                                               scale=10.0),
        "76805 bf16 view at offset 3": dict(shape=(76808,), offset=3,
                                            dtype=torch.bfloat16, e=-3.0,
                                            scale=10.0),
    }
    k1_bad = 0
    for i, (tag, kw) in enumerate(k1_cases.items()):
        shape, off = kw.pop("shape"), kw.pop("offset", 0)
        a = qc.quantize_case(shape, seed=i, device=dev, **kw)
        a["x"] = a["x"][off:]
        y, st = k1_call(a)
        yr, sr = k1_plain(a)
        torch.cuda.synchronize()
        nan = torch.isnan(yr)
        ok = (torch.equal(torch.isnan(y), nan)
              and torch.equal(y[~nan], yr[~nan]) and torch.equal(st, sr))
        log(f"K1 {tag}: counts {st.tolist()} plain {sr.tolist()} "
            f"bit-exact {ok}")
        k1_bad += not ok
    if k1_bad:
        raise SystemExit("K1 disagrees with its plain version")

    k1_rows = {}
    for tag, shape, kw, n in (
            ("maxout_w_fc0", (784, 1200), dict(e=-11.0, scale=0.05), 24),
            ("maxout_pre", (64, 1200), dict(), 24),
            ("llama3_8b_w_up", (4096, 14336), dict(e=-12.0, scale=0.02), 2)):
        copies = [qc.quantize_case(shape, seed=s, device=dev, **kw)
                  for s in range(n)]
        k1_rows[tag] = time_row(
            f"K1 {tag} {shape} timing", "dfxp_quantize_kernel", k1_call,
            k1_plain, copies, qc.quantize_cost, k1_library,
            extra={"eager_fixed_round_ms": k1_eager,
                   "call_device_ms": k1_call},
            info={"device_ops_per_call": device_ops(
                lambda: k1_call(copies[0]))})
        n_ops = k1_rows[tag]["device_ops_per_call"]
        if n_ops > 2:
            raise SystemExit(f"K1 {tag}: one call put {n_ops} operations "
                             f"on the device")
        if n_ops == 0:
            k1_rows[tag]["device_ops_per_call"] = \
                "not measured (no device activity in the trace)"
        del copies

    errs = []

    def k2_check(tag, a):
        n = k2.launches()
        out = k2.qmm(a["a"], a["b"], a["e_a"], a["e_b"], kind=a["kind"],
                     width_a=a["width_a"], width_b=a["width_b"])
        want = qmatmul_ref(a["a"], a["b"], a["e_a"], a["e_b"],
                           kind=a["kind"], width_a=a["width_a"],
                           width_b=a["width_b"])
        torch.cuda.synchronize()
        _, _, D = k2.shapes(a["kind"], a["a"].shape, a["b"].shape)
        tol = mc.tolerance(D)
        err = float((out - want).abs().max())
        bad = not (torch.allclose(out, want, **tol) and k2.launches() == n + 1)
        log(f"K2 {tag}: max_abs_err {err:.3e} (atol {tol['atol']:.2e}, "
            f"rtol {tol['rtol']})" + ("  FAIL" if bad else ""))
        if bad:
            raise SystemExit(f"K2 {tag} disagrees with its plain version")
        errs.append(err)

    for kind in ("nn", "nt", "tn"):
        for wa, wb in ((10, 10), (None, 10), (10, None), (None, None),
                       (13, 16), (24, None)):
            e = (0.0 if wa is None else 3.0 - wa,
                 0.0 if wb is None else 3.0 - wb)
            k2_check(f"{kind} widths=({wa},{wb}) 100x130x70",
                     mc.qmm_case(kind, 100, 130, 70, width_a=wa, width_b=wb,
                                 e_a=e[0], e_b=e[1], seed=3, device=dev))
        # widths past 24 (the paper's Fig. 3 computes at 31): one operand
        # at the step 2^(3 - w), the other clipped (step 2^-28)
        for w in (25, 31, 32):
            k2_check(f"{kind} widths=({w},{w}) e=({3 - w},-28) 100x130x70",
                     mc.qmm_case(kind, 100, 130, 70, width_a=w, width_b=w,
                                 e_a=3.0 - w, e_b=-28.0, seed=3,
                                 device=dev))
    maxout = {"fwd nn [64,784]x[784,1200]": ("nn", 64, 1200, 784),
              "dgrad nt [64,1200]x[240,1200]^T": ("nt", 64, 240, 1200),
              "wgrad tn [64,784]^Tx[64,1200]": ("tn", 784, 1200, 64),
              "ragged nn [33,65]x[65,7]": ("nn", 33, 7, 65)}
    for tag, (kind, R, C, D) in maxout.items():
        wb = None if kind == "tn" else 10         # wgrad rounds nothing
        k2_check(tag, mc.qmm_case(kind, R, C, D, width_b=wb, seed=4,
                                  device=dev))
    k2_check("llama3-8B chunk nn [128,4096]x[4096,14336]",
             mc.qmm_case("nn", 128, 14336, 4096, seed=5, device=dev))
    # the rounded operands are the plain version's, bit for bit: a width-8
    # product of on-grid values is exact in any order
    a = mc.qmm_case("nn", 96, 80, 64, width_a=8, width_b=8, seed=6,
                    device=dev)
    ex = k2.qmm(a["a"] * 0.125, a["b"] * 0.125, -10.0, -10.0, kind="nn",
                width_a=8, width_b=8)
    want = (round_operand(a["a"] * 0.125, -10.0, 8)
            @ round_operand(a["b"] * 0.125, -10.0, 8))
    if not torch.equal(ex, want):
        raise SystemExit("K2's rounded operands differ from the plain "
                         "version's")
    log("K2 on-grid width-8 product: bit-exact True")
    # split-K sums its partials in split order: the same bits twice
    for kind, R, C, D in (("nn", 64, 1200, 784), ("nt", 64, 240, 1200)):
        a = mc.qmm_case(kind, R, C, D, seed=7, device=dev)
        outs = [k2.qmm(a["a"], a["b"], a["e_a"], a["e_b"], kind=kind,
                       width_a=None, width_b=10) for _ in range(2)]
        if not torch.equal(*outs):
            raise SystemExit(f"K2 {kind} [{R},{C}] D={D}: two calls differ")
        log(f"K2 {kind} [{R},{C}] D={D} plan {k2.plan(R, C, D)}: two calls "
            f"bit-identical")

    def k2_call(a):
        return k2.qmm(a["a"], a["b"], a["e_a"], a["e_b"], kind=a["kind"],
                      width_a=a["width_a"], width_b=a["width_b"])

    def k2_plain(a):
        return qmatmul_ref(a["a"], a["b"], a["e_a"], a["e_b"],
                           kind=a["kind"], width_a=a["width_a"],
                           width_b=a["width_b"])

    def k2_library(a):
        # torch.matmul on the operands rounded outside the timed call
        if "_q" not in a:
            a["_q"] = (round_operand(a["a"], a["e_a"], a["width_a"]),
                       round_operand(a["b"], a["e_b"], a["width_b"]))
        qa, qb = a["_q"]
        if a["kind"] == "nt":
            qb = qb.t()
        elif a["kind"] == "tn":
            qa = qa.t()
        return torch.matmul(qa, qb)

    k2_rows = {}
    for tag, (kind, R, C, D), n in (
            ("maxout_fwd_nn", ("nn", 64, 1200, 784), 24),
            ("maxout_dgrad_nt", ("nt", 64, 240, 1200), 24),
            ("maxout_wgrad_tn", ("tn", 784, 1200, 64), 24),
            ("llama3_8b_chunk_nn", ("nn", 128, 14336, 4096), 2)):
        wb = None if kind == "tn" else 10
        copies = [mc.qmm_case(kind, R, C, D, width_b=wb, seed=s, device=dev)
                  for s in range(n)]
        for c in copies:
            k2_library(c)             # round the yardstick's operands now
        bn, splits, per = k2.plan(R, C, D)
        k2_rows[tag] = time_row(
            f"K2 {tag} timing", "qmm_kernel", k2_call, k2_plain, copies,
            lambda a: (*mc.qmm_cost(a), H100_TF32_FLOPS), k2_library,
            info={"plan": {"bn": bn, "splits": splits, "per": per}}
            | {k: v for k, v in mc.qmm_bounds(copies[0]).items()
               if k.startswith("f32_") or k == "products"})
        del copies
    return {"dfxp_quantize": dict(rows=k1_rows, max_abs_err=0.0),
            "qmatmul": dict(rows=k2_rows, max_abs_err=max(errs))}


def site_launches(cfg, pol, B: int, backward: bool):
    """(K1, K2) launches of one forward (and backward) of the PI maxout
    under ``pol`` at batch ``B``, from the rounding sites' sizes: every
    weight site rounds once (its value, or under fused DFXP its
    statistics); every ``pre``/``act`` site rounds its value forward and
    its cotangent backward; K1 takes a site of at least ``MIN_SIZE``
    elements.  Under fused DFXP each dot is one K2 forward, one wgrad and
    — except the first layer, whose input needs no gradient — one dgrad."""
    if pol.arithmetic not in ("fixed", "dfxp"):
        return 0, 0
    dims = [cfg.input_dim] + list(cfg.hidden)
    layers = [(dims[i], cfg.pieces * h, h) for i, h in enumerate(cfg.hidden)]
    layers.append((dims[-1], cfg.num_classes, None))
    fused = pol.dynamic and pol.fused_matmul
    k1 = k2 = 0
    for i, (d_in, d_out, h) in enumerate(layers):
        k1 += d_in * d_out >= MIN_SIZE
        for n in [B * d_out] + ([B * h] if h else []):
            k1 += (n >= MIN_SIZE) * (1 + backward)
        if fused:
            k2 += 1 + backward * (1 + (i > 0))
    return k1, k2


def phase_train_parity():
    """Smoke-size DFXP maxout on the card (K1 from 4096 elements, K2)
    against the CPU (plain versions), from the same weights and
    calibrated exponents: 10 steps of DFXP-10/12, and 5 steps computing
    at width 31 (the paper's Fig. 3), whose K2 products run at width 31."""
    import dataclasses
    from repro_torch.core.quant import enable_pallas_quantize
    from repro_torch.examples import quickstart as qs
    from repro_torch.models import maxout as MX
    cfg = MX.MaxoutConfig(hidden=(48,), pieces=3)
    res = {}
    for tag, pol, steps in (
            ("dfxp 10/12", qs.dfxp_policy(fused_matmul=True), 10),
            ("dfxp 31/12", dataclasses.replace(
                qs.dfxp_policy(fused_matmul=True), comp_width=31), 5)):
        init = qs.calibrated_exps(cfg, pol, "cpu")
        out = {}
        enable_pallas_quantize(True, min_size=1 << 12)
        try:
            for dev in ("cuda", "cpu"):
                before = train_launches()
                r = qs.train(cfg, pol, dev, steps=steps,
                             init_exp={k: v.to(dev) for k, v in init.items()})
                exps = {k: float(v) for k, v in r["state"].scale.exps.items()}
                after = train_launches()
                out[dev] = (r["losses"], exps,
                            {k: after[k] - before[k] for k in after})
        finally:
            enable_pallas_quantize(False)
        lc, lp = np.array(out["cuda"][0]), np.array(out["cpu"][0])
        rel = np.abs(lc / lp - 1)
        log(f"train parity card vs cpu ({steps} {tag} steps, hidden=(48,) "
            f"x 3): max loss rel diff {rel.max():.3e}; exponents equal "
            f"{out['cuda'][1] == out['cpu'][1]}; card launches "
            f"{out['cuda'][2]}")
        if not (np.isfinite(lc).all() and rel.max() <= 1e-4
                and out["cuda"][1] == out["cpu"][1]
                and out["cuda"][2]["dfxp_quantize"] > 0
                and out["cuda"][2]["qmatmul"] > 0):
            raise SystemExit(f"training ({tag}) on the card disagrees with "
                             f"the CPU")
        res[tag] = {"max_loss_rel_diff": float(rel.max()),
                    "card_launches": out["cuda"][2]}
    return res


def _on_grid(state, width: int) -> bool:
    """Every ``p:`` leaf an integer multiple of its group's step, within
    the ``width``-bit range."""
    from repro_torch.train.state import leaves_with_path
    q = 2 ** (width - 1)
    for path, x in leaves_with_path(state.params):
        e = state.scale.exps["p:" + "/".join(path)]
        m = x / torch.ldexp(torch.ones_like(e), e.to(torch.int32))
        if not (torch.equal(m, torch.round(m)) and bool((m >= -q).all())
                and bool((m <= q - 1).all())):
            return False
    return True


def phase_train():
    """The training main path at full width: the quickstart's four rows."""
    from repro_torch.examples import quickstart as qs
    from repro_torch.models import maxout as MX
    reset_all_launches()
    t0 = time.perf_counter()
    res = qs.main(["--fused-matmul", "--kernel-quantize"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = train_launches()
    cfg, rows = res["cfg"], res["rows"]
    want = {"dfxp_quantize": 0, "qmatmul": 0}
    summary, ok = {}, True
    for (name, pol, _), r in zip(qs.rows(None, True), rows.values()):
        k1s, k2s = site_launches(cfg, pol, qs.BATCH, backward=True)
        k1e, k2e = site_launches(cfg, pol, 1024, backward=False)
        step_want = {"dfxp_quantize": qs.STEPS * k1s, "qmatmul": qs.STEPS * k2s}
        want["dfxp_quantize"] += step_want["dfxp_quantize"] + k1e
        want["qmatmul"] += step_want["qmatmul"] + k2e
        summary[name] = {"final_loss": r["loss"],
                         "last10_mean_loss": float(np.mean(r["losses"][-10:])),
                         "eval_acc": r["acc"],
                         "train_s": r["seconds"],
                         "ms_per_step": r["seconds"] / qs.STEPS * 1e3,
                         "train_launches": r["launches"],
                         "expected_train_launches": step_want,
                         "per_step": {"dfxp_quantize": k1s, "qmatmul": k2s}}
        ok &= r["launches"] == step_want and r["acc"] >= 0.99
        ok &= bool(np.isfinite(r["losses"]).all())
    d = rows["dfxp 10/12 (paper)"]
    moved = sum(float(d["state"].scale.exps[k]) != float(v)
                for k, v in res["init_exp"].items())

    def tail(name):                   # mean loss of the last 10 steps
        return float(np.mean(rows[name]["losses"][-10:]))

    ratio = d["loss"] / rows["float32 (baseline)"]["loss"]
    tail_ratio = tail("dfxp 10/12 (paper)") / tail("float32 (baseline)")
    beats_fixed = tail("dfxp 10/12 (paper)") < tail("fixed point 20/20")
    on_grid = _on_grid(d["state"], 12)
    log(f"train main path ({cfg.name}, hidden {cfg.hidden} x "
        f"{cfg.pieces}, batch {qs.BATCH}, {qs.STEPS} steps/row): "
        f"{wall:.1f}s; launches {launches} expected {want}; exponents moved "
        f"{moved}; dfxp/float32 final loss {ratio:.3f}, last-10 mean "
        f"{tail_ratio:.3f}; dfxp below fixed 20/20 {beats_fixed}; p: on "
        f"grid {on_grid}")
    log("train rows: " + json.dumps(summary))
    # The paper's claim, as this configuration lets it show: DFXP 10/12
    # trains below 20-bit fixed point (its Table 3 ordering) and near
    # float32.  Near, not within 3x: with dropout off float32 drives the
    # training loss to ~3e-4, below DFXP-10's rounding floor; the
    # reference's own run of this configuration on a CPU gives a last-10
    # mean ratio of 4.3 (final-batch 5.1), so the bound is 10x.
    if not (ok and launches == want and moved > 0 and tail_ratio <= 10.0
            and beats_fixed and on_grid):
        raise SystemExit("the training main path failed its checks")
    return {"rows": summary, "launches": launches, "wall_s": wall,
            "exponents_moved": moved, "dfxp_over_float32_final_loss": ratio,
            "dfxp_over_float32_last10_loss": tail_ratio}


def phase_conv():
    """20 DFXP conv-maxout steps at the conv defaults (K1 on, fused),
    calibrated, at ``quickstart.CONV_OPT``'s learning rate."""
    from repro_torch.core.quant import enable_pallas_quantize
    from repro_torch.examples import quickstart as qs
    cfg, pol = qs.CONV, qs.dfxp_policy(fused_matmul=True)
    reset_all_launches()
    enable_pallas_quantize(True)
    try:
        init = qs.calibrated_exps(cfg, pol, "cuda", opt=qs.CONV_OPT)
        r = qs.train(cfg, pol, "cuda", init_exp=init, steps=20, eval_n=256,
                     opt=qs.CONV_OPT)
    finally:
        enable_pallas_quantize(False)
    launches = train_launches()
    ls = np.array(r["losses"])
    log(f"conv maxout (channels {cfg.conv_channels} x {cfg.pieces}, "
        f"{cfg.conv_kernel}x{cfg.conv_kernel}, pool {cfg.pool}): losses "
        f"{np.round(ls, 4).tolist()}; launches {launches}; "
        f"{r['seconds']:.2f}s for 20 steps; eval acc {r['acc']:.3f}")
    if not (np.isfinite(ls).all() and ls[-5:].mean() < ls[:5].mean()
            and launches["dfxp_quantize"] > 0):
        raise SystemExit("the conv-maxout run failed its checks")
    return {"losses": ls.tolist(), "launches": launches,
            "ms_per_step": r["seconds"] / 20 * 1e3, "eval_acc": r["acc"]}


def phase_train_profile():
    """Device time of one full-width DFXP train step by kind, and of its
    forward+backward alone (the rest of the step is the gradient rounding,
    optimizer, storage rounding and controller)."""
    from repro_torch.core.quant import enable_pallas_quantize
    from repro_torch.examples import quickstart as qs
    from repro_torch.models import maxout as MX
    from repro_torch.optim.opt import sgd_init
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.step import loss_and_grads
    cfg = MX.MaxoutConfig()
    pol = qs.dfxp_policy(fused_matmul=True)
    gs = MX.group_shapes(cfg)
    params = MX.init_params(cfg, 7, "cuda")
    state = init_train_state(params, sgd_init(params), gs, pol, -6.0)

    def loss_fn(p, b, s, e):
        return MX.loss_fn(cfg, pol, p, b, e, s)

    step = make_train_step(loss_fn, gs, pol, qs.OPT)
    batch = next(qs.batches(qs.data_for(cfg), 1, "cuda"))
    sinks = {n: torch.zeros(3, device="cuda", requires_grad=True)
             for n in gs if n.startswith("g:")}

    def fwd_bwd():
        loss_and_grads(loss_fn, state.params, batch, sinks, state.scale.exps)

    enable_pallas_quantize(True)
    try:
        out = {"train_step": _profile("dfxp_train_step",
                                      lambda: step(state, batch)),
               "forward_backward": _profile("dfxp_forward_backward",
                                            fwd_bwd)}
    finally:
        enable_pallas_quantize(False)
    full, fb = out["train_step"]["device_ms"], out["forward_backward"][
        "device_ms"]
    if isinstance(full, float) and isinstance(fb, float):
        # gradient rounding, optimizer, storage rounding and controller
        out["after_backward_device_ms"] = full - fb
        log(f"profile: {full - fb:.4f} ms of the step's device time comes "
            f"after the backward (rounding, optimizer, controller)")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    t0 = time.perf_counter()
    phase_build()
    log(f"[{time.perf_counter() - t0:.0f}s] kernels built")
    kern = phase_kernels()
    kern.update(phase_train_kernels())
    log(f"[{time.perf_counter() - t0:.0f}s] kernels checked")
    phase_parity()
    phase_parity_paged()
    tpar = phase_train_parity()
    log(f"[{time.perf_counter() - t0:.0f}s] smoke parity checked")
    train = phase_train()
    log(f"[{time.perf_counter() - t0:.0f}s] training main path trained")
    conv = phase_conv()
    tprof = phase_train_profile()
    log(f"[{time.perf_counter() - t0:.0f}s] conv maxout trained, train step "
        f"profiled")
    eng, st, launches, peak = phase_serve()
    log(f"[{time.perf_counter() - t0:.0f}s] main path served")
    peng, pst, plaunches, ppeak = phase_paged(eng)
    log(f"[{time.perf_counter() - t0:.0f}s] paged path served")
    prof = phase_profile(eng, peng)
    log(f"[{time.perf_counter() - t0:.0f}s] steps profiled")
    wst, wlaunches = phase_whole_prompt(eng)
    log(f"[{time.perf_counter() - t0:.0f}s] whole-prompt path served")

    csrc = "src/repro_torch/kernels/attn/csrc/"
    srcs = {"flash_decode": ("src/repro/kernels/attn/attn_kernel.py:123",
                             launches),
            "flash_prefill": ("src/repro/kernels/attn/prefill_kernel.py:125",
                              launches),
            "flash_decode_paged": (
                "src/repro/kernels/attn/attn_kernel.py:248", plaunches),
            "flash_prefill_paged": (
                "src/repro/kernels/attn/prefill_kernel.py:281", plaunches)}
    rows = []
    for name, (replaces, main_launches) in srcs.items():
        k = kern[name]
        main_row = k["rows"]["int8"]           # the pool the main path runs
        rows.append({
            "name": name, "route": "cuda", "source": f"{csrc}{name}.cu",
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": k["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": k["rows"]["f32"].get("library_ms"),
            "library_note": "scaled_dot_product_attention on the f32 case "
                            "of the same shape and mask (paged: its pages "
                            "gathered first, outside the timed call)",
            "cases": k["rows"],
            "whole_prompt_launches": wlaunches[name]})
        for key in ("f32_bound_ms", "plan", "splits"):
            if key in main_row:
                rows[-1][key] = main_row[key]
    rows[2]["k5_vs_k3_max_abs_diff"] = \
        kern["flash_decode_paged"]["k5_vs_k3_max_abs_diff"]
    # each attention kernel's device time per call inside the profiled
    # serving step (one call per layer), beside its isolated rows
    n_layers = eng.cfg.num_layers
    for row, step, label in (
            (rows[0], "decode_step", "flash_decode (K3)"),
            (rows[1], "prefill_chunk", "flash_prefill (K4)"),
            (rows[2], "paged_decode_step", "flash_decode_paged (K5)"),
            (rows[3], "paged_prefill_chunk", "flash_prefill_paged (K6)")):
        ms = prof[step]["device_ms_by_kind"].get(label)
        row["in_step_ms_per_call"] = None if ms is None else ms / n_layers
        log(f"{row['name']}: in the {step} {row['in_step_ms_per_call']} ms "
            f"per call; isolated {row['ms']} (inputs past the L2)")
    for name, src, replaces, main_case, note in (
            ("dfxp_quantize", "src/repro_torch/kernels/dfxp/csrc/"
             "dfxp_quantize.cu", "src/repro/kernels/dfxp/dfxp_kernel.py:45",
             "maxout_w_fc0", "torch.fake_quantize_per_tensor_affine, the "
             "same rounding without the overflow counts"),
            ("qmatmul", "src/repro_torch/kernels/qmatmul/csrc/qmatmul.cu",
             "src/repro/kernels/qmatmul/qmatmul_kernel.py:78",
             "maxout_fwd_nn", "torch.matmul (TF32 off) on the operands "
             "rounded outside the timed call; bound_ms on the kernel's TF32 "
             "route, f32_bound_ms at the float32 SIMT rate")):
        k = kern[name]
        main_row = k["rows"][main_case]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": train["launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row.get("library_ms"), "library_note": note,
            "main_case": main_case, "cases": k["rows"]})
        for key in ("f32_bound_ms", "call_device_ms", "device_ops_per_call"):
            if key in main_row:
                rows[-1][key] = main_row[key]
    summary = {"peak_memory_bytes": peak, "tok_per_s": st["tok_per_s"],
               "ttft_mean_s": st["ttft_mean_s"], "decode_steps":
               st["decode_steps"], "prefill_chunks": st["prefill_chunks"],
               "whole_prompt_tok_per_s": wst["tok_per_s"],
               "paged": {k: pst[k] for k in (
                   "tok_per_s", "ttft_mean_s", "ttft_max_s", "wall_s",
                   "decode_steps", "prefill_chunks", "pages_allocated",
                   "page_cache_hits", "page_cow_forks",
                   "pages_in_use_peak")} | {"peak_memory_bytes": ppeak},
               "profile": prof}
    log("train: " + json.dumps({"parity": tpar, "main": train, "conv": conv,
                                "profile": tprof}))
    log("serve: " + json.dumps(summary))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
