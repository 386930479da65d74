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
   same model on the CPU (plain versions), slot-major for each of the
   eight token-in archs (17a) and paged for llama3 (engine logits with
   prefix sharing, and a tight arena that preempts);
5. the main path: ``repro_torch.launch.serve`` at full llama3-8B width
   and 4 of its 32 layers (``LLAMA_LAYERS``), DFXP-10, int8 pool, fused
   decode, chunked prefill (6 requests, 4 slots, 16 tokens each); every request must end OK and both kernels
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
    paper's full PI-MNIST width on the reference's recipe (weights from
    ``PRNGKey(7)``, dropout on; the four Table-3 rows, DFXP calibrated,
    150 steps each, fused matmul and kernel quantize on); K1 and K2 must
    launch exactly as often as the rounding sites and products give,
    every row must reach ``ACC_FLOOR`` eval accuracy (fixed 20/20 as
    its median over 8 init and dropout seed pairs), DFXP's loss must end
    below fixed 20/20's and within ``TABLE3_LAST10_BOUND`` of float32's (mean
    of the last 10 steps), its parameters on their grids, and an
    exponent must have moved; then a DFXP 10/12 row with stochastic
    storage rounding (finite, on grid, 0.99 accuracy, launches exact);
12. the paper's Figures 1-4 (``repro_torch.examples.precision_sweep``,
    DFXP rows through K1 and K2): each row's loss ratio to float32
    within ``SWEEP_BAND`` of the reference's (``REF_SWEEP``), and each
    DFXP row's final exponents within ``SWEEP_EXP_TOL`` of the
    reference's (``REF_SWEEP_EXPS``), a check that fails when held
    against a row of other widths (checked too); then 20 conv-maxout
    steps at the conv defaults;
13. one profiled full-width DFXP training step, dropout on and off;
14. the PRNG (while 2 builds: it runs no kernel): ``split``,
    ``fold_in``, bits, ``uniform``, ``bernoulli``, ``normal`` (16.8M
    draws), ``gumbel`` and ``categorical`` on the card equal the CPU's,
    and jax's constants;
15. sampled serving at full llama3-8B width (4 layers) over a stochastic int8 pool
    (top-k 40 at temperature 0.8), slot-major (C = 128) and paged
    (P = 64): every request OK with 16 tokens, K3-K6 launched as in the
    greedy runs, request 0 alone drawing what it drew in the batch, no
    prefix pages shared; and the device operations the PRNG adds to one
    decode step;
16. the trainer's main path: ``repro_torch.launch.train`` on the
    reference example's LM_100M at full width and depth (batch 16 x 128,
    DFXP 10/12 through K2 and K1, adamw, 2 calibration steps), 60 steps
    in this process and a float32 row of 20: every step ok, 62 groups,
    step 1 within ``LM_STEP1_TOL`` and step 20 within ``LM_STEP20_TOL``
    of the reference's losses (``REF_LM``), DFXP above float32, K1 and
    K2 launches = the sites' arithmetic; the same argv killed at cursor
    30 (137) and resumed in subprocesses, ending with the solo run's
    final loss and checkpoint bit for bit; a chaos run at full width
    (exit 0, a rollback, a tear, a bit flip); one profiled step, a
    checkpoint and a restore timed; the solo, killed and resumed runs
    write the §5 numerics timeline (``--numerics-log``): records every 20
    steps holding the states' exponents, controller moves, the killed and
    resumed runs' records equal to the solo run's, the resume still bit
    for bit; before it, three supervised steps of a tiny tied LM on the
    card against the CPU (exponents equal, losses within 1e-4);
17. the token-in families: (a) with 4, each of the eight smoke configs
    on the card (K3/K4 over an f32 pool) against the CPU, prefill
    (chunked where the family chunks) + 4 decode steps, within ``TOL``,
    gemma3-smoke past its window; after 16, K3 and K4 against their
    plain versions at the families' head shapes and gemma3's windows
    (wrapped rings, p0 > window), timed; (b) granite-moe-1b at full
    width and depth through ``launch.serve`` (DFXP-10, int8 pool, fused
    decode, 6 requests of 96/200/384 tokens, 4 slots; chunk 128 asked
    for, whole prompts run): every request OK, K3 once per layer per
    decode step, K4 never, request 0 alone = in the batch, float32
    decode logits = the full forward's within ``FAMILY_DECODE_TOL`` (a
    capacity that drops no token), a profiled decode step; (c) the
    trainer with no ``--arch`` (granite-moe-1b at full width, batch 8 x
    64, SGD) 20 steps under DFXP 10/12 and float32: every step ok, K1
    and K2 launches = the sites' arithmetic (``lm_site_launches``, MoE
    blocks included), at 2 layers steps 1 and 10 within ``GRANITE_TOL``
    of the reference launcher's (``REF_GRANITE``), two 5-step DFXP runs
    equal bit for bit, a profiled step; (d) mamba2-370m (48 layers) and
    zamba2-1.2b (38 layers) served whole-prompt, gemma3-27b at full
    width and 6 layers with 1100-1200-token prompts and chunk 128, its
    local rings wrapped and K3 and K4 called with a window: every request
    OK, K3/K4 launches = attention calls x steps, request 0 alone = in
    the batch, weight bytes, peak memory, tok/s and TTFT;
18. the two models the engine does not serve (token-in decoders only):
    (a) with 4, seamless-smoke (24 source frames) and qwen2vl-smoke
    (embeds, M-RoPE positions with an image span) prefilled and decoded
    4 steps through K3 on their f32 rings, card against CPU within
    ``TOL``; (b) K1, K2 and K3 against their plain versions at these
    models' shapes (seamless's 256256-row table and [512, 256256] logits,
    qwen2-vl's 8192 x 152064 head; K2 on seamless's head at N = 256256
    in all three layouts and its cross-attention's wk; K3 at K=16, G=1
    and K=8, G=8), timed beside their bounds and library calls;
    (c) seamless-m4t-medium at full width and depth trained through
    ``make_train_step`` (DFXP 10/12 with 5 calibration steps, fused
    matmul and K1, then float32; batch 8 x 64 over 96 source frames, 10
    steps each): 151 groups, K1 and K2 launches = the sites' arithmetic,
    peak memory; its float32 weights prefilled (4 prompts of 64 tokens)
    and decoded 16 greedy steps through K3 (12 calls a step) within
    ``FAMILY_DECODE_TOL`` of the full forward; the same recipe at 1 + 1
    layers within ``SEAMLESS_TOL`` of the reference's losses at steps 1
    and 10 (``REF_SEAMLESS``); (d) qwen2-vl-72b at full width and 2 of
    its 80 layers: 4 prompts of 96 embeds with a 1x8x8 image span
    prefilled and decoded 16 steps on embeds through K3 (2 calls a step)
    within ``FAMILY_DECODE_TOL`` of its M-RoPE forward; its training at
    the smoke config, 3 DFXP steps card against CPU (a full-width layer's
    training state does not fit the card);
19. the serve engine's robustness layer on the serving run's llama3
    weights (no new weights): (a) a NaN in one request's logits and a
    bit flipped in another's private page of the paged engine (K5, K6):
    the NaN victim ``FAILED`` with its clean prefix, every untouched
    request equal to phase 6's tokens; then, on the weights' first
    ``ROBUST_LAYERS`` layers, (b) a seeded chaos plan with a page
    squeeze on a short arena: drains, every request terminal, a
    preemption, the fault log JSON; (c) a queue cap (4 of 6 submits
    ``REJECTED``), a deadline of 0 (all ``TIMED_OUT``) and a runaway
    threshold of -1 (all ``FAILED``) on the slot-major engine (K3, K4);
    (d) a tracer and a numerics log on it: ``validate_trace``, a
    ``decode_step`` span per decode step, records on the cadence with
    the pool's exponents; (e) one decode step's device operations bare
    (= its model step and sampler tail) and with a harness and a runaway
    threshold; (f) the serve CLI's ``--chaos 0`` demo with every output
    file parsed;
20. the distributed layer (``repro_torch.dist``, ``launch/mesh.py``):
    after 3, K3-K6 as a rank of a TP = 2 mesh calls them (4 of llama3's
    8 kv heads, int8) against their plain versions, timed; then, in a
    world of two gloo ranks on the card (the weights passed by CUDA
    IPC): TP = 2 over the slot-major and the paged pool (K3-K6) and CP =
    2 over a 2048-slot window on the serving weights' first
    ``SHARD_LAYERS`` layers, granite-moe-1b expert-parallel (12 of its
    24 layers) with plain and int8 ``all_to_all``: each rank's tokens,
    kv heads, window and launches held to an unsharded engine's; LM_100M
    trained with ``--grad-compress-bits 8`` (K1 a step = the uncompressed
    step's + one per leaf of at least ``MIN_SIZE`` elements; a kill at 5
    and a bit-exact resume, the residuals included); the serve CLI's
    ``--smoke --tp 2`` spawning its own world (started after 15, it runs
    beside the robustness and sharded phases), its tokens = the run
    without ``--tp``;
21. the multi-pod dry run (``repro_torch.launch.dryrun``, the meta
    device): one cell of each kind (granite-moe-1b ``train_4k``,
    seamless ``prefill_32k``, llama3-8B ``decode_32k``, zamba2
    ``long_500k``) on the 16x16 and 2x16x16 meshes, in a subprocess
    started after 2 that must create no CUDA context: every record
    ``ok``, its per-device bytes printed against the card's memory; then
    here, with ``memory_allocated`` unchanged across them, the cells of
    17(c)'s granite run (8 x 64, SGD, 1x1) and 16's LM_100M run (16 x
    128, adamw): each state's ``argument_bytes`` = the bytes of the state
    the card held, exactly; the predicted peak (arguments + temp) and
    its split printed beside the measured one.

The ``kernels`` JSON gives each attention kernel's device time per call
inside the profiled serving step (``in_step_ms_per_call``) beside its
isolated rows.  The line before the last is the ``kernels`` JSON; the
last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the rest
of the repository, it exits non-zero and prints no result.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TOL = 1e-4                      # kernel vs plain, outputs of size O(1..16)
K6_TOL = 1e-5                   # K6 on K4's TF32 route vs plain (atol, rtol)
# llama3-8B at full width and 4 of its 32 layers (registered as
# "llama3_8b_l4" by phase_serve): the cut keeps the whole run, with the
# token-in families', the robustness layer's and the sharded phases,
# inside its time limit on the slower H100 hosts (at 16 layers the script
# took 1173 s of its 1200 on one, 962 s on another; at 12, 871 s; at 8
# with the sharded phases, 1041 s)
LLAMA_LAYERS = 4
SERVE_ARGS = ["--arch", f"llama3_8b_l{LLAMA_LAYERS}", "--num-requests", "6", "--slots", "4",
              "--prompt-len", "96,200,384", "--max-new", "16",
              "--cache-bits", "8", "--fused-decode", "--prefill-chunk",
              "128"]
PAGE = 64                       # the paged run's page size and chunk
MIN_SIZE = 1 << 14              # enable_pallas_quantize's threshold (K1)
# DFXP/float32 ratio of the last-10 mean training loss on the
# quickstart's recipe at full PI width.  The reference's own run with
# dropout on (jax 0.9.0 on a CPU, `tools/reference_table3.py --full`)
# gives 0.00987 / 0.00076 = 13.0 (final batch 0.78): one loss spike in
# DFXP's last ten steps, where both losses are below 1e-2.  A bound set
# from that run would be looser than the 10x that held with dropout off,
# so the bound stays 10x.
TABLE3_LAST10_BOUND = 10.0
# Eval accuracy floor of the Table-3 rows.  Fixed 20/20 is held to it as
# its median over `quickstart.SEED_PAIRS` (init and dropout seeds): that
# row stores on the reference's 2^-8 `p:` grid (ROADMAP.md §3), where a
# flipped rounding tie moves a parameter by a whole grid step, and its
# accuracy at one seed pair is a draw from a wide spread in the
# reference too: over the same 8 pairs on a CPU it is 0.3613-1.0000,
# 3 below 0.99, median 0.9951 (`tests/test_torch_table3_seeds.py`).
ACC_FLOOR = 0.99
# The reference's final loss / float32's for each row of Figures 1-4 on
# `benchmarks/_common.py`'s harness (jax 0.9.0 on a CPU, `python -m
# benchmarks.run --only fig1,fig2,fig3,fig4`); the card's ratio for a row
# must lie within SWEEP_BAND times it.
REF_SWEEP = {
    "fig1/radix_1": 2.4878, "fig1/radix_3": 2.4111, "fig1/radix_5": 0.9360,
    "fig1/radix_7": 1.0479, "fig1/radix_9": 0.8687, "fig1/radix_12": 0.8825,
    "fig2/dfxp_comp_14": 0.9451, "fig2/dfxp_comp_12": 0.9861,
    "fig2/dfxp_comp_10": 0.9714, "fig2/dfxp_comp_8": 0.9269,
    "fig2/dfxp_comp_6": 1.3005, "fig2/fixed_comp_24": 0.8227,
    "fig2/fixed_comp_20": 0.8338, "fig2/fixed_comp_16": 0.9470,
    "fig3/dfxp_update_16": 0.8459, "fig3/dfxp_update_12": 0.9549,
    "fig3/dfxp_update_10": 1.0022, "fig3/dfxp_update_8": 0.7823,
    "fig3/fixed_update_20": 1.0185, "fig3/fixed_update_16": 1.0185,
    "fig4/rate_0.01_comp_8": 0.9365, "fig4/rate_0.01_comp_10": 1.0054,
    "fig4/rate_0.001_comp_8": 0.7532, "fig4/rate_0.001_comp_10": 0.9350,
    "fig4/rate_0.0001_comp_8": 0.9269, "fig4/rate_0.0001_comp_10": 0.9714,
}
SWEEP_BAND = (0.67, 1.5)
# The reference's final exponents of each DFXP row of Figures 2-4 on the
# same harness, by group (jax 0.9.0 on a CPU, `PYTHONPATH=src:. python
# tests/test_torch_sweep_reference.py`).  The port on a CPU ends within 1
# of them in every group (0-4 of a row's 22 groups differ), and the card
# is held to the same SWEEP_EXP_TOL; two rows whose widths differ, at
# one overflow rate, lie 2 or more apart in some group.
SWEEP_GROUPS = (
    "a:fc0/act", "a:fc0/pre", "a:out/act", "a:out/pre", "g:fc0/act",
    "g:fc0/pre", "g:out/act", "g:out/pre", "p:fc0/b", "p:fc0/w", "p:out/b",
    "p:out/w", "pg:fc0/b", "pg:fc0/w", "pg:out/b", "pg:out/w", "pm:fc0/b",
    "pm:fc0/w", "pm:out/b", "pm:out/w", "w:fc0/w", "w:out/w"
)
REF_SWEEP_EXPS = {name: dict(zip(SWEEP_GROUPS, map(float, exps)))
                  for name, exps in {
    "fig2/dfxp_comp_14": (
        -9, -9, 0, -8, -18, -19, -40, -19, -33, -32, -33, -30, -17,
        -16, -16, -13, -34, -33, -33, -30, -15, -14
    ),
    "fig2/dfxp_comp_12": (
        -7, -7, 0, -6, -16, -17, -40, -17, -33, -32, -33, -31, -15,
        -14, -14, -11, -34, -33, -33, -30, -13, -12
    ),
    "fig2/dfxp_comp_10": (
        -5, -5, 0, -4, -14, -15, -40, -15, -33, -32, -33, -30, -13,
        -12, -12, -9, -34, -33, -33, -30, -11, -9
    ),
    "fig2/dfxp_comp_8": (
        -3, -3, 0, -2, -13, -13, -40, -12, -33, -32, -33, -31, -11,
        -10, -10, -7, -34, -33, -33, -31, -9, -8
    ),
    "fig2/dfxp_comp_6": (
        -1, -1, 0, 0, -11, -11, -40, -10, -33, -32, -33, -31, -9,
        -8, -8, -5, -34, -33, -33, -30, -7, -6
    ),
    "fig3/dfxp_update_16": (
        -26, -26, 0, -25, -36, -36, -40, -36, -18, -17, -18, -16,
        -34, -33, -33, -30, -19, -18, -18, -15, -32, -31
    ),
    "fig3/dfxp_update_12": (
        -26, -26, 0, -25, -35, -36, -40, -36, -14, -13, -14, -11,
        -34, -33, -33, -30, -15, -14, -14, -11, -32, -31
    ),
    "fig3/dfxp_update_10": (
        -26, -26, 0, -25, -36, -36, -40, -36, -12, -11, -12, -10,
        -34, -33, -33, -31, -13, -12, -12, -10, -32, -31
    ),
    "fig3/dfxp_update_8": (
        -26, -26, 0, -25, -36, -36, -40, -36, -10, -9, -10, -8, -34,
        -33, -33, -30, -11, -10, -10, -7, -32, -31
    ),
    "fig4/rate_0.01_comp_8": (
        -4, -4, 0, -3, -14, -14, -40, -13, -33, -33, -33, -31, -12,
        -12, -10, -8, -35, -34, -34, -31, -10, -8
    ),
    "fig4/rate_0.01_comp_10": (
        -6, -6, 0, -5, -16, -16, -40, -15, -33, -33, -33, -31, -14,
        -14, -12, -10, -35, -34, -34, -31, -12, -10
    ),
    "fig4/rate_0.001_comp_8": (
        -3, -3, 0, -2, -13, -13, -40, -13, -33, -33, -33, -31, -11,
        -11, -10, -8, -35, -34, -33, -31, -10, -8
    ),
    "fig4/rate_0.001_comp_10": (
        -5, -5, 0, -4, -15, -15, -40, -15, -33, -33, -33, -31, -13,
        -13, -12, -10, -34, -34, -33, -31, -12, -10
    ),
    "fig4/rate_0.0001_comp_8": (
        -3, -3, 0, -2, -13, -13, -40, -12, -33, -32, -33, -31, -11,
        -10, -10, -7, -34, -33, -33, -31, -9, -8
    ),
    "fig4/rate_0.0001_comp_10": (
        -5, -5, 0, -4, -14, -15, -40, -15, -33, -32, -33, -30, -13,
        -12, -12, -9, -34, -33, -33, -30, -11, -9
    ),
}.items()}
SWEEP_EXP_TOL = 1


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


def phase_build_and_prng() -> dict:
    """:func:`phase_build` in a thread (its ``nvcc`` processes) while
    :func:`phase_prng`, which runs no kernel of the repo, checks the
    PRNG here; a failed build fails the run after the check ends."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=1) as pool:
        built = pool.submit(phase_build)
        try:
            return phase_prng()
        finally:
            built.result()


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


def k3(a):
    """K3 (flash-decode) on a :func:`cases.decode_case`'s arguments."""
    from repro_torch.kernels.attn import ops
    return ops.flash_decode(a["q"], a["k"], a["v"], a["pos"], a["q_pos"],
                            a["k_exp"], a["v_exp"], width=a["width"],
                            scale=a["scale"], window=a["window"])


def k3_plain(a):
    from repro_torch.kernels.attn import ref
    return ref.decode_attention_ref(
        a["q"], a["k"], a["v"], a["pos"], a["q_pos"], k_exp=a["k_exp"],
        v_exp=a["v_exp"], width=a["width"], scale=a["scale"],
        window=a["window"])


def sdpa_decode(a):
    """K3's function in one library call on an f32 case: the boolean
    mask and the K/V layout built outside the timed call."""
    from repro_torch.kernels.attn import ref
    valid = ref.valid_mask(a["pos"], a["q_pos"], window=a["window"],
                           causal=True)[:, None, None, :]
    k, v = a["k"].permute(0, 2, 1, 3), a["v"].permute(0, 2, 1, 3)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        a["q"], k, v, attn_mask=valid, scale=a["scale"])


def sdpa_prefill(a):
    """K4's function in one library call on an f32 case: the history and
    the chunk's K/V concatenated and the joint (window) mask built
    outside the timed call."""
    from repro_torch.kernels.attn import cases
    Bq, Cq, K, G, HD = a["q"].shape
    vh, vs = cases.prefill_valid(a)
    mask = torch.cat([vh, vs], dim=-1)                     # [B, C, W+C]
    mask = mask.repeat_interleave(G, dim=1)[:, None]       # [B,1,CG,W+C]
    q = a["q"].permute(0, 2, 1, 3, 4).reshape(Bq, K, Cq * G, HD)
    kc = torch.cat([a["k"], a["k_new"]], 1).permute(0, 2, 1, 3)
    vc = torch.cat([a["v"], a["v_new"]], 1).permute(0, 2, 1, 3)
    kc, vc = kc.contiguous(), vc.contiguous()
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kc, vc, attn_mask=mask, scale=a["scale"])


def k4(a):
    """K4 (flash-prefill) on a :func:`cases.prefill_case`'s arguments."""
    from repro_torch.kernels.attn import ops
    return ops.flash_prefill(a["q"], a["k_new"], a["v_new"], a["k"], a["v"],
                             a["pos"], a["p0"], a["n_valid"], a["k_exp"],
                             a["v_exp"], width=a["width"], scale=a["scale"],
                             window=a["window"])


def k4_plain(a):
    from repro_torch.kernels.attn import ref
    return ref.prefill_attention_ref(
        a["q"], a["k"], a["v"], a["pos"], a["k_new"], a["v_new"], a["p0"],
        a["n_valid"], k_exp=a["k_exp"], v_exp=a["v_exp"], width=a["width"],
        scale=a["scale"], window=a["window"])


def phase_kernels():
    """K3-K6 against their plain versions; timings and bounds."""
    from repro_torch.kernels.attn import cases, ops, ref
    dev = torch.device("cuda")
    B, W, K, G, HD, C = 4, 400, 8, 4, 128, 128
    NBLK = 8                    # paged: 464-token max_len over 64-row pages

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


class _TPRank:
    """The ambient mesh of rank 0 of a 2-way TP serving mesh, for timing
    one rank's kernel calls in this process (no world: the kernels take
    no collective)."""

    shape = {"data": 1, "model": 2}

    @staticmethod
    def axis_index(axes) -> int:
        return 0


def phase_tp_kernels() -> dict:
    """K3-K6 as one rank of the TP = 2 serving runs calls them: the int8
    pool's 4 of llama3's 8 kv heads (the rank's slice), the queries of
    all 8 heads cut to the rank's inside the wrapper, the split plan of
    the whole 8.  Each against its plain version on the rank's slice,
    and timed at the main path's shapes (K3 B=4, W=400; K4 B=1, C=128,
    p0=256; K5 B=4, P=64, 8 blocks; K6 C=64, p0=384)."""
    from repro_torch.kernels.attn import cases, ops, ref
    from repro_torch.launch.mesh import use_mesh
    dev = torch.device("cuda")
    B, W, K, G, HD, C, NBLK = 4, 400, 4, 4, 128, 128, 8

    def tp(fn, make, **dims):
        """(case maker, call): each case also carries its queries (and
        chunk K/V) over all 8 heads, the rank's 0..3 the case's own,
        built outside the timed call; the call runs ``fn`` on them under
        rank 0's mesh."""
        def make_whole(seed):
            a = make(seed)
            a["whole"] = {n: torch.cat([a[n], torch.zeros_like(a[n])], d)
                          for n, d in dims.items()}
            return a

        def call(a):
            with use_mesh(_TPRank):
                return fn(dict(a, **a["whole"]))
        return make_whole, call

    def k5(a):
        return ops.flash_decode_paged(
            a["q"], a["k"], a["v"], a["bt"], a["pos"], a["q_pos"],
            a["k_exp"], a["v_exp"], width=8, scale=a["scale"],
            tp_axis="model")

    def k5_plain(a):
        return ref.paged_decode_attention_ref(
            a["q"], a["k"], a["v"], a["bt"], a["pos"], a["q_pos"],
            k_exp=a["k_exp"], v_exp=a["v_exp"], width=8, scale=a["scale"])

    def k6(a):
        return ops.flash_prefill_paged(
            a["q"], a["k_new"], a["v_new"], a["k"], a["v"], a["bt"],
            a["pos"], a["p0"], a["n_valid"], a["k_exp"], a["v_exp"],
            width=8, scale=a["scale"], tp_axis="model")

    def k6_plain(a):
        return ref.paged_prefill_attention_ref(
            a["q"], a["k"], a["v"], a["bt"], a["pos"], a["k_new"],
            a["v_new"], a["p0"], a["n_valid"], k_exp=a["k_exp"],
            v_exp=a["v_exp"], width=8, scale=a["scale"])

    def k3_tp(a):
        return ops.flash_decode(a["q"], a["k"], a["v"], a["pos"],
                                a["q_pos"], a["k_exp"], a["v_exp"], width=8,
                                scale=a["scale"], tp_axis="model")

    def k4_tp(a):
        return ops.flash_prefill(a["q"], a["k_new"], a["v_new"], a["k"],
                                 a["v"], a["pos"], a["p0"], a["n_valid"],
                                 a["k_exp"], a["v_exp"], width=8,
                                 scale=a["scale"], tp_axis="model")

    kinds = {
        "flash_decode": (
            "flash_decode_kernel", k3_plain, cases.decode_cost, TOL,
            tp(k3_tp, lambda s: cases.decode_case(B, W, K, G, HD, 8, seed=s,
                                                  device=dev), q=1)),
        "flash_prefill": (
            "flash_prefill_kernel", k4_plain, cases.prefill_route_cost, TOL,
            tp(k4_tp, lambda s: cases.prefill_case(
                1, C, W, K, G, HD, 8, p0=[256], n_valid=[C], seed=s,
                device=dev), q=2, k_new=2, v_new=2)),
        "flash_decode_paged": (
            "flash_decode_paged_kernel", k5_plain, cases.decode_paged_cost,
            TOL, tp(k5, lambda s: cases.decode_paged_case(
                B, PAGE, NBLK, K, G, HD, 8, fill=[320, 384, 448, 200],
                seed=s, device=dev), q=1)),
        "flash_prefill_paged": (
            "flash_prefill_paged_kernel", k6_plain,
            cases.prefill_paged_route_cost, K6_TOL,
            tp(k6, lambda s: cases.prefill_paged_case(
                1, PAGE, PAGE, NBLK, K, G, HD, 8, p0=[384], n_valid=[PAGE],
                seed=s, device=dev), q=2, k_new=2, v_new=2))}
    rows = {}
    for name, (kernel, plain, cost, tol, (make, fn)) in kinds.items():
        a = make(100)
        out, want = fn(a), plain(a)
        err = float((out - want).abs().max())
        if tuple(out.shape) != tuple(want.shape) or \
                not torch.allclose(out, want, atol=tol, rtol=tol):
            raise SystemExit(f"{name} on a TP rank's 4 kv heads disagrees "
                             f"with its plain version ({err})")
        rows[name] = time_row(
            f"{name} on a TP = 2 rank (4 of 8 kv heads, int8)", kernel, fn,
            plain, [make(s) for s in range(24)], cost,
            info={"max_abs_err": err, "kv_heads": K})
    return rows


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

        def spy(logits, **draw):         # every chunk's and step's logits
            seen.append(logits.cpu())
            return sample(logits, **draw)
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
    attention kernel at all (``n_layers``: the attention layers a step
    runs; none for an SSM)."""
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
          and launches == want
          and (launches[decode_kernel] > 0 or not n_layers)
          and (prefill_kernel is None or launches[prefill_kernel] > 0))
    if not ok:
        raise SystemExit(f"serving run failed its checks (launches "
                         f"{launches}, expected {want})")
    return st, launches


def phase_serve():
    """The serving main path; the weight init inside it (threefry draws in
    row blocks at llama3-8B width) timed with its own peak memory."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    inner, init = T.init_params, {}

    def timed_init(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        params = inner(*a, **kw)
        torch.cuda.synchronize()
        init.update(s=time.perf_counter() - t,
                    params_bytes=torch.cuda.memory_allocated() - base,
                    peak_bytes=torch.cuda.max_memory_allocated() - base)
        return params

    register_cut("llama3_8b", LLAMA_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    T.init_params = timed_init
    try:
        t0 = time.perf_counter()
        eng = serve.main(SERVE_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        T.init_params = inner
    st, launches = _check_served(eng, eng.cfg.num_layers, 16,
                                 "flash_decode", "flash_prefill")
    st["weight_init"] = init
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: {wall:.1f}s including weight init ({init['s']:.1f}s: "
        f"{init['params_bytes'] / 1e9:.2f} GB of weights, a peak of "
        f"{init['peak_bytes'] / 1e9:.2f} GB during the draw); peak memory "
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
    if "long" in name and "float" not in name:
        return "int64 elementwise/reduction"
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


def k1_call(a):
    """K1 (fused quantize) on a :func:`dfxp.cases.quantize_case`."""
    from repro_torch.kernels.dfxp import ops
    return ops.dfxp_quantize(a["x"], a["e"], width=a["width"])


def k1_plain(a):
    from repro_torch.kernels.dfxp.ref import dfxp_quantize_ref
    return dfxp_quantize_ref(a["x"], a["e"], width=a["width"])


def k1_eager(a):
    from repro_torch.core.quant import fixed_round
    return fixed_round(a["x"], a["width"], a["e"])


def k1_library(a):
    """One PyTorch call of the same rounding (no overflow counts)."""
    q = 2 ** (a["width"] - 1)
    return torch.fake_quantize_per_tensor_affine(
        a["x"], 2.0 ** a["e"], 0, -q, q - 1)


def k2_call(a):
    """K2 (quantized matmul) on a :func:`qmatmul.cases.qmm_case`."""
    from repro_torch.kernels.qmatmul import ops
    return ops.qmm(a["a"], a["b"], a["e_a"], a["e_b"], kind=a["kind"],
                   width_a=a["width_a"], width_b=a["width_b"])


def k2_plain(a):
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    return qmatmul_ref(a["a"], a["b"], a["e_a"], a["e_b"], kind=a["kind"],
                       width_a=a["width_a"], width_b=a["width_b"])


def k2_plain64(a):
    """K2's plain version in float64: the same rounded operands, their
    product summed in double precision."""
    from repro_torch.kernels.qmatmul.ref import round_operand
    qa = round_operand(a["a"], a["e_a"], a["width_a"]).double()
    qb = round_operand(a["b"], a["e_b"], a["width_b"]).double()
    if a["kind"] == "nt":
        qb = qb.t()
    elif a["kind"] == "tn":
        qa = qa.t()
    return torch.matmul(qa, qb)


def k2_library(a):
    """``torch.matmul`` on the operands rounded outside the timed call."""
    from repro_torch.kernels.qmatmul.ref import round_operand
    if "_q" not in a:
        a["_q"] = (round_operand(a["a"], a["e_a"], a["width_a"]),
                   round_operand(a["b"], a["e_b"], a["width_b"]))
    qa, qb = a["_q"]
    if a["kind"] == "nt":
        qb = qb.t()
    elif a["kind"] == "tn":
        qa = qa.t()
    return torch.matmul(qa, qb)


def phase_train_kernels():
    """K1 bit-exact and K2 within tolerance against their plain versions
    on card tensors; timings and bounds at the main path's shapes and at
    llama3-8B's."""
    from repro_torch.kernels.dfxp import cases as qc
    from repro_torch.kernels.attn.cases import H100_TF32_FLOPS
    from repro_torch.kernels.qmatmul import cases as mc
    from repro_torch.kernels.qmatmul import ops as k2
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref, round_operand
    dev = torch.device("cuda")
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
        "2048x32768 f32 (LM_100M head/logits site)": dict(
            shape=(2048, 32768), e=-3.0, scale=4.0),
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
            ("llama3_8b_w_up", (4096, 14336), dict(e=-12.0, scale=0.02), 2),
            ("lm_head_logits", (2048, 32768), dict(e=-3.0), 2)):
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
    # the LM trainer's products (LM_100M at 2048 tokens): the tied head
    # forward (nt), its dgrad (nn over the vocabulary) and wgrad (tn over
    # the tokens), a layer's split-K forward and wgrad; backward operands
    # raw, as the fused path passes them
    for tag, (kind, R, C, D, wb) in LM_K2.items():
        k2_check(f"LM {tag}", mc.qmm_case(kind, R, C, D, width_b=wb, seed=8,
                                          device=dev))
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

    k2_rows = {}
    for tag, (kind, R, C, D), n in (
            ("maxout_fwd_nn", ("nn", 64, 1200, 784), 24),
            ("maxout_dgrad_nt", ("nt", 64, 240, 1200), 24),
            ("maxout_wgrad_tn", ("tn", 784, 1200, 64), 24),
            ("llama3_8b_chunk_nn", ("nn", 128, 14336, 4096), 2),
            *((f"lm_{k}", v[:4], 2) for k, v in LM_K2.items()
              if k.startswith("head"))):
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


# K2's products on the LM trainer's path: (layout, R, C, D, width of B)
LM_K2 = {"head_fwd_nt": ("nt", 2048, 32768, 512, 10),
         "head_dgrad_nn": ("nn", 2048, 512, 32768, 10),
         "head_wgrad_tn": ("tn", 32768, 512, 2048, None),
         "wk_fwd_nn_split": ("nn", 2048, 256, 512, 10),
         "wq_wgrad_tn_split": ("tn", 512, 512, 2048, None)}


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


def _on_grid(state, store_exps, width: int) -> bool:
    """Every ``p:`` leaf an integer multiple of the step it was stored
    with, within the ``width``-bit range there.  That step is its group's
    exponent before the last step (``store_exps``): the §5 controller
    moves exponents after the storage rounding, at the end of a step that
    closes an ``update_interval`` window, such as the 150th."""
    from repro_torch.train.state import leaves_with_path
    q = 2 ** (width - 1)
    for path, x in leaves_with_path(state.params):
        e = store_exps["p:" + "/".join(path)]
        m = x / torch.ldexp(torch.ones_like(e), e.to(torch.int32))
        if not (torch.equal(m, torch.round(m)) and bool((m >= -q).all())
                and bool((m <= q - 1).all())):
            return False
    return True


def _grid_control(run) -> bool:
    """The grid check discriminates: a run's parameters do not all lie on
    the grid one step coarser than the one they were stored on (as
    parameters rounded one step finer than their exponent's would not
    pass :func:`_on_grid` at it)."""
    coarser = {k: v + 1 for k, v in run["store_exps"].items()}
    return not _on_grid(run["state"], coarser, 12)


def phase_train():
    """The training main path at full width: the quickstart's four rows on
    the reference's recipe (weights from ``PRNGKey(7)``, dropout on), then
    a DFXP 10/12 row with stochastic storage rounding."""
    from repro_torch.examples import quickstart as qs
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
        ok &= r["launches"] == step_want
        ok &= pol.arithmetic == "fixed" or r["acc"] >= ACC_FLOOR
        ok &= bool(np.isfinite(r["losses"]).all())
    d = rows["dfxp 10/12 (paper)"]
    moved = sum(float(d["state"].scale.exps[k]) != float(v)
                for k, v in res["init_exp"].items())

    def tail(name):                   # mean loss of the last 10 steps
        return float(np.mean(rows[name]["losses"][-10:]))

    ratio = d["loss"] / rows["float32 (baseline)"]["loss"]
    tail_ratio = tail("dfxp 10/12 (paper)") / tail("float32 (baseline)")
    beats_fixed = tail("dfxp 10/12 (paper)") < tail("fixed point 20/20")
    on_grid = _on_grid(d["state"], d["store_exps"], 12)
    log(f"train main path ({cfg.name}, hidden {cfg.hidden} x "
        f"{cfg.pieces}, batch {qs.BATCH}, {qs.STEPS} steps/row): "
        f"{wall:.1f}s; launches {launches} expected {want}; exponents moved "
        f"{moved}; dfxp/float32 final loss {ratio:.3f}, last-10 mean "
        f"{tail_ratio:.3f}; dfxp below fixed 20/20 {beats_fixed}; p: on "
        f"grid {on_grid}")
    log("train rows: " + json.dumps(summary))
    # The paper's claim, as this configuration lets it show: DFXP 10/12
    # trains below 20-bit fixed point (its Table 3 ordering) and near
    # float32, within TABLE3_LAST10_BOUND of it (the reference's own ratio
    # on this recipe with dropout on, with a margin; see its definition).
    fixed = fixed_row_study(rows["fixed point 20/20"]["acc"])
    if not (ok and launches == want and moved > 0
            and tail_ratio <= TABLE3_LAST10_BOUND and beats_fixed
            and on_grid and _grid_control(d)
            and fixed["acc_median"] >= ACC_FLOOR):
        raise SystemExit("the training main path failed its checks")
    stoch = _stochastic_row(cfg, res["init_exp"])
    return {"rows": summary, "launches": launches, "wall_s": wall,
            "fixed_20_20_over_seeds": fixed,
            "exponents_moved": moved, "dfxp_over_float32_final_loss": ratio,
            "dfxp_over_float32_last10_loss": tail_ratio,
            "stochastic_rounding_row": stoch}


def fixed_row_study(recipe_acc=None) -> dict:
    """The fixed 20/20 Table-3 row on the card, at full PI width: its eval
    accuracy over ``quickstart.SEED_PAIRS`` (init and dropout seeds; the
    recipe's first, ``recipe_acc`` where the main path already trained
    it), and where the card's run on the recipe parts from the CPU's:
    each of the first steps' loss gap, and after the first update the
    parameters that differ, in steps of their 2^-8 grid.  K1 on, as on
    the main path."""
    from repro_torch.core.quant import enable_pallas_quantize
    from repro_torch.examples import quickstart as qs
    from repro_torch.models import maxout as MX
    from repro_torch.train.state import leaves_with_path
    cfg = MX.MaxoutConfig()
    pol = next(p for _, p, _ in qs.rows(None) if p.arithmetic == "fixed")
    enable_pallas_quantize(True)
    try:
        accs = [] if recipe_acc is None else [recipe_acc]
        for seed, dseed in qs.SEED_PAIRS[len(accs):]:
            accs.append(qs.train(cfg, pol, "cuda", seed=seed,
                                 dropout_seed=dseed)["acc"])
        first = {d: qs.train(cfg, pol, d, steps=3, eval_n=64)
                 for d in ("cuda", "cpu")}
        one = {d: qs.train(cfg, pol, d, steps=1, eval_n=64)
               for d in ("cuda", "cpu")}
    finally:
        enable_pallas_quantize(False)
    lc = np.array(first["cuda"]["losses"])
    lp = np.array(first["cpu"]["losses"])
    differ, steps_max, n = 0, 0.0, 0
    cpu_leaves = dict(leaves_with_path(one["cpu"]["state"].params))
    for path, x in leaves_with_path(one["cuda"]["state"].params):
        grid = 2.0 ** float(one["cuda"]["store_exps"]["p:" + "/".join(path)])
        d = (x.cpu() - cpu_leaves[path]).abs() / grid
        differ += int((d > 0).sum())
        steps_max = max(steps_max, float(d.max()))
        n += x.numel()
    a = np.array(accs)
    out = {"seed_pairs": [list(p) for p in qs.SEED_PAIRS], "acc": accs,
           "acc_median": float(np.median(a)), "acc_min": float(a.min()),
           "below_floor": int((a < ACC_FLOOR).sum()),
           "first_losses_rel_gap": np.abs(lc / lp - 1).tolist(),
           "params_differ_after_one_update": differ, "params": n,
           "max_gap_in_grid_steps": steps_max}
    log(f"fixed 20/20 on the card over seeds: {json.dumps(out)}")
    return out


def _stochastic_row(cfg, init_exp):
    """DFXP 10/12 at full width with ``stochastic_rounding=True``: the
    parameters and momentum stored by ``floor(x / step + u)``, ``u`` from
    ``fold_in(PRNGKey(i), hash(name) % 2**31)`` at step ``i``; K1 and K2
    on.  Finite losses, every parameter on its 12-bit grid, eval
    accuracy at least 0.99, and K1/K2 launched as the rounding sites give
    (storage rounding, stochastic or not, takes neither kernel)."""
    import dataclasses
    from repro_torch.core.quant import enable_pallas_quantize
    from repro_torch.examples import quickstart as qs
    pol = dataclasses.replace(qs.dfxp_policy(fused_matmul=True),
                              stochastic_rounding=True)
    enable_pallas_quantize(True)
    try:
        r = qs.train(cfg, pol, "cuda", init_exp=init_exp)
    finally:
        enable_pallas_quantize(False)
    k1s, k2s = site_launches(cfg, pol, qs.BATCH, backward=True)
    want = {"dfxp_quantize": qs.STEPS * k1s, "qmatmul": qs.STEPS * k2s}
    on_grid = _on_grid(r["state"], r["store_exps"], 12)
    out = {"final_loss": r["loss"],
           "last10_mean_loss": float(np.mean(r["losses"][-10:])),
           "eval_acc": r["acc"], "train_launches": r["launches"],
           "expected_train_launches": want, "on_grid": on_grid,
           "ms_per_step": r["seconds"] / qs.STEPS * 1e3}
    log(f"stochastic-rounding row: {json.dumps(out)}")
    if not (np.isfinite(r["losses"]).all() and on_grid and _grid_control(r)
            and r["acc"] >= ACC_FLOOR
            and r["launches"] == want):
        raise SystemExit("the stochastic-rounding row failed its checks")
    return out


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
    """Device time of one full-width DFXP train step by kind, dropout on,
    of the same step with dropout off (the difference is the PRNG's: its
    key splits and masks), and of its forward+backward alone (the rest of
    the step is the gradient rounding, optimizer, storage rounding and
    controller)."""
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
    loss_fn = qs.loss_fn(cfg, pol, "cuda")             # dropout on
    step = make_train_step(loss_fn, gs, pol, qs.OPT)
    step_nodrop = make_train_step(
        lambda p, b, s, e: MX.loss_fn(cfg, pol, p, b, e, s), gs, pol, qs.OPT)
    batch = next(qs.batches(qs.data_for(cfg), 1, "cuda"))
    sinks = {n: torch.zeros(3, device="cuda", requires_grad=True)
             for n in gs if n.startswith("g:")}

    def fwd_bwd():
        loss_and_grads(loss_fn, state.params, batch, sinks, state.scale.exps)

    enable_pallas_quantize(True)
    try:
        out = {"train_step": _profile("dfxp_train_step",
                                      lambda: step(state, batch)),
               "train_step_dropout_off": _profile(
                   "dfxp_train_step_dropout_off",
                   lambda: step_nodrop(state, batch)),
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


# ---------------------------------------------------------------------------
# the trainer slice: repro_torch.launch.train on the example's LM_100M
# ---------------------------------------------------------------------------

# The example's recipe (examples/train_lm.py: LM_100M, adamw lr 3e-3, batch
# 16, seq 128, DFXP 10/12, controller interval 20) on the fused path.
LM_ARGV = ["--arch", "lm_100m", "--global-batch", "16", "--seq-len", "128",
           "--comp-width", "10", "--update-width", "12",
           "--update-interval", "20", "--optimizer", "adamw", "--lr", "3e-3",
           "--fused-matmul", "--log-every", "1", "--device", "cuda"]
LM_DFXP = ["--arithmetic", "dfxp", "--calibrate-steps", "2"]
LM_F32 = ["--arithmetic", "float32", "--calibrate-steps", "0"]
# The reference launcher's losses at steps 1-20 at the same argv (without
# --fused-matmul: the reference's fused path gives the same numbers), jax
# 0.9.0 on a CPU: `python tests/test_torch_launch_train.py`.
REF_LM = {
    "float32": [10.5108, 10.5138, 10.4877, 10.509, 10.5433, 10.6203,
                10.5863, 10.5537, 10.5706, 10.6838, 10.6898, 10.7135,
                10.615, 10.6133, 10.6563, 10.6544, 10.6985, 10.6557,
                10.5933, 10.628],
    "dfxp": [10.5118, 10.5214, 10.496, 10.5172, 10.5375, 10.5615, 10.5856,
             10.6939, 10.8393, 10.9489, 11.2427, 11.4246, 11.6947, 11.9083,
             12.1511, 12.305, 12.5441, 12.6448, 12.8398, 12.8456]}
REF_LM_GROUPS = 62
LM_STEP1_TOL = 1e-3             # same weights and data: the initial loss
LM_STEP20_TOL = 0.5             # nats: a free-running run parts from the
                                # reference after its first flipped tie
# a subprocess of the trainer CLI: K1 on (the reference's API, no flag)
# and LM_100M registered as the arch "lm_100m", as the example does
LM_CLI = ("import sys; sys.path.insert(0, sys.argv.pop(1)); "
          "from repro_torch.core.quant import enable_pallas_quantize; "
          "enable_pallas_quantize(True); "
          "from repro_torch.examples.train_lm import register; register(); "
          "from repro_torch.launch.train import main; main(sys.argv[1:])")


def lm_site_launches(cfg, B: int, S: int, S_src: int = 0):
    """(K1, K2) launches of one fused DFXP step of a token-in LM of dense
    (attn, swiglu or gelu ffn), MoE (attn, moe) and encoder-decoder
    (an encoder of attn, ffn over ``S_src`` source frames; attn, xattn,
    ffn decoder layers) blocks, from its rounding sites: every
    ``tape.dot`` (4 an attention or cross-attention block, 3 a SwiGLU
    FFN, 2 a gelu one, and the head) is one K2 forward, dgrad and wgrad,
    and rounds its weight's statistics once (K1); an expert bank (3 a MoE
    block, ``[E, D, F]``) and the embedding table round once at
    ``tape.weight``; every activation site (qkv, k, v, out, res of
    attention, k and v of cross-attention over the source; pre, out, res
    of an FFN; dispatch ``[E, C, D]``, pre ``[E, C, F]``, expert_out,
    out, res of a MoE block at its capacity ``C``; emb/out; head/logits)
    rounds its value forward and its cotangent backward.  K1 takes a site
    of at least ``MIN_SIZE`` elements."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    d = cfg.d_model
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    weights, acts, dots = [], [], 1
    for stage in T.build_stages(cfg):
        n = stage.count
        N = B * (S_src if stage.name == "enc" else S)
        for blk in stage.blocks:
            if blk.kind in ("attn", "xattn"):
                Nk = B * S_src if blk.kind == "xattn" else N
                weights += [d * q, d * kv, d * kv, q * d] * n
                acts += [N * q, Nk * kv, Nk * kv, N * d, N * d] * n
                dots += 4 * n
            elif blk.kind == "ffn" and cfg.ffn_kind in ("swiglu", "gelu"):
                f = cfg.d_ff
                n_w = 3 if cfg.ffn_kind == "swiglu" else 2
                weights += ([d * f] * (n_w - 1) + [f * d]) * n
                acts += [N * f, N * d, N * d] * n
                dots += n_w * n
            elif blk.kind == "moe" and not cfg.shared_expert:
                E, F = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
                C = moe.capacity(N, cfg.moe_spec)
                weights += [E * d * F] * 3 * n
                acts += [E * C * d, E * C * F, E * C * d, N * d, N * d] * n
            else:
                raise NotImplementedError(f"no site count for {blk.kind}")
    N = B * S
    weights += [cfg.vocab_size * d] * (2 if cfg.input_mode == "tokens"
                                       else 1)
    acts += [N * d, N * cfg.vocab_size]
    k1 = sum(n >= MIN_SIZE for n in weights) \
        + 2 * sum(n >= MIN_SIZE for n in acts)
    return k1, 3 * dots


def _lm_parse(text: str) -> dict:
    """Group count, per-step losses, the summary and the outcome table of
    one launcher run's output."""
    import re
    m = re.search(r"calibrated (\d+) scale groups", text)
    losses = {int(s): float(v) for s, v in
              re.findall(r"^step (\d+): loss=(\S+)$", text, re.M)}
    summ = [ln for ln in text.splitlines() if ln.startswith("summary: ")]
    r = re.search(r"^resumed from cursor (\d+)$", text, re.M)
    return {"groups": int(m.group(1)) if m else None, "losses": losses,
            "resumed_from": int(r.group(1)) if r else None,
            "summary": json.loads(summ[-1][9:]) if summ else None,
            "table": "     outcome  count" in text}


def lm_cli(args, timeout: int):
    """Run the trainer CLI in a subprocess; ``(returncode, stdout,
    stderr)``.  A run past ``timeout`` is killed and fails the phase."""
    src = str(Path(__file__).resolve().parent / "src")
    r = subprocess.run([sys.executable, "-c", LM_CLI, src, *args],
                       capture_output=True, text=True, timeout=timeout)
    return r.returncode, r.stdout, r.stderr


def _lm_in_process(argv):
    """``repro_torch.launch.train.main(argv)`` in this process (K1 on):
    its output parsed and the final state.  The launcher's signal
    handlers are put back afterwards."""
    import contextlib
    import io
    import signal
    from repro_torch.core.quant import enable_pallas_quantize
    from repro_torch.launch import train
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                  signal.SIGINT)}
    buf = io.StringIO()
    enable_pallas_quantize(True)
    try:
        with contextlib.redirect_stdout(buf):
            state = train.main(argv)
        torch.cuda.synchronize()
    finally:
        enable_pallas_quantize(False)
        for s, h in handlers.items():
            signal.signal(s, h)
    return _lm_parse(buf.getvalue()), state


def _ckpt_leaves(d: str):
    """The newest committed checkpoint under ``d``: (step, {name: array})."""
    import os
    steps = [int(n.split("_")[1]) for n in os.listdir(d)
             if n.startswith("step_") and n[5:].isdigit()
             and os.path.exists(os.path.join(d, n, "_COMMITTED"))]
    path = os.path.join(d, f"step_{max(steps):08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return max(steps), {m["name"]: np.load(os.path.join(path, m["file"]))
                        for m in leaves}


def phase_train_lm_parity():
    """Card = CPU at smoke size: three supervised DFXP 10/12 steps of a
    tied 2-layer LM (the example's shape, narrow) from calibrated
    exponents, fused matmul and K1 from 4096 elements on the card, plain
    versions on the CPU: exponents equal, losses within 1e-4 (the CPU
    parity tests' tolerance against the reference)."""
    import dataclasses
    from repro_torch.core import prng
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.core.quant import enable_pallas_quantize
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.optim.opt import OptConfig, adamw_init
    from repro_torch.train import TrainSupervisor, init_train_state
    from repro_torch.train.calibrate import calibrate
    cfg = T.ModelConfig(name="lm-tiny", num_layers=2, d_model=64,
                        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                        vocab_size=256, tie_embeddings=True)
    pol = PrecisionPolicy("dfxp", update_interval=2, fused_matmul=True)
    obs = dataclasses.replace(pol, arithmetic="observe")
    opt = OptConfig(kind="adamw", lr=3e-3, lr_decay_steps=1000)
    gs = T.group_shapes(cfg)
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=0)
    runs = []
    enable_pallas_quantize(True, min_size=1 << 12)
    try:
        for dev in ("cuda", "cpu"):
            def batch(c, dev=dev):
                return {k: torch.from_numpy(v).to(dev)
                        for k, v in data.batch(c).items()}
            init = calibrate(
                lambda p, b, s, e: T.loss_fn(cfg, obs, p, b, e, s),
                T.init_params(cfg, 0, device=dev), gs, pol, opt,
                (batch(i) for i in range(2)), steps=2)
            params = T.init_params(cfg, prng.fold_in(prng.PRNGKey(0), 1),
                                   device=dev)
            before = train_launches()
            sup = TrainSupervisor(
                lambda p, b, s, e: T.loss_fn(cfg, pol, p, b, e, s), gs, pol,
                opt, init_train_state(params, adamw_init(params), gs, pol,
                                      init_exp=init),
                batch_fn=batch, rng=0)
            sup.run(3)
            after = train_launches()
            runs.append((sup.losses, {k: v.tolist() for k, v in
                                      sup.state.scale.exps.items()},
                         {k: after[k] - before[k] for k in after},
                         {k: v.tolist() for k, v in init.items()}))
    finally:
        enable_pallas_quantize(False)
    card, cpu = runs
    lc, lp = np.array(card[0]), np.array(cpu[0])
    diff = float(np.abs(lc - lp).max()) if lc.size == lp.size else math.inf
    same_init = card[3] == cpu[3]
    same_exps = card[1] == cpu[1]
    log(f"LM parity card vs cpu (3 supervised DFXP steps, {cfg.name}): "
        f"max loss diff {diff:.3e}; calibrated exponents equal {same_init}; "
        f"exponents equal {same_exps}; card launches {card[2]}")
    if not (lc.size == 3 and diff <= 1e-4 and same_init and same_exps
            and card[2]["dfxp_quantize"] > 0 and card[2]["qmatmul"] > 0):
        raise SystemExit("LM training on the card disagrees with the CPU")
    return {"max_loss_diff": diff, "card_launches": card[2]}


def phase_train_lm():
    """The trainer main path: ``repro_torch.launch.train`` on the
    example's LM_100M at full width and depth (12 layers, d_model 512,
    vocab 32768, tied), batch 16 x 128, DFXP 10/12 through K2 (fused
    matmul) and K1, adamw lr 3e-3, 2 calibration steps:

    1. a 60-step run here (checkpoints every 10), and a float32 run of 20
       steps: every step ok, 62 groups, step 1 within ``LM_STEP1_TOL`` and
       step 20 within ``LM_STEP20_TOL`` of the reference's in each row,
       DFXP above float32 at step 20, K1 and K2 launches = the sites'
       arithmetic;
    2. the same argv in a subprocess with ``--kill-at 30`` exits 137, and
       the rerun without the kill resumes and ends with the solo run's
       final loss and final checkpoint, bit for bit;
    3. a chaos run, the reference CI's sweep at full width (packed
       storage, SGD, ``--chaos 0``: a corrupt checkpoint tear and a bit
       flip at cursor 11, a 4-step NaN burst at 13): exit 0, every
       attempt resolved, a rollback, a bit flip and a tear logged;
    4. one step profiled, one synchronous checkpoint and one restore
       timed, the peak memory, the init's seconds.

    The solo, killed and resumed runs write the §5 numerics timeline
    (``--numerics-log``, every ``--update-interval`` = 20 committed
    steps): the solo run's records at steps 20, 40 and 60, one per
    tensor class, with controller moves; at step 60 the final state's
    exponents, at step 20 those of the killed run's last committed
    checkpoint; the killed run's step-20 record and the resumed run's
    at 40 and 60 equal the solo run's but their clock (:func:`numerics_check`);
    the resume stays bit for bit with the tap on."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import prng
    from repro_torch.data import SyntheticLM
    from repro_torch.examples import train_lm
    from repro_torch.launch.train import build_policy
    from repro_torch.models import transformer as T
    from repro_torch.optim.opt import OptConfig
    from repro_torch.train import TrainSupervisor
    train_lm.register()
    cfg = train_lm.LM_100M
    tmp = tempfile.mkdtemp(prefix="lm_ckpt_")
    res = {"config": cfg.name}
    try:
        # -- init alone ------------------------------------------------------
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = T.init_params(cfg, 0, device="cuda")
        torch.cuda.synchronize()
        res["init_s"] = time.perf_counter() - t0
        del params

        # -- 1. the solo run (the main path: counts from 0) ------------------
        solo_dir = f"{tmp}/solo"
        # a checkpoint every 10 steps, so the kill at cursor 30 lands just
        # as the save of 30 begins, after the save of 20 was waited for:
        # the resume is from 20 whatever a 0.77 GB write takes
        argv = LM_ARGV + LM_DFXP + ["--steps", "60", "--ckpt-every", "10",
                                    "--keep", "1"]
        logs = {k: f"{tmp}/numerics_{k}.jsonl"
                for k in ("solo", "kill", "resume")}
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_all_launches()
        t0 = time.perf_counter()
        solo, state = _lm_in_process(argv + ["--ckpt-dir", solo_dir,
                                             "--numerics-log", logs["solo"]])
        res["solo_wall_s"] = time.perf_counter() - t0
        launches = train_launches()
        res["launches"] = launches
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - base
        res["state_bytes"] = _state_bytes(state)
        k1s, k2s = lm_site_launches(cfg, 16, 128)
        want = {"dfxp_quantize": 60 * k1s, "qmatmul": 60 * k2s}
        f32, _ = _lm_in_process(LM_ARGV + LM_F32 + ["--steps", "20"])
        rows = {"dfxp": solo, "float32": f32}
        for row, r in rows.items():
            log(f"LM {row}: groups {r['groups']}, losses "
                + ", ".join(f"{s}: {r['losses'][s]:.4f} (ref "
                            f"{REF_LM[row][s - 1]})" for s in (1, 10, 20)
                            if s in r["losses"]))
        s_ok = all(r["summary"] and r["summary"]["attempts"]
                   == r["summary"]["steps_committed"] == len(r["losses"])
                   and r["summary"]["halted"] is False
                   for r in rows.values())
        d1 = max(abs(r["losses"].get(1, math.inf) - REF_LM[k][0])
                 for k, r in rows.items())
        d20 = max(abs(r["losses"].get(20, math.inf) - REF_LM[k][19])
                  for k, r in rows.items())
        above = solo["losses"].get(20, 0.0) > f32["losses"].get(20, math.inf)
        res.update(groups=solo["groups"], step1_max_diff=d1,
                   step20_max_diff=d20, dfxp_above_float32=above,
                   expected_launches=want, per_step={"dfxp_quantize": k1s,
                                                    "qmatmul": k2s},
                   losses={k: [r["losses"].get(s) for s in (1, 10, 20, 40,
                                                             60)]
                           for k, r in rows.items()},
                   final_loss=solo["summary"] and solo["summary"]
                   ["final_loss"])
        log(f"LM solo: {res['solo_wall_s']:.1f}s, every step ok {s_ok}, "
            f"step-1 diff {d1:.2e}, step-20 diff {d20:.3f}, dfxp above "
            f"float32 {above}; launches {launches} expected {want}; peak "
            f"{res['peak_memory_bytes'] / 1e9:.2f} GB")
        if not (s_ok and solo["groups"] == REF_LM_GROUPS
                and d1 <= LM_STEP1_TOL and d20 <= LM_STEP20_TOL and above
                and launches == want):
            raise SystemExit("the LM trainer's solo run failed its checks")

        # -- 2. crash and resume ---------------------------------------------
        crash = argv + ["--ckpt-dir", f"{tmp}/crash"]
        t0 = time.perf_counter()
        code, out, err = lm_cli(crash + ["--kill-at", "30", "--numerics-log",
                                         logs["kill"]], 600)
        code = 128 - code if code < 0 else code     # a signal's shell code
        killed = code == 137
        s20, at20 = _ckpt_leaves(f"{tmp}/crash")
        code2, out2, err2 = lm_cli(crash + ["--numerics-log", logs["resume"]],
                                   600)
        res["crash_resume_s"] = time.perf_counter() - t0
        resumed = _lm_parse(out2)
        same_loss = (resumed["summary"] is not None and
                     resumed["summary"]["final_loss"] == res["final_loss"])
        (sa, a), (sb, b) = _ckpt_leaves(solo_dir), _ckpt_leaves(
            f"{tmp}/crash")
        diff_leaves = [k for k in a if k not in b
                       or not np.array_equal(a[k], b[k])]
        res.update(kill_exit=code, resume_exit=code2,
                   resumed_final_loss=resumed["summary"] and
                   resumed["summary"]["final_loss"],
                   ckpt_leaves=len(a), ckpt_leaves_differing=len(diff_leaves))
        log(f"LM crash at 30: exit {code}; resume: exit {code2}, "
            f"'resumed from cursor' {'resumed from cursor 20' in out2}, "
            f"final loss {res['resumed_final_loss']!r} vs solo "
            f"{res['final_loss']!r}; checkpoint {sb} vs {sa}: "
            f"{len(diff_leaves)} of {len(a)} leaves differ {diff_leaves[:3]}")
        if not (killed and code2 == 0 and "resumed from cursor 20" in out2
                and same_loss and sa == sb == 60 and not diff_leaves):
            log(err[-2000:] + err2[-2000:])
            raise SystemExit("the LM trainer's crash and resume is not "
                             "bit-exact")
        if s20 != 20:
            raise SystemExit(f"the killed LM run's last checkpoint is at "
                             f"{s20}, not 20")
        res["numerics"] = numerics_check(
            logs, {k[len("train/scale/exps/"):]: v for k, v in a.items()
                   if k.startswith("train/scale/exps/")},
            {k[len("train/scale/exps/"):]: v for k, v in at20.items()
             if k.startswith("train/scale/exps/")})
        shutil.rmtree(f"{tmp}/crash", ignore_errors=True)

        # -- 3. chaos at full width ------------------------------------------
        fault_log = f"{tmp}/faults.json"
        chaos = ["--arch", "lm_100m", "--global-batch", "16", "--seq-len",
                 "128", "--arithmetic", "dfxp", "--fused-matmul",
                 "--calibrate-steps", "0", "--update-interval", "4",
                 "--storage", "packed", "--steps", "24", "--ckpt-dir",
                 f"{tmp}/chaos", "--ckpt-every", "4", "--skip-budget", "3",
                 "--chaos", "0", "--log-every", "100", "--fault-log",
                 fault_log, "--bundle-dir", f"{tmp}/bundle",
                 "--device", "cuda"]
        t0 = time.perf_counter()
        code3, out3, err3 = lm_cli(chaos, 600)
        res["chaos_s"] = time.perf_counter() - t0
        with open(fault_log) as f:
            flog = json.load(f)
        run, kinds = flog["run"], [e["kind"] for e in
                                   flog["harness"]["events"]]
        chaos_ok = (code3 == 0 and "Traceback" not in out3 + err3
                    and sum(run["outcomes"].values()) == run["attempts"]
                    == 24 and run["outcomes"]["rolled_back"] >= 1
                    and "bit_flip" in kinds and "ckpt_tear" in kinds
                    and _lm_parse(out3)["table"])
        res["chaos"] = {"exit": code3, "outcomes": run["outcomes"],
                        "events": flog["harness"]["event_counts"]}
        log(f"LM chaos (seed 0, packed, 24 steps): exit {code3}, "
            f"{res['chaos_s']:.1f}s, outcomes {run['outcomes']}, events "
            f"{flog['harness']['event_counts']}")
        if not chaos_ok:
            log(err3[-3000:])
            raise SystemExit("the LM trainer's chaos run failed its checks")

        # -- 4. a profiled step, a checkpoint, a restore ---------------------
        from repro_torch.core.quant import enable_pallas_quantize
        ns = type("Args", (), dict(
            arithmetic="dfxp", comp_width=10, update_width=12,
            update_interval=20, storage="sim", max_overflow_rate=1e-4,
            fused_matmul=True))
        pol = build_policy(ns)
        data = SyntheticLM(cfg.vocab_size, 128, 16, seed=0)
        sup = TrainSupervisor(
            lambda p, b, s, e: T.loss_fn(cfg, pol, p, b, e, s),
            T.group_shapes(cfg), pol,
            OptConfig(kind="adamw", lr=3e-3, lr_decay_steps=1000), state,
            batch_fn=lambda c: {k: torch.from_numpy(v).cuda()
                                for k, v in data.batch(c).items()},
            rng=prng.PRNGKey(0, "cuda"))
        sup.cursor = 60
        enable_pallas_quantize(True)
        try:
            res["step_profile"] = _profile("lm_train_step", sup.step_once)
        finally:
            enable_pallas_quantize(False)
        mgr = CheckpointManager(f"{tmp}/timing", keep=1)
        t0 = time.perf_counter()
        mgr.save(sup.cursor, sup.ckpt_tree())
        res["ckpt_save_s"] = time.perf_counter() - t0
        import os
        sdir = f"{tmp}/timing/step_{sup.cursor:08d}"
        res["ckpt_bytes"] = sum(os.path.getsize(f"{sdir}/{n}")
                                for n in os.listdir(sdir))
        t0 = time.perf_counter()
        mgr.restore_latest(sup.ckpt_template())
        torch.cuda.synchronize()
        res["ckpt_restore_s"] = time.perf_counter() - t0
        log(f"LM checkpoint: {res['ckpt_bytes'] / 1e9:.3f} GB written in "
            f"{res['ckpt_save_s']:.2f}s, restored in "
            f"{res['ckpt_restore_s']:.2f}s; init {res['init_s']:.2f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def _class_exps(exps: dict) -> dict:
    """Per tensor class: (groups, min, max, mean) of a state's exponents
    (stacked groups count each layer), as ``train_records`` sums them."""
    from repro_torch.core.tape import tensor_class
    by = {}
    for g, e in exps.items():
        by.setdefault(tensor_class(g), []).extend(
            np.asarray(e, np.float64).reshape(-1).tolist())
    return {c: (len(v), min(v), max(v), sum(v) / len(v))
            for c, v in by.items()}


def numerics_check(logs: dict, exps_last: dict, exps_first: dict, *,
                   interval: int = 20, steps: int = 60) -> dict:
    """The LM trainer's numerics timelines (``logs``: solo, kill, resume
    JSONL paths; a record every ``interval`` of ``steps`` committed steps,
    the kill after the first record and the resume from there) against
    the states they describe (``exps_last``: the solo run's final
    checkpoint's exponents; ``exps_first``: the killed run's last
    committed checkpoint's, at step ``interval``)."""
    from repro_torch.obs import count_moves, read_jsonl
    recs = {k: read_jsonl(p) for k, p in logs.items()}
    want_steps = list(range(interval, steps + 1, interval))

    def by_step(rs, step):
        return [{k: v for k, v in r.items() if k != "t"} for r in rs
                if r["step"] == step]

    solo = recs["solo"]
    agree = {}
    for step, want in ((steps, _class_exps(exps_last)),
                       (interval, _class_exps(exps_first))):
        got = {r["class"]: (r["n_groups"], r["exp_min"], r["exp_max"],
                            r["exp_mean"]) for r in solo
               if r["step"] == step}
        agree[step] = got == want
    same_kill = by_step(recs["kill"], interval) == by_step(solo, interval)
    same_resume = all(by_step(recs["resume"], s) == by_step(solo, s)
                      for s in want_steps[1:])
    n_cls = len(_class_exps(exps_last))
    res = {"records": len(solo), "steps": sorted({r["step"] for r in solo}),
           "controller_moves": count_moves(solo),
           "state_exponents_agree": agree, "kill_first_equal": same_kill,
           "resume_rest_equal": same_resume,
           "resume_steps": sorted({r["step"] for r in recs["resume"]})}
    log(f"LM numerics timeline: {json.dumps(res)}")
    if not (res["steps"] == want_steps
            and len(solo) == len(want_steps) * n_cls
            and res["controller_moves"] > 0 and all(agree.values())
            and same_kill and same_resume
            and res["resume_steps"] == want_steps[1:]):
        raise SystemExit("the LM trainer's numerics timeline failed its "
                         "checks")
    return res


# ---------------------------------------------------------------------------
# the PRNG slice: threefry keys and draws, dropout and stochastic rounding
# in training, sampled serving over a stochastic pool, the precision sweep
# ---------------------------------------------------------------------------

# split(PRNGKey(0)) and fold_in(PRNGKey(0), 3) as jax 0.9.0 gives them
PRNG_SPLIT0 = [[1797259609, 2579123966], [928981903, 3453687069]]
PRNG_FOLD3 = [2467461003, 3840466878]
PRNG_BIG = (4097, 4097)               # 16,785,409 draws, past 2**24


def _bits_equal(a, b) -> int:
    """Elements of ``a`` and ``b`` whose bits differ (floats compared as
    their 32-bit words)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def _ulp_max(a, b) -> int:
    def ordered(x):
        i = x.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _exp_gap(got: dict, want: dict) -> float:
    """The largest exponent gap over the groups of two rows (inf where
    their groups differ)."""
    if set(got) != set(want):
        return math.inf
    return max(abs(got[k] - want[k]) for k in want)


def phase_sweep():
    """The paper's Figures 1-4 (``repro_torch.examples.precision_sweep``)
    on the card, DFXP rows through K1 and K2: every row's final loss ÷
    float32's within ``SWEEP_BAND`` of the reference's number for the
    same row (``REF_SWEEP``), eval accuracy finite; and every DFXP row's
    final exponents within ``SWEEP_EXP_TOL`` of the reference's, group
    by group (``REF_SWEEP_EXPS``).  The exponents follow the widths, so
    the same check fails a row that ran at other widths: as a control,
    each DFXP row is also held to the reference exponents of every row
    with other widths at its overflow rate, and each of those
    comparisons must fail."""
    from repro_torch.core.quant import enable_pallas_quantize
    from repro_torch.examples import precision_sweep as ps
    reset_all_launches()
    t0 = time.perf_counter()
    enable_pallas_quantize(True)    # the example's --kernel-quantize
    try:    # the example's small table; its full-width one gives no reading
        res = {"rows": ps.sweep(ps.CFG, ps.fig_rows(), "cuda",
                                fused_matmul=True)}
    finally:
        enable_pallas_quantize(False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = train_launches()
    lo, hi = SWEEP_BAND
    table, ok = {}, set(REF_SWEEP) <= set(res["rows"])
    for name, r in res["rows"].items():
        ref = REF_SWEEP.get(name)
        within = ref is not None and lo <= r["ratio"] / ref <= hi
        table[name] = {"loss": r["loss"], "ratio": r["ratio"],
                       "reference_ratio": ref, "acc": r["acc"],
                       "within_band": within}
        ok &= bool(np.isfinite(r["loss"])) and (name == "float32" or within)
    widths = {n: (p.comp_width, p.update_width) for n, p in ps.fig_rows()}
    rates = {n: p.max_overflow_rate for n, p in ps.fig_rows()}
    ok &= set(REF_SWEEP_EXPS) == {n for n, p in ps.fig_rows() if p.dynamic}
    controls = {"comparisons": 0, "failed": 0}
    for name, want in REF_SWEEP_EXPS.items():
        got = res["rows"][name]["exps"]
        gap = _exp_gap(got, want)
        table[name]["max_exp_gap"] = gap
        ok &= gap <= SWEEP_EXP_TOL
        for other, want_o in REF_SWEEP_EXPS.items():
            if widths[other] != widths[name] and rates[other] == rates[name]:
                controls["comparisons"] += 1
                controls["failed"] += _exp_gap(got, want_o) > SWEEP_EXP_TOL
    ok &= controls["failed"] == controls["comparisons"] > 0
    ok &= launches["dfxp_quantize"] > 0 and launches["qmatmul"] > 0
    out = {"wall_s": wall, "launches": launches, "rows": table,
           "exponent_controls": controls}
    log(f"precision sweep ({wall:.1f}s, launches {launches}): "
        + json.dumps(out))
    if not ok:
        raise SystemExit("the precision sweep failed its checks")
    return out


def phase_prng():
    """The port's threefry on the card against the same calls on the CPU:
    ``split``, ``fold_in``, raw bits, ``uniform``, ``bernoulli`` and
    ``normal`` at 16.8M draws, ``gumbel`` and ``categorical`` over
    llama3-8B's vocabulary, bit for bit; and jax's values of
    ``split(PRNGKey(0))`` and ``fold_in(PRNGKey(0), 3)``."""
    from repro_torch.core import prng
    k0 = prng.PRNGKey(0, "cuda")
    consts = (prng.split(k0).tolist() == PRNG_SPLIT0
              and prng.fold_in(k0, 3).tolist() == PRNG_FOLD3)
    g = torch.Generator().manual_seed(0)
    logits = 3.0 * torch.randn((4, 128256), generator=g)
    data = torch.tensor([0, 3, 2 ** 31 - 1, 2 ** 32 - 1])
    calls = {
        "split": lambda k: prng.split(k, 7),
        "fold_in": lambda k: prng.fold_in(prng.split(k, 4),
                                          data.to(k.device)),
        "random_bits": lambda k: prng.random_bits(k, PRNG_BIG),
        "uniform": lambda k: prng.uniform(k, PRNG_BIG),
        "bernoulli": lambda k: prng.bernoulli(k, 0.8, PRNG_BIG),
        "normal": lambda k: prng.normal(k, PRNG_BIG),
        "gumbel": lambda k: prng.gumbel(k, tuple(logits.shape)),
        "categorical": lambda k: prng.categorical(prng.split(k, 4),
                                                  logits.to(k.device)),
    }
    key = prng.PRNGKey(42)
    res, ok = {}, consts
    for name, f in calls.items():
        a, b = f(key.cuda()).cpu(), f(key)
        diff = _bits_equal(a, b)
        res[name] = {"elements": a.numel(), "bits_differ": diff}
        if a.is_floating_point():
            res[name]["max_ulp"] = _ulp_max(a, b)
        ok &= diff == 0
    kc = key.cuda()
    for name in ("uniform", "normal"):
        f = calls[name]
        res[name]["card_ms"] = cuda_ms(lambda: f(kc), 5)
        res[name]["device_ops"] = device_ops(lambda: f(kc))
    res["split"]["device_ops"] = device_ops(lambda: calls["split"](kc))
    log(f"prng card vs cpu: constants {consts}; " + json.dumps(res))
    if not ok:
        raise SystemExit("the PRNG on the card disagrees with the CPU or "
                         "with jax's constants")
    return res


SAMPLED = dict(kind="top_k", temperature=0.8, top_k=40)


def _sampled_engine(cfg, params, page: int, max_len: int):
    """DFXP-10, fused decode, top-k 40 at temperature 0.8 over a
    stochastic int8 pool; slot-major with C = 128 or paged with P = C."""
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.serve import EngineOptions, SamplerConfig, ServeEngine
    from repro_torch.serve.kv_pool import CacheQuantConfig
    pol = PrecisionPolicy("dfxp", fused_decode=True,
                          prefill_chunk=page or 128, page_size=page)
    opts = EngineOptions(cache_bits=8, seed=0,
                         cache_cfg=CacheQuantConfig(width=8, stochastic=True),
                         sampler_cfg=SamplerConfig(**SAMPLED))
    return ServeEngine(cfg, pol, params, max_slots=4, max_len=max_len,
                       options=opts, device="cuda")


def _serve_prompts(cfg, page: int):
    from repro_torch.launch.serve import prompt
    if page:
        return paged_prompts(cfg.vocab_size)
    return [prompt(i, (96, 200, 384)[i % 3], cfg.vocab_size)
            for i in range(6)]


def phase_sampled(eng, page: int = 0):
    """Sampled serving at full llama3-8B width on the greedy runs'
    weights: the six requests of the slot-major run (``page`` 0) or of
    the paged run (P = 64), top-k 40 at temperature 0.8 over a stochastic
    int8 pool.  Every request OK with 16 tokens; the attention kernels
    launched as in the greedy run (once per layer per decode step and per
    chunk); paged: no prefix page shared (sharing is off under a
    stochastic pool), the chunks and pages the allocator's arithmetic
    gives; request 0 served alone (same uid, same slots) draws the tokens
    it drew in the batch."""
    cfg = eng.cfg
    prompts = _serve_prompts(cfg, page)
    reset_all_launches()
    t0 = time.perf_counter()
    max_len = max(map(len, prompts)) + 16
    seng = _sampled_engine(cfg, eng.params, page, max_len)
    for p in prompts:
        seng.submit(p, max_new=16)
    seng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kinds = (("flash_decode_paged", "flash_prefill_paged") if page
             else ("flash_decode", "flash_prefill"))
    st, launches = _check_served(seng, cfg.num_layers, 16, *kinds)
    solo = _sampled_engine(cfg, eng.params, page, max_len)
    solo.submit(prompts[0], max_new=16)
    solo.run()
    same = solo.results[0].tolist() == seng.results[0].tolist()
    distinct = len({tuple(r.tolist()) for r in seng.results.values()})
    out = {"wall_s": wall, "tok_per_s": st["tok_per_s"],
           "ttft_mean_s": st["ttft_mean_s"], "launches": launches,
           "decode_steps": st["decode_steps"],
           "prefill_chunks": st["prefill_chunks"],
           "solo_equals_batched": same, "distinct_streams": distinct,
           "tokens_request_0": seng.results[0].tolist()}
    ok = same and distinct > 1
    if page:
        P = page
        chunks = sum(-(-len(t) // P) for t in prompts)
        pages = sum((len(t) + 16 - 2) // P + 1 for t in prompts)
        out.update({k: st[k] for k in ("page_cache_hits", "page_cow_forks",
                                       "pages_allocated")})
        ok &= (st["page_cache_hits"] == 0 and st["page_cow_forks"] == 0
               and st["prefill_chunks"] == chunks
               and st["pages_allocated"] == pages)
    log(f"sampled {'paged' if page else 'slot-major'} path: "
        f"{json.dumps(out)}")
    if not ok:
        raise SystemExit("the sampled serving run over a stochastic pool "
                         "failed its checks")
    out["engine"] = seng
    return out


def phase_prng_launches(eng, seng):
    """Device operations of one full-width decode step (4 slots at
    position 300) over the deterministic pool with greedy sampling
    against the stochastic pool with top-k sampling: what the PRNG adds
    to a step (the key splits and draws of every layer's append, and the
    sampler's position keys and Gumbel noise)."""
    from repro_torch.core import prng
    from repro_torch.models import transformer as T
    from repro_torch.serve import SamplerConfig, sampler
    B = eng.max_slots
    dev = torch.device("cuda")
    tok = torch.zeros(B, dtype=torch.int32, device=dev)
    pos = torch.full((B,), 300, dtype=torch.int32, device=dev)
    keys = prng.split(prng.PRNGKey(0, dev), B)

    def step(e, cfg_s):
        def call():
            logits, _, _ = T.decode_step(e.cfg, e.policy, e.params,
                                         e.kv.pool, tok, pos, e.exps,
                                         kv_codec=e.codec)
            pk = (None if cfg_s.kind == "greedy"
                  else sampler.position_keys(keys, pos + 1))
            sampler.sample(logits, pk, cfg_s)
        return call

    greedy, sampled = step(eng, SamplerConfig()), step(
        seng, SamplerConfig(**SAMPLED))
    out = {"greedy_deterministic_pool": device_ops(greedy),
           "top_k_stochastic_pool": device_ops(sampled)}
    out["added_by_prng"] = (out["top_k_stochastic_pool"]
                            - out["greedy_deterministic_pool"])
    out["greedy_deterministic_pool_profile"] = _profile(
        "greedy_decode_step", greedy)
    out["top_k_stochastic_pool_profile"] = _profile(
        "stochastic_decode_step", sampled)
    log(f"decode step device operations: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# the serve engine's robustness and observability layer: fault injection,
# admission control, deadlines, the §5 runaway sentinel, the tracer and
# the numerics log, on the serving run's llama3-8B weights
# ---------------------------------------------------------------------------

ROBUST_NEW = 8              # new tokens a request in these phases
ROBUST_LAYERS = 4           # phases b-e: the serving weights' first layers
# the chaos sweep: its seed, and an arena of 11 usable pages (full
# residency is 32): the four slots' concurrent demand exhausts it, and
# the allocator's arithmetic (the same at any width: it reads lengths,
# not values) preempts 4 times
CHAOS_SEED, CHAOS_PAGES = 7, 12
NUMERICS_EVERY = 4          # the traced run's numerics cadence, steps


def _first_layers(tree, n: int):
    """The stages' stacked leaves cut to their first ``n`` layers: views
    of the same tensors, no new weights."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def _robust_engine(eng, page: int = 0, layers: int = ROBUST_LAYERS,
                   **opts):
    """A new engine on ``eng``'s weights (the first ``layers`` of them)
    and geometry: DFXP-10, fused attention, an int8 pool, 4 slots, room
    for 16 new tokens; slot-major with C = 128, or paged with P = C =
    ``page``.  Returns it with the serving runs' six prompts."""
    import dataclasses
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.serve import EngineOptions, ServeEngine
    cfg, params = eng.cfg, eng.params
    if layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        params = {**params,
                  "stages": _first_layers(params["stages"], layers)}
    prompts = _serve_prompts(cfg, page)
    pol = PrecisionPolicy("dfxp", fused_decode=True,
                          prefill_chunk=page or 128, page_size=page)
    e = ServeEngine(cfg, pol, params, max_slots=4,
                    max_len=max(map(len, prompts)) + 16,
                    options=EngineOptions(cache_bits=8, **opts),
                    device="cuda")
    return e, prompts


def _attn_launches(e, decode_kernel: str, prefill_kernel: str) -> dict:
    """The run's attention-kernel launches (counted from 0 around it),
    held to its arithmetic: the decode kernel once per layer per decode
    step, the prefill kernel once per layer per chunk, no other kernel,
    and both launched."""
    from repro_torch.kernels.attn import ops
    st = e.stats()
    launches = dict(ops.LAUNCHES)
    want = {name: 0 for name in launches}
    want[decode_kernel] = e.cfg.num_layers * st["decode_steps"]
    want[prefill_kernel] = e.cfg.num_layers * st["prefill_chunks"]
    if launches != want or not (launches[decode_kernel]
                                and launches[prefill_kernel]) \
            or any(train_launches().values()):
        raise SystemExit(f"launches {launches}, expected {want}")
    return launches


def _statuses(e, uids) -> list:
    out = [e.status(u) for u in uids]
    if any(s is None for s in out):
        raise SystemExit(f"a request has no terminal status: {out}")
    return [s.value for s in out]


def phase_faults(eng, clean: dict) -> dict:
    """(a) Targeted faults on the paged int8 engine (P = 64): a NaN in
    request 1's logits at its fourth token, and a mantissa bit flipped in
    request 3's newest private page at step 16 (K5 and K6 read it next).
    Request 1 resolves FAILED with its three clean tokens, request 3
    drains to a terminal status, and every request no fault touched
    equals ``clean`` (the fault-free paged run's tokens)."""
    from repro_torch.serve import FaultHarness, KVBitFlip, LogitNaN
    fh = FaultHarness([LogitNaN(uid=1, token_idx=3),
                       KVBitFlip(step=16, uid=3, bit=6)])
    reset_all_launches()
    t0 = time.perf_counter()
    e, prompts = _robust_engine(eng, PAGE, eng.cfg.num_layers, faults=fh)
    uids = [e.submit(p, max_new=ROBUST_NEW) for p in prompts]
    e.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _attn_launches(e, "flash_decode_paged", "flash_prefill_paged")
    status = _statuses(e, uids)
    toks = [e.results[u].tolist() for u in uids]
    spared = [u for u in uids if u not in (1, 3)]
    out = {"wall_s": wall, "statuses": status, "launches": launches,
           "events": fh.log,
           "nan_victim_prefix_equal": toks[1] == clean[1][:3],
           "spared_equal": all(toks[u] == clean[u][:ROBUST_NEW]
                               for u in spared),
           "flip_victim_equal": toks[3] == clean[3][:len(toks[3])]}
    log(f"faults (paged): {json.dumps(out)}")
    if not (status[1] == "failed" and out["nan_victim_prefix_equal"]
            and status[3] in ("ok", "failed") and out["spared_equal"]
            and all(status[u] == "ok" for u in spared)
            and sorted(ev["kind"] for ev in fh.log)
            == ["bit_flip", "logit_nan"]):
        raise SystemExit("the targeted faults run failed its checks")
    return out


def phase_chaos(eng) -> dict:
    """(b) A ``chaos_plan`` sweep (seed ``CHAOS_SEED``: logit NaNs, bit
    flips, admission delays and a page squeeze) over the paged engine on
    an arena of ``CHAOS_PAGES`` pages: ``run()`` drains, every request
    ends terminal, at least one is preempted, and the harness log
    round-trips through JSON."""
    from repro_torch.serve import FaultHarness, chaos_plan
    fh = FaultHarness(chaos_plan(CHAOS_SEED, list(range(6)),
                                 n_steps=4 * ROBUST_NEW, squeeze_pages=4),
                      seed=CHAOS_SEED)
    reset_all_launches()
    t0 = time.perf_counter()
    e, prompts = _robust_engine(eng, PAGE, faults=fh, n_pages=CHAOS_PAGES)
    uids = [e.submit(p, max_new=ROBUST_NEW) for p in prompts]
    e.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _attn_launches(e, "flash_decode_paged", "flash_prefill_paged")
    summary = fh.summary()
    st = e.stats()
    out = {"wall_s": wall, "statuses": _statuses(e, uids),
           "launches": launches, "event_counts": summary["event_counts"],
           "preemptions": st["preemptions"],
           "drained": not (e._queue or e._prefilling or e._active.any()),
           **{k: st[k] for k in ("requests_failed", "prefill_chunks",
                                 "pages_allocated", "page_evictions")}}
    log(f"chaos (paged, {CHAOS_PAGES} pages): {json.dumps(out)}")
    if not (out["drained"] and st["preemptions"] >= 1
            and json.loads(json.dumps(summary)) == summary):
        raise SystemExit("the chaos sweep failed its checks")
    return out


def phase_admission(eng) -> dict:
    """(c) Admission on the slot-major chunked engine: a queue of 2 takes
    two of six submits and rejects four (empty results); a deadline of
    0 ms times every queued request out before any step; a runaway
    threshold of -1 quarantines every decoding request FAILED on its
    first decode step."""
    from repro_torch.serve import RequestStatus
    reset_all_launches()
    e, prompts = _robust_engine(eng, queue_cap=2)
    uids = [e.submit(p, max_new=ROBUST_NEW) for p in prompts]
    rejected = [u for u in uids if e.status(u) is RequestStatus.REJECTED]
    e.run()
    torch.cuda.synchronize()
    launches = _attn_launches(e, "flash_decode", "flash_prefill")
    cap = {"statuses": _statuses(e, uids), "rejected_at_submit": rejected,
           "requests_rejected": e.stats()["requests_rejected"],
           "launches": launches}
    ok = (rejected == uids[2:] and cap["requests_rejected"] == 4
          and cap["statuses"] == ["ok"] * 2 + ["rejected"] * 4
          and all(e.results[u].size == 0 for u in rejected)
          and all(e.results[u].size == ROBUST_NEW for u in uids[:2]))

    e, _ = _robust_engine(eng, deadline_ms=0.0)
    uids = [e.submit(p, max_new=ROBUST_NEW) for p in prompts]
    e.run()
    st = e.stats()
    dl = {"statuses": _statuses(e, uids),
          "requests_timed_out": st["requests_timed_out"],
          "decode_steps": st["decode_steps"]}
    ok &= (dl["statuses"] == ["timed_out"] * 6 and st["decode_steps"] == 0
           and all(e.results[u].size == 0 for u in uids))

    reset_all_launches()
    e, _ = _robust_engine(eng, runaway_ovf=-1.0)
    uids = [e.submit(p, max_new=ROBUST_NEW) for p in prompts[:2]]
    e.run()
    torch.cuda.synchronize()
    launches = _attn_launches(e, "flash_decode", "flash_prefill")
    run = {"statuses": _statuses(e, uids),
           "tokens": [e.results[u].size for u in uids],
           "requests_failed": e.stats()["requests_failed"],
           "launches": launches}
    ok &= (run["statuses"] == ["failed"] * 2 and run["tokens"] == [1, 1])
    out = {"queue_cap": cap, "deadline_0": dl, "runaway": run}
    log(f"admission (slot-major): {json.dumps(out)}")
    if not ok:
        raise SystemExit("the admission run failed its checks")
    return out


def phase_observed(eng) -> dict:
    """(d) A tracer and a numerics log on the chunked int8 run, stepped
    by hand: the trace passes ``validate_trace`` with one
    ``decode_step`` span per decode step, and every numerics record
    falls on the ``NUMERICS_EVERY`` cadence with the exponents the
    pool's ``k_e`` holds for its slot at that step."""
    from repro_torch.obs import NumericsLog, Tracer, validate_trace
    tracer, num = Tracer(), NumericsLog()
    reset_all_launches()
    e, prompts = _robust_engine(eng, tracer=tracer, numerics_log=num,
                                numerics_every=NUMERICS_EVERY)
    uids = [e.submit(p, max_new=ROBUST_NEW) for p in prompts]
    t0 = time.perf_counter()
    bad = []
    while e._queue or e._prefilling or e._active.any():
        n = len(num.records)
        e.step()
        for rec in num.records[n:]:
            stage, bkey = rec["entry"].split("/", 1)
            k_e = e._pool[stage][bkey]["k_e"][:, rec["slot"]].tolist()
            if rec["step"] != e._step_idx or rec["k_e"] != k_e:
                bad.append(rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _attn_launches(e, "flash_decode", "flash_prefill")
    st = e.stats()
    trace = tracer.to_chrome()
    validate_trace(trace)
    spans = [ev for ev in trace["traceEvents"]
             if ev["name"] == "decode_step" and ev["ph"] == "X"]
    steps = sorted({rec["step"] for rec in num.records})
    out = {"wall_s": wall, "statuses": _statuses(e, uids),
           "launches": launches, "trace_events": len(trace["traceEvents"]),
           "decode_step_spans": len(spans),
           "decode_steps": st["decode_steps"],
           "numerics_records": len(num.records), "sampled_steps": steps,
           "records_off_the_pool": len(bad)}
    log(f"observed (slot-major, traced): {json.dumps(out)}")
    if not (len(spans) == st["decode_steps"] > 0 and num.records
            and not bad and all(s % NUMERICS_EVERY == 0 for s in steps)
            and out["statuses"] == ["ok"] * 6):
        raise SystemExit("the traced run failed its checks")
    return out


def phase_robust_ops(eng, greedy_ops: int) -> dict:
    """(e) Device operations of one engine decode step (4 slots at
    position 300, greedy, the chunked int8 pool) with none of the new
    options, and with a fault harness and a runaway threshold.  The bare
    step must issue exactly the model's step and the sampler's tail
    (``_sample`` on its logits, the host copies of the tokens, positions
    and append mask), as before the options existed; the options must
    add operations (``tools/serve_step_ops.py`` splits them by option).
    ``greedy_ops`` (the model's step and the sampler,
    :func:`phase_prng_launches`, at the serving run's depth) is printed
    beside them: that count moves by a few operations run to run."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import FaultHarness
    out = {"decode_step_and_sample": greedy_ops,
           "layers": ROBUST_LAYERS}
    for tag, opts in (("bare", {}),
                      ("harness_and_runaway", {"faults": FaultHarness([]),
                                               "runaway_ovf": 1.0})):
        e, _ = _robust_engine(eng, **opts)
        e._pos[:] = 300
        e._active[:] = True
        nan_mask = np.zeros(e.max_slots, bool) if "faults" in opts else None
        out[tag] = device_ops(
            lambda e=e, m=nan_mask: e._decode_impl(e._dev(e._active), m))
        if tag == "bare":
            def tail(e=e):
                with torch.no_grad():
                    logits, _, e._pool = T.decode_step(
                        e.cfg, e.policy, e.params, e._pool, e._dev(e._tok),
                        e._dev(e._pos), e.exps, kv_codec=e.codec,
                        append_mask=e._dev(e._active))
                    e._sample(logits)
            out["model_step_and_tail"] = device_ops(tail)
        del e
    out["added_by_options"] = out["harness_and_runaway"] - out["bare"]
    log(f"engine decode step device operations: {json.dumps(out)}")
    if out["bare"] != out["model_step_and_tail"] or \
            not out["added_by_options"] > 0:
        raise SystemExit("an engine decode step without the options issues "
                         "other device operations than its model step and "
                         "sampler tail, or an option adds none")
    return out


def phase_cli_chaos() -> dict:
    """(f) The serve CLI's bare chaos demo on the card (``--arch
    llama3_8b --chaos 0``: the smoke config, an int8 pool, pages of 4 on
    a short arena, a controller cadence of 4) with every output file:
    each parses, the trace passes ``validate_trace``, and every request
    ends terminal."""
    import os
    import tempfile
    from repro_torch.launch import serve
    from repro_torch.obs import read_jsonl, validate_trace
    with tempfile.TemporaryDirectory() as d:
        f = {k: os.path.join(d, k) for k in ("faults.json", "trace.json",
                                             "numerics.jsonl",
                                             "metrics.jsonl")}
        t0 = time.perf_counter()
        e = serve.main(["--arch", "llama3_8b", "--chaos", "0",
                        "--fault-log", f["faults.json"],
                        "--trace-out", f["trace.json"],
                        "--numerics-log", f["numerics.jsonl"],
                        "--metrics-out", f["metrics.jsonl"]])
        wall = time.perf_counter() - t0
        with open(f["faults.json"]) as fp:
            faults = json.load(fp)
        with open(f["trace.json"]) as fp:
            trace = json.load(fp)
        validate_trace(trace)
        numerics = read_jsonl(f["numerics.jsonl"])
        metrics = read_jsonl(f["metrics.jsonl"])
    out = {"wall_s": wall, "arch": e.cfg.name,
           "statuses": _statuses(e, range(4)),
           "event_counts": faults["event_counts"],
           "trace_events": len(trace["traceEvents"]),
           "numerics_records": len(numerics),
           "metrics_series": len(metrics[-1]["metrics"]),
           "preemptions": e.stats()["preemptions"]}
    log(f"cli chaos demo: {json.dumps(out)}")
    if not (numerics and metrics and e.cfg.name.endswith("smoke")):
        raise SystemExit("the CLI's chaos demo failed its checks")
    return out


def phases_robustness(eng, clean: dict, greedy_ops: int, t0) -> dict:
    """Phases (a)-(f), on the serving run's weights; no new weights."""
    out = {"faults": phase_faults(eng, clean), "chaos": phase_chaos(eng)}
    log(f"[{time.perf_counter() - t0:.0f}s] faults and chaos served")
    out["admission"] = phase_admission(eng)
    out["observed"] = phase_observed(eng)
    out["decode_ops"] = phase_robust_ops(eng, greedy_ops)
    out["cli_chaos"] = phase_cli_chaos()
    log(f"[{time.perf_counter() - t0:.0f}s] admission, tracing and the CLI "
        f"chaos demo served")
    log("robustness: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# sharded serving and compressed training (repro_torch.dist, launch/mesh)
# ---------------------------------------------------------------------------

WORLD = 2                   # ranks of the sharded phases, on the one card
SHARD_LAYERS = ROBUST_LAYERS    # llama3 layers of the TP and CP phases
CP_PROMPT, CP_MAX_LEN = 1500, 2048  # a 1,024-slot window a rank at CP = 2
# granite-moe-1b's layers in the EP phase: 12 of its 24 (full width; the
# cut is the run's time limit's, as LLAMA_LAYERS)
GRANITE_EP_LAYERS = 12
# the compressed LM run's steps; a checkpoint every 2, the kill at cursor
# 5, where the save of 4 has begun after the save of 2 was waited for:
# the resume is from 2 or 4
COMPRESS_STEPS, COMPRESS_KILL = 6, 5


def _serve_job(job: dict, tp: int = 1, cp: int = 1) -> dict:
    """One serving job (a config, weights, policy, options, prompts) on
    an engine; with ``tp``/``cp`` > 1 a sharded engine over the current
    world's serve mesh (which checks every step that the ranks sampled
    the same tokens).  Counts the attention kernels from 0 around the run.
    Returns the tokens, statuses, launches and the pool's local shape;
    with ``job["logits_vs"]`` (another policy) also the largest
    difference of prompt 0's first-step logits between the job's policy
    and that one."""
    from repro_torch.dist import serve_pod_ctx
    from repro_torch.kernels.attn import ops
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine
    mesh = M.make_serve_mesh(tp=tp, cp=cp) if tp * cp > 1 else None
    dist = serve_pod_ctx(tp=tp, cp=cp) if mesh is not None else None
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    eng = ServeEngine(job["cfg"], job["policy"], job["params"],
                      max_slots=job["slots"], max_len=job["max_len"],
                      options=job["options"], device="cuda", dist=dist,
                      mesh=mesh)
    uids = [eng.submit(p, max_new=job["max_new"]) for p in job["prompts"]]
    eng.run()
    torch.cuda.synchronize()
    res = {"wall_s": time.perf_counter() - t0,
           "tokens": [eng.results[u].tolist() for u in uids],
           "statuses": [eng.status(u).value for u in uids],
           "launches": dict(ops.LAUNCHES),
           "decode_steps": eng.stats()["decode_steps"],
           "prefill_chunks": eng.stats()["prefill_chunks"]}
    entry = next(e for sc in eng.kv.pool.values() for e in sc.values()
                 if "pos" in e)
    k = entry["k_m"] if "k_m" in entry else entry["k"]
    res["kv_heads"], res["window"] = int(k.shape[3]), int(k.shape[2])
    if "bt" not in entry:
        res["window"] = int(entry["pos"].shape[2])
    if job.get("logits_vs") is not None:
        toks = torch.as_tensor(job["prompts"][0], device="cuda")[None]
        with M.use_mesh(mesh), torch.no_grad():
            lg = [T.prefill(job["cfg"], pol, job["params"], {"tokens": toks},
                            eng.exps, max_cache_len=job["max_len"],
                            dist=dist)[0]
                  for pol in (job["policy"], job["logits_vs"])]
        res["first_logits_max_abs_diff"] = float((lg[0] - lg[1]).abs().max())
        res["first_logits_max_abs"] = float(lg[1].abs().max())
    return res


def _shard_rank(rank: int, jobs) -> dict:
    """A rank of the sharded phases' world: every job at its degrees.
    The weights arrive from the parent through CUDA IPC (no copy); the
    kernels load from the parent's build."""
    torch.cuda.set_device(0)
    out = {}
    for name, job in jobs:
        out[name] = _serve_job(job, job["tp"], job["cp"])
        torch.cuda.empty_cache()
    return out


def _shard_jobs(eng):
    """The sharded phases' jobs on the serving run's weights (the first
    ``SHARD_LAYERS`` layers, views) and granite-moe-1b's."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.launch.serve import prompt
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineOptions
    cfg = dataclasses.replace(eng.cfg, num_layers=SHARD_LAYERS)
    params = {**eng.params,
              "stages": _first_layers(eng.params["stages"], SHARD_LAYERS)}
    int8 = EngineOptions(cache_bits=8)
    jobs = []
    for page in (0, PAGE):
        prompts = _serve_prompts(cfg, page)
        jobs.append((f"tp2{'_paged' if page else ''}", dict(
            cfg=cfg, params=params, prompts=prompts, slots=4,
            max_len=max(map(len, prompts)) + ROBUST_NEW, max_new=ROBUST_NEW,
            options=int8, tp=2, cp=1,
            policy=PrecisionPolicy("dfxp", fused_decode=True,
                                   prefill_chunk=page or 128,
                                   page_size=page))))
    jobs.append(("cp2", dict(
        cfg=cfg, params=params, slots=2, max_len=CP_MAX_LEN,
        max_new=ROBUST_NEW, options=int8, tp=1, cp=2,
        prompts=[prompt(200 + i, CP_PROMPT + 37 * i, cfg.vocab_size)
                 for i in range(2)],
        policy=PrecisionPolicy("float32", prefill_chunk=128))))
    gcfg = dataclasses.replace(configs.get("granite_moe_1b"),
                               num_layers=GRANITE_EP_LAYERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gparams = T.init_params(gcfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"granite-moe-1b ({GRANITE_EP_LAYERS} layers) weights drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    gpol = PrecisionPolicy("dfxp", fused_decode=True)
    gprompts = [prompt(i, (96, 200, 384)[i % 3], gcfg.vocab_size)
                for i in range(6)]
    g = dict(cfg=gcfg, params=gparams, prompts=gprompts, slots=4,
             max_len=384 + ROBUST_NEW, max_new=ROBUST_NEW, options=int8,
             tp=2, cp=1, policy=gpol)
    jobs.append(("ep", g))
    # int8 lanes: statuses and the first-step logits only (no unsharded
    # twin), so two requests of 4 tokens
    jobs.append(("ep_a2a8", dict(
        g, prompts=gprompts[:2], max_new=4, logits_vs=gpol,
        policy=dataclasses.replace(gpol, a2a_compress_bits=8))))
    return jobs


def phase_sharded(eng) -> dict:
    """Sharded serving in one world of ``WORLD`` ranks on the one card
    (gloo: the ranks share it), the kernels built once by
    :func:`phase_build` before any rank starts:

    1. TP = 2 slot-major on the serving weights' first ``SHARD_LAYERS``
       layers (DFXP-10, int8 pool, fused decode, C = 128, the six serving
       prompts, ``ROBUST_NEW`` tokens): each rank holds 4 of the 8 kv
       heads; its tokens equal the unsharded engine's, bit for bit, and
       its K3 and K4 launches the unsharded run's;
    2. the same over the paged pool (P = C = 64, the paged prompts): K5
       and K6;
    3. CP = 2: two slots of ~1,500-token prompts, ``max_len`` 2048 (a
       1,024-slot window a rank), int8 pool, float32, C = 128: tokens
       equal the unsharded run's;
    4. EP (TP = 2) on granite-moe-1b at full width, its experts halved
       over the ranks: greedy tokens equal the unsharded run's; a second
       run with ``a2a_compress_bits=8`` (two of the prompts, 4 tokens)
       resolves every request ``ok``, and its first-step logits' largest
       difference from the uncompressed run's is printed.

    Every rank checks each step that all ranks sampled the same tokens.
    The unsharded runs are this process's, over the same weights."""
    from repro_torch.launch import mesh as M
    log(f"sharded phases: backend rule: {M.BACKEND_RULE}")
    backend = M.backend_for("cuda", WORLD)
    if backend != "gloo":
        raise SystemExit(f"{WORLD} ranks on {torch.cuda.device_count()} "
                         f"card(s) should take gloo, got {backend}")
    jobs = _shard_jobs(eng)
    t0 = time.perf_counter()
    import os
    ranks = M.spawn(_shard_rank, WORLD, jobs, backend=backend,
                    timeout_s=600.0,
                    threads=max(1, (os.cpu_count() or 1) // WORLD))
    world_s = time.perf_counter() - t0
    torch.cuda.ipc_collect()            # the weights the ranks mapped
    log(f"sharded world: {WORLD} ranks ({backend}) ran {len(jobs)} jobs in "
        f"{world_s:.1f}s")
    out = {"world_s": world_s, "backend": backend, "jobs": {}}
    bad = []
    for name, job in jobs:
        res = {"ranks": [r[name] for r in ranks]}
        out["jobs"][name] = res
        if name == "ep_a2a8":
            for rank, got in enumerate(res["ranks"]):
                log(f"{name} rank {rank}: statuses {got['statuses']}, "
                    f"launches {got['launches']}, {got['wall_s']:.1f}s; "
                    f"first-step logits vs the uncompressed run's max abs "
                    f"diff {got['first_logits_max_abs_diff']:.4e} (logits "
                    f"up to {got['first_logits_max_abs']:.3f})")
                if any(s != "ok" for s in got["statuses"]) or not \
                        math.isfinite(got["first_logits_max_abs_diff"]):
                    bad.append(f"{name} rank {rank}")
            continue
        t0 = time.perf_counter()
        want = _serve_job(job)
        torch.cuda.empty_cache()
        res.update(unsharded=want, unsharded_s=time.perf_counter() - t0)
        for rank, got in enumerate(res["ranks"]):
            log(f"{name} rank {rank}: kv heads {got['kv_heads']} (of "
                f"{want['kv_heads']}), window {got['window']} (of "
                f"{want['window']}), statuses {got['statuses']}, launches "
                f"{got['launches']} (unsharded {want['launches']}), "
                f"{got['wall_s']:.1f}s (unsharded {want['wall_s']:.1f}s)")
            if any(s != "ok" for s in got["statuses"]):
                bad.append(f"{name} rank {rank}: statuses")
            same = got["tokens"] == want["tokens"]
            log(f"{name} rank {rank}: tokens equal to the unsharded run's: "
                f"{same}")
            if not same:
                bad.append(f"{name} rank {rank}: tokens")
            if name.startswith("tp") and got["launches"] != want["launches"]:
                bad.append(f"{name} rank {rank}: launches")
            if name.startswith("tp") and not (
                    got["kv_heads"] * 2 == want["kv_heads"]
                    and any(got["launches"].values())):
                bad.append(f"{name} rank {rank}: kv heads / launches")
            if name == "cp2" and got["window"] * 2 != want["window"]:
                bad.append(f"{name} rank {rank}: window")
    if bad:
        raise SystemExit(f"sharded serving failed: {bad}")
    return out


def phase_train_compressed(lm: dict) -> dict:
    """The trainer CLI on LM_100M (the LM phase's argv, DFXP 10/12, K1 and
    K2) with ``--grad-compress-bits 8``: a ``COMPRESS_STEPS``-step run
    here whose step-1 loss equals the uncompressed run's (compression
    acts after the gradient) and whose K1 launches a step are the
    uncompressed step's plus one per parameter leaf of at least
    ``MIN_SIZE`` elements (the deterministic rounding of
    ``compress_decompress`` takes K1 under the same threshold as every
    other site); the same argv killed at cursor ``COMPRESS_KILL`` in a
    subprocess that runs beside the solo run (137) and resumed here ends with the solo run's final loss and
    checkpoint, bit for bit, the error-feedback residuals (``ef/...``)
    among its leaves."""
    import shutil
    import tempfile
    from repro_torch.examples import train_lm
    from repro_torch.models import transformer as T
    from repro_torch.train.state import leaves_with_path
    train_lm.register()
    cfg = train_lm.LM_100M
    tmp = tempfile.mkdtemp(prefix="lm_ef_")
    res, killed = {}, None
    try:
        argv = LM_ARGV + LM_DFXP + ["--steps", str(COMPRESS_STEPS),
                                    "--ckpt-every", "2",
                                    "--grad-compress-bits", "8"]
        # the run to kill, in a subprocess on the card beside the solo run
        # here (its own process: its launches do not reach these counts)
        t0 = time.perf_counter()
        killed = subprocess.Popen(
            [sys.executable, "-c", LM_CLI,
             str(Path(__file__).resolve().parent / "src"), *argv,
             "--ckpt-dir", f"{tmp}/crash", "--kill-at", str(COMPRESS_KILL)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        reset_all_launches()
        solo, _ = _lm_in_process(argv + ["--ckpt-dir", f"{tmp}/solo"])
        res["solo_s"] = time.perf_counter() - t0
        launches = train_launches()
        k1s, k2s = lm_site_launches(cfg, 16, 128)
        meta = T.init_params(cfg, 0, device="meta")
        big = sum(1 for _, x in leaves_with_path(meta)
                  if x.numel() >= MIN_SIZE)
        n_leaves = len(leaves_with_path(meta))
        want = {"dfxp_quantize": COMPRESS_STEPS * (k1s + big),
                "qmatmul": COMPRESS_STEPS * k2s}
        step1, ref1 = solo["losses"].get(1), lm["losses"]["dfxp"][0]
        res.update(losses=solo["losses"], launches=launches,
                   expected_launches=want, leaves=n_leaves,
                   leaves_through_k1=big, step1=step1,
                   uncompressed_step1=ref1)
        log(f"compressed LM: {res['solo_s']:.1f}s, losses "
            f"{solo['losses']}, step 1 {step1!r} vs uncompressed {ref1!r}; "
            f"launches {launches} (expected {want}: {k1s} + {big} of "
            f"{n_leaves} leaves a step)")
        if not (step1 == ref1 and launches == want
                and solo["summary"]["steps_committed"] == COMPRESS_STEPS):
            raise SystemExit("the compressed LM run failed its checks")
        _, err = killed.communicate(timeout=300)
        code = killed.returncode
        code = 128 - code if code < 0 else code     # a signal's shell code
        t0 = time.perf_counter()
        resumed, _ = _lm_in_process(argv + ["--ckpt-dir", f"{tmp}/crash"])
        res["crash_resume_s"] = time.perf_counter() - t0
        sa, a = _ckpt_leaves(f"{tmp}/solo")
        sb, b = _ckpt_leaves(f"{tmp}/crash")
        ef = [k for k in a if k.startswith("ef/")]
        same = (sa == sb == COMPRESS_STEPS and a.keys() == b.keys()
                and all(np.array_equal(a[k], b[k]) for k in a))
        res.update(kill_exit=code, resumed_from=resumed["resumed_from"],
                   resumed_final_loss=resumed["summary"]["final_loss"]
                   if resumed["summary"] else None,
                   final_loss=solo["summary"]["final_loss"],
                   ckpt_leaves=len(a), ef_leaves=len(ef),
                   ckpt_bit_equal=same)
        log(f"compressed LM kill at {COMPRESS_KILL}: exit {code}, resumed "
            f"from cursor "
            f"{res['resumed_from']}, final loss "
            f"{res['resumed_final_loss']!r} vs solo "
            f"{res['final_loss']!r}; checkpoint {len(a)} leaves ({len(ef)} "
            f"residuals) bit for bit {same}; {res['crash_resume_s']:.1f}s")
        if not (code == 137 and same and ef and resumed["resumed_from"]
                and any(a[k].any() for k in ef)
                and res["resumed_final_loss"] == res["final_loss"]):
            raise SystemExit(f"the compressed LM resume failed: "
                             f"{err[-2000:]}")
    finally:
        if killed is not None and killed.poll() is None:
            killed.kill()
            killed.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return res


CLI_TP_ARGV = ["--smoke", "--num-requests", "3", "--slots", "2",
               "--prompt-len", "6,10", "--max-new", "4"]


def start_cli_tp():
    """Start the serve CLI with ``--smoke --tp 2`` in a subprocess: on the
    card it spawns its own world of two ranks (gloo, one card).  It runs
    beside the phases that follow it; :func:`phase_cli_tp` collects it."""
    src = str(Path(__file__).resolve().parent / "src")
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv.pop(1)); "
         "from repro_torch.launch.serve import main; main(sys.argv[1:])",
         src, "--tp", "2", *CLI_TP_ARGV],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_cli_tp(started) -> dict:
    """The ``--tp 2`` CLI run of :func:`start_cli_tp` prints the tokens of
    the run without ``--tp`` (here, in this process)."""
    import contextlib
    import io
    from repro_torch.launch import serve
    t0, proc = started
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(CLI_TP_ARGV)
        want = [ln for ln in buf.getvalue().splitlines()
                if ln.startswith("sample:")]
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    got = [ln for ln in out.splitlines() if ln.startswith("sample:")]
    res = {"exit": proc.returncode, "wall_s": time.perf_counter() - t0,
           "sample": got, "unsharded_sample": want,
           "spawned": "spawning 2 ranks (gloo" in out}
    log(f"serve CLI --tp 2: {json.dumps(res)}")
    if not (proc.returncode == 0 and got == want and len(got) == 1
            and res["spawned"]):
        raise SystemExit(f"the serve CLI --tp 2 failed: {out[-2000:]}"
                         f"{err[-2000:]}")
    return res


def phases_dist(eng, lm: dict, t0, cli) -> dict:
    """Sharded serving, compressed training and the CLI's --tp (``cli``,
    from :func:`start_cli_tp`, whose subprocess runs beside them)."""
    out = {"sharded": phase_sharded(eng)}
    log(f"[{time.perf_counter() - t0:.0f}s] sharded serving served")
    out["compressed"] = phase_train_compressed(lm)
    out["cli_tp"] = phase_cli_tp(cli)
    log(f"[{time.perf_counter() - t0:.0f}s] compressed training trained, "
        f"CLI --tp served")
    log("dist: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# the token-in families: MoE (granite, llama4), SSM (mamba2), hybrid
# (zamba2), windowed and qk-norm dense (gemma3, qwen3), phi3
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the multi-pod dry run: repro_torch.launch.dryrun on the meta device
# ---------------------------------------------------------------------------

# one cell of each kind, each on both meshes: ~25 s of traces on a
# sandbox CPU, in a subprocess beside the card phases
DRYRUN_CELLS = (("granite_moe_1b", "train_4k"),
                ("seamless_m4t_medium", "prefill_32k"),
                ("llama3_8b", "decode_32k"), ("zamba2_1p2b", "long_500k"))
DRYRUN_CODE = (
    "import json, sys, time; t0 = time.perf_counter(); "
    "sys.path.insert(0, sys.argv[1]); import torch; "
    "torch.set_num_threads(1); from repro_torch.launch import dryrun; "
    "recs = [dryrun.run_cell(a, s, mp, ops_dir='') for a, s in "
    "json.loads(sys.argv[2]) for mp in (False, True)]; "
    "print(json.dumps({'records': recs, 'wall_s': time.perf_counter() - t0,"
    " 'cuda_initialized': torch.cuda.is_initialized()}))")


def start_dryrun():
    """The production cells' dry run, in a subprocess from here on."""
    src = str(Path(__file__).resolve().parent / "src")
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CODE, src, json.dumps(DRYRUN_CELLS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _state_bytes(state) -> int:
    return sum(t.nbytes for t in _state_leaves(state).values())


def _train_cell(cfg, B: int, S: int, opt) -> dict:
    """The dry run's record of one trainer step of ``cfg`` at ``B x S``
    (DFXP 10/12, one microbatch, no remat, whole cross-entropy) on a 1x1
    debug mesh."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.dist import ShardingRules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(1, 1)
    cell = dryrun.make_cell(cfg, ShapeSpec("card", S, B, "train"),
                            PrecisionPolicy("dfxp", comp_width=10,
                                            update_width=12),
                            mesh, ShardingRules(mesh), opt=opt)
    return dryrun.record(cell, dryrun.trace(cell), arch=cfg.name,
                         shape_name=f"train_{B}x{S}")


def phase_dryrun(started, smi: str, granite: dict, lm: dict) -> dict:
    """Phase 21: the production cells' records (the subprocess of
    :func:`start_dryrun`), and the trainer runs' cells held to the card:
    the state bytes exactly, the peak printed."""
    from repro_torch import configs
    from repro_torch.examples import train_lm
    from repro_torch.optim.opt import OptConfig
    total = torch.cuda.get_device_properties(0).total_memory
    res = {"card": smi, "total_memory": total, "train": {}}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for name, cfg, B, S, opt, ran in (
            ("granite_moe_1b", configs.get("granite_moe_1b"), 8, 64,
             OptConfig(kind="sgd", lr=0.01, lr_decay_steps=1000), granite),
            ("lm_100m", train_lm.LM_100M, 16, 128,
             OptConfig(kind="adamw", lr=3e-3, lr_decay_steps=1000), lm)):
        t0 = time.perf_counter()
        rec = _train_cell(cfg, B, S, opt)
        g = rec["memory_groups"]
        state = g["params"] + g["opt"] + g["scale"] + g["step"]
        peak = rec["per_device"]["argument_bytes"] + \
            rec["per_device"]["temp_bytes"]
        res["train"][name] = row = {
            "state_bytes_predicted": state,
            "state_bytes_card": ran["state_bytes"],
            "peak_predicted": peak,
            "peak_measured": ran["peak_memory_bytes"],
            "peak_measured_over_predicted": ran["peak_memory_bytes"] / peak,
            "groups": g, "flops_global": rec["flops_global"],
            "trace_s": rec["trace_s"], "wall_s": time.perf_counter() - t0}
        log(f"dryrun {name} ({B} x {S}, 1x1): state {state} bytes "
            f"predicted, {ran['state_bytes']} held on the card; peak "
            f"predicted {peak / 1e9:.3f} GB (params {g['params'] / 1e9:.3f}"
            f", opt {g['opt'] / 1e9:.3f}, scales {g['scale'] / 1e6:.3f} MB,"
            f" batch {g['batch'] / 1e6:.3f} MB, temp {g['temp'] / 1e9:.3f}"
            f" GB), measured {ran['peak_memory_bytes'] / 1e9:.3f} GB "
            f"({row['peak_measured_over_predicted']:.2f}x); trace "
            f"{rec['trace_s']:.1f} s [{smi}]")
        if state != ran["state_bytes"]:
            raise SystemExit(f"the dry run's {name} state bytes are not "
                             f"the card's")
    torch.cuda.synchronize()
    res["memory_allocated_change"] = torch.cuda.memory_allocated() - before
    if res["memory_allocated_change"]:
        raise SystemExit("the dry run allocated card memory")
    t0, proc = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    res["collected_after_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        log(err[-3000:])
        raise SystemExit("the dry run's production cells failed")
    got = json.loads(out.strip().splitlines()[-1])
    res["cuda_initialized"] = got["cuda_initialized"]
    res["subprocess_wall_s"] = got["wall_s"]
    res["cells"] = []
    for r in got["records"]:
        pd = r["per_device"]
        gb = (pd["argument_bytes"] + pd["temp_bytes"]) / 1e9
        res["cells"].append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "ok": r["ok"], "per_device_gb": gb,
            "fits": gb * 1e9 <= total, "trace_s": r["trace_s"],
            "tflops_per_device": r["flops"] / 1e12,
            "collective_gb": r["collectives"]["total_bytes"] / 1e9,
            "cuda_initialized": r["cuda_initialized"]})
        log(f"dryrun {r['arch']} {r['shape']} {r['mesh']}: ok {r['ok']}, "
            f"{gb:.3f} GB a device (arguments + temp) of the card's "
            f"{total / 1e9:.1f}, {r['flops'] / 1e12:.3f} TF a device, "
            f"collectives {r['collectives']['total_bytes'] / 1e9:.3f} GB, "
            f"trace {r['trace_s']} s (CPU)")
    if not (len(res["cells"]) == 2 * len(DRYRUN_CELLS)
            and all(c["ok"] and not c["cuda_initialized"]
                    for c in res["cells"])
            and not got["cuda_initialized"]):
        raise SystemExit("a dry-run cell failed or created a CUDA context")
    log("dryrun: " + json.dumps(res))
    return res


FAMILY_ARCHS = ("llama3_8b", "qwen3_14b", "phi3_medium_14b", "gemma3_27b",
                "llama4_maverick_400b", "granite_moe_1b", "mamba2_370m",
                "zamba2_1p2b", "seamless_m4t_medium", "qwen2_vl_72b")
FAMILY_SERVE = ["--num-requests", "6", "--slots", "4", "--prompt-len",
                "96,200,384", "--max-new", "16", "--cache-bits", "8",
                "--fused-decode", "--device", "cuda"]
# granite is asked for chunk 128: the engine keeps MoE on whole prompts
GRANITE_SERVE = ["--arch", "granite_moe_1b", *FAMILY_SERVE,
                 "--prefill-chunk", "128"]
# gemma3-27b at full width and 6 of its 62 layers (one 5-local + 1-global
# super-block): prompts past the local window of 1024, so the local rings
# wrap and K3 and K4 run windowed, p0 > window included
GEMMA_LAYERS = 6
GEMMA_SERVE = ["--num-requests", "4", "--slots", "4", "--prompt-len",
               "1100,1150,1200,1130", "--max-new", "16", "--cache-bits", "8",
               "--fused-decode", "--prefill-chunk", "128", "--device", "cuda"]
# the trainer with no --arch: granite-moe-1b at full width and depth,
# batch 8 x 64, SGD lr 0.01, DFXP 10/12 with 5 calibration steps
GRANITE_TRAIN = ["--fused-matmul", "--steps", "20", "--log-every", "1",
                 "--device", "cuda"]
GRANITE_F32 = ["--arithmetic", "float32", "--calibrate-steps", "0"]
# The reference launcher's losses at steps 1-10 at the same argv, granite
# at full width with 2 of its 24 layers ("granite_moe_1b_l2"), jax 0.9.0 on
# a CPU: `python tools/ref_family_train.py` (the port on the CPU at the
# same argv, `--port`: float32 equal to 4 decimals at every step; DFXP
# 1.4e-3 off at step 1 and 2.7e-3 at step 10, flipped rounding ties).
REF_GRANITE = {
    "float32": [10.9991, 11.0209, 11.037, 11.0144, 11.0112, 10.9998,
                11.0229, 10.991, 11.0595, 10.9678],
    "dfxp": [11.0027, 11.0217, 11.0326, 11.0174, 11.0101, 11.004, 11.0176,
             10.9899, 11.0609, 10.968]}
REF_GRANITE_GROUPS = 69
# bounds on |card - reference| at steps 1 and 10, set before the card run
# from the CPU gap above: float32 1e-3 / 1e-2, DFXP 1e-2 / 3e-2
GRANITE_TOL = {"float32": (1e-3, 1e-2), "dfxp": (1e-2, 3e-2)}
# full-width decode logits against the full forward (float32, a capacity
# that drops no token, f32 pool): the same sums in other orders
FAMILY_DECODE_TOL = 1e-3


def register_cut(arch: str, layers: int) -> str:
    """Register ``<arch>_l<layers>``: the arch's full-width config with its
    depth cut, as the LM example registers LM_100M.  Returns its name."""
    import dataclasses
    import types
    from repro_torch import configs
    name = f"{arch}_l{layers}"
    cfg = dataclasses.replace(configs.get(arch), name=f"{arch}-l{layers}",
                              num_layers=layers)
    sys.modules[f"repro_torch.configs.{name}"] = types.SimpleNamespace(
        CONFIG=cfg, SMOKE=cfg)
    return name


def attn_calls(cfg) -> tuple:
    """(self-attention sub-block applications, the windowed ones among
    them) of one token step: each decoder stage's count times its
    attention blocks (an encoder does not run at decode)."""
    from repro_torch.models import transformer as T
    n = w = 0
    for stage in T.build_stages(cfg):
        if not stage.decoder:
            continue
        for blk in stage.blocks:
            if blk.kind == "attn":
                n += stage.count
                w += stage.count if blk.window else 0
    return n, w


class WindowSpy:
    """Counts the attention wrappers' calls that pass a window, in place
    around ``repro_torch.kernels.attn.ops`` (the codecs call the module's
    functions), for a ``with`` block."""

    def __init__(self):
        self.calls = {"flash_decode": 0, "flash_prefill": 0}

    def __enter__(self):
        from repro_torch.kernels.attn import ops
        self.saved = {n: getattr(ops, n) for n in self.calls}
        for n, fn in self.saved.items():
            def spy(*a, _fn=fn, _n=n, **kw):
                if kw.get("window"):
                    self.calls[_n] += 1
                return _fn(*a, **kw)
            setattr(ops, n, spy)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.attn import ops
        for n, fn in self.saved.items():
            setattr(ops, n, fn)


def phase_family_kernels():
    """K3 and K4 against their plain versions at the shapes the families'
    main paths give them, over the int8 pool, timed (kernel, plain, and
    the bound from this case's bytes and operations): K3 at granite's
    heads (K=8, G=2, hd=64) and zamba2's (K=32, G=1, hd=64) over a
    400-slot ring, and at gemma3-27b's (K=16, G=2, hd=128) over a local
    ring of 1024 that has wrapped (window 1024) and a global one of 1216;
    K4 at gemma3's heads, a 128-row chunk at p0 = 1152 > window with 48
    valid rows over the wrapped local ring, and at p0 = 1024 over the
    global one.  ``library_ms``: SDPA on the f32 case of the same shape
    and window mask (the yardstick of the kernel table's other rows)."""
    from repro_torch.kernels.attn import cases

    fills = [112, 216, 400, 300]
    gfills = [1116, 1166, 1216, 1146]
    shapes = {
        "k3_granite": ("flash_decode", k3, k3_plain, cases.decode_cost,
                       sdpa_decode,
                       lambda s, w=8: cases.decode_case(
                           4, 400, 8, 2, 64, w, fill=fills, seed=s)),
        "k3_zamba2": ("flash_decode", k3, k3_plain, cases.decode_cost,
                      sdpa_decode,
                      lambda s, w=8: cases.decode_case(
                          4, 400, 32, 1, 64, w, fill=fills, seed=s)),
        "k3_gemma3_local": ("flash_decode", k3, k3_plain, cases.decode_cost,
                            sdpa_decode,
                            lambda s, w=8: cases.decode_case(
                                4, 1024, 16, 2, 128, w, fill=gfills,
                                window=1024, seed=s)),
        "k3_gemma3_global": ("flash_decode", k3, k3_plain,
                             cases.decode_cost, sdpa_decode,
                             lambda s, w=8: cases.decode_case(
                                 4, 1216, 16, 2, 128, w, fill=gfills,
                                 seed=s)),
        "k4_gemma3_local": ("flash_prefill", k4, k4_plain,
                            cases.prefill_route_cost, sdpa_prefill,
                            lambda s, w=8: cases.prefill_case(
                                1, 128, 1024, 16, 2, 128, w, p0=[1152],
                                n_valid=[48], window=1024, seed=s)),
        "k4_gemma3_global": ("flash_prefill", k4, k4_plain,
                             cases.prefill_route_cost, sdpa_prefill,
                             lambda s, w=8: cases.prefill_case(
                                 1, 128, 1216, 16, 2, 128, w, p0=[1024],
                                 n_valid=[128], seed=s)),
    }
    out = {}
    for name, (kname, fn, plain, cost, library, make) in shapes.items():
        a = make(0)
        got, want = fn(a), plain(a)
        err = float((got - want).abs().max())
        log(f"{name}: max_abs_err {err:.3e} against the plain version")
        if not (torch.isfinite(got).all() and err < TOL):
            raise SystemExit(f"{name} disagrees with its plain version")
        if not torch.equal(fn(a), got):
            raise SystemExit(f"{name}: two calls differ")
        nbytes = sum(t.numel() * t.element_size() for t in a.values()
                     if torch.is_tensor(t))
        copies = [a] + [make(s) for s in range(1, max(2, -(-(120 << 20)
                                                         // nbytes)))]
        call = library(make(0, None))
        row = time_row(name, f"{kname}_kernel", fn, plain, copies, cost,
                       lambda _: call())
        row["max_abs_err"] = err
        out[name] = row
        del call
    return out


def phase_families_parity():
    """Smoke size, each of the ten archs: the card (K3/K4 over an f32
    pool) against the CPU (plain versions), float32, a 40-token prompt
    (past gemma3-smoke's window of 16) — three chunks of 16 where the
    family chunks, the whole prompt inserted into the pool where it does
    not — then 4 decode steps; logits within ``TOL``.  The two models
    the engine does not serve decode from their prefill cache through
    K3 on its f32 rings: seamless-smoke with 24 source frames, and
    qwen2vl-smoke on embeds whose M-RoPE positions carry an image span
    (``image_span_positions``), decoding embeds."""
    from repro_torch import configs
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.core.scale import ScaleState
    from repro_torch.models import transformer as T
    from repro_torch.serve import kv_pool

    pol = PrecisionPolicy("float32", fused_decode=True)
    g = torch.Generator().manual_seed(13)
    res = {}
    for arch in FAMILY_ARCHS:
        cfg = configs.get_smoke(arch)
        chunked = (cfg.family == "dense" and not cfg.num_experts
                   and cfg.input_mode == "tokens")
        toks = torch.randint(0, cfg.vocab_size, (1, 44), generator=g)
        logits = {}
        if arch in ENCDEC_ARCHS:
            logits = {dev: encdec_parity_logits(cfg, toks, dev)
                      for dev in ("cuda", "cpu")}
        for dev in (() if logits else ("cuda", "cpu")):
            params = _to(T.init_params(cfg, 7, device="cpu"), dev)
            exps = ScaleState.create(T.group_shapes(cfg), -6.0,
                                     device=dev).exps
            kvp = kv_pool.make_kv_pool(cfg, pol, max_slots=1, max_len=48,
                                       device=dev)
            out = []
            if chunked:
                for p0 in (0, 16, 32):
                    n = min(16, 40 - p0)
                    t = torch.zeros((1, 16), dtype=torch.int32)
                    t[0, :n] = toks[0, p0:p0 + n]
                    lg, _, _ = T.prefill_chunk_step(
                        cfg, pol, params, kvp.pool, t.to(dev),
                        torch.tensor([p0], dtype=torch.int32, device=dev),
                        torch.tensor([n], dtype=torch.int32, device=dev),
                        exps, kv_codec=kvp.codec)
                    out.append(lg.cpu())
            else:
                lg, _, entry = T.prefill(cfg, pol, params,
                                         {"tokens": toks[:, :40].to(dev)},
                                         exps, max_cache_len=48)
                kv_pool.insert(kvp.pool, entry,
                               torch.tensor([0], device=dev), kvp.codec)
                out.append(lg.cpu())
            for step in range(4):
                lg, _, _ = T.decode_step(
                    cfg, pol, params, kvp.pool, toks[:, 40 + step].to(dev),
                    torch.tensor([40 + step], dtype=torch.int32, device=dev),
                    exps, kv_codec=kvp.codec)
                out.append(lg.cpu())
            logits[dev] = torch.stack(out)
        err = float((logits["cuda"] - logits["cpu"]).abs().max())
        res[arch] = err
        how = ("chunked" if chunked else "ring decode" if arch in
               ENCDEC_ARCHS else "whole-prompt")
        log(f"family parity {cfg.name} card vs cpu ({how}): logits "
            f"{tuple(logits['cpu'].shape)} max_abs_err {err:.3e}")
        if not (torch.isfinite(logits["cuda"]).all() and err < TOL):
            raise SystemExit(f"{cfg.name} on the card disagrees with the "
                             f"CPU")
    return res


def _alone_tokens(eng, uid: int, prompt_tokens, max_new: int):
    """Request ``uid``'s prompt served alone on an engine of the same
    geometry and options: its tokens."""
    from repro_torch.serve import ServeEngine
    alone = ServeEngine(eng.cfg, eng.policy, eng.params,
                        max_slots=eng.max_slots, max_len=eng.max_len,
                        options=eng.options, device="cuda")
    u = alone.submit(prompt_tokens, max_new=max_new)
    alone.run()
    return alone.results[u]


def _weight_bytes(params) -> int:
    if isinstance(params, dict):
        return sum(_weight_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


def serve_family(argv, *, chunked: bool):
    """``repro_torch.launch.serve.main(argv)`` counted from 0, held by
    :func:`_check_served` (K3 once per attention call of every decode
    step, K4 once per attention call of every chunk when ``chunked``);
    the windowed calls among them; request 0 alone gives its tokens in
    the batch.  Returns (engine, the run's numbers)."""
    from repro_torch.launch import serve
    from repro_torch.launch.serve import prompt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    with WindowSpy() as spy:
        eng = serve.main(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, nw = attn_calls(eng.cfg)
    st, launches = _check_served(eng, n, 16, "flash_decode",
                                 "flash_prefill" if chunked else None)
    want_win = {"flash_decode": nw * st["decode_steps"],
                "flash_prefill": nw * st["prefill_chunks"]}
    lens = [int(x) for x in argv[argv.index("--prompt-len") + 1].split(",")]
    alone = _alone_tokens(eng, 0, prompt(0, lens[0], eng.cfg.vocab_size), 16)
    same = bool(np.array_equal(alone, eng.results[0]))
    res = {"arch": eng.cfg.name, "layers": eng.cfg.num_layers,
           "wall_s": wall, "tok_per_s": st["tok_per_s"],
           "ttft_mean_s": st["ttft_mean_s"], "ttft_max_s": st["ttft_max_s"],
           "decode_steps": st["decode_steps"],
           "prefill_chunks": st["prefill_chunks"],
           "weight_bytes": _weight_bytes(eng.params),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "windowed_calls": dict(spy.calls),
           "alone_equals_batch": same}
    log(f"{eng.cfg.name} served: {json.dumps(res)}")
    if not (spy.calls == want_win and same
            and (st["prefill_chunks"] > 0) == chunked):
        raise SystemExit(f"{eng.cfg.name} serving failed its checks "
                         f"(windowed {spy.calls}, expected {want_win}; "
                         f"alone = batch {same})")
    return eng, res


def phase_granite_serve():
    """granite-moe-1b served at full width and depth through the CLI
    (DFXP-10, int8 pool, fused decode; chunk 128 asked for, whole prompts
    run), then at float32 with a capacity that drops no token: the
    decode logits of 8 teacher-forced steps after a 96-token prefill
    against the full forward's over the same 104 tokens, within
    ``FAMILY_DECODE_TOL``; and one profiled decode step."""
    import dataclasses
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.launch.serve import prompt
    from repro_torch.models import transformer as T
    from repro_torch.serve import kv_pool
    eng, res = serve_family(GRANITE_SERVE, chunked=False)
    cfg, params = eng.cfg, eng.params
    nd = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    pol = PrecisionPolicy("float32", fused_decode=True)
    exps = eng.exps
    seq = np.concatenate([prompt(0, 96, cfg.vocab_size),
                          eng.results[0][:8]]).astype(np.int64)
    tseq = torch.from_numpy(seq).cuda()[None]
    with torch.no_grad():
        full, _, _ = T.forward(nd, pol, params, {"tokens": tseq}, exps, {})
        kvp = kv_pool.make_kv_pool(nd, pol, max_slots=1, max_len=128,
                                   device="cuda")
        lg, _, entry = T.prefill(nd, pol, params, {"tokens": tseq[:, :96]},
                                 exps, max_cache_len=128)
        kv_pool.insert(kvp.pool, entry, torch.tensor([0], device="cuda"),
                       kvp.codec)
        out = [lg]
        for j in range(7):
            lg, _, _ = T.decode_step(
                nd, pol, params, kvp.pool, tseq[:, 96 + j],
                torch.tensor([96 + j], dtype=torch.int32, device="cuda"),
                exps, kv_codec=kvp.codec)
            out.append(lg)
        got = torch.cat(out)
        err = float((got - full[0, 95:103]).abs().max())
        scale = float(full[0, 95:103].abs().max())
    res["decode_vs_forward_max_abs_err"] = err
    res["logits_max_abs"] = scale
    log(f"granite f32 prefill+decode vs forward (no drops): max_abs_err "
        f"{err:.3e} on logits up to {scale:.3f}")
    if not (math.isfinite(err) and err <= FAMILY_DECODE_TOL):
        raise SystemExit("granite's decode disagrees with its forward")
    tok = torch.zeros(eng.max_slots, dtype=torch.int32, device="cuda")
    pos = torch.full((eng.max_slots,), 300, dtype=torch.int32,
                     device="cuda")

    def decode():
        T.decode_step(cfg, eng.policy, params, eng.kv.pool, tok, pos,
                      eng.exps, kv_codec=eng.codec)

    res["decode_profile"] = _profile("granite_decode_step", decode)
    res["decode_device_ops"] = device_ops(decode)
    log(f"granite decode step: {res['decode_device_ops']} device operations")
    return eng, res


def _state_leaves(tree, path=""):
    """Tensors of a train state (dataclasses, dicts) by path."""
    import dataclasses
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_state_leaves(v, f"{path}/{k}"))
        return out
    return {path: tree} if torch.is_tensor(tree) else {}


def phase_granite_train():
    """The trainer with no ``--arch``: granite-moe-1b at full width and
    depth, batch 8 x 64, SGD, fused matmul and K1, DFXP 10/12 (5
    calibration steps) and float32, 20 steps each: every step ok, losses
    finite, K1 and K2 launches = the sites' arithmetic
    (:func:`lm_site_launches`, MoE blocks included); the same argv at 2
    of the 24 layers against the reference launcher's losses at steps 1
    and 10 (``REF_GRANITE``, within ``GRANITE_TOL``); two 5-step DFXP runs
    (no calibration) end in the same bits, every state leaf; one
    profiled train step."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.core.quant import enable_pallas_quantize
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import build_policy
    from repro_torch.models import transformer as T
    from repro_torch.optim.opt import OptConfig
    from repro_torch.train import TrainSupervisor
    cfg = configs.get("granite_moe_1b")
    res = {"config": cfg.name}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_all_launches()
    t0 = time.perf_counter()
    dfxp, state = _lm_in_process(GRANITE_TRAIN)
    res["dfxp_wall_s"] = time.perf_counter() - t0
    launches = train_launches()
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - base
    res["state_bytes"] = _state_bytes(state)
    k1s, k2s = lm_site_launches(cfg, 8, 64)
    want = {"dfxp_quantize": 20 * k1s, "qmatmul": 20 * k2s}
    res.update(launches=launches, expected_launches=want,
               per_step={"dfxp_quantize": k1s, "qmatmul": k2s})
    t0 = time.perf_counter()
    f32, _ = _lm_in_process(GRANITE_TRAIN + GRANITE_F32)
    res["float32_wall_s"] = time.perf_counter() - t0
    rows = {"dfxp": dfxp, "float32": f32}
    s_ok = all(r["summary"] and r["summary"]["attempts"]
               == r["summary"]["steps_committed"] == len(r["losses"]) == 20
               and r["summary"]["halted"] is False
               and all(math.isfinite(v) for v in r["losses"].values())
               for r in rows.values())
    res["losses"] = {k: [r["losses"].get(s) for s in (1, 5, 10, 15, 20)]
                     for k, r in rows.items()}
    res["groups"] = dfxp["groups"]
    log(f"granite trained ({cfg.num_layers} layers): every step ok {s_ok}, "
        f"groups "
        f"{dfxp['groups']}, losses {res['losses']}; launches {launches} "
        f"expected {want}; peak {res['peak_memory_bytes'] / 1e9:.2f} GB; "
        f"{res['dfxp_wall_s']:.1f}s dfxp, {res['float32_wall_s']:.1f}s f32")
    if not (s_ok and dfxp["groups"] == REF_GRANITE_GROUPS
            and launches == want):
        raise SystemExit("granite training failed its checks")

    # -- a profiled step on the run's final state ----------------------------
    ns = type("Args", (), dict(
        arithmetic="dfxp", comp_width=10, update_width=12,
        update_interval=20, storage="sim", max_overflow_rate=1e-4,
        fused_matmul=True))
    pol = build_policy(ns)
    data = SyntheticLM(cfg.vocab_size, 64, 8, seed=0)
    sup = TrainSupervisor(
        lambda p, b, s, e: T.loss_fn(cfg, pol, p, b, e, s),
        T.group_shapes(cfg), pol, OptConfig(kind="sgd", lr=0.01,
                                            lr_decay_steps=1000), state,
        batch_fn=lambda c: {k: torch.from_numpy(v).cuda()
                            for k, v in data.batch(c).items()},
        rng=prng.PRNGKey(0, "cuda"))
    sup.cursor = 20
    enable_pallas_quantize(True)
    try:
        res["step_profile"] = _profile("granite_train_step", sup.step_once)
        res["step_device_ops"] = device_ops(sup.step_once)
    finally:
        enable_pallas_quantize(False)
    log(f"granite train step: {res['step_device_ops']} device operations")
    del sup, state

    # -- the reference's losses, at 2 layers ---------------------------------
    cut = register_cut("granite_moe_1b", 2)
    res["ref"] = {}
    for row, flags in (("dfxp", []), ("float32", GRANITE_F32)):
        r, _ = _lm_in_process(["--arch", cut, "--fused-matmul", "--steps",
                               "10", "--log-every", "1", "--device", "cuda",
                               *flags])
        got = [r["losses"].get(s, math.inf) for s in (1, 10)]
        ref = [REF_GRANITE[row][0], REF_GRANITE[row][9]]
        d = [abs(a - b) for a, b in zip(got, ref)]
        res["ref"][row] = {"card": got, "reference": ref, "diff": d,
                           "bound": list(GRANITE_TOL[row])}
        log(f"granite 2-layer {row}: steps 1, 10 {got} vs the reference's "
            f"{ref}: diff {d[0]:.2e}, {d[1]:.2e} (bounds "
            f"{GRANITE_TOL[row]})")
        if not (d[0] <= GRANITE_TOL[row][0] and d[1] <= GRANITE_TOL[row][1]):
            raise SystemExit(f"granite {row} training disagrees with the "
                             f"reference launcher's losses")

    # -- determinism: two 5-step DFXP runs -----------------------------------
    runs = []
    for _ in range(2):
        r, st = _lm_in_process(["--fused-matmul", "--steps", "5",
                                "--calibrate-steps", "0", "--log-every", "1",
                                "--device", "cuda"])
        runs.append((r["losses"], {k: v.cpu() for k, v in
                                   _state_leaves(st).items()}))
        del st
    (la, a), (lb, b) = runs
    differ = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
    res["determinism"] = {"leaves": len(a), "differing": len(differ),
                          "losses_equal": la == lb}
    log(f"granite two 5-step DFXP runs: {len(differ)} of {len(a)} state "
        f"leaves differ {differ[:3]}; losses equal {la == lb}")
    if differ or la != lb or not a:
        raise SystemExit("two granite DFXP runs do not give the same bits")
    return res


def phase_families_serve():
    """mamba2-370m (48 layers) and zamba2-1.2b (38 layers; shared
    attention through K3) served whole-prompt at full width, and
    gemma3-27b at full width and ``GEMMA_LAYERS`` layers with prompts past
    its window (K3 and K4 windowed on its local layers): each through
    :func:`serve_family`, with its weight bytes, peak memory, tok/s and
    TTFT; gemma3's local rings must have wrapped."""
    out = {}
    for arch in ("mamba2_370m", "zamba2_1p2b"):
        eng, out[arch] = serve_family(["--arch", arch, *FAMILY_SERVE],
                                      chunked=False)
        del eng
        torch.cuda.empty_cache()
    name = register_cut("gemma3_27b", GEMMA_LAYERS)
    eng, res = serve_family(["--arch", name, *GEMMA_SERVE], chunked=True)
    ring = eng.kv.pool["dec"]["0:attn"]["pos"]
    res["local_ring_cap"] = int(ring.shape[-1])
    res["local_ring_max_pos"] = int(ring.max())
    log(f"gemma3 local ring: cap {res['local_ring_cap']}, newest position "
        f"{res['local_ring_max_pos']}")
    if not (res["local_ring_cap"] == eng.cfg.window
            and res["local_ring_max_pos"] > eng.cfg.window
            and res["windowed_calls"]["flash_prefill"] > 0):
        raise SystemExit("gemma3's local rings did not wrap")
    out["gemma3_27b"] = res
    del eng
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the encoder-decoder (seamless-m4t-medium) and the embeds-input M-RoPE
# model (qwen2-vl-72b), which the engine does not serve (token-in decoders
# only): trained through make_train_step, decoded from their prefill cache
# ---------------------------------------------------------------------------

ENCDEC_ARCHS = ("seamless_m4t_medium", "qwen2_vl_72b")
# seamless-m4t-medium trained at full width and depth through
# make_train_step (neither package's trainer CLI feeds src_embeds):
# SyntheticLM(256256, 64, 8, seed=0).batch(i) and src_embeds [8, 96, 1024]
# = 0.1 * default_rng(i).standard_normal, SGD lr 0.01, DFXP 10/12 with 5
# calibration steps (fused matmul, K1), and float32; 96 source frames
# against 64 target tokens
SEAMLESS_B, SEAMLESS_S, SEAMLESS_SRC, SEAMLESS_STEPS = 8, 64, 96, 10
# The reference's losses at steps 1-10 of the same recipe at 1 encoder +
# 1 decoder layer of the 12 + 12 ("seamless-m4t-medium-l1e1"), jax 0.9.0 on
# a CPU: `python tools/ref_encdec_train.py` (the port on the CPU at the
# same recipe, `--port`: float32 equal to 4 decimals at every step; DFXP
# 7e-4 off at step 1 and 2.2e-3 at step 10, flipped rounding ties).
REF_SEAMLESS = {
    "dfxp": [12.6625, 12.6472, 12.6335, 12.6801, 12.6683, 12.6011, 12.6626,
             12.6869, 12.681, 12.6882],
    "float32": [12.6613, 12.6452, 12.6334, 12.6785, 12.6683, 12.5954,
                12.6627, 12.6869, 12.6777, 12.6884]}
REF_SEAMLESS_GROUPS = 151
# bounds on |card - reference| at steps 1 and 10, set before the card run
# from the CPU port's gap above, as GRANITE_TOL: float32 1e-3 / 1e-2,
# DFXP 1e-2 / 3e-2
SEAMLESS_TOL = {"float32": (1e-3, 1e-2), "dfxp": (1e-2, 3e-2)}
# decode: 4 sequences of 64-token prompts over 96 source frames (seamless),
# 4 of 96 embeds with a 1x8x8 image span (qwen2-vl), then 16 decode steps
DECODE_STEPS = 16
QWEN_LAYERS = 2        # of 80: 3.00B parameters, 12.0 GB in f32


def image_span_positions(b: int, s: int, n0: int, gh: int, gw: int):
    """M-RoPE positions ``[3, b, s]`` (numpy int32): ``n0`` text tokens on
    equal streams, a 1 x gh x gw patch grid (temporal ``n0``, height
    ``n0 + row``, width ``n0 + col``), then text again on equal streams
    from ``n0 + max(gh, gw)``."""
    pos = np.zeros((3, s), np.int32)
    pos[:, :n0] = np.arange(n0)
    r, c = np.divmod(np.arange(gh * gw), gw)
    pos[0, n0:n0 + gh * gw] = n0
    pos[1, n0:n0 + gh * gw] = n0 + r
    pos[2, n0:n0 + gh * gw] = n0 + c
    rest = s - n0 - gh * gw
    pos[:, n0 + gh * gw:] = n0 + max(gh, gw) + np.arange(rest)
    return np.broadcast_to(pos[:, None], (3, b, s)).copy()


def _normal(shape, seed: int, scale: float = 0.1):
    """``scale * default_rng(seed).standard_normal(shape)`` in float32."""
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32))


def ring_decode(cfg, params, prompt: dict, inputs, dev):
    """float32 prefill of ``prompt`` [B, S] (or [B, S, D] embeds), then one
    decode step per entry of ``inputs`` (``None``: the greedy token of the
    last logits; else that [B, 1, D] embeds) at positions ``S + j``, K3
    (``RawKVCodec(fused_decode=True)``) on the prefill's f32 rings.
    Returns (logits [B, 1 + steps, V], the inputs fed, seconds)."""
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    pol = PrecisionPolicy("float32")
    codec = L.RawKVCodec(fused_decode=True)
    key = "tokens" if cfg.input_mode == "tokens" else "embeds"
    B, S = prompt[key].shape[:2]
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        lg, _, cache = T.prefill(cfg, pol, params, prompt, {},
                                 max_cache_len=S + len(inputs))
        out, fed = [lg], []
        for j, x in enumerate(inputs):
            if x is None:
                x = torch.argmax(lg, dim=-1).to(torch.int32)
            fed.append(x)
            pos = torch.full((B,), S + j, dtype=torch.int32, device=dev)
            lg, _, cache = T.decode_step(cfg, pol, params, cache, x, pos, {},
                                         kv_codec=codec)
            out.append(lg)
        logits = torch.stack(out, dim=1)
    if dev == "cuda":
        torch.cuda.synchronize()
    return logits, fed, time.perf_counter() - t0


def encdec_parity_logits(cfg, toks, dev):
    """Smoke parity of seamless-smoke (tokens, 24 source frames) or
    qwen2vl-smoke (embeds, image-span positions): prefill 40 and decode 4
    (teacher-forced) on ``dev``; the logits on the CPU."""
    from repro_torch.models import transformer as T
    params = _to(T.init_params(cfg, 7, device="cpu"), dev)
    if cfg.input_mode == "tokens":
        prompt = {"tokens": toks[:, :40],
                  "src_embeds": _normal((1, 24, cfg.d_model), 11)}
        inputs = [toks[:, 40 + j].to(torch.int32) for j in range(4)]
    else:
        emb = _normal((1, 44, cfg.d_model), 12)
        prompt = {"embeds": emb[:, :40], "positions": torch.from_numpy(
            image_span_positions(1, 40, 6, 4, 4))}
        inputs = [emb[:, 40 + j:41 + j] for j in range(4)]
    logits, _, _ = ring_decode(cfg, params, _to(prompt, dev),
                               [x.to(dev) for x in inputs], dev)
    return logits[0].cpu()


def encdec_batch(cfg, i: int, dev="cuda"):
    """Training batch ``i`` of the seamless recipe (``SEAMLESS_*``)."""
    from repro_torch.data import SyntheticLM
    b = SyntheticLM(cfg.vocab_size, SEAMLESS_S, SEAMLESS_B, seed=0).batch(i)
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out["src_embeds"] = _normal((SEAMLESS_B, SEAMLESS_SRC, cfg.d_model), i)
    return _to(out, dev)


def train_direct(cfg, row: str, steps: int, batch_fn, *, calibrate: int = 5,
                 opt_kind: str = "sgd", lr: float = 0.01):
    """``make_train_step`` on the card with the trainer's recipe and key
    tree: ``row`` (dfxp: 10/12, controller interval 20, fused matmul and
    K1, exponents calibrated on ``calibrate`` batches from
    ``init_params(PRNGKey(0))``; or float32), weights from
    ``fold_in(PRNGKey(0), 1)``, ``steps`` steps of ``batch_fn(i)``.  K1
    and K2 counted from 0 around the steps alone.  Returns (result,
    final state)."""
    import dataclasses
    from repro_torch.core import prng
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.core.quant import enable_pallas_quantize
    from repro_torch.models import transformer as T
    from repro_torch.optim.opt import OptConfig, adamw_init, sgd_init
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.calibrate import calibrate as run_calibration
    gs = T.group_shapes(cfg)
    opt = OptConfig(kind=opt_kind, lr=lr, lr_decay_steps=1000)
    pol = PrecisionPolicy(row, comp_width=10, update_width=12,
                          update_interval=20, fused_matmul=row == "dfxp")
    key = prng.PRNGKey(0, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    enable_pallas_quantize(True)
    try:
        init = -8.0
        if pol.dynamic:
            obs = dataclasses.replace(pol, arithmetic="observe")
            init = run_calibration(
                lambda p, b, s, e: T.loss_fn(cfg, obs, p, b, e, s),
                T.init_params(cfg, key, device="cuda"), gs, pol, opt,
                (batch_fn(i) for i in range(calibrate)), steps=calibrate)
        params = T.init_params(cfg, prng.fold_in(key, 1), device="cuda")
        state = init_train_state(
            params, (sgd_init if opt_kind == "sgd" else adamw_init)(params),
            gs, pol, init_exp=init)
        del params
        step = make_train_step(
            lambda p, b, s, e: T.loss_fn(cfg, pol, p, b, e, s), gs, pol,
            opt)
        batches = [batch_fn(i) for i in range(steps)]
        torch.cuda.synchronize()
        reset_all_launches()
        t1 = time.perf_counter()
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(m["loss"])
        losses = torch.stack(losses).tolist()
        steps_s = time.perf_counter() - t1
        launches = train_launches()
    finally:
        enable_pallas_quantize(False)
    res = {"row": row, "groups": len(init) if pol.dynamic else None,
           "losses": losses, "launches": launches, "steps_wall_s": steps_s,
           "wall_s": time.perf_counter() - t0,
           "peak_memory_bytes": torch.cuda.max_memory_allocated() - base}
    return res, state


def decode_vs_forward(cfg, params, prompt: dict, inputs, n_attn: int):
    """:func:`ring_decode` on the card with K3 counted from 0 around it
    (``n_attn`` self-attention calls a step), then the float32 forward
    over the prompt and the fed inputs (M-RoPE: each fed embedding at
    ``S + j`` on all three streams, as the decode positions are); the
    decode's logits against the forward's at positions ``S-1 ..
    S+steps-1``, within ``FAMILY_DECODE_TOL``."""
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.kernels.attn import ops
    from repro_torch.models import transformer as T
    reset_all_launches()
    logits, fed, secs = ring_decode(cfg, params, prompt, inputs, "cuda")
    launches = dict(ops.LAUNCHES)
    steps = len(inputs)
    key = "tokens" if cfg.input_mode == "tokens" else "embeds"
    B, S = prompt[key].shape[:2]
    full = dict(prompt)
    if key == "tokens":
        full["tokens"] = torch.cat([prompt["tokens"]] + [
            x[:, None].to(prompt["tokens"].dtype) for x in fed], dim=1)
    else:
        full["embeds"] = torch.cat([prompt["embeds"]] + fed, dim=1)
        if "positions" in prompt:
            tail = torch.arange(S, S + steps, dtype=torch.int32,
                                device="cuda").expand(3, B, steps)
            full["positions"] = torch.cat([prompt["positions"], tail], 2)
    with torch.no_grad():
        want, _, _ = T.forward(cfg, PrecisionPolicy("float32"), params, full,
                               {}, {})
    want = want[:, S - 1:S + steps]
    err = float((logits - want).abs().max())
    scale = float(want.abs().max())
    want_launches = {n: 0 for n in launches}
    want_launches["flash_decode"] = n_attn * steps
    res = {"decode_steps": steps, "wall_s": secs,
           "tok_per_s": B * (steps + 1) / secs, "launches": launches,
           "expected_launches": want_launches,
           "decode_vs_forward_max_abs_err": err, "logits_max_abs": scale}
    log(f"{cfg.name} prefill {B}x{S} + {steps} decode steps (K3 on f32 "
        f"rings): {secs:.2f}s, launches {launches} expected "
        f"{want_launches}; logits vs the forward's: max_abs_err {err:.3e} "
        f"on logits up to {scale:.3f}")
    if not (math.isfinite(err) and err <= FAMILY_DECODE_TOL
            and launches == want_launches
            and torch.isfinite(logits).all()):
        raise SystemExit(f"{cfg.name}: decode disagrees with its forward "
                         f"or did not run K3 as often as its layers")
    return res


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    return tree.numel()


def phase_seamless():
    """seamless-m4t-medium at full width and depth (877M parameters):
    trained through ``make_train_step`` (DFXP 10/12 with fused matmul and
    K1, then float32; ``SEAMLESS_*``), every loss finite, 151 groups, K1
    and K2 launches = the sites' arithmetic a step
    (:func:`lm_site_launches` with the 96-frame encoder); the float32
    run's weights prefilled (4 prompts of 64 tokens over 96 frames) and
    decoded 16 greedy steps through K3 (12 self-attention calls a step)
    within ``FAMILY_DECODE_TOL`` of the full forward; then the same
    recipe at 1 + 1 layers against the reference's losses at steps 1 and
    10 (``REF_SEAMLESS``, within ``SEAMLESS_TOL``)."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.get("seamless_m4t_medium")
    res = {"config": cfg.name}

    def batch(i):
        return encdec_batch(cfg, i)

    dfxp, state = train_direct(cfg, "dfxp", SEAMLESS_STEPS, batch)
    res["weight_bytes"] = 4 * _n_params(state.params)
    del state
    torch.cuda.empty_cache()
    k1s, k2s = lm_site_launches(cfg, SEAMLESS_B, SEAMLESS_S, SEAMLESS_SRC)
    want = {"dfxp_quantize": SEAMLESS_STEPS * k1s,
            "qmatmul": SEAMLESS_STEPS * k2s}
    f32, state = train_direct(cfg, "float32", SEAMLESS_STEPS, batch)
    res.update(dfxp=dfxp, float32=f32, expected_launches=want,
               per_step={"dfxp_quantize": k1s, "qmatmul": k2s})
    ok = (dfxp["groups"] == REF_SEAMLESS_GROUPS
          and dfxp["launches"] == want
          and not any(f32["launches"].values())
          and all(math.isfinite(v) for r in (dfxp, f32)
                  for v in r["losses"]))
    log(f"seamless trained (12 + 12 layers, {res['weight_bytes'] / 1e9:.2f} "
        f"GB): groups {dfxp['groups']}, losses dfxp {dfxp['losses']} "
        f"float32 {f32['losses']}; launches {dfxp['launches']} expected "
        f"{want}; peak {dfxp['peak_memory_bytes'] / 1e9:.2f} GB dfxp, "
        f"{f32['peak_memory_bytes'] / 1e9:.2f} GB float32; "
        f"{dfxp['steps_wall_s']:.1f}s / {f32['steps_wall_s']:.1f}s for "
        f"{SEAMLESS_STEPS} steps")
    if not ok:
        raise SystemExit("seamless training failed its checks")

    n = 4
    prompt = {"tokens": encdec_batch(cfg, 0)["tokens"][:n],
              "src_embeds": _normal((n, SEAMLESS_SRC, cfg.d_model), 100
                                    ).cuda()}
    res["decode"] = decode_vs_forward(
        cfg, state.params, prompt, [None] * DECODE_STEPS,
        attn_calls(cfg)[0])
    del state
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, name="seamless-m4t-medium-l1e1",
                              num_layers=1, encoder_layers=1)
    res["ref"] = {}
    for row in ("dfxp", "float32"):
        r, st = train_direct(cut, row, SEAMLESS_STEPS,
                             lambda i: encdec_batch(cut, i))
        del st
        got = [r["losses"][0], r["losses"][-1]]
        ref = [REF_SEAMLESS[row][0], REF_SEAMLESS[row][-1]]
        d = [abs(a - b) for a, b in zip(got, ref)]
        res["ref"][row] = {"card": got, "reference": ref, "diff": d,
                           "bound": list(SEAMLESS_TOL[row]),
                           "groups": r["groups"]}
        log(f"seamless 1+1 layers {row}: steps 1, 10 {got} vs the "
            f"reference's {ref}: diff {d[0]:.2e}, {d[1]:.2e} (bounds "
            f"{SEAMLESS_TOL[row]})")
        if not (d[0] <= SEAMLESS_TOL[row][0] and d[1] <= SEAMLESS_TOL[row][1]):
            raise SystemExit(f"seamless {row} training disagrees with the "
                             f"reference's losses")
    torch.cuda.empty_cache()
    return res


def phase_qwen2vl():
    """qwen2-vl-72b at full width, ``reduced: num_layers 80 -> 2``
    (``QWEN_LAYERS``): 4 prompts of 96 embeds (16 text, a 1x8x8 image
    span, 16 text) prefilled and decoded 16 steps on [4, 1, 8192] embeds
    through K3 (2 calls a step), within ``FAMILY_DECODE_TOL`` of the
    M-RoPE forward; then its training step at the smoke config, card
    against the CPU (3 DFXP steps, fused matmul, K1 from 4096 elements:
    exponents equal, losses within 1e-4) — one full-width layer's
    training state does not fit the card (PERF.md)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core.quant import enable_pallas_quantize
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(configs.get("qwen2_vl_72b"),
                              name=f"qwen2-vl-72b-l{QWEN_LAYERS}",
                              num_layers=QWEN_LAYERS)
    res = {"config": cfg.name}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    res["weight_bytes"] = 4 * _n_params(params)
    B, S = 4, 96
    prompt = {"embeds": _normal((B, S, cfg.d_model), 20).cuda(),
              "positions": torch.from_numpy(
                  image_span_positions(B, S, 16, 8, 8)).cuda()}
    inputs = [_normal((B, 1, cfg.d_model), 21 + j).cuda()
              for j in range(DECODE_STEPS)]
    res["decode"] = decode_vs_forward(cfg, params, prompt, inputs,
                                      attn_calls(cfg)[0])
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - base
    log(f"qwen2-vl ({QWEN_LAYERS} layers, {res['weight_bytes'] / 1e9:.2f} "
        f"GB): init {res['init_s']:.1f}s, peak "
        f"{res['peak_memory_bytes'] / 1e9:.2f} GB")
    del params, prompt, inputs
    torch.cuda.empty_cache()

    smoke = configs.get_smoke("qwen2_vl_72b")

    def batch(i, dev):
        from repro_torch.data import SyntheticLM
        b = SyntheticLM(smoke.vocab_size, 32, 4, seed=0).batch(i)
        out = {"labels": torch.from_numpy(b["labels"]),
               "embeds": _normal((4, 32, smoke.d_model), 30 + i),
               "positions": torch.from_numpy(
                   image_span_positions(4, 32, 6, 4, 4))}
        return _to(out, dev)

    enable_pallas_quantize(True, min_size=1 << 12)
    try:
        card, cpu = (_train_smoke(smoke, lambda i, d=dev: batch(i, d), dev)
                     for dev in ("cuda", "cpu"))
    finally:
        enable_pallas_quantize(False)
    diff = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
    same = card["exps"] == cpu["exps"]
    res["smoke_train"] = {"max_loss_diff": diff, "exponents_equal": same,
                          "card_launches": card["launches"],
                          "losses": card["losses"]}
    log(f"qwen2vl-smoke 3 DFXP steps card vs cpu: max loss diff "
        f"{diff:.3e}, exponents equal {same}, card launches "
        f"{card['launches']}")
    if not (diff <= 1e-4 and same and all(card["launches"].values())):
        raise SystemExit("qwen2vl-smoke training on the card disagrees "
                         "with the CPU")
    return res


def _train_smoke(cfg, batch_fn, dev):
    """Three DFXP 10/12 steps (controller interval 2, fused matmul) of
    ``cfg`` on ``dev`` from calibrated exponents: losses, exponents and
    the K1/K2 launches of the steps."""
    import dataclasses
    from repro_torch.core import prng
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import transformer as T
    from repro_torch.optim.opt import OptConfig, sgd_init
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.calibrate import calibrate
    pol = PrecisionPolicy("dfxp", update_interval=2, fused_matmul=True)
    obs = dataclasses.replace(pol, arithmetic="observe")
    opt = OptConfig(kind="sgd", lr=0.01, lr_decay_steps=1000)
    gs = T.group_shapes(cfg)
    init = calibrate(lambda p, b, s, e: T.loss_fn(cfg, obs, p, b, e, s),
                     T.init_params(cfg, 0, device=dev), gs, pol, opt,
                     (batch_fn(i) for i in range(2)), steps=2)
    params = T.init_params(cfg, prng.fold_in(prng.PRNGKey(0), 1), device=dev)
    state = init_train_state(params, sgd_init(params), gs, pol,
                             init_exp=init)
    step = make_train_step(lambda p, b, s, e: T.loss_fn(cfg, pol, p, b, e, s),
                           gs, pol, opt)
    before = train_launches()
    losses = []
    for i in range(3):
        state, m = step(state, batch_fn(i))
        losses.append(float(m["loss"]))
    after = train_launches()
    return {"losses": losses,
            "exps": {k: v.tolist() for k, v in state.scale.exps.items()},
            "launches": {k: after[k] - before[k] for k in after}}


def phase_encdec_kernels():
    """K1, K2 and K3 against their plain versions at the shapes the two
    new models give them, timed beside the bound and the library call:
    K1 on seamless's 256256 x 1024 embedding table, its [512, 256256]
    logits site, and qwen2-vl's 8192 x 152064 head (1.246e9 elements,
    4.98 GB: 64-bit offsets); K2 on seamless's untied head at N = 256256
    (forward nn, dgrad nt over the vocabulary, wgrad tn) and the
    cross-attention's wk over 768 source rows; K3 on seamless's decoder
    rings (K=16, G=1, hd=64) and qwen2-vl's (K=8, G=8, hd=128), f32, as
    the decode phases run them.  K1 bit for bit; K2 within its
    tolerance of the plain product summed in float64 (at D = 256256 the
    float32 plain version's own error exceeds that tolerance; it is
    reported beside); K3 within ``TOL``."""
    from repro_torch.kernels.attn import cases
    from repro_torch.kernels.attn.cases import H100_TF32_FLOPS
    from repro_torch.kernels.dfxp import cases as qc
    from repro_torch.kernels.qmatmul import cases as mc
    from repro_torch.kernels.qmatmul import ops as k2
    dev = torch.device("cuda")
    out = {}

    def k1_big(shape, e, scale, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(shape, generator=g, device=dev).mul_(scale)
        return {"x": x, "e": e, "width": 10}

    for tag, make in (
            ("k1_seamless_embed", lambda s: qc.quantize_case(
                (256256, 1024), e=-12.0, scale=0.02, seed=s, device=dev)),
            ("k1_seamless_logits", lambda s: qc.quantize_case(
                (512, 256256), e=-3.0, seed=s, device=dev)),
            ("k1_qwen2vl_head", lambda s: k1_big((8192, 152064), -12.0,
                                                 0.02, s))):
        a = make(0)
        y, st = k1_call(a)
        yr, sr = k1_plain(a)
        torch.cuda.synchronize()
        ok = torch.equal(y, yr) and torch.equal(st, sr)
        log(f"{tag} {tuple(a['x'].shape)}: counts {st.tolist()} plain "
            f"{sr.tolist()} bit-exact {ok}")
        del y, yr
        if not ok:
            raise SystemExit(f"{tag}: K1 disagrees with its plain version")
        row = time_row(f"{tag} timing", "dfxp_quantize_kernel", k1_call,
                       k1_plain, [a], qc.quantize_cost, k1_library)
        row["max_abs_err"] = 0.0
        out[tag] = row
        del a
        torch.cuda.empty_cache()

    for tag, (kind, R, C, D, wb) in (
            ("k2_seamless_head_fwd_nn", ("nn", 512, 256256, 1024, 10)),
            ("k2_seamless_head_dgrad_nt", ("nt", 512, 1024, 256256, 10)),
            ("k2_seamless_head_wgrad_tn", ("tn", 1024, 256256, 512, None)),
            ("k2_seamless_xattn_wk_nn", ("nn", 768, 1024, 1024, 10))):
        a = mc.qmm_case(kind, R, C, D, width_b=wb, seed=9, device=dev)
        got, plain = k2_call(a), k2_plain(a)
        # held against the plain product in float64 (the same rounded
        # operands): at D = 256256 the float32 plain version's own
        # summation error passes cases.tolerance(D)
        exact = k2_plain64(a)
        tol = mc.tolerance(D)
        err = float((got.double() - exact).abs().max())
        err32 = float((plain.double() - exact).abs().max())
        log(f"{tag} [{R},{C}] D={D} plan {k2.plan(R, C, D)}: max_abs_err "
            f"{err:.3e} from the float64 plain product (atol "
            f"{tol['atol']:.2e}, rtol {tol['rtol']}); the float32 plain "
            f"version's {err32:.3e}, K2 vs it "
            f"{float((got - plain).abs().max()):.3e}")
        if not torch.allclose(got.double(), exact, **tol):
            raise SystemExit(f"{tag}: K2 disagrees with its plain version")
        del got, plain, exact
        k2_library(a)
        row = time_row(f"{tag} timing", "qmm_kernel", k2_call, k2_plain,
                       [a], lambda c: (*mc.qmm_cost(c), H100_TF32_FLOPS),
                       k2_library)
        row.update(max_abs_err=err, float32_plain_max_abs_err=err32)
        out[tag] = row
        del a
        torch.cuda.empty_cache()

    fills = [80, 72, 64, 80]
    for tag, (K, G, hd, W) in (("k3_seamless", (16, 1, 64, 80)),
                               ("k3_qwen2vl", (8, 8, 128, 112))):
        def make(s, K=K, G=G, hd=hd, W=W):
            return cases.decode_case(4, W, K, G, hd, None,
                                     fill=[min(f, W) for f in fills],
                                     seed=s, device=dev)
        a = make(0)
        got, want = k3(a), k3_plain(a)
        err = float((got - want).abs().max())
        log(f"{tag}: max_abs_err {err:.3e} against the plain version")
        if not (torch.isfinite(got).all() and err < TOL
                and torch.equal(k3(a), got)):
            raise SystemExit(f"{tag}: K3 disagrees with its plain version")
        nbytes = sum(t.numel() * t.element_size() for t in a.values()
                     if torch.is_tensor(t))
        copies = [a] + [make(s) for s in range(1, max(2, -(-(120 << 20)
                                                         // nbytes)))]
        row = time_row(f"{tag} timing", "flash_decode_kernel", k3, k3_plain,
                       copies, cases.decode_cost, sdpa_decode)
        row["max_abs_err"] = err
        out[tag] = row
    return out


def phases_encdec(t0) -> dict:
    """The two models the engine does not serve, after the families'
    phases, each freed before the next."""
    res = {"kernels": phase_encdec_kernels()}
    log(f"[{time.perf_counter() - t0:.0f}s] K1, K2, K3 checked at the new "
        f"models' shapes")
    res["seamless"] = phase_seamless()
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t0:.0f}s] seamless-m4t-medium trained and "
        f"decoded")
    res["qwen2vl"] = phase_qwen2vl()
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t0:.0f}s] qwen2-vl-72b decoded")
    log("encdec: " + json.dumps(res))
    return res


def phases_families(t0, parity: dict) -> dict:
    """The token-in families' phases after the trainer's (``parity``: the
    smoke parity phase's result), each engine freed before the next."""
    fam = {"parity": parity, "kernels": phase_family_kernels()}
    log(f"[{time.perf_counter() - t0:.0f}s] families' kernel shapes checked")
    eng, fam["granite_serve"] = phase_granite_serve()
    del eng
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t0:.0f}s] granite-moe-1b served")
    fam["granite_train"] = phase_granite_train()
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - t0:.0f}s] granite-moe-1b trained")
    fam["serve"] = phase_families_serve()
    log(f"[{time.perf_counter() - t0:.0f}s] mamba2, zamba2, gemma3 served")
    log("families: " + json.dumps(fam))
    return fam


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
    prng_res = phase_build_and_prng()
    log(f"[{time.perf_counter() - t0:.0f}s] kernels built, PRNG checked")
    # the dry run's production cells trace on the CPU from here on, in a
    # subprocess (phase_dryrun collects it)
    dry = start_dryrun()
    kern = phase_kernels()
    tp_rows = phase_tp_kernels()
    kern.update(phase_train_kernels())
    log(f"[{time.perf_counter() - t0:.0f}s] kernels checked")
    fam_parity = phase_families_parity()
    phase_parity_paged()
    tpar = phase_train_parity()
    log(f"[{time.perf_counter() - t0:.0f}s] smoke parity checked")
    train = phase_train()
    log(f"[{time.perf_counter() - t0:.0f}s] training main path trained")
    sweep = phase_sweep()
    log(f"[{time.perf_counter() - t0:.0f}s] precision sweep trained")
    conv = phase_conv()
    tprof = phase_train_profile()
    log(f"[{time.perf_counter() - t0:.0f}s] conv maxout trained, train step "
        f"profiled")
    lm_par = phase_train_lm_parity()
    lm = phase_train_lm()
    lm["parity"] = lm_par
    log(f"[{time.perf_counter() - t0:.0f}s] LM trainer trained, crashed, "
        f"resumed and survived chaos")
    fam = phases_families(t0, fam_parity)
    encdec = phases_encdec(t0)
    eng, st, launches, peak = phase_serve()
    log(f"[{time.perf_counter() - t0:.0f}s] main path served")
    peng, pst, plaunches, ppeak = phase_paged(eng)
    clean = {u: r.tolist() for u, r in peng.results.items()}
    log(f"[{time.perf_counter() - t0:.0f}s] paged path served")
    prof = phase_profile(eng, peng)
    log(f"[{time.perf_counter() - t0:.0f}s] steps profiled")
    wst, wlaunches = phase_whole_prompt(eng)
    log(f"[{time.perf_counter() - t0:.0f}s] whole-prompt path served")
    sampled = phase_sampled(eng)
    sampled_paged = phase_sampled(eng, page=PAGE)
    log(f"[{time.perf_counter() - t0:.0f}s] sampled paths served")
    # the serve CLI's --tp 2 world runs from here beside the robustness
    # and sharded phases (none of them times the card); phases_dist
    # collects it
    cli = start_cli_tp()
    try:
        prng_ops = phase_prng_launches(eng, sampled["engine"])
        for r in (sampled, sampled_paged):
            r.pop("engine")
        robust = phases_robustness(eng, clean,
                                   prng_ops["greedy_deterministic_pool"], t0)
        dist = phases_dist(eng, lm, t0, cli)
        phase_dryrun(dry, smi, fam["granite_train"], lm)
        log(f"[{time.perf_counter() - t0:.0f}s] dry run traced")
    finally:
        for proc in (cli[1], dry[1]):     # stop what this run started
            if proc.poll() is None:
                proc.kill()
                proc.wait()

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
    # K3 and K4 on the token-in families' serving paths, each counted from
    # 0 around its run, and the calls among them that pass a window
    fam_paths = {"granite_moe_1b": fam["granite_serve"],
                 **{a: fam["serve"][a] for a in ("mamba2_370m",
                                                 "zamba2_1p2b",
                                                 "gemma3_27b")}}
    for row in rows[:2]:
        row["launches_by_path"] = {"llama3_8b": row["launches"], **{
            a: r["launches"][row["name"]] for a, r in fam_paths.items()}}
        row["windowed_calls"] = {a: r["windowed_calls"][row["name"]]
                                 for a, r in fam_paths.items()}
        tag = "k3_" if row["name"] == "flash_decode" else "k4_"
        row["family_cases"] = {k: v for k, v in (fam["kernels"]
                                                 | encdec["kernels"]).items()
                               if k.startswith(tag)}
    # K3 on the decode of the two models the engine does not serve
    rows[0]["launches_by_path"].update(
        seamless_m4t_medium=encdec["seamless"]["decode"]["launches"][
            "flash_decode"],
        qwen2_vl_72b_l2=encdec["qwen2vl"]["decode"]["launches"][
            "flash_decode"])
    # the robustness phases' runs: admission and the traced run (K3, K4),
    # the targeted faults and the chaos sweep (K5, K6)
    for row in rows[:2]:
        row["launches_by_path"].update(
            llama3_8b_queue_cap=robust["admission"]["queue_cap"][
                "launches"][row["name"]],
            llama3_8b_runaway=robust["admission"]["runaway"]["launches"][
                row["name"]],
            llama3_8b_traced=robust["observed"]["launches"][row["name"]])
    for row in rows[2:4]:
        row["launches_by_path"] = {
            "llama3_8b_paged": row["launches"],
            "llama3_8b_faults": robust["faults"]["launches"][row["name"]],
            "llama3_8b_chaos": robust["chaos"]["launches"][row["name"]]}
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
             "lm_head_logits", "torch.fake_quantize_per_tensor_affine, the "
             "same rounding without the overflow counts"),
            ("qmatmul", "src/repro_torch/kernels/qmatmul/csrc/qmatmul.cu",
             "src/repro/kernels/qmatmul/qmatmul_kernel.py:78",
             "lm_head_fwd_nt", "torch.matmul (TF32 off) on the operands "
             "rounded outside the timed call; bound_ms on the kernel's TF32 "
             "route, f32_bound_ms at the float32 SIMT rate")):
        k = kern[name]
        main_row = k["rows"][main_case]
        # launches: this slice's main path (the LM trainer's solo run);
        # by path: each training main path, counted from 0 around it
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": lm["launches"][name],
            "launches_by_path": {"train_lm": lm["launches"][name],
                                 "quickstart": train["launches"][name],
                                 "granite_moe_1b_train": fam[
                                     "granite_train"]["launches"][name],
                                 "seamless_m4t_medium_train": encdec[
                                     "seamless"]["dfxp"]["launches"][name]},
            "max_abs_err": k["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row.get("library_ms"), "library_note": note,
            "main_case": main_case, "cases": k["rows"],
            "encdec_cases": {c: v for c, v in encdec["kernels"].items()
                             if c.startswith("k1_" if name == "dfxp_quantize"
                                             else "k2_")}})
        for key in ("f32_bound_ms", "call_device_ms", "device_ops_per_call"):
            if key in main_row:
                rows[-1][key] = main_row[key]
    # the sharded runs (each counted from 0 around it): K3-K6 on each
    # rank of the TP runs (4 of 8 kv heads), K3 on granite's EP ranks; K1
    # and K2 on the compressed LM run
    jobs = dist["sharded"]["jobs"]
    for row, job in ((rows[0], "tp2"), (rows[1], "tp2"),
                     (rows[2], "tp2_paged"), (rows[3], "tp2_paged"),
                     (rows[0], "ep"), (rows[0], "ep_a2a8"),
                     (rows[1], "cp2")):
        for rank, r in enumerate(jobs[job]["ranks"]):
            row["launches_by_path"][f"{job}_rank{rank}"] = \
                r["launches"][row["name"]]
    for row in rows[4:6]:
        row["launches_by_path"]["train_lm_grad_compress_8"] = \
            dist["compressed"]["launches"][row["name"]]
    for row in rows[:4]:
        row["tp_rank_case"] = tp_rows[row["name"]]
    summary = {"peak_memory_bytes": peak, "tok_per_s": st["tok_per_s"],
               "weight_init": st["weight_init"],
               "ttft_mean_s": st["ttft_mean_s"], "decode_steps":
               st["decode_steps"], "prefill_chunks": st["prefill_chunks"],
               "whole_prompt_tok_per_s": wst["tok_per_s"],
               "paged": {k: pst[k] for k in (
                   "tok_per_s", "ttft_mean_s", "ttft_max_s", "wall_s",
                   "decode_steps", "prefill_chunks", "pages_allocated",
                   "page_cache_hits", "page_cow_forks",
                   "pages_in_use_peak")} | {"peak_memory_bytes": ppeak},
               "profile": prof, "sampled": sampled,
               "sampled_paged": sampled_paged,
               "decode_step_device_ops": prng_ops}
    log("prng: " + json.dumps(prng_res))
    log("train: " + json.dumps({"parity": tpar, "main": train, "conv": conv,
                                "sweep": sweep, "profile": tprof}))
    log("serve: " + json.dumps(summary))
    log("train_lm: " + json.dumps(lm))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
