"""Smoke run of the PyTorch port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build the flash-decode (K3) and flash-prefill (K4) CUDA kernels from
   ``src/repro_torch/kernels/attn/csrc`` with ``nvcc`` (in parallel) and
   print each kernel's registers and shared memory;
3. hold each kernel against its plain PyTorch version on card tensors at
   the serving slice's shapes (K3: B=4 slots, W=400, K=8, G=4, hd=128 for
   int8, int16, f32 and a sliding window; K4: C=128 with ragged n_valid
   and p0 > 0), and time kernel, plain version and a library yardstick;
4. smoke-size parity: the port's model on the card (kernels) against the
   same model on the CPU (plain versions);
5. the main path: ``repro_torch.launch.serve`` at full llama3-8B width,
   DFXP-10, int8 pool, fused decode, chunked prefill (6 requests, 4
   slots, 16 tokens each); every request must end OK and both kernels
   must have launched, K3 once per layer per decode step;
6. a whole-prompt run (``prefill_chunk=0``) on the same weights.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the rest
of the repository, it exits non-zero and prints no result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

TOL = 1e-4                      # kernel vs plain, outputs of size O(1..16)
SERVE_ARGS = ["--arch", "llama3_8b", "--num-requests", "6", "--slots", "4",
              "--prompt-len", "96,200,384", "--max-new", "16",
              "--cache-bits", "8", "--fused-decode", "--prefill-chunk",
              "128"]


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
    """Mean device time per call of ``fn()`` in ms: the ``torch.profiler``
    time of the kernels whose name contains ``match`` (every kernel the
    call launches when ``match`` is None).  Host-side launch gaps are not
    in it; :func:`cuda_ms` measures the call as the stream sees it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_iter):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_time_us(e) for e in prof.key_averages()
             if _on_device(e) and (match is None or match in e.key))
    if us <= 0:
        raise SystemExit("the profiler recorded no device time")
    return us / 1e3 / n_iter


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
    from repro_torch.kernels.attn import build
    report = build.build_all(force=True)
    for name, r in report.items():
        info = [ln.strip() for ln in r["ptxas"].splitlines()
                if "registers" in ln or "Compiling entry" in ln]
        log(f"built {name} in {r['seconds']:.1f}s")
        for ln in info:
            log("  ", ln)
    # dynamic shared memory a block asks for (attn_common.cuh smem_floats:
    # a padded K tile, a V tile and the block's query rows, f32)
    for name, rows in (("flash_decode", 4), ("flash_prefill", 32)):
        log(f"  {name}: {(32 * 129 + 32 * 128 + rows * 128) * 4} bytes of "
            f"dynamic shared memory per block at hd=128")


def phase_kernels():
    """K3/K4 against their plain versions; timings and bounds."""
    from repro_torch.kernels.attn import cases, ops, ref
    dev = torch.device("cuda")
    B, W, K, G, HD, C = 4, 400, 8, 4, 128, 128

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
        Bq = a["q"].shape[0]
        vh, vs = cases.prefill_valid(a)
        mask = torch.cat([vh, vs], dim=-1)                     # [B, C, W+C]
        mask = mask.repeat_interleave(G, dim=1)[:, None]       # [B,1,CG,W+C]
        q = a["q"].permute(0, 2, 1, 3, 4).reshape(Bq, K, C * G, HD)
        kc = torch.cat([a["k"], a["k_new"]], 1).permute(0, 2, 1, 3)
        vc = torch.cat([a["v"], a["v_new"]], 1).permute(0, 2, 1, 3)
        kc, vc = kc.contiguous(), vc.contiguous()
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask, scale=a["scale"])

    results = {}

    def check(name, fn, plain, a):
        out, want = fn(a), plain(a)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        bad = not torch.allclose(out, want, atol=TOL, rtol=TOL)
        log(f"{name}: max_abs_err {err:.3e}" + ("  FAIL" if bad else ""))
        if bad:
            raise SystemExit(f"{name} disagrees with its plain version")
        return err

    def timed(name, kernel, fn, plain, make, cost, library=None):
        # ms / plain_ms / library_ms: device time per call (profiler);
        # *_call_ms: CUDA-event time per call in a loop, host gaps included
        copies = [make(seed) for seed in range(24)]
        nbytes, flops = cost(copies[0])
        bound, bound_by = cases.bound_ms(nbytes, flops)
        row = dict(ms=device_ms(rotating(fn, copies), kernel),
                   call_ms=cuda_ms(rotating(fn, copies)),
                   plain_ms=device_ms(rotating(plain, copies)),
                   plain_call_ms=cuda_ms(rotating(plain, copies), 10),
                   bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                   flops=flops)
        if library is not None:
            row["library_ms"] = device_ms(library(copies[0]))
        log(f"{name}: {json.dumps(row)}")
        return row

    errs = {"flash_decode": [], "flash_prefill": []}
    decode_rows = {}
    for width, tag in ((8, "int8"), (16, "int16"), (None, "f32")):
        for window in (None, 128):
            a = cases.decode_case(B, W, K, G, HD, width, window=window,
                                  fill=[W, 3 * W // 2, 37, 1], seed=1,
                                  device=dev)
            errs["flash_decode"].append(
                check(f"K3 {tag} window={window}", k3, k3_plain, a))
    for width, tag in ((8, "int8"), (16, "int16"), (None, "f32")):
        decode_rows[tag] = timed(
            f"K3 {tag} timing", "flash_decode_kernel", k3, k3_plain,
            lambda s, w=width: cases.decode_case(B, W, K, G, HD, w, seed=s,
                                                 device=dev),
            cases.decode_cost, sdpa_decode if width is None else None)
    prefill_rows = {}
    for width, tag in ((8, "int8"), (16, "int16"), (None, "f32")):
        a = cases.prefill_case(2, C, W, K, G, HD, width, p0=[256, 0],
                               n_valid=[100, C], seed=3, device=dev)
        errs["flash_prefill"].append(
            check(f"K4 {tag} B=2 p0=[256,0] nv=[100,128]", k4, k4_plain, a))
        a = cases.prefill_case(1, C, W, K, G, HD, width, p0=[256],
                               n_valid=[C], window=128, seed=4, device=dev)
        errs["flash_prefill"].append(
            check(f"K4 {tag} window=128", k4, k4_plain, a))
    for width, tag in ((8, "int8"), (16, "int16"), (None, "f32")):
        prefill_rows[tag] = timed(
            f"K4 {tag} timing (B=1, C=128, p0=256, W=400)",
            "flash_prefill_kernel", k4, k4_plain,
            lambda s, w=width: cases.prefill_case(1, C, W, K, G, HD, w,
                                                  p0=[256], n_valid=[C],
                                                  seed=s, device=dev),
            cases.prefill_cost, sdpa_prefill if width is None else None)
    results["flash_decode"] = dict(rows=decode_rows,
                                   max_abs_err=max(errs["flash_decode"]))
    results["flash_prefill"] = dict(rows=prefill_rows,
                                    max_abs_err=max(errs["flash_prefill"]))
    return results


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


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _check_served(eng, n_layers, max_new, chunked):
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
    vocab = eng.cfg.vocab_size
    ok = (all(s == "ok" for s in statuses)
          and all(n == max_new for n in lens)
          and all(((r >= 0) & (r < vocab)).all()
                  for r in eng.results.values())
          and launches["flash_decode"] == n_layers * st["decode_steps"] > 0
          and launches["flash_prefill"] == (
              n_layers * st["prefill_chunks"] if chunked else 0))
    if chunked and not launches["flash_prefill"] > 0:
        ok = False
    if not ok:
        raise SystemExit("serving run failed its checks")
    return st, launches


def phase_serve():
    from repro_torch.kernels.attn import ops
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    eng = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st, launches = _check_served(eng, eng.cfg.num_layers, 16, chunked=True)
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: {wall:.1f}s including weight init; peak memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated)")
    return eng, st, launches, peak


def phase_whole_prompt(eng):
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.kernels.attn import ops
    from repro_torch.launch.serve import prompt
    from repro_torch.serve import EngineOptions, ServeEngine
    pol = PrecisionPolicy("dfxp", fused_decode=True)
    whole = ServeEngine(eng.cfg, pol, eng.params, max_slots=4, max_len=208,
                        options=EngineOptions(cache_bits=8, prefill_chunk=0),
                        device="cuda")
    for i, n in enumerate((96, 96, 200, 200)):
        whole.submit(prompt(i, n, eng.cfg.vocab_size), max_new=8)
    ops.reset_launches()
    whole.run()
    torch.cuda.synchronize()
    st, launches = _check_served(whole, eng.cfg.num_layers, 8, chunked=False)
    return st, launches


def _kind(name: str) -> str:
    if "flash_decode_kernel" in name:
        return "flash_decode (K3)"
    if "flash_prefill_kernel" in name:
        return "flash_prefill (K4)"
    if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "gemv")):
        return "matmul"
    return "elementwise/reduction"


def phase_profile(eng):
    """Where one decode step and one prefill chunk spend device time, at
    full width, from ``torch.profiler``; device idle share = 1 - device
    time / host wall time of the call."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    cfg, pol, params, codec = eng.cfg, eng.policy, eng.params, eng.codec
    pool, B = eng.kv.pool, eng.max_slots
    dev = torch.device("cuda")
    tok = torch.zeros(B, dtype=torch.int32, device=dev)
    pos = torch.full((B,), 300, dtype=torch.int32, device=dev)
    toks = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    one = {s: {b: {n: t[:, :1] for n, t in e.items()} for b, e in sc.items()}
           for s, sc in pool.items()}

    def decode():
        T.decode_step(cfg, pol, params, pool, tok, pos, eng.exps,
                      kv_codec=codec)

    def chunk():
        T.prefill_chunk_step(
            cfg, pol, params, one, toks,
            torch.tensor([128], dtype=torch.int32, device=dev),
            torch.tensor([128], dtype=torch.int32, device=dev), eng.exps,
            kv_codec=codec)

    out = {}
    for name, fn in (("decode_step", decode), ("prefill_chunk", chunk)):
        fn()
        torch.cuda.synchronize()
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
        row = {"wall_ms": wall, "device_ms": total / 1e3,
               "device_ms_by_kind": by_kind}
        if total > 0:
            row["device_idle_share"] = 1.0 - total / 1e3 / wall
        else:
            row["device_ms"] = "not measured (no device time in the trace)"
        out[name] = row
        log(f"profile {name}: {json.dumps(row)}")
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
    log(f"[{time.perf_counter() - t0:.0f}s] kernels checked")
    phase_parity()
    log(f"[{time.perf_counter() - t0:.0f}s] smoke parity checked")
    eng, st, launches, peak = phase_serve()
    log(f"[{time.perf_counter() - t0:.0f}s] main path served")
    prof = phase_profile(eng)
    log(f"[{time.perf_counter() - t0:.0f}s] one step profiled")
    wst, wlaunches = phase_whole_prompt(eng)
    log(f"[{time.perf_counter() - t0:.0f}s] whole-prompt path served")

    srcs = {"flash_decode": ("src/repro_torch/kernels/attn/csrc/flash_decode.cu",
                             "src/repro/kernels/attn/attn_kernel.py:123"),
            "flash_prefill": ("src/repro_torch/kernels/attn/csrc/flash_prefill.cu",
                              "src/repro/kernels/attn/prefill_kernel.py:125")}
    rows = []
    for name, (src, replaces) in srcs.items():
        k = kern[name]
        main_row = k["rows"]["int8"]           # the pool the main path runs
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": k["rows"]["f32"].get("library_ms"),
            "library_note": "scaled_dot_product_attention on the f32-pool "
                            "case of the same shape and mask",
            "cases": k["rows"],
            "whole_prompt_launches": wlaunches[name]})
    summary = {"peak_memory_bytes": peak, "tok_per_s": st["tok_per_s"],
               "ttft_mean_s": st["ttft_mean_s"], "decode_steps":
               st["decode_steps"], "prefill_chunks": st["prefill_chunks"],
               "whole_prompt_tok_per_s": wst["tok_per_s"], "profile": prof}
    log("serve: " + json.dumps(summary))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
