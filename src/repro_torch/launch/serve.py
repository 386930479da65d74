"""Serving CLI over the ``repro_torch.serve`` continuous-batching engine.

Mixed-length prompts, per-request budgets, greedy, temperature or top-k
sampling (``--sampler``, ``--temperature``, ``--top-k``: per-request
threefry streams keyed by ``--seed``), an optionally DFXP-packed KV pool
(``--cache-bits 8|16``), the hand-written flash-decode/flash-prefill
kernels (``--fused-decode``), chunked prefill (``--prefill-chunk C``)
and the paged pool with prefix sharing (``--page-size P``), on the card
by default:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \\
      --num-requests 6 --slots 4 --prompt-len 96,200,384 --max-new 16 \\
      --cache-bits 8 --fused-decode --prefill-chunk 128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \\
      --num-requests 6 --slots 4 --prompt-len 96,200,384 --max-new 16 \\
      --cache-bits 8 --fused-decode --page-size 64

``--arch`` takes every registered arch (``repro_torch.configs.ARCHS``):
MoE, SSM and hybrid models prefill whole prompts whatever
``--prefill-chunk`` asks for, as the reference's engine does, and the
paged pool takes the dense attention family without windows only::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_370m \\
      --smoke --device cpu --num-requests 3 --slots 2 --prompt-len 6,10 \\
      --max-new 4 --cache-bits 8

``--smoke`` takes the reduced config, ``--device cpu`` runs the plain
PyTorch versions on the CPU.  Weights are random, drawn on the device
from key 0 whatever ``--seed`` says (which keys the sampler and the
cache-rounding streams), and request ``i``'s prompt is
``randint(PRNGKey(1000 + i), (len,), 0, vocab)``: the reference's CLI
serves the same model the same requests for the same argv.

Robustness and observability: ``--queue-cap`` (reject-on-full
admission), ``--deadline-ms`` (queued and in-flight expiry), ``--chaos
[SEED]`` (a seeded fault-injection sweep of logit NaNs, KV bit flips,
admission delays and page squeezes, its event log printed and written
to ``--fault-log``), ``--trace-out`` (a Chrome-trace JSON of the engine's
steps, requests and faults), ``--numerics-log`` / ``--numerics-every``
(the packed pool's §5 timeline as JSONL), ``--metrics-port`` (the
metrics registry as Prometheus text on localhost) and ``--metrics-out``
(a final JSONL snapshot of it).  A bare ``--chaos`` on llama3_8b without
``--smoke`` is the reference's demo: the smoke config, an int8 pool,
pages of 4 on an arena two slots short of full residency, and a
controller cadence of 4 steps::

  PYTHONPATH=src python -m repro_torch.launch.serve --chaos 0 \\
      --device cpu --fault-log faults.json --trace-out trace.json

A per-request status table prints at exit.

Sharded serving: ``--tp N`` shards the KV pool's kv heads over N ranks,
``--cp N`` the decode KV window (slot-major pools only), ``--mesh
DATAxMODEL`` names both (mutually exclusive with ``--tp``/``--cp``).
Without a ``torch.distributed`` world in the environment (no
``WORLD_SIZE``) the CLI spawns ``tp·cp`` ranks itself and rank 0 prints;
under ``torchrun`` it joins the world it is given.  The backend follows
:data:`repro_torch.launch.mesh.BACKEND_RULE` (NCCL with a card per rank,
gloo when ranks share one or run on the CPU); greedy tokens equal the
unsharded run's::

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --tp 2 --num-requests 3 --slots 2 --prompt-len 6,10 --max-new 4

``--profile`` profiles kernel dispatch
(:mod:`repro_torch.kernels.dispatch`): at exit it prints ``dispatch
profile:`` and a table of plan selections per key (calls, cache hits and
misses, candidate plans timed, ms spent measuring, the plan), and with
``--trace-out`` dumps the same counters to the trace.  On the card the
first call of a key times its candidate plans and the file of measured
plans (``REPRO_TORCH_AUTOTUNE_CACHE``, default
``.cache/autotune_torch.json``) carries them to later runs; on the CPU
the rows are the plain versions' ``interp`` selections, as the
reference's interpret mode prints them.

:class:`Engine` is the reference's *lockstep* server: batched prefill,
then every sequence decodes the same number of steps at one shared
position, greedy.  It frees no slots and admits nothing mid-decode; its
greedy tokens are the anchor the float32 ``ServeEngine`` is held to.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.core import ScaleState, prng
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import MeshConfigError, serve_pod_ctx
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import (
    CacheQuantConfig,
    EngineOptions,
    FaultHarness,
    SamplerConfig,
    ServeEngine,
    chaos_plan,
)


class Engine:
    """Lockstep reference: batched prefill + fixed-step greedy decode
    (the reference's ``launch/serve.py:51-87``).

    The decode cache is the raw f32 ring; with ``policy.fused_decode`` its
    attention runs the flash-decode kernel K3 on it (whole prompts prefill
    on the plain attention).  Exponents are ``ScaleState.create(gs,
    -6.0)``'s, as the reference's."""

    def __init__(self, cfg, policy, params, *, max_len: int):
        self.cfg, self.policy, self.params = cfg, policy, params
        self.max_len = max_len
        self.device = params["final_norm"].device
        self.exps = ScaleState.create(T.group_shapes(cfg), -6.0,
                                      device=self.device).exps
        self.codec = L.RawKVCodec(policy.fused_decode)

    @torch.no_grad()
    def generate(self, prompts, max_new: int):
        """``prompts``: [B, S] token ids.  Returns [B, max_new] int32
        (greedy)."""
        if not isinstance(prompts, torch.Tensor):
            prompts = torch.from_numpy(np.array(prompts))
        prompts = prompts.to(self.device)
        B, S = prompts.shape
        logits, _, cache = T.prefill(self.cfg, self.policy, self.params,
                                     {"tokens": prompts}, self.exps,
                                     max_cache_len=self.max_len)
        outs = []
        tok = torch.argmax(logits, -1).to(torch.int32)
        for i in range(max_new):
            outs.append(tok)
            pos = torch.full((B,), S + i, dtype=torch.int32,
                             device=prompts.device)
            logits, _, cache = T.decode_step(self.cfg, self.policy,
                                             self.params, cache, tok, pos,
                                             self.exps, kv_codec=self.codec)
            tok = torch.argmax(logits, -1).to(torch.int32)
        return torch.stack(outs, dim=1)


def _parse_lens(spec: str):
    return [int(x) for x in spec.split(",") if x]


def prompt(i: int, length: int, vocab: int):
    """Request ``i``'s prompt: ``length`` ids drawn from key ``1000 + i``,
    as the reference's CLI draws them."""
    return prng.randint(prng.PRNGKey(1000 + i), (length,), 0, vocab).numpy()


def main(argv=None):
    """Serve the requests the flags describe; returns the drained engine
    (``results``, ``statuses``, ``stats()``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--arithmetic", default="dfxp")
    ap.add_argument("--num-requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=0,
                    help="concurrent slots (default: min(num-requests, 4))")
    ap.add_argument("--prompt-len", default="32",
                    help="prompt length, or comma list cycled over requests")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-bits", type=int, default=0, choices=(0, 8, 16),
                    help="KV-cache storage: 0=float32, 8/16=DFXP-packed "
                         "mantissas with per-slot controller-managed scales")
    ap.add_argument("--fused-decode", action="store_true",
                    help="run decode and chunked-prefill attention as the "
                         "hand-written flash kernels directly on the KV "
                         "pool's storage")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: admit any request into any free "
                         "slot immediately and prefill C tokens per engine "
                         "step interleaved with decode. 0 = whole-prompt")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV pool: page size P in tokens (0 = "
                         "slot-major rings). Pages carry their own DFXP "
                         "exponents; requests sharing a prompt prefix map "
                         "the same pages (refcounted, copy-on-write on "
                         "divergence). Implies --prefill-chunk P unless "
                         "set. The paged kernels take P a multiple of 32")
    ap.add_argument("--sampler", default="greedy",
                    choices=("greedy", "temperature", "top_k"))
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="admission control: bound the waiting queue; a "
                         "submit finding it full resolves REJECTED (empty "
                         "result, terminal status) instead of queueing. "
                         "0 = unbounded")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline from submit; expired "
                         "requests (queued or mid-decode) resolve "
                         "TIMED_OUT with the tokens harvested so far. "
                         "0 = no deadline")
    ap.add_argument("--chaos", type=int, nargs="?", const=0, default=None,
                    metavar="SEED",
                    help="fault-injection sweep: drive a seeded random mix "
                         "of logit NaNs, KV bit flips, admission delays, "
                         "and (paged pools) a page squeeze through the "
                         "run, then print the fault log. The engine must "
                         "drain with terminal statuses either way")
    ap.add_argument("--fault-log", default="",
                    help="with --chaos: write the harness event log (JSON) "
                         "to this path")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "(engine-step spans, request lifecycle instants, "
                         "fault events, queue counters) to this path")
    ap.add_argument("--numerics-log", default="",
                    help="write the §5 numeric-health timeline (per-layer/"
                         "per-slot KV exponents, overflow rates, controller "
                         "up/down moves) as JSONL to this path; packed "
                         "pools (--cache-bits 8|16) only")
    ap.add_argument("--numerics-every", type=int, default=0,
                    help="numerics sampling cadence in engine steps "
                         "(default: the cache controller's update "
                         "interval)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve the live metrics registry as Prometheus "
                         "text on http://127.0.0.1:PORT/metrics (0 picks "
                         "an ephemeral port)")
    ap.add_argument("--metrics-out", default="",
                    help="append a final JSONL snapshot of the metrics "
                         "registry (counters/gauges/histograms) to this "
                         "path at exit")
    ap.add_argument("--profile", action="store_true",
                    help="profile kernel dispatch: per-bucket plan-"
                         "selection calls, autotune cache hits/misses, "
                         "candidate plans timed and measured us, printed "
                         "as a table (and dumped to the trace when "
                         "--trace-out)")
    ap.add_argument("--mesh", default="",
                    help="serving mesh as DATAxMODEL (e.g. 2x1, 1x4): the "
                         "data axis shards the decode KV window (context "
                         "parallelism), the model axis the pool's kv heads "
                         "(tensor parallelism). Mutually exclusive with "
                         "--tp/--cp")
    ap.add_argument("--tp", type=int, default=1,
                    help="serving tensor parallelism: shard the KV pool's "
                         "kv-head axis over N ranks (params replicated; "
                         "greedy streams bit-identical to one process)")
    ap.add_argument("--cp", type=int, default=1,
                    help="serving context parallelism: shard the decode KV "
                         "window over N ranks (long-context slots; exact "
                         "log-sum-exp merge). Slot-major pools only")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args(argv)

    tp, cp = args.tp, args.cp
    if args.mesh:
        if tp != 1 or cp != 1:
            raise MeshConfigError("--mesh and --tp/--cp are mutually "
                                  "exclusive")
        try:
            cp, tp = (int(x) for x in args.mesh.lower().split("x"))
        except ValueError:
            raise MeshConfigError(
                f"--mesh {args.mesh!r} is not DATAxMODEL (e.g. 2x1, 1x4)")
    serve_pod_ctx(tp=tp, cp=cp)          # degrees must be positive
    n = tp * cp
    if n > 1 and mesh_mod.world_size() == 1:
        if "WORLD_SIZE" in os.environ:        # under torchrun: join it
            mesh_mod.init_world(
                int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                "env://", mesh_mod.backend_for(args.device,
                                               int(os.environ["WORLD_SIZE"])))
        else:                                  # spawn the world ourselves
            backend = mesh_mod.backend_for(args.device, n)
            print(f"spawning {n} ranks ({backend}: {mesh_mod.BACKEND_RULE})",
                  flush=True)
            # ranks on the CPU share its cores
            threads = max(1, (os.cpu_count() or 1) // n) \
                if args.device == "cpu" else 0
            mesh_mod.spawn(_cli_rank, n,
                           sys.argv[1:] if argv is None else list(argv),
                           backend=backend, threads=threads)
            return None
    return _serve(args, tp, cp)


def _cli_rank(rank: int, argv):
    """One spawned rank of the CLI: rank 0 prints, the others are quiet."""
    sink = contextlib.nullcontext() if rank == 0 else \
        contextlib.redirect_stdout(io.StringIO())
    with sink:
        main(argv)


def _serve(args, tp: int, cp: int):
    dist = mesh = None
    lead = True
    if tp > 1 or cp > 1:
        dist = serve_pod_ctx(tp=tp, cp=cp)
        mesh = mesh_mod.make_serve_mesh(tp=tp, cp=cp)
        lead = mesh.rank == 0
        print(f"mesh: data={cp} (cp) x model={tp} (tp) over "
              f"{mesh_mod.world_size()} ranks, {mesh.backend}")
    demo_chaos = args.chaos is not None and not args.smoke \
        and args.arch == "llama3_8b"
    if demo_chaos:
        # the bare --chaos sweep is the reference's diagnostic demo: the
        # smoke config over int8 pages, a tight arena (exhaustion →
        # preemption) and a fast controller cadence
        args.smoke = True
        if args.cache_bits == 0:
            args.cache_bits = 8
        if args.page_size == 0:
            args.page_size = 4

    device = resolve_device(args.device)
    if device.type == "cuda" and mesh is not None:
        device = torch.device("cuda", mesh.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    policy = PrecisionPolicy(args.arithmetic, fused_decode=args.fused_decode,
                             prefill_chunk=args.prefill_chunk or
                             args.page_size, page_size=args.page_size)
    scfg = SamplerConfig(kind=args.sampler, temperature=args.temperature,
                         top_k=args.top_k if args.sampler == "top_k" else 0)
    params = T.init_params(cfg, 0, device=device)
    lens = _parse_lens(args.prompt_len)
    slots = args.slots or min(args.num_requests, 4)

    tracer = None
    if args.trace_out:
        from repro_torch.obs import Tracer
        tracer = Tracer()
    num_log = None
    if args.numerics_log and lead:
        from repro_torch.obs import NumericsLog
        num_log = NumericsLog(args.numerics_log)
    if args.profile:
        from repro_torch.kernels import dispatch
        dispatch.profile_enable(True)
    cache_cfg = n_pages = None
    if demo_chaos and args.cache_bits:
        cache_cfg = CacheQuantConfig(width=args.cache_bits,
                                     update_interval=4)
        if args.page_size:
            # roughly two slots' worth of pages short of full residency,
            # so concurrent decode exhausts the arena and preempts
            nblocks = -(-(max(lens) + args.max_new) // args.page_size)
            n_pages = 1 + nblocks * max(slots - 2, 1)
    harness = None
    if args.chaos is not None:
        harness = FaultHarness(
            chaos_plan(args.chaos, list(range(args.num_requests)),
                       n_steps=4 * args.max_new,
                       squeeze_pages=4 if args.page_size else 0),
            seed=args.chaos)
    opts = EngineOptions(cache_bits=args.cache_bits, sampler_cfg=scfg,
                         cache_cfg=cache_cfg, n_pages=n_pages,
                         seed=args.seed, queue_cap=args.queue_cap or None,
                         deadline_ms=args.deadline_ms or None,
                         faults=harness, tracer=tracer, numerics_log=num_log,
                         numerics_every=args.numerics_every or None)
    max_len = max(lens) + args.max_new
    if cp > 1 and max_len % cp:
        max_len += cp - max_len % cp   # the KV window shards evenly
    eng = ServeEngine(cfg, policy, params, max_slots=slots,
                      max_len=max_len, options=opts,
                      device=device, dist=dist, mesh=mesh)
    server = None
    if args.metrics_port is not None and lead:
        from repro_torch.obs import start_http_server
        server = start_http_server(eng.metrics.registry, args.metrics_port)
        print(f"metrics: http://127.0.0.1:{server.server_address[1]}/metrics")
    uids = [eng.submit(prompt(i, lens[i % len(lens)], cfg.vocab_size),
                       max_new=args.max_new)
            for i in range(args.num_requests)]
    out = eng.run()
    stats = eng.stats()
    print(f"served {stats['requests_finished']} requests, "
          f"{stats['new_tokens']} tokens in {stats['wall_s']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s, "
          f"ttft mean {stats['ttft_mean_s'] * 1e3:.0f}ms)")
    print("stats:", json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                for k, v in stats.items()}))
    print("sample:", out[uids[0]][:8].tolist())
    print(f"{'uid':>5} {'status':>10} {'tokens':>7} {'preempts':>9}")
    for u in uids:
        st = eng.status(u)
        tr = eng.metrics.traces[u]
        print(f"{u:>5} {st.value if st else '?':>10} {out[u].size:>7} "
              f"{tr.preempts:>9}")
    if harness is not None:
        print("faults:", json.dumps(harness.summary()["event_counts"]))
        if args.fault_log and lead:
            with open(args.fault_log, "w") as f:
                json.dump(harness.summary(), f, indent=2)
            print(f"fault log written to {args.fault_log}")
    if args.profile:
        from repro_torch.kernels import dispatch
        if tracer is not None:
            dispatch.profile_trace_counters(tracer)
        print("dispatch profile:")
        print(dispatch.profile_table())
    if tracer is not None and lead:
        spans = len(tracer.span_names())
        tracer.export(args.trace_out)
        print(f"trace: {spans} spans, {len(tracer.events)} events -> "
              f"{args.trace_out}")
    if num_log is not None:
        from repro_torch.obs import count_moves
        print(f"numerics: {len(num_log.records)} records, "
              f"{count_moves(num_log.records)} controller moves -> "
              f"{args.numerics_log}")
        num_log.close()
    if args.metrics_out and lead:
        eng.metrics.registry.snapshot_jsonl(args.metrics_out,
                                            {"final": True})
        print(f"metrics snapshot appended to {args.metrics_out}")
    if server is not None:
        server.shutdown()
    return eng


if __name__ == "__main__":
    main()
