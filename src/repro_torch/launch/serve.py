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

``--smoke`` takes the reduced config, ``--device cpu`` runs the plain
PyTorch versions on the CPU.  Weights are random, drawn on the device
from ``--seed``; prompts are drawn from seeds ``1000 + i``.  A
per-request status table prints at exit.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import configs, resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models import transformer as T
from repro_torch.serve import EngineOptions, SamplerConfig, ServeEngine


def _parse_lens(spec: str):
    return [int(x) for x in spec.split(",") if x]


def prompt(i: int, length: int, vocab: int):
    """Request ``i``'s prompt: ``length`` ids drawn from seed ``1000 + i``."""
    g = torch.Generator().manual_seed(1000 + i)
    return torch.randint(0, vocab, (length,), generator=g).numpy()


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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    policy = PrecisionPolicy(args.arithmetic, fused_decode=args.fused_decode,
                             prefill_chunk=args.prefill_chunk or
                             args.page_size, page_size=args.page_size)
    scfg = SamplerConfig(kind=args.sampler, temperature=args.temperature,
                         top_k=args.top_k if args.sampler == "top_k" else 0)
    params = T.init_params(cfg, args.seed, device=device)
    lens = _parse_lens(args.prompt_len)
    slots = args.slots or min(args.num_requests, 4)
    opts = EngineOptions(cache_bits=args.cache_bits, sampler_cfg=scfg,
                         seed=args.seed)
    eng = ServeEngine(cfg, policy, params, max_slots=slots,
                      max_len=max(lens) + args.max_new, options=opts,
                      device=device)
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
    return eng


if __name__ == "__main__":
    main()
