"""Device operations of one decode step of the port's serve engine on one
NVIDIA card, with none of the robustness options and with each of them,
so that two trees of the port can be compared.

    PYTHONPATH=src python tools/serve_step_ops.py [--layers 2]

llama3-8B at its full width, cut to ``--layers`` layers (random weights
from key 0), DFXP-10 over the chunked int8 pool with fused attention
(K3), 4 slots at position 300, greedy: the operations (kernels, copies,
memsets) that the engine's decode step (``ServeEngine._decode_impl``:
the model's step, the sentinel, the sampler and the one host transfer)
puts on the stream, from ``torch.profiler``, after a warm-up call.
Engines of a tree without the options (``EngineOptions`` lacking
``runaway_ovf``) count the bare step only.  Prints the card's name and
power limit first, then one JSON line.  Imports no JAX.
"""
import argparse
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch


def device_ops(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # some sessions record no device activity
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA"))
        if n:
            return n
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from repro_torch import configs
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineOptions, ServeEngine
    cfg = dataclasses.replace(configs.get("llama3_8b"),
                              num_layers=args.layers)
    params = T.init_params(cfg, 0, device="cuda")
    pol = PrecisionPolicy("dfxp", fused_decode=True, prefill_chunk=128)
    variants = {"bare": {}}
    fields = {f.name for f in dataclasses.fields(EngineOptions)}
    if "runaway_ovf" in fields:
        from repro_torch.serve import FaultHarness
        variants.update(harness={"faults": FaultHarness([])},
                        runaway={"runaway_ovf": 1.0},
                        harness_and_runaway={"faults": FaultHarness([]),
                                             "runaway_ovf": 1.0})
    out = {"layers": args.layers}
    for tag, opts in variants.items():
        eng = ServeEngine(cfg, pol, params, max_slots=4, max_len=400,
                          options=EngineOptions(cache_bits=8, **opts),
                          device="cuda")
        eng._pos[:] = 300
        eng._active[:] = True
        args_ = [eng._dev(eng._active)]
        if "faults" in opts:
            args_.append(np.zeros(eng.max_slots, bool))
        out[tag] = device_ops(lambda: eng._decode_impl(*args_))
        del eng
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
