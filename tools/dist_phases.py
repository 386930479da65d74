"""``chip_smoke.py``'s distributed phases alone, on one NVIDIA card.

    python tools/dist_phases.py

Builds the kernels (``phase_build``), draws llama3-8B at full width with
``chip_smoke.SHARD_LAYERS`` layers (key 0), and runs ``phase_sharded``
(TP = 2 slot-major and paged, CP = 2, granite-moe-1b's EP with plain and
int8 ``all_to_all``, in a world of two gloo ranks on the card), then
``phase_train_compressed`` (LM_100M with ``--grad-compress-bits 8``,
against a one-step uncompressed run made here), with the serve CLI's
``--tp 2`` run beside them (``start_cli_tp``, ``phase_cli_tp``): the
same checks as the whole script, in a few minutes instead of twenty.
Prints the card's name and power limit first and the phases' results as
a JSON line last.  Imports no JAX.
"""
import dataclasses
import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("dist_phases: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    cs.phase_build()
    from repro_torch import configs
    from repro_torch.examples import train_lm
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(configs.get("llama3_8b"),
                              num_layers=cs.SHARD_LAYERS)
    eng = types.SimpleNamespace(cfg=cfg,
                                params=T.init_params(cfg, 0, device="cuda"))
    cli = cs.start_cli_tp()
    out = {"sharded": cs.phase_sharded(eng)}
    cs.log(f"[{time.perf_counter() - t0:.0f}s] sharded serving done")
    del eng
    torch.cuda.empty_cache()
    train_lm.register()
    ref, _ = cs._lm_in_process(cs.LM_ARGV + cs.LM_DFXP + ["--steps", "1"])
    out["compressed"] = cs.phase_train_compressed(
        {"losses": {"dfxp": [ref["losses"][1]]}})
    out["cli_tp"] = cs.phase_cli_tp(cli)
    cs.log(f"[{time.perf_counter() - t0:.0f}s] done")
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
