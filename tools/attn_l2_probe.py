"""Why an attention kernel takes less time inside a serving step than
alone: its device time per call with inputs past the L2 and with inputs
in the L2, on one NVIDIA card.

    PYTHONPATH=src python tools/attn_l2_probe.py

K3 (flash-decode; B=4, W=400, K=8, G=4, hd=128) and K4 (flash-prefill;
B=1, C=128, p0=256, W=400), int8 pools, through the public wrappers only
(so the script runs on any tree of the port), each timed three ways with
``torch.profiler`` (the kernel's own launches, device time per call over
20 calls):

* ``cold``: a ring of 24 seeded inputs, more bytes than the 50 MB L2 —
  the isolated row of ``chip_smoke.py``;
* ``warm``: one input over and over, its K/V left in the L2;
* ``rewritten``: one input whose K/V mantissas are rewritten on the card
  (``mul_(1)``, as the serving step's KV append rescales the layer's
  whole ring) just before each call — the serving step's case.

The card's name and power limit come first.  Imports no JAX.
"""
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels.attn import cases, ops

B, W, K, G, HD, C = 4, 400, 8, 4, 128, 128


def device_us(fn, kernel: str, n_iter: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_iter):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and kernel in e.key) / n_iter


def probe(name, kernel, call, make):
    copies = [make(s) for s in range(24)]
    it = iter(range(1 << 30))
    one = copies[0]

    def rewritten():
        one["k"].mul_(1)
        one["v"].mul_(1)
        call(one)

    t = {"cold": device_us(lambda: call(copies[next(it) % 24]), kernel),
         "warm": device_us(lambda: call(one), kernel),
         "rewritten": device_us(rewritten, kernel)}
    print(f"{name}: " + " ".join(f"{k}={v:.2f}us" for k, v in t.items()),
          flush=True)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    probe("K3 int8", "flash_decode_kernel",
          lambda a: ops.flash_decode(
              a["q"], a["k"], a["v"], a["pos"], a["q_pos"], a["k_exp"],
              a["v_exp"], width=8, scale=a["scale"]),
          lambda s: cases.decode_case(B, W, K, G, HD, 8, seed=s, device=dev))
    probe("K4 int8", "flash_prefill_kernel",
          lambda a: ops.flash_prefill(
              a["q"], a["k_new"], a["v_new"], a["k"], a["v"], a["pos"],
              a["p0"], a["n_valid"], a["k_exp"], a["v_exp"], width=8,
              scale=a["scale"]),
          lambda s: cases.prefill_case(1, C, W, K, G, HD, 8, p0=[256],
                                       n_valid=[C], seed=s, device=dev))


if __name__ == "__main__":
    main()
