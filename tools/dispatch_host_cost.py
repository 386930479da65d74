"""Host µs a plan selection costs a call of the fused matmul (K2) and of
the attention wrappers (K3, K4) once its key is cached, beside the fixed
rule each replaced, on the host clock of whatever runs it.

    PYTHONPATH=src python tools/dispatch_host_cost.py [--calls 200000]

Pure Python on the host: selection is the same code on a card and off
one, so this runs anywhere (the keys are cached with ``measure=False``:
nothing is launched).  Shapes: the LM_100M trainer's ``w_down`` dgrad
(``nt`` [2048, 512] D = 2048), the llama3-8B serving decode (B=4, W=400)
and chunk (C=128).  Prints one JSON line of µs per call.
"""
import argparse
import json
import time

from repro_torch.kernels import dispatch
from repro_torch.kernels.attn import ops as A
from repro_torch.kernels.qmatmul import ops as Q


def per_call_us(fn, n: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=200000)
    n = ap.parse_args().calls
    dispatch.reset_autotune()
    dispatch.set_autotune(measure=False)
    out = {
        "k2_selection": per_call_us(lambda: dispatch.blocks_for(
            "nt", 2048, 512, 2048, interpret=False, widths=(None, 10)), n),
        "k2_rule": per_call_us(lambda: Q.plan(2048, 512, 2048), n),
        "k3_selection": per_call_us(lambda: dispatch.attn_blocks_for(
            400, 4, 128, width=8, interpret=False, B=4, K=8), n),
        "k3_rule": per_call_us(lambda: A.ring_splits(4, 8, 400), n),
        "k4_selection": per_call_us(lambda: dispatch.prefill_blocks_for(
            400, 128, 4, 128, width=8, interpret=False, B=1, K=8), n),
        "k4_rule": per_call_us(lambda: A.prefill_plan(1, 128, 400, 8, 4,
                                                      128), n)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
