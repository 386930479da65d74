"""The paper's bit-width frontier (its Figures 1-4) on the port.

The counterpart of ``benchmarks/paper_tables.py``'s ``fig1_radix``,
``fig2_comp_width``, ``fig3_update_width`` and ``fig4_overflow_rate`` and
of ``examples/precision_sweep.py``, on the harness of
``benchmarks/_common.py``: ``MaxoutConfig(hidden=(48,), pieces=3)`` on
``SyntheticImages.hard()``, SGD at lr 0.1 with max-norm 1.9365, 120
steps at batch 64, weights from ``PRNGKey(7)``, dropout keyed
``PRNGKey(1)``, step ``i`` keyed ``PRNGKey(i)``, DFXP exponents
calibrated by 6 observe steps over 10 batches.  Each row prints its
final loss divided by the float32 row's, the paper's presentation.

    python -m repro_torch.examples.precision_sweep            # the card
    python -m repro_torch.examples.precision_sweep --device cpu --smoke

On the card the Fig-2 and Fig-3 rows run a second time at the paper's
full PI width (``MaxoutConfig()``, 784 → 240×5 → 240×5 → 10) as a second
table.  At the harness's lr 0.1 on this task float32 diverges at that
width (its final loss ~64), so the second table's ratios say nothing of
precision; it shows that the rows run there.  ``--smoke`` trains 20
steps a row and skips that table;
``--fused-matmul`` and ``--kernel-quantize`` route the DFXP rows through
K2 and K1 as the quickstart's flags do.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Tuple

from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.quant import enable_pallas_quantize
from repro_torch.data import SyntheticImages
from repro_torch.models import maxout as MX

from . import quickstart as qs

STEPS = 120
SMOKE_STEPS = 20
BATCH = 64
CFG = MX.MaxoutConfig(hidden=(48,), pieces=3)
FULL = MX.MaxoutConfig()
CALIB_STEPS, CALIB_BATCHES = 6, 10


def data() -> SyntheticImages:
    return SyntheticImages.hard()


def fig_rows() -> List[Tuple[str, PrecisionPolicy]]:
    """Every row of Figures 1-4, named as ``paper_tables.py`` names them,
    after the float32 baseline."""
    rows = [("float32", PrecisionPolicy("float32"))]
    for b in (1, 3, 5, 7, 9, 12):
        rows.append((f"fig1/radix_{b}", PrecisionPolicy(
            "fixed", comp_width=32, update_width=32, fixed_int_bits=b)))
    for w in (14, 12, 10, 8, 6):
        rows.append((f"fig2/dfxp_comp_{w}", PrecisionPolicy(
            "dfxp", comp_width=w, update_width=31, update_interval=10)))
    for w in (24, 20, 16):
        rows.append((f"fig2/fixed_comp_{w}", PrecisionPolicy(
            "fixed", comp_width=w, update_width=31)))
    for w in (16, 12, 10, 8):
        rows.append((f"fig3/dfxp_update_{w}", PrecisionPolicy(
            "dfxp", comp_width=31, update_width=w, update_interval=10)))
    for w in (20, 16):
        rows.append((f"fig3/fixed_update_{w}", PrecisionPolicy(
            "fixed", comp_width=31, update_width=w)))
    for rate in (1e-2, 1e-3, 1e-4):
        for w in (8, 10):
            rows.append((f"fig4/rate_{rate:g}_comp_{w}", PrecisionPolicy(
                "dfxp", comp_width=w, update_width=31, update_interval=10,
                max_overflow_rate=rate)))
    return rows


def train_row(cfg: MX.MaxoutConfig, policy: PrecisionPolicy, device, *,
              steps: int = STEPS, fused_matmul: bool = False) -> dict:
    """One row on the harness's recipe: ``{"loss", "acc", "seconds",
    "launches", "exps"}`` (``exps``: the final DFXP exponents by group)."""
    if policy.dynamic and fused_matmul:
        policy = dataclasses.replace(policy, fused_matmul=True)
    init_exp = -8.0
    if policy.dynamic:
        init_exp = qs.calibrated_exps(cfg, policy, device, data=data(),
                                      steps=CALIB_STEPS, seed=7,
                                      n_batches=CALIB_BATCHES)
    r = qs.train(cfg, policy, device, init_exp=init_exp, steps=steps,
                 batch=BATCH, data=data(), seed=7)
    out = {k: r[k] for k in ("loss", "acc", "seconds", "launches")}
    if policy.dynamic:
        out["exps"] = {k: float(v) for k, v in r["state"].scale.exps.items()}
    return out


def sweep(cfg: MX.MaxoutConfig, rows, device, *, steps: int = STEPS,
          fused_matmul: bool = False, label: str = "") -> Dict[str, dict]:
    """Train ``rows`` (the float32 baseline first) and print each one's
    final loss ÷ float32's.  Returns the rows by name, each with its
    ``ratio``."""
    print(f"{label}{cfg.input_dim} -> {cfg.hidden} x {cfg.pieces}, "
          f"{steps} steps at batch {BATCH}")
    print(f"{'row':28s} {'final loss':>10s} {'/ float32':>9s} "
          f"{'eval acc':>8s}")
    out: Dict[str, dict] = {}
    base = None
    for name, pol in rows:
        r = train_row(cfg, pol, device, steps=steps,
                      fused_matmul=fused_matmul)
        if base is None:
            base = r["loss"]
        r["ratio"] = r["loss"] / base
        out[name] = r
        print(f"{name:28s} {r['loss']:10.4f} {r['ratio']:9.3f} "
              f"{r['acc']:8.3f}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help=f"{SMOKE_STEPS} steps a row, no full-width table")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps a row (overrides --smoke's)")
    ap.add_argument("--rows", default="",
                    help="comma list of row names (default: all)")
    ap.add_argument("--fused-matmul", action="store_true",
                    help="DFXP matmuls through the quantized matmul K2")
    ap.add_argument("--kernel-quantize", action="store_true",
                    help="large rounding sites through the quantize K1")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps = args.steps or (SMOKE_STEPS if args.smoke else STEPS)
    rows = fig_rows()
    if args.rows:
        want = ["float32"] + [n for n in args.rows.split(",")
                              if n and n != "float32"]
        by_name = dict(rows)
        rows = [(n, by_name[n]) for n in want]
    enable_pallas_quantize(args.kernel_quantize)
    t0 = time.perf_counter()
    try:
        res = {"names": [n for n, _ in rows], "steps": steps,
               "rows": sweep(CFG, rows, device, steps=steps,
                             fused_matmul=args.fused_matmul)}
        if device.type == "cuda" and not args.smoke:
            wide = [r for r in rows if r[0] == "float32"
                    or r[0].startswith(("fig2/", "fig3/"))]
            res["full_width"] = sweep(FULL, wide, device, steps=steps,
                                      fused_matmul=args.fused_matmul,
                                      label="full PI width: ")
    finally:
        enable_pallas_quantize(False)
    res["seconds"] = time.perf_counter() - t0
    return res


if __name__ == "__main__":
    main()
