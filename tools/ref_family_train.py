"""The trainer's default run, granite-moe-1b at full width with its depth
cut to two layers, through the reference's launcher and the port's on a
CPU: the losses that ``chip_smoke.py`` holds the card's run of the same
argv to (``REF_GRANITE``).

Each launcher trains ``granite_moe_1b_l2`` — ``configs/granite_moe_1b.py``
at d_model 1024, 32 experts top-8, vocab 49408, 2 of its 24 layers
(157M parameters) — with the launcher's defaults (batch 8 x 64, SGD
lr 0.01, DFXP 10/12 with 5 calibration steps, seed 0) for 10 steps, and
again under float32, printing the loss of every step.  The port runs
with ``--fused-matmul`` (K2's plain version here), as the card does::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ref_family_train.py
    PYTHONPATH=src python tools/ref_family_train.py --port

It prints each row's group count and losses, and last a JSON line of
them.  Two layers, not 24: the full model (1.33B parameters, 5.3 GB in
f32, about 20 GB to train) is not run on a shared CPU host.
"""
import contextlib
import dataclasses
import io
import json
import re
import sys
import types

ARCH = "granite_moe_1b_l2"
ARGV = ["--arch", ARCH, "--steps", "10", "--log-every", "1"]
ROWS = {"dfxp": [], "float32": ["--arithmetic", "float32",
                                "--calibrate-steps", "0"]}


def register(package: str) -> None:
    """Register ``granite_moe_1b_l2`` with ``package``'s config registry
    (``repro`` or ``repro_torch``), as the LM example registers LM_100M."""
    if package == "repro":
        from repro.configs import granite_moe_1b as g
    else:
        from repro_torch.configs import granite_moe_1b as g
    cfg = dataclasses.replace(g.CONFIG, name="granite-moe-1b-l2",
                              num_layers=2)
    sys.modules[f"{package}.configs.{ARCH}"] = types.SimpleNamespace(
        CONFIG=cfg, SMOKE=cfg, CELLS=("train_4k",))


def parse(text: str) -> dict:
    m = re.search(r"calibrated (\d+) scale groups", text)
    losses = {int(s): float(v) for s, v in
              re.findall(r"^step (\d+): loss=(\S+)$", text, re.M)}
    return {"groups": int(m.group(1)) if m else None,
            "losses": [losses[s] for s in sorted(losses)]}


def rows(port: bool) -> dict:
    if port:
        from repro_torch.launch import train
        register("repro_torch")
        extra = ["--fused-matmul", "--device", "cpu"]
    else:
        from repro.launch import train
        register("repro")
        extra = []
    out = {}
    for row, flags in ROWS.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(ARGV + flags + extra)
        out[row] = parse(buf.getvalue())
        print(row, out[row]["groups"], out[row]["losses"], flush=True)
    return out


if __name__ == "__main__":
    print(json.dumps(rows(port="--port" in sys.argv)))
