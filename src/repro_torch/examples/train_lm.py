"""End-to-end driver: train a ~64M-parameter transformer LM with DFXP
10/12 for a few hundred steps on synthetic data, with calibration,
checkpointing and resume — the reference's production example
(``examples/train_lm.py``) on the card:

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu

Its argv is the reference's (adamw lr 3e-3, batch 16, seq 128, DFXP
10/12, controller interval 20, 5 calibration steps, a checkpoint every
100 steps), through :func:`repro_torch.launch.train.main`.  The
checkpoints go under the temporary directory unless ``--ckpt-dir``;
``--log-every`` sets the loss lines' cadence (the reference's 20).
"""
import argparse
import os
import sys
import tempfile
import types

from repro_torch.launch.train import main as train_main
from repro_torch.models.transformer import ModelConfig

# a ~100M dense transformer, defined inline as in the reference's example
LM_100M = ModelConfig(
    name="lm-100m", family="dense", num_layers=12, d_model=512,
    num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
    tie_embeddings=True)


def register() -> None:
    """Make LM_100M the arch ``lm_100m`` of :mod:`repro_torch.configs`."""
    sys.modules["repro_torch.configs.lm_100m"] = types.SimpleNamespace(
        CONFIG=LM_100M, SMOKE=LM_100M, CELLS=("train_4k",))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--log-every", type=int, default=20,
                    help="print the loss every this many steps")
    args = ap.parse_args(argv)
    register()

    c = LM_100M
    n_params = (c.num_layers * (
        c.d_model * (c.num_heads + 2 * c.num_kv_heads + c.num_heads)
        * c.head_dim + 3 * c.d_model * c.d_ff) + c.vocab_size * c.d_model)
    print(f"~{n_params/1e6:.0f}M params")

    return train_main([
        "--arch", "lm_100m", "--steps", str(args.steps),
        "--global-batch", "16", "--seq-len", "128",
        "--arithmetic", "dfxp", "--comp-width", "10", "--update-width", "12",
        "--update-interval", "20", "--calibrate-steps", "5",
        "--optimizer", "adamw", "--lr", "3e-3",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--log-every", str(args.log_every), "--device", args.device,
    ])


if __name__ == "__main__":
    main()
