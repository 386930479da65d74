"""seamless-m4t-medium at full width with its depth cut to one encoder
and one decoder layer, trained by the reference's train step and the
port's on a CPU: the losses that ``chip_smoke.py`` holds the card's run
of the same recipe to (``REF_SEAMLESS``).

Neither package's trainer CLI feeds an encoder (its ``SyntheticLM`` data
has no ``src_embeds``), so this calls ``make_train_step`` directly, with
the launcher's recipe and key tree: ``seamless_m4t_medium`` at d_model
1024, 16 heads of 64, gelu FFN 4096, vocab 256256, untied head, 1 + 1 of
its 12 + 12 layers (554M parameters); batch ``i`` is
``SyntheticLM(256256, 64, 8, seed=0).batch(i)`` with ``src_embeds``
``[8, 96, 1024]`` = ``0.1 * default_rng(i).standard_normal`` (96 source
frames against 64 target tokens); SGD lr 0.01 (decay over 1000 steps);
DFXP 10/12 (controller interval 20) calibrated on batches 0-4 from
``init_params(PRNGKey(0))``, then trained from ``init_params(fold_in(
PRNGKey(0), 1))`` for 10 steps; and float32 from the same weights.  The
port runs with ``fused_matmul`` (K2's plain version here), as the card
does::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ref_encdec_train.py
    PYTHONPATH=src python tools/ref_encdec_train.py --port

It prints each row's group count and losses, and last a JSON line of
them.  One encoder and one decoder layer, not 12 + 12: the full model
(877M parameters, 3.5 GB in f32) is not trained on a shared CPU host.
"""
import dataclasses
import json
import sys

import numpy as np

B, S, SRC = 8, 64, 96
STEPS, CALIBRATE = 10, 5


def cut_config(cfg):
    """The full-width config with 1 encoder and 1 decoder layer."""
    return dataclasses.replace(cfg, name="seamless-m4t-medium-l1e1",
                               num_layers=1, encoder_layers=1)


def batch_np(data_cls, vocab: int, i: int) -> dict:
    """Batch ``i``: ``data_cls`` (a package's ``SyntheticLM``) tokens and
    labels, and ``src_embeds``."""
    out = dict(data_cls(vocab, S, B, seed=0).batch(i))
    src = np.random.default_rng(i).standard_normal((B, SRC, 1024))
    out["src_embeds"] = (src * 0.1).astype(np.float32)
    return out


def _reference() -> dict:
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.core.policy import PrecisionPolicy
    from repro.data import SyntheticLM
    from repro.models import transformer as T
    from repro.optim.opt import OptConfig, sgd_init
    from repro.train import init_train_state, make_train_step
    from repro.train.calibrate import calibrate

    cfg = cut_config(configs.get("seamless_m4t_medium"))
    gs = T.group_shapes(cfg)
    opt = OptConfig(kind="sgd", lr=0.01, lr_decay_steps=1000)
    key = jax.random.PRNGKey(0)

    def batch(i):
        return {k: jnp.asarray(v) for k, v in batch_np(
            SyntheticLM, cfg.vocab_size, i).items()}

    out = {}
    for row in ("dfxp", "float32"):
        pol = PrecisionPolicy(row, comp_width=10, update_width=12,
                              update_interval=20)
        init = -8.0
        if pol.dynamic:
            obs = dataclasses.replace(pol, arithmetic="observe")
            init = calibrate(
                lambda p, b, s, e: T.loss_fn(cfg, obs, p, b, e, s),
                T.init_params(cfg, key), gs, pol, opt,
                (batch(i) for i in range(CALIBRATE)), steps=CALIBRATE)
        params = T.init_params(cfg, jax.random.fold_in(key, 1))
        state = init_train_state(params, sgd_init(params), gs, pol,
                                 init_exp=init)
        step = jax.jit(make_train_step(
            lambda p, b, s, e: T.loss_fn(cfg, pol, p, b, e, s), gs, pol,
            opt))
        losses = []
        for i in range(STEPS):
            state, m = step(state, batch(i), key)
            losses.append(round(float(m["loss"]), 4))
        out[row] = {"groups": len(init) if pol.dynamic else None,
                    "losses": losses}
        print(row, out[row]["groups"], losses, flush=True)
        del state, step
    return out


def _port() -> dict:
    import torch
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.data import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.optim.opt import OptConfig, sgd_init
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.calibrate import calibrate

    cfg = cut_config(configs.get("seamless_m4t_medium"))
    gs = T.group_shapes(cfg)
    opt = OptConfig(kind="sgd", lr=0.01, lr_decay_steps=1000)
    key = prng.PRNGKey(0, "cpu")

    def batch(i):
        return {k: torch.from_numpy(v) for k, v in batch_np(
            SyntheticLM, cfg.vocab_size, i).items()}

    out = {}
    for row in ("dfxp", "float32"):
        pol = PrecisionPolicy(row, comp_width=10, update_width=12,
                              update_interval=20,
                              fused_matmul=row == "dfxp")
        init = -8.0
        if pol.dynamic:
            obs = dataclasses.replace(pol, arithmetic="observe")
            init = calibrate(
                lambda p, b, s, e: T.loss_fn(cfg, obs, p, b, e, s),
                T.init_params(cfg, key, device="cpu"), gs, pol, opt,
                (batch(i) for i in range(CALIBRATE)), steps=CALIBRATE)
        params = T.init_params(cfg, prng.fold_in(key, 1), device="cpu")
        state = init_train_state(params, sgd_init(params), gs, pol,
                                 init_exp=init)
        step = make_train_step(
            lambda p, b, s, e: T.loss_fn(cfg, pol, p, b, e, s), gs, pol,
            opt)
        losses = []
        for i in range(STEPS):
            state, m = step(state, batch(i))
            losses.append(round(float(m["loss"]), 4))
        out[row] = {"groups": len(init) if pol.dynamic else None,
                    "losses": losses}
        print(row, out[row]["groups"], losses, flush=True)
        del state
    return out


if __name__ == "__main__":
    print(json.dumps(_port() if "--port" in sys.argv else _reference()))
