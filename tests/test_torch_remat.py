"""``remat`` in ``repro_torch.models.transformer`` against ``remat="none"``
and against the reference's ``remat``.

* ``"dots"`` and ``"full"`` give the loss, every parameter gradient, the
  forward statistics and the sinks' gradients (the backward statistics)
  of ``"none"`` bit for bit, under DFXP 10/12 and float32, over the dense
  (llama3), MoE (granite), hybrid (zamba2: mamba layers and the shared
  attention and FFN blocks) and encoder-decoder (seamless, its encoder
  stage recomputed too) smoke configs, with the chunked cross-entropy
  on.  The transformer takes no
  dropout in either package, so a recomputed layer has no random stream
  to repeat; a layer returns its statistics and writes nothing else, so a
  recomputation records nothing twice;
* ``"dots"`` keeps the matrix products' outputs: the dry run's counter
  sees ``"none"``'s products under it and more under ``"full"``;
* the reference's ``remat="full"`` loss at the same weights, data and
  exponents within the tolerance of the ``remat="none"`` parity tests
  (``test_torch_families.py``: 1e-5 relative under float32, 2e-4 under
  DFXP), its value and gradients compiled in a spawned process beside
  these tests.
"""
import functools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import ShardingRules
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import transformer as T
from repro_torch.train.state import leaves_with_path
from repro_torch.train.step import loss_and_grads

ARCHS = ("llama3_8b", "granite_moe_1b", "zamba2_1p2b",
         "seamless_m4t_medium")
B, S, S_SRC, CE = 1, 16, 9, 8
INIT_EXP = -6.0
REF_CASES = (("llama3_8b", "float32"), ("llama3_8b", "dfxp"))
LOSS_RTOL = {"float32": 1e-5, "dfxp": 2e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policy(cls, arith):
    if arith == "dfxp":
        return cls("dfxp", comp_width=10, update_width=12)
    return cls("float32")


def _batch(cfg) -> dict:
    """numpy inputs from a seed, the same for both packages."""
    rs = np.random.RandomState(0)
    b = {"labels": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.input_mode == "tokens":
        b["tokens"] = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    else:
        b["embeds"] = rs.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.mrope_sections:
        b["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32),
                                         (3, B, S)).copy()
    if cfg.encoder_layers:
        b["src_embeds"] = rs.standard_normal((B, S_SRC, cfg.d_model)).astype(
            np.float32)
    return b


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The smoke config's weights (read only: the step differentiates
    detached copies)."""
    return T.init_params(configs.get_smoke(arch), 0, device="cpu")


@functools.lru_cache(maxsize=None)
def _run(arch, arith, remat):
    """``(loss, forward stats, grads, sink grads)`` of one forward and
    backward of the smoke config, flattened."""
    cfg = configs.get_smoke(arch)
    pol = _policy(PrecisionPolicy, arith)
    params = _params(arch)
    gs = T.group_shapes(cfg)
    exps = {n: torch.full(s, INIT_EXP) for n, s in gs.items()}
    sinks = {n: torch.zeros(s + (3,), requires_grad=True)
             for n, s in gs.items() if n.startswith("g:")}
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, st, g, sg = loss_and_grads(
        lambda p, b, s, e: T.loss_fn(cfg, pol, p, b, e, s, remat=remat,
                                     ce_chunk=CE),
        params, batch, sinks, exps)
    flat = {"loss": loss}
    flat.update({f"stats/{k}": v for k, v in st.items()})
    flat.update({"grad/" + "/".join(p): v for p, v in leaves_with_path(g)})
    flat.update({f"sink/{k}": v for k, v in sg.items()})
    return flat


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arith", ["dfxp", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_identical(arch, arith, remat):
    want, got = _run(arch, arith, "none"), _run(arch, arith, remat)
    assert list(got) == list(want)
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, differ[:5]
    assert any(k.startswith("sink/") for k in want)


def test_unknown_remat_raises():
    with pytest.raises(ValueError, match="'none', 'dots' or 'full'"):
        _run("llama3_8b", "float32", "some")


def test_dots_keeps_the_products():
    cfg = configs.get_smoke("llama3_8b")
    mesh = AbstractMesh((1, 1), ("data", "model"))
    flops = {}
    for remat in ("none", "dots", "full"):
        cell = D.make_cell(cfg, ShapeSpec("smoke", S, B, "train"),
                           PrecisionPolicy("float32"), mesh,
                           ShardingRules(mesh), remat=remat, ce_chunk=CE)
        flops[remat] = D.trace(cell)["flops"]
    assert flops["dots"] == flops["none"] < flops["full"]


# ---------------------------------------------------------------------------
# the reference's remat="full"
# ---------------------------------------------------------------------------

def _ref_loss(arch, arith):
    """The reference's ``remat="full"`` loss, through ``jax.jit`` of the
    value and gradients, from the same key, data and exponents."""
    import jax
    import jax.numpy as jnp

    from repro import configs as rconfigs
    from repro.core.policy import PrecisionPolicy as RPolicy
    from repro.models import transformer as RT
    cfg = rconfigs.get_smoke(arch)
    pol = _policy(RPolicy, arith)
    params = RT.init_params(cfg, jax.random.PRNGKey(0))
    gs = RT.group_shapes(cfg)
    exps = {n: jnp.full(s, INIT_EXP, jnp.float32) for n, s in gs.items()}
    sinks = {n: jnp.zeros(s + (3,), jnp.float32) for n, s in gs.items()
             if n.startswith("g:")}
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}

    def loss(p, b, s, e):
        return RT.loss_fn(cfg, pol, p, b, e, s, remat="full", ce_chunk=CE)
    (value, _), _ = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 2), has_aux=True))(params, batch, sinks, exps)
    return float(value)


_COMPILER = ProcessPoolExecutor(
    max_workers=len(REF_CASES),
    mp_context=multiprocessing.get_context("spawn"))


@functools.lru_cache(maxsize=None)
def _ref_futures():
    """``{case: future of the reference's loss}``, one process a case."""
    return {c: _COMPILER.submit(_ref_loss, *c) for c in REF_CASES}


@pytest.fixture(scope="module", autouse=True)
def _start_reference():
    _ref_futures()
    yield
    _COMPILER.shutdown(wait=False, cancel_futures=True)


@pytest.mark.parametrize("arch,arith", REF_CASES)
def test_full_remat_loss_matches_reference(arch, arith):
    want = _ref_futures()[arch, arith].result()
    got = float(_run(arch, arith, "full")["loss"])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL[arith])
