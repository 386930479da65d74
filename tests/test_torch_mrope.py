"""M-RoPE and the embeds-input qwen2-vl-72b of the port against the
reference, on the CPU.

* ``apply_rope`` with 3-D positions ``[3, B, S]``: frequency dim ``f``
  takes position stream ``sec_ids[f]`` of ``mrope_sections``
  (qwen2-vl's (16, 24, 24) at head dim 128, its smoke's (4, 6, 6), the
  default one section, a short list whose last stream fills the tail, a
  long one cut at ``hd/2``).  Held bit for bit against the port's own
  2-D rotation: equal streams give the 2-D result, and each section's
  dims are the 2-D rotation by that section's stream; the stream of each
  dim is ``jnp.repeat``'s.  Against the reference within 4e-6 plus what
  the frequencies' last bits turn at these positions (up to 915): the
  port's ``exp``, ``cos`` and ``sin`` are torch's, which differ from
  XLA's CPU approximations in the last bit of some values, as in the
  2-D rotation (the model-level tests below hold the consequence).
* The smoke config (4 layers, embeds of width 128, an untied head, no
  ``embed`` leaf, no ``w:emb/w`` group), on embeds with an image span —
  6 text positions on equal streams, a 1×4×4 patch grid whose height
  and width streams differ, then text again — held as
  ``test_torch_encdec.py`` holds seamless: init bit for bit, float32
  loss and gradients, one DFXP step at the families' bands, prefill and
  decode (decode takes ``[B, 1, D]`` embeds at one position stream, as
  the reference's 2-D decode positions).
* A microbatched step splits M-RoPE's positions on their batch axis
  (axis 1), as the reference's.
* Chunked prefill refuses an embeds-input model, as the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import opt as topt
from repro_torch.train import init_train_state as t_init_state
from repro_torch.train import make_train_step as t_make_step
from test_torch_encdec import (B, S, batch_np, cfgs, dfxp_step_case, exps,
                               float32_grads_case, image_span_positions,
                               init_case, params, prefill_decode_case, to_t)

ARCH = "qwen2_vl_72b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SECTIONS = {"qwen2vl": (128, (16, 24, 24)), "smoke": (32, (4, 6, 6)),
            "default": (32, ()), "short": (32, (4, 6)),
            "long": (32, (8, 8, 8))}


@pytest.mark.parametrize("name", list(SECTIONS))
def test_mrope_apply_rope(name):
    hd, sections = SECTIONS[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, hd)).astype(np.float32)
    pos = image_span_positions(2, 40, 5, 5, 6) + np.array(
        [0, 900], np.int32)[None, :, None]
    theta = 1e6
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta,
                        sections)
    # equal streams are the 2-D rotation, bit for bit
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    np.testing.assert_array_equal(
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(same), theta,
                      sections).numpy(),
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                      theta).numpy())
    # each frequency dim turns by its own section's stream
    ids = np.asarray(TL.mrope_streams(hd, sections or (hd // 2,)))
    want_ids = np.asarray(jnp.repeat(jnp.arange(len(sections or (1,))),
                                     jnp.asarray(sections or (hd // 2,)),
                                     total_repeat_length=hd // 2))
    np.testing.assert_array_equal(ids, want_ids)
    for st in range(3):
        ref2 = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[st]),
                             theta).numpy()
        f = np.flatnonzero(ids == st)
        for half in (0, hd // 2):
            np.testing.assert_array_equal(got.numpy()[..., half + f],
                                          ref2[..., half + f])
    # the reference, within its sin/cos ulps plus what a frequency's
    # last bit (at most one ulp apart) turns at these positions
    fj = np.asarray(JL.rope_freqs(hd, theta))
    dfreq = np.abs(TL.rope_freqs(hd, theta, "cpu").numpy() - fj)
    assert np.all(dfreq <= np.spacing(fj))
    tol = 4e-6 + 2 * np.abs(x).max() * pos.max() * dfreq.max()
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                                    sections))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_init_params_and_groups_match_reference():
    init_case(ARCH)
    gs = TT.group_shapes(cfgs(ARCH)[1])
    assert "w:emb/w" not in gs and "a:emb/out" in gs


def test_float32_loss_and_gradients_match_reference():
    float32_grads_case(ARCH)


def test_dfxp_train_step_matches_reference():
    dfxp_step_case(ARCH)


def test_prefill_and_decode_match_reference():
    prefill_decode_case(ARCH)


def test_microbatches_split_mrope_positions():
    """Two microbatches of one sample each give the loss of the batch's
    two halves, each run alone (float32)."""
    _, tcfg = cfgs(ARCH)
    _, tp = params(ARCH)
    gs = TT.group_shapes(tcfg)
    pol = TPolicy("float32")
    b = to_t(batch_np(cfgs(ARCH)[0]))
    opt = topt.OptConfig(kind="sgd", lr=0.01)

    def loss(p, bb, s, e):
        return TT.loss_fn(tcfg, pol, p, bb, e, s)

    state = t_init_state(tp, topt.sgd_init(tp), gs, pol)
    _, m = t_make_step(loss, gs, pol, opt, microbatches=2)(state, b)
    halves = [{k: (v[:, i:i + 1] if k == "positions" else v[i:i + 1])
               for k, v in b.items()} for i in range(B)]
    want = sum(float(loss(tp, h, {}, state.scale.exps)[0]) for h in halves)
    np.testing.assert_allclose(float(m["loss"]), want / B, rtol=1e-6)


def test_chunked_prefill_refuses_embeds_input():
    _, tcfg = cfgs(ARCH)
    _, tp = params(ARCH)
    _, tex = exps(ARCH)
    cache = TT.init_cache(tcfg, B, S)
    with pytest.raises(ValueError, match="token-in"):
        TT.prefill_chunk_step(tcfg, TPolicy("float32"), tp, cache,
                              torch.zeros((B, 4), dtype=torch.int32),
                              torch.zeros(B, dtype=torch.int32),
                              torch.full((B,), 4, dtype=torch.int32), tex)
