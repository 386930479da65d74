"""The small public helpers against the reference's, on the CPU:

* ``core.packed.pack_overflow_stats``: the ``(ovf, ovf_half, total)``
  triple bit for bit, at widths 4 to 16;
* ``core.tape.null_tape``: default scales, no sinks, and the same
  rounded weights, activations and products as the reference's;
* ``kernels.qmatmul.ops.qmatmul``: within ``qmatmul.cases.tolerance`` of
  the reference's (interpret mode);
* ``launch.serve.Engine`` (the lockstep greedy server): the reference's
  tokens at llama3-smoke, float32 (one module-cached reference run), over
  the plain and the fused decode attention, and the float32
  ``ServeEngine``'s greedy tokens for the same prompts;
* every public name of this slice (the dispatch layer's selection,
  cache and profile, ``qmm``/``qmatmul``, the helpers) keeps the
  reference's parameters, in order, but the TPU-only ones.
"""
import functools
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import packed as jpacked
from repro.core import tape as jtape
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.kernels.qmatmul import ops as jqops
from repro.launch import serve as jcli
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.core import packed as tpacked
from repro_torch.core import tape as ttape
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.kernels.qmatmul import cases as mcases
from repro_torch.kernels.qmatmul import ops as tqops
from repro_torch.launch import serve as tcli
from repro_torch.models import transformer as TT

S, NEW = 12, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("width", range(4, 17))
def test_pack_overflow_stats_bit_exact(width):
    rng = np.random.default_rng(width)
    x = (rng.standard_normal((37, 29)) * 2.0 ** (width - 4)).astype(
        np.float32)
    x[0, :4] = [np.inf, -np.inf, 0.0, -0.0]
    for e in (-3.0, 0.0, 2.0):
        want = np.asarray(jpacked.pack_overflow_stats(jnp.asarray(x), width,
                                                      e))
        got = tpacked.pack_overflow_stats(torch.from_numpy(x), width, e)
        assert np.array_equal(got.numpy(), want), (width, e)


@pytest.mark.parametrize("arith", ["float32", "dfxp"])
def test_null_tape_matches_reference(arith):
    jt, tt = jtape.null_tape(JPolicy(arith)), ttape.null_tape(TPolicy(arith))
    assert (tt.scales, tt.sinks, tt.stats) == ({}, {}, {})
    assert (jt.scales, jt.sinks) == ({}, {})
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    got = [tt.weight("w", torch.from_numpy(w)), tt.act("a",
                                                       torch.from_numpy(x)),
           tt.dot("d", torch.from_numpy(x), torch.from_numpy(w))]
    want = [jt.weight("w", jnp.asarray(w)), jt.act("a", jnp.asarray(x)),
            jt.dot("d", jnp.asarray(x), jnp.asarray(w))]
    for g, r in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert sorted(tt.stats) == sorted(jt.stats)


@pytest.mark.parametrize("width", [8, 10, 16])
def test_qmatmul_matches_reference(width):
    rng = np.random.default_rng(width)
    a = rng.standard_normal((48, 56)).astype(np.float32)
    b = rng.standard_normal((56, 40)).astype(np.float32)
    want = np.asarray(jqops.qmatmul(jnp.asarray(a), jnp.asarray(b), -6.0,
                                    -6.0, width=width, interpret=True))
    got = tqops.qmatmul(torch.from_numpy(a), torch.from_numpy(b), -6.0, -6.0,
                        width=width)
    np.testing.assert_allclose(got.numpy(), want, **mcases.tolerance(56))


@functools.lru_cache(maxsize=None)
def _prompts():
    cfg = jconfigs.get_smoke("llama3_8b")
    return np.asarray(jax.random.randint(jax.random.PRNGKey(7), (2, S), 0,
                                         cfg.vocab_size), np.int32)


@functools.lru_cache(maxsize=None)
def _reference_tokens():
    cfg = jconfigs.get_smoke("llama3_8b")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    eng = jcli.Engine(cfg, JPolicy("float32"), params, max_len=S + NEW)
    return np.asarray(eng.generate(jnp.asarray(_prompts()), NEW))


@functools.lru_cache(maxsize=None)
def _tparams():
    return TT.init_params(tconfigs.get_smoke("llama3_8b"), 0, device="cpu")


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_lockstep_engine_matches_reference(fused):
    cfg = tconfigs.get_smoke("llama3_8b")
    pol = TPolicy("float32", fused_decode=fused)
    got = tcli.Engine(cfg, pol, _tparams(), max_len=S + NEW).generate(
        _prompts(), NEW)
    assert got.dtype == torch.int32 and got.shape == (2, NEW)
    assert np.array_equal(got.numpy(), _reference_tokens())
    eng = tserve.ServeEngine(cfg, pol, _tparams(), max_slots=2,
                             max_len=S + NEW, device="cpu")
    uids = [eng.submit(p, max_new=NEW) for p in _prompts()]
    eng.run()
    assert [eng.results[u].tolist() for u in uids] == got.tolist()


# the reference's TPU-only arguments, which the port leaves out
TPU_ONLY = {"blocks", "cast", "out_dtype", "interpret"}
NAMES = [
    ("kernels.dispatch", n) for n in (
        "blocks_for", "attn_blocks_for", "prefill_blocks_for",
        "paged_attn_blocks_for", "paged_prefill_blocks_for",
        "autotune_cache", "reset_autotune", "set_autotune", "save_autotune",
        "load_autotune", "profile_enable", "reset_profile", "profile_stats",
        "profile_table", "profile_trace_counters")] + [
    ("kernels.qmatmul.ops", "qmm"), ("kernels.qmatmul.ops", "qmatmul"),
    ("core.tape", "null_tape"), ("core.packed", "pack_overflow_stats"),
    ("launch.serve", "Engine"), ("launch.serve", "Engine.generate")]


@pytest.mark.parametrize("mod,name", NAMES,
                         ids=[f"{m}.{n}" for m, n in NAMES])
def test_public_names_keep_the_reference_signatures(mod, name):
    """Each name the reference has exists in the port with the
    reference's parameters, in order, but the TPU-only ones; the
    dispatch layer's selection keeps ``interpret`` (the plain versions'
    path)."""
    def get(pkg):
        obj = importlib.import_module(f"{pkg}.{mod}")
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj
    drop = set() if mod == "kernels.dispatch" else TPU_ONLY
    want = [p for p in inspect.signature(get("repro")).parameters
            if p not in drop]
    got = list(inspect.signature(get("repro_torch")).parameters)
    assert got[:len(want)] == want
