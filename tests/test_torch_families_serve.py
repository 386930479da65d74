"""The port's engine serving the other token-in families, against the
reference engine, on the CPU.

* Greedy tokens equal the reference engine's for granite-smoke (MoE),
  mamba2-smoke (SSM), zamba2-smoke (hybrid, shared attention) and
  gemma3-smoke (windows of 16, qk-norm, embed scale; prompts past the
  window so its rings wrap, chunk 8), under ``float32`` arithmetic, over
  the f32 pool and the int8 pool (fused attention, the plain kernel
  versions here; mamba2 over the f32 pool only: with no attention its
  int8 pool holds the same f32 conv windows and states).  Both engines run the same schedule: the reference
  chunks the dense family only, and so does the port.
* The port keeps MoE, SSM and hybrid models on whole-prompt prefill when
  a chunk is asked for (no chunk runs), as the reference does.
* The paged pool refuses a windowed model (one ring cap) and an SSM
  model (non-attention entries), with the reference's messages.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import transformer as JT
from repro.serve import EngineOptions as JOptions
from repro.serve import ServeEngine as JEngine
from repro.serve import kv_pool as jkv
from repro_torch import configs as tconfigs
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import EngineOptions as TOptions
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import kv_pool as tkv

ARCHS = ("granite_moe_1b", "mamba2_370m", "zamba2_1p2b", "gemma3_27b")
MAX_NEW = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunk(arch):
    return 8 if arch == "gemma3_27b" else 0


def _prompts(arch):
    cfg = jconfigs.get_smoke(arch)
    lens = (19, 23, 19) if arch == "gemma3_27b" else (7, 11, 7)
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg = jconfigs.get_smoke(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(tconfigs.get_smoke(arch),
                         jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jp, tp


def _max_len(arch):
    return max(p.size for p in _prompts(arch)) + MAX_NEW


@functools.lru_cache(maxsize=None)
def _reference_run(arch, bits):
    jp, _ = _params(arch)
    eng = JEngine(jconfigs.get_smoke(arch),
                  JPolicy("float32", fused_decode=bool(bits)), jp,
                  max_slots=2, max_len=_max_len(arch),
                  options=JOptions(cache_bits=bits,
                                   prefill_chunk=_chunk(arch)))
    uids = [eng.submit(p, max_new=MAX_NEW) for p in _prompts(arch)]
    out = eng.run()
    return [out[u].tolist() for u in uids], eng.stats()["prefill_chunks"]


@pytest.mark.parametrize("arch,bits", [
    (a, b) for a in ARCHS for b in (0, 8)
    if not (a == "mamba2_370m" and b)])     # no attention: no int8 entry
def test_engine_greedy_tokens_match_reference(arch, bits):
    want, ref_chunks = _reference_run(arch, bits)
    _, tp = _params(arch)
    eng = TEngine(tconfigs.get_smoke(arch),
                  TPolicy("float32", fused_decode=bool(bits)), tp,
                  max_slots=2, max_len=_max_len(arch),
                  options=TOptions(cache_bits=bits,
                                   prefill_chunk=_chunk(arch)),
                  device="cpu")
    uids = [eng.submit(p, max_new=MAX_NEW) for p in _prompts(arch)]
    out = eng.run()
    assert [out[u].tolist() for u in uids] == want
    assert all(eng.status(u).value == "ok" for u in uids)
    chunks = eng.stats()["prefill_chunks"]
    assert chunks == ref_chunks
    if arch == "gemma3_27b":
        assert chunks == sum(-(-p.size // 8) for p in _prompts(arch))
        # the local rings (cap 16) hold the last 16 positions only
        pool = eng._pool["dec"]["0:attn"]
        assert pool["pos"].shape[2] == 16
        assert int(pool["pos"].max()) >= 16


@pytest.mark.parametrize("arch", ["granite_moe_1b", "mamba2_370m",
                                  "zamba2_1p2b"])
def test_moe_ssm_hybrid_keep_whole_prompt(arch):
    _, tp = _params(arch)
    eng = TEngine(tconfigs.get_smoke(arch), TPolicy("float32"), tp,
                  max_slots=2, max_len=_max_len(arch),
                  options=TOptions(prefill_chunk=4), device="cpu")
    assert eng.prefill_chunk == 0
    uids = [eng.submit(p, max_new=2) for p in _prompts(arch)]
    eng.run()
    assert all(eng.status(u).value == "ok" for u in uids)
    assert eng.stats()["prefill_chunks"] == 0


@pytest.mark.parametrize("arch,match", [
    ("gemma3_27b", "one ring cap"),
    ("mamba2_370m", "dense attention family"),
    ("zamba2_1p2b", "dense attention family"),
    ("granite_moe_1b", "dense attention family")])
def test_paged_pool_refuses_what_the_reference_refuses(arch, match):
    tcfg, jcfg = tconfigs.get_smoke(arch), jconfigs.get_smoke(arch)
    with pytest.raises(ValueError, match=match):
        jkv.make_kv_pool(jcfg, JPolicy("float32"), max_slots=2, max_len=32,
                         page_size=8)
    with pytest.raises(ValueError, match=match):
        tkv.make_kv_pool(tcfg, TPolicy("float32"), max_slots=2, max_len=32,
                         page_size=8, device="cpu")
