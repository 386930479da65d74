"""The port's model and engine (repro_torch) against the reference, on the CPU.

* Model parity through ``params_from_jax``: whole-prompt ``prefill``,
  ``prefill_chunk_step`` and teacher-forced ``decode_step`` logits, on an
  f32 ring and on the int8 packed pool with the fused attention path.
  Under ``float32`` arithmetic the logits agree within atol 1e-4 (f32
  contractions summed in another order).  Under ``dfxp`` every value
  sits on a 2**-6 grid, and where the two backends' f32 sums differ by
  an ulp across a rounding boundary an activation lands one grid step
  away; that shift propagates, so the allowance is: at most 2% of the
  logits differ, and by at most 4 grid steps (4 * 2**-6).
* Engine parity under ``float32`` with an f32 pool, whole-prompt and
  ``prefill_chunk=4``: identical greedy tokens.  The reference's
  teacher-forced logits are checked to separate their top two entries by
  more than the logits tolerance at every generated step, so a flipped
  token could only mean a real fault.
* No module of ``repro_torch`` (nor ``chip_smoke.py``) imports ``jax`` or
  ``repro`` — an AST scan of every file.
"""
import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import ScaleState as JScale
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import transformer as JT
from repro.serve import EngineOptions as JOptions
from repro.serve import ServeEngine as JEngine
from repro.serve import kv_pool as jkv
from repro_torch import configs as tconfigs
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.core.scale import ScaleState as TScale
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import EngineOptions as TOptions
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import kv_pool as tkv

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4
GRID = 2.0 ** -6          # init_exp -6: the logits group's grid step
JCFG = jconfigs.get_smoke("llama3_8b")
TCFG = tconfigs.get_smoke("llama3_8b")


@functools.lru_cache(maxsize=None)
def _params():
    jp = JT.init_params(JCFG, jax.random.PRNGKey(0))
    tp = params_from_jax(TCFG, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jp, tp


def _scales():
    gs = JT.group_shapes(JCFG)
    jex = JScale.create(gs, -6.0).exps
    jsk = {n: jnp.zeros(s + (3,)) for n, s in gs.items() if n.startswith("g:")}
    tex = TScale.create(TT.group_shapes(TCFG), -6.0).exps
    return jex, jsk, tex


def _check(jl, tl, arith, what):
    jl, tl = np.asarray(jl), tl.numpy()
    if arith == "float32":
        np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0, err_msg=what)
        return
    d = np.abs(tl - jl)
    assert d.max() <= 4 * GRID, (what, d.max())
    assert (d > 0).mean() <= 0.02, (what, (d > 0).mean())


@pytest.mark.parametrize("arith", ["float32", "dfxp"])
def test_prefill_and_decode_logits_f32_ring(arith):
    """Whole-prompt prefill into an f32 ring, then teacher-forced decode."""
    jp, tp = _params()
    jex, jsk, tex = _scales()
    jpol, tpol = JPolicy(arith), TPolicy(arith)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, JCFG.vocab_size, (2, 9)).astype(np.int32)
    jpre = jax.jit(lambda t: JT.prefill(JCFG, jpol, jp, {"tokens": t}, jex,
                                        jsk, max_cache_len=16))
    jl, _, jc = jpre(jnp.asarray(toks))
    tl, _, tc = TT.prefill(TCFG, tpol, tp, {"tokens": torch.from_numpy(toks)},
                           tex, max_cache_len=16)
    _check(jl, tl, arith, "prefill")
    jdec = jax.jit(lambda c, t, p: JT.decode_step(JCFG, jpol, jp, c, t, p,
                                                  jex, jsk))
    pos = np.array([9, 9], np.int32)
    for step in range(5):
        tok = rng.integers(0, JCFG.vocab_size, 2).astype(np.int32)
        jl, _, jc = jdec(jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, _, tc = TT.decode_step(TCFG, tpol, tp, tc, torch.from_numpy(tok),
                                   torch.from_numpy(pos), tex)
        _check(jl, tl, arith, f"decode {step}")
        pos = pos + 1


@pytest.mark.parametrize("arith", ["float32", "dfxp"])
def test_chunked_prefill_and_decode_logits_int8_fused(arith):
    """Chunked prefill into the int8 packed pool, then teacher-forced
    decode, both through the fused attention path (the reference's
    Pallas kernels in interpret mode, the port's plain versions)."""
    jp, tp = _params()
    jex, jsk, tex = _scales()
    jpol = JPolicy(arith, fused_decode=True)
    tpol = TPolicy(arith, fused_decode=True)
    jkvp = jkv.make_kv_pool(JCFG, jpol, max_slots=1, max_len=16, cache_bits=8)
    tkvp = tkv.make_kv_pool(TCFG, tpol, max_slots=1, max_len=16,
                            cache_bits=8, device="cpu")
    jpool, tpool = jkvp.pool, tkvp.pool
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, JCFG.vocab_size, 7).astype(np.int32)
    jchunk = jax.jit(lambda c, t, p0, nv: JT.prefill_chunk_step(
        JCFG, jpol, jp, c, t, p0, nv, jex, jsk, kv_codec=jkvp.codec))
    for p0 in (0, 4):
        n = min(4, prompt.size - p0)
        t = np.zeros((1, 4), np.int32)
        t[0, :n] = prompt[p0:p0 + n]
        args = (np.array([p0], np.int32), np.array([n], np.int32))
        jl, _, jpool = jchunk(jpool, jnp.asarray(t), *map(jnp.asarray, args))
        tl, _, tpool = TT.prefill_chunk_step(
            TCFG, tpol, tp, tpool, torch.from_numpy(t),
            *map(torch.from_numpy, args), tex, kv_codec=tkvp.codec)
        _check(jl, tl, arith, f"chunk p0={p0}")
    if arith == "float32":   # f32 K/V quantized identically: same pool bits
        for name in ("k_e", "v_e", "pos"):
            np.testing.assert_array_equal(
                np.asarray(jpool["dec"]["0:attn"][name]),
                tpool["dec"]["0:attn"][name].numpy())
    jdec = jax.jit(lambda c, t, p: JT.decode_step(
        JCFG, jpol, jp, c, t, p, jex, jsk, kv_codec=jkvp.codec))
    pos = np.array([7], np.int32)
    for step in range(4):
        tok = rng.integers(0, JCFG.vocab_size, 1).astype(np.int32)
        jl, _, jpool = jdec(jpool, jnp.asarray(tok), jnp.asarray(pos))
        tl, _, tpool = TT.decode_step(TCFG, tpol, tp, tpool,
                                      torch.from_numpy(tok),
                                      torch.from_numpy(pos), tex,
                                      kv_codec=tkvp.codec)
        _check(jl, tl, arith, f"decode {step}")
        pos = pos + 1


PROMPT_LENS = (5, 9, 6)
MAX_NEW = 6


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, JCFG.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]


@functools.lru_cache(maxsize=None)
def _reference_run(chunk):
    jp, _ = _params()
    eng = JEngine(JCFG, JPolicy("float32"), jp, max_slots=2, max_len=16,
                  options=JOptions(prefill_chunk=chunk))
    uids = [eng.submit(p, max_new=MAX_NEW) for p in _prompts()]
    out = eng.run()
    return [out[u].tolist() for u in uids]


def _top2_gaps(tokens):
    """The reference's teacher-forced logits at every generated step:
    assert they pick ``tokens`` and return their top-two gaps."""
    jp, _ = _params()
    jex, jsk, _ = _scales()
    gaps = []
    for prompt, gen in zip(_prompts(), tokens):
        seq = np.concatenate([prompt, gen[:-1]]).astype(np.int32)
        logits, _, _ = JT.forward(JCFG, JPolicy("float32"), jp,
                                  {"tokens": jnp.asarray(seq[None])}, jex, jsk)
        lg = np.asarray(logits[0, prompt.size - 1:])
        assert lg.argmax(-1).tolist() == gen
        top2 = np.sort(lg, axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
    return gaps


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("chunk", [0, 4], ids=["whole", "chunked"])
def test_engine_greedy_tokens_match_reference(chunk, fused):
    want = _reference_run(chunk)
    assert min(_top2_gaps(want)) > ATOL
    _, tp = _params()
    eng = TEngine(TCFG, TPolicy("float32", fused_decode=fused), tp,
                  max_slots=2, max_len=16,
                  options=TOptions(prefill_chunk=chunk), device="cpu")
    uids = [eng.submit(p, max_new=MAX_NEW) for p in _prompts()]
    out = eng.run()
    assert [out[u].tolist() for u in uids] == want
    assert all(eng.status(u).value == "ok" for u in uids)
    st = eng.stats()
    assert st["requests_finished"] == 3
    assert st["new_tokens"] == 3 * MAX_NEW
    assert st["prefill_chunks"] == (sum(-(-n // 4) for n in PROMPT_LENS)
                                    if chunk else 0)


def test_engine_times_out_when_out_of_steps():
    _, tp = _params()
    eng = TEngine(TCFG, TPolicy("float32"), tp, max_slots=1, max_len=16,
                  device="cpu")
    a = eng.submit(_prompts()[0], max_new=MAX_NEW)
    b = eng.submit(_prompts()[1], max_new=MAX_NEW)
    out = eng.run(max_steps=2)
    assert eng.status(a).value == "timed_out" and out[a].size == 3
    assert eng.status(b).value == "timed_out" and out[b].size == 0


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
