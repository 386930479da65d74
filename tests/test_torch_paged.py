"""The port's paged serving path (repro_torch.serve.paged) against the reference.

Mirrors ``tests/test_paged_pool.py``.  Inputs are made with numpy from a
seed and go through both packages on the CPU (the reference's paged
kernels in interpret mode, the port's wrappers as their plain versions):

* codec: ``PagedKVCodec.append_chunk`` / ``append`` at int8, int16 and
  f32 across page boundaries, a mid-page continuation, masked rows and
  ``update_interval`` crossings — mantissas, per-page exponents,
  ``acc_*``, ``tot_*``, ``pos`` and ``n_app`` bit-exact; the null page
  stays zero.  The port's per-page leaves carry one scratch page past the
  reference's arena (the drop target of masked rows), so the comparison
  covers the reference's ``n_pages`` pages;
* pool ops (``reset_slot``, ``cow_page``, ``set_block``,
  ``slice_slot``/``merge_slot``): the same pool, exactly;
* ``PageAllocator``: the same decisions on one scripted sequence;
* plain versions of K5/K6 against the reference's kernels: atol = rtol =
  1e-5 (f32 contractions summed in another order);
* engine: greedy tokens and page counters equal the reference engine's
  at smoke size (P = C = 8, float32 arithmetic over int8 pages, fused);
  paged tokens equal slot-major tokens; preemption and exhaustion.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.kernels.attn.ops import flash_decode_paged as j_decode_paged
from repro.kernels.attn.ops import flash_prefill_paged as j_prefill_paged
from repro.models import transformer as JT
from repro.serve import EngineOptions as JOptions
from repro.serve import ServeEngine as JEngine
from repro.serve import kv_pool as jkv
from repro.serve import paged as jpaged
from repro_torch import configs as tconfigs
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.kernels.attn import ops as tops
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import EngineOptions as TOptions
from repro_torch.serve import RequestStatus
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import kv_pool as tkv
from repro_torch.serve import paged as tpaged

P, NBLK, B, K, HD = 4, 5, 3, 2, 8
N_PAGES = 1 + B * NBLK
WIDTHS = [8, 16, None]
WIDTH_IDS = ["int8", "int16", "f32"]


# ---------------------------------------------------------------------------
# codec (one layer, no model)
# ---------------------------------------------------------------------------

def _codecs(width):
    if width is None:
        return jpaged.PagedKVCodec(P), tpaged.PagedKVCodec(P)
    cfg = dict(width=width, update_interval=4)
    return (jpaged.PagedKVCodec(P, jkv.CacheQuantConfig(**cfg)),
            tpaged.PagedKVCodec(P, tkv.CacheQuantConfig(**cfg)))


def _bt():
    """Block tables in a non-monotone page order, null past each use."""
    return np.array([[7, 2, 11, 4, 13],
                     [3, 9, 14, 5, 0],
                     [12, 6, 1, 0, 0]], np.int32)


def _fresh(jc, tc):
    W = NBLK * P
    raw = {"k": np.zeros((1, B, W, K, HD), np.float32),
           "v": np.zeros((1, B, W, K, HD), np.float32),
           "pos": np.full((1, B, W), -1, np.int32)}
    je = jax.tree_util.tree_map(
        lambda a: a[0], jc.init_like({k: jnp.asarray(v)
                                      for k, v in raw.items()}, N_PAGES))
    te = {k: v[0] for k, v in tc.init_like(
        {k: torch.from_numpy(v) for k, v in raw.items()}, N_PAGES).items()}
    je["bt"] = jnp.asarray(_bt())
    te["bt"] = torch.from_numpy(_bt())
    return je, te


def _assert_entry_equal(je, te, what=""):
    assert set(je) == set(te)
    for name in je:
        j = np.asarray(je[name])
        t = te[name].numpy()
        if name in tpaged.PAGE_KEYS:          # the port's scratch page
            assert t.shape[0] == j.shape[0] + 1
            t = t[:-1]
        np.testing.assert_array_equal(t, j, err_msg=f"{what} {name}")


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_codec_append_chunk_and_append_exact(width):
    rng = np.random.default_rng(0 if width is None else width)
    jc, tc = _codecs(width)
    je, te = _fresh(jc, tc)
    C = 6
    # admission chunks (slot 2 writes nothing), then a mid-page
    # continuation across the next page boundary with a ragged tail
    for p0, nv, gain in (([0, 0, 0], [6, 4, 0], 1.0),
                         ([6, 4, 0], [5, 3, 2], 3.0)):
        kn = (gain * rng.standard_normal((B, C, K, HD))).astype(np.float32)
        vn = rng.standard_normal((B, C, K, HD)).astype(np.float32)
        args = (np.asarray(p0, np.int32), np.asarray(nv, np.int32))
        je = jc.append_chunk(je, jnp.asarray(kn), jnp.asarray(vn),
                             *map(jnp.asarray, args))
        te = tc.append_chunk(te, torch.from_numpy(kn), torch.from_numpy(vn),
                             *map(torch.from_numpy, args))
        _assert_entry_equal(je, te, f"chunk p0={p0}")
    # decode appends: masked rows, page boundaries, interval crossings,
    # magnitudes that move the §5 controller both ways
    pos = np.array([11, 7, 2], np.int32)
    moved = 0
    for step in range(8):
        gain = 8.0 if step in (1, 2) else 0.02 if step > 4 else 1.0
        kn = (gain * rng.standard_normal((B, K, HD))).astype(np.float32)
        vn = (gain * rng.standard_normal((B, K, HD))).astype(np.float32)
        mask = None if step % 3 else np.array([True, step % 2 == 0, True])
        before = None if width is None else te["k_e"].clone()
        je = jc.append(je, jnp.asarray(kn), jnp.asarray(vn),
                       jnp.asarray(pos),
                       mask=None if mask is None else jnp.asarray(mask))
        te = tc.append(te, torch.from_numpy(kn), torch.from_numpy(vn),
                       torch.from_numpy(pos),
                       mask=None if mask is None else torch.from_numpy(mask))
        _assert_entry_equal(je, te, f"append {step}")
        if width is not None:
            moved += int((te["k_e"] != before)[:-1].sum())
        pos = pos + (1 if mask is None else mask.astype(np.int32))
    if width is not None:
        assert moved > 0                      # calibration and controller
    assert not te["k_m"][0].any() and not te["v_m"][0].any()   # null page


@pytest.mark.parametrize("width", [8, None], ids=["int8", "f32"])
def test_pool_ops_exact(width):
    """reset_slot, cow_page, set_block, slice_slot/merge_slot around a
    chunk written through the slice: the same pool as the reference."""
    rng = np.random.default_rng(1)
    jc, tc = _codecs(width)
    je, te = _fresh(jc, tc)
    kn = rng.standard_normal((B, 8, K, HD)).astype(np.float32)
    args = (np.zeros(B, np.int32), np.array([8, 6, 3], np.int32))
    je = jc.append_chunk(je, jnp.asarray(kn), jnp.asarray(kn),
                         *map(jnp.asarray, args))
    te = tc.append_chunk(te, torch.from_numpy(kn), torch.from_numpy(kn),
                         *map(torch.from_numpy, args))
    jpool = {"dec": {"0:attn": jax.tree_util.tree_map(lambda a: a[None],
                                                      je)}}
    tpool = {"dec": {"0:attn": {k: v[None].clone() for k, v in te.items()}}}

    def same(what):
        _assert_entry_equal(
            jax.tree_util.tree_map(lambda a: a[0], jpool["dec"]["0:attn"]),
            {k: v[0] for k, v in tpool["dec"]["0:attn"].items()}, what)

    # slot 1 re-admitted sharing slot 0's rows 0..5 (page 2 mid-page)
    row = np.array([7, 2, 0, 0, 0], np.int32)
    jpool = jpaged.reset_slot(jpool, 1, 6, jnp.asarray(row), 6.0)
    tpaged.reset_slot(tpool, 1, 6, row, 6.0)
    same("reset_slot")
    jpool = jpaged.cow_page(jpool, 2, 5)
    tpaged.cow_page(tpool, 2, 5)
    same("cow_page")
    jpool = jpaged.set_block(jpool, 1, 1, 5)
    tpaged.set_block(tpool, 1, 1, 5)
    jpool = jpaged.set_block(jpool, 1, 2, 6)
    tpaged.set_block(tpool, 1, 2, 6)
    same("set_block")
    # a chunk for slot 1 written through the one-slot view
    kn = rng.standard_normal((1, 4, K, HD)).astype(np.float32)
    args = (np.array([6], np.int32), np.array([4], np.int32))
    jsub = jpaged.slice_slot(jpool, 1)
    e = jax.tree_util.tree_map(lambda a: a[0], jsub["dec"]["0:attn"])
    e = jc.append_chunk(e, jnp.asarray(kn), jnp.asarray(kn),
                        *map(jnp.asarray, args))
    jsub = {"dec": {"0:attn": jax.tree_util.tree_map(lambda a: a[None], e)}}
    jpool = jpaged.merge_slot(jpool, jsub, 1)
    tsub = tpaged.slice_slot(tpool, 1)
    assert tsub["dec"]["0:attn"]["k_m"] is tpool["dec"]["0:attn"]["k_m"]
    # write through copies, so merge_slot has to carry every leaf back
    ts = {k: v.clone() for k, v in tsub["dec"]["0:attn"].items()}
    tsub = {"dec": {"0:attn": ts}}
    new = tc.append_chunk({k: v[0] for k, v in ts.items()},
                          torch.from_numpy(kn), torch.from_numpy(kn),
                          *map(torch.from_numpy, args))
    for name, t in new.items():
        ts[name][0].copy_(t)
    tpaged.merge_slot(tpool, tsub, 1)
    same("slice/merge")
    # the shared page's bytes are those slot 0 wrote; the fork moved on
    tk = tpool["dec"]["0:attn"]["k_m"][0]
    assert torch.equal(tk[5][:2], tk[2][:2])
    assert not torch.equal(tk[5][2:], tk[2][2:])


def test_overflow_views_match_reference():
    """overflow_summary (shared pages once), slot_overflow_rates and
    slot_totals over a paged int8 pool with a shared page."""
    rng = np.random.default_rng(2)
    jc, tc = _codecs(8)
    je, te = _fresh(jc, tc)
    kn = (4 * rng.standard_normal((B, 8, K, HD))).astype(np.float32)
    args = (np.zeros(B, np.int32), np.array([8, 5, 3], np.int32))
    je = jc.append_chunk(je, jnp.asarray(kn), jnp.asarray(kn),
                         *map(jnp.asarray, args))
    te = tc.append_chunk(te, torch.from_numpy(kn), torch.from_numpy(kn),
                         *map(torch.from_numpy, args))
    shared = np.array([[7, 2, 0, 0, 0], [7, 2, 0, 0, 0], [12, 0, 0, 0, 0]],
                      np.int32)
    je["bt"] = jnp.asarray(shared)
    te["bt"] = torch.from_numpy(shared)
    jpool = {"dec": {"0:attn": jax.tree_util.tree_map(lambda a: a[None],
                                                      je)}}
    tpool = {"dec": {"0:attn": {k: v[None] for k, v in te.items()}}}
    for act in (None, np.array([True, True, False]),
                np.array([False, False, False])):
        assert tkv.overflow_summary(tpool, act) == \
            jkv.overflow_summary(jpool, act)
    np.testing.assert_array_equal(
        tkv.slot_overflow_rates(tpool, B).numpy(),
        np.asarray(jkv.slot_overflow_rates(jpool, B)))
    for s in range(B):
        np.testing.assert_array_equal(tkv.slot_totals(tpool, s).numpy(),
                                      np.asarray(jkv.slot_totals(jpool, s)))
    assert tpaged.page_nbytes(tpool) == jpaged.page_nbytes(jpool)
    # a slot-major packed pool's per-slot reservation, for comparison
    jslot = jkv.make_kv_pool(JCFG, JPolicy(), max_slots=2, max_len=16,
                             cache_bits=8).pool
    tslot = tkv.make_kv_pool(TCFG, TPolicy(), max_slots=2, max_len=16,
                             cache_bits=8, device="cpu").pool
    assert tpaged.slot_nbytes(tslot) == jpaged.slot_nbytes(jslot) > 0


# ---------------------------------------------------------------------------
# allocator
# ---------------------------------------------------------------------------

def test_allocator_same_decisions():
    """alloc, ensure_block with COW, match_prefix with the L-1 cap,
    register_prefix, free_slot, LRU eviction, grab/ungrab and exhaustion:
    the same returns, block tables, refcounts and stats."""
    al = {"j": jpaged.PageAllocator(9, 4, 4),
          "t": tpaged.PageAllocator(9, 4, 4)}
    a = (np.arange(12) % 7).astype(np.int32)
    b = np.concatenate([a[:8], [50, 51, 52]]).astype(np.int32)

    def both(fn):
        out = {k: fn(v) for k, v in al.items()}
        assert repr(out["j"]) == repr(out["t"]), out
        np.testing.assert_array_equal(al["j"].rc, al["t"].rc)
        assert al["j"].stats() == al["t"].stats()
        assert set(al["j"].bt) == set(al["t"].bt)
        for s in al["j"].bt:
            np.testing.assert_array_equal(al["j"].bt[s], al["t"].bt[s])
        return out["t"]

    both(lambda x: x.match_prefix(a))
    both(lambda x: x.new_slot(0, []).tolist())
    for blk in range(3):
        both(lambda x: x.ensure_block(0, blk))
    both(lambda x: x.register_prefix(0, a))
    pages, shared = both(lambda x: x.match_prefix(b))       # 2 pages hit
    assert shared == 8
    both(lambda x: x.new_slot(1, pages).tolist())
    both(lambda x: x.ensure_block(1, 2))                    # fresh page
    pages, shared = both(lambda x: x.match_prefix(a))       # L-1 cap
    assert shared == 11
    both(lambda x: x.new_slot(2, pages).tolist())
    assert both(lambda x: x.ensure_block(2, 2))[0] == "cow"
    both(lambda x: x.ensure_block(2, 2))                    # now private
    both(lambda x: x.free_slot(0))
    both(lambda x: x.free_slot(2))
    held = both(lambda x: x.grab(3))
    both(lambda x: x.ungrab(held))
    for i in range(4):                                      # churn → evict
        t = (100 * (i + 1) + np.arange(8)).astype(np.int32)
        both(lambda x: x.match_prefix(t))
        both(lambda x: x.new_slot(0, []).tolist())
        both(lambda x: [x.ensure_block(0, blk) for blk in range(2)])
        both(lambda x: x.register_prefix(0, t))
        both(lambda x: x.free_slot(0))
    assert al["t"].stats()["page_evictions"] > 0
    both(lambda x: x.new_slot(3, []).tolist())
    for blk in range(4):
        both(lambda x: x.ensure_block(3, blk))
    both(lambda x: x.grab(20))                # evicts, then runs dry
    with pytest.raises(tpaged.PageExhausted, match="exhausted"):
        al["t"].alloc()
    with pytest.raises(jpaged.PageExhausted, match="exhausted"):
        al["j"].alloc()


# ---------------------------------------------------------------------------
# plain K5 / K6 against the reference's kernels
# ---------------------------------------------------------------------------

def _arena_case(rng, width, n_pages, Pk, nblocks, Kh, hd, fills, mapped):
    perm = list(1 + rng.permutation(n_pages - 1))
    Bq = len(fills)
    bt = np.zeros((Bq, nblocks), np.int32)
    pos = np.full((Bq, nblocks * Pk), -1, np.int32)
    for b in range(Bq):
        for j in range(-(-mapped[b] // Pk)):
            bt[b, j] = perm.pop()
        pos[b, :fills[b]] = np.arange(fills[b])
    shape = (n_pages, Pk, Kh, hd)
    if width is None:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ke = ve = None
    else:
        hi = 2 ** (width - 1)
        dt = np.int8 if width == 8 else np.int16
        k = rng.integers(-hi, hi, shape).astype(dt)
        v = rng.integers(-hi, hi, shape).astype(dt)
        ke = rng.integers(1 - width, 4 - width, n_pages).astype(np.float32)
        ve = rng.integers(1 - width, 4 - width, n_pages).astype(np.float32)
    k[0] = 0
    v[0] = 0
    return k, v, bt, pos, ke, ve


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
@pytest.mark.parametrize("window", [None, 6], ids=["global", "window"])
def test_plain_decode_paged_matches_reference(width, window):
    rng = np.random.default_rng(3)
    Pk, nblocks, Kh, G, hd = 8, 4, 2, 2, 16
    fills = [32, 13, 0]                       # full, ragged, null-only
    k, v, bt, pos, ke, ve = _arena_case(rng, width, 12, Pk, nblocks, Kh, hd,
                                        fills, fills)
    q = rng.standard_normal((3, Kh, G, hd)).astype(np.float32)
    qpos = np.array([31, 12, 0], np.int32)
    kw = dict(width=width, scale=hd ** -0.5, window=window)
    want = j_decode_paged(*map(_j, (q, k, v, bt, pos, qpos, ke, ve)), **kw)
    got = tops.flash_decode_paged(*map(_t, (q, k, v, bt, pos, qpos, ke, ve)),
                                  **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert not got[2].any()                   # empty slot: 0, not NaN


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_plain_prefill_paged_matches_reference(width):
    rng = np.random.default_rng(4)
    Pk, nblocks, Kh, G, hd, C = 8, 5, 2, 2, 16, 8
    p0, nv = [13, 0, 24], [8, 5, 3]
    k, v, bt, pos, ke, ve = _arena_case(
        rng, width, 14, Pk, nblocks, Kh, hd, p0,
        [a + n for a, n in zip(p0, nv)])
    q = rng.standard_normal((3, C, Kh, G, hd)).astype(np.float32)
    kn = rng.standard_normal((3, C, Kh, hd)).astype(np.float32)
    vn = rng.standard_normal((3, C, Kh, hd)).astype(np.float32)
    p0a, nva = np.asarray(p0, np.int32), np.asarray(nv, np.int32)
    kw = dict(width=width, scale=hd ** -0.5)
    args = (q, kn, vn, k, v, bt, pos, p0a, nva, ke, ve)
    want = j_prefill_paged(*map(_j, args), **kw)
    got = tops.flash_prefill_paged(*map(_t, args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert not got[1, 5:].any()               # rows past n_valid: 0


# ---------------------------------------------------------------------------
# engine (smoke model)
# ---------------------------------------------------------------------------

P_ENG = 8
MAXLEN = 32
JCFG = jconfigs.get_smoke("llama3_8b")
TCFG = tconfigs.get_smoke("llama3_8b")


@functools.lru_cache(maxsize=None)
def _params():
    jp = JT.init_params(JCFG, jax.random.PRNGKey(0))
    tp = params_from_jax(TCFG, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jp, tp


def _prompts():
    shared = (np.arange(1, 17) % JCFG.vocab_size).astype(np.int32)  # 2 pages
    pa = np.concatenate([shared, [17, 18, 19, 20]]).astype(np.int32)
    pb = np.concatenate([shared, [31, 32, 33, 34]]).astype(np.int32)
    return pa, pb


def _torch_engine(*, bits=8, fused=True, page=True, slots=2, n_pages=None):
    _, tp = _params()
    pol = TPolicy("float32", fused_decode=fused, prefill_chunk=P_ENG,
                  page_size=P_ENG if page else 0)
    return TEngine(TCFG, pol, tp, max_slots=slots, max_len=MAXLEN,
                   options=TOptions(cache_bits=bits, n_pages=n_pages),
                   device="cpu")


def _run(eng, prompts, max_new=6):
    uids = [eng.submit(p, max_new=max_new) for p in prompts]
    out = eng.run()
    return [out[u].tolist() for u in uids]


COUNTERS = ("page_cache_hits", "page_cow_forks", "pages_allocated",
            "prefill_chunks")


@functools.lru_cache(maxsize=None)
def _reference(case):
    jp, _ = _params()
    pa, pb = _prompts()
    prompts = [pa, pb] if case == "shared" else [pa[:16], pa[:16]]
    pol = JPolicy("float32", fused_decode=True, prefill_chunk=P_ENG,
                  page_size=P_ENG)
    eng = JEngine(JCFG, pol, jp, max_slots=2, max_len=MAXLEN,
                  options=JOptions(cache_bits=8))
    toks = _run(eng, prompts)
    st = eng.stats()
    return toks, {c: st[c] for c in COUNTERS}


@pytest.mark.parametrize("case", ["shared", "identical"])
def test_engine_tokens_and_page_counters_match_reference(case):
    """A shared 16-token prefix (page hits), and two identical
    page-aligned prompts (hits plus a copy-on-write fork)."""
    want, want_st = _reference(case)
    pa, pb = _prompts()
    prompts = [pa, pb] if case == "shared" else [pa[:16], pa[:16]]
    eng = _torch_engine()
    assert _run(eng, prompts) == want
    st = eng.stats()
    assert {c: st[c] for c in COUNTERS} == want_st
    assert st["page_cache_hits"] >= 1
    if case == "identical":
        assert st["page_cow_forks"] >= 1
        assert want[0] == want[1]


@pytest.mark.parametrize("bits,fused", [(0, False), (8, True), (16, False)])
def test_paged_matches_slot_major(bits, fused):
    prompts = _prompts()
    ref = _run(_torch_engine(bits=bits, fused=fused, page=False), prompts)
    assert _run(_torch_engine(bits=bits, fused=fused), prompts) == ref


def test_exhaustion_preempts_and_resumes_bit_identical():
    """Four usable pages for two requests that need six at peak: the
    younger is preempted, requeued with its tokens carried, and resumed;
    at f32 both streams equal their solo runs, and the reference engine
    takes the same tokens and the same number of preemptions."""
    pa, pb = _prompts()
    eng = _torch_engine(bits=0, fused=False, n_pages=5)
    out = _run(eng, [pa, pb])
    assert all(s is RequestStatus.OK for s in eng.statuses.values())
    st = eng.stats()
    assert st["preemptions"] >= 1
    jp, _ = _params()
    jeng = JEngine(JCFG, JPolicy("float32", prefill_chunk=P_ENG,
                                 page_size=P_ENG), jp, max_slots=2,
                   max_len=MAXLEN, options=JOptions(n_pages=5))
    assert _run(jeng, [pa, pb]) == out
    assert jeng.stats()["preemptions"] == st["preemptions"]
    assert sum(t.preempts for t in eng.metrics.traces.values()) == \
        st["preemptions"]
    solo = [_run(_torch_engine(bits=0, fused=False, slots=1), [p])[0]
            for p in (pa, pb)]
    assert out == solo


def test_lone_request_that_cannot_fit_fails():
    pa, _ = _prompts()
    eng = _torch_engine(bits=0, fused=False, slots=1, n_pages=3)
    uid = eng.submit(pa, max_new=6)
    out = eng.run()
    assert eng.status(uid) is RequestStatus.FAILED
    assert out[uid].size == 0                 # died mid-prefill
    assert eng.stats()["requests_failed"] == 1
