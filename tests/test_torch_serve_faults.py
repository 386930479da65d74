"""The serve engine's robustness and observability layer against the
reference: fault injection, chaos sweeps, the tracer and numerics log.

llama3-smoke on float32 arithmetic over an int8 paged pool (P = 8, 2
slots, max_len 32), where the port's tokens equal the reference's bit
for bit.  Every case runs the same scenario through both packages and
holds the port to the reference exactly:

* ``chaos_plan`` gives the same fault lists for the same seed; a chaos
  sweep (the reference's ``tests/test_faults.py`` engine: 9 pages, a
  page squeeze, 5 new tokens) gives the same statuses, tokens, harness
  log event by event (a bit flip's index, old and new mantissa too),
  counters, trace span/instant/counter names with their counts, and
  numerics records byte for byte but their clock;
* ``LogitNaN`` quarantines its victim ``FAILED`` with its clean prefix
  and spares its sibling (the fault-free run, whose port tokens
  ``tests/test_torch_paged.py`` holds to the reference's); ``KVBitFlip`` flips the same mantissa of a
  paged private page or of the slot-major ring; ``AdmitDelay`` changes
  no token;
* ``ServeMetrics``' series come in the reference's order.

Admission, deadlines, the runaway sentinel, a bit flip on an f32 pool,
``prng.randint`` and the serve CLI are in
``tests/test_torch_serve_admission.py``.  Each
reference run is cached for the module; torch runs on one thread.
"""
import collections
import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import transformer as JT
from repro.obs import NumericsLog as JNumericsLog
from repro.obs import Tracer as JTracer
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.models import transformer as TT
from repro_torch.obs import NumericsLog as TNumericsLog
from repro_torch.obs import Tracer as TTracer

P, MAXLEN = 8, 32
JCFG = jconfigs.get_smoke("llama3_8b")
TCFG = tconfigs.get_smoke("llama3_8b")
COUNTERS = ("requests_submitted", "requests_finished", "requests_rejected",
            "requests_timed_out", "requests_failed", "preemptions",
            "decode_steps", "prefill_chunks", "new_tokens",
            "queue_depth_peak", "pages_allocated", "page_cache_hits",
            "page_cow_forks", "page_evictions", "pages_in_use_peak",
            "pages_registered")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jparams():
    return JT.init_params(JCFG, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _tparams():
    return TT.init_params(TCFG, 0, device="cpu")


def prompts():
    """The reference chaos suite's prompts: two sharing a 16-token
    (two-page) prefix, and a short one."""
    shared = (np.arange(1, 17) % JCFG.vocab_size).astype(np.int32)
    pa = np.concatenate([shared, [17, 18, 19, 20]]).astype(np.int32)
    pb = np.concatenate([shared, [31, 32, 33, 34]]).astype(np.int32)
    pc = (np.arange(5, 15) % JCFG.vocab_size).astype(np.int32)
    return pa, pb, pc


def engine(pkg, *, bits=8, page=P, slots=2, **opts):
    """A float32-arithmetic engine of package ``pkg`` ("ref" or "port")
    on llama3-smoke: chunk P, paged unless ``page=0``, fused attention
    over a packed pool."""
    if pkg == "ref":
        S, pol, params, kw = jserve, JPolicy, _jparams(), {}
    else:
        S, pol, params, kw = tserve, TPolicy, _tparams(), {"device": "cpu"}
    policy = pol("float32", fused_decode=bool(bits), prefill_chunk=P,
                 page_size=page)
    cfg = JCFG if pkg == "ref" else TCFG
    return S.ServeEngine(cfg, policy, params, max_slots=slots,
                         max_len=MAXLEN,
                         options=S.EngineOptions(cache_bits=bits, **opts),
                         **kw)


def outcome(eng, uids, harness=None):
    """What a run is compared on: statuses, tokens, counters and, with a
    harness, its log (JSON round-tripped: the log must serialize)."""
    st = eng.stats()
    out = {"status": [eng.status(u).value for u in uids],
           "tokens": [eng._results[u].tolist() for u in uids],
           "counters": {k: st[k] for k in COUNTERS if k in st}}
    if harness is not None:
        out["log"] = json.loads(json.dumps(harness.summary()))
    return out


# ---------------------------------------------------------------------------
# targeted faults on the paged int8 engine
# ---------------------------------------------------------------------------

def _faults(S, case):
    return {"clean": [],
            "nan": [S.LogitNaN(uid=1, token_idx=2)],
            "flip": [S.KVBitFlip(step=6, uid=1, bit=6)],
            "delay": [S.AdmitDelay(uid=1, until_step=6)]}[case]


def targeted(pkg, case, page=P):
    S = jserve if pkg == "ref" else tserve
    fh = S.FaultHarness(_faults(S, case)) if case != "clean" else None
    eng = engine(pkg, page=page, faults=fh)
    pa, pb, _ = prompts()
    uids = [eng.submit(p, max_new=6) for p in (pa, pb)]
    eng.run()
    return outcome(eng, uids, fh)


@functools.lru_cache(maxsize=None)
def _ref_targeted(case, page=P):
    return targeted("ref", case, page)


def test_logit_nan_quarantines_the_victim_only():
    """The NaN poisons uid 1's third token on the device: uid 1 resolves
    FAILED with its two clean tokens; uid 0 equals the fault-free run."""
    got, want = targeted("port", "nan"), _ref_targeted("nan")
    assert got == want
    clean = _ref_targeted("clean")["tokens"]
    assert got["status"] == ["ok", "failed"]
    assert got["tokens"] == [clean[0], clean[1][:2]]
    assert got["counters"]["requests_failed"] == 1
    assert [ev["kind"] for ev in got["log"]["events"]] == ["logit_nan"]


@pytest.mark.parametrize("page", [P, 0], ids=["paged", "ring"])
def test_kv_bitflip_flips_the_references_mantissa(page):
    """The flip lands on uid 1's newest private page (paged) or its
    newest ring row (slot-major): the same index, bit, old and new
    mantissa as the reference's, and the same tokens after it; uid 0's
    stream is the fault-free one."""
    got, want = targeted("port", "flip", page), _ref_targeted("flip", page)
    assert got == want
    (ev,) = got["log"]["events"]
    assert ev["kind"] == "bit_flip" and ev["old"] ^ ev["new"] == 1 << 6
    assert got["status"][0] == "ok"
    if page:
        assert got["tokens"][0] == _ref_targeted("clean")["tokens"][0]


def test_admit_delay_changes_no_token():
    got, want = targeted("port", "delay"), _ref_targeted("delay")
    assert got == want
    assert got["tokens"] == _ref_targeted("clean")["tokens"]
    assert [ev["kind"] for ev in got["log"]["events"]] == ["admit_released"]


# ---------------------------------------------------------------------------
# seeded chaos sweeps, traced and sampled
# ---------------------------------------------------------------------------

SEEDS = [0, 7, 18]


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_plan_matches_reference(seed):
    want = jserve.chaos_plan(seed, [0, 1, 2], n_steps=24, squeeze_pages=4)
    got = tserve.chaos_plan(seed, [0, 1, 2], n_steps=24, squeeze_pages=4)
    assert [(type(f).__name__, vars(f)) for f in got] == \
        [(type(f).__name__, vars(f)) for f in want]


def chaos(pkg, seed):
    """The reference suite's chaos sweep (int8 pages, an arena of 9
    pages, a squeeze of 4) with a tracer and a numerics log attached."""
    S = jserve if pkg == "ref" else tserve
    tracer = (JTracer if pkg == "ref" else TTracer)()
    num = (JNumericsLog if pkg == "ref" else TNumericsLog)()
    fh = S.FaultHarness(S.chaos_plan(seed, [0, 1, 2], n_steps=24,
                                     squeeze_pages=4), seed=seed)
    eng = engine(pkg, n_pages=9, faults=fh, tracer=tracer,
                 numerics_log=num, numerics_every=2)
    uids = [eng.submit(p, max_new=5) for p in prompts()]
    eng.run()
    assert not eng._queue and not eng._active.any()
    assert all(r is None for r in eng._reqs)
    out = outcome(eng, uids, fh)
    out["trace"] = sorted(collections.Counter(
        (e["name"], e["ph"], e.get("tid")) for e in tracer.events).items())
    out["numerics"] = [json.dumps({k: v for k, v in r.items() if k != "t"})
                       for r in num.records]
    out["series"] = [line.split()[2] for line in
                     eng.metrics.registry.prometheus_text().splitlines()
                     if line.startswith("# TYPE")]
    out["registered"] = list(eng.metrics.registry._m)
    return out


@functools.lru_cache(maxsize=None)
def _ref_chaos(seed):
    return chaos("ref", seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_sweep_matches_reference(seed):
    """Statuses, tokens, the harness log event by event, the counters,
    the trace's names and counts, the numerics records but their clock,
    and the metric series in order: all the reference's."""
    got, want = chaos("port", seed), _ref_chaos(seed)
    for key in ("status", "tokens", "log", "counters", "trace", "numerics",
                "series", "registered"):
        assert got[key] == want[key], key
    assert got["log"]["seed"] == seed
    assert got["counters"]["requests_submitted"] == 3
    assert got["numerics"], "no numerics record"
    names = {name for (name, ph, tid), _ in got["trace"]}
    assert {"admit", "prefill_chunk", "decode_step", "submit", "admitted",
            "finish", "queue"} <= names
    if seed == 8:
        assert got["counters"]["preemptions"] >= 1
        assert "preempt" in names


def test_metric_series_in_reference_order():
    """``ServeMetrics`` registers its series in the reference's order
    (the admission counter after the finished one, the failed counter
    before the preemptions); the text outputs sort them by name."""
    want = _ref_chaos(0)["registered"]
    assert list(tserve.ServeMetrics().registry._m) == want
    assert want.index("serve_requests_rejected") == \
        want.index("serve_requests_finished") + 1
