"""The dispatch layer's plan selection, persisted cache and profile
(``repro_torch.kernels.dispatch``) against the reference's
(``repro.kernels.dispatch``), on the CPU.

The reference's dispatch tests, ported to the port's plans
(``tests/test_fused_dot.py::test_autotune_cache_bucketing``,
``tests/test_attn_kernel.py::test_autotune_*``,
``tests/test_prefill_chunk.py::test_prefill_bucket_persistence_roundtrip``,
``tests/test_obs.py::test_dispatch_profile_*``), and:

* selection under an injected timer (``dispatch._time_plan``; nothing is
  launched): the fastest candidate wins, the rule's plan wins a tie and
  a near-tie (within ``dispatch._MARGIN``), nothing is persisted with
  ``measure=False``, and each stored plan fits every shape of its
  bucket;
* the rule a K3/K4 key starts from is ``ring_splits``/``prefill_plan``
  at the call's shape, and attention keys part by ring size and window;
* every candidate runs once before any is timed: a launch that writes
  into its input (its fingerprint moves) or past its scratch output
  raises first;
* the reference's file (``REPRO_AUTOTUNE_CACHE``,
  ``.cache/autotune.json``) is never written;
* a save racing another keeps both's entries;
* ``profile_table()`` after the same plain-path selections equals the
  reference's text byte for byte.

The first rank of a bound world selects and the others take its plan:
``tests/test_torch_dist.py`` holds that in its worlds.
"""
import json
import os
import sys
import threading

import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro_torch.kernels import dispatch
from repro_torch.kernels.attn import ops as A
from repro_torch.kernels.qmatmul import ops as Q
from repro_torch.obs import Tracer, validate_trace


@pytest.fixture
def clean(monkeypatch, tmp_path):
    """A fresh cache and profile, the cache file under ``tmp_path``; the
    process's state comes back afterwards."""
    saved = (dict(dispatch._BLOCK_CACHE), set(dispatch._MEASURED),
             dict(dispatch._RECORDS), dict(dispatch._AUTOTUNE))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune_torch.json"))
    dispatch.reset_autotune()
    dispatch.reset_profile()
    yield tmp_path
    dispatch.reset_autotune()
    dispatch.reset_profile()
    dispatch.profile_enable(False)
    dispatch._BLOCK_CACHE.update(saved[0])
    dispatch._MEASURED.update(saved[1])
    dispatch._RECORDS.update(saved[2])
    dispatch._AUTOTUNE.update(saved[3])


def _timer(monkeypatch, times):
    """Replace the card timer: ``times(plan)`` µs for each fitted plan
    (K2's launches do nothing); returns the plans timed, in order."""
    seen = []

    def fake(run, plan):
        seen.append(plan)
        return times(plan)
    monkeypatch.setattr(dispatch, "_time_plan", fake)
    monkeypatch.setattr(Q, "launch", lambda *a, **kw: None)
    return seen


def _noop_launch():
    """``launch()`` of a selection whose candidates launch nothing."""
    return (torch.zeros(4),), lambda scratch, x: (lambda plan: None)


def _mm_operands(R, C, D):
    return (torch.zeros(R, D), torch.zeros(D, C), 0.0, 0.0)


# ---------------------------------------------------------------------------
# the reference's tests, on the port's plans
# ---------------------------------------------------------------------------

def test_autotune_cache_bucketing(clean):
    dispatch.set_autotune(measure=False)
    b1 = dispatch.blocks_for("nn", 120, 250, 70, interpret=False)
    key = ("nn", 128, 256, 128, Q.products(10, 10))
    assert dispatch.autotune_cache() == {key: Q.plan(128, 256, 128)[:2]}
    assert b1 == Q.fit_plan(70, *Q.plan(128, 256, 128)[:2])
    # same bucket → cache hit; an injected entry wins, fitted to the call
    dispatch.autotune_cache()[key] = (64, 2)
    assert dispatch.blocks_for("nn", 100, 140, 100, interpret=False) \
        == (64, 2, 2)
    # a raw operand costs more products: another bucket
    dispatch.blocks_for("nn", 120, 250, 70, interpret=False,
                        widths=(None, 10))
    # different layout → new entry
    dispatch.blocks_for("tn", 120, 250, 70, interpret=False)
    assert len(dispatch.autotune_cache()) == 3
    assert not dispatch._MEASURED


ENTRIES = {
    "mm": (("nn", 256, 256, 512, 2), (32, 4),
           lambda: dispatch.blocks_for("nn", 200, 200, 500, interpret=False,
                                       widths=(None, 10)),
           Q.fit_plan(500, 32, 4)),
    "attn": (("attn", 32, 4096, 4, 64, 8, 0), (3,),
             lambda: dispatch.attn_blocks_for(4000, 4, 64, width=8,
                                              interpret=False, B=4, K=8),
             3),
    "attn_f32": (("attn", 4, 16, 2, 32, 0, 0), (2,),
                 lambda: dispatch.attn_blocks_for(14, 2, 32, interpret=False,
                                                  B=2, K=2),
                 1),
    "prefill": (("prefill", 8, 4096, 64, 4, 64, 8, 0), (8, 5),
                lambda: dispatch.prefill_blocks_for(4000, 64, 4, 64, width=8,
                                                    interpret=False, B=1,
                                                    K=8),
                (8, 5)),
}


@pytest.mark.parametrize("kind", sorted(ENTRIES))
def test_autotune_persistence_roundtrip(clean, monkeypatch, kind):
    """Measured entries survive save → reset → load; the rule's don't; a
    loaded entry is used without measuring."""
    key, plan, select, want = ENTRIES[kind]
    path = str(clean / "autotune.json")
    dispatch._BLOCK_CACHE[key] = plan
    dispatch._MEASURED.add(key)
    dispatch._RECORDS[key] = {"device": "cpu", "rule": [1], "us": 1.0}
    dispatch._BLOCK_CACHE[("nt", 64, 64, 64, 1)] = (64, 1)    # a rule's
    assert dispatch.save_autotune(path) == path
    dispatch.reset_autotune()
    assert dispatch.load_autotune(path) == 1
    assert dispatch.autotune_cache() == {key: plan}
    seen = _timer(monkeypatch, lambda p: 1.0)
    assert select() == want and not seen


@pytest.mark.parametrize("text", [None, "{not json", "[1, 2, 3]",
                                  '{"nn|64|64|64|1": [64, 1, 2]}'],
                         ids=["missing", "corrupt", "list", "reference"])
def test_autotune_load_missing_or_corrupt(clean, text):
    path = clean / "bad.json"
    if text is not None:
        path.write_text(text)
    assert dispatch.load_autotune(str(path)) == 0
    assert not dispatch.autotune_cache()


def test_autotune_save_merges(clean):
    """Successive processes contribute different buckets without
    clobbering."""
    path = str(clean / "autotune.json")
    for key, plan in ((("nn", 256, 256, 512, 1), (64, 1)),
                      (("attn", 32, 4096, 4, 64, 8, 0), (4,))):
        dispatch.reset_autotune()          # "process A", then "process B"
        dispatch._BLOCK_CACHE[key] = plan
        dispatch._MEASURED.add(key)
        dispatch._RECORDS[key] = {"device": "cpu"}
        dispatch.save_autotune(path)
    dispatch.reset_autotune()
    assert dispatch.load_autotune(path) == 2


@pytest.mark.parametrize("key,plan,device", [
    ("nn|256|256|512|1", [0, 1], "cpu"),           # zero tile
    ("nn|256|256|512|1", [48, 1], "cpu"),          # no such tile
    ("nn|256|256|512|1", [64, 17], "cpu"),         # more splits than slices
    ("nn|256|256|512|4", [64, 1], "cpu"),          # four products
    ("nn|200|256|512|1", [64, 1], "cpu"),          # not a bucket
    ("attn|32|4096|4|64|8|0", [1 << 20], "cpu"),   # past the grid
    ("attn|32|4096|4|64|32|0", [4], "cpu"),        # no such container
    ("attn|32|4000|4|64|8|0", [4], "cpu"),         # a ring not bucketed
    ("attn|32|4096|4|64|8|2", [4], "cpu"),         # windowed is 0 or 1
    ("attn|32|4096|4|64|8", [4], "cpu"),           # an attention key
    #                                                without its window
    ("prefill|8|4096|64|4|64|8|0", [2, 4], "cpu"),  # warps hd 64 has not
    ("prefill|8|4096|64|4|64|8|0", [8, 1 << 20], "cpu"),  # past the grid
    ("nt|64|64", [64, 1], "cpu"),                  # wrong arity
    ("bogus|1", [1], "cpu"),                       # unknown kind
    ("nn|256|256|512|1", [64, 1], "NVIDIA H100 80GB HBM3"),  # another card
], ids=["zero", "tile", "splits", "products", "bucket", "attn", "width",
        "ring", "window", "unwindowed", "warps", "grid", "arity", "kind",
        "device"])
def test_autotune_load_validates(clean, key, plan, device):
    """Entries the kernel cannot take, or measured on another card, are
    skipped (a trusted-forever bad entry would break every call in its
    bucket); the valid entry beside them loads."""
    path = clean / "autotune.json"
    path.write_text(json.dumps({
        key: {"plan": plan, "device": device},
        "tn|64|64|64|2": {"plan": [32, 2], "device": "cpu"}}))
    assert dispatch.load_autotune(str(path)) == 1
    assert dispatch.autotune_cache() == {("tn", 64, 64, 64, 2): (32, 2)}


def test_dispatch_profile_disabled_records_nothing(clean):
    dispatch.profile_enable(False)
    dispatch.blocks_for("fwd", 8, 8, 8, interpret=True)
    assert dispatch.profile_stats() == {}


def test_dispatch_profile_records_and_renders(clean):
    dispatch.profile_enable(True)
    for _ in range(3):
        blocks = dispatch.blocks_for("fwd", 8, 16, 32, interpret=True)
    assert blocks == (8, 16, 32)
    assert dispatch.attn_blocks_for(64, 4, 8, interpret=True) == 64
    stats = dispatch.profile_stats()
    mm = stats[("mm", "fwd", "interp")]
    assert mm["calls"] == 3 and mm["hits"] == 3 and mm["misses"] == 0
    assert mm["blocks"] == (8, 16, 32)
    assert ("attn", "interp") in stats
    table = dispatch.profile_table()
    assert "mm|fwd|interp" in table and "calls" in table
    tr = Tracer()
    dispatch.profile_trace_counters(tr)
    assert tr.find("dispatch/mm|fwd|interp", "C")
    validate_trace(tr.to_chrome())


# ---------------------------------------------------------------------------
# selection under an injected timer
# ---------------------------------------------------------------------------

def _select(kind):
    """One selection of each kernel on the card path, launches injected."""
    if kind == "mm":
        return dispatch.blocks_for("nt", 64, 240, 1200, interpret=False,
                                   widths=(None, 10),
                                   operands=_mm_operands(64, 240, 1200))
    if kind == "attn":
        return dispatch.attn_blocks_for(400, 4, 128, width=8,
                                        interpret=False, B=4, K=8,
                                        launch=_noop_launch)
    return dispatch.prefill_blocks_for(400, 128, 4, 128, width=8,
                                       interpret=False, B=1, K=8,
                                       launch=_noop_launch)


RULES = {"mm": Q.plan(64, 256, 2048)[:2], "attn": (5,), "prefill": (8, 4)}
FITS = {"mm": lambda p: Q.fit_plan(1200, *p),
        "attn": lambda p: A.ring_plan(400, p[0]),
        "prefill": lambda p: A.prefill_fit(1, 128, 400, p)}


@pytest.mark.parametrize("kind", sorted(RULES))
def test_fastest_plan_wins_and_persists(clean, monkeypatch, kind):
    fit = FITS[kind]
    rule = fit(RULES[kind])
    seen = _timer(monkeypatch, lambda p: 1.0 + (p == rule))
    got = _select(kind)
    plans = list(dict.fromkeys(seen))
    assert seen[0] == rule and len(plans) > 2
    assert seen == plans * dispatch._AUTOTUNE["reps"]   # rounds of all
    want = plans[1]                  # the first of the fastest
    assert (fit((got,)) if kind == "attn" else got) == want
    (key,) = dispatch.autotune_cache()
    rec = dispatch.autotune_records()[key]
    assert rec["rule"] == list(RULES[kind]) and rec["device"] == "cpu"
    assert (rec["us"], rec["rule_us"]) == (1.0, 2.0)
    dispatch.reset_autotune()
    assert dispatch.load_autotune() == 1
    del seen[:]
    assert _select(kind) == got and not seen        # loaded: no timing


@pytest.mark.parametrize("gain", [0.0, 0.03], ids=["tie", "near_tie"])
@pytest.mark.parametrize("kind", sorted(RULES))
def test_rule_wins_a_tie(clean, monkeypatch, kind, gain):
    """A candidate faster than the rule's plan by less than the margin
    (the times' spread from run to run) does not replace it."""
    rule = FITS[kind](RULES[kind])
    seen = _timer(monkeypatch, lambda p: 1.0 - gain * (p != rule))
    got = _select(kind)
    assert seen[0] == rule and len(set(seen)) > 2
    assert (FITS[kind]((got,)) if kind == "attn" else got) == rule
    assert dispatch._MEASURED          # measured, and the rule's kept


@pytest.mark.parametrize("B,K,W", [(4, 8, 400), (3, 8, 400), (1, 2, 1000),
                                   (6, 1, 333)])
def test_rule_is_the_attention_kernels_rule(clean, B, K, W):
    """The plan a K3/K4 key starts from, fitted to the call, is
    ``ring_splits`` / ``prefill_plan`` at the call's own shape: one rule
    a kernel, whatever ``B·K`` (a bucketed ``B·K`` would give 5 splits
    where the rule gives 6 at B=3, K=8)."""
    dispatch.set_autotune(measure=False)
    assert dispatch.attn_blocks_for(W, 4, 128, width=8, interpret=False,
                                    B=B, K=K) == A.ring_splits(B, K, W)[0]
    assert dispatch.prefill_blocks_for(W, 64, 4, 128, width=8,
                                       interpret=False, B=B, K=K) == \
        A.prefill_plan(B, 64, W, K, 4, 128)


def test_attention_keys_part_by_ring_and_window(clean):
    """A chunk over a ring of another size bucket, or under a window that
    hides part of its ring, keys apart (its tiles differ); a window as
    wide as the ring does not."""
    dispatch.set_autotune(measure=False)
    for select in (dispatch.attn_blocks_for,
                   lambda W, *a, **kw: dispatch.prefill_blocks_for(
                       W, 128, *a, **kw)):
        dispatch.reset_autotune()
        for W, window in ((400, None), (300, 400), (400, 128), (4000, None)):
            select(W, 4, 128, width=8, interpret=False, B=1, K=8,
                   window=window)
        assert [k[-1] for k in dispatch.autotune_cache()] == [0, 1, 0]
        assert [k[2] for k in dispatch.autotune_cache()] == [512, 512, 4096]


@pytest.mark.parametrize("kind", sorted(RULES))
def test_measure_off_caches_the_rule_and_saves_nothing(clean, monkeypatch,
                                                       kind):
    dispatch.set_autotune(measure=False)
    seen = _timer(monkeypatch, lambda p: 1.0)
    _select(kind)
    assert not seen and not dispatch._MEASURED
    assert list(dispatch.autotune_cache().values()) == [RULES[kind]]
    assert not (clean / "autotune_torch.json").exists()


def _mm_ok(D, plan):
    bn, s, per = plan
    n = max(1, -(-D // Q.BK))
    return bn in (32, 64) and 1 <= s <= 65535 and (s - 1) * per < n <= s * per


def _ring_ok(W, plan):
    s, tps = plan
    n = -(-W // A.TILE)
    return 1 <= s and (s - 1) * tps < n <= s * tps


def _prefill_ok(B, C, W, plan):
    n_list = -(-W // A.TILE) + -(-C // A.TILE)
    return 1 <= plan[1] <= n_list and B * plan[1] <= 65535


@pytest.mark.parametrize("kind", ["mm", "attn", "prefill"])
def test_stored_plans_fit_every_shape_of_their_bucket(kind):
    """Every stored form a measurement can keep (and the rule's) gives a
    plan the kernel accepts at each shape that falls in its bucket."""
    stored = [(s,) for s in dispatch._SPLITS] + [(1 << 16,)]
    for hi in (8, 64, 512, 4096):
        for n in range(hi // 2 + 1, hi + 1):
            if kind == "mm":
                for bn in (32, 64):
                    for (s,) in stored:
                        assert _mm_ok(n, Q.fit_plan(n, bn, s))
                assert _mm_ok(n, Q.fit_plan(n, *Q.plan(64, 64, hi)[:2]))
            elif kind == "attn":
                for p in stored + [A.ring_rule(1), A.ring_rule(8)]:
                    assert _ring_ok(n, A.ring_plan(n, p[0]))
            else:
                for B in (1, 3, 65535):
                    for p in stored + [A.prefill_rule(1, 128, 4, 128)[1:],
                                       A.prefill_rule(8, 128, 4, 128)[1:]]:
                        assert _prefill_ok(B, 96, n, A.prefill_fit(
                            B, 96, n, (8, p[0])))


def test_reference_file_is_never_written(clean, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(clean / "ref.json"))
    monkeypatch.chdir(clean)
    _timer(monkeypatch, lambda p: 1.0)
    for kind in RULES:
        _select(kind)
    assert dispatch.autotune_records()
    assert json.loads((clean / ".cache" / "autotune_torch.json").read_text())
    assert not (clean / "ref.json").exists()
    assert not (clean / ".cache" / "autotune.json").exists()


def test_racing_saves_keep_both(clean):
    """Writers merging at once (threads here, more than the cores;
    processes take the same lock) lose nothing, and no temporary file is
    left behind."""
    path = str(clean / "autotune.json")
    n = 2 * (os.cpu_count() or 1) + 2

    def writer(tag):
        for i in range(10):
            dispatch._write_merged(
                {f"nn|{8 << (i % 4)}|8|8|{tag}": {"plan": [64, 1],
                                                   "device": "cpu", "i": i},
                 f"{tag}:{i}": {}}, path)
    ts = [threading.Thread(target=writer, args=(t,)) for t in range(n)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in ts)
    data = json.loads(open(path).read())
    assert {f"{t}:{i}" for t in range(n) for i in range(10)} <= set(data)
    assert sorted(p.name for p in clean.iterdir()) == [
        "autotune.json", "autotune.json.lock"]


def test_profile_table_matches_reference(clean):
    """The same plain-path selections (interpret mode in the reference)
    give the same table, byte for byte."""
    def calls(d):
        d.reset_profile()
        d.profile_enable(True)
        try:
            for kind in ("nn", "nt", "tn", "nn"):
                d.blocks_for(kind, 96, 80, 64, interpret=True)
            for _ in range(2):
                d.attn_blocks_for(400, 4, 128, width=8, interpret=True)
            d.prefill_blocks_for(400, 128, 4, 128, width=None,
                                 interpret=True)
            d.paged_attn_blocks_for(64, 4, 128, width=8, interpret=True)
            d.paged_prefill_blocks_for(64, 64, 4, 128, width=16,
                                       interpret=True)
            return d.profile_table()
        finally:
            d.profile_enable(False)
            d.reset_profile()
    got, want = calls(dispatch), calls(jdispatch)
    assert got == want and len(got.splitlines()) == 8


def test_paged_hooks_name_the_page(clean):
    """On the card path a page the paged kernels cannot take raises,
    naming it; the plain versions take any page."""
    assert dispatch.paged_attn_blocks_for(4, 4, 64, interpret=True) == 4
    with pytest.raises(ValueError, match="page_size 48"):
        dispatch.paged_attn_blocks_for(48, 4, 64, interpret=False)
    with pytest.raises(ValueError, match="page_size 16"):
        dispatch.paged_prefill_blocks_for(16, 64, 4, 64, interpret=False)
    assert dispatch.paged_prefill_blocks_for(64, 64, 4, 64,
                                             interpret=False) == 64


@pytest.mark.parametrize("where", ["input", "guard", "none"])
def test_measurement_checks_what_a_launch_writes(clean, monkeypatch, where):
    """Every candidate runs once first: one that writes into its input
    (the input's fingerprint moves; a NaN's bits do not) or past its
    scratch output raises before any launch is timed."""
    seen = _timer(monkeypatch, lambda p: 1.0)
    live = torch.arange(8.0)
    live[3] = float("nan")             # NaN stays NaN: not a write

    def make_run(scratch, x):
        out = scratch(4)

        def run(plan):
            if where == "input":
                x[plan[0] % 8] = -1.0
            elif where == "guard":
                out.view(-1).as_strided((5,), (1,))[4] = 0.0
            out.zero_()
        return run
    def launch():
        return (live,), make_run
    if where == "none":
        assert dispatch.attn_blocks_for(400, 4, 128, interpret=False, B=4,
                                        K=8, launch=launch) == 5
        assert seen
        return
    with pytest.raises(RuntimeError, match="wrote"):
        dispatch.attn_blocks_for(400, 4, 128, interpret=False, B=4, K=8,
                                 launch=launch)
    assert not seen


@pytest.mark.parametrize("make", [
    lambda: torch.arange(12.0).reshape(3, 4),
    lambda: torch.arange(7, dtype=torch.int8),
    lambda: torch.arange(16, dtype=torch.int32).reshape(4, 4)[:, :1][1],
    lambda: torch.tensor(3.0)],
    ids=["f32", "int8_odd", "one_of_a_column", "scalar"])
def test_digest_moves_with_any_write(make):
    """The fingerprint of an input the kernels take (contiguous, or one
    element whatever its stride) reads its bytes without a copy of a
    large one, and moves when any element is written."""
    t = make()
    before = dispatch._digest(t)
    assert torch.equal(before, dispatch._digest(t.clone()))
    t.view(-1)[-1] += 1
    assert not torch.equal(before, dispatch._digest(t))
