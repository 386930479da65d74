"""The serve engine's admission control, deadlines and runaway sentinel,
``prng.randint`` and the serve CLI's robustness flags, against the
reference.

The engines are those of ``tests/test_torch_serve_faults.py``
(llama3-smoke, float32 arithmetic, P = 8, max_len 32, the reference
chaos suite's prompts), each scenario run through both packages and
compared exactly — statuses, tokens, counters, fault logs:

* ``queue_cap``: the same ``REJECTED`` set with empty results and
  ``requests_rejected``; a ``KVBitFlip`` on that run's f32 pool skips
  with the reference's reason;
* deadlines: a queued ``deadline_ms=0`` resolves ``TIMED_OUT`` before
  any step; a deadline forced into the past mid-decode returns the
  partial tokens; under a step-driven fake clock (both packages'
  ``serve.metrics._now``) queued and in-flight expiries land on the same
  steps;
* ``runaway_ovf=-1.0`` quarantines every decoding request ``FAILED``;
* the loose keyword arguments warn and unknown ones raise, and
  ``reset_metrics`` opens a fresh window;
* an MoE engine admits one prompt a prefill, so two equal-length
  prompts decode as each alone;
* ``prng.randint`` draws ``jax.random.randint``'s int32s bit for bit;
* ``repro_torch.launch.serve.main`` and ``repro.launch.serve.main`` on
  the same argv (``--queue-cap``, ``--chaos``, ``--fault-log``,
  ``--metrics-out``, ``--numerics-log``, and ``--fused-decode
  --profile``, under which both select the paged kernels' pages) print
  the same statuses, the same dispatch profile's buckets and blocks (not
  its ``calls``: the reference counts jit traces, the port eager calls)
  and write the same fault log, numerics records and metric series.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.launch import serve as jcli
from repro.serve import metrics as jmetrics
from repro_torch import configs as tconfigs
from repro_torch import serve as tserve
from repro_torch.core import prng
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.launch import serve as tcli
from repro_torch.models import transformer as TT
from repro_torch.serve import metrics as tmetrics
from test_torch_serve_faults import engine, outcome, prompts


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pkg(pkg):
    return (jserve, jmetrics) if pkg == "ref" else (tserve, tmetrics)


# ---------------------------------------------------------------------------
# admission control and the runaway sentinel
# ---------------------------------------------------------------------------

def queue_cap(pkg):
    """One slot, a queue of 2, three submits: the third bounces.  The
    pool is f32, so the bit flip at step 3 has no mantissa to flip."""
    S, _ = _pkg(pkg)
    fh = S.FaultHarness([S.KVBitFlip(step=3, uid=0)])
    eng = engine(pkg, bits=0, slots=1, queue_cap=2, faults=fh)
    uids = [eng.submit(p, max_new=4) for p in prompts()]
    rejected = eng.status(uids[2]).value
    eng.run()
    return rejected, outcome(eng, uids, fh)


def runaway(pkg):
    eng = engine(pkg, runaway_ovf=-1.0)
    pa, _, pc = prompts()
    uids = [eng.submit(p, max_new=6) for p in (pa, pc)]
    eng.run()
    return outcome(eng, uids)


def forced_deadline(pkg):
    """A deadline set into the past after 4 steps: the in-flight request
    resolves TIMED_OUT with the tokens it has."""
    _, M = _pkg(pkg)
    eng = engine(pkg, slots=1)
    uid = eng.submit(prompts()[2], max_new=8)
    for _ in range(4):
        eng.step()
    eng._reqs[0].deadline = M._now() - 1.0
    eng.run()
    return outcome(eng, [uid])


def fake_clock(pkg, monkeypatch):
    """A clock of 1 ms an engine step: uid 1 (deadline 3 ms) expires in
    the queue at step 4, uid 0 (5 ms) mid-decode at step 6, uid 2 (no
    deadline) finishes."""
    _, M = _pkg(pkg)
    eng = engine(pkg, slots=1)
    monkeypatch.setattr(M, "_now", lambda: eng._step_idx * 1e-3)
    pa, pb, pc = prompts()
    uids = [eng.submit(pa, max_new=6, deadline_ms=5.0),
            eng.submit(pb, max_new=6, deadline_ms=3.0),
            eng.submit(pc, max_new=6)]
    eng.run()
    return outcome(eng, uids)


SCENARIOS = {"runaway": runaway, "forced_deadline": forced_deadline}


@functools.lru_cache(maxsize=None)
def _reference(name):
    return SCENARIOS[name]("ref") if name in SCENARIOS else queue_cap("ref")


def test_queue_cap_rejects_and_f32_flip_skips():
    got, want = queue_cap("port"), _reference("queue_cap")
    assert got == want
    rejected, out = got
    assert rejected == "rejected"
    assert out["status"] == ["ok", "ok", "rejected"]
    assert out["tokens"][2] == []
    assert out["counters"]["requests_rejected"] == 1
    assert out["counters"]["queue_depth_peak"] == 2
    assert out["log"]["events"] == [{
        "kind": "bit_flip_skipped", "uid": 0, "step": 3,
        "reason": "f32 pool has no mantissa to flip"}]


def test_runaway_quarantines_every_decoding_request():
    got = runaway("port")
    assert got == _reference("runaway")
    assert got["status"] == ["failed", "failed"]
    assert [len(t) for t in got["tokens"]] == [1, 1]
    assert got["counters"]["requests_failed"] == 2


def test_queued_deadline_zero_times_out():
    outs = []
    for pkg in ("ref", "port"):
        eng = engine(pkg, deadline_ms=0.0)
        uids = [eng.submit(p, max_new=4) for p in prompts()[:2]]
        eng.run()
        outs.append(outcome(eng, uids))
    assert outs[1] == outs[0]
    assert outs[1]["status"] == ["timed_out", "timed_out"]
    assert outs[1]["tokens"] == [[], []]
    assert outs[1]["counters"]["decode_steps"] == 0


def test_forced_inflight_deadline_returns_partial_tokens():
    got = forced_deadline("port")
    assert got == _reference("forced_deadline")
    assert got["status"] == ["timed_out"]
    assert 1 <= len(got["tokens"][0]) < 8


def test_fake_clock_deadlines_match_reference(monkeypatch):
    want = fake_clock("ref", monkeypatch)
    got = fake_clock("port", monkeypatch)
    assert got == want
    assert got["status"] == ["timed_out", "timed_out", "ok"]
    assert got["tokens"][1] == [] and 1 <= len(got["tokens"][0]) < 6
    assert got["counters"]["requests_timed_out"] == 2


def test_loose_keywords_warn_and_reset_metrics():
    cfg = tconfigs.get_smoke("llama3_8b")
    params = TT.init_params(cfg, 0, device="cpu")
    pol = TPolicy("float32", prefill_chunk=8)
    with pytest.warns(DeprecationWarning):
        eng = tserve.ServeEngine(cfg, pol, params, max_slots=1, max_len=32,
                                 device="cpu", queue_cap=1)
    assert eng.queue_cap == 1
    # an active serving context without its mesh fails typed, at
    # construction, as the reference's engine does
    from repro_torch.dist import DistCtx, MeshConfigError
    with pytest.raises(MeshConfigError, match="needs the mesh"):
        tserve.ServeEngine(cfg, pol, params, max_slots=1, max_len=32,
                           device="cpu", dist=DistCtx(
                               ep_axis="model", all_axes=("model",)))
    eng.submit(prompts()[2], max_new=2)
    eng.submit(prompts()[2], max_new=2)
    eng.run()
    assert eng.stats()["requests_rejected"] == 1
    eng.reset_metrics()
    assert eng.stats()["requests_submitted"] == 0
    assert eng.stats()["requests_rejected"] == 0


def test_moe_admits_one_prompt_a_prefill():
    """MoE capacity counts the whole prefill batch, so equal-length
    prompts are admitted one at a time: each decodes as it does alone."""
    cfg = tconfigs.get_smoke("granite_moe_1b")
    params = TT.init_params(cfg, 0, device="cpu")
    pol = TPolicy("float32")
    # one token repeated: every position routes to the same experts,
    # past their capacity, so which positions drop depends on the batch
    ps = [np.full(9, t, np.int32) for t in (5, 7)]

    def serve(batch):
        eng = tserve.ServeEngine(cfg, pol, params, max_slots=2, max_len=16,
                                 device="cpu")
        uids = [eng.submit(p, max_new=3) for p in batch]
        out = eng.run()
        return [out[u].tolist() for u in uids]

    assert serve(ps) == serve(ps[:1]) + serve(ps[1:])


# ---------------------------------------------------------------------------
# prng.randint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [
    (0, 1), (0, 256), (0, 32768), (0, 128256), (0, 1 << 20),
    (0, 2 ** 31 - 1), (-5, 7), (-2 ** 31, 2 ** 31 - 1), (9, 3)])
def test_randint_matches_jax(lo, hi):
    for seed in (0, 1003):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                             (4, 257), lo, hi))
        got = prng.randint(prng.PRNGKey(seed), (4, 257), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_cli_prompts_are_the_references():
    for i, n in ((0, 32), (5, 17)):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(1000 + i),
                                             (n,), 0, 128256))
        np.testing.assert_array_equal(tcli.prompt(i, n, 128256), want)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

CLI_ARGV = ["--smoke", "--arithmetic", "float32", "--cache-bits", "8",
            "--page-size", "8", "--queue-cap", "2", "--chaos", "0",
            "--numerics-every", "2", "--fused-decode", "--profile"]


def _cli(main, out_dir, capsys, extra=()):
    files = {k: str(out_dir / f"{k}.json") for k in ("faults", "metrics",
                                                     "numerics")}
    main(CLI_ARGV + ["--fault-log", files["faults"], "--metrics-out",
                     files["metrics"], "--numerics-log", files["numerics"],
                     *extra])
    text = capsys.readouterr().out
    table = text[text.index("  uid"):].splitlines()
    table = [line.split() for line in table[1:] if line.split()
             and line.split()[0].isdigit()]
    with open(files["faults"]) as f:
        faults = json.load(f)
    with open(files["metrics"]) as f:
        (snap,) = [json.loads(line) for line in f]
    with open(files["numerics"]) as f:
        numerics = [{k: v for k, v in json.loads(line).items() if k != "t"}
                    for line in f]
    sample = [line for line in text.splitlines() if line.startswith("sample")]
    prof = text[text.index("dispatch profile:"):].splitlines()[1:]
    prof = [(row.split()[0], row.split()[-1]) for row in
            prof[:next(i for i, r in enumerate(prof) if "  " not in r)]]
    return {"table": table, "faults": faults, "numerics": numerics,
            "sample": sample, "profile": prof,
            "series": list(snap["metrics"]),
            "values": {k: v for k, v in snap["metrics"].items()
                       if v["type"] in ("counter", "gauge")}}


def test_cli_matches_reference(tmp_path, capsys):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _cli(jcli.main, tmp_path / "ref", capsys)
    got = _cli(tcli.main, tmp_path / "port", capsys, ["--device", "cpu"])
    assert got == want
    statuses = [row[1] for row in got["table"]]
    assert statuses == ["ok", "ok", "rejected", "rejected"]
    assert got["profile"] == [("bucket", "blocks"),
                              ("paged_attn|8|2|32|8", "8"),
                              ("paged_prefill|8|8|2|32|8", "8")]
    assert got["values"]["serve_requests_rejected"]["value"] == 2
    assert got["numerics"]
