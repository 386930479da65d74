"""The §5 numeric-health timeline and the metrics outputs of the port
(``repro_torch.obs``) against the reference's (``repro.obs``), on the
CPU.

* ``train_records``: the port's train step with ``numerics_tap`` taps
  the reference's exponents before and after the controller exactly and
  its pre-reset §5 windows within the families' DFXP band; both
  packages' ``train_records`` turn one tap into the same JSON lines,
  byte for byte.
* ``numerics_snapshot`` of a slot-major and of a paged int8 pool after
  appends that move the controller: exactly the reference's (the paged
  pool's newest page per slot, counters through the block tables); both
  packages' ``serve_records`` of two samples give the same JSON lines,
  byte for byte, with controller moves in them.
* ``MetricsRegistry``: the same operations give the same ``snapshot``,
  ``snapshot_jsonl`` line (but its wall-clock ``t``), Prometheus text
  and quantiles; ``start_http_server`` serves that text on localhost.
* ``TrainSupervisor(numerics_log=…)``: records every ``numerics_every``
  committed steps, whose exponents are the state's at that step, and a
  HALTED bundle's ``numerics_tail.jsonl``.
* The trainer CLI's ``--numerics-log`` at smoke size (llama3-smoke,
  DFXP, 4 steps, controller interval 2), against the reference launcher
  at the same argv: records at the same steps; at the first controller
  application the same records but their clock and rates (exponents,
  moves, groups; the two free-running DFXP runs part at their first
  flipped tie after it, ROADMAP §3); the port's last records hold its
  final state's exponents.
"""
import contextlib
import io
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.data import synthetic as jdata
from repro.models import maxout as JMX
from repro.optim import opt as jopt
from repro.serve import kv_pool as jkv
from repro.serve import paged as jpaged
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch import obs as tobs
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.core.tape import tensor_class
from repro_torch.models import maxout as TMX
from repro_torch.models.convert import maxout_params_from_jax
from repro_torch.optim import opt as topt
from repro_torch.serve import kv_pool as tkv
from repro_torch.serve import paged as tpaged
from repro_torch.train import TrainSupervisor
from repro_torch.train import init_train_state as t_init_state
from repro_torch.train import make_train_step as t_make_step

PI = dict(input_dim=64, hidden=(24, 16), num_classes=10, pieces=3,
          name="pi-numerics")
OPT = dict(kind="sgd", lr=0.05, lr_decay_steps=1000)
DFXP = dict(arithmetic="dfxp", comp_width=10, update_width=12,
            update_interval=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(records):
    return [json.dumps(r) for r in records]


def _batch(i):
    b = jdata.SyntheticImages(input_dim=PI["input_dim"]).batch(i, 16)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _maxout():
    jcfg = JMX.MaxoutConfig(**PI)
    tcfg = TMX.MaxoutConfig(**PI)
    jp = JMX.init_params(jcfg, jax.random.PRNGKey(3))
    tp = maxout_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    return jcfg, tcfg, jp, tp, JMX.group_shapes(jcfg)


def test_train_records_match_reference():
    jcfg, tcfg, jp, tp, gs = _maxout()
    jpol, tpol = JPolicy(**DFXP), TPolicy(**DFXP)
    jstate = j_init_state(jp, jopt.sgd_init(jp), gs, jpol, init_exp=-6.0)
    tstate = t_init_state(tp, topt.sgd_init(tp), gs, tpol, init_exp=-6.0)
    jstep = jax.jit(j_make_step(
        lambda p, b, s, e: JMX.loss_fn(jcfg, jpol, p, b, e, s), gs, jpol,
        jopt.OptConfig(**OPT), numerics_tap=True))
    tstep = t_make_step(
        lambda p, b, s, e: TMX.loss_fn(tcfg, tpol, p, b, e, s), gs, tpol,
        topt.OptConfig(**OPT), numerics_tap=True)
    moves = 0
    for i in range(2):       # the controller records, then applies
        jb, tb = _batch(i)
        jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(i))
        tstate, tm = tstep(tstate, tb)
        jt = jax.device_get(jm["numerics"])
        tt = tm["numerics"]
        for part in ("prev_exps", "exps"):
            assert set(tt[part]) == set(jt[part])
            for g, v in jt[part].items():
                np.testing.assert_array_equal(tt[part][g].numpy(), v, g)
        assert set(tt["acc"]) == set(jt["acc"])
        for g, v in jt["acc"].items():
            got = tt["acc"][g].numpy()
            np.testing.assert_array_equal(got[..., 2], v[..., 2], g)
            np.testing.assert_allclose(got, v, rtol=0,
                                       atol=1e-3 * float(v[..., 2].max()))
        want = jobs.train_records(jt["prev_exps"], jt["exps"], jt["acc"],
                                  step=i + 1, t=12.5)
        got = tobs.train_records(jt["prev_exps"], jt["exps"], jt["acc"],
                                 step=i + 1, t=12.5)
        assert _lines(got) == _lines(want)
        assert {r["class"] for r in got} == {tensor_class(g)
                                             for g in jt["exps"]}
        moves += tobs.count_moves(got)
    assert moves > 0


def _paged_pool(rng):
    P, NBLK, B, K, HD = 4, 5, 3, 2, 8
    cfg = dict(width=8, update_interval=2)
    jc = jpaged.PagedKVCodec(P, jkv.CacheQuantConfig(**cfg))
    tc = tpaged.PagedKVCodec(P, tkv.CacheQuantConfig(**cfg))
    raw = {"k": np.zeros((1, B, NBLK * P, K, HD), np.float32),
           "v": np.zeros((1, B, NBLK * P, K, HD), np.float32),
           "pos": np.full((1, B, NBLK * P), -1, np.int32)}
    n_pages = 1 + B * NBLK
    je = jax.tree_util.tree_map(
        lambda a: a[0], jc.init_like({k: jnp.asarray(v)
                                      for k, v in raw.items()}, n_pages))
    te = {k: v[0] for k, v in tc.init_like(
        {k: torch.from_numpy(v) for k, v in raw.items()}, n_pages).items()}
    bt = np.array([[7, 2, 11, 4, 13], [3, 9, 14, 5, 0], [12, 6, 1, 0, 0]],
                  np.int32)
    je["bt"], te["bt"] = jnp.asarray(bt), torch.from_numpy(bt)
    kn = (4 * rng.standard_normal((B, 8, K, HD))).astype(np.float32)
    args = (np.zeros(B, np.int32), np.array([8, 5, 3], np.int32))
    je = jc.append_chunk(je, jnp.asarray(kn), jnp.asarray(kn),
                         *map(jnp.asarray, args))
    te = tc.append_chunk(te, torch.from_numpy(kn), torch.from_numpy(kn),
                         *map(torch.from_numpy, args))
    return jc, tc, je, te, np.array([8, 5, 3], np.int32)


def _slot_pool(rng):
    B, W, K, HD = 3, 10, 2, 8
    cfg = dict(width=8, update_interval=2)
    jc = jkv.PackedKVCodec(jkv.CacheQuantConfig(**cfg))
    tc = tkv.PackedKVCodec(tkv.CacheQuantConfig(**cfg))
    k = rng.standard_normal((1, B, W, K, HD)).astype(np.float32)
    pos = np.full((1, B, W), -1, np.int32)
    for b, n in enumerate([4, 6, 2]):
        pos[0, b, :n] = np.arange(n)
    raw = {"k": k, "v": 0.5 * k, "pos": pos}
    je = {n: v[0] for n, v in jc.pack_entry(
        {n: jnp.asarray(v) for n, v in raw.items()}).items()}
    te = {n: v[0] for n, v in tc.pack_entry(
        {n: torch.from_numpy(v) for n, v in raw.items()}).items()}
    return jc, tc, je, te, np.array([4, 6, 2], np.int32)


@pytest.mark.parametrize("layout", ["slot_major", "paged"])
def test_serve_records_and_numerics_snapshot_match_reference(layout):
    rng = np.random.default_rng(4)
    jc, tc, je, te, pos = (_paged_pool if layout == "paged"
                           else _slot_pool)(rng)
    B, K, HD = 3, 2, 8
    prev_j = prev_t = None
    lines = []
    for step, gain in enumerate((1.0, 8.0, 8.0, 0.02, 0.02, 0.02)):
        kn = (gain * rng.standard_normal((B, K, HD))).astype(np.float32)
        je = jc.append(je, jnp.asarray(kn), jnp.asarray(kn),
                       jnp.asarray(pos))
        te = tc.append(te, torch.from_numpy(kn), torch.from_numpy(kn),
                       torch.from_numpy(pos))
        pos = pos + 1
        jpool = {"dec": {"0:attn": {n: v[None] for n, v in je.items()}}}
        tpool = {"dec": {"0:attn": {n: v[None] for n, v in te.items()}}}
        js = jax.device_get(jkv.numerics_snapshot(jpool, B))
        ts = tkv.numerics_snapshot(tpool, B)
        assert set(ts) == set(js) == {"dec/0:attn"}
        for name, v in js["dec/0:attn"].items():
            np.testing.assert_array_equal(ts["dec/0:attn"][name].numpy(), v,
                                          name)
        uids = {0: 10, 2: 12}
        want = jobs.serve_records(js, prev_j, step=step, t=1.5,
                                  slot_uids=uids)
        got = tobs.serve_records(ts, prev_t, step=step, t=1.5,
                                 slot_uids=uids)
        assert _lines(got) == _lines(want)
        lines += _lines(got)
        prev_j, prev_t = js, ts
    assert tobs.count_moves([json.loads(s) for s in lines]) > 0
    # a float32 pool has no exponents to sample
    assert tkv.numerics_snapshot({"dec": {"0:attn": {
        "k": torch.zeros(1), "v": torch.zeros(1)}}}, B) == {}


def _fill(reg):
    reg.counter("steps", "train steps").inc(3)
    reg.counter("bytes").inc(2.5)
    g = reg.gauge("mem_gb", "device memory")
    for v in (1.5, 4.0, 2.0):
        g.set(v)
    h = reg.histogram("ttft_s", "time to first token", lo=1e-3,
                      n_buckets=12)
    for v in (0.0005, 0.002, 0.002, 0.03, 0.5, 1.7, 9.0):
        h.observe(v)
    reg.histogram("empty")
    return h


def test_metrics_outputs_match_reference():
    jreg, treg = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    jh, th = _fill(jreg), _fill(treg)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.prometheus_text() == jreg.prometheus_text()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jreg.snapshot_jsonl(jbuf, {"step": 7})
    treg.snapshot_jsonl(tbuf, {"step": 7})
    jrec, trec = json.loads(jbuf.getvalue()), json.loads(tbuf.getvalue())
    assert jrec.pop("t") <= trec.pop("t")
    assert trec == jrec
    server = tobs.start_http_server(treg)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            assert r.read().decode() == treg.prometheus_text()
    finally:
        server.shutdown()
        server.server_close()


def test_supervisor_numerics_log_and_bundle(tmp_path):
    _, tcfg, _, tp, gs = _maxout()
    pol = TPolicy(**DFXP)
    state = t_init_state(tp, topt.sgd_init(tp), gs, pol, init_exp=-6.0)
    log = tobs.NumericsLog(str(tmp_path / "num.jsonl"))
    sup = TrainSupervisor(
        lambda p, b, s, e: TMX.loss_fn(tcfg, pol, p, b, e, s), gs, pol,
        topt.OptConfig(**OPT), state, batch_fn=lambda c: _batch(c)[1],
        rng=0, numerics_log=log, bundle_dir=str(tmp_path / "bundle"))
    n_cls = len({tensor_class(g) for g in state.scale.exps})
    for n in range(1, 6):
        sup.step_once()
        assert len(log.records) == n_cls * (n // 2)
        if n % 2 == 0:     # the newest records hold the state's exponents
            exps = {g: float(v) for g, v in sup.state.scale.exps.items()}
            for r in log.records[-n_cls:]:
                vals = [e for g, e in exps.items()
                        if tensor_class(g) == r["class"]]
                assert r["step"] == n
                assert r["n_groups"] == len(vals)
                assert (r["exp_min"], r["exp_max"]) == (min(vals),
                                                        max(vals))
    log.close()
    assert tobs.read_jsonl(str(tmp_path / "num.jsonl")) == log.records
    sup.write_bundle()
    tail = tobs.read_jsonl(str(tmp_path / "bundle" / "numerics_tail.jsonl"))
    assert tail == log.records[-50:]


def test_trainer_cli_numerics_log(tmp_path):
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    argv = ["--arch", "llama3_8b", "--smoke", "--global-batch", "2",
            "--seq-len", "16", "--arithmetic", "dfxp", "--calibrate-steps",
            "1", "--update-interval", "2", "--steps", "4", "--log-every", "1"]
    runs = []
    for name, main, extra in (("ref", jtrain.main, []),
                              ("port", ttrain.main, ["--device", "cpu"])):
        path = str(tmp_path / f"{name}.jsonl")
        with contextlib.redirect_stdout(io.StringIO()) as out:
            state = main(argv + extra + ["--numerics-log", path])
        assert f"-> {path}" in out.getvalue()
        runs.append((tobs.read_jsonl(path), state))
    (ref, _), (port, state) = runs
    keep = ("kind", "step", "class", "n_groups", "exp_mean", "exp_min",
            "exp_max", "moves_up", "moves_down")
    # the first controller application (step 2) is the reference's; the
    # two free-running DFXP runs part at their first flipped tie after it
    assert [{k: r[k] for k in keep} for r in port if r["step"] == 2] == \
        [{k: r[k] for k in keep} for r in ref if r["step"] == 2]
    assert [r["step"] for r in port] == [r["step"] for r in ref]
    assert sorted({r["step"] for r in port}) == [2, 4]
    assert tobs.count_moves(port) > 0
    exps = {g: float(v) for g, v in state.scale.exps.items()
            if v.ndim == 0}
    stacked = {g: v.tolist() for g, v in state.scale.exps.items()
               if v.ndim}
    for r in (r for r in port if r["step"] == 4):
        vals = [e for g, e in exps.items() if tensor_class(g) == r["class"]]
        vals += [e for g, es in stacked.items()
                 if tensor_class(g) == r["class"] for e in es]
        assert r["n_groups"] == len(vals)
        assert (r["exp_min"], r["exp_max"]) == (min(vals), max(vals))
