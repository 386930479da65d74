"""The port's dry run (``repro_torch.configs.shapes``,
``repro_torch.launch.dryrun``) against the reference's.

* ``SHAPES``, ``cells()``, ``all_cells()`` and the per-arch settings
  equal the reference's; ``input_specs`` gives the reference's keys,
  shapes and dtypes for every arch × shape (the decode cache on the meta
  device against ``jax.eval_shape``);
* per-device ``argument_bytes``, ``output_bytes`` and ``alias_bytes`` of
  all 66 (arch × shape × mesh) records equal the same sums over the
  reference's ``ShardingRules`` specs and ``jax.eval_shape`` trees (the
  reference's declared outputs: the state and its three scalar metrics;
  the last logits over ``(dp, "model")`` and the cache);
* the counted flops of the smoke cells (B = 2, S = 32, ``ce_chunk`` 16,
  one device) equal ``benchmarks.hlo_cost.analyze_text`` of the
  reference's compiled program — train (``remat`` none and full),
  prefill and decode over llama3, granite, mamba2, seamless and qwen2-vl,
  and the whole train step at two microbatches (llama3, granite) —
  up to the differences :func:`named_remainder` names by op and shape.
  The programs run float32 arithmetic (DFXP's rounding adds no matrix
  product in either package, and compiles 2–3× slower), and one case
  runs the dry run's own DFXP 10/12.  Every count is compiled live
  (``tools/ref_dryrun_flops.py``) in a pool of spawned processes started
  beside the port's traces;
* a microbatched train step traced by its first microbatch counts what
  a trace of every microbatch counts, and a step that does not call
  ``train.step.loss_and_grads`` once a microbatch raises;
* the counter's flops, bytes and live peak on a known sequence; the CLI:
  one cell's record, ``--all`` resuming over 65 done records, a raising
  cell recorded as not ``ok``.

The reference's ``repro.launch.dryrun`` forces 512 host devices at import,
so it is not imported: its ``ARCH_SETTINGS`` are read from its source,
and its programs are built from the modules it calls
(``tools/ref_dryrun_flops.py``).  The CLI's subprocess starts beside the
port's traces too.
"""
import ast
import dataclasses
import functools
import gzip
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as rconfigs
from repro.configs import shapes as rshapes
from repro.core.policy import PrecisionPolicy as RPolicy
from repro.dist import sharding as rsharding
from repro.models import transformer as RT
from repro.optim.opt import sgd_init as rsgd_init
from repro.train import init_train_state as r_init_train_state
from tools.ref_dryrun_flops import (B, CASES, CE, MICROBATCHED, S, parse,
                                    policy, ref_flops)
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import ShardingRules
from repro_torch.dist.sharding import leaves_with_path
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import AbstractMesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_settings() -> dict:
    """``ARCH_SETTINGS`` of the reference's dry run, from its source."""
    path = os.path.join(REPO, "src", "repro", "launch", "dryrun.py")
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "ARCH_SETTINGS":
            return eval(compile(ast.Expression(node.value), path, "eval"),
                        {"dict": dict})
    raise AssertionError("no ARCH_SETTINGS")


def test_arch_settings_match_reference():
    assert D.ARCH_SETTINGS == _ref_settings()
    assert D.COLLECTIVES == ("all-gather", "all-reduce", "reduce-scatter",
                             "all-to-all", "collective-permute")


def test_shapes_match_reference():
    assert list(shapes.SHAPES) == list(rshapes.SHAPES)
    for name, s in shapes.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            rshapes.SHAPES[name])
    assert configs.SHAPES is shapes.SHAPES
    assert configs.input_specs is shapes.input_specs
    assert configs.ShapeSpec is shapes.ShapeSpec


def test_cells_match_reference():
    assert configs.all_cells() == rconfigs.all_cells()
    for a in configs.ARCHS:
        assert configs.cells(a) == rconfigs.cells(a)
    assert sum(len(c) for c in configs.all_cells().values()) == 33


def _ref_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(rsharding._path_parts(p)):
            (tuple(x.shape), np.dtype(x.dtype).name) for p, x in flat}


def _port_flat(tree):
    return {"/".join(p): (tuple(t.shape), str(t.dtype)[len("torch."):])
            for p, t in leaves_with_path(tree)}


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_input_specs_match_reference(arch):
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    for name in shapes.SHAPES:
        got = shapes.input_specs(cfg, shapes.SHAPES[name])
        want = rshapes.input_specs(rcfg, rshapes.SHAPES[name])
        assert _port_flat(got) == _ref_flat(want), name
        assert all(t.device.type == "meta"
                   for _, t in leaves_with_path(got))


# ---------------------------------------------------------------------------
# per-device bytes of the 66 records
# ---------------------------------------------------------------------------

class _StubMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _block(shape, itemsize, spec, mesh) -> int:
    dims = list(shape)
    for d, e in enumerate(tuple(spec)[:len(dims)]):
        if e is not None:
            names = e if isinstance(e, tuple) else (e,)
            n = int(np.prod([mesh[a] for a in names]))
            dims[d] = -(-dims[d] // n)
    return int(np.prod(dims)) * itemsize


def _rbytes(tree, specs, mesh) -> int:
    leaves = jax.tree.leaves(tree)
    sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(sp)
    return sum(_block(x.shape, np.dtype(x.dtype).itemsize, s, mesh)
               for x, s in zip(leaves, sp))


@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    rcfg = rconfigs.get(arch)
    s = _ref_settings()[arch]
    pol = RPolicy("dfxp", comp_width=10, update_width=12,
                  update_interval=100, storage=s["storage"],
                  compute_dtype=s["compute"])
    gs = RT.group_shapes(rcfg)
    params = jax.eval_shape(lambda: RT.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    state = jax.eval_shape(lambda p: r_init_train_state(
        p, rsgd_init(p), gs, pol, init_exp=-8.0), params)
    exps = {n: jax.ShapeDtypeStruct(sh, jnp.float32) for n, sh in gs.items()}
    return rcfg, pol, params, state, exps


def _ref_record_bytes(arch, shape_name, mesh, rules):
    rcfg, pol, params, state, exps = _ref_trees(arch)
    shape = rshapes.SHAPES[shape_name]
    cdtype = jnp.dtype(pol.compute_dtype)
    B, S = shape.global_batch, shape.seq_len
    rep = lambda t: jax.tree.map(lambda _: P(), t)   # noqa: E731
    if shape.kind == "train":
        batch = rshapes.input_specs(rcfg, shape)["batch"]
        sb = _rbytes(state, rules.state_shardings(state), mesh)
        return (sb + _rbytes(batch, rules.batch_shardings(batch), mesh),
                sb + 3 * 4, sb)
    dp = rules.dp if rules.shard_batch else None
    logits = _block((B, rcfg.vocab_size), cdtype.itemsize, P(dp, "model"),
                    mesh)
    cache = jax.eval_shape(lambda: RT.init_cache(
        rcfg, B, S, src_len=S if rcfg.encoder_layers else 0, dtype=cdtype))
    cb = _rbytes(cache, rules.cache_shardings(cache), mesh)
    pb = _rbytes(params, rules.params_shardings(params), mesh)
    eb = _rbytes(exps, rep(exps), mesh)
    if shape.kind == "prefill":
        batch = rshapes.input_specs(rcfg, shape)["batch"]
        return (pb + _rbytes(batch, rules.batch_shardings(batch), mesh) + eb,
                logits + cb, 0)
    tok = rshapes.input_specs(rcfg, shape)["tokens"]
    tspec = (P(dp) if rcfg.input_mode == "tokens" else P(dp, None, None)) \
        if rules.shard_batch else P()
    return (pb + cb + _block(tok.shape, 4, tspec, mesh) + 4 + eb,
            logits + cb, cb)


@pytest.fixture
def ref_rules(monkeypatch):
    # the reference's rules read only mesh.shape; its NamedSharding
    # wrapper is replaced by the bare PartitionSpec
    monkeypatch.setattr(rsharding, "NamedSharding", lambda mesh, spec: spec)

    def make(shape, **kw):
        return rsharding.ShardingRules(_StubMesh(shape), **kw)
    return make


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_record_bytes_match_reference(arch, ref_rules):
    for shape_name in configs.cells(arch):
        long_ctx = shape_name == "long_500k"
        for mesh_name, mesh in MESHES.items():
            multi = "pod" in mesh
            cell = D.build_cell(arch, shape_name, multi)
            assert all(t.device.type == "meta" for t, _ in D.leaf_specs(
                cell["params"], cell["param_specs"]))
            got = D.cell_bytes(cell)
            ref = ref_rules(mesh, multi_pod=multi, shard_batch=not long_ctx,
                            seq_shard_cache=long_ctx)
            want = _ref_record_bytes(arch, shape_name, mesh, ref)
            have = (got["argument_bytes"], got["output_bytes"],
                    got["alias_bytes"])
            assert have == want, (shape_name, mesh_name)
            assert sum(got["groups"].values()) == got["argument_bytes"]


# ---------------------------------------------------------------------------
# flops at smoke size against the reference's hlo_cost
# ---------------------------------------------------------------------------

FLOPS_CASES = CASES + MICROBATCHED

# the reference's compiles: several cores for a second or more each
_COMPILER = ProcessPoolExecutor(
    max_workers=3, mp_context=multiprocessing.get_context("spawn"))


@functools.lru_cache(maxsize=None)
def _ref_flops():
    """``{case: future of the reference's hlo_cost flops}``, the train
    programs (the slow compiles) submitted first."""
    order = sorted(FLOPS_CASES, key=lambda c: parse(c[1])[0] != "train")
    return {c: _COMPILER.submit(ref_flops, *c) for c in order}


def _cli_command(tmp):
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            "granite_moe_1b", "--shape", "decode_32k", "--out",
            os.path.join(tmp, "r.jsonl"), "--ops-dir",
            os.path.join(tmp, "ops")]


@functools.lru_cache(maxsize=None)
def _cli_run():
    """The CLI on one cell, in a subprocess started beside the tests."""
    tmp = tempfile.mkdtemp(prefix="dryrun_cli_")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return tmp, subprocess.Popen(_cli_command(tmp), cwd=tmp, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module", autouse=True)
def _start_background():
    _ref_flops()
    tmp, proc = _cli_run()
    yield
    _COMPILER.shutdown(wait=False, cancel_futures=True)
    if proc.poll() is None:
        proc.kill()
    proc.communicate()
    shutil.rmtree(tmp, ignore_errors=True)


def named_remainder(cfg, case) -> int:
    """Port flops minus the reference's ``hlo_cost`` flops, named:

    * mamba2 train: the backward of the SSD's three-operand einsums
      (``ssm.py`` ``hc`` and ``y_inter``).  XLA transposes each into two
      ``dot_general``s, ``[B, nc, Q, N]`` over the heads and ``[B, nc, Q,
      H]`` over the state, 2·B·S·N·H flops each; torch's autograd of its
      einsum path forms the same sums as broadcast multiplies and
      reductions, which count no matrix product: −4·2·B·S·N·H a layer.
    * mamba2 decode: the depthwise conv over the cached window.  The
      reference writes it as ``einsum("bkc,kc->bc")``, a ``[conv_dim, B]``
      dot over the kernel's K taps; the port as K shifted multiply-adds:
      −2·B·conv_dim·K a layer.
    * seamless prefill: the cross-attention K/V of the encoder's memory
      for the decode cache.  Both packages compute ``memory @ wk`` and
      ``memory @ wv`` once for attention and again for the cache; XLA's
      CSE merges the pair, the port runs both: +2 · 2·B·S_src·D·(K·hd) a
      decoder layer (the port's redundant work, ROADMAP §2).
    """
    kind = case.split("_")[0]
    if cfg.family == "ssm" and kind == "train":
        sp = cfg.ssm_spec
        return -cfg.num_layers * 4 * 2 * B * S * sp.state * sp.heads
    if cfg.family == "ssm" and kind == "decode":
        sp = cfg.ssm_spec
        return -cfg.num_layers * 2 * B * sp.conv_dim * sp.conv_kernel
    if cfg.encoder_layers and kind == "prefill":
        kv = cfg.num_kv_heads * cfg.head_dim
        return cfg.num_layers * 2 * 2 * B * S * cfg.d_model * kv
    return 0


def _smoke_cell(arch, case, arith):
    cfg = configs.get_smoke(arch)
    kind, remat, mb = parse(case)
    mesh = AbstractMesh((1, 1), ("data", "model"))
    return D.make_cell(cfg, shapes.ShapeSpec("smoke", S, B, kind),
                       policy(PrecisionPolicy, arith), mesh,
                       ShardingRules(mesh), remat=remat, ce_chunk=CE,
                       microbatches=mb)


@functools.lru_cache(maxsize=None)
def _smoke_trace(arch, case, arith):
    return D.trace(_smoke_cell(arch, case, arith))


def test_microbatch_shortcut_counts_every_microbatch():
    """Two microbatches counted from the first equal both traced (flops,
    bytes, transcendentals, the census)."""
    short = _smoke_trace("granite_moe_1b", "train_full_mb2", "float32")
    every = D.trace(_smoke_cell("granite_moe_1b", "train_full_mb2",
                                "float32"), every_microbatch=True)
    for k in ("flops", "bytes", "transcendentals", "census"):
        assert short[k] == every[k], k


def test_uncounted_microbatches_raise():
    """A step holding its own reference to ``loss_and_grads`` (bound
    before the trace wraps the module's) bypasses the counted wrapper:
    the trace refuses it."""
    from repro_torch.train import step as train_step
    cell = _smoke_cell("llama3_8b", "train_none_mb2", "float32")
    run, bound = cell["run"], train_step.loss_and_grads

    def run_bound():
        wrapper, train_step.loss_and_grads = train_step.loss_and_grads, bound
        try:
            return run()
        finally:
            train_step.loss_and_grads = wrapper
    cell["run"] = run_bound
    with pytest.raises(RuntimeError, match="0 times, not 2"):
        D.trace(cell)
    assert train_step.loss_and_grads is bound


@pytest.mark.parametrize("arch,case,arith", FLOPS_CASES)
def test_smoke_flops_match_reference(arch, case, arith):
    got = _smoke_trace(arch, case, arith)["flops"]
    want = _ref_flops()[arch, case, arith].result()
    assert got - want == named_remainder(configs.get_smoke(arch), case), \
        (got, want)


def test_remat_full_adds_the_recomputed_forward():
    """``remat="full"`` counts each layer's forward again, up to the last
    tensor its backward needs: the full step minus the plain one is one
    forward pass of the layers (``mode="hidden"``, no head) less each
    layer's last product (``w_down``), whose output no backward reads —
    the non-reentrant checkpoint stops there, as XLA drops it; the
    reference's two counts differ by the same."""
    from repro_torch.models import transformer as T
    cfg = configs.get_smoke("llama3_8b")
    pol = PrecisionPolicy("float32")
    got = {r: _smoke_trace("llama3_8b", f"train_{r}", "float32")["flops"]
           for r in ("none", "full")}
    params = T.init_params(cfg, 0, device="meta")
    batch = shapes.input_specs(cfg, shapes.ShapeSpec("s", S, B, "train"))
    counter = D.OpCounter()
    with counter, torch.no_grad():
        T.forward(cfg, pol, params, batch["batch"], {}, {}, mode="hidden")
    w_down = 2 * B * S * cfg.d_ff * cfg.d_model
    assert got["full"] - got["none"] == \
        counter.flops - cfg.num_layers * w_down
    ref = {r: _ref_flops()["llama3_8b", f"train_{r}", "float32"].result()
           for r in ("none", "full")}
    assert (got["none"], got["full"]) == (ref["none"], ref["full"])


# ---------------------------------------------------------------------------
# the counter itself, and the CLI
# ---------------------------------------------------------------------------

def test_op_counter_counts_a_known_sequence():
    x = torch.empty((8, 16), device="meta")
    w = torch.empty((16, 32), device="meta")
    counter = D.OpCounter()
    counter.known((x, w))
    with counter:
        y = x @ w                       # 8*32 f32 allocated
        z = torch.relu(y)               # another
        del y                           # freed
        with counter.repeat(3):
            v = z.t() @ x               # [32, 16]: a view, then a product
        u = v.sum()
        del z, v, u
    assert counter.flops == 2 * 8 * 16 * 32 + 3 * 2 * 32 * 8 * 16
    assert counter.peak == 8 * 32 * 4 + 32 * 16 * 4 + 4     # z, v, u
    assert counter.live == 0
    mm = (8 * 16 + 16 * 32 + 8 * 32) * 4
    relu = 2 * 8 * 32 * 4
    mm2 = 3 * (32 * 8 + 8 * 16 + 32 * 16) * 4
    assert counter.bytes == mm + relu + mm2 + (32 * 16 + 1) * 4
    assert sum(c for c, _ in counter.census.values()) == 1 + 1 + 3 + 3 + 1


REF_KEYS = {"arch", "shape", "mesh", "ok", "per_device", "flops",
            "bytes_accessed", "transcendentals", "collectives", "loop_aware"}


def test_cli_writes_one_record():
    tmp, proc = _cli_run()
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    out = os.path.join(tmp, "r.jsonl")
    rec, = [json.loads(line) for line in open(out)]
    assert REF_KEYS | {"basis", "flops_global", "trace_s", "ops"} <= set(rec)
    assert rec["ok"] and rec["mesh"] == "16x16"
    assert set(rec["per_device"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes", "alias_bytes"}
    assert set(rec["collectives"]) >= {"bytes", "count", "total_bytes"}
    assert set(rec["collectives"]["bytes"]) == set(D.COLLECTIVES)
    assert set(rec["loop_aware"]) == {"flops", "traffic_bytes",
                                      "collective_bytes",
                                      "collective_by_kind"}
    assert rec["flops"] * 256 == rec["flops_global"] > 0
    assert rec["collectives"]["bytes"]["all-to-all"] > 0      # EP decode
    assert rec["cuda_initialized"] is False
    with gzip.open(rec["ops"], "rt") as f:
        census = json.load(f)
    assert sum(c["flops"] for c in census) == rec["flops_global"]


def _all_cells():
    return [(a, s, m) for a in configs.ARCHS for s in configs.cells(a)
            for m in MESHES]


def test_all_resumes_past_done_records(tmp_path, capsys):
    out = tmp_path / "r.jsonl"
    left = ("seamless_m4t_medium", "decode_32k", "2x16x16")
    cells = _all_cells()
    assert len(cells) == 66 and left in cells
    with open(out, "w") as f:
        for a, s, m in cells:
            if (a, s, m) != left:
                f.write(json.dumps({"arch": a, "shape": s, "mesh": m,
                                    "ok": True}) + "\n")
    assert D.main(["--all", "--out", str(out), "--ops-dir", ""]) == 0
    recs = [json.loads(line) for line in open(out)]
    assert len(recs) == 66
    new = recs[-1]
    assert (new["arch"], new["shape"], new["mesh"]) == left and new["ok"]
    assert capsys.readouterr().out.count("skip (done)") == 65


def test_all_records_a_raising_cell(tmp_path, monkeypatch):
    out = tmp_path / "r.jsonl"
    cells = _all_cells()
    with open(out, "w") as f:
        for a, s, m in cells[1:]:
            f.write(json.dumps({"arch": a, "shape": s, "mesh": m,
                                "ok": True}) + "\n")

    def boom(*a, **kw):
        raise RuntimeError("x" * 300)
    monkeypatch.setattr(D, "run_cell", boom)
    D.main(["--all", "--out", str(out), "--ops-dir", ""])
    rec = json.loads(open(out).read().splitlines()[-1])
    assert rec == {"arch": cells[0][0], "shape": cells[0][1],
                   "mesh": cells[0][2], "ok": False, "error": "x" * 200}
