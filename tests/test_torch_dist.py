"""``repro_torch.dist`` and ``repro_torch.launch.mesh`` against ``repro.dist``.

The reference's collectives run under ``jax.vmap(..., axis_name=...)`` in
this process; the port's run in worlds of ranks spawned once per world
size (gloo on the CPU, one torch thread a rank, a ``file://`` rendezvous
in a fresh directory, a timeout on every collective), each rank running
every case of the ranks' module and returning its results.

* the context factories and every ``MeshConfigError`` of the contexts,
  the mesh and the pool factory;
* ``ShardingRules``' entries equal the reference's for every leaf of the
  ten smoke configs (params, train state, batch, decode cache, serve
  pools) on a 1×1 mesh and the 16×16 and 2×16×16 production shapes;
* ``compress_decompress`` and ``compress_tree`` with and without an
  axis, and ``compressed_all_to_all`` forward and backward, bit for bit;
* ``cp_decode_attention`` merged over worlds of 2 and 4 within 1e-6 of
  the reference's monolithic result, and the monolithic paths;
* MoE expert parallelism on a 2×2 world (E = 8): plain, FSDP and the
  stationary decode within 1e-5 of the local path, int8 lanes within
  1e-5 of the reference's expert-parallel block under ``vmap``;
* the bytes the EP blocks' all-to-alls and the CP merge move (the mesh's
  collectives counted on the ranks) equal the dry run's implied
  collectives for the same block and mesh
  (``repro_torch.launch.dryrun.experts`` and ``cp_merge``);
* plan selection (``kernels.dispatch``) on a bound mesh: the first rank
  times the candidates and every rank runs its plan, whatever plans the
  ranks' own caches hold;
* resharded checkpoints: granite-smoke's train state, saved whole by
  this process, restored on every rank under TP, FSDP and both to
  exactly its block of each leaf, saved back by the ranks to the same
  files byte for byte; a corrupt leaf named on every rank, a corrupt
  newest step skipped by every rank together;
* ``launch.mesh.spawn``'s report of a world that fails (a rank that
  dies, a result that never arrives, a crash after the result).

The ranks' side is ``tests/_torch_dist_ranks.py``, which imports no jax.
"""
import dataclasses
import functools
import hashlib
import json
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as rconfigs
from repro.core.policy import PrecisionPolicy as RPolicy
from repro.dist import compress as rcompress
from repro.dist import context as rcontext
from repro.dist import cp_attention as rcp
from repro.dist import sharding as rsharding
from repro.models import moe as rmoe
from repro.models import transformer as RT
from repro.optim.opt import sgd_init as rsgd_init
from repro.serve.kv_pool import make_kv_pool as r_make_kv_pool
from repro.train.state import init_train_state as r_init_train_state
import _torch_dist_ranks as R
from _torch_dist_ranks import (A2A_SCALES, MOE_DISTS, MOE_SPEC, _a2a,
                               _cp_inputs, _grads, _moe_inputs, _port_moe,
                               _t)
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import (DistCtx, MeshConfigError, ShardingRules,
                              compress, context, cp_attention)
from repro_torch.dist.sharding import leaves_with_path
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.optim.opt import sgd_init
from repro_torch.serve.kv_pool import make_kv_pool
from repro_torch.train.state import init_train_state

TIMEOUT = 120.0


# ---------------------------------------------------------------------------
# the worlds: the ranks' side is tests/_torch_dist_ranks.py (torch only)
# ---------------------------------------------------------------------------

_LAUNCHER = ThreadPoolExecutor(max_workers=3)


@functools.lru_cache(maxsize=None)
def _ckpt_dir():
    """The parent's checkpoints for the ranks: ``whole`` (step 1, the
    seeded state saved in this one process), ``corrupt`` (its copy with a
    byte of ``CORRUPT_LEAF``'s file flipped), per world and layout,
    ``fallback_<n>_<layout>`` (step 1 whole, step 2 the corrupt copy),
    and per world and rank ``skew_<n>/rank<r>`` (step 1, and a whole step
    2 on every rank but the first) and ``lost_<n>/rank<r>`` (steps 1 and
    2 whole, step 2's manifest gone on the last rank)."""
    d = tempfile.mkdtemp(prefix="repro_ckpt_")
    CheckpointManager(os.path.join(d, "whole")).save(R.CKPT_STEP,
                                                     R.ckpt_tree())
    step = f"step_{R.CKPT_STEP:08d}"
    good = os.path.join(d, "whole", step)
    bad = os.path.join(d, "corrupt", step)
    shutil.copytree(good, bad)
    with open(os.path.join(bad, "manifest.json")) as f:
        fname = {m["name"]: m["file"] for m in json.load(f)["leaves"]}
    with open(os.path.join(bad, fname[CORRUPT_LEAF]), "r+b") as f:
        f.seek(-3, os.SEEK_END)
        byte = f.read(1)
        f.seek(-3, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0x10]))
    for n, meshes in R.CKPT_MESHES.items():
        for name in meshes:
            fb = os.path.join(d, f"fallback_{n}_{name}")
            shutil.copytree(good, os.path.join(fb, step))
            shutil.copytree(bad, os.path.join(fb, "step_00000002"))
        for r in range(n):
            skew = os.path.join(d, f"skew_{n}", f"rank{r}")
            lost = os.path.join(d, f"lost_{n}", f"rank{r}")
            for where in (skew, lost):
                shutil.copytree(good, os.path.join(where, step))
            for where in ((skew,) if r else ()) + (lost,):
                shutil.copytree(good, os.path.join(where, "step_00000002"))
        os.remove(os.path.join(d, f"lost_{n}", f"rank{n - 1}",
                               "step_00000002", "manifest.json"))
    return d


CORRUPT_LEAF = "params/embed"


@functools.lru_cache(maxsize=None)
def _world_future(n):
    """The world of ``n`` ranks, started once, in the background: the
    reference's side of the tests runs here meanwhile."""
    return _LAUNCHER.submit(M.spawn, R._world_main, n, n, _ckpt_dir(),
                            threads=1, timeout_s=TIMEOUT)


def _world(n):
    return _world_future(n).result()


@functools.lru_cache(maxsize=None)
def _failure_future():
    """The report of a world of 3 that fails (``R.failing_world``),
    started after the worlds above are done."""
    def run():
        for n in (2, 4):
            _world_future(n).exception()
        try:
            M.spawn(R.failing_world, 3, threads=1, timeout_s=TIMEOUT)
        except RuntimeError as e:
            return str(e)
        return None
    return _LAUNCHER.submit(run)


@pytest.fixture(scope="module", autouse=True)
def _start_worlds():
    for n in (2, 4):
        _world_future(n)
    _failure_future()
    yield
    _failure_future().exception()
    shutil.rmtree(_ckpt_dir(), ignore_errors=True)


# ---------------------------------------------------------------------------
# contexts, meshes, construction errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["single_pod_ctx", "multi_pod_ctx"])
def test_pod_contexts_match_reference(name):
    want = dataclasses.asdict(getattr(rcontext, name)())
    assert dataclasses.asdict(getattr(context, name)()) == want


@pytest.mark.parametrize("tp,cp", [(1, 1), (2, 1), (1, 4), (2, 2)])
def test_serve_pod_ctx_matches_reference(tp, cp):
    got = context.serve_pod_ctx(tp=tp, cp=cp)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        rcontext.serve_pod_ctx(tp=tp, cp=cp))
    assert got.active == (tp * cp > 1)
    assert got.cp_axes == (("data",) if cp > 1 else ())


@pytest.mark.parametrize("tp,cp", [(0, 1), (1, -1)])
def test_nonpositive_degrees_raise(tp, cp):
    for fn in (context.serve_pod_ctx, M.make_serve_mesh):
        with pytest.raises(MeshConfigError, match="must be >= 1"):
            fn(tp=tp, cp=cp)


def test_mesh_oversubscription_raises():
    with pytest.raises(MeshConfigError, match="devices but only 1"):
        M.make_serve_mesh(tp=2)


def test_meshes_shapes():
    assert M.make_production_mesh().shape == {"data": 16, "model": 16}
    assert M.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert M.make_debug_mesh(2, 4).shape == {"data": 2, "model": 4}
    one = M.make_serve_mesh()
    assert one.shape == {"data": 1, "model": 1} and one.size == 1
    assert one.axis_index("model") == 0
    x = torch.arange(6.0)
    assert torch.equal(one.psum(x, "model"), x)
    assert torch.equal(one.all_to_all(x, "model", 0, 0), x)


def test_pool_construction_errors():
    cfg = configs.get_smoke("llama3_8b")
    pol = PrecisionPolicy("float32")
    kw = dict(max_slots=1, max_len=16, device="cpu")
    with pytest.raises(MeshConfigError, match="needs the mesh"):
        make_kv_pool(cfg, pol, DistCtx(ep_axis="model",
                                       all_axes=("model",)), **kw)
    with pytest.raises(MeshConfigError, match="absent from the mesh"):
        make_kv_pool(cfg, pol, context.serve_pod_ctx(tp=2),
                     mesh=M.AbstractMesh((2,), ("data",)), **kw)
    with pytest.raises(MeshConfigError, match="paged"):
        make_kv_pool(cfg, pol, context.serve_pod_ctx(cp=2), page_size=8,
                     mesh=M.make_debug_mesh(2, 1), **kw)
    with pytest.raises(MeshConfigError, match="divisible"):
        make_kv_pool(cfg, pol, context.serve_pod_ctx(cp=2),
                     mesh=M.make_debug_mesh(2, 1), max_slots=1, max_len=15,
                     device="cpu")


# ---------------------------------------------------------------------------
# ShardingRules against the reference's, leaf by leaf
# ---------------------------------------------------------------------------

class _StubMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"1x1": {"data": 1, "model": 1},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _ref_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(rsharding._path_parts(p)): tuple(s) for p, s in flat}


def _port_specs(tree, path=()):
    if isinstance(tree, tuple):
        return {"/".join(path): tree}
    out = {}
    kids = tree.items() if isinstance(tree, dict) else \
        ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    for k, v in kids:
        out.update(_port_specs(v, path + (str(k),)))
    return out


def _meta(tree):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """The reference's and the port's params, state, batch and cache."""
    rcfg, cfg = rconfigs.get_smoke(arch), configs.get_smoke(arch)
    rp = jax.eval_shape(lambda: RT.init_params(rcfg, jax.random.PRNGKey(0)))
    rstate = jax.eval_shape(lambda p: r_init_train_state(
        p, rsgd_init(p), RT.group_shapes(rcfg), RPolicy("dfxp")), rp)
    rcache = jax.eval_shape(lambda: RT.init_cache(rcfg, 2, 16))
    p = T.init_params(cfg, 0, device="meta")
    state = init_train_state(p, sgd_init(p), T.group_shapes(cfg),
                             PrecisionPolicy("dfxp"))
    cache = T.init_cache(cfg, 2, 16, device="meta")
    batch = {"tokens": np.zeros((4, 8), np.int32),
             "labels": np.zeros((4, 8), np.int32),
             "positions": np.zeros((3, 4, 8), np.int32),
             "loss_mask": np.zeros((4, 8), np.float32)}
    return (rp, rstate, rcache), (p, state, cache), batch


@pytest.fixture
def ref_rules(monkeypatch):
    # the reference's rules read only mesh.shape; its NamedSharding
    # wrapper is replaced by the bare PartitionSpec
    monkeypatch.setattr(rsharding, "NamedSharding", lambda mesh, spec: spec)

    def make(shape, **kw):
        return rsharding.ShardingRules(_StubMesh(shape), **kw)
    return make


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_sharding_rules_match_reference(arch, mesh, ref_rules):
    shape = MESHES[mesh]
    kw = dict(multi_pod="pod" in shape)
    (rp, rstate, rcache), (p, state, cache), batch = _trees(arch)
    for seq in (False, True):
        ref = ref_rules(shape, seq_shard_cache=seq, **kw)
        got = ShardingRules(M.AbstractMesh(tuple(shape.values()),
                                           tuple(shape)),
                            seq_shard_cache=seq, **kw)
        pairs = [(ref.params_shardings(rp), got.params_shardings(p)),
                 (ref.state_shardings(rstate), got.state_shardings(state)),
                 (ref.batch_shardings(batch), got.batch_shardings(batch)),
                 (ref.cache_shardings(rcache), got.cache_shardings(cache))]
        for r, g in pairs:
            want, have = _ref_specs(r), _port_specs(g)
            assert want == have
        assert got.describe(p) == {k: str(P(*v)) for k, v in
                                   _ref_specs(ref.params_shardings(rp))
                                   .items()}
    assert len(leaves_with_path(p)) == len(jax.tree.leaves(rp))


POOL_ARCHS = [a for a in configs.ARCHS
              if configs.get_smoke(a).input_mode == "tokens"
              and not configs.get_smoke(a).encoder_layers]


@pytest.mark.parametrize("arch", POOL_ARCHS)
def test_pool_shardings_match_reference(arch, ref_rules):
    rcfg, cfg = rconfigs.get_smoke(arch), configs.get_smoke(arch)
    dense = cfg.family == "dense" and not cfg.num_experts
    layouts = [dict(cache_bits=0), dict(cache_bits=8)]
    if dense and not any(getattr(b, "window", 0) for st in
                         T.build_stages(cfg) for b in st.blocks):
        layouts.append(dict(cache_bits=8, page_size=4))
    for lay in layouts:
        rpool = r_make_kv_pool(rcfg, RPolicy("float32"), max_slots=2,
                               max_len=16, **lay).pool
        pool = make_kv_pool(cfg, PrecisionPolicy("float32"), max_slots=2,
                            max_len=16, device="cpu", **lay).pool
        for shape in MESHES.values():
            for seq in (False, True):
                ref = ref_rules(shape, shard_batch=False,
                                seq_shard_cache=seq)
                got = ShardingRules(M.AbstractMesh(tuple(shape.values()),
                                                   tuple(shape)),
                                    shard_batch=False, seq_shard_cache=seq)
                want = _ref_specs(ref.pool_shardings(rpool))
                have = _port_specs(got.pool_shardings(pool))
                assert want == have, (lay, shape, seq)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 16])
def test_compress_decompress_local_bit_exact(bits):
    g, r = _grads(1)
    want = rcompress.compress_decompress(jnp.asarray(g[0]),
                                         jnp.asarray(r[0]), bits)
    got = compress.compress_decompress(_t(g[0]), _t(r[0]), bits)
    for w, h in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), h.numpy())


def test_compress_stochastic_and_tree_bit_exact():
    g, r = _grads(1)
    key = jax.random.PRNGKey(7)
    pkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    want = rcompress.compress_decompress(jnp.asarray(g[0]),
                                         jnp.asarray(r[0]), 8,
                                         stochastic_key=key)
    got = compress.compress_decompress(_t(g[0]), _t(r[0]), 8,
                                       stochastic_key=pkey)
    for w, h in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), h.numpy())
    tg = {"w": g[0], "b": g[0][0] * 1e-3, "a": {"c": g[0][:2] * 1e2}}
    tr = {"w": r[0], "b": r[0][0], "a": {"c": r[0][:2]}}
    for sk in (None, key):
        want = rcompress.compress_tree(jax.tree.map(jnp.asarray, tg),
                                       jax.tree.map(jnp.asarray, tr), 8,
                                       stochastic_key=sk)
        got = compress.compress_tree(
            jax.tree.map(_t, tg), jax.tree.map(_t, tr), 8,
            stochastic_key=None if sk is None else pkey)
        for w, h in zip(jax.tree.leaves(want), jax.tree.leaves(
                jax.tree.map(lambda t: t.numpy(), got))):
            np.testing.assert_array_equal(np.asarray(w), h)


def test_ef_init_and_error_feedback():
    """Residual zeros of the logical shape; over 50 steps the compressed
    constant gradient averages to the true one (the reference's test)."""
    from repro_torch.core.packed import pack
    p = {"w": torch.ones(3, 4), "q": pack(torch.ones(5), 8, 0.0)}
    ef = compress.ef_init(p)
    assert ef["w"].shape == (3, 4) and ef["q"].shape == (5,)
    assert ef["q"].dtype == torch.float32 and not ef["w"].any()
    g = torch.from_numpy(np.random.RandomState(4).standard_normal(
        512).astype(np.float32)) * 1e-3
    r, acc = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        gh, r = compress.compress_decompress(g, r, 8)
        acc = acc + gh
    np.testing.assert_allclose(acc / 50, g, atol=float(g.abs().max()) * 0.02)


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_allreduce_bit_exact(n):
    g, r = _grads(n)
    want = jax.vmap(lambda g, r: rcompress.compress_decompress(
        g, r, 8, axis_name="d"), axis_name="d")(jnp.asarray(g),
                                                 jnp.asarray(r))
    tree_want = jax.vmap(lambda g, r: rcompress.compress_tree(
        {"w": g, "b": g[0] * 1e-3}, {"w": r, "b": r[0]}, 16,
        axis_name="d"), axis_name="d")(jnp.asarray(g), jnp.asarray(r))
    for rank, res in enumerate(_world(n)):
        np.testing.assert_array_equal(np.asarray(want[0][rank]),
                                      res["cd"][0])
        np.testing.assert_array_equal(np.asarray(want[1][rank]),
                                      res["cd"][1])
        for i in range(2):
            for k in ("w", "b"):
                np.testing.assert_array_equal(
                    np.asarray(tree_want[i][k][rank]), res["tree"][i][k])


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_all_to_all_fwd_bwd_bit_exact(n):
    x, ct = _a2a(n)

    def f(x):
        return rcompress.compressed_all_to_all(x, -3.0, 8, "d",
                                               split_axis=0, concat_axis=1)

    y = jax.vmap(f, axis_name="d")(jnp.asarray(x))
    cts = jnp.asarray(ct if n == 4 else ct.reshape(y.shape))

    def loss(x, c):
        return jnp.sum(f(x) * c)

    gx = jax.vmap(jax.grad(loss), axis_name="d")(jnp.asarray(x), cts)
    for rank, res in enumerate(_world(n)):
        got_y, got_gx, got_ge = res["a2a"]
        np.testing.assert_array_equal(np.asarray(y[rank]), got_y)
        np.testing.assert_array_equal(np.asarray(gx[rank]), got_gx)
        assert got_ge == 0.0


# ---------------------------------------------------------------------------
# context-parallel decode attention
# ---------------------------------------------------------------------------

def test_cp_monolithic_matches_reference():
    q, ck, cv, pos, q_pos, kw = _cp_inputs()
    want = rcp.cp_decode_attention(*map(jnp.asarray, (q, ck, cv, pos,
                                                      q_pos)), **kw)
    got = cp_attention.cp_decode_attention(*map(_t, (q, ck, cv, pos,
                                                     q_pos)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # axes the (absent) mesh does not have: the monolithic path
    got = cp_attention.cp_decode_attention(
        *map(_t, (q, ck, cv, pos, q_pos)), cp_axes=("data",), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_cp_merge_matches_reference(n):
    q, ck, cv, pos, q_pos, kw = _cp_inputs()
    want = np.asarray(rcp.cp_decode_attention(
        *map(jnp.asarray, (q, ck, cv, pos, q_pos)), **kw))
    for res in _world(n):
        np.testing.assert_allclose(res["cp"], want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(res["cp_local"], res["cp"])


# ---------------------------------------------------------------------------
# MoE expert parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,want", [("gloo", "cpu"), ("nccl", "cuda"),
                                          (None, "cpu")])
def test_collectives_cross_the_backends_device(backend, want):
    """A host tensor (the scheduler's clock, a Python scalar's sum)
    crosses NCCL on the rank's card and gloo on the host; without a
    world nothing moves.  The decision only: no card here."""
    mesh = M.BoundMesh((1, 1), ("data", "model"))
    mesh.backend = backend
    assert mesh.wire_device(torch.zeros(1, dtype=torch.float64)) == \
        torch.device(want)


@pytest.mark.parametrize("n", [2, 4])
def test_plan_selection_follows_the_first_rank(n):
    """The mesh's first rank times the candidate plans; every rank runs
    its choice (split 2), not the one its own timer prefers."""
    got = [r["plan"]["empty"] for r in _world(n)]
    assert [g[0] for g in got] == [2] * n
    assert got[0][1] > 2 and all(g[1] == 0 for g in got[1:])


@pytest.mark.parametrize("case,splits,first_timed", [("others", 2, True),
                                                     ("first", 3, False)])
@pytest.mark.parametrize("n", [2, 4])
def test_plan_agreement_ignores_each_ranks_cache(n, case, splits,
                                                 first_timed):
    """Whatever each rank's cache holds (a plan one rank loaded from a
    file that another had not seen yet), the first call of a key is one
    gather on every rank, and every rank runs the first rank's cached or
    measured plan; a second call takes it without a collective."""
    for rank, got in enumerate(r["plan"][case] for r in _world(n)):
        assert got[0] == got[3] == splits
        assert got[2] == got[4] == 1
        assert (got[1] > 2) == (first_timed and rank == 0)


def test_bound_mesh_coordinates():
    coords = [res["coords"] for res in _world(4)]
    assert coords == [{"data": d, "model": m} for d in (0, 1)
                      for m in (0, 1)]


@pytest.mark.parametrize("name", list(MOE_DISTS))
def test_moe_expert_parallel_matches_local(name):
    params, x = _moe_inputs()
    pol = PrecisionPolicy("float32")
    want = _port_moe(params, x, None, pol, name == "stationary")
    for res in _world(4):
        got = res[f"moe_{name}"]
        err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert err < 1e-5, (name, err)


def _moe_cfg():
    """A one-MoE-layer model of ``MOE_SPEC`` for the dry run's rules."""
    return T.ModelConfig(family="moe", num_layers=1, d_model=32,
                         num_heads=2, num_kv_heads=2, head_dim=16, d_ff=16,
                         num_experts=8, top_k=2, moe_d_ff=16,
                         capacity_factor=8.0)


@pytest.mark.parametrize("name,bits", [("ep", 0), ("ep_fsdp", 0),
                                       ("int8", 8)])
def test_moe_all_to_all_bytes_match_dryrun_rule(name, bits):
    """The all-to-alls an EP block moves on the 2×2 world (dispatch and
    combine, 32 tokens over ``data``, E = 8, f32 or int8 lanes) are the
    dry run's ``experts`` rule for the same block and mesh."""
    from repro_torch.launch import dryrun
    dist = MOE_DISTS["ep" if name == "int8" else name]
    want = dryrun.experts(_moe_cfg(), dist, M.AbstractMesh(
        (2, 2), ("data", "model")), tokens_global=32,
        act_dtype=torch.float32, a2a_bits=bits, decode=False, passes=1)
    want = sorted(b for k, b, c in want for _ in range(c))
    for res in _world(4):
        got = sorted(b for k, b in res[f"moe_{name}_collectives"]
                     if k == "all-to-all")
        assert got == want


@pytest.mark.parametrize("n", [2, 4])
def test_cp_merge_bytes_match_dryrun_rule(n):
    """The collectives of one CP decode attention call on a world of
    ``n`` are the dry run's ``cp_merge`` for its batch, heads and head
    dim: two all-reduces of [B, H] and one of [B, H, hd], f32."""
    from repro_torch.launch import dryrun
    _, _, _, _, _, kw = _cp_inputs()
    want = sorted((k, b) for k, b, c in dryrun.cp_merge(
        2, kw["num_heads"], kw["head_dim"]) for _ in range(c))
    for res in _world(n):
        assert sorted(res["cp_collectives"]) == want


def test_moe_int8_lanes_match_reference():
    """The int8-lane all_to_all EP block against the reference's
    ``_moe_local`` under nested ``vmap`` over (data, model)."""
    params, x = _moe_inputs()
    spec = rmoe.MoESpec(**MOE_SPEC)
    pol = RPolicy("float32", a2a_compress_bits=8)
    dist = rcontext.DistCtx(token_axes=("data",), ep_axis="model",
                            all_axes=("data", "model"))
    xf = x.reshape(2, 16, 32)             # tokens over data
    E2 = 4                                # experts per model rank

    def bank(w):
        return jnp.asarray(w).reshape((2, E2) + w.shape[1:])

    def local(xd, wg, wu, wd):
        y, _ = rmoe._moe_local(
            xd, jnp.asarray(params["router"]), wg, wu, wd,
            {k: jnp.float32(v) for k, v in A2A_SCALES.items()}, {},
            spec=spec, policy=pol, dist=dist, prefix="moe", t_local=16)
        return y

    def per_rank(w):                      # [data, model, E/2, ...]
        return jnp.broadcast_to(bank(w)[None], (2,) + bank(w).shape)

    xb = jnp.broadcast_to(jnp.asarray(xf)[:, None], (2, 2, 16, 32))
    y = jax.vmap(jax.vmap(local, axis_name="model"), axis_name="data")(
        xb, per_rank(params["w_gate"]), per_rank(params["w_up"]),
        per_rank(params["w_down"]))             # [data, model, 16, D]
    want = np.asarray(y[:, 0]).reshape(x.shape)
    for res in _world(4):
        got = res["moe_int8"]
        err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert err < 1e-5, err


# ---------------------------------------------------------------------------
# resharded checkpoints (repro_torch.checkpoint with shardings)
# ---------------------------------------------------------------------------

CKPT_CASES = [(n, name) for n, meshes in R.CKPT_MESHES.items()
              for name in meshes]


def _leaf_entries(tmpl, ents) -> list:
    """The entries at each leaf of ``tmpl``, in ``flatten``'s order (the
    two trees walked together: leaf names may hold a ``/`` of their own)."""
    if isinstance(tmpl, dict):
        return [e for k in sorted(tmpl)
                for e in _leaf_entries(tmpl[k], ents[k])]
    if isinstance(tmpl, torch.Tensor):
        return [ents]
    return [e for f in dataclasses.fields(tmpl)
            for e in _leaf_entries(getattr(tmpl, f.name),
                                   getattr(ents, f.name))]


def _block(a: np.ndarray, entries, shape, coords):
    """A rank's block of ``a`` cut by hand: each sharded dim split into
    equal parts, the rank's part at its row-major index over the axes."""
    for dim, e in enumerate(entries):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else e
        n, idx = 1, 0
        for ax in axes:
            n, idx = n * shape[ax], idx * shape[ax] + coords[ax]
        size = a.shape[dim] // n
        a = np.take(a, np.arange(idx * size, (idx + 1) * size), axis=dim)
    return a


def _digest(a: np.ndarray):
    return (a.shape, str(torch.from_numpy(a).dtype),
            hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest())


@pytest.mark.parametrize("n,layout", CKPT_CASES)
def test_resharded_restore_is_each_ranks_block(n, layout):
    """Every rank's ``restore_latest(template, shardings)`` of the whole
    state the parent saved equals its block of each leaf, bit for bit:
    granite-smoke's train state under the layout's ``ShardingRules``
    (TP over ``model``, FSDP over ``data``, or both)."""
    shape = dict(zip(("data", "model"), R.CKPT_MESHES[n][layout]))
    tmpl = R.ckpt_template()
    ents = ShardingRules(M.AbstractMesh(tuple(shape.values()),
                                        tuple(shape))).state_shardings(tmpl)
    whole = {k: v.numpy() for k, v in flatten(R.ckpt_tree())}
    at = dict(zip(whole, _leaf_entries(tmpl, ents)))
    sharded = [k for k in whole if any(e is not None for e in at[k])]
    assert len(sharded) >= 8, sharded
    for rank, res in enumerate(_world(n)):
        got = res["ckpt"][layout]
        assert got["step"] == R.CKPT_STEP
        assert list(got["leaves"]) == list(whole)
        for k, a in whole.items():
            want = _digest(_block(a, at[k], shape, got["coords"]))
            assert got["leaves"][k] == want, (rank, k)


@pytest.mark.parametrize("n,layout", CKPT_CASES)
def test_sharded_save_is_the_whole_save(n, layout):
    """The ranks' save of their shards (each sharded leaf gathered along
    its axes, the first rank writing) holds the same files, byte for
    byte, as this process's save of the whole state."""
    _world(n)
    step = f"step_{R.CKPT_STEP:08d}"
    want_dir = os.path.join(_ckpt_dir(), "whole", step)
    got_dir = os.path.join(_ckpt_dir(), f"saved_{n}_{layout}", step)
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    for f in os.listdir(want_dir):
        with open(os.path.join(want_dir, f), "rb") as a, \
                open(os.path.join(got_dir, f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("n", [2, 4])
def test_restore_without_shardings_is_the_whole_tree(n):
    want = {k: _digest(v.numpy()) for k, v in flatten(R.ckpt_tree())}
    for res in _world(n):
        assert res["ckpt"]["whole"] == want


@pytest.mark.parametrize("n,layout", CKPT_CASES)
def test_corrupt_leaf_raises_on_every_rank(n, layout):
    for rank, res in enumerate(_world(n)):
        msg = res["ckpt"][layout]["corrupt"]
        assert msg and f"leaf {CORRUPT_LEAF!r}: CRC32 mismatch" in msg, \
            (rank, msg)


@pytest.mark.parametrize("n,layout", CKPT_CASES)
def test_restore_latest_falls_back_together(n, layout):
    """Step 2 corrupt, step 1 whole: every rank fails step 2, they agree,
    the first rank alone quarantines it, and all restore step 1."""
    assert [r["ckpt"][layout]["fallback_step"] for r in _world(n)] == \
        [R.CKPT_STEP] * n
    d = os.path.join(_ckpt_dir(), f"fallback_{n}_{layout}")
    assert sorted(os.listdir(d)) == ["corrupt_step_00000002",
                                     f"step_{R.CKPT_STEP:08d}"]


@pytest.mark.parametrize("n", [2, 4])
def test_restore_latest_takes_the_first_ranks_steps(n):
    """Every rank but the first sees a newer committed step (as when it
    commits between the ranks' listings): all restore the first rank's
    newest step, and nothing is quarantined."""
    got = [r["ckpt"]["agreement"]["skew_step"] for r in _world(n)]
    assert got == [R.CKPT_STEP] * n
    d = os.path.join(_ckpt_dir(), f"skew_{n}")
    assert [sorted(os.listdir(os.path.join(d, f"rank{r}")))
            for r in range(n)] == \
        [["step_00000001"]] + [["step_00000001", "step_00000002"]] * (n - 1)


@pytest.mark.parametrize("n", [2, 4])
def test_error_on_one_rank_raises_on_every_rank(n):
    """Step 2's manifest is gone on the last rank alone: that rank's
    ``FileNotFoundError`` is raised there and named on every other rank,
    and no rank quarantines or falls back.  A bfloat16 leaf, which only
    the writing rank converts, fails the sharded save on every rank."""
    ranks = [r["ckpt"]["agreement"] for r in _world(n)]
    for rank, res in enumerate(ranks):
        msg = res["lost"]
        assert msg is not None, rank
        if rank == n - 1:
            assert msg.startswith("FileNotFoundError:"), msg
        else:
            assert msg.startswith("CheckpointError:"), msg
            assert f"failed on rank {n - 1}: FileNotFoundError" in msg, msg
        assert res["lost_steps"] == [1, 2], (rank, res["lost_steps"])
        want = ("TypeError: cannot checkpoint a torch.bfloat16 leaf"
                if rank == 0 else "CheckpointWriteError:")
        assert res["bf16"] is not None and res["bf16"].startswith(want), \
            (rank, res["bf16"])
        if rank:
            assert "failed on rank 0: TypeError" in res["bf16"], res["bf16"]
    assert not os.path.exists(os.path.join(_ckpt_dir(), f"bf16_{n}"))


# ---------------------------------------------------------------------------
# spawn's report of a world that fails
# ---------------------------------------------------------------------------

def test_spawn_reports_a_dead_ranks_stderr():
    """Rank 1 writes a line to its stderr and calls ``os._exit(255)``:
    ``spawn`` raises with its exit code and that line."""
    msg = _failure_future().result()
    assert msg is not None
    assert "rank 1 died (exit code 255); its stderr ends:" in msg, msg
    assert f"  | {R.DEATH_MARK}" in msg, msg


def test_spawn_reports_a_lost_result_and_a_crash_after_it():
    """Rank 0's result cannot be pickled: it exits 0 unheard, and the
    report carries the pickling error from its stderr.  Rank 2 sends its
    result and exits 255: the world fails all the same."""
    msg = _failure_future().result()
    assert msg is not None
    assert "rank 0 exited 0 but its result never arrived" in msg, msg
    assert "Can't" in msg and "lambda" in msg, msg
    assert "rank 2 died (exit code 255) after sending its result" in msg, \
        msg
