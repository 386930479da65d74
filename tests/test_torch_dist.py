"""``repro_torch.dist`` and ``repro_torch.launch.mesh`` against ``repro.dist``.

The reference's collectives run under ``jax.vmap(..., axis_name=...)`` in
this process; the port's run in worlds of ranks spawned once per world
size (gloo on the CPU, one torch thread a rank, a ``file://`` rendezvous
in a fresh directory, a timeout on every collective), each rank running
every case of this module and returning its results.

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
  (``repro_torch.launch.dryrun.experts`` and ``cp_merge``).
"""
import dataclasses
import functools
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
from repro_torch import configs
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import (DistCtx, MeshConfigError, ShardingRules,
                              compress, context, cp_attention)
from repro_torch.dist.sharding import leaves_with_path
from repro_torch.launch import mesh as M
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.optim.opt import sgd_init
from repro_torch.serve.kv_pool import make_kv_pool
from repro_torch.train.state import init_train_state

TIMEOUT = 120.0


# ---------------------------------------------------------------------------
# inputs shared by the ranks and the reference (numpy, from seeds)
# ---------------------------------------------------------------------------

def _grads(n_ranks):
    rs = np.random.RandomState(0)
    g = rs.standard_normal((n_ranks, 8, 33)).astype(np.float32) * 1e-3
    r = rs.standard_normal((n_ranks, 8, 33)).astype(np.float32) * 1e-5
    return g, r


def _a2a(n_ranks):
    rs = np.random.RandomState(1)
    x = rs.standard_normal((n_ranks, 8, 6, 5)).astype(np.float32)
    ct = rs.standard_normal((n_ranks, 2, 24, 5)).astype(np.float32)
    return x, ct


def _cp_inputs():
    rs = np.random.RandomState(2)
    B, W, H, K, hd = 2, 64, 4, 2, 16
    q = rs.standard_normal((B, 1, H, hd)).astype(np.float32)
    ck = rs.standard_normal((B, W, K, hd)).astype(np.float32)
    cv = rs.standard_normal((B, W, K, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(W, dtype=np.int32), (B, W)).copy()
    pos[:, -3:] = -1                     # some empty slots
    pos[1, :20] = -1                     # a shard that is nearly empty
    q_pos = np.full((B, 1), 40, np.int32)
    return q, ck, cv, pos, q_pos, dict(num_heads=H, num_kv_heads=K,
                                       head_dim=hd)


MOE_SPEC = dict(d_model=32, d_ff=16, num_experts=8, top_k=2,
                capacity_factor=8.0)     # dropless, for exactness


def _moe_inputs():
    rs = np.random.RandomState(3)
    E, D, F = 8, 32, 16
    params = {
        "router": rs.standard_normal((D, E)).astype(np.float32) * 0.2,
        "w_gate": rs.standard_normal((E, D, F)).astype(np.float32) / 6,
        "w_up": rs.standard_normal((E, D, F)).astype(np.float32) / 6,
        "w_down": rs.standard_normal((E, F, D)).astype(np.float32) / 4,
    }
    x = rs.standard_normal((4, 8, D)).astype(np.float32)
    return params, x


A2A_SCALES = {"a:moe/dispatch": -4.0, "a:moe/expert_out": -4.0}

MOE_DISTS = {
    "ep": DistCtx(token_axes=("data",), ep_axis="model",
                  all_axes=("data", "model")),
    "ep_fsdp": DistCtx(token_axes=("data",), ep_axis="model",
                       fsdp_axis="data", all_axes=("data", "model")),
    "stationary": DistCtx(ep_axis="model", fsdp_axis="data",
                          all_axes=("data", "model"), moe_stationary=True),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_moe(params, x, dist, policy, dropless, scales=None):
    from repro_torch.core.tape import QTape
    tape = QTape(policy, dict(scales or {}), {})
    y = moe.moe_ffn({k: _t(v) for k, v in params.items()},
                    moe.MoESpec(**MOE_SPEC), _t(x), tape, "moe", dist,
                    dropless=dropless)
    return y.numpy()


# ---------------------------------------------------------------------------
# the ranks' side: every case of the module in one world
# ---------------------------------------------------------------------------

_KINDS = {"psum": "all-reduce", "pmax": "all-reduce",
          "all_gather": "all-gather", "all_to_all": "all-to-all"}


def _count_collectives(mesh) -> list:
    """Wrap ``mesh``'s collectives so each call appends ``(kind, output
    bytes)`` to the returned log (a psum or pmax counts its result, as an
    all-reduce's output, though gloo gathers the ranks' copies to form
    it)."""
    log = []
    for name, kind in _KINDS.items():
        def counted(*a, _f=getattr(mesh, name), _k=kind, **kw):
            out = _f(*a, **kw)
            log.append((_k, out.numel() * out.element_size()))
            return out
        setattr(mesh, name, counted)
    return log


def _rank_cases(rank, n):
    out = {}
    mesh = M.BoundMesh((n,), ("d",))
    # the compressed all-reduce and tree, with an axis
    g, r = _grads(n)
    gh, rn = compress.compress_decompress(_t(g[rank]), _t(r[rank]), 8, "d",
                                          mesh=mesh)
    out["cd"] = (gh.numpy(), rn.numpy())
    tg = {"w": _t(g[rank]), "b": _t(g[rank][0] * 1e-3)}
    tr = {"w": _t(r[rank]), "b": _t(r[rank][0])}
    gh, rn = compress.compress_tree(tg, tr, 16, "d", mesh=mesh)
    out["tree"] = ({k: v.numpy() for k, v in gh.items()},
                   {k: v.numpy() for k, v in rn.items()})
    # the compressed all_to_all, forward and backward
    x, ct = _a2a(n)
    xt = _t(x[rank]).requires_grad_(True)
    e = torch.tensor(-3.0, requires_grad=True)
    y = compress.compressed_all_to_all(xt, e, 8, "d", split_axis=0,
                                       concat_axis=1, mesh=mesh)
    c = _t(ct[rank].reshape(y.shape))
    gx, ge = torch.autograd.grad((y * c).sum(), (xt, e))
    out["a2a"] = (y.detach().numpy(), gx.numpy(), float(ge))
    # CP decode attention over the world's window shards
    q, ck, cv, pos, q_pos, kw = _cp_inputs()
    log = _count_collectives(mesh)
    with M.use_mesh(mesh):
        out["cp"] = cp_attention.cp_decode_attention(
            _t(q), _t(ck), _t(cv), _t(pos), _t(q_pos), cp_axes=("d",),
            **kw).numpy()
        out["cp_collectives"] = list(log)
        Wl = ck.shape[1] // n
        sl = slice(rank * Wl, (rank + 1) * Wl)
        out["cp_local"] = cp_attention.cp_decode_attention(
            _t(q), _t(ck[:, sl]), _t(cv[:, sl]), _t(pos[:, sl]), _t(q_pos),
            cp_axes=("d",), local=True, **kw).numpy()
    if n == 4:
        mesh2 = M.BoundMesh((2, 2), ("data", "model"))
        out["coords"] = dict(mesh2.coords)
        params, xm = _moe_inputs()
        pol = PrecisionPolicy("float32")
        log = _count_collectives(mesh2)
        with M.use_mesh(mesh2):
            for name, dist in MOE_DISTS.items():
                dropless = name == "stationary"
                del log[:]
                out[f"moe_{name}"] = _port_moe(params, xm, dist, pol,
                                               dropless)
                out[f"moe_{name}_collectives"] = list(log)
            del log[:]
            out["moe_int8"] = _port_moe(
                params, xm, MOE_DISTS["ep"],
                PrecisionPolicy("float32", a2a_compress_bits=8), False,
                A2A_SCALES)
            out["moe_int8_collectives"] = list(log)
    return out


def _world_main(rank, n):
    torch.manual_seed(0)
    return _rank_cases(rank, n)


_LAUNCHER = ThreadPoolExecutor(max_workers=2)


@functools.lru_cache(maxsize=None)
def _world_future(n):
    """The world of ``n`` ranks, started once, in the background: the
    reference's side of the tests runs here meanwhile."""
    return _LAUNCHER.submit(M.spawn, _world_main, n, n, threads=1,
                            timeout_s=TIMEOUT)


def _world(n):
    return _world_future(n).result()


@pytest.fixture(scope="module", autouse=True)
def _start_worlds():
    for n in (2, 4):
        _world_future(n)
    yield


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
