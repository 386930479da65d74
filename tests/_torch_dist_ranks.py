"""The ranks' side of ``tests/test_torch_dist.py``: the inputs the ranks
and the reference share (numpy, from seeds) and every case a rank of its
worlds runs.

It imports torch and ``repro_torch`` only, never jax or the reference:
each spawned rank imports this module by name, so a rank starts without
the reference's import (``launch.mesh.spawn``).
"""
import hashlib
import os

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, LeafCorruptError,
                                    restore_tree, save_tree)
from repro_torch.checkpoint.manager import flatten, unflatten
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import DistCtx, ShardingRules, compress, cp_attention
from repro_torch.launch import mesh as M
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.optim.opt import sgd_init
from repro_torch.train.state import init_train_state


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


def _rank_plan(rank, mesh):
    """K3's split count selected on a bound mesh, each rank's (injected)
    timer preferring another plan, with every cache empty (``"empty"``),
    with a plan preloaded (as from a cache file) on every rank but the
    first (``"others"``) and on the first alone (``"first"``): for each,
    ``(splits, plans this rank timed, gathers, splits of a second call,
    gathers after it)``."""
    from repro_torch.kernels import dispatch
    timed, gathers = [], []

    def fake(run, plan):
        timed.append(plan)
        return 1.0 if plan[0] == 2 + rank else 2.0
    dispatch._time_plan = fake
    dispatch.save_autotune = lambda path=None: None
    gather = mesh.gather_list
    mesh.gather_list = lambda *a: gathers.append(a) or gather(*a)

    def select():
        return dispatch.attn_blocks_for(
            400, 4, 128, width=8, interpret=False, B=4, K=8,
            launch=lambda: ((torch.zeros(4),),
                            lambda scratch, x: (lambda plan: None)))
    out = {}
    try:
        with M.use_mesh(mesh):
            for case, preload in (("empty", ()),
                                  ("others", range(1, mesh.size)),
                                  ("first", (0,))):
                dispatch.reset_autotune()
                if rank in preload:
                    dispatch._BLOCK_CACHE[("attn", 32, 512, 4, 128, 8, 0)] = \
                        (3,)
                del timed[:], gathers[:]
                splits = select()
                n_gathers = len(gathers)
                out[case] = (splits, len(timed), n_gathers, select(),
                             len(gathers))
    finally:
        del mesh.gather_list
    return out


def _rank_cases(rank, n):
    out = {}
    mesh = M.BoundMesh((n,), ("d",))
    out["plan"] = _rank_plan(rank, mesh)
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


def _world_main(rank, n, ckpt_dir):
    torch.manual_seed(0)
    out = _rank_cases(rank, n)
    out["ckpt"] = _rank_ckpt(n, ckpt_dir)
    return out


# ---------------------------------------------------------------------------
# resharded checkpoints: the parent saves a whole train state, the ranks
# restore it under ShardingRules layouts and save their shards back
# ---------------------------------------------------------------------------

CKPT_ARCH = "granite_moe_1b"        # embed, head, attention and MoE banks
CKPT_MESHES = {2: {"tp": (1, 2), "fsdp": (2, 1)}, 4: {"tp_fsdp": (2, 2)}}
CKPT_STEP = 1


def ckpt_template():
    """The smoke state's structure on the meta device."""
    cfg = configs.get_smoke(CKPT_ARCH)
    p = T.init_params(cfg, 0, device="meta")
    return init_train_state(p, sgd_init(p), T.group_shapes(cfg),
                            PrecisionPolicy("dfxp"))


def ckpt_tree(seed=11):
    """The template's structure over numpy values drawn from ``seed``."""
    rs = np.random.RandomState(seed)
    leaves = []
    for _, x in flatten(ckpt_template()):
        shape = tuple(x.shape)
        if x.dtype == torch.float32:
            a = rs.standard_normal(shape).astype(np.float32)
        else:
            a = rs.randint(-100, 100, size=shape).astype(np.int32)
        leaves.append(torch.from_numpy(a))
    return unflatten(ckpt_template(), leaves)


def digest(tree) -> dict:
    """``{leaf name: (shape, dtype, sha256 of its bytes)}``."""
    return {n: (tuple(x.shape), str(x.dtype),
                hashlib.sha256(x.numpy().tobytes()).hexdigest())
            for n, x in flatten(tree)}


def _rank_ckpt(n, d):
    """Per mesh of ``CKPT_MESHES[n]``: this rank's coordinates, the
    digests of its restored shards (``restore_latest`` with shardings),
    its save of them (into ``saved_<n>_<layout>``), the error of a
    restore of the corrupt copy, and the step ``restore_latest`` falls
    back to past a corrupt newest step; without shardings, the digests of
    the whole restore."""
    tmpl = ckpt_template()
    whole = CheckpointManager(os.path.join(d, "whole"))
    out = {"whole": digest(whole.restore(tmpl, CKPT_STEP))}
    for name, shape in CKPT_MESHES[n].items():
        mesh = M.BoundMesh(shape, ("data", "model"))
        sh = ShardingRules(mesh).state_shardings(tmpl)
        res = {"coords": dict(mesh.coords)}
        with M.use_mesh(mesh):
            local, res["step"] = whole.restore_latest(tmpl, sh)
            res["leaves"] = digest(local)
            CheckpointManager(os.path.join(d, f"saved_{n}_{name}")).save(
                CKPT_STEP, local, sh)
            try:
                restore_tree(tmpl, os.path.join(
                    d, "corrupt", f"step_{CKPT_STEP:08d}"), sh)
                res["corrupt"] = None
            except LeafCorruptError as e:
                res["corrupt"] = str(e)
            fb = CheckpointManager(os.path.join(d, f"fallback_{n}_{name}"))
            res["fallback_step"] = fb.restore_latest(tmpl, sh)[1]
        out[name] = res
    out["agreement"] = _rank_agreement(n, d, tmpl, sh, mesh)
    return out


def _raised(fn):
    """``"<type>: <message>"`` of what ``fn()`` raised, else ``None``."""
    try:
        fn()
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    return None


def _rank_agreement(n, d, tmpl, sh, mesh):
    """The collective save and restore where the ranks see different
    things, on the last layout's mesh: each rank's ``restore_latest``
    step from a directory of its own in which every rank but the first
    has a newer step (``skew_<n>/rank<r>``); what each rank raised where
    the newest step's manifest is gone on the last rank alone
    (``lost_<n>/rank<r>``), and what each raised on a save whose first
    leaf is a dtype only the writer rejects (bfloat16)."""
    rank = mesh.rank
    res = {}
    with M.use_mesh(mesh):
        skew = CheckpointManager(os.path.join(d, f"skew_{n}", f"rank{rank}"))
        res["skew_step"] = skew.restore_latest(tmpl, sh)[1]
        lost = CheckpointManager(os.path.join(d, f"lost_{n}", f"rank{rank}"))
        res["lost"] = _raised(lambda: lost.restore_latest(tmpl, sh))
        res["lost_steps"] = lost.all_steps()
        mesh1 = M.BoundMesh((n,), ("d",))
    with M.use_mesh(mesh1):
        tree = {"a": torch.zeros(3, dtype=torch.bfloat16),
                "b": torch.full((2, 5), float(rank))}
        res["bf16"] = _raised(lambda: save_tree(
            tree, os.path.join(d, f"bf16_{n}"),
            shardings={"a": (None,), "b": ("d", None)}))
    return res


# ---------------------------------------------------------------------------
# worlds that fail, for the report of launch.mesh.spawn
# ---------------------------------------------------------------------------

DEATH_MARK = "rank 1 exits 255 here"


def failing_world(rank):
    """A world of 3 in which no rank finishes cleanly: rank 0 returns a
    result the queue cannot pickle (it exits 0, its message never reaches
    the parent); rank 1 writes a line to its stderr and dies with exit
    code 255; rank 2 sends its result, then exits 255 on its way out."""
    import sys
    if rank == 0:
        return lambda: rank
    if rank == 1:
        print(DEATH_MARK, file=sys.stderr, flush=True)
        os._exit(255)
    import atexit
    atexit.register(os._exit, 255)
    return rank
