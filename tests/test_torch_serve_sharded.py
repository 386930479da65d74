"""Sharded serving in ``repro_torch``: the port's sharded engines against
the reference's unsharded ones, greedy token for token.

Mirrors ``tests/test_serve_sharded.py``'s multi-device cases: TP = 2 over
f32 and int8 pools, fused and unfused; TP = 4 on a 4-kv-head model; TP = 2
over the paged pool; CP = 2 and 4 on long-context slots, with a chunked
int8 pool; an engine given only the mesh; granite-moe-1b's
expert-parallel MoE under TP = 2; and the serve CLI's ``--tp 2``, which
spawns its own world.  The CP = 2 engine's merges are counted on its mesh
and held to the dry run's implied CP collectives.  The port's engines run in one spawned gloo world
of 4 ranks (a 2-rank mesh holds two replicas of it), every rank checking
that all ranks sampled the same tokens; the reference's run here, on one
device.
"""
import contextlib
import dataclasses
import functools
import io
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from repro import configs as rconfigs
from repro.core.policy import PrecisionPolicy as RPolicy
from repro.models import transformer as RT
from repro.serve import EngineOptions as REngineOptions
from repro.serve import ServeEngine as RServeEngine
from repro_torch import configs
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import serve_pod_ctx
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.serve import EngineOptions, ServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (arch, kv heads, prompt len, max_len, fused, opts, tp, cp, mesh only)
CASES = {
    "tp2_f32": ("llama3_8b", 0, 8, 24, False, {}, 2, 1, False),
    "tp2_f32_fused": ("llama3_8b", 0, 8, 24, True, {}, 2, 1, False),
    "tp2_int8": ("llama3_8b", 0, 8, 24, False, {"cache_bits": 8}, 2, 1,
                 False),
    "tp2_int8_fused": ("llama3_8b", 0, 8, 24, True, {"cache_bits": 8}, 2, 1,
                       False),
    "tp4_f32": ("llama3_8b", 4, 8, 24, False, {}, 4, 1, False),
    "tp4_int8_fused": ("llama3_8b", 4, 8, 24, True, {"cache_bits": 8}, 4, 1,
                       False),
    "tp2_int8_paged": ("llama3_8b", 0, 8, 24, True,
                       {"cache_bits": 8, "page_size": 8}, 2, 1, False),
    "cp2_f32": ("llama3_8b", 0, 40, 64, False, {}, 1, 2, False),
    "cp2_int8_chunked": ("llama3_8b", 0, 40, 64, False,
                         {"cache_bits": 8, "prefill_chunk": 16}, 1, 2, False),
    "cp4_f32": ("llama3_8b", 0, 40, 64, False, {}, 1, 4, False),
    "mesh_only_tp2": ("llama3_8b", 0, 8, 24, False, {}, 2, 1, True),
    "granite_tp2": ("granite_moe_1b", 0, 8, 24, False, {}, 2, 1, False),
}


def _cfg(pkg, arch, kv):
    cfg = pkg.get_smoke(arch)
    return dataclasses.replace(cfg, num_kv_heads=kv) if kv else cfg


def _prompts(cfg, length):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, length),
                                         0, cfg.vocab_size))


def _wave(eng, prompts, max_new=8):
    uids = [eng.submit(p, max_new=max_new) for p in prompts]
    out = eng.run()
    return [np.asarray(out[u]) for u in uids]


@contextlib.contextmanager
def _merge_collectives(mesh, merges: list):
    """Each CP merge's collectives on ``mesh``, ``[(kind, output
    bytes)]`` a merge, appended to ``merges`` (the mesh's psum and pmax
    counted at their results, as an all-reduce's output)."""
    from repro_torch.dist import cp_attention
    log = []
    for name in ("psum", "pmax"):
        def counted(*a, _f=getattr(mesh, name), **kw):
            out = _f(*a, **kw)
            log.append(("all-reduce", out.numel() * out.element_size()))
            return out
        setattr(mesh, name, counted)
    merge = cp_attention._merge

    def counted_merge(*a, **kw):
        del log[:]
        out = merge(*a, **kw)
        merges.append(list(log))
        return out
    cp_attention._merge = counted_merge
    try:
        yield
    finally:
        cp_attention._merge = merge


def _port_case(name, merges=None):
    arch, kv, L, max_len, fused, opts, tp, cp, mesh_only = CASES[name]
    cfg = _cfg(configs, arch, kv)
    params = T.init_params(cfg, 0, device="cpu")
    mesh = M.make_serve_mesh(tp=tp, cp=cp)
    kw = dict(mesh=mesh) if mesh_only else dict(
        dist=serve_pod_ctx(tp=tp, cp=cp), mesh=mesh)
    eng = ServeEngine(cfg, PrecisionPolicy("float32", fused_decode=fused),
                      params, max_slots=2, max_len=max_len,
                      options=EngineOptions(**opts), device="cpu", **kw)
    assert eng.dist.active and (tp == 1 or "model" in eng.dist.all_axes)
    heads = [e["k"].shape[3] if "k" in e else e["k_m"].shape[3]
             for sc in eng.kv.pool.values() for e in sc.values()
             if "pos" in e]
    with (_merge_collectives(mesh, merges) if merges is not None
          else contextlib.nullcontext()):
        return _wave(eng, _prompts(cfg, L)), heads


def _deadline_case():
    """TP = 2 with deadlines: the scheduler's clock (a host tensor) is
    gathered over the mesh, so every rank expires the same requests;
    without a deadline no step reads it."""
    cfg = _cfg(configs, "llama3_8b", 0)
    params = T.init_params(cfg, 0, device="cpu")
    mesh = M.make_serve_mesh(tp=2)
    out = {}
    for name, dl in (("none", None), ("far", 6e5), ("past", 0.0)):
        eng = ServeEngine(cfg, PrecisionPolicy("float32"), params,
                          max_slots=2, max_len=24, device="cpu",
                          dist=serve_pod_ctx(tp=2), mesh=mesh)
        reads, now = [], eng._now
        eng._now = lambda: reads.append(1) or now()
        uids = [eng.submit(p, max_new=8, deadline_ms=dl)
                for p in _prompts(cfg, 8)]
        at_submit = len(reads)
        eng.run()
        out[name] = ([eng.status(u).value for u in uids],
                     [np.asarray(eng.results[u]) for u in uids],
                     len(reads) - at_submit)
    return out


def _world_main(rank):
    merges = []
    out = {name: _port_case(name, merges if name == "cp2_f32" else None)
           for name in CASES}
    out["cp2_f32_merges"] = merges
    out["deadlines"] = _deadline_case()
    return out


_LAUNCHER = ThreadPoolExecutor(max_workers=1)


@functools.lru_cache(maxsize=None)
def _world_future():
    """The port's world, started once, in the background: the
    reference's engines run here meanwhile."""
    return _LAUNCHER.submit(M.spawn, _world_main, 4, threads=1,
                            timeout_s=240.0)


def _world():
    return _world_future().result()


@pytest.fixture(scope="module", autouse=True)
def _start_world():
    _world_future()
    yield


@functools.lru_cache(maxsize=None)
def _reference(arch, kv, L, max_len, opts):
    cfg = _cfg(rconfigs, arch, kv)
    params = RT.init_params(cfg, jax.random.PRNGKey(0))
    eng = RServeEngine(cfg, RPolicy("float32"), params, max_slots=2,
                       max_len=max_len, options=REngineOptions(**dict(opts)))
    return _wave(eng, _prompts(cfg, L))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_tokens_match_reference(name):
    arch, kv, L, max_len, fused, opts, tp, cp, _ = CASES[name]
    want = _reference(arch, kv, L, max_len, tuple(sorted(opts.items())))
    K = (kv or configs.get_smoke(arch).num_kv_heads)
    for rank, res in enumerate(_world()):
        got, heads = res[name]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g, err_msg=f"{name} rank {rank}")
        assert set(heads) == {K // tp if K % tp == 0 else K}


def test_cp_merge_bytes_match_dryrun_rule():
    """The ``cp2_f32`` engine's CP merges (2 slots, the window over a
    1×2 mesh): each merge's collectives are the dry run's ``cp_merge``,
    and a decode step's, one merge a layer, its ``long_context`` bytes
    for the same decode cell on the same mesh."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.dist import ShardingRules
    from repro_torch.launch import dryrun
    cfg = configs.get_smoke("llama3_8b")
    merge = sorted((k, b) for k, b, c in dryrun.cp_merge(
        2, cfg.num_heads, cfg.head_dim) for _ in range(c))
    mesh = M.AbstractMesh((2, 1), ("data", "model"))
    cell = dryrun.make_cell(
        cfg, ShapeSpec("cp2_f32", CASES["cp2_f32"][3], 2, "decode"),
        PrecisionPolicy("float32"), mesh,
        ShardingRules(mesh, shard_batch=False, seq_shard_cache=True),
        serve_pod_ctx(cp=2))
    step = dryrun.implied_collectives(cell)["by_rule"]["long_context"]
    for rank, res in enumerate(_world()):
        merges = res["cp2_f32_merges"]
        assert merges and len(merges) % cfg.num_layers == 0, rank
        assert all(sorted(m) == merge for m in merges), rank
        assert step == sum(b for m in merges[:cfg.num_layers]
                           for _, b in m)


def test_sharded_deadlines_expire_alike_on_every_rank():
    want = _reference("llama3_8b", 0, 8, 24, ())
    for rank, res in enumerate(_world()):
        got = res["deadlines"]
        statuses, _, reads = got["none"]
        assert statuses == ["ok", "ok"] and reads == 0, rank
        statuses, toks, reads = got["far"]
        assert statuses == ["ok", "ok"] and reads > 0, rank
        for w, g in zip(want, toks):
            np.testing.assert_array_equal(w, g, err_msg=f"rank {rank}")
        statuses, toks, _ = got["past"]
        assert statuses == ["timed_out", "timed_out"], rank
        assert all(t.size == 0 for t in toks), rank


def test_cli_tp2_tokens_match_reference():
    argv = ["--smoke", "--num-requests", "3", "--slots", "2",
            "--prompt-len", "6,10", "--max-new", "4"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("WORLD_SIZE", None)
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve",
                             "--tp", "2", "--device", "cpu", *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)
    try:
        # the reference CLI's own run of the same argv, on one device,
        # while the port's ranks run
        from repro.launch import serve as rserve
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rserve.main(argv)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out + err
    assert "spawning 2 ranks (gloo" in out
    assert "model=2 (tp)" in out
    sample = [ln for ln in out.splitlines() if ln.startswith("sample:")]
    assert len(sample) == 1                  # rank 0 prints, rank 1 not
    want = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("sample:")]
    assert sample == want
