"""The ranks' side of ``tests/test_torch_serve_sharded.py``: the cases, the
port's sharded engines and the prompts both sides serve.

It imports torch and ``repro_torch`` only, never jax or the reference:
each spawned rank imports this module by name (``launch.mesh.spawn``).
"""
import contextlib
import dataclasses

import numpy as np

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import serve_pod_ctx
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.serve import EngineOptions, ServeEngine

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
    """Two prompts of ``length`` tokens: ``jax.random.randint`` under key
    1, drawn by the port's threefry (the same ints, bit for bit)."""
    return prng.randint(prng.PRNGKey(1), (2, length), 0,
                        cfg.vocab_size).numpy()


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
