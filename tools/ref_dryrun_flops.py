"""The reference's matrix-product flops of the dry run's smoke programs:
what ``tests/test_torch_dryrun.py`` holds the port's counter to.  The
tests compile every case live, in spawned processes beside the port's
traces; this script prints the same counts for reading::

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/ref_dryrun_flops.py

Each case compiles one of the reference's programs at smoke size (B = 2,
S = 32, ``ce_chunk`` 16) on one CPU device and reads
``benchmarks.hlo_cost.analyze_text(...)["flops"]`` of the compiled HLO:
the dry run's prefill or serve step; for ``train_<remat>`` the value and
gradients of ``loss_fn(remat, ce_chunk)`` with its statistics (every
matrix product of the train step: its optimizer and controller multiply
none); for ``train_<remat>_mb<n>`` the whole train step of
``make_train_step(..., microbatches=n)``, whose ``lax.scan`` over the
microbatches ``hlo_cost`` counts by its known trip count.

The compiles run XLA's LLVM back end unoptimized (:data:`FAST_BACKEND`):
``hlo_cost`` reads the optimized HLO, which the back end's options do not
change (XLA's default options give the same count in every case, at
twice the compile's CPU time; ``compiler_options=None`` asks for them).
"""
import sys

B, S, CE = 2, 32, 16
ARCHS = ("llama3_8b", "granite_moe_1b", "mamba2_370m", "seamless_m4t_medium",
         "qwen2_vl_72b")
KINDS = ("train_none", "train_full", "prefill", "decode")
CASES = [(a, k, "float32") for a in ARCHS for k in KINDS] + [
    ("llama3_8b", "train_full", "dfxp")]
MICROBATCHED = [("llama3_8b", "train_none_mb2", "float32"),
                ("granite_moe_1b", "train_full_mb2", "float32")]
FAST_BACKEND = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def policy(cls, arith):
    if arith == "dfxp":
        return cls("dfxp", comp_width=10, update_width=12,
                   update_interval=100)
    return cls("float32")


def parse(case: str):
    """``(kind, remat, microbatches)`` of a case name."""
    parts = case.split("_")
    remat = parts[1] if parts[0] == "train" else "none"
    mb = int(parts[2][2:]) if len(parts) > 2 else 1
    return parts[0], remat, mb


def ref_flops(arch, case, arith, compiler_options=FAST_BACKEND) -> float:
    """``hlo_cost`` flops of the reference's compiled program for one
    case."""
    import jax
    import jax.numpy as jnp

    from benchmarks.hlo_cost import analyze_text
    from repro import configs
    from repro.configs import shapes
    from repro.core.policy import PrecisionPolicy
    from repro.models import transformer as T
    from repro.optim.opt import OptConfig, sgd_init
    from repro.train import init_train_state, make_train_step
    cfg = configs.get_smoke(arch)
    pol = policy(PrecisionPolicy, arith)
    gs = T.group_shapes(cfg)
    kind, remat, mb = parse(case)
    specs = shapes.input_specs(cfg, shapes.ShapeSpec("smoke", S, B, kind))
    params = jax.eval_shape(lambda: T.init_params(cfg,
                                                  jax.random.PRNGKey(0)))
    exps = {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in gs.items()}

    def sinks():
        return {n: jnp.zeros(s + (3,), jnp.float32) for n, s in gs.items()
                if n.startswith("g:")}

    def loss(p, b, s, e):
        return T.loss_fn(cfg, pol, p, b, e, s, remat=remat, ce_chunk=CE)

    if kind == "train" and mb > 1:
        step = make_train_step(loss, gs, pol,
                               OptConfig(kind="sgd", lr=0.01,
                                         lr_decay_steps=100_000),
                               microbatches=mb)

        def make_state():
            p = T.init_params(cfg, jax.random.PRNGKey(0))
            return init_train_state(p, sgd_init(p), gs, pol, init_exp=-8.0)
        state = jax.eval_shape(make_state)
        lowered = jax.jit(step).lower(
            state, specs["batch"], jax.ShapeDtypeStruct((2,), jnp.uint32))
    elif kind == "train":
        sk = {n: jax.ShapeDtypeStruct(s + (3,), jnp.float32)
              for n, s in gs.items() if n.startswith("g:")}
        lowered = jax.jit(jax.value_and_grad(loss, argnums=(0, 2),
                                             has_aux=True)).lower(
            params, specs["batch"], sk, exps)
    elif kind == "prefill":
        def prefill(p, batch, e):
            logits, _, cache = T.forward(cfg, pol, p, batch, e, sinks(),
                                         mode="prefill", max_cache_len=S)
            return logits[:, -1, :], cache
        lowered = jax.jit(prefill).lower(params, specs["batch"], exps)
    else:
        def serve(p, cache, tok, pos, e):
            logits, _, cache2 = T.decode_step(cfg, pol, p, cache, tok, pos,
                                              e, sinks())
            return logits, cache2
        lowered = jax.jit(serve).lower(params, specs["cache"],
                                       specs["tokens"], specs["pos"], exps)
    compiled = lowered.compile(compiler_options=compiler_options)
    return analyze_text(compiled.as_text())["flops"]


def main():
    for c in CASES + MICROBATCHED:
        print(f"{c!r}: {int(ref_flops(*c)):_}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
