"""One DFXP 10/12 train step of the token-in families against the
reference, on the CPU: the case of ``test_torch_families.py`` (whose
docstring states what is held and how closely) under DFXP, in a file of
its own so that the suite's workers share the reference's compile time;
and calibration's initial exponents for the MoE and the hybrid family,
exactly equal.

The step runs for the families whose DFXP numerics no other test holds:
granite and llama4 (MoE: top-8, and top-1 with a shared expert every
2nd layer), mamba2 (SSM) and gemma3 (windows, qk-norm, a ``dec_tail``).
Dense DFXP steps are held by ``test_torch_lm_train.py`` (llama3-smoke;
phi3-smoke is the same config, qwen3's qk-norm is gemma3's), and
zamba2's shared blocks by its calibration below and its float32 step
(the reference's DFXP step of zamba2 is the slowest of all to compile).
"""
import pytest
import torch

from test_torch_families import train_step_case

DFXP_ARCHS = ("gemma3_27b", "llama4_maverick_400b", "granite_moe_1b",
              "mamba2_370m")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", DFXP_ARCHS)
def test_dfxp_train_step_matches_reference(arch):
    train_step_case(arch, "dfxp")


@pytest.mark.parametrize("arch", ["granite_moe_1b", "zamba2_1p2b"])
def test_calibrate_exponents_match_reference(arch):
    """Two observe steps (paper §9.3) from the same weights and data: the
    initial exponents of every group exactly equal — the MoE sites'
    (dispatch, expert banks) and zamba2's shared blocks', whose
    statistics are summed over their repetitions in both packages."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    from repro.core.policy import PrecisionPolicy as JPolicy
    from repro.data import synthetic as jdata
    from repro.models import transformer as JT
    from repro.optim import opt as jopt
    from repro.train.calibrate import calibrate as j_calibrate
    from repro_torch.core.policy import PrecisionPolicy as TPolicy
    from repro_torch.models import transformer as TT
    from repro_torch.optim import opt as topt
    from repro_torch.train.calibrate import calibrate as t_calibrate
    from test_torch_families import B, OPT, S, _cfgs, _params

    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    gs = JT.group_shapes(jcfg)
    jobs = dataclasses.replace(JPolicy("dfxp"), arithmetic="observe")
    tobs = dataclasses.replace(TPolicy("dfxp"), arithmetic="observe")
    batches = [jdata.SyntheticLM(jcfg.vocab_size, S, B, seed=0).batch(i)
               for i in range(2)]
    je = j_calibrate(
        lambda p, b, s, e: JT.loss_fn(jcfg, jobs, p, b, e, s), jp, gs,
        JPolicy("dfxp"), jopt.OptConfig(**OPT),
        ({k: jnp.asarray(v) for k, v in b.items()} for b in batches),
        steps=2)
    te = t_calibrate(
        lambda p, b, s, e: TT.loss_fn(tcfg, tobs, p, b, e, s), tp, gs,
        TPolicy("dfxp"), topt.OptConfig(**OPT),
        ({k: torch.from_numpy(v) for k, v in b.items()} for b in batches),
        steps=2)
    assert set(je) == set(te)
    shared = [k for k, s in gs.items() if s == () and "/" in k
              and k.split(":", 1)[1].startswith("dec/")]
    assert bool(shared) == (arch == "zamba2_1p2b")
    for k in je:
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]),
                                      err_msg=k)
