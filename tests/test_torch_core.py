"""Parity of the port's core (repro_torch.core) with the reference.

Same numpy inputs through ``repro.core`` (JAX on the CPU) and
``repro_torch.core`` (torch on the CPU).  Everything here is elementwise
grid arithmetic or integer counting, so every assertion is exact
equality: values, both overflow counts, mantissas, exponents.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed as jpacked
from repro.core import quant as jquant
from repro.core import scale as jscale
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.core.tape import QTape as JTape
from repro_torch.core import packed as tpacked
from repro_torch.core import quant as tquant
from repro_torch.core import scale as tscale
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.core.tape import QTape as TTape


def _values(seed, n=4096):
    """Random magnitudes over many binades, exact grid ties, and ±3e38."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-12, 12, n)))
    ties = (rng.integers(-600, 600, 512) + 0.5) * 2.0 ** -6   # k.5 * step
    big = np.array([3e38, -3e38, 0.0, -0.0, 1e-30, -1e-30])
    return np.concatenate([x, ties, big]).astype(np.float32)


@pytest.mark.parametrize("width", [8, 10, 12, 16])
@pytest.mark.parametrize("e", [-6.0, -2.0, 3.0])
def test_fixed_round_exact(width, e):
    x = _values(width)
    jy, (jo, joh) = jquant.fixed_round(jnp.asarray(x), width, jnp.float32(e))
    ty, (to, toh) = tquant.fixed_round(torch.from_numpy(x), width, e)
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    assert float(jo) == float(to) and float(joh) == float(toh)
    assert float(to) > 0      # the ±3e38 lanes overflow every width


@pytest.mark.parametrize("width", [8, 16])
def test_pack_and_overflow_counts_exact(width):
    x = _values(100 + width)
    e = np.float32(-5.0)
    jp = jpacked.pack(jnp.asarray(x), width, e)
    tp = tpacked.pack(torch.from_numpy(x), width, float(e))
    np.testing.assert_array_equal(np.asarray(jp.mantissa), tp.mantissa.numpy())
    assert str(tp.mantissa.dtype) == f"torch.int{8 if width == 8 else 16}"
    # integer mantissas incl. the asymmetric qmin, which is not overflow
    qmax, qmin = jpacked.qrange(width)
    with np.errstate(over="ignore"):           # the ±3e38 lanes → ±inf
        m = np.concatenate([np.round(x / 2.0 ** -5),
                            [qmin, qmax, qmin - 1, qmax + 1]]).astype(np.float32)
    mask = np.random.default_rng(width).random(m.shape) < 0.7
    for msk in (None, mask):
        jo = jpacked._overflow_counts(
            jnp.asarray(m), width, mask=None if msk is None else jnp.asarray(msk))
        to = tpacked._overflow_counts(
            torch.from_numpy(m), width,
            mask=None if msk is None else torch.from_numpy(msk))
        assert [float(a) for a in jo] == [float(a) for a in to]
    m2 = m[: 4096].reshape(8, 512)
    jo = jpacked._overflow_counts(jnp.asarray(m2), width, axes=(1,))
    to = tpacked._overflow_counts(torch.from_numpy(m2), width, axes=(1,))
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_pack_rows_exact():
    x = _values(7)[: 6 * 2 * 64].reshape(6, 2, 64) * 4.0
    e = np.array([-6, -4, -2, 0, 1, 3], np.float32)
    jm, js = jpacked.pack_rows(jnp.asarray(x), 8, jnp.asarray(e))
    tm, ts = tpacked.pack_rows(torch.from_numpy(x), 8, torch.from_numpy(e))
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


def _pow2_neighbours():
    xs = []
    for k in range(-70, 60):
        p = np.float32(2.0) ** k
        xs += [p, np.nextafter(p, np.float32(np.inf)),
               np.nextafter(p, np.float32(0))]
    return np.array(xs, np.float32)


@pytest.mark.parametrize("width", [4, 8, 10, 12, 16])
@pytest.mark.parametrize("margin", [0, 1])
def test_calibrate_exp_at_powers_of_two(width, margin):
    """``maxabs`` at powers of two and their float neighbours.  The port
    takes ``log2`` as ``log(x) / log(2)``, the formula ``jnp.log2`` lowers
    to; see ROADMAP queue 3 for the ratios where XLA's own log2 is off."""
    x = _pow2_neighbours()
    je = jscale.calibrate_exp(jnp.asarray(x), width, margin)
    te = tscale.calibrate_exp(torch.from_numpy(x), width, margin)
    np.testing.assert_array_equal(np.asarray(je), te.numpy())


def test_controller_step_per_slot_exact():
    rng = np.random.default_rng(3)
    B = 16
    e = rng.integers(-8, 2, B).astype(np.float32)
    total = rng.choice([0.0, 512.0, 4096.0], B).astype(np.float32)
    ovf = np.floor(total * rng.choice([0, 1e-5, 1e-3, 0.5], B))
    half = np.maximum(ovf, np.floor(total * rng.choice([0, 1e-5, 1e-2], B)))
    acc = np.stack([ovf, half, total], -1).astype(np.float32)
    apply = rng.random(B) < 0.6
    js = jscale.controller_step(
        jscale.ScaleState(exps={"k": jnp.asarray(e)}, acc={"k": jnp.asarray(acc)}),
        max_overflow_rate=1e-4, apply=jnp.asarray(apply))
    ts = tscale.controller_step(
        tscale.ScaleState(exps={"k": torch.from_numpy(e)},
                          acc={"k": torch.from_numpy(acc)}),
        max_overflow_rate=1e-4, apply=torch.from_numpy(apply))
    np.testing.assert_array_equal(np.asarray(js.exps["k"]), ts.exps["k"].numpy())
    np.testing.assert_array_equal(np.asarray(js.acc["k"]), ts.acc["k"].numpy())
    assert (ts.exps["k"].numpy() != e).any()     # some slot moved


def test_scale_state_create_and_accumulate_exact():
    shapes = {"a:x": (), "w:y": (3,)}
    stats = {"a:x": np.array([2.0, 5.0, 64.0], np.float32),
             "w:y": np.arange(9, dtype=np.float32).reshape(3, 3),
             "a:absent": np.ones(3, np.float32)}
    js = jscale.accumulate(jscale.ScaleState.create(shapes, -5.0),
                           {k: jnp.asarray(v) for k, v in stats.items()})
    ts = tscale.accumulate(tscale.ScaleState.create(shapes, -5.0),
                           {k: torch.from_numpy(v) for k, v in stats.items()})
    for d in ("exps", "acc"):
        jd, td = getattr(js, d), getattr(ts, d)
        assert set(jd) == set(td) == set(shapes)
        for k in jd:
            np.testing.assert_array_equal(np.asarray(jd[k]), td[k].numpy())


@pytest.mark.parametrize("arith", ["dfxp", "fixed", "float16", "bfloat16",
                                   "float8_e4m3", "observe"])
def test_qtape_act_exact(arith):
    x = _values(11)[:1024].reshape(4, 256) * 0.5
    jt = JTape(JPolicy(arith), {"a:s": jnp.float32(-4.0)}, {})
    tt = TTape(TPolicy(arith), {"a:s": torch.tensor(-4.0)})
    jy = jt.act("s", jnp.asarray(x))
    ty = tt.act("s", torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    assert set(jt.stats) == set(tt.stats)
    for k in jt.stats:
        np.testing.assert_array_equal(np.asarray(jt.stats[k]),
                                      tt.stats[k].numpy())


def test_qtape_weight_matches_ste_quant():
    w = _values(12)[:2048].reshape(32, 64) * 0.1
    jt = JTape(JPolicy("dfxp"), {"w:m": jnp.float32(-7.0)}, {})
    tt = TTape(TPolicy("dfxp"), {"w:m": torch.tensor(-7.0)})
    np.testing.assert_array_equal(np.asarray(jt.weight("m", jnp.asarray(w))),
                                  tt.weight("m", torch.from_numpy(w)).numpy())
    np.testing.assert_array_equal(np.asarray(jt.stats["w:m"]),
                                  tt.stats["w:m"].numpy())


def test_exact_pow2_range():
    e = np.arange(-126, 128, dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(jquant.exact_pow2(jnp.asarray(e))),
                                  tquant.exact_pow2(torch.from_numpy(e)).numpy())


def test_policy_validation_matches():
    for kw in (dict(arithmetic="nope"), dict(storage="x"),
               dict(prefill_chunk=-1),
               dict(arithmetic="dfxp", storage="packed", comp_width=12,
                    compute_dtype="bfloat16")):
        with pytest.raises(ValueError):
            JPolicy(**kw)
        with pytest.raises(ValueError):
            TPolicy(**kw)
