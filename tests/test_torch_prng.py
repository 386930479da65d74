"""The port's threefry PRNG (repro_torch.core.prng) against ``jax.random``.

Same keys through ``jax.random`` on the installed jax (the CPU backend)
and through the port (torch on the CPU):

* keys, ``split``, ``fold_in``, raw bits, ``uniform`` and ``bernoulli``:
  bit for bit, for single keys and batches of keys (the reference's
  ``vmap`` over them);
* ``normal`` and ``gumbel`` (each evaluates XLA's float32
  approximations): bit for bit;
* ``categorical``: the same indices.

The port implements jax's partitionable threefry scheme only; the first
test pins that the installed jax runs it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SHAPES = [(), (1,), (3,), (5, 7), (2, 3, 129), (300, 257)]   # last > 2**16


def _t(key):
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps (ordered-integer difference)."""
    def ordered(x):
        i = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def test_installed_jax_runs_the_partitionable_scheme():
    assert jax.config.jax_threefry_partitionable, (
        "repro_torch.core.prng implements jax's partitionable threefry "
        "(jax_threefry_partitionable=True, jax 0.9.0's default); this jax "
        "runs the original scheme, so its draws differ from the port's")


def test_known_values():
    """``split(PRNGKey(0))`` and ``fold_in(PRNGKey(0), 3)`` as jax 0.9.0
    gives them (the values ROADMAP quotes for a check by eye)."""
    assert prng.split(prng.PRNGKey(0)).tolist() == [
        [1797259609, 2579123966], [928981903, 3453687069]]
    assert prng.fold_in(prng.PRNGKey(0), 3).tolist() == [2467461003,
                                                         3840466878]


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1,
                                  2 ** 40 + 5, -1, -5, 2 ** 63 - 1])
def test_prng_key_exact(seed):
    assert prng.PRNGKey(seed).tolist() == np.asarray(
        jax.random.PRNGKey(seed)).astype(np.int64).tolist()


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_split_exact(n):
    for seed in (0, 42, 2 ** 32 - 1):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(key, n)).astype(np.int64),
            prng.split(_t(key), n).numpy())


@pytest.mark.parametrize("data", [0, 3, 2 ** 31 - 1, 2 ** 32 - 1])
def test_fold_in_exact(data):
    key = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(
        np.asarray(jax.random.fold_in(key, data)).astype(np.int64),
        prng.fold_in(_t(key), data).numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_exact(shape):
    key = jax.random.PRNGKey(42)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64),
        prng.random_bits(_t(key), shape).numpy())
    for lo, hi in ((0.0, 1.0), (-2.5, 3.0)):
        ju = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))
        tu = prng.uniform(_t(key), shape, lo, hi).numpy()
        assert tu.dtype == np.float32 and tu.shape == ju.shape
        np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))


def test_batched_keys_exact():
    """``[B, 2]`` keys: the reference's ``vmap`` over them, row by row."""
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    tk = _t(keys)
    shape = (3, 17)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys)
                   ).astype(np.int64), prng.split(tk, 3).numpy())
    pos = np.array([0, 9, 2 ** 31 - 1, 123456], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jax.random.fold_in)(keys, pos)).astype(np.int64),
        prng.fold_in(tk, torch.from_numpy(pos)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jax.random.fold_in, (0, None))(keys, 2 ** 31 - 1)
                   ).astype(np.int64),
        prng.fold_in(tk, 2 ** 31 - 1).numpy())
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))
    np.testing.assert_array_equal(ju, prng.uniform(tk, shape).numpy())
    jb = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, 0.3, shape))(
        keys))
    np.testing.assert_array_equal(jb, prng.bernoulli(tk, 0.3, shape).numpy())


@pytest.mark.parametrize("p", [0.8, 0.5, 0.01])
def test_bernoulli_exact(p):
    key = jax.random.PRNGKey(3)
    shape = (64, 784)
    jb = np.asarray(jax.random.bernoulli(key, p, shape))
    tb = prng.bernoulli(_t(key), p, shape).numpy()
    np.testing.assert_array_equal(jb, tb)


def test_normal_within_tolerance():
    key = jax.random.PRNGKey(0)
    shape = (400_000,)                     # reaches the |u| > 0.9968 tail
    jn = np.asarray(jax.random.normal(key, shape))
    tn = prng.normal(_t(key), shape).numpy()
    d = _ulps(jn, tn)
    assert d.max() == 0, (d.max(), int((d > 0).sum()))
    # the reference's maxout init: normal / sqrt(fan_in) on a weight shape
    jw = np.asarray(jax.random.normal(key, (784, 1200)) / math.sqrt(784))
    tw = (prng.normal(_t(key), (784, 1200)) / math.sqrt(784)).numpy()
    np.testing.assert_array_equal(jw, tw)


def test_sqrt_rounds_correctly_whatever_root_it_starts_from(monkeypatch):
    """``erfinv``'s square root is the correctly rounded float32 one
    (numpy's), also when the library root it refines is off by 3e-4."""
    w = np.linspace(0.0, 60.0, 300_001, dtype=np.float32)
    w = np.concatenate([w, np.float32([1e-30, 1.17e-38, np.inf])])
    want = np.sqrt(w)
    np.testing.assert_array_equal(prng._sqrt(torch.from_numpy(w)).numpy(),
                                  want)
    true_sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: true_sqrt(x) * (1.0 + 3e-4 * torch.sign(
                            torch.sin(1e3 * x))))
    np.testing.assert_array_equal(prng._sqrt(torch.from_numpy(w)).numpy(),
                                  want)


def test_gumbel_within_tolerance_and_categorical_equal():
    key = jax.random.PRNGKey(9)
    shape = (200_000,)
    jg = np.asarray(jax.random.gumbel(key, shape))
    tg = prng.gumbel(_t(key), shape).numpy()
    np.testing.assert_array_equal(jg, tg)
    rng = np.random.default_rng(0)
    logits = (3.0 * rng.standard_normal((8, 1000))).astype(np.float32)
    keys = jax.random.split(key, 8)
    jc = np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                     jnp.asarray(logits)))
    tc = prng.categorical(_t(keys), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(jc, tc)
    # one key over a batch of rows: jax draws noise over the whole shape
    jc1 = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
    tc1 = prng.categorical(_t(key), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(jc1, tc1)


def test_key_conversions():
    k = prng.as_key(7)
    assert k.dtype == torch.int64 and k.tolist() == [0, 7]
    u32 = torch.tensor([1, 2 ** 32 - 1], dtype=torch.int64).to(torch.uint32)
    assert prng.as_key(u32).tolist() == [1, 2 ** 32 - 1]
    with pytest.raises(ValueError):
        prng.as_key(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError):
        prng.as_key(torch.zeros(2))
    with pytest.raises(OverflowError):
        prng.PRNGKey(2 ** 64)
