"""The port's packed KV pool (repro_torch.serve.kv_pool) against the reference.

The same f32 K/V streams go through ``repro.serve.kv_pool.PackedKVCodec``
and the port's codec: ``pack_entry``, twelve ``append``s with
``update_interval=4`` (masked rows included, magnitudes that drive the §5
controller both ways), and ``append_chunk`` with ragged ``n_valid`` and an
admission slot.  Mantissas, exponents, positions, controller windows and
cumulative counters must be exactly equal after every operation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import kv_pool as jkv
from repro_torch.serve import kv_pool as tkv

B, W, K, HD = 3, 10, 2, 8


def _assert_entry_equal(je, te):
    assert set(je) == set(te)
    for name in je:
        np.testing.assert_array_equal(np.asarray(je[name]), te[name].numpy(),
                                      err_msg=name)


def _codecs(width):
    cfg = dict(width=width, update_interval=4)
    return (jkv.PackedKVCodec(jkv.CacheQuantConfig(**cfg)),
            tkv.PackedKVCodec(tkv.CacheQuantConfig(**cfg)))


def _raw(rng, n_filled):
    k = rng.standard_normal((1, B, W, K, HD)).astype(np.float32)
    v = (0.5 * rng.standard_normal((1, B, W, K, HD))).astype(np.float32)
    pos = np.full((1, B, W), -1, np.int32)
    for b, n in enumerate(n_filled):
        pos[0, b, :n] = np.arange(n)
    return {"k": k, "v": v, "pos": pos}


@pytest.mark.parametrize("width", [8, 16])
def test_pack_append_chunk_exact(width):
    rng = np.random.default_rng(width)
    jc, tc = _codecs(width)
    raw = _raw(rng, [4, 6, 2])
    je = jc.pack_entry({k: jnp.asarray(v) for k, v in raw.items()})
    te = tc.pack_entry({k: torch.from_numpy(v) for k, v in raw.items()})
    _assert_entry_equal(je, te)

    je = {k: v[0] for k, v in je.items()}          # one layer, as in the scan
    te = {k: v[0] for k, v in te.items()}
    j_append = jax.jit(jc.append)
    pos = np.array([4, 6, 2], np.int32)
    moved = 0
    for step in range(12):
        gain = 6.0 if step in (2, 3, 4) else 0.05 if step > 7 else 1.0
        kn = (gain * rng.standard_normal((B, K, HD))).astype(np.float32)
        vn = (gain * rng.standard_normal((B, K, HD))).astype(np.float32)
        mask = None if step % 3 else np.array([True, step % 2 == 0, True])
        e_before = te["k_e"].clone()
        je = j_append(je, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos),
                      mask=None if mask is None else jnp.asarray(mask))
        te = tc.append(te, torch.from_numpy(kn), torch.from_numpy(vn),
                       torch.from_numpy(pos),
                       mask=None if mask is None else torch.from_numpy(mask))
        _assert_entry_equal(je, te)
        moved += int((te["k_e"] != e_before).sum())
        pos = pos + (1 if mask is None else mask.astype(np.int32))
    assert moved > 0                      # the controller acted

    C = 5
    kn = (3.0 * rng.standard_normal((B, C, K, HD))).astype(np.float32)
    vn = rng.standard_normal((B, C, K, HD)).astype(np.float32)
    p0 = np.array([int(pos[0]), 0, int(pos[2])], np.int32)   # slot 1 admits
    nv = np.array([5, 3, 2], np.int32)
    je = jc.append_chunk(je, jnp.asarray(kn), jnp.asarray(vn),
                         jnp.asarray(p0), jnp.asarray(nv))
    te = tc.append_chunk(te, torch.from_numpy(kn), torch.from_numpy(vn),
                         torch.from_numpy(p0), torch.from_numpy(nv))
    _assert_entry_equal(je, te)

    # pool-level views of the counters
    jpool = {"dec": {"0:attn": {k: v[None] for k, v in je.items()}}}
    tpool = {"dec": {"0:attn": {k: v[None] for k, v in te.items()}}}
    np.testing.assert_array_equal(
        np.asarray(jkv.slot_overflow_rates(jpool, B)),
        tkv.slot_overflow_rates(tpool, B).numpy())
    for s in range(B):
        np.testing.assert_array_equal(np.asarray(jkv.slot_totals(jpool, s)),
                                      tkv.slot_totals(tpool, s).numpy())
    act = np.array([True, False, True])
    assert jkv.overflow_summary(jpool, act) == \
        tkv.overflow_summary(tpool, torch.from_numpy(act))


def test_chunk_larger_than_window_drops_evicted_rows():
    """C > W: rows the ring evicts within the chunk are written by neither."""
    rng = np.random.default_rng(5)
    jc, tc = _codecs(8)
    je = jc.init_like({"k": jnp.zeros((1, B, 4, K, HD)),
                       "v": jnp.zeros((1, B, 4, K, HD)),
                       "pos": jnp.full((1, B, 4), -1, jnp.int32)})
    te = tc.init_like({"k": torch.zeros((1, B, 4, K, HD)),
                       "v": torch.zeros((1, B, 4, K, HD)),
                       "pos": torch.full((1, B, 4), -1, dtype=torch.int32)})
    _assert_entry_equal(je, te)
    je = {k: v[0] for k, v in je.items()}
    te = {k: v[0] for k, v in te.items()}
    kn = rng.standard_normal((B, 7, K, HD)).astype(np.float32)
    p0 = np.zeros(B, np.int32)
    nv = np.array([7, 5, 2], np.int32)
    je = jc.append_chunk(je, jnp.asarray(kn), jnp.asarray(kn),
                         jnp.asarray(p0), jnp.asarray(nv))
    te = tc.append_chunk(te, torch.from_numpy(kn), torch.from_numpy(kn),
                         torch.from_numpy(p0), torch.from_numpy(nv))
    _assert_entry_equal(je, te)
    assert te["pos"][0].tolist() == [4, 5, 6, 3]


def test_make_kv_pool_refuses_what_is_not_ported():
    from repro_torch import configs
    from repro_torch.core.policy import PrecisionPolicy
    cfg = configs.get_smoke("llama3_8b")
    # paged pools are ported: page_size builds one (arena with its
    # scratch page, block tables, per-page exponents)
    kvp = tkv.make_kv_pool(cfg, PrecisionPolicy(), max_slots=2, max_len=10,
                           cache_bits=8, page_size=4, device="cpu")
    e = kvp.pool["dec"]["0:attn"]
    assert kvp.paged and kvp.nblocks == 3 and kvp.total_pages == 7
    assert e["k_m"].dtype == torch.int8
    assert tuple(e["k_m"].shape) == (cfg.num_layers, 7 + 1, 4,
                                     cfg.num_kv_heads, cfg.head_dim)
    assert tuple(e["bt"].shape) == (cfg.num_layers, 2, 3)
    assert tuple(e["k_e"].shape) == (cfg.num_layers, 8)
    with pytest.raises(NotImplementedError):
        tkv.PackedKVCodec(tkv.CacheQuantConfig(stochastic=True))
    with pytest.raises(NotImplementedError):
        tkv.make_kv_pool(cfg, PrecisionPolicy(), max_slots=2, max_len=10,
                         cache_bits=8, page_size=4, device="cpu",
                         cache_cfg=tkv.CacheQuantConfig(stochastic=True))
    kvp = tkv.make_kv_pool(cfg, PrecisionPolicy(fused_decode=True),
                           max_slots=2, max_len=8, cache_bits=16,
                           device="cpu")
    assert kvp.packed and kvp.codec.fused_decode
    assert kvp.pool["dec"]["0:attn"]["k_m"].dtype == torch.int16
