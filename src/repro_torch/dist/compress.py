"""Low-bit compression for the distributed wires (beyond-paper §DFXP-comm).

The port of ``repro.dist.compress``.  The paper quantizes *compute*; at
scale the bytes that hurt are the ones crossing the interconnect.  Three
wires, on the grid machinery of :mod:`repro_torch.core.quant`:

  * :func:`compress_decompress` — data-parallel gradient mean-reduce in
    ``bits``-bit lanes with **error feedback**: the quantization residual
    is carried to the next step, so the time-averaged update is unbiased.
    Over a mesh axis a shared power-of-two scale is agreed via ``pmax`` so
    every replica quantizes onto the same grid and the ``psum`` is exact
    integer addition.
  * :func:`compress_tree` — the same over a gradient tree, one scale per
    leaf (weight-gradient magnitudes differ by orders across layers).
  * :func:`compressed_all_to_all` — MoE dispatch/combine ``all_to_all`` in
    int8/int16 lanes at the tape's activation exponent for the site; the
    backward pass runs the reverse ``all_to_all`` through the same
    quantizer.

Collectives run over the ambient mesh (:func:`repro_torch.launch.mesh
.use_mesh`) unless a ``mesh`` is passed.  The deterministic rounding is
:func:`repro_torch.core.quant.fixed_round`, which takes the quantize
kernel K1 under ``enable_pallas_quantize``; stochastic rounding draws
from a threefry key, ``fold_in(key, i)`` for leaf ``i`` of a tree.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.packed import PackedArray
from repro_torch.core.quant import exact_pow2, fixed_round, log2

Tensor = torch.Tensor

_TINY = 1e-38


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from repro_torch.launch.mesh import ambient_mesh
    m = ambient_mesh()
    if m is None:
        raise ValueError("a collective over a mesh axis needs a mesh: pass "
                         "mesh= or run under launch.mesh.use_mesh")
    return m


def _grid_exp(amax: Tensor, bits: int) -> Tensor:
    """Smallest integer ``e`` such that ``amax`` fits the ``bits``-bit grid
    ``k * 2**e``, ``|k| <= 2**(bits-1)-1`` (``log2`` as ``jnp.log2``
    computes it, so powers of two ceil to the same integer)."""
    qmax = float(2 ** (bits - 1) - 1)
    return torch.ceil(log2(torch.clamp(amax, min=_TINY) / qmax))


def compress_decompress(g: Tensor, r: Tensor, bits: int, axis_name=None, *,
                        stochastic_key: Optional[Tensor] = None,
                        mesh=None) -> Tuple[Tensor, Tensor]:
    """Quantize ``g + r`` to ``bits`` bits; optionally mean-reduce over
    the mesh axis ``axis_name``.  Returns ``(g_hat, r_new)``.

    ``r`` is the error-feedback residual from the previous step; ``r_new``
    this step's (``compensated - quantized``, always local).  With
    ``axis_name`` the scale is agreed with ``pmax`` and ``g_hat`` is the
    mean of the ranks' quantized gradients — the compressed all-reduce.
    """
    c = g.to(torch.float32) + r.to(torch.float32)
    amax = torch.amax(torch.abs(c))
    if axis_name is not None:
        mesh = _mesh(mesh)
        amax = mesh.pmax(amax, axis_name)
    e = _grid_exp(amax, bits)
    q, _ = fixed_round(c, bits, e, stochastic=stochastic_key is not None,
                       key=stochastic_key)
    r_new = c - q
    if axis_name is not None:
        # q values are k·2**e with small integer k: the sum is exact
        # integer addition on the shared grid (the int-lane wire format)
        n = float(mesh.axis_size(axis_name))
        q = mesh.psum(q, axis_name) / n
    return q.to(g.dtype), r_new.to(r.dtype)


def ef_init(params):
    """Zero error-feedback residuals matching ``params``' *compute* view:
    f32 zeros of each leaf's logical shape (a :class:`PackedArray` leaf
    maps to its mantissa's shape).  The tree a checkpointed trainer saves
    and restores for a bit-exact resume of compressed training."""
    if isinstance(params, dict):
        return {k: ef_init(v) for k, v in params.items()}
    x = params.mantissa if isinstance(params, PackedArray) else params
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


def _flatten(tree):
    """Leaves in ``jax.tree`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    return [tree]


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        return next(it)

    return build(template)


def compress_tree(g, r, bits: int, axis_name=None, *,
                  stochastic_key: Optional[Tensor] = None, mesh=None):
    """:func:`compress_decompress` over a tree, one scale per leaf.
    Returns ``(g_hat_tree, r_new_tree)`` with the structure of ``g``."""
    outs = []
    for i, (gl, rl) in enumerate(zip(_flatten(g), _flatten(r))):
        key = (prng.fold_in(prng.as_key(stochastic_key, gl.device), i)
               if stochastic_key is not None else None)
        outs.append(compress_decompress(gl, rl, bits, axis_name,
                                        stochastic_key=key, mesh=mesh))
    return (_unflatten(g, [o[0] for o in outs]),
            _unflatten(g, [o[1] for o in outs]))


def _int_lane_dtype(bits: int) -> torch.dtype:
    if bits <= 8:
        return torch.int8
    if bits <= 16:
        return torch.int16
    return torch.int32


def _quantized_all_to_all(x: Tensor, e: Tensor, bits: int, axis_name,
                          split: int, concat: int, mesh) -> Tensor:
    """Round onto the ``2**e`` grid, ship int mantissas, dequantize."""
    step = exact_pow2(torch.as_tensor(e, dtype=torch.float32,
                                      device=x.device))
    qmax = float(2 ** (bits - 1) - 1)
    qmin = -float(2 ** (bits - 1))
    m = torch.clamp(torch.round(x.to(torch.float32) / step), qmin, qmax)
    mo = mesh.all_to_all(m.to(_int_lane_dtype(bits)), axis_name, split,
                         concat)
    return (mo.to(torch.float32) * step).to(x.dtype)


class _CompressedAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, e, bits, axis_name, split, concat, mesh):
        ctx.args = (bits, axis_name, split, concat, mesh)
        ctx.save_for_backward(e)
        return _quantized_all_to_all(x, e, bits, axis_name, split, concat,
                                     mesh)

    @staticmethod
    def backward(ctx, ct):
        # the transpose of all_to_all(split, concat) is
        # all_to_all(concat, split); the cotangent rides the wire at the
        # same width (quantized backprop)
        bits, axis_name, split, concat, mesh = ctx.args
        e, = ctx.saved_tensors
        ctx_x = _quantized_all_to_all(ct, e, bits, axis_name, concat, split,
                                      mesh)
        return ctx_x, torch.zeros_like(e), None, None, None, None, None


def compressed_all_to_all(x: Tensor, e, bits: int, axis_name, *,
                          split_axis: int, concat_axis: int,
                          mesh=None) -> Tensor:
    """Tiled ``all_to_all`` of ``x`` in ``bits``-bit integer lanes.

    ``e`` is the DFXP scale exponent of the activation group being shipped
    (the tape tracks one per dispatch/combine site); values are rounded
    onto ``k * 2**e`` and the int mantissas cross the wire.  The exponent
    gets a zero gradient.
    """
    e = torch.as_tensor(e, dtype=torch.float32, device=x.device)
    return _CompressedAllToAll.apply(x, e, int(bits), axis_name,
                                     int(split_axis), int(concat_axis),
                                     _mesh(mesh))
