"""The differentiable fused DFXP matmul on K2 (``repro.kernels.dispatch``,
its fused part: ``_make_fused``, ``fused_dot``, ``tape_dot``).

:func:`fused_dot` is one ``torch.autograd.Function`` whose three passes
are launches of the quantized matmul kernel K2
(:func:`repro_torch.kernels.qmatmul.ops.qmm`):

  * forward  ``y = q(a) @ q(b)``        (layout ``nn``; ``nt`` under
    ``transpose_b``);
  * dgrad    ``da = q_g(ct) @ q(b)^T``  (``nt``; ``nn`` under
    ``transpose_b``);
  * wgrad    ``db = q(a)^T @ q_g(ct)``  (``tn``; under ``transpose_b``
    ``db = q_g(ct)^T @ q(a)``, the operand roles swapped).

Gradients pass straight through the operand rounding, with the rounded
co-operand, and ``q_g`` is the optional cotangent rounding
(``grad_width``) — the reference's custom VJP (``dispatch.py:611-628``).
The backward skips the pass of an input that needs no gradient (the
network's input, say).  Leading dims of ``a`` collapse to 2-D around the
kernel.  The reference's block selection and its persisted autotune cache
are not ported: K2 picks its own tiles (ROADMAP).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.qmatmul.ops import qmm

Tensor = torch.Tensor


class _FusedDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, e_a, e_b, e_g, width_a, width_b, grad_width,
                transpose_b):
        ctx.save_for_backward(a, b, e_a, e_b, e_g)
        ctx.cfg = (width_a, width_b, grad_width, transpose_b)
        return qmm(a, b, e_a, e_b, kind="nt" if transpose_b else "nn",
                   width_a=width_a, width_b=width_b)

    @staticmethod
    def backward(ctx, ct):
        a, b, e_a, e_b, e_g = ctx.saved_tensors
        width_a, width_b, grad_width, transpose_b = ctx.cfg
        need_a, need_b = ctx.needs_input_grad[:2]
        ct = ct.contiguous()
        da = db = None
        if transpose_b:
            # y[M,V] = qa[M,D] @ qb[V,D]^T
            if need_a:
                da = qmm(ct, b, e_g, e_b, kind="nn", width_a=grad_width,
                         width_b=width_b)
            if need_b:
                db = qmm(ct, a, e_g, e_a, kind="tn", width_a=grad_width,
                         width_b=width_a)
        else:
            # y[M,N] = qa[M,K] @ qb[K,N]
            if need_a:
                da = qmm(ct, b, e_g, e_b, kind="nt", width_a=grad_width,
                         width_b=width_b)
            if need_b:
                db = qmm(a, ct, e_a, e_g, kind="tn", width_a=width_a,
                         width_b=grad_width)
        return da, db, None, None, None, None, None, None, None


def fused_dot(a: Tensor, b: Tensor, e_a, e_b, *, width: int,
              grad_width: Optional[int] = None, e_g=0.0, quant_a: bool = True,
              quant_b: bool = True, transpose_b: bool = False) -> Tensor:
    """Differentiable fused DFXP matmul ``q(a) @ q(b)[^T]`` on K2.

    ``a``: [..., K] float32 (leading dims collapsed around the kernel),
    ``b``: [K, N] (or [N, K] with ``transpose_b``).  ``grad_width`` rounds
    the cotangent (exponent ``e_g``) in both backward passes;
    ``quant_a=False`` / ``quant_b=False`` pass that operand through raw —
    the straight-through composite contract used by ``QTape.dot``."""
    dev = a.device

    def exp(e):
        return torch.as_tensor(e, dtype=torch.float32, device=dev)

    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1]).contiguous()
    y = _FusedDot.apply(a2, b.contiguous(), exp(e_a), exp(e_b), exp(e_g),
                        width if quant_a else None,
                        width if quant_b else None, grad_width, transpose_b)
    return y.reshape(*lead, y.shape[-1])


def tape_dot(x: Tensor, w: Tensor, e_w, *, width: int,
             transpose_b: bool = False) -> Tensor:
    """The ``QTape.dot`` fused path: raw activations × quantized weight.

    The same function as ``matmul(x, ste_quant(w))``: the activation
    operand and the backward cotangent are *not* re-rounded here (the
    surrounding ``tape.act`` sites already hold them on the DFXP grid),
    and the weight gradient passes straight through, like ``ste_quant``'s
    identity backward (``dispatch.py:661-673``)."""
    return fused_dot(x, w, 0.0, e_w, width=width, quant_a=False,
                     transpose_b=transpose_b)
