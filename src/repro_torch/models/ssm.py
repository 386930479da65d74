"""Mamba2 (SSD, state-space duality) block, chunked matmul form + decode —
``repro.models.ssm`` in PyTorch.

Per head with log-decay ``a_t = dt_t * A`` (A < 0) and state ``h_t``
``[P, N]``::

    h_t = exp(a_t) h_{t-1} + dt_t * x_t ⊗ B_t
    y_t = C_t · h_t + D * x_t

The chunked form computes each chunk of ``Q`` positions' own
contribution as masked products ``(C Bᵀ ⊙ decay) X`` and carries the
chunk states across chunks in a short loop.

DFXP: the recurrent state accumulates across the whole sequence, so it is
rounded at the *update* width at chunk boundaries (``tape.state``, its
statistics taken once over the stacked carries); everything else at the
computation width.

Formulas follow the reference's, not torch's defaults: ``softplus`` is
``jax.nn.softplus`` (``logaddexp(x, 0)``, with no switch to ``x`` above
a threshold), and the intra-chunk decay is masked with a ``where`` after
the ``exp``.  The depthwise causal convolution is ``K`` shifted
multiply-adds in a fixed order (the reference's grouped ``lax.conv``
sums the same ``K`` products in its own order: the two differ by ulps).
The mamba init's ``dt_bias`` (``log(expm1(exp(u)))``) and ``A_log``
evaluate XLA's CPU ``exp``, ``expm1`` and ``log``
(:mod:`repro_torch.core.prng`), so they equal the reference's bit for bit
on either device.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.tape import QTape

from .layers import init_dense, rmsnorm

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_model: int
    state: int            # N
    headdim: int = 64     # P
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def heads(self):
        return self.d_inner // self.headdim

    @property
    def conv_dim(self):
        return self.d_inner + 2 * self.state

    @property
    def in_proj_dim(self):
        # z (gate), x, B, C, dt
        return 2 * self.d_inner + 2 * self.state + self.heads


def _linspace(start: float, stop: float, num: int, device) -> Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 as XLA compiles it:
    ``r = f32(1 / (num - 1))``, then ``fma(i, f32(stop * r), f32(start *
    f32(1 - f32(i * r))))`` for ``i < num - 1`` (the fused multiply-add
    as a float64 product and sum rounded once to float32), the endpoint
    set exactly."""
    div = num - 1
    f32 = torch.float32
    r = torch.tensor(1.0 / div, dtype=f32, device=device)
    i = torch.arange(div, dtype=f32, device=device)
    lo = start * (1.0 - i * r)             # float32 products, each rounded
    hi = (stop * r).to(torch.float64)
    out = (i.to(torch.float64) * hi + lo.to(torch.float64)).to(f32)
    return torch.cat([out, torch.full((1,), stop, device=device)])


def init_ssm(key: Tensor, spec: SSMSpec) -> dict:
    """The reference's draws from ``split(key, 3)``; a batch of keys
    ``[L, 2]`` draws ``L`` layers."""
    ks = prng.split(key, 3)
    k1, k2, k3 = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]
    H = spec.heads
    lead = key.shape[:-1]
    dev = key.device
    if dev.type == "meta":
        A_log = torch.empty(lead + (H,), device=dev)
        dt_bias = torch.empty(lead + (H,), device=dev)
    else:
        A_log = prng.log(_linspace(1.0, 16.0, H, dev)).expand(
            lead + (H,)).clone()
        u = prng.uniform(k3, (H,), math.log(1e-3), math.log(1e-1))
        dt_bias = prng.log(prng.expm1(prng.exp(u)))
    return {
        "in_proj": init_dense(k1, spec.d_model, spec.in_proj_dim),
        "conv_w": prng.normal_blocked(
            k2, (spec.conv_kernel, spec.conv_dim)).div_(
                math.sqrt(spec.conv_kernel)),
        "conv_b": torch.zeros(lead + (spec.conv_dim,), device=dev),
        "A_log": A_log,
        "D": torch.ones(lead + (H,), device=dev),
        "dt_bias": dt_bias,
        "norm_w": torch.ones(lead + (spec.d_inner,), device=dev),
        "out_proj": init_dense(prng.fold_in(k1, 7), spec.d_inner,
                               spec.d_model),
    }


def _split_in_proj(spec: SSMSpec, zxbcdt: Tensor):
    di, N, H = spec.d_inner, spec.state, spec.heads
    return torch.split(zxbcdt, [di, di, N, N, H], dim=-1)


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal convolution then ``silu``; ``x`` [B, S, C],
    ``w`` [K, C]: ``y[t] = sum_k w[k] x[t - K + 1 + k]`` over zero-padded
    ``x``, summed in the order ``k = 0 .. K-1``."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x.to(torch.float32), (0, 0, K - 1, 0))
    w = w.to(torch.float32)
    y = xp[:, 0:S] * w[0]
    for k in range(1, K):
        y = y + xp[:, k:k + S] * w[k]
    return F.silu(y + b).to(x.dtype)


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))`` (no threshold)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def ssm_forward(params, spec: SSMSpec, u: Tensor, tape: QTape, prefix: str,
                return_cache: bool = False):
    """Training and prefill forward, chunked SSD. ``u``: [B, S, D].

    A sequence that is not a multiple of the chunk is padded; the pad
    positions' ``dt`` is masked to 0, so they neither decay nor feed the
    state and the carried state is the one after the real tokens.  With
    ``return_cache``, also returns the decode cache (the last ``K-1``
    pre-conv inputs and the final state)."""
    B_, S, _ = u.shape
    H, P, N, Q = spec.heads, spec.headdim, spec.state, spec.chunk
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        u = F.pad(u, (0, 0, 0, pad))
        S = S + pad

    zxbcdt = tape.dot(f"{prefix}/in_proj", u, params["in_proj"])
    z, x_raw, B_raw, C_raw, dt = _split_in_proj(spec, zxbcdt)
    di = spec.d_inner
    w, b = params["conv_w"], params["conv_b"]
    x = _causal_conv(x_raw, w[:, :di], b[:di])
    Bm = _causal_conv(B_raw, w[:, di:di + N], b[di:di + N])
    Cm = _causal_conv(C_raw, w[:, di + N:], b[di + N:])
    x = tape.act(f"{prefix}/x", x)

    dt = softplus(dt.to(torch.float32) + params["dt_bias"])         # [B,S,H]
    A = -torch.exp(params["A_log"].to(torch.float32))                # [H]
    if S != S_orig:
        valid = (torch.arange(S, device=u.device) < S_orig)[None, :, None]
        dt = torch.where(valid, dt, 0.0)
    a = dt * A

    nc = S // Q
    xc = x.reshape(B_, nc, Q, H, P).to(torch.float32)
    Bc = Bm.reshape(B_, nc, Q, N).to(torch.float32)
    Cc = Cm.reshape(B_, nc, Q, N).to(torch.float32)
    ac = a.reshape(B_, nc, Q, H)
    dtc = dt.reshape(B_, nc, Q, H)

    acum = torch.cumsum(ac, dim=2)                                   # [B,nc,Q,H]

    # intra-chunk: Y[i] = sum_{j<=i} exp(acum_i - acum_j) (C_i·B_j) dt_j x_j
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                      # [B,nc,Q,Q]
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]           # [B,nc,Q,Q,H]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=u.device))
    M = torch.where(causal[None, None, :, :, None], torch.exp(diff), 0.0) \
        * G[..., None] * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xc)

    # each chunk's own final-state contribution
    decay_to_end = torch.exp(acum[:, :, -1:, :] - acum)              # [B,nc,Q,H]
    hc = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_to_end * dtc, Bc, xc)

    # carry the chunk states
    a_end = acum[:, :, -1, :]                                        # [B,nc,H]
    h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=u.device)
    h_ins = []
    for c in range(nc):
        h = tape.state(f"{prefix}/state", h, record=False)
        h_ins.append(h)
        h = torch.exp(a_end[:, c])[:, :, None, None] * h + hc[:, c]
    h_in = torch.stack(h_ins, dim=1)                                 # [B,nc,H,P,N]
    tape.record_state_stats(f"{prefix}/state", h_in)

    # inter-chunk: Y[i] += C_i · (exp(acum_i) h_prev_chunk)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Cc, h_in,
                           torch.exp(acum))

    y = (y_intra + y_inter + params["D"][None, None, None, :, None]
         * xc).reshape(B_, S, spec.d_inner)
    y = y[:, :S_orig]
    y = tape.act(f"{prefix}/y", y.to(u.dtype))
    y = rmsnorm(y * F.silu(z[:, :S_orig]), params["norm_w"])
    out = tape.dot(f"{prefix}/out_proj", y, params["out_proj"])
    out = tape.act(f"{prefix}/out", out)
    if return_cache:
        need = spec.conv_kernel - 1
        take = min(need, S_orig)   # the last *real* pre-conv inputs
        lo = S_orig - take
        tail = torch.cat([x_raw[:, lo:S_orig], B_raw[:, lo:S_orig],
                          C_raw[:, lo:S_orig]], dim=-1)
        if take < need:            # very short prompt: fresh-state zeros
            tail = F.pad(tail, (0, 0, need - take, 0))
        return out, {"conv": tail, "state": h}
    return out, None


def init_ssm_cache(spec: SSMSpec, batch: int, *, device="cpu") -> dict:
    return {
        "conv": torch.zeros((batch, spec.conv_kernel - 1, spec.conv_dim),
                            device=device),
        "state": torch.zeros((batch, spec.heads, spec.headdim, spec.state),
                             device=device),
    }


def ssm_decode(params, spec: SSMSpec, u: Tensor, cache: dict, tape: QTape,
               prefix: str):
    """One-token recurrent step. ``u``: [B, 1, D] → (y [B,1,D], cache')."""
    B_ = u.shape[0]
    H, P, N = spec.heads, spec.headdim, spec.state

    zxbcdt = tape.dot(f"{prefix}/in_proj", u, params["in_proj"])
    z, x, Bm, Cm, dt = _split_in_proj(spec, zxbcdt)

    xbc = torch.cat([x, Bm, Cm], dim=-1)                             # [B,1,conv]
    conv_buf = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)  # [B,K,conv]
    w = params["conv_w"]
    out = conv_buf[:, 0] * w[0]
    for k in range(1, w.shape[0]):
        out = out + conv_buf[:, k] * w[k]
    xbc1 = F.silu(out + params["conv_b"])[:, None, :]
    x, Bm, Cm = torch.split(xbc1, [spec.d_inner, N, N], dim=-1)
    x = tape.act(f"{prefix}/x", x)

    dt = softplus(dt.to(torch.float32) + params["dt_bias"])[:, 0]    # [B,H]
    A = -torch.exp(params["A_log"].to(torch.float32))
    a = dt * A

    xh = x[:, 0].reshape(B_, H, P).to(torch.float32)
    Bv = Bm[:, 0].to(torch.float32)                                  # [B,N]
    Cv = Cm[:, 0].to(torch.float32)

    h = tape.state(f"{prefix}/state", cache["state"])
    h = (torch.exp(a)[:, :, None, None] * h
         + torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bv))
    y = torch.einsum("bn,bhpn->bhp", Cv, h) + params["D"][None, :, None] * xh
    y = y.reshape(B_, 1, spec.d_inner).to(u.dtype)
    y = tape.act(f"{prefix}/y", y)
    y = rmsnorm(y * F.silu(z), params["norm_w"])
    out = tape.dot(f"{prefix}/out_proj", y, params["out_proj"])
    out = tape.act(f"{prefix}/out", out)
    return out, {"conv": conv_buf[:, 1:], "state": h}
