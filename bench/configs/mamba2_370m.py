"""mamba2-370m: the weight maker, the plain reference of served tokens and
the work counts of prefill and decode.

The reference is plain PyTorch in float32 with TF32 off, written from the
Mamba-2 equations (arXiv:2405.21060): per layer RMSNorm, ``in_proj`` to
``z, x, B, C, dt``, a depthwise causal convolution of width 4 over
``x, B, C`` and SiLU, ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``
and per head the state ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``,
``y_t = C_t h_t + D x_t``, then ``RMSNorm(y * silu(z))``, ``out_proj`` and
the residual; a tied head.

Served DFXP arithmetic, which both sides run: every weight where it
enters a product and every activation (``x``, ``y``, a block's output,
the residual, the embedding's output, the logits) at the computation
width; the carried state at the update width where it is carried: at the
start of each chunk of the prompt (inside a chunk the state is exact) and
at every generated token.  All exponents are the served model's fixed
one.  The reference computes the prompt chunk by chunk and each generated
token by the recurrence, from the prompt and the served tokens alone.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from harness import dfxp
from harness.traffic import mix


def sizes(config: dict, smoke: bool = False) -> dict:
    s = {k: v for k, v in config.items() if k != "smoke"}
    if smoke:
        s.update({k: v for k, v in config["smoke"].items() if k != "port"})
    di = s["expand"] * s["hidden_size"]
    s.update(d_inner=di, heads=di // s["head_dim"],
             conv_dim=di + 2 * s["state_size"],
             in_dim=2 * di + 2 * s["state_size"] + di // s["head_dim"])
    return s


def make_weights(S: dict, seed: int, device) -> dict:
    """The initial parameters in the program's layout, drawn on
    ``device`` from the seed."""
    L, D, H = S["num_hidden_layers"], S["hidden_size"], S["heads"]
    K, di = S["conv_kernel"], S["d_inner"]
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, "weights"))

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device).mul_(std)

    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand((L, H), generator=g, device=device)
                   * (hi - lo) + lo)
    blk = {"norm": torch.ones(L, D, device=device),
           "in_proj": normal((L, D, S["in_dim"]), 1 / math.sqrt(D)),
           "conv_w": normal((L, K, S["conv_dim"]), 1 / math.sqrt(K)),
           "conv_b": torch.zeros(L, S["conv_dim"], device=device),
           "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)
                              ).expand(L, H).clone(),
           "D": torch.ones(L, H, device=device),
           "dt_bias": dt + torch.log(-torch.expm1(-dt)),
           "norm_w": torch.ones(L, di, device=device),
           "out_proj": normal((L, di, D), 1 / math.sqrt(di))}
    return {"stages": {"dec": {"stacked": {"0:mamba": blk}, "shared": {}}},
            "embed": normal((S["vocab_size"], D), 0.02),
            "final_norm": torch.ones(D, device=device)}


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def softplus(x):
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


class Reference:
    """The served model's plain forward over one sequence."""

    def __init__(self, weights: dict, S: dict, policy: dict,
                 comp_width=None, carry_state: bool = True):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.S = S
        self.cw = comp_width or policy["comp_width"]
        self.uw = policy["update_width"]
        self.carry_state = carry_state     # False: a planted fault
        self.e = float(policy["init_exp"])
        blk = weights["stages"]["dec"]["stacked"]["0:mamba"]
        self.L = S["num_hidden_layers"]
        self.blk = [{n: t[l] for n, t in blk.items()} for l in range(self.L)]
        self.w_in = [self.q(b["in_proj"]) for b in self.blk]
        self.w_out = [self.q(b["out_proj"]) for b in self.blk]
        self.table = self.q(weights["embed"])
        self.final = weights["final_norm"]

    def q(self, x):
        return dfxp.rnd(x, self.cw, self.e)

    def qs(self, x):
        return dfxp.rnd(x, self.uw, self.e)

    def _split(self, zx):
        S = self.S
        di, N, H = S["d_inner"], S["state_size"], S["heads"]
        return torch.split(zx, [di, di + 2 * N, H], dim=-1)

    def _out(self, l, x_in, y, z):
        b, eps = self.blk[l], self.S["layer_norm_epsilon"]
        y = rmsnorm(self.q(y) * F.silu(z), b["norm_w"], eps)
        return self.q(x_in + self.q(y @ self.w_out[l]))

    def _head(self, x):
        h = rmsnorm(x, self.final, self.S["layer_norm_epsilon"])
        return self.q(h @ self.table.t())

    def prompt(self, ids: torch.Tensor):
        """Logits after the prompt and each layer's carried (conv window,
        state)."""
        S = self.S
        H, P, N, Q = S["heads"], S["head_dim"], S["state_size"], \
            S["chunk_size"]
        di, K, eps = S["d_inner"], S["conv_kernel"], S["layer_norm_epsilon"]
        T = ids.numel()
        x = self.q(self.table[ids.long()])
        carry = []
        for l, b in enumerate(self.blk):
            z, xbc_raw, dt = self._split(rmsnorm(x, b["norm"], eps)
                                         @ self.w_in[l])
            pad = F.pad(xbc_raw, (0, 0, K - 1, 0))
            conv = pad[0:T] * b["conv_w"][0]
            for k in range(1, K):
                conv = conv + pad[k:k + T] * b["conv_w"][k]
            xbc = F.silu(conv + b["conv_b"])
            xs = self.q(xbc[:, :di]).view(T, H, P)
            Bm, Cm = xbc[:, di:di + N], xbc[:, di + N:]
            dt = softplus(dt + b["dt_bias"])
            a = dt * -torch.exp(b["A_log"])
            h = torch.zeros(H, P, N, device=x.device)
            ys = []
            for c0 in range(0, T, Q):
                sl = slice(c0, min(c0 + Q, T))
                h = self.qs(h)
                acum = torch.cumsum(a[sl], 0)                       # [q,H]
                q_ = acum.shape[0]
                tri = torch.ones(q_, q_, dtype=torch.bool,
                                 device=x.device).tril()
                decay = torch.where(tri[:, :, None], torch.exp(
                    acum[:, None, :] - acum[None, :, :]), 0.0)      # [t,s,H]
                G = Cm[sl] @ Bm[sl].t()                             # [t,s]
                w = decay * G[:, :, None] * dt[sl][None, :, :]
                y = torch.einsum("tsh,shp->thp", w, xs[sl])
                y = y + torch.einsum("tn,hpn,th->thp", Cm[sl], h,
                                     torch.exp(acum))
                ys.append(y)
                to_end = torch.exp(acum[-1][None, :] - acum) * dt[sl]
                h = torch.exp(acum[-1])[:, None, None] * h + torch.einsum(
                    "sh,shp,sn->hpn", to_end, xs[sl], Bm[sl])
            y = torch.cat(ys) + b["D"][None, :, None] * xs
            x = self._out(l, x, y.reshape(T, di), z)
            carry.append((xbc_raw[T - (K - 1):].clone(), h))
        return self._head(x[-1]), carry

    def step(self, tok: int, carry):
        """Logits after one generated token, and the new carry."""
        S = self.S
        H, P, N = S["heads"], S["head_dim"], S["state_size"]
        di, eps = S["d_inner"], S["layer_norm_epsilon"]
        x = self.q(self.table[tok])
        out = []
        for l, b in enumerate(self.blk):
            conv_win, h = carry[l]
            z, raw, dt = self._split(rmsnorm(x, b["norm"], eps)
                                     @ self.w_in[l])
            buf = torch.cat([conv_win, raw[None]])
            conv = buf[0] * b["conv_w"][0]
            for k in range(1, buf.shape[0]):
                conv = conv + buf[k] * b["conv_w"][k]
            xbc = F.silu(conv + b["conv_b"])
            xs = self.q(xbc[:di]).view(H, P)
            Bv, Cv = xbc[di:di + N], xbc[di + N:]
            dt = softplus(dt + b["dt_bias"])
            a = dt * -torch.exp(b["A_log"])
            h = torch.exp(a)[:, None, None] * self.qs(h) \
                + dt[:, None, None] * xs[:, :, None] * Bv[None, None, :]
            y = (h * Cv[None, None, :]).sum(-1) + b["D"][:, None] * xs
            x = self._out(l, x, y.reshape(di), z)
            out.append((buf[1:], h) if self.carry_state else carry[l])
        return self._head(x), out

    def logits(self, prompt, served: List[int]) -> torch.Tensor:
        """``[len(served), V]``: the logits each served token was chosen
        from."""
        dev = self.table.device
        lg, carry = self.prompt(torch.as_tensor(prompt, device=dev))
        rows = [lg]
        for tok in served[:-1]:
            lg, carry = self.step(int(tok), carry)
            rows.append(lg)
        return torch.stack(rows)


def gaps(logits: torch.Tensor, tokens) -> torch.Tensor:
    """How far each token's logit lies below the row's best."""
    t = torch.as_tensor(tokens, device=logits.device).long()
    return logits.max(-1).values - logits.gather(-1, t[:, None])[:, 0]


# ---------------------------------------------------------------------------
# work counts
# ---------------------------------------------------------------------------

def body_params(S: dict) -> float:
    """Parameters of the layers' products (the tied table apart)."""
    D, di = S["hidden_size"], S["d_inner"]
    return S["num_hidden_layers"] * (D * S["in_dim"] + di * D)


def prefill_flops(S: dict, T: int) -> float:
    """Model operations of one whole prompt of ``T`` tokens: the layers'
    products, the chunked scan's (the roofline convention: half a chunk
    of intra-chunk work a token, and the state's in and out) and the head
    at the last position."""
    H, P, N, Q = S["heads"], S["head_dim"], S["state_size"], S["chunk_size"]
    per_tok = 4 * Q / 2 * H * P + 8 * H * P * N
    return (2 * body_params(S) * T + per_tok * T * S["num_hidden_layers"]
            + 2 * S["vocab_size"] * S["hidden_size"])


def decode_flops(S: dict) -> float:
    """Model operations of one generated token."""
    H, P, N = S["heads"], S["head_dim"], S["state_size"]
    return (2 * body_params(S) + 8 * H * P * N * S["num_hidden_layers"]
            + 2 * S["vocab_size"] * S["hidden_size"])
