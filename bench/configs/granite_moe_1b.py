"""granite-moe-1b (granite-3.0-1b-a400m): the weight maker, the plain
reference of a DFXP training run and the work counts of a step.

The reference is plain PyTorch in float32 with TF32 off, written from the
model's equations: pre-norm RMSNorm blocks of RoPE attention with grouped
KV heads and a mixture of 32 SwiGLU experts (softmax router, top 8
renormalised, ``ceil(T*k/E*capacity)`` slots an expert, slots taken in
token order), a tied head and mean cross-entropy.  Its DFXP arithmetic
(:mod:`harness.dfxp`) rounds each activation and its cotangent at the
computation width, each weight where it enters a product, the weight
gradient at the computation width, and parameters and momentum at the
update width; it calibrates its own exponents (paper §9.3) from the
inputs.  It imports nothing of the program and takes nothing the program
made: the weights and rows come from the seed, as the program's do.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from harness import dfxp
from harness.peaks import least_seconds, product
from harness.traffic import mix

def sizes(config: dict, smoke: bool = False) -> dict:
    s = {k: v for k, v in config.items() if k != "smoke"}
    if smoke:
        s.update({k: v for k, v in config["smoke"].items() if k != "port"})
    return s


def make_weights(S: dict, seed: int, device) -> dict:
    """The initial parameters in the program's layout, drawn on
    ``device`` from the seed: one call a leaf."""
    L, D = S["num_hidden_layers"], S["hidden_size"]
    H, K, hd = (S["num_attention_heads"], S["num_key_value_heads"],
                S["head_dim"])
    E, Fd, V = (S["num_local_experts"], S["intermediate_size"],
                S["vocab_size"])
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, "weights"))

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device).mul_(std)

    def ones(*shape):
        return torch.ones(shape, device=device)

    attn = {"norm": ones(L, D),
            "wq": normal((L, D, H * hd), 1 / math.sqrt(D)),
            "wk": normal((L, D, K * hd), 1 / math.sqrt(D)),
            "wv": normal((L, D, K * hd), 1 / math.sqrt(D)),
            "wo": normal((L, H * hd, D), 1 / math.sqrt(H * hd))}
    moe = {"norm": ones(L, D),
           "router": normal((L, D, E), 0.02),
           "w_gate": normal((L, E, D, Fd), 1 / math.sqrt(D)),
           "w_up": normal((L, E, D, Fd), 1 / math.sqrt(D)),
           "w_down": normal((L, E, Fd, D), 1 / math.sqrt(Fd))}
    return {"stages": {"dec": {"stacked": {"0:attn": attn, "1:moe": moe},
                               "shared": {}}},
            "embed": normal((V, D), 0.02),
            "final_norm": ones(D)}


def leaves(tree, prefix="") -> Dict[str, torch.Tensor]:
    """``{"a/b/c": leaf}`` of nested dicts, in the tree's order."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(leaves(v, name))
        else:
            out[name] = v
    return out


def _tree(flat: Dict[str, torch.Tensor]) -> dict:
    root: dict = {}
    for name, v in flat.items():
        node = root
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    root.setdefault("stages", {}).setdefault("dec", {}).setdefault(
        "shared", {})
    return root


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """Rotary embedding of ``x`` [B, T, H, hd] at positions ``0..T-1``,
    the two halves of each head rotated together."""
    T, hd = x.shape[1], x.shape[-1]
    ar = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-ar / hd * torch.log(
        torch.tensor(theta, dtype=torch.float32, device=x.device)))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, scale: float):
    """Causal attention; query head ``h`` reads KV head ``h // group``."""
    B, T, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def moe(x, m: dict, S: dict, ar: dfxp.Arith, pre: str, l: int):
    """The expert layer over tokens ``x`` [T, D]."""
    T, D = x.shape
    E, k = S["num_local_experts"], S["num_experts_per_tok"]
    probs = torch.softmax(x @ m["router"], dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :k], ids[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    cap = max(1, math.ceil(T * k / E * S["capacity_factor"]))
    eid, gate = ids.reshape(-1), gates.reshape(-1)
    # a slot's rank among the slots of its expert, in token order
    rank = (torch.cumsum(F.one_hot(eid, E), 0) - 1).gather(
        1, eid[:, None])[:, 0]
    keep = rank < cap
    xk = x.repeat_interleave(k, dim=0)
    xe = x.new_zeros((E, cap, D)).index_put(
        (eid[keep], rank[keep]), xk[keep])
    xe = ar.site(xe, f"{pre}/dispatch", l)
    wg = ar.weight(m["w_gate"], f"{pre}/w_gate", l)
    wu = ar.weight(m["w_up"], f"{pre}/w_up", l)
    wd = ar.weight(m["w_down"], f"{pre}/w_down", l)
    h = ar.site(F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu),
                f"{pre}/pre", l)
    ye = ar.site(torch.bmm(h, wd), f"{pre}/expert_out", l)
    picked = ye[eid, rank.clamp(max=cap - 1)] * (gate * keep)[:, None]
    picked = picked.view(T, k, D)
    y = picked[:, 0]
    for j in range(1, k):
        y = y + picked[:, j]
    return y


def loss(p: dict, batch: dict, S: dict, ar: dfxp.Arith):
    """Mean next-token cross-entropy of one batch."""
    L, eps = S["num_hidden_layers"], S["rms_norm_eps"]
    H, K, hd = (S["num_attention_heads"], S["num_key_value_heads"],
                S["head_dim"])
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    B, T = tokens.shape
    table = p["embed"]
    x = ar.site(ar.weight(table, "emb/w")[tokens], "emb/out")
    st = p["stages"]["dec"]["stacked"]
    a_l = {n: t.unbind(0) for n, t in st["0:attn"].items()}
    m_l = {n: t.unbind(0) for n, t in st["1:moe"].items()}
    for l in range(L):
        a = {n: t[l] for n, t in a_l.items()}
        pre = "dec/0:attn"
        h = rmsnorm(x, a["norm"], eps)
        q = (h @ ar.weight(a["wq"], f"{pre}/wq", l)).view(B, T, H, hd)
        k = (h @ ar.weight(a["wk"], f"{pre}/wk", l)).view(B, T, K, hd)
        v = (h @ ar.weight(a["wv"], f"{pre}/wv", l)).view(B, T, K, hd)
        q = ar.site(rope(q, S["rope_theta"]), f"{pre}/qkv", l)
        k = ar.site(rope(k, S["rope_theta"]), f"{pre}/k", l)
        v = ar.site(v, f"{pre}/v", l)
        o = attention(q, k, v, S["attention_multiplier"])
        y = o.reshape(B, T, H * hd) @ ar.weight(a["wo"], f"{pre}/wo", l)
        y = ar.site(y, f"{pre}/out", l)
        x = ar.site(x + y, f"{pre}/res", l)
        m = {n: t[l] for n, t in m_l.items()}
        pre = "dec/1:moe"
        h = rmsnorm(x, m["norm"], eps)
        y = moe(h.reshape(B * T, -1), m, S, ar, pre, l).view(B, T, -1)
        y = ar.site(y, f"{pre}/out", l)
        x = ar.site(x + y, f"{pre}/res", l)
    h = rmsnorm(x, p["final_norm"], eps)
    logits = ar.site(h @ ar.weight(table, "head/w").t(), "head/logits")
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None]).mean()


# ---------------------------------------------------------------------------
# training: calibration, then SGD with momentum at DFXP
# ---------------------------------------------------------------------------

def _schedule(opt: dict, step: int, device):
    """The learning rate (linear decay) and momentum (linear saturation)
    of step ``step``, in float32."""
    s = torch.tensor(float(step), dtype=torch.float32, device=device)
    frac = 1.0 - s / opt["lr_decay_steps"]
    lr = opt["lr"] * torch.clamp(frac, opt["lr_min_factor"], 1.0)
    t = torch.clamp(s / opt["momentum_sat_steps"], 0.0, 1.0)
    slope = float(torch.tensor(opt["momentum_final"] - opt["momentum_init"],
                               dtype=torch.float32))
    mom = (slope * t.double() + opt["momentum_init"]).float()
    return lr, mom


def _sgd(p, m, g, lr, mom):
    """Momentum ``mom * m + g`` and the parameter ``p - lr * m``, each a
    float32 rounding of its exact value."""
    new_m = (mom.double() * m.double() + g.double()).float()
    new_p = (p.double() - lr.double() * new_m.double()).float()
    return new_p, new_m


def _per_layer_max(x: torch.Tensor, stacked: bool):
    a = x.detach().abs()
    return a.flatten(1).amax(1) if stacked else a.max()


def _grads(params: Dict[str, torch.Tensor], batch, S, ar):
    ps = {n: t.detach().requires_grad_(True) for n, t in params.items()}
    lo = loss(_tree(ps), batch, S, ar)
    gs = torch.autograd.grad(lo, list(ps.values()))
    return float(lo.detach()), dict(zip(ps, gs))


def calibrate(w0: Dict[str, torch.Tensor], batches: List[dict], S: dict,
              opt: dict, comp_width: int, update_width: int) -> dict:
    """Paper §9.3: float32 SGD steps that book every group's largest
    magnitude; each group's exponent holds it with a bit of headroom."""
    book = dfxp.MaxBook()
    ar = dfxp.Arith("observe", book=book)
    L = S["num_hidden_layers"]
    params = dict(w0)
    mom = {n: torch.zeros_like(t) for n, t in w0.items()}
    vec: Dict[str, torch.Tensor] = {}

    def see(group, x, stacked):
        m = _per_layer_max(x, stacked)
        vec[group] = torch.maximum(vec[group], m) if group in vec else m

    for i, batch in enumerate(batches):
        _, grads = _grads(params, batch, S, ar)
        lr, mu = _schedule(opt, i, next(iter(w0.values())).device)
        for n in params:
            stacked = "stacked" in n
            see(f"pg:{n}", grads[n], stacked)
            params[n], mom[n] = _sgd(params[n], mom[n], grads[n], lr, mu)
            see(f"p:{n}", params[n], stacked)
            see(f"pm:{n}", mom[n], stacked)
    layers = {g: L for (g, _) in book.max}

    def width(group):
        return update_width if group.startswith(("p:", "pm:")) \
            else comp_width

    exps = dfxp.stacked_exps(book, width, layers)
    for g, m in vec.items():
        exps[g] = dfxp.calibrated_exp(m, width(g))
    return exps


def norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def train_reference(S: dict, seed: int, batches: dict, opt: dict,
                    policy: dict, steps: int, device,
                    comp_width=None) -> dict:
    """The run the program makes in set-up, followed for ``steps``
    steps: per step the loss, after step 1 each leaf's momentum norm (the
    gradient as the optimizer took it), after the last each leaf's
    change (its norm, and how many of its elements moved).  ``comp_width`` other than the policy's computes the products
    at that width (the control); ``batches["train"]`` may be edited by a
    test's planted fault."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cw = comp_width or policy["comp_width"]
    uw = policy["update_width"]
    w0 = leaves(make_weights(S, seed, device))
    exps = calibrate(w0, batches["calibrate"], S, opt, cw, uw)
    ar = dfxp.Arith("dfxp", cw, exps)

    def q(n, x, prefix, width):
        return dfxp.rnd(x, width, exps[prefix + n])

    params = {n: q(n, t, "p:", uw) for n, t in w0.items()}
    p0 = dict(params)
    del w0
    mom = {n: torch.zeros_like(t) for n, t in params.items()}
    out = {"loss": [], "grad_norm": {}, "update_norm": {}}
    for i in range(steps):
        lo, grads = _grads(params, batches["train"][i], S, ar)
        out["loss"].append(lo)
        lr, mu = _schedule(opt, i, device)
        for n in params:
            g = q(n, grads[n], "pg:", cw)
            p, m = _sgd(params[n], mom[n], g, lr, mu)
            params[n], mom[n] = q(n, p, "p:", uw), q(n, m, "pm:", uw)
        del grads
        if i == 0:
            out["grad_norm"] = {n: norm(m) for n, m in mom.items()}
    out["update_norm"] = {n: norm(params[n] - p0[n]) for n in params}
    out["update_moved"] = {n: int(torch.count_nonzero(params[n] - p0[n]))
                           for n in params}
    return out


# ---------------------------------------------------------------------------
# work counts
# ---------------------------------------------------------------------------

def active_params(S: dict) -> float:
    """Parameters a token uses: all but the experts it is not routed to
    (the tied table once)."""
    L, D = S["num_hidden_layers"], S["hidden_size"]
    H, K, hd = (S["num_attention_heads"], S["num_key_value_heads"],
                S["head_dim"])
    E, k, Fd, V = (S["num_local_experts"], S["num_experts_per_tok"],
                   S["intermediate_size"], S["vocab_size"])
    attn = D * H * hd * 2 + D * K * hd * 2 + D
    moe = D * E + D + 3 * D * Fd * k
    return L * (attn + moe) + V * D + D


def train_flops(S: dict, B: int, T: int) -> float:
    """Model operations of one training step (forward and backward,
    nothing recomputed): ``6 * active * tokens`` and causal attention's
    score and value products, three times their forward."""
    L, H, hd = (S["num_hidden_layers"], S["num_attention_heads"],
                S["head_dim"])
    attn = 4 * B * T * (T / 2) * H * hd * L
    return 6 * active_params(S) * B * T + 3 * attn


def train_products(S: dict, B: int, T: int) -> List[tuple]:
    """``(flops, bytes)`` of each matrix product a training step needs
    (forward, input gradient and weight gradient), float32 operands: the
    projections, the routed tokens' expert products (``T*k`` rows), the
    router, the causal half of attention and the tied head."""
    L, D = S["num_hidden_layers"], S["hidden_size"]
    H, K, hd = (S["num_attention_heads"], S["num_key_value_heads"],
                S["head_dim"])
    E, k, Fd, V = (S["num_local_experts"], S["num_experts_per_tok"],
                   S["intermediate_size"], S["vocab_size"])
    N = B * T
    fwd = []
    for _ in range(L):
        fwd += [(N, D, H * hd, 1), (N, D, K * hd, 2), (N, H * hd, D, 1),
                (N, D, E, 1),
                (N * k // E, D, Fd, 2 * E), (N * k // E, Fd, D, E)]
        # causal scores and values: half of each T x T product
        fwd += [(T, hd, T // 2, B * H), (T, T // 2, hd, B * H)]
    fwd.append((N, D, V, 1))
    prods = []
    for m, kk, n, c in fwd:
        prods.append(product(m, kk, n, c))          # forward
        prods.append(product(m, n, kk, c))          # input gradient
        prods.append(product(kk, m, n, c))          # weight gradient
    return prods


def train_gemm_least_s(S: dict, B: int, T: int) -> float:
    return sum(least_seconds(f, b) for f, b in train_products(S, B, T))
