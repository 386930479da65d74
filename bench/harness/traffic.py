"""The general traffic generators.  A mix is a JSON file of parameters
(``traffic/<name>.json``); these functions turn it and ``--seed`` into
inputs.  Both sides of a comparison draw their inputs here, so the
program and the plain reference see the same rows.

Every seed gets the same sizes: lengths are fixed quantiles of the mix's
laws, and the seed only orders them and draws the token ids.
"""
from __future__ import annotations

import hashlib
import math
from statistics import NormalDist
from typing import List

import numpy as np


def mix(*parts) -> int:
    """A 63-bit seed from any parts (the run's seed, a stream name, an
    index): streams that never overlap, for any ``--seed``."""
    h = hashlib.sha256(":".join(map(str, parts)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


# ---------------------------------------------------------------------------
# language-model rows (training)
# ---------------------------------------------------------------------------

def zipf_cdf(torch, vocab: int, s: float, device):
    """The cumulative Zipf law of exponent ``s`` over ranks ``1..vocab``."""
    w = torch.arange(1, vocab + 1, dtype=torch.float64, device=device).pow(-s)
    cdf = torch.cumsum(w, 0)
    return cdf / cdf[-1]


def lm_batch(torch, traffic: dict, vocab: int, seed: int, stream: str,
             index: int, device) -> dict:
    """Batch ``index`` of a stream: ``batch`` rows of ``seq_len + 1`` ids
    from a Zipf law of exponent ``zipf_s`` over ``vocab`` (id ``r`` is the
    ``r``-th most frequent), as ``tokens`` and next-token ``labels``,
    drawn on ``device`` by inverse transform."""
    B, S = int(traffic["batch"]), int(traffic["seq_len"])
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, stream, index))
    u = torch.rand((B, S + 1), generator=g, dtype=torch.float64,
                   device=device)
    cdf = zipf_cdf(torch, vocab, float(traffic["zipf_s"]), device)
    ids = torch.searchsorted(cdf, u).clamp_(max=vocab - 1).to(torch.int32)
    return {"tokens": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}


# ---------------------------------------------------------------------------
# a closed loop of chat clients (serving)
# ---------------------------------------------------------------------------

def lognormal_quantiles(n: int, median: float, sigma: float, lo: int,
                        hi: int) -> List[int]:
    """``n`` lengths at the mid-quantiles ``(i + 1/2) / n`` of a lognormal
    law, rounded and clipped to ``[lo, hi]``."""
    nd = NormalDist()
    return [int(min(hi, max(lo, round(median * math.exp(
        sigma * nd.inv_cdf((i + 0.5) / n)))))) for i in range(n)]


def chat_plan(traffic: dict, vocab: int, seed: int) -> List[List[dict]]:
    """Each client's requests in order: ``{"prompt": int32 ids, "max_new":
    n}``.  A client's first request is admitted in set-up with part of its
    output already behind it: its budget is the residual of a drawn
    length, so that completions spread over the window from its start.

    The sizes are fixed quantiles of the mix's laws, and the seed only
    deals them out: each round of requests (every client's ``r``-th) holds
    the same ``clients`` prompt lengths and output lengths in another
    order, so a window that reaches about the same round on every seed
    serves about the same work."""
    C, R = int(traffic["clients"]), int(traffic["requests_per_client"])
    p, o = traffic["prompt"], traffic["output"]

    def law(spec):
        return lognormal_quantiles(C, spec["median"], spec["sigma"],
                                   spec["min"], spec["max"])

    plens, olens = law(p), law(o)
    # residual fractions (k + 1/2) / C dealt over the lengths by a fixed
    # stride, so that long and short lengths each get small and large ones
    first = [max(1, math.ceil((j * 37 % C + 0.5) / C * n))
             for j, n in enumerate(olens)]
    rng = np.random.Generator(np.random.PCG64(mix(seed, "chat")))
    rounds = []
    for r in range(R):
        sizes = olens if r else first
        rounds.append([(plens[i], sizes[j]) for i, j in
                       zip(rng.permutation(C), rng.permutation(C))])
    return [[{"prompt": rng.integers(0, vocab, size=rounds[r][c][0],
                                     dtype=np.int32),
              "max_new": int(rounds[r][c][1])} for r in range(R)]
            for c in range(C)]
