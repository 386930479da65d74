"""Deterministic synthetic datasets — a numpy copy of ``repro.data.synthetic``.

Two generators, batch for batch bit-equal with the reference's:
  * :class:`SyntheticLM` — a *learnable* token stream: tokens follow a
    random bigram chart with Zipf-ish marginals, so a language model's
    loss decreases well below the unigram entropy.
  * :class:`SyntheticImages` — class-conditional Gaussian clusters pushed
    through a fixed random deep projection (matched to MNIST/CIFAR input
    dims), hard enough that a linear model underperforms the maxout nets.

Both are deterministic in (seed, step), and each host generates only its
own shard (``host_id``/``num_hosts``).  Batches are numpy arrays; the
caller moves them to its device.  The reference's ``shard_batch`` (a JAX
device-put) has no counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        v = self.vocab_size
        # sparse-ish bigram chart: each token has ~8 likely successors
        self.n_next = min(8, v)
        self.nexts = rng.randint(0, v, size=(v, self.n_next)).astype(np.int32)
        zipf = 1.0 / np.arange(1, v + 1)
        self.marginal = (zipf / zipf.sum()).astype(np.float64)

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts

    def batch(self, step: int) -> dict:
        """Host-local shard of the global batch for ``step`` (numpy)."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 613 + self.host_id) % 2 ** 31)
        B, S = self.host_batch, self.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(self.vocab_size, size=B, p=self.marginal)
        # 85% bigram-following, 15% resample → learnable but not trivial
        follows = rng.random((B, S)) < 0.85
        pick = rng.randint(0, self.n_next, size=(B, S))
        resample = rng.randint(0, self.vocab_size, size=(B, S))
        for t in range(S):
            nxt = self.nexts[toks[:, t], pick[:, t]]
            toks[:, t + 1] = np.where(follows[:, t], nxt, resample[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class SyntheticImages:
    input_dim: int = 784
    num_classes: int = 10
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    image_shape: tuple = ()      # e.g. (1, 28, 28) → conv layout
    # difficulty knobs (hard() raises the Bayes error so format differences
    # show up in both loss and error rate)
    center_scale: float = 1.0
    latent_noise: float = 1.0
    out_noise: float = 0.3

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        d_latent = 32
        self.centers = rng.randn(self.num_classes, d_latent).astype(np.float32) * 2.0
        self.proj1 = rng.randn(d_latent, 128).astype(np.float32) / np.sqrt(d_latent)
        self.proj2 = rng.randn(128, self.input_dim).astype(np.float32) / np.sqrt(128)

    @classmethod
    def hard(cls, **kw):
        return cls(center_scale=0.5, latent_noise=1.6, out_noise=1.0, **kw)

    def batch(self, step: int, batch_size: int) -> dict:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 613 + self.host_id + 7) % 2 ** 31)
        per_host = batch_size // self.num_hosts
        y = rng.randint(0, self.num_classes, per_host)
        z = (self.centers[y] * self.center_scale
             + rng.randn(per_host, self.centers.shape[1]) * self.latent_noise)
        h = np.tanh(z @ self.proj1)
        x = (h @ self.proj2 + rng.randn(per_host, self.input_dim)
             * self.out_noise)
        x = x.astype(np.float32)
        if self.image_shape:
            x = x.reshape((per_host,) + tuple(self.image_shape))
        return {"x": x, "y": y.astype(np.int32)}

    def eval_set(self, n: int = 2048) -> dict:
        return self.batch(step=10 ** 6, batch_size=n)
