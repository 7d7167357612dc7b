"""Deterministic synthetic data (a copy of repro/data/synthetic.py's numpy
half, so that this package imports nothing from repro: the same seed gives
the same batches in both packages).

* SyntheticTokens — an affine-Markov token stream (next = a*tok + b mod V
  with seeded noise): cheap, host-shardable and learnable, so a trainer
  can be checked for a falling loss. Stateful and checkpointable: state()
  returns a dict that restore() accepts (train/checkpoint.py's meta).
* SyntheticMnist — a 10-class 28x28 image set standing in for MNIST
  offline (class-conditional fixed patterns + deformation noise). The
  paper's float-vs-hybrid accuracy protocol runs on it.
"""

from __future__ import annotations

import numpy as np


class SyntheticTokens:
    def __init__(self, vocab: int, seq_len: int, batch: int, *, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1, noise: float = 0.05):
        assert batch % n_hosts == 0
        self.vocab, self.seq_len = vocab, seq_len
        self.batch_local = batch // n_hosts
        self.seed, self.host_id, self.n_hosts = seed, host_id, n_hosts
        self.noise = noise
        self.step = 0
        # fixed affine map (the learnable structure)
        self.a = 7 % vocab or 1
        self.b = 13 % vocab

    def __iter__(self):
        return self

    def __next__(self):
        rng = np.random.default_rng((self.seed, self.host_id, self.step))
        b, s, v = self.batch_local, self.seq_len, self.vocab
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        for t in range(s):
            nxt = (toks[:, t] * self.a + self.b) % v
            flip = rng.random(b) < self.noise
            nxt = np.where(flip, rng.integers(0, v, size=b), nxt)
            toks[:, t + 1] = nxt
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, st: dict) -> None:
        self.step = int(st["step"])
        self.seed = int(st["seed"])


class SyntheticMnist:
    """28x28, 10 classes; deterministic given seed. Returns flattened
    (B, 784) float images in [-1, 1] and int labels — the paper's MLP input
    format."""

    def __init__(self, *, n_train: int = 8192, n_test: int = 2048,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.protos = rng.normal(0, 1, (10, 28, 28)).astype(np.float32)
        # low-pass the prototypes so classes have structure, not white noise
        k = np.ones((5, 5), np.float32) / 25.0
        for c in range(10):
            self.protos[c] = _conv2d_same(self.protos[c], k)
        self.protos /= np.abs(self.protos).max(axis=(1, 2), keepdims=True)
        self.train = self._make(rng, n_train)
        self.test = self._make(rng, n_test)

    def _make(self, rng, n):
        labels = rng.integers(0, 10, n).astype(np.int32)
        imgs = self.protos[labels]
        # deformations: shifts + pixel noise
        sx = rng.integers(-2, 3, n)
        sy = rng.integers(-2, 3, n)
        out = np.empty((n, 28, 28), np.float32)
        for i in range(n):
            out[i] = np.roll(np.roll(imgs[i], sx[i], 0), sy[i], 1)
        out += rng.normal(0, 0.35, out.shape).astype(np.float32)
        out = np.clip(out, -1, 1)
        return out.reshape(n, 784), labels

    def batches(self, split: str, batch: int, *, seed: int = 0):
        x, y = self.train if split == "train" else self.test
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(x))
        for i in range(0, len(x) - batch + 1, batch):
            j = idx[i:i + batch]
            yield x[j], y[j]


def _conv2d_same(img, k):
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    pad = np.pad(img, ((ph, ph), (pw, pw)))
    out = np.zeros_like(img)
    for i in range(kh):
        for j in range(kw):
            out += k[i, j] * pad[i:i + img.shape[0], j:j + img.shape[1]]
    return out
