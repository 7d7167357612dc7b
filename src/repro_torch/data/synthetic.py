"""SyntheticMnist: a 10-class 28x28 image set standing in for MNIST offline
(class-conditional fixed patterns + deformation noise). The paper's
float-vs-hybrid accuracy protocol runs on it.

A copy of repro/data/synthetic.py's numpy half, so that this package
imports nothing from repro: the same seed gives the same images and the
same batches in both packages.
"""

from __future__ import annotations

import numpy as np


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
