"""Deterministic synthetic datasets (the JAX package's
`repro/data/synthetic.py`, the same numpy generators, so both packages
train on the same tokens and images bit for bit).

SyntheticLM emits token streams with learnable structure (a Zipf unigram
prior, first-order Markov chains and induction-style copies), so
cross-entropy falls during training; SyntheticImages emits class-dependent
smooth random fields plus noise for the ResNet runs. Batches are tensors on
the device the caller asks for.

make_noniid_class_partition breaks the paper's iid assumption on purpose
(each virtual node sees a skewed class marginal) for the ablation.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    seed: int = 0
    n_states: int = 64          # Markov states
    copy_prob: float = 0.25     # induction pattern density

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V, M = self.vocab_size, min(self.n_states, self.vocab_size)
        # sparse-ish Markov transition over M frequent tokens
        trans = rng.dirichlet(np.full(M, 0.3), size=M).astype(np.float32)
        self._trans_cum = np.cumsum(trans, axis=1)
        # Zipf tail over the rest of the vocab
        ranks = np.arange(1, V + 1)
        zipf = 1.0 / ranks ** 1.2
        self._zipf_cum = np.cumsum(zipf / zipf.sum()).astype(np.float64)
        self._M = M

    def batch(self, batch_size: int, step: int, device="cpu"):
        """Returns dict(tokens (B,S) int32, labels (B,S) int32) on `device`.
        labels are next-token targets (shifted), last position ignored
        (-1)."""
        rng = np.random.default_rng((self.seed, step))
        B, S, M = batch_size, self.seq_len, self._M
        toks = np.empty((B, S + 1), np.int64)
        state = rng.integers(0, M, size=B)
        toks[:, 0] = state
        u = rng.random((B, S))
        mix = rng.random((B, S))
        zipf_draw = np.searchsorted(self._zipf_cum, rng.random((B, S)))
        for t in range(1, S + 1):
            nxt = np.array([np.searchsorted(self._trans_cum[s], x)
                            for s, x in zip(state, u[:, t - 1])])
            nxt = np.minimum(nxt, M - 1)
            # occasionally jump to a zipf token (keeps full vocab in play)
            jump = mix[:, t - 1] < 0.15
            nxt = np.where(jump, zipf_draw[:, t - 1], nxt)
            # induction: with copy_prob, repeat the token seen 8 steps ago
            if t > 8:
                copy = mix[:, t - 1] > 1.0 - self.copy_prob
                nxt = np.where(copy, toks[:, t - 8], nxt)
            state = np.minimum(nxt, M - 1)
            toks[:, t] = nxt
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": torch.from_numpy(tokens).to(device),
                "labels": torch.from_numpy(labels).to(device)}


@dataclass
class SyntheticImages:
    n_classes: int
    image_size: int = 32
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # class prototypes: smooth random fields
        base = rng.normal(size=(self.n_classes, self.image_size,
                                self.image_size, 3)).astype(np.float32)
        k = np.ones((5, 5)) / 25.0
        for c in range(self.n_classes):
            for ch in range(3):
                base[c, :, :, ch] = _conv2d_same(base[c, :, :, ch], k)
        self._protos = base * 3.0

    def batch(self, batch_size: int, step: int, class_weights=None, device="cpu"):
        """Returns dict(images (B,H,W,3) f32, labels (B,) int32) on `device`;
        `class_weights` (n_classes,) draws the labels from that marginal."""
        rng = np.random.default_rng((self.seed, step))
        if class_weights is None:
            labels = rng.integers(0, self.n_classes, size=batch_size)
        else:
            labels = rng.choice(self.n_classes, size=batch_size,
                                p=class_weights)
        noise = rng.normal(size=(batch_size, self.image_size,
                                 self.image_size, 3)).astype(np.float32)
        imgs = self._protos[labels] + noise
        return {"images": torch.from_numpy(imgs).to(device),
                "labels": torch.from_numpy(labels.astype(np.int32)).to(device)}


def _conv2d_same(x, k):
    from numpy.lib.stride_tricks import sliding_window_view
    ph, pw = k.shape[0] // 2, k.shape[1] // 2
    xp = np.pad(x, ((ph, ph), (pw, pw)), mode="reflect")
    win = sliding_window_view(xp, k.shape)
    return np.einsum("ijkl,kl->ij", win, k)


def make_noniid_class_partition(n_classes: int, n_nodes: int,
                                alpha: float = 0.3, seed: int = 0):
    """Dirichlet class-skew per node (breaks iid): returns (n_nodes, n_classes)
    class weight rows."""
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.full(n_classes, alpha), size=n_nodes)
    return w.astype(np.float64) / w.sum(axis=1, keepdims=True)
