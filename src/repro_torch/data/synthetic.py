"""Deterministic synthetic datasets (port of ``repro/data/synthetic.py``).

numpy only, and byte-identical to the reference: the same seed gives the
same arrays in both packages, so the tests feed one dataset to both.

  * ``SyntheticClassification`` — the learnable Gaussian-mixture image
    task that stands in for CIFAR-10/100: each class has a fixed template
    image, a sample is its template plus noise.
  * token batches for the LM families, with a planted bigram rule.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass
class SyntheticClassification:
    num_classes: int = 10
    image_shape: tuple = (32, 32, 3)
    num_train: int = 5000
    num_test: int = 1000
    num_server: int = 2000          # unlabeled server distillation set
    noise: float = 0.6
    seed: int = 0
    _cache: dict = field(default_factory=dict, repr=False)

    def _templates(self, rng):
        """Low-frequency class templates: random 4×4 patterns upsampled to
        image size (nearest), so convolution and pooling keep the class
        signal."""
        h, w, c = self.image_shape
        coarse = rng.normal(0, 1, (self.num_classes, 4, 4, c)).astype(np.float32)
        reps = (h // 4, w // 4)
        return np.kron(coarse, np.ones((1, *reps, 1), np.float32))

    def _make(self, n, seed_off, *, shift: float = 0.0):
        rng = np.random.default_rng(self.seed)
        templates = self._templates(rng)
        rng2 = np.random.default_rng(self.seed + seed_off)
        y = rng2.integers(0, self.num_classes, n)
        x = templates[y] + rng2.normal(0, self.noise, (n, *self.image_shape)).astype(np.float32)
        if shift:
            x = x + shift * rng2.normal(0, 1, (1, *self.image_shape)).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    def train(self):
        if "train" not in self._cache:
            self._cache["train"] = self._make(self.num_train, 1)
        return self._cache["train"]

    def test(self):
        if "test" not in self._cache:
            self._cache["test"] = self._make(self.num_test, 2)
        return self._cache["test"]

    def server_unlabeled(self):
        """Unlabeled distillation set, slightly domain-shifted like the
        paper's CIFAR-100/ImageNet32 server sets; labels are discarded."""
        if "server" not in self._cache:
            x, _ = self._make(self.num_server, 3, shift=0.3)
            self._cache["server"] = x
        return self._cache["server"]

    def client_shard(self, cid: int, n: int):
        """One client's (x, y) shard, generated from (seed, cid) alone;
        each client leans toward two 'home' classes."""
        rng = np.random.default_rng(self.seed)
        templates = self._templates(rng)
        rng_c = np.random.default_rng(
            np.random.SeedSequence([self.seed, 1_000_003, int(cid)]))
        home = rng_c.integers(0, self.num_classes, 2)
        y = np.where(rng_c.random(n) < 0.7,
                     home[rng_c.integers(0, 2, n)],
                     rng_c.integers(0, self.num_classes, n))
        x = templates[y] + rng_c.normal(
            0, self.noise, (n, *self.image_shape)).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)


def batches(x, y, batch_size: int, rng: np.random.Generator):
    """One epoch of shuffled minibatches (drops the ragged tail)."""
    idx = rng.permutation(len(x))
    for i in range(0, len(x) - batch_size + 1, batch_size):
        b = idx[i:i + batch_size]
        yield x[b], y[b]


# ----------------------------------------------------------------- LM data
def make_lm_batch(vocab: int, batch: int, seq: int, seed: int = 0):
    """Deterministic token batch with a planted rule: token 2i is followed by
    token (2i + 7) % vocab half the time — learnable structure."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int64)
    follow = rng.random((batch, seq)) < 0.5
    toks[:, 1:][follow] = (toks[:, :-1][follow] * 2 + 7) % vocab
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


def make_model_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
    """Training batch matching ``Model.loss``'s expectations per family,
    the reference's byte for byte: tokens for the token-input families;
    for audio frame ``embeds``, ``labels`` and a bool ``mask`` of the
    frames to predict (frame 0 always set); for a VLM the token batch plus
    ``min(num_prefix_embeds, seq // 2)`` patch ``embeds``."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        mask = rng.random((batch, seq)) < 0.15
        mask[:, 0] = True  # ensure non-empty
        return {
            "embeds": rng.normal(0, 1, (batch, seq, cfg.frontend_dim)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
            "mask": mask,
        }
    b = make_lm_batch(cfg.vocab_size, batch, seq, seed)
    if cfg.family == "vlm":
        P = min(cfg.num_prefix_embeds, seq // 2)
        b["embeds"] = rng.normal(0, 1, (batch, P, cfg.frontend_dim)).astype(np.float32)
    return b
