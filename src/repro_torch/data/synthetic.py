"""Deterministic synthetic token batches (port of ``repro/data/synthetic.py``).

numpy only, and byte-identical to the reference for the token families:
the same seed gives the same prompts in both packages, so the serving
tests feed one request mix to both.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig


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
    """Token batch for a token-input family (the audio and VLM frontends
    arrive with a later slice)."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.family} batches arrive with the slice that ports the "
            f"modality frontends")
    return make_lm_batch(cfg.vocab_size, batch, seq, seed)
