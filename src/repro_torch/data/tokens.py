"""Deterministic synthetic LM token pipeline with skip-ahead (port of
``repro.data.tokens``: numpy only, the same draws, so every batch equals the
reference's bit for bit).

Every batch is a pure function of (seed, step) so a restarted trainer can
resume mid-epoch without replaying — the skip-ahead contract production
loaders implement (tf.data checkpointing / grain index semantics).

The synthetic distribution is a Zipf-ish unigram mixture with induced
bigram structure so cross-entropy has meaningful, monotonically learnable
signal (unlike uniform noise). :func:`to_device` moves a batch onto a
device as tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.config import ModelConfig


class TokenStream:
    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        V = cfg.vocab
        rng = np.random.default_rng(seed)
        probs = 1.0 / np.arange(1, V + 1) ** 1.1
        self.unigram = probs / probs.sum()
        # deterministic 'successor' map inducing bigram structure
        self.successor = rng.permutation(V)

    def batch_at(self, step: int) -> dict:
        """The batch of ``step`` as numpy arrays: int32 ``tokens`` and
        ``labels`` [B, S] (audio [B, S, ncb]); the VLM adds float32
        ``vision`` [B, Nv, vision_dim]; MoE with MTP adds ``tokens_next``
        and ``labels_mtp``."""
        rng = np.random.default_rng((self.seed, step))
        B, S = self.batch, self.seq_len
        V = self.cfg.vocab
        first = rng.choice(V, size=(B, 1), p=self.unigram)
        noise = rng.choice(V, size=(B, S), p=self.unigram)
        copy_mask = rng.random((B, S)) < 0.5
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = first[:, 0]
        for t in range(1, S):
            toks[:, t] = np.where(copy_mask[:, t],
                                  self.successor[toks[:, t - 1]],
                                  noise[:, t])
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = toks[:, 0]
        batch = {"tokens": toks, "labels": labels}
        if self.cfg.family == "audio":
            nc = self.cfg.n_codebooks
            toks_a = rng.integers(0, V, size=(B, S, nc), dtype=np.int32)
            batch = {"tokens": toks_a,
                     "labels": np.roll(toks_a, -1, axis=1)}
        if self.cfg.family == "vlm":
            batch["vision"] = rng.standard_normal(
                (B, self.cfg.n_vision_tokens, self.cfg.vision_dim)
            ).astype(np.float32)
        if self.cfg.family == "moe" and self.cfg.mtp_depth:
            batch["tokens_next"] = labels
            batch["labels_mtp"] = np.roll(toks, -2, axis=1)
        return batch

    def stream(self, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device`` (integer arrays int32, float
    arrays float32; the model casts ``vision`` to its dtype). From the
    host the copy goes through pinned memory and does not block the
    caller."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out
