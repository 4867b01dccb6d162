"""Deterministic synthetic LM batches, counterpart of
``repro.data.pipeline.TokenPipeline``.

Host numpy, the reference's draws in the reference's order: ``batch(step)``
and ``global_batch(step)`` give the reference's arrays bit for bit, per
(seed, step, shard), so a restarted run replays the same data whatever
the number of shards.  ``TensorStream``, ``NonzeroStore`` and
``StratumPrefetcher`` are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic corpus: Zipf-ish unigram + bigram mixture so losses move
    zipf_a: float = 1.2


class TokenPipeline:
    """Deterministic synthetic LM token stream (host-side numpy)."""

    def __init__(self, cfg: TokenPipelineConfig,
                 shard: int = 0, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {num_shards} shards")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        # fixed unigram distribution (vocab-sized)
        rng = np.random.default_rng(cfg.seed)
        w = rng.zipf(cfg.zipf_a, size=cfg.vocab_size * 4) % cfg.vocab_size
        hist = np.bincount(w, minlength=cfg.vocab_size).astype(np.float64)
        self.probs = hist / hist.sum()

    def batch(self, step: int) -> dict:
        """Batch for ``step`` — identical across runs / topologies."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.shard, 0xBEEF))
        toks = rng.choice(
            cfg.vocab_size, p=self.probs,
            size=(self.local_batch, cfg.seq_len + 1),
        ).astype(np.int32)
        # light bigram structure: every even position correlates w/ previous
        toks[:, 2::2] = (toks[:, 1:-1:2] * 31 + 7) % cfg.vocab_size
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }

    def global_batch(self, step: int) -> dict:
        """All shards concatenated (single-host testing)."""
        parts = [
            TokenPipeline(self.cfg, s, self.num_shards).batch(step)
            for s in range(self.num_shards)
        ]
        return {
            k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0]
        }
