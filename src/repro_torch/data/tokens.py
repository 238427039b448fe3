"""Deterministic synthetic LM token pipeline (port of
``repro.data.tokens``; numpy, the reference's code).

Each data-parallel host owns a disjoint shard of the global batch,
derived purely from (step, shard_index), so a restarted worker
regenerates exactly its shard with no shared state. A tokenized-corpus
reader would replace ``_tokens_for`` and keep the same (step, shard) ->
batch contract. The batches are numpy int32; the train step moves them to
the model's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    shards: int = 1
    seed: int = 17


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig):
        if cfg.global_batch % cfg.shards:
            raise ValueError(f"global batch {cfg.global_batch} is not a multiple of "
                             f"{cfg.shards} shards")
        self.cfg = cfg
        self.per_shard = cfg.global_batch // cfg.shards

    def _tokens_for(self, step: int, shard: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.Generator(
            np.random.PCG64(((cfg.seed * 1_000_003 + step) << 16) | shard))
        # zipf-ish marginals so the loss curve is non-trivial
        z = rng.zipf(1.3, size=(self.per_shard, cfg.seq_len + 1))
        return np.minimum(z - 1, cfg.vocab_size - 1).astype(np.int32)

    def batch(self, step: int, shard: int = 0) -> dict[str, np.ndarray]:
        toks = self._tokens_for(step, shard)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def global_batch(self, step: int) -> dict[str, np.ndarray]:
        parts = [self.batch(step, s) for s in range(self.cfg.shards)]
        return {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}
