"""Deterministic, shardable synthetic LM data pipeline: the JAX package's
``data/pipeline.py``, numpy only, so its tokens are bit-equal to the
reference's.

Tokens are a stateless function of (step, position): any host can
materialize exactly its shard for any step, which makes the pipeline
elastic (restore on a different host count reproduces the same global
batch) and checkpoint-free (only the step index needs saving).  The
stream is a Zipf-ish mixture with local n-gram structure, so a model has
something to learn.  Batches are numpy; the train step places them on its
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _tokens(step: int, global_batch: int, seq: int, vocab: int,
            seed: int) -> np.ndarray:
    """Tokens for the FULL global batch: a pure function of (step, seed),
    independent of how it is later sliced (shard invariance)."""
    rng = np.random.Generator(np.random.Philox(key=seed * 1_000_003 + step))
    # per-row base offset gives each sequence its own "topic"
    base = rng.integers(0, vocab, size=(global_batch, 1))
    noise = rng.integers(0, vocab, size=(global_batch, seq))
    ar = np.cumsum(rng.integers(0, 7, size=(global_batch, seq)), axis=1)
    toks = (base + ar + (noise % 13)) % vocab
    return toks.astype(np.int32)


def batch_for_step(step: int, *, global_batch: int, seq: int, vocab: int,
                   seed: int = 0, shard: tuple[int, int] = (0, 1)) -> dict:
    """Returns this shard's slice of the global batch for ``step``.
    ``shard=(index, count)`` slices the batch dimension; any sharding of
    the same (step, seed) reproduces the same global batch."""
    idx, count = shard
    assert global_batch % count == 0
    rows_per = global_batch // count
    toks = _tokens(step, global_batch, seq + 1, vocab, seed)
    toks = toks[idx * rows_per:(idx + 1) * rows_per]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class SyntheticLMDataset:
    global_batch: int
    seq: int
    vocab: int
    seed: int = 0
    step: int = 0
    shard: tuple[int, int] = (0, 1)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = batch_for_step(self.step, global_batch=self.global_batch,
                           seq=self.seq, vocab=self.vocab, seed=self.seed,
                           shard=self.shard)
        self.step += 1
        return b

    # -- checkpointable state ------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, s: dict) -> None:
        self.step = int(s["step"])
