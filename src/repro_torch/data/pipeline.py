"""Deterministic synthetic LM data pipeline, host-shardable (the port's
copy of the reference's ``data/pipeline.py``: NumPy only, the same rows
bit for bit).

Tokens are a stateless function of (seed, step, global position) via
numpy's Philox counter RNG, so every host can generate exactly its shard of
the global batch without communication, any step can be regenerated after a
restart (fault tolerance!), and runs are bit-reproducible.

The stream is a Zipf-ish unigram mix with in-sequence repetition so a tiny
LM actually has something learnable (pure uniform tokens give a flat loss);
labels are next-token shifted.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    repeat_p: float = 0.3        # P(copy an earlier token) — learnable signal

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count

    def _row(self, row_id: int) -> np.ndarray:
        """One sequence, a pure function of (seed, global row id)."""
        S = self.seq_len
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, 0, row_id]))
        u = rng.random(S + 1)
        toks = np.minimum((self.vocab - 1) * u ** 3, self.vocab - 1
                          ).astype(np.int32)
        rep = rng.random(S + 1) < self.repeat_p
        lag = rng.integers(1, 9, S + 1)
        idx = np.clip(np.arange(S + 1) - lag, 0, None)
        return np.where(rep, toks[idx], toks)

    def batch(self, step: int) -> dict:
        """-> {'tokens': [local_B, S] i32, 'labels': [local_B, S] i32}.

        Row r of the GLOBAL batch is a pure function of
        (seed, step * global_batch + r): every host generates exactly its
        shard, and any batch can be regenerated after a restart.
        """
        B = self.local_batch
        first_row = step * self.global_batch + self.host_index * B
        toks = np.stack([self._row(first_row + i) for i in range(B)])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def microbatched(self, step: int, accum: int) -> dict:
        """-> arrays shaped [accum, local_B // accum, S]."""
        b = self.batch(step)
        B = self.local_batch
        assert B % accum == 0
        return {k: v.reshape(accum, B // accum, self.seq_len)
                for k, v in b.items()}


def make_batch(cfg, B: int, S: int, seed: int = 0, accum: int = 0) -> dict:
    """Convenience: full input dict for an arch (stub modality frontends)."""
    pipe = SyntheticLM(cfg.vocab, S, B, seed=seed)
    batch = pipe.microbatched(0, accum) if accum else pipe.batch(0)
    lead = (accum, B // accum) if accum else (B,)
    rng = np.random.default_rng(seed + 1)
    if cfg.family == "encdec":
        batch["audio_embeds"] = rng.normal(
            size=lead + (cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = rng.normal(
            size=lead + (cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return batch
