"""Token data pipeline: deterministic synthetic LM stream (zipfian tokens
with local structure), sharded global batches, and whisper-style
(embedding, token) pairs for the enc-dec / frontend-stub architectures."""
from __future__ import annotations

from typing import Optional

import numpy as np


class TokenDataset:
    """Deterministic pseudo-corpus: zipf-distributed tokens with Markov-ish
    bigram structure so the LM loss is learnable (tests assert it drops)."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        # bigram successor table: each token has a few likely successors
        self._succ = rng.integers(0, vocab_size, (vocab_size, 4))
        self._zipf_p = 1.0 / np.arange(1, vocab_size + 1)
        self._zipf_p /= self._zipf_p.sum()

    def batch(self, batch_size: int, seq_len: int, step: int) -> np.ndarray:
        """[B, seq_len+1] int32 (inputs + shifted labels)."""
        rng = np.random.default_rng(hash((step, 7)) % (2 ** 31))
        out = np.empty((batch_size, seq_len + 1), np.int32)
        tok = rng.choice(self.vocab, size=batch_size, p=self._zipf_p)
        for t in range(seq_len + 1):
            out[:, t] = tok
            branch = rng.random(batch_size) < 0.8
            succ_idx = rng.integers(0, 4, batch_size)
            nxt_struct = self._succ[tok, succ_idx]
            nxt_rand = rng.choice(self.vocab, size=batch_size, p=self._zipf_p)
            tok = np.where(branch, nxt_struct, nxt_rand)
        return out


def make_train_batch(cfg, batch_size: int, seq_len: int, step: int,
                     dataset: Optional[TokenDataset] = None):
    """Returns the model's `loss()` batch dict for any architecture family."""
    ds = dataset or TokenDataset(cfg.vocab_size, seed=0)
    tokens = ds.batch(batch_size, seq_len, step)
    if cfg.enc_dec:
        rng = np.random.default_rng(step)
        enc_len = min(cfg.enc_seq_len or 64, 64)
        enc = rng.standard_normal((batch_size, enc_len, cfg.d_model)).astype(np.float32)
        return {"enc_emb": enc, "tokens": tokens}
    return {"tokens": tokens}
