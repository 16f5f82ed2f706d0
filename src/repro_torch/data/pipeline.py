"""Deterministic synthetic token pipeline (counterpart of
``repro.data.pipeline``).

Batches are a pure function of (seed, step), so a restarted job replays the
exact same stream from its restored step: the restart-exactness property
the checkpointing layer relies on (no data-loader state to snapshot).  The
rows are drawn on the host by the reference's numpy generators, so a batch
holds the same token ids in both packages, and land on ``device`` as
int64 tensors.  The reference's ``mesh=`` / ``batch_spec=`` (each host
building only its shard of a sharded batch) come with the sharded
training (ROADMAP.md queue 1, item 12b).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SyntheticTokens"]


class SyntheticTokens:
    """Zipf-ish synthetic LM tokens with next-token labels."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, device="cuda"):
        from repro_torch.core.engine import resolve_device

        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.device = resolve_device(device)

    def _host_batch(self, step: int, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the global batch at ``step`` (deterministic):
        one generator a row, seeded from (seed, step, row)."""
        out = np.empty((hi - lo, self.seq + 1), np.int32)
        for i, row in enumerate(range(lo, hi)):
            r = np.random.default_rng(
                (np.uint64(self.seed) << np.uint64(20))
                ^ np.uint64(step * 131_071 + row))
            u = r.random(self.seq + 1)
            out[i] = np.minimum((u ** 3.0 * self.vocab).astype(np.int32),
                                self.vocab - 1)
        return out

    def batch_at(self, step: int) -> dict:
        """{"tokens": (B, S), "labels": (B, S)}: the labels are the tokens
        shifted by one."""
        arr = torch.from_numpy(self._host_batch(step, 0, self.batch)).long()
        arr = arr.to(self.device)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
