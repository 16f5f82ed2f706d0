"""Deterministic synthetic token pipeline (counterpart of
``repro.data.pipeline``).

Batches are a pure function of (seed, step), so a restarted job replays the
exact same stream from its restored step: the restart-exactness property
the checkpointing layer relies on (no data-loader state to snapshot).  The
rows are drawn on the host by the reference's numpy generators, so a batch
holds the same token ids in both packages, and land on ``device`` as
int64 tensors.

With ``mesh=`` (a ``DeviceMesh``) and ``batch_spec=`` (the batch's
``PartitionSpec``, ``sharding.partition.batch_pspec``) each rank builds
only its own rows of the global batch: the rows of the reference's
addressable shard at the same mesh position (``jax.make_array_from_callback``
builds each shard from the same rows), for the sharded train step.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SyntheticTokens"]


class SyntheticTokens:
    """Zipf-ish synthetic LM tokens with next-token labels."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, device="cuda", mesh=None, batch_spec=None):
        from repro_torch.core import distributed as D
        from repro_torch.core.engine import resolve_device

        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.device = resolve_device(device)
        self.rows = (0, global_batch)
        if mesh is not None:
            spec = batch_spec if batch_spec is not None else D.P(None)
            rows = D._block(torch.arange(global_batch), mesh, spec[:1],
                            "the batch")
            self.rows = (int(rows[0]), int(rows[-1]) + 1)

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
        shifted by one; with a mesh, B is this rank's rows only."""
        arr = torch.from_numpy(self._host_batch(step, *self.rows)).long()
        arr = arr.to(self.device)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
