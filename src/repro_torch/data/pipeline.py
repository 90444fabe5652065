"""Deterministic synthetic token pipeline with per-host sharding and an
exactly-resumable cursor.

Port of ``repro.data.pipeline``.  Batches are pure NumPy, so they are the
reference's bit for bit:

* determinism: batch ``i`` is a pure function of (seed, i), restart-safe
  and independent of worker count;
* per-host sharding: each process materialises only its slice of the
  global batch (striding by the process index);
* resume: the cursor (= step index) lives in the checkpoint, so a restart
  continues the exact token stream.

The process index and count default to ``torch.distributed``'s rank and
world size when a process group is initialised, else to 0 and 1 (the
reference's ``jax.process_index()`` / ``jax.process_count()``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist


@dataclasses.dataclass
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    # stub-modality inputs (audio/vlm backbones): emit embeddings instead
    embed_dim: int = 0
    encdec: bool = False


def _process() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class SyntheticTokenSource:
    """Batch i is fully determined by (seed, i)."""

    def __init__(self, cfg: DataConfig, process_index: int | None = None,
                 process_count: int | None = None):
        self.cfg = cfg
        rank, world = _process()
        self.pi = rank if process_index is None else process_index
        self.pc = world if process_count is None else process_count
        if cfg.global_batch % self.pc:
            raise ValueError("global batch must divide process count")
        self.local_batch = cfg.global_batch // self.pc

    def __call__(self, step: int) -> dict:
        """Local shard of global batch ``step`` (NumPy arrays)."""
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, self.pi]))
        out: dict = {}
        # a Markov-ish stream so the loss actually decreases in examples
        toks = rng.integers(0, c.vocab, (self.local_batch, c.seq_len + 1),
                            dtype=np.int32)
        toks[:, 1::2] = (toks[:, 0:-1:2] * 31 + 7) % c.vocab  # learnable pairs
        if c.embed_dim:
            out["embeds"] = rng.standard_normal(
                (self.local_batch, c.seq_len, c.embed_dim)).astype(np.float32) * 0.1
        if c.encdec or not c.embed_dim:
            out["tokens"] = toks[:, :-1]
        out["labels"] = toks[:, 1:]
        return out

    def checkpoint_state(self, step: int) -> dict:
        return {"step": step, "seed": self.cfg.seed}

    @staticmethod
    def resume_step(state: dict) -> int:
        return int(state["step"])
