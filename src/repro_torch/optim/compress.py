"""Top-k gradient compression with error feedback.

Port of ``repro.optim.compress``.  Magnitude top-k sparsification with an
error-feedback accumulator (Stich et al., "Sparsified SGD with Memory")
cuts the synchronized bytes by 1/k_frac:

    e_t   <- e_{t-1} + g_t          (accumulate into the residual)
    s_t   <- topk_mask(e_t)         (what gets synchronized)
    e_t   <- e_t - s_t              (what stays local)

The compressed tensor is materialised densely (mask * values); the math
(what the optimizer sees, what the residual carries) is the deployed
algorithm.  Off by default; enable via
``TrainConfig(compress=CompressionConfig(...))``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.model import tree_leaves, tree_map, unzip

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    k_frac: float = 0.1          # fraction of entries synchronized
    min_size: int = 4096         # leaves smaller than this pass through


def init_residual(params) -> Any:
    """Error-feedback accumulators, one per parameter leaf (f32)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def _topk_mask(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    """Boolean mask keeping the k largest-magnitude entries of ``x``."""
    n = x.numel()
    k = max(int(n * k_frac), 1)
    flat = torch.abs(x.reshape(-1))
    # threshold = k-th largest magnitude, a value (the order topk gives
    # ties does not matter); ties keep >= threshold (may pass marginally
    # more than k entries, harmless for error feedback)
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x) >= thresh) & (thresh > 0)


@torch.no_grad()
def compress(cfg: CompressionConfig, grads, residual):
    """(synchronized_grads, new_residual).

    Leaves below ``min_size`` are synchronized exactly (their bytes are
    negligible and biasing tiny norm/bias vectors hurts).
    """
    def one(g, e):
        g32 = g.to(F32)
        if g.numel() < cfg.min_size or cfg.k_frac >= 1.0:
            return g32, torch.zeros_like(e)
        acc = e + g32
        mask = _topk_mask(acc, cfg.k_frac)
        sent = torch.where(mask, acc, torch.zeros((), dtype=F32,
                                                  device=acc.device))
        return sent, acc - sent

    out = tree_map(one, grads, residual)
    return unzip(out, 0), unzip(out, 1)


def compression_ratio(cfg: CompressionConfig, params) -> float:
    """Fraction of gradient bytes actually synchronized."""
    total = kept = 0
    for p in tree_leaves(params):
        n = p.numel()
        total += n
        kept += n if n < cfg.min_size else int(n * cfg.k_frac)
    return kept / max(total, 1)
