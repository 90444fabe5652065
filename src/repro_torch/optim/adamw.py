"""AdamW with global-norm clipping, a warmup + cosine LR schedule and an
optional state-dtype downcast (bf16 m/v for the largest configs).

Port of ``repro.optim.adamw``: functions on the port's dict trees of
tensors, not a ``torch.optim`` subclass, so the state is the reference's
``{"mu", "nu", "step"}`` tree and checkpoints interchange.  The update
runs in f32 whatever the parameter and state dtypes; ``step`` is int32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.model import tree_leaves, tree_map, unzip

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"   # "bfloat16" for the giant configs


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, in f32 (``step``: an int or a
    tensor)."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    # the cosine of the f32 angle, rounded once to f32 (torch's f32 cos
    # is off by an ulp at some angles)
    cos = 0.5 * (1 + torch.cos((math.pi * prog).double()).to(F32))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def init_state(cfg: AdamWConfig, params) -> dict:
    dt = getattr(torch, cfg.state_dtype)
    device = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads,
                  state) -> tuple[Any, dict, dict]:
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm else 1.0
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(F32)
    bc2 = 1 - b2 ** step.to(F32)
    sdt = getattr(torch, cfg.state_dtype)

    def upd(p, g, mu, nu):
        g = g.to(F32) * scale
        mu32 = mu.to(F32) * b1 + (1 - b1) * g
        nu32 = nu.to(F32) * b2 + (1 - b2) * g * g
        mhat = mu32 / bc1
        nhat = nu32 / bc2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:   # decay matrices only
            delta = delta + cfg.weight_decay * p.to(F32)
        return ((p.to(F32) - lr * delta).to(p.dtype), mu32.to(sdt),
                nu32.to(sdt))

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    new_state = {"mu": unzip(out, 1), "nu": unzip(out, 2), "step": step}
    return unzip(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}
