"""Shape cells + ``meta``-device input specs per (arch x shape).

Port of ``repro.launch.specs``: ``input_specs`` gives tensors on the
``meta`` device (shapes and dtypes, no storage) where the reference gives
``ShapeDtypeStruct``s, and the hardware constants are the H100's.

The four assigned shape cells (LM shapes are seq_len x global_batch):

* train_4k    — seq 4096,   batch 256  -> lowers ``train_step``
* prefill_32k — seq 32768,  batch 32   -> lowers ``prefill``
* decode_32k  — seq 32768,  batch 128  -> lowers ``serve_step`` (1 token)
* long_500k   — seq 524288, batch 1    -> serve_step; **runs only for the
  sub-quadratic archs** (xlstm, zamba2) — full-attention archs skip it per
  the assignment (noted in DESIGN.md).

``[audio]``/``[vlm]`` archs get stub modality inputs: ``input_specs``
provides precomputed frame/patch embeddings.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import model as M


def ShapeDtype(shape, dtype) -> torch.Tensor:
    """A shapes-only stand-in: an empty tensor on the ``meta`` device."""
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPE_CELLS: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg, cell: ShapeCell) -> tuple[bool, str]:
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k dense KV is the quadratic regime the assignment excludes"
    return True, ""


def input_specs(cfg, cell: ShapeCell) -> dict:
    """``meta`` stand-ins for every model input of this cell."""
    B, S = cell.batch, cell.seq
    i32 = torch.int32
    dt = cfg.torch_dtype
    if cell.kind == "train":
        batch = {}
        if cfg.block_pattern == "encdec":
            batch["embeds"] = ShapeDtype((B, S, cfg.d_model), dt)
            batch["tokens"] = ShapeDtype((B, S), i32)
        elif cfg.modality_stub:
            batch["embeds"] = ShapeDtype((B, S, cfg.d_model), dt)
        else:
            batch["tokens"] = ShapeDtype((B, S), i32)
        batch["labels"] = ShapeDtype((B, S), i32)
        return {"batch": batch}
    if cell.kind == "prefill":
        batch = {}
        if cfg.block_pattern == "encdec":
            batch["embeds"] = ShapeDtype((B, S, cfg.d_model), dt)
            batch["tokens"] = ShapeDtype((B, S), i32)
        elif cfg.modality_stub:
            batch["embeds"] = ShapeDtype((B, S, cfg.d_model), dt)
        else:
            batch["tokens"] = ShapeDtype((B, S), i32)
        return {"batch": batch, "max_len": S}
    if cell.kind == "decode":
        cache = M.init_cache(cfg, B, S, "meta")
        batch = {"tokens": ShapeDtype((B, 1), i32)}
        if cfg.modality_stub and cfg.block_pattern != "encdec":
            # VLM backbone decodes text tokens; embed table exists
            batch = {"tokens": ShapeDtype((B, 1), i32)}
        return {"batch": batch, "cache": cache}
    raise ValueError(cell.kind)


# hardware constants: NVIDIA H100 SXM (the card the port runs on); the
# same values and sources as repro_torch.core.autoshard
PEAK_FLOPS = 989e12        # bf16 dense FLOP/s per GPU (H100 data sheet)
HBM_BW = 3.35e12           # B/s per GPU, HBM3 (H100 data sheet)
LINK_BW = 50e9             # B/s per GPU, InfiniBand NDR 400 Gb/s: the
                           # slowest link a 16-wide ring crosses
NVLINK_BW = 450e9          # B/s per GPU per direction inside a board
CHIP_POWER = 700.0         # W, board power limit (H100 data sheet, SXM)


def model_flops(cfg, cell: ShapeCell) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for the step.

    For train cells D = processed tokens and the 6x covers fwd+bwd; for
    prefill 2*N*D (fwd only); for decode D = new tokens (=batch)."""
    n_params = cfg.param_count()
    if cfg.n_experts:
        # subtract inactive routed-expert params
        d = cfg.d_model
        moe_layers = cfg.n_layers - cfg.first_k_dense
        routed = moe_layers * cfg.n_experts * 3 * d * cfg.moe_d_ff
        active = moe_layers * cfg.moe_top_k * 3 * d * cfg.moe_d_ff
        n_active = n_params - routed + active
    else:
        n_active = n_params
    if cell.kind == "train":
        tokens = cell.batch * cell.seq
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.batch * cell.seq
        return 2.0 * n_active * tokens
    # decode: one token per sequence; embedding params don't matmul
    return 2.0 * n_active * cell.batch
