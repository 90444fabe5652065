"""Fixtures of the benchmark's CPU tests: the cells at tiny sizes on the
host, through the same harness the chip runs."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the chain at CHAIN_DEFAULTS' sizes on the host lanes, and the Zamba2
# pattern at the port's reduced widths
TINY = {
    "granite-chain": dict(blocks=2, batch=1, seq=64, heads=2, head_dim=16,
                          state=8, experts=4, top_k=2, moe_ff=16, chunk=32,
                          min_capacity=16,
                          lanes=["numpy-eager", "torch-cpu"]),
    "zamba2-2.7b-port": dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                        d_head=16, vocab=256, ssm_state=16,
                        ssm_headdim=16, ssm_chunk=16, zamba_attn_every=2),
}
TINY_GENERATE = dict(batch=3, prompt_len=24, new_tokens=5, check_batches=2,
                     check_rows=3)


def tiny_spec(cell: str, **config) -> dict:
    """The cell's spec with its configuration and traffic cut to tiny
    sizes (``config`` overrides further fields)."""
    from chipbench import harness
    spec = harness.cell_spec(harness.load_manifest(), cell)
    spec["config"].update(TINY[spec["config_name"]], **config)
    if spec["traffic"]["kind"] == "closed_generate":
        spec["traffic"].update(TINY_GENERATE)
    return spec


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
