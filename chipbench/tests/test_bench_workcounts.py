"""The frozen work counts against shapes worked by hand, and the
configuration files against the port's own."""
from __future__ import annotations

import json

from chipbench import harness, workcounts as wc


def test_glu_at_the_main_path():
    # GRANITE_MAIN_PATH: d 16 x 64 = 1024, F 512, 32 experts; all 1024 x 8
    # routed pairs kept
    ops, nbytes = wc.expert_glu(8192, 32, 1024, 512, "float32")
    assert ops == 6 * 1024 * 512 * 8192 == 25_769_803_776
    # rows in and out 2 x 8192 x 1024, weights 32 x (1024 x 1024 + 512 x
    # 1024), 4 bytes each
    assert nbytes == 4 * (16_777_216 + 50_331_648) == 268_435_456
    # bound by bytes: 0.0801 ms at 3.35 TB/s (ops 0.0521 ms at TF32)
    assert abs(wc.bound_s(ops, nbytes, "float32") - 268_435_456 / 3.35e12) \
        < 1e-15


def test_scan_at_zamba2_prefill():
    # (B, T, H, N=P) = (4, 1024, 80, 64), chunk 256, bf16: 4 chunks of
    # 256 steps, 32,896 causal pairs each
    ops, nbytes = wc.ssd_scan(4, 1024, 80, 64, 64, 256, "bfloat16")
    per_chunk = 2 * 32_896 * 128 + 4 * 256 * 64 * 64     # 12,615,680
    assert ops == per_chunk * 4 * 4 * 80 == 16_148_070_400
    # c, b, v, y in bf16; log_a f32; the final state f32
    assert nbytes == (2 * 4 * 1024 * 80 * 256 + 4 * 4 * 1024 * 80
                      + 4 * 4 * 80 * 64 * 64) == 174_325_760
    assert wc.bound_s(ops, nbytes, "bfloat16") == nbytes / 3.35e12


def test_ragged_scan_chunks():
    # 300 steps at chunk 256: a chunk of 256 and one of 44
    ops, _ = wc.ssd_scan(1, 300, 1, 2, 3, 256, "float32")
    assert ops == (256 * 257 * 5 + 4 * 256 * 6) + (44 * 45 * 5 + 4 * 44 * 6)


def test_one_zamba2_layer():
    cfg = json.load(open(harness.BENCH / "configs" / "zamba2-2.7b-port.json"))
    # 4 x 1024 tokens: in_proj 2560 -> 2 x 5120 + 128 + 80 = 10448,
    # conv over 5248 channels x 4 taps, the scan above, out_proj 5120 ->
    # 2560
    tokens = 4096
    want = (2 * tokens * 2560 * 10448 + 2 * tokens * 5248 * 4
            + 16_148_070_400 + 2 * tokens * 5120 * 2560)
    assert wc.zamba2_layer_ops(cfg, 4, 1024) == want
    # the shared block: four projections of 2560 x 2560, 32 heads x 80
    # over 524,800 causal pairs a sequence
    attn = 4 * 2 * tokens * 2560 * 2560 + 4 * 80 * 524_800 * 4 * 32
    assert wc.zamba2_attention_ops(cfg, 4, 1024, 1024) == attn
    assert wc.zamba2_prefill_ops(cfg, 4, 1024) == \
        54 * want + 9 * attn + 2 * 4 * 2560 * 32000
    # a decode step at position 200: the shared block over 201 keys
    step = wc.zamba2_decode_ops(cfg, 32, 200)
    layer = (2 * 32 * 2560 * 10448 + 2 * 32 * 5248 * 4
             + 4 * 32 * 80 * 64 * 64 + 2 * 32 * 5120 * 2560)
    use = 4 * 2 * 32 * 2560 * 2560 + 4 * 80 * 201 * 32 * 32
    assert step == 54 * layer + 9 * use + 2 * 32 * 2560 * 32000


def test_chain_route_ops():
    cfg = json.load(open(harness.BENCH / "configs" / "granite-chain.json"))
    block = wc.chain_block_ops(cfg, 8192)
    assert block["attention"] == 4 * 64 * 524_800 * 16
    assert block["ssd_scan"] == (2 * 2080 * 128 + 4 * 64 * 64 * 64) * 16 * 16
    assert block["router"] == 2 * 1024 * 1024 * 32
    assert block["expert_glu"] == 25_769_803_776
    assert 56e9 < 2 * sum(block.values()) < 58e9


def test_configs_are_the_ports():
    from repro_torch.configs.base import get_config
    from repro_torch.core.modelgraph import GRANITE_MAIN_PATH
    chain = json.load(open(harness.BENCH / "configs" / "granite-chain.json"))
    assert {k: chain[k] for k in GRANITE_MAIN_PATH} == GRANITE_MAIN_PATH
    z = json.load(open(harness.BENCH / "configs" / "zamba2-2.7b-port.json"))
    port = get_config("zamba2-2.7b")
    for k, v in z.items():
        if hasattr(port, k) and k not in ("use_kernels", "source"):
            assert getattr(port, k) == v, k
