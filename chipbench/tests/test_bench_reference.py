"""The plain references against the port's CPU path at tiny sizes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from chipbench import harness
from chipbench.reference import chain as rchain
from chipbench.reference import ops as rops
from chipbench.reference import zamba2 as rzamba2
from chipbench.reference.precision import rounding

from .conftest import TINY

F32 = rounding("float32")


def _sequential_scan(c, b, v, log_a):
    B, T, H, N = b.shape
    S = torch.zeros(B, H, N, v.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(T):
        S = S * torch.exp(log_a[:, t].double())[..., None, None] + \
            torch.einsum("bhn,bhp->bhnp", b[:, t].double(), v[:, t].double())
        ys.append(torch.einsum("bhn,bhnp->bhp", c[:, t].double(), S))
    return torch.stack(ys, 1), S


@pytest.mark.parametrize("T,chunk", [(37, 8), (64, 16), (5, 16)])
def test_scan_reference_is_the_recurrence(T, chunk):
    g = torch.Generator().manual_seed(T)
    c, b = (torch.randn(2, T, 3, 4, generator=g) for _ in range(2))
    v = torch.randn(2, T, 3, 5, generator=g)
    log_a = -0.3 * torch.rand(2, T, 3, generator=g)
    y, S = rops.ssd_scan(c, b, v, log_a, rnd=F32, chunk=chunk)
    y0, S0 = _sequential_scan(c, b, v, log_a)
    assert torch.allclose(y.double(), y0, atol=1e-5, rtol=1e-5)
    assert torch.allclose(S.double(), S0, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("q_offset", [0, 7])
def test_attention_reference_is_the_ports(q_offset):
    from repro_torch.kernels.ref import attention_ref
    g = torch.Generator().manual_seed(q_offset)
    q = torch.randn(2, 9, 4, 8, generator=g)
    k, v = (torch.randn(2, 9 + q_offset, 2, 8, generator=g) for _ in (0, 1))
    got = rops.attention(q, k, v, rnd=F32, q_offset=q_offset, block=4)
    want = attention_ref(q, k, v, causal=True, q_offset=q_offset)
    assert torch.allclose(got, want, atol=1e-6, rtol=1e-5)


def test_chain_reference_is_the_ports_oracle_op_by_op():
    from repro_torch.core.modelgraph import chain_arrays, kernel_chain
    cfg = {k: v for k, v in TINY["granite-chain"].items() if k != "lanes"}
    arrays = chain_arrays(seed=3, **cfg)
    graph, ext = kernel_chain(arrays=arrays, device="cpu", **cfg)
    weights = {k: torch.from_numpy(a) for k, a in arrays.items()}
    x = ext[0][0]
    names = rchain.op_names(cfg)
    assert len(names) == len(graph.ops)
    for op, (j, name) in zip(graph.ops, names):
        assert op.name == f"b{j}.{name}"
        want = op.fn(x)
        got = rchain.op(cfg, weights, j, name, x, F32)
        assert torch.allclose(got, want, atol=1e-5 * float(want.abs().max()),
                              rtol=1e-5), op.name
        x = want


def test_zamba2_reference_is_the_ports_forward_and_serving():
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    spec = harness.cell_spec(harness.load_manifest(), "zamba2-prefill")
    cfg = {**spec["config"], **TINY["zamba2-2.7b-port"], "dtype": "float32"}
    mod = harness.config_module("zamba2-2.7b-port")
    params = mod.draw_params(cfg, 5, torch.device("cpu"))
    mcfg = mod.model_config(cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg["vocab"], (2, 21))).to(torch.int32)
    want = rzamba2.logits(params, tokens, cfg, F32)
    got, _ = M.forward(mcfg, params, {"tokens": tokens})
    assert torch.allclose(got, want, atol=2e-5 * float(want.abs().max()))
    # prefill of 16 tokens, then five decode steps through the engine
    eng = Engine(mcfg, params)
    logits, cache = M.prefill(mcfg, params, {"tokens": tokens[:, :16]},
                              max_len=21)
    rows = [logits[:, -1]]
    step = eng.decode_step_fn()
    for t in range(16, 21):
        logits, cache = step(params, cache, {"tokens": tokens[:, t:t + 1]})
        rows.append(logits[:, -1])
    served = torch.stack(rows[:-1], 1)
    assert torch.allclose(served, want[:, 15:20],
                          atol=2e-5 * float(want.abs().max()))


@pytest.mark.parametrize("tiny", [False, True])
def test_zamba2_tree_is_the_ports(tiny):
    from repro_torch.models import model as M
    spec = harness.cell_spec(harness.load_manifest(), "zamba2-prefill")
    cfg = {**spec["config"], **(TINY["zamba2-2.7b-port"] if tiny else {})}
    mod = harness.config_module("zamba2-2.7b-port")
    want = {p: (tuple(t.shape), str(t.dtype).split(".")[1]) for p, t in
            M.tree_flatten_with_path(M.param_shapes(mod.model_config(cfg)))}
    got = dict(mod._leaves(mod.param_tree(cfg)))
    assert got == want
    params = mod.draw_params({**cfg, **TINY["zamba2-2.7b-port"]}, 1,
                             torch.device("cpu"))
    assert [p for p, _ in M.tree_flatten_with_path(params)] == \
        [p for p, _ in M.tree_flatten_with_path(M.param_shapes(
            mod.model_config({**cfg, **TINY["zamba2-2.7b-port"]})))]


def test_roundings():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10 + 2 ** -12, -3.0, 0.0])
    t = rounding("tf32")(x)
    assert t.tolist() == [1.0, 1.0 + 2 ** -10, -3.0, 0.0]
    y = torch.linspace(-3, 3, 50)[None]
    f = rounding("fp8")(y)
    assert (f - y).abs().max() <= 3 * 2 ** -4 + 1e-6
    assert (f - y).abs().max() > 0
