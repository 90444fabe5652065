"""``trace_fused_ops`` against the reference's.

* the reference's two tests (``tests/test_executor_profiler.py``) for the
  port: a 3-matmul MLP gives 3 fused matmul ops in a chain with the
  elementwise FLOPs attributed; a higher-order ``scan`` (the counterpart
  of ``jax.lax.scan``) gives a ``scan`` op;
* the kinds sequence of a reduced Llama forward equals the reference's.
  The reference scans over the layers (one ``scan`` op in its jaxpr); the
  port loops over them, so the reference's sequence is compared with its
  ``scan`` replaced by the reference's own trace of one layer body, once
  per layer.  The reference's jaxpr holds the embedding lookup inside a
  nested ``jit`` call, which its walk (recursing into ``pjit``, that
  primitive's older name) leaves fused and unseen; the port sees the
  lookup as the leading ``gather``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_config
from repro.core.profiler import trace_fused_ops as ref_trace
from repro.models import layers as RL
from repro.models import model as RM
from repro.sharding import NO_POLICY as REF_NO_POLICY
from repro_torch.configs import get_config
from repro_torch.core import trace_fused_ops
from repro_torch.models import model as M


def test_trace_fused_ops_mlp():
    def mlp(x, w1, w2, w3):
        h = F.silu(x @ w1)
        h = h * torch.sigmoid(h @ w2)
        return h @ w3

    x = torch.ones((2, 8))
    w = [torch.ones((8, 8))] * 3
    g = trace_fused_ops(mlp, x, *w)
    kinds = [o.kind for o in g.ops]
    assert kinds.count("matmul") == 3
    assert g.is_chain()
    assert any(o.flops > 2 * 2 * 8 * 8 for o in g.ops if o.kind == "matmul")


def test_trace_fused_ops_scan():
    from torch._higher_order_ops.scan import scan

    def f(x):
        def step(c, xi):
            c = 0.5 * c + xi
            return c, c.clone()
        _, ys = scan(step, torch.zeros(x.shape[1:]), x)
        return ys.sum()

    g = trace_fused_ops(f, torch.ones((16, 4)))
    assert any(o.kind == "scan" for o in g.ops)


def test_mlp_kinds_equal_the_reference():
    def mlp(x, w1, w2, w3):
        h = F.silu(x @ w1)
        h = h * torch.sigmoid(h @ w2)
        return h @ w3

    def ref_mlp(x, w1, w2, w3):
        h = jax.nn.silu(x @ w1)
        h = h * jax.nn.sigmoid(h @ w2)
        return h @ w3

    g = trace_fused_ops(mlp, torch.ones((2, 8)), *[torch.ones((8, 8))] * 3)
    rg = ref_trace(ref_mlp, jnp.ones((2, 8)), *[jnp.ones((8, 8))] * 3)
    assert [o.kind for o in g.ops] == [o.kind for o in rg.ops]
    assert [o.out_shape for o in g.ops] == [o.out_shape for o in rg.ops]


def test_reduced_llama_forward_kinds_equal_the_reference():
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype="float32")
    rcfg = dataclasses.replace(ref_config("llama3.2-1b").reduced(),
                               dtype="float32")
    B, T = 2, 16
    tokens = np.arange(B * T, dtype=np.int32).reshape(B, T) % cfg.vocab
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    port = trace_fused_ops(
        lambda p, t: M.forward(cfg, p, {"tokens": t})[0], params,
        torch.from_numpy(tokens))

    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    ref = ref_trace(lambda p, t: RM.forward(rcfg, p, {"tokens": t})[0],
                    rparams, jnp.asarray(tokens))
    # one layer body of the reference, as its scan runs it
    lp = jax.tree.map(lambda x: x[0], rparams["blocks"])
    pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    h = jnp.zeros((B, T, rcfg.d_model), jnp.float32)

    def body(h, lp):
        eps = rcfg.norm_eps
        a, _ = RL.gqa_attention(lp["attn"], RL.rms_norm(h, lp["ln1"], eps),
                                rcfg, REF_NO_POLICY, positions=pos)
        h = h + a
        m = RL.swiglu_mlp(lp["mlp"], RL.rms_norm(h, lp["ln2"], eps),
                          REF_NO_POLICY)
        return h + m

    layer = [o.kind for o in ref_trace(body, h, lp).ops]
    expected = []
    for o in ref.ops:
        expected += layer * cfg.n_layers if o.kind == "scan" else [o.kind]
    assert [o.kind for o in port.ops] == ["gather"] + expected
    assert sum(k == "matmul" for k in expected) >= 6 * cfg.n_layers + 1
