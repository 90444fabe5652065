"""The port's model-zoo layers against the reference's, in f32.

Two kinds of check, on seeded NumPy inputs:

* parity: each layer of ``repro_torch.models.layers`` on the reference
  layer's own parameters (``repro.models.layers.*_init`` as NumPy) and
  inputs matches ``repro.models.layers`` within atol = rtol = 1e-5,
  prefill and decode (the cache written in place) alike; the kernel
  call sites (``use_flash="pallas"``, ``use_kernel=True``) run the
  reference's Pallas kernels in interpret mode and the port's plain
  versions;
* the reference's layer oracles (``tests/test_models.py``) repeated on
  the port: flash_ref against plain, the chunked recurrence against a
  naive loop, the recurrence step against the chunked tail, MoE with no
  drops against an explicit top-k mixture, MLA absorbed decode against
  the expanded form, and M-RoPE with equal streams against RoPE — at
  the reference's tolerances.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro.sharding import NO_POLICY as REF_POLICY
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models.model import params_from_numpy, tree_leaves
from repro_torch.sharding import NO_POLICY

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float64),
                               np.asarray(want, np.float64), **(tol or TOL))


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _params(init, key, *args):
    p = init(jax.random.PRNGKey(key), *args)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _jit(fn, **static):
    """The reference layer jitted, with ``static`` (configs, flags,
    chunk sizes) bound: one compile instead of op-by-op dispatch."""
    return jax.jit(functools.partial(fn, **static))


def _cfgs(arch, **kw):
    return (dataclasses.replace(ref_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


# ---------------------------------------------------------------------------
# parity with the reference layers
# ---------------------------------------------------------------------------

def test_norms_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, (2, 5, 32)), _rand(rng, (32,)), _rand(rng, (32,))
    _close(L.rms_norm(_t(x), _t(w), 1e-6), RL.rms_norm(x, w, 1e-6))
    _close(L.layer_norm(_t(x), _t(w), _t(b)), RL.layer_norm(x, w, b))
    pos = np.broadcast_to(np.arange(5)[None], (2, 5)).astype(np.int32)
    for theta in (1e4, 5e5):
        cos_r, sin_r = RL.rope_cos_sin(jnp.asarray(pos), 16, theta)
        cos_t, sin_t = L.rope_cos_sin(_t(pos), 16, theta)
        _close(cos_t, cos_r)
        _close(sin_t, sin_r)
        xh = _rand(rng, (2, 5, 3, 16))
        _close(L.apply_rope(_t(xh), cos_t, sin_t),
               RL.apply_rope(xh, cos_r, sin_r))
    pos3 = np.stack([pos, pos + 1, 2 * pos])
    for got, want in zip(L.mrope_cos_sin(_t(pos3), 16, 1e4, (2, 3, 3)),
                         RL.mrope_cos_sin(jnp.asarray(pos3), 16, 1e4,
                                          (2, 3, 3))):
        _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 64, 4, 2, 16), (2, 70, 6, 3, 8)])
def test_attention_oracles_match_reference(causal, shape):
    B, T, Hq, Hk, D = shape
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, (B, T, h, D)) for h in (Hq, Hk, Hk))
    _close(L.plain_attention(_t(q), _t(k), _t(v), causal=causal),
           _jit(RL.plain_attention, causal=causal)(q, k, v))
    _close(L.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                 q_chunk=32, kv_chunk=48),
           _jit(RL.flash_attention_ref, causal=causal, q_chunk=32,
                kv_chunk=48)(q, k, v))
    # decode continuation: q at kv offset 5
    _close(L.flash_attention_ref(_t(q[:, :7]), _t(k), _t(v), causal=True,
                                 q_chunk=4, kv_chunk=16, q_offset=5),
           _jit(RL.flash_attention_ref, causal=True, q_chunk=4, kv_chunk=16,
                q_offset=5)(q[:, :7], k, v))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-8b", "qwen2-vl-72b"])
@pytest.mark.parametrize("use_flash", [None, True, "pallas"])
def test_gqa_attention_matches_reference(arch, use_flash):
    rcfg, cfg = _cfgs(arch)
    pr, pt = _params(RL.gqa_init, 3, rcfg, jnp.float32)
    rng = np.random.default_rng(2)
    B, T = 2, 40
    x = _rand(rng, (B, T, cfg.d_model), 0.5)
    pos = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
    if cfg.mrope:
        pos = np.stack([pos, pos, pos])
    out_r, _ = _jit(RL.gqa_attention, cfg=rcfg, shd=REF_POLICY,
                    use_flash=use_flash)(pr, x, positions=pos)
    out_t, _ = L.gqa_attention(pt, _t(x), cfg, NO_POLICY, positions=_t(pos),
                               use_flash=use_flash)
    _close(out_t, out_r)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-vl-72b"])
def test_gqa_decode_writes_the_cache_as_the_reference(arch):
    rcfg, cfg = _cfgs(arch)
    pr, pt = _params(RL.gqa_init, 4, rcfg, jnp.float32)
    rng = np.random.default_rng(3)
    B, S = 2, 12
    ck = _rand(rng, (B, S, cfg.n_kv_heads, cfg.d_head))
    cv = _rand(rng, (B, S, cfg.n_kv_heads, cfg.d_head))
    cache_r = {"k": ck, "v": cv, "len": jnp.asarray(5, jnp.int32)}
    cache_t = {"k": _t(ck), "v": _t(cv), "len": torch.tensor(5, dtype=torch.int32)}
    k_buf = cache_t["k"]
    step = _jit(RL.gqa_attention, cfg=rcfg, shd=REF_POLICY)
    for t in range(3):
        x = _rand(rng, (B, 1, cfg.d_model), 0.5)
        pos = np.full((B, 1), 5 + t, np.int32)
        if cfg.mrope:
            pos = np.stack([pos, pos, pos])
        out_r, cache_r = step(pr, x, positions=pos, cache=cache_r)
        out_t, cache_t = L.gqa_attention(pt, _t(x), cfg, NO_POLICY,
                                         positions=_t(pos), cache=cache_t)
        _close(out_t, out_r)
        for a, b in zip(tree_leaves(cache_t), jax.tree.leaves(cache_r)):
            _close(a, b)
    assert cache_t["k"] is k_buf                 # written in place
    assert int(cache_t["len"]) == 8


def test_mla_attention_matches_reference_prefill_and_decode():
    rcfg, cfg = _cfgs("deepseek-v3-671b")
    pr, pt = _params(RL.mla_init, 7, rcfg, jnp.float32)
    rng = np.random.default_rng(7)
    B, T = 2, 9
    x = _rand(rng, (B, T, cfg.d_model), 0.2)
    pos = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
    mla = _jit(RL.mla_attention, cfg=rcfg, shd=REF_POLICY)
    out_r, _ = mla(pr, x, positions=pos)
    out_t, _ = L.mla_attention(pt, _t(x), cfg, NO_POLICY, positions=_t(pos))
    _close(out_t, out_r)
    cr = {"c_kv": np.zeros((B, T, cfg.kv_lora_rank), np.float32),
          "k_pe": np.zeros((B, T, cfg.qk_rope_head_dim), np.float32),
          "len": jnp.zeros((), jnp.int32)}
    ct = {"c_kv": _t(cr["c_kv"]), "k_pe": _t(cr["k_pe"]),
          "len": torch.zeros((), dtype=torch.int32)}
    for t in range(T):
        o_r, cr = mla(pr, x[:, t:t + 1], positions=pos[:, t:t + 1], cache=cr)
        o_t, ct = L.mla_attention(pt, _t(x[:, t:t + 1]), cfg, NO_POLICY,
                                  positions=_t(pos[:, t:t + 1]), cache=ct)
        _close(o_t, o_r)
    for a, b in zip(tree_leaves(ct), jax.tree.leaves(cr)):
        _close(a, b)


def test_swiglu_and_cross_attention_match_reference():
    rcfg, cfg = _cfgs("seamless-m4t-medium")
    rng = np.random.default_rng(4)
    x = _rand(rng, (2, 6, cfg.d_model), 0.5)
    mem = _rand(rng, (2, 11, cfg.d_model), 0.5)
    pr, pt = _params(RL.swiglu_init, 5, cfg.d_model, cfg.d_ff, jnp.float32)
    _close(L.swiglu_mlp(pt, _t(x), NO_POLICY), RL.swiglu_mlp(pr, x, REF_POLICY))
    pr, pt = _params(RL.cross_attn_init, 6, rcfg, jnp.float32)
    _close(L.cross_attention(pt, _t(x), _t(mem), cfg, NO_POLICY),
           _jit(RL.cross_attention, cfg=rcfg, shd=REF_POLICY)(pr, x, mem))


@pytest.mark.parametrize("arch,capacity", [("granite-moe-1b-a400m", 8.0),
                                           ("granite-moe-1b-a400m", 0.5),
                                           ("deepseek-v3-671b", 8.0)])
def test_moe_block_matches_reference(arch, capacity):
    rcfg, cfg = _cfgs(arch, moe_capacity_factor=capacity, moe_group_size=16)
    pr, pt = _params(RL.moe_init, 2, rcfg, jnp.float32)
    rng = np.random.default_rng(5)
    x = _rand(rng, (2, 16, cfg.d_model), 0.3)
    out_r, aux_r = _jit(RL.moe_block, cfg=rcfg, shd=REF_POLICY)(pr, x)
    out_t, aux_t = L.moe_block(pt, _t(x), cfg, NO_POLICY)
    _close(out_t, out_r)
    _close(aux_t, aux_r)


@pytest.mark.parametrize("dims", [(1, 32, 2, 4, 8, 8), (2, 50, 3, 8, 4, 16)])
def test_recurrences_match_reference(dims):
    B, T, H, N, P, chunk = dims
    rng = np.random.default_rng(11)
    c, b = _rand(rng, (B, T, H, N)), _rand(rng, (B, T, H, N))
    v = _rand(rng, (B, T, H, P))
    log_a = -np.abs(_rand(rng, (B, T, H))) * 0.5
    s0 = _rand(rng, (B, H, N, P))
    for init in (None, s0):
        y_r, s_r = _jit(RL.chunked_linear_recurrence, chunk=chunk)(
            c, b, v, log_a,
            initial_state=None if init is None else jnp.asarray(init))
        y_t, s_t = L.chunked_linear_recurrence(
            _t(c), _t(b), _t(v), _t(log_a), chunk=chunk,
            initial_state=None if init is None else _t(init))
        _close(y_t, y_r)
        _close(s_t, s_r)
    y_r, s_r = RL.linear_recurrence_step(s0, c[:, 0], b[:, 0], v[:, 0],
                                         log_a[:, 0])
    y_t, s_t = L.linear_recurrence_step(_t(s0), _t(c[:, 0]), _t(b[:, 0]),
                                        _t(v[:, 0]), _t(log_a[:, 0]))
    _close(y_t, y_r)
    _close(s_t, s_r)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_block_matches_reference(use_kernel):
    rcfg, cfg = _cfgs("zamba2-2.7b")
    pr, pt = _params(RL.mamba2_init, 8, rcfg, jnp.float32)
    rng = np.random.default_rng(6)
    B, T = 2, 40
    x = _rand(rng, (B, T, cfg.d_model), 0.5)
    out_r, st_r = _jit(RL.mamba2_block, cfg=rcfg, shd=REF_POLICY,
                       use_kernel=use_kernel)(pr, x)
    out_t, st_t = L.mamba2_block(pt, _t(x), cfg, NO_POLICY, use_kernel=use_kernel)
    _close(out_t, out_r)
    _close(st_t["ssm"], st_r["ssm"])
    # one decode step from a state
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state * cfg.ssm_groups
    state = {"ssm": _rand(rng, st_r["ssm"].shape, 0.1),
             "conv": _rand(rng, (B, cfg.ssm_conv - 1, conv_dim), 0.5)}
    x1 = _rand(rng, (B, 1, cfg.d_model), 0.5)
    out_r, st_r = _jit(RL.mamba2_block, cfg=rcfg, shd=REF_POLICY)(
        pr, x1, state=state)
    out_t, st_t = L.mamba2_block(pt, _t(x1), cfg, NO_POLICY,
                                 state={k: _t(a) for k, a in state.items()})
    _close(out_t, out_r)
    for k in ("ssm", "conv"):
        _close(st_t[k], st_r[k])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_xlstm_blocks_match_reference(use_kernel):
    rcfg, cfg = _cfgs("xlstm-125m")
    rng = np.random.default_rng(9)
    B, T = 2, 20
    x = _rand(rng, (B, T, cfg.d_model), 0.5)
    pr, pt = _params(RL.mlstm_init, 9, rcfg, jnp.float32)
    mlstm = _jit(RL.mlstm_block, cfg=rcfg, shd=REF_POLICY)
    out_r, st_r = _jit(RL.mlstm_block, cfg=rcfg, shd=REF_POLICY,
                       use_kernel=use_kernel)(pr, x)
    out_t, st_t = L.mlstm_block(pt, _t(x), cfg, NO_POLICY, use_kernel=use_kernel)
    _close(out_t, out_r)
    _close(st_t["ssm"], st_r["ssm"])
    x1 = _rand(rng, (B, 1, cfg.d_model), 0.5)
    out_r, _ = mlstm(pr, x1, state=st_r)
    out_t, _ = L.mlstm_block(pt, _t(x1), cfg, NO_POLICY, state=st_t)
    _close(out_t, out_r)
    pr, pt = _params(RL.slstm_init, 10, rcfg, jnp.float32)
    slstm = _jit(RL.slstm_block, cfg=rcfg, shd=REF_POLICY)
    out_r, st_r = slstm(pr, x)
    out_t, st_t = L.slstm_block(pt, _t(x), cfg, NO_POLICY)
    _close(out_t, out_r)
    for a, b in zip(st_t["slstm"], st_r["slstm"]):
        _close(a, b)
    out_r, _ = slstm(pr, x1, state=st_r)
    out_t, _ = L.slstm_block(pt, _t(x1), cfg, NO_POLICY, state=st_t)
    _close(out_t, out_r)


# ---------------------------------------------------------------------------
# the reference's layer oracles, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("shape", [(1, 64, 4, 2, 16), (2, 96, 8, 8, 32),
                                   (1, 130, 6, 3, 8)])
def test_flash_ref_matches_plain(seed, shape):
    B, T, Hq, Hk, D = shape
    rng = np.random.default_rng(seed)
    q, k, v = (_t(_rand(rng, (B, T, h, D))) for h in (Hq, Hk, Hk))
    for causal in (True, False):
        ref = L.plain_attention(q, k, v, causal=causal)
        out = L.flash_attention_ref(q, k, v, causal=causal, q_chunk=32,
                                    kv_chunk=48)
        _close(out, ref.numpy())


def _naive_linear_recurrence(c, b, v, log_a):
    B, T, H, N = b.shape
    S = np.zeros((B, H, N, v.shape[-1]))
    ys = []
    for t in range(T):
        S = S * np.exp(log_a[:, t])[..., None, None] \
            + np.einsum("bhn,bhp->bhnp", b[:, t], v[:, t])
        ys.append(np.einsum("bhn,bhnp->bhp", c[:, t], S))
    return np.stack(ys, 1), S


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("dims", [(1, 32, 2, 4, 8, 8), (2, 50, 3, 8, 4, 16)])
def test_chunked_recurrence_matches_naive(seed, dims):
    B, T, H, N, P, chunk = dims
    rng = np.random.default_rng(10 + seed)
    c, b = _rand(rng, (B, T, H, N)), _rand(rng, (B, T, H, N))
    v = _rand(rng, (B, T, H, P))
    log_a = -np.abs(_rand(rng, (B, T, H))) * 0.5
    y, S = L.chunked_linear_recurrence(_t(c), _t(b), _t(v), _t(log_a),
                                       chunk=chunk)
    y_ref, S_ref = _naive_linear_recurrence(c, b, v, log_a)
    _close(y, y_ref, rtol=2e-4, atol=2e-4)
    _close(S, S_ref, rtol=2e-4, atol=2e-4)


def test_recurrence_step_matches_chunked_tail():
    rng = np.random.default_rng(3)
    B, T, H, N, P = 2, 17, 2, 4, 8
    c, b = _t(_rand(rng, (B, T, H, N))), _t(_rand(rng, (B, T, H, N)))
    v = _t(_rand(rng, (B, T, H, P)))
    log_a = _t(-np.abs(_rand(rng, (B, T, H))) * 0.3)
    y_all, S_all = L.chunked_linear_recurrence(c, b, v, log_a, chunk=8)
    _, S_head = L.chunked_linear_recurrence(c[:, :-1], b[:, :-1], v[:, :-1],
                                            log_a[:, :-1], chunk=8)
    y_last, S_last = L.linear_recurrence_step(S_head, c[:, -1], b[:, -1],
                                              v[:, -1], log_a[:, -1])
    _close(y_last, y_all[:, -1].numpy(), rtol=2e-4, atol=2e-4)
    _close(S_last, S_all.numpy(), rtol=2e-4, atol=2e-4)


def test_moe_no_drop_equals_explicit_topk():
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              moe_capacity_factor=8.0)
    gen = torch.Generator().manual_seed(2)
    p = L.moe_init(gen, cfg, torch.float32, "cpu")
    rng = np.random.default_rng(5)
    B, T = 2, 16
    x = _t(_rand(rng, (B, T, cfg.d_model), 0.3))
    out, _ = L.moe_block(p, x, cfg, NO_POLICY)
    xf = x.numpy().reshape(-1, cfg.d_model)
    logits = xf @ p["router"].numpy()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    ref = np.zeros_like(xf)
    for n in range(xf.shape[0]):
        topk = np.argsort(probs[n])[::-1][:cfg.moe_top_k]
        gv = probs[n][topk] / probs[n][topk].sum()
        for e, g in zip(topk, gv):
            gate, up = np.split(xf[n] @ p["w_up"][e].numpy(), 2)
            ref[n] += g * ((gate / (1 + np.exp(-gate)) * up)
                           @ p["w_down"][e].numpy())
    _close(out, ref.reshape(B, T, cfg.d_model), rtol=2e-3, atol=2e-3)


def test_mla_absorbed_decode_equals_expanded():
    cfg = get_config("deepseek-v3-671b").reduced()
    p = L.mla_init(torch.Generator().manual_seed(7), cfg, torch.float32, "cpu")
    rng = np.random.default_rng(7)
    B, T = 2, 9
    x = _t(_rand(rng, (B, T, cfg.d_model), 0.2))
    pos = torch.arange(T)[None].expand(B, T)
    out_full, _ = L.mla_attention(p, x, cfg, NO_POLICY, positions=pos)
    cache = {"c_kv": torch.zeros((B, T, cfg.kv_lora_rank)),
             "k_pe": torch.zeros((B, T, cfg.qk_rope_head_dim)),
             "len": torch.zeros((), dtype=torch.int32)}
    outs = []
    for t in range(T):
        o, cache = L.mla_attention(p, x[:, t:t + 1], cfg, NO_POLICY,
                                   positions=pos[:, t:t + 1], cache=cache)
        outs.append(o)
    _close(torch.cat(outs, 1), out_full.numpy(), rtol=2e-3, atol=2e-3)


def test_mrope_equals_rope_when_streams_equal():
    rng = np.random.default_rng(8)
    B, T, H, D = 2, 16, 4, 32
    x = _t(_rand(rng, (B, T, H, D)))
    p = torch.arange(T)[None].expand(B, T)
    cos1, sin1 = L.rope_cos_sin(p, D, 1e4)
    cos3, sin3 = L.mrope_cos_sin(torch.stack([p, p, p]), D, 1e4,
                                 sections=(4, 6, 6))
    _close(cos3, cos1.numpy(), rtol=1e-6, atol=0)
    _close(L.apply_rope(x, cos3, sin3), L.apply_rope(x, cos1, sin1).numpy(),
           rtol=1e-6, atol=0)
