"""Composable LM: block-spec patterns -> init / forward / prefill / decode.

Port of ``repro.models.model``.  Every assigned architecture maps to one
of six block patterns:

* ``dense``    — GQA attention + SwiGLU (llama3.2 / mistral-large /
                 qwen3 (qk-norm) / stablelm / qwen2-vl (M-RoPE, stub
                 patch embeddings))
* ``moe``      — GQA attention + top-k MoE (granite)
* ``mla_moe``  — MLA attention, first-k dense then MoE + shared expert,
                 optional MTP head (deepseek-v3)
* ``encdec``   — encoder + decoder with cross-attention (seamless, stub
                 frame embeddings)
* ``xlstm``    — alternating mLSTM / sLSTM pairs
* ``zamba2``   — Mamba2 backbone + one *shared* GQA attention block applied
                 every ``zamba_attn_every`` layers

Parameters are the reference's tree (dicts of tensors, with each block
stack's layers stored along a leading dimension); where the reference
scans over that dimension the port loops over it.  :func:`params_from_numpy`
turns the reference's parameter tree, as NumPy arrays, into the port's.
With ``cfg.remat`` each per-layer body of :func:`forward` is recomputed in
the backward pass (``torch.utils.checkpoint``), as the reference wraps
each scan body in ``jax.checkpoint``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import tracing
from ..sharding import (NO_POLICY, NamedSharding, Policy, hold_grad, lookup,
                        reshape, rows_of, select_layer, sharded_on,
                        sharded_zeros, split_ways, take_last)
from . import layers as L


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every tensor leaf of a tree of dicts, lists and tuples
    (with ``rest``: on the leaves at the same place of each tree)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the reference's (``jax.tree.leaves``) order: dict
    keys sorted, sequences in order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def unzip(tree, k: int):
    """Element ``k`` of every tuple at a leaf's place of ``tree`` (a tree
    whose leaves were mapped to tuples, as the reference unzips with
    ``is_leaf=lambda t: isinstance(t, tuple)``).  The parameter trees hold
    dicts and lists only, so every tuple is such a leaf."""
    if isinstance(tree, tuple):
        return tree[k]
    if isinstance(tree, dict):
        return {n: unzip(v, k) for n, v in tree.items()}
    return [unzip(v, k) for v in tree]


def tree_flatten_with_path(tree, path=()) -> list:
    """``(path, leaf)`` pairs in :func:`tree_leaves` order; a path is the
    tuple of dict keys (str) and sequence indices (int) down to the leaf
    (``jax.tree_util.tree_flatten_with_path``'s keys).  ``None`` is an
    empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def _take(x, i: int):
    """``x[i]``; of a DTensor split along its layer dim, layer ``i``
    gathered alone (:func:`repro_torch.sharding.select_layer`)."""
    return select_layer(x, i) if sharded_on(x, 0) else x[i]


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter (or cache) tree: views."""
    return tree_map(lambda x: _take(x, i), tree)


def _unstack(tree) -> list:
    """Every layer of a stacked parameter tree, as views (``unbind``, so a
    backward pass stacks the layers' gradients once rather than adding a
    full-size gradient per layer).  A stack whose layer dim is split over
    a mesh gives each layer gathered alone."""
    paths = tree_flatten_with_path(tree)
    per_leaf = [[select_layer(x, i) for i in range(x.shape[0])]
                if sharded_on(x, 0) else torch.unbind(x) for _, x in paths]
    return [tree_unflatten(tree, [u[i] for u in per_leaf])
            for i in range(len(per_leaf[0]))]


def _maybe_remat(fn: Callable, cfg) -> Callable:
    """``fn`` recomputed in the backward pass when ``cfg.remat`` (the
    reference's ``jax.checkpoint``); its inputs and outputs are kept.
    Without autograd (serving) there is no backward pass, and ``fn`` runs
    as it is."""
    if not cfg.remat or not torch.is_grad_enabled():
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _stack_init(init_fn, n: int):
    """``n`` draws of ``init_fn()`` stacked along a new leading dim (the
    reference's ``vmap`` of the init over split keys)."""
    return _stack_trees([init_fn() for _ in range(n)])


def _stack_trees(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_trees([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def params_from_numpy(tree, device) -> dict:
    """The reference's parameter tree (``repro.models.model.init_params``
    output, leaves as NumPy arrays; bf16 as ``ml_dtypes.bfloat16``) as
    the port's, on ``device``: same keys, same stacked layer dims, same
    dtypes."""
    device = torch.device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
            return t.view(torch.bfloat16).to(device)
        return torch.from_numpy(np.array(a)).to(device)
    return tree_map(conv, tree)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator | None = None, *,
                device=None) -> dict:
    """Random parameters drawn from ``generator`` on its device (the
    reference draws from a PRNG key; the values differ, the tree, shapes
    and dtypes do not).  ``device="meta"`` without a generator gives the
    shapes only (:func:`param_shapes`)."""
    if device is None:
        device = generator.device
    device = torch.device(device)
    gen = generator
    dt = cfg.torch_dtype
    params: dict[str, Any] = {
        "embed": (L.normal(gen, (cfg.vocab, cfg.d_model), device)
                  * 0.02).to(dt),
        "final_norm": L.ones(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab, dt,
                                         device)

    def ln():
        return L.ones(cfg.d_model, dt, device)

    def dense_block():
        return {"ln1": ln(), "attn": L.gqa_init(gen, cfg, dt, device),
                "ln2": ln(),
                "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt, device)}

    def moe_block():
        return {"ln1": ln(), "attn": L.gqa_init(gen, cfg, dt, device),
                "ln2": ln(), "moe": L.moe_init(gen, cfg, dt, device)}

    def mla_dense_block():
        return {"ln1": ln(), "attn": L.mla_init(gen, cfg, dt, device),
                "ln2": ln(),
                "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt, device)}

    def mla_moe_block():
        return {"ln1": ln(), "attn": L.mla_init(gen, cfg, dt, device),
                "ln2": ln(), "moe": L.moe_init(gen, cfg, dt, device)}

    def dec_block():
        return {"ln1": ln(), "attn": L.gqa_init(gen, cfg, dt, device),
                "lnx": ln(), "xattn": L.cross_attn_init(gen, cfg, dt, device),
                "ln2": ln(),
                "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt, device)}

    def mamba_block():
        return {"ln1": ln(), "mamba": L.mamba2_init(gen, cfg, dt, device)}

    def xlstm_pair():
        return {"ln_m": ln(), "mlstm": L.mlstm_init(gen, cfg, dt, device),
                "ln_s": ln(), "slstm": L.slstm_init(gen, cfg, dt, device)}

    bp = cfg.block_pattern
    if bp == "dense":
        params["blocks"] = _stack_init(dense_block, cfg.n_layers)
    elif bp == "moe":
        params["blocks"] = _stack_init(moe_block, cfg.n_layers)
    elif bp == "mla_moe":
        params["dense_blocks"] = _stack_init(mla_dense_block, cfg.first_k_dense)
        params["moe_blocks"] = _stack_init(mla_moe_block,
                                           cfg.n_layers - cfg.first_k_dense)
        if cfg.mtp:
            params["mtp"] = {
                "proj": L.dense_init(gen, 2 * cfg.d_model, cfg.d_model, dt,
                                     device),
                "block": mla_dense_block(),
                "norm": ln(),
            }
    elif bp == "encdec":
        params["enc_blocks"] = _stack_init(dense_block, cfg.n_enc_layers)
        params["dec_blocks"] = _stack_init(dec_block, cfg.n_dec_layers)
        params["enc_norm"] = ln()
    elif bp == "xlstm":
        params["blocks"] = _stack_init(xlstm_pair, cfg.n_layers // 2)
    elif bp == "zamba2":
        params["blocks"] = _stack_init(mamba_block, cfg.n_layers)
        params["shared_attn"] = {"ln": ln(),
                                 "attn": L.gqa_init(gen, cfg, dt, device)}
    else:
        raise ValueError(f"unknown block pattern {bp!r}")
    return params


def param_shapes(cfg) -> Any:
    """The parameter tree on the meta device (shapes and dtypes, no
    allocation)."""
    return init_params(cfg, None, device="meta")


# ---------------------------------------------------------------------------
# forward (full-sequence)
# ---------------------------------------------------------------------------

def _embed_in(cfg, params, batch, shd: Policy):
    """tokens (B,T) int -> embeddings, or pass through stub embeddings."""
    if "embeds" in batch:
        h = batch["embeds"].to(cfg.torch_dtype)
    else:
        h = lookup(params["embed"], batch["tokens"])
    return shd.constrain(h, "batch", "seq_act", "embed", name="embed_out")


def _arange_bt(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, device=device)[None].expand(B, T)


def _positions(cfg, batch, T: int, device):
    B = (batch["tokens"].shape[0] if "tokens" in batch
         else batch["embeds"].shape[0])
    if cfg.mrope:
        if "positions" in batch:
            return batch["positions"]
        p = _arange_bt(B, T, device)
        return torch.stack([p, p, p])         # text-only: t=h=w stream
    return _arange_bt(B, T, device)


def _logits(cfg, params, h, shd: Policy):
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = h @ w
    return shd.constrain(logits, "batch", "seq", "vocab", name="logits")


def _n(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def forward(cfg, params, batch, shd: Policy = NO_POLICY,
            return_hidden: bool = False):
    """Full-sequence forward -> (logits, aux_loss[, hidden])."""
    h = _embed_in(cfg, params, batch, shd)
    dev = h.device
    T = h.shape[1]
    pos = _positions(cfg, batch, T, dev)
    bp = cfg.block_pattern
    eps = cfg.norm_eps
    aux = torch.zeros((), dtype=torch.float32, device=dev)

    if bp in ("dense", "moe"):
        def body(h, aux, lp):
            a, _ = L.gqa_attention(lp["attn"], L.rms_norm(h, lp["ln1"], eps),
                                   cfg, shd, positions=pos)
            h = h + a
            if bp == "moe":
                m, a_l = L.moe_block(lp["moe"], L.rms_norm(h, lp["ln2"], eps),
                                     cfg, shd)
                aux = aux + a_l
            else:
                m = L.swiglu_mlp(lp["mlp"], L.rms_norm(h, lp["ln2"], eps), shd)
            return h + m, aux
        body = _maybe_remat(body, cfg)
        for lp in _unstack(params["blocks"]):
            h, aux = body(h, aux, lp)

    elif bp == "mla_moe":
        def mla_body(h, aux, lp, is_moe):
            a, _ = L.mla_attention(lp["attn"], L.rms_norm(h, lp["ln1"], eps),
                                   cfg, shd, positions=pos)
            h = h + a
            if is_moe:
                m, a_l = L.moe_block(lp["moe"], L.rms_norm(h, lp["ln2"], eps),
                                     cfg, shd)
                aux = aux + a_l
            else:
                m = L.swiglu_mlp(lp["mlp"], L.rms_norm(h, lp["ln2"], eps), shd)
            return h + m, aux
        mla_body = _maybe_remat(mla_body, cfg)
        for key, is_moe in (("dense_blocks", False), ("moe_blocks", True)):
            for lp in _unstack(params[key]):
                h, aux = mla_body(h, aux, lp, is_moe)

    elif bp == "encdec":
        # batch: embeds (encoder input, stub frontend) + tokens (decoder)
        memory = _encode(cfg, params, batch, shd)
        h = lookup(params["embed"], batch["tokens"])
        h = shd.constrain(h, "batch", "seq_act", "embed", name="dec_in")
        T = h.shape[1]
        dpos = _arange_bt(h.shape[0], T, dev)

        def dec_body(h, lp):
            a, _ = L.gqa_attention(lp["attn"], L.rms_norm(h, lp["ln1"], eps),
                                   cfg, shd, positions=dpos)
            h = h + a
            x = L.cross_attention(lp["xattn"], L.rms_norm(h, lp["lnx"], eps),
                                  memory, cfg, shd)
            h = h + x
            m = L.swiglu_mlp(lp["mlp"], L.rms_norm(h, lp["ln2"], eps), shd)
            return h + m
        dec_body = _maybe_remat(dec_body, cfg)
        for lp in _unstack(params["dec_blocks"]):
            h = dec_body(h, lp)

    elif bp == "xlstm":
        def body(h, lp):
            a, _ = L.mlstm_block(lp["mlstm"], L.rms_norm(h, lp["ln_m"], eps),
                                 cfg, shd)
            h = h + a
            s, _ = L.slstm_block(lp["slstm"], L.rms_norm(h, lp["ln_s"], eps),
                                 cfg, shd)
            return h + s
        body = _maybe_remat(body, cfg)
        for lp in _unstack(params["blocks"]):
            h = body(h, lp)

    elif bp == "zamba2":
        # groups of ``every`` Mamba-2 layers, each group closed by the
        # shared attention block (the reference's grouped scan body)
        every = cfg.zamba_attn_every
        sa = params["shared_attn"]

        def group_body(h, lps, attend):
            for lp in lps:
                m, _ = L.mamba2_block(lp["mamba"],
                                      L.rms_norm(h, lp["ln1"], eps), cfg, shd)
                h = h + m
            if attend:
                a, _ = L.gqa_attention(sa["attn"], L.rms_norm(h, sa["ln"], eps),
                                       cfg, shd, positions=pos)
                h = h + a
            return h
        group_body = _maybe_remat(group_body, cfg)
        layers = _unstack(params["blocks"])[:cfg.n_layers]
        for g0 in range(0, len(layers), every):
            lps = layers[g0:g0 + every]
            h = group_body(h, lps, len(lps) == every)
    else:
        raise ValueError(bp)

    logits = _logits(cfg, params, h, shd)
    if return_hidden:
        return logits, aux, h
    return logits, aux


def _encode(cfg, params, batch, shd: Policy):
    """The enc-dec encoder over the stub frame embeddings -> memory."""
    enc_cfg = dataclasses.replace(cfg, causal=False)
    eps = cfg.norm_eps
    e = batch["embeds"].to(cfg.torch_dtype)
    e = shd.constrain(e, "batch", "seq_act", "embed", name="enc_in")
    epos = _arange_bt(e.shape[0], e.shape[1], e.device)

    def enc_body(e, lp):
        a, _ = L.gqa_attention(lp["attn"], L.rms_norm(e, lp["ln1"], eps),
                               enc_cfg, shd, positions=epos)
        e = e + a
        m = L.swiglu_mlp(lp["mlp"], L.rms_norm(e, lp["ln2"], eps), shd)
        return e + m
    enc_body = _maybe_remat(enc_body, cfg)
    for lp in _unstack(params["enc_blocks"]):
        e = enc_body(e, lp)
    return L.rms_norm(e, params["enc_norm"], eps)


# ---------------------------------------------------------------------------
# loss (differentiable: ``train.trainer`` takes its gradient by autograd)
# ---------------------------------------------------------------------------

def _ce(logits, labels):
    lg = logits.float()
    if split_ways(lg, lg.dim() - 1) > 1:
        # vocab split over a mesh: max and sum reduce across the shards
        # (DTensor gathers the whole vocab for logsumexp)
        m = rows_of(lg.amax(dim=-1, keepdim=True).detach(), lg)
        s = rows_of(torch.exp(lg - m).sum(dim=-1, keepdim=True), lg)
        lse = hold_grad((torch.log(s) + m).squeeze(-1))
    else:
        lse = torch.logsumexp(lg, dim=-1)
    gold = take_last(lg, labels.long().clamp_min(0))
    mask = (labels >= 0).float()
    n = torch.clamp_min(mask.sum(), 1.0)
    nll = ((lse - gold) * mask).sum() / n
    zloss = ((lse ** 2) * mask).sum() / n
    return nll, zloss, mask.sum()


def loss_fn(cfg, params, batch, shd: Policy = NO_POLICY):
    """Next-token cross-entropy (+ MoE aux + z-loss + MTP for deepseek)."""
    use_mtp = cfg.mtp and "mtp" in params and "tokens" in batch
    if use_mtp:
        logits, aux, h = forward(cfg, params, batch, shd, return_hidden=True)
    else:
        logits, aux = forward(cfg, params, batch, shd)
    labels = batch["labels"]
    nll, zloss, ntok = _ce(logits, labels)
    total = nll + 1e-4 * zloss + cfg.aux_loss_coef * aux
    metrics = {"nll": nll, "zloss": zloss, "aux": aux, "tokens": ntok}

    if use_mtp:
        # DeepSeek-V3 multi-token prediction (depth 1): predict token t+2
        # from h_t combined with the embedding of token t+1.
        eps = cfg.norm_eps
        mtp = params["mtp"]
        tok_next = batch["tokens"][:, 1:]
        e_next = lookup(params["embed"], tok_next)
        hin = torch.cat([h[:, :-1], e_next], dim=-1) @ mtp["proj"]
        pos = _arange_bt(hin.shape[0], hin.shape[1], hin.device)
        lp = mtp["block"]
        a, _ = L.mla_attention(lp["attn"], L.rms_norm(hin, lp["ln1"], eps),
                               cfg, shd, positions=pos)
        hin = hin + a
        hin = hin + L.swiglu_mlp(lp["mlp"], L.rms_norm(hin, lp["ln2"], eps),
                                 shd)
        hin = L.rms_norm(hin, mtp["norm"], eps)
        w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
        mtp_logits = hin @ w
        mtp_labels = torch.cat(
            [labels[:, 2:], torch.full_like(labels[:, :1], -1)], dim=1)
        mtp_nll, _, _ = _ce(mtp_logits, mtp_labels)
        total = total + 0.3 * mtp_nll
        metrics["mtp_nll"] = mtp_nll
    return total, metrics


# ---------------------------------------------------------------------------
# KV / state caches
# ---------------------------------------------------------------------------

# cache leaf name -> logical axes for its *last* dims (leading stack dims
# padded with None).  kv-head and state-head dims shard over the model
# axis (guarded by divisibility), batch over data(+pod).
_CACHE_AXES: dict[str, tuple] = {
    "k": ("batch", "kv_len", "heads", None),
    "v": ("batch", "kv_len", "heads", None),
    "xk": ("batch", "kv_len", "heads", None),
    "xv": ("batch", "kv_len", "heads", None),
    "c_kv": ("batch", "kv_len", None),
    "k_pe": ("batch", "kv_len", None),
    "ssm": ("batch", "heads", None, None),
    "conv": ("batch", None, "ff"),
    "mlstm": ("batch", "heads", None, None),
    "slstm": ("batch", "heads", None),
    "len": (),
}


def cache_pspecs(policy: Policy, cache_tree):
    """Tree of PartitionSpec matching a cache (``meta`` tensors do)."""
    out = []
    for path, leaf in tree_flatten_with_path(cache_tree):
        name = next((p for p in reversed(path) if isinstance(p, str)), None)
        axes = _CACHE_AXES.get(name, ())
        ndim = len(leaf.shape)
        ax = axes[-ndim:] if len(axes) > ndim else axes
        ax = (None,) * (ndim - len(ax)) + tuple(ax)
        out.append(policy.param_spec(tuple(leaf.shape), ax))
    return tree_unflatten(cache_tree, out)


class _Leaf:
    """A cache leaf's shape and dtype, without a tensor."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype


def init_cache(cfg, batch: int, max_len: int, device=None,
               shd: Policy = NO_POLICY) -> dict:
    """Zeroed caches on ``device`` (default: the card).  ``len`` is a
    device int32 scalar.  With a mesh in ``shd`` every leaf is a DTensor
    with the placements of :func:`cache_pspecs`, each rank allocating
    its shard only (the placements read from the leaves' shapes, with no
    whole-batch tensor made first)."""
    if device is None:
        from ..core.modelgraph import chain_device
        device = chain_device(None)
    device = torch.device(device)
    if shd.mesh is not None:
        shapes = _cache_tree(cfg, batch, max_len, _Leaf)
        return tree_map(
            lambda m, s: sharded_zeros(m.shape, m.dtype, device,
                                       NamedSharding(shd.mesh, s)),
            shapes, cache_pspecs(shd, shapes))
    return _cache_tree(cfg, batch, max_len, lambda shape, dtype: torch.zeros(
        shape, dtype=dtype, device=device))


def _cache_tree(cfg, batch: int, max_len: int, leaf) -> dict:
    """The cache tree of :func:`init_cache`, each leaf ``leaf(shape,
    dtype)``."""
    dt = cfg.torch_dtype
    bp = cfg.block_pattern
    Lc = cfg.n_layers

    def zeros(shape, dtype=dt):
        return leaf(shape, dtype)

    def attn_cache(n, length):
        return {"k": zeros((n, batch, length, cfg.n_kv_heads, cfg.d_head)),
                "v": zeros((n, batch, length, cfg.n_kv_heads, cfg.d_head))}

    length0 = zeros((), torch.int32)
    if bp == "dense" or bp == "moe":
        return {"attn": attn_cache(Lc, max_len), "len": length0}
    if bp == "mla_moe":
        def mla_cache(n):
            return {"c_kv": zeros((n, batch, max_len, cfg.kv_lora_rank)),
                    "k_pe": zeros((n, batch, max_len, cfg.qk_rope_head_dim))}
        return {"dense": mla_cache(cfg.first_k_dense),
                "moe": mla_cache(Lc - cfg.first_k_dense), "len": length0}
    if bp == "encdec":
        n = cfg.n_dec_layers
        return {"attn": attn_cache(n, max_len),
                # cross-attention K/V computed once from encoder memory
                "xk": zeros((n, batch, max_len, cfg.n_kv_heads, cfg.d_head)),
                "xv": zeros((n, batch, max_len, cfg.n_kv_heads, cfg.d_head)),
                "len": length0}
    if bp == "xlstm":
        P2 = Lc // 2
        H = cfg.n_heads
        dh = cfg.xlstm_d_inner // H
        dhs = cfg.d_model // H
        return {
            "mlstm": zeros((P2, batch, H, dh, dh + 1), torch.float32),
            "slstm": tuple(zeros((P2, batch, H, dhs), torch.float32)
                           for _ in range(4)),
            "len": length0}
    if bp == "zamba2":
        G = cfg.n_layers // cfg.zamba_attn_every
        conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state * cfg.ssm_groups
        P = cfg.ssm_d_inner // cfg.ssm_heads
        return {
            "ssm": zeros((Lc, batch, cfg.ssm_heads, cfg.ssm_state, P),
                         torch.float32),
            "conv": zeros((Lc, batch, cfg.ssm_conv - 1, conv_dim)),
            "attn": attn_cache(G, max_len),
            "len": length0}
    raise ValueError(bp)


# ---------------------------------------------------------------------------
# decode step (one token)
# ---------------------------------------------------------------------------

def decode_step(cfg, params, cache, batch, shd: Policy = NO_POLICY, *,
                donate: bool = False):
    """One decode step.  batch: tokens (B, 1) (+ embeds for stubs).
    Returns (logits (B, 1, V), new_cache).

    ``donate=True`` updates ``cache``'s tensors in place and returns it
    (the reference donates the cache to its jitted step); otherwise the
    step works on a copy and ``cache`` is left as it was.  Nothing here
    syncs the host, so the step can be captured as a CUDA graph."""
    if not donate:
        cache = tree_map(torch.clone, cache)
    h = _embed_in(cfg, params, batch, shd)
    B, T = h.shape[:2]
    eps = cfg.norm_eps
    idx = cache["len"]
    p = reshape(idx, 1, 1).expand(B, T)
    pos = torch.stack([p, p, p]) if cfg.mrope else p
    bp = cfg.block_pattern

    if bp in ("dense", "moe"):
        ca = cache["attn"]
        for i in range(_n(params["blocks"])):
            lp = _layer(params["blocks"], i)
            a, _ = L.gqa_attention(
                lp["attn"], L.rms_norm(h, lp["ln1"], eps), cfg, shd,
                positions=pos, cache={"k": ca["k"][i], "v": ca["v"][i],
                                      "len": idx})
            h = h + a
            if bp == "moe":
                m, _ = L.moe_block(lp["moe"], L.rms_norm(h, lp["ln2"], eps),
                                   cfg, shd)
            else:
                m = L.swiglu_mlp(lp["mlp"], L.rms_norm(h, lp["ln2"], eps), shd)
            h = h + m

    elif bp == "mla_moe":
        for key, ckey, is_moe in (("dense_blocks", "dense", False),
                                  ("moe_blocks", "moe", True)):
            cm = cache[ckey]
            for i in range(_n(params[key])):
                lp = _layer(params[key], i)
                a, _ = L.mla_attention(
                    lp["attn"], L.rms_norm(h, lp["ln1"], eps), cfg, shd,
                    positions=pos, cache={"c_kv": cm["c_kv"][i],
                                          "k_pe": cm["k_pe"][i], "len": idx})
                h = h + a
                if is_moe:
                    m, _ = L.moe_block(lp["moe"], L.rms_norm(h, lp["ln2"], eps),
                                       cfg, shd)
                else:
                    m = L.swiglu_mlp(lp["mlp"], L.rms_norm(h, lp["ln2"], eps),
                                     shd)
                h = h + m

    elif bp == "encdec":
        ca = cache["attn"]
        for i in range(_n(params["dec_blocks"])):
            lp = _layer(params["dec_blocks"], i)
            a, _ = L.gqa_attention(
                lp["attn"], L.rms_norm(h, lp["ln1"], eps), cfg, shd,
                positions=pos, cache={"k": ca["k"][i], "v": ca["v"][i],
                                      "len": idx})
            h = h + a
            # cross-attention against cached encoder K/V
            xk, xv = cache["xk"][i], cache["xv"][i]
            xq = L.rms_norm(h, lp["lnx"], eps) @ lp["xattn"]["wq"]
            xq = reshape(xq, B, T, cfg.n_heads, cfg.d_head)
            valid = torch.ones((xk.shape[1],), dtype=torch.bool, device=h.device)
            xo = L._decode_attention(xq, xk, xv, valid, q_offset=xk.shape[1])
            h = h + reshape(xo, B, T, -1) @ lp["xattn"]["wo"]
            m = L.swiglu_mlp(lp["mlp"], L.rms_norm(h, lp["ln2"], eps), shd)
            h = h + m

    elif bp == "xlstm":
        for i in range(_n(params["blocks"])):
            lp = _layer(params["blocks"], i)
            # the step writes the state in place (``kernels.ssd_step``)
            a, _ = L.mlstm_block(lp["mlstm"], L.rms_norm(h, lp["ln_m"], eps),
                                 cfg, shd, state={"ssm": cache["mlstm"][i]},
                                 use_kernel=cfg.use_kernels)
            h = h + a
            s, ns = L.slstm_block(
                lp["slstm"], L.rms_norm(h, lp["ln_s"], eps), cfg, shd,
                state={"slstm": tuple(x[i] for x in cache["slstm"])})
            h = h + s
            for buf, new in zip(cache["slstm"], ns["slstm"]):
                buf[i].copy_(new)

    elif bp == "zamba2":
        every = cfg.zamba_attn_every
        sa = params["shared_attn"]
        ca = cache["attn"]
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            # the step writes the state in place (``kernels.ssd_step``)
            m, ns = L.mamba2_block(lp["mamba"], L.rms_norm(h, lp["ln1"], eps),
                                   cfg, shd, state={"ssm": cache["ssm"][i],
                                                    "conv": cache["conv"][i]},
                                   use_kernel=cfg.use_kernels)
            h = h + m
            cache["conv"][i].copy_(ns["conv"])
            if (i + 1) % every == 0:
                g = i // every
                a, _ = L.gqa_attention(
                    sa["attn"], L.rms_norm(h, sa["ln"], eps), cfg, shd,
                    positions=pos, cache={"k": ca["k"][g], "v": ca["v"][g],
                                          "len": idx})
                h = h + a
    else:
        raise ValueError(bp)

    idx.add_(T)
    return _logits(cfg, params, h, shd), cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _prefill_kv(cfg, lp_attn, x, pos, ck, cv):
    """Write the layer's roped K and V for positions [0, T) into the cache
    slices ``ck``/``cv`` (B, max_len, Hk, dh), in place (through
    :func:`cache_insert`, which a cache split over its seq dim needs)."""
    B, T = x.shape[:2]
    k = reshape(x @ lp_attn["wk"], B, T, cfg.n_kv_heads, cfg.d_head)
    v = reshape(x @ lp_attn["wv"], B, T, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        k = L.rms_norm(k, lp_attn["k_norm"])
    cs, sn = L.rope_cos_sin(pos[0] if pos.dim() == 3 else pos,
                            cfg.d_head, cfg.rope_theta)
    if cfg.mrope:
        cs, sn = L.mrope_cos_sin(pos, cfg.d_head, cfg.rope_theta,
                                 cfg.mrope_sections)
    k = L.apply_rope(k, cs, sn)
    start = torch.zeros((), dtype=torch.int32, device=x.device)
    L.cache_insert(ck, k, start)
    L.cache_insert(cv, v, start)


def prefill(cfg, params, batch, max_len: int, shd: Policy = NO_POLICY):
    """Run the full prompt, returning (last-position logits, filled cache).

    For recurrent patterns the cache is the final recurrent state; for
    attention patterns the K/V cache is written by a second pass of the
    per-layer K/V projections, as the reference does.  With
    ``cfg.use_kernels`` attention (dense/moe) and the SSD scans
    (Mamba-2, mLSTM) go through ``repro_torch.kernels.ops``.  Under a
    profiler the call is a ``model.prefill`` span
    (:mod:`repro_torch.tracing`).
    """
    with tracing.span("model.prefill"):
        return _prefill(cfg, params, batch, max_len, shd)


def _prefill(cfg, params, batch, max_len: int, shd: Policy):
    h = _embed_in(cfg, params, batch, shd)
    dev = h.device
    B, T = h.shape[:2]
    eps = cfg.norm_eps
    pos = _positions(cfg, batch, T, dev)
    bp = cfg.block_pattern
    cache = init_cache(cfg, B, max_len, dev, shd)

    def length(n):
        return torch.full((), n, dtype=torch.int32, device=dev)

    if bp in ("dense", "moe"):
        ca = cache["attn"]
        for i in range(_n(params["blocks"])):
            lp = _layer(params["blocks"], i)
            x = L.rms_norm(h, lp["ln1"], eps)
            _prefill_kv(cfg, lp["attn"], x, pos, ca["k"][i], ca["v"][i])
            a, _ = L.gqa_attention(
                lp["attn"], x, cfg, shd, positions=pos,
                use_flash="pallas" if cfg.use_kernels else None)
            h = h + a
            if bp == "moe":
                m, _ = L.moe_block(lp["moe"], L.rms_norm(h, lp["ln2"], eps),
                                   cfg, shd)
            else:
                m = L.swiglu_mlp(lp["mlp"], L.rms_norm(h, lp["ln2"], eps), shd)
            h = h + m
        cache["len"] = length(T)

    elif bp == "mla_moe":
        for key, ckey, is_moe in (("dense_blocks", "dense", False),
                                  ("moe_blocks", "moe", True)):
            cm = cache[ckey]
            for i in range(_n(params[key])):
                lp = _layer(params[key], i)
                x = L.rms_norm(h, lp["ln1"], eps)
                kv_a = x @ lp["attn"]["wkv_a"]
                c_kv = L.rms_norm(kv_a[..., :cfg.kv_lora_rank],
                                  lp["attn"]["kv_a_norm"])
                k_pe = kv_a[..., cfg.kv_lora_rank:]
                cs, sn = L.rope_cos_sin(pos, cfg.qk_rope_head_dim,
                                        cfg.rope_theta)
                k_pe = L.apply_rope(k_pe[:, :, None, :], cs, sn)[:, :, 0]
                start = torch.zeros((), dtype=torch.int32, device=dev)
                L.cache_insert(cm["c_kv"][i], c_kv, start)
                L.cache_insert(cm["k_pe"][i], k_pe, start)
                a, _ = L.mla_attention(lp["attn"], x, cfg, shd, positions=pos)
                h = h + a
                if is_moe:
                    m, _ = L.moe_block(lp["moe"], L.rms_norm(h, lp["ln2"], eps),
                                       cfg, shd)
                else:
                    m = L.swiglu_mlp(lp["mlp"], L.rms_norm(h, lp["ln2"], eps),
                                     shd)
                h = h + m
        cache["len"] = length(T)

    elif bp == "encdec":
        # encode, then prefill the decoder prompt + cross K/V
        memory = _encode(cfg, params, batch, shd)
        S = memory.shape[1]
        h = lookup(params["embed"], batch["tokens"])
        T2 = h.shape[1]
        dpos = _arange_bt(B, T2, dev)
        ca = cache["attn"]
        xks, xvs = [], []
        for i in range(_n(params["dec_blocks"])):
            lp = _layer(params["dec_blocks"], i)
            x = L.rms_norm(h, lp["ln1"], eps)
            _prefill_kv(cfg, lp["attn"], x, dpos, ca["k"][i], ca["v"][i])
            a, _ = L.gqa_attention(lp["attn"], x, cfg, shd, positions=dpos)
            h = h + a
            xh = L.rms_norm(h, lp["lnx"], eps)
            h = h + L.cross_attention(lp["xattn"], xh, memory, cfg, shd)
            xks.append(reshape(memory @ lp["xattn"]["wk"],
                B, S, cfg.n_kv_heads, cfg.d_head))
            xvs.append(reshape(memory @ lp["xattn"]["wv"],
                B, S, cfg.n_kv_heads, cfg.d_head))
            m = L.swiglu_mlp(lp["mlp"], L.rms_norm(h, lp["ln2"], eps), shd)
            h = h + m
        cache = {"attn": ca, "xk": torch.stack(xks), "xv": torch.stack(xvs),
                 "len": length(T2)}

    elif bp == "xlstm":
        ms, ss = [], []
        for i in range(_n(params["blocks"])):
            lp = _layer(params["blocks"], i)
            a, nm = L.mlstm_block(lp["mlstm"], L.rms_norm(h, lp["ln_m"], eps),
                                  cfg, shd, use_kernel=cfg.use_kernels)
            h = h + a
            s, ns = L.slstm_block(lp["slstm"], L.rms_norm(h, lp["ln_s"], eps),
                                  cfg, shd)
            h = h + s
            ms.append(nm["ssm"])
            ss.append(ns["slstm"])
        cache = {"mlstm": torch.stack(ms),
                 "slstm": tuple(torch.stack(x) for x in zip(*ss)),
                 "len": length(T)}

    elif bp == "zamba2":
        every = cfg.zamba_attn_every
        sa = params["shared_attn"]
        ca = cache["attn"]
        ssms, convs = [], []
        for i in range(cfg.n_layers):
            lp = _layer(params["blocks"], i)
            x = L.rms_norm(h, lp["ln1"], eps)
            m, ns = L.mamba2_block(lp["mamba"], x, cfg, shd,
                                   use_kernel=cfg.use_kernels)
            convs.append(ns["conv"])
            ssms.append(ns["ssm"])
            h = h + m
            if (i + 1) % every == 0:
                g = i // every
                x = L.rms_norm(h, sa["ln"], eps)
                _prefill_kv(cfg, sa["attn"], x, pos, ca["k"][g], ca["v"][g])
                a, _ = L.gqa_attention(sa["attn"], x, cfg, shd, positions=pos)
                h = h + a
        cache = {"ssm": torch.stack(ssms), "conv": torch.stack(convs),
                 "attn": ca, "len": length(T)}
    else:
        raise ValueError(bp)

    return _logits(cfg, params, h[:, -1:], shd), cache
