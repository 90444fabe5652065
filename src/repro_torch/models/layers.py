"""Model-zoo primitive layers (PyTorch, functional, shard-annotated).

Port of ``repro.models.layers``, function for function.

Conventions:
* activations are (batch, seq, ...) laid out as ``B T H D`` for attention;
* every layer is ``fn(params, x, cfg, shd, ...)`` with ``shd`` a
  ``repro_torch.sharding.Policy`` (the identity on one device);
* on a mesh the same code runs on DTensors.  Attention runs meshless on
  each rank's batch and q-head shards (``_on_rank_shards``).  Where
  DTensor has no rule for a view or contraction the reference's GSPMD
  would take (a split the view cannot carry, the decode scores' strided
  batch), the split is gathered at that site (``sharding.reshape``,
  ``_latent_scores``, the MoE combine); the cache is written on each
  rank's shard;
* params are plain dicts of tensors; init functions live next to apply
  functions and draw from a ``torch.Generator`` on the tensors' device;
* a decode cache (``cache=`` / ``state=``) is written in place: the
  reference donates it to the jitted step, the port updates its tensors.

Numerics: layers compute in ``cfg.dtype`` (bf16 for the big configs) with
f32 softmax/normaliser accumulations, and round where the reference
rounds.  The kernel call sites go through ``repro_torch.kernels.ops``,
which runs the kernel's plain version on a CPU tensor and launches the
CUDA kernel (or raises) on a CUDA one.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..sharding import (NO_POLICY, Policy, assemble, attention_shards,
                        column_blocks, gather_dim, hold_grad, is_dtensor,
                        local_shape_and_offset, local_value, place,
                        placements, reshape, rows_of, sharded_on,
                        split_ways, to_local)

F32 = torch.float32


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator | None, shape, device) -> torch.Tensor:
    """Standard normal f32 draws from ``gen`` on ``device``; on the meta
    device (shapes only) an empty tensor."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=F32, device=device)
    return torch.randn(shape, generator=gen, dtype=F32, device=device)


def dense_init(gen, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    return (normal(gen, (d_in, d_out), device) * scale).to(dtype)


def ones(n: int, dtype, device) -> torch.Tensor:
    return torch.ones((n,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    ms = (x * x).mean(dim=-1, keepdim=True)
    if sharded_on(x, x.ndim - 1):
        # a mesh splits the normalised dim: the row means made whole once,
        # placed as x's rows, and the gradient of the scale kept so, so
        # that the backward stays on x's shards (DTensor's own choices
        # split the seq dim and gather x and its gradient back)
        ms = rows_of(ms, x)
        x = x * hold_grad(torch.rsqrt(ms + eps))
    else:
        x = x * torch.rsqrt(ms + eps)
    return (x * w).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings (+ M-RoPE for qwen2-vl)
# ---------------------------------------------------------------------------

_INV_FREQ: dict[tuple, torch.Tensor] = {}


def _inv_freq(d_head: int, theta: float, device) -> torch.Tensor:
    """The rotary frequencies, computed in NumPy f32 as the reference
    does, and kept per device: a copy from the host inside a captured
    decode step would break the capture (the step's eager run before the
    capture fills this)."""
    key = (d_head, float(theta), torch.device(device))
    inv = _INV_FREQ.get(key)
    if inv is None:
        a = 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))
        inv = _INV_FREQ[key] = torch.from_numpy(
            np.asarray(a, np.float32)).to(device)
    return inv


def rope_cos_sin(positions, d_head: int, theta: float):
    """positions (..., T) -> cos/sin (..., T, d_head//2), fp32."""
    inv = _inv_freq(d_head, theta, positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, T, H, D); cos/sin (B, T, D/2) or (B, T, H, D/2)."""
    if cos.dim() == x.dim() - 1:
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_cos_sin(positions3, d_head: int, theta: float, sections=(16, 24, 24)):
    """M-RoPE (Qwen2-VL): three position streams (t, h, w) each driving a
    section of the rotary dims.  positions3: (3, B, T)."""
    assert sum(sections) == d_head // 2
    cos_p, sin_p = [], []
    inv = _inv_freq(d_head, theta, positions3.device)
    start = 0
    for s, sec in enumerate(sections):
        ang = positions3[s][..., None].float() * inv[start:start + sec]
        cos_p.append(torch.cos(ang))
        sin_p.append(torch.sin(ang))
        start += sec
    return torch.cat(cos_p, -1), torch.cat(sin_p, -1)


# ---------------------------------------------------------------------------
# chunked (flash) attention — the plain oracle beside the kernel
# ---------------------------------------------------------------------------

def _pad_seq(x, n: int):
    """Zero-pad dim 1 of ``x`` by ``n``."""
    if not n:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))], 1)


def _on_mesh(*xs) -> bool:
    return any(is_dtensor(x) for x in xs)


def _on_rank_shards(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (an attention of this module) on a mesh: run
    meshless on this rank's batch and q-head shards against the k/v heads
    those q heads read, the result a DTensor split as q
    (:func:`repro_torch.sharding.attention_shards`, the slicing the
    kernels' mesh entry uses).  No q head is gathered, also where the
    split of the q heads cuts the kv groups (DTensor cannot split one mesh
    axis over the (Hk, G) pair a view would make); autograd goes through
    the shards."""
    q_loc, k_loc, v_loc, finish = attention_shards(q, k, v)
    return finish(fn(q_loc, k_loc, v_loc, **kw))


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        q_chunk: int = 512, kv_chunk: int = 512,
                        q_offset: int = 0):
    """Online-softmax blockwise attention.

    q: (B, Tq, Hq, D), k/v: (B, Tk, Hk, D) with Hq % Hk == 0.  Never
    materialises the (Tq, Tk) score matrix; memory is O(q_chunk x kv_chunk).
    ``q_offset`` positions q tokens at kv index ``q_offset + i`` for causal
    masking (prefill continuation / decode).  On a mesh it runs on each
    rank's shards (:func:`_on_rank_shards`).
    """
    if _on_mesh(q, k, v):
        return _on_rank_shards(flash_attention_ref, q, k, v, causal=causal,
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               q_offset=q_offset)
    B, Tq, Hq, D = q.shape
    _, Tk, Hk, _ = k.shape
    Dv = v.shape[-1]
    G = Hq // Hk
    scale = 1.0 / math.sqrt(D)
    q_chunk = min(q_chunk, Tq)
    kv_chunk = min(kv_chunk, Tk)
    nq = -(-Tq // q_chunk)
    nk = -(-Tk // kv_chunk)
    dev = q.device
    qp = _pad_seq(q, nq * q_chunk - Tq)
    kp = _pad_seq(k, nk * kv_chunk - Tk)
    vp = _pad_seq(v, nk * kv_chunk - Tk)
    qs = reshape(qp, B, nq, q_chunk, Hk, G, D)
    ks = reshape(kp, B, nk, kv_chunk, Hk, D)
    vs = reshape(vp, B, nk, kv_chunk, Hk, Dv)
    kv_valid = (torch.arange(nk * kv_chunk, device=dev) < Tk).reshape(nk, kv_chunk)

    outs = []
    for qi in range(nq):
        q_blk = qs[:, qi].float() * scale
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((B, q_chunk, Hk, G, Dv), dtype=F32, device=dev)
        m = torch.full((B, q_chunk, Hk, G), -math.inf, dtype=F32, device=dev)
        l = torch.zeros((B, q_chunk, Hk, G), dtype=F32, device=dev)
        for ki in range(nk):
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            # scores: (B, C, Hk, G, Ck)
            s = torch.einsum("bchgd,bkhd->bchgk", q_blk, ks[:, ki].float())
            mask = kv_valid[ki][None, None, None, None, :]
            if causal:
                cm = q_pos[:, None] >= k_pos[None, :]
                mask = mask & cm[None, :, None, None, :]
            s = torch.where(mask, s, torch.full((), -1e30, device=dev))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bchgk,bkhd->bchgd", p, vs[:, ki].float())
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    out = reshape(torch.stack(outs, 1), B, nq * q_chunk, Hq, Dv)
    return out[:, :Tq].to(q.dtype)


def plain_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Reference dense attention (small shapes / decode).  v's head dim may
    differ from q/k's (MLA).  On a mesh it runs on each rank's shards
    (:func:`_on_rank_shards`)."""
    if _on_mesh(q, k, v):
        return _on_rank_shards(plain_attention, q, k, v, causal=causal,
                               q_offset=q_offset)
    B, Tq, Hq, D = q.shape
    _, Tk, Hk, _ = k.shape
    Dv = v.shape[-1]
    G = Hq // Hk
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = reshape(q, B, Tq, Hk, G, D).float() * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if causal:
        q_pos = q_offset + torch.arange(Tq, device=dev)
        mask = q_pos[:, None] >= torch.arange(Tk, device=dev)[None, :]
        s = torch.where(mask[None, None, None], s,
                        torch.full((), -1e30, device=dev))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return reshape(o, B, Tq, Hq, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (llama/qwen/stablelm/mistral/qwen2-vl/zamba2-shared)
# ---------------------------------------------------------------------------

def gqa_init(gen, cfg, dtype, device) -> dict:
    d, dh = cfg.d_model, cfg.d_head
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * dh, dtype, device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * dh, dtype, device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * dh, dtype, device),
        "wo": dense_init(gen, cfg.n_heads * dh, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = ones(dh, dtype, device)
        p["k_norm"] = ones(dh, dtype, device)
    return p


def cache_insert(buf, x, idx):
    """Write ``x`` (B, T, ...) into ``buf`` (B, L, ...) at rows ``idx +
    arange(T)``, in place; ``idx`` is a device scalar, so nothing syncs
    the host (the reference's ``dynamic_update_slice_in_dim``)."""
    if is_dtensor(buf):
        return _cache_insert_mesh(buf, x, idx)
    rows = idx.long() + torch.arange(x.shape[1], device=buf.device)
    buf.index_copy_(1, rows, x.to(buf.dtype))
    return buf


def _cache_insert_mesh(buf, x, idx):
    """:func:`cache_insert` into a DTensor cache, on each rank's shard
    (DTensor's in-place rule may re-place the buffer's spec without
    moving its data).  ``x`` takes the buffer's placements but for the
    seq dim, which it holds whole on every rank: where the mesh splits
    the cache's seq dim, each token is written only by the rank that
    holds its row, one token at a time."""
    from torch.distributed.tensor import Replicate
    mesh, pl = buf.device_mesh, tuple(buf.placements)
    x_pl = tuple(Replicate() if p.is_shard(1) else p for p in pl)
    x_loc = place(x.to(buf.dtype), mesh, x_pl).to_local()
    loc = buf.to_local()
    i = idx.to_local() if is_dtensor(idx) else idx
    shape, off = local_shape_and_offset(buf.shape, mesh, pl)
    rows = i.long() + torch.arange(x_loc.shape[1], device=loc.device) - off[1]
    if shape[1] == buf.shape[1]:
        loc.index_copy_(1, rows, x_loc)
        return buf
    n = shape[1]
    for t in range(x_loc.shape[1]):
        r = rows[t:t + 1]
        inside = ((r >= 0) & (r < n)).reshape((1, 1) + (1,) * (loc.dim() - 2))
        r = r.clamp(0, n - 1)
        loc.index_copy_(1, r, torch.where(inside, x_loc[:, t:t + 1],
                                          loc.index_select(1, r)))
    return buf


def gqa_attention(p, x, cfg, shd: Policy, *, positions, cache=None,
                  use_flash: bool | str | None = None):
    """Returns (out, new_cache).  cache = dict(k, v, len) for decode; its
    k/v tensors are written in place."""
    B, T, d = x.shape
    dh = cfg.d_head
    q = reshape(x @ p["wq"], B, T, cfg.n_heads, dh)
    k = reshape(x @ p["wk"], B, T, cfg.n_kv_heads, dh)
    v = reshape(x @ p["wv"], B, T, cfg.n_kv_heads, dh)
    q = shd.constrain(q, "batch", "seq", "heads", None, name="attn_q")
    # where each rank reads only the kv heads of its q heads, the k/v
    # gradients are partial sums over the q heads' split: they stay so
    # through the projections, so that the input's gradient (q's, k's and
    # v's parts) is made whole once
    k = shd.constrain(k, "batch", "seq", "kv_heads", None, name="attn_k",
                      partial_grad=True)
    v = shd.constrain(v, "batch", "seq", "kv_heads", None, name="attn_v",
                      partial_grad=True)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.mrope:
        cos, sin = mrope_cos_sin(positions, dh, cfg.rope_theta,
                                 cfg.mrope_sections)
    else:
        cos, sin = rope_cos_sin(positions[0] if positions.dim() == 3
                                else positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is not None:
        # decode: insert k/v at cache['len'], attend over the full cache
        idx = cache["len"]
        ck = cache_insert(cache["k"], k, idx)
        cv = cache_insert(cache["v"], v, idx)
        new_cache = {"k": ck, "v": cv, "len": idx + T}
        kv_pos = torch.arange(ck.shape[1], device=x.device)
        valid = kv_pos < (idx + T)
        q = shd.constrain(q, "batch", None, "decode_q_heads", None,
                          name="decode_q")
        o = _decode_attention(q, ck, cv, valid, q_offset=idx)
    else:
        q_off = 0
        if use_flash is None:
            use_flash = T > 1024
        if use_flash == "pallas":
            from ..kernels import ops as K
            o = K.flash_attention(q, k, v, causal=cfg.causal)
        elif use_flash:
            o = flash_attention_ref(q, k, v, causal=cfg.causal,
                                    q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                    q_offset=q_off)
        else:
            o = plain_attention(q, k, v, causal=cfg.causal, q_offset=q_off)
    o = shd.constrain(o, "batch", "seq", "heads", None, name="attn_o")
    of = reshape(o, B, T, cfg.n_heads * dh)
    of = shd.constrain(of, "batch", "seq", "attn_o_feat", name="attn_o_flat")
    out = of @ p["wo"]
    return shd.constrain(out, "batch", "seq_act", "embed", name="attn_out"), new_cache


def _decode_attention(q, k, v, valid, q_offset):
    """Attention of T=1..few query tokens over a padded cache.  On a mesh
    it runs on each rank's shards (:func:`_on_rank_shards`), unless the
    cache's seq dim is split: then the cache's split leads and the few
    query tokens' heads are gathered instead (never the cache)."""
    if _on_mesh(q, k, v):
        if not sharded_on(k, 1):
            return _on_rank_shards(_decode_attention, q, k, v,
                                   valid=local_value(valid),
                                   q_offset=local_value(q_offset))
        q = gather_dim(q, 2)
    B, Tq, Hq, D = q.shape
    _, Tk, Hk, _ = k.shape
    Dv = v.shape[-1]
    G = Hq // Hk
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = reshape(q, B, Tq, Hk, G, D).float() * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    q_pos = q_offset + torch.arange(Tq, device=dev)
    causal = q_pos[:, None] >= torch.arange(Tk, device=dev)[None, :]
    mask = valid[None, :] & causal
    s = torch.where(mask[None, None, None], s, torch.full((), -1e30, device=dev))
    # fp32 softmax, then probs cast to the cache dtype before the PV
    # contraction (as the reference does)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return reshape(o, B, Tq, Hq, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v3): latent-compressed KV + decoupled RoPE
# ---------------------------------------------------------------------------

def mla_init(gen, cfg, dtype, device) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": dense_init(gen, d, qr, dtype, device),
        "q_a_norm": ones(qr, dtype, device),
        "wq_b": dense_init(gen, qr, H * (dn + dr), dtype, device),
        "wkv_a": dense_init(gen, d, kvr + dr, dtype, device),
        "kv_a_norm": ones(kvr, dtype, device),
        "wkv_b": dense_init(gen, kvr, H * (dn + dv), dtype, device),
        "wo": dense_init(gen, H * dv, d, dtype, device),
    }


def _latent_scores(q, c):
    """``einsum("bthr,bsr->bhts")`` as one batched matmul of the decode
    queries against the latent cache (on a mesh DTensor's einsum loses
    the cache's batch split in its views).  On a mesh whose cache holds
    its seq dim whole, each rank scores its own batch and q-head shards
    against its rows of the cache, no head gathered; where the cache's
    seq dim is split, the few query tokens' heads are gathered instead."""
    B, T, H, R = q.shape
    S = c.shape[1]
    if sharded_on(q, 2) and is_dtensor(c) and not sharded_on(c, 1):
        from torch.distributed.tensor import Replicate, Shard
        mesh = q.device_mesh
        # the cache's batch split leads (q is the small side); q keeps its
        # head split on the other mesh dims
        cpl = tuple(Shard(0) if p.is_shard(0) else Replicate()
                    for p in c.placements)
        qpl = tuple(cp if cp.is_shard(0) else p if p.is_shard(2)
                    else Replicate() for p, cp in zip(q.placements, cpl))
        q_loc = place(q, mesh, qpl).to_local().float()
        c_loc = place(c, mesh, cpl).to_local()
        b, _, h, _ = q_loc.shape
        s = torch.bmm(q_loc.reshape(b, T * h, R),
                      c_loc.float().transpose(1, 2))
        s = assemble(s.reshape(b, T, h, S), mesh, qpl, (B, T, H, S))
        return s.permute(0, 2, 1, 3)
    q = reshape(gather_dim(q, 2).float(), B, T * H, R)
    s = torch.bmm(q, c.float().transpose(1, 2))             # (B, T*H, S)
    return reshape(s, B, T, H, S).permute(0, 2, 1, 3)


def mla_attention(p, x, cfg, shd: Policy, *, positions, cache=None):
    """DeepSeek-V3 Multi-head Latent Attention.

    Prefill/train: expanded form.  Decode: *weight-absorbed* form scoring
    directly against the latent cache (the MLA serving optimisation) —
    cache holds only (c_kv[kvr], k_pe[dr]) per position, written in place.
    """
    B, T, d = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    dev = x.device
    q = rms_norm(x @ p["wq_a"], p["q_a_norm"]) @ p["wq_b"]
    q = reshape(q, B, T, H, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    kv_a = x @ p["wkv_a"]
    c_kv, k_pe = kv_a[..., :kvr], kv_a[..., kvr:]
    c_kv = rms_norm(c_kv, p["kv_a_norm"])
    pos = positions[0] if positions.dim() == 3 else positions
    cos, sin = rope_cos_sin(pos, dr, cfg.rope_theta)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe[:, :, None, :], cos, sin)[:, :, 0]  # shared across heads
    scale = 1.0 / math.sqrt(dn + dr)

    w_kv_b = reshape(p["wkv_b"], kvr, H, dn + dv)
    w_uk, w_uv = w_kv_b[..., :dn], w_kv_b[..., dn:]

    if cache is not None:
        idx = cache["len"]
        cc = cache_insert(cache["c_kv"], c_kv, idx)
        cp = cache_insert(cache["k_pe"], k_pe, idx)
        new_cache = {"c_kv": cc, "k_pe": cp, "len": idx + T}
        # absorbed scoring: q_abs (B,T,H,kvr) = q_nope . W_uk
        q_nope = shd.constrain(q_nope, "batch", None, "decode_q_heads", None,
                               name="mla_decode_q")
        q_pe = shd.constrain(q_pe, "batch", None, "decode_q_heads", None,
                             name="mla_decode_qpe")
        q_abs = torch.einsum("bthn,rhn->bthr", q_nope.float(), w_uk.float())
        s = _latent_scores(q_abs, cc) + _latent_scores(q_pe, cp)
        s = s * scale
        kv_pos = torch.arange(cc.shape[1], device=dev)
        q_pos = idx + torch.arange(T, device=dev)
        mask = (kv_pos[None, :] < idx + T) & (q_pos[:, None] >= kv_pos[None, :])
        s = torch.where(mask[None, None], s, torch.full((), -1e30, device=dev))
        pr = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhts,bsr->bthr", pr, cc.float())
        o = torch.einsum("bthr,rhv->bthv", o_lat, w_uv.float())
        o = o.to(x.dtype)
    else:
        new_cache = None
        kv = torch.einsum("btr,rhe->bthe", c_kv, w_kv_b.to(c_kv.dtype))
        k_nope, v = kv[..., :dn], kv[..., dn:]
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, T, H, dr)], -1)
        qf = torch.cat([q_nope, q_pe], -1)
        qf = shd.constrain(qf, "batch", "seq", "heads", None, name="mla_q")
        k = shd.constrain(k, "batch", "seq", "heads", None, name="mla_k")
        if T > 1024:
            o = flash_attention_ref(qf, k, v, causal=True,
                                    q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        else:
            o = plain_attention(qf, k, v, causal=True)
    of = reshape(o, B, T, H * dv)
    of = shd.constrain(of, "batch", "seq", "attn_o_feat", name="mla_o_flat")
    out = of @ p["wo"]
    return shd.constrain(out, "batch", "seq_act", "embed", name="mla_out"), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_init(gen, d: int, d_ff: int, dtype, device) -> dict:
    return {"wi": dense_init(gen, d, 2 * d_ff, dtype, device),
            "wo": dense_init(gen, d_ff, d, dtype, device)}


def _weight_moves(x, w) -> bool:
    """On a mesh that splits ``w``'s output features, ``x @ w`` then split
    into column pieces gathers the product (DTensor splits evenly, so the
    pieces' bounds cut the shards; GSPMD permutes them).  Where this
    rank's tokens outnumber ``w``'s input features, splitting ``w`` into
    its column blocks first moves fewer bytes: a weight, not every
    token's features (:func:`_column_blocks`)."""
    if not sharded_on(w, w.ndim - 1):
        return False
    tokens = x.numel() // x.shape[-1] // (split_ways(x, 0)
                                          * split_ways(x, 1))
    return tokens > w.shape[-2]


def _column_blocks(w, sizes, shd: Policy, axes):
    """``w`` (d_in, d_out) cut into column blocks of ``sizes``, each with
    its columns split as the logical axis in ``axes`` (None: whole)
    (:func:`repro_torch.sharding.column_blocks`)."""
    return column_blocks(w, sizes, [
        placements(shd.mesh, shd.guarded_spec((w.shape[0], n), None, ax))
        for n, ax in zip(sizes, axes)])


def swiglu_mlp(p, x, shd: Policy):
    if _weight_moves(x, p["wi"]):
        f = p["wi"].shape[-1] // 2
        gate, up = (shd.constrain(x @ w, "batch", "seq", "ff", name="mlp_h")
                    for w in _column_blocks(p["wi"], (f, f), shd,
                                            ("ff", "ff")))
    else:
        h = x @ p["wi"]
        h = shd.constrain(h, "batch", "seq", "ff", name="mlp_h")
        gate, up = h.chunk(2, dim=-1)
    h = F.silu(gate) * up
    out = h @ p["wo"]
    return shd.constrain(out, "batch", "seq_act", "embed", name="mlp_out")


# ---------------------------------------------------------------------------
# MoE (granite / deepseek-v3): top-k routing, capacity, shared expert
# ---------------------------------------------------------------------------

def moe_init(gen, cfg, dtype, device) -> dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    scale_i = 1.0 / math.sqrt(d)
    scale_o = 1.0 / math.sqrt(ff)
    p = {
        "router": dense_init(gen, d, e, F32, device),
        "w_up": (normal(gen, (e, d, 2 * ff), device) * scale_i).to(dtype),
        "w_down": (normal(gen, (e, ff, d), device) * scale_o).to(dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = swiglu_init(gen, d, cfg.moe_d_ff * cfg.n_shared_experts,
                                  dtype, device)
    return p


def one_hot(idx, n: int, dtype):
    """``idx[..., None] == arange(n)`` as ``dtype`` (no host sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_block(p, x, cfg, shd: Policy):
    """Grouped dispatch-einsum MoE (Switch/MaxText style), static capacity.

    Tokens are partitioned into contiguous *groups*, routing capacity is
    per (group, expert), and the dispatch one-hot is (G, Ng, E, cap).
    Tokens beyond capacity are dropped (the residual path carries them).
    """
    B, T, d = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    N = B * T
    gs = min(getattr(cfg, "moe_group_size", 512), N)
    if N % gs:
        gs = N
    G = N // gs
    xg = reshape(x, G, gs, d)
    xg = shd.constrain(xg, "batch", None, None, name="moe_groups")
    logits = xg.float() @ p["router"]                        # (G, Ng, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k breaks ties toward the lower index: a stable descending
    # sort (torch.topk leaves the order of ties unspecified)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :K], gate_idx[..., :K]  # (G, Ng, K)
    if cfg.moe_renorm:
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)
    cap = max(int(cfg.moe_capacity_factor * gs * K / E), 1)
    # position of each (token, k) within its (group, expert) queue
    onehot = one_hot(gate_idx, E, torch.int32)               # (G, Ng, K, E)
    flat = reshape(onehot, G, gs * K, E)
    pos_in_e = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = reshape((pos_in_e * flat).sum(-1, dtype=torch.int32), G, gs, K)
    keep = pos < cap
    # dispatch (G, Ng, E, cap) one-hot
    slot = torch.where(keep, pos, torch.full_like(pos, cap))
    disp = (one_hot(gate_idx, E, x.dtype)[..., None]
            * one_hot(slot, cap + 1, x.dtype)[..., :cap][:, :, :, None, :])
    disp = disp.sum(2)                                       # (G, Ng, E, cap)
    disp = shd.constrain(disp, "batch", None, "experts", None, name="moe_disp")
    xe = torch.einsum("gnec,gnd->gecd", disp, xg)            # (G, E, cap, d)
    xe = shd.constrain(xe, "batch", "experts", None, None, name="moe_xe")
    h = torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    g, u = h.chunk(2, dim=-1)
    h = F.silu(g) * u
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    ye = shd.constrain(ye, "batch", "experts", None, None, name="moe_ye")
    # combine: weight each token's expert outputs by its gate value
    gate_full = (one_hot(gate_idx, E, x.dtype)
                 * gate_vals.to(x.dtype)[..., None]).sum(2)  # (G, Ng, E)
    # weight the dispatch first and contract over (experts, capacity),
    # experts major, in one bmm (the three-operand einsum on a mesh views
    # the split experts in a strided layout that DTensor takes seconds a
    # call to plan)
    w = reshape(disp * gate_full[..., None], G, gs, E * cap)
    y = torch.bmm(w, reshape(ye, G, E * cap, d))
    out = reshape(y, B, T, d)
    if "shared" in p:
        out = out + swiglu_mlp(p["shared"], x, shd)
    # aux losses for training: load-balance (Switch) in fp32
    me = probs.mean((0, 1))                                  # mean router prob
    ce = disp.sum((0, 1, 3)) / torch.clamp_min(disp.sum(), 1.0)  # fraction routed
    aux = E * torch.sum(me * ce)
    return shd.constrain(out, "batch", "seq_act", "embed", name="moe_out"), aux


# ---------------------------------------------------------------------------
# chunked gated linear recurrence — shared by Mamba2 (SSD) and mLSTM
# ---------------------------------------------------------------------------

def _intra_chunk(cc, bb, vv, cum):
    """The intra-chunk term of :func:`chunked_linear_recurrence`, in a
    function of its own so that its (B, nc, C, C, H) temporaries die with
    it: L[i,j] = exp(cum_i - cum_j) for i >= j, masked before exp."""
    chunk = cum.shape[2]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,C,C,H)
    ii = torch.arange(chunk, device=cum.device)
    lmask = ii[:, None] >= ii[None, :]
    diff = torch.where(lmask[None, None, :, :, None], diff,
                       torch.full((), -1e9, device=cum.device))
    L = torch.exp(diff)
    s_intra = torch.einsum("bgihn,bgjhn->bgijh", cc, bb) * L
    return torch.einsum("bgijh,bgjhp->bgihp", s_intra, vv)


def _inter_chunk(cc, bb, vv, cum, tot, initial_state):
    """The inter-chunk term of :func:`chunked_linear_recurrence` from the
    state before the first chunk (None: zeros), and the final state; its
    chunk states die with it."""
    # per-chunk state contribution: sum_j exp(tot - cum_j) b_j v_j^T
    w = torch.exp(tot[:, :, None, :] - cum)                 # (B,nc,C,H)
    chunk_state = torch.einsum("bgjh,bgjhn,bgjhp->bghnp", w, bb, vv)
    # zeros split as the chunk states (on a mesh, not a whole-batch copy)
    S = (torch.zeros_like(chunk_state[:, 0]) if initial_state is None
         else initial_state.float())
    # inter-chunk pass over nc, emitting the state *before* each chunk
    states_in = []
    for g in range(cum.shape[1]):
        states_in.append(S)
        S = S * torch.exp(tot[:, g])[..., None, None] + chunk_state[:, g]
    states_in = torch.stack(states_in, 1)                   # (B,nc,H,N,P)
    return torch.einsum("bgihn,bghnp,bgih->bgihp", cc, states_in,
                        torch.exp(cum)), S


def chunked_linear_recurrence(c, b, v, log_a, *, chunk: int,
                              initial_state=None):
    """y_t = c_t^T S_t,  S_t = exp(log_a_t) * S_{t-1} + b_t v_t^T.

    c, b: (B, T, H, N); v: (B, T, H, P); log_a: (B, T, H) (<= 0).
    Returns (y: (B, T, H, P), final_state: (B, H, N, P)).

    The Mamba-2 SSD chunked algorithm: intra-chunk work is dense matmuls,
    inter-chunk state is a short loop over chunks.
    """
    B, T, H, N = b.shape
    P = v.shape[-1]
    nc = -(-T // chunk)
    pad = nc * chunk - T
    c, b, v, log_a = (_pad_seq(t, pad) for t in (c, b, v, log_a))
    cc = reshape(c, B, nc, chunk, H, N).float()
    bb = reshape(b, B, nc, chunk, H, N).float()
    vv = reshape(v, B, nc, chunk, H, P).float()
    la = reshape(log_a, B, nc, chunk, H).float()
    cum = torch.cumsum(la, dim=2)                   # (B, nc, C, H)
    tot = cum[:, :, -1]                             # (B, nc, H)
    y_intra = _intra_chunk(cc, bb, vv, cum)
    y_inter, S = _inter_chunk(cc, bb, vv, cum, tot, initial_state)
    y = reshape(y_intra + y_inter, B, nc * chunk, H, P)[:, :T]
    return y.to(v.dtype), S


def linear_recurrence_step(S, c_t, b_t, v_t, log_a_t):
    """Single decode step: S' = a*S + b v^T; y = c^T S'.  Functional (S
    is left as it was); the blocks' decode writes S' over the cache's
    state (``kernels.ssd_step``)."""
    S = S.float()
    a = torch.exp(log_a_t.float())[..., None, None]
    S_new = S * a + torch.einsum("bhn,bhp->bhnp", b_t.float(), v_t.float())
    y = torch.einsum("bhn,bhnp->bhp", c_t.float(), S_new)
    return y.to(v_t.dtype), S_new


def _decode_step(use_kernel: bool):
    """The blocks' decode step, which writes S' over the state it is given
    and returns it: the kernel (``ops.ssd_step``) with ``use_kernel``,
    else the plain step in place."""
    from ..kernels import ops, ssd_step
    return ops.ssd_step if use_kernel else ssd_step.ssd_step_plain


# ---------------------------------------------------------------------------
# Mamba2 block (zamba2 backbone)
# ---------------------------------------------------------------------------

def mamba2_init(gen, cfg, dtype, device) -> dict:
    d = cfg.d_model
    di = cfg.ssm_d_inner
    H = cfg.ssm_heads
    N = cfg.ssm_state
    conv_dim = di + 2 * N * cfg.ssm_groups
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * N * cfg.ssm_groups + H,
                              dtype, device),
        "conv_w": (normal(gen, (cfg.ssm_conv, conv_dim), device)
                   * 0.2).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        "D": torch.ones((H,), dtype=F32, device=device),
        "dt_bias": torch.zeros((H,), dtype=F32, device=device),
        "norm_w": ones(di, dtype, device),
        "out_proj": dense_init(gen, di, d, dtype, device),
    }


def _causal_conv(x, w, b):
    """The depthwise causal conv of ``x`` (B, T, C) with taps ``w`` (k,
    C) and bias ``b`` from a zero history, in a function of its own so
    that its padded copy of ``x`` dies with it."""
    B, T, C = x.shape
    k = w.shape[0]
    pad = x.new_zeros((B, k - 1, C))
    xin = torch.cat([pad, x], dim=1)
    out = sum(xin[:, i:i + T] * w[i] for i in range(k))
    return out + b


def _repeat_groups(x, rep: int):
    """(B, T, G, N) -> (B, T, G*rep, N), each group repeated ``rep``
    times in place (``jnp.repeat`` on dim 2)."""
    B, T, G, N = x.shape
    return reshape(x[:, :, :, None, :].expand(B, T, G, rep, N),
                   B, T, G * rep, N)


def _heads_of_groups(x, rep: int, h0: int, h: int):
    """(B, T, G, N) -> (B, T, h, N): the group of each head of [h0, h0 +
    h), ``rep`` heads to a group; of all the heads, :func:`_repeat_groups`."""
    if h0 % rep == 0 and h % rep == 0:
        return _repeat_groups(x[:, :, h0 // rep:(h0 + h) // rep], rep)
    idx = torch.arange(h0, h0 + h, device=x.device) // rep
    return x.index_select(2, idx)


def _ssd_inputs(xbc, dt, A_log, dt_bias, cfg, h: int, h0: int = 0,
                shd: Policy = NO_POLICY):
    """The scan's operands for heads [h0, h0 + h) from the conv's
    activated output ``xbc`` (B, T, h*P + 2*N*G) and the projection's
    ``dt`` (B, T, h), with ``A_log`` and ``dt_bias`` of those heads:
    (xs (B,T,h,P), c, b (B,T,h,N), xdt (B,T,h,P), log_a (B,T,h)).  On a
    mesh (``shd``: a decode step, with no backward) all of them take the
    heads' split, b and c as slices of their whole value."""
    B, T = xbc.shape[:2]
    N, G = cfg.ssm_state, cfg.ssm_groups
    P = cfg.ssm_d_inner // cfg.ssm_heads
    rep = cfg.ssm_heads // G
    xs, Bc, Cc = xbc.split([h * P, N * G, N * G], dim=-1)
    xs = shd.constrain(reshape(xs, B, T, h, P), "batch", "seq", "heads", None)
    Bh, Ch = (shd.constrain(_heads_of_groups(reshape(t, B, T, G, N), rep,
                                             h0, h),
                            "batch", "seq", "heads", None) for t in (Bc, Cc))
    dt = shd.constrain(dt, "batch", "seq", "heads")
    dt = F.softplus(dt.float() + dt_bias)                          # (B,T,h)
    A = -torch.exp(A_log)
    log_a = dt * A                                                 # (B,T,h)
    xdt = xs * dt[..., None].to(xs.dtype)
    return xs, Ch, Bh, xdt, log_a


def _mamba2_out(p, y, z, shd: Policy):
    """The Mamba-2 block's gated norm and output projection of the scan's
    output ``y`` (B, T, di)."""
    y = rms_norm(y * F.silu(z[:, :y.shape[1]]), p["norm_w"])
    out = y @ p["out_proj"]
    return shd.constrain(out, "batch", "seq_act", "embed", name="ssm_out")


def mamba2_block(p, x, cfg, shd: Policy, *, state=None,
                 use_kernel: bool = False):
    """Mamba-2 (SSD).  state = dict(ssm (B,H,N,P), conv (B, k-1, convdim))
    for single-step decode; None for full-sequence work, whose returned
    state then holds the conv tail a decode continues from.  On a mesh a
    sequence runs on each rank's heads (:func:`_mamba2_on_heads`); a
    decode step splits x dt, b and c as the state's heads."""
    if state is None and is_dtensor(x):
        return _mamba2_on_heads(p, x, cfg, shd, use_kernel)
    B, T, d = x.shape
    di, H, N, G = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = di + 2 * N * G
    # the input projection, split into (z, xbc, dt); where the weight moves
    # (:func:`_weight_moves`), z is split as the ff axis, xbc and dt whole
    sizes = [di, conv_dim, p["in_proj"].shape[-1] - di - conv_dim]
    if _weight_moves(x, p["in_proj"]):
        z, xbc, dt = (x @ w for w in _column_blocks(
            p["in_proj"], sizes, shd, ("ff", None, None)))
    else:
        z, xbc, dt = (x @ p["in_proj"]).split(sizes, dim=-1)
    z = shd.constrain(z, "batch", "seq", "ff", name="ssm_z")
    # depthwise causal conv over (x, B, C)
    if state is not None:
        conv_in = torch.cat([state["conv"], xbc], dim=1)
        new_conv = conv_in[:, -(cfg.ssm_conv - 1):]
        xbc = torch.einsum("bkc,kc->bc", conv_in[:, -cfg.ssm_conv:],
                           p["conv_w"])[:, None, :] + p["conv_b"]
    else:
        # the conv tail a decode continues from (the last k-1 rows, copied
        # so that a prefill's cache does not hold the whole projection)
        new_conv = xbc[:, -(cfg.ssm_conv - 1):].clone()
        xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc)
    xs, Ch, Bh, xdt, log_a = _ssd_inputs(xbc, dt, p["A_log"], p["dt_bias"],
                                         cfg, H, shd=shd)
    if state is not None:
        y, S = _decode_step(use_kernel)(state["ssm"], Ch[:, 0], Bh[:, 0],
                                        xdt[:, 0], log_a[:, 0])
        y = y[:, None]
    elif use_kernel:
        from ..kernels import ops as K
        y, S = K.ssd_scan(Ch, Bh, xdt, log_a, chunk=cfg.ssm_chunk)
    else:
        y, S = chunked_linear_recurrence(Ch, Bh, xdt, log_a,
                                         chunk=cfg.ssm_chunk)
    y = y + xs * p["D"][None, None, :, None].to(xs.dtype)
    y = reshape(y, B, y.shape[1], di)
    return _mamba2_out(p, y, z, shd), {"ssm": S, "conv": new_conv}


def _mamba2_on_heads(p, x, cfg, shd: Policy, use_kernel: bool):
    """:func:`mamba2_block` over a sequence on a mesh, the conv and the
    scan on each rank's heads.  The heads split over the mesh dims that
    split the ff axis the same way (where they do not, they stay whole),
    so that a rank's heads are its columns of z and the gate and the norm
    run on them as they are.  The input projection gives xs (split as
    z), B and C (whole) and dt (split as the heads); from there to the
    scan's output the block runs meshless on this rank's shards: the
    conv on its columns of xs and on B and C, the scan (the kernel
    through its mesh entry) on its heads.  Each rank's part of B's and
    C's gradient, and of the parameters' (the conv taps, ``A_log``,
    ``dt_bias``, ``D``), returns as a partial sum over the mesh dims that
    split the work: the projection's backward carries it on, so that the
    input's gradient is made whole once."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    B, T, _ = x.shape
    di, H, N, G = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    P, k = di // H, cfg.ssm_conv
    ff = shd.guarded_spec((B, T, di), "batch", "seq", "ff")[2]
    split = ff is not None and \
        ff == shd.guarded_spec((B, T, H), "batch", "seq", "heads")[2]
    xs_ax, dt_ax = ("ff", "heads") if split else (None, None)
    sizes = [di, di, 2 * N * G, H]
    if _weight_moves(x, p["in_proj"]):
        z, xs, bc, dt = (x @ w for w in _column_blocks(
            p["in_proj"], sizes, shd, ("ff", xs_ax, None, dt_ax)))
    else:
        z, xs, bc, dt = (x @ p["in_proj"]).split(sizes, dim=-1)
    z = shd.constrain(z, "batch", "seq", "ff", name="ssm_z")
    xs = shd.constrain(xs, "batch", "seq", xs_ax)
    dt = shd.constrain(dt, "batch", "seq", dt_ax)
    bc = shd.constrain(bc, "batch", "seq", None, partial_grad=True)
    mesh, pl = xs.device_mesh, tuple(xs.placements)
    rep = tuple(Replicate() for _ in pl)
    wpl = tuple(Partial() if q.is_shard() else Replicate() for q in pl)

    def whole(w):
        # a parameter whole on this rank; its gradient a partial sum over
        # the mesh dims that split the work
        return to_local(place(w, mesh, rep), wpl)
    shape, off = local_shape_and_offset((B, T, H), mesh, dt.placements)
    h0, h = off[2], shape[2]
    cols = (slice(h0 * P, (h0 + h) * P), slice(di, None))
    cw, cb = whole(p["conv_w"]), whole(p["conv_b"])
    xbc = torch.cat([to_local(xs), to_local(bc, tuple(
        Partial() if q.is_shard(2) else b
        for q, b in zip(pl, bc.placements)))], dim=-1)
    xbc = F.silu(_causal_conv(xbc, torch.cat([cw[:, c] for c in cols], -1),
                              torch.cat([cb[c] for c in cols])))
    heads = slice(h0, h0 + h)
    xs_l, Ch, Bh, xdt, log_a = _ssd_inputs(
        xbc, to_local(dt), whole(p["A_log"])[heads],
        whole(p["dt_bias"])[heads], cfg, h, h0)
    spl = tuple(Shard(1) if q.is_shard(2) else q for q in pl)
    if use_kernel:
        from ..kernels import ops as K
        y, S = K.ssd_scan(*(assemble(t, mesh, pl, (B, T, H) + t.shape[3:])
                            for t in (Ch, Bh, xdt, log_a)),
                          chunk=cfg.ssm_chunk)
        y = y.to_local()
    else:
        y, S = chunked_linear_recurrence(Ch, Bh, xdt, log_a,
                                         chunk=cfg.ssm_chunk)
        S = assemble(S, mesh, spl, (B, H, N, P))
    y = y + xs_l * whole(p["D"])[heads][None, None, :, None].to(xs_l.dtype)
    y = assemble(y.reshape(y.shape[0], T, h * P), mesh, pl, (B, T, di))
    if not split:
        # y whole where z is split: its gradient gathered once, here
        y = hold_grad(y)
    # the conv tail a decode continues from
    new_conv = torch.cat([xs[:, -(k - 1):], bc[:, -(k - 1):]], dim=-1)
    return _mamba2_out(p, y, z, shd), {"ssm": S, "conv": new_conv}


# ---------------------------------------------------------------------------
# xLSTM blocks (mLSTM: matrix memory; sLSTM: scalar memory + state mixing)
# ---------------------------------------------------------------------------

def mlstm_init(gen, cfg, dtype, device) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    di = cfg.xlstm_d_inner
    return {
        "up": dense_init(gen, d, 2 * di, dtype, device),
        "wq": dense_init(gen, di, di, dtype, device),
        "wk": dense_init(gen, di, di, dtype, device),
        "wv": dense_init(gen, di, di, dtype, device),
        "wif": dense_init(gen, di, 2 * H, dtype, device),  # input+forget gates
        "norm_w": ones(di, dtype, device),
        "down": dense_init(gen, di, d, dtype, device),
    }


def mlstm_block(p, x, cfg, shd: Policy, *, state=None,
                use_kernel: bool = False):
    """mLSTM: exponentially-gated matrix memory == gated linear attention,
    on the same chunked recurrence as Mamba2."""
    B, T, d = x.shape
    H = cfg.n_heads
    di = cfg.xlstm_d_inner
    dh = di // H
    h = x @ p["up"]
    hx, hg = h.chunk(2, dim=-1)
    q = reshape(hx @ p["wq"], B, T, H, dh)
    k = reshape(hx @ p["wk"], B, T, H, dh) / math.sqrt(dh)
    v = reshape(hx @ p["wv"], B, T, H, dh)
    gates = (hx @ p["wif"]).float()
    i_g, f_g = gates.chunk(2, dim=-1)                         # (B,T,H)
    log_f = -F.softplus(-f_g)                                 # log sigmoid
    # stabilised exponential input gate: fold exp(i) into k
    k = k * torch.exp(torch.clamp_max(i_g, 8.0))[..., None].to(k.dtype)
    # normaliser: append ones column to v
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    if state is not None:
        y_aug, S = _decode_step(use_kernel)(state["ssm"], q[:, 0], k[:, 0],
                                            v_aug[:, 0], log_f[:, 0])
        y_aug = y_aug[:, None]
    elif use_kernel:
        from ..kernels import ops as K
        y_aug, S = K.ssd_scan(q, k, v_aug, log_f, chunk=cfg.ssm_chunk)
    else:
        y_aug, S = chunked_linear_recurrence(q, k, v_aug, log_f,
                                             chunk=cfg.ssm_chunk)
    new_state = {"ssm": S}
    y, nrm = y_aug[..., :dh], y_aug[..., dh:]
    y = y / torch.clamp_min(nrm.abs(), 1.0).to(y.dtype)
    y = reshape(y, B, y.shape[1], di)
    y = rms_norm(y, p["norm_w"]) * F.silu(hg[:, :y.shape[1]])
    out = y @ p["down"]
    return shd.constrain(out, "batch", "seq_act", "embed", name="mlstm_out"), new_state


def slstm_init(gen, cfg, dtype, device) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    return {
        "w_in": dense_init(gen, d, 4 * d, dtype, device),   # z i f o pre-acts
        "r": (normal(gen, (H, dh, 4 * dh), device)
              / math.sqrt(dh)).to(dtype),                   # block-diag recurrent
        "bias": torch.zeros((4 * d,), dtype=dtype, device=device),
        "norm_w": ones(d, dtype, device),
        "ff": swiglu_init(gen, d, cfg.slstm_ff, dtype, device),
    }


def slstm_block(p, x, cfg, shd: Policy, *, state=None):
    """sLSTM: scalar memories, exponential gating, per-head state mixing.
    Truly sequential: a loop over time."""
    B, T, d = x.shape
    H = cfg.n_heads
    dh = d // H
    pre_all = x @ p["w_in"] + p["bias"]                      # (B,T,4d)
    r = p["r"].float()

    if state is None:
        zeros = torch.zeros((B, H, dh), dtype=F32, device=x.device)
        carry = (zeros, zeros, zeros, zeros)
    else:
        carry = tuple(state["slstm"])
    hs = []
    for t in range(T):
        c, n, hprev, m = carry                               # (B,H,dh) each
        rec = torch.einsum("bhe,hef->bhf", hprev, r)
        pre = reshape(pre_all[:, t], B, H, 4 * dh).float() + rec
        z, i, f, o = pre.chunk(4, dim=-1)
        z = torch.tanh(z)
        o = torch.sigmoid(o)
        log_f = -F.softplus(-f)
        m_new = torch.maximum(log_f + m, i)
        i_p = torch.exp(i - m_new)
        f_p = torch.exp(log_f + m - m_new)
        c_new = f_p * c + i_p * z
        n_new = f_p * n + i_p
        h_new = o * c_new / torch.clamp_min(n_new.abs(), 1.0)
        carry = (c_new, n_new, h_new, m_new)
        hs.append(h_new)
    h = reshape(torch.stack(hs, 1), B, T, d).to(x.dtype)
    h = rms_norm(h, p["norm_w"])
    out = h + swiglu_mlp(p["ff"], h, shd)
    return shd.constrain(out, "batch", "seq_act", "embed", name="slstm_out"), \
        {"slstm": carry}


# ---------------------------------------------------------------------------
# cross-attention (seamless enc-dec)
# ---------------------------------------------------------------------------

def cross_attn_init(gen, cfg, dtype, device) -> dict:
    d, dh = cfg.d_model, cfg.d_head
    return {
        "wq": dense_init(gen, d, cfg.n_heads * dh, dtype, device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * dh, dtype, device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * dh, dtype, device),
        "wo": dense_init(gen, cfg.n_heads * dh, d, dtype, device),
    }


def cross_attention(p, x, memory, cfg, shd: Policy):
    B, T, d = x.shape
    S = memory.shape[1]
    dh = cfg.d_head
    q = reshape(x @ p["wq"], B, T, cfg.n_heads, dh)
    k = reshape(memory @ p["wk"], B, S, cfg.n_kv_heads, dh)
    v = reshape(memory @ p["wv"], B, S, cfg.n_kv_heads, dh)
    q = shd.constrain(q, "batch", "seq", "heads", None, name="xattn_q")
    if S > 2048:
        o = flash_attention_ref(q, k, v, causal=False,
                                q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    else:
        o = plain_attention(q, k, v, causal=False)
    of = reshape(o, B, T, cfg.n_heads * dh)
    of = shd.constrain(of, "batch", "seq", "attn_o_feat", name="xattn_o_flat")
    out = of @ p["wo"]
    return shd.constrain(out, "batch", "seq_act", "embed", name="xattn_out")
