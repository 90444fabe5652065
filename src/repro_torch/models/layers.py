"""Model-zoo primitive layers (PyTorch, functional, shard-annotated).

Port of ``repro.models.layers``, function for function.

Conventions:
* activations are (batch, seq, ...) laid out as ``B T H D`` for attention;
* every layer is ``fn(params, x, cfg, shd, ...)`` with ``shd`` a
  ``repro_torch.sharding.Policy`` (the identity on one device);
* on a mesh the same code runs on DTensors.  Where DTensor has no rule
  for a view or contraction the reference's GSPMD would take (a split
  the view cannot carry, the decode scores' strided batch), the split is
  gathered at that site (``sharding.reshape``, ``_groupable``,
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

from ..sharding import (Policy, gather_dim, is_dtensor, local_shape_and_offset,
                        place, reshape, split_ways)

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
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
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


def _groupable(q, Hk: int):
    """``q`` ready to view its heads as (Hk, G): on a mesh whose split of
    the q heads does not divide the kv heads, the heads are gathered
    first (DTensor cannot split one mesh axis over the (Hk, G) pair)."""
    if Hk % split_ways(q, 2):
        return gather_dim(q, 2)
    return q


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        q_chunk: int = 512, kv_chunk: int = 512,
                        q_offset: int = 0):
    """Online-softmax blockwise attention.

    q: (B, Tq, Hq, D), k/v: (B, Tk, Hk, D) with Hq % Hk == 0.  Never
    materialises the (Tq, Tk) score matrix; memory is O(q_chunk x kv_chunk).
    ``q_offset`` positions q tokens at kv index ``q_offset + i`` for causal
    masking (prefill continuation / decode).
    """
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
    qp = _pad_seq(_groupable(q, Hk), nq * q_chunk - Tq)
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
    differ from q/k's (MLA)."""
    B, Tq, Hq, D = q.shape
    _, Tk, Hk, _ = k.shape
    Dv = v.shape[-1]
    G = Hq // Hk
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = reshape(_groupable(q, Hk), B, Tq, Hk, G, D).float() * scale
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
    k = shd.constrain(k, "batch", "seq", "kv_heads", None, name="attn_k")
    v = shd.constrain(v, "batch", "seq", "kv_heads", None, name="attn_v")
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
    """Attention of T=1..few query tokens over a padded cache."""
    B, Tq, Hq, D = q.shape
    _, Tk, Hk, _ = k.shape
    Dv = v.shape[-1]
    G = Hq // Hk
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = reshape(_groupable(q, Hk), B, Tq, Hk, G, D).float() * scale
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
    """``einsum("bthr,bsr->bhts")`` as one batched matmul of the (small,
    heads gathered) decode queries against the latent cache: on a mesh
    DTensor's einsum loses the cache's batch split in its views."""
    B, T, H, R = q.shape
    q = reshape(gather_dim(q, 2).float(), B, T * H, R)
    s = torch.bmm(q, c.float().transpose(1, 2))             # (B, T*H, S)
    return reshape(s, B, T, H, c.shape[1]).permute(0, 2, 1, 3)


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


def swiglu_mlp(p, x, shd: Policy):
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

    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j, masked before exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,C,C,H)
    ii = torch.arange(chunk, device=v.device)
    lmask = ii[:, None] >= ii[None, :]
    diff = torch.where(lmask[None, None, :, :, None], diff,
                       torch.full((), -1e9, device=v.device))
    L = torch.exp(diff)
    s_intra = torch.einsum("bgihn,bgjhn->bgijh", cc, bb) * L
    y_intra = torch.einsum("bgijh,bgjhp->bgihp", s_intra, vv)

    # per-chunk state contribution: sum_j exp(tot - cum_j) b_j v_j^T
    w = torch.exp(tot[:, :, None, :] - cum)                 # (B,nc,C,H)
    chunk_state = torch.einsum("bgjh,bgjhn,bgjhp->bghnp", w, bb, vv)

    # inter-chunk pass over nc, emitting the state *before* each chunk
    S = (torch.zeros((B, H, N, P), dtype=F32, device=v.device)
         if initial_state is None else initial_state.float())
    states_in = []
    for g in range(nc):
        states_in.append(S)
        S = S * torch.exp(tot[:, g])[..., None, None] + chunk_state[:, g]
    states_in = torch.stack(states_in, 1)                   # (B,nc,H,N,P)
    y_inter = torch.einsum("bgihn,bghnp,bgih->bgihp", cc, states_in,
                           torch.exp(cum))
    y = reshape(y_intra + y_inter, B, nc * chunk, H, P)[:, :T]
    return y.to(v.dtype), S


def linear_recurrence_step(S, c_t, b_t, v_t, log_a_t):
    """Single decode step: S' = a*S + b v^T; y = c^T S'."""
    S = S.float()
    a = torch.exp(log_a_t.float())[..., None, None]
    S_new = S * a + torch.einsum("bhn,bhp->bhnp", b_t.float(), v_t.float())
    y = torch.einsum("bhn,bhnp->bhp", c_t.float(), S_new)
    return y.to(v_t.dtype), S_new


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


def _repeat_groups(x, rep: int):
    """(B, T, G, N) -> (B, T, G*rep, N), each group repeated ``rep``
    times in place (``jnp.repeat`` on dim 2)."""
    B, T, G, N = x.shape
    return reshape(x[:, :, :, None, :].expand(B, T, G, rep, N),
                   B, T, G * rep, N)


def mamba2_block(p, x, cfg, shd: Policy, *, state=None,
                 use_kernel: bool = False):
    """Mamba-2 (SSD).  state = dict(ssm (B,H,N,P), conv (B, k-1, convdim))
    for single-step decode; None for full-sequence work."""
    B, T, d = x.shape
    di, H, N, G = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    P = di // H
    conv_dim = di + 2 * N * G
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = zxbcdt.split([di, conv_dim, zxbcdt.shape[-1] - di - conv_dim],
                              dim=-1)
    z = shd.constrain(z, "batch", "seq", "ff", name="ssm_z")
    # depthwise causal conv over (x, B, C)
    if state is not None:
        conv_in = torch.cat([state["conv"], xbc], dim=1)
        new_conv = conv_in[:, -(cfg.ssm_conv - 1):]
        xbc = torch.einsum("bkc,kc->bc", conv_in[:, -cfg.ssm_conv:],
                           p["conv_w"])[:, None, :] + p["conv_b"]
    else:
        new_conv = None
        pad = xbc.new_zeros((B, cfg.ssm_conv - 1, conv_dim))
        xin = torch.cat([pad, xbc], dim=1)
        xbc = sum(xin[:, i:i + T] * p["conv_w"][i] for i in range(cfg.ssm_conv))
        xbc = xbc + p["conv_b"]
    xbc = F.silu(xbc)
    xs, Bc, Cc = xbc.split([di, N * G, xbc.shape[-1] - di - N * G], dim=-1)
    Tx = xs.shape[1]
    xs = reshape(xs, B, Tx, H, P)
    Bc = reshape(Bc, B, Tx, G, N)
    Cc = reshape(Cc, B, Tx, G, N)
    rep = H // G
    Bh = _repeat_groups(Bc, rep)
    Ch = _repeat_groups(Cc, rep)
    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,T,H)
    A = -torch.exp(p["A_log"])
    log_a = dt * A                                                 # (B,T,H)
    xdt = xs * dt[..., None].to(xs.dtype)
    if state is not None:
        y, S = linear_recurrence_step(state["ssm"], Ch[:, 0], Bh[:, 0],
                                      xdt[:, 0], log_a[:, 0])
        y = y[:, None]
        new_state = {"ssm": S, "conv": new_conv}
    elif use_kernel:
        from ..kernels import ops as K
        y, S = K.ssd_scan(Ch, Bh, xdt, log_a, chunk=cfg.ssm_chunk)
        new_state = {"ssm": S, "conv": None}
    else:
        y, S = chunked_linear_recurrence(Ch, Bh, xdt, log_a,
                                         chunk=cfg.ssm_chunk)
        new_state = {"ssm": S, "conv": None}
    y = y + xs * p["D"][None, None, :, None].to(xs.dtype)
    y = reshape(y, B, y.shape[1], di)
    y = rms_norm(y * F.silu(z[:, :y.shape[1]]), p["norm_w"])
    out = y @ p["out_proj"]
    return shd.constrain(out, "batch", "seq_act", "embed", name="ssm_out"), new_state


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
        y_aug, S = linear_recurrence_step(state["ssm"], q[:, 0], k[:, 0],
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
