"""Plain reference of the Zamba2 language model (block pattern
``zamba2``): the full forward over whole sequences, no cache.

From the token embedding, ``n_layers`` Mamba-2 blocks, each closed every
``zamba_attn_every`` layers by one use of the shared attention block,
then the final norm and the head:

* h <- h + Mamba2(rms_norm(h, ln1)): the input projection gives z (di),
  the conv input (x, B, C: di + 2 N G) and dt (H); a depthwise causal
  conv of ``ssm_conv`` taps from a zero history (the last tap on the
  current token) plus its bias, then silu; dt <- softplus(dt + dt_bias),
  log_a = -exp(A_log) dt; the scan of v = x dt with c = C, b = B (each
  group shared by H / G consecutive heads), plus D x; then
  rms_norm(y silu(z), norm_w) times the output projection;
* h <- h + Attention(rms_norm(h, ln)) with the shared block's weights:
  rotary embeddings (half-split, theta ``rope_theta``) on q and k,
  causal softmax attention, the output projection.  The block has no
  MLP, no per-use adapters and does not see the original embeddings:
  a departure of the port's zamba2 pattern from the published model.

Everything is float32 with TF32 off (products' operands through ``rnd``);
the weights are the bf16 tree the port serves, read as float32, one
layer at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import attention, ssd_scan

# the Mamba-2 block's gated norm keeps its own epsilon
GATE_NORM_EPS = 1e-6


def rms_norm(x, w, eps: float):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x, positions, theta: float):
    """Rotary embeddings on x (B, T, H, D), halves rotated as pairs."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    ang = positions[:, None].float() * inv[None, :]               # T, D/2
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mamba2(p: dict, x, cfg: dict, rnd):
    B, T, d = x.shape
    di = cfg["ssm_expand"] * d
    N, G, P = cfg["ssm_state"], cfg["ssm_groups"], cfg["ssm_headdim"]
    H = di // P
    conv_dim = di + 2 * N * G
    proj = rnd(x) @ rnd(p["in_proj"].float())
    z, xbc, dt = proj.split([di, conv_dim, H], dim=-1)
    w, k = p["conv_w"].float(), cfg["ssm_conv"]
    xin = torch.cat([xbc.new_zeros((B, k - 1, conv_dim)), xbc], dim=1)
    xbc = sum(xin[:, i:i + T] * w[i] for i in range(k)) + p["conv_b"].float()
    xbc = F.silu(xbc)
    xs, Bc, Cc = xbc.split([di, N * G, N * G], dim=-1)
    xs = xs.reshape(B, T, H, P)
    rep = H // G
    Bh = Bc.reshape(B, T, G, N).repeat_interleave(rep, dim=2)
    Ch = Cc.reshape(B, T, G, N).repeat_interleave(rep, dim=2)
    dt = F.softplus(dt + p["dt_bias"].float())
    log_a = -torch.exp(p["A_log"].float()) * dt
    y, _ = ssd_scan(Ch, Bh, xs * dt[..., None], log_a, rnd=rnd,
                    chunk=cfg["ssm_chunk"])
    y = (y + xs * p["D"].float()[None, None, :, None]).reshape(B, T, di)
    y = rms_norm(y * F.silu(z), p["norm_w"], GATE_NORM_EPS)
    return rnd(y) @ rnd(p["out_proj"].float())


def shared_attention(p: dict, x, cfg: dict, rnd):
    B, T, d = x.shape
    H, Hk, D = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    pos = torch.arange(T, device=x.device)
    xr = rnd(x)
    q = (xr @ rnd(p["wq"].float())).reshape(B, T, H, D)
    k = (xr @ rnd(p["wk"].float())).reshape(B, T, Hk, D)
    v = (xr @ rnd(p["wv"].float())).reshape(B, T, Hk, D)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    o = attention(q, k, v, rnd=rnd, causal=True).reshape(B, T, H * D)
    return rnd(o) @ rnd(p["wo"].float())


def logits(params: dict, tokens, cfg: dict, rnd, positions=None):
    """float32 logits (B, len(positions), V) of ``tokens`` (B, T) at
    ``positions`` (all by default)."""
    eps = cfg["norm_eps"]
    h = rnd(params["embed"].float())[tokens.long()]
    blocks, sa = params["blocks"], params["shared_attn"]
    for i in range(cfg["n_layers"]):
        lp = {"ln1": blocks["ln1"][i],
              **{k: v[i] for k, v in blocks["mamba"].items()}}
        h = h + mamba2(lp, rms_norm(h, lp["ln1"], eps), cfg, rnd)
        if (i + 1) % cfg["zamba_attn_every"] == 0:
            h = h + shared_attention(sa["attn"], rms_norm(h, sa["ln"], eps),
                                     cfg, rnd)
    if positions is not None:
        h = h[:, positions]
    h = rms_norm(h, params["final_norm"], eps)
    return rnd(h) @ rnd(params["lm_head"].float())
