"""Parity of the port's kernels (``repro_torch.kernels``) with the JAX
reference (``repro.kernels``).

The same inputs, made with a seeded NumPy generator, go through:

* each port oracle (``repro_torch.kernels.ref``) against the JAX oracle;
* each kernel's plain PyTorch version — what ``ops`` runs for a CPU
  tensor, the same algorithm the CUDA kernel runs on the card — against
  the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs
  it;

at a subset of ``tests/test_kernels.py``'s shapes (GQA, padded T, decode
``q_offset``, ``initial_state``, capacity drop), f32 and bf16, at its
tolerance buckets.  The CUDA kernels themselves run only on the card
(``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gather as mg
from repro_torch.kernels import ops, payloads, ref
from repro_torch.kernels import ssd_scan as ss

TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
MOE_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
           "bfloat16": dict(atol=5e-2, rtol=5e-2)}
DTYPES = ["float32", "bfloat16"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pair(a: np.ndarray, dtype: str):
    """One NumPy array as (jax array, torch tensor), both in ``dtype``
    (bf16 rounding is round-to-nearest-even on both sides)."""
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype]))


def close(got_torch, want_jax, tol):
    np.testing.assert_allclose(got_torch.float().numpy(),
                               np.asarray(want_jax, np.float32), **tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

ATTN_SHAPES = [
    (2, 256, 256, 4, 2, 64, True, 0, 128, 128),    # GQA
    (2, 200, 200, 4, 1, 32, True, 0, 64, 64),      # padded seqs
    (1, 1, 300, 4, 2, 64, True, 299, 64, 64),      # decode-style
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Tq,Tk,Hq,Hk,D,causal,off,bq,bk", ATTN_SHAPES)
def test_attention_matches_jax(B, Tq, Tk, Hq, Hk, D, causal, off, bq, bk,
                               dtype):
    rng = np.random.default_rng(0)
    (jq, q), (jk, k), (jv, v) = (
        pair(rng.standard_normal(s, dtype=np.float32), dtype)
        for s in ((B, Tq, Hq, D), (B, Tk, Hk, D), (B, Tk, Hk, D)))
    want_ref = jref.attention_ref(jq, jk, jv, causal=causal, q_offset=off)
    close(ref.attention_ref(q, k, v, causal=causal, q_offset=off),
          want_ref, TOL[dtype])
    want_kernel = jops.flash_attention(jq, jk, jv, causal=causal,
                                       q_offset=off, block_q=bq,
                                       block_k=bk, interpret=True)
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
    assert got.dtype == TDT[dtype] and got.shape == (B, Tq, Hq, D)
    close(got, want_kernel, TOL[dtype])


# The bf16 design's arithmetic (the 1/sqrt(D) scale on S after the
# product, base-2 exponentials, P V with P as its two bf16 terms, the
# kernel's kv tiles), which the plain version follows for bf16 inputs:
# every element within one bf16 ulp of the Pallas kernel (f32 products,
# p never rounded), the ulp taken at max(|ref|, 1e-3 max|ref|) as
# chip_smoke.py takes it against the f32 kernel on the card.
@pytest.mark.parametrize("D", [64, 128, 160])
@pytest.mark.parametrize("Tq,Tk,causal,off", [
    (96, 96, True, 0),            # ragged T, causal
    (96, 96, False, 0),           # non-causal
    (59, 96, True, 37),           # q_offset > 0: the last 59 of 96
])
def test_bf16_attention_within_one_ulp_of_jax(D, Tq, Tk, causal, off):
    rng = np.random.default_rng(D + Tq + off)
    (jq, q), (jk, k), (jv, v) = (
        pair(rng.standard_normal(s, dtype=np.float32), "bfloat16")
        for s in ((1, Tq, 4, D), (1, Tk, 2, D), (1, Tk, 2, D)))
    want = jops.flash_attention(jq, jk, jv, causal=causal, q_offset=off,
                                block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=off)
    assert got.dtype == torch.bfloat16 and got.shape == (1, Tq, 4, D)
    ref = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert fa.bf16_ulps(got, ref) <= 1.0


# The f32 wgmma design's arithmetic (q scaled before the product, base-2
# exponentials with log2(e) on S, kv tiles of f32_kv_tile(D) walked by two
# streams, even and odd tiles, merged at the end), which the plain version
# follows for f32 inputs, against the Pallas kernel at the f32 bucket: at
# the design's head dims, over several kv tiles of each stream, a stream
# whose first tile is wholly masked for some rows, and q_offset.
@pytest.mark.parametrize("D", fa.F32_WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("Tq,Tk,causal,off", [
    (200, 200, True, 0),          # ragged T, causal: 4-7 tiles a block
    (96, 150, False, 0),          # non-causal, ragged Tk
    (37, 300, True, 263),         # q_offset > 0: the last 37 of 300
])
def test_f32_attention_streams_match_jax(D, Tq, Tk, causal, off):
    rng = np.random.default_rng(D + Tq + off)
    (jq, q), (jk, k), (jv, v) = (
        pair(rng.standard_normal(s, dtype=np.float32), "float32")
        for s in ((2, Tq, 4, D), (2, Tk, 2, D), (2, Tk, 2, D)))
    want = jops.flash_attention(jq, jk, jv, causal=causal, q_offset=off,
                                block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=off)
    assert got.dtype == torch.float32 and got.shape == (2, Tq, 4, D)
    close(got, want, TOL["float32"])


def test_f32_kernel_rule():
    """Which f32 design a call takes (``f32_kernel``, the C entry's rule):
    wgmma at D 64, 128 and 160 on 16-byte boundaries, mma.sync
    elsewhere."""
    def z(D, shift=0):
        flat = torch.zeros(1 * 8 * 2 * D + shift)
        return flat[shift:].view(1, 8, 2, D)
    for D in fa.HEAD_DIMS:
        want = "attn_tf32_kernel" if D in (64, 128, 160) else "attn_kernel"
        assert fa.f32_kernel(z(D), z(D), z(D)) == want, D
    assert fa.f32_kernel(z(64), z(64, 1), z(64, 1)) == "attn_kernel"
    assert fa.f32_kernel(z(128, 1), z(128), z(128)) == "attn_kernel"
    assert fa.f32_kernel(z(160), z(160, 1), z(160, 1)) == "attn_kernel"
    assert fa.f32_kernel(z(160, 2), z(160), z(160)) == "attn_kernel"
    assert fa.f32_kv_tile(64) == 64 and fa.f32_kv_tile(128) == 32
    assert fa.f32_kv_tile(160) == 16


def test_bf16_ulps_measures_in_bf16_ulps():
    """One ulp of bf16 at x is 2^(floor(log2 x) - 7), floored at 1e-3 of
    the largest |ref|."""
    ref = torch.tensor([1.0, -3.0, 0.0])
    assert fa.bf16_ulps(ref, ref) == 0.0
    assert fa.bf16_ulps(ref + torch.tensor([2.0 ** -7, 0, 0]), ref) == 1.0
    assert fa.bf16_ulps(ref + torch.tensor([0, 2.0 ** -7, 0]), ref) == 0.5
    # at 0 the ulp is that of 3e-3: 2^-9 - 7
    assert fa.bf16_ulps(ref + torch.tensor([0, 0, 2.0 ** -16]), ref) == 1.0


# ---------------------------------------------------------------------------
# ssd scan
# ---------------------------------------------------------------------------

SSD_SHAPES = [
    (1, 100, 3, 8, 16, 32, False),     # padded T
    (2, 64, 2, 16, 16, 16, True),      # initial state
    (1, 17, 2, 8, 8, 32, True),        # T < chunk
]
# At the Pallas kernel's own chunks the sums run over hundreds of steps:
# with unit-scale c and b (|y| ~ 25-40) f32 rounding alone puts the
# Pallas kernel 4e-5 to 2.2e-4 from an f64 recurrence, past the f32
# bucket's elementwise 3e-5, so these draw c and b at 0.5, the scale
# kernel_chain draws them at (|y| ~ 10).
SSD_LONG_SHAPES = [
    (1, 300, 2, 16, 32, 128, False),   # chunk 128, padded T
    (1, 200, 2, 8, 16, 128, True),     # chunk 128, T not a multiple, state
    (1, 600, 1, 16, 32, 256, True),    # chunk 256, padded third chunk, state
    (1, 100, 2, 8, 16, 256, False),    # chunk 256 > T
]


def _ssd_inputs(rng, B, T, H, N, P, with_s0, dtype, scale=1.0):
    c, b = (pair(np.float32(scale) * rng.standard_normal((B, T, H, N),
                                                         dtype=np.float32),
                 dtype) for _ in range(2))
    v = pair(rng.standard_normal((B, T, H, P), dtype=np.float32), dtype)
    la_np = -np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    la = pair(la_np, "float32")
    s0 = (pair(rng.standard_normal((B, H, N, P), dtype=np.float32), "float32")
          if with_s0 else (None, None))
    return c, b, v, la, s0


def _ssd_matches_jax(B, T, H, N, P, chunk, with_s0, dtype, scale=1.0):
    rng = np.random.default_rng(2)
    (jc, c), (jb, b), (jv, v), (jla, la), (js0, s0) = _ssd_inputs(
        rng, B, T, H, N, P, with_s0, dtype, scale)
    yr, Sr = jref.ssd_scan_ref(jc, jb, jv, jla, initial_state=js0)
    y, S = ref.ssd_scan_ref(c, b, v, la, initial_state=s0)
    close(y, yr, TOL[dtype])
    close(S, Sr, dict(atol=5e-4, rtol=5e-4))
    yk, Sk = jops.ssd_scan(jc, jb, jv, jla, initial_state=js0, chunk=chunk,
                           interpret=True)
    y, S = ops.ssd_scan(c, b, v, la, initial_state=s0, chunk=chunk)
    assert y.dtype == TDT[dtype] and S.dtype == torch.float32
    close(y, yk, TOL[dtype])
    close(S, Sk, dict(atol=5e-4, rtol=5e-4))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,H,N,P,chunk,with_s0", SSD_SHAPES)
def test_ssd_scan_matches_jax(B, T, H, N, P, chunk, with_s0, dtype):
    _ssd_matches_jax(B, T, H, N, P, chunk, with_s0, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,H,N,P,chunk,with_s0", SSD_LONG_SHAPES)
def test_ssd_scan_long_chunks_match_jax(B, T, H, N, P, chunk, with_s0,
                                        dtype):
    _ssd_matches_jax(B, T, H, N, P, chunk, with_s0, dtype, scale=0.5)


# The zoo's two widest kernel shapes, at reduced T: StableLM-12B's
# attention (d_head 160, 32 query heads over 8, here 8 over 2) and
# xLSTM-125M's mLSTM scan (N = 384, P = 385: v and a column of ones,
# chunk 256).  c and b are drawn at 1/sqrt(N)-like scale, as the mLSTM
# scales k by 1/sqrt(d_head).
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_at_d_head_160_matches_jax(dtype):
    rng = np.random.default_rng(14)
    (jq, q), (jk, k), (jv, v) = (
        pair(rng.standard_normal(sh, dtype=np.float32), dtype)
        for sh in ((1, 130, 8, 160), (1, 130, 2, 160), (1, 130, 2, 160)))
    want = jops.flash_attention(jq, jk, jv, causal=True, block_q=64,
                                block_k=64, interpret=True)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.shape == (1, 130, 8, 160) and got.dtype == TDT[dtype]
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_at_the_mlstm_state_matches_jax(dtype):
    rng = np.random.default_rng(15)
    B, T, H, N = 1, 300, 2, 384
    (jc, c), (jb, b) = (pair(np.float32(0.1) * rng.standard_normal(
        (B, T, H, N), dtype=np.float32), dtype) for _ in range(2))
    v_np = np.concatenate([rng.standard_normal((B, T, H, N),
                                               dtype=np.float32),
                           np.ones((B, T, H, 1), np.float32)], axis=-1)
    jv, v = pair(v_np, dtype)
    la_np = -np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(
        np.float32)
    jla, la = pair(la_np, "float32")
    yk, Sk = jops.ssd_scan(jc, jb, jv, jla, chunk=256, interpret=True)
    y, S = ops.ssd_scan(c, b, v, la, chunk=256)
    assert y.shape == (B, T, H, N + 1) and S.shape == (B, H, N, N + 1)
    close(y, yk, TOL[dtype])
    close(S, Sk, dict(atol=5e-4, rtol=5e-4))


# bf16 c, b, v at the zoo's two scan widths, chunk 256: every element of
# y within one bf16 ulp of the Pallas kernel (f32 arithmetic on the
# upcast operands), the ulp taken at max(|ref|, 1e-3 max|ref|) as
# chip_smoke.py holds the bf16 kernel to the f32 one on the card; the
# final state (f32) within the f32 bucket.
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("N,P,T,scale", [
    (64, 64, 300, 0.5),           # Zamba2-2.7B's N = P = 64
    (384, 385, 300, 0.1),         # xLSTM-125M's mLSTM: v and a ones column
])
def test_bf16_ssd_scan_within_one_ulp_of_jax(N, P, T, scale, with_s0):
    rng = np.random.default_rng(N + T + with_s0)
    B, H = 1, 2
    (jc, c), (jb, b) = (pair(np.float32(scale) * rng.standard_normal(
        (B, T, H, N), dtype=np.float32), "bfloat16") for _ in range(2))
    v_np = rng.standard_normal((B, T, H, P), dtype=np.float32)
    if P == N + 1:
        v_np[..., -1] = 1.0
    jv, v = pair(v_np, "bfloat16")
    jla, la = pair(-np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(
        np.float32), "float32")
    js0, s0 = (pair(rng.standard_normal((B, H, N, P), dtype=np.float32),
                    "float32") if with_s0 else (None, None))
    yk, Sk = jops.ssd_scan(jc, jb, jv, jla, initial_state=js0, chunk=256,
                           interpret=True)
    y, S = ops.ssd_scan(c, b, v, la, initial_state=s0, chunk=256)
    assert y.dtype == torch.bfloat16 and y.shape == (B, T, H, P)
    ref = torch.from_numpy(np.array(yk.astype(jnp.float32)))
    assert fa.bf16_ulps(y, ref) <= 1.0
    close(S, Sk, TOL["float32"])


def test_ssd_scan_default_chunk_is_the_pallas_kernels():
    """Without a ``chunk`` argument both packages chunk at 256, so the
    same call computes the same chunked algebra: T = 300 runs as one full
    chunk of 256 and a padded second one in both."""
    import inspect
    assert inspect.signature(ops.ssd_scan).parameters["chunk"].default \
        == inspect.signature(jops.ssd_scan).parameters["chunk"].default \
        == ss.ssd_scan_plain.__kwdefaults__["chunk"] \
        == ss.ssd_scan_cuda.__kwdefaults__["chunk"] == 256
    rng = np.random.default_rng(13)
    (jc, c), (jb, b), (jv, v), (jla, la), (js0, s0) = _ssd_inputs(
        rng, 1, 300, 2, 8, 16, True, "float32", 0.5)
    yk, Sk = jops.ssd_scan(jc, jb, jv, jla, initial_state=js0,
                           interpret=True)
    y, S = ops.ssd_scan(c, b, v, la, initial_state=s0)
    close(y, yk, TOL["float32"])
    close(S, Sk, dict(atol=5e-4, rtol=5e-4))


def test_ssd_scan_state_chaining():
    """scan(T) == scan(T/2) chained through the carried state."""
    rng = np.random.default_rng(5)
    (_, c), (_, b), (_, v), (_, la), _ = _ssd_inputs(rng, 1, 64, 2, 8, 8,
                                                     False, "float32")
    y_full, S_full = ops.ssd_scan(c, b, v, la, chunk=16)
    h = 32
    y1, S1 = ops.ssd_scan(c[:, :h], b[:, :h], v[:, :h], la[:, :h], chunk=16)
    y2, S2 = ops.ssd_scan(c[:, h:], b[:, h:], v[:, h:], la[:, h:],
                          initial_state=S1, chunk=16)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full,
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(S2, S_full, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# moe dispatch/combine
# ---------------------------------------------------------------------------

MOE_SHAPES = [
    (128, 64, 8, 2, 32, 24),    # drops happen
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,d,E,K,F,cap", MOE_SHAPES)
def test_moe_matches_jax(T, d, E, K, F, cap, dtype):
    rng = np.random.default_rng(3)
    jx, x = pair(rng.standard_normal((T, d), dtype=np.float32), dtype)
    logits = rng.standard_normal((T, E), dtype=np.float32)
    jgv, jgi = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), K)
    gi, gv = payloads.top_k_gates(torch.from_numpy(logits), K)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi))
    jgv = (jgv / jgv.sum(-1, keepdims=True)).astype(JDT[dtype])
    gv = gv.to(TDT[dtype])
    close(gv, jgv, TOL[dtype])
    jw_up, w_up = pair(0.1 * rng.standard_normal((E, d, 2 * F),
                                                 dtype=np.float32), dtype)
    jw_down, w_down = pair(0.1 * rng.standard_normal((E, F, d),
                                                     dtype=np.float32), dtype)
    want_ref = jref.moe_dispatch_combine_ref(jx, jgi, jgv, jw_up, jw_down,
                                             capacity=cap)
    close(ref.moe_dispatch_combine_ref(x, gi, gv, w_up, w_down,
                                       capacity=cap), want_ref, MOE_TOL[dtype])
    want = jops.moe_dispatch_combine(jx, jgi, jgv, jw_up, jw_down,
                                     capacity=cap, block_m=16, block_f=8,
                                     interpret=True)
    got = ops.moe_dispatch_combine(x, gi, gv, w_up, w_down, capacity=cap)
    assert got.dtype == TDT[dtype]
    close(got, want, MOE_TOL[dtype])


@pytest.mark.parametrize("T,K,E,cap", [(40, 2, 4, 8), (128, 2, 8, 24)])
def test_dispatch_indices_match_jax(T, K, E, cap):
    """Queue positions, keep mask and the (E, cap) token table equal the
    reference's exactly (including which slots the capacity drops)."""
    gi = np.random.default_rng(7).integers(0, E, (T, K)).astype(np.int32)
    jt, jk, jp = jops.dispatch_indices(jnp.asarray(gi), cap, E)
    tt, tk, tp = ops.dispatch_indices(torch.from_numpy(gi), cap, E)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert not tk.all()     # the capacity really drops slots here


def test_top_k_gates_break_ties_like_jax():
    """Tied gate probabilities pick the lower expert index first, as
    ``jax.lax.top_k`` does."""
    logits = np.array([[0.5, 1.0, 1.0, 0.5, 1.0, -2.0],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                       [3.0, -1.0, 3.0, 3.0, -1.0, 2.0]], np.float32)
    for k in (1, 2, 3, 4):
        _, jgi = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), k)
        gi, _ = payloads.top_k_gates(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi))


@pytest.mark.parametrize("E, cap, d, F", [
    (2, 16, 32, 16),      # cap 16: a decode batch's
    (2, 24, 32, 16),      # a ragged cap (the Pallas kernel pads a tile)
    (1, 32, 64, 32),      # one expert
], ids=["cap 16", "ragged cap 24", "E = 1"])
def test_expert_glu_rounds_activation_to_input_dtype(E, cap, d, F):
    """In bf16 the activation is rounded before the down projection, as
    the Pallas kernel does (moe_gather.py:50): the plain version within
    the bf16 bucket (3e-2) of the Pallas kernel in interpret mode, and
    apart from the same products unrounded."""
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal(s, dtype=np.float32) * sc for s, sc in
              (((E, cap, d), 1.0), ((E, d, 2 * F), 0.3), ((E, F, d), 0.3))]
    jx, jwu, jwd = (pair(a, "bfloat16")[0] for a in arrays)
    x, wu, wd = (pair(a, "bfloat16")[1] for a in arrays)
    want = jops.expert_glu(jx, jwu, jwd, block_m=16, block_f=8,
                           interpret=True)
    got = mg.expert_glu_plain(x, wu, wd)
    close(got, want, TOL["bfloat16"])
    h = torch.bmm(x.float(), wu.float())
    a = torch.nn.functional.silu(h[..., :F]) * h[..., F:]
    unrounded = torch.bmm(a, wd.float()).to(torch.bfloat16)
    assert not torch.equal(got, unrounded)


# ---------------------------------------------------------------------------
# host payloads and the device rule
# ---------------------------------------------------------------------------


def test_host_payloads():
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 16), dtype=np.float32))
    el = payloads.eltwise_payloads(1.25)
    got = el["numpy"](x)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    torch.testing.assert_close(got, el["ref"](x), atol=3e-5, rtol=3e-5)
    so = payloads.sort_payloads()
    assert torch.equal(so["numpy"](x), so["ref"](x))


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan",
                                    "expert_glu"])
def test_cuda_wrappers_refuse_host_tensors(kernel):
    """A wrapper launches its kernel or raises: on host tensors it raises
    before any build or launch (the CPU takes the plain version through
    ``ops``)."""
    z = torch.zeros
    with pytest.raises(ValueError, match="not a CUDA device"):
        if kernel == "flash_attention":
            fa.flash_attention_cuda(z(1, 8, 2, 16), z(1, 8, 2, 16),
                                    z(1, 8, 2, 16))
        elif kernel == "ssd_scan":
            ss.ssd_scan_cuda(z(1, 8, 2, 4), z(1, 8, 2, 4), z(1, 8, 2, 4),
                             z(1, 8, 2))
        else:
            mg.expert_glu_cuda(z(2, 4, 8), z(2, 8, 8), z(2, 4, 8))
