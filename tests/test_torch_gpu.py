"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips without a CUDA device (the kernels have
no CPU mode).  The file imports no JAX, so it runs on a machine with the
card and PyTorch alone: ``python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gather as mg
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels import ssd_step as st

TOL = {torch.float32: dict(atol=3e-5, rtol=3e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(rng, shape, device, dtype, scale=1.0):
    return (scale * torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32))).to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda, dtype):
    rng = np.random.default_rng(8)

    def t(shape, scale=1.0):
        return _rand(rng, shape, cuda, dtype, scale)

    q, k, v = t((1, 200, 4, 64)), t((1, 200, 2, 64)), t((1, 200, 2, 64))
    torch.testing.assert_close(fa.flash_attention_cuda(q, k, v),
                               fa.flash_attention_plain(q, k, v),
                               **TOL[dtype])
    q1 = t((1, 1, 4, 64))
    torch.testing.assert_close(
        fa.flash_attention_cuda(q1, k, v, q_offset=199),
        fa.flash_attention_plain(q1, k, v, q_offset=199), **TOL[dtype])
    c, b, x = t((1, 100, 3, 8)), t((1, 100, 3, 8)), t((1, 100, 3, 16))
    la = -torch.nn.functional.softplus(t((1, 100, 3)).float())
    s0 = t((1, 3, 8, 16)).float()
    (y, s), (yp, sp) = (f(c, b, x, la, initial_state=s0, chunk=32) for f in
                        (ss.ssd_scan_cuda, ss.ssd_scan_plain))
    torch.testing.assert_close(y, yp, **TOL[dtype])
    torch.testing.assert_close(s, sp, atol=5e-4, rtol=5e-4)
    x, wu, wd = t((4, 40, 64)), t((4, 64, 64), 0.1), t((4, 32, 64), 0.1)
    torch.testing.assert_close(mg.expert_glu_cuda(x, wu, wd),
                               mg.expert_glu_plain(x, wu, wd), **TOL[dtype])


@pytest.mark.gpu
def test_each_launch_is_counted_once(cuda):
    """``ops`` launches the kernel for a CUDA tensor, and the kernel's
    count grows by one per launch, nowhere else."""
    rng = np.random.default_rng(9)
    q = _rand(rng, (1, 64, 2, 16), cuda, torch.float32)
    kernels.reset_launch_counts()
    ops.flash_attention(q, q, q)
    ops.flash_attention(q.cpu(), q.cpu(), q.cpu())      # the plain version
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"flash_attention": 1, "ssd_scan": 0,
                                       "expert_glu": 0, "ssd_step": 0}


# the decode step's kernel: (B, H, N, P, dtype of c, b and v, the
# operands as views laid out as the decode's) at Zamba2-2.7B's decode at
# batch 32 (16-byte rows; c and b one group's rows for every head,
# batch-minor, as the conv leaves them) and the mLSTM's P = N + 1 (one
# float a column)
SSD_STEP_CASES = {"zamba2": (32, 80, 64, 64, torch.bfloat16, False),
                  "zamba2_views": (32, 80, 64, 64, torch.bfloat16, True),
                  "mlstm": (4, 4, 384, 385, torch.float32, False)}


def _step_operands(rng, cuda, B, H, N, P, dtype, views=False):
    S = _rand(rng, (B, H, N, P), cuda, torch.float32, 0.5)
    if views:
        c, b = (_rand(rng, (N, B), cuda, dtype).t()[:, None].expand(B, H, N)
                for _ in range(2))
        v = _rand(rng, (H, P, B), cuda, dtype).permute(2, 0, 1)
    else:
        c, b = (_rand(rng, (B, H, N), cuda, dtype) for _ in range(2))
        v = _rand(rng, (B, H, P), cuda, dtype)
    la = -torch.nn.functional.softplus(_rand(rng, (B, H), cuda,
                                             torch.float32))
    return S, c, b, v, la


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SSD_STEP_CASES))
def test_ssd_step_kernel_matches_plain(cuda, case):
    """One launch writes S' over S, bitwise the plain step's (a product
    and a sum, each rounded, as PyTorch computes them); y is the same sum
    over N in another order: within the f32 bucket, or one bf16 ulp; two
    runs give the same bits.  Views are read at their strides."""
    S, c, b, v, la = _step_operands(np.random.default_rng(11), cuda,
                                    *SSD_STEP_CASES[case])
    S_plain, S_again = S.clone(), S.clone()
    kernels.reset_launch_counts()
    y, out = ops.ssd_step(S, c, b, v, la)
    torch.cuda.synchronize()
    assert out is S and y.is_contiguous()
    assert kernels.launch_counts() == {"flash_attention": 0, "ssd_scan": 0,
                                       "expert_glu": 0, "ssd_step": 1}
    y_plain, _ = st.ssd_step_plain(S_plain, c, b, v, la)
    assert torch.equal(S, S_plain)
    if v.dtype == torch.float32:
        scale = float(y_plain.abs().max())
        torch.testing.assert_close(y, y_plain, atol=3e-5 * scale, rtol=0)
    else:
        gap = (y.double() - y_plain.double()).abs()
        one_ulp = 2.0 ** -7 * y_plain.double().abs() \
            + 1e-5 * float(y_plain.abs().max())
        assert bool((gap <= one_ulp).all()), float(gap.max())
    y_again, _ = st.ssd_step_cuda(S_again, c, b, v, la)
    assert torch.equal(y_again, y) and torch.equal(S_again, S)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["bfloat16", "transposed"])
def test_ssd_step_kernel_refuses_a_state_it_cannot_update(cuda, bad):
    """The kernel updates an f32 contiguous state in place; any other
    raises, and nothing launches (no fallback)."""
    S, c, b, v, la = _step_operands(np.random.default_rng(12), cuda,
                                    2, 4, 64, 64, torch.float32)
    kernels.reset_launch_counts()
    S = S.bfloat16() if bad == "bfloat16" else S.transpose(2, 3)
    with pytest.raises(TypeError if bad == "bfloat16" else ValueError):
        ops.ssd_step(S, c, b, v, la)
    assert not any(kernels.launch_counts().values())


def _unaligned(t):
    """A contiguous copy of ``t`` starting one element past an
    allocation's start, so off a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    u = flat[1:].view(t.shape)
    u.copy_(t)
    return u


BF16_ATTN_CASES = {              # Tq, Tk, causal, q_offset, k/v unaligned
    "causal, ragged T": (200, 200, True, 0, False),
    "non-causal": (96, 150, False, 0, False),
    "q_offset": (37, 300, True, 263, False),
    "k, v unaligned": (96, 96, True, 0, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BF16_ATTN_CASES))
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_bf16_attention_kernel_matches_plain(cuda, D, case):
    """The bf16 kernel (wgmma; TMA, or plain loads for k/v off a 16-byte
    boundary) against its plain version within the bf16 bucket, within
    one bf16 ulp of the f32 kernel on the upcast inputs, bitwise run to
    run, one launch counted per call."""
    Tq, Tk, causal, off, unaligned = BF16_ATTN_CASES[case]
    rng = np.random.default_rng(13 + D)
    bf16 = torch.bfloat16
    q = _rand(rng, (2, Tq, 4, D), cuda, bf16)
    k, v = (_rand(rng, (2, Tk, 2, D), cuda, bf16) for _ in range(2))
    if unaligned:
        k, v = _unaligned(k), _unaligned(v)
    kernels.reset_launch_counts()
    got = fa.flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
    again = fa.flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 2
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    torch.testing.assert_close(
        got, fa.flash_attention_plain(q, k, v, causal=causal, q_offset=off),
        **TOL[bf16])
    ref = fa.flash_attention_cuda(q.float(), k.float(), v.float(),
                                  causal=causal, q_offset=off).to(bf16)
    assert fa.bf16_ulps(got, ref) <= 1.0


F32_ATTN_CASES = {     # B, Tq, Tk, Hq, Hk, causal, q_offset, k/v unaligned
    "causal, GQA 4/2, padded T": (2, 200, 200, 4, 2, True, 0, False),
    "non-causal, Tq != Tk": (1, 96, 150, 4, 2, False, 0, False),
    "decode Tq = 1, q_offset": (2, 1, 300, 4, 1, True, 299, False),
    "q_offset, a partial q tile": (1, 37, 300, 8, 2, True, 263, False),
    "k, v unaligned (mma.sync by the rule)": (1, 96, 96, 4, 2, True, 0,
                                              True),
}


ATTN_KERNELS = ("attn_kernel", "attn_tf32_kernel", "attn_wgmma_kernel")


def _launched(fn, names=ATTN_KERNELS, traces: int = 3) -> list:
    """The port's kernels of ``names`` (default: the attention's) one
    ``fn()`` launched, by name, from a device trace.  A trace that holds
    none of them is taken again, up to ``traces`` in all: the profiler
    at times records no kernel of a call in a process that has traced
    many (PERF.md §7), which says nothing of the route."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got = sorted({n for ev in prof.key_averages()
                      if ev.device_type == DeviceType.CUDA for n in names
                      if f"::{n}<" in ev.key or f"::{n}(" in ev.key})
        if got:
            break
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(F32_ATTN_CASES))
@pytest.mark.parametrize("D", [64, 128, 160])
def test_f32_attention_kernel_matches_plain(cuda, D, case):
    """The f32 attention at D 64, 128 and 160: 3xTF32 wgmma fed by TMA
    where q, k, v lie on 16-byte boundaries, the mma.sync kernel where
    they do not (the C entry's rule, ``f32_kernel``, read from a device
    trace); within the f32 bucket of the plain version, bitwise run to
    run, one counted launch a call."""
    B, Tq, Tk, Hq, Hk, causal, off, unaligned = F32_ATTN_CASES[case]
    rng = np.random.default_rng(17 + D)
    f32 = torch.float32
    q = _rand(rng, (B, Tq, Hq, D), cuda, f32)
    k, v = (_rand(rng, (B, Tk, Hk, D), cuda, f32) for _ in range(2))
    if unaligned:
        k, v = _unaligned(k), _unaligned(v)

    def call():
        return fa.flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
    kernels.reset_launch_counts()
    got, again = call(), call()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    torch.testing.assert_close(
        got, fa.flash_attention_plain(q, k, v, causal=causal, q_offset=off),
        **TOL[f32])
    want = "attn_kernel" if unaligned else "attn_tf32_kernel"
    assert fa.f32_kernel(q, k, v) == want
    assert _launched(call) == [want]


@pytest.mark.gpu
def test_f32_attention_other_head_dims_take_the_mma_sync_kernel(cuda):
    """D 16 and 32 take the mma.sync kernel by the rule, within the f32
    bucket of the plain version."""
    rng = np.random.default_rng(19)
    for D in (16, 32):
        q = _rand(rng, (1, 130, 4, D), cuda, torch.float32)
        k, v = (_rand(rng, (1, 130, 2, D), cuda, torch.float32)
                for _ in range(2))
        got = fa.flash_attention_cuda(q, k, v)
        torch.testing.assert_close(got, fa.flash_attention_plain(q, k, v),
                                   **TOL[torch.float32])
        assert _launched(lambda: fa.flash_attention_cuda(q, k, v)) == [
            "attn_kernel"], D


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_glu_beyond_d_1024(cuda, dtype):
    """The tensor-core GLU has no cap on d: d = 2048 (moe_d_ff 512, 4
    experts) against the plain version, normalised by the largest output
    as chip_smoke.py holds the main-path shapes."""
    rng = np.random.default_rng(10)
    x = _rand(rng, (4, 256, 2048), cuda, dtype)
    wu = _rand(rng, (4, 2048, 1024), cuda, dtype, 0.5)
    wd = _rand(rng, (4, 512, 2048), cuda, dtype, 0.5)
    got = mg.expert_glu_cuda(x, wu, wd).double()
    want = mg.expert_glu_plain(x, wu, wd).double()
    assert got.shape == want.shape
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= TOL[dtype]["rtol"], rel


@pytest.mark.gpu
def test_expert_glu_counts_one_launch_for_its_two_kernels(cuda):
    """One ``ops.expert_glu`` call runs the up and the down projection as
    two device kernels from one C call, and counts one launch."""
    rng = np.random.default_rng(11)
    x = _rand(rng, (4, 40, 64), cuda, torch.float32)
    wu = _rand(rng, (4, 64, 64), cuda, torch.float32, 0.1)
    wd = _rand(rng, (4, 32, 64), cuda, torch.float32, 0.1)
    kernels.reset_launch_counts()
    y = ops.expert_glu(x, wu, wd)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"flash_attention": 0, "ssd_scan": 0,
                                       "expert_glu": 1, "ssd_step": 0}
    torch.testing.assert_close(y, mg.expert_glu_plain(x, wu, wd),
                               **TOL[torch.float32])


F32_GLU_CASES = {          # E, cap, d, F, weight scale, x unaligned
    "main-path widths": (4, 256, 1024, 512, 0.5, False),
    "cap 200, a ragged token tile": (4, 200, 1024, 512, 0.5, False),
    "E = 1": (1, 256, 1024, 512, 0.5, False),
    "d = 2048": (2, 256, 2048, 512, 0.5, False),
    "d 36, F 20: ragged K and row tiles": (3, 70, 36, 20, 0.1, False),
    "d 18, F 10: rows off 16 bytes (mma.sync)": (3, 20, 18, 10, 0.1, False),
    "x off 16 bytes (mma.sync)": (2, 64, 64, 32, 0.1, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(F32_GLU_CASES))
def test_f32_expert_glu_matches_plain(cuda, case):
    """The f32 expert GLU (TF32 wgmma fed by TMA on 16-byte rows, the
    mma.sync kernel elsewhere) against the plain version within 3e-5 of
    its largest output, bitwise run to run, one counted launch a call."""
    E, cap, d, F, scale, unaligned = F32_GLU_CASES[case]
    rng = np.random.default_rng(14)
    f32 = torch.float32
    x = _rand(rng, (E, cap, d), cuda, f32)
    if unaligned:
        x = _unaligned(x)
    wu = _rand(rng, (E, d, 2 * F), cuda, f32, scale)
    wd = _rand(rng, (E, F, d), cuda, f32, scale)
    kernels.reset_launch_counts()
    got = mg.expert_glu_cuda(x, wu, wd)
    again = mg.expert_glu_cuda(x, wu, wd)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["expert_glu"] == 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = mg.expert_glu_plain(x, wu, wd).double()
    rel = float((got.double() - want).abs().max() / want.abs().max())
    assert rel <= TOL[f32]["rtol"], rel


BF16_GLU_CASES = {         # E, cap, d, F, weight scale, x unaligned
    "main-path widths": (32, 256, 1024, 512, 0.5, False),
    "cap 200, a ragged token tile": (4, 200, 1024, 512, 0.5, False),
    "cap 16, Granite's decode": (32, 16, 1024, 512, 0.5, False),
    "cap 100, a 128-row token tile": (4, 100, 1024, 512, 0.5, False),
    "cap 160, a box of 192 token rows": (4, 160, 1024, 512, 0.5, False),
    "E = 1": (1, 256, 1024, 512, 0.5, False),
    "d = 2048": (2, 256, 2048, 512, 0.5, False),
    "d 36, F 20 (mma.sync)": (3, 70, 36, 20, 0.1, False),
    "d 18, F 10: rows off 16 bytes (mma.sync)": (3, 20, 18, 10, 0.1, False),
    "x off 16 bytes (mma.sync)": (2, 64, 64, 32, 0.1, True),
}
GLU_KERNELS = ("gemm_kernel", "glu_bf16_kernel", "glu_wgmma_kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BF16_GLU_CASES))
def test_bf16_expert_glu_matches_plain(cuda, case):
    """The bf16 expert GLU (bf16 wgmma fed by TMA where d and F are
    multiples of 8 on 16-byte boundaries, the mma.sync kernel elsewhere:
    the C entry's rule, ``bf16_kernels``, read from a device trace)
    against the plain version within 3e-2 of its largest output, bitwise
    run to run, one counted launch a call."""
    E, cap, d, F, scale, unaligned = BF16_GLU_CASES[case]
    rng = np.random.default_rng(15)
    bf16 = torch.bfloat16
    x = _rand(rng, (E, cap, d), cuda, bf16)
    if unaligned:
        x = _unaligned(x)
    wu = _rand(rng, (E, d, 2 * F), cuda, bf16, scale)
    wd = _rand(rng, (E, F, d), cuda, bf16, scale)

    def call():
        return mg.expert_glu_cuda(x, wu, wd)
    kernels.reset_launch_counts()
    got, again = call(), call()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["expert_glu"] == 2
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    want = mg.expert_glu_plain(x, wu, wd).double()
    rel = float((got.double() - want).abs().max() / want.abs().max())
    assert rel <= TOL[bf16]["rtol"], rel
    tma = d % 8 == 0 and F % 8 == 0 and not unaligned
    assert mg.bf16_kernels(x, wu, wd) == (
        mg.BF16_WGMMA_KERNELS if tma else mg.BF16_MMA_SYNC_KERNELS)
    assert _launched(call, GLU_KERNELS) == sorted(mg.bf16_kernels(x, wu, wd))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_at_chunk_256(cuda, dtype):
    """The chunk-parallel scan at the Pallas kernel's own chunk: T = 600
    (a padded third chunk), N = P = 64, with an initial state, against
    the plain version, normalised by the largest output."""
    rng = np.random.default_rng(12)
    c, b = (_rand(rng, (1, 600, 2, 64), cuda, dtype, 0.5) for _ in range(2))
    x = _rand(rng, (1, 600, 2, 64), cuda, dtype)
    la = -torch.nn.functional.softplus(_rand(rng, (1, 600, 2), cuda,
                                             torch.float32))
    s0 = _rand(rng, (1, 2, 64, 64), cuda, torch.float32)
    (y, s), (yp, sp) = (f(c, b, x, la, initial_state=s0, chunk=256) for f in
                        (ss.ssd_scan_cuda, ss.ssd_scan_plain))
    for got, want, tol in ((y, yp, TOL[dtype]["rtol"]),
                           (s, sp, TOL[torch.float32]["rtol"])):
        assert got.shape == want.shape and got.dtype == want.dtype
        got, want = got.double(), want.double()
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= tol, rel


BF16_SSD_CASES = {   # B, T, H, N, P, chunk, initial state, decay, unaligned
    "chunk 32": (2, 128, 2, 16, 32, 32, False, None, ()),
    "padded T=100, N 8": (1, 100, 3, 8, 16, 32, False, None, ()),
    "chunk 16, initial_state": (2, 64, 2, 16, 16, 16, True, None, ()),
    "T=17 < chunk": (1, 17, 2, 8, 8, 32, True, None, ()),
    "main path widths, chunk 64": (1, 256, 4, 64, 64, 64, True, None, ()),
    "chunk 128, padded": (1, 300, 2, 64, 64, 128, True, None, ()),
    "Zamba2 widths, chunk 256": (1, 600, 2, 64, 64, 256, False, None, ()),
    "strong decay, chunk 256": (1, 600, 2, 64, 64, 256, True, -5.0, ()),
    "mLSTM N 384 P 385": (1, 300, 2, 384, 385, 256, False, None, ()),
    "mLSTM N 384 P 385, initial_state": (1, 300, 2, 384, 385, 256, True,
                                         None, ()),
    "N 18 P 20, chunk 100": (1, 200, 2, 18, 20, 100, True, None, ()),
    "N 496": (1, 130, 1, 496, 24, 64, True, None, ()),
    "c, b, v unaligned": (1, 96, 2, 64, 64, 64, False, None,
                          ("c", "b", "v")),
    "v unaligned": (1, 96, 2, 64, 64, 64, True, None, ("v",)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BF16_SSD_CASES))
def test_bf16_ssd_scan_kernel_matches_plain(cuda, case):
    """The bf16 scan (chunk outputs on wgmma; c, b, v by TMA, or plain
    loads for rows TMA cannot read) against its plain version within the
    bf16 bucket; every element of y within one bf16 ulp of the f32 kernel
    on the upcast inputs and the final state within 3e-5 of its largest
    value; bitwise run to run; one launch counted per call."""
    B, T, H, N, P, chunk, with_s0, decay, unaligned = BF16_SSD_CASES[case]
    rng = np.random.default_rng(17 + N + T)
    bf16 = torch.bfloat16
    scale = 0.1 if N > 64 else 0.5
    x = dict(c=_rand(rng, (B, T, H, N), cuda, bf16, scale),
             b=_rand(rng, (B, T, H, N), cuda, bf16, scale),
             v=_rand(rng, (B, T, H, P), cuda, bf16))
    if P == N + 1:
        x["v"][..., -1] = 1.0
    for name in unaligned:
        x[name] = _unaligned(x[name])
    c, b, v = x["c"], x["b"], x["v"]
    if decay is None:
        la = -torch.nn.functional.softplus(_rand(rng, (B, T, H), cuda,
                                                 torch.float32))
    else:
        la = (decay + 0.5 * _rand(rng, (B, T, H), cuda,
                                  torch.float32)).clamp(max=0)
    s0 = (_rand(rng, (B, H, N, P), cuda, torch.float32) if with_s0
          else None)
    kernels.reset_launch_counts()
    y, s = ss.ssd_scan_cuda(c, b, v, la, initial_state=s0, chunk=chunk)
    y2, s2 = ss.ssd_scan_cuda(c, b, v, la, initial_state=s0, chunk=chunk)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ssd_scan"] == 2
    assert torch.equal(y.view(torch.int16), y2.view(torch.int16))
    assert torch.equal(s, s2)
    yp, sp = ss.ssd_scan_plain(c, b, v, la, initial_state=s0, chunk=chunk)
    torch.testing.assert_close(y, yp, **TOL[bf16])
    yf, sf = ss.ssd_scan_cuda(c.float(), b.float(), v.float(), la,
                              initial_state=s0, chunk=chunk)
    assert fa.bf16_ulps(y, yf.to(bf16)) <= 1.0
    assert float((s - sf).abs().max() / sf.abs().max()) <= 3e-5


F32_SSD_CASES = {   # B, T, H, N, P, chunk, initial state, decay, unaligned
    "main path widths, chunk 64": (1, 1024, 16, 64, 64, 64, False, None, ()),
    "main path widths, initial_state": (1, 256, 4, 64, 64, 64, True, None,
                                        ()),
    "chunk 128, padded": (1, 300, 2, 64, 64, 128, True, None, ()),
    "Zamba2 widths, chunk 256": (2, 600, 2, 64, 64, 256, False, None, ()),
    "strong decay, chunk 256": (1, 600, 2, 64, 64, 256, True, -5.0, ()),
    "T=17 < chunk": (1, 17, 2, 64, 64, 64, True, None, ()),
    "chunk 100, P 96 (a ragged P tile)": (1, 250, 2, 64, 96, 100, True,
                                          None, ()),
    "P 128 (two P tiles), chunk 32": (2, 160, 1, 64, 128, 32, True, None,
                                      ()),
    # above N = 64, the wide design: xLSTM-125M's mLSTM widths (P 385: v
    # copied into padded rows first), P 384 (v by TMA), N 128 to 320,
    # initial states, ragged T, v off 16 bytes
    "N 384, P 385": (1, 300, 2, 384, 385, 256, False, None, ()),
    "N 384, P 385, initial_state": (1, 300, 2, 384, 385, 256, True, None,
                                    ()),
    "N 384, P 384, ragged T, chunk 64": (2, 200, 1, 384, 384, 64, True, None,
                                         ()),
    "N 128, P 96, initial_state, ragged T": (1, 300, 3, 128, 96, 128, True,
                                             None, ()),
    "N 128, P 16, T < chunk": (1, 100, 2, 128, 16, 256, True, None, ()),
    "N 256, P 65, chunk 100": (1, 250, 2, 256, 65, 100, True, None, ()),
    "N 320, strong decay, chunk 256": (1, 600, 1, 320, 64, 256, True, -5.0,
                                       ()),
    "N 448, P 200, chunk 128": (1, 333, 2, 448, 200, 128, True, None, ()),
    "N 384, v unaligned": (1, 160, 2, 384, 384, 128, True, None, ("v",)),
    # the rule's other side: the mma.sync kernels
    "N 16 (mma.sync by the rule)": (1, 100, 3, 16, 32, 32, True, None, ()),
    "N 384, P 385, c unaligned (mma.sync by the rule)": (
        1, 300, 2, 384, 385, 256, True, None, ("c",)),
    "N 128, b unaligned (mma.sync by the rule)": (1, 100, 2, 128, 64, 32,
                                                  False, None, ("b",)),
    "N 96 (mma.sync by the rule)": (1, 64, 2, 96, 32, 32, False, None, ()),
    "P 385 at N 64 (mma.sync by the rule)": (1, 200, 2, 64, 385, 64, True,
                                             None, ()),
    "c, b, v unaligned (mma.sync by the rule)": (1, 96, 2, 64, 64, 64,
                                                 False, None,
                                                 ("c", "b", "v")),
    "v unaligned (mma.sync by the rule)": (1, 96, 2, 64, 64, 64, True, None,
                                           ("v",)),
}


def _scan_launched(fn) -> list:
    """The port's f32 scan kernels one ``fn()`` launched, by name and
    sorted, from a device trace (taken again where it holds none, as
    ``_launched`` does)."""
    names = tuple(dict.fromkeys(ss.F32_WGMMA_KERNELS + ss.F32_WIDE_PAD_KERNELS
                                + ss.F32_MMA_SYNC_KERNELS))
    return _launched(fn, names)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(F32_SSD_CASES))
def test_f32_ssd_scan_kernel_matches_plain(cuda, case):
    """The f32 scan: 3xTF32 wgmma fed by TMA at N = 64 where TMA reads c,
    b and v and at N 128-448 where it reads c and b (v copied into padded
    rows first where TMA cannot read it), the mma.sync kernels elsewhere
    (the C entry's rule, ``ssd_scan.f32_kernels``, read from a device
    trace); y and the final state within the f32 bucket of the plain
    version's largest value, bitwise run to run, one counted launch a
    call."""
    B, T, H, N, P, chunk, with_s0, decay, unaligned = F32_SSD_CASES[case]
    rng = np.random.default_rng(23 + N + T + P)
    f32 = torch.float32
    scale = 0.1 if N > 64 else 0.5
    x = dict(c=_rand(rng, (B, T, H, N), cuda, f32, scale),
             b=_rand(rng, (B, T, H, N), cuda, f32, scale),
             v=_rand(rng, (B, T, H, P), cuda, f32))
    if P == N + 1:
        x["v"][..., -1] = 1.0
    for name in unaligned:
        x[name] = _unaligned(x[name])
    c, b, v = x["c"], x["b"], x["v"]
    if decay is None:
        la = -torch.nn.functional.softplus(_rand(rng, (B, T, H), cuda, f32))
    else:
        la = (decay + 0.5 * _rand(rng, (B, T, H), cuda, f32)).clamp(max=0)
    s0 = _rand(rng, (B, H, N, P), cuda, f32) if with_s0 else None

    def call():
        return ss.ssd_scan_cuda(c, b, v, la, initial_state=s0, chunk=chunk)
    kernels.reset_launch_counts()
    (y, s), (y2, s2) = call(), call()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ssd_scan"] == 2
    assert torch.equal(y.view(torch.int32), y2.view(torch.int32))
    assert torch.equal(s.view(torch.int32), s2.view(torch.int32))
    yp, sp = ss.ssd_scan_plain(c, b, v, la, initial_state=s0, chunk=chunk)
    for got, want in ((y, yp), (s, sp)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert bool(torch.isfinite(got).all())
        rel = float((got.double() - want.double()).abs().max()
                    / want.double().abs().max())
        assert rel <= TOL[f32]["rtol"], rel
    want = ss.f32_kernels(c, b, v)
    if "mma.sync" in case:
        assert want == ss.F32_MMA_SYNC_KERNELS
    elif N > 64:
        assert want == (ss.F32_WIDE_KERNELS if P % 4 == 0 and P >= 32
                        and not unaligned else ss.F32_WIDE_PAD_KERNELS)
    else:
        assert want == ss.F32_WGMMA_KERNELS
    assert _scan_launched(call) == sorted(want)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    z = torch.zeros
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_cuda(z(1, 8, 2, 16, device=cuda),
                                z(1, 8, 2, 16, device=cuda,
                                  dtype=torch.bfloat16),
                                z(1, 8, 2, 16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        mg.expert_glu_cuda(z(2, 8, 4, device=cuda).transpose(1, 2),
                           z(2, 8, 8, device=cuda), z(2, 4, 8, device=cuda))
    with pytest.raises(ValueError, match="chunk"):
        ss.ssd_scan_cuda(z(1, 600, 1, 8, device=cuda),
                         z(1, 600, 1, 8, device=cuda),
                         z(1, 600, 1, 8, device=cuda),
                         z(1, 600, 1, device=cuda), chunk=512)


# ---------------------------------------------------------------------------
# the threaded lane runtime on the card: one stream per CUDA lane
# ---------------------------------------------------------------------------


def _cuda_lane(name, cuda, dialect="ref"):
    from repro_torch.core import Target
    return Target(name, kind="cuda", dialect=dialect, device=cuda,
                  is_accelerator=True)


@pytest.mark.gpu
def test_handoffs_out_of_a_slow_cuda_lane_wait_for_its_event(cuda):
    """The producer's segment spins its stream for ~0.1 s before it
    writes its output.  A consumer on a second CUDA lane (its own stream)
    and one on a host lane must both read the finished output: the first
    waits on the producer's event on the device, the second on the host
    before its ``.to("cpu")``."""
    from repro_torch.core import (FusedOp, OpGraph, ScheduleExecutor,
                                  results_bitwise_equal)
    from repro_torch.core.backends import torch_cpu

    def slow(x):
        torch.cuda._sleep(200_000_000)
        return x * 2.0 + 1.0

    graph = OpGraph([FusedOp("slow", "other", fn=slow),
                     FusedOp("card", "other", fn=lambda a: a * 3.0),
                     FusedOp("host", "other", fn=lambda a: a - 1.0)],
                    edges=[(0, 1), (0, 2)])
    lanes = {"k1": _cuda_lane("k1", cuda), "k2": _cuda_lane("k2", cuda),
             "torch-cpu": torch_cpu()}
    ex = ScheduleExecutor(list(lanes), targets=lanes)
    prog = ex.compile_scheduled(graph, {0: "k1", 1: "k2", 2: "torch-cpu"})
    x = torch.arange(1 << 20, dtype=torch.float32, device=cuda)
    oracle = ex.run_scheduled(graph, {0: "k1", 1: "k2", 2: "torch-cpu"},
                              {0: (x,)})
    for _ in range(3):
        out = prog.run({0: (x,)})
        assert out[1].device.type == "cuda" and out[2].device.type == "cpu"
        torch.cuda.synchronize()
        assert results_bitwise_equal(out, oracle)
    streams = prog.lane_streams()
    assert sorted(streams) == ["k1", "k2"]
    assert streams["k1"][1] != streams["k2"][1]
    prog.close()


@pytest.mark.gpu
def test_concurrent_small_chains_bitwise_alone_and_run_to_run(cuda):
    """Checks (a) and (c) of ``chip_smoke.py`` phase 4 at a small size:
    two small chains planned side by side on both CUDA lanes and the
    host lanes; each request's outputs are bitwise its run alone with
    the same op -> lane assignment, and two warm runs are bitwise
    equal."""
    from repro_torch import kernels
    from repro_torch.core import (CostEntry, CostTable, Orchestrator,
                                  kernel_chain, results_bitwise_equal)
    from repro_torch.core.backends import default_registry
    from repro_torch.core.profiler import fence

    reg = default_registry()
    lanes = {n: reg.get(n) for n in ("numpy-eager", "torch-cpu", "cuda:0",
                                     "cuda-kernels")}
    chains = [kernel_chain(seed=s, blocks=2, seq=128) for s in (0, 1)]
    orch = Orchestrator(CostTable(list(lanes)), targets=lanes)
    hs = []
    for k, (graph, _) in enumerate(chains):
        # request 0 is cheap on cuda-kernels, request 1 on cuda:0, and
        # the glue on the host, so the plan co-schedules across lanes
        table = CostTable(list(lanes))
        for i, op in enumerate(graph.ops):
            kernel_op = op.name.rsplit(".", 1)[-1] in ("attn", "ssd", "moe")
            for lane in lanes:
                fast = (lane == ("cuda-kernels", "cuda:0")[k]) if kernel_op \
                    else lane == "numpy-eager"
                table.set(i, lane, CostEntry(kernel=1e-4 if fast else 5e-3,
                                             dispatch=1e-5, h2d=0.0,
                                             d2h=0.0, power=100.0))
        hs.append(orch.register(graph, table=table))
    plan = orch.plan(hs)
    exts = [ext for _, ext in chains]
    used = {lane for r in range(2) for _, lane in plan.route[r]}
    assert {"cuda:0", "cuda-kernels"} <= used
    prog = orch.program_for(plan, exts)
    assert not prog.stats["serial"] and prog.stats["n_barrier"] > 0
    fence([list(o.values()) for o in orch.execute(plan, exts)])   # cold
    kernels.reset_launch_counts()
    first = orch.execute(plan, exts)
    second = orch.execute(plan, exts)
    fence([list(o.values()) for o in first + second])
    assert sum(kernels.launch_counts().values()) > 0
    for r, (graph, ext) in enumerate(chains):
        assert results_bitwise_equal(first[r], second[r])
        alone = orch.executor.compile_scheduled(
            graph, dict(plan.schedule.assignment_of(r)))
        alone.run(ext)
        got = alone.run(ext)
        fence(list(got.values()))
        assert results_bitwise_equal(first[r], got), r
    prog.close()


@pytest.mark.gpu
def test_dag_fork_out_of_a_slow_kernel_lane_feeds_a_card_and_a_host_lane(
        cuda):
    """A DAG fork: the producer on ``cuda-kernels`` spins its stream for
    ~0.1 s before it writes, then goes on with its own tower; one
    consumer runs on ``cuda:0`` (its own stream: a device wait on the
    producer's event, and ``record_stream``) and one on ``torch-cpu``
    (a host wait before its copy).  The compiled DAG program matches the
    interpreter bitwise, run after run, and no wait hits its deadline."""
    from repro_torch.core import (DagSchedule, DagStep, ExecutionPolicy,
                                  FusedOp, OpGraph, ScheduleExecutor,
                                  results_bitwise_equal)
    from repro_torch.core.backends import default_registry

    def slow(x):
        torch.cuda._sleep(200_000_000)
        return x * 2.0 + 1.0

    graph = OpGraph([FusedOp("slow", "other", fn=slow),
                     FusedOp("tower", "other", fn=lambda a: a.sin()),
                     FusedOp("card", "other", fn=lambda a: a * 3.0),
                     FusedOp("host", "other", fn=lambda a: a - 1.0)],
                    edges=[(0, 1), (0, 2), (0, 3)])
    reg = default_registry()
    lanes = {n: reg.get(n) for n in ("cuda-kernels", "cuda:0", "torch-cpu")}
    sched = DagSchedule(
        steps=[DagStep(ops=(0,), pus=("cuda-kernels",), cost=1e-3),
               DagStep(ops=(1, 2, 3),
                       pus=("cuda-kernels", "cuda:0", "torch-cpu"),
                       cost=1e-3)],
        latency=2e-3, energy=0.0, objective="latency", mode="frontier")
    ex = ScheduleExecutor(list(lanes), targets=lanes)
    prog = ex.compile_dag(graph, sched)
    # the fork cut: the consumers wait for the producer's op, not for its
    # lane's tower behind it
    assert [s.items for s in prog.lane_segments["cuda-kernels"]] == [
        [(0, 0)], [(0, 1)]]
    x = torch.arange(1 << 20, dtype=torch.float32, device=cuda)
    policy = ExecutionPolicy(timeout=30.0)
    oracle = ex.run_dag(graph, sched, {0: (x,)}, policy=policy)
    for _ in range(3):
        out = prog.run({0: (x,)}, policy=policy)
        assert out[2].device.type == "cuda" and out[3].device.type == "cpu"
        torch.cuda.synchronize()
        assert results_bitwise_equal(out, oracle)
    assert sorted(prog.lane_streams()) == ["cuda-kernels", "cuda:0"]
    prog.close()


@pytest.mark.gpu
def test_union_dag_with_two_card_inputs_caches_its_program(cuda):
    """A union of two chains, each fed its own CUDA tensor: the plan is
    the DAG route's union-grid sweep, its compiled program is cached
    over both inputs, and other input shapes compile anew."""
    from repro_torch.core import (CostEntry, CostTable, FusedOp, OpGraph,
                                  Orchestrator, results_bitwise_equal)
    from repro_torch.core.backends import default_registry

    graph = OpGraph([FusedOp("a0", "other", fn=lambda a: a * 2.0),
                     FusedOp("a1", "other", fn=lambda a: a.tanh()),
                     FusedOp("b0", "other", fn=lambda a: a + 1.0),
                     FusedOp("b1", "other", fn=lambda a: a.cos())],
                    edges=[(0, 1), (2, 3)])
    reg = default_registry()
    lanes = {n: reg.get(n) for n in ("cuda:0", "cuda-kernels")}
    table = CostTable(list(lanes))
    for i in range(4):
        for k, lane in enumerate(lanes):
            fast = (i < 2) == (k == 0)    # chain a on cuda:0, b on the other
            table.set(i, lane, CostEntry(kernel=1e-4 if fast else 1e-2,
                                         dispatch=1e-5, h2d=0.0, d2h=0.0,
                                         power=100.0))
    orch = Orchestrator(table, targets=lanes)
    plan = orch.plan(orch.register(graph))
    assert plan.kind == "dag" and plan.schedule.mode == "union-grid"
    rng = np.random.default_rng(12)
    ins = {0: (_rand(rng, (256, 64), cuda, torch.float32),),
           2: (_rand(rng, (128, 32), cuda, torch.float32),)}
    oracle = orch.execute(plan, ins, compile=False)
    for _ in range(3):
        out = orch.execute(plan, ins)
        torch.cuda.synchronize()
        assert results_bitwise_equal(out, oracle)
    assert (orch.stats["program_misses"], orch.stats["program_hits"]) == (1, 2)
    other = {0: ins[0], 2: (_rand(rng, (64, 32), cuda, torch.float32),)}
    out = orch.execute(plan, other)
    torch.cuda.synchronize()
    assert orch.stats["program_misses"] == 2
    assert results_bitwise_equal(out, orch.execute(plan, other,
                                                   compile=False))
    assert not orch.program_for(plan, ins).stats["serial"]


# ---------------------------------------------------------------------------
# segments captured as CUDA graphs (the counterpart of the jit leg)
# ---------------------------------------------------------------------------


def _small_kernel_chain(seed=0, seq=128):
    from repro_torch.core import kernel_chain
    return kernel_chain(seed=seed, blocks=2, seq=seq, heads=4, head_dim=32,
                        state=16, experts=8, top_k=2, moe_ff=32, chunk=32)


def _kernel_lane_program(graph):
    from repro_torch.core import ScheduleExecutor
    from repro_torch.core.backends import cuda_kernels
    lane = cuda_kernels(0)
    ex = ScheduleExecutor([lane.name], targets={lane.name: lane})
    return ex.compile_scheduled(graph, {i: lane.name
                                        for i in range(len(graph))})


@pytest.mark.gpu
def test_kernel_lane_segment_captures_and_replays_bitwise_as_eager(cuda):
    """A small chain on ``cuda-kernels``: the cold run probes and
    captures the segment (``JIT``, ``"bitwise"``), and a warm replay
    gives bitwise what the same program gives eagerly."""
    from repro_torch.core import laneprogram as lp
    from repro_torch.core import results_bitwise_equal
    graph, ext = _small_kernel_chain()
    prog = _kernel_lane_program(graph)
    prog.run(ext)
    seg = prog.segments[0]
    assert seg.use_variant and seg.verified in ("bitwise", "tolerance")
    assert (seg.mode, seg.jit_verified) == (lp.JIT, "bitwise"), \
        seg.capture_error
    replayed = prog.run(ext)
    seg.mode = lp.WARM                  # the same program, eagerly
    eager = prog.run(ext)
    torch.cuda.synchronize()
    assert results_bitwise_equal(replayed, eager)
    prog.close()


@pytest.mark.gpu
def test_warm_runs_on_other_inputs_leave_earlier_outputs_alone(cuda):
    """A replay writes into the graph's fixed buffers; the outputs a run
    hands out are copies, so a later run on other inputs changes none of
    them."""
    from repro_torch.core import laneprogram as lp
    from repro_torch.core import results_bitwise_equal
    graph, ext = _small_kernel_chain()
    prog = _kernel_lane_program(graph)
    prog.run(ext)
    assert prog.segments[0].mode == lp.JIT
    first = prog.run(ext)
    keep = {i: t.clone() for i, t in first.items()}
    other = {0: (ext[0][0] * 0.5 + 0.25,)}
    second = prog.run(other)
    torch.cuda.synchronize()
    assert results_bitwise_equal(first, keep)
    assert not torch.equal(second[0], first[0])
    assert all(first[i].data_ptr() != second[i].data_ptr() for i in first)
    prog.close()


@pytest.mark.gpu
def test_threaded_program_captures_on_the_lanes_own_streams(cuda):
    """Two small chains side by side on ``cuda:0`` and ``cuda-kernels``
    (one thread and one stream a lane): every CUDA segment is captured
    in its lane's worker, on its lane's stream, and the warm replays are
    bitwise each request alone with the same assignment."""
    from repro_torch.core import (CostEntry, CostTable, Orchestrator,
                                  laneprogram as lp, results_bitwise_equal)
    from repro_torch.core.backends import default_registry
    from repro_torch.core.profiler import fence

    reg = default_registry()
    lanes = {n: reg.get(n) for n in ("cuda:0", "cuda-kernels")}
    chains = [_small_kernel_chain(seed=s) for s in (0, 1)]
    orch = Orchestrator(CostTable(list(lanes)), targets=lanes)
    hs = []
    for k, (graph, _) in enumerate(chains):
        table = CostTable(list(lanes))
        for i in range(len(graph)):
            for lane in lanes:
                fast = lane == ("cuda-kernels", "cuda:0")[k]
                table.set(i, lane, CostEntry(kernel=1e-4 if fast else 5e-3,
                                             dispatch=1e-5, h2d=0.0,
                                             d2h=0.0, power=100.0))
        hs.append(orch.register(graph, table=table))
    plan = orch.plan(hs)
    exts = [ext for _, ext in chains]
    prog = orch.program_for(plan, exts)
    assert not prog.stats["serial"]
    captured_on = set()
    real = lp._capture

    def spy(fn, args, device):
        captured_on.add(torch.cuda.current_stream(device).stream_id)
        return real(fn, args, device)
    lp._capture = spy
    try:
        fence([list(o.values()) for o in orch.execute(plan, exts)])
    finally:
        lp._capture = real
    streams = {s.stream_id for _, s in prog.lane_streams().values()}
    assert captured_on and captured_on <= streams
    assert all(seg.mode == lp.JIT for seg in prog.segments), \
        prog.stats["capture_errors"]
    first = orch.execute(plan, exts)
    second = orch.execute(plan, exts)
    fence([list(o.values()) for o in first + second])
    for r, (graph, ext) in enumerate(chains):
        assert results_bitwise_equal(first[r], second[r])
        alone = orch.executor.compile_scheduled(
            graph, dict(plan.schedule.assignment_of(r)))
        alone.run(ext)
        got = alone.run(ext)
        fence(list(got.values()))
        assert results_bitwise_equal(first[r], got), r
        alone.close()
    prog.close()


@pytest.mark.gpu
def test_a_payload_that_syncs_the_host_stays_eager(cuda):
    """``.item()`` cannot be captured: the segment falls back to eager
    with ``jit_verified is None`` and the reason recorded, and runs."""
    from repro_torch.core import (FusedOp, ScheduleExecutor, chain_graph,
                                  laneprogram as lp)
    from repro_torch.core.backends import cuda_target
    lane = cuda_target(0)
    graph = chain_graph([
        FusedOp("scale", "other", fn=lambda x: x * float(x.abs().max())),
        FusedOp("tanh", "other", fn=torch.tanh)])
    ex = ScheduleExecutor([lane.name], targets={lane.name: lane})
    prog = ex.compile_scheduled(graph, {0: lane.name, 1: lane.name})
    x = torch.linspace(-1, 1, 4096, device=cuda)
    cold = prog.run({0: (x,)})
    seg = prog.segments[0]
    assert seg.mode == lp.WARM and seg.jit_verified is None
    assert seg.capture_error
    warm = prog.run({0: (x,)})
    torch.cuda.synchronize()
    assert torch.equal(warm[1], cold[1])


@pytest.mark.gpu
def test_launch_counts_of_a_replay_equal_the_eager_counts(cuda):
    """A kernel replayed in a graph counts its launches as an eager run
    does: one per kernel op, none while the graph is captured."""
    from repro_torch.core import laneprogram as lp
    graph, ext = _small_kernel_chain()
    prog = _kernel_lane_program(graph)
    prog.run(ext)
    assert prog.segments[0].mode == lp.JIT
    kernels.reset_launch_counts()
    prog.run(ext)
    torch.cuda.synchronize()
    replayed = kernels.launch_counts()
    prog.segments[0].mode = lp.WARM
    kernels.reset_launch_counts()
    prog.run(ext)
    torch.cuda.synchronize()
    assert replayed == kernels.launch_counts() == {
        "flash_attention": 2, "ssd_scan": 2, "expert_glu": 2, "ssd_step": 0}
    prog.close()


def _profiled(fn):
    """``fn()`` under the host profiler, the card synchronised inside it;
    the port's spans it recorded."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tracing
    n = len(tracing.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
        torch.cuda.synchronize()
    return tracing.spans()[n:]


def _children(spans, parent):
    return [s["name"] for s in spans if s["parent"] == parent["id"]]


@pytest.mark.gpu
def test_a_replays_span_counts_its_copies_and_its_launches(cuda):
    """Under the profiler a warm run of a captured segment replays in one
    ``capture.replay`` span (copy in, the graph, the clones out) whose
    counts are the static buffers' sizes and the kernels' launches, and
    ``launch_counts()`` folds them in as an eager run counts them."""
    from repro_torch.core import laneprogram as lp
    graph, ext = _small_kernel_chain()
    prog = _kernel_lane_program(graph)
    prog.run(ext)
    seg = prog.segments[0]
    assert seg.mode == lp.JIT
    call = seg._graph
    kernels.reset_launch_counts()
    spans = _profiled(lambda: prog.run(ext))
    replay, = [s for s in spans if s["name"] == "capture.replay"]
    assert _children(spans, replay) == ["capture.copy_in", "capture.graph",
                                        "capture.clone_out"]
    launches = {"flash_attention": 2, "ssd_scan": 2, "expert_glu": 2}
    assert replay["counts"] == {
        "capture.copy_in_bytes": sum(t.nbytes for t in call.static_in),
        "capture.clone_bytes": sum(t.nbytes for t in call.static_out),
        **{f"kernels.launches.{k}": n for k, n in launches.items()}}
    assert kernels.launch_counts() == {**launches, "ssd_step": 0}
    seg_span, = [s for s in spans if s["id"] == replay["parent"]]
    assert seg_span["name"] == "laneprogram.segment"
    assert seg_span["attrs"]["mode"] == lp.JIT
    prog.close()


@pytest.mark.gpu
def test_an_engine_decode_step_is_a_root_over_its_replay(cuda):
    """A decode step is an ``engine.decode_step`` root: on a new
    signature it holds the capture, then the replay, whose graph launch
    is ``capture.graph``; the cache goes back as it is, so only the
    tokens are copied in and the logits cloned out."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    cfg = get_config("zamba2-2.7b").reduced()
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (2, 16), dtype=torch.int32,
                            device=cuda)
    logits, cache = M.prefill(cfg, params, {"tokens": prompts}, max_len=24)
    eng = Engine(cfg=cfg, params=params)
    step = eng.decode_step_fn()
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    out = {}

    def one_step():
        out["logits"], out["cache"] = step(params, cache, {"tokens": tok})

    spans = _profiled(one_step)
    root, = [s for s in spans if s["parent"] is None]
    assert root["name"] == "engine.decode_step"
    assert "capture.capture" in _children(spans, root)
    cache = out["cache"]
    spans = _profiled(one_step)
    root, = [s for s in spans if s["parent"] is None]
    assert root["name"] == "engine.decode_step"
    assert _children(spans, root) == ["capture.replay"]
    replay, = [s for s in spans if s["name"] == "capture.replay"]
    assert "capture.graph" in _children(spans, replay)
    assert replay["counts"]["capture.copy_in_bytes"] == tok.nbytes
    assert replay["counts"]["capture.clone_bytes"] == out["logits"].nbytes
    eng.release()


# ---------------------------------------------------------------------------
# PU-loss recovery and serving under chaos on the card
# ---------------------------------------------------------------------------


def _card_lanes_and_table(graph):
    """``cuda:0`` and ``cuda-kernels``, with every op cheaper on the
    kernel lane."""
    from repro_torch.core import CostEntry, CostTable
    from repro_torch.core.backends import default_registry
    reg = default_registry()
    lanes = {n: reg.get(n) for n in ("cuda:0", "cuda-kernels")}
    table = CostTable(list(lanes))
    for i in range(len(graph)):
        for lane in lanes:
            table.set(i, lane, CostEntry(
                kernel=1e-4 if lane == "cuda-kernels" else 4e-4,
                dispatch=1e-5, h2d=0.0, d2h=0.0, power=100.0))
    return lanes, table


@pytest.mark.gpu
def test_recovery_of_a_captured_route(cuda):
    """A kernel-lane route cut by one op on ``cuda:0`` runs as two
    captured segments; a loss of ``cuda-kernels`` at a late kernel op
    keeps the first segments' results bitwise, re-plans the rest onto
    ``cuda:0`` and resumes on the interpreter from that frontier."""
    from repro_torch.core import (FaultPlan, Orchestrator, Plan,
                                  PULostError, SeqSchedule,
                                  laneprogram as lp, results_bitwise_equal)
    from repro_torch.core.profiler import fence
    graph, ext = _small_kernel_chain()
    lanes, table = _card_lanes_and_table(graph)
    orch = Orchestrator(table, targets=lanes)
    h = orch.register(graph)
    n, cut, late = len(graph), 5, 10          # moe of block 1 is op 10
    route = ["cuda-kernels"] * n
    route[cut] = "cuda:0"
    lat, eng = orch.workload(h).evaluate(route)
    plan = Plan("sequential", SeqSchedule(list(range(n)), route, lat, eng,
                                          "latency"), "latency", (h,),
                "sequential")
    orch.execute(plan, ext)                   # cold: probe and capture
    clean = orch.execute(plan, ext)
    fence(list(clean.values()))
    prog = orch.program_for(plan, ext)
    assert [seg.mode for seg in prog.segments] == [lp.JIT] * 3
    faults = FaultPlan.single("pu_lost", lane="cuda-kernels", op=late)
    with pytest.raises(PULostError) as lost:
        orch.execute(plan, ext, recover=False, faults=faults)
    prefix = lost.value.partial[0]
    assert sorted(prefix) == list(range(cut + 1))
    assert results_bitwise_equal(prefix, {i: clean[i] for i in prefix})
    faults.reset()
    got = orch.execute(plan, ext, faults=faults)
    fence(list(got.values()))
    assert orch.stats["recoveries"] == 1
    assert orch.condition.unavailable == {"cuda-kernels"}
    assert orch.plan(h).route[0] == [(i, "cuda:0") for i in range(n)]
    assert results_bitwise_equal({i: got[i] for i in prefix}, prefix)
    stitched = {i: "cuda:0" for i in range(cut + 1, n)}
    want = orch.executor.run_scheduled(graph, stitched, ext,
                                       completed=prefix)
    assert results_bitwise_equal(got, want)
    oracle = orch.execute(plan, ext, compile=False)
    for i in range(n):
        scale = float(oracle[i].abs().max())
        assert float((got[i] - oracle[i]).abs().max()) <= 1e-3 * scale, i
    prog.close()


@pytest.mark.gpu
def test_serving_recovers_from_a_lost_kernel_lane(cuda):
    """Real-mode serving with compiled windows over two two-block
    chains: ``cuda-kernels`` is lost at the third arrival and returns at
    the fifth; the run drains with no wrong answer, recovers, and the
    kernel lane's breaker closes again after a probe."""
    from repro_torch.core import (ArrivalTrace, ChaosEvent, ChaosTrace,
                                  HealthPolicy, Orchestrator, ServingEngine)
    chains = {m: _small_kernel_chain(seed=s) for m, s in (("A", 0),
                                                          ("B", 1))}
    lanes, table = _card_lanes_and_table(chains["A"][0])
    orch = Orchestrator(table, targets=lanes)
    lat = orch.plan(orch.register(chains["A"][0])).latency
    eng = ServingEngine(orch, {m: c[0] for m, c in chains.items()},
                        execution="real", compile_exec=True,
                        max_concurrent=2,
                        inputs={m: c[1] for m, c in chains.items()},
                        health_policy=HealthPolicy(cooldown=0.25 * lat,
                                                   cooldown_backoff=1.0))
    trace = ArrivalTrace.poisson(["A", "B"], rate=1.5 / lat, n=6, seed=2)
    t = [a.time for a in trace.arrivals]
    kernels.reset_launch_counts()
    rep = eng.serve(trace, chaos=ChaosTrace([
        ChaosEvent(time=t[2], kind="pu_lost", lane="cuda-kernels"),
        ChaosEvent(time=t[4], kind="pu_restored", lane="cuda-kernels")]))
    assert rep.completed + rep.shed == 6 and rep.bitwise_failures == 0
    assert rep.bitwise_checked == rep.completed >= 1
    assert rep.recoveries >= 1
    assert [f[:2] for f in eng.faults.fired] == [("pu_lost", "cuda-kernels")]
    assert rep.breaker["targets"]["cuda-kernels"]["state"] == "closed"
    # each of the chain's kernels ran; a chain has no decode step
    counts = kernels.launch_counts()
    assert all(counts[k] >= 1 for k in ("flash_attention", "ssd_scan",
                                        "expert_glu"))
    assert counts["ssd_step"] == 0
    assert orch._active == {}


# ---------------------------------------------------------------------------
# the model zoo on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch,depth", [("llama3.2-1b", 2),
                                        ("zamba2-2.7b", 6)])
def test_zoo_captured_decode_is_bitwise_the_eager_step(cuda, arch, depth):
    """At full width and cut depth in bf16 with the kernels: every step
    of the engine's captured decode gives the eager ``decode_step``'s
    logits and cache bit for bit, one capture serves two generates, and
    the prefill launched its kernel once a layer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    cfg = dataclasses.replace(get_config(arch), n_layers=depth,
                              use_kernels=True)
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128),
                                            dtype=np.int32)).to(cuda)
    kernels.reset_launch_counts()
    logits, cache = M.prefill(cfg, params, {"tokens": prompts}, max_len=136)
    torch.cuda.synchronize()
    kernel = "flash_attention" if arch == "llama3.2-1b" else "ssd_scan"
    assert kernels.launch_counts()[kernel] == depth
    eng = Engine(cfg=cfg, params=params)
    step = eng.decode_step_fn()
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    for _ in range(6):
        want_logits, want_cache = M.decode_step(cfg, params, cache,
                                                {"tokens": tok})
        logits, cache = step(params, cache, {"tokens": tok})
        assert torch.equal(logits.view(torch.int16),
                           want_logits.view(torch.int16))
        for a, b in zip(M.tree_leaves(cache), M.tree_leaves(want_cache)):
            assert torch.equal(a, b)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    out1 = eng.generate(prompts, max_new=8)
    out2 = eng.generate(prompts, max_new=8)
    assert torch.equal(out1, out2) and tuple(out1.shape) == (2, 8)
    assert sum(eng.decode_trace_counts.values()) == 1
    eng.release()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zoo_kernel_shapes_d160_and_n384_match_plain(cuda, dtype):
    """StableLM-12B's attention (D = 160, 32 query heads over 8) and
    xLSTM-125M's mLSTM scan (N = 384, P = 385: v and a column of ones,
    chunk 256) run the kernels within the bucket of their plain versions,
    bitwise run to run; a state beyond the kernel (N = 512) still raises
    and launches nothing."""
    from repro_torch.configs import get_config
    rng = np.random.default_rng(3)
    s = get_config("stablelm-12b")
    q = _rand(rng, (1, 200, s.n_heads, s.d_head), cuda, dtype)
    k, v = (_rand(rng, (1, 200, s.n_kv_heads, s.d_head), cuda, dtype)
            for _ in range(2))
    kernels.reset_launch_counts()
    o = ops.flash_attention(q, k, v)
    assert torch.equal(o, ops.flash_attention(q, k, v))
    torch.testing.assert_close(o, fa.flash_attention_plain(q, k, v),
                               **TOL[dtype])
    x = get_config("xlstm-125m")
    dh = x.xlstm_d_inner // x.n_heads
    c, b = (_rand(rng, (1, 300, x.n_heads, dh), cuda, dtype, 0.1)
            for _ in range(2))
    vv = torch.cat([_rand(rng, (1, 300, x.n_heads, dh), cuda, dtype),
                    torch.ones((1, 300, x.n_heads, 1), device=cuda,
                               dtype=dtype)], dim=-1)
    la = -torch.nn.functional.softplus(_rand(rng, (1, 300, x.n_heads), cuda,
                                             torch.float32))
    y, st = ops.ssd_scan(c, b, vv, la, chunk=x.ssm_chunk)
    y2, st2 = ops.ssd_scan(c, b, vv, la, chunk=x.ssm_chunk)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    yp, sp = ss.ssd_scan_plain(c, b, vv, la, chunk=x.ssm_chunk)
    for got, want, tol in ((y, yp, TOL[dtype]["rtol"]),
                           (st, sp, TOL[torch.float32]["rtol"])):
        assert got.shape == want.shape and got.dtype == want.dtype
        got, want = got.double(), want.double()
        assert float((got - want).abs().max() / want.abs().max()) <= tol
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"flash_attention": 2, "ssd_scan": 2,
                                       "expert_glu": 0, "ssd_step": 0}
    kernels.reset_launch_counts()
    wide = _rand(rng, (1, 64, 1, ss.MAX_STATE + 16), cuda, dtype)
    with pytest.raises(ValueError, match="N <="):
        ops.ssd_scan(wide, wide, vv[:, :64, :1], la[:, :64, :1])
    assert not any(kernels.launch_counts().values())
