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
                                       "expert_glu": 0}


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
        ss.ssd_scan_cuda(z(1, 200, 1, 8, device=cuda),
                         z(1, 200, 1, 8, device=cuda),
                         z(1, 200, 1, 8, device=cuda),
                         z(1, 200, 1, device=cuda), chunk=128)
