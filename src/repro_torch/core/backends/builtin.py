"""Factories for the builtin targets.

Port of ``repro.core.backends.builtin``.  Every factory returns a plain
:class:`~repro_torch.core.targets.Target` value; keyword overrides pass
straight through, so a caller can re-declare any pricing field without
subclassing anything:

    reg = default_registry()
    reg.register(torch_cpu(name="torch-cpu-lowlat", dispatch_s=5e-6))

* ``numpy-eager`` — host NumPy; serves the ``"numpy"`` dialect of an
  op's variant table (falling back to the reference ``fn``, run on the
  host).  The paper's plain-CPU lane: minimal dispatch, no handoff.
* ``torch-cpu``   — the reference payloads, PyTorch eager on the host.
* ``cuda:<i>``    — the reference payloads on CUDA device ``i``
  (``cuda_target``).
* ``cuda-kernels`` — serves the ``"cuda"`` dialect (the hand-written
  kernels) on CUDA device 0 (``cuda_kernels``), probe-verified against
  the reference composition before it is served.

The two host targets never jit (``jit=False``); the CUDA targets do:
their warm segments replay as verified CUDA graphs, and their cells are
timed so.

The CUDA lanes are priced as accelerators: a lane switch to or from one
charges ``handoff_s`` on each accelerator side.
"""
from __future__ import annotations

from typing import Any

import torch

from ..targets import Target, TargetRegistry

# priced cross-lane handoff of a CUDA lane: one main-path activation
# (4 MiB of f32) over PCIe at ~25 GB/s plus a device synchronise
CUDA_HANDOFF_S = 2.5e-4


def _cuda_device(index: int = 0) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CUDA targets need a card "
                           "(pass device='cpu' for the host targets only)")
    return torch.device("cuda", index)


def numpy_eager(**overrides: Any) -> Target:
    kw: dict[str, Any] = dict(
        name="numpy-eager", kind="host", dialect="numpy", jit=False,
        device=torch.device("cpu"), is_accelerator=False, dispatch_s=3e-6,
        handoff_s=0.0, power_compute=15.0, power_memory=11.0)
    kw.update(overrides)
    return Target(**kw)


def torch_cpu(**overrides: Any) -> Target:
    kw: dict[str, Any] = dict(
        name="torch-cpu", kind="cpu", dialect="ref", jit=False,
        device=torch.device("cpu"), is_accelerator=False, dispatch_s=1e-5,
        handoff_s=0.0, power_compute=17.0, power_memory=12.0)
    kw.update(overrides)
    return Target(**kw)


def cuda_target(index: int = 0, **overrides: Any) -> Target:
    """The reference-dialect lane on one CUDA device.  atol/rtol 1e-5 as
    the reference's device targets declare: the tolerance this lane's
    outputs are held to wherever they are compared with another
    device's."""
    dev = _cuda_device(index)
    kw: dict[str, Any] = dict(
        name=f"cuda:{index}", kind="cuda", dialect="ref", jit=True,
        device=dev,
        is_accelerator=True, dispatch_s=1e-5, handoff_s=CUDA_HANDOFF_S,
        power_compute=700.0, power_memory=400.0, atol=1e-5, rtol=1e-5)
    kw.update(overrides)
    return Target(**kw)


def cuda_kernels(index: int = 0, **overrides: Any) -> Target:
    """The hand-written-kernel lane (dialect ``"cuda"``) on one CUDA
    device.

    Its probe holds each kernel op to the dtype's bucket with atol
    scaled by the op's largest output magnitude: the MoE outputs of the
    main path (``GRANITE_MAIN_PATH``, weights at scale 0.5) reach ~7e4,
    where an f32 sum over 1024 terms is off by ~1e-2 in absolute terms
    near zero, while attention, SSD and tanh outputs are of order 1 and
    stay held to the bucket itself."""
    dev = _cuda_device(index)
    kw: dict[str, Any] = dict(
        name="cuda-kernels", kind="cuda", dialect="cuda", jit=True,
        device=dev,
        is_accelerator=True, dispatch_s=1e-5, handoff_s=CUDA_HANDOFF_S,
        power_compute=700.0, power_memory=400.0, atol_scaled=True)
    kw.update(overrides)
    return Target(**kw)


def default_registry(*, device=None) -> TargetRegistry:
    """The builtin target set.  By default (``device=None``) the card's:
    `numpy-eager` + `torch-cpu` + `cuda:<i>` for every CUDA device +
    `cuda-kernels` on device 0, raising when there is no CUDA device.
    ``device="cpu"`` asks for the two host targets only."""
    reg = TargetRegistry([numpy_eager(), torch_cpu()])
    if device is not None and torch.device(device).type == "cpu":
        return reg
    _cuda_device()
    for i in range(torch.cuda.device_count()):
        reg.register(cuda_target(i))
    reg.register(cuda_kernels(0))
    return reg
