"""Production and host meshes.

Port of ``repro.launch.mesh``.  Both are FUNCTIONS: importing this module
starts no process group and touches no device.  Single pod: (16, 16) =
256 ranks, axes (data, model).  Multi-pod: (2, 16, 16) = 512 ranks, axes
(pod, data, model) — the pod axis composes with data parallelism.

A mesh spans the ranks of the current ``torch.distributed`` process
group.  The production meshes need a group of 256 or 512 ranks (the
dry-run starts a fake one, ``repro_torch.launch.dryrun``);
:func:`make_host_mesh` starts a one-rank group when none exists.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _device_type() -> str:
    """The mesh's device type: the card under NCCL, the host otherwise
    (gloo, or the fake group of the dry-run)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"the production mesh {shape} needs a process "
                           f"group of {n} ranks (have {have})")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def start_single_rank_group(device: str = "cuda") -> None:
    """A one-rank process group: NCCL on the card, gloo on the host."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card "
                               "by default; pass device='cpu' for the host")
        torch.cuda.set_device(device.index or 0)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group for device {device}")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_host_mesh(model_axis: int = 1, *, device: str = "cuda"):
    """(data, model) mesh over the ranks of the current process group;
    without one, a one-rank group is started first (NCCL on the card,
    gloo when ``device="cpu"``)."""
    if not dist.is_initialized():
        start_single_rank_group(device)
    n = dist.get_world_size()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"--model-axis {model_axis} does not divide the "
                         f"{n} ranks of the process group")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
