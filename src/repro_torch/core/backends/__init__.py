"""Builtin execution backends, declared as :class:`~repro_torch.core.targets.Target` data.

``default_registry()`` is the front door: the two host backends
(`numpy-eager`, `torch-cpu`) plus, for each CUDA device, an eager
reference lane and a hand-written-kernel lane.  See ``builtin.py`` for
the factories and :mod:`repro_torch.core.targets` for the contract.
"""
from .builtin import (cuda_kernels, cuda_target, default_registry,
                      numpy_eager, torch_cpu)

__all__ = ["cuda_kernels", "cuda_target", "default_registry",
           "numpy_eager", "torch_cpu"]
