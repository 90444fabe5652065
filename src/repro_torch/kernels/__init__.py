"""Hand-written Hopper kernels for the compute hot-spots of the chain.

Ports of the reference package's three Pallas TPU kernels, each a CUDA
C++ source under ``csrc/`` (built with ``nvcc`` for ``sm_90a`` at first
use, bound with ``ctypes``) with a plain PyTorch version beside it:

* ``flash_attention`` — blockwise causal GQA attention;
* ``ssd_scan``        — the chunked Mamba-2 state-space scan;
* ``expert_glu``      — the capacity-padded MoE expert GLU, under
  ``moe_dispatch_combine``;

and one kernel of the port's own, with no Pallas kernel behind it:

* ``ssd_step``        — one decode step of the same recurrence, the
  state updated in place.

``ops`` dispatches on the tensor's device (CPU: the plain version; CUDA:
the kernel), ``ref`` holds the dense oracles, ``payloads`` the per-dialect
op payload tables.  (Unlike the reference package, the entry points are
not re-exported here: their names would shadow the kernel modules.)  ``launch_counts()`` reports how often each kernel
launched since ``reset_launch_counts()``.
"""
from . import ops, payloads, ref  # noqa: F401
from ._build import launch_counts, reset_launch_counts  # noqa: F401
from .payloads import (attention_payloads, bind_variants,  # noqa: F401
                       eltwise_payloads, moe_payloads, sort_payloads,
                       ssd_payloads)
