"""BIDENT on PyTorch and CUDA: the port of the JAX reference package
``repro`` to one NVIDIA H100.

The port mirrors ``repro``'s layout (``repro_torch.kernels``,
``repro_torch.core``, ``repro_torch.fault``, the model zoo's
``repro_torch.configs``, ``repro_torch.models``, ``repro_torch.serving``,
``repro_torch.launch`` and ``repro_torch.sharding`` on a
``torch.distributed`` device mesh) and
never imports JAX or
``repro``: what it needs of the reference's pure-NumPy modules it keeps
as its own copies.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
