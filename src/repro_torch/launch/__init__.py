"""Command-line drivers (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``).  Port of ``repro.launch``."""
