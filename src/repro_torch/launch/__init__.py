"""Command-line drivers (``python -m repro_torch.launch.serve``).  Port of
``repro.launch``."""
