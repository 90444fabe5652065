"""The training step (``trainer``).  Port of ``repro.train``."""
