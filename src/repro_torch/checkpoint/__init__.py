"""Atomic, manifest-driven checkpoints (``ckpt``).  Port of
``repro.checkpoint``."""
