"""Optimizer and gradient compression (``adamw``, ``compress``).  Port of
``repro.optim``."""
