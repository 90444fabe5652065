"""Batched greedy serving of the model zoo (``engine.Engine``).  Port of
``repro.serving``."""
