"""The deterministic training data pipeline (``pipeline``).  Port of
``repro.data``."""
