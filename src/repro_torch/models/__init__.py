"""The model zoo on PyTorch: ``layers`` (the primitive layers) and
``model`` (init / forward / loss / prefill / decode over the six block
patterns).  Port of ``repro.models``."""
