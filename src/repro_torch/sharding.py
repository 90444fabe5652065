"""Logical-axis sharding policy: the one-device part the model layers call.

Port of the part of ``repro.sharding`` that ``models/layers.py`` and
``models/model.py`` use.  Model code annotates tensors with *logical*
axis names (``shd.constrain(x, "batch", "seq", ..., name=...)``); on one
device there is no mesh, and ``constrain`` returns ``x`` unchanged, as
the reference's does without a mesh.  The mesh, its rules and the
parameter specs come with the sharding and launch slice.
"""
from __future__ import annotations


class Policy:
    """The policy without a mesh: every constraint is the identity."""

    def constrain(self, x, *logical_axes: str | None, name: str | None = None):
        """``x`` itself: one device has nothing to shard."""
        return x


NO_POLICY = Policy()
