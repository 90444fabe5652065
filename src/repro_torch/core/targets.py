"""Execution targets: named backends behind the PU lanes.

Port of ``repro.core.targets``.  A :class:`Target` is a *data*
declaration of how a lane executes —

* which torch device the payloads run on (``device``; segment inputs
  are moved there before the segment runs),
* which entry of an op's variant table is served (``dialect``; ``"ref"``
  is the op's own ``fn``, the oracle payload),
* whether its segments are captured as CUDA graphs and its cells timed
  as captured replays (``jit``, the reference's jit policy; only a lane
  on a CUDA device captures), and
* how the planner should price its dispatch and cross-lane handoffs
  (``dispatch_s``, ``handoff_s``, ``is_accelerator``).

Adding a backend is registering one more ``Target`` value — no executor
or planner code changes.  :class:`TargetRegistry` holds them by name;
``backends.default_registry()`` provides the builtin set (`numpy-eager`,
`torch-cpu`, plus, per CUDA device, an eager reference lane and a
hand-written-kernel lane) and ``Orchestrator(targets=...)`` binds lane
names to registered targets.  The reference's ``interpret`` field (the
Pallas interpret-mode knob) has no counterpart here.

Verification contract: a non-``ref`` dialect variant is served by the
compiled path only after a cold-run probe against the reference
composition — **bitwise**-gated where the probe passes exactly, else
tolerance-gated per output dtype (:func:`variant_tolerance`, or the
target's declared ``atol``/``rtol``, atol optionally scaled by each
output's largest magnitude), else rejected back to the reference
payload.  The per-op interpreter never reads variant tables:
it stays the single-variant oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

import numpy as np
import torch

from .costmodel import PUSpec

# Per-dtype (atol, rtol) used when a variant's probe is not bitwise equal
# to the reference composition (the reference package's buckets, which
# follow tests/test_kernels.py: blockwise kernels reorder float
# accumulation, so f32 variants land within ~1e-4 of the oracle and bf16
# within ~5e-2).  Non-float outputs get (0, 0): integer/bool variants
# must be bitwise.
VARIANT_TOL: dict[str, tuple[float, float]] = {
    "float64": (1e-9, 1e-9),
    "float32": (3e-4, 3e-4),
    "float16": (2e-2, 2e-2),
    "bfloat16": (5e-2, 5e-2),
}


# Dialects whose variants are hand-written kernels.  A kernel that fails
# to run in its probe (a failed launch, a shape it does not take) is a
# fault of its lane and raises; only a numeric disagreement sends the
# segment back to the reference payloads.
KERNEL_DIALECTS = frozenset({"cuda"})


# torch dtypes named explicitly: ``np.dtype(torch.bfloat16)`` fails, and
# falling through to (0, 0) would reject every bf16 variant
_TORCH_DTYPE_NAMES = {torch.float64: "float64", torch.float32: "float32",
                      torch.float16: "float16", torch.bfloat16: "bfloat16"}


def variant_tolerance(dtype: Any) -> tuple[float, float]:
    """(atol, rtol) bucket for comparing a variant output of ``dtype`` (a
    torch or NumPy dtype) against the reference payload's output."""
    if isinstance(dtype, torch.dtype):
        name = _TORCH_DTYPE_NAMES.get(dtype, str(dtype))
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = str(dtype)
    return VARIANT_TOL.get(name, (0.0, 0.0))


@dataclasses.dataclass(frozen=True, eq=False)
class Target:
    """One named execution backend, declared as data.

    ``dialect`` selects the op payload: ``op.payload_for(dialect)``
    returns ``op.variants[dialect]`` when present, else the reference
    ``op.fn``.  ``device`` (a ``torch.device``) is where the lane runs:
    the compiled path and the profiler move every segment input there
    first, so a lane never computes on another device by accident.
    ``jit=True`` on a CUDA device captures the lane's warm segments as
    CUDA graphs (kept only when verified, see
    :mod:`repro_torch.core.laneprogram`) and has the profiler time its
    cells as captured replays; elsewhere it changes nothing.

    The pricing fields feed :meth:`pu_spec`: ``handoff_s`` becomes the
    cost-table H2D/D2H column (charged by ``transition_cost`` on lane
    switches when ``is_accelerator``), so the planner only routes an op
    off its neighbours' lane when the measured win clears a real sync
    margin.  Targets compare by identity (a registry entry is the unit
    of binding), not by field value.
    """

    name: str
    kind: str = "host"             # device-class label ("host", "cpu", "cuda")
    dialect: str = "ref"           # variant-table key; "ref" = op.fn oracle
    jit: bool = True               # capture warm segments / profile captured
    device: Any = None             # a torch.device, or None = wherever-is
    is_accelerator: bool = False   # gate handoff pricing + boundary H2D/D2H
    dispatch_s: float = 2e-5       # per-op dispatch charged in the table
    handoff_s: float = 2.5e-4      # priced cross-lane sync (h2d = d2h)
    power_compute: float = 17.0    # W while compute-bound (energy objective)
    power_memory: float = 12.0     # W while memory/transfer-bound
    atol: float | None = None      # override variant_tolerance() per target
    rtol: float | None = None
    atol_scaled: bool = False      # atol is relative to each output's max |ref|
    meta: dict = dataclasses.field(default_factory=dict)

    def tolerance(self, dtype: Any) -> tuple[float, float]:
        """The (atol, rtol) this target's variants are gated at."""
        at, rt = variant_tolerance(dtype)
        return (self.atol if self.atol is not None else at,
                self.rtol if self.rtol is not None else rt)

    def tolerance_for(self, ref: torch.Tensor) -> tuple[float, float]:
        """The (atol, rtol) one variant output is gated at against its
        reference output ``ref``: :meth:`tolerance` of its dtype, with
        atol multiplied by max |ref| when ``atol_scaled`` (so an output
        of magnitude ~1 is held to the bucket itself, and one of
        magnitude 1e4 to the bucket at its own scale)."""
        atol, rtol = self.tolerance(ref.dtype)
        if self.atol_scaled and ref.numel():
            atol *= float(ref.detach().abs().max())
        return atol, rtol

    def pu_spec(self) -> PUSpec:
        """Synthesize the planner-side PUSpec for this target.

        The analytic compute fields are neutral placeholders (flat
        ``kind_eff``, generous peaks): a target-backed workload is meant
        to be priced by *measured* per-target cells
        (``MeasuredProfiler(targets=...)``), and the spec's job is the
        transition algebra — ``is_accelerator`` gating, ``power_*`` for
        the energy objective, ``dispatch_s`` as the analytic fallback.
        """
        return PUSpec(
            name=self.name, is_accelerator=self.is_accelerator,
            dispatch_s=self.dispatch_s, mem_bw=50e9,
            peak_gemm={1: 1e12, 2: 1e12, 4: 1e12, 8: 1e12},
            sat_flops={1: 0.0, 2: 0.0, 4: 0.0, 8: 0.0},
            kind_eff={"other": 1.0}, kind_bw_eff={},
            h2d_base=self.handoff_s, h2d_bw=float("inf"),
            power_compute=self.power_compute,
            power_memory=self.power_memory)

    def __repr__(self) -> str:  # keep registry dumps readable
        return (f"Target({self.name!r}, kind={self.kind!r}, "
                f"dialect={self.dialect!r}, jit={self.jit}, "
                f"device={self.device})")


class TargetRegistry:
    """Named :class:`Target` set; adding a backend is one ``register``."""

    def __init__(self, targets: Iterable[Target] = ()):
        self._targets: dict[str, Target] = {}
        for t in targets:
            self.register(t)

    def register(self, target: Target, *, replace: bool = False) -> Target:
        if not isinstance(target, Target):
            raise TypeError(f"expected a Target, got {type(target).__name__}")
        if target.name in self._targets and not replace:
            raise ValueError(
                f"target {target.name!r} already registered "
                f"(pass replace=True to rebind)")
        self._targets[target.name] = target
        return target

    def get(self, name: str) -> Target:
        try:
            return self._targets[name]
        except KeyError:
            raise KeyError(
                f"unknown target {name!r}; registered: {self.names()}"
            ) from None

    def names(self) -> list[str]:
        return list(self._targets)

    def items(self):
        return self._targets.items()

    def __contains__(self, name: str) -> bool:
        return name in self._targets

    def __iter__(self):
        return iter(self._targets.values())

    def __len__(self) -> int:
        return len(self._targets)

    def __repr__(self) -> str:
        return f"TargetRegistry({self.names()})"


def resolve_targets(spec) -> dict[str, Target] | None:
    """Normalize a target binding to ``{lane name: Target}``.

    Accepts ``None``, a :class:`TargetRegistry` (one lane per registered
    target, named after it), a ``{lane: Target}`` mapping (lane names may
    differ from target names — two lanes can share one target), or an
    iterable of targets.
    """
    if spec is None:
        return None
    if isinstance(spec, TargetRegistry):
        return {t.name: t for t in spec}
    if isinstance(spec, Mapping):
        binding = dict(spec)
    else:
        binding = {t.name: t for t in spec}
    if not binding:
        raise ValueError("empty target binding: need at least one lane")
    for lane, t in binding.items():
        if not isinstance(t, Target):
            raise TypeError(
                f"lane {lane!r}: expected a Target, got {type(t).__name__}")
    return binding


def pu_specs_for_targets(targets: Mapping[str, Target]) -> dict[str, PUSpec]:
    """Planner PU axis for a lane→target binding (``Target.pu_spec`` per
    lane, keyed by *lane* name so cost-table columns line up)."""
    return {lane: t.pu_spec() for lane, t in targets.items()}
