"""Per-PU cost models and the (operator, PU) cost table (a NumPy copy of
``repro.core.costmodel``).

* ``EdgeSoCCostModel`` — analytic models of the paper's three PUs (CPU /
  GPU / NPU on an Intel Core Ultra-class SoC), calibrated so that the
  paper's motivating measurements hold:

    - Fig. 2 operator affinity: GPU fastest for MatMul (2.8x vs CPU, 1.6x
      vs NPU) and Conv2D (2.2x / 1.1x); CPU fastest for DWConv, Add, RDFT,
      CumSum, Gather with NPU penalties of 4.7x / 8.7x / 4.1x on the
      non-GEMM trio.
    - Fig. 3 MatMul size sweep: FP16 CPU fastest through N=64, GPU
      crosses at N=128 and widens to ~4.8x at N=2048; INT8 CPU leads
      through N=128, GPU crosses at N=256, NPU overtakes GPU only at
      N=2048 (MAC-array utilisation saturation).
    - Power ordering under GEMM load: GPU > CPU > NPU (paper §4.2).

The measured-profiling path (``repro_torch.core.profiler``) fills the same
``CostTable`` from wall-clock timings instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, Sequence

import numpy as np

from .op import FusedOp, OpGraph

# ---------------------------------------------------------------------------
# Cost table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostEntry:
    """Profiled cost of one fused operator on one PU (paper §3.1)."""

    kernel: float      # kernel execution time (s)
    dispatch: float    # kernel dispatch / submit time (s)
    h2d: float         # host-to-device availability cost (s)
    d2h: float         # device-to-host availability cost (s)
    power: float       # sustained power during execution (W)

    @property
    def w(self) -> float:
        """Node weight: dispatch + execution (paper §3.2.1)."""
        return self.dispatch + self.kernel

    @property
    def energy(self) -> float:
        return self.w * self.power


class CostTable:
    """(op index, pu name) -> CostEntry; missing entry == unsupported."""

    def __init__(self, pus: Sequence[str]):
        self.pus: list[str] = list(pus)
        self._t: dict[tuple[int, str], CostEntry] = {}
        # free-form provenance metadata attached by the producer, e.g.
        # MeasuredProfiler records per-op measurement failures under
        # ``meta["profile_failures"]`` instead of swallowing them
        self.meta: dict = {}

    def set(self, op_idx: int, pu: str, entry: CostEntry) -> None:
        if pu not in self.pus:
            raise KeyError(f"unknown PU {pu!r}")
        self._t[(op_idx, pu)] = entry

    def get(self, op_idx: int, pu: str) -> CostEntry | None:
        return self._t.get((op_idx, pu))

    def supported(self, op_idx: int, pu: str) -> bool:
        return (op_idx, pu) in self._t

    def supported_pus(self, op_idx: int) -> list[str]:
        return [p for p in self.pus if (op_idx, p) in self._t]

    def items(self):
        """Iterate ((op_idx, pu), entry) over all populated cells."""
        return self._t.items()

    def require(self, op_idx: int, pu: str) -> CostEntry:
        e = self.get(op_idx, pu)
        if e is None:
            raise KeyError(f"op {op_idx} unsupported on {pu}")
        return e


# ---------------------------------------------------------------------------
# Dense (vectorized) cost-table view
# ---------------------------------------------------------------------------


class DenseCostTable:
    """Vectorized ``(N, K)`` view of a ``CostTable`` along an op chain.

    Built once per chain and shared by the vectorized DP / A* solvers.
    Row ``i`` is chain position ``i`` (op index ``chain[i]``); column ``k``
    is ``table.pus[k]``.  Unsupported (op, PU) slots hold ``inf`` in the
    cost arrays (``w``, ``energy``) so that NumPy ``min``/``argmin`` route
    around them exactly like the sparse search routes around missing
    entries, and ``0`` in the auxiliary arrays (``power``, ``h2d``,
    ``d2h``) so no ``inf * 0`` NaNs can arise in transition algebra.

    ``sig`` assigns every row a signature id: rows with identical
    (w, power, support) vectors share an id, which is what lets the
    concurrent solvers memoize the ``(K0, K1)`` pair-cost matrices per
    op-kind/PU signature instead of per chain position.
    """

    def __init__(self, pus: Sequence[str], chain: Sequence[int],
                 mask: np.ndarray, w: np.ndarray, power: np.ndarray,
                 h2d: np.ndarray, d2h: np.ndarray, acc: np.ndarray,
                 dispatch: np.ndarray | None = None):
        self.pus = list(pus)
        self.chain = list(chain)
        self.mask = mask            # (N, K) bool
        self.w = w                  # (N, K); inf where unsupported
        self.power = power          # (N, K); 0 where unsupported
        self.h2d = h2d              # (N, K); 0 where unsupported
        self.d2h = d2h              # (N, K); 0 where unsupported
        self.acc = acc              # (K,) bool: PU is an accelerator
        # (N, K) dispatch share of w; 0 where unsupported.  Kept separate
        # so runtime conditions can scale the *kernel* share (w - dispatch)
        # without rebuilding the table (see workload.Workload.under_condition).
        self.dispatch = (dispatch if dispatch is not None
                         else np.zeros_like(power))
        with np.errstate(invalid="ignore"):  # inf * 0 at unsupported slots
            self.energy = w * power          # (N, K)
        self.energy[~mask] = np.inf
        self._sig: np.ndarray | None = None
        self._sig_row: np.ndarray | None = None

    def _build_sigs(self) -> None:
        # pair-cost matrices depend only on (w, power, support); one
        # vectorized unique over the stacked rows (id order is opaque)
        stacked = np.concatenate(
            [self.w, self.power, self.mask.astype(np.float64)], axis=1)
        _, first, inv = np.unique(stacked, axis=0, return_index=True,
                                  return_inverse=True)
        self._sig = inv.reshape(-1).astype(np.int64)
        self._sig_row = first.astype(np.int64)

    @property
    def sig(self) -> np.ndarray:
        """(N,) signature id per row; equal-id rows have identical
        (w, power, support) vectors.  Computed lazily — the sequential
        solvers never need it."""
        if self._sig is None:
            self._build_sigs()
        return self._sig

    @property
    def sig_row(self) -> np.ndarray:
        """(n_sig,) a representative row index per signature id."""
        if self._sig_row is None:
            self._build_sigs()
        return self._sig_row

    @property
    def n_sig(self) -> int:
        return len(self.sig_row)

    @property
    def n(self) -> int:
        return len(self.chain)

    @property
    def k(self) -> int:
        return len(self.pus)

    @classmethod
    def from_chain(cls, chain: Sequence[int], table: CostTable,
                   pus: Mapping[str, "PUSpec"]) -> "DenseCostTable":
        n, k = len(chain), len(table.pus)
        mask = np.zeros((n, k), dtype=bool)
        w = np.full((n, k), np.inf)
        power = np.zeros((n, k))
        h2d = np.zeros((n, k))
        d2h = np.zeros((n, k))
        disp = np.zeros((n, k))
        pos_of: dict[int, list[int]] = {}
        for i, oi in enumerate(chain):
            pos_of.setdefault(oi, []).append(i)
        col = {pu: j for j, pu in enumerate(table.pus)}
        # single pass over populated cells (vs N*K speculative lookups)
        for (oi, pu), e in table.items():
            rows = pos_of.get(oi)
            if not rows:
                continue
            j = col[pu]
            ww, pw, hh, dd = e.dispatch + e.kernel, e.power, e.h2d, e.d2h
            for i in rows:
                mask[i, j] = True
                w[i, j] = ww
                power[i, j] = pw
                h2d[i, j] = hh
                d2h[i, j] = dd
                disp[i, j] = e.dispatch
        acc = np.array([pus[p].is_accelerator for p in table.pus], dtype=bool)
        return cls(table.pus, chain, mask, w, power, h2d, d2h, acc,
                   dispatch=disp)

    def require_row(self, pos: int, what: str = "op") -> None:
        if not self.mask[pos].any():
            raise ValueError(
                f"{what} {self.chain[pos]} unsupported on all PUs")


# ---------------------------------------------------------------------------
# Edge SoC PU models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PUSpec:
    """Analytic model of one processing unit."""

    name: str
    is_accelerator: bool
    dispatch_s: float                  # fixed per-kernel dispatch latency
    mem_bw: float                      # effective streaming bandwidth (B/s)
    # peak compute (FLOP/s) per (kind-class, dtype): see _eff_flops
    peak_gemm: Mapping[int, float]     # dtype_bytes -> peak FLOP/s
    # MAC-array / SIMT pipeline-fill constant per dtype (FLOPs).  Applies to
    # GEMM-datapath kinds only: t_compute = (flops + sat) / (peak * eff).
    # This is what makes the NPU win INT8 GEMM only at N=2048 (Fig. 3b).
    sat_flops: Mapping[int, float]
    kind_eff: Mapping[str, float]      # relative efficiency per op kind
    kind_bw_eff: Mapping[str, float]   # bandwidth efficiency per op kind
    h2d_base: float                    # fixed H2D cost (cache/IOMMU/DMA setup)
    h2d_bw: float                      # H2D per-byte bandwidth (B/s)
    power_compute: float               # package W when compute-bound
    power_memory: float                # package W when memory-bound
    # cache-spill knee (FLOPs) for GEMM kinds: effective peak degrades as
    # peak / (1 + flops/knee).  Models the CPU's LLC falling out of reuse
    # at large GEMMs — the paper's Fig. 3a CPU gap widening from 2.8x at
    # N=1024 to 4.8x at N=2048.  Empty = no spill (accelerators).
    spill_flops: Mapping[int, float] = dataclasses.field(default_factory=dict)

    def h2d(self, nbytes: float) -> float:
        if not self.is_accelerator:
            return 0.0
        return self.h2d_base + nbytes / self.h2d_bw

    d2h = h2d  # symmetric (paper §3.1)


def _mk(name, **kw) -> PUSpec:
    return PUSpec(name=name, **kw)


# Op kinds that run on the MAC/MXU datapath (pipeline-fill ramp applies).
GEMM_KINDS = ("matmul", "conv2d", "attention")

# Calibrated PU set (see module docstring for the calibration targets).
CPU = _mk(
    "CPU", is_accelerator=False, dispatch_s=3e-6, mem_bw=55e9,
    # AMX/VNNI-class GEMM throughput with an LLC spill knee: Fig. 3a's CPU
    # gap widens 2.8x (N=1024) -> 4.8x (N=2048) as reuse falls out of cache
    peak_gemm={2: 0.675e12, 1: 0.95e12}, sat_flops={2: 0.0, 1: 0.0},
    spill_flops={2: 19.7e9, 1: 39e9},
    kind_eff={
        "matmul": 1.0, "conv2d": 1.16, "dwconv": 0.80, "attention": 0.9,
        "rdft": 0.55, "cumsum": 0.35, "gather": 0.30, "scatter": 0.30,
        "scan": 0.35, "embed": 0.35, "norm": 0.6, "softmax": 0.6,
        "act": 0.7, "add": 0.7, "mul": 0.7, "other": 0.5, "transfer": 1.0,
    },
    kind_bw_eff={
        "gather": 0.75, "scatter": 0.70, "embed": 0.75, "cumsum": 0.85,
        "scan": 0.85, "rdft": 0.8, "dwconv": 0.85, "add": 0.95, "mul": 0.95,
        "norm": 0.9, "softmax": 0.9, "act": 0.95,
    },
    h2d_base=0.0, h2d_bw=60e9, power_compute=17.0, power_memory=12.0,
)

GPU = _mk(
    "GPU", is_accelerator=True, dispatch_s=5e-6, mem_bw=95e9,
    peak_gemm={2: 1.75e12, 1: 2.30e12}, sat_flops={2: 2.0e6, 1: 2.0e6},
    kind_eff={
        "matmul": 1.0, "conv2d": 0.95, "dwconv": 0.35, "attention": 0.95,
        "rdft": 0.10, "cumsum": 0.02, "gather": 0.10, "scatter": 0.10,
        "scan": 0.02, "embed": 0.10, "norm": 0.5, "softmax": 0.55,
        "act": 0.6, "add": 0.6, "mul": 0.6, "other": 0.3, "transfer": 1.0,
    },
    kind_bw_eff={
        "gather": 0.30, "scatter": 0.28, "embed": 0.30, "cumsum": 0.05,
        "scan": 0.05, "rdft": 0.35, "dwconv": 0.5, "add": 0.6, "mul": 0.6,
        "norm": 0.6, "softmax": 0.6, "act": 0.6,
    },
    # unified memory: H2D = cache flush + IOMMU walk, not a PCIe copy
    h2d_base=5e-6, h2d_bw=120e9, power_compute=28.0, power_memory=18.0,
)

NPU = _mk(
    "NPU", is_accelerator=True, dispatch_s=45e-6, mem_bw=68e9,
    peak_gemm={2: 1.10e12, 1: 4.0e12}, sat_flops={2: 0.8e8, 1: 8.0e9},
    kind_eff={
        "matmul": 1.0, "conv2d": 1.49, "dwconv": 0.50, "attention": 0.85,
        "rdft": 0.075, "cumsum": 0.008, "gather": 0.04, "scatter": 0.04,
        "scan": 0.008, "embed": 0.04, "norm": 0.35, "softmax": 0.35,
        "act": 0.45, "add": 0.5, "mul": 0.5, "other": 0.1, "transfer": 1.0,
    },
    kind_bw_eff={
        "gather": 0.15, "scatter": 0.14, "embed": 0.15, "cumsum": 0.080,
        "scan": 0.080, "rdft": 0.10, "dwconv": 0.6, "add": 0.75, "mul": 0.75,
        "norm": 0.6, "softmax": 0.6, "act": 0.7,
    },
    h2d_base=10e-6, h2d_bw=80e9, power_compute=9.0, power_memory=7.5,
)

EDGE_PUS: dict[str, PUSpec] = {p.name: p for p in (CPU, GPU, NPU)}

# Paper §3.2.2: measured cross-PU slowdown factors SF(P_run, P_interfere).
# NPU is most sensitive (1.17x with CPU active, 1.09x with GPU active);
# CPU and GPU show negligible cross-PU interference with each other, and
# slightly more when the NPU's DMA bursts hit the shared DRAM — this
# ordering is what makes GPU||CPU the consistently-best pair assignment
# in Fig. 4.
DEFAULT_SF: dict[tuple[str, str], float] = {
    ("NPU", "CPU"): 1.17, ("NPU", "GPU"): 1.09,
    ("CPU", "NPU"): 1.03, ("CPU", "GPU"): 1.01,
    ("GPU", "NPU"): 1.03, ("GPU", "CPU"): 1.01,
    ("CPU", "CPU"): 1.0, ("GPU", "GPU"): 1.0, ("NPU", "NPU"): 1.0,
}

# Package static/uncore power (W): drawn for the whole execution window
# regardless of which PUs are active.  This is what makes *shorter
# makespans* save energy in concurrent scheduling (paper Fig. 8's 48.2%
# average concurrent energy reduction) — the SoC's base power integrates
# over wall-clock time.
STATIC_POWER_W = 6.0


class EdgeSoCCostModel:
    """Analytic cost provider for the paper's CPU/GPU/NPU SoC."""

    def __init__(self, pus: Mapping[str, PUSpec] | None = None):
        self.pus: dict[str, PUSpec] = dict(pus or EDGE_PUS)

    # -- per-op costing ------------------------------------------------------
    def _t_compute(self, op: FusedOp, pu: PUSpec) -> float:
        peak = pu.peak_gemm.get(op.dtype_bytes, pu.peak_gemm[2])
        eff = pu.kind_eff.get(op.kind, pu.kind_eff["other"])
        sat = 0.0
        if op.kind in GEMM_KINDS:
            sat = pu.sat_flops.get(op.dtype_bytes, 0.0)
            knee = pu.spill_flops.get(op.dtype_bytes, 0.0)
            if knee:
                peak = peak / (1.0 + op.flops / knee)
        return (op.flops + sat) / max(peak * eff, 1.0)

    def kernel_time(self, op: FusedOp, pu: PUSpec) -> float:
        """Roofline time: max(compute term, memory term)."""
        t_compute = self._t_compute(op, pu)
        bw_eff = pu.kind_bw_eff.get(op.kind, 1.0)
        t_memory = op.bytes_moved / (pu.mem_bw * bw_eff)
        return max(t_compute, t_memory)

    def entry(self, op: FusedOp, pu: PUSpec) -> CostEntry | None:
        unsupported = op.meta.get("unsupported_on", ())
        if pu.name in unsupported:
            return None  # compile failure -> omitted from table (paper §3.1)
        k = self.kernel_time(op, pu)
        # Power depends on boundedness: compute-bound draws more.
        t_compute = self._t_compute(op, pu)
        frac_compute = min(t_compute / k, 1.0) if k > 0 else 0.0
        power = pu.power_memory + (pu.power_compute - pu.power_memory) * frac_compute
        return CostEntry(
            kernel=k,
            dispatch=pu.dispatch_s,
            h2d=pu.h2d(op.in_bytes),
            d2h=pu.d2h(op.out_bytes),
            power=power,
        )

    def build_table(self, graph: OpGraph) -> CostTable:
        table = CostTable(list(self.pus))
        for i, op in enumerate(graph.ops):
            for name, pu in self.pus.items():
                e = self.entry(op, pu)
                if e is not None:
                    table.set(i, name, e)
        return table

    # -- transition costs (paper §3.2.1 edge rule) --------------------------
    def transition(self, table: CostTable, prev_op: int, prev_pu: str,
                   next_op: int, next_pu: str) -> float:
        return transition_cost(self.pus, table, prev_op, prev_pu, next_op, next_pu)


def transition_cost(pus: Mapping[str, PUSpec], table: CostTable,
                    prev_op: int, prev_pu: str, next_op: int, next_pu: str) -> float:
    """Paper §3.2.1: zero if same PU; else H2D(O_next, P_next) when P_next is
    an accelerator, plus D2H(O_prev, P_prev) for accelerator->accelerator or
    accelerator->CPU transitions."""
    if prev_pu == next_pu:
        return 0.0
    cost = 0.0
    if pus[next_pu].is_accelerator:
        cost += table.require(next_op, next_pu).h2d
    if pus[prev_pu].is_accelerator:
        cost += table.require(prev_op, prev_pu).d2h
    return cost


# ---------------------------------------------------------------------------
# Helpers to build representative operators (used by Fig. 2/3/4 benchmarks)
# ---------------------------------------------------------------------------


def make_matmul(n: int, dtype_bytes: int = 2, batch: int = 1, name: str | None = None) -> FusedOp:
    return FusedOp(
        name=name or f"matmul{n}", kind="matmul",
        in_shapes=((batch, n, n), (n, n)), out_shape=(batch, n, n),
        dtype_bytes=dtype_bytes,
    )


def make_conv2d(c_in: int = 64, c_out: int = 64, hw: int = 56, k: int = 3,
                dtype_bytes: int = 2, name: str | None = None) -> FusedOp:
    return FusedOp(
        name=name or "conv2d", kind="conv2d",
        in_shapes=((1, c_in, hw, hw), (c_out, c_in, k, k)),
        out_shape=(1, c_out, hw, hw), dtype_bytes=dtype_bytes,
    )


def make_dwconv(c: int = 128, hw: int = 56, k: int = 3, dtype_bytes: int = 2) -> FusedOp:
    return FusedOp(
        name="dwconv", kind="dwconv",
        in_shapes=((1, c, hw, hw), (c, 1, k, k)),
        out_shape=(1, c, hw, hw), dtype_bytes=dtype_bytes,
    )


def make_eltwise(kind: str, numel: int, dtype_bytes: int = 2) -> FusedOp:
    return FusedOp(name=kind, kind=kind, in_shapes=((numel,), (numel,)) if kind in ("add", "mul") else ((numel,),),
                   out_shape=(numel,), dtype_bytes=dtype_bytes)


def make_rdft(n: int = 1024, ch: int = 512, dtype_bytes: int = 2) -> FusedOp:
    return FusedOp(name="rdft", kind="rdft", in_shapes=((1, ch, n),),
                   out_shape=(1, ch, n // 2 + 1, 2), dtype_bytes=dtype_bytes)


def make_cumsum(n: int = 4096, ch: int = 256, dtype_bytes: int = 2) -> FusedOp:
    return FusedOp(name="cumsum", kind="cumsum", in_shapes=((1, ch, n),),
                   out_shape=(1, ch, n), dtype_bytes=dtype_bytes)


def make_gather(rows: int = 65536, dim: int = 64, idx: int = 8192, dtype_bytes: int = 2) -> FusedOp:
    return FusedOp(name="gather", kind="gather", in_shapes=((rows, dim), (idx,)),
                   out_shape=(idx, dim), dtype_bytes=dtype_bytes)


FIG2_OPS: dict[str, FusedOp] = {
    "MatMul": make_matmul(1024),
    "Conv2D": make_conv2d(128, 128, 56, 3),
    "DWConv": make_dwconv(64, 28, 3),
    "Add": make_eltwise("add", 1 * 64 * 28 * 28),
    "RDFT": make_rdft(1024, 512),
    "CumSum": make_cumsum(4096, 256),
    "Gather": make_gather(65536, 64, 8192),
}
