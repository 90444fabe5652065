"""Autoshard mode: sharding strategies as BIDENT "PUs".

Port of ``repro.core.autoshard``.  On a mesh of GPUs the heterogeneity
that matters is not CPU/GPU/NPU but *which sharding a given operator
runs under*.  This module maps BIDENT's abstraction 1:1 onto that
problem:

  PU P_j                   -> sharding strategy S_j (REP/DP/SP/TP/DP_TP/EP)
  kernel cost w(O_i, P_j)  -> H100 roofline time of the per-shard work
  H2D/D2H transition cost  -> resharding collective bytes / link bandwidth
  unsupported (op, PU)     -> infeasible (op, strategy): no node in graph
  energy w x p             -> mesh power model (compute vs memory bound)

The *same* CostTable / graph / Dijkstra machinery from ``core`` then finds
the optimal per-operator sharding path — the paper's Algorithm 1 applied
to distributed-sharding search.

A strategy transition is modeled as D2H (all-gather the producer's
output out of its sharding) + H2D (local slice into the consumer's
sharding), mirroring the paper's accelerator H2D/D2H edge rule.  A
direct all-to-all reshard can be cheaper; see ``direct_reshard`` below.

The law is the reference's; only the chip constants are the H100's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np

from .contention import ContentionModel
from .costmodel import CostEntry, CostTable, PUSpec
from .op import FusedOp, OpGraph
from .schedule import ParallelSchedule, SeqSchedule, single_pu_cost
from .search import solve_parallel, solve_sequential

# ---------------------------------------------------------------------------
# NVIDIA H100 SXM constants (the card the port runs on)
# ---------------------------------------------------------------------------

# bf16 dense tensor-core peak, no sparsity (NVIDIA H100 data sheet, SXM)
PEAK_FLOPS = 989e12
# HBM3, 80 GB part (NVIDIA H100 data sheet, SXM)
HBM_BW = 3.35e12
# collective bandwidth per GPU of the slowest link a 16-wide ``model``
# ring crosses: an NVLink domain (one HGX board) holds 8 GPUs, so the
# ring leaves the board over InfiniBand NDR, 400 Gb/s = 50e9 B/s per GPU
# (one ConnectX-7 port per GPU, NVIDIA DGX H100 reference architecture)
LINK_BW = 50e9
# NVLink 4 inside the board, per direction per GPU (18 links x 25 GB/s,
# NVIDIA H100 data sheet); rings of <= 8 GPUs would see this instead
NVLINK_BW = 450e9
# per-op launch overhead: the host time of one small kernel launch, the
# median of three readings by chip_smoke.py phase 10 (c) on an NVIDIA
# H100 80GB HBM3 at 700 W (6.86, 8.68, 9.62 us)
DISPATCH_S = 8.68e-6
# per collective phase latency: a guess, since one card cannot measure a
# hop between two GPUs.  It is the median of three readings of a
# one-rank NCCL all-reduce of 4 bytes by chip_smoke.py phase 10 (c) on
# the same card (26.1, 75.8, 89.5 us: host time, which spreads); a real
# hop adds the wire's latency.  The autoshard speedups move with it:
# phase 10 (c) prints them at both ends of the spread.
HOP_LAT = 7.58e-5
# board power limit (NVIDIA H100 data sheet, SXM: up to 700 W).  The data
# sheet gives one limit, not a compute/memory split, so both charge it.
POWER_COMPUTE = 700.0
POWER_MEMORY = 700.0

# fraction of PEAK_FLOPS each fused-op kind reaches.  matmul and conv2d
# run on the tensor cores at the share a bf16 GEMM (8192^3) reached in
# chip_smoke.py phase 10 (c) on an NVIDIA H100 80GB HBM3 at 700 W, 80.5%;
# attention at the share the port's bf16 flash_attention reached there at
# Llama-3.2-1B's prefill shape, 6.5%; every other kind runs on the CUDA
# cores, whose f32 peak is 67e12 FLOP/s (data sheet), so at most 67/989
# of the bf16 peak; transfers are priced by bytes alone.
_CUDA_CORES = 67e12 / PEAK_FLOPS
KIND_EFF = {
    "matmul": 0.805, "conv2d": 0.805, "attention": 0.065, "rdft": _CUDA_CORES,
    "cumsum": _CUDA_CORES, "scan": _CUDA_CORES, "gather": _CUDA_CORES,
    "scatter": _CUDA_CORES, "embed": _CUDA_CORES, "norm": _CUDA_CORES,
    "softmax": _CUDA_CORES, "act": _CUDA_CORES, "add": _CUDA_CORES,
    "mul": _CUDA_CORES, "other": _CUDA_CORES, "dwconv": _CUDA_CORES,
    "transfer": 1.0,
}
# fraction of HBM_BW per kind (default 0.8): the reference's fractions,
# not measured on the card
KIND_BW_EFF = {
    "gather": 0.5, "scatter": 0.5, "embed": 0.5, "cumsum": 0.7, "scan": 0.7,
}

# kinds whose recurrence/statefulness forbids sharding the time dim
_SEQ_FORBIDDEN = ("attention", "scan", "cumsum")


@dataclasses.dataclass(frozen=True)
class Strategy:
    """One sharding strategy = one BIDENT "PU"."""

    name: str
    # parallel degree over which this strategy divides the op's work,
    # given (data_axis, model_axis) mesh sizes
    data_frac: bool      # shards over the data axis
    model_frac: bool     # shards over the model axis
    # which tensor dim the strategy splits (for feasibility checks):
    # "batch" (dim 0), "seq" (dim 1), "feature" (last dim), "table"
    # (first dim of operand 0 — the EP/gather case), or None (replicated)
    split: str | None

    def degree(self, d_data: int, d_model: int) -> int:
        deg = 1
        if self.data_frac:
            deg *= d_data
        if self.model_frac:
            deg *= d_model
        return deg


STRATEGIES: dict[str, Strategy] = {
    "REP":   Strategy("REP", False, False, None),
    "DP":    Strategy("DP", True, False, "batch"),
    "SP":    Strategy("SP", True, False, "seq"),
    "TP":    Strategy("TP", False, True, "feature"),
    "DP_TP": Strategy("DP_TP", True, True, "batch+feature"),
    "EP":    Strategy("EP", False, True, "table"),
}


def strategy_pus(d_data: int, d_model: int,
                 names: Sequence[str] | None = None) -> dict[str, PUSpec]:
    """PUSpec adapters so the core search/graph code works unchanged.

    Every strategy is an "accelerator" (the paper's transition rule then
    charges D2H out of the source + H2D into the destination, which is our
    all-gather + local-slice reshard model).  Power fields carry the *pod*
    power (chips x per-chip W) used to scale transition-edge energy.
    """
    n = d_data * d_model
    out: dict[str, PUSpec] = {}
    for nm in (names or STRATEGIES):
        out[nm] = PUSpec(
            name=nm, is_accelerator=True, dispatch_s=DISPATCH_S,
            mem_bw=HBM_BW, peak_gemm={2: PEAK_FLOPS, 1: 2 * PEAK_FLOPS},
            sat_flops={2: 0.0, 1: 0.0}, kind_eff=KIND_EFF,
            kind_bw_eff=KIND_BW_EFF, h2d_base=0.0, h2d_bw=LINK_BW,
            power_compute=POWER_COMPUTE * n, power_memory=POWER_MEMORY * n,
        )
    return out


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


class ShardingCostModel:
    """Fill a CostTable whose "PUs" are sharding strategies."""

    def __init__(self, d_data: int = 16, d_model: int = 16,
                 strategies: Sequence[str] | None = None,
                 direct_reshard: bool = False):
        self.d_data = d_data
        self.d_model = d_model
        self.names = list(strategies or STRATEGIES)
        self.pus = strategy_pus(d_data, d_model, self.names)
        # beyond-paper refinement: transitions bounded by a direct
        # all-to-all instead of gather+slice (see transition docstring)
        self.direct_reshard = direct_reshard

    # -- feasibility ---------------------------------------------------------
    def feasible(self, op: FusedOp, s: Strategy) -> bool:
        if s.split is None:
            return True
        shape = op.out_shape or (op.in_shapes[0] if op.in_shapes else ())
        if not shape:
            return False
        if s.split == "batch":
            return shape[0] % self.d_data == 0 and shape[0] >= self.d_data
        if s.split == "seq":
            if op.kind in _SEQ_FORBIDDEN:
                return False
            return (len(shape) >= 3 and shape[1] % self.d_data == 0
                    and shape[1] >= self.d_data)
        if s.split == "feature":
            return shape[-1] % self.d_model == 0 and shape[-1] >= self.d_model
        if s.split == "batch+feature":
            return (shape[0] % self.d_data == 0 and shape[0] >= self.d_data
                    and shape[-1] % self.d_model == 0
                    and shape[-1] >= self.d_model)
        if s.split == "table":
            # EP: shard the lookup table / expert dim (gather/scatter class)
            if op.kind not in ("gather", "scatter", "embed"):
                return False
            t = op.in_shapes[0] if op.in_shapes else ()
            return bool(t) and t[0] % self.d_model == 0 and t[0] >= self.d_model
        return False

    # -- per-shard bytes (the DP/TP asymmetry) -------------------------------
    def _shard_bytes(self, op: FusedOp, s: Strategy, deg: int) -> float:
        """HBM bytes per chip under strategy ``s``.

        The asymmetry that makes the search non-trivial: token-sharding
        (DP/SP) replicates *weights* (every chip streams the full weight),
        while weight-sharding (TP/EP) replicates *activations*.  For
        decode-shape GEMMs (tiny token count, weight-dominated) TP wins by
        ~d_model x; for train-shape GEMMs (activation-dominated) DP wins.
        This is the mesh analog of the paper's operand-size-dependent PU
        affinity (Observation 2 / Fig. 3).
        """
        dtb = op.dtype_bytes
        if op.kind in ("matmul", "conv2d", "dwconv") and len(op.in_shapes) >= 2:
            act = float(np.prod(op.in_shapes[0])) * dtb
            w = float(np.prod(op.in_shapes[1])) * dtb
            out = op.out_bytes
            if s.split in ("batch", "seq"):            # DP / SP
                return act / deg + w + out / deg
            if s.split == "feature":                    # TP (column parallel)
                return act + w / deg + out / deg
            if s.split == "batch+feature":              # DP_TP
                return (act / self.d_data + w / self.d_model
                        + out / deg)
            return act + w + out                        # REP
        if op.kind in ("gather", "scatter", "embed") and op.in_shapes:
            table = float(np.prod(op.in_shapes[0])) * dtb
            rest = (sum(float(np.prod(sh)) for sh in op.in_shapes[1:]) * dtb
                    + op.out_bytes)
            if s.split == "table":                      # EP
                return table / deg + rest
            if s.split is None:
                return table + rest
            return table + rest / deg                   # token sharding
        # weight-free ops (attention over cache, norms, eltwise, scans):
        # all strategies divide traffic evenly over their degree
        return op.bytes_moved / deg

    # -- per-op costing ------------------------------------------------------
    def entry(self, op: FusedOp, name: str) -> CostEntry | None:
        """Cost of ``op`` under strategy ``name``.

        Infeasibility is *soft* by default: when the strategy's split dim
        doesn't exist / divide, the op degrades to replicated execution
        under that strategy (what the Policy's divisibility guard does for
        non-divisible dims).  Hard
        omission (no table entry — the paper's compile-failure case) only
        happens via ``op.meta['unsupported_on']``.
        """
        if name in op.meta.get("unsupported_on", ()):
            return None
        s = STRATEGIES[name]
        if not self.feasible(op, s):
            s = STRATEGIES["REP"]
        deg = s.degree(self.d_data, self.d_model)
        eff = KIND_EFF.get(op.kind, KIND_EFF["other"])
        bw_eff = KIND_BW_EFF.get(op.kind, 0.8)
        t_compute = (op.flops / deg) / (PEAK_FLOPS * eff)
        t_memory = self._shard_bytes(op, s, deg) / (HBM_BW * bw_eff)
        kernel = max(t_compute, t_memory)
        frac_compute = min(t_compute / kernel, 1.0) if kernel > 0 else 0.0
        n = self.d_data * self.d_model
        power = (POWER_MEMORY + (POWER_COMPUTE - POWER_MEMORY) * frac_compute) * n
        # d2h: all-gather this op's output out of the strategy's activation
        # sharding (bytes x (deg-1)/deg over the link, + per-phase latency).
        if deg > 1:
            gather = (op.out_bytes * (deg - 1) / deg) / LINK_BW \
                + HOP_LAT * math.log2(deg)
            if self.direct_reshard:
                # a direct reshard moves only each chip's resident slice to
                # its new owners: at most bytes/deg per chip pairwise
                gather = min(gather,
                             (op.out_bytes / deg) / LINK_BW
                             + HOP_LAT * math.log2(deg))
        else:
            gather = 0.0
        return CostEntry(kernel=kernel, dispatch=DISPATCH_S, h2d=0.0,
                         d2h=gather, power=power)

    def build_table(self, graph: OpGraph) -> CostTable:
        table = CostTable(self.names)
        for i, op in enumerate(graph.ops):
            for nm in self.names:
                e = self.entry(op, nm)
                if e is not None:
                    table.set(i, nm, e)
        return table


# ---------------------------------------------------------------------------
# autoshard pass
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AutoshardResult:
    schedule: SeqSchedule
    single: dict[str, float | None]      # strategy -> monolithic latency
    best_single: str
    speedup: float                       # vs best single strategy
    table: CostTable
    model: ShardingCostModel

    def summary(self) -> str:
        lines = [f"autoshard: {len(self.schedule.chain)} fused ops, "
                 f"objective={self.schedule.objective}"]
        for nm, v in sorted(self.single.items()):
            mark = " <- best single" if nm == self.best_single else ""
            lines.append(f"  {nm:6s}: "
                         + (f"{v*1e3:9.3f} ms{mark}" if v is not None
                            else "   infeasible"))
        lines.append(f"  BIDENT: {self.schedule.latency*1e3:9.3f} ms "
                     f"({self.speedup:.2f}x vs best single)")
        counts: dict[str, int] = {}
        for a in self.schedule.assignment:
            counts[a] = counts.get(a, 0) + 1
        lines.append("  assignment: " + ", ".join(
            f"{k}={v}" for k, v in sorted(counts.items())))
        return "\n".join(lines)


def autoshard(graph: OpGraph, *, d_data: int = 16, d_model: int = 16,
              objective: str = "latency",
              direct_reshard: bool = False) -> AutoshardResult:
    """Run the BIDENT search with sharding strategies as PUs."""
    model = ShardingCostModel(d_data, d_model, direct_reshard=direct_reshard)
    table = model.build_table(graph)
    chain = list(range(len(graph)))
    sched = solve_sequential(chain, graph.ops, table, model.pus, objective)
    single: dict[str, float | None] = {}
    for nm in model.names:
        c = single_pu_cost(chain, nm, graph.ops, table, model.pus)
        single[nm] = None if c is None else (c[0] if objective == "latency"
                                             else c[1])
    feas = {k: v for k, v in single.items() if v is not None}
    best_single = min(feas, key=feas.get)
    opt = sched.latency if objective == "latency" else sched.energy
    return AutoshardResult(schedule=sched, single=single,
                           best_single=best_single,
                           speedup=feas[best_single] / max(opt, 1e-30),
                           table=table, model=model)


# ---------------------------------------------------------------------------
# override emission: strategy -> Policy logical axes per constrain site
# ---------------------------------------------------------------------------

# logical-axes template per strategy for rank-3 (B, T, F) activation sites;
# Policy.constrain pads/trims to the tensor rank and applies divisibility
# guards, so these templates are safe for any site.
_STRATEGY_AXES: dict[str, tuple] = {
    "REP":   (None, None, None),
    "DP":    ("batch", None, None),
    "SP":    ("batch", "seq_shard", None),
    "TP":    (None, None, "ff"),
    "DP_TP": ("batch", None, "ff"),
    "EP":    (None, None, "experts"),
}


def emit_overrides(site_assignment: Mapping[str, str]) -> dict[str, tuple]:
    """Map {constrain-site name -> strategy} to Policy.overrides.

    The returned dict plugs into ``sharding.Policy(overrides=...)``: model
    code tags its ``with_sharding_constraint`` sites with ``name=...`` and
    the override replaces the default logical axes at that site — this is
    how a BIDENT schedule becomes real DTensor placements on the mesh.
    """
    out: dict[str, tuple] = {}
    for site, strat in site_assignment.items():
        if strat not in _STRATEGY_AXES:
            raise KeyError(f"unknown strategy {strat!r}")
        out[site] = _STRATEGY_AXES[strat]
    return out


# ---------------------------------------------------------------------------
# intra-model parallel regime on a mesh (paper §3.3.2 mapped to mesh slices)
# ---------------------------------------------------------------------------

def _ici_contention(names) -> ContentionModel:
    """Branches that co-execute under different strategies contend for link
    and HBM bandwidth; a flat measured-style 1.10x factor stands in for
    the paper's per-PU-pair SF table (strategies sharing a mesh axis
    contend; REP never does)."""
    sf = {}
    for a in names:
        for b in names:
            sf[(a, b)] = 1.0 if (a == b or "REP" in (a, b)) else 1.10
    return ContentionModel(sf=sf, mm_sf=sf)


def autoshard_parallel(graph: OpGraph, *, d_data: int = 16,
                       d_model: int = 16, objective: str = "latency",
                       direct_reshard: bool = False) -> ParallelSchedule:
    """Phase/branch-parallel BIDENT search with strategies as PUs.

    MoE layers' routed/shared branches (and enc/dec towers) become the
    paper's concurrent phases: each branch gets its own per-operator
    strategy path and the phase makespan is the contention-adjusted max —
    i.e. independent subgraphs co-execute on disjoint mesh capacity.
    """
    model = ShardingCostModel(d_data, d_model, direct_reshard=direct_reshard)
    table = model.build_table(graph)
    return solve_parallel(graph, table, model.pus,
                          _ici_contention(model.names), objective)
