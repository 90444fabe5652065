"""Fused-operator abstraction and operator DAG.

BIDENT operates on *fused operators*: groups of primitive ops fused by the
backend compiler (paper §3, "we use the term operator to refer to a group of
primitive operations fused by the backend compiler").  ``FusedOp`` carries
everything the cost model needs (kind, operand shapes, flop/byte counts) plus
an optional callable so the executor can actually run it.

``OpGraph`` is the fused-operator DAG.  It supports the paper's phase/branch
partitioning (§3.2.2): a topological traversal partitions the DAG into
*phases* bounded by fork (out-degree > 1) and join (in-degree > 1) points;
within a phase, *branches* are the mutually independent chains.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Sequence

import numpy as np

# Operator kinds.  These cover the paper's seven representative operators
# (Fig. 2) plus the kinds needed by the model zoo.
OP_KINDS = (
    "matmul",        # dense GEMM / GEMV
    "conv2d",        # standard convolution
    "dwconv",        # depthwise convolution
    "add",           # elementwise add / residual
    "mul",           # elementwise multiply / gating
    "rdft",          # real FFT (Hyena long conv)
    "cumsum",        # sequential scan (Mamba selective scan recurrence)
    "gather",        # indexed gather (KAN spline eval, MoE dispatch)
    "scatter",       # indexed scatter (MoE combine)
    "norm",          # layer/rms/batch norm
    "act",           # nonlinearity (SiLU/GELU/ReLU/spike)
    "softmax",       # softmax / attention probs
    "attention",     # fused attention block
    "scan",          # recurrent scan (SSM/xLSTM state update)
    "embed",         # embedding lookup
    "transfer",      # explicit data movement (rare; usually edge cost)
    "other",
)


@dataclasses.dataclass
class FusedOp:
    """One fused operator in an inference/training graph."""

    name: str
    kind: str
    # Shapes of the major input operands and the output (element counts are
    # what the cost model consumes).
    in_shapes: tuple[tuple[int, ...], ...] = ()
    out_shape: tuple[int, ...] = ()
    dtype_bytes: int = 2  # FP16 default, INT8 -> 1
    flops: float = 0.0    # algorithmic FLOPs
    bytes_moved: float = 0.0  # bytes read + written (roofline memory term)
    # Optional execution payload: fn(*inputs) -> output.  Used by the
    # executor to really run the schedule; None for analytic-only graphs.
    # ``fn`` is always the *reference* variant: the per-op interpreter
    # executes it exclusively (the single-variant bitwise oracle).
    fn: Callable[..., Any] | None = None
    # Per-target payload variants: ``{dialect: callable}`` with the same
    # call signature as ``fn``.  The compiled path serves
    # ``payload_for(target.dialect)`` on a lane bound to a target, after
    # probe-verifying it against the reference payload on the same
    # inputs.  Rebinding
    # any entry after compilation invalidates cached lane programs (the
    # same staleness rule as rebinding ``fn``).
    variants: dict[str, Callable[..., Any]] = dataclasses.field(
        default_factory=dict)
    # Free-form metadata (e.g. which paper model / layer this came from).
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind not in OP_KINDS:
            raise ValueError(f"unknown op kind {self.kind!r}")
        if not self.bytes_moved:
            n_in = sum(int(np.prod(s)) for s in self.in_shapes)
            n_out = int(np.prod(self.out_shape)) if self.out_shape else 0
            self.bytes_moved = float((n_in + n_out) * self.dtype_bytes)
        if not self.flops:
            self.flops = default_flops(self.kind, self.in_shapes, self.out_shape)

    def payload_for(self, dialect: str | None) -> Callable[..., Any] | None:
        """The payload serving ``dialect``: the variant-table entry when
        one is bound, else the reference ``fn`` (``"ref"``/``None`` always
        resolve to ``fn`` — the oracle is not overridable)."""
        if dialect is None or dialect == "ref":
            return self.fn
        return self.variants.get(dialect, self.fn)

    def payload_token(self) -> tuple:
        """Identity snapshot of ``fn`` + the variant table, compared with
        ``is`` per entry by ``LaneProgram.payloads_current`` so rebinding
        *any* payload after compilation is detected."""
        return (self.fn,
                tuple((k, self.variants[k]) for k in sorted(self.variants)))

    @property
    def out_bytes(self) -> float:
        return float(int(np.prod(self.out_shape)) * self.dtype_bytes) if self.out_shape else 0.0

    @property
    def in_bytes(self) -> float:
        return float(sum(int(np.prod(s)) for s in self.in_shapes) * self.dtype_bytes)


def default_flops(kind: str, in_shapes: Sequence[tuple[int, ...]], out_shape: tuple[int, ...]) -> float:
    """Default algorithmic FLOP count for an op kind."""
    n_out = float(np.prod(out_shape)) if out_shape else 0.0
    if kind == "matmul" and len(in_shapes) >= 2:
        # [.., M, K] x [K, N] -> 2*M*K*N (batch included via out size)
        k = in_shapes[0][-1]
        return 2.0 * n_out * k
    if kind in ("conv2d", "dwconv") and len(in_shapes) >= 2:
        # weight shape (Cout, Cin, kh, kw) or (C, 1, kh, kw) for dw
        w = in_shapes[1]
        per_out = 2.0 * float(np.prod(w[1:]))
        return n_out * per_out
    if kind == "attention" and len(in_shapes) >= 2:
        # q [B,H,Lq,D], k [B,H,Lk,D] -> 4*B*H*Lq*Lk*D
        q, k = in_shapes[0], in_shapes[1]
        return 4.0 * float(np.prod(q)) * k[-2]
    if kind == "rdft":
        n = float(np.prod(in_shapes[0])) if in_shapes else n_out
        return 5.0 * n * max(math.log2(max(n, 2.0)), 1.0)
    if kind in ("cumsum", "scan"):
        return 3.0 * n_out
    if kind in ("add", "mul", "act", "gather", "scatter", "embed", "transfer"):
        return n_out
    if kind in ("norm", "softmax"):
        return 8.0 * n_out
    return n_out


class OpGraph:
    """Fused-operator DAG with phase/branch partitioning (paper §3.2.2)."""

    def __init__(self, ops: Sequence[FusedOp], edges: Iterable[tuple[int, int]] | None = None):
        self.ops: list[FusedOp] = list(ops)
        n = len(self.ops)
        if edges is None:  # pure sequential chain
            edges = [(i, i + 1) for i in range(n - 1)]
        self.succ: list[list[int]] = [[] for _ in range(n)]
        self.pred: list[list[int]] = [[] for _ in range(n)]
        self.n_edges = 0
        for a, b in edges:
            if not (0 <= a < n and 0 <= b < n):
                raise ValueError(f"edge ({a},{b}) out of range")
            self.succ[a].append(b)
            self.pred[b].append(a)
            self.n_edges += 1
        # structure is fixed after construction, so the derived views
        # below are computed once (the acyclicity check already pays for
        # the first topological sort)
        self._topo: list[int] | None = None
        self._is_chain: bool | None = None
        self._check_acyclic()

    # -- basic structure ----------------------------------------------------
    def __len__(self) -> int:
        return len(self.ops)

    @property
    def edges(self) -> list[tuple[int, int]]:
        return [(a, b) for a in range(len(self.ops)) for b in self.succ[a]]

    def is_chain(self) -> bool:
        if self._is_chain is None:
            self._is_chain = (all(len(s) <= 1 for s in self.succ)
                              and all(len(p) <= 1 for p in self.pred))
        return self._is_chain

    def components(self) -> list[list[int]]:
        """Weakly-connected components, each as a topologically-ordered op
        list (in global topo-order positions)."""
        n = len(self.ops)
        parent = list(range(n))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for a, b in self.edges:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb
        buckets: dict[int, list[int]] = {}
        for u in self.topo_order():
            buckets.setdefault(find(u), []).append(u)
        return list(buckets.values())

    def topo_order(self) -> list[int]:
        if self._topo is None:
            n = len(self.ops)
            indeg = [len(p) for p in self.pred]
            stack = [i for i in range(n) if indeg[i] == 0]
            order: list[int] = []
            while stack:
                u = stack.pop()
                order.append(u)
                for v in self.succ[u]:
                    indeg[v] -= 1
                    if indeg[v] == 0:
                        stack.append(v)
            if len(order) != n:
                raise ValueError("graph has a cycle")
            self._topo = order
        return list(self._topo)    # defensive copy: callers may mutate

    def _check_acyclic(self) -> None:
        self.topo_order()

    # -- phase / branch partitioning (paper §3.2.2) -------------------------
    def phases(self) -> list["Phase"]:
        """Partition into phases bounded by fork/join points.

        A *level-synchronous* partition: we walk the DAG in topological order
        and cut a phase boundary at every join (in-degree > 1) and after
        every fork (out-degree > 1).  Inside a phase, branches are the
        maximal independent chains discovered by DFS from the phase's roots.
        Phase boundaries are synchronization barriers.
        """
        n = len(self.ops)
        order = self.topo_order()
        # Longest-path level of each op; ops at disjoint chains between a
        # fork and the matching join share levels.
        level = [0] * n
        for u in order:
            for v in self.succ[u]:
                level[v] = max(level[v], level[u] + 1)

        # Group ops into chains: follow single-in/single-out links.
        visited = [False] * n
        chains: list[list[int]] = []
        for u in order:
            if visited[u]:
                continue
            chain = [u]
            visited[u] = True
            cur = u
            while (
                len(self.succ[cur]) == 1
                and len(self.pred[self.succ[cur][0]]) == 1
            ):
                cur = self.succ[cur][0]
                if visited[cur]:
                    break
                visited[cur] = True
                chain.append(cur)
            chains.append(chain)

        # A chain's phase key: (level of first op).  Chains whose head ops
        # have no dependency between them and overlapping level ranges can
        # co-execute.  We bucket chains by the level of their head; this is
        # the paper's fork/join bounded partition for series-parallel graphs
        # (all graphs our builders emit are series-parallel).
        chain_key = [min(level[i] for i in ch) for ch in chains]
        buckets: dict[int, list[list[int]]] = {}
        for ch, key in zip(chains, chain_key):
            buckets.setdefault(key, []).append(ch)
        phases = [
            Phase(index=pi, branches=[Branch(ops=ch) for ch in buckets[k]])
            for pi, k in enumerate(sorted(buckets))
        ]
        return phases


@dataclasses.dataclass
class Branch:
    """A sequential chain of op indices inside a phase."""

    ops: list[int]


@dataclasses.dataclass
class Phase:
    """A set of mutually independent branches; bounded by barriers."""

    index: int
    branches: list[Branch]

    @property
    def concurrent(self) -> bool:
        return len(self.branches) > 1


def chain_graph(ops: Sequence[FusedOp]) -> OpGraph:
    return OpGraph(ops, edges=None)
