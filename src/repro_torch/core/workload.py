"""``Workload`` — the dense-layer contract every solver consumes.

A ``Workload`` binds one inference request's op chain to everything the
schedulers need, in vectorized form:

* the ``(N, K)`` :class:`~repro_torch.core.costmodel.DenseCostTable` (cost,
  power, dispatch, support mask) along the chain,
* the contention *signatures* (``dense.sig``) that let the concurrent
  solvers memoize per-signature pair/group cost matrices,
* the boundary H2D row (``dense.h2d[0]``) and D2H row (``dense.d2h[-1]``)
  that price entering/leaving the chain,
* the per-PU specs (``power_memory`` for transition-energy scaling,
  ``is_accelerator`` for H2D/D2H gating).

**The dense-layer contract.**  The scalar dict ``CostTable`` remains the
*ingestion* format: profilers and analytic cost models populate it cell
by cell, and the scalar ``*_reference`` solvers keep using it as the
equivalence oracle.  Everything on a solver or evaluator hot path —
``sequential_dp``, ``solve_parallel``'s branch re-walk, the concurrent
pair/group searches, ``evaluate_sequential``/``single_pu_cost``, and the
``DynamicScheduler`` — consumes ``Workload`` views instead.  A
``Workload`` is built **once** per (chain, table) via :meth:`build` —
the only place the scalar dict is iterated — and then sliced
(:meth:`tail`), re-indexed (:meth:`select`), or rescaled
(:meth:`under_condition`) as O(N*K) array operations that never touch
the dict again.

Derived views share the source arrays where possible (``tail`` and
``select`` return NumPy views / fancy-indexed copies of rows; they do
not re-ingest), so building per-branch or per-tail workloads inside
``solve_parallel`` / ``DynamicScheduler`` is allocation-cheap.

**DAG invariants.**  A ``Workload`` may additionally carry ``preds`` —
per-position predecessor sets over an op *DAG* — in which case the
following invariants hold and are what every DAG route relies on:

1. ``chain`` is a **topological order** of the DAG: every predecessor
   position in ``preds[i]`` is ``< i``.  A chain-shaped workload is the
   special case ``preds[i] == (i-1,)`` (``preds=None`` means exactly
   that), so every chain solver remains a valid DAG solver oracle.
2. Scheduler state is an **order ideal** (downward-closed set) of DAG
   positions; the *frontier* is the antichain of ready positions (all
   predecessors inside the ideal).  Any prefix of ``chain`` is an
   ideal, so prefix-progress resume/recovery stays well-defined on
   DAGs.
3. Cost semantics are the *concurrent* formulation: no inter-op
   transition costs; singleton advances are priced from the dense solo
   arrays, co-scheduled antichain steps via the contention model's
   group law.  Execution-side synchronization derives from the same
   ``preds`` sets (cross-lane events only at true dependency edges).
4. ``preds`` participates in :meth:`signature` **only when non-linear**,
   so chain workload signatures (and every existing plan-cache key)
   are unchanged.
5. Row-reordering views (``tail``, ``select``) drop ``preds`` — their
   rows no longer index the same DAG positions; row-preserving views
   (``under_condition``, ``spliced``) carry it through unchanged.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, Mapping, Sequence

import numpy as np

from .costmodel import CostTable, DenseCostTable, PUSpec


def _as_pu_specs(pus: Mapping[str, PUSpec]) -> dict[str, PUSpec]:
    """Normalize a PU-axis mapping: values may be ``PUSpec``s or execution
    :class:`~repro_torch.core.targets.Target`\\ s (anything with ``pu_spec()``),
    so target-backed lanes plug into every solver unchanged."""
    out: dict[str, PUSpec] = {}
    for name, spec in dict(pus).items():
        if not isinstance(spec, PUSpec) and hasattr(spec, "pu_spec"):
            spec = spec.pu_spec()
        out[name] = spec
    return out


class Workload:
    """One request: an op chain bound to its dense cost views."""

    def __init__(self, chain: Sequence[int], dense: DenseCostTable,
                 pus: Mapping[str, PUSpec], ops: Sequence | None = None,
                 table: CostTable | None = None,
                 preds: Sequence[Sequence[int]] | None = None):
        self.chain = list(chain)
        self.dense = dense
        self.pus = pus = _as_pu_specs(pus)
        self.ops = ops                  # optional FusedOp list (names in errors)
        # Optional DAG structure: preds[i] = sorted tuple of predecessor
        # *positions* (indices into ``chain``), each < i (topological
        # order).  None means the linear chain preds[i] == (i-1,).
        self.preds = (None if preds is None
                      else tuple(tuple(sorted(int(q) for q in ps))
                                 for ps in preds))
        if self.preds is not None:
            if len(self.preds) != len(self.chain):
                raise ValueError(
                    f"preds length {len(self.preds)} != chain length "
                    f"{len(self.chain)}")
            for i, ps in enumerate(self.preds):
                if any(not 0 <= q < i for q in ps):
                    raise ValueError(
                        f"preds[{i}]={ps} is not topologically ordered "
                        "(every predecessor position must be < its node)")
        # The scalar source table is kept ONLY as the oracle handle for the
        # ``*_reference`` fallbacks (custom contention models); no Workload
        # method iterates it.
        self.table = table
        self.pu_names = dense.pus
        self._col = {p: j for j, p in enumerate(self.pu_names)}
        # (K,) transition-energy scale: transitions consume time on the
        # interconnect/host, charged at the destination PU's memory-bound
        # power in energy mode (same rule as graph.build_sequential_graph).
        self.power_memory = np.array(
            [pus[p].power_memory for p in self.pu_names])
        self._signature: str | None = None
        self._succs: tuple[tuple[int, ...], ...] | None = None

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, chain: Sequence[int], table: CostTable,
              pus: Mapping[str, PUSpec], ops: Sequence | None = None,
              preds: Sequence[Sequence[int]] | None = None
              ) -> "Workload":
        """Ingest a scalar ``CostTable`` into a dense Workload (the single
        sanctioned dict pass).

        Malformed inputs raise descriptive ``ValueError``s here, at the
        front door, instead of surfacing as bare ``KeyError``/``IndexError``
        deep inside the dense views: empty chains, chain ops with no cost
        entry on any PU (unprofiled), and cost-table PU names the
        ``PUSpec`` mapping doesn't know.
        """
        chain = list(chain)
        pus = _as_pu_specs(pus)
        if not chain:
            raise ValueError(
                "Workload.build: empty op chain — nothing to schedule")
        if table is None:
            raise ValueError(
                "Workload.build: no CostTable (table=None); profile the "
                "graph first, or pass a prebuilt workload to the solver")
        unknown = [p for p in table.pus if p not in pus]
        if unknown:
            raise ValueError(
                f"Workload.build: cost table uses unknown PU name(s) "
                f"{unknown}; the PUSpec mapping only defines "
                f"{sorted(pus)}")
        missing = [oi for oi in dict.fromkeys(chain)
                   if not table.supported_pus(oi)]
        if missing:
            def _nm(oi: int) -> str:
                if ops is not None and 0 <= oi < len(ops):
                    return f"op {oi} ({ops[oi].name})"
                return f"op {oi}"
            shown = ", ".join(_nm(oi) for oi in missing[:5])
            more = f" (+{len(missing) - 5} more)" if len(missing) > 5 else ""
            raise ValueError(
                f"Workload.build: {len(missing)} chain op(s) missing from "
                f"the cost table on every PU: {shown}{more} — were they "
                "profiled?")
        dense = DenseCostTable.from_chain(chain, table, pus)
        return cls(chain, dense, pus, ops=ops, table=table, preds=preds)

    @classmethod
    def from_graph(cls, graph, table: CostTable,
                   pus: Mapping[str, PUSpec]) -> "Workload":
        """Build a DAG workload from an :class:`~repro_torch.core.op.OpGraph`:
        rows follow ``graph.topo_order()`` and ``preds`` holds the graph's
        predecessor sets mapped to topological positions."""
        order = graph.topo_order()
        pos_of = {oi: i for i, oi in enumerate(order)}
        preds = [tuple(sorted(pos_of[q] for q in graph.pred[oi]))
                 for oi in order]
        return cls.build(order, table, pus, ops=graph.ops, preds=preds)

    def signature(self) -> str:
        """Content hash of the dense views (chain, PU set, all cost
        arrays).  Two workloads with equal signatures are interchangeable
        for every dense solver — the orchestrator keys its plan cache on
        this, so an identically-profiled graph reuses cached *schedules*
        (the orchestrator re-binds the plan's handles to the caller's,
        since op payloads may differ behind equal cost tables)."""
        if self._signature is None:
            h = hashlib.blake2b(digest_size=16)
            d = self.dense
            h.update(repr((tuple(self.chain), tuple(d.pus))).encode())
            for a in (d.mask, d.w, d.power, d.h2d, d.d2h, d.dispatch, d.acc):
                h.update(np.ascontiguousarray(a).tobytes())
            # DAG structure changes the schedule space, so it must change
            # the signature — but ONLY when non-linear, keeping every
            # existing chain-workload signature (and plan-cache key) stable.
            if not self.is_linear:
                h.update(b"dag")
                h.update(repr(self.preds).encode())
            self._signature = h.hexdigest()
        return self._signature

    # -- basic queries -------------------------------------------------------
    @property
    def n(self) -> int:
        return self.dense.n

    @property
    def k(self) -> int:
        return self.dense.k

    def col(self, pu: str) -> int:
        return self._col[pu]

    def cols(self, assignment: Sequence[str]) -> np.ndarray:
        """(len(assignment),) column index per assigned PU name."""
        return np.fromiter((self._col[p] for p in assignment),
                           dtype=np.int64, count=len(assignment))

    def op_name(self, pos: int) -> str:
        oi = self.chain[pos]
        if self.ops is not None and 0 <= oi < len(self.ops):
            return f"op {oi} ({self.ops[oi].name})"
        return f"op {oi}"

    # -- DAG structure -------------------------------------------------------
    @property
    def is_linear(self) -> bool:
        """True when the dependency structure is the plain chain
        ``0 -> 1 -> ... -> n-1`` (including ``preds=None``)."""
        if self.preds is None:
            return True
        return all(ps == (() if i == 0 else (i - 1,))
                   for i, ps in enumerate(self.preds))

    def pred_positions(self, pos: int) -> tuple[int, ...]:
        """Predecessor positions of ``pos`` (chain semantics if no DAG)."""
        if self.preds is None:
            return () if pos == 0 else (pos - 1,)
        return self.preds[pos]

    @property
    def succs(self) -> tuple[tuple[int, ...], ...]:
        """Successor positions per position (derived from ``preds``)."""
        if self._succs is None:
            out: list[list[int]] = [[] for _ in range(self.n)]
            for i in range(self.n):
                for q in self.pred_positions(i):
                    out[q].append(i)
            self._succs = tuple(tuple(s) for s in out)
        return self._succs

    # -- derived views -------------------------------------------------------
    def _derive(self, dense: DenseCostTable,
                preds: tuple[tuple[int, ...], ...] | None = None
                ) -> "Workload":
        wl = Workload.__new__(Workload)
        wl.chain = list(dense.chain)
        wl.dense = dense
        wl.pus = self.pus
        wl.ops = self.ops
        # a derived view's rows no longer correspond to the source dict
        # (sliced / re-indexed / condition-scaled), so it carries NO
        # oracle handle — consumers needing the scalar fallback must be
        # given a Workload built directly from a table
        wl.table = None
        wl.pu_names = dense.pus
        wl._col = self._col
        wl.power_memory = self.power_memory
        wl._signature = None
        # row-preserving views pass the DAG structure through explicitly;
        # row-reordering views (tail/select) leave it behind
        wl.preds = preds
        wl._succs = None
        return wl

    def tail(self, pos: int) -> "Workload":
        """Workload over ``chain[pos:]`` — row *views*, no copies."""
        d = self.dense
        sub = DenseCostTable(d.pus, d.chain[pos:], d.mask[pos:], d.w[pos:],
                             d.power[pos:], d.h2d[pos:], d.d2h[pos:], d.acc,
                             dispatch=d.dispatch[pos:])
        return self._derive(sub)

    def select(self, sub_chain: Sequence[int]) -> "Workload":
        """Workload over an arbitrary op subset (e.g. one parallel branch).

        Rows are fancy-indexed from this workload's dense arrays — the
        scalar table is not consulted.  Each op index in ``sub_chain``
        must appear in ``self.chain``.
        """
        pos_of: dict[int, int] = {}
        for i, oi in enumerate(self.chain):
            pos_of.setdefault(oi, i)
        rows = np.fromiter((pos_of[oi] for oi in sub_chain), dtype=np.int64,
                           count=len(sub_chain))
        d = self.dense
        sub = DenseCostTable(d.pus, list(sub_chain), d.mask[rows], d.w[rows],
                             d.power[rows], d.h2d[rows], d.d2h[rows], d.acc,
                             dispatch=d.dispatch[rows])
        return self._derive(sub)

    def under_condition(self, slowdown: Mapping[str, float] | None = None,
                        unavailable: Iterable[str] = ()) -> "Workload":
        """Workload under a runtime condition: per-PU *column* scalings.

        ``slowdown[pu] = f`` multiplies the kernel share of every op on
        that PU (dispatch, H2D/D2H, and power are monitoring-invariant);
        ``unavailable`` PUs are masked out entirely (the paper's
        compile-failure semantics applied at runtime).  O(N*K) array work
        — the dict-table rebuild of the old ``dynamic.adjusted_table`` is
        retired from this path.
        """
        d = self.dense
        w = d.w.copy()
        mask = d.mask.copy()
        for pu, f in (slowdown or {}).items():
            j = self._col.get(pu)
            if j is None:
                continue
            col = mask[:, j]
            w[col, j] = d.dispatch[col, j] + (d.w[col, j]
                                              - d.dispatch[col, j]) * float(f)
        for pu in unavailable:
            j = self._col.get(pu)
            if j is None:
                continue
            mask[:, j] = False
            w[:, j] = np.inf
        sub = DenseCostTable(d.pus, d.chain, mask, w, d.power, d.h2d, d.d2h,
                             d.acc, dispatch=d.dispatch)
        return self._derive(sub, preds=self.preds)

    def spliced(self, other: "Workload", pos: int) -> "Workload":
        """Rows ``[:pos]`` from this workload, rows ``[pos:]`` from
        ``other`` (same chain/PUs).  Used by the dynamic scheduler to
        price a stitched plan: the already-executed prefix at the nominal
        profile, the re-planned tail under the current condition."""
        d0, d1 = self.dense, other.dense
        sub = DenseCostTable(
            d0.pus, d0.chain,
            np.concatenate([d0.mask[:pos], d1.mask[pos:]]),
            np.concatenate([d0.w[:pos], d1.w[pos:]]),
            np.concatenate([d0.power[:pos], d1.power[pos:]]),
            np.concatenate([d0.h2d[:pos], d1.h2d[pos:]]),
            np.concatenate([d0.d2h[:pos], d1.d2h[pos:]]),
            d0.acc,
            dispatch=np.concatenate([d0.dispatch[:pos], d1.dispatch[pos:]]))
        return self._derive(sub, preds=self.preds)

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, assignment: Sequence[str],
                 allow_infeasible: bool = False) -> tuple[float, float]:
        """(latency, energy) of a fixed assignment, including boundary
        H2D/D2H and inter-op transition costs — the dense equivalent of
        the scalar ``evaluate_sequential`` walk.

        Unsupported (op, PU) cells raise ``KeyError`` (matching the
        scalar ``CostTable.require``) unless ``allow_infeasible``, which
        returns ``(inf, inf)`` instead.
        """
        d = self.dense
        n = d.n
        if len(assignment) != n:
            raise ValueError(
                f"assignment length {len(assignment)} != chain length {n}")
        c = self.cols(assignment)
        rows = np.arange(n)
        sup = d.mask[rows, c]
        if not sup.all():
            if allow_infeasible:
                return float("inf"), float("inf")
            bad = int(np.argmin(sup))
            raise KeyError(
                f"{self.op_name(bad)} unsupported on {assignment[bad]}")
        w = d.w[rows, c]
        pw = d.power[rows, c]
        h2d = d.h2d[rows, c]
        d2h = d.d2h[rows, c]
        accv = d.acc[c]
        pmv = self.power_memory[c]
        if n > 1:
            same = c[1:] == c[:-1]
            tc = np.where(same, 0.0,
                          np.where(accv[1:], h2d[1:], 0.0)
                          + np.where(accv[:-1], d2h[:-1], 0.0))
            tc_lat = float(np.sum(tc))
            tc_eng = float(np.sum(tc * pmv[1:]))
        else:
            tc_lat = tc_eng = 0.0
        lat = float(h2d[0]) + float(np.sum(w)) + tc_lat + float(d2h[-1])
        eng = (float(h2d[0]) * float(pmv[0]) + float(np.sum(w * pw))
               + tc_eng + float(d2h[-1]) * float(pmv[-1]))
        return lat, eng

    def single_pu(self, pu: str) -> tuple[float, float] | None:
        """(latency, energy) of monolithic execution on ``pu``; ``None``
        if any op is unsupported there (the compile-failure case)."""
        j = self._col[pu]
        d = self.dense
        if not d.mask[:, j].all():
            return None
        w = d.w[:, j]
        pm = float(self.power_memory[j])
        lat = float(d.h2d[0, j]) + float(np.sum(w)) + float(d.d2h[-1, j])
        eng = (float(d.h2d[0, j]) * pm + float(np.sum(w * d.power[:, j]))
               + float(d.d2h[-1, j]) * pm)
        return lat, eng

    def best_solo(self, objective: str = "latency"
                  ) -> tuple[str, float, dict[str, float | None]]:
        """(best PU, value, per-PU dict) of monolithic execution."""
        idx = 0 if objective == "latency" else 1
        vals: dict[str, float | None] = {}
        for pu in self.pu_names:
            c = self.single_pu(pu)
            vals[pu] = None if c is None else c[idx]
        feas = {p: v for p, v in vals.items() if v is not None}
        if not feas:
            raise ValueError(
                f"no single PU supports every op of the chain "
                f"(len={self.n})")
        b = min(feas, key=feas.get)
        return b, feas[b], vals

    def require_feasible(self) -> None:
        """Raise if any chain position is unsupported on every PU."""
        ok = self.dense.mask.any(axis=1)
        if not ok.all():
            bad = int(np.argmin(ok))
            raise ValueError(f"{self.op_name(bad)} unsupported on all PUs")
