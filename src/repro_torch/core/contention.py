"""Cross-PU contention models (paper §3.2.2, "Memory contention modeling").

A NumPy copy of ``repro.core.contention``: the co-execution laws and their
batched caches, with the reference's summation order kept term for term so
every table is bitwise equal to the reference's.

In the port the PU axis is keyed by lane name (``numpy-eager``,
``torch-cpu``, ``cuda:0``, ``cuda-kernels``), which ``DEFAULT_MM_SF`` does
not name: any two different lanes co-execute at factor 1.0, so the two
CUDA lanes of one card are priced as free overlap.  The laws stay as they
are so that plans stay bitwise equal to the reference's; a contention
table for lanes that share one card is open work (``ROADMAP.md``).

Two empirically grounded models:

* **Intra-model parallel** — when branches co-execute on different PUs, each
  operator's cost is scaled by a measured slowdown factor
  ``SF(P_run, P_interfere)``.  The paper's measurements: the NPU is most
  sensitive (1.17x with CPU active, 1.09x with GPU active); CPU and GPU show
  negligible interference.

* **Multi-model concurrent** — co-scheduled operators from different models
  on the *same* PU are profiled under barrier-synchronised simultaneous
  execution.  The default derived model serialises same-PU co-execution
  (each op's measured concurrent latency ~= sum of solo latencies, which is
  what time-sharing a single command queue yields) and applies a
  memory-bandwidth contention factor across PUs.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Sequence

import numpy as np

from .costmodel import DEFAULT_SF, DenseCostTable

# Multi-model cross-PU memory-bandwidth contention (two active PUs hammering
# the shared DRAM).  Slightly stronger than the intra-model SF because whole
# models (not single branches) co-execute.
DEFAULT_MM_SF: dict[tuple[str, str], float] = {
    ("NPU", "CPU"): 1.22, ("NPU", "GPU"): 1.15,
    ("CPU", "NPU"): 1.04, ("CPU", "GPU"): 1.08,
    ("GPU", "NPU"): 1.04, ("GPU", "CPU"): 1.08,
    ("CPU", "CPU"): 1.0, ("GPU", "GPU"): 1.0, ("NPU", "NPU"): 1.0,
}


@dataclasses.dataclass
class ContentionModel:
    """SF tables + derived co-execution costs."""

    sf: Mapping[tuple[str, str], float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_SF))
    mm_sf: Mapping[tuple[str, str], float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_MM_SF))

    def slowdown(self, run: str, interfere: str) -> float:
        return self.sf.get((run, interfere), 1.0)

    def branch_factor(self, run_pu: str, other_pus: set[str]) -> float:
        """Paper §3.3.2: max over PUs used by other concurrent branches."""
        if not other_pus:
            return 1.0
        return max(self.slowdown(run_pu, p) for p in other_pus)

    # -- multi-model co-execution -------------------------------------------
    def co_exec(self, t_a: float, pu_a: str, t_b: float, pu_b: str
                ) -> tuple[float, float]:
        """Concurrent latencies of two ops from different models.

        Same PU: the command queue serialises them -> each op's measured
        wall-clock concurrent latency is the pair's makespan.  Different
        PUs: each solo latency inflated by memory-bandwidth contention.
        """
        if pu_a == pu_b:
            s = t_a + t_b
            return s, s
        return (t_a * self.mm_sf.get((pu_a, pu_b), 1.0),
                t_b * self.mm_sf.get((pu_b, pu_a), 1.0))

    def pair_step_cost(self, t_a: float, pu_a: str, t_b: float, pu_b: str) -> float:
        """Aligned-mode step cost (paper §3.2.2): same-PU uses the average of
        measured concurrent times; cross-PU uses the max of (contention-
        adjusted) solo times."""
        cc_a, cc_b = self.co_exec(t_a, pu_a, t_b, pu_b)
        if pu_a == pu_b:
            return 0.5 * (cc_a + cc_b)
        return max(cc_a, cc_b)

    # -- M-ary co-execution (generalizes the pair laws above) ---------------
    def _group_factors(self, pus_: Sequence[str]) -> dict[str, float]:
        """Per-active-PU bandwidth-contention factor: max SF against the
        *other* distinct PUs active in the step (1.0 when alone)."""
        active = set(pus_)
        return {q: max((self.mm_sf.get((q, p), 1.0)
                        for p in active if p != q), default=1.0)
                for q in active}

    def group_step_cost(self, ts: Sequence[float],
                        pus_: Sequence[str]) -> float:
        """Makespan of M co-scheduled ops (one per request).

        Ops sharing a PU serialise on its command queue (queue time = sum
        of solo times); each queue is inflated by the memory-bandwidth
        contention factor against the other active PUs; the step cost is
        the slowest queue.  For M = 2 this reduces exactly to
        ``pair_step_cost``: same-PU -> ``t_a + t_b``, cross-PU ->
        ``max(t_a*SF(a,b), t_b*SF(b,a))``.
        """
        f = self._group_factors(pus_)
        cost = 0.0
        for q, fq in f.items():
            tq = sum(t for t, p in zip(ts, pus_) if p == q)
            cost = max(cost, tq * fq)
        return cost

    def group_energy(self, ts: Sequence[float], powers: Sequence[float],
                     pus_: Sequence[str]) -> float:
        """Energy of M co-scheduled ops: each op runs for its concurrent
        duration at its PU's power.  Time-shared same-PU execution draws
        the PU's power once, so each op is charged its solo share scaled
        only by the cross-PU contention factor — for M = 2 this is the
        pair energy law bit-for-bit (same-PU ``t_a*p_a + t_b*p_b``,
        cross-PU ``cc_a*p_a + cc_b*p_b``)."""
        f = self._group_factors(pus_)
        return sum(t * f[p] * pw for t, p, pw in zip(ts, pus_, powers))

    # -- batched M-ary laws (one fixed PU combo, many op tuples) ------------
    def group_step_cost_batch(self, ts: np.ndarray,
                              pus_: Sequence[str]) -> np.ndarray:
        """Vectorized :meth:`group_step_cost`: ``ts`` is ``(..., M)`` solo
        times of M co-scheduled ops and ``pus_`` their (single, shared
        across the batch) PU assignment.  Returns the ``(...,)`` makespans,
        bit-for-bit equal to the scalar law applied per tuple: per-PU
        queue sums accumulate in op-position order and the per-queue
        factor/max algebra is order-exact."""
        f = self._group_factors(pus_)
        cost: np.ndarray | None = None
        for q in dict.fromkeys(pus_):           # distinct PUs, first-seen order
            tq: np.ndarray | None = None
            for i, p in enumerate(pus_):
                if p == q:
                    tq = ts[..., i] if tq is None else tq + ts[..., i]
            vq = tq * f[q]
            cost = vq if cost is None else np.maximum(cost, vq)
        return cost

    def group_energy_batch(self, ts: np.ndarray, powers: np.ndarray,
                           pus_: Sequence[str]) -> np.ndarray:
        """Vectorized :meth:`group_energy` over ``(..., M)`` solo times and
        powers for one fixed PU combo — same term grouping and summation
        order as the scalar law, so results match element-for-element."""
        f = self._group_factors(pus_)
        out: np.ndarray | None = None
        for i, p in enumerate(pus_):
            term = (ts[..., i] * f[p]) * powers[..., i]
            out = term if out is None else out + term
        return out

    def min_factor(self) -> float:
        """Smallest factor any co-executed op's solo time can be scaled by.

        Used to keep the A* lower-bound heuristic admissible even for
        custom ``mm_sf`` tables with entries < 1 (same-PU co-execution
        always costs at least each op's solo time, cross-PU costs at
        least ``solo * mm_sf``)."""
        return min(1.0, *self.mm_sf.values()) if self.mm_sf else 1.0


def uses_default_coexec(cm: ContentionModel) -> bool:
    """True iff ``cm`` inherits the base co-execution cost laws, so the
    vectorized pair-cost matrices below reproduce its behaviour exactly.
    Subclasses overriding ``co_exec``/``pair_step_cost`` fall back to the
    scalar reference solvers."""
    return (type(cm).co_exec is ContentionModel.co_exec
            and type(cm).pair_step_cost is ContentionModel.pair_step_cost)


def uses_default_group(cm: ContentionModel) -> bool:
    """True iff ``cm`` inherits the base M-ary group laws AND the pair
    laws they generalize.  The M-dimensional grid search prices group
    advances with ``group_step_cost``/``group_energy`` (the vectorized
    sweep through their ``*_batch`` forms); a model that overrides any of
    the family would be priced inconsistently, so such models route to
    the pairwise-merge fallback (which honours custom pair laws through
    the reference solvers)."""
    return (uses_default_coexec(cm)
            and type(cm).group_step_cost is ContentionModel.group_step_cost
            and type(cm).group_energy is ContentionModel.group_energy
            and type(cm).group_step_cost_batch
            is ContentionModel.group_step_cost_batch
            and type(cm).group_energy_batch
            is ContentionModel.group_energy_batch
            and type(cm)._group_factors is ContentionModel._group_factors)


class GroupCostCache:
    """Batched group-edge tables per *signature tuple* for one ordered
    subset of >= 2 co-advancing requests — the M-ary generalization of
    :class:`PairCostCache`.

    A group co-advance's cost/energy over all PU combos depends only on
    the advancing ops' per-PU (w, power, support) signatures
    (``DenseCostTable.sig``), so one batched reduction per signature
    tuple serves every grid state that advances this subset.  For each of
    the ``prod(n_sig_r)`` signature tuples the cache stores the best PU
    combo under BOTH objectives (one enumeration pass, memoized — a
    shared cache serves a latency solve and an energy solve of the same
    workload tuple, like ``PairCostCache.edge_tables``).

    Semantics replicate the scalar per-state enumeration of the heap grid
    A* bit-for-bit: PU combos are scanned in the same row-major
    (``itertools.product``) order with strict first-minimum updates, the
    costs come from :meth:`ContentionModel.group_step_cost_batch` /
    :meth:`~ContentionModel.group_energy_batch` (order-exact vectorized
    forms of the scalar laws), and unsupported slots are ``inf`` in both
    keys so they can never win the argmin.
    """

    def __init__(self, cm: ContentionModel, denses: Sequence[DenseCostTable]):
        if len(denses) < 2:
            raise ValueError(
                f"GroupCostCache is for group advances of >= 2 requests, "
                f"got {len(denses)}; singleton advances price from the "
                "dense solo-edge arrays")
        self.cm = cm
        self.denses = list(denses)
        self.ks = [d.k for d in self.denses]
        self.shape = tuple(d.n_sig for d in self.denses)
        self._memo: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]] = {}

    def nbytes(self) -> int:
        """Bytes held by the built edge tables (0 until ``edge_tables``
        first runs — ``ConcurrentCaches.trim`` budgets on this)."""
        return sum(a.nbytes for arrs in self._memo.values() for a in arrs)

    def edge_tables(self, objective: str
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
        """``(key, step_cost, energy, flat PU-combo argmin)`` per signature
        tuple, each of shape ``(n_sig_1, ..., n_sig_g)``.  The argmin is
        row-major over ``(K_1, ..., K_g)`` (decode with divmod), matching
        the scalar enumeration's first-minimum tie-break."""
        if objective not in self._memo:
            self._build()
        return self._memo[objective]

    # tuples per build chunk: each chunk gathers g per-request (C, K)
    # w/power/mask blocks once and then serves every PU combo from cheap
    # column views, bounding the gather scratch to a few tens of MB even
    # at the rolling route's signature-alphabet cap
    _CHUNK_TUPLES = 262_144

    def _build(self) -> None:
        g = len(self.denses)
        rows = [d.sig_row for d in self.denses]
        tsig = [d.w[r] for d, r in zip(self.denses, rows)]       # (S_r, K_r)
        psig = [d.power[r] for d, r in zip(self.denses, rows)]
        msig = [d.mask[r] for d, r in zip(self.denses, rows)]
        grid = np.indices(self.shape).reshape(g, -1)             # (g, n_tup)
        n_tup = grid.shape[1]
        pu_lists = [d.pus for d in self.denses]
        combos = list(itertools.product(*[range(k) for k in self.ks]))
        out = {obj: (np.full(n_tup, np.inf), np.empty(n_tup),
                     np.empty(n_tup), np.zeros(n_tup, dtype=np.int64))
               for obj in ("latency", "energy")}
        for lo in range(0, n_tup, self._CHUNK_TUPLES):
            hi = min(lo + self._CHUNK_TUPLES, n_tup)
            # one gather per (request, kind) per chunk — combo-independent
            gat = [(tsig[i][grid[i, lo:hi]], psig[i][grid[i, lo:hi]],
                    msig[i][grid[i, lo:hi]]) for i in range(g)]
            ts = np.empty((hi - lo, g))
            pws = np.empty((hi - lo, g))
            for ci, combo in enumerate(combos):
                pnames = [pu_lists[i][j] for i, j in enumerate(combo)]
                valid: np.ndarray | None = None
                for i, j in enumerate(combo):
                    ts[:, i] = gat[i][0][:, j]
                    pws[:, i] = gat[i][1][:, j]
                    vi = gat[i][2][:, j]
                    valid = vi if valid is None else valid & vi
                with np.errstate(invalid="ignore"):  # inf*0 at unsupported
                    cost = self.cm.group_step_cost_batch(ts, pnames)
                    eng = self.cm.group_energy_batch(ts, pws, pnames)
                cost = np.where(valid, cost, np.inf)
                eng = np.where(valid, eng, np.inf)
                for obj, key in (("latency", cost), ("energy", eng)):
                    pk, ps, pe, pa = out[obj]
                    pkc = pk[lo:hi]
                    imp = key < pkc
                    if imp.any():
                        pkc[imp] = key[imp]
                        ps[lo:hi][imp] = cost[imp]
                        pe[lo:hi][imp] = eng[imp]
                        pa[lo:hi][imp] = ci
        self._memo.update(
            {obj: tuple(a.reshape(self.shape) for a in arrs)
             for obj, arrs in out.items()})


class PairCostCache:
    """Batched ``(K0, K1)`` pair-cost / pair-energy matrices per signature.

    For two co-scheduled ops (one per model) the step cost and energy over
    all PU pairs depend only on the ops' per-PU (w, power, support)
    vectors — their *signatures* (``DenseCostTable.sig``).  The model zoo
    repeats layer shapes heavily, so reducing once per signature pair
    turns the per-state K0*K1 Python loop of the reference solvers into a
    single batched NumPy evaluation shared across thousands of (i, j)
    states.

    Matrix semantics replicate ``ContentionModel`` bit-for-bit:

    * cost:   same PU -> ``t0 + t1`` (serialised queue); cross-PU ->
      ``max(t0*SF(a,b), t1*SF(b,a))``.
    * energy: same PU -> ``t0*p0 + t1*p1``; cross-PU ->
      ``cc0*p0 + cc1*p1``.

    Unsupported slots are ``inf`` in both, so flat ``argmin`` picks the
    same first-minimum the scalar ``for d0 ... for d1`` loops pick.
    """

    # peak elements per 4-D temporary in edge_tables (~16 MB of float64):
    # measured/profiled tables can have near-unique per-op signatures, so
    # the (S0, S1, K0, K1) block is built in row chunks to bound memory.
    _CHUNK_ELEMS = 2_000_000

    def __init__(self, cm: ContentionModel, dense0: DenseCostTable,
                 dense1: DenseCostTable):
        self.cm = cm
        self.d0 = dense0
        self.d1 = dense1
        p0, p1 = dense0.pus, dense1.pus
        self.sf_a = np.array([[cm.mm_sf.get((a, b), 1.0) for b in p1]
                              for a in p0])
        self.sf_b = np.array([[cm.mm_sf.get((b, a), 1.0) for b in p1]
                              for a in p0])
        self.same = np.array([[a == b for b in p1] for a in p0])
        self._memo: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]] = {}

    def nbytes(self) -> int:
        """Bytes held by the built signature-pair matrices (0 until
        ``edge_tables`` first runs — ``ConcurrentCaches.trim`` budgets
        on this)."""
        return sum(a.nbytes for arrs in self._memo.values() for a in arrs)

    def edge_tables(self, objective: str
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Co-advance edges for *all* signature pairs, reduced in batches.

        Every PU pair of a co-advance leads to the same successor state,
        so the search only needs the minimum-key pair per signature pair;
        its latency / energy / identity are kept for reconstruction.
        Returns ``(key, step_cost, energy, flat_argmin)``, each
        ``(n_sig0, n_sig1)``.  The flat row-major argmin reproduces the
        scalar solvers' first-minimum ``for d0 ... for d1`` tie-break.

        The 4-D cost/energy reductions are objective-independent, so the
        first call builds **both** objectives' tables in one chunked pass
        and memoizes them — a shared cache threaded through a pair's
        latency- and energy-objective solves pays the 4-D setup once.
        """
        if objective not in self._memo:
            self._build()
        return self._memo[objective]

    def _build(self) -> None:
        r0, r1 = self.d0.sig_row, self.d1.sig_row
        t0s, p0s, m0s = self.d0.w[r0], self.d0.power[r0], self.d0.mask[r0]
        t1, p1, m1 = self.d1.w[r1], self.d1.power[r1], self.d1.mask[r1]
        s0, s1 = len(r0), len(r1)
        k0, k1 = t0s.shape[1], t1.shape[1]
        out = {obj: tuple(np.empty((s0, s1)) for _ in range(3))
               + (np.empty((s0, s1), dtype=np.int64),)
               for obj in ("latency", "energy")}
        a1 = t1[None, :, None, :]        # (1, S1, 1, K1)
        with np.errstate(invalid="ignore"):  # inf * 0 at unsupported slots
            e1 = a1 * p1[None, :, None, :]
        bad1 = ~m1[None, :, None, :]
        same = self.same[None, None, :, :]
        chunk = max(1, self._CHUNK_ELEMS // max(1, s1 * k0 * k1))
        for lo in range(0, s0, chunk):
            hi = min(lo + chunk, s0)
            a0 = t0s[lo:hi, None, :, None]       # (C, 1, K0, 1)
            with np.errstate(invalid="ignore"):  # inf * 0 at unsupported
                cc0 = a0 * self.sf_a[None, None, :, :]
                cc1 = a1 * self.sf_b[None, None, :, :]
                cost = np.maximum(cc0, cc1)
                energy = (cc0 * p0s[lo:hi, None, :, None]
                          + cc1 * p1[None, :, None, :])
                cost = np.where(same, a0 + a1, cost)
                energy = np.where(
                    same, a0 * p0s[lo:hi, None, :, None] + e1, energy)
            bad = ~m0s[lo:hi, None, :, None] | bad1
            cost[bad] = np.inf
            energy[bad] = np.inf
            cost = cost.reshape(hi - lo, s1, k0 * k1)
            energy = energy.reshape(hi - lo, s1, k0 * k1)
            for obj in ("latency", "energy"):
                key = cost if obj == "latency" else energy
                pk, ps, pe, pa = out[obj]
                arg = key.argmin(axis=2)
                sel = arg[:, :, None]
                pa[lo:hi] = arg
                pk[lo:hi] = np.take_along_axis(key, sel, axis=2)[:, :, 0]
                ps[lo:hi] = np.take_along_axis(cost, sel, axis=2)[:, :, 0]
                pe[lo:hi] = np.take_along_axis(energy, sel, axis=2)[:, :, 0]
        self._memo.update(out)
