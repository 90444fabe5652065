"""Parity of the port's per-target health monitor and circuit breaker
with the JAX reference.

``core/health.py`` is pure Python in both packages: one event sequence
(``observe`` / ``record_failure`` / ``record_loss`` / ``due_probes`` /
``probe_result``), drawn from a seeded ``np.random.default_rng`` on a
serving clock, fed to both monitors must leave the same transitions,
``stats()``, drift EWMAs and ``condition()`` after every event.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as P

LANES = ("numpy-eager", "torch-cpu", "cuda:0", "cuda-kernels")

POLICIES = [
    dict(),
    dict(failure_threshold=1, cooldown=0.002, calibration=3,
         rescale_threshold=2.0),
    dict(failure_threshold=3, cooldown=0.01, cooldown_backoff=1.0,
         ewma_alpha=0.6, calibration=2, rescale_threshold=1.5,
         rescale_hysteresis=0.9, rescale_min_change=1.05),
]


def _events(seed, n=400):
    """A serving-clock script over the four lanes: mostly observations
    (with a lane that drifts part-way), some failures, a few losses and
    probe outcomes."""
    rng = np.random.default_rng(seed)
    now, out = 0.0, []
    drift_from = {lane: int(rng.integers(50, 300)) for lane in LANES}
    for k in range(n):
        now += float(rng.exponential(5e-3))
        lane = LANES[int(rng.integers(len(LANES)))]
        u = rng.random()
        if u < 0.70:
            pred = float(rng.uniform(1e-4, 2e-3))
            slow = 6.0 if k >= drift_from[lane] else 1.0
            meas = pred * float(rng.uniform(40.0, 60.0)) * slow
            out.append(("observe", lane, pred, meas, now))
        elif u < 0.82:
            out.append(("record_failure", lane, now,
                        ["timeout", "retry_exceeded"][int(rng.integers(2))]))
        elif u < 0.86:
            out.append(("record_loss", lane, now))
        elif u < 0.96:
            out.append(("due_probes", now))
        else:
            out.append(("probe_result", lane, bool(rng.random() < 0.6), now))
    return out


def _apply(mon, ev):
    name, *args = ev
    if name == "observe":
        lane, pred, meas, now = args
        return mon.observe(lane, pred, meas, now)
    if name == "record_failure":
        lane, now, reason = args
        return mon.record_failure(lane, now, reason)
    if name == "record_loss":
        return mon.record_loss(*args)
    if name == "due_probes":
        return mon.due_probes(*args)
    lane, ok, now = args
    return mon.probe_result(lane, ok=ok, now=now)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_event_sequence_gives_the_same_breakers(seed, policy):
    pm = P.HealthMonitor(P.HealthPolicy(**policy))
    jm = J.HealthMonitor(J.HealthPolicy(**policy))
    base = [(P.RuntimeCondition(), J.RuntimeCondition()),
            (P.RuntimeCondition(slowdown={"cuda:0": 2.0},
                                unavailable=frozenset({"torch-cpu"})),
             J.RuntimeCondition(slowdown={"cuda:0": 2.0},
                                unavailable=frozenset({"torch-cpu"})))]
    for ev in _events(seed):
        assert _apply(pm, ev) == _apply(jm, ev), ev
        assert pm.dirty() == jm.dirty(), ev
        for pb, jb in base:
            pc, jc = pm.condition(pb), jm.condition(jb)
            assert pc.key(LANES) == jc.key(LANES), ev
        assert pm.quarantined() == jm.quarantined()
        assert pm.half_open() == jm.half_open()
    assert pm.stats() == jm.stats()
    assert [t.to_dict() for t in pm.transitions] == \
        [t.to_dict() for t in jm.transitions]
    for lane in LANES:
        p, j = pm.health(lane), jm.health(lane)
        assert vars(p) == vars(j)
        assert (p.drift() is None) == (j.drift() is None)
        if p.drift() is not None:
            assert p.drift().hex() == j.drift().hex()
    st = pm.stats()
    # the script exercises every transition kind
    tos = {(t["frm"], t["to"]) for t in st["transitions"]}
    assert ("closed", "open") in tos and ("open", "half_open") in tos
    assert ("half_open", "closed") in tos or ("half_open", "open") in tos


@pytest.mark.parametrize("bad", [
    dict(failure_threshold=0), dict(ewma_alpha=0.0), dict(ewma_alpha=1.5),
    dict(rescale_threshold=1.0), dict(cooldown=-1.0),
    dict(cooldown=5.0, max_cooldown=1.0)])
def test_policy_checks_match(bad):
    with pytest.raises(ValueError) as pe:
        P.HealthPolicy(**bad)
    with pytest.raises(ValueError) as je:
        J.HealthPolicy(**bad)
    assert str(pe.value) == str(je.value)
