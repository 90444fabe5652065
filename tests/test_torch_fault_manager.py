"""The port's train-loop fault manager against the reference: the
recovery, heartbeat and straggler tests of
``tests/test_checkpoint_fault_data.py``, each run through both packages
on the same injected faults, with the same ``RecoveryStats``, executed
steps, saves and verdicts."""
import dataclasses

import pytest

from repro.fault import manager as R
from repro_torch.fault import manager as P


def _recovery_run(mod, fail_at, n_fails, every, total=10, detector=None):
    state = {"ckpt": 0, "fails": 0}
    executed, saves = [], []

    def step(i):
        if i in fail_at and state["fails"] < n_fails:
            state["fails"] += 1
            raise mod.RecoverableError("injected")
        executed.append(i)

    def save(i):
        state["ckpt"] = i
        saves.append(i)

    stats = mod.run_with_recovery(
        step, start_step=0, total_steps=total,
        cfg=mod.FaultConfig(checkpoint_every=every, max_restarts=5),
        save_fn=save, restore_fn=lambda: state["ckpt"], detector=detector)
    return dataclasses.asdict(stats), executed, saves


@pytest.mark.parametrize("fail_at,n_fails,every", [
    ((5,), 2, 2), ((3, 7), 3, 3), ((9,), 1, 4), ((), 0, 1)])
def test_recovery_matches_reference(fail_at, n_fails, every):
    got = _recovery_run(P, fail_at, n_fails, every)
    assert got == _recovery_run(R, fail_at, n_fails, every)
    assert got[1][-1] == 9


def test_recovery_restarts_from_checkpoint():
    stats, executed, _ = _recovery_run(P, (5,), 2, 2)
    assert stats["restarts"] == 2 and stats["failures_detected"] == 2
    assert executed.count(4) == 3   # steps from the checkpoint re-execute


def test_recovery_gives_up_after_max_restarts():
    def step(i):
        raise P.RecoverableError("always")
    with pytest.raises(P.RecoverableError):
        P.run_with_recovery(step, start_step=0, total_steps=3,
                            cfg=P.FaultConfig(max_restarts=2,
                                              checkpoint_every=1),
                            save_fn=lambda i: None, restore_fn=lambda: 0)


def test_transient_fault_of_the_runtime_is_recoverable():
    """The inference runtime's injected fault is the train loop's
    ``RecoverableError``: one vocabulary for both."""
    from repro_torch.core.faults import TransientFault
    assert issubclass(TransientFault, P.RecoverableError)


def test_heartbeat_failure_detection_matches_reference():
    verdicts = []
    for mod in (P, R):
        clock = {"t": 0.0}
        hb = mod.HeartbeatTracker(mod.FaultConfig(failure_timeout=10.0),
                                  n_hosts=3, clock=lambda: clock["t"])
        clock["t"] = 15.0
        hb.beat(0)
        hb.beat(1)
        clock["t"] = 20.0        # host 2 silent since t=0 -> dead (>10s)
        seen = [hb.dead_hosts()]
        hb.beat(2)
        seen.append(hb.dead_hosts())
        seen.append(hb.dead_hosts(now=40.0))
        verdicts.append(seen)
    assert verdicts[0] == verdicts[1] == [[2], [], [0, 1, 2]]


def test_straggler_detection_matches_reference():
    found = []
    for mod in (P, R):
        det = mod.StragglerDetector(mod.FaultConfig(straggler_factor=1.5,
                                                    straggler_window=8),
                                    n_hosts=4)
        for k in range(12):
            for h in range(3):
                det.record(h, 1.0 + 0.01 * k)
            det.record(3, 2.0)       # host 3 is 2x the median
        found.append((det.stragglers(), det.medians()))
    assert found[0] == found[1] and found[0][0] == [3]


def test_stragglers_flagged_in_the_loop_match_reference():
    """A detector inside ``run_with_recovery`` counts the same flags in
    both packages (one host: never a straggler against itself)."""
    runs = []
    for mod in (P, R):
        det = mod.StragglerDetector(mod.FaultConfig(), n_hosts=1)
        runs.append(_recovery_run(mod, (4,), 1, 2, detector=det))
    assert runs[0] == runs[1]
    assert runs[0][0]["stragglers_flagged"] == 0
