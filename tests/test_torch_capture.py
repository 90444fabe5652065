"""Segment capture, the port's counterpart of the reference's jit leg, on
the CPU.

A CUDA graph needs the card, so the rule that decides whether a captured
segment is kept runs here through the capture seam
(``laneprogram._capture``) with fakes in place of the graph: a replay
that is bitwise the eager composition is kept (mode ``JIT``,
``jit_verified == "bitwise"``); one that differs only on the perturbed
leg, or a capture that raises, leaves the segment eager with
``jit_verified is None``; a target that declares a tolerance admits a
replay within it (``"tolerance"``); host targets never try.  ``_perturb``
is held bitwise to the reference's on NumPy arrays.  The real capture is
``tests/test_torch_gpu.py``'s.
"""
import numpy as np
import pytest
import torch

from repro.core import laneprogram as JL
from repro_torch.core import (ExecutionPolicy, FusedOp, ScheduleExecutor,
                              Target, chain_graph, results_bitwise_equal)
from repro_torch.core import laneprogram as lp
from repro_torch.core.backends import numpy_eager, torch_cpu

RNG = np.random.default_rng(4)
X = torch.from_numpy(RNG.standard_normal((8, 16), dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "int32",
                                   "int64"])
def test_perturb_is_bitwise_the_reference(dtype):
    a = (RNG.standard_normal((5, 7)) * 40).astype(dtype)
    got, want = lp._perturb(torch.from_numpy(a)), JL._perturb(a)
    if dtype.startswith("int"):
        assert torch.equal(got, torch.from_numpy(a))
        assert want is a
        return
    assert got.dtype == torch.from_numpy(np.asarray(want)).dtype
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert not torch.equal(got, torch.from_numpy(a))


class Fake:
    """A stand-in for a captured graph: ``replay`` runs the composition
    eagerly, optionally off by ``off`` (relative) on every leg or on the
    perturbed leg only; ``boom`` makes the capture itself raise."""

    def __init__(self, off=0.0, perturbed_only=False, boom=False):
        self.off, self.perturbed_only, self.boom = off, perturbed_only, boom
        self.captured, self.replays, self.released = [], 0, 0

    def seam(self, fn, args, device):
        if self.boom:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        first = [a.clone() for a in args]
        fake = self

        class Captured:
            launches = {}

            def replay(self, leaves):
                fake.replays += 1
                outs = fn(*leaves)
                probe = all(torch.equal(a, b) for a, b in zip(leaves, first))
                if fake.off and not (fake.perturbed_only and probe):
                    outs = tuple(o * (1.0 + fake.off) for o in outs)
                return outs

            def release(self):
                fake.released += 1

        self.captured.append(fn)
        return Captured(), fn(*args)


def _jit_lane(**kw):
    return Target("lane", kind="cpu", dialect="ref", jit=True,
                  device=torch.device("cpu"), **kw)


def _program(target, n=3, variant=None):
    ops = [FusedOp(name=f"op{i}", kind="other",
                   fn=(lambda x, i=i: torch.tanh(x * (0.5 + i))),
                   variants={} if variant is None else {"numpy": variant})
           for i in range(n)]
    ex = ScheduleExecutor([target.name], targets={target.name: target})
    return ex.compile_scheduled(chain_graph(ops),
                                {i: target.name for i in range(n)})


@pytest.fixture
def fake(monkeypatch):
    """The seam replaced by a fake, and a CPU target that jits treated
    as capturing (on the card only a CUDA device captures)."""
    f = Fake()
    monkeypatch.setattr(lp, "_capture", f.seam)
    monkeypatch.setattr(lp, "_capture_device",
                        lambda t: torch.device("cpu")
                        if t is not None and t.jit else None)
    return f


def _settle(prog, x=X):
    cold = prog.run({0: (x,)})
    return cold, prog.segments[0]


def test_a_bitwise_replay_is_kept_and_served(fake):
    prog = _program(_jit_lane())
    cold, seg = _settle(prog)
    assert (seg.mode, seg.jit_verified, seg.capture_error) == \
        (lp.JIT, "bitwise", None)
    assert prog.stats["n_jitted"] == 1
    assert prog.stats["jit_verified"] == {0: "bitwise"}
    before = fake.replays
    warm = prog.run({0: (X,)})
    assert fake.replays == before + 1          # the warm run replays
    assert results_bitwise_equal(warm, cold)
    prog.close()
    assert fake.released == 1 and seg.mode == lp.WARM
    assert results_bitwise_equal(prog.run({0: (X,)}), cold)


def test_a_replay_off_only_on_the_perturbed_leg_stays_eager(fake):
    fake.off, fake.perturbed_only = 1e-3, True
    prog = _program(_jit_lane())
    _, seg = _settle(prog)
    assert seg.mode == lp.WARM and seg.jit_verified is None
    assert "perturbed" in seg.capture_error
    assert fake.released == 1
    before = fake.replays
    prog.run({0: (X,)})
    assert fake.replays == before              # nothing replays any more


def test_a_capture_that_raises_stays_eager(fake):
    fake.boom = True
    prog = _program(_jit_lane())
    cold, seg = _settle(prog)
    assert seg.mode == lp.WARM and seg.jit_verified is None
    assert "RuntimeError" in seg.capture_error
    assert prog.stats["capture_errors"] == {0: seg.capture_error}
    assert results_bitwise_equal(prog.run({0: (X,)}), cold)


@pytest.mark.parametrize("declared,verdict", [(True, "tolerance"),
                                              (False, None)])
def test_only_a_declared_tolerance_admits_a_close_replay(fake, declared,
                                                         verdict):
    """A replay off by 1e-7 of each output on both legs: kept as
    ``"tolerance"`` on a target that declares atol/rtol 1e-5 (as the
    reference's device targets do), eager on one that declares none."""
    fake.off = 1e-7
    tol = dict(atol=1e-5, rtol=1e-5) if declared else {}
    prog = _program(_jit_lane(**tol))
    _, seg = _settle(prog)
    assert seg.jit_verified == verdict
    assert seg.mode == (lp.JIT if declared else lp.WARM)


def test_the_served_variant_is_what_is_captured(fake):
    """A segment that serves a verified variant captures the variant
    composition, not the reference one."""
    def variant(x):
        return torch.from_numpy(np.tanh(x.numpy() * np.float32(0.5)))

    target = Target("lane", kind="cpu", dialect="numpy", jit=True,
                    device=torch.device("cpu"))
    prog = _program(target, n=1, variant=variant)
    _, seg = _settle(prog)
    assert seg.use_variant and seg.mode == lp.JIT
    assert seg.verified in ("bitwise", "tolerance")
    leaves = [X]
    got = fake.captured[0](*leaves)[0]
    assert torch.equal(got, variant(X))


def test_another_input_signature_runs_eagerly(fake):
    prog = _program(_jit_lane())
    _, seg = _settle(prog)
    before = fake.replays
    other = X[:4].clone()
    out = prog.run({0: (other,)})
    assert fake.replays == before and seg.mode == lp.JIT
    assert torch.equal(out[2], torch.tanh(torch.tanh(torch.tanh(
        other * 0.5) * 1.5) * 2.5))


def test_a_replay_that_fails_falls_back_to_eager_once(fake):
    prog = _program(_jit_lane())
    cold, seg = _settle(prog)

    def broken(leaves):
        raise RuntimeError("CUDA error: an illegal memory access")
    seg._graph.replay = broken
    out = prog.run({0: (X,)}, policy=ExecutionPolicy(timeout=30.0))
    assert seg.mode == lp.WARM and fake.released == 1
    assert results_bitwise_equal(out, cold)


def test_host_targets_never_try_to_capture(monkeypatch):
    calls = []
    monkeypatch.setattr(lp, "_capture",
                        lambda *a: calls.append(a) or (_ for _ in ()).throw(
                            AssertionError("capture attempted")))
    for target in (torch_cpu(), numpy_eager(), _jit_lane()):
        prog = _program(target)
        prog.run({0: (X,)})
        prog.run({0: (X,)})
        seg = prog.segments[0]
        assert seg.mode == lp.WARM and seg.jit_verified is None
        assert seg.capture_error is None
    assert calls == []
    assert torch_cpu().jit is False and numpy_eager().jit is False
