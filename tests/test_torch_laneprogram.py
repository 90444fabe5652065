"""The port's compiled lane programs: how a variant is probed and served.

Small hand-built chains on the CPU, no JAX.  Each variant op is probed
on the reference composition's own inputs, against the target's
tolerance (atol optionally scaled by the output's largest magnitude);
a kernel-dialect variant that fails to run raises; a program whose
segments could run concurrently runs on its lane workers.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (FusedOp, OpGraph, ScheduleExecutor, Target,
                              chain_graph, results_bitwise_equal)

X = torch.from_numpy(np.random.default_rng(0).standard_normal(
    64, dtype=np.float32))
X[0] = 0.0          # an output near zero, where only atol can pass


def _op(i, fn, variant=None, dialect="cuda"):
    return FusedOp(name=f"op{i}", kind="other", fn=fn,
                   variants={dialect: variant} if variant else {})


def _compile(graph, target):
    ex = ScheduleExecutor([target.name], targets={target.name: target})
    return ex.compile_scheduled(graph,
                                {i: target.name for i in range(len(graph))})


def _lane(dialect="cuda", **kw):
    return Target("lane", kind="cpu", dialect=dialect,
                  device=torch.device("cpu"), **kw)


def test_probe_holds_each_variant_op_to_its_own_inputs():
    """Op 0's variant is within the f32 bucket; op 1 cancels its input
    against a constant and amplifies what is left.  Fed op 0's variant
    output, op 1 would be 1e-3 off a zero output and fail the bucket;
    fed the reference's, it is exact.  The probe takes the second."""
    graph = chain_graph([
        _op(0, lambda x: x * 1.0, lambda x: x * (1.0 + 1e-6)),
        _op(1, lambda y: (y - X) * 1e3),
    ])
    prog = _compile(graph, _lane())
    cold = prog.run({0: (X,)})
    assert cold[1].abs().max() == 0                 # served the reference
    assert prog.stats["variant_verified"] == {0: "tolerance"}
    errs = prog.stats["variant_errors"][0]
    assert errs[0][0] > 0 and errs[1][0] == 0
    warm = prog.run({0: (X,)})                      # serves the variants
    assert prog.stats["n_variant"] == 1
    assert warm[1].abs().max() > 3e-4


@pytest.mark.parametrize("scale,err,atol_scaled,verdict", [
    (1e4, 1e-2, True, "tolerance"),     # 1e-6 of the output's magnitude
    (1e4, 1e-2, False, "rejected"),     # off by 30x the bucket's atol
    (1.0, 1e-1, True, "rejected"),      # order-1 output: the bucket itself
    (1.0, 1e-5, True, "tolerance"),
])
def test_probe_tolerance_scales_with_the_output(scale, err, atol_scaled,
                                                verdict):
    graph = chain_graph([_op(0, lambda x: x * scale,
                             lambda x: x * scale + err)])
    prog = _compile(graph, _lane(atol_scaled=atol_scaled))
    prog.run({0: (X,)})
    assert prog.stats["variant_verified"] == {0: verdict}
    assert prog.stats["n_variant"] == (verdict == "tolerance")


def test_a_rejected_variant_is_never_served():
    graph = chain_graph([_op(0, lambda x: x + 1.0, lambda x: x + 1.1,
                             dialect="numpy")])
    prog = _compile(graph, _lane("numpy"))
    ref = {0: X + 1.0}
    assert results_bitwise_equal(prog.run({0: (X,)}), ref)
    assert prog.stats["variant_verified"] == {0: "rejected"}
    assert results_bitwise_equal(prog.run({0: (X,)}), ref)


def _fails(x):
    raise ValueError("shape not taken")


def test_a_kernel_that_fails_to_run_raises():
    """On a kernel dialect the failure surfaces, on every run (the
    segment stays cold); on another dialect the segment serves the
    reference and records the error."""
    prog = _compile(chain_graph([_op(0, lambda x: x + 1.0, _fails)]),
                    _lane("cuda"))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="failed in its probe"):
            prog.run({0: (X,)})
    assert prog.stats["n_cold"] == 1
    prog = _compile(chain_graph([_op(0, lambda x: x + 1.0, _fails,
                                     dialect="numpy")]), _lane("numpy"))
    assert results_bitwise_equal(prog.run({0: (X,)}), {0: X + 1.0})
    assert prog.stats["variant_verified"][0].startswith(
        "error: ValueError")


def test_segments_that_could_run_concurrently_are_not_ported():
    """A fork whose branches land on different lanes: the segments can
    co-execute, so the program runs on its lane workers (not inline),
    and its outputs are bitwise the per-op interpreter's."""
    graph = OpGraph([_op(0, lambda x: x * 2.0), _op(1, lambda x: x + 1.0),
                     _op(2, lambda x: x.sin())], edges=[(0, 1), (0, 2)])
    ex = ScheduleExecutor(["a", "b", "c"])
    assignment = {0: "a", 1: "b", 2: "c"}
    prog = ex.compile_scheduled(graph, assignment)
    assert prog.serial_order is None and not prog.stats["serial"]
    oracle = ex.run_scheduled(graph, assignment, {0: (X,)})
    for _ in range(2):
        assert results_bitwise_equal(prog.run({0: (X,)}), oracle)
    assert prog.runs == 2
    prog.close()
