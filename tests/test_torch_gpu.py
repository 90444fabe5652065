"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: each test skips without a CUDA device (the kernels have
no CPU mode).  The file imports no JAX, so it runs on a machine with the
card and PyTorch alone: ``python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gather as mg
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss

TOL = {torch.float32: dict(atol=3e-5, rtol=3e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(rng, shape, device, dtype, scale=1.0):
    return (scale * torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32))).to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda, dtype):
    rng = np.random.default_rng(8)

    def t(shape, scale=1.0):
        return _rand(rng, shape, cuda, dtype, scale)

    q, k, v = t((1, 200, 4, 64)), t((1, 200, 2, 64)), t((1, 200, 2, 64))
    torch.testing.assert_close(fa.flash_attention_cuda(q, k, v),
                               fa.flash_attention_plain(q, k, v),
                               **TOL[dtype])
    q1 = t((1, 1, 4, 64))
    torch.testing.assert_close(
        fa.flash_attention_cuda(q1, k, v, q_offset=199),
        fa.flash_attention_plain(q1, k, v, q_offset=199), **TOL[dtype])
    c, b, x = t((1, 100, 3, 8)), t((1, 100, 3, 8)), t((1, 100, 3, 16))
    la = -torch.nn.functional.softplus(t((1, 100, 3)).float())
    s0 = t((1, 3, 8, 16)).float()
    (y, s), (yp, sp) = (f(c, b, x, la, initial_state=s0, chunk=32) for f in
                        (ss.ssd_scan_cuda, ss.ssd_scan_plain))
    torch.testing.assert_close(y, yp, **TOL[dtype])
    torch.testing.assert_close(s, sp, atol=5e-4, rtol=5e-4)
    x, wu, wd = t((4, 40, 64)), t((4, 64, 64), 0.1), t((4, 32, 64), 0.1)
    torch.testing.assert_close(mg.expert_glu_cuda(x, wu, wd),
                               mg.expert_glu_plain(x, wu, wd), **TOL[dtype])


@pytest.mark.gpu
def test_each_launch_is_counted_once(cuda):
    """``ops`` launches the kernel for a CUDA tensor, and the kernel's
    count grows by one per launch, nowhere else."""
    rng = np.random.default_rng(9)
    q = _rand(rng, (1, 64, 2, 16), cuda, torch.float32)
    kernels.reset_launch_counts()
    ops.flash_attention(q, q, q)
    ops.flash_attention(q.cpu(), q.cpu(), q.cpu())      # the plain version
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"flash_attention": 1, "ssd_scan": 0,
                                       "expert_glu": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_glu_beyond_d_1024(cuda, dtype):
    """The tensor-core GLU has no cap on d: d = 2048 (moe_d_ff 512, 4
    experts) against the plain version, normalised by the largest output
    as chip_smoke.py holds the main-path shapes."""
    rng = np.random.default_rng(10)
    x = _rand(rng, (4, 256, 2048), cuda, dtype)
    wu = _rand(rng, (4, 2048, 1024), cuda, dtype, 0.5)
    wd = _rand(rng, (4, 512, 2048), cuda, dtype, 0.5)
    got = mg.expert_glu_cuda(x, wu, wd).double()
    want = mg.expert_glu_plain(x, wu, wd).double()
    assert got.shape == want.shape
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= TOL[dtype]["rtol"], rel


@pytest.mark.gpu
def test_expert_glu_counts_one_launch_for_its_two_kernels(cuda):
    """One ``ops.expert_glu`` call runs the up and the down projection as
    two device kernels from one C call, and counts one launch."""
    rng = np.random.default_rng(11)
    x = _rand(rng, (4, 40, 64), cuda, torch.float32)
    wu = _rand(rng, (4, 64, 64), cuda, torch.float32, 0.1)
    wd = _rand(rng, (4, 32, 64), cuda, torch.float32, 0.1)
    kernels.reset_launch_counts()
    y = ops.expert_glu(x, wu, wd)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"flash_attention": 0, "ssd_scan": 0,
                                       "expert_glu": 1}
    torch.testing.assert_close(y, mg.expert_glu_plain(x, wu, wd),
                               **TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_at_chunk_256(cuda, dtype):
    """The chunk-parallel scan at the Pallas kernel's own chunk: T = 600
    (a padded third chunk), N = P = 64, with an initial state, against
    the plain version, normalised by the largest output."""
    rng = np.random.default_rng(12)
    c, b = (_rand(rng, (1, 600, 2, 64), cuda, dtype, 0.5) for _ in range(2))
    x = _rand(rng, (1, 600, 2, 64), cuda, dtype)
    la = -torch.nn.functional.softplus(_rand(rng, (1, 600, 2), cuda,
                                             torch.float32))
    s0 = _rand(rng, (1, 2, 64, 64), cuda, torch.float32)
    (y, s), (yp, sp) = (f(c, b, x, la, initial_state=s0, chunk=256) for f in
                        (ss.ssd_scan_cuda, ss.ssd_scan_plain))
    for got, want, tol in ((y, yp, TOL[dtype]["rtol"]),
                           (s, sp, TOL[torch.float32]["rtol"])):
        assert got.shape == want.shape and got.dtype == want.dtype
        got, want = got.double(), want.double()
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= tol, rel


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    z = torch.zeros
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_cuda(z(1, 8, 2, 16, device=cuda),
                                z(1, 8, 2, 16, device=cuda,
                                  dtype=torch.bfloat16),
                                z(1, 8, 2, 16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        mg.expert_glu_cuda(z(2, 8, 4, device=cuda).transpose(1, 2),
                           z(2, 8, 8, device=cuda), z(2, 4, 8, device=cuda))
    with pytest.raises(ValueError, match="chunk"):
        ss.ssd_scan_cuda(z(1, 600, 1, 8, device=cuda),
                         z(1, 600, 1, 8, device=cuda),
                         z(1, 600, 1, 8, device=cuda),
                         z(1, 600, 1, device=cuda), chunk=512)


# ---------------------------------------------------------------------------
# the threaded lane runtime on the card: one stream per CUDA lane
# ---------------------------------------------------------------------------


def _cuda_lane(name, cuda, dialect="ref"):
    from repro_torch.core import Target
    return Target(name, kind="cuda", dialect=dialect, device=cuda,
                  is_accelerator=True)


@pytest.mark.gpu
def test_handoffs_out_of_a_slow_cuda_lane_wait_for_its_event(cuda):
    """The producer's segment spins its stream for ~0.1 s before it
    writes its output.  A consumer on a second CUDA lane (its own stream)
    and one on a host lane must both read the finished output: the first
    waits on the producer's event on the device, the second on the host
    before its ``.to("cpu")``."""
    from repro_torch.core import (FusedOp, OpGraph, ScheduleExecutor,
                                  results_bitwise_equal)
    from repro_torch.core.backends import torch_cpu

    def slow(x):
        torch.cuda._sleep(200_000_000)
        return x * 2.0 + 1.0

    graph = OpGraph([FusedOp("slow", "other", fn=slow),
                     FusedOp("card", "other", fn=lambda a: a * 3.0),
                     FusedOp("host", "other", fn=lambda a: a - 1.0)],
                    edges=[(0, 1), (0, 2)])
    lanes = {"k1": _cuda_lane("k1", cuda), "k2": _cuda_lane("k2", cuda),
             "torch-cpu": torch_cpu()}
    ex = ScheduleExecutor(list(lanes), targets=lanes)
    prog = ex.compile_scheduled(graph, {0: "k1", 1: "k2", 2: "torch-cpu"})
    x = torch.arange(1 << 20, dtype=torch.float32, device=cuda)
    oracle = ex.run_scheduled(graph, {0: "k1", 1: "k2", 2: "torch-cpu"},
                              {0: (x,)})
    for _ in range(3):
        out = prog.run({0: (x,)})
        assert out[1].device.type == "cuda" and out[2].device.type == "cpu"
        torch.cuda.synchronize()
        assert results_bitwise_equal(out, oracle)
    streams = prog.lane_streams()
    assert sorted(streams) == ["k1", "k2"]
    assert streams["k1"][1] != streams["k2"][1]
    prog.close()


@pytest.mark.gpu
def test_concurrent_small_chains_bitwise_alone_and_run_to_run(cuda):
    """Checks (a) and (c) of ``chip_smoke.py`` phase 4 at a small size:
    two small chains planned side by side on both CUDA lanes and the
    host lanes; each request's outputs are bitwise its run alone with
    the same op -> lane assignment, and two warm runs are bitwise
    equal."""
    from repro_torch import kernels
    from repro_torch.core import (CostEntry, CostTable, Orchestrator,
                                  kernel_chain, results_bitwise_equal)
    from repro_torch.core.backends import default_registry
    from repro_torch.core.profiler import fence

    reg = default_registry()
    lanes = {n: reg.get(n) for n in ("numpy-eager", "torch-cpu", "cuda:0",
                                     "cuda-kernels")}
    chains = [kernel_chain(seed=s, blocks=2, seq=128) for s in (0, 1)]
    orch = Orchestrator(CostTable(list(lanes)), targets=lanes)
    hs = []
    for k, (graph, _) in enumerate(chains):
        # request 0 is cheap on cuda-kernels, request 1 on cuda:0, and
        # the glue on the host, so the plan co-schedules across lanes
        table = CostTable(list(lanes))
        for i, op in enumerate(graph.ops):
            kernel_op = op.name.rsplit(".", 1)[-1] in ("attn", "ssd", "moe")
            for lane in lanes:
                fast = (lane == ("cuda-kernels", "cuda:0")[k]) if kernel_op \
                    else lane == "numpy-eager"
                table.set(i, lane, CostEntry(kernel=1e-4 if fast else 5e-3,
                                             dispatch=1e-5, h2d=0.0,
                                             d2h=0.0, power=100.0))
        hs.append(orch.register(graph, table=table))
    plan = orch.plan(hs)
    exts = [ext for _, ext in chains]
    used = {lane for r in range(2) for _, lane in plan.route[r]}
    assert {"cuda:0", "cuda-kernels"} <= used
    prog = orch.program_for(plan, exts)
    assert not prog.stats["serial"] and prog.stats["n_barrier"] > 0
    fence([list(o.values()) for o in orch.execute(plan, exts)])   # cold
    kernels.reset_launch_counts()
    first = orch.execute(plan, exts)
    second = orch.execute(plan, exts)
    fence([list(o.values()) for o in first + second])
    assert sum(kernels.launch_counts().values()) > 0
    for r, (graph, ext) in enumerate(chains):
        assert results_bitwise_equal(first[r], second[r])
        alone = orch.executor.compile_scheduled(
            graph, dict(plan.schedule.assignment_of(r)))
        alone.run(ext)
        got = alone.run(ext)
        fence(list(got.values()))
        assert results_bitwise_equal(first[r], got), r
    prog.close()


@pytest.mark.gpu
def test_dag_fork_out_of_a_slow_kernel_lane_feeds_a_card_and_a_host_lane(
        cuda):
    """A DAG fork: the producer on ``cuda-kernels`` spins its stream for
    ~0.1 s before it writes, then goes on with its own tower; one
    consumer runs on ``cuda:0`` (its own stream: a device wait on the
    producer's event, and ``record_stream``) and one on ``torch-cpu``
    (a host wait before its copy).  The compiled DAG program matches the
    interpreter bitwise, run after run, and no wait hits its deadline."""
    from repro_torch.core import (DagSchedule, DagStep, ExecutionPolicy,
                                  FusedOp, OpGraph, ScheduleExecutor,
                                  results_bitwise_equal)
    from repro_torch.core.backends import default_registry

    def slow(x):
        torch.cuda._sleep(200_000_000)
        return x * 2.0 + 1.0

    graph = OpGraph([FusedOp("slow", "other", fn=slow),
                     FusedOp("tower", "other", fn=lambda a: a.sin()),
                     FusedOp("card", "other", fn=lambda a: a * 3.0),
                     FusedOp("host", "other", fn=lambda a: a - 1.0)],
                    edges=[(0, 1), (0, 2), (0, 3)])
    reg = default_registry()
    lanes = {n: reg.get(n) for n in ("cuda-kernels", "cuda:0", "torch-cpu")}
    sched = DagSchedule(
        steps=[DagStep(ops=(0,), pus=("cuda-kernels",), cost=1e-3),
               DagStep(ops=(1, 2, 3),
                       pus=("cuda-kernels", "cuda:0", "torch-cpu"),
                       cost=1e-3)],
        latency=2e-3, energy=0.0, objective="latency", mode="frontier")
    ex = ScheduleExecutor(list(lanes), targets=lanes)
    prog = ex.compile_dag(graph, sched)
    # the fork cut: the consumers wait for the producer's op, not for its
    # lane's tower behind it
    assert [s.items for s in prog.lane_segments["cuda-kernels"]] == [
        [(0, 0)], [(0, 1)]]
    x = torch.arange(1 << 20, dtype=torch.float32, device=cuda)
    policy = ExecutionPolicy(timeout=30.0)
    oracle = ex.run_dag(graph, sched, {0: (x,)}, policy=policy)
    for _ in range(3):
        out = prog.run({0: (x,)}, policy=policy)
        assert out[2].device.type == "cuda" and out[3].device.type == "cpu"
        torch.cuda.synchronize()
        assert results_bitwise_equal(out, oracle)
    assert sorted(prog.lane_streams()) == ["cuda-kernels", "cuda:0"]
    prog.close()


@pytest.mark.gpu
def test_union_dag_with_two_card_inputs_caches_its_program(cuda):
    """A union of two chains, each fed its own CUDA tensor: the plan is
    the DAG route's union-grid sweep, its compiled program is cached
    over both inputs, and other input shapes compile anew."""
    from repro_torch.core import (CostEntry, CostTable, FusedOp, OpGraph,
                                  Orchestrator, results_bitwise_equal)
    from repro_torch.core.backends import default_registry

    graph = OpGraph([FusedOp("a0", "other", fn=lambda a: a * 2.0),
                     FusedOp("a1", "other", fn=lambda a: a.tanh()),
                     FusedOp("b0", "other", fn=lambda a: a + 1.0),
                     FusedOp("b1", "other", fn=lambda a: a.cos())],
                    edges=[(0, 1), (2, 3)])
    reg = default_registry()
    lanes = {n: reg.get(n) for n in ("cuda:0", "cuda-kernels")}
    table = CostTable(list(lanes))
    for i in range(4):
        for k, lane in enumerate(lanes):
            fast = (i < 2) == (k == 0)    # chain a on cuda:0, b on the other
            table.set(i, lane, CostEntry(kernel=1e-4 if fast else 1e-2,
                                         dispatch=1e-5, h2d=0.0, d2h=0.0,
                                         power=100.0))
    orch = Orchestrator(table, targets=lanes)
    plan = orch.plan(orch.register(graph))
    assert plan.kind == "dag" and plan.schedule.mode == "union-grid"
    rng = np.random.default_rng(12)
    ins = {0: (_rand(rng, (256, 64), cuda, torch.float32),),
           2: (_rand(rng, (128, 32), cuda, torch.float32),)}
    oracle = orch.execute(plan, ins, compile=False)
    for _ in range(3):
        out = orch.execute(plan, ins)
        torch.cuda.synchronize()
        assert results_bitwise_equal(out, oracle)
    assert (orch.stats["program_misses"], orch.stats["program_hits"]) == (1, 2)
    other = {0: ins[0], 2: (_rand(rng, (64, 32), cuda, torch.float32),)}
    out = orch.execute(plan, other)
    torch.cuda.synchronize()
    assert orch.stats["program_misses"] == 2
    assert results_bitwise_equal(out, orch.execute(plan, other,
                                                   compile=False))
    assert not orch.program_for(plan, ins).stats["serial"]


# ---------------------------------------------------------------------------
# segments captured as CUDA graphs (the counterpart of the jit leg)
# ---------------------------------------------------------------------------


def _small_kernel_chain(seed=0, seq=128):
    from repro_torch.core import kernel_chain
    return kernel_chain(seed=seed, blocks=2, seq=seq, heads=4, head_dim=32,
                        state=16, experts=8, top_k=2, moe_ff=32, chunk=32)


def _kernel_lane_program(graph):
    from repro_torch.core import ScheduleExecutor
    from repro_torch.core.backends import cuda_kernels
    lane = cuda_kernels(0)
    ex = ScheduleExecutor([lane.name], targets={lane.name: lane})
    return ex.compile_scheduled(graph, {i: lane.name
                                        for i in range(len(graph))})


@pytest.mark.gpu
def test_kernel_lane_segment_captures_and_replays_bitwise_as_eager(cuda):
    """A small chain on ``cuda-kernels``: the cold run probes and
    captures the segment (``JIT``, ``"bitwise"``), and a warm replay
    gives bitwise what the same program gives eagerly."""
    from repro_torch.core import laneprogram as lp
    from repro_torch.core import results_bitwise_equal
    graph, ext = _small_kernel_chain()
    prog = _kernel_lane_program(graph)
    prog.run(ext)
    seg = prog.segments[0]
    assert seg.use_variant and seg.verified in ("bitwise", "tolerance")
    assert (seg.mode, seg.jit_verified) == (lp.JIT, "bitwise"), \
        seg.capture_error
    replayed = prog.run(ext)
    seg.mode = lp.WARM                  # the same program, eagerly
    eager = prog.run(ext)
    torch.cuda.synchronize()
    assert results_bitwise_equal(replayed, eager)
    prog.close()


@pytest.mark.gpu
def test_warm_runs_on_other_inputs_leave_earlier_outputs_alone(cuda):
    """A replay writes into the graph's fixed buffers; the outputs a run
    hands out are copies, so a later run on other inputs changes none of
    them."""
    from repro_torch.core import laneprogram as lp
    from repro_torch.core import results_bitwise_equal
    graph, ext = _small_kernel_chain()
    prog = _kernel_lane_program(graph)
    prog.run(ext)
    assert prog.segments[0].mode == lp.JIT
    first = prog.run(ext)
    keep = {i: t.clone() for i, t in first.items()}
    other = {0: (ext[0][0] * 0.5 + 0.25,)}
    second = prog.run(other)
    torch.cuda.synchronize()
    assert results_bitwise_equal(first, keep)
    assert not torch.equal(second[0], first[0])
    assert all(first[i].data_ptr() != second[i].data_ptr() for i in first)
    prog.close()


@pytest.mark.gpu
def test_threaded_program_captures_on_the_lanes_own_streams(cuda):
    """Two small chains side by side on ``cuda:0`` and ``cuda-kernels``
    (one thread and one stream a lane): every CUDA segment is captured
    in its lane's worker, on its lane's stream, and the warm replays are
    bitwise each request alone with the same assignment."""
    from repro_torch.core import (CostEntry, CostTable, Orchestrator,
                                  laneprogram as lp, results_bitwise_equal)
    from repro_torch.core.backends import default_registry
    from repro_torch.core.profiler import fence

    reg = default_registry()
    lanes = {n: reg.get(n) for n in ("cuda:0", "cuda-kernels")}
    chains = [_small_kernel_chain(seed=s) for s in (0, 1)]
    orch = Orchestrator(CostTable(list(lanes)), targets=lanes)
    hs = []
    for k, (graph, _) in enumerate(chains):
        table = CostTable(list(lanes))
        for i in range(len(graph)):
            for lane in lanes:
                fast = lane == ("cuda-kernels", "cuda:0")[k]
                table.set(i, lane, CostEntry(kernel=1e-4 if fast else 5e-3,
                                             dispatch=1e-5, h2d=0.0,
                                             d2h=0.0, power=100.0))
        hs.append(orch.register(graph, table=table))
    plan = orch.plan(hs)
    exts = [ext for _, ext in chains]
    prog = orch.program_for(plan, exts)
    assert not prog.stats["serial"]
    captured_on = set()
    real = lp._capture

    def spy(fn, args, device):
        captured_on.add(torch.cuda.current_stream(device).stream_id)
        return real(fn, args, device)
    lp._capture = spy
    try:
        fence([list(o.values()) for o in orch.execute(plan, exts)])
    finally:
        lp._capture = real
    streams = {s.stream_id for _, s in prog.lane_streams().values()}
    assert captured_on and captured_on <= streams
    assert all(seg.mode == lp.JIT for seg in prog.segments), \
        prog.stats["capture_errors"]
    first = orch.execute(plan, exts)
    second = orch.execute(plan, exts)
    fence([list(o.values()) for o in first + second])
    for r, (graph, ext) in enumerate(chains):
        assert results_bitwise_equal(first[r], second[r])
        alone = orch.executor.compile_scheduled(
            graph, dict(plan.schedule.assignment_of(r)))
        alone.run(ext)
        got = alone.run(ext)
        fence(list(got.values()))
        assert results_bitwise_equal(first[r], got), r
        alone.close()
    prog.close()


@pytest.mark.gpu
def test_a_payload_that_syncs_the_host_stays_eager(cuda):
    """``.item()`` cannot be captured: the segment falls back to eager
    with ``jit_verified is None`` and the reason recorded, and runs."""
    from repro_torch.core import (FusedOp, ScheduleExecutor, chain_graph,
                                  laneprogram as lp)
    from repro_torch.core.backends import cuda_target
    lane = cuda_target(0)
    graph = chain_graph([
        FusedOp("scale", "other", fn=lambda x: x * float(x.abs().max())),
        FusedOp("tanh", "other", fn=torch.tanh)])
    ex = ScheduleExecutor([lane.name], targets={lane.name: lane})
    prog = ex.compile_scheduled(graph, {0: lane.name, 1: lane.name})
    x = torch.linspace(-1, 1, 4096, device=cuda)
    cold = prog.run({0: (x,)})
    seg = prog.segments[0]
    assert seg.mode == lp.WARM and seg.jit_verified is None
    assert seg.capture_error
    warm = prog.run({0: (x,)})
    torch.cuda.synchronize()
    assert torch.equal(warm[1], cold[1])


@pytest.mark.gpu
def test_launch_counts_of_a_replay_equal_the_eager_counts(cuda):
    """A kernel replayed in a graph counts its launches as an eager run
    does: one per kernel op, none while the graph is captured."""
    from repro_torch.core import laneprogram as lp
    graph, ext = _small_kernel_chain()
    prog = _kernel_lane_program(graph)
    prog.run(ext)
    assert prog.segments[0].mode == lp.JIT
    kernels.reset_launch_counts()
    prog.run(ext)
    torch.cuda.synchronize()
    replayed = kernels.launch_counts()
    prog.segments[0].mode = lp.WARM
    kernels.reset_launch_counts()
    prog.run(ext)
    torch.cuda.synchronize()
    assert replayed == kernels.launch_counts() == {
        "flash_attention": 2, "ssd_scan": 2, "expert_glu": 2}
    prog.close()


# ---------------------------------------------------------------------------
# PU-loss recovery and serving under chaos on the card
# ---------------------------------------------------------------------------


def _card_lanes_and_table(graph):
    """``cuda:0`` and ``cuda-kernels``, with every op cheaper on the
    kernel lane."""
    from repro_torch.core import CostEntry, CostTable
    from repro_torch.core.backends import default_registry
    reg = default_registry()
    lanes = {n: reg.get(n) for n in ("cuda:0", "cuda-kernels")}
    table = CostTable(list(lanes))
    for i in range(len(graph)):
        for lane in lanes:
            table.set(i, lane, CostEntry(
                kernel=1e-4 if lane == "cuda-kernels" else 4e-4,
                dispatch=1e-5, h2d=0.0, d2h=0.0, power=100.0))
    return lanes, table


@pytest.mark.gpu
def test_recovery_of_a_captured_route(cuda):
    """A kernel-lane route cut by one op on ``cuda:0`` runs as two
    captured segments; a loss of ``cuda-kernels`` at a late kernel op
    keeps the first segments' results bitwise, re-plans the rest onto
    ``cuda:0`` and resumes on the interpreter from that frontier."""
    from repro_torch.core import (FaultPlan, Orchestrator, Plan,
                                  PULostError, SeqSchedule,
                                  laneprogram as lp, results_bitwise_equal)
    from repro_torch.core.profiler import fence
    graph, ext = _small_kernel_chain()
    lanes, table = _card_lanes_and_table(graph)
    orch = Orchestrator(table, targets=lanes)
    h = orch.register(graph)
    n, cut, late = len(graph), 5, 10          # moe of block 1 is op 10
    route = ["cuda-kernels"] * n
    route[cut] = "cuda:0"
    lat, eng = orch.workload(h).evaluate(route)
    plan = Plan("sequential", SeqSchedule(list(range(n)), route, lat, eng,
                                          "latency"), "latency", (h,),
                "sequential")
    orch.execute(plan, ext)                   # cold: probe and capture
    clean = orch.execute(plan, ext)
    fence(list(clean.values()))
    prog = orch.program_for(plan, ext)
    assert [seg.mode for seg in prog.segments] == [lp.JIT] * 3
    faults = FaultPlan.single("pu_lost", lane="cuda-kernels", op=late)
    with pytest.raises(PULostError) as lost:
        orch.execute(plan, ext, recover=False, faults=faults)
    prefix = lost.value.partial[0]
    assert sorted(prefix) == list(range(cut + 1))
    assert results_bitwise_equal(prefix, {i: clean[i] for i in prefix})
    faults.reset()
    got = orch.execute(plan, ext, faults=faults)
    fence(list(got.values()))
    assert orch.stats["recoveries"] == 1
    assert orch.condition.unavailable == {"cuda-kernels"}
    assert orch.plan(h).route[0] == [(i, "cuda:0") for i in range(n)]
    assert results_bitwise_equal({i: got[i] for i in prefix}, prefix)
    stitched = {i: "cuda:0" for i in range(cut + 1, n)}
    want = orch.executor.run_scheduled(graph, stitched, ext,
                                       completed=prefix)
    assert results_bitwise_equal(got, want)
    oracle = orch.execute(plan, ext, compile=False)
    for i in range(n):
        scale = float(oracle[i].abs().max())
        assert float((got[i] - oracle[i]).abs().max()) <= 1e-3 * scale, i
    prog.close()


@pytest.mark.gpu
def test_serving_recovers_from_a_lost_kernel_lane(cuda):
    """Real-mode serving with compiled windows over two two-block
    chains: ``cuda-kernels`` is lost at the third arrival and returns at
    the fifth; the run drains with no wrong answer, recovers, and the
    kernel lane's breaker closes again after a probe."""
    from repro_torch.core import (ArrivalTrace, ChaosEvent, ChaosTrace,
                                  HealthPolicy, Orchestrator, ServingEngine)
    chains = {m: _small_kernel_chain(seed=s) for m, s in (("A", 0),
                                                          ("B", 1))}
    lanes, table = _card_lanes_and_table(chains["A"][0])
    orch = Orchestrator(table, targets=lanes)
    lat = orch.plan(orch.register(chains["A"][0])).latency
    eng = ServingEngine(orch, {m: c[0] for m, c in chains.items()},
                        execution="real", compile_exec=True,
                        max_concurrent=2,
                        inputs={m: c[1] for m, c in chains.items()},
                        health_policy=HealthPolicy(cooldown=0.25 * lat,
                                                   cooldown_backoff=1.0))
    trace = ArrivalTrace.poisson(["A", "B"], rate=1.5 / lat, n=6, seed=2)
    t = [a.time for a in trace.arrivals]
    kernels.reset_launch_counts()
    rep = eng.serve(trace, chaos=ChaosTrace([
        ChaosEvent(time=t[2], kind="pu_lost", lane="cuda-kernels"),
        ChaosEvent(time=t[4], kind="pu_restored", lane="cuda-kernels")]))
    assert rep.completed + rep.shed == 6 and rep.bitwise_failures == 0
    assert rep.bitwise_checked == rep.completed >= 1
    assert rep.recoveries >= 1
    assert [f[:2] for f in eng.faults.fired] == [("pu_lost", "cuda-kernels")]
    assert rep.breaker["targets"]["cuda-kernels"]["state"] == "closed"
    assert all(c >= 1 for c in kernels.launch_counts().values())
    assert orch._active == {}


# ---------------------------------------------------------------------------
# the model zoo on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch,depth", [("llama3.2-1b", 2),
                                        ("zamba2-2.7b", 6)])
def test_zoo_captured_decode_is_bitwise_the_eager_step(cuda, arch, depth):
    """At full width and cut depth in bf16 with the kernels: every step
    of the engine's captured decode gives the eager ``decode_step``'s
    logits and cache bit for bit, one capture serves two generates, and
    the prefill launched its kernel once a layer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    cfg = dataclasses.replace(get_config(arch), n_layers=depth,
                              use_kernels=True)
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 128),
                                            dtype=np.int32)).to(cuda)
    kernels.reset_launch_counts()
    logits, cache = M.prefill(cfg, params, {"tokens": prompts}, max_len=136)
    torch.cuda.synchronize()
    kernel = "flash_attention" if arch == "llama3.2-1b" else "ssd_scan"
    assert kernels.launch_counts()[kernel] == depth
    eng = Engine(cfg=cfg, params=params)
    step = eng.decode_step_fn()
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    for _ in range(6):
        want_logits, want_cache = M.decode_step(cfg, params, cache,
                                                {"tokens": tok})
        logits, cache = step(params, cache, {"tokens": tok})
        assert torch.equal(logits.view(torch.int16),
                           want_logits.view(torch.int16))
        for a, b in zip(M.tree_leaves(cache), M.tree_leaves(want_cache)):
            assert torch.equal(a, b)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    out1 = eng.generate(prompts, max_new=8)
    out2 = eng.generate(prompts, max_new=8)
    assert torch.equal(out1, out2) and tuple(out1.shape) == (2, 8)
    assert sum(eng.decode_trace_counts.values()) == 1
    eng.release()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zoo_kernel_shapes_d160_and_n384_match_plain(cuda, dtype):
    """StableLM-12B's attention (D = 160, 32 query heads over 8) and
    xLSTM-125M's mLSTM scan (N = 384, P = 385: v and a column of ones,
    chunk 256) run the kernels within the bucket of their plain versions,
    bitwise run to run; a state beyond the kernel (N = 512) still raises
    and launches nothing."""
    from repro_torch.configs import get_config
    rng = np.random.default_rng(3)
    s = get_config("stablelm-12b")
    q = _rand(rng, (1, 200, s.n_heads, s.d_head), cuda, dtype)
    k, v = (_rand(rng, (1, 200, s.n_kv_heads, s.d_head), cuda, dtype)
            for _ in range(2))
    kernels.reset_launch_counts()
    o = ops.flash_attention(q, k, v)
    assert torch.equal(o, ops.flash_attention(q, k, v))
    torch.testing.assert_close(o, fa.flash_attention_plain(q, k, v),
                               **TOL[dtype])
    x = get_config("xlstm-125m")
    dh = x.xlstm_d_inner // x.n_heads
    c, b = (_rand(rng, (1, 300, x.n_heads, dh), cuda, dtype, 0.1)
            for _ in range(2))
    vv = torch.cat([_rand(rng, (1, 300, x.n_heads, dh), cuda, dtype),
                    torch.ones((1, 300, x.n_heads, 1), device=cuda,
                               dtype=dtype)], dim=-1)
    la = -torch.nn.functional.softplus(_rand(rng, (1, 300, x.n_heads), cuda,
                                             torch.float32))
    y, st = ops.ssd_scan(c, b, vv, la, chunk=x.ssm_chunk)
    y2, st2 = ops.ssd_scan(c, b, vv, la, chunk=x.ssm_chunk)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    yp, sp = ss.ssd_scan_plain(c, b, vv, la, chunk=x.ssm_chunk)
    for got, want, tol in ((y, yp, TOL[dtype]["rtol"]),
                           (st, sp, TOL[torch.float32]["rtol"])):
        assert got.shape == want.shape and got.dtype == want.dtype
        got, want = got.double(), want.double()
        assert float((got - want).abs().max() / want.abs().max()) <= tol
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"flash_attention": 2, "ssd_scan": 2,
                                       "expert_glu": 0}
    kernels.reset_launch_counts()
    wide = _rand(rng, (1, 64, 1, ss.MAX_STATE + 16), cuda, dtype)
    with pytest.raises(ValueError, match="N <="):
        ops.ssd_scan(wide, wide, vv[:, :64, :1], la[:, :64, :1])
    assert not any(kernels.launch_counts().values())
