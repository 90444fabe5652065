"""The port's main path on the CPU, against the JAX reference.

``kernel_chain`` at a small size (1 block, seq 64, 2 heads of 16), with
the reference chain's own weights carried across: the arrays are rebuilt
exactly as ``repro.core.modelgraph.kernel_chain`` draws them (one
``jax.random.split`` of ``PRNGKey(seed)`` into ``8 * blocks + 1`` keys,
drawn as x0, then per block k, v, c, b, log_a, w_gate, w_up, w_down) and
handed to the port as NumPy arrays.  Then:

* the port's ``run_monolithic`` against the reference's, f32 within 1e-5;
* the MoE experts each package chooses, compared exactly;
* profile → plan → compiled execute on the host lanes, the compiled
  outputs held against the port's interpreter oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.executor import ScheduleExecutor as JExecutor
from repro.core.modelgraph import kernel_chain as jax_kernel_chain
from repro_torch.core import (MeasuredProfiler, Orchestrator, Plan,
                              ScheduleExecutor, Target, kernel_chain,
                              results_bitwise_equal, variant_tolerance)
from repro_torch.core.backends import default_registry
from repro_torch.kernels.payloads import top_k_gates

CFG = dict(blocks=1, seq=64, heads=2, head_dim=16)
SHAPES = dict(batch=1, state=8, experts=4, moe_ff=16, top_k=2)


def reference_arrays(seed: int, blocks: int, seq: int, heads: int,
                     head_dim: int) -> dict[str, np.ndarray]:
    """The reference chain's arrays, drawn in its order from its keys."""
    B, T, H, D = SHAPES["batch"], seq, heads, head_dim
    N, E, F = SHAPES["state"], SHAPES["experts"], SHAPES["moe_ff"]
    d = H * D
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 8 * blocks + 1))

    def rnd(shape, scale=1.0):
        return (scale * jax.random.normal(next(keys), shape)
                ).astype(jnp.float32)

    out = {"x0": rnd((B, T, H, D))}
    for j in range(blocks):
        out[f"b{j}.attn.k"] = rnd((B, T, H, D), 0.5)
        out[f"b{j}.attn.v"] = rnd((B, T, H, D), 0.5)
        out[f"b{j}.ssd.c"] = rnd((B, T, H, N), 0.5)
        out[f"b{j}.ssd.b"] = rnd((B, T, H, N), 0.5)
        out[f"b{j}.ssd.log_a"] = -0.05 * jnp.abs(rnd((B, T, H)))
        out[f"b{j}.moe.w_gate"] = rnd((d, E), 0.5)
        out[f"b{j}.moe.w_up"] = rnd((E, d, 2 * F), 0.5)
        out[f"b{j}.moe.w_down"] = rnd((E, F, d), 0.5)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def chains():
    jgraph, jext = jax_kernel_chain(seed=0, **CFG)
    arrays = reference_arrays(0, **CFG)
    assert np.asarray(jext[0][0]).tobytes() == arrays["x0"].tobytes()
    graph, ext = kernel_chain(arrays=arrays, device="cpu", **CFG)
    jres = JExecutor(["CPU"]).run_monolithic(jgraph, jext)
    res = ScheduleExecutor(["cpu"]).run_monolithic(graph, ext)
    return dict(jgraph=jgraph, graph=graph, ext=ext, arrays=arrays,
                jres=jres, res=res)


def test_monolithic_matches_reference(chains):
    graph, res, jres = chains["graph"], chains["res"], chains["jres"]
    assert [op.name for op in graph.ops] == \
        [op.name for op in chains["jgraph"].ops]
    for i, op in enumerate(graph.ops):
        assert res[i].dtype == torch.float32 and res[i].device.type == "cpu"
        np.testing.assert_allclose(res[i].numpy(), np.asarray(jres[i]),
                                   rtol=1e-5, atol=1e-5, err_msg=op.name)


def test_moe_chooses_the_reference_experts(chains):
    """At each MoE op, top-k gating picks the same experts in both
    packages: on the reference's own input, and on each package's input
    as its chain computed it."""
    graph, res, jres = chains["graph"], chains["res"], chains["jres"]
    tokens, d = CFG["seq"], CFG["heads"] * CFG["head_dim"]
    moe = [i for i, op in enumerate(graph.ops) if op.name.endswith(".moe")]
    assert moe
    for i in moe:
        j = int(graph.ops[i].name[1:].split(".")[0])
        w_gate = chains["arrays"][f"b{j}.moe.w_gate"]
        jx = jnp.asarray(jres[i - 1]).reshape(tokens, d)
        _, want = jax.lax.top_k(jax.nn.softmax(jx @ jnp.asarray(w_gate),
                                               axis=-1), SHAPES["top_k"])
        for x in (torch.tensor(np.asarray(jx)),
                  res[i - 1].reshape(tokens, d)):
            got, _ = top_k_gates(x @ torch.tensor(w_gate),
                                 SHAPES["top_k"])
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lanes():
    reg = default_registry(device="cpu")
    lanes = {name: reg.get(name) for name in reg.names()}
    # the kernel dialect on a host lane: its payloads take the kernels'
    # plain versions, so the variant probe and placement run here too
    lanes["kernels-plain"] = Target("kernels-plain", kind="cpu",
                                    dialect="cuda",
                                    device=torch.device("cpu"))
    return lanes


def _close(a: dict, b: dict, verdicts) -> bool:
    if all(v == "bitwise" for v in verdicts):
        return results_bitwise_equal(a, b)
    atol, rtol = variant_tolerance(torch.float32)
    return all(torch.allclose(a[k], b[k], atol=atol, rtol=rtol) for k in a)


def test_profile_plan_execute_on_host_lanes(chains):
    graph, ext = chains["graph"], chains["ext"]
    lanes = _lanes()
    table = MeasuredProfiler(warmup=1, iters=1, strict=True,
                             targets=lanes).profile(graph)
    assert not table.meta["profile_failures"]
    assert {lane for _, lane in table.meta["measurements"]} == set(lanes)
    orch = Orchestrator(table, targets=lanes)
    h = orch.register(graph)
    plan = orch.plan(h)
    assert Plan.from_json(plan.to_json()).route == plan.route
    oracle = orch.execute(plan, ext, compile=False)
    assert results_bitwise_equal(oracle, chains["res"])
    out = orch.execute(plan, ext)                  # cold: probes variants
    again = orch.execute(plan, ext)                # warm, cached program
    assert orch.stats["program_hits"] == 1
    prog = orch.program_for(plan, ext)
    verdicts = prog.stats["variant_verified"].values()
    assert set(verdicts) <= {"bitwise", "tolerance"}
    assert _close(out, oracle, ["bitwise"])        # cold run serves the oracle
    assert _close(again, oracle, verdicts)
    stats = {}
    for lane in lanes:
        p = orch.executor.compile_scheduled(
            graph, {i: lane for i in range(len(graph))})
        p.run(ext)
        got = p.run(ext)
        stats[lane] = p.stats
        verdicts = p.stats["variant_verified"].values()
        assert set(verdicts) <= {"bitwise", "tolerance"}, lane
        assert _close(got, oracle, verdicts), lane
        assert all(t.device == lanes[lane].device for t in got.values())
    assert stats["kernels-plain"]["n_variant"] == 1      # one 6-op segment
    assert stats["torch-cpu"]["variant_verified"] == {}  # ref dialect


def test_chain_builds_the_reference_config_names():
    """Unknown configuration keys are refused, not ignored."""
    with pytest.raises(TypeError, match="unknown config"):
        kernel_chain(device="cpu", block_q=32, **CFG)
