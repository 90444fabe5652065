"""The port's serving engine and serve driver against the reference.

* ``Engine.generate`` on reduced models (the reference's parameters as
  NumPy) gives the reference's greedy tokens exactly;
* the two decode-step reuse tests of ``tests/test_serving_engine.py``,
  mirrored: two same-shape ``generate`` calls prepare the step once, a
  new cache length once more (on the CPU the step runs eagerly; on the
  card it is captured, ``tests/test_torch_gpu.py``);
* ``repro_torch.launch.serve.main([..., "--device", "cpu"])`` serves
  tokens of the right shape, and ``--concurrent``'s co-schedule (steps
  and predicted makespan) is bitwise the reference driver's;
* without a card the driver needs ``--device cpu``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core.schedule import schedule_to_dict as ref_schedule_to_dict
from repro.launch import serve as ref_serve
from repro.models import model as RM
from repro.serving.engine import Engine as RefEngine
from repro.sharding import Policy as RefPolicy
from repro_torch.configs import get_config
from repro_torch.core.schedule import schedule_to_dict
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine
from repro_torch.sharding import Policy


@functools.lru_cache(maxsize=None)
def _engines(arch):
    """The reference engine on its own parameters and the port's engine
    on the same parameters."""
    cfg = ref_config(arch).reduced()
    params = jax.jit(functools.partial(RM.init_params, cfg))(
        jax.random.PRNGKey(0))
    port_params = M.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return (RefEngine(cfg=cfg, params=params, policy=RefPolicy()),
            Engine(cfg=get_config(arch).reduced(), params=port_params,
                   policy=Policy()))


def _prompts(vocab, batch=2, seq=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, seq), dtype=np.int32)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b", "xlstm-125m"])
def test_generate_gives_the_reference_tokens(arch):
    ref, port = _engines(arch)
    prompts = _prompts(port.cfg.vocab)
    want = np.asarray(ref.generate(jnp.asarray(prompts), max_new=3))
    got = port.generate(torch.from_numpy(prompts), max_new=3)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture
def engine():
    cfg = get_config("llama3.2-1b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    return Engine(cfg=cfg, params=params, policy=Policy())


def test_two_generates_reuse_one_decode_compilation(engine):
    toks = torch.from_numpy(_prompts(engine.cfg.vocab))
    out1 = engine.generate(toks, max_new=3)
    assert sum(engine.decode_trace_counts.values()) == 1
    out2 = engine.generate(toks, max_new=3)
    assert sum(engine.decode_trace_counts.values()) == 1
    assert len(engine.decode_trace_counts) == 1
    assert torch.equal(out1, out2)
    assert tuple(out1.shape) == (2, 3)


def test_new_shapes_trace_once_each(engine):
    toks = torch.from_numpy(_prompts(engine.cfg.vocab))
    engine.generate(toks, max_new=3)
    base = sum(engine.decode_trace_counts.values())
    engine.generate(toks, max_new=3, max_len=24)
    assert sum(engine.decode_trace_counts.values()) == base + 1
    engine.generate(toks, max_new=3, max_len=24)
    assert sum(engine.decode_trace_counts.values()) == base + 1


def test_serve_main_on_the_cpu():
    res = serve.main(["--arch", "zamba2-2.7b", "--batch", "3",
                      "--prompt-len", "10", "--max-new", "4",
                      "--device", "cpu"])
    assert tuple(res["tokens"].shape) == (3, 4)
    assert res["tokens"].dtype == torch.int32
    assert int(res["tokens"].min()) >= 0
    assert int(res["tokens"].max()) < get_config("zamba2-2.7b").vocab
    assert res["tok_per_s"] > 0


def test_serve_concurrent_schedule_is_bitwise_the_reference():
    argv = ["--arch", "llama3.2-1b", "--concurrent", "granite-moe-1b-a400m",
            "--batch", "2", "--prompt-len", "8", "--max-new", "2"]
    want = ref_serve.main(argv)
    got = serve.main(argv + ["--device", "cpu"])
    sw, sg = want["concurrent_schedule"], got["concurrent_schedule"]
    assert len(sg.steps) == len(sw.steps)
    assert sg.latency == sw.latency
    assert schedule_to_dict(sg) == ref_schedule_to_dict(sw)


def test_serve_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--max-new", "1"])
