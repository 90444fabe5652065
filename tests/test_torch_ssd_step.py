"""The decode step of the gated linear recurrence, the state updated in
place (``repro_torch.kernels.ssd_step``, ``ops.ssd_step``), on the CPU.

* ``ssd_step_plain`` is ``layers.linear_recurrence_step`` bit for bit,
  with S' written over S and S returned, at Zamba2's decode head shape
  (N = P = 64) and the mLSTM's P = N + 1;
* ``mamba2_block`` and ``mlstm_block`` in decode, with the kernel's
  entry and with the plain step, return the state tensor they were
  given, updated;
* four ``decode_step(donate=True)`` steps of reduced Zamba2 and xLSTM,
  with the kernels and without, keep the cache's state where it was,
  with the values of the model's functional step
  (``linear_recurrence_step``, its result written over the state), and
  ``donate=False`` leaves the cache as it was;
* on a mesh (two ``gloo`` ranks in child processes) each rank steps its
  shard of the state in place, the operands placed as the state's heads;
  a state split on N is refused and left as it was.

The CUDA kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_step as st
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.sharding import NO_POLICY

ROOT = Path(__file__).resolve().parents[1]

# (B, H, N, P): Zamba2-2.7B's decode heads (N = P = 64) at a small batch
# and head count, and the mLSTM's P = N + 1 (xLSTM-125M: 384 / 385)
SHAPES = {"zamba2": (2, 3, 64, 64), "mlstm": (2, 2, 48, 49)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _operands(B, H, N, P, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * scale)
    S = draw(B, H, N, P, scale=0.5)
    c, b, v = (draw(*s).to(dtype) for s in ((B, H, N), (B, H, N), (B, H, P)))
    log_a = -torch.nn.functional.softplus(draw(B, H))
    return S, c, b, v, log_a


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_step_is_the_model_step_in_place(shape, dtype):
    S, c, b, v, la = _operands(*SHAPES[shape], DTYPES[dtype])
    before = S.clone()
    y_want, S_want = L.linear_recurrence_step(before, c, b, v, la)
    y, out = st.ssd_step_plain(S, c, b, v, la)
    assert out is S
    assert torch.equal(S, S_want) and not torch.equal(S, before)
    assert y.dtype == v.dtype and torch.equal(y, y_want)
    # ops takes the plain version for a CPU tensor, in place as well
    S2 = before.clone()
    y2, out2 = ops.ssd_step(S2, c, b, v, la)
    assert out2 is S2 and torch.equal(S2, S) and torch.equal(y2, y)


@pytest.mark.parametrize("which", ["c", "v", "log_a"])
def test_plain_step_refuses_shapes_that_disagree(which):
    S, c, b, v, la = _operands(2, 3, 8, 8, torch.float32)
    args = dict(c=c, b=b, v=v, log_a=la)
    args[which] = args[which][:, :2]
    before = S.clone()
    with pytest.raises(ValueError, match="disagree"):
        ops.ssd_step(S, args["c"], b, args["v"], args["log_a"])
    assert torch.equal(S, before)


def _zamba2_state(cfg, B, rng):
    H, N = cfg.ssm_heads, cfg.ssm_state
    P = cfg.ssm_d_inner // H
    conv_dim = cfg.ssm_d_inner + 2 * N * cfg.ssm_groups
    return {"ssm": torch.from_numpy(
                0.1 * rng.standard_normal((B, H, N, P), dtype=np.float32)),
            "conv": torch.from_numpy(0.5 * rng.standard_normal(
                (B, cfg.ssm_conv - 1, conv_dim), dtype=np.float32))}


def _mlstm_state(cfg, B, rng):
    H = cfg.n_heads
    dh = cfg.xlstm_d_inner // H
    return {"ssm": torch.from_numpy(
        0.1 * rng.standard_normal((B, H, dh, dh + 1), dtype=np.float32))}


BLOCKS = {"mamba2": ("zamba2-2.7b", L.mamba2_init, L.mamba2_block,
                     _zamba2_state),
          "mlstm": ("xlstm-125m", L.mlstm_init, L.mlstm_block, _mlstm_state)}


def _functional_step(S, *operands):
    """The model's functional step, its new state written over S."""
    y, S_new = L.linear_recurrence_step(S, *operands)
    S.copy_(S_new)
    return y, S


@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_decode_returns_the_state_it_was_given(block, monkeypatch):
    arch, init, fn, state_of = BLOCKS[block]
    cfg = get_config(arch).reduced()
    p = init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    rng = np.random.default_rng(1)
    B = 2
    state = state_of(cfg, B, rng)
    x = torch.from_numpy(0.5 * rng.standard_normal((B, 1, cfg.d_model),
                                                   dtype=np.float32))
    before = state["ssm"].clone()
    # the same block on a copy of the state, with the functional step
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(L, "_decode_step", lambda use_kernel: _functional_step)
        out_f, new_f = fn(p, x, cfg, NO_POLICY,
                          state=dict(state, ssm=before.clone()))
    for use_kernel in (True, False):
        S = before.clone()
        with torch.no_grad():
            out, new = fn(p, x, cfg, NO_POLICY, state=dict(state, ssm=S),
                          use_kernel=use_kernel)
        assert new["ssm"] is S and not torch.equal(S, before)
        assert torch.equal(out, out_f) and torch.equal(S, new_f["ssm"])


CACHE_KEY = {"zamba2-2.7b": "ssm", "xlstm-125m": "mlstm"}


def _prefilled(arch, use_kernels=True):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              use_kernels=use_kernels)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (2, 10),
                        generator=torch.Generator().manual_seed(1))
    _, cache = M.prefill(cfg, params, {"tokens": tok[:, :6]}, max_len=10)
    return cfg, params, tok, cache


def _steps(cfg, params, tok, cache, donate):
    logits = []
    with torch.no_grad():
        for t in range(6, 10):
            lg, cache = M.decode_step(cfg, params, cache,
                                      {"tokens": tok[:, t:t + 1]},
                                      donate=donate)
            logits.append(lg)
    return logits, cache


def _same(xs, ys) -> bool:
    return all(torch.equal(a, b) for a, b in zip(xs, ys))


@pytest.mark.parametrize("arch", list(CACHE_KEY))
def test_donated_decode_keeps_the_state_in_place(arch, monkeypatch):
    key = CACHE_KEY[arch]
    for use_kernels in (True, False):
        cfg, params, tok, cache = _prefilled(arch, use_kernels)
        kept = M.tree_map(torch.clone, cache)
        ptr = cache[key].data_ptr()
        got, out = _steps(cfg, params, tok, cache, donate=True)
        assert out is cache and cache[key].data_ptr() == ptr
        # the functional step, its state written over the cache's
        with monkeypatch.context() as m:
            m.setattr(L, "_decode_step", lambda use_kernel: _functional_step)
            want, ref = _steps(cfg, params, tok,
                               M.tree_map(torch.clone, kept), donate=True)
        assert _same(got, want)
        assert _same(M.tree_leaves(out), M.tree_leaves(ref))
        # without donation the cache is left as it was
        again, new = _steps(cfg, params, tok, kept, donate=False)
        assert new is not kept and torch.equal(new[key], out[key])
        assert _same(again, got)
        assert torch.equal(kept[key], _prefilled(arch, use_kernels)[3][key])


# two gloo ranks, a (2,) mesh: the state split on its heads, c whole, b
# split as the state, v split on batch (so it is placed as the state's
# heads first); each rank steps its two of four heads in place.  Then a
# state split on N, which the step refuses.
_MESH_JOB = r'''
import json, os
import torch, torch.distributed as dist
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank,
                        world_size=2)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from repro_torch.kernels import ops
from repro_torch.models import layers as L
g = torch.Generator().manual_seed(0)
B, H, N, P = 2, 4, 16, 17
S, c, b, v = (torch.randn(s, generator=g) for s in
              ((B, H, N, P), (B, H, N), (B, H, N), (B, H, P)))
la = -torch.nn.functional.softplus(torch.randn((B, H), generator=g))
mesh = init_device_mesh("cpu", (2,))
dS = distribute_tensor(S, mesh, [Shard(1)])
local, ptr = dS.to_local(), dS.to_local().data_ptr()
args = (distribute_tensor(b, mesh, [Shard(1)]),
        distribute_tensor(v, mesh, [Shard(0)]),
        distribute_tensor(la, mesh, [Shard(1)]))
y, out = ops.ssd_step(dS, c, *args)
y_want, S_want = L.linear_recurrence_step(S, c, b, v, la)
heads = slice(2 * rank, 2 * rank + 2)
res = {"same": out is dS, "in_place": dS.to_local().data_ptr() == ptr,
       "local": torch.allclose(local, S_want[:, heads], rtol=1e-6,
                               atol=1e-6),
       "state": torch.allclose(out.full_tensor(), S_want, rtol=1e-6,
                               atol=1e-6),
       "y_placed": str(tuple(y.placements)) == "(Shard(dim=1),)",
       "y": torch.allclose(y.full_tensor(), y_want, rtol=1e-6, atol=1e-6)}
dN = distribute_tensor(S, mesh, [Shard(2)])
try:
    ops.ssd_step(dN, c, *args)
    res["refused"] = False
except ValueError:
    res["refused"] = True
res["untouched"] = torch.equal(dN.full_tensor(), S)
outs = [None, None]
dist.all_gather_object(outs, res)
if rank == 0:
    with open(os.environ["OUT"], "w") as f:
        json.dump(outs, f)
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("ssd_step_mesh") / "out.json"
    env = dict(os.environ, OUT=str(out), OMP_NUM_THREADS="1",
               INIT=f"tcp://localhost:{_free_port()}",
               PYTHONPATH=str(ROOT / "src"), PYTHONWARNINGS="ignore")
    procs = [subprocess.Popen([sys.executable, "-c", _MESH_JOB],
                              env=dict(env, RANK=str(r)), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    return json.loads(out.read_text())


def test_a_mesh_state_is_stepped_in_place_on_each_ranks_heads(mesh_job):
    for rec in mesh_job:
        keys = ("same", "in_place", "local", "state", "y_placed", "y")
        assert all(rec[k] for k in keys), rec


def test_a_mesh_state_split_on_n_is_refused(mesh_job):
    for rec in mesh_job:
        assert rec["refused"] and rec["untouched"], rec
