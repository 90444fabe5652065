"""The Mamba-2 block on each rank's heads: four ``gloo`` ranks on a (1, 4)
mesh, and one rank on a (1, 1) mesh, against the meshless block.

One job of four rank processes (``torch.distributed`` over
``tcp://localhost``) runs reduced Zamba2's Mamba-2 block (f32, 8 heads,
two a rank) with its parameters placed as the trainer places them (the
input projection's columns and the output projection's rows split over
``model``):

* a sequence (2 x 40 tokens: enough that the input projection's column
  blocks are exchanged rather than the activations gathered): the output,
  the final state and, through a backward pass, the input's and every
  parameter's gradient, with the plain scan; the output and the final
  state again with ``use_kernel`` (on the CPU the kernel's plain version,
  through the kernels' mesh entry);
* four decode steps from that state, the state placed as the cache
  places it, with the plain step and through the kernel's entry (each
  rank's shard of the state updated in place): each step's output and
  state;

each within 1e-5 of the meshless block (relative to the largest value).
The job records where the scan ran: the plain scan on each rank's two
heads (its shard of xdt, whose offset is the rank's), the kernel's mesh
entry and each decode step on DTensors split on the head dim (the
kernel's step then on the rank's shard), and the final state split so.  A one-rank job on a (1, 1) mesh runs reduced
Zamba2's ``jit_prefill`` (with the kernels), two ``jit_decode_step``s
and a ``jit_train_step``: bit for bit the meshless ones.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_JOB = r'''
import json, os
import numpy as np
import torch, torch.distributed as dist
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank,
                        world_size=world)
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import cache_pspecs, tree_map
from repro_torch.sharding import NO_POLICY, NamedSharding, Policy, distribute
from repro_torch.train import trainer as T

cfg = get_config("zamba2-2.7b").reduced()
H = cfg.ssm_heads
rng = np.random.default_rng(0)
def draw(*shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            * scale)
p = L.mamba2_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                  "cpu")
B, S = 2, 40
x, gy = draw(B, S, cfg.d_model, scale=0.5), draw(B, S, cfg.d_model)
steps = [draw(B, 1, cfg.d_model, scale=0.5) for _ in range(4)]

def err(a, b):
    a = a.full_tensor() if hasattr(a, "full_tensor") else a
    return [float((a - b).abs().max()), float(b.abs().max())]

# where the scan ran: its operands' placements on the mesh (DTensor
# calls), and the heads of the plain scan's operands
seen = {"plain": [], "kernel": [], "step": [], "kernel_step": []}
plain, step, kernel = (L.chunked_linear_recurrence, L.linear_recurrence_step,
                       ops.ssd_scan)
kernel_step = ops.ssd_step
def record_plain(c, b, v, log_a, **kw):
    seen["plain"].append(list(v.shape))
    return plain(c, b, v, log_a, **kw)
def record_step(S, c, b, v, log_a):
    if hasattr(v, "placements"):
        seen["step"].append([str(tuple(t.placements)) for t in (S, v)])
    return step(S, c, b, v, log_a)
def record_kernel(c, b, v, log_a, **kw):
    if hasattr(v, "placements"):
        seen["kernel"].append(str(tuple(v.placements)))
    return kernel(c, b, v, log_a, **kw)
def record_kernel_step(S, c, b, v, log_a):
    # the mesh entry's call on DTensors, then its call on the rank's shard
    seen["kernel_step"].append(str(tuple(S.placements))
                               if hasattr(S, "placements") else
                               list(S.shape))
    return kernel_step(S, c, b, v, log_a)
L.chunked_linear_recurrence, L.linear_recurrence_step = record_plain, \
    record_step
ops.ssd_scan, ops.ssd_step = record_kernel, record_kernel_step

def run(pol, p, x, to):
    """The block over the sequence (its gradients), with the kernel, and
    four decode steps; ``to`` places a tree as the mesh does."""
    pd = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    xd = x.detach().requires_grad_(True)
    out, st = L.mamba2_block(pd, xd, cfg, pol)
    (out * to({"g": gy})["g"]).sum().backward()
    with torch.no_grad():
        ko, kst = L.mamba2_block(pd, xd, cfg, pol, use_kernel=True)
        # a decode step writes its state in place: the steps start from
        # a copy, and each step's state is kept as a copy
        state = to({"ssm": st["ssm"].clone(), "conv": st["conv"]},
                   cache=True)
        dec, kdec = [], []
        for t in steps:
            o, state = L.mamba2_block(pd, to({"t": t})["t"], cfg, pol,
                                      state=state)
            dec.append((o, state["ssm"].clone(), state["conv"]))
        # the same steps through the kernel's entry
        state = to({"ssm": st["ssm"].clone(), "conv": st["conv"]},
                   cache=True)
        for t in steps:
            o, state = L.mamba2_block(pd, to({"t": t})["t"], cfg, pol,
                                      state=state, use_kernel=True)
            kdec.append((o, state["ssm"].clone(), state["conv"]))
    return dict(out=out, ssm=st["ssm"], dx=xd.grad,
                grads={k: v.grad for k, v in pd.items()}, kernel=ko,
                kernel_ssm=kst["ssm"], decode=dec, kernel_decode=kdec)

want = run(NO_POLICY, p, x, lambda t, cache=False: t)
pol = Policy(make_host_mesh(4, device="cpu"))
mesh = pol.mesh
def to(tree, cache=False):
    specs = cache_pspecs(pol, tree) if cache else tree_map(
        lambda v: pol.guarded_spec(tuple(v.shape), "batch"), tree)
    return tree_map(lambda v, s: distribute(v, NamedSharding(mesh, s)),
                    tree, specs)
with implicit_replication():
    pm = T.distribute_tree({"mamba": p}, T.param_shardings(
        pol, {"mamba": p}))["mamba"]
    got = run(pol, pm, to({"x": x})["x"], to)
out = {
    "in_proj": str(tuple(pm["in_proj"].placements)),
    "prefill": [err(got["out"], want["out"]), err(got["ssm"], want["ssm"])],
    "kernel": [err(got["kernel"], want["kernel"]),
               err(got["kernel_ssm"], want["kernel_ssm"])],
    "train": [err(got["dx"], want["dx"])] + [
        err(got["grads"][k], want["grads"][k]) for k in sorted(p)],
    "decode": [[err(a, b) for a, b in zip(g, w)]
               for g, w in zip(got["decode"], want["decode"])],
    "kernel_decode": [[err(a, b) for a, b in zip(g, w)]
                      for g, w in zip(got["kernel_decode"],
                                      want["kernel_decode"])],
    "ssm_placements": [str(tuple(got[k].placements))
                       for k in ("ssm", "kernel_ssm")] + [
        str(tuple(s.placements)) for _, s, _ in got["decode"]
        + got["kernel_decode"]],
    # the meshless run's plain scan came first
    "plain": seen["plain"][1:], "kernel_calls": seen["kernel"],
    "step": seen["step"], "rank": rank,
    # the meshless run's four kernel steps came first
    "kernel_step": seen["kernel_step"][4:],
}
outs = [None] * world
dist.all_gather_object(outs, out)
if rank == 0:
    with open(os.environ["OUT"], "w") as f:
        json.dump(outs, f)
dist.destroy_process_group()
'''

# one rank, a (1, 1) mesh: every placement whole, so the mesh paths (the
# block on each rank's heads among them) must give the meshless bits
_JOB_11 = r'''
import dataclasses, json, os
import torch, torch.distributed as dist
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=0,
                        world_size=1)
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.serving import engine as E
from repro_torch.sharding import Policy
from repro_torch.train import trainer as T

def same(x, y):
    xs, ys = M.tree_leaves(x), M.tree_leaves(y)
    return len(xs) == len(ys) and all(
        torch.equal(a.full_tensor() if hasattr(a, "full_tensor") else a, b)
        for a, b in zip(xs, ys))

pol = Policy(make_host_mesh(1, device="cpu"), fsdp=True)
cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                          use_kernels=True)
params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
g = torch.Generator().manual_seed(1)
tokens = torch.randint(0, cfg.vocab, (2, 40), generator=g, dtype=torch.int32)
b = {"tokens": tokens}
l1, c1 = M.prefill(cfg, params, b, max_len=48)
l2, c2 = E.jit_prefill(cfg, pol, M.param_shapes(cfg), b, 48)(params, b)
ok = [same(l2, l1), same(c2, c1)]
tok = {"tokens": torch.argmax(l1[:, -1], -1)[:, None].to(torch.int32)}
dec = E.jit_decode_step(cfg, pol, M.param_shapes(cfg), c1, tok)
for _ in range(2):
    l1, c1 = M.decode_step(cfg, params, c1, tok)
    l2, c2 = dec(params, c2, tok)
    ok += [same(l2, l1), same(c2, c1)]
tc = T.TrainConfig(opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=10))
opt = adamw.init_state(tc.opt, params)
batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
p1, o1, m1 = T.make_train_step(cfg, tc)(params, opt, batch)
step = T.jit_train_step(cfg, tc, pol, M.param_shapes(cfg), batch)
p2, o2, m2 = step(params, opt, batch)
ok += [same(m2["loss"], m1["loss"]), same(p2, p1), same(o2, o1)]
with open(os.environ["OUT"], "w") as f:
    json.dump(ok, f)
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(tmp, job: str, ranks: int):
    out = tmp / "out.json"
    env = dict(os.environ, OUT=str(out), OMP_NUM_THREADS="1",
               INIT=f"tcp://localhost:{_free_port()}", WORLD_SIZE=str(ranks),
               PYTHONPATH=str(ROOT / "src"), PYTHONWARNINGS="ignore")
    procs = [subprocess.Popen([sys.executable, "-c", job],
                              env=dict(env, RANK=str(r)), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(ranks)]
    logs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            logs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("mamba2_heads"), _JOB, 4)


@pytest.fixture(scope="module")
def job_11(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("mamba2_heads_11"), _JOB_11, 1)


def _within(pairs, tol=1e-5):
    return all(diff <= tol * (1 + scale) for diff, scale in pairs)


@pytest.mark.parametrize("phase", ["prefill", "kernel", "train"])
def test_block_on_four_ranks_within_1e_5_of_meshless(job, phase):
    for rec in job:
        assert _within(rec[phase]), (rec["rank"], rec[phase])


def test_decode_steps_on_four_ranks_within_1e_5_of_meshless(job):
    for rec in job:
        assert len(rec["decode"]) == 4
        for i, errs in enumerate(rec["decode"]):
            assert _within(errs), (rec["rank"], i, errs)


def test_kernel_decode_steps_on_four_ranks_within_1e_5_of_meshless(job):
    for rec in job:
        assert len(rec["kernel_decode"]) == 4
        for i, errs in enumerate(rec["kernel_decode"]):
            assert _within(errs), (rec["rank"], i, errs)
        # each step through the kernel's mesh entry on the state split on
        # its heads, then on the rank's shard: 2 of 8 heads, N = P = 16
        assert rec["kernel_step"] == ["(Replicate(), Shard(dim=1))",
                                      [2, 2, 16, 16]] * 4, rec


def test_scan_and_state_on_each_ranks_heads(job):
    for rec in job:
        # the input projection's columns split over model: the column
        # blocks were exchanged
        assert rec["in_proj"] == "(Replicate(), Shard(dim=1))", rec
        # the plain scan on the rank's 2 of 8 heads, 40 tokens, P = 16
        assert rec["plain"] == [[2, 40, 2, 16]], rec["plain"]
        # the kernel's mesh entry took xdt split on its head dim
        assert rec["kernel_calls"] == ["(Replicate(), Shard(dim=2))"], rec
        # each decode step's state and xdt split on their head dim
        assert rec["step"] == [["(Replicate(), Shard(dim=1))"] * 2] * 4, rec
        assert set(rec["ssm_placements"]) == {"(Replicate(), Shard(dim=1))"}


def test_one_by_one_mesh_is_bitwise_meshless(job_11):
    # prefill logits and cache (the kernels' mesh entry), two decode
    # steps, a train step's loss, parameters and optimizer state
    assert all(job_11), job_11
