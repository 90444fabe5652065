"""FSDP's layer fetch and the Mamba-2 block's backward on four ``gloo``
ranks, against the meshless port.

One job of four rank processes (``torch.distributed`` over
``tcp://localhost``) runs every case once; the tests read its results:

* ``sharding.select_layer`` on an (8, 6, 4) stack whose layer dim is split
  over one mesh dim ((4, 1), and (2, 2) with the last dim split over
  ``model``) and over both ((2, 2)), for every layer: the forward is
  ``x[i]`` bit for bit, and so is the gradient of ``(inp @ x[i]) * v``,
  whole (``v`` alone) and as a partial sum (``inp``'s rows split over
  the layer's mesh dims, or over one of them): small integers, so that
  every sum is exact.  The bytes counted (``roofline.OpCounter``) are a
  broadcast of (n-1)/n of the layer a chip, and a reduce of as much where
  the gradient arrives as a partial sum;
* reduced Zamba2 and Llama (f32): the loss and every gradient of
  ``loss_fn`` on a (2, 2) mesh with FSDP (the layer stacks split over
  ``data``) and on a (1, 4) mesh, within 1e-5 of the meshless ones
  (relative to the largest): the Mamba-2 block's backward held in its
  forward's placements, and the embedding's gradient made whole over the
  batch's split where the vocab is split too (``sharding.lookup``).
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
import torch, torch.distributed as dist
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank,
                        world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.roofline import OpCounter
from repro_torch.models import model as M
from repro_torch.sharding import NamedSharding, Policy, select_layer
from repro_torch.train import trainer as T

out = {}
R, S0, S2 = Replicate(), Shard(0), Shard(2)
g = torch.Generator().manual_seed(0)
L, a, b, n = 8, 6, 4, 8
x0 = torch.randint(-4, 5, (L, a, b), generator=g).float()
inp = torch.randint(-4, 5, (n, a), generator=g).float()
v = torch.randint(-4, 5, (n, b), generator=g).float()
# name -> (mesh, the stack's placements, inp's (None: v alone))
cases = {"one": ((4, 1), (S0, R), (S0, R)),
         "one_whole": ((4, 1), (S0, R), None),
         "one_tp": ((2, 2), (S0, S2), (S0, R)),
         "two": ((2, 2), (S0, S0), (S0, S0)),
         "two_whole": ((2, 2), (S0, S0), None),
         "two_mixed": ((2, 2), (S0, S0), (S0, R))}
for name, (shape, pls, ipl) in cases.items():
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    rec = []
    for i in range(L):
        x = distribute_tensor(x0, mesh, pls).requires_grad_(True)
        dv = distribute_tensor(v if ipl is not None else v[:a], mesh, (R, R))
        di = None if ipl is None else distribute_tensor(inp, mesh, ipl)
        with OpCounter(track_memory=False) as c:
            y = select_layer(x, i)
            fwd = dict(c.collectives)
            loss = (((di @ y) if di is not None else y) * dv).sum()
            loss.backward()
        want = torch.zeros_like(x0)
        want[i] = inp.T @ v if ipl is not None else v[:a]
        local = y.to_local()
        rec.append({
            "forward": torch.equal(y.full_tensor(), x0[i]),
            "grad": torch.equal(x.grad.full_tensor(), want),
            "grad_placements": x.grad.placements == x.placements,
            "layer_bytes": local.numel() * local.element_size(),
            "forward_bytes": {k: b for k, b in fwd.items() if b},
            "bytes": {k: b for k, b in c.collectives.items() if b}})
    out[name] = rec
    out[name + "_ways"] = mesh.size() // (shape[1] if pls[1] != S0 else 1)

# -- reduced Zamba2 and Llama: loss and gradients on the mesh -----------------
for arch in ("zamba2-2.7b", "llama3.2-1b"):
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (8, 32), generator=g,
                                     dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (8, 32), generator=g,
                                     dtype=torch.int32)}
    l1, _, g1 = T.value_and_grad(cfg, params, batch)
    for model_axis in (2, 4):
        pol = Policy(make_host_mesh(model_axis, device="cpu"), fsdp=True)
        p2 = T.distribute_tree(params, T.param_shardings(pol, params))
        b2 = T.distribute_tree(batch, M.tree_map(
            lambda s: NamedSharding(pol.mesh, s), T.batch_pspecs(pol, batch)))
        with implicit_replication():
            l2, _, g2 = T.value_and_grad(cfg, p2, b2, pol)
        full = [x.full_tensor() for x in M.tree_leaves(g2)]
        stack = p2["blocks"]["mamba" if "mamba" in p2["blocks"] else
                                "attn"]
        out[f"{arch}_{model_axis}"] = {
            "loss": [float((l2.full_tensor() - l1).abs()), float(l1.abs())],
            "grads": [max(float((x - y).abs().max()) for x, y
                          in zip(full, M.tree_leaves(g1))),
                      max(float(y.abs().max()) for y in M.tree_leaves(g1))],
            "stack_split": [str(p) for p in
                            next(iter(stack.values())).placements]}
if rank == 0:
    with open(os.environ["OUT"], "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("select_layer") / "out.json"
    env = dict(os.environ, OUT=str(out), OMP_NUM_THREADS="1",
               INIT=f"tcp://localhost:{_free_port()}", WORLD_SIZE="4",
               PYTHONPATH=str(ROOT / "src"), PYTHONWARNINGS="ignore")
    procs = [subprocess.Popen([sys.executable, "-c", _JOB],
                              env=dict(env, RANK=str(r)), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(4)]
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


CASES = ["one", "one_whole", "one_tp", "two", "two_whole", "two_mixed"]


@pytest.mark.parametrize("case", CASES)
def test_select_layer_is_the_layer_bit_for_bit(job, case):
    for i, rec in enumerate(job[case]):
        assert rec["forward"] and rec["grad"] and rec["grad_placements"], \
            (i, rec)


@pytest.mark.parametrize("case", CASES)
def test_select_layer_moves_at_most_n_minus_1_over_n_of_the_layer(job, case):
    n = job[case + "_ways"]
    for rec in job[case]:
        most = (n - 1) / n * rec["layer_bytes"]
        assert rec["forward_bytes"] == {"broadcast": most}, rec
        backward = {k: b - rec["forward_bytes"].get(k, 0.0)
                    for k, b in rec["bytes"].items()}
        # a gradient that arrives whole stays on its owner
        reduced = {} if case.endswith("_whole") else {"reduce": most}
        assert {k: b for k, b in backward.items() if b} == reduced, rec


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "llama3.2-1b"])
@pytest.mark.parametrize("model_axis", [2, 4])
def test_gradients_on_the_mesh(job, arch, model_axis):
    rec = job[f"{arch}_{model_axis}"]
    for diff, scale in (rec["loss"], rec["grads"]):
        assert diff <= 1e-5 * (1 + scale), rec
    if model_axis == 2:
        # FSDP claimed the layer stacks' dim: select_layer fetched them
        assert rec["stack_split"][0] == "S(0)", rec
