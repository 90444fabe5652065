"""The port on a mesh: two ``gloo`` ranks on the CPU, against the
meshless port.

One job of two rank processes (``torch.distributed`` over
``tcp://localhost``) runs every case once; the tests read its results.
All in f32 at reduced widths:

* a Llama train step through ``jit_train_step`` at (2, 1) with FSDP
  (which lands on the layer-stack dim) and at (1, 2) (TP), and at (1, 2)
  for a GQA whose kv heads the model axis cuts (6 q / 3 kv heads: the
  plain attention on each rank's q heads, k/v gradients as partial
  sums): loss and every parameter within atol = rtol = 1e-5 of the
  meshless step;
* ``jit_prefill`` and three ``jit_decode_step``s of Llama and Zamba2 at
  (1, 2), heads sharded, with ``use_kernels`` (so ``flash_attention`` and
  ``ssd_scan`` take their mesh entry, counted), of DeepSeek-V3 (MLA's
  latent decode scores, the MoE combine with the experts split over
  ``model``), and of Llama and DeepSeek-V3 under ``serve_layout="1d"``
  (the cache's kv_len split, written token by token on the rank that
  holds the row), and of the 6 q / 3 kv heads model plain and under
  ``"1d"``: logits and every cache leaf within 1e-5 of the meshless
  ``prefill`` / ``decode_step``;
* one rank on a (1, 1) mesh (a job of its own): Llama's prefill, two
  decode steps and a train step, and the same for the 6 q / 3 kv heads
  model, bit for bit the meshless ones;
* the kernels' mesh entries called directly: q heads sharded with kv
  heads replicated (GQA groups that split evenly, a group wider than a
  rank's q heads, and q heads that cut a group), a split of the
  sequence (gathered first), the SSD scan with its heads sharded and
  with N split: each within 1e-6 of the plain version on the whole
  tensors;
* the elastic case: 3 steps on (2, 1), a checkpoint, ``restore(...,
  shardings=)`` onto (1, 2), 3 more steps: parameters within 1e-6 of
  the uninterrupted 6 steps on (2, 1) (relative to the largest), the
  restored tree bitwise the saved one, and only the writing rank copied
  the checkpoint's leaves to the host;
* ``make_host_mesh`` spans the group's ranks and refuses a model axis
  that does not divide them.

Marked ``gpu``: one test per kernel entry on a DTensor of a (1, 1) CUDA
mesh, bitwise its meshless launch (skipped without a card).
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_JOB = r'''
import json, os, sys, dataclasses
import torch, torch.distributed as dist
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank,
                        world_size=world)
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.serving import engine as E
from repro_torch.sharding import NamedSharding, P, Policy, make_rules
from repro_torch.train import trainer as T
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

out = {}
def err(a, b):
    a = a.full_tensor() if hasattr(a, "full_tensor") else a
    b = b.full_tensor() if hasattr(b, "full_tensor") else b
    return float((a.float() - b.float()).abs().max()), \
        float(b.float().abs().max())
def tree_err(x, y):
    es = [err(a, b) for a, b in zip(M.tree_leaves(x), M.tree_leaves(y))]
    return max(e for e, _ in es), max(s for _, s in es)

meshes = {"2x1": make_host_mesh(1, device="cpu"),
          "1x2": make_host_mesh(2, device="cpu")}
out["mesh_shapes"] = {k: list(m.shape) for k, m in meshes.items()}
try:
    make_host_mesh(3, device="cpu")
    out["refused_3"] = False
except ValueError:
    out["refused_3"] = True

# GQA whose kv heads the model axis does not divide (3 kv heads at TP 2;
# each rank's 3 q heads cut a group), beside reduced Llama's 4 / 2
def cut_groups(cfg):
    return dataclasses.replace(cfg, n_heads=6, n_kv_heads=3)

def batch_of(cfg, B, S, seed):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                    dtype=torch.int32),
            "labels": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                    dtype=torch.int32)}

# -- train steps ------------------------------------------------------------
tc = T.TrainConfig(opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=10))
for cname, cfg in (("", get_config("llama3.2-1b").reduced()),
                   ("_cut", cut_groups(get_config("llama3.2-1b").reduced()))):
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    opt = adamw.init_state(tc.opt, params)
    batch = batch_of(cfg, 4, 32, 1)
    p1, o1, m1 = T.make_train_step(cfg, tc)(params, opt, batch)
    for name, fsdp in (("2x1", True), ("1x2", True)):
        if cname and name == "2x1":
            continue
        pol = Policy(meshes[name], fsdp=fsdp)
        step = T.jit_train_step(cfg, tc, pol, M.param_shapes(cfg), batch)
        p2, o2, m2 = step(params, opt, batch)
        out[f"train_{name}{cname}"] = {"loss": err(m2["loss"], m1["loss"]),
                                       "params": tree_err(p2, p1),
                                       "opt": tree_err(o2, o1)}
        out[f"train_{name}{cname}_layer_dim"] = [
            str(p) for p in p2["blocks"]["attn"]["wq"].placements]
cfg = get_config("llama3.2-1b").reduced()
params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
opt = adamw.init_state(tc.opt, params)
batch = batch_of(cfg, 4, 32, 1)

# -- prefill and decode ---------------------------------------------------------
calls = {"flash_attention": 0, "ssd_scan": 0}
from repro_torch.models import layers as L
from repro_torch.sharding import split_ways
cut_calls = [0]
plain_shards = L.attention_shards
def counted_shards(q, k, v):
    # the plain attention on a mesh whose q-head split cuts the kv groups
    cut_calls[0] += k.shape[2] % split_ways(q, 2) != 0
    return plain_shards(q, k, v)
L.attention_shards = counted_shards
for name in list(calls):
    orig = getattr(ops, f"_{name}_mesh")
    def counted(*a, _orig=orig, _name=name, **k):
        calls[_name] += 1
        return _orig(*a, **k)
    setattr(ops, f"_{name}_mesh", counted)
serve_cases = (("llama3.2-1b", None), ("zamba2-2.7b", None),
               ("deepseek-v3-671b", None), ("llama3.2-1b", "1d"),
               ("deepseek-v3-671b", "1d"), ("llama3.2-1b", "cut"),
               ("llama3.2-1b", "cut-1d"))
for arch, layout in serve_cases:
    cfg = dataclasses.replace(get_config(arch).reduced(), use_kernels=True)
    if layout and layout.startswith("cut"):
        cfg = cut_groups(cfg)
        layout = layout[4:] or None
        arch = arch + "-cut"
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    pol = Policy(meshes["1x2"], rules=make_rules(serve_layout=layout))
    b = {"tokens": batch_of(cfg, 2, 24, 2)["tokens"]}
    ML = 32
    l1, c1 = M.prefill(cfg, params, b, max_len=ML)
    pre = E.jit_prefill(cfg, pol, M.param_shapes(cfg), b, ML)
    l2, c2 = pre(params, b)
    rec = {"prefill": [err(l2, l1), tree_err(c2, c1)], "decode": []}
    tok = {"tokens": torch.argmax(l1[:, -1], -1)[:, None].to(torch.int32)}
    dec = E.jit_decode_step(cfg, pol, M.param_shapes(cfg), c1, tok)
    for _ in range(3):
        l1, c1 = M.decode_step(cfg, params, c1, tok)
        l2, c2 = dec(params, c2, tok)
        rec["decode"].append([err(l2, l1), tree_err(c2, c1)])
    rec["cache_placements"] = [str(tuple(x.placements))
                               for x in M.tree_leaves(c2)]
    rec["cache_specs"] = [list(s) for s in
                          M.tree_leaves(E.cache_pspecs(pol, c1))]
    if cfg.n_experts:
        rec["w_up_spec"] = list(
            T.param_pspecs(pol, params)["moe_blocks"]["moe"]["w_up"])
    out[f"serve_{arch}" + (f"-{layout}" if layout else "")] = rec
out["mesh_calls"] = dict(calls)
out["cut_calls"] = cut_calls[0]

# -- the kernels' mesh entries ---------------------------------------------------
mesh = meshes["1x2"]
R, S0, S1, S2, S3 = Replicate(), Shard(0), Shard(1), Shard(2), Shard(3)
def dt(x, pl):
    return distribute_tensor(x, mesh, pl)
g = torch.Generator().manual_seed(3)
attn = {}
for Hq, Hk, qpl in ((4, 2, (R, S2)), (4, 1, (R, S2)), (6, 3, (R, S2)),
                    (4, 2, (R, S1)), (4, 2, (S0, R))):
    q = torch.randn(2, 16, Hq, 16, generator=g)
    k = torch.randn(2, 16, Hk, 16, generator=g)
    v = torch.randn(2, 16, Hk, 16, generator=g)
    ref = ops.flash_attention(q, k, v, causal=True)
    o = ops.flash_attention(dt(q, qpl), dt(k, (R, R)), dt(v, (R, R)),
                            causal=True)
    attn[f"{Hq}/{Hk}/{qpl}"] = [err(o, ref)[0], str(tuple(o.placements))]
out["attention"] = attn
scan = {}
for cpl in ((R, S2), (R, S3), (S0, R)):
    c = torch.randn(2, 24, 4, 16, generator=g)
    b_ = torch.randn(2, 24, 4, 16, generator=g)
    v = torch.randn(2, 24, 4, 8, generator=g)
    la = -torch.rand(2, 24, 4, generator=g)
    s0 = torch.randn(2, 4, 16, 8, generator=g)
    y1, st1 = ops.ssd_scan(c, b_, v, la, initial_state=s0, chunk=8)
    y2, st2 = ops.ssd_scan(dt(c, cpl), dt(b_, (R, S2)), dt(v, (R, S2)),
                           dt(la, (R, S2)), initial_state=s0, chunk=8)
    scan[str(cpl)] = [err(y2, y1)[0], err(st2, st1)[0],
                      str(tuple(y2.placements))]
out["scan"] = scan

# -- elastic: (2, 1) -> checkpoint -> (1, 2) -----------------------------------------
cfg = get_config("llama3.2-1b").reduced()
params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
opt = adamw.init_state(tc.opt, params)
pa, pb = Policy(meshes["2x1"], fsdp=True), Policy(meshes["1x2"], fsdp=True)
sa = T.jit_train_step(cfg, tc, pa, M.param_shapes(cfg), batch)
sb = T.jit_train_step(cfg, tc, pb, M.param_shapes(cfg), batch)
batches = [batch_of(cfg, 4, 32, 10 + i) for i in range(6)]
p, o = params, opt
for i in range(6):
    p, o, _ = sa(p, o, batches[i])
full = (p, o)
p, o = params, opt
for i in range(3):
    p, o, _ = sa(p, o, batches[i])
ck = os.environ["CKPT"]
host_copies = [0]
to_numpy = ckpt._to_numpy
def counted_to_numpy(leaf):
    host_copies[0] += 1
    return to_numpy(leaf)
ckpt._to_numpy = counted_to_numpy
ckpt.save(ck, 3, {"params": p, "opt": o})
ckpt._to_numpy = to_numpy
out["host_copies"] = [None] * world
dist.all_gather_object(out["host_copies"], host_copies[0])
out["n_leaves"] = len(M.tree_leaves({"params": p, "opt": o}))
pshard = T.param_shardings(pb, params)
shards = {"params": pshard, "opt": {"mu": pshard, "nu": pshard,
                                    "step": NamedSharding(pb.mesh, P())}}
state, _ = ckpt.restore(ck, {"params": params, "opt": opt},
                        shardings=shards)
out["restored_bitwise"] = tree_err(state["params"], p)[0] == 0.0 and \
    tree_err(state["opt"], o)[0] == 0.0
out["restored_placements"] = str(tuple(
    state["params"]["blocks"]["attn"]["wq"].placements))
p, o = state["params"], state["opt"]
for i in range(3, 6):
    p, o, _ = sb(p, o, batches[i])
out["elastic"] = [tree_err(p, full[0]), tree_err(o, full[1])]
if rank == 0:
    with open(os.environ["OUT"], "w") as f:
        json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
'''


# one rank, a (1, 1) mesh: every placement Replicate, so the mesh code
# paths (the plain attention on each rank's shards among them) must give
# the meshless bits
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
base = get_config("llama3.2-1b").reduced()
out = {}
for name, cfg in (("llama3.2-1b", base),
                  ("llama3.2-1b-cut", dataclasses.replace(
                      base, n_heads=6, n_kv_heads=3))):
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=g,
                           dtype=torch.int32)
    b = {"tokens": tokens}
    l1, c1 = M.prefill(cfg, params, b, max_len=32)
    l2, c2 = E.jit_prefill(cfg, pol, M.param_shapes(cfg), b, 32)(params, b)
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
    out[name] = ok
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
    tmp = tmp_path_factory.mktemp("mesh")
    out = tmp / "out.json"
    env = dict(os.environ, WORLD_SIZE="2", OUT=str(out),
               CKPT=str(tmp / "ckpt"), OMP_NUM_THREADS="1",
               INIT=f"tcp://localhost:{_free_port()}",
               PYTHONPATH=str(ROOT / "src"), PYTHONWARNINGS="ignore")
    procs = [subprocess.Popen([sys.executable, "-c", _JOB],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
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
def job_11(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh11") / "out.json"
    env = dict(os.environ, OUT=str(out), OMP_NUM_THREADS="1",
               INIT=f"tcp://localhost:{_free_port()}",
               PYTHONPATH=str(ROOT / "src"), PYTHONWARNINGS="ignore")
    proc = subprocess.run([sys.executable, "-c", _JOB_11], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def _within(e, tol=1e-5):
    diff, scale = e
    return diff <= tol + tol * scale


def test_host_mesh_spans_the_group(job):
    assert job["mesh_shapes"] == {"2x1": [2, 1], "1x2": [1, 2]}
    assert job["refused_3"]


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "1x2_cut"])
def test_train_step_on_the_mesh(job, mesh):
    rec = job[f"train_{mesh}"]
    assert _within(rec["loss"]) and _within(rec["params"]) \
        and _within(rec["opt"]), rec
    if mesh == "2x1":
        # FSDP claimed the layer-stack dim: each layer gathered alone
        assert job["train_2x1_layer_dim"][0] == "S(0)"


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b",
                                  "deepseek-v3-671b", "llama3.2-1b-1d",
                                  "deepseek-v3-671b-1d", "llama3.2-1b-cut",
                                  "llama3.2-1b-cut-1d"])
def test_prefill_and_decode_on_the_mesh(job, arch):
    rec = job[f"serve_{arch}"]
    for e in [rec["prefill"]] + rec["decode"]:
        logits, cache = e
        assert _within(logits) and _within(cache), rec
    if arch.endswith("-1d"):
        # serve_layout "1d": the cache's kv_len dim split over the model
        # axis, so each token is written by the rank that holds its row
        assert any(spec[2] == "model" for spec in rec["cache_specs"]
                   if len(spec) > 2), rec["cache_specs"]
    elif arch.endswith("-cut"):
        # 3 kv heads do not split 2 ways: the cache's heads stay whole
        assert not any("Shard" in p for p in rec["cache_placements"])
    elif arch.startswith("deepseek"):
        # the latent cache has no heads; the experts split over model
        assert rec["w_up_spec"][1] == "model", rec["w_up_spec"]
    else:
        # the heads (kv heads of the attention cache, state heads of the
        # SSM) split over the model axis
        assert any("Shard" in p for p in rec["cache_placements"])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama3.2-1b-cut"])
def test_one_by_one_mesh_is_bitwise_meshless(job_11, arch):
    # prefill logits and cache, two decode steps, a train step's loss,
    # parameters and optimizer state: bit for bit
    assert all(job_11[arch]), job_11[arch]


def test_plain_attention_ran_on_cut_groups(job):
    # the train steps' forward and backward and the "cut" prefills ran the
    # plain attention on q heads that cut the kv groups, with no gather
    assert job["cut_calls"] >= 4, job["cut_calls"]


def test_kernels_took_their_mesh_entry(job):
    assert job["mesh_calls"]["flash_attention"] >= 2     # Llama's 2 layers
    assert job["mesh_calls"]["ssd_scan"] >= 2            # Zamba2's layers


def test_gqa_heads_sharded_kv_replicated(job):
    for case, (e, pl) in job["attention"].items():
        assert e <= 1e-6, (case, e)
        # q's batch or head split is kept; a seq split was gathered first
        assert "Shard(dim=1)" not in pl, case


def test_ssd_scan_heads_sharded(job):
    for case, (ey, es, pl) in job["scan"].items():
        assert ey <= 1e-6 and es <= 1e-6, case
        assert "Shard(dim=3)" not in pl


def test_elastic_resume(job):
    assert job["restored_bitwise"]
    # every rank gathers each leaf; only the writer copies it to the host
    assert job["host_copies"] == [job["n_leaves"], 0], job["host_copies"]
    assert job["restored_placements"] != "(Shard(dim=0), Replicate())"
    for diff, scale in job["elastic"]:
        assert diff <= 1e-6 * max(scale, 1.0), job["elastic"]


# -- on the card -----------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1)
    yield mesh
    dist.destroy_process_group()


def _rep(mesh, *xs):
    from torch.distributed.tensor import Replicate, distribute_tensor
    return [distribute_tensor(x, mesh, [Replicate(), Replicate()])
            for x in xs]


@pytest.mark.gpu
def test_flash_attention_mesh_entry_on_the_card(cuda_mesh):
    from repro_torch.kernels import ops
    g = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 256, 8, 64, device="cuda", generator=g,
                           dtype=torch.bfloat16) for _ in range(3))
    k, v = k[:, :, :2].contiguous(), v[:, :, :2].contiguous()
    o = ops.flash_attention(*_rep(cuda_mesh, q, k, v), causal=True)
    assert torch.equal(o.to_local(), ops.flash_attention(q, k, v))


@pytest.mark.gpu
def test_ssd_scan_mesh_entry_on_the_card(cuda_mesh):
    from repro_torch.kernels import ops
    g = torch.Generator("cuda").manual_seed(1)
    c, b = (torch.randn(2, 128, 4, 64, device="cuda", generator=g)
            for _ in range(2))
    v = torch.randn(2, 128, 4, 32, device="cuda", generator=g)
    la = -torch.rand(2, 128, 4, device="cuda", generator=g)
    y, s = ops.ssd_scan(*_rep(cuda_mesh, c, b, v, la), chunk=64)
    y0, s0 = ops.ssd_scan(c, b, v, la, chunk=64)
    assert torch.equal(y.to_local(), y0) and torch.equal(s.to_local(), s0)


@pytest.mark.gpu
def test_ssd_step_mesh_entry_on_the_card(cuda_mesh):
    # the state's local shard updated in place by one launch, bitwise the
    # meshless step on Zamba2's decode head shape
    from repro_torch import kernels
    from repro_torch.kernels import ops
    g = torch.Generator("cuda").manual_seed(3)
    S = torch.randn(2, 4, 64, 64, device="cuda", generator=g)
    c, b = (torch.randn(2, 4, 64, device="cuda", generator=g,
                        dtype=torch.bfloat16) for _ in range(2))
    v = torch.randn(2, 4, 64, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    la = -torch.rand(2, 4, device="cuda", generator=g)
    dS, *ops_ = _rep(cuda_mesh, S.clone(), c, b, v, la)
    ptr = dS.to_local().data_ptr()
    kernels.reset_launch_counts()
    y, out = ops.ssd_step(dS, *ops_)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ssd_step"] == 1
    y0, s0 = ops.ssd_step(S, c, b, v, la)
    assert out is dS and dS.to_local().data_ptr() == ptr
    assert torch.equal(y.to_local(), y0) and torch.equal(dS.to_local(), s0)


@pytest.mark.gpu
def test_expert_glu_mesh_entry_on_the_card(cuda_mesh):
    from repro_torch.kernels import ops
    g = torch.Generator("cuda").manual_seed(2)
    x = torch.randn(4, 64, 128, device="cuda", generator=g)
    wu = torch.randn(4, 128, 256, device="cuda", generator=g) * 0.1
    wd = torch.randn(4, 128, 128, device="cuda", generator=g) * 0.1
    y = ops.expert_glu(*_rep(cuda_mesh, x, wu, wd))
    assert torch.equal(y.to_local(), ops.expert_glu(x, wu, wd))
