"""End-to-end training example on PyTorch: a ~100M-parameter dense
LM trained for a few hundred steps on the deterministic synthetic
pipeline, with atomic checkpoints, exact resume, and fault-managed
stepping — the complete production path of launch/train.py at example
scale (the port of ``examples/train_e2e.py``).

The step runs through ``jit_train_step`` on a one-rank (data, model) mesh
(NCCL on the card, gloo with ``--device cpu``) with FSDP on, as the
reference's does, under deterministic kernels.  After the run, the last
checkpoint before the end is restored and the steps after it replayed:
the parameters must come back bit for bit.

Run:  PYTHONPATH=src python examples/torch_train_e2e.py [--steps 300]
      [--d-model 768] [--layers 12] [--device cpu]
(The warmup is 30 steps, or a tenth of a shorter run.)
"""
import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core.modelgraph import chain_device
from repro_torch.data.pipeline import DataConfig, SyntheticTokenSource
from repro_torch.fault.manager import FaultConfig, run_with_recovery
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.sharding import NamedSharding, P, Policy
from repro_torch.train import trainer as T

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--d-model", type=int, default=768)
ap.add_argument("--layers", type=int, default=12)
ap.add_argument("--vocab", type=int, default=4096)
ap.add_argument("--ckpt-dir", default=str(
    Path(__file__).resolve().parents[1] / "build" / "ckpt" / "e2e"))
ap.add_argument("--ckpt-every", type=int, default=100)
ap.add_argument("--lr", type=float, default=1e-3)
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
args = ap.parse_args()
device = chain_device(args.device)

# ~100M-parameter llama-family config (exact size printed below)
cfg = dataclasses.replace(
    get_config("llama3.2-1b"),
    name="llama-100m", n_layers=args.layers, d_model=args.d_model,
    n_heads=8, n_kv_heads=4, d_head=args.d_model // 8,
    d_ff=4 * args.d_model, vocab=args.vocab, dtype="float32", remat=False,
    q_chunk=64, kv_chunk=64)
print(f"config: {cfg.n_layers}L d={cfg.d_model} ff={cfg.d_ff} "
      f"vocab={cfg.vocab} -> {cfg.param_count()/1e6:.1f}M params")

mesh = make_host_mesh(device=device.type)
policy = Policy(mesh=mesh, fsdp=True)
source = SyntheticTokenSource(DataConfig(
    global_batch=args.batch, seq_len=args.seq, vocab=cfg.vocab))

tc = T.TrainConfig(opt=adamw.AdamWConfig(
    lr=args.lr, warmup_steps=min(30, max(args.steps // 10, 1)),
    total_steps=args.steps))
params = M.init_params(cfg, torch.Generator(device).manual_seed(0),
                       device=device)
opt_state = adamw.init_state(tc.opt, params)
step_fn = T.jit_train_step(cfg, tc, policy, M.param_shapes(cfg), source(0))
pshard = T.param_shardings(policy, params)
shardings = {"params": pshard, "opt": {"mu": pshard, "nu": pshard,
                                       "step": NamedSharding(mesh, P())}}

state = {"params": params, "opt": opt_state}
start = 0
if ckpt.latest_step(args.ckpt_dir) is not None:
    state, extra = ckpt.restore(args.ckpt_dir, state, shardings=shardings)
    start = SyntheticTokenSource.resume_step(extra["data"])
    print(f"resuming from step {start}")

losses = []
t0 = time.time()


def whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def train(i: int, log: bool = True) -> None:
    batch = {k: torch.from_numpy(v).to(device) for k, v in source(i).items()}
    p, o, met = step_fn(state["params"], state["opt"], batch)
    state["params"], state["opt"] = p, o
    if not log:
        return
    losses.append(float(whole(met["loss"])))
    if i % 20 == 0:
        dt = (time.time() - t0) / max(len(losses), 1)
        print(f"step {i:4d} loss {losses[-1]:7.4f} ({dt*1e3:.0f} ms/step)")


def restore_at(step: int) -> int:
    restored, extra = ckpt.restore(args.ckpt_dir, state, step=step,
                                   shardings=shardings)
    state.update(restored)
    return SyntheticTokenSource.resume_step(extra["data"])


try:
    with T.deterministic_training():
        run_with_recovery(
            train, start_step=start, total_steps=args.steps,
            cfg=FaultConfig(checkpoint_every=args.ckpt_every),
            save_fn=lambda i: ckpt.save(
                args.ckpt_dir, i, state,
                extra={"data": source.checkpoint_state(i)}),
            restore_fn=lambda: restore_at(ckpt.latest_step(args.ckpt_dir)))

        first = float(np.mean(losses[:10])) if len(losses) >= 10 \
            else losses[0]
        final = float(np.mean(losses[-10:]))
        print(f"\ntrained {len(losses)} steps: loss {first:.3f} -> "
              f"{final:.3f}")
        assert final < first, "loss did not decrease"
        print("loss decreased: OK")

        # exact resume: the last checkpoint before the end, replayed
        mid = (args.steps - 1) // args.ckpt_every * args.ckpt_every
        if start < mid < args.steps:
            end = [whole(x).clone() for x in M.tree_leaves(state["params"])]
            at = restore_at(mid)
            for i in range(at, args.steps):
                train(i, log=False)
            again = [whole(x) for x in M.tree_leaves(state["params"])]
            assert all(torch.equal(a, b) for a, b in zip(end, again)), \
                "the resumed run differs from the uninterrupted one"
            print(f"resumed from step {at}, replayed {args.steps - at} "
                  f"steps: parameters bitwise the uninterrupted run's: OK")
finally:
    dist.destroy_process_group()
