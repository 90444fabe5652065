"""Training driver: ``python -m repro_torch.launch.train --arch llama3.2-1b``.

Port of ``repro.launch.train``: config registry -> parameters and
optimizer state on one device -> deterministic data pipeline -> train
step -> fault-managed loop with atomic checkpoints and exact resume
(params, optimizer and data cursor all round-trip).  It runs on the card
unless ``--device cpu``; the run uses deterministic kernels
(:func:`repro_torch.train.trainer.deterministic_training`), so a resumed
run repeats the uninterrupted one bit for bit.

``--reduced 1`` (the default) trains the reduced config of the same
family.  ``--model-axis N`` trains on a (ranks / N, N) mesh
(:func:`repro_torch.launch.mesh.make_host_mesh` over the ranks of the
process group, a one-rank group if there is none) through
``jit_train_step`` with ``Policy(mesh, fsdp=True)``, as the reference
always does; checkpoints then restore straight into the mesh's
placements.  Without it the step runs on one device.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..checkpoint import ckpt
from ..configs import ALL_ARCHS, get_config
from ..data.pipeline import DataConfig, SyntheticTokenSource
from ..fault.manager import FaultConfig, StragglerDetector, run_with_recovery
from ..models import model as M
from ..optim import adamw
from ..sharding import NamedSharding, P, Policy
from ..train import trainer as T
from .mesh import make_host_mesh

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "ckpt"


def _whole(x):
    """A metric as a plain value (a DTensor metric gathered)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", type=int, default=1,
                    help="train the reduced smoke config")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--model-axis", type=int, default=None,
                    help="train on a (ranks/N, N) data x model mesh")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass --device cpu to run on the host")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"device={device}")

    dc = DataConfig(global_batch=args.batch, seq_len=args.seq,
                    vocab=cfg.vocab, seed=args.seed,
                    embed_dim=cfg.d_model if cfg.modality_stub else 0,
                    encdec=cfg.block_pattern == "encdec")
    source = SyntheticTokenSource(dc)

    tc = T.TrainConfig(
        microbatches=args.microbatches,
        opt=adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                              total_steps=args.steps))
    params = M.init_params(cfg, torch.Generator(device).manual_seed(args.seed))
    opt_state = adamw.init_state(tc.opt, params)
    shardings = None
    if args.model_axis is None:
        step_fn = T.make_train_step(cfg, tc)
    else:
        mesh = make_host_mesh(args.model_axis, device=str(device))
        policy = Policy(mesh=mesh, fsdp=True)
        print(f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        step_fn = T.jit_train_step(cfg, tc, policy, M.param_shapes(cfg),
                                   source(0))
        pshard = T.param_shardings(policy, params)
        shardings = {"params": pshard,
                     "opt": {"mu": pshard, "nu": pshard,
                             "step": NamedSharding(mesh, P())}}

    state = {"params": params, "opt": opt_state}
    start = 0
    last = ckpt.latest_step(args.ckpt_dir)
    if last is not None:
        state, extra = ckpt.restore(args.ckpt_dir, state, shardings=shardings)
        start = SyntheticTokenSource.resume_step(extra["data"])
        print(f"resumed from checkpoint step {start}")

    losses: list[float] = []
    det = StragglerDetector(FaultConfig(), n_hosts=1)

    def one_step(i: int) -> None:
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in source(i).items()}
        p, o, met = step_fn(state["params"], state["opt"], batch)
        state["params"], state["opt"] = p, o
        losses.append(float(_whole(met["loss"])))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"lr {float(_whole(met.get('lr', 0))):.2e}")

    def save_fn(i: int) -> None:
        ckpt.save(args.ckpt_dir, i, state,
                  extra={"data": source.checkpoint_state(i)})

    def restore_fn() -> int:
        nonlocal state
        state, extra = ckpt.restore(args.ckpt_dir, state, shardings=shardings)
        return SyntheticTokenSource.resume_step(extra["data"])

    t0 = time.time()
    with T.deterministic_training():
        stats = run_with_recovery(
            one_step, start_step=start, total_steps=args.steps,
            cfg=FaultConfig(checkpoint_every=args.ckpt_every),
            save_fn=save_fn, restore_fn=restore_fn, detector=det)
    dt = time.time() - t0

    first = float(np.mean(losses[:5])) if len(losses) >= 5 else losses[0]
    final = float(np.mean(losses[-5:]))
    print(f"done: {len(losses)} steps in {dt:.1f}s "
          f"({dt/max(len(losses),1)*1e3:.0f} ms/step); "
          f"loss {first:.3f} -> {final:.3f}; restarts={stats.restarts}")
    return {"losses": losses, "stats": stats, "first": first, "final": final}


if __name__ == "__main__":
    main()
