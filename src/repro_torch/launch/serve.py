"""Serving driver: ``python -m repro_torch.launch.serve --arch qwen3-8b``.

Port of ``repro.launch.serve``: batched prefill + greedy decode of a
reduced model of the zoo (random weights from ``--seed``) through
``Engine``, on the card unless ``--device cpu``.  With ``--concurrent
arch2`` it co-schedules two models' request streams using BIDENT's joint
(i, j) search over their fused-operator graphs (full widths, analytic
costs), as the reference does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ALL_ARCHS, get_config
from ..core import (ContentionModel, EDGE_PUS, EdgeSoCCostModel,
                    solve_concurrent_joint)
from ..core.modelgraph import model_op_graph
from ..models import model as M
from ..serving.engine import Engine
from ..sharding import Policy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ALL_ARCHS)
    ap.add_argument("--concurrent", default=None, choices=ALL_ARCHS,
                    help="co-schedule a second model's stream")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass --device cpu to run on the host")
    cfg = get_config(args.arch).reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, gen)
    engine = Engine(cfg=cfg, params=params, policy=Policy())

    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len), dtype=np.int32)).to(device)
    t0 = time.time()
    out = engine.generate(prompts, max_new=args.max_new)
    out_host = out.cpu()                      # waits for the card
    dt = time.time() - t0
    tps = args.batch * args.max_new / dt
    print(f"{cfg.name}: generated {tuple(out.shape)} in {dt:.2f}s "
          f"({tps:.1f} tok/s, greedy, batched, {device})")

    result = {"tokens": out_host, "tok_per_s": tps}
    if args.concurrent:
        # BIDENT joint co-schedule of the two models' operator graphs
        cfg2 = get_config(args.concurrent)
        g1 = model_op_graph(get_config(args.arch), kind="decode",
                            batch=args.batch, seq=2048)
        g2 = model_op_graph(cfg2, kind="decode", batch=args.batch, seq=2048)
        m = EdgeSoCCostModel()
        t1, t2 = m.build_table(g1), m.build_table(g2)
        sched = solve_concurrent_joint(
            list(range(len(g1))), t1, list(range(len(g2))), t2,
            EDGE_PUS, ContentionModel())
        print(f"concurrent co-schedule {args.arch} + {args.concurrent}: "
              f"{len(sched.steps)} steps, predicted makespan "
              f"{sched.latency*1e3:.2f} ms")
        result["concurrent_schedule"] = sched
    engine.release()
    return result


if __name__ == "__main__":
    main()
