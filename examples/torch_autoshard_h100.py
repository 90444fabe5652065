"""Beyond-paper mesh mode on the H100: BIDENT's search over sharding
strategies, and the emitted overrides applied to a real train step (the
port of ``examples/autoshard_tpu.py``).

1. Expand an assigned architecture into its fused-operator graph.
2. Run the BIDENT shortest-path search with sharding strategies as "PUs"
   (roofline node costs and resharding-collective edge costs on the
   H100 constants of ``repro_torch.core.autoshard``: the card's bf16 peak
   and HBM3 rate from its data sheet, a 16-wide ring over InfiniBand NDR
   between hosts, a launch and a hop measured on one card).
3. Emit Policy overrides from the schedule and run a train step under
   them through ``jit_train_step`` on a one-rank (data, model) mesh (NCCL
   on the card, gloo with ``--device cpu``): its loss must be the
   meshless step's, bit for bit, since one rank holds every shard.

Run:  PYTHONPATH=src python examples/torch_autoshard_h100.py [--device cpu]
"""
import argparse

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.autoshard import autoshard, emit_overrides
from repro_torch.core.modelgraph import chain_device, model_op_graph
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.sharding import Policy
from repro_torch.train import trainer as T

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device of the train step (default: the card)")
args = ap.parse_args()
device = chain_device(args.device)

# -- 1+2: search ----------------------------------------------------------
arch = "granite-moe-1b-a400m"
cfg = get_config(arch)
g = model_op_graph(cfg, kind="train", batch=256, seq=4096)
res = autoshard(g, d_data=16, d_model=16)
print(res.summary())
res_direct = autoshard(g, d_data=16, d_model=16, direct_reshard=True)
print(f"with direct-reshard refinement: "
      f"{res_direct.schedule.latency*1e3:.2f} ms "
      f"({res_direct.speedup:.2f}x vs best single strategy)")

# -- 3: apply overrides to a real train step ---------------------------------
# map the schedule's dominant strategies onto the model's constrain sites
overrides = emit_overrides({
    "moe_xe": "EP" if "EP" in res.schedule.assignment else "DP_TP",
    "mlp_h": "DP_TP",
    "attn_q": "DP_TP",
})
print(f"\nemitted overrides: {overrides}")

rcfg = cfg.reduced()
mesh = make_host_mesh(device=device.type)
try:
    policy = Policy(mesh=mesh, fsdp=True, overrides=overrides)
    params = M.init_params(rcfg, torch.Generator(device).manual_seed(0),
                           device=device)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, rcfg.vocab, (4, 33), generator=gen,
                           dtype=torch.int32).to(device)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    tc = T.TrainConfig()
    opt = adamw.init_state(tc.opt, params)
    step = T.jit_train_step(rcfg, tc, policy, M.param_shapes(rcfg), batch)
    with T.deterministic_training():
        _, _, met = step(params, opt, batch)
        _, _, ref = T.make_train_step(rcfg, tc)(params, opt, batch)
    loss = met["loss"].full_tensor()
    assert torch.equal(loss, ref["loss"]), (float(loss), float(ref["loss"]))
    print("ran jit_train_step under BIDENT-emitted shardings: OK "
          f"(loss {float(loss):.6f}, bitwise the meshless step's)")
finally:
    dist.destroy_process_group()
