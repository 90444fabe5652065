"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step once on
fake tensors over a fake 256- or 512-rank process group.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell's jitted step over 512 host devices and reads XLA's memory and cost
analyses.  Here, for each cell:

  1. a fake process group (``torch.distributed``'s ``fake`` backend) of
     256 or 512 ranks is started in this process, and the production mesh
     ((16,16) single-pod / (2,16,16) multi-pod) is built on it;
  2. parameters, optimizer state, batch and cache are DTensors with the
     policy's placements, each rank's local shard a tensor on the
     ``meta`` device (shapes, no storage);
  3. the train / prefill / serve step (``jit_train_step``, ``jit_prefill``,
     ``jit_decode_step``) runs once on them under
     :class:`repro_torch.launch.roofline.OpCounter`, which counts the
     bytes of every collective DTensor issues and the peak of one rank's
     live local bytes;
  4. the same step runs once more without a mesh, at global shapes, on
     plain ``meta`` tensors, under :func:`repro_torch.launch.roofline.count_ops`
     (the counterpart of the reference's ``count_jaxpr`` of the step), in
     a child process beside step 3: global FLOPs and fused bytes, per
     chip / n_chips;
  5. the roofline terms are taken against the H100's constants.

Fields XLA alone gives (``gen_code_bytes``, ``hlo_flops_body_once``,
``compile_s``) are recorded as ``null``.  One process holds one process
group, so a fake group never shares a process with a real one: ``main``
runs the cells of each mesh in a child process of their own.

Where the record's measure differs from the reference's (numbers from
both packages' dry-runs on an 8-core CPU host; the reference through its
production mesh with ``Auto`` axes):

* ``bytes_per_device`` is the peak of one rank's live local bytes during
  the eager step (inputs included).  The reference sums XLA's argument,
  output and temp sizes after buffer reuse, and counts a donated output
  again: at ``deepseek-v3-671b|decode_32k|2x16x16`` it reports 51.98 GiB
  = arguments 13.79 + output 8.58 (the decode cache, 8.58 of it aliased
  to its argument) + temp 29.62, where the temp holds f32 copies of the
  whole stacked latent cache (14.50 GiB) and of the stacked expert
  weights (6.34 GiB) converted outside the layer loop.  The port converts
  one layer at a time and updates the cache in place: 14.07 GiB, of which
  arguments 13.81.  At ``llama3.2-1b|train_4k|16x16`` the two agree
  closer: 13.46 GiB here against 15.51.
* On the host DTensor turns an all-to-all into an all-gather and a
  chunk, so the collective bytes of a Shard-to-Shard redistribution are
  those of the all-gather.  GSPMD realigns a split whose bounds move (the
  SwiGLU halves, Mamba-2's input projection) with a collective-permute
  of the activation; DTensor splits evenly and would gather it, so the
  port cuts the weight into its column blocks instead
  (``sharding.column_blocks``): each rank receives only the columns its
  blocks hold, by an all-to-all over the model axis, and the backward
  sends their gradients back the same way.  At reduced Llama's train on a
  (4, 4) mesh that is 4.92e4 B a chip each way, where the weight's
  all-gather and its gradient's were 1.97e5 each.
* The Mamba-2 block runs its conv and scan on each rank's heads (the
  heads split as the ff axis splits z), with B and C whole; their
  gradient, and the block's parameters', return as partial sums that
  the input projection's backward carries on, so that the block's input
  gradient is made whole once, as the attention's is (its k/v gradients
  partial sums over the q heads' split).  A decode step takes the
  state's head split from the cache and gathers none of it.
* FSDP on the stacked layer dim fetches one layer at a time
  (``sharding.select_layer``): a broadcast from the rank that holds it,
  and in the backward a reduce of its gradient to that rank.  The
  reference's compiled step all-gathers the stack instead, and
  reduce-scatters its gradient.  On a ring both move (n-1)/n of a layer
  a chip for each layer, and the record counts them as the kinds
  ``broadcast`` and ``reduce``, which the reference's record never has.
  At reduced Llama's prefill on a (4, 4) mesh that is 1.49e5 B a chip
  of broadcast, against the reference's 1.49e5 B of all-gather.  Before,
  the layer was an all-reduce of a partial sum: 2.98e5 B, twice as much.

Results accumulate in a JSON file so the sweep is resumable.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

from ..configs import ALL_ARCHS, get_config
from .specs import (HBM_BW, LINK_BW, PEAK_FLOPS, SHAPE_CELLS,
                    cell_applicable, input_specs, model_flops)


def _mesh_key(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def start_fake_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks (this process is rank
    0); reused when one of that size exists."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world_size or dist.get_backend() != "fake":
            raise RuntimeError(
                f"this process holds a {dist.get_backend()} group of "
                f"{dist.get_world_size()} ranks; the dry-run needs a fake "
                f"group of {world_size} in a process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _placed_meta(tree, shardings):
    """DTensors shaped like ``tree``'s leaves with the placements in
    ``shardings``, each rank's shard on the ``meta`` device."""
    from ..models import model as M
    from ..sharding import sharded_zeros
    return M.tree_map(lambda x, s: sharded_zeros(x.shape, x.dtype, "meta", s),
                      tree, shardings)


def _local_bytes(tree) -> int:
    from ..models import model as M
    total = 0
    for x in M.tree_leaves(tree):
        loc = x.to_local() if hasattr(x, "to_local") else x
        total += loc.numel() * loc.element_size()
    return int(total)


def global_counts(cfg, cell, microbatches: int, state_dtype: str) -> dict:
    """The cell's step without a mesh at global shapes, on ``meta``
    tensors, under :func:`repro_torch.launch.roofline.count_ops`: global
    FLOPs, fused bytes and matmul FLOPs, and the seconds it took."""
    import torch

    from ..models import model as M
    from ..optim import adamw
    from ..train import trainer as T
    from .roofline import count_ops
    t0 = time.time()
    specs = input_specs(cfg, cell)
    params_shapes = M.param_shapes(cfg)

    def full(tree):
        return M.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                                device="meta"), tree)
    gp, gb = full(params_shapes), full(specs["batch"])
    if cell.kind == "train":
        tc = T.TrainConfig(microbatches=microbatches,
                           opt=adamw.AdamWConfig(state_dtype=state_dtype))
        raw = T.make_train_step(cfg, tc)
        gargs = (gp, full(adamw.init_state(tc.opt, params_shapes)), gb)
    elif cell.kind == "prefill":
        def raw(p, b):
            return M.prefill(cfg, p, b, max_len=specs["max_len"])
        gargs = (gp, gb)
    else:
        def raw(p, c, b):
            return M.decode_step(cfg, p, c, b, donate=True)
        gargs = (gp, full(specs["cache"]), gb)
    tot = count_ops(raw, *gargs)
    tot["seconds"] = time.time() - t0
    return tot


def count_pool() -> ProcessPoolExecutor:
    """One ``spawn`` worker for :func:`global_counts` (close it with
    ``shutdown``)."""
    return ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
        "spawn"))


def lower_cell(arch: str, shape: str, multi_pod: bool,
               fsdp: bool = True, microbatches: int = 1,
               overrides: dict | None = None,
               sp: bool = False, serve_layout: str | None = None,
               train_layout: str | None = None, *,
               cfg=None, batch: int | None = None, seq: int | None = None,
               mesh_shape: tuple | None = None, pool=None,
               peak_top: int = 0):
    """Run one cell's step on ``meta`` shards; returns the result record.

    ``sp`` / ``serve_layout`` / ``train_layout`` select the layouts of
    ``sharding.make_rules``.  ``cfg``, ``batch``, ``seq`` and
    ``mesh_shape`` (with axes (data, model) or (pod, data, model)) cut a
    cell to a small size, for tests.  ``pool`` (a ``spawn`` process pool,
    see :func:`count_pool`) runs the global count; without one the cell
    starts its own.  ``peak_top`` > 0 adds ``peak_tensors``, the largest
    storages live at the peak of ``bytes_per_device``
    (:meth:`repro_torch.launch.roofline.OpCounter.peak_tensors`)."""
    import dataclasses

    cfg = cfg if cfg is not None else get_config(arch)
    cell = SHAPE_CELLS[shape]
    if batch is not None or seq is not None:
        cell = dataclasses.replace(cell, batch=batch or cell.batch,
                                   seq=seq or cell.seq)
    mesh_name = (_mesh_key(multi_pod) if mesh_shape is None
                 else "x".join(map(str, mesh_shape)))
    ok, why = cell_applicable(cfg, cell)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "sp": sp, "serve_layout": serve_layout,
           "train_layout": train_layout}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    # bf16 optimizer state for the giant configs
    state_dtype = "bfloat16" if cfg.param_count() > 5e10 else "float32"
    # the global count runs in a child process beside the mesh run; it
    # starts first, so the child's start overlaps this process's imports,
    # group and mesh
    own = pool is None
    pool = count_pool() if own else pool
    counts = pool.submit(global_counts, cfg, cell, microbatches, state_dtype)

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models import model as M
    from ..optim import adamw
    from ..serving import engine as E
    from ..sharding import NamedSharding, P, Policy, make_rules
    from ..train import trainer as T
    from .mesh import make_production_mesh
    from .roofline import OpCounter, collective_bytes

    if serve_layout in ("1d", "2d"):
        fsdp = False        # params stationary; no per-step FSDP gathers
    if mesh_shape is None:
        n_chips = 512 if multi_pod else 256
        start_fake_group(n_chips)
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        n_chips = 1
        for s in mesh_shape:
            n_chips *= s
        start_fake_group(n_chips)
        axes = (("pod", "data", "model") if len(mesh_shape) == 3
                else ("data", "model"))
        mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                mesh_dim_names=axes)
    policy = Policy(mesh=mesh, fsdp=fsdp, overrides=overrides or {},
                    rules=make_rules(sp=sp, serve_layout=serve_layout,
                                     train_layout=train_layout))
    params_shapes = M.param_shapes(cfg)
    specs = input_specs(cfg, cell)
    rep = NamedSharding(mesh, P())
    tc = T.TrainConfig(microbatches=microbatches,
                       opt=adamw.AdamWConfig(state_dtype=state_dtype))
    t0 = time.time()
    counter = OpCounter(peak_top=peak_top)
    with implicit_replication():
        params = _placed_meta(params_shapes,
                              T.param_shardings(policy, params_shapes))
        batch_d = _placed_meta(specs["batch"], M.tree_map(
            lambda s: NamedSharding(mesh, s),
            T.batch_pspecs(policy, specs["batch"])))
        if cell.kind == "train":
            opt_meta = adamw.init_state(tc.opt, params_shapes)
            pshard = T.param_shardings(policy, params_shapes)
            opt = _placed_meta(opt_meta, {"mu": pshard, "nu": pshard,
                                          "step": rep})
            step = T.jit_train_step(cfg, tc, policy, params_shapes,
                                    specs["batch"])
            args = (params, opt, batch_d)
        elif cell.kind == "prefill":
            step = E.jit_prefill(cfg, policy, params_shapes, specs["batch"],
                                 max_len=specs["max_len"])
            args = (params, batch_d)
        else:  # decode
            cache = _placed_meta(specs["cache"], E.cache_shardings(
                policy, specs["cache"]))
            step = E.jit_decode_step(cfg, policy, params_shapes,
                                     specs["cache"], specs["batch"])
            args = (params, cache, batch_d)
        arg_bytes = _local_bytes(args)
        counter.hold(args)
        with counter:
            out = step(*args)
        out_bytes = _local_bytes(out)
        del out, args, params, batch_d
    t_run = time.time() - t0

    try:
        tot = counts.result()
    finally:
        if own:
            pool.shutdown()
    t_count = tot["seconds"]

    coll = collective_bytes(counter)
    flops = tot["flops"] / n_chips
    bytes_acc = tot["bytes"] / n_chips
    coll_total = sum(coll.values())
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_acc / HBM_BW
    t_coll = coll_total / LINK_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, cell)
    mf_per_chip = mf / n_chips
    peak = int(counter.peak)
    rec.update(
        status="ok",
        n_chips=n_chips,
        lower_s=round(t_run, 1),
        count_s=round(t_count, 1),
        compile_s=None,
        bytes_per_device=peak,
        temp_bytes=max(peak - arg_bytes, 0),
        arg_bytes=arg_bytes,
        out_bytes=out_bytes,
        gen_code_bytes=None,
        flops_per_chip=flops,
        bytes_per_chip=bytes_acc,
        matmul_flops_total=tot["matmul_flops"],
        hlo_flops_body_once=None,
        collective_bytes_per_chip=coll_total,
        collectives=coll,
        collective_counts=dict(counter.collective_counts),
        roofline={
            "compute_s": t_compute,
            "memory_s": t_memory,
            "collective_s": t_coll,
            "dominant": dominant,
        },
        model_flops_total=mf,
        model_flops_per_chip=mf_per_chip,
        useful_flop_ratio=(mf_per_chip / flops) if flops else None,
    )
    if peak_top:
        rec["peak_tensors"] = counter.peak_tensors()
    return rec


def _run_cells(args, multi_pod: bool, results: dict) -> None:
    with count_pool() as pool:
        _run_cells_with(args, multi_pod, results, pool)


def _run_cells_with(args, multi_pod: bool, results: dict, pool) -> None:
    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = (list(SHAPE_CELLS) if (args.all or not args.shape)
              else [args.shape])
    for arch in archs:
        for shape in shapes:
            key = f"{arch}|{shape}|{_mesh_key(multi_pod)}"
            if key in results and results[key].get("status") in (
                    "ok", "skipped") and not args.force:
                print(f"[cached] {key}")
                continue
            print(f"[fake run] {key} ...", flush=True)
            try:
                rec = lower_cell(arch, shape, multi_pod, fsdp=bool(args.fsdp),
                                 microbatches=args.microbatches, sp=args.sp,
                                 serve_layout=args.serve_layout,
                                 train_layout=args.train_layout, pool=pool)
            except Exception as e:      # one cell's failure is its record
                rec = {"arch": arch, "shape": shape,
                       "mesh": _mesh_key(multi_pod), "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            results[key] = rec
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
            if rec["status"] == "ok":
                r = rec["roofline"]
                print(f"  ok: {rec['lower_s']}s, "
                      f"{rec['bytes_per_device']/2**30:.2f} GiB/dev, "
                      f"dominant={r['dominant']} "
                      f"(c={r['compute_s']*1e3:.2f}ms "
                      f"m={r['memory_s']*1e3:.2f}ms "
                      f"coll={r['collective_s']*1e3:.2f}ms)", flush=True)
            else:
                print(f"  {rec['status']}: "
                      f"{rec.get('reason', rec.get('error'))}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel residual activations (train)")
    ap.add_argument("--serve-layout", default=None,
                    choices=["legacy", "1d", "2d"],
                    help="decode-path layout")
    ap.add_argument("--train-layout", default=None, choices=["tp", "dp"],
                    help="train-path layout")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells already in the results file")
    args = ap.parse_args(argv)

    if args.both_meshes:
        # one process per mesh: a process holds one (fake) group
        base = [a for a in (argv if argv is not None else sys.argv[1:])
                if a not in ("--both-meshes", "--multi-pod")]
        for mp in (False, True):
            subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            *base, *(["--multi-pod"] if mp else [])],
                           check=True)
        return

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    _run_cells(args, args.multi_pod, results)

    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"\n== dry-run summary: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"(of {len(results)} cells) ==")


if __name__ == "__main__":
    main()
