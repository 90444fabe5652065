"""Tree checkpointing: atomic, manifest-driven, device-agnostic.

Port of ``repro.checkpoint.ckpt``, with the same layout on disk, so a
checkpoint written by either package restores in the other:

* each leaf is one ``.npy`` file keyed by its tree path (dict keys joined
  by ``/``, a list index as ``[i]``; the file name replaces ``/`` by
  ``__``);
* a JSON manifest records the leaves' keys, dtypes and shapes, the step
  and ``extra``.  It is written last and the directory renamed into
  place (tmp + rename), so a crash mid-save never corrupts the latest
  checkpoint;
* ``keep_last`` old checkpoints are garbage-collected after a successful
  save (never before).

bf16 leaves: NumPy has no bfloat16, so a bf16 leaf is saved as its bits
in a ``uint16`` array, with ``"dtype": "bfloat16"`` in the manifest, and
restored by the manifest's dtype (which also reads the reference's bf16
files, whose 2-byte elements carry the same bits).

On a mesh: a DTensor leaf is saved whole (every rank gathers it, rank 0
writes, and all wait for the write), and ``restore(..., shardings=)``
(a tree of :class:`repro_torch.sharding.NamedSharding` matching the
target) puts each leaf straight into its placements on the new mesh,
each rank keeping its shard — the elastic-rescale path.  Without
``shardings``, ``device=`` places plain tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any

import numpy as np
import torch

from ..models.model import (tree_flatten_with_path, tree_leaves,
                            tree_unflatten)
from ..sharding import distribute


def _key(path) -> str:
    return "/".join(f"[{p}]" if isinstance(p, int) else str(p)
                    for p in path) or "_root"


def _flatten(tree) -> list[tuple[str, Any]]:
    return [(_key(path), leaf) for path, leaf in tree_flatten_with_path(tree)]


def _is_writer() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to save, manifest dtype) of one gathered leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), \
                "bfloat16"
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, *, keep_last: int = 3,
         extra: dict | None = None) -> str:
    """Atomic checkpoint save; returns the checkpoint path.  Under a
    process group every rank calls it (DTensor leaves are gathered) and
    rank 0 writes."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    writer = _is_writer()
    arrays = []
    for key, leaf in _flatten(tree):
        # gathering a DTensor whole is a collective, so every rank calls
        # it; only the writer copies it to the host
        if hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()
        if writer:
            arrays.append((key, *_to_numpy(leaf)))
    if writer:
        _write(ckpt_dir, step, final, arrays, keep_last, extra)
    _barrier()
    return final


def _write(ckpt_dir: str, step: int, final: str, arrays, keep_last: int,
           extra: dict | None) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "time": time.time(), "extra": extra or {},
                "leaves": []}
    for key, arr, dtype in arrays:
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "key": key, "file": fname, "shape": list(arr.shape),
            "dtype": dtype})
    # manifest last + atomic rename = crash-safe
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _load(path: str, meta: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, meta["file"]))
    if meta["dtype"] == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore(ckpt_dir: str, target_tree, *, step: int | None = None,
            device=None, shardings=None) -> tuple[Any, dict]:
    """Restore into the structure of ``target_tree`` (tensors, or tensors
    on the ``meta`` device for shapes and dtypes only), each leaf in its
    target's dtype, on ``device`` (default: the target leaf's device, the
    CPU for a ``meta`` one).  ``shardings`` (a tree of NamedSharding
    matching the target) puts each leaf straight into its placements on
    that mesh instead.  Returns (tree, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {m["key"]: m for m in manifest["leaves"]}

    shard_leaves = (tree_leaves(shardings) if shardings is not None
                    else [None] * len(_flatten(target_tree)))
    out = []
    for (key, ref), shd in zip(_flatten(target_tree), shard_leaves):
        meta = by_key.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _load(path, meta)
        want_shape = tuple(ref.shape) if hasattr(ref, "shape") else \
            tuple(t.shape)
        if tuple(t.shape) != want_shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)} != target "
                             f"{want_shape}")
        dtype = ref.dtype if isinstance(ref, torch.Tensor) else t.dtype
        if shd is not None:
            dev = _mesh_device(shd.mesh)
            out.append(distribute(t.to(device=dev, dtype=dtype), shd))
            continue
        dev = device
        if dev is None:
            dev = ref.device if isinstance(ref, torch.Tensor) \
                and ref.device.type != "meta" else "cpu"
        out.append(t.to(device=dev, dtype=dtype))
    return tree_unflatten(target_tree, out), manifest.get("extra", {})


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")))
    for s in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
