"""The port's checkpoints: round trip, latest and GC, no partial save
after a crash, and the same layout on disk as the reference's, so a
checkpoint written by either package restores in the other.

* f32 and int trees cross both ways bit for bit, with the same keys,
  file names, shapes and dtypes in the manifest;
* bf16 leaves, as found: the port saves their bits as ``uint16`` with
  ``"dtype": "bfloat16"`` and restores them bit for bit, the reference's
  bf16 files included; the reference restores neither its own bf16
  files (NumPy has no cast from their 2-byte void elements) nor the
  port's (it casts the ``uint16`` bits as integers).
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as rckpt
from repro_torch.checkpoint import ckpt
from repro_torch.models import model as M


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal((8, 16))
                                  .astype(np.float32)),
            "b": {"w": torch.arange(12, dtype=torch.int32).reshape(3, 4),
                  "s": torch.tensor(3.5)},
            "l": [torch.ones(3), torch.zeros((2, 2))]}


def _np(t):
    return M.tree_map(lambda x: x.numpy(), t)


def _bits(x):
    x = x.detach().cpu() if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.array(x))
    return x.reshape(-1).view(torch.uint8)


def _bitwise(got, want) -> bool:
    g, w = M.tree_leaves(got), M.tree_leaves(want)
    return len(g) == len(w) and all(
        a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape)
        and torch.equal(_bits(a), _bits(b)) for a, b in zip(g, w))


def test_roundtrip(tmp_path):
    t = _tree()
    t["h"] = torch.randn(5, 3, generator=torch.Generator().manual_seed(1)
                         ).to(torch.bfloat16)
    ckpt.save(str(tmp_path), 7, t, extra={"data": {"step": 7, "seed": 0}})
    target = M.tree_map(lambda x: torch.empty_like(x, device="meta"), t)
    restored, extra = ckpt.restore(str(tmp_path), target)
    assert _bitwise(restored, t)
    assert all(x.device.type == "cpu" for x in M.tree_leaves(restored))
    assert extra["data"]["step"] == 7
    again, _ = ckpt.restore(str(tmp_path), t, step=7, device="cpu")
    assert _bitwise(again, t)


def test_latest_and_gc(tmp_path):
    t = _tree()
    for s in (10, 20, 30, 40, 50):
        ckpt.save(str(tmp_path), s, t, keep_last=2)
    assert ckpt.latest_step(str(tmp_path)) == 50
    kept = sorted(glob.glob(os.path.join(str(tmp_path), "step_*")))
    assert [os.path.basename(k) for k in kept] == ["step_00000040",
                                                   "step_00000050"]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), t)


def test_atomic_no_partial(tmp_path):
    """A .tmp directory left by a crash is never picked up as latest, and
    a checkpoint directory without its manifest does not count."""
    t = _tree()
    ckpt.save(str(tmp_path), 10, t)
    os.makedirs(os.path.join(str(tmp_path), "step_00000099.tmp"))
    os.makedirs(os.path.join(str(tmp_path), "step_00000098"))
    assert ckpt.latest_step(str(tmp_path)) == 10
    ckpt.save(str(tmp_path), 11, t)       # a crashed tmp is cleared
    assert ckpt.latest_step(str(tmp_path)) == 11


def test_restore_checks_keys_and_shapes(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(str(tmp_path), {**t, "extra": torch.ones(1)})
    bad = {**t, "a": torch.zeros(4, 4)}
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), bad)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    t = _tree(2)
    rckpt.save(str(tmp_path), 3, M.tree_map(jnp.asarray, _np(t)),
               extra={"data": {"step": 3, "seed": 0}})
    restored, extra = ckpt.restore(str(tmp_path), t)
    assert _bitwise(restored, t) and extra["data"]["step"] == 3


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    t = _tree(3)
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    ckpt.save(str(port_dir), 4, t, extra={"x": 1})
    rckpt.save(str(ref_dir), 4, M.tree_map(jnp.asarray, _np(t)),
               extra={"x": 1})
    # the same layout: keys, files, shapes and dtypes
    man = [json.load(open(d / "step_00000004" / "manifest.json"))
           for d in (port_dir, ref_dir)]
    assert man[0]["leaves"] == man[1]["leaves"]
    target = jax.eval_shape(lambda: M.tree_map(jnp.asarray, _np(t)))
    restored, extra = rckpt.restore(str(port_dir), target)
    assert extra == {"x": 1}
    for a, b in zip(jax.tree.leaves(restored), M.tree_leaves(_np(t))):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))


def test_bf16_leaves_across_the_packages_as_found(tmp_path):
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32)
                         ).to(torch.bfloat16)
    tree = {"w": w}
    # the reference's bf16 file: 2-byte void elements, the same bits
    rckpt.save(str(tmp_path / "ref"), 1,
               {"w": jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)})
    got, _ = ckpt.restore(str(tmp_path / "ref"), tree)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(
        got["w"].view(torch.int16), w.view(torch.int16))
    with pytest.raises(ValueError):
        rckpt.restore(str(tmp_path / "ref"),
                      {"w": jnp.zeros((6, 5), jnp.bfloat16)})
    # the port's bf16 file: uint16 bits, "bfloat16" in the manifest
    path = ckpt.save(str(tmp_path / "port"), 1, tree)
    meta = json.load(open(os.path.join(path, "manifest.json")))["leaves"][0]
    assert meta["dtype"] == "bfloat16"
    assert np.load(os.path.join(path, meta["file"])).dtype == np.uint16
    got, _ = ckpt.restore(str(tmp_path / "port"), tree)
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    cast, _ = rckpt.restore(str(tmp_path / "port"),
                            {"w": jnp.zeros((6, 5), jnp.bfloat16)})
    ints = w.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(np.asarray(cast["w"], np.float32),
                                  np.asarray(jnp.asarray(ints).astype(
                                      jnp.bfloat16), np.float32))


def test_training_state_round_trips(tmp_path):
    """A reduced model's params (bf16) and AdamW state (f32, int32 step)
    round-trip bitwise, in the train driver's tree."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    state = {"params": params,
             "opt": adamw.init_state(adamw.AdamWConfig(), params)}
    state["opt"]["step"] += 5
    ckpt.save(str(tmp_path), 5, state)
    restored, _ = ckpt.restore(str(tmp_path), state)
    assert _bitwise(restored, state)
