"""Training in the port against the reference, in f32 on the CPU.

One parameter tree (drawn by the port's ``init_params``, as NumPy) and
one seeded batch go to both packages:

* gradients of ``loss_fn`` (autograd) against ``jax.value_and_grad`` for
  reduced llama3.2-1b, granite-moe-1b-a400m, zamba2-2.7b and xlstm-125m:
  the loss within 1e-5 relative, each gradient leaf within 1e-4 of its
  largest magnitude;
* ``make_train_step``, 3 steps with 1 and 2 microbatches and with top-k
  compression: losses within 1e-5 relative, params within 1e-4 of each
  leaf's largest magnitude.  AdamW's first steps divide each gradient
  element by its own magnitude (``nu``'s root), so an element whose
  gradient is near zero, where the two packages' gradients differ by
  f32 rounding (1.5e-6 of the largest), can take a visibly different
  step: with 2 microbatches one of 16384 elements moves 5.9e-5 (1.25e-4
  of the leaf's largest).  Such elements, at most 0.1% of a leaf, are
  held within steps x lr, the most an AdamW step moves an element;
* remat on and off give the same gradients in the port, bit for bit;
* ``launch.train.main`` with a ``RecoverableError`` injected at step 4
  resumes from step 3's checkpoint and ends bitwise where the
  uninterrupted run ends (losses and final checkpoint); with
  ``--model-axis 1`` it trains on a one-rank mesh, losses bitwise the
  run without a mesh, and it refuses a model axis the ranks cannot form;
* ``logical_axes_for`` names every parameter's axes as the reference
  does.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro.optim import adamw as radamw
from repro.optim import compress as rcompress
from repro.sharding import Policy as RPolicy
from repro.train import trainer as RT
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.fault.manager import RecoverableError
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.optim.compress import CompressionConfig
from repro_torch.train import trainer as T

B, SEQ = 2, 32
GRAD_ARCHS = ["llama3.2-1b", "granite-moe-1b-a400m", "zamba2-2.7b",
              "xlstm-125m"]


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    cfg = get_config(arch).reduced()
    params = M.tree_map(lambda x: x.numpy(), M.init_params(
        cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, SEQ)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, SEQ)).astype(np.int32)}
    return params, batch


def _torch(tree):
    return M.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves_close(got, want, rel, adam_step=None):
    """Every leaf within ``rel`` of its largest magnitude; with
    ``adam_step`` (steps x lr), at most 0.1% of a leaf's elements may lie
    past that, within ``adam_step``."""
    g, w = M.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        d = np.abs(a - b)
        off = d > rel * scale
        if adam_step is None:
            assert not off.any(), (a.shape, float(d.max()), scale)
        else:
            assert off.mean() <= 1e-3 and float(d.max()) <= adam_step, \
                (a.shape, int(off.sum()), float(d.max()), scale)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_gradients_match_jax(arch):
    np_params, b = _inputs(arch)
    cfg = ref_config(arch).reduced()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(cfg, p, jb), has_aux=True))(
            jax.tree.map(jnp.asarray, np_params))
    loss, met, grads = T.value_and_grad(get_config(arch).reduced(),
                                        _torch(np_params), _torch(b))
    assert abs(float(loss) - float(rloss)) <= 1e-5 * abs(float(rloss))
    assert set(met) >= {"nll", "zloss", "aux", "tokens"}
    _leaves_close(grads, rgrads, 1e-4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_remat_gives_the_same_gradients(arch):
    np_params, b = _inputs(arch)
    cfg = get_config(arch).reduced()
    on = T.value_and_grad(dataclasses.replace(cfg, remat=True),
                          _torch(np_params), _torch(b))
    off = T.value_and_grad(cfg, _torch(np_params), _torch(b))
    assert torch.equal(on[0], off[0])
    for a, c in zip(M.tree_leaves(on[2]), M.tree_leaves(off[2])):
        assert torch.equal(a, c)


@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False),
                                                   (1, True)])
def test_train_step_three_steps_match_reference(microbatches, compress):
    arch = "llama3.2-1b"
    np_params, _ = _inputs(arch)
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    opt = dict(lr=2e-3, warmup_steps=2, total_steps=10)
    tc = T.TrainConfig(microbatches=microbatches,
                       opt=adamw.AdamWConfig(**opt),
                       compress=CompressionConfig(k_frac=0.1)
                       if compress else None)
    rtc = RT.TrainConfig(microbatches=microbatches,
                         opt=radamw.AdamWConfig(**opt),
                         compress=rcompress.CompressionConfig(k_frac=0.1)
                         if compress else None)
    p, rp = _torch(np_params), jax.tree.map(jnp.asarray, np_params)
    if compress:
        from repro_torch.optim.compress import init_residual
        st = {"opt": adamw.init_state(tc.opt, p), "residual": init_residual(p)}
        rst = {"opt": radamw.init_state(rtc.opt, rp),
               "residual": rcompress.init_residual(rp)}
    else:
        st, rst = adamw.init_state(tc.opt, p), radamw.init_state(rtc.opt, rp)
    step = T.make_train_step(cfg, tc)
    rstep = jax.jit(RT.make_train_step(rcfg, rtc, RPolicy()))
    rng = np.random.default_rng(5)
    for i in range(3):
        b = {"tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)}
        p, st, met = step(p, st, _torch(b))
        rp, rst, rmet = rstep(rp, rst, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        assert abs(float(met["loss"]) - float(rmet["loss"])) <= \
            1e-5 * abs(float(rmet["loss"]))
        _leaves_close(p, rp, 1e-4, adam_step=(i + 1) * opt["lr"])
    opt_state = st["opt"] if compress else st
    assert int(opt_state["step"]) == 3


def test_microbatch_split_sums_gradients_in_f32():
    """Two microbatches of a batch give the mean loss and the mean of
    their gradients (within f32 rounding of the full batch's)."""
    np_params, b = _inputs("llama3.2-1b")
    cfg = get_config("llama3.2-1b").reduced()
    l1, _, g1 = T.value_and_grad(cfg, _torch(np_params), _torch(b))
    halves = [T.value_and_grad(cfg, _torch(np_params),
                               {k: torch.from_numpy(v[i:i + 1])
                                for k, v in b.items()}) for i in range(2)]
    assert abs(float(halves[0][0] + halves[1][0]) / 2 - float(l1)) < 1e-5
    for a, c, full in zip(M.tree_leaves(halves[0][2]),
                          M.tree_leaves(halves[1][2]), M.tree_leaves(g1)):
        torch.testing.assert_close((a + c) / 2, full, atol=1e-5, rtol=1e-4)


def test_logical_axes_match_reference():
    for arch in ALL_ARCHS:
        rcfg = ref_config(arch).reduced()
        want = [RT.logical_axes_for(path, leaf.shape) for path, leaf in
                jax.tree_util.tree_flatten_with_path(RM.param_shapes(rcfg))[0]]
        got = [T.logical_axes_for(path, leaf.shape) for path, leaf in
               M.tree_flatten_with_path(M.param_shapes(
                   get_config(arch).reduced()))]
        assert got == want, arch


def _train_args(ckpt_dir):
    return ["--device", "cpu", "--reduced", "1", "--arch", "llama3.2-1b",
            "--steps", "6", "--batch", "4", "--seq", "16",
            "--ckpt-every", "3", "--ckpt-dir", str(ckpt_dir),
            "--log-every", "100"]


def test_train_driver_resumes_exactly_after_an_injected_fault(
        tmp_path, monkeypatch):
    clean = launch_train.main(_train_args(tmp_path / "clean"))
    fired = []

    class FailsOnce(launch_train.SyntheticTokenSource):
        def __call__(self, step):
            if step == 4 and not fired:
                fired.append(step)
                raise RecoverableError("injected at step 4")
            return super().__call__(step)

    monkeypatch.setattr(launch_train, "SyntheticTokenSource", FailsOnce)
    hurt = launch_train.main(_train_args(tmp_path / "hurt"))
    assert fired == [4]
    assert clean["stats"].restarts == 0 and hurt["stats"].restarts == 1
    # steps 0-3, then step 3 again from its checkpoint, then 4-5
    assert len(hurt["losses"]) == 7
    assert hurt["losses"][:4] + hurt["losses"][5:] == clean["losses"]
    assert hurt["losses"][4] == clean["losses"][3]
    target = {"params": M.param_shapes(get_config("llama3.2-1b").reduced())}
    target["opt"] = adamw.init_state(adamw.AdamWConfig(), target["params"])
    a, ea = ckpt.restore(str(tmp_path / "clean"), target)
    b, eb = ckpt.restore(str(tmp_path / "hurt"), target)
    assert ea == eb == {"data": {"step": 6, "seed": 0}}
    for x, y in zip(M.tree_leaves(a), M.tree_leaves(b)):
        assert torch.equal(x, y)
    assert sorted(os.listdir(tmp_path / "hurt")) == ["step_00000003",
                                                    "step_00000006"]


def test_train_driver_on_a_one_rank_mesh(tmp_path):
    import torch.distributed as dist
    clean = launch_train.main(_train_args(tmp_path / "clean"))
    try:
        mesh = launch_train.main(_train_args(tmp_path / "mesh")
                                 + ["--model-axis", "1"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert mesh["losses"] == clean["losses"]
    assert sorted(os.listdir(tmp_path / "mesh")) == ["step_00000003",
                                                     "step_00000006"]


def test_train_driver_refuses_the_mesh_and_needs_the_card(tmp_path):
    """``--model-axis`` now trains on a mesh (``test_torch_mesh.py``); a
    model axis the process group's ranks cannot form is refused."""
    import torch.distributed as dist
    try:
        with pytest.raises(ValueError, match="does not divide"):
            launch_train.main(_train_args(tmp_path) + ["--model-axis", "2"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(["--ckpt-dir", str(tmp_path)])
