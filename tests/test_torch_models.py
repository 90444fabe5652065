"""The port's model zoo against the reference, arch by arch, in f32.

For each of the ten archs, reduced, with ``use_kernels`` False and True,
on one parameter tree as NumPy (drawn by the port's ``init_params``; the
reference takes it as ``jnp`` arrays, the port through
``params_from_numpy``) and seeded NumPy inputs:

* ``forward`` logits and aux and ``loss_fn``'s value;
* ``prefill`` logits and every cache leaf;
* four ``decode_step``s after prefill: logits and every cache leaf;

match ``repro.models.model`` within atol = rtol = 5e-5.  The measured
worst error is about 1.2e-5 (relative to 1 + |value|), so 5e-5 is the
reference's own 2e-4 bound (``tests/test_kernel_integration_compress.py``)
tightened by four.  With ``use_kernels`` the reference runs its Pallas
kernels in interpret mode and the port the kernels' plain versions (the
tensors lie on the CPU).

Also: the parameter tree (keys, shapes, dtypes) equals the reference's
(full and reduced), ``params_from_numpy`` takes the reference's own
``init_params`` bit for bit,
``init_params`` is a function of its generator, and ``decode_step``
leaves its cache alone unless asked to update it in place.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro_torch.configs import get_config
from repro_torch.models import model as M

TOL = dict(atol=5e-5, rtol=5e-5)
B, T, N_PRE, N_DEC = 2, 20, 14, 4


def _batch(cfg, rng):
    b = {}
    if cfg.block_pattern == "encdec" or cfg.modality_stub:
        b["embeds"] = (rng.standard_normal((B, T, cfg.d_model)) * 0.1
                       ).astype(np.float32)
    if cfg.block_pattern == "encdec" or not cfg.modality_stub:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    b["labels"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    return b


def _prompt(cfg, b):
    if cfg.block_pattern == "encdec":       # the encoder sees all frames
        return {"embeds": b["embeds"], "tokens": b["tokens"][:, :N_PRE]}
    return {k: v[:, :N_PRE] for k, v in b.items() if k != "labels"}


def _step_input(cfg, b, t):
    if cfg.modality_stub and cfg.block_pattern != "encdec":
        return {"embeds": b["embeds"][:, t:t + 1]}
    return {"tokens": b["tokens"][:, t:t + 1]}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """The parameters (drawn by the port's ``init_params``, as a NumPy
    tree both packages take) and the batch."""
    cfg = get_config(arch).reduced()
    params = M.tree_map(lambda x: x.numpy(), M.init_params(
        cfg, torch.Generator().manual_seed(0)))
    return params, _batch(cfg, np.random.default_rng(0))


@functools.lru_cache(maxsize=None)
def _reference(arch, use_kernels):
    """The reference's outputs as NumPy: forward, loss, then prefill and
    N_DEC decode steps (each jitted once)."""
    cfg = dataclasses.replace(ref_config(arch).reduced(),
                              use_kernels=use_kernels)
    params, b = _inputs(arch)
    params = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    out = {}
    if not use_kernels:      # forward and loss never take the kernels
        logits, aux = jax.jit(functools.partial(RM.forward, cfg))(params, jb)
        loss, _ = jax.jit(functools.partial(RM.loss_fn, cfg))(params, jb)
        out["forward"] = [_np(logits), _np(aux)]
        out["loss"] = _np(loss)
    logits, cache = RM.prefill(cfg, params,
                               {k: jnp.asarray(v) for k, v in
                                _prompt(cfg, b).items()}, max_len=T)
    out["prefill"] = [_np(logits)] + [_np(x) for x in jax.tree.leaves(cache)]
    step = jax.jit(lambda p, c, x: RM.decode_step(cfg, p, c, x))
    out["decode"] = []
    for t in range(N_PRE, N_PRE + N_DEC):
        logits, cache = step(params, cache,
                             {k: jnp.asarray(v) for k, v in
                              _step_input(cfg, b, t).items()})
        out["decode"].append([_np(logits)]
                             + [_np(x) for x in jax.tree.leaves(cache)])
    return out


@functools.lru_cache(maxsize=None)
def _port(arch, use_kernels):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              use_kernels=use_kernels)
    np_params, b = _inputs(arch)
    params = M.params_from_numpy(np_params, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    out = {}
    logits, aux = M.forward(cfg, params, tb)
    out["forward"] = [_np(logits), _np(aux)]
    out["loss"] = _np(M.loss_fn(cfg, params, tb)[0])
    logits, cache = M.prefill(cfg, params,
                              {k: torch.from_numpy(v) for k, v in
                               _prompt(cfg, b).items()}, max_len=T)
    out["prefill"] = [_np(logits)] + [_np(x) for x in M.tree_leaves(cache)]
    out["decode"] = []
    for t in range(N_PRE, N_PRE + N_DEC):
        logits, cache = M.decode_step(cfg, params, cache,
                                      {k: torch.from_numpy(v) for k, v in
                                       _step_input(cfg, b, t).items()})
        out["decode"].append([_np(logits)] + [_np(x) for x in
                                              M.tree_leaves(cache)])
    return out


def _assert_all_close(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"{what} leaf {i}"
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   err_msg=f"{what} leaf {i}", **TOL)


KERNELS = pytest.mark.parametrize("use_kernels", [False, True],
                                  ids=["plain", "kernels"])


@pytest.mark.parametrize("arch", ALL_ARCHS)
@KERNELS
def test_forward_and_loss_match_reference(arch, use_kernels):
    want = _reference(arch, False)
    got = _port(arch, use_kernels)
    _assert_all_close(got["forward"], want["forward"], "forward")
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    assert np.isfinite(got["forward"][0]).all()


@pytest.mark.parametrize("arch", ALL_ARCHS)
@KERNELS
def test_prefill_matches_reference(arch, use_kernels):
    _assert_all_close(_port(arch, use_kernels)["prefill"],
                      _reference(arch, use_kernels)["prefill"], "prefill")


@pytest.mark.parametrize("arch", ALL_ARCHS)
@KERNELS
def test_decode_steps_match_reference(arch, use_kernels):
    got, want = _port(arch, use_kernels), _reference(arch, use_kernels)
    for t, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        _assert_all_close(g, w, f"decode step {t}")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_tree_matches_reference(arch):
    for cfg_r, cfg_p in ((ref_config(arch), get_config(arch)),
                         (ref_config(arch).reduced(),
                          get_config(arch).reduced())):
        ref = jax.tree_util.tree_flatten_with_path(RM.param_shapes(cfg_r))[0]
        port = M.tree_leaves(M.param_shapes(cfg_p))
        assert len(port) == len(ref)
        for (path, want), got in zip(ref, port):
            assert got.device.type == "meta"
            assert tuple(got.shape) == tuple(want.shape), path
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype), \
                path


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_params_from_numpy_keeps_the_reference_tree(arch):
    """The reference's own init (bf16), as NumPy: the same leaves in the
    same order, bit for bit."""
    small = dataclasses.replace(ref_config(arch).reduced(), dtype="bfloat16")
    ref_p = jax.jit(functools.partial(RM.init_params, small))(
        jax.random.PRNGKey(1))
    port_p = M.params_from_numpy(jax.tree.map(np.asarray, ref_p), "cpu")
    for want, got in zip(jax.tree.leaves(ref_p), M.tree_leaves(port_p)):
        assert got.dtype == getattr(torch, str(want.dtype))
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_init_params_is_a_function_of_its_generator():
    cfg = get_config("zamba2-2.7b").reduced()

    def draw(seed):
        return M.tree_leaves(M.init_params(
            cfg, torch.Generator().manual_seed(seed)))
    a, b, c = draw(0), draw(0), draw(1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    shapes = M.tree_leaves(M.param_shapes(cfg))
    assert [x.shape for x in a] == [x.shape for x in shapes]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b", "xlstm-125m"])
def test_decode_step_donates_only_when_asked(arch):
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator()
                        .manual_seed(1))
    _, cache = M.prefill(cfg, params, {"tokens": tok}, max_len=8)
    before = [x.clone() for x in M.tree_leaves(cache)]
    step = {"tokens": tok[:, :1]}
    logits, new = M.decode_step(cfg, params, cache, step)
    assert all(torch.equal(x, y) for x, y in zip(before, M.tree_leaves(cache)))
    assert int(new["len"]) == 7 and int(cache["len"]) == 6
    logits2, same = M.decode_step(cfg, params, cache, step, donate=True)
    assert same is cache and int(cache["len"]) == 7
    assert torch.equal(logits, logits2)
    assert all(torch.equal(x, y) for x, y in zip(M.tree_leaves(new),
                                                 M.tree_leaves(cache)))


def test_entry_points_need_the_card_unless_given_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_cache(get_config("llama3.2-1b").reduced(), 1, 8)
    cache = M.init_cache(get_config("llama3.2-1b").reduced(), 1, 8, "cpu")
    assert cache["len"].dtype == torch.int32 and int(cache["len"]) == 0
