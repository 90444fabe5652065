"""The port's optimizer and gradient compression against the reference.

Seeded NumPy trees go to both packages (``repro.optim`` on ``jnp``
arrays, ``repro_torch.optim`` on CPU tensors):

* ``lr_at`` over steps 0-120 (ints and int32 tensors) and
  ``global_norm`` within 1e-7 relative (f32 sums taken in another order);
* three ``apply_updates`` steps, f32 and ``state_dtype="bfloat16"``:
  params, ``mu`` and ``nu`` within 1e-6 of each leaf's largest
  magnitude, ``step`` exact.  With bf16 state and clipping on, the clip
  scale comes from ``global_norm``, whose f32 sum the two packages take
  in different orders (one ulp apart): a state element whose f32 value
  lies at a bf16 rounding midpoint may then round one bf16 ulp apart, so
  bf16 ``mu``/``nu`` elements may differ by one bf16 ulp (2^-7 relative),
  in under 0.1% of elements; without clipping everything is within
  1e-6;
* ``compress``: masks, synchronized values and residuals bitwise, ties
  included; ``compression_ratio`` equal;
* the reference's own compression properties
  (``tests/test_kernel_integration_compress.py``) on the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as radamw
from repro.optim import compress as rcompress
from repro_torch.models import model as M
from repro_torch.optim import adamw, compress
from repro_torch.optim.compress import (CompressionConfig,
                                        compression_ratio, init_residual)

OPT = dict(lr=1e-3, warmup_steps=10, total_steps=100)


def _tree(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((64, 48))).astype(np.float32),
            "blocks": {"wi": (scale * rng.standard_normal((3, 32, 40))
                              ).astype(np.float32),
                       "ln": (1 + scale * rng.standard_normal(40)
                              ).astype(np.float32)},
            "b": (scale * rng.standard_normal(17)).astype(np.float32)}


def _jax(tree):
    return M.tree_map(jnp.asarray, tree)


def _torch(tree):
    return M.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaf_close(got, want, rel, bf16_ulp=False):
    """Every leaf within ``rel`` of its largest magnitude; with
    ``bf16_ulp``, elements one bf16 ulp apart (under 0.1% of them) are
    let through."""
    for g, w in zip(M.tree_leaves(got), M.tree_leaves(_np_tree(want))):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        off = np.abs(g - w) > rel * scale
        if bf16_ulp:
            one_ulp = np.abs(g - w) <= 2.0 ** -7 * np.abs(w)
            assert bool(one_ulp[off].all()) and off.mean() < 1e-3, \
                (int(off.sum()), off.size)
        else:
            assert not off.any(), (float(np.abs(g - w).max()), scale)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(tree[k]) for k in tree}
    return np.asarray(tree, np.float32)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_lr_at_matches_reference(as_tensor):
    cfg, rcfg = adamw.AdamWConfig(**OPT), radamw.AdamWConfig(**OPT)
    for step in range(121):
        if as_tensor:
            got = adamw.lr_at(cfg, torch.tensor(step, dtype=torch.int32))
            want = radamw.lr_at(rcfg, jnp.int32(step))
        else:
            got, want = adamw.lr_at(cfg, step), radamw.lr_at(rcfg, step)
        got, want = float(got), float(np.float32(want))
        assert abs(got - want) <= 1e-7 * abs(want), (step, got, want)


def test_global_norm_matches_reference():
    t = _tree(np.random.default_rng(0))
    got = float(adamw.global_norm(_torch(t)))
    want = float(radamw.global_norm(_jax(t)))
    assert abs(got - want) <= 1e-7 * want, (got, want)


@pytest.mark.parametrize("state_dtype,clip", [("float32", 1.0),
                                              ("bfloat16", 1.0),
                                              ("bfloat16", 0.0)])
def test_apply_updates_three_steps_match_reference(state_dtype, clip):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(3)]
    cfg = adamw.AdamWConfig(state_dtype=state_dtype, clip_norm=clip, **OPT)
    rcfg = radamw.AdamWConfig(state_dtype=state_dtype, clip_norm=clip,
                              **OPT)
    ulp = state_dtype == "bfloat16" and clip > 0
    p, rp = _torch(params), _jax(params)
    st, rst = adamw.init_state(cfg, p), radamw.init_state(rcfg, rp)
    assert st["step"].dtype == torch.int32
    for g in grads:
        p, st, met = adamw.apply_updates(cfg, p, _torch(g), st)
        rp, rst, rmet = radamw.apply_updates(rcfg, rp, _jax(g), rst)
        assert int(st["step"]) == int(rst["step"])
        assert st["step"].dtype == torch.int32
        _leaf_close(p, rp, 1e-6)
        _leaf_close(st["mu"], rst["mu"], 1e-6, ulp)
        _leaf_close(st["nu"], rst["nu"], 1e-6, ulp)
        for k in ("grad_norm", "lr"):
            assert abs(float(met[k]) - float(rmet[k])) <= \
                1e-6 * abs(float(rmet[k])), k
    want_dt = getattr(torch, state_dtype)
    assert all(x.dtype == want_dt for x in M.tree_leaves(st["mu"]))
    assert all(x.dtype == torch.float32 for x in M.tree_leaves(p))


def test_weight_decay_only_on_matrices():
    """A zero gradient moves a matrix by its decay and a vector not at
    all."""
    cfg = adamw.AdamWConfig(weight_decay=0.5, clip_norm=0.0, **OPT)
    p = {"m": torch.ones((4, 4)), "v": torch.ones(4)}
    g = M.tree_map(torch.zeros_like, p)
    new, _, _ = adamw.apply_updates(cfg, p, g, adamw.init_state(cfg, p))
    assert torch.equal(new["v"], p["v"])
    assert bool((new["m"] < 1).all())


def _quantized(rng, shape, levels=7):
    """Values on a few levels, so the top-k threshold has many ties."""
    return (rng.integers(-levels, levels + 1, shape) / levels
            ).astype(np.float32)


@pytest.mark.parametrize("k_frac,ties", [(0.1, False), (0.1, True),
                                         (0.3, True), (1.0, False)])
def test_compress_matches_reference_bitwise(k_frac, ties):
    rng = np.random.default_rng(2)
    shapes = {"big": (128, 64), "mid": (80, 70), "small": (16,)}
    draw = (lambda s: _quantized(rng, s)) if ties else \
        (lambda s: rng.standard_normal(s).astype(np.float32))
    g = {k: draw(s) for k, s in shapes.items()}
    e = {k: (0.1 * draw(s)).astype(np.float32) for k, s in shapes.items()}
    cfg = CompressionConfig(k_frac=k_frac)
    rcfg = rcompress.CompressionConfig(k_frac=k_frac)
    sent, res = compress.compress(cfg, _torch(g), _torch(e))
    rsent, rres = rcompress.compress(rcfg, _jax(g), _jax(e))
    for k in shapes:
        for got, want in ((sent[k], rsent[k]), (res[k], rres[k])):
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          np.asarray(want).view(np.int32))
    for k in ("big", "mid"):
        acc = torch.from_numpy(e[k]) + torch.from_numpy(g[k])
        mask = compress._topk_mask(acc, k_frac)
        rmask = rcompress._topk_mask(jnp.asarray(e[k]) + jnp.asarray(g[k]),
                                     k_frac)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))


def test_compression_ratio_matches_reference():
    tree = {"big": np.zeros((1024, 1024), np.float32),
            "mid": np.zeros((97, 61), np.float32),
            "small": np.zeros((64,), np.float32)}
    for k_frac in (0.01, 0.1, 0.5):
        assert compression_ratio(CompressionConfig(k_frac=k_frac),
                                 _torch(tree)) == \
            rcompress.compression_ratio(
                rcompress.CompressionConfig(k_frac=k_frac), _jax(tree))


def test_compress_identity_at_full_k():
    rng = np.random.default_rng(3)
    params = {"w": torch.from_numpy(rng.standard_normal((128, 64))
                                    .astype(np.float32))}
    grads = {"w": torch.from_numpy(rng.standard_normal((128, 64))
                                   .astype(np.float32))}
    sent, new_res = compress.compress(CompressionConfig(k_frac=1.0), grads,
                                      init_residual(params))
    assert torch.equal(sent["w"], grads["w"])
    assert float(new_res["w"].abs().max()) == 0.0


def test_compress_error_feedback_conserves_mass():
    """sent + residual' == grad + residual (nothing is lost, only
    delayed)."""
    rng = np.random.default_rng(4)
    g = {"w": torch.from_numpy(rng.standard_normal((256, 32))
                               .astype(np.float32))}
    e = {"w": torch.from_numpy(0.1 * rng.standard_normal((256, 32))
                               .astype(np.float32))}
    sent, e2 = compress.compress(CompressionConfig(k_frac=0.1), g, e)
    torch.testing.assert_close(sent["w"] + e2["w"], g["w"] + e["w"],
                               atol=1e-6, rtol=0)
    frac = float((sent["w"] != 0).float().mean())
    assert 0.05 <= frac <= 0.2


def test_compress_small_leaves_pass_through():
    g = {"bias": torch.ones(16)}
    sent, _ = compress.compress(CompressionConfig(k_frac=0.01, min_size=4096),
                                g, init_residual(g))
    assert torch.equal(sent["bias"], g["bias"])
