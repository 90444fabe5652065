"""The port's sharding policy against the reference's, rule for rule.

* ``make_rules`` in every preset (``sp``, ``train_layout``,
  ``serve_layout``, and the presets it refuses) equals the reference's;
* ``param_pspecs``, ``batch_pspecs`` and ``cache_pspecs`` of every
  arch's full-size ``param_shapes`` / train batch / ``init_cache`` on the
  production meshes (16, 16) and (2, 16, 16), with FSDP and without,
  equal the reference's spec for spec (exact: they are tuples of axis
  names).  Neither side needs devices: each policy gets a stand-in mesh
  holding only the axis names and sizes, which is all ``_axis``,
  ``_fit_axis`` and ``param_spec`` read;
* ``placements`` turns a spec into one DTensor placement per mesh dim,
  and refuses a split DTensor cannot express.
"""
import types

import jax
import pytest

from repro import sharding as RS
from repro.configs import ALL_ARCHS
from repro.configs import get_config as ref_config
from repro.launch import specs as RSP
from repro.models import model as RM
from repro.serving import engine as RE
from repro.train import trainer as RT
from repro_torch import sharding as S
from repro_torch.configs import get_config
from repro_torch.launch import specs as SP
from repro_torch.models import model as M
from repro_torch.serving import engine as E
from repro_torch.train import trainer as T

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _ref_mesh(names, sizes):
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)))


def _port_mesh(names, sizes):
    return types.SimpleNamespace(mesh_dim_names=names, shape=sizes)


def _ref_specs(tree) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(spec)) for path, spec in flat]


def _port_specs(tree) -> list:
    return [("/".join(str(k) for k in path), tuple(spec))
            for path, spec in M.tree_flatten_with_path(tree)]


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("train_layout", [None, "tp", "dp"])
@pytest.mark.parametrize("serve_layout", [None, "legacy", "1d", "2d"])
def test_make_rules_every_preset(sp, train_layout, serve_layout):
    assert S.make_rules(sp=sp, train_layout=train_layout,
                        serve_layout=serve_layout) == RS.make_rules(
        sp=sp, train_layout=train_layout, serve_layout=serve_layout)


@pytest.mark.parametrize("kw", [{"train_layout": "zz"},
                                {"serve_layout": "3d"}])
def test_make_rules_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError):
        RS.make_rules(**kw)
    with pytest.raises(ValueError):
        S.make_rules(**kw)


def test_default_rules_and_no_policy():
    assert S.DEFAULT_RULES == RS.DEFAULT_RULES
    assert S.NO_POLICY.mesh is None
    x = object()
    assert S.NO_POLICY.constrain(x, "batch", name="logits") is x
    assert S.NO_POLICY.named("batch") is None


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_batch_cache_specs_equal_the_reference(arch, mesh):
    names, sizes = MESHES[mesh]
    cfg, rcfg = get_config(arch), ref_config(arch)
    cell = SP.SHAPE_CELLS["decode_32k"]
    for fsdp in (True, False):
        pol = S.Policy(mesh=_port_mesh(names, sizes), fsdp=fsdp)
        rpol = RS.Policy(mesh=_ref_mesh(names, sizes), fsdp=fsdp)
        assert _port_specs(T.param_pspecs(pol, M.param_shapes(cfg))) == \
            _ref_specs(RT.param_pspecs(rpol, RM.param_shapes(rcfg)))
        batch = SP.input_specs(cfg, SP.SHAPE_CELLS["train_4k"])["batch"]
        rbatch = RSP.input_specs(rcfg, RSP.SHAPE_CELLS["train_4k"])["batch"]
        assert _port_specs(T.batch_pspecs(pol, batch)) == \
            _ref_specs(RT.batch_pspecs(rpol, rbatch))
        cache = M.init_cache(cfg, cell.batch, cell.seq, "meta")
        rcache = jax.eval_shape(
            lambda: RM.init_cache(rcfg, cell.batch, cell.seq))
        assert _port_specs(E.cache_pspecs(pol, cache)) == \
            _ref_specs(RE.cache_pspecs(rpol, rcache))


@pytest.mark.parametrize("preset", [dict(serve_layout="2d"),
                                    dict(serve_layout="1d"),
                                    dict(train_layout="dp", sp=True)])
def test_layout_presets_give_the_reference_specs(preset):
    names, sizes = MESHES["2x16x16"]
    rules = S.make_rules(**preset)
    for arch in ("llama3.2-1b", "deepseek-v3-671b", "zamba2-2.7b"):
        pol = S.Policy(mesh=_port_mesh(names, sizes), rules=rules)
        rpol = RS.Policy(mesh=_ref_mesh(names, sizes),
                         rules=RS.make_rules(**preset))
        assert _port_specs(T.param_pspecs(pol, M.param_shapes(
            get_config(arch)))) == _ref_specs(RT.param_pspecs(
                rpol, RM.param_shapes(ref_config(arch))))
        for shape in [(128, 1, 7168), (256, 4096, 2048), (1, 32768, 8)]:
            for axes in [("batch", "seq", "vocab"),
                         ("batch", "kv_len", "heads", None),
                         ("batch", "seq_act", "embed")]:
                assert tuple(pol.guarded_spec(shape, *axes)) == \
                    tuple(rpol.guarded_spec(shape, *axes))
                assert tuple(pol.spec(*axes)) == tuple(rpol.spec(*axes))


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _port_mesh(("pod", "data", "model"), (2, 16, 16))
    assert S.placements(mesh, S.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert S.placements(mesh, S.P(None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        S.placements(mesh, S.P(("model", "data"), None))
    assert S.P("data", None) == ("data", None)
    assert repr(S.P("data", None)) == "P('data', None)"
