"""The port's model configs and analytic op graphs against the reference.

* every config of ``repro_torch.configs`` and its ``reduced()`` equal
  ``repro.configs``' field for field, and so does ``param_count()``;
* ``repro_torch.core.modelgraph.model_op_graph`` is bitwise the
  reference's (op names, kinds, shapes, flops, bytes, edges) for every
  arch x train/prefill/decode at two (batch, seq) pairs.
"""
import dataclasses

import pytest
import torch

from repro.configs import ALL_ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs import list_configs as ref_list
from repro.core.modelgraph import model_op_graph as ref_graph
from repro_torch.configs import ALL_ARCHS, get_config, list_configs
from repro_torch.core.modelgraph import model_op_graph


def test_registry_matches_reference():
    assert ALL_ARCHS == REF_ARCHS
    assert list_configs() == ref_list()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", REF_ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_field_for_field(arch, reduced):
    ref, port = ref_config(arch), get_config(arch)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert type(port).__name__ == type(ref).__name__ == "ModelConfig"
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    for prop in ("ssm_d_inner", "ssm_heads", "xlstm_d_inner", "slstm_ff",
                 "sub_quadratic"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.torch_dtype == getattr(torch, ref.dtype)
    assert str(ref.jdtype) == str(port.torch_dtype).removeprefix("torch.")


def _graph_record(g):
    return ([(op.name, op.kind, tuple(map(tuple, op.in_shapes)),
              tuple(op.out_shape), op.dtype_bytes, op.flops, op.bytes_moved)
             for op in g.ops], g.edges)


@pytest.mark.parametrize("arch", REF_ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("batch,seq", [(8, 2048), (1, 96)])
def test_model_op_graph_bitwise(arch, kind, batch, seq):
    ref = ref_graph(ref_config(arch), kind=kind, batch=batch, seq=seq)
    port = model_op_graph(get_config(arch), kind=kind, batch=batch, seq=seq)
    assert _graph_record(port) == _graph_record(ref)
    assert port.n_edges == ref.n_edges
