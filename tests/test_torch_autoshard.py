"""The port's autoshard pass against the reference's.

* the reference's own invariants (``tests/test_autoshard.py``) hold for
  the port at its H100 constants: never worse than the best single
  strategy, direct reshard never worse, soft feasibility degrading to
  REP, hard-unsupported entries omitted, the decode/train GEMM asymmetry,
  cost monotone in the mesh, overrides emitted and refused;
* with the port's constants set to the reference's values (through
  ``monkeypatch``, no knob), cost tables, schedules (sequential and
  phase-parallel), single-strategy costs, speedups and ``emit_overrides``
  equal the reference's bitwise for every arch, train and decode, on
  (16, 16) and (4, 4); and the reference's paper-shaped result (dense
  near unity, MoE and enc-dec gaining) holds for the port.
"""
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core import autoshard as RA  # noqa: E402
from repro.core import modelgraph as RMG  # noqa: E402
from repro.core.schedule import schedule_to_dict as ref_to_dict  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import autoshard as A  # noqa: E402
from repro_torch.core.modelgraph import model_op_graph  # noqa: E402
from repro_torch.core.op import FusedOp  # noqa: E402
from repro_torch.core.schedule import schedule_to_dict  # noqa: E402

# port constant -> the reference constant it stands for
_CONSTANTS = {"PEAK_FLOPS": "PEAK_FLOPS", "HBM_BW": "HBM_BW",
              "LINK_BW": "ICI_BW", "DISPATCH_S": "DISPATCH_S",
              "HOP_LAT": "HOP_LAT", "POWER_COMPUTE": "POWER_COMPUTE",
              "POWER_MEMORY": "POWER_MEMORY", "KIND_EFF": "KIND_EFF",
              "KIND_BW_EFF": "KIND_BW_EFF"}


@pytest.fixture
def reference_constants(monkeypatch):
    for port, ref in _CONSTANTS.items():
        monkeypatch.setattr(A, port, getattr(RA, ref))


def _graph(arch="llama3.2-1b", kind="decode", batch=128, seq=4096):
    return model_op_graph(get_config(arch), kind=kind, batch=batch, seq=seq)


def _ref_graph(arch="llama3.2-1b", kind="decode", batch=128, seq=4096):
    return RMG.model_op_graph(ref_config(arch), kind=kind, batch=batch,
                              seq=seq)


# -- the reference's invariants, at the H100 constants ----------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_never_worse_than_best_single(arch):
    r = A.autoshard(_graph(arch), d_data=4, d_model=4)
    assert r.speedup >= 1.0 - 1e-9
    for pos, oi in enumerate(r.schedule.chain):
        assert r.table.supported(oi, r.schedule.assignment[pos])


def test_direct_reshard_at_least_as_good():
    for arch in ("llama3.2-1b", "granite-moe-1b-a400m", "xlstm-125m"):
        g = _graph(arch, kind="train", batch=256, seq=4096)
        base = A.autoshard(g, d_data=16, d_model=16)
        direct = A.autoshard(g, d_data=16, d_model=16, direct_reshard=True)
        assert direct.schedule.latency <= base.schedule.latency + 1e-12


def test_soft_feasibility_degrades_to_rep():
    m = A.ShardingCostModel(d_data=16, d_model=16)
    op = FusedOp(name="odd", kind="matmul",
                 in_shapes=((7, 33), (33, 13)), out_shape=(7, 13))
    assert m.entry(op, "TP").kernel == m.entry(op, "REP").kernel


def test_hard_unsupported_omitted():
    m = A.ShardingCostModel(d_data=4, d_model=4)
    op = FusedOp(name="x", kind="matmul", in_shapes=((64, 64), (64, 64)),
                 out_shape=(64, 64), meta={"unsupported_on": ("TP",)})
    assert m.entry(op, "TP") is None
    assert m.entry(op, "DP") is not None


def test_weight_vs_activation_asymmetry():
    m = A.ShardingCostModel(d_data=16, d_model=16)
    decode_mm = FusedOp(name="d", kind="matmul",
                        in_shapes=((128, 8192), (8192, 8192)),
                        out_shape=(128, 8192))
    train_mm = FusedOp(name="t", kind="matmul",
                       in_shapes=((1048576, 1024), (1024, 1024)),
                       out_shape=(1048576, 1024))
    assert m.entry(decode_mm, "TP").kernel < m.entry(decode_mm, "DP").kernel
    assert m.entry(train_mm, "DP").kernel <= \
        m.entry(train_mm, "TP").kernel * 1.001


@settings(max_examples=25, deadline=None)
@given(dd=st.sampled_from([2, 4, 8, 16]), dm=st.sampled_from([2, 4, 8, 16]),
       m_dim=st.sampled_from([64, 256, 1024]),
       k_dim=st.sampled_from([128, 512]))
def test_cost_monotone_in_mesh(dd, dm, m_dim, k_dim):
    op = FusedOp(name="mm", kind="matmul",
                 in_shapes=((m_dim, k_dim), (k_dim, k_dim)),
                 out_shape=(m_dim, k_dim))
    small = A.ShardingCostModel(d_data=dd, d_model=dm).entry(op, "DP_TP")
    big = A.ShardingCostModel(d_data=2 * dd, d_model=2 * dm).entry(op,
                                                                    "DP_TP")
    if m_dim % (2 * dd) == 0 and k_dim % (2 * dm) == 0:
        assert big.kernel <= small.kernel + 1e-12


def test_emit_overrides_equal_and_unknown_strategy():
    sites = {"attn_q": "DP_TP", "mlp_h": "TP", "logits": "DP",
             "moe_xe": "EP", "embed_out": "SP", "attn_o": "REP"}
    assert A.emit_overrides(sites) == RA.emit_overrides(sites)
    with pytest.raises(KeyError):
        A.emit_overrides({"site": "NOT_A_STRATEGY"})


def test_h100_constants():
    assert A.PEAK_FLOPS == 989e12 and A.HBM_BW == 3.35e12
    assert A.LINK_BW == 50e9 and A.NVLINK_BW == 450e9
    assert A.POWER_COMPUTE == 700.0
    assert all(0 < v <= 1 for v in A.KIND_EFF.values())
    assert set(A.KIND_EFF) == set(RA.KIND_EFF)


# -- bitwise at the reference's constants ------------------------------------

@pytest.mark.parametrize("mesh", [(16, 16), (4, 4)])
@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_schedules_equal_the_reference_bitwise(reference_constants, arch,
                                               kind, mesh):
    dd, dm = mesh
    batch, seq = (256, 4096) if kind == "train" else (128, 32768)
    g, rg = _graph(arch, kind, batch, seq), _ref_graph(arch, kind, batch, seq)
    for direct in (False, True):
        r = A.autoshard(g, d_data=dd, d_model=dm, direct_reshard=direct)
        rr = RA.autoshard(rg, d_data=dd, d_model=dm, direct_reshard=direct)
        assert r.schedule.assignment == rr.schedule.assignment
        assert r.schedule.latency == rr.schedule.latency
        assert r.schedule.energy == rr.schedule.energy
        assert r.single == rr.single
        assert r.best_single == rr.best_single
        assert r.speedup == rr.speedup
        for i in range(len(g.ops)):
            for nm in r.model.names:
                e, re_ = r.table.get(i, nm), rr.table.get(i, nm)
                assert (e is None) == (re_ is None)
                if e is not None:
                    assert (e.kernel, e.dispatch, e.h2d, e.d2h, e.power) == \
                        (re_.kernel, re_.dispatch, re_.h2d, re_.d2h,
                         re_.power)
    par = A.autoshard_parallel(g, d_data=dd, d_model=dm)
    rpar = RA.autoshard_parallel(rg, d_data=dd, d_model=dm)
    assert schedule_to_dict(par) == ref_to_dict(rpar)


def test_dense_train_near_unity_moe_gains(reference_constants):
    dense = A.autoshard(_graph("mistral-large-123b", "train", 256, 4096),
                        d_data=16, d_model=16)
    moe = A.autoshard(_graph("granite-moe-1b-a400m", "train", 256, 4096),
                      d_data=16, d_model=16)
    encdec = A.autoshard(_graph("seamless-m4t-medium", "train", 256, 4096),
                         d_data=16, d_model=16)
    assert dense.speedup <= 1.05
    assert moe.speedup >= 1.1
    assert encdec.speedup >= 1.5
