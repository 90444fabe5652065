"""Idle-share and roofline arithmetic on a synthetic trace."""
from __future__ import annotations

import pytest

from chipbench import harness, trace

GLU = "void tc::glu_wgmma_kernel<0>(CUtensorMap_st, float const*, int)"
SCAN = "void st::state_wgmma_kernel<64>(float*, int)"
GEMM = "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32"


def test_entry_of_names_only_the_ports_kernels():
    assert trace.entry_of(GLU) == "expert_glu"
    assert trace.entry_of(SCAN) == "ssd_scan"
    assert trace.entry_of("void attn_tf32_kernel<64, 64>(int)") == \
        "flash_attention"
    assert trace.entry_of(GEMM) is None
    assert trace.entry_of("void cutlass::Kernel<ampere_sgemm_kernel>("
                          "int)") is None
    assert trace.entry_of("Memcpy HtoD (Pinned -> Device)") is None


def _summary():
    # a window of 10 s: kernels over [1, 3], [2, 4] (overlapping), [6, 7];
    # the host in a sync over [4, 6] and a launch over [7, 10]
    dev = [(1.0, 3.0, GLU), (2.0, 4.0, GEMM), (6.0, 7.0, GLU),
           (11.0, 12.0, GLU)]
    host = [(0.0, 10.0, "chipbench.route"),
            (4.0, 6.0, "cudaDeviceSynchronize"),
            (7.0, 10.0, "cudaGraphLaunch"), (0.0, 1.0, "aten::copy_")]
    s = trace.reduce([(0.0, 10.0)], dev, host)
    s["n_kernels"] = 3
    return s


def test_busy_idle_and_gaps():
    s = _summary()
    assert s["window_s"] == 10.0
    assert s["busy_s"] == pytest.approx(4.0)        # [1, 4] and [6, 7]
    assert dict(s["idle_gaps"]) == pytest.approx(
        {"aten::copy_": 1.0, "cudaDeviceSynchronize": 2.0,
         "cudaGraphLaunch": 3.0})
    assert dict(s["device_ops"]) == pytest.approx({GLU: 3.0, GEMM: 2.0})
    assert trace.device_s_of(s, "expert_glu") == pytest.approx(3.0)


def test_windows_are_summed():
    # the same operations, seen through two windows: [0, 3] and [6, 10]
    dev = [(1.0, 3.0, GLU), (2.0, 4.0, GEMM), (6.0, 7.0, GLU)]
    host = [(3.0, 6.0, "cudaDeviceSynchronize"),
            (7.0, 10.0, "cudaGraphLaunch"), (0.0, 1.0, "aten::copy_")]
    s = trace.reduce([(0.0, 3.0), (6.0, 10.0)], dev, host)
    assert s["window_s"] == 7.0 and s["windows"] == 2
    assert s["busy_s"] == pytest.approx(3.0)        # [1, 3] and [6, 7]
    assert dict(s["idle_gaps"]) == pytest.approx(
        {"aten::copy_": 1.0, "cudaGraphLaunch": 3.0})
    assert dict(s["device_ops"]) == pytest.approx({GLU: 3.0, GEMM: 1.0})


def test_union():
    assert trace.union_s([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)]) == 3.0
    assert trace.union_s([]) == 0.0


def test_readers_on_the_synthetic_trace():
    s = _summary()
    rec = {"trace": {**s, "launches": {"expert_glu": 2},
                     "work": {"ops": 495e12, "expert_glu.bound_s": 0.6,
                              "expert_glu.calls": 2}, "units": 4},
           "config": {}, "traffic": {}, "spans": {"profile_s": 12.5},
           "setup_s": 30.0, "window": {}}
    read = {m: harness.reader(m).read(rec) for m in
            ("idle_share.route", "glu_roofline.route", "route_mfu",
             "profile_s")}
    assert read["idle_share.route"] == pytest.approx(60.0)
    # bound 0.3 s a call over 3.0 s of GLU kernels / 2 launches
    assert read["glu_roofline.route"] == pytest.approx(20.0)
    # 495e12 operations over 10 s at the TF32 peak
    assert read["route_mfu"] == pytest.approx(10.0)
    assert read["profile_s"] == 12.5


def test_a_reader_with_nothing_to_read_returns_nothing():
    s = _summary()
    rec = {"trace": {**s, "launches": {}, "work": {}}, "config": {},
           "traffic": {}}
    assert harness.reader("glu_roofline.route").read(rec) is None
    assert harness.reader("scan_roofline.ttft").read(rec) is None
    assert harness.reader("route_mfu").read(rec) is None
    assert harness.reader("decode_kernels").read(rec) is None


def test_end_to_end_readers():
    rec = {"setup_s": 20.0, "window": {
        "seconds": 10.0, "units": 4000, "ttft_s": [0.1] * 95 + [0.2] * 5,
        "decode_s": 3.0, "decode_steps": 200}}
    assert harness.reader("route_ms").read(rec) == pytest.approx(2.5)
    assert harness.reader("tpot_ms").read(rec) == pytest.approx(15.0)
    assert harness.reader("setup_s").read(rec) == 20.0
    assert harness.reader("ttft_p95_ms").read(rec) == pytest.approx(105.0)
