"""The readers of the port's own spans and counters, on synthetic spans."""
from __future__ import annotations

import pytest

from chipbench import harness, port_spans

MS = 1_000_000      # nanoseconds


def _span(sid, name, start, end, parent=None, request=None, counts=None):
    """A span record as ``repro_torch.tracing`` keeps it, times in ms."""
    return {"name": name, "start_ns": start * MS, "end_ns": end * MS,
            "id": sid, "parent": parent,
            "request": sid if request is None else request, "thread": 1,
            "attrs": {}, "counts": counts or {}}


def _unit(sid, root, t0, graphs, copy=(0, 0)):
    """A root span of 10 ms at ``t0`` holding a replay over [t0 + 2,
    t0 + 8] with ``capture.graph`` spans at ``graphs`` (offsets in ms),
    the replay's copy counts ``copy`` (in, clone bytes)."""
    out = [_span(sid, root, t0, t0 + 10),
           _span(sid + 1, "capture.replay", t0 + 2, t0 + 8, sid, sid,
                 {"capture.copy_in_bytes": copy[0],
                  "capture.clone_bytes": copy[1]})]
    for k, (a, b) in enumerate(graphs):
        out.append(_span(sid + 2 + k, "capture.graph", t0 + a, t0 + b,
                         sid + 1, sid))
    return out


def _spans(root):
    """Two warm-up roots, then two traced ones."""
    spans = []
    for n in range(4):
        spans += _unit(100 * n, root, 20 * n, [(3, 4), (3.5, 6)],
                       copy=(1_000_000 * n, 2_000_000))
    return spans


def test_window_takes_the_last_roots_and_their_descendants():
    spans = _spans("engine.decode_step")
    # a span of another root between them
    spans.append(_span(999, "model.prefill", 0, 100))
    rec = {"trace": {"decode_steps": 2}}
    units = port_spans.window(rec, "engine.decode_step", spans)
    assert [u["id"] for u in units] == [200, 300]
    assert [sorted(d["id"] for d in u["descendants"]) for u in units] == [
        [201, 202, 203], [301, 302, 303]]
    assert port_spans.window({"trace": {"decode_steps": 5}},
                             "engine.decode_step", spans) is None
    assert port_spans.window(rec, "engine.decode_step", []) is None


def test_outside_subtracts_overlapping_descendants_once():
    unit, = port_spans.window({"trace": {"units": 1}},
                              "orchestrator.execute",
                              _unit(1, "orchestrator.execute", 0,
                                    [(3, 4), (3.5, 6), (20, 30)]))
    # graphs over [3, 6] and one past the span's end, [20, 30] clipped
    assert port_spans.outside(unit, "capture.graph") == pytest.approx(7e-3)
    assert port_spans.outside(unit, "capture.replay") == pytest.approx(4e-3)
    assert port_spans.outside(unit, "none") == pytest.approx(10e-3)


CELLS = {"execute_host_share.route": ("orchestrator.execute", "units"),
         "replay_copy_mb.route": ("orchestrator.execute", "units"),
         "step_host_share.tpot": ("engine.decode_step", "decode_steps"),
         "replay_copy_mb.tpot": ("engine.decode_step", "decode_steps"),
         "prefill_issue_ms.ttft": ("model.prefill", "prefills")}
WANT = {"execute_host_share.route": 70.0, "step_host_share.tpot": 70.0,
        # (2e6 + 3e6 copied in, 2e6 cloned each) / 2 routes, in MB
        "replay_copy_mb.route": 4.5, "replay_copy_mb.tpot": 4.5,
        "prefill_issue_ms.ttft": 10.0}


@pytest.mark.parametrize("metric", sorted(CELLS))
def test_span_readers(metric, monkeypatch):
    root, key = CELLS[metric]
    rec = {"trace": {key: 2}}
    monkeypatch.setattr(port_spans, "port_spans", lambda: _spans(root))
    assert harness.reader(metric).read(rec) == pytest.approx(WANT[metric])
    # without the port's spans: a checkout of the port that records none,
    # or a window whose roots were not recorded
    monkeypatch.setattr(port_spans, "port_spans", lambda: None)
    assert harness.reader(metric).read(rec) is None
    monkeypatch.setattr(port_spans, "port_spans", lambda: [])
    assert harness.reader(metric).read(rec) is None


@pytest.mark.parametrize("root", ["orchestrator.execute",
                                  "engine.decode_step"])
def test_host_share_is_over_the_whole_window(root, monkeypatch):
    """Each unit weighs by its length: a slow unit of three (the
    allocator growing in it) counts its 50 ms more host work once."""
    spans = [s for t0 in (0, 100, 200)
             for s in _unit(t0, root, t0, [(3, 6)])]
    spans[0]["end_ns"] += 50 * MS
    rec = {"trace": {"units": 3, "decode_steps": 3}}
    monkeypatch.setattr(port_spans, "port_spans", lambda: spans)
    assert [1e3 * port_spans.outside(u, "capture.graph")
            for u in port_spans.window(rec, root)] == pytest.approx(
        [57.0, 7.0, 7.0])
    assert port_spans.host_share(rec, root) == pytest.approx(
        100 * 71 / 80)


def test_profile_offcard_s(monkeypatch):
    read = harness.reader("profile_offcard_s").read
    monkeypatch.setattr(port_spans, "port_counters", lambda: {
        "planner.measure_s.cpu": 12.5, "capture.clone_bytes": 3})
    assert read({}) == 12.5
    monkeypatch.setattr(port_spans, "port_counters", lambda: None)
    assert read({}) is None
    monkeypatch.setattr(port_spans, "port_counters", lambda: {})
    assert read({}) is None


def test_the_ports_own_records_are_read():
    """The readers find the port's spans where it records them."""
    from repro_torch import tracing
    assert port_spans.port_spans() == tracing.spans()
    assert port_spans.port_counters() == tracing.counters()
