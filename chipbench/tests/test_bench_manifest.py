"""BENCHMARK.json against the rules of its format, and every name it
gives found as a file."""
from __future__ import annotations

import json
import re

import pytest

from chipbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(manifest):
    assert set(manifest) == KEYS
    assert 1 <= len(manifest["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in manifest["paths"])
    assert len(manifest["command"]) <= 32
    assert all(_line(w) for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_names_units_and_entries(manifest):
    groups = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source",
                             "workloads"},
              "per_layer": {"name", "unit", "better", "source", "layer",
                            "moves", "workloads"}}
    for group, allowed in groups.items():
        names = [e["name"] for e in manifest[group]]
        assert len(names) == len(set(names)), group
        for e in manifest[group]:
            assert set(e) <= allowed, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and group in ("configs", "workloads",
                                          "per_layer"):
                    assert _line(e[key]), (e["name"], key)
    for c in manifest["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in
                                          manifest["paths"]))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) and NAME.match(w["traffic"])
               for w in manifest["workloads"])
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(
        1, len(manifest["workloads"]) // 4)


def test_metrics(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    assert all(m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
               for m in manifest["per_layer"])
    layers: dict = {}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    # metrics of one layer name it letter for letter alike
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_what_it_must(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    for cell in cells:
        e2e = harness.metrics_of(manifest, cell, "end_to_end")
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2, cell
        per_layer = harness.metrics_of(manifest, cell, "per_layer")
        assert per_layer, cell
        # every per-layer metric it reports moves a metric it reports
        assert all(m["moves"] in names for m in per_layer), cell
    for m in manifest["per_layer"] + manifest["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    # a per-layer metric names the cells in which its reader finds
    # something to read
    assert all(m.get("workloads") for m in manifest["per_layer"])


def test_every_name_is_a_file(manifest):
    for c in manifest["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert (harness.BENCH / "configs" / f"{c['name']}.py").is_file()
    for w in manifest["workloads"]:
        spec = harness.cell_spec(manifest, w["name"])
        assert spec["traffic"]["kind"] in ("closed_route", "closed_generate")
        assert spec["limits"] and spec["control"]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(harness.reader(m["name"]).read), m["name"]


def test_check_budget_fits(manifest):
    """A check of 24 cells, 14 runs each, fits in 12 hours."""
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
