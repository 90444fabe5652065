"""A new cell, configuration or per-layer metric is found by its file
names alone: new files and manifest entries, no edit of the harness."""
from __future__ import annotations

import json
import shutil
import time

import torch

from chipbench import harness

from .conftest import TINY


def test_new_cell_config_and_metric_are_found(tmp_path, monkeypatch):
    bench = tmp_path / "chipbench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    # a new configuration: the chain with one block, its own files
    cfg = json.loads((bench / "configs" / "granite-chain.json").read_text())
    cfg.update(TINY["granite-chain"], blocks=1)
    (bench / "configs" / "chain-one.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "configs" / "granite-chain.py",
                bench / "configs" / "chain-one.py")
    # a new cell on it, and a new per-layer metric that it reports
    work = json.loads((bench / "workloads" / "chain-route.json").read_text())
    work["traffic"]["name"] = "closed-route-4"
    work["traffic"]["inputs"] = 4
    (bench / "workloads" / "chain-one-route.json").write_text(
        json.dumps(work))
    (bench / "metrics" / "requests_done.py").write_text(
        "def read(rec):\n    return float(rec['window']['requests'])\n")
    manifest = harness.load_manifest()
    manifest["configs"].append({
        "name": "chain-one", "source": "https://example.org/chain-one",
        "file": "chipbench/configs/chain-one.json", "reduced": ["blocks"],
        "why": "a test configuration"})
    manifest["workloads"].append({
        "name": "chain-one-route", "config": "chain-one",
        "traffic": "closed-route-4", "chips": 1, "why": "a test cell"})
    manifest["end_to_end"][[m["name"] for m in manifest["end_to_end"]]
                           .index("route_ms")]["workloads"].append(
        "chain-one-route")
    manifest["per_layer"].append({
        "name": "requests_done", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "lane runtime",
        "moves": "route_ms", "workloads": ["chain-one-route"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    monkeypatch.setattr(harness, "BENCH", bench)
    monkeypatch.setattr(harness, "ROOT", tmp_path)

    spec = harness.cell_spec(harness.load_manifest(tmp_path),
                             "chain-one-route", root=tmp_path)
    assert spec["config"]["blocks"] == 1
    assert [m["name"] for m in spec["end_to_end"]] == ["route_ms", "setup_s"]
    assert "requests_done" in [m["name"] for m in spec["per_layer"]]
    res = harness.run_spec(spec, 5, 0.2, False, torch.device("cpu"),
                           time.perf_counter())
    assert res["correct"] and set(res["metrics"]) == {"route_ms", "setup_s"}
    assert harness.reader("requests_done").read(
        {"window": {"requests": 3}}) == 3.0
