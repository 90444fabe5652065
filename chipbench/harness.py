"""Run one cell of the benchmark once and print its result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration as it is run;
* ``configs/<config>.py``: how to build it, its weights from the seed,
  and its check against the plain reference (``reference/``);
* ``workloads/<cell>.json``: the cell's traffic parameters, the sample
  its check takes and the limit of each number the check compares;
* ``metrics/<metric>.py``: the reader of one metric.

A new cell, configuration or metric is new files and entries in
``BENCHMARK.json``, never an edit of this module.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import traffic as traffic_mod

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level modules the port must not load in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ForbiddenModules(RuntimeError):
    """The measured process loaded a module of ``FORBIDDEN``."""


def subseed(seed: int, stream: int) -> int:
    """A 32-bit seed for one stream (weights, inputs, prompts, samples)
    of a run's ``--seed``, which may exceed 32 bits."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        1, dtype=np.uint32)[0])


def load_module(path: Path):
    """The Python file ``path`` as a module (names may hold '-' or '.')."""
    name = "chipbench_" + path.stem.replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_spec(manifest: dict, name: str, root: Path = ROOT) -> dict:
    """The cell ``name``: its manifest entry, its configuration's entry and
    file, its workload file, and the metrics it reports."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(root / config["file"]) as f:
        cfg = json.load(f)
    with open(BENCH / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    if workload["traffic"]["name"] != cell["traffic"]:
        raise ValueError(f"{name}: workloads/{name}.json's traffic "
                         f"{workload['traffic']['name']!r} is not the "
                         f"manifest's {cell['traffic']!r}")
    return {"name": name, "chips": cell["chips"],
            "config_name": config["name"],
            "config": cfg, "traffic": workload["traffic"],
            "limits": workload["limits"], "control": workload["control"],
            "end_to_end": metrics_of(manifest, name, "end_to_end"),
            "per_layer": metrics_of(manifest, name, "per_layer")}


def metrics_of(manifest: dict, cell: str, group: str) -> list[dict]:
    """The metrics of ``group`` that cell ``cell`` reports: an end-to-end
    metric without ``workloads`` in every cell, any other metric in the
    cells its ``workloads`` lists."""
    default = [cell] if group == "end_to_end" else []
    return [m for m in manifest[group]
            if cell in m.get("workloads", default)]


def reader(metric: str):
    return load_module(BENCH / "metrics" / f"{metric}.py")


def config_module(config: str):
    return load_module(BENCH / "configs" / f"{config}.py")


def forbidden_modules() -> list[str]:
    """Top-level names of ``FORBIDDEN`` in ``sys.modules``, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_kernels(spans: dict) -> None:
    """The port's CUDA kernels built (only a checkout's first run does)
    or loaded from its ``build/kernels``, timed apart from the rest of
    set-up: ``kernels_s``, and ``kernels_built`` the number compiled."""
    from repro_torch.kernels import _build
    built = sum(not _build._lib_path(n).exists() for n in _build.KERNELS)
    t0 = time.perf_counter()
    for name in _build.KERNELS:
        _build.function(name)
    spans.update(kernels_s=time.perf_counter() - t0, kernels_built=built)


def control_readings(spec: dict, seed: int, device, seconds: float) -> dict:
    """What a limit is set from, on one seed: a short window of the cell's
    own traffic as a run drives it, then the check's numbers for the
    program (``program``) and for the cell's control (the reference in
    the precision below the configuration's, put in the program's
    place; under the control's name); ``units`` the window ran."""
    import torch
    mod = config_module(spec["config_name"])
    with torch.no_grad():
        system = mod.build(spec["config"], spec["traffic"], subseed(seed, 0),
                           device, {})
        system.warm()
        loop = traffic_mod.run(system, spec["traffic"], seconds, False,
                               np.random.default_rng(subseed(seed, 1)),
                               subseed(seed, 2))
        system.release()
        got = system.readings(loop["kept"], (spec["control"],))
    got["units"] = loop["units"]
    return got


def run_spec(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of the cell ``spec`` on ``device``; returns the result
    (the line's object, and ``spans``: set-up's parts in seconds).
    ``t_start`` is the process's start on the host clock: set-up is
    everything from it to the window."""
    import torch
    with torch.no_grad():
        return _run_spec(spec, seed, seconds, trace, device, t_start)


def _run_spec(spec, seed, seconds, trace, device, t_start) -> dict:
    import torch
    mod = config_module(spec["config_name"])
    spans: dict = {"start_s": time.perf_counter() - t_start}
    if device.type == "cuda":
        load_kernels(spans)
    t0 = time.perf_counter()
    system = mod.build(spec["config"], spec["traffic"], subseed(seed, 0),
                       device, spans)
    t1 = time.perf_counter()
    system.warm()
    t2 = time.perf_counter()
    spans.update(build_s=t1 - t0, warm_s=t2 - t1)
    setup_s = t2 - t_start
    loop = traffic_mod.run(system, spec["traffic"], seconds, trace,
                           np.random.default_rng(subseed(seed, 1)),
                           subseed(seed, 2))
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"the measured process loaded {found}")
    kept = loop.pop("kept")
    system.release()
    readings = system.readings(kept, ())["program"]
    checks = {name: {"value": readings[name], "limit": limit}
              for name, limit in spec["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    rec = {"setup_s": setup_s, "spans": spans, "window": loop,
           "trace": loop.get("trace"), "config": spec["config"],
           "traffic": spec["traffic"]}
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": spec["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": loop["requests"],
              "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        tr = loop["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    result["spans"] = spans
    return result


def main(args, t_start: float) -> int:
    import torch
    manifest = load_manifest()
    spec = cell_spec(manifest, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    try:
        result = run_spec(spec, args.seed, args.seconds, bool(args.trace),
                          device, t_start)
    except ForbiddenModules as err:
        print(err, file=sys.stderr)
        return 4
    print("set-up spans (s): " + json.dumps(result.pop("spans")),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
