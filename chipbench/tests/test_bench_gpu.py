"""Each cell once on the card, briefly, through ``chipbench/run.py``
(``python -m pytest chipbench/tests -m gpu`` on a machine with a
card)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from chipbench import harness


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_manifest()["workloads"]])
def test_cell_runs_correct_on_the_card(cuda_device, cell, trace):
    out = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", cell, "--seed",
         str(2147483659 + trace), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    spec = harness.cell_spec(harness.load_manifest(), cell)
    want = spec["per_layer" if trace else "end_to_end"]
    assert set(res["metrics"]) == {m["name"] for m in want}
