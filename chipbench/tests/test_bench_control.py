"""Each cell's control: the reference in the precision below the one its
configuration states, put in the program's place.  On the card at the
cells' own sizes (``gpu``) it fails the cell's limits on three seeds,
where the program keeps them; at tiny sizes on the host, where those
limits do not scale, it reads at least three times the program on one
of the cell's numbers.  ``chipbench/calibrate.py`` takes the same
readings (``harness.control_readings``) on a dozen seeds; PERF.md gives
them beside each limit."""
from __future__ import annotations

import pytest
import torch

from chipbench import harness

from .conftest import tiny_spec


@pytest.mark.parametrize("cell,dtype", [("chain-route", "float32"),
                                        ("zamba2-prefill", "bfloat16"),
                                        ("zamba2-decode", "bfloat16")])
def test_control_reads_apart_at_tiny_sizes(cell, dtype):
    spec = tiny_spec(cell, dtype=dtype)
    for seed in range(3):
        got = harness.control_readings(spec, seed, torch.device("cpu"), 0.2)
        prog, ctrl = got["program"], got[spec["control"]]
        assert all(prog[n] <= lim for n, lim in spec["limits"].items()), got
        assert any(ctrl[n] >= 3 * max(prog[n], 1e-12)
                   for n in spec["limits"]), got


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_manifest()["workloads"]])
def test_control_fails_the_limits_on_the_card(cuda_device, cell):
    spec = harness.cell_spec(harness.load_manifest(), cell)
    for seed in (2147483701, 2147483702, 2147483703):
        got = harness.control_readings(spec, seed, cuda_device, 3.0)
        limits = spec["limits"]
        assert all(got["program"][n] <= lim for n, lim in limits.items())
        assert any(got[spec["control"]][n] > lim
                   for n, lim in limits.items()), got
