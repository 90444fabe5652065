"""Readings that a cell's limits are set from: on each seed, a short
window of the cell's own traffic, then the check's numbers for the
program and for the cell's control (the reference computed in the
precision below the configuration's, put in the program's place).

    python chipbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

One JSON line a seed on standard output, and a last line with the
largest program reading and the smallest control reading of each
number.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from chipbench import harness
    spec = harness.cell_spec(harness.load_manifest(), args.workload)
    control = spec["control"]
    device = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = harness.control_readings(spec, seed, device, args.seconds)
        row = {"seed": seed, "units": got["units"], "program": got["program"],
               control: got[control], "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del got
        torch.cuda.empty_cache()
    names = rows[0]["program"].keys()
    summary = {"lower": {n: max(r["program"][n] for r in rows) for n in names},
               "upper": {n: min(r[control][n] for r in rows) for n in names},
               "control": control, "seeds": len(rows)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
