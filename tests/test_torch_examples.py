"""The port's examples (``examples/torch_*.py``) on the CPU.

* each runs with ``--device cpu`` at its smallest size and exits 0 (its
  own asserts hold: outputs against the oracle, a recovery bitwise, the
  train run's loss and its resume bitwise, the autoshard step's loss the
  meshless one's);
* for the four whose plans are host arithmetic on the cost model
  (``quickstart``, ``multi_model_concurrent``, ``dynamic_rescheduling``,
  ``vla_pipeline``) the reference example runs too (``JAX_PLATFORMS=cpu``)
  and every printed route and plan line is the same, bitwise; the lines
  left out carry a wall time or the compiled program's segment modes
  (captured CUDA graphs against the reference's jit);
* none imports ``jax`` or the reference package, and without a card an
  example refuses to run unless asked for the CPU.

The children run four at a time, once for the whole module.
"""
import ast
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

# example -> its arguments at its smallest size (besides --device cpu)
SMALLEST = {
    "quickstart": [],
    "multi_model_concurrent": [],
    "dynamic_rescheduling": [],
    "vla_pipeline": [],
    "streaming_serving": [],
    "heterogeneous_serving": ["--arch", "llama3.2-1b", "--batch", "1"],
    "train_e2e": ["--steps", "20", "--d-model", "32", "--layers", "1",
                  "--seq", "16", "--batch", "2", "--vocab", "128",
                  "--ckpt-every", "10", "--lr", "1e-2"],
    "autoshard_h100": [],
}
# example -> lines (regex) that may differ from the reference's output
UNCOMPARED = {
    "quickstart": (),
    "multi_model_concurrent": (r"^compiled lane program: ",),
    "dynamic_rescheduling": (),
    "vla_pipeline": (r"^executed frontier plan on ",),
}
# what each example must print (its last check)
LAST_LINE = {
    "quickstart": "orchestrated output == monolithic output: OK",
    "multi_model_concurrent": "A retires -> re-planned set",
    "dynamic_rescheduling": "recovered outputs are bitwise-identical",
    "vla_pipeline": "VLA pipeline: planned and executed as a DAG workload",
    "streaming_serving": "breaker:",
    "heterogeneous_serving": "served batch: prompts (1, 16) -> generated "
                             "(1, 8)",
    "train_e2e": "parameters bitwise the uninterrupted run's: OK",
    "autoshard_h100": "bitwise the meshless step's",
}


def _run(cmd, env, cwd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                          env=env, cwd=cwd)
    return proc.returncode, proc.stdout, proc.stderr


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONWARNINGS="ignore", OMP_NUM_THREADS="1")
    jobs = {}
    for name, extra in SMALLEST.items():
        if name == "train_e2e":
            extra = extra + ["--ckpt-dir", str(tmp / "ckpt")]
        jobs[("port", name)] = (
            [sys.executable, str(EXAMPLES / f"torch_{name}.py"),
             "--device", "cpu", *extra], env)
    for name in UNCOMPARED:
        jobs[("reference", name)] = (
            [sys.executable, str(EXAMPLES / f"{name}.py")],
            dict(env, JAX_PLATFORMS="cpu"))
    with ThreadPoolExecutor(4) as pool:
        futs = {k: pool.submit(_run, cmd, e, tmp) for k, (cmd, e)
                in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


@pytest.mark.parametrize("name", list(SMALLEST))
def test_example_runs_on_the_cpu(outputs, name):
    rc, out, err = outputs[("port", name)]
    assert rc == 0, err[-3000:]
    assert LAST_LINE[name] in out, out[-2000:]


def _compared(out: str, name: str) -> list[str]:
    return [line for line in out.splitlines()
            if not any(re.search(p, line) for p in UNCOMPARED[name])]


@pytest.mark.parametrize("name", list(UNCOMPARED))
def test_route_and_plan_lines_equal_the_reference(outputs, name):
    rc, ref, err = outputs[("reference", name)]
    assert rc == 0, err[-3000:]
    port = outputs[("port", name)][1]
    assert len(_compared(ref, name)) >= 4
    assert _compared(port, name) == _compared(ref, name)


@pytest.mark.parametrize("name", list(SMALLEST))
def test_example_imports_neither_jax_nor_the_reference(name):
    path = EXAMPLES / f"torch_{name}.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for mod in names:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path.name}: imports {mod}"


def test_an_example_refuses_to_run_without_a_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_quickstart.py")],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "monolithic" not in proc.stdout
