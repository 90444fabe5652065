"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the port.  Modules are compared by their
whole top-level name: the port's name begins with the JAX package's."""
from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

from chipbench import harness

BENCH = harness.BENCH
JAX_SIDE = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def _sources(*parts) -> list[Path]:
    return sorted(BENCH.joinpath(*parts).rglob("*.py"))


def test_no_source_imports_the_jax_side():
    files = [p for p in _sources() if "tests" not in p.parts]
    assert files
    for p in files:
        assert not _top_level_imports(p) & JAX_SIDE, p


def test_references_import_nothing_of_the_port():
    for p in _sources("reference"):
        names = _top_level_imports(p)
        assert not names & (JAX_SIDE | {"repro_torch", "chipbench"}), p
        assert names <= {"__future__", "math", "typing", "torch"}, (p, names)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "reproduce.x", sys)
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert set(harness.forbidden_modules()) == before | {"jaxlib"}


def test_a_run_loads_nothing_of_the_jax_side():
    """A whole run of each cell at tiny sizes in a fresh process, then
    the modules it holds."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(harness.ROOT / 'src')!r}, {str(harness.ROOT)!r}]
        import torch
        from chipbench import harness
        from chipbench.tests.conftest import tiny_spec
        for cell in ("chain-route", "zamba2-prefill"):
            res = harness.run_spec(tiny_spec(cell), 7, 0.2, False,
                                   torch.device("cpu"), time.perf_counter())
            assert res["correct"], res
        print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & JAX_SIDE, loaded & JAX_SIDE
