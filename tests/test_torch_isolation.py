"""The port stands alone: no JAX, no reference package, the card by
default.

* every ``repro_torch`` module (and ``chip_smoke.py``) imports in a
  fresh interpreter where ``jax`` and ``repro`` are blocked;
* no import statement in the port names ``jax`` or ``repro``;
* the entry points raise without a CUDA device unless asked for the CPU;
* ``chip_smoke.py`` alone, or without a card, exits non-zero and prints
  no result.
"""
import ast
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.core import backends, kernel_chain
from repro_torch.launch.mesh import make_host_mesh

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules() -> list[str]:
    return ["repro_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch."))


def test_every_module_imports_with_jax_and_repro_blocked():
    modules = _modules()
    assert {"repro_torch.core.orchestrator", "repro_torch.kernels.ops",
            "repro_torch.fault.manager",
            "repro_torch.core.contention", "repro_torch.sharding",
            "repro_torch.configs.base", "repro_torch.configs.zamba2_2_7b",
            "repro_torch.models.layers", "repro_torch.models.model",
            "repro_torch.serving.engine",
            "repro_torch.launch.serve", "repro_torch.launch.train",
            "repro_torch.optim.adamw", "repro_torch.optim.compress",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.ckpt",
            "repro_torch.train.trainer", "repro_torch.core.autoshard",
            "repro_torch.launch.mesh", "repro_torch.launch.specs",
            "repro_torch.launch.roofline",
            "repro_torch.launch.dryrun"} <= set(modules)
    code = "\n".join([
        "import sys",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
        "for name in ('jax', 'jaxlib', 'repro'):",
        "    sys.modules[name] = None     # any import of them now fails",
        "import importlib",
        f"for m in {modules!r} + ['chip_smoke']:",
        "    importlib.import_module(m)",
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))",
        "               for k, v in sys.modules.items() if v is not None)",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"], ids=lambda p: p.name)
def test_no_import_names_jax_or_the_reference(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}: imports {name}"


def test_mesh_and_dryrun_import_without_a_process_group():
    code = "\n".join([
        "import sys",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]",
        "import torch.distributed as dist",
        "import repro_torch.launch.dryrun, repro_torch.launch.mesh",
        "import repro_torch.launch.roofline, repro_torch.core.autoshard",
        "assert not dist.is_initialized()",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_chain()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backends.default_registry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    graph, ext = kernel_chain(device="cpu")
    assert ext[0][0].device.type == "cpu" and len(graph) == 6
    assert backends.default_registry(device="cpu").names() == \
        ["numpy-eager", "torch-cpu"]


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
