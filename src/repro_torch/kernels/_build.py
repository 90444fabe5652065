"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ``ctypes``.  Builds happen at first use, all
sources in parallel, into ``build/kernels/`` at the root of the checkout;
a library's file name carries a hash of its sources and flags, so an
edited source is rebuilt and a stale library is never loaded.

Each kernel wrapper launches through :func:`launch`, which counts the
launches, so a run can show that its main path really went through the
kernels; :func:`check_operands` holds the checks every wrapper shares.
Under a CUDA graph capture nothing is launched: the thread's launches
are recorded (:func:`recording_launches`) and counted at every replay of
the graph (:func:`add_launches`).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("flash_attention", "ssd_scan", "expert_glu")
FLOATS = (torch.float32, torch.bfloat16)   # operand dtypes the kernels take
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: device pointers and the stream as void*, sizes as int;
# every entry point returns its launch's cudaError_t
_SIGNATURES = {
    "flash_attention": ("bident_flash_attention", [_P] * 4 + [_I] * 9 + [_P]),
    "ssd_scan": ("bident_ssd_scan", [_P] * 8 + [_I] * 7 + [_P]),
    "expert_glu": ("bident_expert_glu", [_P] * 5 + [_I] * 5 + [_P]),
}

_lock = threading.Lock()
_fns: dict[str, object] = {}
_launches: collections.Counter = collections.Counter()
_count_lock = threading.Lock()   # lanes may launch from several threads
_local = threading.local()       # .recording: this thread's capture, if any
build_log: dict[str, str] = {}   # kernel -> nvcc/ptxas output of its build


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``,
    else the ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> dict[str, Path]:
    """Compile every kernel not built yet, one ``nvcc`` per source, all
    started together; raises with the compiler's output on a failure.
    Returns ``{name: library path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    compiler = None
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        compiler = compiler or nvcc()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


_PTXAS_ENTRY = re.compile(r"(?:Compiling entry function '|Function "
                          r"properties for )([\w$.]+)")
_PTXAS_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_usage(out: str) -> list[dict]:
    """What ``nvcc -Xptxas -v`` output (a ``build_log`` entry) reports
    for each kernel instantiation, in order: ``name`` (mangled),
    ``registers`` a thread, ``smem`` (static shared memory bytes; the
    kernels' dynamic shared memory is set at launch), ``spill_stores``
    and ``spill_loads`` bytes."""
    rows: dict[str, dict] = {}
    cur = None
    for line in out.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = rows.setdefault(m.group(1), dict(
                name=m.group(1), registers=None, smem=0, spill_stores=0,
                spill_loads=0))
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILLS.search(line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _PTXAS_USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _PTXAS_SMEM.search(line)
            cur["smem"] = int(s.group(1)) if s else 0
    return [r for r in rows.values() if r["registers"] is not None]


def demangle(names: list[str]) -> list[str]:
    """C++ names of mangled kernel symbols, by the toolkit's ``cu++filt``
    (the names unchanged where it is missing)."""
    try:
        tool = Path(nvcc()).with_name("cu++filt")
        out = subprocess.run([str(tool)], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return list(names)
    got = out.stdout.splitlines()
    return got if out.returncode == 0 and len(got) == len(names) else \
        list(names)


def function(name: str):
    """The bound C entry point of kernel ``name`` (built at first use)."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _fns:
            paths = build_all()
            for n, (symbol, argtypes) in _SIGNATURES.items():
                f = getattr(ctypes.CDLL(str(paths[n])), symbol)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _fns[n] = f
    return _fns[name]


def check_operands(name: str, **operands) -> None:
    """Raise unless every operand lies on one CUDA device, is contiguous
    and has one of its accepted dtypes (``arg=(tensor, dtypes)``)."""
    device = None
    for arg, (t, dtypes) in operands.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} lies on {t.device}, not a CUDA "
                             "device (the CPU takes the plain version)")
        if device is not None and t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, other "
                             f"operands on {device}")
        device = t.device
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}; the kernel "
                            f"takes {[str(d) for d in dtypes]} here")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point; raise if it reports a CUDA
    error, else count the launch (or, under a capture on this thread,
    record it for the graph's replays)."""
    err = function(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    recording = getattr(_local, "recording", None)
    if recording is not None:
        recording[name] += 1
        return
    with _count_lock:
        _launches[name] += 1


@contextlib.contextmanager
def recording_launches():
    """While a CUDA graph is captured on this thread: the kernels this
    thread's wrappers put into the graph, counted into the yielded
    ``Counter`` and not into :func:`launch_counts` (nothing runs until a
    replay, which adds them with :func:`add_launches`)."""
    outer = getattr(_local, "recording", None)
    _local.recording = collections.Counter()
    try:
        yield _local.recording
    finally:
        _local.recording = outer


def add_launches(counts) -> None:
    """Count the launches of one replayed graph (``{kernel: launches}``,
    as :func:`recording_launches` recorded them)."""
    with _count_lock:
        _launches.update(counts)


def launch_counts() -> dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return {n: _launches[n] for n in KERNELS}


def reset_launch_counts() -> None:
    with _count_lock:
        _launches.clear()
