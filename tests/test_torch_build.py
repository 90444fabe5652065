"""The kernel build's bookkeeping, on the CPU: what ``chip_smoke.py``
reads out of ``nvcc -Xptxas -v`` for every kernel instantiation."""
import shutil

from repro_torch.kernels import _build

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111gemm_kernelIfLb1ELb1EEEvPKT_S3_PS1_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111gemm_kernelIfLb1ELb1EEEvPKT_S3_PS1_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110glu_kernelIfLi4EEEvPKT_S3_S3_PS1_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110glu_kernelIfLi4EEEvPKT_S3_S3_PS1_iii
    64 bytes stack frame, 60 bytes spill stores, 68 bytes spill loads
ptxas info    : Used 255 registers, 2048 bytes smem, 392 bytes cmem[0]
"""


def test_ptxas_usage_reads_every_instantiation():
    got = _build.ptxas_usage(PTXAS)
    assert [(u["registers"], u["smem"], u["spill_stores"], u["spill_loads"])
            for u in got] == [(168, 0, 0, 0), (255, 2048, 60, 68)]
    assert got[0]["name"].startswith("_ZN12_GLOBAL__N_111gemm_kernel")
    assert _build.ptxas_usage("nvcc: no ptxas lines\n") == []


def test_demangle_keeps_the_names_without_the_toolkit(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    assert _build.demangle(["_Z1fv", "_Z1gv"]) == ["_Z1fv", "_Z1gv"]
    if shutil.which("nvcc") is None:
        monkeypatch.undo()
        assert _build.demangle(["_Z1fv"]) == ["_Z1fv"]


def test_kernel_variants_still_match_the_sources():
    """Each design variant of ``kernel_variants.py`` is a substitution
    that must match the shipped sources, or the script would time the
    shipped kernel under another name."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "kernel_variants.py"
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    for kernel in kv.KERNELS:
        shipped = kv.sources("shipped", kernel)
        for variant in kv.VARIANTS:
            files = kv.sources(variant, kernel)
            if files is not None and variant != "shipped":
                assert files != shipped, (variant, kernel)
    # every kernel has its variants, the SSD scan's fold among them
    assert set(kv.KERNELS) == set(_build.KERNELS)
    for variant, kernel in (("fold64", "ssd_scan"), ("one_tf32", "ssd_scan"),
                            ("cvt_rna", "ssd_scan")):
        assert kv.sources(variant, kernel) is not None, (variant, kernel)
    assert "constexpr int FOLD_K8 = 8;" in \
        kv.sources("fold64", "ssd_scan")["ssd_scan.cu"]
