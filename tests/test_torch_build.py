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
    fold64 = kv.sources("fold64", "ssd_scan")["ssd_scan.cu"]
    assert "constexpr int ST_FOLD = 64;" in fold64
    assert "constexpr int N_FOLD = 64;" in fold64
    # the bf16 attention's variants, each a copy with every header
    for variant in kv.ATTN_BF16:
        files = kv.sources(variant, "flash_attention")
        assert set(files) == {"flash_attention.cu", "common.cuh",
                              "hopper.cuh"}, variant
    assert "Wgmma<D>::rs(acc, lo[kk]" not in \
        kv.sources("p_one_bf16", "flash_attention")["flash_attention.cu"]


def test_build_key_covers_every_included_header(tmp_path, monkeypatch):
    """A library's name hashes its source and every header it includes,
    directly or through another header, so an edited header is never
    served by a stale library."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cmath>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [f.name for f in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    before = _build._lib_path("k")
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build._lib_path("k") != before
    monkeypatch.undo()
    assert [f.name for f in _build.sources("flash_attention")] == [
        "flash_attention.cu", "common.cuh", "hopper.cuh"]


def test_ssd_build_key_covers_hopper_header():
    """The SSD scan includes ``hopper.cuh`` (its bf16 chunk outputs run on
    wgmma and TMA), so an edit of that header rebuilds it too."""
    assert [f.name for f in _build.sources("ssd_scan")] == [
        "ssd_scan.cu", "common.cuh", "hopper.cuh"]


def test_ssd_scan_bf16_variants_match_the_sources():
    """The bf16 SSD scan's design variants and ablations in
    ``kernel_variants.py`` each change its source, with every header
    copied beside it."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "kernel_variants.py"
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    shipped = kv.sources("shipped", "ssd_scan")
    assert "out_wgmma_kernel" in shipped["ssd_scan.cu"]
    for variant in kv.SSD_BF16[1:]:
        files = kv.sources(variant, "ssd_scan")
        assert files is not None and files != shipped, variant
        assert set(files) == {"ssd_scan.cu", "common.cuh", "hopper.cuh"}
    got = {v: kv.sources(v, "ssd_scan")["ssd_scan.cu"] for v in kv.SSD_BF16}
    assert "constexpr int KV = 64;" in got["kv64"]
    assert "constexpr int S_TERMS = 3;" in got["s_three"]
    assert "constexpr int G_TERMS = 1;" in got["g_one_bf16"]
    assert "constexpr int G_TERMS = 2;" in got["g_two"]
    assert "constexpr int MAX_STAGES = 2;" in got["stages2"]
    assert "constexpr int W_TERMS = 3;" in got["w_three"]
    assert "if (false)" in got["qtile"]
    assert "constexpr int S_TERMS = 0;" in got["no_inter"]
    assert got["score_p0"].count("L.c_sub(), pt ? 0 : nsub);") == 2


def test_expert_glu_variants_match_the_sources():
    """The f32 and bf16 expert GLU's baselines, fold, chain, ring and
    token-tile variants and their ablations in ``kernel_variants.py``
    each change its source, every header copied beside it (it includes
    ``hopper.cuh`` since both wgmma designs run on it and TMA, so an edit
    of that header rebuilds it); the bf16 variants leave the f32 design
    as shipped."""
    import importlib.util
    from pathlib import Path
    assert [f.name for f in _build.sources("expert_glu")] == [
        "expert_glu.cu", "common.cuh", "hopper.cuh"]
    path = Path(__file__).resolve().parents[1] / "kernel_variants.py"
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    shipped = kv.sources("shipped", "expert_glu")["expert_glu.cu"]
    assert "glu_wgmma_kernel" in shipped
    assert "glu_bf16_kernel" in shipped
    got = {}
    assert set(kv.GLU_F32) | set(kv.GLU_BF16) <= set(kv.VARIANTS)
    for variant in sorted(set(kv.GLU_F32[1:]) | set(kv.GLU_BF16[1:])):
        files = kv.sources(variant, "expert_glu")
        assert set(files) == {"expert_glu.cu", "common.cuh", "hopper.cuh"}
        assert files != kv.sources("shipped", "expert_glu"), variant
        got[variant] = files["expert_glu.cu"]
    assert "if (false && tc::tma_route(" in got["mma_sync"]
    assert "return dispatch<float>(x, w_up" in got["mma_sync"]
    assert "dispatch<float>(" not in shipped
    assert "constexpr int FOLD = 1;" in got["fold1"]
    assert "constexpr int FOLD = 1 << 30;" in got["no_fold"]
    assert "constexpr int BM = 64;" in got["bm64"]
    assert "constexpr int STAGES = 4;" in got["ring4"]
    assert got["no_lohi"].count("WgmmaTf32<BM>::rs(") == 2
    assert got["one_tf32"].count("WgmmaTf32<BM>::rs(") == 1
    assert "WgmmaTf32<BM>::rs(" not in got["no_mma"]
    assert "q < 0; ++q" in got["no_bsplit"]
    assert "warps16" not in kv.VARIANTS
    # the bf16 design: its route off (the same build times the mma.sync
    # kernel), rings, token tile and chain, and no products
    assert ("if (false && bf::tma_route(x, w_up, w_down, act, y, d, F))"
            in got["mma_sync"])
    assert "constexpr int STAGES = 3;   // the ring of TMA stages" in got["ring3"]
    assert "const bool narrow = true;" in got["bm128"]
    assert shipped.count("Wgmma<128>::ss_t(") == 1
    assert "Wgmma<128>::ss_t(" not in got["no_mma"]
    tc = shipped.split("namespace tc {")[1].split("namespace bf {")[0]
    for variant in ("ring3", "bm128"):
        assert got[variant].split("namespace tc {")[1].split(
            "namespace bf {")[0] == tc, variant


def test_bf16_expert_glu_rule_mirrors_the_c_entry():
    """``moe_gather.bf16_kernels`` states the C entry's rule
    (``bf::tma_route``): d and F multiples of 8 with x, w_up, w_down (and
    the wrapper's own act and y) on 16-byte boundaries take the wgmma
    design; every other bf16 call the mma.sync kernel."""
    import re

    import torch

    from repro_torch.kernels import moe_gather as mg
    src = (_build.CSRC / "expert_glu.cu").read_text()
    bf = src.split("namespace bf {")[1]
    rule = re.search(r"inline bool tma_route\(.*?\{\s*return (.*?);", bf,
                     re.S).group(1)
    assert re.sub(r"\s+", " ", rule) == (
        "d % 8 == 0 && F % 8 == 0 && bident::aligned16(x) && "
        "bident::aligned16(w_up) && bident::aligned16(w_down) && "
        "bident::aligned16(act) && bident::aligned16(y)")
    entry = src.split('extern "C" int bident_expert_glu(')[1]
    assert "if (bf::tma_route(x, w_up, w_down, act, y, d, F))" in entry
    assert entry.index("bf::tma_route") < entry.index(
        "dispatch<__nv_bfloat16>")

    def t(*shape, offset=0):
        flat = torch.zeros(offset + int(torch.tensor(shape).prod()),
                           dtype=torch.bfloat16)
        return flat[offset:].view(shape)
    for E, cap, d, F in ((32, 256, 1024, 512), (1, 16, 8, 8), (3, 70, 64, 40)):
        assert mg.bf16_kernels(t(E, cap, d), t(E, d, 2 * F), t(E, F, d)) \
            == mg.BF16_WGMMA_KERNELS
    for x, wu, wd in ((t(3, 70, 36), t(3, 36, 40), t(3, 20, 36)),
                      (t(3, 20, 18), t(3, 18, 20), t(3, 10, 18)),
                      (t(2, 64, 64, offset=1), t(2, 64, 64), t(2, 32, 64)),
                      (t(2, 64, 64), t(2, 64, 64, offset=4), t(2, 32, 64)),
                      (t(2, 64, 64), t(2, 64, 64), t(2, 32, 64, offset=2))):
        assert mg.bf16_kernels(x, wu, wd) == mg.BF16_MMA_SYNC_KERNELS


def test_f32_attention_variants_match_the_sources():
    """The f32 attention's baseline, tile, ring and split variants and its
    ablations in ``kernel_variants.py`` each change the source of the
    TF32 wgmma design (or its route), every header copied beside it; the
    C entry's rule names the head dims ``flash_attention.f32_kernel``
    routes to it."""
    import importlib.util
    import re
    from pathlib import Path

    from repro_torch.kernels import flash_attention as fa
    path = Path(__file__).resolve().parents[1] / "kernel_variants.py"
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    shipped = kv.sources("shipped", "flash_attention")["flash_attention.cu"]
    rule = re.search(r"inline bool tma_route\(.*?\{\s*return (.*?);", shipped,
                     re.S).group(1)
    dims = tuple(int(d) for d in re.findall(r"D == (\d+)", rule))
    assert dims == fa.F32_WGMMA_HEAD_DIMS
    assert all(f"bident::aligned16({x})" in rule for x in "qkv")
    got = {}
    for variant in kv.ATTN_F32[1:]:
        files = kv.sources(variant, "flash_attention")
        assert set(files) == {"flash_attention.cu", "common.cuh",
                              "hopper.cuh"}, variant
        assert files != kv.sources("shipped", "flash_attention"), variant
        got[variant] = files["flash_attention.cu"]
    assert "if (false && tf::tma_route(q, k, v, D))" in got["mma_sync"]
    assert got["one_tf32"].count("WgmmaTf32<C::BK>::ss(") == 1
    assert got["one_tf32"].count("WgmmaTf32<DH>::rs(") == 1
    assert "bident::mma_tf32(c, al, bh)" not in got["one_tf32"]
    assert "WgmmaTf32<" not in got["no_mma"]
    assert kv.TF_KV not in got["f32_kv32"]
    assert "return D == 160 ? 16 : 32;" in got["f32_kv32"]
    assert kv.TF_RING.replace("4;", "3;") in got["f32_ring3"]
    assert "constexpr int RING = 2;" in got["f32_stages2"]
    assert "(w == 0 ? nk : 0)" in got["kv_one_wg"]
    assert "pv_mma<D, D, BK>(acc, hi, lo, vth, vtl);" in got["o_in_place"]
    assert "float pv[DH / 2];" not in got["o_in_place"]
    # the bf16 design's variants leave the f32 one as shipped
    bf16_ring = kv.sources("stages2", "flash_attention")["flash_attention.cu"]
    assert kv.TF_RING in bf16_ring


def _kernel_variants():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "kernel_variants.py"
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    return kv


def test_f32_ssd_scan_variants_match_the_sources():
    """The f32 SSD scan's baseline (the mma.sync kernels), product,
    fold, state-tile and ring variants and its ablation in
    ``kernel_variants.py`` each change the source of the TF32 wgmma
    design (or its route), every header copied beside it, ``hopper.cuh``
    in the build key; the bf16 design's variants leave it as shipped."""
    kv = _kernel_variants()
    assert [f.name for f in _build.sources("ssd_scan")] == [
        "ssd_scan.cu", "common.cuh", "hopper.cuh"]
    shipped = kv.sources("shipped", "ssd_scan")["ssd_scan.cu"]
    assert "state_tf32_kernel" in shipped and "out_tf32_kernel" in shipped
    got = {}
    for variant in kv.SSD_F32[1:]:
        files = kv.sources(variant, "ssd_scan")
        assert set(files) == {"ssd_scan.cu", "common.cuh", "hopper.cuh"}
        assert files != kv.sources("shipped", "ssd_scan"), variant
        got[variant] = files["ssd_scan.cu"]
    assert "if (false && tf::tma_route(c, b, v, N, P))" in got["mma_sync"]
    for variant, n in (("one_tf32", 1), ("no_mma", 0)):
        assert got[variant].count("WgmmaTf32<NS>::rs(part") == n, variant
        assert got[variant].count("M::rs(d, ") == n, variant
        assert got[variant].count("WgmmaTf32<PW>::rs(part") == n, variant
        # the wide outputs kernel: two interleaved chains, or one
        assert got[variant].count("M::rs(da, ") == 2 * n, variant
        assert got[variant].count("M::rs(db, ") == n, variant
    assert shipped.count("WgmmaTf32<NS>::rs(part") == 3
    assert shipped.count("M::rs(da, ") == 6
    assert shipped.count("M::rs(db, ") == 3
    assert "return 32;" in got["st32"] and "return 64;" in got["st64"]
    assert "constexpr int OUT_STAGES = 2;" in got["f32_stages2"]
    assert "constexpr int ST_STAGES = 3;    // b / v tiles in flight, " \
        "state kernel" in got["st_stages3"]
    # the wide design's variants (xLSTM-125M's mLSTM shape)
    for variant in kv.SSD_F32_WIDE[1:]:
        files = kv.sources(variant, "ssd_scan")
        assert set(files) == {"ssd_scan.cu", "common.cuh", "hopper.cuh"}
        assert files != kv.sources("shipped", "ssd_scan"), variant
        got[variant] = files["ssd_scan.cu"]
    assert "constexpr int WIDE_STAGES = 3;" in got["wide_ring3"]
    assert "constexpr int WIDE_SPLITS = 1;" in got["wide_splits1"]
    assert "constexpr int WIDE_SPLIT_WARPS = 4;" in got["wide_split4"]
    assert "if (it < NI || gv || pt == 0)" in got["wide_score_p0"]
    # the mma.sync kernels' bf16 branches are gone, and so is the variant that fed them
    assert "EXACT" not in shipped and "tf32" not in kv.VARIANTS
    for variant in kv.SSD_BF16[1:]:
        assert "state_tf32_kernel" in kv.sources(variant, "ssd_scan")[
            "ssd_scan.cu"]
        tf = kv.sources(variant, "ssd_scan")["ssd_scan.cu"].split(
            "namespace tf {")[1]
        assert tf == shipped.split("namespace tf {")[1], variant


def test_f32_ssd_scan_rule_mirrors_the_c_entry():
    """``ssd_scan.f32_kernels`` states the C entry's rule
    (``tf::tma_route``): with c and b on 16-byte boundaries, N a multiple
    of 64 from 128 to 448 takes the wgmma design at any P and v (v's
    padded copy first where TMA cannot read it, ``tf::pad_v``), and N =
    64 with v on a 16-byte boundary and P a multiple of 4, at least 32;
    every other f32 call the mma.sync kernels.  The wrapper's scratch
    (``scratch_floats``) holds the padded copy where the rule makes one."""
    import re

    import torch

    from repro_torch.kernels import ssd_scan as ss
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    rule = re.search(r"inline bool tma_route\(.*?\{\s*return (.*?);", src,
                     re.S).group(1)
    assert re.sub(r"\s+", " ", rule) == (
        "bident::aligned16(c) && bident::aligned16(b) && ((N % 64 == 0 && "
        "N >= WIDE_MIN && N <= WIDE_MAX) || (N == NW && P % 4 == 0 && "
        "P >= 32 && bident::aligned16(v)))")
    pad = re.search(r"inline bool pad_v\(.*?\{\s*return (.*?);", src,
                    re.S).group(1)
    assert re.sub(r"\s+", " ", pad) == (
        "N != NW && !(P % 4 == 0 && P >= 32 && bident::aligned16(v))")
    nw = int(re.search(r"constexpr int NW = (\d+);", src).group(1))
    assert nw == ss.F32_WGMMA_STATE
    wide = tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                 for k in ("WIDE_MIN", "WIDE_MAX"))
    assert wide == ss.F32_WIDE_STATES == (128, 448)
    assert "if (tf::tma_route(c, b, v, N, P))" in src

    def x(*shape, offset=0):
        flat = torch.zeros(offset + int(torch.tensor(shape).prod()))
        return flat[offset:].view(shape)
    cb = x(1, 8, 2, 64)
    assert ss.f32_kernels(cb, cb, x(1, 8, 2, 64)) == ss.F32_WGMMA_KERNELS
    assert ss.f32_kernels(cb, cb, x(1, 8, 2, 32)) == ss.F32_WGMMA_KERNELS
    for c, b, v in ((x(1, 8, 2, 16), x(1, 8, 2, 16), x(1, 8, 2, 64)),
                    (cb, cb, x(1, 8, 2, 385)), (cb, cb, x(1, 8, 2, 16)),
                    (x(1, 8, 2, 64, offset=1), cb, x(1, 8, 2, 64)),
                    (cb, cb, x(1, 8, 2, 64, offset=1))):
        assert ss.f32_kernels(c, b, v) == ss.F32_MMA_SYNC_KERNELS
    # above N = 64: the wide design at any P and v, where c and b are on
    # 16 bytes; v copied first where TMA cannot read it
    wide = x(1, 8, 2, 384)
    assert ss.f32_kernels(wide, wide, x(1, 8, 2, 384)) == \
        ss.F32_WIDE_KERNELS
    for v in (x(1, 8, 2, 385), x(1, 8, 2, 384, offset=1), x(1, 8, 2, 16)):
        assert ss.f32_kernels(wide, wide, v) == ss.F32_WIDE_PAD_KERNELS
    for N in (128, 192, 320, 448):
        assert ss.f32_kernels(x(1, 8, 2, N), x(1, 8, 2, N),
                              x(1, 8, 2, 96)) == ss.F32_WIDE_KERNELS
    for c, b in ((x(1, 8, 2, 96), x(1, 8, 2, 96)),
                 (x(1, 8, 2, 496), x(1, 8, 2, 496)),
                 (x(1, 8, 2, 384, offset=1), wide),
                 (wide, x(1, 8, 2, 384, offset=2))):
        assert ss.f32_kernels(c, b, x(1, 8, 2, 385)) == \
            ss.F32_MMA_SYNC_KERNELS
    # the scratch: S_in and tot, then from the next multiple of 4 the
    # padded rows (P 385 -> 388 floats) where the rule copies v
    B, T, H, nc = 1, 8, 2, 1
    assert ss.scratch_floats(wide, wide, x(1, 8, 2, 384), 8) == \
        B * H * nc * (384 * 384 + 1)
    base = B * H * nc * (384 * 385 + 1)
    assert ss.scratch_floats(wide, wide, x(1, 8, 2, 385), 8) == \
        -(-base // 4) * 4 + B * T * H * 388
    assert ss.scratch_floats(wide, wide, x(1, 8, 2, 16), 8) == \
        -(-(B * H * nc * (384 * 16 + 1)) // 4) * 4 + B * T * H * 32
    assert ss.scratch_floats(cb, cb, x(1, 8, 2, 385), 8) == \
        B * H * nc * (64 * 385 + 1)
