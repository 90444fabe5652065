"""Fused-operator graphs for the paper's own evaluated models (Table 1).

A copy of ``repro.core.paperzoo`` on the port's ``FusedOp``/``OpGraph``:
the graphs are analytic (shapes and kinds, no payloads), so nothing here
touches a device.

BIDENT evaluates ten model families on the Intel Core Ultra SoC.  To
reproduce Tables 2/3 and Figures 6/8 we rebuild each model's fused-operator
DAG at the paper's granularity (Table 1 "fused ops"), with operand shapes
from the published input shapes.  The *kind mix* is what drives every
result: conv-heavy (ResNet/SNN), GEMM-heavy (ViT/LLaMA/BitNet), FFT
(Hyena), sequential-scan (Mamba), spline-gather (KAN), dual-tower
(LAVISH), and the 4-stage VLA pipeline (pi05).

Each builder returns an ``OpGraph`` (fork/join edges where the paper
exploits intra-model parallelism) and takes ``dtb`` (2 = FP16, 1 = INT8,
the paper's two precision columns).  KAN ops carry
``unsupported_on=("NPU",)`` — the paper's compile-failure case (BitwiseAnd
on float inputs); pi05's prefix/denoise stages carry
``unsupported_on=("GPU",)`` (exceeds GPU memory).
"""
from __future__ import annotations

from typing import Sequence

from .op import FusedOp, OpGraph


class _G:
    """Tiny DAG-builder helper (chain by default, explicit forks)."""

    def __init__(self):
        self.ops: list[FusedOp] = []
        self.edges: list[tuple[int, int]] = []
        self.tail: int | None = None

    def add(self, op: FusedOp, after="tail") -> int:
        idx = len(self.ops)
        self.ops.append(op)
        if after == "tail":
            if self.tail is not None:
                self.edges.append((self.tail, idx))
        elif after is None:
            pass
        else:
            for a in (after if isinstance(after, (list, tuple)) else [after]):
                self.edges.append((a, idx))
        self.tail = idx
        return idx

    def graph(self) -> OpGraph:
        return OpGraph(self.ops, edges=self.edges)


def _conv(name, cin, cout, hw, k, dtb, stride=1, unsupported=()):
    out_hw = hw // stride
    return FusedOp(name=name, kind="conv2d",
                   in_shapes=((1, cin, hw, hw), (cout, cin, k, k)),
                   out_shape=(1, cout, out_hw, out_hw), dtype_bytes=dtb,
                   meta={"unsupported_on": unsupported})


def _mm(name, m, k, n, dtb, unsupported=()):
    return FusedOp(name=name, kind="matmul",
                   in_shapes=((1, m, k), (k, n)), out_shape=(1, m, n),
                   dtype_bytes=dtb, meta={"unsupported_on": unsupported})


def _elt(name, kind, numel, dtb, unsupported=()):
    return FusedOp(name=name, kind=kind, in_shapes=((numel,),),
                   out_shape=(numel,), dtype_bytes=dtb,
                   meta={"unsupported_on": unsupported})


# ---------------------------------------------------------------------------
# CNNs / Transformers
# ---------------------------------------------------------------------------


def resnet50(dtb: int = 2) -> OpGraph:
    """1x3x224x224; ~73 fused Conv-BN-ReLU ops + residual adds."""
    g = _G()
    g.add(_conv("stem", 3, 64, 224, 7, dtb, stride=2))
    cfgs = [(64, 256, 56, 3), (128, 512, 28, 4), (256, 1024, 14, 6),
            (512, 2048, 7, 3)]
    cin = 64
    for bi, (mid, cout, hw, reps) in enumerate(cfgs):
        for r in range(reps):
            g.add(_conv(f"b{bi}.{r}.c1", cin, mid, hw, 1, dtb))
            g.add(_conv(f"b{bi}.{r}.c2", mid, mid, hw, 3, dtb))
            g.add(_conv(f"b{bi}.{r}.c3", mid, cout, hw, 1, dtb))
            g.add(_elt(f"b{bi}.{r}.add", "add", cout * hw * hw, dtb))
            cin = cout
    g.add(FusedOp(name="pool", kind="norm", in_shapes=((1, 2048, 7, 7),),
                  out_shape=(1, 2048), dtype_bytes=dtb))
    g.add(_mm("fc", 1, 2048, 1000, dtb))
    return g.graph()


def vit_b16(dtb: int = 2, head_branches: int = 4) -> OpGraph:
    """1x3x224x224 -> 197 tokens x 768; 12 layers.  Attention splits into
    ``head_branches`` independent head-group branches per layer (the
    paper's "independent attention heads execute on different PUs",
    Table 3: ViT has the most concurrent phases)."""
    g = _G()
    T, d, ff = 197, 768, 3072
    g.add(_conv("patch", 3, d, 224, 16, dtb, stride=16))
    for i in range(12):
        g.add(_elt(f"L{i}.ln1", "norm", T * d, dtb))
        fork = g.add(_mm(f"L{i}.qkv", T, d, 3 * d, dtb))
        heads = []
        dh = d // head_branches
        for h in range(head_branches):
            a = g.add(FusedOp(name=f"L{i}.attn{h}", kind="attention",
                              in_shapes=((1, head_branches, T, dh),
                                         (1, head_branches, T, dh)),
                              out_shape=(1, head_branches, T, dh),
                              dtype_bytes=dtb), after=fork)
            heads.append(a)
        g.add(_mm(f"L{i}.o", T, d, d, dtb), after=heads)
        g.add(_elt(f"L{i}.ln2", "norm", T * d, dtb))
        g.add(_mm(f"L{i}.mlp1", T, d, ff, dtb))
        g.add(_elt(f"L{i}.gelu", "act", T * ff, dtb))
        g.add(_mm(f"L{i}.mlp2", T, ff, d, dtb))
    g.add(_mm("head", 1, d, 1000, dtb))
    return g.graph()


def llama_1l(dtb: int = 2) -> OpGraph:
    """One LLaMA-7B decoder layer at 1x128 (13 fused ops, Fig. 5)."""
    g = _G()
    T, d, ff = 128, 4096, 11008
    g.add(_elt("ln1", "norm", T * d, dtb))
    g.add(_mm("q", T, d, d, dtb))
    g.add(_mm("k", T, d, d, dtb))
    g.add(_mm("v", T, d, d, dtb))
    g.add(FusedOp(name="attn", kind="attention",
                  in_shapes=((1, 32, T, 128), (1, 32, T, 128)),
                  out_shape=(1, 32, T, 128), dtype_bytes=dtb))
    g.add(_mm("o", T, d, d, dtb))
    g.add(_elt("ln2", "norm", T * d, dtb))
    f = g.add(_mm("gate_proj", T, d, ff, dtb))
    g.add(_mm("up_proj", T, d, ff, dtb), after=f - 1)  # parallel with gate
    g.add(_elt("silu", "act", T * ff, dtb), after=f)
    g.add(_elt("mul", "mul", T * ff, dtb), after=[f + 1, f + 2])
    g.add(_mm("down_proj", T, ff, d, dtb))
    g.add(_elt("residual", "add", T * d, dtb))
    return g.graph()


def bitnet(dtb: int = 2) -> OpGraph:
    """Ternary transformer, 36 fused ops, single sequential chain
    (0 concurrent phases, Table 3)."""
    g = _G()
    T, d, ff = 128, 2048, 5460
    for i in range(3):
        g.add(_elt(f"L{i}.ln1", "norm", T * d, dtb))
        g.add(_mm(f"L{i}.qkv", T, d, 3 * d, 1))      # ternary weights
        g.add(FusedOp(name=f"L{i}.attn", kind="attention",
                      in_shapes=((1, 16, T, 128), (1, 16, T, 128)),
                      out_shape=(1, 16, T, 128), dtype_bytes=dtb))
        g.add(_mm(f"L{i}.o", T, d, d, 1))
        g.add(_elt(f"L{i}.add1", "add", T * d, dtb))
        g.add(_elt(f"L{i}.ln2", "norm", T * d, dtb))
        g.add(_mm(f"L{i}.up", T, d, ff, 1))
        g.add(_elt(f"L{i}.act", "act", T * ff, dtb))
        g.add(_mm(f"L{i}.gate", T, ff, ff, 1))
        g.add(_elt(f"L{i}.mul", "mul", T * ff, dtb))
        g.add(_mm(f"L{i}.down", T, ff, d, 1))
        g.add(_elt(f"L{i}.add2", "add", T * d, dtb))
    return g.graph()


# ---------------------------------------------------------------------------
# Emerging architectures
# ---------------------------------------------------------------------------


def mamba_370m(dtb: int = 2) -> OpGraph:
    """Selective SSM at 1x128 (~52 fused ops).  The selective-scan
    recurrences are the paper's CumSum-affinity case (CPU-favoured).
    Parallel SSM branches give Table 3's 25 concurrent phases."""
    g = _G()
    T, d, di, N = 128, 1024, 2048, 16
    for i in range(8):
        fork = g.add(_mm(f"L{i}.in_proj", T, d, 2 * di, dtb))
        # x-branch: conv + scan;   z-branch: gate activation (independent)
        c = g.add(FusedOp(name=f"L{i}.conv", kind="dwconv",
                          in_shapes=((1, di, T, 1), (di, 1, 4, 1)),
                          out_shape=(1, di, T, 1), dtype_bytes=dtb),
                  after=fork)
        s = g.add(FusedOp(name=f"L{i}.scan", kind="cumsum",
                          in_shapes=((1, di, T),), out_shape=(1, di, T),
                          dtype_bytes=dtb))
        z = g.add(_elt(f"L{i}.zgate", "act", T * di, dtb), after=fork)
        g.add(_elt(f"L{i}.mul", "mul", T * di, dtb), after=[s, z])
        g.add(_mm(f"L{i}.out_proj", T, di, d, dtb))
    g.add(_mm("head", 1, d, 50280, dtb))
    return g.graph()


def hyena(dtb: int = 2) -> OpGraph:
    """FFT long-convolution operator mix at 1x1x1024x512.  RDFT/IRDFT +
    elementwise gating are CPU-affine (Fig. 2); the dense projections are
    GEMMs.  448 fused ops at FP16 (order-2 filters over many blocks)."""
    g = _G()
    T, d = 1024, 512
    n_blocks = 56 if dtb == 2 else 11
    for i in range(n_blocks):
        fork = g.add(_mm(f"B{i}.proj", T, d, 3 * d, dtb))
        # two independent filter branches (x1, x2) + gate path
        outs = []
        for br in range(2):
            r = g.add(FusedOp(name=f"B{i}.rdft{br}", kind="rdft",
                              in_shapes=((1, d, T),),
                              out_shape=(1, d, T // 2 + 1, 2),
                              dtype_bytes=dtb), after=fork)
            g.add(_elt(f"B{i}.fmul{br}", "mul", d * (T // 2 + 1) * 2, dtb))
            irf = g.add(FusedOp(name=f"B{i}.irdft{br}", kind="rdft",
                                in_shapes=((1, d, T // 2 + 1, 2),),
                                out_shape=(1, d, T), dtype_bytes=dtb))
            outs.append(irf)
        g.add(_elt(f"B{i}.gate", "mul", d * T, dtb), after=outs)
        g.add(_mm(f"B{i}.out", T, d, d, dtb))
    return g.graph()


def kan(dtb: int = 2) -> OpGraph:
    """Kolmogorov-Arnold network at 1x784 (27 fused ops).  Spline
    evaluation = gather + control-heavy elementwise; CANNOT compile on the
    NPU (BitwiseAnd on float inputs) -> every op omitted from the NPU
    column, the paper's §3.1 fallback-elimination case."""
    g = _G()
    uns = ("NPU",)
    dims = [(784, 128), (128, 128), (128, 64), (64, 10)]
    for i, (din, dout) in enumerate(dims):
        # grid lookup (gather), basis eval (elementwise), spline matmul,
        # base matmul, combine
        g.add(FusedOp(name=f"L{i}.grid_gather", kind="gather",
                      in_shapes=((din * 16, 8), (din,)),
                      out_shape=(din, 8), dtype_bytes=dtb,
                      meta={"unsupported_on": uns}))
        g.add(_elt(f"L{i}.basis", "act", din * 8, dtb, unsupported=uns))
        g.add(_mm(f"L{i}.spline_mm", 1, din * 8, dout, dtb, unsupported=uns))
        f = len(g.ops) - 3
        g.add(_mm(f"L{i}.base_mm", 1, din, dout, dtb, unsupported=uns),
              after=f - 1 if i else None)
        g.add(_elt(f"L{i}.combine", "add", dout, dtb, unsupported=uns),
              after=[len(g.ops) - 2, len(g.ops) - 1])
    # fix chain roots: first layer's base_mm has no predecessor op
    return OpGraph(g.ops, edges=[e for e in g.edges if e[0] >= 0])


def snn_vgg9(dtb: int = 2) -> OpGraph:
    """Spiking VGG9 at 1x1x32x32, 25 timesteps (93 fused ops).

    The op mix behind the paper's largest sequential gain (1.58x): ~50
    membrane-potential convs (grouped over timestep windows, MAC-friendly)
    interleaved with ~40 spiking accumulate/threshold/reset ops.  The
    spiking ops are *control-heavy* — comparisons, conditional resets,
    stateful membrane updates on the DSP/scalar path — the paper's
    KAN-spline affinity class, so they carry the gather-kind cost profile
    (CPU-favoured; order-of-magnitude NPU penalty)."""
    g = _G()
    T = 25
    groups = 5           # convs fuse over 5-timestep windows -> 5 per layer
    Tg = T // groups
    cfgs = [(1, 64, 32), (64, 64, 32), (64, 128, 16), (128, 128, 16),
            (128, 256, 8), (256, 256, 8), (256, 256, 8), (256, 512, 4),
            (512, 512, 4)]
    for i, (cin, cout, hw) in enumerate(cfgs):
        for w in range(groups):
            g.add(FusedOp(name=f"c{i}.w{w}", kind="conv2d",
                          in_shapes=((Tg, cin, hw, hw), (cout, cin, 3, 3)),
                          out_shape=(Tg, cout, hw, hw), dtype_bytes=dtb))
        # spiking neuron dynamics over the full window: the membrane
        # accumulation is a *temporal recurrence* across the 25 steps
        # (cumsum class — the paper's Mamba-scan affinity); threshold
        # compare + conditional reset are control-heavy (gather class);
        # spike trains are binary (1-byte)
        numel = T * cout * hw * hw
        for nm, kd, db in (("acc", "cumsum", 4), ("thresh", "gather", 1),
                           ("reset", "gather", 1), ("enc", "act", 1)):
            g.add(FusedOp(name=f"s{i}.{nm}", kind=kd,
                          in_shapes=((numel,),), out_shape=(numel,),
                          dtype_bytes=db))
    g.add(_mm("fc1", T, 512 * 4 * 4, 1024, dtb))
    g.add(FusedOp(name="fc1.spike", kind="gather",
                  in_shapes=((T * 1024,),), out_shape=(T * 1024,),
                  dtype_bytes=4))
    g.add(_mm("fc2", T, 1024, 10, dtb))
    g.add(_elt("readout", "add", T * 10, dtb))
    return g.graph()


def lavish(dtb: int = 2) -> OpGraph:
    """Audio-visual transformer (dual 224^2 + 128^2 towers -> fusion).
    The dual encoder is the fork the parallel scheduler exploits
    (Table 3: +9%)."""
    g = _G()
    root = g.add(_elt("input", "add", 3 * 224 * 224, dtb))
    # visual tower
    v = g.add(_conv("v.patch", 3, 768, 224, 16, dtb, stride=16), after=root)
    for i in range(2):
        g.add(_mm(f"v.L{i}.qkv", 196, 768, 3 * 768, dtb))
        g.add(FusedOp(name=f"v.L{i}.attn", kind="attention",
                      in_shapes=((1, 12, 196, 64), (1, 12, 196, 64)),
                      out_shape=(1, 12, 196, 64), dtype_bytes=dtb))
        g.add(_mm(f"v.L{i}.mlp", 196, 768, 3072, dtb))
    v_end = g.tail
    # audio tower (smaller)
    a = g.add(_conv("a.patch", 1, 768, 128, 16, dtb, stride=16), after=root)
    for i in range(2):
        g.add(_mm(f"a.L{i}.qkv", 64, 768, 3 * 768, dtb))
        g.add(_mm(f"a.L{i}.mlp", 64, 768, 3072, dtb))
    a_end = g.tail
    g.add(_mm("fusion", 260, 768, 768, dtb), after=[v_end, a_end])
    g.add(_mm("head", 1, 768, 309, dtb))
    return g.graph()


def pi05() -> OpGraph:
    """pi0.5 VLA pipeline: text embedder || INT8 vision encoder ->
    prefix-cache decoder -> 10 iterative denoising steps (~4,600 fused
    ops, single mixed-precision configuration).  The prefix/denoise
    stages exceed GPU memory -> unsupported_on GPU (paper Table 2 N/A)."""
    g = _G()
    root = g.add(_elt("inputs", "add", 1024, 2))
    no_gpu = ("GPU",)
    # text embedder (small CPU-ish ops)
    t = root
    for i in range(120):
        t = g.add(_mm(f"txt.{i}.mm", 64, 512, 512, 2), after=t)
        t = g.add(_elt(f"txt.{i}.act", "act", 64 * 512, 2), after=t)
    txt_end = t
    # vision encoder (INT8 conv/mm tower), parallel with text
    v = root
    for i in range(27):
        v = g.add(_conv(f"vis.{i}.conv", 64 if i else 3, 64, 56, 3, 1),
                  after=v)
        v = g.add(_elt(f"vis.{i}.act", "act", 64 * 56 * 56, 1), after=v)
        v = g.add(_mm(f"vis.{i}.mm", 196, 768, 768, 1), after=v)
    vis_end = v
    # prefix-cache decoder (GEMM-heavy, no GPU)
    p = g.add(_mm("prefix.in", 256, 2048, 2048, 2, unsupported=no_gpu),
              after=[txt_end, vis_end])
    for i in range(400):
        p = g.add(_mm(f"pre.{i}.mm", 256, 2048, 2048, 2,
                      unsupported=no_gpu), after=p)
        p = g.add(_elt(f"pre.{i}.act", "act", 256 * 2048, 2,
                       unsupported=no_gpu), after=p)
    # 10 denoising iterations, each with two parallel branches
    for it in range(10):
        fork = p
        b1 = fork
        for i in range(80):
            b1 = g.add(_mm(f"dn{it}.a{i}", 128, 1024, 1024, 2,
                           unsupported=no_gpu), after=b1)
            b1 = g.add(_elt(f"dn{it}.a{i}.act", "act", 128 * 1024, 2,
                            unsupported=no_gpu), after=b1)
        b2 = fork
        for i in range(80):
            b2 = g.add(_mm(f"dn{it}.b{i}", 128, 1024, 1024, 2,
                           unsupported=no_gpu), after=b2)
            b2 = g.add(_elt(f"dn{it}.b{i}.act", "act", 128 * 1024, 2,
                            unsupported=no_gpu), after=b2)
        p = g.add(_elt(f"dn{it}.join", "add", 128 * 1024, 2,
                       unsupported=no_gpu), after=[b1, b2])
    g.add(_mm("action_head", 1, 1024, 32, 2), after=p)
    return g.graph()


def vla_pipeline(dtb: int = 2, depth: int = 5) -> OpGraph:
    """Compact multi-stage VLA pipeline: vision encoder || language
    encoder -> fusion -> action head, as an explicit op DAG.

    The paper's intra-model-parallelism scenario at DAG-solver scale
    (``pi05`` is the same pipeline at full ~4,600-op profile scale; this
    builder keeps it under the frontier DP's 63-node bitmask so the
    antichain-frontier route can co-schedule the towers step by step).
    The towers are deliberately affinity-split — a conv tower (NPU-fast)
    against a GEMM/attention tower (GPU-fast) — so co-executing them on
    different PUs beats any serialized single-sequence route: paired
    advances cost ``max(w_v, w_l) * SF`` with the cross-PU SF factors
    well under 2x.
    """
    g = _G()
    root = g.add(_elt("inputs", "add", 3 * 224 * 224, dtb))
    # vision encoder: conv tower (NPU-affine)
    v = g.add(_conv("vis.patch", 3, 64, 224, 8, dtb, stride=4), after=root)
    for i in range(depth):
        v = g.add(_conv(f"vis.{i}.conv", 64, 64, 56, 3, dtb), after=v)
        v = g.add(_elt(f"vis.{i}.act", "act", 64 * 56 * 56, dtb), after=v)
    v_end = g.add(_mm("vis.proj", 196, 768, 768, dtb), after=v)
    # language encoder: GEMM/attention tower (GPU-affine), parallel
    t = g.add(_mm("lang.embed", 128, 768, 768, dtb), after=root)
    for i in range(depth):
        t = g.add(_mm(f"lang.{i}.qkv", 128, 768, 3 * 768, dtb), after=t)
        t = g.add(FusedOp(name=f"lang.{i}.attn", kind="attention",
                          in_shapes=((1, 12, 128, 64), (1, 12, 128, 64)),
                          out_shape=(1, 12, 128, 64), dtype_bytes=dtb),
                  after=t)
    t_end = g.add(_mm("lang.proj", 128, 768, 768, dtb), after=t)
    # fusion + action head (sequential epilogue)
    f = g.add(_mm("fusion", 324, 768, 768, dtb), after=[v_end, t_end])
    g.add(_mm("action.fc", 1, 768, 256, dtb), after=f)
    g.add(_mm("action_head", 1, 256, 32, dtb))
    return g.graph()


# ---------------------------------------------------------------------------
# registry: the paper's 19 model-precision configurations
# ---------------------------------------------------------------------------

def zoo() -> dict[str, OpGraph]:
    """All 19 configurations of Table 1/2 (9 models x FP16+INT8, + pi05)."""
    out: dict[str, OpGraph] = {}
    builders = {
        "ResNet-50": resnet50, "ViT-B/16": vit_b16, "LLaMA-7B(1L)": llama_1l,
        "BitNet": bitnet, "Mamba-370M": mamba_370m, "Hyena": hyena,
        "KAN": kan, "SNN-VGG9": snn_vgg9, "LAVISH": lavish,
    }
    for name, fn in builders.items():
        out[f"{name} FP16"] = fn(2)
        out[f"{name} INT8"] = fn(1)
    out["pi0.5"] = pi05()
    return out


ZOO_NAMES: Sequence[str] = tuple(
    [f"{m} {p}" for m in ("ResNet-50", "ViT-B/16", "LLaMA-7B(1L)", "BitNet",
                          "Mamba-370M", "Hyena", "KAN", "SNN-VGG9", "LAVISH")
     for p in ("FP16", "INT8")] + ["pi0.5"])
