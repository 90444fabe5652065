"""Why the port's tensor-core kernels may use 3xTF32 and not TF32.

``expert_glu`` and ``flash_attention`` (``src/repro_torch/csrc``) run
their f32 products on the tensor cores as TF32 tiles (``mma.sync``, and
``wgmma`` where TMA reads the operands).  TF32
keeps 10 explicit mantissa bits, so one TF32 product per f32 product
misses the f32 bucket of 3e-5 (``chip_smoke.py`` ``F32_TOL``, normalised
by the largest output).  The 3xTF32 split a = hi + lo, hi = tf32(a),
lo = tf32(a - hi), a.b ~ lo.b_hi + hi.b_lo + hi.b_hi keeps it.  This file
emulates both in torch on the CPU, at the main path's reduction depths
and scales (``GRANITE_MAIN_PATH``: the up projection over d = 1024, the
down projection over F = 512, attention over D = 64 and a 64-wide kv
tile), and holds each to the bucket.

The tensor cores' f32 accumulator may truncate (round toward zero) at
every ``mma``; a long chain of truncations drifts.  The next test
emulates that accumulator and the kernels' remedy: each stretch of K (32
deep in the ``mma.sync`` expert GLU, one 64-wide kv tile in attention) is
summed in a fresh accumulator and added to the running f32 sum, rounding
to nearest.

The f32 expert GLU on 16-byte rows runs on TF32 ``wgmma``, which takes
its shared-memory operand K-major only, so it computes the transpose
C^T = W^T B^T (``csrc/expert_glu.cu``): the weights are A, split into hi
and lo in registers as above, and x (or the activation) is B, read from
the raw f32 tile as its hi term and from a second tile holding
x - hi as its lo term.  The last four tests emulate that
design and decide its split: B's lo term must be taken against what the
tensor cores read of the raw bits (they truncate, as the card showed),
all three products are needed, and the accumulator is folded every
``FOLD`` stages of ``BK``, as read from the kernel's source.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

F32_TOL = 3e-5          # chip_smoke.py F32_TOL, the f32 bucket
MMA_K = 8               # depth of one m16n8k8 TF32 tile


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (nearest, ties away from zero), as the card's
    ``cvt.rna.tf32.f32``: the low 13 mantissa bits are rounded away."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def rz32(x: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounding toward zero."""
    r = x.float()
    over = r.double().abs() > x.abs()
    r[over] = torch.nextafter(r[over], torch.zeros_like(r[over]))
    return r


def one_tf32(a, b):
    return tf32(a).double() @ tf32(b).double()


def three_tf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return (al.double() @ bh.double() + ah.double() @ bl.double()
            + ah.double() @ bh.double())


def three_tf32_truncating(a, b, fold: int):
    """3xTF32 with the tensor cores' accumulator emulated: every 8-deep
    ``mma`` rounds toward zero into a partial sum that starts at zero
    every ``fold`` of K, and each partial is added to the running f32 sum
    rounding to nearest (``fold`` = K: one chain, no fold)."""
    (ah, al), (bh, bl) = split(a), split(b)
    total = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for f0 in range(0, a.shape[1], fold):
        part = torch.zeros_like(total)
        for k0 in range(f0, f0 + fold, MMA_K):
            ks = slice(k0, k0 + MMA_K)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                part = rz32(part.double() + x[:, ks].double()
                            @ y[ks].double())
        total = total + part
    return total.double()


def _operands(case: str):
    """(A, B) at one of the main path's products, from a seeded rng."""
    rng = np.random.default_rng({"up": 0, "down": 1, "qk": 2, "pv": 3}[case])

    def n(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).float()
    if case == "up":            # x (N(0,1)) . w_up (0.5 N(0,1)), K = d
        return n(64, 1024), n(1024, 128, scale=0.5)
    if case == "down":          # silu(g) * u . w_down, K = F
        h = (n(64, 1024).double() @ n(1024, 1024, scale=0.5).double())
        act = (torch.nn.functional.silu(h[:, :512]) * h[:, 512:]).float()
        return act, n(512, 128, scale=0.5)
    if case == "qk":            # (q / sqrt(D)) . k^T, K = D
        return n(64, 64) * 0.125, n(64, 64)
    s = n(64, 64) @ n(64, 64) * 0.125       # p . v over one kv tile
    p = torch.exp(s - s.amax(dim=1, keepdim=True))
    return p, n(64, 64)


def _err(got, a, b) -> float:
    want = a.double() @ b.double()
    return float((got - want).abs().max() / want.abs().max())


CASES = ["up", "down", "qk", "pv"]


@pytest.mark.parametrize("case", CASES)
def test_one_tf32_product_misses_the_f32_bucket(case):
    a, b = _operands(case)
    assert _err(one_tf32(a, b), a, b) > F32_TOL


@pytest.mark.parametrize("case", CASES)
def test_3xtf32_split_holds_the_f32_bucket(case):
    a, b = _operands(case)
    err = _err(three_tf32(a, b), a, b)
    assert err <= F32_TOL / 30, err      # ~1e-7: f32's own order
    f32 = _err((a @ b).double(), a, b)
    assert err <= 4 * f32 + 1e-7, (err, f32)


@pytest.mark.parametrize("case,fold", [("up", 32), ("down", 32),
                                       ("qk", 64), ("pv", 64)])
def test_3xtf32_with_a_truncating_accumulator_holds_the_bucket(case, fold):
    a, b = _operands(case)
    folded = _err(three_tf32_truncating(a, b, fold), a, b)
    assert folded <= F32_TOL / 10, folded
    if a.shape[1] > fold:       # one chain over all of K drifts further
        chained = _err(three_tf32_truncating(a, b, a.shape[1]), a, b)
        assert chained > folded, (chained, folded)


# ---- the transposed design of the f32 wgmma expert GLU ----------------------

_GLU_SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
            "csrc" / "expert_glu.cu").read_text().split("namespace tc {")[1]
BK = int(re.search(r"constexpr int BK = (\d+);", _GLU_SRC).group(1))
FOLD = int(re.search(r"constexpr int FOLD = (\d+);", _GLU_SRC).group(1))


def trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of f32 bits: the top 19 (sign, exponent,
    10 mantissa bits), the other 13 cut off."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)


def transposed(a, b, fold: int, hw=trunc, lo_against=None,
               products=("lo.hi", "hi.lo", "hi.hi")):
    """a (M, K) @ b (K, N) as the kernel computes it, transposed: A = b^T
    split in registers (hi = tf32(b), lo = b - hi, read through ``hw``),
    B = a from its raw tile (read through ``hw``, the tensor cores' view
    of raw bits) and its lo tile a - lo_against(a) (default: ``hw``, the
    matching split); products named weight.x in issue order per k8 step,
    into a truncating accumulator folded every ``fold`` of K."""
    lo_against = lo_against or hw
    wh = tf32(b.t())
    terms = {"w": (wh, hw(b.t() - wh)),
             "x": (hw(a), hw(a - lo_against(a)))}
    pick = {"hi": 0, "lo": 1}
    total = torch.zeros(b.shape[1], a.shape[0], dtype=torch.float32)
    for f0 in range(0, a.shape[1], fold):
        part = torch.zeros_like(total)
        for k0 in range(f0, min(f0 + fold, a.shape[1]), MMA_K):
            ks = slice(k0, k0 + MMA_K)
            for name in products:
                w_, x_ = name.split(".")
                wk = terms["w"][pick[w_]][:, ks].double()
                xk = terms["x"][pick[x_]][:, ks].double()
                part = rz32(part.double() + wk @ xk.t())
        total = total + part
    return total.t().double()


@pytest.mark.parametrize("fold", [BK, FOLD * BK])
@pytest.mark.parametrize("hw", ["trunc", "rna"])
@pytest.mark.parametrize("case", ["up", "down"])
def test_transposed_3xtf32_holds_the_bucket(case, hw, fold):
    """With B's lo term split against what the tensor cores read of the
    raw tile (truncated, as on the card; rounded, had they rounded), the
    transposed design holds the f32 bucket tenfold, folded every stage or
    every FOLD stages."""
    a, b = _operands(case)
    got = transposed(a, b, fold, hw={"trunc": trunc, "rna": tf32}[hw])
    assert _err(got, a, b) <= F32_TOL / 10


@pytest.mark.parametrize("case", ["up", "down"])
def test_transposed_split_must_match_what_the_hardware_reads(case):
    """A lo term taken against the other reading of the raw bits counts
    the cut-off bits twice or not at all: far outside the bucket.  So the
    kernel splits against truncation, which the card showed."""
    a, b = _operands(case)
    fold = FOLD * BK
    assert _err(transposed(a, b, fold, hw=tf32, lo_against=trunc), a,
                b) > F32_TOL
    assert _err(transposed(a, b, fold, hw=trunc, lo_against=tf32), a,
                b) > F32_TOL


@pytest.mark.parametrize("dropped", ["lo.hi", "hi.lo"])
@pytest.mark.parametrize("case", ["up", "down"])
def test_transposed_3xtf32_needs_every_product(case, dropped):
    """Without either cross product the error is that of one TF32 side:
    far outside the bucket (the kernel_variants.py ``no_lohi`` ablation)."""
    a, b = _operands(case)
    kept = tuple(p for p in ("lo.hi", "hi.lo", "hi.hi") if p != dropped)
    assert _err(transposed(a, b, FOLD * BK, products=kept), a, b) > F32_TOL


@pytest.mark.parametrize("case", ["up", "down"])
def test_transposed_fold_depth(case):
    """The kernel's fold (FOLD stages of BK) keeps the truncating
    accumulator's drift a tenth of the bucket; one chain over all of K
    drifts several times further (on the card 1.75e-5 of the largest
    output over both projections, ``no_fold``)."""
    a, b = _operands(case)
    folded = _err(transposed(a, b, FOLD * BK), a, b)
    chained = _err(transposed(a, b, a.shape[1]), a, b)
    assert folded <= F32_TOL / 10, folded
    assert chained > 3 * folded, (chained, folded)


# ---- the f32 wgmma attention's two chains -----------------------------------
#
# ``tf::attn_tf32_kernel`` (csrc/flash_attention.cu) runs S = Q K^T and
# P V on TF32 wgmma in 3xTF32, with raw tiles as their own hi terms (read
# truncated) beside lo tiles x - trunc(x): Q scaled by 1/sqrt(D) and its
# lo tile, K and its lo tile, V^T's raw bits and its lo tile, each 8 kv
# positions of V^T in the order 0, 2, 4, 6, 1, 3, 5, 7 so that P's
# registers are the A fragment as S's accumulator left them; P split in
# registers into hi (rounded) and lo.  Two streams of kv tiles (even,
# odd), each with its own online softmax in base 2, merged at the end.
# The emulation weighs P V accumulated into O scaled by alpha against a
# fresh accumulator a tile folded as O alpha + pv (the kernel's choice), at
# the main path's width (D 64), Qwen3-8B's (D 128) and StableLM-12B's (D
# 160, whose kv tiles of 16 rows are what fits in shared memory): both
# hold the bucket, but summed straight into O the truncations of the
# whole kv walk shrink the outputs several times as far.

_ATTN_SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
             "csrc" / "flash_attention.cu").read_text().split(
                 "namespace tf {")[1]
_KV = re.search(r"constexpr int kv_tile\(int D\) \{ return D == 160 \? "
                r"(\d+) : D == 128 \? (\d+) : (\d+); \}", _ATTN_SRC)
ATTN_KV_TILE = {160: int(_KV.group(1)), 128: int(_KV.group(2)),
                64: int(_KV.group(3))}
PERM = (0, 2, 4, 6, 1, 3, 5, 7)     # position c of 8 holds kv PERM[c]
LOG2E = float(np.log2(np.e))
THREE = ("lo.hi", "hi.lo", "hi.hi")


def _chain(part, x, y, products):
    """part += x @ y over k8 steps, each named product (x term . y term)
    into the truncating accumulator."""
    for k0 in range(0, x[0].shape[1], MMA_K):
        ks = slice(k0, k0 + MMA_K)
        for name in products:
            a_, b_ = name.split(".")
            xa = x[a_ == "lo"][:, ks].double()
            yb = y[b_ == "lo"][ks].double()
            part = rz32(part.double() + xa @ yb)
    return part


def wgmma_attention(q, k, v, bk, o_mode="scaled", s_products=THREE,
                    pv_products=THREE, streams=2):
    """One causal head (T, D) as the kernel computes it (see above)."""
    T, D = q.shape
    qs = q * torch.tensor(1.0 / np.sqrt(D), dtype=torch.float32)
    Q = (trunc(qs), trunc(qs - trunc(qs)))
    kt = k.t().contiguous()
    K = (trunc(kt), trunc(kt - trunc(kt)))
    perm = torch.tensor([8 * (i // 8) + PERM[i % 8] for i in range(T)])
    vp = v[perm]                     # V^T's rows of k, in the kernel's order
    V = (trunc(vp), trunc(vp - trunc(vp)))
    st = [[torch.full((T, 1), -1e30), torch.zeros(T, 1), torch.zeros(T, D)]
          for _ in range(streams)]
    rows = torch.arange(T)[:, None]
    for j in range(-(-T // bk)):
        m, l, o = st[j % streams]
        cols = slice(j * bk, min((j + 1) * bk, T))
        s = _chain(torch.zeros(T, cols.stop - cols.start), Q,
                   (K[0][:, cols], K[1][:, cols]), s_products).float()
        s = s.masked_fill(rows < torch.arange(cols.start, cols.stop)[None],
                          -1e30) * LOG2E
        m_new = torch.maximum(m, s.amax(1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)[:, perm[cols] - cols.start]
        l = l * alpha + p.sum(1, keepdim=True)
        P = (tf32(p), trunc(p - tf32(p)))
        Vt = (V[0][cols], V[1][cols])
        if o_mode == "scaled":
            o = _chain(o * alpha, P, Vt, pv_products).float()
        else:
            o = o * alpha + _chain(torch.zeros(T, D), P, Vt,
                                   pv_products).float()
        st[j % streams] = [m_new, l, o]
    mm = st[0][0]
    for m_i, _, _ in st[1:]:
        mm = torch.maximum(mm, m_i)
    a = [torch.exp2(m_i - mm) for m_i, _, _ in st]
    l = sum(l_i * a_i for (_, l_i, _), a_i in zip(st, a))
    o = sum(o_i * a_i for (_, _, o_i), a_i in zip(st, a))
    return (o / l.clamp_min(1e-30)).double()


def _attn_operands(D: int, T: int = 256):
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal((T, D))).float()
               for _ in range(3))
    s = (q.double() @ k.double().t() / np.sqrt(D)).masked_fill(
        torch.ones(T, T, dtype=torch.bool).triu(1), -np.inf)
    return (q, k, v), torch.softmax(s, -1) @ v.double()


def _shrink(got, want) -> float:
    """The mean of (got - want) / want over the larger outputs of the
    second half of the rows (the longest kv walks): a truncating
    accumulator's pull toward zero."""
    half = slice(want.shape[0] // 2, None)
    big = want[half].abs() > 0.05
    return float(((got[half] - want[half]) / want[half])[big].mean())


@pytest.mark.parametrize("o_mode", ["scaled", "fresh"])
@pytest.mark.parametrize("D", [64, 128, 160])
def test_wgmma_attention_holds_the_bucket(D, o_mode):
    """Both ways of accumulating P V hold the f32 bucket tenfold at the
    kernel's kv tiles (~1e-6 of the largest output)."""
    (q, k, v), want = _attn_operands(D)
    got = wgmma_attention(q, k, v, ATTN_KV_TILE[D], o_mode=o_mode)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= F32_TOL / 10, err


@pytest.mark.parametrize("D", [64, 128, 160])
def test_wgmma_attention_fresh_accumulator_halves_the_shrink(D):
    """Over a kv walk of 1024 the truncations summed straight into O pull
    the outputs toward zero by ~4e-6 of themselves; a fresh accumulator a
    tile, folded with an f32 add, by less than half that.  The main
    path's chain on the card held its oracle only with the fresh one, so
    the kernel takes it."""
    (q, k, v), want = _attn_operands(D, 1024)
    scaled = _shrink(wgmma_attention(q, k, v, ATTN_KV_TILE[D]), want)
    fresh = _shrink(wgmma_attention(q, k, v, ATTN_KV_TILE[D],
                                    o_mode="fresh"), want)
    assert scaled < 0 and fresh < 0, (scaled, fresh)
    assert abs(fresh) < abs(scaled) / 2, (scaled, fresh)


@pytest.mark.parametrize("dropped", ["lo.hi", "hi.lo"])
@pytest.mark.parametrize("chain", ["s", "pv"])
@pytest.mark.parametrize("D", [64, 128, 160])
def test_wgmma_attention_needs_every_product(D, chain, dropped):
    """Without either cross product of either chain the error is that of
    one TF32 side: outside the f32 bucket."""
    (q, k, v), want = _attn_operands(D)
    kept = tuple(p for p in THREE if p != dropped)
    got = wgmma_attention(q, k, v, ATTN_KV_TILE[D],
                          **{f"{chain}_products": kept})
    assert float((got - want).abs().max() / want.abs().max()) > F32_TOL


def test_wgmma_attention_fragment_relabelling():
    """P's registers as S's accumulator leaves them (thread (g, t) of a
    warp: (g, kv 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of an
    8-column slice), passed in the kernel's order sc[0], sc[2], sc[1],
    sc[3] as the TF32 A fragment ((g, t), (g + 8, t), (g, t + 4), (g + 8,
    t + 4)), against V^T with 8 kv positions in the order 0, 2, 4, 6, 1,
    3, 5, 7 as B, give P V exactly."""
    rng = np.random.default_rng(0)
    P = torch.from_numpy(rng.integers(-8, 8, (16, 8))).double()
    V = torch.from_numpy(rng.integers(-8, 8, (8, 8))).double()
    A = torch.zeros(16, 8, dtype=torch.float64)
    for g in range(8):
        for t in range(4):
            sc = [P[g, 2 * t], P[g, 2 * t + 1], P[g + 8, 2 * t],
                  P[g + 8, 2 * t + 1]]
            a = [sc[0], sc[2], sc[1], sc[3]]
            A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a
    Bt = V[list(PERM)].t()           # V^T: row n, position c holds kv PERM[c]
    assert torch.equal(A @ Bt.t(), P @ V)



# ---- the f32 wgmma SSD scan's four chains -----------------------------------
#
# ``tf::state_tf32_kernel`` and ``tf::out_tf32_kernel`` (csrc/ssd_scan.cu)
# run the scan's four products on TF32 wgmma in 3xTF32: the chunk states
# S^T = v^T (w o b) over a chunk's rows, the score c b^T over N, G v over
# a kv tile's rows, and the inter term c S_in over N.  Every operand is
# taken as its TF32 hi term rounded to nearest (split_tf32; a tile is
# rounded in place, or written rounded where the consumers transpose it)
# beside a lo term x - hi that the tensor cores read truncated: so each
# product's terms are those of the mma.sync kernels, whose fresh
# accumulators (every 32 of K) the design keeps in every chain.  The
# emulation below holds that design to the f32 bucket against the chunked
# algebra in f64 at the main path's N = P = 64, chunk 64 to 256 and T 256
# to 1024, its shrink to the mma.sync kernels' at T 1024 (the state is carried through
# 16 chunks on the main path), and shows what the choices avoid: raw
# tiles as their own hi terms (the f32 expert GLU's and attention's way) and one chain over N
# each pull the outputs toward zero further, and without either cross
# product of any chain the bucket is missed.  The wide design above N =
# 64 (``tf::out_wide_tf32_kernel``, xLSTM-125M's mLSTM at N 384, P 385)
# keeps the same fresh accumulators (two chains of 32 of N an item, a kv
# pair's G v as its two tiles' chains), so the same emulation holds it at
# the mLSTM's widths, chunk 256 over T 300.

_SCAN_SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
             "csrc" / "ssd_scan.cu").read_text()
_SCAN_TF = _SCAN_SRC.split("namespace tf {")[1]


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# the design's fresh accumulators (rows or N of K), read from its source,
# and the mma.sync kernels' (FOLD_K8 k8 steps in every chain)
SCAN_FOLDS = {"state": _const(_SCAN_TF, "ST_FOLD"),
              "score": _const(_SCAN_TF, "N_FOLD"),
              "inter": _const(_SCAN_TF, "N_FOLD"),
              "gv": _const(_SCAN_TF, "KVT")}
MMA_SYNC_FOLDS = dict.fromkeys(SCAN_FOLDS,
                           MMA_K * _const(_SCAN_SRC, "FOLD_K8"))
CHAINS = tuple(SCAN_FOLDS)


def rounded(x):
    """The design's terms of x: hi rounded to TF32, lo = x - hi as the
    tensor cores read it (truncated)."""
    h = tf32(x)
    return h, trunc(x - h)


def raw(x):
    """A raw tile as its own hi term (read truncated), lo = x - trunc(x)."""
    return trunc(x), trunc(x - trunc(x))


def _folded(x, y, fold, products):
    """x (M, K) @ y (K, N), both as (hi, lo), into a truncating
    accumulator that starts afresh every ``fold`` of K; the partials added
    in f32."""
    out = torch.zeros(x[0].shape[0], y[0].shape[1])
    for f0 in range(0, x[0].shape[1], fold):
        sl = slice(f0, f0 + fold)
        out = out + _chain(torch.zeros_like(out), (x[0][:, sl], x[1][:, sl]),
                           (y[0][sl], y[1][sl]), products).float()
    return out


def wgmma_scan(c, b, v, la, C, folds=None, tiles=rounded, drop=None):
    """One (batch, head) of the scan as the kernels compute it: c, b (T,
    N), v (T, P), log_a (T,) in f32; returns y (T, P) and the final state
    (N, P) in f64.  ``tiles``: the terms of the shared-memory operands
    (the register operand G is always ``rounded``); ``drop``: (chain, a
    cross product) left out."""
    folds = folds or SCAN_FOLDS
    T, N = c.shape
    P = v.shape[1]
    nc = -(-T // C)
    pad = nc * C - T
    c, b, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (c, b, v))
    la = torch.nn.functional.pad(la, (0, pad))
    prods = {k: tuple(p for p in THREE if (k, p) != drop) for k in CHAINS}
    S = torch.zeros(N, P)
    y = torch.zeros(nc * C, P)
    low = torch.ones(C, C, dtype=torch.bool).tril()
    for ci in range(nc):
        r = slice(ci * C, (ci + 1) * C)
        cc, bb, vv = c[r], b[r], v[r]
        cum = torch.cumsum(la[r], 0)
        tot = cum[-1]
        w = torch.exp(tot - cum)
        # chunk state S^T = v^T (w o b), carried as a product then a sum
        st = _folded(tiles(vv.t().contiguous()), tiles(bb * w[:, None]),
                     folds["state"], prods["state"]).t()
        s_in = S
        S = S * torch.exp(tot) + st
        # inter: exp(cum_i) (c S_in), then + G v a kv tile at a time
        e = torch.exp(cum)[:, None]
        acc = torch.zeros(C, P)
        for f0 in range(0, N, folds["inter"]):
            sl = slice(f0, f0 + folds["inter"])
            ct, stt = tiles(cc), tiles(s_in)
            acc = acc + e * _chain(torch.zeros(C, P), (ct[0][:, sl], ct[1][:, sl]),
                                   (stt[0][sl], stt[1][sl]),
                                   prods["inter"]).float()
        score = _folded(tiles(cc), tiles(bb.t().contiguous()), folds["score"],
                        prods["score"])
        d = torch.where(low, cum[:, None] - cum[None, :], torch.zeros(C, C))
        G = torch.where(low, score * torch.exp(d), torch.zeros(C, C))
        for j0 in range(0, C, folds["gv"]):
            sl = slice(j0, j0 + folds["gv"])
            acc = acc + _chain(torch.zeros(C, P), rounded(G[:, sl].contiguous()),
                               tiles(vv[sl]), prods["gv"]).float()
        y[r] = acc
    return y[:T].double(), S.double()


def ssd_f64(c, b, v, la, C):
    """The chunked algebra in f64: y (T, P) and the final state."""
    T, N = c.shape
    nc = -(-T // C)
    pad = nc * C - T
    c, b, v = (torch.nn.functional.pad(x.double(), (0, 0, 0, pad))
               for x in (c, b, v))
    la = torch.nn.functional.pad(la.double(), (0, pad))
    S = torch.zeros(N, v.shape[1], dtype=torch.float64)
    y = torch.zeros(nc * C, v.shape[1], dtype=torch.float64)
    low = torch.ones(C, C, dtype=torch.bool).tril()
    for ci in range(nc):
        r = slice(ci * C, (ci + 1) * C)
        cum = torch.cumsum(la[r], 0)
        d = torch.where(low, cum[:, None] - cum[None, :],
                        torch.zeros(C, C, dtype=torch.float64))
        L = torch.where(low, torch.exp(d), torch.zeros_like(d))
        y[r] = ((c[r] @ b[r].t()) * L) @ v[r] \
            + (c[r] * torch.exp(cum)[:, None]) @ S
        S = S * torch.exp(cum[-1]) \
            + (b[r] * torch.exp(cum[-1] - cum)[:, None]).t() @ v[r]
    return y[:T], S


# (N, P, scale of c and b): the main path's state (N = P = 64, as
# chip_smoke.py draws it) and xLSTM-125M's mLSTM (N 384, P 385 with v's
# column of ones; c and b at the 1/sqrt(N)-like scale of
# tests/test_torch_kernels.py's mLSTM case)
MAIN, MLSTM = (64, 64, 0.5), (384, 385, 0.1)


def _scan_operands(T: int, shape=MAIN):
    """c, b (scale N(0, 1)), v (N(0, 1); its last column ones where P = N
    + 1), log_a = -softplus(N(0, 1)) at ``shape``."""
    N, P, scale = shape
    rng = np.random.default_rng(T if shape == MAIN else (T, N, P))

    def n(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).float()
    c, b, v = n(T, N, scale=scale), n(T, N, scale=scale), n(T, P)
    if P == N + 1:
        v[:, -1] = 1.0
    return c, b, v, -torch.nn.functional.softplus(n(T))


_SCAN_RUNS: dict = {}


def _scan_run(C, T, shape=MAIN, **kw):
    """(y, state, f64 y, f64 state) of one emulated run, memoised."""
    key = (C, T, shape, tuple(sorted((k, str(v)) for k, v in kw.items())))
    if key not in _SCAN_RUNS:
        ops = _scan_operands(T, shape)
        _SCAN_RUNS[key] = wgmma_scan(*ops, C, **kw) + ssd_f64(*ops, C)
    return _SCAN_RUNS[key]


def _scan_err(run) -> float:
    y, s, wy, ws = run
    return max(float((y - wy).abs().max() / wy.abs().max()),
               float((s - ws).abs().max() / ws.abs().max()))


@pytest.mark.parametrize("C,T,shape", [
    pytest.param(64, 256, MAIN, id="64-256"),
    pytest.param(64, 1024, MAIN, id="64-1024"),
    pytest.param(128, 512, MAIN, id="128-512"),
    pytest.param(256, 256, MAIN, id="256-256"),
    pytest.param(256, 1024, MAIN, id="256-1024"),
    pytest.param(256, 300, MLSTM, id="mlstm-256-300")])
def test_wgmma_scan_holds_the_bucket(C, T, shape):
    """The design's folds hold y and the final state within 3e-5 of the
    largest value of the chunked algebra in f64 (~1e-6 at chunk 64, ~8e-6
    at chunk 256, f32's own order there; ~4e-6 at the mLSTM's widths)."""
    assert _scan_err(_scan_run(C, T, shape)) <= F32_TOL


@pytest.mark.parametrize("C,T,shape", [
    pytest.param(64, 1024, MAIN, id="64"),
    pytest.param(256, 1024, MAIN, id="256"),
    pytest.param(256, 300, MLSTM, id="mlstm")])
def test_wgmma_scan_shrink_at_most_the_mma_sync_kernels(C, T, shape):
    """At T 1024 (T 300 at the mLSTM's widths) the truncating accumulators
    pull the outputs toward zero by no more than the mma.sync kernels do
    (~2.6e-7 of themselves)."""
    want = _scan_run(C, T, shape)[2]
    design = _shrink(_scan_run(C, T, shape)[0], want)
    mma_sync = _shrink(_scan_run(C, T, shape, folds=MMA_SYNC_FOLDS)[0], want)
    assert design < 0 and abs(design) <= abs(mma_sync), (design, mma_sync)


@pytest.mark.parametrize("C,T,shape,alternative", [
    pytest.param(C, T, shape, alt, id=f"{label}-{alt}")
    for label, C, T, shape in ((64, 64, 1024, MAIN), (256, 256, 1024, MAIN),
                               ("mlstm", 256, 300, MLSTM))
    for alt in ("raw tiles", "one chain over N")])
def test_wgmma_scan_alternatives_shrink_further(C, T, shape, alternative):
    """Raw tiles as their own hi terms (their lo terms' truncation always
    pulls toward zero) and one chain over N in c b^T and c S_in each hold
    the bucket but pull the outputs toward zero at least half as far
    again as the design does; the main path's route oracle is sensitive
    to that drift (the f32 attention showed it), so the design rounds and folds."""
    want = _scan_run(C, T, shape)[2]
    kw = {"tiles": raw} if alternative == "raw tiles" else \
        {"folds": dict(SCAN_FOLDS, score=shape[0], inter=shape[0])}
    run = _scan_run(C, T, shape, **kw)
    design = _shrink(_scan_run(C, T, shape)[0], want)
    assert _scan_err(run) <= F32_TOL
    assert _shrink(run[0], want) < 1.5 * design, (_shrink(run[0], want),
                                                  design)


@pytest.mark.parametrize("chain,dropped,C,T,shape", [
    pytest.param(chain, dropped, C, T, shape, id=label + f"{chain}-{dropped}")
    for label, C, T, shape in (("", 64, 256, MAIN),
                               ("mlstm-", 256, 300, MLSTM))
    for chain in CHAINS for dropped in ("lo.hi", "hi.lo")])
def test_wgmma_scan_needs_every_product(chain, dropped, C, T, shape):
    """Without either cross product of any of the four chains, y or the
    final state misses the f32 bucket (at the mLSTM's widths too)."""
    assert _scan_err(_scan_run(C, T, shape, drop=(chain, dropped))) > F32_TOL


def test_wgmma_scan_permuted_kv_order_gives_g_v():
    """G's registers as the score's accumulator leaves them, passed as the
    TF32 A fragment in the kernel's order (sc[4 jn], sc[4 jn + 2], sc[4 jn
    + 1], sc[4 jn + 3]), against v^T written by ``transpose8`` with each 8
    kv positions in the order 0, 2, 4, 6, 1, 3, 5, 7, give G v exactly,
    over a kv tile of 32 rows and 64 columns of P."""
    rng = np.random.default_rng(1)
    kv = SCAN_FOLDS["gv"]
    G = torch.from_numpy(rng.integers(-8, 8, (64, kv))).double()
    V = torch.from_numpy(rng.integers(-8, 8, (kv, 64))).double()
    # v^T as transpose8 writes it: row p, position 8 k + c holds kv 8 k +
    # PERM[c]
    vt = torch.zeros(64, kv, dtype=torch.float64)
    for p in range(64):
        for r0 in range(0, kv, 8):
            x = [V[r0 + r, p] for r in range(8)]
            vt[p, r0:r0 + 8] = torch.stack([x[0], x[2], x[4], x[6],
                                            x[1], x[3], x[5], x[7]])
    A = torch.zeros(64, kv, dtype=torch.float64)
    for warp in range(4):
        for g in range(8):
            for t in range(4):
                r = 16 * warp + g
                for jn in range(kv // 8):
                    sc = [G[r, 8 * jn + 2 * t], G[r, 8 * jn + 2 * t + 1],
                          G[r + 8, 8 * jn + 2 * t],
                          G[r + 8, 8 * jn + 2 * t + 1]]
                    a = [sc[0], sc[2], sc[1], sc[3]]
                    k = 8 * jn
                    A[r, k + t], A[r + 8, k + t] = a[0], a[1]
                    A[r, k + t + 4], A[r + 8, k + t + 4] = a[2], a[3]
    assert torch.equal(A @ vt.t(), G @ V)


if __name__ == "__main__":
    # the numbers behind the f32 attention's choice (PERF.md):
    # error over the largest output and shrink of each way to accumulate
    # P V, and of one stream of kv tiles, at the kernel's kv tiles
    for D in (64, 128):
        for T in (256, 1024):
            (q, k, v), want = _attn_operands(D, T)
            for label, kw in (("O scaled", {}), ("fresh", {"o_mode": "fresh"}),
                              ("one stream", {"streams": 1})):
                got = wgmma_attention(q, k, v, ATTN_KV_TILE[D], **kw)
                err = float((got - want).abs().max() / want.abs().max())
                print(f"D {D} T {T} {label}: {err:.2e} of the largest "
                      f"output, shrink {_shrink(got, want):.2e}", flush=True)
    # the numbers behind the f32 scan's choices: error (y and the final
    # state, over the f64 algebra's largest value) and shrink of the
    # design, the mma.sync folds, raw tiles and one chain over N
    for C in (64, 256):
        for label, kw in (("design", {}), ("the mma.sync folds",
                                           {"folds": MMA_SYNC_FOLDS}),
                          ("raw tiles", {"tiles": raw}),
                          ("one chain over N",
                           {"folds": dict(SCAN_FOLDS, score=64, inter=64)})):
            run = _scan_run(C, 1024, **kw)
            print(f"scan chunk {C} T 1024 {label}: {_scan_err(run):.2e}, "
                  f"shrink {_shrink(run[0], run[2]):.2e}", flush=True)
    # ... and at xLSTM-125M's mLSTM widths (N 384, P 385), chunk 256
    for label, kw in (("design", {}), ("raw tiles", {"tiles": raw}),
                      ("one chain over N",
                       {"folds": dict(SCAN_FOLDS, score=384, inter=384)})):
        run = _scan_run(256, 300, MLSTM, **kw)
        print(f"scan mLSTM chunk 256 T 300 {label}: {_scan_err(run):.2e}, "
              f"shrink {_shrink(run[0], run[2]):.2e}", flush=True)
