"""zamba2-2.7b-port: Zamba2-2.7B's Mamba-2 stack as the port's zamba2
pattern builds it, served through the port's model and engine.

The model is ``repro_torch.models.model`` at ``zamba2-2.7b-port.json``'s
fields, with ``use_kernels`` (the SSD scan of every Mamba-2 layer's
prefill on the hand-written kernel).  The pattern's shared block is one
attention block over the hidden state, with no MLP and no adapters; the
file names each departure from the published model (``departures``,
and the structural keys that ``PORT_PATTERN`` holds).  A batch is
served as ``Engine.generate`` serves it: ``model.prefill``, then the
engine's captured decode step (``Engine.decode_step_fn``) fed the argmax
of the last logits.  The weights are drawn on the device from the seed in one
call, in the port's parameter tree, dtypes and init scales.

The check runs the plain float32 reference (``reference/zamba2.py``)
once over each kept prompt followed by the tokens served for it, and
compares at every served position:

* ``token_gap``: how far the served token's logit lies below the
  reference's best, the widest over the positions;
* ``logit_err``: the program's logits against the reference's, the
  largest difference over the reference logits' standard deviation.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from chipbench import workcounts
from chipbench.reference import zamba2 as ref
from chipbench.reference.precision import rounding, strict_float32

# the check's reference runs this many sequences at a time
REF_BLOCK = 8
_ALIGN = 64           # elements between the starts of the drawn weights


# the shared block as the port's zamba2 pattern builds it; a file that
# asks for another is refused rather than run as this one
PORT_PATTERN = {"num_mem_blocks": 1, "shared_mlp": False,
                "shared_input": "hidden", "shared_adapters": False}


def model_config(cfg: dict):
    from repro_torch.configs.base import ModelConfig
    for key, value in PORT_PATTERN.items():
        if cfg.get(key, value) != value:
            raise ValueError(f"the port's zamba2 pattern builds {key} = "
                             f"{value!r}, not {cfg[key]!r}")
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    # d_ff sizes an MLP, and the pattern's shared block has none
    kw = {"d_ff": 0, **{k: v for k, v in cfg.items() if k in names}}
    return ModelConfig(**kw)


def param_tree(cfg: dict) -> dict:
    """The shape and dtype of every parameter of the port's ``zamba2``
    tree (``models.model.init_params``), each layer's stacked on a
    leading dim.  (Worked out here rather than on the meta device, whose
    first use costs seconds of set-up; a test holds the two equal.)"""
    d, V, L = cfg["d_model"], cfg["vocab"], cfg["n_layers"]
    di = cfg["ssm_expand"] * d
    H = di // cfg["ssm_headdim"]
    conv_dim = di + 2 * cfg["ssm_state"] * cfg["ssm_groups"]
    q, kv = cfg["n_heads"] * cfg["d_head"], cfg["n_kv_heads"] * cfg["d_head"]
    dt, f32 = cfg["dtype"], "float32"
    tree = {"embed": ((V, d), dt), "final_norm": ((d,), dt)}
    if not cfg.get("tie_embeddings", False):
        tree["lm_head"] = ((d, V), dt)
    tree["blocks"] = {"ln1": ((L, d), dt), "mamba": {
        "in_proj": ((L, d, di + conv_dim + H), dt),
        "conv_w": ((L, cfg["ssm_conv"], conv_dim), dt),
        "conv_b": ((L, conv_dim), dt), "A_log": ((L, H), f32),
        "D": ((L, H), f32), "dt_bias": ((L, H), f32),
        "norm_w": ((L, di), dt), "out_proj": ((L, di, d), dt)}}
    tree["shared_attn"] = {"ln": ((d,), dt), "attn": {
        "wq": ((d, q), dt), "wk": ((d, kv), dt), "wv": ((d, kv), dt),
        "wo": ((q, d), dt)}}
    return tree


def _leaves(tree: dict, path=()):
    """(path, leaf) pairs in ``models.model.tree_leaves``' order (keys
    sorted), the order the weights are drawn in."""
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _init(path: tuple, shape, cfg: dict):
    """How leaf ``path`` is drawn: ("normal", scale), ("const", value) or
    ("A_log", None), as ``models.model.init_params`` draws it."""
    key = path[-1]
    if key == "embed":
        return "normal", cfg["init"]["embed"]
    if key in ("lm_head", "in_proj", "out_proj", "wq", "wk", "wv", "wo"):
        return "normal", shape[-2] ** -0.5
    if key == "conv_w":
        return "normal", cfg["init"]["conv_w"]
    if key in ("final_norm", "ln1", "ln", "norm_w", "D"):
        return "const", 1.0
    if key in ("conv_b", "dt_bias"):
        return "const", 0.0
    if key == "A_log":
        return "A_log", None
    raise KeyError(f"no init rule for parameter {'/'.join(map(str, path))}")


def draw_params(cfg: dict, seed: int, device) -> dict:
    """The port's parameter tree for ``cfg``, its random leaves views of
    one standard normal draw on ``device`` in the model's dtype."""
    leaves = list(_leaves(param_tree(cfg)))
    rules = [_init(p, shape, cfg) for p, (shape, _) in leaves]
    offsets, total = [], 0
    for (_, (shape, _)), (kind, _) in zip(leaves, rules):
        offsets.append(total)
        if kind == "normal":
            total += -(-torch.Size(shape).numel() // _ALIGN) * _ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=getattr(torch, cfg["dtype"]))
    out: dict = {}
    for (path, (shape, dtype)), (kind, arg), off in zip(leaves, rules,
                                                         offsets):
        dtype = getattr(torch, dtype)
        if kind == "normal":
            if dtype != flat.dtype:
                raise TypeError(f"{path}: drawn leaves are {flat.dtype}")
            x = flat[off:off + torch.Size(shape).numel()].view(shape)
            x = x.mul_(arg)
        elif kind == "const":
            x = torch.full(shape, arg, dtype=dtype, device=device)
        else:
            a_log = torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                             device=device))
            x = a_log.to(dtype).expand(shape).contiguous()
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


class LMSystem:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans):
        from repro_torch.models import model as M
        from repro_torch.serving.engine import Engine
        self.M = M
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.mcfg = model_config(cfg)
        self.vocab = self.mcfg.vocab
        self.seed = seed
        t0 = time.perf_counter()
        self.params = draw_params(cfg, seed, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        spans["weights_s"] = time.perf_counter() - t0
        self.engine = Engine(self.mcfg, self.params)
        self._step = self.engine.decode_step_fn()

    def prefill(self, tokens, max_len: int):
        return self.M.prefill(self.mcfg, self.params, {"tokens": tokens},
                              max_len=max_len)

    def step(self, cache, tok):
        return self._step(self.params, cache, {"tokens": tok})

    def warm(self) -> None:
        """The cell's prefill shape run once and its decode step captured
        and replayed, on prompts of its own."""
        B, T, M = (self.traffic[k] for k in ("batch", "prompt_len",
                                             "new_tokens"))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 1)
        tokens = torch.randint(0, self.vocab, (B, T), generator=gen,
                               device=self.device, dtype=torch.int32)
        logits, cache = self.prefill(tokens, T + M)
        for _ in range(min(2, M - 1)):
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            logits, cache = self.step(cache, tok)
        logits.cpu()

    def work(self, kind: str, B: int, n: int) -> dict:
        """Operations of a prefill of B prompts of n tokens (and its scan
        calls' bounds), or of a decode step at position n."""
        cfg = self.cfg
        if kind == "decode":
            return {"ops": workcounts.zamba2_decode_ops(cfg, B, n)}
        di = cfg["ssm_expand"] * cfg["d_model"]
        H = di // cfg["ssm_headdim"]
        bound = workcounts.bound_s(*workcounts.ssd_scan(
            B, n, H, cfg["ssm_state"], cfg["ssm_headdim"], cfg["ssm_chunk"],
            cfg["dtype"]), cfg["dtype"])
        L = cfg["n_layers"]
        return {"ops": workcounts.zamba2_prefill_ops(cfg, B, n),
                "ssd_scan.bound_s": L * bound, "ssd_scan.calls": L}

    def release(self) -> None:
        """Drop the captured decode steps and their memory."""
        self.engine.release()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, kept: list, controls) -> dict:
        """``token_gap`` and ``logit_err`` of the program, and of each
        precision in ``controls`` put in its place, over the kept
        prompts."""
        strict_float32()
        prompts = torch.cat([p.to(self.device) for p, _, _ in kept])
        served = torch.cat([s for _, s, _ in kept]).to(self.device).long()
        prog = torch.cat([lg.to(self.device) for _, _, lg in kept]).float()
        T, M = prompts.shape[1], served.shape[1]
        seqs = torch.cat([prompts.long(), served[:, :-1]], dim=1)
        positions = torch.arange(T - 1, T + M - 1, device=self.device)

        def run(precision):
            return torch.cat([ref.logits(self.params, seqs[i:i + REF_BLOCK],
                                         self.cfg, rounding(precision),
                                         positions)
                              for i in range(0, len(seqs), REF_BLOCK)])

        want = run("float32")
        best = want.max(dim=-1).values
        scale = want.std()

        def numbers(logits, tokens):
            return {"token_gap": float((best - want.gather(
                        -1, tokens[..., None])[..., 0]).max()),
                    "logit_err": float((logits - want).abs().max() / scale)}

        out = {"program": numbers(prog, served)}
        for p in controls:
            ctrl = run(p)
            out[p] = numbers(ctrl, ctrl.argmax(dim=-1))
        return out


def build(cfg: dict, traffic: dict, seed: int, device, spans: dict):
    return LMSystem(cfg, traffic, seed, device, spans)
