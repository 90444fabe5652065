"""Batched serving engine: prefill + greedy decode with KV/state caches.

Port of ``repro.serving.engine``'s ``Engine``.  The reference keeps one
jitted decode step per engine (``jax.jit`` traces it once per shape
signature and donates the cache).  Here, on a CUDA device, the decode
step is captured once per (batch, cache) shape signature as a CUDA graph
(``repro_torch.core.capture``) and replayed: the cache lives in the
graph's static input buffers and the step updates it in place, and only
the logits are copied out.  On the CPU the step runs eagerly.

Under a profiler each decode step is an ``engine.decode_step`` span
(:mod:`repro_torch.tracing`) holding the replay's ``capture.replay``, or
``capture.capture`` on a new signature.

``decode_trace_counts`` keeps the reference's meaning: one entry per
signature, counted once each time the step is prepared for it (captured
on the card, first run on the CPU), so two same-shape ``generate`` calls
show one.

On a mesh, :func:`jit_prefill` and :func:`jit_decode_step` are the
reference's jitted steps with explicit in/out shardings: the arguments
are distributed to the placements of :func:`cache_pspecs` and the
trainer's parameter and batch specs (DTensors), the step runs on them
eagerly, and the logits and cache are redistributed to the output
placements.  The reference donates the cache to its decode step; here
the step updates the cache's shards in place (``decode_step(...,
donate=True)``) and returns them: the cache passed in is consumed, as a
donated one is.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import tracing
from ..core.capture import CapturedCall, capture_call
from ..models import model as M
from ..models.model import _CACHE_AXES, cache_pspecs  # noqa: F401
from ..sharding import NamedSharding, Policy, distribute
from ..train.trainer import batch_pspecs, distribute_tree, param_shardings


def cache_shardings(policy: Policy, cache_tree):
    return M.tree_map(lambda s: NamedSharding(policy.mesh, s),
                      cache_pspecs(policy, cache_tree))


def _batch_of(batch_shapes) -> int:
    return M.tree_leaves(batch_shapes)[0].shape[0]


def _batch_shardings(policy: Policy, batch_shapes):
    return M.tree_map(lambda s: NamedSharding(policy.mesh, s),
                      batch_pspecs(policy, batch_shapes))


def _logits_sharding(cfg, policy: Policy, B: int) -> NamedSharding:
    return NamedSharding(policy.mesh, policy.guarded_spec(
        (B, 1, cfg.vocab), "batch", None, "vocab"))


def jit_decode_step(cfg, policy: Policy, params_shapes, cache_shapes,
                    batch_shapes):
    """serve_step: one new token against an existing cache, on the
    policy's mesh.  ``step(params, cache, batch) -> (logits, cache)``."""
    from torch.distributed.tensor.experimental import implicit_replication
    pshard = param_shardings(policy, params_shapes)
    cshard = cache_shardings(policy, cache_shapes)
    bshard = _batch_shardings(policy, batch_shapes)
    lshard = _logits_sharding(cfg, policy, _batch_of(batch_shapes))

    def step(params, cache, batch):
        with implicit_replication():
            params = distribute_tree(params, pshard)
            cache = distribute_tree(cache, cshard)
            batch = distribute_tree(batch, bshard)
            logits, cache = M.decode_step(cfg, params, cache, batch, policy,
                                          donate=True)
            return distribute(logits, lshard), distribute_tree(cache, cshard)

    return step


def jit_prefill(cfg, policy: Policy, params_shapes, batch_shapes,
                max_len: int):
    """The prompt's prefill on the policy's mesh: ``pre(params, batch) ->
    (last-position logits, cache)``."""
    from torch.distributed.tensor.experimental import implicit_replication
    pshard = param_shardings(policy, params_shapes)
    bshard = _batch_shardings(policy, batch_shapes)
    B = _batch_of(batch_shapes)
    cshard = cache_shardings(policy, M.init_cache(cfg, B, max_len, "meta"))
    lshard = _logits_sharding(cfg, policy, B)

    def pre(params, batch):
        with implicit_replication():
            params = distribute_tree(params, pshard)
            batch = distribute_tree(batch, bshard)
            logits, cache = M.prefill(cfg, params, batch, max_len=max_len,
                                      shd=policy)
            return distribute(logits, lshard), distribute_tree(cache, cshard)

    return pre


@dataclasses.dataclass
class _CapturedStep:
    call: CapturedCall
    params: Any          # the tree the graph reads (by address)
    cache: dict          # the graph's static cache, updated by each replay


@dataclasses.dataclass
class Engine:
    cfg: Any
    params: Any
    policy: Policy = dataclasses.field(default_factory=Policy)
    decode_trace_counts: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _captured: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def decode_step_fn(self):
        """The engine's decode step ``step(params, cache, batch) ->
        (logits, cache)``.

        On the card the returned cache is the graph's own, updated in
        place by the next step of the same signature (the reference
        donates the cache likewise): pass it back as it is, and it is not
        copied.  A cache of the same signature from elsewhere (a new
        prefill) is copied into the graph's buffers first.
        """
        return self._step

    def _step(self, params, cache, batch):
        with tracing.span("engine.decode_step"):
            return self._decode_step(params, cache, batch)

    def _decode_step(self, params, cache, batch):
        tokens = batch["tokens"]
        leaves = M.tree_leaves(cache)
        key = (tuple(tokens.shape), tuple(tuple(l.shape) for l in leaves))
        if tokens.device.type != "cuda":
            if key not in self.decode_trace_counts:
                self.decode_trace_counts[key] = 1
            return M.decode_step(self.cfg, params, cache, batch, self.policy)
        rec = self._captured.get(key)
        if rec is not None and rec.params is params:
            logits = rec.call.replay((tokens, *leaves))
            return logits, rec.cache
        if rec is not None:
            rec.call.release()
        cfg, policy = self.cfg, self.policy

        def step(tok, *cache_leaves):
            c = M.tree_unflatten(cache, cache_leaves)
            logits, _ = M.decode_step(cfg, params, c, {"tokens": tok}, policy,
                                      donate=True)
            return logits

        # the run just before the capture steps the static cache once and
        # gives this call's logits; replays then step it in place
        call, logits = capture_call(step, (tokens, *leaves), tokens.device)
        rec = _CapturedStep(call, params,
                            M.tree_unflatten(cache, call.static_in[1:]))
        self._captured[key] = rec
        self.decode_trace_counts[key] = self.decode_trace_counts.get(key, 0) + 1
        return logits, rec.cache

    def release(self) -> None:
        """Drop every captured step and its memory pool."""
        for rec in self._captured.values():
            rec.call.release()
        self._captured.clear()

    def generate(self, prompt_tokens, max_new: int = 16,
                 max_len: int | None = None):
        """Greedy batched generation.  prompt_tokens: (B, T) int on the
        params' device.  Returns (B, max_new) int32."""
        B, T = prompt_tokens.shape
        max_len = max_len or (T + max_new)
        logits, cache = M.prefill(self.cfg, self.params,
                                  {"tokens": prompt_tokens},
                                  max_len=max_len, shd=self.policy)
        outs = []
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        step = self.decode_step_fn()
        for _ in range(max_new):
            outs.append(tok)
            logits, cache = step(self.params, cache, {"tokens": tok})
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        return torch.cat(outs, dim=1)
