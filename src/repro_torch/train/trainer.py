"""The training step: loss, gradients by autograd, gradient accumulation,
optional top-k compression, AdamW.

Port of ``repro.train.trainer``.  The reference trains on its plain jnp
path (a Pallas call has no implicit VJP), and so does the port: the loss
is :func:`repro_torch.models.model.loss_fn`, whose ``forward`` never
reaches a kernel, and its gradient is autograd's.  On the card the step
runs eagerly on one device, or on a device mesh through
:func:`jit_train_step`, with parameters, optimizer state and batch
placed by the partition-spec functions (:func:`param_pspecs`,
:func:`batch_pspecs`).

``_PARAM_AXES`` and :func:`logical_axes_for` are kept: they name each
parameter's logical axes, which a sharding policy maps onto a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

from ..models import model as M
from ..optim import adamw
from ..sharding import NO_POLICY, NamedSharding, P, Policy, distribute

F32 = torch.float32

# logical axes for the *last* dims of each named parameter; leading stack
# dims are padded with None.  'heads'/'ff'/'experts'/'vocab' all map to the
# model axis under the default rules; FSDP then claims one leftover dim.
_PARAM_AXES: dict[str, tuple] = {
    "embed": ("vocab", "nofsdp"),
    "lm_head": ("nofsdp", "vocab"),
    "wq": (None, "heads"),
    "wk": (None, "kv_heads_p"),
    "wv": (None, "kv_heads_p"),
    "wo": ("ff", None),
    "wi": (None, "ff"),
    "w_up": ("experts", None, None),
    "w_down": ("experts", None, None),
    "router": (None, None),
    "wq_a": (None, None),
    "wq_b": (None, "heads"),
    "wkv_a": (None, None),
    "wkv_b": (None, "heads"),
    "in_proj": (None, "ff"),
    "out_proj": ("ff", None),
    "up": (None, "ff"),
    "down": ("ff", None),
    "w_in": (None, "ff"),
    "proj": (None, None),
}


def logical_axes_for(path, shape) -> tuple:
    """Logical axes of the parameter at ``path`` (a tuple of dict keys and
    list indices, as :func:`repro_torch.models.model.tree_flatten_with_path`
    gives it): named by its last dict key."""
    name = None
    for p in reversed(path):
        if isinstance(p, str):
            name = p
            break
    axes = _PARAM_AXES.get(name, ())
    ndim = len(shape)
    if len(axes) > ndim:
        axes = axes[-ndim:]
    return (None,) * (ndim - len(axes)) + tuple(axes)


def _map_with_path(fn, tree):
    return M.tree_unflatten(tree, [fn(path, leaf) for path, leaf
                                   in M.tree_flatten_with_path(tree)])


def param_pspecs(policy: Policy, params_tree):
    """Tree of PartitionSpec matching params (works on ``meta`` tensors)."""
    return _map_with_path(
        lambda path, leaf: policy.param_spec(
            tuple(leaf.shape), logical_axes_for(path, leaf.shape)),
        params_tree)


def param_shardings(policy: Policy, params_tree):
    return M.tree_map(lambda s: NamedSharding(policy.mesh, s),
                      param_pspecs(policy, params_tree))


def batch_pspecs(policy: Policy, batch_tree):
    # guarded: a batch dim the data axes don't divide (e.g. the
    # long_500k cell's global_batch=1) stays replicated
    return _map_with_path(
        lambda path, leaf: policy.guarded_spec(tuple(leaf.shape), "batch"),
        batch_tree)


def distribute_tree(tree, shardings):
    """Every leaf of ``tree`` distributed to the NamedSharding at its
    place in ``shardings``."""
    return M.tree_map(distribute, tree, shardings)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1           # gradient accumulation steps
    opt: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)
    # top-k gradient compression with error feedback (optim.compress);
    # None = exact synchronization
    compress: "object" = None


def value_and_grad(cfg, params, batch, policy: Policy = NO_POLICY):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``: the loss and
    metrics detached, grads a tree like ``params`` in its dtypes."""
    paths = M.tree_flatten_with_path(params)
    leaves = [p.detach().requires_grad_(True) for _, p in paths]
    loss, met = M.loss_fn(cfg, M.tree_unflatten(params, leaves), batch,
                          policy)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    met = {k: v.detach() for k, v in met.items()}
    return loss.detach(), met, M.tree_unflatten(params, grads)


def make_train_step(cfg, tc: TrainConfig, policy: Policy = NO_POLICY):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  With ``tc.microbatches > 1`` the batch's leading dim is
    split and gradients are summed in f32 over the microbatches, then
    divided by their number; the loss is the mean, the metrics are the
    last microbatch's."""

    def grads_of(params, batch):
        if tc.microbatches <= 1:
            return value_and_grad(cfg, params, batch, policy)
        n = tc.microbatches

        def split_mb(x):
            return x.reshape(n, x.shape[0] // n, *x.shape[1:])
        mbs = M.tree_map(split_mb, batch)
        acc = M.tree_map(lambda x: torch.zeros(x.shape, dtype=F32,
                                               device=x.device), params)
        lsum = 0.0
        for i in range(n):
            l, met, g = value_and_grad(cfg, params,
                                       M.tree_map(lambda x: x[i], mbs),
                                       policy)
            acc = M.tree_map(lambda a, x: a + x.to(F32), acc, g)
            lsum = lsum + l
            del g
        g = M.tree_map(lambda x: x / n, acc)
        return lsum / n, met, g

    if tc.compress is not None:
        from ..optim import compress as C

        def train_step(params, state, batch):
            opt_state, residual = state["opt"], state["residual"]
            l, met, g = grads_of(params, batch)
            g, residual = C.compress(tc.compress, g, residual)
            params, opt_state, om = adamw.apply_updates(tc.opt, params, g,
                                                        opt_state)
            met = dict(met)
            met.update(om)
            met["loss"] = l
            return params, {"opt": opt_state, "residual": residual}, met

        return train_step

    def train_step(params, opt_state, batch):
        l, met, g = grads_of(params, batch)
        params, opt_state, om = adamw.apply_updates(tc.opt, params, g,
                                                    opt_state)
        met = dict(met)
        met.update(om)
        met["loss"] = l
        return params, opt_state, met

    return train_step


def jit_train_step(cfg, tc: TrainConfig, policy: Policy, params_shapes,
                   batch_shapes):
    """The train step with explicit in/out shardings (what the dry-run
    lowers): ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on the policy's mesh.  Inputs may be plain tensors (the
    full value on every rank) or DTensors; outputs are DTensors with the
    parameter placements, the metrics replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    raw = make_train_step(cfg, tc, policy)
    mesh = policy.mesh
    pspec = param_shardings(policy, params_shapes)
    rep = NamedSharding(mesh, P())
    bspec = M.tree_map(lambda s: NamedSharding(mesh, s),
                       batch_pspecs(policy, batch_shapes))

    def opt_spec(opt_state):
        return {k: (pspec if k in ("mu", "nu") else rep) for k in opt_state}

    def step(params, opt_state, batch):
        ospec = opt_spec(opt_state)
        with implicit_replication():
            params = distribute_tree(params, pspec)
            opt_state = distribute_tree(opt_state, ospec)
            batch = distribute_tree(batch, bspec)
            params, opt_state, met = raw(params, opt_state, batch)
            return (distribute_tree(params, pspec),
                    distribute_tree(opt_state, ospec),
                    M.tree_map(lambda x: distribute(x, rep), met))

    return step


@contextlib.contextmanager
def deterministic_training():
    """Deterministic kernels for the span of a training run, so that a
    step gives the same bits every time and a resume from a checkpoint is
    exact: ``torch.use_deterministic_algorithms`` (the embedding's and
    the loss gather's backward sum without atomics) with cuBLAS's fixed
    workspace.  Ops that have no deterministic kernel warn rather than
    fail.  Both settings are restored on exit, so serving paths run with
    their own."""
    was = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    var = "CUBLAS_WORKSPACE_CONFIG"
    old = os.environ.get(var)
    os.environ[var] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=was_warn)
        if old is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = old


__all__ = ["_PARAM_AXES", "logical_axes_for", "TrainConfig",
           "make_train_step", "value_and_grad", "deterministic_training",
           "param_pspecs", "param_shardings", "batch_pspecs",
           "distribute_tree", "jit_train_step"]
