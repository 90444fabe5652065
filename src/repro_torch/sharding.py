"""Logical-axis sharding policy.

Port of ``repro.sharding``.  Model code annotates tensors with *logical*
axis names; the policy maps them to mesh axes.  ``Policy.constrain`` is
the identity without a mesh, so the same model code runs one-device
tests and 512-rank dry-runs.

The default rules implement DP(+pod) x TP with optional FSDP (ZeRO-3-style
parameter sharding over the data axis) and EP (experts over the model
axis).  The BIDENT autoshard pass (``repro_torch.core.autoshard``) emits
*overrides* to these rules.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims.  A :class:`PartitionSpec` is, as in the reference, one entry per
tensor dim: ``None`` (replicated), a mesh-axis name, or a tuple of names
(the dim split over several mesh axes, the first the major one);
:func:`placements` turns it into DTensor placements, one per mesh dim.
DTensor splits a dim over several mesh dims in the mesh's order, so a
tuple whose names are not in that order cannot be expressed and raises
``ValueError``; the presets only ever list axes in mesh order.  A mesh
axis shards at most one dim of a tensor (:func:`_dedup_axes`), which
DTensor expresses as one ``Shard`` per mesh dim.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

# logical axis -> mesh axis (None = replicated). A tuple value shards one
# logical axis over several mesh axes.
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),     # pure DP composes pod x data
    "seq": None,                  # sequence replicated by default (SP opts in)
    "seq_shard": ("pod", "data"), # sequence-parallel alternative for act.s
    "seq_act": None,              # residual-stream seq axis: "model" = Megatron-SP
    "embed": None,
    "heads": "model",
    "kv_heads": None,             # kv heads replicated (GQA kv < TP degree)
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    "kv_len": None,               # KV-cache seq axis (serving layouts shard it)
    "decode_q_heads": "model",    # q heads in the decode attention region
    "attn_o_feat": "model",       # flattened attn output features (pre-wo)
    "mla_o_heads": "model",       # MLA latent attn output heads (pre-w_uv)
    "kv_heads_p": None,           # wk/wv output features (serve layouts shard)
    "state": None,
    # parameter FSDP axis: weights' non-TP dim sharded over data
    "fsdp": "data",
}


def make_rules(*, sp: bool = False, serve_layout: str | None = None,
               train_layout: str | None = None) -> dict[str, object]:
    """Rule presets of the reference's layout search.

    sp: Megatron-style sequence parallelism — residual-stream activations
        (the ``seq_act`` sites between attention/MLP regions) shard their
        seq dim over the model axis.

    train_layout: "dp" folds the model axis into batch (pure DP+FSDP),
        for models where TP only buys activation all-reduces.

    serve_layout: decode-path layouts:
      * "1d"  — batch over data, KV-cache seq over model; params TP over
        model, replicated over data.
      * "2d"  — batch replicated, KV-cache seq over (data x model),
        weights stationary 2D-sharded (d_in over data via FSDP + d_out
        over model).
    """
    rules = dict(DEFAULT_RULES)
    if sp:
        rules["seq_act"] = "model"
    if train_layout == "dp":
        # pure data parallelism: the model axis folds into batch; the pod
        # axis joins through FSDP
        rules["batch"] = ("data", "model")
        rules["heads"] = None
        rules["ff"] = None
        rules["vocab"] = None
        rules["attn_o_feat"] = None
        rules["kv_heads_p"] = None
        rules["fsdp"] = ("pod", "data", "model")   # ZeRO-3 over all chips
    elif train_layout not in (None, "tp"):
        raise ValueError(train_layout)
    if serve_layout == "1d":
        rules["kv_len"] = "model"
        rules["kv_heads_p"] = "model"
    elif serve_layout == "2d":
        # weight-stationary 2D: params shard statically over both mesh
        # axes; KV cache seq shards over all chips; batch replicates
        rules["batch"] = None
        rules["kv_len"] = ("data", "model")
        rules["ff"] = ("data", "model")
        rules["vocab"] = ("data", "model")
        rules["experts"] = ("data", "model")
        rules["kv_heads_p"] = ("data", "model")
        # q is tiny at decode: replicate it so the contraction against the
        # seq-sharded cache stays local
        rules["decode_q_heads"] = None
        rules["attn_o_feat"] = ("data", "model")
    elif serve_layout not in (None, "legacy"):
        raise ValueError(serve_layout)
    return rules


class PartitionSpec:
    """One entry per tensor dim: None, a mesh-axis name or a tuple of
    names (``jax.sharding.PartitionSpec``'s values).  Not a tuple, so the
    port's tree functions take it as a leaf; it compares equal to the
    tuple of its entries."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self) -> int:
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other.axes
        return isinstance(other, tuple) and self.axes == other

    def __hash__(self) -> int:
        return hash(self.axes)

    def __repr__(self) -> str:
        return f"P{self.axes!r}"


P = PartitionSpec


def mesh_axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def mesh_axis_size(mesh, name: str) -> int:
    """Size of the mesh axis ``name`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return int(mesh.shape[mesh_axis_names(mesh).index(name)])


def _fit_axis(mesh, dim: int, ax):
    """Largest suffix of the axis tuple whose size divides ``dim``.

    ("data","model") degrades to ("model",) then to None instead of
    jumping straight to replicated — e.g. qwen2-vl's d_ff=29568 divides
    the 16-way model axis but not the 256-way (data x model) product.
    """
    if ax is None:
        return None
    axes = ax if isinstance(ax, tuple) else (ax,)
    for i in range(len(axes)):
        cand = axes[i:]
        size = 1
        for m in cand:
            size *= mesh_axis_size(mesh, m)
        if size > 1 and dim % size == 0:
            return cand if len(cand) > 1 else cand[0]
    return None


def _dedup_axes(axes: list) -> list:
    """A mesh axis may appear at most once per PartitionSpec: later dims
    that re-request an already-claimed axis fall back to replicated (the
    first claim wins)."""
    used: set = set()
    out = []
    for ax in axes:
        keys = ax if isinstance(ax, tuple) else (ax,)
        if ax is None or not (used & set(keys)):
            out.append(ax)
            used.update(k for k in keys if k is not None)
        else:
            out.append(None)
    return out


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements (one per mesh dim) of a PartitionSpec."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {tuple(spec)}: dim {d} splits over {axes}, not in "
                f"the mesh's order {names}; DTensor splits a dim over mesh "
                f"dims in mesh order only")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {tuple(spec)}: mesh axis {names[i]} "
                                 f"shards two dims")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a PartitionSpec (``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def local_shape_and_offset(shape, mesh, pls) -> tuple[tuple, tuple]:
    """This rank's shard shape and its offset in the global tensor, for
    placements ``pls`` on ``mesh`` (splits are even: the divisibility
    guard sees to that).  Plain integers, so it also runs on fake
    tensors."""
    shape, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(pls):
        if p.is_shard():
            d, n = p.dim, mesh.size(i)
            if shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"{n} ways")
            shape[d] //= n
            offset[d] += coord[i] * shape[d]
    return tuple(shape), tuple(offset)


def assemble(local, mesh, pls, shape):
    """The DTensor of global ``shape`` whose shard on this rank is
    ``local`` (contiguous), with placements ``pls``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, tuple(pls), run_check=False,
                              shape=tuple(shape),
                              stride=_contiguous_stride(shape))


def sharded_zeros(shape, dtype, device, sharding: NamedSharding):
    """A zero DTensor of global ``shape`` with ``sharding``, each rank
    allocating only its shard."""
    local = torch.zeros(local_shape_and_offset(
        shape, sharding.mesh, sharding.placements)[0], dtype=dtype,
        device=device)
    return assemble(local, sharding.mesh, sharding.placements, shape)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place(x, mesh, pls):
    """``x`` as a DTensor on ``mesh`` with placements ``pls``: a DTensor
    is redistributed; a plain tensor is taken as the same full value on
    every rank (a tensor made inside the model, or an input every rank
    holds) and this rank keeps its shard of it."""
    from torch.distributed.tensor import DTensor, Replicate
    pls = tuple(pls)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == pls and x.device_mesh == mesh:
        return x
    return x.redistribute(mesh, pls)


def distribute(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``x`` as a DTensor with ``sharding`` (:func:`place`)."""
    return place(x, sharding.mesh, sharding.placements)


def sharded_on(x, dim: int) -> bool:
    """``x`` is a DTensor split along tensor dim ``dim``."""
    return is_dtensor(x) and any(p.is_shard(dim) for p in x.placements)


def select_layer(x, i: int):
    """``x[i]`` of a DTensor split along dim 0 (a stacked parameter whose
    layer dim FSDP claimed): only layer ``i`` is gathered, never the
    stack.  The ranks that hold layer ``i`` contribute it and the others
    zeros, as a partial sum over the mesh dims that split dim 0, which
    one all-reduce of the layer's size makes whole; the other dims keep
    their placements."""
    from torch.distributed.tensor import Partial, Shard
    mesh = x.device_mesh
    local = x.to_local()
    shape, offset = local_shape_and_offset(x.shape, mesh, x.placements)
    j = i - offset[0]
    if 0 <= j < shape[0]:
        piece = local[j]
    else:
        # zeros that stay on the autograd graph, so that every rank runs
        # the backward all-reduce of every layer, in the same order
        piece = torch.where(torch.zeros((), dtype=torch.bool,
                                        device=local.device), local[0], 0)
    part = tuple(Partial() if p.is_shard(0) else
                 Shard(p.dim - 1) if p.is_shard() else p
                 for p in x.placements)
    return settle(assemble(piece, mesh, part, x.shape[1:]))


class _HoldGrad(torch.autograd.Function):
    """Identity whose backward puts the gradient in the given placements
    (the transpose of JAX's ``with_sharding_constraint`` constrains the
    cotangent to the same sharding)."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.pl:
            g = g.redistribute(g.device_mesh, ctx.pl)
        return g, None


def hold_grad(x):
    """``x``; its gradient arrives in ``x``'s placements (partial sums
    made whole), whatever placements DTensor picks for the ops after it.
    A plain tensor, or one that needs no gradient, as it is."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return _HoldGrad.apply(x, pl)


def split_ways(x, dim: int) -> int:
    """Into how many pieces a mesh splits tensor dim ``dim`` of ``x`` (1
    for a plain tensor)."""
    if not is_dtensor(x):
        return 1
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n *= x.device_mesh.size(i)
    return n


def gather_dim(x, dim: int):
    """``x`` with its split of tensor dim ``dim`` gathered; other
    placements kept.  A plain tensor as it is."""
    if split_ways(x, dim) == 1:
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_shard(dim) else p for p in x.placements))


def reshape(x, *shape):
    """``x.reshape(*shape)``.  On a mesh DTensor views a split dim only
    where the split lands on the first factor of the new dims; where it
    cannot (a projection's features split more ways than its heads), the
    splits are gathered, the last dim first, until it can — what GSPMD
    does at such a view."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    for d in [None] + list(range(x.ndim - 1, -1, -1)):
        if d is not None:
            x = gather_dim(x, d)
        try:
            return _canonical_strides(x.reshape(*shape))
        except RuntimeError as e:
            if "Sharding propagation failed" not in str(e):
                raise
    return _canonical_strides(x.reshape(*shape))


def _canonical_strides(x):
    """A DTensor whose shards are contiguous, with the strides a
    contiguous plain tensor of its shape has.  DTensor's views can give a
    size-1 dim another stride, and ``matmul`` reads the strides to choose
    between one ``mm`` and a batched ``bmm``: with these it chooses as
    for the plain tensor, so a (1, 1) mesh computes bit for bit as one
    device."""
    if tuple(x.stride()) == _contiguous_stride(x.shape) or \
            not x.to_local().is_contiguous():
        return x
    return assemble(x.to_local(), x.device_mesh, x.placements, x.shape)


def lookup(table, tokens):
    """``table[tokens]`` (rows of a (V, d) table).  A table split over its
    rows on a mesh is looked up as GSPMD does it: each rank takes the
    rows it holds (zeros for the others), a partial sum over the mesh
    dims that split the rows, so the table is never gathered.  The
    tokens keep their batch split on the other mesh dims."""
    if not sharded_on(table, 0):
        return table[tokens.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tokens = place(tokens, mesh, [Replicate()] * mesh.ndim) \
        if not is_dtensor(tokens) else tokens
    tpl = tuple(Shard(0) if p.is_shard(0) and not q.is_shard(0)
                else Replicate()
                for p, q in zip(tokens.placements, table.placements))
    tok = place(tokens, mesh, tpl).to_local()
    shape, offset = local_shape_and_offset(table.shape, mesh,
                                           table.placements)
    loc = table.to_local()
    ids = tok.long() - offset[0]
    valid = (ids >= 0) & (ids < shape[0])
    rows = loc[ids.clamp(0, shape[0] - 1)] * valid[..., None].to(loc.dtype)
    opl = tuple(Partial() if q.is_shard(0) else
                Shard(tokens.ndim) if q.is_shard(1) else t
                for q, t in zip(table.placements, tpl))
    return assemble(rows, mesh, opl,
                    tuple(tokens.shape) + (table.shape[1],))


def rows_of(t, x):
    """``t`` (a reduction of ``x`` over its last dim, kept) placed as
    ``x``'s rows: ``x``'s splits of the leading dims, whole along the
    last.  DTensor is free to split a cheap result any way; this keeps
    the row statistics of a vocab-split tensor (and, with
    :func:`hold_grad`, their gradient) aligned with its rows."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    last = x.ndim - 1
    return t.redistribute(t.device_mesh, tuple(
        p if p.is_shard() and p.dim < last else Replicate()
        for p in x.placements))


def take_last(x, idx):
    """``x[..., idx]`` elementwise: ``gather(x, -1, idx[..., None])[...,
    0]``.  On a mesh each rank gathers from its own shard (its slice of
    the last dim, where that is split: a partial sum, zeros for the
    indices other ranks hold), so neither the forward nor the backward
    (a scatter into zeros the size of the shard) makes a tensor of the
    global shape.  ``idx`` takes ``x``'s splits of the leading dims."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx.long()[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    x = settle(x)
    mesh, last = x.device_mesh, x.ndim - 1
    ipl = tuple(p if p.is_shard() and p.dim < last else Replicate()
                for p in x.placements)
    j = place(idx, mesh, ipl).to_local().long()
    loc = x.to_local()
    shape, off = local_shape_and_offset(x.shape, mesh, x.placements)
    if shape[last] == x.shape[last]:
        out, opl = torch.gather(loc, -1, j[..., None])[..., 0], ipl
    else:
        j = j - off[last]
        inside = (j >= 0) & (j < shape[last])
        out = torch.gather(loc, -1, j.clamp(0, shape[last] - 1)[..., None])
        out = out[..., 0] * inside.to(loc.dtype)
        opl = tuple(Partial() if p.is_shard(last) else q
                    for p, q in zip(x.placements, ipl))
    return settle(assemble(out, mesh, opl, idx.shape))


def settle(x):
    """``x`` with its pending partial sums reduced (DTensor ``Partial``
    placements made ``Replicate``); a plain tensor as it is.  Called where
    DTensor's rule for the next op cannot take the partial value."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


@dataclasses.dataclass
class Policy:
    """Maps logical axis names to mesh axes and applies constraints."""

    mesh: object = None           # DeviceMesh with named dims, or None
    rules: Mapping[str, object] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    fsdp: bool = False
    # per-tensor-name overrides emitted by the autoshard pass:
    # name -> tuple of logical axes (replaces the annotation at that site)
    overrides: Mapping[str, tuple] = dataclasses.field(default_factory=dict)

    def _axis(self, logical: str | None):
        if logical is None:
            return None
        ax = self.rules.get(logical, None)
        if ax is None:
            return None
        names = mesh_axis_names(self.mesh) if self.mesh is not None else ()
        if isinstance(ax, tuple):
            # drop mesh axes that don't exist (e.g. "pod" on single-pod mesh)
            if self.mesh is not None:
                ax = tuple(a for a in ax if a in names)
                if not ax:
                    return None
                return ax if len(ax) > 1 else ax[0]
            return ax
        if self.mesh is not None and ax not in names:
            return None
        return ax

    def spec(self, *logical_axes: str | None) -> PartitionSpec:
        return P(*(self._axis(a) for a in logical_axes))

    def named(self, *logical_axes: str | None) -> tuple | None:
        """DTensor placements of the logical axes (None without a mesh)."""
        if self.mesh is None:
            return None
        return placements(self.mesh, self.spec(*logical_axes))

    def constrain(self, x, *logical_axes: str | None, name: str | None = None):
        """Redistribute ``x`` to the policy's sharding of its logical
        axes, and its gradient to the same (as the transpose of JAX's
        sharding constraint does); the identity without a mesh.  A plain
        tensor (made inside the model) becomes a DTensor first,
        replicated.

        ``name`` keys into autoshard overrides: when the BIDENT search has
        assigned this site a different sharding "PU", the override wins.
        """
        if self.mesh is None:
            return x
        if name is not None and name in self.overrides:
            logical_axes = self.overrides[name]
        return hold_grad(distribute(x, NamedSharding(
            self.mesh, self.guarded_spec(tuple(x.shape), *logical_axes))))

    def guarded_spec(self, shape: Sequence[int],
                     *logical_axes: str | None) -> PartitionSpec:
        """PartitionSpec with the divisibility guard (no FSDP pass): a
        dim whose size the mapped mesh axes don't divide stays
        replicated.  Axes are padded or trimmed to the rank."""
        axes = list(logical_axes)
        if len(axes) < len(shape):
            axes += [None] * (len(shape) - len(axes))
        axes = axes[: len(shape)]
        fixed = [_fit_axis(self.mesh, dim, self._axis(a))
                 for dim, a in zip(shape, axes)]
        return P(*_dedup_axes(fixed))

    # -- parameter specs -----------------------------------------------------
    def param_spec(self, shape: Sequence[int],
                   logical_axes: Sequence[str | None]) -> PartitionSpec:
        """PartitionSpec for a parameter; applies FSDP to the first
        unsharded (and divisible) dim when ``fsdp`` is on.  The sentinel
        logical axis ``"nofsdp"`` keeps a dim replicated AND opts it out of
        the FSDP pass."""
        axes = [self._axis(a) for a in logical_axes]
        if self.fsdp and self.mesh is not None:
            data_ax = self._axis("fsdp")
            # flatten tuple entries: ('pod','data') uses the data axis too
            used: set = set()
            for a in axes:
                used.update(a if isinstance(a, tuple) else (a,))
            if data_ax is not None and data_ax not in used and not (
                    isinstance(data_ax, tuple) and used & set(data_ax)):
                dsize = 1
                for m in (data_ax if isinstance(data_ax, tuple)
                          else (data_ax,)):
                    dsize *= mesh_axis_size(self.mesh, m)
                for i, (dim, a) in enumerate(zip(shape, axes)):
                    if (a is None and dim % dsize == 0
                            and logical_axes[i] != "nofsdp"):
                        axes[i] = data_ax
                        break
        # divisibility guard; tuple axes degrade to a dividing suffix
        fixed = [_fit_axis(self.mesh, dim, ax)
                 for dim, ax in zip(shape, axes)]
        return P(*_dedup_axes(fixed))


NO_POLICY = Policy(mesh=None)
