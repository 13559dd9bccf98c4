"""Logical-axis sharding rules on DTensor: the port of
``repro.models.sharding``.

Model code names the axes of its parameters, caches and activations with
*logical* names; a rule set maps each name to mesh axes.  The rules are
the reference's: feature dims shard over ``model``, batch over (``pod``,
``data``), sequence over ``model`` in attention regions, vocab and experts
over ``model``, parameter d_model and expert d_ff over ``data``.

A resolved spec is a tuple with one entry per tensor dim: ``None``, a mesh
axis name, or a tuple of mesh axis names (one tensor dim split over
several mesh dims, major first), exactly a ``jax.sharding.PartitionSpec``'s
entries.  :func:`placements` turns it into a DTensor placement list, one
``Shard(dim)`` or ``Replicate()`` per mesh dim.  Where the reference calls
``with_sharding_constraint``, :func:`logical` calls
``DTensor.redistribute``; on a plain tensor, or outside a
:func:`sharding_rules` context, it returns its input.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names`` (:mod:`repro_torch.launch.mesh` builds them); its
process groups must exist before it does, so nothing here starts one.

The mesh regions take their axes from the active rules
(:func:`rule_axes`): the batch rows from ``batch``, the vocabulary shard
from ``vocab``, attention's query rows, heads and cache slots from
``seq_shard``, ``heads_shard`` and ``kv_seq``, SwiGLU's hidden units from
``dff``, the experts and their d_ff slices from ``experts`` and
``expert_dff``, the mixers' projection columns from ``qkv`` and
``rnn_state``; a rule naming several mesh axes splits over them major
first (:func:`axes_bounds`), and one naming none leaves the work whole on
every rank.  So they run under the dry run's per-shape rules as under
:data:`DEFAULT_RULES`.

A mixer region (:func:`mixer_region`) enters each parameter in its
storage layout with only the FSDP axis (``dmodel_fsdp``, ``data``)
gathered: a dim the rules put on ``model`` (``qkv``, ``rnn_state``) stays
split, as XLA's partitioner splits the reference's projections from the
same rules, and each rank projects with its own columns.  The
activations move instead of the weights: :func:`exchange` turns a split of
the columns into a split of the rows, re-chunks columns into the heads a
rank needs, or gathers them whole, in one ``all_to_all_single`` with
per-rank sizes.

Training runs through the same regions.  Their collectives are autograd
functions with Megatron's conjugate backward (:func:`all_reduce` out of a
region: identity; :func:`copy_in`: all-reduce; :func:`all_gather_dim` for a
consumer every rank computes alike: this rank's chunk;
:func:`gather_scatter_dim` and :func:`reduce_scatter_dim`: each other's
collective; :func:`all_to_all` and :func:`exchange`: the reverse exchange),
and a region's inputs leave it with the gradient placements of
:func:`grad_placements` (a split parameter's as its shard), which
DTensor's redistribute then reduces into each parameter's layout.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# Default logical→mesh rules (single- and multi-pod; 'pod' silently dropped
# when absent from the mesh).
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,                # embedding-layer seq: replicated
    "seq_shard": "model",       # sequence-parallel regions (attention/FFN acts)
    "dmodel": None,
    "dmodel_fsdp": "data",      # parameter storage: d_model sharded over data
    "qkv": "model",             # flattened head*head_dim projections
    "heads": None,              # head axis in attention math: replicated
    "heads_shard": "model",     # padded-head attention sharding
    "kv_seq": "model",          # decode split-K: cache length over model
    "dff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_dff": "data",       # expert weights: d_ff slice per data shard
    "rnn_state": "model",
    "lora": None,
}

_local = threading.local()


def current_rules() -> Optional[Rules]:
    return getattr(_local, "rules", None)


def current_mesh():
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def sharding_rules(mesh, rules: Optional[Rules] = None):
    """Activate logical-axis sharding for model code inside this context."""
    prev = (current_mesh(), current_rules())
    _local.mesh = mesh
    _local.rules = dict(DEFAULT_RULES, **(rules or {})) if mesh is not None else None
    try:
        yield
    finally:
        _local.mesh, _local.rules = prev


def _resolve(names: Sequence[Optional[str]], axis_names: Sequence[str],
             rules: Rules) -> Spec:
    """The mesh axes of each tensor dim named ``names``, on a mesh whose
    axes are ``axis_names``: the entries of the reference's PartitionSpec."""
    axes = []
    for n in names:
        if n is None:
            axes.append(None)
            continue
        tgt = rules.get(n, None)
        if tgt is None:
            axes.append(None)
        elif isinstance(tgt, tuple):
            present = tuple(t for t in tgt if t in axis_names)
            # one axis left: the name itself, as a PartitionSpec keeps it
            axes.append(present if len(present) > 1
                        else present[0] if present else None)
        else:
            axes.append(tgt if tgt in axis_names else None)
    return tuple(axes)


def placements(spec: Spec, mesh) -> List:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that tensor dim ``d`` is split over, ``Replicate()`` on the
    rest."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        for a in (axes,) if isinstance(axes, str) else (axes or ()):
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
            out[names.index(a)] = Shard(d)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: object
    spec: Spec

    @property
    def placements(self) -> List:
        return placements(self.spec, self.mesh)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def logical(x, *names: Optional[str]):
    """``x`` redistributed to the placements of the logical ``names``; ``x``
    itself when it is a plain tensor or no mesh context is active."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None or not is_dtensor(x):
        return x
    want = placements(_resolve(names, mesh.mesh_dim_names, rules), mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)


def spec_for(mesh, *names: Optional[str],
             rules: Optional[Rules] = None) -> NamedSharding:
    """The sharding of logical ``names`` on ``mesh`` under the active rules
    (the default rules outside a context), updated by ``rules``."""
    r = dict(current_rules() or DEFAULT_RULES, **(rules or {}))
    return NamedSharding(mesh, _resolve(names, mesh.mesh_dim_names, r))


def param_spec(mesh, logical_axes: Sequence[Optional[str]],
               rules: Optional[Rules] = None) -> NamedSharding:
    return spec_for(mesh, *logical_axes, rules=rules)


BATCH_AXES = ("pod", "data")     # the mesh axes the default rules split a batch over


def rule_axes(name: str, mesh=None) -> Tuple[str, ...]:
    """The mesh axes (major first) that logical axis ``name`` splits over
    under the active rules (the default rules outside a context), on
    ``mesh`` (the active one by default); () where it is replicated."""
    mesh = current_mesh() if mesh is None else mesh
    a = _resolve((name,), mesh.mesh_dim_names,
                 current_rules() or DEFAULT_RULES)[0]
    return () if a is None else (a,) if isinstance(a, str) else tuple(a)


def batch_axis_names(mesh) -> Tuple[str, ...]:
    """The mesh axes a batch splits over: the ``batch`` rule's."""
    return rule_axes("batch", mesh)


# ---------------------------------------------------------------------------
# Helpers for the mesh regions of the model code
# ---------------------------------------------------------------------------

def _axes(axis) -> Tuple[str, ...]:
    """One mesh axis name or several (major first), as a tuple."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh, name) -> int:
    """Size of mesh axis ``name`` (1 when the mesh lacks it); of several
    axes, the product."""
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in _axes(name):
        n *= mesh.size(names.index(a)) if a in names else 1
    return n


def axis_rank(mesh, name) -> int:
    """This process's coordinate along mesh axis ``name`` (0 when absent);
    along several, the flat index, the first axis major."""
    i = 0
    for a in _axes(name):
        i = i * axis_size(mesh, a) + (
            mesh.get_local_rank(a) if a in mesh.mesh_dim_names else 0)
    return i


def axes_bounds(n: int, mesh, axes) -> Tuple[int, int]:
    """[start, stop) of this rank's chunk of ``n`` rows split over ``axes``
    one after the other, the first major: the rows a DTensor sharded on
    those mesh dims in that order holds (:func:`chunk_bounds` at each
    level)."""
    lo, hi = 0, n
    for a in _axes(axes):
        l2, h2 = chunk_bounds(hi - lo, axis_size(mesh, a), axis_rank(mesh, a))
        lo, hi = lo + l2, lo + h2
    return lo, hi


def chunk_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of chunk ``index`` when ``n`` rows are split into
    ``parts`` as ``torch.chunk`` (and a DTensor ``Shard``) splits them:
    chunks of ceil(n / parts) rows, the last ones short or empty."""
    size = -(-n // parts) if parts else n
    start = min(index * size, n)
    return start, min(start + size, n)


def distribute(full: torch.Tensor, sharding: NamedSharding):
    """A DTensor of ``sharding`` whose global value is ``full``, a tensor
    every rank holds alike (drawn from one seed, or read from one file).
    Each rank keeps its own slice; nothing is communicated."""
    return place(full, sharding.mesh, sharding.placements)


def place(full: torch.Tensor, mesh, pl):
    """:func:`distribute` onto the placements ``pl`` of ``mesh`` (those of
    an existing DTensor, say)."""
    from torch.distributed.tensor import Shard
    local = full
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            lo, hi = chunk_bounds(local.shape[p.dim], mesh.size(i),
                                  mesh.get_local_rank(i))
            local = local.narrow(p.dim, lo, hi - lo)
    if local.numel() != full.numel():      # a slice: its own storage
        local = local.clone(memory_format=torch.contiguous_format)
    return wrap_local(local, mesh, pl, full.shape)


def from_local(local: torch.Tensor, mesh, spec_names: Sequence[Optional[str]],
               shape: Sequence[int]):
    """A DTensor over ``local``, this rank's shard of a tensor of global
    ``shape`` placed by the logical ``spec_names`` under the active rules."""
    rules = current_rules() or DEFAULT_RULES
    pl = placements(_resolve(spec_names, mesh.mesh_dim_names, rules), mesh)
    return wrap_local(local, mesh, pl, shape)


def wrap_local(local: torch.Tensor, mesh, pl, shape):
    """A DTensor of global ``shape`` over ``local``, this rank's shard
    placed ``pl``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=_stride(shape))


def _stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def to_local(x, *names: Optional[str]):
    """The local shard of ``x`` redistributed to the logical ``names``; a
    plain tensor as it is."""
    return logical(x, *names).to_local() if is_dtensor(x) else x


def require_group():
    """Raise unless a default process group exists: a mesh entry point
    never builds one on its own."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group; call "
            "torch.distributed.init_process_group (nccl on CUDA, gloo on the "
            "CPU) with its address, world size and rank first")


ACT = ("batch", "seq", "dmodel")      # the residual stream between blocks


def gathered(names: Sequence[Optional[str]]) -> Tuple[Optional[str], ...]:
    """``names`` with every axis but ``batch`` replicated: the layout a
    region computes in when the reference constrains nothing inside it."""
    return tuple(n if n == "batch" else None for n in names)


# The collectives of the mesh regions, each with the backward its use needs
# (Megatron's conjugate pairs): a region's inputs enter through
# ``to_local(grad_placements=)`` (:func:`grad_placements`), so these carry
# only what the region does inside.

class _ReduceOut(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: a region's partial sums
    leaving it for a consumer that every rank computes alike."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyIn(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward: a value every rank
    holds alike entering work that each rank does differently."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _gather0(x: torch.Tensor, n: int, size: int, group) -> torch.Tensor:
    """The (n * size, ...) concatenation of each rank's ``x`` (its first dim
    zero-padded to ``size`` rows)."""
    if x.shape[0] < size:
        x = torch.cat([x, x.new_zeros((size - x.shape[0],) + x.shape[1:])])
    out = x.new_empty((n * size,) + x.shape[1:])
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _scatter0(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """This rank's chunk of the first dim of the sum of ``x`` over ranks."""
    out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


class _GatherSlice(torch.autograd.Function):
    """All-gather forward (dim 0, chunks of ``chunk_bounds``), this rank's
    chunk of the gradient backward: the gathered value's consumer is
    computed alike on every rank, so its gradient is whole on each."""

    @staticmethod
    def forward(ctx, x, n, rank, total, group):
        ctx.bounds = chunk_bounds(total, n, rank)
        return _gather0(x, n, -(-total // n), group)[:total]

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.bounds
        return g[lo:hi], None, None, None, None


class _GatherScatter(torch.autograd.Function):
    """All-gather forward (dim 0, even chunks), reduce-scatter backward:
    the gathered value feeds work that each rank does differently."""

    @staticmethod
    def forward(ctx, x, n, group):
        ctx.n, ctx.group = n, group
        return _gather0(x, n, x.shape[0], group)

    @staticmethod
    def backward(ctx, g):
        return _scatter0(g, ctx.n, ctx.group), None, None


class _ScatterGather(torch.autograd.Function):
    """Reduce-scatter forward (dim 0, even chunks), all-gather backward."""

    @staticmethod
    def forward(ctx, x, n, group):
        ctx.n, ctx.group = n, group
        return _scatter0(x, n, group)

    @staticmethod
    def backward(ctx, g):
        return _gather0(g, ctx.n, g.shape[0], ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks forward; the same exchange of
    the gradient backward (each rank's chunk goes back where it came
    from)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def all_reduce(x: torch.Tensor, mesh, axis, op=None) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over the ranks of mesh axis ``axis``
    (or of several axes).  The sum's backward is the identity (a region's
    partial sums leaving it); another ``op`` carries no gradient."""
    if not isinstance(axis, str):
        for a in axis:
            x = all_reduce(x, mesh, a, op)
        return x
    if axis_size(mesh, axis) == 1:
        return x
    group = mesh.get_group(axis)
    if op in (None, dist.ReduceOp.SUM) and torch.is_grad_enabled() \
            and x.requires_grad:
        return _ReduceOut.apply(x, group)
    x = x.detach().contiguous()     # no gradient: in place, as dist does
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


def copy_in(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``x`` itself; in the backward its gradient summed over mesh axis
    ``axis`` or axes (a value alike on every rank entering work each does
    differently)."""
    if not isinstance(axis, str):
        for a in axis:
            x = copy_in(x, mesh, a)
        return x
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyIn.apply(x, mesh.get_group(axis))


def all_gather_dim(x: torch.Tensor, dim: int, mesh, axis,
                   total: int) -> torch.Tensor:
    """The chunks of a dim of ``total`` rows split over mesh axis ``axis``
    (``chunk_bounds``; several axes: :func:`axes_bounds`), this rank's
    chunk ``x``, put back together on every rank.  Backward: this rank's
    chunk of the gradient, which the consumers, computed alike on every
    rank, give whole."""
    if not isinstance(axis, str):
        for i in reversed(range(len(axis))):     # innermost level first
            lo, hi = axes_bounds(total, mesh, axis[:i])
            x = all_gather_dim(x, dim, mesh, axis[i], hi - lo)
        return x
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    out = _GatherSlice.apply(x.movedim(dim, 0), n, axis_rank(mesh, axis),
                             total, mesh.get_group(axis))
    return out.movedim(0, dim)


def gather_scatter_dim(x: torch.Tensor, dim: int, mesh, axis) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` over
    mesh axis ``axis`` (several: the first major); backward, the gradient
    reduce-scattered (each rank worked differently on the gathered rows)."""
    if not isinstance(axis, str):
        for a in reversed(axis):
            x = gather_scatter_dim(x, dim, mesh, a)
        return x
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    out = _GatherScatter.apply(x.movedim(dim, 0), n, mesh.get_group(axis))
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, mesh, axis) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over mesh axis
    ``axis`` (several: the first major); ``dim`` must split evenly over
    the axis.  Backward: the gradient all-gathered."""
    if not isinstance(axis, str):
        for a in axis:
            x = reduce_scatter_dim(x, dim, mesh, a)
        return x
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"mesh axis {axis!r} of {n}")
    out = _ScatterGather.apply(x.movedim(dim, 0), n, mesh.get_group(axis))
    return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``all_to_all_single`` of the equal first-dim chunks of ``x`` over
    mesh axis ``axis``; backward, the gradient's chunks sent back."""
    return _AllToAll.apply(x, mesh.get_group(axis))


Bounds = Sequence[Tuple[int, int]]


def one_axis(name: str, mesh=None) -> Tuple[str, ...]:
    """The mesh axis (as a 1-tuple; () where it is replicated) the logical
    axis ``name`` splits over under the active rules: the split of a
    mixer's projections over ``qkv`` or ``rnn_state``, which the regions
    exchange over one axis only."""
    axes = rule_axes(name, mesh)
    if len(axes) > 1:
        raise ValueError(f"the mixers split {name!r} over one mesh axis, "
                         f"not {axes}")
    return axes


def rank_chunks(n: int, mesh, axis) -> List[Tuple[int, int]]:
    """Every rank's [start, stop) of ``n`` rows split over mesh axis
    ``axis`` (``()``: one rank holding all), in rank order: the chunks a
    DTensor ``Shard`` holds (:func:`chunk_bounds`)."""
    m = axis_size(mesh, axis) if axis else 1
    return [chunk_bounds(n, m, r) for r in range(m)]


def _overlap(p: Tuple[int, int], q: Tuple[int, int]) -> Tuple[int, int]:
    """The rows runs ``p`` and ``q`` share (an empty run at ``p``'s start
    where they share none)."""
    lo, hi = max(p[0], q[0]), min(p[1], q[1])
    return (lo, hi) if hi > lo else (p[0], p[0])


def _exchange(x, group, me, a, src, b, dst):
    """The exchange of :func:`exchange` on local tensors (``group`` None:
    one rank).  Each piece a rank receives is added into its block, so
    ranks whose ``src`` rows overlap add their values."""
    n, same = len(src), a == b
    total = max(hi for _, hi in src)

    def piece(i, j):        # the [lo, hi) along ``a`` rank i sends rank j
        return _overlap(src[i], dst[j]) if same else src[i]

    def shape(i, j):
        s = list(x.shape)
        lo, hi = piece(i, j)
        s[a] = hi - lo
        if not same:
            s[b] = dst[j][1] - dst[j][0]
        return s

    def send(j):
        lo, hi = piece(me, j)
        y = x.narrow(a, lo - src[me][0], hi - lo)
        return y if same else y.narrow(b, dst[j][0], dst[j][1] - dst[j][0])

    out_shape = list(x.shape)
    out_shape[b] = dst[me][1] - dst[me][0]
    if not same:
        out_shape[a] = total
    base = dst[me][0] if same else 0
    numel = [[math.prod(shape(i, j)) for j in range(n)] for i in range(n)]
    if group is None or not any(numel[i][j] for i in range(n)
                                for j in range(n) if i != j):
        got = {me: send(me)}
    else:
        buf = torch.cat([send(j).reshape(-1) for j in range(n)])
        recv = buf.new_empty(sum(numel[i][me] for i in range(n)))
        dist.all_to_all_single(recv, buf.contiguous(),
                               [numel[i][me] for i in range(n)],
                               [numel[me][j] for j in range(n)], group=group)
        got, off = {}, 0
        for i in range(n):
            got[i] = recv[off:off + numel[i][me]].view(shape(i, me))
            off += numel[i][me]
    pieces = [(piece(i, me)[0] - base, got[i]) for i in sorted(got)
              if got[i].numel()]
    if not pieces:
        return x.new_zeros(out_shape)
    if len(pieces) == 1 and tuple(pieces[0][1].shape) == tuple(out_shape):
        return pieces[0][1]
    disjoint = all(pieces[k][0] + pieces[k][1].shape[a] <= pieces[k + 1][0]
                   for k in range(len(pieces) - 1))
    if disjoint and sum(p.shape[a] for _, p in pieces) == out_shape[a]:
        return torch.cat([p for _, p in pieces], dim=a)
    out = x.new_zeros(out_shape)
    for lo, p in pieces:
        out.narrow(a, lo, p.shape[a]).add_(p)
    return out


class _Exchange(torch.autograd.Function):
    """:func:`exchange` forward; the reverse exchange of the gradient
    backward (each piece sent back where it came from, the pieces of rows
    several ranks received added)."""

    @staticmethod
    def forward(ctx, x, group, me, a, src, b, dst):
        ctx.back = (group, me, b, dst, a, src)
        return _exchange(x, group, me, a, src, b, dst)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g.contiguous(), *ctx.back),) + (None,) * 6


def exchange(x: torch.Tensor, mesh, axis, src_dim: int, src: Bounds,
             dst_dim: int, dst: Bounds) -> torch.Tensor:
    """Move a tensor between two splits over mesh axis ``axis`` (a 1-tuple
    or ``()``).  Rank r holds ``x``: the rows ``src[r]`` of dim
    ``src_dim`` (the ``src`` chunks partition it), and, when ``dst_dim``
    is another dim, all of that dim.  It returns the rows ``dst[r]`` of
    dim ``dst_dim`` (and, when ``src_dim`` is another dim, all of
    ``src_dim``): a split of the columns turned into a split of the rows,
    or the columns re-chunked into other (possibly overlapping) runs, or
    gathered whole.  One ``all_to_all_single`` with per-rank sizes (an
    ``all_gather`` where every rank gathers equal chunks whole, and no
    collective where no rank needs another's rows); backward, the reverse
    exchange, which adds the gradients of rows several ranks received."""
    n = axis_size(mesh, axis) if axis else 1
    a, b = src_dim % x.dim(), dst_dim % x.dim()
    src, dst = [tuple(s) for s in src], [tuple(d) for d in dst]
    if n > 1 and a == b and len({hi - lo for lo, hi in src}) == 1 \
            and all(d == (0, src[-1][1]) for d in dst):
        return gather_scatter_dim(x, a, mesh, axis[0])
    if n == 1:
        return _exchange(x, None, 0, a, src, b, dst)
    return _Exchange.apply(x, mesh.get_group(axis[0]), axis_rank(mesh, axis),
                           a, src, b, dst)


def grad_placements(pl, mesh, split: Sequence[str]):
    """The gradient placements of a region input placed ``pl``: ``Shard``
    where the input is split (each rank's gradient of its own slice: a
    projection's columns over ``qkv`` or ``rnn_state``, its rows of the
    output projection, its d_ff or vocabulary slice), ``Partial`` over the
    batch axes where it is replicated (each rank's rows contribute), and
    over the axes ``split`` (the ranks along them did different work on
    it: projection columns, query rows, heads, d_ff, vocabulary columns,
    expert tokens); ``Replicate`` where the ranks computed the same
    thing."""
    from torch.distributed.tensor import Partial, Shard
    names = tuple(mesh.mesh_dim_names)
    partial = set(batch_axis_names(mesh)) | set(split)
    return tuple(p if isinstance(p, Shard)
                 else Partial() if names[i] in partial else p
                 for i, p in enumerate(pl))


def _enter(x, names, mesh, split: Sequence[str]):
    """The local shard of DTensor ``x`` placed by the logical ``names``,
    its gradient placed by :func:`grad_placements`."""
    x = logical(x, *names)
    return x.to_local(grad_placements=grad_placements(
        x.placements, mesh, split))


def _global_shape(local: torch.Tensor, pl, mesh) -> Tuple[int, ...]:
    """The global shape of ``local`` placed ``pl``, split evenly."""
    from torch.distributed.tensor import Shard
    shape = list(local.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.size(i)
    return tuple(shape)


def region(fn, args: Sequence, arg_names: Sequence, out_names: Sequence, *,
           split: Sequence[str] = ()):
    """``fn`` over the local shards of ``args`` under the active mesh: the
    counterpart of the reference's ``shard_map``.  Each DTensor arg is
    redistributed to the placements of its logical names in ``arg_names``
    (None for an int or a plain tensor), ``fn`` runs on the local tensors
    with explicit collectives, and its outputs come back as DTensors placed
    by ``out_names``, split evenly (their global shapes are inferred).  The
    inputs' gradients are placed by :func:`grad_placements`: ``split``
    names the mesh axes whose ranks work differently on them (the axes of
    the rule the region splits its work by)."""
    mesh, rules = current_mesh(), current_rules()
    local = [_enter(a, n, mesh, split) if is_dtensor(a) else a
             for a, n in zip(args, arg_names)]
    outs = fn(*local)
    single = isinstance(outs, torch.Tensor)
    wrapped = []
    for y, names in zip((outs,) if single else outs, out_names):
        pl = placements(_resolve(names, mesh.mesh_dim_names, rules), mesh)
        wrapped.append(wrap_local(y, mesh, pl, _global_shape(y, pl, mesh)))
    return wrapped[0] if single else tuple(wrapped)


def mixer_region(fn, p, x, *, axes, cache=None, cache_axes=None, inplace=(),
                 stored=None, place=True, split: Sequence[str] = (),
                 acts=None, **kw):
    """A mixer under the active mesh: ``fn(p, x, cache=..., mesh=..., **kw)``
    over local shards.  ``x`` enters in the residual stream's layout and
    ``y`` leaves in it.  Each parameter ``k`` enters placed by the logical
    names ``axes[k]``: its storage layout with the FSDP axis
    (``dmodel_fsdp``) gathered, so a dim the rules put on ``model``
    (``qkv``, ``rnn_state``) stays split and each rank holds its columns
    (or rows) of the projection.  A cache leaf enters in its storage
    layout ``cache_axes[k]`` when it is in ``inplace`` (a decode step
    writes its slot there) or in ``stored`` (a dict of the leaf's global
    shape past the batch: RG-LRU's state, split like its channels, leaves
    in that layout too), else gathered; each other cache leaf ``fn``
    returns is placed back by ``cache_axes`` (left gathered when not
    ``place``: a prefill's K/V, which the model pads before placing).
    ``split``: the mesh axes whose ranks do different work (the axes of
    ``qkv`` or ``rnn_state``, and attention's query rows or heads), over
    which the gradients of ``x`` and of the parameters they hold whole are
    partial (:func:`grad_placements`); a split parameter's gradient leaves
    as its shard.  ``acts``: other activations, passed to ``fn`` by
    keyword (a cross attention's encoder output), each entered as ``x``
    is.  Cache lengths need not split evenly, so unlike :func:`region`
    the outputs are wrapped with explicit global shapes."""
    mesh = current_mesh()
    stored = stored or {}
    kw.update({k: _enter(a, ACT, mesh, split) for k, a in (acts or {}).items()})
    p_loc = {k: _enter(v, axes[k], mesh, split) for k, v in p.items()}
    c_loc = None
    if cache is not None:
        c_loc = {k: to_local(v, *(cache_axes[k] if k in inplace or k in stored
                                  else gathered(cache_axes[k])))
                 for k, v in cache.items()}
    y, nc = fn(p_loc, _enter(x, ACT, mesh, split), cache=c_loc,
               mesh=mesh, **kw)
    B = x.shape[0]
    y = from_local(y, mesh, ACT, (B,) + tuple(y.shape[1:]))
    if nc is not None:
        nc = {k: cache[k] if k in inplace else from_local(
                  v, mesh, cache_axes[k] if k in stored
                  else gathered(cache_axes[k]),
                  (B,) + tuple(stored.get(k, v.shape[1:])))
              for k, v in nc.items()}
        if place:
            nc = {k: logical(v, *cache_axes[k]) for k, v in nc.items()}
    return y, nc


def batch_rows(mesh, B: int) -> Tuple[int, int]:
    """[start, stop) of this rank's rows of a batch of ``B`` split over the
    batch axes (``pod`` major, then ``data``)."""
    nb, ib = 1, 0
    for a in batch_axis_names(mesh):
        nb, ib = nb * axis_size(mesh, a), ib * axis_size(mesh, a) + axis_rank(mesh, a)
    if B % nb:
        raise ValueError(f"a batch of {B} does not split over the mesh's "
                         f"{nb} batch shards")
    return chunk_bounds(B, nb, ib)
