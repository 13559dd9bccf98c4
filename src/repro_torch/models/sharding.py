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
"""
from __future__ import annotations

import contextlib
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
    r = dict(DEFAULT_RULES, **(rules or {}))
    return NamedSharding(mesh, _resolve(names, mesh.mesh_dim_names, r))


def param_spec(mesh, logical_axes: Sequence[Optional[str]],
               rules: Optional[Rules] = None) -> NamedSharding:
    return spec_for(mesh, *logical_axes, rules=rules)


def batch_axis_names(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


# ---------------------------------------------------------------------------
# Helpers for the mesh regions of the model code
# ---------------------------------------------------------------------------

def axis_size(mesh, name: str) -> int:
    """Size of mesh axis ``name`` (1 when the mesh lacks it)."""
    names = tuple(mesh.mesh_dim_names)
    return mesh.size(names.index(name)) if name in names else 1


def axis_rank(mesh, name: str) -> int:
    """This process's coordinate along mesh axis ``name`` (0 when absent)."""
    return mesh.get_local_rank(name) if name in mesh.mesh_dim_names else 0


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
    from torch.distributed.tensor import DTensor, Shard
    mesh = sharding.mesh
    local = full
    for i, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard):
            lo, hi = chunk_bounds(local.shape[pl.dim], mesh.size(i),
                                  mesh.get_local_rank(i))
            local = local.narrow(pl.dim, lo, hi - lo)
    if local.data_ptr() != full.data_ptr() or local.numel() != full.numel():
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False, shape=full.shape,
                              stride=_stride(full.shape))


def from_local(local: torch.Tensor, mesh, spec_names: Sequence[Optional[str]],
               shape: Sequence[int]):
    """A DTensor over ``local``, this rank's shard of a tensor of global
    ``shape`` placed by the logical ``spec_names`` under the active rules."""
    from torch.distributed.tensor import DTensor
    rules = current_rules() or DEFAULT_RULES
    pl = placements(_resolve(spec_names, mesh.mesh_dim_names, rules), mesh)
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


def require_default_rules():
    """Raise unless the active rules are ``DEFAULT_RULES``: the mesh regions
    write their collectives for that mapping (the vocabulary, ``kv_seq``
    and ``dff`` over ``model``, ``expert_dff`` over ``data``, the batch over
    ``pod`` and ``data``), so under any other they would compute wrong
    values without an error."""
    rules = current_rules()
    if rules is not None and rules != DEFAULT_RULES:
        changed = sorted(k for k in set(rules) | set(DEFAULT_RULES)
                         if rules.get(k) != DEFAULT_RULES.get(k))
        raise NotImplementedError(
            f"the mesh regions run under the default sharding rules only; "
            f"these rules change {changed}")


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


def all_reduce(x: torch.Tensor, mesh, axis: str, op=None) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over the ranks of mesh axis ``axis``."""
    if axis_size(mesh, axis) == 1:
        return x
    x = x.contiguous()
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return x


def all_gather_dim(x: torch.Tensor, dim: int, mesh, axis: str,
                   total: int) -> torch.Tensor:
    """The chunks of a dim of ``total`` rows split over mesh axis ``axis``
    (``chunk_bounds``), this rank's chunk ``x``, put back together on every
    rank."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    size = -(-total // n)
    xm = x.movedim(dim, 0)
    if xm.shape[0] < size:
        xm = torch.cat([xm, xm.new_zeros((size - xm.shape[0],) + xm.shape[1:])])
    out = xm.new_empty((n * size,) + xm.shape[1:])
    dist.all_gather_into_tensor(out, xm.contiguous(),
                                group=mesh.get_group(axis))
    return out[:total].movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over mesh axis
    ``axis``; ``dim`` must split evenly over the axis."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"mesh axis {axis!r} of {n}")
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n,) + xm.shape[1:])
    dist.reduce_scatter_tensor(out, xm, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def region(fn, args: Sequence, arg_names: Sequence, out_names: Sequence):
    """``fn`` over the local shards of ``args`` under the active mesh: the
    counterpart of the reference's ``shard_map``, through ``local_map``.
    Each DTensor arg is redistributed to the placements of its logical
    names in ``arg_names`` (None for an int or a plain tensor), ``fn``
    runs on the local tensors with explicit collectives, and its outputs
    come back as DTensors placed by ``out_names``.  Outputs must split
    evenly, as ``local_map`` infers their global shapes."""
    from torch.distributed.tensor.experimental import local_map
    require_default_rules()
    mesh, rules = current_mesh(), current_rules()

    def pl(names):
        return tuple(placements(_resolve(names, mesh.mesh_dim_names, rules), mesh))

    in_pl = tuple(None if n is None else pl(n) for n in arg_names)
    out_pl = tuple(pl(n) for n in out_names)
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def mixer_region(fn, p, x, *, cache=None, cache_axes=None, inplace=(),
                 place=True, **kw):
    """A mixer under the active mesh: ``fn(p, x, cache=..., mesh=..., **kw)``
    over local shards.  ``x`` enters in the residual stream's layout and
    ``y`` leaves in it; each parameter enters gathered;
    a cache leaf enters in its storage layout ``cache_axes[k]`` when it is
    in ``inplace`` (a decode step writes its slot there), else gathered,
    and each cache leaf ``fn`` returns is placed back by ``cache_axes``
    (left gathered when not ``place``: a prefill's K/V, which the model
    pads before placing).  Cache lengths need not split evenly, so unlike
    :func:`region` the outputs are wrapped with explicit global shapes."""
    require_default_rules()
    mesh = current_mesh()
    p_loc = {k: to_local(v, *(None,) * v.dim()) for k, v in p.items()}
    c_loc = None
    if cache is not None:
        c_loc = {k: to_local(v, *(cache_axes[k] if k in inplace
                                  else gathered(cache_axes[k])))
                 for k, v in cache.items()}
    y, nc = fn(p_loc, to_local(x, *ACT), cache=c_loc, mesh=mesh, **kw)
    B = x.shape[0]
    y = from_local(y, mesh, ACT, (B,) + tuple(y.shape[1:]))
    if nc is not None:
        nc = {k: cache[k] if k in inplace else from_local(
                  v, mesh, gathered(cache_axes[k]), (B,) + tuple(v.shape[1:]))
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
