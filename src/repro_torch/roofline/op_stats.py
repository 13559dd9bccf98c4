"""Per-device FLOP, byte and collective counts of eager PyTorch work: the
port's counterpart of ``repro.roofline.hlo_stats``.

There is no HLO to read in PyTorch, so :class:`OpStats` is a
``TorchDispatchMode`` that sees every aten op this process runs while it
is active, on real or fake tensors (``FakeTensorMode``), and counts:

* FLOPs: 2 · |out| · K per matrix product (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``; ``matmul``, ``einsum`` and ``linear`` decompose into them),
  with ``torch.utils.flop_counter``'s formulas (convolutions and the fused
  attention kernels too, should any run).  Elementwise work is ignored, as
  ``hlo_stats`` ignores it.
* Bytes: eager PyTorch fuses nothing, so every op that computes reads each
  of its tensor operands once and writes each output once; an op is
  charged its operand bytes plus its output bytes.  Views, metadata
  queries and bare allocations (``empty``) move nothing and are charged
  nothing.  This is ``hlo_stats``' ``bytes_raw`` convention at the
  granularity of aten ops; XLA's fusions make its ``bytes`` smaller.
  ``bytes_by_op`` splits them by op name.
* Collectives: the output-buffer bytes and the count of each collective op
  by kind, under the reference's names (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``): the
  functional collectives DTensor issues and the in-place ``c10d`` ops the
  mesh regions' ``torch.distributed`` calls dispatch to.

* Memory: the peak of the bytes held at once in storages that the ops
  allocated while the mode was active (each new output storage counted
  until it is freed), ``peak_bytes``; with the bytes still held at the
  end, ``live_bytes``.

A DTensor op is left to DTensor, whose local ops (and collectives) are then
counted: the counts are this rank's, per device, as ``hlo_stats`` reads
post-SPMD HLO.  Loops run eagerly, so a loop of 17 steps is counted 17
times; there is no trip count to parse.

A per-token loop (:func:`repro_torch.models.loops.token_loop`: the RG-LRU
prefill and the sLSTM) can be counted from a few of its steps instead, as
``hlo_stats`` scales a while body by its trip count: under
``OpStats(sample_loops=True)`` (its ``run_token_loop`` hook), on fake
tensors only, it runs :data:`SAMPLED_STEPS` steps and adds the last
step's counts for each step it skips.  Every step runs the same ops on the
same shapes, so the count is exact; in training the loop's backward is
counted on the 3- and 4-step graphs and extended the same way (its first
and last steps differ from the rest, so the counts are affine in the trip
count from 3 steps on; the ``stack`` that ends the backward of
``token_loop``'s ``unbind`` grows by one step's gradient per step too).
FLOPs, bytes and collectives are exact; ``n_ops``, a diagnostic, counts
the views of the sampled steps only.  The outputs keep their full shapes
(the sampled steps' values stand in for the rest), so only counts, never
values, come out of a sampled loop, and asking for one on real tensors
raises.  The memory peak counts the sampled steps' storages only.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.models.loops import run_steps

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name -> (kind, where its output buffer is: "out" the return value,
# "arg0" the first argument of an in-place c10d op)
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "_c10d_functional.all_reduce": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", "out"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "out"),
    "c10d.allgather_": ("all-gather", "arg0"),
    "c10d._allgather_base_": ("all-gather", "arg0"),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", "arg0"),
    "c10d.allreduce_": ("all-reduce", "arg0"),
    "c10d.allreduce_coalesced_": ("all-reduce", "arg0"),
    "c10d.reduce_scatter_": ("reduce-scatter", "arg0"),
    "c10d._reduce_scatter_base_": ("reduce-scatter", "arg0"),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", "arg0"),
    "c10d.alltoall_base_": ("all-to-all", "arg0"),
    "c10d.alltoall_": ("all-to-all", "arg0"),
    "c10d.send": ("collective-permute", "arg0"),
    "c10d.recv_": ("collective-permute", "arg0"),
}

# bare allocations, aliases and host-side bookkeeping: no bytes moved
_MOVES_NOTHING = {"empty", "empty_strided", "empty_like", "new_empty",
                  "new_empty_strided", "detach", "alias", "lift_fresh",
                  "wait_tensor", "_local_scalar_dense", "set_",
                  "record_stream"}
_METADATA = {"size", "sym_size", "stride", "sym_stride", "numel", "sym_numel",
             "dim", "storage_offset", "sym_storage_offset", "is_contiguous",
             "sym_is_contiguous", "is_strides_like_format",
             "is_non_overlapping_and_dense"}


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _name(func) -> str:
    pk = func._overloadpacket
    return f"{pk._qualified_op_name.split('::')[0]}.{pk.__name__}"


class OpStats(TorchDispatchMode):
    """Counts FLOPs, bytes and collectives of the ops run while active;
    :meth:`stats` returns them in ``hlo_stats``' keys."""

    def __init__(self, sample_loops: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        # the hook models.loops.token_loop looks for on the mode stack
        self.run_token_loop = self._sampled_loop if sample_loops else None
        self._flop_fns = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.op_bytes = defaultdict(float)     # the bytes, by op name
        self.coll = defaultdict(float)
        self.coll_n = defaultdict(int)
        self.n_ops = 0
        self.live = self.peak = 0
        self._held = set()

    def _hold(self, out, args):
        """Count each new storage among ``out`` until it is freed."""
        mine = {id(t.untyped_storage()) for t in tree_leaves(args)
                if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in mine or key in self._held:
                continue
            n = st.nbytes()
            self._held.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        self._held.discard(key)
        self.live -= n

    def _sampled_loop(self, step, carry, xs, n, consts):
        """``token_loop``'s steps, :data:`SAMPLED_STEPS` of them run and
        the counts extended to ``n`` (the module docstring)."""
        from torch._subclasses.fake_tensor import is_fake
        tensors = carry + xs + consts
        if not all(is_fake(t) for t in tensors):
            raise RuntimeError("loop sampling counts fake tensors only: on "
                               "real tensors every step must run")
        if n <= SAMPLED_STEPS:
            return run_steps(step, carry, [x.unbind(1) for x in xs], n, consts)
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            out = _SampledLoop.apply(self, step, n, len(carry), len(xs),
                                     *tensors)
            return tuple(out[:-1]), out[-1]
        ys, carry = _sample(self, step, carry,
                            [x[:, :SAMPLED_STEPS].unbind(1) for x in xs],
                            consts, n)
        return carry, torch.stack(ys + [ys[-1]] * (n - len(ys)), dim=1)

    def _counts(self) -> Dict[str, float]:
        """The additive counters, flat: what a sampled loop extends."""
        out = {"flops": self.flops, "bytes": self.bytes, "n_ops": self.n_ops}
        out.update({f"coll/{k}": v for k, v in self.coll.items()})
        out.update({f"n/{k}": v for k, v in self.coll_n.items()})
        out.update({f"op/{k}": v for k, v in self.op_bytes.items()})
        return out

    def _add(self, delta: Dict[str, float]):
        self.flops += delta.get("flops", 0)
        self.bytes += delta.get("bytes", 0)
        self.n_ops += int(delta.get("n_ops", 0))
        for k, v in delta.items():
            if v and k.startswith("coll/"):
                self.coll[k[5:]] += v
            elif v and k.startswith("n/"):
                self.coll_n[k[2:]] += int(v)
            elif v and k.startswith("op/"):
                self.op_bytes[k[3:]] += v

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs it as local ops
        pk = func._overloadpacket
        if pk.__name__ in _METADATA or func is torch.ops.prim.layout.default:
            return NotImplemented
        if pk not in self._flop_fns and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        name = _name(func)
        self.n_ops += 1
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None:
            kind, where = coll
            self.coll[kind] += _nbytes(out if where == "out" else args[0])
            self.coll_n[kind] += 1
        elif pk in self._flop_fns:
            self.flops += float(self._flop_fns[pk](*args, **kwargs, out_val=out))
        if not func.is_view and func is not torch.ops.prim.device.default:
            if coll is None and pk.__name__ not in _MOVES_NOTHING:
                b = _nbytes((args, kwargs)) + _nbytes(out)
                self.bytes += b
                self.op_bytes[name] += b
            self._hold(out, (args, kwargs))
        return out

    def stats(self) -> Dict:
        """``{"flops", "bytes", "bytes_by_op", "collective_bytes",
        "collective_counts", "n_ops", "peak_bytes", "live_bytes"}``, per
        device (this rank); ``bytes_by_op`` the bytes of each op name, most
        first."""
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_by_op": dict(sorted(self.op_bytes.items(),
                                           key=lambda kv: -kv[1])),
                "collective_bytes": {k: self.coll.get(k, 0.0) for k in COLLECTIVES},
                "collective_counts": {k: self.coll_n.get(k, 0) for k in COLLECTIVES},
                "n_ops": self.n_ops, "peak_bytes": self.peak,
                "live_bytes": self.live}


def op_stats(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, its :meth:`OpStats.stats`)."""
    mode = OpStats()
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.stats()


# ---------------------------------------------------------------------------
# Per-token loops
# ---------------------------------------------------------------------------

SAMPLED_STEPS = 4


def _diff(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {k: b.get(k, 0) - a.get(k, 0) for k in set(a) | set(b)}


def _sample(mode, step, carry, steps, consts, n):
    """:data:`SAMPLED_STEPS` steps over ``steps`` (each input's per-step
    tensors), the forward counts extended to ``n``: (their outputs, the
    carry after them)."""
    ys, snaps = [], []
    for t in range(SAMPLED_STEPS):
        carry, y = step(carry, tuple(s[t] for s in steps), consts)
        ys.append(y)
        if t >= SAMPLED_STEPS - 2:
            snaps.append(mode._counts())
    mode._add({k: (n - SAMPLED_STEPS) * v
               for k, v in _diff(snaps[0], snaps[1]).items()})
    return ys, carry


class _SampledLoop(torch.autograd.Function):
    """A sampled loop in training.  The forward builds the 4-step graph
    (its counts extended to ``n``) and, uncounted, the 3-step graph; the
    backward runs each through its graph and extends their difference to
    ``n`` steps.  Each graph takes the first 3 or 4 steps of every input
    as a leaf of its own and unbinds it, as ``token_loop`` unbinds a whole
    input, so its backward ends in a ``stack`` of its step gradients as a
    full loop's ends in a ``stack`` of ``n``: that op's bytes grow by one
    step's gradient read and written per step, which the extension
    counts.  The inputs' gradients are returned as empty stand-ins of
    their full shapes (no values come out of a sampled loop)."""

    @staticmethod
    def forward(ctx, mode, step, n, nc, nx, *tensors):
        # the inner graphs keep their own saved tensors: a remat region's
        # hooks would recompute them in the backward, which runs them twice
        keep = torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                        lambda t: t)

        def leaf(t):
            return t.detach().requires_grad_(t.requires_grad)

        def inputs(k):
            return [leaf(x[:, :k]) for x in tensors[nc:nc + nx]]

        with torch.enable_grad(), keep:
            carry = tuple(leaf(t) for t in tensors[:nc])
            consts = tuple(leaf(t) for t in tensors[nc + nx:])
            x4 = inputs(SAMPLED_STEPS)
            ys, c4 = _sample(mode, step, carry, [x.unbind(1) for x in x4],
                             consts, n)
            before = mode._counts()
            x3 = inputs(SAMPLED_STEPS - 1)
            c3, ys3 = carry, []
            for t_steps in zip(*[x.unbind(1) for x in x3]):
                c3, y = step(c3, t_steps, consts)
                ys3.append(y)
            mode._add(_diff(mode._counts(), before))
        ctx.mode, ctx.n, ctx.shapes = mode, n, [x.shape for x in
                                                tensors[nc:nc + nx]]
        ctx.graphs = ((ys3, c3, list(carry) + x3 + list(consts)),
                      (ys, c4, list(carry) + x4 + list(consts)))
        ctx.nc = nc
        ctx.set_materialize_grads(False)
        out = [c.detach() for c in c4]
        ys = [y.detach() for y in ys]
        return tuple(out) + (torch.stack(ys + [ys[-1]] * (n - len(ys)), dim=1),)

    @staticmethod
    def backward(ctx, *grads):
        mode, n = ctx.mode, ctx.n
        g_carry, g_ys = grads[:-1], grads[-1]

        def run(ys, carry, leaves):
            outs, gs = [], []
            for t, y in enumerate(ys):
                if g_ys is not None:
                    outs.append(y)
                    gs.append(g_ys[:, t])
            for c, g in zip(carry, g_carry):
                if g is not None:
                    outs.append(c)
                    gs.append(g)
            want = [i for i, t in enumerate(leaves) if t.requires_grad]
            got = torch.autograd.grad(outs, [leaves[i] for i in want], gs,
                                      allow_unused=True)
            out = [None] * len(leaves)
            for i, g in zip(want, got):
                out[i] = g
            return out

        s0 = mode._counts()
        got = run(*ctx.graphs[0])
        s1 = mode._counts()
        run(*ctx.graphs[1])
        s2 = mode._counts()
        # counted: d3 + d4; wanted: d3 + (n - 3) (d4 - d3)
        d3, d4 = _diff(s0, s1), _diff(s1, s2)
        mode._add({k: (n - SAMPLED_STEPS + 1) * (d4.get(k, 0) - d3.get(k, 0))
                   - d4.get(k, 0) for k in set(d3) | set(d4)})
        nc, nx = ctx.nc, len(ctx.shapes)
        for i, shape in enumerate(ctx.shapes):
            if got[nc + i] is not None:
                got[nc + i] = got[nc + i].new_empty(shape)
        return (None,) * 5 + tuple(got)
