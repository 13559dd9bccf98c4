"""CompositeEngine: serve a block-decomposed plan through the block engines.

The port of ``repro.engine.composite``.  Measurement and reconstruction
dispatch per block to ordinary
:class:`~repro_torch.engine.engine.MarginalEngine` instances obtained
through the engine cache (:func:`repro_torch.engine.sharded._engine_for`),
so block engines are shared across composite engines, sharded calls and
repeated releases — a block planned twice is set up once.

Noise: the JAX package splits the caller's key into one key per block.  The
port derives one ``torch.Generator`` per block from the caller's generator,
in block order (:meth:`CompositeEngine.block_generators`): one
``torch.randint`` of ``n_blocks`` 62-bit seeds from the caller's generator,
and block b's generator, on the engine's device, seeded with ``seeds[b]``.
One seeded caller generator therefore gives the same release every time,
and each block engine draws exactly the noise it would draw serving its
block alone from that block's generator.

The one cross-block subtlety is the shared empty clique: every block closure
contains ∅, but the composite charges its pcost once, so the noisy total is
**measured once** (by block 0) and injected into every other block's
measurement dict before reconstruction.  (Later blocks still draw their own
∅ noise — discarding an unreleased draw costs nothing — which keeps each
block engine's noise identical to serving that block standalone.)

Cut-straddling workload cliques are reconstructed by the product-of-blocks
correction: the normalized outer product of their per-block part tables,
``(⊗_p M̂_p) / T̂^{n_parts−1}`` with T̂ the shared noisy total, in float64
on the host.  The JAX package walks the straddlers one by one; the port
groups them by their parts' shapes (:func:`straddler_groups`, numpy over
every straddler at once) and forms each group's products as one broadcast
product, with the same roundings: every table bit-equal to the JAX
package's.
"""
from __future__ import annotations

from itertools import chain
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.domain import Clique
from repro_torch.core.mechanism import Measurement, noise_dtype
from repro_torch.core.partition import ROW_EMPTY, group_rows
from repro_torch.engine.engine import EngineStats, ReleaseServing
from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.obs import TRACER
from repro_torch.release import POSTPROCESS_MODES, postprocess_release


class StraddlerGroup(NamedTuple):
    """Straddling workload rows whose parts have one tuple of shapes and one
    transpose back to sorted attribute order.  ``rows`` ascend; part ``p``
    of member ``i`` is ``block_workloads[blocks[i, p]].cliques[pos[i, p]]``,
    parts in the JAX package's ``Decomposition.parts_of`` order."""

    rows: np.ndarray
    blocks: np.ndarray
    pos: np.ndarray


def straddler_groups(d) -> Dict[tuple, StraddlerGroup]:
    """``{(part shapes, perm): StraddlerGroup}`` of a Decomposition, groups
    in the order of their first row.  One integer signature per straddler
    (its parts' widths, their attributes' sizes and the argsort of its
    attributes taken part after part), sorted once: no Python step per
    straddler."""
    order = np.argsort(d.part_row, kind="stable")
    if not order.size:
        return {}
    prow = d.part_row[order]
    start = np.flatnonzero(np.r_[True, prow[1:] != prow[:-1]])
    count = np.diff(np.r_[start, prow.size])
    n_p = int(count.max())
    live = np.arange(n_p) < count[:, None]                     # (R, n_p)
    idx = order[np.minimum(start[:, None] + np.arange(n_p), prow.size - 1)]
    # every block clique's attributes, padded with -1, one row each
    cl = [c for bw in d.block_workloads for c in bw.cliques]
    lens = np.fromiter(map(len, cl), np.int64, len(cl))
    k = int(lens.max())
    attrs = np.full((len(cl), k), -1, np.int64)
    attrs[np.repeat(np.arange(len(cl)), lens),
          np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                 lens)] = np.fromiter(
        chain.from_iterable(cl), np.int64, int(lens.sum()))
    offs = np.cumsum([0] + [len(bw.cliques) for bw in d.block_workloads])
    a = attrs[offs[d.part_block[idx]] + d.part_pos[idx]]      # (R, n_p, k)
    a[~live] = -1
    valid = (a >= 0).reshape(len(start), -1)
    flat = a.reshape(len(start), -1)
    sizes = np.asarray(d.workload.domain.sizes, np.int64)
    shape = np.where(flat >= 0, sizes[np.maximum(flat, 0)], 0)
    # the argsort of the concatenated part attributes, in compact positions
    srt = np.argsort(np.where(valid, flat, np.iinfo(np.int64).max), axis=1,
                     kind="stable")
    compact = np.cumsum(valid, axis=1) - 1
    perm = np.where(np.take_along_axis(valid, srt, 1),
                    np.take_along_axis(compact, srt, 1), -1)
    sig = np.concatenate([(a >= 0).sum(axis=2), shape, perm], axis=1)
    rows = prow[start]
    groups: Dict[tuple, StraddlerGroup] = {}
    for mem in sorted(group_rows(sig), key=lambda m: m[0]):
        rep = int(mem[0])
        n = int(count[rep])
        shapes = tuple(tuple(int(sizes[x]) for x in a[rep, p] if x >= 0)
                       for p in range(n))
        key = (shapes, tuple(int(x) for x in perm[rep] if x >= 0))
        groups[key] = StraddlerGroup(rows[mem], d.part_block[idx[mem, :n]],
                                     d.part_pos[idx[mem, :n]])
    return groups


class CompositeEngine(ReleaseServing):
    """Measurement/reconstruction/release for a CompositePlan.

    ``precompile`` is accepted for the engines' signature: the block
    engines come from the engine cache, built without a warm-up launch.
    ``device`` is ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.
    """

    def __init__(self, plan, use_kernel: Optional[bool] = None,
                 precompile: bool = True, dtype=None, device=None):
        from repro_torch.engine.sharded import _engine_for
        self.plan = plan
        self.device = resolve_device(device)
        self.use_kernel = True if use_kernel is None else use_kernel
        self.dtype = noise_dtype() if dtype is None else dtype
        self.stats = EngineStats()
        self._engines = [_engine_for(bp, self.use_kernel, self.dtype,
                                     device=self.device)
                         for bp in plan.block_plans]
        self.stats.measure_signatures = sum(
            e.stats.measure_signatures for e in self._engines)
        self.stats.reconstruct_signatures = sum(
            e.stats.reconstruct_signatures for e in self._engines)
        self._straddlers: Optional[Dict[tuple, StraddlerGroup]] = None

    # ------------------------------------------------------------------ serve
    def block_generators(self, gen: torch.Generator) -> List[torch.Generator]:
        """One generator per block, derived from ``gen`` in block order (see
        the module docstring); advances ``gen`` by one ``torch.randint``."""
        seeds = torch.randint(0, 1 << 62, (len(self._engines),),
                              generator=gen, dtype=torch.int64,
                              device=gen.device).tolist()
        return [torch.Generator(device=self.device).manual_seed(int(s))
                for s in seeds]

    def measure(self, marginals: Mapping[Clique, np.ndarray],
                gen: torch.Generator) -> Dict[Clique, Measurement]:
        """Per-block Algorithm 1; the shared ∅ is block 0's measurement."""
        self.stats.bump("measure_calls")
        gens = self.block_generators(gen)
        out: Dict[Clique, Measurement] = {}
        with TRACER.span("engine.measure").set(
                engine="composite", blocks=len(self._engines),
                use_kernel=self.use_kernel):
            for b, eng in enumerate(self._engines):
                mb = dict(eng.measure(marginals, gens[b]))
                if b > 0:
                    mb[()] = out[()]
                out.update(mb)
        return out

    def _block_tables(self, measurements: Mapping[Clique, Measurement]
                      ) -> List[Dict[Clique, np.ndarray]]:
        """Each block's reconstructed sub-workload (in-block rows + parts)."""
        return [eng.reconstruct(measurements) for eng in self._engines]

    def _straddler_groups(self) -> Dict[tuple, StraddlerGroup]:
        """The straddlers grouped once (:func:`straddler_groups`)."""
        if self._straddlers is None:
            self._straddlers = straddler_groups(self.plan.decomposition)
        return self._straddlers

    def _assemble(self, block_tables: List[Dict[Clique, np.ndarray]],
                  total: float, cliques: Sequence[Clique]
                  ) -> Dict[Clique, np.ndarray]:
        """Original-workload tables from block tables (+ straddler products)."""
        d = self.plan.decomposition
        wk = d.workload.cliques
        rows = {c: r for r, c in enumerate(wk)}
        out: Dict[Clique, np.ndarray] = {}
        wanted = np.zeros(len(wk), bool)
        for c in cliques:
            r = rows[c]
            b = int(d.row_block[r])
            if b >= 0:
                out[c] = block_tables[b][c]
            elif b == ROW_EMPTY:
                out[c] = np.asarray([total], dtype=float)
            else:
                wanted[r] = True
        for (shapes, perm), grp in self._straddler_groups().items():
            keep = wanted[grp.rows]
            if not keep.any():
                continue
            members = grp.rows[keep].tolist()
            g = len(members)
            tab = None
            for p, shape in enumerate(shapes):
                pt = np.stack([
                    block_tables[b][d.block_workloads[b].cliques[q]]
                    for b, q in zip(grp.blocks[keep, p].tolist(),
                                    grp.pos[keep, p].tolist())]
                ).astype(np.float64).reshape((g,) + shape)
                if tab is None:
                    tab = pt
                else:
                    tab = (tab.reshape(tab.shape + (1,) * len(shape))
                           * pt.reshape((g,) + (1,) * (tab.ndim - 1) + shape))
            if len(shapes) > 1:
                den = float(total) ** (len(shapes) - 1)
                tiny = np.finfo(np.float64).tiny
                if abs(den) < tiny:
                    den = np.copysign(tiny, den if den else 1.0)
                tab = tab / den
            tab = np.transpose(tab, (0,) + tuple(q + 1 for q in perm))
            tab = np.ascontiguousarray(tab).reshape(g, -1)
            for i, r in enumerate(members):
                out[wk[r]] = tab[i]
        return {c: out[c] for c in cliques}

    def reconstruct(self, measurements: Mapping[Clique, Measurement],
                    cliques: Optional[Sequence[Clique]] = None
                    ) -> Dict[Clique, np.ndarray]:
        """Per-block Algorithm 2, then stitch the original workload's tables."""
        self.stats.bump("reconstruct_calls")
        d = self.plan.decomposition
        total = float(np.asarray(measurements[()].omega,
                                 float).reshape(-1)[0])
        cliques = list(d.workload.cliques if cliques is None else cliques)
        with TRACER.span("engine.reconstruct").set(
                engine="composite", blocks=len(self._engines),
                use_kernel=self.use_kernel):
            return self._assemble(self._block_tables(measurements), total,
                                  cliques)

    # ---------------------------------------------------------------- release
    def release(self, marginals, gen: torch.Generator,
                postprocess: Optional[str] = None,
                total: Optional[float] = None, weights=None,
                mw_rounds: int = 0, **post_opts):
        """measure → per-block reconstruct (→ per-block postprocess) → stitch.

        Postprocessing runs the release subsystem independently on each
        block's plan and tables, on the engine's device and kernels
        (consistency and non-negativity are per-block properties; the blocks
        only share the total, which ``total=`` pins for every block, the
        measured total by default).  Straddler products are rebuilt from the
        *postprocessed* part tables, so ``"nonneg"`` straddler marginals are
        products of non-negative factors — non-negative themselves — and
        ``synthesize`` works end to end.
        """
        if postprocess is None:
            meas = self.measure(marginals, gen)
            return self.reconstruct(meas), meas
        if postprocess not in POSTPROCESS_MODES:
            raise ValueError(f"postprocess mode must be one of "
                             f"{POSTPROCESS_MODES}, got {postprocess!r}")
        if weights is not None:
            raise ValueError("per-marginal postprocess weights are not "
                             "supported on a composite plan; postprocess the "
                             "block plans directly instead")
        meas = self.measure(marginals, gen)
        bt = self._block_tables(meas)
        t_meas = float(np.asarray(meas[()].omega, float).reshape(-1)[0])
        t_pin = t_meas if total is None else float(total)
        post = [postprocess_release(bp, tables, postprocess, total=t_pin,
                                    mw_rounds=mw_rounds, device=self.device,
                                    use_kernel=self.use_kernel, **post_opts)
                for bp, tables in zip(self.plan.block_plans, bt)]
        out = self._assemble(post, t_pin, list(self.plan.workload.cliques))
        self.stats.bump("postprocess_calls")
        if postprocess == "nonneg":
            self._synth_tables = out
        return out, meas

    # ------------------------------------------------------------- introspect
    def variances(self) -> Dict[Clique, float]:
        return self.plan.workload_variances()

    def block_engines(self) -> List:
        """The per-block engines (shared via the engine cache)."""
        return list(self._engines)
