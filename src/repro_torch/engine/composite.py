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
groups them by their parts' shapes and forms each group's products as one
broadcast product, with the same roundings.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.domain import Clique
from repro_torch.core.mechanism import Measurement, noise_dtype
from repro_torch.core.partition import ROW_EMPTY
from repro_torch.engine.engine import EngineStats, ReleaseServing
from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.obs import TRACER
from repro_torch.release import POSTPROCESS_MODES, postprocess_release


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
        self._straddlers: Optional[Dict[tuple, list]] = None

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

    def _straddler_groups(self) -> Dict[tuple, List[Tuple[int, list]]]:
        """Straddling workload rows grouped by the shapes of their parts and
        the transpose back to sorted attribute order: ``{(part shapes,
        perm): [(row, [(block, part clique), ...]), ...]}``, parts in the
        JAX package's ``Decomposition.parts_of`` order.  Built once."""
        if self._straddlers is None:
            d = self.plan.decomposition
            dom = d.workload.domain
            order = np.argsort(d.part_row, kind="stable")
            rows = d.part_row[order]
            cut = np.flatnonzero(np.diff(rows)) + 1
            groups: Dict[tuple, List[Tuple[int, list]]] = {}
            for grp in np.split(order, cut):
                if not grp.size:
                    continue
                parts = [(int(d.part_block[i]), d.part_clique(i))
                         for i in grp]
                attrs = [a for _, pc in parts for a in pc]
                key = (tuple(dom.clique_sizes(pc) for _, pc in parts),
                       tuple(np.argsort(np.asarray(attrs)).tolist()))
                groups.setdefault(key, []).append(
                    (int(d.part_row[grp[0]]), parts))
            self._straddlers = groups
        return self._straddlers

    def _assemble(self, block_tables: List[Dict[Clique, np.ndarray]],
                  total: float, cliques: Sequence[Clique]
                  ) -> Dict[Clique, np.ndarray]:
        """Original-workload tables from block tables (+ straddler products)."""
        d = self.plan.decomposition
        wk = d.workload.cliques
        rows = {c: r for r, c in enumerate(wk)}
        out: Dict[Clique, np.ndarray] = {}
        wanted = set()
        for c in cliques:
            r = rows[c]
            b = int(d.row_block[r])
            if b >= 0:
                out[c] = block_tables[b][c]
            elif b == ROW_EMPTY:
                out[c] = np.asarray([total], dtype=float)
            else:
                wanted.add(r)
        for (shapes, perm), group in self._straddler_groups().items():
            members = [(r, parts) for r, parts in group if r in wanted]
            if not members:
                continue
            g = len(members)
            tab = None
            for p, shape in enumerate(shapes):
                pt = np.stack([block_tables[parts[p][0]][parts[p][1]]
                               for _, parts in members]
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
            for i, (r, _) in enumerate(members):
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
