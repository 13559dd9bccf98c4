"""PlusEngine: signature-batched serving of ResidualPlanner+ (Algs 5/6).

The port of ``repro.engine.plus_engine``.  Three generalizations over
:class:`~repro_torch.engine.engine.MarginalEngine`:

* **Generalized signatures** — cliques batch by per-axis ``(Sub_i, Γ_i, W_i)``
  factor shape + value tokens (``plus_signature_groups``), not attribute
  sizes: Γ_i ≠ Sub_i for non-identity bases, so equal sizes no longer imply
  equal chains.
* **Staged [v; z] measurement** — ω = (⊗Sub_i) v + σ(⊗Γ_i) z runs as at most
  two chains per group: stage A applies the general-axis ``Sub_i`` to the
  v rows (Γ_i = I there, so the noise stream skips those axes), stage B rides
  the stacked ``[v'; z]`` pairs of the whole group down the identity-axis
  chain.
* **Merged reconstruction with an implicit-W epilogue** — Algorithm 6's
  2^|A| subset matvecs collapse into ONE chain per signature group via the
  generalized T_i = [Sub_i† | (1/n_i)·1] embedding, with W_i folded into the
  chain factor (identity/total/custom) or applied implicitly: prefix as the
  ``'cumsum'`` epilogue of the fused kernel, range as that epilogue followed
  by :func:`expand_range_axis` — the O(n²)-row ``w_range`` matrix never
  enters a dense matvec.

Noise is ONE ``torch.randn`` over every base mechanism's Γ-column cells in
``plan.cliques`` order (:func:`repro_torch.core.mechanism.draw_noise`); each
group reads its slice.  Host traffic per group is one host-to-device copy of
its stacked marginals (measure) or subset embeddings (reconstruct) and one
device-to-host copy of its answers.

Usage::

    engine = PlusEngine(plan)                    # plan: core.plus.select_plus
    gen = torch.Generator(device="cuda").manual_seed(0)
    tables, meas = engine.release(marginals, gen)
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.domain import Clique
from repro_torch.core.kron import kron_matvec_batched, kron_out_dims
from repro_torch.core.mechanism import (_NP_DTYPES, Measurement, _group_noise,
                                        _stack_marginals, draw_noise,
                                        noise_dtype, noise_offsets)
from repro_torch.core.plus import (PlusPlan, measure_chain_split,
                                   plus_signature_groups, t_chain_factors_plus)
from repro_torch.core.reconstruct import embed_group
from repro_torch.engine.engine import ChainRegistry, EngineStats, ReleaseServing
from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.kernels.kron_matvec.fused import (apply_epilogue,
                                                   fused_chain_matvec)
from repro_torch.kernels.kron_matvec.stats import CHAIN_STATS
from repro_torch.obs import TRACER


def expand_range_axis(t: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Implicit ``w_range`` from per-axis prefix sums: rows p[b] − p[a−1].

    ``t`` carries cumulative sums along ``axis`` (the cumsum epilogue output,
    size n); n slice-subtracts expand them to all n(n+1)/2 contiguous ranges
    in ``w_range`` row order (a-major) without the dense O(n²)-row matrix.
    """
    p = torch.movedim(t, axis, -1)
    parts = [p]                                      # a = 0: p[b]
    for a in range(1, n):
        parts.append(p[..., a:] - p[..., a - 1:a])   # p[b] − p[a−1], b ≥ a
    return torch.movedim(torch.cat(parts, dim=-1), -1, axis)


class PlusEngine(ReleaseServing, ChainRegistry):
    """Plan a PlusPlan's kernel chains once; serve Alg 5/6 traffic.

    Parameters
    ----------
    plan:        ``core.plus.select_plus`` output (σ² per closure clique and
                 the per-attribute generalized bases, ``plan.schema``).
    use_kernel:  route chains through the hand-written kernels (default) or
                 the plain batched torch path.
    precompile:  on CUDA, launch every chain once at construction, epilogues
                 included, so the kernels are built and loaded before serving.
    dtype:       noise dtype; ``None`` is float32.
    device:      ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.
    """

    def __init__(self, plan: PlusPlan, use_kernel: Optional[bool] = None,
                 precompile: bool = True, dtype=None, device=None):
        self.plan = plan
        self.schema = plan.schema
        self.device = resolve_device(device)
        self.use_kernel = True if use_kernel is None else use_kernel
        self.dtype = noise_dtype() if dtype is None else dtype
        if self.dtype not in _NP_DTYPES:
            raise TypeError(f"noise dtype {self.dtype}: expected float32 or "
                            "float64")
        self.stats = EngineStats()
        self._measure_groups = plus_signature_groups(self.schema, plan.cliques)
        self._reconstruct_groups = plus_signature_groups(
            self.schema, plan.workload.cliques)
        self.stats.measure_signatures = len(self._measure_groups)
        self.stats.reconstruct_signatures = len(self._reconstruct_groups)
        self._noise_offs = noise_offsets(plan, self._noise_cells)
        self._measure_specs = {tok: self._build_measure_spec(cliques)
                               for tok, cliques in self._measure_groups.items()}
        self._reconstruct_specs = {
            tok: self._build_reconstruct_spec(cliques[0])
            for tok, cliques in self._reconstruct_groups.items() if tok}
        self._chain_plans: Dict[tuple, tuple] = {}
        for tok, cliques in self._measure_groups.items():
            dims, zdims, stage_a, stage_b = self._measure_specs[tok]["split"]
            if any(f is not None for f in stage_a):
                self._register_chain(stage_a, dims, len(cliques),
                                     role="measure")
            if any(f is not None for f in stage_b):
                self._register_chain(stage_b, zdims, 2 * len(cliques),
                                     role="measure")
        for tok, cliques in self._reconstruct_groups.items():
            if tok:
                s = self._reconstruct_specs[tok]
                self._register_chain(s["factors"], s["in_dims"], len(cliques),
                                     s["epilogue"], role="reconstruct")
        if precompile and self.use_kernel and self.device.type == "cuda":
            self._warmup()

    # ------------------------------------------------------------ group prep
    def _noise_cells(self, clique: Clique) -> int:
        """Noise values of a base mechanism: Π Γ_i column counts (1 for ())."""
        return math.prod(self.schema.bases[i].Gamma.shape[1] for i in clique)

    def _build_measure_spec(self, cliques: List[Clique]) -> dict:
        dims, zdims, stage_a, stage_b = measure_chain_split(self.schema,
                                                            cliques[0])
        return dict(split=(dims, zdims, stage_a, stage_b),
                    m=math.prod(dims), mz=math.prod(zdims),
                    offs=[self._noise_offs[c] for c in cliques],
                    sig=torch.tensor([math.sqrt(self.plan.sigma2(c))
                                      for c in cliques], dtype=self.dtype,
                                     device=self.device)[:, None])

    def _build_reconstruct_spec(self, clique: Clique) -> dict:
        """Merged-chain layout for one reconstruction signature group.

        Per axis: the chain factor (T_i, or W_i·T_i when W_i is folded in),
        the epilogue op, and the range expansion size (None unless the axis
        is a range query).
        """
        factors: List[np.ndarray] = []
        in_dims: List[int] = []
        epilogue: List[Optional[str]] = []
        posts: List[Optional[int]] = []
        for i, t_i in zip(clique, t_chain_factors_plus(self.schema, clique)):
            b = self.schema.bases[i]
            in_dims.append(t_i.shape[1])
            if b.kind in ("prefix", "range"):
                factors.append(t_i)
                epilogue.append("cumsum")
                posts.append(b.n if b.kind == "range" else None)
            else:   # identity / total / custom: fold W into the chain factor
                factors.append(b.W @ t_i)
                epilogue.append(None)
                posts.append(None)
        chain_out = tuple(kron_out_dims(factors, in_dims))
        return dict(factors=factors, in_dims=in_dims, epilogue=tuple(epilogue),
                    chain_out=chain_out, posts=posts)

    # ---------------------------------------------------------------- noise
    def _draw(self, gen: torch.Generator) -> torch.Tensor:
        return draw_noise(self.plan, gen, self.device, self.dtype,
                          self._noise_cells)

    def noise_draws(self, gen: torch.Generator) -> Dict[Clique, np.ndarray]:
        """The per-clique Gaussian draws ``measure(·, gen)`` consumes, float64.

        The same slices of the same flat draw as :meth:`measure`, so tests can
        replay them into the numpy oracle ``measure_plus_np``.
        """
        z = self._draw(gen).double().cpu().numpy()
        return {c: z[o:o + self._noise_cells(c)]
                for c, o in self._noise_offs.items()}

    # ------------------------------------------------------------------ serve
    def _chain(self, factors, x, dims, epilogue=None, allow_narrow=False):
        """One chain on the device: the kernels when ``use_kernel`` (narrow
        operands only where ``allow_narrow``, i.e. reconstruction), else
        the plain batched torch path in float32."""
        if self.use_kernel:
            return fused_chain_matvec(factors, x, dims, epilogue=epilogue,
                                      allow_narrow=allow_narrow)
        y = kron_matvec_batched(factors, x, dims)
        CHAIN_STATS.inc("epilogue_axes", sum(op is not None
                                             for op in epilogue or ()))
        return apply_epilogue(y, [f.shape[0] if f is not None else n
                                  for f, n in zip(factors, dims)], epilogue)

    def measure(self, marginals: Mapping[Clique, np.ndarray],
                gen: torch.Generator) -> Dict[Clique, Measurement]:
        """Algorithm 5 over the whole closure, signature-batched on the device.

        ``marginals[A]`` must hold the exact marginal table for every A in
        the plan's closure (flattened or tensor shaped, host arrays); ``gen``
        is a ``torch.Generator`` on the engine's device.
        """
        self.stats.bump("measure_calls")
        with TRACER.span("engine.measure").set(
                engine="plus", cliques=len(self.plan.cliques),
                use_kernel=self.use_kernel):
            return self._measure_impl(marginals, gen)

    def _measure_impl(self, marginals, gen) -> Dict[Clique, Measurement]:
        z_all = self._draw(gen)
        np_dtype = _NP_DTYPES[self.dtype]
        out: Dict[Clique, Measurement] = {}
        for tok, cliques in self._measure_groups.items():
            s = self._measure_specs[tok]
            dims, zdims, stage_a, stage_b = s["split"]
            g = len(cliques)
            x = torch.from_numpy(_stack_marginals(marginals, cliques, s["m"],
                                                  np_dtype)).to(self.device)
            if any(f is not None for f in stage_a):
                x = self._chain(stage_a, x, dims)
            x = torch.cat([x.to(self.dtype),
                           _group_noise(z_all, s["offs"], s["mz"])])
            if any(f is not None for f in stage_b):
                x = self._chain(stage_b, x, zdims)
            om = (x[:g] + s["sig"] * x[g:]).cpu().numpy()
            for i, c in enumerate(cliques):
                out[c] = Measurement(c, om[i], self.plan.sigma2(c))
        return out

    def reconstruct(self, measurements: Mapping[Clique, Measurement],
                    cliques: Optional[Sequence[Clique]] = None
                    ) -> Dict[Clique, np.ndarray]:
        """Algorithm 6 for the workload (or ``cliques``): one merged chain
        per signature group, with prefix/range W_i applied implicitly.
        Returns float32 host arrays in ``w_range``/``w_prefix`` row order."""
        self.stats.bump("reconstruct_calls")
        with TRACER.span("engine.reconstruct").set(
                engine="plus", use_kernel=self.use_kernel):
            return self._reconstruct_impl(measurements, cliques)

    def _reconstruct_impl(self, measurements, cliques=None
                          ) -> Dict[Clique, np.ndarray]:
        groups = (self._reconstruct_groups if cliques is None
                  else plus_signature_groups(self.schema, cliques))
        out: Dict[Clique, np.ndarray] = {}
        for tok, group in groups.items():
            if not tok:
                for c in group:
                    out[c] = np.asarray(measurements[()].omega,
                                        dtype=float).reshape(-1)
                continue
            s = self._reconstruct_specs.get(tok)
            if s is None:   # ad-hoc clique outside the workload's signatures
                s = self._reconstruct_specs[tok] = \
                    self._build_reconstruct_spec(group[0])
            x = torch.from_numpy(embed_group(self.plan, measurements, group,
                                             slot_dims=s["in_dims"]))
            # Reconstruction carries no noise lanes: a tuned narrow operand
            # type (float32 accumulation) may serve it.
            y = self._chain(s["factors"], x.to(self.device), s["in_dims"],
                            s["epilogue"], allow_narrow=True)
            y = y.reshape((len(group),) + s["chain_out"])
            for axis, post in enumerate(s["posts"]):
                if post is not None:
                    y = expand_range_axis(y, axis + 1, post)
            y = y.reshape(len(group), -1).cpu().numpy()
            for i, c in enumerate(group):
                out[c] = y[i]
        return out

    # release() comes from ReleaseServing.  Postprocessing operates on
    # *marginal tables*: it is available exactly when every attribute basis
    # is the identity (W_i = I, so Alg 6's answers ARE the marginals);
    # generalized range/prefix answers are not a consistent-marginal family
    # and are rejected up front.
    def _check_postprocess(self) -> None:
        bad = [i for i, b in enumerate(self.schema.bases)
               if b.kind != "identity"]
        if bad:
            raise ValueError(
                "postprocess/synthesize require identity-basis marginals; "
                f"attributes {bad} use non-identity bases "
                f"({[self.schema.bases[i].kind for i in bad]})")
