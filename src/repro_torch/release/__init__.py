"""Release subsystem: postprocessing + synthesis downstream of the engines.

The port of ``repro.release``.  Three stages, all formulated on the PlanTable
IR / residual coordinates and never on the contingency table:

* :mod:`repro_torch.release.consistency` — covariance-weighted least-squares
  consistency across overlapping noisy marginals (preconditioned batched CG
  whose Kronecker chains run on the port's kernels; fp64 dense WLS oracle
  for small domains);
* :mod:`repro_torch.release.nonneg` — ReM-style local non-negativity
  (signature-batched simplex projection with exact total preservation,
  optional multiplicative-weights refinement);
* :mod:`repro_torch.release.synth` — vectorized synthetic-record sampling
  over a clique junction order, with a :class:`SynthReport` audit.

The engines reach it through ``engine.release(..., postprocess=...)`` and
``engine.synthesize(...)`` on :class:`~repro_torch.engine.engine.MarginalEngine`,
:class:`~repro_torch.engine.plus_engine.PlusEngine`, the secure
:class:`~repro_torch.engine.discrete_engine.DiscreteEngine` and the
divide-and-conquer :class:`~repro_torch.engine.composite.CompositeEngine`,
and the sharded route through
``repro_torch.engine.corpus_stats.corpus_marginal_release(...,
postprocess=...)``.  Each postprocess call is one ``release.postprocess``
trace span.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from repro_torch.core.domain import Clique
from repro_torch.core.plantable import BasePlan
from repro_torch.obs import TRACER

from .consistency import (ConsistencyOperator, ConsistentRelease,
                          dense_wls_oracle, precision_weights,
                          solve_consistency)
from .nonneg import (mw_refine, nonneg_release, project_nonneg,
                     simplex_project_batch)
from .synth import (MarginalCheck, SynthReport, junction_order, synth_report,
                    synthesize_records)

POSTPROCESS_MODES = ("consistent", "nonneg")


def measured_integer_total(measurements) -> float:
    """The secure path's total pin: the measured empty-clique answer, which
    is exact-integer by construction (integer count + integer noise), as a
    float."""
    return float(int(round(float(
        np.asarray(measurements[()].omega).reshape(-1)[0]))))


def postprocess_release(plan: BasePlan, tables: Mapping[Clique, np.ndarray],
                        mode: str, *, total: Optional[float] = None,
                        weights: Optional[np.ndarray] = None,
                        mw_rounds: int = 0, backend: str = "device",
                        tol: float = 1e-9, maxiter: int = 200,
                        device=None, use_kernel: bool = True
                        ) -> Dict[Clique, np.ndarray]:
    """One entry point for the engines' ``postprocess=`` kwarg.

    ``mode="consistent"`` returns the covariance-weighted consistent family;
    ``mode="nonneg"`` additionally projects each marginal onto its scaled
    simplex (and runs ``mw_rounds`` of MW refinement).  ``total`` pins the
    family's common total — the secure path passes the measured integer.
    ``device`` (CUDA unless ``"cpu"``) and ``use_kernel`` serve the device
    backend's CG and projection.
    """
    if mode == "consistent":
        with TRACER.span("release.postprocess").set(mode=mode,
                                                    tables=len(tables)):
            cons = solve_consistency(plan, tables, weights=weights,
                                     fix_total=total, tol=tol,
                                     maxiter=maxiter, backend=backend,
                                     device=device, use_kernel=use_kernel)
            return cons.marginals()
    if mode == "nonneg":
        with TRACER.span("release.postprocess").set(mode=mode,
                                                    tables=len(tables),
                                                    mw_rounds=mw_rounds):
            return nonneg_release(plan, tables, total=total, weights=weights,
                                  mw_rounds=mw_rounds, tol=tol,
                                  maxiter=maxiter, backend=backend,
                                  device=device, use_kernel=use_kernel)
    raise ValueError(f"postprocess mode must be one of {POSTPROCESS_MODES}, "
                     f"got {mode!r}")


__all__ = [
    "ConsistencyOperator", "ConsistentRelease", "MarginalCheck",
    "POSTPROCESS_MODES", "SynthReport", "dense_wls_oracle", "junction_order",
    "measured_integer_total", "mw_refine", "nonneg_release",
    "postprocess_release", "precision_weights", "project_nonneg",
    "simplex_project_batch", "solve_consistency", "synth_report",
    "synthesize_records",
]
