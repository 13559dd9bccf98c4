"""DP release of corpus statistics through ResidualPlanner.

The port of ``repro.engine.corpus_stats``: document-level attributes of a
training corpus (source, language bucket, length bucket, quality bucket, …)
form a tabular domain; curators get unbiased noisy marginals over it with
the optimal mechanism and exact variances, and the privacy budget is shared
with the rest of the pipeline through the common accountant.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.accountant import PrivacyBudget
from repro_torch.core.domain import Domain, MarginalWorkload
from repro_torch.core.mechanism import pcost_of_plan
from repro_torch.core.select import select
from repro_torch.release import measured_integer_total, postprocess_release

from .sharded import _engine_for, sharded_measure

_SOV = ("sum_of_variances", "sov", "rmse")


def corpus_marginal_release(domain: Domain, workload: MarginalWorkload,
                            records, budget: PrivacyBudget, pcost: float, gen,
                            objective: str = "sum_of_variances",
                            group=None, secure: bool = False,
                            digits: int = 4,
                            postprocess: Optional[str] = None,
                            mw_rounds: int = 0,
                            device=None) -> Tuple[Dict, Dict, Dict]:
    """Select → (sharded) measure → reconstruct; charges the shared budget.

    ``records`` is this rank's shard and ``group`` the ``torch.distributed``
    process group over the shards (None: one process), as in
    :func:`~repro_torch.engine.sharded.sharded_measure`; ``gen`` is the
    generator the engine's ``measure`` takes.  The tables come from the
    plan's engine on ``device`` (CUDA unless ``device="cpu"``), the chains
    on the kernels: the JAX package reconstructs here with its per-clique
    float64 host oracle, so the two agree to float32, not bit for bit.

    ``secure=True`` releases through the numerically secure path (Alg 3,
    :class:`~repro_torch.engine.discrete_engine.DiscreteEngine`): integer
    queries plus exact discrete Gaussian noise at the rationalized σ̄ ≥ σ,
    the budget charged the *exact* discrete pcost 2·Σ_A ρ_A
    (:func:`repro_torch.core.discrete.discrete_pcost_of_plan` — never more
    than the continuous ``pcost_of_plan``, Thm 6).

    ``postprocess`` is the sharded passthrough into the release subsystem:
    ``"consistent"`` / ``"nonneg"`` run the covariance-weighted
    postprocessor on the reconstructed tables — pure post-processing, so
    the privacy charge is unchanged; the secure path pins the family total
    to the measured integer.

    Returns (noisy marginal tables, per-marginal variances, privacy report).
    """
    kw = {} if objective in _SOV else {"device": device}
    plan = select(workload, pcost_budget=pcost, objective=objective, **kw)
    if secure:
        from repro_torch.core.discrete import discrete_pcost_of_plan
        budget.charge(discrete_pcost_of_plan(plan, digits))
    else:
        budget.charge(pcost_of_plan(plan))
    meas = sharded_measure(plan, records, gen, group, secure=secure,
                           digits=digits, device=device)
    eng = _engine_for(plan, None, None, secure, digits, device)
    tables = eng.reconstruct(meas)
    if postprocess is not None:
        total = measured_integer_total(meas) if secure else None
        tables = postprocess_release(plan, tables, postprocess, total=total,
                                     mw_rounds=mw_rounds, device=eng.device,
                                     use_kernel=eng.use_kernel)
    return tables, plan.workload_variances(), budget.report()
