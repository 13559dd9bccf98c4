"""Privacy accounting: pcost → ρ-zCDP / (ε,δ)-approximate DP / μ-GDP (Def. 2).

The privacy cost of a linear Gaussian mechanism is the largest diagonal of
``Bᵀ Σ⁻¹ B``; the paper's Definition 2 converts it to the three DP flavours.
The port's own copy of ``repro.core.accountant`` (pure math, unchanged):
importing that module would run ``repro/core/__init__.py``, which imports
jax.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


def _phi(x: float) -> float:
    """Standard normal CDF."""
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def _log_phi(x: float) -> float:
    """log Φ(x), finite for arbitrarily negative x.

    ``erfc`` underflows to 0 near x ≈ -37.5; below that the standard
    asymptotic Φ(x) ≈ φ(x)/(-x) takes over (relative error < 1/x² there).
    """
    if x > -37.0:
        return math.log(0.5 * math.erfc(-x / math.sqrt(2.0)))
    return -0.5 * x * x - math.log(-x) - 0.5 * math.log(2.0 * math.pi)


def zcdp_rho(pcost: float) -> float:
    return pcost / 2.0


def gdp_mu(pcost: float) -> float:
    return math.sqrt(pcost)


def approx_dp_delta(pcost: float, eps: float) -> float:
    """δ as a function of ε for a mechanism with the given pcost (Def. 2, [5]).

    The ``exp(ε)·Φ(·)`` term is evaluated in log space — the naive product is
    ``inf · 0 = nan`` for ε ≳ 709 — and the result is clamped to [0, 1]:
    the two Φ terms cancel catastrophically at large pcost/ε and used to
    return small negative δ.
    """
    if pcost <= 0:
        return 0.0
    r = math.sqrt(pcost)
    # term2 = exp(eps)·Φ(-r/2 - eps/r) ≤ δ's first term ≤ 1 mathematically;
    # the exponent cap only guards float round-up at the boundary.
    term2 = math.exp(min(eps + _log_phi(-r / 2.0 - eps / r), 1.0))
    delta = _phi(r / 2.0 - eps / r) - term2
    return min(1.0, max(0.0, delta))


def approx_dp_eps(pcost: float, delta: float, hi: float = 200.0) -> float:
    """Invert δ(ε) by bisection (δ is decreasing in ε)."""
    if pcost <= 0:
        return 0.0
    lo = 0.0
    if approx_dp_delta(pcost, lo) <= delta:
        return 0.0
    for _ in range(200):
        mid = (lo + hi) / 2.0
        if approx_dp_delta(pcost, mid) > delta:
            lo = mid
        else:
            hi = mid
    return hi


def pcost_for_rho(rho: float) -> float:
    return 2.0 * rho


def pcost_for_mu(mu: float) -> float:
    return mu * mu


def pcost_for_eps_delta(eps: float, delta: float, hi_cap: float = 1e12) -> float:
    """Largest pcost whose (ε,δ) curve passes under the target (bisection).

    Contract: ``delta`` must lie strictly inside (0, 1) and ``eps`` must be
    non-negative; a target the δ(pcost) curve cannot reach below ``hi_cap``
    raises ``ValueError`` (the historical version broke out of the doubling
    loop silently and bisected against an unreachable target, returning an
    arbitrary interior point).
    """
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    if eps < 0.0:
        raise ValueError(f"eps must be >= 0, got {eps}")
    lo, hi = 0.0, 1.0
    while approx_dp_delta(hi, eps) < delta:
        hi *= 2.0
        if hi > hi_cap:
            raise ValueError(
                f"(eps={eps}, delta={delta}) unreachable: delta({hi_cap:g}, "
                f"eps) = {approx_dp_delta(hi_cap, eps):g} < delta")
    for _ in range(200):
        mid = (lo + hi) / 2.0
        if approx_dp_delta(mid, eps) < delta:
            lo = mid
        else:
            hi = mid
    return lo


class BudgetExhausted(ValueError):
    """A charge would exceed the remaining privacy budget.

    Subclasses ``ValueError`` for backward compatibility with callers that
    catch the historical exception.  Carries the exact remaining budget in
    both pcost and ρ-zCDP units so serving layers (the ledger, the release
    server) can surface an actionable rejection without re-deriving it.
    """

    def __init__(self, requested_pcost: float, remaining_pcost: float,
                 tenant: str = ""):
        self.requested_pcost = float(requested_pcost)
        self.remaining_pcost = float(remaining_pcost)
        self.tenant = tenant
        who = f" for tenant {tenant!r}" if tenant else ""
        super().__init__(
            f"privacy budget exhausted{who}: need pcost={self.requested_pcost:.12g} "
            f"(rho={self.requested_rho:.12g}), have pcost={self.remaining_pcost:.12g} "
            f"(rho={self.remaining_rho:.12g})")

    @property
    def requested_rho(self) -> float:
        return zcdp_rho(self.requested_pcost)

    @property
    def remaining_rho(self) -> float:
        return zcdp_rho(self.remaining_pcost)


@dataclass
class PrivacyBudget:
    """A total pcost budget with sequential-composition tracking."""

    total_pcost: float
    spent: float = 0.0

    @staticmethod
    def from_zcdp(rho: float) -> "PrivacyBudget":
        return PrivacyBudget(pcost_for_rho(rho))

    @staticmethod
    def from_gdp(mu: float) -> "PrivacyBudget":
        return PrivacyBudget(pcost_for_mu(mu))

    @staticmethod
    def from_approx_dp(eps: float, delta: float) -> "PrivacyBudget":
        return PrivacyBudget(pcost_for_eps_delta(eps, delta))

    @property
    def remaining(self) -> float:
        return max(0.0, self.total_pcost - self.spent)

    @property
    def remaining_rho(self) -> float:
        return zcdp_rho(self.remaining)

    def can_charge(self, pcost: float) -> bool:
        return pcost <= self.remaining + 1e-12

    def charge(self, pcost: float, tenant: str = "") -> None:
        if not self.can_charge(pcost):
            raise BudgetExhausted(pcost, self.remaining, tenant)
        self.spent += pcost

    def report(self) -> dict:
        return {
            "pcost_total": self.total_pcost,
            "pcost_spent": self.spent,
            "rho_zcdp": zcdp_rho(self.spent),
            "mu_gdp": gdp_mu(self.spent),
            "eps_at_delta_1e-6": approx_dp_eps(self.spent, 1e-6) if self.spent else 0.0,
        }
