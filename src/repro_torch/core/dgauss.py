r"""Batched exact discrete Gaussian sampling (CKS'20) over integer lanes.

The secure release path (Section 5 / Algorithm 3, :mod:`repro_torch.core.discrete`)
adds exact discrete Gaussian noise ``N_Z(0, γ²)`` with γ² = σ̄²·Π n_i² — a
*rational* variance whose numerator routinely exceeds both float64 range and
int64 range on large cliques.  The seed-era sampler drew one value at a time
through a recursive ``fractions.Fraction`` implementation; this module is the
same CKS'20 rejection scheme (dLaplace proposal + Bernoulli-exp acceptance)
re-expressed as **vectorized rejection rounds over numpy integer lanes**:

* all probabilities are exact rationals ``num/den`` held as integer arrays —
  no floating point ever touches the noise path;
* uniform integers below a bound come from pooled numpy draws:
  ``Generator.integers`` (Lemire, unbiased) while the bound fits int64, and a
  mask-and-reject composition of 32-bit words on an object-dtype (Python
  big-int) array beyond that — the **automatic big-int fallback** that makes
  γ² at Πn_i ~ 10²⁰ scale (γ² ≳ 10⁴⁰) work instead of overflowing;
* each CKS subroutine (Bernoulli(p), Bernoulli(exp(-γ)), discrete Laplace,
  the final accept/reject) runs as a while-any-lane-active loop whose rounds
  shrink geometrically, so the expected number of numpy calls is
  O(log lanes + 1) regardless of ``size``.

The distribution is *identical* to the serial sampler's (both are exact);
only the consumption order of the underlying randomness differs, so the two
paths are seed-deterministic individually but not bit-aligned with each
other.  ``sample`` is the single entry point; ``measure_discrete`` and the
:class:`~repro_torch.engine.discrete_engine.DiscreteEngine` both draw through it.

The port's own copy of ``repro.core.dgauss``, unchanged: host numpy by
design (the exactness of the noise is the privacy proof, and the noise never
goes to the device), so the same ``np.random.Generator`` state gives the
same integers in both packages.
"""
from __future__ import annotations

import math
import numbers
import random
from fractions import Fraction
from typing import Tuple, Union

import numpy as np

# Bounds strictly below 2**62 stay on the int64 lane path; beyond it every
# uniform is composed from 32-bit words on an object-dtype array.
_INT62 = 1 << 62
_WORD = 32


def as_integer_ratio(sigma2: Union[int, Fraction]) -> Tuple[int, int]:
    """Exact ``(numerator, denominator)`` of a positive variance.

    Floats are rejected: a float γ² silently changes the sampled distribution
    (the privacy proof needs the *exact* rational), and overflowing γ² is the
    very bug this module fixes.
    """
    if isinstance(sigma2, float) or not isinstance(sigma2, numbers.Rational):
        raise TypeError(
            f"sigma2 must be an exact int or Fraction, got {type(sigma2).__name__}")
    a, b = int(sigma2.numerator), int(sigma2.denominator)
    if a <= 0 or b <= 0:
        raise ValueError(f"sigma2 must be positive, got {sigma2}")
    return a, b


def _uniform_below(bound: int, size: int, rng: np.random.Generator) -> np.ndarray:
    """``size`` exact uniform integers in [0, bound), vectorized.

    int64 lanes while the bound allows; otherwise big-int lanes built from
    pooled 32-bit words with top-word masking + rejection (≤ 2 expected
    rounds).  Both paths are unbiased.
    """
    if bound <= 0:
        raise ValueError(f"bound must be positive, got {bound}")
    if bound <= _INT62:
        return rng.integers(0, bound, size=size, dtype=np.int64)
    bits = bound.bit_length()
    nwords = -(-bits // _WORD)
    top_mask = (1 << (bits - _WORD * (nwords - 1))) - 1
    out = np.empty(size, dtype=object)
    pending = np.arange(size)
    while pending.size:
        words = rng.integers(0, 1 << _WORD, size=(pending.size, nwords),
                             dtype=np.int64)
        words[:, 0] &= top_mask
        val = words[:, 0].astype(object)
        for j in range(1, nwords):
            val = val * (1 << _WORD) + words[:, j]
        ok = val < bound
        out[pending[ok]] = val[ok]
        pending = pending[~ok]
    return out


def _bernoulli(num: np.ndarray, den: int, rng: np.random.Generator) -> np.ndarray:
    """Exact per-lane Bernoulli(num_i/den) (shared denominator)."""
    u = _uniform_below(den, len(num), rng)
    return np.asarray(u < num, dtype=bool)


def _bernoulli_exp_frac(num: np.ndarray, den: int,
                        rng: np.random.Generator) -> np.ndarray:
    """Per-lane Bernoulli(exp(-num_i/den)) for 0 ≤ num_i ≤ den (CKS Alg 1).

    The serial algorithm draws Bernoulli(γ/k) for k = 1, 2, … until the first
    failure and returns "k is odd"; here every round serves all still-active
    lanes with one pooled draw.  Active lanes halve at least geometrically
    (the continue probability at round k is γ/k ≤ 1/k), so rounds are few.
    """
    n = len(num)
    result = np.zeros(n, dtype=bool)
    active = np.arange(n)
    num = np.asarray(num)
    k = 1
    while active.size:
        a = _bernoulli(num[active], den * k, rng)
        result[active[~a]] = (k % 2 == 1)
        active = active[a]
        k += 1
    return result


def _bernoulli_exp1(size: int, rng: np.random.Generator) -> np.ndarray:
    """Bernoulli(exp(-1)) lanes — the γ = 1 boundary case of Alg 1."""
    return _bernoulli_exp_frac(np.ones(size, dtype=np.int64), 1, rng)


def _bernoulli_exp(num: np.ndarray, den: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Per-lane Bernoulli(exp(-num_i/den)) for arbitrary num_i ≥ 0.

    Integer part: lane i must survive ⌊num_i/den⌋ independent
    Bernoulli(exp(-1)) draws — run as rounds over the lanes still alive and
    still owing draws (each dies with probability 1-1/e per round, so the
    loop ends long before pathological ⌊γ⌋ values are exhausted).
    Fractional part: one Alg-1 call on the survivors.
    """
    num = np.asarray(num)
    q = num // den
    r = num - q * den
    alive = np.ones(len(num), dtype=bool)
    rounds = 0
    while True:
        idx = np.flatnonzero(alive & (q > rounds))
        if not idx.size:
            break
        a = _bernoulli_exp1(idx.size, rng)
        alive[idx[~a]] = False
        rounds += 1
    idx = np.flatnonzero(alive & (r > 0))
    if idx.size:
        a = _bernoulli_exp_frac(r[idx], den, rng)
        alive[idx[~a]] = False
    return alive


def _sample_dlaplace(t: int, size: int, rng: np.random.Generator) -> np.ndarray:
    """Vectorized exact discrete Laplace, P(x) ∝ exp(-|x|/t) (CKS Alg 2).

    Returns int64 lanes when every magnitude provably fits, object lanes
    otherwise (t beyond ~2⁴⁰ — magnitudes are u + t·v with v geometric).
    """
    small = t < (1 << 40)
    out = np.empty(size, dtype=np.int64 if small else object)
    filled = 0
    while filled < size:
        # Candidates are iid, so surplus accepted values can be discarded and
        # shortfalls refilled: oversampling (~1/0.6 acceptance) collapses the
        # shrinking-lane tail into ~1-2 full-width rounds of numpy calls.
        m = size - filled + (size - filled) // 2 + 16
        u = _uniform_below(t, m, rng)
        ok = _bernoulli_exp_frac(u, t, rng)
        v = np.zeros(m, dtype=np.int64)
        act = np.flatnonzero(ok)
        while act.size:                       # geometric run of exp(-1) successes
            a = _bernoulli_exp1(act.size, rng)
            v[act[a]] += 1
            act = act[a]
        if small:
            x = u + t * v
        else:
            x = u.astype(object) + t * v.astype(object)
        neg = rng.integers(0, 2, size=m, dtype=np.int64).astype(bool)
        good = ok & ~(neg & (x == 0))         # resample "-0"
        x = np.where(good & neg, -x, x)       # object arrays negate elementwise
        vals = x[good]
        k = min(len(vals), size - filled)
        out[filled:filled + k] = vals[:k]
        filled += k
    return out


def as_np_rng(rng) -> np.random.Generator:
    """Normalize a randomness source to ``np.random.Generator``.

    ``random.Random`` seeds a Generator from its stream (deterministic given
    the Random's state); a Generator passes through.  ``torch.Generator``
    sources are handled by the engine layer, which owns that convention.
    """
    if isinstance(rng, np.random.Generator):
        return rng
    if isinstance(rng, random.Random):
        return np.random.default_rng(rng.getrandbits(128))
    raise TypeError(f"expected np.random.Generator or random.Random, "
                    f"got {type(rng).__name__}")


def sample(sigma2: Union[int, Fraction], size: int, rng) -> np.ndarray:
    """``size`` exact draws from N_Z(0, σ²): P(x) ∝ exp(-x²/2σ²) (CKS Alg 3).

    The single batched entry point of the secure noise path.  σ² is an exact
    int/Fraction (floats are rejected); ``rng`` is an ``np.random.Generator``
    (or ``random.Random``, from which a Generator is seeded).  Candidates come
    from the vectorized discrete Laplace at scale t = ⌊√σ²⌋+1 and are accepted
    with probability exp(-(|y| - σ²/t)²/(2σ²)); with σ² = a/b the acceptance
    odds are the exact rational

        (|y|·b·t - a)² / (2·a·b·t²)

    evaluated per lane in integer arithmetic (object dtype for the numerator:
    its square exceeds int64 even at modest γ²).  Returns int64 when every
    accepted value fits, object (Python big-int) lanes otherwise.
    """
    a, b = as_integer_ratio(sigma2)
    if size < 0:
        raise ValueError(f"size must be >= 0, got {size}")
    rng = as_np_rng(rng)
    if size == 0:
        return np.empty(0, dtype=np.int64)
    t = math.isqrt(a // b) + 1
    bt = b * t
    den = 2 * a * b * t * t
    out = np.empty(size, dtype=object)
    filled = 0
    while filled < size:
        # Oversample for the ~e^{-1/2} Alg-3 acceptance rate; candidates are
        # iid so surplus accepts are dropped and shortfalls refilled.
        m = 2 * (size - filled) + 16
        y = _sample_dlaplace(t, m, rng)
        num = (np.abs(y).astype(object) * bt - a) ** 2
        acc = _bernoulli_exp(num, den, rng)
        vals = y[acc]
        k = min(len(vals), size - filled)
        out[filled:filled + k] = vals[:k]
        filled += k
    if t < (1 << 40):                         # dLaplace lanes were int64 already
        return out.astype(np.int64)
    if max(abs(int(v)) for v in out) < _INT62:
        return out.astype(np.int64)
    return out
