"""Carry a plan across from the JAX package.

A plan's state is the domain's sizes, the workload (cliques and importance
weights), the closure in its (len, lex) order and σ² over that closure.
:func:`plan_from_arrays` rebuilds the port's :class:`~repro_torch.core.Plan`
from exactly that, given as numpy arrays and tuples, so both packages can
run one plan with identical σ².  It takes plain data, never a JAX object:
the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.domain import Clique, Domain, MarginalWorkload, as_clique
from repro_torch.core.plantable import PlanTable
from repro_torch.core.select import Plan


def plan_from_arrays(sizes: Sequence[int],
                     workload_cliques: Sequence[Sequence[int]],
                     weights: Sequence[float],
                     closure_cliques: Sequence[Sequence[int]],
                     sigma: Sequence[float]) -> Plan:
    """The port's Plan for σ² ``sigma`` over ``closure_cliques``.

    ``weights`` are the importance weights of ``workload_cliques``, in that
    order.  Raises if ``closure_cliques`` is not the closure of the workload
    in the planner's order, or if ``sigma`` does not match it.
    """
    wk_cliques = tuple(as_clique(c) for c in workload_cliques)
    w = np.asarray(weights, dtype=np.float64).reshape(-1)
    if w.shape != (len(wk_cliques),):
        raise ValueError(f"{w.shape[0]} weights for {len(wk_cliques)} cliques")
    dom = Domain.create(list(sizes))
    workload = MarginalWorkload(dom, wk_cliques, dict(zip(wk_cliques, w.tolist())))
    table = PlanTable.for_workload(workload)
    closure = [tuple(int(i) for i in c) for c in closure_cliques]
    if closure != table.cliques:
        raise ValueError("closure_cliques is not the workload's closure in "
                         "(len, lex) order")
    sig = np.asarray(sigma, dtype=np.float64).reshape(-1)
    if sig.shape != (table.n,):
        raise ValueError(f"sigma has {sig.shape[0]} entries, closure has {table.n}")
    return Plan(table, sig.copy(), "converted", pcost=table.pcost(sig),
                loss_value=float(np.dot(table.v, sig)))


def plan_arrays(plan) -> tuple:
    """The ``plan_from_arrays`` arguments of a plan of either package."""
    wk = plan.workload
    cliques: Sequence[Clique] = wk.cliques
    return (list(wk.domain.sizes), [tuple(c) for c in cliques],
            np.array([wk.weight(c) for c in cliques]),
            [tuple(c) for c in plan.cliques], np.asarray(plan.sigma))
