"""Carry a plan across from the JAX package.

A plan's state is the domain's sizes, the workload (cliques and importance
weights), the closure in its (len, lex) order and σ² over that closure.
:func:`plan_from_arrays` rebuilds the port's :class:`~repro_torch.core.Plan`
from exactly that, given as numpy arrays and tuples, so both packages can
run one plan with identical σ².  :func:`plus_plan_from_arrays` does the same
for a ResidualPlanner+ plan, given besides each attribute's basic matrix W_i
and strategy S_i.  :func:`lm_params_from_jax` and :func:`lm_caches_from_jax`
carry an LM's parameters and caches across, from the JAX package's
group-stacked trees to the port's one dict per layer group, and
:func:`train_state_from_jax` a training state (parameters and AdamW
moments).  They take plain
data, never a JAX object: the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.domain import Clique, Domain, MarginalWorkload, as_clique
from repro_torch.core.plantable import PlanTable
from repro_torch.core.plus import PlusPlan, PlusSchema, attr_basis, plan_table_plus
from repro_torch.core.select import Plan


def _workload(sizes, workload_cliques, weights) -> MarginalWorkload:
    wk_cliques = tuple(as_clique(c) for c in workload_cliques)
    w = np.asarray(weights, dtype=np.float64).reshape(-1)
    if w.shape != (len(wk_cliques),):
        raise ValueError(f"{w.shape[0]} weights for {len(wk_cliques)} cliques")
    dom = Domain.create(list(sizes))
    return MarginalWorkload(dom, wk_cliques, dict(zip(wk_cliques, w.tolist())))


def _checked_sigma(table: PlanTable, closure_cliques, sigma) -> np.ndarray:
    closure = [tuple(int(i) for i in c) for c in closure_cliques]
    if closure != table.cliques:
        raise ValueError("closure_cliques is not the workload's closure in "
                         "(len, lex) order")
    sig = np.asarray(sigma, dtype=np.float64).reshape(-1)
    if sig.shape != (table.n,):
        raise ValueError(f"sigma has {sig.shape[0]} entries, closure has {table.n}")
    return sig.copy()


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
    table = PlanTable.for_workload(_workload(sizes, workload_cliques, weights))
    sig = _checked_sigma(table, closure_cliques, sigma)
    return Plan(table, sig, "converted", pcost=table.pcost(sig),
                loss_value=float(np.dot(table.v, sig)))


def plus_plan_from_arrays(sizes: Sequence[int],
                          bases: Sequence[Tuple[np.ndarray, Optional[np.ndarray]]],
                          workload_cliques: Sequence[Sequence[int]],
                          weights: Sequence[float],
                          closure_cliques: Sequence[Sequence[int]],
                          sigma: Sequence[float],
                          objective: str = "converted") -> PlusPlan:
    """The port's PlusPlan for σ² ``sigma``, as :func:`plan_from_arrays`.

    ``bases[i]`` is attribute i's ``(W_i, S_i)``, with ``S_i=None`` where the
    strategy is W_i itself; the port rebuilds each basis with Algorithm 4
    (:func:`~repro_torch.core.plus.attr_basis`).  ``loss_value`` is the SoV
    of ``sigma``.
    """
    workload = _workload(sizes, workload_cliques, weights)
    schema = PlusSchema(workload.domain,
                        tuple(attr_basis(W, S) for W, S in bases))
    table = plan_table_plus(workload, schema)
    sig = _checked_sigma(table, closure_cliques, sigma)
    return PlusPlan(table, sig, objective, pcost=table.pcost(sig),
                    loss_value=float(np.dot(table.v, sig)), schema=schema)


def plan_arrays(plan) -> tuple:
    """The ``plan_from_arrays`` arguments of a plan of either package."""
    wk = plan.workload
    cliques: Sequence[Clique] = wk.cliques
    return (list(wk.domain.sizes), [tuple(c) for c in cliques],
            np.array([wk.weight(c) for c in cliques]),
            [tuple(c) for c in plan.cliques], np.asarray(plan.sigma))


def plus_plan_arrays(plan) -> tuple:
    """The ``plus_plan_from_arrays`` arguments of an RP+ plan of either
    package (its objective included)."""
    sizes, wk, w, cl, sig = plan_arrays(plan)
    bases = [(b.W, None if b.S is b.W else b.S) for b in plan.schema.bases]
    return sizes, bases, wk, w, cl, sig, plan.objective


def _unstack_groups(tree: dict, n_groups: dict) -> dict:
    """``tree`` with each group-stacked subtree (``blocks``, ``tail_blocks``,
    ``encoder_blocks``: every leaf led by a group axis) split into a list of
    per-group trees, every leaf a numpy array."""
    def index(t, g):
        if isinstance(t, dict):
            return {k: index(v, g) for k, v in t.items()}
        return np.asarray(t)[g]

    def arrays(t):
        if isinstance(t, dict):
            return {k: arrays(v) for k, v in t.items()}
        return np.asarray(t)

    out = {}
    for k, v in tree.items():
        if k in n_groups:
            out[k] = [index(v, g) for g in range(n_groups[k])]
        else:
            out[k] = arrays(v)
    return out


def _group_counts(cfg) -> dict:
    return {"blocks": cfg.n_pattern_groups, "tail_blocks": cfg.n_tail,
            "encoder_blocks": cfg.encoder_layers}


def lm_params_from_jax(cfg, params: dict, mesh=None) -> dict:
    """The port's parameter tree for an LM config, from the JAX package's
    ``Model.init`` pytree given as nested dicts of numpy arrays: each leaf
    of ``blocks``, ``tail_blocks`` and ``encoder_blocks`` is split along
    its leading group axis into one dict per group.  Feed the result to
    :meth:`repro_torch.models.Model.from_params`.  With ``mesh`` (every
    rank passing the same arrays) each leaf is a DTensor on the mesh's
    device type, placed by its ``PDef`` axes."""
    from repro_torch.models.transformer import model_defs
    tree = _unstack_groups(params, _group_counts(cfg))
    return tree if mesh is None else _on_mesh(tree, model_defs(cfg), mesh)


def lm_caches_from_jax(cfg, caches: dict, mesh=None) -> dict:
    """The port's cache tree from the JAX package's group-stacked caches
    (as :func:`lm_params_from_jax` does for parameters), numpy leaves; with
    ``mesh``, DTensors placed by the port's ``cache_axes``."""
    from repro_torch.models.transformer import cache_defs
    tree = _unstack_groups(caches, _group_counts(cfg))
    return tree if mesh is None else _on_mesh(tree, cache_defs(cfg, 1, 1),
                                              mesh)


def _on_mesh(tree, defs, mesh):
    """Each numpy leaf of ``tree`` as a DTensor placed by the axes of the
    matching PDef leaf of ``defs``."""
    import torch
    from repro_torch.models.layers import tree_map
    from repro_torch.models.sharding import distribute, param_spec
    return tree_map(lambda a, pd: distribute(
        torch.tensor(np.asarray(a), device=mesh.device_type),
        param_spec(mesh, pd.axes)), tree, defs)


def train_state_from_jax(cfg, state: dict) -> dict:
    """The port's training state from the JAX package's ``TrainState``
    (nested dicts of numpy arrays): ``params`` as :func:`lm_params_from_jax`
    splits them, the AdamW moments ``m`` and ``v`` (float32 leaves, or int8
    ``{"q", "s"}`` pairs) split the same way, and ``count``.  The JAX
    ``rng`` key is not carried across: the two packages draw from different
    generators, and the port seeds its own (``init_train_state``)."""
    counts = _group_counts(cfg)
    opt = state["opt"]
    return {"params": _unstack_groups(state["params"], counts),
            "opt": {"m": _unstack_groups(opt["m"], counts),
                    "v": _unstack_groups(opt["v"], counts),
                    "count": np.asarray(opt["count"])}}
