"""ResidualPlanner core in PyTorch: domain, planner IR, select, measure, reconstruct."""
from .domain import (Attribute, Clique, Domain, MarginalWorkload, all_kway,
                     as_clique, closure, subsets)
from .residual import (axis_coeff_vectors, expand_marginal, expand_residual,
                       marginal_factors, p_coeff, residual_factors, sub_gram,
                       sub_matrix, sub_pinv, variance_coeff)
from .plantable import BasePlan, PlanTable, SigmaView, plan_table, sov_closed_form
from .select import (Plan, select, select_convex, select_max_variance,
                     select_sum_of_variances, select_utility_constrained)
from .partition import (DEFAULT_MAX_BLOCK, Decomposition, Partition,
                        decompose, interaction_weights, partition_attributes)
from .composite import (CompositePlan, allocate_budget,
                        compare_with_monolithic, select_dnc)
from .mechanism import (Measurement, draw_noise, exact_marginals_from_x,
                        measure, measure_np, measure_np_batched,
                        noise_offsets, pcost_of_plan, residual_answer,
                        signature_groups)
from .reconstruct import (cross_marginal_covariance_dense, embed_group,
                          embed_subset_answers, marginal_covariance_dense,
                          marginal_variance, reconstruct_all,
                          reconstruct_all_batched, reconstruct_marginal,
                          reconstruct_marginal_fast, subset_slot_region,
                          u_chain_factors)

from .accountant import (BudgetExhausted, PrivacyBudget, approx_dp_delta,
                         approx_dp_eps, gdp_mu, pcost_for_eps_delta,
                         pcost_for_mu, pcost_for_rho, zcdp_rho)
from . import dgauss
from .discrete import (DiscreteMeasurement, clique_gamma2,
                       discrete_pcost_of_plan, discrete_zcdp_rho,
                       measure_discrete, naive_discrete_rho, rationalize_sigma)

__all__ = [n for n in dir() if not n.startswith("_")]
