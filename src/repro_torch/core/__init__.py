"""ResidualPlanner core in PyTorch: domain, planner IR, select, measure, reconstruct."""
from .domain import (Attribute, Clique, Domain, MarginalWorkload, all_kway,
                     as_clique, closure, subsets)
from .residual import (axis_coeff_vectors, p_coeff, sub_gram, sub_matrix,
                       sub_pinv, variance_coeff)
from .plantable import BasePlan, PlanTable, SigmaView, plan_table, sov_closed_form
from .select import (Plan, select, select_convex, select_max_variance,
                     select_sum_of_variances)
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

__all__ = [n for n in dir() if not n.startswith("_")]
