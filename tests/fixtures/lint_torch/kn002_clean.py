"""KN002 clean fixture: budgets within a Hopper block, and the per-axis
route forced by a zero budget.

Must produce ZERO findings (tests/test_torch_analysis.py asserts emptiness).
"""
from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec, plan_chain


def plan_full_block(factors, dims):
    return plan_chain(factors, dims, smem_budget=227 * 1024)


def force_per_axis(factors, x, dims):
    return fused_chain_matvec(factors, x, dims, smem_budget=0)
