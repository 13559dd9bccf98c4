"""KN001 clean fixture: literal rows of at least 1, or computed ones.

Must produce ZERO findings (tests/test_torch_analysis.py asserts emptiness).
"""
from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec, plan_chain


def plan_one_row(factors, dims):
    return plan_chain(factors, dims, batch=8, rows=1)


def launch_tuned_rows(factors, x, dims, cfg):
    return fused_chain_matvec(factors, x, dims, rows=cfg.rows)
