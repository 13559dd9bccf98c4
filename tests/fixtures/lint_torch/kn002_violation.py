"""KN002 fixture: literal shared-memory budgets above every card's block
limit (232,448 bytes on an H100).  Line numbers are asserted by
tests/test_torch_analysis.py."""
from repro_torch.kernels.kron_matvec.fused import (fused_chain_matvec,
                                                   plan_shapes)


def plan_too_big(fshapes, dims):
    return plan_shapes(fshapes, dims, smem_budget=256 * 1024)     # KN002


def launch_too_big(factors, x, dims):
    return fused_chain_matvec(factors, x, dims,
                              smem_budget=228 * 1024 + 1)         # KN002
