"""KN001 fixture: literal rows below 1 at chain calls (a fused block holds
at least one batch row).  Line numbers are asserted by
tests/test_torch_analysis.py."""
from repro_torch.kernels.kron_matvec.fused import (fused_chain_matvec,
                                                   plan_chain, plan_shapes)


def plan_empty_block(factors, dims):
    return plan_chain(factors, dims, batch=8, rows=0)            # KN001


def launch_negative_rows(factors, x, dims):
    return fused_chain_matvec(factors, x, dims, rows=-1)          # KN001


def plan_from_shapes(fshapes, dims):
    return plan_shapes(fshapes, dims, batch=4, rows=2 - 4)        # KN001
