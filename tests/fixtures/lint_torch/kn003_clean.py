"""KN003 clean fixture: noise chains at float32; narrow operands only where
no noise is drawn.

Must produce ZERO findings (tests/test_torch_analysis.py asserts emptiness).
"""
import torch

from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec


def measure_fp32(factors, x, dims, gen):
    z = torch.randn(x.shape, generator=gen)
    return fused_chain_matvec(factors, x + z, dims, compute_dtype="float32",
                              allow_narrow=False)


def reconstruct_narrow(factors, y, dims):
    # a narrow chain is fine here: this function draws no noise
    return fused_chain_matvec(factors, y, dims, allow_narrow=True)
