"""KN003 fixture: narrow operands on chains inside noise-drawing functions.
Line numbers are asserted by tests/test_torch_analysis.py."""
import torch

from repro_torch.core.mechanism import draw_noise
from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec


def measure_bf16(factors, x, dims, gen):
    z = torch.randn(x.shape, generator=gen)
    y = x + z
    return fused_chain_matvec(factors, y, dims, compute_dtype="bfloat16")  # KN003


def measure_allow_narrow(plan, factors, x, dims, gen):
    z = draw_noise(plan, gen)
    y = fused_chain_matvec(factors, x, dims, allow_narrow=True)   # KN003
    return y + z


def measure_fp16_dtype(factors, x, dims, gen):
    z = torch.empty_like(x).normal_(generator=gen)
    y = x + z
    return fused_chain_matvec(factors, y, dims, compute_dtype=torch.float16)  # KN003
