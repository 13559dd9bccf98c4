"""KN004 clean fixture: compiled and captured bodies with device work only;
host calls outside them.

Must produce ZERO findings (tests/test_torch_analysis.py asserts emptiness).
"""
import time

import torch
import triton
import triton.language as tl


@torch.compile
def compiled_pure(x):
    return torch.tanh(x) * 2.0


@triton.jit
def kernel_pure(x_ptr, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    x = tl.load(x_ptr + offs, mask=offs < n)
    tl.store(x_ptr + offs, x * 2.0, mask=offs < n)


def timed_capture(graph, static_x):
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        y = static_x * 2.0
    torch.cuda.synchronize()
    return y, time.perf_counter() - t0
