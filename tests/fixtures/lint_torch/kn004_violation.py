"""KN004 fixture: host side effects inside compiled and captured bodies.
Line numbers are asserted by tests/test_torch_analysis.py."""
import time

import numpy as np
import torch
import triton


@torch.compile
def compiled_with_clock(x):
    t0 = time.perf_counter()                                      # KN004
    return x * 2.0, t0


@torch.compile(mode="reduce-overhead")
def compiled_with_sync(x):
    return x * float(x.sum().item())                              # KN004


def scripted_body(x):
    print("debug")                                                # KN004
    return x + 1


scripted = torch.jit.script(scripted_body)


@triton.jit
def kernel_with_host_rng(x_ptr):
    seed = np.random.randint(10)                                  # KN004
    return x_ptr + seed


def capture(graph, static_x):
    with torch.cuda.graph(graph):
        y = static_x * 2.0
        torch.cuda.synchronize()                                  # KN004
    return y
