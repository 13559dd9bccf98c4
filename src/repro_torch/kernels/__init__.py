"""Hand-written CUDA kernels (Hopper, sm_90a) and their plain PyTorch versions."""
