"""The analytic cost model of the port's kernels (the autotuner scores with it).

The JAX package's HLO readers (``roofline/analyze.py``, ``hlo_stats.py``) are
not ported here: they read the XLA HLO of the LM plane's dry runs, so they
come with that plane (ROADMAP queue 1, item 15).
"""
from .cost_model import (DEVICE_TABLE, ChainCost, CostModel, DeviceSpec,
                         chain_bytes, chain_flops, detect_device, device_spec)

__all__ = ["DEVICE_TABLE", "ChainCost", "CostModel", "DeviceSpec",
           "chain_bytes", "chain_flops", "detect_device", "device_spec"]
