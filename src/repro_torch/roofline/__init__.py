"""The analytic cost model of the port's kernels (the autotuner scores with
it), and the LM dry run's readers: :mod:`.op_stats` counts FLOPs, bytes and
collectives of eager work on fake tensors (the counterpart of the JAX
package's HLO reader ``hlo_stats.py``), and :mod:`.analyze` scores the dry
run's records with a device row.
"""
from .analyze import analyze_all, analyze_cell, artifact_dir
from .cost_model import (DEVICE_TABLE, ChainCost, CostModel, DeviceSpec,
                         chain_bytes, chain_flops, detect_device, device_spec)

__all__ = ["analyze_all", "analyze_cell", "artifact_dir",
           "DEVICE_TABLE", "ChainCost", "CostModel", "DeviceSpec",
           "chain_bytes", "chain_flops", "detect_device", "device_spec"]
