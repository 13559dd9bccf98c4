"""repro-lint for the port: AST/dataflow static analysis of the load-bearing
invariants of ``src/repro_torch``.

The reference's three pass families (``repro.analysis``), copied, with the
port's own registry:

* **privacy-flow** (:mod:`repro_torch.analysis.privacy`) — intraprocedural
  taint analysis from raw-data sources through Gaussian-noise sanitizers to
  release sinks, plus the charge-before-measure protocol check over the
  serving tier (``PF*`` rules);
* **kernel-invariant** (:mod:`repro_torch.analysis.kernels`) — launch-config
  literals (``rows``, ``smem_budget``) checked against the fused kernel's
  shared-memory budget and the cost model's DeviceSpec table, the
  noise-stays-fp32 ``allow_narrow`` policy, and host-effect hygiene inside
  compiled and captured bodies (``KN*`` rules);
* **lock-discipline** (:mod:`repro_torch.analysis.locks`) — ``# guarded-by:``
  annotated fields may only be touched under their lock (``LK*`` rules).

Drive it with ``python -m repro_torch.analysis [--gate]`` or
programmatically via :func:`analyze_paths` / :func:`analyze_source`.
"""
from .driver import (BASELINE, DEFAULT_ROOTS, analyze_file, analyze_paths,
                     analyze_source, iter_py_files, main)
from .findings import Baseline, Finding
from .registry import (DEFAULT_PRIVACY, ALL_RULES, KernelLimits,
                       PrivacyRegistry, kernel_limits)

__all__ = ["BASELINE", "DEFAULT_ROOTS", "analyze_file", "analyze_paths",
           "analyze_source", "iter_py_files", "main",
           "Baseline", "Finding",
           "DEFAULT_PRIVACY", "ALL_RULES", "KernelLimits",
           "PrivacyRegistry", "kernel_limits"]
