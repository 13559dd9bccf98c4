"""Declarative rule registries of the port's repro-lint: what counts as a
source, sanitizer, sink, charge, or device limit.

The passes are generic dataflow machines; everything specific to the port
lives here, so adding a rule is a registry edit, not a pass rewrite.  The
privacy vocabulary is the reference's (``repro.analysis.registry``), whose
names the port's entry points share; the kernel limits are the port's own:
the Hopper shared-memory budget of the fused kernel and the cost model's
device table, not the TPU's VMEM and tiling quanta.

Name matching is by *last dotted component* — ``self.ledger.charge`` and
``ledger.charge`` both match ``charge`` — which is the right granularity
for an intraprocedural analysis that cannot resolve imports.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional, Tuple

# Rule catalog of the port.  The reference's KN005 (a BlockSpec's minor
# dimension a multiple of the TPU's 128-lane quantum) has no counterpart:
# the CUDA kernels take their geometry from Python and mask their own
# edges (kron_axis.cu, fused_chain.cu), so no launch literal has a quantum.
ALL_RULES: Dict[str, str] = {
    "PF001": "raw-data taint reaches a release sink without a noise "
             "sanitizer on the path",
    "PF002": "measurement in a serve-scope class is not dominated by a "
             "budget-ledger charge (charge-before-measure)",
    "KN001": "literal rows= below 1 at a chain call (a fused block holds "
             "at least one row)",
    "KN002": "literal smem_budget exceeds every card's per-block shared "
             "memory in the DeviceSpec table",
    "KN003": "narrow compute dtype / allow_narrow=True on a chain inside a "
             "noise-drawing function (noise must stay float32)",
    "KN004": "host side effect (RNG, clock, I/O, env, host sync) inside a "
             "function handed to torch.compile, torch.jit.script, "
             "triton.jit or a CUDA graph capture",
    "LK001": "field annotated '# guarded-by: <lock>' accessed outside a "
             "'with self.<lock>' block",
    "LK002": "'# guarded-by:' names a lock never created in this class",
    "LINT000": "file could not be parsed",
}


@dataclass(frozen=True)
class PrivacyRegistry:
    """Source/sanitizer/sink vocabulary for the privacy-flow pass."""

    # Calls whose RESULT is raw (pre-noise) data.
    source_calls: FrozenSet[str] = frozenset({
        "exact_marginals_from_x", "sharded_marginals", "_local_marginal",
        "marginals_from_records", "synthetic_records",
    })
    # Attribute reads that yield raw data wherever they appear
    # (request payloads: ``req.marginals``).
    source_attrs: FrozenSet[str] = frozenset({"marginals"})
    # Parameters of these names are raw on entry (data-plane helpers).
    source_params: FrozenSet[str] = frozenset({"records", "marginals"})
    # Calls whose result is differentially private — taint stops here.
    sanitizer_calls: FrozenSet[str] = frozenset({
        "measure", "measure_multi", "measure_np", "measure_np_batched",
        "measure_discrete", "sharded_measure", "release",
        "corpus_marginal_release",
    })
    # Metadata projections: shape-class information, not data.
    declassifier_attrs: FrozenSet[str] = frozenset({
        "size", "shape", "ndim", "dtype", "nbytes", "itemsize",
    })
    declassifier_calls: FrozenSet[str] = frozenset({
        "len", "isinstance", "type", "id", "hash",
    })
    # Sinks: raw taint must never reach these (checked everywhere).
    sink_calls: FrozenSet[str] = frozenset({
        "set_result", "set_exception", "_append",
    })
    # Sinks only enforced inside serve-scope modules (response assembly).
    serve_sink_calls: FrozenSet[str] = frozenset({
        "dumps", "write", "sendall",
    })
    # Constructors whose fields ship to tenants.
    sink_constructors: FrozenSet[str] = frozenset({"ReleaseResult"})
    # PF002 protocol vocabulary.
    charge_calls: FrozenSet[str] = frozenset({"charge"})
    measure_calls: FrozenSet[str] = frozenset({"measure", "measure_multi"})
    serve_scope: str = "serve"


DEFAULT_PRIVACY = PrivacyRegistry()


@dataclass(frozen=True)
class KernelLimits:
    """Launch-config constants the kernel-invariant pass enforces.

    Sourced live from :mod:`repro_torch.kernels.kron_matvec.fused` (the
    operand types) and the :mod:`repro_torch.roofline.cost_model`
    DeviceSpec table (the largest per-block shared memory of a card), so
    the analyzer cannot drift from the kernels it checks; the literals
    below are only the fallback when those imports fail.
    """

    # Largest shared memory one block may use on any card in the table: a
    # literal budget above it fits no card.
    smem_limit: int = 232448
    narrow_dtypes: FrozenSet[str] = frozenset({"bfloat16", "float16"})
    chain_calls: FrozenSet[str] = frozenset({
        "plan_chain", "plan_shapes", "fused_chain_matvec", "tune_chain"})
    noise_calls: FrozenSet[str] = frozenset({
        "normal", "normal_", "standard_normal", "sample",
        "sample_discrete_gaussian", "randn", "randn_like", "draw_noise"})
    host_effect_exact: FrozenSet[str] = frozenset({
        "print", "open", "input", "breakpoint", "torch.manual_seed",
        "torch.cuda.synchronize"})
    host_effect_prefixes: Tuple[str, ...] = (
        "np.random.", "numpy.random.", "random.", "os.", "time.", "sys.")
    # Methods that copy a device value to the host (a sync inside a capture).
    host_sync_methods: FrozenSet[str] = frozenset({
        "item", "tolist", "numpy", "cpu"})


_LIMITS: Optional[KernelLimits] = None


def kernel_limits() -> KernelLimits:
    """KernelLimits bound to the live kernel/cost-model constants."""
    global _LIMITS
    if _LIMITS is not None:
        return _LIMITS
    try:
        from repro_torch.kernels.kron_matvec.fused import (_OPERANDS,
                                                           _SMEM_BUDGET)
        from repro_torch.roofline.cost_model import DEVICE_TABLE
        # The planner's default budget is a card's limit too.
        smem = max([_SMEM_BUDGET] + [spec.smem_limit for spec in
                                     DEVICE_TABLE.values() if not spec.plain])
        narrow = frozenset(name for name, (_, nbytes, _) in _OPERANDS.items()
                           if nbytes < 4)
        _LIMITS = KernelLimits(smem_limit=smem, narrow_dtypes=narrow)
    except ImportError:                    # pragma: no cover - no torch
        _LIMITS = KernelLimits()
    return _LIMITS
