from .fused import (ChainPlan, apply_epilogue, fused_cache_info,
                    fused_chain_matvec, fused_chain_matvec_plain, plan_chain)
from .kron_matvec import kron_axis_matvec, kron_axis_matvec_plain
from .ops import kron_matvec_kernel, residual_measure_kernel
from .ref import kron_matvec_ref, residual_measure_ref
from .stats import CHAIN_STATS, chain_stats, reset_chain_stats
