"""Paper-plane config: Synth-n^d generalized-marginal (range/prefix) workloads
(paper §9) for ResidualPlanner+.

Usage:
    from repro_torch.configs.synth_ranges import make
    domain, workload, schema = make(n=10, d=20, kind="range")
"""
from repro_torch.core import all_kway
from repro_torch.core.plus import PlusSchema
from repro_torch.data.tabular import synth_domain


def make(n: int = 10, d: int = 20, kmax: int = 3, kind: str = "range",
         strategy_mode: str = "hier", device=None):
    """All ≤kmax-way ``kind`` queries on Synth-n^d; ``device`` as in
    :meth:`PlusSchema.create` (CUDA unless ``device="cpu"``)."""
    domain = synth_domain(n, d, kind="numeric")
    wk = all_kway(domain, min(kmax, d), include_lower=True)
    schema = PlusSchema.create(domain, [kind] * d, strategy_mode=strategy_mode,
                               device=device)
    return domain, wk, schema
