"""Baselines the paper compares against: HDMM templates and the SVD lower bound."""
from .hdmm import (HdmmKron, HdmmUnion, hdmm_marginals, hdmm_generalized,
                   opt_pidentity, opt_pidentity_projected)
from .svdb import svd_bound_marginals, svd_bound_dense

__all__ = [n for n in dir() if not n.startswith("_")]
