"""Baselines of the paper; so far the p-Identity strategy optimizer of HDMM."""
from .hdmm import opt_pidentity, opt_pidentity_projected
