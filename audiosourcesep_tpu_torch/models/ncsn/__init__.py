"""NCSN score networks (v1 conditional, v2 unconditional)."""

from .refinenet import RefineNetDilated, get_score_model
from .utils import anneal_langevin_dynamics, dsm_loss, get_sigmas

__all__ = ["RefineNetDilated", "get_score_model", "anneal_langevin_dynamics",
           "dsm_loss", "get_sigmas"]
