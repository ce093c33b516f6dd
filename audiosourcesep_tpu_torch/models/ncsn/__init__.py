"""NCSN score networks (v1 conditional, v2 unconditional)."""

from .refinenet import RefineNetDilated, get_score_model
from .utils import get_sigmas

__all__ = ["RefineNetDilated", "get_score_model", "get_sigmas"]
