"""NCSN score networks (v1 conditional, v2 unconditional) and their
RefineNet layers."""

from .layers import (CRPBlock, ConditionalInstanceNorm2dPlus,
                     InstanceNorm2dPlus, MSFBlock, RCUBlock, RefineBlock,
                     ResidualBlock)
from .refinenet import RefineNetDilated, get_score_model
from .utils import anneal_langevin_dynamics, dsm_loss, get_sigmas

__all__ = ["RefineNetDilated", "get_score_model", "anneal_langevin_dynamics",
           "dsm_loss", "get_sigmas", "InstanceNorm2dPlus",
           "ConditionalInstanceNorm2dPlus", "ResidualBlock", "CRPBlock",
           "RCUBlock", "MSFBlock", "RefineBlock"]
