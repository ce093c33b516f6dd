"""Models of the port: NCSN score networks (``models.ncsn``) and Glow."""

from .flow_builder import build_glow
from .glow import (GlowMultiScale, glow_block, glow_step,
                   make_conv_net_factory)

__all__ = ["build_glow", "GlowMultiScale", "glow_block", "glow_step",
           "make_conv_net_factory"]
