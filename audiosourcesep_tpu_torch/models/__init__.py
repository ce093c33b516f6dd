"""Models of the port: NCSN score networks (``models.ncsn``), Glow,
RealNVP and Flow++."""

from .flow_builder import build_glow, build_realnvp
from .flowpp import (FlowppBlock, FlowppCifar10, FlowppCouplingLayer,
                     VariationalDequant, build_flowpp)
from .glow import (GlowMultiScale, glow_block, glow_step,
                   make_conv_net_factory)
from .realnvp import RealNVP

__all__ = ["build_glow", "build_realnvp", "build_flowpp", "GlowMultiScale",
           "glow_block", "glow_step", "make_conv_net_factory", "RealNVP",
           "FlowppCouplingLayer", "FlowppBlock", "FlowppCifar10",
           "VariationalDequant"]
