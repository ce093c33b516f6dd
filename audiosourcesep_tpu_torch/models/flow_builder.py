"""Flow builders (port of ``audiosourcesep_tpu/models/flow_builder.py``).

Each builds the flow and its prior into a :class:`FlowModel`; with a
``minibatch`` it also initialises it (data-dependent ActNorm from the
minibatch, the rest from ``generator``), as the JAX builders do, and
without one leaves it uninitialised (``device="meta"`` builds a template
to load a checkpoint into).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..bijectors import (Chain, FlowModel, ImgPreprocessing,
                         IsotropicNormalPrior, LearnableDiagNormalPrior,
                         SpecPreprocessing)
from .glow import GlowMultiScale, make_conv_net_factory
from .realnvp import RealNVP


def _prior(base_shape, learntop: bool, device=None):
    return (LearnableDiagNormalPrior(base_shape, device=device) if learntop
            else IsotropicNormalPrior(base_shape))


def build_glow(data_shape: Sequence[int], L: int = 3, K: int = 32,
               n_filters: int = 512, learntop: bool = True,
               data_type: str = "image", use_logit: bool = False,
               alpha: float = 1e-6, minval: float = -100.0,
               maxval: float = 20.0,
               minibatch: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               device=None) -> FlowModel:
    """Glow with an L-level multi-scale bijector.

    ``data_type='image'`` uses dequantising :class:`ImgPreprocessing`;
    anything else :class:`SpecPreprocessing` with ``[minval, maxval]``
    from the spectrogram scale.
    """
    H, W, C = data_shape
    if H % 2 ** L or W % 2 ** L:
        raise ValueError(f"data shape {tuple(data_shape)} is not divisible "
                         f"by 2^L = {2 ** L}")
    if data_type == "image":
        prep = ImgPreprocessing(alpha=alpha if use_logit else 0.05,
                                use_logit=use_logit)
    else:
        prep = SpecPreprocessing(minval=minval, maxval=maxval,
                                 alpha=alpha or 1e-10, use_logit=use_logit)
    glow = GlowMultiScale(L, K, C, make_conv_net_factory(n_filters),
                          device=device)
    model = FlowModel(Chain([prep, glow], name="glow_flow"),
                      _prior(glow.base_event_shape(data_shape), learntop,
                             device))
    if minibatch is not None:
        model.init(minibatch, generator)
    return model


def build_realnvp(data_shape: Sequence[int], n_filters: int = 32,
                  n_blocks: int = 4, learntop: bool = True,
                  alpha: float = 0.05,
                  minibatch: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> FlowModel:
    """RealNVP's two-scale flow on NHWC images of ``data_shape``, with a
    prior over ``(H/2, W/2, 4C)``."""
    H, W, C = data_shape
    model = FlowModel(RealNVP(C, n_filters=n_filters, n_blocks=n_blocks,
                              alpha=alpha, device=device),
                      _prior((H // 2, W // 2, 4 * C), learntop, device))
    if minibatch is not None:
        model.init(minibatch, generator)
    return model
