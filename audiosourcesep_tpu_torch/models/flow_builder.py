"""Flow builders (port of ``build_glow`` in ``audiosourcesep_tpu/models/flow_builder.py``).

``build_realnvp`` waits for the RealNVP port.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..bijectors import (Chain, FlowModel, ImgPreprocessing,
                         IsotropicNormalPrior, LearnableDiagNormalPrior,
                         SpecPreprocessing)
from .glow import GlowMultiScale, make_conv_net_factory


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
    from the spectrogram scale. With ``minibatch`` (NHWC, on ``device``)
    the model is initialised from it and ``generator``, as the JAX
    ``build_glow`` is; without, its parameters are left uninitialised
    (``device="meta"`` builds a template to load a checkpoint into).
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
    base = glow.base_event_shape(data_shape)
    prior = (LearnableDiagNormalPrior(base, device=device) if learntop
             else IsotropicNormalPrior(base))
    model = FlowModel(Chain([prep, glow], name="glow_flow"), prior)
    if minibatch is not None:
        model.init(minibatch, generator)
    return model
