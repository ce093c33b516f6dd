"""Normalizing-flow bijectors, priors and the flow model (the Glow subset
of ``audiosourcesep_tpu/bijectors``)."""

from .basic import (ActNorm, ImgPreprocessing, Invertible1x1Conv,
                    SpecPreprocessing, Squeeze)
from .core import Bijector, Chain, Identity, Invert, sum_event
from .coupling import AffineCouplingSplit
from .distribution import (FlowModel, IsotropicNormalPrior,
                           LearnableDiagNormalPrior)
from .nets import ConstantShiftAndLogScale, ShiftAndLogScaleConvNet

__all__ = ["Bijector", "Chain", "Identity", "Invert", "sum_event",
           "ActNorm", "Invertible1x1Conv", "Squeeze", "ImgPreprocessing",
           "SpecPreprocessing", "AffineCouplingSplit",
           "ShiftAndLogScaleConvNet", "ConstantShiftAndLogScale",
           "IsotropicNormalPrior", "LearnableDiagNormalPrior", "FlowModel"]
