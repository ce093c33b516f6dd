"""Normalizing-flow bijectors, priors and the flow model (port of
``audiosourcesep_tpu/bijectors``)."""

from .basic import (ActNorm, ImgPreprocessing, Invertible1x1Conv,
                    SpecPreprocessing, Squeeze)
from .core import Bijector, Chain, Identity, Invert, sum_event
from .coupling import (AffineCouplingMasked, AffineCouplingSplit,
                       binary_mask, stacked_masked_couplings)
from .distribution import (FlowModel, IsotropicNormalPrior,
                           LearnableDiagNormalPrior)
from .nets import (ConstantShiftAndLogScale, ShiftAndLogScaleConvNet,
                   ShiftAndLogScaleDenseNet, ShiftAndLogScaleResNet)

__all__ = ["Bijector", "Chain", "Identity", "Invert", "sum_event",
           "ActNorm", "Invertible1x1Conv", "Squeeze", "ImgPreprocessing",
           "SpecPreprocessing", "AffineCouplingSplit",
           "AffineCouplingMasked", "binary_mask", "stacked_masked_couplings",
           "ShiftAndLogScaleConvNet", "ShiftAndLogScaleResNet",
           "ShiftAndLogScaleDenseNet", "ConstantShiftAndLogScale",
           "IsotropicNormalPrior", "LearnableDiagNormalPrior", "FlowModel"]
