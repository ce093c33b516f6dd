"""BSS-Eval v4 and oracle separations: numpy and scipy on the host."""

from .bsseval import (bss_eval, bss_eval_sources, bss_eval_sources_framewise,
                      bss_eval_images, bss_eval_images_framewise, validate)
from .oracles import IBM, IRM, MWF, IBM_melspec, IRM_melspec

__all__ = [
    "bss_eval", "bss_eval_sources", "bss_eval_sources_framewise",
    "bss_eval_images", "bss_eval_images_framewise", "validate",
    "IBM", "IRM", "MWF", "IBM_melspec", "IRM_melspec",
]
