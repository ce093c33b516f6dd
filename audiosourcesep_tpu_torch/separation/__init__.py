"""BASIS separation with score priors."""

from .basis import (BasisConfig, basis_separate, basis_separate_per_level,
                    glow_score_fn, ncsn_score_fn, postprocess,
                    preprocess_mixture, source_sharded_glow_score,
                    source_sharded_ncsn_score)
from .mixing import mixing_process

__all__ = ["BasisConfig", "basis_separate", "basis_separate_per_level",
           "glow_score_fn", "ncsn_score_fn", "postprocess",
           "preprocess_mixture", "source_sharded_glow_score",
           "source_sharded_ncsn_score", "mixing_process"]
