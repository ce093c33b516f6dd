"""Hyperparameter techniques, model summaries and profiling."""

from .hparams import (max_pairwise_distance, technique1_sigma1,
                      technique2_gamma, technique4_epsilon)
from .profiling import trace
from .summary import print_summary, total_trainable_variables

__all__ = ["max_pairwise_distance", "technique1_sigma1", "technique2_gamma",
           "technique4_epsilon", "total_trainable_variables",
           "print_summary", "trace"]
