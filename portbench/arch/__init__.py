"""How the program builds and runs each architecture, one module a
configuration's ``arch``, with the same functions:

* ``build(cfg, traffic, sigmas, seed, device)``: the program's priors,
  made as the separation CLI restores them (built on ``meta``, then a state
  dict loaded), from weights the benchmark draws from the seed; returns the
  score function the CLI hands ``basis_separate_per_level``;
* ``reference_scores(cfg, traffic, seed, level, device, prec, cache)``:
  the same priors' scores at one noise level from the plain reference,
  ``x [K, n, ...] -> [K, n, ...]``, on weights drawn again from the seed
  (kept in ``cache`` between levels);
* ``step_count(cfg, traffic, device)``: one Langevin step's model FLOPs
  (direct convolutions and matmuls, counted from shapes on the ``meta``
  device) and its routable 3x3 convs ``(N, H, W, C_in, C_out)``.
"""

from __future__ import annotations

import torch

from .. import weights
from ..spec import derive


def model_weights(ref, cfg: dict, seed: int, key, device) -> dict:
    """The weights of model ``key`` (a source, or a level and a source)."""
    return weights.make(ref.param_specs(cfg), derive(seed, "weights", key),
                        device)


def meta_params(ref, cfg: dict, sources: int) -> dict:
    """The K sources' parameters, stacked, on the ``meta`` device."""
    return {n: torch.empty((sources, *s), device="meta")
            for n, s, _ in ref.param_specs(cfg)}


def routable(convs) -> list:
    """The 3x3 stride-1 undilated convs of even H and W, as
    ``(N, H, W, C_in, C_out)``: what ``nn.set_winograd(True)`` routes to
    the hand-written kernels."""
    return [(n, h, w, ci, co) for n, h, w, ci, co, k, d in convs
            if k == 3 and d == 1 and h % 2 == 0 and w % 2 == 0]
