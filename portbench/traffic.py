"""The one generator of the benchmark's separation jobs.

A traffic mix (``traffic/<name>.json``) is a job: ``frames`` of the
model's data shape, ``sources`` priors, ``compute_dtype``, ``frame_chunk``
(a flow's score over this many frames at a time; 0 = all), ``winograd``
(routing on), the mixture's
draw (``mixture_mean``, ``mixture_std``: normal in [0, 1] units, as the
JAX package's benchmark draws it) and ``trace_replays`` (the replays a
``--trace 1`` run records after a level's warm-up and capture).

From the seed it draws, on the device, the mixture ``[N, H, W, C]`` and
the sources' start ``[K, N, H, W, C]`` (uniform), mapped to data scale
where the configuration separates there, and hands on the generator that
then draws the Langevin noise, as the separation CLI uses one generator
for both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .spec import derive


class Inputs(NamedTuple):
    mixed: torch.Tensor
    x_init: torch.Tensor
    sigmas: np.ndarray
    generator: torch.Generator


def sigmas(cfg: dict) -> np.ndarray:
    """The configuration's noise levels, float32."""
    s1, sl, n = cfg["sigma1"], cfg["sigmaL"], cfg["num_classes"]
    if cfg["progression"] == "logarithmic":
        out = np.logspace(np.log10(s1), np.log10(sl), num=n)
    else:
        out = np.exp(np.linspace(np.log(s1), np.log(sl), num=n))
    return out.astype(np.float32)


def make(cfg: dict, traffic: dict, seed: int, device) -> Inputs:
    shape = (traffic["frames"], *cfg["data_shape"])
    gen = torch.Generator(device=device).manual_seed(
        derive(seed, "inputs"))
    mixed = torch.randn(shape, generator=gen, device=device) \
        * traffic["mixture_std"] + traffic["mixture_mean"]
    x_init = torch.rand((traffic["sources"], *shape), generator=gen,
                        device=device)
    if cfg["separation_scale"] == "data":
        lo, hi = cfg["data_range"]
        mixed = mixed * (hi - lo) + lo
        x_init = x_init * (hi - lo) + lo
    return Inputs(mixed, x_init, sigmas(cfg), gen)
