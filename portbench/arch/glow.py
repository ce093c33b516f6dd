"""Glow priors: one flow a noise level and source (as the separation CLI
restores a noise-level chain), in float32; the score is the input
gradient of log p through the flow, ``frame_chunk`` frames at a time."""

from __future__ import annotations

import torch

from . import meta_params, model_weights, routable
from ..reference import glow as ref
from ..reference.precision import Precision, stack


def build(cfg, traffic, sigmas, seed, device):
    from audiosourcesep_tpu_torch.models import build_glow
    from audiosourcesep_tpu_torch.separation import glow_score_fn
    lo, hi = cfg["data_range"]
    chains = []
    for level in range(len(sigmas)):
        flows = []
        for k in range(traffic["sources"]):
            model = build_glow(cfg["data_shape"], L=cfg["L"], K=cfg["K"],
                               n_filters=cfg["n_filters"],
                               learntop=cfg["learntop"], data_type="melspec",
                               use_logit=cfg["use_logit"],
                               alpha=cfg["alpha"] or 1e-6,
                               minval=lo, maxval=hi, device="meta")
            state = model_weights(ref, cfg, seed, (level, k), device)
            model = model.to_empty(device=device)
            model.load_state_dict(state)
            del state
            flows.append(model.eval().requires_grad_(False))
        chains.append(flows)
    return glow_score_fn(chains, frame_chunk=traffic["frame_chunk"] or None)


def reference_scores(cfg, traffic, seed, level, device, prec, cache):
    """The sources' scores at ``level``; ``cache`` keeps this level's
    weights (the previous level's are dropped)."""
    if cache.get("glow_level") != level:
        cache.pop("glow", None)
        params = stack([model_weights(ref, cfg, seed, (level, k), device)
                        for k in range(traffic["sources"])])
        cache["glow"] = params, ref.weights_1x1(params, cfg)
        cache["glow_level"] = level
    params, w1x1 = cache["glow"]

    def scores(x):
        return ref.score(params, x, cfg, prec, w1x1)

    return scores


def step_count(cfg, traffic):
    """(FLOPs, routable convs) of one step: per source a forward through
    the flow and the input-gradient backward (as many FLOPs: each conv and
    matmul's input gradient is one product of the same size), each over
    the frames in chunks of ``frame_chunk``."""
    k, n = traffic["sources"], traffic["frames"]
    chunk = traffic["frame_chunk"] or n
    prec = Precision(count=True)
    params = meta_params(ref, cfg, k)
    for start in range(0, n, chunk):
        x = torch.empty((k, min(chunk, n - start), *cfg["data_shape"]),
                        device="meta")
        ref.log_prob(params, x, cfg, prec)
    return 2 * prec.flops, routable(prec.convs)
