"""Flow++ priors over mel frames: one flow a noise level and source (as the
separation CLI restores a noise-level chain), in float32; the score is the
input gradient of log p through the flow, ``frame_chunk`` frames at a
time."""

from __future__ import annotations

import torch

from . import meta_params, model_weights, routable
from ..reference import flowpp as ref
from ..reference.precision import Precision, stack


def build(cfg, traffic, sigmas, seed, device):
    from audiosourcesep_tpu_torch.models import build_flowpp
    from audiosourcesep_tpu_torch.separation import glow_score_fn
    lo, hi = cfg["data_range"]
    chains = []
    for level in range(len(sigmas)):
        flows = []
        for k in range(traffic["sources"]):
            model = build_flowpp(cfg["data_shape"],
                                 n_components=cfg["n_components"],
                                 n_blocks_flow=cfg["n_blocks"],
                                 filters=cfg["n_filters"],
                                 heads=cfg["heads"], data_type="melspec",
                                 minval=lo, maxval=hi, device="meta")
            state = model_weights(ref, cfg, seed, (level, k), device)
            model = model.to_empty(device=device)
            model.load_state_dict(state)
            del state
            flows.append(model.eval().requires_grad_(False))
        chains.append(flows)
    return glow_score_fn(chains, frame_chunk=traffic["frame_chunk"] or None)


def reference_scores(cfg, traffic, seed, level, device, prec, cache):
    """The sources' scores at ``level``, every frame at once; ``cache``
    keeps this level's weights (the previous level's are dropped)."""
    if cache.get("flowpp_level") != level:
        cache.pop("flowpp", None)
        params = stack([model_weights(ref, cfg, seed, (level, k), device)
                        for k in range(traffic["sources"])])
        cache["flowpp"] = params, ref.weights_1x1(params, cfg)
        cache["flowpp_level"] = level
    params, w1x1 = cache["flowpp"]

    def scores(x):
        return ref.score(params, x, cfg, prec, w1x1)

    return scores


def _forward_count(cfg, traffic) -> Precision:
    """One step's forwards (every source's flow over every frame) counted
    on the ``meta`` device."""
    k, n = traffic["sources"], traffic["frames"]
    chunk = traffic["frame_chunk"] or n
    prec = Precision(count=True)
    params = meta_params(ref, cfg, k)
    for start in range(0, n, chunk):
        x = torch.empty((k, min(chunk, n - start), *cfg["data_shape"]),
                        device="meta")
        ref.log_prob(params, x, cfg, prec)
    return prec


def attention_calls(cfg, traffic) -> list:
    """One step's attention calls, ``(N, heads, T, d)`` each, a source's
    flow over a chunk of frames a call a layer."""
    return list(getattr(_forward_count(cfg, traffic), "attention", []))


def attention_flops(call) -> int:
    """A forward's two attention products, ``4 N heads T^2 d``."""
    n, heads, t, d = call
    return 4 * n * heads * t * t * d


def step_count(cfg, traffic):
    """(FLOPs, routable convs) of one step: per source a forward through
    the flow and the input-gradient backward, over the frames in chunks of
    ``frame_chunk``. The forward's convs and dense layers are one product
    each, its attention two (q k^T, then the weights times v); the input
    gradient takes one product of the same size a conv or dense layer and
    four an attention (the gradients of q, k, v and of the weights: all
    three depend on x)."""
    prec = _forward_count(cfg, traffic)
    attn = sum(attention_flops(c) for c in getattr(prec, "attention", []))
    return 2 * (prec.flops - attn) + 3 * attn, routable(prec.convs)
