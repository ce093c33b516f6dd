"""NCSN v2 priors: one RefineNetDilated a source with unconditional norms,
shared by every noise level, its output divided by the level's sigma,
computed in the traffic's ``compute_dtype``."""

from __future__ import annotations

import torch

from . import meta_params, model_weights, routable
from .ncsn_v1 import DTYPES
from ..reference import ncsn_v2 as ref
from ..reference.precision import Precision, stack
from ..traffic import sigmas as schedule


def build(cfg, traffic, sigmas, seed, device):
    from audiosourcesep_tpu_torch.models.ncsn import get_score_model
    from audiosourcesep_tpu_torch.separation import ncsn_score_fn
    models = []
    for k in range(traffic["sources"]):
        model = get_score_model(
            cfg["version"], cfg["data_shape"], cfg["n_filters"],
            cfg["num_classes"], sigmas=sigmas,
            logit_transform=cfg["use_logit"],
            compute_dtype=DTYPES[traffic["compute_dtype"]], device="meta")
        state = model_weights(ref, cfg, seed, k, device)
        model = model.to_empty(device=device)
        model.load_state_dict(state)
        del state
        # a buffer, not a state dict entry: set as the separation CLI sets it
        model.sigmas.copy_(torch.as_tensor(sigmas))
        models.append(model.eval().requires_grad_(False))
    return ncsn_score_fn(models)


def reference_scores(cfg, traffic, seed, level, device, prec, cache):
    """The sources' scores at ``level``; ``cache`` keeps the weights and
    the schedule."""
    if "ncsn" not in cache:
        cache["ncsn"] = stack([model_weights(ref, cfg, seed, k, device)
                               for k in range(traffic["sources"])])
        cache["sigmas"] = torch.as_tensor(schedule(cfg), device=device)
    params, sigmas = cache["ncsn"], cache["sigmas"]

    def scores(x):
        labels = torch.full((x.shape[1],), level, dtype=torch.long,
                            device=x.device)
        return ref.score(params, x, labels, cfg, prec, sigmas)

    return scores


def step_count(cfg, traffic):
    """(FLOPs, routable convs) of one step: a forward a source."""
    prec = Precision(count=True)
    k, n = traffic["sources"], traffic["frames"]
    x = torch.empty((k, n, *cfg["data_shape"]), device="meta")
    labels = torch.zeros(n, dtype=torch.long, device="meta")
    sigmas = torch.empty(cfg["num_classes"], device="meta")
    ref.score(meta_params(ref, cfg, k), x, labels, cfg, prec, sigmas)
    return prec.flops, routable(prec.convs)
