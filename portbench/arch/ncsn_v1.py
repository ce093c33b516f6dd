"""NCSN v1 priors: one RefineNetDilated a source, shared by every noise
level, computed in the traffic's ``compute_dtype``."""

from __future__ import annotations

import torch

from . import meta_params, model_weights, routable
from ..reference import ncsn_v1 as ref
from ..reference.precision import Precision, stack

DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


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
        models.append(model.eval().requires_grad_(False))
    return ncsn_score_fn(models)


def reference_scores(cfg, traffic, seed, level, device, prec, cache):
    """The sources' scores at ``level``; ``cache`` keeps the weights."""
    if "ncsn" not in cache:
        cache["ncsn"] = stack([model_weights(ref, cfg, seed, k, device)
                               for k in range(traffic["sources"])])
    params = cache["ncsn"]

    def scores(x):
        labels = torch.full((x.shape[1],), level, dtype=torch.long,
                            device=x.device)
        return ref.score(params, x, labels, cfg, prec)

    return scores


def step_count(cfg, traffic):
    """(FLOPs, routable convs) of one step: a forward a source."""
    prec = Precision(count=True)
    k, n = traffic["sources"], traffic["frames"]
    x = torch.empty((k, n, *cfg["data_shape"]), device="meta")
    labels = torch.zeros(n, dtype=torch.long, device="meta")
    ref.score(meta_params(ref, cfg, k), x, labels, cfg, prec)
    return prec.flops, routable(prec.convs)
