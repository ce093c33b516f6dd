"""A multi-rank dry run at tiny shapes (port of
``__graft_entry__.dryrun_multichip``).

    python -m audiosourcesep_tpu_torch.parallel.dryrun 4 [--device cpu]

On ``n`` ranks (processes of one gloo or NCCL group, started by
:func:`~.workers.run_ranks`) it runs one data-parallel NCSN train step,
the frame-sharded BASIS anneal with NCSN and with Glow priors, and for an
even ``n`` the source-sharded NCSN and Glow anneals on JAX's
``(source, data)`` layout, and checks that each result is finite.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

SHAPE = (16, 16, 1)


def _finite(what: str, x) -> None:
    if x is not None and not torch.isfinite(x).all():
        raise FloatingPointError(f"dryrun: {what} is not finite")


def rank_body(device: torch.device) -> dict:
    """One rank of the dry run (every rank runs it); returns the train
    step's loss."""
    from ..models import build_glow
    from ..models.ncsn import get_score_model, get_sigmas
    from ..separation import (BasisConfig, basis_separate_per_level,
                              glow_score_fn, ncsn_score_fn,
                              source_sharded_glow_score,
                              source_sharded_ncsn_score)
    from ..training import (init_train_state, make_ncsn_train_step,
                            setup_optimizer)
    from . import make_layout, make_mesh_for_batch, world_size

    n = world_size()
    sigmas = get_sigmas(1.0, 0.01, 4)
    gen = torch.Generator(device=device).manual_seed(2)

    # data parallelism: the full NCSN train step, gradients averaged
    model = get_score_model("v1", SHAPE, 8, 4, device=device)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = init_train_state(model, setup_optimizer("adam", 1e-3), ema=True)
    layout = make_mesh_for_batch(2 * n)
    step, _ = make_ncsn_train_step(sigmas, ema_decay=0.999, layout=layout)
    batch = torch.randn((2 * n, *SHAPE), generator=torch.Generator()
                        .manual_seed(1))
    first = 2 * (layout.data_index if layout is not None else 0)
    mine = batch[first:first + 2]
    state, loss = step(state, mine.to(device), gen)
    loss = float(loss)
    if not math.isfinite(loss):
        raise FloatingPointError(f"dryrun: train loss {loss}")
    model.eval().requires_grad_(False)

    cfg = BasisConfig(T=1, collect_trajectory=False)
    mixed = torch.ones((n, *SHAPE), device=device)
    x0 = torch.zeros((2, n, *SHAPE), device=device)
    frames = make_layout(1) if n > 1 else None

    # BASIS with the frames sharded: every rank holds both priors
    out, _ = basis_separate_per_level(ncsn_score_fn([model, model]), mixed,
                                      x0, sigmas, gen, cfg, layout=frames)
    _finite("frame-sharded NCSN anneal", out)

    # Glow priors: the score through each level's flows
    mb = torch.randn((4, *SHAPE), generator=torch.Generator().manual_seed(4))
    glow = build_glow(SHAPE, L=2, K=1, n_filters=4, learntop=True,
                      data_type="melspec", minval=-1.0, maxval=1.0,
                      minibatch=mb.to(device),
                      generator=torch.Generator().manual_seed(5),
                      device=device).eval().requires_grad_(False)
    out, _ = basis_separate_per_level(
        glow_score_fn([[glow, glow]] * 2), mixed, x0, sigmas[:2], gen, cfg,
        layout=frames)
    _finite("frame-sharded Glow anneal", out)

    if n % 2 == 0:
        # JAX's (source, data) layout: one prior per rank, the mixing
        # gathered over the source pair
        sources = make_layout(2)
        out, _ = basis_separate_per_level(
            source_sharded_ncsn_score([model], sources), mixed, x0, sigmas,
            gen, cfg, layout=sources)
        _finite("source-sharded NCSN anneal", out)
        out, _ = basis_separate_per_level(
            source_sharded_glow_score([[glow]] * 2, sources), mixed, x0,
            sigmas[:2], gen, cfg, layout=sources)
        _finite("source-sharded Glow anneal", out)
    return {"loss": loss}


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 120.0) -> float:
    """Run the dry run on ``n_devices`` ranks (``device`` ``cpu``, or
    ``cuda``: the ranks share the cards, over gloo where they share one);
    returns the train step's loss, the same on every rank."""
    from .workers import run_ranks
    out = run_ranks({"task": "dryrun"}, n_devices, device, timeout)
    losses = {o["loss"] for o in out}
    if len(losses) != 1:
        raise AssertionError(f"the ranks' losses differ: {sorted(losses)}")
    loss = losses.pop()
    print(f"dryrun_multichip OK on {n_devices} ranks ({device}); "
          f"loss={loss:.4f}")
    return loss


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n", type=int)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the ranks share the cards) or cpu")
    a = parser.parse_args(sys.argv[1:])
    dryrun_multichip(a.n, a.device)
