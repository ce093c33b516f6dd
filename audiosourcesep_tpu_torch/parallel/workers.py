"""Rank workers: run a task on ``n`` processes of one ``torch.distributed``
group and collect each rank's result.

:func:`run_ranks` starts ``n`` Python processes of this module, each one
rank, joined through a ``file://`` rendezvous in a fresh directory (no
port to collide with), runs the payload's task on every rank (in full
float32: TF32 off) and returns
the ranks' results in rank order. It waits at most ``timeout`` seconds
and kills every rank when one fails or the time is up. The ranks import
this package and torch only: they serve ``parallel.dryrun`` and the tests
that hold a multi-rank run against one process or the JAX package.

Tasks (``payload["task"]``), each on tiny models whose weights come in
the payload as flat JAX-layout params (``{keystr: array}``):

- ``ncsn_step`` / ``flow_step``: data-parallel train steps of an NCSN or
  a Glow on the payload's global batch, each rank taking its slice, with
  the payload's global draws; returns the losses and the train state;
- ``noisy_chain``: the noisy-Glow chain, data-parallel, each rank
  writing to a directory of its own; returns rank 0's checkpoints;
- ``basis``: a BASIS anneal of two NCSN or Glow priors on a frame-sharded
  (``n_sources`` 1) or source-sharded (2) layout, with the payload's
  Langevin draws; returns the result on rank 0;
- ``dryrun``: :func:`~.dryrun.dryrun_multichip`'s rank body;
- ``many``: the payloads of ``payload["items"]`` in turn, one process
  start for all (returns ``{name: result}``).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List

import numpy as np
import torch

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_ranks(payload: Dict[str, Any], n: int, device: str = "cuda",
              timeout: float = 120.0) -> List[Any]:
    """Run ``payload`` on ``n`` ranks (``device`` ``cuda``, the ranks'
    cards, which raises without one; or ``cpu``); returns each rank's
    result, in rank order. Raises with the tail of every rank's log when a
    rank fails or the run takes longer than ``timeout`` seconds; no rank
    outlives the call."""
    with tempfile.TemporaryDirectory(prefix="ranks_") as work:
        torch.save(payload, os.path.join(work, "in.pt"))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [_PKG_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        logs = [os.path.join(work, f"rank{r}.log") for r in range(n)]
        procs = []
        try:
            for r in range(n):
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", __name__, work, str(r),
                         str(n), device],
                        stdout=log, stderr=subprocess.STDOUT, env=env))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = [p for p in procs if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        if any(p.returncode != 0 for p in procs):
            tails = []
            for r, path in enumerate(logs):
                with open(path) as f:
                    tails.append(f"--- rank {r} (exit {procs[r].returncode})"
                                 f" ---\n" + f.read()[-4000:])
            raise RuntimeError(
                f"{payload['task']} on {n} ranks failed or passed "
                f"{timeout:.0f} s:\n" + "\n".join(tails))
        return [torch.load(os.path.join(work, f"out{r}.pt"),
                           weights_only=False) for r in range(n)]


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------

def _load(model: torch.nn.Module, flat: Dict[str, np.ndarray],
          device) -> torch.nn.Module:
    from ..training.checkpoint import params_from_jax
    model.load_state_dict(params_from_jax(flat))
    return model.to(device)


def _ncsn(p, flat, device):
    from ..models.ncsn import RefineNetDilated
    return _load(RefineNetDilated(tuple(p["shape"]), p["n_filters"],
                                  num_classes=p["num_classes"]), flat,
                 device)


def _glow(p, flat, device):
    from ..models import build_glow
    return _load(build_glow(tuple(p["shape"]), **p["glow"]), flat, device)


def _tree(state) -> Dict[str, np.ndarray]:
    from ..training.checkpoint import _flatten
    return _flatten(state.tree())


def _train_steps(p, device, model, make_step, names):
    """Steps on this rank's slice of ``p["batch"]`` with the global draws
    ``p["draws"]`` (one tuple per step, named ``names``)."""
    from ..parallel import make_mesh_for_batch
    from ..training import init_train_state, setup_optimizer
    batch = torch.as_tensor(p["batch"])
    layout = make_mesh_for_batch(len(batch))
    b = len(batch) // layout.data_size
    local = batch[layout.data_index * b:(layout.data_index + 1) * b]
    state = init_train_state(model, setup_optimizer(*p["optimizer"]),
                             ema=p.get("ema", False))
    step, eval_loss = make_step(layout)
    losses = []
    for draws in p["draws"]:
        kw = {k: torch.as_tensor(v, device=device)
              for k, v in zip(names, draws)}
        state, loss = step(state, local.to(device), **kw)
        losses.append(float(loss))
    return {"losses": losses, "tree": _tree(state)}


def ncsn_step(p, device):
    from ..training import make_ncsn_train_step
    return _train_steps(
        p, device, _ncsn(p, p["params"], device),
        lambda layout: make_ncsn_train_step(p["sigmas"], ema_decay=0.999
                                            if p.get("ema") else None,
                                            layout=layout),
        ("sigma_idx", "noise"))


def flow_step(p, device):
    from ..training import make_flow_train_step
    return _train_steps(
        p, device, _glow(p, p["params"], device),
        lambda layout: make_flow_train_step(p.get("noise_sigma"),
                                            layout=layout),
        ("noise", "dequant"))


def noisy_chain(p, device):
    """``train_noisy_glow_chain`` of a Glow (``p["params"]``) on this
    rank's host shard of ``p["data"]`` (unshuffled; ``p["test"]`` to
    validate) at the global batch ``p["batch_size"]``, into a directory of
    this rank's own; returns the latest checkpoint of each level (rank 0)
    and the files this rank wrote there."""
    from ..data.loaders import ArrayDataset
    from ..parallel import make_mesh_for_batch, rank, world_size
    from ..training import train_noisy_glow_chain
    from ..training.checkpoint import latest_checkpoint, load_flat
    n, me = world_size(), rank()
    b = p["batch_size"] // n
    with tempfile.TemporaryDirectory(prefix=f"chain{me}_") as out:
        dirs = train_noisy_glow_chain(
            _glow(p, p["params"], device), p["sigmas"],
            ArrayDataset(p["data"], b, False, num_hosts=n, host_id=me),
            ArrayDataset(p["test"], b, False, num_hosts=n, host_id=me),
            n_epochs_per_sigma=1, batch_size=p["batch_size"],
            output_dir=out, reinit_actnorm=True,
            reinit_minibatch=p["data"][:4],
            generator=torch.Generator(device=device).manual_seed(0),
            layout=make_mesh_for_batch(p["batch_size"]))
        files = sorted(os.path.relpath(os.path.join(d, f), out)
                       for d, _, fs in os.walk(out) for f in fs)
        latest = {s: latest_checkpoint(d) for s, d in dirs.items()}
        levels = {s: load_flat(c) for s, c in latest.items() if c}
    return {"levels": levels, "files": files}


def basis(p, device):
    """``p["kind"]`` ``ncsn`` (``p["params"]``: the two sources' flat
    params) or ``glow`` (``[level][source]``); ``p["n_sources"]`` 1 or 2;
    ``p["noise"]`` ``[L, T, *x0.shape]``."""
    from ..parallel import make_layout
    from ..separation import (BasisConfig, basis_separate_per_level,
                              glow_score_fn, ncsn_score_fn,
                              source_sharded_glow_score,
                              source_sharded_ncsn_score)
    layout = make_layout(p["n_sources"])
    mine = list(range(2))[layout.sources]
    sharded = p["n_sources"] == 2
    if p["kind"] == "ncsn":
        models = [_ncsn(p, p["params"][k], device).eval() for k in mine]
        score = (source_sharded_ncsn_score(models, layout) if sharded
                 else ncsn_score_fn(models))
    else:
        chains = [[_glow(p, lvl[k], device).eval().requires_grad_(False)
                   for k in mine] for lvl in p["params"]]
        chunk = p.get("frame_chunk")
        score = (source_sharded_glow_score(chains, layout, chunk) if sharded
                 else glow_score_fn(chains, chunk))
    noise = torch.as_tensor(p["noise"])
    x, traj = basis_separate_per_level(
        score, torch.as_tensor(p["mixed"], device=device),
        torch.as_tensor(p["x0"], device=device), p["sigmas"],
        config=BasisConfig(**p["cfg"]),
        noise_fn=lambda level, step: noise[level, step], layout=layout)
    if x is None:
        return None
    return {"x": x.cpu().numpy(), "traj": traj.cpu().numpy()}


def _dryrun(p, device):
    from .dryrun import rank_body
    return rank_body(device)


def _many(p, device):
    return {name: TASKS[item["task"]](item, device)
            for name, item in p["items"].items()}


TASKS = {"ncsn_step": ncsn_step, "flow_step": flow_step,
         "noisy_chain": noisy_chain, "basis": basis, "dryrun": _dryrun,
         "many": _many}


def _main(work: str, rank: int, n: int, device: str) -> None:
    from . import init_distributed, shutdown
    if device == "cpu":
        torch.set_num_threads(1)
    # full float32, as the comparisons these ranks serve are made
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_distributed(f"file://{os.path.join(work, 'rendezvous')}", n,
                           rank, device=device)
    payload = torch.load(os.path.join(work, "in.pt"), weights_only=False)
    out = TASKS[payload["task"]](payload, dev)
    if dev.type == "cuda":
        print(f"rank {rank}: peak CUDA memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    torch.save(out, os.path.join(work, f"out{rank}.pt"))
    shutdown()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
