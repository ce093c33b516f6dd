#!/usr/bin/env python3
"""The port's collectives on one CUDA card: what a multi-process run pays.

    python3 benchmarks/torch_dist_probe.py          # needs a CUDA card
    python3 benchmarks/torch_dist_probe.py --json   # last line: the numbers

Two ``torchrun`` launches of this script's rank body:

1. one rank over NCCL (world size 1, as ``train_ncsn --multihost
   --num_processes 1``): the time to create the group, the NCSN v1 train
   step at full width (192 filters, 10 levels, batch 32, Adam, f32, TF32
   and Winograd routing off) as the CLI runs it at world size 1 (no
   collective), and the same step with its gradients all-reduced through
   NCCL over the group of one;
2. two ranks sharing the card over gloo (NCCL refuses two ranks on one
   device): which of ``all_reduce``, ``broadcast`` and ``all_gather``
   gloo takes CUDA tensors for, as this PyTorch is built (it stages them
   through host memory itself); the data-parallel step at batch 16 a rank
   (32 in all) with its bucketed all-reduce of the 67,464,769 f32
   gradients; that all-reduce alone; and the BASIS mixing's
   ``all_gather`` of one
   source's ``[1, 30, 96, 64, 1]`` f32 iterate over the source pair.

Times are host clocks around work that ends in ``torch.cuda.synchronize``
(medians of the repeats). Two ranks on one card share it: their times are
not scaling numbers. Each line names the card and its power limit.
``chip_smoke.py`` phase 10 times the same step, all-reduce and gather
inside the CLIs' own ranks; this script adds the world-size-1 all-reduce
and gloo's CUDA support, which need no re-reading with every run.
"""

import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

REPEATS = 3


def _timed(fn, device, repeats=REPEATS):
    """Median seconds of ``fn()`` (after one warm-up), each ending in a
    barrier-free ``torch.cuda.synchronize``."""
    fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _gloo_takes_cuda(device, world):
    """gloo's own CUDA support per collective (an unsupported one raises
    on every rank alike, so no rank is left waiting)."""
    import torch.distributed as dist
    probes = {
        "all_reduce": lambda t: dist.all_reduce(t),
        "broadcast": lambda t: dist.broadcast(t, 0),
        "all_gather": lambda t: dist.all_gather(
            [torch.empty_like(t) for _ in range(world)], t)}
    out = {}
    for name, fn in probes.items():
        try:
            fn(torch.ones(4, device=device))
            torch.cuda.synchronize(device)
            out[name] = "takes CUDA tensors"
        except RuntimeError as e:
            out[name] = f"refuses: {str(e).splitlines()[0][:100]}"
    return out


def rank_probe(device, init_s):
    """One rank's measurements (every rank runs it); ``init_s`` is the
    seconds the rank took to join the group."""
    import torch.distributed as dist

    from audiosourcesep_tpu_torch import nn
    from audiosourcesep_tpu_torch.models.ncsn import (get_score_model,
                                                      get_sigmas)
    from audiosourcesep_tpu_torch.parallel import Layout, make_layout
    from audiosourcesep_tpu_torch.parallel import world_size
    from audiosourcesep_tpu_torch.training import (init_train_state,
                                                   make_ncsn_train_step,
                                                   setup_optimizer)
    from audiosourcesep_tpu_torch.training.trainers import _mean_over_ranks_
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    nn.set_winograd(False)
    world, rank = world_size(), dist.get_rank()
    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "init_s": init_s}
    if out["backend"] == "gloo":
        out["gloo_cuda"] = _gloo_takes_cuda(device, world)

    model = get_score_model("v1", (96, 64, 1), 192, 10, device=device)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = init_train_state(model, setup_optimizer("adam", 1e-3))
    sigmas = get_sigmas(1.0, 0.01, 10, "logarithmic")
    b = 32 // world
    x = torch.rand((b, 96, 64, 1), generator=torch.Generator(
        device=device).manual_seed(rank), device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    out["n_grad"] = sum(t.numel() for t in state.params.values())
    # the data-parallel layout over every rank, also at world size 1
    dp = Layout(world_size=world, rank=rank, data_size=world)
    step, _ = make_ncsn_train_step(sigmas, layout=dp)
    out["step_s"] = _timed(lambda: step(state, x, gen), device)
    grads = [p.grad for p in state.params.values()]
    out["all_reduce_s"] = _timed(lambda: _mean_over_ranks_(grads, dp),
                                 device)
    if world == 1:
        plain, _ = make_ncsn_train_step(sigmas)      # the CLI at world 1
        out["plain_step_s"] = _timed(lambda: plain(state, x, gen), device)
    else:
        layout = make_layout(2)
        it = torch.randn((1, 30, 96, 64, 1), device=device)
        out["mixing_gather_s"] = _timed(lambda: layout.gather_sources(it),
                                        device, repeats=50)
        out["mixing_bytes"] = it.numel() * it.element_size()
    out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2 ** 20
    return out


def rank_main(out_dir):
    """``--rank OUT_DIR``: one rank under torchrun; writes its results to
    ``OUT_DIR/rank{r}.json``."""
    from audiosourcesep_tpu_torch.parallel import init_distributed, shutdown
    t0 = time.perf_counter()
    device = init_distributed(device="cuda")
    out = rank_probe(device, time.perf_counter() - t0)
    with open(os.path.join(out_dir, f"rank{out['rank']}.json"), "w") as f:
        json.dump(out, f)
    shutdown()


def probe():
    """Both runs; returns ``{"nccl_1": [rank results], "gloo_2": [...]}``."""
    out = {}
    for name, n in (("nccl_1", 1), ("gloo_2", 2)):
        with tempfile.TemporaryDirectory(prefix="probe_") as d:
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--nproc_per_node", str(n), "--master_addr", "localhost",
                 "--master_port", str(port), os.path.abspath(__file__),
                 "--rank", d], check=True, timeout=600,
                env=dict(os.environ, PYTHONPATH=REPO,
                         OMP_NUM_THREADS=str(torch.get_num_threads())))
            out[name] = []
            for r in range(n):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    out[name].append(json.load(f))
    return out


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("torch_dist_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = probe()
    one, two = res["nccl_1"][0], res["gloo_2"]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(f"NCCL, world size 1 ({one['backend']}): group created in "
          f"{one['init_s']:.2f} s; train step (batch 32, "
          f"no collective, as the CLI) {1e3 * one['plain_step_s']:.1f} ms; "
          f"with its {one['n_grad']:,} gradients all-reduced over the "
          f"group of one {1e3 * one['step_s']:.1f} ms (the all-reduce "
          f"alone {1e3 * one['all_reduce_s']:.2f} ms); peak "
          f"{one['peak_mib']:.0f} MiB [{smi}]")
    for r in two:
        print(f"gloo, 2 ranks sharing one card, rank {r['rank']}: step at "
              f"batch 16 a rank {1e3 * r['step_s']:.1f} ms; bucketed "
              f"all-reduce of {r['n_grad']:,} f32 gradients "
              f"{1e3 * r['all_reduce_s']:.1f} ms; mixing all_gather of "
              f"{r['mixing_bytes'] / 1e6:.2f} MB "
              f"{1e3 * r['mixing_gather_s']:.3f} ms; peak "
              f"{r['peak_mib']:.0f} MiB [{smi}; ranks sharing one card, "
              f"not scaling]")
    print(f"gloo on CUDA tensors, as built: {two[0]['gloo_cuda']}")
    if "--json" in argv:
        print(json.dumps({"card": smi, **res}))
    return res


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2])
    else:
        main(sys.argv[1:])
