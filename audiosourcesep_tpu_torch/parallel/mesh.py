"""Process groups and the frame/source layout of a multi-process run, on
``torch.distributed`` (port of ``audiosourcesep_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a mesh, ``(data,)`` for data
parallelism and ``(source, data)`` for source-sharded BASIS, and lets XLA
insert the collectives. Here each rank is one process with one device;
:class:`Layout` says which source and which frame shard a rank holds and
carries the two process groups that the ``(source, data)`` grid needs. The
collectives are explicit, and each is written so that a run on several
ranks gives the numbers of one process.

Backends: ``nccl`` when every local rank has a card of its own, ``gloo``
when ranks share one (NCCL refuses two ranks on one device) or run on the
CPU. gloo takes CUDA tensors for the collectives used here (all-reduce,
all-gather; it stages them through host memory itself).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SOURCE_AXIS = "source"

# a rank that waits longer than this in a collective raises instead of
# hanging (a peer that died, or control flow that diverged)
TIMEOUT_S = 600.0


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0, or a run without ``torch.distributed``: the process that
    writes checkpoints and results."""
    return rank() == 0


def _init_method(address: Optional[str]) -> str:
    """``env://`` (torchrun's variables) without an address; ``host:port``
    becomes ``tcp://host:port``; a URL (``tcp://``, ``file://``) is kept."""
    if address is None:
        return "env://"
    return address if "://" in address else f"tcp://{address}"


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: ``cuda:<local_rank % device_count>`` for a
    CUDA ``device``, else ``device`` itself."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but CUDA is not "
                           "available (no fallback to the CPU)")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """``nccl`` when the ranks of this host each have a card of their own,
    ``gloo`` when they share one or run on the CPU. A rule of topology:
    an NCCL init that fails raises, it is not retried on gloo."""
    if device.type == "cuda" \
            and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> torch.device:
    """Join the process group; returns this rank's device.

    ``coordinator_address`` (``host:port`` or a ``tcp://`` / ``file://``
    URL) with ``num_processes`` and ``process_id`` name the group
    explicitly; without an address the rendezvous, world size and rank
    come from torchrun's environment (``env://``), as JAX auto-detects
    them on a TPU pod. The local rank and the number of local ranks come
    from ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` when torchrun sets them,
    else every process is taken to run on this host. The backend is
    :func:`choose_backend`'s unless given; it is printed.
    """
    if coordinator_address is not None and (num_processes is None
                                            or process_id is None):
        raise ValueError("--coordinator_address needs --num_processes and "
                         "--process_id")
    world = (num_processes if coordinator_address is not None
             else int(os.environ["WORLD_SIZE"]))
    me = (process_id if coordinator_address is not None
          else int(os.environ["RANK"]))
    local_rank = int(os.environ.get("LOCAL_RANK", me))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(device, local_rank)
    backend = backend or choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address),
        world_size=world, rank=me,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        # NCCL: create the communicator now, not at the first collective
        device_id=dev if backend == "nccl" else None)
    print(f"torch.distributed: rank {me} of {world}, backend "
          f"{dist.get_backend()}, device {dev}")
    return dev


def shutdown() -> None:
    """Barrier, then leave the process group (the end of a run: a rank
    that exits while its peers still talk to it makes them fail)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """``t`` of every rank of ``group``, in group-rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def gather_to_main(t: torch.Tensor) -> Optional[List[torch.Tensor]]:
    """``t`` of every rank, in rank order, on rank 0 (``None`` on the
    other ranks). Every rank's ``t`` has the same shape. It is an
    all-gather, of which the other ranks drop their copy: the results
    are small, and it is the collective both backends take CUDA tensors
    for."""
    out = all_gather(t)
    return out if is_main_process() else None


# ---------------------------------------------------------------------------
# the (source, data) layout
# ---------------------------------------------------------------------------

@dataclass
class Layout:
    """This rank's place in a ``(source, data)`` grid of ranks, JAX's
    ``make_source_mesh`` layout: rank ``r`` holds source ``r // data_size``
    (with ``n_sources == 2``; every source with ``n_sources == 1``) and
    frame shard ``r % data_size``.

    ``mixing_group``: the ranks that hold the same frames and the other
    source (the BASIS mixing gathers over it; ``None`` when every rank
    holds both sources). ``data_group``: the ranks that hold the same
    source (``None`` means the whole world); the anneal needs no
    collective over it, and data-parallel training all-reduces over it.
    """
    world_size: int = 1
    rank: int = 0
    n_sources: int = 1
    data_size: int = 1
    mixing_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def source(self) -> int:
        """The source this rank holds (0 when it holds both)."""
        return self.rank // self.data_size if self.n_sources > 1 else 0

    @property
    def data_index(self) -> int:
        return self.rank % self.data_size

    @property
    def sources(self) -> slice:
        """This rank's rows of the source axis."""
        if self.n_sources == 1:
            return slice(None)
        return slice(self.source, self.source + 1)

    def padded(self, n_frames: int) -> int:
        return pad_to_multiple(n_frames, self.data_size)

    def frames(self, n_frames: int) -> slice:
        """This rank's frames of the padded frame axis."""
        n_local = self.padded(n_frames) // self.data_size
        return slice(self.data_index * n_local,
                     (self.data_index + 1) * n_local)

    def local(self, x: torch.Tensor, frame_axis: int = 1,
              source_axis: Optional[int] = 0) -> torch.Tensor:
        """This rank's block of a global ``x``: the frame axis wrap-padded
        to a multiple of ``data_size`` (frames repeated from the start, as
        ``jnp.pad(mode="wrap")``), then this rank's frame shard and, on a
        source-sharded layout, its source row (``source_axis``)."""
        if self.world_size == 1:
            return x
        n = x.shape[frame_axis]
        x = wrap_pad(x, self.padded(n), frame_axis)
        x = x.narrow(frame_axis, self.frames(n).start,
                     self.padded(n) // self.data_size)
        if source_axis is not None and self.n_sources > 1:
            x = x.narrow(source_axis, self.source, 1)
        return x

    def gather_sources(self, x: torch.Tensor) -> torch.Tensor:
        """Every source of this rank's frames, ``[K, n_local, ...]``, from
        this rank's ``[1, n_local, ...]`` (the mixing's collective); ``x``
        itself when this rank holds every source."""
        if self.n_sources == 1:
            return x
        return torch.cat(all_gather(x, self.mixing_group))

    def gather(self, x: torch.Tensor, n_frames: int,
               frame_axis: int = 1) -> Optional[torch.Tensor]:
        """The global tensor from every rank's block (:meth:`local`'s
        inverse, the padding frames dropped) on rank 0; ``None`` on the
        other ranks. The source axis is the one before ``frame_axis``."""
        if self.world_size == 1:
            return x
        blocks = gather_to_main(x)
        if blocks is None:
            return None
        rows = [torch.cat(blocks[s * self.data_size:
                                 (s + 1) * self.data_size], frame_axis)
                for s in range(self.n_sources)]
        out = torch.cat(rows, frame_axis - 1) if self.n_sources > 1 \
            else rows[0]
        return out.narrow(frame_axis, 0, n_frames)


def wrap_pad(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """``x`` with ``axis`` padded to ``n`` by repeating it from its start
    (``jnp.pad(mode="wrap")``)."""
    m = x.shape[axis]
    if n == m:
        return x
    idx = torch.arange(n, device=x.device) % m
    return x.index_select(axis, idx)


def make_layout(n_sources: int = 1) -> Layout:
    """The layout of this process group: ``n_sources == 1`` shards the
    frames (or the batch) over every rank; ``n_sources == 2`` is JAX's
    ``(source, data)`` mesh, ``world_size // 2`` frame shards per source.
    Every rank must call it, in the same order (it makes process groups).
    """
    n = world_size()
    if n_sources not in (1, 2) or n % n_sources:
        raise ValueError(f"{n} ranks do not divide into {n_sources} "
                         "sources")
    data_size = n // n_sources
    layout = Layout(world_size=n, rank=rank(), n_sources=n_sources,
                    data_size=data_size)
    if n_sources > 1:
        # every rank creates every group, in one order
        mixing = [dist.new_group([d + s * data_size
                                  for s in range(n_sources)])
                  for d in range(data_size)]
        data = [dist.new_group(list(range(s * data_size,
                                          (s + 1) * data_size)))
                for s in range(n_sources)]
        layout.mixing_group = mixing[layout.data_index]
        layout.data_group = data[layout.source]
    return layout


def make_mesh_for_batch(batch_size: int) -> Optional[Layout]:
    """The data-parallel layout over every rank, or ``None`` in a single
    process (callers then skip every collective). Each rank takes
    ``batch_size // world_size`` examples of the global batch."""
    n = world_size()
    if n <= 1:
        return None
    if batch_size % n:
        raise ValueError(f"batch size {batch_size} does not divide over "
                         f"{n} ranks")
    return make_layout(1)
