"""Multi-process layouts on torch.distributed (port of
``audiosourcesep_tpu/parallel``)."""

from .mesh import (DATA_AXIS, SOURCE_AXIS, Layout, all_gather,
                   choose_backend, gather_to_main, init_distributed,
                   is_main_process, make_layout, make_mesh_for_batch,
                   pad_to_multiple, rank, rank_device, shutdown, world_size,
                   wrap_pad)

__all__ = ["DATA_AXIS", "SOURCE_AXIS", "Layout", "all_gather",
           "choose_backend", "gather_to_main", "init_distributed",
           "is_main_process", "make_layout", "make_mesh_for_batch",
           "pad_to_multiple", "rank", "rank_device", "shutdown",
           "world_size", "wrap_pad"]
