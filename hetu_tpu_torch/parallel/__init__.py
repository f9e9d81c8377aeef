"""Parallel modes of the port.

Counterpart of ``hetu_tpu/parallel/``. Ported so far:

* ``pipeline`` — GPipe and PipeDream 1F1B over stages placed by
  ``with ht.context(...)``, in one process or across worker processes
  (:class:`~.pipeline.PipelineSubExecutor`; the Executor's
  ``gpipe=True`` / ``pipedream=True``), with the interleaved schedule's
  helpers;
* ``p2p`` — the host TCP channel that carries stage boundaries between
  worker processes;
* ``mesh`` — rank meshes over ``torch.distributed``, one process group
  per axis slice;
* ``data_parallel`` — the global batch split over data-parallel ranks
  and the fetched values made global again.

The TP planner, the collective pipeline and the auto-planner wait for
ROADMAP item 11b; ring and Ulysses attention for 11c; DistGCN for 11d.
"""
from .mesh import Mesh, build_mesh, factorized_axes, mesh_for_statuses
from .p2p import PipeChannel, get_channel
from .pipeline import (PipelineSubExecutor, analytic_bubble_fraction,
                       splice_send_recv, virtual_stage_program)

__all__ = ["Mesh", "build_mesh", "factorized_axes", "mesh_for_statuses",
           "PipelineSubExecutor", "analytic_bubble_fraction",
           "virtual_stage_program", "splice_send_recv", "PipeChannel",
           "get_channel"]
