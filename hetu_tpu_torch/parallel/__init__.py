"""Parallel modes of the port.

Counterpart of ``hetu_tpu/parallel/``. Ported so far:

* ``pipeline`` — GPipe and PipeDream 1F1B over stages placed by
  ``with ht.context(...)``, in one process or across worker processes
  (:class:`~.pipeline.PipelineSubExecutor`; the Executor's
  ``gpipe=True`` / ``pipedream=True``), with the interleaved schedule's
  helpers; a stage whose context is a tuple of devices runs on one
  rank a device, tensor or data parallel inside;
* ``p2p`` — the host TCP channel that carries stage boundaries between
  worker processes;
* ``mesh`` — rank meshes over ``torch.distributed``, one process group
  per axis slice, over the job's ranks or a stage's (``Job``,
  ``subset_mesh``);
* ``data_parallel`` — the global batch split over data-parallel ranks
  and the fetched values made global again;
* ``planner`` — the tensor-parallel planner: ``NodeStatus``
  propagation from ``dispatch`` markers to partition specs;
* ``tensor_parallel`` — those specs realized across processes: each
  rank computes on its shards, values move between layouts by
  ``torch.distributed`` collectives;
* ``autoplan`` — the rules compiler (``DEFAULT_RULES``,
  ``compile_rules``, ``apply_rules``) that puts ``dispatch`` specs on a
  model.

The collective pipeline waits for ROADMAP item 11b.2, the auto-planner's
cost model for 11b.3, a split parameter on a parameter server for 11b.5;
ring and Ulysses attention for 11c; DistGCN for 11d.
"""
from . import autoplan
from .autoplan import DEFAULT_RULES, apply_rules, compile_rules
from .mesh import (Job, Mesh, build_mesh, factorized_axes,
                   mesh_for_statuses, subset_mesh)
from .p2p import PipeChannel, get_channel
from .planner import assign_states, propagate_statuses, spec_for_status
from .pipeline import (PipelineSubExecutor, analytic_bubble_fraction,
                       splice_send_recv, virtual_stage_program)

__all__ = ["Job", "Mesh", "build_mesh", "factorized_axes",
           "mesh_for_statuses", "subset_mesh",
           "assign_states", "propagate_statuses", "spec_for_status",
           "autoplan", "DEFAULT_RULES", "compile_rules", "apply_rules",
           "PipelineSubExecutor", "analytic_bubble_fraction",
           "virtual_stage_program", "splice_send_recv", "PipeChannel",
           "get_channel"]
