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
* ``autoplan`` — the cost-model planner: the rules compiler
  (``DEFAULT_RULES``, ``compile_rules``, ``apply_rules``) that puts
  ``dispatch`` specs on a model, and ``choose_plan`` / ``apply_plan``,
  which score (dp, tp, pp) plans on the measured CostDB and apply the
  winner (the executor's ``parallel="auto"``);
* ``ring`` and ``ulysses`` — sequence parallelism over a mesh's ``"sp"``
  axis: ring attention (the zigzag layout when causal) and Ulysses'
  all-to-all, their blocks on the flash kernels, as
  ``ring_attention_op`` / ``ulysses_attention_op`` run them;
* ``distgcn`` — DistGCN-1.5D over a ``("gr", "gc")`` mesh
  (``partition_csr_15d``, ``dist_gcn_spmm`` and its transpose), as
  ``distgcn_15d_op`` runs it;
* ``local_ranks`` — several devices of one process's context (or a
  ``LocalMesh``) run as thread ranks of the process, each on its own
  clone of the graph, over a ``LocalJob``.

The collective pipeline waits for ROADMAP item 11b.2, a split parameter
on a parameter server for 11b.5;
the sp axis beside model axes, in a pipeline and on a parameter server
for 11c.1-11c.3.
"""
from . import autoplan
from .autoplan import (DEFAULT_RULES, apply_plan, apply_rules, choose_plan,
                       compile_rules)
from .mesh import (Job, LocalJob, LocalMesh, Mesh, build_mesh,
                   factorized_axes, mesh_for_statuses, subset_mesh)
from .p2p import PipeChannel, get_channel
from .planner import assign_states, propagate_statuses, spec_for_status
from .pipeline import (PipelineSubExecutor, analytic_bubble_fraction,
                       splice_send_recv, virtual_stage_program)
from . import distgcn, local_ranks, ring, ulysses
from .distgcn import DistCSR15d, dist_gcn_spmm, partition_csr_15d

__all__ = ["Job", "LocalJob", "LocalMesh", "Mesh", "build_mesh",
           "factorized_axes", "mesh_for_statuses", "subset_mesh",
           "DistCSR15d", "dist_gcn_spmm", "partition_csr_15d", "distgcn",
           "local_ranks",
           "assign_states", "propagate_statuses", "spec_for_status",
           "autoplan", "DEFAULT_RULES", "compile_rules", "apply_rules",
           "choose_plan", "apply_plan",
           "PipelineSubExecutor", "analytic_bubble_fraction",
           "virtual_stage_program", "splice_send_recv", "PipeChannel",
           "get_channel", "ring", "ulysses"]
