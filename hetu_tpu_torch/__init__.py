"""hetu_tpu_torch: the PyTorch/CUDA port of ``hetu_tpu`` for NVIDIA Hopper.

The port grows slice by slice beside the JAX package and mirrors its
module names and public API, so each module's counterpart is easy to
find. It imports ``torch`` and never ``jax`` or ``hetu_tpu``.

What runs today:

* training through the define-then-run graph API — ``ht.Variable``,
  the ``*_op`` builders, ``ht.optim``, ``ht.Executor`` — for the GPT
  causal LM and the BERT family (MLM + NSP pre-training and its other
  heads; :mod:`.models`), with the flash-attention forward (K1, K2)
  and fused backward (K3, K4) as hand-written sm_90a kernels
  (``ops/csrc/``);
* the CNN/RNN zoo (``models.cnn``: conv, pooling, batch norm) trained
  from ``ht.dataloader_op`` batches through train and validate
  subgraphs of one executor (``ht.data``, ``ht.metrics``,
  ``examples/cnn_main.py``);
* the CTR models (WDL, DeepFM, DCN, DC), NCF and the seq2seq
  Transformer, trained through ``Executor.run`` / ``run_batches`` with
  their embedding tables on the device (``examples/ctr_main.py``,
  ``rec_main.py``, ``transformer_main.py``);
* GCN and GraphSAGE (``models.gnn``) over CSR graph feeds
  (``ND_Sparse_Array`` / ``CSRValue``, ``csrmm_op`` / ``csrmv_op``):
  full-batch with the graph pinned on the device
  (``examples/gcn_main.py``) and minibatch over sampled subgraphs fed
  through ``GNNDataLoaderOp`` (``examples/sampled_sage.py``); the
  step, multi-step, exponential and plateau schedules (``ht.lr``),
  AdamW, and ``ht.stream``'s streams and events;
* the PS and Hybrid modes against the port's C++ parameter server, and
  fleets of PS workers and servers started by its launcher
  (``python -m hetu_tpu_torch.launcher -c cluster.yml <command>``);
* data-parallel training (AllReduce, and Hybrid's dense half) across a
  launcher's ``spmd: true`` processes, one a card: the global batch
  split over the ranks, gradients averaged over ``torch.distributed``
  (:mod:`.parallel.mesh`, :mod:`.parallel.data_parallel`);
* tensor-parallel training (``ht.dispatch`` specs, by hand or from
  :func:`~.parallel.autoplan.compile_rules`) across a launcher's
  ``spmd: true`` processes: the planner's ``NodeStatus`` propagation,
  each rank holding and computing its shards
  (:mod:`.parallel.planner`, :mod:`.parallel.tensor_parallel`), with
  data parallelism beside it on the mesh's ``dp`` axis;
* pipeline-parallel training, GPipe and PipeDream 1F1B (``gpipe=True``
  / ``pipedream=True``), its stages placed by ``with ht.context(...)``,
  in one process or across a launcher's worker processes
  (:mod:`.parallel`);
* sequence parallelism (ring, Ulysses) and DistGCN-1.5D
  (``distgcn_15d_op`` over a ``("gr", "gc")`` mesh);
* several devices of one process's context, a tensor-parallel plan or a
  tuple stage with no launcher job: one thread rank a device
  (:mod:`.parallel.local_ranks`), so the reference's scripts run
  unchanged;
* the telemetry layer (span tracer, metrics, flight recorder, the
  launcher's watchdog), the training health monitor (sentinels on
  sampled steps, staleness and hot keys of the PS caches, the trip
  ladder), the perf doctor and the fleet plane (per-rank step
  timelines, the launcher's ``--watch`` naming a straggler), with their
  file tools ``python -m
  hetu_tpu_torch.telemetry.{check,health,blackbox,regress,doctor,fleet}``,
  which run without torch;
* GPT-2-shaped paged-KV serving through
  :class:`~hetu_tpu_torch.serving.ContinuousBatchingEngine`, prefill on
  K1.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, or ``ctx=ht.cpu(0)`` for an executor); asking for
``cuda`` without a GPU raises (:func:`resolve_device`). On the CPU each
kernel's plain PyTorch version runs instead — that is what the tests
use.
"""
import sys as _sys

# the telemetry command-line tools read and write files only; run as
# ``python -m hetu_tpu_torch.telemetry.<tool>`` they skip the API below
# and its torch import (seconds a start), so they run where no card is
_TOOLS = tuple(f"hetu_tpu_torch.telemetry.{t}"
               for t in ("check", "health", "blackbox", "regress",
                         "doctor", "fleet"))


def _runs_tool():
    """True while ``python -m`` imports this package on its way to one
    of ``_TOOLS`` (runpy sets ``sys.argv[0]`` to "-m" until the target
    module runs)."""
    argv = getattr(_sys, "orig_argv", ())
    if _sys.argv[:1] != ["-m"] or "-m" not in argv:
        return False
    i = argv.index("-m")
    return i + 1 < len(argv) and argv[i + 1] in _TOOLS


if _runs_tool():
    __all__ = []
else:
    from . import data, metrics, models, parallel, stream, telemetry
    from . import initializers as init
    from . import lr_scheduler as lr
    from . import optimizer as optim
    from .context import (DeviceGroup, NodeStatus, context,
                          get_current_context)
    from .dataloader import (Dataloader, DataloaderOp, GNNDataLoaderOp,
                             dataloader_op)
    from .device import resolve_device, start_cpu_threads
    from .executor import (Executor, HetuConfig, SubExecutor,
                           get_worker_communicate, gradients,
                           new_group_comm, scheduler_finish, scheduler_init,
                           server_finish, server_init, worker_finish,
                           worker_init, wrapped_mpi_nccl_init)
    from .graph.node import Op
    from .ndarray import (DLContext, IndexedSlices, ND_Sparse_Array,
                          NDArray, array, cpu, empty, gpu, is_gpu_ctx,
                          is_tpu_ctx, rcpu, rgpu, rtpu, sparse_array, tpu)
    from .ops import *                                    # noqa: F401,F403
    from .ops import __all__ as _ops_all

    start_cpu_threads()

    __all__ = ["resolve_device", "DLContext", "NDArray", "IndexedSlices",
               "cpu", "gpu", "tpu", "rcpu", "rgpu", "rtpu", "is_gpu_ctx",
               "is_tpu_ctx", "DeviceGroup", "NodeStatus", "context",
               "get_current_context",
               "Op", "Executor", "HetuConfig", "SubExecutor", "gradients",
               "scheduler_init", "scheduler_finish", "server_init",
               "server_finish", "worker_init", "worker_finish",
               "get_worker_communicate", "wrapped_mpi_nccl_init",
               "new_group_comm", "mpi_nccl_init", "optim", "init", "lr",
               "data", "metrics", "models", "launcher", "telemetry",
               "parallel", "Dataloader", "DataloaderOp", "dataloader_op",
               "GNNDataLoaderOp", "ND_Sparse_Array", "sparse_array",
               "array", "empty", "stream",
               *_ops_all]


def mpi_nccl_init(init_nccl=True):
    """The reference's ``(comm, device_id)``: the job's communicator and
    this rank's card (:func:`wrapped_mpi_nccl_init`)."""
    comm = wrapped_mpi_nccl_init(init_nccl)
    return comm, comm.dev_id()


def __getattr__(name):
    # lazy: ``python -m hetu_tpu_torch.launcher`` runs the module as
    # __main__, and runpy warns when the package imported it first
    if name == "launcher":
        import importlib
        return importlib.import_module(".launcher", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
