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
* GPT-2-shaped paged-KV serving through
  :class:`~hetu_tpu_torch.serving.ContinuousBatchingEngine`, prefill on
  K1.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, or ``ctx=ht.cpu(0)`` for an executor); asking for
``cuda`` without a GPU raises (:func:`resolve_device`). On the CPU each
kernel's plain PyTorch version runs instead — that is what the tests
use.
"""
from . import data, metrics, models
from . import initializers as init
from . import lr_scheduler as lr
from . import optimizer as optim
from .context import DeviceGroup, context, get_current_context
from .dataloader import Dataloader, DataloaderOp, dataloader_op
from .device import resolve_device
from .executor import Executor, HetuConfig, SubExecutor, gradients
from .graph.node import Op
from .ndarray import DLContext, IndexedSlices, NDArray, cpu, gpu
from .ops import *                                        # noqa: F401,F403
from .ops import __all__ as _ops_all

__all__ = ["resolve_device", "DLContext", "NDArray", "IndexedSlices",
           "cpu", "gpu", "DeviceGroup", "context", "get_current_context",
           "Op", "Executor", "HetuConfig", "SubExecutor", "gradients",
           "optim", "init", "lr", "data", "metrics", "models",
           "Dataloader", "DataloaderOp", "dataloader_op", *_ops_all]
