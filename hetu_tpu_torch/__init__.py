"""hetu_tpu_torch: the PyTorch/CUDA port of ``hetu_tpu`` for NVIDIA Hopper.

The port grows slice by slice beside the JAX package and mirrors its
module names, so each module's counterpart is easy to find. It imports
``torch`` and never ``jax`` or ``hetu_tpu``.

What runs today is the serving slice: GPT-2-shaped paged-KV serving
through :class:`~hetu_tpu_torch.serving.ContinuousBatchingEngine`, with
prompt prefill on a hand-written sm_90a flash-attention kernel
(``ops/csrc/flash_fwd.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a GPU raises (:func:`resolve_device`). On
the CPU each kernel's plain PyTorch version runs instead — that is what
the tests use.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
