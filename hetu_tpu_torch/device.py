"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import os

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``device`` argument -> ``torch.device``.

    ``None`` means ``cuda``: the port is built for the GPU and never
    drops to the CPU on its own. In a launcher's job (``LOCAL_RANK``
    set) it is the rank's card, ``cuda:{LOCAL_RANK % cards}``. Asking
    for ``cuda`` where CUDA is absent raises; pass ``device="cpu"`` to
    run the plain PyTorch versions of the kernels on the CPU (the tests
    do)."""
    if device is None and "LOCAL_RANK" in os.environ and \
            torch.cuda.is_available():
        local = int(os.environ["LOCAL_RANK"])
        device = f"cuda:{local % torch.cuda.device_count()}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
