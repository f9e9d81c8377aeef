"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import os

import torch

__all__ = ["resolve_device", "start_cpu_threads"]


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


def start_cpu_threads():
    """Start PyTorch's intra-op CPU thread team on a value that is thrown
    away; the package calls it once, when it is imported.

    On a loaded host the first parallel region of a fresh OpenMP team
    now and then returns a wrong vectorized ``exp`` for one thread's
    chunk (relative errors near 1.5e-4, where every later region's stay
    near 1e-7), with or without the port (ROADMAP §3,
    ``omp_team_probe.py``). Started here, the team's first region is
    this one, so no graph's first step is, and two processes of one job
    compute as one does."""
    n = torch.get_num_threads()
    if n > 1:
        # at least one grain (32768 elements) a thread: every thread runs
        torch.exp(torch.zeros(32768 * n))

