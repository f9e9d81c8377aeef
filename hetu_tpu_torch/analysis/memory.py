"""Pass 4 — memory preflight against a device-memory budget (HT4xx).

Counterpart of ``hetu_tpu/analysis/memory.py``'s static tier
(:func:`memory_pass`): from the shape pass's results alone —
parameter bytes, their gradients, the optimizer's slots (a multiplier
per optimizer class) and a sum of the forward activations, each at 4
bytes an element as in the reference — checked against the budget
before any parameter reaches the card. Deliberately pessimistic about
activations (no credit for frees): a plan that fails HT401 is certain
to run out of memory; one that passes may still.

Budget resolution order: an explicit argument > ``HETU_HBM_BUDGET``
(``8G`` / ``512MiB`` / plain bytes) > the total memory of the
session's CUDA device (``torch.cuda``; never read under
``HETU_PREFLIGHT``, whose machine need not hold the fleet's cards).

HT401  estimated footprint exceeds the budget               error
HT402  footprint breakdown (always, when shapes are known)  info
HT403  estimate within 10% of the budget                    warn

The reference's HT404 (``check_compiled``) compares a compiled
program's ``memory_analysis`` with the budget; the port compiles
nothing (ROADMAP §3, "Telemetry records no compile"), so it has none.
"""
from __future__ import annotations

import os
import re

from ..telemetry.memory import fmt_bytes

__all__ = ["memory_pass", "parse_bytes", "resolve_budget"]

_SLOTS_PER_PARAM = {
    "SGDOptimizer": 0,
    "MomentumOptimizer": 1,
    "NesterovOptimizer": 1,
    "AdaGradOptimizer": 1,
    "AdamOptimizer": 2,
    "AdamWOptimizer": 2,
}

_UNITS = {"": 1, "k": 2 ** 10, "m": 2 ** 20, "g": 2 ** 30, "t": 2 ** 40}


def parse_bytes(value):
    """'8G' / '512MiB' / '1073741824' -> bytes (int)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return int(value)
    m = re.fullmatch(r"\s*([0-9]*\.?[0-9]+)\s*([kKmMgGtT]?)i?[bB]?\s*",
                     str(value))
    if not m:
        raise ValueError(f"unparseable byte size {value!r}")
    return int(float(m.group(1)) * _UNITS[m.group(2).lower()])


def _device_limit(device=None):
    """Total memory of the session's CUDA device (``device``, or the
    default card — the launcher rank's, ``LOCAL_RANK``), or None off
    the card."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    index = dev.index
    if index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        index = local % torch.cuda.device_count()
    return int(torch.cuda.get_device_properties(index).total_memory)


def resolve_budget(budget=None, device=None):
    """Explicit budget > HETU_HBM_BUDGET > the device's memory > None."""
    if budget is not None:
        return parse_bytes(budget)
    env = os.environ.get("HETU_HBM_BUDGET")
    if env:
        return parse_bytes(env)
    if "HETU_PREFLIGHT" in os.environ:
        return None
    return _device_limit(device)


def _nbytes(shape, itemsize=4):
    if shape is None:
        return None
    n = itemsize
    for s in shape:
        n *= int(s)
    return n


def memory_pass(topo, shapes, report, budget=None, device=None):
    """Static footprint estimate vs budget; returns the breakdown dict."""
    from ..optimizer import OptimizerOp
    from ..ops.variable import PlaceholderOp

    param_bytes = 0
    for n in topo:
        if isinstance(n, PlaceholderOp) and n.trainable:
            b = _nbytes(shapes.get(n))
            if b:
                param_bytes += b

    opt_ops = [n for n in topo if isinstance(n, OptimizerOp)]
    slot_mult = 0
    for op in opt_ops:
        cls = type(op.optimizer).__name__
        slot_mult = max(slot_mult, _SLOTS_PER_PARAM.get(cls, 1))
    training = bool(opt_ops)
    grad_bytes = param_bytes if training else 0
    slot_bytes = param_bytes * slot_mult

    act_bytes = 0
    unknown_acts = 0
    for n in topo:
        if isinstance(n, (PlaceholderOp, OptimizerOp)):
            continue
        b = _nbytes(shapes.get(n))
        if b is None:
            unknown_acts += 1
        else:
            act_bytes += b

    total = param_bytes + grad_bytes + slot_bytes + act_bytes
    breakdown = {"param_bytes": param_bytes, "grad_bytes": grad_bytes,
                 "opt_slot_bytes": slot_bytes,
                 "activation_bytes": act_bytes, "total_bytes": total}
    if total:
        caveat = (f" ({unknown_acts} node(s) unshaped and uncounted)"
                  if unknown_acts else "")
        report.add(
            "HT402", "info",
            f"static footprint estimate: params {fmt_bytes(param_bytes)}"
            f" + grads {fmt_bytes(grad_bytes)} + optimizer slots "
            f"{fmt_bytes(slot_bytes)} + activations "
            f"{fmt_bytes(act_bytes)} = {fmt_bytes(total)}{caveat}",
            **breakdown)

    budget = resolve_budget(budget, device)
    if budget is None or not total:
        return breakdown
    if total > budget:
        report.add(
            "HT401", "error",
            f"estimated device footprint {fmt_bytes(total)} exceeds "
            f"the HBM budget {fmt_bytes(budget)} — the plan OOMs "
            f"before the first step completes; shard parameters "
            f"(dispatch/PS), shrink the batch, or raise the budget",
            budget_bytes=budget, **breakdown)
    elif total > 0.9 * budget:
        report.add(
            "HT403", "warn",
            f"estimated footprint {fmt_bytes(total)} is within 10% of "
            f"the HBM budget {fmt_bytes(budget)} — fragmentation or "
            f"temp buffers can tip this over",
            budget_bytes=budget, **breakdown)
    return breakdown
