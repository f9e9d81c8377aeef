"""Frozen-graph inference sessions.

Counterpart of ``hetu_tpu/serving/session.py``. ``InferenceSession``
wraps an eval-only :class:`~hetu_tpu_torch.executor.Executor` (no
optimizer state) restored from an ``Executor.save`` checkpoint — this
package's or ``hetu_tpu``'s, one ``.npy`` per parameter plus a sidecar —
and serves ``predict(feed_dict)`` with MANDATORY shape bucketing: the
batch dim pads up to the next power-of-two bucket and (optionally) a
ragged sequence dim pads to a fixed bucket, so the executor sees at
most one feed shape per bucket however ragged the traffic is. The
reference bounds its ``jit`` compiles that way; the port's eager
executor keeps the same shapes, so the kernels see the same few
problem sizes.

The forward runs under ``torch.inference_mode()``: no autograd graph
is built and nothing is kept for a backward. Outputs are cut back to
the real batch (and sequence) on the device before the one copy to the
host. A PS-backed session (``comm_mode="PS"``, its lookups rewritten
by :func:`~hetu_tpu_torch.serving.embedding.serve_embeddings_from_ps`)
pulls its embedding rows from the server per request through a
:class:`~hetu_tpu_torch.serving.embedding.ReadOnlyPSClient`, with an
LRU row cache of ``embed_cache_rows`` rows a table.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..executor import Executor, HetuConfig
from ..graph.autodiff import find_topo_sort
from ..graph.node import Op
from ..ndarray import NDArray
from ..ops.comm import ParameterServerCommunicateOp
from ..optimizer import OptimizerOp

__all__ = ["InferenceSession", "next_bucket"]

def next_bucket(n, buckets=None):
    """Smallest bucket >= n. ``buckets=None`` means the power-of-two
    ladder {1, 2, 4, 8, ...}; an explicit sequence must be sorted."""
    n = int(n)
    if buckets is None:
        b = 1
        while b < n:
            b *= 2
        return b
    for b in buckets:
        if b >= n:
            return int(b)
    raise ValueError(f"batch/seq of {n} exceeds the largest configured "
                     f"bucket {max(buckets)}")


def _pad_axis(arr, target, axis):
    """Pad by repeating the trailing slice (edge padding keeps ids in
    vocabulary range and dense features finite — zeros could be an
    out-of-distribution input for either)."""
    n = arr.shape[axis]
    if n == target:
        return arr
    take = [slice(None)] * arr.ndim
    take[axis] = slice(n - 1, n)
    pad = np.repeat(arr[tuple(take)], target - n, axis=axis)
    return np.concatenate([arr, pad], axis=axis)


class InferenceSession:
    """Serve ``predict()`` over a frozen eval graph.

    Parameters
    ----------
    eval_node_list : list[Op]
        Output nodes (logits, probabilities, ...). The graph must be
        inference-only: an optimizer in the closure raises at
        construction — freezing is a contract, not a convention.
    checkpoint : str, optional
        ``Executor.save`` directory to restore parameters from.
    batch_buckets : sequence[int], optional
        Batch-dim buckets (default: powers of two).
    seq_buckets : sequence[int], optional
        When set, dim ``seq_axis`` of every feed with more than
        ``seq_axis`` dims also pads up to a bucket (causal LMs: extra
        trailing positions never change real positions' outputs).
    ps_read_only : bool
        Wrap the session's PS client so any push raises (default True).
    embed_cache_rows : int
        Rows a table the read-only client keeps in its LRU cache
        (default 0: every row is pulled).
    executor_kwargs :
        Forwarded to :class:`HetuConfig` (``ctx``, ``device``, ``seed``,
        ``dtype``, ``comm_mode``); the session runs on ``cuda`` unless
        they say otherwise, and raises without it.
    """

    def __init__(self, eval_node_list, checkpoint=None, *,
                 batch_buckets=None, seq_buckets=None, seq_axis=1,
                 ps_read_only=True, embed_cache_rows=0, telemetry=None,
                 **executor_kwargs):
        eval_node_list = list(eval_node_list)
        self._check_frozen(eval_node_list)
        self.telemetry = _telemetry.resolve(telemetry)
        self.batch_buckets = (tuple(sorted(batch_buckets))
                              if batch_buckets else None)
        self.seq_buckets = (tuple(sorted(seq_buckets))
                            if seq_buckets else None)
        self.seq_axis = int(seq_axis)
        config = HetuConfig(eval_node_list=eval_node_list, **executor_kwargs)
        self.device = config.device
        self.ps_client = None
        if config.ps_comm is not None and ps_read_only:
            from .embedding import ReadOnlyPSClient
            if not isinstance(config.ps_comm, ReadOnlyPSClient):
                config.ps_comm = ReadOnlyPSClient(
                    config.ps_comm, cache_rows=embed_cache_rows)
            self.ps_client = config.ps_comm
        self.executor = Executor({"default": eval_node_list},
                                 config=config)
        sub = self.executor.subexecutors["default"]
        assert not sub.training
        self.feed_nodes = list(sub.feed_nodes)
        self._by_name = {n.name: n for n in self.feed_nodes}
        if checkpoint is not None:
            self.load(checkpoint)

    @staticmethod
    def _check_frozen(eval_node_list):
        """The reference's frozen-graph contract
        (``hetu_tpu/analysis/shapes.py`` ``frozen_graph_pass``): no
        optimizer and no PS push op in the closure."""
        errors = []
        for n in find_topo_sort(eval_node_list):
            if isinstance(n, OptimizerOp):
                errors.append("InferenceSession over a training graph: "
                              "eval nodes reach an OptimizerOp — pass the "
                              "model outputs only (no train_op)")
            elif isinstance(n, ParameterServerCommunicateOp):
                errors.append(f"InferenceSession over a PS push "
                              f"({n.name}): serving never pushes")
        if errors:
            raise ValueError("\n".join(errors))

    # ------------------------------------------------------------------
    def load(self, checkpoint):
        """Restore parameters from an ``Executor.save`` directory."""
        self.executor.load(checkpoint)
        return self

    def params_by_name(self):
        """{param name: device tensor} — the bridge to weight-level
        serving paths (``GPTDecoder.from_session``): the session's own
        tensors, not copies."""
        return {node.name: self.executor.params[sid]
                for sid, node in self.executor._param_nodes.items()}

    def node_of(self, key):
        if isinstance(key, Op):
            return key
        try:
            return self._by_name[key]
        except KeyError:
            raise KeyError(
                f"unknown feed {key!r}; session feeds are "
                f"{sorted(self._by_name)}") from None

    # ------------------------------------------------------------------
    def predict(self, feed_dict, unpad=True):
        """Run the frozen forward on one (ragged) batch.

        Feeds pad up to the shape bucket, outputs slice back to the real
        batch (and sequence) before returning, as numpy arrays."""
        if self.executor is None:
            raise RuntimeError("session closed")
        t0 = time.perf_counter()
        feeds = {self.node_of(k): np.asarray(v)
                 for k, v in feed_dict.items()}
        sizes = {v.shape[0] for v in feeds.values() if v.ndim}
        if len(sizes) != 1:
            raise ValueError(
                f"feeds disagree on batch size: {sorted(sizes)}")
        n = sizes.pop()
        b = next_bucket(n, self.batch_buckets)
        seq_pads = {}      # bucket -> set of real lengths padded to it
        padded = {}
        for node, v in feeds.items():
            v = _pad_axis(v, b, 0)
            if self.seq_buckets is not None and v.ndim > self.seq_axis:
                s = v.shape[self.seq_axis]
                sb = next_bucket(s, self.seq_buckets)
                seq_pads.setdefault(sb, set()).add(s)
                v = _pad_axis(v, sb, self.seq_axis)
            padded[node] = v
        frec = None
        if self.telemetry.enabled:
            frec = self.telemetry.flight.start(
                "serve", "serve_predict", tag=f"bucket{b}",
                nbytes=sum(int(v.nbytes) for v in padded.values()))
        with torch.inference_mode():
            outs = [o.tensor for o in
                    self.executor.run("default", feed_dict=padded)]
            if unpad:
                outs = [self._trim(o, n, b, seq_pads) for o in outs]
            # the cut view is copied alone; the padded output is freed
            # when ``outs`` drops it
            outs = [NDArray(o).asnumpy() for o in outs]
        self.telemetry.flight_complete(frec)
        tel = self.telemetry
        if tel.enabled:
            tel.inc("serve_predictions")
            tel.observe("predict_ms", (time.perf_counter() - t0) * 1e3)
            tel.set_gauge("serve_batch_bucket", b)
        return outs

    def _trim(self, out, n, b, seq_pads):
        if out is None or not getattr(out, "ndim", 0):
            return out
        if out.shape[0] == b:
            out = out[:n]
        if seq_pads and out.ndim > self.seq_axis + 1:
            # ndim guard: only outputs with structure BEYOND
            # [batch, features] (e.g. logits [B, S, V]) are treated as
            # sequence-shaped — a [B, C] head whose class count happens
            # to equal a seq bucket must never be cut; per-position 2-D
            # outputs come back padded, callers slice themselves
            width = out.shape[self.seq_axis]
            reals = seq_pads.get(width)
            # trim ONLY when unambiguous: every feed padded to this
            # bucket had the same real length (two ragged feeds sharing
            # a bucket would make any cut a guess — return padded then)
            if reals is not None and len(reals) == 1:
                real = next(iter(reals))
                if real != width:
                    idx = [slice(None)] * out.ndim
                    idx[self.seq_axis] = slice(0, real)
                    out = out[tuple(idx)]
        return out

    # ------------------------------------------------------------------
    def close(self):
        """Close the executor and drop it and its parameter table;
        ``predict`` then raises. A decoder built ``from_session`` keeps
        the tensors it shares."""
        if self.executor is not None:
            self.executor.close()
        self.executor = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
