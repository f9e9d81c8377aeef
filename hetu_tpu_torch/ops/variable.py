"""Placeholders and variables (counterpart of ``hetu_tpu/ops/variable.py``;
reference: gpu_ops/Variable.py)."""
from __future__ import annotations

import zlib

import numpy as np

from ..graph.node import Op
from ..ndarray import NDArray

__all__ = ["PlaceholderOp", "Variable", "placeholder_op"]


class PlaceholderOp(Op):
    """A leaf node: a parameter (value or initializer given) or a feed
    slot (reference Variable.py:19-108)."""

    def __init__(self, name, value=None, initializer=None, trainable=True,
                 dtype=np.float32, ctx=None):
        super().__init__(PlaceholderOp, [], ctx)
        self.name = name
        self.is_embed = False
        self.shape = None
        if value is None and initializer is None:
            trainable = False
        elif value is not None:
            if initializer is not None:
                raise ValueError("value already specified, initializer "
                                 "must be None")
            if not isinstance(value, NDArray):
                value = np.asarray(value, dtype=dtype)
            self.shape = tuple(value.shape)
        else:
            self.shape = initializer.shape
        self.tensor_value = value
        self.initializer = initializer
        self.trainable = trainable
        self.dtype = dtype

    def compute(self, input_vals, ectx):
        # feeds and parameters are injected by the executor; reaching
        # here means the node was neither fed nor initialized
        raise RuntimeError(f"placeholder {self.name} must be fed or "
                           f"initialized")

    def gradient(self, output_grad):
        return None

    def infer_shape(self, input_shapes):
        if self.shape is None:
            raise ValueError(f"placeholder {self.name} has no shape: feed it")
        return self.shape

    def initial_value(self, seed=0):
        """The initial value as a numpy array. The draw is seeded from
        the parameter *name* (``seed + crc32(name)``), as in
        ``hetu_tpu``, so both packages draw the same weights."""
        if self.tensor_value is not None:
            if isinstance(self.tensor_value, NDArray):
                return self.tensor_value.asnumpy()
            return np.asarray(self.tensor_value, dtype=self.dtype)
        if self.initializer is None:
            raise ValueError(f"placeholder {self.name} has no value")
        tag = zlib.crc32(self.name.encode())
        return self.initializer.init_numpy(seed=seed + tag)


def Variable(name, value=None, initializer=None, trainable=True,
             dtype=np.float32, ctx=None):
    return placeholder_op(name, value, initializer, trainable, dtype, ctx)


def placeholder_op(name, value=None, initializer=None, trainable=True,
                   dtype=np.float32, ctx=None):
    return PlaceholderOp(name, value, initializer, trainable, dtype, ctx)
