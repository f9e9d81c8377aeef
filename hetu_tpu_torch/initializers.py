"""Parameter initializers.

Counterpart of ``hetu_tpu/initializers.py`` (reference parity:
python/hetu/initializers.py). Every draw is numpy, seeded per parameter
by ``seed + crc32(name)`` (``PlaceholderOp.initial_value``), so a graph
built in this package and the same graph built in ``hetu_tpu`` start
from bit-identical weights. ``dist_spec`` describes the draw to the
parameter server, which initializes a PS table itself, so a table the
size of Criteo's never materializes on the worker. ``interval`` bounds
the draw for the numerics verifier (``analysis/numerics.py``).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "BaseInit", "ConstantInit", "ZerosInit", "OnesInit", "UniformInit",
    "NormalInit", "TruncatedNormalInit", "XavierNormalInit",
    "XavierUniformInit", "HeNormalInit", "HeUniformInit", "LecunNormalInit",
    "LecunUniformInit", "constant", "zeros", "ones", "random_uniform",
    "random_normal", "truncated_normal", "xavier_normal", "xavier_uniform",
    "he_normal", "he_uniform", "lecun_normal", "lecun_uniform",
    "GenEmpty", "GenConstant",
]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[-2] * receptive if len(shape) == 2 else shape[1] * receptive
    fan_out = shape[-1] * receptive if len(shape) == 2 else shape[0] * receptive
    return fan_in, fan_out


class BaseInit:
    def __init__(self, shape):
        self.shape = tuple(shape)

    def init_numpy(self, seed=0):
        raise NotImplementedError

    def dist_spec(self):
        """``(init_kind, a, b)`` for on-server initialization (reference
        initializers.py:43-60; the server mirrors PSFHandle.h:277-342):
        0 = constant(a), 1 = uniform(a, b), 2 = normal(mean a, std b),
        3 = truncated normal. None when the server cannot draw it."""
        return None

    def interval(self):
        """Static (lo, hi) bound on the initial draw: the numerics
        verifier's interval seed (``analysis/numerics.py``). Constants
        and uniforms are exact; normals are bounded at mean ± 4σ (a draw
        escapes with probability < 1e-4 an element, and the verifier
        widens a trainable's seed for training drift anyway), truncated
        normals at their ± 2σ clip. None where unknown."""
        spec = self.dist_spec()
        if spec is None:
            return None
        kind, a, b = spec
        if kind == 0:
            return (a, a)
        if kind == 1:
            return (a, b)
        if kind == 2:
            return (a - 4.0 * b, a + 4.0 * b)
        if kind == 3:
            return (a - 2.0 * b, a + 2.0 * b)
        return None

    def __call__(self, name, trainable=True, dtype=np.float32, ctx=None):
        from .ops.variable import placeholder_op
        return placeholder_op(name, value=None, initializer=self,
                              trainable=trainable, dtype=dtype, ctx=ctx)


class ConstantInit(BaseInit):
    def __init__(self, constant, shape):
        super().__init__(shape)
        self.constant = constant

    def init_numpy(self, seed=0):
        return np.full(self.shape, self.constant, dtype=np.float32)

    def dist_spec(self):
        return (0, float(self.constant), 0.0)


class ZerosInit(ConstantInit):
    def __init__(self, shape):
        super().__init__(0.0, shape)


class OnesInit(ConstantInit):
    def __init__(self, shape):
        super().__init__(1.0, shape)


class UniformInit(BaseInit):
    def __init__(self, shape, minval=-0.05, maxval=0.05):
        super().__init__(shape)
        self.minval = minval
        self.maxval = maxval

    def init_numpy(self, seed=0):
        rng = np.random.RandomState(seed)
        return rng.uniform(self.minval, self.maxval,
                           self.shape).astype(np.float32)

    def dist_spec(self):
        return (1, float(self.minval), float(self.maxval))


class NormalInit(BaseInit):
    def __init__(self, shape, mean=0.0, stddev=0.05):
        super().__init__(shape)
        self.mean = mean
        self.stddev = stddev

    def init_numpy(self, seed=0):
        rng = np.random.RandomState(seed)
        return rng.normal(self.mean, self.stddev,
                          self.shape).astype(np.float32)

    def dist_spec(self):
        return (2, float(self.mean), float(self.stddev))


class TruncatedNormalInit(BaseInit):
    def __init__(self, shape, mean=0.0, stddev=0.05):
        super().__init__(shape)
        self.mean = mean
        self.stddev = stddev

    def init_numpy(self, seed=0):
        rng = np.random.RandomState(seed)
        out = rng.normal(self.mean, self.stddev, self.shape)
        # resample outside 2 sigma (curand-style truncation)
        for _ in range(8):
            bad = np.abs(out - self.mean) > 2 * self.stddev
            if not bad.any():
                break
            out[bad] = rng.normal(self.mean, self.stddev, bad.sum())
        np.clip(out, self.mean - 2 * self.stddev,
                self.mean + 2 * self.stddev, out=out)
        return out.astype(np.float32)

    def dist_spec(self):
        return (3, float(self.mean), float(self.stddev))


class _VarianceScaling(BaseInit):
    scale_mode = "fan_avg"
    distribution = "normal"
    gain = 1.0

    def __init__(self, shape, gain=None):
        super().__init__(shape)
        if gain is not None:
            self.gain = gain

    def init_numpy(self, seed=0):
        fan_in, fan_out = _fans(self.shape)
        denom = {"fan_in": fan_in, "fan_out": fan_out,
                 "fan_avg": (fan_in + fan_out) / 2}[self.scale_mode]
        rng = np.random.RandomState(seed)
        if self.distribution == "normal":
            std = self.gain * np.sqrt(1.0 / denom)
            return rng.normal(0.0, std, self.shape).astype(np.float32)
        limit = self.gain * np.sqrt(3.0 / denom)
        return rng.uniform(-limit, limit, self.shape).astype(np.float32)

    def dist_spec(self):
        fan_in, fan_out = _fans(self.shape)
        denom = {"fan_in": fan_in, "fan_out": fan_out,
                 "fan_avg": (fan_in + fan_out) / 2}[self.scale_mode]
        if self.distribution == "normal":
            return (2, 0.0, float(self.gain * np.sqrt(1.0 / denom)))
        limit = float(self.gain * np.sqrt(3.0 / denom))
        return (1, -limit, limit)


class XavierNormalInit(_VarianceScaling):
    scale_mode, distribution = "fan_avg", "normal"


class XavierUniformInit(_VarianceScaling):
    scale_mode, distribution = "fan_avg", "uniform"


class HeNormalInit(_VarianceScaling):
    scale_mode, distribution, gain = "fan_in", "normal", np.sqrt(2.0)


class HeUniformInit(_VarianceScaling):
    scale_mode, distribution, gain = "fan_in", "uniform", np.sqrt(2.0)


class LecunNormalInit(_VarianceScaling):
    scale_mode, distribution = "fan_in", "normal"


class LecunUniformInit(_VarianceScaling):
    scale_mode, distribution = "fan_in", "uniform"


# -- reference-named convenience builders (initializers.py:203-295) ---------

def constant(shape, fill_value=0.0, name="constant_var", trainable=True,
             dtype=np.float32, ctx=None):
    return ConstantInit(fill_value, shape)(name, trainable, dtype, ctx)


def zeros(shape, name="zeros_var", trainable=True, dtype=np.float32,
          ctx=None):
    return ZerosInit(shape)(name, trainable, dtype, ctx)


def ones(shape, name="ones_var", trainable=True, dtype=np.float32, ctx=None):
    return OnesInit(shape)(name, trainable, dtype, ctx)


def random_uniform(shape, minval=-0.05, maxval=0.05, name="uniform_var",
                   trainable=True, dtype=np.float32, ctx=None):
    return UniformInit(shape, minval, maxval)(name, trainable, dtype, ctx)


def random_normal(shape, mean=0.0, stddev=0.05, name="normal_var",
                  trainable=True, dtype=np.float32, ctx=None):
    return NormalInit(shape, mean, stddev)(name, trainable, dtype, ctx)


def truncated_normal(shape, mean=0.0, stddev=0.05,
                     name="truncated_normal_var", trainable=True,
                     dtype=np.float32, ctx=None):
    return TruncatedNormalInit(shape, mean, stddev)(name, trainable, dtype,
                                                    ctx)


def xavier_normal(shape, gain=1.0, name="xavier_normal_var", trainable=True,
                  dtype=np.float32, ctx=None):
    return XavierNormalInit(shape, gain)(name, trainable, dtype, ctx)


def xavier_uniform(shape, gain=1.0, name="xavier_uniform_var",
                   trainable=True, dtype=np.float32, ctx=None):
    return XavierUniformInit(shape, gain)(name, trainable, dtype, ctx)


def he_normal(shape, name="he_normal_var", trainable=True, dtype=np.float32,
              ctx=None):
    return HeNormalInit(shape)(name, trainable, dtype, ctx)


def he_uniform(shape, name="he_uniform_var", trainable=True,
               dtype=np.float32, ctx=None):
    return HeUniformInit(shape)(name, trainable, dtype, ctx)


def lecun_normal(shape, name="lecun_normal_var", trainable=True,
                 dtype=np.float32, ctx=None):
    return LecunNormalInit(shape)(name, trainable, dtype, ctx)


def lecun_uniform(shape, name="lecun_uniform_var", trainable=True,
                  dtype=np.float32, ctx=None):
    return LecunUniformInit(shape)(name, trainable, dtype, ctx)


# aliases used by some reference examples
GenEmpty = ZerosInit
GenConstant = ConstantInit
