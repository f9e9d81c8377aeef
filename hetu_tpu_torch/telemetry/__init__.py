"""Telemetry surface the serving plane calls — disabled only.

Counterpart of ``hetu_tpu/telemetry/__init__.py``. Only the disabled
facade is ported so far: every recording method is a no-op and
``enabled`` is False, so the serving modules' guarded instrumentation
sites cost one attribute check, and the few they call unguarded
(``flight_complete``) do nothing. Asking for ENABLED telemetry raises
``NotImplementedError`` instead of silently recording nothing.
"""
from __future__ import annotations

import os

__all__ = ["Telemetry", "resolve", "NULL"]


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

_NOT_PORTED = ("enabled telemetry is not ported to hetu_tpu_torch yet; "
               "pass telemetry=None or False")


class Telemetry:
    """Disabled telemetry facade: the method surface of the reference's
    ``Telemetry`` with every call a no-op."""

    def __init__(self, enabled=False):
        if enabled:
            raise NotImplementedError(_NOT_PORTED)
        self.enabled = False

    def span(self, name, **args):
        return _NULL_SPAN

    def instant(self, name, **args):
        pass

    def complete(self, name, t0_ns, t1_ns, args=None):
        pass

    def inc(self, name, n=1):
        pass

    def observe(self, name, value):
        pass

    def set_gauge(self, name, value):
        pass

    @staticmethod
    def flight_complete(rec):
        pass

    def flight_record(self, group, kind, peer=None, tag=None, nbytes=0):
        pass


NULL = Telemetry()


def resolve(arg=None):
    """``telemetry=`` argument -> the disabled :data:`NULL` instance.

    ``None`` and ``False`` resolve to it, as does a disabled
    :class:`Telemetry`. Everything that asks for recording — ``True``,
    an output directory, or ``HETU_TELEMETRY`` set in the environment
    with ``None`` — raises ``NotImplementedError`` until telemetry is
    ported."""
    if arg is None:
        if os.environ.get("HETU_TELEMETRY"):
            raise NotImplementedError(
                _NOT_PORTED + " (HETU_TELEMETRY is set)")
        return NULL
    if arg is False:
        return NULL
    if isinstance(arg, Telemetry):
        return arg
    if arg is True or isinstance(arg, (str, os.PathLike)) \
            or getattr(arg, "enabled", False):
        raise NotImplementedError(_NOT_PORTED)
    raise TypeError(f"telemetry must be None/bool/path/Telemetry, "
                    f"got {type(arg).__name__}")
