"""Autotuning: sweep-once, cache-forever config selection.

Counterpart of ``hetu_tpu/tune/``. ``autotune.py`` is the generic
engine: ``autotune(name, key, candidates, measure)`` with an
env-controlled persistent JSON cache (``HETU_AUTOTUNE``,
``HETU_AUTOTUNE_CACHE``); the auto-planner's measured refinement rides
it. ``probe.py`` and the flash-attention block sweep (K5) wait for
ROADMAP item 13.
"""
from .autotune import (AutotuneTable, autotune, configure,
                       default_cache_path, get_table, platform_scope,
                       platform_tag, reset, timeit, tuning_mode)

__all__ = ["AutotuneTable", "autotune", "configure",
           "default_cache_path", "get_table", "platform_scope",
           "platform_tag", "reset", "timeit", "tuning_mode"]
