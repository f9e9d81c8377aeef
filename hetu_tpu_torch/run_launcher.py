"""The launcher as a script, by path: ``python
hetu_tpu_torch/run_launcher.py -c cluster.yml <command> [args...]``.

The same :func:`~hetu_tpu_torch.launcher.main` as ``python -m
hetu_tpu_torch.launcher``, without the package's ``__init__``, which
imports torch (seconds a start): the launcher needs the standard library
and the parameter server's process helpers, none of which import torch,
so a fleet's launcher starts in a fraction of a second. Its servers and
workers are processes of their own and import what they use.
"""
import os
import sys
import types

_PKG = os.path.dirname(os.path.abspath(__file__))
# the package's directory, not this script's, is no import root
sys.path[0] = os.path.dirname(_PKG)
if "hetu_tpu_torch" not in sys.modules:
    _pkg = types.ModuleType("hetu_tpu_torch")
    _pkg.__path__ = [_PKG]
    sys.modules["hetu_tpu_torch"] = _pkg

from hetu_tpu_torch.launcher import main                   # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
