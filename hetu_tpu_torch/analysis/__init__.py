"""Graph analysis passes over ``hetu_tpu_torch`` graphs.

Counterpart of ``hetu_tpu/analysis/``. Ported so far:

* ``findings`` — :class:`~.findings.Finding`, :class:`~.findings.Report`,
  the collector stack (:func:`~.findings.collecting`,
  :func:`~.findings.emit`) and the suppression-comment helpers;
* ``shapes`` — the shape/dtype propagation pass (``shape_pass``, HT1xx)
  and its graph lints (``lint_pass``, ``frozen_graph_pass``), which the
  auto-planner's cost model reads;
* ``zoo`` — the model zoo's training graphs with canonical feed shapes.

The other passes (sharding, deadlock, memory, numerics, efficiency, ...)
and the executor's ``validate=`` wait for ROADMAP item 17.
"""
from .findings import (Finding, GraphValidationError, Report, collecting,
                       emit, provenance)
from .shapes import frozen_graph_pass, lint_pass, shape_pass

__all__ = ["Finding", "GraphValidationError", "Report", "collecting",
           "emit", "provenance", "shape_pass", "lint_pass",
           "frozen_graph_pass"]
