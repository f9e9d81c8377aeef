"""Structured findings: the common currency of the analysis passes.

Counterpart of ``hetu_tpu/analysis/findings.py``, whole. A
:class:`Finding` is one diagnostic with a stable code (HT1xx shapes,
HT2xx sharding, ...), a severity, and — when the graph node that caused
it is known — the node name and its construction site where the node
records one (``defined_at``; the port's ``Op`` does not yet, ROADMAP
item 17).

The module also hosts the **collector stack**: runtime code that
degrades gracefully with a ``logger.warning`` (e.g.
``parallel/autoplan.py compile_rules``'s HT205) calls :func:`emit`;
when an analysis pass is active (``with collecting(report):``) the
diagnostic becomes a structured finding, otherwise ``emit`` returns
False and the caller keeps its warning fallback.
"""
from __future__ import annotations

import contextlib
import json
import re

__all__ = ["Finding", "Report", "GraphValidationError", "collecting",
           "emit", "provenance", "suppressed", "suppressed_at",
           "SEVERITIES"]

SEVERITIES = ("error", "warn", "info")

# ---------------------------------------------------------------------------
# suppression comments: one grep surface for every waived finding
# ---------------------------------------------------------------------------

# an HT finding code: HT601, HT702, HTP01, HT001, ...
_SUPPRESS_CODE_RE = re.compile(r"HT[A-Z]?\d+")

# canonical marker + per-pass aliases kept for existing annotations
SUPPRESS_MARKERS = ("ht-ok", "jit-ok", "lock-ok")


def suppressed(lines, lineno, code=None, markers=SUPPRESS_MARKERS):
    """Shared suppression-comment check for every source-level pass.

    True when source line ``lineno`` (1-based, ``lines`` =
    ``src.splitlines()``) carries a suppression marker that waives
    ``code``. The house style is ``# ht-ok: <CODE> <reason>`` — the
    annotated form suppresses only that code (the reason is the review
    artifact); a bare marker suppresses every finding on the line.
    ``// ht-ok`` works the same way in C/C++ sources (the wire-contract
    pass lints the native PS files). ``jit-ok`` and ``lock-ok`` are
    kept as pass-local aliases so existing annotations stay valid;
    ``grep -rn 'ht-ok\\|jit-ok\\|lock-ok'`` is the one audit surface.
    """
    if not (0 < lineno <= len(lines)):
        return False
    line = lines[lineno - 1]
    for marker in markers:
        for lead in ("# ", "#", "// ", "//"):
            i = line.find(lead + marker)
            if i < 0:
                continue
            codes = _SUPPRESS_CODE_RE.findall(line[i:])
            if not codes or code is None or code in codes:
                return True
    return False


_SRC_CACHE = {}


def suppressed_at(path, lineno, code=None, markers=SUPPRESS_MARKERS):
    """:func:`suppressed` over a source FILE, with the read cached per
    process — the shared file-layer for passes whose findings anchor at
    a ``defined_at`` construction site rather than an already-parsed
    source (numerics; the wire/protocol passes keep their own parsed
    lines)."""
    lines = _SRC_CACHE.get(path)
    if lines is None:
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            lines = []
        _SRC_CACHE[path] = lines
    return suppressed(lines, lineno, code, markers=markers)


def provenance(node):
    """``file:line`` where the user's code constructed ``node`` (the
    ``Op.defined_at`` capture), or None for nodes built before the
    provenance hook existed / outside any user frame."""
    site = getattr(node, "defined_at", None)
    if not site:
        return None
    return f"{site[0]}:{site[1]}"


class Finding:
    """One diagnostic: code + severity + message (+ node provenance)."""

    __slots__ = ("code", "severity", "message", "node", "where", "data")

    def __init__(self, code, severity, message, node=None, where=None,
                 **data):
        assert severity in SEVERITIES, severity
        self.code = code
        self.severity = severity
        self.message = message
        # accept an Op (name + provenance extracted) or a plain string
        if node is not None and not isinstance(node, str):
            if where is None:
                where = provenance(node)
            node = getattr(node, "name", str(node))
        self.node = node
        self.where = where
        self.data = data

    def to_dict(self):
        out = {"code": self.code, "severity": self.severity,
               "message": self.message}
        if self.node is not None:
            out["node"] = self.node
        if self.where is not None:
            out["where"] = self.where
        if self.data:
            out.update(self.data)
        return out

    def __str__(self):
        loc = ""
        if self.node or self.where:
            parts = [p for p in (self.node, self.where) if p]
            loc = "  (" + " @ ".join(parts) + ")"
        return f"[{self.code}] {self.severity}: {self.message}{loc}"

    def __repr__(self):
        return f"Finding({self})"


class Report:
    """Ordered collection of findings from one analysis run."""

    def __init__(self, findings=None):
        self.findings = list(findings or [])

    def add(self, code, severity, message, node=None, where=None, **data):
        f = Finding(code, severity, message, node=node, where=where,
                    **data)
        self.findings.append(f)
        return f

    def extend(self, findings):
        self.findings.extend(findings)

    def _sev(self, severity):
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self):
        return self._sev("error")

    @property
    def warnings(self):
        return self._sev("warn")

    @property
    def infos(self):
        return self._sev("info")

    @property
    def ok(self):
        return not self.errors

    def by_node(self):
        """{node name: worst severity} — the graphboard overlay index."""
        rank = {s: i for i, s in enumerate(SEVERITIES)}
        out = {}
        for f in self.findings:
            if f.node is None:
                continue
            cur = out.get(f.node)
            if cur is None or rank[f.severity] < rank[cur]:
                out[f.node] = f.severity
        return out

    def to_json(self):
        return json.dumps({
            "errors": len(self.errors), "warnings": len(self.warnings),
            "infos": len(self.infos),
            "findings": [f.to_dict() for f in self.findings]}, indent=2)

    def to_text(self):
        lines = [f"preflight: {len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s), "
                 f"{len(self.infos)} info(s)"]
        for sev in SEVERITIES:
            for f in self._sev(sev):
                lines.append("  " + str(f))
        return "\n".join(lines)

    def __str__(self):
        return self.to_text()

    def __len__(self):
        return len(self.findings)


class GraphValidationError(ValueError):
    """Raised by ``Executor(validate='error')`` when preflight finds
    errors; carries the full report."""

    def __init__(self, report):
        self.report = report
        super().__init__("graph preflight failed:\n" + report.to_text())


# ---------------------------------------------------------------------------
# collector stack: runtime warning sites upgrade to structured findings
# ---------------------------------------------------------------------------

_collectors = []


@contextlib.contextmanager
def collecting(report):
    """Route :func:`emit` calls into ``report`` for the duration."""
    _collectors.append(report)
    try:
        yield report
    finally:
        _collectors.pop()


def emit(code, severity, message, node=None, **data):
    """Add a finding to the innermost active collector. Returns True if
    one was active (caller can skip its logging fallback)."""
    if not _collectors:
        return False
    _collectors[-1].add(code, severity, message, node=node, **data)
    return True
