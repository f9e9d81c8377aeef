"""Pass 8 — the numerics and precision verifier (HT8xx).

Counterpart of ``hetu_tpu/analysis/numerics.py``. An abstract
interpretation over the dataflow graph, scoped to what a
define-then-run training graph can prove cheaply: every node carries

* a **value interval** ``(lo, hi)`` bounding every element of its
  output, seeded from initializer distributions
  (``initializers.BaseInit.interval``), constant values and known op
  semantics (softmax, sigmoid and tanh in their ranges; exp, log and
  rsqrt monotone; norm outputs bounded by ``sqrt(n)·|scale| + |bias|``;
  attention outputs inside the value hull; matmul, conv and reductions
  by ``K·max|A|·max|B|``), propagated through the per-op
  ``infer_range`` protocol (``ops/*.py``) with the shape-aware cases
  handled here, and
* a **precision class** (fp32 / bf16 / fp16 / int) riding the HT1xx
  dtype propagation of ``analysis/shapes.py``, whose dtypes are
  ``torch.dtype`` values: the tables below rest on ``torch.finfo`` and
  ``torch.iinfo`` and accept the numpy and string spellings too.

An unknown feed propagates as *unknown* (no claim, no false positive),
as in the shape pass; the measured-range DB of the dynamic twin
(``analysis/rangecheck.py``) tightens the seeds on re-analysis.

Error codes
-----------
HT801  overflow-prone op in low precision: the derived interval
       exceeds the dtype's largest finite value (an unshifted exp or a
       square in fp16 the classic)                     error (lp) / warn
HT802  low-precision accumulation: a reduction, matmul or conv
       accumulating in bf16/fp16 over N elements whose worst-case
       error N·eps/2 exceeds the bound — accumulate in f32   warn
HT803  integer-exactness loss: float ids (exact only to 2^mantissa),
       an id dtype narrower than the declared table, or an
       int-to-float cast past the target's exact range   error / warn
HT804  div/log/sqrt/rsqrt whose operand interval contains zero with
       no eps or clip guard on the path (interval arithmetic IS the
       guard detector: ``x*x + eps`` excludes zero, a raw softmax
       output does not); also norm eps <= 0 and optimizer eps <= 0  warn
HT805  low-precision cross-replica or pipeline boundary: bf16/fp16
       boundary edges whose derived error bound (hops · eps/2)
       exceeds the declared tolerance, or an fp16 boundary whose
       halved exponent range was never retuned          error / warn
HT806  gradient-underflow risk: a backward path entirely in fp16 with
       no loss scale (an interval below fp16's smallest normal
       upgrades the severity)                           warn / error
HT807  PRNG stream reuse: one key consumed by two independent random
       ops (correlated dropout masks — silent wrongness)     error

The reference's HT803 also warns where a table needs 64-bit ids while
JAX's x64 is off (device feeds canonicalize int64 to int32 there); the
port's feeds keep int64 on the card, so the warning has no counterpart.

Waivers: ``# ht-ok: HT8xx <reason>`` on the user's construction line a
finding points at (``Op.defined_at``), as for every other pass.

CLI: ``python -m hetu_tpu_torch.analysis.numerics [models...] [--json]
[--db PATH]`` sweeps the zoo and exits 1 on any unsuppressed finding.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .findings import suppressed_at
from .shapes import _kind, dtype_name

__all__ = ["numerics_pass", "seed_interval", "stable_keys",
           "boundary_error_bound", "accum_error_bound", "prec_class",
           "dtype_max", "dtype_eps", "dtype_tiny", "exact_int_limit",
           "TRAINING_DRIFT", "MEASURED_EXPAND", "ACC_TOL", "main"]

# trainable parameters drift during training: their initializer seed
# interval widens to ± max(TRAINING_DRIFT · init_absmax, 1.0) so a
# rangecheck run a few steps in still lands inside the static interval;
# the measured-range DB replaces the heuristic after a real run
TRAINING_DRIFT = 16.0

# a measured (lo, hi) from the range DB is re-seeded widened about its
# center by this factor — measured ranges are samples, not bounds
MEASURED_EXPAND = 4.0

# HT802 fires when the worst-case accumulation error N·eps/2 exceeds
# this relative bound
ACC_TOL = 0.05


# ---------------------------------------------------------------------------
# dtype tables
# ---------------------------------------------------------------------------

def _torch_dtype(dt):
    """The ``torch.dtype`` of a torch dtype, a numpy dtype or type, or a
    name (``"bfloat16"``, ``"float16"``); None where it names none (and
    for None: numpy reads ``np.dtype(None)`` as float64)."""
    if dt is None:
        return None
    if isinstance(dt, torch.dtype):
        return dt
    name = dt if isinstance(dt, str) else None
    if name is None:
        try:
            name = np.dtype(dt).name
        except TypeError:
            return None
    got = getattr(torch, name, None)
    return got if isinstance(got, torch.dtype) else None


_FLOAT_CLASS = {torch.float64: "fp64", torch.float32: "fp32",
                torch.bfloat16: "bf16", torch.float16: "fp16"}


def prec_class(dtype):
    """'fp64' | 'fp32' | 'bf16' | 'fp16' | 'int' | None."""
    dt = _torch_dtype(dtype)
    if dt is None:
        return None
    if dt in _FLOAT_CLASS:
        return _FLOAT_CLASS[dt]
    return "int" if _kind(dt) in "iub" else None


def _finfo(dtype):
    return torch.finfo(_torch_dtype(dtype))


def _nmant(dtype):
    """Explicit mantissa bits (eps = 2^-nmant; torch.finfo has no
    ``nmant``)."""
    return int(round(-math.log2(_finfo(dtype).eps)))


def dtype_max(dtype):
    """Largest finite value of a float dtype (fp16's 65504 cliff)."""
    return float(_finfo(dtype).max)


def dtype_eps(dtype):
    """Machine epsilon (bf16: 2^-7 — 8 significand bits in all)."""
    return float(_finfo(dtype).eps)


def dtype_tiny(dtype):
    """Smallest positive normal (fp16: 6.1e-5 — the underflow knee loss
    scaling exists to clear)."""
    return float(_finfo(dtype).tiny)


def exact_int_limit(dtype):
    """Largest N with every integer in [0, N] exactly representable
    (float32: 2^24 — the id-through-float exactness cliff)."""
    return 2 ** (_nmant(dtype) + 1)


def accum_error_bound(dtype, n):
    """Worst-case relative error of summing ``n`` same-sign terms in
    ``dtype``: n·eps/2 (the recursive-summation bound)."""
    return float(n) * dtype_eps(dtype) / 2.0


def boundary_error_bound(dtype, hops=1):
    """Relative error bound of a value crossing ``hops`` low-precision
    cast boundaries (each round trip contributes eps/2): the HT805
    interval math against the collective pipeline's declared rtol."""
    return float(max(1, hops)) * dtype_eps(dtype) / 2.0


# ---------------------------------------------------------------------------
# interval plumbing
# ---------------------------------------------------------------------------

def _absmax(rng):
    return max(abs(rng[0]), abs(rng[1]))


def _hull(*rngs):
    known = [r for r in rngs if r is not None]
    if len(known) != len(rngs):
        return None
    return (min(r[0] for r in known), max(r[1] for r in known))


def _intersect(a, b):
    if a is None:
        return b
    if b is None:
        return a
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo <= hi else a   # disjoint: trust the transfer


def _expand_measured(rng):
    lo, hi = float(rng[0]), float(rng[1])
    c = (lo + hi) / 2.0
    half = max((hi - lo) / 2.0, 1e-6 + 1e-3 * max(abs(lo), abs(hi)))
    return (c - MEASURED_EXPAND * half, c + MEASURED_EXPAND * half)


def stable_keys(topo):
    """Per-node keys stable across rebuilds of the same graph (node
    *names* embed the process-wide id counter, so two builds in one
    process differ): topo position and op type. The measured-range DB
    (``rangecheck.RangeDB``) is keyed on these."""
    return [f"{i:04d}:{n.op_type}" for i, n in enumerate(topo)]


def seed_interval(node, measured=None):
    """The interval seed of a leaf placeholder: the exact min and max of
    a constant value, the initializer's distribution bound (widened by
    TRAINING_DRIFT for a trainable), the measured DB entry where there
    is one, else unknown."""
    iv = None
    value = getattr(node, "tensor_value", None)
    if value is not None:
        try:
            arr = value.asnumpy() if hasattr(value, "asnumpy") \
                else np.asarray(value)
            iv = (float(arr.min()), float(arr.max()))
        except (TypeError, ValueError):
            iv = None
    elif getattr(node, "initializer", None) is not None:
        got = node.initializer.interval()
        iv = (float(got[0]), float(got[1])) if got is not None else None
    if iv is not None and getattr(node, "trainable", False):
        m = max(TRAINING_DRIFT * _absmax(iv), 1.0)
        iv = (-m, m)
    if measured is not None:
        iv = _intersect(iv, _expand_measured(measured))
    return iv


# ---------------------------------------------------------------------------
# the central transfer table: structural and shape-aware ops
# ---------------------------------------------------------------------------

_PASS_THROUGH = {
    "ArrayReshapeOp", "ArrayReshapeGradientOp", "TransposeOp",
    "FlattenOp", "SqueezeOp", "UnsqueezeOp", "BroadcastToOp",
    "BroadcastShapeOp", "SliceOp", "SplitOp", "SplitGradientOp",
    "PadGradientOp", "ConcatGradientOp", "ConcatenateGradientOp",
    "DataH2DOp", "DataD2HOp", "PipelineSendOp",
    "AllReduceCommunicateOp", "GroupAllReduceCommunicateOp",
    "ParameterServerCommunicateOp", "EmbeddingLookUpGradient",
    "DispatchOp",
}

_CONST_RANGE = {
    "OnesLikeOp": (1.0, 1.0),
    "ZerosLikeOp": (0.0, 0.0),
    "OptimizerOp": (0.0, 0.0),
}


def _matmul_k(node, in_shapes):
    a = in_shapes[0]
    if a is None or len(a) < 2:
        return None
    if node.op_type == "MatMulOp":
        return a[0] if node.matmul_attr_trans_A else a[1]
    return a[-2] if node.trans_A else a[-1]


def _transfer(node, in_rngs, in_shapes):
    """The range of a shape-aware or structural op the per-op protocol
    does not cover. None = unknown."""
    ot = node.op_type
    if ot in _CONST_RANGE:
        return _CONST_RANGE[ot]
    if ot in _PASS_THROUGH:
        return in_rngs[0] if in_rngs else None
    if ot in ("ConcatOp", "ConcatenateOp"):
        return _hull(*in_rngs)
    if ot == "PadOp":
        a = in_rngs[0]
        if a is None:
            return None
        c = float(getattr(node, "constant_values", 0) or 0)
        return (min(a[0], c), max(a[1], c))
    if ot == "SliceGradientOp":
        a = in_rngs[0]
        return None if a is None else (min(a[0], 0.0), max(a[1], 0.0))
    if ot in ("MatMulOp", "BatchMatMulOp"):
        a, b = in_rngs[0], in_rngs[1]
        k = _matmul_k(node, in_shapes)
        if a is None or b is None or k is None:
            return None
        m = float(k) * _absmax(a) * _absmax(b)
        if a[0] >= 0 and b[0] >= 0:
            return (float(k) * a[0] * b[0], m)
        return (-m, m)
    if ot == "Conv2dOp":
        a, w = in_rngs[0], in_rngs[1]
        f = in_shapes[1]
        if a is None or w is None or f is None or len(f) != 4:
            return None
        k = f[1] * f[2] * f[3]
        m = float(k) * _absmax(a) * _absmax(w)
        return (-m, m)
    if ot in ("ReduceSumOp", "ReduceSumAxisZeroOp"):
        a = in_rngs[0]
        s = in_shapes[0]
        if a is None or s is None:
            return None
        if ot == "ReduceSumAxisZeroOp":
            n = s[0] if s else 1
        else:
            n = 1
            for ax in node.axes:
                if ax < len(s):
                    n *= s[ax]
        return (min(n * a[0], a[0]), max(n * a[1], a[1]))
    if ot == "ReduceMeanOp":
        return in_rngs[0]
    if ot in ("BroadcastShapeGradSourceOp", "UnbroadcastOp"):
        # sums the adjoint over the broadcast axes; without the exact
        # fan-in no claim
        return None
    if ot in ("FlashAttentionOp", "RingAttentionOp",
              "UlyssesAttentionOp"):
        # softmax rows are convex weights: the output lies in v's hull
        return in_rngs[2] if len(in_rngs) > 2 else None
    return None


def _domain_violation(node, in_rngs):
    """HT804's table: (what, operand interval, why) where an operand's
    interval leaves the op's domain, else None."""
    ot = node.op_type
    if ot == "LogOp":
        a = in_rngs[0]
        if a is not None and a[0] <= 0.0:
            return ("log", a, "operand interval reaches <= 0")
    elif ot == "SqrtOp":
        a = in_rngs[0]
        if a is not None and a[0] < 0.0:
            return ("sqrt", a, "operand interval reaches < 0")
    elif ot == "ReciprocalSqrtOp":
        a = in_rngs[0]
        if a is not None and a[0] <= 0.0:
            return ("rsqrt", a, "operand interval reaches <= 0")
    elif ot == "DivOp":
        b = in_rngs[1]
        if b is not None and b[0] <= 0.0 <= b[1]:
            return ("div", b, "denominator interval contains 0")
    elif ot == "DivConstOp":
        a = in_rngs[0]
        if a is not None and a[0] <= 0.0 <= a[1]:
            return ("div", a, "denominator interval contains 0")
    elif ot == "PowerOp":
        a = in_rngs[0]
        if getattr(node, "p", 1) < 0 and a is not None \
                and a[0] <= 0.0 <= a[1]:
            return ("pow", a, "negative power over an interval "
                              "containing 0")
    return None


def _suppressed_node(node, code):
    site = getattr(node, "defined_at", None)
    if not site:
        return False
    return suppressed_at(site[0], site[1], code)


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def _stage_count(topo):
    """Distinct devices across the graph's contexts: the collective
    pipeline's stage count for the HT805 hop bound."""
    seen = set()
    for n in topo:
        ctxs = getattr(getattr(n, "raw_ctx", None), "_contexts", None)
        if not ctxs:
            continue
        for c in ctxs:
            for cc in (c if isinstance(c, tuple) else (c,)):
                seen.add((getattr(cc, "hostname", None),
                          getattr(cc, "device_id", None)))
    return max(1, len(seen))


def _canon_low_prec(spec):
    """'bfloat16' | 'float16' | None from any spelling the collective
    pipeline's boundary dtype accepts: strings or dtype objects
    (``np.float16``, ``torch.bfloat16``)."""
    if spec is None:
        return None
    if isinstance(spec, str):
        name = spec.lower()
        if name in ("bf16", "bfloat16"):
            return "bfloat16"
        if name in ("fp16", "f16", "float16", "half"):
            return "float16"
        return None
    dt = _torch_dtype(spec)
    return {torch.bfloat16: "bfloat16",
            torch.float16: "float16"}.get(dt)


def _session_dtype(config):
    """The session's compute dtype where it is bf16 or fp16, else None."""
    dt = _torch_dtype(getattr(config, "dtype", None)) \
        if config is not None else None
    return dt if prec_class(dt) in ("bf16", "fp16") else None


def numerics_pass(topo, report, shapes=None, dtypes=None,
                  feed_shapes=None, config=None, measured=None,
                  acc_tol=ACC_TOL, boundary_rtol=None):
    """Run the HT8xx checks over a topo-sorted graph; returns the derived
    ``{node: (lo, hi) or None}`` interval map.

    ``shapes``/``dtypes`` are the shape pass's outputs (recomputed here
    where absent); ``measured`` is a ``{stable_key: (lo, hi)}`` map from
    the range DB that tightens the seeds; ``config`` (a HetuConfig)
    enables the mixed-precision flow checks (HT805/HT806). Findings
    whose construction line carries ``# ht-ok: HT8xx`` are waived."""
    from ..ops.variable import PlaceholderOp
    from ..optimizer import OptimizerOp

    if shapes is None or dtypes is None:
        from .findings import Report
        from .shapes import shape_pass
        dtypes = {} if dtypes is None else dtypes
        shapes = shape_pass(topo, Report(), feed_shapes=feed_shapes,
                            dtypes_out=dtypes)

    keys = stable_keys(topo)
    measured = measured or {}

    # Executor(dtype=torch.bfloat16 / float16) casts every float param
    # and feed to the compute dtype at the step: the session's EFFECTIVE
    # precision for float nodes is config.dtype, not the declared fp32
    # the graph was built with — without this HT801/HT802 are blind on
    # the mixed-precision path
    cfg_dt = _session_dtype(config)

    def eff_dtype(n):
        dt = _torch_dtype(dtypes.get(n))
        if cfg_dt is not None and dt is not None and dt.is_floating_point:
            return cfg_dt
        return dt

    def add(code, severity, message, node):
        if _suppressed_node(node, code):
            return
        report.add(code, severity, message, node=node)

    ranges = {}
    for i, node in enumerate(topo):
        in_rngs = [ranges.get(x) for x in node.inputs]
        in_shapes = [shapes.get(x) for x in node.inputs]
        if isinstance(node, PlaceholderOp):
            rng = seed_interval(node, measured=measured.get(keys[i]))
        else:
            rng = None
            infer = getattr(node, "infer_range", None)
            if infer is not None:
                try:
                    rng = infer(in_rngs, in_shapes)
                except Exception:   # noqa: BLE001 — a bad bound is no bound
                    rng = None
            if rng is None:
                rng = _transfer(node, in_rngs, in_shapes)
            if keys[i] in measured:
                rng = _intersect(rng, _expand_measured(measured[keys[i]]))
        if rng is not None and (math.isnan(rng[0]) or math.isnan(rng[1])
                                or rng[0] > rng[1]):
            rng = None      # a degenerate bound is no bound: a NaN
            # interval compares False everywhere and would disarm every
            # check downstream
        ranges[node] = rng

        dt = eff_dtype(node)
        prec = prec_class(dt)

        # HT804 — domain hazards (a zero-crossing operand, no guard)
        hit = _domain_violation(node, in_rngs)
        if hit is not None:
            what, iv, why = hit
            add("HT804", "warn",
                f"{node.op_type} {node.name}: {why} "
                f"([{iv[0]:.3g}, {iv[1]:.3g}]) with no eps/clip guard "
                f"on the path — add a clip/+eps (interval arithmetic "
                f"recognizes the guard and clears this)", node)
        eps = getattr(node, "eps", None)
        if eps is not None and "Normalization" in node.op_type \
                and "Gradient" not in node.op_type and eps <= 0:
            add("HT804", "warn",
                f"{node.op_type} {node.name}: eps={eps} — the rsqrt "
                f"of the variance is unguarded at zero variance", node)
        if isinstance(node, OptimizerOp):
            oeps = getattr(node.optimizer, "epsilon",
                           getattr(node.optimizer, "eps", None))
            if oeps is not None and oeps <= 0:
                add("HT804", "warn",
                    f"{node.name}: optimizer eps={oeps} — the "
                    f"sqrt(v)+eps denominator is unguarded", node)

        # HT801 — the derived interval exceeds the dtype's largest value
        if prec in ("fp16", "bf16", "fp32", "fp64") and rng is not None:
            am = _absmax(rng)
            fmax = dtype_max(dt)
            explosive = node.op_type in ("ExpOp", "PowerOp", "MulOp",
                                         "MatMulOp", "BatchMatMulOp")

            # only the node that CREATES the overflow fires: an input
            # already past ITS OWN dtype's max would re-report one root
            # cause on every consumer. Each input is judged against its
            # own precision: an fp32 interval past 65504 cast to fp16 is
            # overflow created by the cast.
            def _in_bounds(inp, r):
                if r is None:
                    return True
                idt = eff_dtype(inp)
                if prec_class(idt) not in ("fp16", "bf16", "fp32",
                                           "fp64"):
                    return True
                return _absmax(r) <= dtype_max(idt)
            created = all(_in_bounds(inp, r)
                          for inp, r in zip(node.inputs, in_rngs))
            if created and ((math.isfinite(am) and am > fmax) or
                            (math.isinf(am) and explosive
                             and all(r is not None for r in in_rngs))):
                sev = "error" if prec in ("fp16", "bf16") else "warn"
                add("HT801", sev,
                    f"{node.op_type} {node.name}: derived interval "
                    f"[{rng[0]:.3g}, {rng[1]:.3g}] exceeds "
                    f"{dtype_name(dt)} max {fmax:.3g} — overflow-prone "
                    f"in {prec} (shift the operand, e.g. subtract the "
                    f"max before exp, or compute in fp32)", node)

        # HT802 — low-precision accumulation over N elements
        if prec in ("fp16", "bf16"):
            n_acc = None
            if node.op_type in ("MatMulOp", "BatchMatMulOp"):
                n_acc = _matmul_k(node, in_shapes)
            elif node.op_type == "Conv2dOp" and in_shapes[1] is not None \
                    and len(in_shapes[1]) == 4:
                f = in_shapes[1]
                n_acc = f[1] * f[2] * f[3]
            elif node.op_type in ("ReduceSumOp", "ReduceMeanOp") \
                    and in_shapes[0] is not None:
                n_acc = 1
                for ax in node.axes:
                    if ax < len(in_shapes[0]):
                        n_acc *= in_shapes[0][ax]
            elif node.op_type == "ReduceSumAxisZeroOp" \
                    and in_shapes[0]:
                n_acc = in_shapes[0][0]
            if n_acc is not None and accum_error_bound(dt, n_acc) > acc_tol:
                add("HT802", "warn",
                    f"{node.op_type} {node.name}: accumulates {n_acc} "
                    f"elements in {prec} (worst-case relative error "
                    f"{accum_error_bound(dt, n_acc):.2g} > {acc_tol:g})"
                    f" — accumulate in f32 (an f32 operand cast, or the "
                    f"executor's dtype= off) and cast the result", node)

        # HT803 — integer-exactness loss on the id paths
        if node.op_type == "EmbeddingLookUp":
            tbl, idx = node.inputs
            rows = None
            tshape = shapes.get(tbl) or getattr(tbl, "shape", None)
            if tshape:
                rows = tshape[0]
            idt = _torch_dtype(dtypes.get(idx))
            if idt is not None and idt.is_floating_point:
                limit = exact_int_limit(idt)
                if rows is not None and rows > limit:
                    add("HT803", "error",
                        f"{node.name}: ids arrive as {dtype_name(idt)} "
                        f"but the table declares {rows} rows — float ids "
                        f"are exact only to 2^{_nmant(idt) + 1} = "
                        f"{limit}; feed integer ids", node)
                else:
                    add("HT803", "warn",
                        f"{node.name}: float-dtype ids "
                        f"({dtype_name(idt)}) — exactness is lost past "
                        f"{exact_int_limit(idt)} ids; the runtime "
                        f"rejects float id feeds (feed int32/int64)",
                        node)
            elif idt is not None and _kind(idt) in "iu" \
                    and rows is not None \
                    and rows - 1 > torch.iinfo(idt).max:
                add("HT803", "error",
                    f"{node.name}: id dtype {dtype_name(idt)} cannot "
                    f"address the declared {rows}-row table — widen the "
                    f"id dtype", node)
        if node.op_type == "CastOp" and prec in ("fp16", "bf16", "fp32"):
            src = _torch_dtype(dtypes.get(node.inputs[0]))
            src_rng = in_rngs[0]
            if src is not None and _kind(src) in "iu" \
                    and src_rng is not None \
                    and _absmax(src_rng) > exact_int_limit(dt):
                add("HT803", "error",
                    f"{node.name}: casts integers up to "
                    f"{_absmax(src_rng):.3g} through {dtype_name(dt)}, "
                    f"which is exact only to {exact_int_limit(dt)} — ids "
                    f"pass 2^{_nmant(dt) + 1} and collide", node)

    # HT807 — PRNG stream reuse across independent random ops
    fams = {}
    for node in topo:
        if not (hasattr(node, "keep_prob") or hasattr(node, "rng_key")):
            continue
        fwd = getattr(node, "forward_node", None)
        key = getattr(node, "rng_key", None)
        if key is None:
            key = fwd.id if fwd is not None else node.id
        fam = fwd.id if fwd is not None else node.id
        fams.setdefault(key, []).append((fam, node))
    for key, members in fams.items():
        owners = {}
        for fam, node in members:
            owners.setdefault(fam, node)
        if len(owners) > 1:
            names = ", ".join(n.name for n in owners.values())
            first = next(iter(owners.values()))
            if not any(_suppressed_node(n, "HT807")
                       for n in owners.values()):
                report.add(
                    "HT807", "error",
                    f"PRNG key {key} is consumed by {len(owners)} "
                    f"independent random ops ({names}) — their masks "
                    f"are CORRELATED, not independent; give each op "
                    f"its own key", node=first)

    _config_checks(topo, ranges, dtypes, config, boundary_rtol, add)
    return ranges


def _config_checks(topo, ranges, dtypes, config, boundary_rtol, add):
    """HT805/HT806 — the mixed-precision flow checks that need the
    session's config (the pipeline boundary dtype, the executor's
    compute dtype)."""
    from ..optimizer import OptimizerOp

    opt_nodes = [n for n in topo if isinstance(n, OptimizerOp)]

    # HT806: a backward path entirely in fp16 with no loss scale
    cfg_fp16 = _session_dtype(config) == torch.float16
    for opt_op in opt_nodes:
        fp16_grads = [g for g in opt_op.inputs
                      if prec_class(dtypes.get(g)) == "fp16"]
        all_fp16 = cfg_fp16 or \
            (fp16_grads and len(fp16_grads) == len(opt_op.inputs))
        if not all_fp16:
            continue
        scale = getattr(opt_op.optimizer, "loss_scale", None)
        if scale is not None and scale > 1:
            continue
        sev = "warn"
        tiny = dtype_tiny(torch.float16)
        small = [g for g in fp16_grads
                 if ranges.get(g) is not None
                 and _absmax(ranges[g]) < tiny]
        if small:
            sev = "error"
        add("HT806", sev,
            f"{opt_op.name}: the backward path runs entirely in fp16 "
            f"with no loss scale — gradients below {tiny:.2g} (fp16 "
            f"min-normal) flush to zero"
            + (f"; {len(small)} gradient(s) derive an interval below "
               f"it already" if small else "")
            + " — pass loss_scale= to the optimizer (gradients are "
              "unscaled inside the update)", opt_op)

    if config is None:
        return
    ppo = getattr(config, "pp_options", None) or {}
    bdt = _canon_low_prec(ppo.get("boundary_dtype"))
    if getattr(config, "pipeline_mode", None) == "collective" and bdt:
        if boundary_rtol is None:
            boundary_rtol = ppo.get("boundary_rtol")
        if boundary_rtol is None:
            from ..parallel.collective_pp import BOUNDARY_RTOL
            boundary_rtol = BOUNDARY_RTOL
        hops = max(1, _stage_count(topo) - 1)
        bound = boundary_error_bound(bdt, hops)
        # through the waiver-aware ``add``: a deliberately retuned
        # boundary is waived with '# ht-ok: HT805' on the anchor's line
        anchor = topo[-1]
        if bound > boundary_rtol:
            add("HT805", "error",
                f"collective-pipeline boundary in {bdt}: derived "
                f"relative error bound {bound:.2e} over {hops} hop(s) "
                f"exceeds the declared tolerance {boundary_rtol:g} — "
                f"retune boundary_rtol or keep fp32 boundaries",
                anchor)
        if bdt == "float16":
            add("HT805", "warn",
                f"collective-pipeline boundary widened to fp16: the "
                f"exponent range halves (max {dtype_max(bdt):.0f}) — "
                f"activations beyond it overflow at the stage "
                f"boundary; verify the measured activation absmax "
                f"(rangecheck) and retune before shipping", anchor)

    # HT805: explicit low-precision cross-replica reduction edges
    for node in topo:
        if node.op_type in ("AllReduceCommunicateOp",
                            "GroupAllReduceCommunicateOp"):
            prec = prec_class(dtypes.get(node))
            if prec in ("bf16", "fp16"):
                add("HT805", "warn",
                    f"{node.name}: cross-replica reduction in {prec} — "
                    f"per-hop relative error "
                    f"~{dtype_eps(dtypes.get(node)) / 2:.2e} compounds "
                    f"with the replica count; reduce in fp32 or declare "
                    f"the tolerance", node)


# ---------------------------------------------------------------------------
# CLI: the zoo sweep, gating on any unsuppressed finding
# ---------------------------------------------------------------------------

def check_zoo(names=None, measured_db=None):
    """{model: Report} of numerics-only findings over the zoo graphs."""
    from . import zoo
    from .findings import Report
    from .shapes import shape_pass
    from ..graph.autodiff import find_topo_sort

    out = {}
    for name in names or sorted(zoo.ZOO):
        eval_nodes, feed_shapes = zoo.build(name)
        topo = find_topo_sort(list(eval_nodes))
        dtypes = {}
        shapes = shape_pass(topo, Report(), feed_shapes=feed_shapes,
                            dtypes_out=dtypes)
        measured = None
        if measured_db is not None:
            measured = measured_db.get(name)
        report = Report()
        numerics_pass(topo, report, shapes=shapes, dtypes=dtypes,
                      config=None, measured=measured)
        out[name] = report
    return out


def main(argv=None):
    import argparse
    import json
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m hetu_tpu_torch.analysis.numerics",
        description="interval + dtype abstract interpretation over the "
                    "zoo graphs (HT8xx); exits 1 on any unsuppressed "
                    "finding")
    parser.add_argument("models", nargs="*",
                        help="zoo model names (default: all)")
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--db", default=None, metavar="PATH",
                        help="measured-range DB (rangecheck output) "
                             "that tightens the interval seeds")
    args = parser.parse_args(argv)

    from . import zoo
    names = args.models or sorted(zoo.ZOO)
    unknown = [n for n in names if n not in zoo.ZOO]
    if unknown:
        parser.error(f"unknown zoo model(s) {unknown}")

    db = None
    if args.db:
        from .rangecheck import RangeDB
        db = RangeDB(args.db)
    reports = check_zoo(names, measured_db=db)
    total = sum(len(r) for r in reports.values())
    if args.json:
        print(json.dumps(
            {name: json.loads(r.to_json())
             for name, r in reports.items()}, indent=2))
    else:
        for name, r in reports.items():
            status = "FAIL" if len(r) else "ok"
            print(f"== {name}: {status} ({len(r)} finding(s))")
            for f in r.findings:
                print("   " + str(f))
        print(f"numerics: {total} unsuppressed finding(s) across "
              f"{len(names)} zoo model(s)")
    if total:
        print("numerics: FAILED — guard the op, or waive with "
              "'# ht-ok: HT8xx <reason>' on the construction line",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
