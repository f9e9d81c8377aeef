#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``hetu_tpu_torch``).

    python3 chip_smoke.py [--seed N] [--out FILE]

Run from a checkout of the repository on a machine with one NVIDIA GPU
and the CUDA toolkit. It builds every hand-written kernel from the
sources in the checkout, drives the port's two main paths — GPT-2-small
(full width, random weights from a seed) served through
``ContinuousBatchingEngine``, and the same model trained with Adam in
bf16 through ``Executor.run`` (B=8, S=1024) — checks every kernel
against its plain PyTorch version on the card, and prints one JSON
object per line (``--out`` also writes them to FILE):

* ``device``  the card (name and power limit from nvidia-smi), torch and
  CUDA versions;
* ``build``   seconds spent compiling each kernel source, and ptxas's
  summary;
* ``kernel_shapes`` per kernel, one row per checked shape: error
  against the plain version, median times of the kernel, of the plain
  version and of the one PyTorch call computing the same function, and
  the least time the card could take (``bound_ms``);
* ``serve``   per pass: tokens/s, TTFT p50, decode step ms, kernel
  launches, and the token-parity check against the plain attention;
* ``train``   tokens/s, step ms p50, the loss of every step, kernel
  launches, peak memory, the device idle share and time by kernel
  category of one profiled step, and the step-1 parity check against
  the plain K2–K4;
* ``crossover`` per sequence length, the fused training attention
  (K2 + K3 + K4) against K1 + the composed autograd backward;
* ``kernels`` per kernel (K1 flash forward, K2 forward with logsumexp,
  K3 backward dK/dV, K4 backward dQ): launches on its main path, the
  largest error against the plain version by dtype over every checked
  shape, and ``kernel_shapes``' row at the main path's shape;

then the card line as ``nvidia-smi`` prints it, and last
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. It also exits non-zero without a
CUDA device, or when ``hetu_tpu_torch`` is not beside it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: f32 on the CUDA cores, bf16 on the
# tensor cores; HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12

# the GPT-2-small widths (bench.py's gpt2-small)
GPT2_SMALL = dict(vocab_size=50257, hidden_size=768, num_hidden_layers=12,
                  num_attention_heads=12, max_position_embeddings=1024)
NUM_REQUESTS = 16
MAX_NEW = 32
NUM_BLOCKS = 512            # 512 x 16 positions: 8 concurrent 800-token seqs
MARGIN_TOL = 1e-3           # top-2 logit gap below which argmax may flip

# the training pass: bench.py:1103-1118 (B=8, S=1024, bf16, Adam 1e-4)
TRAIN_BATCH = 8
TRAIN_WARMUP, TRAIN_STEPS = 2, 6
TRAIN_LR = 1e-4
# step-1 parity, kernels vs plain K2-K4: the bf16 loss within one bf16
# ulp of its magnitude; the layer-0 q/k/v weight grads within 2e-2 of
# their largest element (dq/dk/dv differ by bf16 roundings summed over
# the 8192 tokens of the batch)
GRAD_PARITY_TOL = 2e-2

# kernel checks of K2-K4 (float32 / bfloat16): the forward as K1's; the
# gradients looser in bf16, where p and dS are each rounded before a
# product summed over S
FWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
CROSSOVER_SEQ = (128, 256, 512, 1024, 2048)
# device kernels of the profiled training step, by name (first match)
PROFILE_CATEGORIES = (
    ("flash attention (K1-K4)", ("flash_fwd_kernel", "flash_bwd_")),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("reduction", ("reduce_kernel",)),
    ("index / scatter / gather", ("index", "scatter", "gather", "unique",
                                  "sort", "radix")),
    ("elementwise", ("elementwise", "copy")),
)


def log(msg):
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# per kernel: (flops per b*h*s*s*d, [b,h,s,d] tensors moved, f32 [b,h,s]
# vectors moved): K1 reads q, k, v and writes o; K2 also writes lse; K3
# reads q, k, v, dO, lse, D and writes dk, dv; K4 the same reads, dq out
FLASH_WORK = {"K1": (4, 4, 0), "K2": (4, 4, 1), "K3": (8, 6, 2),
              "K4": (6, 5, 2)}


def flash_bound(b, h, s, d, dtype_name, causal, masked, kind="K1"):
    """Least time for a flash kernel's work: max(flops / peak for the
    dtype, bytes moved once (+ mask rows) / HBM bandwidth). Causal halves
    the flops."""
    per, tensors, vectors = FLASH_WORK[kind]
    itemsize = 4 if dtype_name == "float32" else 2
    flops = per * b * h * s * s * d * (0.5 if causal else 1.0)
    nbytes = (tensors * b * h * s * d * itemsize + vectors * b * h * s * 4
              + (b * s * 4 if masked else 0))
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


# ---------------------------------------------------------------------------
# kernels: K1 against its plain version at every listed shape
# ---------------------------------------------------------------------------

def check_flash_fwd(torch, seed):
    import torch.nn.functional as F
    from hetu_tpu_torch.ops.flash_attention import (
        NEG_INF, flash_attention, flash_attention_plain)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    h, d = 12, 64
    rows, failures = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for b in (1, 4):
            for s in (8, 128, 512, 1024):
                g = torch.Generator(device="cuda").manual_seed(seed + s + b)
                q, k, v = (torch.randn(b, h, s, d, generator=g,
                                       device="cuda").to(dtype)
                           for _ in range(3))
                for masked in (False, True):
                    mask = None
                    if masked:
                        mask = torch.zeros(b, 1, 1, s, device="cuda")
                        mask[0, ..., s // 2:] = -1e9
                        if b > 1:
                            mask[-1] = -1e9     # a fully masked row
                    for causal in (False, True):
                        scale = d ** -0.5
                        out = flash_attention(q, k, v, mask, scale, causal)
                        ref = flash_attention_plain(q, k, v, mask, scale,
                                                    causal)
                        torch.cuda.synchronize()
                        diff = (out.float() - ref.float()).abs()
                        err = float(diff.max())
                        rel = float((diff / ref.float().abs()
                                     .clamp_min(1.0)).max())
                        ok = bool(torch.allclose(out.float(), ref.float(),
                                                 atol=tol[dtype],
                                                 rtol=tol[dtype]))
                        lib_mask = mask
                        if causal:
                            cm = torch.full((s, s), NEG_INF,
                                            device="cuda").triu(1)
                            lib_mask = cm if mask is None else mask + cm
                        if lib_mask is not None:
                            lib_mask = lib_mask.to(dtype)

                        def library():
                            return F.scaled_dot_product_attention(
                                q, k, v, attn_mask=lib_mask, scale=scale)
                        bound, by = flash_bound(b, h, s, d, dname, causal,
                                                masked)
                        row = {"b": b, "h": h, "s": s, "d": d,
                               "dtype": dname, "causal": causal,
                               "mask": masked, "max_abs_err": err,
                               "max_rel_err": rel, "tol": tol[dtype],
                               "ok": ok,
                               "ms": median_ms(torch, lambda: flash_attention(
                                   q, k, v, mask, scale, causal)),
                               "plain_ms": median_ms(
                                   torch, lambda: flash_attention_plain(
                                       q, k, v, mask, scale, causal),
                                   reps=3, warmup=1),
                               "library_ms": median_ms(torch, library),
                               "bound_ms": bound, "bound_by": by}
                        rows.append(row)
                        if not ok:
                            failures.append(row)
    if failures:
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"at {len(failures)} shape(s): {failures}")
    return rows


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


def _sdpa_flash(torch, q, k, v, scale, causal):
    """PyTorch's own flash-attention forward (bf16 only, no mask): output,
    logsumexp and what its backward needs. Timing yardstick only."""
    return torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, causal, False, scale=scale)


def check_flash_train_kernels(torch, seed):
    """K2, K3 and K4 against their plain versions at every checked shape:
    B in (1, 8), H=12, D=64, S in (128, 512, 1024), mask on/off, causal
    on/off, f32 and bf16. The padding mask leaves every row an unmasked
    key (a fully masked row has p = exp(s - lse) = 1 under the
    reference's formula, which nothing pins). K3 and K4 run from the
    kernel's own o and lse, so each is held apart from K2's roundings.
    Returns {kernel: [row per shape]}."""
    from hetu_tpu_torch.ops import flash_attention as fa
    h, d = 12, 64
    rows = {"K2": [], "K3": [], "K4": []}
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for b in (1, TRAIN_BATCH):
            for s in (128, 512, 1024):
                g = torch.Generator(device="cuda").manual_seed(seed + s + b)
                q, k, v, do = (torch.randn(b, h, s, d, generator=g,
                                           device="cuda").to(dtype)
                               for _ in range(4))
                for masked in (False, True):
                    mask = None
                    if masked:
                        mask = torch.zeros(b, 1, 1, s, device="cuda")
                        mask[0, ..., s // 2:] = -1e9
                        mask[-1, ..., 3 * s // 4:] = -1e9
                    for causal in (False, True):
                        args = (q, k, v, mask)
                        scale = d ** -0.5
                        o, lse = fa.flash_attention_with_lse(
                            *args, scale, causal)
                        bwd = (*args, o, lse, do, scale, causal)
                        dk, dv = fa.flash_attention_bwd_dkv(*bwd)
                        dq = fa.flash_attention_bwd_dq(*bwd)
                        ro, rlse = fa.flash_attention_with_lse_plain(
                            *args, scale, causal)
                        rdk, rdv = fa.flash_attention_bwd_dkv_plain(*bwd)
                        rdq = fa.flash_attention_bwd_dq_plain(*bwd)
                        torch.cuda.synchronize()
                        lib = {"K2": None, "K3": None, "K4": None}
                        if dtype == torch.bfloat16 and not masked:
                            res = _sdpa_flash(torch, q, k, v, scale, causal)
                            lib["K2"] = median_ms(torch, lambda: _sdpa_flash(
                                torch, q, k, v, scale, causal))
                            # one call computes dq, dk and dv: K3's row
                            # carries it
                            lib["K3"] = median_ms(
                                torch, lambda: torch.ops.aten.
                                _scaled_dot_product_flash_attention_backward(
                                    do, q, k, v, res[0], res[1], res[2],
                                    res[3], res[4], res[5], 0.0, causal,
                                    res[6], res[7], scale=scale))
                        checks = {
                            "K2": ((o, ro), (lse, rlse), FWD_TOL[dname],
                                   lambda: fa.flash_attention_with_lse(
                                       *args, scale, causal),
                                   lambda: fa.flash_attention_with_lse_plain(
                                       *args, scale, causal)),
                            "K3": ((dk, rdk), (dv, rdv), BWD_TOL[dname],
                                   lambda: fa.flash_attention_bwd_dkv(*bwd),
                                   lambda: fa.flash_attention_bwd_dkv_plain(
                                       *bwd)),
                            "K4": ((dq, rdq), (dq, rdq), BWD_TOL[dname],
                                   lambda: fa.flash_attention_bwd_dq(*bwd),
                                   lambda: fa.flash_attention_bwd_dq_plain(
                                       *bwd)),
                        }
                        for kind, (p1, p2, tol, kern, plain) in \
                                checks.items():
                            ok = all(bool(torch.allclose(
                                a.float(), w.float(), atol=tol, rtol=tol))
                                for a, w in (p1, p2))
                            bound, by = flash_bound(b, h, s, d, dname,
                                                    causal, masked, kind)
                            row = {"b": b, "h": h, "s": s, "d": d,
                                   "dtype": dname, "causal": causal,
                                   "mask": masked,
                                   "max_abs_err": max(_err(*p1), _err(*p2)),
                                   "tol": tol, "ok": ok,
                                   "ms": median_ms(torch, kern),
                                   "plain_ms": median_ms(torch, plain,
                                                         reps=3, warmup=1),
                                   "library_ms": lib[kind],
                                   "bound_ms": bound, "bound_by": by}
                            rows[kind].append(row)
                            if not ok:
                                failures.append((kind, row))
    if failures:
        raise AssertionError(f"K2-K4 disagree with their plain versions at "
                             f"{len(failures)} case(s): {failures}")
    return rows


# ---------------------------------------------------------------------------
# train: the second main path
# ---------------------------------------------------------------------------

def _bf16_ulp(x):
    """One bfloat16 ulp at the magnitude of x (8 significand bits)."""
    return 2.0 ** (int(np.floor(np.log2(abs(x)))) - 7)


def train(torch, seed, card):
    """GPT-2-small causal LM, the graph of bench.py:1103-1118, trained
    with Adam in bf16 through Executor.run on one fixed batch. First a
    parity step with the plain K2-K4 swapped in (before the main path
    window), then the main path: warm-up and timed steps with the
    kernels; then one profiled step."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import attention as attn
    from hetu_tpu_torch.ops import flash_attention as fa

    cfg = M.GPTConfig(**GPT2_SMALL, hidden_dropout_prob=0.0,
                      use_flash_attention=True)
    seq = cfg.max_position_embeddings
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _, loss = M.GPTLMHeadModel(cfg)(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    opt = ht.optim.AdamOptimizer(learning_rate=TRAIN_LR)
    train_op = opt.minimize(lm)
    # the layer-0 qkv weight's gradient: its column blocks are dq, dk, dv
    # of layer 0 mapped back through the qkv projection
    qkv0 = next(i for i, p in enumerate(opt.params)
                if p.name == "gpt_h0_attn_qkv_weights")
    nodes = [lm, train_op.inputs[qkv0], train_op]
    rng = np.random.RandomState(seed)
    x = rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, seq))
    y = np.concatenate([x[:, 1:], np.full((TRAIN_BATCH, 1), -1)], axis=1)
    feeds = {ids: torch.as_tensor(x, device="cuda"),
             labels: torch.as_tensor(y, device="cuda")}

    kernels = (attn.flash_attention_with_lse, attn.flash_attention_bwd)
    attn.flash_attention_with_lse = fa.flash_attention_with_lse_plain
    attn.flash_attention_bwd = fa.flash_attention_bwd_plain
    try:
        exe = ht.Executor(nodes, dtype=torch.bfloat16)
        out = exe.run(feed_dict=feeds)
        plain_loss = float(out[0].asnumpy())
        plain_grad = out[1].tensor.float().clone()
    finally:
        attn.flash_attention_with_lse, attn.flash_attention_bwd = kernels
    del exe, out
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    exe = ht.Executor(nodes, dtype=torch.bfloat16)
    setup_s = time.perf_counter() - t0
    losses, step_ms = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        out = exe.run(feed_dict=feeds)
        losses.append(float(out[0].asnumpy()))      # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            kernel_grad = out[1].tensor.float().clone()
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)           # main path ends
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_WARMUP + TRAIN_STEPS
    layers = cfg.num_hidden_layers
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss not finite and falling: "
                             f"{losses}")
    want = {fa.K1: 0, fa.K2: layers * steps, fa.K3: layers * steps,
            fa.K4: layers * steps}
    got = {key: launches.get(key, 0) for key in want}
    if got != want:
        raise AssertionError(f"train launches {got}, want {want}")
    hidden = cfg.hidden_size
    grad_err = {
        part: float((kernel_grad[:, i * hidden:(i + 1) * hidden]
                     - plain_grad[:, i * hidden:(i + 1) * hidden]).abs().max()
                    / plain_grad[:, i * hidden:(i + 1) * hidden].abs().max())
        for i, part in enumerate("qkv")}
    loss_tol = _bf16_ulp(plain_loss)
    parity = {"loss_kernels": losses[0], "loss_plain": plain_loss,
              "loss_tol": loss_tol, "grad_rel_err": grad_err,
              "grad_tol": GRAD_PARITY_TOL}
    if abs(losses[0] - plain_loss) > loss_tol or \
            max(grad_err.values()) > GRAD_PARITY_TOL:
        raise AssertionError(f"step-1 parity with the plain K2-K4 failed: "
                             f"{parity}")
    timed = step_ms[TRAIN_WARMUP:]
    tokens = TRAIN_BATCH * seq
    profile = profile_train_step(torch, exe, feeds)
    return {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "batch": TRAIN_BATCH, "seq": seq, "dtype": "bfloat16",
            "optimizer": "Adam", "lr": TRAIN_LR, "seed": seed,
            "executor_setup_s": setup_s,
            "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_STEPS,
            "tokens_per_s": tokens * len(timed) / (sum(timed) / 1e3),
            "step_ms_p50": float(np.median(timed)), "step_ms": step_ms,
            "losses": losses, "launches": got,
            "peak_memory_bytes": int(peak), "parity": parity,
            "profile": profile}, launches


def profile_train_step(torch, exe, feeds):
    """One more training step under torch.profiler: device busy time over
    the CUDA kernels and copies, the idle share of the step's wall time
    (the profiler's own host overhead included), and the kernels that
    took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(feed_dict=feeds)[0].asnumpy()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]

    def kernel_ms(name):
        return sum(e.self_device_time_total for e in dev
                   if name in e.key) / 1e3
    by_category = {}
    for e in dev:
        cat = next((c for c, keys in PROFILE_CATEGORIES
                    if any(key in e.key.lower() for key in keys)), "other")
        ms, n = by_category.get(cat, (0.0, 0))
        by_category[cat] = (ms + e.self_device_time_total / 1e3,
                            n + e.count)
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if dev else None,
            "device_idle_share": 1.0 - busy / wall_ms if dev else None,
            "flash_fwd_kernel_ms": kernel_ms("flash_fwd_kernel"),
            "flash_bwd_dkv_kernel_ms": kernel_ms("flash_bwd_dkv_kernel"),
            "flash_bwd_dq_kernel_ms": kernel_ms("flash_bwd_dq_kernel"),
            "by_category": {c: {"ms": ms, "count": n}
                            for c, (ms, n) in sorted(
                                by_category.items(), key=lambda x: -x[1][0])},
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def crossover(torch, seed):
    """Per sequence length (B*H = 96, D=64, bf16, causal): one training
    attention forward + backward through the fused kernels (K2, then K3
    + K4) against K1 + the composed autograd backward — the two routes
    FlashAttentionOp / its gradient op choose between at
    FUSED_BWD_MIN_SEQ."""
    from hetu_tpu_torch.ops import attention as attn
    from hetu_tpu_torch.ops import flash_attention as fa
    b, h, d = TRAIN_BATCH, 12, 64
    scale = d ** -0.5
    out = []
    for s in CROSSOVER_SEQ:
        g = torch.Generator(device="cuda").manual_seed(seed + s)
        q, k, v, do = (torch.randn(b, h, s, d, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))

        def fused():
            o, lse = fa.flash_attention_with_lse(q, k, v, None, scale, True)
            return fa.flash_attention_bwd(q, k, v, None, o, lse, do, scale,
                                          True)

        def composed():
            fa.flash_attention(q, k, v, None, scale, True)
            mask = attn._causal_mask(s, q.device)
            _, vjp = torch.func.vjp(
                lambda q_, k_, v_: attn.attention_reference(
                    q_, k_, v_, mask, scale), q, k, v)
            return vjp(do)

        out.append({"s": s, "b": b, "h": h, "d": d, "dtype": "bfloat16",
                    "causal": True, "fused_ms": median_ms(torch, fused,
                                                          reps=5),
                    "composed_ms": median_ms(torch, composed, reps=5)})
        del q, k, v, do
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# serve: the main path
# ---------------------------------------------------------------------------

def drive(engine, prompts, max_new):
    """Submit every prompt at once, step until all resolve. Returns
    (tokens per request, pass metrics). TTFT counts from the common
    submit time to the end of the step that produced a request's first
    token; a decode step is one that began with every running request
    past its first token and no admission possible (nothing waiting, or
    the batch full), so it ran no prefill."""
    t0 = time.perf_counter()
    futs = [engine.submit(p, max_new, request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    ttft, step_ms, decode_ms = {}, [], []
    while not all(f.done() for f in futs):
        rows = engine.inflight_requests()
        running = [r for r in rows if r["phase"] in ("running", "replay")]
        waiting = len(rows) - len(running)
        decode_only = all(r["tokens_done"] >= 1 for r in running) and (
            not waiting or len(running) >= engine.max_batch_size)
        ts = time.perf_counter()
        engine.step()
        te = time.perf_counter()
        step_ms.append((te - ts) * 1e3)
        if decode_only:
            decode_ms.append((te - ts) * 1e3)
        for r in engine.inflight_requests():
            if r["tokens_done"] >= 1:
                ttft.setdefault(r["request_id"], (te - t0) * 1e3)
        for i, f in enumerate(futs):
            if f.done():
                ttft.setdefault(f"r{i}", (te - t0) * 1e3)
    wall = time.perf_counter() - t0
    outs = [f.result() for f in futs]
    ntok = sum(len(o) for o in outs)
    return outs, {"requests": len(outs), "tokens": ntok,
                  "wall_s": wall, "tokens_per_s": ntok / wall,
                  "ttft_ms_p50": float(np.median(list(ttft.values()))),
                  "decode_step_ms_p50": float(np.median(decode_ms))
                  if decode_ms else None,
                  "steps": len(step_ms), "decode_steps": len(decode_ms)}


def teacher_forced_logits(torch, cfg, params, tokens):
    """Logits of one causal prefill over ``tokens`` (K1 path), padded
    to the next power of two with the last token like the engine."""
    from hetu_tpu_torch.models.gpt import gpt_paged_prefill
    from hetu_tpu_torch.serving import PagedKVCache
    from hetu_tpu_torch.serving.session import next_bucket
    n = len(tokens)
    p = next_bucket(n)
    cache = PagedKVCache(cfg, num_blocks=p // 16 + 1, device="cuda")
    cache.add_seq(0, p)
    ids = np.full((1, p), tokens[-1], np.int64)
    ids[0, :n] = tokens
    slots = cache.slot_mapping(0, 0, p)[None].astype(np.int64)
    logits, _ = gpt_paged_prefill(
        params, cache.pools, torch.as_tensor(ids, device="cuda"),
        torch.as_tensor(slots, device="cuda"),
        num_heads=cfg.num_attention_heads)
    return logits[0, :n].cpu().numpy()


def serve(torch, seed, card):
    from hetu_tpu_torch.models.gpt import GPTConfig, random_gpt_checkpoint
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import attention as attn
    from hetu_tpu_torch.ops import flash_attention as fa
    from hetu_tpu_torch.serving import ContinuousBatchingEngine

    cfg = GPTConfig(**GPT2_SMALL)
    ckpt = random_gpt_checkpoint(cfg, seed=0)
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    prompts = [rng.integers(0, v, int(n)).astype(np.int32)
               for n in rng.integers(16, 769, NUM_REQUESTS)]
    shared = rng.integers(0, v, 256).astype(np.int32)
    prompts2 = [np.concatenate([shared, rng.integers(0, v, int(n))])
                .astype(np.int32)
                for n in rng.integers(16, 513, NUM_REQUESTS)]

    def engine(**kw):
        return ContinuousBatchingEngine(
            cfg, ckpt.__getitem__, device="cuda", start=False,
            num_blocks=NUM_BLOCKS, max_batch_size=8, **kw)

    # warm-up: library handles and the allocator's first blocks, so the
    # timed passes measure the steady engine
    warm = engine()
    drive(warm, [p[:16] for p in prompts[:2]], 4)
    warm.close()
    del warm

    passes = []
    _build.reset_launch_counts()                    # main path starts
    eng = engine()
    outs, m = drive(eng, prompts, MAX_NEW)
    m.update(name="plain_prefill", k1_launches=_build.launch_counts[
        "flash_fwd"], jit_compiles=eng.jit_compiles,
        compile_bound=eng.compile_bound)
    passes.append(m)
    params = eng.params
    eng.close()
    before = _build.launch_counts["flash_fwd"]
    eng2 = engine(prefix_cache=True, prefill_chunk=128)
    outs2, m2 = drive(eng2, prompts2, MAX_NEW)
    m2.update(name="prefix_cache_chunk128",
              k1_launches=_build.launch_counts["flash_fwd"] - before,
              jit_compiles=eng2.jit_compiles,
              compile_bound=eng2.compile_bound,
              prefix_hit_rate=eng2.cache.prefix.hit_rate())
    passes.append(m2)
    eng2.close()
    launches = dict(_build.launch_counts)           # main path ends
    del eng2
    for name, got in (("plain_prefill", outs), ("prefix", outs2)):
        for o in got:
            if o.shape != (MAX_NEW,) or o.min() < 0 or o.max() >= v:
                raise AssertionError(f"{name}: bad tokens {o}")
    if launches.get("flash_fwd", 0) <= 0 or passes[0]["k1_launches"] <= 0:
        raise AssertionError(f"main path never launched flash_fwd: "
                             f"{launches}")

    # token parity of request 0: the same engine with the plain blocked
    # attention swapped in for the kernel, up to the first position
    # whose top-2 logit gap is under MARGIN_TOL
    logits = teacher_forced_logits(
        torch, cfg, params, np.concatenate([prompts[0], outs[0][:-1]]))
    rows = logits[len(prompts[0]) - 1:]
    top2 = np.sort(rows, axis=-1)[:, -2:]
    margins = top2[:, 1] - top2[:, 0]
    kernel_fa = attn.flash_attention

    def plain_fa(q, k, v_, mask=None, sm_scale=1.0, causal=False):
        s, d = q.shape[-2:]
        if not fa._supported(s, d, *fa._block_sizes(s, d)):
            return kernel_fa(q, k, v_, mask, sm_scale, causal)
        return fa.flash_attention_plain(q, k, v_, mask, sm_scale, causal)

    attn.flash_attention = plain_fa
    try:
        eng3 = engine()
        plain_out, _ = drive(eng3, prompts[:1], MAX_NEW)
        eng3.close()
    finally:
        attn.flash_attention = kernel_fa
    checked = int(np.argmax(margins < MARGIN_TOL)) \
        if (margins < MARGIN_TOL).any() else MAX_NEW
    tf_tokens = rows.argmax(axis=-1)
    if not (np.array_equal(outs[0][:checked], plain_out[0][:checked])
            and np.array_equal(outs[0][:checked], tf_tokens[:checked])):
        raise AssertionError(
            f"request 0 tokens disagree within the margin-checked "
            f"{checked} positions: kernel {outs[0].tolist()}, plain "
            f"{plain_out[0].tolist()}, teacher-forced "
            f"{tf_tokens.tolist()}")
    profile = profile_pass(torch, engine(), prompts)
    return {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "dtype": "float32", "seed": seed,
            "tf32_matmul": bool(torch.backends.cuda.matmul.allow_tf32),
            "max_new_tokens": MAX_NEW, "num_blocks": NUM_BLOCKS,
            "passes": passes, "launches": launches,
            "parity": {"positions_checked": checked,
                       "min_margin": float(margins.min()),
                       "margin_tol": MARGIN_TOL,
                       "tokens_equal_plain": bool(np.array_equal(
                           outs[0], plain_out[0]))},
            "profile": profile}, launches


def profile_pass(torch, eng, prompts):
    """Pass 1 again under torch.profiler: device busy time summed over
    the CUDA kernels and copies, the idle share of the pass's wall time
    (the profiler's own host overhead included), and the kernels that
    took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive(eng, prompts, MAX_NEW)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.close()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if dev else None,
            "device_idle_share": 1.0 - busy / wall_ms if dev else None,
            "flash_fwd_ms": sum(e.self_device_time_total for e in dev
                                if "flash_fwd_kernel" in e.key) / 1e3,
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def _kernel_row(name, source, replaces, launches, rows, rep_key,
                library):
    rep = next(r for r in rows if (r["b"], r["s"], r["dtype"], r["causal"],
                                   r["mask"]) == rep_key)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "shape": {k: rep[k] for k in ("b", "h", "s", "d", "dtype",
                                          "causal", "mask")},
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "library": library, "checked_shapes": len(rows),
            "max_abs_err_all": {dt: max(r["max_abs_err"] for r in rows
                                        if r["dtype"] == dt)
                                for dt in ("float32", "bfloat16")}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the traffic, the data and the kernel "
                         "inputs")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not os.path.isfile(os.path.join(ROOT, "hetu_tpu_torch", "ops",
                                       "csrc", "flash_fwd.cu")):
        log("hetu_tpu_torch is not beside chip_smoke.py: run it from a "
            "checkout of the repository")
        return 2
    import torch
    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this smoke needs a GPU")
        return 1
    sys.path.insert(0, ROOT)
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import flash_attention as fa

    t_start = time.perf_counter()
    card = nvidia_smi_line()
    device = {"card": card, "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0]}
    log(f"device {device}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the serving path "
                             "keeps float32 products in float32")

    sources = ["flash_fwd", "flash_bwd"]
    seconds = _build.build(sources)
    ptxas = [ln.strip() for name in sources
             for f in sorted(_build.BUILD_DIR.glob(f"lib{name}_*.log"))
             for ln in f.read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    build = {"seconds": seconds, "ptxas": ptxas}
    log(f"build {build}")

    t = time.perf_counter()
    serve_line, serve_launches = serve(torch, args.seed, card)
    log(f"serve ({time.perf_counter() - t:.1f} s) {serve_line}")

    t = time.perf_counter()
    train_line, train_launches = train(torch, args.seed, card)
    log(f"train ({time.perf_counter() - t:.1f} s) {train_line}")

    t = time.perf_counter()
    k1_rows = check_flash_fwd(torch, args.seed)
    train_rows = check_flash_train_kernels(torch, args.seed)
    log(f"kernels checked ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    cross = crossover(torch, args.seed)
    log(f"crossover ({time.perf_counter() - t:.1f} s) {cross}")

    csrc = "hetu_tpu_torch/ops/csrc/"
    pallas = "hetu_tpu/ops/pallas_attention.py:"
    # K1: the serving path's longest prefill, one 1024-token bucket; K2-K4:
    # the training path's shape
    k1_rep = (1, 1024, "float32", True, False)
    train_rep = (TRAIN_BATCH, 1024, "bfloat16", True, False)
    sdpa = "torch.ops.aten._scaled_dot_product_flash_attention"
    kernels = {"kernels": [
        _kernel_row("flash_fwd", csrc + "flash_fwd.cu", pallas + "346",
                    serve_launches.get(fa.K1, 0), k1_rows, k1_rep,
                    "torch.nn.functional.scaled_dot_product_attention"),
        _kernel_row("flash_fwd_lse", csrc + "flash_fwd.cu", pallas + "333",
                    train_launches.get(fa.K2, 0), train_rows["K2"],
                    train_rep, sdpa + " (bf16 without mask only)"),
        _kernel_row("flash_bwd_dkv", csrc + "flash_bwd.cu", pallas + "514",
                    train_launches.get(fa.K3, 0), train_rows["K3"],
                    train_rep, sdpa + "_backward (computes dq, dk and dv: "
                    "K3 and K4 together; bf16 without mask only)"),
        _kernel_row("flash_bwd_dq", csrc + "flash_bwd.cu", pallas + "526",
                    train_launches.get(fa.K4, 0), train_rows["K4"],
                    train_rep, "none alone: see flash_bwd_dkv"),
    ]}
    shapes = {"kernel_shapes": {"flash_fwd": k1_rows, **{
        row["name"]: train_rows[key] for key, row in
        zip(("K2", "K3", "K4"), kernels["kernels"][1:])}}}
    lines = [{"device": device}, {"build": build}, shapes,
             {"serve": serve_line}, {"train": train_line},
             {"crossover": cross}, kernels,
             {"wall_s": time.perf_counter() - t_start}]
    texts = [json.dumps(line) for line in lines]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(texts + [card]) + "\n")
    for text in texts:
        print(text, flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
