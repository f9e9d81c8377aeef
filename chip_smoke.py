#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``hetu_tpu_torch``).

    python3 chip_smoke.py [--seed N] [--out FILE]

Run from a checkout of the repository on a machine with one NVIDIA GPU
and the CUDA toolkit. It builds every hand-written kernel from the
sources in the checkout, drives the port's main paths — GPT-2-small
(full width, random weights from a seed) served through
``ContinuousBatchingEngine``; the same model served through the
request-level plane (HTTP frontend, ``ReplicaRouter`` over two
``MicroBatcher``s, ``GPTDecoder`` over an ``InferenceSession`` restored
from a checkpoint); the same model trained with Adam in bf16 through
``Executor.run`` (B=8, S=1024); BERT-base MLM + NSP pre-training (B=64,
S=128, padded rows, dropout 0.1); BERT-small at S=2048 (B=8); the CNN
zoo's VGG-16 (full width) and ResNet-18 trained in f32 from dataloader
ops (B=128); ``digits_cnn`` trained to accuracy on the checked-in digits
through the port's ``examples/cnn_main.py`` — checks every kernel
against its plain PyTorch version on the card, and prints one JSON
object per line (``--out`` also writes them to FILE):

* ``device``  the card (name and power limit from nvidia-smi), torch and
  CUDA versions;
* ``build``   seconds spent compiling each kernel source, and ptxas's
  registers and spills for every kernel instantiation;
* ``kernel_shapes`` per kernel, one row per checked shape: error
  against the plain version (for K3/K4 also row by row), the route the
  kernel took (``tc`` or ``simt``), median times of the kernel, of the
  plain version and of the one PyTorch call computing the same
  function, the least time the card could take (``bound_ms``), and the
  wrapper's host time;
* ``check_faults`` the forward and gradient checks against faults
  planted in the kernels' output at the training shape: each must fail
  its check;
* ``serve``   per pass: tokens/s, TTFT p50, decode step ms, kernel
  launches, and the token-parity check against the plain attention;
* ``serve_dense`` the request-level plane under 16 closed-loop HTTP
  clients: requests/s, tokens/s, client latency p50/p95, mean batch
  occupancy, requests per replica, prefill and decode-step ms, the
  no-cache recompute tokens/s through ``InferenceSession.predict``, K1's
  launches on its two paths there (the decoder's prefill, the session's
  graph forward; all on ``simt``), one profiled tick, peak memory, and
  the parity checks (HTTP against a direct ``generate``: one request
  served alone, and eight of the timed replies against one batch of 8;
  the cached chain against the no-cache one; the decoder, and the
  session over inputs that fill its 1024 bucket, with the plain K1);
* ``train``   tokens/s, step ms p50, the loss of every step, kernel
  launches (K2, K3 and K4 also by route: all on the tensor-core ``tc``
  route), peak memory, the device idle share and time by kernel
  category of one profiled step, and the step-1 parity check against
  the plain K2–K4;
* ``bert``, ``bert_long`` the same for the two BERT passes, with MFU
  against the bf16 dense peak and the host time of one step by op type
  (the composed attention backward's and dropout's among them); BERT-base
  launches K1 12 times a step, all on ``tc``, and no K2–K4; BERT-small at
  S=2048 launches K2, K3 and K4 4 times a step each, all on ``tc``, and
  no K1; step-1 parity against the plain kernels;
* ``cnn_vgg16``, ``cnn_resnet18`` images/s, step ms p50, the loss of
  every step, MFU against the f32 peak, peak memory, the device idle
  share and device time by kernel category and by op type (and op
  category: conv, batch norm, gemm, pool, elementwise) of one profiled
  step, the host time of one step by op type, the launches of K1-K4
  (none: this path has no Pallas kernel), and the step-1 parity of the
  card against the CPU on one B=8 batch;
* ``cnn_digits`` held-out accuracy (at least the JAX package's 0.96),
  the epoch time and steps/s of ``cnn_main.run()``, K1-K4 launches
  (none);
* ``crossover`` per sequence length, the fused training attention
  (K2 + K3 + K4) against K1 + the composed autograd backward, and one
  row at BERT-base's shape (masked, non-causal);
* ``kernels`` per kernel (K1 flash forward, K2 forward with logsumexp,
  K3 backward dK/dV, K4 backward dQ, and the K3+K4 pair as one
  ``flash_attention_bwd`` against PyTorch's flash backward): launches
  on its main paths (by path and route), the largest error against the
  plain version by dtype and route over every checked shape, and
  ``kernel_shapes``' row at each main path's shape with the kernel's and
  the PyTorch call's device time per call (``device_ms``,
  ``library_device_ms``: calls queued back to back behind a spin kernel,
  timed by CUDA events);

then the card line as ``nvidia-smi`` prints it, and last
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. It also exits non-zero without a
CUDA device, or when ``hetu_tpu_torch`` is not beside it.
"""
from __future__ import annotations

import argparse
import http.client
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "hetu_tpu_torch/ops/csrc/"      # the kernel sources, in the repo

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

# the request-level plane (serve_dense): bench.py's bench_serving
# (:1191-1302) and the baseline of bench_serving_continuous
# (:1504-1529) at GPT-2-small's widths in f32. Clients edge-pad each
# prompt (16-256 tokens) to the fleet prompt bucket; a tick pads its
# batch to the next power of two and generates its longest request's
# gen for every row
DENSE_PROMPT_BUCKET = 256
DENSE_SEQ_BUCKET = 1024             # the session's sequence bucket
DENSE_CLIENTS, DENSE_PER_CLIENT = 16, 4
DENSE_MAX_BATCH, DENSE_MAX_WAIT_MS = 8, 5
DENSE_DECODE_STEPS = 20             # timed decode_step calls (:1245-1252)
DENSE_NO_CACHE_STEPS = 4            # no-cache recompute steps (:1233-1242)
# sess.predict's logits, K1 against its plain version (f32, B=8 S=1024):
# the two attentions differ by ~1e-6 of an output (K1's f32 checks),
# which 12 layers, the LayerNorms and the 768-wide LM head carry to
# the logits (measured in the serve_dense line's parity)
DENSE_LOGIT_TOL = 1e-4

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
# and each gradient row (one key of dk / dv, one q of dq) against its own
# size: |got - want| <= tol * (|want| + floor) in the 2-norm over the head
# dim, floor = BWD_ROW_FLOOR * the largest |want| row of the tensor (a row
# whose exact value is 0, as dq's first under causal, is held to the
# tensor's scale). In bf16 a correct kernel differs from the plain
# version by at most about one flipped rounding of p or dS and one of the
# output, ~1e-2 of a row's size in the worst case. BWD_TOL alone lets a
# fault confined to the late causal rows pass: their gradients are ~1e-2
# of the early rows'; check_catches_faults plants such faults
BWD_ROW_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_ROW_FLOOR = 1e-3
CROSSOVER_SEQ = (128, 256, 512, 1024, 2048)

# the BERT pre-training passes: BERT-base, the graph of bench.py:1150-1168
# (B=64, S=128), and BERT-small at S=2048, the graph of
# bench.py:2390-2406 (B=8); bf16 with f32 masters, Adam lr 1e-4, the
# default dropout 0.1, one fixed batch whose rows are padded past a
# length drawn from ``lengths``
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=128)
BERT_SMALL_2048 = dict(vocab_size=30522, hidden_size=512,
                       num_hidden_layers=4, num_attention_heads=8,
                       intermediate_size=2048, max_position_embeddings=2048)
BERT_PASSES = {
    "bert": dict(model="bert-base", widths=BERT_BASE, batch=64,
                 lengths=(64, 128), warmup=2, steps=6),
    "bert_long": dict(model="bert-small-2048", widths=BERT_SMALL_2048,
                      batch=8, lengths=(1024, 2048), warmup=2, steps=6),
}
BERT_FEEDS = ("input_ids", "token_type_ids", "attention_mask",
              "masked_lm_labels", "next_sentence_label")

# the CNN passes: the reference's CIFAR VGG-16 with batch norm (channels
# 64-512, FC 512-4096-4096-10) and pre-activation ResNet-18 (widths
# 16/32/64), hetu_tpu/models/cnn.py, trained at B=128 on 3x32x32 in f32
# with MomentumOptimizer (examples/cnn/main.py --opt momentum) on batches
# of ht.data.cifar10() (its seeded synthetic images where CIFAR_10 is
# absent) through dataloader ops; 2 warm-up then 20 timed steps, each
# ending in the loss's readback. ResNet-18 takes main.py's default rate
# 0.1. VGG-16 takes 0.01: from the zoo's stddev-0.1 weights it diverges
# at 0.1 in both packages (tests/test_torch_cnn_models.py
# ::test_vgg16_diverges_at_lr_0_1_like_the_reference)
CNN_BATCH = 128
CNN_WARMUP, CNN_STEPS = 2, 20
CNN_PASSES = {
    "cnn_vgg16": dict(model="vgg16", lr=0.01,
                      grads=("vgg_conv1_1_weight", "vgg_conv1_1_scale")),
    "cnn_resnet18": dict(model="resnet18", lr=0.1,
                         grads=("resnet_init_conv_weight",
                                "resnet_init_bn_scale")),
}
# step-1 parity, the pass's graph in f32 on the card (cuDNN's TF32 off)
# against the same graph on the CPU in float64 (same weights, one B=8
# batch): the loss within CNN_LOSS_TOL relative, the first convolution's
# weight gradient and the first batch norm's scale gradient within
# CNN_GRAD_TOL of their largest element. The reference is the CPU in
# float64, not in f32: at VGG-16's initial weights a relu in the FC
# layers sits at a pre-activation within f32 rounding of 0 for this
# batch, so which side an f32 run lands on is decided by its summation
# order, and the CPU's f32 run lands on the other side from exact
# arithmetic — its first-layer gradients are ~1e-2 of their largest
# element from float64's (both packages' CPU f32 runs; the loss and
# ResNet-18 agree to ~1e-6). The CPU's f32 run is reported beside.
CNN_PARITY_BATCH = 8
CNN_LOSS_TOL = 1e-4
CNN_GRAD_TOL = 1e-3
# device time of the profiled step by op type, summed into these
# categories (the first prefix that matches; else "elementwise / other")
CNN_OP_CATEGORIES = (
    ("conv", ("Conv2d",)), ("batch norm", ("BatchNormalization",)),
    ("gemm", ("MatMul",)), ("pool", ("MaxPool2d", "AvgPool2d")),
    ("optimizer", ("Optimizer",)), ("loss", ("SoftmaxCrossEntropy",)),
)
# the digits pass: cnn_main.run() as tests/test_accuracy.py:65-76 runs
# the reference's examples/cnn/main.py, on the checked-in real digits;
# the JAX package's own bar
CNN_DIGITS_ARGS = ("--model", "digits_cnn", "--dataset", "DIGITS",
                   "--validate", "--num-epochs", "25", "--learning-rate",
                   "0.002", "--opt", "adam", "--batch-size", "64",
                   "--timing")
CNN_DIGITS_MIN_ACC = 0.96

# the main-path shape of each kernel: K1 the serving path's longest
# prefill (one 1024-token bucket) and the BERT-base step's; K2-K4 the
# GPT training step's and the BERT-small S=2048 step's. ``mask``: None,
# "half" (fixed keys masked, see check_flash_fwd) or "padding" (BERT's
# rows, padding_mask)
K1_REP = dict(b=1, h=12, s=1024, d=64, dtype="float32", causal=True,
              mask=None)
BERT_K1_REP = dict(b=64, h=12, s=128, d=64, dtype="bfloat16", causal=False,
                   mask="padding")
TRAIN_REP = dict(b=TRAIN_BATCH, h=12, s=1024, d=64, dtype="bfloat16",
                 causal=True, mask=None)
BERT_LONG_REP = dict(b=8, h=8, s=2048, d=64, dtype="bfloat16", causal=False,
                     mask="padding")
# K1 on the request-level plane: the decoder's prefill of a full tick
# (B=8 in the 256 prompt bucket) and the session's graph forward of 8
# rows in its 1024 bucket
K1_PREFILL_REP = dict(b=DENSE_MAX_BATCH, h=12, s=DENSE_PROMPT_BUCKET, d=64,
                      dtype="float32", causal=True, mask=None)
K1_SESSION_REP = dict(K1_PREFILL_REP, s=DENSE_SEQ_BUCKET)
K1_REPS = (K1_REP, BERT_K1_REP, K1_PREFILL_REP, K1_SESSION_REP)
# device kernels of the profiled training step, by name (first match)
PROFILE_CATEGORIES = (
    ("flash attention (K1-K4)", ("flash_fwd", "flash_bwd_")),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "convolve",
                             "winograd", "cudnn", "fft2d")),
    ("pooling", ("pool",)),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("reduction", ("reduce_kernel",)),
    ("index / scatter / gather", ("index", "scatter", "gather", "unique",
                                  "sort", "radix")),
    ("random (dropout masks)", ("distribution", "philox")),
    ("elementwise", ("elementwise", "copy")),
)
# the name prefix of profile_window's per-op ranges
OP_RANGE = "op::"
# device_ms: the spin kernel's first length, in clock cycles (~10 ms at
# the H100's boost clock), and the launch-count keys each timed call of
# K1-K4 and the pair adds one to
DEVICE_SPIN_CYCLES = 20_000_000
DEVICE_LAUNCHES = {"K1": ("flash_fwd",), "K2": ("flash_fwd_lse",),
                   "K3": ("flash_bwd_dkv",), "K4": ("flash_bwd_dq",),
                   "pair": ("flash_bwd_dkv", "flash_bwd_dq")}


def log(msg):
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def host_ms(torch, fn, reps=20):
    """Median host time of one call made on an idle device (synchronised
    first, not after): what the wrapper costs the host, launches included
    but not the kernels' run."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


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
# reads q, k, v, dO, lse, D and writes dk, dv; K4 reads q, k, v, dO, O,
# lse and writes dq and D (on the tc route it computes D); the pair
# (one flash_attention_bwd) reads q, k, v, O, dO, lse, writes dq, dk, dv
FLASH_WORK = {"K1": (4, 4, 0), "K2": (4, 4, 1), "K3": (8, 6, 2),
              "K4": (6, 6, 2), "pair": (14, 8, 1)}
# the K1 checks: (dtypes, batches, seqs, head dim, heads, masks); every
# row with each of its masks and causal on/off. The "half" mask hides the
# second half of the first batch element's keys and every key of the
# last one's rows where B > 1. D=64 is the main paths' (f32 serving on
# the simt route, B=8 at S=256 and 1024 on the request-level plane,
# bf16 BERT-base on tc, B=64 with BERT's padding); bf16 D=128 and the
# ragged S=520 hold the other tensor-core instantiation and the TMA
# edge; bf16 D=96 the simt route's bf16
FWD_KERNEL_SHAPES = (
    (("float32", "bfloat16"), (1, 4), (8, 128, 512, 1024), 64, 12,
     (None, "half")),
    (("float32",), (DENSE_MAX_BATCH,), (DENSE_PROMPT_BUCKET, DENSE_SEQ_BUCKET),
     64, 12, (None,)),
    (("bfloat16",), (64,), (128,), 64, 12, (None, "half", "padding")),
    (("bfloat16",), (4,), (512, 1024), 128, 12, (None, "half")),
    (("bfloat16",), (4,), (520,), 64, 12, (None, "half")),
    (("bfloat16",), (4,), (512, 1024), 96, 12, (None, "half")),
)
# the K2-K4 checks: (dtypes, batches, seqs, head dim, heads, masks); every
# row with each of its masks and causal on/off; the "half" mask hides the
# second half of the first element's keys and the last quarter of the
# last one's. D=64 is the training paths' (GPT-2 at H=12 S=1024, BERT-small
# at H=8 S=2048 with BERT's padding); D=128 and the ragged S=520 hold the
# other tensor-core instantiations and the TMA edge; bf16 at D=96 the
# simt route's bf16 instantiations
TRAIN_KERNEL_SHAPES = (
    (("float32", "bfloat16"), (1, TRAIN_BATCH), (128, 512, 1024), 64, 12,
     (None, "half")),
    (("bfloat16",), (8,), (2048,), 64, 8, (None, "half", "padding")),
    (("bfloat16",), (1,), (512, 1024), 128, 12, (None, "half")),
    (("bfloat16",), (1,), (520,), 64, 12, (None, "half")),
    (("bfloat16",), (1,), (512, 1024), 96, 12, (None, "half")),
)


def padding_mask(torch, b, s, dtype, g):
    """BERT's additive padding mask, [B, 1, 1, S] in ``dtype``, as its
    graph builds it: (m - 1) * 10000 with m = 1 on each element's first L
    keys, L drawn from [S/2, S] (in bf16 a padded key carries -9984)."""
    lengths = torch.randint(s // 2, s + 1, (b, 1), generator=g,
                            device="cuda")
    keep = (torch.arange(s, device="cuda")[None] < lengths).to(dtype)
    return ((keep - 1) * 10000).view(b, 1, 1, s)


def _is(row, rep):
    return all(row[k] == v for k, v in rep.items())


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


def device_ms(torch, fn, label, launches=(), n=20):
    """Device time of one call: n calls queued behind a spin kernel
    (``torch.cuda._sleep``), so that they run back to back with no host
    time between them, timed by two CUDA events around them, over n.
    The spin grows until the host has queued every call before the
    device reaches the first event. ``launches``: the launch-count keys
    (``_build.launch_counts``) the call adds one to; it raises unless
    each rose by exactly n, or the time is not positive. (torch.profiler
    lost kernel records in these short windows: see PERF.md.)"""
    from hetu_tpu_torch.ops import _build
    fn()
    torch.cuda.synchronize()
    cycles = DEVICE_SPIN_CYCLES
    for _ in range(4):
        before = {k: _build.launch_counts[k] for k in launches}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            break
        cycles *= 4
    else:
        raise AssertionError(f"device_ms {label}: the device reached the "
                             f"calls before the host had queued them")
    got = {k: _build.launch_counts[k] - before[k] for k in launches}
    ms = start.elapsed_time(end) / n
    if ms <= 0 or any(c != n for c in got.values()):
        raise AssertionError(f"device_ms {label}: {ms} ms, launches {got} "
                             f"over {n} calls")
    return ms


def _device_times(torch, kern, library, launches, label):
    """The main-path row's device times: the kernel call's (``launches``:
    the launch-count keys it adds one to a call) and the library call's
    (None where there is none)."""
    return {"device_ms": device_ms(torch, kern, label, launches),
            "library_device_ms": None if library is None
            else device_ms(torch, library, label + " library")}


# ---------------------------------------------------------------------------
# kernels: K1 against its plain version at every listed shape
# ---------------------------------------------------------------------------

def check_flash_fwd(torch, seed):
    """K1 against its plain version at every shape of FWD_KERNEL_SHAPES,
    with each of its masks and causal on/off; each row names the route
    the kernel took and the wrapper's host time; the rows at the main
    paths' shapes (K1_REPS) also their device times (_device_times). The
    PyTorch call is SDPA with the same additive mask (and the causal
    one)."""
    import torch.nn.functional as F
    from hetu_tpu_torch.ops import flash_attention as fa
    rows, failures = [], []
    shapes = [(getattr(torch, dname), b, s, d, h, masks)
              for dnames, batches, seqs, d, h, masks in FWD_KERNEL_SHAPES
              for dname in dnames for b in batches for s in seqs]
    for dtype, b, s, d, h, masks in shapes:
        dname = str(dtype).split(".")[-1]
        g = torch.Generator(device="cuda").manual_seed(seed + s + b)
        q, k, v = (torch.randn(b, h, s, d, generator=g,
                               device="cuda").to(dtype) for _ in range(3))
        for masked in masks:
            mask = None
            if masked == "half":
                mask = torch.zeros(b, 1, 1, s, device="cuda")
                mask[0, ..., s // 2:] = -1e9
                if b > 1:
                    mask[-1] = -1e9     # a fully masked row
            elif masked == "padding":
                mask = padding_mask(torch, b, s, dtype, g)
            for causal in (False, True):
                scale = d ** -0.5
                out = fa.flash_attention(q, k, v, mask, scale, causal)
                ref = fa.flash_attention_plain(q, k, v, mask, scale, causal)
                torch.cuda.synchronize()
                diff = (out.float() - ref.float()).abs()
                tol = FWD_TOL[dname]
                ok = bool(torch.allclose(out.float(), ref.float(), atol=tol,
                                         rtol=tol))
                lib_mask = mask
                if causal:
                    cm = torch.full((s, s), fa.NEG_INF, device="cuda").triu(1)
                    lib_mask = cm if mask is None else mask + cm
                if lib_mask is not None:
                    lib_mask = lib_mask.to(dtype)

                def kern():
                    return fa.flash_attention(q, k, v, mask, scale, causal)

                def library():
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=lib_mask, scale=scale)
                bound, by = flash_bound(b, h, s, d, dname, causal, masked)
                row = {"b": b, "h": h, "s": s, "d": d, "dtype": dname,
                       "causal": causal, "mask": masked,
                       "route": fa._fwd_route(dtype, d),
                       "max_abs_err": float(diff.max()),
                       "max_rel_err": float((diff / ref.float().abs()
                                             .clamp_min(1.0)).max()),
                       "tol": tol, "ok": ok,
                       "ms": median_ms(torch, kern),
                       "host_ms": host_ms(torch, kern),
                       "plain_ms": median_ms(
                           torch, lambda: fa.flash_attention_plain(
                               q, k, v, mask, scale, causal),
                           reps=3, warmup=1),
                       "library_ms": median_ms(torch, library),
                       "bound_ms": bound, "bound_by": by}
                if any(_is(row, rep) for rep in K1_REPS):
                    row.update(_device_times(
                        torch, kern, library, DEVICE_LAUNCHES["K1"],
                        f"K1 {dname} B={b} H={h} S={s} mask={masked}"))
                rows.append(row)
                if not ok:
                    failures.append(row)
    if failures:
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"at {len(failures)} shape(s): {failures}")
    return rows


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


def _row_rel_err(got, want):
    """The largest |got - want| of a row over (|want| + floor) of that row
    (2-norms over the last axis; see BWD_ROW_TOL)."""
    want = want.float()
    size = want.norm(dim=-1)
    diff = (got.float() - want).norm(dim=-1)
    return float((diff / (size + BWD_ROW_FLOOR * size.max()
                          + 1e-30)).max())


def _fwd_check(pairs, dname):
    """(ok, max_abs_err) of (got, want) forward pairs (o, lse): each
    within FWD_TOL elementwise."""
    tol = FWD_TOL[dname]
    return (all(a.float().allclose(w.float(), atol=tol, rtol=tol)
                for a, w in pairs), max(_err(*pr) for pr in pairs))


def _grad_check(pairs, dname):
    """(ok, max_abs_err, row_rel_err) of (got, want) gradient pairs: each
    within BWD_TOL elementwise and BWD_ROW_TOL row by row."""
    tol = BWD_TOL[dname]
    abs_err = max(_err(*pr) for pr in pairs)
    row_err = max(_row_rel_err(*pr) for pr in pairs)
    ok = all(a.float().allclose(w.float(), atol=tol, rtol=tol)
             for a, w in pairs) and row_err <= BWD_ROW_TOL[dname]
    return ok, abs_err, row_err


def _sdpa_flash(torch, q, k, v, scale, causal):
    """PyTorch's own flash-attention forward (bf16 only, no mask): output,
    logsumexp and what its backward needs. Timing yardstick only."""
    return torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, causal, False, scale=scale)


def _sdpa_efficient(torch, q, k, v, bias, scale, causal):
    """PyTorch's memory-efficient attention forward (the only PyTorch
    call that takes an additive mask and returns the logsumexp), with
    ``bias`` [B, H, S, S]: output, logsumexp and the Philox state its
    backward takes. Timing yardstick only."""
    return torch.ops.aten._scaled_dot_product_efficient_attention(
        q, k, v, bias, True, 0.0, causal, scale=scale)


def check_flash_train_kernels(torch, seed):
    """K2, K3, K4 and the K3+K4 pair (one flash_attention_bwd) against
    their plain versions at every shape of TRAIN_KERNEL_SHAPES, with each
    of its masks and causal on/off. The masks leave every row an unmasked
    key (a fully masked row has p = exp(s - lse) = 1 under the
    reference's formula, which nothing pins). K3 and K4 run from the
    kernel's own o and lse, so each is held apart from K2's roundings;
    their rows name the route they took. K3's and K4's times are their
    launches alone, from prepared inputs (K3 reading the D that K4
    wrote, as on the path); the pair's is one whole flash_attention_bwd.
    The PyTorch calls: flash attention (bf16 without a mask) and, under
    BERT's padding mask, memory-efficient attention with the mask
    expanded to a [B, H, S, S] bias; each backward computes dq, dk and
    dv, so K3's row and the pair's carry it. The rows at TRAIN_REP and
    BERT_LONG_REP also carry device times (_device_times). Returns
    {kernel: [row per shape]}."""
    from hetu_tpu_torch.ops import flash_attention as fa
    rows = {"K2": [], "K3": [], "K4": [], "pair": []}
    failures = []
    shapes = [(getattr(torch, dname), b, s, d, h, masks)
              for dnames, batches, seqs, d, h, masks in TRAIN_KERNEL_SHAPES
              for dname in dnames for b in batches for s in seqs]
    for dtype, b, s, d, h, masks in shapes:
        dname = str(dtype).split(".")[-1]
        g = torch.Generator(device="cuda").manual_seed(seed + s + b)
        q, k, v, do = (torch.randn(b, h, s, d, generator=g,
                                   device="cuda").to(dtype)
                       for _ in range(4))
        for masked in masks:
            mask = None
            if masked == "half":
                mask = torch.zeros(b, 1, 1, s, device="cuda")
                mask[0, ..., s // 2:] = -1e9
                mask[-1, ..., 3 * s // 4:] = -1e9
            elif masked == "padding":
                mask = padding_mask(torch, b, s, dtype, g)
            for causal in (False, True):
                args = (q, k, v, mask)
                scale = d ** -0.5
                o, lse = fa.flash_attention_with_lse(*args, scale, causal)
                bwd = (*args, o, lse, do, scale, causal)
                dk, dv = fa.flash_attention_bwd_dkv(*bwd)
                dq = fa.flash_attention_bwd_dq(*bwd)
                pdq, pdk, pdv = fa.flash_attention_bwd(*bwd)
                prep = fa._bwd_prepare(*bwd[:7])
                fa._launch_dq(prep, scale, causal)  # tc: writes K3's D
                ro, rlse = fa.flash_attention_with_lse_plain(*args, scale,
                                                             causal)
                rdk, rdv = fa.flash_attention_bwd_dkv_plain(*bwd)
                rdq = fa.flash_attention_bwd_dq_plain(*bwd)
                torch.cuda.synchronize()
                lib = dict.fromkeys(rows)
                if dtype == torch.bfloat16 and not masked:
                    res = _sdpa_flash(torch, q, k, v, scale, causal)
                    lib["K2"] = lambda: _sdpa_flash(torch, q, k, v, scale,
                                                    causal)
                    # one call computes dq, dk and dv: K3's row and the
                    # pair's carry it
                    lib["K3"] = lib["pair"] = lambda: torch.ops.aten.\
                        _scaled_dot_product_flash_attention_backward(
                            do, q, k, v, res[0], res[1], res[2], res[3],
                            res[4], res[5], 0.0, causal, res[6], res[7],
                            scale=scale)
                elif masked == "padding":
                    bias = mask.expand(b, h, s, s)
                    eff = _sdpa_efficient(torch, q, k, v, bias, scale,
                                          causal)
                    lib["K2"] = lambda: _sdpa_efficient(torch, q, k, v,
                                                        bias, scale, causal)
                    lib["K3"] = lib["pair"] = lambda: torch.ops.aten.\
                        _scaled_dot_product_efficient_attention_backward(
                            do, q, k, v, bias, eff[0], eff[1], eff[2],
                            eff[3], 0.0, (True, True, True, False), causal,
                            scale=scale)
                # kind: ((got, want) pairs, kernel call, plain call)
                checks = {
                    "K2": ([(o, ro), (lse, rlse)],
                           lambda: fa.flash_attention_with_lse(
                               *args, scale, causal),
                           lambda: fa.flash_attention_with_lse_plain(
                               *args, scale, causal)),
                    "K3": ([(dk, rdk), (dv, rdv)],
                           lambda: fa._launch_dkv(prep, scale, causal),
                           lambda: fa.flash_attention_bwd_dkv_plain(*bwd)),
                    "K4": ([(dq, rdq)],
                           lambda: fa._launch_dq(prep, scale, causal),
                           lambda: fa.flash_attention_bwd_dq_plain(*bwd)),
                    "pair": ([(pdq, rdq), (pdk, rdk), (pdv, rdv)],
                             lambda: fa.flash_attention_bwd(*bwd),
                             lambda: fa.flash_attention_bwd_plain(*bwd)),
                }
                for kind, (pairs, kern, plain) in checks.items():
                    bound, by = flash_bound(b, h, s, d, dname, causal,
                                            masked, kind)
                    row = {"b": b, "h": h, "s": s, "d": d, "dtype": dname,
                           "causal": causal, "mask": masked}
                    if kind == "K2":
                        ok, err = _fwd_check(pairs, dname)
                        row.update(max_abs_err=err, tol=FWD_TOL[dname],
                                   ok=ok, route=fa._fwd_route(dtype, d))
                    else:
                        ok, err, row_err = _grad_check(pairs, dname)
                        row.update(max_abs_err=err, tol=BWD_TOL[dname],
                                   row_rel_err=row_err,
                                   row_tol=BWD_ROW_TOL[dname], ok=ok,
                                   route=fa._bwd_route(dtype, d))
                    row.update(ms=median_ms(torch, kern),
                               host_ms=host_ms(torch, kern),
                               plain_ms=median_ms(torch, plain, reps=3,
                                                  warmup=1),
                               library_ms=None if lib[kind] is None
                               else median_ms(torch, lib[kind]),
                               bound_ms=bound, bound_by=by)
                    if _is(row, TRAIN_REP) or _is(row, BERT_LONG_REP):
                        row.update(_device_times(
                            torch, kern, lib[kind], DEVICE_LAUNCHES[kind],
                            f"{kind} B={b} H={h} S={s} mask={masked}"))
                    rows[kind].append(row)
                    if not row["ok"]:
                        failures.append((kind, row))
    if failures:
        raise AssertionError(f"K2-K4 disagree with their plain versions at "
                             f"{len(failures)} case(s): {failures}")
    return rows


def check_catches_faults(torch, seed):
    """The forward check (_fwd_check) and the gradient check
    (_grad_check) against faults planted in the kernels' output at the
    training shape (B=8 H=12 S=1024 D=64 bf16 causal): forward, the last
    q tile of O zeroed and lse shifted by log 2 on the last 64 rows of
    each head; backward, the last key tile of dk and dv zeroed, the last
    q tile of dq zeroed, and dk from K3 given D = 0. The kernels' own
    output must pass both checks and every fault must fail its check;
    each gradient row also says whether BWD_TOL alone would have caught
    it."""
    from hetu_tpu_torch.ops import flash_attention as fa
    b, h, s, d, dname = TRAIN_BATCH, 12, 1024, 64, "bfloat16"
    g = torch.Generator(device="cuda").manual_seed(seed + s + b)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_attention_with_lse(q, k, v, None, scale, True)
    ro, rlse = fa.flash_attention_with_lse_plain(q, k, v, None, scale, True)
    bwd = (q, k, v, None, o, lse, do, scale, True)
    dq, dk, dv = fa.flash_attention_bwd(*bwd)
    rdk, rdv = fa.flash_attention_bwd_dkv_plain(*bwd)
    rdq = fa.flash_attention_bwd_dq_plain(*bwd)
    prep = fa._bwd_prepare(*bwd[:7])
    prep["delta"] = torch.zeros_like(prep["delta"])
    dk_no_d, _ = fa._launch_dkv(prep, scale, True)

    def last_tile_zeroed(t):
        t = t.clone()
        t[..., -64:, :] = 0
        return t
    lse_shifted = lse.clone()
    lse_shifted[..., -64:] += float(np.log(2.0))
    fwd_cases = {
        "forward kernels": [(o, ro), (lse, rlse)],
        "last q tile of O zeroed": [(last_tile_zeroed(o), ro)],
        "lse shifted by log 2 on its last rows": [(lse_shifted, rlse)],
    }
    cases = {
        "kernels": [(dq, rdq), (dk, rdk), (dv, rdv)],
        "last key tile of dk and dv zeroed": [(last_tile_zeroed(dk), rdk),
                                              (last_tile_zeroed(dv), rdv)],
        "last q tile of dq zeroed": [(last_tile_zeroed(dq), rdq)],
        "K3 given D = 0": [(dk_no_d, rdk)],
    }
    torch.cuda.synchronize()
    out = {}
    for name, pairs in fwd_cases.items():
        ok, err = _fwd_check(pairs, dname)
        out[name] = {"passes": ok, "max_abs_err": err}
    for name, pairs in cases.items():
        ok, err, row_err = _grad_check(pairs, dname)
        out[name] = {"passes": ok, "max_abs_err": err,
                     "row_rel_err": row_err,
                     "passes_bwd_tol_alone": all(
                         a.float().allclose(w.float(), atol=BWD_TOL[dname],
                                            rtol=BWD_TOL[dname])
                         for a, w in pairs)}
    own = ("kernels", "forward kernels")
    if not all(out[name]["passes"] for name in own) or any(
            r["passes"] for name, r in out.items() if name not in own):
        raise AssertionError(f"the forward or gradient check does not "
                             f"tell the kernels from planted faults: {out}")
    return out


# ---------------------------------------------------------------------------
# train: the second main path
# ---------------------------------------------------------------------------

def _bf16_ulp(x):
    """One bfloat16 ulp at the magnitude of x (8 significand bits)."""
    return 2.0 ** (int(np.floor(np.log2(abs(x)))) - 7)


def train_pass(torch, nodes, feeds, plain, steps):
    """What every training phase runs: first one step of an executor
    over ``nodes`` (the loss, the gradients to compare, the optimizer)
    with the plain kernel versions of ``plain`` ({name in
    ``ops.attention``: function}) swapped in, before the main path; then
    the main path, ``steps`` steps of a new executor of the same graph
    with the kernels, the launch counts set to 0 just before and read
    just after. The same graph and step 0 give both executors the same
    weights and dropout masks. Returns (executor, run)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import attention as attn
    kernels = {key: getattr(attn, key) for key in plain}
    for key, fn in plain.items():
        setattr(attn, key, fn)
    try:
        exe = ht.Executor(nodes, dtype=torch.bfloat16)
        out = exe.run(feed_dict=feeds)
        plain_loss = float(out[0].asnumpy())
        plain_grads = [o.tensor.float().clone() for o in out[1:-1]]
    finally:
        for key, fn in kernels.items():
            setattr(attn, key, fn)
    del exe, out
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    exe = ht.Executor(nodes, dtype=torch.bfloat16)
    setup_s = time.perf_counter() - t0
    losses, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        out = exe.run(feed_dict=feeds)
        losses.append(float(out[0].asnumpy()))      # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            kernel_grads = [o.tensor.float().clone() for o in out[1:-1]]
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)           # main path ends
    return exe, {"setup_s": setup_s, "losses": losses, "step_ms": step_ms,
                 "launches": launches,
                 "peak": torch.cuda.max_memory_allocated(),
                 "plain_loss": plain_loss, "plain_grads": plain_grads,
                 "kernel_grads": kernel_grads}


def check_pass(name, run, want, grads):
    """A training phase's checks: every loss finite and the last below
    the first; the launch counts ``want``; step-1 parity with the plain
    kernels — the loss within one bf16 ulp, each of ``grads`` ({part:
    (kernel's, plain's)}) within GRAD_PARITY_TOL of its largest element.
    Returns (launches, parity)."""
    losses = run["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} loss not finite and falling: {losses}")
    got = {key: run["launches"].get(key, 0) for key in want}
    if got != want:
        raise AssertionError(f"{name} launches {got}, want {want}")
    grad_err = {part: float((kg - pg).abs().max() / pg.abs().max())
                for part, (kg, pg) in grads.items()}
    parity = {"loss_kernels": losses[0], "loss_plain": run["plain_loss"],
              "loss_tol": _bf16_ulp(run["plain_loss"]),
              "grad_rel_err": grad_err, "grad_tol": GRAD_PARITY_TOL}
    if abs(losses[0] - run["plain_loss"]) > parity["loss_tol"] or \
            max(grad_err.values()) > GRAD_PARITY_TOL:
        raise AssertionError(f"{name} step-1 parity with the plain kernels "
                             f"failed: {parity}")
    return got, parity


def _route_counts(on, off, n):
    """Launch counts of a path whose kernels ``on`` launch n times each,
    all on the tc route, and whose kernels ``off`` never launch."""
    return {**{k: n for k in on}, **{f"{k}.tc": n for k in on},
            **{f"{k}.simt": 0 for k in on}, **{k: 0 for k in off}}


def train(torch, seed, card):
    """GPT-2-small causal LM, the graph of bench.py:1103-1118, trained
    with Adam in bf16 through Executor.run on one fixed batch
    (train_pass: a parity step with the plain K2-K4 swapped in, then
    warm-up and timed steps with the kernels); then one profiled step."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
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

    steps = TRAIN_WARMUP + TRAIN_STEPS
    exe, run = train_pass(
        torch, nodes, feeds,
        {"flash_attention_with_lse": fa.flash_attention_with_lse_plain,
         "flash_attention_bwd": fa.flash_attention_bwd_plain}, steps)
    hidden = cfg.hidden_size
    (kernel_grad,), (plain_grad,) = run["kernel_grads"], run["plain_grads"]
    got, parity = check_pass(
        "train", run,
        _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,),
                      cfg.num_hidden_layers * steps),
        {part: (kernel_grad[:, i * hidden:(i + 1) * hidden],
                plain_grad[:, i * hidden:(i + 1) * hidden])
         for i, part in enumerate("qkv")})
    timed = run["step_ms"][TRAIN_WARMUP:]
    tokens = TRAIN_BATCH * seq
    profile = profile_train_step(torch, exe, feeds)
    return {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "batch": TRAIN_BATCH, "seq": seq, "dtype": "bfloat16",
            "optimizer": "Adam", "lr": TRAIN_LR, "seed": seed,
            "executor_setup_s": run["setup_s"],
            "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_STEPS,
            "tokens_per_s": tokens * len(timed) / (sum(timed) / 1e3),
            "step_ms_p50": float(np.median(timed)),
            "step_ms": run["step_ms"], "losses": run["losses"],
            "launches": got, "peak_memory_bytes": int(run["peak"]),
            "parity": parity, "profile": profile}, run["launches"]


def profile_train_step(torch, exe, feeds):
    """One more training step under torch.profiler (profile_window)."""
    return profile_window(
        torch, lambda: exe.run(feed_dict=feeds)[0].asnumpy())


def profile_window(torch, fn, nodes=()):
    """``fn()`` once under torch.profiler: device busy time over the CUDA
    kernels and copies, the idle share of the window's wall time (the
    profiler's own host overhead included), device time by kernel
    category (PROFILE_CATEGORIES) and the kernels that took the most.
    With graph ``nodes``, each one's ``compute`` runs inside a profiler
    range named by its op type (which slows the host: take the idle
    share from a window without them), and ``device_ms_by_op_type``
    holds the device time of the kernels each op type launched, from
    the ranges' host-side events; their device-side copies are left out
    of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def annotated(node, fn):
        def run(input_vals, ectx):
            with record_function(OP_RANGE + node.op_type):
                return fn(input_vals, ectx)
        return run

    for node in nodes:
        node.compute = annotated(node, node.compute)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for node in nodes:
            del node.compute
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.key.startswith(OP_RANGE)]
    by_op_type = {e.key[len(OP_RANGE):]: {"ms": e.device_time_total / 1e3,
                                          "count": e.count}
                  for e in events if e.key.startswith(OP_RANGE)
                  and e.device_type == DeviceType.CPU}
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
            "flash_fwd_kernel_ms": kernel_ms("flash_fwd"),
            "flash_bwd_dkv_kernel_ms": kernel_ms("flash_bwd_dkv"),
            "flash_bwd_dq_kernel_ms": kernel_ms("flash_bwd_dq"),
            "by_category": {c: {"ms": ms, "count": n}
                            for c, (ms, n) in sorted(
                                by_category.items(), key=lambda x: -x[1][0])},
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top],
            **({"device_ms_by_op_type": dict(sorted(
                by_op_type.items(), key=lambda x: -x[1]["ms"]))}
               if nodes else {})}


def bert_train_flops(batch, seq, hidden, layers, heads, intermediate,
                     vocab):
    """Analytic FLOPs of one BERT MLM training step (bench.py:54: the
    backward counts 2x the forward). Per token forward: QKVO projections
    8h^2, scores and context 4sh, FFN 4hi, the MLM head over every
    position 2hV; embeddings, LayerNorm and softmax are O(h) and left
    out, so the MFU it gives is conservative."""
    per_token = layers * (8 * hidden * hidden + 4 * seq * hidden
                          + 4 * hidden * intermediate) + 2 * hidden * vocab
    return 3.0 * per_token * batch * seq


def bert_feed_values(feed_nodes, batch, seq, vocab, lengths, seed):
    """The feeds of bench.py's BERT passes (``_feed_values``,
    __graft_entry__.py:47-57: random ids, token types, MLM labels and NSP
    labels), except that each row keeps a length drawn uniformly from
    ``lengths`` in its attention mask and its MLM labels are -1 on the
    padding, so the padding mask masks."""
    rng = np.random.RandomState(seed)
    input_ids, token_type_ids, attention_mask, mlm_labels, nsp_label = \
        feed_nodes
    values = {
        input_ids: rng.randint(0, vocab, (batch, seq)),
        token_type_ids: rng.randint(0, 2, (batch, seq)),
        attention_mask: np.ones((batch, seq), np.float32),
        mlm_labels: rng.randint(0, vocab, (batch, seq)),
        nsp_label: rng.randint(0, 2, (batch,)),
    }
    keep = np.arange(seq)[None] < rng.randint(lengths[0], lengths[1] + 1,
                                              (batch, 1))
    values[attention_mask] = keep.astype(np.float32)
    values[mlm_labels][~keep] = -1
    return values


def bert_train(torch, seed, card, name):
    """One BERT pass of BERT_PASSES: BertForPreTraining (MLM + NSP, flash
    attention under the padding mask, dropout 0.1) trained with Adam in
    bf16 through Executor.run on one fixed batch (train_pass: a parity
    step with the plain kernels swapped in — K1 below FUSED_BWD_MIN_SEQ,
    K2-K4 from it on — then warm-up and timed steps with the kernels);
    then one profiled step and one with each op's host time taken."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import attention as attn
    from hetu_tpu_torch.ops import flash_attention as fa

    spec = BERT_PASSES[name]
    widths = spec["widths"]
    cfg = M.BertConfig(**widths, use_flash_attention=True)
    batch, seq = spec["batch"], widths["max_position_embeddings"]
    feed_nodes = [ht.Variable(n, trainable=False) for n in BERT_FEEDS]
    _, _, mlm_loss, nsp_loss = M.BertForPreTraining(cfg)(*feed_nodes)
    loss = ht.reduce_mean_op(mlm_loss, [0, 1]) + \
        ht.reduce_mean_op(nsp_loss, [0])
    opt = ht.optim.AdamOptimizer(learning_rate=TRAIN_LR)
    train_op = opt.minimize(loss)
    # the layer-0 query / key / value weights' gradients: dq, dk, dv of
    # layer 0 mapped back through the projections
    qkv = [next(i for i, p in enumerate(opt.params)
                if p.name == f"layer0_attn_{w}_weights")
           for w in ("query", "key", "value")]
    nodes = [loss] + [train_op.inputs[i] for i in qkv] + [train_op]
    feeds = {node: torch.as_tensor(v, device="cuda") for node, v in
             bert_feed_values(feed_nodes, batch, seq, widths["vocab_size"],
                              spec["lengths"], seed).items()}

    steps = spec["warmup"] + spec["steps"]
    fused = seq >= attn.FUSED_BWD_MIN_SEQ
    plain = ({"flash_attention_with_lse": fa.flash_attention_with_lse_plain,
              "flash_attention_bwd": fa.flash_attention_bwd_plain}
             if fused else {"flash_attention": fa.flash_attention_plain})
    exe, run = train_pass(torch, nodes, feeds, plain, steps)
    on, off = ((fa.K2, fa.K3, fa.K4), (fa.K1,)) if fused \
        else ((fa.K1,), (fa.K2, fa.K3, fa.K4))
    got, parity = check_pass(
        name, run, _route_counts(on, off, cfg.num_hidden_layers * steps),
        dict(zip("qkv", zip(run["kernel_grads"], run["plain_grads"]))))
    timed = run["step_ms"][spec["warmup"]:]
    p50 = float(np.median(timed))
    flops = bert_train_flops(batch, seq, widths["hidden_size"],
                             widths["num_hidden_layers"],
                             widths["num_attention_heads"],
                             widths["intermediate_size"],
                             widths["vocab_size"])
    return {"card": card, "model": spec["model"], **widths,
            "batch": batch, "seq": seq, "padded_lengths": spec["lengths"],
            "dtype": "bfloat16", "dropout": cfg.hidden_dropout_prob,
            "optimizer": "Adam", "lr": TRAIN_LR, "seed": seed,
            "executor_setup_s": run["setup_s"],
            "warmup_steps": spec["warmup"], "timed_steps": spec["steps"],
            "tokens_per_s": batch * seq * len(timed) / (sum(timed) / 1e3),
            "step_ms_p50": p50, "step_ms": run["step_ms"],
            "flops_per_step": flops,
            "mfu": flops / (p50 / 1e3) / PEAK_FLOPS["bfloat16"],
            "losses": run["losses"], "launches": got,
            "peak_memory_bytes": int(run["peak"]),
            "parity": {"plain": sorted(plain), **parity},
            "profile": profile_train_step(torch, exe, feeds),
            "host": host_ms_by_op(torch, exe, feeds)}, run["launches"]


def host_ms_by_op(torch, exe, feeds, name="default"):
    """One more step of subgraph ``name`` with every op's ``compute``
    timed on the host clock, summed by op type: the host's time in each
    op, launches included, not the device's (an op that waits for the
    device, as the optimizer's ``torch.unique`` does, also counts the
    device work queued before it). Also the host time of making one
    per-op generator on the card, which every dropout op and its
    gradient op pay."""
    from hetu_tpu_torch.graph.node import ExecContext
    sub = exe.subexecutors[name]
    totals = {}

    def timed(node, fn):
        def run(input_vals, ectx):
            t0 = time.perf_counter()
            try:
                return fn(input_vals, ectx)
            finally:
                ms, n = totals.get(node.op_type, (0.0, 0))
                totals[node.op_type] = (
                    ms + (time.perf_counter() - t0) * 1e3, n + 1)
        return run

    for node in sub.topo_order:
        node.compute = timed(node, node.compute)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(name, feed_dict=feeds)[0].asnumpy()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for node in sub.topo_order:
            del node.compute
    ectx = ExecContext(device=torch.device("cuda"))
    op = sub.topo_order[-1]
    t0 = time.perf_counter()
    for _ in range(100):
        ectx.generator_for(op)
    gen_us = (time.perf_counter() - t0) * 1e4
    by_type = sorted(totals.items(), key=lambda x: -x[1][0])
    return {"wall_ms": wall_ms,
            "ops_ms": sum(ms for ms, _ in totals.values()),
            "generator_us": gen_us,
            "by_op_type": {t: {"ms": ms, "count": n}
                           for t, (ms, n) in by_type}}


# ---------------------------------------------------------------------------
# the CNN zoo: VGG-16 and ResNet-18 through dataloaders, digits to accuracy
# ---------------------------------------------------------------------------

def cnn_forward_flops(loss):
    """FLOPs of one forward pass: 2 x the multiply-adds of every
    convolution and matmul, from the shapes the executor inferred (the
    elementwise, norm and pool work is O(activations) and left out)."""
    from hetu_tpu_torch.graph.autodiff import find_topo_sort
    from hetu_tpu_torch.ops.conv import Conv2dOp
    from hetu_tpu_torch.ops.linalg import MatMulOp
    flops = 0
    for node in find_topo_sort([loss]):
        if isinstance(node, Conv2dOp):
            _, c, kh, kw = node.inputs[1].inferred_shape
            flops += 2 * int(np.prod(node.inferred_shape)) * c * kh * kw
        elif isinstance(node, MatMulOp):
            a = node.inputs[0].inferred_shape
            k = a[0] if node.matmul_attr_trans_A else a[1]
            flops += 2 * int(np.prod(node.inferred_shape)) * k
    return flops


def _cnn_graph(ht, model, lr, x, y_, grads):
    """``model`` over (x, y_) with MomentumOptimizer(lr): (loss, the
    gradient nodes of the parameters named ``grads``, the train op)."""
    loss, _ = getattr(ht.models, model)(x, y_)
    opt = ht.optim.MomentumOptimizer(lr)
    train_op = opt.minimize(loss)
    picked = [next(g for p, g in zip(opt.params, train_op.inputs)
                   if p.name == name) for name in grads]
    return loss, picked, train_op


def cnn_parity(torch, spec, x, y):
    """One step of the pass's graph from the same weights and batch on
    the card in f32, on the CPU in float64 and on the CPU in f32: the
    card's loss and the two gradients of ``spec["grads"]`` held to
    CNN_LOSS_TOL and CNN_GRAD_TOL against float64's; the CPU's f32 run
    against float64 and the card against it reported beside."""
    import hetu_tpu_torch as ht
    out = {}
    for run, device, dtype in (("cuda", "cuda", None),
                               ("cpu_f64", "cpu", torch.float64),
                               ("cpu", "cpu", None)):
        px = ht.Variable("x", trainable=False)
        py = ht.Variable("y_", trainable=False)
        loss, grads, train_op = _cnn_graph(ht, spec["model"], spec["lr"],
                                           px, py, spec["grads"])
        exe = ht.Executor([loss, *grads, train_op], device=device,
                          dtype=dtype)
        vals = exe.run(feed_dict={px: x, py: y})[:-1]
        out[run] = [np.asarray(v.asnumpy(), np.float64) for v in vals]

    def errs(got, want):
        (gl, *gg), (wl, *wg) = out[got], out[want]
        return {"loss_rel_err": float(abs(gl - wl) / abs(wl)),
                "grad_rel_err": {name: float(np.abs(g - w).max()
                                             / np.abs(w).max())
                                 for name, g, w in zip(spec["grads"], gg,
                                                       wg)}}
    parity = {"batch": int(x.shape[0]), "reference": "cpu float64",
              "loss_cuda": float(out["cuda"][0]),
              "loss_cpu_f64": float(out["cpu_f64"][0]),
              **errs("cuda", "cpu_f64"), "loss_tol": CNN_LOSS_TOL,
              "grad_tol": CNN_GRAD_TOL,
              "cpu_f32_vs_f64": errs("cpu", "cpu_f64"),
              "cuda_vs_cpu_f32": errs("cuda", "cpu")}
    if parity["loss_rel_err"] > CNN_LOSS_TOL or \
            max(parity["grad_rel_err"].values()) > CNN_GRAD_TOL:
        raise AssertionError(f"{spec['model']} step-1 parity, card against "
                             f"the CPU in float64, failed: {parity}")
    return parity


def _k1_k4_launches(launches):
    from hetu_tpu_torch.ops import flash_attention as fa
    return {k: launches.get(k, 0) for k in (fa.K1, fa.K2, fa.K3, fa.K4)}


def _cnn_category(op_type):
    return next((c for c, prefixes in CNN_OP_CATEGORIES
                 if op_type.startswith(prefixes)), "elementwise / other")


def cnn_train(torch, name, card, cifar):
    """One pass of CNN_PASSES: the main path — a train subgraph fed by
    dataloader ops over ``cifar`` (the arrays of ht.data.cifar10()),
    CNN_WARMUP + CNN_STEPS steps at B=128 with the launch counts set to
    0 just before and read just after (no flash kernel may launch) —
    then one profiled step (idle share, device time by kernel category),
    one profiled with a range per op (device time by op type and op
    category), one with each op's host time taken, and the step-1
    parity of the card against the CPU (B=8, cnn_parity)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    spec = CNN_PASSES[name]
    tx, ty = cifar[0], cifar[1]
    x = ht.dataloader_op([ht.Dataloader(tx, CNN_BATCH, "train")])
    y_ = ht.dataloader_op([ht.Dataloader(ty, CNN_BATCH, "train")])
    loss, _, train_op = _cnn_graph(ht, spec["model"], spec["lr"], x, y_, ())
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    exe = ht.Executor({"train": [loss, train_op]})
    setup_s = time.perf_counter() - t0
    losses, step_ms = [], []
    for _ in range(CNN_WARMUP + CNN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(exe.run("train")[0].asnumpy()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} loss not finite and falling: {losses}")
    if any(launches.values()):
        raise AssertionError(f"{name} launched flash kernels: {launches}")

    timed = step_ms[CNN_WARMUP:]
    p50 = float(np.median(timed))
    flops = 3 * cnn_forward_flops(loss)             # backward = 2 forwards

    def step():
        return exe.run("train")[0].asnumpy()
    profile = profile_window(torch, step)
    by_op_type = profile_window(
        torch, step, exe.subexecutors["train"].topo_order)[
            "device_ms_by_op_type"]
    by_cat = {}
    for op_type, v in by_op_type.items():
        cat = _cnn_category(op_type)
        by_cat[cat] = by_cat.get(cat, 0.0) + v["ms"]
    profile["device_ms_by_op_type"] = by_op_type
    profile["device_ms_by_op_category"] = dict(
        sorted(by_cat.items(), key=lambda x: -x[1]))
    host = host_ms_by_op(torch, exe, None, "train")
    n_params = sum(int(v.numel()) for v in exe.params.values())
    n_state = len(exe.state)
    del exe
    torch.cuda.empty_cache()
    # after the timed steps: the CPU's threads, busy with its
    # convolutions, would compete with the host walk of steps after them
    parity = cnn_parity(torch, spec, tx[:CNN_PARITY_BATCH],
                        ty[:CNN_PARITY_BATCH])
    return {"card": card, "model": spec["model"], "params": n_params,
            "stateful_ops": n_state, "batch": CNN_BATCH,
            "image": list(tx.shape[1:]), "dtype": "float32",
            "optimizer": "Momentum", "lr": spec["lr"],
            "data": "ht.data.cifar10() through dataloader ops",
            "executor_setup_s": setup_s, "warmup_steps": CNN_WARMUP,
            "timed_steps": CNN_STEPS,
            "images_per_s": CNN_BATCH * len(timed) / (sum(timed) / 1e3),
            "step_ms_p50": p50, "step_ms": step_ms,
            "flops_per_step": flops,
            "mfu": flops / (p50 / 1e3) / PEAK_FLOPS["float32"],
            "losses": losses, "launches": launches,
            "peak_memory_bytes": int(peak), "parity": parity,
            "profile": profile, "host": host}


def cnn_digits(torch, card):
    """The port's cnn_main.run() with CNN_DIGITS_ARGS on the card: held
    to CNN_DIGITS_MIN_ACC held-out accuracy, no flash kernel launched."""
    from hetu_tpu_torch import data
    from hetu_tpu_torch.examples import cnn_main
    from hetu_tpu_torch.ops import _build
    args = cnn_main.parse_args(list(CNN_DIGITS_ARGS))
    batches = len(data.digits()[0][0]) // args.batch_size
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    results = cnn_main.run(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    if not results["val_acc"] >= CNN_DIGITS_MIN_ACC:
        raise AssertionError(f"cnn_digits val_acc {results['val_acc']} < "
                             f"{CNN_DIGITS_MIN_ACC}: {results}")
    if any(launches.values()):
        raise AssertionError(f"cnn_digits launched flash kernels: "
                             f"{launches}")
    return {"card": card, "args": " ".join(CNN_DIGITS_ARGS),
            "val_acc": results["val_acc"], "min_val_acc": CNN_DIGITS_MIN_ACC,
            "train_acc": results["train_acc"],
            "train_loss": results["train_loss"],
            "epoch_time_s": results["epoch_time"],
            "steps_per_epoch": batches,
            "steps_per_s": batches / results["epoch_time"],
            "wall_s": wall_s, "launches": launches}


def crossover(torch, seed):
    """Per sequence length (B*H = 96, D=64, bf16, causal), and at
    BERT-base's shape (B=64 H=12 S=128, non-causal, BERT's padding mask):
    one training attention forward + backward through the fused kernels
    (K2, then K3 + K4) against K1 + the composed autograd backward — the
    two routes FlashAttentionOp / its gradient op choose between at
    FUSED_BWD_MIN_SEQ."""
    from hetu_tpu_torch.ops import attention as attn
    from hetu_tpu_torch.ops import flash_attention as fa
    d = 64
    scale = d ** -0.5
    cases = [(TRAIN_BATCH, 12, s, True, None) for s in CROSSOVER_SEQ]
    cases.append((BERT_K1_REP["b"], BERT_K1_REP["h"], BERT_K1_REP["s"],
                  False, "padding"))
    out = []
    for b, h, s, causal, masked in cases:
        g = torch.Generator(device="cuda").manual_seed(seed + s)
        q, k, v, do = (torch.randn(b, h, s, d, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        mask = padding_mask(torch, b, s, torch.bfloat16, g) if masked \
            else None

        def fused():
            o, lse = fa.flash_attention_with_lse(q, k, v, mask, scale,
                                                 causal)
            return fa.flash_attention_bwd(q, k, v, mask, o, lse, do, scale,
                                          causal)

        def composed():
            fa.flash_attention(q, k, v, mask, scale, causal)
            m = mask
            if causal:
                m = attn._causal_mask(s, q.device)
            _, vjp = torch.func.vjp(
                lambda q_, k_, v_: attn.attention_reference(
                    q_, k_, v_, m, scale), q, k, v)
            return vjp(do)

        out.append({"s": s, "b": b, "h": h, "d": d, "dtype": "bfloat16",
                    "causal": causal, "mask": masked,
                    "fused_ms": median_ms(torch, fused, reps=5),
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


def _margin_checked(rows):
    """(tokens, positions checked, smallest margin) of teacher-forced
    logit rows: the argmax of each, and how many lead positions have a
    top-2 gap of at least MARGIN_TOL (argmax may flip past the first
    that does not)."""
    top2 = np.sort(rows, axis=-1)[:, -2:]
    margins = top2[:, 1] - top2[:, 0]
    low = margins < MARGIN_TOL
    checked = int(np.argmax(low)) if low.any() else len(rows)
    return rows.argmax(axis=-1), checked, float(margins.min())


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
    # the f32 serving path: every K1 launch on the CUDA-core route
    if launches.get(f"{fa.K1}.simt", 0) != launches[fa.K1] or \
            launches.get(f"{fa.K1}.tc", 0):
        raise AssertionError(f"serve K1 launches off the simt route: "
                             f"{launches}")

    # token parity of request 0: the same engine with the plain blocked
    # attention swapped in for the kernel, up to the first position
    # whose top-2 logit gap is under MARGIN_TOL
    logits = teacher_forced_logits(
        torch, cfg, params, np.concatenate([prompts[0], outs[0][:-1]]))
    tf_tokens, checked, min_margin = _margin_checked(
        logits[len(prompts[0]) - 1:])
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
    if not (np.array_equal(outs[0][:checked], plain_out[0][:checked])
            and np.array_equal(outs[0][:checked], tf_tokens[:checked])):
        raise AssertionError(
            f"request 0 tokens disagree within the margin-checked "
            f"{checked} positions: kernel {outs[0].tolist()}, plain "
            f"{plain_out[0].tolist()}, teacher-forced "
            f"{tf_tokens.tolist()}")
    eng4 = engine()
    profile = profile_window(torch, lambda: drive(eng4, prompts, MAX_NEW))
    eng4.close()
    return {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "dtype": "float32", "seed": seed,
            "tf32_matmul": bool(torch.backends.cuda.matmul.allow_tf32),
            "max_new_tokens": MAX_NEW, "num_blocks": NUM_BLOCKS,
            "passes": passes, "launches": launches,
            "parity": {"positions_checked": checked,
                       "min_margin": min_margin,
                       "margin_tol": MARGIN_TOL,
                       "tokens_equal_plain": bool(np.array_equal(
                           outs[0], plain_out[0]))},
            "profile": profile}, launches


# ---------------------------------------------------------------------------
# serve_dense: the request-level serving plane
# ---------------------------------------------------------------------------

def _tensors(tree):
    """The tensors of a nested dict / list / tuple of parameters."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def _post(port, ids, gen, rid):
    """One ``POST /v1/predict`` to the server on 127.0.0.1 (http.client:
    no proxy of the environment is consulted). Returns the reply's JSON
    body; raises on any status but 200 or a request id not echoed."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/predict", body=json.dumps(
            {"inputs": {"ids": ids, "gen": [[gen]] * len(ids)}}),
            headers={"Content-Type": "application/json",
                     "x-request-id": rid})
        resp = conn.getresponse()
        body = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200 or body.get("request_id") != rid or \
            resp.getheader("X-Request-Id") != rid:
        raise AssertionError(f"POST /v1/predict {rid}: {resp.status} "
                             f"{body}")
    return body


def _http_clients(port, prompts, gen):
    """DENSE_CLIENTS closed-loop client threads, each POSTing
    DENSE_PER_CLIENT of ``prompts`` in turn. Returns ({request index:
    tokens}, client latencies in ms)."""
    import threading
    out, latency, errors = {}, [], []

    def client(k):
        try:
            for i in range(k * DENSE_PER_CLIENT, (k + 1) * DENSE_PER_CLIENT):
                t0 = time.perf_counter()
                body = _post(port, prompts[i:i + 1].tolist(), gen,
                             f"dense-{i}")
                latency.append((time.perf_counter() - t0) * 1e3)
                out[i] = np.asarray(body["outputs"][0])
        except Exception as e:                      # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(DENSE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out, latency


def _k1_counts(launches):
    """K1's launches in a run's counts, in total and by route, and K2-K4's
    (which the serving paths never launch)."""
    from hetu_tpu_torch.ops import flash_attention as fa
    return {key: launches.get(key, 0) for key in (
        fa.K1, f"{fa.K1}.simt", f"{fa.K1}.tc", fa.K2, fa.K3, fa.K4)}


def _check_k1_path(name, launches, n):
    """A serving path's launches: K1 ``n`` times, all on ``simt``, and no
    K2-K4."""
    from hetu_tpu_torch.ops import flash_attention as fa
    want = {fa.K1: n, f"{fa.K1}.simt": n, f"{fa.K1}.tc": 0, fa.K2: 0,
            fa.K3: 0, fa.K4: 0}
    got = _k1_counts(launches)
    if n <= 0 or got != want:
        raise AssertionError(f"serve_dense {name} launches {got}, want "
                             f"{want}")
    return got


def serve_dense(torch, seed, card):
    """GPT-2-small (f32) through the request-level plane: an
    InferenceSession restored from an Executor.save checkpoint; two
    GPTDecoders built from_session (sharing its tensors) behind two
    MicroBatchers, a ReplicaRouter and the HTTP frontend; 16 closed-loop
    clients x 4 requests after an untimed warm pass over every batch
    bucket. K1 runs on two main paths, each counted from 0: the decoders'
    prefill under the HTTP traffic (B in {1, 2, 4, 8}, S=256) and the
    session's graph forward under the no-cache recompute (B=8, S=1024).
    Then the parity checks, the prefill and decode-step times, and one
    profiled tick. Returns (line, {path: launch counts})."""
    import tempfile

    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import attention as attn
    from hetu_tpu_torch.ops import flash_attention as fa
    from hetu_tpu_torch.serving import (GPTDecoder, InferenceSession,
                                        MicroBatcher, ReplicaRouter,
                                        ServingHTTPServer, next_bucket)

    torch.cuda.reset_peak_memory_stats()
    cfg = M.GPTConfig(**GPT2_SMALL, hidden_dropout_prob=0.0,
                      use_flash_attention=True)
    ids = ht.Variable("input_ids", trainable=False)
    logits = M.GPTLMHeadModel(cfg)(ids)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        ht.Executor([logits], seed=seed).save(ckpt)
        # another seed: only the checkpoint gives the session its weights
        sess = InferenceSession([logits], checkpoint=ckpt, seed=seed + 1,
                                seq_buckets=(DENSE_SEQ_BUCKET,))
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    shared = {t.data_ptr() for t in sess.params_by_name().values()}
    decs = [GPTDecoder.from_session(sess, cfg,
                                    prompt_buckets=(DENSE_PROMPT_BUCKET,))
            for _ in range(2)]
    for dec in decs:
        # every decoder parameter is one of the session's tensors (the
        # session also holds the graph's position ids)
        if not all(t.data_ptr() in shared for t in _tensors(dec.params)):
            raise AssertionError("GPTDecoder.from_session does not share "
                                 "the session's tensors")
    dec = decs[0]

    rng = np.random.default_rng(seed)
    n_req = DENSE_CLIENTS * DENSE_PER_CLIENT
    pb = DENSE_PROMPT_BUCKET
    prompts = np.stack([
        np.pad(rng.integers(0, cfg.vocab_size, int(n)), (0, pb - int(n)),
               mode="edge")
        for n in rng.integers(16, pb + 1, n_req)])  # the client's padding
    x8 = prompts[:DENSE_MAX_BATCH]

    def tick_fn(d):
        def tick(feeds):
            x, gen = feeds["ids"], int(np.max(feeds["gen"]))
            n = len(x)
            b = next_bucket(n)
            if b > n:
                x = np.concatenate([x, np.repeat(x[-1:], b - n, axis=0)])
            return d.generate(x, gen)[:n]
        return tick

    # the untimed warm pass, on this thread before any server thread
    # launches: every batch bucket on both decoders
    for d in decs:
        b = 1
        while b <= DENSE_MAX_BATCH:
            d.generate(prompts[:b], 2)
            b *= 2
    torch.cuda.synchronize()

    batchers = [MicroBatcher(tick_fn(d), max_batch_size=DENSE_MAX_BATCH,
                             max_wait_ms=DENSE_MAX_WAIT_MS,
                             name=f"replica{i}") for i, d in enumerate(decs)]
    router = ReplicaRouter(batchers)
    srv = ServingHTTPServer(router, host="127.0.0.1")
    try:
        port = srv.start()
        _build.reset_launch_counts()                # prefill path starts
        t0 = time.perf_counter()
        got, latency = _http_clients(port, prompts, MAX_NEW)
        wall = time.perf_counter() - t0
        prefill_counts = dict(_build.launch_counts)  # prefill path ends
        stats = router.stats()["replicas"]
        # one request alone (a tick of one): its tokens against a direct
        # generate of the same prompt
        lone = np.asarray(_post(port, prompts[:1].tolist(), MAX_NEW,
                                "dense-alone")["outputs"][0])
    finally:
        srv.stop()
        for mb in batchers:
            mb.close()
    ticks = sum(r["replica"]["ticks"] for r in stats)
    rows = sum(r["replica"]["rows"] for r in stats)
    routed = [r["routed"] for r in stats]
    for i in range(n_req):
        tok = got[i]
        if tok.shape != (1, MAX_NEW) or tok.min() < 0 or \
                tok.max() >= cfg.vocab_size:
            raise AssertionError(f"serve_dense request {i}: bad tokens {tok}")
    if rows != n_req or sum(routed) != n_req or min(routed) <= 0:
        raise AssertionError(f"serve_dense routed {routed}, {rows} rows in "
                             f"{ticks} ticks for {n_req} requests")
    prefill_launches = _check_k1_path("prefill", prefill_counts,
                                      cfg.num_hidden_layers * ticks)
    direct = dec.generate(prompts[:1], MAX_NEW)
    if not np.array_equal(lone, direct):
        raise AssertionError(f"serve_dense: HTTP tokens {lone.tolist()} "
                             f"!= direct generate {direct.tolist()}")
    # eight of the timed requests, spread over the clients, generated
    # again in one batch of 8: each HTTP reply (served in a tick with
    # other rows and padding) equals its row, and each row the argmax of
    # one teacher-forced session forward over it, up to the row's first
    # top-2 logit gap under MARGIN_TOL
    picked = np.linspace(0, n_req - 1, DENSE_MAX_BATCH).astype(int)
    batch = dec.generate(prompts[picked], MAX_NEW)
    batch_tf = sess.predict({ids: np.concatenate(
        [prompts[picked], batch[:, :-1]], axis=1)})[0][:, pb - 1:]
    batch_checked = []
    for row, i in enumerate(picked):
        tf_row, n_ok, _ = _margin_checked(batch_tf[row])
        if not (np.array_equal(got[i][0, :n_ok], batch[row, :n_ok])
                and np.array_equal(batch[row, :n_ok], tf_row[:n_ok])):
            raise AssertionError(
                f"serve_dense request {i}: HTTP tokens {got[i].tolist()}, "
                f"batch-of-8 generate {batch[row].tolist()}, teacher-"
                f"forced {tf_row.tolist()} (first {n_ok} checked)")
        batch_checked.append(n_ok)
    del batch_tf

    # the decode step at B=8 (bench.py:1245-1252) and the prefill of a
    # full tick
    prefill_ms = median_ms(torch, lambda: dec.prefill(x8))
    _, kv = dec.prefill(x8)
    tok = torch.as_tensor(x8[:, -1], device=dec.device)
    step_ms = []
    for t in range(DENSE_DECODE_STEPS):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        last, kv = dec.decode_step(kv, tok, pb + t)
        tok = last.argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
    del kv, last

    # the no-cache recompute through the session (bench.py:1233-1242):
    # K1's second path
    sess.predict({ids: x8})                         # untimed warm call
    _build.reset_launch_counts()                    # session path starts
    cur = x8
    t0 = time.perf_counter()
    for _ in range(DENSE_NO_CACHE_STEPS):
        full = sess.predict({ids: cur})[0]
        cur = np.concatenate([cur, full[:, -1].argmax(-1)[:, None]], axis=1)
        del full                        # [8, S, V] f32 on the host
    no_cache_s = time.perf_counter() - t0
    session_counts = dict(_build.launch_counts)     # session path ends
    session_launches = _check_k1_path(
        "session", session_counts,
        cfg.num_hidden_layers * DENSE_NO_CACHE_STEPS)

    # the cached chain against the no-cache one: one teacher-forced
    # forward over the prompt and the generated tokens gives every
    # step's no-cache logits (the chains share their inputs up to the
    # first disagreement)
    chain = np.concatenate([prompts[0], lone[0, :-1]])[None]
    tf_tokens, checked, min_margin = _margin_checked(
        sess.predict({ids: chain})[0][0, pb - 1:])
    # K1 swapped for its plain version: the decoder's tokens, and the
    # session's logits at B=8 over inputs that fill the 1024 bucket, so
    # every query row of K1 reaches the compared logits
    x_full = rng.integers(0, cfg.vocab_size, (DENSE_MAX_BATCH,
                                               DENSE_SEQ_BUCKET))
    logits_k1 = sess.predict({ids: x_full})[0]
    kernel_fa = attn.flash_attention
    attn.flash_attention = fa.flash_attention_plain
    try:
        plain_tokens = dec.generate(prompts[:1], MAX_NEW)
        logits_plain = sess.predict({ids: x_full})[0]
    finally:
        attn.flash_attention = kernel_fa
    logit_err = float(np.abs(logits_k1 - logits_plain).max())
    logits_ok = bool(np.allclose(logits_k1, logits_plain,
                                 atol=DENSE_LOGIT_TOL, rtol=DENSE_LOGIT_TOL))
    logit_scale = float(np.abs(logits_plain).max())
    del logits_k1, logits_plain
    parity = {"http_equals_direct_generate": True,
              "http_equals_batch_generate": True,
              "batch_requests": picked.tolist(),
              "batch_positions_checked": batch_checked,
              "positions_checked": checked, "min_margin": min_margin,
              "margin_tol": MARGIN_TOL,
              "cached_equals_no_cache": bool(np.array_equal(
                  lone[0, :checked], tf_tokens[:checked])),
              "plain_k1_decoder_equal": bool(np.array_equal(
                  lone[0, :checked], plain_tokens[0, :checked])),
              "plain_k1_decoder_all_equal": bool(np.array_equal(
                  lone, plain_tokens)),
              "session_logits_max_abs_err": logit_err,
              "session_logits_max_abs": logit_scale,
              "session_logits_tol": DENSE_LOGIT_TOL,
              "session_logits_ok": logits_ok}
    if not (parity["cached_equals_no_cache"]
            and parity["plain_k1_decoder_equal"] and logits_ok):
        raise AssertionError(f"serve_dense parity failed: {parity}; "
                             f"cached {lone.tolist()}, no-cache "
                             f"{tf_tokens.tolist()}, plain K1 "
                             f"{plain_tokens.tolist()}")

    tick = tick_fn(dec)
    profile = profile_window(torch, lambda: tick(
        {"ids": x8, "gen": np.full((len(x8), 1), MAX_NEW)}))
    peak = torch.cuda.max_memory_allocated()
    sess.close()
    del sess, decs, dec
    torch.cuda.empty_cache()
    tokens = n_req * MAX_NEW
    line = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "dtype": "float32", "seed": seed,
            "stack": "HTTP -> ReplicaRouter -> 2 x MicroBatcher -> "
                     "GPTDecoder.from_session(InferenceSession)",
            "setup_s": setup_s, "clients": DENSE_CLIENTS,
            "requests_per_client": DENSE_PER_CLIENT,
            "prompt_tokens": [16, pb], "prompt_bucket": pb,
            "seq_bucket": DENSE_SEQ_BUCKET, "max_new_tokens": MAX_NEW,
            "max_batch_size": DENSE_MAX_BATCH,
            "max_wait_ms": DENSE_MAX_WAIT_MS,
            "requests": n_req, "wall_s": wall,
            "requests_per_s": n_req / wall, "tokens_per_s": tokens / wall,
            "latency_ms_p50": float(np.percentile(latency, 50)),
            "latency_ms_p95": float(np.percentile(latency, 95)),
            "ticks": ticks, "rows": rows,
            "mean_batch_occupancy": rows / (ticks * DENSE_MAX_BATCH),
            "routed_per_replica": routed,
            "prefill_ms_b8_p256": prefill_ms,
            "decode_step_ms_p50": float(np.median(step_ms)),
            "decode_step_ms": step_ms,
            "no_cache_tokens_per_s":
                DENSE_NO_CACHE_STEPS * len(x8) / no_cache_s,
            "k1_launches": {"prefill": prefill_launches,
                            "session": session_launches},
            "parity": parity, "profile_tick_b8": profile,
            "peak_memory_bytes": int(peak)}
    return line, {"prefill": prefill_counts, "session": session_counts}


def ptxas_report(log_text):
    """Registers and spills of every kernel instantiation in one
    ``nvcc -Xptxas -v`` log, by ptxas's (mangled) entry name:
    [{"kernel": name, "registers": N, "spill_stores": B,
    "spill_loads": B}]."""
    out, cur = [], None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int,
                                                              m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
    return out


# the two sources of each kernel family, by route
SOURCES = {"fwd": {"tc": CSRC + "flash_fwd_tc.cu",
                   "simt": CSRC + "flash_fwd.cu"},
           "bwd": {"tc": CSRC + "flash_bwd_tc.cu",
                   "simt": CSRC + "flash_bwd.cu"}}


def _kernel_row(name, family, replaces, keys, paths, rows, library):
    """One kernel of the ``kernels`` line. ``paths`` is [(main path,
    its launch counts, its shape in ``rows``)]: ``launches`` sums the
    launch-count ``keys`` over the paths (``launches_by_path`` by route
    too), and the first path's row gives the top-level numbers and
    ``source`` (by its route); ``main_path_rows`` holds every path's."""
    reps = [next(r for r in rows if _is(r, rep)) for _, _, rep in paths]
    by_path = {path: {k: counts.get(k, 0) for k in
                      (*keys, *(f"{k}.{route}" for k in keys
                                for route in ("tc", "simt")))}
               for path, counts, _ in paths}
    rep = reps[0]
    main_rows = [
        {"path": path, "source": SOURCES[family][r["route"]],
         **{k: r[k] for k in ("b", "h", "s", "d", "dtype", "causal", "mask",
                              "route", "max_abs_err", "ms", "device_ms",
                              "host_ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "library_device_ms")}}
        for (path, _, _), r in zip(paths, reps)]
    return {"name": name, "route": "cuda",
            "source": SOURCES[family][rep["route"]],
            "replaces": replaces,
            "launches": sum(min(c[k] for k in keys) for c in by_path.values()),
            "launches_by_path": by_path,
            "shape": {k: rep[k] for k in ("b", "h", "s", "d", "dtype",
                                          "causal", "mask")},
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "library": library, "device_ms": rep["device_ms"],
            "library_device_ms": rep["library_device_ms"],
            "host_ms": rep["host_ms"], "kernel_route": rep["route"],
            "sources": SOURCES[family], "main_path_rows": main_rows,
            "checked_shapes": len(rows),
            "max_abs_err_all": _by_case(rows, "max_abs_err"),
            **({"row_rel_err": rep["row_rel_err"],
                "row_rel_err_all": _by_case(rows, "row_rel_err")}
               if "row_rel_err" in rep else {})}


def _by_case(rows, key):
    """The largest ``key`` over rows, by dtype (and route where the rows
    have one: "bfloat16/tc")."""
    out = {}
    for r in rows:
        case = "/".join(filter(None, (r["dtype"], r.get("route"))))
        out[case] = max(out.get(case, 0.0), r[key])
    return out


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

    sources = ["flash_fwd", "flash_fwd_tc", "flash_bwd", "flash_bwd_tc"]
    seconds = _build.build(sources)
    ptxas = {name: ptxas_report(_build.build_log(name)) for name in sources}
    build = {"seconds": seconds, "ptxas": ptxas}
    log(f"build {build}")

    t = time.perf_counter()
    serve_line, serve_launches = serve(torch, args.seed, card)
    log(f"serve ({time.perf_counter() - t:.1f} s) {serve_line}")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    dense_line, dense_launches = serve_dense(torch, args.seed, card)
    log(f"serve_dense ({time.perf_counter() - t:.1f} s) {dense_line}")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    train_line, train_launches = train(torch, args.seed, card)
    log(f"train ({time.perf_counter() - t:.1f} s) {train_line}")

    bert_lines, bert_launches = {}, {}
    for name in BERT_PASSES:
        t = time.perf_counter()
        bert_lines[name], bert_launches[name] = bert_train(
            torch, args.seed, card, name)
        log(f"{name} ({time.perf_counter() - t:.1f} s) {bert_lines[name]}")
        torch.cuda.empty_cache()

    from hetu_tpu_torch import data
    cifar = data.cifar10()
    cnn_lines = {}
    for name in CNN_PASSES:
        t = time.perf_counter()
        cnn_lines[name] = cnn_train(torch, name, card, cifar)
        log(f"{name} ({time.perf_counter() - t:.1f} s) {cnn_lines[name]}")
        torch.cuda.empty_cache()
    del cifar
    t = time.perf_counter()
    cnn_lines["cnn_digits"] = cnn_digits(torch, card)
    log(f"cnn_digits ({time.perf_counter() - t:.1f} s) "
        f"{cnn_lines['cnn_digits']}")

    t = time.perf_counter()
    k1_rows = check_flash_fwd(torch, args.seed)
    train_rows = check_flash_train_kernels(torch, args.seed)
    faults = check_catches_faults(torch, args.seed)
    log(f"kernels checked ({time.perf_counter() - t:.1f} s) {faults}")

    t = time.perf_counter()
    cross = crossover(torch, args.seed)
    log(f"crossover ({time.perf_counter() - t:.1f} s) {cross}")

    pallas = "hetu_tpu/ops/pallas_attention.py:"
    sdpa = "torch.ops.aten._scaled_dot_product_flash_attention"
    eff = ("; with BERT's padding mask (bert_long) "
           "torch.ops.aten._scaled_dot_product_efficient_attention")
    bias = " (memory-efficient attention, the mask as a [B, H, S, S] bias)"
    fwd_paths = [("serve", serve_launches, K1_REP),
                 ("serve_dense.prefill", dense_launches["prefill"],
                  K1_PREFILL_REP),
                 ("serve_dense.session", dense_launches["session"],
                  K1_SESSION_REP),
                 ("bert", bert_launches["bert"], BERT_K1_REP)]
    train_paths = [("train", train_launches, TRAIN_REP),
                   ("bert_long", bert_launches["bert_long"], BERT_LONG_REP)]
    kernels = {"kernels": [
        _kernel_row("flash_fwd", "fwd", pallas + "346", (fa.K1,),
                    fwd_paths, k1_rows,
                    "torch.nn.functional.scaled_dot_product_attention "
                    "(with the same additive mask)"),
        _kernel_row("flash_fwd_lse", "fwd", pallas + "333", (fa.K2,),
                    train_paths, train_rows["K2"],
                    sdpa + " (bf16 without mask)" + eff + bias),
        _kernel_row("flash_bwd_dkv", "bwd", pallas + "514", (fa.K3,),
                    train_paths, train_rows["K3"],
                    sdpa + "_backward (computes dq, dk and dv: K3 and K4 "
                    "together; bf16 without mask)" + eff + "_backward"
                    + bias),
        _kernel_row("flash_bwd_dq", "bwd", pallas + "526", (fa.K4,),
                    train_paths, train_rows["K4"],
                    "none alone: see flash_bwd_dkv"),
        # K3 + K4 as the path calls them: one flash_attention_bwd, the
        # counterpart of the reference's entry that launches both
        _kernel_row("flash_bwd_pair", "bwd", pallas + "539",
                    (fa.K3, fa.K4), train_paths, train_rows["pair"],
                    sdpa + "_backward (bf16 without mask)" + eff
                    + "_backward" + bias),
    ]}
    shapes = {"kernel_shapes": {"flash_fwd": k1_rows, **{
        row["name"]: train_rows[key] for key, row in
        zip(("K2", "K3", "K4", "pair"), kernels["kernels"][1:])}}}
    lines = [{"device": device}, {"build": build}, shapes,
             {"check_faults": faults}, {"serve": serve_line},
             {"serve_dense": dense_line}, {"train": train_line},
             *({name: line} for name, line in bert_lines.items()),
             *({name: line} for name, line in cnn_lines.items()),
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
