#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``hetu_tpu_torch``).

    python3 chip_smoke.py [--seed N]

Run from a checkout of the repository on a machine with one NVIDIA GPU
and the CUDA toolkit. It builds every hand-written kernel from the
sources in the checkout, drives the port's main path — GPT-2-small
(full width, random weights from a seed) served through
``ContinuousBatchingEngine`` — checks every kernel against its plain
PyTorch version on the card, and prints one JSON object per line:

* ``device``  the card (name and power limit from nvidia-smi), torch and
  CUDA versions;
* ``build``   seconds spent compiling each kernel, and ptxas's summary;
* ``kernels`` per kernel: launches on the main path, error against the
  plain version at every checked shape, median times of the kernel, of
  the plain version and of the one PyTorch call computing the same
  function, and the least time the card could take (``bound_ms``);
* ``serve``   per pass: tokens/s, TTFT p50, decode step ms, kernel
  launches, and the token-parity check against the plain attention;

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

# the GPT-2-small serving widths (bench.py's gpt2-small)
GPT2_SMALL = dict(vocab_size=50257, hidden_size=768, num_hidden_layers=12,
                  num_attention_heads=12, max_position_embeddings=1024)
NUM_REQUESTS = 16
MAX_NEW = 32
NUM_BLOCKS = 512            # 512 x 16 positions: 8 concurrent 800-token seqs
MARGIN_TOL = 1e-3           # top-2 logit gap below which argmax may flip


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


def flash_bound(b, h, s, d, dtype_name, causal, masked):
    """Least time for K1's work: max(flops / peak for the dtype, bytes of
    q, k, v, o (+ mask rows) / HBM bandwidth). Causal halves the flops."""
    itemsize = 4 if dtype_name == "float32" else 2
    flops = 4.0 * b * h * s * s * d * (0.5 if causal else 1.0)
    nbytes = 4.0 * b * h * s * d * itemsize + (b * s * 4 if masked else 0)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the traffic and of the kernel inputs")
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

    card = nvidia_smi_line()
    device = {"card": card, "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0]}
    log(f"device {device}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the serving path "
                             "keeps float32 products in float32")

    seconds = _build.build(["flash_fwd"])
    logs = sorted(_build.BUILD_DIR.glob("libflash_fwd_*.log"))
    ptxas = [ln.strip() for f in logs for ln in f.read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    build = {"seconds": seconds, "ptxas": ptxas}
    log(f"build {build}")

    t = time.perf_counter()
    serve_line, launches = serve(torch, args.seed, card)
    log(f"serve ({time.perf_counter() - t:.1f} s) {serve_line}")

    t = time.perf_counter()
    rows = check_flash_fwd(torch, args.seed)
    log(f"kernels checked ({time.perf_counter() - t:.1f} s)")
    # the main path's longest prefill shape: one 1024-token bucket
    rep = next(r for r in rows if (r["b"], r["s"], r["dtype"], r["causal"],
                                   r["mask"]) == (1, 1024, "float32", True,
                                                  False))
    kernels = {"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "hetu_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "hetu_tpu/ops/pallas_attention.py:346",
        "launches": launches.get("flash_fwd", 0),
        "shape": {k: rep[k] for k in ("b", "h", "s", "d", "dtype",
                                      "causal", "mask")},
        "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
        "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "max_abs_err_all": {dt: max(r["max_abs_err"] for r in rows
                                    if r["dtype"] == dt)
                            for dt in ("float32", "bfloat16")},
        "shapes": rows}]}

    print(json.dumps({"device": device}), flush=True)
    print(json.dumps({"build": build}), flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"serve": serve_line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
