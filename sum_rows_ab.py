"""A/B of the port's sparse-gradient row sum on the card.

``IndexedSlices.dedup`` and ``.to_dense`` sum a repeated index's rows
through ``hetu_tpu_torch.ndarray._sum_rows``: a stable sort and a
segment sum (in f32 for 16-bit rows). Before, they were one
``index_add_`` into a zeroed tensor, whose atomics on the card add the
rows in the order they land. This script runs ``chip_smoke.py``'s
single-process lines that sum sparse gradients (``train``,
``bert_long``, ``ctr``'s ``wdl_criteo``, and ``ps_wdl`` and
``hybrid_wdl`` from ``ps_passes``) once with each sum, each run in a
process of its own as ``chip_smoke.py`` runs them (so with the same
weights and rows), in the order index_add_, sort, sort, index_add_,
recording every call's shape; then it times both sums on the recorded
inputs of each shape (CUDA events, median) and checks that two sort runs
give equal bits where ``index_add_``'s may not. The multi-process
lines (``hybrid_fleet``) run the port's own sum in their workers and are
not swapped.

Run from the repository's root on a machine with one CUDA card::

    python3 sum_rows_ab.py [--out sum_rows_ab.json]

It prints one JSON object and the card's ``nvidia-smi`` name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as cs
from hetu_tpu_torch import ndarray
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ps import native_lib

SORT = ndarray._sum_rows


def index_add_sum(index, rows, n):
    """The sum this replaced: one ``index_add_`` into zeros."""
    return torch.zeros((n,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                       device=rows.device).index_add_(0, index, rows)


VARIANTS = {"index_add_": index_add_sum, "sort": SORT}
ORDER = ("index_add_", "sort", "sort", "index_add_")


def _recording(fn, seen):
    """``fn``, keeping the first inputs of each (index count, row shape,
    n, dtype) on the host and counting the calls."""
    def run(index, rows, n):
        key = (int(index.shape[0]), tuple(rows.shape[1:]), int(n),
               str(rows.dtype).replace("torch.", ""))
        if key not in seen:
            seen[key] = {"calls": 0,
                         "inputs": (index.cpu(), rows.cpu())}
        seen[key]["calls"] += 1
        return fn(index, rows, n)
    return run


def lines_once(seed, card):
    out = {}
    out["train"] = cs.train(torch, seed, card)[0]["step_ms_p50"]
    torch.cuda.empty_cache()
    out["bert_long"] = cs.bert_train(torch, seed, card,
                                     "bert_long")[0]["step_ms_p50"]
    torch.cuda.empty_cache()
    ctr = cs.sparse_pass(torch, "wdl_criteo", card, seed)
    out["wdl_criteo"] = {k: ctr[k] for k in ("step_ms_p50", "samples_per_s")}
    torch.cuda.empty_cache()
    ps = cs.ps_passes(torch, card, seed)
    for name in ("ps_wdl", "hybrid_wdl"):
        out[name] = {k: ps[name][k] for k in ("step_ms_p50", "samples_per_s")}
    torch.cuda.empty_cache()
    return out


def time_ms(fn, reps=50):
    """Median device time of one call (CUDA events around each)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_variant(name, seed, out_dir):
    """One run of the lines with ``name``'s sum, in this process: their
    numbers and the sum's calls by shape; saves each shape's first
    inputs in ``out_dir``."""
    card = cs.nvidia_smi_line()
    shapes = {}
    ndarray._sum_rows = _recording(VARIANTS[name], shapes)
    t = time.perf_counter()
    line = lines_once(seed, card)
    ndarray._sum_rows = SORT
    rec = {"sum": name, "s": time.perf_counter() - t, **line,
           "sum_calls": {str(k): v["calls"] for k, v in shapes.items()}}
    torch.save({k: v["inputs"] for k, v in shapes.items()},
               os.path.join(out_dir, f"inputs_{name}.pt"))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--run", default=None, choices=sorted(VARIANTS),
                    help=argparse.SUPPRESS)     # one run, in a child
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sum_rows_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    if args.run:
        rec = run_variant(args.run, args.seed, args.dir)
        print(json.dumps(rec))
        return 0
    card = cs.nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build(["flash_fwd", "flash_fwd_tc", "flash_bwd", "flash_bwd_tc"])
    native_lib.build_lib()
    build_s = time.perf_counter() - t0

    runs = []
    with tempfile.TemporaryDirectory(prefix="sum_rows_ab_") as tmp:
        for name in ORDER:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--run", name,
                 "--dir", tmp, "--seed", str(args.seed)],
                stdout=subprocess.PIPE, text=True, check=True, timeout=900)
            runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
            cs.log(f"{name}: {runs[-1]}")
        inputs = torch.load(os.path.join(tmp, "inputs_sort.pt"))

    micro = []
    for (m, shape, n, dtype), (index, rows) in sorted(inputs.items(),
                                                      key=str):
        index, rows = index.cuda(), rows.cuda()
        row = {"indices": m, "row_shape": list(shape), "n": n, "dtype": dtype}
        for name, fn in VARIANTS.items():
            row[f"{name}_ms"] = time_ms(lambda: fn(index, rows, n))
        first = SORT(index, rows, n)
        row["sort_bit_equal_over_5_runs"] = all(
            torch.equal(SORT(index, rows, n), first) for _ in range(5))
        again = index_add_sum(index, rows, n)
        row["index_add_bit_equal_over_5_runs"] = all(
            torch.equal(index_add_sum(index, rows, n), again)
            for _ in range(5))
        row["max_abs_diff"] = (first.double() - again.double()).abs().max() \
            .item() if first.numel() else 0.0
        micro.append(row)

    result = {"card": card, "build_s": build_s, "order": list(ORDER),
              "runs": runs, "sums": micro,
              "wall_s": time.perf_counter() - t0}
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    print(card)
    return 0 if all(r["sort_bit_equal_over_5_runs"] for r in micro) else 1


if __name__ == "__main__":
    sys.exit(main())
