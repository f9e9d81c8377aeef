"""Two measurements behind ``chip_smoke.py``'s wall, on the card.

* **The launcher's start-up**, both ways: ``python -m
  hetu_tpu_torch.launcher --help`` (the package's ``__init__``, which
  imports torch, runs first) against ``python
  hetu_tpu_torch/run_launcher.py --help`` (the same main by path, no
  torch), in the order module, path, path, module, ``--rounds`` times;
  wall seconds of each process. ``chip_smoke.py`` starts every launcher
  job by path.
* **``distgcn_local`` alone, repeated**: ``chip_smoke.py``'s 2-layer
  GCN through ``distgcn_15d_op`` at (gr, gc) = (2, 2) on the
  OGB-arxiv-sized graph as four thread ranks of this process, run
  ``--repeat`` times, and once more right after ``distgcn``'s
  four-process launcher job, as ``chip_smoke.py`` orders them. For each
  epoch: its milliseconds, and each rank's collectives by kind (calls,
  seconds, the slowest call), with every call over ``--slow-s`` listed
  by rank, kind, start and length within the epoch. A thread of this
  process wakes every millisecond and records how late it woke (the
  longest wake-up an epoch): a late wake-up while a collective stalls
  means the GIL was held, a prompt one means the stall was outside
  Python.

Run from the repository's root on a machine with one CUDA card::

    python3 smoke_wall_probe.py [--out probe.json]

It prints one JSON object and the card's ``nvidia-smi`` name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

import chip_smoke as cs
import hetu_tpu_torch as ht
from hetu_tpu_torch.ops.comm import GroupComm

ROOT = os.path.dirname(os.path.abspath(__file__))


def launcher_startup(rounds):
    """Seconds of each ``--help`` start, by entry point, in the order
    module, path, path, module a round."""
    cmds = {"module": [sys.executable, "-m", "hetu_tpu_torch.launcher",
                       "--help"],
            "path": [sys.executable, cs.LAUNCHER, "--help"]}
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    out = {k: [] for k in cmds}
    for _ in range(rounds):
        for k in ("module", "path", "path", "module"):
            t = time.perf_counter()
            subprocess.run(cmds[k], cwd=ROOT, env=env, check=True,
                           stdout=subprocess.DEVNULL)
            out[k].append(time.perf_counter() - t)
    return {k: {"seconds": v, "median": float(np.median(v))}
            for k, v in out.items()}


class Calls:
    """Every collective's (thread, kind, start, end, bytes), through
    GroupComm's counter."""

    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()
        self._orig = GroupComm._count
        calls, lock, orig = self.calls, self._lock, self._orig

        def count(comm, kind, t0, nbytes, seconds=None):
            end = time.perf_counter()
            with lock:
                calls.append((threading.current_thread().name, kind, t0,
                              end, nbytes))
            return orig(comm, kind, t0, nbytes, seconds)
        GroupComm._count = count

    def close(self):
        GroupComm._count = self._orig

    def between(self, t0, t1):
        with self._lock:
            return [c for c in self.calls if t0 <= c[2] and c[3] <= t1]


class Waker:
    """A thread that sleeps a millisecond at a time and keeps how late
    each wake-up came (seconds, with its time)."""

    def __init__(self):
        self.late = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self._stop.is_set():
            t = time.perf_counter()
            time.sleep(0.001)
            now = time.perf_counter()
            self.late.append((now, now - t - 0.001))

    def worst(self, t0, t1):
        return max((d for t, d in self.late if t0 <= t <= t1), default=0.0)

    def close(self):
        self._stop.set()
        self._t.join()


def local_run(seed, graph, calls, waker, slow_s, device="cuda"):
    """One ``distgcn_local``: step 1, then chip_smoke's warm-up and timed
    epochs, each with its collectives by rank and kind (``device="cpu"``
    rehearses it on a small graph)."""
    t = time.perf_counter()
    mesh = ht.parallel.build_mesh(cs.DISTGCN_MESH)
    exe, feeds, train_op = cs._distgcn_session(ht, seed, graph, mesh,
                                               device)
    for r in exe.ranks:
        for axis in ("gr", "gc"):
            r.config.mesh.comm(axis).sync_timing = True
    setup_s = time.perf_counter() - t
    cs._distgcn_step1(exe, feeds, train_op)
    epochs = []
    for _ in range(cs.DISTGCN_WARMUP + cs.DISTGCN_EPOCHS):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(exe.run("train", feed_dict=feeds)[0].asnumpy())
        t1 = time.perf_counter()
        inside = calls.between(t0, t1)
        by_rank = {}
        for name, kind, a, b, _ in inside:
            st = by_rank.setdefault(name, {}).setdefault(
                kind, {"calls": 0, "seconds": 0.0, "slowest_s": 0.0})
            st["calls"] += 1
            st["seconds"] += b - a
            st["slowest_s"] = max(st["slowest_s"], b - a)
        epochs.append({
            "ms": (t1 - t0) * 1e3, "loss": loss, "collectives": by_rank,
            "worst_wakeup_late_s": waker.worst(t0, t1),
            "slow_calls": [{"rank": name, "kind": kind,
                            "start_s": a - t0, "seconds": b - a,
                            "bytes": nbytes}
                           for name, kind, a, b, nbytes in inside
                           if b - a > slow_s]})
    exe.close()
    del exe, feeds
    cs._release(torch)
    return {"setup_s": setup_s, "epochs": epochs,
            "timed_ms": [e["ms"] for e in epochs[cs.DISTGCN_WARMUP:]]}


def job_run(seed, graph):
    """``distgcn``'s four-process launcher job as chip_smoke.py starts it;
    each rank's epoch milliseconds."""
    out_dir = tempfile.mkdtemp(prefix="probe_distgcn_")
    try:
        wall, _ = cs._launch_job(
            "distgcn", f"spmd: true\nnodes:\n  - host: localhost\n"
            f"    workers: {cs.DISTGCN_RANKS}\n    chief: true\n",
            "--distgcn-worker", {"seed": seed, "out": out_dir,
                                 "device": "cuda",
                                 "nodes": int(graph[0].shape[0])},
            cs.DISTGCN_TIMEOUT_S, False)
        ms = []
        for r in range(cs.DISTGCN_RANKS):
            with open(os.path.join(out_dir, f"worker_{r}.json")) as f:
                ms.append(json.load(f)["epoch_ms"])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"launcher_wall_s": wall, "epoch_ms_by_rank": ms}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--slow-s", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("smoke_wall_probe.py needs a CUDA card", file=sys.stderr)
        return 1
    card = cs.nvidia_smi_line()
    result = {"card": card,
              "launcher_startup": launcher_startup(args.rounds)}
    cs.log(f"launcher start-up {result['launcher_startup']}")
    graph = cs.gnn_graph()
    calls, waker = Calls(), Waker()
    try:
        runs = []
        for i in range(args.repeat):
            runs.append({"after": "nothing" if i == 0 else "local",
                         **local_run(args.seed, graph, calls, waker,
                                     args.slow_s)})
            cs.log(f"local run {i}: {runs[-1]['timed_ms']}")
        job = job_run(args.seed, graph)
        cs.log(f"job {job}")
        runs.append({"after": "the launcher job",
                     **local_run(args.seed, graph, calls, waker,
                                 args.slow_s)})
        cs.log(f"local after the job: {runs[-1]['timed_ms']}")
    finally:
        calls.close()
        waker.close()
    result.update(distgcn_local_runs=runs, distgcn_job=job)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
