#!/usr/bin/env python3
"""Probe the CPU fault of ROADMAP §3 (fault 1): on a loaded host the
first parallel region of a fresh OpenMP thread team can return a wrong
vectorized ``exp`` for one thread's chunk.

    python3 omp_team_probe.py procs [--n 240] [--parallel 4] [--port]
    python3 omp_team_probe.py fleets [--n 20] [--parallel 2]

``procs`` starts ``--n`` fresh processes, ``--parallel`` at a time, each
with ``OMP_NUM_THREADS=4``; each computes ``torch.exp`` of a fixed
[4, 32, 32] f32 tensor as its first parallel region (with ``--port``,
after ``import hetu_tpu_torch``, which starts the team on a discarded
region first) and counts the elements more than 1e-6 relative from the
float64 exp, and the largest such error. ``fleets`` runs the bf16 GPT of
``tests/test_torch_pipeline_fleet.py`` (four stages round-robin on two
launcher processes, 1F1B, 3 steps) ``--n`` times, every plain K2 call
recorded with its inner values, and compares each worker's calls with
the in-process run's by their inputs (q, k, v bit-equal): a call whose
output differs names the first inner value that does (scores, exp,
sum, p·v). Prints one JSON line of counts. Run it from the repository
root, on the CPU; make load beside it to see the fault (it needs a busy
host).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

_FIRST_EXP = """
import numpy as np, torch
if {port}:
    import hetu_tpu_torch
g = np.random.RandomState(7)
x = torch.from_numpy((-np.abs(g.randn(4, 32, 32)) * 0.6).astype(np.float32))
y = torch.exp(x).numpy()
ref = np.exp(x.numpy().astype(np.float64)).astype(np.float32)
rel = np.abs(y - ref) / ref
print(int((rel > 1e-6).sum()), float(rel.max()))
"""

# a worker (HETU_PROC_ID set) or the in-process run of the fleet test's
# GPT, each plain K2 call recorded: the op's code with its inner values
_GPT = """
import hashlib, os, sys
import numpy as np, torch
sys.path.insert(0, os.path.join({root!r}, "tests"))
import hetu_tpu_torch as ht
import hetu_tpu_torch.models as M
from hetu_tpu_torch.ops import flash_attention as fa
from test_torch_pipeline_fleet import GPT_CFG, gpt_contexts, gpt_feeds
recs = []

def k2(q, k, v, mask=None, sm_scale=1.0, causal=False):
    b, h, s, d, bq, bk, qr, kr, vr, rows = fa._plain_inputs(
        q, k, v, mask, "flash_attention_plain")
    assert s == bq == bk, "one tile a call"
    sc = fa._scores(qr, kr, rows, 0, bk, sm_scale, causal, 0)
    m = torch.maximum(torch.full((b * h, s, 1), fa.NEG_INF),
                      sc.amax(dim=-1, keepdim=True))
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).to(torch.float32), vr)
    out = (pv / l).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    key = hashlib.md5(b"".join(t.view(torch.uint8).numpy().tobytes()
                              for t in (q, k, v))).hexdigest()
    recs.append(dict(key=key, **{{n: t.float().numpy().copy() for n, t in
        (("scores", sc), ("exp", p), ("sum", l), ("pv", pv),
         ("out", out))}}))
    return out.reshape(b, h, s, d), lse.reshape(b, h, s)

fa.flash_attention_with_lse_plain = k2
rank = int(os.environ.get("HETU_PROC_ID", "-1"))
cfg = M.GPTConfig(**GPT_CFG)
ids, labels, loss, _, train = M.staged_gpt(cfg, gpt_contexts(ht, rank >= 0),
                                           1e-3)
kw = {{"pp_options": {{"virtual_stages": 2}}}} if rank >= 0 else {{}}
exe = ht.Executor([loss, train], device="cpu", dtype=torch.bfloat16,
                  pipedream=True, num_microbatches=4, **kw)
for step in range(3):
    x, y = gpt_feeds(step)
    exe.run(feed_dict={{ids: x, labels: y}})
np.save(os.path.join(os.environ["HETU_TEST_OUT"], f"k2_{{rank}}.npy"),
        np.array(recs, dtype=object), allow_pickle=True)
"""

_SPMD = "spmd: true\nnodes:\n  - host: localhost\n    workers: 2\n" \
        "    chief: true\n"


def _procs(args):
    code = _FIRST_EXP.format(port=bool(args.port))
    env = dict(os.environ, OMP_NUM_THREADS="4",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))

    def one(_):
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        n, rel = out.stdout.split()[-2:]
        return int(n), float(rel)
    with ThreadPoolExecutor(args.parallel) as pool:
        runs = list(pool.map(one, range(args.n)))
    bad = [(n, rel) for n, rel in runs if n]
    return {"mode": "procs", "port": bool(args.port), "processes": args.n,
            "processes_with_a_wrong_exp": len(bad),
            "wrong_elements": [n for n, _ in bad],
            "max_rel_err_wrong": max((rel for _, rel in bad), default=None),
            "max_rel_err_right": max(rel for n, rel in runs if not n)}


def _run_gpt(tmp, fleet):
    import numpy as np
    script = os.path.join(tmp, "gpt.py")
    with open(script, "w") as f:
        f.write(_GPT.format(root=ROOT))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HETU_PS_", "HETU_PROC", "MASTER_"))}
    env.update(HETU_TEST_OUT=tmp, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    if fleet:
        cfg = os.path.join(tmp, "spmd.yml")
        with open(cfg, "w") as f:
            f.write(_SPMD)
        cmd = [sys.executable, "-m", "hetu_tpu_torch.launcher", "-c", cfg,
               sys.executable, script]
    else:
        cmd = [sys.executable, script]
    subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, timeout=300,
                   check=True)
    ranks = (0, 1) if fleet else (-1,)
    return {r: np.load(os.path.join(tmp, f"k2_{r}.npy"), allow_pickle=True)
            for r in ranks}


def _fleets(args):
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        ref = {r["key"]: r for r in _run_gpt(tmp, False)[-1]}

    def one(_):
        with tempfile.TemporaryDirectory() as tmp:
            found = []
            for rank, recs in _run_gpt(tmp, True).items():
                for i, rec in enumerate(recs):
                    want = ref.get(rec["key"])
                    if want is None or np.array_equal(rec["out"],
                                                      want["out"]):
                        continue
                    first = next(n for n in ("scores", "exp", "sum", "pv",
                                             "out")
                                 if not np.array_equal(rec[n], want[n]))
                    found.append({"rank": rank, "call": i,
                                  "first_differing": first,
                                  "elements": int((rec[first]
                                                   != want[first]).sum())})
            return found
    with ThreadPoolExecutor(args.parallel) as pool:
        runs = list(pool.map(one, range(args.n)))
    return {"mode": "fleets", "fleets": args.n,
            "fleets_apart": sum(bool(r) for r in runs),
            "apart": [r for r in runs if r]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("procs", "fleets"))
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--parallel", type=int, default=None)
    ap.add_argument("--port", action="store_true",
                    help="procs: import hetu_tpu_torch first")
    args = ap.parse_args(argv)
    if args.mode == "procs":
        args.n, args.parallel = args.n or 240, args.parallel or 4
        print(json.dumps(_procs(args)))
    else:
        args.n, args.parallel = args.n or 20, args.parallel or 2
        print(json.dumps(_fleets(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
