"""TP and DP inside pipeline stages across the port's launcher's
processes (``spmd: true``: one job, gloo inside the stages, the pipe
channel between them), and on the card.

* Four launcher processes train tests/test_pipeline.py's ``_build_tp``
  graph under GPipe (M=4): stage 0 over ``worker0`` and ``worker1``
  column-splits w1, stage 1 over ``worker2`` and ``worker3`` splits its
  activations by rows. Nothing passes a job: each executor reads the
  launcher's (``HETU_PROC_ID``, ``HETU_NUM_PROCS``, the ``HETU_PIPE_*``
  addresses) and makes its stages' groups over the joined process group.
  ``Executor.save`` gathers each stage's weights, and each stage's first
  rank writes them. Losses and the saved weights against the thread run
  of tests/torch_tp_util.py (the same executor code in one process) at
  rtol 1e-6.
* ``cuda``-marked: a GPT at S=512 in bf16, 2 stages x tp=2 by
  ``DEFAULT_RULES``, four thread ranks on the one card, each launching
  the hand-written K2-K4 on the tc route; skips without a GPU.
"""
import numpy as np
import pytest

from torch_ps_util import run_fleet

STEPS, M = 4, 4

SPMD = """
spmd: true
nodes:
  - host: localhost
    workers: 4
    chief: true
"""

MLP = r"""
def mlp(ht):
    rng = np.random.RandomState(7)
    w = {"w1": rng.randn(20, 32).astype("f") * 0.2,
         "b1": np.zeros(32, "f"),
         "w2": rng.randn(32, 24).astype("f") * 0.2,
         "w3": rng.randn(24, 10).astype("f") * 0.2}
    with ht.context((ht.rcpu("worker0", 0), ht.rcpu("worker1", 0))):
        x = ht.Variable("x", trainable=False)
        w1 = ht.Variable("w1", value=w["w1"])
        b1 = ht.Variable("b1", value=w["b1"])
        act = ht.matmul_op(x, ht.dispatch(w1, (1, 2)))
        act = ht.relu_op(act + ht.broadcastto_op(b1, act))
        act = ht.dispatch(act, (1, 1))
    with ht.context((ht.rcpu("worker2", 0), ht.rcpu("worker3", 0))):
        w2 = ht.Variable("w2", value=w["w2"])
        w3 = ht.Variable("w3", value=w["w3"])
        act2 = ht.relu_op(ht.matmul_op(ht.dispatch(act, (2, 1)), w2))
        y_ = ht.Variable("y_", trainable=False)
        loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(
            ht.matmul_op(act2, w3), y_), [0])
        train = ht.optim.SGDOptimizer(learning_rate=0.2).minimize(loss)
    return x, y_, [loss, train]


def feeds(i):
    rng = np.random.RandomState(8)
    xs = rng.randn(64, 20).astype(np.float32)
    ys = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 64)]
    s = (i * 32) % 64
    return xs[s:s + 32], ys[s:s + 32]


def train(exe, x, y_, steps):
    out = []
    for i in range(steps):
        loss = exe.run(feed_dict=dict(zip((x, y_), feeds(i))))[0]
        out.append(np.nan if loss is None else float(loss.asnumpy()))
    return out
"""

WORKER = r"""
import os
import numpy as np
import torch.distributed as dist
import hetu_tpu_torch as ht
""" + MLP + f"""
STEPS, M = {STEPS}, {M}
""" + r"""
out = os.environ["HETU_TEST_OUT"]
rank = int(os.environ["RANK"])
x, y_, nodes = mlp(ht)
exe = ht.Executor(nodes, gpipe=True, num_microbatches=M, device="cpu")
losses = train(exe, x, y_, STEPS)
exe.save(os.path.join(out, "ckpt"))
sub = exe.subexecutors["default"]
np.savez(os.path.join(out, f"pp_tp_{rank}.npz"), losses=losses,
         ranks=[st.ranks for st in sub.stages], backend=dist.get_backend(),
         held={n.name: tuple(exe.params[sid].shape)
               for sid, n in exe._param_nodes.items()})
dist.destroy_process_group()
"""

_ns = {"np": np}
exec(MLP, _ns)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_tp_fleet")
    proc = run_fleet("hetu_tpu_torch", SPMD, WORKER, tmp, timeout=180)
    assert proc.returncode == 0, proc.stdout[-3000:]
    return tmp, [dict(np.load(tmp / f"pp_tp_{r}.npz", allow_pickle=True))
                 for r in range(4)]


def test_four_processes_match_the_thread_run(fleet):
    import hetu_tpu_torch as tht
    from torch_tp_util import job_ranks

    def run(r, job, built):
        x, y_, nodes = built
        exe = tht.Executor(nodes, gpipe=True, num_microbatches=M,
                           device="cpu", pp_options={"job": job})
        losses = _ns["train"](exe, x, y_, STEPS)
        return losses, {n.name: exe._whole(n, exe.params[sid]).numpy()
                        for sid, n in exe._param_nodes.items()}

    threads = job_ranks(4, run, lambda r: _ns["mlp"](tht))
    tmp, recs = fleet
    for r, rec in enumerate(recs):
        assert rec["backend"] == "gloo"
        assert rec["ranks"].tolist() == [[0, 1], [2, 3]]
        np.testing.assert_allclose(rec["losses"], threads[r][0], rtol=1e-6)
    assert recs[0]["held"].item()["w1"] == (20, 16)
    assert all(np.isfinite(recs[r]["losses"]).all() for r in (2, 3))
    ckpt = tmp / "ckpt"
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "b1.npy", "session.ckpt", "session.ckpt.rank2", "w1.npy", "w2.npy",
        "w3.npy"]
    want = {**threads[0][1], **threads[2][1]}
    for name, value in want.items():
        np.testing.assert_allclose(np.load(ckpt / f"{name}.npy"), value,
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.cuda
def test_four_ranks_on_the_card_launch_the_kernels():
    """A GPT at S=512, head dim 64 (the fused attention path, on the
    tensor cores), bf16, 2 layers in 2 stages x tp=2 by the default rules,
    four ranks (threads) on cuda:0 under GPipe at M=2: K2, K3 and K4
    launched once a layer a microbatch in each rank, all on tc, K1 never;
    the step's loss within two bf16 ulps of one process's on the same
    stages without the split."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import hetu_tpu_torch as ht
    import hetu_tpu_torch.models as TM
    from hetu_tpu_torch.ops import _build
    from torch_tp_util import job_ranks, same_ids

    cfg = TM.GPTConfig(vocab_size=98, hidden_size=128, num_hidden_layers=2,
                       num_attention_heads=2, max_position_embeddings=512,
                       hidden_dropout_prob=0.0, use_flash_attention=True)
    x = np.random.RandomState(0).randint(0, 98, (4, 512))
    y = np.concatenate([x[:, 1:], np.full((4, 1), -1)], axis=1)

    def build(split):
        w = [tuple(ht.rgpu(f"worker{r}", 0) for r in ranks)
             for ranks in ((0, 1), (2, 3))]
        contexts = w if split else [ht.gpu(0), ht.gpu(1)]
        ids, labels, loss, _, train = TM.staged_gpt(cfg, contexts, 1e-3)
        if split:
            bindings, _ = ht.parallel.compile_rules([loss, train], tp=2)
            ht.parallel.apply_rules([loss, train], bindings)
        return ids, labels, [loss, train]

    def step(exe, ids, labels):
        return exe.run(feed_dict={ids: x, labels: y})[0]

    ids, labels, nodes = same_ids(build, False)
    want = float(step(ht.Executor(nodes, gpipe=True, num_microbatches=2,
                                  dtype=torch.bfloat16), ids, labels)
                 .asnumpy())

    def run(r, job, built):
        ids, labels, nodes = built
        exe = ht.Executor(nodes, gpipe=True, num_microbatches=2,
                          dtype=torch.bfloat16, pp_options={"job": job})
        loss = step(exe, ids, labels)
        return None if loss is None else float(loss.asnumpy())

    _build.reset_launch_counts()
    got = job_ranks(4, run, lambda r: build(True))
    for key in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"):
        assert _build.launch_counts[key] == 4 * 1 * 2, key
        assert _build.launch_counts[f"{key}.tc"] == 4 * 1 * 2, key
    assert _build.launch_counts["flash_fwd"] == 0
    ulp = 2.0 ** (int(np.floor(np.log2(abs(want)))) - 7)
    for loss in got[2:]:
        assert abs(loss - want) <= 2 * ulp
