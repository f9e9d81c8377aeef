"""Tensor parallelism across the port's launcher's processes (``spmd:
true``, one job, gloo on the CPU), and on the card.

* Two launcher processes train tests/test_parallel.py's MLP under the
  ``right`` split (w2 column-split two ways). Nothing passes a mesh:
  each executor joins the job and lays the plan over it
  (``mesh_for_statuses``: one ``tp0`` axis of 2 ranks). Losses and each
  rank's w2 block against the thread run of tests/torch_tp_util.py
  (the same executor code in one process) at rtol 1e-6, and the losses
  against the JAX package's TP run at its tolerances (rtol 2e-4, atol
  1e-5).
* ``cuda``-marked: two ranks on the one card train a GPT at S=512 in
  bf16 at tp=2 (``compile_rules`` + ``apply_rules``), each launching the
  hand-written K2-K4 on the tc route; skips without a GPU.
"""
import numpy as np
import pytest

from torch_ps_util import run_fleet

STEPS = 6

SPMD = """
spmd: true
nodes:
  - host: localhost
    workers: 2
    chief: true
"""

MLP = r"""
def mlp(ht, split):
    rng = np.random.RandomState(0)
    w = {"w1": rng.randn(32, 64).astype("f") * 0.1,
         "b1": np.zeros(64, "f"),
         "w2": rng.randn(64, 48).astype("f") * 0.1,
         "w3": rng.randn(48, 10).astype("f") * 0.1}
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    w1 = ht.Variable("w1", value=w["w1"])
    b1 = ht.Variable("b1", value=w["b1"])
    w2 = ht.Variable("w2", value=w["w2"])
    w3 = ht.Variable("w3", value=w["w3"])
    act = ht.matmul_op(x, w1)
    act = ht.relu_op(act + ht.broadcastto_op(b1, act))
    act = ht.matmul_op(ht.dispatch(act, split[0]), ht.dispatch(w2, split[1]))
    act = ht.relu_op(ht.dispatch(act, (1, 1)))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(act, w3), y_), [0])
    train = ht.optim.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return x, y_, [loss, train], w2


def feeds(i):
    rng = np.random.RandomState(1)
    xs = rng.randn(64, 32).astype(np.float32)
    ys = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 64)]
    s = (i * 16) % 64
    return xs[s:s + 16], ys[s:s + 16]


def train(ht, exe, x, y_, steps):
    return [float(exe.run(feed_dict=dict(zip((x, y_), feeds(i))))[0]
                  .asnumpy()) for i in range(steps)]
"""

WORKER = r"""
import os
import numpy as np
import torch.distributed as dist
import hetu_tpu_torch as ht
""" + MLP + r"""
out = os.environ["HETU_TEST_OUT"]
rank = int(os.environ["RANK"])
x, y_, nodes, w2 = mlp(ht, ((1, 1), (1, 2)))
exe = ht.Executor(nodes, ctx=ht.cpu(0))
losses = train(ht, exe, x, y_, STEPS)
np.savez(os.path.join(out, f"tp_{rank}.npz"), losses=losses,
         w2=exe.params[str(w2.id)].numpy(),
         mesh=list(exe.config.mesh.shape.items()),
         coord=exe.config.mesh.coord("tp0"), backend=dist.get_backend(),
         gathers=exe.config.mesh.comm("tp0").stats["gather"]["calls"])
dist.destroy_process_group()
""".replace("STEPS", str(STEPS))

_ns = {"np": np}
exec(MLP, _ns)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_fleet")
    proc = run_fleet("hetu_tpu_torch", SPMD, WORKER, tmp, timeout=180)
    assert proc.returncode == 0, proc.stdout[-3000:]
    return [dict(np.load(tmp / f"tp_{r}.npz")) for r in range(2)]


def test_two_processes_match_the_thread_run_and_the_reference(fleet):
    import hetu_tpu as jht
    import hetu_tpu_torch as tht
    from torch_tp_util import ranks

    def run(r, mesh, built):
        x, y_, nodes, w2 = built
        exe = tht.Executor(nodes, ctx=tht.cpu(0), mesh=mesh)
        return _ns["train"](tht, exe, x, y_, STEPS), \
            exe.params[str(w2.id)].numpy().copy()

    threads = ranks({"tp0": 2}, run,
                    lambda r: _ns["mlp"](tht, ((1, 1), (1, 2))))
    x, y_, nodes, _ = _ns["mlp"](jht, ((1, 1), (1, 2)))
    want = _ns["train"](jht, jht.Executor(nodes, ctx=jht.cpu(0)), x, y_,
                        STEPS)
    for r, rec in enumerate(fleet):
        assert rec["backend"] == "gloo" and int(rec["coord"]) == r
        assert [tuple(a) for a in rec["mesh"]] == [("tp0", "2")]
        assert int(rec["gathers"]) > 0
        np.testing.assert_allclose(rec["losses"], threads[r][0], rtol=1e-6)
        np.testing.assert_allclose(rec["w2"], threads[r][1], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(rec["losses"], want, rtol=2e-4,
                                   atol=1e-5)
        assert rec["w2"].shape == (64, 24)


@pytest.mark.cuda
def test_two_ranks_on_the_card_launch_the_kernels():
    """A GPT at S=512, head dim 64 (the fused attention path, on the
    tensor cores), bf16, split by the default rules at tp=2 over two
    ranks (threads) on cuda:0: K2, K3 and K4 launched once a layer in
    each rank, all on tc, K1 never; the step's loss within two bf16 ulps
    of one process's on the same graph without the split."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import hetu_tpu_torch as ht
    import hetu_tpu_torch.models as M
    from hetu_tpu_torch.ops import _build
    from torch_tp_util import ranks, same_ids

    cfg = dict(vocab_size=98, hidden_size=128, num_hidden_layers=2,
               num_attention_heads=2, max_position_embeddings=512,
               hidden_dropout_prob=0.0, use_flash_attention=True)
    x = np.random.RandomState(0).randint(0, 98, (2, 512))
    y = np.concatenate([x[:, 1:], np.full((2, 1), -1)], axis=1)

    def build(tp):
        ids = ht.Variable("input_ids", trainable=False)
        labels = ht.Variable("labels", trainable=False)
        _, loss = M.GPTLMHeadModel(M.GPTConfig(**cfg))(ids, labels)
        lm = ht.reduce_mean_op(loss, [0, 1])
        nodes = [lm, ht.optim.AdamOptimizer(1e-3).minimize(lm)]
        if tp > 1:
            bindings, _ = ht.parallel.compile_rules(nodes, tp=tp)
            ht.parallel.apply_rules(nodes, bindings)
        return ids, labels, nodes

    ids, labels, nodes = same_ids(build, 1)
    want = float(ht.Executor(nodes, dtype=torch.bfloat16).run(
        feed_dict={ids: x, labels: y})[0].asnumpy())

    def run(r, mesh, built):
        ids, labels, nodes = built
        exe = ht.Executor(nodes, dtype=torch.bfloat16, mesh=mesh)
        return float(exe.run(feed_dict={ids: x, labels: y})[0].asnumpy())

    _build.reset_launch_counts()
    got = ranks({"tp0": 2}, run, lambda r: build(2))
    for key in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"):
        assert _build.launch_counts[key] == 2 * 2, key
        assert _build.launch_counts[f"{key}.tc"] == 2 * 2, key
    assert _build.launch_counts["flash_fwd"] == 0
    ulp = 2.0 ** (int(np.floor(np.log2(abs(want)))) - 7)
    for loss in got:
        assert abs(loss - want) <= 2 * ulp
