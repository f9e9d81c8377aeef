"""Pipeline parallelism in one process: hetu_tpu_torch against hetu_tpu
on the CPU.

The 2-stage MLP of tests/test_pipeline.py and a tiny GPT (2 layers,
hidden 64, 4 heads, S=64) split over 2 stages are built alike in both
packages (the same numpy weights: values given, or drawn by name) and
trained under GPipe and PipeDream 1F1B. The JAX package runs on its
8-device CPU harness (tests/conftest.py), a stage on each device; the
port runs both stages on the CPU. For the GPT, the port's
``FUSED_BWD_MIN_SEQ`` is patched to 0, so its attention runs the plain
versions of K2 (forward with logsumexp), K3 and K4 in each stage. The
JAX package's pipeline differentiates a stage with ``jax.vjp``, which
has no rule for a ``pallas_call`` in interpret mode, so it runs its
composed attention off the TPU, as tests/test_torch_gpt_training.py's
reference does; the plain K2–K4 are held against the Pallas kernels in
interpret mode by tests/test_torch_flash_backward.py.

Tolerances are tests/test_pipeline.py's, rtol 2e-4 / atol 1e-5, on the
losses of every step and on every weight at the end (measured: see each
test's docstring).
"""
import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu.models as JM
from hetu_tpu.executor import Executor as JExecutor
from hetu_tpu.parallel import pipeline as jpipe
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ops import attention as tattn
from hetu_tpu_torch.parallel import pipeline as tpipe

RTOL, ATOL = 2e-4, 1e-5


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(20, 32).astype("f") * 0.2,
            "b1": np.zeros(32, "f"),
            "w2": rng.randn(32, 24).astype("f") * 0.2,
            "w3": rng.randn(24, 10).astype("f") * 0.2}


def _data(n=64, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 20).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)]
    return x, y


def _mlp(ht, weights, staged, opt=None):
    """tests/test_pipeline.py's 2-stage MLP: fc1 on cpu:0, fc2 + fc3 +
    the loss on cpu:1 (both on cpu:0 unstaged)."""
    ctx0, ctx1 = (ht.cpu(0), ht.cpu(1)) if staged else (ht.cpu(0),) * 2
    with ht.context(ctx0):
        x = ht.Variable("x", trainable=False)
        w1 = ht.Variable("w1", value=weights["w1"])
        b1 = ht.Variable("b1", value=weights["b1"])
        act = ht.matmul_op(x, w1)
        act = ht.relu_op(act + ht.broadcastto_op(b1, act))
    with ht.context(ctx1):
        w2 = ht.Variable("w2", value=weights["w2"])
        w3 = ht.Variable("w3", value=weights["w3"])
        act2 = ht.relu_op(ht.matmul_op(act, w2))
        logits = ht.matmul_op(act2, w3)
        y_ = ht.Variable("y_", trainable=False)
        loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
        opt = opt or ht.optim.SGDOptimizer(learning_rate=0.2)
        train_op = opt.minimize(loss)
    return x, y_, loss, train_op


def _run(exe, x, y_, xs, ys, steps, bs=32):
    out = []
    for i in range(steps):
        s = (i * bs) % len(xs)
        res = exe.run(feed_dict={x: xs[s:s + bs], y_: ys[s:s + bs]})
        out.append(float(np.asarray(res[0].asnumpy()).reshape(())))
    return np.asarray(out)


def _params(exe):
    """{name: numpy} of an executor of either package."""
    out = {}
    for sid, node in exe._param_nodes.items():
        v = exe.params[sid]
        out[node.name] = (v.detach().cpu().numpy()
                          if isinstance(v, torch.Tensor) else np.asarray(v))
    return out


def _assert_params_close(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("M", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("V", [1, 2, 3])
def test_bubble_and_virtual_program_equal_the_reference(S, M, V):
    assert tpipe.analytic_bubble_fraction(S, M, V) == \
        jpipe.analytic_bubble_fraction(S, M, V)
    nranks = max(1, S // V)
    assert tpipe.virtual_stage_program(nranks, S, M) == \
        jpipe.virtual_stage_program(nranks, S, M)


def _stage_names(sub):
    return [(sorted(p.name for p in st.param_nodes),
             sorted(f.name for f in st.feed_nodes)) for st in sub.stages]


@pytest.mark.parametrize("schedule", ["gpipe", "pipedream"])
def test_stage_split_of_the_mlp_equals_the_reference(schedule):
    w = _weights()
    _, _, loss, train = _mlp(jht, w, True)
    jsub = JExecutor([loss, train], num_microbatches=4,
                     **{schedule: True}).subexecutors["default"]
    _, _, loss, train = _mlp(tht, w, True)
    tsub = tht.Executor([loss, train], num_microbatches=4,
                        **{schedule: True}).subexecutors["default"]
    assert _stage_names(tsub) == _stage_names(jsub)
    assert tsub.schedule == jsub.schedule
    assert [len(st.in_nodes) for st in tsub.stages] == \
        [len(st.in_nodes) for st in jsub.stages]
    # each gradient op runs in the stage of the forward op it came from,
    # though minimize() made them all under stage 1's context
    names = [{tsub.param_grad[p].name for p in st.train_params}
             for st in tsub.stages]
    assert [sorted(p.name for p in st.train_params)
            for st in tsub.stages] == [["b1", "w1"], ["w2", "w3"]]
    assert all(names) and tsub.stages[0].grad_nodes \
        and tsub.stages[0].grad_in


@pytest.mark.parametrize("schedule,M", [("gpipe", 4), ("pipedream", 4),
                                        ("pipedream", 2)])
def test_mlp_follows_the_reference_losses_and_weights(schedule, M):
    """6 SGD steps at B=32 (measured: losses within 1.9e-7 relative,
    weights within 6e-8)."""
    w = _weights(2)
    xs, ys = _data(64, 3)
    x, y_, loss, train = _mlp(jht, w, True)
    jexe = JExecutor([loss, train], num_microbatches=M, **{schedule: True})
    want = _run(jexe, x, y_, xs, ys, steps=6)
    x, y_, loss, train = _mlp(tht, w, True)
    texe = tht.Executor([loss, train], num_microbatches=M,
                        **{schedule: True})
    got = _run(texe, x, y_, xs, ys, steps=6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _assert_params_close(_params(texe), _params(jexe))
    if schedule == "pipedream":
        assert got[-1] < got[0]


def test_mlp_with_adam_follows_the_reference():
    """Adam: one slot pair per parameter on its stage (measured after 6
    steps: losses within 2.9e-6 relative, weights within 2.0e-6)."""
    w = _weights(4)
    xs, ys = _data(64, 5)
    for schedule in ("gpipe", "pipedream"):
        x, y_, loss, train = _mlp(jht, w, True,
                                  jht.optim.AdamOptimizer(0.01))
        jexe = JExecutor([loss, train], num_microbatches=4,
                         **{schedule: True})
        want = _run(jexe, x, y_, xs, ys, steps=6)
        x, y_, loss, train = _mlp(tht, w, True,
                                  tht.optim.AdamOptimizer(0.01))
        texe = tht.Executor([loss, train], num_microbatches=4,
                            **{schedule: True})
        got = _run(texe, x, y_, xs, ys, steps=6)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        _assert_params_close(_params(texe), _params(jexe))


def test_gpipe_equals_the_single_device_executor():
    """GPipe over 4 microbatches trains as one executor on the whole
    batch (tests/test_pipeline.py:64-76)."""
    w = _weights()
    xs, ys = _data()
    x, y_, loss, train = _mlp(tht, w, False)
    base_exe = tht.Executor([loss, train], ctx=tht.cpu(0))
    base = _run(base_exe, x, y_, xs, ys, steps=6)
    x, y_, loss, train = _mlp(tht, w, True)
    exe = tht.Executor([loss, train], gpipe=True, num_microbatches=4)
    assert len(exe.subexecutors["default"].stages) == 2
    got = _run(exe, x, y_, xs, ys, steps=6)
    np.testing.assert_allclose(got, base, rtol=RTOL, atol=ATOL)
    _assert_params_close(_params(exe), _params(base_exe))


def test_pipedream_with_one_microbatch_is_sequential_training():
    """1F1B at M=1 is plain training on each batch
    (tests/test_pipeline.py:90-103)."""
    w = _weights(4)
    xs, ys = _data(32, 5)
    x, y_, loss, train = _mlp(tht, w, False)
    base_exe = tht.Executor([loss, train], ctx=tht.cpu(0))
    base = _run(base_exe, x, y_, xs, ys, steps=5, bs=16)
    x, y_, loss, train = _mlp(tht, w, True)
    exe = tht.Executor([loss, train], pipedream=True, num_microbatches=1)
    got = _run(exe, x, y_, xs, ys, steps=5, bs=16)
    np.testing.assert_allclose(got, base, rtol=RTOL, atol=ATOL)
    _assert_params_close(_params(exe), _params(base_exe))


@pytest.mark.parametrize("schedule, live", [("gpipe", 8), ("pipedream", 2)])
def test_pipedream_frees_each_microbatch_with_its_stash(schedule, live):
    """At M=8 over S=2 stages 1F1B holds the environments (activations,
    residuals, stashed weights) of at most S microbatches at a time,
    GPipe those of all M: a microbatch's go when its backward has run
    through the stage."""
    x, y_, loss, train = _mlp(tht, _weights(), True)
    exe = tht.Executor([loss, train], num_microbatches=8,
                       **{schedule: True})
    sub = exe.subexecutors["default"]
    forward, seen = sub._forward, []

    def counted(executor, st, m):
        forward(executor, st, m)
        seen.append(len({mb for _, mb in sub._envs}))
    sub._forward = counted
    xs, ys = _data(32, 5)
    _run(exe, x, y_, xs, ys, steps=2, bs=16)
    assert len(seen) == 2 * 8 * 2 and max(seen) == live


# ---------------------------------------------------------------------------
# a tiny GPT over two stages
# ---------------------------------------------------------------------------

GPT_CFG = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=64,
               hidden_dropout_prob=0.0, use_flash_attention=True)
GPT_B, GPT_LR = 4, 1e-3


def _jax_staged_gpt(cfg, contexts, lr):
    """``hetu_tpu_torch.models.staged_gpt`` built with the JAX package:
    the same blocks per stage, the same slice of ``gpt_wpe`` for the
    positions, the same loss and Adam."""
    nstages, seq = len(contexts), cfg.max_position_embeddings
    per = cfg.num_hidden_layers // nstages
    ids = jht.Variable("input_ids", trainable=False)
    labels = jht.Variable("labels", trainable=False)
    model = JM.GPTLMHeadModel(cfg)
    body = model.transformer
    for s, ctx in enumerate(contexts):
        with jht.context(ctx):
            if s == 0:
                x = body.wte(ids)
                pos = jht.slice_op(body.wpe.weight, (0, 0), (seq, -1))
                x = body.dropout(x + jht.broadcastto_op(pos, x))
            for block in body.blocks[s * per:(s + 1) * per]:
                x = block(x, seq)
            if s == nstages - 1:
                logits = model.lm_head(body.ln_f(x),
                                       [-1, seq, cfg.vocab_size])
                loss = jht.reduce_mean_op(
                    jht.softmaxcrossentropy_sparse_op(logits, labels),
                    [0, 1])
                opt = jht.optim.AdamOptimizer(learning_rate=lr)
                train_op = opt.minimize(loss)
    return ids, labels, loss, opt, train_op


def _gpt(ht, models):
    cfg = models.GPTConfig(**GPT_CFG)
    staged = models.staged_gpt if ht is tht else _jax_staged_gpt
    return staged(cfg, [ht.gpu(0), ht.gpu(1)], GPT_LR)


SEEN = 16


def _gpt_batch(step):
    """Ids from [0, SEEN), every id in every row. The JAX package's
    stage vjp makes the token table's gradient dense, so its Adam moves
    every row that has moments; the port keeps lazy Adam on it, as both
    packages' executors do (rows a microbatch does not touch keep their
    value and slots). The two agree where each microbatch touches every
    row it moves: here every row of the batch holds every id."""
    rng = np.random.RandomState(step)
    s = GPT_CFG["max_position_embeddings"]
    x = np.stack([rng.permutation(np.concatenate(
        [np.arange(SEEN), rng.randint(0, SEEN, s - SEEN)]))
        for _ in range(GPT_B)])
    return x, np.concatenate([x[:, 1:], np.full((GPT_B, 1), -1)], axis=1)


@pytest.mark.parametrize("schedule", ["gpipe", "pipedream"])
def test_tiny_gpt_follows_the_reference(monkeypatch, schedule):
    """3 Adam steps at M=4 over 2 stages, the fused attention path in
    the port (plain K2 forward, K3 + K4 backward, in the stage that holds
    each block); no kernel launch counted on the CPU (measured: losses
    within 9.1e-7 relative, weights within 1.4e-6 but the key biases,
    which differ by up to 2.3e-5 under 1F1B)."""
    monkeypatch.setattr(tattn, "FUSED_BWD_MIN_SEQ", 0)
    ids, labels, loss, _, train = _gpt(jht, JM)
    jexe = JExecutor([loss, train], num_microbatches=4, **{schedule: True})
    tids, tlabels, tloss, _, ttrain = _gpt(tht, TM)
    texe = tht.Executor([tloss, ttrain], num_microbatches=4,
                        device="cpu", **{schedule: True})
    sub = texe.subexecutors["default"]
    assert [st.device.type for st in sub.stages] == ["cpu", "cpu"]
    # the attention backward of block 0 runs in stage 0; block 1 reads
    # the boundary twice (LayerNorm, residual), and stage 1 sums the two
    # partial adjoints before one crosses back
    grad_ops = {type(n).__name__ for n in sub.stages[0].grad_nodes}
    assert "_FlashAttentionGradOp" in grad_ops
    assert len(sub.stages[1].in_nodes) == len(sub.stages[0].grad_in) == 1
    assert _stage_names(sub) == _stage_names(jexe.subexecutors["default"])
    # the reference's weights, by name, each onto its stage's device
    texe.load_params({k: v.copy() for k, v in _params(jexe).items()})
    _assert_params_close(_params(texe), _params(jexe))
    calls = []
    real = tattn.flash_attention_bwd
    monkeypatch.setattr(tattn, "flash_attention_bwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = dict(_build.launch_counts)
    for step in range(3):
        x, y = _gpt_batch(step)
        want = float(jexe.run(feed_dict={ids: x, labels: y})[0].asnumpy())
        got = float(texe.run(feed_dict={tids: x, tlabels: y})[0].asnumpy())
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert len(calls) == 3 * 4 * GPT_CFG["num_hidden_layers"]
    assert dict(_build.launch_counts) == before
    tp, jp = _params(texe), _params(jexe)
    init = _params(tht.Executor([tloss, ttrain], num_microbatches=4,
                                device="cpu", **{schedule: True}))
    # the key third of each qkv bias has an exact gradient of 0 (adding b
    # to every key adds q . b to a query's scores alike, which the
    # softmax cancels): each package steps on its own rounding noise,
    # 4 Adam updates a step under 1F1B. It is held within 1e-4 of its
    # initial value in both instead
    h = GPT_CFG["hidden_size"]
    for name in [n for n in jp if n.endswith("_attn_qkv_bias")]:
        for params in (tp, jp):
            key = params[name][h:2 * h]
            assert np.abs(key - init[name][h:2 * h]).max() < 1e-4, name
            params[name] = np.concatenate([params[name][:h],
                                           params[name][2 * h:]])
    _assert_params_close(tp, jp)
    # lazy Adam: the rows no id touched keep their initial value
    np.testing.assert_array_equal(tp["gpt_wte"][SEEN:],
                                  init["gpt_wte"][SEEN:])


def test_explicit_send_recv_markers():
    """Reference-style pipeline_send_op / pipeline_receive_op between the
    stages: spliced, same losses as the graph without them
    (tests/test_pipeline.py::test_explicit_send_recv_markers)."""
    rng = np.random.RandomState(11)
    w1v = rng.randn(12, 10).astype("f") * 0.3
    w2v = rng.randn(10, 4).astype("f") * 0.3
    xs = rng.randn(8, 12).astype("f")
    ys = np.eye(4, dtype="f")[rng.randint(0, 4, 8)]

    def build(ht, markers):
        with ht.context(ht.cpu(0)):
            x = ht.Variable("sr_x", trainable=False)
            w1 = ht.Variable("sr_w1", value=w1v)
            a = ht.relu_op(ht.matmul_op(x, w1))
            if markers:
                ht.pipeline_send_op(a, destination=1)
        with ht.context(ht.cpu(1)):
            a_in = ht.pipeline_receive_op(source=0) if markers else a
            w2 = ht.Variable("sr_w2", value=w2v)
            y_ = ht.Variable("sr_y", trainable=False)
            loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(
                ht.matmul_op(a_in, w2), y_), [0])
            train = ht.optim.SGDOptimizer(0.1).minimize(loss)
        return x, y_, loss, train

    runs = {}
    for name, ht, make in (("jax", jht, JExecutor),
                           ("port", tht, tht.Executor)):
        for markers in (False, True):
            x, y_, loss, train = build(ht, markers)
            exe = make([loss, train], gpipe=True, num_microbatches=2)
            runs[name, markers] = [float(np.asarray(exe.run(
                feed_dict={x: xs, y_: ys})[0].asnumpy())) for _ in range(3)]
    np.testing.assert_allclose(runs["port", True], runs["port", False],
                               rtol=1e-6)
    np.testing.assert_allclose(runs["port", True], runs["jax", True],
                               rtol=RTOL, atol=ATOL)


def test_send_recv_markers_must_pair():
    tht.ops.comm.PipelineSendOp.registry.clear()
    with tht.context(tht.cpu(0)):
        x = tht.Variable("u_x", trainable=False)
        w = tht.Variable("u_w", value=np.ones((3, 3), "f"))
    with tht.context(tht.cpu(1)):
        r = tht.pipeline_receive_op(source=0)
        loss = tht.reduce_mean_op(tht.matmul_op(r, w), [0, 1])
        train = tht.optim.SGDOptimizer(0.1).minimize(loss)
    with pytest.raises(ValueError, match="unpaired pipeline markers"):
        tht.Executor([loss, train], gpipe=True)
    del x


@pytest.mark.parametrize("schedule,M", [("gpipe", 4), ("pipedream", 2)])
def test_lr_scheduler_advances_once_per_global_step(schedule, M):
    """tests/test_pipeline.py::test_lr_scheduler_advances_per_global_step:
    3 steps decay a StepScheduler 3 times, not 3·M, and the losses follow
    the reference's under the decaying rate."""
    losses = {}
    for name, ht, make, sched_mod in (
            ("jax", jht, JExecutor, jht.lr),
            ("port", tht, tht.Executor, tht.lr)):
        x, y_, loss, train = _mlp(ht, _weights(3), True)
        exe = make([loss, train], num_microbatches=M, **{schedule: True})
        sched = sched_mod.StepScheduler(0.2, step_size=1, gamma=0.5)
        exe.subexecutors["default"].optimizer.lr_sched = sched
        xs, ys = _data(64, 4)
        losses[name] = _run(exe, x, y_, xs, ys, steps=3)
        assert sched.cnt == 3, (name, sched.cnt)
        assert abs(sched.get() - 0.2 * 0.5 ** 3) < 1e-12
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=RTOL,
                               atol=ATOL)


def test_refusals_name_their_roadmap_item():
    x, y_, loss, train = _mlp(tht, _weights(), True)
    with pytest.raises(TypeError, match="ROADMAP item 11b"):
        tht.Executor([loss, train], gpipe=True, pipeline_mode="collective")
    with pytest.raises(NotImplementedError, match="ROADMAP item 11b"):
        tht.Executor([loss, train], gpipe=True, comm_mode="AllReduce")
    exe = tht.Executor([loss, train], gpipe=True, num_microbatches=2)
    xs, ys = _data(8)
    with pytest.raises(ValueError, match="run_batches is not supported"):
        exe.run_batches([{x: xs, y_: ys}])
    with pytest.raises(ValueError, match="run_batches_stream is not"):
        exe.run_batches_stream([[{x: xs, y_: ys}]])
    with pytest.raises(ValueError, match="not divisible into 2"):
        exe.run(feed_dict={x: xs[:7], y_: ys[:7]})
    # a tuple context is a stage that is model-parallel inside: one
    # that splits nothing runs on its first device, as in the JAX
    # package; one that splits needs a process a device
    for split in (False, True):
        with tht.context((tht.cpu(0), tht.cpu(1))):
            a = tht.Variable("t_x", trainable=False)
            w = tht.Variable("t_w", value=np.ones((4, 4), "f"))
            h = tht.matmul_op(a, tht.dispatch(w, (1, 2)) if split else w)
        with tht.context(tht.cpu(2)):
            l2 = tht.reduce_mean_op(h, [0, 1])
            t2 = tht.optim.SGDOptimizer(0.1).minimize(l2)
        if split:
            with pytest.raises(NotImplementedError,
                               match="ROADMAP item 11a's remainder"):
                tht.Executor([l2, t2], gpipe=True)
        else:
            sub = tht.Executor([l2, t2], gpipe=True).subexecutors["default"]
            assert [st.ranks for st in sub.stages] == [[0], [0]]


def test_pipedream_refuses_sgd_on_an_embedding_table():
    """SGD's sparse update writes the table in place, which would change
    the weights stashed for microbatches in flight: PipeDream refuses
    it; GPipe (one update after every backward) and Adam (out of place)
    run, and Adam's lazy rows follow the reference."""
    def build(ht, opt):
        with ht.context(ht.cpu(0)):
            ids = ht.Variable("e_ids", trainable=False, dtype=np.int32)
            table = ht.Variable("e_table", value=np.random.RandomState(
                0).randn(10, 4).astype("f"))
            h = ht.embedding_lookup_op(table, ids)
        with ht.context(ht.cpu(1)):
            w = ht.Variable("e_w", value=np.ones((4, 1), "f"))
            loss = ht.reduce_mean_op(ht.matmul_op(
                ht.array_reshape_op(h, [-1, 4]), w), [0, 1])
            train = opt(ht).minimize(loss)
        return ids, loss, train

    sgd = lambda ht: ht.optim.SGDOptimizer(0.1)  # noqa: E731
    adam = lambda ht: ht.optim.AdamOptimizer(0.1)  # noqa: E731
    ids, loss, train = build(tht, sgd)
    with pytest.raises(ValueError, match="SGD updates a table in place"):
        tht.Executor([loss, train], pipedream=True, num_microbatches=2)
    # each microbatch touches the same rows (the JAX package's pipeline
    # updates the table densely: see _gpt_batch)
    feed = np.array([[1, 2], [3, 1], [2, 3], [3, 1]], np.int32)
    for schedule, opt in (("gpipe", sgd), ("pipedream", adam)):
        out = {}
        for name, ht, make in (("jax", jht, JExecutor),
                               ("port", tht, tht.Executor)):
            ids, loss, train = build(ht, opt)
            exe = make([loss, train], num_microbatches=2,
                       **{schedule: True})
            for _ in range(2):
                exe.run(feed_dict={ids: feed})
            out[name] = _params(exe)
        _assert_params_close(out["port"], out["jax"])



def test_pipeline_defaults_to_the_card(monkeypatch):
    """Stages on gpu contexts run on the card unless the caller asks for
    the CPU: without CUDA the executor raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tht.context(tht.gpu(0)):
        x = tht.Variable("d_x", trainable=False)
        w = tht.Variable("d_w", value=np.ones((3, 3), "f"))
        h = tht.matmul_op(x, w)
    with tht.context(tht.gpu(1)):
        loss = tht.reduce_mean_op(h, [0, 1])
        train = tht.optim.SGDOptimizer(0.1).minimize(loss)
    with pytest.raises(RuntimeError, match="CUDA"):
        tht.Executor([loss, train], gpipe=True)
    exe = tht.Executor([loss, train], gpipe=True, device="cpu")
    assert exe.config.device == torch.device("cpu")
    assert [st.device for st in exe.subexecutors["default"].stages] == \
        [torch.device("cpu")] * 2
