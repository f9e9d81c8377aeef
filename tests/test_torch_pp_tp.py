"""TP and DP inside a pipeline stage (tuple stage contexts) in the port
against the JAX package, on the CPU.

A stage whose context is a tuple of devices runs on one rank a device:
here each rank is a thread with gloo groups and a pipe channel of its
own (tests/torch_tp_util.py ``job_ranks``), the stages' contexts named
``worker<k>``. The JAX package runs the same graph in one process on its
8 host devices (tests/conftest.py), a tuple stage over a mesh of its
devices. Weights after the steps are gathered whole in each stage
(``Executor._whole``, a collective of the stage's ranks).

Tolerances are the JAX package's (tests/test_pipeline.py: losses and
weights rtol 2e-4, atol 1e-5) unless stated; each test's docstring
gives what was measured.
"""
import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu.models as JM
from hetu_tpu.executor import Executor as JExecutor
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
from hetu_tpu_torch.ops import attention as tattn
from hetu_tpu_torch.ops.comm import DispatchOp
from hetu_tpu_torch.ops.variable import PlaceholderOp
from hetu_tpu_torch.parallel.pipeline import _device_key

from test_torch_pipeline import _jax_staged_gpt
from torch_tp_util import job_ranks

RTOL, ATOL = 2e-4, 1e-5


def _weights(seed):
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(20, 32).astype("f") * 0.2,
            "b1": np.zeros(32, "f"),
            "w2": rng.randn(32, 24).astype("f") * 0.2,
            "w3": rng.randn(24, 10).astype("f") * 0.2}


def _data(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 20).astype(np.float32),
            np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])


def _workers(ht, *ranks):
    """The contexts of a stage over the given worker ranks: a tuple for
    several, one context for one."""
    ctxs = tuple(ht.rcpu(f"worker{r}", 0) for r in ranks)
    return ctxs if len(ctxs) > 1 else ctxs[0]


def _mlp(ht, weights, ctx0, ctx1, tp=True, dp=True):
    """tests/test_pipeline.py's ``_build_tp``: stage 0 column-splits w1
    over its devices (TP) and gathers its output, stage 1 splits its
    activations by rows (DP, ``dispatch(act, (2, 1))``); ``tp`` / ``dp``
    leave either out (a stage of one device)."""
    with ht.context(ctx0):
        x = ht.Variable("x", trainable=False)
        w1 = ht.Variable("w1", value=weights["w1"])
        b1 = ht.Variable("b1", value=weights["b1"])
        act = ht.matmul_op(x, ht.dispatch(w1, (1, 2)) if tp else w1)
        act = ht.relu_op(act + ht.broadcastto_op(b1, act))
        if tp:
            act = ht.dispatch(act, (1, 1))
    with ht.context(ctx1):
        w2 = ht.Variable("w2", value=weights["w2"])
        w3 = ht.Variable("w3", value=weights["w3"])
        if dp:
            act = ht.dispatch(act, (2, 1))
        act2 = ht.relu_op(ht.matmul_op(act, w2))
        logits = ht.matmul_op(act2, w3)
        y_ = ht.Variable("y_", trainable=False)
        loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
        train = ht.optim.SGDOptimizer(learning_rate=0.2).minimize(loss)
    return x, y_, loss, train


def _feeds(xs, ys, i, bs):
    s = (i * bs) % len(xs)
    return xs[s:s + bs], ys[s:s + bs]


def _jax_params(exe):
    return {node.name: np.array(exe.params[sid])
            for sid, node in exe._param_nodes.items()}


def _port_run(nranks, build, schedule, M, steps, feeds, init=None):
    """The port's pipeline on one thread a rank, from the whole weights
    ``init`` where given (each rank loads its stages' and keeps its
    shards): per rank (losses, the weights of its stages gathered whole,
    the executor)."""
    def run(r, job, built):
        nodes, fed = built
        exe = tht.Executor(nodes, num_microbatches=M, device="cpu",
                           pp_options={"job": job}, **{schedule: True})
        if init is not None:
            exe.load_params(init)
        losses = []
        for i in range(steps):
            out = exe.run(feed_dict=dict(zip(fed, feeds(i))))
            losses.append(None if out[0] is None
                          else float(np.asarray(out[0].asnumpy())))
        whole = {node.name: exe._whole(node, exe.params[sid]).numpy()
                 for sid, node in exe._param_nodes.items()}
        return losses, whole, exe

    return job_ranks(nranks, run, build)


def _merged(results):
    """Every stage's whole weights from the ranks' results; the ranks of
    one stage hold the same."""
    out = {}
    for _, whole, _ in results:
        for name, value in whole.items():
            if name in out:
                np.testing.assert_array_equal(value, out[name])
            out[name] = value
    return out


def _assert_close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **(tol or dict(rtol=RTOL, atol=ATOL)))


@pytest.mark.parametrize("schedule,M,steps,bs", [
    ("gpipe", 4, 6, 32), ("pipedream", 1, 5, 16)])
def test_tp_and_dp_stages_follow_the_reference(schedule, M, steps, bs):
    """(a) tests/test_pipeline.py's ``test_gpipe_with_tp_and_dp_stages``
    and ``test_pipedream_with_tp_stage`` graph, 2 stages x 2 ranks, against
    the JAX package's pipeline on its host devices; (e) the split weight
    and its slots stored as shards (measured: losses within 1.1e-7
    relative, weights within 6e-8 absolute)."""
    w = _weights(7 if schedule == "gpipe" else 9)
    xs, ys = _data(64, 8 if schedule == "gpipe" else 10)
    x, y_, loss, train = _mlp(jht, w, (jht.cpu(0), jht.cpu(1)),
                              (jht.cpu(2), jht.cpu(3)))
    jexe = JExecutor([loss, train], num_microbatches=M, **{schedule: True})
    want = [float(np.asarray(jexe.run(feed_dict={
        x: a, y_: b})[0].asnumpy())) for a, b in
        (_feeds(xs, ys, i, bs) for i in range(steps))]

    def build(r):
        x, y_, loss, train = _mlp(tht, w, _workers(tht, 0, 1),
                                  _workers(tht, 2, 3))
        return [loss, train], [x, y_]

    results = _port_run(4, build, schedule, M, steps,
                        lambda i: _feeds(xs, ys, i, bs))
    for r, (losses, _, exe) in enumerate(results):
        sub = exe.subexecutors["default"]
        assert [st.ranks for st in sub.stages] == [[0, 1], [2, 3]]
        st = sub.stages[r // 2]
        assert st.mesh is not None and st.mesh.rank == r % 2
        if r < 2:           # TP: w1's columns, its slots none (SGD)
            w1 = next(p for p in st.param_nodes if p.name == "w1")
            assert tuple(exe.params[str(w1.id)].shape) == (20, 16)
            assert exe.config.tp_layouts is None and sub.multiproc
            assert all(v is None for v in losses)
        else:               # DP: the rows of the stage's activations
            np.testing.assert_allclose(losses, want, rtol=RTOL, atol=ATOL)
    _assert_close(_merged(results), _jax_params(jexe))


GPT_CFG = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=64,
               hidden_dropout_prob=0.0, use_flash_attention=True)
GPT_B, GPT_LR, GPT_M, SEEN = 4, 1e-3, 4, 16


def _gpt_batch(step):
    """tests/test_torch_pipeline.py's rows: every id of [0, SEEN) in
    every row, so the JAX package's dense table gradient and the port's
    lazy Adam move the same rows."""
    rng = np.random.RandomState(step)
    x = np.stack([rng.permutation(np.concatenate(
        [np.arange(SEEN), rng.randint(0, SEEN, 64 - SEEN)]))
        for _ in range(GPT_B)])
    return x, np.concatenate([x[:, 1:], np.full((GPT_B, 1), -1)], axis=1)


def _tiny_gpt(split):
    """The port's tiny GPT in 2 stages: over (worker0, worker1) and
    (worker2, worker3) split by ``DEFAULT_RULES`` at tp=2, else over
    cpu(0) and cpu(1) whole."""
    contexts = [_workers(tht, 0, 1), _workers(tht, 2, 3)] if split \
        else [tht.cpu(0), tht.cpu(1)]
    ids, labels, loss, _, train = TM.staged_gpt(TM.GPTConfig(**GPT_CFG),
                                                contexts, GPT_LR)
    if split:
        bindings, _ = tht.parallel.compile_rules([loss, train], tp=2)
        tht.parallel.apply_rules([loss, train], bindings)
    return [loss, train], [ids, labels]


def test_tiny_gpt_in_two_stages_at_tp2_follows_both_references(
        monkeypatch):
    """(b) 3 Adam steps, GPipe at M=4, 2 stages x tp=2 (even vocabulary:
    the tables and the LM head split too), the plain K2-K4 in every rank,
    against the JAX package's staged run (composed attention, its stage
    vjp has no rule for a pallas_call) and (c) against the port's run of
    the same stages in one process; (e) every split weight and its Adam
    slots at the shard's shape (measured: losses within 6.6e-7 relative
    and weights within 2.4e-6 absolute of either)."""
    monkeypatch.setattr(tattn, "FUSED_BWD_MIN_SEQ", 0)
    steps = 3
    ids, labels, loss, _, train = _jax_staged_gpt(
        JM.GPTConfig(**GPT_CFG), [jht.gpu(0), jht.gpu(1)], GPT_LR)
    jexe = JExecutor([loss, train], num_microbatches=GPT_M, gpipe=True)
    init = _jax_params(jexe)
    want = [float(jexe.run(feed_dict=dict(zip(
        (ids, labels), _gpt_batch(i))))[0].asnumpy()) for i in range(steps)]

    nodes, fed = _tiny_gpt(False)
    one = tht.Executor(nodes, num_microbatches=GPT_M, device="cpu",
                       gpipe=True)
    one.load_params(init)
    mine = [float(one.run(feed_dict=dict(zip(fed, _gpt_batch(i))))[0]
                  .asnumpy()) for i in range(steps)]

    results = _port_run(4, lambda r: _tiny_gpt(True), "gpipe", GPT_M, steps,
                        _gpt_batch, init)
    for r, (losses, _, exe) in enumerate(results):
        sub = exe.subexecutors["default"]
        st = sub.stages[r // 2]
        split = 0
        for p in st.param_nodes:
            layout = exe._layout(p)
            held = tuple(exe.params[str(p.id)].shape)
            assert tuple(exe.opt_state[p.id]["m"].shape) == held, p.name
            if layout is not None:
                split += 1
                assert held == tuple(s // 2 if ax else s for s, ax in
                                     zip(p.shape, layout)), p.name
            else:
                assert held == tuple(p.shape), p.name
        assert split >= 4, [p.name for p in st.param_nodes]
        if r >= 2:
            np.testing.assert_allclose(losses, mine, rtol=1e-5)
            np.testing.assert_allclose(losses, want, rtol=RTOL, atol=ATOL)
    got = _merged(results)
    _assert_close(got, {n.name: one.params[sid].numpy()
                        for sid, n in one._param_nodes.items()})
    _assert_close(got, _jax_params(jexe))


def test_every_split_weights_dispatch_sits_in_its_readers_stage():
    """(d) ``apply_rules`` on ``staged_gpt``, whose model is built
    outside every stage context: each parameter's dispatch takes its
    readers' context, so no weight crosses a stage boundary."""
    nodes, _ = _tiny_gpt(True)
    from hetu_tpu_torch.graph.autodiff import find_topo_sort
    topo = find_topo_sort(nodes)
    dispatches = [n for n in topo if isinstance(n, DispatchOp)
                  and isinstance(n.inputs[0], PlaceholderOp)]
    assert len(dispatches) >= 8
    stages = {_device_key(n) for n in topo if _device_key(n)}
    assert len(stages) == 2
    for d in dispatches:
        readers = [n for n in topo if d in n.inputs]
        assert readers and all(_device_key(n) == _device_key(d)
                               for n in readers), d.inputs[0].name
        assert _device_key(d) in stages


@pytest.mark.parametrize("widths", [(2, 1), (1, 2)])
def test_boundaries_between_groups_of_unequal_width(widths):
    """(f) a 2-rank TP stage feeding a 1-rank stage, and a 1-rank stage
    feeding a 2-rank DP stage: a boundary made whole in the sending
    group, rank k of the receiving group taking it from rank k mod width
    of the sending group, adjoints back the same way; 4 GPipe steps at
    M=4 against the JAX package (measured: losses within 1.1e-7
    relative, weights within 3e-8 absolute)."""
    w = _weights(11)
    xs, ys = _data(64, 12)
    tp, dp = widths == (2, 1), widths == (1, 2)
    jc = [jht.cpu(i) for i in range(3)]
    jctx = ((jc[0], jc[1]), jc[2]) if tp else (jc[0], (jc[1], jc[2]))
    x, y_, loss, train = _mlp(jht, w, *jctx, tp=tp, dp=dp)
    jexe = JExecutor([loss, train], num_microbatches=4, gpipe=True)
    want = [float(np.asarray(jexe.run(feed_dict={
        x: a, y_: b})[0].asnumpy())) for a, b in
        (_feeds(xs, ys, i, 32) for i in range(4))]

    def build(r):
        ctx = (_workers(tht, 0, 1), _workers(tht, 2)) if tp else \
            (_workers(tht, 0), _workers(tht, 1, 2))
        x, y_, loss, train = _mlp(tht, w, *ctx, tp=tp, dp=dp)
        return [loss, train], [x, y_]

    results = _port_run(3, build, "gpipe", 4, 4,
                        lambda i: _feeds(xs, ys, i, 32))
    sub = results[0][2].subexecutors["default"]
    assert [st.ranks for st in sub.stages] == \
        ([[0, 1], [2]] if tp else [[0], [1, 2]])
    for losses, _, exe in results[-(2 if dp else 1):]:
        np.testing.assert_allclose(losses, want, rtol=RTOL, atol=ATOL)
    _assert_close(_merged(results), _jax_params(jexe))


def test_an_indivisible_row_split_of_a_microbatch_is_refused():
    """(g) stage 1's ``dispatch(act, (2, 1))`` of a 3-row microbatch (12
    rows over M=4): every rank raises, naming the split and the
    microbatch, before any boundary crosses."""
    w = _weights(7)
    xs, ys = _data(12, 8)

    def build(r):
        x, y_, loss, train = _mlp(tht, w, _workers(tht, 0, 1),
                                  _workers(tht, 2, 3))
        return [loss, train], [x, y_]

    with pytest.raises(ValueError, match=r"splits dim 0 of its value of "
                       r"shape \(3, 32\) 2 ways.*does not divide.*"
                       r"num_microbatches"):
        _port_run(4, build, "gpipe", 4, 1, lambda i: (xs, ys))
