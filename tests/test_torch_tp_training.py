"""Tensor-parallel training in the port against the JAX package's TP
runs on its 8 host devices (tests/conftest.py).

Each rank is a thread with gloo groups of its own
(tests/torch_tp_util.py); the executor gets ``mesh=`` their
:class:`~hetu_tpu_torch.parallel.mesh.Mesh`. The JAX side is the same
graph under ``hetu_tpu``'s planner, its specs realized by XLA's SPMD
partitioner over a mesh of that many host devices.

Tolerances are the JAX package's own (tests/test_parallel.py:90-91:
losses rtol 2e-4, atol 1e-5) unless stated. The tiny GPT (even
vocabulary, so its tables and LM head split) is held to the JAX
package's TP run, whose attention runs on the CPU mesh: losses 1e-5
relative, weights within 1e-4 after 3 Adam steps.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu.models as JM
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
from hetu_tpu.parallel import autoplan as jautoplan
from hetu_tpu_torch.ops import attention as tattn

from torch_tp_util import ranks, same_ids

RTOL, ATOL = 2e-4, 1e-5


def _mlp_weights(seed=0):
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(32, 64).astype("f") * 0.1,
            "b1": np.zeros(64, "f"),
            "w2": rng.randn(64, 48).astype("f") * 0.1,
            "w3": rng.randn(48, 10).astype("f") * 0.1}


def _mlp_data(seed=1, n=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 32).astype(np.float32),
            np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)])


def _mlp(ht, split, dropout=None):
    """tests/test_parallel.py's MLP: ``split`` = (activation parts,
    weight parts) around the middle matmul; ``dropout`` a keep
    probability after the gather (a replicated region)."""
    w = _mlp_weights()
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
    if dropout is not None:
        act = ht.dropout_op(act, dropout)
    logits = ht.matmul_op(act, w3)
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    train = ht.optim.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return (x, y_), [loss, train], {"w1": w1, "b1": b1, "w2": w2, "w3": w3}


def _mlp_feeds(i, rows=16):
    xs, ys = _mlp_data()
    s = (i * rows) % 64
    return xs[s:s + rows], ys[s:s + rows]


def _train(exe, feeds, data, steps):
    out = []
    for i in range(steps):
        vals = exe.run(feed_dict=dict(zip(feeds, data(i))))
        out.append(float(np.asarray(vals[0].asnumpy()).reshape(())))
    return out


def _jax_run(build, data, steps):
    feeds, nodes, params = build(jht)
    exe = jht.Executor(nodes, ctx=jht.cpu(0))
    assert exe.config.mesh is not None
    return _train(exe, feeds, data, steps), exe, params


def _port_run(axes, build, data, steps):
    """The port's run on one thread a rank of ``axes``: (losses, each of
    the graph's named parameters' shard as numpy, the executor) by
    rank."""
    def run(r, mesh, built):
        feeds, nodes, params = built
        exe = tht.Executor(nodes, ctx=tht.cpu(0), mesh=mesh)
        losses = _train(exe, feeds, data, steps)
        shards = {name: exe.params[str(p.id)].numpy().copy()
                  for name, p in params.items()}
        return losses, shards, exe

    return ranks(axes, run, lambda r: build(tht))


def _jax_shard(exe, value, rank):
    """The block of a JAX array on the device at mesh position
    ``rank``."""
    device = exe.config.mesh.devices.flat[rank]
    return next(np.asarray(s.data) for s in value.addressable_shards
                if s.device == device)


MLP_SPLITS = {
    "left": (((2, 1), (1, 1)), {"tp0": 2}),      # row-split activation
    "right": (((1, 1), (1, 2)), {"tp0": 2}),     # col-split weight
    "middle": (((1, 2), (2, 1)), {"tp0": 2}),    # k-split contraction
    "grid": (((2, 2), (2, 1)), {"tp0": 2, "tp1": 2}),
    "wide": (((1, 1), (1, 4)), {"tp0": 2, "tp1": 2}),
    "row4": (((4, 1), (1, 1)), {"tp0": 2, "tp1": 2}),
}


@pytest.mark.parametrize("name", list(MLP_SPLITS))
def test_mlp_splits_match_the_reference(name):
    split, axes = MLP_SPLITS[name]
    build = lambda ht: _mlp(ht, split)      # noqa: E731
    want, jexe, jparams = _jax_run(build, _mlp_feeds, 6)
    results = _port_run(axes, build, _mlp_feeds, 6)
    for r, (losses, shards, _) in enumerate(results):
        np.testing.assert_allclose(losses, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} rank {r}")
        # every rank's shard of the split weight is the JAX package's
        # block on the device at its mesh position
        np.testing.assert_allclose(
            shards["w2"], _jax_shard(jexe, jexe.params[
                str(jparams["w2"].id)], r), rtol=RTOL, atol=ATOL)


def test_param_is_sharded():
    """A dispatched weight is stored sharded (the TP memory win): each
    rank holds its (64, 24) block of the (64, 48) weight."""
    results = _port_run({"tp0": 2}, lambda ht: _mlp(ht, ((1, 1), (1, 2))),
                        _mlp_feeds, 1)
    w = _mlp_weights()["w2"]
    for r, (_, shards, exe) in enumerate(results):
        assert shards["w2"].shape == (64, 24)
        assert shards["w1"].shape == (32, 64)
        assert exe.config.mesh.coord("tp0") == r
    for r, (_, shards, exe) in enumerate(
            _port_run({"tp0": 2}, lambda ht: _mlp(ht, ((1, 1), (1, 2))),
                      _mlp_feeds, 0)):
        np.testing.assert_array_equal(shards["w2"],
                                      w[:, 24 * r:24 * (r + 1)])


def _bert_arrays(B=4, S=8, H=16):
    """tests/test_parallel.py:305's draws, in its order: wq, wo, the
    feeds x and y, wc."""
    rng = np.random.RandomState(3)
    wq = rng.randn(H, H).astype("f") * 0.2
    wo = rng.randn(H, H).astype("f") * 0.2
    xs = rng.randn(B * S, H).astype("f")
    ys = np.eye(10, dtype=np.float32)[rng.randint(0, 10, B)]
    wc = rng.randn(H, 10).astype("f") * 0.2
    return wq, wo, xs, ys, wc


def _bert_layer(ht):
    """tests/test_parallel.py:305's attention + FFN block under a TP
    dispatch."""
    B, S, H, NH = 4, 8, 16, 2
    wq, wo, _, _, wc = _bert_arrays(B, S, H)
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    vq = ht.Variable("wq", value=wq)
    vo = ht.Variable("wo", value=wo)
    vc = ht.Variable("wc", value=wc)
    q2 = ht.matmul_op(x, ht.dispatch(vq, (1, 2)))
    q = ht.transpose_op(
        ht.array_reshape_op(q2, [B, S, NH, H // NH]), [0, 2, 1, 3])
    probs = ht.softmax_op(ht.batch_matmul_op(q, q, trans_B=True))
    ctxv = ht.batch_matmul_op(probs, q)
    merged = ht.array_reshape_op(
        ht.transpose_op(ctxv, [0, 2, 1, 3]), [B * S, H])
    h = ht.dispatch(ht.matmul_op(merged, vo), (1, 1))
    pooled = ht.reduce_mean_op(ht.array_reshape_op(h, [B, S, H]), [1])
    logits = ht.matmul_op(pooled, vc)
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    train = ht.optim.SGDOptimizer(0.05).minimize(loss)
    return (x, y_), [loss, train], {"wq": vq, "wo": vo, "wc": vc}


def _bert_data(i):
    return _bert_arrays()[2:4]


def test_bert_style_layer_matches_the_reference():
    want, _, _ = _jax_run(_bert_layer, _bert_data, 4)
    for r, (losses, shards, _) in enumerate(
            _port_run({"tp0": 2}, _bert_layer, _bert_data, 4)):
        np.testing.assert_allclose(losses, want, rtol=RTOL, atol=ATOL)
        assert shards["wq"].shape == (16, 8)


# conv split vocabulary -> (data parts, filter parts) over NCHW x OIHW
# (examples/runner/parallel/common.py CNN_SPLITS)
CNN_SPLITS = {
    "left": ((2, 1, 1, 1), (1, 1, 1, 1)),
    "right": ((1, 1, 1, 1), (2, 1, 1, 1)),
    "middle": ((1, 2, 1, 1), (1, 2, 1, 1)),
}


def _cnn(ht, split):
    rng = np.random.RandomState(43)
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    w1 = ht.Variable("conv1", value=rng.randn(8, 2, 3, 3).astype("f") * .2)
    w2 = ht.Variable("special", value=rng.randn(8, 8, 3, 3).astype("f") * .1)
    wf = ht.Variable("fc", value=rng.randn(8 * 6 * 6, 10).astype("f") * .05)
    act = ht.relu_op(ht.conv2d_op(x, w1, padding=1, stride=1))
    act = ht.conv2d_op(ht.dispatch(act, split[0]), ht.dispatch(w2, split[1]),
                       padding=1, stride=1)
    act = ht.relu_op(ht.dispatch(act, (1, 1, 1, 1)))
    logits = ht.matmul_op(ht.array_reshape_op(act, [-1, 8 * 6 * 6]), wf)
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    train = ht.optim.SGDOptimizer(0.05).minimize(loss)
    return (x, y_), [loss, train], {"special": w2}


def _cnn_data(i):
    rng = np.random.RandomState(7 + i)
    return (rng.randn(4, 2, 6, 6).astype("f"),
            np.eye(10, dtype=np.float32)[rng.randint(0, 10, 4)])


@pytest.mark.parametrize("name", list(CNN_SPLITS))
def test_conv_splits_match_the_reference(name):
    build = lambda ht: _cnn(ht, CNN_SPLITS[name])       # noqa: E731
    want, jexe, jparams = _jax_run(build, _cnn_data, 3)
    for r, (losses, shards, _) in enumerate(
            _port_run({"tp0": 2}, build, _cnn_data, 3)):
        np.testing.assert_allclose(losses, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            shards["special"], _jax_shard(jexe, jexe.params[
                str(jparams["special"].id)], r), rtol=RTOL, atol=ATOL)


# --- a tiny GPT, the chip path at small widths --------------------------

GPT_CFG = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=64,
               hidden_dropout_prob=0.0, use_flash_attention=True)
GPT_B, GPT_S = 2, 64


def _gpt(ht, models, tp):
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _, loss = models.GPTLMHeadModel(models.GPTConfig(**GPT_CFG))(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    nodes = [lm, ht.optim.AdamOptimizer(learning_rate=1e-3).minimize(lm)]
    if tp > 1:
        ap = jautoplan if ht is jht else tht.parallel.autoplan
        bindings, _ = ap.compile_rules(nodes, None, tp=tp)
        ap.apply_rules(nodes, bindings)
    return (ids, labels), nodes


def _gpt_batch(i):
    """Ids from the first 40 rows only: most of each table is never
    touched, and lazy Adam must leave those rows (on both shards)."""
    rng = np.random.RandomState(i)
    x = rng.randint(0, 40, (GPT_B, GPT_S))
    return x, np.concatenate([x[:, 1:], np.full((GPT_B, 1), -1)], axis=1)


def _names(exe):
    return {node.name: sid for sid, node in exe._param_nodes.items()}


def test_tiny_gpt_at_tp2_matches_the_reference(monkeypatch):
    """compile_rules + apply_rules at tp=2 split the token and position
    tables by rows (their gradients sparse, kept on each rank's rows),
    the LM head and each block's four weights by columns. Reference:
    the JAX package's TP run over 2 host devices."""
    monkeypatch.setattr(tattn, "FUSED_BWD_MIN_SEQ", 0)
    feeds, nodes = _gpt(jht, JM, 2)
    jexe = jht.Executor(nodes)
    want = _train(jexe, feeds, _gpt_batch, 3)
    jnames = _names(jexe)

    def run(r, mesh, built):
        feeds, nodes = built
        exe = tht.Executor(nodes, ctx=tht.cpu(0), mesh=mesh)
        losses = _train(exe, feeds, _gpt_batch, 3)
        got, split = {}, set()
        for name, sid in _names(exe).items():
            node = exe._param_nodes[sid]
            ref = torch.as_tensor(np.array(jexe.params[jnames[name]]))
            got[name] = (exe.params[sid].numpy().copy(),
                         exe._local(node, ref).numpy())
            if exe._layout(node) is not None:
                split.add(name)
        return losses, got, split

    results = ranks({"tp0": 2}, run, lambda r: _gpt(tht, TM, 2))
    for r, (losses, params, split) in enumerate(results):
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        assert split == {"gpt_wte", "gpt_wpe", "gpt_lm_head_weights"} | {
            f"gpt_h{i}_{w}_weights" for i in range(2)
            for w in ("attn_qkv", "attn_proj", "mlp_fc", "mlp_proj")}
        for name, (value, ref) in params.items():
            assert value.shape == ref.shape, name
            np.testing.assert_allclose(value, ref, rtol=0, atol=1e-4,
                                       err_msg=f"{name} rank {r}")


def test_tiny_gpt_tp2_equals_one_process_bit_for_bit(monkeypatch):
    """In f32 on the CPU the port's TP run rounds as its one-process run
    does: the gathers and the masked lookup's all-reduce add zeros, and
    the k-split partial sums are the only reordering."""
    monkeypatch.setattr(tattn, "FUSED_BWD_MIN_SEQ", 0)
    feeds, nodes = _gpt(tht, TM, 1)
    base = _train(tht.Executor(nodes, ctx=tht.cpu(0)), feeds, _gpt_batch, 2)

    def run(r, mesh, built):
        feeds, nodes = built
        exe = tht.Executor(nodes, ctx=tht.cpu(0), mesh=mesh)
        return _train(exe, feeds, _gpt_batch, 2)

    for losses in ranks({"tp0": 2}, run, lambda r: _gpt(tht, TM, 2)):
        np.testing.assert_allclose(losses, base, rtol=1e-6)


def test_dp2_by_tp2_matches_the_reference():
    """A ("dp", "tp0") mesh of 4 ranks: DP splits the 16 rows over dp
    and averages the gradients on that axis alone, TP splits w2's
    columns; the losses are the JAX package's TP run on the whole
    batch."""
    build = lambda ht: _mlp(ht, ((1, 1), (1, 2)))      # noqa: E731
    want, _, _ = _jax_run(build, _mlp_feeds, 4)
    results = _port_run({"dp": 2, "tp0": 2}, build, _mlp_feeds, 4)
    for r, (losses, shards, exe) in enumerate(results):
        np.testing.assert_allclose(losses, want, rtol=RTOL, atol=ATOL)
        assert exe.config.nrank == 2 and shards["w2"].shape == (64, 24)
        assert exe.config.dp_comm.nrank == 2
        assert exe.subexecutors["default"].dp.rank == exe.config.mesh.coord(
            "dp")
    # the ranks of one dp slice hold the same shard; tp0 picks the block
    assert np.array_equal(results[0][1]["w2"], results[2][1]["w2"])
    assert not np.array_equal(results[0][1]["w2"], results[1][1]["w2"])


def test_dropout_in_a_replicated_region_stays_equal_across_ranks():
    """Dropout after the gather: each rank draws the whole mask from the
    same generator (the seed does not depend on the TP coordinate), so
    both ranks train the same weights, and those of one process built
    with the same op ids."""
    build = lambda ht: _mlp(ht, ((1, 1), (1, 2)), dropout=0.5)  # noqa
    # (1, 1) dispatches: the same nodes, ids and masks, nothing split
    feeds, nodes, params = same_ids(
        lambda ht: _mlp(ht, ((1, 1), (1, 1)), dropout=0.5), tht)
    exe = tht.Executor(nodes, ctx=tht.cpu(0))
    want = _train(exe, feeds, _mlp_feeds, 4)
    one = {name: exe.params[str(p.id)].numpy() for name, p in params.items()}
    results = _port_run({"tp0": 2}, build, _mlp_feeds, 4)
    for r, (losses, shards, _) in enumerate(results):
        np.testing.assert_allclose(losses, want, rtol=1e-6)
        for name in ("w1", "b1", "w3"):
            np.testing.assert_array_equal(shards[name], results[0][1][name])
            np.testing.assert_allclose(shards[name], one[name], rtol=1e-6,
                                       atol=1e-7)
        np.testing.assert_allclose(shards["w2"],
                                   one["w2"][:, 24 * r:24 * (r + 1)],
                                   rtol=1e-6, atol=1e-7)


def test_save_gathers_and_load_slices():
    """Every rank calls save; the whole weight lands on disk and a
    one-process session reads it; load_params gives each rank its
    block back."""
    build = lambda ht: _mlp(ht, ((1, 1), (1, 2)))      # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        def run(r, mesh, built):
            feeds, nodes, params = built
            exe = tht.Executor(nodes, ctx=tht.cpu(0), mesh=mesh)
            _train(exe, feeds, _mlp_feeds, 2)
            exe.save(tmp)
            whole = np.arange(64 * 48, dtype="f").reshape(64, 48)
            exe.load_params({"w2": whole})
            return exe.params[str(params["w2"].id)].numpy().copy(), \
                exe.opt_state

        results = ranks({"tp0": 2}, run, lambda r: build(tht))
        saved = np.load(os.path.join(tmp, "w2.npy"))
        assert saved.shape == (64, 48)
        feeds, nodes, params = _mlp(tht, ((1, 1), (1, 1)))
        exe = tht.Executor(nodes, ctx=tht.cpu(0))
        exe.load(tmp)
        assert exe.params[str(params["w2"].id)].shape == (64, 48)
    whole = np.arange(64 * 48, dtype="f").reshape(64, 48)
    for r, (w2, _) in enumerate(results):
        np.testing.assert_array_equal(w2, whole[:, 24 * r:24 * (r + 1)])
    with pytest.raises(ValueError, match="checkpoint shape"):
        exe.load_params({"w2": np.zeros((64, 24), "f")})


def test_adam_slots_are_sized_to_the_shard():
    """Adam's m and v of a split weight are the shard's shape."""
    def build(ht):
        feeds, nodes, params = _mlp(ht, ((1, 1), (1, 2)))
        loss = nodes[0]
        return feeds, [loss, ht.optim.AdamOptimizer(1e-3).minimize(loss)], \
            params

    def run(r, mesh, built):
        feeds, nodes, params = built
        exe = tht.Executor(nodes, ctx=tht.cpu(0), mesh=mesh)
        _train(exe, feeds, _mlp_feeds, 1)
        return {k: tuple(v.shape) for k, v in
                exe.opt_state[params["w2"].id].items()}

    for slots in ranks({"tp0": 2}, run, lambda r: build(tht)):
        assert slots == {"m": (64, 24), "v": (64, 24)}


def test_fetched_split_values_are_whole():
    """A fetched node held split is gathered: the right split's middle
    product, column-split on the ranks, is fetched whole, equal to the
    one-process value."""
    from hetu_tpu_torch.graph.autodiff import find_topo_sort
    from hetu_tpu_torch.ops.comm import DispatchOp
    from hetu_tpu_torch.ops.linalg import MatMulOp

    def build(ht, split):
        feeds, nodes, params = _mlp(ht, split)
        mid = next(n.inputs[0] for n in find_topo_sort(nodes)
                   if isinstance(n, DispatchOp)
                   and isinstance(n.inputs[0], MatMulOp))
        return feeds, [nodes[0], mid, nodes[1]]

    feeds, nodes = same_ids(build, tht, ((1, 1), (1, 1)))
    want = tht.Executor(nodes, ctx=tht.cpu(0)).run(
        feed_dict=dict(zip(feeds, _mlp_feeds(0))))[1].asnumpy()

    def run(r, mesh, built):
        feeds, nodes = built
        exe = tht.Executor(nodes, ctx=tht.cpu(0), mesh=mesh)
        got = exe.run(feed_dict=dict(zip(feeds, _mlp_feeds(0))))[1]
        assert exe.subexecutors["default"].tp.layout[nodes[1]] == \
            ((), ("tp0",))
        return got.asnumpy()

    for got in ranks({"tp0": 2}, run,
                     lambda r: build(tht, ((1, 1), (1, 2)))):
        assert got.shape == want.shape == (16, 48)
        np.testing.assert_allclose(got, want, rtol=1e-6)


# --- each local rule on its own, forward and backward -----------------------

def _rule_case(name):
    """A small graph whose dispatches drive one local rule of the
    realization, trained 2 SGD steps: (data(i), build(ht))."""
    rng = np.random.RandomState(11)
    a = rng.randn(4, 6, 8).astype("f")
    b = rng.randn(4, 8, 6).astype("f") * 0.3
    t = rng.randn(12, 8).astype("f")
    m = rng.randn(8, 12).astype("f") * 0.3
    ids = rng.randint(0, 12, (6, 2))

    def data(i):
        return ((ids + i) % 12,) if name == "lookup_cols" else (a + i,)

    def build(ht):
        x = ht.Variable("x", trainable=False)
        feeds = (x,)
        if name in ("batch_matmul_batch", "batch_matmul_k"):
            parts = ((2, 1, 1), (2, 1, 1)) if name == "batch_matmul_batch" \
                else ((1, 1, 2), (1, 2, 1))
            w = ht.Variable("w", value=b.copy())
            out = ht.batch_matmul_op(ht.dispatch(x, parts[0]),
                                     ht.dispatch(w, parts[1]))
        elif name == "transpose_reshape":
            w = ht.Variable("w", value=m.copy())
            h = ht.matmul_op(ht.array_reshape_op(x, [-1, 8]),
                             ht.dispatch(w, (1, 2)))     # (24, 12) by columns
            h = ht.array_reshape_op(ht.transpose_op(h, [1, 0]),
                                    [-1, 4, 6])          # (12, ...) by rows
            out = ht.dispatch(ht.relu_op(h), (1, 1, 1))
        elif name == "lookup_cols":
            idx = ht.Variable("ids", trainable=False, dtype=np.int64)
            feeds = (idx,)
            w = ht.Variable("w", value=t.copy())
            emb = ht.embedding_lookup_op(ht.dispatch(w, (1, 2)), idx)
            out = ht.dispatch(emb, (1, 1, 1))
        else:   # mixed layouts into one elementwise op
            w = ht.Variable("w", value=a[0].copy() * 0.1)
            xs = ht.reduce_mean_op(x, [0])                    # (6, 8)
            out = ht.dispatch(xs, (2, 1)) * ht.dispatch(w, (1, 2))
        loss = ht.reduce_mean_op(out * out, [0, 1, 2]
                                 if name != "mixed_elementwise" else [0, 1])
        train = ht.optim.SGDOptimizer(0.1).minimize(loss)
        return feeds, [loss, out, train], {"w": w}

    return data, build


RULE_OPS = {"batch_matmul_batch": {"BatchMatMulOp"},
            "batch_matmul_k": {"BatchMatMulOp"},
            "transpose_reshape": {"TransposeOp", "ArrayReshapeOp",
                                  "MatMulOp"},
            "lookup_cols": {"EmbeddingLookUp"},
            "mixed_elementwise": {"MulOp"}}


@pytest.mark.parametrize("name", sorted(RULE_OPS))
def test_each_local_rule_matches_the_reference(name):
    """Batch-matmul batch and k splits, a transpose and reshapes of a
    column-split product, a lookup into a column-split table (and its
    sparse gradient's columns), an elementwise op of inputs in two
    layouts: 2 SGD steps against the JAX package's TP run, losses, the
    fetched output (whole) and w's block."""
    data, build = _rule_case(name)
    feeds, nodes, params = build(jht)
    jexe = jht.Executor(nodes, ctx=jht.cpu(0))
    want = [jexe.run(feed_dict=dict(zip(feeds, data(i)))) for i in range(2)]

    def run(r, mesh, built):
        feeds, nodes, params = built
        exe = tht.Executor(nodes, ctx=tht.cpu(0), mesh=mesh)
        outs = [exe.run(feed_dict=dict(zip(feeds, data(i))))
                for i in range(2)]
        # the rule under test ran on the shards, not by the gather rule
        assert not RULE_OPS[name] & set(
            exe.subexecutors["default"].tp.gather_rule)
        return outs, exe

    ref = torch.as_tensor(np.array(jexe.params[str(params["w"].id)]))
    for outs, exe in ranks({"tp0": 2}, run, lambda r: build(tht)):
        for got, exp in zip(outs, want):
            np.testing.assert_allclose(got[0].asnumpy(), exp[0].asnumpy(),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got[1].asnumpy(), exp[1].asnumpy(),
                                       rtol=RTOL, atol=ATOL)
        node = next(n for n in exe._param_nodes.values() if n.name == "w")
        assert exe._layout(node) is not None
        np.testing.assert_allclose(
            exe.params[str(node.id)].numpy(),
            exe._local(node, ref).numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("parts", [(2, 1), (1, 2)])
def test_lookup_of_a_split_table_indexes_as_one_process(parts):
    """A forward lookup into a row- or column-split table gives each id
    its row as ``table[ids]`` does on the whole table, a negative id
    counting from the end."""
    table = np.arange(12 * 8, dtype="f").reshape(12, 8)
    ids = np.array([[0, 11], [-1, 5], [6, -12]])

    def build(ht):
        idx = ht.Variable("ids", trainable=False, dtype=np.int64)
        w = ht.Variable("w", value=table.copy())
        emb = ht.embedding_lookup_op(ht.dispatch(w, parts), idx)
        return idx, ht.dispatch(emb, (1, 1, 1))

    def run(r, mesh, built):
        idx, out = built
        exe = tht.Executor([out], ctx=tht.cpu(0), mesh=mesh)
        return exe.run(feed_dict={idx: ids})[0].asnumpy()

    for got in ranks({"tp0": 2}, run, lambda r: build(tht)):
        np.testing.assert_array_equal(got, table[ids])
