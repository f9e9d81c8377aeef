"""The tensor-parallel planner in the port against the JAX package's:
``NodeStatus`` and its device-index algebra, ``spec_for_status``, every
op's ``deduce_states`` rule, ``propagate_statuses`` node by node, the
rules compiler, the mesh, and the refusals that stay (each naming the
ROADMAP sub-item that owns it).

Statuses are exact integer tuples: every comparison is equality. The
planner's numerics are held by tests/test_torch_tp_training.py.
"""
import importlib
import logging

import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu.models as JM
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
from hetu_tpu.graph.autodiff import find_topo_sort as jtopo
from hetu_tpu.parallel import factorized_axes as jfactorized
from hetu_tpu.parallel import spec_for_status as jspec
from hetu_tpu.parallel.planner import propagate_statuses as jprop
from hetu_tpu_torch.graph.autodiff import find_topo_sort as ttopo
from hetu_tpu_torch.parallel import mesh as tmesh
from hetu_tpu_torch.parallel import planner as tplanner

PACKAGES = {"jax": (jht, JM, jtopo, jprop),
            "port": (tht, TM, ttopo, tplanner.propagate_statuses)}


def _st(ht, state, dup=1, order=None):
    st = ht.NodeStatus(state, duplicate=dup, order=order)
    if order is None:
        st.get_default()
    return st


def _key(st):
    return None if st is None else (st.state, st.duplicate, st.order)


# --- NodeStatus -------------------------------------------------------------

@pytest.mark.parametrize("state,dup,order", [
    ((2, 2), 2, (-1, 0, 1)),
    ((2, 2), 2, (0, -1, 1)),
    ((4, 1), 2, (1, 0, -1)),
    ((1, 2, 4), 1, (-1, 2, 0, 1)),
])
def test_status_algebra_matches_the_reference(state, dup, order):
    j, t = (ht.NodeStatus(state, duplicate=dup, order=order)
            for ht in (jht, tht))
    n = int(np.prod(state)) * dup
    assert [t.map_dev_to_index(g) for g in range(n)] == \
        [j.map_dev_to_index(g) for g in range(n)]
    assert t.get_loop_sizes() == j.get_loop_sizes()
    assert (t.device_num, t.is_dist(), t.mesh_shape()) == \
        (j.device_num, j.is_dist(), j.mesh_shape())
    assert t.to_partition_spec() == tuple(j.to_partition_spec())
    assert t.to_partition_spec({0: "x"}) == \
        tuple(j.to_partition_spec({0: "x"}))
    assert hash(t) == hash(tht.NodeStatus(state, dup, order))
    assert t == tht.NodeStatus.from_other(t) and repr(t) == repr(j)


def test_status_defaults_and_setters_match_the_reference():
    j, t = jht.NodeStatus({1: 2}), tht.NodeStatus({1: 2})
    assert t.state == j.state == (1, 2) and t.device_num is None
    assert t.get_default() == j.get_default()
    t2, j2 = tht.NodeStatus(), jht.NodeStatus()
    t2.set_state({0: 4})
    j2.set_state({0: 4})
    t2.set_attr(2, (0, -1))
    j2.set_attr(2, (0, -1))
    assert _key(t2) == _key(j2) and t2.device_num == j2.device_num == 8
    with pytest.raises(AssertionError):
        t.set_attr(3, (-1, 0, 1))        # defaulted: attrs are fixed
    t.check_devices(list(range(2)))
    assert not tht.NodeStatus((1, 1)).is_dist()


@pytest.mark.parametrize("n", [2, 4, 8, 12])
@pytest.mark.parametrize("state", [(2, 2), (4, 1), (1, 8), (2, 1), (1, 1),
                                   (3, 1), (2, 3), (1, 4)])
def test_spec_for_status_matches_the_reference(n, state, caplog):
    j = jspec(_st(jht, state), jfactorized(n))
    with caplog.at_level(logging.WARNING,
                         logger="hetu_tpu_torch.parallel.planner"):
        t = tplanner.spec_for_status(_st(tht, state),
                                     tmesh.factorized_axes(n))
    assert t == (None if j is None else tuple(j))
    assert tplanner.spec_for_status(None, tmesh.factorized_axes(n)) is \
        jspec(None, jfactorized(n)) is None


def test_spec_lowering_of_the_reference_cases():
    axes = tmesh.factorized_axes(8)
    assert tplanner.spec_for_status(_st(tht, (2, 2)), axes) == \
        ("tp0", "tp1")
    assert tplanner.spec_for_status(_st(tht, (4, 1)), axes) == \
        (("tp0", "tp1"),)
    assert tplanner.spec_for_status(_st(tht, (1, 8)), axes) == \
        (None, ("tp0", "tp1", "tp2"))


def test_spec_lowering_warns_on_unmappable(caplog):
    """A distributed status the planner cannot map is replicated (exact)
    and warns naming the node and status, with the JAX package's
    text."""
    with caplog.at_level(logging.WARNING,
                         logger="hetu_tpu_torch.parallel.planner"):
        assert tplanner.spec_for_status(
            _st(tht, (3, 1)), tmesh.factorized_axes(4),
            node="MatMulOp(w_proj)") is None
    msgs = [r.getMessage() for r in caplog.records]
    assert any("MatMulOp(w_proj)" in m and "unmappable" in m
               and "replicated layout" in m for m in msgs), msgs


def test_mesh_for_statuses_outside_a_job_names_the_ranks_it_needs():
    with pytest.raises(ValueError, match="needs 4 ranks, the job has 1"):
        tmesh.mesh_for_statuses([_st(tht, (2, 1))], dp=2)
    assert tmesh.tp_degree([_st(tht, (2, 2)), None, _st(tht, (1, 2))]) == 4


def test_mesh_coordinates_are_row_major():
    m = tmesh.Mesh({"dp": 2, "tp0": 2, "tp1": 3}, 9,
                   {"dp": 0, "tp0": 1, "tp1": 2})
    assert (m.coord("dp"), m.coord("tp0"), m.coord("tp1")) == (1, 1, 0)


# --- deduce_states, rule by rule --------------------------------------------

def _vars(ht, n):
    return [ht.Variable(f"v{i}", trainable=False) for i in range(n)]


RULES = {
    "matmul_row": (lambda ht, a, b: ht.matmul_op(a, b), [(2, 1), None]),
    "matmul_col": (lambda ht, a, b: ht.matmul_op(a, b), [None, (1, 2)]),
    "matmul_k": (lambda ht, a, b: ht.matmul_op(a, b), [(1, 2), (2, 1)]),
    "matmul_grid": (lambda ht, a, b: ht.matmul_op(a, b), [(2, 2), (2, 1)]),
    "matmul_trans_a": (lambda ht, a, b: ht.matmul_op(a, b, trans_A=True),
                       [(2, 1), (2, 1)]),
    "matmul_trans_b": (lambda ht, a, b: ht.matmul_op(a, b, trans_B=True),
                       [None, (1, 2)]),
    "matmul_dup": (lambda ht, a, b: ht.matmul_op(a, b),
                   [((2, 1), 2), (1, 2)]),
    "batch_matmul": (lambda ht, a, b: ht.batch_matmul_op(a, b),
                     [(2, 1, 1), (1, 1, 2)]),
    "batch_matmul_k": (lambda ht, a, b: ht.batch_matmul_op(a, b),
                       [(1, 1, 2), (1, 2, 1)]),
    "batch_matmul_trans": (lambda ht, a, b: ht.batch_matmul_op(
        a, b, trans_A=True, trans_B=True), [(2, 1, 2, 1), None]),
    "embedding_rows": (lambda ht, t, i: ht.embedding_lookup_op(t, i),
                       [(4, 1), (2,)]),
    "embedding_cols": (lambda ht, t, i: ht.embedding_lookup_op(t, i),
                       [(1, 2), (2,)]),
    "embedding_no_index": (lambda ht, t, i: ht.embedding_lookup_op(t, i),
                           [(2, 1), None]),
    "embedding_index_only": (lambda ht, t, i: ht.embedding_lookup_op(t, i),
                             [None, (2, 1)]),
    "conv_batch_out": (lambda ht, a, f: ht.conv2d_op(a, f),
                       [(2, 1, 1, 1), (2, 1, 1, 1)]),
    "conv_in": (lambda ht, a, f: ht.conv2d_op(a, f),
                [(1, 2, 1, 1), (1, 2, 1, 1)]),
    "conv_filter_only": (lambda ht, a, f: ht.conv2d_op(a, f),
                         [None, (1, 2, 1, 1)]),
    "reshape_lead": (lambda ht, a: ht.array_reshape_op(a, [-1, 8]),
                     [(2, 4)]),
    "reshape_fold": (lambda ht, a: ht.array_reshape_op(a, [8, -1]),
                     [(2, 4)]),
    "broadcastto": (lambda ht, a, b: ht.broadcastto_op(a, b),
                    [None, (2, 1)]),
    "broadcastto_a_only": (lambda ht, a, b: ht.broadcastto_op(a, b),
                           [(1, 2), None]),
    "concat": (lambda ht, a, b: ht.concat_op(a, b, axis=0),
               [(2, 4), (2, 4)]),
    "concat_axis1": (lambda ht, a, b: ht.concat_op(a, b, axis=1),
                     [None, ((2, 2), 2)]),
    "concatenate": (lambda ht, a, b, c: ht.concatenate_op([a, b, c],
                                                          axis=1),
                    [(1, 2), (1, 2), (1, 2)]),
    "split": (lambda ht, a: ht.split_op(a, [1], [0], [2]), [(2, 4)]),
    "split_two_axes": (lambda ht, a: ht.split_op(a, [0, 1], [1, 0], [2, 2]),
                       [(2, 4)]),
    "transpose": (lambda ht, a: ht.transpose_op(a, [1, 0]), [(2, 4)]),
    "transpose_default": (lambda ht, a: ht.transpose_op(a), [(2, 1, 4)]),
    "reduce_sum": (lambda ht, a: ht.reduce_sum_op(a, [0]), [(2, 4)]),
    "reduce_sum_keep": (lambda ht, a: ht.reduce_sum_op(a, [1],
                                                       keepdims=True),
                        [(2, 4)]),
    "reduce_mean": (lambda ht, a: ht.reduce_mean_op(a, [-1]),
                    [((2, 4), 2)]),
    "reduce_mean_all": (lambda ht, a: ht.reduce_mean_op(a, [0, 1]),
                        [(2, 4)]),
    "elementwise_add": (lambda ht, a, b: ht.add_op(a, b), [None, (2, 1)]),
    "elementwise_relu": (lambda ht, a: ht.relu_op(a), [((1, 2), 2)]),
    "dispatch": (lambda ht, a: ht.dispatch(a, (2, -2)), [(1, 2)]),
    "dispatch_dict": (lambda ht, a: ht.dispatch(a, {1: 4}), [None]),
}


def _deduce(ht, name, shapes=None):
    make, statuses = RULES[name]
    ins = _vars(ht, len(statuses))
    node = make(ht, *ins)
    for v, shape in zip(ins, shapes or ()):
        v.inferred_shape = shape
    sts = [None if s is None else
           _st(ht, *s) if isinstance(s[0], tuple) else _st(ht, s)
           for s in statuses]
    out = ht.NodeStatus()
    node.deduce_states(sts, out, False)
    return _key(out) if out.state is not None else None


@pytest.mark.parametrize("name", sorted(RULES))
def test_each_rule_matches_the_reference(name):
    assert _deduce(tht, name) == _deduce(jht, name)


@pytest.mark.parametrize("in_shape,want_lead", [((4, 16), 2), ((3, 16), 1)])
def test_reshape_keeps_a_lead_split_its_first_dim_divides(in_shape,
                                                          want_lead):
    """``array_reshape_op(a, [8, -1])`` keeps dim 0's split where 8 is a
    multiple of the input's dim 0, in both packages."""
    got = _deduce(tht, "reshape_fold", [in_shape])
    assert got == _deduce(jht, "reshape_fold", [in_shape])
    assert got[0][0] == want_lead


# --- propagation, node by node ----------------------------------------------

def _mlp(ht, split=((2, 2), (2, 1))):
    """tests/test_parallel.py's MLP under a TP split."""
    rng = np.random.RandomState(0)
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    w1 = ht.Variable("w1", value=rng.randn(32, 64).astype("f"))
    b1 = ht.Variable("b1", value=np.zeros(64, "f"))
    w2 = ht.Variable("w2", value=rng.randn(64, 48).astype("f"))
    w3 = ht.Variable("w3", value=rng.randn(48, 10).astype("f"))
    act = ht.matmul_op(x, w1)
    act = ht.relu_op(act + ht.broadcastto_op(b1, act))
    act = ht.matmul_op(ht.dispatch(act, split[0]), ht.dispatch(w2, split[1]))
    act = ht.relu_op(ht.dispatch(act, (1, 1)))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(act, w3), y_), [0])
    return [loss, ht.optim.SGDOptimizer(0.1).minimize(loss)]


def _bert_layer(ht):
    """tests/test_parallel.py's BERT-style block under its TP dispatch."""
    B, S, H, NH = 4, 8, 16, 2
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    vq = ht.Variable("wq", value=np.ones((H, H), "f"))
    vo = ht.Variable("wo", value=np.ones((H, H), "f"))
    vc = ht.Variable("wc", value=np.ones((H, 10), "f"))
    q2 = ht.matmul_op(x, ht.dispatch(vq, (1, 2)))
    q = ht.transpose_op(ht.array_reshape_op(q2, [B, S, NH, H // NH]),
                        [0, 2, 1, 3])
    probs = ht.softmax_op(ht.batch_matmul_op(q, q, trans_B=True))
    merged = ht.array_reshape_op(
        ht.transpose_op(ht.batch_matmul_op(probs, q), [0, 2, 1, 3]),
        [B * S, H])
    h = ht.dispatch(ht.matmul_op(merged, vo), (1, 1))
    pooled = ht.reduce_mean_op(ht.array_reshape_op(h, [B, S, H]), [1])
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(pooled, vc), y_), [0])
    return [loss, ht.optim.SGDOptimizer(0.05).minimize(loss)]


GPT_CFG = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=64,
               hidden_dropout_prob=0.0, use_flash_attention=True)


def _gpt_nodes(ht, models):
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _, loss = models.GPTLMHeadModel(models.GPTConfig(**GPT_CFG))(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    return [lm, ht.optim.AdamOptimizer(learning_rate=1e-3).minimize(lm)]


def _autoplan(ht):
    return importlib.import_module(ht.__name__ + ".parallel.autoplan")


def _gpt(ht, models):
    nodes = _gpt_nodes(ht, models)
    ap = _autoplan(ht)
    bindings, _ = ap.compile_rules(nodes, None, tp=2)
    ap.apply_rules(nodes, bindings)
    return nodes


GRAPHS = {"mlp": lambda ht, models: _mlp(ht),
          "bert_layer": lambda ht, models: _bert_layer(ht),
          "gpt": _gpt}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_propagation_matches_the_reference_node_by_node(graph):
    seqs = {}
    for name, (ht, models, topo, prop) in PACKAGES.items():
        order = topo(GRAPHS[graph](ht, models))
        status = prop(order)
        seqs[name] = [(n.op_type, _key(status.get(n))) for n in order]
    assert seqs["port"] == seqs["jax"]
    assert sum(k is not None for _, k in seqs["port"]) > 10


def test_compile_rules_binds_the_tiny_gpt_as_the_reference():
    got = {}
    for name, (ht, models, _, _) in PACKAGES.items():
        nodes = _gpt_nodes(ht, models)
        bindings, conflicts = _autoplan(ht).compile_rules(nodes, None, tp=2)
        got[name] = [(b.param.name, b.axes, b.parts, b.dim, b.axis_name)
                     for b in bindings]
        assert conflicts == []
    assert got["port"] == got["jax"]
    parts = {name: p for name, _, p, _, _ in got["port"]}
    assert parts["gpt_wte"] == parts["gpt_wpe"] == (2, 1)
    assert parts["gpt_lm_head_weights"] == (1, 2)
    assert parts["gpt_h0_attn_qkv_weights"] == (1, 2)
    assert not any(n.endswith("_bias") or "ln" in n for n in parts)


def test_compile_rules_skips_a_dim_tp_does_not_divide_and_hand_specs():
    """An odd vocabulary (GPT-2's 50257) leaves the tables and the LM
    head whole; a hand dispatch wins over the rules, with a warning."""
    cfg = dict(GPT_CFG, vocab_size=97)
    ids = tht.Variable("input_ids", trainable=False)
    labels = tht.Variable("labels", trainable=False)
    _, loss = TM.GPTLMHeadModel(TM.GPTConfig(**cfg))(ids, labels)
    lm = tht.reduce_mean_op(loss, [0, 1])
    nodes = [lm, tht.optim.AdamOptimizer(1e-3).minimize(lm)]
    bindings, _ = tht.parallel.compile_rules(nodes, tp=2)
    names = {b.param.name for b in bindings}
    assert "gpt_wte" not in names and "gpt_lm_head_weights" not in names
    assert "gpt_wpe" in names
    x = tht.Variable("x", trainable=False)
    w = tht.Variable("w", value=np.ones((8, 4), "f"))
    out = tht.reduce_mean_op(tht.matmul_op(x, tht.dispatch(w, (2, 1))), [0])
    nodes = [out, tht.optim.SGDOptimizer(0.1).minimize(out)]
    bindings, conflicts = tht.parallel.compile_rules(nodes, tp=2)
    assert conflicts and conflicts[0][0] is w and not bindings
    assert tht.parallel.compile_rules(nodes, tp=1) == ([], [])


def test_apply_rules_gather_dispatch_pads_short_statuses():
    """Without shapes apply_rules builds (1, 1) gathers, as the JAX
    package does: on a 3-D lookup output that status is replicated."""
    nodes = _gpt_nodes(tht, TM)
    bindings, _ = tht.parallel.compile_rules(nodes, tp=2)
    spliced = tht.parallel.apply_rules(nodes, bindings)
    gathers = [d for d in spliced if all(p == 1 for p in d.parts)]
    assert gathers and all(d.parts == (1, 1) for d in gathers)
    assert tht.parallel.apply_rules(nodes, []) == []


# --- refusals that stay -----------------------------------------------------

def test_refusals_name_their_roadmap_sub_items():
    nodes = _mlp(tht, ((1, 1), (1, 2)))
    # parallel= / rules= / autoplan_options= are ported (the planner,
    # tests/test_torch_autoplan.py); an unknown parallel= still raises
    with pytest.raises(ValueError, match="unknown parallel"):
        tht.HetuConfig(nodes, device="cpu", parallel="manual")
    with pytest.raises(TypeError, match=r"ROADMAP item 11b\.2"):
        tht.HetuConfig(nodes, device="cpu", gpipe=True,
                       pipeline_mode="collective")
    # a pipeline plans each stage (tests/test_torch_pp_tp.py): no session
    # mesh, no refusal
    config = tht.HetuConfig(nodes, device="cpu", gpipe=True)
    assert config.mesh is None and config.tp_layouts is None
    mesh = tmesh.Mesh({"dp": 1}, 0, {"dp": None})
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 11b\.4"):
        tht.HetuConfig(_mlp(tht, ((1, 1), (1, 1))), device="cpu",
                       gpipe=True, mesh=mesh)
    with pytest.raises(NotImplementedError, match=r"item 11b\.5"):
        tht.HetuConfig(nodes, device="cpu", comm_mode="PS")
    # a 2-way plan over two workers of one process's context: thread
    # ranks, dp=2 x tp=2 (tests/test_torch_local_ranks.py)
    plan = tht.HetuConfig(nodes, ctx=[tht.gpu(0), tht.gpu(1)],
                          device="cpu").local_ranks
    assert (plan.kind, plan.n, plan.axes) == ("tp", 4,
                                              {"dp": 2, "tp0": 2})
    # a pipeline stage over two devices of one process: a thread rank a
    # device, the head's device the third
    with tht.context((tht.cpu(0), tht.cpu(1))):
        a = tht.Variable("t_x", trainable=False)
        w = tht.Variable("t_w", value=np.ones((4, 4), "f"))
        h = tht.matmul_op(a, tht.dispatch(w, (1, 2)))
    with tht.context(tht.cpu(2)):
        loss = tht.reduce_mean_op(h, [0, 1])
        train = tht.optim.SGDOptimizer(0.1).minimize(loss)
    exe = tht.Executor([loss, train], gpipe=True)
    assert exe.config.local_ranks.kind == "pipeline"
    assert [[st.ranks for st in r.subexecutors["default"].stages]
            for r in exe.ranks] == [[[0, 1], [2]]] * 3
    (got, _) = exe.run(feed_dict={a: np.ones((4, 4), "f")},
                       convert_to_numpy_ret_vals=True)
    assert float(got) == 4.0
    exe.close()


def test_a_plan_needs_its_ranks():
    """One process holds a 2-way split as two thread ranks (the plan's
    mesh over them); a mesh given must carry the plan's model axes."""
    plan = tht.HetuConfig(_mlp(tht, ((1, 1), (1, 2))),
                          device="cpu").local_ranks
    assert (plan.kind, plan.n, plan.axes) == ("tp", 2, {"tp0": 2})
    mesh = tmesh.Mesh({"tp": 2}, 0, {"tp": None})
    with pytest.raises(ValueError, match="model axes"):
        tht.HetuConfig(_mlp(tht, ((1, 1), (1, 2))), device="cpu",
                       mesh=mesh)


def test_degenerate_dispatches_change_nothing():
    """Only (1, 1) dispatches: nothing is split, no mesh is needed, and
    the dispatch is the identity, as in the JAX package."""
    nodes = _mlp(tht, ((1, 1), (1, 1)))
    exe = tht.Executor(nodes, ctx=tht.cpu(0))
    assert exe.config.tp_layouts is None and exe.config.mesh is None
    assert exe.subexecutors["default"].tp is None
    x, y_ = [n for n in ttopo(nodes) if n.name in ("x", "y_")]
    rng = np.random.RandomState(0)
    out = exe.run(feed_dict={x: rng.randn(4, 32).astype("f"),
                             y_: np.eye(10, dtype="f")[[1, 2, 3, 4]]})
    assert np.isfinite(out[0].asnumpy()).all()


def test_device_group_helpers_match_the_reference():
    """``servers``, ``flat_workers``, ``index`` and ``get_sorted`` of
    the port's DeviceGroup against the JAX package's."""
    spec = ["gpu:1", "cpu:0", "gpu:0"]
    j, t = jht.DeviceGroup(spec), tht.DeviceGroup(spec)
    assert [str(c) for c in t.servers] == [str(c) for c in j.servers]
    # the JAX package names a GPU context tpu: compare the device ids
    assert [c.device_id for c in t.get_sorted()] == \
        [c.device_id for c in j.get_sorted()]
    assert t.index(t[2]) == j.index(j[2]) == 2
    tup = (tht.gpu(0), tht.gpu(1))
    assert tht.DeviceGroup([tup, tht.gpu(2)]).flat_workers() == \
        [tht.gpu(0), tht.gpu(1), tht.gpu(2)]
