"""The port's shape/dtype pass (``hetu_tpu_torch/analysis/shapes.py``)
and findings against the JAX package's: ``shape_pass``'s shapes and
dtypes node by node, matched by place, on every zoo model both packages
build (the same builders, ``analysis/zoo.py``) and on a GPT whose
parameters are declared bf16; the HT1xx findings; and the findings
collector.
"""
import numpy as np
import pytest
import torch

from hetu_tpu.analysis import findings as jfind
from hetu_tpu.analysis import shapes as jshapes
from hetu_tpu.analysis import zoo as jzoo
from hetu_tpu.graph.autodiff import find_topo_sort as jtopo
from hetu_tpu_torch.analysis import findings as tfind
from hetu_tpu_torch.analysis import shapes as tshapes
from hetu_tpu_torch.analysis import zoo as tzoo
from hetu_tpu_torch.graph.autodiff import find_topo_sort as ttopo


def _jname(dt):
    return None if dt is None else np.dtype(dt).name


def _pass(topo, shapes, find, nodes, feeds, name_of):
    """{(topo position, op type): (shape, dtype name)} and the finding
    codes. Nodes match by place, not name: a name carries its package's
    node counter, which other graphs built in the process have moved."""
    dtypes = {}
    report = find.Report()
    order = topo(nodes)
    got = shapes.shape_pass(order, report, feed_shapes=feeds,
                            dtypes_out=dtypes)
    return ({(i, n.op_type): (got.get(n), name_of(dtypes.get(n)))
             for i, n in enumerate(order)},
            sorted(f.code for f in report.findings))


def _both(jnodes, jfeeds, tnodes, tfeeds):
    j = _pass(jtopo, jshapes, jfind, jnodes, jfeeds, _jname)
    t = _pass(ttopo, tshapes, tfind, tnodes, tfeeds, tshapes.dtype_name)
    return j, t


def test_the_zoos_are_the_same_models():
    assert sorted(tzoo.ZOO) == sorted(jzoo.ZOO)


@pytest.mark.parametrize("model", sorted(jzoo.ZOO))
def test_shape_pass_matches_the_reference_node_by_node(model):
    (jmap, jcodes), (tmap, tcodes) = _both(*jzoo.build(model),
                                           *tzoo.build(model))
    assert set(tmap) == set(jmap)
    assert tmap == jmap
    assert tcodes == jcodes
    # fully shaped: every forward value has a shape
    assert sum(s is not None for s, _ in tmap.values()) > len(tmap) // 2


def _bf16(nodes, topo, dtype):
    """Declare every float parameter ``dtype`` (what a bf16 session's
    casts make of them)."""
    from hetu_tpu.ops.variable import PlaceholderOp as JP
    from hetu_tpu_torch.ops.variable import PlaceholderOp as TP
    for n in topo(nodes):
        if isinstance(n, (JP, TP)) and n.trainable:
            n.dtype = dtype


def test_shape_pass_on_a_bf16_gpt():
    import jax.numpy as jnp
    jnodes, jfeeds = jzoo.build("gpt_tiny")
    tnodes, tfeeds = tzoo.build("gpt_tiny")
    _bf16(jnodes, jtopo, jnp.bfloat16)
    _bf16(tnodes, ttopo, torch.bfloat16)
    (jmap, jcodes), (tmap, tcodes) = _both(jnodes, jfeeds, tnodes, tfeeds)
    assert tmap == jmap
    kinds = {d for _, d in tmap.values()}
    assert {"bfloat16", "float32", "int32", "int64"} <= kinds
    # the findings differ by HT102 alone: numpy's kind of the reference's
    # bf16 (ml_dtypes) is 'V', so the reference flags bf16 beside f32 as
    # a mix of kinds; the port's bf16 is a float (ROADMAP §3)
    assert tcodes == [c for c in jcodes if c != "HT102"]
    assert "HT102" in jcodes and "HT102" not in tcodes
    report = jfind.Report()
    jshapes.shape_pass(jtopo(jnodes), report, feed_shapes=jfeeds)
    for f in report.findings:
        if f.code == "HT102":
            assert "bfloat16" in f.message and "int" not in f.message


@pytest.mark.parametrize("a,b", [
    ("bfloat16", "float32"), ("bfloat16", "int32"), ("float16", "bfloat16"),
    ("int32", "float32"), ("int64", "float32"), ("int32", "int64"),
    ("uint8", "int8"), ("bool", "int32"), ("float16", "float32")])
def test_promotion_is_the_reference_lattice(a, b):
    import jax.numpy as jnp
    want = np.dtype(jnp.promote_types(jnp.dtype(a), jnp.dtype(b))).name
    got = tshapes.dtype_name(tshapes._result_dtype(
        type("N", (), {"op_type": "AddOp", "dtype": None})(),
        [tshapes.as_dtype(a), tshapes.as_dtype(b)]))
    assert got == want


def test_mismatched_operands_are_ht101_with_the_same_message_shape():
    import hetu_tpu as jht
    import hetu_tpu_torch as tht
    got = {}
    for name, ht, topo, shapes, find in (
            ("jax", jht, jtopo, jshapes, jfind),
            ("port", tht, ttopo, tshapes, tfind)):
        a = ht.Variable("sa", value=np.ones((4, 3), "f"))
        b = ht.Variable("sb", value=np.ones((5, 2), "f"))
        y = ht.matmul_op(a, b)
        report = find.Report()
        out = shapes.shape_pass(topo([y]), report)
        got[name] = ([f.code for f in report.findings], out[y],
                     report.errors[0].node == y.name)
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["HT101"]


def test_lint_pass_finds_duplicates_and_frozen_variables():
    import hetu_tpu as jht
    import hetu_tpu_torch as tht
    got = {}
    for name, ht, topo, shapes, find in (
            ("jax", jht, jtopo, jshapes, jfind),
            ("port", tht, ttopo, tshapes, tfind)):
        x = ht.Variable("lx", trainable=False)
        w1 = ht.Variable("lw", value=np.ones((4, 4), "f"))
        w2 = ht.Variable("lw", value=np.ones((4, 4), "f"))
        frozen = ht.Variable("lf", value=np.ones((4, 4), "f"))
        y = ht.matmul_op(ht.matmul_op(ht.matmul_op(x, w1), w2), frozen)
        loss = ht.reduce_mean_op(y, [0, 1])
        train = ht.optim.SGDOptimizer(0.1).minimize(loss,
                                                     var_list=[w1, w2])
        report = find.Report()
        shapes.lint_pass(topo([loss, train]), report)
        shapes.frozen_graph_pass(topo([loss, train]), report)
        got[name] = sorted(f.code for f in report.findings)
    assert got["port"] == got["jax"]
    assert {"HT111", "HT112", "HT150"} <= set(got["port"])


def test_findings_collector_and_report():
    for find in (jfind, tfind):
        report = find.Report()
        assert find.emit("HT205", "warn", "x") is False
        with find.collecting(report):
            assert find.emit("HT205", "warn", "conflict", node="w")
        assert [str(f) for f in report.findings] == \
            ["[HT205] warn: conflict  (w)"]
        assert report.ok and len(report.warnings) == 1
        assert find.suppressed(["y = f()  # ht-ok: HT205 why"], 1, "HT205")
    assert tfind.Report([tfind.Finding("HT1", "error", "m")]).to_text() \
        == jfind.Report([jfind.Finding("HT1", "error", "m")]).to_text()
