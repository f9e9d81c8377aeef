"""The cost-model planner over a CostDB measured on the card
(``cuda``-marked; skips without a GPU): one step of a small GPT profiled
op by op (``profile_op_records``, attention's eval forward on K1, its
launches counted, the plain attention never called), then ``choose_plan`` over the same graph reads a
measured cost for every op."""
import numpy as np
import pytest

WIDTHS = dict(vocab_size=512, hidden_size=256, num_hidden_layers=2,
              num_attention_heads=4, max_position_embeddings=128)


def _gpt(ht, M):
    cfg = M.GPTConfig(**WIDTHS, hidden_dropout_prob=0.0,
                      use_flash_attention=True)
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _, loss = M.GPTLMHeadModel(cfg)(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    return ids, labels, [lm, ht.optim.AdamOptimizer(1e-3).minimize(lm)]


@pytest.mark.cuda
def test_choose_plan_reads_a_profile_measured_on_the_card(tmp_path,
                                                          monkeypatch):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import hetu_tpu_torch as ht
    import hetu_tpu_torch.models as M
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import attention as attn
    from hetu_tpu_torch.ops import flash_attention as fa
    from hetu_tpu_torch.parallel import autoplan
    from hetu_tpu_torch.profiler import profile_op_records
    from hetu_tpu_torch.telemetry.costdb import CostDB

    rng = np.random.RandomState(0)
    x = rng.randint(0, WIDTHS["vocab_size"], (2, 128))
    y = np.concatenate([x[:, 1:], np.full((2, 1), -1)], axis=1)
    ids, labels, nodes = _gpt(ht, M)
    exe = ht.Executor(nodes)
    db = CostDB(str(tmp_path / "costdb.json"))
    plain = []
    reference = attn.attention_reference
    monkeypatch.setattr(attn, "attention_reference",
                        lambda *a: plain.append(1) or reference(*a))
    _build.reset_launch_counts()
    records = profile_op_records(exe, {ids: x, labels: y}, costdb=db)
    launches = dict(_build.launch_counts)
    assert launches.get(fa.K1, 0) == WIDTHS["num_hidden_layers"]
    assert launches.get(fa.K2, 0) == 0
    assert not plain
    assert all(r["ms"] > 0 for r in records)
    assert all(k.startswith("cuda-") for k in db.entries())

    ids, labels, nodes = _gpt(ht, M)
    res = autoplan.choose_plan(
        nodes, nworld=2, db=CostDB(db.path), device="cuda",
        feed_shapes={ids: ((2, 128), np.int64), labels: ((2, 128),
                                                           np.int64)})
    assert set(res.info["sources"].values()) == {"measured"}
    assert any(str(k).startswith("op-compute:") for k in res.coverage[0])
    # the same DB read as the CPU's holds nothing: platforms never mix
    from hetu_tpu_torch.tune import platform_scope
    with platform_scope("cpu"):
        cpu = autoplan.graph_costs(
            nodes, db=CostDB(db.path),
            feed_shapes={ids: ((2, 128), np.int64),
                         labels: ((2, 128), np.int64)})
    assert "measured" not in set(cpu["sources"].values())
