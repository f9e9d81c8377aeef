"""The training health monitor on the card: ``chip_smoke.py``'s
``health_train`` checks at 2 layers of GPT-2-small's widths. An executor
with the monitor on (every_n=2) and one with it off run interleaved; the
monitored losses must equal the others bit for bit (the sentinels only
read what the step computed), its records hold every parameter, each
grad norm and update ratio within 1e-5 of a plain f32 recomputation on
the card from the step's own gradients and weights, and K2-K4 launch on
``tc`` as without the monitor. Then a NaN in an f32 master trips the
next sample. Marked ``cuda``: it skips without a GPU. Imports neither
JAX nor ``hetu_tpu``, so it runs on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_health_cuda.py
"""
import numpy as np
import pytest
import torch

import hetu_tpu_torch as ht
import hetu_tpu_torch.models as M
from hetu_tpu_torch import telemetry
from hetu_tpu_torch.ndarray import IndexedSlices
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ops import flash_attention as fa
from hetu_tpu_torch.telemetry import health

pytestmark = pytest.mark.cuda

WIDTHS = dict(vocab_size=50257, hidden_size=768, num_hidden_layers=2,
              num_attention_heads=12, max_position_embeddings=1024,
              hidden_dropout_prob=0.0, use_flash_attention=True)
BATCH, STEPS, EVERY_N = 8, 4, 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda", 0)
    telemetry._default = None
    health._LAST = None


def _gpt():
    cfg = M.GPTConfig(**WIDTHS)
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _, loss = M.GPTLMHeadModel(cfg)(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    train = ht.optim.AdamOptimizer(learning_rate=1e-4).minimize(lm)
    rng = np.random.RandomState(0)
    seq = cfg.max_position_embeddings
    x = rng.randint(0, cfg.vocab_size, (BATCH, seq))
    y = np.concatenate([x[:, 1:], np.full((BATCH, 1), -1)], axis=1)
    return lm, train, {ids: x, labels: y}


def _keep_inputs(train):
    """References to each parameter's gradient and f32 master before and
    after the update, on the steps the monitor samples."""
    kept, compute = [], type(train).compute

    def keep(input_vals, ectx):
        if ectx.health_sentinels is None:
            return compute(train, input_vals, ectx)
        masters = ectx.master_params or ectx.params
        before = {p: masters[p] for p in train.optimizer.params}
        out = compute(train, input_vals, ectx)
        kept.append({p.name: (g, before[p], ectx.new_params[p])
                     for p, g in zip(train.optimizer.params, input_vals)
                     if g is not None})
        return out

    train.compute = keep
    return kept


def test_sentinels_on_the_card_match_a_plain_recomputation(cuda, tmp_path):
    lm, train, feeds = _gpt()
    plain = ht.Executor([lm, train], dtype=torch.bfloat16)
    monitored = ht.Executor([lm, train], dtype=torch.bfloat16,
                            health_options={"every_n": EVERY_N,
                                            "out_dir": str(tmp_path)})
    kept = _keep_inputs(train)
    got, want, launches = [], [], {}
    for _ in range(STEPS):
        want.append(float(plain.run(feed_dict=feeds)[0].asnumpy()))
        before = dict(_build.launch_counts)
        got.append(float(monitored.run(feed_dict=feeds)[0].asnumpy()))
        for k, v in _build.launch_counts.items():
            launches[k] = launches.get(k, 0) + v - before.get(k, 0)
    del train.compute
    assert got == want and np.all(np.isfinite(got))
    n = WIDTHS["num_hidden_layers"] * STEPS
    for k in (fa.K2, fa.K3, fa.K4):
        assert launches[k] == launches[f"{k}.tc"] == n, launches
    hm = monitored.config.health_monitor
    assert [r["step"] for r in hm.records] == [2, 4] and len(kept) == 2
    names = {p.name for p in train.optimizer.params}
    for rec, step in zip(hm.records, kept):
        assert set(rec["layers"]) == names == set(step)
        assert rec["loss_finite"] and not rec["trips"]
        for name, (g, old, new) in step.items():
            g = (g.values if isinstance(g, IndexedSlices) else g).float()
            m = rec["layers"][name]
            assert m["nonfinite"] == 0
            assert m["grad_norm"] == pytest.approx(
                float(torch.linalg.vector_norm(g)), rel=1e-5)
            ratio = torch.linalg.vector_norm(new.float() - old.float()) / (
                torch.linalg.vector_norm(old.float()) + 1e-12)
            assert m["update_ratio"] == pytest.approx(float(ratio),
                                                      rel=1e-5)
    monitored.close()

    # a NaN in an f32 master before step 3 trips the sample at step 4
    trip = ht.Executor([lm, train], dtype=torch.bfloat16,
                       health_options={"every_n": EVERY_N, "action": "dump",
                                       "out_dir": str(tmp_path / "trip")})
    sid = next(sid for sid, node in trip._param_nodes.items()
               if node.name == "gpt_h0_attn_qkv_weights")
    for step in range(1, 5):
        if step == 3:
            trip.params[sid].view(-1)[0] = float("nan")
        trip.run(feed_dict=feeds)
    recs = trip.config.health_monitor.records
    assert [r["step"] for r in recs] == [2, 4]
    assert not recs[0]["trips"] and not recs[1]["loss_finite"]
    assert {t["kind"] for t in recs[1]["trips"]} == {"nonfinite"}
    trip.close()
    rep = health.diagnose(str(tmp_path / "trip"))
    assert rep["first_bad_step"] == 4
