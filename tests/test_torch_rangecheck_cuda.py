"""The range capture on the card (``analysis/rangecheck.py``). The same
f32 MLP step, recorded on the card and on the CPU, measures the same
(lo, hi) per stable key within 1e-5 relative; ``torch.aminmax`` and the
device fold keep a NaN as NaN on the card as on the CPU; and a bf16
two-layer GPT at GPT-2-small's widths, recorded on the card through
K2-K4, escapes no static interval (no HT810) with every
``FlashAttentionOp`` checked. Marked ``cuda``: it skips without a GPU.
Imports neither JAX nor ``hetu_tpu``, so it runs on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_rangecheck_cuda.py
"""
import math

import numpy as np
import pytest
import torch

import hetu_tpu_torch as ht
import hetu_tpu_torch.models as M
from hetu_tpu_torch.analysis import Report, numerics, rangecheck
from hetu_tpu_torch.analysis.shapes import shape_pass

pytestmark = pytest.mark.cuda

WIDTHS = dict(vocab_size=50257, hidden_size=768, num_hidden_layers=2,
              num_attention_heads=12, max_position_embeddings=1024,
              hidden_dropout_prob=0.0, use_flash_attention=True)
BATCH = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda", 0)


def _mlp(device):
    x = ht.Variable("xrcc", trainable=False)
    y_ = ht.Variable("yrcc", trainable=False)
    w1 = ht.init.xavier_normal((16, 32), name="w1rcc")
    w2 = ht.init.xavier_normal((32, 4), name="w2rcc")
    h = ht.relu_op(ht.matmul_op(x, w1))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(h, w2), y_), [0])
    train = ht.optim.SGDOptimizer(0.1).minimize(loss)
    return ht.Executor([loss, train], device=device), x, y_


def test_card_ranges_equal_the_cpu_ranges(cuda):
    rng = np.random.RandomState(0)
    feeds = [(rng.randn(8, 16).astype("f"),
              np.eye(4, dtype="f")[rng.randint(0, 4, 8)]) for _ in range(2)]
    got = {}
    for device in ("cpu", "cuda"):
        exe, x, y_ = _mlp(device)
        rec = rangecheck.RangeRecorder(exe).attach()
        for xs, ys in feeds:
            exe.run(feed_dict={x: xs, y_: ys})
            rec.sample()
        rec.detach()
        assert rec.fetches == 2
        got[device] = rec.by_stable_key()
    assert got["cuda"].keys() == got["cpu"].keys() and got["cuda"]
    for k, (lo, hi) in got["cuda"].items():
        clo, chi = got["cpu"][k]
        for a, b in ((lo, clo), (hi, chi)):
            assert abs(a - b) <= 1e-5 * max(abs(a), abs(b)) + 1e-7, \
                (k, got["cuda"][k], got["cpu"][k])


def test_nan_reaches_the_host_as_nan(cuda):
    cap = rangecheck.RangeCapture()
    for dtype in (torch.float32, torch.bfloat16):
        cap.observe(0, torch.tensor([1.0, math.nan, -2.0], dtype=dtype,
                                    device=cuda))
        cap.end_step()
    cap.observe(1, torch.tensor([3.0], device=cuda))
    cap.end_step()
    cap.observe(1, torch.tensor([math.nan], device=cuda))
    cap.end_step()
    got = cap.take()
    assert [i for i, _, _ in got] == [0, 1]
    assert all(math.isnan(lo) and math.isnan(hi) for _, lo, hi in got)


def test_bf16_gpt_on_the_card_is_sound(cuda):
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import flash_attention as fa
    cfg = M.GPTConfig(**WIDTHS)
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _, loss = M.GPTLMHeadModel(cfg)(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    train = ht.optim.AdamOptimizer(learning_rate=1e-4).minimize(lm)
    rng = np.random.RandomState(0)
    seq = WIDTHS["max_position_embeddings"]
    x = rng.randint(0, WIDTHS["vocab_size"], (BATCH, seq))
    y = np.concatenate([x[:, 1:], np.full((BATCH, 1), -1)], axis=1)
    feeds = {ids: torch.as_tensor(x, device=cuda),
             labels: torch.as_tensor(y, device=cuda)}
    plain = ht.Executor([lm, train], dtype=torch.bfloat16, device=cuda)
    want = [float(plain.run(feed_dict=feeds)[0].asnumpy())
            for _ in range(2)]
    del plain
    _build.reset_launch_counts()
    exe = ht.Executor([lm, train], dtype=torch.bfloat16, device=cuda)
    rec = rangecheck.RangeRecorder(exe).attach()
    got = []
    for _ in range(2):
        got.append(float(exe.run(feed_dict=feeds)[0].asnumpy()))
        rec.sample()
    launches = dict(_build.launch_counts)
    assert got == want
    for k in (fa.K2, fa.K3, fa.K4):
        assert launches.get(f"{k}.tc", 0) == 2 * WIDTHS["num_hidden_layers"]
    topo = exe.subexecutors["default"].topo_order
    dtypes = {}
    shapes = shape_pass(topo, Report(), feed_shapes={
        ids: ((BATCH, seq), np.int64), labels: ((BATCH, seq), np.int64)},
        dtypes_out=dtypes)
    static = numerics.numerics_pass(topo, Report(), shapes=shapes,
                                    dtypes=dtypes, config=exe.config)
    measured = rec.by_stable_key()
    report, checked = rangecheck.soundness_pass(topo, static, measured)
    assert not report.errors, [str(f) for f in report.errors]
    keys = numerics.stable_keys(topo)
    flash = [k for k, n in zip(keys, topo)
             if n.op_type == "FlashAttentionOp"]
    assert len(flash) == WIDTHS["num_hidden_layers"]
    assert all(k in measured and static[topo[keys.index(k)]] is not None
               for k in flash)
    assert checked > len(flash)
