"""The collective pipeline on the card: two stages of GPT blocks on
``gpu(0)`` and ``gpu(1)`` (one card twice, or two cards) run the tick
loop on their own streams and launch the hand-written K2-K4 from it.
Marked ``cuda``: it skips without a GPU. Imports neither JAX nor
``hetu_tpu``, so it runs on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_collective_pp_cuda.py
"""
import numpy as np
import pytest
import torch

import hetu_tpu_torch as ht
import hetu_tpu_torch.models as M
from hetu_tpu_torch.ops import _build

pytestmark = pytest.mark.cuda

WIDTHS = dict(hidden_size=64, num_attention_heads=1, intermediate_size=256,
              max_position_embeddings=512, vocab_size=64,
              hidden_dropout_prob=0.0, use_flash_attention=True)
STAGES, PER_STAGE, MICROBATCHES, BATCH, STEPS = 2, 2, 4, 8, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _chain():
    """2 stages of 2 GPT blocks (64 wide, one head of 64: the tc route at
    S=512): x [B, 512, 64] in, the mean sparse softmax cross-entropy of
    the last stage's [B·S, 64] output out."""
    cfg = M.GPTConfig(num_hidden_layers=STAGES * PER_STAGE, **WIDTHS)
    seq, h = WIDTHS["max_position_embeddings"], WIDTHS["hidden_size"]
    blocks = [M.gpt.GPTBlock(cfg, name=f"cc{i}")
              for i in range(STAGES * PER_STAGE)]
    for s in range(STAGES):
        with ht.context(ht.gpu(s)):
            if s == 0:
                x = ht.Variable("x", trainable=False)
                act = x
            for block in blocks[s * PER_STAGE:(s + 1) * PER_STAGE]:
                act = block(act, seq)
    labels = ht.Variable("labels", trainable=False)
    with ht.context(ht.gpu(STAGES - 1)):
        loss = ht.reduce_mean_op(ht.softmaxcrossentropy_sparse_op(
            ht.array_reshape_op(act, [-1, h]), labels), [0])
        train = ht.optim.AdamOptimizer(learning_rate=1e-3).minimize(loss)
    return x, labels, loss, train


def test_tick_loop_launches_the_kernels_and_matches_staged(cuda):
    """bf16, M=4, 3 Adam steps: the collective run's losses within one
    bf16 ulp of ``gpipe=True``'s on the same graph and weights; K2, K3
    and K4 launched 4 blocks × M times a step from the tick loop, all on
    the tc route; every stage on its own stream of the card."""
    rng = np.random.RandomState(0)
    h, seq = WIDTHS["hidden_size"], WIDTHS["max_position_embeddings"]
    xv = torch.as_tensor(rng.randn(BATCH, seq, h).astype("f"), device=cuda)
    yv = torch.as_tensor(rng.randint(0, h, BATCH * seq), device=cuda)
    losses, launches = {}, {}
    for mode in ({"gpipe": True}, {"pipeline_mode": "collective"}):
        x, labels, loss, train = _chain()
        exe = ht.Executor([loss, train], num_microbatches=MICROBATCHES,
                          dtype=torch.bfloat16, **mode)
        _build.reset_launch_counts()
        key = "gpipe" if "gpipe" in mode else "collective"
        losses[key] = [float(exe.run(feed_dict={x: xv, labels: yv})[0]
                             .asnumpy()) for _ in range(STEPS)]
        launches[key] = dict(_build.launch_counts)
    sub = exe.subexecutors["default"]
    assert sub.schedule == "collective"
    assert {st.device for st in sub.stages} == {cuda}
    streams = sub._cpp.streams
    assert len({id(s) for s in streams}) == STAGES and None not in streams
    per_step = STAGES * PER_STAGE * MICROBATCHES
    for key in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"):
        assert launches["collective"][key] == per_step * STEPS, key
        assert launches["collective"][f"{key}.tc"] == per_step * STEPS, key
        assert launches["gpipe"][key] == per_step * STEPS, key
    assert launches["collective"].get("flash_fwd", 0) == 0
    assert all(np.isfinite(losses["collective"]))
    for got, want in zip(losses["collective"], losses["gpipe"]):
        ulp = 2.0 ** (int(np.floor(np.log2(abs(want)))) - 7)
        assert abs(got - want) <= ulp, (losses, ulp)
    assert losses["collective"][-1] < losses["collective"][0]
