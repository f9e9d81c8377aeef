"""The pipeline on the card: GPT stages on ``gpu(0)``…``gpu(3)`` wrap
onto one card and launch the hand-written K2–K4 from inside each stage.
Marked ``cuda``: it skips without a GPU. Imports neither JAX nor
``hetu_tpu``, so it runs on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_pipeline_cuda.py
"""
import numpy as np
import pytest
import torch

import hetu_tpu_torch as ht
import hetu_tpu_torch.models as M
from hetu_tpu_torch.ops import _build

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("schedule", ["gpipe", "pipedream"])
def test_stages_wrap_onto_the_card_and_launch_the_kernels(cuda, schedule):
    """Four stages of a 4-layer GPT at S=512 and head dim 64 (the fused
    attention path, on the tensor cores) on one card, M=2: every stage
    and parameter on cuda:0, K2, K3 and K4 launched 4 layers × 2
    microbatches times, all on the tc route, and the step's loss within
    one bf16 ulp of the single-device executor's."""
    cfg = M.GPTConfig(vocab_size=97, hidden_size=128, num_hidden_layers=4,
                      num_attention_heads=2, max_position_embeddings=512,
                      hidden_dropout_prob=0.0, use_flash_attention=True)
    x = np.random.RandomState(0).randint(0, 97, (4, 512))
    y = np.concatenate([x[:, 1:], np.full((4, 1), -1)], axis=1)
    ids, labels, loss, _, train = M.staged_gpt(cfg, [ht.gpu(0)], 1e-3)
    single = ht.Executor([loss, train], dtype=torch.bfloat16)
    want = float(single.run(feed_dict={ids: x, labels: y})[0].asnumpy())
    ids, labels, loss, _, train = M.staged_gpt(
        cfg, [ht.gpu(i) for i in range(4)], 1e-3)
    exe = ht.Executor([loss, train], num_microbatches=2,
                      dtype=torch.bfloat16, **{schedule: True})
    sub = exe.subexecutors["default"]
    assert {st.device for st in sub.stages} == {cuda}
    assert {v.device for v in exe.params.values()} == {cuda}
    _build.reset_launch_counts()
    got = float(exe.run(feed_dict={ids: x, labels: y})[0].asnumpy())
    for key in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"):
        assert _build.launch_counts[key] == 4 * 2, key
        assert _build.launch_counts[f"{key}.tc"] == 4 * 2, key
    assert _build.launch_counts["flash_fwd"] == 0
    bf16_ulp = 2.0 ** (int(np.floor(np.log2(abs(want)))) - 7)
    assert abs(got - want) <= bf16_ulp
