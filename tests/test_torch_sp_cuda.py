"""Sequence parallelism on the card (``cuda``-marked; skips without a
GPU): two sp ranks (threads of one process, gloo groups of their own,
tests/torch_tp_util.py) on cuda:0 train a GPT at S=512 in bf16 under the
zigzag ring and under Ulysses, every block on the hand-written K2-K4 of
the tc route, the ring's hops staged through pinned host memory (gloo's
send and receive read host memory; its all-to-all takes CUDA tensors)."""
import numpy as np
import pytest

CFG = dict(vocab_size=98, hidden_size=128, num_hidden_layers=2,
           num_attention_heads=2, max_position_embeddings=512,
           hidden_dropout_prob=0.0, use_flash_attention=True)
# K2 launches a layer a rank: the ring's diagonal (S=256, causal) and a
# hop's two S=128 squares; Ulysses' one attention of the rank's head
BLOCKS = {"ring": 3, "ulysses": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_two_sp_ranks_on_the_card_launch_the_kernels(kind):
    """Each rank launches K2, K3 and K4 BLOCKS[kind] times a layer, all
    on tc, K1 never, no composed block; its hops are staged, its
    all-to-alls not; the step's loss is within two bf16 ulps of one
    process's on the fused path."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import hetu_tpu_torch as ht
    import hetu_tpu_torch.models as M
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.parallel import ring
    from torch_tp_util import ranks, same_ids

    x = np.random.RandomState(0).randint(0, 98, (2, 512))
    y = np.concatenate([x[:, 1:], np.full((2, 1), -1)], axis=1)

    def build(sp):
        ids = ht.Variable("input_ids", trainable=False)
        labels = ht.Variable("labels", trainable=False)
        cfg = M.GPTConfig(**CFG, sequence_parallel=sp)
        _, loss = M.GPTLMHeadModel(cfg)(ids, labels)
        lm = ht.reduce_mean_op(loss, [0, 1])
        return ids, labels, [lm, ht.optim.AdamOptimizer(1e-3).minimize(lm)]

    ids, labels, nodes = same_ids(build, None)
    want = float(ht.Executor(nodes, dtype=torch.bfloat16).run(
        feed_dict={ids: x, labels: y})[0].asnumpy())

    def run(r, mesh, built):
        ids, labels, nodes = built
        exe = ht.Executor(nodes, dtype=torch.bfloat16, mesh=mesh)
        loss = float(exe.run(feed_dict={ids: x, labels: y})[0].asnumpy())
        return loss, mesh.comm("sp").stats

    _build.reset_launch_counts()
    ring.reset_composed_blocks()
    got = ranks({"sp": 2}, run, lambda r: build(kind))
    n = 2 * CFG["num_hidden_layers"] * BLOCKS[kind]
    for key in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"):
        assert _build.launch_counts[key] == n, key
        assert _build.launch_counts[f"{key}.tc"] == n, key
    assert _build.launch_counts["flash_fwd"] == 0
    assert not ring.composed_blocks
    ulp = 2.0 ** (int(np.floor(np.log2(abs(want)))) - 7)
    for loss, stats in got:
        assert abs(loss - want) <= 2 * ulp
        moved = stats["ring" if kind == "ring" else "all_to_all"]
        assert moved["calls"] > 0
        assert stats["staged"]["calls"] == stats["ring"]["calls"]
