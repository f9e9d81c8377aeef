"""Thread ranks and DistGCN on the card (``cuda``-marked; skips without a
GPU): ``dist_gcn_spmm`` and its transpose on two thread ranks of a local
job on cuda:0 against ``csrmm_op``'s product, and a data-parallel GPT at
S=512 in bf16 under a context of two devices, whose two thread ranks
launch K2-K4 at once, each counted under its own rank."""
import threading

import numpy as np
import pytest


def _graph(n=301, deg=5, seed=0):
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.randint(0, n, n * deg)
    adj = sp.coo_matrix((np.ones(n * deg, np.float32), (rows, cols)),
                        shape=(n, n)).tocsr()
    adj = adj + sp.eye(n, format="csr", dtype=np.float32)
    dinv = sp.diags(1.0 / np.sqrt(np.asarray(adj.sum(1)).ravel()))
    return (dinv @ adj @ dinv).tocsr()


@pytest.mark.cuda
def test_dist_gcn_spmm_on_two_thread_ranks_matches_csrmm():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ndarray import CSRValue
    from hetu_tpu_torch.ops.sparse import _csr_product
    from hetu_tpu_torch.parallel import mesh as tmesh
    from hetu_tpu_torch.parallel.distgcn import (dist_gcn_spmm,
                                                 dist_gcn_spmm_t,
                                                 partition_csr_15d)
    adj = _graph()
    h = torch.from_numpy(np.random.RandomState(1).randn(301, 128)
                         .astype(np.float32)).cuda()
    csr = CSRValue.from_sparse_array(ht.ND_Sparse_Array(
        adj.data.astype(np.float32), adj.indptr.astype(np.int32),
        adj.indices.astype(np.int32), nrow=301, ncol=301), "cuda")
    want = _csr_product(csr, h, False)
    want_t = _csr_product(csr, h, True)
    part = partition_csr_15d(adj, 2, 1)
    local = tmesh.build_mesh({"gr": 2, "gc": 1})
    job = tmesh.LocalJob(2)
    out = [None, None]

    def go(r):
        m = local.rank_mesh(job.job(r))
        out[r] = (dist_gcn_spmm(part, h, m), dist_gcn_spmm_t(part, h, m))

    threads = [threading.Thread(target=go, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    for z, zt in out:
        assert z.is_cuda
        assert float((z - want).abs().max() / want.abs().max()) < 1e-5
        assert float((zt - want_t).abs().max() / want_t.abs().max()) < 1e-5


@pytest.mark.cuda
def test_two_thread_ranks_launch_k2_k4_counted_by_rank():
    """A tuple context of two devices under AllReduce: two thread ranks on
    cuda:0, one row each, each launching K2, K3 and K4 once a layer, all
    on tc, counted apart; the step's loss within 1e-2 of one process's."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import hetu_tpu_torch as ht
    import hetu_tpu_torch.models as M
    from hetu_tpu_torch.ops import _build

    cfg = dict(vocab_size=98, hidden_size=128, num_hidden_layers=2,
               num_attention_heads=2, max_position_embeddings=512,
               hidden_dropout_prob=0.0, use_flash_attention=True)
    x = np.random.RandomState(0).randint(0, 98, (2, 512))
    y = np.concatenate([x[:, 1:], np.full((2, 1), -1)], axis=1)

    def build():
        ids = ht.Variable("input_ids", trainable=False)
        labels = ht.Variable("labels", trainable=False)
        _, loss = M.GPTLMHeadModel(M.GPTConfig(**cfg))(ids, labels)
        lm = ht.reduce_mean_op(loss, [0, 1])
        return ids, labels, [lm, ht.optim.AdamOptimizer(1e-3).minimize(lm)]

    ids, labels, nodes = build()
    want = float(ht.Executor(nodes, dtype=torch.bfloat16).run(
        feed_dict={ids: x, labels: y})[0].asnumpy())
    with ht.context((ht.gpu(0), ht.gpu(1))):
        ids, labels, nodes = build()
        exe = ht.Executor(nodes, dtype=torch.bfloat16, comm_mode="AllReduce")
    assert [str(d) for d in exe.config.local_ranks.devices] == \
        ["cuda:0", "cuda:0"]
    _build.reset_launch_counts()
    got = float(exe.run(feed_dict={ids: x, labels: y})[0].asnumpy())
    exe.close()
    n = cfg["num_hidden_layers"]
    for key in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"):
        assert _build.launch_counts[key] == 2 * n, key
        for r in (0, 1):
            assert _build.rank_launch_counts[r][key] == n, (r, key)
            assert _build.rank_launch_counts[r][f"{key}.tc"] == n, (r, key)
    assert _build.launch_counts["flash_fwd"] == 0
    assert abs(got - want) <= 1e-2 * abs(want)
