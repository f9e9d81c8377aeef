"""The device-cache PS path on the card against the CPU: a small WDL
(10,000 x 128 table, B=32) in ``chip_smoke.py``'s ``ps_wdl``
configuration — comm_mode="PS", the device cache with bf16 drains, the
dense weights on the unified HET path — trained 30 steps in blocks of
10 (``cache_bound`` 10, so drains run) on the card and on the CPU, each
with its own server, from one graph numbered alike (the servers draw
the same table). Losses within 1e-5 relative; after drain() every
touched server row within 1e-4 of the largest. Marked ``cuda``: it
skips without a GPU. Imports neither JAX nor hetu_tpu:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_ps_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import hetu_tpu_torch as ht

pytestmark = pytest.mark.cuda

ROWS, BATCH, BLOCK, BLOCKS = 10_000, 32, 10, 3


def _run(device, feeds):
    with cs.ps_server() as (client, _):
        with cs.ps_node_ids(cs.PS_ID_BASE):
            nodes = [ht.Variable(n, trainable=False)
                     for n in ("dense_input", "sparse_input", "y_")]
            loss, _, _, train_op = ht.models.wdl_criteo(
                *nodes, feature_dimension=ROWS)
            exe = ht.Executor([loss, train_op], comm_mode="PS",
                              cstable_policy="Device", cache_bound=BLOCK,
                              drain_compress=True, device=device)
        losses = []
        for b in range(BLOCKS):
            outs = exe.run_batches([dict(zip(nodes, f))
                                    for f in feeds[b * BLOCK:(b + 1) * BLOCK]])
            losses += [float(o[0].asnumpy().reshape(-1)[0]) for o in outs]
        rt = exe.ps_runtime
        rt.drain()
        dt = next(iter(rt.device_tables.values()))
        ids = np.sort(dt.id_of[dt.id_of >= 0])
        rows = client.sparse_pull(dt.tid, ids, dt.width)
        assert dt.pushed_rows > 0 and len(exe.config.ps_dense_cached)
        exe.close()
    return np.array(losses), ids, rows


def test_ps_wdl_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(0)
    feeds = [(rng.randn(BATCH, 13).astype("f"),
              ((rng.zipf(1.3, (BATCH, 26)) - 1) % ROWS).astype(np.int32),
              rng.randint(0, 2, (BATCH, 1)).astype("f"))
             for _ in range(BLOCK * BLOCKS)]
    card, card_ids, card_rows = _run("cuda", feeds)
    cpu, cpu_ids, cpu_rows = _run("cpu", feeds)
    np.testing.assert_allclose(card, cpu, rtol=1e-5)
    np.testing.assert_array_equal(card_ids, cpu_ids)
    scale = np.abs(cpu_rows).max()
    np.testing.assert_allclose(card_rows, cpu_rows, rtol=0,
                               atol=1e-4 * scale)
