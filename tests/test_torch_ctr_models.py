"""The CTR models of ``models/ctr.py`` trained in hetu_tpu and in the
port on the CPU from the same initial values (both packages draw them
from numpy, seeded by parameter name) and the same numpy batches, at
``tests/test_models.py``'s sizes (1000 rows, width 8, B=16): 4 SGD steps,
losses within 1e-5 relative, every parameter after the steps within 1e-5.

Also: SGD's sparse update writes into the table in place (the reference's
compiled step donates the table; copying it a step would move the whole
table through memory twice) and, with ids repeated within a batch,
leaves the table as hetu_tpu's does within 1e-6; ``run_batches`` gives
what the same number of ``run`` calls gives; ``ctr_main``'s metrics
loop runs on the CPU with ``--device cpu``, in PS mode too; and a table
placed on the host trains on the parameter server as hetu_tpu's does
(losses within 1e-5 relative, each package on its own server).
"""
import os

import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu.models as JM
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
from hetu_tpu_torch.examples import ctr_main

STEPS, B, ROWS, WIDTH = 4, 16, 1000, 8
CRITEO = ["wdl_criteo", "deepfm_criteo", "dcn_criteo", "dc_criteo"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """A step here is hundreds of small ops: one intra-op thread runs them
    fastest, and parallel test workers share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _criteo_feeds(seed=2, id_range=ROWS):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, 13).astype(np.float32),
             rng.randint(0, id_range, (B, 26)),
             rng.randint(0, 2, (B, 1)).astype(np.float32))
            for _ in range(STEPS)]


def _adult_feeds(seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, 6).astype(np.float32),
             rng.randint(0, 50000, (B, 8)),
             np.eye(2, dtype=np.float32)[rng.randint(0, 2, B)])
            for _ in range(STEPS)]


def _session(ht, models, name):
    dense = ht.Variable("dense", trainable=False)
    sparse = ht.Variable("sparse", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    kwargs = {} if name == "wdl_adult" else dict(
        feature_dimension=ROWS, embedding_size=WIDTH)
    loss, _, _, train_op = getattr(models, name)(dense, sparse, y_,
                                                 **kwargs)
    kw = {"ctx": tht.cpu(0)} if ht is tht else {}
    return ht.Executor([loss, train_op], **kw), (dense, sparse, y_)


def _train(ht, models, name, feeds):
    exe, nodes = _session(ht, models, name)
    losses = [float(np.asarray(
        exe.run(feed_dict=dict(zip(nodes, f)))[0].asnumpy()).reshape(-1)[0])
        for f in feeds]
    return exe, losses


def _params(exe):
    return {node.name: np.asarray(exe.params[sid])
            for sid, node in exe._param_nodes.items()}


@pytest.mark.parametrize("name", CRITEO + ["wdl_adult"])
def test_builder_trains_like_the_reference(name):
    feeds = _adult_feeds() if name == "wdl_adult" else _criteo_feeds()
    jexe, jl = _train(jht, JM, name, feeds)
    texe, tl = _train(tht, TM, name, feeds)
    assert np.all(np.isfinite(tl)), tl
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    jp, tp = _params(jexe), _params(texe)
    assert sorted(tp) == sorted(jp)
    for key in jp:
        np.testing.assert_allclose(tp[key], jp[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_sgd_updates_the_table_in_place_and_like_the_reference():
    """Ids drawn from 20 of the 1000 rows repeat within every batch: the
    in-place scatter-add sums them as the reference's does."""
    feeds = _criteo_feeds(seed=5, id_range=20)[:3]
    jexe, _ = _train(jht, JM, "wdl_criteo", feeds)
    texe, nodes = _session(tht, TM, "wdl_criteo")
    sid = next(sid for sid, n in texe._param_nodes.items()
               if n.name == "snd_order_embedding")
    table = texe.params[sid]
    ptr = table.data_ptr()
    for f in feeds:
        texe.run(feed_dict=dict(zip(nodes, f)))
        assert texe.params[sid].data_ptr() == ptr
    assert texe.params[sid] is table
    np.testing.assert_allclose(
        table.numpy(), _params(jexe)["snd_order_embedding"], rtol=0,
        atol=1e-6)


def _dataloader_session(name, n=8 * B):
    rng = np.random.RandomState(4)
    dense = rng.randn(n, 13).astype(np.float32)
    sparse = rng.randint(0, ROWS, (n, 26))
    labels = rng.randint(0, 2, (n, 1)).astype(np.float32)
    ops = [tht.dataloader_op([tht.Dataloader(a, B, "train")])
           for a in (dense, sparse, labels)]
    loss, y, _, train_op = getattr(TM, name)(
        *ops, feature_dimension=ROWS, embedding_size=WIDTH)
    return tht.Executor({"train": [loss, y, train_op]}, ctx=tht.cpu(0))


@pytest.mark.parametrize("name", ["wdl_criteo", "dcn_criteo"])
def test_run_batches_matches_sequential_runs(name):
    seq, blk = _dataloader_session(name), _dataloader_session(name)
    assert seq.get_batch_num("train") == 8
    want = [seq.run("train", convert_to_numpy_ret_vals=True)
            for _ in range(6)]
    got = blk.run_batches([{}] * 4, name="train",
                          convert_to_numpy_ret_vals=True) \
        + blk.run_batches([{}] * 2, name="train")
    assert len(got) == 6 and all(len(step) == 3 for step in got)
    for g, w in zip(got, want):
        assert g[2] is None and w[2] is None
        for a, b in zip(g[:2], w[:2]):
            a = a.asnumpy() if hasattr(a, "asnumpy") else a
            np.testing.assert_array_equal(a, b)
    for key, value in _params(seq).items():
        np.testing.assert_array_equal(_params(blk)[key], value)


def test_ctr_main_trains_on_the_cpu_and_refuses_ps(monkeypatch, tmp_path):
    """The metrics loop (``--all``), the block loop and validation of the
    port's ctr_main on its synthetic Criteo stand-in, and its PS mode,
    which it no longer refuses. (It starts and finalizes the port's
    client itself, so it runs before the module's PS fixture below.)"""
    monkeypatch.setenv("HETU_DATA_DIR", str(tmp_path))
    args = ["--model", "dcn_criteo", "--dim", str(ROWS), "--nsamples",
            "2560", "--batch-size", "64", "--nepoch", "2", "--val",
            "--device", "cpu"]
    metrics = ctr_main.worker(ctr_main.parse_args(args + ["--all"]))
    assert np.isfinite(metrics["loss"]) and 0 <= metrics["auc"] <= 1
    assert np.isfinite(metrics["val_loss"]), metrics
    blocks = ctr_main.worker(ctr_main.parse_args(args))
    assert np.isfinite(blocks["val_loss"]), blocks
    # --comm-mode PS, which was refused, now trains: the table on a
    # server started for the run (and stopped after it), read through the
    # device cache with drains every 5 steps. No server is named (other
    # tests in this process may have left theirs in the environment)
    monkeypatch.delenv("HETU_PS_PORTS", raising=False)
    monkeypatch.delenv("HETU_PS_HOSTS", raising=False)
    ps = ctr_main.worker(ctr_main.parse_args(
        args + ["--comm-mode", "PS", "--bound", "5"]))
    assert np.isfinite(ps["val_loss"]), ps
    assert "HETU_PS_PORTS" not in os.environ


@pytest.fixture(scope="module")
def ps_servers():
    """A parameter server of each package, each package's client on its
    own (tests/torch_ps_util.py)."""
    from torch_ps_util import both_servers
    with both_servers() as pair:
        yield pair


def _ps_losses(ht, models, name, feeds, client):
    """``name`` built with its tables on the host (``embed_ctx``) and
    trained in PS mode with synchronous pushes. The server draws a
    table seeded by its tensor id, which differs between the packages,
    so the tables are set to the name-seeded values both packages
    draw."""
    nodes = [ht.Variable(n, trainable=False) for n in ("d", "s", "y")]
    loss, _, _, train_op = getattr(models, name)(
        *nodes, feature_dimension=ROWS, embedding_size=WIDTH,
        embed_ctx=ht.cpu(0))
    kw = {"ctx": tht.cpu(0)} if ht is tht else {}
    exe = ht.Executor([loss, train_op], comm_mode="PS", prefetch=False,
                      **kw)
    tables = [op.parameter for op in exe.config.ps_nodes
              if op.parameter.is_embed]
    for table in tables:
        client.set_param(table.id, table.initial_value(seed=0))
    losses = [float(np.asarray(exe.run(feed_dict=dict(zip(nodes, f)))[0]
                               .asnumpy()).reshape(-1)[0]) for f in feeds]
    exe.close()
    return losses, tables


@pytest.mark.parametrize("name", CRITEO)
def test_a_table_on_the_host_is_refused(name, ps_servers):
    """A table placed on the host (``embed_ctx=ht.cpu(0)``) is no longer
    refused: under ``comm_mode="PS"`` it lives on the parameter server,
    and the model trains there as it does in hetu_tpu, losses within
    1e-5 relative."""
    jc, tc = ps_servers
    feeds = _criteo_feeds()
    jl, _ = _ps_losses(jht, JM, name, feeds, jc)
    tl, tables = _ps_losses(tht, TM, name, feeds, tc)
    assert tables and all(t.raw_ctx[0] == tht.cpu(0) for t in tables)
    assert np.all(np.isfinite(tl)), tl
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
