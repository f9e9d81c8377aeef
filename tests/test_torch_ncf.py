"""NCF (``models/ncf.py`` ``neural_mf``) in hetu_tpu and in the port on
the CPU from the same initial values and batches: 4 SGD steps, losses
within 1e-5 relative, every parameter after them within 1e-5; and the
port's ``rec_main`` against the JAX package's retrieval bars
(``tests/test_accuracy.py::test_ncf_retrieval_accuracy``: HR@10 >= 0.5,
NDCG@10 >= 0.25 over each user's 100 candidates) with the same settings.
"""
import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu.models.ncf as JN
import hetu_tpu_torch as tht
import hetu_tpu_torch.models.ncf as TN
from hetu_tpu_torch.examples import movielens, rec_main

USERS, ITEMS, B, STEPS = 50, 40, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """A step here is hundreds of small ops: one intra-op thread runs them
    fastest, and parallel test workers share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _train(ht, ncf, batches):
    user = ht.Variable("user_input", trainable=False)
    item = ht.Variable("item_input", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    loss, _, train_op = ncf.neural_mf(user, item, y_, USERS, ITEMS,
                                      learning_rate=0.5)
    kw = {"ctx": tht.cpu(0)} if ht is tht else {}
    exe = ht.Executor([loss, train_op], **kw)
    losses = [float(np.asarray(exe.run(feed_dict={
        user: u, item: i, y_: y})[0].asnumpy()).reshape(-1)[0])
        for u, i, y in batches]
    return losses, {node.name: np.asarray(exe.params[sid])
                    for sid, node in exe._param_nodes.items()}


def test_neural_mf_trains_like_the_reference():
    rng = np.random.RandomState(0)
    # ids repeat within a batch (16 draws from 40 items, zipf-skewed)
    batches = [(rng.randint(0, USERS, B).astype(np.int32),
                ((rng.zipf(1.3, B) - 1) % ITEMS).astype(np.int32),
                rng.randint(0, 2, (B, 1)).astype(np.float32))
               for _ in range(STEPS)]
    jl, jp = _train(jht, JN, batches)
    tl, tp = _train(tht, TN, batches)
    assert np.all(np.isfinite(tl)) and tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert sorted(tp) == sorted(jp)
    for key in jp:
        np.testing.assert_allclose(tp[key], jp[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    assert (TN.ML25M_USERS, TN.ML25M_ITEMS) == (JN.ML25M_USERS,
                                                JN.ML25M_ITEMS)


def test_rec_main_reaches_the_reference_retrieval_bars(monkeypatch,
                                                       tmp_path):
    """HETU_DATA_DIR points at an empty directory: the synthetic
    implicit-feedback set, the same draw as examples/rec/movielens.py's."""
    monkeypatch.setenv("HETU_DATA_DIR", str(tmp_path))
    args = rec_main.parse_args([
        "--val", "--nepoch", "18", "--learning-rate", "8.0",
        "--batch-size", "1024", "--device", "cpu"])
    results = rec_main.worker(args)
    assert results["hr"] >= 0.5, results
    assert results["ndcg"] >= 0.25, results


def test_movielens_copy_draws_the_reference_set():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "rec",
                        "movielens.py")
    spec = importlib.util.spec_from_file_location("ref_movielens", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    got, want = movielens.make_synthetic(), ref.make_synthetic()
    for key in want[0]:
        np.testing.assert_array_equal(got[0][key], want[0][key])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]


@pytest.mark.parametrize("mode", ["PS", "Hybrid"])
def test_rec_main_trains_in_the_ps_modes(monkeypatch, tmp_path, mode):
    """``--comm-mode PS`` / ``Hybrid``: the tables on a server started for
    the run (which draws them itself: other initial values than the
    device run's), read through the device cache, reach the same
    retrieval bars as the tables on the device."""
    monkeypatch.setenv("HETU_DATA_DIR", str(tmp_path))
    # no server named: rec_main starts its own (other tests in this
    # process may have left theirs in the environment)
    monkeypatch.delenv("HETU_PS_PORTS", raising=False)
    monkeypatch.delenv("HETU_PS_HOSTS", raising=False)
    results = rec_main.worker(rec_main.parse_args([
        "--val", "--nepoch", "18", "--learning-rate", "8.0",
        "--batch-size", "1024", "--device", "cpu", "--comm-mode", mode]))
    assert results["hr"] >= 0.5, results
    assert results["ndcg"] >= 0.25, results
