"""hetu_tpu_torch.serving.InferenceSession against hetu_tpu's on the CPU.

A tiny GPT (vocab 64, hidden 32, 2 layers, 4 heads, 32 positions, the
widths of tests/test_serving.py) is built letter for letter in both
packages from one seed, so the parameters are bit-identical; the port
runs kernel K1's plain version in the session's graph forward, the
reference its composed attention. ``predict`` pads the batch to its
power-of-two bucket and the sequence to the model's bucket and cuts
both back: the logits of a ragged batch agree within rtol = atol =
1e-5 (float32, the reference's pin). Also: the frozen-graph contract,
the bucketing bound, a checkpoint that ``hetu_tpu``'s ``Executor.save``
wrote (sidecar included) and the port's own save -> session -> predict
round trip.
"""
import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu.models as JM
from hetu_tpu.serving import InferenceSession as JSession
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.serving import InferenceSession

TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB, SEQ = 64, 32
GPT = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=SEQ,
           hidden_dropout_prob=0.0)


def _gpt(ht, models, flash=True):
    cfg = models.GPTConfig(**GPT, use_flash_attention=flash)
    ids = ht.Variable("input_ids", trainable=False)
    return cfg, ids, models.GPTLMHeadModel(cfg)(ids)


def _linear(ht, seed=0):
    rng = np.random.RandomState(seed)
    w = ht.Variable("w", value=rng.randn(20, 4).astype("f"))
    x = ht.Variable("x", trainable=False)
    return x, ht.matmul_op(x, w)


@pytest.mark.parametrize("flash", [True, False])
def test_predict_unpads_and_matches_reference(flash):
    _, tids, tlogits = _gpt(tht, TM, flash)
    _, jids, jlogits = _gpt(jht, JM, flash)
    tsess = InferenceSession([tlogits], seq_buckets=(SEQ,), seed=3,
                             device="cpu")
    jsess = JSession([jlogits], seq_buckets=(SEQ,), seed=3)
    x = np.random.RandomState(3).randint(0, VOCAB, (3, 10))
    before = dict(_build.launch_counts)
    got = tsess.predict({"input_ids": x})[0]
    want = jsess.predict({jids: x})[0]
    assert dict(_build.launch_counts) == before
    assert isinstance(got, np.ndarray) and got.shape == (3, 10, VOCAB)
    np.testing.assert_allclose(got, want, **TOL)


def test_predict_unpads_a_linear_graph():
    x, out = _linear(tht, seed=2)
    sess = InferenceSession([out], device="cpu")
    v = np.random.RandomState(3).randn(5, 20).astype("f")
    got = sess.predict({x: v})[0]
    w = sess.params_by_name()["w"].numpy()
    assert got.shape == (5, 4)
    np.testing.assert_allclose(got, v @ w, rtol=1e-5)
    sess.close()
    with pytest.raises(RuntimeError, match="closed"):
        sess.predict({x: v})


def test_session_rejects_training_graph():
    x, out = _linear(tht, seed=4)
    y = tht.Variable("y", trainable=False)
    loss = tht.reduce_mean_op(tht.softmaxcrossentropy_sparse_op(out, y), [0])
    train = tht.optim.SGDOptimizer(0.1).minimize(loss)
    with pytest.raises(ValueError, match="OptimizerOp") as err:
        InferenceSession([loss, train], device="cpu")
    assert "pass the model outputs only (no train_op)" in str(err.value)


@pytest.fixture(scope="module")
def ps_server():
    """A server of the port and its client (tests/torch_ps_util.py)."""
    from torch_ps_util import torch_server
    with torch_server() as (client, _):
        yield client


@pytest.mark.parametrize("option", [dict(comm_mode="PS"),
                                    dict(ps_read_only=True),
                                    dict(embed_cache_rows=16)])
def test_ps_serving_options_wait_for_the_ps_port(option, ps_server):
    """The PS serving options, which the session refused until the PS
    port, now serve: an embedding table on the server, read through the
    session's client, predicts what the same table on the device does
    (1e-6 relative); ``ps_read_only`` (the default) wraps the client
    read-only and ``embed_cache_rows`` sizes its row cache."""
    from hetu_tpu_torch.serving import (ReadOnlyPSClient,
                                        serve_embeddings_from_ps)
    rng = np.random.RandomState(5)
    table = rng.randn(30, 20).astype("f")
    ids = rng.randint(0, 30, (5, 2))

    def graph():
        x, out = _linear(tht)
        tbl = tht.Variable("serve_table", value=table)
        rows = tht.embedding_lookup_op(tbl, x)
        return x, tbl, tht.matmul_op(tht.reduce_sum_op(rows, [1]),
                                     out.inputs[1])

    x, _, out = graph()
    want = InferenceSession([out], device="cpu").predict({x: ids})[0]
    x, tbl, out = graph()
    ps_server.init_tensor(tbl.id, table.shape, kind=1, opt="None")
    ps_server.set_param(tbl.id, table)
    nodes = [out]
    serve_embeddings_from_ps(nodes)
    kwargs = {"comm_mode": "PS", **option}
    sess = InferenceSession(nodes, device="cpu", **kwargs)
    np.testing.assert_allclose(sess.predict({x: ids})[0], want, rtol=1e-6)
    client = sess.ps_client
    assert isinstance(client, ReadOnlyPSClient)
    assert client.cache_rows == option.get("embed_cache_rows", 0)
    # the batch of 5 pads to its bucket of 8 by repeating the last row;
    # the row cache pulls each id of the padded batch once, the uncached
    # client every id
    padded = np.concatenate([ids, np.repeat(ids[-1:], 3, axis=0)])
    assert client.misses == (len(np.unique(padded)) if client.cache_rows
                             else padded.size)
    sess.close()


def test_bucketing_bounds_the_feed_shapes():
    """50 ragged requests (batch 1..8) reach the executor in at most one
    feed shape per bucket {1, 2, 4, 8}."""
    x, out = _linear(tht, seed=1)
    sess = InferenceSession([out], device="cpu")
    seen = []
    run = sess.executor.run

    def spy(name="default", eval_node_list=None, feed_dict=None, **kw):
        seen.append(tuple(v.shape for v in feed_dict.values()))
        return run(name, eval_node_list, feed_dict, **kw)

    sess.executor.run = spy
    rng = np.random.RandomState(1)
    for _ in range(50):
        n = int(rng.randint(1, 9))
        assert sess.predict({x: rng.randn(n, 20).astype("f")})[0].shape == \
            (n, 4)
    assert set(seen) <= {((b, 20),) for b in (1, 2, 4, 8)}, set(seen)
    assert len(set(seen)) <= 4


def _jax_trained_checkpoint(tmp_path):
    """A GPT trained one Adam step by hetu_tpu (so its sidecar carries
    optimizer slots), saved by hetu_tpu's Executor.save; returns the
    reference's eval logits of ``x`` after the step."""
    cfg, ids, logits = _gpt(jht, JM)
    labels = jht.Variable("labels", trainable=False)
    loss = jht.reduce_mean_op(
        jht.softmaxcrossentropy_sparse_op(logits, labels), [0, 1])
    train = jht.optim.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    exe = jht.Executor({"train": [loss, train], "eval": [logits]},
                       ctx=jht.cpu(0), seed=11)
    rng = np.random.RandomState(11)
    xs = rng.randint(0, VOCAB, (4, SEQ))
    ys = np.concatenate([xs[:, 1:], np.full((4, 1), -1)], axis=1)
    exe.run("train", feed_dict={ids: xs, labels: ys})
    want = np.asarray(exe.run("eval", feed_dict={ids: xs},
                              convert_to_numpy_ret_vals=True)[0])
    exe.save(str(tmp_path))
    assert (tmp_path / "session.ckpt").exists()
    return xs, want


def test_loads_a_checkpoint_saved_by_hetu_tpu(tmp_path):
    xs, want = _jax_trained_checkpoint(tmp_path)
    _, ids, logits = _gpt(tht, TM)
    # another seed: only the checkpoint can make the logits agree
    sess = InferenceSession([logits], checkpoint=str(tmp_path), seed=5,
                            device="cpu")
    np.testing.assert_allclose(sess.predict({ids: xs})[0], want, **TOL)


def test_port_save_session_predict_roundtrip(tmp_path):
    """save -> InferenceSession(checkpoint) -> predict equals the
    training executor's own eval output after 3 Adam steps."""
    _, ids, logits = _gpt(tht, TM)
    labels = tht.Variable("labels", trainable=False)
    loss = tht.reduce_mean_op(
        tht.softmaxcrossentropy_sparse_op(logits, labels), [0, 1])
    train = tht.optim.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    exe = tht.Executor({"train": [loss, train], "eval": [logits]},
                       ctx=tht.cpu(0), seed=7)
    rng = np.random.RandomState(7)
    xs = rng.randint(0, VOCAB, (4, SEQ))
    ys = np.concatenate([xs[:, 1:], np.full((4, 1), -1)], axis=1)
    for _ in range(3):
        exe.run("train", feed_dict={ids: xs, labels: ys})
    want = exe.run("eval", feed_dict={ids: xs},
                   convert_to_numpy_ret_vals=True)[0]
    exe.save(str(tmp_path))
    sess = InferenceSession([logits], checkpoint=str(tmp_path),
                            ctx=tht.cpu(0))
    got = sess.predict({ids: xs})[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the session's parameters are the checkpoint's, not copies per call
    params = sess.params_by_name()
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in params.values())
    assert params is not sess.params_by_name()
    assert all(params[n] is t for n, t in sess.params_by_name().items())
