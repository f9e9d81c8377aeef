"""The seq2seq Transformer (``models/transformer.py``) in hetu_tpu and in
the port on the CPU, at ``tests/test_transformer.py``'s sizes, and the
port's ``transformer_main`` against the JAX package's reversal bar.

At dropout 0 both packages train 3 Adam steps from the same initial
values on the same padded batch: losses and every parameter after the
steps within 1e-5, but for the attention key biases (``*_k_b``). Adding
``b`` to every key adds ``q . b`` to all scores of a query alike, which
the softmax cancels: their exact gradient is 0, so what each package
computes is its own rounding noise, which Adam scales to steps of its
own. Those stay within 1e-4 of 0 in both packages (measured: below
3e-5 after 3 steps). With dropout the two draw other masks
(``jax.random`` against ``torch.Generator``), so the port's dropout run
is held to its properties: finite losses that fall.
"""
import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu.models as JM
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
from hetu_tpu_torch.examples import transformer_main

B, T, VOCAB = 8, 6, 12


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """A step here is hundreds of small ops: one intra-op thread runs them
    fastest, and parallel test workers share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(ht, models, dropout=0.0, smoothing=0.0):
    cfg = models.TransformerConfig(
        vocab_size=VOCAB, d_model=32, d_ff=64, num_blocks=1, num_heads=2,
        maxlen1=T, maxlen2=T + 1, batch_size=B, dropout_rate=dropout,
        label_smoothing=smoothing)
    model = models.Transformer(cfg)
    feeds = [ht.Variable(n, trainable=False)
             for n in ("tf_src", "tf_dec", "tf_tgt")]
    return model, feeds, model(*feeds)


def _batch(seed=0, pad_tail=2):
    rng = np.random.RandomState(seed)
    s = rng.randint(2, VOCAB, (B, T))
    if pad_tail:
        s[: B // 2, -pad_tail:] = 0              # padded rows
    d = np.concatenate([np.ones((B, 1), int), s[:, :-1]], 1)
    return s, d, s


def _exe(ht, nodes):
    kw = {"ctx": tht.cpu(0)} if ht is tht else {}
    return ht.Executor(nodes, **kw)


def _scalar(v):
    return float(np.asarray(v.asnumpy()).reshape(-1)[0])


def _params(exe):
    return {node.name: np.asarray(exe.params[sid])
            for sid, node in exe._param_nodes.items()}


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_three_adam_steps_match_the_reference(smoothing):
    runs = []
    for ht, models in ((jht, JM), (tht, TM)):
        _, feeds, loss = _build(ht, models, smoothing=smoothing)
        exe = _exe(ht, [loss, ht.optim.AdamOptimizer(3e-3).minimize(loss)])
        losses = [_scalar(exe.run(feed_dict=dict(zip(feeds, _batch(i))))[0])
                  for i in range(3)]
        runs.append((losses, _params(exe)))
    (jl, jp), (tl, tp) = runs
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert sorted(tp) == sorted(jp)
    for key in jp:
        if key.endswith("_k_b"):
            assert max(np.abs(tp[key]).max(), np.abs(jp[key]).max()) < 1e-4
            continue
        np.testing.assert_allclose(tp[key], jp[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_pad_row_stays_exactly_zero():
    """The tied table's pad row gets the summed adjoint of the lookup and
    of the output projection, and must not move."""
    _, feeds, loss = _build(tht, TM)
    exe = _exe(tht, [loss, tht.optim.SGDOptimizer(0.5).minimize(loss)])
    for i in range(5):
        exe.run(feed_dict=dict(zip(feeds, _batch(i))))
    params = _params(exe)
    np.testing.assert_array_equal(params["tok_embed_pad"],
                                  np.zeros((1, 32), np.float32))
    assert np.abs(params["tok_embed"]).max() > 0


def test_decoder_is_causal():
    """Changing the last decoder input changes only the last position's
    loss: every earlier position is unchanged."""
    model, (src, dec, tgt), _ = _build(tht, TM)
    per_tok = model.train(src, dec, tgt)
    exe = _exe(tht, [per_tok])
    s, d, t = _batch(1, pad_tail=0)
    base = exe.run(feed_dict={src: s, dec: d, tgt: t})[0].asnumpy()
    d2 = d.copy()
    d2[:, -1] = (d2[:, -1] + 3) % (VOCAB - 2) + 2
    moved = exe.run(feed_dict={src: s, dec: d2, tgt: t})[0].asnumpy()
    np.testing.assert_array_equal(moved[:, :-1], base[:, :-1])
    assert np.all(moved[:, -1] != base[:, -1])


def test_copy_batch_is_memorized():
    _, feeds, loss = _build(tht, TM)
    exe = _exe(tht, [loss, tht.optim.AdamOptimizer(3e-3).minimize(loss)])
    batch = dict(zip(feeds, _batch(0, pad_tail=0)))
    losses = [_scalar(exe.run(feed_dict=batch)[0]) for _ in range(150)]
    assert losses[-1] < 0.1 and losses[-1] < losses[0] * 0.1, losses[::30]


def test_all_pad_batch_gives_loss_zero():
    outs = []
    for ht, models in ((jht, JM), (tht, TM)):
        _, feeds, loss = _build(ht, models)
        zeros = np.zeros((B, T), np.int64)
        outs.append(_scalar(_exe(ht, [loss]).run(
            feed_dict=dict(zip(feeds, (zeros, zeros, zeros))))[0]))
    assert outs == [0.0, 0.0]


def test_dropout_training_loss_is_finite_and_falls():
    _, feeds, loss = _build(tht, TM, dropout=0.3, smoothing=0.1)
    exe = _exe(tht, [loss, tht.optim.AdamOptimizer(3e-3).minimize(loss)])
    batch = dict(zip(feeds, _batch(0)))
    losses = [_scalar(exe.run(feed_dict=batch)[0]) for _ in range(40)]
    assert np.all(np.isfinite(losses)), losses
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]), losses[::5]


def test_transformer_main_learns_the_reversal(monkeypatch, tmp_path):
    """``tests/test_accuracy.py::test_transformer_example_learns_transduction``
    on the port: two epochs drive the pad-masked loss below 5.0
    (uniform: ln(2000) = 7.6)."""
    monkeypatch.setenv("HETU_DATA_DIR", str(tmp_path))
    results = transformer_main.main(transformer_main.parse_args(
        ["--nepoch", "2", "--num-blocks", "2", "--d-model", "128",
         "--d-ff", "256", "--maxlen", "12", "--nsamples", "6400",
         "--dropout", "0.0", "--device", "cpu"]))
    assert results["loss"] < 5.0, results
