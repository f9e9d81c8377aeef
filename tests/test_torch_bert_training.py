"""BERT MLM + NSP pre-training: hetu_tpu_torch against hetu_tpu on the CPU.

A tiny BERT (vocab 64, hidden 32, 2 layers, 4 heads, intermediate 64,
S=16, B=4, dropout 0, fp32: the widths of tests/test_models.py) is built
letter for letter in both packages (the graph of bench.py:1150-1168) and
trained with Adam. Token types are 0 and 1 of a 3-row table: hetu_tpu's
lazy Adam loses the slots of a table's last row when ids repeat
(ROADMAP.md section 3; test_lazy_adam_keeps_the_last_row_slots holds
the port to dense Adam there), so the table's last row is never looked
up here. The attention mask
pads each row past a length drawn
from [S/2, S], and the MLM labels are -1 on the padding. Three attention
cases:

* ``flash``: ``use_flash_attention=True`` at S < ``FUSED_BWD_MIN_SEQ``,
  so the port runs kernel K1's plain version forward and the composed
  vjp backward, under the padding mask, as BERT-base does on the card;
* ``composed``: ``use_flash_attention=False``, ``batch_matmul_op`` +
  ``softmax_op``;
* ``fused``: the flash path with ``FUSED_BWD_MIN_SEQ`` patched to 0, so
  the port runs K2's, K3's and K4's plain versions, masked and
  non-causal, as BERT at S=2048 does on the card.

The JAX side runs its composed attention, as it does off the TPU.

Tolerances: initial parameters bit-identical (numpy draws seeded by name
in both packages); loss rtol 1e-5; every gradient atol = rtol = 2e-4 (the
reference's flash-backward pin, tests/test_attention.py), the tied
``word_embeddings`` included (the lookup's sparse adjoint plus the MLM
decoder's dense one); parameters after 3 Adam steps atol 1e-5 at lr 1e-4.
Adam divides by sqrt(v) + 1e-7, so where a gradient is zero in exact
arithmetic (the key biases: softmax ignores a shift shared by a row's
scores) the two frameworks' rounding noise moves a parameter by up to
about lr a step; measured 1.2e-6 after 3 steps, while every other
parameter moves ~3e-4.
"""
import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu.models as JM
import hetu_tpu.models.bert as JB
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
import hetu_tpu_torch.models.bert as TB
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ops import attention as tattn
from hetu_tpu_torch.ops import flash_attention as fa

CFG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=16, type_vocab_size=3,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S = 4, 16
LR = 1e-4                   # bench.py's BERT learning rate
CASES = ("flash", "composed", "fused")
FEEDS = ("input_ids", "token_type_ids", "attention_mask",
         "masked_lm_labels", "next_sentence_label")


@pytest.fixture(params=CASES)
def case(request, monkeypatch):
    if request.param == "fused":
        monkeypatch.setattr(tattn, "FUSED_BWD_MIN_SEQ", 0)
    return request.param


def _config(models, case, **kw):
    return models.BertConfig(**{**CFG, **kw},
                             use_flash_attention=case != "composed")


def _feeds(nodes, seed=0, b=B, s=S, vocab=CFG["vocab_size"]):
    """The graph's feeds: random ids and labels, each row padded past a
    length drawn from [S/2, S], MLM labels -1 on the padding."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(s // 2, s + 1, b)
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.float32)
    mlm = rng.randint(0, vocab, (b, s))
    mlm[mask == 0] = -1
    values = (rng.randint(0, vocab, (b, s)),
              rng.randint(0, 2, (b, s)), mask, mlm, rng.randint(0, 2, (b,)))
    return dict(zip(nodes, values))


def _graph(ht, models, case, with_grads=False, **widths):
    feeds = [ht.Variable(n, trainable=False) for n in FEEDS]
    _, _, mlm_loss, nsp_loss = models.BertForPreTraining(
        _config(models, case, **widths))(*feeds)
    loss = ht.reduce_mean_op(mlm_loss, [0, 1]) + \
        ht.reduce_mean_op(nsp_loss, [0])
    opt = ht.optim.AdamOptimizer(learning_rate=LR)
    train = opt.minimize(loss)
    nodes = [loss] + (list(train.inputs) if with_grads else []) + [train]
    return feeds, nodes, opt


def _jax_exe(case, with_grads=False):
    feeds, nodes, opt = _graph(jht, JM, case, with_grads)
    return jht.Executor(nodes), feeds, opt


def _port_exe(case, with_grads=False):
    feeds, nodes, opt = _graph(tht, TM, case, with_grads)
    return tht.Executor(nodes, ctx=tht.cpu(0)), feeds, opt


def _params(exe):
    return {node.name: np.asarray(
        exe.params[sid] if not hasattr(exe.params[sid], "numpy")
        else exe.params[sid].numpy()) for sid, node in exe._param_nodes.items()}


def _dense(value):
    """A gradient output (NDArray of a tensor or of IndexedSlices) as a
    dense numpy array."""
    v = value._value
    if hasattr(v, "to_dense"):
        v = v.to_dense()
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def _loss(exe, feeds, seed=0):
    return float(exe.run(feed_dict=_feeds(feeds, seed))[0].asnumpy())


def test_initial_params_identical_and_fwd_bwd_match(case):
    jexe, jfeeds, jopt = _jax_exe(case, with_grads=True)
    texe, tfeeds, topt = _port_exe(case, with_grads=True)
    jp, tp = _params(jexe), _params(texe)
    assert sorted(jp) == sorted(tp)
    for name in jp:
        np.testing.assert_array_equal(tp[name], jp[name], err_msg=name)
    before = dict(_build.launch_counts)
    jout = jexe.run(feed_dict=_feeds(jfeeds))
    tout = texe.run(feed_dict=_feeds(tfeeds))
    assert dict(_build.launch_counts) == before, \
        "a CPU step counted a kernel launch"
    np.testing.assert_allclose(float(tout[0].asnumpy()),
                               float(jout[0].asnumpy()), rtol=1e-5)
    names = [p.name for p in topt.params]
    assert names == [p.name for p in jopt.params]
    assert "word_embeddings" in names
    for name, jg, tg in zip(names, jout[1:-1], tout[1:-1]):
        np.testing.assert_allclose(_dense(tg), _dense(jg), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_tied_decoder_gives_word_embeddings_a_dense_gradient():
    """The lookup's IndexedSlices and the decoder's dense adjoint sum to
    one dense gradient, so every row of the table moves under Adam."""
    texe, tfeeds, topt = _port_exe("flash", with_grads=True)
    i = [p.name for p in topt.params].index("word_embeddings")
    init = _params(texe)["word_embeddings"]
    grad = texe.run(feed_dict=_feeds(tfeeds))[1 + i]._value
    assert not isinstance(grad, tht.IndexedSlices)
    assert grad.shape == init.shape and bool((grad != 0).all())
    assert (_params(texe)["word_embeddings"] != init).all()


def test_lazy_adam_keeps_the_last_row_slots():
    """A sparse gradient with repeated ids that touches a table's last
    row: the port's lazy Adam gives every touched row the m, v and
    update of dense Adam on the summed gradient. (hetu_tpu's does not
    for the last row: its dedup pads with the sentinel id dense_shape[0],
    which clips to the last row, and the padded lanes write that row's
    old slots back; ROADMAP.md section 3.)"""
    import torch
    rng = np.random.RandomState(0)
    ids = torch.tensor([[1, 0], [1, 1]])
    rows = torch.from_numpy(rng.randn(2, 2, 3).astype(np.float32))
    dense = torch.zeros(2, 3).index_add_(0, ids.reshape(-1),
                                         rows.reshape(-1, 3))
    param = torch.from_numpy(rng.randn(2, 3).astype(np.float32))
    opt = tht.optim.AdamOptimizer(learning_rate=LR)
    slots = {"m": torch.full((2, 3), 0.1), "v": torch.full((2, 3), 0.2)}
    sparse = opt.update_one(param, tht.IndexedSlices(ids, rows, (2, 3)),
                            slots, LR, 1)
    want = opt.update_one(param, dense, slots, LR, 1)
    torch.testing.assert_close(sparse[0], want[0], rtol=1e-6, atol=1e-7)
    for key in ("m", "v"):
        torch.testing.assert_close(sparse[1][key], want[1][key], rtol=1e-6,
                                   atol=1e-7)


def test_adam_steps_match(case):
    jexe, jfeeds, _ = _jax_exe(case)
    texe, tfeeds, _ = _port_exe(case)
    for step in range(3):
        np.testing.assert_allclose(_loss(texe, tfeeds, step),
                                   _loss(jexe, jfeeds, step), rtol=1e-5)
    jp, tp = _params(jexe), _params(texe)
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], rtol=0, atol=1e-5,
                                   err_msg=name)


def test_hetu_tpu_checkpoint_loads_into_the_port(tmp_path):
    jexe, jfeeds, _ = _jax_exe("flash")
    _loss(jexe, jfeeds)
    jexe.save(str(tmp_path))
    want = _loss(jexe, jfeeds, seed=1)
    texe, tfeeds, _ = _port_exe("flash")
    texe.load(str(tmp_path))
    np.testing.assert_allclose(_loss(texe, tfeeds, seed=1), want, rtol=1e-5)
    emb = next(n for n in texe._param_nodes.values()
               if n.name == "word_embeddings")
    assert float(texe.opt_state[emb.id]["v"].abs().sum()) > 0


@pytest.mark.parametrize("head", ["masked_lm", "nsp", "classification"])
def test_other_heads_match_forward_loss(head):
    """BertForMaskedLM, BertForNextSentencePrediction and
    BertForSequenceClassification: the same forward loss in both
    packages (flash attention, padded rows)."""
    losses = []
    for ht, models in ((jht, JB), (tht, TB)):
        feeds = [ht.Variable(n, trainable=False) for n in FEEDS]
        cfg = _config(models, "flash")
        ids, types, mask, mlm, nsp = feeds
        if head == "masked_lm":
            _, loss = models.BertForMaskedLM(cfg)(ids, types, mask, mlm)
            loss = ht.reduce_mean_op(loss, [0, 1])
        elif head == "nsp":
            _, loss = models.BertForNextSentencePrediction(cfg)(
                ids, types, mask, nsp)
            loss = ht.reduce_mean_op(loss, [0])
        else:
            _, loss = models.BertForSequenceClassification(cfg, 2)(
                ids, types, mask, nsp)
            loss = ht.reduce_mean_op(loss, [0])
        kw = {"ctx": tht.cpu(0)} if ht is tht else {}
        exe = ht.Executor([loss], **kw)
        values = _feeds(feeds)
        used = {n: v for n, v in values.items()
                if n in exe.subexecutors["default"].topo_order}
        losses.append(float(exe.run(feed_dict=used)[0].asnumpy()))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_attention_routing_under_the_padding_mask(monkeypatch, fused):
    """Below FUSED_BWD_MIN_SEQ each layer's forward takes K1 and its
    backward the composed vjp; from it on, K2 and K3 + K4. Every call
    carries the [B, 1, 1, S] mask."""
    if fused:
        monkeypatch.setattr(tattn, "FUSED_BWD_MIN_SEQ", 0)
    calls = {"fwd": 0, "lse": 0, "bwd": 0}
    masks = []

    def counting(name, fn):
        def wrapped(q, k, v, mask, *a, **kw):
            calls[name] += 1
            masks.append(tuple(mask.shape))
            return fn(q, k, v, mask, *a, **kw)
        return wrapped

    monkeypatch.setattr(tattn, "flash_attention",
                        counting("fwd", fa.flash_attention))
    monkeypatch.setattr(tattn, "flash_attention_with_lse",
                        counting("lse", fa.flash_attention_with_lse))
    monkeypatch.setattr(tattn, "flash_attention_bwd",
                        counting("bwd", fa.flash_attention_bwd))
    texe, tfeeds, _ = _port_exe("flash")
    _loss(texe, tfeeds)
    n = CFG["num_hidden_layers"]
    assert calls == ({"fwd": 0, "lse": n, "bwd": n} if fused
                     else {"fwd": n, "lse": 0, "bwd": 0})
    assert set(masks) == {(B, 1, 1, S)}


def test_dropout_trains_deterministically_per_seed():
    """At the default rates (0.1 hidden and probs) two executors of one
    graph with one seed take the same steps (the masks come from the
    per-op generators of (seed, step, op)), and the losses differ from
    the graph's without dropout."""
    rates = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)

    def losses(case, **kw):
        feeds = [tht.Variable(n, trainable=False) for n in FEEDS]
        _, _, mlm, nsp = TM.BertForPreTraining(
            _config(TM, case, **kw))(*feeds)
        total = tht.reduce_mean_op(mlm, [0, 1]) + tht.reduce_mean_op(nsp,
                                                                      [0])
        train = tht.optim.AdamOptimizer(learning_rate=LR).minimize(total)
        return [[_loss(exe, feeds, step) for step in range(2)]
                for exe in (tht.Executor([total, train], ctx=tht.cpu(0))
                            for _ in range(2))]

    for case in ("flash", "composed"):
        first, second = losses(case, **rates)
        assert np.isfinite(first).all() and first == second
        assert first != losses(case)[0]


@pytest.mark.parametrize("fused", [False, True])
def test_sequence_parallel_off_an_sp_mesh_is_the_flash_path(fused,
                                                             monkeypatch):
    """``sequence_parallel=True`` builds ring attention, which off a mesh
    with an "sp" axis is the flash path (plain K1 and the composed vjp,
    or with ``fused`` the plain K2-K4): 3 Adam steps of the two graphs
    give equal losses and parameters, bit for bit."""
    if fused:
        monkeypatch.setattr(tattn, "FUSED_BWD_MIN_SEQ", 0)
    runs = []
    for sp in (False, True):
        feeds = [tht.Variable(n, trainable=False) for n in FEEDS]
        _, _, mlm, nsp = TM.BertForPreTraining(
            _config(TM, "flash", sequence_parallel=sp))(*feeds)
        total = tht.reduce_mean_op(mlm, [0, 1]) + tht.reduce_mean_op(nsp,
                                                                      [0])
        train = tht.optim.AdamOptimizer(learning_rate=LR).minimize(total)
        exe = tht.Executor([total, train], ctx=tht.cpu(0))
        runs.append(([_loss(exe, feeds, step) for step in range(3)],
                     _params(exe)))
    (want, want_p), (got, got_p) = runs
    assert got == want
    for name in want_p:
        np.testing.assert_array_equal(got_p[name], want_p[name],
                                      err_msg=name)


# BERT-base's widths (bench.py:1150-1168), with a third, unused token-type
# row (see the module docstring)
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_attention_heads=12,
                 intermediate_size=3072, type_vocab_size=3)


@pytest.mark.parametrize("layers,b,s", [
    (2, 2, 64), pytest.param(12, 8, 128, marks=pytest.mark.slow)])
def test_bert_base_width_loss_curve_matches(layers, b, s):
    """BERT-base's widths, fp32, dropout 0: 4 Adam steps at lr 1e-4 on
    one fixed batch (as the card's ``bert`` pass runs it), the flash path
    (plain K1 + the composed vjp, as BERT-base on the card); 2 layers at
    B=2 S=64, and all 12 at B=8 S=128 (slow). The four losses agree
    within rtol 1e-5, as the tiny twins' do: the two frameworks sum the
    30522-way softmax and the matmuls in other orders (measured 5e-7 at
    2 layers, 6e-6 at 12 across the jump of steps 2-3, which both
    packages make there), while the loss moves by ~1e-1 a step or more,
    so a jump the port alone made would show far above that."""
    widths = dict(BERT_BASE, num_hidden_layers=layers,
                  max_position_embeddings=s)
    losses = []
    for ht, models, ctx in ((jht, JM, {}), (tht, TM, dict(ctx=tht.cpu(0)))):
        feeds, nodes, _ = _graph(ht, models, "flash", **widths)
        exe = ht.Executor(nodes, **ctx)
        batch = _feeds(feeds, b=b, s=s, vocab=widths["vocab_size"])
        losses.append([float(exe.run(feed_dict=batch)[0].asnumpy())
                       for _ in range(4)])
        del exe
    jax_losses, port_losses = losses
    print(f"layers={layers} B={b} S={s} hetu_tpu {jax_losses} "
          f"port {port_losses}")
    assert np.all(np.isfinite(port_losses))
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)
