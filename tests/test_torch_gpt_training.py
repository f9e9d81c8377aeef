"""GPT causal-LM training: hetu_tpu_torch against hetu_tpu on the CPU.

A tiny GPT (2 layers, hidden 64, 4 heads, vocab 97, S=64, B=2, fp32)
is built letter for letter in both packages (the graph of
bench.py:1103-1118) and trained with Adam. On the port side
``FUSED_BWD_MIN_SEQ`` is patched to 0, so its attention runs the plain
versions of kernels K2 (forward with logsumexp), K3 and K4 (fused
backward); the JAX side runs its composed attention, as it does off
TPU. ``test_composed_attention_path_matches`` builds both with
``use_flash_attention=False`` instead. Ids come from the first 40 rows of the vocabulary only, so most of
``gpt_wte`` is never touched and lazy Adam must leave it alone.

Tolerances: initial parameters bit-identical (numpy draws seeded by
name in both packages); loss rtol 1e-5; gradients atol = rtol = 2e-4
(the reference's flash-backward pin, tests/test_attention.py); params
after 3 Adam steps atol 1e-5 at lr 1e-3 (Adam divides by sqrt(v) + 1e-7,
so a gradient difference dg moves a parameter by at most
lr * dg / 1e-7 per step; the measured gap is 2.1e-6, the
gradient gap 7.5e-8).
"""
import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu.models as JM
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ops import attention as tattn
from hetu_tpu_torch.ops import flash_attention as fa

CFG = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=64,
           hidden_dropout_prob=0.0, use_flash_attention=True)
B, S, SEEN = 2, 64, 40
LR = 1e-3


@pytest.fixture(autouse=True)
def _fused_path(monkeypatch):
    monkeypatch.setattr(tattn, "FUSED_BWD_MIN_SEQ", 0)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, SEEN, (B, S))
    y = np.concatenate([x[:, 1:], np.full((B, 1), -1)], axis=1)
    return x, y


def _graph(ht, models, with_grads=False, flash=True):
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    cfg = models.GPTConfig(**{**CFG, "use_flash_attention": flash})
    _, loss = models.GPTLMHeadModel(cfg)(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    opt = ht.optim.AdamOptimizer(learning_rate=LR)
    train = opt.minimize(lm)
    nodes = [lm] + (list(train.inputs) if with_grads else []) + [train]
    return ids, labels, nodes, opt


def _jax_exe(with_grads=False, flash=True):
    ids, labels, nodes, opt = _graph(jht, JM, with_grads, flash)
    return jht.Executor(nodes), ids, labels, opt


def _port_exe(with_grads=False, flash=True):
    ids, labels, nodes, opt = _graph(tht, TM, with_grads, flash)
    return tht.Executor(nodes, ctx=tht.cpu(0)), ids, labels, opt


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


def test_initial_params_identical_and_fwd_bwd_match():
    jexe, jids, jlab, jopt = _jax_exe(with_grads=True)
    texe, tids, tlab, topt = _port_exe(with_grads=True)
    jp, tp = _params(jexe), _params(texe)
    assert sorted(jp) == sorted(tp)
    for name in jp:
        np.testing.assert_array_equal(tp[name], jp[name], err_msg=name)
    x, y = _batch()
    before = dict(_build.launch_counts)
    jout = jexe.run(feed_dict={jids: x, jlab: y})
    tout = texe.run(feed_dict={tids: x, tlab: y})
    assert dict(_build.launch_counts) == before, \
        "a CPU step counted a kernel launch"
    np.testing.assert_allclose(float(tout[0].asnumpy()),
                               float(jout[0].asnumpy()), rtol=1e-5)
    names = [p.name for p in topt.params]
    assert names == [p.name for p in jopt.params]
    for name, jg, tg in zip(names, jout[1:-1], tout[1:-1]):
        np.testing.assert_allclose(_dense(tg), _dense(jg), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_adam_steps_match_and_leave_unseen_embedding_rows():
    jexe, jids, jlab, _ = _jax_exe()
    texe, tids, tlab, _ = _port_exe()
    init = _params(texe)
    for step in range(3):
        x, y = _batch(seed=step)
        jl = float(jexe.run(feed_dict={jids: x, jlab: y})[0].asnumpy())
        tl = float(texe.run(feed_dict={tids: x, tlab: y})[0].asnumpy())
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jp, tp = _params(jexe), _params(texe)
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    # lazy Adam: rows no id touched are bit-identical to the initial ones
    np.testing.assert_array_equal(tp["gpt_wte"][SEEN:],
                                  init["gpt_wte"][SEEN:])
    assert not np.array_equal(tp["gpt_wte"][:SEEN], init["gpt_wte"][:SEEN])


@pytest.mark.parametrize("check", ["fwd_bwd", "adam_steps"])
def test_composed_attention_path_matches(check):
    """use_flash_attention=False in both packages: batch_matmul_op +
    softmax_op under a broadcast [1, 1, S, S] causal-mask constant. The
    step's loss and gradients, or the loss of 3 Adam steps and the
    parameters after them, at the tolerances above."""
    jexe, jids, jlab, jopt = _jax_exe(with_grads=check == "fwd_bwd",
                                      flash=False)
    texe, tids, tlab, topt = _port_exe(with_grads=check == "fwd_bwd",
                                       flash=False)
    steps = 1 if check == "fwd_bwd" else 3
    for step in range(steps):
        x, y = _batch(seed=step)
        jout = jexe.run(feed_dict={jids: x, jlab: y})
        tout = texe.run(feed_dict={tids: x, tlab: y})
        np.testing.assert_allclose(float(tout[0].asnumpy()),
                                   float(jout[0].asnumpy()), rtol=1e-5)
    if check == "fwd_bwd":
        for p, jg, tg in zip(topt.params, jout[1:-1], tout[1:-1]):
            np.testing.assert_allclose(_dense(tg), _dense(jg), rtol=2e-4,
                                       atol=2e-4, err_msg=p.name)
        return
    jp, tp = _params(jexe), _params(texe)
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], rtol=0, atol=1e-5,
                                   err_msg=name)


def test_hetu_tpu_checkpoint_loads_into_the_port(tmp_path):
    jexe, jids, jlab, _ = _jax_exe()
    x, y = _batch()
    jexe.run(feed_dict={jids: x, jlab: y})
    jexe.save(str(tmp_path))
    want = float(jexe.run(feed_dict={jids: x, jlab: y})[0].asnumpy())
    texe, tids, tlab, _ = _port_exe()
    texe.load(str(tmp_path))
    got = float(texe.run(feed_dict={tids: x, tlab: y})[0].asnumpy())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # Adam's slots came across by name
    wte = next(n for n in texe._param_nodes.values() if n.name == "gpt_wte")
    assert float(texe.opt_state[wte.id]["v"].abs().sum()) > 0


def test_port_save_load_round_trip(tmp_path):
    texe, tids, tlab, _ = _port_exe()
    x, y = _batch()
    texe.run(feed_dict={tids: x, tlab: y})
    texe.save(str(tmp_path))
    other, oids, olab, _ = _port_exe()
    other.load(str(tmp_path))
    for name, value in _params(texe).items():
        np.testing.assert_array_equal(_params(other)[name], value)
    a = float(texe.run(feed_dict={tids: x, tlab: y})[0].asnumpy())
    b = float(other.run(feed_dict={oids: x, olab: y})[0].asnumpy())
    assert a == b


def test_load_params_by_name_and_shape_check():
    texe, tids, tlab, _ = _port_exe()
    ones = np.ones((CFG["hidden_size"],), np.float32)
    texe.load_params({"gpt_ln_f_bias": ones, "not_a_param": ones})
    assert np.array_equal(_params(texe)["gpt_ln_f_bias"], ones)
    with pytest.raises(ValueError):
        texe.load_params({"gpt_ln_f_bias": np.ones(3, np.float32)})


def test_training_routes_through_the_fused_kernels(monkeypatch):
    """Every layer's forward takes K2 and its backward K3 + K4 (their
    plain versions on the CPU); no step calls K1 or the composed vjp."""
    calls = {"fwd": 0, "lse": 0, "bwd": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tattn, "flash_attention",
                        counting("fwd", fa.flash_attention))
    monkeypatch.setattr(tattn, "flash_attention_with_lse",
                        counting("lse", fa.flash_attention_with_lse))
    monkeypatch.setattr(tattn, "flash_attention_bwd",
                        counting("bwd", fa.flash_attention_bwd))
    texe, tids, tlab, _ = _port_exe()
    x, y = _batch()
    texe.run(feed_dict={tids: x, tlab: y})
    layers = CFG["num_hidden_layers"]
    assert calls == {"fwd": 0, "lse": layers, "bwd": layers}


def test_executor_defaults_to_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ids, labels, nodes, _ = _graph(tht, TM)
    with pytest.raises(RuntimeError, match="CUDA"):
        tht.Executor(nodes)
    with pytest.raises(TypeError, match="ROADMAP"):
        tht.Executor(nodes, ctx=tht.cpu(0), comm_mode="PS")
