"""What the sequence-parallel tests share (tests/test_torch_sequence_parallel*.py):
the JAX package's executor over a mesh of its host devices, the port's
executors on one thread a rank (tests/torch_tp_util.py), the tiny GPT of
tests/test_gpt.py, and the reference tests' tolerances."""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

import hetu_tpu as jht
from hetu_tpu.executor import HetuConfig as JHetuConfig
import hetu_tpu_torch as tht

from torch_tp_util import ranks

@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread a rank: the ranks are threads of one process,
    and parallel test workers share the CPU's cores (imported into each
    test module, where it applies)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SP = (2, 4)           # the sp axis sizes every twin runs at
LOSS_RTOL = 1e-4
W_RTOL, W_ATOL = 1e-3, 1e-5


def jax_exe(nodes, axes=None):
    """The JAX package's executor over ``axes`` ({name: size}) of its host
    devices, or of one device."""
    if axes is None:
        return jht.Executor(nodes)
    sizes = [int(s) for s in axes.values()]
    devs = np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes)
    config = JHetuConfig(eval_node_list=nodes,
                         mesh=JMesh(devs, axis_names=tuple(axes)))
    return jht.Executor({"default": nodes}, config=config)


def run_steps(exe, steps, feeds=None):
    out = []
    for i in range(steps):
        fd = {} if feeds is None else feeds(i)
        out.append(float(np.asarray(exe.run(
            feed_dict=fd, convert_to_numpy_ret_vals=True)[0]).reshape(())))
    return out


def port_ranks(axes, build, run):
    """``run(exe, built)`` on one thread a rank of ``axes``, each rank's
    executor over its mesh."""
    def go(r, mesh, built):
        exe = tht.Executor(built[0], ctx=tht.cpu(0), mesh=mesh)
        return run(exe, built)
    return ranks(axes, go, lambda r: build(tht))


def value(exe, node):
    v = exe.params[str(node.id)]
    return v.numpy().copy() if hasattr(v, "numpy") else np.asarray(v)


GPT_VOCAB, GPT_SEQ, GPT_BATCH = 64, 32, 4


def gpt(ht, models, sp=None, dropout=0.0):
    """tests/test_gpt.py's ``_build``: (nodes, (ids, labels))."""
    cfg = models.GPTConfig(
        vocab_size=GPT_VOCAB, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=8, max_position_embeddings=GPT_SEQ,
        hidden_dropout_prob=dropout, sequence_parallel=sp,
        use_flash_attention=False)
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _, loss = models.GPTLMHeadModel(cfg)(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    return [lm, ht.optim.AdamOptimizer(1e-3).minimize(lm)], (ids, labels)


def gpt_feeds(feeds):
    rng = np.random.RandomState(1)
    x = rng.randint(0, GPT_VOCAB, (GPT_BATCH, GPT_SEQ))
    y = np.concatenate([x[:, 1:], np.full((len(x), 1), -1, np.int64)],
                       axis=1)
    return lambda i: {feeds[0]: x, feeds[1]: y}


def named(exe):
    return {n.name: value(exe, n) for n in exe._param_nodes.values()}


