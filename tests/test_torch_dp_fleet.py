"""Data parallelism across the port's launcher's processes (``spmd:
true``, one job, gloo on the CPU), held against the JAX package.

* The MLP of the JAX package's two-process DP test
  (``tests/test_launcher.py`` ``SPMD_DP_WORKER``), global batch 32, at 2
  and at 4 ranks: losses against the JAX package's one-process run and
  its 8-way in-process mesh (``tests/test_parallel.py:139-177``), rtol
  1e-5; the weights after the steps identical on every rank. The 4-rank
  job also builds a ``{"dp": 2, "tp": 2}`` mesh, checks its subgroups by
  all-reducing the ranks over each, and trains over its ``dp`` axis (two
  pairs of ranks, each the global batch over 2).
* A tiny GPT (2 layers, hidden 64, S=64, global batch 4) at 2 ranks,
  lazy Adam (the embedding tables' gradients take the sparse all-gather), the
  plain K2-K4 (``FUSED_BWD_MIN_SEQ`` = 0): losses and the weights after
  3 steps against ``hetu_tpu``'s one process at the tolerances of
  ``tests/test_torch_gpt_training.py`` (loss rtol 1e-5, weights atol
  1e-5), rows no id touched left alone.

Each job runs once per module (fixtures); the references run here, on
the JAX package's 8-CPU-device harness.
"""
import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu.models as JM
from torch_ps_util import run_fleet

RTOL = 1e-5
STEPS = 6

SPMD = """
spmd: true
nodes:
  - host: localhost
    workers: {n}
    chief: true
"""

WORKER = r"""
import os
import numpy as np
import torch
import torch.distributed as dist
import hetu_tpu_torch as ht
import hetu_tpu_torch.models as M
from hetu_tpu_torch.ops import attention

out = os.environ["HETU_TEST_OUT"]
rank = int(os.environ["RANK"])
nrank = int(os.environ["WORLD_SIZE"])


def mlp():
    rng = np.random.RandomState(0)
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    w1 = ht.Variable("w1", value=rng.randn(12, 16).astype("f") * 0.3)
    w2 = ht.Variable("w2", value=rng.randn(16, 4).astype("f") * 0.3)
    h = ht.relu_op(ht.matmul_op(x, w1))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(h, w2), y_), [0])
    return x, y_, loss, ht.optim.SGDOptimizer(0.2).minimize(loss), (w1, w2)


def train_mlp(tag, **options):
    x, y_, loss, train, ws = mlp()
    exe = ht.Executor([loss, train], ctx=ht.cpu(0), **options)
    frng = np.random.RandomState(3)
    xs = frng.randn(32, 12).astype("f")
    ys = np.eye(4, dtype="f")[frng.randint(0, 4, 32)]
    losses = [float(exe.run(feed_dict={x: xs, y_: ys})[0].asnumpy())
              for _ in range(STEPS)]
    np.savez(os.path.join(out, f"{tag}_{rank}.npz"), losses=losses,
             w1=exe.params[str(ws[0].id)].numpy(),
             w2=exe.params[str(ws[1].id)].numpy(),
             nrank=exe.config.nrank, mode=exe.config.comm_mode,
             backend=dist.get_backend())


train_mlp("mlp")
if nrank == 4:
    mesh = ht.parallel.build_mesh({"dp": 2, "tp": 2})
    members = {}
    for axis in mesh.axis_names:
        t = torch.zeros(4)
        t[rank] = 1
        dist.all_reduce(t, group=mesh.group(axis))
        members[axis] = np.nonzero(t.numpy())[0].tolist()
    np.save(os.path.join(out, f"groups_{rank}.npy"),
            [members["dp"], members["tp"]])
    train_mlp("mesh", mesh=mesh)
    job = ht.wrapped_mpi_nccl_init()
    pair = ht.new_group_comm([0, 1])
    total = torch.tensor([float(rank + 1)])
    if pair is not None:
        pair.all_reduce(total)
    np.save(os.path.join(out, f"job_{rank}.npy"),
            [job.rank, job.nrank, job.dev_id(), total.item(),
             -1 if pair is None else pair.nrank])
if nrank == 2:
    attention.FUSED_BWD_MIN_SEQ = 0
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    cfg = M.GPTConfig(**GPT_CFG)
    _, loss = M.GPTLMHeadModel(cfg)(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    train = ht.optim.AdamOptimizer(learning_rate=1e-3).minimize(lm)
    exe = ht.Executor([lm, train], ctx=ht.cpu(0))
    losses = []
    for step in range(3):
        rng = np.random.RandomState(step)
        x = rng.randint(0, SEEN, (4, 64))
        y = np.concatenate([x[:, 1:], np.full((4, 1), -1)], axis=1)
        losses.append(float(exe.run(feed_dict={ids: x, labels: y}
                                    )[0].asnumpy()))
    params = {n.name: exe.params[sid].numpy()
              for sid, n in exe._param_nodes.items()}
    np.savez(os.path.join(out, f"gpt_{rank}.npz"), losses=losses,
             sparse_calls=exe.config.dp_comm.stats["sparse"]["calls"],
             **params)
dist.destroy_process_group()
"""

GPT_CFG = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=64,
               hidden_dropout_prob=0.0, use_flash_attention=True)
SEEN = 40


def _fleet(tmp_path_factory, n):
    tmp = tmp_path_factory.mktemp(f"dp{n}")
    script = WORKER.replace("STEPS", str(STEPS)).replace(
        "GPT_CFG", repr(GPT_CFG)).replace("SEEN", str(SEEN))
    proc = run_fleet("hetu_tpu_torch", SPMD.format(n=n), script, tmp,
                     timeout=240)
    assert proc.returncode == 0, proc.stdout
    return tmp


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _fleet(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _fleet(tmp_path_factory, 4)


def _jax_mlp(mesh=False):
    import jax
    from jax.sharding import Mesh
    rng = np.random.RandomState(0)
    x = jht.Variable("x", trainable=False)
    y_ = jht.Variable("y_", trainable=False)
    w1 = jht.Variable("w1", value=rng.randn(12, 16).astype("f") * 0.3)
    w2 = jht.Variable("w2", value=rng.randn(16, 4).astype("f") * 0.3)
    h = jht.relu_op(jht.matmul_op(x, w1))
    loss = jht.reduce_mean_op(
        jht.softmaxcrossentropy_op(jht.matmul_op(h, w2), y_), [0])
    train = jht.optim.SGDOptimizer(0.2).minimize(loss)
    if mesh:
        config = jht.HetuConfig(eval_node_list=[loss, train], mesh=Mesh(
            np.asarray(jax.devices()[:8]), axis_names=("dp",)))
        config.nrank = 8
        exe = jht.Executor({"default": [loss, train]}, config=config)
    else:
        exe = jht.Executor([loss, train], ctx=jht.cpu(0))
    frng = np.random.RandomState(3)
    xs = frng.randn(32, 12).astype("f")
    ys = np.eye(4, dtype="f")[frng.randint(0, 4, 32)]
    losses = [float(np.asarray(exe.run(feed_dict={x: xs, y_: ys}
                                       )[0].asnumpy()).reshape(()))
              for _ in range(STEPS)]
    return losses, [np.asarray(exe.params[str(w.id)]) for w in (w1, w2)]


@pytest.fixture(scope="module")
def jax_mlp():
    return {"one": _jax_mlp(), "mesh8": _jax_mlp(mesh=True)}


def _check_mlp(tmp, tag, n, jax_mlp):
    records = [np.load(tmp / f"{tag}_{r}.npz") for r in range(n)]
    for rec in records:
        assert str(rec["mode"]) == "AllReduce" and str(rec["backend"]) == \
            "gloo"
        for ref in ("one", "mesh8"):
            np.testing.assert_allclose(rec["losses"], jax_mlp[ref][0],
                                       rtol=RTOL, err_msg=ref)
        for w in ("w1", "w2"):
            np.testing.assert_array_equal(rec[w], records[0][w])
    np.testing.assert_allclose(records[0]["w1"], jax_mlp["one"][1][0],
                               rtol=RTOL, atol=1e-6)
    return records


@pytest.mark.parametrize("n", [2, 4])
def test_mlp_fleet_matches_the_jax_package(n, two, four, jax_mlp):
    tmp = two if n == 2 else four
    for rec in _check_mlp(tmp, "mlp", n, jax_mlp):
        assert int(rec["nrank"]) == n


def test_mesh_subgroups_and_dp_over_an_axis(four, jax_mlp):
    """Rank r of the {"dp": 2, "tp": 2} grid sits at (r // 2, r % 2):
    its dp slice is {r % 2, r % 2 + 2}, its tp slice {2 (r // 2),
    2 (r // 2) + 1}; training over the dp axis is the global batch over
    2 ranks."""
    for r in range(4):
        dp, tp = np.load(four / f"groups_{r}.npy").tolist()
        assert dp == [r % 2, r % 2 + 2] and tp == [2 * (r // 2),
                                                   2 * (r // 2) + 1]
    for rec in _check_mlp(four, "mesh", 4, jax_mlp):
        assert int(rec["nrank"]) == 2


def test_reference_communicators_in_a_job(four):
    """``wrapped_mpi_nccl_init`` gives the rank, the rank count and the
    rank's card (0: no card here); ``new_group_comm([0, 1])`` a
    communicator of ranks 0 and 1 (1 + 2 all-reduced), None elsewhere."""
    for r in range(4):
        rank, nrank, dev, total, size = np.load(four / f"job_{r}.npy")
        assert (rank, nrank, dev) == (r, 4, 0)
        assert (total, size) == ((3.0, 2) if r < 2 else (r + 1.0, -1))


def test_tiny_gpt_fleet_matches_the_jax_package(two):
    """Two ranks of a tiny GPT with lazy Adam against hetu_tpu's one
    process: the token and position tables' sparse gradients are
    all-gathered (indices and values, each after its counts: 4 all_reduce
    calls a table, 8 a step) and lazy Adam leaves the rows no id
    touched."""
    ids = jht.Variable("input_ids", trainable=False)
    labels = jht.Variable("labels", trainable=False)
    _, loss = JM.GPTLMHeadModel(JM.GPTConfig(**GPT_CFG))(ids, labels)
    lm = jht.reduce_mean_op(loss, [0, 1])
    train = jht.optim.AdamOptimizer(learning_rate=1e-3).minimize(lm)
    exe = jht.Executor([lm, train])
    init = {n.name: np.asarray(exe.params[sid])
            for sid, n in exe._param_nodes.items()}
    want = []
    for step in range(3):
        rng = np.random.RandomState(step)
        x = rng.randint(0, SEEN, (4, 64))
        y = np.concatenate([x[:, 1:], np.full((4, 1), -1)], axis=1)
        want.append(float(np.asarray(exe.run(feed_dict={ids: x, labels: y}
                                             )[0].asnumpy())))
    jp = {n.name: np.asarray(exe.params[sid])
          for sid, n in exe._param_nodes.items()}
    records = [np.load(two / f"gpt_{r}.npz") for r in range(2)]
    for rec in records:
        np.testing.assert_allclose(rec["losses"], want, rtol=RTOL)
        assert int(rec["sparse_calls"]) == 8 * 3
        for name, value in jp.items():
            np.testing.assert_allclose(rec[name], value, rtol=0, atol=1e-5,
                                       err_msg=name)
            np.testing.assert_array_equal(rec[name], records[0][name])
        np.testing.assert_array_equal(rec["gpt_wte"][SEEN:],
                                      init["gpt_wte"][SEEN:])
