"""Sequence parallelism on the session mesh in the port: a
``("dp", "sp")`` mesh against one process and the JAX package's (2, 2)
mesh, dropout's masks equal across the sp ranks, and the refusals of an
sp axis where the port has no sequence parallelism (beside model axes,
in a pipeline, on a parameter server), each naming its ROADMAP item.
"""
import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu.models as JM
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM

from torch_sp_util import (LOSS_RTOL, W_ATOL, W_RTOL,  # noqa: F401
                           gpt, gpt_feeds, jax_exe, named,
                           one_intra_op_thread, port_ranks, run_steps)
from torch_tp_util import same_ids

# ---------------------------------------------------------------------------
# the mesh: dp x sp, dropout, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_dp_by_sp_matches_one_process_and_the_jax_package(kind):
    """A ("dp", "sp") mesh of 4 ranks: dp splits the 4 rows, sp the
    sequence inside each; 3 Adam steps against the port's one process
    (the fused path) and the JAX package's (2, 2) mesh: losses rtol
    1e-4, weights rtol 1e-3 / atol 1e-5."""
    nodes, feeds = gpt(tht, TM, kind)
    one = tht.Executor(nodes, ctx=tht.cpu(0))
    base, base_w = run_steps(one, 3, gpt_feeds(feeds)), named(one)
    nodes, feeds = gpt(jht, JM, kind)
    jexe = jax_exe(nodes, {"dp": 2, "sp": 2})
    want = run_steps(jexe, 3, gpt_feeds(feeds))

    def run(exe, built):
        assert exe.config.dp_comm.nrank == 2 and exe.config.nrank == 2
        return run_steps(exe, 3, gpt_feeds(built[1])), named(exe)

    results = port_ranks({"dp": 2, "sp": 2},
                          lambda ht: gpt(ht, TM, kind), run)
    for got, got_w in results:
        np.testing.assert_allclose(got, base, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        for name, w in got_w.items():
            np.testing.assert_allclose(w, base_w[name], rtol=W_RTOL,
                                       atol=W_ATOL, err_msg=name)


def test_weights_stay_equal_across_sp_ranks_under_dropout():
    """Dropout 0.1 outside attention: every sp rank draws the same masks
    (the seed is the dp coordinate's), so after 3 Adam steps every
    weight is equal on both ranks, and the losses are the one-process
    run's at the same seed."""
    def run(exe, built):
        return run_steps(exe, 3, gpt_feeds(built[1])), named(exe)

    # the one process's graph carries the ranks' node ids: dropout seeds
    # its masks by op id
    nodes, feeds = same_ids(gpt, tht, TM, "ring", 0.1)
    results = port_ranks({"sp": 2}, lambda ht: gpt(ht, TM, "ring", 0.1),
                          run)
    base = run_steps(tht.Executor(nodes, ctx=tht.cpu(0)), 3, gpt_feeds(feeds))
    assert results[0][0] == results[1][0]
    np.testing.assert_allclose(results[0][0], base, rtol=LOSS_RTOL)
    for name, w in results[0][1].items():
        np.testing.assert_array_equal(w, results[1][1][name], err_msg=name)


def _refused(axes, match, build=None, **options):
    import datetime
    import torch.distributed as dist
    from hetu_tpu_torch.parallel import mesh as tmesh
    store = dist.HashStore()
    groups = {a: dist.ProcessGroupGloo(dist.PrefixStore(a, store), 0, 1,
                                       datetime.timedelta(seconds=10))
              for a in axes}
    mesh = tmesh.Mesh({a: 1 for a in axes}, 0, groups)
    nodes = (build or (lambda: gpt(tht, TM, "ring")[0]))()
    with pytest.raises(NotImplementedError, match=match):
        tht.Executor(nodes, ctx=tht.cpu(0), mesh=mesh, **options)


def test_sp_beside_model_axes_is_refused():
    _refused(("sp", "tp0"), "ROADMAP item 11c.1")


def test_sp_beside_a_tensor_parallel_plan_is_refused():
    def build():
        x = tht.Variable("x", value=np.ones((4, 8), np.float32))
        w = tht.Variable("w", value=np.ones((8, 8), np.float32))
        y = tht.matmul_op(x, tht.dispatch(w, (1, 2)))
        return [tht.reduce_mean_op(y, [0, 1])]
    _refused(("sp",), "ROADMAP item 11c.1", build)


def test_sp_in_a_pipeline_is_refused():
    _refused(("sp",), "ROADMAP item 11c.2", gpipe=True, num_microbatches=2)


@pytest.mark.parametrize("mode", ["PS", "Hybrid"])
def test_sp_on_a_parameter_server_is_refused(mode):
    _refused(("sp",), "ROADMAP item 11c.3", comm_mode=mode)
