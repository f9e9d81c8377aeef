"""GPT's sequence parallelism in the port against the JAX package's on
a CPU mesh of the same size: ``sequence_parallel="ring"`` / ``"ulysses"``
(the twin of tests/test_gpt.py::test_gpt_causal_sequence_parallel_matches)
on an sp mesh of thread ranks (tests/torch_tp_util.py): losses rtol
1e-4, weights rtol 1e-3 / atol 1e-5. BERT's is in
test_torch_sequence_parallel_ring.py.
"""
import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu.models as JM
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM

from torch_sp_util import (LOSS_RTOL, SP, W_ATOL, W_RTOL,  # noqa: F401
                           gpt, gpt_feeds, jax_exe, named,
                           one_intra_op_thread, port_ranks, run_steps)

@pytest.mark.parametrize("sp", SP)
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_gpt_causal_sequence_parallel_matches(kind, sp):
    """GPTConfig(sequence_parallel=...) on an sp mesh of n ranks, 3 Adam
    steps, against the JAX package's run on n host devices (losses rtol
    1e-4, as tests/test_gpt.py holds its own; every weight rtol 1e-3 /
    atol 1e-5) and the port's one process (every weight, the same
    tolerances), equal on every rank. The ids repeat and reach the token
    table's last row, whose Adam slots the JAX package's lazy Adam loses
    (ROADMAP section 3): that row is held to the port's one process
    alone. The model's head dim is 4, which K2 does not take (a multiple
    of 8): every block takes the composed arithmetic."""
    nodes, feeds = gpt(jht, JM, kind)
    jexe = jax_exe(nodes, {"sp": sp})
    want = run_steps(jexe, 3, gpt_feeds(feeds))
    want_w = named(jexe)
    want_w["gpt_wte"] = want_w["gpt_wte"][:-1]
    nodes, feeds = gpt(tht, TM, kind)
    one = tht.Executor(nodes, ctx=tht.cpu(0))
    run_steps(one, 3, gpt_feeds(feeds))
    base_w = named(one)

    def run(exe, built):
        return run_steps(exe, 3, gpt_feeds(built[1])), named(exe)

    results = port_ranks({"sp": sp}, lambda ht: gpt(ht, TM, kind), run)
    for got, got_w in results:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        assert sorted(got_w) == sorted(want_w)
        for name, w in got_w.items():
            np.testing.assert_allclose(w, base_w[name], rtol=W_RTOL,
                                       atol=W_ATOL, err_msg=name)
            np.testing.assert_allclose(w[:len(want_w[name])], want_w[name],
                                       rtol=W_RTOL, atol=W_ATOL,
                                       err_msg=name)
            np.testing.assert_array_equal(w, results[0][1][name])
