"""The collective pipeline (``pipeline_mode="collective"``) in one
process: hetu_tpu_torch against hetu_tpu on the CPU.

Twins of tests/test_collective_pp.py and of tests/test_autoplan.py's
interleaved cases: the same numpy weights and feeds go through the JAX
package's collective pipeline (one ``shard_map`` program over its
8-device CPU harness, tests/conftest.py), through its staged GPipe, and
through the port's tick loop (every stage on the CPU) and its staged
GPipe. The port's collective run is held to its staged run and to the
JAX package's collective run at tests/test_collective_pp.py's rtol 1e-5
/ atol 1e-6 (the interleaved cases at tests/test_autoplan.py's 2e-4 /
1e-5 against the JAX package), a bf16 boundary within ``BOUNDARY_RTOL``;
every refusal of the reference's contract is raised with its words.

A chain of GPT blocks (2 a stage, 64 wide, S=16, f32) runs the port's
plain K2-K4 in every stage (``FUSED_BWD_MIN_SEQ`` patched to 0) against
the JAX package's collective run of the same graph, whose flash op
computes its composed reference off the TPU (``attention_reference``):
the JAX package's collective vjp has no rule for a ``pallas_call`` in
interpret mode, and the plain K2-K4 are held against the Pallas kernels
by tests/test_torch_flash_backward.py. Its ``use_flash_attention=False``
graph cannot serve: each block's causal-mask constant is a
``trainable=False`` parameter, which the JAX collective pipeline updates
with the rest (ROADMAP §3) and Adam has no slots for (``KeyError``).
"""
import numpy as np
import pytest
import torch

import hetu_tpu as jht
import hetu_tpu.models as JM
from hetu_tpu.executor import Executor as JExecutor
from hetu_tpu.parallel import collective_pp as jcpp
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM
from hetu_tpu_torch.ops import _build
from hetu_tpu_torch.ops import attention as tattn
from hetu_tpu_torch.parallel import collective_pp as tcpp

RTOL, ATOL = 1e-5, 1e-6                 # tests/test_collective_pp.py's
JAX_RTOL, JAX_ATOL = 2e-4, 1e-5         # tests/test_autoplan.py's


def _uniform_pipeline(ht, nstages=4, h=32, seed=0, lr=0.01, opt_cls=None,
                      ctx_of=None):
    """tests/test_collective_pp.py's uniform matmul chain, a stage on
    ``ctx_of(s)`` (default ``cpu(s)``)."""
    rng = np.random.RandomState(seed)
    for s in range(nstages):
        with ht.context(ctx_of(s) if ctx_of else ht.cpu(s)):
            if s == 0:
                x = ht.Variable("x", trainable=False)
                act = x
            w = ht.Variable(f"w{s}",
                            value=rng.randn(h, h).astype("f") * 0.2)
            act = ht.matmul_op(act, w)
            if s < nstages - 1:
                act = ht.relu_op(act)
            else:
                y_ = ht.Variable("y_", trainable=False)
                loss = ht.reduce_mean_op(
                    ht.softmaxcrossentropy_op(act, y_), [0])
                opt = (opt_cls or ht.optim.AdamOptimizer)(learning_rate=lr)
                train = opt.minimize(loss)
    return x, y_, loss, train


def _losses(exe, feeds, steps):
    return np.asarray([float(np.asarray(exe.run(
        feed_dict=feeds, convert_to_numpy_ret_vals=True)[0]).reshape(()))
        for _ in range(steps)])


def _first_weight(exe):
    sub = exe.subexecutors["default"]
    v = exe.params[str(sub.stages[0].param_nodes[0].id)]
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _session(ht, make, kind, M, steps, feeds_of, **kw):
    """(losses, stage 0's first weight) of a session of either package
    over ``make(ht)``: ``kind`` "staged" (gpipe=True) or "collective"."""
    x, y_, loss, train = make(ht)
    Exe = JExecutor if ht is jht else tht.Executor
    mode = {"gpipe": True} if kind == "staged" else \
        {"pipeline_mode": "collective"}
    exe = Exe([loss, train], num_microbatches=M, **mode, **kw)
    got = _losses(exe, feeds_of(x, y_), steps)
    return got, _first_weight(exe), exe


def _xy(seed, rows, h=32):
    rng = np.random.RandomState(seed)
    xv = rng.randn(rows, h).astype("f")
    yv = np.eye(h, dtype="f")[rng.randint(0, h, rows)]
    return lambda x, y_: {x: xv, y_: yv}


# --- the schedule ----------------------------------------------------------

def _jax_cpp(S, M, V, **kw):
    return jcpp.CollectiveGPipe([None] * S, None, M, None, "stage", None,
                                virtual_stages=V, **kw)


@pytest.mark.parametrize("S,M,V", [(2, 2, 1), (4, 4, 1), (4, 8, 1),
                                   (3, 2, 1), (8, 8, 2), (8, 4, 2),
                                   (12, 4, 3), (8, 8, 4), (6, 3, 2)])
def test_tick_loop_keeps_the_reference_schedule(S, M, V):
    """Every (chunk, microbatch) runs once forward and once backward; at
    tick t lane r runs position t - r of its V·M turns, chunk ``v·S_dev
    + r`` of microbatch m at tick ``r + v·M + m``; every boundary is
    made before it is read (the wraparound ``M - S_dev + 1`` ticks
    before, under V > 1), every cotangent likewise in reverse. The tick
    count and the [S_dev][V] layout are the JAX package's."""
    cpp = tcpp.CollectiveGPipe(S, M, virtual_stages=V)
    ref = _jax_cpp(S, M, V)
    assert (cpp.n_ticks, cpp.S_dev, cpp.V) == (ref.n_ticks, ref.S_dev, ref.V)
    sd = cpp.S_dev
    tick_of = {}
    for t in range(cpp.n_ticks):
        for c, m in cpp.lanes(t):
            v, r = divmod(c, sd)
            assert t == r + v * M + m and cpp.lane(c) == r
            tick_of[(c, m)] = t
    assert sorted(tick_of) == [(c, m) for c in range(S) for m in range(M)]
    for (c, m), t in tick_of.items():
        if c:
            gap = t - tick_of[(c - 1, m)]
            assert gap == (1 if c % sd else M - sd + 1)
    order = []
    cpp.run(lambda c, m: order.append(("f", c, m)),
            lambda c, m: order.append(("b", c, m)))
    fwd = [o[1:] for o in order if o[0] == "f"]
    bwd = [o[1:] for o in order if o[0] == "b"]
    assert fwd == sorted(tick_of, key=lambda k: (tick_of[k], k[0] % sd))
    seen = set()
    for c, m in bwd:
        assert c == S - 1 or (c + 1, m) in seen
        seen.add((c, m))
    assert len(bwd) == S * M
    np.testing.assert_array_equal(
        cpp.stack_stage_values([torch.tensor(float(s)) for s in range(S)])
        .numpy(), ref.stack_stage_values(np.arange(S, dtype="f")))


@pytest.mark.parametrize("opts", [
    {"fuse_ticks": 1, "unroll_fill_drain": False},
    {"fuse_ticks": 2, "unroll_fill_drain": False},
    {"fuse_ticks": 1, "unroll_fill_drain": True},
    {"fuse_ticks": 2, "unroll_fill_drain": True},
    {"fuse_ticks": 3, "unroll_fill_drain": True, "virtual_stages": 2},
])
def test_tick_groups_cover_every_tick_in_order(opts):
    """``fuse_ticks`` and ``unroll_fill_drain`` group the host's tick
    iterations as the reference lays out its loop (fill and drain alone
    when unrolled, the steady ticks K at a time), every tick once, in
    order; they are validated as the reference's."""
    S, M = 4, 8
    cpp = tcpp.CollectiveGPipe(S * opts.get("virtual_stages", 1), M, **opts)
    groups = cpp.tick_groups()
    assert [t for g in groups for t in g] == list(range(cpp.n_ticks))
    K = opts["fuse_ticks"]
    if opts["unroll_fill_drain"] and cpp.V == 1:
        assert groups[:S - 1] == [[t] for t in range(S - 1)]
        assert groups[-(S - 1):] == [[t] for t in
                                     range(M, M + S - 1)]
        assert [len(g) for g in groups[S - 1:-(S - 1)]] == \
            [min(K, M - S + 1 - i) for i in range(0, M - S + 1, K)]
    else:
        assert all(len(g) <= K for g in groups)
    for bad, err in (({"feed_mode": "packed"}, "feed_mode"),
                     ({"virtual_stages": 3}, "must divide")):
        for make in (lambda: tcpp.CollectiveGPipe(S, M, **bad),
                     lambda: _jax_cpp(S, M, bad.get("virtual_stages", 1),
                                      **{k: v for k, v in bad.items()
                                         if k != "virtual_stages"})):
            with pytest.raises(ValueError, match=err):
                make()
    assert tcpp.BOUNDARY_RTOL == jcpp.BOUNDARY_RTOL
    assert tcpp._canon_boundary_dtype("bf16") is torch.bfloat16
    assert tcpp._canon_boundary_dtype("fp32") is None


# --- tests/test_collective_pp.py's cases ------------------------------------

def test_collective_matches_staged_gpipe():
    """4 Adam steps at M=4 over 4 stages: the port's collective run
    against its staged GPipe (bit-equal here: the CPU adds the same
    gradients in the other order exactly at these sizes, so the check
    is at the reference's 1e-5) and against the JAX package's collective
    run; stage 0's weight written back after the steps."""
    make = _uniform_pipeline
    feeds = _xy(1, 16)
    jgot, jw0, jexe = _session(jht, make, "collective", 4, 4, feeds)
    assert jexe.subexecutors["default"]._cpp is not None
    want, w0_ref, _ = _session(tht, make, "staged", 4, 4, feeds)
    got, w0, exe = _session(tht, make, "collective", 4, 4, feeds)
    sub = exe.subexecutors["default"]
    assert sub.schedule == "collective" and sub._cpp is not None
    assert len(sub.stages) == 4 and exe.config.use_gpipe
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w0, w0_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w0, jw0, rtol=JAX_RTOL, atol=JAX_ATOL)
    assert got[-1] < got[0]


def _heterogeneous(ht, rng):
    with ht.context(ht.cpu(0)):
        x = ht.Variable("x", trainable=False)
        w0 = ht.Variable("hw0", value=rng.randn(32, 48).astype("f") * .2)
        a = ht.relu_op(ht.matmul_op(x, w0))
    with ht.context(ht.cpu(1)):
        w1 = ht.Variable("hw1", value=rng.randn(48, 10).astype("f") * .2)
        y_ = ht.Variable("y_", trainable=False)
        loss = ht.reduce_mean_op(
            ht.softmaxcrossentropy_op(ht.matmul_op(a, w1), y_), [0])
        train = ht.optim.SGDOptimizer(0.1).minimize(loss)
    return x, y_, loss, train


def test_collective_rejects_heterogeneous_stages():
    """Mismatched per-stage parameter shapes fail at the first run in
    both packages, with the reference's words."""
    for ht, Exe in ((jht, JExecutor), (tht, tht.Executor)):
        rng = np.random.RandomState(2)
        x, y_, loss, train = _heterogeneous(ht, rng)
        exe = Exe([loss, train], pipeline_mode="collective",
                  num_microbatches=2)
        with pytest.raises(ValueError, match="homogeneous"):
            exe.run(feed_dict={
                x: rng.randn(8, 32).astype("f"),
                y_: np.eye(10, dtype="f")[rng.randint(0, 10, 8)]})


_STAGED_REF = {}


def _staged_ref(M=8, steps=3):
    """The port's and the JAX package's staged-GPipe losses of the
    4-stage chain at seed 5 (once per session; every variant is held
    to both)."""
    if M not in _STAGED_REF:
        feeds = _xy(11, 32)
        make = lambda ht: _uniform_pipeline(ht, seed=5)  # noqa: E731
        _STAGED_REF[M] = (
            _session(tht, make, "staged", M, steps, feeds)[0],
            _session(jht, make, "staged", M, steps, feeds)[0])
    return _STAGED_REF[M]


@pytest.mark.parametrize("opts", [
    {"feed_mode": "replicated", "fuse_ticks": 1,
     "unroll_fill_drain": False},
    {"feed_mode": "sharded", "fuse_ticks": 1, "unroll_fill_drain": False},
    {"feed_mode": "sharded", "fuse_ticks": 2, "unroll_fill_drain": False},
    {"feed_mode": "sharded", "fuse_ticks": 1, "unroll_fill_drain": True},
    {"feed_mode": "sharded", "fuse_ticks": 2, "unroll_fill_drain": True},
], ids=["repl_scan", "shard_scan", "shard_fuse2", "shard_unroll",
        "shard_unroll_fuse2"])
def test_collective_variants_match_staged(opts):
    """Every ``pp_options`` variant trains as the staged GPipe runner
    over 3 Adam steps at M=8 > S=4 (fill, steady state and drain all
    run): the port's staged run at 1e-5, the JAX package's at 2e-4."""
    want, jwant = _staged_ref()
    got, _, exe = _session(tht, lambda ht: _uniform_pipeline(ht, seed=5),
                           "collective", 8, 3, _xy(11, 32),
                           pp_options=opts)
    cpp = exe.subexecutors["default"]._cpp
    assert (cpp.feed_mode, cpp.fuse_ticks, cpp.unroll_fill_drain) == (
        opts["feed_mode"], opts["fuse_ticks"], opts["unroll_fill_drain"])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, jwant, rtol=JAX_RTOL, atol=JAX_ATOL)


def test_collective_bf16_boundary_close_and_learning():
    """bf16 boundaries (and cotangents) quantize only what crosses: the
    losses stay within the declared ``BOUNDARY_RTOL`` of the staged
    runner's, as the JAX package's bf16 collective run does, and the
    model still learns."""
    want, _ = _staged_ref()
    runs = {}
    for ht in (jht, tht):
        runs[ht] = _session(ht, lambda ht: _uniform_pipeline(ht, seed=5),
                            "collective", 8, 3, _xy(11, 32),
                            pp_options={"boundary_dtype": "bf16"})[0]
    for got in runs.values():
        np.testing.assert_allclose(got, want, rtol=tcpp.BOUNDARY_RTOL,
                                   atol=1e-4)
        assert got[-1] < got[0]
    # the cast rounds: the run differs from the f32 boundary's
    assert not np.array_equal(runs[tht], want)


def test_collective_sharded_feeds_reject_shape_change():
    """The sharded feed layout of the first step holds: a later batch of
    another size fails loudly in both packages; the replicated transport
    takes it in the port."""
    rng = np.random.RandomState(12)
    xv = rng.randn(16, 32).astype("f")
    yv = np.eye(32, dtype="f")[rng.randint(0, 32, 16)]
    for ht, Exe in ((jht, JExecutor), (tht, tht.Executor)):
        x, y_, loss, train = _uniform_pipeline(ht, seed=6)
        exe = Exe([loss, train], pipeline_mode="collective",
                  num_microbatches=4)
        exe.run(feed_dict={x: xv, y_: yv})
        with pytest.raises(ValueError, match="changed shape"):
            exe.run(feed_dict={x: xv[:8], y_: yv[:8]})
    x, y_, loss, train = _uniform_pipeline(tht, seed=6)
    exe = tht.Executor([loss, train], pipeline_mode="collective",
                       num_microbatches=4,
                       pp_options={"feed_mode": "replicated"})
    exe.run(feed_dict={x: xv, y_: yv})
    assert np.isfinite(exe.run(feed_dict={x: xv[:8], y_: yv[:8]},
                               convert_to_numpy_ret_vals=True)[0])


def test_collective_sgd_and_more_microbatches():
    """SGD at M=8 > S=2: the schedule fills and drains; the port's
    collective run against its staged run and the JAX package's
    collective run."""
    make = lambda ht: _uniform_pipeline(  # noqa: E731
        ht, nstages=2, seed=4, opt_cls=ht.optim.SGDOptimizer, lr=0.05)
    feeds = _xy(3, 32)
    want, w_ref, _ = _session(tht, make, "staged", 8, 3, feeds)
    got, w, _ = _session(tht, make, "collective", 8, 3, feeds)
    jgot, _, _ = _session(jht, make, "collective", 8, 3, feeds)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w, w_ref, rtol=RTOL, atol=ATOL)
    assert want[-1] < want[0]


# --- tests/test_autoplan.py's interleaved cases ------------------------------

def _chain(ht, layers=4, h=32, seed=1, ctx_of=None):
    """tests/test_autoplan.py's uniform chain, SGD 0.3."""
    r = np.random.RandomState(seed)
    for k in range(layers):
        with ht.context(ctx_of(k)):
            if k == 0:
                x = ht.Variable("x", trainable=False)
                act = x
            w = ht.Variable(f"w{k}", value=r.randn(h, h).astype("f") * .05)
            act = ht.matmul_op(act, w)
            if k < layers - 1:
                act = ht.relu_op(act)
            else:
                y_ = ht.Variable("y_", trainable=False)
                loss = ht.reduce_mean_op(
                    ht.softmaxcrossentropy_op(act, y_), [0])
                train = ht.optim.SGDOptimizer(0.3).minimize(loss)
    return x, y_, loss, train


def _chain_xy(h=32):
    rng = np.random.RandomState(0)
    xv = rng.randn(16, h).astype("f")
    yv = np.eye(h, dtype="f")[rng.randint(0, h, 16)]
    return lambda x, y_: {x: xv, y_: yv}


@pytest.mark.parametrize("V", [2, pytest.param(4, marks=pytest.mark.slow)])
def test_interleaved_collective_matches_staged_gpipe(V):
    """V-way interleaved: 8 chunks on 8 // V devices (chunk k on
    ``v{k // s_dev}:cpu:{k % s_dev}``, a stage each), 4 SGD steps at
    M=8, against the port's staged GPipe on the same 8-stage graph and
    the JAX package's interleaved collective run. V=4 is slow-marked as
    the reference marks it."""
    M, S = 8, 8
    s_dev = S // V
    staged = lambda ht: _chain(  # noqa: E731
        ht, layers=S, ctx_of=lambda k: f"v0:cpu:{k}")
    folded = lambda ht: _chain(  # noqa: E731
        ht, layers=S, ctx_of=lambda k: f"v{k // s_dev}:cpu:{k % s_dev}")
    feeds = _chain_xy()
    opts = {"pp_options": {"virtual_stages": V}}
    want = _session(tht, staged, "staged", M, 4, feeds)[0]
    got, _, exe = _session(tht, folded, "collective", M, 4, feeds, **opts)
    jgot, _, jexe = _session(jht, folded, "collective", M, 4, feeds, **opts)
    cpp = exe.subexecutors["default"]._cpp
    assert (cpp.V, cpp.S_dev) == (V, s_dev) == (
        jexe.subexecutors["default"]._cpp.V,
        jexe.subexecutors["default"]._cpp.S_dev)
    assert len(exe.subexecutors["default"].stages) == S
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, jgot, rtol=JAX_RTOL, atol=JAX_ATOL)


def test_interleaved_requires_m_ge_devices():
    for ht, Exe in ((jht, JExecutor), (tht, tht.Executor)):
        x, y_, loss, train = _chain(
            ht, layers=8, ctx_of=lambda k: f"v{k // 4}:cpu:{k % 4}")
        exe = Exe([loss, train], pipeline_mode="collective",
                  num_microbatches=2,        # < 4 devices
                  pp_options={"virtual_stages": 2})
        rng = np.random.RandomState(0)
        with pytest.raises(ValueError, match="M >= device count"):
            exe.run(feed_dict={x: rng.randn(16, 32).astype("f"),
                               y_: np.eye(32, dtype="f")[:16]})


# --- the contract's other refusals -------------------------------------------

def _refused(ht, make, M=4, **kw):
    x, y_, loss, train = make(ht)
    Exe = JExecutor if ht is jht else tht.Executor
    exe = Exe([loss, train], pipeline_mode="collective",
              num_microbatches=M, **kw)
    exe.run(feed_dict=_xy(0, 16)(x, y_))


@pytest.mark.parametrize("case,match", [
    ("repeated_device", "one distinct device per stage"),
    ("not_round_robin", "round-robin placement"),
    ("skip_connection", "linear chain"),
    ("one_stage", "needs >= 2 stages"),
])
def test_contract_refusals_name_the_reference_words(case, match):
    """Raised at the first run by both packages with the same words: a
    device twice at V=1 (``v0:cpu:1`` and ``v1:cpu:1`` are one device
    to both, two stages to the port's split), V=2 over a blocked
    placement, a boundary that skips a stage, one stage."""
    def make(ht):
        if case == "repeated_device":
            return _chain(ht, layers=4,
                          ctx_of=lambda k: f"v{k // 2}:cpu:{k % 2}")
        if case == "not_round_robin":
            return _chain(ht, layers=4,
                          ctx_of=lambda k: f"v{k % 2}:cpu:{k // 2}")
        if case == "one_stage":
            return _chain(ht, layers=2, ctx_of=lambda k: "cpu:0")
        rng = np.random.RandomState(3)
        with ht.context(ht.cpu(0)):
            x = ht.Variable("x", trainable=False)
            a = ht.relu_op(ht.matmul_op(x, ht.Variable(
                "s0", value=rng.randn(32, 32).astype("f"))))
        with ht.context(ht.cpu(1)):
            b = ht.relu_op(ht.matmul_op(a, ht.Variable(
                "s1", value=rng.randn(32, 32).astype("f"))))
        with ht.context(ht.cpu(2)):
            c = ht.matmul_op(b, ht.Variable(
                "s2", value=rng.randn(32, 32).astype("f"))) + a
            y_ = ht.Variable("y_", trainable=False)
            loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(c, y_), [0])
            train = ht.optim.SGDOptimizer(0.1).minimize(loss)
        return x, y_, loss, train

    kw = {"pp_options": {"virtual_stages": 2}} \
        if case == "not_round_robin" else {}
    for ht in (jht, tht):
        with pytest.raises(ValueError, match=match):
            _refused(ht, make, **kw)


def test_stages_across_worker_processes_are_refused(monkeypatch):
    """In a launcher's job (``HETU_NUM_PROCS=2``) stages owned by two
    worker processes are refused at the first run, before any boundary
    crosses, with the reference's words; so is the planner's collective
    plan in a job, whose chunks are ``worker<k>`` stages."""
    monkeypatch.setenv("HETU_NUM_PROCS", "2")
    monkeypatch.setenv("HETU_PROC_ID", "0")
    with pytest.raises(ValueError, match="stages spanning worker processes"):
        _refused(tht, lambda ht: _chain(
            ht, layers=4, ctx_of=lambda k: f"worker{k % 2}:cpu:{k}"))


def test_a_tuple_stage_is_refused():
    """A stage whose context is a tuple of devices that it splits over
    (TP inside the stage, run as thread ranks of this process) is
    refused with the reference's words for an in-stage mesh; a tuple
    stage that splits nothing runs on its first device, as in the JAX
    package, and trains as the staged runner."""
    def make(split):
        def build(ht):
            rng = np.random.RandomState(7)
            with ht.context((ht.cpu(0), ht.cpu(1))):
                x = ht.Variable("x", trainable=False)
                w = ht.Variable("tw0", value=rng.randn(32, 32).astype("f"))
                a = ht.relu_op(ht.matmul_op(
                    x, ht.dispatch(w, (1, 2)) if split else w))
            with ht.context(ht.cpu(2)):
                w1 = ht.Variable("tw1", value=rng.randn(32, 32).astype("f"))
                y_ = ht.Variable("y_", trainable=False)
                loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(
                    ht.matmul_op(a, w1), y_), [0])
                train = ht.optim.SGDOptimizer(0.01).minimize(loss)
            return x, y_, loss, train
        return build

    with pytest.raises(ValueError, match="in-stage TP/DP meshes"):
        _refused(tht, make(True))
    feeds = _xy(0, 16)
    want = _session(tht, make(False), "staged", 4, 2, feeds)[0]
    got = _session(tht, make(False), "collective", 4, 2, feeds)[0]
    np.testing.assert_array_equal(got, want)


# --- a chain of GPT blocks ---------------------------------------------------

GPT = dict(hidden_size=64, num_attention_heads=4, intermediate_size=256,
           max_position_embeddings=16, vocab_size=64,
           hidden_dropout_prob=0.0)


def _gpt_chain(ht, models, stages=2, per=2, lr=1e-3):
    """2·``stages`` GPT blocks, ``per`` a stage on cpu(s): a feed x [B,
    S, 64] enters stage 0, the last stage's loss is the mean sparse
    softmax cross-entropy of its [B·S, 64] output against labels in
    [0, 64) (no embeddings or head: the stages stay homogeneous)."""
    cfg = models.GPTConfig(num_hidden_layers=stages * per,
                           use_flash_attention=True, **GPT)
    seq, h = GPT["max_position_embeddings"], GPT["hidden_size"]
    blocks = [models.gpt.GPTBlock(cfg, name=f"c{i}")
              for i in range(stages * per)]
    for s in range(stages):
        with ht.context(ht.cpu(s)):
            if s == 0:
                x = ht.Variable("x", trainable=False)
                act = x
            for block in blocks[s * per:(s + 1) * per]:
                act = block(act, seq)
            if s == stages - 1:
                labels = ht.Variable("labels", trainable=False)
                loss = ht.reduce_mean_op(ht.softmaxcrossentropy_sparse_op(
                    ht.array_reshape_op(act, [-1, h]), labels), [0])
                train = ht.optim.AdamOptimizer(learning_rate=lr) \
                    .minimize(loss)
    return x, labels, loss, train


def test_gpt_block_chain_matches_staged_and_the_reference(monkeypatch):
    """2 stages of 2 GPT blocks, f32, M=4, 3 Adam steps: the port's
    collective run (the plain K2-K4 in every block) against its staged
    GPipe at 1e-5 and the JAX package's collective run (its composed
    reference) at 2e-4 / 1e-5; the tick loop calls K2 and the K3 + K4
    pair 4 · M times a step (their plain versions: no launch is counted
    on the CPU)."""
    rng = np.random.RandomState(9)
    B, S, H = 8, GPT["max_position_embeddings"], GPT["hidden_size"]
    xv = rng.randn(B, S, H).astype("f")
    yv = rng.randint(0, H, B * S).astype("f")
    monkeypatch.setattr(tattn, "FUSED_BWD_MIN_SEQ", 0)
    calls = {}
    for key in ("flash_attention_with_lse", "flash_attention_bwd"):
        real = getattr(tattn, key)
        monkeypatch.setattr(tattn, key, lambda *a, _r=real, _k=key, **k: (
            calls.__setitem__(_k, calls.get(_k, 0) + 1) or _r(*a, **k)))
    before = dict(_build.launch_counts)
    runs = {}
    for name, ht, models, kind in (
            ("jax", jht, JM, "collective"),
            ("staged", tht, TM, "staged"),
            ("collective", tht, TM, "collective")):
        calls.clear()
        runs[name] = _session(
            ht, lambda ht: _gpt_chain(ht, models), kind,
            4, 3, lambda x, y_: {x: xv, y_: yv})
    got, w, exe = runs["collective"]
    np.testing.assert_allclose(got, runs["staged"][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w, runs["staged"][1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, runs["jax"][0], rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    np.testing.assert_allclose(w, runs["jax"][1], rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    assert calls == {"flash_attention_with_lse": 4 * 4 * 3,
                     "flash_attention_bwd": 4 * 4 * 3}
    assert dict(_build.launch_counts) == before
    assert got[-1] < got[0]


def test_pipeline_mode_takes_the_reference_values():
    """``pipeline_mode`` is None or ``"collective"`` in both packages,
    which sets ``use_gpipe``; any other value is refused with the
    reference's words."""
    for ht, Exe in ((jht, JExecutor), (tht, tht.Executor)):
        x, y_, loss, train = _chain(ht, layers=2,
                                    ctx_of=lambda k: f"cpu:{k}")
        with pytest.raises(ValueError, match="unknown pipeline_mode"):
            Exe([loss, train], pipeline_mode="ring")
        exe = Exe([loss, train], pipeline_mode="collective",
                  num_microbatches=2)
        assert exe.config.use_gpipe
        assert exe.config.pipeline_mode == "collective"
