"""Ranks of a tensor-parallel mesh as threads of one process, for the
port's TP tests: each thread a rank, one gloo process group for each
mesh-axis slice it belongs to, all over one in-memory store, and the
executor's ``mesh=`` a :class:`~hetu_tpu_torch.parallel.mesh.Mesh` over
them (the launcher's processes run the same executor code;
tests/test_torch_tp_fleet.py runs those)."""
import datetime
import threading

import numpy as np
import torch.distributed as dist

from hetu_tpu_torch.graph import node as tnode
from hetu_tpu_torch.parallel import mesh as tmesh

TIMEOUT_S = 120


def axis_groups(axes, rank, store, timeout_s=60):
    """This rank's gloo group along each axis of the row-major grid
    ``axes`` ({name: size}): the ranks that differ from it in that
    axis alone, ranked by their coordinate on it."""
    names, sizes = list(axes), [int(axes[a]) for a in axes]
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    groups = {}
    for i, name in enumerate(names):
        for k, members in enumerate(
                np.moveaxis(grid, i, -1).reshape(-1, sizes[i])):
            members = [int(m) for m in members]
            if rank in members:
                groups[name] = dist.ProcessGroupGloo(
                    dist.PrefixStore(f"{name}/{k}", store),
                    members.index(rank), len(members),
                    datetime.timedelta(seconds=timeout_s))
    return groups


def same_ids(build, *args):
    """``build(*args)`` with node ids from the counter's next value, and
    the counter left as it was: a graph built so carries the ids of the
    next one built (:func:`ranks` builds every rank's so, as every
    process of a job builds the same ids; dropout seeds its masks by op
    id)."""
    start = tnode.G_NODE_ID
    try:
        return build(*args)
    finally:
        tnode.G_NODE_ID = start


def _run_threads(n, go):
    results, errors = [None] * n, [None] * n

    def target(r):
        try:
            results[r] = go(r)
        except BaseException as e:      # raised again on the caller
            errors[r] = e

    threads = [threading.Thread(target=target, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT_S)
        assert not t.is_alive(), "a rank did not finish (a collective hung)"
    for e in errors:
        if e is not None:
            raise e
    return results


def _build_all(n, build):
    start = end = tnode.G_NODE_ID
    built = []
    for r in range(n):
        tnode.G_NODE_ID = start
        built.append(build(r) if build else None)
        end = max(end, tnode.G_NODE_ID)
    tnode.G_NODE_ID = end
    return built


def job_ranks(n, run, build=None):
    """``run(rank, job, built)`` on one thread a rank of an ``n``-rank
    job, ``job`` the rank's :class:`~hetu_tpu_torch.parallel.mesh.Job`
    from the package's :class:`~hetu_tpu_torch.parallel.mesh.LocalJob`
    (the executor's ``pp_options={"job": job}``): its groups gloo over
    one in-memory store, its channel a
    :class:`~hetu_tpu_torch.parallel.p2p.PipeChannel` of its own on
    loopback. ``build`` as for :func:`ranks`."""
    built = _build_all(n, build)
    job = tmesh.LocalJob(n)
    try:
        return _run_threads(n, lambda r: run(r, job.job(r), built[r]))
    finally:
        job.close()


def ranks(axes, run, build=None):
    """``run(rank, mesh, built)`` on one thread a rank of the mesh
    ``axes``; ``build(rank)`` runs first, serially, every rank's graph
    with the same node ids, as every process of a job builds it.
    Returns the results by rank; a rank's exception is raised here, and
    a rank that outlives TIMEOUT_S fails the test."""
    n = int(np.prod(list(axes.values())))
    built = _build_all(n, build)
    store = dist.HashStore()

    def go(r):
        mesh = tmesh.Mesh(dict(axes), r, axis_groups(axes, r, store))
        return run(r, mesh, built[r])

    return _run_threads(n, go)
