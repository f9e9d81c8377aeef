"""Executor: define-then-run sessions, run eagerly on one device.

Counterpart of ``hetu_tpu/executor.py``, its single-device path:
``HetuConfig`` (seed, device, mixed-precision ``dtype``),
``SubExecutor`` (one eval subgraph) and ``Executor`` (parameter,
op-state and optimizer-slot materialization, ``run``, dataloaders and
``get_batch_num``, ``save`` / ``load``).

Where the reference traces the topological order once per feed-shape
signature into one XLA program, this executor walks it eagerly every
step, calling each op's ``compute`` on torch tensors (the kernels launch
from there). The mixed-precision rule is the reference's
(``executor.py:695-712``): with ``dtype`` set, floating parameters are
cast to it for compute while the optimizer updates their f32 masters,
floating feeds are cast, integer feeds and parameters are not. Each
intermediate value is dropped after its last consumer, so a step holds
only what the rest of the step still reads.

A graph without ``dtype`` computes in f32, as the reference's does: its
walk runs with cuDNN's TF32 off (``_EXACT_F32_CONVS``), so convolutions
on the card round like the CPU's; PyTorch's matmuls are f32 by default.
The process-wide flag is restored when the last such walk ends.

Op state (batch norm's running statistics) is one ``Executor.state``
shared by every subgraph: created once shapes are known, updated by
training steps, read by the others, which run their ops in inference
mode (no optimizer in the subgraph). Dataloader ops give each run of a
subgraph the next batch of the dataloader of its name.

The PS and Hybrid modes, the dp/tp/pp meshes, ``run_batches``,
telemetry and the preflight analysis are still to port; ``HetuConfig``
refuses their options.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import threading
import warnings

import numpy as np
import torch

from .context import DeviceGroup, get_current_context
from .dataloader import DataloaderOp
from .device import resolve_device
from .graph.autodiff import find_topo_sort, gradients
from .graph.node import ExecContext
from .ndarray import NDArray, cpu, gpu
from .optimizer import OptimizerOp
from .ops.variable import PlaceholderOp

__all__ = ["Executor", "HetuConfig", "SubExecutor", "gradients"]


class HetuConfig:
    """Session configuration: the eval nodes, the seed of parameter
    initialization and of per-op generators, the device and the compute
    dtype.

    The device is ``device`` if given, else the first context of ``ctx``
    (``ht.cpu(0)`` / ``ht.gpu(0)``) or of the enclosing ``ht.context``,
    else ``cuda`` — which raises without a GPU
    (:func:`~hetu_tpu_torch.device.resolve_device`)."""

    def __init__(self, eval_node_list, ctx=None, seed=0, dtype=None,
                 device=None, **options):
        if options:
            raise TypeError(
                f"HetuConfig options {sorted(options)} belong to modes the "
                f"port does not have yet (PS/Hybrid, parallel meshes, "
                f"pipelines, telemetry, analysis): see ROADMAP.md")
        if dtype is not None and not (isinstance(dtype, torch.dtype)
                                      and dtype.is_floating_point):
            raise TypeError(f"dtype must be a floating torch.dtype, got "
                            f"{dtype!r}")
        self.eval_node_list = eval_node_list
        self.seed = seed
        self.dtype = dtype
        if device is None:
            ctx = ctx if ctx is not None else get_current_context()
            if ctx is not None:
                device = DeviceGroup(ctx)[0].torch_device()
        self.device = resolve_device(device)


class _ExactF32Convs:
    """Turns cuDNN's TF32 off while any f32 walk runs and restores the
    caller's setting when the last one ends. The flag is the process's,
    and threads (serving batchers) walk concurrently, so the walks are
    counted under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    def __enter__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
            self._depth += 1

    def __exit__(self, *exc):
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                torch.backends.cudnn.allow_tf32 = self._saved


_EXACT_F32_CONVS = _ExactF32Convs()


class SubExecutor:
    """Runs one eval subgraph (reference executor.py:1340-1864)."""

    def __init__(self, name, eval_node_list, config):
        self.name = name
        self.eval_node_list = eval_node_list
        self.config = config
        self.topo_order = find_topo_sort(eval_node_list)
        self.optimizer_ops = [n for n in self.topo_order
                              if isinstance(n, OptimizerOp)]
        self.training = bool(self.optimizer_ops)
        self.param_nodes = [n for n in self.topo_order
                            if isinstance(n, PlaceholderOp)
                            and (n.tensor_value is not None
                                 or n.initializer is not None)]
        self.feed_nodes = [n for n in self.topo_order
                           if isinstance(n, PlaceholderOp)
                           and n not in self.param_nodes]
        self.dataloader_ops = [n for n in self.topo_order
                               if isinstance(n, DataloaderOp)]
        self.stateful_ops = [n for n in self.topo_order if n.stateful]
        # batches an epoch: the fewest any of its dataloaders gives
        self.batch_num = min((dl.get_batch_num(name)
                              for dl in self.dataloader_ops), default=None)
        self.step_count = 0
        self._shapes_key = None
        # the step index after which each value is dead: its last
        # consumer's position, or never for what the caller fetches
        keep = set(eval_node_list) | set(self.param_nodes) \
            | set(self.feed_nodes) | set(self.dataloader_ops)
        last = {}
        for i, node in enumerate(self.topo_order):
            for inp in node.inputs:
                last[inp] = i
        self._free_after = [[] for _ in self.topo_order]
        for node, i in last.items():
            if node not in keep:
                self._free_after[i].append(node)

    def _infer_shapes(self, feed_map):
        """Set ``inferred_shape`` on every node (gradient ops read their
        forward's input shapes from it), as the reference does once per
        feed-shape signature."""
        for node in self.topo_order:
            if node in feed_map:
                shape = tuple(feed_map[node].shape)
            elif isinstance(node, PlaceholderOp):
                shape = tuple(node.shape)
            else:
                shape = node.infer_shape(
                    [inp.inferred_shape for inp in node.inputs])
            node.inferred_shape = shape

    def _ensure_state(self, executor):
        """Create the state of this subgraph's stateful ops that the
        session does not hold yet — 1 for a key naming a variance, else
        0 — and refuse held state (loaded from a checkpoint) whose keys
        or shapes differ from what the op now needs."""
        for node in self.stateful_ops:
            shapes = {k: tuple(shape) for k, shape in node.state_shapes(
                [inp.inferred_shape for inp in node.inputs]).items()}
            held = executor.state.get(str(node.id))
            if held is None:
                executor.state[str(node.id)] = {
                    k: torch.full(shape, 1.0 if "var" in k else 0.0,
                                  dtype=torch.float32,
                                  device=self.config.device)
                    for k, shape in shapes.items()}
            elif {k: tuple(v.shape) for k, v in held.items()} != shapes:
                raise ValueError(
                    f"{node.name}: state {sorted(held)} of shapes "
                    f"{[tuple(v.shape) for v in held.values()]} does not "
                    f"match the op's {shapes}")

    def _ingest(self, value):
        if isinstance(value, NDArray):
            value = value.tensor
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.ascontiguousarray(value))
        # float64 feeds (numpy's default, JSON bodies) compute in f32, as
        # the reference's JAX canonicalizes them with 64-bit mode off
        if value.dtype == torch.float64:
            value = value.to(torch.float32)
        value = value.to(self.config.device)
        dtype = self.config.dtype
        if dtype is not None and value.is_floating_point():
            value = value.to(dtype)
        return value

    def run(self, executor, feed_dict=None, convert_to_numpy_ret_vals=False):
        config = self.config
        feed_dict = feed_dict or {}
        missing = [n.name for n in self.feed_nodes if n not in feed_dict]
        if missing:
            raise ValueError(f"no feed for placeholder(s) {missing}")
        env = {node: self._ingest(feed_dict[node])
               for node in self.feed_nodes}
        for dl in self.dataloader_ops:
            env[dl] = self._ingest(dl.get_arr(self.name))
        key = tuple((tuple(v.shape), v.dtype) for v in env.values())
        if key != self._shapes_key:
            self._infer_shapes(env)
            self._ensure_state(executor)
            self._shapes_key = key

        ectx = ExecContext(training=self.training, seed=config.seed,
                           step=self.step_count, device=config.device,
                           config=config)
        params = {n: executor.params[str(n.id)] for n in self.param_nodes}
        if config.dtype is not None:
            ectx.master_params = params
            params = {n: v.to(config.dtype) if v.is_floating_point() else v
                      for n, v in params.items()}
        ectx.params = params
        ectx.opt_state = executor.opt_state
        ectx.state = {n: executor.state[str(n.id)] for n in self.stateful_ops}
        for opt in self.optimizer_ops:
            ectx.lr = float(opt.optimizer.learning_rate)
        env.update(params)
        with _EXACT_F32_CONVS if config.dtype in (None, torch.float32) \
                else contextlib.nullcontext():
            for i, node in enumerate(self.topo_order):
                if node not in env:
                    env[node] = node.compute([env[n] for n in node.inputs],
                                             ectx)
                for dead in self._free_after[i]:
                    env.pop(dead, None)

        if self.training:
            for node, value in ectx.new_params.items():
                executor.params[str(node.id)] = value
            for node, value in ectx.new_state.items():
                executor.state[str(node.id)] = value
            executor.opt_state = ectx.new_opt_state
            for opt in self.optimizer_ops:
                opt.optimizer.lr_sched.step()
        self.step_count += 1
        results = []
        for node in self.eval_node_list:
            if isinstance(node, OptimizerOp):
                results.append(None)
            elif convert_to_numpy_ret_vals:
                results.append(NDArray(env[node]).asnumpy())
            else:
                results.append(NDArray(env[node], _context_of(config)))
        return results


def _context_of(config):
    dev = config.device
    return cpu(0) if dev.type == "cpu" else gpu(dev.index or 0)


class Executor:
    """Session over one or more eval subgraphs (reference
    executor.py:317-455)."""

    def __init__(self, eval_node_dict, config=None, **kargs):
        if not isinstance(eval_node_dict, dict):
            eval_node_dict = {"default": eval_node_dict}
        self.eval_node_dict = eval_node_dict
        all_eval_nodes = []
        for nodes in eval_node_dict.values():
            for n in nodes:
                if n not in all_eval_nodes:
                    all_eval_nodes.append(n)
        if config is None:
            config = HetuConfig(eval_node_list=all_eval_nodes, **kargs)
        self.config = config

        # parameters: f32 masters (integer parameters keep their dtype)
        # drawn from numpy with the reference's name-seeded draw
        self.params = {}
        self.opt_state = {}
        self.state = {}
        self._param_nodes = {}
        topo = find_topo_sort(all_eval_nodes)
        # stateful ops in creation order: how load_state matches them
        self._stateful_ops = sorted((n for n in topo if n.stateful),
                                    key=lambda n: n.id)
        for node in topo:
            if isinstance(node, PlaceholderOp) and (
                    node.tensor_value is not None
                    or node.initializer is not None):
                value = np.ascontiguousarray(
                    node.initial_value(seed=config.seed))
                self.params[str(node.id)] = torch.from_numpy(value).to(
                    config.device)
                self._param_nodes[str(node.id)] = node
        for nodes in eval_node_dict.values():
            for n in find_topo_sort(nodes):
                if isinstance(n, OptimizerOp):
                    self.opt_state.update(n.optimizer.init_state(
                        {p: self.params[str(p.id)]
                         for p in n.optimizer.params}))
        self.subexecutors = {name: SubExecutor(name, nodes, config)
                             for name, nodes in eval_node_dict.items()}

    def run(self, name="default", eval_node_list=None, feed_dict=None,
            convert_to_numpy_ret_vals=False):
        if isinstance(name, dict) and feed_dict is None:
            feed_dict, name = name, "default"     # positional run(feeds)
        if name not in self.subexecutors and "default" in self.subexecutors:
            name = "default"
        return self.subexecutors[name].run(self, feed_dict,
                                           convert_to_numpy_ret_vals)

    def get_batch_num(self, name="default"):
        """Batches in an epoch of subgraph ``name``: the fewest any of
        its dataloaders gives (None without dataloaders)."""
        return self.subexecutors[name].batch_num

    @property
    def batch_num(self):
        if len(self.subexecutors) != 1:
            raise ValueError("batch_num needs a single subgraph: use "
                             "get_batch_num(name)")
        return next(iter(self.subexecutors.values())).batch_num

    # ------------------------------------------------------------------
    def _by_name(self):
        by_name = {}
        for sid, node in self._param_nodes.items():
            if node.name in by_name:
                raise ValueError(
                    f"two parameters share the name {node.name!r} (node ids "
                    f"{by_name[node.name]} and {sid}): their .npy files "
                    f"would overwrite each other; give the variables "
                    f"distinct names")
            by_name[node.name] = sid
        return by_name

    def save(self, file_path, file_name=None):
        """One ``<name>.npy`` per parameter (the f32 masters) plus
        optimizer slots and op state (keyed by op id) in a sidecar
        pickle — ``hetu_tpu``'s layout (reference executor.py:376-434)."""
        os.makedirs(file_path, exist_ok=True)
        self._by_name()
        for sid, node in self._param_nodes.items():
            np.save(os.path.join(file_path, node.name + ".npy"),
                    NDArray(self.params[sid]).asnumpy())
        sidecar = {
            "opt_state": {k: {s: NDArray(t).asnumpy()
                              for s, t in slots.items()}
                          for k, slots in self.opt_state.items()},
            "state": {k: {s: NDArray(t).asnumpy() for s, t in vals.items()}
                      for k, vals in self.state.items()},
            "id_to_name": {sid: node.name
                           for sid, node in self._param_nodes.items()},
        }
        with open(os.path.join(file_path, file_name or "session.ckpt"),
                  "wb") as f:
            pickle.dump(sidecar, f)

    def load(self, file_path, file_name=None):
        """Read what ``save`` — this package's or ``hetu_tpu``'s — wrote:
        parameters by name, optimizer slots by the sidecar's id -> name
        map, op state as ``load_state`` matches it. A parameter without a
        file keeps its value, with a warning."""
        values = {}
        for node in self._param_nodes.values():
            path = os.path.join(file_path, node.name + ".npy")
            if os.path.exists(path):
                values[node.name] = np.load(path)
            else:
                warnings.warn(
                    f"checkpoint {file_path} has no file for parameter "
                    f"{node.name!r} ({node.name}.npy); keeping its current "
                    f"value", stacklevel=2)
        self.load_params(values)
        ckpt = os.path.join(file_path, file_name or "session.ckpt")
        if not os.path.exists(ckpt):
            return
        # the sidecar is a pickle of plain dicts and numpy arrays written
        # by Executor.save of this package or of hetu_tpu
        with open(ckpt, "rb") as f:
            sidecar = pickle.load(f)
        self.load_state(sidecar["state"])
        node_of = {node.name: node for node in self._param_nodes.values()}
        for key, slots in sidecar["opt_state"].items():
            node = node_of.get(sidecar["id_to_name"].get(str(key)))
            if node is None or node.id not in self.opt_state:
                continue
            mine = self.opt_state[node.id]
            self.opt_state[node.id] = {
                s: torch.as_tensor(np.asarray(v), dtype=mine[s].dtype,
                                   device=mine[s].device)
                for s, v in slots.items() if s in mine}

    def load_state(self, state):
        """Set op state (batch norm's running statistics) from ``{op id:
        {key: array}}``, as an executor of this package or of
        ``hetu_tpu`` holds and saves it. Op ids differ between graphs,
        so ops are matched in creation order: ascending id in ``state``
        against this session's stateful ops by ascending id, which the
        same builders create in the same order. A different number of
        ops raises here; a key or shape an op does not have raises at the
        next run, where shapes are inferred again. Empty ``state`` (saved
        before any step) leaves every op to start afresh."""
        theirs = sorted(state.items(), key=lambda item: int(item[0]))
        if theirs and len(theirs) != len(self._stateful_ops):
            raise ValueError(
                f"state of {len(theirs)} ops for a session with "
                f"{len(self._stateful_ops)} stateful ops "
                f"({[n.name for n in self._stateful_ops]})")
        self.state = {
            str(node.id): {k: torch.tensor(np.asarray(v),
                                           dtype=torch.float32,
                                           device=self.config.device)
                           for k, v in values.items()}
            for node, (_, values) in zip(self._stateful_ops, theirs)}
        for sub in self.subexecutors.values():
            sub._shapes_key = None

    def load_params(self, values):
        """Set parameters from ``{name: array}``; names the session does
        not have are ignored, shapes must match."""
        by_name = self._by_name()
        for name, value in values.items():
            sid = by_name.get(name)
            if sid is None:
                continue
            old = self.params[sid]
            value = np.asarray(value)
            if tuple(value.shape) != tuple(old.shape):
                raise ValueError(f"parameter {name!r}: checkpoint shape "
                                 f"{value.shape} != {tuple(old.shape)}")
            self.params[sid] = torch.as_tensor(value, dtype=old.dtype,
                                               device=old.device)
