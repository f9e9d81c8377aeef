"""The collective pipeline: GPipe as one tick loop over each stage's
device and CUDA stream.

Counterpart of ``hetu_tpu/parallel/collective_pp.py``, where the whole
GPipe schedule is one ``shard_map`` program over a ``stage`` mesh axis:
each device holds one stage's parameters, each tick runs ``lax.switch``
on the stage index, and a ``ppermute`` shifts the boundary to the next
stage with no host in the loop. PyTorch's counterpart of one program
over S devices is one host thread that issues every tick's work to each
stage's own device and stream (``Executor(pipeline_mode="collective")``,
:class:`~.pipeline.PipelineSubExecutor` with ``schedule="collective"``):

* **Ticks.** At tick t stage r runs microbatch t - r (:meth:`lanes`),
  its forward ops through the same walk as the staged runner's, so the
  flash residuals stay in the stage's and microbatch's context. The
  backward is the reverse tick loop over the graph's own gradient ops,
  cotangents crossing back stage by stage. Fill and drain lanes are not
  computed: the reference computes them on zeros and their outputs get
  zero cotangents, so skipping them changes no number.
* **Streams.** Each lane's forward, backward and update run on its own
  stream, so launches from the one thread overlap on the device(s). A
  boundary, and its cotangent back, moves as a device tensor
  (:meth:`send` / :meth:`receive`): a copy to the reader's device where
  that is another card (on the reader's stream, after the sender's),
  an event where the value is complete that the reader's stream waits
  for, and ``record_stream`` so the allocator keeps the memory until
  the reader is done. No host copy and no process group. On the CPU the
  lanes run in turn on the one device.
* **The update.** One update a step over the gradients summed over
  microbatches (the optimizer's ``update_one`` after ``_apply_l2``, as
  the reference's stacked update), the LR scheduler once a step.
  Parameters and slots stay per stage on its device: the reference's
  ``[S, ...]`` stacks are its one program's layout, and the update is
  elementwise.
* **Interleaved schedule** (``virtual_stages`` V > 1): chunk
  ``v*S_dev + r`` lives on device r, and chunk ``v*S_dev + r`` of
  microbatch m runs at tick ``r + v*M + m``, so the schedule takes
  ``V*M + S_dev - 1`` ticks. The ``S_dev - 1 -> 0`` wraparound arrives
  ``M - S_dev + 1`` ticks before its reader's turn and waits in the
  reader's inbox (the reference's ``[M - S_dev + 1]`` ring buffer),
  which is why M >= S_dev.

The knobs of ``pp_options``:

* ``feed_mode``: ``"sharded"`` (default) gives each stage only its own
  feeds, on its own device, in the layout of the first step: a feed
  whose shape or dtype changes after is refused, as the reference's
  packed byte rows refuse it. ``"replicated"`` copies every stage's
  feeds to every stage's device.
* ``boundary_dtype="bf16"``: the boundary and its cotangent cross in
  bf16; compute, loss, gradients and optimizer stay in the session's
  dtype. Losses stay within :data:`BOUNDARY_RTOL` of the staged run's.
* ``fuse_ticks`` and ``unroll_fill_drain`` are accepted and validated as
  the reference's. There they shape the compiled loop; here they only
  group the host's tick iterations (:meth:`tick_groups`) and change no
  launch and no number.

With telemetry on (``telemetry=``, the session's), a step is one
``cpp_dispatch`` span (ticks, fill, drain, stages, microbatches) over
one ``cpp_tick`` span per tick and lane (``stage`` the chunk,
``microbatch``, ``phase`` ``fwd`` / ``bwd``). They are host spans: a
tick's span closes when its lane's work is issued, and none waits on a
stream.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from .. import telemetry as _telemetry

__all__ = ["CollectiveGPipe", "BOUNDARY_RTOL"]

# the declared loss tolerance of a bf16 boundary, the reference's
BOUNDARY_RTOL = 5e-3


def _canon_boundary_dtype(boundary_dtype):
    if boundary_dtype in (None, "fp32", "f32", "float32"):
        return None
    if boundary_dtype in ("bf16", "bfloat16", torch.bfloat16):
        return torch.bfloat16
    if isinstance(boundary_dtype, torch.dtype):
        return boundary_dtype
    return getattr(torch, str(boundary_dtype))


@dataclass
class _Boundary:
    """A boundary value in flight: the tensor as it crosses, the dtype
    it is read in, and the event its reader's stream waits for."""
    value: torch.Tensor
    dtype: torch.dtype
    ready: object = None


class CollectiveGPipe:
    """The schedule of the collective pipeline over ``num_stages`` stages
    (chunks, under V > 1) and ``num_microbatches`` microbatches: which
    (chunk, microbatch) each tick runs, each lane's stream, the
    boundary's crossing and the feed layout. The pipeline runs the
    stages' walks in its order."""

    def __init__(self, num_stages, num_microbatches, feed_mode="sharded",
                 fuse_ticks=2, unroll_fill_drain=True, boundary_dtype=None,
                 virtual_stages=1, telemetry=None):
        if feed_mode not in ("sharded", "replicated"):
            raise ValueError(
                f"feed_mode must be 'sharded' or 'replicated', got "
                f"{feed_mode!r}")
        self.S = int(num_stages)        # chunks: the user's stages
        self.M = int(num_microbatches)
        self.V = max(1, int(virtual_stages or 1))
        if self.S % self.V != 0:
            raise ValueError(
                f"virtual_stages={self.V} must divide the stage count "
                f"{self.S} (each device owns exactly V chunks)")
        self.S_dev = self.S // self.V   # devices (lanes)
        if self.V > 1:
            if self.S_dev < 2:
                raise ValueError(
                    "interleaved schedule needs >= 2 devices after "
                    f"folding {self.S} stages by V={self.V}")
            if self.M < self.S_dev:
                raise ValueError(
                    f"interleaved schedule requires M >= device count "
                    f"({self.M} < {self.S_dev}): the S-1 -> 0 wraparound "
                    f"buffer depth is M - S + 1; raise num_microbatches "
                    f"or drop virtual_stages")
        self.feed_mode = feed_mode
        self.fuse_ticks = max(1, int(fuse_ticks))
        self.unroll_fill_drain = bool(unroll_fill_drain)
        self.boundary_dtype = _canon_boundary_dtype(boundary_dtype)
        self.streams = [None] * self.S_dev     # a lane's, on a card
        self._layout = None
        self.telemetry = (telemetry if telemetry is not None
                          else _telemetry.NULL)

    @property
    def n_ticks(self):
        """Schedule length in ticks (V*M + S_dev - 1; the V=1 case is
        the classic M + S - 1)."""
        return self.V * self.M + self.S_dev - 1

    def lane(self, chunk):
        """The device (lane) a chunk runs on: chunk ``v*S_dev + r`` on
        r."""
        return chunk % self.S_dev

    def lanes(self, t):
        """[(chunk, microbatch)] that tick ``t`` runs, by lane: lane r
        runs position u = t - r of its V·M (chunk group, microbatch)
        turns; a lane outside them idles."""
        out = []
        for r in range(self.S_dev):
            u = t - r
            if 0 <= u < self.V * self.M:
                v, m = divmod(u, self.M)
                out.append((v * self.S_dev + r, m))
        return out

    def tick_groups(self):
        """The host's iterations over the ticks: the S_dev - 1 fill
        ticks one at a time (``unroll_fill_drain``), the steady ticks
        ``fuse_ticks`` at a time, the drain one at a time, as the
        reference lays its loop out (V = 1; under V > 1 its loop is
        ``fuse_ticks`` at a time throughout). Every tick once, in
        order."""
        T, K = self.n_ticks, self.fuse_ticks
        if self.V == 1 and self.unroll_fill_drain:
            n_pre = min(self.S_dev - 1, T)
            n_mid = max(self.M - self.S_dev + 1, 0)
        else:
            n_pre, n_mid = 0, T
        groups = [[t] for t in range(n_pre)]
        end = n_pre + n_mid
        groups += [list(range(t, min(t + K, end)))
                   for t in range(n_pre, end, K)]
        groups += [[t] for t in range(end, T)]
        return groups

    def run(self, forward, backward):
        """The step's ticks: ``forward(chunk, m)`` for every lane of
        every tick in order, then ``backward(chunk, m)`` over the ticks
        in reverse (the transpose of the forward loop)."""
        groups = self.tick_groups()
        tel = self.telemetry
        # disabled: the shared no-op span, nothing allocated that lives
        span = tel.span if tel.enabled \
            else lambda *a, **k: _telemetry._NULL_SPAN
        fill = min(self.S_dev - 1, self.n_ticks)
        with span("cpp_dispatch", ticks=self.n_ticks, fill=fill,
                  drain=fill, fuse_ticks=self.fuse_ticks, stages=self.S,
                  microbatches=self.M, virtual_stages=self.V):
            for group in groups:
                for t in group:
                    for chunk, m in self.lanes(t):
                        with span("cpp_tick", tick=t, stage=chunk,
                                  microbatch=m, phase="fwd"):
                            forward(chunk, m)
            for group in reversed(groups):
                for t in reversed(group):
                    for chunk, m in reversed(self.lanes(t)):
                        with span("cpp_tick", tick=t, stage=chunk,
                                  microbatch=m, phase="bwd"):
                            backward(chunk, m)

    def stack_stage_values(self, per_stage):
        """One per-stage value list in the schedule's layout: [S] for
        V=1, [S_dev][V] with chunk ``v*S_dev + r`` at ``[r][v]`` under
        V > 1, as the reference stacks its parameters (tensors are
        stacked, anything else nested in lists)."""
        per_stage = list(per_stage)
        if self.V == 1:
            rows = per_stage
        else:
            rows = [[per_stage[v * self.S_dev + r] for v in range(self.V)]
                    for r in range(self.S_dev)]
        if per_stage and isinstance(per_stage[0], torch.Tensor):
            return torch.stack([torch.stack(r) if isinstance(r, list)
                                else r for r in rows])
        return rows

    # -- streams and the boundary ----------------------------------------
    def bind(self, lane_devices):
        """A stream for each lane whose device is a card, made once."""
        for r, dev in enumerate(lane_devices):
            if dev.type == "cuda" and self.streams[r] is None:
                self.streams[r] = torch.cuda.Stream(dev)

    def on_lane(self, chunk):
        """The context a chunk's work is issued in: its lane's stream."""
        s = self.streams[self.lane(chunk)]
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def begin(self):
        """Every lane's stream waits for what its device's current
        stream queued before the step (the feeds, the user's writes)."""
        for s in self.streams:
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(s.device))

    def end(self):
        """Each device's current stream waits for its lanes' work, so
        the losses, parameters and slots read after the step are the
        step's."""
        for s in self.streams:
            if s is not None:
                torch.cuda.current_stream(s.device).wait_stream(s)

    def send(self, value, chunk, device):
        """``value`` (made on the current stream) on its way to ``chunk``
        on ``device``: in the boundary dtype where one is set, with an
        event where it is complete on a card. A copy to another card is
        made on the reader's stream (the copy waits for the sender's),
        so nothing of the step is allocated on a device's default
        stream."""
        dtype = value.dtype
        if self.boundary_dtype is not None and value.is_floating_point():
            value = value.to(self.boundary_dtype)
        reader = self.streams[self.lane(chunk)]
        with torch.cuda.stream(reader) if reader is not None and \
                value.device != reader.device else contextlib.nullcontext():
            value = value.to(device, non_blocking=True)
            ready = None
            if value.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(value.device))
        return _Boundary(value, dtype, ready)

    def receive(self, box):
        """The boundary's value for the reader's stream (current), in
        the dtype it was made in."""
        value = box.value
        if box.ready is not None:
            stream = torch.cuda.current_stream(value.device)
            stream.wait_event(box.ready)
            value.record_stream(stream)
        return value.to(box.dtype)

    # -- the feed layout -------------------------------------------------
    def check_feeds(self, layout):
        """Hold each stage's feeds (``layout``: per stage, each feed's
        (stacked [M, mb, ...] shape, dtype)) to the first step's under
        ``feed_mode="sharded"``."""
        if self.feed_mode != "sharded":
            return
        if self._layout is None:
            self._layout = layout
            return
        for s, (got, built) in enumerate(zip(layout, self._layout)):
            if len(got) != len(built):
                raise ValueError(
                    f"collective pipeline stage {s} got {len(got)} feeds; "
                    f"built for {len(built)}")
            for j, (g, b) in enumerate(zip(got, built)):
                if g != b:
                    raise ValueError(
                        f"collective pipeline feed changed shape/dtype "
                        f"after build: stage {s} feed {j} is {g[0]}/{g[1]}, "
                        f"built for {b[0]}/{b[1]} — keep the batch size "
                        f"fixed or rebuild the executor")
