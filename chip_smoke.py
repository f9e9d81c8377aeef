#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``hetu_tpu_torch``).

    python3 chip_smoke.py [--seed N] [--out FILE]

Run from a checkout of the repository on a machine with one NVIDIA GPU
and the CUDA toolkit. It builds every hand-written kernel from the
sources in the checkout, drives the port's main paths — GPT-2-small
(full width, random weights from a seed) served through
``ContinuousBatchingEngine``; the same model served through the
request-level plane (HTTP frontend, ``ReplicaRouter`` over two
``MicroBatcher``s, ``GPTDecoder`` over an ``InferenceSession`` restored
from a checkpoint); the same model trained with Adam in bf16 through
``Executor.run`` (B=8, S=1024); BERT-base MLM + NSP pre-training (B=64,
S=128, padded rows, dropout 0.1); BERT-small at S=2048 (B=8); the CNN
zoo's VGG-16 (full width) and ResNet-18 trained in f32 from dataloader
ops (B=128); ``digits_cnn`` trained to accuracy on the checked-in digits
through the port's ``examples/cnn_main.py``; the CTR models and NCF
trained on bench.py's traffic with their tables on the card, NCF to
retrieval accuracy through ``examples/rec_main.py``; the seq2seq
Transformer-base trained in f32, and to the reversal bar through
``examples/transformer_main.py``; GCN and GraphSAGE trained full-batch
on an OGB-arxiv-sized graph, through ``examples/gcn_main.py``, and on
sampled subgraphs through ``examples/sampled_sage.py``; WDL at Criteo
widths trained in the PS and Hybrid modes against the port's parameter
server, and served from it; fleets of PS servers and workers started by
the port's launcher, every worker on the card; GPT-2-small trained in
four pipeline stages on the card (GPipe and PipeDream 1F1B) and across
two launcher processes; its 12 blocks as a uniform chain under the
collective pipeline (one tick loop over four stages' streams, and
interleaved at V=3); the same model trained data parallel by two
launcher processes, split at tp=2 by two, and in two stages x tp=2 by
four; the same model, and BERT-small at S=2048, trained sequence
parallel by two (the zigzag ring, Ulysses, the masked ring); the same
model under a tuple context of two devices in one process (thread
ranks); the same model planned over two ranks by the cost-model
planner (a CostDB measured on the card, its finalists timed, the chosen
plan trained through ``Executor(parallel="auto")``, and a launcher job's
``--autoplan``); a 2-layer GCN through ``distgcn_15d_op`` at (gr, gc) = (2, 2)
as four launcher ranks and as four thread ranks; the port's runner zoo
through its launcher and its BERT example; WDL's
Hybrid mode across two workers; with telemetry on, the training
step, the request-level plane and a two-process pipeline job; and with
the training health monitor on, the training step and a two-worker job
with a NaN injected; the training step under the preflight analysis
(``validate="error"``) and the launcher's ``--preflight`` of a
two-process pipeline job — checks
every kernel
against its plain PyTorch version on the card, and prints one JSON
object per line (``--out`` also writes them to FILE):

* ``device``  the card (name and power limit from nvidia-smi), torch and
  CUDA versions;
* ``build``   seconds spent compiling each kernel source, and ptxas's
  registers and spills for every kernel instantiation;
* ``kernel_shapes`` per kernel, one row per checked shape: error
  against the plain version (for K3/K4 also row by row), the route the
  kernel took (``tc`` or ``simt``), median times of the kernel, of the
  plain version and of the one PyTorch call computing the same
  function, the least time the card could take (``bound_ms``), and the
  wrapper's host time;
* ``check_faults`` the forward and gradient checks against faults
  planted in the kernels' output at the training shape: each must fail
  its check;
* ``serve``   per pass: tokens/s, TTFT p50, decode step ms, kernel
  launches, and the token-parity check against the plain attention;
* ``serve_dense`` the request-level plane under 16 closed-loop HTTP
  clients: requests/s, tokens/s, client latency p50/p95, mean batch
  occupancy, requests per replica, prefill and decode-step ms, the
  no-cache recompute tokens/s through ``InferenceSession.predict``, K1's
  launches on its two paths there (the decoder's prefill, the session's
  graph forward; all on ``simt``), one profiled tick, peak memory, and
  the parity checks (HTTP against a direct ``generate``: one request
  served alone, and eight of the timed replies against one batch of 8;
  the cached chain against the no-cache one; the decoder, and the
  session over inputs that fill its 1024 bucket, with the plain K1);
* ``train``   tokens/s, step ms p50, the loss of every step, kernel
  launches (K2, K3 and K4 also by route: all on the tensor-core ``tc``
  route), peak memory, the device idle share and time by kernel
  category of one profiled step, and the step-1 parity check against
  the plain K2–K4;
* ``pp_gpipe``, ``pp_1f1b`` the ``train`` model in four pipeline stages
  on ``ht.gpu(0)``..``gpu(3)`` (all the one card), M=4 microbatches of 2
  rows: tokens/s, step ms p50 beside ``train``'s, the losses, peak
  memory, the analytic bubble, one profiled step (idle share, device
  time by kernel category), K2/K3/K4 launches (12·M a step, all on
  ``tc``, K1 none); the checks: step 1 against the plain K2–K4, GPipe's
  step 1 against the single-device executor in f32 (the bf16 difference
  reported beside, with the single-device executor's own against four
  microbatches), 1F1B's at M=1 against it in bf16, and 1F1B's weight
  stash (one step at M=4 against Adam applied to each microbatch's
  gradient at the initial weights in turn; a backward reading the
  current weights must fail it);
* ``pp_fleet`` the same model in two worker processes started by
  ``python hetu_tpu_torch/run_launcher.py`` (``spmd: true``; each
  ``python chip_smoke.py --pp-worker SPEC``), two stages each, GPipe
  then 1F1B, boundaries crossing the host channel in bf16: the losses of
  the rank that owns the loss against the in-process passes', each
  rank's step ms, channel bytes and seconds a step, peak memory and
  launches (6·M a step each of K2/K3/K4);
* ``collective_gpt`` the ``train`` model's 12 blocks (no embeddings or
  LM head: a feed x [8, 1024, 768] in, a sparse cross-entropy of the
  last block's output against labels in [0, 768) out) as a uniform
  chain of four stages on ``ht.gpu(0)``..``gpu(3)`` under
  ``pipeline_mode="collective"`` (one tick loop over the stages'
  streams), M=4, bf16: tokens/s, step ms p50 beside the staged GPipe
  runner's, ``pp_gpipe``'s and ``train``'s, peak memory, K2/K3/K4
  launches (12·M a step, all on ``tc``), one profiled step; the checks:
  step 1 and every loss against ``gpipe=True`` on the same chain (one
  bf16 ulp; Adam's first moments of stage 0's qkv and of the last
  stage's MLP projection within 2e-2 of their largest element), a fresh
  executor's three losses bit-equal, the interleaved schedule (12
  one-block chunks at V=3) against ``gpipe=True`` over the same 12
  stages, and ``boundary_dtype="bf16"`` within ``BOUNDARY_RTOL``;
* ``collective_parity`` the chain at 64 wide (4 stages of 2 blocks,
  S=512, M=8) in f32, 3 Adam steps, against ``gpipe=True``: losses 1e-5
  relative, every weight 1e-4 of its largest element; its bf16
  boundary within ``BOUNDARY_RTOL``;
* ``dp_gpt`` the ``train`` model trained data parallel by two ranks of
  one launcher job (``spmd: true``; each ``python chip_smoke.py
  --dp-worker SPEC``) on the one card, over gloo, 4 of the 8 rows each,
  the dense gradients in 25 MiB buckets: tokens/s of the global batch,
  step ms p50 beside ``train``'s, per rank the ms, calls and bytes a
  step of the dense and sparse collectives, peak memory, launches a
  step (K2/K3/K4 12 each, all ``tc``), the card's used memory while the
  job runs; the checks: the step-1 global loss against ``train``'s, every
  weight identical across the ranks;
* ``dp_parity`` the model at 2 layers in f32 (``simt`` K2–K4), global
  batch 4, 3 Adam steps, two ranks against one process: losses, Adam's
  first moments and the weights;
* ``autoplan`` the ``train`` model, rows and dtype planned over two
  ranks (``parallel/autoplan.py``): a fresh CostDB measured on the card
  (h2d, d2h; allreduce and p2p between two thread ranks over gloo and
  the pipe channel: the points and fitted curves), one step's ops
  profiled one by one (attention's eval forward on K1, 12 launches), the
  top four finalists each realized and timed (one warm-up, two steps:
  every candidate's predicted and measured ms, the coverage split), the
  chosen plan trained 3 steps through ``Executor(parallel="auto")``
  (each step's loss against ``train``'s within the tolerance of the
  plan's mode, falling; K2/K3/K4 12 a step in each rank that runs
  attention, all ``tc``), and a 2-rank launcher job of a small GPT,
  its ops profiled into the same CostDB first: ``--autoplan`` (exit 0,
  ``autoplan: OK``, the report, every op's cost measured), then the job
  on the report's plan, 2 steps, both ranks agreeing, its losses
  against one process's; the phase's wall;
* ``dp_gpt_local`` the ``train`` model and rows under ``ht.context((
  ht.gpu(0), ht.gpu(1)))`` with ``comm_mode="AllReduce"`` in this
  process: two thread ranks on the one card, 4 rows each, gloo groups
  of their own: step ms p50 beside ``dp_gpt``'s, launches a step in
  each thread rank (K2/K3/K4 12 each, all ``tc``, counted by rank), the
  collectives a step by rank; the checks: the step-1 loss against
  ``dp_gpt``'s, every weight the same on both ranks;
* ``tp_gpt`` the ``train`` model split by the JAX package's default
  rules at tp=2 (``compile_rules`` + ``apply_rules``: each block's four
  weights by columns, the position table by rows; the odd vocabulary
  leaves the token table and the LM head whole) and trained by two
  ranks of one launcher job (``spmd: true``; each ``python chip_smoke.py
  --tp-worker SPEC``) on the one card, over gloo, all 8 rows each, at
  hidden dropout 0.1: tokens/s, step ms p50 beside ``train``'s, per
  rank the calls, bytes and ms a step of the all-gathers and the
  all-reduces, the values moved between layouts by op type, peak
  memory, the parameter and slot bytes against one process's, launches
  a step (K2/K3/K4 12 each, all ``tc``), the card's used memory while
  the job runs; the checks: step 1 at dropout 0 against one process at
  the same weights and rows (the loss, and Adam's first moment of layer
  0's qkv, each rank's columns, and of the LM head), every replicated
  weight the same on both ranks after the timed steps, every split one
  at its shard's shape;
* ``tp_parity`` the model at 2 layers in f32 (``simt`` K2–K4), batch 4,
  3 Adam steps at dropout 0, two TP ranks against one process (the
  ``dp_parity`` reference): losses, Adam's first moments and the
  weights, each gathered whole;
* ``pp_tp_gpt`` the same model in two pipeline stages of six blocks,
  each stage's context a tuple of two worker devices and split at tp=2
  by the default rules (``models.staged_gpt`` + ``compile_rules`` +
  ``apply_rules``), trained under GPipe at M=4 by four ranks of one
  launcher job on the one card (each ``python chip_smoke.py
  --pp-tp-worker SPEC``; gloo inside the stages, the pipe channel
  between them): step ms p50 and tokens/s, per rank the collectives of
  its stage a step (calls, bytes, ms), the pipe channel's bytes, the
  values moved by op type and the ops computed whole, parameters and
  Adam slots against one process's and a ``tp_gpt`` rank's, peak memory,
  launches a step (K2/K3/K4 24 each, all ``tc``) and one profiled
  step's kernel time on rank 0; the checks: step 1 against the same
  stages in one process (the loss within one bf16 ulp; Adam's first
  moment of layer 0's qkv, each stage-0 rank's columns, and of the LM
  head), every replicated weight the same on both ranks of its stage,
  every split one at its shard's shape;
* ``pp_tp_parity`` the same plan at 2 layers in f32, batch 4, 3 Adam
  steps under GPipe and under 1F1B (M=4) against the same stages in one
  process: losses, Adam's first moments and the weights gathered whole,
  at ``tp_parity``'s tolerances;
* ``bert``, ``bert_long`` the same for the two BERT passes, with MFU
  against the bf16 dense peak and the host time of one step by op type
  (the composed attention backward's and dropout's among them); BERT-base
  launches K1 12 times a step, all on ``tc``, and no K2–K4; BERT-small at
  S=2048 launches K2, K3 and K4 4 times a step each, all on ``tc``, and
  no K1; step-1 parity against the plain kernels; for ``bert_long`` also
  the errors of both against the same step in f32 (the plain versions,
  reported, not gated);
* ``bert_example`` ``hetu_tpu_torch/examples/train_hetu_bert.py`` as a
  user runs it (BERT-base, S=128, B=64, 20 steps, bf16): its tokens/s,
  the losses (finite), K1 12 launches a step, all ``tc``, K2-K4 none;
* ``runner_zoo`` the port's parallel-config zoo through ``python
  hetu_tpu_torch/run_launcher.py``: the MLP and CNN bases under ``config1``,
  then ``test_mlp_mp --split middle``, ``test_mlp_pp``, ``test_mlp_mp_pp
  --split left`` and ``test_cnn_mp --split middle`` under ``config4``
  (one process driving four devices of the one card as thread ranks),
  held to the bases by the zoo's ``validate_results.py`` (rtol 1e-4);
* ``cnn_vgg16``, ``cnn_resnet18`` images/s, step ms p50, the loss of
  every step, MFU against the f32 peak, peak memory, the device idle
  share and device time by kernel category and by op type (and op
  category: conv, batch norm, gemm, pool, elementwise) of one profiled
  step, the host time of one step by op type, the launches of K1-K4
  (none: this path has no Pallas kernel), and the step-1 parity of the
  card against the CPU on one B=8 batch;
* ``cnn_digits`` held-out accuracy (at least the JAX package's 0.96),
  the epoch time and steps/s of ``cnn_main.run()``, K1-K4 launches
  (none);
* ``ctr`` per model (WDL, DeepFM, DCN, DC on a 1,000,000 x 128 table on
  the card, bench.py's zipf(1.3) id traffic, B=128, SGD, steps through
  ``Executor.run_batches``): samples/s, step ms p50, the losses, the
  table's bytes and the peak memory of the steps (held below 1.5 x the
  table plus the dense work: SGD updates the table in place), K1-K4
  launches (none), the step-1 parity of the card against the CPU from
  the same initial values, and for WDL one profiled step (idle share,
  device time by kernel category and op type, host time by op type);
* ``ncf`` the same for NeuMF at ML-25M's cardinalities (B=1024);
* ``ncf_hr`` HR@10 and NDCG@10 of ``rec_main.worker`` (at least the
  JAX package's 0.5 and 0.25) and its steps/s;
* ``transformer`` Transformer-base (vocab 32000, 6 + 6 blocks, d_model
  512, B=32, lengths 100, dropout 0.3) trained with Adam in f32 on the
  reversal task: target tokens/s, step ms p50, MFU against the f32
  peak, the losses, peak memory, one profiled step, K1-K4 launches
  (none: attention is composed, as in the reference), and the step-1
  parity at dropout 0 (B=4) of the card against the CPU;
* ``transformer_reverse`` ``transformer_main.main()``'s reversal-task
  loss (below the JAX package's 5.0) and its tokens/s;
* ``gcn``, ``graphsage`` full-batch training at OGB-arxiv scale
  (bench.py's graph: 169,343 nodes, 1,354,709 entries, features 128,
  hidden 256, 40 classes; SGD 0.1, f32, the graph pinned on the card):
  epoch ms p50, epochs/s, MFU (the GEMMs' 3 x forward FLOPs and 2 x nnz x
  F for every SpMM, against the f32 peak), the losses, peak memory, the
  host's queueing time against the device's span of an epoch (CUDA
  events), one profiled epoch (idle share, device time by kernel
  category and by op type and op category, the sparse one among them),
  the host time of one epoch by op type, K1-K4 launches (none), and the
  step-1 parity of the card against the CPU from the card's initial
  values;
* ``spmm`` one csrmm at [169343 x 169343] . [169343 x 256]: the
  formulation in use (gather + scale + sorted segment-sum) against
  cuSPARSE's CSR SpMM on the same inputs, device ms of each (and of the
  gather alone, and of the product summed by ``index_add_``);
* ``distgcn`` a 2-layer GCN (128 -> 256 -> 40, f32, SGD) through
  ``distgcn_15d_op`` on the ``gcn`` graph, (gr, gc) = (2, 2), trained by
  four ranks of one launcher job on the one card (each ``python
  chip_smoke.py --distgcn-worker SPEC``): epoch ms p50 beside ``gcn``'s,
  per rank the ring hops, gc sums and gr gathers an epoch (calls, bytes,
  ms); the checks: each rank's step-1 loss and W1, W2 gradients against
  the one-process ``csrmm_op`` model at the same weights, every weight
  the same on the four ranks, ``dist_gcn_spmm`` alone against csrmm_op
  at F=128;
* ``distgcn_local`` the same model as four thread ranks of this process
  (``mesh=`` a mesh built outside a job): epoch ms p50, and its losses
  against ``distgcn``'s;
* ``gcn_example`` ``gcn_main.run()`` at the reference example's graph:
  each epoch's loss and accuracy against the JAX package's CPU run;
* ``gnn_sampled`` ``sampled_sage.main()`` (a sampled subgraph through
  ``GNNDataLoaderOp`` every step): the loss (below the JAX package's
  0.5), seed nodes/s and steps/s;
* ``ps_wdl`` WDL at Criteo widths (a 1,000,000 x 128 table, bench.py's
  zipf traffic, B=128) trained in the PS mode with the device cache
  (cache_bound 100, bf16 drains, the dense weights on the unified HET
  path) against the port's C++ parameter server on the host, one server
  and one worker, in run_batches blocks of 100: samples/s, step ms p50,
  phase_breakdown() in ms a step, the cache's hits, misses, evictions,
  pushed and pulled rows, the host's time to queue a block against the
  device's span of it (CUDA events), peak memory, the server's RSS
  (idle, with the table registered, after training), K1-K4 launches
  (none), and the parity of its first 200 steps against
  a CPU twin on a server of its own (losses, and the server's rows
  after drain());
* ``ps_wdl_host`` the host path (no cache; ASP and BSP): samples/s and
  the host_pull, sync_push and prefetch phases a step;
* ``ps_serve`` the BSP-trained WDL's eval graph served from the server
  through ``InferenceSession(comm_mode="PS")`` with an LRU row cache:
  requests/s, latency p50, the cache's hit rate, and its predictions
  against the same session over a dense table on the card;
* ``hybrid_wdl`` comm_mode="Hybrid" with the device cache: samples/s,
  step ms, phases, cache counters;
* ``ps_fleet`` fleets of (servers, workers) = (1, 1), (1, 2), (2, 2)
  and (4, 4) started by ``python hetu_tpu_torch/run_launcher.py`` (each
  worker ``python chip_smoke.py --fleet-worker SPEC``, a process of its
  own on the one card, placed by ``ht.rgpu("localhost", rank)``) on
  ``ps_wdl``'s configuration and traffic (ids from seed + rank), one
  warm-up and 3 timed blocks of 100 a worker under ASP: the aggregate
  samples/s (samples of all workers / the slowest worker's timed
  window), each worker's step p50, phases, cache counters (the rows
  refreshed from the other workers' pushes among them), peak memory and
  K1-K4 launches (none), the card's used memory while the fleet runs,
  each server's RSS idle, registered and after training and whether it
  maps libtorch (it must not), the host's cores; then the BSP host-path
  fleet (2, 2), 50 steps, against the same fleet with its workers on the
  CPU (losses and the touched server rows, as ``ps_wdl``'s parity). A
  fleet that does not come up, a worker that fails or a server that
  maps libtorch fails the run;
* ``hybrid_fleet`` WDL in the Hybrid mode across two worker processes
  of one job (each ``python chip_smoke.py --hybrid-worker SPEC``) and
  one server: the dense weights all-reduced over gloo, the table through
  each worker's device cache, the global batch of two ``ps_wdl``
  streams: samples/s, per worker step p50, phases and the collectives a
  step, losses falling, the server rows moved, the dense weights the
  same on both ranks; then the host path under BSP against the same job
  with CPU workers;
* ``sp_gpt`` the ``train`` model under ``GPTConfig(sequence_parallel=
  "ring")`` (the zigzag causal ring) and ``"ulysses"``, and
  ``sp_bert_long`` the ``bert_long`` model under ``BertConfig(
  sequence_parallel=True)`` (a masked, non-causal ring), each trained by
  two ranks of one launcher job (``spmd: true``; each ``python
  chip_smoke.py --sp-worker SPEC``) on the one card over an ``{"sp": 2}``
  mesh, over gloo, all 8 rows each and half of each sequence, at
  dropout 0.1: step ms p50 beside the one-process line's, tokens/s,
  per rank the ring hops, all-to-alls, gathers and host staging a step
  (calls, bytes, ms), peak memory, launches a step by route (K2/K3/K4 36
  each for the ring, 12 for Ulysses, 8 for BERT's ring, all ``tc``) and
  the composed blocks (none); the checks: step 1 at dropout 0 against
  one process at the same weights and rows (the loss, and Adam's first
  moments of layer 0's attention weights and of the LM head / MLM
  transform) and against the same job with the plain K2-K4 in the
  blocks, every weight the same on both ranks after the timed steps;
* ``sp_parity`` the GPT at 2 layers (ring and Ulysses) and BERT-small at
  1 layer in f32 (``simt`` K2-K4), 3 Adam steps, two sp ranks against
  one process: losses, Adam's first moments and the weights;
* ``telemetry_train`` the ``train`` model and rows in two executors
  over one graph, one with ``telemetry=<dir>`` and ``log_path``, one
  with telemetry off, 8 steps each interleaved: the traced and untraced
  step p50 and their ratio, and the checks (losses bit-equal, the trace
  valid with one ``step`` span a run, ``h2d_transfer`` and ``h2d_bytes``
  the feeds' bytes, ``step_wall_ms``, the memory gauges beside
  ``torch.cuda.max_memory_allocated``, a step-log line a step, K2/K3/K4
  12 a step on ``tc``; two more steps under ``profiler.trace`` whose
  Chrome trace names the three ``tc`` kernels 24 times each);
* ``telemetry_serve`` ``serve_dense``'s plane with one enabled
  Telemetry, 4 clients x 4 requests: ``/metrics`` (200, the serving
  histograms, its latency), ``/v1/requests``, ``/stats``, every request
  recorded at every hop, ``requests_rank0.json`` flushed, the replies
  against a decoder with telemetry off, K1 on ``simt``; then an engine
  leg (a ContinuousBatchingEngine over the same session and Telemetry,
  8 requests) whose request timelines ``doctor_serve`` reads;
* ``telemetry_job`` a two-rank launcher job of two GPipe stages (2
  layers, 1 + 2 steps; each ``python chip_smoke.py --telemetry-worker
  SPEC``) with ``--telemetry --watch``, then without: the merged trace
  through ``python -m hetu_tpu_torch.telemetry.check``, spans of both
  ranks, ``p2p_*`` / ``pp_*`` spans, ``pp_bubble_fraction``, both
  metrics files, both step timelines and a fleet report with no
  fault-sized skew, the losses equal to the untraced job's;
* ``doctor_train``, ``doctor_serve``, ``doctor_job`` the perf doctor
  over those three directories: every step window (every request)
  conserved, the buckets in ms a step beside ``telemetry_train``'s
  profiled device idle share, the measured bubble fraction beside the
  analytic one, the serving TTFT p50;
* ``fleet_job`` GPT-2-small's 12 blocks in two GPipe launcher processes
  (``--watch-worker``; M=4 of B=2, 1 + 4 steps) under ``--telemetry
  --watch --hang-timeout 120``, rank 1 slowed by
  ``HETU_FAULT_SLOW_RANK`` for 0.75 of ``pp_fleet``'s GPipe p50: the
  live ``fleet_report.json``, ``python -m
  hetu_tpu_torch.telemetry.fleet`` and the black box name rank 1, with
  its skew; the doctor's buckets a rank; K2/K3/K4 24 a step a rank on
  ``tc``;
* ``health_train`` a third executor interleaved with
  ``telemetry_train``'s two, the health monitor at every_n=2: its losses
  bit-equal to the untraced ones, records at steps 2, 4, 6, 8 with every
  parameter tensor, each grad norm and update ratio within 1e-5 of a
  plain f32 recomputation from the step's gradients and weights, K2/K3/K4
  12 a step on ``tc``; the monitored and untraced step p50, their ratio
  and the monitor's ms a sample (reported); then a NaN set in an f32
  master before step 3 under ``action="dump"``: the trip at step 4, the
  last-good record at 2, the flight dump, and the health CLI's
  ``first_bad_step``;
* ``health_job`` the reference's acceptance run on the card: two
  launcher workers (``--health-worker``) of the 12-16-4 MLP with
  ``--telemetry --health every_n=5,action=dump`` and a NaN at step 7:
  both ranks' records at 5 and 10, their trips at 10 naming a layer, the
  last-good files, and ``first_bad_step`` 10 from ``python -m
  hetu_tpu_torch.telemetry.health`` and ``.blackbox``;
* ``preflight_train`` the ``train`` model and rows under
  ``Executor(validate="error")``: the report's codes (no error), the
  host seconds of ``analyze``, 3 steps bit-equal to an unvalidated
  executor's with K2/K3/K4 12 a step on ``tc``, the memory pass's HT402
  breakdown beside the steps' peak memory, the budget read from the
  card, HT401 raised before any weight reaches the card at a tenth of
  that peak, and the graph's build time with and without the
  construction-site frame walk;
* ``numerics_train`` ``preflight_train``'s graph, rows and unvalidated
  losses under the numerics verifier: ``analyze`` with HT8xx (codes,
  seconds, no error), a ``RangeRecorder`` at every_n=1 over 3 steps
  bit-equal to the unvalidated losses with K2/K3/K4 12 a step on
  ``tc``, ``soundness_pass`` with no HT810 and every
  ``FlashAttentionOp`` checked against the hull of v, the recorded and
  unrecorded step ms and ``sample()``'s ms; ``python -m
  hetu_tpu_torch.analysis.rangecheck mlp wdl_adult`` in process on the
  card (exit 0) and ``check_zoo`` clean;
* ``efficiency_train`` the same graph, rows and unvalidated losses
  under the efficiency lint and perfcheck: a CostDB measured on the card
  (the comm sweep, ``profile_ops``), the HT902 card-model sweep (GEMM
  times, granules, rates, bf16's misalignment share, the copy rate), a
  ``validate="error"`` session with telemetry traced 8 steps
  (``analyze`` with HT9xx, no error; losses bit-equal; K2/K3/K4 12 a
  step on ``tc``), its topo order priced against the measured step and
  held to the doctor's buckets (no HT910) by
  ``perfcheck.perfcheck_session``, an f32 and a bf16 HT902 fixture held
  likewise and against what aligning their GEMM measurably saves, the
  HT904 A/B between two thread ranks within ``AB_TOLERANCE``, and both
  CLIs in process (exit 0);
* ``preflight_job`` the launcher's ``--preflight`` over
  ``telemetry_job``'s script: clean (exit 0, its JSON report), clean
  with no card visible, and with a back edge (exit 121, HT302 naming
  ranks 0 and 1); no worker spawned, no preflight process initialized
  CUDA; each run's seconds;
* ``crossover`` per sequence length, the fused training attention
  (K2 + K3 + K4) against K1 + the composed autograd backward, and one
  row at BERT-base's shape (masked, non-causal);
* ``kernels`` per kernel (K1 flash forward, K2 forward with logsumexp,
  K3 backward dK/dV, K4 backward dQ, and the K3+K4 pair as one
  ``flash_attention_bwd`` against PyTorch's flash backward): launches
  on its main paths (by path and route), the largest error against the
  plain version by dtype and route over every checked shape, and
  ``kernel_shapes``' row at each main path's shape with the kernel's and
  the PyTorch call's device time per call (``device_ms``,
  ``library_device_ms``: calls queued back to back behind a spin kernel,
  timed by CUDA events);

then the card line as ``nvidia-smi`` prints it, and last
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. It also exits non-zero without a
CUDA device, or when ``hetu_tpu_torch`` is not beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import http.client
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "hetu_tpu_torch/ops/csrc/"      # the kernel sources, in the repo

# NVIDIA H100 SXM data sheet, dense: f32 on the CUDA cores, bf16 on the
# tensor cores; HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12

# the GPT-2-small widths (bench.py's gpt2-small)
GPT2_SMALL = dict(vocab_size=50257, hidden_size=768, num_hidden_layers=12,
                  num_attention_heads=12, max_position_embeddings=1024)
NUM_REQUESTS = 16
MAX_NEW = 32
NUM_BLOCKS = 512            # 512 x 16 positions: 8 concurrent 800-token seqs
MARGIN_TOL = 1e-3           # top-2 logit gap below which argmax may flip

# the request-level plane (serve_dense): bench.py's bench_serving
# (:1191-1302) and the baseline of bench_serving_continuous
# (:1504-1529) at GPT-2-small's widths in f32. Clients edge-pad each
# prompt (16-256 tokens) to the fleet prompt bucket; a tick pads its
# batch to the next power of two and generates its longest request's
# gen for every row
DENSE_PROMPT_BUCKET = 256
DENSE_SEQ_BUCKET = 1024             # the session's sequence bucket
DENSE_CLIENTS, DENSE_PER_CLIENT = 16, 4
DENSE_MAX_BATCH, DENSE_MAX_WAIT_MS = 8, 5
# telemetry_serve: the same plane at 4 closed-loop clients over two
# replicas, so a tick pads its batch to 1, 2 or 4
TEL_SERVE_CLIENTS, TEL_SERVE_PER_CLIENT = 4, 4
# telemetry_serve's engine leg: the requests a ContinuousBatchingEngine
# over the same session and Telemetry serves, whose request timelines
# (serve_request / serve_phase spans) doctor_serve attributes
TEL_SERVE_ENGINE_REQUESTS = 8
DENSE_DECODE_STEPS = 20             # timed decode_step calls (:1245-1252)
DENSE_NO_CACHE_STEPS = 4            # no-cache recompute steps (:1233-1242)
# sess.predict's logits, K1 against its plain version (f32, B=8 S=1024):
# the two attentions differ by ~1e-6 of an output (K1's f32 checks),
# which 12 layers, the LayerNorms and the 768-wide LM head carry to
# the logits (measured in the serve_dense line's parity)
DENSE_LOGIT_TOL = 1e-4

# the training pass: bench.py:1103-1118 (B=8, S=1024, bf16, Adam 1e-4)
TRAIN_BATCH = 8
TRAIN_WARMUP, TRAIN_STEPS = 2, 6
TRAIN_LR = 1e-4
# step-1 parity, kernels vs plain K2-K4: the bf16 loss within one bf16
# ulp of its magnitude; the layer-0 q/k/v weight grads within 2e-2 of
# their largest element (dq/dk/dv differ by bf16 roundings summed over
# the 8192 tokens of the batch)
GRAD_PARITY_TOL = 2e-2

# kernel checks of K2-K4 (float32 / bfloat16): the forward as K1's; the
# gradients looser in bf16, where p and dS are each rounded before a
# product summed over S
FWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# and each gradient row (one key of dk / dv, one q of dq) against its own
# size: |got - want| <= tol * (|want| + floor) in the 2-norm over the head
# dim, floor = BWD_ROW_FLOOR * the largest |want| row of the tensor (a row
# whose exact value is 0, as dq's first under causal, is held to the
# tensor's scale). In bf16 a correct kernel differs from the plain
# version by at most about one flipped rounding of p or dS and one of the
# output, ~1e-2 of a row's size in the worst case. BWD_TOL alone lets a
# fault confined to the late causal rows pass: their gradients are ~1e-2
# of the early rows'; check_catches_faults plants such faults
BWD_ROW_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_ROW_FLOOR = 1e-3
CROSSOVER_SEQ = (128, 256, 512, 1024, 2048)

# the BERT pre-training passes: BERT-base, the graph of bench.py:1150-1168
# (B=64, S=128), and BERT-small at S=2048, the graph of
# bench.py:2390-2406 (B=8); bf16 with f32 masters, Adam lr 1e-4, the
# default dropout 0.1, one fixed batch whose rows are padded past a
# length drawn from ``lengths``
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=128)
BERT_SMALL_2048 = dict(vocab_size=30522, hidden_size=512,
                       num_hidden_layers=4, num_attention_heads=8,
                       intermediate_size=2048, max_position_embeddings=2048)
BERT_PASSES = {
    "bert": dict(model="bert-base", widths=BERT_BASE, batch=64,
                 lengths=(64, 128), warmup=2, steps=6),
    "bert_long": dict(model="bert-small-2048", widths=BERT_SMALL_2048,
                      batch=8, lengths=(1024, 2048), warmup=2, steps=6,
                      f32_reference=True),
}
BERT_FEEDS = ("input_ids", "token_type_ids", "attention_mask",
              "masked_lm_labels", "next_sentence_label")

# the CNN passes: the reference's CIFAR VGG-16 with batch norm (channels
# 64-512, FC 512-4096-4096-10) and pre-activation ResNet-18 (widths
# 16/32/64), hetu_tpu/models/cnn.py, trained at B=128 on 3x32x32 in f32
# with MomentumOptimizer (examples/cnn/main.py --opt momentum) on batches
# of ht.data.cifar10() (its seeded synthetic images where CIFAR_10 is
# absent) through dataloader ops; 2 warm-up then 20 timed steps, each
# ending in the loss's readback. ResNet-18 takes main.py's default rate
# 0.1. VGG-16 takes 0.01: from the zoo's stddev-0.1 weights it diverges
# at 0.1 in both packages (tests/test_torch_cnn_models.py
# ::test_vgg16_diverges_at_lr_0_1_like_the_reference)
CNN_BATCH = 128
CNN_WARMUP, CNN_STEPS = 2, 20
CNN_PASSES = {
    "cnn_vgg16": dict(model="vgg16", lr=0.01,
                      grads=("vgg_conv1_1_weight", "vgg_conv1_1_scale")),
    "cnn_resnet18": dict(model="resnet18", lr=0.1,
                         grads=("resnet_init_conv_weight",
                                "resnet_init_bn_scale")),
}
# step-1 parity, the pass's graph in f32 on the card (cuDNN's TF32 off)
# against the same graph on the CPU in float64 (same weights, one B=8
# batch): the loss within CNN_LOSS_TOL relative, the first convolution's
# weight gradient and the first batch norm's scale gradient within
# CNN_GRAD_TOL of their largest element. The reference is the CPU in
# float64, not in f32: at VGG-16's initial weights a relu in the FC
# layers sits at a pre-activation within f32 rounding of 0 for this
# batch, so which side an f32 run lands on is decided by its summation
# order, and the CPU's f32 run lands on the other side from exact
# arithmetic — its first-layer gradients are ~1e-2 of their largest
# element from float64's (both packages' CPU f32 runs; the loss and
# ResNet-18 agree to ~1e-6). The CPU's f32 run is reported beside.
CNN_PARITY_BATCH = 8
CNN_LOSS_TOL = 1e-4
CNN_GRAD_TOL = 1e-3
# device time of the profiled step by op type, summed into these
# categories (the first prefix that matches; else "elementwise / other")
CNN_OP_CATEGORIES = (
    ("conv", ("Conv2d",)), ("batch norm", ("BatchNormalization",)),
    ("gemm", ("MatMul",)), ("pool", ("MaxPool2d", "AvgPool2d")),
    ("optimizer", ("Optimizer",)), ("loss", ("SoftmaxCrossEntropy",)),
)
# the digits pass: cnn_main.run() as tests/test_accuracy.py:65-76 runs
# the reference's examples/cnn/main.py, on the checked-in real digits;
# the JAX package's own bar
CNN_DIGITS_ARGS = ("--model", "digits_cnn", "--dataset", "DIGITS",
                   "--validate", "--num-epochs", "25", "--learning-rate",
                   "0.002", "--opt", "adam", "--batch-size", "64",
                   "--timing")
CNN_DIGITS_MIN_ACC = 0.96

# the sparse passes: bench.py's CTR traffic (bench_wdl_ps, :422-446) and
# NCF traffic (bench_ncf, :967-987) with every table on the card (no
# PS): 26 slots of int32 ids drawn zipf(1.3) mod 1,000,000 over a cycle
# of 100 batches, one fixed batch of 13 dense features and labels, B=128,
# SGD at each builder's default rate; NCF at ML-25M's cardinalities,
# uniform int32 user ids and zipf(1.3) item ids, B=1024. Steps go through
# Executor.run_batches in blocks of SPARSE_BLOCK: one warm-up block, then
# SPARSE_TIMED_BLOCKS timed ones, each ending in the last loss's readback
CTR_ROWS = 1_000_000
CTR_BATCH = 128
NCF_BATCH = 1024
SPARSE_CYCLE = 100
SPARSE_BLOCK = 100
SPARSE_TIMED_BLOCKS = 3
# pass: (builder, the dense weight whose step-1 gradient the parity holds)
SPARSE_PASSES = {"wdl_criteo": ("wdl_criteo", "W1"),
                 "deepfm_criteo": ("deepfm_criteo", "W1"),
                 "dcn_criteo": ("dcn_criteo", "W1"),
                 "dc_criteo": ("dc_criteo", "dc_res1_w1"),
                 "ncf": ("neural_mf", "ncf_W1")}
# step-1 parity, card against the port's CPU path built from the card
# run's initial values, on the traffic's first batch: the loss within
# SPARSE_LOSS_TOL relative; the dense weight's gradient and each table's
# step-1 update (its rows after the step less before) within
# SPARSE_GRAD_TOL of their largest element. Repeated ids make the card's
# index_add_ sum in another order than the CPU's (atomics)
SPARSE_LOSS_TOL = 1e-5
SPARSE_GRAD_TOL = 1e-4
# the pass's peak memory during its steps stays below
# SPARSE_TABLE_FACTOR x the tables' bytes plus the dense work (every
# intermediate value of a step alive at once and the other parameters
# three times: value, gradient, new value). An SGD update that copied the
# table would hold it twice
SPARSE_TABLE_FACTOR = 1.5
# the NCF retrieval pass: rec_main.worker as tests/test_accuracy.py:162-172
# runs the reference's examples/rec/run_hetu.py, on the synthetic set;
# the JAX package's own bars
NCF_HR_ARGS = ("--val", "--nepoch", "18", "--learning-rate", "8.0",
               "--batch-size", "1024")
NCF_MIN_HR, NCF_MIN_NDCG = 0.5, 0.25
# the Transformer pass: TransformerConfig's defaults (vocab 32000,
# d_model 512, d_ff 2048, 6 + 6 blocks, 8 heads, lengths 100, B=32,
# dropout 0.3, label smoothing 0.1) in f32 with Adam at transformer_main's
# 1e-3, on the reversal task's batches (a new batch every step)
TRANSFORMER_WARMUP, TRANSFORMER_STEPS = 2, 8
TRANSFORMER_LR = 1e-3
# step-1 parity at dropout 0 and B=4, the card against the port's CPU
# path in f32 (the same initial values: both draw them from numpy): the
# loss within TRANSFORMER_LOSS_TOL relative, the layer-0 self-attention
# query weight's and the token table's gradients within
# TRANSFORMER_GRAD_TOL of their largest element; float64 on the CPU is
# reported beside
TRANSFORMER_PARITY_BATCH = 4
TRANSFORMER_LOSS_TOL = 1e-4
TRANSFORMER_GRAD_TOL = 1e-3
TRANSFORMER_PARITY_GRADS = ("enc0_self_q_w", "tok_embed")
# transformer_main.main as tests/test_accuracy.py:148-159 runs the
# reference's example; the JAX package's own bar
TRANSFORMER_REVERSE_ARGS = ("--nepoch", "2", "--num-blocks", "2",
                            "--d-model", "128", "--d-ff", "256",
                            "--maxlen", "12", "--nsamples", "6400",
                            "--dropout", "0.0", "--timing")
TRANSFORMER_MAX_LOSS = 5.0

# the GNN passes: bench.py:1030-1079's graph (gcn_arxiv_epoch_time) —
# 169,343 nodes, 7 random out-edges a node from RandomState(0), self
# loops, symmetric normalization (1,354,709 entries) —, 128 features,
# hidden 256, 40 classes, the mask all ones; the builders' SGD at 0.1, in
# f32; the feeds put on the card once; GNN_WARMUP then GNN_EPOCHS timed
# full-graph epochs, each ending in the loss's readback
GNN_NODES, GNN_DEGREE = 169_343, 7
GNN_FEATURES, GNN_HIDDEN, GNN_CLASSES = 128, 256, 40
GNN_WARMUP, GNN_EPOCHS = 3, 20
GNN_PASSES = ("gcn", "graphsage")
# step-1 parity, card against the port's CPU path from the card's initial
# values: every ReLU's input within GNN_PRE_TOL of its largest element,
# the loss within GNN_LOSS_TOL relative, every parameter's gradient
# within GNN_GRAD_TOL of its largest element. The segment sums add a
# row's entries in a fixed order on both; the GEMMs round apart, by
# ~1e-6 of a ReLU input. Among GraphSAGE's 43 million second-layer ReLU
# inputs a few lie within that of 0 (three, at |x| <= 1.5e-7, on an
# H100), and one ReLU decided the other way moves a weight's gradient
# by ~1e-3 of its largest element. So the CPU twin takes its ReLU
# decisions from the card's inputs, and the line reports how many
# differ and the largest |x| among them
GNN_PRE_TOL = 1e-5
GNN_LOSS_TOL = 1e-5
GNN_GRAD_TOL = 1e-4
# device time of the profiled epoch by op type, summed into these
# categories (the first prefix that matches; else "elementwise / other")
GNN_OP_CATEGORIES = (
    ("sparse (SpMM / gather / segment)", ("Csrmm", "Csrmv")),
    ("gemm", ("MatMul",)), ("optimizer", ("Optimizer",)),
    ("loss", ("SoftmaxCrossEntropy",)),
)
# gcn_main.run at the reference example's graph and widths
# (examples/gnn/train_hetu_gcn.py:95-106: 169,343 nodes, 128 features, 40
# classes, hidden 256, 10 epochs) and learning rate 10: at its default
# 0.01 the loss moves by 1e-4 in 10 epochs. No rate in {0.5, 1, 2, 5, 10,
# 20, 50, 100, 200, 500} makes it fall by 1% in 10 epochs: it starts
# 0.32% above chance, ln(40) = 3.68888; 10 is the lowest of them at which
# it falls monotonically below chance (accuracy 0.0245 -> 0.0273). The
# expected values are the JAX package's CPU run of the same example,
# each epoch's mean loss and accuracy, printed by
#   JAX_PLATFORMS=cpu python tests/test_torch_gnn_example.py \
#       --learning-rate 10
# and held to GCN_EXAMPLE_LOSS_TOL relative and GCN_EXAMPLE_ACC_TOL
GCN_EXAMPLE_ARGS = ("--learning-rate", "10", "--timing")
GCN_EXAMPLE_LOSSES = (
    3.7006664276123047, 3.693124532699585, 3.690143346786499,
    3.6896440982818604, 3.689391613006592, 3.6892056465148926,
    3.689042806625366, 3.6888973712921143, 3.6887612342834473,
    3.688631772994995)
GCN_EXAMPLE_ACCS = (
    0.024459233626426838, 0.025055656271590794, 0.025102897669227544,
    0.02574065653732366, 0.025805613459074186, 0.02639613092953355,
    0.02668548449005864, 0.026856734556491853, 0.027069320845857225,
    0.02732324335815475)
GCN_EXAMPLE_LOSS_TOL = 1e-5
GCN_EXAMPLE_ACC_TOL = 1e-3
# sampled_sage.main at tests/test_gnn_sampled.py:19-22's settings, held to
# its bar
GNN_SAMPLED_ARGS = ("--num-epoch", "4", "--nodes", "1200", "--batch-seeds",
                    "32", "--timing")
GNN_SAMPLED_MAX_LOSS = 0.5

# the main-path shape of each kernel: K1 the serving path's longest
# prefill (one 1024-token bucket) and the BERT-base step's; K2-K4 the
# GPT training step's and the BERT-small S=2048 step's. ``mask``: None,
# "half" (fixed keys masked, see check_flash_fwd) or "padding" (BERT's
# rows, padding_mask)
K1_REP = dict(b=1, h=12, s=1024, d=64, dtype="float32", causal=True,
              mask=None)
BERT_K1_REP = dict(b=64, h=12, s=128, d=64, dtype="bfloat16", causal=False,
                   mask="padding")
TRAIN_REP = dict(b=TRAIN_BATCH, h=12, s=1024, d=64, dtype="bfloat16",
                 causal=True, mask=None)
BERT_LONG_REP = dict(b=8, h=8, s=2048, d=64, dtype="bfloat16", causal=False,
                     mask="padding")
# K1 on the request-level plane: the decoder's prefill of a full tick
# (B=8 in the 256 prompt bucket) and the session's graph forward of 8
# rows in its 1024 bucket
K1_PREFILL_REP = dict(b=DENSE_MAX_BATCH, h=12, s=DENSE_PROMPT_BUCKET, d=64,
                      dtype="float32", causal=True, mask=None)
K1_SESSION_REP = dict(K1_PREFILL_REP, s=DENSE_SEQ_BUCKET)
# telemetry_serve's prefill: its largest tick (B=4) in the prompt bucket
K1_TEL_SERVE_REP = dict(K1_PREFILL_REP, b=TEL_SERVE_CLIENTS)
# K1 in the autoplan phase's per-op profile: train's attention, eval
# forward
K1_PROFILE_REP = dict(TRAIN_REP)
K1_REPS = (K1_REP, BERT_K1_REP, K1_PREFILL_REP, K1_SESSION_REP,
           K1_TEL_SERVE_REP, K1_PROFILE_REP)
# device kernels of the profiled training step, by name (first match)
PROFILE_CATEGORIES = (
    ("flash attention (K1-K4)", ("flash_fwd", "flash_bwd_")),
    ("sparse (SpMM / segment)", ("segment_reduce", "spmm", "csrmm")),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "convolve",
                             "winograd", "cudnn", "fft2d")),
    ("pooling", ("pool",)),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("reduction", ("reduce_kernel",)),
    ("index / scatter / gather", ("index", "scatter", "gather", "unique",
                                  "sort", "radix")),
    ("random (dropout masks)", ("distribution", "philox")),
    ("elementwise", ("elementwise", "copy")),
)
# the name prefix of profile_window's per-op ranges
OP_RANGE = "op::"
# device_ms: the spin kernel's first length, in clock cycles (~10 ms at
# the H100's boost clock), and the launch-count keys each timed call of
# K1-K4 and the pair adds one to
DEVICE_SPIN_CYCLES = 20_000_000
DEVICE_LAUNCHES = {"K1": ("flash_fwd",), "K2": ("flash_fwd_lse",),
                   "K3": ("flash_bwd_dkv",), "K4": ("flash_bwd_dq",),
                   "pair": ("flash_bwd_dkv", "flash_bwd_dq")}


def log(msg):
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def _reuse_weight_draws():
    """Keep each named weight's initial draw (``PlaceholderOp.
    initial_value``) for the rest of the process and hand out copies:
    the phases build the same models again and again (GPT-2-small in
    some twenty executors here and in the jobs' ranks), and numpy's draw
    of its 124M weights is most of an executor's setup (about 6 s on the
    H100's host). Every executor starts from the same values as before;
    only ``executor_setup_s`` after a model's first build shrinks."""
    import threading
    from hetu_tpu_torch.ops.variable import PlaceholderOp
    draw = PlaceholderOp.initial_value
    kept, lock = {}, threading.Lock()

    def initial_value(self, seed=0):
        init = self.initializer
        if self.tensor_value is not None or init is None:
            return draw(self, seed)
        key = (self.name, seed, type(init), repr(sorted(vars(init).items())))
        with lock:
            if key not in kept:
                kept[key] = draw(self, seed)
            return kept[key].copy()

    PlaceholderOp.initial_value = initial_value


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def host_ms(torch, fn, reps=20):
    """Median host time of one call made on an idle device (synchronised
    first, not after): what the wrapper costs the host, launches included
    but not the kernels' run."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def median_ms(torch, fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# per kernel: (flops per b*h*s*s*d, [b,h,s,d] tensors moved, f32 [b,h,s]
# vectors moved): K1 reads q, k, v and writes o; K2 also writes lse; K3
# reads q, k, v, dO, lse, D and writes dk, dv; K4 reads q, k, v, dO, O,
# lse and writes dq and D (on the tc route it computes D); the pair
# (one flash_attention_bwd) reads q, k, v, O, dO, lse, writes dq, dk, dv
FLASH_WORK = {"K1": (4, 4, 0), "K2": (4, 4, 1), "K3": (8, 6, 2),
              "K4": (6, 6, 2), "pair": (14, 8, 1)}
# the K1 checks: (dtypes, batches, seqs, head dim, heads, masks); every
# row with each of its masks and causal on/off. The "half" mask hides the
# second half of the first batch element's keys and every key of the
# last one's rows where B > 1. D=64 is the main paths' (f32 serving on
# the simt route, B=8 at S=256 and 1024 on the request-level plane and
# the smaller ticks' B=1, 2, 4 at S=256, bf16 BERT-base on tc, B=64 with
# BERT's padding); bf16 D=128 and the
# ragged S=520 hold the other tensor-core instantiation and the TMA
# edge; bf16 D=96 the simt route's bf16
FWD_KERNEL_SHAPES = (
    (("float32", "bfloat16"), (1, 4), (8, 128, 512, 1024), 64, 12,
     (None, "half")),
    (("float32",), (DENSE_MAX_BATCH,), (DENSE_PROMPT_BUCKET, DENSE_SEQ_BUCKET),
     64, 12, (None,)),
    (("float32",), (1, 2, 4), (DENSE_PROMPT_BUCKET,), 64, 12, (None,)),
    (("bfloat16",), (64,), (128,), 64, 12, (None, "half", "padding")),
    (("bfloat16",), (TRAIN_BATCH,), (1024,), 64, 12, (None,)),  # autoplan
    (("bfloat16",), (4,), (512, 1024), 128, 12, (None, "half")),
    (("bfloat16",), (4,), (520,), 64, 12, (None, "half")),
    (("bfloat16",), (4,), (512, 1024), 96, 12, (None, "half")),
)
# the K2-K4 checks: (dtypes, batches, seqs, head dim, heads, masks); every
# row with each of its masks and causal on/off; the "half" mask hides the
# second half of the first element's keys and the last quarter of the
# last one's. D=64 is the training paths' (GPT-2 at H=12 S=1024, at B=2 the
# pipeline passes' microbatch, at B=4 a data-parallel rank's rows,
# BERT-small at H=8 S=2048 with BERT's padding; the sp passes' blocks:
# the zigzag ring's diagonal at S=512 and squares at S=256, Ulysses' 6
# heads at S=1024, BERT's ring at S=1024); D=128 and the ragged S=520 hold the
# other tensor-core instantiations and the TMA edge; bf16 at D=96 the
# simt route's bf16 instantiations
TRAIN_KERNEL_SHAPES = (
    (("float32", "bfloat16"), (1, TRAIN_BATCH), (128, 512, 1024), 64, 12,
     (None, "half")),
    (("bfloat16",), (TRAIN_BATCH // 4,), (1024,), 64, 12, (None,)),  # PP_REP
    (("bfloat16",), (TRAIN_BATCH // 2,), (1024,), 64, 12, (None,)),  # DP_REP
    (("bfloat16",), (8,), (2048,), 64, 8, (None, "half", "padding")),
    (("bfloat16",), (TRAIN_BATCH,), (256,), 64, 12, (None,)),  # ring squares
    (("bfloat16",), (TRAIN_BATCH,), (1024,), 64, 6, (None,)),  # Ulysses
    (("bfloat16",), (8,), (1024,), 64, 8, (None, "padding")),  # BERT's ring
    (("bfloat16",), (1,), (512, 1024), 128, 12, (None, "half")),
    (("bfloat16",), (1,), (520,), 64, 12, (None, "half")),
    (("bfloat16",), (1,), (512, 1024), 96, 12, (None, "half")),
)


def padding_mask(torch, b, s, dtype, g):
    """BERT's additive padding mask, [B, 1, 1, S] in ``dtype``, as its
    graph builds it: (m - 1) * 10000 with m = 1 on each element's first L
    keys, L drawn from [S/2, S] (in bf16 a padded key carries -9984)."""
    lengths = torch.randint(s // 2, s + 1, (b, 1), generator=g,
                            device="cuda")
    keep = (torch.arange(s, device="cuda")[None] < lengths).to(dtype)
    return ((keep - 1) * 10000).view(b, 1, 1, s)


def _is(row, rep):
    return all(row[k] == v for k, v in rep.items())


def flash_bound(b, h, s, d, dtype_name, causal, masked, kind="K1"):
    """Least time for a flash kernel's work: max(flops / peak for the
    dtype, bytes moved once (+ mask rows) / HBM bandwidth). Causal halves
    the flops."""
    per, tensors, vectors = FLASH_WORK[kind]
    itemsize = 4 if dtype_name == "float32" else 2
    flops = per * b * h * s * s * d * (0.5 if causal else 1.0)
    nbytes = (tensors * b * h * s * d * itemsize + vectors * b * h * s * 4
              + (b * s * 4 if masked else 0))
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def device_ms(torch, fn, label, launches=(), n=20):
    """Device time of one call: n calls queued behind a spin kernel
    (``torch.cuda._sleep``), so that they run back to back with no host
    time between them, timed by two CUDA events around them, over n.
    The spin grows until the host has queued every call before the
    device reaches the first event. ``launches``: the launch-count keys
    (``_build.launch_counts``) the call adds one to; it raises unless
    each rose by exactly n, or the time is not positive. (torch.profiler
    lost kernel records in these short windows: see PERF.md.)"""
    from hetu_tpu_torch.ops import _build
    fn()
    torch.cuda.synchronize()
    cycles = DEVICE_SPIN_CYCLES
    for _ in range(4):
        before = {k: _build.launch_counts[k] for k in launches}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            break
        cycles *= 4
    else:
        raise AssertionError(f"device_ms {label}: the device reached the "
                             f"calls before the host had queued them")
    got = {k: _build.launch_counts[k] - before[k] for k in launches}
    ms = start.elapsed_time(end) / n
    if ms <= 0 or any(c != n for c in got.values()):
        raise AssertionError(f"device_ms {label}: {ms} ms, launches {got} "
                             f"over {n} calls")
    return ms


def _device_times(torch, kern, library, launches, label):
    """The main-path row's device times: the kernel call's (``launches``:
    the launch-count keys it adds one to a call) and the library call's
    (None where there is none)."""
    return {"device_ms": device_ms(torch, kern, label, launches),
            "library_device_ms": None if library is None
            else device_ms(torch, library, label + " library")}


# ---------------------------------------------------------------------------
# kernels: K1 against its plain version at every listed shape
# ---------------------------------------------------------------------------

def check_flash_fwd(torch, seed):
    """K1 against its plain version at every shape of FWD_KERNEL_SHAPES,
    with each of its masks and causal on/off; each row names the route
    the kernel took; the rows at the main paths' shapes (K1_REPS) also
    the kernel's, the plain version's and the PyTorch call's times, the
    wrapper's host time and the device times (_device_times). The
    PyTorch call is SDPA with the same additive mask (and the causal
    one)."""
    import torch.nn.functional as F
    from hetu_tpu_torch.ops import flash_attention as fa
    rows, failures = [], []
    shapes = [(getattr(torch, dname), b, s, d, h, masks)
              for dnames, batches, seqs, d, h, masks in FWD_KERNEL_SHAPES
              for dname in dnames for b in batches for s in seqs]
    for dtype, b, s, d, h, masks in shapes:
        dname = str(dtype).split(".")[-1]
        g = torch.Generator(device="cuda").manual_seed(seed + s + b)
        q, k, v = (torch.randn(b, h, s, d, generator=g,
                               device="cuda").to(dtype) for _ in range(3))
        for masked in masks:
            mask = None
            if masked == "half":
                mask = torch.zeros(b, 1, 1, s, device="cuda")
                mask[0, ..., s // 2:] = -1e9
                if b > 1:
                    mask[-1] = -1e9     # a fully masked row
            elif masked == "padding":
                mask = padding_mask(torch, b, s, dtype, g)
            for causal in (False, True):
                scale = d ** -0.5
                out = fa.flash_attention(q, k, v, mask, scale, causal)
                ref = fa.flash_attention_plain(q, k, v, mask, scale, causal)
                torch.cuda.synchronize()
                diff = (out.float() - ref.float()).abs()
                tol = FWD_TOL[dname]
                ok = bool(torch.allclose(out.float(), ref.float(), atol=tol,
                                         rtol=tol))
                lib_mask = mask
                if causal:
                    cm = torch.full((s, s), fa.NEG_INF, device="cuda").triu(1)
                    lib_mask = cm if mask is None else mask + cm
                if lib_mask is not None:
                    lib_mask = lib_mask.to(dtype)

                def kern():
                    return fa.flash_attention(q, k, v, mask, scale, causal)

                def library():
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=lib_mask, scale=scale)
                bound, by = flash_bound(b, h, s, d, dname, causal, masked)
                row = {"b": b, "h": h, "s": s, "d": d, "dtype": dname,
                       "causal": causal, "mask": masked,
                       "route": fa._fwd_route(dtype, d),
                       "max_abs_err": float(diff.max()),
                       "max_rel_err": float((diff / ref.float().abs()
                                             .clamp_min(1.0)).max()),
                       "tol": tol, "ok": ok,
                       "bound_ms": bound, "bound_by": by}
                # timed at the main paths' shapes; the others are held
                # against the plain version only
                timed = any(_is(row, rep) for rep in K1_REPS)
                row.update(_row_times(
                    torch, timed, kern, lambda: fa.flash_attention_plain(
                        q, k, v, mask, scale, causal), library))
                if timed:
                    row.update(_device_times(
                        torch, kern, library, DEVICE_LAUNCHES["K1"],
                        f"K1 {dname} B={b} H={h} S={s} mask={masked}"))
                rows.append(row)
                if not ok:
                    failures.append(row)
    if failures:
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"at {len(failures)} shape(s): {failures}")
    return rows


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


def _row_rel_err(got, want):
    """The largest |got - want| of a row over (|want| + floor) of that row
    (2-norms over the last axis; see BWD_ROW_TOL)."""
    want = want.float()
    size = want.norm(dim=-1)
    diff = (got.float() - want).norm(dim=-1)
    return float((diff / (size + BWD_ROW_FLOOR * size.max()
                          + 1e-30)).max())


def _fwd_check(pairs, dname):
    """(ok, max_abs_err) of (got, want) forward pairs (o, lse): each
    within FWD_TOL elementwise."""
    tol = FWD_TOL[dname]
    return (all(a.float().allclose(w.float(), atol=tol, rtol=tol)
                for a, w in pairs), max(_err(*pr) for pr in pairs))


def _grad_check(pairs, dname):
    """(ok, max_abs_err, row_rel_err) of (got, want) gradient pairs: each
    within BWD_TOL elementwise and BWD_ROW_TOL row by row."""
    tol = BWD_TOL[dname]
    abs_err = max(_err(*pr) for pr in pairs)
    row_err = max(_row_rel_err(*pr) for pr in pairs)
    ok = all(a.float().allclose(w.float(), atol=tol, rtol=tol)
             for a, w in pairs) and row_err <= BWD_ROW_TOL[dname]
    return ok, abs_err, row_err


def _sdpa_flash(torch, q, k, v, scale, causal):
    """PyTorch's own flash-attention forward (bf16 only, no mask): output,
    logsumexp and what its backward needs. Timing yardstick only."""
    return torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, causal, False, scale=scale)


def _sdpa_efficient(torch, q, k, v, bias, scale, causal):
    """PyTorch's memory-efficient attention forward (the only PyTorch
    call that takes an additive mask and returns the logsumexp), with
    ``bias`` [B, H, S, S]: output, logsumexp and the Philox state its
    backward takes. Timing yardstick only."""
    return torch.ops.aten._scaled_dot_product_efficient_attention(
        q, k, v, bias, True, 0.0, causal, scale=scale)


def _row_times(torch, timed, kern, plain, library):
    """A checked shape's times: the kernel call's median and host time,
    the plain version's and the library call's (None without one); all
    None where the shape is on no main path (``timed`` false)."""
    if not timed:
        return dict.fromkeys(("ms", "host_ms", "plain_ms", "library_ms"))
    return {"ms": median_ms(torch, kern), "host_ms": host_ms(torch, kern),
            "plain_ms": median_ms(torch, plain, reps=3, warmup=1),
            "library_ms": None if library is None
            else median_ms(torch, library)}


def check_flash_train_kernels(torch, seed, extra_reps=()):
    """K2, K3, K4 and the K3+K4 pair (one flash_attention_bwd) against
    their plain versions at every shape of TRAIN_KERNEL_SHAPES, with each
    of its masks and causal on/off. The masks leave every row an unmasked
    key (a fully masked row has p = exp(s - lse) = 1 under the
    reference's formula, which nothing pins). K3 and K4 run from the
    kernel's own o and lse, so each is held apart from K2's roundings;
    their rows name the route they took. K3's and K4's times are their
    launches alone, from prepared inputs (K3 reading the D that K4
    wrote, as on the path); the pair's is one whole flash_attention_bwd.
    The PyTorch calls: flash attention (bf16 without a mask) and, under
    BERT's padding mask, memory-efficient attention with the mask
    expanded to a [B, H, S, S] bias; each backward computes dq, dk and
    dv, so K3's row and the pair's carry it. The rows at a main path's
    shape (the *_REP shapes and ``extra_reps``) carry the times and the
    device times (_device_times); the others the check alone. Returns
    {kernel: [row per shape]}."""
    from hetu_tpu_torch.ops import flash_attention as fa
    rows = {"K2": [], "K3": [], "K4": [], "pair": []}
    failures = []
    shapes = [(getattr(torch, dname), b, s, d, h, masks)
              for dnames, batches, seqs, d, h, masks in TRAIN_KERNEL_SHAPES
              for dname in dnames for b in batches for s in seqs]
    for dtype, b, s, d, h, masks in shapes:
        dname = str(dtype).split(".")[-1]
        g = torch.Generator(device="cuda").manual_seed(seed + s + b)
        q, k, v, do = (torch.randn(b, h, s, d, generator=g,
                                   device="cuda").to(dtype)
                       for _ in range(4))
        for masked in masks:
            mask = None
            if masked == "half":
                mask = torch.zeros(b, 1, 1, s, device="cuda")
                mask[0, ..., s // 2:] = -1e9
                mask[-1, ..., 3 * s // 4:] = -1e9
            elif masked == "padding":
                mask = padding_mask(torch, b, s, dtype, g)
            for causal in (False, True):
                args = (q, k, v, mask)
                scale = d ** -0.5
                o, lse = fa.flash_attention_with_lse(*args, scale, causal)
                bwd = (*args, o, lse, do, scale, causal)
                dk, dv = fa.flash_attention_bwd_dkv(*bwd)
                dq = fa.flash_attention_bwd_dq(*bwd)
                pdq, pdk, pdv = fa.flash_attention_bwd(*bwd)
                prep = fa._bwd_prepare(*bwd[:7])
                fa._launch_dq(prep, scale, causal)  # tc: writes K3's D
                ro, rlse = fa.flash_attention_with_lse_plain(*args, scale,
                                                             causal)
                rdk, rdv = fa.flash_attention_bwd_dkv_plain(*bwd)
                rdq = fa.flash_attention_bwd_dq_plain(*bwd)
                torch.cuda.synchronize()
                lib = dict.fromkeys(rows)
                if dtype == torch.bfloat16 and not masked:
                    res = _sdpa_flash(torch, q, k, v, scale, causal)
                    lib["K2"] = lambda: _sdpa_flash(torch, q, k, v, scale,
                                                    causal)
                    # one call computes dq, dk and dv: K3's row and the
                    # pair's carry it
                    lib["K3"] = lib["pair"] = lambda: torch.ops.aten.\
                        _scaled_dot_product_flash_attention_backward(
                            do, q, k, v, res[0], res[1], res[2], res[3],
                            res[4], res[5], 0.0, causal, res[6], res[7],
                            scale=scale)
                elif masked == "padding":
                    bias = mask.expand(b, h, s, s)
                    eff = _sdpa_efficient(torch, q, k, v, bias, scale,
                                          causal)
                    lib["K2"] = lambda: _sdpa_efficient(torch, q, k, v,
                                                        bias, scale, causal)
                    lib["K3"] = lib["pair"] = lambda: torch.ops.aten.\
                        _scaled_dot_product_efficient_attention_backward(
                            do, q, k, v, bias, eff[0], eff[1], eff[2],
                            eff[3], 0.0, (True, True, True, False), causal,
                            scale=scale)
                # kind: ((got, want) pairs, kernel call, plain call)
                checks = {
                    "K2": ([(o, ro), (lse, rlse)],
                           lambda: fa.flash_attention_with_lse(
                               *args, scale, causal),
                           lambda: fa.flash_attention_with_lse_plain(
                               *args, scale, causal)),
                    "K3": ([(dk, rdk), (dv, rdv)],
                           lambda: fa._launch_dkv(prep, scale, causal),
                           lambda: fa.flash_attention_bwd_dkv_plain(*bwd)),
                    "K4": ([(dq, rdq)],
                           lambda: fa._launch_dq(prep, scale, causal),
                           lambda: fa.flash_attention_bwd_dq_plain(*bwd)),
                    "pair": ([(pdq, rdq), (pdk, rdk), (pdv, rdv)],
                             lambda: fa.flash_attention_bwd(*bwd),
                             lambda: fa.flash_attention_bwd_plain(*bwd)),
                }
                for kind, (pairs, kern, plain) in checks.items():
                    bound, by = flash_bound(b, h, s, d, dname, causal,
                                            masked, kind)
                    row = {"b": b, "h": h, "s": s, "d": d, "dtype": dname,
                           "causal": causal, "mask": masked}
                    if kind == "K2":
                        ok, err = _fwd_check(pairs, dname)
                        row.update(max_abs_err=err, tol=FWD_TOL[dname],
                                   ok=ok, route=fa._fwd_route(dtype, d))
                    else:
                        ok, err, row_err = _grad_check(pairs, dname)
                        row.update(max_abs_err=err, tol=BWD_TOL[dname],
                                   row_rel_err=row_err,
                                   row_tol=BWD_ROW_TOL[dname], ok=ok,
                                   route=fa._bwd_route(dtype, d))
                    # timed at the main paths' shapes; the others are
                    # held against the plain versions only
                    timed = any(_is(row, rep) for rep in
                                (TRAIN_REP, BERT_LONG_REP, PP_REP, DP_REP,
                                 SP_RING_DIAG_REP, SP_RING_SQUARE_REP,
                                 SP_ULYSSES_REP, SP_BERT_REP, *extra_reps))
                    row.update(_row_times(torch, timed, kern, plain,
                                          lib[kind]),
                               bound_ms=bound, bound_by=by)
                    if timed:
                        row.update(_device_times(
                            torch, kern, lib[kind], DEVICE_LAUNCHES[kind],
                            f"{kind} B={b} H={h} S={s} mask={masked}"))
                    rows[kind].append(row)
                    if not row["ok"]:
                        failures.append((kind, row))
    if failures:
        raise AssertionError(f"K2-K4 disagree with their plain versions at "
                             f"{len(failures)} case(s): {failures}")
    return rows


def check_catches_faults(torch, seed):
    """The forward check (_fwd_check) and the gradient check
    (_grad_check) against faults planted in the kernels' output at the
    training shape (B=8 H=12 S=1024 D=64 bf16 causal): forward, the last
    q tile of O zeroed and lse shifted by log 2 on the last 64 rows of
    each head; backward, the last key tile of dk and dv zeroed, the last
    q tile of dq zeroed, and dk from K3 given D = 0. The kernels' own
    output must pass both checks and every fault must fail its check;
    each gradient row also says whether BWD_TOL alone would have caught
    it."""
    from hetu_tpu_torch.ops import flash_attention as fa
    b, h, s, d, dname = TRAIN_BATCH, 12, 1024, 64, "bfloat16"
    g = torch.Generator(device="cuda").manual_seed(seed + s + b)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_attention_with_lse(q, k, v, None, scale, True)
    ro, rlse = fa.flash_attention_with_lse_plain(q, k, v, None, scale, True)
    bwd = (q, k, v, None, o, lse, do, scale, True)
    dq, dk, dv = fa.flash_attention_bwd(*bwd)
    rdk, rdv = fa.flash_attention_bwd_dkv_plain(*bwd)
    rdq = fa.flash_attention_bwd_dq_plain(*bwd)
    prep = fa._bwd_prepare(*bwd[:7])
    prep["delta"] = torch.zeros_like(prep["delta"])
    dk_no_d, _ = fa._launch_dkv(prep, scale, True)

    def last_tile_zeroed(t):
        t = t.clone()
        t[..., -64:, :] = 0
        return t
    lse_shifted = lse.clone()
    lse_shifted[..., -64:] += float(np.log(2.0))
    fwd_cases = {
        "forward kernels": [(o, ro), (lse, rlse)],
        "last q tile of O zeroed": [(last_tile_zeroed(o), ro)],
        "lse shifted by log 2 on its last rows": [(lse_shifted, rlse)],
    }
    cases = {
        "kernels": [(dq, rdq), (dk, rdk), (dv, rdv)],
        "last key tile of dk and dv zeroed": [(last_tile_zeroed(dk), rdk),
                                              (last_tile_zeroed(dv), rdv)],
        "last q tile of dq zeroed": [(last_tile_zeroed(dq), rdq)],
        "K3 given D = 0": [(dk_no_d, rdk)],
    }
    torch.cuda.synchronize()
    out = {}
    for name, pairs in fwd_cases.items():
        ok, err = _fwd_check(pairs, dname)
        out[name] = {"passes": ok, "max_abs_err": err}
    for name, pairs in cases.items():
        ok, err, row_err = _grad_check(pairs, dname)
        out[name] = {"passes": ok, "max_abs_err": err,
                     "row_rel_err": row_err,
                     "passes_bwd_tol_alone": all(
                         a.float().allclose(w.float(), atol=BWD_TOL[dname],
                                            rtol=BWD_TOL[dname])
                         for a, w in pairs)}
    own = ("kernels", "forward kernels")
    if not all(out[name]["passes"] for name in own) or any(
            r["passes"] for name, r in out.items() if name not in own):
        raise AssertionError(f"the forward or gradient check does not "
                             f"tell the kernels from planted faults: {out}")
    return out


# ---------------------------------------------------------------------------
# train: the second main path
# ---------------------------------------------------------------------------

def _bf16_ulp(x):
    """One bfloat16 ulp at the magnitude of x (8 significand bits)."""
    return 2.0 ** (int(np.floor(np.log2(abs(x)))) - 7)


def train_pass(torch, nodes, feeds, plain, steps):
    """What every training phase runs: first one step of an executor
    over ``nodes`` (the loss, the gradients to compare, the optimizer)
    with the plain kernel versions of ``plain`` ({name in
    ``ops.attention``: function}) swapped in, before the main path; then
    the main path, ``steps`` steps of a new executor of the same graph
    with the kernels, the launch counts set to 0 just before and read
    just after. The same graph and step 0 give both executors the same
    weights and dropout masks. Returns (executor, run)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import attention as attn
    kernels = {key: getattr(attn, key) for key in plain}
    for key, fn in plain.items():
        setattr(attn, key, fn)
    try:
        exe = ht.Executor(nodes, dtype=torch.bfloat16)
        out = exe.run(feed_dict=feeds)
        plain_loss = float(out[0].asnumpy())
        plain_grads = [o.tensor.float().clone() for o in out[1:-1]]
    finally:
        for key, fn in kernels.items():
            setattr(attn, key, fn)
    del exe, out
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    exe = ht.Executor(nodes, dtype=torch.bfloat16)
    setup_s = time.perf_counter() - t0
    losses, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        out = exe.run(feed_dict=feeds)
        losses.append(float(out[0].asnumpy()))      # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            kernel_grads = [o.tensor.float().clone() for o in out[1:-1]]
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)           # main path ends
    return exe, {"setup_s": setup_s, "losses": losses, "step_ms": step_ms,
                 "launches": launches,
                 "peak": torch.cuda.max_memory_allocated(),
                 "plain_loss": plain_loss, "plain_grads": plain_grads,
                 "kernel_grads": kernel_grads}


def f32_reference(torch, nodes, feeds, plain, run):
    """Step 1 of the graph in f32 with the plain kernel versions of
    ``plain`` (the same weights and, keyed by the graph's own op ids,
    the same dropout masks as the bf16 executors): the errors of the
    bf16 kernels' step and of the bf16 plain versions' against it, as
    ``check_pass`` measures them (each gradient's largest difference
    over its largest element). Reported, not gated: it says whether the
    kernels or bf16 itself set a bf16 parity gate's margin."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import attention as attn
    kernels = {key: getattr(attn, key) for key in plain}
    for key, fn in plain.items():
        setattr(attn, key, fn)
    try:
        exe = ht.Executor(nodes)
        out = exe.run(feed_dict=feeds)
        loss = float(out[0].asnumpy())
        grads = [o.tensor.float().clone() for o in out[1:-1]]
    finally:
        for key, fn in kernels.items():
            setattr(attn, key, fn)
    del exe, out
    torch.cuda.empty_cache()

    def errs(got):
        return {part: float((g - r).abs().max() / r.abs().max())
                for part, g, r in zip("qkv", got, grads)}
    return {"loss_f32": loss, "loss_kernels": run["losses"][0],
            "loss_plain_bf16": run["plain_loss"],
            "kernels_rel_err": errs(run["kernel_grads"]),
            "plain_bf16_rel_err": errs(run["plain_grads"])}


def check_pass(name, run, want, grads):
    """A training phase's checks: every loss finite and the last below
    the first; the launch counts ``want``; step-1 parity with the plain
    kernels — the loss within one bf16 ulp, each of ``grads`` ({part:
    (kernel's, plain's)}) within GRAD_PARITY_TOL of its largest element.
    Returns (launches, parity)."""
    losses = run["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} loss not finite and falling: {losses}")
    got = {key: run["launches"].get(key, 0) for key in want}
    if got != want:
        raise AssertionError(f"{name} launches {got}, want {want}")
    grad_err = {part: float((kg - pg).abs().max() / pg.abs().max())
                for part, (kg, pg) in grads.items()}
    parity = {"loss_kernels": losses[0], "loss_plain": run["plain_loss"],
              "loss_tol": _bf16_ulp(run["plain_loss"]),
              "grad_rel_err": grad_err, "grad_tol": GRAD_PARITY_TOL}
    if abs(losses[0] - run["plain_loss"]) > parity["loss_tol"] or \
            max(grad_err.values()) > GRAD_PARITY_TOL:
        raise AssertionError(f"{name} step-1 parity with the plain kernels "
                             f"failed: {parity}")
    return got, parity


def _route_counts(on, off, n):
    """Launch counts of a path whose kernels ``on`` launch n times each,
    all on the tc route, and whose kernels ``off`` never launch."""
    return {**{k: n for k in on}, **{f"{k}.tc": n for k in on},
            **{f"{k}.simt": 0 for k in on}, **{k: 0 for k in off}}


def train(torch, seed, card):
    """GPT-2-small causal LM, the graph of bench.py:1103-1118, trained
    with Adam in bf16 through Executor.run on one fixed batch
    (train_pass: a parity step with the plain K2-K4 swapped in, then
    warm-up and timed steps with the kernels); then one profiled step."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import flash_attention as fa

    cfg = M.GPTConfig(**GPT2_SMALL, hidden_dropout_prob=0.0,
                      use_flash_attention=True)
    seq = cfg.max_position_embeddings
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _, loss = M.GPTLMHeadModel(cfg)(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    opt = ht.optim.AdamOptimizer(learning_rate=TRAIN_LR)
    train_op = opt.minimize(lm)
    # the layer-0 qkv weight's gradient: its column blocks are dq, dk, dv
    # of layer 0 mapped back through the qkv projection
    qkv0 = next(i for i, p in enumerate(opt.params)
                if p.name == "gpt_h0_attn_qkv_weights")
    nodes = [lm, train_op.inputs[qkv0], train_op]
    rng = np.random.RandomState(seed)
    x = rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, seq))
    y = np.concatenate([x[:, 1:], np.full((TRAIN_BATCH, 1), -1)], axis=1)
    feeds = {ids: torch.as_tensor(x, device="cuda"),
             labels: torch.as_tensor(y, device="cuda")}

    steps = TRAIN_WARMUP + TRAIN_STEPS
    exe, run = train_pass(
        torch, nodes, feeds,
        {"flash_attention_with_lse": fa.flash_attention_with_lse_plain,
         "flash_attention_bwd": fa.flash_attention_bwd_plain}, steps)
    hidden = cfg.hidden_size
    (kernel_grad,), (plain_grad,) = run["kernel_grads"], run["plain_grads"]
    got, parity = check_pass(
        "train", run,
        _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,),
                      cfg.num_hidden_layers * steps),
        {part: (kernel_grad[:, i * hidden:(i + 1) * hidden],
                plain_grad[:, i * hidden:(i + 1) * hidden])
         for i, part in enumerate("qkv")})
    timed = run["step_ms"][TRAIN_WARMUP:]
    tokens = TRAIN_BATCH * seq
    profile = profile_train_step(torch, exe, feeds)
    return {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "batch": TRAIN_BATCH, "seq": seq, "dtype": "bfloat16",
            "optimizer": "Adam", "lr": TRAIN_LR, "seed": seed,
            "executor_setup_s": run["setup_s"],
            "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_STEPS,
            "tokens_per_s": tokens * len(timed) / (sum(timed) / 1e3),
            "step_ms_p50": float(np.median(timed)),
            "step_ms": run["step_ms"], "losses": run["losses"],
            "launches": got, "peak_memory_bytes": int(run["peak"]),
            "parity": parity, "profile": profile}, run["launches"]


def profile_train_step(torch, exe, feeds):
    """One more training step under torch.profiler (profile_window)."""
    return profile_window(
        torch, lambda: exe.run(feed_dict=feeds)[0].asnumpy())


def profile_window(torch, fn, nodes=()):
    """``fn()`` once under torch.profiler: device busy time over the CUDA
    kernels and copies, the idle share of the window's wall time (the
    profiler's own host overhead included), device time by kernel
    category (PROFILE_CATEGORIES) and the kernels that took the most.
    With graph ``nodes``, each one's ``compute`` runs inside a profiler
    range named by its op type (which slows the host: take the idle
    share from a window without them), and ``device_ms_by_op_type``
    holds the device time of the kernels each op type launched, from
    the ranges' host-side events; their device-side copies are left out
    of the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def annotated(node, fn):
        def run(input_vals, ectx):
            with record_function(OP_RANGE + node.op_type):
                return fn(input_vals, ectx)
        return run

    for node in nodes:
        node.compute = annotated(node, node.compute)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for node in nodes:
            del node.compute
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.key.startswith(OP_RANGE)]
    by_op_type = {e.key[len(OP_RANGE):]: {"ms": e.device_time_total / 1e3,
                                          "count": e.count}
                  for e in events if e.key.startswith(OP_RANGE)
                  and e.device_type == DeviceType.CPU}
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]

    def kernel_ms(name):
        return sum(e.self_device_time_total for e in dev
                   if name in e.key) / 1e3
    by_category = {}
    for e in dev:
        cat = next((c for c, keys in PROFILE_CATEGORIES
                    if any(key in e.key.lower() for key in keys)), "other")
        ms, n = by_category.get(cat, (0.0, 0))
        by_category[cat] = (ms + e.self_device_time_total / 1e3,
                            n + e.count)
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if dev else None,
            "device_idle_share": 1.0 - busy / wall_ms if dev else None,
            "flash_fwd_kernel_ms": kernel_ms("flash_fwd"),
            "flash_bwd_dkv_kernel_ms": kernel_ms("flash_bwd_dkv"),
            "flash_bwd_dq_kernel_ms": kernel_ms("flash_bwd_dq"),
            "by_category": {c: {"ms": ms, "count": n}
                            for c, (ms, n) in sorted(
                                by_category.items(), key=lambda x: -x[1][0])},
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top],
            **({"device_ms_by_op_type": dict(sorted(
                by_op_type.items(), key=lambda x: -x[1]["ms"]))}
               if nodes else {})}


# ---------------------------------------------------------------------------
# pipelines: GPipe and PipeDream 1F1B over four stages of GPT-2-small
# ---------------------------------------------------------------------------

# GPT-2-small as ``train`` trains it (B=8, S=1024, bf16, Adam 1e-4, dropout
# 0, flash attention), built by models.staged_gpt over ht.gpu(0)..gpu(3):
# four stages of three blocks on the one card, M=4 microbatches of 2 rows
PP_STAGES, PP_MICROBATCHES = 4, 4
PP_MICROBATCH = TRAIN_BATCH // PP_MICROBATCHES
PP_WARMUP, PP_STEPS = 1, 4
PP_REP = dict(TRAIN_REP, b=PP_MICROBATCH)   # K2-K4's shape on this path
# the weights whose step-1 state the parity holds: Adam's first moment is
# (1 - beta1) x the step's gradient, so it is held as train holds the
# gradients (within GRAD_PARITY_TOL of its largest element; the qkv
# weight by its q, k and v column blocks), and the loss within one bf16
# ulp. The updated weights are reported in units of the rate: Adam's
# first step moves a weight by lr * g / (|g| + 3.2e-6), so a gradient
# near 0 whose sign the two runs round apart moves it by up to 2 lr
PP_PARITY_PARAMS = ("gpt_h0_attn_qkv_weights", "gpt_lm_head_weights")
# GPipe against the single-device executor is held in f32: the two run
# every GEMM at other shapes (2 rows against 8), and in bf16 that alone
# moves the layer-0 gradients by up to 7% of their largest element (the
# single-device executor against itself fed four microbatches: reported
# as ``bf16_four_microbatches_vs_whole_batch``). In f32 the loss within
# 1e-5 relative, the first moment within 1e-3 of its largest element
PP_F32_LOSS_RTOL, PP_F32_M_TOL = 1e-5, 1e-3
# the stash check: one 1F1B step at M=4 at this rate, against Adam applied
# four times in turn to each microbatch's gradient at the step's initial
# weights (all four forwards run before the first backward at M = S = 4,
# so each backward must read those weights). 1e-2 moves each weight by
# about half the initializer's std, so a backward that reads the updated
# weights instead of its stash fails the check
PP_STASH_LR = 1e-2
# pp_fleet: two worker processes, each owning two stages; after its steps
# (no more than the in-process passes run) each rank's PP_PARITY_PARAMS
# (layer 0's qkv on rank 0, the LM head on rank 1) are held against the
# in-process pass's after as many steps
PP_FLEET_WARMUP, PP_FLEET_STEPS = 1, 4
PP_FLEET_TIMEOUT_S = 300
# the memory record: where a step's memory goes at M = S and at M = 2S
# microbatches of one row (GPipe keeps every microbatch's activations
# until its backward, 1F1B at most S microbatches' with their stashes)
PP_MEMORY_MICROBATCHES = 2 * PP_STAGES


def _pp_batch(seed, vocab, seq, batch=TRAIN_BATCH):
    """train's batch: ids drawn from ``seed``, labels shifted by one."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, vocab, (batch, seq))
    return x, np.concatenate([x[:, 1:], np.full((batch, 1), -1)], axis=1)


def _pp_graph(ht, models, contexts, lr=TRAIN_LR, init=None,
              widths=GPT2_SMALL):
    """models.staged_gpt at ``widths``; with ``init`` ({name:
    numpy}) every drawn parameter takes its value from it instead of a
    new draw (the same values: the draws are seeded by name). Returns
    (ids, labels, loss, optimizer, train_op, {PP_PARITY_PARAMS name: its
    gradient node})."""
    from hetu_tpu_torch.graph.autodiff import find_topo_sort
    cfg = models.GPTConfig(**widths, hidden_dropout_prob=0.0,
                           use_flash_attention=True)
    ids, labels, loss, opt, train_op = models.staged_gpt(cfg, contexts, lr)
    if init is not None:
        for node in find_topo_sort([loss]):
            if getattr(node, "initializer", None) is not None:
                node.tensor_value = init[node.name]
    grads = {p.name: g for p, g in zip(opt.params, train_op.inputs)
             if p.name in PP_PARITY_PARAMS}
    return ids, labels, loss, opt, train_op, grads


def _pp_state(exe):
    """{PP_PARITY_PARAMS name: (f32 weight, Adam's first moment)}."""
    out = {}
    for sid, node in exe._param_nodes.items():
        if node.name in PP_PARITY_PARAMS:
            out[node.name] = (exe.params[sid].float().clone(),
                              exe.opt_state[node.id]["m"].float().clone())
    return out


def _pp_compare(got, want, lr, loss_rtol=None, m_tol=GRAD_PARITY_TOL):
    """Step parity of two runs' (loss, _pp_state): the loss within one
    bf16 ulp (``loss_rtol``: within that, relative), each first moment
    within ``m_tol`` of its largest element (qkv by q, k, v blocks); the
    weights' largest difference in units of ``lr``. Returns (ok,
    record)."""
    hidden = GPT2_SMALL["hidden_size"]
    (loss, state), (rloss, rstate) = got, want
    grad_err, weight_err = {}, {}
    for name, (w, m) in state.items():
        rw, rm = rstate[name]
        parts = ({p: slice(i * hidden, (i + 1) * hidden)
                  for i, p in enumerate("qkv")} if "qkv" in name
                 else {"": slice(None)})
        short = "qkv0." if "qkv" in name else "lm_head"
        for part, cols in parts.items():
            grad_err[short + part] = float((m[:, cols] - rm[:, cols]).abs()
                                           .max() / rm[:, cols].abs().max())
        weight_err[short.rstrip(".")] = float((w - rw).abs().max() / lr)
    rec = {"loss": loss, "loss_ref": rloss,
           "loss_tol": _bf16_ulp(rloss) if loss_rtol is None
           else loss_rtol * abs(rloss),
           "m_rel_err": grad_err, "m_tol": m_tol,
           "weight_max_diff_in_lr": weight_err}
    ok = abs(loss - rloss) <= rec["loss_tol"] and \
        max(grad_err.values()) <= m_tol
    return ok, rec


def _pp_executor(ht, torch, models, schedule, microbatches, init,
                 lr=TRAIN_LR, dtype="bfloat16"):
    """A pipeline executor over the four stages and its feeds (``dtype``
    None: f32)."""
    ids, labels, loss, _, train_op, _ = _pp_graph(
        ht, models, [ht.gpu(i) for i in range(PP_STAGES)], lr, init)
    exe = ht.Executor([loss, train_op],
                      dtype=dtype and getattr(torch, dtype),
                      num_microbatches=microbatches, **{schedule: True})
    return exe, ids, labels


def _pp_step1(torch, exe, feeds):
    out = exe.run(feed_dict=feeds)
    return float(out[0].asnumpy()), _pp_state(exe)


def _read_current_weights(exe):
    """The fault of the stash check: the 1F1B backward reads the stage's
    current weights instead of those its microbatch's forward read."""
    sub = exe.subexecutors["default"]
    stashed = sub._backward_env

    def backward_env(st, m):
        env, ectx = stashed(st, m)
        env.update(sub._compute_params(exe, st))
        return env, ectx
    sub._backward_env = backward_env


def pp_references(torch, seed):
    """What the pipeline passes are held to, from the single-device
    executor over the same graph in one stage (drawn once here; the
    pipelines reuse the draw): its first step on the whole batch (loss,
    _pp_state), and each microbatch's loss and PP_PARITY_PARAMS gradients
    at the initial weights (Adam at rate 0 leaves them), and its first
    step in f32. From those, the stash reference: Adam at PP_STASH_LR
    applied to each microbatch's gradients in turn, at the global step 0
    (1F1B's M updates of a step share its step count). Returns (init,
    {"bf16": step1, "f32": step1}, stash, info: the microbatch losses,
    and the four microbatches' mean gradient against the whole batch's,
    both bf16 and single-device)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    vocab = GPT2_SMALL["vocab_size"]
    seq = GPT2_SMALL["max_position_embeddings"]
    x, y = _pp_batch(seed, vocab, seq)
    xt, yt = (torch.as_tensor(a, device="cuda") for a in (x, y))
    ids, labels, loss, _, train_op, _ = _pp_graph(ht, M, [ht.gpu(0)])
    exe = ht.Executor([loss, train_op], dtype=torch.bfloat16)
    init = {node.name: exe.params[sid].cpu().numpy()
            for sid, node in exe._param_nodes.items()}
    step1 = {"bf16": _pp_step1(torch, exe, {ids: xt, labels: yt})}
    del exe
    ids, labels, loss, _, train_op, _ = _pp_graph(ht, M, [ht.gpu(0)],
                                                  init=init)
    exe = ht.Executor([loss, train_op])
    step1["f32"] = _pp_step1(torch, exe, {ids: xt, labels: yt})
    del exe
    ids, labels, loss, _, train_op, grads = _pp_graph(
        ht, M, [ht.gpu(0)], lr=0.0, init=init)
    names = list(grads)
    exe = ht.Executor([loss, *grads.values(), train_op],
                      dtype=torch.bfloat16)
    nodes = {n.name: n for n in exe._param_nodes.values()}
    mb = PP_MICROBATCH
    losses, mb_grads = [], []
    for m in range(PP_MICROBATCHES):
        out = exe.run(feed_dict={ids: xt[m * mb:(m + 1) * mb],
                                 labels: yt[m * mb:(m + 1) * mb]})
        losses.append(float(out[0].asnumpy()))
        mb_grads.append([o.tensor.float() for o in out[1:-1]])
    del exe
    opt = ht.optim.AdamOptimizer(learning_rate=PP_STASH_LR)
    state = {}
    for i, name in enumerate(names):
        node = nodes[name]
        w = torch.as_tensor(init[name], device="cuda")
        slots = opt.init_state({node: w})
        for g in mb_grads:
            new_w, new_s = opt.update({node: w}, {node: g[i]}, slots,
                                      PP_STASH_LR, 0)
            w, slots = new_w[node], new_s
        state[name] = (w, slots[node.id]["m"])
    stash = (float(torch.tensor(losses).mean()), state)
    # the single-device executor against itself: the whole batch's first
    # moment (1 - beta1) g against the four microbatches' mean gradient
    whole = step1["bf16"][1]
    split = {name: (whole[name][0], (1 - opt.beta1) * sum(
        g[i] for g in mb_grads) / len(mb_grads))
        for i, name in enumerate(names)}
    _, noise = _pp_compare((step1["bf16"][0], split), step1["bf16"], 1.0)
    torch.cuda.synchronize()
    return init, step1, stash, {
        "microbatch_losses": losses,
        "bf16_four_microbatches_vs_whole_batch": noise["m_rel_err"]}


def pp_pass(torch, schedule, card, seed, init, refs, train_p50):
    """``pp_gpipe`` / ``pp_1f1b``: the four-stage pipeline over M=4
    microbatches. First its checks: step 1 with the plain K2-K4 swapped
    in against step 1 with the kernels (as train_pass does), GPipe's step
    1 against the single-device executor's, and for 1F1B the same at M=1
    and the stash check at M=4 (the correct run must pass it, the run
    whose backward reads the current weights must fail it); then the main
    path: PP_WARMUP + PP_STEPS steps with the launch counts set to 0
    before and read after (K2, K3, K4 12·M a step, all on ``tc``, K1
    none), and one profiled step; then where a step's memory goes at
    M = S and at M = 2S (_pp_memory). Returns (line, launches, the loss
    and _pp_state on the host after the steps pp_fleet runs)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import attention as attn
    from hetu_tpu_torch.ops import flash_attention as fa
    vocab = GPT2_SMALL["vocab_size"]
    seq = GPT2_SMALL["max_position_embeddings"]
    xt, yt = (torch.as_tensor(a, device="cuda")
              for a in _pp_batch(seed, vocab, seq))
    step1, stash_ref = refs
    mode = "gpipe" if schedule == "gpipe" else "pipedream"
    checks = {}

    def one_step(microbatches, lr=TRAIN_LR, fault=False, dtype="bfloat16"):
        exe, ids, labels = _pp_executor(ht, torch, M, mode, microbatches,
                                        init, lr, dtype)
        if fault:
            _read_current_weights(exe)
        got = _pp_step1(torch, exe, {ids: xt, labels: yt})
        del exe
        torch.cuda.empty_cache()
        return got

    plain = {"flash_attention_with_lse": fa.flash_attention_with_lse_plain,
             "flash_attention_bwd": fa.flash_attention_bwd_plain}
    kernels = {key: getattr(attn, key) for key in plain}
    for key, fn in plain.items():
        setattr(attn, key, fn)
    try:
        plain_step1 = one_step(PP_MICROBATCHES)
    finally:
        for key, fn in kernels.items():
            setattr(attn, key, fn)
    if schedule == "gpipe":
        ok, checks["vs_single_device_f32"] = _pp_compare(
            one_step(PP_MICROBATCHES, dtype=None), step1["f32"], TRAIN_LR,
            PP_F32_LOSS_RTOL, PP_F32_M_TOL)
        if not ok:
            raise AssertionError(f"pp_gpipe step 1 against the "
                                 f"single-device executor (f32): {checks}")
    if schedule == "1f1b":
        ok, checks["m1_vs_single_device"] = _pp_compare(
            one_step(1), step1["bf16"], TRAIN_LR)
        if not ok:
            raise AssertionError(f"pp_1f1b at M=1 against the single-device "
                                 f"executor: {checks}")
        ok, checks["stash"] = _pp_compare(
            one_step(PP_MICROBATCHES, PP_STASH_LR), stash_ref, PP_STASH_LR)
        fault_ok, checks["stash_fault_current_weights"] = _pp_compare(
            one_step(PP_MICROBATCHES, PP_STASH_LR, fault=True), stash_ref,
            PP_STASH_LR)
        checks["stash"]["passes"] = ok
        checks["stash_fault_current_weights"]["passes"] = fault_ok
        if not ok or fault_ok:
            raise AssertionError(f"pp_1f1b: the stash check does not tell "
                                 f"the stash from the current weights: "
                                 f"{checks}")

    torch.cuda.synchronize()
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    exe, ids, labels = _pp_executor(ht, torch, M, mode, PP_MICROBATCHES,
                                    init)
    setup_s = time.perf_counter() - t0
    feeds = {ids: xt, labels: yt}
    losses, step_ms = [], []
    for i in range(PP_WARMUP + PP_STEPS):
        t0 = time.perf_counter()
        out = exe.run(feed_dict=feeds)
        losses.append(float(out[0].asnumpy()))      # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            kernel_step1 = (losses[0], _pp_state(exe))
        if i == PP_FLEET_WARMUP + PP_FLEET_STEPS - 1:
            # what pp_fleet holds its ranks to, kept off the card
            fleet_ref = (losses[i], {name: (w.cpu(), m.cpu()) for name, (
                w, m) in _pp_state(exe).items()})
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)           # main path ends
    peak = torch.cuda.max_memory_allocated()
    steps = PP_WARMUP + PP_STEPS
    per_step = GPT2_SMALL["num_hidden_layers"] * PP_MICROBATCHES
    want = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,), per_step * steps)
    got = {key: launches.get(key, 0) for key in want}
    if got != want:
        raise AssertionError(f"pp_{schedule} launches {got}, want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"pp_{schedule} losses not finite and falling: "
                             f"{losses}")
    ok, checks["plain_kernels"] = _pp_compare(kernel_step1, plain_step1,
                                              TRAIN_LR)
    if not ok:
        raise AssertionError(f"pp_{schedule} step 1 against the plain "
                             f"K2-K4: {checks}")
    if schedule == "gpipe":
        # reported, not held: bf16's rounding at other GEMM shapes (see
        # PP_F32_LOSS_RTOL); the f32 check above holds the schedule
        checks["vs_single_device_bf16"] = _pp_compare(
            kernel_step1, step1["bf16"], TRAIN_LR)[1]
    timed = step_ms[PP_WARMUP:]
    sub = exe.subexecutors["default"]
    profile = profile_window(torch, lambda: exe.run(feed_dict=feeds)[0]
                             .asnumpy())
    del exe
    torch.cuda.empty_cache()
    memory = {f"m{mb}": _pp_memory(torch, ht, M, mode, mb, init, xt, yt)
              for mb in (PP_MICROBATCHES, PP_MEMORY_MICROBATCHES)}
    return {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "schedule": schedule, "stages": PP_STAGES,
            "stage_devices": sorted({str(st.device) for st in sub.stages}),
            "blocks_per_stage": GPT2_SMALL["num_hidden_layers"] // PP_STAGES,
            "microbatches": PP_MICROBATCHES, "microbatch": PP_MICROBATCH,
            "batch": TRAIN_BATCH, "seq": seq, "dtype": "bfloat16",
            "optimizer": "Adam", "lr": TRAIN_LR, "seed": seed,
            "executor_setup_s": setup_s, "warmup_steps": PP_WARMUP,
            "timed_steps": PP_STEPS,
            "tokens_per_s": TRAIN_BATCH * seq * len(timed)
            / (sum(timed) / 1e3),
            "step_ms_p50": float(np.median(timed)),
            "train_step_ms_p50": train_p50,
            "step_ms": step_ms, "losses": losses,
            "analytic_bubble_fraction": sub.bubble_fraction,
            "launches": got,
            "launches_per_step": {k: v / steps for k, v in got.items()},
            "peak_memory_bytes": int(peak),
            "memory": memory, "checks": checks,
            "profile": profile}, launches, fleet_ref


def _pp_memory(torch, ht, M, mode, microbatches, init, xt, yt):
    """Where a pipeline step's memory goes: a fresh executor at
    ``microbatches``, one step, then a second with every stage's
    forward, backward and update watched. Bytes above what the script
    held before (``resident_bytes``): the executor's parameters and
    slots after the first step, the most held at the end of a forward
    (activations and stashes), and the peak inside the forwards, the
    backwards and the updates; ``peak_bytes`` is the largest."""
    torch.cuda.synchronize()
    _release(torch)
    resident = torch.cuda.memory_allocated()
    exe, ids, labels = _pp_executor(ht, torch, M, mode, microbatches, init)
    feeds = {ids: xt, labels: yt}
    exe.run(feed_dict=feeds)[0].asnumpy()
    torch.cuda.synchronize()
    rec = {"microbatches": microbatches,
           "microbatch": TRAIN_BATCH // microbatches,
           "resident_bytes": int(resident),
           "params_and_slots_bytes": int(torch.cuda.memory_allocated()
                                         - resident),
           "held_after_forward_bytes": 0, "peak_in_forward_bytes": 0,
           "peak_in_backward_bytes": 0, "peak_in_update_bytes": 0}
    sub = exe.subexecutors["default"]
    for phase in ("forward", "backward", "apply"):
        def watched(*args, _fn=getattr(sub, "_" + phase), _phase=phase):
            torch.cuda.reset_peak_memory_stats()
            out = _fn(*args)
            torch.cuda.synchronize()
            key = "update" if _phase == "apply" else _phase
            rec[f"peak_in_{key}_bytes"] = max(
                rec[f"peak_in_{key}_bytes"],
                int(torch.cuda.max_memory_allocated() - resident))
            if _phase == "forward":
                rec["held_after_forward_bytes"] = max(
                    rec["held_after_forward_bytes"],
                    int(torch.cuda.memory_allocated() - resident))
            return out
        setattr(sub, "_" + phase, watched)
    exe.run(feed_dict=feeds)[0].asnumpy()
    rec["peak_bytes"] = max(rec[f"peak_in_{k}_bytes"]
                            for k in ("forward", "backward", "update"))
    del exe, sub
    _release(torch)
    return rec


def _release(torch):
    """Free the card's memory held by dropped executors: one the checks
    patched (the watched stage calls, the faulty backward) is in a
    reference cycle and goes only when the collector runs, so a peak
    measured before would count its parameters and slots."""
    gc.collect()
    torch.cuda.empty_cache()


def pp_worker(spec):
    """One worker process of ``pp_fleet``, run by the launcher as
    ``python chip_smoke.py --pp-worker SPEC``: stages 2r and 2r + 1 on
    ``ht.rgpu("worker<r>", i)`` (on a one-card host all on cuda:0), GPipe
    then 1F1B, each PP_FLEET_WARMUP + PP_FLEET_STEPS steps on train's
    batch with fresh weights (the in-process passes' draw: both are
    seeded by name). Writes ``worker_<rank>.json``: the losses (on the
    rank that owns the loss stage), step times, the channel's bytes and
    seconds each step, launches and peak memory; and
    ``state_<rank>_<mode>.pt``: the PP_PARITY_PARAMS it owns after the
    steps (_pp_state, on the host)."""
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import _build
    rank = int(os.environ["HETU_PROC_ID"])
    vocab = GPT2_SMALL["vocab_size"]
    seq = GPT2_SMALL["max_position_embeddings"]
    xt, yt = (torch.as_tensor(a, device="cuda")
              for a in _pp_batch(spec["seed"], vocab, seq))
    contexts = [ht.rgpu(f"worker{i // 2}", i) for i in range(PP_STAGES)]
    out = {"rank": rank, "schedules": {}}
    for mode in ("gpipe", "pipedream"):
        t0 = time.perf_counter()
        ids, labels, loss, _, train_op, _ = _pp_graph(ht, M, contexts)
        exe = ht.Executor([loss, train_op], dtype=torch.bfloat16,
                          num_microbatches=PP_MICROBATCHES, **{mode: True})
        sub = exe.subexecutors["default"]
        rec = {"executor_setup_s": time.perf_counter() - t0,
               "owned_stages": [st.index for st in sub.stages
                                if st.device is not None],
               "devices": sorted({str(st.device) for st in sub.stages
                                  if st.device is not None}),
               "params": len(exe.params), "losses": [], "step_ms": [],
               "channel": []}
        channel = ht.parallel.get_channel()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()                # main path starts
        for _ in range(PP_FLEET_WARMUP + PP_FLEET_STEPS):
            channel.reset_stats()
            t0 = time.perf_counter()
            res = exe.run(feed_dict={ids: xt, labels: yt})
            if res[0] is not None:
                rec["losses"].append(float(res[0].asnumpy()))
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["channel"].append(channel.stats())
        rec["launches"] = _k1_k4_launches(_build.launch_counts)  # ends
        rec["launches_tc"] = {k: v for k, v in _build.launch_counts.items()
                              if k.endswith(".tc")}
        rec["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated())
        out["schedules"][mode] = rec
        torch.save({name: (w.cpu(), m.cpu())
                    for name, (w, m) in _pp_state(exe).items()},
                   os.path.join(spec["out"], f"state_{rank}_{mode}.pt"))
        del exe, sub
        torch.cuda.empty_cache()
    with open(os.path.join(spec["out"], f"worker_{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def pp_fleet_pass(card, seed, inproc):
    """``pp_fleet``: two worker processes started by ``python
    hetu_tpu_torch/run_launcher.py`` (``spmd: true``: one job, the pipeline
    channel's addresses exported), each running pp_worker on the one
    card, stage boundaries crossing the host channel in bf16. Held
    against the in-process passes (``inproc``: {schedule: (losses,
    (loss, _pp_state) after the fleet's steps)}): the losses of the rank
    that owns the loss stage, each within one bf16 ulp, and after the
    last step the state of layer 0's qkv (rank 0: trained only by the
    adjoints that crossed back from rank 1) and of the LM head (rank 1),
    by _pp_compare. The boundaries cross as their bf16 bits, so the ops
    are the in-process run's, but the card's atomics (the embedding
    gradient's scatter-add) may sum in another order; how many losses
    and tensors are bit-equal is reported. Each rank launches K2, K3 and
    K4 6·M times a step (its six blocks), all on tc, K1 none."""
    import shutil
    import tempfile
    import torch
    from hetu_tpu_torch.ops import flash_attention as fa
    out_dir = tempfile.mkdtemp(prefix="pp_fleet_")
    try:
        wall, _ = _launch_job(
            "pp_fleet", "spmd: true\nnodes:\n  - host: localhost\n"
            "    workers: 2\n    chief: true\n", "--pp-worker",
            {"seed": seed, "out": out_dir}, PP_FLEET_TIMEOUT_S, False)
        records, states = [], {"gpipe": {}, "pipedream": {}}
        for r in range(2):
            with open(os.path.join(out_dir, f"worker_{r}.json")) as f:
                records.append(json.load(f))
            for mode, state in states.items():
                state.update(torch.load(
                    os.path.join(out_dir, f"state_{r}_{mode}.pt")))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    steps = PP_FLEET_WARMUP + PP_FLEET_STEPS
    per_rank = GPT2_SMALL["num_hidden_layers"] // 2 * PP_MICROBATCHES * steps
    line = {"card": card, "model": "gpt2-small", "workers": 2,
            "stages": PP_STAGES, "microbatches": PP_MICROBATCHES,
            "batch": TRAIN_BATCH, "dtype": "bfloat16",
            "boundary_dtype": "bfloat16", "steps": steps,
            "timed_steps": PP_FLEET_STEPS, "launcher_wall_s": wall,
            "schedules": {}}
    faults = []
    for mode, schedule in (("gpipe", "gpipe"), ("pipedream", "1f1b")):
        got = records[1]["schedules"][mode]["losses"]
        losses, final = inproc[schedule]
        want = losses[:steps]
        tol = [_bf16_ulp(w) for w in want]
        sched = {"losses": got, "in_process_losses": want,
                 "loss_tol": tol, "bit_equal_losses": sum(
                     g == w for g, w in zip(got, want)), "ranks": []}
        if records[0]["schedules"][mode]["losses"] or len(got) != steps \
                or any(abs(g - w) > t for g, w, t in zip(got, want, tol)):
            faults.append(f"{schedule} losses {got} (rank 0: "
                          f"{records[0]['schedules'][mode]['losses']}) "
                          f"against {want}")
        state = states[mode]
        if sorted(state) != sorted(PP_PARITY_PARAMS):
            faults.append(f"{schedule}: the ranks wrote {sorted(state)}")
        else:
            ok, sched["state_after_steps"] = _pp_compare(
                (got[-1] if got else float("nan"), state), final, TRAIN_LR)
            sched["state_after_steps"]["bit_equal_tensors"] = sum(
                torch.equal(a, b) for name in PP_PARITY_PARAMS
                for a, b in zip(state[name], final[1][name]))
            if not ok:
                faults.append(f"{schedule} state after {steps} steps: "
                              f"{sched['state_after_steps']}")
        for rec in records:
            r = rec["schedules"][mode]
            timed = r["step_ms"][PP_FLEET_WARMUP:]
            chan = r["channel"][PP_FLEET_WARMUP:]
            sched["ranks"].append({
                "rank": rec["rank"], "owned_stages": r["owned_stages"],
                "devices": r["devices"], "params": r["params"],
                "executor_setup_s": r["executor_setup_s"],
                "step_ms": r["step_ms"],
                "step_ms_p50": float(np.median(timed)),
                "channel_bytes_per_step": float(np.mean(
                    [c["sent_bytes"] + c["recv_bytes"] for c in chan])),
                "channel_send_s_per_step": float(np.mean(
                    [c["send_s"] for c in chan])),
                "channel_recv_wait_s_per_step": float(np.mean(
                    [c["recv_wait_s"] for c in chan])),
                "channel_messages_per_step": float(np.mean(
                    [c["sent_messages"] + c["recv_messages"]
                     for c in chan])),
                "launches": r["launches"],
                "peak_memory_bytes": r["peak_memory_bytes"]})
            want_l = {fa.K1: 0, fa.K2: per_rank, fa.K3: per_rank,
                      fa.K4: per_rank}
            if r["launches"] != want_l or any(
                    r["launches_tc"].get(f"{k}.tc", 0) != per_rank
                    for k in (fa.K2, fa.K3, fa.K4)) \
                    or r["devices"] != ["cuda:0"]:
                faults.append(f"{schedule} rank {rec['rank']} on "
                              f"{r['devices']} launched {r['launches']} "
                              f"({r['launches_tc']}), want {want_l}")
        sched["step_ms_p50"] = max(x["step_ms_p50"] for x in sched["ranks"])
        sched["tokens_per_s"] = TRAIN_BATCH * GPT2_SMALL[
            "max_position_embeddings"] / (sched["step_ms_p50"] / 1e3)
        line["schedules"][schedule] = sched
    if faults:
        raise AssertionError(f"pp_fleet: {faults}")
    return line


# ---------------------------------------------------------------------------
# collective_gpt, collective_parity: the collective pipeline
# (pipeline_mode="collective"), one tick loop over each stage's stream
# ---------------------------------------------------------------------------

# GPT-2-small's 12 decoder blocks as a uniform chain of four stages of
# three blocks on ht.gpu(0)..gpu(3) (the one card four times): the
# contract wants homogeneous stages, so the embeddings and the LM head
# are left out (as bench.py:1962-1978 closes its collective chain): a
# feed x [B, 1024, 768] enters stage 0, the last stage's loss is the mean
# sparse softmax cross-entropy of its [B·S, 768] output against labels
# in [0, 768). B=8, M=4, bf16, Adam, dropout 0 (pp_gpipe's settings)
COLL_STAGES, COLL_MICROBATCHES = 4, 4
COLL_WARMUP, COLL_STEPS = 1, 3
COLL_REPEAT_STEPS = 3            # a fresh executor's, bit-equal
# the interleaved run: the 12 blocks as 12 one-block chunks at V=3, chunk
# k on device k mod 4 under a host name of its own per group of four
# (``v{k // 4}:gpu:{k % 4}``, as tests/test_autoplan.py places them)
COLL_V, COLL_V_WARMUP, COLL_V_STEPS = 3, 1, 2
COLL_BF16_WARMUP, COLL_BF16_STEPS = 1, 2
# step-1 parity as the pp_* checks hold it: the loss within one bf16 ulp,
# Adam's first moments of stage 0's qkv (by q, k, v) and of the last
# stage's MLP projection within GRAD_PARITY_TOL of their largest element
COLL_MOMENTS = ("coll_h0_attn_qkv_weights", "coll_h11_mlp_proj_weights")
# collective_parity: 4 stages of 2 blocks, 64 wide (one head of 64),
# S=512, B=8 at M=8, f32, 3 Adam steps against the staged GPipe runner
COLL_PARITY = dict(hidden_size=64, num_attention_heads=1,
                   max_position_embeddings=512, vocab_size=64)
COLL_PARITY_PER_STAGE, COLL_PARITY_M, COLL_PARITY_STEPS = 2, 8, 3
COLL_PARITY_LOSS_RTOL, COLL_PARITY_WEIGHT_TOL = 1e-5, 1e-4


def _coll_chain(ht, models, contexts, per_stage, widths, lr=TRAIN_LR):
    """``per_stage`` GPT blocks (``coll_h{i}``: the same names, so the
    same seeded draws, however the chain is staged) under each context:
    x [B, S, hidden] in, the mean sparse softmax cross-entropy of the
    last stage's [B·S, hidden] output out. Returns (x, labels, loss,
    train_op)."""
    cfg = models.GPTConfig(**{**widths, "num_hidden_layers":
                              len(contexts) * per_stage},
                           hidden_dropout_prob=0.0, use_flash_attention=True)
    seq, hidden = cfg.max_position_embeddings, cfg.hidden_size
    blocks = [models.gpt.GPTBlock(cfg, name=f"coll_h{i}")
              for i in range(cfg.num_hidden_layers)]
    for s, ctx in enumerate(contexts):
        with ht.context(ctx):
            if s == 0:
                x = ht.Variable("coll_x", trainable=False)
                act = x
            for block in blocks[s * per_stage:(s + 1) * per_stage]:
                act = block(act, seq)
            if s == len(contexts) - 1:
                labels = ht.Variable("coll_labels", trainable=False)
                loss = ht.reduce_mean_op(ht.softmaxcrossentropy_sparse_op(
                    ht.array_reshape_op(act, [-1, hidden]), labels), [0])
                train_op = ht.optim.AdamOptimizer(
                    learning_rate=lr).minimize(loss)
    return x, labels, loss, train_op


def _coll_feeds(torch, seed, batch, widths):
    g = torch.Generator(device="cuda").manual_seed(seed)
    seq, hidden = widths["max_position_embeddings"], widths["hidden_size"]
    x = torch.randn(batch, seq, hidden, device="cuda", generator=g)
    y = torch.randint(0, hidden, (batch * seq,), device="cuda", generator=g)
    return x, y


def _coll_state(exe, names):
    """{name: (f32 weight, Adam's first moment)} of the named weights."""
    return {node.name: (exe.params[sid].float().clone(),
                        exe.opt_state[node.id]["m"].float().clone())
            for sid, node in exe._param_nodes.items() if node.name in names}


def _coll_compare(got, want, hidden, m_tol=GRAD_PARITY_TOL):
    """Step-1 parity of two (loss, _coll_state): the loss within one bf16
    ulp, each first moment within ``m_tol`` of its largest element (a
    qkv weight by its q, k, v column blocks). Returns (ok, record)."""
    (loss, state), (rloss, rstate) = got, want
    m_err = {}
    for name, (_, m) in state.items():
        rm = rstate[name][1]
        parts = ({p: slice(i * hidden, (i + 1) * hidden)
                  for i, p in enumerate("qkv")} if "qkv" in name
                 else {"": slice(None)})
        for part, cols in parts.items():
            m_err[name + (f".{part}" if part else "")] = float(
                (m[:, cols] - rm[:, cols]).abs().max()
                / rm[:, cols].abs().max())
    rec = {"loss": loss, "loss_ref": rloss, "loss_tol": _bf16_ulp(rloss),
           "m_rel_err": m_err, "m_tol": m_tol}
    ok = abs(loss - rloss) <= rec["loss_tol"] and \
        max(m_err.values()) <= m_tol
    return ok, rec


def _coll_session(torch, contexts, per_stage, widths, feeds, steps, mode,
                  microbatches, dtype="bfloat16", pp_options=None,
                  keep=None):
    """A pipeline executor over ``_coll_chain``, ``steps`` steps, each
    ending in the loss's readback. Returns (executor, losses, step ms,
    _coll_state of ``keep`` after step 1)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    x, labels, loss, train_op = _coll_chain(ht, M, contexts, per_stage,
                                            widths)
    exe = ht.Executor([loss, train_op], dtype=dtype and getattr(torch, dtype),
                      num_microbatches=microbatches,
                      pp_options=pp_options, **mode)
    losses, step_ms, state1 = [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        out = exe.run(feed_dict={x: feeds[0], labels: feeds[1]})
        losses.append(float(out[0].asnumpy()))          # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0 and keep:
            state1 = _coll_state(exe, keep)
    return exe, losses, step_ms, state1


def collective_pass(torch, card, seed, pp_line, train_p50):
    """``collective_gpt``: the chain under ``gpipe=True`` (1 + 3 steps),
    then the main path, ``pipeline_mode="collective"`` (1 + 3 steps, the
    launch counts set to 0 before and read after: K2, K3, K4 12·M a step,
    all on ``tc``, K1 none), one profiled step; a fresh collective
    executor's first 3 losses, bit-equal (a stream race would show); the
    interleaved run (12 one-block chunks at V=3, 1 + 2 steps) against
    ``gpipe=True`` over the same 12 stages; ``boundary_dtype="bf16"``
    (1 + 2 steps) within BOUNDARY_RTOL. ``collective_parity``: the f32
    chain against the staged runner. Returns ({line name: line},
    {"main": launches, "interleaved": launches})."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import flash_attention as fa
    from hetu_tpu_torch.parallel.collective_pp import BOUNDARY_RTOL
    widths = {k: GPT2_SMALL[k] for k in ("hidden_size", "num_attention_heads",
                                         "max_position_embeddings",
                                         "vocab_size")}
    hidden, seq = widths["hidden_size"], widths["max_position_embeddings"]
    blocks = GPT2_SMALL["num_hidden_layers"]
    per_stage = blocks // COLL_STAGES
    contexts = [ht.gpu(i) for i in range(COLL_STAGES)]
    feeds = _coll_feeds(torch, seed, TRAIN_BATCH, widths)
    M = COLL_MICROBATCHES
    collective = {"pipeline_mode": "collective"}
    checks, faults = {}, []

    def run(ctxs, per, steps, mode, **kw):
        return _coll_session(torch, ctxs, per, widths, feeds, steps, mode,
                             M, keep=COLL_MOMENTS, **kw)[1:]

    _release(torch)
    staged = _coll_session(torch, contexts, per_stage, widths, feeds,
                           COLL_WARMUP + COLL_STEPS, {"gpipe": True}, M,
                           keep=COLL_MOMENTS)
    staged_ms = staged[2][COLL_WARMUP:]
    staged = staged[1:]
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    exe, losses, step_ms, state1 = _coll_session(
        torch, contexts, per_stage, widths, feeds, COLL_WARMUP + COLL_STEPS,
        collective, M, keep=COLL_MOMENTS)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)           # main path ends
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    sub = exe.subexecutors["default"]
    cpp = sub._cpp
    stage_streams = [str(s) for s in cpp.streams]
    x_node, y_node = sub.stages[0].feed_nodes[0], \
        sub.stages[-1].feed_nodes[0]
    profile = profile_window(torch, lambda: exe.run(feed_dict={
        x_node: feeds[0], y_node: feeds[1]})[0].asnumpy())
    del exe, sub, cpp
    _release(torch)
    steps = COLL_WARMUP + COLL_STEPS
    per_step = blocks * M
    want = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,), per_step * steps)
    got = {key: launches.get(key, 0) for key in want}
    if got != want:
        faults.append(f"launches {got}, want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        faults.append(f"losses not finite and falling: {losses}")
    ok, checks["vs_staged"] = _coll_compare((losses[0], state1),
                                            (staged[0][0], staged[2]),
                                            hidden)
    checks["vs_staged"]["losses"] = losses
    checks["vs_staged"]["staged_losses"] = staged[0]
    later = [abs(a - b) <= _bf16_ulp(b) for a, b in zip(losses, staged[0])]
    checks["vs_staged"]["every_loss_within_one_ulp"] = all(later)
    if not ok or not all(later):
        faults.append(f"collective against staged: {checks['vs_staged']}")

    repeat = run(contexts, per_stage, COLL_REPEAT_STEPS, collective)
    checks["repeat_bit_equal"] = {
        "losses": repeat[0], "first_run": losses[:COLL_REPEAT_STEPS],
        "equal": repeat[0] == losses[:COLL_REPEAT_STEPS]}
    if not checks["repeat_bit_equal"]["equal"]:
        faults.append(f"a fresh executor's losses differ: "
                      f"{checks['repeat_bit_equal']}")
    _release(torch)

    s_dev = COLL_STAGES
    chunks = [f"v{k // s_dev}:gpu:{k % s_dev}" for k in range(blocks)]
    v_steps = COLL_V_WARMUP + COLL_V_STEPS
    v_staged = run(chunks, 1, v_steps, {"gpipe": True})
    _release(torch)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    v_losses, v_ms, v_state = run(chunks, 1, v_steps, collective,
                                  pp_options={"virtual_stages": COLL_V})
    torch.cuda.synchronize()
    v_launches = dict(_build.launch_counts)
    v_wall = time.perf_counter() - t0
    _release(torch)
    v_want = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,),
                           per_step * v_steps)
    v_got = {key: v_launches.get(key, 0) for key in v_want}
    if v_got != v_want:
        faults.append(f"interleaved launches {v_got}, want {v_want}")
    ok, checks["interleaved_vs_staged"] = _coll_compare(
        (v_losses[0], v_state), (v_staged[0][0], v_staged[2]), hidden)
    checks["interleaved_vs_staged"]["losses"] = v_losses
    checks["interleaved_vs_staged"]["staged_losses"] = v_staged[0]
    later = [abs(a - b) <= _bf16_ulp(b) for a, b in
             zip(v_losses, v_staged[0])]
    checks["interleaved_vs_staged"]["every_loss_within_one_ulp"] = all(later)
    if not ok or not all(later):
        faults.append(f"interleaved against staged: "
                      f"{checks['interleaved_vs_staged']}")

    b_losses = run(contexts, per_stage, COLL_BF16_WARMUP + COLL_BF16_STEPS,
                   collective, pp_options={"boundary_dtype": "bf16"})[0]
    _release(torch)
    rel = [abs(a - b) / abs(b) for a, b in zip(b_losses, losses)]
    # in a bf16 session the boundary is bf16 already: the cast is exact
    checks["bf16_boundary"] = {
        "losses": b_losses, "f32_boundary_losses": losses[:len(b_losses)],
        "rel_err": rel, "rtol": BOUNDARY_RTOL,
        "bit_equal": b_losses == losses[:len(b_losses)]}
    if max(rel) > BOUNDARY_RTOL:
        faults.append(f"bf16 boundary: {checks['bf16_boundary']}")
    if faults:
        raise AssertionError(f"collective_gpt: {faults}")

    timed = step_ms[COLL_WARMUP:]
    v_timed = v_ms[COLL_V_WARMUP:]
    line = {"card": card, "model": "gpt2-small blocks (no embeddings, no "
            "LM head: a feed x [B, S, 768] in, a parameter-free sparse "
            "cross-entropy of the last block's output against labels in "
            "[0, 768) out)", "blocks": blocks, **widths,
            "stages": COLL_STAGES, "blocks_per_stage": per_stage,
            "stage_contexts": [str(c) for c in contexts],
            "stage_streams": stage_streams,
            "microbatches": M, "microbatch": TRAIN_BATCH // M,
            "batch": TRAIN_BATCH, "seq": seq, "dtype": "bfloat16",
            "optimizer": "Adam", "lr": TRAIN_LR, "seed": seed,
            "warmup_steps": COLL_WARMUP, "timed_steps": COLL_STEPS,
            "tokens_per_s": TRAIN_BATCH * seq * len(timed)
            / (sum(timed) / 1e3),
            "step_ms_p50": float(np.median(timed)),
            "staged_step_ms_p50": float(np.median(staged_ms)),
            "pp_gpipe_step_ms_p50": pp_line["step_ms_p50"],
            "train_step_ms_p50": train_p50,
            "step_ms": step_ms, "staged_step_ms": staged_ms,
            "losses": losses, "main_path_wall_s": wall_s,
            "launches": got,
            "launches_per_step": {k: v / steps for k, v in got.items()},
            "peak_memory_bytes": int(peak),
            "interleaved": {
                "chunks": blocks, "virtual_stages": COLL_V,
                "devices": s_dev, "chunk_contexts": chunks,
                "microbatches": M, "warmup_steps": COLL_V_WARMUP,
                "timed_steps": COLL_V_STEPS,
                "step_ms_p50": float(np.median(v_timed)),
                "staged_step_ms_p50": float(np.median(
                    v_staged[1][COLL_V_WARMUP:])),
                "step_ms": v_ms, "losses": v_losses, "wall_s": v_wall,
                "launches": v_got,
                "launches_per_step": {k: v / v_steps
                                      for k, v in v_got.items()}},
            "checks": checks, "profile": profile}
    parity = collective_parity(torch, card, seed)
    return {"collective_gpt": line, "collective_parity": parity}, \
        {"main": launches, "interleaved": v_launches}


def collective_parity(torch, card, seed):
    """The f32 chain (4 stages of 2 blocks, 64 wide, S=512, B=8, M=8, 3
    Adam steps, ``simt`` K2-K4) under ``pipeline_mode="collective"``
    against ``gpipe=True``: losses within 1e-5 relative, every weight
    within 1e-4 of its largest element; and with ``boundary_dtype=
    "bf16"``, whose losses stay within BOUNDARY_RTOL."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.parallel.collective_pp import BOUNDARY_RTOL
    contexts = [ht.gpu(i) for i in range(COLL_STAGES)]
    feeds = _coll_feeds(torch, seed + 1, TRAIN_BATCH, COLL_PARITY)
    runs, launches = {}, {}
    for name, mode, opts in (
            ("staged", {"gpipe": True}, None),
            ("collective", {"pipeline_mode": "collective"}, None),
            ("bf16_boundary", {"pipeline_mode": "collective"},
             {"boundary_dtype": "bf16"})):
        _build.reset_launch_counts()
        exe, losses, _, _ = _coll_session(
            torch, contexts, COLL_PARITY_PER_STAGE, COLL_PARITY, feeds,
            COLL_PARITY_STEPS, mode, COLL_PARITY_M, dtype=None,
            pp_options=opts)
        torch.cuda.synchronize()
        launches[name] = {k: v for k, v in _build.launch_counts.items()
                          if v}
        runs[name] = (losses, {node.name: exe.params[sid].float().clone()
                               for sid, node in exe._param_nodes.items()})
        del exe
    (want, w_want), (got, w_got) = runs["staged"], runs["collective"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    weight_err = max(float((w_got[n] - w).abs().max() / w.abs().max())
                     for n, w in w_want.items())
    bf16 = runs["bf16_boundary"][0]
    bf16_err = max(abs(a - b) / abs(b) for a, b in zip(bf16, got))
    line = {"card": card, **COLL_PARITY, "stages": COLL_STAGES,
            "blocks_per_stage": COLL_PARITY_PER_STAGE,
            "microbatches": COLL_PARITY_M, "batch": TRAIN_BATCH,
            "dtype": "float32", "steps": COLL_PARITY_STEPS,
            "losses": got, "staged_losses": want,
            "loss_rel_err": loss_err, "loss_rtol": COLL_PARITY_LOSS_RTOL,
            "weight_rel_err": weight_err,
            "weight_tol": COLL_PARITY_WEIGHT_TOL,
            "bf16_boundary_losses": bf16, "bf16_boundary_rel_err": bf16_err,
            "bf16_boundary_rtol": BOUNDARY_RTOL, "launches": launches}
    if loss_err > COLL_PARITY_LOSS_RTOL or \
            weight_err > COLL_PARITY_WEIGHT_TOL or \
            bf16_err > BOUNDARY_RTOL or not got[-1] < got[0]:
        raise AssertionError(f"collective_parity: {line}")
    return line


# ---------------------------------------------------------------------------
# dp_gpt, dp_parity: GPT-2-small data parallel across two launcher
# processes on the one card (gloo); hybrid_fleet: WDL's dense weights
# all-reduced beside its table on a parameter server
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_REP = dict(TRAIN_REP, b=TRAIN_BATCH // DP_RANKS)   # K2-K4 in each rank
DP_WARMUP, DP_STEPS = 1, 3
DP_BUCKET_BYTES = 25 << 20          # PyTorch DDP's default bucket
# the step-1 global loss (the mean of the ranks' bf16 losses over 4096
# tokens each) against train's (one bf16 loss over 8192): two bf16
# roundings of a loss near 11, one ulp 2**-4, ~0.6% of it
DP_LOSS_TOL = 1e-2
DP_SAME_TOL = 1e-5      # a weight across ranks, of its largest element
# dp_parity: 2 layers at full width in f32 (K2-K4 on simt), global batch
# 4, against one process: losses relative; Adam's first moments (linear
# in the averaged gradients: a gradient not divided by the rank count
# doubles them) and the weights, of each tensor's largest element. Adam
# moves an element by lr * m / (sqrt(v) + eps), so where an element's
# gradient cancels to near eps, its step is a rounding-dependent
# fraction of lr; a tensor that starts at 0 (the biases) holds elements
# of a few lr after 3 steps, so it is held at 1e-3 of them (the q/v
# biases differ by 2.9e-4 of theirs on the H100, PERF.md §6)
DP_PARITY_LAYERS, DP_PARITY_BATCH, DP_PARITY_STEPS = 2, 4, 3
DP_PARITY_LOSS_TOL = 1e-5
DP_PARITY_WEIGHT_TOL = 1e-4
DP_PARITY_ZERO_INIT_TOL = 1e-3
DP_TIMEOUT_S = 400
# hybrid_fleet: one server, two workers, each a rank of one job fed the
# global batch of both workers' ps_wdl traffic (B=128 a worker)
HYBRID_WORKERS = 2
HYBRID_BSP_STEPS = 20


def _gpt_graph(ht, models, widths, dropout=0.0, sp=None):
    """train's graph (bench.py:1103-1118) at ``widths`` (and hidden
    dropout ``dropout``, ``sequence_parallel=sp``): (ids, labels, the
    mean loss, the Adam train op)."""
    cfg = models.GPTConfig(**widths, hidden_dropout_prob=dropout,
                           use_flash_attention=True, sequence_parallel=sp)
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _, loss = models.GPTLMHeadModel(cfg)(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    return ids, labels, lm, ht.optim.AdamOptimizer(
        learning_rate=TRAIN_LR).minimize(lm)


def _gpt_rows(seed, batch):
    """train's batch (its first ``batch`` rows): ids and next-token
    labels."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, GPT2_SMALL["vocab_size"],
                    (TRAIN_BATCH, GPT2_SMALL["max_position_embeddings"]))
    y = np.concatenate([x[:, 1:], np.full((TRAIN_BATCH, 1), -1)], axis=1)
    return x[:batch], y[:batch]


def _master_state(exe):
    """{parameter name: its f32 master} of a session."""
    return {node.name: exe.params[sid]
            for sid, node in exe._param_nodes.items()}


def _parity_state(exe):
    """{parameter name: (f32 master, Adam's first moment)} of dp_parity's
    session, on the host."""
    return {node.name: (exe.params[sid].cpu(),
                        exe.opt_state[node.id]["m"].cpu())
            for sid, node in exe._param_nodes.items()
            if node.id in exe.opt_state}


def _across_ranks(torch, dist, tensors, group=None):
    """max over ``tensors`` of max |rank 0's - rank 1's| / max |rank 0's|
    of ``group`` (two ranks; None: the job's): rank 1 all-reduces its
    negated copy onto rank 0's."""
    worst = 0.0
    for t in tensors:
        d = t.detach().float().clone()
        if dist.get_rank(group) == 1:
            d.neg_()
        dist.all_reduce(d, group=group)
        scale = float(t.detach().float().abs().max()) or 1.0
        worst = max(worst, float(d.abs().max()) / scale)
    return worst


def _comm_per_step(stats, steps):
    return {kind: {"calls": s["calls"] / steps,
                   "bytes": s["bytes"] / steps,
                   "ms": s["seconds"] * 1e3 / steps}
            for kind, s in stats.items()}


def dp_worker(spec):
    """One rank of ``dp_gpt`` and ``dp_parity``, run by the launcher as
    ``python chip_smoke.py --dp-worker SPEC`` (``spmd: true``: one job of
    DP_RANKS processes). ``dp_gpt``: train's model and batch at full
    width and depth through ``Executor.run`` in bf16 with
    ``overlap_options={"bucket_bytes": DP_BUCKET_BYTES}``; the executor
    joins the job, the rank runs its 4 rows of the global 8, the launch
    counts set to 0 before the steps and read after; then the largest
    difference of any weight between the ranks. ``dp_parity``: the model
    at DP_PARITY_LAYERS layers in f32 on DP_PARITY_BATCH rows, whose
    weights rank 0 saves for the one-process run to be held to. Writes
    ``worker_<rank>.json`` (and ``parity_state.pt``)."""
    import torch
    import torch.distributed as dist
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import _build
    rank = int(os.environ["RANK"])
    t0 = time.perf_counter()
    ids, labels, lm, train_op = _gpt_graph(ht, M, GPT2_SMALL)
    exe = ht.Executor([lm, train_op], dtype=torch.bfloat16,
                      overlap_options={"bucket_bytes": DP_BUCKET_BYTES})
    cfg = exe.config
    rec = {"rank": rank, "executor_setup_s": time.perf_counter() - t0,
           "backend": dist.get_backend(), "nrank": cfg.nrank,
           "comm_mode": cfg.comm_mode, "device": str(cfg.device),
           "bucketed_gradients": len(
               exe.subexecutors["default"].allreduce_defer)}
    x, y = _gpt_rows(spec["seed"], TRAIN_BATCH)
    feeds = {ids: torch.as_tensor(x, device=cfg.device),
             labels: torch.as_tensor(y, device=cfg.device)}
    comm = cfg.dp_comm
    comm.sync_timing = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    losses, step_ms = [], []
    for i in range(DP_WARMUP + DP_STEPS):
        if i == DP_WARMUP:
            comm.reset_stats()
            dist.barrier()
            rec["window_start"] = time.time()
        t = time.perf_counter()
        losses.append(float(exe.run(feed_dict=feeds)[0].asnumpy()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    rec["window_end"] = time.time()
    rec["launches"] = dict(_build.launch_counts)    # main path ends
    rec.update(losses=losses, step_ms=step_ms,
               step_ms_p50=float(np.median(step_ms[DP_WARMUP:])),
               comm_per_step=_comm_per_step(comm.stats, DP_STEPS),
               peak_memory_bytes=int(torch.cuda.max_memory_allocated()))
    state = _master_state(exe)
    rec["weights_rel_diff_across_ranks"] = _across_ranks(
        torch, dist, state.values())
    rec["token_table_rel_diff_across_ranks"] = _across_ranks(
        torch, dist, [state["gpt_wte"]])
    del exe, state, feeds
    _release(torch)

    widths = dict(GPT2_SMALL, num_hidden_layers=DP_PARITY_LAYERS)
    ids, labels, lm, train_op = _gpt_graph(ht, M, widths)
    exe = ht.Executor([lm, train_op])
    x, y = _gpt_rows(spec["seed"], DP_PARITY_BATCH)
    feeds = {ids: torch.as_tensor(x, device=cfg.device),
             labels: torch.as_tensor(y, device=cfg.device)}
    rec["parity_losses"] = [float(exe.run(feed_dict=feeds)[0].asnumpy())
                            for _ in range(DP_PARITY_STEPS)]
    if rank == 0:
        torch.save(_parity_state(exe),
                   os.path.join(spec["out"], "parity_state.pt"))
    with open(os.path.join(spec["out"], f"worker_{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    return 0


# the launcher by path (hetu_tpu_torch/run_launcher.py): the same main as
# ``python -m hetu_tpu_torch.launcher`` without the package's __init__,
# so a job's launcher does not spend seconds importing torch
LAUNCHER = os.path.join(ROOT, "hetu_tpu_torch", "run_launcher.py")


def _launch_job(name, config, flag, spec, timeout, sample_card,
                launcher_args=(), env=None):
    """``python hetu_tpu_torch/run_launcher.py -c <config>
    [launcher_args]`` running
    ``python chip_smoke.py <flag> SPEC`` in each worker, in a session of
    its own killed whole if it outlives ``timeout``; ``spec["out"]`` is a
    temp dir (removed by the caller) for the workers' records. With
    ``sample_card`` nvidia-smi's used memory is sampled while the job
    runs. A launcher that exits non-zero raises with its log's tail.
    ``env`` adds to the launcher's environment (which its workers
    inherit). Returns (wall seconds, the used-memory samples in MiB)."""
    import threading
    cfg = os.path.join(spec["out"], "cluster.yml")
    with open(cfg, "w") as f:
        f.write(config)
    cmd = [sys.executable, LAUNCHER, "-c", cfg, *launcher_args,
           sys.executable, os.path.join(ROOT, "chip_smoke.py"), flag,
           json.dumps(spec)]
    # the launcher keeps a leaked fleet environment from its servers and
    # workers; HETU_PS_REPLICATE it reads itself: these jobs have no
    # replicas
    env = {**os.environ, "HETU_PS_REPLICATE": "0",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""),
           **(env or {})}
    used, stop = [], threading.Event()

    def sample():
        while not stop.wait(0.5):
            used.append(_card_memory_used_mib())

    sampler = threading.Thread(target=sample, daemon=True)
    if sample_card:
        sampler.start()
    log_path = os.path.join(spec["out"], "job.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=logf,
                                stderr=subprocess.STDOUT,
                                stdin=subprocess.DEVNULL,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = f"no exit within {timeout} s"
        finally:
            stop.set()
            try:
                os.killpg(proc.pid, 9)          # whatever is left of it
            except ProcessLookupError:
                pass
            proc.wait()
    wall = time.perf_counter() - t0
    if sample_card:
        sampler.join()
    if rc != 0:
        # the workers write into the launcher's log: their stderr, and
        # the launcher's line naming the rank that failed and how
        with open(log_path) as f:
            tail = f.read()[-8000:]
        how = f" (a worker killed by signal {256 - rc})" \
            if isinstance(rc, int) and rc > 128 else ""
        raise AssertionError(f"{name}: launcher exit {rc}{how}\n{tail}")
    return wall, used


def dp_parity_reference(torch, seed):
    """dp_parity's one process on the card: the same graph, rows and
    steps with no job joined. Returns (losses, _parity_state, the names
    of the parameters that start at 0)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    widths = dict(GPT2_SMALL, num_hidden_layers=DP_PARITY_LAYERS)
    ids, labels, lm, train_op = _gpt_graph(ht, M, widths)
    exe = ht.Executor([lm, train_op])
    zero_init = {name for name, w in _master_state(exe).items()
                 if not w.any()}
    x, y = _gpt_rows(seed, DP_PARITY_BATCH)
    feeds = {ids: torch.as_tensor(x, device="cuda"),
             labels: torch.as_tensor(y, device="cuda")}
    losses = [float(exe.run(feed_dict=feeds)[0].asnumpy())
              for _ in range(DP_PARITY_STEPS)]
    return losses, _parity_state(exe), zero_init


def _parity_line(losses, got_state, ref, zero_grad=None):
    """A 2-layer f32 parity run of several ranks (``dp_parity``,
    ``tp_parity``, ``sp_parity``) against the one process ``ref``
    (losses, state, the names of the parameters that start at 0): losses
    within DP_PARITY_LOSS_TOL relative, Adam's first moments within
    DP_PARITY_WEIGHT_TOL and the weights within DP_PARITY_WEIGHT_TOL
    (DP_PARITY_ZERO_INIT_TOL for a tensor that starts at 0) of each
    tensor's largest element. ``zero_grad`` maps a tensor whose exact
    gradient is 0 (BERT's attention key biases: a shift of every key
    adds one term to all of a query's scores, which the softmax cancels)
    to a tensor of the same layer: each run's moves are its own rounding
    noise, scaled by Adam to steps of lr, so such a tensor is held by its
    first moment instead, within DP_PARITY_WEIGHT_TOL of the other's
    largest. Returns (the line's numbers, ok)."""
    ref_losses, ref_state, zero_init = ref
    zero_grad = zero_grad or {}
    parity_rel = abs(np.asarray(losses) - ref_losses) / np.abs(ref_losses)
    weight_err, moment_err, noise = {}, {}, {}
    for name, other in zero_grad.items():
        noise[name] = float(got_state[name][1].abs().max()
                            / got_state[other][1].abs().max())
    for name, (ref_w, ref_m) in ref_state.items():
        if name in zero_grad:
            continue
        got_w, got_m = got_state[name]
        weight_err[name] = float((got_w - ref_w).abs().max()
                                 / (ref_w.abs().max() or 1.0))
        moment_err[name] = float((got_m - ref_m).abs().max()
                                 / (ref_m.abs().max() or 1.0))
    weight_faults = {
        name: err for name, err in weight_err.items()
        if err > (DP_PARITY_ZERO_INIT_TOL if name in zero_init
                  else DP_PARITY_WEIGHT_TOL)}
    worst = max(weight_err, key=weight_err.get)
    worst_m = max(moment_err, key=moment_err.get)
    trained = [n for n in weight_err if n not in zero_init]
    worst_trained = max(trained, key=weight_err.get)
    line = {"losses": losses, "reference_losses": ref_losses,
            "loss_rel_err": float(parity_rel.max()),
            "loss_tol": DP_PARITY_LOSS_TOL,
            "weight_err_of_largest": weight_err[worst],
            "worst_weight": worst,
            "worst_nonzero_init_weight": [worst_trained,
                                          weight_err[worst_trained]],
            "weight_tol": DP_PARITY_WEIGHT_TOL,
            "zero_init_weight_tol": DP_PARITY_ZERO_INIT_TOL,
            "zero_init_weights": sorted(zero_init),
            "first_moment_err_of_largest": moment_err[worst_m],
            "worst_first_moment": worst_m,
            "tensors_compared": len(weight_err),
            **({"zero_gradient_first_moment_of_other": noise}
               if zero_grad else {})}
    ok = sorted(got_state) == sorted(ref_state) and \
        line["loss_rel_err"] <= DP_PARITY_LOSS_TOL and not weight_faults \
        and moment_err[worst_m] <= DP_PARITY_WEIGHT_TOL \
        and all(v <= DP_PARITY_WEIGHT_TOL for v in noise.values())
    return line, ok


def dp_pass(card, seed, train_line):
    """``dp_gpt`` and ``dp_parity``: DP_RANKS processes of one job
    started by ``python hetu_tpu_torch/run_launcher.py`` (``spmd: true``),
    each ``python chip_smoke.py --dp-worker SPEC`` on the one card, where
    the executors pick gloo (NCCL refuses two ranks on one card). The
    checks: the backend gloo, each rank on cuda:0; K2, K3 and K4 12
    launches a step in each rank, all on tc, K1 none; the step-1 global
    loss against train's step 1 (the same weights and rows) within
    DP_LOSS_TOL; every weight, the token table among them, the same on
    both ranks within DP_SAME_TOL of its largest element. dp_parity:
    rank 0's losses within DP_PARITY_LOSS_TOL, its Adam first moments
    within DP_PARITY_WEIGHT_TOL and its weights within
    DP_PARITY_WEIGHT_TOL (DP_PARITY_ZERO_INIT_TOL for a tensor that
    starts at 0) of each tensor's largest element against the one
    process on the card (dp_parity_reference). Returns ({"dp_gpt":
    line, "dp_parity": line}, dp_gpt's launch counts summed over the
    ranks, the one-process reference, which ``tp_parity`` is held to
    too)."""
    import shutil
    import tempfile
    import torch
    from hetu_tpu_torch.ops import flash_attention as fa
    t = time.perf_counter()
    ref_losses, ref_state, zero_init = dp_parity_reference(torch, seed)
    ref_s = time.perf_counter() - t
    _release(torch)
    out_dir = tempfile.mkdtemp(prefix="dp_job_")
    try:
        wall, used = _launch_job(
            "dp", f"spmd: true\nnodes:\n  - host: localhost\n"
            f"    workers: {DP_RANKS}\n    chief: true\n", "--dp-worker",
            {"seed": seed, "out": out_dir}, DP_TIMEOUT_S, True)
        records = []
        for r in range(DP_RANKS):
            with open(os.path.join(out_dir, f"worker_{r}.json")) as f:
                records.append(json.load(f))
        got_state = torch.load(os.path.join(out_dir, "parity_state.pt"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    steps = DP_WARMUP + DP_STEPS
    per_rank = GPT2_SMALL["num_hidden_layers"] * steps
    want_l = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,), per_rank)
    faults = []
    ranks = []
    for rec in records:
        got_l = {k: rec["launches"].get(k, 0) for k in want_l}
        if got_l != want_l:
            faults.append(f"rank {rec['rank']} launched {got_l}")
        if rec["backend"] != "gloo" or rec["device"] != "cuda:0" or \
                rec["nrank"] != DP_RANKS or rec["comm_mode"] != "AllReduce":
            faults.append(f"rank {rec['rank']}: {rec['backend']} on "
                          f"{rec['device']}, {rec['nrank']} ranks, "
                          f"{rec['comm_mode']}")
        for key in ("weights_rel_diff_across_ranks",
                    "token_table_rel_diff_across_ranks"):
            if rec[key] > DP_SAME_TOL:
                faults.append(f"rank {rec['rank']} {key} {rec[key]}")
        ranks.append({k: rec[k] for k in (
            "rank", "device", "executor_setup_s", "step_ms", "step_ms_p50",
            "comm_per_step", "peak_memory_bytes", "bucketed_gradients",
            "weights_rel_diff_across_ranks",
            "token_table_rel_diff_across_ranks")})
        ranks[-1]["launches_per_step"] = {
            k: rec["launches"].get(k, 0) / steps
            for k in (fa.K1, fa.K2, fa.K3, fa.K4)}
    losses = records[0]["losses"]
    step1 = losses[0]
    train1 = train_line["losses"][0]
    loss_err = abs(step1 - train1) / abs(train1)
    if loss_err > DP_LOSS_TOL or not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0] or \
            any(r["losses"] != losses for r in records):
        faults.append(f"losses {[r['losses'] for r in records]} against "
                      f"train's step 1 {train1}")
    window = max(r["window_end"] - r["window_start"] for r in records)
    tokens = TRAIN_BATCH * GPT2_SMALL["max_position_embeddings"]
    p50 = max(r["step_ms_p50"] for r in records)
    dp_gpt = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
              "ranks": DP_RANKS, "global_batch": TRAIN_BATCH,
              "rows_per_rank": TRAIN_BATCH // DP_RANKS,
              "seq": GPT2_SMALL["max_position_embeddings"],
              "dtype": "bfloat16", "optimizer": "Adam", "lr": TRAIN_LR,
              "backend": records[0]["backend"],
              "bucket_bytes": DP_BUCKET_BYTES, "warmup_steps": DP_WARMUP,
              "timed_steps": DP_STEPS,
              "tokens_per_s": tokens * DP_STEPS / window,
              "slowest_window_s": window, "step_ms_p50": p50,
              "train_step_ms_p50": train_line["step_ms_p50"],
              "step_cost_vs_train": p50 / train_line["step_ms_p50"],
              "losses": losses, "step1_global_loss": step1,
              "train_step1_loss": train1, "step1_loss_rel_err": loss_err,
              "loss_tol": DP_LOSS_TOL, "same_weights_tol": DP_SAME_TOL,
              "launcher_wall_s": wall,
              "card_memory_used_mib_max": max(used) if used else None,
              "card_memory_samples": len(used), "per_rank": ranks}
    dp_parity, parity_ok = _parity_line(
        records[0]["parity_losses"], got_state,
        (ref_losses, ref_state, zero_init))
    dp_parity = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
                 "num_hidden_layers": DP_PARITY_LAYERS, "dtype": "float32",
                 "ranks": DP_RANKS, "global_batch": DP_PARITY_BATCH,
                 "steps": DP_PARITY_STEPS, "reference": "one process on "
                 "the card, no job joined", "reference_s": ref_s,
                 **dp_parity}
    if not parity_ok:
        faults.append(f"dp_parity {dp_parity}")
    if faults:
        log(f"dp failed: {dp_gpt}")
        raise AssertionError(f"dp: {faults}")
    counts = {}
    for rec in records:
        for k, v in rec["launches"].items():
            counts[k] = counts.get(k, 0) + v
    return {"dp_gpt": dp_gpt, "dp_parity": dp_parity}, counts, \
        (ref_losses, ref_state, zero_init)


# ---------------------------------------------------------------------------
# tp_gpt, tp_parity: the train model split by the default rules at tp=2,
# two ranks of one launcher job on the one card
# ---------------------------------------------------------------------------

TP_RANKS = 2
TP_WARMUP, TP_STEPS = 1, 2
TP_DROPOUT = 0.1        # the timed steps' hidden dropout
# step 1 (dropout 0) against one process at the same weights and rows:
# the loss within DP_LOSS_TOL; Adam's first moment of these (each rank's
# block against the same block) within GRAD_PARITY_TOL of its largest
# element: the k-split products' bf16 partial sums round otherwise than
# one product of the whole contraction
TP_MOMENTS = ("gpt_h0_attn_qkv_weights", "gpt_lm_head_weights")
# a replicated weight across the ranks after the timed steps, of its
# largest element: both ranks compute every replicated value from the
# same inputs (dropout's masks from the same generator)
TP_SAME_TOL = 1e-6
TP_TIMEOUT_S = 400


def _tp_split(ht, nodes):
    """The default rules compiled at tp=TP_RANKS and spliced into the
    graph (the JAX package's way to put dispatch specs on a model);
    returns the bindings' parameter names."""
    bindings, _ = ht.parallel.compile_rules(nodes, tp=TP_RANKS)
    ht.parallel.apply_rules(nodes, bindings)
    return sorted(b.param.name for b in bindings)


def _params_and_slots_bytes(exe):
    return sum(t.numel() * t.element_size() for t in exe.params.values()) \
        + sum(t.numel() * t.element_size() for slots in
              exe.opt_state.values() for t in slots.values())


def tp_reference(torch, seed):
    """One process's step 1 of tp_gpt's graph without the split (train's
    model, weights and rows, dropout 0, bf16): its loss, Adam's first
    moments of TP_MOMENTS (on the host), and the parameter and slot
    bytes and parameter elements it holds."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    ids, labels, lm, train_op = _gpt_graph(ht, M, GPT2_SMALL)
    exe = ht.Executor([lm, train_op], dtype=torch.bfloat16)
    x, y = _gpt_rows(seed, TRAIN_BATCH)
    loss = float(exe.run(feed_dict={
        ids: torch.as_tensor(x, device="cuda"),
        labels: torch.as_tensor(y, device="cuda")})[0].asnumpy())
    nodes = {n.name: n for n in exe._param_nodes.values()}
    moments = {name: exe.opt_state[nodes[name].id]["m"].cpu()
               for name in TP_MOMENTS}
    return {"loss": loss, "moments": moments,
            "params_and_slots_bytes": _params_and_slots_bytes(exe),
            "param_elements": sum(t.numel() for t in exe.params.values())}


def tp_worker(spec):
    """One rank of ``tp_gpt`` and ``tp_parity``, run by the launcher as
    ``python chip_smoke.py --tp-worker SPEC`` (``spmd: true``: one job of
    TP_RANKS processes; nothing passes a mesh, the executor lays the
    plan over the job). Step 1 of the split graph at dropout 0, whose
    loss and first moments (this rank's blocks) go to the parent; then
    the timed steps at TP_DROPOUT through ``Executor.run`` in bf16, the
    launch counts set to 0 before them and read after, the collectives
    timed after a device sync; then the largest difference of a
    replicated weight between the ranks. ``tp_parity``: the model at
    DP_PARITY_LAYERS layers in f32 on DP_PARITY_BATCH rows, its weights
    and first moments gathered whole, saved by rank 0. ``spec`` may set
    ``device`` and ``widths`` (a rehearsal on the CPU at small widths).
    Writes ``worker_<rank>.json``, ``moments_<rank>.pt`` and
    ``parity_state.pt``."""
    import torch
    import torch.distributed as dist
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import _build
    rank = int(os.environ["RANK"])
    device = spec.get("device", "cuda")
    widths = spec.get("widths", GPT2_SMALL)
    batch = spec.get("batch", TRAIN_BATCH)
    dtype = torch.bfloat16 if device == "cuda" else None

    def rows(n):
        # train's rows; a rehearsal's narrower model takes their first
        # positions, its ids folded into its vocabulary
        x = _gpt_rows(spec["seed"], n)[0][
            :, :widths["max_position_embeddings"]] % widths["vocab_size"]
        return x, np.concatenate([x[:, 1:], np.full((n, 1), -1)], axis=1)

    def session(nodes, **options):
        # on the card the entry point's own default: cuda:{LOCAL_RANK}
        if device != "cuda":
            options["device"] = device
        exe = ht.Executor(nodes, **options)
        return exe, {n.name: n for n in exe._param_nodes.values()}

    ids, labels, lm, train_op = _gpt_graph(ht, M, widths)
    bound = _tp_split(ht, [lm, train_op])
    t0 = time.perf_counter()
    exe, nodes = session([lm, train_op], dtype=dtype)
    cfg = exe.config
    rec = {"rank": rank, "executor_setup_s": time.perf_counter() - t0,
           "backend": dist.get_backend(), "nrank": cfg.nrank,
           "mesh": dict(cfg.mesh.shape), "coord": cfg.mesh.coord("tp0"),
           "device": str(cfg.device), "bound": bound}
    x, y = rows(batch)
    feeds = {ids: torch.as_tensor(x, device=cfg.device),
             labels: torch.as_tensor(y, device=cfg.device)}
    rec["step1_loss"] = float(exe.run(feed_dict=feeds)[0].asnumpy())
    torch.save({name: (exe.opt_state[nodes[name].id]["m"].cpu(),
                       exe._layout(nodes[name])) for name in TP_MOMENTS},
               os.path.join(spec["out"], f"moments_{rank}.pt"))
    rec["shards"] = {name: [list(node.shape), list(exe.params[str(
        node.id)].shape), exe._layout(node)] for name, node in nodes.items()}
    rec["params_and_slots_bytes"] = _params_and_slots_bytes(exe)
    rec["param_elements"] = sum(t.numel() for t in exe.params.values())
    del exe, feeds
    _release(torch)

    ids, labels, lm, train_op = _gpt_graph(ht, M, widths, TP_DROPOUT)
    _tp_split(ht, [lm, train_op])
    exe, nodes = session([lm, train_op], dtype=dtype)
    sub = exe.subexecutors["default"]
    comm = exe.config.mesh.comm("tp0")
    comm.sync_timing = True
    feeds = {ids: torch.as_tensor(x, device=cfg.device),
             labels: torch.as_tensor(y, device=cfg.device)}
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    losses, step_ms = [], []
    for i in range(TP_WARMUP + TP_STEPS):
        if i == TP_WARMUP:
            comm.reset_stats()
            sub.tp.reset_stats()
            dist.barrier()
            rec["window_start"] = time.time()
        t = time.perf_counter()
        losses.append(float(exe.run(feed_dict=feeds)[0].asnumpy()))
        if cuda:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    rec["window_end"] = time.time()
    rec["launches"] = dict(_build.launch_counts)    # main path ends
    per_step = {kind: {op: n / TP_STEPS for op, n in counts.items()}
                for kind, counts in sub.tp.moves.items()}
    rec.update(losses=losses, step_ms=step_ms,
               step_ms_p50=float(np.median(step_ms[TP_WARMUP:])),
               comm_per_step=_comm_per_step(comm.stats, TP_STEPS),
               moves_per_step=per_step,
               gather_rule_per_step={op: n / TP_STEPS for op, n in
                                     sub.tp.gather_rule.items()},
               peak_memory_bytes=int(torch.cuda.max_memory_allocated())
               if cuda else None)
    rec["replicated_rel_diff_across_ranks"] = _across_ranks(
        torch, dist, [exe.params[str(n.id)] for n in nodes.values()
                      if exe._layout(n) is None])
    del exe, feeds
    _release(torch)

    parity_widths = dict(widths, num_hidden_layers=DP_PARITY_LAYERS)
    ids, labels, lm, train_op = _gpt_graph(ht, M, parity_widths)
    _tp_split(ht, [lm, train_op])
    exe, nodes = session([lm, train_op])
    x, y = rows(DP_PARITY_BATCH)
    feeds = {ids: torch.as_tensor(x, device=cfg.device),
             labels: torch.as_tensor(y, device=cfg.device)}
    rec["parity_losses"] = [float(exe.run(feed_dict=feeds)[0].asnumpy())
                            for _ in range(DP_PARITY_STEPS)]
    state = {name: (exe._whole(n, exe.params[str(n.id)]).cpu(),
                    exe._whole(n, exe.opt_state[n.id]["m"]).cpu())
             for name, n in nodes.items() if n.id in exe.opt_state}
    if rank == 0:
        torch.save(state, os.path.join(spec["out"], "parity_state.pt"))
    with open(os.path.join(spec["out"], f"worker_{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    return 0


def _tp_job(seed, out_dir, sample_card, **spec):
    """tp_gpt's job: TP_RANKS launcher processes of one spmd job, each
    ``python chip_smoke.py --tp-worker SPEC``. Returns (wall s, the
    card's used-memory samples, the workers' records by rank, rank 0's
    parity state, each rank's first moments)."""
    import torch
    wall, used = _launch_job(
        "tp", f"spmd: true\nnodes:\n  - host: localhost\n"
        f"    workers: {TP_RANKS}\n    chief: true\n", "--tp-worker",
        {"seed": seed, "out": out_dir, **spec}, TP_TIMEOUT_S, sample_card)
    records, moments = [], []
    for r in range(TP_RANKS):
        with open(os.path.join(out_dir, f"worker_{r}.json")) as f:
            records.append(json.load(f))
        moments.append(torch.load(os.path.join(out_dir,
                                               f"moments_{r}.pt")))
    return wall, used, records, torch.load(
        os.path.join(out_dir, "parity_state.pt")), moments


def _block(ref, layout, coord):
    """The block of a whole ``ref`` a rank holds in ``layout`` (a dim
    split over the one tp axis: its coord-th part)."""
    for d, axes in enumerate(layout or ()):
        if axes:
            n = ref.shape[d] // TP_RANKS
            ref = ref.narrow(d, coord * n, n)
    return ref


def tp_pass(card, seed, train_line, parity_ref):
    """``tp_gpt`` and ``tp_parity``: TP_RANKS processes of one job
    started by ``python hetu_tpu_torch/run_launcher.py`` (``spmd: true``) on
    the one card, where the executors pick gloo. The checks: the
    backend gloo, each rank on cuda:0 at its coordinate of a ("tp0",)
    mesh; K2, K3 and K4 12 launches a step in each rank, all on tc, K1
    none; step 1 (dropout 0) against one process at the same weights
    and rows (tp_reference): the loss within DP_LOSS_TOL, Adam's first
    moments of TP_MOMENTS (each rank's block) within GRAD_PARITY_TOL of
    their largest element; the timed losses finite and falling; every
    replicated weight the same on both ranks within TP_SAME_TOL of its
    largest element; every split weight at its shard's shape (one dim
    halved). tp_parity: rank 0's losses, first moments and weights
    against ``parity_ref`` (``dp_parity``'s one process) as dp_parity
    holds them. Returns ({"tp_gpt": line, "tp_parity": line}, tp_gpt's
    launch counts summed over the ranks, tp_reference's one process,
    which the sp passes are held to too)."""
    import shutil
    import tempfile
    import torch
    from hetu_tpu_torch.ops import flash_attention as fa
    t = time.perf_counter()
    ref = tp_reference(torch, seed)
    ref_s = time.perf_counter() - t
    _release(torch)
    out_dir = tempfile.mkdtemp(prefix="tp_job_")
    try:
        wall, used, records, got_state, moments = _tp_job(seed, out_dir,
                                                          True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    steps = TP_WARMUP + TP_STEPS
    want_l = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,),
                           GPT2_SMALL["num_hidden_layers"] * steps)
    faults, ranks = [], []
    split_want = {"gpt_wpe"} | {
        f"gpt_h{i}_{w}_weights"
        for i in range(GPT2_SMALL["num_hidden_layers"])
        for w in ("attn_qkv", "attn_proj", "mlp_fc", "mlp_proj")}
    for rec, mom in zip(records, moments):
        r = rec["rank"]
        got_l = {k: rec["launches"].get(k, 0) for k in want_l}
        if got_l != want_l:
            faults.append(f"rank {r} launched {got_l}")
        if rec["backend"] != "gloo" or rec["device"] != "cuda:0" or \
                rec["mesh"] != {"tp0": TP_RANKS} or rec["coord"] != r:
            faults.append(f"rank {r}: {rec['backend']} on {rec['device']}, "
                          f"mesh {rec['mesh']} at {rec['coord']}")
        split = {name for name, (_, _, lay) in rec["shards"].items() if lay}
        halved = all(
            got == [s // TP_RANKS if ax else s for s, ax in zip(whole, lay)]
            for whole, got, lay in rec["shards"].values() if lay)
        if split != split_want or set(rec["bound"]) != split_want or \
                not halved:
            faults.append(f"rank {r} split {sorted(split)}, bound "
                          f"{rec['bound']}, shapes halved {halved}")
        moment_err = {}
        for name, (m, layout) in mom.items():
            want = _block(ref["moments"][name], layout, r)
            moment_err[name] = float((m - want).abs().max()
                                     / want.abs().max())
        if max(moment_err.values()) > GRAD_PARITY_TOL:
            faults.append(f"rank {r} first moments {moment_err}")
        if rec["replicated_rel_diff_across_ranks"] > TP_SAME_TOL:
            faults.append(f"rank {r} replicated weights differ by "
                          f"{rec['replicated_rel_diff_across_ranks']}")
        ranks.append({k: rec[k] for k in (
            "rank", "device", "coord", "executor_setup_s", "step_ms",
            "step_ms_p50", "comm_per_step", "moves_per_step",
            "gather_rule_per_step", "peak_memory_bytes",
            "params_and_slots_bytes", "param_elements", "step1_loss",
            "replicated_rel_diff_across_ranks")})
        ranks[-1]["first_moment_err_of_largest"] = moment_err
        ranks[-1]["launches_per_step"] = {
            k: rec["launches"].get(k, 0) / steps
            for k in (fa.K1, fa.K2, fa.K3, fa.K4)}
    losses = records[0]["losses"]
    step1 = records[0]["step1_loss"]
    loss_err = abs(step1 - ref["loss"]) / abs(ref["loss"])
    if loss_err > DP_LOSS_TOL or not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0] or \
            any(r["losses"] != losses or r["step1_loss"] != step1
                for r in records):
        faults.append(f"losses {[r['losses'] for r in records]}, step 1 "
                      f"{[r['step1_loss'] for r in records]} against one "
                      f"process's {ref['loss']}")
    window = max(r["window_end"] - r["window_start"] for r in records)
    tokens = TRAIN_BATCH * GPT2_SMALL["max_position_embeddings"]
    p50 = max(r["step_ms_p50"] for r in records)
    tp_gpt = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
              "tp": TP_RANKS, "rows_per_rank": TRAIN_BATCH,
              "seq": GPT2_SMALL["max_position_embeddings"],
              "dtype": "bfloat16", "optimizer": "Adam", "lr": TRAIN_LR,
              "dropout": TP_DROPOUT, "rules": "DEFAULT_RULES",
              "split_params": len(split_want),
              "backend": records[0]["backend"],
              "warmup_steps": TP_WARMUP, "timed_steps": TP_STEPS,
              "tokens_per_s": tokens * TP_STEPS / window,
              "slowest_window_s": window, "step_ms_p50": p50,
              "train_step_ms_p50": train_line["step_ms_p50"],
              "step_cost_vs_train": p50 / train_line["step_ms_p50"],
              "losses": losses, "step1_loss": step1,
              "one_process_step1_loss": ref["loss"],
              "step1_loss_rel_err": loss_err, "loss_tol": DP_LOSS_TOL,
              "first_moment_tol": GRAD_PARITY_TOL,
              "same_weights_tol": TP_SAME_TOL,
              "one_process_params_and_slots_bytes":
                  ref["params_and_slots_bytes"],
              "one_process_param_elements": ref["param_elements"],
              "reference_s": ref_s, "launcher_wall_s": wall,
              "card_memory_used_mib_max": max(used) if used else None,
              "card_memory_samples": len(used), "per_rank": ranks}
    line, parity_ok = _parity_line(records[0]["parity_losses"], got_state,
                                   parity_ref)
    tp_parity = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
                 "num_hidden_layers": DP_PARITY_LAYERS, "dtype": "float32",
                 "tp": TP_RANKS, "batch": DP_PARITY_BATCH,
                 "steps": DP_PARITY_STEPS, "reference": "dp_parity's one "
                 "process on the card", **line}
    if not parity_ok:
        faults.append(f"tp_parity {tp_parity}")
    if faults:
        log(f"tp failed: {tp_gpt}")
        raise AssertionError(f"tp: {faults}")
    counts = {}
    for rec in records:
        for k, v in rec["launches"].items():
            counts[k] = counts.get(k, 0) + v
    return {"tp_gpt": tp_gpt, "tp_parity": tp_parity}, counts, ref


# ---------------------------------------------------------------------------
# TP and DP inside pipeline stages: GPT-2-small in 2 stages x tp=2
# ---------------------------------------------------------------------------

# train's model, rows and rate in PP_TP_STAGES stages of six blocks, each
# over a tuple of TP_RANKS worker devices and split by DEFAULT_RULES at
# tp=TP_RANKS: four ranks of one launcher job, GPipe at M=PP_MICROBATCHES
# (K2-K4 at PP_REP's B=2 in every rank). Step 1 is held against the same
# stages in one process (pp_tp_reference): the loss within one bf16 ulp,
# the first moments of PP_PARITY_PARAMS (layer 0's qkv in stage 0, the
# LM head in stage 1) within GRAD_PARITY_TOL of their largest element
PP_TP_STAGES = 2
PP_TP_RANKS = PP_TP_STAGES * TP_RANKS
PP_TP_WARMUP, PP_TP_STEPS = 0, 2     # after step 1
PP_TP_TIMEOUT_S = 400
PP_TP_SCHEDULES = {"gpipe": "gpipe", "1f1b": "pipedream"}


def _pp_tp_contexts(ht, split=True):
    """The stages' contexts: a tuple of TP_RANKS worker devices each
    (``split``), else one device each (the one-process reference)."""
    if not split:
        return [ht.gpu(s) for s in range(PP_TP_STAGES)]
    return [tuple(ht.rgpu(f"worker{s * TP_RANKS + k}", 0)
                  for k in range(TP_RANKS)) for s in range(PP_TP_STAGES)]


def _pp_tp_session(ht, widths, schedule, dtype, split=True,
                   device=None):
    """A pipeline executor over the staged model (split by the default
    rules where ``split``): (executor, ids, labels, the split parameters'
    names)."""
    from hetu_tpu_torch import models as M
    ids, labels, loss, _, train_op, _ = _pp_graph(
        ht, M, _pp_tp_contexts(ht, split), widths=widths)
    bound = _tp_split(ht, [loss, train_op]) if split else []
    exe = ht.Executor([loss, train_op], dtype=dtype,
                      num_microbatches=PP_MICROBATCHES,
                      **{PP_TP_SCHEDULES[schedule]: True},
                      **({"device": device} if device else {}))
    return exe, ids, labels, bound


def _pp_tp_rows(seed, widths, n):
    """train's first ``n`` rows; a rehearsal's narrower model takes their
    first positions, its ids folded into its vocabulary."""
    x = _gpt_rows(seed, n)[0][:, :widths["max_position_embeddings"]] \
        % widths["vocab_size"]
    return x, np.concatenate([x[:, 1:], np.full((n, 1), -1)], axis=1)


def pp_tp_reference(torch, seed):
    """The same stages in one process, each on the card whole: step 1 of
    pp_tp_gpt's graph in bf16 (its loss, Adam's first moments of
    PP_PARITY_PARAMS on the host, the parameter and slot bytes and the
    parameter elements), and pp_tp_parity's runs in f32 by schedule
    (losses, _parity_state, the names of the parameters that start at
    0)."""
    import hetu_tpu_torch as ht
    exe, ids, labels, _ = _pp_tp_session(ht, GPT2_SMALL, "gpipe",
                                         torch.bfloat16, split=False)
    x, y = _gpt_rows(seed, TRAIN_BATCH)
    loss = float(exe.run(feed_dict={ids: x, labels: y})[0].asnumpy())
    nodes = {n.name: n for n in exe._param_nodes.values()}
    ref = {"loss": loss,
           "moments": {name: exe.opt_state[nodes[name].id]["m"].cpu()
                       for name in PP_PARITY_PARAMS},
           "params_and_slots_bytes": _params_and_slots_bytes(exe),
           "param_elements": sum(t.numel() for t in exe.params.values())}
    del exe
    _release(torch)
    widths = dict(GPT2_SMALL, num_hidden_layers=DP_PARITY_LAYERS)
    x, y = _gpt_rows(seed, DP_PARITY_BATCH)
    ref["parity"] = {}
    for schedule in PP_TP_SCHEDULES:
        exe, ids, labels, _ = _pp_tp_session(ht, widths, schedule, None,
                                             split=False)
        zero_init = {name for name, w in _master_state(exe).items()
                     if not w.any()}
        losses = [float(exe.run(feed_dict={ids: x, labels: y})[0]
                        .asnumpy()) for _ in range(DP_PARITY_STEPS)]
        ref["parity"][schedule] = (losses, _parity_state(exe), zero_init)
        del exe
        _release(torch)
    return ref


def pp_tp_worker(spec):
    """One rank of ``pp_tp_gpt`` and ``pp_tp_parity``, run by the
    launcher as ``python chip_smoke.py --pp-tp-worker SPEC`` (``spmd:
    true``: one job of PP_TP_RANKS processes; the executor reads the job,
    and a stage's ranks from its context's hostnames). Step 1, whose
    first moments of this stage's PP_PARITY_PARAMS (this rank's block)
    go to the parent, then PP_TP_WARMUP + PP_TP_STEPS timed steps through
    ``Executor.run`` in bf16, the launch counts set to 0 before step 1
    and read after the last, the collectives timed after a device sync;
    then one step profiled on rank 0, and the largest difference of a
    replicated weight between the stage's two ranks. ``pp_tp_parity``:
    the model at DP_PARITY_LAYERS layers in f32 on DP_PARITY_BATCH rows
    under each schedule, its weights and first moments gathered whole in
    each stage, saved by the stage's first rank. ``spec`` may set
    ``device`` and ``widths`` (a rehearsal on the CPU at small widths).
    Writes ``worker_<rank>.json``, ``moments_<rank>.pt`` and
    ``parity_<schedule>_<rank>.pt``."""
    import torch
    import torch.distributed as dist
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    rank = int(os.environ["RANK"])
    device = spec.get("device", "cuda")
    widths = spec.get("widths", GPT2_SMALL)
    cuda = device == "cuda"
    opts = {} if cuda else {"device": device}

    t0 = time.perf_counter()
    exe, ids, labels, bound = _pp_tp_session(
        ht, widths, "gpipe", torch.bfloat16 if cuda else None,
        **opts)
    sub = exe.subexecutors["default"]
    st = next(s for s in sub.stages if rank in s.ranks)
    nodes = {n.name: n for n in exe._param_nodes.values()}
    rec = {"rank": rank, "executor_setup_s": time.perf_counter() - t0,
           "backend": dist.get_backend(), "stage": st.index,
           "ranks": [s.ranks for s in sub.stages],
           "mesh": dict(st.mesh.shape), "coord": st.mesh.coord("tp0"),
           "device": str(st.device), "bound": bound,
           "shards": {name: [list(n.shape), list(exe.params[str(
               n.id)].shape), exe._layout(n)] for name, n in nodes.items()},
           "params_and_slots_bytes": _params_and_slots_bytes(exe),
           "param_elements": sum(t.numel() for t in exe.params.values())}
    x, y = _pp_tp_rows(spec["seed"], widths, TRAIN_BATCH)
    feeds = {ids: x, labels: y}
    comm = st.mesh.comm("tp0")
    comm.sync_timing = True
    channel = sub.job.channel()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    losses, step_ms = [], []
    for i in range(1 + PP_TP_WARMUP + PP_TP_STEPS):
        if i == 1 + PP_TP_WARMUP:
            comm.reset_stats()
            channel.reset_stats()
            st.tp.reset_stats()
            dist.barrier()
            rec["window_start"] = time.time()
        t = time.perf_counter()
        out = exe.run(feed_dict=feeds)[0]
        losses.append(None if out is None else float(out.asnumpy()))
        if cuda:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        if i == 0:
            torch.save({name: (exe.opt_state[n.id]["m"].cpu(),
                               exe._layout(n))
                        for name, n in nodes.items()
                        if name in PP_PARITY_PARAMS},
                       os.path.join(spec["out"], f"moments_{rank}.pt"))
    rec["window_end"] = time.time()
    rec["launches"] = dict(_build.launch_counts)    # main path ends
    per_step = {kind: {op: n / PP_TP_STEPS for op, n in counts.items()}
                for kind, counts in st.tp.moves.items()}
    rec.update(losses=losses, step_ms=step_ms,
               step_ms_p50=float(np.median(step_ms[1 + PP_TP_WARMUP:])),
               comm_per_step=_comm_per_step(comm.stats, PP_TP_STEPS),
               channel_per_step={k: v / PP_TP_STEPS for k, v in
                                 channel.stats().items()},
               moves_per_step=per_step,
               gather_rule_per_step={op: n / PP_TP_STEPS for op, n in
                                     st.tp.gather_rule.items()},
               peak_memory_bytes=int(torch.cuda.max_memory_allocated())
               if cuda else None)
    if cuda and rank == 0:
        rec["profile"] = profile_window(
            torch, lambda: exe.run(feed_dict=feeds))
    else:
        exe.run(feed_dict=feeds)
    rec["replicated_rel_diff_across_ranks"] = _across_ranks(
        torch, dist, [exe.params[str(n.id)] for n in nodes.values()
                      if exe._layout(n) is None], st.mesh.group("tp0"))
    del exe, sub, st
    _release(torch)

    parity_widths = dict(widths, num_hidden_layers=DP_PARITY_LAYERS)
    x, y = _pp_tp_rows(spec["seed"], widths, DP_PARITY_BATCH)
    for schedule in PP_TP_SCHEDULES:
        exe, ids, labels, _ = _pp_tp_session(ht, parity_widths, schedule,
                                             None, **opts)
        out = [exe.run(feed_dict={ids: x, labels: y})[0]
               for _ in range(DP_PARITY_STEPS)]
        rec[f"parity_losses_{schedule}"] = [
            None if v is None else float(v.asnumpy()) for v in out]
        state = {n.name: (exe._whole(n, exe.params[sid]).cpu(),
                          exe._whole(n, exe.opt_state[n.id]["m"]).cpu())
                 for sid, n in exe._param_nodes.items()}
        if exe._writes(next(iter(exe._param_nodes.values()))):
            torch.save(state, os.path.join(
                spec["out"], f"parity_{schedule}_{rank}.pt"))
        del exe
        _release(torch)
    with open(os.path.join(spec["out"], f"worker_{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    return 0


def _pp_tp_job(seed, out_dir, sample_card, **spec):
    """pp_tp_gpt's job: PP_TP_RANKS launcher processes of one spmd job,
    each ``python chip_smoke.py --pp-tp-worker SPEC``. Returns (wall s,
    the card's used-memory samples, the workers' records by rank, each
    rank's first moments, {schedule: the stages' parity state merged})."""
    import torch
    wall, used = _launch_job(
        "pp_tp", f"spmd: true\nnodes:\n  - host: localhost\n"
        f"    workers: {PP_TP_RANKS}\n    chief: true\n", "--pp-tp-worker",
        {"seed": seed, "out": out_dir, **spec}, PP_TP_TIMEOUT_S,
        sample_card)
    records, moments, parity = [], [], {s: {} for s in PP_TP_SCHEDULES}
    for r in range(PP_TP_RANKS):
        with open(os.path.join(out_dir, f"worker_{r}.json")) as f:
            records.append(json.load(f))
        moments.append(torch.load(os.path.join(out_dir,
                                               f"moments_{r}.pt")))
        for schedule in PP_TP_SCHEDULES:
            path = os.path.join(out_dir, f"parity_{schedule}_{r}.pt")
            if os.path.exists(path):
                parity[schedule].update(torch.load(path))
    return wall, used, records, moments, parity


def pp_tp_pass(card, seed, train_line, tp_line):
    """``pp_tp_gpt`` and ``pp_tp_parity``: PP_TP_RANKS processes of one
    job started by ``python hetu_tpu_torch/run_launcher.py`` (``spmd: true``)
    on the one card, where the executors pick gloo. The checks: the
    backend gloo, every rank on cuda:0 in its stage's ranks, at its
    coordinate of the stage's ("tp0",) mesh; K2, K3 and K4 24 launches a
    step (6 blocks x M=4) in each rank, all on tc, K1 none; step 1
    against the same stages in one process (pp_tp_reference): the loss
    within one bf16 ulp, Adam's first moments of layer 0's qkv (each
    stage-0 rank's columns) and of the LM head (each stage-1 rank's)
    within GRAD_PARITY_TOL of their largest element; the timed losses
    finite and falling; every replicated weight the same on both ranks
    of its stage within TP_SAME_TOL of its largest element; every split
    weight at its shard's shape, the split weights those the rules bound.
    pp_tp_parity: the losses of the loss stage's ranks, the first moments
    and the weights gathered whole against the one process as
    ``_parity_line`` holds them, under GPipe and 1F1B. Returns
    ({"pp_tp_gpt": line, "pp_tp_parity": line}, pp_tp_gpt's launch counts
    summed over the ranks)."""
    import shutil
    import tempfile
    import torch
    from hetu_tpu_torch.ops import flash_attention as fa
    t = time.perf_counter()
    ref = pp_tp_reference(torch, seed)
    ref_s = time.perf_counter() - t
    out_dir = tempfile.mkdtemp(prefix="pp_tp_job_")
    try:
        wall, used, records, moments, parity = _pp_tp_job(seed, out_dir,
                                                          True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    steps = 1 + PP_TP_WARMUP + PP_TP_STEPS
    per_stage = GPT2_SMALL["num_hidden_layers"] // PP_TP_STAGES
    want_l = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,),
                           per_stage * PP_MICROBATCHES * steps)
    faults, ranks = [], []
    bound = set(records[0]["bound"])
    split = set()
    for rec, mom in zip(records, moments):
        r = rec["rank"]
        got_l = {k: rec["launches"].get(k, 0) for k in want_l}
        if got_l != want_l:
            faults.append(f"rank {r} launched {got_l}")
        stage_ranks = [list(range(s * TP_RANKS, (s + 1) * TP_RANKS))
                       for s in range(PP_TP_STAGES)]
        if rec["backend"] != "gloo" or rec["device"] != "cuda:0" or \
                rec["ranks"] != stage_ranks or \
                rec["mesh"] != {"tp0": TP_RANKS} or \
                rec["coord"] != r % TP_RANKS or rec["bound"] != records[0][
                    "bound"]:
            faults.append(f"rank {r}: {rec['backend']} on {rec['device']}, "
                          f"stages {rec['ranks']}, mesh {rec['mesh']} at "
                          f"{rec['coord']}")
        mine = {name for name, (_, _, lay) in rec["shards"].items() if lay}
        split |= mine
        halved = all(
            got == [s // TP_RANKS if ax else s for s, ax in zip(whole, lay)]
            for whole, got, lay in rec["shards"].values() if lay)
        if not halved or not mine:
            faults.append(f"rank {r} split {sorted(mine)}, shapes halved "
                          f"{halved}")
        moment_err = {}
        for name, (m, layout) in mom.items():
            want = _block(ref["moments"][name], layout, r % TP_RANKS)
            moment_err[name] = float((m - want).abs().max()
                                     / want.abs().max())
        if len(moment_err) != 1 or \
                max(moment_err.values()) > GRAD_PARITY_TOL:
            faults.append(f"rank {r} first moments {moment_err}")
        if rec["replicated_rel_diff_across_ranks"] > TP_SAME_TOL:
            faults.append(f"rank {r} replicated weights differ by "
                          f"{rec['replicated_rel_diff_across_ranks']}")
        ranks.append({k: rec[k] for k in (
            "rank", "stage", "coord", "executor_setup_s", "step_ms",
            "step_ms_p50", "comm_per_step", "channel_per_step",
            "moves_per_step", "gather_rule_per_step", "peak_memory_bytes",
            "params_and_slots_bytes", "param_elements",
            "replicated_rel_diff_across_ranks")})
        ranks[-1]["first_moment_err_of_largest"] = moment_err
        ranks[-1]["launches_per_step"] = {
            k: rec["launches"].get(k, 0) / steps
            for k in (fa.K1, fa.K2, fa.K3, fa.K4)}
    if split != bound:
        faults.append(f"split {sorted(split)} against bound {sorted(bound)}")
    last = records[-1]["losses"]
    step1 = last[0]
    ulp = _bf16_ulp(ref["loss"])
    if abs(step1 - ref["loss"]) > ulp or not all(np.isfinite(last)) or \
            not last[-1] < last[0] or any(
                rec["losses"] != (last if rec["stage"] == PP_TP_STAGES - 1
                                  else [None] * steps) for rec in records):
        faults.append(f"losses {[r['losses'] for r in records]} against "
                      f"one process's step 1 {ref['loss']}")
    window = max(r["window_end"] - r["window_start"] for r in records)
    tokens = TRAIN_BATCH * GPT2_SMALL["max_position_embeddings"]
    p50 = max(r["step_ms_p50"] for r in records)
    profile = records[0]["profile"]
    launches_r0 = per_stage * PP_MICROBATCHES
    pp_tp_gpt = {
        "card": card, "model": "gpt2-small", **GPT2_SMALL,
        "stages": PP_TP_STAGES, "tp": TP_RANKS, "ranks": PP_TP_RANKS,
        "schedule": "gpipe", "microbatches": PP_MICROBATCHES,
        "microbatch_rows": PP_MICROBATCH, "batch": TRAIN_BATCH,
        "seq": GPT2_SMALL["max_position_embeddings"], "dtype": "bfloat16",
        "optimizer": "Adam", "lr": TRAIN_LR, "dropout": 0.0,
        "rules": "DEFAULT_RULES", "split_params": len(bound),
        "backend": records[0]["backend"],
        "warmup_steps": 1 + PP_TP_WARMUP, "timed_steps": PP_TP_STEPS,
        "tokens_per_s": tokens * PP_TP_STEPS / window,
        "slowest_window_s": window, "step_ms_p50": p50,
        "train_step_ms_p50": train_line["step_ms_p50"],
        "step_cost_vs_train": p50 / train_line["step_ms_p50"],
        "tp_gpt_step_ms_p50": tp_line["step_ms_p50"],
        "losses": last, "step1_loss": step1,
        "one_process_step1_loss": ref["loss"], "loss_tol": ulp,
        "first_moment_tol": GRAD_PARITY_TOL,
        "same_weights_tol": TP_SAME_TOL,
        "one_process_params_and_slots_bytes": ref["params_and_slots_bytes"],
        "one_process_param_elements": ref["param_elements"],
        "tp_gpt_params_and_slots_bytes": [
            r["params_and_slots_bytes"] for r in tp_line["per_rank"]],
        "rank0_profiled_step": {
            "wall_ms": profile["wall_ms"],
            "device_idle_share": profile["device_idle_share"],
            "flash_fwd_lse_device_ms_a_launch":
                profile["flash_fwd_kernel_ms"] / launches_r0,
            "flash_bwd_dkv_device_ms_a_launch":
                profile["flash_bwd_dkv_kernel_ms"] / launches_r0,
            "flash_bwd_dq_device_ms_a_launch":
                profile["flash_bwd_dq_kernel_ms"] / launches_r0,
            "by_category": profile["by_category"]},
        "reference_s": ref_s, "launcher_wall_s": wall,
        "card_memory_used_mib_max": max(used) if used else None,
        "card_memory_samples": len(used), "per_rank": ranks}
    pp_tp_parity = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
                    "num_hidden_layers": DP_PARITY_LAYERS,
                    "dtype": "float32", "stages": PP_TP_STAGES,
                    "tp": TP_RANKS, "batch": DP_PARITY_BATCH,
                    "microbatches": PP_MICROBATCHES,
                    "steps": DP_PARITY_STEPS, "reference": "the same "
                    "stages in one process on the card"}
    for schedule in PP_TP_SCHEDULES:
        got = records[-1][f"parity_losses_{schedule}"]
        line, ok = _parity_line(got, parity[schedule],
                                ref["parity"][schedule])
        pp_tp_parity[schedule] = line
        if not ok:
            faults.append(f"pp_tp_parity {schedule} {line}")
    if faults:
        log(f"pp_tp failed: {pp_tp_gpt}")
        raise AssertionError(f"pp_tp: {faults}")
    counts = {}
    for rec in records:
        for k, v in rec["launches"].items():
            counts[k] = counts.get(k, 0) + v
    return {"pp_tp_gpt": pp_tp_gpt, "pp_tp_parity": pp_tp_parity}, counts


# ---------------------------------------------------------------------------
# sp_gpt, sp_bert_long, sp_parity: sequence parallelism, two ranks of one
# launcher job on the one card
# ---------------------------------------------------------------------------

# train's model and rows under GPTConfig(sequence_parallel="ring") (the
# zigzag causal ring) and "ulysses", and bert_long's model and rows under
# BertConfig(sequence_parallel=True) (a masked, non-causal ring), each
# trained by SP_RANKS ranks of one job over an {"sp": 2} mesh, every rank
# fed the whole batch and attending its half of each sequence. Step 1
# runs at dropout 0 (held against one process at the same weights and
# rows: the loss within DP_LOSS_TOL, Adam's first moments of SP_MOMENTS
# within GRAD_PARITY_TOL of their largest element; and against the same
# job with the plain K2-K4 swapped into the blocks: the loss within one
# bf16 ulp), the warm-up and timed steps at SP_DROPOUT (tp_gpt's; train's
# own is 0), after which every weight is the same on both ranks within
# TP_SAME_TOL of its largest element
SP_RANKS = 2
SP_WARMUP, SP_STEPS = 1, 3
SP_DROPOUT = TP_DROPOUT
SP_TIMEOUT_S = 500
SP_MOMENTS = {"gpt": TP_MOMENTS,
              "bert": tuple(f"layer0_attn_{w}_weights"
                            for w in ("query", "key", "value"))
              + ("mlm_transform_weights",)}
# the passes: (model, sequence_parallel, K2 launches a layer a step a
# rank: the ring's diagonal and a hop's two square blocks at sp=2, one
# Ulysses attention, the non-causal ring's two blocks)
SP_PASSES = {"ring": ("gpt", "ring", 3), "ulysses": ("gpt", "ulysses", 1),
             "bert_long": ("bert", True, 2)}
# the blocks' shapes on these paths (kernel_shapes holds each)
SP_RING_DIAG_REP = dict(TRAIN_REP, s=TRAIN_REP["s"] // SP_RANKS)
SP_RING_SQUARE_REP = dict(TRAIN_REP, s=TRAIN_REP["s"] // (2 * SP_RANKS),
                          causal=False)
SP_ULYSSES_REP = dict(TRAIN_REP, h=TRAIN_REP["h"] // SP_RANKS)
SP_BERT_REP = dict(BERT_LONG_REP, s=BERT_LONG_REP["s"] // SP_RANKS)
# sp_parity: dp_parity's GPT (2 layers, f32, batch 4) under the ring and
# Ulysses, and BERT-small at 1 layer (f32, SP_BERT_PARITY_BATCH rows of
# bert_long's), 3 Adam steps at dropout 0 against one process, at
# dp_parity's tolerances
SP_BERT_PARITY_LAYERS, SP_BERT_PARITY_BATCH = 1, 2


def _bert_graph(ht, models, widths, dropout=0.1, sp=False):
    """bert_long's graph (bench.py:2390-2406) at ``widths``, hidden and
    attention-probs dropout ``dropout``, ``sequence_parallel=sp``:
    (feed nodes, the loss, the Adam train op)."""
    cfg = models.BertConfig(**widths, use_flash_attention=True,
                            hidden_dropout_prob=dropout,
                            attention_probs_dropout_prob=dropout,
                            sequence_parallel=sp)
    feed_nodes = [ht.Variable(n, trainable=False) for n in BERT_FEEDS]
    _, _, mlm_loss, nsp_loss = models.BertForPreTraining(cfg)(*feed_nodes)
    loss = ht.reduce_mean_op(mlm_loss, [0, 1]) + \
        ht.reduce_mean_op(nsp_loss, [0])
    return feed_nodes, loss, ht.optim.AdamOptimizer(
        learning_rate=TRAIN_LR).minimize(loss)


def _sp_model(ht, models, model, widths, dropout, sp, seed, batch, device):
    """One sp pass's graph and feeds: (nodes, feeds). ``model`` "gpt"
    (train's rows) or "bert" (bert_long's padded rows)."""
    import torch
    if model == "gpt":
        ids, labels, lm, train_op = _gpt_graph(ht, models, widths, dropout,
                                               sp)
        x, y = _gpt_rows(seed, batch)
        seq, vocab = widths["max_position_embeddings"], widths["vocab_size"]
        x, y = x[:, :seq] % vocab, np.concatenate(
            [x[:, 1:seq] % vocab, np.full((batch, 1), -1)], axis=1)
        values = {ids: x, labels: y}
        nodes = [lm, train_op]
    else:
        feed_nodes, loss, train_op = _bert_graph(ht, models, widths,
                                                 dropout, sp)
        seq = widths["max_position_embeddings"]
        values = bert_feed_values(feed_nodes, batch, seq,
                                  widths["vocab_size"],
                                  (seq // 2, seq), seed)
        nodes = [loss, train_op]
    return nodes, {n: torch.as_tensor(v, device=device)
                   for n, v in values.items()}


def _sp_widths(spec, model):
    if model == "gpt":
        return spec.get("widths", GPT2_SMALL), spec.get("batch", TRAIN_BATCH)
    return spec.get("bert_widths", BERT_SMALL_2048), \
        spec.get("bert_batch", BERT_PASSES["bert_long"]["batch"])


@contextlib.contextmanager
def _plain_blocks():
    """The plain K2-K4 swapped into the ring's and Ulysses' blocks."""
    from hetu_tpu_torch.ops import flash_attention as fa
    from hetu_tpu_torch.parallel import ring, ulysses
    saved = []
    for mod in (ring, ulysses):
        for name, fn in (("flash_attention_with_lse",
                          fa.flash_attention_with_lse_plain),
                         ("flash_attention_bwd", fa.flash_attention_bwd_plain)):
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def sp_references(torch, seed):
    """One process's runs that the sp passes are held to, on the card:
    bert_long's graph without sequence parallelism at dropout 0, step 1
    (its loss and Adam's first moments of SP_MOMENTS["bert"] on the
    host); and sp_parity's BERT at SP_BERT_PARITY_LAYERS in f32, 3 Adam
    steps (losses, _parity_state, the names of the parameters that start
    at 0). train's GPT reference is tp_reference's."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    widths, batch = _sp_widths({}, "bert")
    nodes, feeds = _sp_model(ht, M, "bert", widths, 0.0, False, seed, batch,
                             "cuda")
    exe = ht.Executor(nodes, dtype=torch.bfloat16)
    loss = float(exe.run(feed_dict=feeds)[0].asnumpy())
    names = {n.name: n for n in exe._param_nodes.values()}
    bert = {"loss": loss,
            "moments": {name: exe.opt_state[names[name].id]["m"].cpu()
                        for name in SP_MOMENTS["bert"]}}
    del exe, feeds
    _release(torch)
    widths = dict(widths, num_hidden_layers=SP_BERT_PARITY_LAYERS)
    nodes, feeds = _sp_model(ht, M, "bert", widths, 0.0, False, seed,
                             SP_BERT_PARITY_BATCH, "cuda")
    exe = ht.Executor(nodes)
    zero_init = {name for name, w in _master_state(exe).items()
                 if not w.any()}
    losses = [float(exe.run(feed_dict=feeds)[0].asnumpy())
              for _ in range(DP_PARITY_STEPS)]
    parity = (losses, _parity_state(exe), zero_init)
    del exe, feeds
    _release(torch)
    return bert, parity


def sp_worker(spec):
    """One rank of the sp passes, run by the launcher as ``python
    chip_smoke.py --sp-worker SPEC`` (``spmd: true``: one job of SP_RANKS
    processes). The rank joins the job and takes an {"sp": SP_RANKS}
    mesh; then for each of SP_PASSES: step 1 at dropout 0 (its loss, and
    Adam's first moments of SP_MOMENTS saved), step 1 again in a new
    session with the plain K2-K4 in the blocks, and warm-up and timed
    steps at SP_DROPOUT through ``Executor.run`` in bf16, the launch
    counts and the composed-block counts set to 0 before them and read
    after, the collectives timed after a device sync; then the largest
    difference of any weight between the ranks. ``sp_parity``: the
    passes' models at 2 layers (GPT) and 1 (BERT) in f32, 3 Adam steps,
    rank 0 saving their state. ``spec`` may set ``device``, ``widths``,
    ``bert_widths``, ``batch`` and ``bert_batch`` (a rehearsal on the
    CPU at small widths). Writes ``worker_<rank>.json``,
    ``moments_<rank>.pt`` and ``parity_state.pt``."""
    import torch
    import torch.distributed as dist
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.executor import maybe_init_distributed
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.parallel import ring
    rank = int(os.environ["RANK"])
    device = spec.get("device", "cuda")
    cuda = device == "cuda"
    dtype = torch.bfloat16 if cuda else None
    maybe_init_distributed(device)
    mesh = ht.parallel.build_mesh({"sp": SP_RANKS})
    comm = mesh.comm("sp")
    comm.sync_timing = cuda

    def session(nodes, **options):
        # on the card the entry point's own default: cuda:{LOCAL_RANK}
        if not cuda:
            options["device"] = device
        exe = ht.Executor(nodes, mesh=mesh, **options)
        return exe, {n.name: n for n in exe._param_nodes.values()}

    def step1(model, widths, sp, batch, names):
        nodes, feeds = _sp_model(ht, M, model, widths, 0.0, sp,
                                 spec["seed"], batch, device)
        exe, params = session(nodes, dtype=dtype)
        loss = float(exe.run(feed_dict=feeds)[0].asnumpy())
        moments = {n: exe.opt_state[params[n].id]["m"].cpu() for n in names}
        del exe, feeds
        _release(torch)
        return loss, moments

    rec = {"rank": rank, "backend": dist.get_backend(),
           "mesh": dict(mesh.shape), "coord": mesh.coord("sp"), "passes": {}}
    saved = {}
    passes = {n: SP_PASSES[n] for n in spec.get("passes", SP_PASSES)}
    for name, (model, sp, _) in passes.items():
        widths, batch = _sp_widths(spec, model)
        t0 = time.perf_counter()
        ring.reset_composed_blocks()
        loss1, moments = step1(model, widths, sp, batch, SP_MOMENTS[model])
        with _plain_blocks():
            plain1, plain_moments = step1(model, widths, sp, batch,
                                          SP_MOMENTS[model])
        saved[name] = {"kernels": moments, "plain": plain_moments}
        nodes, feeds = _sp_model(ht, M, model, widths, SP_DROPOUT, sp,
                                 spec["seed"], batch, device)
        exe, params = session(nodes, dtype=dtype)
        p = {"step1_loss": loss1, "plain_step1_loss": plain1,
             "device": str(exe.config.device),
             "sp_mesh": dict(exe.config.mesh.shape),
             "nrank": exe.config.nrank}
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()                # main path starts
        losses, step_ms = [], []
        for i in range(SP_WARMUP + SP_STEPS):
            if i == SP_WARMUP:
                comm.reset_stats()
                dist.barrier()
                p["window_start"] = time.time()
            t = time.perf_counter()
            losses.append(float(exe.run(feed_dict=feeds)[0].asnumpy()))
            if cuda:
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        p["window_end"] = time.time()
        p["launches"] = dict(_build.launch_counts)  # main path ends
        p["launches_by_shape"] = [[k, route, list(shape), n] for
                                  (k, route, shape), n in
                                  _build.launch_shapes.items()]
        p["composed_blocks"] = dict(ring.composed_blocks)
        p.update(losses=losses, step_ms=step_ms,
                 step_ms_p50=float(np.median(step_ms[SP_WARMUP:])),
                 comm_per_step=_comm_per_step(comm.stats, SP_STEPS),
                 peak_memory_bytes=int(torch.cuda.max_memory_allocated())
                 if cuda else None,
                 weights_rel_diff_by_tensor={
                     n: _across_ranks(torch, dist, [exe.params[str(node.id)]],
                                      mesh.group("sp"))
                     for n, node in params.items()},
                 pass_s=time.perf_counter() - t0)
        rec["passes"][name] = p
        del exe, feeds
        _release(torch)
    torch.save(saved, os.path.join(spec["out"], f"moments_{rank}.pt"))

    states, rec["parity_losses"] = {}, {}
    for name, (model, sp, _) in passes.items():
        widths, _ = _sp_widths(spec, model)
        if model == "gpt":
            widths = dict(widths, num_hidden_layers=DP_PARITY_LAYERS)
            batch = DP_PARITY_BATCH
        else:
            widths = dict(widths, num_hidden_layers=SP_BERT_PARITY_LAYERS)
            batch = SP_BERT_PARITY_BATCH
        nodes, feeds = _sp_model(ht, M, model, widths, 0.0, sp, spec["seed"],
                                 batch, device)
        exe, _ = session(nodes)
        rec["parity_losses"][name] = [
            float(exe.run(feed_dict=feeds)[0].asnumpy())
            for _ in range(DP_PARITY_STEPS)]
        states[name] = _parity_state(exe)
        del exe, feeds
        _release(torch)
    if rank == 0:
        torch.save(states, os.path.join(spec["out"], "parity_state.pt"))
    with open(os.path.join(spec["out"], f"worker_{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    return 0


def _sp_job(seed, out_dir, sample_card, **spec):
    """The sp passes' job: SP_RANKS launcher processes of one spmd job,
    each ``python chip_smoke.py --sp-worker SPEC``. Returns (wall s, the
    card's used-memory samples, the workers' records by rank, their
    saved first moments by rank, rank 0's parity states)."""
    import torch
    wall, used = _launch_job(
        "sp", f"spmd: true\nnodes:\n  - host: localhost\n"
        f"    workers: {SP_RANKS}\n    chief: true\n", "--sp-worker",
        {"seed": seed, "out": out_dir, **spec}, SP_TIMEOUT_S, sample_card)
    records, moments = [], []
    for r in range(SP_RANKS):
        with open(os.path.join(out_dir, f"worker_{r}.json")) as f:
            records.append(json.load(f))
        moments.append(torch.load(os.path.join(out_dir,
                                               f"moments_{r}.pt")))
    return wall, used, records, moments, torch.load(
        os.path.join(out_dir, "parity_state.pt"))


def _moment_err(got, want):
    return {name: float((got[name] - w).abs().max() / w.abs().max())
            for name, w in want.items()}


def _launches_at(by_shape, rep):
    """The launch counts of a worker's ``launches_by_shape`` ([key,
    route, shape, n]) at ``rep``'s [b, h, s, d], under ``key`` and
    ``key.route`` as in ``_build.launch_counts``."""
    want = [rep[k] for k in ("b", "h", "s", "d")]
    out = {}
    for key, route, shape, n in by_shape:
        if list(shape) == want:
            for k in (key, f"{key}.{route}"):
                out[k] = out.get(k, 0) + n
    return out


def sp_pass(card, seed, train_line, bert_long_line, gpt_ref, parity_ref):
    """``sp_gpt`` (ring and Ulysses), ``sp_bert_long`` and ``sp_parity``:
    one job of SP_RANKS processes started by ``python
    hetu_tpu_torch/run_launcher.py`` (``spmd: true``) on the one card,
    where the executors pick gloo. ``gpt_ref``: tp_reference's one process (train's
    model, weights and rows at dropout 0); ``parity_ref``: dp_parity's.
    The checks, per pass and rank: the backend gloo, cuda:0, an {"sp": 2}
    mesh at the rank's coordinate; K2, K3 and K4 at SP_PASSES' blocks a
    layer a step, all on tc, K1 none; no composed block; step 1 against
    one process (the loss within DP_LOSS_TOL, the first moments within
    GRAD_PARITY_TOL of their largest element) and against the plain
    K2-K4 (the loss within one bf16 ulp, the first moments within
    GRAD_PARITY_TOL); the timed losses finite, falling and the same on
    both ranks; every weight the same on both ranks within TP_SAME_TOL.
    sp_parity: rank 0's losses, first moments and weights against one
    process at dp_parity's tolerances. The ring's launches also by
    shape: the diagonal a layer at SP_RING_DIAG_REP, the hops' squares
    at SP_RING_SQUARE_REP. Returns ({"sp_gpt": {variant: line},
    "sp_bert_long": line, "sp_parity": {pass: line}}, launch counts by
    pass summed over the ranks, the ring's also as "ring.diagonal" and
    "ring.squares")."""
    import shutil
    import tempfile
    import torch
    from hetu_tpu_torch.ops import flash_attention as fa
    t = time.perf_counter()
    bert_ref, bert_parity_ref = sp_references(torch, seed)
    ref_s = time.perf_counter() - t
    out_dir = tempfile.mkdtemp(prefix="sp_job_")
    try:
        wall, used, records, moments, states = _sp_job(seed, out_dir, True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    refs = {"gpt": gpt_ref, "bert": bert_ref}
    steps = SP_WARMUP + SP_STEPS
    faults, lines, counts = [], {}, {}
    for name, (model, sp, blocks) in SP_PASSES.items():
        widths, batch = _sp_widths({}, model)
        layers = widths["num_hidden_layers"]
        want_l = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,),
                               blocks * layers * steps)
        ref = refs[model]
        ranks, counts[name] = [], {}
        for rec, mom in zip(records, moments):
            r, p = rec["rank"], rec["passes"][name]
            got_l = {k: p["launches"].get(k, 0) for k in want_l}
            if got_l != want_l:
                faults.append(f"{name} rank {r} launched {got_l}")
            if p["composed_blocks"]:
                faults.append(f"{name} rank {r} composed blocks "
                              f"{p['composed_blocks']}")
            if rec["backend"] != "gloo" or p["device"] != "cuda:0" or \
                    p["sp_mesh"] != {"sp": SP_RANKS} or rec["coord"] != r:
                faults.append(f"{name} rank {r}: {rec['backend']} on "
                              f"{p['device']}, mesh {p['sp_mesh']} at "
                              f"{rec['coord']}")
            ulp = _bf16_ulp(p["plain_step1_loss"])
            loss_err = abs(p["step1_loss"] - ref["loss"]) / abs(ref["loss"])
            m_ref = _moment_err(mom[name]["kernels"], ref["moments"])
            m_plain = _moment_err(mom[name]["kernels"],
                                  mom[name]["plain"])
            if loss_err > DP_LOSS_TOL or \
                    abs(p["step1_loss"] - p["plain_step1_loss"]) > ulp or \
                    max(m_ref.values()) > GRAD_PARITY_TOL or \
                    max(m_plain.values()) > GRAD_PARITY_TOL:
                faults.append(f"{name} rank {r} step 1: loss "
                              f"{p['step1_loss']}, plain "
                              f"{p['plain_step1_loss']}, one process "
                              f"{ref['loss']}; moments against one "
                              f"process {m_ref}, against plain {m_plain}")
            by_tensor = p["weights_rel_diff_by_tensor"]
            worst_w = sorted(by_tensor, key=by_tensor.get)[-3:][::-1]
            if by_tensor[worst_w[0]] > TP_SAME_TOL:
                faults.append(f"{name} rank {r} weights differ across the "
                              f"ranks: {[(n, by_tensor[n]) for n in worst_w]}")
            row = {k: p[k] for k in (
                "step_ms", "step_ms_p50", "comm_per_step", "peak_memory_bytes",
                "composed_blocks", "step1_loss", "plain_step1_loss",
                "pass_s")}
            ranks.append({"rank": r, "device": p["device"], **row,
                          "weights_rel_diff_across_ranks":
                              by_tensor[worst_w[0]],
                          "largest_rel_diffs_across_ranks": {
                              n: by_tensor[n] for n in worst_w},
                          "step1_loss_rel_err": loss_err,
                          "first_moment_err_vs_one_process": m_ref,
                          "first_moment_err_vs_plain": m_plain,
                          "launches_per_step": {
                              f"{x}.{route}": p["launches"].get(
                                  f"{x}.{route}", 0) / steps
                              for x in (fa.K1, fa.K2, fa.K3, fa.K4)
                              for route in ("tc", "simt")}})
            for k, v in p["launches"].items():
                counts[name][k] = counts[name].get(k, 0) + v
            if name == "ring":
                # the diagonal block and the hops' squares by their S
                for path, rep, per_layer in (
                        ("ring.diagonal", SP_RING_DIAG_REP, 1),
                        ("ring.squares", SP_RING_SQUARE_REP, blocks - 1)):
                    at = _launches_at(p["launches_by_shape"], rep)
                    want_s = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,),
                                           per_layer * layers * steps)
                    got_s = {k: at.get(k, 0) for k in want_s}
                    if got_s != want_s:
                        faults.append(f"{name} rank {r} launched {got_s} "
                                      f"at S={rep['s']}")
                    into = counts.setdefault(path, {})
                    for k, v in at.items():
                        into[k] = into.get(k, 0) + v
        passes = [rec["passes"][name] for rec in records]
        losses = passes[0]["losses"]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
                any(q["losses"] != losses for q in passes):
            faults.append(f"{name} losses {[q['losses'] for q in passes]}")
        window = max(q["window_end"] - q["window_start"] for q in passes)
        seq = widths["max_position_embeddings"]
        p50 = max(q["step_ms_p50"] for q in passes)
        base = train_line if model == "gpt" else bert_long_line
        lines[name] = {
            "card": card, "model": "gpt2-small" if model == "gpt"
            else "bert-small-2048", **widths, "sequence_parallel": sp,
            "sp": SP_RANKS, "batch": batch, "seq": seq,
            "rows_per_rank_shard": seq // SP_RANKS, "dtype": "bfloat16",
            "optimizer": "Adam", "lr": TRAIN_LR, "dropout": SP_DROPOUT,
            "backend": records[0]["backend"], "warmup_steps": SP_WARMUP,
            "timed_steps": SP_STEPS,
            "tokens_per_s": batch * seq * SP_STEPS / window,
            "slowest_window_s": window, "step_ms_p50": p50,
            "one_process_step_ms_p50": base["step_ms_p50"],
            "one_process_line": "train" if model == "gpt" else "bert_long",
            "step_cost_vs_one_process": p50 / base["step_ms_p50"],
            "k2_k3_k4_launches_per_step_per_rank": blocks * layers,
            "losses": losses, "one_process_step1_loss": ref["loss"],
            "loss_tol": DP_LOSS_TOL, "first_moment_tol": GRAD_PARITY_TOL,
            "same_weights_tol": TP_SAME_TOL, "per_rank": ranks}
    parity = {}
    for name, (model, sp, _) in SP_PASSES.items():
        ref = parity_ref if model == "gpt" else bert_parity_ref
        zero_grad = {n: n.replace("_key_", "_query_")
                     for n in states[name] if n.endswith("_attn_key_bias")}
        line, ok = _parity_line(records[0]["parity_losses"][name],
                                states[name], ref, zero_grad)
        parity[name] = {"model": "gpt2-small" if model == "gpt"
                        else "bert-small-2048", "sequence_parallel": sp,
                        "num_hidden_layers": DP_PARITY_LAYERS
                        if model == "gpt" else SP_BERT_PARITY_LAYERS,
                        "batch": DP_PARITY_BATCH if model == "gpt"
                        else SP_BERT_PARITY_BATCH, **line}
        if not ok:
            faults.append(f"sp_parity {name} {line}")
    out = {"sp_gpt": {"ring": lines["ring"], "ulysses": lines["ulysses"],
                      "launcher_wall_s": wall, "reference_s": ref_s,
                      "card_memory_used_mib_max": max(used) if used
                      else None, "card_memory_samples": len(used)},
           "sp_bert_long": lines["bert_long"],
           "sp_parity": {"card": card, "dtype": "float32", "sp": SP_RANKS,
                         "steps": DP_PARITY_STEPS, **parity}}
    if faults:
        log(f"sp failed: {out}")
        raise AssertionError(f"sp: {faults}")
    return out, counts


def _hybrid_traffic(seed):
    """The global batches of ``hybrid_fleet``: the rows of HYBRID_WORKERS
    ps_wdl streams (seeds seed .. seed + workers - 1) stacked, so each
    rank's row shard is one stream's B=128; the dense features and labels
    are one array for every step, as in ps_wdl."""
    streams = [sparse_traffic("wdl_criteo", seed + r)
               for r in range(HYBRID_WORKERS)]
    dense = np.concatenate([s[0][0] for s in streams])
    y = np.concatenate([s[0][2] for s in streams])
    return [(dense, np.concatenate([s[i][1] for s in streams]), y)
            for i in range(SPARSE_CYCLE)]


def _dense_params(exe):
    """The worker-side dense parameters of a WDL session (not the
    device cache)."""
    return [exe.params[sid] for sid, node in exe._param_nodes.items()
            if not getattr(node, "device_cached", False)]


def hybrid_worker(spec):
    """One worker of ``hybrid_fleet``, run by the launcher as ``python
    chip_smoke.py --hybrid-worker SPEC``: a rank of an ``spmd`` job
    beside one server, on ``ht.rgpu("localhost", rank)`` (cuda:0 on a
    one-card host) or, for the CPU twin, the CPU. Mode "cache" (on the
    card): WDL in the Hybrid mode through the device cache
    (cache_bound 100, bf16 drains), run_batches blocks of 100 on the
    global batch — one warm-up block, a barrier, PS_TIMED_BLOCKS timed
    ones —, then drain(), the rows of the first batch moved on the
    server, and the dense weights across the ranks. Mode "bsp": the
    host path under BSP for HYBRID_BSP_STEPS run() steps, then the
    server rows of every id touched (rank 0). Writes
    ``worker_<rank>.json`` and ``rows.npz``."""
    import torch
    import torch.distributed as dist
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    rank = int(os.environ["RANK"])
    cuda = spec["device"] == "cuda"
    ctx = ht.rgpu("localhost", rank) if cuda else ht.cpu(0)
    traffic = _hybrid_traffic(spec["seed"])
    out = {"rank": rank, "device": spec["device"]}
    if "cache" in spec["modes"]:
        t0 = time.perf_counter()
        with ps_node_ids(PS_ID_BASE):
            nodes, loss, _, train_op = ps_wdl_graph(ht)
            exe = ht.Executor([loss, train_op], ctx=ctx,
                              comm_mode="Hybrid", cstable_policy="Device",
                              cache_bound=PS_BLOCK, drain_compress=True)
        cfg = exe.config
        rec = {"executor_setup_s": time.perf_counter() - t0,
               "executor_device": str(cfg.device), "nrank": cfg.nrank,
               "backend": dist.get_backend(),
               "ps_dense_cached": len(cfg.ps_dense_cached),
               "device_cache_tables": len(cfg.device_cache_tables)}
        rt, client, comm = exe.ps_runtime, cfg.ps_comm, cfg.dp_comm
        comm.sync_timing = cuda
        tid, width = _ps_table(exe)
        first_ids = np.unique(traffic[0][1])
        first_rows = client.sparse_pull(tid, first_ids, width)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()                # main path starts
        losses = _step_losses(exe.run_batches(
            _ps_block(nodes, traffic, 0, PS_BLOCK)))
        rt.reset_phase_times()
        comm.reset_stats()
        dist.barrier()                  # the timed windows start together
        block_ms = []
        rec["window_start"] = time.time()
        for b in range(PS_TIMED_BLOCKS):
            t = time.perf_counter()
            outs = exe.run_batches(_ps_block(nodes, traffic,
                                             (1 + b) * PS_BLOCK, PS_BLOCK))
            outs[-1][0].asnumpy()
            block_ms.append((time.perf_counter() - t) * 1e3)
            losses += _step_losses(outs)
        rec["window_end"] = time.time()
        steps = PS_BLOCK * PS_TIMED_BLOCKS
        rec["launches"] = _k1_k4_launches(_build.launch_counts)  # ends
        rec["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated()) \
            if cuda else None
        rec["step_ms"] = [ms / PS_BLOCK for ms in block_ms]
        rec["step_ms_p50"] = float(np.median(rec["step_ms"]))
        rec["phase_ms_per_step"], rec["cache"] = _phase_ms(rt, steps)
        rec["comm_per_step"] = _comm_per_step(comm.stats, steps)
        rec["steps"] = steps
        rec["losses_finite"] = bool(np.all(np.isfinite(losses)))
        rec["first_last_block_mean_loss"] = [
            float(np.mean(losses[:PS_BLOCK])),
            float(np.mean(losses[-PS_BLOCK:]))]
        rt.drain()
        dt = next(iter(rt.device_tables.values()))
        rec["dirty_after_drain"] = int(dt.dirty.sum())
        dist.barrier()                  # every worker's drain landed
        rec["first_rows_moved"] = float(np.abs(
            client.sparse_pull(tid, first_ids, width) - first_rows).max())
        rec["dense_rel_diff_across_ranks"] = _across_ranks(
            torch, dist, _dense_params(exe))
        dist.barrier()
        exe.close()
        del exe
        _release(torch)
        out["cache"] = rec
    with ps_node_ids(PS_ID_BSP):
        nodes, loss, _, train_op = ps_wdl_graph(ht)
        exe = ht.Executor([loss, train_op], ctx=ctx, comm_mode="Hybrid",
                          bsp=True)
    rec = {"executor_device": str(exe.config.device), "losses": []}
    t0 = time.perf_counter()
    for i in range(HYBRID_BSP_STEPS):
        rec["losses"].append(float(exe.run(feed_dict=dict(zip(
            nodes, traffic[i % SPARSE_CYCLE])))[0].asnumpy().reshape(-1)[0]))
    rec["seconds"] = time.perf_counter() - t0
    exe.ps_runtime.drain()
    dist.barrier()
    if rank == 0:
        tid, width = _ps_table(exe)
        ids = np.unique(np.concatenate([traffic[i % SPARSE_CYCLE][1].ravel()
                                        for i in range(HYBRID_BSP_STEPS)]))
        np.savez(os.path.join(spec["out"], "rows.npz"), ids=ids,
                 rows=exe.config.ps_comm.sparse_pull(tid, ids, width))
    rec["dense_rel_diff_across_ranks"] = _across_ranks(
        torch, dist, _dense_params(exe))
    dist.barrier()
    exe.close()
    out["bsp"] = rec
    with open(os.path.join(spec["out"], f"worker_{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _hybrid_job(seed, device, modes):
    """One hybrid_fleet job (one server, HYBRID_WORKERS workers): the
    workers' records by rank, the server rows of the BSP session, and
    (wall seconds, used-memory samples)."""
    import shutil
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="hybrid_job_")
    try:
        info = _launch_job(
            f"hybrid_fleet ({device})",
            f"spmd: true\nnodes:\n  - host: localhost\n    servers: 1\n"
            f"    workers: {HYBRID_WORKERS}\n    chief: true\n",
            "--hybrid-worker", {"seed": seed, "device": device,
                                "modes": modes, "out": out_dir},
            DP_TIMEOUT_S, device == "cuda")
        records = []
        for r in range(HYBRID_WORKERS):
            with open(os.path.join(out_dir, f"worker_{r}.json")) as f:
                records.append(json.load(f))
        with np.load(os.path.join(out_dir, "rows.npz")) as z:
            rows = (z["ids"], z["rows"])
        return records, rows, info
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def hybrid_fleet_pass(card, seed):
    """``hybrid_fleet``: WDL at Criteo widths (the 1,000,000 x 128 table,
    ps_wdl's zipf traffic, B=128 a worker) in the Hybrid mode across
    two worker processes of one ``spmd`` job and one server, every
    worker on the one card: the dense weights all-reduced over the job
    (gloo), the table through each worker's device cache. The checks:
    every loss finite, the workers' mean loss over the last block below
    the first's, no dirty row after drain(), the server rows moved, the
    dense weights the same on both ranks within DP_SAME_TOL, no dense
    weight on the PS, K1-K4 0 launches. Then the host path under BSP,
    HYBRID_BSP_STEPS steps, in the same job against a job of CPU
    workers: losses within PS_LOSS_TOL relative, the touched server rows
    within PS_ROW_TOL of their largest element."""
    t = time.perf_counter()
    records, rows, (wall, used) = _hybrid_job(seed, "cuda",
                                              ["cache", "bsp"])
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    cpu_records, cpu_rows, _ = _hybrid_job(seed, "cpu", ["bsp"])
    cpu_s = time.perf_counter() - t
    caches = [r["cache"] for r in records]
    total = sum(CTR_BATCH * c["steps"] for c in caches)
    window = max(c["window_end"] - c["window_start"] for c in caches)
    first, last = np.mean([c["first_last_block_mean_loss"]
                           for c in caches], axis=0)
    faults = []
    for r, c in zip(records, caches):
        if not c["losses_finite"] or c["dirty_after_drain"] or \
                not c["first_rows_moved"] > 0 or c["ps_dense_cached"] or \
                not c["device_cache_tables"] or any(c["launches"].values()) \
                or c["dense_rel_diff_across_ranks"] > DP_SAME_TOL or \
                not c["executor_device"].startswith("cuda") or \
                c["backend"] != "gloo" or c["nrank"] != HYBRID_WORKERS:
            faults.append(f"rank {r['rank']}: {c}")
    if not last < first:
        faults.append(f"fleet mean loss {first} -> {last}")
    bsp = {"mode": "BSP, host path", "steps": HYBRID_BSP_STEPS,
           "reference": "the same job, workers on the CPU",
           "loss_tol": PS_LOSS_TOL, "row_tol": PS_ROW_TOL,
           "seconds": {"cuda": card_s, "cpu": cpu_s}, "ranks": []}
    for rec, cpu_rec in zip(records, cpu_records):
        got, want = (np.asarray(x["bsp"]["losses"])
                     for x in (rec, cpu_rec))
        err = float(np.max(np.abs(got - want) / np.abs(want)))
        bsp["ranks"].append({
            "rank": rec["rank"], "loss_rel_err": err,
            "losses_first_last": [float(got[0]), float(got[-1])],
            "dense_rel_diff_across_ranks":
                rec["bsp"]["dense_rel_diff_across_ranks"],
            "steps_per_s": HYBRID_BSP_STEPS / rec["bsp"]["seconds"]})
        if err > PS_LOSS_TOL or not rec["bsp"]["executor_device"] \
                .startswith("cuda") or cpu_rec["bsp"]["executor_device"] \
                != "cpu" or rec["bsp"]["dense_rel_diff_across_ranks"] > \
                DP_SAME_TOL:
            faults.append(f"bsp rank {rec['rank']}: {bsp['ranks'][-1]}")
    if not np.array_equal(rows[0], cpu_rows[0]):
        faults.append("bsp: the twins touched different ids")
    else:
        bsp["touched_rows"] = int(len(rows[0]))
        bsp["row_err_of_largest"] = _rel(rows[1], cpu_rows[1])
        if bsp["row_err_of_largest"] > PS_ROW_TOL:
            faults.append(f"bsp rows {bsp['row_err_of_largest']}")
    line = {"card": card, "model": "wdl_criteo", "comm_mode": "Hybrid",
            "servers": 1, "workers": HYBRID_WORKERS,
            "backend": caches[0]["backend"], "batch_per_worker": CTR_BATCH,
            "table_rows": CTR_ROWS, "cstable_policy": "Device",
            "cache_bound": PS_BLOCK, "drain_compress": True, "mode": "ASP",
            "timed_blocks": PS_TIMED_BLOCKS, "block_steps": PS_BLOCK,
            "samples_per_s": total / window, "slowest_window_s": window,
            "fleet_mean_loss_first_last_block": [float(first), float(last)],
            "launcher_wall_s": wall,
            "card_memory_used_mib_max": max(used) if used else None,
            "per_worker": [{"rank": r["rank"], **{k: c[k] for k in (
                "executor_device", "executor_setup_s", "step_ms_p50",
                "step_ms", "phase_ms_per_step", "comm_per_step", "cache",
                "peak_memory_bytes", "first_last_block_mean_loss",
                "dirty_after_drain", "first_rows_moved",
                "dense_rel_diff_across_ranks", "launches")}}
                for r, c in zip(records, caches)],
            "bsp_parity": bsp}
    if faults:
        log(f"hybrid_fleet failed: {line}")
        raise AssertionError(f"hybrid_fleet: {faults}")
    return line


def bert_train_flops(batch, seq, hidden, layers, heads, intermediate,
                     vocab):
    """Analytic FLOPs of one BERT MLM training step (bench.py:54: the
    backward counts 2x the forward). Per token forward: QKVO projections
    8h^2, scores and context 4sh, FFN 4hi, the MLM head over every
    position 2hV; embeddings, LayerNorm and softmax are O(h) and left
    out, so the MFU it gives is conservative."""
    per_token = layers * (8 * hidden * hidden + 4 * seq * hidden
                          + 4 * hidden * intermediate) + 2 * hidden * vocab
    return 3.0 * per_token * batch * seq


def bert_feed_values(feed_nodes, batch, seq, vocab, lengths, seed):
    """The feeds of bench.py's BERT passes (``_feed_values``,
    __graft_entry__.py:47-57: random ids, token types, MLM labels and NSP
    labels), except that each row keeps a length drawn uniformly from
    ``lengths`` in its attention mask and its MLM labels are -1 on the
    padding, so the padding mask masks."""
    rng = np.random.RandomState(seed)
    input_ids, token_type_ids, attention_mask, mlm_labels, nsp_label = \
        feed_nodes
    values = {
        input_ids: rng.randint(0, vocab, (batch, seq)),
        token_type_ids: rng.randint(0, 2, (batch, seq)),
        attention_mask: np.ones((batch, seq), np.float32),
        mlm_labels: rng.randint(0, vocab, (batch, seq)),
        nsp_label: rng.randint(0, 2, (batch,)),
    }
    keep = np.arange(seq)[None] < rng.randint(lengths[0], lengths[1] + 1,
                                              (batch, 1))
    values[attention_mask] = keep.astype(np.float32)
    values[mlm_labels][~keep] = -1
    return values


def bert_train(torch, seed, card, name):
    """One BERT pass of BERT_PASSES: BertForPreTraining (MLM + NSP, flash
    attention under the padding mask, dropout 0.1) trained with Adam in
    bf16 through Executor.run on one fixed batch (train_pass: a parity
    step with the plain kernels swapped in — K1 below FUSED_BWD_MIN_SEQ,
    K2-K4 from it on — then warm-up and timed steps with the kernels);
    then one profiled step and one with each op's host time taken."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import attention as attn
    from hetu_tpu_torch.ops import flash_attention as fa

    spec = BERT_PASSES[name]
    widths = spec["widths"]
    cfg = M.BertConfig(**widths, use_flash_attention=True)
    batch, seq = spec["batch"], widths["max_position_embeddings"]
    feed_nodes = [ht.Variable(n, trainable=False) for n in BERT_FEEDS]
    _, _, mlm_loss, nsp_loss = M.BertForPreTraining(cfg)(*feed_nodes)
    loss = ht.reduce_mean_op(mlm_loss, [0, 1]) + \
        ht.reduce_mean_op(nsp_loss, [0])
    opt = ht.optim.AdamOptimizer(learning_rate=TRAIN_LR)
    train_op = opt.minimize(loss)
    # the layer-0 query / key / value weights' gradients: dq, dk, dv of
    # layer 0 mapped back through the projections
    qkv = [next(i for i, p in enumerate(opt.params)
                if p.name == f"layer0_attn_{w}_weights")
           for w in ("query", "key", "value")]
    nodes = [loss] + [train_op.inputs[i] for i in qkv] + [train_op]
    feeds = {node: torch.as_tensor(v, device="cuda") for node, v in
             bert_feed_values(feed_nodes, batch, seq, widths["vocab_size"],
                              spec["lengths"], seed).items()}

    steps = spec["warmup"] + spec["steps"]
    fused = seq >= attn.FUSED_BWD_MIN_SEQ
    plain = ({"flash_attention_with_lse": fa.flash_attention_with_lse_plain,
              "flash_attention_bwd": fa.flash_attention_bwd_plain}
             if fused else {"flash_attention": fa.flash_attention_plain})
    exe, run = train_pass(torch, nodes, feeds, plain, steps)
    on, off = ((fa.K2, fa.K3, fa.K4), (fa.K1,)) if fused \
        else ((fa.K1,), (fa.K2, fa.K3, fa.K4))
    got, parity = check_pass(
        name, run, _route_counts(on, off, cfg.num_hidden_layers * steps),
        dict(zip("qkv", zip(run["kernel_grads"], run["plain_grads"]))))
    if spec.get("f32_reference"):
        parity["f32_reference"] = f32_reference(torch, nodes, feeds, plain,
                                                run)
    timed = run["step_ms"][spec["warmup"]:]
    p50 = float(np.median(timed))
    flops = bert_train_flops(batch, seq, widths["hidden_size"],
                             widths["num_hidden_layers"],
                             widths["num_attention_heads"],
                             widths["intermediate_size"],
                             widths["vocab_size"])
    return {"card": card, "model": spec["model"], **widths,
            "batch": batch, "seq": seq, "padded_lengths": spec["lengths"],
            "dtype": "bfloat16", "dropout": cfg.hidden_dropout_prob,
            "optimizer": "Adam", "lr": TRAIN_LR, "seed": seed,
            "executor_setup_s": run["setup_s"],
            "warmup_steps": spec["warmup"], "timed_steps": spec["steps"],
            "tokens_per_s": batch * seq * len(timed) / (sum(timed) / 1e3),
            "step_ms_p50": p50, "step_ms": run["step_ms"],
            "flops_per_step": flops,
            "mfu": flops / (p50 / 1e3) / PEAK_FLOPS["bfloat16"],
            "losses": run["losses"], "launches": got,
            "peak_memory_bytes": int(run["peak"]),
            "parity": {"plain": sorted(plain), **parity},
            "profile": profile_train_step(torch, exe, feeds),
            "host": host_ms_by_op(torch, exe, feeds)}, run["launches"]


def host_ms_by_op(torch, exe, feeds, name="default"):
    """One more step of subgraph ``name`` with every op's ``compute``
    timed on the host clock, summed by op type: the host's time in each
    op, launches included, not the device's (an op that waits for the
    device, as the optimizer's ``torch.unique`` does, also counts the
    device work queued before it). Also the host time of making one
    per-op generator on the card, which every dropout op and its
    gradient op pay."""
    from hetu_tpu_torch.graph.node import ExecContext
    sub = exe.subexecutors[name]
    totals = {}

    def timed(node, fn):
        def run(input_vals, ectx):
            t0 = time.perf_counter()
            try:
                return fn(input_vals, ectx)
            finally:
                ms, n = totals.get(node.op_type, (0.0, 0))
                totals[node.op_type] = (
                    ms + (time.perf_counter() - t0) * 1e3, n + 1)
        return run

    for node in sub.topo_order:
        node.compute = timed(node, node.compute)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(name, feed_dict=feeds)[0].asnumpy()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for node in sub.topo_order:
            del node.compute
    ectx = ExecContext(device=torch.device("cuda"))
    op = sub.topo_order[-1]
    t0 = time.perf_counter()
    for _ in range(100):
        ectx.generator_for(op)
    gen_us = (time.perf_counter() - t0) * 1e4
    by_type = sorted(totals.items(), key=lambda x: -x[1][0])
    return {"wall_ms": wall_ms,
            "ops_ms": sum(ms for ms, _ in totals.values()),
            "generator_us": gen_us,
            "by_op_type": {t: {"ms": ms, "count": n}
                           for t, (ms, n) in by_type}}


# ---------------------------------------------------------------------------
# the CNN zoo: VGG-16 and ResNet-18 through dataloaders, digits to accuracy
# ---------------------------------------------------------------------------

def cnn_forward_flops(loss):
    """FLOPs of one forward pass: 2 x the multiply-adds of every
    convolution and matmul, from the shapes the executor inferred (the
    elementwise, norm and pool work is O(activations) and left out)."""
    from hetu_tpu_torch.graph.autodiff import find_topo_sort
    from hetu_tpu_torch.ops.conv import Conv2dOp
    from hetu_tpu_torch.ops.linalg import MatMulOp
    flops = 0
    for node in find_topo_sort([loss]):
        if isinstance(node, Conv2dOp):
            _, c, kh, kw = node.inputs[1].inferred_shape
            flops += 2 * int(np.prod(node.inferred_shape)) * c * kh * kw
        elif isinstance(node, MatMulOp):
            a = node.inputs[0].inferred_shape
            k = a[0] if node.matmul_attr_trans_A else a[1]
            flops += 2 * int(np.prod(node.inferred_shape)) * k
    return flops


def _cnn_graph(ht, model, lr, x, y_, grads):
    """``model`` over (x, y_) with MomentumOptimizer(lr): (loss, the
    gradient nodes of the parameters named ``grads``, the train op)."""
    loss, _ = getattr(ht.models, model)(x, y_)
    opt = ht.optim.MomentumOptimizer(lr)
    train_op = opt.minimize(loss)
    picked = [next(g for p, g in zip(opt.params, train_op.inputs)
                   if p.name == name) for name in grads]
    return loss, picked, train_op


def cnn_parity(torch, spec, x, y):
    """One step of the pass's graph from the same weights and batch on
    the card in f32, on the CPU in float64 and on the CPU in f32: the
    card's loss and the two gradients of ``spec["grads"]`` held to
    CNN_LOSS_TOL and CNN_GRAD_TOL against float64's; the CPU's f32 run
    against float64 and the card against it reported beside."""
    import hetu_tpu_torch as ht
    out = {}
    for run, device, dtype in (("cuda", "cuda", None),
                               ("cpu_f64", "cpu", torch.float64),
                               ("cpu", "cpu", None)):
        px = ht.Variable("x", trainable=False)
        py = ht.Variable("y_", trainable=False)
        loss, grads, train_op = _cnn_graph(ht, spec["model"], spec["lr"],
                                           px, py, spec["grads"])
        exe = ht.Executor([loss, *grads, train_op], device=device,
                          dtype=dtype)
        vals = exe.run(feed_dict={px: x, py: y})[:-1]
        out[run] = [np.asarray(v.asnumpy(), np.float64) for v in vals]

    def errs(got, want):
        (gl, *gg), (wl, *wg) = out[got], out[want]
        return {"loss_rel_err": float(abs(gl - wl) / abs(wl)),
                "grad_rel_err": {name: float(np.abs(g - w).max()
                                             / np.abs(w).max())
                                 for name, g, w in zip(spec["grads"], gg,
                                                       wg)}}
    parity = {"batch": int(x.shape[0]), "reference": "cpu float64",
              "loss_cuda": float(out["cuda"][0]),
              "loss_cpu_f64": float(out["cpu_f64"][0]),
              **errs("cuda", "cpu_f64"), "loss_tol": CNN_LOSS_TOL,
              "grad_tol": CNN_GRAD_TOL,
              "cpu_f32_vs_f64": errs("cpu", "cpu_f64"),
              "cuda_vs_cpu_f32": errs("cuda", "cpu")}
    if parity["loss_rel_err"] > CNN_LOSS_TOL or \
            max(parity["grad_rel_err"].values()) > CNN_GRAD_TOL:
        raise AssertionError(f"{spec['model']} step-1 parity, card against "
                             f"the CPU in float64, failed: {parity}")
    return parity


def _k1_k4_launches(launches):
    from hetu_tpu_torch.ops import flash_attention as fa
    return {k: launches.get(k, 0) for k in (fa.K1, fa.K2, fa.K3, fa.K4)}


def _cnn_category(op_type):
    return next((c for c, prefixes in CNN_OP_CATEGORIES
                 if op_type.startswith(prefixes)), "elementwise / other")


def cnn_train(torch, name, card, cifar):
    """One pass of CNN_PASSES: the main path — a train subgraph fed by
    dataloader ops over ``cifar`` (the arrays of ht.data.cifar10()),
    CNN_WARMUP + CNN_STEPS steps at B=128 with the launch counts set to
    0 just before and read just after (no flash kernel may launch) —
    then one profiled step (idle share, device time by kernel category),
    one profiled with a range per op (device time by op type and op
    category), one with each op's host time taken, and the step-1
    parity of the card against the CPU (B=8, cnn_parity)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    spec = CNN_PASSES[name]
    tx, ty = cifar[0], cifar[1]
    x = ht.dataloader_op([ht.Dataloader(tx, CNN_BATCH, "train")])
    y_ = ht.dataloader_op([ht.Dataloader(ty, CNN_BATCH, "train")])
    loss, _, train_op = _cnn_graph(ht, spec["model"], spec["lr"], x, y_, ())
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    exe = ht.Executor({"train": [loss, train_op]})
    setup_s = time.perf_counter() - t0
    losses, step_ms = [], []
    for _ in range(CNN_WARMUP + CNN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(exe.run("train")[0].asnumpy()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} loss not finite and falling: {losses}")
    if any(launches.values()):
        raise AssertionError(f"{name} launched flash kernels: {launches}")

    timed = step_ms[CNN_WARMUP:]
    p50 = float(np.median(timed))
    flops = 3 * cnn_forward_flops(loss)             # backward = 2 forwards

    def step():
        return exe.run("train")[0].asnumpy()
    profile = profile_window(torch, step)
    by_op_type = profile_window(
        torch, step, exe.subexecutors["train"].topo_order)[
            "device_ms_by_op_type"]
    by_cat = {}
    for op_type, v in by_op_type.items():
        cat = _cnn_category(op_type)
        by_cat[cat] = by_cat.get(cat, 0.0) + v["ms"]
    profile["device_ms_by_op_type"] = by_op_type
    profile["device_ms_by_op_category"] = dict(
        sorted(by_cat.items(), key=lambda x: -x[1]))
    host = host_ms_by_op(torch, exe, None, "train")
    n_params = sum(int(v.numel()) for v in exe.params.values())
    n_state = len(exe.state)
    del exe
    torch.cuda.empty_cache()
    # after the timed steps: the CPU's threads, busy with its
    # convolutions, would compete with the host walk of steps after them
    parity = cnn_parity(torch, spec, tx[:CNN_PARITY_BATCH],
                        ty[:CNN_PARITY_BATCH])
    return {"card": card, "model": spec["model"], "params": n_params,
            "stateful_ops": n_state, "batch": CNN_BATCH,
            "image": list(tx.shape[1:]), "dtype": "float32",
            "optimizer": "Momentum", "lr": spec["lr"],
            "data": "ht.data.cifar10() through dataloader ops",
            "executor_setup_s": setup_s, "warmup_steps": CNN_WARMUP,
            "timed_steps": CNN_STEPS,
            "images_per_s": CNN_BATCH * len(timed) / (sum(timed) / 1e3),
            "step_ms_p50": p50, "step_ms": step_ms,
            "flops_per_step": flops,
            "mfu": flops / (p50 / 1e3) / PEAK_FLOPS["float32"],
            "losses": losses, "launches": launches,
            "peak_memory_bytes": int(peak), "parity": parity,
            "profile": profile, "host": host}


def cnn_digits(torch, card):
    """The port's cnn_main.run() with CNN_DIGITS_ARGS on the card: held
    to CNN_DIGITS_MIN_ACC held-out accuracy, no flash kernel launched."""
    from hetu_tpu_torch import data
    from hetu_tpu_torch.examples import cnn_main
    from hetu_tpu_torch.ops import _build
    args = cnn_main.parse_args(list(CNN_DIGITS_ARGS))
    batches = len(data.digits()[0][0]) // args.batch_size
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    results = cnn_main.run(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    if not results["val_acc"] >= CNN_DIGITS_MIN_ACC:
        raise AssertionError(f"cnn_digits val_acc {results['val_acc']} < "
                             f"{CNN_DIGITS_MIN_ACC}: {results}")
    if any(launches.values()):
        raise AssertionError(f"cnn_digits launched flash kernels: "
                             f"{launches}")
    return {"card": card, "args": " ".join(CNN_DIGITS_ARGS),
            "val_acc": results["val_acc"], "min_val_acc": CNN_DIGITS_MIN_ACC,
            "train_acc": results["train_acc"],
            "train_loss": results["train_loss"],
            "epoch_time_s": results["epoch_time"],
            "steps_per_epoch": batches,
            "steps_per_s": batches / results["epoch_time"],
            "wall_s": wall_s, "launches": launches}


# ---------------------------------------------------------------------------
# the sparse passes (CTR, NCF) and the seq2seq Transformer
# ---------------------------------------------------------------------------

def sparse_graph(ht, builder, dense_param):
    """The pass's graph over three feed placeholders: (feed nodes, loss,
    the gradient node of ``dense_param``, train op, and per table its
    name, the adjoint of its lookup's output and the index of the id feed
    it is looked up with)."""
    from hetu_tpu_torch.models.ncf import ML25M_ITEMS, ML25M_USERS
    from hetu_tpu_torch.ops.embedding import EmbeddingLookUpGradient
    if builder == "neural_mf":
        nodes = [ht.Variable(n, trainable=False)
                 for n in ("user_input", "item_input", "y_")]
        loss, _, train_op = ht.models.neural_mf(*nodes, ML25M_USERS,
                                                ML25M_ITEMS)
    else:
        nodes = [ht.Variable(n, trainable=False)
                 for n in ("dense_input", "sparse_input", "y_")]
        loss, _, _, train_op = getattr(ht.models, builder)(
            *nodes, feature_dimension=CTR_ROWS)
    pairs = list(zip(train_op.optimizer.params, train_op.inputs))
    grad = next(g for p, g in pairs if p.name == dense_param)
    lookups = [(p.name, g.inputs[0], nodes.index(g.inputs[1]))
               for p, g in pairs if isinstance(g, EmbeddingLookUpGradient)]
    return nodes, loss, grad, train_op, lookups


def sparse_traffic(builder, seed):
    """SPARSE_CYCLE batches of the pass's feeds, as bench.py draws them
    (the same order of draws from one RandomState)."""
    from hetu_tpu_torch.models.ncf import ML25M_ITEMS, ML25M_USERS
    rng = np.random.RandomState(seed)
    if builder == "neural_mf":
        users = rng.randint(0, ML25M_USERS, (SPARSE_CYCLE, NCF_BATCH)
                            ).astype(np.int32)
        items = ((rng.zipf(1.3, size=(SPARSE_CYCLE, NCF_BATCH)) - 1)
                 % ML25M_ITEMS).astype(np.int32)
        y_in = rng.randint(0, 2, (NCF_BATCH, 1)).astype("f")
        return [(users[i], items[i], y_in) for i in range(SPARSE_CYCLE)]
    ids = ((rng.zipf(1.3, size=(SPARSE_CYCLE, CTR_BATCH, 26)) - 1)
           % CTR_ROWS).astype(np.int32)
    dense_in = rng.randn(CTR_BATCH, 13).astype("f")
    y_in = rng.randint(0, 2, (CTR_BATCH, 1)).astype("f")
    return [(dense_in, ids[i], y_in) for i in range(SPARSE_CYCLE)]


def _dense_work_bytes(exe, tables):
    """Every intermediate value of a step alive at once (the shapes the
    executor inferred; a lookup's gradient holds its rows, not the
    table), plus the parameters that are not tables three times."""
    from hetu_tpu_torch.ops.embedding import EmbeddingLookUpGradient
    from hetu_tpu_torch.ops.variable import PlaceholderOp
    sub = exe.subexecutors["train"]
    total = 0
    for node in sub.topo_order:
        if isinstance(node, PlaceholderOp):
            continue
        shape = node.inferred_shape
        if isinstance(node, EmbeddingLookUpGradient):
            shape = tuple(node.inputs[0].inferred_shape)
        total += 4 * int(np.prod(shape))
    params = sum(t.numel() * t.element_size() for sid, t in
                 exe.params.items() if sid not in tables)
    return total + 3 * params


def _table_ids(exe):
    return {sid for sid, node in exe._param_nodes.items() if node.is_embed}


def _step1(exe, subgraph, nodes, lookups, batch, initial):
    """Step 1 of ``subgraph`` (fetching [loss, dense gradient, the lookups'
    adjoints, train op]) on ``batch``: the loss, the dense gradient, and
    per table over the rows the batch touches: its gradient (the
    adjoint's rows summed per id, in float64 on the host), its rows after
    the step and its update (after less ``initial``)."""
    out = exe.run(subgraph, feed_dict=dict(zip(nodes, batch)))
    by_name = {node.name: sid for sid, node in exe._param_nodes.items()}
    step = {"loss": float(out[0].asnumpy()), "grad": out[1].asnumpy(),
            "tables": {}}
    for (tname, _, feed), adjoint in zip(lookups, out[2:]):
        ids, inverse = np.unique(np.asarray(batch[feed]).reshape(-1),
                                 return_inverse=True)
        rows = adjoint.asnumpy().reshape(inverse.size, -1)
        summed = np.zeros((ids.size, rows.shape[1]))
        np.add.at(summed, inverse, rows)
        after = exe.params[by_name[tname]][ids].cpu().numpy()
        step["tables"][tname] = {"grad": summed, "rows": after,
                                 "update": after - initial[tname][ids]}
    return step


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def sparse_parity(torch, name, card_step, initial, batch):
    """Step 1 on the port's CPU path from the card run's initial values
    (``initial``: name -> array, copied before the card's step 1) on
    ``batch``, against ``card_step`` (_step1 on the card). Held: the
    loss, the dense gradient, and per table its summed gradient rows and
    its touched rows after the step. Reported: the update the step
    applied to those rows. SGD adds each id's rows into the table one at
    a time (on the card with atomics, in no fixed order): an addend of
    ~4e-7 into a value of ~1e-2 rounds by up to ~1e-3 of itself, so the
    applied update differs by order, not by the gradient."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.graph.autodiff import find_topo_sort
    from hetu_tpu_torch.ops.variable import PlaceholderOp
    builder, dense_param = SPARSE_PASSES[name]
    nodes, loss, grad, train_op, lookups = sparse_graph(ht, builder,
                                                        dense_param)
    for node in find_topo_sort([train_op]):
        if isinstance(node, PlaceholderOp) and node.name in initial:
            node.initializer = None
            node.tensor_value = initial[node.name].copy()
    exe = ht.Executor([loss, grad, *(a for _, a, _ in lookups), train_op],
                      device="cpu")
    cpu = _step1(exe, "default", nodes, lookups, batch, initial)
    tables = {tname: {"grad_rel_err": _rel(card["grad"], cpu_t["grad"]),
                      "rows_rel_err": _rel(card["rows"], cpu_t["rows"]),
                      "update_rel_err": _rel(card["update"],
                                             cpu_t["update"]),
                      "touched_rows": int(cpu_t["rows"].shape[0])}
              for (tname, card), cpu_t in zip(
                  card_step["tables"].items(), cpu["tables"].values())}
    parity = {"batch": int(batch[1].shape[0]), "reference": "cpu float32",
              "loss_cuda": card_step["loss"], "loss_cpu": cpu["loss"],
              "loss_rel_err": abs(card_step["loss"] - cpu["loss"])
              / abs(cpu["loss"]),
              "grad": dense_param,
              "grad_rel_err": _rel(card_step["grad"], cpu["grad"]),
              "tables": tables,
              "loss_tol": SPARSE_LOSS_TOL, "grad_tol": SPARSE_GRAD_TOL}
    held = [parity["grad_rel_err"]] + [
        t[k] for t in tables.values() for k in ("grad_rel_err",
                                                "rows_rel_err")]
    if parity["loss_rel_err"] > SPARSE_LOSS_TOL or max(held) \
            > SPARSE_GRAD_TOL:
        raise AssertionError(f"{name} step-1 parity, card against the "
                             f"CPU, failed: {parity}")
    return parity


def sparse_pass(torch, name, card, seed):
    """One pass of SPARSE_PASSES on the card: step 1 on the traffic's
    first batch with its initial values kept for the parity, then the
    main path — one warm-up and SPARSE_TIMED_BLOCKS timed blocks of
    SPARSE_BLOCK steps through Executor.run_batches, the launch counts set
    to 0 just before and read just after (no flash kernel may launch) and
    the peak memory held to the in-place bound; for wdl_criteo one
    profiled step (idle share, device time by kernel category and by op
    type) and one with each op's host time; last the CPU twin's step 1
    (sparse_parity)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    builder, dense_param = SPARSE_PASSES[name]
    traffic = sparse_traffic(builder, seed)
    nodes, loss, grad, train_op, lookups = sparse_graph(ht, builder,
                                                        dense_param)
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    # one set of parameters: "step1" also fetches what the parity holds;
    # the main path runs "train", which keeps only the losses
    exe = ht.Executor({"step1": [loss, grad, *(a for _, a, _ in lookups),
                                 train_op],
                       "train": [loss, train_op]})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tables = _table_ids(exe)
    table_bytes = sum(exe.params[sid].numel() * exe.params[sid]
                      .element_size() for sid in tables)
    # copies: the table's update is in place
    initial = {exe._param_nodes[sid].name: t.to("cpu", copy=True).numpy()
               for sid, t in exe.params.items()}
    card_step = _step1(exe, "step1", nodes, lookups, traffic[0], initial)

    def block(i0):
        return [dict(zip(nodes, traffic[(i0 + j) % SPARSE_CYCLE]))
                for j in range(SPARSE_BLOCK)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    losses, block_ms = [], []
    for b in range(1 + SPARSE_TIMED_BLOCKS):
        t0 = time.perf_counter()
        outs = exe.run_batches(block(1 + b * SPARSE_BLOCK), name="train")
        outs[-1][0].asnumpy()
        block_ms.append((time.perf_counter() - t0) * 1e3)
        losses.extend(float(o[0].asnumpy()) for o in outs)
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    peak = torch.cuda.max_memory_allocated() - base
    dense_bytes = _dense_work_bytes(exe, tables)
    bound = SPARSE_TABLE_FACTOR * table_bytes + dense_bytes
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{name} losses not finite: {losses}")
    if any(launches.values()):
        raise AssertionError(f"{name} launched flash kernels: {launches}")
    if not peak < bound:
        raise AssertionError(f"{name} peak memory {peak} B >= {bound} B: "
                             f"the table is copied in a step")
    timed = block_ms[1:]
    step_ms = [ms / SPARSE_BLOCK for ms in timed]
    batch = int(traffic[0][1].shape[0])
    line = {"card": card, "model": builder, "batch": batch,
            "table_rows": {exe._param_nodes[sid].name: int(
                exe.params[sid].shape[0]) for sid in tables},
            "table_bytes": int(table_bytes), "dtype": "float32",
            "optimizer": "SGD", "lr": float(train_op.optimizer.learning_rate),
            "executor_setup_s": setup_s, "block_steps": SPARSE_BLOCK,
            "warmup_blocks": 1, "timed_blocks": SPARSE_TIMED_BLOCKS,
            "samples_per_s": batch * SPARSE_BLOCK * len(timed)
            / (sum(timed) / 1e3),
            "step_ms_p50": float(np.median(step_ms)), "step_ms": step_ms,
            "losses_first_last": [losses[0], losses[-1]],
            "loss_mean_by_block": [float(np.mean(losses[i:i + SPARSE_BLOCK]))
                                   for i in range(0, len(losses),
                                                  SPARSE_BLOCK)],
            "launches": launches, "peak_memory_bytes": int(peak),
            "memory_bound_bytes": int(bound),
            "dense_work_bytes": int(dense_bytes)}
    if name == "wdl_criteo":
        feeds = dict(zip(nodes, traffic[0]))

        def step():
            return exe.run("train", feed_dict=feeds)[0].asnumpy()
        profile = profile_window(torch, step)
        profile["device_ms_by_op_type"] = profile_window(
            torch, step, exe.subexecutors["train"].topo_order)[
                "device_ms_by_op_type"]
        line["profile"] = profile
        line["host"] = host_ms_by_op(torch, exe, feeds, "train")
    del exe
    torch.cuda.empty_cache()
    line["parity"] = sparse_parity(torch, name, card_step, initial,
                                   traffic[0])
    return line


def ncf_hr(torch, card):
    """The port's rec_main.worker with NCF_HR_ARGS on the card: held to
    the JAX package's HR@10 and NDCG@10 bars, no flash kernel launched."""
    from hetu_tpu_torch.examples import rec_main
    from hetu_tpu_torch.ops import _build
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    results = rec_main.worker(rec_main.parse_args(list(NCF_HR_ARGS)))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    if not (results["hr"] >= NCF_MIN_HR and results["ndcg"] >= NCF_MIN_NDCG):
        raise AssertionError(f"ncf_hr below the bars HR@10 >= {NCF_MIN_HR}, "
                             f"NDCG@10 >= {NCF_MIN_NDCG}: {results}")
    if any(launches.values()):
        raise AssertionError(f"ncf_hr launched flash kernels: {launches}")
    return {"card": card, "args": " ".join(NCF_HR_ARGS),
            "hr": results["hr"], "ndcg": results["ndcg"],
            "min_hr": NCF_MIN_HR, "min_ndcg": NCF_MIN_NDCG,
            "train_loss": results["loss"],
            "steps_per_epoch": results["steps_per_epoch"],
            "steps_per_s": results["steps_per_epoch"]
            / results["train_time"],
            "wall_s": wall_s, "launches": launches}


def transformer_train_flops(cfg):
    """Analytic FLOPs of one Transformer training step (the backward
    counts 2x the forward). Forward, per source token and encoder layer:
    QKVO 8d^2, scores and context 4 T1 d, FFN 4 d d_ff; per target token
    and decoder layer: self-attention 8d^2 + 4 T2 d (the full score
    matrix, as the graph computes it under the causal mask), the cross
    attention's Q and O 4d^2 and scores and context 4 T1 d, FFN 4 d d_ff,
    and per source token and decoder layer the cross K and V 4d^2; the
    tied output projection 2 d V per target token. Embeddings, layer
    norm, softmax and the loss are O(d) or O(V) a token and left out."""
    d, f, n, v = cfg.d_model, cfg.d_ff, cfg.num_blocks, cfg.vocab_size
    t1, t2 = cfg.maxlen1, cfg.maxlen2 - 1
    enc = n * t1 * (8 * d * d + 4 * t1 * d + 4 * d * f)
    dec = n * (t2 * (12 * d * d + 4 * t2 * d + 4 * t1 * d + 4 * d * f)
               + t1 * 4 * d * d)
    return 3.0 * cfg.batch_size * (enc + dec + t2 * 2 * d * v)


def reversal_batch(cfg, rng):
    """One batch of the reversal task (transformer_main's synthetic
    data): source ids in [2, vocab), the target the source reversed,
    the decoder input the target after a BOS (1)."""
    src = rng.randint(2, cfg.vocab_size, (cfg.batch_size, cfg.maxlen1))
    tgt = src[:, ::-1][:, :cfg.maxlen2 - 1].copy()
    dec = np.concatenate([np.ones((cfg.batch_size, 1), np.int64),
                          tgt[:, :-1]], 1)
    return src, dec, tgt


def _transformer_graph(ht, cfg, grads=()):
    model = ht.models.Transformer(cfg)
    nodes = [ht.Variable(n, trainable=False)
             for n in ("src_ids", "dec_ids", "tgt_ids")]
    loss = model(*nodes)
    train_op = ht.optim.AdamOptimizer(TRANSFORMER_LR).minimize(loss)
    picked = [next(g for p, g in zip(train_op.optimizer.params,
                                     train_op.inputs) if p.name == name)
              for name in grads]
    return nodes, loss, picked, train_op


def transformer_parity(torch, seed):
    """Step 1 at dropout 0 and B=TRANSFORMER_PARITY_BATCH: the card
    against the CPU in f32 (held), and both against the CPU in float64
    (reported)."""
    import hetu_tpu_torch as ht
    cfg = dataclasses.replace(ht.models.TransformerConfig(),
                              dropout_rate=0.0,
                              batch_size=TRANSFORMER_PARITY_BATCH)
    batch = reversal_batch(cfg, np.random.RandomState(seed + 1))
    out = {}
    for run, device, dtype in (("cuda", "cuda", None), ("cpu", "cpu", None),
                               ("cpu_f64", "cpu", torch.float64)):
        nodes, loss, grads, train_op = _transformer_graph(
            ht, cfg, TRANSFORMER_PARITY_GRADS)
        exe = ht.Executor([loss, *grads, train_op], device=device,
                          dtype=dtype)
        vals = exe.run(feed_dict=dict(zip(nodes, batch)))[:-1]
        out[run] = [np.asarray(v.asnumpy(), np.float64) for v in vals]
        del exe
    torch.cuda.empty_cache()

    def errs(got, want):
        (gl, *gg), (wl, *wg) = out[got], out[want]
        return {"loss_rel_err": float(abs(gl - wl) / abs(wl)),
                "grad_rel_err": {name: float(np.abs(g - w).max()
                                             / np.abs(w).max())
                                 for name, g, w in zip(
                                     TRANSFORMER_PARITY_GRADS, gg, wg)}}
    parity = {"batch": TRANSFORMER_PARITY_BATCH, "dropout": 0.0,
              "reference": "cpu float32", "loss_cuda": float(out["cuda"][0]),
              "loss_cpu": float(out["cpu"][0]), **errs("cuda", "cpu"),
              "loss_tol": TRANSFORMER_LOSS_TOL,
              "grad_tol": TRANSFORMER_GRAD_TOL,
              "cuda_vs_cpu_f64": errs("cuda", "cpu_f64"),
              "cpu_f32_vs_f64": errs("cpu", "cpu_f64")}
    if parity["loss_rel_err"] > TRANSFORMER_LOSS_TOL or \
            max(parity["grad_rel_err"].values()) > TRANSFORMER_GRAD_TOL:
        raise AssertionError(f"transformer step-1 parity, card against the "
                             f"CPU, failed: {parity}")
    return parity


def transformer_train(torch, card, seed):
    """The Transformer pass: TRANSFORMER_WARMUP + TRANSFORMER_STEPS Adam
    steps of Transformer-base in f32 on reversal batches, each ending in
    the loss's readback, the launch counts set to 0 just before and read
    just after (no flash kernel may launch: attention is composed from
    batch_matmul and softmax, as in the reference); one profiled step
    (idle share, device time by kernel category and by op type), one
    with each op's host time, and the step-1 parity
    (transformer_parity)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    cfg = ht.models.TransformerConfig()
    rng = np.random.RandomState(seed)
    batches = [reversal_batch(cfg, rng)
               for _ in range(TRANSFORMER_WARMUP + TRANSFORMER_STEPS + 3)]
    nodes, loss, _, train_op = _transformer_graph(ht, cfg)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    exe = ht.Executor([loss, train_op])
    setup_s = time.perf_counter() - t0
    losses, step_ms = [], []
    for batch in batches[:TRANSFORMER_WARMUP + TRANSFORMER_STEPS]:
        t0 = time.perf_counter()
        losses.append(float(exe.run(
            feed_dict=dict(zip(nodes, batch)))[0].asnumpy()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    peak = torch.cuda.max_memory_allocated() - base
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"transformer losses not finite: {losses}")
    if any(launches.values()):
        raise AssertionError(f"transformer launched flash kernels: "
                             f"{launches}")
    timed = step_ms[TRANSFORMER_WARMUP:]
    p50 = float(np.median(timed))
    flops = transformer_train_flops(cfg)
    feeds = iter(batches[TRANSFORMER_WARMUP + TRANSFORMER_STEPS:])

    def step():
        return exe.run(feed_dict=dict(zip(nodes, next(feeds))))[0].asnumpy()
    profile = profile_window(torch, step)
    profile["device_ms_by_op_type"] = profile_window(
        torch, step, exe.subexecutors["default"].topo_order)[
            "device_ms_by_op_type"]
    host = host_ms_by_op(torch, exe, dict(zip(nodes, next(feeds))))
    n_params = sum(int(v.numel()) for v in exe.params.values())
    del exe
    torch.cuda.empty_cache()
    targets = cfg.batch_size * (cfg.maxlen2 - 1)
    return {"card": card, "config": dataclasses.asdict(cfg),
            "params": n_params, "dtype": "float32", "optimizer": "Adam",
            "lr": TRANSFORMER_LR, "executor_setup_s": setup_s,
            "warmup_steps": TRANSFORMER_WARMUP,
            "timed_steps": TRANSFORMER_STEPS,
            "tokens_per_s": targets * len(timed) / (sum(timed) / 1e3),
            "step_ms_p50": p50, "step_ms": step_ms,
            "flops_per_step": flops,
            "mfu": flops / (p50 / 1e3) / PEAK_FLOPS["float32"],
            "losses": losses, "launches": launches,
            "peak_memory_bytes": int(peak),
            "parity": transformer_parity(torch, seed),
            "profile": profile, "host": host}


def transformer_reverse(torch, card):
    """The port's transformer_main.main with TRANSFORMER_REVERSE_ARGS on
    the card: the reversal task's loss below the JAX package's bar, no
    flash kernel launched."""
    from hetu_tpu_torch.examples import transformer_main
    from hetu_tpu_torch.ops import _build
    args = transformer_main.parse_args(list(TRANSFORMER_REVERSE_ARGS))
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    results = transformer_main.main(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    if not results["loss"] < TRANSFORMER_MAX_LOSS:
        raise AssertionError(f"transformer_reverse loss {results['loss']} "
                             f">= {TRANSFORMER_MAX_LOSS}: {results}")
    if any(launches.values()):
        raise AssertionError(f"transformer_reverse launched flash kernels: "
                             f"{launches}")
    return {"card": card, "args": " ".join(TRANSFORMER_REVERSE_ARGS),
            "loss": results["loss"], "max_loss": TRANSFORMER_MAX_LOSS,
            "tokens_per_s": results["tokens_per_sec"],
            "epoch_time_s": results["epoch_time"],
            "steps_per_s": results["steps_per_epoch"]
            / results["epoch_time"],
            "wall_s": wall_s, "launches": launches}


# ---------------------------------------------------------------------------
# the GNNs: GCN and GraphSAGE at OGB-arxiv scale, and the two examples
# ---------------------------------------------------------------------------

def gnn_graph(n=GNN_NODES):
    """bench.py:1030-1079's graph and feeds: (normalized adjacency as a
    scipy CSR, features, one-hot labels, mask), all from RandomState(0);
    ``n`` nodes (a rehearsal on the CPU cuts it)."""
    import scipy.sparse as sp
    rng = np.random.RandomState(0)
    rows = np.repeat(np.arange(n), GNN_DEGREE)
    cols = rng.randint(0, n, n * GNN_DEGREE)
    m = sp.coo_matrix((np.ones(n * GNN_DEGREE, np.float32), (rows, cols)),
                      shape=(n, n)).tocsr()
    m = m + sp.eye(n, format="csr", dtype=np.float32)
    dinv = sp.diags(1.0 / np.sqrt(np.asarray(m.sum(1)).ravel()))
    adj = (dinv @ m @ dinv).tocsr()
    feat = rng.randn(n, GNN_FEATURES).astype(np.float32)
    y = np.eye(GNN_CLASSES, dtype=np.float32)[
        rng.randint(0, GNN_CLASSES, n)]
    return adj, feat, y, np.ones(n, np.float32)


def _gnn_graph(ht, builder):
    """The pass's graph: (feed nodes, the mean loss, the train op, the
    input of each ReLU)."""
    from hetu_tpu_torch.graph.autodiff import find_topo_sort
    from hetu_tpu_torch.ops.activations import ReluOp
    nodes = [ht.Variable(name, trainable=False)
             for name in ("feat", "y_", "mask_", "norm_adj")]
    loss, _, train_op = getattr(ht.models, builder)(
        *nodes, GNN_FEATURES, GNN_HIDDEN, GNN_CLASSES)
    loss = ht.reduce_mean_op(loss, [0])
    pre = [n.inputs[0] for n in find_topo_sort([loss])
           if isinstance(n, ReluOp)]
    return nodes, loss, train_op, pre


def _gnn_feeds(ht, graph, device):
    """The graph's feeds on ``device``: tensors and a CSRValue."""
    import torch
    from hetu_tpu_torch.ndarray import CSRValue
    adj, feat, y, mask = graph
    sp_adj = ht.ND_Sparse_Array(
        adj.data.astype(np.float32), adj.indptr.astype(np.int32),
        adj.indices.astype(np.int32), nrow=adj.shape[0], ncol=adj.shape[1])
    return [torch.from_numpy(a).to(device) for a in (feat, y, mask)] + [
        CSRValue.from_sparse_array(sp_adj, device)]


def _gnn_step1(exe, subgraph, nodes, feeds, train_op, pre):
    """Step 1 of ``subgraph`` (fetching [loss, every gradient, every
    ReLU input, train op]): the loss, each parameter's gradient by name
    and the ReLU inputs."""
    out = exe.run(subgraph, feed_dict=dict(zip(nodes, feeds)))
    grads = out[1:len(train_op.inputs) + 1]
    return {"loss": float(out[0].asnumpy()),
            "grads": {p.name: g.asnumpy() for p, g in zip(
                train_op.optimizer.params, grads)},
            "pre": [v.asnumpy() for v in out[len(grads) + 1:-1]]}


def _relu_by_mask(node, mask):
    """``node`` (a ReLU or its gradient op) computing with the ReLU
    decisions ``mask`` in place of its own input's signs."""
    from hetu_tpu_torch.ops.activations import ReluOp

    def compute(input_vals, ectx):
        if isinstance(node, ReluOp):
            return input_vals[0] * mask
        return input_vals[1] * mask
    node.compute = compute


def gnn_parity(torch, builder, card_step, initial, graph):
    """Step 1 on the port's CPU path from the card's initial values
    (``initial``: name -> array), its ReLUs deciding as the card's did,
    against ``card_step``: each ReLU input within GNN_PRE_TOL of its
    largest element, the loss within GNN_LOSS_TOL relative, each
    gradient within GNN_GRAD_TOL of its largest element; the ReLU inputs
    whose sign differs are counted."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.graph.autodiff import find_topo_sort
    from hetu_tpu_torch.ops.activations import ReluGradientOp, ReluOp
    from hetu_tpu_torch.ops.variable import PlaceholderOp
    nodes, loss, train_op, pre = _gnn_graph(ht, builder)
    masks = {node: torch.from_numpy(p > 0)
             for node, p in zip(pre, card_step["pre"])}
    for node in find_topo_sort([train_op]):
        if isinstance(node, PlaceholderOp) and node.name in initial:
            node.initializer = None
            node.tensor_value = initial[node.name]
        elif isinstance(node, (ReluOp, ReluGradientOp)):
            _relu_by_mask(node, masks[node.inputs[0]])
    exe = ht.Executor([loss, *train_op.inputs, *pre, train_op],
                      device="cpu")
    cpu = _gnn_step1(exe, "default", nodes, _gnn_feeds(ht, graph, "cpu"),
                     train_op, pre)
    flips = [(got > 0) != (want > 0)
             for got, want in zip(card_step["pre"], cpu["pre"])]
    parity = {"reference": "cpu float32, the card's ReLU decisions",
              "pre_rel_err": [_rel(got, want) for got, want in zip(
                  card_step["pre"], cpu["pre"])],
              "relu_flips": [int(f.sum()) for f in flips],
              "relu_flip_max_abs_input": max(
                  (float(np.abs(want[f]).max()) for f, want in
                   zip(flips, cpu["pre"]) if f.any()), default=0.0),
              "loss_cuda": card_step["loss"], "loss_cpu": cpu["loss"],
              "loss_rel_err": abs(card_step["loss"] - cpu["loss"])
              / abs(cpu["loss"]),
              "grad_rel_err": {name: _rel(card_step["grads"][name], g)
                               for name, g in cpu["grads"].items()},
              "pre_tol": GNN_PRE_TOL, "loss_tol": GNN_LOSS_TOL,
              "grad_tol": GNN_GRAD_TOL}
    if max(parity["pre_rel_err"]) > GNN_PRE_TOL \
            or parity["loss_rel_err"] > GNN_LOSS_TOL \
            or max(parity["grad_rel_err"].values()) > GNN_GRAD_TOL:
        raise AssertionError(f"{builder} step-1 parity, card against the "
                             f"CPU, failed: {parity}")
    return parity


def _gnn_flops(sub, loss, nnz):
    """(GEMM FLOPs: 3 x the forward's matmuls, SpMM FLOPs: 2 x entries x
    columns of every csrmm the step runs, forward and backward)."""
    from hetu_tpu_torch.ops.sparse import CsrmmOp
    spmm = sum(2 * nnz * node.inferred_shape[1] for node in sub.topo_order
               if isinstance(node, CsrmmOp))
    return 3 * cnn_forward_flops(loss), spmm


def event_epochs(torch, run, n=5):
    """Medians over ``n`` calls of ``run`` (a step that returns its
    outputs, read back after): the host time to queue the step
    (``queue_ms``), the device's time from the step's first queued work
    to its last (``device_span_ms``, two CUDA events) and the wall time
    to the readback (``wall_ms``). Where the host queues the step in a
    fraction of the span, the device runs it without waiting on the
    host."""
    rows = []
    for _ in range(n):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = run()
        t1 = time.perf_counter()
        end.record()
        out[0].asnumpy()
        rows.append(((t1 - t0) * 1e3, start.elapsed_time(end),
                     (time.perf_counter() - t0) * 1e3))
    queue, span, wall = (float(np.median(col)) for col in zip(*rows))
    return {"queue_ms": queue, "device_span_ms": span, "wall_ms": wall}


def _gnn_category(op_type):
    return next((c for c, prefixes in GNN_OP_CATEGORIES
                 if op_type.startswith(prefixes)), "elementwise / other")


def gnn_pass(torch, builder, card, graph):
    """One pass of GNN_PASSES on the card: step 1 with the card's initial
    values kept for the parity, then the main path — GNN_WARMUP +
    GNN_EPOCHS full-graph epochs over feeds pinned on the card, the
    launch counts set to 0 just before and read just after (no flash
    kernel may launch) —, five timed by CUDA events (event_epochs), one
    profiled epoch (idle share, device time by kernel category), one with
    a range per op (device time by op type and op category, the sparse
    one among them), one with each op's host time, and last the CPU
    twin's step 1 (gnn_parity)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    nodes, loss, train_op, pre = _gnn_graph(ht, builder)
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    exe = ht.Executor({"step1": [loss, *train_op.inputs, *pre, train_op],
                       "train": [loss, train_op]})
    feeds = _gnn_feeds(ht, graph, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    initial = {exe._param_nodes[sid].name: t.cpu().numpy()
               for sid, t in exe.params.items()}
    card_step = _gnn_step1(exe, "step1", nodes, feeds, train_op, pre)
    feed_dict = dict(zip(nodes, feeds))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    losses, epoch_ms = [], []
    for _ in range(GNN_WARMUP + GNN_EPOCHS):
        t0 = time.perf_counter()
        losses.append(float(exe.run("train", feed_dict=feed_dict)[0]
                            .asnumpy()))
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    peak = torch.cuda.max_memory_allocated() - base
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{builder} loss not finite and falling: "
                             f"{losses}")
    if any(launches.values()):
        raise AssertionError(f"{builder} launched flash kernels: "
                             f"{launches}")
    timed = epoch_ms[GNN_WARMUP:]
    p50 = float(np.median(timed))
    sub = exe.subexecutors["train"]
    gemm_flops, spmm_flops = _gnn_flops(sub, loss, int(graph[0].nnz))
    flops = gemm_flops + spmm_flops

    def epoch():
        return exe.run("train", feed_dict=feed_dict)[0].asnumpy()
    events = event_epochs(torch, lambda: exe.run("train",
                                                 feed_dict=feed_dict))
    profile = profile_window(torch, epoch)
    by_op_type = profile_window(torch, epoch, sub.topo_order)[
        "device_ms_by_op_type"]
    by_cat = {}
    for op_type, v in by_op_type.items():
        cat = _gnn_category(op_type)
        by_cat[cat] = by_cat.get(cat, 0.0) + v["ms"]
    profile["device_ms_by_op_type"] = by_op_type
    profile["device_ms_by_op_category"] = dict(
        sorted(by_cat.items(), key=lambda x: -x[1]))
    host = host_ms_by_op(torch, exe, feed_dict, "train")
    n_params = sum(int(v.numel()) for v in exe.params.values())
    del exe, feeds, feed_dict
    torch.cuda.empty_cache()
    adj = graph[0]
    return {"card": card, "model": builder, "nodes": int(adj.shape[0]),
            "nnz": int(adj.nnz), "features": GNN_FEATURES,
            "hidden": GNN_HIDDEN, "classes": GNN_CLASSES,
            "params": n_params, "dtype": "float32", "optimizer": "SGD",
            "lr": float(train_op.optimizer.learning_rate),
            "spmm": "gather + scale + sorted segment-sum "
                    "(torch.segment_reduce over the row pointer)",
            "executor_setup_s": setup_s, "warmup_epochs": GNN_WARMUP,
            "timed_epochs": GNN_EPOCHS, "epoch_ms_p50": p50,
            "epochs_per_s": len(timed) / (sum(timed) / 1e3),
            "epoch_ms": epoch_ms, "gemm_flops": gemm_flops,
            "spmm_flops": spmm_flops,
            "mfu": flops / (p50 / 1e3) / PEAK_FLOPS["float32"],
            "losses": losses, "launches": launches,
            "peak_memory_bytes": int(peak), "events": events,
            "parity": gnn_parity(torch, builder, card_step, initial, graph),
            "profile": profile, "host": host}


def spmm_compare(torch, card, graph):
    """csrmm at [169343 x 169343] . [169343 x 256] on the card, the
    formulation in use (gather + scale + sorted segment-sum) against
    cuSPARSE's CSR SpMM (``torch.sparse_csr_tensor @ dense``) on the
    same inputs: device ms of each (device_ms), the time of a call with
    its host part (median_ms), their largest difference, and the bound
    (entries, row pointer and the dense operand read once, the output
    written once; 2 x nnz x F FLOPs)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import sparse
    adj = graph[0]
    n, nnz, f = adj.shape[0], int(adj.nnz), GNN_HIDDEN
    value = _gnn_feeds(ht, graph, "cuda")[3]
    dense = torch.randn(n, f, generator=torch.Generator("cuda")
                        .manual_seed(0), device="cuda")
    csr = torch.sparse_csr_tensor(value.indptr, value.indices, value.data,
                                  size=(n, n))

    def in_use():
        return sparse._csr_product(value, dense, False)

    def cusparse():
        return csr @ dense

    def gather():
        return dense.index_select(0, value.indices)

    def gather_index_add():
        rows = gather().mul_(value.data[:, None])
        return torch.zeros_like(dense).index_add_(0, value.row_ids, rows)
    err = float((in_use() - cusparse()).abs().max())
    nbytes = nnz * 8 + (n + 1) * 4 + 2 * n * f * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * nnz * f / PEAK_FLOPS["float32"]
    line = {"card": card, "shape": [n, n, f], "nnz": nnz,
            "in_use": "gather + scale + sorted segment-sum",
            "other": "cuSPARSE CSR SpMM (torch.sparse_csr_tensor @ dense)",
            "device_ms": device_ms(torch, in_use, "spmm segment"),
            "other_device_ms": device_ms(torch, cusparse, "spmm cusparse"),
            "ms": median_ms(torch, in_use),
            "other_ms": median_ms(torch, cusparse),
            # the formulation's gather alone, and the same product summed
            # by index_add_ (atomics, no fixed order) in place of the
            # sorted segment-sum
            "gather_device_ms": device_ms(torch, gather, "spmm gather"),
            "index_add_device_ms": device_ms(torch, gather_index_add,
                                             "spmm index_add"),
            "max_abs_diff": err,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    del value, dense, csr
    torch.cuda.empty_cache()
    return line


def gcn_example(torch, card):
    """The port's gcn_main.run with GCN_EXAMPLE_ARGS on the card at the
    reference example's graph: each epoch's loss and accuracy held to the
    JAX package's CPU run (GCN_EXAMPLE_LOSSES, GCN_EXAMPLE_ACCS), no
    flash kernel launched."""
    from hetu_tpu_torch.examples import gcn_main
    from hetu_tpu_torch.ops import _build
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    results = gcn_main.run(gcn_main.parse_args(list(GCN_EXAMPLE_ARGS)))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    loss_err = [abs(g - w) / abs(w) for g, w in zip(results["losses"],
                                                   GCN_EXAMPLE_LOSSES)]
    acc_err = [abs(g - w) for g, w in zip(results["accs"],
                                          GCN_EXAMPLE_ACCS)]
    line = {"card": card, "args": " ".join(GCN_EXAMPLE_ARGS),
            "losses": results["losses"], "accs": results["accs"],
            "loss_rel_err_max": max(loss_err), "acc_err_max": max(acc_err),
            "loss_tol": GCN_EXAMPLE_LOSS_TOL, "acc_tol": GCN_EXAMPLE_ACC_TOL,
            "epoch_ms": [t * 1e3 for t in results["epoch_times"]],
            "wall_s": wall_s, "launches": launches}
    if len(results["losses"]) != len(GCN_EXAMPLE_LOSSES) \
            or max(loss_err) > GCN_EXAMPLE_LOSS_TOL \
            or max(acc_err) > GCN_EXAMPLE_ACC_TOL:
        raise AssertionError(f"gcn_example against the JAX package's CPU "
                             f"run failed: {line}")
    if any(launches.values()):
        raise AssertionError(f"gcn_example launched flash kernels: "
                             f"{launches}")
    return line


def gnn_sampled(torch, card):
    """The port's sampled_sage.main with GNN_SAMPLED_ARGS on the card: a
    fresh sampled subgraph fed through GNNDataLoaderOp every step, the
    last epoch's loss below the JAX package's bar, no flash kernel
    launched."""
    from hetu_tpu_torch.examples import sampled_sage
    from hetu_tpu_torch.ops import _build
    args = sampled_sage.parse_args(list(GNN_SAMPLED_ARGS))
    steps = args.nodes // args.batch_seeds
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    results = sampled_sage.main(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    if not results["loss"] < GNN_SAMPLED_MAX_LOSS:
        raise AssertionError(f"gnn_sampled loss {results['loss']} >= "
                             f"{GNN_SAMPLED_MAX_LOSS}: {results}")
    if any(launches.values()):
        raise AssertionError(f"gnn_sampled launched flash kernels: "
                             f"{launches}")
    last = results["epoch_times"][-1]
    return {"card": card, "args": " ".join(GNN_SAMPLED_ARGS),
            "loss": results["loss"], "losses": results["losses"],
            "max_loss": GNN_SAMPLED_MAX_LOSS,
            "seed_nodes_per_s": results["nodes_per_sec"],
            "steps_per_epoch": steps, "steps_per_s": steps / last,
            "epoch_s": results["epoch_times"], "wall_s": wall_s,
            "launches": launches}


def crossover(torch, seed):
    """Per sequence length (B*H = 96, D=64, bf16, causal), and at
    BERT-base's shape (B=64 H=12 S=128, non-causal, BERT's padding mask):
    one training attention forward + backward through the fused kernels
    (K2, then K3 + K4) against K1 + the composed autograd backward — the
    two routes FlashAttentionOp / its gradient op choose between at
    FUSED_BWD_MIN_SEQ."""
    from hetu_tpu_torch.ops import attention as attn
    from hetu_tpu_torch.ops import flash_attention as fa
    d = 64
    scale = d ** -0.5
    cases = [(TRAIN_BATCH, 12, s, True, None) for s in CROSSOVER_SEQ]
    cases.append((BERT_K1_REP["b"], BERT_K1_REP["h"], BERT_K1_REP["s"],
                  False, "padding"))
    out = []
    for b, h, s, causal, masked in cases:
        g = torch.Generator(device="cuda").manual_seed(seed + s)
        q, k, v, do = (torch.randn(b, h, s, d, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        mask = padding_mask(torch, b, s, torch.bfloat16, g) if masked \
            else None

        def fused():
            o, lse = fa.flash_attention_with_lse(q, k, v, mask, scale,
                                                 causal)
            return fa.flash_attention_bwd(q, k, v, mask, o, lse, do, scale,
                                          causal)

        def composed():
            fa.flash_attention(q, k, v, mask, scale, causal)
            m = mask
            if causal:
                m = attn._causal_mask(s, q.device)
            _, vjp = torch.func.vjp(
                lambda q_, k_, v_: attn.attention_reference(
                    q_, k_, v_, m, scale), q, k, v)
            return vjp(do)

        out.append({"s": s, "b": b, "h": h, "d": d, "dtype": "bfloat16",
                    "causal": causal, "mask": masked,
                    "fused_ms": median_ms(torch, fused, reps=5),
                    "composed_ms": median_ms(torch, composed, reps=5)})
        del q, k, v, do
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# serve: the main path
# ---------------------------------------------------------------------------

def drive(engine, prompts, max_new):
    """Submit every prompt at once, step until all resolve. Returns
    (tokens per request, pass metrics). TTFT counts from the common
    submit time to the end of the step that produced a request's first
    token; a decode step is one that began with every running request
    past its first token and no admission possible (nothing waiting, or
    the batch full), so it ran no prefill."""
    t0 = time.perf_counter()
    futs = [engine.submit(p, max_new, request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    ttft, step_ms, decode_ms = {}, [], []
    while not all(f.done() for f in futs):
        rows = engine.inflight_requests()
        running = [r for r in rows if r["phase"] in ("running", "replay")]
        waiting = len(rows) - len(running)
        decode_only = all(r["tokens_done"] >= 1 for r in running) and (
            not waiting or len(running) >= engine.max_batch_size)
        ts = time.perf_counter()
        engine.step()
        te = time.perf_counter()
        step_ms.append((te - ts) * 1e3)
        if decode_only:
            decode_ms.append((te - ts) * 1e3)
        for r in engine.inflight_requests():
            if r["tokens_done"] >= 1:
                ttft.setdefault(r["request_id"], (te - t0) * 1e3)
        for i, f in enumerate(futs):
            if f.done():
                ttft.setdefault(f"r{i}", (te - t0) * 1e3)
    wall = time.perf_counter() - t0
    outs = [f.result() for f in futs]
    ntok = sum(len(o) for o in outs)
    return outs, {"requests": len(outs), "tokens": ntok,
                  "wall_s": wall, "tokens_per_s": ntok / wall,
                  "ttft_ms_p50": float(np.median(list(ttft.values()))),
                  "decode_step_ms_p50": float(np.median(decode_ms))
                  if decode_ms else None,
                  "steps": len(step_ms), "decode_steps": len(decode_ms)}


def _margin_checked(rows):
    """(tokens, positions checked, smallest margin) of teacher-forced
    logit rows: the argmax of each, and how many lead positions have a
    top-2 gap of at least MARGIN_TOL (argmax may flip past the first
    that does not)."""
    top2 = np.sort(rows, axis=-1)[:, -2:]
    margins = top2[:, 1] - top2[:, 0]
    low = margins < MARGIN_TOL
    checked = int(np.argmax(low)) if low.any() else len(rows)
    return rows.argmax(axis=-1), checked, float(margins.min())


def teacher_forced_logits(torch, cfg, params, tokens):
    """Logits of one causal prefill over ``tokens`` (K1 path), padded
    to the next power of two with the last token like the engine."""
    from hetu_tpu_torch.models.gpt import gpt_paged_prefill
    from hetu_tpu_torch.serving import PagedKVCache
    from hetu_tpu_torch.serving.session import next_bucket
    n = len(tokens)
    p = next_bucket(n)
    cache = PagedKVCache(cfg, num_blocks=p // 16 + 1, device="cuda")
    cache.add_seq(0, p)
    ids = np.full((1, p), tokens[-1], np.int64)
    ids[0, :n] = tokens
    slots = cache.slot_mapping(0, 0, p)[None].astype(np.int64)
    logits, _ = gpt_paged_prefill(
        params, cache.pools, torch.as_tensor(ids, device="cuda"),
        torch.as_tensor(slots, device="cuda"),
        num_heads=cfg.num_attention_heads)
    return logits[0, :n].cpu().numpy()


def serve(torch, seed, card):
    from hetu_tpu_torch.models.gpt import GPTConfig, random_gpt_checkpoint
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import attention as attn
    from hetu_tpu_torch.ops import flash_attention as fa
    from hetu_tpu_torch.serving import ContinuousBatchingEngine

    cfg = GPTConfig(**GPT2_SMALL)
    ckpt = random_gpt_checkpoint(cfg, seed=0)
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    prompts = [rng.integers(0, v, int(n)).astype(np.int32)
               for n in rng.integers(16, 769, NUM_REQUESTS)]
    shared = rng.integers(0, v, 256).astype(np.int32)
    prompts2 = [np.concatenate([shared, rng.integers(0, v, int(n))])
                .astype(np.int32)
                for n in rng.integers(16, 513, NUM_REQUESTS)]

    def engine(**kw):
        return ContinuousBatchingEngine(
            cfg, ckpt.__getitem__, device="cuda", start=False,
            num_blocks=NUM_BLOCKS, max_batch_size=8, **kw)

    # warm-up: library handles and the allocator's first blocks, so the
    # timed passes measure the steady engine
    warm = engine()
    drive(warm, [p[:16] for p in prompts[:2]], 4)
    warm.close()
    del warm

    passes = []
    _build.reset_launch_counts()                    # main path starts
    eng = engine()
    outs, m = drive(eng, prompts, MAX_NEW)
    m.update(name="plain_prefill", k1_launches=_build.launch_counts[
        "flash_fwd"], jit_compiles=eng.jit_compiles,
        compile_bound=eng.compile_bound)
    passes.append(m)
    params = eng.params
    eng.close()
    before = _build.launch_counts["flash_fwd"]
    eng2 = engine(prefix_cache=True, prefill_chunk=128)
    outs2, m2 = drive(eng2, prompts2, MAX_NEW)
    m2.update(name="prefix_cache_chunk128",
              k1_launches=_build.launch_counts["flash_fwd"] - before,
              jit_compiles=eng2.jit_compiles,
              compile_bound=eng2.compile_bound,
              prefix_hit_rate=eng2.cache.prefix.hit_rate())
    passes.append(m2)
    eng2.close()
    launches = dict(_build.launch_counts)           # main path ends
    del eng2
    for name, got in (("plain_prefill", outs), ("prefix", outs2)):
        for o in got:
            if o.shape != (MAX_NEW,) or o.min() < 0 or o.max() >= v:
                raise AssertionError(f"{name}: bad tokens {o}")
    if launches.get("flash_fwd", 0) <= 0 or passes[0]["k1_launches"] <= 0:
        raise AssertionError(f"main path never launched flash_fwd: "
                             f"{launches}")
    # the f32 serving path: every K1 launch on the CUDA-core route
    if launches.get(f"{fa.K1}.simt", 0) != launches[fa.K1] or \
            launches.get(f"{fa.K1}.tc", 0):
        raise AssertionError(f"serve K1 launches off the simt route: "
                             f"{launches}")

    # token parity of request 0: the same engine with the plain blocked
    # attention swapped in for the kernel, up to the first position
    # whose top-2 logit gap is under MARGIN_TOL
    logits = teacher_forced_logits(
        torch, cfg, params, np.concatenate([prompts[0], outs[0][:-1]]))
    tf_tokens, checked, min_margin = _margin_checked(
        logits[len(prompts[0]) - 1:])
    kernel_fa = attn.flash_attention

    def plain_fa(q, k, v_, mask=None, sm_scale=1.0, causal=False):
        s, d = q.shape[-2:]
        if not fa._supported(s, d, *fa._block_sizes(s, d)):
            return kernel_fa(q, k, v_, mask, sm_scale, causal)
        return fa.flash_attention_plain(q, k, v_, mask, sm_scale, causal)

    attn.flash_attention = plain_fa
    try:
        eng3 = engine()
        plain_out, _ = drive(eng3, prompts[:1], MAX_NEW)
        eng3.close()
    finally:
        attn.flash_attention = kernel_fa
    if not (np.array_equal(outs[0][:checked], plain_out[0][:checked])
            and np.array_equal(outs[0][:checked], tf_tokens[:checked])):
        raise AssertionError(
            f"request 0 tokens disagree within the margin-checked "
            f"{checked} positions: kernel {outs[0].tolist()}, plain "
            f"{plain_out[0].tolist()}, teacher-forced "
            f"{tf_tokens.tolist()}")
    eng4 = engine()
    profile = profile_window(torch, lambda: drive(eng4, prompts, MAX_NEW))
    eng4.close()
    return {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "dtype": "float32", "seed": seed,
            "tf32_matmul": bool(torch.backends.cuda.matmul.allow_tf32),
            "max_new_tokens": MAX_NEW, "num_blocks": NUM_BLOCKS,
            "passes": passes, "launches": launches,
            "parity": {"positions_checked": checked,
                       "min_margin": min_margin,
                       "margin_tol": MARGIN_TOL,
                       "tokens_equal_plain": bool(np.array_equal(
                           outs[0], plain_out[0]))},
            "profile": profile}, launches


# ---------------------------------------------------------------------------
# serve_dense: the request-level serving plane
# ---------------------------------------------------------------------------

def _tensors(tree):
    """The tensors of a nested dict / list / tuple of parameters."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def _post(port, ids, gen, rid):
    """One ``POST /v1/predict`` to the server on 127.0.0.1 (http.client:
    no proxy of the environment is consulted). Returns the reply's JSON
    body; raises on any status but 200 or a request id not echoed."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/predict", body=json.dumps(
            {"inputs": {"ids": ids, "gen": [[gen]] * len(ids)}}),
            headers={"Content-Type": "application/json",
                     "x-request-id": rid})
        resp = conn.getresponse()
        body = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200 or body.get("request_id") != rid or \
            resp.getheader("X-Request-Id") != rid:
        raise AssertionError(f"POST /v1/predict {rid}: {resp.status} "
                             f"{body}")
    return body


def _http_clients(port, prompts, gen, clients=DENSE_CLIENTS,
                  per_client=DENSE_PER_CLIENT, rid="dense"):
    """``clients`` closed-loop client threads, each POSTing
    ``per_client`` of ``prompts`` in turn. Returns ({request index:
    tokens}, client latencies in ms)."""
    import threading
    out, latency, errors = {}, [], []

    def client(k):
        try:
            for i in range(k * per_client, (k + 1) * per_client):
                t0 = time.perf_counter()
                body = _post(port, prompts[i:i + 1].tolist(), gen,
                             f"{rid}-{i}")
                latency.append((time.perf_counter() - t0) * 1e3)
                out[i] = np.asarray(body["outputs"][0])
        except Exception as e:                      # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out, latency


def _dense_tick(decoder):
    """A MicroBatcher tick over ``decoder``: the batch padded to the next
    power of two with its last row, every row generated to the longest
    request's ``gen``."""
    from hetu_tpu_torch.serving import next_bucket

    def tick(feeds):
        x, gen = feeds["ids"], int(np.max(feeds["gen"]))
        n = len(x)
        b = next_bucket(n)
        if b > n:
            x = np.concatenate([x, np.repeat(x[-1:], b - n, axis=0)])
        return decoder.generate(x, gen)[:n]
    return tick


def _k1_counts(launches):
    """K1's launches in a run's counts, in total and by route, and K2-K4's
    (which the serving paths never launch)."""
    from hetu_tpu_torch.ops import flash_attention as fa
    return {key: launches.get(key, 0) for key in (
        fa.K1, f"{fa.K1}.simt", f"{fa.K1}.tc", fa.K2, fa.K3, fa.K4)}


def _check_k1_path(name, launches, n):
    """A serving path's launches: K1 ``n`` times, all on ``simt``, and no
    K2-K4."""
    from hetu_tpu_torch.ops import flash_attention as fa
    want = {fa.K1: n, f"{fa.K1}.simt": n, f"{fa.K1}.tc": 0, fa.K2: 0,
            fa.K3: 0, fa.K4: 0}
    got = _k1_counts(launches)
    if n <= 0 or got != want:
        raise AssertionError(f"serve_dense {name} launches {got}, want "
                             f"{want}")
    return got


def serve_dense(torch, seed, card):
    """GPT-2-small (f32) through the request-level plane: an
    InferenceSession restored from an Executor.save checkpoint; two
    GPTDecoders built from_session (sharing its tensors) behind two
    MicroBatchers, a ReplicaRouter and the HTTP frontend; 16 closed-loop
    clients x 4 requests after an untimed warm pass over every batch
    bucket. K1 runs on two main paths, each counted from 0: the decoders'
    prefill under the HTTP traffic (B in {1, 2, 4, 8}, S=256) and the
    session's graph forward under the no-cache recompute (B=8, S=1024).
    Then the parity checks, the prefill and decode-step times, and one
    profiled tick. Returns (line, {path: launch counts})."""
    import tempfile

    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import attention as attn
    from hetu_tpu_torch.ops import flash_attention as fa
    from hetu_tpu_torch.serving import (GPTDecoder, InferenceSession,
                                        MicroBatcher, ReplicaRouter,
                                        ServingHTTPServer)

    torch.cuda.reset_peak_memory_stats()
    cfg = M.GPTConfig(**GPT2_SMALL, hidden_dropout_prob=0.0,
                      use_flash_attention=True)
    ids = ht.Variable("input_ids", trainable=False)
    logits = M.GPTLMHeadModel(cfg)(ids)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        ht.Executor([logits], seed=seed).save(ckpt)
        # another seed: only the checkpoint gives the session its weights
        sess = InferenceSession([logits], checkpoint=ckpt, seed=seed + 1,
                                seq_buckets=(DENSE_SEQ_BUCKET,))
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    shared = {t.data_ptr() for t in sess.params_by_name().values()}
    decs = [GPTDecoder.from_session(sess, cfg,
                                    prompt_buckets=(DENSE_PROMPT_BUCKET,))
            for _ in range(2)]
    for dec in decs:
        # every decoder parameter is one of the session's tensors (the
        # session also holds the graph's position ids)
        if not all(t.data_ptr() in shared for t in _tensors(dec.params)):
            raise AssertionError("GPTDecoder.from_session does not share "
                                 "the session's tensors")
    dec = decs[0]

    rng = np.random.default_rng(seed)
    n_req = DENSE_CLIENTS * DENSE_PER_CLIENT
    pb = DENSE_PROMPT_BUCKET
    prompts = np.stack([
        np.pad(rng.integers(0, cfg.vocab_size, int(n)), (0, pb - int(n)),
               mode="edge")
        for n in rng.integers(16, pb + 1, n_req)])  # the client's padding
    x8 = prompts[:DENSE_MAX_BATCH]

    # the untimed warm pass, on this thread before any server thread
    # launches: every batch bucket on both decoders
    for d in decs:
        b = 1
        while b <= DENSE_MAX_BATCH:
            d.generate(prompts[:b], 2)
            b *= 2
    torch.cuda.synchronize()

    batchers = [MicroBatcher(_dense_tick(d),
                             max_batch_size=DENSE_MAX_BATCH,
                             max_wait_ms=DENSE_MAX_WAIT_MS,
                             name=f"replica{i}") for i, d in enumerate(decs)]
    router = ReplicaRouter(batchers)
    srv = ServingHTTPServer(router, host="127.0.0.1")
    try:
        port = srv.start()
        _build.reset_launch_counts()                # prefill path starts
        t0 = time.perf_counter()
        got, latency = _http_clients(port, prompts, MAX_NEW)
        wall = time.perf_counter() - t0
        prefill_counts = dict(_build.launch_counts)  # prefill path ends
        stats = router.stats()["replicas"]
        # one request alone (a tick of one): its tokens against a direct
        # generate of the same prompt
        lone = np.asarray(_post(port, prompts[:1].tolist(), MAX_NEW,
                                "dense-alone")["outputs"][0])
    finally:
        srv.stop()
        for mb in batchers:
            mb.close()
    ticks = sum(r["replica"]["ticks"] for r in stats)
    rows = sum(r["replica"]["rows"] for r in stats)
    routed = [r["routed"] for r in stats]
    for i in range(n_req):
        tok = got[i]
        if tok.shape != (1, MAX_NEW) or tok.min() < 0 or \
                tok.max() >= cfg.vocab_size:
            raise AssertionError(f"serve_dense request {i}: bad tokens {tok}")
    if rows != n_req or sum(routed) != n_req or min(routed) <= 0:
        raise AssertionError(f"serve_dense routed {routed}, {rows} rows in "
                             f"{ticks} ticks for {n_req} requests")
    prefill_launches = _check_k1_path("prefill", prefill_counts,
                                      cfg.num_hidden_layers * ticks)
    direct = dec.generate(prompts[:1], MAX_NEW)
    if not np.array_equal(lone, direct):
        raise AssertionError(f"serve_dense: HTTP tokens {lone.tolist()} "
                             f"!= direct generate {direct.tolist()}")
    # eight of the timed requests, spread over the clients, generated
    # again in one batch of 8: each HTTP reply (served in a tick with
    # other rows and padding) equals its row, and each row the argmax of
    # one teacher-forced session forward over it, up to the row's first
    # top-2 logit gap under MARGIN_TOL
    picked = np.linspace(0, n_req - 1, DENSE_MAX_BATCH).astype(int)
    batch = dec.generate(prompts[picked], MAX_NEW)
    batch_tf = sess.predict({ids: np.concatenate(
        [prompts[picked], batch[:, :-1]], axis=1)})[0][:, pb - 1:]
    batch_checked = []
    for row, i in enumerate(picked):
        tf_row, n_ok, _ = _margin_checked(batch_tf[row])
        if not (np.array_equal(got[i][0, :n_ok], batch[row, :n_ok])
                and np.array_equal(batch[row, :n_ok], tf_row[:n_ok])):
            raise AssertionError(
                f"serve_dense request {i}: HTTP tokens {got[i].tolist()}, "
                f"batch-of-8 generate {batch[row].tolist()}, teacher-"
                f"forced {tf_row.tolist()} (first {n_ok} checked)")
        batch_checked.append(n_ok)
    del batch_tf

    # the decode step at B=8 (bench.py:1245-1252) and the prefill of a
    # full tick
    prefill_ms = median_ms(torch, lambda: dec.prefill(x8))
    _, kv = dec.prefill(x8)
    tok = torch.as_tensor(x8[:, -1], device=dec.device)
    step_ms = []
    for t in range(DENSE_DECODE_STEPS):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        last, kv = dec.decode_step(kv, tok, pb + t)
        tok = last.argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
    del kv, last

    # the no-cache recompute through the session (bench.py:1233-1242):
    # K1's second path
    sess.predict({ids: x8})                         # untimed warm call
    _build.reset_launch_counts()                    # session path starts
    cur = x8
    t0 = time.perf_counter()
    for _ in range(DENSE_NO_CACHE_STEPS):
        full = sess.predict({ids: cur})[0]
        cur = np.concatenate([cur, full[:, -1].argmax(-1)[:, None]], axis=1)
        del full                        # [8, S, V] f32 on the host
    no_cache_s = time.perf_counter() - t0
    session_counts = dict(_build.launch_counts)     # session path ends
    session_launches = _check_k1_path(
        "session", session_counts,
        cfg.num_hidden_layers * DENSE_NO_CACHE_STEPS)

    # the cached chain against the no-cache one: one teacher-forced
    # forward over the prompt and the generated tokens gives every
    # step's no-cache logits (the chains share their inputs up to the
    # first disagreement)
    chain = np.concatenate([prompts[0], lone[0, :-1]])[None]
    tf_tokens, checked, min_margin = _margin_checked(
        sess.predict({ids: chain})[0][0, pb - 1:])
    # K1 swapped for its plain version: the decoder's tokens, and the
    # session's logits at B=8 over inputs that fill the 1024 bucket, so
    # every query row of K1 reaches the compared logits
    x_full = rng.integers(0, cfg.vocab_size, (DENSE_MAX_BATCH,
                                               DENSE_SEQ_BUCKET))
    logits_k1 = sess.predict({ids: x_full})[0]
    kernel_fa = attn.flash_attention
    attn.flash_attention = fa.flash_attention_plain
    try:
        plain_tokens = dec.generate(prompts[:1], MAX_NEW)
        logits_plain = sess.predict({ids: x_full})[0]
    finally:
        attn.flash_attention = kernel_fa
    logit_err = float(np.abs(logits_k1 - logits_plain).max())
    logits_ok = bool(np.allclose(logits_k1, logits_plain,
                                 atol=DENSE_LOGIT_TOL, rtol=DENSE_LOGIT_TOL))
    logit_scale = float(np.abs(logits_plain).max())
    del logits_k1, logits_plain
    parity = {"http_equals_direct_generate": True,
              "http_equals_batch_generate": True,
              "batch_requests": picked.tolist(),
              "batch_positions_checked": batch_checked,
              "positions_checked": checked, "min_margin": min_margin,
              "margin_tol": MARGIN_TOL,
              "cached_equals_no_cache": bool(np.array_equal(
                  lone[0, :checked], tf_tokens[:checked])),
              "plain_k1_decoder_equal": bool(np.array_equal(
                  lone[0, :checked], plain_tokens[0, :checked])),
              "plain_k1_decoder_all_equal": bool(np.array_equal(
                  lone, plain_tokens)),
              "session_logits_max_abs_err": logit_err,
              "session_logits_max_abs": logit_scale,
              "session_logits_tol": DENSE_LOGIT_TOL,
              "session_logits_ok": logits_ok}
    if not (parity["cached_equals_no_cache"]
            and parity["plain_k1_decoder_equal"] and logits_ok):
        raise AssertionError(f"serve_dense parity failed: {parity}; "
                             f"cached {lone.tolist()}, no-cache "
                             f"{tf_tokens.tolist()}, plain K1 "
                             f"{plain_tokens.tolist()}")

    tick = _dense_tick(dec)
    profile = profile_window(torch, lambda: tick(
        {"ids": x8, "gen": np.full((len(x8), 1), MAX_NEW)}))
    peak = torch.cuda.max_memory_allocated()
    sess.close()
    del sess, decs, dec
    torch.cuda.empty_cache()
    tokens = n_req * MAX_NEW
    line = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "dtype": "float32", "seed": seed,
            "stack": "HTTP -> ReplicaRouter -> 2 x MicroBatcher -> "
                     "GPTDecoder.from_session(InferenceSession)",
            "setup_s": setup_s, "clients": DENSE_CLIENTS,
            "requests_per_client": DENSE_PER_CLIENT,
            "prompt_tokens": [16, pb], "prompt_bucket": pb,
            "seq_bucket": DENSE_SEQ_BUCKET, "max_new_tokens": MAX_NEW,
            "max_batch_size": DENSE_MAX_BATCH,
            "max_wait_ms": DENSE_MAX_WAIT_MS,
            "requests": n_req, "wall_s": wall,
            "requests_per_s": n_req / wall, "tokens_per_s": tokens / wall,
            "latency_ms_p50": float(np.percentile(latency, 50)),
            "latency_ms_p95": float(np.percentile(latency, 95)),
            "ticks": ticks, "rows": rows,
            "mean_batch_occupancy": rows / (ticks * DENSE_MAX_BATCH),
            "routed_per_replica": routed,
            "prefill_ms_b8_p256": prefill_ms,
            "decode_step_ms_p50": float(np.median(step_ms)),
            "decode_step_ms": step_ms,
            "no_cache_tokens_per_s":
                DENSE_NO_CACHE_STEPS * len(x8) / no_cache_s,
            "k1_launches": {"prefill": prefill_launches,
                            "session": session_launches},
            "parity": parity, "profile_tick_b8": profile,
            "peak_memory_bytes": int(peak)}
    return line, {"prefill": prefill_counts, "session": session_counts}


# ---------------------------------------------------------------------------
# PS and Hybrid (bench.py:400-590, :881-935): WDL at Criteo widths on a
# 1,000,000 x 128 table held by the port's C++ parameter server on the
# host, one server and one worker
# ---------------------------------------------------------------------------

PS_BLOCK = 100              # run_batches block; also cache_bound, the drain
PS_PARITY_BLOCKS = 2        # blocks held against the CPU twin
PS_TIMED_BLOCKS = 3
PS_HOST_WARMUP = 10         # host path: run() steps before the timed ones
PS_HOST_BLOCK = 20          # host path: steps a block of run_batches_stream
PS_HOST_BLOCKS = 3
PS_SERVE_REQUESTS = 50      # predict calls of CTR_BATCH rows
PS_SERVE_CACHE_ROWS = 100_000
PS_SERVE_CHECKED = 5        # requests held against the dense-table session
PS_LOSS_TOL = 1e-5          # card losses against the CPU twin's, relative
PS_ROW_TOL = 1e-4           # server rows after drain(), of the largest
PS_SERVE_TOL = 1e-5         # PS session against the dense one, relative
PS_ID_BASE = 1 << 40        # node ids of the twin graphs (ps_node_ids)
PS_ID_BSP = PS_ID_BASE + (1 << 30)  # hybrid_fleet's BSP session's


@contextlib.contextmanager
def ps_server():
    """A fresh server of the port on localhost and the port's client on
    it (set as the default client); yields (client, server process).
    The server and the client's connection are gone afterwards."""
    from hetu_tpu_torch.ps import client as ps_client
    from hetu_tpu_torch.ps import server as ps_srv
    port = ps_srv.pick_free_port()
    try:
        proc = ps_srv.ensure_server(port=port, nworkers=1, wait_s=120)
        client = ps_client.PSClient(hosts="127.0.0.1", ports=str(port),
                                    rank=0, nworkers=1)
        ps_client.set_default_client(client)
        try:
            yield client, proc
        finally:
            client.shutdown_servers()
            ps_client.close_default_client()
    finally:
        ps_srv.shutdown_server()


@contextlib.contextmanager
def ps_node_ids(base):
    """Graph nodes numbered from ``base``: a server draws a table seeded
    by its tensor id (the table's node id), so two builds of one graph
    — the card's and its CPU twin — draw the same table only when their
    nodes are numbered alike. The counter resumes afterwards."""
    from hetu_tpu_torch.graph import node
    saved, node.G_NODE_ID = node.G_NODE_ID, base
    try:
        yield
    finally:
        node.G_NODE_ID = saved


def ps_wdl_graph(ht):
    nodes = [ht.Variable(n, trainable=False)
             for n in ("dense_input", "sparse_input", "y_")]
    loss, y, _, train_op = ht.models.wdl_criteo(*nodes,
                                                feature_dimension=CTR_ROWS)
    return nodes, loss, y, train_op


def _ps_block(nodes, traffic, i0, n):
    return [dict(zip(nodes, traffic[(i0 + j) % SPARSE_CYCLE]))
            for j in range(n)]


def _step_losses(outs):
    return [float(o[0].asnumpy().reshape(-1)[0]) for o in outs]


def _rss_bytes(pid):
    with open(f"/proc/{pid}/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")


def _phase_ms(rt, steps):
    """PSRuntime.phase_breakdown() in ms a step, and the cache counters."""
    times = rt.phase_breakdown()
    perf = times.pop("cache_perf", {})
    return {k: v * 1e3 / steps for k, v in times.items()}, perf


def _block_events(torch, exe, feeds):
    """One run_batches block timed by CUDA events: the host's time to
    queue it (``queue_ms``) against the device's span from its first
    queued work to its last (``device_span_ms``) and the wall time to
    the last loss's readback."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    outs = exe.run_batches(feeds)
    t1 = time.perf_counter()
    end.record()
    outs[-1][0].asnumpy()
    return {"steps": len(feeds), "queue_ms": (t1 - t0) * 1e3,
            "device_span_ms": start.elapsed_time(end),
            "wall_ms": (time.perf_counter() - t0) * 1e3}


def _touched_rows(exe, client):
    """(ids, server rows) of every id the device cache holds, read after
    a drain()."""
    rt = next(iter(exe.ps_runtime.device_tables.values()))
    ids = np.sort(rt.id_of[rt.id_of >= 0])
    return ids, client.sparse_pull(rt.tid, ids, rt.width)


def ps_wdl_run(torch, card, traffic, client, proc):
    """``ps_wdl``: bench.py:400-500's configuration on the card —
    comm_mode="PS", the device cache (cache_bound 100, bf16 drains), the
    dense weights on the unified HET path — through run_batches blocks
    of 100. The main path (launch counts set to 0 before, read after):
    PS_PARITY_BLOCKS blocks whose losses and drained server rows the CPU
    twin is held to, then PS_TIMED_BLOCKS timed blocks (samples/s, step
    ms, phase_breakdown a step, cache counters), then one block timed by
    CUDA events. Returns the line and what the twin is held to."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    rss_idle = _rss_bytes(proc.pid)             # the process, no tensor
    t0 = time.perf_counter()
    with ps_node_ids(PS_ID_BASE):
        nodes, loss, _, train_op = ps_wdl_graph(ht)
        exe = ht.Executor([loss, train_op], comm_mode="PS",
                          cstable_policy="Device", cache_bound=PS_BLOCK,
                          drain_compress=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rss_registered = _rss_bytes(proc.pid)
    rt = exe.ps_runtime
    dt = next(iter(rt.device_tables.values()))
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    parity_losses = []
    for b in range(PS_PARITY_BLOCKS):
        parity_losses += _step_losses(exe.run_batches(
            _ps_block(nodes, traffic, b * PS_BLOCK, PS_BLOCK)))
    rt.drain()
    ids, rows = _touched_rows(exe, client)
    rt.reset_phase_times()
    block_ms, losses = [], []
    for b in range(PS_TIMED_BLOCKS):
        feeds = _ps_block(nodes, traffic, (PS_PARITY_BLOCKS + b)
                          * PS_BLOCK, PS_BLOCK)
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = exe.run_batches(feeds)
        outs[-1][0].asnumpy()
        block_ms.append((time.perf_counter() - t) * 1e3)
        losses += _step_losses(outs)
    phases, perf = _phase_ms(rt, PS_TIMED_BLOCKS * PS_BLOCK)
    events = _block_events(torch, exe, _ps_block(nodes, traffic, 0,
                                                 PS_BLOCK))
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    peak = torch.cuda.max_memory_allocated()
    rt.drain()
    if not np.all(np.isfinite(parity_losses + losses)):
        raise AssertionError(f"ps_wdl losses not finite: {losses}")
    if any(launches.values()):
        raise AssertionError(f"ps_wdl launched flash kernels: {launches}")
    if not (dt.misses and dt.pushed_rows):
        raise AssertionError(f"ps_wdl cache never filled or drained: "
                             f"{dt.perf}")
    step_ms = [ms / PS_BLOCK for ms in block_ms]
    line = {"card": card, "model": "wdl_criteo", "batch": CTR_BATCH,
            "table_rows": CTR_ROWS, "width": int(dt.width),
            "comm_mode": "PS", "cstable_policy": "Device",
            "cache_bound": PS_BLOCK, "drain_compress": True,
            "cache_capacity": int(dt.capacity), "servers": 1, "workers": 1,
            "dense_on_het_path": len(exe.config.ps_dense_cached),
            "executor_setup_s": setup_s, "block_steps": PS_BLOCK,
            "timed_blocks": PS_TIMED_BLOCKS,
            "samples_per_s": CTR_BATCH * PS_BLOCK * PS_TIMED_BLOCKS
            / (sum(block_ms) / 1e3),
            "step_ms_p50": float(np.median(step_ms)), "step_ms": step_ms,
            "phase_ms_per_step": phases, "cache": perf,
            "block_events": events,
            "losses_first_last": [parity_losses[0], losses[-1]],
            "peak_memory_bytes": int(peak),
            "server_rss_bytes_idle": rss_idle,
            "server_rss_bytes_registered": rss_registered,
            "server_rss_bytes": _rss_bytes(proc.pid),
            "launches": launches}
    exe.close()
    del exe
    torch.cuda.empty_cache()
    return line, {"losses": parity_losses, "ids": ids, "rows": rows}


def ps_wdl_parity(torch, traffic, card_run):
    """The CPU twin of ps_wdl's first PS_PARITY_BLOCKS blocks: the same
    graph numbered alike (so its fresh server draws the same table), the
    same configuration and feeds on the port's CPU path; after drain()
    the server rows of every id the card's cache held. Losses held at
    PS_LOSS_TOL relative, rows at PS_ROW_TOL of the largest (SGD adds a
    row's gradients with atomics on the card, in no fixed order)."""
    import hetu_tpu_torch as ht
    t0 = time.perf_counter()
    with ps_server() as (client, _):
        with ps_node_ids(PS_ID_BASE):
            nodes, loss, _, train_op = ps_wdl_graph(ht)
            exe = ht.Executor([loss, train_op], comm_mode="PS",
                              cstable_policy="Device", cache_bound=PS_BLOCK,
                              drain_compress=True, device="cpu")
        losses = []
        for b in range(PS_PARITY_BLOCKS):
            losses += _step_losses(exe.run_batches(
                _ps_block(nodes, traffic, b * PS_BLOCK, PS_BLOCK)))
        exe.ps_runtime.drain()
        dt = next(iter(exe.ps_runtime.device_tables.values()))
        rows = client.sparse_pull(dt.tid, card_run["ids"], dt.width)
        exe.close()
    want, got = np.array(losses), np.array(card_run["losses"])
    parity = {"reference": "cpu float32, its own server",
              "steps": len(losses), "drains": PS_PARITY_BLOCKS,
              "loss_rel_err": float(np.max(np.abs(got - want)
                                           / np.abs(want))),
              "touched_rows": int(len(card_run["ids"])),
              "row_err_of_largest": _rel(card_run["rows"], rows),
              "loss_tol": PS_LOSS_TOL, "row_tol": PS_ROW_TOL,
              "seconds": time.perf_counter() - t0}
    if parity["loss_rel_err"] > PS_LOSS_TOL or \
            parity["row_err_of_largest"] > PS_ROW_TOL:
        raise AssertionError(f"ps_wdl parity, card against the CPU, "
                             f"failed: {parity}")
    return parity


def ps_wdl_host_run(torch, card, traffic, bsp):
    """One variant of ``ps_wdl_host`` (bench.py:515-590): no cache, every
    step pulls its rows from the server and pushes its gradients, ASP or
    BSP. PS_HOST_WARMUP run() steps, then the main path:
    PS_HOST_BLOCKS blocks of PS_HOST_BLOCK steps through
    run_batches_stream (the next steps' pull and feed transfer on the
    ingest worker). Returns the line, the executor and its graph."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    nodes, loss, y, train_op = ps_wdl_graph(ht)
    exe = ht.Executor({"train": [loss, train_op], "eval": [y]},
                      comm_mode="PS", bsp=bsp)
    for i in range(PS_HOST_WARMUP):
        exe.run("train", feed_dict=dict(zip(nodes, traffic[i])))[0].asnumpy()
    rt = exe.ps_runtime
    rt.reset_phase_times()
    exe.reset_ingest_stats()
    steps = PS_HOST_BLOCK * PS_HOST_BLOCKS
    _build.reset_launch_counts()                    # main path starts
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = exe.run_batches_stream(
        (_ps_block(nodes, traffic, PS_HOST_WARMUP + b * PS_HOST_BLOCK,
                   PS_HOST_BLOCK) for b in range(PS_HOST_BLOCKS)),
        name="train")
    outs[-1][0].asnumpy()
    seconds = time.perf_counter() - t
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    rt.drain()
    losses = _step_losses(outs)
    if not np.all(np.isfinite(losses)) or any(launches.values()):
        raise AssertionError(f"ps_wdl_host {'bsp' if bsp else 'asp'}: "
                             f"losses {losses}, launches {launches}")
    phases, _ = _phase_ms(rt, steps)
    line = {"mode": "BSP" if bsp else "ASP", "steps": steps,
            "samples_per_s": CTR_BATCH * steps / seconds,
            "step_ms": seconds * 1e3 / steps,
            "host_pull_ms": phases["host_pull"],
            "sync_push_ms": phases["sync_push"],
            "prefetch_ms": phases["prefetch"], "repull_ms": phases["repull"],
            "phase_ms_per_step": phases, "ingest": exe.ingest_stats(),
            "last_block_losses_first_last": [losses[0], losses[-1]],
            "launches": launches}
    return line, exe, (nodes, y)


def ps_serve_run(torch, card, traffic, exe, graph, client):
    """``ps_serve``: the host-path-trained WDL's eval graph rewritten by
    serve_embeddings_from_ps and served from an
    InferenceSession(comm_mode="PS") with a row cache of
    PS_SERVE_CACHE_ROWS rows (the dense weights are the trained ones).
    PS_SERVE_REQUESTS predicts of CTR_BATCH rows from the traffic, timed
    (the main path, launch counts set to 0 before and read after), then
    the first PS_SERVE_CHECKED held against the same session over a
    dense table on the card that holds the server's rows."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.graph.autodiff import find_topo_sort
    from hetu_tpu_torch.ndarray import NDArray
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.serving import (InferenceSession,
                                        serve_embeddings_from_ps)
    nodes, y = graph
    exe.ps_runtime.drain()
    dense = {exe._param_nodes[sid].name: NDArray(t).asnumpy()
             for sid, t in exe.params.items()}
    table = next(op.parameter for op in exe.config.ps_nodes
                 if op.parameter.is_embed)
    eval_nodes = [y]
    serve_embeddings_from_ps(eval_nodes)
    sess = InferenceSession(eval_nodes, comm_mode="PS",
                            embed_cache_rows=PS_SERVE_CACHE_ROWS)
    sess.executor.load_params(dense)
    feeds = [{nodes[0]: traffic[i][0], nodes[1]: traffic[i][1]}
             for i in range(SPARSE_CYCLE)]
    sess.predict(feeds[0])                          # warm-up
    sess.ps_client.hits = sess.ps_client.misses = 0
    _build.reset_launch_counts()                    # main path starts
    lat, preds = [], []
    t = time.perf_counter()
    for i in range(PS_SERVE_REQUESTS):
        t1 = time.perf_counter()
        preds.append(sess.predict(feeds[1 + i % (SPARSE_CYCLE - 1)])[0])
        lat.append((time.perf_counter() - t1) * 1e3)
    seconds = time.perf_counter() - t
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    hit_rate = sess.ps_client.hit_rate
    sess.close()
    # the same session over a dense table holding the server's rows
    rows = client.sparse_pull(table.id, np.arange(CTR_ROWS),
                              int(table.shape[1]))
    dnodes, _, dy, _ = ps_wdl_graph(ht)
    dtable = next(n for n in find_topo_sort([dy]) if n.name == table.name)
    dtable.initializer, dtable.tensor_value = None, rows
    dense_sess = InferenceSession([dy])
    dense_sess.executor.load_params(dense)
    err = 0.0
    for i in range(PS_SERVE_CHECKED):
        want = dense_sess.predict({dnodes[0]: traffic[1 + i][0],
                                   dnodes[1]: traffic[1 + i][1]})[0]
        err = max(err, float(np.abs(preds[i] - want).max()
                             / np.abs(want).max()))
    dense_sess.close()
    if err > PS_SERVE_TOL or any(launches.values()):
        raise AssertionError(f"ps_serve: error {err} against the dense "
                             f"table, launches {launches}")
    return {"card": card, "requests": PS_SERVE_REQUESTS,
            "rows_per_request": CTR_BATCH,
            "requests_per_s": PS_SERVE_REQUESTS / seconds,
            "latency_ms_p50": float(np.median(lat)),
            "embed_cache_rows": PS_SERVE_CACHE_ROWS,
            "lru_hit_rate": hit_rate, "launches": launches,
            "dense_table_rel_err": err, "tol": PS_SERVE_TOL,
            "checked_requests": PS_SERVE_CHECKED}


def hybrid_wdl_run(torch, card, traffic):
    """``hybrid_wdl`` (bench.py:881-935): comm_mode="Hybrid" — the dense
    weights in the step (allreduce, the identity at one worker), the
    table through the device cache (cache_bound 100, bf16 drains). One
    warm-up block, then PS_TIMED_BLOCKS timed ones: the main path."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    nodes, loss, _, train_op = ps_wdl_graph(ht)
    exe = ht.Executor([loss, train_op], comm_mode="Hybrid",
                      cstable_policy="Device", cache_bound=PS_BLOCK,
                      drain_compress=True)
    rt = exe.ps_runtime
    _build.reset_launch_counts()                    # main path starts
    exe.run_batches(_ps_block(nodes, traffic, 0, PS_BLOCK))[-1][0].asnumpy()
    rt.reset_phase_times()
    block_ms, losses = [], []
    for b in range(PS_TIMED_BLOCKS):
        feeds = _ps_block(nodes, traffic, (1 + b) * PS_BLOCK, PS_BLOCK)
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = exe.run_batches(feeds)
        outs[-1][0].asnumpy()
        block_ms.append((time.perf_counter() - t) * 1e3)
        losses += _step_losses(outs)
    launches = _k1_k4_launches(_build.launch_counts)    # main path ends
    phases, perf = _phase_ms(rt, PS_TIMED_BLOCKS * PS_BLOCK)
    if exe.config.ps_dense_cached or not np.all(np.isfinite(losses)) \
            or any(launches.values()):
        raise AssertionError(f"hybrid_wdl: dense on the PS "
                             f"{exe.config.ps_dense_cached}, losses "
                             f"{losses[:3]}, launches {launches}")
    exe.close()
    step_ms = [ms / PS_BLOCK for ms in block_ms]
    return {"card": card, "comm_mode": "Hybrid", "cstable_policy": "Device",
            "batch": CTR_BATCH, "table_rows": CTR_ROWS,
            "samples_per_s": CTR_BATCH * PS_BLOCK * PS_TIMED_BLOCKS
            / (sum(block_ms) / 1e3),
            "step_ms_p50": float(np.median(step_ms)), "step_ms": step_ms,
            "phase_ms_per_step": phases, "cache": perf,
            "losses_first_last": [losses[0], losses[-1]],
            "launches": launches}


def ps_passes(torch, card, seed):
    """The PS and Hybrid phases on one server (ps_wdl, ps_wdl_host,
    ps_serve, hybrid_wdl), then ps_wdl's CPU twin on a fresh server of
    its own."""
    traffic = sparse_traffic("wdl_criteo", seed)
    lines = {}
    t = time.perf_counter()
    with ps_server() as (client, proc):
        lines["ps_wdl"], card_run = ps_wdl_run(torch, card, traffic, client,
                                               proc)
        log(f"ps_wdl ({time.perf_counter() - t:.1f} s) {lines['ps_wdl']}")
        t = time.perf_counter()
        host = {}
        for bsp in (False, True):
            host["bsp" if bsp else "asp"], exe, graph = ps_wdl_host_run(
                torch, card, traffic, bsp)
            if not bsp:
                exe.close()
        lines["ps_wdl_host"] = {"card": card, **host}
        log(f"ps_wdl_host ({time.perf_counter() - t:.1f} s) "
            f"{lines['ps_wdl_host']}")
        t = time.perf_counter()
        lines["ps_serve"] = ps_serve_run(torch, card, traffic, exe, graph,
                                         client)
        exe.close()
        del exe
        torch.cuda.empty_cache()
        log(f"ps_serve ({time.perf_counter() - t:.1f} s) "
            f"{lines['ps_serve']}")
        t = time.perf_counter()
        lines["hybrid_wdl"] = hybrid_wdl_run(torch, card, traffic)
        torch.cuda.empty_cache()
        log(f"hybrid_wdl ({time.perf_counter() - t:.1f} s) "
            f"{lines['hybrid_wdl']}")
    t = time.perf_counter()
    lines["ps_wdl"]["parity"] = ps_wdl_parity(torch, traffic, card_run)
    log(f"ps_wdl parity ({time.perf_counter() - t:.1f} s) "
        f"{lines['ps_wdl']['parity']}")
    return lines


# ---------------------------------------------------------------------------
# ps_fleet: fleets of PS servers and workers started by the port's launcher
# (python hetu_tpu_torch/run_launcher.py), every worker on the one card
# ---------------------------------------------------------------------------

FLEETS = ((1, 1), (1, 2), (2, 2), (4, 4))   # (servers, workers), bench.py:633
FLEET_PARITY = (2, 2)       # the BSP fleet held against its CPU twin
FLEET_PARITY_STEPS = 50
FLEET_TIMEOUT_S = 300       # a fleet's launcher run, start to exit


def _listener_pids(ports):
    """{port: pid} of the processes listening on ``ports`` on this host
    (``/proc/net/tcp`` names each listening socket's inode; a process's
    ``fd`` links name the sockets it holds)."""
    inodes = {}
    for path in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(path) as f:
                lines = f.read().splitlines()[1:]
        except OSError:
            continue
        for line in lines:
            fields = line.split()
            port = int(fields[1].rsplit(":", 1)[1], 16)
            if fields[3] == "0A" and port in ports:      # LISTEN
                inodes[fields[9]] = port
    pids = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            continue
        for fd in fds:
            try:
                link = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if link.startswith("socket:[") and link[8:-1] in inodes:
                pids[inodes[link[8:-1]]] = int(pid)
    return pids


def _server_memory(pids):
    """{port: {"pid", "rss_bytes", "maps_libtorch"}} of the servers."""
    out = {}
    for port, pid in sorted(pids.items()):
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
        out[str(port)] = {"pid": pid, "rss_bytes": _rss_bytes(pid),
                          "maps_libtorch": "libtorch" in maps}
    return out


def _ps_table(exe):
    """(tensor id, width) of the PS embedding table of a WDL session."""
    rt = exe.ps_runtime
    if rt.device_tables:
        dt = next(iter(rt.device_tables.values()))
        return dt.tid, dt.width
    table = next(op.parameter for op in exe.config.ps_nodes
                 if op.parameter.is_embed)
    return table.id, int(table.shape[-1])


def fleet_worker(spec):
    """One worker process of a ps_fleet fleet, run by the launcher as
    ``python chip_smoke.py --fleet-worker SPEC``. ``spec["mode"]``:
    "cache" trains WDL through the device cache (ASP, cache_bound 100,
    bf16 drains) in run_batches blocks — one warm-up block, then a
    barrier, then PS_TIMED_BLOCKS timed ones; "bsp" trains it on the host
    path under BSP for FLEET_PARITY_STEPS run() steps. The worker of rank
    r draws bench.py's traffic from seed + r and runs on
    ``ht.rgpu("localhost", r)`` (``cuda:0`` on a one-card host) or, for
    the CPU twin, on the CPU. Rank 0 reads the servers' RSS and maps
    idle, registered and after training. Writes ``worker_<rank>.json``
    (and, under "bsp", ``rows_<rank>.npz``: the server rows of every id
    it touched, which the parity reads)."""
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ps.client import get_default_client
    rank = int(os.environ["HETU_PS_RANK"])
    cuda = spec["device"] == "cuda"
    client = get_default_client()
    ports = [int(p) for p in os.environ["HETU_PS_PORTS"].split(",")]
    servers = _listener_pids(set(ports)) if rank == 0 else {}
    if rank == 0 and len(servers) != len(ports):
        raise AssertionError(f"servers on {ports}: found {servers}")
    out = {"rank": rank, "device": spec["device"],
           "nworkers": client.nworkers, "nservers": client.nservers}
    client.barrier()
    if rank == 0:
        out["servers_idle"] = _server_memory(servers)
    traffic = sparse_traffic("wdl_criteo", spec["seed"] + rank)
    if spec["mode"] == "cache":
        options = dict(cstable_policy="Device", cache_bound=PS_BLOCK,
                       drain_compress=True)
    else:
        options = dict(bsp=True)
    ctx = ht.rgpu("localhost", rank) if cuda else ht.cpu(0)
    t0 = time.perf_counter()
    with ps_node_ids(PS_ID_BASE):
        nodes, loss, _, train_op = ps_wdl_graph(ht)
        exe = ht.Executor([loss, train_op], ctx=ctx, comm_mode="PS",
                          **options)
    out["executor_device"] = str(exe.config.device)
    out["executor_setup_s"] = time.perf_counter() - t0
    rt = exe.ps_runtime
    tid, width = _ps_table(exe)
    first_ids = np.unique(traffic[0][1])
    first_rows = client.sparse_pull(tid, first_ids, width)
    client.barrier()                        # every shard is registered
    if rank == 0:
        out["servers_registered"] = _server_memory(servers)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    if spec["mode"] == "cache":
        losses = _step_losses(exe.run_batches(
            _ps_block(nodes, traffic, 0, PS_BLOCK)))
        rt.reset_phase_times()
        client.barrier()                    # the timed windows start together
        block_ms = []
        out["window_start"] = time.time()
        for b in range(PS_TIMED_BLOCKS):
            t = time.perf_counter()
            outs = exe.run_batches(_ps_block(nodes, traffic,
                                             (1 + b) * PS_BLOCK, PS_BLOCK))
            outs[-1][0].asnumpy()
            block_ms.append((time.perf_counter() - t) * 1e3)
            losses += _step_losses(outs)
        out["window_end"] = time.time()
        steps = PS_BLOCK * PS_TIMED_BLOCKS
        out["step_ms"] = [ms / PS_BLOCK for ms in block_ms]
        out["step_ms_p50"] = float(np.median(out["step_ms"]))
        out["first_last_block_mean_loss"] = [
            float(np.mean(losses[:PS_BLOCK])),
            float(np.mean(losses[-PS_BLOCK:]))]
    else:
        steps = spec["steps"]
        losses = []
        out["window_start"] = time.time()
        for i in range(steps):
            losses.append(float(exe.run(feed_dict=dict(zip(
                nodes, traffic[i % SPARSE_CYCLE])))[0].asnumpy()
                .reshape(-1)[0]))
        out["window_end"] = time.time()
        out["losses"] = losses
    out["steps"] = steps
    out["phase_ms_per_step"], out["cache"] = _phase_ms(rt, steps)
    out["launches"] = _k1_k4_launches(_build.launch_counts)  # main path ends
    if cuda:
        out["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated())
    out["losses_finite"] = bool(np.all(np.isfinite(losses)))
    rt.drain()
    if rt.device_tables:
        dt = next(iter(rt.device_tables.values()))
        out["dirty_after_drain"] = int(dt.dirty.sum())
        out["refreshed_rows"] = int(dt.pulled_rows - dt.misses)
    client.barrier()                        # every worker's pushes landed
    out["first_rows_moved"] = float(np.abs(
        client.sparse_pull(tid, first_ids, width) - first_rows).max())
    if spec["mode"] == "bsp":
        ids = np.unique(np.concatenate([traffic[i % SPARSE_CYCLE][1].ravel()
                                        for i in range(steps)]))
        np.savez(os.path.join(spec["out"], f"rows_{rank}.npz"), ids=ids,
                 rows=client.sparse_pull(tid, ids, width))
    if rank == 0:
        out["servers_trained"] = _server_memory(servers)
    client.barrier()                # no worker leaves while others read
    exe.close()
    with open(os.path.join(spec["out"], f"worker_{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _card_memory_used_mib():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True)
    return float(out.stdout.split()[0])


def run_fleet(seed, servers, workers, mode, device,
              steps=FLEET_PARITY_STEPS, timeout=FLEET_TIMEOUT_S):
    """One fleet through ``python hetu_tpu_torch/run_launcher.py -c <yml>``
    with :func:`fleet_worker` as the workers' command. The launcher runs
    in a session of its own, killed whole (servers and workers with it)
    if it outlives ``timeout``; a launcher that exits non-zero (a fleet
    that did not come up, a worker that failed) raises with its log's
    tail. On the card, ``nvidia-smi``'s used memory is sampled while the
    fleet runs. The fleet's directory (its config, log and records) is
    removed when it is read. Returns (the workers' records by rank,
    info)."""
    import shutil
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="ps_fleet_")
    try:
        spec = {"mode": mode, "device": device, "seed": seed,
                "steps": steps, "out": out_dir}
        before = _card_memory_used_mib() if device == "cuda" else None
        wall, used = _launch_job(
            f"fleet ({servers} servers, {workers} workers, {mode}, "
            f"{device})", f"nodes:\n  - host: localhost\n"
            f"    servers: {servers}\n    workers: {workers}\n"
            f"    chief: true\n", "--fleet-worker", spec, timeout,
            device == "cuda")
        records = []
        for r in range(workers):
            with open(os.path.join(out_dir, f"worker_{r}.json")) as f:
                records.append(json.load(f))
            if mode == "bsp":
                with np.load(os.path.join(out_dir, f"rows_{r}.npz")) as z:
                    records[-1]["rows"] = (z["ids"], z["rows"])
        info = {"launcher_wall_s": wall,
                "card_memory_used_mib_before": before,
                "card_memory_used_mib_max": max(used) if used else None,
                "card_memory_samples": len(used)}
        return records, info
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _fleet_line(card, servers, workers, records, info):
    """The ps_fleet line of one device-cache fleet, after its checks:
    every loss finite, the workers' mean loss over their last blocks
    below their mean over their first blocks, no dirty row after
    drain(), the server rows moved, rows refreshed from the other
    workers' pushes at 2 workers or more, no server mapping libtorch,
    every worker on the card, K1-K4 0 launches. The loss is held for the
    fleet, not for each worker: bench.py's traffic gives each worker one
    fixed label vector of its own, so one worker's loss can rise under
    the others' updates while the fleet's falls (a rank at 4 workers did
    so on the H100)."""
    total = sum(CTR_BATCH * r["steps"] for r in records)
    windows = [r["window_end"] - r["window_start"] for r in records]
    span = max(r["window_end"] for r in records) \
        - min(r["window_start"] for r in records)
    lead = records[0]
    rss = {port: {"idle": lead["servers_idle"][port]["rss_bytes"],
                  "registered": lead["servers_registered"][port][
                      "rss_bytes"],
                  "trained": lead["servers_trained"][port]["rss_bytes"]}
           for port in lead["servers_idle"]}
    maps_torch = any(s[port]["maps_libtorch"]
                     for key in ("servers_idle", "servers_registered",
                                 "servers_trained")
                     for s in [lead[key]] for port in s)
    per_worker = [{k: r[k] for k in (
        "rank", "executor_device", "step_ms_p50", "step_ms",
        "phase_ms_per_step", "cache", "refreshed_rows",
        "peak_memory_bytes", "executor_setup_s",
        "first_last_block_mean_loss", "dirty_after_drain",
        "first_rows_moved", "launches")} for r in records]
    line = {"card": card, "servers": servers, "workers": workers,
            "model": "wdl_criteo", "batch": CTR_BATCH,
            "table_rows": CTR_ROWS, "cache_bound": PS_BLOCK,
            "drain_compress": True, "mode": "ASP",
            "timed_blocks": PS_TIMED_BLOCKS, "block_steps": PS_BLOCK,
            "samples_per_s": total / max(windows),
            "samples_per_s_over_span": total / span,
            "slowest_window_s": max(windows),
            "host_cores": len(os.sched_getaffinity(0)),
            "server_rss_bytes": rss, "servers_map_libtorch": maps_torch,
            **info, "per_worker": per_worker}
    first, last = np.mean([r["first_last_block_mean_loss"]
                           for r in records], axis=0)
    line["fleet_mean_loss_first_last_block"] = [float(first), float(last)]
    faults = []
    if maps_torch:
        faults.append("a server maps libtorch")
    if not last < first:
        faults.append(f"fleet mean loss {first} -> {last}")
    for r in records:
        if not r["losses_finite"]:
            faults.append(f"rank {r['rank']} losses not finite")
        if r["dirty_after_drain"] or not r["first_rows_moved"] > 0:
            faults.append(f"rank {r['rank']} dirty "
                          f"{r['dirty_after_drain']}, rows moved "
                          f"{r['first_rows_moved']}")
        if any(r["launches"].values()) or \
                not r["executor_device"].startswith("cuda"):
            faults.append(f"rank {r['rank']} on {r['executor_device']} "
                          f"launched {r['launches']}")
    if workers > 1 and not sum(r["refreshed_rows"] for r in records):
        faults.append("no row refreshed from the other workers' pushes")
    if faults:
        log(f"ps_fleet ({servers}, {workers}) failed: {line}")
        raise AssertionError(f"ps_fleet ({servers}, {workers}): {faults}")
    return line


def fleet_parity(seed):
    """The BSP fleet of FLEET_PARITY on the host path, FLEET_PARITY_STEPS
    steps with its workers on the card, against the same fleet with its
    workers on the CPU (same seeds, tables drawn alike by the servers):
    each rank's losses within PS_LOSS_TOL relative, the server rows of
    every id it touched within PS_ROW_TOL of their largest element. The
    twins run at once: their numbers are only compared, and the card's
    fleet shares the host with the CPU's (its samples/s is not
    ps_fleet's measure; FLEETS' are)."""
    from concurrent.futures import ThreadPoolExecutor
    servers, workers = FLEET_PARITY
    devices = ("cuda", "cpu")

    def twin(device):
        t = time.perf_counter()
        records, info = run_fleet(seed, servers, workers, "bsp", device)
        info["seconds"] = time.perf_counter() - t
        return records, info

    with ThreadPoolExecutor(len(devices)) as pool:
        runs = list(pool.map(twin, devices))
    out = {"servers": servers, "workers": workers, "mode": "BSP, host path",
           "steps": FLEET_PARITY_STEPS, "reference": "the same fleet, "
           "workers on the CPU", "loss_tol": PS_LOSS_TOL,
           "row_tol": PS_ROW_TOL, "ranks": []}
    for card_rec, cpu_rec in zip(runs[0][0], runs[1][0]):
        if not (card_rec["executor_device"].startswith("cuda")
                and cpu_rec["executor_device"] == "cpu"):
            raise AssertionError(
                f"ps_fleet parity: rank {card_rec['rank']} ran on "
                f"{card_rec['executor_device']} and "
                f"{cpu_rec['executor_device']}")
        got, want = np.array(card_rec["losses"]), np.array(cpu_rec["losses"])
        (ids, rows), (cids, crows) = card_rec["rows"], cpu_rec["rows"]
        if not np.array_equal(ids, cids):
            raise AssertionError("ps_fleet parity: the twins touched "
                                 "different ids")
        rank = {"rank": card_rec["rank"],
                "loss_rel_err": float(np.max(np.abs(got - want)
                                             / np.abs(want))),
                "touched_rows": int(len(ids)),
                "row_err_of_largest": _rel(rows, crows),
                "losses_first_last": [float(got[0]), float(got[-1])],
                "card_samples_per_s": CTR_BATCH * card_rec["steps"] / (
                    card_rec["window_end"] - card_rec["window_start"]),
                "launches": card_rec["launches"]}
        out["ranks"].append(rank)
        if rank["loss_rel_err"] > PS_LOSS_TOL or \
                rank["row_err_of_largest"] > PS_ROW_TOL or \
                any(rank["launches"].values()):
            raise AssertionError(f"ps_fleet parity failed: {rank}")
    out["seconds"] = {d: r[1]["seconds"] for d, r in zip(devices, runs)}
    return out


def ps_fleet_pass(card, seed):
    """``ps_fleet``: the device-cache fleets of FLEETS, then the BSP
    fleet's parity against its CPU twin."""
    fleets = []
    for servers, workers in FLEETS:
        t = time.perf_counter()
        records, info = run_fleet(seed, servers, workers, "cache", "cuda")
        fleets.append(_fleet_line(card, servers, workers, records, info))
        log(f"ps_fleet ({servers}, {workers}) "
            f"({time.perf_counter() - t:.1f} s) {fleets[-1]}")
    t = time.perf_counter()
    parity = fleet_parity(seed)
    log(f"ps_fleet parity ({time.perf_counter() - t:.1f} s) {parity}")
    return {"card": card, "fleets": fleets, "parity": parity}


# ---------------------------------------------------------------------------
# distgcn, distgcn_local: a 2-layer GCN through distgcn_15d_op on the gcn
# pass's graph at (gr, gc) = (2, 2), as four ranks of one launcher job and
# as four thread ranks of this process, all on the one card
# ---------------------------------------------------------------------------

DISTGCN_MESH = {"gr": 2, "gc": 2}
DISTGCN_RANKS = 4
DISTGCN_LR = 0.1
DISTGCN_WARMUP, DISTGCN_EPOCHS = 1, 3
DISTGCN_TIMEOUT_S = 300
# step 1 against the one-process csrmm_op GCN on the same weights: the
# loss relative, each weight's gradient of its largest element; the SpMM
# alone against csrmm_op at F=128; the weights across the four ranks
# after the timed epochs, of their largest element; distgcn_local's
# losses against the job's, relative (both reduce through gloo on the
# host in one order, so bit-equal is expected)
DISTGCN_LOSS_TOL = 1e-5
DISTGCN_GRAD_TOL = 1e-4
DISTGCN_SPMM_TOL = 1e-5
DISTGCN_SAME_TOL = 1e-6
DISTGCN_LOCAL_TOL = 1e-6


def _distgcn_weights(seed):
    """W1 [128, 256] and W2 [256, 40], Glorot-scaled normals from
    ``seed``."""
    rng = np.random.RandomState(seed + 17)
    dims = (GNN_FEATURES, GNN_HIDDEN, GNN_CLASSES)
    return [(rng.randn(a, b) * np.sqrt(2.0 / (a + b))).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])]


def _distgcn_graph(ht, weights, dist):
    """tests/test_distgcn.py's 2-layer GCN at the gcn pass's widths:
    distgcn_15d_op layers (``dist``) or csrmm_op ones in the same order
    of products (the op's rule: the SpMM first where W widens the
    features, 128 -> 256; W first where it narrows them, 256 -> 40).
    Returns (feed nodes, loss, train op, the first ReLU's input)."""
    feat = ht.Variable("feat", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    adj = ht.Variable("adj", trainable=False)
    w1 = ht.Variable("gcn_w1", value=weights[0])
    w2 = ht.Variable("gcn_w2", value=weights[1])
    if dist:
        pre = ht.distgcn_15d_op(adj, feat, w1)
        logits = ht.distgcn_15d_op(adj, ht.relu_op(pre), w2)
    else:
        pre = ht.matmul_op(ht.csrmm_op(adj, feat), w1)
        logits = ht.csrmm_op(adj, ht.matmul_op(ht.relu_op(pre), w2))
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    return (feat, y_, adj), loss, ht.optim.SGDOptimizer(
        DISTGCN_LR).minimize(loss), pre


def _distgcn_step1(exe, feeds, train_op):
    """Step 1 of the "step1" subgraph ([loss, every gradient, the first
    ReLU's input, train op]): the loss, the gradients by parameter name
    and the ReLU's input."""
    out = exe.run("step1", feed_dict=feeds)
    names = [p.name for p in train_op.optimizer.params]
    return float(out[0].asnumpy()), {
        n: g.asnumpy() for n, g in zip(names, out[1:-2])}, \
        out[-2].asnumpy()


def _distgcn_train(torch, exe, feeds, train_op, comms):
    """Step 1 (gradients fetched), then DISTGCN_WARMUP + DISTGCN_EPOCHS
    epochs, each ending in the loss's readback; ``comms`` (GroupComms)
    count the timed epochs' collectives alone. (On the CPU, as a
    rehearsal runs it, the synchronize is a no-op.)"""
    loss1, grads, pre = _distgcn_step1(exe, feeds, train_op)
    losses, epoch_ms = [loss1], []
    for i in range(DISTGCN_WARMUP + DISTGCN_EPOCHS):
        if i == DISTGCN_WARMUP:
            for comm in comms:
                comm.reset_stats()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(exe.run("train", feed_dict=feeds)[0].asnumpy()))
        epoch_ms.append((time.perf_counter() - t) * 1e3)
    return losses, epoch_ms, grads, pre


def _distgcn_session(ht, seed, graph, mesh, device):
    """The distributed GCN's executor over ``mesh`` (a rank's mesh in a
    job, or a LocalMesh) and its feeds: the partition and the features
    and labels on the card."""
    import torch
    from hetu_tpu_torch.parallel.distgcn import partition_csr_15d
    adj, feat, y, _ = graph
    nodes, loss, train_op, pre = _distgcn_graph(
        ht, _distgcn_weights(seed), True)
    exe = ht.Executor({"step1": [loss, *train_op.inputs, pre, train_op],
                       "train": [loss, train_op]}, mesh=mesh, device=device)
    part = partition_csr_15d(adj, DISTGCN_MESH["gr"], DISTGCN_MESH["gc"])
    feeds = dict(zip(nodes, (torch.from_numpy(feat).to(device),
                             torch.from_numpy(y).to(device), part)))
    return exe, feeds, train_op


def _merged_stats(comms):
    """The counters of several GroupComms summed by kind."""
    out = {}
    for comm in comms:
        for kind, st in comm.stats.items():
            out[kind] = {k: out.get(kind, {}).get(k, 0) + v
                         for k, v in st.items()}
    return out


def _distgcn_comm(stats, epochs):
    """The gcn epoch's collectives by kind: ring hops (the gr group's
    ``ring``), the gc sums (``reduce``), the gr gathers (``gather``)."""
    return {kind: _comm_per_step({kind: stats[kind]}, epochs)[kind]
            for kind in ("ring", "reduce", "gather")}


def distgcn_worker(spec):
    """One rank of ``distgcn``, run by the launcher as ``python
    chip_smoke.py --distgcn-worker SPEC`` (``spmd: true``: one job of four
    processes): the rank's (gr, gc) mesh over the job, the graph
    partitioned, step 1 with the gradients fetched, the timed epochs, its
    collectives a timed epoch by kind, ``dist_gcn_spmm`` alone against
    csrmm_op at F=128; writes ``worker_<rank>.json`` and its weights."""
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.executor import maybe_init_distributed
    from hetu_tpu_torch.ndarray import CSRValue
    from hetu_tpu_torch.ops.sparse import _csr_product
    from hetu_tpu_torch.parallel.distgcn import dist_gcn_spmm
    rank = int(os.environ["RANK"])
    device = spec["device"]
    maybe_init_distributed(device)
    mesh = ht.parallel.build_mesh(DISTGCN_MESH)
    graph = gnn_graph(spec["nodes"])
    t0 = time.perf_counter()
    exe, feeds, train_op = _distgcn_session(ht, spec["seed"], graph, mesh,
                                            device)
    rec = {"rank": rank, "coords": [mesh.coord("gr"), mesh.coord("gc")],
           "setup_s": time.perf_counter() - t0,
           "device": str(exe.config.device)}
    comms = [mesh.comm(axis) for axis in ("gr", "gc")]
    for comm in comms:
        comm.sync_timing = True
    losses, epoch_ms, grads, pre = _distgcn_train(torch, exe, feeds,
                                                  train_op, comms)
    rec.update(losses=losses, epoch_ms=epoch_ms,
               comm_per_epoch=_distgcn_comm(_merged_stats(comms),
                                            DISTGCN_EPOCHS),
               peak_memory_bytes=int(torch.cuda.max_memory_allocated())
               if device == "cuda" else None)
    if rank == 0:
        # the first ReLU's decisions, which the one-process reference
        # takes (an input within rounding of 0 may fall either way)
        np.save(os.path.join(spec["out"], "relu_mask.npy"),
                np.packbits(pre > 0))
    adj, feat, _, _ = graph
    h = torch.from_numpy(feat).to(device)
    csr = CSRValue.from_sparse_array(ht.ND_Sparse_Array(
        adj.data.astype(np.float32), adj.indptr.astype(np.int32),
        adj.indices.astype(np.int32), nrow=adj.shape[0],
        ncol=adj.shape[1]), device)
    want = _csr_product(csr, h, False)
    got = dist_gcn_spmm(feeds[list(feeds)[2]], h, mesh)
    rec["spmm_rel_err"] = float((got - want).abs().max()
                                / want.abs().max())
    np.savez(os.path.join(spec["out"], f"weights_{rank}.npz"),
             **{exe._param_nodes[sid].name: v.cpu().numpy()
                for sid, v in exe.params.items()})
    np.savez(os.path.join(spec["out"], f"grads_{rank}.npz"), **grads)
    with open(os.path.join(spec["out"], f"worker_{rank}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def _rel_to_max(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def _distgcn_reference(torch, seed, graph, mask, device):
    """Step 1 of the one-process csrmm_op GCN on the card at distgcn's
    weights, its first ReLU taking the decisions ``mask`` (np.packbits of
    the job's ReLU input > 0), as gnn_parity does for the CPU twin.
    Returns (loss, gradients by name, a record: seconds, the ReLU inputs
    whose own sign differs from the mask, the largest |x| among them)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.graph.autodiff import find_topo_sort
    from hetu_tpu_torch.ops.activations import ReluGradientOp, ReluOp
    t = time.perf_counter()
    nodes, loss, train_op, pre = _distgcn_graph(
        ht, _distgcn_weights(seed), False)
    n = graph[0].shape[0] * GNN_HIDDEN
    decide = torch.from_numpy(np.unpackbits(mask)[:n].astype(bool)
                              .reshape(-1, GNN_HIDDEN)).to(device)
    for node in find_topo_sort([train_op]):
        if isinstance(node, (ReluOp, ReluGradientOp)):
            _relu_by_mask(node, decide)
    exe = ht.Executor({"step1": [loss, *train_op.inputs, pre, train_op]},
                      device=device)
    feeds = _gnn_feeds(ht, graph, device)
    loss1, grads, x = _distgcn_step1(
        exe, dict(zip(nodes, (feeds[0], feeds[1], feeds[3]))), train_op)
    flips = (x > 0) != decide.cpu().numpy()
    del exe, feeds, decide
    _release(torch)
    return loss1, grads, {
        "reference_s": time.perf_counter() - t,
        "relu_flips": int(flips.sum()),
        "relu_flip_max_abs_input": float(np.abs(x[flips]).max())
        if flips.any() else 0.0}


def distgcn_pass(card, seed, graph, gcn_line, device="cuda"):
    """``distgcn`` and ``distgcn_local``. The reference first: the
    one-process csrmm_op GCN on the card at the same weights (step 1's
    loss and gradients). Then four ranks of one launcher job on the card
    (``--distgcn-worker``), then the same model as four thread ranks of
    this process (``mesh=`` a LocalMesh). The checks: each rank's step-1
    loss within DISTGCN_LOSS_TOL of the reference's and its W1, W2
    gradients within DISTGCN_GRAD_TOL of their largest element; every
    weight equal across the four ranks within DISTGCN_SAME_TOL after the
    timed epochs; ``dist_gcn_spmm`` alone against csrmm_op within
    DISTGCN_SPMM_TOL; losses finite; distgcn_local's losses against the
    job's within DISTGCN_LOCAL_TOL and its weights across its ranks as
    the job's. Returns {"distgcn": line, "distgcn_local": line}.
    ``device="cpu"`` rehearses it on the CPU (``GNN_NODES`` cut)."""
    import shutil
    import tempfile
    import torch
    import hetu_tpu_torch as ht
    out_dir = tempfile.mkdtemp(prefix="distgcn_job_")
    try:
        wall, used = _launch_job(
            "distgcn", f"spmd: true\nnodes:\n  - host: localhost\n"
            f"    workers: {DISTGCN_RANKS}\n    chief: true\n",
            "--distgcn-worker", {"seed": seed, "out": out_dir,
                                 "device": device,
                                 "nodes": int(graph[0].shape[0])},
            DISTGCN_TIMEOUT_S, device == "cuda")
        records, weights, grads = [], [], []
        for r in range(DISTGCN_RANKS):
            with open(os.path.join(out_dir, f"worker_{r}.json")) as f:
                records.append(json.load(f))
            weights.append(dict(np.load(os.path.join(
                out_dir, f"weights_{r}.npz"))))
            grads.append(dict(np.load(os.path.join(
                out_dir, f"grads_{r}.npz"))))
        mask = np.load(os.path.join(out_dir, "relu_mask.npy"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    ref_loss, ref_grads, ref = _distgcn_reference(torch, seed, graph, mask,
                                                  device)
    adj = graph[0]
    faults = []
    step1 = {"loss_rel_err": [], "grad_rel_err": []}
    for rec, g in zip(records, grads):
        err = abs(rec["losses"][0] - ref_loss) / abs(ref_loss)
        gerr = {n: _rel_to_max(g[n], ref_grads[n]) for n in ref_grads}
        step1["loss_rel_err"].append(err)
        step1["grad_rel_err"].append(gerr)
        if err > DISTGCN_LOSS_TOL or max(gerr.values()) > DISTGCN_GRAD_TOL:
            faults.append(f"rank {rec['rank']} step 1: loss {err}, "
                          f"gradients {gerr}")
        if rec["spmm_rel_err"] > DISTGCN_SPMM_TOL:
            faults.append(f"rank {rec['rank']} spmm {rec['spmm_rel_err']}")
        if not np.all(np.isfinite(rec["losses"])):
            faults.append(f"rank {rec['rank']} losses {rec['losses']}")
    same = max(_rel_to_max(w[n], weights[0][n]) for w in weights[1:]
               for n in weights[0])
    if same > DISTGCN_SAME_TOL:
        faults.append(f"weights across ranks {same}")
    losses = records[0]["losses"]
    if any(r["losses"] != losses for r in records):
        faults.append(f"losses differ across ranks "
                      f"{[r['losses'] for r in records]}")
    p50 = max(float(np.median(r["epoch_ms"][DISTGCN_WARMUP:]))
              for r in records)
    common = {"card": card, "model": "gcn (2 distgcn_15d_op layers)",
              "nodes": int(adj.shape[0]), "nnz": int(adj.nnz),
              "features": GNN_FEATURES, "hidden": GNN_HIDDEN,
              "classes": GNN_CLASSES, "mesh": DISTGCN_MESH,
              "dtype": "float32", "optimizer": "SGD", "lr": DISTGCN_LR,
              "warmup_epochs": DISTGCN_WARMUP,
              "timed_epochs": DISTGCN_EPOCHS,
              "gcn_epoch_ms_p50": gcn_line["epoch_ms_p50"]}
    line = {**common, "ranks": DISTGCN_RANKS, "backend": "gloo",
            "epoch_ms_p50": p50, "epoch_cost_vs_gcn":
            p50 / gcn_line["epoch_ms_p50"], "losses": losses,
            "reference": "one process, csrmm_op, the same weights and "
                         "order of products, the first ReLU deciding as "
                         "the job's rank 0", **ref,
            "reference_step1_loss": ref_loss,
            "step1": step1, "weights_rel_diff_across_ranks": same,
            "loss_tol": DISTGCN_LOSS_TOL, "grad_tol": DISTGCN_GRAD_TOL,
            "spmm_tol": DISTGCN_SPMM_TOL, "same_tol": DISTGCN_SAME_TOL,
            "launcher_wall_s": wall,
            "card_memory_used_mib_max": max(used) if used else None,
            "per_rank": [{k: r[k] for k in (
                "rank", "coords", "device", "setup_s", "epoch_ms",
                "comm_per_epoch", "peak_memory_bytes", "spmm_rel_err")}
                for r in records]}
    if faults:
        log(f"distgcn failed: {line}")
        raise AssertionError(f"distgcn: {faults}")

    t = time.perf_counter()
    mesh = ht.parallel.build_mesh(DISTGCN_MESH)
    exe, feeds, train_op = _distgcn_session(ht, seed, graph, mesh, device)
    setup_s = time.perf_counter() - t
    plan = exe.config.local_ranks
    comms = [[r.config.mesh.comm(axis) for axis in ("gr", "gc")]
             for r in exe.ranks]
    for comm in sum(comms, []):
        comm.sync_timing = True
    local_losses, epoch_ms, _, _ = _distgcn_train(
        torch, exe, feeds, train_op, sum(comms, []))
    stats = [_distgcn_comm(_merged_stats(c), DISTGCN_EPOCHS) for c in comms]
    rank_weights = [{r._param_nodes[sid].name: v.cpu().numpy()
                     for sid, v in r.params.items()} for r in exe.ranks]
    exe.close()
    del exe, feeds
    _release(torch)
    local_same = max(_rel_to_max(w[n], rank_weights[0][n])
                     for w in rank_weights[1:] for n in rank_weights[0])
    local_err = max(abs(a - b) / abs(b) for a, b in zip(local_losses,
                                                        losses))
    lp50 = float(np.median(epoch_ms[DISTGCN_WARMUP:]))
    local = {**common, "thread_ranks": plan.n,
             "devices": [str(d) for d in plan.devices],
             "epoch_ms_p50": lp50, "epoch_ms": epoch_ms,
             "job_epoch_ms_p50": p50, "setup_s": setup_s,
             "losses": local_losses, "job_losses": losses,
             "losses_rel_err_vs_job": local_err,
             "losses_bit_equal_to_job": local_losses == losses,
             "weights_rel_diff_across_ranks": local_same,
             "local_tol": DISTGCN_LOCAL_TOL,
             "comm_per_epoch_by_rank": stats}
    if local_err > DISTGCN_LOCAL_TOL or local_same > DISTGCN_SAME_TOL:
        log(f"distgcn_local failed: {local}")
        raise AssertionError(f"distgcn_local: losses {local_err}, weights "
                             f"across ranks {local_same}")
    return {"distgcn": line, "distgcn_local": local}


# ---------------------------------------------------------------------------
# dp_gpt_local: dp_gpt's model and rows under a tuple context of two
# devices and AllReduce in one process: two thread ranks on the one card
# ---------------------------------------------------------------------------

def dp_gpt_local(card, seed, train_line, dp_line):
    """``train``'s model at full width under ``ht.context((ht.gpu(0),
    ht.gpu(1)))`` with ``comm_mode="AllReduce"``, bf16, 25 MiB buckets:
    the executor runs two thread ranks (both on cuda:0), 4 of the 8 rows
    each. The launch counts set to 0 before the steps and read after, in
    each rank apart. The checks: K2/K3/K4 12 a step in each thread rank,
    all on tc, K1 none; the step-1 global loss against ``dp_gpt``'s
    launcher job within DP_LOSS_TOL; every weight the same on both ranks
    within DP_SAME_TOL of its largest element. Returns (line, the launch
    counts summed over the ranks)."""
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    with ht.context((ht.gpu(0), ht.gpu(1))):
        ids, labels, lm, train_op = _gpt_graph(ht, M, GPT2_SMALL)
        exe = ht.Executor([lm, train_op], dtype=torch.bfloat16,
                          comm_mode="AllReduce", overlap_options={
                              "bucket_bytes": DP_BUCKET_BYTES})
    setup_s = time.perf_counter() - t0
    plan = exe.config.local_ranks
    x, y = _gpt_rows(seed, TRAIN_BATCH)
    feeds = {ids: torch.as_tensor(x, device="cuda"),
             labels: torch.as_tensor(y, device="cuda")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()                    # main path starts
    losses, step_ms = [], []
    for _ in range(DP_WARMUP + DP_STEPS):
        t = time.perf_counter()
        losses.append(float(exe.run(feed_dict=feeds)[0].asnumpy()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    by_rank = {r: dict(c) for r, c in _build.rank_launch_counts.items()}
    launches = dict(_build.launch_counts)           # main path ends
    peak = int(torch.cuda.max_memory_allocated())
    states = [_master_state(r) for r in exe.ranks]
    same = max(float((states[1][n].float() - v.float()).abs().max()
                     / (v.float().abs().max() or 1.0))
               for n, v in states[0].items())
    comm = [r.config.dp_comm.stats for r in exe.ranks]
    exe.close()
    del exe, states, feeds
    _release(torch)
    steps = DP_WARMUP + DP_STEPS
    want = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,),
                         GPT2_SMALL["num_hidden_layers"] * steps)
    faults = []
    for r in range(plan.n):
        got = {k: by_rank.get(r, {}).get(k, 0) for k in want}
        if got != want:
            faults.append(f"thread rank {r} launched {got}")
    step1, dp1 = losses[0], dp_line["losses"][0]
    err = abs(step1 - dp1) / abs(dp1)
    if err > DP_LOSS_TOL or not all(np.isfinite(losses)):
        faults.append(f"losses {losses} against dp_gpt's step 1 {dp1}")
    if same > DP_SAME_TOL:
        faults.append(f"weights across ranks {same}")
    p50 = float(np.median(step_ms[DP_WARMUP:]))
    tokens = TRAIN_BATCH * GPT2_SMALL["max_position_embeddings"]
    line = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "context": "(gpu(0), gpu(1)), comm_mode AllReduce",
            "thread_ranks": plan.n, "devices": [str(d) for d in
                                                plan.devices],
            "global_batch": TRAIN_BATCH,
            "rows_per_rank": TRAIN_BATCH // plan.n, "dtype": "bfloat16",
            "bucket_bytes": DP_BUCKET_BYTES, "executor_setup_s": setup_s,
            "warmup_steps": DP_WARMUP, "timed_steps": DP_STEPS,
            "step_ms": step_ms, "step_ms_p50": p50,
            "tokens_per_s": tokens * DP_STEPS / (sum(step_ms[DP_WARMUP:])
                                                 / 1e3),
            "dp_gpt_step_ms_p50": dp_line["step_ms_p50"],
            "train_step_ms_p50": train_line["step_ms_p50"],
            "step_cost_vs_dp_gpt": p50 / dp_line["step_ms_p50"],
            "losses": losses, "dp_gpt_step1_loss": dp1,
            "step1_loss_rel_err": err, "loss_tol": DP_LOSS_TOL,
            "weights_rel_diff_across_ranks": same,
            "same_weights_tol": DP_SAME_TOL,
            "launches_per_step_by_rank": {
                r: {k: c.get(k, 0) / steps for k in
                    (fa.K1, fa.K2, fa.K3, fa.K4, f"{fa.K2}.tc",
                     f"{fa.K3}.tc", f"{fa.K4}.tc")}
                for r, c in by_rank.items()},
            "comm_per_step_by_rank": [_comm_per_step(c, steps)
                                      for c in comm],
            "peak_memory_bytes": peak}
    if faults:
        log(f"dp_gpt_local failed: {line}")
        raise AssertionError(f"dp_gpt_local: {faults}")
    return line, launches


# ---------------------------------------------------------------------------
# autoplan: the cost-model planner (parallel/autoplan.py) on the card
# ---------------------------------------------------------------------------

AUTOPLAN_RANKS = 2          # the world the phase plans for: thread ranks
AUTOPLAN_TOPK = 4           # finalists measured
AUTOPLAN_WARMUP, AUTOPLAN_STEPS = 1, 2    # a finalist's measured steps
AUTOPLAN_TRAIN_STEPS = 3    # the chosen plan's steps, each held to train's
# the comm sweep's sizes (the JAX package's ladder)
AUTOPLAN_SIZES = (1 << 14, 1 << 17, 1 << 20, 1 << 23)
# the launcher job's small GPT (2 ranks, --autoplan, then 2 steps); S=512
# so training takes the fused K2-K4
AUTOPLAN_JOB_WIDTHS = dict(vocab_size=4096, hidden_size=256,
                           num_hidden_layers=2, num_attention_heads=4,
                           max_position_embeddings=512)
AUTOPLAN_JOB_BATCH = 8
AUTOPLAN_JOB_STEPS = 2
AUTOPLAN_JOB_TIMEOUT_S = 240


def _autoplan_feeds(torch, ids, labels, seed, widths=GPT2_SMALL,
                    batch=TRAIN_BATCH, device="cuda"):
    """train's rows (its seed's ids and next-token labels) at ``widths``
    on ``device``, and their feed shapes."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, widths["vocab_size"],
                    (batch, widths["max_position_embeddings"]))
    y = np.concatenate([x[:, 1:], np.full((batch, 1), -1)], axis=1)
    return ({ids: torch.as_tensor(x, device=device),
             labels: torch.as_tensor(y, device=device)},
            {ids: (x.shape, np.int64), labels: (y.shape, np.int64)})


def _plan_loss_tols(plan, ref):
    """Each step's tolerance for the losses of a plan (``dp``, ``tp``,
    ``pp`` keys) against one process's ``ref`` losses on the same rows
    and weights, from the parity check of the plan's mode: (1, 1, 1) is
    one process's own path, one bf16 ulp at every step (check_pass);
    any split plan's loss is a mean of several bf16 losses (its ranks'
    or its microbatches') against one, DP_LOSS_TOL relative (dp_gpt's
    and tp_gpt's rule)."""
    if plan["dp"] == plan["tp"] == plan["pp"] == 1:
        return [_bf16_ulp(r) for r in ref]
    return [DP_LOSS_TOL * abs(r) for r in ref]


def _loss_faults(what, plan, losses, ref):
    """The faults of a plan's losses against ``ref`` (_plan_loss_tols),
    and that they are finite and fall; (faults, tolerances)."""
    tols = _plan_loss_tols(plan, ref)
    faults = []
    if not all(x is not None and np.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        faults.append(f"{what} losses {losses} not finite and falling")
    elif any(abs(x - r) > t for x, r, t in zip(losses, ref, tols)):
        faults.append(f"{what} losses {losses} against one process's "
                      f"{ref[:len(losses)]}, tolerances {tols}")
    return faults, tols


def _count_calls(module, name):
    """Count the calls of ``module.name`` until the returned function is
    called: it puts the function back and returns the count."""
    fn, calls = getattr(module, name), [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)

    def stop():
        setattr(module, name, fn)
        return calls[0]

    return stop


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _autoplan_steps(torch, exe, feeds, steps):
    """``steps`` steps; (losses, step ms), each step ended by a sync."""
    losses, step_ms = [], []
    for _ in range(steps):
        t = time.perf_counter()
        out = exe.run(feed_dict=feeds)
        losses.append(None if out[0] is None
                      else float(out[0].asnumpy()))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    return losses, step_ms


def _per_step(counts, steps, keys):
    return {k: counts.get(k, 0) / steps for k in keys}


def _autoplan_measure(torch, seed, finalists, device="cuda",
                      widths=GPT2_SMALL, batch=TRAIN_BATCH):
    """``measure(plan)`` for choose_plan: a new GPT-2-small graph, the
    plan applied (``plan_overrides``: its mesh of thread ranks on the
    card, or its stages), one warm-up and AUTOPLAN_STEPS timed steps on
    train's rows; seconds a step. Each finalist's record (or its error)
    goes to ``finalists``."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import flash_attention as fa
    from hetu_tpu_torch.parallel import autoplan

    keys = (fa.K1, fa.K2, fa.K3, fa.K4)

    def measure(plan):
        # keyed by the plan as applied: apply_plan may fold a collective
        # plan's virtual stages out (V -> 1), as the reference's does
        rec = {"plan": plan.describe()}
        exe = None
        try:
            ids, labels, lm, train_op = _gpt_graph(ht, M, widths)
            t0 = time.perf_counter()
            try:
                ov = autoplan.plan_overrides([lm, train_op], plan,
                                             device=device)
            finally:
                rec = finalists.setdefault(autoplan.plan_key(plan), rec)
                rec["applied"] = plan.describe()
            exe = ht.Executor([lm, train_op], dtype=torch.bfloat16,
                              device=device, **ov)
            rec["executor_setup_s"] = time.perf_counter() - t0
            rec["ranks"] = len(exe.ranks)
            feeds, _ = _autoplan_feeds(torch, ids, labels, seed, widths,
                                       batch, device)
            _build.reset_launch_counts()
            steps = AUTOPLAN_WARMUP + AUTOPLAN_STEPS
            losses, step_ms = _autoplan_steps(torch, exe, feeds, steps)
            rec["launches_per_step_by_rank"] = {
                r: _per_step(c, steps, keys)
                for r, c in _build.rank_launch_counts.items()} or {
                0: _per_step(_build.launch_counts, steps, keys)}
            rec.update(losses=losses, step_ms=step_ms)
            timed = step_ms[AUTOPLAN_WARMUP:]
            rec["measured_ms"] = float(np.mean(timed))
            return rec["measured_ms"] / 1e3
        except Exception as e:
            rec["error"] = f"{type(e).__name__}: {e}"[:400]
            raise
        finally:
            if exe is not None:
                exe.close()
            del exe
            _release(torch)

    return measure


def autoplan_worker(spec):
    """One rank of the autoplan phase's launcher job (and, under
    ``--autoplan``, the one preview process): the small GPT on the card,
    ``Executor(parallel="auto")`` over the phase's measured CostDB, then
    AUTOPLAN_JOB_STEPS steps; its plan, losses and launches to
    ``spec["out"]/rank<r>.json``."""
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import flash_attention as fa
    from hetu_tpu_torch.parallel import autoplan
    from hetu_tpu_torch.telemetry.costdb import CostDB
    rank = int(os.environ.get("RANK", "0"))
    widths = spec["widths"]
    ids, labels, lm, train_op = _gpt_graph(ht, M, widths)
    device = spec["device"]
    feeds, shapes = _autoplan_feeds(torch, ids, labels, spec["seed"],
                                    widths, spec["batch"], device)
    exe = ht.Executor([lm, train_op], dtype=torch.bfloat16,
                      device=None if device == "cuda" else device,
                      parallel="auto", autoplan_options={
                          "db": CostDB(spec["db"]), "feed_shapes": shapes,
                          "model": "gpt_job"})
    _build.reset_launch_counts()
    losses, step_ms = _autoplan_steps(torch, exe, feeds, spec["steps"])
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank,
                   "key": autoplan.plan_key(exe.config.autoplan.plan),
                   "nworld": exe.config.autoplan.nworld,
                   "idle": exe.config.idle, "losses": losses,
                   "step_ms": step_ms,
                   "launches": {k: _build.launch_counts.get(k, 0) for k in
                                (fa.K1, fa.K2, fa.K3, fa.K4)}}, f)
    exe.close()
    return 0


def _autoplan_job(seed, db_path, device="cuda"):
    """The launcher's ``--autoplan`` on a 2-rank ``spmd: true`` job (one
    preview process, its report) and, beside it, the job itself training
    the plan: (report, the ranks' records, seconds of each)."""
    import shutil
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="autoplan_job_")
    config = (f"spmd: true\nnodes:\n  - host: localhost\n"
              f"    workers: {AUTOPLAN_RANKS}\n    chief: true\n")
    spec = {"seed": seed, "out": out_dir, "db": db_path,
            "widths": AUTOPLAN_JOB_WIDTHS, "batch": AUTOPLAN_JOB_BATCH,
            "steps": AUTOPLAN_JOB_STEPS, "device": device}
    try:
        cfg = os.path.join(out_dir, "preview.yml")
        with open(cfg, "w") as f:
            f.write(config)
        env = {**os.environ, "HETU_PS_REPLICATE": "0",
               "PYTHONPATH": ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        t0 = time.perf_counter()
        logs = [open(os.path.join(out_dir, f"preview.{k}"), "w+")
                for k in ("out", "err")]
        proc = subprocess.Popen(
            [sys.executable, LAUNCHER, "-c", cfg, "--autoplan",
             sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--autoplan-worker", json.dumps(spec)],
            cwd=ROOT, env=env, stdout=logs[0], stderr=logs[1],
            stdin=subprocess.DEVNULL, start_new_session=True)
        try:
            job_s, _ = _launch_job("autoplan_job", config,
                                   "--autoplan-worker", spec,
                                   AUTOPLAN_JOB_TIMEOUT_S, False)
            proc.wait(timeout=AUTOPLAN_JOB_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
            texts = []
            for f in logs:
                f.seek(0)
                texts.append(f.read())
                f.close()
            out, err = texts
        preview_s = time.perf_counter() - t0
        marker = "autoplan: report written to "
        if proc.returncode != 0 or "autoplan: OK" not in out or \
                marker not in out:
            raise AssertionError(
                f"autoplan preview: exit {proc.returncode}\n"
                f"{out[-2000:]}\n{err[-2000:]}")
        path = out.split(marker)[1].split()[0]
        with open(path) as f:
            report = json.load(f)
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
        ranks = []
        for r in range(AUTOPLAN_RANKS):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return report, ranks, preview_s, job_s


def autoplan_pass(card, seed, train_line, device="cuda",
                  widths=GPT2_SMALL, batch=TRAIN_BATCH):
    """The cost-model planner on GPT-2-small at train's width, rows and
    dtype (B=8, S=1024, bf16, Adam), over a world of AUTOPLAN_RANKS:

    1. a fresh CostDB and autotune cache in a temp dir: the comm sweep
       over two thread ranks on the card (h2d, d2h; allreduce over their
       gloo group, p2p through their pipe channels), then one step's
       forward ops profiled (``profile_op_records``: the eval forward,
       attention on K1, the launch counts set to 0 before it and read
       after, the plain attention's calls counted: none);
    2. ``choose_plan(nworld=2, measure=...)``: the top AUTOPLAN_TOPK
       finalists each realized (``plan_overrides`` + ``Executor``) and
       timed; every candidate's predicted and measured ms, the coverage
       split and the chosen ``plan_key``;
    3. ``Executor(parallel="auto")`` (the warm autotune cache gives it
       the measured winner) trains AUTOPLAN_TRAIN_STEPS steps, the
       launch counts set to 0 before and read after: each step's loss
       against ``train``'s within the plan's tolerance
       (_plan_loss_tols), falling; K2/K3/K4 12 a step in each rank that
       runs attention, all on tc, K1 none;
    4. the job's small GPT profiled into the same DB and trained in this
       process (the job's reference losses); then a 2-rank launcher job:
       ``--autoplan`` (exit 0, ``autoplan: OK``, the JSON report, every
       op priced by a measured cost), then the job training the plan
       AUTOPLAN_JOB_STEPS steps, both ranks on the report's plan, its
       losses against the reference within the plan's tolerance.

    Returns (line, {"profile": launch counts, "train": launch counts
    summed over ranks, "train_rep": K2-K4's shape on the path}).
    ``device``, ``widths`` and ``batch`` rehearse the phase on the CPU
    at small widths (its launch checks then fail: the plain versions
    count nothing)."""
    import shutil
    import tempfile
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch import tune
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import attention as attn
    from hetu_tpu_torch.ops import flash_attention as fa
    from hetu_tpu_torch.parallel import autoplan
    from hetu_tpu_torch.profiler import profile_op_records
    from hetu_tpu_torch.telemetry import costdb
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="autoplan_")
    saved_env = {k: os.environ.get(k) for k in ("HETU_COSTDB",
                                                "HETU_AUTOTUNE_CACHE",
                                                "HETU_AUTOTUNE")}
    os.environ["HETU_COSTDB"] = db_path = os.path.join(tmp, "costdb.json")
    os.environ["HETU_AUTOTUNE_CACHE"] = os.path.join(tmp, "autotune.json")
    os.environ.pop("HETU_AUTOTUNE", None)
    tune.configure(path=os.environ["HETU_AUTOTUNE_CACHE"])
    faults, timing = [], {}
    try:
        db = costdb.CostDB(db_path)
        t = time.perf_counter()
        swept = costdb.comm_microbench(db, sizes=AUTOPLAN_SIZES, reps=3,
                                       device=device, ranks=AUTOPLAN_RANKS)
        timing["comm_microbench_s"] = time.perf_counter() - t
        curves = {k: db.curve(k) for k in ("h2d", "d2h", "allreduce",
                                           "p2p")}
        points = {k: {e["shape"]: e["ms"] for e in db.entries().values()
                      if e["kind"] == k}
                  for k in ("h2d", "d2h", "allreduce", "p2p")}

        # one step's ops profiled, attention's eval forward on K1
        t = time.perf_counter()
        ids, labels, lm, train_op = _gpt_graph(ht, M, widths)
        exe = ht.Executor([lm, train_op], dtype=torch.bfloat16,
                          device=device)
        feeds, shapes = _autoplan_feeds(torch, ids, labels, seed, widths,
                                        batch, device)
        _sync(torch, device)
        plain_attention = _count_calls(attn, "attention_reference")
        _build.reset_launch_counts()                # main path starts
        try:
            records = profile_op_records(exe, feeds, costdb=db)
            _sync(torch, device)
        finally:
            plain_attention = plain_attention()
        profile_launches = dict(_build.launch_counts)   # main path ends
        exe.close()
        del exe, feeds
        _release(torch)
        timing["profile_s"] = time.perf_counter() - t
        want_k1 = {fa.K1: widths["num_hidden_layers"],
                   f"{fa.K1}.tc": widths["num_hidden_layers"],
                   fa.K2: 0, fa.K3: 0, fa.K4: 0}
        got_k1 = {k: profile_launches.get(k, 0) for k in want_k1}
        if got_k1 != want_k1:
            faults.append(f"profile launches {got_k1}, want {want_k1}")
        if plain_attention:
            faults.append(f"the profile ran the plain attention "
                          f"{plain_attention} times")

        # choose, measuring the finalists
        t = time.perf_counter()
        finalists = {}
        measure = _autoplan_measure(torch, seed, finalists, device,
                                    widths, batch)
        ids, labels, lm, train_op = _gpt_graph(ht, M, widths)
        _, shapes = _autoplan_feeds(torch, ids, labels, seed, widths,
                                    batch, device)
        res = autoplan.choose_plan(
            [lm, train_op], nworld=AUTOPLAN_RANKS, db=db,
            feed_shapes=shapes, model="gpt2_small", measure=measure,
            topk=AUTOPLAN_TOPK, device=device, dtype=torch.bfloat16)
        timing["choose_s"] = time.perf_counter() - t
        del ids, labels, lm, train_op
        log("autoplan table:\n" + res.render())
        chosen = autoplan.plan_key(res.plan)
        sources = {}
        for s in res.info["sources"].values():
            sources[s] = sources.get(s, 0) + 1
        candidates = [dict(p.to_dict(), key=autoplan.plan_key(p),
                           **{k: v for k, v in finalists.get(
                               autoplan.plan_key(p), {}).items()
                              if k not in ("plan", "measured_ms")})
                      for p in res.candidates]

        # train the chosen plan through parallel="auto"
        t = time.perf_counter()
        ids, labels, lm, train_op = _gpt_graph(ht, M, widths)
        feeds, shapes = _autoplan_feeds(torch, ids, labels, seed, widths,
                                        batch, device)
        exe = ht.Executor([lm, train_op], dtype=torch.bfloat16,
                          device=device, parallel="auto", autoplan_options={
                              "nworld": AUTOPLAN_RANKS, "db": db,
                              "feed_shapes": shapes, "model": "gpt2_small",
                              "measure": measure, "topk": AUTOPLAN_TOPK})
        timing["train_setup_s"] = time.perf_counter() - t
        plan = exe.config.autoplan.plan
        if autoplan.plan_key(plan) != chosen:
            faults.append(f"parallel='auto' chose {autoplan.plan_key(plan)}"
                          f", choose_plan {chosen}")
        _sync(torch, device)
        _build.reset_launch_counts()                # main path starts
        losses, step_ms = _autoplan_steps(torch, exe, feeds,
                                          AUTOPLAN_TRAIN_STEPS)
        _sync(torch, device)
        by_rank = {r: dict(c) for r, c in _build.rank_launch_counts.items()}
        train_launches = dict(_build.launch_counts)     # main path ends
        nranks = len(exe.ranks)
        exe.close()
        del exe, feeds
        _release(torch)
        timing["train_s"] = time.perf_counter() - t
        if not by_rank:
            by_rank = {0: train_launches}
        attn_ranks = [r for r, c in by_rank.items() if c.get(fa.K2, 0)]
        per_step = widths["num_hidden_layers"]
        if plan.pp > 1:
            per_step *= plan.M
        want = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,),
                             per_step * AUTOPLAN_TRAIN_STEPS)
        if plan.pp == 1 and len(attn_ranks) != nranks:
            faults.append(f"ranks launching attention {attn_ranks} of "
                          f"{nranks}")
        for r in attn_ranks:
            got = {k: by_rank[r].get(k, 0) for k in want}
            if plan.pp == 1 and got != want:
                faults.append(f"rank {r} launched {got}, want {want}")
        if plan.pp > 1:
            got = {k: sum(c.get(k, 0) for c in by_rank.values())
                   for k in want}
            if got != want:
                faults.append(f"the stages launched {got}, want {want}")
        train_ref = train_line["losses"][:AUTOPLAN_TRAIN_STEPS]
        loss_faults, loss_tols = _loss_faults(
            "parallel='auto'", plan.to_dict(), losses, train_ref)
        faults += loss_faults
        train_rep = dict(TRAIN_REP, b=batch // (
            plan.dp * (plan.M if plan.pp > 1 else 1)))

        # the job's small GPT in one process: its ops profiled into the
        # DB (so the job's plan is priced by measured costs) and its
        # losses, the job's reference
        t = time.perf_counter()
        jw = AUTOPLAN_JOB_WIDTHS
        ids, labels, lm, train_op = _gpt_graph(ht, M, jw)
        exe = ht.Executor([lm, train_op], dtype=torch.bfloat16,
                          device=device)
        feeds, _ = _autoplan_feeds(torch, ids, labels, seed, jw,
                                   AUTOPLAN_JOB_BATCH, device)
        job_records = profile_op_records(exe, feeds, costdb=db)
        job_ref, _ = _autoplan_steps(torch, exe, feeds, AUTOPLAN_JOB_STEPS)
        exe.close()
        del exe, feeds
        _release(torch)
        timing["job_reference_s"] = time.perf_counter() - t

        # the launcher job: --autoplan, then the job on the plan
        t = time.perf_counter()
        report, job_ranks, preview_s, job_s = _autoplan_job(seed, db_path,
                                                            device)
        timing["job_s"] = time.perf_counter() - t
        preview = "dp{dp}-tp{tp}-pp{pp}-M{M}-V{V}-f{fuse_ticks}".format(
            **report["chosen"])
        keys = {r["key"] for r in job_ranks}
        if keys != {preview} or report["nworld"] != AUTOPLAN_RANKS:
            faults.append(f"job ranks chose {keys}, the preview {preview} "
                          f"over {report['nworld']}")
        op_cover = [k for k in report["coverage"]["measured"]
                    if k.startswith("op-compute:")]
        n_meas, n_ops = (map(int, op_cover[0].split(":")[1].split("/"))
                         if op_cover else (0, 1))
        if n_meas != n_ops:
            faults.append(f"the job's plan priced {n_meas} of {n_ops} ops "
                          f"by measured costs")
        # a step's loss: the mean of the ranks' that return one (dp's
        # ranks each their rows; tp's the same; a pipeline's last stage)
        job_losses = []
        for i in range(AUTOPLAN_JOB_STEPS):
            got = [r["losses"][i] for r in job_ranks
                   if not r["idle"] and r["losses"][i] is not None]
            job_losses.append(float(np.mean(got)) if got else None)
        job_faults, job_tols = _loss_faults("job", report["chosen"],
                                            job_losses, job_ref)
        faults += job_faults
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tune.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    timed = step_ms[1:]
    tokens = batch * widths["max_position_embeddings"]
    line = {"card": card, "model": "gpt2-small", **widths,
            "batch": batch, "dtype": "bfloat16", "nworld":
            AUTOPLAN_RANKS, "wall_s": wall, "timing_s": timing,
            "costdb": {"swept": swept, "curves": curves, "points_ms": points,
                       "profiled_ops": len(records),
                       "profiled_ms_total": sum(r["ms"] for r in records),
                       "profile_launches": got_k1,
                       "profile_plain_attention_calls": plain_attention,
                       "job_profiled_ops": len(job_records)},
            "op_sources": sources,
            "coverage": {"measured": res.coverage[0],
                         "guessed": res.coverage[1]},
            "candidates": candidates,
            "rejected": [{"mesh": list(c), "reason": r}
                         for c, r in res.rejected],
            "chosen": chosen, "chosen_plan": res.plan.describe(),
            "train": {"plan": autoplan.plan_key(plan), "ranks": nranks,
                      "losses": losses, "step_ms": step_ms,
                      "step_ms_p50": float(np.median(timed)),
                      "tokens_per_s": tokens * len(timed)
                      / (sum(timed) / 1e3),
                      "train_losses": train_ref, "loss_tols": loss_tols,
                      "train_step_ms_p50": train_line["step_ms_p50"],
                      "launches_per_step_by_rank": {
                          r: _per_step(c, AUTOPLAN_TRAIN_STEPS,
                                       (fa.K1, fa.K2, fa.K3, fa.K4,
                                        f"{fa.K2}.tc", f"{fa.K3}.tc",
                                        f"{fa.K4}.tc"))
                          for r, c in by_rank.items()}},
            "job": {"widths": AUTOPLAN_JOB_WIDTHS,
                    "batch": AUTOPLAN_JOB_BATCH, "preview_key": preview,
                    "preview_nworld": report["nworld"],
                    "preview_coverage": report["coverage"],
                    "losses": job_losses, "one_process_losses": job_ref,
                    "loss_tols": job_tols,
                    "preview_candidates": [
                        (c["dp"], c["tp"], c["pp"], c["predicted_ms"])
                        for c in report["candidates"]],
                    "ranks": job_ranks, "preview_s": preview_s,
                    "job_s": job_s}}
    if faults:
        log(f"autoplan failed: {line}")
        raise AssertionError(f"autoplan: {faults}")
    return line, {"profile": profile_launches, "train": train_launches,
                  "train_rep": train_rep}


# ---------------------------------------------------------------------------
# runner_zoo, bert_example: the port's entry scripts as a user runs them
# ---------------------------------------------------------------------------

ZOO = os.path.join(ROOT, "hetu_tpu_torch", "examples", "runner", "parallel")
# (yaml, script, flags, result dir): all at once (small MLPs and a small
# CNN, one process each, all on the card); the gate reads them after
ZOO_BASES = (("config1.yml", "test_mlp_base.py", ["--save"], "mlp"),
             ("config1.yml", "test_cnn_base.py", ["--save"], "cnn"))
ZOO_CASES = (("config4.yml", "test_mlp_mp.py", ["--split", "middle"], "mlp"),
             ("config4.yml", "test_mlp_pp.py", [], "mlp"),
             ("config4.yml", "test_mlp_mp_pp.py", ["--split", "left"], "mlp"),
             ("config4.yml", "test_cnn_mp.py", ["--split", "middle"], "cnn"))
ZOO_TIMEOUT_S = 240
BERT_EXAMPLE_ARGS = ("--num-steps", "20", "--timing", "--batch-size", "64",
                     "--seq-length", "128", "--log-every", "10")


def _zoo_procs(cases, out_dir, index):
    """Start each case through ``python hetu_tpu_torch/run_launcher.py``: its
    loss series to ``out_dir/<dir>/base.npy`` (a base) or
    ``res<i>.npy``."""
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    procs = []
    for cfg, script, flags, sub in cases:
        d = os.path.join(out_dir, sub)
        os.makedirs(d, exist_ok=True)
        name = "base.npy" if index is None else f"res{index[sub]}.npy"
        if index is not None:
            index[sub] += 1
        log_f = open(os.path.join(out_dir, f"{sub}_{name}.log"), "w")
        cmd = [sys.executable, LAUNCHER, "-c",
               os.path.join(ZOO, cfg), sys.executable,
               os.path.join(ZOO, script), *flags, "--log",
               os.path.join(d, name)]
        procs.append((script, flags, log_f, subprocess.Popen(
            cmd, cwd=ZOO, env=env, stdout=log_f, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL, start_new_session=True)))
    return procs


def _zoo_wait(procs):
    """Wait for the cases, each killed whole past ZOO_TIMEOUT_S (every
    one is stopped before a failure is raised); a case that fails raises
    with its log's tail. Returns each case's seconds."""
    t0, seconds, failed = time.perf_counter(), [], []
    for script, flags, log_f, proc in procs:
        try:
            rc = proc.wait(timeout=max(1.0, ZOO_TIMEOUT_S
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        finally:
            try:
                os.killpg(proc.pid, 9)
            except ProcessLookupError:
                pass
            proc.wait()
            log_f.close()
        seconds.append(time.perf_counter() - t0)
        if rc != 0:
            with open(log_f.name) as f:
                failed.append(f"runner_zoo {script} {flags}: exit {rc}\n"
                              f"{f.read()[-3000:]}")
    if failed:
        raise AssertionError("\n".join(failed))
    return seconds


def runner_zoo(card):
    """The port's parallel-config zoo on the card through the port's
    launcher: ``config1`` ``test_mlp_base --save`` and ``test_cnn_base
    --save``, and under ``config4`` — one process driving four devices,
    every ``gpu(i)`` the one card, a context or tuple stage of several
    run as thread ranks — ``test_mlp_mp --split middle``, ``test_mlp_pp``,
    ``test_mlp_mp_pp --split left`` and ``test_cnn_mp --split middle``,
    the six at once. The gate is the zoo's ``validate_results.py`` (rtol
    1e-4, atol 1e-6) over each base's results."""
    import shutil
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="runner_zoo_")
    try:
        t0 = time.perf_counter()
        index = {"mlp": 0, "cnn": 0}
        seconds = _zoo_wait(_zoo_procs(ZOO_BASES, out_dir, None)
                            + _zoo_procs(ZOO_CASES, out_dir, index))
        gates = {}
        for sub, n in index.items():
            out = subprocess.run(
                [sys.executable, os.path.join(ZOO, "validate_results.py"),
                 str(n), "--dir", os.path.join(out_dir, sub)],
                capture_output=True, text=True, timeout=60)
            gates[sub] = out.returncode
            if out.returncode != 0:
                raise AssertionError(f"runner_zoo {sub}: validate_results "
                                     f"{out.stdout[-2000:]}"
                                     f"{out.stderr[-2000:]}")
        series = {sub: {name: np.load(os.path.join(out_dir, sub, name))
                        .tolist() for name in sorted(os.listdir(
                            os.path.join(out_dir, sub)))}
                  for sub in index}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"card": card, "launcher": "python hetu_tpu_torch/run_launcher.py",
            "bases": [[c, s, f] for c, s, f, _ in ZOO_BASES],
            "cases": [[c, s, f] for c, s, f, _ in ZOO_CASES],
            "gate": "validate_results.py, rtol 1e-4, atol 1e-6",
            "gate_exit_codes": gates, "loss_series": series,
            "seconds": seconds,
            "wall_s": time.perf_counter() - t0}


def bert_example(torch, card):
    """``hetu_tpu_torch/examples/train_hetu_bert.py`` as a user runs it,
    BERT-base at S=128, B=64, 20 steps, bf16 (``run(parse_args(...))`` in
    this process, so its launches are counted: set to 0 before, read
    after). The checks: K1 12 launches a step, all on tc, K2-K4 none;
    every loss finite. tokens/s is the example's own, over steps 11-20."""
    from hetu_tpu_torch.examples import train_hetu_bert
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import flash_attention as fa
    steps = int(BERT_EXAMPLE_ARGS[1])
    _build.reset_launch_counts()                    # main path starts
    t0 = time.perf_counter()
    res = train_hetu_bert.run(train_hetu_bert.parse_args(
        list(BERT_EXAMPLE_ARGS)))
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)           # main path ends
    _release(torch)
    want = _route_counts((fa.K1,), (fa.K2, fa.K3, fa.K4),
                         BERT_BASE["num_hidden_layers"] * steps)
    got = {k: launches.get(k, 0) for k in want}
    line = {"card": card, "script": "hetu_tpu_torch/examples/"
            "train_hetu_bert.py", "args": list(BERT_EXAMPLE_ARGS),
            "tokens_per_s": res["tokens_per_sec"], "losses": res["losses"],
            "wall_s": wall, "k1_launches_per_step": {
                k: v / steps for k, v in got.items()}}
    if got != want or not np.all(np.isfinite(res["losses"])):
        log(f"bert_example failed: {line}")
        raise AssertionError(f"bert_example: launches {got} against "
                             f"{want}, losses {res['losses']}")
    return line, launches


# ---------------------------------------------------------------------------
# telemetry_train, telemetry_serve, telemetry_job: the telemetry layer on
# (hetu_tpu_torch/telemetry) over the train, serve_dense and pp_fleet paths
# ---------------------------------------------------------------------------

TEL_WARMUP, TEL_STEPS = 2, 6      # each executor's, interleaved
TEL_PROFILE_STEPS = 2             # under profiler.trace
# the kernels torch.profiler's trace must name on train's path (tc route)
TEL_TRACE_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
                     "flash_bwd_dq_tc_kernel")
TEL_SERVE_HISTS = ("serve_queue_wait_ms", "serve_ttft_ms", "serve_tpot_ms",
                   "http_request_ms")
TEL_JOB_LAYERS, TEL_JOB_WARMUP, TEL_JOB_STEPS = 2, 1, 2
TEL_JOB_TIMEOUT_S = 300
# telemetry_job's traced leg runs under --watch with no fault: its skew is
# the stages' own imbalance (rank 1 holds the LM head and the loss, 11.4
# and 13.9 ms against thresholds of 13.8 and 12.6 in two runs), which the
# monitor names in some runs; a fault-sized skew (fleet_job injects half
# a step or more) is this share of the median step wall
TEL_JOB_MAX_SKEW = 0.5


def _quiet_telemetry(tel):
    """Stop ``tel`` being the process default and flushing at exit (its
    directory is removed with the phase)."""
    import atexit
    from hetu_tpu_torch import telemetry
    atexit.unregister(tel.flush)
    if telemetry._default is tel:
        telemetry._default = None


def telemetry_train(torch, seed, card):
    """``train``'s model and rows (GPT-2-small, B=8, S=1024, bf16, Adam,
    dropout 0) in two executors over the one graph: one with
    ``telemetry=<dir>`` and ``log_path=<dir>/steps.jsonl``, one with
    telemetry off, TEL_WARMUP + TEL_STEPS steps each, interleaved, the
    rows fed from the host. Checks: the traced losses bit-equal to the
    untraced ones; the trace valid (``telemetry.check.validate``); one
    ``step`` span a run; the ``h2d_transfer`` spans and ``h2d_bytes`` the
    feeds' bytes; ``step_wall_ms`` counting every step; the memory
    gauges read (beside ``torch.cuda.max_memory_allocated``); a JSON line
    a step; K2/K3/K4 12 launches a step on ``tc`` for each executor. Then
    TEL_PROFILE_STEPS traced steps under ``profiler.trace``, whose Chrome
    trace must name TEL_TRACE_KERNELS 12 times a step each. Reports the
    traced and untraced step p50 and their ratio (not gated), and the
    device idle share of the profiled steps (their kernels' time against
    their wall). Returns (line, launch counts of the interleaved steps,
    health_train's line, its launches, the telemetry dir: the caller
    runs the doctor over it, then removes it)."""
    import shutil
    import tempfile
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch import profiler
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import flash_attention as fa
    from hetu_tpu_torch.telemetry import validate

    cfg = M.GPTConfig(**GPT2_SMALL, hidden_dropout_prob=0.0,
                      use_flash_attention=True)
    seq = cfg.max_position_embeddings
    ids = ht.Variable("input_ids", trainable=False)
    labels = ht.Variable("labels", trainable=False)
    _, loss = M.GPTLMHeadModel(cfg)(ids, labels)
    lm = ht.reduce_mean_op(loss, [0, 1])
    train_op = ht.optim.AdamOptimizer(learning_rate=TRAIN_LR).minimize(lm)
    x, y = _pp_batch(seed, cfg.vocab_size, seq)
    feeds = {ids: x, labels: y}                     # host rows: h2d a step
    feed_bytes = int(x.nbytes + y.nbytes)
    tdir = tempfile.mkdtemp(prefix="telemetry_train_")
    try:
        traced = ht.Executor([lm, train_op], dtype=torch.bfloat16,
                             telemetry=tdir,
                             log_path=os.path.join(tdir, "steps.jsonl"))
        tel = traced.config.telemetry
        plain = ht.Executor([lm, train_op], dtype=torch.bfloat16,
                            telemetry=False)
        if not tel.enabled or plain.config.telemetry.enabled:
            raise AssertionError("telemetry_train: telemetry= not honored")
        # health_train: a third executor over the graph, the health
        # monitor on (telemetry off)
        monitored = _monitored_executor(ht, torch, [lm, train_op],
                                        os.path.join(tdir, "health"))
        steps = TEL_WARMUP + TEL_STEPS
        runs = (("traced", traced), ("untraced", plain),
                ("health", monitored))
        losses = {key: [] for key, _ in runs}
        step_ms = {key: [] for key, _ in runs}
        by_exe = {key: {} for key, _ in runs}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()                # main paths start
        for _ in range(steps):
            for key, exe in runs:
                before = dict(_build.launch_counts)
                t0 = time.perf_counter()
                out = exe.run(feed_dict=feeds)
                losses[key].append(float(out[0].asnumpy()))  # waits
                step_ms[key].append((time.perf_counter() - t0) * 1e3)
                for k, v in _build.launch_counts.items():
                    by_exe[key][k] = by_exe[key].get(k, 0) + v \
                        - before.get(k, 0)
        torch.cuda.synchronize()                    # main paths end
        peak_alloc = int(torch.cuda.max_memory_allocated())
        # the sentinels' check: a fourth executor, after the timed window,
        # its sampled steps' gradients and weights kept
        checker = _monitored_executor(ht, torch, [lm, train_op],
                                      os.path.join(tdir, "health_check"))
        sampled = _keep_sentinel_inputs(torch, train_op)
        losses["check"] = [float(checker.run(feed_dict=feeds)[0].asnumpy())
                           for _ in range(steps)]
        del train_op.compute                        # the class's again
        launches = {k: by_exe["traced"].get(k, 0)
                    + by_exe["untraced"].get(k, 0)
                    for k in set(by_exe["traced"]) | set(by_exe["untraced"])}
        health_line = _health_train_line(
            torch, monitored, checker, sampled, losses, step_ms,
            by_exe["health"], card, seed)
        del monitored, checker, sampled
        health_line["trip"] = health_trip(torch, [lm, train_op], feeds,
                                          os.path.join(tdir, "trip"))
        gauges = {g: tel.metrics.peek(g)
                  for g in ("memory_live_bytes", "memory_peak_bytes")}
        h2d_counter = tel.counter_value("h2d_bytes")
        wall_count = tel.metrics.histogram("step_wall_ms").count
        traced.close()                              # flushes the files
        trace = os.path.join(tdir, "trace_rank0.json")
        n_events, errors = validate(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        names = {}
        for e in events:
            if e["ph"] != "M":
                names[e["name"]] = names.get(e["name"], 0) + 1
        h2d = [e for e in events if e["name"] == "h2d_transfer"]
        with open(os.path.join(tdir, "steps.jsonl")) as f:
            step_lines = [json.loads(line) for line in f]

        # two more traced steps under torch.profiler
        trace_exe = ht.Executor([lm, train_op], dtype=torch.bfloat16,
                                telemetry=tel)
        trace_exe.run(feed_dict=feeds)[0].asnumpy()  # its state, warm
        _build.reset_launch_counts()
        with profiler.trace(os.path.join(tdir, "profile")) as prof:
            t0 = time.perf_counter()
            for _ in range(TEL_PROFILE_STEPS):
                trace_exe.run(feed_dict=feeds)[0].asnumpy()
            torch.cuda.synchronize()
            profiled_wall_ms = (time.perf_counter() - t0) * 1e3
        profiled = dict(_build.launch_counts)
        with open(prof.trace_path) as f:
            kernel_events = [e for e in json.load(f)["traceEvents"]
                             if e.get("cat") == "kernel"]
        # the share of the profiled steps' wall no kernel ran in (the
        # profiler's own host cost included)
        kernel_ms = sum(float(e.get("dur", 0.0)) for e in kernel_events) / 1e3
        named = {k: sum(1 for e in kernel_events if k in e.get("name", ""))
                 for k in TEL_TRACE_KERNELS}
        del trace_exe, traced, plain
        _quiet_telemetry(tel)
    except BaseException:
        shutil.rmtree(tdir, ignore_errors=True)
        raise
    torch.cuda.empty_cache()

    layers = cfg.num_hidden_layers
    want = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,), layers * 2 * steps)
    got = {k: launches.get(k, 0) for k in want}
    p50 = {k: float(np.median(step_ms[k][TEL_WARMUP:]))
           for k in ("traced", "untraced")}
    checks = {
        "losses_bit_equal": losses["traced"] == losses["untraced"],
        "trace_events": n_events, "trace_errors": errors[:5],
        "step_spans": names.get("step", 0),
        "device_dispatch_spans": names.get("device_dispatch", 0),
        "h2d_transfer_spans": len(h2d),
        "h2d_transfer_bytes": sum(e["args"]["bytes"] for e in h2d),
        "h2d_bytes_counter": h2d_counter,
        "feed_bytes": feed_bytes * steps,
        "step_wall_ms_count": wall_count,
        "memory_gauges": gauges, "max_memory_allocated": peak_alloc,
        "step_log_lines": len(step_lines),
        "launches": got, "launches_want": want,
        "profiler_kernel_events": named,
        "profiler_launches": {k: profiled.get(k, 0)
                              for k in (fa.K2, fa.K3, fa.K4)},
        "profiler_want": layers * TEL_PROFILE_STEPS,
        "profiled_wall_ms": profiled_wall_ms,
        "profiled_kernel_ms": kernel_ms,
        "profiled_device_idle_share": 1.0 - kernel_ms / profiled_wall_ms}
    faults = []
    if not checks["losses_bit_equal"] or not all(
            np.isfinite(losses["traced"])):
        faults.append(f"losses traced {losses['traced']} untraced "
                      f"{losses['untraced']}")
    if errors or checks["step_spans"] != steps or \
            checks["step_wall_ms_count"] != steps or \
            checks["step_log_lines"] != steps:
        faults.append("trace / step counts")
    if len(h2d) != 2 * steps or not (
            checks["h2d_transfer_bytes"] == checks["h2d_bytes_counter"]
            == checks["feed_bytes"]):
        faults.append("h2d accounting")
    if not gauges["memory_live_bytes"] or gauges["memory_peak_bytes"] \
            is None or gauges["memory_peak_bytes"] > peak_alloc:
        faults.append("memory gauges")
    if got != want:
        faults.append("launches")
    if any(n != checks["profiler_want"] for n in named.values()) or any(
            n != checks["profiler_want"]
            for n in checks["profiler_launches"].values()):
        faults.append("profiler.trace kernel events")
    line = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "batch": TRAIN_BATCH, "seq": seq, "dtype": "bfloat16",
            "optimizer": "Adam", "lr": TRAIN_LR, "seed": seed,
            "warmup_steps": TEL_WARMUP, "timed_steps": TEL_STEPS,
            "losses": losses["traced"],
            "step_ms": {k: step_ms[k] for k in ("traced", "untraced")},
            "step_ms_p50_traced": p50["traced"],
            "step_ms_p50_untraced": p50["untraced"],
            "telemetry_overhead_ratio": p50["traced"] / p50["untraced"],
            "checks": checks}
    if faults:
        shutil.rmtree(tdir, ignore_errors=True)
        raise AssertionError(f"telemetry_train: {faults}: {line}")
    return line, launches, health_line, by_exe["health"], tdir


# health_train, health_job: the training health monitor
# (hetu_tpu_torch/telemetry/health.py) on train's path and in a job
HEALTH_EVERY_N = 2
HEALTH_REL_TOL = 1e-5     # sentinels against their plain recomputation
HEALTH_NAN_PARAM = "gpt_h0_attn_qkv_weights"
HEALTH_NAN_STEP, HEALTH_TRIP_STEPS = 3, 4   # trips at the next sample
HEALTH_JOB_SPEC = "every_n=5,action=dump"
HEALTH_JOB_STEPS, HEALTH_JOB_NAN_STEP = 13, 7
HEALTH_JOB_TIMEOUT_S = 180


def _monitored_executor(ht, torch, nodes, out_dir):
    """An executor of ``train``'s graph with the health monitor on at
    every_n=HEALTH_EVERY_N (telemetry off), its records into ``out_dir``."""
    return ht.Executor(nodes, dtype=torch.bfloat16, telemetry=False,
                       health_options={"every_n": HEALTH_EVERY_N,
                                       "out_dir": out_dir})


def _keep_sentinel_inputs(torch, train_op):
    """On every step the health monitor samples (``ectx.health_sentinels``
    set), keep ``{name: (gradient, f32 master before, after)}`` of each
    parameter ``train_op`` updates. The kept blocks do not go back to the
    allocator, so only the untimed check executor runs with this. Returns
    the list they go to; ``del train_op.compute`` undoes it."""
    kept = []
    compute = type(train_op).compute

    def keep(input_vals, ectx):
        if ectx.health_sentinels is None:
            return compute(train_op, input_vals, ectx)
        masters = ectx.master_params or ectx.params
        params = train_op.optimizer.params
        before = {p: masters[p] for p in params}
        out = compute(train_op, input_vals, ectx)
        kept.append({p.name: (g, before[p], ectx.new_params[p])
                     for p, g in zip(params, input_vals) if g is not None})
        return out

    train_op.compute = keep
    return kept


def _plain_sentinels(torch, step):
    """One sampled step's sentinels recomputed plainly in f32 on the card
    from what ``_keep_sentinel_inputs`` kept: {name: (grad_norm,
    nonfinite, update_ratio)}, read in one copy."""
    from hetu_tpu_torch.ndarray import IndexedSlices
    names, vals = sorted(step), []
    for name in names:
        g, old, new = step[name]
        g = (g.values if isinstance(g, IndexedSlices) else g).float()
        vals += [torch.linalg.vector_norm(g),
                 (~torch.isfinite(g)).sum().float(),
                 torch.linalg.vector_norm(new.float() - old.float())
                 / (torch.linalg.vector_norm(old.float()) + 1e-12)]
    host = torch.stack(vals).double().cpu().numpy().reshape(-1, 3)
    return dict(zip(names, host))


def _rel_err(got, ref):
    """|got - ref| / |ref| (|got| where ref is 0); inf where either is
    missing or not finite, so that no entry escapes its gate."""
    if got is None or ref is None:
        return float("inf")
    err = abs(got - ref) / abs(ref) if ref else abs(got)
    return float(err) if np.isfinite(err) else float("inf")


def _health_train_line(torch, exe, checker, sampled, losses, step_ms,
                       launches, card, seed):
    """``health_train``'s line and checks. ``exe`` ran in the timed
    window; ``checker``, a second monitored executor of the graph, ran the
    same steps after it with their inputs kept (``sampled``). Checks: both
    executors' losses bit-equal to the untraced one's; records at every
    HEALTH_EVERY_N-th step, each with every parameter tensor of the
    model, every nonfinite count 0 and ``loss_finite``; each of
    ``checker``'s records' grad norms and update ratios within
    HEALTH_REL_TOL of their plain f32 recomputation from the step's
    gradients and weights, and ``exe``'s within HEALTH_REL_TOL of
    ``checker``'s; K2/K3/K4 12 a step on ``tc`` in ``exe``. Reports the
    monitored and untraced step p50 and their ratio (not gated) and
    ``sample_wall_ms`` a sample, both of ``exe``, which ran no check."""
    from hetu_tpu_torch.ops import flash_attention as fa
    hm, hm_check = exe.config.health_monitor, checker.config.health_monitor
    records, checked = list(hm.records), list(hm_check.records)
    steps = len(losses["health"])
    want_steps = list(range(HEALTH_EVERY_N, steps + 1, HEALTH_EVERY_N))
    names = {p.name for p in exe.subexecutors["default"].optimizer_ops[0]
             .optimizer.params}
    worst = {"grad_norm": 0.0, "update_ratio": 0.0}
    worst_window = {"grad_norm": 0.0, "update_ratio": 0.0}
    faults = []
    for rec, chk, step in zip(records, checked, sampled):
        plain = _plain_sentinels(torch, step)
        if not (set(rec["layers"]) == set(chk["layers"]) == set(plain)
                == names) or rec["step"] != chk["step"]:
            faults.append(f"step {rec['step']} layers")
            continue
        for name, (gn, nf, ur) in plain.items():
            m, c = rec["layers"][name], chk["layers"][name]
            if m["nonfinite"] != 0 or c["nonfinite"] != 0 or nf != 0:
                faults.append(f"step {rec['step']} {name} nonfinite")
            for key, ref in (("grad_norm", gn), ("update_ratio", ur)):
                worst[key] = max(worst[key], _rel_err(c[key], ref))
                worst_window[key] = max(worst_window[key],
                                        _rel_err(m[key], c[key]))
    want = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,),
                         GPT2_SMALL["num_hidden_layers"] * steps)
    got = {k: launches.get(k, 0) for k in want}
    p50 = {k: float(np.median(step_ms[k][TEL_WARMUP:]))
           for k in ("health", "untraced")}
    both = records + checked
    checks = {
        "losses_bit_equal": losses["health"] == losses["untraced"]
        == losses["check"],
        "record_steps": [r["step"] for r in records],
        "check_record_steps": [r["step"] for r in checked],
        "record_steps_want": want_steps,
        "layers_per_record": [len(r["layers"]) for r in records],
        "parameter_tensors": len(names),
        "loss_finite": [r["loss_finite"] for r in both],
        "nonfinite_total": sum(m["nonfinite"] for r in both
                               for m in r["layers"].values()),
        "trips": sum(len(r["trips"]) for r in both),
        "max_rel_err": worst, "max_rel_err_window_vs_check": worst_window,
        "rel_tol": HEALTH_REL_TOL,
        "launches": got, "launches_want": want}
    if not checks["losses_bit_equal"]:
        faults.append(f"losses {losses['health']} and {losses['check']} "
                      f"against untraced {losses['untraced']}")
    if checks["record_steps"] != want_steps or \
            checks["check_record_steps"] != want_steps or \
            len(sampled) != len(want_steps) or \
            not all(checks["loss_finite"]) or \
            checks["nonfinite_total"] or checks["trips"]:
        faults.append("records")
    if max(worst.values()) > HEALTH_REL_TOL:
        faults.append("sentinels against their recomputation")
    if max(worst_window.values()) > HEALTH_REL_TOL:
        faults.append("the timed executor's sentinels against the check's")
    if got != want:
        faults.append("launches")
    line = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "batch": TRAIN_BATCH, "dtype": "bfloat16", "optimizer": "Adam",
            "seed": seed, "every_n": HEALTH_EVERY_N,
            "warmup_steps": TEL_WARMUP, "timed_steps": TEL_STEPS,
            "losses": losses["health"],
            "step_ms": {k: step_ms[k] for k in ("health", "untraced")},
            "step_ms_p50_monitored": p50["health"],
            "step_ms_p50_untraced": p50["untraced"],
            "health_overhead_ratio": p50["health"] / p50["untraced"],
            "samples": len(records),
            "sample_wall_ms": hm.sample_wall_ms / max(1, len(records)),
            "checks": checks}
    exe.close()
    checker.close()
    if faults:
        raise AssertionError(f"health_train: {faults}: {line}")
    return line


def health_trip(torch, nodes, feeds, out_dir):
    """``health_train``'s trip: a fresh executor of the graph with
    telemetry into ``out_dir`` and the monitor at every_n=HEALTH_EVERY_N,
    action ``dump``; one element of the f32 master HEALTH_NAN_PARAM set to
    NaN before step HEALTH_NAN_STEP. Checks: the trip at the next sampled
    step (kind ``nonfinite``, ``loss_finite`` false), the last-good record
    at the sample before, the flight dump, and ``python -m
    hetu_tpu_torch.telemetry.health``'s ``first_bad_step``."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.telemetry import Telemetry
    tel = Telemetry(enabled=True, out_dir=out_dir, rank=0)
    exe = ht.Executor(nodes, dtype=torch.bfloat16, telemetry=tel,
                      health_options={"every_n": HEALTH_EVERY_N,
                                      "action": "dump"})
    sid = next(sid for sid, n in exe._param_nodes.items()
               if n.name == HEALTH_NAN_PARAM)
    losses = []
    for step in range(1, HEALTH_TRIP_STEPS + 1):
        if step == HEALTH_NAN_STEP:
            exe.params[sid].view(-1)[0] = float("nan")
        losses.append(float(exe.run(feed_dict=feeds)[0].asnumpy()))
    records = list(exe.config.health_monitor.records)
    exe.close()
    _quiet_telemetry(tel)
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m",
                          "hetu_tpu_torch.telemetry.health", out_dir,
                          "--json"], cwd=ROOT, capture_output=True,
                         text=True)
    cli_s = time.perf_counter() - t0
    rep = json.loads(cli.stdout) if cli.returncode == 0 else {}
    with open(os.path.join(out_dir, "health_lastgood_rank0.json")) as f:
        lastgood = json.load(f)
    with open(os.path.join(out_dir, "flight_rank0.json")) as f:
        reason = json.load(f)["reason"]
    trip_step = HEALTH_NAN_STEP + (-HEALTH_NAN_STEP) % HEALTH_EVERY_N
    bad = [r for r in records if r["trips"]]
    out = {"nan_param": HEALTH_NAN_PARAM, "nan_step": HEALTH_NAN_STEP,
           "losses": losses, "record_steps": [r["step"] for r in records],
           "trip_step": bad[0]["step"] if bad else None,
           "trip_kinds": sorted({t["kind"] for t in bad[0]["trips"]})
           if bad else [], "loss_finite": bad[0]["loss_finite"]
           if bad else None,
           "layer": next((t["layer"] for t in bad[0]["trips"]
                          if t.get("layer")), None) if bad else None,
           "lastgood_step": lastgood["step"], "flight_reason": reason,
           "cli_rc": cli.returncode, "cli_s": cli_s,
           "cli_first_bad_step": rep.get("first_bad_step")}
    if out["trip_step"] != trip_step or out["trip_kinds"] != \
            ["nonfinite"] or out["loss_finite"] is not False or \
            out["lastgood_step"] != trip_step - HEALTH_EVERY_N or \
            not reason.startswith("health trip: nonfinite") or \
            out["cli_first_bad_step"] != trip_step:
        raise AssertionError(f"health_train trip: {out} {cli.stderr}")
    return out


def health_worker(spec):
    """One rank of ``health_job`` (``python chip_smoke.py
    --health-worker SPEC``): the reference's acceptance run on the card
    (tests/test_health.py:684), the 12 -> 16 -> 4 MLP trained by SGD for
    HEALTH_JOB_STEPS steps with a NaN fed at step HEALTH_JOB_NAN_STEP; the
    monitor armed by the launcher's ``--health`` (``HETU_HEALTH``), on
    ``spec["device"]``."""
    import torch
    import hetu_tpu_torch as ht
    rank = int(os.environ.get("HETU_PS_RANK", "0"))
    x = ht.Variable("x", trainable=False)
    y_ = ht.Variable("y_", trainable=False)
    w1 = ht.init.xavier_normal((12, 16), name="acc_w1")
    w2 = ht.init.xavier_normal((16, 4), name="acc_w2")
    h = ht.relu_op(ht.matmul_op(x, w1))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(h, w2), y_), [0])
    train = ht.optim.SGDOptimizer(0.1).minimize(loss)
    exe = ht.Executor([loss, train], device=spec["device"])
    if exe.config.health_monitor is None:
        raise AssertionError("health_job: HETU_HEALTH must arm the monitor")
    frng = np.random.RandomState(spec["seed"] + 3 + rank)
    for step in range(1, HEALTH_JOB_STEPS + 1):
        xs = frng.randn(8, 12).astype("f")
        ys = np.eye(4, dtype="f")[frng.randint(0, 4, 8)]
        if step == HEALTH_JOB_NAN_STEP:
            xs[0, 0] = np.nan
        exe.run(feed_dict={x: xs, y_: ys})
    if exe.config.device.type == "cuda":
        torch.cuda.synchronize()
    exe.close()
    return 0


def health_job(card, seed, device="cuda"):
    """``health_job``: two launcher workers of health_worker with
    ``--telemetry <dir> --health every_n=5,action=dump``. Checks: records
    at steps 5 and 10 on both ranks; both tripped at 10 (``nonfinite``,
    naming ``acc_w1`` or ``acc_w2``); the last-good files at step 5 and
    the flight dumps; the health CLI's ``first_bad_step`` 10 and
    ``bad_ranks`` [0, 1]; the black-box CLI's ``health.first_bad_step``
    10. ``device="cpu"`` rehearses it without a card."""
    import shutil
    import tempfile
    config = "nodes:\n  - host: localhost\n    workers: 2\n    chief: true\n"
    out_dir = tempfile.mkdtemp(prefix="health_job_")
    tdir = os.path.join(out_dir, "telemetry")
    try:
        wall, _ = _launch_job(
            "health_job", config, "--health-worker",
            {"seed": seed, "out": out_dir, "device": device},
            HEALTH_JOB_TIMEOUT_S, False,
            launcher_args=["--telemetry", tdir, "--health",
                           HEALTH_JOB_SPEC])
        ranks = []
        for r in range(2):
            with open(os.path.join(tdir, f"health_rank{r}.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            with open(os.path.join(tdir,
                                   f"health_lastgood_rank{r}.json")) as f:
                lastgood = json.load(f)["step"]
            trips = recs[-1]["trips"] if recs else []
            ranks.append({
                "record_steps": [rec["step"] for rec in recs],
                "loss_finite": [rec["loss_finite"] for rec in recs],
                "trip_kinds": sorted({t["kind"] for t in trips}),
                "layers": sorted({t["layer"] for t in trips
                                  if t.get("layer")}),
                "lastgood_step": lastgood,
                "flight_dump": os.path.exists(os.path.join(
                    tdir, f"flight_rank{r}.json"))})
        clis = {}
        for tool in ("health", "blackbox"):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", f"hetu_tpu_torch.telemetry.{tool}",
                 tdir, "--json"], cwd=ROOT, capture_output=True, text=True)
            clis[tool] = {"rc": proc.returncode,
                          "s": time.perf_counter() - t0,
                          "report": json.loads(proc.stdout)
                          if proc.returncode == 0 else proc.stderr[-500:]}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    rep, bb = clis["health"]["report"], clis["blackbox"]["report"]
    faults = []
    for r in ranks:
        if r["record_steps"] != [5, 10] or r["loss_finite"] != \
                [True, False] or "nonfinite" not in r["trip_kinds"] or \
                not set(r["layers"]) & {"acc_w1", "acc_w2"} or \
                r["lastgood_step"] != 5 or not r["flight_dump"]:
            faults.append("records")
    if not isinstance(rep, dict) or rep.get("first_bad_step") != 10 or \
            rep.get("bad_ranks") != [0, 1]:
        faults.append("health CLI")
    if not isinstance(bb, dict) or \
            (bb.get("health") or {}).get("first_bad_step") != 10:
        faults.append("blackbox CLI")
    line = {"card": card, "workers": 2, "model": "mlp 12-16-4",
            "health": HEALTH_JOB_SPEC, "steps": HEALTH_JOB_STEPS,
            "nan_step": HEALTH_JOB_NAN_STEP, "wall_s": wall,
            "ranks": ranks,
            "health_cli": {"rc": clis["health"]["rc"],
                           "s": clis["health"]["s"],
                           "first_bad_step": rep.get("first_bad_step")
                           if isinstance(rep, dict) else None,
                           "bad_ranks": rep.get("bad_ranks")
                           if isinstance(rep, dict) else None},
            "blackbox_cli": {"rc": clis["blackbox"]["rc"],
                             "s": clis["blackbox"]["s"],
                             "health": bb.get("health")
                             if isinstance(bb, dict) else None}}
    if faults:
        raise AssertionError(f"health_job: {faults}: {line}")
    return line


def telemetry_serve(torch, seed, card):
    """``serve_dense``'s plane (GPT-2-small f32, HTTP -> ReplicaRouter ->
    two MicroBatchers -> GPTDecoder.from_session, K1 ``simt`` on the
    prefill) with one enabled Telemetry through every layer, under
    TEL_SERVE_CLIENTS closed-loop clients x TEL_SERVE_PER_CLIENT requests
    of MAX_NEW tokens, K1 counted from 0. Checks: ``GET /metrics`` 200
    with the serving histograms (TEL_SERVE_HISTS) and its latency;
    ``GET /v1/requests`` and ``GET /stats``; each request's timeline
    complete (recorded at every hop: HTTP, router, batcher queue and
    latency, one count each); ``flush()`` writing ``requests_rank0.json``
    beside the trace, no request left in flight; the replies equal a
    telemetry-off decoder's generate of each request alone up to the
    first top-2 logit gap under MARGIN_TOL, and one batch of every prompt
    bit-equal between a decoder with telemetry on and one with it off.
    The decoders behind the batchers record no request timeline (in
    either package only the engine's scheduler does), so an engine leg
    follows: a ContinuousBatchingEngine over the same session and
    Telemetry serves TEL_SERVE_ENGINE_REQUESTS of the prompts, K1 on its
    prefill, each retiring with its ``serve_request`` / ``serve_phase``
    spans. Returns (line, launch counts of the HTTP leg, the telemetry
    dir: the caller runs the serving doctor over it, then removes it)."""
    import http.client
    import shutil
    import tempfile
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch import telemetry
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.serving import (ContinuousBatchingEngine,
                                        GPTDecoder, InferenceSession,
                                        MicroBatcher, ReplicaRouter,
                                        ServingHTTPServer)

    cfg = M.GPTConfig(**GPT2_SMALL, hidden_dropout_prob=0.0,
                      use_flash_attention=True)
    ids = ht.Variable("input_ids", trainable=False)
    logits = M.GPTLMHeadModel(cfg)(ids)
    tdir = tempfile.mkdtemp(prefix="telemetry_serve_")
    tel = telemetry.Telemetry(enabled=True, out_dir=tdir, rank=0)
    sess = InferenceSession([logits], seed=seed,
                            seq_buckets=(DENSE_SEQ_BUCKET,))
    decs = [GPTDecoder.from_session(sess, cfg, telemetry=tel,
                                    prompt_buckets=(DENSE_PROMPT_BUCKET,))
            for _ in range(2)]
    off = GPTDecoder.from_session(sess, cfg, telemetry=False,
                                  prompt_buckets=(DENSE_PROMPT_BUCKET,))
    rng = np.random.default_rng(seed)
    n_req = TEL_SERVE_CLIENTS * TEL_SERVE_PER_CLIENT
    pb = DENSE_PROMPT_BUCKET
    prompts = np.stack([
        np.pad(rng.integers(0, cfg.vocab_size, int(n)), (0, pb - int(n)),
               mode="edge") for n in rng.integers(16, pb + 1, n_req)])

    for d in decs:                                  # untimed warm pass
        b = 1
        while b <= TEL_SERVE_CLIENTS:
            d.generate(prompts[:b], 2)
            b *= 2
    torch.cuda.synchronize()
    batchers = [MicroBatcher(_dense_tick(d),
                             max_batch_size=DENSE_MAX_BATCH,
                             max_wait_ms=DENSE_MAX_WAIT_MS,
                             name=f"replica{i}", telemetry=tel)
                for i, d in enumerate(decs)]
    router = ReplicaRouter(batchers, telemetry=tel)
    srv = ServingHTTPServer(router, host="127.0.0.1", telemetry=tel)

    def get(port, path):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            t0 = time.perf_counter()
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            return resp.status, body, (time.perf_counter() - t0) * 1e3
        finally:
            conn.close()

    try:
        port = srv.start()
        _build.reset_launch_counts()                # main path starts
        t0 = time.perf_counter()
        got, latency = _http_clients(port, prompts, MAX_NEW,
                                     TEL_SERVE_CLIENTS,
                                     TEL_SERVE_PER_CLIENT, "tel")
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)       # main path ends
        m_status, m_body, m_ms = get(port, "/metrics")
        r_status, r_body, _ = get(port, "/v1/requests")
        s_status, s_body, _ = get(port, "/stats")
        stats = router.stats()["replicas"]
    finally:
        srv.stop()
        for mb in batchers:
            mb.close()
    # the HTTP leg's hops, before the engine leg observes its own
    snap = {s["name"]: s for s in tel.metrics.snapshot()}
    try:
        # the engine leg: request timelines into the same trace
        eng = ContinuousBatchingEngine.from_session(
            sess, cfg, telemetry=tel, start=False, num_blocks=NUM_BLOCKS,
            max_batch_size=8)
        _, engine_metrics = drive(eng, list(
            prompts[:TEL_SERVE_ENGINE_REQUESTS].astype(np.int32)), MAX_NEW)
        eng.close()
        del eng
        paths = tel.flush()
        with open(os.path.join(tdir, "requests_rank0.json")) as f:
            inflight = json.load(f)
        n_events, errors = telemetry.validate(
            os.path.join(tdir, "trace_rank0.json"))
    except BaseException:
        shutil.rmtree(tdir, ignore_errors=True)
        raise
    finally:
        _quiet_telemetry(tel)
    ticks = sum(r["replica"]["ticks"] for r in stats)

    # the replies against a telemetry-off decoder: each request alone up
    # to its first near-tie (teacher-forced margins), and one batch of
    # every prompt bit-equal between the two decoders
    checked = []
    for i in range(n_req):
        alone = off.generate(prompts[i:i + 1], MAX_NEW)
        tf = sess.predict({ids: np.concatenate(
            [prompts[i:i + 1], alone[:, :-1]], axis=1)})[0][0, pb - 1:]
        _, n_ok, _ = _margin_checked(tf)
        if not np.array_equal(got[i][0, :n_ok], alone[0, :n_ok]):
            raise AssertionError(
                f"telemetry_serve request {i}: {got[i].tolist()} against "
                f"{alone.tolist()} with telemetry off (first {n_ok})")
        checked.append(n_ok)
    batch_on = decs[0].generate(prompts, MAX_NEW)
    batch_off = off.generate(prompts, MAX_NEW)
    text = m_body.decode()
    hops = {"http_request_ms": snap.get("http_request_ms", {}).get("count"),
            "router_latency_ms": snap.get("router_latency_ms",
                                          {}).get("count"),
            "serve_queue_wait_ms": snap.get("serve_queue_wait_ms",
                                            {}).get("count"),
            "replica_latency_ms": sum(
                snap.get(f"replica{i}_latency_ms", {}).get("count", 0)
                for i in range(2))}
    rows_left = sum(len(c["requests"]) for c in inflight["components"])
    checks = {
        "metrics_status": m_status, "metrics_ms": m_ms,
        "metrics_histograms": {h: f"# TYPE {h} summary" in text
                               for h in TEL_SERVE_HISTS},
        "requests_status": r_status,
        "requests_in_flight": json.loads(r_body)["count"],
        "stats_status": s_status,
        "stats_healthy": json.loads(s_body)["healthy"],
        "timeline_hops": hops, "requests": n_req,
        "flushed": sorted(os.path.basename(p) for p in paths),
        "requests_file_components": [c["kind"]
                                     for c in inflight["components"]],
        "requests_left_in_flight": rows_left,
        "trace_events": n_events, "trace_errors": errors[:5],
        "replies_checked_positions": checked,
        "batch_on_equals_off": bool(np.array_equal(batch_on, batch_off)),
        "k1": _k1_counts(launches), "ticks": ticks}
    sess.close()
    del sess, decs, off
    torch.cuda.empty_cache()
    faults = []
    if m_status != 200 or not all(checks["metrics_histograms"].values()):
        faults.append("/metrics")
    if (r_status, s_status) != (200, 200) or checks["requests_in_flight"]:
        faults.append("/v1/requests or /stats")
    if any(v != n_req for v in hops.values()) or rows_left or \
            "requests_rank0.json" not in checks["flushed"]:
        faults.append("request timelines")
    if errors or not checks["batch_on_equals_off"]:
        faults.append("trace or tokens")
    try:
        _check_k1_path("telemetry_serve", launches,
                       cfg.num_hidden_layers * ticks)
    except AssertionError as e:
        faults.append(str(e))
    line = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "dtype": "float32", "seed": seed,
            "stack": "HTTP -> ReplicaRouter -> 2 x MicroBatcher -> "
                     "GPTDecoder.from_session(InferenceSession), one "
                     "enabled Telemetry",
            "clients": TEL_SERVE_CLIENTS,
            "requests_per_client": TEL_SERVE_PER_CLIENT,
            "max_new_tokens": MAX_NEW, "wall_s": wall,
            "tokens_per_s": n_req * MAX_NEW / wall,
            "latency_ms_p50": float(np.percentile(latency, 50)),
            "engine_leg": engine_metrics,
            "checks": checks}
    if faults:
        shutil.rmtree(tdir, ignore_errors=True)
        raise AssertionError(f"telemetry_serve: {faults}: {line}")
    return line, launches, tdir


def telemetry_worker(spec):
    """One rank of ``telemetry_job`` (``python chip_smoke.py
    --telemetry-worker SPEC``): GPT-2-small's widths at TEL_JOB_LAYERS
    layers in two stages, one a rank (``ht.rgpu("worker<r>", r)``, the
    one card), GPipe M=PP_MICROBATCHES, bf16, TEL_JOB_WARMUP +
    TEL_JOB_STEPS steps on train's rows; the executor's telemetry is the
    job's (``HETU_TELEMETRY`` when the launcher had ``--telemetry``).
    Writes ``rank_<r>.json``: losses, launches, whether telemetry was
    on. The graph and its ``Executor`` come before anything touches the
    card, so the launcher's ``--preflight`` runs this script unchanged
    (``preflight_job``): the ``Executor`` exits there. ``back_edge``
    adds a third block on worker0 after worker1's, a stage-0 node
    reading stage 1's output: a schedule that would hang, which only a
    preflight may be given."""
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import _build
    rank = int(os.environ.get("HETU_PROC_ID", "0"))
    if "HETU_PREFLIGHT" in os.environ:
        # what the preflight's exit leaves behind: whether CUDA started
        import atexit

        def touched():
            with open(os.path.join(spec["out"],
                                   f"preflight_{os.getpid()}.json"), "w") as f:
                json.dump({"cuda": torch.cuda.is_initialized()}, f)
        atexit.register(touched)
    widths = dict(GPT2_SMALL, num_hidden_layers=TEL_JOB_LAYERS)
    contexts = [ht.rgpu(f"worker{i}", i) for i in range(2)]
    if spec.get("back_edge"):
        contexts.append(contexts[0])
        widths["num_hidden_layers"] = len(contexts)
    ids, labels, loss, _, train_op, _ = _pp_graph(ht, M, contexts,
                                                  widths=widths)
    exe = ht.Executor([loss, train_op], dtype=torch.bfloat16,
                      num_microbatches=PP_MICROBATCHES, gpipe=True)
    xt, yt = (torch.as_tensor(a, device="cuda") for a in _pp_batch(
        spec["seed"], widths["vocab_size"],
        widths["max_position_embeddings"]))
    _build.reset_launch_counts()
    losses = []
    for _ in range(TEL_JOB_WARMUP + TEL_JOB_STEPS):
        res = exe.run(feed_dict={ids: xt, labels: yt})
        if res[0] is not None:
            losses.append(float(res[0].asnumpy()))
    torch.cuda.synchronize()
    kernels = _k1_k4_launches(_build.launch_counts)
    out = {"rank": rank, "losses": losses,
           "telemetry": exe.config.telemetry.enabled,
           "launches": {k: v for k, v in _build.launch_counts.items()
                        if k.split(".")[0] in kernels}}
    exe.close()
    with open(os.path.join(spec["out"], f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def telemetry_job(card, seed):
    """``telemetry_job``: a two-rank launcher job (``spmd: true``) of
    telemetry_worker with ``--telemetry <dir> --watch`` (the fleet plane
    armed, no fault), then the same job without either. Checks:
    ``trace_merged.json`` passes ``python -m
    hetu_tpu_torch.telemetry.check``; it holds spans of both pids, the
    channel's ``p2p_*`` and the pipeline's ``pp_*`` spans; both
    ``metrics_rank<r>.jsonl`` files exist, rank 1's with
    ``pp_bubble_fraction``; both ranks flushed step timelines and the
    monitor's ``fleet_report.json``, aligned, shows no fault-sized skew
    (under TEL_JOB_MAX_SKEW of the median step wall, rank 0 never named:
    with no fault the skew is the stages' imbalance, and rank 1 holds the
    LM head); every loss equals the untraced job's (the fleet plane
    changes no math); each rank
    launches K2-K4 once a layer and microbatch a step. Returns (line,
    the traced ranks' launch counts, the traced leg's telemetry dir: the
    caller runs the doctor over it, then removes it)."""
    import shutil
    import tempfile
    from hetu_tpu_torch.ops import flash_attention as fa
    config = ("spmd: true\nnodes:\n  - host: localhost\n    workers: 2\n"
              "    chief: true\n")
    runs, kept = {}, None
    for traced in (True, False):
        out_dir = tempfile.mkdtemp(prefix="telemetry_job_")
        tdir = os.path.join(out_dir, "telemetry")
        try:
            wall, _ = _launch_job(
                "telemetry_job", config, "--telemetry-worker",
                {"seed": seed, "out": out_dir}, TEL_JOB_TIMEOUT_S, False,
                launcher_args=["--telemetry", tdir, "--watch"]
                if traced else [])
            ranks = []
            for r in range(2):
                with open(os.path.join(out_dir, f"rank_{r}.json")) as f:
                    ranks.append(json.load(f))
            rec = {"wall_s": wall, "ranks": ranks}
            if traced:
                merged = os.path.join(tdir, "trace_merged.json")
                t0 = time.perf_counter()
                check = subprocess.run(
                    [sys.executable, "-m", "hetu_tpu_torch.telemetry.check",
                     merged], cwd=ROOT, capture_output=True, text=True)
                rec["check_s"] = time.perf_counter() - t0
                rec["check_rc"] = check.returncode
                rec["check_out"] = check.stdout.strip()[-300:]
                with open(merged) as f:
                    events = json.load(f)["traceEvents"]
                spans = [e for e in events if e["ph"] == "X"]
                names = {}
                for e in spans:
                    names[e["name"]] = names.get(e["name"], 0) + 1
                rec["events"] = len(events)
                rec["span_pids"] = sorted({e["pid"] for e in spans})
                rec["spans"] = {k: v for k, v in sorted(names.items())
                                if k.startswith(("p2p_", "pp_", "step"))}
                rec["metrics_files"] = sorted(
                    f for f in os.listdir(tdir) if f.startswith("metrics_"))
                with open(os.path.join(tdir, "metrics_rank1.jsonl")) as f:
                    bubble = [json.loads(line) for line in f
                              if "pp_bubble_fraction" in line]
                rec["pp_bubble_fraction"] = bubble[0]["p50"] \
                    if bubble else None
                with open(os.path.join(tdir, "fleet_report.json")) as f:
                    report = json.load(f)
                rec["fleet_report"] = {k: report[k] for k in (
                    "step", "aligned", "straggler", "skew_ms", "victims",
                    "ranks")}
                rec["timelines"] = sorted(
                    f for f in os.listdir(tdir) if f.startswith("timeline_"))
                kept = out_dir
            runs["traced" if traced else "untraced"] = rec
        except BaseException:
            if kept is not None:
                shutil.rmtree(kept, ignore_errors=True)
            raise
        finally:
            if kept != out_dir:
                shutil.rmtree(out_dir, ignore_errors=True)
    steps = TEL_JOB_WARMUP + TEL_JOB_STEPS
    per_rank = TEL_JOB_LAYERS // 2 * PP_MICROBATCHES * steps
    want = {fa.K1: 0, fa.K2: per_rank, fa.K3: per_rank, fa.K4: per_rank}
    tr, un = runs["traced"], runs["untraced"]
    losses = [r["losses"] for r in tr["ranks"]]
    faults = []
    if tr["check_rc"] != 0 or len(tr["span_pids"]) < 2:
        faults.append("merged trace")
    if not any(k.startswith("p2p_") for k in tr["spans"]) or not any(
            k.startswith("pp_") for k in tr["spans"]) or \
            tr["pp_bubble_fraction"] is None or \
            tr["metrics_files"] != ["metrics_rank0.jsonl",
                                    "metrics_rank1.jsonl"]:
        faults.append("spans / metrics files")
    if losses != [r["losses"] for r in un["ranks"]] or \
            len(losses[1]) != steps or losses[0]:
        faults.append(f"losses {losses} against "
                      f"{[r['losses'] for r in un['ranks']]}")
    if [r["telemetry"] for r in tr["ranks"] + un["ranks"]] != \
            [True, True, False, False]:
        faults.append("telemetry on/off by the launcher flag")
    report = tr["fleet_report"]
    walls = [r["step_ms"] for r in report["ranks"].values()
             if r["step_ms"] is not None]
    tr["fleet_skew_bound_ms"] = TEL_JOB_MAX_SKEW * float(np.median(walls)) \
        if walls else None
    if tr["timelines"] != ["timeline_rank0.jsonl", "timeline_rank1.jsonl"] \
            or not report["aligned"] or report["straggler"] == 0 or \
            not walls or report["skew_ms"] >= tr["fleet_skew_bound_ms"]:
        faults.append(f"fleet plane: timelines {tr['timelines']}, report "
                      f"{report}")
    want.update({f"{k}.tc": per_rank for k in (fa.K2, fa.K3, fa.K4)})
    if any({k: r["launches"].get(k, 0) for k in want} != want
           for r in tr["ranks"] + un["ranks"]):
        faults.append(f"launches, want {want}")
    line = {"card": card, "model": "gpt2-small",
            **dict(GPT2_SMALL, num_hidden_layers=TEL_JOB_LAYERS),
            "workers": 2, "stages": 2, "microbatches": PP_MICROBATCHES,
            "schedule": "gpipe", "dtype": "bfloat16",
            "steps": steps, "losses": losses[1], "traced": tr,
            "untraced_wall_s": un["wall_s"],
            "launches_per_rank": [r["launches"] for r in tr["ranks"]]}
    if faults:
        shutil.rmtree(kept, ignore_errors=True)
        raise AssertionError(f"telemetry_job: {faults}: {line}")
    return line, [r["launches"] for r in tr["ranks"]], \
        os.path.join(kept, "telemetry")

# doctor_train, doctor_job, doctor_serve: the perf doctor
# (hetu_tpu_torch/telemetry/doctor.py) over the directories telemetry_train,
# telemetry_job and telemetry_serve wrote; fleet_job: the fleet plane
# (telemetry/fleet.py) on GPT-2-small's 12 blocks in two GPipe processes
# under the launcher's --watch, rank 1 slowed
FLEET_WARMUP, FLEET_STEPS = 1, 4
FLEET_SLOW_FRAC = 0.75      # the fault: this share of pp_fleet's GPipe p50
FLEET_TIMEOUT_S = 300
FLEET_HANG_TIMEOUT_S = 120
DOCTOR_TOOLS = ("fleet", "blackbox", "doctor")   # fleet_job's CLIs


def _doctor_windows(doctor, events):
    """Each step window of one rank's trace attributed alone by the
    doctor: (windows, conserved windows, largest conservation error)."""
    spans = [e for e in events if e.get("ph") == "X"]
    wins = [e for e in spans if e["name"] in ("step", "step_block")]
    rest = [e for e in spans if e["name"] not in ("step", "step_block")]
    verdicts = [doctor.attribute_events([w] + rest) for w in wins]
    return {"windows": len(wins),
            "windows_conserved": sum(bool(a["conserved"])
                                     for a in verdicts),
            "max_conservation_error": max(
                (a["conservation_error"] for a in verdicts), default=None)}


def _doctor_timed(doctor, events, skip):
    """The doctor over one rank's step windows past the first ``skip``
    (the warm-up steps): buckets in ms a step, its step wall."""
    spans = [e for e in events if e.get("ph") == "X"]
    wins = sorted((e for e in spans if e["name"] in ("step", "step_block")),
                  key=lambda e: e["ts"])
    rest = [e for e in spans if e["name"] not in ("step", "step_block")]
    a = doctor.attribute_events(wins[skip:] + rest)
    return {"steps": a["steps"], "step_wall_ms": a["step_wall_ms"],
            "ms_per_step": a["per_step_ms"], "conserved": a["conserved"]}


def _doctor_ranks(doctor, tdir, skip=0):
    """The doctor over one telemetry dir: per rank its steps, step wall,
    buckets in ms a step, hidden ms, the measured bubble fraction and
    every window's conservation, and with ``skip`` the same past the
    first ``skip`` (warm-up) windows; and the diagnosis."""
    t0 = time.perf_counter()
    per = doctor.attribute_trace(tdir)
    diag = doctor.diagnose(per)
    traces = doctor.load_telemetry_dir(tdir)
    windows = {label: _doctor_windows(doctor, events) for label, events
               in traces.items() if label in per}
    if skip:
        for label in windows:
            windows[label]["timed"] = _doctor_timed(doctor, traces[label],
                                                    skip)
    seconds = time.perf_counter() - t0
    ranks = {label: {
        "steps": a["steps"], "step_wall_ms": a["step_wall_ms"],
        "ms_per_step": a["per_step_ms"], "hidden_ms": a["hidden_ms"],
        "bubble_fraction": a["per_step_ms"]["bubble"]
        / max(a["step_wall_ms"], 1e-9),
        "conserved": a["conserved"],
        "conservation_error": a["conservation_error"],
        **windows[label]} for label, a in sorted(per.items())}
    faults = [f"{label}: {w['windows_conserved']} of {w['windows']} "
              f"windows conserved" for label, w in ranks.items()
              if w["windows_conserved"] != w["windows"] or not w["windows"]
              or not w["conserved"]]
    return ranks, diag, seconds, faults


def _diag_summary(diag):
    return {k: diag.get(k) for k in (
        "straggler", "steps", "step_wall_ms", "top_exposed_bucket",
        "ranked_exposed", "bubble_fraction", "comm_compute_ratio",
        "conserved")} if diag.get("ranks") else diag


def doctor_train(tdir, tel_line):
    """The doctor over telemetry_train's traced executor: its
    TEL_WARMUP + TEL_STEPS windows, each conserved (the buckets sum to
    the step wall within the doctor's 10%), the buckets in ms a step
    beside the untraced step p50 and the profiled steps' device idle
    share (spans time host work: a bucket is host time, and the idle
    share says whether the device waited on it)."""
    from hetu_tpu_torch.telemetry import doctor
    ranks, diag, seconds, faults = _doctor_ranks(doctor, tdir,
                                                 skip=TEL_WARMUP)
    steps = TEL_WARMUP + TEL_STEPS
    if set(ranks) != {"rank0"} or ranks["rank0"]["steps"] != steps:
        faults.append(f"steps {ranks}, want {steps} on rank0")
    line = {"source": "telemetry_train", "seconds": seconds,
            "ranks": ranks, "diagnosis": _diag_summary(diag),
            "step_ms_p50_traced": tel_line["step_ms_p50_traced"],
            "step_ms_p50_untraced": tel_line["step_ms_p50_untraced"],
            "profiled_device_idle_share":
                tel_line["checks"]["profiled_device_idle_share"]}
    if faults:
        raise AssertionError(f"doctor_train: {faults}: {line}")
    return line


def doctor_job(tdir, job_line):
    """The doctor over telemetry_job's traced leg (two GPipe processes):
    each rank's windows conserved, its buckets in ms a step, and the
    measured bubble fraction (``pp_stage_idle`` over the step wall)
    beside the analytic ``pp_bubble_fraction`` the job reported."""
    from hetu_tpu_torch.telemetry import doctor
    ranks, diag, seconds, faults = _doctor_ranks(doctor, tdir,
                                                 skip=TEL_JOB_WARMUP)
    steps = TEL_JOB_WARMUP + TEL_JOB_STEPS
    if set(ranks) != {"rank0", "rank1"} or any(
            r["steps"] != steps for r in ranks.values()):
        faults.append(f"steps {ranks}, want {steps} on each rank")
    measured = {label: r["bubble_fraction"] for label, r in ranks.items()}
    measured_timed = {label: r["timed"]["ms_per_step"]["bubble"]
                      / max(r["timed"]["step_wall_ms"], 1e-9)
                      for label, r in ranks.items()}
    if not any(v > 0 for v in measured.values()):
        faults.append("no measured bubble")
    line = {"source": "telemetry_job", "seconds": seconds, "ranks": ranks,
            "diagnosis": _diag_summary(diag),
            "bubble_fraction_measured": measured,
            "bubble_fraction_measured_timed": measured_timed,
            "bubble_fraction_analytic":
                job_line["traced"]["pp_bubble_fraction"]}
    if faults:
        raise AssertionError(f"doctor_job: {faults}: {line}")
    return line


def doctor_serve(tdir, serve_line):
    """The serving doctor over telemetry_serve's trace: every request of
    its engine leg retired, its timeline complete and conserved (the
    buckets sum to its e2e within the doctor's 5%), TTFT p50 beside the
    engine's own measure."""
    from hetu_tpu_torch.telemetry import doctor
    t0 = time.perf_counter()
    diag = doctor.attribute_requests_dir(tdir)
    seconds = time.perf_counter() - t0
    line = {"source": "telemetry_serve", "seconds": seconds,
            **{k: diag.get(k) for k in (
                "requests", "conserved", "complete", "violations",
                "incomplete", "e2e_p50_ms", "e2e_p99_ms",
                "serve_ttft_p50_ms", "serve_ttft_p99_ms",
                "serve_tpot_p50_ms", "serve_queue_wait_p99_ms",
                "buckets_ms", "bucket_fraction", "preempted_requests",
                "top_bucket")},
            "engine_ttft_ms_p50": serve_line["engine_leg"]["ttft_ms_p50"]}
    if diag.get("requests") != TEL_SERVE_ENGINE_REQUESTS or not (
            diag.get("conserved") and diag.get("complete")):
        raise AssertionError(f"doctor_serve: {line}")
    return line


def watch_worker(spec):
    """One rank of ``fleet_job`` (``python chip_smoke.py --watch-worker
    SPEC``): GPT-2-small's 12 blocks in two GPipe stages, one a rank
    (``ht.rgpu("worker<r>", r)``, the one card), M=PP_MICROBATCHES of
    PP_MICROBATCH rows, bf16, FLEET_WARMUP + FLEET_STEPS steps on train's
    rows, under the launcher's ``--watch`` and the fault it was given.
    Writes ``rank_<r>.json``: losses, step ms, launches, the fault's
    seconds and whether the step timeline was armed."""
    import torch
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.ops import _build
    rank = int(os.environ["HETU_PROC_ID"])
    xt, yt = (torch.as_tensor(a, device="cuda") for a in _pp_batch(
        spec["seed"], GPT2_SMALL["vocab_size"],
        GPT2_SMALL["max_position_embeddings"]))
    contexts = [ht.rgpu(f"worker{i}", i) for i in range(2)]
    ids, labels, loss, _, train_op, _ = _pp_graph(ht, M, contexts)
    exe = ht.Executor([loss, train_op], dtype=torch.bfloat16,
                      num_microbatches=PP_MICROBATCHES, gpipe=True)
    _build.reset_launch_counts()                    # main path starts
    losses, step_ms = [], []
    for _ in range(FLEET_WARMUP + FLEET_STEPS):
        t0 = time.perf_counter()
        res = exe.run(feed_dict={ids: xt, labels: yt})
        if res[0] is not None:
            losses.append(float(res[0].asnumpy()))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    kernels = _k1_k4_launches(_build.launch_counts)  # main path ends
    out = {"rank": rank, "losses": losses, "step_ms": step_ms,
           "fault_slow_s": exe._fault_slow_s,
           "timeline": exe._fleet_timeline is not None,
           "launches": {k: v for k, v in _build.launch_counts.items()
                        if k.split(".")[0] in kernels}}
    exe.close()
    with open(os.path.join(spec["out"], f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def fleet_job(card, seed, pp_fleet_line):
    """``fleet_job``: a two-rank launcher job (``spmd: true``) of
    watch_worker under ``--telemetry <dir> --watch --hang-timeout 120``,
    rank 1 slowed by ``HETU_FAULT_SLOW_RANK=1`` for FLEET_SLOW_FRAC of
    pp_fleet's GPipe step p50 a step (the same model in two processes);
    then the fleet CLI, the black box and the doctor over its directory,
    each as ``python -m hetu_tpu_torch.telemetry.<tool> <dir> --json``.
    Checks: the live monitor's ``fleet_report.json`` and the fleet CLI
    name rank 1, the launcher printed its STRAGGLER line, the black box
    names rank 1 as the straggler; both ranks flushed timelines; rank 1
    carried the fault and its own work covers it (self ms at least the
    fault's), rank 0 none; the doctor conserves every window; losses
    finite; each rank launches K2-K4 once a layer and microbatch a step,
    all ``tc``. Returns (line, each rank's launch counts)."""
    import math
    import shutil
    import tempfile
    from hetu_tpu_torch.ops import flash_attention as fa
    from hetu_tpu_torch.telemetry import doctor
    p50 = pp_fleet_line["schedules"]["gpipe"]["step_ms_p50"]
    slow_ms = int(math.ceil(FLEET_SLOW_FRAC * p50))
    config = ("spmd: true\nnodes:\n  - host: localhost\n    workers: 2\n"
              "    chief: true\n")
    out_dir = tempfile.mkdtemp(prefix="fleet_job_")
    tdir = os.path.join(out_dir, "telemetry")
    try:
        wall, _ = _launch_job(
            "fleet_job", config, "--watch-worker",
            {"seed": seed, "out": out_dir}, FLEET_TIMEOUT_S, False,
            launcher_args=["--telemetry", tdir, "--watch", "--hang-timeout",
                           str(FLEET_HANG_TIMEOUT_S)],
            env={"HETU_FAULT_SLOW_RANK": "1",
                 "HETU_FAULT_SLOW_MS": str(slow_ms)})
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank_{r}.json")) as f:
                ranks.append(json.load(f))
        with open(os.path.join(tdir, "fleet_report.json")) as f:
            live = json.load(f)
        with open(os.path.join(out_dir, "job.log")) as f:
            printed = "straggler rank 1" in f.read()
        timelines = sorted(f for f in os.listdir(tdir)
                           if f.startswith("timeline_"))
        cli, cli_s = {}, {}
        for tool in DOCTOR_TOOLS:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", f"hetu_tpu_torch.telemetry.{tool}",
                 tdir, "--json"], cwd=ROOT, capture_output=True, text=True,
                timeout=120)
            cli_s[tool] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"fleet_job: {tool} CLI exit "
                                     f"{proc.returncode}: {proc.stdout[-2000:]}"
                                     f" {proc.stderr[-2000:]}")
            cli[tool] = json.loads(proc.stdout)
        dranks, diag, dseconds, faults = _doctor_ranks(doctor, tdir,
                                                       skip=FLEET_WARMUP)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    steps = FLEET_WARMUP + FLEET_STEPS
    per_rank = GPT2_SMALL["num_hidden_layers"] // 2 * PP_MICROBATCHES * steps
    want = {fa.K1: 0, **{k: per_rank for k in (fa.K2, fa.K3, fa.K4)},
            **{f"{k}.tc": per_rank for k in (fa.K2, fa.K3, fa.K4)}}
    row1 = live["ranks"]["1"]
    box = cli["blackbox"].get("fleet") or {}
    if live["straggler"] != 1 or not printed or \
            cli["fleet"]["straggler"] != 1 or box.get("straggler") != 1:
        faults.append(f"straggler: live {live['straggler']} (printed "
                      f"{printed}), CLI {cli['fleet']['straggler']}, black "
                      f"box {box}")
    if timelines != ["timeline_rank0.jsonl", "timeline_rank1.jsonl"] or \
            not all(r["timeline"] for r in ranks):
        faults.append(f"timelines {timelines}")
    if [r["fault_slow_s"] for r in ranks] != [0.0, slow_ms / 1e3] or \
            (row1["self_ms"] or 0.0) < slow_ms:
        faults.append(f"the fault: {[r['fault_slow_s'] for r in ranks]}, "
                      f"rank 1's self {row1['self_ms']} ms against "
                      f"{slow_ms} ms")
    losses = ranks[1]["losses"]
    if ranks[0]["losses"] or len(losses) != steps or \
            not all(np.isfinite(losses)):
        faults.append(f"losses {[r['losses'] for r in ranks]}")
    if any({k: r["launches"].get(k, 0) for k in want} != want
           for r in ranks):
        faults.append(f"launches, want {want}")
    if not cli["doctor"].get("conserved"):
        faults.append("doctor CLI conservation")
    med_wall = float(np.median([v["step_ms"] for v in live["ranks"].values()
                                if v["step_ms"] is not None]))
    line = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "workers": 2, "stages": 2, "microbatches": PP_MICROBATCHES,
            "microbatch_rows": PP_MICROBATCH, "schedule": "gpipe",
            "dtype": "bfloat16", "steps": steps, "losses": losses,
            "wall_s": wall, "pp_fleet_gpipe_step_ms_p50": p50,
            "fault_slow_ms": slow_ms,
            "step_ms": {str(r["rank"]): r["step_ms"] for r in ranks},
            "live_report": {k: live[k] for k in (
                "step", "aligned", "straggler", "skew_ms", "victims",
                "ranks")},
            "skew_ms": live["skew_ms"], "skew_threshold_ms": max(
                2.0, 0.2 * med_wall),
            "cli_straggler": cli["fleet"]["straggler"],
            "cli_skew_ms": cli["fleet"]["skew_ms"],
            "blackbox_fleet": box,
            "blackbox_suspects": cli["blackbox"].get("suspect_ranks"),
            "cli_seconds": cli_s, "doctor_seconds": dseconds,
            "doctor": {"ranks": dranks, "diagnosis": _diag_summary(diag),
                       "cli_conserved": cli["doctor"].get("conserved")},
            "launches_per_rank": [r["launches"] for r in ranks]}
    if faults:
        raise AssertionError(f"fleet_job: {faults}: {line}")
    return line, [r["launches"] for r in ranks]


# preflight_train: steps of the validated and the unvalidated executor,
# graph builds timed with and without the construction-site frame walk
PF_STEPS, PF_BUILD_REPS = 3, 3
PF_JOB_TIMEOUT_S = 240


def preflight_train(torch, seed, card):
    """``preflight_train``: ``train``'s graph (GPT-2-small, B=8, S=1024,
    bf16, Adam) under ``Executor(validate="error")`` on the card. The
    report must hold no error; the host seconds ``analyze`` took; 3
    steps whose losses equal an unvalidated executor's bit for bit (the
    analysis adds no device work), with K2/K3/K4 12 a step on ``tc``
    (counted from 0 just before the validated session's construction,
    read just after its steps); the memory pass's HT402 breakdown with
    the feeds' shapes beside the steps' ``max_memory_allocated``; the
    budget resolved from the card. Then ``HETU_HBM_BUDGET`` at a tenth
    of that peak: HT401 must raise ``GraphValidationError`` before any
    parameter reaches the card (``memory_allocated`` unchanged). Also
    the graph's build time with and without the construction-site frame
    walk (``graph/node.py`` ``_construction_site``). Returns (line, the
    validated session's launch counts, what ``numerics_train`` reuses:
    the graph, its feeds and the unvalidated losses)."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import analysis
    from hetu_tpu_torch import models as M
    from hetu_tpu_torch.analysis import memory as pf_memory
    from hetu_tpu_torch.graph import node as gnode
    from hetu_tpu_torch.graph.autodiff import find_topo_sort
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import flash_attention as fa

    site = gnode._construction_site
    # the last graph built, the one the sessions run, records its sites
    build_ms = {"without_site": [], "with_site": []}
    try:
        for _ in range(PF_BUILD_REPS):
            for key in build_ms:
                gnode._construction_site = site if key == "with_site" \
                    else (lambda: (None, None))
                t0 = time.perf_counter()
                ids, labels, lm, train_op = _gpt_graph(ht, M, GPT2_SMALL)
                build_ms[key].append((time.perf_counter() - t0) * 1e3)
    finally:
        gnode._construction_site = site
    nodes = [lm, train_op]
    nops = len(find_topo_sort(nodes))
    x, y = _gpt_rows(seed, TRAIN_BATCH)
    feeds = {ids: torch.as_tensor(x, device="cuda"),
             labels: torch.as_tensor(y, device="cuda")}

    def steps(exe):
        return [float(exe.run(feed_dict=feeds)[0].asnumpy())
                for _ in range(PF_STEPS)]

    plain = ht.Executor(nodes, dtype=torch.bfloat16)
    unvalidated = steps(plain)
    del plain
    torch.cuda.empty_cache()

    # the validated session: the main path of this phase
    timed = analysis.analyze
    analyze_s = []

    def timed_analyze(*a, **kw):
        t0 = time.perf_counter()
        try:
            return timed(*a, **kw)
        finally:
            analyze_s.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    analysis.analyze = timed_analyze
    _build.reset_launch_counts()                    # main path starts
    try:
        exe = ht.Executor(nodes, dtype=torch.bfloat16, validate="error")
    finally:
        analysis.analyze = timed
    validated = steps(exe)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)           # main path ends
    peak = torch.cuda.max_memory_allocated() - base
    report = exe.config.analysis_report
    codes = {}
    for f in report.findings:
        codes[f.code] = codes.get(f.code, 0) + 1
    del exe
    torch.cuda.empty_cache()

    # the footprint estimate with the feeds' shapes (the construction's
    # analysis had none: its activations are unshaped)
    shaped = analysis.analyze(nodes, feed_shapes={
        ids: ((TRAIN_BATCH, GPT2_SMALL["max_position_embeddings"]),
              np.int64),
        labels: ((TRAIN_BATCH, GPT2_SMALL["max_position_embeddings"]),
                 np.int64)})
    ht402 = {f.code: f.data for f in shaped.findings}.get("HT402", {})
    ht402_unshaped = {f.code: f.data for f in report.findings}.get(
        "HT402", {})
    budget = pf_memory.resolve_budget()

    # a budget of a tenth of the measured peak: HT401 before any weight
    # reaches the card
    before = torch.cuda.memory_allocated()
    os.environ["HETU_HBM_BUDGET"] = str(peak // 10)
    raised = None
    try:
        ht.Executor(nodes, dtype=torch.bfloat16, validate="error")
    except analysis.GraphValidationError as e:
        raised = sorted({f.code for f in e.report.errors})
    finally:
        del os.environ["HETU_HBM_BUDGET"]
    after = torch.cuda.memory_allocated()

    want = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,),
                         GPT2_SMALL["num_hidden_layers"] * PF_STEPS)
    got = {k: launches.get(k, 0) for k in want}
    line = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "batch": TRAIN_BATCH, "dtype": "bfloat16", "optimizer": "Adam",
            "seed": seed, "validate": "error", "steps": PF_STEPS,
            "graph_ops": nops, "graph_build_ms": build_ms,
            "analyze_s": analyze_s, "report_codes": codes,
            "report_errors": len(report.errors),
            "losses": validated, "unvalidated_losses": unvalidated,
            "launches": got,
            "ht402_with_feed_shapes": ht402,
            "ht402_at_construction": ht402_unshaped,
            "peak_memory_bytes": int(peak),
            "estimate_over_peak": (ht402.get("total_bytes", 0) / peak
                                   if peak else None),
            "budget_from_card_bytes": budget,
            "ht401_budget_bytes": int(peak // 10),
            "ht401_raised": raised,
            "memory_allocated_before_after": [int(before), int(after)]}
    faults = []
    if report.errors:
        faults.append(f"errors in the report: {report.to_text()}")
    if validated != unvalidated:
        faults.append("validated losses differ from the unvalidated")
    if got != want:
        faults.append(f"launches {got}, want {want}")
    if not all(np.isfinite(validated)):
        faults.append("losses not finite")
    if raised is None or "HT401" not in raised:
        faults.append(f"HT401 not raised at a budget of {peak // 10} B")
    if after != before:
        faults.append("the rejected session put bytes on the card")
    if budget is None or budget < peak:
        faults.append(f"the card's budget {budget} B")
    if faults:
        raise AssertionError(f"preflight_train: {faults}: {line}")
    return line, launches, {"nodes": nodes, "ids": ids, "labels": labels,
                            "feeds": feeds, "unvalidated": unvalidated}


# numerics_train: steps of the recorded executor, then unrecorded steps
# of the same executor (timed only), and the rangecheck CLI's steps
NT_STEPS, NT_PLAIN_STEPS, NT_CLI_STEPS = 3, 2, 3


def numerics_train(torch, card, shared):
    """``numerics_train``: ``preflight_train``'s graph, rows and
    unvalidated losses (GPT-2-small, B=8, S=1024, bf16, Adam) under the
    numerics verifier and its measured-range twin. A fresh executor with
    ``validate="error"``: ``analyze`` with HT8xx (codes by count, its
    host seconds, no error); a ``RangeRecorder`` at every_n=1 over 3
    steps whose losses equal the unvalidated executor's bit for bit (the
    recorder only reads), K2/K3/K4 12 a step on ``tc`` (counted from 0
    just before the session's construction, read just after its recorded
    steps); ``soundness_pass`` over the measured ranges against the
    static intervals of the session's topo order: no HT810, and every
    ``FlashAttentionOp`` among the checked nodes (its bound is the hull
    of v, which K2 writes). Reported, not gated: the recorded and the
    unrecorded step ms (2 more steps, detached), ``sample()``'s wall ms,
    and one more step each way under torch.profiler. Then ``rangecheck.main`` over mlp and wdl_adult on the card
    (exit 0) and ``numerics.check_zoo()`` (no finding). Returns (line,
    the recorded session's launch counts)."""
    import shutil
    import tempfile
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import analysis
    from hetu_tpu_torch.analysis import numerics, rangecheck
    from hetu_tpu_torch.analysis.shapes import shape_pass
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import flash_attention as fa

    nodes, feeds = shared["nodes"], shared["feeds"]

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    timed = analysis.analyze
    analyze_s = []

    def timed_analyze(*a, **kw):
        t0 = time.perf_counter()
        try:
            return timed(*a, **kw)
        finally:
            analyze_s.append(time.perf_counter() - t0)
    analysis.analyze = timed_analyze
    _build.reset_launch_counts()                    # main path starts
    try:
        exe = ht.Executor(nodes, dtype=torch.bfloat16, validate="error")
    finally:
        analysis.analyze = timed
    report = exe.config.analysis_report
    rec = rangecheck.RangeRecorder(exe, every_n=1).attach()
    losses, step_ms, sample_ms = [], [], []
    for _ in range(NT_STEPS):
        out, ms = sync_ms(lambda: exe.run(feed_dict=feeds)[0])
        losses.append(float(out.asnumpy()))
        step_ms.append(ms)
        t0 = time.perf_counter()
        rec.sample()
        sample_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)           # main path ends
    # one more step each way under torch.profiler: where the recorded
    # step's added time goes (device kernels or the host's issue)
    profiles = {"recorded": profile_train_step(torch, exe, feeds)}
    rec.sample()
    rec.detach()
    profiles["unrecorded"] = profile_train_step(torch, exe, feeds)
    plain_ms = [sync_ms(lambda: exe.run(feed_dict=feeds))[1]
                for _ in range(NT_PLAIN_STEPS)]
    measured = rec.by_stable_key()
    nan_nodes = sorted(k for k, (lo, hi) in measured.items()
                       if math.isnan(lo) or math.isnan(hi))

    # the static side over the session's topo order, with the feeds'
    # shapes and the session's config
    topo = exe.subexecutors["default"].topo_order
    seq = GPT2_SMALL["max_position_embeddings"]
    dtypes = {}
    shapes = shape_pass(topo, analysis.Report(), feed_shapes={
        shared["ids"]: ((TRAIN_BATCH, seq), np.int64),
        shared["labels"]: ((TRAIN_BATCH, seq), np.int64)},
        dtypes_out=dtypes)
    t0 = time.perf_counter()
    static = numerics.numerics_pass(topo, analysis.Report(), shapes=shapes,
                                    dtypes=dtypes, config=exe.config)
    pass_s = time.perf_counter() - t0
    sound, checked = rangecheck.soundness_pass(topo, static, measured)
    keys = numerics.stable_keys(topo)
    fa_keys = [k for k, n in zip(keys, topo)
               if n.op_type == "FlashAttentionOp"]
    fa_checked = [k for k in fa_keys
                  if k in measured and static[topo[keys.index(k)]]
                  is not None]
    fa_rows = {k: {"measured": measured.get(k),
                   "static": static[topo[keys.index(k)]]}
               for k in fa_keys[:2]}
    del exe, rec
    torch.cuda.empty_cache()

    # the CLI on the card, and the zoo
    tmp = tempfile.mkdtemp(prefix="rangedb_")
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as cli_out:
            cli_rc = rangecheck.main(["mlp", "wdl_adult", "--steps",
                                      str(NT_CLI_STEPS), "--db",
                                      os.path.join(tmp, "ranges.json")])
        cli_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "ranges.json")) as f:
            db_models = sorted(json.load(f)["models"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    zoo = numerics.check_zoo()
    zoo_s = time.perf_counter() - t0
    zoo_findings = {n: [str(f) for f in r.findings]
                    for n, r in zoo.items() if len(r)}

    codes = {}
    for f in report.findings:
        codes[f.code] = codes.get(f.code, 0) + 1
    want = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,),
                         GPT2_SMALL["num_hidden_layers"] * NT_STEPS)
    got = {k: launches.get(k, 0) for k in want}
    line = {"card": card, "model": "gpt2-small", **GPT2_SMALL,
            "batch": TRAIN_BATCH, "dtype": "bfloat16", "optimizer": "Adam",
            "validate": "error", "every_n": 1, "steps": NT_STEPS,
            "analyze_s": analyze_s, "report_codes": codes,
            "report_errors": len(report.errors),
            "losses": losses, "unvalidated_losses": shared["unvalidated"],
            "launches": got, "graph_ops": len(topo),
            "measured_nodes": len(measured), "checked": checked,
            "ht810": len(sound.errors),
            "ht810_findings": [str(f) for f in sound.errors[:5]],
            "nan_nodes": nan_nodes,
            "flash_attention_nodes": len(fa_keys),
            "flash_attention_checked": len(fa_checked),
            "flash_attention_ranges": fa_rows,
            "numerics_pass_s": pass_s,
            "recorded_step_ms": step_ms, "unrecorded_step_ms": plain_ms,
            "sample_ms": sample_ms,
            "profiles": {k: {f: p[f] for f in (
                "wall_ms", "device_busy_ms", "device_idle_share",
                "by_category", "top_kernels")}
                for k, p in profiles.items()},
            "rangecheck_cli": {"rc": cli_rc, "seconds": cli_s,
                               "db_models": db_models,
                               "out": cli_out.getvalue()[-600:]},
            "check_zoo": {"models": len(zoo), "findings": zoo_findings,
                          "seconds": zoo_s}}
    faults = []
    if report.errors:
        faults.append(f"errors in the report: {report.to_text()}")
    if losses != shared["unvalidated"]:
        faults.append("recorded losses differ from the unvalidated")
    if not all(np.isfinite(losses)):
        faults.append("losses not finite")
    if got != want:
        faults.append(f"launches {got}, want {want}")
    if sound.errors or nan_nodes:
        faults.append(f"{len(sound.errors)} HT810, NaN at {nan_nodes}")
    if checked == 0 or not fa_keys or len(fa_checked) != len(fa_keys):
        faults.append(f"checked {checked}; FlashAttentionOp checked "
                      f"{len(fa_checked)} of {len(fa_keys)}")
    if cli_rc != 0 or db_models != ["mlp", "wdl_adult"]:
        faults.append(f"rangecheck CLI exit {cli_rc}, DB {db_models}")
    if len(zoo) != 14 or zoo_findings:
        faults.append(f"check_zoo over {len(zoo)}: {zoo_findings}")
    if faults:
        raise AssertionError(f"numerics_train: {faults}: {line}")
    return line, launches


# efficiency_train: perfcheck's traced steps of the GPT-2-small session and
# of one HT902 fixture a dtype — (M, K, N) GEMMs the card's model flags:
# f32 N=72, compute-bound, padded to the 64-wide N granule; bf16 N=260,
# whose rows are not whole 16-byte vectors. A flagged GEMM's priced share
# of its time may be at most perfcheck.SOUND_FACTOR times the share that
# aligning its dims measurably saves (efficiency.measure_padding_share)
EF_STEPS = 8
EF_FIXTURES = {"float32": (8192, 4096, 72), "bfloat16": (8192, 4096, 260)}


def _ht902_fixture(ht, dtype):
    """A training graph whose forward GEMM the card's model flags."""
    m, k, n = EF_FIXTURES[dtype]
    a = ht.init.random_normal((m, k), name=f"ef_a_{dtype}")
    b = ht.init.random_normal((k, n), name=f"ef_b_{dtype}")
    loss = ht.reduce_mean_op(ht.matmul_op(a, b), [0, 1])
    return [loss, ht.optim.SGDOptimizer(1e-3).minimize(loss)]


def _codes(findings):
    out = {}
    for f in findings:
        out[f.code] = out.get(f.code, 0) + 1
    return out


def _traced(torch, ht, nodes, tdir, device, **kw):
    """An executor of ``nodes`` tracing into ``tdir``, each run's loss and
    host ms (the readback ends the step) kept on it. Close it with
    ``_untrace``."""
    from hetu_tpu_torch.telemetry import Telemetry
    exe = ht.Executor(nodes, telemetry=Telemetry(
        enabled=True, out_dir=tdir, rank=0), device=device, **kw)
    exe.losses, exe.step_ms = [], []
    run = exe.run

    def recorded(*a, **k):
        t0 = time.perf_counter()
        out = run(*a, **k)
        exe.losses.append(float(out[0].asnumpy()))
        exe.step_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    exe.run = recorded
    return exe


def _untrace(exe):
    """Close a ``_traced`` executor; its telemetry, flushed, writes no more
    (the trace dir goes with the phase's temp dir)."""
    exe.close()
    exe.config.telemetry.out_dir = None


def _session_dtype(torch, name):
    """An Executor's ``dtype=`` for a dtype name: None (the default) for
    f32."""
    return None if name == "float32" else getattr(torch, name)


def _ht910(report):
    return [f for f in report.findings if f.code == "HT910"]


def efficiency_train(torch, card, shared, device="cuda"):
    """``efficiency_train``: ``preflight_train``'s graph, rows and
    unvalidated losses (GPT-2-small, B=8, S=1024, bf16, Adam) under the
    efficiency lint and perfcheck:

    1. a CostDB measured on the card in a temp dir (``HETU_COSTDB`` for
       the phase): the comm sweep (h2d, d2h; allreduce and p2p between
       two thread ranks, autoplan's sizes), then ``profile_ops`` over the
       session's forward ops and each HT902 fixture's, each twice: the
       cold pass's total reported, the warm pass's ops into the DB;
    2. the card model sweep (``measure_card_model``): every GEMM time,
       the granules fitted, the GEMM rates and the copy rate, beside the
       module's constants (reported, not gated: the cuda test holds them);
    3. a fresh ``validate="error"`` executor with telemetry (``analyze``
       with HT9xx: codes, seconds, no error), held to its measured steps
       by ``perfcheck.perfcheck_session``: EF_STEPS traced steps whose
       first losses equal the unvalidated executor's bit for bit, K2/K3/K4
       12 a step on ``tc`` (counted from 0 just before the construction,
       read just after the steps and the pricing, which launches
       nothing); its topo order priced in bf16 by the DB: findings by
       code, the predicted step against the measured p50, the waste, the
       coverage; no HT910 against the doctor's buckets; the constant-feed
       check (reported);
    4. each HT902 fixture (f32 and bf16) through ``perfcheck_session``
       likewise: its claims fire and are checked against its measured
       ``compute`` bucket, no HT910; and its forward GEMM's priced share
       against the share aligning its dims measurably saves
       (``measure_padding_share``): at most ``SOUND_FACTOR`` times it;
    5. ``ab_bucketed_allreduce`` between two thread ranks on the card:
       predicted and measured within ``AB_TOLERANCE`` (a second try with
       more reps, as the test does);
    6. ``python -m hetu_tpu_torch.analysis.efficiency --costdb <db>`` over
       the zoo and ``python -m hetu_tpu_torch.analysis.perfcheck``, in
       process: both exit 0.

    Returns (line, the traced session's launch counts). ``device``
    rehearses the phase on the CPU at small widths (its launch checks
    then fail: the plain versions count nothing)."""
    import shutil
    import tempfile
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import analysis
    from hetu_tpu_torch.analysis import efficiency, perfcheck
    from hetu_tpu_torch.graph.autodiff import find_topo_sort
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import flash_attention as fa
    from hetu_tpu_torch.profiler import profile_ops
    from hetu_tpu_torch.telemetry import costdb

    t_phase = time.perf_counter()
    nodes, feeds = shared["nodes"], shared["feeds"]
    ids, labels = shared["ids"], shared["labels"]
    batch, seq = tuple(feeds[ids].shape)
    feed_shapes = {ids: ((batch, seq), np.int64),
                   labels: ((batch, seq), np.int64)}
    layers = sum(n.op_type == "FlashAttentionOp"
                 for n in find_topo_sort(nodes))
    tmp = tempfile.mkdtemp(prefix="efficiency_")
    db_path = os.path.join(tmp, "costdb.json")
    saved = os.environ.get("HETU_COSTDB")
    os.environ["HETU_COSTDB"] = db_path
    timing, faults = {}, []
    try:
        # 1. the CostDB, measured here
        db = costdb.CostDB(db_path)
        t = time.perf_counter()
        swept = costdb.comm_microbench(db, sizes=AUTOPLAN_SIZES, reps=3,
                                       device=device, ranks=AUTOPLAN_RANKS)
        timing["comm_microbench_s"] = time.perf_counter() - t
        # each graph profiled twice, the second (warm) pass into the DB:
        # an op's first call in the process pays its kernels' module
        # load and cuBLAS's heuristics, which no step after it pays
        t = time.perf_counter()
        fixtures = {dt: _ht902_fixture(ht, dt) for dt in EF_FIXTURES}
        profiled = {}
        for name, graph, dtype, graph_feeds in (
                ("session", nodes, "bfloat16", feeds),
                *((f"fixture_{dt}", g, dt, {})
                  for dt, g in fixtures.items())):
            exe = ht.Executor(graph, device=device,
                              dtype=_session_dtype(torch, dtype))
            cold = profile_ops(exe, graph_feeds, printout=False)
            warm = profile_ops(exe, graph_feeds, costdb=db, printout=False)
            profiled[name] = {"ops": len(warm),
                              "cold_ms": sum(ms for _, ms in cold),
                              "warm_ms": sum(ms for _, ms in warm)}
            exe.close()
            del exe
        _release(torch)
        timing["profile_ops_s"] = time.perf_counter() - t

        # 2. the card model, measured again
        t = time.perf_counter()
        model = efficiency.measure_card_model(device)
        timing["card_model_s"] = time.perf_counter() - t

        # 3. the session, validated, traced, priced and held to the doctor
        timed = analysis.analyze
        analyze_s = []

        def timed_analyze(*a, **kw):
            t0 = time.perf_counter()
            try:
                return timed(*a, **kw)
            finally:
                analyze_s.append(time.perf_counter() - t0)
        t = time.perf_counter()
        analysis.analyze = timed_analyze
        _build.reset_launch_counts()                # main path starts
        try:
            exe = _traced(torch, ht, nodes, os.path.join(tmp, "trace"),
                          device, dtype=torch.bfloat16, validate="error")
        finally:
            analysis.analyze = timed
        got = perfcheck.perfcheck_session(
            exe, nodes, lambda i: feeds, feed_shapes=feed_shapes,
            steps=EF_STEPS, costdb=db)
        if device != "cpu":
            torch.cuda.synchronize()
        launches = dict(_build.launch_counts)       # main path ends
        timing["session_s"] = time.perf_counter() - t
        report = exe.config.analysis_report
        losses, step_ms = exe.losses, exe.step_ms
        _untrace(exe)
        del exe
        _release(torch)
        static, buckets = got["static"], got["buckets"]
        sound = _ht910(got["report"])
        dynamic = [f for f in got["report"].findings if f.code != "HT910"]
        step_p50 = float(np.median(step_ms[1:]))
        total_ms = sum(got["op_ms"].values())
        waste_ms = sum(f.data.get("estimated_ms_per_step", 0.0)
                       for f in static.findings if f.code != "HT908")
        coverage = {s: sum(v == s for v in got["sources"].values())
                    for s in ("measured", "flops_scaled", "cold_start")}

        # 4. the HT902 fixtures: claims the card's model makes, held to the
        # measured compute bucket and to the measured saving of aligning
        fixture_lines = {}
        for dt, graph in fixtures.items():
            t = time.perf_counter()
            exe = _traced(torch, ht, graph, os.path.join(tmp, dt), device,
                          dtype=_session_dtype(torch, dt))
            f_got = perfcheck.perfcheck_session(exe, graph, lambda i: {},
                                                steps=EF_STEPS, costdb=db)
            _untrace(exe)
            del exe
            _release(torch)
            m, k, n = EF_FIXTURES[dt]
            share = efficiency.measure_padding_share(
                m, k, n, getattr(torch, dt), device)
            fixture_lines[dt] = {
                "widths": EF_FIXTURES[dt], "checked": f_got["checked"],
                "claims": [{"node": f.node,
                            "waste_frac": f.data["waste_frac"],
                            "estimated_ms_per_step":
                                f.data["estimated_ms_per_step"],
                            "source": f.data["source"]}
                           for f in f_got["static"].findings
                           if f.code == "HT902"],
                "buckets_ms_per_step": f_got["buckets"],
                "ht910": [str(f) for f in _ht910(f_got["report"])],
                "padding_share": share,
                "seconds": time.perf_counter() - t}
        timing["fixtures_s"] = sum(v["seconds"]
                                   for v in fixture_lines.values())

        # 5. the HT904 A/B between two thread ranks
        t = time.perf_counter()
        ab_tries = []
        for reps in (8, 12):
            ab = perfcheck.ab_bucketed_allreduce(reps=reps, device=device)
            ratio = (ab["measured_ms"] / ab["predicted_ms"]
                     if ab["predicted_ms"] > 0 else None)
            ab_tries.append(dict(ab, ratio=ratio))
            if ratio is not None and ab["measured_ms"] > 0 and \
                    1 / perfcheck.AB_TOLERANCE <= ratio \
                    <= perfcheck.AB_TOLERANCE:
                break
        timing["ab_s"] = time.perf_counter() - t

        # 6. both CLIs, in process
        clis = {}
        for name, main, argv in (
                ("efficiency", efficiency.main, ["--costdb", db_path]),
                ("perfcheck", perfcheck.main,
                 [] if device != "cpu" else ["--device", "cpu"])):
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out, \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = main(argv)
            clis[name] = {"rc": rc, "seconds": time.perf_counter() - t,
                          "out": out.getvalue()[-600:]}
    finally:
        if saved is None:
            os.environ.pop("HETU_COSTDB", None)
        else:
            os.environ["HETU_COSTDB"] = saved
        shutil.rmtree(tmp, ignore_errors=True)

    n_ref = len(shared["unvalidated"])
    want = _route_counts((fa.K2, fa.K3, fa.K4), (fa.K1,), layers * EF_STEPS)
    got_launches = {k: launches.get(k, 0) for k in want}
    ab = ab_tries[-1]
    line = {"card": card, "model": "gpt2-small", "batch": batch,
            "seq": seq, "dtype": "bfloat16", "optimizer": "Adam",
            "validate": "error", "steps": EF_STEPS,
            "wall_s": time.perf_counter() - t_phase, "timing_s": timing,
            "costdb": {"swept": swept, "entries": len(db),
                       "profiled": profiled,
                       "curves": {k: db.curve(k) for k in ("h2d", "d2h",
                                                           "allreduce")}},
            "card_model": {"granule": model["granule"],
                           "module_granule": efficiency._GRANULE,
                           "tflops": model["tflops"],
                           "module_tflops": efficiency._GEMM_TFLOPS,
                           "copy": model["copy"],
                           "module_dram_gbps": efficiency._DRAM_GBPS,
                           "matmul_ms": model["matmul_ms"]},
            "analyze_s": analyze_s, "report_codes": _codes(report.findings),
            "report_errors": len(report.errors),
            "losses": losses, "unvalidated_losses": shared["unvalidated"],
            "launches": got_launches, "step_ms": step_ms,
            "step_ms_p50": step_p50,
            "static": {"codes": _codes(static.findings),
                       "findings": [str(f) for f in static.findings[:8]],
                       "total_predicted_ms": total_ms,
                       "predicted_over_measured": total_ms / step_p50,
                       "predicted_waste_ms": waste_ms,
                       "coverage": coverage,
                       "priced_ops": len(got["op_ms"])},
            "buckets_ms_per_step": buckets,
            "doctor_step_wall_ms": (got["attribution"] or {}).get(
                "step_wall_ms"),
            "claims_checked": got["checked"], "ht910": len(sound),
            "ht910_findings": [str(f) for f in sound[:5]],
            "dynamic": [str(f) for f in dynamic],
            "fixtures": fixture_lines, "ab": ab_tries, "clis": clis}
    if report.errors:
        faults.append(f"errors in the report: {report.to_text()}")
    if losses[:n_ref] != shared["unvalidated"]:
        faults.append("traced losses differ from the unvalidated")
    if not all(np.isfinite(losses)):
        faults.append("losses not finite")
    if got_launches != want:
        faults.append(f"launches {got_launches}, want {want}")
    if sound:
        faults.append(f"HT910: {len(sound)} on the session")
    if not buckets:
        faults.append("the doctor measured no bucket")
    for dt, f in fixture_lines.items():
        share = f["padding_share"]
        if f["ht910"] or not f["claims"] or f["checked"] == 0:
            faults.append(f"the {dt} fixture: {len(f['claims'])} HT902 "
                          f"claims, {f['checked']} checked, HT910 "
                          f"{f['ht910']}")
        if share["priced_share"] > perfcheck.SOUND_FACTOR * \
                share["measured_share"]:
            faults.append(f"the {dt} fixture prices "
                          f"{share['priced_share']:.3f} of its GEMM's time, "
                          f"aligning it saves "
                          f"{share['measured_share']:.3f}")
    ratio = ab["ratio"]
    if not (ab["predicted_ms"] > 0 and ab["measured_ms"] > 0
            and ratio is not None
            and 1 / perfcheck.AB_TOLERANCE <= ratio
            <= perfcheck.AB_TOLERANCE):
        faults.append(f"A/B outside {perfcheck.AB_TOLERANCE}x: {ab_tries}")
    bad = {k: v["rc"] for k, v in clis.items() if v["rc"] != 0}
    if bad:
        faults.append(f"CLI exit codes {bad}")
    if faults:
        raise AssertionError(f"efficiency_train: {faults}: {line}")
    return line, launches


def preflight_job(card, seed):
    """``preflight_job``: ``python -m hetu_tpu_torch.launcher -c <2
    workers> --preflight`` over ``telemetry_job``'s script (two GPipe
    stages of GPT-2-small, ``--telemetry-worker``): clean, it exits 0
    with ``graph verified clean`` and its JSON report; clean again with
    ``CUDA_VISIBLE_DEVICES=""`` (a preflight needs no card); with a back
    edge (a third block on worker0 after worker1's) it exits 121 with
    HT302 naming rank 0 and rank 1. No run spawns a worker: no rank's
    record appears; and the one preflight process of each leg exits
    with CUDA not initialized. The three run at once; each one's
    seconds."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    config = ("spmd: true\nnodes:\n  - host: localhost\n    workers: 2\n"
              "    chief: true\n")
    legs = {"clean": ({}, {}), "no_card": ({}, {"CUDA_VISIBLE_DEVICES": ""}),
            "back_edge": ({"back_edge": True}, {})}

    def run(name):
        extra, env_add = legs[name]
        out_dir = tempfile.mkdtemp(prefix=f"preflight_{name}_")
        cfg = os.path.join(out_dir, "cluster.yml")
        with open(cfg, "w") as f:
            f.write(config)
        spec = {"seed": seed, "out": out_dir, **extra}
        env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **env_add}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "hetu_tpu_torch.launcher", "-c", cfg,
             "--preflight", sys.executable,
             os.path.join(ROOT, "chip_smoke.py"), "--telemetry-worker",
             json.dumps(spec)], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=PF_JOB_TIMEOUT_S, stdin=subprocess.DEVNULL)
        wall = time.perf_counter() - t0
        text = proc.stdout + proc.stderr
        ranks = sorted(n for n in os.listdir(out_dir)
                       if n.startswith("rank_"))
        cuda = []
        for n in sorted(os.listdir(out_dir)):
            if n.startswith("preflight_"):
                with open(os.path.join(out_dir, n)) as f:
                    cuda.append(json.load(f)["cuda"])
        shutil.rmtree(out_dir, ignore_errors=True)
        report = None
        m = re.search(r"graph verified clean \(report: (\S+)\)", text)
        if m:
            with open(m.group(1)) as f:
                report = json.load(f)
            shutil.rmtree(os.path.dirname(m.group(1)), ignore_errors=True)
        return {"rc": proc.returncode, "seconds": wall,
                "worker_records": ranks, "cuda_initialized": cuda,
                "errors": None if report is None else report["errors"],
                "codes": sorted(set(re.findall(r"\[(HT\d+)\] error", text))),
                "ht302_names_both_ranks": bool(re.search(
                    r"\[HT302\][^\n]*rank 0[^\n]*rank 1", text)),
                "tail": text[-1500:]}

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(legs)) as pool:
        runs = dict(zip(legs, pool.map(run, legs)))
    wall = time.perf_counter() - t0
    faults = []
    for name in ("clean", "no_card"):
        r = runs[name]
        if r["rc"] != 0 or r["errors"] != 0:
            faults.append(f"{name}: exit {r['rc']}, report {r['errors']}")
    r = runs["back_edge"]
    if r["rc"] != 121 or "HT302" not in r["codes"] or \
            not r["ht302_names_both_ranks"]:
        faults.append(f"back_edge: exit {r['rc']}, codes {r['codes']}")
    if any(r["worker_records"] for r in runs.values()):
        faults.append("a preflight spawned a worker")
    if any(r["cuda_initialized"] != [False] for r in runs.values()):
        faults.append("a preflight initialized CUDA (or left no record)")
    line = {"card": card, "model": "gpt2-small",
            "layers": TEL_JOB_LAYERS, "stages": 2, "wall_s": wall,
            **{name: {k: v for k, v in r.items() if k != "tail"}
               for name, r in runs.items()}}
    if faults:
        raise AssertionError(f"preflight_job: {faults}: {line} "
                             f"{ {n: r['tail'] for n, r in runs.items()} }")
    return line


def ptxas_report(log_text):
    """Registers and spills of every kernel instantiation in one
    ``nvcc -Xptxas -v`` log, by ptxas's (mangled) entry name:
    [{"kernel": name, "registers": N, "spill_stores": B,
    "spill_loads": B}]."""
    out, cur = [], None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int,
                                                              m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
    return out


# the two sources of each kernel family, by route
SOURCES = {"fwd": {"tc": CSRC + "flash_fwd_tc.cu",
                   "simt": CSRC + "flash_fwd.cu"},
           "bwd": {"tc": CSRC + "flash_bwd_tc.cu",
                   "simt": CSRC + "flash_bwd.cu"}}


def _kernel_row(name, family, replaces, keys, paths, rows, library):
    """One kernel of the ``kernels`` line. ``paths`` is [(main path,
    its launch counts, its shape in ``rows``)]: ``launches`` sums the
    launch-count ``keys`` over the paths (``launches_by_path`` by route
    too), and the first path's row gives the top-level numbers and
    ``source`` (by its route); ``main_path_rows`` holds every path's."""
    reps = [next(r for r in rows if _is(r, rep)) for _, _, rep in paths]
    by_path = {path: {k: counts.get(k, 0) for k in
                      (*keys, *(f"{k}.{route}" for k in keys
                                for route in ("tc", "simt")))}
               for path, counts, _ in paths}
    rep = reps[0]
    main_rows = [
        {"path": path, "source": SOURCES[family][r["route"]],
         **{k: r[k] for k in ("b", "h", "s", "d", "dtype", "causal", "mask",
                              "route", "max_abs_err", "ms", "device_ms",
                              "host_ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "library_device_ms")}}
        for (path, _, _), r in zip(paths, reps)]
    return {"name": name, "route": "cuda",
            "source": SOURCES[family][rep["route"]],
            "replaces": replaces,
            "launches": sum(min(c[k] for k in keys) for c in by_path.values()),
            "launches_by_path": by_path,
            "shape": {k: rep[k] for k in ("b", "h", "s", "d", "dtype",
                                          "causal", "mask")},
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "library": library, "device_ms": rep["device_ms"],
            "library_device_ms": rep["library_device_ms"],
            "host_ms": rep["host_ms"], "kernel_route": rep["route"],
            "sources": SOURCES[family], "main_path_rows": main_rows,
            "checked_shapes": len(rows),
            "max_abs_err_all": _by_case(rows, "max_abs_err"),
            **({"row_rel_err": rep["row_rel_err"],
                "row_rel_err_all": _by_case(rows, "row_rel_err")}
               if "row_rel_err" in rep else {})}


def _by_case(rows, key):
    """The largest ``key`` over rows, by dtype (and route where the rows
    have one: "bfloat16/tc")."""
    out = {}
    for r in rows:
        case = "/".join(filter(None, (r["dtype"], r.get("route"))))
        out[case] = max(out.get(case, 0.0), r[key])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the traffic, the data and the kernel "
                         "inputs")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--fleet-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)     # ps_fleet's workers
    ap.add_argument("--pp-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)     # pp_fleet's workers
    ap.add_argument("--dp-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)     # dp_gpt's ranks
    ap.add_argument("--hybrid-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)     # hybrid_fleet's workers
    ap.add_argument("--tp-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)     # tp_gpt's ranks
    ap.add_argument("--pp-tp-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)     # pp_tp_gpt's ranks
    ap.add_argument("--sp-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)     # the sp passes' ranks
    ap.add_argument("--distgcn-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)     # distgcn's ranks
    ap.add_argument("--autoplan-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)     # autoplan's job ranks
    ap.add_argument("--telemetry-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)     # telemetry_job's ranks
    ap.add_argument("--health-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)     # health_job's ranks
    ap.add_argument("--watch-worker", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)     # fleet_job's ranks
    args = ap.parse_args(argv)
    if not os.path.isfile(os.path.join(ROOT, "hetu_tpu_torch", "ops",
                                       "csrc", "flash_fwd.cu")):
        log("hetu_tpu_torch is not beside chip_smoke.py: run it from a "
            "checkout of the repository")
        return 2
    sys.path.insert(0, ROOT)
    _reuse_weight_draws()
    if args.fleet_worker is not None:
        return fleet_worker(json.loads(args.fleet_worker))
    if args.pp_worker is not None:
        return pp_worker(json.loads(args.pp_worker))
    if args.dp_worker is not None:
        return dp_worker(json.loads(args.dp_worker))
    if args.hybrid_worker is not None:
        return hybrid_worker(json.loads(args.hybrid_worker))
    if args.tp_worker is not None:
        return tp_worker(json.loads(args.tp_worker))
    if args.pp_tp_worker is not None:
        return pp_tp_worker(json.loads(args.pp_tp_worker))
    if args.sp_worker is not None:
        return sp_worker(json.loads(args.sp_worker))
    if args.distgcn_worker is not None:
        return distgcn_worker(json.loads(args.distgcn_worker))
    if args.autoplan_worker is not None:
        return autoplan_worker(json.loads(args.autoplan_worker))
    if args.telemetry_worker is not None:
        return telemetry_worker(json.loads(args.telemetry_worker))
    if args.health_worker is not None:
        return health_worker(json.loads(args.health_worker))
    if args.watch_worker is not None:
        return watch_worker(json.loads(args.watch_worker))
    import torch
    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this smoke needs a GPU")
        return 1
    from hetu_tpu_torch.ops import _build
    from hetu_tpu_torch.ops import flash_attention as fa

    t_start = time.perf_counter()
    card = nvidia_smi_line()
    device = {"card": card, "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0]}
    log(f"device {device}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the serving path "
                             "keeps float32 products in float32")

    sources = ["flash_fwd", "flash_fwd_tc", "flash_bwd", "flash_bwd_tc"]
    # the parameter server's library (g++) builds beside the kernels
    from concurrent.futures import ThreadPoolExecutor
    from hetu_tpu_torch.ps import native_lib
    with ThreadPoolExecutor(1) as pool:
        t = time.perf_counter()
        ps_build = pool.submit(native_lib.build_lib)
        seconds = _build.build(sources)
        ps_build.result()
        seconds["libhetu_ps"] = time.perf_counter() - t
    ptxas = {name: ptxas_report(_build.build_log(name)) for name in sources}
    build = {"seconds": seconds, "ptxas": ptxas}
    log(f"build {build}")

    t = time.perf_counter()
    serve_line, serve_launches = serve(torch, args.seed, card)
    log(f"serve ({time.perf_counter() - t:.1f} s) {serve_line}")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    dense_line, dense_launches = serve_dense(torch, args.seed, card)
    log(f"serve_dense ({time.perf_counter() - t:.1f} s) {dense_line}")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    train_line, train_launches = train(torch, args.seed, card)
    log(f"train ({time.perf_counter() - t:.1f} s) {train_line}")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    init, pp_step1, pp_stash, pp_info = pp_references(torch, args.seed)
    log(f"pp references ({time.perf_counter() - t:.1f} s)")
    pp_lines, pp_launches, pp_fleet_refs = {}, {}, {}
    for schedule in ("gpipe", "1f1b"):
        t = time.perf_counter()
        pp_lines[f"pp_{schedule}"], pp_launches[schedule], ref = pp_pass(
            torch, schedule, card, args.seed, init, (pp_step1, pp_stash),
            train_line["step_ms_p50"])
        pp_fleet_refs[schedule] = (pp_lines[f"pp_{schedule}"]["losses"], ref)
        log(f"pp_{schedule} ({time.perf_counter() - t:.1f} s) "
            f"{pp_lines[f'pp_{schedule}']}")
    pp_lines["pp_1f1b"]["checks"]["stash"]["microbatch_losses"] = \
        pp_info["microbatch_losses"]
    pp_lines["pp_gpipe"]["checks"]["bf16_four_microbatches_vs_whole_batch"] \
        = pp_info["bf16_four_microbatches_vs_whole_batch"]
    del init
    torch.cuda.empty_cache()
    t = time.perf_counter()
    pp_lines["pp_fleet"] = pp_fleet_pass(card, args.seed, pp_fleet_refs)
    del pp_fleet_refs
    log(f"pp_fleet ({time.perf_counter() - t:.1f} s) {pp_lines['pp_fleet']}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    coll_lines, coll_launches = collective_pass(
        torch, card, args.seed, pp_lines["pp_gpipe"],
        train_line["step_ms_p50"])
    log(f"collective ({time.perf_counter() - t:.1f} s) {coll_lines}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    dp_lines, dp_launches, parity_ref = dp_pass(card, args.seed, train_line)
    log(f"dp ({time.perf_counter() - t:.1f} s) {dp_lines}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    dp_lines["dp_gpt_local"], dp_local_launches = dp_gpt_local(
        card, args.seed, train_line, dp_lines["dp_gpt"])
    log(f"dp_gpt_local ({time.perf_counter() - t:.1f} s) "
        f"{dp_lines['dp_gpt_local']}")
    t = time.perf_counter()
    tp_lines, tp_launches, gpt_ref = tp_pass(card, args.seed, train_line,
                                             parity_ref)
    log(f"tp ({time.perf_counter() - t:.1f} s) {tp_lines}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    pp_tp_lines, pp_tp_launches = pp_tp_pass(card, args.seed, train_line,
                                             tp_lines["tp_gpt"])
    log(f"pp_tp ({time.perf_counter() - t:.1f} s) {pp_tp_lines}")
    torch.cuda.empty_cache()

    bert_lines, bert_launches = {}, {}
    for name in BERT_PASSES:
        t = time.perf_counter()
        bert_lines[name], bert_launches[name] = bert_train(
            torch, args.seed, card, name)
        log(f"{name} ({time.perf_counter() - t:.1f} s) {bert_lines[name]}")
        torch.cuda.empty_cache()
    t = time.perf_counter()
    bert_lines["bert_example"], bert_ex_launches = bert_example(torch, card)
    log(f"bert_example ({time.perf_counter() - t:.1f} s) "
        f"{bert_lines['bert_example']}")
    t = time.perf_counter()
    zoo_line = runner_zoo(card)
    log(f"runner_zoo ({time.perf_counter() - t:.1f} s) {zoo_line}")
    t = time.perf_counter()
    sp_lines, sp_launches = sp_pass(card, args.seed, train_line,
                                    bert_lines["bert_long"], gpt_ref,
                                    parity_ref)
    del gpt_ref, parity_ref
    log(f"sp ({time.perf_counter() - t:.1f} s) {sp_lines}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    autoplan_line, autoplan_launches = autoplan_pass(card, args.seed,
                                                     train_line)
    log(f"autoplan ({time.perf_counter() - t:.1f} s) {autoplan_line}")
    torch.cuda.empty_cache()

    from hetu_tpu_torch import data
    cifar = data.cifar10()
    cnn_lines = {}
    for name in CNN_PASSES:
        t = time.perf_counter()
        cnn_lines[name] = cnn_train(torch, name, card, cifar)
        log(f"{name} ({time.perf_counter() - t:.1f} s) {cnn_lines[name]}")
        torch.cuda.empty_cache()
    del cifar
    t = time.perf_counter()
    cnn_lines["cnn_digits"] = cnn_digits(torch, card)
    log(f"cnn_digits ({time.perf_counter() - t:.1f} s) "
        f"{cnn_lines['cnn_digits']}")

    sparse_lines = {}
    for name in SPARSE_PASSES:
        t = time.perf_counter()
        sparse_lines[name] = sparse_pass(torch, name, card, args.seed)
        log(f"{name} ({time.perf_counter() - t:.1f} s) "
            f"{sparse_lines[name]}")
    ncf_line = sparse_lines.pop("ncf")
    t = time.perf_counter()
    ncf_hr_line = ncf_hr(torch, card)
    log(f"ncf_hr ({time.perf_counter() - t:.1f} s) {ncf_hr_line}")
    t = time.perf_counter()
    transformer_line = transformer_train(torch, card, args.seed)
    log(f"transformer ({time.perf_counter() - t:.1f} s) {transformer_line}")
    t = time.perf_counter()
    reverse_line = transformer_reverse(torch, card)
    log(f"transformer_reverse ({time.perf_counter() - t:.1f} s) "
        f"{reverse_line}")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    graph = gnn_graph()
    log(f"gnn graph ({time.perf_counter() - t:.1f} s): {graph[0].shape[0]} "
        f"nodes, {graph[0].nnz} entries")
    gnn_lines = {}
    for name in GNN_PASSES:
        t = time.perf_counter()
        gnn_lines[name] = gnn_pass(torch, name, card, graph)
        log(f"{name} ({time.perf_counter() - t:.1f} s) {gnn_lines[name]}")
    t = time.perf_counter()
    gnn_lines["spmm"] = spmm_compare(torch, card, graph)
    log(f"spmm ({time.perf_counter() - t:.1f} s) {gnn_lines['spmm']}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    gnn_lines.update(distgcn_pass(card, args.seed, graph, gnn_lines["gcn"]))
    log(f"distgcn ({time.perf_counter() - t:.1f} s) "
        f"{gnn_lines['distgcn']} {gnn_lines['distgcn_local']}")
    del graph
    t = time.perf_counter()
    gnn_lines["gcn_example"] = gcn_example(torch, card)
    log(f"gcn_example ({time.perf_counter() - t:.1f} s) "
        f"{gnn_lines['gcn_example']}")
    t = time.perf_counter()
    gnn_lines["gnn_sampled"] = gnn_sampled(torch, card)
    log(f"gnn_sampled ({time.perf_counter() - t:.1f} s) "
        f"{gnn_lines['gnn_sampled']}")
    torch.cuda.empty_cache()

    ps_lines = ps_passes(torch, card, args.seed)
    torch.cuda.empty_cache()
    ps_lines["ps_fleet"] = ps_fleet_pass(card, args.seed)
    t = time.perf_counter()
    ps_lines["hybrid_fleet"] = hybrid_fleet_pass(card, args.seed)
    log(f"hybrid_fleet ({time.perf_counter() - t:.1f} s) "
        f"{ps_lines['hybrid_fleet']}")

    import shutil
    tel_lines = {}
    t = time.perf_counter()
    (tel_lines["telemetry_train"], tel_train_launches,
     tel_lines["health_train"], health_launches, tdir) = telemetry_train(
        torch, args.seed, card)
    log(f"telemetry_train and health_train ({time.perf_counter() - t:.1f} "
        f"s) {tel_lines['telemetry_train']} {tel_lines['health_train']}")
    t = time.perf_counter()
    try:
        tel_lines["doctor_train"] = doctor_train(
            tdir, tel_lines["telemetry_train"])
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    log(f"doctor_train ({time.perf_counter() - t:.1f} s) "
        f"{tel_lines['doctor_train']}")
    t = time.perf_counter()
    tel_lines["telemetry_serve"], tel_serve_launches, tdir = \
        telemetry_serve(torch, args.seed, card)
    log(f"telemetry_serve ({time.perf_counter() - t:.1f} s) "
        f"{tel_lines['telemetry_serve']}")
    t = time.perf_counter()
    try:
        tel_lines["doctor_serve"] = doctor_serve(
            tdir, tel_lines["telemetry_serve"])
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    log(f"doctor_serve ({time.perf_counter() - t:.1f} s) "
        f"{tel_lines['doctor_serve']}")
    t = time.perf_counter()
    tel_lines["telemetry_job"], tel_job_launches, tdir = telemetry_job(
        card, args.seed)
    log(f"telemetry_job ({time.perf_counter() - t:.1f} s) "
        f"{tel_lines['telemetry_job']}")
    t = time.perf_counter()
    try:
        tel_lines["doctor_job"] = doctor_job(tdir, tel_lines["telemetry_job"])
    finally:
        shutil.rmtree(os.path.dirname(tdir), ignore_errors=True)
    log(f"doctor_job ({time.perf_counter() - t:.1f} s) "
        f"{tel_lines['doctor_job']}")
    t = time.perf_counter()
    tel_lines["health_job"] = health_job(card, args.seed)
    log(f"health_job ({time.perf_counter() - t:.1f} s) "
        f"{tel_lines['health_job']}")
    t = time.perf_counter()
    tel_lines["fleet_job"], fleet_launches = fleet_job(
        card, args.seed, pp_lines["pp_fleet"])
    log(f"fleet_job ({time.perf_counter() - t:.1f} s) "
        f"{tel_lines['fleet_job']}")

    pf_lines = {}
    t = time.perf_counter()
    pf_lines["preflight_train"], pf_launches, pf_shared = preflight_train(
        torch, args.seed, card)
    log(f"preflight_train ({time.perf_counter() - t:.1f} s) "
        f"{pf_lines['preflight_train']}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    pf_lines["numerics_train"], nt_launches = numerics_train(
        torch, card, pf_shared)
    log(f"numerics_train ({time.perf_counter() - t:.1f} s) "
        f"{pf_lines['numerics_train']}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    pf_lines["efficiency_train"], ef_launches = efficiency_train(
        torch, card, pf_shared)
    del pf_shared
    log(f"efficiency_train ({time.perf_counter() - t:.1f} s) "
        f"{pf_lines['efficiency_train']}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    pf_lines["preflight_job"] = preflight_job(card, args.seed)
    log(f"preflight_job ({time.perf_counter() - t:.1f} s) "
        f"{pf_lines['preflight_job']}")

    t = time.perf_counter()
    k1_rows = check_flash_fwd(torch, args.seed)
    train_rows = check_flash_train_kernels(
        torch, args.seed, (autoplan_launches["train_rep"],))
    faults = check_catches_faults(torch, args.seed)
    log(f"kernels checked ({time.perf_counter() - t:.1f} s) {faults}")

    t = time.perf_counter()
    cross = crossover(torch, args.seed)
    log(f"crossover ({time.perf_counter() - t:.1f} s) {cross}")

    pallas = "hetu_tpu/ops/pallas_attention.py:"
    sdpa = "torch.ops.aten._scaled_dot_product_flash_attention"
    eff = ("; with BERT's padding mask (bert_long) "
           "torch.ops.aten._scaled_dot_product_efficient_attention")
    bias = " (memory-efficient attention, the mask as a [B, H, S, S] bias)"
    fwd_paths = [("serve", serve_launches, K1_REP),
                 ("serve_dense.prefill", dense_launches["prefill"],
                  K1_PREFILL_REP),
                 ("serve_dense.session", dense_launches["session"],
                  K1_SESSION_REP),
                 ("bert", bert_launches["bert"], BERT_K1_REP),
                 ("bert_example", bert_ex_launches, BERT_K1_REP),
                 ("autoplan.profile", autoplan_launches["profile"],
                  K1_PROFILE_REP),
                 ("telemetry_serve", tel_serve_launches, K1_TEL_SERVE_REP)]
    train_paths = [("train", train_launches, TRAIN_REP),
                   ("bert_long", bert_launches["bert_long"], BERT_LONG_REP),
                   ("pp_gpipe", pp_launches["gpipe"], PP_REP),
                   ("pp_1f1b", pp_launches["1f1b"], PP_REP),
                   ("collective_gpt", coll_launches["main"], PP_REP),
                   ("collective_gpt.interleaved",
                    coll_launches["interleaved"], PP_REP),
                   ("dp_gpt", dp_launches, DP_REP),
                   ("dp_gpt_local", dp_local_launches, DP_REP),
                   ("tp_gpt", tp_launches, TRAIN_REP),
                   ("pp_tp_gpt", pp_tp_launches, PP_REP),
                   ("sp_gpt.ring", sp_launches["ring.diagonal"],
                    SP_RING_DIAG_REP),
                   ("sp_gpt.ring.squares", sp_launches["ring.squares"],
                    SP_RING_SQUARE_REP),
                   ("sp_gpt.ulysses", sp_launches["ulysses"],
                    SP_ULYSSES_REP),
                   ("sp_bert_long", sp_launches["bert_long"], SP_BERT_REP),
                   ("autoplan.train", autoplan_launches["train"],
                    autoplan_launches["train_rep"]),
                   ("telemetry_train", tel_train_launches, TRAIN_REP),
                   ("health_train", health_launches, TRAIN_REP),
                   ("preflight_train", pf_launches, TRAIN_REP),
                   ("numerics_train", nt_launches, TRAIN_REP),
                   ("efficiency_train", ef_launches, TRAIN_REP),
                   *((f"telemetry_job.rank{r}", c, PP_REP)
                     for r, c in enumerate(tel_job_launches)),
                   *((f"fleet_job.rank{r}", c, PP_REP)
                     for r, c in enumerate(fleet_launches))]
    kernels = {"kernels": [
        _kernel_row("flash_fwd", "fwd", pallas + "346", (fa.K1,),
                    fwd_paths, k1_rows,
                    "torch.nn.functional.scaled_dot_product_attention "
                    "(with the same additive mask)"),
        _kernel_row("flash_fwd_lse", "fwd", pallas + "333", (fa.K2,),
                    train_paths, train_rows["K2"],
                    sdpa + " (bf16 without mask)" + eff + bias),
        _kernel_row("flash_bwd_dkv", "bwd", pallas + "514", (fa.K3,),
                    train_paths, train_rows["K3"],
                    sdpa + "_backward (computes dq, dk and dv: K3 and K4 "
                    "together; bf16 without mask)" + eff + "_backward"
                    + bias),
        _kernel_row("flash_bwd_dq", "bwd", pallas + "526", (fa.K4,),
                    train_paths, train_rows["K4"],
                    "none alone: see flash_bwd_dkv"),
        # K3 + K4 as the path calls them: one flash_attention_bwd, the
        # counterpart of the reference's entry that launches both
        _kernel_row("flash_bwd_pair", "bwd", pallas + "539",
                    (fa.K3, fa.K4), train_paths, train_rows["pair"],
                    sdpa + "_backward (bf16 without mask)" + eff
                    + "_backward" + bias),
    ]}
    shapes = {"kernel_shapes": {"flash_fwd": k1_rows, **{
        row["name"]: train_rows[key] for key, row in
        zip(("K2", "K3", "K4", "pair"), kernels["kernels"][1:])}}}
    lines = [{"device": device}, {"build": build}, shapes,
             {"check_faults": faults}, {"serve": serve_line},
             {"serve_dense": dense_line}, {"train": train_line},
             *({name: line} for name, line in pp_lines.items()),
             *({name: line} for name, line in coll_lines.items()),
             *({name: line} for name, line in dp_lines.items()),
             *({name: line} for name, line in tp_lines.items()),
             *({name: line} for name, line in pp_tp_lines.items()),
             *({name: line} for name, line in bert_lines.items()),
             {"runner_zoo": zoo_line},
             *({name: line} for name, line in sp_lines.items()),
             {"autoplan": autoplan_line},
             *({name: line} for name, line in cnn_lines.items()),
             {"ctr": sparse_lines}, {"ncf": ncf_line}, {"ncf_hr": ncf_hr_line},
             {"transformer": transformer_line},
             {"transformer_reverse": reverse_line},
             *({name: line} for name, line in gnn_lines.items()),
             *({name: line} for name, line in ps_lines.items()),
             *({name: line} for name, line in tel_lines.items()),
             *({name: line} for name, line in pf_lines.items()),
             {"crossover": cross}, kernels,
             {"wall_s": time.perf_counter() - t_start}]
    texts = [json.dumps(line) for line in lines]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(texts + [card]) + "\n")
    for text in texts:
        print(text, flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
