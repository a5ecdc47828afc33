#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. print the card's name and power limit (``nvidia-smi``); fail without CUDA;
2. build every kernel and the ring's host code from
   ``flink_tensorflow_tpu_torch/csrc`` (one compiler per source: nvcc
   for a ``.cu``, the host C++ compiler for ``spsc_ring.cpp``, started
   together) and print the build seconds;
3. hold K1 (flash attention) against its plain PyTorch version on the
   card at the serving shape and at larger shapes, and time kernel, plain
   version and ``scaled_dot_product_attention`` (a yardstick only, where
   Tk > 0) beside the bound of the route K1 takes (tensor cores for
   bf16/f16, 3xTF32 for f32; f32 rows also carry the FMA bound);
4. serve the repo's serving-bench configuration (char transformer
   64 wide x 3 layers, 96 requests from ``RandomState(11)``) through the
   port's subtask loop on the card, count K1's launches, and hold every
   session's tokens against a CPU run of the port on the same weights;
5. run the Inception-v3 streaming cell (``models/inception_cell.py``, the
   JAX package's Inception bench: 2048 uint8 299x299x3 records, batch
   128, pipeline depth 6, 1000 classes, bf16) through the port's
   ``StreamExecutionEnvironment -> count_window -> ModelWindowFunction``
   on the card; check that every id comes back once, that each label and
   score equals a direct call of the same module on the card over the
   same 16 batches, and that 4 records through the CPU's bf16 path and
   its f32 plain path match the card's bf16 and f32 forwards; print
   records/s (steady, and over the whole job), latency
   percentiles, H2D bytes per batch, batches, padded records, and init
   and warmup seconds, each beside the card line;
6. serve the same cell, on phase 4's weights, through the pipeline users
   call: ``StreamExecutionEnvironment -> from_collection ->
   key_by(session_id) -> serving.continuous_batching -> sink`` on the
   port's local executor (``serving/cell.py:keyed_job``), three ways:
   (a) uninterrupted at parallelism 1, tokens equal to phase 4's, seconds
   and tokens/s beside phase 4's; (b) with count-based checkpoints every 8
   records and a tap that raises once after half the tokens, under
   ``RestartStrategy(max_restarts=1)``: one restart, tokens equal to (a),
   restored sessions resumed from checkpointed caches, K1's launches equal
   to layers x (prefill batches of both attempts + warmup prefills x 2),
   and no KV pool of the failed attempt held when the restart opens its
   own (device memory before each attempt and after the restart, printed);
   (c) the same crash at parallelism 2 without a restart strategy, then a
   restore of the latest checkpoint at parallelism 3: the union of both
   runs' tokens equal to (a);
7. train on the stream (``functions/train_cell.py``; no TPU kernel lies on
   this path, K1 must launch 0 times in it):
   resnet-train, ResNet-50 at full width (224 px, 1000 classes, stages
   (3, 4, 6, 3), width 64, bf16) through ``count_window(32) ->
   DPTrainWindowFunction(adam(1e-3))`` on a ``{"data": 1}`` mesh, 24
   steps: (a) its losses and final params equal to a direct loop of
   ``make_dp_train_step`` over the same batches on the card, bit for bit;
   one SGD step at batch 4, its gradient and statistics' update on the
   card against the CPU's plain path in f32 (TF32 off) and in bf16;
   records/s, step time, losses, peak device memory, and the profiler's
   busy share and launches per step; widedeep-online, Wide&Deep on
   ``key_by(user) -> OnlineTrainFunction(adam(1e-2), mini_batch=32,
   steps_per_dispatch=16)`` over 8192 events: (b) the loss falls within
   each user's run of steps on average, the step count is the sum over
   users of ceil(n / 32), and with checkpoints every 1024 events the
   first 16 losses and checkpoint 1's TrainState equal a CPU run's; (c) with
   checkpoints every 1024 events and a tap that raises once after 3000
   events (and checkpoint 2) under ``RestartStrategy(max_restarts=1)``:
   one restart, the final TrainState equal to the same job checkpointed
   without the crash, the step count equal to (b)'s, host tensors only in
   the checkpoint, and the restart opening with the failed attempt's
   device memory released;
8. stream inference on the two other inference configurations and the
   single-record map (no TPU kernel lies on these paths; K1 must launch 0
   times in each): (a) mnist-lenet (``models/lenet_cell.py``: 16,384 f32
   28x28x1 records, ``count_window(512) -> ModelWindowFunction(fixed_batch
   512)``, LeNet in bf16); (b) bilstm (``models/bilstm_cell.py``: 4,096
   records of 4-192 tokens, ``count_window(64)``, vocab 20,000, hidden
   256), after timing and holding both LSTM routes (cuDNN f32 on
   bf16-rounded weights, cuDNN bf16) against the plain step loop on the
   card and choosing the closer one unless it is more than twice as slow;
   (c) inception-map: phase 5's model saved as a port bundle and 1,024 of
   its records through ``rebalance() -> map(ModelMapFunction(<bundle>,
   micro_batch=32), parallelism=2)``, each subtask loading the bundle at
   ``open()``.  Each: every id once, labels (and prob or score) equal to a
   direct call of the same module on the card over the same batches, a few
   records held to the CPU's bf16 and f32 paths; bilstm also holds a record
   alone at its own bucket to the same record in a batch padded to 256;
   records/s (steady and over the job), latency p50/p95, H2D bytes per
   batch and seconds, each beside the card line;
9. chaining and device-resident dataflow (no TPU kernel on these paths;
   K1 must launch 0 times), each comparison run A B B A in one process:
   (a) phase 5's cell chained (the default: the sink fused behind the
   window, 2 threads and 1 gate) and with ``configure(chaining=False)``
   (3 and 2), labels and scores equal bit for bit to phase 5's direct
   calls in every run, no queue puts on a fused edge, records/s side by
   side; (b) phase 8 (c)'s bundle at parallelism 1 with no
   ``rebalance()``, chained (the sink behind the map, which is cut from
   the source) and unchained, equal to direct calls over the same 32s;
   (c) ``map(ModelMapFunction(inception, outputs=("logits",))) =>
   map(DeviceMapFunction(softmax + top-1)) -> sink`` with
   ``device_resident`` on and off: on, one H2D (the model's) and one D2H
   (at the sink) per micro-batch and ``fetch_elided_batches`` equal to
   the batches; labels equal, scores within ``CHAIN_SCORE_TOL``, and on
   equal to direct calls; (d) ``bench.py:bench_deviceres`` non-smoke
   (resmlp, dim 4096 f32, 512 records from a Poisson ``PacedSource`` at
   400 records/s, micro-batch 8, two chained models) on and off: one H2D
   and one D2H per micro-batch on, two off, outputs equal bit for bit and
   to the CPU's f32; H2D/D2H counts and bytes and e2e latency p50/p95
   from each record's scheduled arrival printed for each arm;
10. paged KV serving (``serving/cell.py:paged_cell``) through the keyed
   pipeline at the serving cell's full width, every pool on the card and
   every run's K1 launches equal to layers x (prefill batches + warmup
   prefills): (a) ``paged_kv=True, page_tokens=16`` with the default 32
   pages against the dense keyed arm, A B B A, tokens equal to phase 4's,
   the step H2D within the token, length and table vectors; (b) the
   oversubscription ladder, 4 seats and a 64-token budget, ``hbm_pages =
   max(4, demand // f)`` for f in 8, 16, 32, every demotion spilled to
   disk, each rung's tokens equal to a dense-roomy arm (same seats and
   buckets, equal to phase 4's), the 8x rung spilling and reviving from
   disk; (c) prefix sharing on and off on two fleets (a shared 32-token
   prefix; one 24-token prompt at 2 seats, which must split a page),
   tokens equal; (d) ``TestPagedFailover``'s schedule at full width (a
   crash at the 120th event under ``RestartStrategy(max_restarts=2)``,
   checkpoints every 4 records, tokens equal to the uninterrupted paged
   run, itself equal to a dense run, and a revival from disk), then
   phase 6 (c)'s 2 -> 3 rescale with (a)'s config, tokens equal to phase
   4's; tokens/s, TTFT and decode-step p50/p95, ``step_h2d_bytes`` and
   every ``kv_*`` counter printed per run;
11. inception-event-time: phase 5's 2,048 records as 8 cameras at 32
   frames/s (record i: camera i % 8, event time (i // 8) / 32 s),
   shuffled within blocks of 64 (``RandomState(1)``), through
   ``assign_timestamps(out_of_orderness_s=0.25, watermark_every=128)``
   (no record K1 lies on this path; it must launch 0 times):
   (a) ``key_by(camera).time_window(1.0).apply(ModelWindowFunction(
   fixed_batch=32, pipeline_depth=3))`` (64 windows of 32), then
   ``time_window_all(1.0)`` counting labels with ``late_tag="late"``:
   labels and scores equal to direct calls on each window's 32 records in
   arrival order bit for bit, every result stamped with its own window's
   end, no late record, each histogram equal to a host recount; (b)
   ``map(ModelMapFunction(<bundle>, micro_batch=128, idle_flush_s=1.0))
   -> key_by(camera).time_window(1.0)`` counting top labels: each record
   keeps its own event time, none is late, labels and scores equal to
   direct calls on the map's micro-batches; (c) in the same job, (b)'s
   predictions joined with a truth stream (``from_collection`` of ``(id,
   label, event time)``, labels from those direct calls) by
   ``join().where(id).equal_to(id).window(1.0)``, then
   ``key_by(camera).reduce``: 2,048 pairs, every one agreeing; (d) (a)'s
   model job into ``ExactlyOnceRecordFileSink`` with checkpoints every 256
   records and one crash after checkpoint 2 under
   ``RestartStrategy(max_restarts=1)``: ``read_committed`` equal to (a)'s
   results, each record once; records/s, seconds and watermarks per arm;
12. the transfer plane (no TPU kernel lies on this path; K1 must launch 0
   times): (a) the Inception cell (phase 5's model and records) at the
   reference bench's settings, ``transfer_lanes=6``, through the ring
   (the default), with ``use_ring=False``, and through the ring at one
   lane: labels and scores equal to phase 5's direct calls bit for bit
   in every arm, every id once, the ring arms firing all 16 batches
   through the ring with a 274,661,376-byte page-locked arena; records/s
   (steady and over the job), assemble and H2D seconds, ring batches,
   wraparound copy-outs and pinned bytes per arm; (b) mnist-lenet with
   ``wire_dtype`` f32, bf16 and int8: H2D bytes per batch exactly
   1,605,632, 802,816 and 401,408 + 4, labels equal to a direct call on
   the card on the inputs rounded host-side as the wire rounds them, and
   the count of labels that differ from the f32 arm; (c) the bench's
   open loop (``models/inception_cell.py``): capacity at windows of 2
   over 24 windows, then a Poisson ``PacedSource`` at half of it into
   ``count_window(16, latency_budget_s=max(0.3, 1.5 x the one-record
   round trip)) -> ModelWindowFunction(BucketLadder.up_to(16),
   pipeline_depth=3, idle_flush_s=0.002, stamp_stages=True)`` over 512
   records: every id once, each batch equal to a direct call at its
   padded bucket bit for bit, p50/p95/p99 latency from the scheduled
   arrival, the median of each stage and the window sizes printed;
13. parallelism and frozen graphs (``parallel/``, ``models/loaders.py``):
   (a) resnet-train (phase 7's cell) through ``DPTrainWindowFunction`` on
   ``{"data": 1}`` over a real NCCL group of one
   (``multihost.initialize``): losses and final params equal to phase 7
   (a)'s bit for bit, all-reduces per step counted (2 + 2 per batch
   norm), step time and records/s beside phase 7's; (b) two processes
   (``functions/train_cell.py --backend gloo``) sharing ``cuda:0``, 16
   records each per step: 8 steps held to (a)'s first 8 (losses 1e-2
   relative; what the steps changed, by norm, within 1.5x the one-card
   noise floor of the same steps on reordered rows), and 1 step held to
   (a)'s first (losses, 2e-3 absolute on the running statistics, and
   1.5x the noise floor by norm), with a control of 1 step with batch
   statistics local to each rank (``--local-batch-stats``) that must
   miss the params' and the statistics' bars;
   seconds per step, "2 ranks sharing one card, not a multi-card
   number"; (c) ``ring_attention`` and ``ulysses_attention`` over the
   group of one, then the ring's block step (``ring_flash_block``) for 8
   simulated ranks fed in ring order and Ulysses' per-rank K1 call on 8
   head slices, at B 1, H 8, T 16,384, D 64 bf16 causal and D 128 f16:
   K1 launched exactly 36 / 64 and 8 / 8 times, every output held to the
   plain path at phase 3's tolerances, K1's ms per block (with
   ``return_lse``) beside the plain path's and its bound; (d) phase 5's
   Inception frozen at batch 128 on the card (``freeze_method``), loaded
   (``GraphLoader``), 512 of phase 5's records through ``count_window(128)
   -> GraphWindowFunction``: labels and scores equal to phase 5's direct
   calls bit for bit (or, if export picked other kernels, equal to the
   program's direct calls and within the bf16 bar of the module), every
   id once, K1 0 launches; freeze and load seconds, forward ms and job
   records/s beside ``ModelWindowFunction``'s; the phase's seconds;
14. split sources and the cohort supervisor (``sources/``,
   ``parallel/supervisor.py``): (a) the reference serving bench's
   open-loop arms (``serving/cell.py:open_loop_arm``; ``bench.py:
   bench_serving``) on phase 4's weights and 96 requests, fixed arm first,
   at 400 and 1,200 requests/s: ``PacedSplitSource(num_splits=1,
   start_delay_s=1.5) -> count_window(8, timeout_s=0.3) ->
   FixedWindowGenerateFunction`` (the window fused into the split
   source's chain) and ``-> key_by -> continuous_batching``; every
   session served once with phase 4's tokens, K1's launches equal to
   layers x (prefill batches + warmup prefills) in each arm; each arm's
   row (tokens/s from the first scheduled arrival to the last emit, TTFT
   and per-token p50/p95 from ``sched_ts``, the continuous arm's
   counters) and the bench's ``continuous_dominates_*`` flags printed,
   nothing about speed asserted; (b) ``bench.py:bench_filesplit`` at
   scale 48 (files of 576, 192, 96 and 6 x 48 records,
   ``source_throttle_s`` 0.0005, parallelism 4 -> rebalance -> identity
   map -> sink; host-only): every id once, records/s and each reader's
   ``splits_completed``; (c) phase 13 (b)'s two gloo ranks under a
   ``CohortSupervisor`` (``train_cell --checkpoint-root``), 8 steps,
   checkpoints every 2: uninterrupted, and with the last rank exiting at
   step 5 on attempt 0: 2 attempts, no rank left alive, both ranks
   restored from checkpoint 2 (the newest both hold), steps 5-8's losses
   and the final params and batch statistics equal to the uninterrupted
   run's bit for bit, K1 0 launches; step times and the card's memory in
   use after the supervisor returned;
15. the distributed record plane (``core/{reactor,shuffle,distributed}.py``;
   host-side, so K1 must launch 0 times): (a) ``bench.py:bench_shuffle``'s
   four arms (``percord_tcp``, ``coalesce_tcp``, ``coalesce_columnar_tcp``,
   ``coalesce_columnar_shm``) at 64 x 40,000, 1,024 x 20,000 and 16,384 x
   2,000 floats, one sender subprocess serving every arm in turn into this
   process's reactor (``core/shuffle_probe.py``, best of
   ``SHUFFLE_PASSES``): every record
   arrives; records/s, MB/s and the bench's two ratios printed, nothing
   about speed asserted; a tensor on the card written to a remote channel
   arrives as the same values in a CPU tensor; (b) resnet-train as ONE job
   across two processes sharing ``cuda:0`` (``train_cell --plane-ports``:
   gloo for the gang, the record plane for the stream,
   ``from_collection(parallelism=2) -> count_window(16) ->
   DPTrainWindowFunction(parallelism=2) -> loss probe ->
   sink_to_callable(parallelism=1)``), 8 steps, checkpoints every 2 into
   one shared directory, under a ``CohortSupervisor`` uninterrupted and
   with the last process exiting at step 5 on attempt 0: 2 attempts, no
   process left alive, the restore from checkpoint 2 (the newest common),
   steps 5-8's losses and the final params and batch statistics equal to
   the uninterrupted run's bit for bit, process 0's sink receiving every
   (rank, step) once, and the uninterrupted run equal to phase 14 (c)'s
   per-rank job bit for bit (the source is interleaved so each rank reads
   the rows that job reads); (c) the widedeep-online cell keyed over the
   cohort (``train_cell --widedeep``: ``key_by(user) ->
   OnlineTrainFunction(scope="key", mini_batch=32, steps_per_dispatch=16)
   -> ExactlyOnceRecordFileSink``) on two processes sharing ``cuda:0``,
   process 0 (the source and the 2PC sink) SIGKILLed once the commit gate
   has promoted a checkpoint's output, restored as three processes at
   keyed parallelism 3:
   the committed (key, step) records equal a one-process run's at keyed
   parallelism 2, each once, losses bit for bit; records/s of each run and
   the recovery seconds printed; the phase's seconds;
16. print one ``kernels`` JSON line, the card line, and the final
   ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# Published H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the
# tensor cores, TF32 and bf16/f16 on the tensor cores, HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# (name, B, H, T, Tk, D, dtype, causal, return_lse)
K1_SHAPES = (
    ("serving", 8, 4, 16, 16, 16, "float32", True, False),
    ("long_f32", 4, 8, 2048, 2048, 64, "float32", True, False),
    ("long_bf16", 4, 8, 2048, 2048, 64, "bfloat16", True, False),
    ("long_f16_d128", 2, 16, 4096, 4096, 128, "float16", True, False),
    ("ragged_lse", 1, 4, 1000, 1536, 128, "float32", False, True),
    ("fully_masked", 1, 4, 16, 0, 16, "float32", False, True),
)
# (atol, rtol) of K1's output against its plain version.  f32: both sum
# f32 products (K1's from 3xTF32, about 21 bits) in another order.  16-bit:
# one step of the output type (rtol 2**-7 covers bf16's 2**-8) plus the
# rounding of P to the input type before P.V, at most 2**-9 of each weight,
# worst on rows that see 2-3 keys (atol 3e-3).  lse is f32 in every case
# and is held to 1e-4.
TOLERANCE = {"float32": (1e-4, 0.0), "bfloat16": (3e-3, 2 ** -7), "float16": (3e-3, 2 ** -7)}
LSE_TOLERANCE = 1e-4
# Inception, the card's f32 forward (cuDNN, TF32 off) against the CPU's f32
# plain path, relative to the largest |logit|: both sum f32 products in
# another order through 94 convs (the CPU tests see about 1e-6 between
# the port and flax; the card read 1.44e-6).  TF32 products (10-bit
# mantissa) would miss it by orders of magnitude.
INCEPTION_F32_TOL = 1e-5
# The card's bf16 forward against the CPU's bf16 path (held to flax by
# tests/test_torch_inception.py at the same tolerance): every conv rounds
# its output to bf16 after summing in another order.  Scores are held to
# the same share of the largest score.  Labels must agree wherever the
# CPU's top-1/top-2 gap exceeds twice this share of max |logit| (random
# weights give near ties, so few rows may be that clear).
INCEPTION_BF16_TOL = 3e-2
# Labels and scores of the stream against a direct call of the same module
# on the card, same batches: the same cuDNN algorithms (chosen once per
# shape) on the same inputs must give the same bits.
INCEPTION_SCORE_TOL = 0.0
# resnet-train (a): the gang against a direct loop of its step on the card
# must give equal bits: both run the same cuDNN algorithms (heuristic
# choice, benchmark off) on the same batches in the same order.
#
# One step at full width, batch 4, from the cell's initial state, card
# against the CPU plain path.  The step is SGD with lr 1e6: (p0 - p1) / 1e6
# is the gradient to within ulp(p0) / 1e6 (with lr 1 the f32 rounding of
# p0 ~ 1 alone is 2e-3 of the largest gradient).  What is compared is what
# the step changed: the gradient, and the update of each running
# statistic, s1 - s0, each by its norm (||card - cpu|| / ||cpu||).  A step
# that changed nothing reads 1 on both.  At the initial state every
# block's last batch norm has scale 0, so its convs get no gradient; the
# stem, the projections, the batch norms' scales and biases and the head
# do, through the whole forward.  (With every scale near 1 the 16-block
# net at batch 4 amplifies f32 rounding in its gradient to percents, and
# bf16's past its own size, so no comparison can hold it; the CPU twins
# hold such states at the tiny size.)
#   f32 (TF32 off): the loss to 1e-5 relative.  A gradient is not
# continuous where a pre-activation sits within f32 rounding of 0: two
# correct f32 paths can put it on either side of its ReLU.  The card showed
# one such element (-6.7e-7 before the ReLU that ends block 7); flipping
# it alone on the CPU moved the gradients of blocks 7-12 by 2.27e-3 of the
# largest gradient and 4.0e-4 of their norm, exactly the card's reading.
# So the gradients are held to 2e-3 of their norm (a few such flips; an
# error in the backward is of order 1) and each element to 1e-2 of the
# largest.  The statistics' update to 1e-5 (the card read 7.0e-7).
#   bf16, the cell's precision: the loss and the statistics' update to
# 3e-2 (every conv rounds its output to bf16 after summing in another
# order).  A gradient keeps few correct bits at bf16 (a batch-norm
# gradient is a sum with heavy cancellation; the CPU tests read 4-28% by
# norm between the JAX package's bf16 step and the f32 one), so the card's
# bf16 gradient is held by the CPU's own bf16 error: it may be at most
# RESNET_BF16_NOISE_FACTOR times as far from the CPU's bf16 gradient as
# that is from the CPU's f32 one (two independent bf16 roundings of one
# gradient are sqrt(2) times as far apart as each is from it; the card
# read 0.021 against 0.055, 0.38 times).  That error must stay below
# 1 / RESNET_BF16_NOISE_FACTOR, so a step that changed nothing fails.
RESNET_F32_TOL = {"loss": 1e-5, "grads_norm": 2e-3, "grads_max": 1e-2, "stats_update": 1e-5}
RESNET_BF16_TOL = {"loss": 3e-2, "stats_update": 3e-2}
RESNET_BF16_NOISE_FACTOR = 1.5
GRAD_LR = 1e6
# widedeep-online (b): the card against a CPU run of the same job, both
# checkpointed every 1024 events, bf16 compute on both: the first 16
# losses to 1e-5 relative (the card read 1.8e-7), and the TrainState of
# checkpoint 1 (23 steps), what training changed, by its norm: params -
# init, and adam's mu and nu, to 1e-5 (the card read 3.1e-8, 8.5e-8 and
# 8.0e-8; an untrained state reads 1).  Not
# the final state: one model shared by 16 users' label rules, adam at eps
# 1e-8 and lr 1e-2 make the job chaotic past its first checkpoint.  A CPU
# run from params moved by 1e-7 relative agrees with the unmoved one at
# checkpoint 1 and ends far from it (tests/test_torch_training.py::
# test_widedeep_cell_is_chaotic_past_its_first_checkpoint), and the card's
# rounding differs from the CPU's by about that much per step.
WIDEDEEP_CPU_TOL = {"losses": 1e-5, "params_update": 1e-5, "mu": 1e-5, "nu": 1e-5}
# (c): the restarted job against the same job without the crash: equal
# bits are expected (the state crosses card -> host -> card exactly and
# the same steps run in the same order); else params within 1e-5 of the
# largest |param|.
WIDEDEEP_RESTART_TOL = 1e-5
DEVICE_BYTES_SLACK = 100_000
# Phase 8.  The card's bf16 forward against the CPU's bf16 path, relative
# to the largest |logit| (LeNet, BiLSTM and Inception; the CPU twins hold
# the CPU paths to flax at the same tolerance): every conv, product and
# gate rounds to bf16 after summing in another order.
STREAM_BF16_TOL = 3e-2
# The card's f32 forward (cuDNN and cuBLAS, TF32 off) against the CPU's
# f32 path.  LeNet sums f32 products in another order through 5 layers.
LENET_F32_TOL = 1e-5
# The BiLSTM's f32 recurrence: 2 x up to 256 sequential steps, each adding
# 384 f32 products in another order, compound their rounding through c
# and h; an error in the recurrence (a gate order, a length) is of order 1.
# Held with cuDNN's RNN left at PyTorch's default (TF32 allowed), as a job
# runs it: the port turns TF32 off for its own call.
BILSTM_F32_TOL = 1e-4
# A BiLSTM record alone at its own bucket against it in a batch padded to
# 256, on the card's route, final states and logits relative to the
# record's own largest magnitude: cuDNN's f32 kernels at batch 1 and 8
# steps sum in another order than at batch 64 and 256 steps (measured
# 1.2e-7-2.4e-7 of the logits); a length or flip error is of order 1.
BILSTM_PAD_TOL = 1e-5
# The cuDNN routes are timed and held to the plain step loop on the
# cell's first batches, this many (the route was chosen by the same
# measurement: models/zoo/bilstm.py:CUDA_ROUTE).
LSTM_ROUTE_BATCHES = 4
# The rule that chose the route: the one closer to the plain loop, unless
# it takes more than this many times the other's time.
LSTM_ROUTE_TIME_FACTOR = 2.0
# inception-map: the map's micro-batch and the subtasks that load the bundle.
MAP_RECORDS = 1024
MAP_MICRO_BATCH = 32
MAP_PARALLELISM = 2
# Phase 9 (c): the device-resident arm's scores (softmax over a
# micro-batch's [32, 1000] logits on the card) against the host arm's (the
# same softmax on each record lifted to [1, 1000]).  Equal bits are
# expected: PyTorch reduces each row of at most 1024 elements within one
# warp whatever the row count.  One f32 ulp of 1 is allowed in case
# another row count takes another kernel and sums the row in another order.
CHAIN_SCORE_TOL = 2 ** -23
# Phase 11: 8 cameras at 32 frames/s, the source order shuffled within
# blocks of 64 records (2 s of one camera's frames span 64 records, so a
# record trails the newest one by at most 7 / 32 s < the 0.25 s slack:
# no source record is late), a watermark every 128 records.
ET_CAMERAS = 8
ET_FPS = 32
ET_BLOCK = 64
ET_SLACK_S = 0.25
ET_WATERMARK_EVERY = 128
ET_BATCH = 32
ET_DEPTH = 3
ET_MAP_MICRO_BATCH = 128
ET_CHECKPOINT_EVERY = 256
# Phase 9 (d): bench.py:bench_deviceres at its full size.  The card's f32
# (TF32 off) against the CPU's: two f32 products of 4096 terms each,
# summed in another order (order 1e-7 of the largest |x|).
RESMLP_DIM = 4096
RESMLP_RECORDS = 512
RESMLP_MICRO = 8
RESMLP_F32_TOL = 1e-5
# The bench's offered load (``bench.py:2127``, ``:2158-2160``).
RESMLP_RATE = 400.0
# Phase 12 (a): the Inception ring at depth 6, (5 + 3) x 128 = 1,024 slots
# of 268,224 B (one 299 x 299 x 3 record, 64-byte rounded), page-locked.
RING_PINNED_BYTES = 1024 * 268224
# Phase 12 (b): H2D bytes per batch of 512 LeNet records (28 x 28 x 1):
# f32, bf16, and int8 plus its f32 scale.
WIRE_H2D_BYTES = {"f32": 512 * 784 * 4, "bf16": 512 * 784 * 2, "int8": 512 * 784 + 4}
# Phase 12 (c): records through the paced pass (bench.py: min(records, 512)).
OPEN_LOOP_RECORDS = 512


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str):
    """(kernel instance, line) for each register / spill line of an nvcc
    -Xptxas -v log, the instance demangled by c++filt where it exists."""
    entry = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            try:
                entry = subprocess.run(["c++filt", entry], capture_output=True, text=True,
                                       timeout=10).stdout.strip() or entry
            except (OSError, subprocess.SubprocessError):
                pass
            entry = re.sub(r"\(.*\)$", "", entry.replace("(anonymous namespace)::", ""))
        elif "registers" in line or "spill" in line:
            yield entry, line.strip().replace("ptxas info    : ", "")


def time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def k1_bound(b, h, t, tk, d, dtype, causal):
    """Least time for the work of this call on the route K1 takes: visible
    (q, k) pairs x 4D FLOPs at the route's peak (bf16/f16: tensor cores;
    f32: three TF32 products, 3x the FLOPs at the TF32 peak), or
    q+k+v+o+lse bytes at HBM rate.  Also returns the f32 FMA bound
    (FLOPs at 67 TFLOP/s), printed beside it for f32 rows."""
    pairs = sum(min(i + 1, tk) for i in range(t)) if causal else t * tk
    flops = 4 * b * h * d * pairs
    es = 4 if dtype == "float32" else 2
    nbytes = es * (2 * b * t * h * d + 2 * b * tk * h * d) + 4 * b * h * t
    if dtype == "float32":
        ops_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
    else:
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    fma_ms = max(flops / PEAK_F32_FLOPS * 1e3, bytes_ms)
    bound = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    return bound + (fma_ms,)


def check_k1(fa, torch):
    import torch.nn.functional as F

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, b, h, t, tk, d, dtype, causal, lse in K1_SHAPES:
        dt = getattr(torch, dtype)
        q = torch.randn(b, t, h, d, device="cuda", generator=gen).to(dt)
        k = torch.randn(b, tk, h, d, device="cuda", generator=gen).to(dt)
        v = torch.randn(b, tk, h, d, device="cuda", generator=gen).to(dt)
        o, l = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        ro, rl = fa.flash_attention_reference(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        if o.shape != ro.shape or o.dtype != dt or l.shape != (b, h, t):
            fail(f"K1 {name}: shape/dtype {tuple(o.shape)} {o.dtype} {tuple(l.shape)}")
        if not torch.equal(torch.isinf(l), torch.isinf(rl)):
            fail(f"K1 {name}: -inf rows of lse differ")
        err = (o.float() - ro.float()).abs().max().item() if o.numel() else 0.0
        fin = torch.isfinite(rl)
        lse_err = (l[fin] - rl[fin]).abs().max().item() if fin.any() else 0.0
        if tk == 0 and (o.abs().max().item() != 0.0 or fin.any()):
            fail(f"K1 {name}: fully masked rows must give o = 0 and lse = -inf")
        atol, rtol = TOLERANCE[dtype]
        over = ((o.float() - ro.float()).abs() - rtol * ro.float().abs()).max().item() \
            if o.numel() else 0.0
        if not (over <= atol and lse_err <= LSE_TOLERANCE):
            fail(f"K1 {name}: max |o - plain| - rtol |plain| = {over} > {atol} "
                 f"or |lse - plain| {lse_err} > {LSE_TOLERANCE}")
        small = t * max(tk, 1) <= 1 << 16
        iters = 200 if small else 50
        plain_ms = time_ms(lambda: fa.flash_attention_reference(
            q, k, v, causal=causal, return_lse=lse), 200 if small else 5)
        # Kernel and library in turns, three times each; the medians are kept.
        kernel, library = [], []
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        for _ in range(3):
            kernel.append(time_ms(lambda: fa.flash_attention(
                q, k, v, causal=causal, return_lse=lse), iters))
            if tk > 0:
                # A yardstick only: PyTorch's is_causal is aligned top-left, as K1's mask is.
                library.append(time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), iters))
        kernel_ms = sorted(kernel)[1]
        library_ms = sorted(library)[1] if library else None
        bound_ms, bound_by, fma_bound_ms = k1_bound(b, h, t, tk, d, dtype, causal)
        row = {"shape": name, "B": b, "H": h, "T": t, "Tk": tk, "D": d, "dtype": dtype,
               "causal": causal, "max_abs_err": max(err, lse_err), "atol": atol,
               "rtol": rtol, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "kernel_ms_runs": kernel, "library_ms_runs": library}
        if dtype == "float32":
            row["fma_bound_ms"] = fma_bound_ms
        print("K1", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def by_session(events):
    out = {}
    for ev in events:
        if ev.index >= 0:
            out.setdefault(ev.session_id, {})[ev.index] = ev.token
    return {sid: [toks[i] for i in sorted(toks)] for sid, toks in out.items()}


def check_inception(card: str, torch):
    """Phase 5: the Inception streaming cell on the card, and its checks."""
    import copy

    import numpy as np

    from flink_tensorflow_tpu_torch.models import inception_cell as cell
    from flink_tensorflow_tpu_torch.models.stream_cell import steady_rps
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def

    t0 = time.monotonic()
    mdef, model, pixels, records = cell.inception_cell(SEED)
    init_s = time.monotonic() - t0
    results, arrivals, metrics, seconds = cell.run_cell(model, records)
    ids = [int(r.meta["id"]) for r in results]
    if sorted(ids) != list(range(cell.RECORDS)):
        fail(f"inception: {len(ids)} results, {len(set(ids))} distinct ids, "
             f"want each of {cell.RECORDS} once")
    got_label = np.empty(cell.RECORDS, np.int32)
    got_score = np.empty(cell.RECORDS, np.float32)
    for r in results:
        got_label[r.meta["id"]] = r["label"]
        got_score[r.meta["id"]] = r["score"]

    # The same module, called directly on the card over the same batches.
    serve = mdef.methods["serve"].fn
    module = copy.deepcopy(model.params).to("cuda").eval()
    want_label = np.empty_like(got_label)
    want_score = np.empty_like(got_score)
    with torch.inference_mode():
        for lo in range(0, cell.RECORDS, cell.BATCH):
            batch = torch.from_numpy(pixels[lo:lo + cell.BATCH].copy()).cuda()
            out = serve(module, {"image": batch})
            want_label[lo:lo + cell.BATCH] = out["label"].cpu().numpy()
            want_score[lo:lo + cell.BATCH] = out["score"].cpu().numpy()
            if lo == 0:
                card_bf16 = {k: out[k][:4].float().cpu().numpy() for k in out}
    del module
    if not np.array_equal(got_label, want_label):
        bad = np.nonzero(got_label != want_label)[0]
        fail(f"inception: {len(bad)} labels differ from the direct call, first id {bad[0]}")
    score_err = float(np.abs(got_score - want_score).max())
    if score_err > INCEPTION_SCORE_TOL:
        fail(f"inception: scores differ from the direct call by {score_err}")

    # 4 records: the CPU's bf16 path against the card's bf16 forward (the
    # direct call above, which the stream equals bit for bit).
    t_cpu = time.monotonic()
    with torch.inference_mode():
        cpu_bf16 = {k: v.float().numpy() for k, v in
                    serve(model.params, {"image": torch.from_numpy(pixels[:4].copy())}).items()}
    bf16_cpu_s = time.monotonic() - t_cpu
    peak = np.abs(cpu_bf16["logits"]).max()
    bf16_err = float(np.abs(card_bf16["logits"] - cpu_bf16["logits"]).max() / peak)
    bf16_score_err = float(np.abs(card_bf16["score"] - cpu_bf16["score"]).max()
                           / np.abs(cpu_bf16["score"]).max())
    top2 = np.sort(cpu_bf16["logits"], axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * INCEPTION_BF16_TOL * peak
    if not (np.isfinite(card_bf16["logits"]).all() and bf16_err <= INCEPTION_BF16_TOL
            and bf16_score_err <= INCEPTION_BF16_TOL):
        fail(f"inception: card bf16 logits differ from the CPU's by {bf16_err} of max |logit|, "
             f"scores by {bf16_score_err} (tolerance {INCEPTION_BF16_TOL})")
    if not np.array_equal(card_bf16["label"][clear], cpu_bf16["label"][clear]):
        fail("inception: card bf16 labels differ from the CPU's where the top-2 gap is clear")

    # 4 records: the CPU's f32 plain path against the card's f32 forward.
    f32 = get_model_def("inception_v3", num_classes=cell.CLASSES, image_size=cell.IMAGE,
                        uint8_input=True, compute_dtype="float32")
    f32_module = f32.to_model(model.params).params
    x = torch.from_numpy(pixels[:4].copy())
    with torch.inference_mode():
        cpu = f32.methods["serve"].fn(f32_module, {"image": x})["logits"].numpy()
        gpu = f32.methods["serve"].fn(copy.deepcopy(f32_module).to("cuda"),
                                      {"image": x.cuda()})["logits"].cpu().numpy()
    f32_err = float(np.abs(gpu - cpu).max() / np.abs(cpu).max())
    if not (np.isfinite(gpu).all() and f32_err <= INCEPTION_F32_TOL):
        fail(f"inception: card f32 logits differ from the CPU's by {f32_err} of max |logit| "
             f"> {INCEPTION_F32_TOL}")

    rps, span = steady_rps(arrivals, cell.RECORDS, cell.BATCH,
                           cell.trailing_exclude(cell.RECORDS))
    m = {k.split(".", 2)[2]: v for k, v in metrics.items() if k.startswith("inception.0.")}
    row = {
        "records": cell.RECORDS, "batch": cell.BATCH, "pipeline_depth": cell.DEPTH,
        "records_per_s": rps, "steady_span_s": span, "job_seconds": seconds,
        "job_records_per_s": cell.RECORDS / seconds,
        "record_latency_p50_ms": m["record_latency_s"]["p50"] * 1e3,
        "record_latency_p95_ms": m["record_latency_s"]["p95"] * 1e3,
        "batch_latency_p50_ms": m["batch_latency_s"]["p50"] * 1e3,
        "batch_latency_p95_ms": m["batch_latency_s"]["p95"] * 1e3,
        "h2d_bytes_per_batch": m["h2d_bytes"] / m["batches"],
        "batches": m["batches"], "padded_records": m["padded_records"],
        "init_s": init_s, "warmup_s": m["warmup_s"]["p50"],
        "assemble_p50_ms": m["assemble_s"]["p50"] * 1e3,
        "dispatch_p50_ms": m["dispatch_s"]["p50"] * 1e3,
        "fetch_wait_p50_ms": m["fetch_wait_s"]["p50"] * 1e3,
        "score_max_abs_err_vs_direct": score_err, "f32_rel_err_vs_cpu": f32_err,
        "f32_tolerance": INCEPTION_F32_TOL, "bf16_rel_err_vs_cpu": bf16_err,
        "bf16_score_err_vs_cpu": bf16_score_err, "bf16_tolerance": INCEPTION_BF16_TOL,
        "bf16_clear_labels": int(clear.sum()),
        "bf16_equal_labels": int((card_bf16["label"] == cpu_bf16["label"]).sum()),
        "bf16_cpu_s": bf16_cpu_s, "card": card,
    }
    for key in ("records_per_s", "job_records_per_s", "record_latency_p50_ms",
                "record_latency_p95_ms", "batch_latency_p50_ms", "batch_latency_p95_ms", "h2d_bytes_per_batch",
                "batches", "padded_records", "init_s", "warmup_s"):
        print(f"inception {key}: {row[key]} | card: {card}", flush=True)
    print("inception", json.dumps(row), flush=True)
    return row, (mdef, model, pixels), (want_label, want_score)


def crash_once(at: int, directory=None, min_checkpoint: int = 1):
    """A tap on the events that raises once, at the ``at``-th event (with
    ``directory``: the first one from there on that finds checkpoint
    ``min_checkpoint`` or a later one completed there); the one instance is
    shared by every subtask and restart."""
    from flink_tensorflow_tpu_torch.checkpoint.store import latest_checkpoint_id
    from flink_tensorflow_tpu_torch.core import functions as fn

    class CrashOnce(fn.MapFunction):
        def __init__(self):
            self.at, self.seen, self.crashed = at, 0, False
            #: ``seen`` when it raised (``seen`` counts both attempts).
            self.crashed_at = None

        def clone(self):
            return self

        def map(self, value):
            self.seen += 1
            if not self.crashed and self.seen >= self.at and (
                    directory is None
                    or (latest_checkpoint_id(directory) or 0) >= min_checkpoint):
                self.crashed, self.crashed_at = True, self.seen
                raise RuntimeError("injected mid-generation crash")
            return value

    return CrashOnce()


def tokens_checked(events):
    """Per-session tokens; an index seen twice (at-least-once replay) must
    carry the same token."""
    out = {}
    for ev in events:
        if ev.index < 0:
            continue
        prev = out.setdefault(ev.session_id, {}).get(ev.index)
        if prev is not None and prev != ev.token:
            fail(f"session {ev.session_id} index {ev.index}: replayed token {ev.token} "
                 f"differs from {prev}")
        out[ev.session_id][ev.index] = ev.token
    return {sid: [toks[i] for i in sorted(toks)] for sid, toks in out.items()}


def hold_tokens(what, got, want, requests, model, torch):
    """Fail unless every session's tokens equal ``want``; on a divergence
    print the session, the step and the CPU's top-2 logit margin there."""
    for r in requests:
        a, b = got.get(r.session_id), want[r.session_id]
        if a == b:
            continue
        if a is None:
            fail(f"{what}: session {r.session_id} produced no tokens")
        step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        seq = list(r.prompt) + list(b[:step])
        with torch.no_grad():
            logits = model.params.last_logits({
                "tokens": torch.tensor([seq], dtype=torch.int32),
                "lengths": torch.tensor([len(seq)], dtype=torch.int32)})[0]
        top2 = torch.topk(logits, 2).values
        fail(f"{what}: session {r.session_id} differs at step {step} "
             f"({a[step:step + 1]} vs {b[step:step + 1]}, lengths {len(a)} vs {len(b)}); "
             f"CPU top-2 logit margin there {float(top2[0] - top2[1])}")


def check_keyed_serving(card, torch, fa, mdef, model, cfg, requests, want, phase4):
    """Phase 6: the serving cell through the keyed pipeline on the local
    executor: uninterrupted, failover under a restart strategy, and a
    rescale from parallelism 2 to 3.  Returns K1's launches per path."""
    import tempfile

    from flink_tensorflow_tpu_torch import RestartStrategy
    from flink_tensorflow_tpu_torch.checkpoint.store import (
        checkpoint_size_bytes,
        latest_checkpoint_id,
    )
    from flink_tensorflow_tpu_torch.core.runtime import JobFailure
    from flink_tensorflow_tpu_torch.serving.cell import keyed_job, serve_keyed

    layers = mdef.config["num_layers"]
    warm = len(cfg.resolved_admit_buckets()) * len(cfg.resolved_prompt_buckets())
    total = sum(len(v) for v in want.values())

    # (a) uninterrupted, parallelism 1.
    fa.flash_attention.launches = 0
    events, seconds, grp = serve_keyed(model, cfg, requests)
    launches_a = fa.flash_attention.launches
    got = tokens_checked(events)
    hold_tokens("keyed pipeline", got, want, requests, model, torch)
    prefills_a = grp.counter("prefill_batches").count
    if launches_a != layers * (prefills_a + warm):
        fail(f"keyed pipeline: K1 launches {launches_a} != {layers} x ({prefills_a} + {warm})")
    row_a = {"tokens": total, "seconds": seconds, "tokens_per_s": total / seconds,
             "subtask_loop_seconds": phase4["seconds"],
             "subtask_loop_tokens_per_s": phase4["tokens_per_s"],
             "prefill_batches": prefills_a, "k1_launches": launches_a, "card": card}
    print("keyed_serving", json.dumps(row_a), flush=True)
    dense_keyed = {"tokens_per_s": row_a["tokens_per_s"],
                   "decode_step_p50_ms": grp.histogram("decode_step_s").percentile(50) * 1e3,
                   "ttft_p50_ms": grp.histogram("ttft_s").percentile(50) * 1e3}

    # (b) failover: count-based checkpoints, one crash, one restart.
    pool_bytes = 2 * 4 * cfg.max_active_seqs * layers * cfg.capacity * mdef.config["embed_dim"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chk") as d:
        tap = crash_once(total // 2)
        env, arrivals = keyed_job(model, cfg, requests, tap=tap)
        env.enable_checkpointing(d, every_n_records=8)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        fa.flash_attention.launches = 0
        result = env.execute("failover", timeout=600,
                             restart_strategy=RestartStrategy(max_restarts=1))
        launches_b = fa.flash_attention.launches
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        last_id = latest_checkpoint_id(d)
        last_bytes = checkpoint_size_bytes(os.path.join(d, f"chk-{last_id:06d}"))
    rep = env.metric_registry.report()
    grp = env.metric_registry.group("continuous_batching.0")
    at_open = grp.histogram("device_bytes_at_open").values
    if result.restarts != 1 or not tap.crashed:
        fail(f"failover: {result.restarts} restarts (crashed: {tap.crashed}), want 1")
    got_b = tokens_checked([ev for _, ev in arrivals])
    hold_tokens("failover", got_b, got, requests, model, torch)
    h2d_blocks = rep["continuous_batching.0.cache_h2d_blocks"]
    if h2d_blocks < 1:
        fail("failover: no session resumed from a checkpointed cache")
    prefills_b = grp.counter("prefill_batches").count
    want_b = layers * (prefills_b + warm * (result.restarts + 1))
    if launches_b != want_b:
        fail(f"failover: K1 launches {launches_b} != {layers} x ({prefills_b} prefill batches "
             f"+ {warm} x {result.restarts + 1} warmup prefills)")
    if len(at_open) != 2:
        fail(f"failover: the serving operator opened {len(at_open)} times, want 2")
    # The restart opens its pool only after the failed attempt let go of
    # its own: less than half a pool may separate the readings.
    held = max(at_open[1], after) - before
    if held > pool_bytes // 2:
        fail(f"failover: {held} device bytes of the failed attempt still held "
             f"(one KV pool is {pool_bytes})")
    sync = grp.histogram("cache_sync_s")
    row_b = {
        "restarts": result.restarts, "crash_after_events": tap.at,
        "checkpoints_completed": rep["checkpoint.completed"],
        "last_checkpoint_id": last_id, "last_checkpoint_bytes": last_bytes,
        "cache_sync_p50_ms": sync.percentile(50) * 1e3,
        "cache_sync_max_ms": max(sync.values) * 1e3, "cache_syncs": len(sync.values),
        "recovery_duration_s": rep["recovery.recovery_duration_s"]["p50"],
        "cache_h2d_blocks": h2d_blocks,
        "device_bytes_before": before, "device_bytes_after_failure": at_open[1],
        "device_bytes_after_restart": after, "kv_pool_bytes": pool_bytes,
        "k1_launches": launches_b, "k1_launches_expected": want_b,
        "prefill_batches_both_attempts": prefills_b, "card": card,
    }
    print("keyed_failover", json.dumps(row_b), flush=True)

    # (c) crash at parallelism 2, restore the latest checkpoint at 3.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rescale") as d:
        env1, arrivals1 = keyed_job(model, cfg, requests, parallelism=2,
                                    tap=crash_once(total // 2))
        env1.enable_checkpointing(d, every_n_records=8)
        try:
            env1.execute("rescale-phase1", timeout=600)
            fail("rescale: the first run did not crash")
        except JobFailure:
            pass
        cid = latest_checkpoint_id(d)
        if cid is None:
            fail("rescale: no checkpoint completed before the crash")
        env2, arrivals2 = keyed_job(model, cfg, requests, parallelism=3)
        env2.execute("rescale-phase2", timeout=600, restore_from=d, restore_checkpoint_id=cid)
    restored = tokens_checked([ev for _, ev in arrivals2])
    if not restored:
        fail("rescale: the restored run emitted no session")
    got_c = tokens_checked([ev for _, ev in arrivals1] + [ev for _, ev in arrivals2])
    hold_tokens("rescale 2->3", got_c, got, requests, model, torch)
    row_c = {"restored_from": cid, "sessions_emitted_after_restore": len(restored),
             "events_before_crash": len(arrivals1), "events_after_restore": len(arrivals2),
             "card": card}
    print("keyed_rescale", json.dumps(row_c), flush=True)
    for key in ("seconds", "tokens_per_s"):
        print(f"keyed serving {key}: {row_a[key]} (subtask loop {phase4[key]}) | card: {card}")
    for key in ("checkpoints_completed", "last_checkpoint_bytes", "cache_sync_p50_ms",
                "cache_sync_max_ms", "recovery_duration_s", "device_bytes_before",
                "device_bytes_after_failure", "device_bytes_after_restart"):
        print(f"keyed failover {key}: {row_b[key]} | card: {card}")
    return {"serving_pipeline": launches_a, "serving_failover": launches_b}, dense_keyed


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif hasattr(v, "device"):
            out[prefix + k] = v
    return out


def _tree_err(got, want) -> float:
    """max |got - want| over a tree of tensors, over the largest |want|."""
    got, want = _flat(got), _flat(want)
    if set(got) != set(want):
        fail(f"train state trees differ in names: {sorted(set(got) ^ set(want))[:4]}")
    peak = max(float(w.float().abs().max()) for w in want.values())
    diff = max(float((got[k].float().cpu() - want[k].float().cpu()).abs().max()) for k in want)
    return diff / peak if peak else diff


def _norm_err(got, want, start=None) -> float:
    """||got - want|| over ||want - start|| (``start`` 0 by default), each
    tree taken as one vector: with ``start`` the state both ran from, the
    error of what they changed."""
    got, want = _flat(got), _flat(want)
    start = _flat(start) if start is not None else {}
    diff = sum(float((got[k].double().cpu() - want[k].double().cpu()).square().sum())
               for k in want)
    size = sum(float((w.double().cpu() - (start[k].double().cpu() if k in start else 0))
                     .square().sum()) for k, w in want.items())
    return (diff / size) ** 0.5


def _bit_equal(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return set(fa) == set(fb) and all(torch_equal(fa[k], fb[k]) for k in fa)


def torch_equal(a, b) -> bool:
    import torch

    return torch.equal(a.cpu(), b.cpu())


def resnet_one_step(torch, mdef, records, schema, compute_dtype, device):
    """One SGD step (lr ``GRAD_LR``) of the cell's model at batch 4 from
    its initial state, on ``device`` (the card) and on the CPU's plain
    path: ``{where: (loss, gradients, statistics' update)}``."""
    from flink_tensorflow_tpu_torch.functions.training_function import _train_batch_arrays
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.parallel import dp
    from flink_tensorflow_tpu_torch.parallel.optim import sgd
    from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy

    mdef = get_model_def("resnet50", **{**mdef.config, "compute_dtype": compute_dtype})
    optimizer = sgd(GRAD_LR)
    host = dp.init_train_state(mdef, optimizer, SEED)
    start = host["variables"]
    _, arrays = _train_batch_arrays(records[:4], schema, BucketPolicy(fixed_batch=4))
    step = dp.make_train_step(mdef, optimizer)
    out = {}
    for where, device in (("card", device), ("cpu", "cpu")):
        state = {**host, "variables": _to(start, device), "opt_state": _to(host["opt_state"], device),
                 "step": host["step"].to(device)}
        batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        new, metrics = step(state, batch, 0)
        new = _to(new["variables"], "cpu")
        grads = {n: (start["params"][n] - t) / GRAD_LR for n, t in new["params"].items()}
        stats = {n: t - start["batch_stats"][n] for n, t in new["batch_stats"].items()}
        out[where] = (float(metrics["loss"]), grads, stats)
        del state, new
    return out


def one_step_errs(out, with_max: bool):
    """The card's one step against the CPU's (``resnet_one_step``)."""
    (loss, grads, stats), (want_loss, want_grads, want_stats) = out["card"], out["cpu"]
    errs = {"loss": abs(loss - want_loss) / abs(want_loss),
            "grads_norm": _norm_err(grads, want_grads)}
    if with_max:
        errs["grads_max"] = _tree_err(grads, want_grads)
    errs["stats_update"] = _norm_err(stats, want_stats)
    return errs


def _to(tree, device):
    if hasattr(tree, "to"):
        return tree.to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree


def check_training(card: str, torch, fa):
    """Phase 7: the two training cells on the card, and their checks."""
    import tempfile

    import numpy as np

    from flink_tensorflow_tpu_torch.checkpoint.store import latest_checkpoint_id, read_checkpoint
    from flink_tensorflow_tpu_torch.functions import train_cell as cell
    from flink_tensorflow_tpu_torch.functions.runner import (
        hold_cudnn_heuristics,
        release_cudnn_heuristics,
    )
    from flink_tensorflow_tpu_torch.functions.train_trace import profile
    from flink_tensorflow_tpu_torch.functions.training_function import _train_batch_arrays
    from flink_tensorflow_tpu_torch.parallel import dp
    from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from flink_tensorflow_tpu_torch.parallel.optim import adam
    from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy

    fa.flash_attention.launches = 0
    # -- resnet-train -----------------------------------------------------
    t0 = time.monotonic()
    mdef, schema, records = cell.resnet_cell()
    build_s = time.monotonic() - t0
    mesh = make_mesh({"data": 1})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = cell.run_resnet(mdef, schema, records, mesh)
    peak_bytes = torch.cuda.max_memory_allocated()
    losses = [float(r["loss"]) for r in run.results]
    if [int(r["step"]) for r in run.results] != list(range(1, cell.RESNET_STEPS + 1)):
        fail(f"resnet-train: steps {[int(r['step']) for r in run.results]}")
    if not all(np.isfinite(losses)):
        fail(f"resnet-train: non-finite loss {losses}")
    final = run.function.current_params()

    # (a) a direct loop of the gang's step over the same 24 batches.
    opt = adam(cell.RESNET_LR)
    state = replicate(mesh, dp.init_train_state(mdef, opt, 0))
    step = dp.make_dp_train_step(mdef, opt, mesh)
    policy = BucketPolicy(fixed_batch=cell.RESNET_BATCH)
    loop = []
    hold_cudnn_heuristics()
    try:
        for i in range(cell.RESNET_STEPS):
            batch = records[i * cell.RESNET_BATCH:(i + 1) * cell.RESNET_BATCH]
            _, arrays = _train_batch_arrays(batch, schema, policy)
            state, metrics = step(state, shard_batch(mesh, arrays), i)
            loop.append(metrics["loss"])
        loop = [float(x) for x in loop]
    finally:
        release_cudnn_heuristics()
    loop_bits = loop == losses and _bit_equal(final, state["variables"])
    del state, step
    if not loop_bits:
        fail(f"resnet-train: the gang differs from a direct loop: losses equal {loop == losses}, "
             f"largest loss difference {max(abs(a - b) for a, b in zip(losses, loop))}")

    # One SGD step, card against the CPU plain path, at f32 and at bf16.
    t_cpu = time.monotonic()
    f32 = resnet_one_step(torch, mdef, records, schema, "float32", mesh.device)
    bf16 = resnet_one_step(torch, mdef, records, schema, "bfloat16", mesh.device)
    cpu_steps_s = time.monotonic() - t_cpu
    f32_errs = one_step_errs(f32, with_max=True)
    bf16_errs = one_step_errs(bf16, with_max=False)
    # The CPU's bf16 gradient against its f32 one: what bf16 costs.
    bf16_errs["cpu_bf16_vs_f32"] = _norm_err(bf16["cpu"][1], f32["cpu"][1])
    del f32, bf16
    print("resnet one step, card vs cpu", json.dumps({"float32": f32_errs, "bfloat16": bf16_errs}),
          flush=True)
    for name, errs, tol in (("f32", f32_errs, RESNET_F32_TOL), ("bf16", bf16_errs,
                                                                 RESNET_BF16_TOL)):
        if not all(errs[k] <= tol[k] for k in tol):
            fail(f"resnet-train: the card's {name} step differs from the CPU's: {errs} "
                 f"(tolerance {tol})")
    noise = bf16_errs["cpu_bf16_vs_f32"]
    if not (RESNET_BF16_NOISE_FACTOR * noise < 1
            and bf16_errs["grads_norm"] <= RESNET_BF16_NOISE_FACTOR * noise):
        fail(f"resnet-train: the card's bf16 gradient is {bf16_errs['grads_norm']} from the "
             f"CPU's, which is {noise} from its f32 one (factor {RESNET_BF16_NOISE_FACTOR})")

    trace = profile(torch, lambda: cell.run_resnet(mdef, schema, records, mesh),
                    cell.RESNET_STEPS)
    gaps = np.diff(run.arrivals) * 1e3
    dispatch = run.env.metric_registry.group("dp_train.0").histogram("step_dispatch_s")
    resnet_row = {
        "records": len(records), "batch": cell.RESNET_BATCH, "steps": len(losses),
        "records_per_s": cell.rate(run.arrivals, cell.RESNET_BATCH),
        "job_seconds": run.seconds, "job_records_per_s": len(records) / run.seconds,
        "step_ms_p50": float(np.percentile(gaps, 50)),
        "step_ms_p95": float(np.percentile(gaps, 95)),
        "host_dispatch_ms_p50": dispatch.percentile(50) * 1e3,
        "loss_first": losses[0], "loss_last": losses[-1],
        "peak_device_bytes": peak_bytes,
        "busy_share_of_job": trace["device_busy_share_of_job"],
        "busy_share_of_active_span": trace["device_busy_share_of_active_span"],
        "kernel_launches_per_step": trace["kernel_launches_per_step"],
        "copy_launches_per_step": trace["copy_launches_per_step"],
        "device_kernel_ms_per_step": trace["device_kernel_ms"] / cell.RESNET_STEPS,
        "traced_s": trace["traced_s"], "top_kernels": trace["top_kernels"][:6],
        "loop_bit_equal": loop_bits, "f32_vs_cpu": f32_errs, "bf16_vs_cpu": bf16_errs,
        "cpu_reference_steps_s": cpu_steps_s, "records_build_s": build_s, "card": card,
    }
    print("resnet_train", json.dumps(resnet_row), flush=True)
    for key in ("records_per_s", "step_ms_p50", "step_ms_p95", "loss_first", "loss_last",
                "peak_device_bytes", "busy_share_of_job", "kernel_launches_per_step"):
        print(f"resnet-train {key}: {resnet_row[key]} | card: {card}", flush=True)

    # -- widedeep-online --------------------------------------------------
    wdef, wschema, events = cell.widedeep_cell()
    b = cell.run_widedeep(wdef, wschema, events)
    wl = [float(r["loss"]) for r in b.results]
    want_steps = cell.expected_steps(events)
    fifth = max(1, len(wl) // 5)
    if len(wl) != want_steps or int(b.function._state["step"]) != want_steps:
        fail(f"widedeep-online: {len(wl)} steps emitted, state step "
             f"{int(b.function._state['step'])}, want {want_steps}")
    # The model is shared by 16 users whose label rules differ (label =
    # wide[user] > 0.5, the user is no input) and steps come in runs of
    # one user's mini-batches, so the job-wide loss stays near ln 2.  Learning
    # shows within each user's run of steps: on average over the users,
    # the loss of a user's last 4 steps is below that of its first 4.
    by_user = {}
    for r in b.results:
        by_user.setdefault(r.meta["key"], []).append(float(r["loss"]))
    user_drop = float(np.mean([np.mean(v[:4]) - np.mean(v[-4:]) for v in by_user.values()]))
    if not user_drop > 0:
        fail(f"widedeep-online: the loss does not fall within the users' runs ({user_drop})")
    # Checkpointed every 1024 events: on the card and on the CPU for (b),
    # then (c) on the card with a crash.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train") as d:
        plain = cell.run_widedeep(wdef, wschema, events, checkpoint_dir=os.path.join(d, "a"))
        cpu = cell.run_widedeep(wdef, wschema, events, checkpoint_dir=os.path.join(d, "cpu"),
                                device_provider=lambda task, index: "cpu")
        got, ref = (read_checkpoint(os.path.join(d, w), 1)[1]["online_train"][0]["function"]
                    ["state"] for w in ("a", "cpu"))
        init = dp.init_train_state(wdef, adam(cell.WIDEDEEP_LR), dp.fold_in(SEED, 0))
        pl, cl = ([float(r["loss"]) for r in run.results] for run in (plain, cpu))
        cpu_errs = {"losses": max(abs(a - c) / abs(c) for a, c in zip(pl[:16], cl[:16])),
                    "checkpoint_1_step": int(got["step"]),
                    "params_update": _norm_err(got["variables"]["params"],
                                               ref["variables"]["params"],
                                               init["variables"]["params"]),
                    "mu": _norm_err(got["opt_state"]["mu"], ref["opt_state"]["mu"]),
                    "nu": _norm_err(got["opt_state"]["nu"], ref["opt_state"]["nu"])}
        print("widedeep-online card vs cpu", json.dumps(cpu_errs), flush=True)
        if int(got["step"]) != int(ref["step"]) or not all(
                cpu_errs[k] <= WIDEDEEP_CPU_TOL[k] for k in WIDEDEEP_CPU_TOL):
            fail(f"widedeep-online: the card differs from a CPU run: {cpu_errs}, CPU step "
                 f"{int(ref['step'])} (tolerance {WIDEDEEP_CPU_TOL})")
        # Paced, and the tap waits for checkpoint 2 (2048 events), so the
        # restart restores a state that has trained.
        tap = crash_once(3000, os.path.join(d, "b"), 2)
        crashed = cell.run_widedeep(wdef, wschema, events, checkpoint_dir=os.path.join(d, "b"),
                                    tap=tap, max_restarts=1, throttle_s=1e-4)
        cid = latest_checkpoint_id(os.path.join(d, "b"))
        _, snaps = read_checkpoint(os.path.join(d, "b"), cid)
    restarts = crashed.env.metric_registry.report()["recovery.restarts_total"]
    if restarts != 1 or not tap.crashed:
        fail(f"widedeep-online: {restarts} restarts (crashed: {tap.crashed}), want 1")
    ckpt_state = snaps["online_train"][0]["function"]["state"]
    on_device = [k for k, t in _flat(ckpt_state).items() if t.device.type != "cpu"]
    if on_device:
        fail(f"widedeep-online: the checkpoint holds device tensors {on_device[:3]}")
    got, ref = crashed.function._state, plain.function._state
    restart_bits = _bit_equal(got, ref)
    restart_err = _tree_err(got["variables"], ref["variables"])
    if int(got["step"]) != want_steps or int(ref["step"]) != want_steps:
        fail(f"widedeep-online: steps after the restart {int(got['step'])}, checkpointed "
             f"{int(ref['step'])}, uninterrupted {want_steps}")
    if not restart_bits and restart_err > WIDEDEEP_RESTART_TOL:
        fail(f"widedeep-online: the restarted state differs by {restart_err}")
    at_open = crashed.env.metric_registry.group("online_train.0").histogram(
        "device_bytes_at_open").values
    if len(at_open) != 2 or abs(at_open[1] - at_open[0]) > DEVICE_BYTES_SLACK:
        fail(f"widedeep-online: device bytes at each open {at_open}: the failed attempt's "
             "state must be released before the restart opens")
    widedeep_row = {
        "events": len(events), "steps": len(wl), "expected_steps": want_steps,
        "steps_per_s": cell.rate(b.arrivals), "records_per_s": len(events) / b.seconds,
        "job_seconds": b.seconds,
        "loss_first_fifth": float(np.mean(wl[:fifth])),
        "loss_last_fifth": float(np.mean(wl[-fifth:])), "mean_drop_within_user": user_drop,
        "vs_cpu": cpu_errs, "cpu_job_seconds": cpu.seconds,
        "checkpointed_job_seconds": plain.seconds, "restart_job_seconds": crashed.seconds,
        "restarts": restarts, "crash_at_event": tap.crashed_at, "last_checkpoint_id": cid,
        "restart_bit_equal": restart_bits,
        "restart_param_err": restart_err, "device_bytes_at_open": at_open, "card": card,
    }
    print("widedeep_online", json.dumps(widedeep_row), flush=True)
    for key in ("steps_per_s", "records_per_s", "loss_first_fifth", "loss_last_fifth",
                "mean_drop_within_user"):
        print(f"widedeep-online {key}: {widedeep_row[key]} | card: {card}", flush=True)
    if fa.flash_attention.launches != 0:
        fail(f"training launched K1 {fa.flash_attention.launches} times, want 0")
    resnet_ref = {"mdef": mdef, "schema": schema, "records": records, "losses": losses,
                  "final": final, "row": resnet_row}
    return {"resnet_train": 0, "widedeep_online": 0}, resnet_ref


def stream_row(card, name, run, records, first_batch, *extra_keys, **extra):
    """The cell's numbers from one run (``stream_cell.CellRun``), printed
    beside the card line; ``name`` is the operator's name, whose subtasks'
    metrics are summed (counters) or listed (latency percentiles)."""
    from flink_tensorflow_tpu_torch.models.stream_cell import steady_rps

    subtasks = sorted({k.split(".")[1] for k in run.metrics if k.startswith(name + ".")})
    m = [{k.split(".", 2)[2]: v for k, v in run.metrics.items()
          if k.startswith(f"{name}.{i}.")} for i in subtasks]
    rps, span = steady_rps(run.arrivals, records, first_batch)
    batches = sum(x["batches"] for x in m)
    row = {
        "records": records, "records_per_s": rps, "steady_span_s": span,
        "job_seconds": run.seconds, "job_records_per_s": records / run.seconds,
        "record_latency_p50_ms": [x["record_latency_s"]["p50"] * 1e3 for x in m],
        "record_latency_p95_ms": [x["record_latency_s"]["p95"] * 1e3 for x in m],
        "batch_latency_p50_ms": [x["batch_latency_s"]["p50"] * 1e3 for x in m],
        "h2d_bytes_per_batch": sum(x["h2d_bytes"] for x in m) / batches,
        "batches": batches, "padded_records": sum(x["padded_records"] for x in m),
        "pinned_allocations": sum(x["pinned_allocations"] for x in m),
        "warmup_s": [x["warmup_s"]["p50"] for x in m if "warmup_s" in x],
        "assemble_p50_ms": [x["assemble_s"]["p50"] * 1e3 for x in m],
        "dispatch_p50_ms": [x["dispatch_s"]["p50"] * 1e3 for x in m],
        "fetch_wait_p50_ms": [x["fetch_wait_s"]["p50"] * 1e3 for x in m],
        **extra, "card": card,
    }
    for key in ("records_per_s", "job_records_per_s", "record_latency_p50_ms",
                "record_latency_p95_ms", "h2d_bytes_per_batch", "batches", "padded_records",
                "pinned_allocations", "warmup_s", *extra_keys):
        print(f"{name} {key}: {row[key]} | card: {card}", flush=True)
    return row


def rel(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def check_ids(what, results, n):
    ids = [int(r.meta["id"]) for r in results]
    if sorted(ids) != list(range(n)):
        fail(f"{what}: {len(ids)} results, {len(set(ids))} distinct ids, want each of {n} once")


def check_lenet(card: str, torch):
    """Phase 8 (a): the mnist-lenet cell on the card, and its checks."""
    import copy

    import numpy as np

    from flink_tensorflow_tpu_torch.models import lenet_cell as cell
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def

    t0 = time.monotonic()
    mdef, model, images, records = cell.lenet_cell(SEED)
    run = cell.run_cell(model, records)
    check_ids("mnist-lenet", run.results, cell.RECORDS)
    m = run.metrics
    if m["lenet.0.batches"] != cell.RECORDS // cell.BATCH or m["lenet.0.padded_records"]:
        fail(f"mnist-lenet: {m['lenet.0.batches']} batches, {m['lenet.0.padded_records']} "
             "padded records: the windows were not the arrival order's 512s")
    got = np.empty(cell.RECORDS, np.int32)
    for r in run.results:
        got[r.meta["id"]] = r["label"]
    serve = mdef.methods["serve"].fn
    module = copy.deepcopy(model.params).to("cuda")
    want = np.empty_like(got)
    with torch.inference_mode():
        for lo in range(0, cell.RECORDS, cell.BATCH):
            out = serve(module, {"image": torch.from_numpy(images[lo:lo + cell.BATCH]).cuda()})
            want[lo:lo + cell.BATCH] = out["label"].cpu().numpy()
            if lo == 0:
                card_bf16 = out["logits"][:4].cpu().numpy()
    if not np.array_equal(got, want):
        bad = np.nonzero(got != want)[0]
        fail(f"mnist-lenet: {len(bad)} labels differ from the direct call, first id {bad[0]}")
    x = torch.from_numpy(images[:4].copy())
    with torch.inference_mode():
        cpu_bf16 = serve(model.params, {"image": x})["logits"].numpy()
        f32 = get_model_def("lenet", compute_dtype="float32")
        f32_module = f32.to_model(model.params).params
        cpu_f32 = f32.methods["serve"].fn(f32_module, {"image": x})["logits"].numpy()
        card_f32 = f32.methods["serve"].fn(copy.deepcopy(f32_module).to("cuda"),
                                           {"image": x.cuda()})["logits"].cpu().numpy()
    bf16_err, f32_err = rel(card_bf16, cpu_bf16), rel(card_f32, cpu_f32)
    if not (np.isfinite(card_bf16).all() and bf16_err <= STREAM_BF16_TOL):
        fail(f"mnist-lenet: card bf16 logits differ from the CPU's by {bf16_err} of max |logit|")
    if not (np.isfinite(card_f32).all() and f32_err <= LENET_F32_TOL):
        fail(f"mnist-lenet: card f32 logits differ from the CPU's by {f32_err} of max |logit|")
    return stream_row(card, "lenet", run, cell.RECORDS, cell.BATCH, "phase_seconds",
                      batch=cell.BATCH, bf16_rel_err_vs_cpu=bf16_err,
                      bf16_tolerance=STREAM_BF16_TOL, f32_rel_err_vs_cpu=f32_err,
                      f32_tolerance=LENET_F32_TOL,
                      phase_seconds=time.monotonic() - t0)


def lstm_routes(card: str, torch, model, batches):
    """Both cuDNN routes of the BiLSTM against its plain step loop on the
    card, on ``batches`` (``(tokens, lengths)`` on the card): the largest
    error of the final hidden states (the recurrence's own error, before
    the bf16 Dense rounds it) and of the logits, each relative to the
    plain path's largest magnitude; ms per call on the first batch (CUDA
    events); and the three costliest kernels (to show which library ran).
    The cell runs the default route (``CUDA_ROUTE``); the rule that chose
    it is re-read here and printed, not applied.  Returns ``{route: row}``."""
    import copy

    from flink_tensorflow_tpu_torch.models.zoo.bilstm import CUDA_ROUTE

    module = copy.deepcopy(model.params).to("cuda")
    with torch.inference_mode():
        plain = [(module.states(x, n, route="plain").cpu().numpy(),
                  module(x, n, route="plain").cpu().numpy()) for x, n in batches]
        x0, n0 = batches[0]
        plain_ms = time_ms(lambda: module(x0, n0, route="plain"), 2)
    rows = {}
    for route in ("cudnn_f32", "cudnn_bf16"):
        try:
            with torch.inference_mode():
                got = [(module.states(x, n, route=route).cpu().numpy(),
                        module(x, n, route=route).cpu().numpy()) for x, n in batches]
                ms = time_ms(lambda: module(x0, n0, route=route), 20)
                activities = [torch.profiler.ProfilerActivity.CPU,
                              torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=activities) as prof:
                    module(x0, n0, route=route)
                    torch.cuda.synchronize()
        except RuntimeError as exc:   # this build's cuDNN RNN may refuse bf16
            if route == CUDA_ROUTE:
                raise
            rows[route] = {"supported": False, "error": str(exc)[:300]}
            continue
        kernels = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:3]
        rows[route] = {
            "supported": True,
            "states_rel_err_vs_plain": max(rel(g[0], p[0]) for g, p in zip(got, plain)),
            "logits_rel_err_vs_plain": max(rel(g[1], p[1]) for g, p in zip(got, plain)),
            "ms": ms, "top_kernels": [e.key[:80] for e in kernels]}
    ok = [r for r in rows if rows[r]["supported"]]
    closer = min(ok, key=lambda r: rows[r]["states_rel_err_vs_plain"])
    other = [r for r in ok if r != closer]
    if other and rows[closer]["ms"] > LSTM_ROUTE_TIME_FACTOR * rows[other[0]]["ms"]:
        closer = other[0]
    rows["plain"] = {"ms": plain_ms, "batches_compared": len(batches)}
    for route, row in rows.items():
        print(f"bilstm route {route}: {json.dumps(row)} | card: {card}", flush=True)
    print(f"bilstm route run: {CUDA_ROUTE} (the default); the rule picks {closer} in this "
          f"run | card: {card}", flush=True)
    return rows


def check_bilstm(card: str, torch):
    """Phase 8 (b): the bilstm cell on the card, its LSTM routes, and its
    checks."""
    import copy

    import numpy as np

    from flink_tensorflow_tpu_torch.models import bilstm_cell as cell
    from flink_tensorflow_tpu_torch.models.zoo.bilstm import CUDA_ROUTE
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy, assemble

    t0 = time.monotonic()
    mdef, model, records = cell.bilstm_cell(SEED)
    batches = [assemble(records[lo:lo + cell.BATCH], mdef.input_schema, BucketPolicy())
               for lo in range(0, cell.RECORDS, cell.BATCH)]
    first = batches[0]
    routes = lstm_routes(card, torch, model, [
        (torch.from_numpy(b.arrays["tokens"].copy()).cuda(),
         torch.from_numpy(b.lengths["tokens"].copy()).cuda()) for b in batches[:LSTM_ROUTE_BATCHES]])

    run = cell.run_cell(model, records)
    check_ids("bilstm", run.results, cell.RECORDS)
    if run.metrics["bilstm.0.batches"] != len(batches):
        fail(f"bilstm: {run.metrics['bilstm.0.batches']} batches: the windows were not "
             "the arrival order's 64s")
    got = {r.meta["id"]: r for r in run.results}
    module = copy.deepcopy(model.params).to("cuda")
    serve = mdef.methods["serve"].fn
    with torch.inference_mode():
        for k, batch in enumerate(batches):
            out = serve(module, {"tokens": torch.from_numpy(batch.arrays["tokens"]).cuda()},
                        {"tokens": torch.from_numpy(batch.lengths["tokens"]).cuda()})
            label, prob = out["label"].cpu().numpy(), out["prob"].cpu().numpy()
            for j in range(cell.BATCH):
                r = got[k * cell.BATCH + j]
                if int(r["label"]) != label[j] or not np.array_equal(r["prob"], prob[j]):
                    fail(f"bilstm: record {k * cell.BATCH + j} differs from the direct call")
            if k == 0:
                card_logits = out["logits"].cpu().numpy()
                card_states = module.states(
                    torch.from_numpy(batch.arrays["tokens"]).cuda(),
                    torch.from_numpy(batch.lengths["tokens"]).cuda()).cpu().numpy()

    # A record alone at its own bucket against the same record in the
    # first batch, padded to 256.
    j = int(np.argmin(first.lengths["tokens"]))
    alone = assemble([records[j]], mdef.input_schema, BucketPolicy())
    with torch.inference_mode():
        x1 = torch.from_numpy(alone.arrays["tokens"]).cuda()
        n1 = torch.from_numpy(alone.lengths["tokens"]).cuda()
        alone_logits = module(x1, n1).cpu().numpy()
        alone_states = module.states(x1, n1).cpu().numpy()
    pad_err = rel(alone_logits[0], card_logits[j])
    pad_states_err = rel(alone_states[0], card_states[j])
    pad_abs = float(np.abs(alone_logits[0] - card_logits[j]).max())
    if not (pad_err <= BILSTM_PAD_TOL and pad_states_err <= BILSTM_PAD_TOL):
        fail(f"bilstm: record {j} alone (bucket {alone.arrays['tokens'].shape[1]}) differs "
             f"from it in a batch padded to {first.arrays['tokens'].shape[1]} by {pad_err} "
             f"(logits), {pad_states_err} (final states) > {BILSTM_PAD_TOL}")

    # 4 records of the first batch through the CPU's plain bf16 and f32 paths.
    few = assemble(records[:4], mdef.input_schema, BucketPolicy())
    x = torch.from_numpy(few.arrays["tokens"].copy())
    n = torch.from_numpy(few.lengths["tokens"].copy())
    # The card's f32 forward is the cuDNN f32 route on unrounded weights,
    # with cuDNN's RNN at PyTorch's default (TF32 allowed), as a job runs
    # it: the port's own call must keep TF32 off.
    f32 = get_model_def("bilstm", vocab_size=cell.VOCAB, embed_dim=128, hidden_dim=cell.HIDDEN,
                        num_classes=2, compute_dtype="float32")
    f32_module = f32.to_model(model.params).params
    with torch.inference_mode():
        card_bf16 = module(x.cuda(), n.cuda()).cpu().numpy()
        cpu_bf16 = model.params(x, n).numpy()
        torch.backends.cudnn.allow_tf32 = True
        try:
            card_f32 = copy.deepcopy(f32_module).to("cuda")(x.cuda(), n.cuda()).cpu().numpy()
            tf32_kept = torch._C._get_cudnn_allow_tf32()
        finally:
            torch.backends.cudnn.allow_tf32 = False
        cpu_f32 = f32_module(x, n).numpy()
    if not tf32_kept:
        fail("bilstm: the f32 route did not give the caller's TF32 setting back")
    bf16_err, f32_err = rel(card_bf16, cpu_bf16), rel(card_f32, cpu_f32)
    if not (np.isfinite(card_bf16).all() and bf16_err <= STREAM_BF16_TOL):
        fail(f"bilstm: card bf16 logits differ from the CPU's by {bf16_err} of max |logit|")
    if not (np.isfinite(card_f32).all() and f32_err <= BILSTM_F32_TOL):
        fail(f"bilstm: card f32 logits differ from the CPU's by {f32_err} of max |logit| "
             f"> {BILSTM_F32_TOL}")
    return stream_row(card, "bilstm", run, cell.RECORDS, cell.BATCH, "lstm_route",
                      "padding_rel_err", "padding_states_rel_err", "f32_rel_err_vs_cpu",
                      "phase_seconds",
                      batch=cell.BATCH, lstm_route=CUDA_ROUTE, lstm_routes=routes,
                      padding_rel_err=pad_err, padding_states_rel_err=pad_states_err,
                      padding_tolerance=BILSTM_PAD_TOL, padding_exact=pad_abs == 0.0,
                      padding_lengths=[int(first.lengths["tokens"][j]),
                                       int(alone.arrays["tokens"].shape[1]),
                                       int(first.arrays["tokens"].shape[1])],
                      bf16_rel_err_vs_cpu=bf16_err, bf16_tolerance=STREAM_BF16_TOL,
                      f32_rel_err_vs_cpu=f32_err, f32_tolerance=BILSTM_F32_TOL,
                      phase_seconds=time.monotonic() - t0)


def check_inception_map(card: str, torch, inception):
    """Phase 8 (c): phase 5's Inception saved as a bundle and served per
    record by ``ModelMapFunction`` at parallelism 2, and its checks."""
    import copy
    import tempfile

    import numpy as np

    from flink_tensorflow_tpu_torch.functions.model_function import ModelMapFunction
    from flink_tensorflow_tpu_torch.models.loaders import SavedModelLoader, save_bundle
    from flink_tensorflow_tpu_torch.models.stream_cell import run_job
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    t0 = time.monotonic()
    mdef, model, pixels = inception
    records = [TensorValue({"image": pixels[i]}, {"id": i}) for i in range(MAP_RECORDS)]
    with tempfile.TemporaryDirectory() as tmp:
        bundle = os.path.join(tmp, "inception")
        save_bundle(mdef, model.params, bundle)
        save_s = time.monotonic() - t0
        # idle_flush_s=1.0: the source never idles for a second, so every
        # micro-batch is a subtask's next 32 records and the direct call
        # below runs the same batches.
        fn = ModelMapFunction(bundle, micro_batch=MAP_MICRO_BATCH, idle_flush_s=1.0,
                              warmup_batches=(MAP_MICRO_BATCH,), outputs=("label", "score"))
        run = run_job(records, lambda s: s.rebalance().map(fn, name="inception_map",
                                                            parallelism=MAP_PARALLELISM))
        loaded = SavedModelLoader(bundle).load()
    check_ids("inception-map", run.results, MAP_RECORDS)
    per_subtask = MAP_RECORDS // MAP_PARALLELISM
    for i in range(MAP_PARALLELISM):
        b = run.metrics[f"inception_map.{i}.batches"]
        if b != per_subtask // MAP_MICRO_BATCH or run.metrics[f"inception_map.{i}.padded_records"]:
            fail(f"inception-map: subtask {i} ran {b} batches: not its arrival order's 32s")
    for name, p in model.params.state_dict().items():
        if not torch.equal(loaded.params.state_dict()[name], p):
            fail(f"inception-map: the bundle's {name} differs from the saved module's")
    got = {r.meta["id"]: r for r in run.results}
    serve = mdef.methods["serve"].fn
    module = copy.deepcopy(loaded.params).to("cuda")
    with torch.inference_mode():
        for i in range(MAP_PARALLELISM):
            ids = np.arange(i, MAP_RECORDS, MAP_PARALLELISM)
            for lo in range(0, per_subtask, MAP_MICRO_BATCH):
                batch = ids[lo:lo + MAP_MICRO_BATCH]
                out = serve(module, {"image": torch.from_numpy(pixels[batch]).cuda()})
                label, score = out["label"].cpu().numpy(), out["score"].cpu().numpy()
                for j, rid in enumerate(batch):
                    if int(got[rid]["label"]) != label[j] or float(got[rid]["score"]) != score[j]:
                        fail(f"inception-map: record {rid} differs from the direct call")
                if i == 0 and lo == 0:
                    card_bf16 = out["logits"][:2].float().cpu().numpy()
    # Records 0 and 2 (subtask 0's first two) through the CPU's paths.
    x = torch.from_numpy(pixels[[0, 2]].copy())
    f32 = get_model_def("inception_v3", num_classes=mdef.config["num_classes"],
                        image_size=mdef.config["image_size"], uint8_input=True,
                        compute_dtype="float32")
    f32_module = f32.to_model(loaded.params).params
    with torch.inference_mode():
        cpu_bf16 = serve(loaded.params, {"image": x})["logits"].float().numpy()
        cpu_f32 = f32.methods["serve"].fn(f32_module, {"image": x})["logits"].numpy()
        card_f32 = f32.methods["serve"].fn(copy.deepcopy(f32_module).to("cuda"),
                                           {"image": x.cuda()})["logits"].cpu().numpy()
    bf16_err, f32_err = rel(card_bf16, cpu_bf16), rel(card_f32, cpu_f32)
    if not (np.isfinite(card_bf16).all() and bf16_err <= INCEPTION_BF16_TOL):
        fail(f"inception-map: card bf16 logits differ from the CPU's by {bf16_err}")
    if not (np.isfinite(card_f32).all() and f32_err <= INCEPTION_F32_TOL):
        fail(f"inception-map: card f32 logits differ from the CPU's by {f32_err}")
    return stream_row(card, "inception_map", run, MAP_RECORDS,
                      MAP_MICRO_BATCH * MAP_PARALLELISM, "phase_seconds",
                      micro_batch=MAP_MICRO_BATCH, parallelism=MAP_PARALLELISM,
                      bundle_save_s=save_s, bf16_rel_err_vs_cpu=bf16_err,
                      bf16_tolerance=INCEPTION_BF16_TOL, f32_rel_err_vs_cpu=f32_err,
                      f32_tolerance=INCEPTION_F32_TOL, phase_seconds=time.monotonic() - t0)


def check_stream_models(card: str, torch, fa, inception):
    """Phase 8: the three jobs, K1's launches counted on each."""
    launches = {}
    for path, check in (("mnist_lenet", lambda: check_lenet(card, torch)),
                        ("bilstm", lambda: check_bilstm(card, torch)),
                        ("inception_map", lambda: check_inception_map(card, torch, inception))):
        fa.flash_attention.launches = 0
        row = check()
        launches[path] = fa.flash_attention.launches
        if launches[path] != 0:
            fail(f"{path} launched K1 {launches[path]} times, want 0")
        print(path, json.dumps(row), flush=True)
    return launches


def fused_edge_puts(run) -> dict:
    """Queue-put gauges on the edges the plan fused: none may exist (a
    fused edge has no channel)."""
    fused = []
    for line in run.plan.splitlines():
        members = re.split(r" -> | => ", line.split(": ", 1)[1])
        fused += list(zip(members, members[1:]))
    return {k: v for k, v in run.metrics.items()
            if any(k.startswith(f"{d}.") and k.endswith(f"_{u}_queue_puts") for u, d in fused)}


#: The order of the two arms of a phase 9 comparison, A B B A: host time
#: drifts within a call, and the first run in a process pays lazy loads.
ABBA = (True, False, False, True)


def check_layouts(card, what, runs, want):
    """Print each run's layout and fail unless (threads, gates) is ``want``
    for it; no queue traffic on a fused edge."""
    for chaining, run in runs:
        layout = "chained" if chaining else "unchained"
        puts = fused_edge_puts(run)
        print(f"{what} {layout} plan:\n" + "\n".join("  " + x for x in run.plan.splitlines()),
              flush=True)
        print(f"{what} {layout}: threads {run.threads}, gates {run.gates}, "
              f"queue puts on fused edges {puts or 'none'} | card: {card}", flush=True)
        if (run.threads, run.gates) != want[chaining] or puts:
            fail(f"{what} {layout}: {run.threads} threads, {run.gates} gates, fused-edge "
                 f"puts {puts}; want {want[chaining]} and none")


def labels_scores(results, n):
    import numpy as np

    label = np.empty(n, np.int32)
    score = np.empty(n, np.float32)
    for r in results:
        label[r.meta["id"]] = r["label"]
        score[r.meta["id"]] = r["score"]
    return label, score


def check_chained_inception_stream(card, torch, inception, direct):
    """Phase 9 (a): phase 5's cell chained (the default) and unchained:
    labels and scores equal bit for bit between the two and with phase
    5's direct calls."""
    import numpy as np

    from flink_tensorflow_tpu_torch.models import inception_cell as cell
    from flink_tensorflow_tpu_torch.models.stream_cell import steady_rps
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    _, model, pixels = inception
    records = [TensorValue({"image": pixels[i]}, {"id": i}) for i in range(cell.RECORDS)]
    runs = [(c, cell.run_cell_job(model, records, chaining=c)) for c in ABBA]
    check_layouts(card, "inception-stream", runs, {True: (2, 1), False: (3, 2)})
    row = {"card": card, "order": "chained, unchained, unchained, chained",
           "chained": [], "unchained": []}
    for chaining, run in runs:
        layout = "chained" if chaining else "unchained"
        check_ids(f"inception-stream {layout}", run.results, cell.RECORDS)
        label, score = labels_scores(run.results, cell.RECORDS)
        if not (np.array_equal(label, direct[0]) and np.array_equal(score, direct[1])):
            fail(f"inception-stream {layout}: labels or scores differ from the direct calls")
        rps, span = steady_rps(run.arrivals, cell.RECORDS, cell.BATCH,
                               cell.trailing_exclude(cell.RECORDS))
        row[layout].append({"records_per_s": rps, "steady_span_s": span,
                            "job_seconds": run.seconds, "threads": run.threads,
                            "gates": run.gates})
    print_rates(card, "inception-stream", row)
    return row


def print_rates(card, what, row):
    rates = {k: [x["records_per_s"] for x in row[k]] for k in ("chained", "unchained")}
    print(f"{what} records_per_s chained {rates['chained']} unchained {rates['unchained']} "
          f"| card: {card}", flush=True)


def check_chained_inception_map(card, torch, inception):
    """Phase 9 (b): phase 8 (c)'s bundle at parallelism 1 with no
    rebalance, chained (the sink fuses behind the timer-driven map, which
    is cut from the source) and unchained: equal results, equal to direct
    calls over the same micro-batches."""
    import copy
    import tempfile

    import numpy as np

    from flink_tensorflow_tpu_torch.functions.model_function import ModelMapFunction
    from flink_tensorflow_tpu_torch.models.loaders import save_bundle
    from flink_tensorflow_tpu_torch.models.stream_cell import run_job, steady_rps
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    mdef, model, pixels = inception
    records = [TensorValue({"image": pixels[i]}, {"id": i}) for i in range(MAP_RECORDS)]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        bundle = os.path.join(tmp, "inception")
        save_bundle(mdef, model.params, bundle)
        for chaining in ABBA:
            fn = ModelMapFunction(bundle, micro_batch=MAP_MICRO_BATCH, idle_flush_s=1.0,
                                  warmup_batches=(MAP_MICRO_BATCH,), outputs=("label", "score"))
            runs.append((chaining, run_job(records, lambda s: s.map(fn, name="inception_map"),
                                           config={"chaining": chaining})))
    check_layouts(card, "inception-map", runs, {True: (2, 1), False: (3, 2)})
    serve = mdef.methods["serve"].fn
    module = copy.deepcopy(model.params).to("cuda")
    want_label = np.empty(MAP_RECORDS, np.int32)
    want_score = np.empty(MAP_RECORDS, np.float32)
    with torch.inference_mode():
        for lo in range(0, MAP_RECORDS, MAP_MICRO_BATCH):
            out = serve(module, {"image": torch.from_numpy(
                pixels[lo:lo + MAP_MICRO_BATCH].copy()).cuda()})
            want_label[lo:lo + MAP_MICRO_BATCH] = out["label"].cpu().numpy()
            want_score[lo:lo + MAP_MICRO_BATCH] = out["score"].cpu().numpy()
    del module
    row = {"card": card, "records": MAP_RECORDS, "micro_batch": MAP_MICRO_BATCH,
           "order": "chained, unchained, unchained, chained", "chained": [], "unchained": []}
    for chaining, run in runs:
        layout = "chained" if chaining else "unchained"
        check_ids(f"inception-map {layout}", run.results, MAP_RECORDS)
        m = run.metrics
        if (m["inception_map.0.batches"] != MAP_RECORDS // MAP_MICRO_BATCH
                or m["inception_map.0.padded_records"]):
            fail(f"inception-map {layout}: {m['inception_map.0.batches']} batches: not the "
                 "arrival order's 32s")
        label, score = labels_scores(run.results, MAP_RECORDS)
        if not (np.array_equal(label, want_label) and np.array_equal(score, want_score)):
            fail(f"inception-map {layout}: labels or scores differ from the direct calls")
        rps, span = steady_rps(run.arrivals, MAP_RECORDS, MAP_MICRO_BATCH)
        row[layout].append({"records_per_s": rps, "steady_span_s": span,
                            "job_seconds": run.seconds, "threads": run.threads,
                            "gates": run.gates})
    print_rates(card, "inception-map", row)
    return row


def run_resident(records, build, device_resident: bool, paced_rate=None):
    """``from_collection(records) -> build(stream) -> sink`` with
    ``device_resident`` on or off; the source stamps each record's
    emission, the sink its arrival.  With ``paced_rate``, the source is a
    Poisson ``PacedSource`` at that many records/s instead, and latency
    runs from each record's scheduled arrival (``sched_ts``).  Returns
    ``(results, end-to-end seconds per record, metric report, plan,
    seconds)``."""
    from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.io.sources import CollectionSource, PacedSource

    stamps = {}

    class StampedCollection(CollectionSource):
        def clone(self):
            return self

        def run(self):
            for r in self.data:
                stamps[r.meta["id"]] = time.monotonic()
                yield r

    results, latency = [], []

    def sink(r):
        start = r.meta["sched_ts"] if paced_rate else stamps[r.meta["id"]]
        latency.append(time.monotonic() - start)
        results.append(r)

    env = StreamExecutionEnvironment(parallelism=1)
    env.configure(device_resident=device_resident)
    source = (PacedSource(records, paced_rate, jitter="poisson") if paced_rate
              else StampedCollection(records))
    build(env.from_source(source, name="collection")).sink_to_callable(sink)
    plan = env.describe()
    t0 = time.monotonic()
    metrics = env.execute(timeout=600).metrics
    return results, latency, metrics, plan, time.monotonic() - t0


def transfer_counts(metrics) -> dict:
    """H2D and D2H batches and bytes summed over the job's operators."""
    return {key: sum(v for k, v in metrics.items() if k.endswith("." + key))
            for key in ("h2d_batches", "h2d_bytes", "d2h_batches", "d2h_bytes",
                        "fetch_elided_batches", "h2d_elided_batches")}


def arm_row(card, what, arm, latency, metrics, seconds):
    import numpy as np

    row = {**transfer_counts(metrics), "e2e_p50_ms": float(np.percentile(latency, 50)) * 1e3,
           "e2e_p95_ms": float(np.percentile(latency, 95)) * 1e3, "job_seconds": seconds}
    print(f"{what} device_resident={arm}: " + ", ".join(f"{k} {v}" for k, v in row.items())
          + f" | card: {card}", flush=True)
    return row


def softmax_top1(t):
    """The elementwise link of phase 9 (c), on the logits where they lie."""
    import torch

    score, label = torch.softmax(t["logits"], dim=-1).max(dim=-1)
    return {"label": label.to(torch.int32), "score": score}


def check_resident_inception(card, torch, inception):
    """Phase 9 (c): ``map(ModelMapFunction(inception, outputs=logits)) =>
    map(DeviceMapFunction(softmax + top-1)) -> sink`` with residency on
    and off."""
    import copy

    import numpy as np

    from flink_tensorflow_tpu_torch.functions.model_function import (
        DeviceMapFunction,
        ModelMapFunction,
    )
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    mdef, model, pixels = inception
    records = [TensorValue({"image": pixels[i]}, {"id": i}) for i in range(MAP_RECORDS)]
    batches = MAP_RECORDS // MAP_MICRO_BATCH

    def build(s):
        return (s.map(ModelMapFunction(model, outputs=("logits",), micro_batch=MAP_MICRO_BATCH,
                                       idle_flush_s=1.0, warmup_batches=(MAP_MICRO_BATCH,)),
                      name="inception_map")
                .map(DeviceMapFunction(softmax_top1), name="softmax"))

    arms = [(on, run_resident(records, build, on)) for on in ABBA]
    plan = arms[0][1][3]
    print("inception-resident plan:\n" + "\n".join("  " + x for x in plan.splitlines()),
          flush=True)
    if "inception_map => softmax -> sink" not in plan:
        fail(f"inception-resident: the model and the map did not fuse on the device: {plan}")
    serve = mdef.methods["serve"].fn
    module = copy.deepcopy(model.params).to("cuda")
    want_label = np.empty(MAP_RECORDS, np.int32)
    want_score = np.empty(MAP_RECORDS, np.float32)
    with torch.inference_mode():
        for lo in range(0, MAP_RECORDS, MAP_MICRO_BATCH):
            logits = serve(module, {"image": torch.from_numpy(
                pixels[lo:lo + MAP_MICRO_BATCH].copy()).cuda()})["logits"]
            out = softmax_top1({"logits": logits})
            want_label[lo:lo + MAP_MICRO_BATCH] = out["label"].cpu().numpy()
            want_score[lo:lo + MAP_MICRO_BATCH] = out["score"].cpu().numpy()
    del module
    row = {"card": card, "records": MAP_RECORDS, "micro_batch": MAP_MICRO_BATCH,
           "order": "on, off, off, on", "score_tolerance_off_vs_on": CHAIN_SCORE_TOL,
           "on": [], "off": []}
    got = {}
    for on, (results, latency, metrics, _, seconds) in arms:
        check_ids(f"inception-resident device_resident={on}", results, MAP_RECORDS)
        got[on] = labels_scores(results, MAP_RECORDS)
        counts = arm_row(card, "inception-resident", on, latency, metrics, seconds)
        row["on" if on else "off"].append(counts)
        if on and not (metrics["inception_map.0.fetch_elided_batches"]
                       == metrics["inception_map.0.batches"] == batches
                       and counts["h2d_batches"] == counts["d2h_batches"] == batches
                       and metrics["softmax.0.d2h_batches"] == batches):
            fail(f"inception-resident on: {counts}; want {batches} batches with one H2D (the "
                 "model's) and one D2H (at the sink) each")
        if not on and not (counts["fetch_elided_batches"] == 0
                           and counts["d2h_batches"] == batches + MAP_RECORDS):
            fail(f"inception-resident off: {counts}; want the model's D2H per batch and the "
                 "map's per record")
        if on and not (np.array_equal(got[on][0], want_label)
                       and np.array_equal(got[on][1], want_score)):
            fail("inception-resident on: labels or scores differ from the direct calls")
    score_err = float(np.abs(got[False][1] - got[True][1]).max())
    row["score_max_abs_err_off_vs_on"] = score_err
    row["scores_bit_equal"] = bool(np.array_equal(got[False][1], got[True][1]))
    if not np.array_equal(got[False][0], got[True][0]) or score_err > CHAIN_SCORE_TOL:
        fail(f"inception-resident: the arms' labels differ or their scores by {score_err}")
    return row


def resmlp_model(torch, rng):
    """``bench.py:bench_deviceres``'s model at its full size: ``tanh(x @ w)
    + x`` over a 4096-wide f32 record, ``w`` from ``RandomState(7)``."""
    import numpy as np

    from flink_tensorflow_tpu_torch.models.base import Model, ModelMethod
    from flink_tensorflow_tpu_torch.tensors.schema import RecordSchema, spec

    class ResMLP(torch.nn.Module):
        def __init__(self, w):
            super().__init__()
            self.register_buffer("w", torch.from_numpy(w))

    def serve(module, inputs):
        return {"x": torch.tanh(inputs["x"] @ module.w) + inputs["x"]}

    # As the bench: f32 draws over sqrt(dim) in f64, stored as f32.
    w = (rng.randn(RESMLP_DIM, RESMLP_DIM).astype(np.float32)
         / np.sqrt(RESMLP_DIM)).astype(np.float32)
    schema = RecordSchema({"x": spec((RESMLP_DIM,), np.float32)})
    return Model("resmlp", ResMLP(w), {"serve": ModelMethod("serve", schema, ("x",), serve)})


def check_resident_resmlp(card, torch):
    """Phase 9 (d): two chained ``ModelMapFunction``s over resmlp, 512
    records from a Poisson ``PacedSource`` at ``RESMLP_RATE`` in
    micro-batches of 8, residency on and off."""
    import numpy as np

    from flink_tensorflow_tpu_torch.functions.model_function import ModelMapFunction
    from flink_tensorflow_tpu_torch.tensors.batching import BucketLadder
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    rng = np.random.RandomState(7)
    model = resmlp_model(torch, rng)
    records = [TensorValue({"x": rng.rand(RESMLP_DIM).astype(np.float32)}, {"id": i})
               for i in range(RESMLP_RECORDS)]
    batches = RESMLP_RECORDS // RESMLP_MICRO

    def build(s):
        return (s.map(ModelMapFunction(model, micro_batch=RESMLP_MICRO, idle_flush_s=1.0,
                                       warmup_batches=tuple(BucketLadder.up_to(RESMLP_MICRO).sizes)),
                      name="model_a")
                .map(ModelMapFunction(model, micro_batch=RESMLP_MICRO, idle_flush_s=1.0),
                     name="model_b"))

    arms = [(on, run_resident(records, build, on, paced_rate=RESMLP_RATE)) for on in ABBA]
    plan = arms[0][1][3]
    print("resmlp-resident plan:\n" + "\n".join("  " + x for x in plan.splitlines()), flush=True)
    if "model_a => model_b -> sink" not in plan:
        fail(f"resmlp-resident: the two models did not fuse on the device: {plan}")
    row = {"card": card, "records": RESMLP_RECORDS, "dim": RESMLP_DIM,
           "micro_batch": RESMLP_MICRO,
           "source": f"PacedSource({RESMLP_RATE}, jitter=poisson)",
           "order": "on, off, off, on", "on": [], "off": []}
    out = {}
    for on, (results, latency, metrics, _, seconds) in arms:
        check_ids(f"resmlp-resident device_resident={on}", results, RESMLP_RECORDS)
        x = np.empty((RESMLP_RECORDS, RESMLP_DIM), np.float32)
        for r in results:
            x[r.meta["id"]] = r["x"]
        if on in out and not np.array_equal(out[on], x):
            fail(f"resmlp-resident device_resident={on}: two runs of the arm differ")
        out[on] = x
        counts = arm_row(card, "resmlp-resident", on, latency, metrics, seconds)
        row["on" if on else "off"].append(counts)
        if on and not (counts["h2d_batches"] == counts["d2h_batches"]
                       == counts["fetch_elided_batches"] == counts["h2d_elided_batches"]
                       == batches):
            fail(f"resmlp-resident on: {counts}; want one H2D and one D2H per micro-batch "
                 f"({batches})")
        if not on and not (counts["h2d_batches"] == counts["d2h_batches"] == 2 * batches
                           and counts["fetch_elided_batches"] == 0):
            fail(f"resmlp-resident off: {counts}; want two H2Ds and two D2Hs per micro-batch")
    if not np.array_equal(out[True], out[False]):
        fail(f"resmlp-resident: the arms differ by {np.abs(out[True] - out[False]).max()}")
    on, off = row["on"][0], row["off"][0]
    x = torch.from_numpy(np.stack([r["x"] for r in records[:RESMLP_MICRO]]))
    with torch.inference_mode():
        cpu = model.method("serve").fn(model.params, {"x": model.method("serve").fn(
            model.params, {"x": x})["x"]})["x"].numpy()
    err = rel(out[True][:RESMLP_MICRO], cpu)
    row["f32_rel_err_vs_cpu"], row["f32_tolerance"] = err, RESMLP_F32_TOL
    row["h2d_bytes_on_over_off"] = on["h2d_bytes"] / off["h2d_bytes"]
    if not (np.isfinite(out[True]).all() and err <= RESMLP_F32_TOL):
        fail(f"resmlp-resident: card f32 differs from the CPU's by {err} of max |x|")
    print(f"resmlp-resident h2d_bytes on {on['h2d_bytes']} off {off['h2d_bytes']} "
          f"| card: {card}", flush=True)
    return row


def check_chaining(card, torch, fa, inception, direct):
    """Phase 9: the chained layout and device-resident chains at full
    width; K1 must launch 0 times (no attention on these paths)."""
    t0 = time.monotonic()
    fa.flash_attention.launches = 0
    rows = {"inception_stream": check_chained_inception_stream(card, torch, inception, direct),
            "inception_map": check_chained_inception_map(card, torch, inception),
            "inception_resident": check_resident_inception(card, torch, inception),
            "resmlp_resident": check_resident_resmlp(card, torch)}
    launches = fa.flash_attention.launches
    if launches != 0:
        fail(f"phase 9 launched K1 {launches} times, want 0")
    for name, row in rows.items():
        print(f"chaining {name}", json.dumps(row), flush=True)
    print(f"chaining phase_seconds: {time.monotonic() - t0} | card: {card}", flush=True)
    return {"chaining_phase9": launches}


KV_COUNTERS = ("kv_pages_total", "kv_pages_free", "kv_page_occupancy_pct", "kv_pages_shared",
               "kv_cow_splits", "kv_indexed_pages", "kv_demoted_sessions",
               "kv_spilled_sessions", "kv_revived_warm", "kv_revived_cold", "kv_tier_moves")


def serving_operators(handle):
    """The continuous-batching operators of a finished job's executor."""
    from flink_tensorflow_tpu_torch.serving.operator import ContinuousBatchingOperator

    return [u.operator for st in handle.executor.subtasks for u in st.units
            if isinstance(u.operator, ContinuousBatchingOperator)]


def keyed_arm(torch, fa, model, cfg, requests, name, *, parallelism=1, tap=None,
              checkpoint_dir=None, every_n=None, restore=None, restart=None,
              arrivals_out=False):
    """One run of the keyed serving pipeline (``serving/cell.py:keyed_job``)
    on the card.  Returns its row: tokens by session, seconds from the
    first event at the sink to the last, K1's launches, the serving
    subtask 0's metrics, and the devices of every serving subtask's pool.
    At parallelism 1 K1 must launch once per layer for every prefill batch
    and warmup prefill (of every attempt)."""
    from flink_tensorflow_tpu_torch.functions.runner import PagedDecodeStepRunner
    from flink_tensorflow_tpu_torch.serving.cell import keyed_job

    env, arrivals = keyed_job(model, cfg, requests, parallelism=parallelism, tap=tap)
    if checkpoint_dir is not None:
        env.enable_checkpointing(checkpoint_dir, every_n_records=every_n)
    if tap is not None and restart is not None:
        env.source_throttle_s = 0.01   # as TestPagedFailover: the crash lands mid-stream
    fa.flash_attention.launches = 0
    pools = []
    if restart is not None:
        result = env.execute(name, timeout=600, restart_strategy=restart)
    else:
        kw = {} if restore is None else {"restore_from": restore[0],
                                         "restore_checkpoint_id": restore[1]}
        handle = env.execute_async(name, **kw)
        result = handle.wait(600)
        for op in serving_operators(handle):
            runner = op._runner
            paged = isinstance(runner, PagedDecodeStepRunner)
            if paged != cfg.paged_kv:
                fail(f"{name}: the serving operator ran {type(runner).__name__}")
            pools.append(runner.device.type)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    rep = env.metric_registry.report()
    grp = env.metric_registry.group("continuous_batching.0")
    events = [ev for _, ev in arrivals]
    seconds = arrivals[-1][0] - arrivals[0][0] if arrivals else 0.0
    got = tokens_checked(events)
    ttft, step = grp.histogram("ttft_s"), grp.histogram("decode_step_s")
    row = {"tokens": sum(len(v) for v in got.values()), "seconds": seconds,
           "tokens_per_s": sum(len(v) for v in got.values()) / seconds if seconds else None,
           "ttft_p50_ms": ttft.percentile(50) * 1e3, "ttft_p95_ms": ttft.percentile(95) * 1e3,
           "decode_step_p50_ms": step.percentile(50) * 1e3,
           "decode_step_p95_ms": step.percentile(95) * 1e3,
           "decode_steps": grp.counter("decode_steps").count,
           "prefill_batches": grp.counter("prefill_batches").count,
           "step_h2d_bytes": rep.get("continuous_batching.0.step_h2d_bytes"),
           "k1_launches": launches, "pool_devices": pools,
           "restarts": getattr(result, "restarts", 0)}
    if arrivals_out:
        row["events"] = events
    for key in KV_COUNTERS:
        if f"continuous_batching.0.{key}" in rep:
            row[key] = rep[f"continuous_batching.0.{key}"]
    if parallelism == 1:
        warm = (len(cfg.resolved_admit_buckets()) * len(cfg.resolved_prompt_buckets())
                if cfg.warmup_compile else 0)
        want = len(model.params.layers) * (row["prefill_batches"] + warm * (row["restarts"] + 1))
        if launches != want:
            fail(f"{name}: K1 launches {launches} != {want} (layers x (prefill batches "
                 f"+ warmup prefills per attempt))")
    return got, row


def decode_step_costs(torch, model, cfg, paged_cfg, requests):
    """Phase 10 (a): one decode step of the dense and the paged runner at
    the serving shape (8 slots, 8 sessions prefilled), each from its own
    runner on the card: kernels and copies per step and their summed
    device ms from the profiler, and host ms per step (median of 50); the
    step's H2D bytes from the runner's ``step_h2d_bytes`` across each of
    five decode steps (the paged step's must be exactly the token, length
    and table vectors), and the profiler's host-to-device copies and
    their bytes; and the paged step's tables H2D + gathers + scatters
    alone, the same two ways."""
    import statistics
    import tempfile

    from flink_tensorflow_tpu_torch.functions.runner import (
        DecodeStepRunner,
        PagedDecodeStepRunner,
    )
    from flink_tensorflow_tpu_torch.ops.paged_attention import gather_pages, scatter_pages

    slots = cfg.max_active_seqs
    batch = requests[:slots]
    prompts = [r.prompt for r in batch]
    lens = [len(p) for p in prompts]
    runners = {
        "dense": DecodeStepRunner(model, pool_slots=slots, capacity=cfg.capacity,
                                  prompt_buckets=cfg.resolved_prompt_buckets(), device="cuda"),
        "paged": PagedDecodeStepRunner(model, pool_slots=slots, capacity=cfg.capacity,
                                       page_tokens=paged_cfg.page_tokens,
                                       num_pages=paged_cfg.resolved_hbm_pages(),
                                       prompt_buckets=cfg.resolved_prompt_buckets(),
                                       device="cuda")}
    row = {}

    def profiled(fn):
        """Device events of one call of ``fn`` (kernels, copies).  A first
        call runs as the profiler's warmup: after an earlier profiler
        session in the process, the first events of a fresh window are
        lost (measured: the step's first host-to-device copy)."""
        torch.cuda.synchronize()
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    schedule=schedule) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        copies = [e for e in device if "Memcpy" in e.name or "Memset" in e.name]
        h2d = [e for e in device if "HtoD" in e.name]
        # Copy sizes are only in the exported trace's event arguments.
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trace") as d:
            prof.export_chrome_trace(os.path.join(d, "step.json"))
            with open(os.path.join(d, "step.json")) as f:
                trace = json.load(f)["traceEvents"]
        sizes = [e.get("args", {}).get("bytes") for e in trace
                 if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
        h2d_bytes = sum(sizes) if sizes and None not in sizes else None
        return (device, copies, sum(e.time_range.elapsed_us() for e in device) / 1e3,
                (len(h2d), len(sizes), h2d_bytes))

    def host_ms(fn):
        ms = []
        for _ in range(50):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    for name, runner in runners.items():
        runner.open()
        first = runner.prefill(prompts, lens, list(range(slots)), batch_bucket=slots)
        toks = [int(t) for t in first]

        def step(toks=toks, runner=runner, paged=(name == "paged")):
            if paged:
                for s in range(slots):
                    runner.ensure_writable(s, lens[s])
            return runner.decode_step(toks, lens, list(range(slots)))

        per_step = []
        for _ in range(5):
            before = runner.step_h2d_bytes
            step()
            per_step.append(runner.step_h2d_bytes - before)
        if len(set(per_step)) != 1:
            fail(f"{name} decode step: H2D bytes vary from step to step: {per_step}")
        device, copies, device_ms, (h2d_copies, traced, h2d_bytes) = profiled(step)
        row[f"{name}_decode_step_h2d_bytes"] = per_step[0]
        row[f"{name}_h2d_copies_per_step"] = h2d_copies
        row[f"{name}_h2d_copies_in_trace"] = traced
        row[f"{name}_h2d_copy_bytes_per_step"] = h2d_bytes
        row[f"{name}_kernels_per_step"] = len(device) - len(copies)
        row[f"{name}_copies_per_step"] = len(copies)
        row[f"{name}_step_device_ms"] = device_ms
        row[f"{name}_step_host_ms"] = host_ms(step)
        if name == "paged":
            tables = runner.step_tables()

            def gather_scatter(runner=runner):
                tab = torch.from_numpy(tables).to("cuda").long()
                kc, vc = gather_pages(runner._kc, tab), gather_pages(runner._vc, tab)
                scatter_pages(runner._kc, tab, kc, runner.page_tokens)
                scatter_pages(runner._vc, tab, vc, runner.page_tokens)

            device, copies, device_ms, _ = profiled(gather_scatter)
            row["gather_scatter_kernels"] = len(device) - len(copies)
            row["gather_scatter_device_ms"] = device_ms
            row["gather_scatter_host_ms"] = host_ms(gather_scatter)
        runner.close()
    # Per paged decode step: tokens and lengths [S] and tables [S, C/pt],
    # int32.  Held on the runner's counter; the profiler's copies are
    # printed beside it but not held, since a profiler window has been
    # seen to lose events on this card.
    want = slots * 4 * (2 + cfg.capacity // paged_cfg.page_tokens)
    if row["paged_decode_step_h2d_bytes"] != want:
        fail(f"paged decode step: {row['paged_decode_step_h2d_bytes']} B of H2D per step, "
             f"want {want}: the token, length and table vectors only")
    row["extra_kernels_per_step"] = row["paged_kernels_per_step"] - row["dense_kernels_per_step"]
    return row


def check_paged_serving(card, torch, fa, model, cfg, requests, want, dense_keyed):
    """Phase 10: the paged KV pool under ``serving.continuous_batching()``
    at the serving cell's full width: (a) paged against dense, A B B A;
    (b) the oversubscription ladder at 8x/16x/32x against a dense-roomy
    arm; (c) prefix sharing on against off on two fleets; (d) failover
    with spilled sessions, and a 2 -> 3 rescale.  Its spill files live in
    a temporary directory removed when the phase ends, however it ends.
    Returns K1's launches."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_spill") as spill_root:
        return paged_serving_arms(card, torch, fa, model, cfg, requests, want, dense_keyed,
                                  spill_root)


def paged_serving_arms(card, torch, fa, model, cfg, requests, want, dense_keyed, spill_root):
    """The runs of phase 10, their spill files under ``spill_root``."""
    import dataclasses
    import tempfile

    from flink_tensorflow_tpu_torch import RestartStrategy
    from flink_tensorflow_tpu_torch.checkpoint.store import latest_checkpoint_id
    from flink_tensorflow_tpu_torch.core.runtime import JobFailure
    from flink_tensorflow_tpu_torch.serving.cell import keyed_job, paged_cell

    t_phase = time.monotonic()
    launches = {}
    slots = cfg.max_active_seqs
    cell = paged_cell(requests, cfg, spill_root=spill_root)

    def print_row(what, row):
        print(f"paged {what}", json.dumps({**row, "card": card}), flush=True)

    # (a) serving-paged against the dense keyed arm, A B B A.
    rows = {"dense": [], "paged": []}
    for arm in ("dense", "paged", "paged", "dense"):
        arm_cfg = cell.serving if arm == "paged" else cfg
        got, row = keyed_arm(torch, fa, model, arm_cfg, requests, f"serving-{arm}")
        hold_tokens(f"serving-{arm}", got, want, requests, model, torch)
        if row["pool_devices"] != ["cuda"]:
            fail(f"serving-{arm}: pools on {row['pool_devices']}, want ['cuda']")
        rows[arm].append(row)
    for row in rows["paged"]:
        n = cell.serving.capacity // cell.serving.page_tokens
        # Per decode step: tokens, lengths and tables, int32; per prefill
        # batch at most the largest admit bucket's tokens, lengths and tables.
        b, t = max(cfg.resolved_admit_buckets()), max(cfg.resolved_prompt_buckets())
        bound = (row["decode_steps"] * slots * 4 * (2 + n)
                 + row["prefill_batches"] * b * 4 * (t + 1 + n))
        row["step_h2d_bound"] = bound
        row["hbm_pages"] = cell.serving.resolved_hbm_pages()
        row["demand_pages"] = cell.demand_pages
        if row["step_h2d_bytes"] > bound:
            fail(f"serving-paged: step_h2d_bytes {row['step_h2d_bytes']} above the "
                 f"token, length and table vectors' {bound}")
    launches["serving_paged"] = rows["paged"][0]["k1_launches"]
    fa.flash_attention.launches = 0
    costs = decode_step_costs(torch, model, cfg, cell.serving, requests)
    launches["paged_step_costs"] = fa.flash_attention.launches
    for row in rows["paged"]:
        row["decode_step_h2d_bytes"] = costs["paged_decode_step_h2d_bytes"]
    print_row("(a) decode step costs", costs)
    for arm in ("dense", "paged"):
        for i, row in enumerate(rows[arm]):
            print_row(f"(a) {arm} run {i + 1}", row)
    for key in ("tokens_per_s", "decode_step_p50_ms", "ttft_p50_ms"):
        print(f"paged (a) {key}: paged {[r[key] for r in rows['paged']]} "
              f"dense {[r[key] for r in rows['dense']]} "
              f"(phase 6 (a) {dense_keyed.get(key)}) | card: {card}", flush=True)

    # (b) the oversubscription ladder against a dense-roomy arm.
    roomy, row = keyed_arm(torch, fa, model, cell.dense_roomy, requests, "dense-roomy")
    hold_tokens("dense-roomy", roomy, want, requests, model, torch)
    print_row("(b) dense-roomy", row)
    for factor, rung in cell.ladder:
        got, row = keyed_arm(torch, fa, model, rung, requests, f"paged-{factor}x")
        hold_tokens(f"paged-{factor}x", got, roomy, requests, model, torch)
        row.update(oversubscription=f"{factor}x", hbm_pages=rung.hbm_pages,
                   demand_pages=cell.demand_pages)
        print_row(f"(b) {factor}x", row)
        if factor == 8 and (row["kv_spilled_sessions"] < 1 or row["kv_revived_cold"] < 1):
            fail(f"paged-8x: spilled {row['kv_spilled_sessions']}, revived from disk "
                 f"{row['kv_revived_cold']}; the ladder never reached the disk")
        launches[f"paged_{factor}x"] = row["k1_launches"]

    # (c) prefix sharing on against off.
    for name, fleet, share_cfg, adoptable in cell.prefix:
        on, row_on = keyed_arm(torch, fa, model, share_cfg, fleet, f"{name}-on")
        off, row_off = keyed_arm(torch, fa, model,
                                 dataclasses.replace(share_cfg, prefix_sharing=False),
                                 fleet, f"{name}-off")
        if on != off or len(on) != len(fleet):
            fail(f"prefix {name}: tokens with sharing differ from without")
        row_on["share_ratio"] = row_on["kv_pages_shared"] / ((len(fleet) - 1) * adoptable)
        row_on["adoptable_pages_per_session"] = adoptable
        print_row(f"(c) {name} on", row_on)
        print_row(f"(c) {name} off", row_off)
        if name == "one-prompt" and row_on["kv_cow_splits"] < 1:
            fail("prefix one-prompt: no copy-on-write split")
        launches[f"prefix_{name}"] = row_on["k1_launches"] + row_off["k1_launches"]

    # (d) failover with sessions on every rung, then a 2 -> 3 rescale.
    fo_reqs, fo_cfg = cell.failover_requests, cell.failover
    ref, row = keyed_arm(torch, fa, model, fo_cfg, fo_reqs, "failover-ref")
    dense_ref, _ = keyed_arm(torch, fa, model, dataclasses.replace(fo_cfg, paged_kv=False),
                             fo_reqs, "failover-dense")
    hold_tokens("failover-ref against dense", ref, dense_ref, fo_reqs, model, torch)
    if not all(len(v) == 24 for v in ref.values()):
        fail("failover-ref: a session ended early")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_paged_chk") as d:
        tap = crash_once(120)
        got, row = keyed_arm(torch, fa, model, fo_cfg, fo_reqs, "failover", tap=tap,
                             checkpoint_dir=d, every_n=4,
                             restart=RestartStrategy(max_restarts=2))
    if row["restarts"] != 1 or not tap.crashed:
        fail(f"paged failover: {row['restarts']} restarts (crashed: {tap.crashed}), want 1")
    hold_tokens("paged failover", got, ref, fo_reqs, model, torch)
    if row["kv_revived_cold"] < 1:
        fail("paged failover: no session revived from disk")
    print_row("(d) failover", row)
    launches["paged_failover"] = row["k1_launches"]

    # Phase 6 (c)'s rescale with (a)'s paged config: sessions cross
    # subtasks as host blocks, pages never do.
    total = sum(len(v) for v in want.values())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_paged_rescale") as d:
        env1, arrivals1 = keyed_job(model, cell.serving, requests, parallelism=2,
                                    tap=crash_once(total // 2))
        env1.enable_checkpointing(d, every_n_records=8)
        fa.flash_attention.launches = 0
        try:
            env1.execute("paged-rescale-1", timeout=600)
            fail("paged rescale: the first run did not crash")
        except JobFailure:
            pass
        cid = latest_checkpoint_id(d)
        if cid is None:
            fail("paged rescale: no checkpoint completed before the crash")
        restored, row = keyed_arm(torch, fa, model, cell.serving, requests, "paged-rescale-2",
                                  parallelism=3, restore=(d, cid), arrivals_out=True)
    if row["pool_devices"] != ["cuda"] * 3:
        fail(f"paged rescale: pools on {row['pool_devices']}")
    union = tokens_checked([ev for _, ev in arrivals1] + row.pop("events"))
    hold_tokens("paged rescale 2->3", union, want, requests, model, torch)
    if not restored:
        fail("paged rescale: the restored run emitted no session")
    print_row("(d) rescale 2->3 restored run", {**row, "restored_from": cid})
    launches["paged_rescale"] = row["k1_launches"]
    phase_s = time.monotonic() - t_phase
    print(f"paged phase_seconds: {phase_s} | card: {card}", flush=True)
    return launches


def et_records(pixels):
    """Phase 11's records in source order: ``(records, order, event time
    per id)``."""
    import numpy as np

    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    n = len(pixels)
    rng = np.random.RandomState(1)
    order = np.concatenate([lo + rng.permutation(min(ET_BLOCK, n - lo))
                            for lo in range(0, n, ET_BLOCK)])
    times = (np.arange(n) // ET_CAMERAS) / ET_FPS
    records = [TensorValue({"image": pixels[i]},
                           {"id": int(i), "camera": int(i % ET_CAMERAS), "t": float(times[i])})
               for i in order]
    return records, order, times


def et_functions():
    """The window functions, the stamp tap and the join of phase 11."""
    import collections
    import threading

    from flink_tensorflow_tpu_torch.core import functions as fn

    class LabelHistogram(fn.WindowFunction):
        def process_window(self, key, window, elements, out):
            ids = sorted(int(r.meta["id"]) for r in elements)
            counts = collections.Counter(int(r["label"]) for r in elements)
            out.collect((window.start, ids, dict(counts)))

    class TopLabel(fn.WindowFunction):
        def process_window(self, key, window, elements, out):
            counts = collections.Counter(int(r["label"]) for r in elements)
            label, n = max(counts.items(), key=lambda kv: (kv[1], -kv[0]))
            out.collect((key, window.start, len(elements), label, n))

    class StampTap(fn.ProcessFunction):
        """Records each result's event time and passes it on with it."""

        def __init__(self):
            self.stamps, self.lock = {}, threading.Lock()

        def clone(self):
            return self

        def process_element(self, value, ctx, out):
            with self.lock:
                self.stamps[int(value.meta["id"])] = ctx.timestamp
            out.collect(value, ctx.timestamp)

    return LabelHistogram, TopLabel, StampTap


def et_timed_sink(stream, name):
    """A sink recording results and their arrival times."""
    results, arrivals = [], []

    def sink(record):
        results.append(record)
        arrivals.append(time.monotonic())

    stream.sink_to_callable(sink, name=name)
    return results, arrivals


def et_window_fn(model):
    from flink_tensorflow_tpu_torch.functions.model_function import ModelWindowFunction
    from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy

    return ModelWindowFunction(model, outputs=("label", "score"),
                               policy=BucketPolicy(fixed_batch=ET_BATCH),
                               warmup_batches=(ET_BATCH,), pipeline_depth=ET_DEPTH)


def et_source(env, records):
    return env.from_collection(records).assign_timestamps(
        lambda r: r.meta["t"], out_of_orderness_s=ET_SLACK_S,
        watermark_every=ET_WATERMARK_EVERY)


def et_arm_row(card, what, handle, seconds, n, **extra):
    """records/s, seconds and watermark counts of one phase 11 run."""
    metrics = handle.executor.metrics.report()
    row = {"records": n, "seconds": seconds, "records_per_s": n / seconds,
           "watermarks": {k: v for k, v in metrics.items() if k.endswith(".watermarks")},
           **extra, "card": card}
    print(f"event-time {what} records_per_s: {row['records_per_s']} | seconds: {seconds} | "
          f"watermarks: {row['watermarks']} | card: {card}", flush=True)
    return row, metrics


def et_direct(torch, serve, module, pixels, ids):
    """Labels and scores of one direct call of ``module`` on the card."""
    import numpy as np

    with torch.inference_mode():
        out = serve(module, {"image": torch.from_numpy(np.ascontiguousarray(pixels[ids])).cuda()})
    return out["label"].cpu().numpy(), out["score"].cpu().numpy()


def check_event_time_windows(card, torch, inception, records, order, times):
    """Phase 11 (a): keyed event-time windows of 32 into the model, and a
    downstream event-time histogram."""
    import collections
    import copy

    import numpy as np

    from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment

    mdef, model, pixels = inception
    n = len(records)
    LabelHistogram, _, StampTap = et_functions()
    tap = StampTap()
    env = StreamExecutionEnvironment(parallelism=1)
    results = (et_source(env, records).key_by(lambda r: r.meta["camera"]).time_window(1.0)
               .apply(et_window_fn(model), name="inception_et")
               .process(tap, name="stamps"))
    got, arrivals = et_timed_sink(results, "sink")
    hist = results.time_window_all(1.0).apply(LabelHistogram(), late_tag="late",
                                              name="histogram")
    hists = hist.sink_to_list()
    late = hist.side_output("late").sink_to_list()
    t0 = time.monotonic()
    handle = env.execute_async()
    handle.wait(600)
    seconds = time.monotonic() - t0
    check_ids("inception-event-time (a)", got, n)
    label = {int(r.meta["id"]): int(r["label"]) for r in got}
    score = {int(r.meta["id"]): float(r["score"]) for r in got}
    second = (times // 1).astype(int)
    for i, ts in tap.stamps.items():
        if ts != second[i] + 1.0:
            fail(f"inception-event-time (a): record {i} stamped {ts}, its window ends at "
                 f"{second[i] + 1.0}")
    if len(tap.stamps) != n:
        fail(f"inception-event-time (a): {len(tap.stamps)} stamps for {n} results")
    if late:
        fail(f"inception-event-time (a): {len(late)} results late downstream")
    serve = mdef.methods["serve"].fn
    module = copy.deepcopy(model.params).to("cuda").eval()
    windows = 0
    for cam in range(ET_CAMERAS):
        for sec in range(int(second.max()) + 1):
            ids = [int(i) for i in order if i % ET_CAMERAS == cam and second[i] == sec]
            want_label, want_score = et_direct(torch, serve, module, pixels, ids)
            for j, i in enumerate(ids):
                if label[i] != want_label[j] or score[i] != want_score[j]:
                    fail(f"inception-event-time (a): record {i} differs from the direct call "
                         f"on its window")
            windows += 1
    del module
    by_end = collections.defaultdict(list)
    for i in range(n):
        by_end[float(second[i] + 1)].append(i)
    if sorted(h[0] for h in hists) != sorted(by_end):
        fail(f"inception-event-time (a): histogram windows {[h[0] for h in hists]}")
    for start, ids, counts in hists:
        recount = collections.Counter(label[i] for i in by_end[start])
        if ids != sorted(by_end[start]) or counts != dict(recount):
            fail(f"inception-event-time (a): the histogram of [{start}, {start + 1}) differs "
                 "from the host recount")
    row, _ = et_arm_row(card, "(a) windows", handle, seconds, n, windows=windows,
                              batches=metrics_sum(handle, "inception_et", "batches"),
                              padded_records=metrics_sum(handle, "inception_et",
                                                         "padded_records"),
                              late=len(late), histograms=len(hists))
    return row, label, score


def metrics_sum(handle, task, name):
    report = handle.executor.metrics.report()
    return sum(v for k, v in report.items()
               if k.startswith(task + ".") and k.endswith("." + name))


def check_event_time_map_join(card, torch, inception, records, order, times):
    """Phase 11 (b) and (c): the per-record map into keyed event-time
    windows, and its predictions joined with a truth stream."""
    import copy
    import tempfile

    import numpy as np

    from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.functions.model_function import ModelMapFunction
    from flink_tensorflow_tpu_torch.models.loaders import SavedModelLoader, save_bundle

    mdef, model, pixels = inception
    n = len(records)
    _, TopLabel, StampTap = et_functions()
    serve = mdef.methods["serve"].fn
    with tempfile.TemporaryDirectory() as tmp:
        bundle = os.path.join(tmp, "inception")
        save_bundle(mdef, model.params, bundle)
        # The truth: direct calls on the map's micro-batches (the next 128
        # records in arrival order: a watermark follows every 128th record
        # and the map's buffer is empty then).
        module = copy.deepcopy(SavedModelLoader(bundle).load().params).to("cuda").eval()
        truth_label, truth_score = {}, {}
        for lo in range(0, n, ET_MAP_MICRO_BATCH):
            ids = [int(i) for i in order[lo:lo + ET_MAP_MICRO_BATCH]]
            label, score = et_direct(torch, serve, module, pixels, ids)
            truth_label.update(zip(ids, label.tolist()))
            truth_score.update(zip(ids, score.tolist()))
        del module
        tap = StampTap()
        env = StreamExecutionEnvironment(parallelism=1)
        preds = (et_source(env, records)
                 .map(ModelMapFunction(bundle, micro_batch=ET_MAP_MICRO_BATCH, idle_flush_s=1.0,
                                       warmup_batches=(ET_MAP_MICRO_BATCH,),
                                       outputs=("label", "score")), name="inception_et_map")
                 .process(tap, name="map_stamps"))
        got, _ = et_timed_sink(preds, "map_sink")
        top = (preds.key_by(lambda r: r.meta["camera"]).time_window(1.0)
               .apply(TopLabel(), late_tag="late", name="top_label"))
        tops = top.sink_to_list()
        late = top.side_output("late").sink_to_list()
        truth = (env.from_collection([(i, truth_label[i], float(times[i])) for i in range(n)],
                                     name="truth")
                 .assign_timestamps(lambda r: r[2], out_of_orderness_s=ET_SLACK_S,
                                    watermark_every=ET_WATERMARK_EVERY, name="truth_timestamps"))
        pairs = (preds.join(truth).where(lambda r: int(r.meta["id"])).equal_to(lambda r: r[0])
                 .window(1.0)
                 .apply(lambda p, t: (int(p.meta["id"]), int(p.meta["camera"]), int(p["label"]),
                                      t[1]), name="join"))
        pair_list = pairs.sink_to_list()
        agree = (pairs.map(lambda x: (x[1], 1, int(x[2] == x[3])), name="agree")
                 .key_by(lambda x: x[0]).reduce(lambda a, b: (a[0], a[1] + b[1], a[2] + b[2]),
                                                 name="agree_per_camera").sink_to_list())
        t0 = time.monotonic()
        handle = env.execute_async()
        handle.wait(600)
        seconds = time.monotonic() - t0
    check_ids("inception-event-time (b)", got, n)
    for r in got:
        i = int(r.meta["id"])
        if int(r["label"]) != truth_label[i] or float(r["score"]) != truth_score[i]:
            fail(f"inception-event-time (b): record {i} differs from the direct call on its "
                 "micro-batch")
    for i in range(n):
        if tap.stamps.get(i) != float(times[i]):
            fail(f"inception-event-time (b): record {i} carries {tap.stamps.get(i)}, its event "
                 f"time is {times[i]}")
    if late:
        fail(f"inception-event-time (b): {len(late)} records late")
    if sorted(t[2] for t in tops) != [ET_FPS] * (n // ET_FPS):
        fail(f"inception-event-time (b): window sizes {sorted(t[2] for t in tops)}")
    if sorted(p[0] for p in pair_list) != list(range(n)):
        fail(f"inception-event-time (c): {len(pair_list)} pairs for {n} records")
    disagree = [p for p in pair_list if p[2] != p[3]]
    if disagree:
        fail(f"inception-event-time (c): {len(disagree)} pairs disagree, first {disagree[0]}")
    final = {}
    for cam, count, agreeing in agree:
        final[cam] = max(final.get(cam, (0, 0)), (count, agreeing))
    per_camera = n // ET_CAMERAS
    if final != {c: (per_camera, per_camera) for c in range(ET_CAMERAS)}:
        fail(f"inception-event-time (c): per-camera (pairs, agreeing) {final}")
    row, _ = et_arm_row(card, "(b, c) map + join", handle, seconds, n,
                        batches=metrics_sum(handle, "inception_et_map", "batches"),
                        padded_records=metrics_sum(handle, "inception_et_map",
                                                   "padded_records"),
                        late=len(late), pairs=len(pair_list), agreeing=len(pair_list))
    return row


def check_event_time_exactly_once(card, torch, inception, records, label, score):
    """Phase 11 (d): (a)'s model job into the two-phase-commit sink, a
    crash after checkpoint 2 and one restart."""
    import tempfile

    from flink_tensorflow_tpu_torch.core.environment import (
        RestartStrategy,
        StreamExecutionEnvironment,
    )
    from flink_tensorflow_tpu_torch.io.files import ExactlyOnceRecordFileSink, read_committed

    _, model, _ = inception
    n = len(records)
    with tempfile.TemporaryDirectory() as tmp:
        chk, out = os.path.join(tmp, "chk"), os.path.join(tmp, "out")
        env = StreamExecutionEnvironment(parallelism=1)
        env.enable_checkpointing(chk, every_n_records=ET_CHECKPOINT_EVERY)
        tap = crash_once(n // 2, chk, min_checkpoint=2)
        (et_source(env, records).key_by(lambda r: r.meta["camera"]).time_window(1.0)
         .apply(et_window_fn(model), name="inception_et_2pc")
         .map(tap, name="crash").add_sink(ExactlyOnceRecordFileSink(out), name="file_sink"))
        t0 = time.monotonic()
        result = env.execute(timeout=900, restart_strategy=RestartStrategy(max_restarts=1))
        seconds = time.monotonic() - t0
        committed = read_committed(out)
        files = len(os.listdir(out))
    if result.restarts != 1 or not tap.crashed:
        fail(f"inception-event-time (d): {result.restarts} restarts, crashed {tap.crashed}")
    ids = [int(r.meta["id"]) for r in committed]
    if sorted(ids) != list(range(n)):
        fail(f"inception-event-time (d): {len(ids)} committed, {len(set(ids))} distinct, "
             f"want each of {n} once")
    for r in committed:
        i = int(r.meta["id"])
        if int(r["label"]) != label[i] or float(r["score"]) != score[i]:
            fail(f"inception-event-time (d): committed record {i} differs from (a)")
    metrics = result.metrics
    row = {"records": n, "seconds": seconds, "records_per_s": n / seconds,
           "restarts": result.restarts, "crashed_at_result": tap.crashed_at,
           "committed": len(ids), "part_files": files,
           "watermarks": {k: v for k, v in metrics.items() if k.endswith(".watermarks")},
           "checkpoints_completed": metrics.get("checkpoint.completed"), "card": card}
    print(f"event-time (d) exactly-once records_per_s: {row['records_per_s']} | seconds: "
          f"{seconds} | watermarks: {row['watermarks']} | card: {card}", flush=True)
    return row


def check_event_time(card, torch, fa, inception):
    """Phase 11: Inception-v3 on event-time windows; K1 must launch 0 times."""
    t0 = time.monotonic()
    fa.flash_attention.launches = 0
    records, order, times = et_records(inception[2])
    row_a, label, score = check_event_time_windows(card, torch, inception, records, order, times)
    rows = {"windows": row_a,
            "map_join": check_event_time_map_join(card, torch, inception, records, order, times),
            "exactly_once": check_event_time_exactly_once(card, torch, inception, records,
                                                          label, score)}
    launches = fa.flash_attention.launches
    if launches != 0:
        fail(f"phase 11 launched K1 {launches} times, want 0")
    for name, row in rows.items():
        print(f"event-time {name}", json.dumps(row), flush=True)
    print(f"event-time phase_seconds: {time.monotonic() - t0} | card: {card}", flush=True)
    return {"inception_event_time_phase11": launches}


def ring_arm_row(card, what, run, records):
    """Phase 12 (a): one arm's rates, host stages and ring counters."""
    from flink_tensorflow_tpu_torch.models import inception_cell as cell
    from flink_tensorflow_tpu_torch.models.stream_cell import steady_rps

    m = {k.split(".", 2)[2]: v for k, v in run.metrics.items() if k.startswith("inception.0.")}
    rps, span = steady_rps(run.arrivals, records, cell.BATCH, cell.trailing_exclude(records))
    row = {
        "records_per_s": rps, "steady_span_s": span, "job_seconds": run.seconds,
        "job_records_per_s": records / run.seconds, "batches": m["batches"],
        "assemble_p50_ms": m["assemble_s"]["p50"] * 1e3,
        "assemble_sum_s": m["assemble_s"]["mean"] * m["assemble_s"]["count"],
        "h2d_p50_ms": m["h2d_s"]["p50"] * 1e3,
        "h2d_sum_s": m["h2d_s"]["mean"] * m["h2d_s"]["count"],
        "dispatch_p50_ms": m["dispatch_s"]["p50"] * 1e3,
        "fetch_wait_p50_ms": m["fetch_wait_s"]["p50"] * 1e3,
        "record_latency_p50_ms": m["record_latency_s"]["p50"] * 1e3,
        "h2d_bytes_per_batch": m["h2d_bytes"] / m["batches"],
        "ring_batches": m.get("ring_batches", 0), "ring_copy_outs": m.get("ring_copy_outs", 0),
        "ring_pinned_bytes": m.get("ring_pinned_bytes", 0),
        "release_h2d_waits": m.get("release_h2d_waits", 0),
        "pinned_staging_allocations": m["pinned_allocations"], "card": card,
    }
    for key in ("records_per_s", "job_records_per_s", "assemble_sum_s", "h2d_sum_s",
                "ring_batches", "ring_copy_outs", "ring_pinned_bytes"):
        print(f"ring {what} {key}: {row[key]} | card: {card}", flush=True)
    return row


def check_ring_arms(card, torch, inception, direct):
    """Phase 12 (a): the Inception cell at the bench's settings through the
    ring, the list path, and the ring at one transfer lane."""
    import numpy as np

    from flink_tensorflow_tpu_torch.models import inception_cell as cell
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    _, model, pixels = inception
    records = [TensorValue({"image": pixels[i]}, {"id": i}) for i in range(cell.RECORDS)]
    want_label, want_score = direct
    rows = {}
    for what, lanes, use_ring in (("ring", cell.LANES, None), ("list", cell.LANES, False),
                                  ("ring_lanes1", 1, None)):
        run = cell.run_cell_job(model, records, lanes=lanes, use_ring=use_ring)
        check_ids(f"ring {what}", run.results, cell.RECORDS)
        label = np.empty(cell.RECORDS, np.int32)
        score = np.empty(cell.RECORDS, np.float32)
        for r in run.results:
            label[r.meta["id"]] = r["label"]
            score[r.meta["id"]] = r["score"]
        if not (np.array_equal(label, want_label) and np.array_equal(score, want_score)):
            fail(f"ring {what}: {int((label != want_label).sum())} labels and "
                 f"{int((score != want_score).sum())} scores differ from the direct calls")
        row = ring_arm_row(card, what, run, cell.RECORDS)
        batches = cell.RECORDS // cell.BATCH
        if use_ring is None and (row["ring_batches"] != batches or row["ring_pinned_bytes"]
                                 != RING_PINNED_BYTES):
            fail(f"ring {what}: {row['ring_batches']} ring batches of {batches}, "
                 f"{row['ring_pinned_bytes']} pinned bytes (want {RING_PINNED_BYTES})")
        if use_ring is False and row["ring_batches"]:
            fail("ring list: the list arm fired through the ring")
        rows[what] = {"transfer_lanes": lanes, "use_ring": use_ring, **row}
    return rows


def wire_reference_inputs(torch, images, wire, batch):
    """The cell's inputs as the wire delivers them, rounded host-side."""
    from flink_tensorflow_tpu_torch.tensors.transfer import narrow_field

    x = torch.tensor(images)   # a copy: the cell's images are read-only
    if wire == "bf16":
        return x.to(torch.bfloat16).float()
    if wire == "int8":
        parts = []
        for lo in range(0, len(images), batch):
            q, scale = narrow_field(images[lo:lo + batch], "int8")
            parts.append(q.float() * torch.tensor(scale))
        return torch.cat(parts)
    return x


def check_wire_arms(card, torch):
    """Phase 12 (b): mnist-lenet with wire f32, bf16 and int8."""
    import copy

    import numpy as np

    from flink_tensorflow_tpu_torch.models import lenet_cell as cell

    mdef, model, images, records = cell.lenet_cell(SEED)
    serve = mdef.methods["serve"].fn
    module = copy.deepcopy(model.params).to("cuda")
    rows, labels = {}, {}
    for wire in ("f32", "bf16", "int8"):
        run = cell.run_cell(model, records, wire_dtype=wire)
        check_ids(f"wire {wire}", run.results, cell.RECORDS)
        m = {k.split(".", 2)[2]: v for k, v in run.metrics.items() if k.startswith("lenet.0.")}
        per_batch = m["h2d_bytes"] / m["batches"]
        if per_batch != WIRE_H2D_BYTES[wire]:
            fail(f"wire {wire}: {per_batch} H2D bytes per batch, want {WIRE_H2D_BYTES[wire]}")
        got = np.empty(cell.RECORDS, np.int32)
        for r in run.results:
            got[r.meta["id"]] = r["label"]
        x = wire_reference_inputs(torch, images, wire, cell.BATCH)
        want = np.empty_like(got)
        with torch.inference_mode():
            for lo in range(0, cell.RECORDS, cell.BATCH):
                out = serve(module, {"image": x[lo:lo + cell.BATCH].cuda()})
                want[lo:lo + cell.BATCH] = out["label"].cpu().numpy()
        if not np.array_equal(got, want):
            fail(f"wire {wire}: {int((got != want).sum())} labels differ from the direct "
                 "call on the rounded inputs")
        labels[wire] = got
        rows[wire] = {"h2d_bytes_per_batch": per_batch,
                      "wire_bytes_saved": m.get("wire_bytes_saved", 0),
                      "labels_differing_from_f32": int((got != labels["f32"]).sum()),
                      "records_per_s": cell.RECORDS / run.seconds,
                      "h2d_p50_ms": m["h2d_s"]["p50"] * 1e3,
                      "ring_batches": m.get("ring_batches", 0), "card": card}
        print(f"wire {wire}", json.dumps(rows[wire]), flush=True)
    return rows


def check_open_loop(card, torch, inception):
    """Phase 12 (c): the bench's open-loop pass on the card."""
    import copy

    import numpy as np

    from flink_tensorflow_tpu_torch.models import inception_cell as cell
    from flink_tensorflow_tpu_torch.tensors.batching import BucketLadder
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    mdef, model, pixels = inception
    n = OPEN_LOOP_RECORDS
    records = [TensorValue({"image": pixels[i]}, {"id": i}) for i in range(n)]
    capacity, _ = cell.calibrate(model, records)
    rtt = cell.one_record_round_trip(model, records[0])
    budget = max(cell.BUDGET_S, 1.5 * rtt)
    rate = cell.RATE_FRACTION * capacity
    run = cell.run_open_loop(model, records, rate, budget)
    check_ids("open loop", run.results, n)
    # Every batch again as a direct call at its padded bucket (pad rows
    # replay its first record, as assembly does): equal bits.
    batches = []
    for r in run.results:
        key = r.meta["__stages__"]["t0"]
        if not batches or batches[-1][0] != key:
            batches.append((key, []))
        batches[-1][1].append(r)
    ladder = BucketLadder.up_to(cell.OL_BATCH)
    serve = mdef.methods["serve"].fn
    module = copy.deepcopy(model.params).to("cuda").eval()
    with torch.inference_mode():
        for _, rs in batches:
            ids = [r.meta["id"] for r in rs]
            rows = ids + [ids[0]] * (ladder.round_up(len(ids)) - len(ids))
            out = serve(module, {"image": torch.from_numpy(pixels[rows]).cuda()})
            label = out["label"].cpu().numpy()[:len(ids)]
            score = out["score"].cpu().numpy()[:len(ids)]
            if not (np.array_equal(label, [r["label"] for r in rs])
                    and np.array_equal(score, [r["score"] for r in rs])):
                fail(f"open loop: a batch of {len(ids)} differs from its direct call")
    del module
    summary = cell.open_loop_summary(run, rate)
    return {"records": n, "calibrated_capacity_rps": capacity, "one_record_rtt_ms": rtt * 1e3,
            "latency_budget_ms": budget * 1e3, "job_seconds": run.seconds,
            "batches": len(batches), **summary, "card": card}


def check_transfer_plane(card, torch, fa, inception, direct):
    """Phase 12: the ring, transfer lanes, wire dtypes and the open loop;
    K1 must launch 0 times."""
    t0 = time.monotonic()
    fa.flash_attention.launches = 0
    rows = {"ring": check_ring_arms(card, torch, inception, direct),
            "wire": check_wire_arms(card, torch)}
    t_c = time.monotonic()
    rows["open_loop"] = check_open_loop(card, torch, inception)
    launches = fa.flash_attention.launches
    if launches != 0:
        fail(f"phase 12 launched K1 {launches} times, want 0")
    for name, row in rows.items():
        print(f"transfer-plane {name}", json.dumps(row), flush=True)
    ol = rows["open_loop"]
    print(f"open loop p50/p95/p99 ms: {ol['p50_ms']} / {ol['p95_ms']} / {ol['p99_ms']} "
          f"at {ol['offered_rps']} offered, {ol['achieved_rps']} achieved records/s "
          f"| card: {card}", flush=True)
    print(f"transfer-plane phase_seconds: {time.monotonic() - t0} (open loop "
          f"{time.monotonic() - t_c}) | card: {card}", flush=True)
    return {"transfer_plane_phase12": launches}


# Phase 13 (b): two gloo ranks sharing the card, 8 steps at global batch
# 32 (16 per rank), against phase 13 (a)'s first 8 steps.  The losses are
# held at tests/test_parallel.py:96-99's bf16 bar, 1e-2 relative.  That
# test's params bar, 2e-3 absolute, cannot hold the params: adam's first
# step (eps 1e-8) moves every param by lr g / (|g| + eps), about +-lr =
# 1e-3 whatever the gradient's size, so two runs differ by at most 2 lr =
# 2e-3 after it by construction, and a gradient near zero whose sign
# another batch split flips then moves it the other way (up to 1.6e-2 in
# 8 steps); a running variance of order 100 has a bf16 step of 0.5.  So
# what the steps changed is held, by its norm (||b - a|| / ||a - start||),
# to DP_NOISE_FACTOR times the bf16 noise floor of the same step: (a)'s
# steps again on one card with the rows of each batch in the other order
# (rank 1's first), the same arithmetic rounded in another order.  The
# global batch statistics are shown at the FIRST step, where every run
# starts from the same params: two ranks for 1 step within the factor of
# the floor at step 1 (and the running statistics within 2e-3, which is
# not bounded by construction), and the control, the same two ranks with
# batch norm's moments over each rank's rows (``train_cell
# --local-batch-stats``), must miss both the params' and the statistics'
# bar.  The factor, 1.5, leaves room on both sides of the readings
# (PERF.md, phase 13): two ranks land at 1.03-1.10x the floor, at step 1
# and after 8; local statistics at 2.1-2.2x after 8 steps and 3.5x
# (params) and 88x (statistics) at step 1.
DP_GLOO_STEPS = 8
DP_GLOO_LOSS_RTOL = 1e-2
DP_GLOO_ATOL = 2e-3
DP_NOISE_FACTOR = 1.5
DP_RANK_TIMEOUT_S = 300
# Phase 13 (c): the ring's block step for 8 simulated ranks, and Ulysses'
# per-rank K1 call on each of 8 head slices: (name, B, H, T, D, dtype,
# causal), T split 8 ways.
SEQ_RANKS = 8
SEQ_CASES = (("bf16_d64_causal", 1, 8, 16384, 64, "bfloat16", True),
             ("f16_d128", 1, 8, 16384, 128, "float16", False))
# Phase 13 (d): phase 5's records through the frozen Inception.
GRAPH_RECORDS = 512


def free_port() -> int:
    return free_ports(1)[0]


def free_ports(n: int) -> list:
    """``n`` distinct free ports, all bound before any is released."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def held(got, want, dtype) -> float:
    """max(|got - want| - rtol |want|) at phase 3's tolerance for
    ``dtype``; fails the phase above its atol."""
    atol, rtol = TOLERANCE[dtype]
    over = ((got.float() - want.float()).abs() - rtol * want.float().abs()).max().item()
    if not over <= atol:
        fail(f"{over} over phase 3's {dtype} atol {atol}")
    return over


def plain_rows(torch, q, k, v, offset: int, causal: bool):
    """Plain attention of the query rows ``q`` (global positions from
    ``offset``) over all keys: ``full_attention``'s rows, a block at a
    time (the whole [T, T] score matrix would take tens of GB)."""
    import math

    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    if causal:
        rows = offset + torch.arange(q.shape[1], device=q.device)[:, None]
        s = s.masked_fill(torch.arange(k.shape[1], device=q.device)[None, :] > rows,
                          float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def check_dp_nccl(card, torch, fa, ref):
    """Phase 13 (a): resnet-train through the gang over a real NCCL group
    of one, equal to phase 7 (a) bit for bit.  Returns the row, the state
    after 8 steps of the same step (for (b)) and (a)'s losses."""
    import numpy as np

    from flink_tensorflow_tpu_torch.functions import train_cell as cell
    from flink_tensorflow_tpu_torch.functions.runner import (
        hold_cudnn_heuristics,
        release_cudnn_heuristics,
    )
    from flink_tensorflow_tpu_torch.functions.training_function import _train_batch_arrays
    from flink_tensorflow_tpu_torch.parallel import collectives, dp, multihost
    from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from flink_tensorflow_tpu_torch.parallel.optim import adam
    from flink_tensorflow_tpu_torch.tensors.batching import BucketPolicy

    mdef, schema, records = ref["mdef"], ref["schema"], ref["records"]
    topo = multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    backend = torch.distributed.get_backend()
    mesh = make_mesh({"data": 1})
    if topo.num_processes != 1 or backend != "nccl" or not mesh.distributed:
        fail(f"dp nccl: cohort {topo}, backend {backend}, mesh over a group {mesh.distributed}")
    collectives.calls.clear()
    fa.flash_attention.launches = 0
    run = cell.run_resnet(mdef, schema, records, mesh)
    launches = fa.flash_attention.launches
    calls = dict(collectives.calls)
    losses = [float(r["loss"]) for r in run.results]
    final = run.function.current_params()
    if not (losses == ref["losses"] and _bit_equal(final, ref["final"])):
        fail(f"dp nccl: differs from phase 7 (a): losses equal {losses == ref['losses']}, "
             f"largest loss difference {max(abs(a - b) for a, b in zip(losses, ref['losses']))}")
    bns = sum(1 for n in final["batch_stats"] if n.endswith(".mean"))
    per_step = calls.get("all_reduce", 0) / cell.RESNET_STEPS
    if per_step != 2 + 2 * bns:
        fail(f"dp nccl: {per_step} all-reduces per step, want 2 + 2 x {bns} batch norms")
    if launches:
        fail(f"dp nccl launched K1 {launches} times, want 0")
    # The first 8 steps again as a direct loop of the gang's step over the
    # group: (b)'s reference state.
    opt = adam(cell.RESNET_LR)
    state = replicate(mesh, dp.init_train_state(mdef, opt, 0))
    step = dp.make_dp_train_step(mdef, opt, mesh)
    policy = BucketPolicy(fixed_batch=cell.RESNET_BATCH)
    loop = []
    hold_cudnn_heuristics()
    try:
        for i in range(DP_GLOO_STEPS):
            batch = records[i * cell.RESNET_BATCH:(i + 1) * cell.RESNET_BATCH]
            _, arrays = _train_batch_arrays(batch, schema, policy)
            state, metrics = step(state, shard_batch(mesh, arrays), i)
            loop.append(metrics["loss"])
            if i == 0:
                ref1 = _to(state["variables"], "cpu")
        loop = [float(x) for x in loop]
    finally:
        release_cudnn_heuristics()
    if loop != losses[:DP_GLOO_STEPS]:
        fail("dp nccl: a direct loop of the step differs from the gang's first 8 losses")
    ref8 = _to(state["variables"], "cpu")
    # The noise floor for (b): the same 8 steps with each batch's rows in
    # the other order (rank 1's 16 first), the same arithmetic.
    start = dp.init_train_state(mdef, opt, 0)
    state = replicate(mesh, start)
    half = cell.RESNET_BATCH // 2
    floor_losses = []
    hold_cudnn_heuristics()
    try:
        for i in range(DP_GLOO_STEPS):
            batch = records[i * cell.RESNET_BATCH:(i + 1) * cell.RESNET_BATCH]
            _, arrays = _train_batch_arrays(batch[half:] + batch[:half], schema, policy)
            state, metrics = step(state, shard_batch(mesh, arrays), i)
            floor_losses.append(metrics["loss"])
            if i == 0:
                floor1 = _to(state["variables"], "cpu")
        floor_losses = [float(x) for x in floor_losses]
    finally:
        release_cudnn_heuristics()
    floor = {"losses": floor_losses, "variables": _to(state["variables"], "cpu"),
             "start": start["variables"], "variables_1": floor1, "ref_1": ref1}
    del state, step
    gaps = np.diff(run.arrivals) * 1e3
    row = {"backend": backend, "world_size": 1, "steps": len(losses), "bit_equal_phase7": True,
           "records_per_s": cell.rate(run.arrivals, cell.RESNET_BATCH),
           "phase7_records_per_s": ref["row"]["records_per_s"],
           "step_ms_p50": float(np.percentile(gaps, 50)),
           "phase7_step_ms_p50": ref["row"]["step_ms_p50"],
           "all_reduce_per_step": per_step, "batch_norms": bns,
           "broadcasts": calls.get("broadcast", 0), "job_seconds": run.seconds, "card": card}
    print("dp nccl w1", json.dumps(row), flush=True)
    print(f"dp nccl w1 records/s {row['records_per_s']} (phase 7 {row['phase7_records_per_s']}), "
          f"step ms p50 {row['step_ms_p50']} (phase 7 {row['phase7_step_ms_p50']}), "
          f"all_reduce per step {per_step} | card: {card}", flush=True)
    return row, ref8, losses[:DP_GLOO_STEPS], floor, launches


def dp_errs(got, got_losses, ref8, losses8, start) -> dict:
    """One run's 8 steps against (a)'s: loss, and per collection the
    largest difference, it over the largest |a|, and what the steps
    changed, by norm."""
    errs = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got_losses, losses8))}
    for coll in ("params", "batch_stats"):
        g, w = _flat(got[coll]), _flat(ref8[coll])
        diff = max(float((g[k].float() - w[k].float()).abs().max()) for k in w)
        peak = max(float(w[k].float().abs().max()) for k in w)
        errs[coll] = {"max_abs": diff, "max_rel": diff / peak,
                      "over_atol": sum(int(((g[k].float() - w[k].float()).abs()
                                            > DP_GLOO_ATOL).sum()) for k in w),
                      "elements": sum(w[k].numel() for k in w),
                      "update_norm": _norm_err(got[coll], ref8[coll], start[coll])}
    return errs


def run_ranks(cmd, what, steps, replicated=("params", "batch_stats")):
    """Two rank processes of ``cmd`` (a list, ``--rank`` appended); their
    output files, read back.  A rank that fails or outlives
    ``DP_RANK_TIMEOUT_S`` fails the phase, and so do ranks whose
    ``replicated`` collections differ."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory(prefix="dp_gloo_") as out:
        port = free_port()
        cmd = cmd + ["--world", "2", "--port", str(port), "--steps", str(steps),
                     "--out", out, "--backend", "gloo"]
        t0 = time.monotonic()
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=REPO, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=DP_RANK_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            fail(f"{what}: the ranks outlived {DP_RANK_TIMEOUT_S} s")
        seconds = time.monotonic() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode:
                print(log[-6000:], file=sys.stderr)
                fail(f"{what}: rank {r} exited {p.returncode}")
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(2)]
        for r in ranks:
            if r["device"] != "cuda:0" or r["steps"] != list(range(1, steps + 1)):
                fail(f"{what}: a rank ran on {r['device']}, steps {r['steps']}")
        if not (ranks[0]["losses"] == ranks[1]["losses"]
                and all(_bit_equal(ranks[0]["variables"][c], ranks[1]["variables"][c])
                        for c in replicated)):
            fail(f"{what}: the two ranks' {replicated} differ (they must stay replicated)")
        return ranks, seconds


def check_dp_gloo(card, torch, ref8, losses8, floor):
    """Phase 13 (b): two processes, each the gang over a gloo group of two
    sharing cuda:0 (gloo sums and broadcasts CUDA tensors; a refusal fails
    the phase), 8 steps, held to (a)'s first 8; then 1 step, with and
    without cross-rank batch statistics, held to (a)'s first."""
    import numpy as np

    rank_cmd = [sys.executable, "-m", "flink_tensorflow_tpu_torch.functions.train_cell"]
    ranks, seconds = run_ranks(rank_cmd, "dp gloo", DP_GLOO_STEPS)
    one, _ = run_ranks(rank_cmd, "dp gloo 1 step", 1)
    # Each rank keeps its own running statistics here; the gradients are
    # still averaged, so the params stay replicated.
    local, _ = run_ranks(rank_cmd + ["--local-batch-stats"], "dp gloo local statistics", 1,
                         replicated=("params",))
    start = floor["start"]
    ref1, losses1 = floor["ref_1"], losses8[:1]
    errs = {"two_ranks_8": dp_errs(ranks[0]["variables"], ranks[0]["losses"], ref8, losses8,
                                   start),
            "noise_floor_8": dp_errs(floor["variables"], floor["losses"], ref8, losses8, start),
            "two_ranks_1": dp_errs(one[0]["variables"], one[0]["losses"], ref1, losses1, start),
            "noise_floor_1": dp_errs(floor["variables_1"], floor["losses"][:1], ref1, losses1,
                                     start),
            "local_statistics_1": dp_errs(local[0]["variables"], local[0]["losses"], ref1,
                                          losses1, start)}
    bars = {f"{c}_{k}": DP_NOISE_FACTOR * errs[f"noise_floor_{k}"][c]["update_norm"]
            for c in ("params", "batch_stats") for k in (8, 1)}
    step_ms = [float(np.median(np.diff(r["arrivals"]))) * 1e3 for r in ranks]
    row = {"ranks": 2, "backend": "gloo", "device": "cuda:0", "steps": DP_GLOO_STEPS,
           "errs_vs_a": errs, "loss_rtol": DP_GLOO_LOSS_RTOL, "update_norm_bars": bars,
           "statistics_atol_step_1": DP_GLOO_ATOL, "step_ms_median": step_ms,
           "all_reduce": ranks[0]["calls"].get("all_reduce"),
           "k1_launches": sum(r["k1_launches"] for r in ranks + one + local),
           "seconds": seconds, "card": card}
    print("dp gloo 2 ranks", json.dumps(row), flush=True)
    print(f"dp gloo seconds per step {[x / 1e3 for x in step_ms]} (2 ranks sharing one card, "
          f"not a multi-card number) | card: {card}", flush=True)
    # The params' max-abs at step 1 is printed only: at most 2 lr by
    # construction (the comment above DP_GLOO_STEPS).
    ok = [errs[f"two_ranks_{k}"]["loss_rel"] <= DP_GLOO_LOSS_RTOL for k in (8, 1)]
    ok += [errs["two_ranks_1"]["batch_stats"]["max_abs"] <= DP_GLOO_ATOL]
    ok += [errs[f"two_ranks_{k}"][c]["update_norm"] <= bars[f"{c}_{k}"]
           for c in ("params", "batch_stats") for k in (8, 1)]
    if not all(ok):
        fail(f"dp gloo: off (a): {json.dumps({k: errs[k] for k in errs if 'two' in k})} "
             f"(loss rtol {DP_GLOO_LOSS_RTOL}, step 1 statistics atol {DP_GLOO_ATOL}, "
             f"update bars {bars})")
    for c in ("params", "batch_stats"):
        ctl = errs["local_statistics_1"][c]["update_norm"]
        if not ctl > bars[f"{c}_1"]:
            fail(f"dp gloo: with local batch statistics the {c} land within the bar ({ctl} <= "
                 f"{bars[f'{c}_1']}): the check cannot tell them from global ones")
    return row


def check_seq_parallel(card, torch, fa):
    """Phase 13 (c): ring and Ulysses attention on K1, through the NCCL
    group of one and for 8 simulated ranks."""
    from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh
    from flink_tensorflow_tpu_torch.parallel.ring_attention import (
        full_attention,
        ring_attention,
        ring_flash_block,
    )
    from flink_tensorflow_tpu_torch.parallel.ulysses import (
        ulysses_attention,
        ulysses_local_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    # Through the group of one: one K1 call each.
    mesh = make_mesh({"seq": 1})
    q, k, v = (torch.randn(1, 2048, 8, 64, device="cuda", generator=gen).bfloat16()
               for _ in range(3))
    want = full_attention(q, k, v, causal=True)
    w1 = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        fa.flash_attention.launches = 0
        got = fn(mesh, q, k, v, causal=True)
        torch.cuda.synchronize()
        w1[name] = {"launches": fa.flash_attention.launches,
                    "over_tolerance": held(got, want, "bfloat16")}
        if w1[name]["launches"] != 1:
            fail(f"{name} over the group of one launched K1 {w1[name]['launches']} times")
    rows["world_size_1"] = w1
    n = SEQ_RANKS
    launches = {"ring_sim8": 0, "ulysses_sim8": 0}
    for name, b, h, t_all, d, dtype, causal in SEQ_CASES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(b, t_all, h, d, device="cuda", generator=gen).to(dt)
                   for _ in range(3))
        t = t_all // n
        blk = [slice(i * t, (i + 1) * t) for i in range(n)]
        fa.flash_attention.launches = 0
        outs = []
        for me in range(n):
            o = torch.zeros((b, t, h, d), dtype=torch.float32, device="cuda")
            lse = torch.full((b, h, t), float("-inf"), device="cuda")
            for step in range(n):
                src = (me - step) % n
                o, lse = ring_flash_block(q[:, blk[me]], k[:, blk[src]], v[:, blk[src]], o, lse,
                                          me=me, src=src, causal=causal)
            outs.append(o.to(dt))
        torch.cuda.synchronize()
        ring_launches = fa.flash_attention.launches
        want_launches = n * (n + 1) // 2 if causal else n * n
        if ring_launches != want_launches:
            fail(f"ring {name}: {ring_launches} K1 launches, want {want_launches}")
        ring_over = max(held(outs[me], plain_rows(torch, q[:, blk[me]], k, v, me * t, causal),
                             dtype) for me in range(n))
        hs = h // n
        fa.flash_attention.launches = 0
        heads = [ulysses_local_attention(q[:, :, j * hs:(j + 1) * hs],
                                         k[:, :, j * hs:(j + 1) * hs],
                                         v[:, :, j * hs:(j + 1) * hs], causal=causal)
                 for j in range(n)]
        torch.cuda.synchronize()
        u_launches = fa.flash_attention.launches
        if u_launches != n:
            fail(f"ulysses {name}: {u_launches} K1 launches, want {n}")
        u_over = max(held(heads[j], full_attention(*(x[:, :, j * hs:(j + 1) * hs].contiguous()
                                                     for x in (q, k, v)), causal=causal), dtype)
                     for j in range(n))
        launches["ring_sim8"] += ring_launches
        launches["ulysses_sim8"] += u_launches
        # K1 per block (return_lse, as the ring calls it) beside the plain path.
        qb, kb, vb = q[:, blk[1]], k[:, blk[0]], v[:, blk[0]]
        kinds = {"full": False, "diagonal": True} if causal else {"full": False}
        per_block = {}
        for kind, c in kinds.items():
            kk, vv = (k[:, blk[1]], v[:, blk[1]]) if c else (kb, vb)
            k1 = time_ms(lambda: fa.flash_attention(qb, kk, vv, causal=c, return_lse=True), 20)
            plain = time_ms(lambda: fa.flash_attention_reference(qb, kk, vv, causal=c,
                                                                 return_lse=True), 5)
            bound_ms, bound_by, _ = k1_bound(b, h, t, t, d, dtype, c)
            per_block[kind] = {"k1_ms": k1, "plain_ms": plain, "bound_ms": bound_ms,
                               "bound_by": bound_by}
        heads_ms = time_ms(lambda: ulysses_local_attention(
            q[:, :, :hs], k[:, :, :hs], v[:, :, :hs], causal=causal), 5)
        rows[name] = {"B": b, "H": h, "T": t_all, "D": d, "dtype": dtype, "causal": causal,
                      "ranks": n, "ring_launches": ring_launches, "ring_over_tolerance": ring_over,
                      "ulysses_launches": u_launches, "ulysses_over_tolerance": u_over,
                      "per_block": per_block, "ulysses_rank_ms": heads_ms,
                      "tolerance": TOLERANCE[dtype], "card": card}
        print(f"seq {name}", json.dumps(rows[name]), flush=True)
        for kind, r in per_block.items():
            print(f"seq {name} K1 {kind} block ms {r['k1_ms']} (plain {r['plain_ms']}, bound "
                  f"{r['bound_ms']}) | card: {card}", flush=True)
    return rows, launches


def check_frozen_inception(card, torch, fa, inception, direct):
    """Phase 13 (d): phase 5's Inception frozen at batch 128 on the card,
    loaded, and run over 512 records through ``count_window(128) ->
    GraphWindowFunction`` beside ``ModelWindowFunction``."""
    import copy

    import numpy as np

    from flink_tensorflow_tpu_torch.models import inception_cell as cell
    from flink_tensorflow_tpu_torch.models.loaders import GraphLoader, freeze_method
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    mdef, model, pixels = inception
    n = GRAPH_RECORDS
    records = [TensorValue({"image": pixels[i]}, {"id": i}) for i in range(n)]
    t0 = time.monotonic()
    frozen = freeze_method(model, batch=cell.BATCH)
    freeze_s = time.monotonic() - t0
    t0 = time.monotonic()
    program = GraphLoader(frozen).load("cuda")
    load_s = time.monotonic() - t0
    fa.flash_attention.launches = 0
    graph = cell.run_graph_job(frozen, mdef.methods["serve"].input_schema, records)
    launches = fa.flash_attention.launches
    check_ids("graph inception", graph.results, n)
    model_run = cell.run_cell_job(model, records)
    check_ids("graph inception (model arm)", model_run.results, n)
    label = np.empty(n, np.int32)
    score = np.empty(n, np.float32)
    for r in graph.results:
        label[r.meta["id"]] = r["label"]
        score[r.meta["id"]] = r["score"]
    want_label, want_score = direct[0][:n], direct[1][:n]
    bit_equal = np.array_equal(label, want_label) and np.array_equal(score, want_score)
    extra = {}
    if not bit_equal:
        # Export may pick other kernels: the job must equal direct calls of
        # the frozen program bit for bit, and the program the module within
        # the bf16 bar (labels equal where the top-2 gap is clear).
        module = copy.deepcopy(model.params).to("cuda").eval()
        serve = mdef.methods["serve"].fn
        worst, flips = 0.0, 0
        with torch.inference_mode():
            for lo in range(0, n, cell.BATCH):
                x = torch.from_numpy(pixels[lo:lo + cell.BATCH].copy()).cuda()
                got, ref = program({"image": x}), serve(module, {"image": x})
                if not (np.array_equal(got["label"].cpu().numpy(), label[lo:lo + cell.BATCH])
                        and np.array_equal(got["score"].cpu().numpy(),
                                           score[lo:lo + cell.BATCH])):
                    fail("graph inception: the job differs from direct calls of the program")
                gl, rl = got["logits"].float().cpu().numpy(), ref["logits"].float().cpu().numpy()
                peak = np.abs(rl).max()
                worst = max(worst, float(np.abs(gl - rl).max() / peak))
                top2 = np.sort(rl, axis=-1)[:, -2:]
                clear = (top2[:, 1] - top2[:, 0]) > 2 * INCEPTION_BF16_TOL * peak
                flips += int((got["label"].cpu().numpy() != ref["label"].cpu().numpy())[clear]
                             .sum())
        del module
        extra = {"logits_rel_err_vs_module": worst, "tolerance": INCEPTION_BF16_TOL,
                 "clear_label_flips": flips,
                 "labels_differing": int((label != want_label).sum())}
        if worst > INCEPTION_BF16_TOL or flips:
            fail(f"graph inception: frozen logits {worst} of max |logit| from the module's, "
                 f"{flips} clear labels flipped")
    if launches:
        fail(f"graph inception launched K1 {launches} times, want 0")
    # The forward alone, a batch of 128 on the card: the program against
    # the module it was frozen from (the jobs' rates below include each
    # one's open: the program's load, the module's copy to the card).
    module = copy.deepcopy(model.params).to("cuda").eval()
    serve = mdef.methods["serve"].fn
    x = {"image": torch.from_numpy(pixels[:cell.BATCH].copy()).cuda()}
    with torch.inference_mode():
        forward = {"graph_ms": time_ms(lambda: program(x), 10),
                   "model_ms": time_ms(lambda: serve(module, x), 10)}
    del module, program
    # Four batches at depth 6 are all in flight at once and land in one
    # burst, so a steady rate between results means nothing here.
    rates = {what: {"job_records_per_s": n / run.seconds}
             for what, run in (("graph", graph), ("model", model_run))}
    row = {"records": n, "batch": cell.BATCH, "freeze_s": freeze_s, "load_s": load_s,
           "artifact_bytes": len(frozen), "bit_equal_direct": bit_equal, **extra, **rates,
           "forward_batch_ms": forward, "card": card}
    print("graph inception", json.dumps(row), flush=True)
    print(f"graph inception job records/s {rates['graph']['job_records_per_s']} "
          f"(ModelWindowFunction {rates['model']['job_records_per_s']}), forward of 128 "
          f"{forward['graph_ms']} ms (module {forward['model_ms']}), freeze {freeze_s} s, "
          f"load {load_s} s | card: {card}", flush=True)
    return row, launches


def check_parallel(card, torch, fa, resnet_ref, inception, direct):
    """Phase 13: data parallelism over NCCL and gloo, sequence parallelism
    on K1, and the frozen Inception."""
    from flink_tensorflow_tpu_torch.parallel import multihost

    t0 = time.monotonic()
    try:
        _, ref8, losses8, floor, nccl_launches = check_dp_nccl(card, torch, fa, resnet_ref)
        _, seq_launches = check_seq_parallel(card, torch, fa)
    finally:
        multihost.shutdown()
    gloo_launches = check_dp_gloo(card, torch, ref8, losses8, floor)["k1_launches"]
    _, graph_launches = check_frozen_inception(card, torch, fa, inception, direct)
    print(f"parallel phase_seconds: {time.monotonic() - t0} | card: {card}", flush=True)
    return {"dp_nccl_w1": nccl_launches, "dp_gloo_2rank": gloo_launches, **seq_launches,
            "graph_inception": graph_launches}


# Phase 14 (b): bench.py:bench_filesplit at its full scale (48): one
# dominant file and a tail of small ones, read by 4 pulling readers.
FILESPLIT_SCALE = 48
FILESPLIT_SIZES = tuple(k * FILESPLIT_SCALE for k in (12, 4, 2, 1, 1, 1, 1, 1, 1))
FILESPLIT_PARALLELISM = 4
FILESPLIT_THROTTLE_S = 0.0005
# Phase 14 (c): phase 13 (b)'s two gloo ranks under a CohortSupervisor,
# 8 steps, count-based checkpoints every 2 steps
# (``train_cell.SUPERVISED_EVERY_N_STEPS``); on attempt 0 the last
# rank exits at step 5, after checkpoint 2 (cut after step 4) is on both
# ranks' disks, so the restart restores checkpoint 2 and runs steps 5-8.
SUPERVISED_STEPS = 8
SUPERVISED_FAIL_AT_STEP = 5
# Phase 15 (a): passes per shuffle arm and size (the bench takes the best
# of 2).
SHUFFLE_PASSES = 2
# Phase 15 (c): the widedeep-online cell's 8,192 events paced at 1 ms
# while two processes run it (a kill must find a committed checkpoint and
# the stream unfinished), checkpoints every 1,024 events
# (``train_cell.WIDEDEEP_EVERY_N_RECORDS``, phase 7's).
COHORT_WIDEDEEP_THROTTLE_S = 0.001
COHORT_TIMEOUT_S = 300


def check_open_loop_serving(card, torch, fa, mdef, model, cfg, requests, want):
    """Phase 14 (a): the serving bench's open-loop arms
    (``serving/cell.py:open_loop_arm``) on phase 4's weights and requests,
    fixed arm first at each offered load.  Every session served once with
    phase 4's tokens, K1's launches counted exactly, the fixed arm's window
    fused into the split source's chain.  Returns K1's launches per arm."""
    from flink_tensorflow_tpu_torch.serving.cell import OPEN_LOOP_RATES, open_loop_arm

    layers = mdef.config["num_layers"]
    warm = len(cfg.resolved_admit_buckets()) * len(cfg.resolved_prompt_buckets())
    sessions = {r.session_id for r in requests}
    launches = {}
    for rate in OPEN_LOOP_RATES:
        rows = {}
        for arm in ("fixed", "continuous"):
            what = f"serving-open-loop {arm}@{rate:g}"
            fa.flash_attention.launches = 0
            run = open_loop_arm(model, cfg, requests, arm, rate)
            n = fa.flash_attention.launches
            seen = set()
            for _, ev in run.events:
                if (ev.session_id, ev.index) in seen:
                    fail(f"{what}: session {ev.session_id} emitted index {ev.index} twice")
                seen.add((ev.session_id, ev.index))
            got = by_session(ev for _, ev in run.events)
            if set(got) != sessions:
                fail(f"{what}: served {len(got)} of {len(sessions)} sessions")
            hold_tokens(what, got, want, requests, model, torch)
            report = run.env.metric_registry.report()
            prefills = sum(v for k, v in report.items() if k.endswith(".prefill_batches"))
            if n != layers * (prefills + warm):
                fail(f"{what}: K1 launches {n} != {layers} x ({prefills} prefill batches "
                     f"+ {warm} warmup prefills)")
            plan = run.env.describe()
            if arm == "fixed" and "sessions -> fixed_window_generate -> sink" not in plan:
                fail(f"{what}: the count window is not fused into the split source's chain: "
                     f"{plan}")
            print(what, json.dumps({**run.row, "k1_launches": n, "prefill_batches": prefills,
                                    "warmup_prefills": warm, "plan": plan, "card": card}),
                  flush=True)
            rows[arm] = run.row
            launches[f"serving_open_loop_{arm}_{rate:g}"] = n
        fixed, cont = rows["fixed"], rows["continuous"]
        point = {"offered_rate_rps": rate,
                 "continuous_dominates_tokens_per_s":
                     (cont["tokens_per_s"] or 0) > (fixed["tokens_per_s"] or 0),
                 "continuous_dominates_ttft":
                     (cont["ttft_p50_ms"] or 1e9) < (fixed["ttft_p50_ms"] or 0),
                 "ttft_p50_speedup": (fixed["ttft_p50_ms"] / cont["ttft_p50_ms"]
                                      if cont["ttft_p50_ms"] and fixed["ttft_p50_ms"]
                                      else None)}
        print(f"serving-open-loop point@{rate:g}", json.dumps(point), f"| card: {card}",
              flush=True)
    return launches


def check_filesplit(card, fa):
    """Phase 14 (b): ``bench.py:bench_filesplit``'s skewed files through
    ``FileSplitSource`` at parallelism 4 -> rebalance -> identity map ->
    sink: every id once, records/s and the splits each reader completed.
    No operator of this job touches the card."""
    import tempfile

    import numpy as np

    from flink_tensorflow_tpu_torch.core.environment import StreamExecutionEnvironment
    from flink_tensorflow_tpu_torch.io.files import write_record_file
    from flink_tensorflow_tpu_torch.sources import FileSplitSource
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    fa.flash_attention.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_filesplit_") as tmp:
        paths, idx = [], 0
        for f, n in enumerate(FILESPLIT_SIZES):
            path = os.path.join(tmp, f"part-{f:02d}.rec")
            write_record_file(path, [TensorValue({"x": np.float32(idx + i)}, {"id": idx + i})
                                     for i in range(n)])
            idx += n
            paths.append(path)
        env = StreamExecutionEnvironment(parallelism=1)
        env.source_throttle_s = FILESPLIT_THROTTLE_S
        results = []
        (env.from_source(FileSplitSource(paths), name="filesplit",
                         parallelism=FILESPLIT_PARALLELISM)
         .rebalance().map(lambda r: r, name="ident", parallelism=FILESPLIT_PARALLELISM)
         .sink_to_callable(results.append))
        t0 = time.monotonic()
        env.execute("filesplit", timeout=600)
        seconds = time.monotonic() - t0
    check_ids("filesplit", results, idx)
    report = env.metric_registry.report()
    splits = {i: report[f"filesplit.{i}.splits_completed"] for i in range(FILESPLIT_PARALLELISM)}
    if sum(splits.values()) != len(FILESPLIT_SIZES):
        fail(f"filesplit: {splits} splits completed, want {len(FILESPLIT_SIZES)} in all")
    row = {"records": idx, "records_per_s": idx / seconds, "seconds": seconds,
           "file_sizes": list(FILESPLIT_SIZES), "throttle_s": FILESPLIT_THROTTLE_S,
           "splits_completed": splits, "splits_assigned": report["filesplit.0.splits_assigned"],
           "k1_launches": fa.flash_attention.launches,
           "note": "host-only arm: no operator of this job runs on the card"}
    print("filesplit", json.dumps(row), f"| card: {card}", flush=True)
    return {"filesplit": fa.flash_attention.launches}


def supervised_ranks(what, fail_at_step=None, cohort=False):
    """Phase 13 (b)'s two gloo ranks under a ``CohortSupervisor``, as
    supervised workers (``train_cell --checkpoint-root``; with ``cohort``,
    one job over the record plane, ``--plane-ports``).  Returns the
    outcome, the ranks' files from the attempt that succeeded, the seconds,
    the rank processes of every attempt and each rank's checkpoint ids."""
    import tempfile

    import torch

    from flink_tensorflow_tpu_torch.checkpoint.store import checkpoint_ids
    from flink_tensorflow_tpu_torch.functions.train_cell import cohort_dirs, rank_checkpoint_dirs
    from flink_tensorflow_tpu_torch.parallel import CohortFailed, CohortSupervisor

    class Recording(CohortSupervisor):
        """Keeps every rank process it spawns in ``procs``."""

        def _spawn(self, attempt, num_workers):
            started = super()._spawn(attempt, num_workers)
            self.procs.extend(started)
            return started

    with tempfile.TemporaryDirectory(prefix="chip_smoke_supervised_") as root:
        out, chk = os.path.join(root, "out"), os.path.join(root, "chk")
        os.makedirs(out)
        ports = {}

        def command(w, n, a):
            port, *plane = ports.setdefault(a, free_ports(1 + (n if cohort else 0)))
            cmd = [sys.executable, "-m", "flink_tensorflow_tpu_torch.functions.train_cell",
                   "--rank", str(w), "--world", str(n), "--port", str(port),
                   "--steps", str(SUPERVISED_STEPS), "--out", out, "--backend", "gloo",
                   "--checkpoint-root", chk, "--attempt", str(a)]
            if plane:
                cmd += ["--plane-ports", ",".join(map(str, plane))]
            return cmd + (["--fail-at-step", str(fail_at_step)] if fail_at_step else [])

        path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
        sup = Recording(command, 2, env=lambda w, n, a: {"PYTHONPATH": path}, max_restarts=1,
                        poll_s=0.1, kill_grace_s=10.0, attempt_timeout_s=DP_RANK_TIMEOUT_S)
        sup.procs = []
        t0 = time.monotonic()
        try:
            outcome = sup.run()
        except CohortFailed as exc:
            fail(f"{what}: {exc}")
        seconds = time.monotonic() - t0
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        dirs = cohort_dirs(chk, 2) if cohort else rank_checkpoint_dirs(chk, 2)
        held = {r: checkpoint_ids(d) for r, d in enumerate(dirs)}
    alive = [p.pid for p in sup.procs if p.poll() is None]
    if alive:
        fail(f"{what}: rank processes {alive} outlived the supervisor")
    return outcome, ranks, seconds, sup.procs, held


def check_supervised_gang(card, torch):
    """Phase 14 (c): the supervised restart of the gang.  An uninterrupted
    supervised run, then one whose last rank exits at step 5 on attempt 0:
    two attempts, no rank left alive, both ranks restored from checkpoint
    2 (the newest both hold), and steps 5-8's losses and the final params
    and batch statistics equal the uninterrupted run's bit for bit."""
    import gc

    from flink_tensorflow_tpu_torch.functions.train_cell import (
        FAIL_EXIT_CODE,
        SUPERVISED_EVERY_N_STEPS,
    )

    # The rank processes share the card with this one, whose caching
    # allocator still holds what the earlier phases freed (all but a few
    # GB of the card after phase 13): give it back first.
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    used_before = total - free
    clean, want, clean_s, _, _ = supervised_ranks("supervised gang, uninterrupted")
    outcome, got, seconds, procs, held = supervised_ranks(
        "supervised gang, failed at step 5", SUPERVISED_FAIL_AT_STEP)
    restored_step = (SUPERVISED_FAIL_AT_STEP - 1) // SUPERVISED_EVERY_N_STEPS
    first = restored_step * SUPERVISED_EVERY_N_STEPS + 1
    codes = [p.returncode for p in procs]
    if (clean.attempts, outcome.attempts, outcome.returncode) != (1, 2, 0):
        fail(f"supervised gang: attempts {clean.attempts} and {outcome.attempts} "
             f"(rc {outcome.returncode}), want 1 and 2")
    if len(procs) != 4 or FAIL_EXIT_CODE not in codes or codes.count(0) != 2:
        fail(f"supervised gang: rank exit codes {codes}")
    for r in range(2):
        a, b = got[r], want[r]
        if b["steps"] != list(range(1, SUPERVISED_STEPS + 1)) or b["device"] != "cuda:0":
            fail(f"supervised gang: the uninterrupted rank {r} ran steps {b['steps']} "
                 f"on {b['device']}")
        if (a["attempt"], a["restored_checkpoint"]) != (1, restored_step):
            fail(f"supervised gang: rank {r} restored {a['restored_checkpoint']} on attempt "
                 f"{a['attempt']}, want checkpoint {restored_step} on attempt 1")
        if a["steps"] != list(range(first, SUPERVISED_STEPS + 1)):
            fail(f"supervised gang: rank {r} ran steps {a['steps']} after the restore")
        if a["losses"] != b["losses"][first - 1:]:
            fail(f"supervised gang: rank {r} losses after the restore {a['losses']} differ "
                 f"from the uninterrupted run's {b['losses'][first - 1:]}")
        for coll in ("params", "batch_stats"):
            if not _bit_equal(a["variables"][coll], b["variables"][coll]):
                fail(f"supervised gang: rank {r}'s final {coll} differ from the "
                     "uninterrupted run's")
    k1 = sum(r["k1_launches"] for r in got + want)
    if k1:
        fail(f"supervised gang: K1 launched {k1} times, want 0")
    free, total = torch.cuda.mem_get_info()
    # Mean seconds per step from the first result to the last: results
    # reach the sink in bursts around the checkpoints, so the median gap
    # between two says nothing of the step.
    step_s = {name: [(r["arrivals"][-1] - r["arrivals"][0]) / (len(r["arrivals"]) - 1)
                     for r in ranks]
              for name, ranks in (("uninterrupted", want), ("restored", got))}
    row = {"ranks": 2, "backend": "gloo", "device": "cuda:0", "steps": SUPERVISED_STEPS,
           "checkpoint_every_steps": SUPERVISED_EVERY_N_STEPS,
           "fail_at_step": SUPERVISED_FAIL_AT_STEP, "attempts": outcome.attempts,
           "rank_exit_codes": codes, "restored_checkpoint": restored_step,
           "checkpoints_held": held, "bit_equal": True, "seconds_per_step": step_s,
           "seconds_uninterrupted": clean_s, "seconds_supervised": seconds,
           "card_memory_used_bytes_before": used_before,
           "card_memory_used_bytes_after": total - free, "card_memory_total_bytes": total,
           "k1_launches": k1, "card": card}
    print("supervised gang", json.dumps(row), flush=True)
    print(f"supervised gang seconds per step {step_s} (2 ranks sharing one card, not a "
          f"multi-card number); card memory in use after the supervisor returned "
          f"{total - free} B | card: {card}", flush=True)
    return {"supervised_gang": k1}, want


def check_split_sources(card, torch, fa, mdef, model, cfg, requests, want):
    """Phase 14: split sources and the cohort supervisor."""
    t0 = time.monotonic()
    launches = check_open_loop_serving(card, torch, fa, mdef, model, cfg, requests, want)
    launches.update(check_filesplit(card, fa))
    gang_launches, per_rank = check_supervised_gang(card, torch)
    launches.update(gang_launches)
    print(f"split sources phase_seconds: {time.monotonic() - t0} | card: {card}", flush=True)
    return launches, per_rank


def check_shuffle_arms(card, torch):
    """Phase 15 (a): ``bench.py:bench_shuffle``'s arms and sizes through
    ``core/shuffle_probe.py`` (a sender subprocess into this process's
    reactor), and a tensor on the card across a remote channel."""
    from flink_tensorflow_tpu_torch.core import elements as el
    from flink_tensorflow_tpu_torch.core.channels import InputGate
    from flink_tensorflow_tpu_torch.core.shuffle import RemoteChannelWriter, ShuffleServer
    from flink_tensorflow_tpu_torch.core.shuffle_probe import SIZES, shuffle_bench

    try:
        bench = shuffle_bench(SIZES, SHUFFLE_PASSES)
    except RuntimeError as exc:
        fail(f"shuffle arms: {exc}")
    for name, rows in bench["arms"].items():
        for row in rows:
            print(f"shuffle {name}", json.dumps(row), f"| card: {card}", flush=True)
    ratios = {k: v for k, v in bench.items() if k != "arms"}
    print("shuffle ratios", json.dumps(ratios),
          "(host-only arms: no tensor touches the card)", f"| card: {card}", flush=True)
    # A card tensor crosses as its host copy; the receiver builds a CPU
    # tensor and touches no device.
    gate = InputGate(1, capacity=4)
    server = ShuffleServer("127.0.0.1")
    server.register_gate("t", 0, gate)
    server.start()
    writer = RemoteChannelWriter("127.0.0.1", server.port, "t", 0, 0, flush_bytes=0)
    sent = torch.arange(12, dtype=torch.bfloat16, device="cuda").reshape(3, 4) / 7
    try:
        writer.write(el.StreamRecord({"t": sent}))
        item = gate.poll(timeout=30.0)
    finally:
        writer.close()
        server.close()
    got = None if item is None else item[1].value["t"]
    if (got is None or got.device.type != "cpu" or got.dtype != sent.dtype
            or not torch.equal(got, sent.cpu())):
        fail(f"a card tensor across the record plane arrived as {got!r}")
    return bench


def check_cohort_gang(card, torch, per_rank):
    """Phase 15 (b): the reference's multihost DP job on the record plane,
    uninterrupted and restarted; held to itself bit for bit, to phase 14
    (c)'s per-rank job bit for bit, and for every (rank, step) once at
    process 0's sink."""
    import gc

    from flink_tensorflow_tpu_torch.functions.train_cell import (
        FAIL_EXIT_CODE,
        SUPERVISED_EVERY_N_STEPS,
    )

    gc.collect()
    torch.cuda.empty_cache()
    clean, want, clean_s, _, _ = supervised_ranks("cohort gang, uninterrupted", cohort=True)
    outcome, got, seconds, procs, held = supervised_ranks(
        "cohort gang, failed at step 5", SUPERVISED_FAIL_AT_STEP, cohort=True)
    restored = (SUPERVISED_FAIL_AT_STEP - 1) // SUPERVISED_EVERY_N_STEPS
    first = restored * SUPERVISED_EVERY_N_STEPS + 1
    codes = [p.returncode for p in procs]
    if (clean.attempts, outcome.attempts, outcome.returncode) != (1, 2, 0):
        fail(f"cohort gang: attempts {clean.attempts} and {outcome.attempts} "
             f"(rc {outcome.returncode}), want 1 and 2")
    if len(procs) != 4 or FAIL_EXIT_CODE not in codes or codes.count(0) != 2:
        fail(f"cohort gang: process exit codes {codes}")
    steps = range(1, SUPERVISED_STEPS + 1)
    # Process 0's sink: every (rank, step) once, each the step's loss.
    for name, runs, span in (("uninterrupted", want, steps),
                             ("restored", got, range(first, SUPERVISED_STEPS + 1))):
        pairs = sorted(zip(runs[0]["gang_subtasks"], runs[0]["steps"]))
        if pairs != [(g, s) for g in range(2) for s in span] or runs[1]["steps"]:
            fail(f"cohort gang, {name}: process 0's sink received {pairs} (process 1's "
                 f"{runs[1]['steps']}), want every (rank, step) of steps {list(span)} once")
    losses = {}
    for g, s, loss in zip(want[0]["gang_subtasks"], want[0]["steps"], want[0]["losses"]):
        if losses.setdefault(s, loss) != loss:
            fail(f"cohort gang: the ranks' losses of step {s} differ")
    for r in range(2):
        if (got[r]["attempt"], got[r]["restored_checkpoint"]) != (1, restored):
            fail(f"cohort gang: process {r} restored {got[r]['restored_checkpoint']} on "
                 f"attempt {got[r]['attempt']}, want checkpoint {restored} on attempt 1")
        if want[r]["device"] != "cuda:0":
            fail(f"cohort gang: process {r} ran on {want[r]['device']}")
        for coll in ("params", "batch_stats"):
            if not _bit_equal(got[r]["variables"][coll], want[r]["variables"][coll]):
                fail(f"cohort gang: process {r}'s final {coll} after the restore differ from "
                     "the uninterrupted run's")
            if not _bit_equal(want[r]["variables"][coll], per_rank[r]["variables"][coll]):
                fail(f"cohort gang: process {r}'s final {coll} differ from phase 14 (c)'s "
                     "per-rank job's")
        if [losses[s] for s in steps] != per_rank[r]["losses"]:
            fail(f"cohort gang: losses {[losses[s] for s in steps]} differ from phase 14 "
                 f"(c)'s per-rank job's {per_rank[r]['losses']}")
    for g, s, loss in zip(got[0]["gang_subtasks"], got[0]["steps"], got[0]["losses"]):
        if loss != losses[s]:
            fail(f"cohort gang: rank {g}'s loss of step {s} after the restore {loss} differs "
                 f"from the uninterrupted run's {losses[s]}")
    k1 = sum(r["k1_launches"] for r in got + want)
    if k1:
        fail(f"cohort gang: K1 launched {k1} times, want 0")
    arrivals = want[0]["arrivals"]
    row = {"processes": 2, "backend": "gloo + record plane", "device": "cuda:0",
           "steps": SUPERVISED_STEPS, "checkpoint_every_steps": SUPERVISED_EVERY_N_STEPS,
           "fail_at_step": SUPERVISED_FAIL_AT_STEP, "attempts": outcome.attempts,
           "exit_codes": codes, "restored_checkpoint": restored, "checkpoints_held": held,
           "bit_equal": True,
           "equal_to_per_rank_job": True,
           "sink_records": {"uninterrupted": len(want[0]["steps"]),
                            "restored": len(got[0]["steps"])},
           "seconds_per_step": (arrivals[-1] - arrivals[0]) / (SUPERVISED_STEPS - 1),
           "seconds_uninterrupted": clean_s, "seconds_supervised": seconds,
           "job_seconds": {"uninterrupted": want[0]["seconds"], "restored": got[0]["seconds"]},
           "k1_launches": k1, "card": card}
    print("cohort gang", json.dumps(row), flush=True)
    return {"cohort_gang": k1}


def widedeep_cohort_proc(rank, world, ports, out, chk, *, par, throttle=0.0, restore_id=None):
    cmd = [sys.executable, "-m", "flink_tensorflow_tpu_torch.functions.train_cell", "--widedeep",
           "--rank", str(rank), "--world", str(world), "--plane-ports", ",".join(map(str, ports)),
           "--out", out, "--checkpoint-root", chk, "--par", str(par),
           "--throttle", str(throttle)]
    if restore_id is not None:
        cmd += ["--restore-id", str(restore_id)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def wait_procs(what, procs, timeout=COHORT_TIMEOUT_S):
    """Every process's exit code and output; kills what outlives ``timeout``."""
    deadline = time.monotonic() + timeout
    results = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail(f"{what}: a process hung")
        results.append((p.returncode, out.decode(errors="replace")))
    return results


def committed_steps(out):
    from flink_tensorflow_tpu_torch.io.files import read_committed

    return [(int(r.meta["key"]), int(r["step"]), float(r["loss"])) for r in read_committed(out)]


def check_widedeep_cohort(card, torch):
    """Phase 15 (c): the widedeep-online cell keyed over the cohort,
    process 0 killed once the commit gate has promoted a checkpoint's
    output, restored as three processes."""
    import signal
    import tempfile

    from flink_tensorflow_tpu_torch.functions import train_cell
    from flink_tensorflow_tpu_torch.parallel.supervisor import latest_common_checkpoint

    mdef, schema, records = train_cell.widedeep_cell()
    n, every = len(records), train_cell.WIDEDEEP_EVERY_N_RECORDS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_widedeep_cohort_") as root:
        base = os.path.join(root, "base")
        base_s = train_cell.run_widedeep_cohort(
            mdef, schema, records, None, out=base, checkpoint_root=os.path.join(root, "chk1"),
            every_n_records=every, parallelism=2,
            device_provider=lambda task, index: "cuda:0")
        want = sorted(committed_steps(base))
        out, chk = os.path.join(root, "out"), os.path.join(root, "chk")
        dirs = train_cell.cohort_dirs(chk, 2)
        ports = free_ports(2)
        t0 = time.monotonic()
        procs = [widedeep_cohort_proc(r, 2, ports, out, chk, par=2,
                                      throttle=COHORT_WIDEDEEP_THROTTLE_S) for r in range(2)]
        # The kill waits for the global commit gate to promote a
        # checkpoint's 2PC output, so the restored cohort must also not
        # commit again what was committed before the kill.
        common, committed = None, 0
        while time.monotonic() - t0 < COHORT_TIMEOUT_S:
            common = latest_common_checkpoint(dirs)
            committed = (len(committed_steps(out))
                         if common is not None and os.path.isdir(out) else 0)
            if committed or any(p.poll() is not None for p in procs):
                break
            time.sleep(0.05)
        t_kill = time.monotonic()
        if not committed:
            for p in procs:
                p.kill()
            fail(f"widedeep cohort: nothing committed before the kill (checkpoint {common}): "
                 f"{[r for r in wait_procs('widedeep cohort', procs)]}")
        cohort_rate = (common * every) / (t_kill - t0)
        procs[0].send_signal(signal.SIGKILL)
        codes = [rc for rc, _ in wait_procs("widedeep cohort, killed", procs)]
        if codes[0] != -signal.SIGKILL or codes[1] == 0:
            fail(f"widedeep cohort: exit codes {codes} after killing process 0 (the survivor "
                 "must fail)")
        common = latest_common_checkpoint(dirs)
        ports = free_ports(3)
        t1 = time.monotonic()
        procs = [widedeep_cohort_proc(r, 3, ports, out, chk, par=3, restore_id=common)
                 for r in range(3)]
        results = wait_procs("widedeep cohort, restored", procs)
        restored_s = time.monotonic() - t1
        for r, (rc, log) in enumerate(results):
            if rc != 0:
                fail(f"widedeep cohort: restored process {r} failed:\n{log[-4000:]}")
        with open(os.path.join(chk, "seconds-0.json")) as f:
            job_s = json.load(f)["seconds"]
        got = sorted(committed_steps(out))
    pairs = [(k, s) for k, s, _ in got]
    if len(set(pairs)) != len(pairs) or pairs != [(k, s) for k, s, _ in want]:
        fail(f"widedeep cohort: committed (key, step) pairs differ from the one-process run's "
             f"({len(pairs)} vs {len(want)}, {len(set(pairs))} distinct)")
    if len(want) != train_cell.expected_steps(records):
        fail(f"widedeep cohort: the one-process run committed {len(want)} steps, want "
             f"{train_cell.expected_steps(records)}")
    equal = sum(a[2] == b[2] for a, b in zip(got, want))
    if equal != len(want):
        worst = max(abs(a[2] - b[2]) / max(abs(b[2]), 1e-30) for a, b in zip(got, want))
        fail(f"widedeep cohort: {len(want) - equal} of {len(want)} losses differ from the "
             f"one-process run's (worst relative {worst:.3g}); each key trains its own model "
             "on the same events in the same dispatch groups, so they must be equal bits")
    row = {"events": n, "steps": len(want), "keys": train_cell.WIDEDEEP_USERS,
           "processes": "2 -> 3", "keyed_parallelism": "2 -> 3",
           "restored_checkpoint": common, "committed_at_kill": committed,
           "losses_bit_equal": equal,
           "records_per_s": {"one_process": n / base_s,
                             "cohort_2_spawn_to_checkpoint_incl_startup": cohort_rate,
                             "restored_3": (n - common * every) / job_s},
           "note": "the 2-process run is paced at 1 ms per event until the kill",
           "seconds": {"one_process": base_s, "restored_job": job_s,
                       "restored_processes": restored_s,
                       "recovery_kill_to_done": time.monotonic() - t_kill},
           "card": card}
    print("widedeep cohort", json.dumps(row), flush=True)


def check_record_plane(card, torch, fa, per_rank):
    """Phase 15: the distributed record plane; K1 must launch 0 times."""
    t0 = time.monotonic()
    fa.flash_attention.launches = 0
    check_shuffle_arms(card, torch)
    launches = check_cohort_gang(card, torch, per_rank)
    check_widedeep_cohort(card, torch)
    in_process = fa.flash_attention.launches
    if in_process:
        fail(f"phase 15 launched K1 {in_process} times in this process, want 0")
    launches["record_plane"] = in_process
    print(f"record plane phase_seconds: {time.monotonic() - t0} | card: {card}", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)

    sys.path.insert(0, REPO)
    from flink_tensorflow_tpu_torch.ops import _build
    from flink_tensorflow_tpu_torch.ops import flash_attention as fa

    # f32 products stay f32 on the card (the reference is f32 throughout).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    logs = _build.build_all()
    build_s = time.monotonic() - t0
    print(f"build: {build_s:.2f} s for {sorted(logs) or 'cached libraries'}", flush=True)
    for source, log in logs.items():
        for entry, line in ptxas_report(log):
            print(f"  {source}: {entry}: {line}")

    k1_rows = check_k1(fa, torch)

    from flink_tensorflow_tpu_torch.serving.cell import serve, serving_cell

    mdef, tree, cfg, requests = serving_cell(SEED)
    model = mdef.to_model(tree)
    fa.flash_attention.launches = 0
    events, seconds, metrics = serve(model, cfg, requests)
    launches = fa.flash_attention.launches
    got = by_session(events)
    if set(got) != {r.session_id for r in requests}:
        fail(f"served {len(got)} of {len(requests)} sessions")
    for r in requests:
        toks = got[r.session_id]
        if len(toks) != r.max_new_tokens or not all(0 <= x < 64 for x in toks):
            fail(f"session {r.session_id}: {len(toks)} tokens, want {r.max_new_tokens}")
    prefill_batches = metrics.counter("prefill_batches").count
    warm_prefills = len(cfg.resolved_admit_buckets()) * len(cfg.resolved_prompt_buckets())
    layers = mdef.config["num_layers"]
    if launches != layers * (prefill_batches + warm_prefills):
        fail(f"K1 launches {launches} != {layers} x ({prefill_batches} prefill batches "
             f"+ {warm_prefills} warmup prefills)")

    cpu_events, cpu_seconds, _ = serve(model, cfg, requests, "cpu")
    want = by_session(cpu_events)
    for r in requests:
        a, b = got[r.session_id], want[r.session_id]
        if a != b:
            step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            fail(f"session {r.session_id} differs from the CPU run at step {step}: "
                 f"gpu {a[step]} vs cpu {b[step]}")

    tokens = sum(len(v) for v in got.values())
    ttft = metrics.histogram("ttft_s")
    step_s = metrics.histogram("decode_step_s")
    serving_row = {
        "sessions": len(got), "tokens": tokens, "seconds": seconds,
        "tokens_per_s": tokens / seconds,
        "ttft_p50_ms": ttft.percentile(50) * 1e3, "ttft_p95_ms": ttft.percentile(95) * 1e3,
        "decode_step_p50_ms": step_s.percentile(50) * 1e3,
        "decode_step_p95_ms": step_s.percentile(95) * 1e3,
        "decode_steps": len(step_s.values), "prefill_batches": prefill_batches,
        "warmup_prefills": warm_prefills, "k1_launches": launches,
        "cpu_seconds": cpu_seconds, "arrivals": "flood (all 96 fed back to back)",
        "card": card,
    }
    print("serving", json.dumps(serving_row), flush=True)

    _, inception, direct = check_inception(card, torch)

    keyed_launches, dense_keyed = check_keyed_serving(card, torch, fa, mdef, model, cfg,
                                                      requests, got, serving_row)

    training_launches, resnet_ref = check_training(card, torch, fa)

    stream_launches = check_stream_models(card, torch, fa, inception)

    chain_launches = check_chaining(card, torch, fa, inception, direct)

    paged_launches = check_paged_serving(card, torch, fa, model, cfg, requests, got, dense_keyed)

    event_time_launches = check_event_time(card, torch, fa, inception)

    transfer_launches = check_transfer_plane(card, torch, fa, inception, direct)

    parallel_launches = check_parallel(card, torch, fa, resnet_ref, inception, direct)

    split_launches, per_rank = check_split_sources(card, torch, fa, mdef, model, cfg,
                                                   requests, got)

    plane_launches = check_record_plane(card, torch, fa, per_rank)

    serving_k1 = k1_rows[0]
    kernels = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "flink_tensorflow_tpu_torch/csrc/flash_attention.cu",
        "replaces": "flink_tensorflow_tpu/ops/flash_attention.py:245",
        "launches": launches,
        "max_abs_err": serving_k1["max_abs_err"],
        "ms": serving_k1["kernel_ms"],
        "plain_ms": serving_k1["plain_ms"],
        "bound_ms": serving_k1["bound_ms"],
        "bound_by": serving_k1["bound_by"],
        "library_ms": serving_k1["library_ms"],
        "launches_by_path": {"serving_subtask_loop": launches, **keyed_launches,
                             **training_launches, **stream_launches, **chain_launches,
                             **paged_launches, **event_time_launches,
                             **transfer_launches, **parallel_launches, **split_launches,
                             **plane_launches},
    }]}
    print(json.dumps(kernels))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
