#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sofa_tpu_torch``).

    python3 chip_smoke.py          # one H100, no arguments

The timed phases run alone, in this order (device, kernel, kernel_perf,
model, train, ring, resnet); then three lanes run side by side, each a
thread that runs its phases in order: (1) profile, cluster, mesh, tp,
tp_serve: the card's Llama-width runs at batch 4 and the multi-rank ones,
up to 43 GB of the card at a time, then tooling, host only, examples (under
2 GB of the card) and chaos_tier, host only; (2) live, serve, window,
faults, ep_pp: its runs of at most 21 GB, then fleet_tier, host only; (3)
train_f32 (under 2 GB, the only launches of this process while the lanes
run), then robust, board, cache, verbs, archive, fleet_push, live_drain:
host only.
The host-only phases run over the captures the card made, each waiting for
the phase of another lane whose capture it reads.  A failure anywhere
raises and exits non-zero; a lane's failure stops every lane before its
next phase.  The phases:

  device   the card's name and power limit; builds the six CUDA kernels
           (the three Hopper kernels and the three general ones) from the
           sources in the checkout, and the ring-depth variants
           kernel_perf's tune_flash sweeps (one nvcc each, all at once),
           and the native sysmon /proc sampler and Perfetto writer with the
           machine's C++ compiler, printing it and the build seconds
  kernel   holds each kernel against its plain PyTorch version at the
           shapes the main paths give it (a tensor-parallel rank's heads,
           H 16 / KVH 4, too) and at the mask and tiling edge cases,
           checks that every kernel is deterministic (two launches
           bit-identical), holds the backward pair in both output modes
           (float32 at GRAD_REL, bfloat16 one ulp wider), and times kernel and one library call in turns
           (kernel, library, library, kernel), the plain version and the
           bound; logs the backward pair's sum against SDPA's backward.
           Then the general kernels (every other dtype and head dim up to
           256), each launched by its record so that bfloat16 at D 128
           runs it too: the grid bfloat16 / float16 / float32 x D 8, 16,
           32, 80, 128, 256, and at D 16 and 256 in each dtype the edges
           (T 1, Tk 1, a ragged T, shift -1, 37, T and -T, segments, GQA
           group 4), the forward and the backward pair in both output
           modes against the plain versions at the same limits, two
           launches bit-identical; timed in turns with SDPA at float32 B 4
           T 512 H 8 / 4 D 64 (the flagship's attention), bfloat16 B 1 T
           8192 H 8 / 4 D 256 and bfloat16 B 8 T 2048 H 4 / 2 D 16, with
           the plain versions' times and the bounds (bytes at the input's
           element size, float32 against the card's float32 rate)
  kernel_perf  the port's kernel_perf tool into a temporary --out: the
           forward at T 2048, 8192 and 16384 (GQA off and 4x), forward plus
           backward end to end and each backward kernel alone at the same
           T, the non-causal ring hop and the Llama-3-8B shape, and the
           general kernels at the kernel phase's three shapes, each in
           turns with SDPA and none faster than its bound; then tune_flash at the Llama-3-8B shape, forward and
           --bwd: every ring-depth variant that fits held against its plain
           version, timed, and ranked
  model    the serving path: the Llama-3-8B-width decoder forward with the
           fused kernel, then 4 requests through the KV-cache serving
           loop; launch counts are zeroed just before and read just after.
           Then checks the logits against the plain-attention forward,
           the prefill's last-position logits against the forward's, and
           the first served token against the forward's argmax (exactly:
           its forward logit must be the maximum; bf16 logits may tie);
           keeps the forward's last logits of the tp_serve phase's prompts
  train    the training path: Llama-3-8B width cut to 4 layers, 5 AdamW
           steps on B 4 x T 2048 after one warm-up; launch counts are
           zeroed just before the 5 steps and read just after, and the loss
           must descend; each step is timed by the host clock and between
           CUDA events (median and spread).  Then fused-vs-plain-attention
           gradients (dense and packed), remat-vs-no-remat loss and
           gradients, and the fused-vs-plain loss along the training
           trajectory (seed weights and after each of the 6 steps) on a
           fresh build, then the allocator trace's entries a step
  ring     ring and zig-zag flash attention over four ranks at Llama-3-8B
           attention width (B 4, T 4 x 2048; then B 1, T 4 x 1024), every
           rank's hop bodies driven in lockstep on the one card (the code a
           distributed run calls; only the rotation indexes a list of
           shards): out, lse and dq/dk/dv against the one-device kernels
           over the whole T (and at B 1 against the plain versions), two
           runs bit-identical, each kernel launched once per rank, hop and
           half-chunk pair (counts zeroed just before, read just after);
           the ring's time against the one-device kernels' by CUDA events,
           and, at B 4, one more forward and backward each under a
           torch.profiler trace: device time of the flash kernels, the other
           kernels, memsets and copies, and the span's idle share
  profile  ``python -m sofa_tpu_torch stat`` over the training workload's
           ``main`` at Llama-3-8B width cut to 4 layers with
           the Python stack sampler on, set by a ``--config`` TOML file;
           checks the device traces and steps (the backward kernels,
           launched from autograd's device thread, inside the steps), the
           memory sampler's readings and peak against the train phase's,
           the allocation-site snapshot, the host frames; then a run
           without the Kineto trace long enough to wrap the allocation
           trace's ring, what its replayed snapshot and the gate's hold,
           and its allocation sites against the traced run's; an eager
           Llama-width run without the trace killed
           mid-run, which must leave a gate snapshot; logs each collector's
           probe; prints the flash kernels'
           roofline rows of the traced Llama-width run
  serve    ``stat`` over the flagship forward with a short serving run and
           over the training workload's ``main`` at its defaults; checks
           that a profiled torch program that never uses the card stays
           CUDA-uninitialized
  resnet   ResNet-50 at its published widths (batch 32, 224 x 224, 1000
           classes, bf16, channels_last): 20 train steps bare, then 20
           under ``sofa_tpu_torch.api.profile()`` with a sofa_step_N range
           each, then 20 bare again, two such pairs each in a fresh
           process; images/s, the overhead (of the medians, with two their
           means), the paired t-test (one degree of freedom), and the
           bare pass after the profiled one against the first (what the
           profiler leaves behind);
           then preprocess and analyze of the last capture (coverage guard:
           CUDA kernels, convolution kernels carrying flops, a roofline no
           row of which runs faster than its bound); one more pair at
           ``--kineto_host_tracer_level 0`` (no aten op recorded): its
           overhead beside the default's median, its kernel rows (> 0)
  window   ``stat`` over ``python -m sofa_tpu_torch.workloads.resnet
           --train --batch 128`` at trace level 0, and once more (level 2)
           with ``--kineto_delay_s`` and
           ``--kineto_duration_s`` set from that run's capture: kernels
           only inside the window, fewer step ranges than the run made,
           every kernel with its launch context
  (every ``stat`` run of ``profile``, ``serve`` and ``window`` writes the
  run manifest: each is held to the port's validate_manifest, every started
  collector must end ``stopped``, ``status`` must exit 0, and Kineto's
  source wall_s and events are printed)
  board    ``report`` with no card visible (CUDA_VISIBLE_DEVICES="") over
           the Llama-width training capture and the last ResNet-50
           capture: report.js's series (the sofa_flash series holding all
           three kernels), the tile pyramid (its deepest tiles hold every
           gputrace row), the hints (the ResNet capture's idle steps);
           ``viz`` in its own process serving every staged page, report.js
           and every CSV a page names (404 where analyze wrote none), a 304
           on revalidation, a deep tile gzipped and plain, nothing outside
           the logdir (the report runs at ``--jobs 4``); ``report --jobs
           1`` over each, whose features.csv and hints.txt must be
           byte-identical to the first report's; the ResNet report's
           concurrency breakdown must give
           performance.csv and five elapsed ratios summing to 1; a
           ``--plugin`` whose pass raises, over a copy of the Llama-width
           capture: ``Complete!!``, the pass ``failed`` in the manifest,
           ``status`` 1 naming it; ``passes`` over the capture, every
           built-in pass with its last run's time; prints the host times
           and sizes
  robust   the supervised, self-reporting record, one line a cell; the
           ``robust`` phase runs cells (2), (6), (3) and (5), ``faults``
           (1) and (7), on the card, and ``cache`` (4), after the board:
           (1) ``stat`` over the Llama-width training at batch 1 with
           procmon killed 5 s in and the Kineto harvest wedged (5 s
           deadline): one
           restart with mpstat rows after the death, kineto ``timed_out``
           at harvest, all three kernels in gputrace, ``analyze`` complete,
           ``status`` as ``render_status`` says; (2) ``stat`` over a
           3-second command with procmon killed at 1 s and no restarts:
           ``died``, ``status`` nonzero, the ``[self]`` hint; (3) a copy
           of the Llama-width capture with its Kineto JSON cut in half:
           ``preprocess`` quarantines it, ``analyze`` completes with the
           ``[self]`` hint, a second ``preprocess`` does not serve it
           warm; (4) over the last ResNet-50 capture where the board phase
           left it (columnar, warm; no card visible), ``analyze`` alone
           over its chunk stores, then ``report`` in csv: wall times, the
           frames' chunks (written, reused) and stage times, the cache's
           format, report.js, features.csv, hints.txt and tiles
           byte-identical to the board's columnar report; (5) the
           durability cell over a copy of the Llama-width capture: the
           resolved format and pyarrow's version, (a) ``report`` in csv
           and columnar, cold and warm, with the four wall times, then
           ``analyze`` alone over the chunk stores, all byte-identical;
           (b) a preprocess SIGKILLed at each of the JAX chaos
           matrix's kill points (a frame CSV write, a tile write, a chunk
           hash), then ``resume``: rc 0, report.js byte-identical to (a)'s,
           ``fsck`` 0, gputrace through ``read_frame`` with its rows and
           all three kernels; (c) a tile removed, a derived CSV's and a
           chunk's byte flipped, the raw capture rewritten and a ``.tmp``
           left: ``fsck`` 1 naming each, ``status`` 1 with its integrity
           line, ``fsck --repair`` 0, the manifest valid; then ``clean``
           keeps the raw files and ``kineto/`` only; (6) ``record
           --epilogue_deadline_s 5`` over a child wedged at exit returns
           within 30 s and warns; (7) ``record --pid`` of an entry-forward
           serving run in its own process, then ``report``.  Cell (1)'s
           procmon is the native sysmon, and its restart runs it again
  cluster  ``record --cluster_hosts localhost,127.0.0.1`` of the
           Llama-width training at batch 1 (two copies on the one card at
           once), then ``report --cluster_hosts`` with no card visible: each
           host's misc.txt rc 0, a healthy manifest and ``status`` 0, its
           native sysmon running under its recorder, all three kernels
           launched as often as in the profile phase's run; the merged
           report.js (meta.cluster_hosts, every host series under
           ``<host>_``, the second host's shifted by the difference of the
           time bases within 1e-6 s) and cluster_summary.csv; both hosts'
           peaks

  mesh     torchrun with NCCL and one rank over the training ``main`` at
           the train phase's shape (--data 1 --seq_par 1; one step after
           the two warm-up steps) under ``stat``: the losses must equal the
           train phase's; logs what the capture
           holds for the gradient all-reduce; then two gloo ranks sharing
           the card at Llama width (--data 2, batch 1 each, one step after
           the two warm-up steps) under ``stat``: two rank traces, device
           ids 0 and 1, one gpumon file per rank (named by its rank),
           gpu_step_skew.csv, equal losses, per-rank flash launches as in a
           one-rank run of as many steps, the merged topology,
           mesh_advice.txt, and comm-report.html rendered by ``report``
           and served by ``viz``; the collectives microbench
           at one rank prints its single-device line
  tp       (a) four gloo ranks sharing the card under ``stat``: the
           training main at Llama width, tensor-parallel 2 x FSDP over data
           2 (--data 2 --model 2 --fsdp, B 2, one step after the warm-up):
           every rank's losses equal and within TP_LOSS_REL of the mesh
           phase's data-parallel pair's, each rank's flash launches as a
           one-rank run's, four rank traces on device ids 0-3, the model
           and data groups apart in gputrace's collectives, comm.csv and
           link_matrix.csv, mesh_advice.txt, comm-report.html
  tp_serve (b) two gloo ranks sharing the card serve the model phase's 4
           requests (prompt 1024, 32 new) at Llama-3-8B width and depth,
           tensor-parallel 2: both ranks' tokens identical, the first token
           the model phase's one-device argmax or within SERVE_TP_LOGIT_TOL
           of its maximum
  tooling  the project's own checks, host only (no card visible, but for
           setup's probe), the cells and their processes side by side, a
           line a cell: (a) ``lint`` over the port's tree
           against sofa_tpu_torch/lint_baseline.json: exit 0, the clean line
           with its totals, ``--json`` at ``--jobs 1`` and ``--jobs 4``
           byte-identical, the checker's seconds; (b) ``artifacts --json``
           validated by the port's manifest_check with full closure, then
           ``report`` over copies of the Llama-width and ResNet-50 captures
           and ``artifacts <copy>`` of each: every file the card's runs
           left is in a registry (zero leaks); (c) ``protocol --json``
           validated, its routes archive/protocol.py's ROUTES; (d)
           ``setup`` on the card's host: the probe line names cuda, 1
           device and the card, the exit code 1 exactly when it printed a
           problem; with ``CUDA_VISIBLE_DEVICES=`` the probe fails and
           setup exits 1
  examples the five examples (sofa_tpu_torch/examples/) side by side,
           each in its own process on the card, their output appended to
           one log:
           matmul_burn, io_churn, serve_tiny by their lines, train_tiny
           under ``stat`` (head dim 16: the three general kernels in its
           gputrace), long_context under ``stat --enable_aisi`` (the same
           width: the three general kernels in gputrace, its 8 steps in
           iterations.csv); meanwhile
           ``edr`` watches the log and fires on train_tiny's "final loss" a
           2 s ``record`` into <base>/edr-train/, whose ``report`` (no card
           visible) must end with Complete!!
  chaos_tier ``python -m sofa_tpu_torch.tools.chaos_tier --smoke`` on the
           host: the tier's five chaos events under fleet_load, its last
           line ``"ok": true``
  ep_pp    (c) the MoE main (vocab 8192, d 256, 8 experts, B 8, T 256) on
           two gloo ranks (--data 1 --expert 2) under ``stat``: losses that
           descend, equal on both ranks, the all-to-all in the capture;
           float32 expert-parallel logits against moe_ffn_dense's (atol
           1e-5, rtol 1e-4); (d) the pipeline at its main's widths over four
           stages in lockstep on the card (gloo has no P2P for CUDA
           tensors), float32: loss and gradients against
           _reference_forward's, remat against no remat; (e)
           dryrun_multigpu over the machine's cards, a torchrun rank each:
           its three lines, and each rank's launch counts: its transformer
           step at head dim 16 on the three general kernels alone
  train_f32 the float32 flagship at full width (entry.ENTRY_CONFIG: vocab
           8192, d_model 512, 4 layers, 8 / 4 heads of 64, B 4 x T 512)
           with flash=None, which the auto rule routes to the general
           kernels: a forward, the gradients and 3 AdamW steps, launch
           counts zeroed just before and read just after (each general
           kernel once a layer and pass, no Hopper kernel), against the
           same from the same seed with flash=False: logits, loss,
           per-leaf gradients and the 3 losses within TRAIN_LOSS_REL /
           TRAIN_GRAD_REL
  verbs    the single-run analysis verbs with no card visible, over the
           captures above, a line a cell: (a) ``analyze --enable_aisi``
           over the last ResNet-50 capture from its step spans (its 20
           sofa_step ranges) and by kernel-name mining (20 +- 2), and (b)
           ``analyze --enable_aisi --enable_hsg`` over the Llama-width
           capture (an iteration per gpusteps row, the flash kernels inside
           them; at most --num_swarms swarms, auto_caption.csv); (c)
           ``diff`` of the Llama-width capture (batch 4) against a cluster
           host's (batch 1): the three flash kernels longer in the base,
           swarm_diff.csv and mem_diff.csv, ``fsck`` 0 over the three
           logdirs, ``viz`` serving diff-report.html and its CSVs; then the
           other host's capture against a byte copy of itself: every delta
           0; (d) ``whatif --apply overlap:*,scale:*=sol`` over ResNet-50:
           calibrated, a speed-of-light table, no step predicted longer than
           measured, meta.whatif valid, whatif.html served, ``fsck`` 0; over
           the Llama width (3 steps): exit 1 uncalibrated, the flash kernels
           among whatif_model.csv's compute classes; (e) ``export --perfetto
           --folded`` over the Llama width: a PDF of 2 pages or more,
           overview.png, a sofa_flash_* slice per gputrace row, written by
           the native writer and byte-identical (decompressed) to the
           Python path's, the folded stacks; ``export --cluster_hosts``:
           both hosts' tracks on one clock (1e-6 s); (f) ``top --once``
           while the profile phase's Llama-width ``stat`` ran (the card's
           name, the sampler's memory, a sample under 5 s old) and over
           the finished capture; (g) no unattributed-kernel hint on the
           level-2 Llama-width capture
  archive  the trace archive and ``regress`` with no card visible over the
           ResNet-50 (``report`` back to columnar first: ``cache`` left it
           in csv) and Llama-width captures, into a fresh root, a line a
           cell: (a) each ingested twice (the second: the same run id, 0
           objects, 0 bytes, one more catalog line), each run doc holding
           the gputrace chunks and the Kineto trace, ``archive show``
           printing the gpu0_ features, ``archive ls`` 2 runs in 4 ingests;
           (b) ``regress`` of the Llama-width run against itself (all
           noise, rc 0), of the ResNet-50 run against it (a verdict the
           port's validate_verdict accepts, rc 1 exactly when regressed),
           ``--rolling 3`` (noise: too short a history; rc 0); (c) ``fsck``
           of the root 0, then an object's byte flipped and 6 bytes written
           into an index chunk's strings: ``fsck`` 1 naming both, ``fsck
           --repair`` 0 (the object restored from its logdir, the index
           rebuilt), ``fsck`` 0, the port's manifest_check accepting the
           index; (d) the JAX chaos
           matrix's kill-mid-archive cell over a copy of the Llama-width
           capture: the ingest SIGKILLed at its 5th stored file, ``resume``
           0, the uninterrupted run id in the catalog, the root's fsck
           clean; prints the store's bytes and the ingest walls
  fleet_push the fleet transport with no card visible over copies of the
           ResNet-50 and Llama-width captures, each ``serve`` and each
           ``agent --once`` a child on loopback, a line a cell: (a) one
           agent delivers both (rc 0, 2 runs in the tenant, each server
           run id its spooled one, meta.agent pushed and meta.serve in each
           manifest, the port's manifest_check 0); (b) again with the
           delivered flags cleared: rc 0, 0 objects and 0 bytes, no catalog
           line; (c) the Llama-width copy, a fresh spool and tenant each,
           under ``service:partial@0.5`` and ``service:conn_reset``: one
           run, fsck clean; (d) the JAX chaos matrix's kill-service-mid-
           upload cell: ``SOFA_SERVE_EXIT_AFTER=4``, the service exits 86,
           the agent 1, the spool fsck-clean, a restarted service takes the
           retry (rc 0, one run, meta.serve); (e) two agents, spools of
           their own, push two copies of the Llama-width capture into one
           tenant at once: rc 0 both, one run, fsck clean; (f) three WAL
           records seeded in a tenant held mid-gc, SIGTERM: exit 0 with
           every WAL drained, the ``serve handled:`` line with a
           422_hash_mismatch and no 500, ``fsck`` of the root 0; prints
           each push's wall, objects, bytes and loopback MB/s
  fleet_tier the fleet tier with no card visible over copies of the
           ResNet-50 and Llama-width captures, each ``serve`` (a pool of 4
           workers, a replica) and each ``agent --once`` a child on
           loopback, a line a cell: (a) the pool (its log names SO_REUSEPORT
           or the dispatcher) under ``--slo``, the port's ``fleet_load`` (4
           agents x 8 pushes over 2 tenants, 2 query pollers; its five
           numbers printed) and both captures: every push acked and
           committed, the run sets the ones offered, ``/v1/tier`` naming 4
           workers and each tenant's ring owner, meta.tier and meta.metrics
           in the manifests; (b) a second pool under
           ``service:worker_die@2,service:slo_breach@2``: worker 2 exits 89
           once and is respawned, no acked push lost, every WAL 0, one
           ``slo_breach`` catalog event, ``slo_verdict.json`` not ok,
           ``status --fleet`` 1; then a WAL append under
           ``service:disk_full@1``: 507, the retry committed; (c)
           ``--rolling-restart`` under load: workers 0-3 handed off in
           order, every push acked and committed, no 500; (d) a replica:
           each tenant's query bytes the primary's with the commit header,
           a write 403, a second pull moving nothing; under
           ``service:replica_stale`` the stale header and ``status
           --fleet``'s staleness line; (e) ``/v1/metrics`` 200 then 304, 401
           without the token, and a served scrape loop stalled by
           ``service:scrape_stall`` past STALE_SCRAPE_S: ``status`` and
           ``status --fleet`` warn; (f) ``fleet analyze`` cold, warm and
           again on a tenant's copy (memoized no-ops, one report),
           ``/v1/smoke/fleet`` 200 then 304, a rotted fleet_state.json:
           ``fsck`` 1 naming it, ``--repair`` 0, the same bytes rebuilt;
           (g) SIGTERM: the pool exits 0, every worker 0, every WAL 0, no 500
           and no traceback, ``fsck`` of the root 0, the merged fleet trace
           joining the Llama-width push's spans across processes

  live     (a) ``record`` of the training ``main`` at Llama-3-8B width cut
           to 2 layers, batch 1 (LIVE_STEPS steps; its Kineto window
           closes while it runs) with ``live --live_interval_s 2`` beside it (no
           card visible) until the job has exited and one more epoch has
           committed; each epoch's ``meta.live`` and ledger are read at
           its journal commit: at least 3 epochs while the job ran, gpumon
           streaming in 2 or more, the chunks parsed over all epochs equal
           to the chunks the ledger committed, chunks_loaded growing, the
           watermark never going back and ending within LIVE_WATERMARK_S of
           the job's last gpumon sample, the epoch in flight when the
           capture landed or the first one after marking the Kineto frames
           dirty, each whole traced step
           of its kernel frame holding 2 launches of each flash kernel,
           and an epoch with gpumon dirty and the Kineto frames clean
           skipping passes clean with fewer tiles rebuilt than kept;
           (b) ``viz`` over the logdir meanwhile: every fetch of report.js
           from epoch 1 on 200, never 503; prints each epoch's wall
           (median, max) and the job's peak
  live_drain (c) over that logdir cleaned back to its raw files (no
           card visible): one epoch with ``gpumon:tail_torn``
           SIGKILLed at its third tile write, ``resume`` (meta.live.epoch
           up by one), ``live --drain`` (active false), its report.js,
           features.csv, hints.txt and _tiles/ byte-identical to a batch
           ``preprocess`` + ``analyze`` after ``clean``; ``status`` prints
           the live line, ``manifest_check --require-healthy`` passes

Every whole frame a check reads comes through the port's ``read_frame``
(``frame``): in columnar mode ``<name>.csv`` is the board's downsampled
copy.

After each timed phase, and after the lanes, the script names any
process left running;
once the phases end (or one fails) it stops every process still under it.
It is its tree's child subreaper, so orphans of a killed recorder or
workload are stopped too.

The last lines are the kernels JSON, the nvidia-smi line, and the result
JSON.  It exits non-zero without a result when no CUDA device is visible.
Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import hashlib
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
# one timing code, one bound, one table of peaks and one set of kernel
# tolerances for the kernel phase and the tools
from sofa_tpu_torch.tools.kernel_perf import (  # noqa: E402
    backward_costs, bound, card_peaks, cuda_ms, forward_cost, in_turns)
from sofa_tpu_torch.tools.tune_flash import (  # noqa: E402
    GRAD_REL, LSE_ATOL, OUT_ATOL, OUT_RTOL, grad_limit)

L2_BYTES = 50 * 2 ** 20         # H100 SXM L2 cache (data sheet: 50 MB)
# Decoder logits after 32 bf16 layers, fused vs plain attention (and the
# serving prefill, whose cache attention is plain, vs the fused forward):
# relative Frobenius error of the logits.  The fused-vs-plain reading on an
# H100 was 1.9e-2.
LOGITS_REL = 3e-2
# Per-leaf gradients of the 4-layer Llama-width loss at B1 T2048, fused vs
# plain attention: relative Frobenius error (worst reading on an H100
# 5.37e-3, the embedding, dense), and the loss's relative difference.  The
# loss check runs after the 6 training steps (reading 2.14e-5 dense); the
# sweep along the trajectory (seed weights and after each step, dense and
# packed) read 1.8e-6 to 5.62e-5 (dense, after step 5) on an H100, so the
# limit holds every reading but sits within 7 % of the largest.
TRAIN_GRAD_REL = 1e-2
TRAIN_LOSS_REL = 6e-5
# The float32 flagship's logits, fused (the general kernels) vs plain
# attention, relative Frobenius error: float32 throughout, so only the
# order of the sums differs (the bf16 LOGITS_REL is 3e-2).
LOGITS_F32_REL = 1e-4
# Remat vs no remat replays the same deterministic kernels and cuBLAS calls
# on the same inputs: the loss and every gradient must be bit-identical (the
# reading on an H100 was 0 for all of them).
REMAT_REL = 0.0
# The ring phase's ranks (the lockstep schedule's shards on the one card).
RING_RANKS = 4
# The general kernels' head-dim caps (csrc/flash_gen.cuh), and the dtype x
# D grid and the timed shapes of the kernel phase's general part:
# (label, dtype name, B, T, H, KVH, D); the first is the flagship's
# attention in float32, whose row the kernels line reports.
GEN_CAPS = (16, 32, 64, 128, 256)
GEN_GRID_DIMS = (8, 16, 32, 80, 128, 256)
GEN_SHAPES = (("f32 flagship B4 T512 H8/4 D64", "float32", 4, 512, 8, 4, 64),
              ("bf16 D256 B1 T8192 H8/4", "bfloat16", 1, 8192, 8, 4, 256),
              ("bf16 D16 B8 T2048 H4/2", "bfloat16", 8, 2048, 4, 2, 16))
# The NCCL world of one against the train phase: the same program on the
# same seed, so the losses are expected to be equal to the bit; the limit
# leaves room only for a reduction that a one-rank collective reorders.
MESH_LOSS_REL = 1e-5
# Llama-3-8B attention at tensor-parallel 2: the heads each rank's flash
# kernels see in the ``tp`` phase's training (B 1 a rank, T 2048).
TP_HEADS = (16, 4)
# The tensor-parallel x FSDP ranks against the two data-parallel gloo
# ranks of the ``mesh`` phase (the same global batch, seed and steps; bf16
# partial sums reduced over the model group in another order): the largest
# relative difference of their three losses.  The reading on an H100 was
# 1.71e-4 (after the step), so the limit leaves a margin of 5.8x.
TP_LOSS_REL = 1e-3
# The sharded serving's first token against the one-device forward of the
# ``model`` phase: its one-device logit at most this far below the maximum
# (two bf16 ulps of a logit in [4, 8); the model group sums bf16
# partials).  The reading on an H100 was 0 for all four requests, one of
# them a tie at the maximum.
SERVE_TP_LOGIT_TOL = 1 / 16
# The expert-parallel MoE against ``moe_ffn_dense`` on the card in float32
# with no token dropped: the JAX test's limits
# (``tests/test_workloads.py:610-637``).
MOE_ATOL, MOE_RTOL = 1e-5, 1e-4
# The lockstep pipeline against ``_reference_forward`` on the card in
# float32 (``tests/test_workloads.py:668-704``): loss, gradients (max
# |err|), remat against no remat.
PIPE_LOSS_TOL, PIPE_GRAD_TOL, PIPE_REMAT_TOL = 1e-4, 1e-5, 1e-6
# The training main's flags for Llama-3-8B's widths (d_model 4096, 32/8
# heads of 128, d_ff 14336, vocab 128256) at T 2048, depth cut to 4 layers:
# the shape of the train phase and of every Llama-width run under the
# profiler (batch apart).
LLAMA_WIDTH = ("--seq 2048 --vocab 128256 --d_model 4096 --n_layers 4 "
               "--n_heads 32 --n_kv_heads 8 --d_ff 14336")
# The job the ``live`` phase tails: the training main at Llama-3-8B width
# cut to 2 layers, batch 1, on an H100.  Its Kineto window opens
# LIVE_KINETO[0] s after torch is imported and closes LIVE_KINETO[1] s
# later, while it runs.  The start-up (import to the first step) is slower
# beside the other lanes than alone: the window opens late enough for both,
# and the steps outlast it.
LIVE_LAYERS, LIVE_STEPS = 2, 260
LIVE_KINETO = (20.0, 2.0)
LIVE_INTERVAL_S = 2.0
# The pools of the epochs and of the drain cell's verbs: the lanes beside
# them hold the host's 8 cores.
LIVE_JOBS = 2
# The least width of the window phase's trace window (s): with the lanes
# beside it, a 4-period window (0.201 s, from the full run's 50.2 ms period)
# once held 122 ms of forward kernels and no whole step on an H100.
WINDOW_MIN_S = 1.0
# The archive phase's kill cell: the ingest of the Llama-width copy dies at
# this stored file (the JAX chaos matrix draws 2..8).
ARCHIVE_KILL_AT = 5
# The last epoch's watermark against the job's last gpumon sample (s).
LIVE_WATERMARK_S = 3.0
# The drain cell's --viz_downsample_to: a pyramid on every large frame.
LIVE_VIZ = 2000


def frame(logdir: str, name: str, columns=None):
    """A whole frame as preprocess wrote it (its chunk store, else its
    parquet or CSV file), through the port's ``read_frame``: in columnar
    mode ``<name>.csv`` is the board's downsampled copy."""
    from sofa_tpu_torch.trace import read_frame

    df = read_frame(os.path.join(logdir, name), columns)
    if df is None:
        raise AssertionError(f"{logdir} has no {name} frame")
    return df


# the lanes log from threads of their own: a line (or a block) at a time,
# and to the stdout this process started with, which a cell's in-process
# capture of a verb's output (contextlib.redirect_stdout) does not take
_LOG_LOCK = threading.Lock()
_STDOUT = sys.stdout


def log(msg: str) -> None:
    with _LOG_LOCK:
        print(msg, file=_STDOUT, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def descendants(root: int):
    """The pids of ``root``'s live descendants, from each process's parent
    in /proc/<pid>/stat."""
    children = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                # the parent follows the state, after the name's ")"
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(name))
    out, todo = [], [root]
    while todo:
        for pid in children.get(todo.pop(), ()):
            out.append(pid)
            todo.append(pid)
    return out


def adopt_orphans() -> bool:
    """Makes this process the child subreaper of its tree (Linux prctl
    PR_SET_CHILD_SUBREAPER): a descendant whose parent exits is re-parented
    here, not to init, so that ``stop_descendants`` still finds it."""
    import ctypes

    try:
        return ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def live_descendants(root: int):
    """{pid: "comm: command line"} of ``root``'s descendants that are not
    zombies."""
    out = {}
    for pid in descendants(root):
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    continue
            with open(f"/proc/{pid}/comm") as f:
                comm = f.read().strip()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, IndexError):
            continue
        out[pid] = f"{comm}: {argv.strip()[:200]}"
    return out


def reap_children() -> None:
    """Collects the exit status of every child of this process that has
    ended (re-parented orphans among them)."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def wait_descendants(timeout: float):
    """Waits up to ``timeout`` s for this process's descendants to exit, and
    returns those still running."""
    deadline = time.monotonic() + timeout
    while True:
        left = live_descendants(os.getpid())
        if not left or time.monotonic() >= deadline:
            return left
        time.sleep(0.1)


def stop_mp_helpers(timeout: float = 10.0) -> None:
    """Stops the multiprocessing forkserver and resource tracker that the
    in-process parser pool of the ``resnet`` phase started here, as the
    standard library's own tests stop them (closing each one's "alive" pipe
    and waiting), forkserver first: it holds the tracker's pipe too."""
    from multiprocessing import forkserver, resource_tracker

    def run():
        for helper in (getattr(forkserver, "_forkserver", None),
                       getattr(resource_tracker, "_resource_tracker", None)):
            stop = getattr(helper, "_stop", None)
            if stop is not None:
                try:
                    stop()
                except (OSError, ChildProcessError):
                    pass

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)


def stop_descendants() -> dict:
    """Ends every process still running under this one once the phases are
    over (or one failed): this process's own multiprocessing helpers the
    standard way, the rest with 5 s to exit, then SIGTERM, 5 s more,
    SIGKILL; then reaps them.  Returns what was still running after the
    first 5 s."""
    stop_mp_helpers()
    reap_children()
    left = wait_descendants(5.0)
    for sig, grace in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 5.0)):
        alive = live_descendants(os.getpid())
        for pid in alive:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        if alive:
            reap_children()
            wait_descendants(grace)
    reap_children()
    return left


def free_port() -> int:
    """A TCP port on localhost that nothing listens on (torchrun's
    rendezvous)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_losses(out: str, workload: str = "transformer") -> dict:
    """{rank: [loss, ...]} from a training main's ``<workload>: rank R
    losses (warm-up first) ...`` lines."""
    import re

    found = {}
    # anchored at neither end: two ranks' prints may interleave (a print
    # writes its text and its newline apart)
    for m in re.finditer(workload + r": rank (\d+) losses \(warm-up "
                         r"first\) ([-+0-9.eE ]+)", out):
        found[int(m.group(1))] = [float(x) for x in m.group(2).split()]
    return found


def _leaf_names(tree, prefix=()):
    """Key paths of a nested param dict, in param_leaves order."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaf_names(val, prefix + (key,))
        else:
            yield prefix + (key,)


@contextlib.contextmanager
def viz_served(logdir: str, port: int, label: str):
    """``viz`` over ``logdir`` in its own process (no card visible), from
    ``port`` up: yields (its port, ``get(path, headers)`` -> (status,
    headers, body)); the server is stopped on exit and must be gone."""
    import http.client

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "sofa_tpu_torch", "viz", "--logdir",
         logdir, "--viz_port", str(port)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        served = None
        t0 = time.perf_counter()
        while served is None and time.perf_counter() - t0 < 60:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.search(r"serving .* at http://[^:]+:(\d+)/", line)
            if m:
                served = int(m.group(1))
        if served is None:
            raise AssertionError(f"viz did not start ({label})")

        def get(path, headers=None):
            conn = http.client.HTTPConnection("127.0.0.1", served,
                                              timeout=30)
            try:
                conn.request("GET", path, headers=headers or {})
                resp = conn.getresponse()
                return resp.status, dict(resp.getheaders()), resp.read()
            finally:
                conn.close()

        yield served, get
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    if proc.poll() is None:
        raise AssertionError("the viz process is still running")


class Smoke:
    def __init__(self):
        import torch

        self.torch = torch
        self.dev = torch.device("cuda")
        self.smi = ""
        self.kernel_rows = {}
        # (flop/s, bytes/s): analysis/sol.py's peaks of this card
        self.peaks = card_peaks(torch.cuda.get_device_name(0))
        if self.peaks is None:
            raise AssertionError(f"{torch.cuda.get_device_name(0)!r} is not "
                                 f"in analysis/sol.py's PEAKS: no bounds")
        from sofa_tpu_torch.frames import columnar_available

        # where pyarrow is missing, columnar falls back to csv
        self.columnar = columnar_available()
        self.jobs1 = {}     # board label -> (wall, outputs) of --jobs 1
        # what the lanes have done (their phases, and "llama"), and whether
        # a lane has failed
        self.done = {name: threading.Event()
                     for name in sum(LANES, ()) + ("llama",)}
        self.failed = threading.Event()

    # -- helpers --------------------------------------------------------------
    def gen(self, seed: int):
        g = self.torch.Generator(device=self.dev)
        g.manual_seed(seed)
        return g

    def flash_inputs(self, b, t, h, kvh, d, seed, tk=None, dtype=None):
        """q [B,T,H,D], k and v [B,Tk,KVH,D] from ``seed``, in ``dtype``
        (bfloat16 by default)."""
        torch = self.torch
        g = self.gen(seed)
        tk = t if tk is None else tk
        q = torch.randn(b, t, h, d, generator=g, device=self.dev)
        k = torch.randn(b, tk, kvh, d, generator=g, device=self.dev)
        v = torch.randn(b, tk, kvh, d, generator=g, device=self.dev)
        return [x.to(dtype or torch.bfloat16) for x in (q, k, v)]

    # -- phases ---------------------------------------------------------------
    def device(self):
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.tools.tune_flash import all_variant_builds

        self.smi = nvidia_smi()
        log(f"device: {self.torch.cuda.get_device_name(0)} | nvidia-smi: "
            f"{self.smi} | torch {self.torch.__version__} cuda "
            f"{self.torch.version.cuda}")
        t0 = time.perf_counter()
        # the kernel_perf phase's tune_flash variants beside the defaults
        variants = all_variant_builds()
        reports = kernels.build_all(kernels.KERNELS, variants)
        log(f"device: built {', '.join(reports)} and {len(variants)} "
            f"ring-depth variants (" + ", ".join(
                f"{k.name} {n}={v}" for k, ((n, v),) in variants)
            + f") in {time.perf_counter() - t0:.2f} s (one nvcc each, in "
            f"parallel)")
        for kern in kernels.KERNELS:
            for line in reports[kern.name].splitlines():
                if any(w in line for w in ("registers", "spill", "smem",
                                           "wgmma", "arning")):
                    log(f"  {kern.name}: {line.strip()}")
            dims = (64, 128) if kern.family == "hopper" else GEN_CAPS
            log(f"  {kern.name}: dynamic shared memory a block, D "
                + " / ".join(map(str, dims)) + " (from the library): "
                + " / ".join(str(kernels.smem_bytes(kern, d)) for d in dims)
                + " bytes")
        self.native_helpers()

    def native_helpers(self):
        """Builds the native helpers from the checkout's sources with the
        machine's C++ compiler: the /proc sampler daemon and the Perfetto
        export's writer (linked with zlib).  Their Python fallbacks, meant
        for hosts without a compiler, must not be what runs here."""
        from sofa_tpu_torch.collectors import native_build

        cxx = native_build.find_compiler()
        if cxx is None:
            raise AssertionError("no C++ compiler: the native helpers "
                                 "cannot be built")
        for tool in ("sysmon", "perfetto_write"):
            path = native_build.binary_path(tool)
            if os.path.exists(path):
                os.unlink(path)        # time the build itself
            got = native_build.ensure_built(tool)
            built = native_build.BUILDS.get(tool)
            if got != path or built is None or not os.access(got, os.X_OK):
                raise AssertionError(f"native {tool} was not built: the "
                                     "Python fallback would run")
            log(f"device: native {tool} built by {built['compiler']} in "
                f"{built['seconds']:.2f} s -> {os.path.relpath(got, REPO)}")

    def kernel(self):
        torch = self.torch
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.workloads.flash_cuda import (
            _flash_forward, _flash_forward_plain)

        def compare(label, q, k, v, shift, seg=None):
            out, lse = _flash_forward(q, k, v, shift, segment_ids=seg)
            seg32 = None if seg is None else seg.to(torch.int32)
            ref_out, ref_lse = _flash_forward_plain(q, k, v, shift, seg32,
                                                    seg32)
            torch.cuda.synchronize()
            err = (out.float() - ref_out.float()).abs()
            lim = OUT_ATOL + OUT_RTOL * ref_out.float().abs()
            lse_err = (lse - ref_lse).abs().max().item()
            ok = bool((err <= lim).all()) and lse_err <= LSE_ATOL \
                and bool(torch.isfinite(out.float()).all())
            log(f"kernel: {label:<34} out max|err| {err.max().item():.3e} "
                f"lse max|err| {lse_err:.3e} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"sofa_flash_fwd disagrees with its "
                                     f"plain version at {label}")
            return err.max().item(), out, lse

        # the main path's shapes: Llama-3-8B attention, the entry forward
        q, k, v = self.flash_inputs(4, 2048, 32, 8, 128, seed=1)
        llama_err, out, lse = compare("llama3_8b B4 T2048 H32/8 D128", q, k,
                                      v, 0)
        again = _flash_forward(q, k, v, 0)
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        log(f"kernel: determinism: a second launch on the same inputs gives "
            f"bit-identical out and lse: {same}")
        if not same:
            raise AssertionError("sofa_flash_fwd is not deterministic")
        del out, lse, again
        entry = self.flash_inputs(4, 512, 8, 4, 64, seed=2)
        compare("entry B4 T512 H8/4 D64", *entry, 0)
        # a rank's heads in the tensor-parallel training (the tp phase)
        compare("tp 2 llama3_8b B1 T2048 H16/4 D128",
                *self.flash_inputs(1, 2048, *TP_HEADS, 128, seed=9), 0)
        # mask edges: full (shift >= T), nothing visible (shift <= -T)
        compare("full shift=T B2 T256 H8/2 D128",
                *self.flash_inputs(2, 256, 8, 2, 128, seed=3), 256)
        _, out, lse = compare("masked shift=-T B2 T256 H8/2 D64",
                              *self.flash_inputs(2, 256, 8, 2, 64, seed=4),
                              -256)
        if out.abs().max().item() != 0 or lse.max().item() > -1e29:
            raise AssertionError("fully masked rows must give out 0 and "
                                 "lse <= -1e29")
        # packed segments (contiguous runs) and a ragged T
        b, t = 2, 512
        seg = (torch.rand(b, t, generator=self.gen(5), device=self.dev)
               < 0.02).to(torch.int64).cumsum(dim=1)
        compare("segmented B2 T512 H8/4 D64",
                *self.flash_inputs(b, t, 8, 4, 64, seed=6), 0, seg)
        compare("ragged T=200 B2 H8/2 D128",
                *self.flash_inputs(2, 200, 8, 2, 128, seed=7), 0)
        compare("ragged cache Tk=333 T=77 shift=256 D128",
                *self.flash_inputs(2, 77, 8, 2, 128, seed=8, tk=333), 256)
        # the edges of the 128-row / 128-key tiling: one row, one row past
        # a tile, one key, shifts that cut a tile, segment boundaries inside
        # and across tiles, D 64 with a ragged T
        compare("T=1 B2 H8/2 D128",
                *self.flash_inputs(2, 1, 8, 2, 128, seed=31), 0)
        compare("T=129 B2 H8/2 D128",
                *self.flash_inputs(2, 129, 8, 2, 128, seed=32), 0)
        compare("Tk=1 T=64 B2 H8/2 D128",
                *self.flash_inputs(2, 64, 8, 2, 128, seed=33, tk=1), 0)
        compare("shift=-1 B2 T300 H8/2 D128",
                *self.flash_inputs(2, 300, 8, 2, 128, seed=34), -1)
        compare("shift=37 B2 T300 H8/2 D128",
                *self.flash_inputs(2, 300, 8, 2, 128, seed=35), 37)
        t = 400
        seg = torch.tensor([0] * 100 + [1] * 150 + [2] * 20 + [3] * 130,
                           device=self.dev).expand(2, t)
        compare("segments at 100/250/270 B2 T400 D128",
                *self.flash_inputs(2, t, 8, 2, 128, seed=36), 0, seg)
        compare("D64 T=200 B2 H8/4",
                *self.flash_inputs(2, 200, 8, 4, 64, seed=37), 0)

        # times at the Llama shape, in turns with SDPA (a yardstick only)
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def timed(label, q, k, v, iters=20):
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            (k1, k2), (l1, l2) = in_turns(
                lambda: _flash_forward(q, k, v, 0),
                lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                iters)
            (bq, tq, hq, dq), kvh = q.shape, k.shape[2]
            flops, nbytes = forward_cost(bq, tq, tq, hq, kvh, dq, 0)
            bound_ms, bound_by = bound(flops, nbytes, self.peaks)
            ms, library_ms = (k1 + k2) / 2, (l1 + l2) / 2
            log(f"kernel: {label} in turns: kernel_ms {k1:.4f} / {k2:.4f}, "
                f"library_ms (SDPA) {l1:.4f} / {l2:.4f}; kernel/SDPA "
                f"{ms / library_ms:.3f}; bound_ms {bound_ms:.4f} "
                f"({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% "
                f"of bound) | {self.smi}")
            return ms, library_ms, bound_ms, bound_by

        timed("entry B4 T512 H8/4 D64", *entry)
        ms, library_ms, bound_ms, bound_by = timed("llama3_8b shape", q, k,
                                                   v)
        plain_ms = cuda_ms(lambda: _flash_forward_plain(q, k, v, 0), iters=3,
                           warmup=1)
        log(f"kernel: llama3_8b shape plain_ms {plain_ms:.4f}")
        kern = kernels.FLASH_FWD
        self.kernel_rows[kern.name] = {
            "name": kern.name, "route": "cuda",
            "source": kern.source_rel, "replaces": kern.replaces,
            "launches": None, "max_abs_err": llama_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}
        self.kernel_backward()
        self.kernel_general()

    def kernel_perf(self):
        """The kernel_perf sweep into a temporary --out (every row printed,
        none faster than its bound), then tune_flash at the Llama-3-8B
        attention shape, forward and --bwd, over the ring-depth variants
        that fit (the device phase built them), each held against its
        plain version."""
        import tempfile

        from sofa_tpu_torch.tools import kernel_perf, tune_flash

        with tempfile.TemporaryDirectory(prefix="chip_smoke_kperf_") as tmp:
            t0 = time.perf_counter()
            out, rows_json = (os.path.join(tmp, n)
                              for n in ("KERNEL_PERF.md", "rows.json"))
            rc = kernel_perf.main(["--out", out, "--json", rows_json])
            with open(rows_json) as f:
                rows = json.load(f)["rows"]
            log(f"kernel_perf: rc {rc}, {len(rows)} rows in "
                f"{time.perf_counter() - t0:.1f} s | {self.smi}")
            if rc != 0:
                raise AssertionError(f"kernel_perf exited {rc}")
            have = {(r["kernel"], r["T"], r["gqa"]) for r in rows}
            want = {("flash fwd", t, gqa) for t in (2048, 8192, 16384)
                    for gqa in (False, True)} | {
                (label, t, False) for t in (2048, 8192, 16384)
                for label in ("flash fwd+bwd", *kernel_perf.MODES[2:])} | {
                ("ring hop (non-causal)", 4096, False)} | {
                ("llama3_8b " + label, 2048, True)
                for label in kernel_perf.MODES} | {
                (f"{label} {mode}", t, kvh != h)
                for label, _, t, h, kvh, _, _ in kernel_perf.GENERAL_SHAPES
                for mode in kernel_perf.MODES}
            slow = [r for r in rows if r["bound_ms"] is None
                    or r["ms"] < r["bound_ms"]]
            if want - have or slow:
                raise AssertionError(f"kernel_perf rows missing "
                                     f"{sorted(want - have)}, without a "
                                     f"bound or faster than it: {slow}")
            for bwd in (False, True):
                t1 = time.perf_counter()
                res = os.path.join(tmp, f"tune_{int(bwd)}.json")
                rc = tune_flash.main(
                    ["--seq", "2048", "--heads", "32", "--kv_heads", "8",
                     "--dim", "128", "--json", res] + ["--bwd"] * bwd,
                    log=log)
                with open(res) as f:
                    doc = json.load(f)
                held = [r for r in doc["results"] if "agrees" in r]
                log(f"tune_flash{' --bwd' * bwd}: rc {rc}, {len(held)} "
                    f"variants held against the plain version, "
                    f"{len(doc['failures'])} failures in "
                    f"{time.perf_counter() - t1:.1f} s | {self.smi}")
                kerns = {k.name for k in tune_flash.mode_kernels(bwd)}
                if rc != 0 or {r["kernel"] for r in held} != kerns:
                    raise AssertionError(f"tune_flash{' --bwd' * bwd} "
                                         f"failed: {doc['failures']}")
        self.torch.cuda.empty_cache()

    def kernel_backward(self):
        torch = self.torch
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.workloads.flash_cuda import (
            _flash_bwd_dq_cuda, _flash_bwd_dq_plain, _flash_bwd_kv_cuda,
            _flash_bwd_kv_plain, _flash_forward)

        # the wrappers as the autograd path calls them: static_causal only
        # labels the profiler's cost range (shift <= 0 is causal)
        def bwd_kv(*args):
            return _flash_bwd_kv_cuda(*args, static_causal=args[6] <= 0)

        def bwd_dq(*args):
            return _flash_bwd_dq_cuda(*args, static_causal=args[6] <= 0)

        def inputs(b, t, h, kvh, d, seed, shift=0, tk=None, seg=None,
                   hop=False):
            """hop: delta from another output, as in a ring hop, where it
            comes from the whole sequence's output.  A row that sees one
            key has p = 1 and dp = delta up to rounding when delta is its
            own (out = v), so its dq and dk are rounding noise; with a hop's
            delta they are not."""
            q, k, v = self.flash_inputs(b, t, h, kvh, d, seed, tk)
            g = self.flash_inputs(b, t, h, kvh, d, seed + 100)[0]
            out, lse = _flash_forward(q, k, v, shift, shift <= 0, seg)
            if hop:
                out = self.flash_inputs(b, t, h, kvh, d, seed + 200)[0]
            seg32 = None if seg is None else seg.to(torch.int32).contiguous()
            delta = (g.float() * out.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            return (q, k, v, g, lse, delta, shift, seg32, seg32)

        def compare(label, args, f32=False):
            """Each gradient against its plain version within grad_limit:
            in the float32 output mode (GRAD_REL of max|ref|, the kernels'
            arithmetic), then, unless f32, in the bfloat16 one the main path
            runs (one ulp of max|ref| more, the store's rounding).  The last
            mode's (errs, gradients)."""
            for gd in (torch.float32,) + (() if f32 else (None,)):
                got = (*bwd_kv(*args, gd), bwd_dq(*args, gd))
                ref = (*_flash_bwd_kv_plain(*args, gd),
                       _flash_bwd_dq_plain(*args, gd))
                torch.cuda.synchronize()
                errs, rels, ok = {}, {}, True
                for name, a, r in zip(("dk", "dv", "dq"), got, ref):
                    ok = ok and a.dtype == (gd or torch.bfloat16)
                    a, r = a.float(), r.float()
                    err = (a - r).abs().max().item()
                    scale = r.abs().max().item()
                    rels[name] = err / scale if scale else (
                        0.0 if err == 0 else float("inf"))
                    errs[name] = err
                    ok = ok and bool(torch.isfinite(a).all()) \
                        and err <= grad_limit(scale, gd is None)
                mode = "f32" if gd else "bf16"
                log(f"kernel: bwd {label:<34} {mode:<4} max|err|/max|ref| "
                    + " ".join(f"{n} {rels[n]:.3e}" for n in rels)
                    + " (max|err| " + " ".join(
                        f"{n} {errs[n]:.3e}" for n in errs)
                    + f") -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"backward kernels disagree with "
                                         f"their plain versions at {label} "
                                         f"({mode})")
            return errs, got

        def deterministic(label, args):
            """Two launches of each backward kernel on the same inputs must
            agree bit for bit (remat replays the backward)."""
            first = (*bwd_kv(*args), bwd_dq(*args))
            second = (*bwd_kv(*args), bwd_dq(*args))
            same = {n: torch.equal(a, b) for n, a, b in
                    zip(("dk", "dv", "dq"), first, second)}
            log(f"kernel: bwd determinism {label}: a second launch of each "
                f"kernel gives bit-identical " + " ".join(
                    f"{n} {s}" for n, s in same.items()))
            if not all(same.values()):
                raise AssertionError(f"the backward kernels are not "
                                     f"deterministic at {label}")

        llama = inputs(4, 2048, 32, 8, 128, seed=11)
        llama_errs, _ = compare("llama3_8b B4 T2048 H32/8 D128", llama)
        deterministic("llama3_8b B4 T2048 H32/8 D128", llama)
        compare("entry B8 T512 H8/4 D64", inputs(8, 512, 8, 4, 64, seed=12))
        compare("tp 2 llama3_8b B1 T2048 H16/4 D128",
                inputs(1, 2048, *TP_HEADS, 128, seed=20))
        compare("full shift=T B2 T256 H8/2 D128",
                inputs(2, 256, 8, 2, 128, seed=13, shift=256))
        _, masked = compare("masked shift=-T B2 T256 H8/2 D64",
                            inputs(2, 256, 8, 2, 64, seed=14, shift=-256))
        if any(x.float().abs().max().item() != 0 for x in masked):
            raise AssertionError("fully masked rows must give exactly zero "
                                 "gradients")
        b, t = 2, 512
        seg = (torch.rand(b, t, generator=self.gen(15), device=self.dev)
               < 0.02).to(torch.int64).cumsum(dim=1)
        segmented = inputs(b, t, 8, 4, 64, seed=16, seg=seg)
        compare("segmented B2 T512 H8/4 D64", segmented)
        deterministic("segmented B2 T512 H8/4 D64", segmented)
        del segmented
        compare("ragged T=200 B2 H8/2 D128",
                inputs(2, 200, 8, 2, 128, seed=17))
        compare("ring hop T256 Tk512 shift=256 D128",
                inputs(2, 256, 8, 2, 128, seed=18, shift=256, tk=512))
        compare("grad_dtype=f32 B2 T256 H8/2 D128",
                inputs(2, 256, 8, 2, 128, seed=19), f32=True)
        # the edges of the backward tiling (dK/dV: 128-key blocks of two
        # 64-key warpgroups over 64-query tiles; dQ: 128-row blocks of two
        # 64-row warpgroups over 64-key tiles): one row, one row past a
        # tile, a ragged T at both head dims, one key, shifts that cut a
        # tile, GQA groups of 1 and 8, segment boundaries off the tile edges
        compare("T=1 ring-hop delta B2 H8/2 D128",
                inputs(2, 1, 8, 2, 128, seed=41, hop=True))
        compare("T=129 B2 H8/2 D128", inputs(2, 129, 8, 2, 128, seed=42))
        compare("T=129 B2 H8/4 D64", inputs(2, 129, 8, 4, 64, seed=43))
        compare("T=200 B2 H8/4 D64", inputs(2, 200, 8, 4, 64, seed=44))
        compare("Tk=1 T=64 ring-hop delta B2 H8/2 D128",
                inputs(2, 64, 8, 2, 128, seed=45, tk=1, hop=True))
        compare("shift=-1 B2 T300 H8/2 D128",
                inputs(2, 300, 8, 2, 128, seed=46, shift=-1))
        compare("shift=37 B2 T300 H8/2 D128",
                inputs(2, 300, 8, 2, 128, seed=47, shift=37))
        compare("GQA group 1 B2 T300 H8/8 D128",
                inputs(2, 300, 8, 8, 128, seed=48))
        compare("GQA group 8 B2 T300 H16/2 D64",
                inputs(2, 300, 16, 2, 64, seed=49))
        t = 400
        seg = torch.tensor([0] * 100 + [1] * 150 + [2] * 20 + [3] * 130,
                           device=self.dev).expand(2, t)
        compare("segments at 100/250/270 B2 T400 D128",
                inputs(2, t, 8, 2, 128, seed=50, seg=seg))

        # times at the Llama training shape; SDPA's backward is a yardstick
        q, k, v, g = llama[:4]
        bq, tq, hq, dq = q.shape
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        gt = g.transpose(1, 2).contiguous()

        def library():
            return torch.autograd.grad(o, (qt, kt, vt), gt, retain_graph=True)

        costs = backward_costs(bq, tq, tq, hq, k.shape[2], dq, 0)
        pair_ms, pair_bound, sdpa_ms = 0.0, 0.0, []
        for kern, fn, plain, errs in (
                (kernels.FLASH_BWD_KV, bwd_kv, _flash_bwd_kv_plain,
                 max(llama_errs["dk"], llama_errs["dv"])),
                (kernels.FLASH_BWD_DQ, bwd_dq, _flash_bwd_dq_plain,
                 llama_errs["dq"])):
            (k1, k2), (l1, l2) = in_turns(lambda: fn(*llama), library)
            ms, library_ms = (k1 + k2) / 2, (l1 + l2) / 2
            plain_ms = cuda_ms(lambda: plain(*llama), iters=3, warmup=1)
            flops, nbytes = costs[kern.name]
            bound_ms, bound_by = bound(flops, nbytes, self.peaks)
            log(f"kernel: {kern.name} llama3_8b shape in turns: kernel_ms "
                f"{k1:.4f} / {k2:.4f}, library_ms (SDPA backward, dq+dk+dv) "
                f"{l1:.4f} / {l2:.4f}; plain_ms {plain_ms:.4f} bound_ms "
                f"{bound_ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s, "
                f"{100 * bound_ms / ms:.1f}% of bound) | {self.smi}")
            self.kernel_rows[kern.name] = {
                "name": kern.name, "route": "cuda",
                "source": kern.source_rel, "replaces": kern.replaces,
                "launches": None, "max_abs_err": errs, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}
            pair_ms += ms
            pair_bound += bound_ms
            sdpa_ms += [l1, l2]
        sdpa_mean = sum(sdpa_ms) / len(sdpa_ms)
        log(f"kernel: backward pair (sofa_flash_bwd_kv + sofa_flash_bwd_dq) "
            f"llama3_8b shape {pair_ms:.4f} ms against SDPA's backward "
            f"{sdpa_mean:.4f} ms (mean of {len(sdpa_ms)} readings): ratio "
            f"{pair_ms / sdpa_mean:.3f}; {100 * pair_bound / pair_ms:.1f}% of "
            f"the pair's bound {pair_bound:.4f} ms | {self.smi}")
        del llama, qt, kt, vt, o
        torch.cuda.empty_cache()

    def kernel_general(self):
        """The general kernels against their plain versions over the dtype
        x D grid and the edges, each launched by its record (bfloat16 at D
        128 runs them too), the forward and the backward pair in both
        output modes; two launches bit-identical; then each timed in turns
        with SDPA at the GEN_SHAPES, with the plain version and the
        bound."""
        torch = self.torch
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.workloads import flash_cuda as fc

        dtypes = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                  "float32": torch.float32}
        worst = {}          # (kernel, dtype) -> worst max|err| / max|ref|
        t0 = time.perf_counter()

        def inputs(dt, b, t, h, kvh, d, seed, shift=0, tk=None, seg=None,
                   hop=False):
            q, k, v = self.flash_inputs(b, t, h, kvh, d, seed, tk, dt)
            g = self.flash_inputs(b, t, h, kvh, d, seed + 100, dtype=dt)[0]
            seg32 = None if seg is None else seg.to(torch.int32).contiguous()
            return q, k, v, g, shift, seg32, hop

        def launch_all(q, k, v, g, shift, seg32, hop, gd_modes):
            """The three general kernels on one case: (out, lse), and per
            output mode (dk, dv, dq), with the backward's inputs."""
            causal = shift <= 0
            out, lse = fc._flash_forward_cuda(
                q, k, v, shift, seg32, seg32, static_causal=causal,
                kern=kernels.GEN_FWD)
            other = self.flash_inputs(*q.shape[:3], k.shape[2], q.shape[3],
                                      7, dtype=q.dtype)[0] if hop else out
            delta = (g.float() * other.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            args = (q, k, v, g, lse, delta, shift, seg32, seg32)
            grads = {gd: (*fc._flash_bwd_kv_cuda(*args, gd,
                                                 static_causal=causal,
                                                 kern=kernels.GEN_BWD_KV),
                          fc._flash_bwd_dq_cuda(*args, gd,
                                                static_causal=causal,
                                                kern=kernels.GEN_BWD_DQ))
                     for gd in gd_modes}
            return (out, lse), grads, args

        def check(label, case):
            q, k, v, g, shift, seg32, hop = case
            dt = q.dtype
            (out, lse), grads, args = launch_all(*case,
                                                 (torch.float32, None))
            ref_out, ref_lse = fc._flash_forward_plain(q, k, v, shift, seg32,
                                                       seg32)
            torch.cuda.synchronize()
            err = (out.float() - ref_out.float()).abs()
            lse_err = (lse - ref_lse).abs().max().item()
            ok = out.dtype == dt and bool(torch.isfinite(out.float()).all()) \
                and bool((err <= OUT_ATOL + OUT_RTOL
                          * ref_out.float().abs()).all()) \
                and lse_err <= LSE_ATOL
            if shift <= -q.shape[1]:
                ok = ok and out.abs().max().item() == 0 \
                    and lse.max().item() <= -1e29
            name = str(dt).split(".")[-1]
            key = (kernels.GEN_FWD.name, name)
            worst[key] = max(worst.get(key, 0.0), err.max().item())
            rels, scales = [], []
            for gd, got in grads.items():
                ref = (*fc._flash_bwd_kv_plain(*args, gd),
                       fc._flash_bwd_dq_plain(*args, gd))
                for kern, a, r in zip((kernels.GEN_BWD_KV, kernels.GEN_BWD_KV,
                                       kernels.GEN_BWD_DQ), got, ref):
                    ok = ok and a.dtype == (gd or dt) \
                        and bool(torch.isfinite(a.float()).all())
                    scale = r.float().abs().max().item()
                    e = (a.float() - r.float()).abs().max().item()
                    ok = ok and e <= grad_limit(
                        scale, gd is None and dt == torch.bfloat16)
                    rel = e / scale if scale else (0.0 if e == 0
                                                   else float("inf"))
                    rels.append(rel)
                    scales.append(scale)
                    key = (kern.name, name)
                    worst[key] = max(worst.get(key, 0.0), rel)
            log(f"kernel: gen {label:<40} out max|err| "
                f"{err.max().item():.3e} lse {lse_err:.3e}; dk dv dq "
                f"max|err|/max|ref| f32 " + " ".join(
                    f"{r:.2e}" for r in rels[:3]) + " / own " + " ".join(
                    f"{r:.2e}" for r in rels[3:])
                + " (max|ref| " + " ".join(f"{x:.2e}" for x in scales[:3])
                + f") -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the general kernels disagree with "
                                     f"their plain versions at {label}")

        n_cases = 0
        for name, dt in dtypes.items():
            for i, d in enumerate(GEN_GRID_DIMS):
                check(f"{name} D{d} B2 T200 H8/2",
                      inputs(dt, 2, 200, 8, 2, d, seed=300 + 10 * i))
                n_cases += 1
            for d in (16, 256):
                seg = torch.tensor([0] * 70 + [1] * 80 + [2] * 10 + [3] * 140,
                                   device=self.dev).expand(2, 300)
                edges = (
                    ("T=1 ring-hop delta", dict(b=2, t=1, h=8, kvh=2,
                                                hop=True)),
                    ("Tk=1 T=64 ring-hop delta", dict(b=2, t=64, h=8, kvh=2,
                                                      tk=1, hop=True)),
                    ("ragged T=129", dict(b=2, t=129, h=8, kvh=2)),
                    ("shift=-1 T=150", dict(b=1, t=150, h=4, kvh=2,
                                            shift=-1)),
                    ("shift=37 T=150", dict(b=1, t=150, h=4, kvh=2,
                                            shift=37)),
                    ("full shift=T T=150", dict(b=1, t=150, h=4, kvh=2,
                                                shift=150)),
                    ("masked shift=-T T=150", dict(b=1, t=150, h=4, kvh=2,
                                                   shift=-150)),
                    ("segments at 70/150/160 T=300", dict(b=2, t=300, h=4,
                                                          kvh=2, seg=seg)),
                    ("GQA group 4 H16/4 T=150", dict(b=1, t=150, h=16,
                                                     kvh=4)),
                )
                for j, (label, kw) in enumerate(edges):
                    check(f"{name} D{d} {label}",
                          inputs(dt, d=d, seed=400 + 10 * j + d, **kw))
                    n_cases += 1
        # two launches on the same inputs: bit-identical (no atomics)
        for dt, d, seg in ((torch.float32, 80, None),
                           (torch.bfloat16, 16, True)):
            s_ids = (torch.arange(300, device=self.dev) // 70).expand(2, 300) \
                if seg else None
            case = inputs(dt, 2, 300, 8, 2, d, seed=500 + d, seg=s_ids)
            first = launch_all(*case, (torch.float32, None))
            second = launch_all(*case, (torch.float32, None))
            same = all(torch.equal(a, b) for a, b in zip(first[0],
                                                         second[0])) and all(
                torch.equal(a, b) for gd in first[1]
                for a, b in zip(first[1][gd], second[1][gd]))
            log(f"kernel: gen determinism {dt} D{d}"
                f"{' segmented' if seg else ''}: a second launch of each "
                f"general kernel gives bit-identical outputs: {same}")
            if not same:
                raise AssertionError("the general kernels are not "
                                     "deterministic")
        log(f"kernel: gen {n_cases} cases held in "
            f"{time.perf_counter() - t0:.1f} s; worst max|err| (forward) and max|err|/max|ref| (backward, "
            f"both modes) by kernel and dtype: " + "; ".join(
                f"{k} {n} {v:.3e}" for (k, n), v in sorted(worst.items())))
        self.kernel_general_times()

    def kernel_general_times(self):
        """Each general kernel at the GEN_SHAPES, in turns with SDPA at the
        same shape (its forward; its whole backward for each backward
        kernel), with the plain version's time and the bound (bytes at the
        input's element size, operations at its type's peak rate).  The
        first shape's row goes into the kernels line."""
        torch = self.torch
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.workloads import flash_cuda as fc

        sdpa = torch.nn.functional.scaled_dot_product_attention
        for i, (label, dtype, b, t, h, kvh, d) in enumerate(GEN_SHAPES):
            dt = getattr(torch, dtype)
            peaks = card_peaks(torch.cuda.get_device_name(0), dtype)
            q, k, v = self.flash_inputs(b, t, h, kvh, d, 600 + i, dtype=dt)
            g = self.flash_inputs(b, t, h, kvh, d, 700 + i, dtype=dt)[0]
            out, lse = fc._flash_forward(q, k, v, 0, True)
            delta = (g.float() * out.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            args = (q, k, v, g, lse, delta, 0)
            if fc.route(dt, d) != tuple(kernels.GENERAL):
                raise AssertionError(f"{label} does not route to the "
                                     f"general kernels")
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                          for x in (q, k, v))
            o = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
            gt = g.transpose(1, 2).contiguous()
            itemsize = q.element_size()
            flops, nbytes = forward_cost(b, t, t, h, kvh, d, 0, itemsize)
            costs = {kernels.GEN_FWD.name: (flops, nbytes)}
            for kern, (f, n) in zip(
                    (kernels.GEN_BWD_KV, kernels.GEN_BWD_DQ),
                    backward_costs(b, t, t, h, kvh, d, 0, itemsize).values()):
                costs[kern.name] = (f, n)
            iters = 5 if t * d > 1 << 20 else 20
            for kern, fn, lib_fn, plain in (
                    (kernels.GEN_FWD,
                     lambda: fc._flash_forward(q, k, v, 0, True),
                     lambda: sdpa(qt, kt, vt, is_causal=True,
                                  enable_gqa=True),
                     lambda: fc._flash_forward_plain(q, k, v, 0)),
                    (kernels.GEN_BWD_KV,
                     lambda: fc._flash_bwd_kv_cuda(*args,
                                                   static_causal=True),
                     lambda: torch.autograd.grad(o, (qt, kt, vt), gt,
                                                 retain_graph=True),
                     lambda: fc._flash_bwd_kv_plain(*args)),
                    (kernels.GEN_BWD_DQ,
                     lambda: fc._flash_bwd_dq_cuda(*args,
                                                   static_causal=True),
                     lambda: torch.autograd.grad(o, (qt, kt, vt), gt,
                                                 retain_graph=True),
                     lambda: fc._flash_bwd_dq_plain(*args))):
                (k1, k2), (l1, l2) = in_turns(fn, lib_fn, iters)
                ms, library_ms = (k1 + k2) / 2, (l1 + l2) / 2
                plain_ms = cuda_ms(plain, iters=3, warmup=1)
                bound_ms, bound_by = bound(*costs[kern.name], peaks)
                what = "forward" if kern is kernels.GEN_FWD \
                    else "backward, dq+dk+dv"
                log(f"kernel: {kern.name} {label} in turns: kernel_ms "
                    f"{k1:.4f} / {k2:.4f}, library_ms (SDPA {what}) "
                    f"{l1:.4f} / {l2:.4f}; kernel/SDPA {ms / library_ms:.3f}; "
                    f"plain_ms {plain_ms:.4f}; bound_ms {bound_ms:.4f} "
                    f"({bound_by}, {dtype} peak "
                    f"{peaks[0] / 1e12:.0f} TFLOP/s; "
                    f"{costs[kern.name][0] / ms / 1e9:.2f} TFLOP/s, "
                    f"{100 * bound_ms / ms:.2f}% of bound) | {self.smi}")
                if ms < bound_ms:
                    raise AssertionError(f"{kern.name} at {label} runs "
                                         f"faster than its bound")
                reading = {"ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "library_ms": library_ms}
                if i == 0:
                    if kern is kernels.GEN_FWD:
                        ref = fc._flash_forward_plain(q, k, v, 0)[0]
                        got = fn()[0]
                    elif kern is kernels.GEN_BWD_KV:
                        ref, got = plain(), fn()
                    else:
                        ref, got = (plain(),), (fn(),)
                    err = max((a.float() - r.float()).abs().max().item()
                              for a, r in zip(
                                  got if isinstance(got, tuple) else (got,),
                                  ref if isinstance(ref, tuple) else (ref,)))
                    self.kernel_rows[kern.name] = {
                        "name": kern.name, "route": "cuda",
                        "source": kern.source_rel,
                        "replaces": kern.replaces, "launches": None,
                        "max_abs_err": err, **reading, "shape": label,
                        "other_shapes": {}}
                else:
                    self.kernel_rows[kern.name]["other_shapes"][label] = \
                        reading
            del q, k, v, g, out, lse, delta, args, qt, kt, vt, o, gt
            torch.cuda.empty_cache()

    def train_f32(self):
        """The float32 flagship at full width with flash=None: the auto
        rule takes the general kernels.  A forward, the gradients and 3
        AdamW steps (counts zeroed just before, read just after: each
        general kernel once a layer and pass, no Hopper kernel), then the
        same from the same seed with flash=False: logits, the loss, each
        gradient and the 3 losses within LOGITS_F32_REL / TRAIN_LOSS_REL /
        TRAIN_GRAD_REL.  The lanes beside it launch nothing in this
        process, so the counts are its own."""
        torch = self.torch
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.entry import ENTRY_BATCH, ENTRY_CONFIG, ENTRY_SEQ
        from sofa_tpu_torch.workloads.common import fence
        from sofa_tpu_torch.workloads.transformer import (
            build, forward, loss_fn, param_leaves, use_flash)

        cfg = dataclasses.replace(ENTRY_CONFIG, dtype=torch.float32,
                                  flash=None)
        steps = 3
        if not use_flash(cfg, ENTRY_SEQ, self.dev):
            raise AssertionError("the auto rule keeps the float32 flagship "
                                 "off the kernels")

        def run(c):
            params, opt, step, tokens = build(c, ENTRY_BATCH, ENTRY_SEQ,
                                              seed=0, device=self.dev)
            leaves = list(param_leaves(params))
            fence(tokens)
            t0 = time.perf_counter()
            logits = forward(params, tokens, c)
            loss = loss_fn(params, tokens, c)
            grads = torch.autograd.grad(loss, leaves)
            losses = []
            for _ in range(steps):
                params, opt, step_loss = step(params, opt, tokens)
                losses.append(step_loss)
            fence(step_loss)
            return (logits, loss.item(), grads, [x.item() for x in losses],
                    time.perf_counter() - t0)

        # --- the main path: counts zeroed just before, read just after ---
        kernels.reset_counts()
        fused = run(cfg)
        counts = kernels.counts()
        # -------------------------------------------------------------------
        plain = run(dataclasses.replace(cfg, flash=False))
        for kern in kernels.GENERAL:
            self.kernel_rows[kern.name]["launches"] = counts[kern.name]
        passes = 2 + steps                  # forward, gradients, steps
        want = {kernels.GEN_FWD.name: cfg.n_layers * passes,
                kernels.GEN_BWD_KV.name: cfg.n_layers * (passes - 1),
                kernels.GEN_BWD_DQ.name: cfg.n_layers * (passes - 1)}
        logits_rel = ((fused[0] - plain[0]).norm() / plain[0].norm()).item()
        loss_rel = abs(fused[1] - plain[1]) / abs(plain[1])
        grad_rels = [((a - b).norm() / b.norm()).item()
                     for a, b in zip(fused[2], plain[2])]
        step_rels = [abs(a - b) / abs(b) for a, b in zip(fused[3], plain[3])]
        log(f"train_f32: float32 flagship (vocab {cfg.vocab}, d_model "
            f"{cfg.d_model}, {cfg.n_layers} layers, {cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads of {cfg.d_head}, B{ENTRY_BATCH} "
            f"T{ENTRY_SEQ}), seed 0: launches {json.dumps(counts)} (want "
            f"{json.dumps(want)}); fused {fused[4]:.2f} s, plain "
            f"{plain[4]:.2f} s for the forward, the gradients and {steps} "
            f"steps; logits rel {logits_rel:.3e} (limit {LOGITS_F32_REL}); "
            f"loss {fused[1]:.6f} vs {plain[1]:.6f} (rel {loss_rel:.3e}); "
            f"grad rel max {max(grad_rels):.3e} (limit {TRAIN_GRAD_REL}); "
            f"step losses {fused[3]} vs {plain[3]} (rel max "
            f"{max(step_rels):.3e}, limit {TRAIN_LOSS_REL}) | {self.smi}")
        if any(counts[name] != n for name, n in want.items()) or any(
                counts[k.name] for k in kernels.HOPPER):
            raise AssertionError(f"the float32 flagship did not run the "
                                 f"general kernels alone: {counts}")
        if not all(map(math.isfinite, fused[3])) \
                or not fused[3][-1] < fused[3][0]:
            raise AssertionError(f"the float32 loss did not descend: "
                                 f"{fused[3]}")
        if logits_rel > LOGITS_F32_REL or loss_rel > TRAIN_LOSS_REL \
                or max(grad_rels) > TRAIN_GRAD_REL \
                or max(step_rels) > TRAIN_LOSS_REL:
            raise AssertionError("the fused and plain float32 runs disagree")
        del fused, plain
        torch.cuda.empty_cache()

    def model(self):
        torch = self.torch
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.workloads import inference
        from sofa_tpu_torch.workloads.common import fence
        from sofa_tpu_torch.workloads.transformer import (
            TransformerConfig, forward, init_params)

        cfg = TransformerConfig.llama3_8b()
        batch, seq, prompt_len, new = 4, 2048, 1024, 32
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=self.dev)
        fence(params["lm_head"])
        log(f"model: llama3_8b, {cfg.n_layers} layers (no depth cut), "
            f"random weights seed 0, init {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        tokens = torch.randint(0, cfg.vocab, (batch, seq),
                               generator=self.gen(0), device=self.dev)
        prompts = tokens[:, :prompt_len].contiguous()
        scfg = dataclasses.replace(cfg, max_seq=prompt_len + new)
        inference.serve(params, prompts, scfg, new)   # warm the libraries
        forward(params, tokens, cfg)
        fence(tokens)

        # --- the main path: counts zeroed just before, read just after ---
        kernels.reset_counts()
        t0 = time.perf_counter()
        logits = forward(params, tokens, cfg)
        fence(logits)
        fwd_s = time.perf_counter() - t0
        served, pre_tps, dec_tps = inference.serve(params, prompts, scfg, new)
        fence(served)
        counts = kernels.counts()
        # -------------------------------------------------------------------
        self.kernel_rows["sofa_flash_fwd"]["launches"] = \
            counts["sofa_flash_fwd"]
        log(f"model: serving path launches {json.dumps(counts)}")
        if counts["sofa_flash_fwd"] < cfg.n_layers or any(
                counts[k.name] for k in kernels.GENERAL):
            raise AssertionError("the forward did not go through "
                                 "sofa_flash_fwd once per layer, and only")

        t0 = time.perf_counter()
        plain = forward(params, tokens, dataclasses.replace(cfg, flash=False))
        fence(plain)
        plain_s = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits")
        rel = ((logits - plain).norm() / plain.norm()).item()
        agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
        log(f"model: forward B{batch} T{seq} fused {1e3 * fwd_s:.1f} ms, "
            f"plain attention {1e3 * plain_s:.1f} ms; logits rel err "
            f"{rel:.3e} (limit {LOGITS_REL}), argmax agreement "
            f"{100 * agree:.2f}%")
        if rel > LOGITS_REL:
            raise AssertionError("fused and plain logits disagree")
        del plain

        # the serving prefill's last-position logits and first served token
        # vs the fused forward's at the last prompt token
        last = forward(params, prompts, cfg)[:, -1]
        cache = inference.init_cache(scfg, batch, self.dev)
        pre_last = inference.prefill(params, prompts, cache, scfg)[0][:, -1]
        del cache
        pre_rel = ((pre_last - last).norm() / last.norm()).item()
        # The logits come out of a bf16 matmul, one ulp apart near their
        # maximum (1/32 at 4.0), so two tokens can tie exactly; every tied
        # token is then an argmax of the forward, and greedy serving may
        # pick any of them.  The served token's forward logit must equal the
        # forward's maximum exactly.
        got = served[:, 0]
        best = last.max(-1).values
        exact = int((last.gather(-1, got[:, None])[:, 0] == best).sum())
        ties = int(((last == best[:, None]).sum(-1) > 1).sum())
        for name, x in (("forward", last), ("prefill", pre_last)):
            val, idx = x.topk(2, dim=-1)
            log(f"model: {name} last-position top-2 (token, logit) per "
                "request: " + "; ".join(
                    f"({i0}, {v0:.4f}) ({i1}, {v1:.4f})"
                    for (i0, i1), (v0, v1) in zip(idx.tolist(),
                                                  val.tolist())))
        log(f"model: prefill last-position logits rel err {pre_rel:.3e} "
            f"(limit {LOGITS_REL}); served {tuple(served.shape)} tokens, "
            f"first token is an argmax of the forward's logits for "
            f"{exact}/{batch} requests ({ties} with a tie at the maximum)")
        if not pre_rel <= LOGITS_REL:
            raise AssertionError("prefill and forward logits disagree")
        if exact != batch:
            raise AssertionError("served first token is not the forward's "
                                 "argmax")
        log(f"model: serving 4 requests (prompt {prompt_len}, {new} new): "
            f"prefill {pre_tps:,.1f} tokens/s, decode {dec_tps:,.1f} "
            f"tokens/s | {self.smi}")
        # the prompts of the sharded serving (tp_serve), drawn as
        # inference.main draws them, and their last-position logits here
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(0)
        main_prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                                     generator=gen, device=self.dev)
        self.serve_ref = forward(params, main_prompts, cfg)[:, -1].cpu()
        del params, logits
        torch.cuda.empty_cache()

    def train(self):
        torch = self.torch
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.workloads.common import fence
        from sofa_tpu_torch.workloads.transformer import (
            TransformerConfig, build, loss_fn, param_leaves)

        full = TransformerConfig.llama3_8b()
        batch, seq, steps = 4, 2048, 5
        cfg = dataclasses.replace(full, n_layers=4, max_seq=seq)
        t0 = time.perf_counter()
        params, opt, step, tokens = build(cfg, batch, seq, seed=0,
                                          device=self.dev)
        leaves = list(param_leaves(params))
        n_params = sum(p.numel() for p in leaves)
        fence(params["lm_head"])
        log(f"train: llama3_8b width, depth cut {full.n_layers} -> "
            f"{cfg.n_layers} layers ({n_params / 1e9:.3f}e9 params: bf16 "
            f"params, grads and AdamW moments at 8 bytes each do not fit "
            f"80 GB at full depth), random weights seed 0, B{batch} "
            f"T{seq}, init {time.perf_counter() - t0:.1f} s")
        losses = []
        params, opt, loss = step(params, opt, tokens)      # warm-up
        losses.append(loss)
        fence(loss)
        # the warm-up step allocates the AdamW moments only in its update,
        # after its backward: its peak holds no moments
        warm_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        # each step is also timed on the device, between CUDA events
        # recorded on the stream before and after it
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(steps)]
        # --- the main path: counts zeroed just before, read just after ---
        kernels.reset_counts()
        t0 = time.perf_counter()
        for start, end in events:
            start.record()
            params, opt, loss = step(params, opt, tokens)
            end.record()
            losses.append(loss)
        fence(loss)
        dt = time.perf_counter() - t0
        counts = kernels.counts()
        # -------------------------------------------------------------------
        torch.cuda.synchronize()
        dev_ms = [start.elapsed_time(end) for start, end in events]
        by_ms = sorted(dev_ms)
        log(f"train: step by CUDA events: median {by_ms[steps // 2]:.3f} ms, "
            f"min {by_ms[0]:.3f}, max {by_ms[-1]:.3f} (spread "
            f"{by_ms[-1] - by_ms[0]:.3f} ms); steps " + " ".join(
                f"{x:.3f}" for x in dev_ms) + f" | {self.smi}")
        peak = torch.cuda.max_memory_allocated()
        self.train_peak, self.train_params = peak, n_params
        losses = [x.item() for x in losses]
        self.train_losses = losses          # the mesh phase's reference
        for name in ("sofa_flash_bwd_kv", "sofa_flash_bwd_dq"):
            self.kernel_rows[name]["launches"] = counts[name]
        log(f"train: main path launches over {steps} steps "
            f"{json.dumps(counts)}")
        log(f"train: step by host clock {1e3 * dt / steps:.1f} ms, "
            f"{batch * seq * steps / dt:,.0f} tokens/s, peak "
            f"{peak / 2**30:.2f} GiB allocated ({peak} bytes; the warm-up "
            f"step's {warm_peak / 2**30:.2f} GiB), losses (warm-up first) "
            + " ".join(f"{x:.4f}" for x in losses) + f" | {self.smi}")
        want = cfg.n_layers * steps
        if any(counts[k.name] != want for k in kernels.HOPPER) or any(
                counts[k.name] for k in kernels.GENERAL):
            raise AssertionError(f"each Hopper kernel must launch {want} "
                                 f"times in {steps} steps, and no general "
                                 f"one; got {counts}")
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not descend: {losses}")

        def value_and_grad(c, toks, seg=None):
            loss = loss_fn(params, toks, c, seg)
            return loss.item(), torch.autograd.grad(loss, leaves)

        def rel_errs(got, ref):
            return [((a.float() - b.float()).norm() / b.float().norm()).item()
                    for a, b in zip(got, ref)]

        # fused vs plain attention at B1 (the plain scores stay small)
        names = [".".join(k) for k in _leaf_names(params)]
        one = tokens[:1]
        seg = (torch.rand(1, seq, generator=self.gen(21), device=self.dev)
               < 1 / 300).to(torch.int64).cumsum(dim=1)
        checked = {}
        for label, s in (("dense", None), ("packed", seg)):
            lf, gf = value_and_grad(cfg, one, s)
            lp, gp = value_and_grad(dataclasses.replace(cfg, flash=False),
                                    one, s)
            rels = rel_errs(gf, gp)
            worst = max(range(len(rels)), key=rels.__getitem__)
            loss_rel = abs(lf - lp) / abs(lp)
            checked[label] = loss_rel
            log(f"train: fused vs plain grads B1 T{seq} {label}: loss "
                f"{lf:.5f} vs {lp:.5f} (rel {loss_rel:.3e}, limit "
                f"{TRAIN_LOSS_REL}); grad rel err max {rels[worst]:.3e} at "
                f"{names[worst]} (limit {TRAIN_GRAD_REL}); "
                + " ".join(f"{n} {r:.2e}" for n, r in zip(names, rels)))
            if loss_rel > TRAIN_LOSS_REL or rels[worst] > TRAIN_GRAD_REL:
                raise AssertionError(f"fused and plain gradients disagree "
                                     f"({label})")
            del gf, gp

        # one remat step against the same step without remat
        torch.cuda.reset_peak_memory_stats()
        base_loss, base = value_and_grad(cfg, tokens)
        base_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        r_loss, r_grads = value_and_grad(
            dataclasses.replace(cfg, remat=True), tokens)
        torch.cuda.synchronize()
        r_counts = kernels.counts()
        r_peak = torch.cuda.max_memory_allocated()
        rels = rel_errs(r_grads, base)
        loss_rel = abs(r_loss - base_loss) / abs(base_loss)
        log(f"train: remat B{batch} T{seq}: loss {r_loss:.6f} vs "
            f"{base_loss:.6f} (rel {loss_rel:.3e}), grad rel err max "
            f"{max(rels):.3e} (limit {REMAT_REL}); launches "
            f"{json.dumps(r_counts)}; peak {r_peak / 2**30:.2f} GiB vs "
            f"{base_peak / 2**30:.2f} GiB without remat")
        if r_counts["sofa_flash_fwd"] != 2 * cfg.n_layers or any(
                r_counts[n] != cfg.n_layers
                for n in ("sofa_flash_bwd_kv", "sofa_flash_bwd_dq")):
            raise AssertionError("remat must replay each layer's forward "
                                 "kernel once in the backward")
        if loss_rel > REMAT_REL or max(rels) > REMAT_REL:
            raise AssertionError("remat changed the loss or the gradients")
        del params, opt, step, leaves, base, r_grads
        torch.cuda.empty_cache()
        self.loss_sweep(cfg, batch, seq, 1 + steps, seg, checked)

    def loss_sweep(self, cfg, batch, seq, n_steps, seg, checked):
        """The fused-vs-plain loss reading (relative difference, B1, dense
        and packed) at the seed weights and after each of ``n_steps``
        steps of the same training run, rebuilt from the same seed: the
        basis of TRAIN_LOSS_REL, which the check above applies after the
        last step.  Logged, not limited."""
        torch = self.torch
        from sofa_tpu_torch.workloads.transformer import build, loss_fn

        params, opt, step, tokens = build(cfg, batch, seq, seed=0,
                                          device=self.dev)
        plain = dataclasses.replace(cfg, flash=False)
        readings = {"dense": [], "packed": []}
        for k in range(n_steps + 1):
            if k:
                params, opt, _ = step(params, opt, tokens)
            with torch.no_grad():
                for label, s in (("dense", None), ("packed", seg)):
                    lf = loss_fn(params, tokens[:1], cfg, s).item()
                    lp = loss_fn(params, tokens[:1], plain, s).item()
                    readings[label].append(abs(lf - lp) / abs(lp))
        for label, rels in readings.items():
            log(f"train: loss sweep {label}: fused vs plain relative loss "
                f"difference at the seed weights and after each of "
                f"{n_steps} steps: " + " ".join(f"{r:.3e}" for r in rels)
                + f"; largest {max(rels):.3e} (limit {TRAIN_LOSS_REL}); "
                f"after step {n_steps} it equals the check's reading: "
                f"{rels[-1] == checked[label]}")
        self.trace_rate(step, params, opt, tokens)
        del params, opt, step
        torch.cuda.empty_cache()

    def trace_rate(self, step, params, opt, tokens):
        """Entries a training step adds to the allocator's alloc/free trace,
        recorded as the profiler's memprof records it: how many steps the
        ring of MAX_ENTRIES holds before it wraps."""
        torch = self.torch
        from sofa_tpu_torch.collectors.gpumon import HISTORY, MAX_ENTRIES

        torch.cuda.memory._record_memory_history(**HISTORY,
                                                 max_entries=MAX_ENTRIES)
        counts = []
        try:
            for _ in range(2):
                params, opt, loss = step(params, opt, tokens)
                torch.cuda.synchronize()
                trace = torch.cuda.memory._snapshot()["device_traces"][0]
                # each _snapshot() call adds one "snapshot" entry
                counts.append(sum(e["action"] != "snapshot" for e in trace))
        finally:
            torch.cuda.memory._record_memory_history(enabled=None)
        self.trace_per_step = max(counts[0], counts[1] - counts[0])
        log(f"train: allocator trace {counts[0]} and {counts[1] - counts[0]}"
            f" entries in two steps: the {MAX_ENTRIES}-entry ring wraps "
            f"after {MAX_ENTRIES / self.trace_per_step:.1f} steps")

    def run_stat(self, label: str, cmd: str, flags=(), healthy=True,
                 probe=None):
        """``python -m sofa_tpu_torch stat [flags]`` over ``cmd``; checks that
        it completes and, for a ``healthy`` run, its manifest
        (``check_manifest``); ``probe(logdir)`` runs on a thread of its own
        while the run goes on.  Returns (features, logdir, output)."""
        import pandas as pd

        logdir = os.path.join(REPO, "build", f"chip_smoke_profile_{label}")
        shutil.rmtree(logdir, ignore_errors=True)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "sofa_tpu_torch", "stat", "--logdir",
             logdir, *flags, cmd], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        prober = None
        if probe is not None:
            prober = threading.Thread(target=probe, args=(logdir,),
                                      daemon=True)
            prober.start()
        try:
            out, _ = proc.communicate(timeout=600)
            if prober is not None:
                prober.join(timeout=60)
        except subprocess.TimeoutExpired:
            proc.terminate()            # record takes the profiled tree down
            try:
                proc.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
            raise
        log("\n".join(f"  | {line}" for line in out.splitlines()
                      if not line.startswith(("USDT", "STAGE:"))))
        log(f"profile[{label}]: stat rc {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        if proc.returncode != 0 or "Complete!!" not in out:
            raise AssertionError(f"sofa_tpu_torch stat failed ({label})")
        if healthy:
            self.check_manifest(label, logdir)
        feats = pd.read_csv(os.path.join(logdir, "features.csv"))
        return dict(zip(feats["name"], feats["value"])), logdir, out

    def check_manifest(self, label, logdir, healthy=True, cli=False):
        """The run manifest: valid by the port's validate_manifest (with
        every frame_index.json of the chunk store); for a
        ``healthy`` run every started collector ``stopped`` and ``status``
        exiting 0 (``render_status``'s code, the ``status`` verb's own;
        with ``cli`` the verb run in its own process).  Prints Kineto's
        source wall_s and events.  Returns (manifest, status's exit
        code)."""
        from sofa_tpu_torch import telemetry
        from sofa_tpu_torch.tools.manifest_check import (check_frame_indexes,
                                                         validate_manifest)

        doc = telemetry.load_manifest(logdir)
        probs = validate_manifest(doc) if doc is not None else ["missing"]
        probs += check_frame_indexes(logdir)
        if probs:
            raise AssertionError(f"run_manifest.json invalid ({label}): "
                                 f"{probs}")
        ended = {n: e["status"] for n, e in doc.get("collectors", {}).items()
                 if "start_seq" in e}
        if cli:
            r, _ = self.board_cli("status", "--logdir", logdir)
            rc, report = r.returncode, r.stdout
        else:
            lines, rc = telemetry.render_status(doc, logdir)
            report = "\n".join(lines)
        src = doc.get("sources", {}).get("kineto", {})
        log(f"manifest[{label}]: valid; started collectors {ended}; status "
            f"rc {rc}; kineto source {src.get('status')} "
            f"{src.get('events')} events in {src.get('wall_s')} s "
            f"(cache {src.get('cache')})")
        if healthy and (any(st != "stopped" for st in ended.values())
                        or rc != 0):
            raise AssertionError(f"the manifest is not healthy ({label}): "
                                 f"{ended}, status rc {rc}: "
                                 f"{report[-2000:]}")
        return doc, rc

    def stat(self, label: str, cmd: str, steps: int, names, flags=(),
             healthy=True, probe=None):
        """``run_stat``, then checks that gputrace has rows of each kernel
        in ``names`` and gpusteps ``steps`` rows; logs where the ranged
        device time goes.  Returns (features, logdir, output, kernels)."""
        feats, logdir, out = self.run_stat(label, cmd, flags, healthy,
                                           probe)
        gpu = frame(logdir, "gputrace")
        kern = gpu[gpu["copyKind"] == 0]
        kname = kern["name"].astype(str)
        found = {n: int(kname.str.contains(n).sum()) for n in names}
        steps_df = frame(logdir, "gpusteps")
        log(f"profile[{label}]: gputrace {len(gpu)} rows, {len(kern)} "
            f"kernels, {json.dumps(found)}; gpusteps {len(steps_df)} rows; "
            + ", ".join(f"{k} {feats.get(k)}" for k in (
                "gpu_busy_pct", "gpu_step_busy_pct", "serving_prefill_time",
                "serving_decode_time", "serving_decode_calls",
                "serving_ttft") if k in feats))
        # where the device time goes inside the annotated ranges (steps,
        # prefill, decode), outside start-up and weight init
        module = kern["module"].fillna("").astype(str)
        ranged = kern[module != ""]
        per_range = ranged.groupby(module[module != ""].str.replace(
            r"_\d+$", "_N", regex=True))["duration"].agg(["sum", "count"])
        for name, row in per_range.iterrows():
            log(f"profile[{label}]: range {name:<12} "
                f"{row['sum'] * 1e3:9.3f} ms device time in "
                f"{int(row['count'])} kernels")
        top = ranged.groupby("name")["duration"].agg(["sum", "count"]) \
            .sort_values("sum", ascending=False)
        for name, row in top.head(8).iterrows():
            log(f"profile[{label}]: top kernel {row['sum'] * 1e3:9.3f} ms "
                f"x{int(row['count']):5d}  {str(name)[:90]}")
        if kern.empty or not all(found.values()):
            raise AssertionError(f"gputrace lacks rows of {found} ({label})")
        if len(steps_df) != steps:
            raise AssertionError(f"gpusteps has {len(steps_df)} rows, "
                                 f"expected {steps} ({label})")
        if not feats.get("gpu_busy_pct", 0) > 0:
            raise AssertionError(f"gpu_busy_pct is not positive ({label})")
        return feats, logdir, out, kern

    def profile(self):
        """The Llama-width runs at batch 4 (up to 43 GB of the card each):
        ``stat`` over the training ``main`` under the whole swarm, then over
        a run that wraps the allocation trace's ring, then an eager run
        killed mid-run.  Marks "llama" done as soon as the first capture is
        checked (the host lane reads it)."""
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.config import SofaConfig
        from sofa_tpu_torch.record import build_collectors

        # which collectors this machine can run (perf, strace, vmstat,
        # tcpdump, blktrace may be missing; only /proc must be there)
        cfg = SofaConfig(enable_py_stacks=True, enable_strace=True,
                         enable_tcpdump=True, blkdev="/dev/null")
        probes = {c.name: c.probe() or "ok" for c in build_collectors(cfg)}
        log(f"profile: collector probes {json.dumps(probes)}")
        if probes["procmon"] != "ok":
            raise AssertionError("no /proc: procmon cannot sample")
        self.profile_llama(3, [k.name for k in kernels.HOPPER])
        self.done["llama"].set()
        self.profile_wrapped_ring()
        self.profile_killed()

    def serve(self):
        """The profile runs that take at most 21 GB of the card, beside the
        Llama-width ones: ``stat`` over the flagship forward with a short
        serving run and over the training ``main`` at the JAX package's
        defaults; a torch program that never uses the card."""
        from sofa_tpu_torch import kernels

        steps = 3
        names = [k.name for k in kernels.HOPPER]
        serve = (f"{sys.executable} -m sofa_tpu_torch.entry --steps {steps} "
                 "--serve_requests 4 --serve_layers 2 --prompt 128 "
                 "--new_tokens 8")
        feats, _, out, _ = self.stat("serve", serve, steps,
                                     ["sofa_flash_fwd"])
        for key in ("serving_prefill_time", "serving_decode_time"):
            if key not in feats:
                raise AssertionError(f"features.csv lacks {key}")
        log("profile: serving (small kernels): " + " | ".join(
            ln for ln in out.splitlines()
            if ln.startswith(("entry:", "serve:"))) + f" | {self.smi}")
        # the training workload at the JAX package's main defaults (batch 8,
        # seq 512, d 512, 4 layers, 8/4 heads: D 64)
        self.stat("train", f"{sys.executable} -m "
                  f"sofa_tpu_torch.workloads.transformer --steps {steps}",
                  steps, names)
        self.profile_untouched_card()

    def profile_llama(self, steps, names):
        """The training ``main`` at Llama-3-8B width cut to 4 layers (the
        train phase's shape) under the whole swarm: the memory sampler, the
        allocation-site snapshot and the host collectors."""
        import pandas as pd

        cmd = (f"{sys.executable} -m sofa_tpu_torch.workloads.transformer "
               f"--steps {steps} --batch 4 {LLAMA_WIDTH}")
        # the whole swarm's settings from a config file (the flags of the
        # other runs): the pystacks check below shows the file took effect
        cfg_file = os.path.join(REPO, "build", "chip_smoke_llama.toml")
        with open(cfg_file, "w") as f:
            f.write("enable_py_stacks = true\n")
        feats, logdir, out, kern = self.stat("llama", cmd, steps, names,
                                             ("--config", cfg_file),
                                             probe=self.top_probe)
        # launches of each kernel in one run of 2 warm-up and ``steps``
        # steps (the cluster's hosts and the two gloo ranks are held to it)
        self.llama_launches = {n: int(kern["name"].astype(str).str.contains(
            n).sum()) for n in names}
        self.llama_passes = 2 + steps
        rate = [("on", [ln for ln in out.splitlines()
                        if ln.startswith("transformer:")])]
        self.kernels_in_steps(kern, steps)
        total = self.torch.cuda.get_device_properties(0).total_memory
        # the sampler: heartbeats and device-0 rows at the card's size
        with open(os.path.join(logdir, "gpumon.txt")) as f:
            rows = [[int(x) for x in ln.split()] for ln in f if ln.strip()]
        beats = sum(r[1] == -1 for r in rows)
        dev0 = [r for r in rows if r[1] == 0]
        log(f"profile[llama]: gpumon.txt {beats} heartbeats, {len(dev0)} "
            f"device-0 rows, bytes_limit {sorted({r[3] for r in dev0})} "
            f"(total_memory {total}), in use up to "
            f"{max((r[2] for r in dev0), default=0)} bytes")
        if not beats or not dev0 or any(r[3] != total for r in dev0):
            raise AssertionError("gpumon.txt lacks heartbeats or device-0 "
                                 "rows at total_memory")
        # the peak against the train phase's in-process reading
        state_gb = 8 * self.train_params / 1e9
        peak_gb = feats.get("gpu0_hbm_peak_gb", 0.0)
        ratio = peak_gb * 1e9 / self.train_peak
        log(f"profile[llama]: gpu0_hbm_peak_gb {peak_gb:.4f} "
            f"({peak_gb * 1e9 / 2**30:.2f} GiB) against the train phase's "
            f"max_memory_allocated {self.train_peak / 1e9:.4f} GB: ratio "
            f"{ratio:.4f} (limit 1 +- 0.05); params, grads and AdamW "
            f"moments {state_gb:.2f} GB; total {total / 1e9:.2f} GB | "
            f"{self.smi}")
        if not state_gb <= peak_gb < total / 1e9:
            raise AssertionError("gpu0_hbm_peak_gb is outside [8 bytes a "
                                 "param, total_memory)")
        if abs(ratio - 1) > 0.05:
            raise AssertionError("the sampled peak and the train phase's "
                                 "peak differ by more than 5 %")
        # the allocation-site snapshot
        with open(os.path.join(logdir, "memprof.pb.gz.meta.json")) as f:
            meta = json.load(f)
        sites = pd.read_csv(os.path.join(logdir, "gpu_memprof.csv"))
        held = feats.get("memprof_held_gb", 0.0)
        top = str(sites["site"].iloc[0])
        when = ("replayed from the trace at exit" if meta.get("replayed")
                else "at a sampler tick")
        log(f"profile[llama]: memprof {meta['trigger']} snapshot ({when})"
            f" at {meta['total_bytes']} bytes in use took "
            f"{meta['snapshot_s']:.4f} s; memprof_held_gb {held:.4f} (limits "
            f"{state_gb:.2f} and 1.02 x {peak_gb:.4f}), "
            f"{feats.get('memprof_sites')} sites; trace entries "
            f"{meta.get('trace_entries')}, allocator peak "
            f"{meta.get('allocator_peak_bytes')} bytes, last gate snapshot "
            f"{meta.get('gate_bytes')} bytes")
        for _, row in sites.head(8).iterrows():
            log(f"profile[llama]: site {row['bytes'] / 1e9:8.4f} GB "
                f"x{int(row['count']):5d} {row['share']:6.1%}  {row['site']}")
        if not state_gb <= held <= 1.02 * peak_gb:
            raise AssertionError("memprof_held_gb is outside its limits")
        if "sofa_tpu_torch/" not in top or "(stackless buffer)" in top:
            raise AssertionError(f"the top allocation site is not a line "
                                 f"of sofa_tpu_torch/: {top}")
        # the host frames
        mp = frame(logdir, "mpstat")
        py = frame(logdir, "pystacks")
        mine = py["module"].str.contains(
            "sofa_tpu_torch.workloads.transformer.", regex=False)
        agg = mp[mp["deviceId"] == -1]
        frozen = not agg["payload"].any()
        log(f"profile[llama]: mpstat {len(mp)} rows "
            f"({len(agg)} aggregate, /proc/stat "
            f"{'frozen: host CPU not measured' if frozen else 'advancing'})"
            f", cpu_util {feats.get('cpu_util')}, num_cores "
            f"{feats.get('num_cores')}; pystacks {len(py)} samples, "
            f"{int(mine.sum())} in the transformer workload")
        if agg.empty or "num_cores" not in feats \
                or ("cpu_util" in feats) == frozen:
            raise AssertionError("the host frames lack mpstat's aggregate "
                                 "rows or num_cores, or cpu_util disagrees "
                                 "with whether /proc/stat advanced")
        if not mine.any():
            raise AssertionError("pystacks has no frame of the workload")
        self.flash_roofline(logdir, steps)
        # the wrapped-ring run (no Kineto trace) compares its sites to these
        self.llama_sites = sites
        for state, got in rate:
            log(f"profile[llama]: allocation stacks {state}: "
                + " | ".join(got) + f" | {self.smi}")

    def flash_roofline(self, logdir, steps):
        """The three flash kernels' rows of the traced Llama-width run's
        roofline.csv: each launch must carry its Pallas CostEstimate."""
        import pandas as pd
        from sofa_tpu_torch.costs import flash_cost

        roof = pd.read_csv(os.path.join(logdir, "roofline.csv"))
        cfg = (4, 2048, 2048, 32, 8, 128, True)     # B T Tk H KVH D causal
        for kern in ("sofa_flash_fwd", "sofa_flash_bwd_kv",
                     "sofa_flash_bwd_dq"):
            rows = roof[roof["name"].astype(str).str.contains(kern)]
            flops, nbytes = flash_cost(kern, *cfg)
            for _, r in rows.iterrows():
                log(f"profile[llama]: roofline {kern}: {int(r['count'])} "
                    f"launches, {r['time'] * 1e3:.3f} ms, flops "
                    f"{r['flops']:.4e} ({r['flops'] / r['count']:.4e} a "
                    f"launch; CostEstimate {flops:.4e}), bytes "
                    f"{r['bytes_accessed'] / r['count']:.4e} a launch "
                    f"(CostEstimate {nbytes:.4e}), sol {r['sol_time'] * 1e3:.3f}"
                    f" ms, efficiency {r['efficiency']:.3f}, {r['bound']}"
                    f"-bound | {self.smi}")
            per = rows["flops"].sum() / max(rows["count"].sum(), 1)
            if rows.empty or abs(per - flops) > 1e-6 * flops:
                raise AssertionError(f"{kern}'s roofline rows do not carry "
                                     f"its CostEstimate flops")

    def sites_without_trace(self, feats, sites, traced_sites):
        """The Llama-width run's allocation sites without the Kineto trace
        (the wrapped-ring run's) against the traced run's: its peak and the
        sites that differ most (the trace's run reads 0.3-1.2 % above the
        train phase's peak)."""
        log(f"profile[notrace]: gpu0_hbm_peak_gb "
            f"{feats.get('gpu0_hbm_peak_gb', 0.0):.4f}, memprof_held_gb "
            f"{feats.get('memprof_held_gb', 0.0):.4f} (train phase "
            f"{self.train_peak / 1e9:.4f})")
        both = traced_sites.merge(sites, on="site", how="outer",
                                  suffixes=("_trace", "_notrace")).fillna(0)
        both["diff"] = both["bytes_trace"] - both["bytes_notrace"]
        both = both.reindex(both["diff"].abs().sort_values(
            ascending=False).index)
        for _, row in both.head(6).iterrows():
            log(f"profile[notrace]: site {row['diff'] / 1e6:+10.3f} MB with "
                f"the trace ({row['bytes_trace'] / 1e9:.4f} vs "
                f"{row['bytes_notrace'] / 1e9:.4f} GB)  {row['site']}")

    def profile_killed(self):
        """An eager Llama-width training run without the Kineto trace,
        under ``-X importtime``, killed mid-run once its gate snapshot holds
        the training state: the snapshot must be there, taken at a sampler
        tick, and the program must still have been running (no deadlock
        against its own imports)."""
        import signal

        logdir = os.path.join(REPO, "build", "chip_smoke_profile_killed")
        shutil.rmtree(logdir, ignore_errors=True)
        meta_path = os.path.join(logdir, "memprof.pb.gz.meta.json")
        state = 8 * self.train_params
        cmd = (f"{sys.executable} -X importtime -m "
               "sofa_tpu_torch.workloads.transformer --steps 400 --batch 4 "
               f"{LLAMA_WIDTH}")
        os.makedirs(logdir)
        # to a file: the import trace fills a pipe and would block the run
        err_path = os.path.join(logdir, "..", "chip_smoke_killed.err")
        err_file = open(err_path, "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "sofa_tpu_torch", "record", "--logdir",
             logdir, "--disable_kineto", cmd], cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=err_file)
        t0, meta, seen = time.perf_counter(), {}, None
        try:
            while time.perf_counter() - t0 < 240 and proc.poll() is None:
                time.sleep(0.5)
                try:
                    with open(meta_path) as f:
                        meta = json.load(f)
                except (OSError, ValueError):
                    continue
                if meta.get("total_bytes", 0) >= state and seen is None:
                    seen = time.perf_counter()
                if seen is not None and time.perf_counter() - seen > 8:
                    break
            victims = []
            for pid in descendants(proc.pid):
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        argv = f.read().split(b"\0")
                except OSError:
                    continue
                if b"sofa_tpu_torch.workloads.transformer" in argv:
                    victims.append(pid)
            alive = proc.poll() is None and bool(victims)
            for pid in victims:
                os.kill(pid, signal.SIGKILL)
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err_file.close()
        with open(err_path) as f:
            err = f.read()
        inductor = sorted({ln.split("|")[-1].strip() for ln in err.splitlines()
                           if "torch._inductor" in ln and "|" in ln})
        log(f"profile[killed]: workload alive at the kill: {alive} "
            f"({len(victims)} process), record rc {proc.returncode}; gate "
            f"snapshot {meta.get('trigger')} at {meta.get('total_bytes')} "
            f"bytes (training state {state}), replayed "
            f"{meta.get('replayed', False)}, took "
            f"{meta.get('snapshot_s', 0):.4f} s; the program imported "
            f"{len(inductor)} torch._inductor modules "
            f"{inductor[:4]}")
        if not alive:
            raise AssertionError("the eager training run was not running "
                                 "when it was to be killed")
        if meta.get("trigger") != "peak" or meta.get("replayed") \
                or meta.get("total_bytes", 0) < state:
            raise AssertionError("the killed eager run left no gate snapshot "
                                 "holding its training state")

    def kernels_in_steps(self, kern, steps):
        """Kernels the sofa_step_N ranges hold, and the backward kernels
        among them, which autograd launches from its own device thread:
        every one of them must be counted in its step."""
        module = kern["module"].fillna("").astype(str)
        ranged = kern[module.str.match(r"sofa_step_\d+$")]
        name = ranged["name"].astype(str)
        bwd = int(name.str.contains("sofa_flash_bwd_").sum())
        log(f"profile: the {steps} steps hold {len(ranged)} kernels, "
            f"{ranged['duration'].sum() * 1e3:.3f} ms of device time; "
            f"backward kernels {bwd}")
        want = 2 * 4 * steps            # two backward kernels, 4 layers
        if bwd != want:
            raise AssertionError(f"the steps hold {bwd} backward kernels, "
                                 f"expected {want}")
        return len(ranged), bwd

    def profile_wrapped_ring(self):
        """The Llama-width training run, long enough that the allocator
        trace's ring wraps (1.1 x its length), without the Kineto trace:
        the at-exit replay then walks the ring's last entries only.  Logs
        what the replay and the last gate snapshot hold."""
        import pandas as pd
        from sofa_tpu_torch.collectors.gpumon import MAX_ENTRIES

        # 1.1 x the ring (1.25 to PR 12): past the wrap, a shorter run
        steps = math.ceil(1.1 * MAX_ENTRIES / self.trace_per_step)
        cmd = (f"{sys.executable} -m sofa_tpu_torch.workloads.transformer "
               f"--steps {steps} --batch 4 {LLAMA_WIDTH}")
        feats, logdir, out = self.run_stat("ring", cmd, ("--disable_kineto",))
        with open(os.path.join(logdir, "memprof.pb.gz.meta.json")) as f:
            meta = json.load(f)
        sites = pd.read_csv(os.path.join(logdir, "gpu_memprof.csv"))
        peak_gb = feats.get("gpu0_hbm_peak_gb", 0.0)
        held = feats.get("memprof_held_gb", 0.0)
        top = str(sites["site"].iloc[0])
        log(f"profile[ring]: {steps} steps (+2 warm-up), "
            + " | ".join(ln for ln in out.splitlines()
                         if ln.startswith("transformer:"))
            + f"; memprof {meta['trigger']} snapshot, replayed "
            f"{meta.get('replayed', False)}, trace entries "
            f"{meta.get('trace_entries')} (wrapped {meta.get('wrapped')}), "
            f"held {meta['total_bytes']} bytes against the allocator's peak "
            f"{meta.get('allocator_peak_bytes')} and the last gate snapshot's"
            f" {meta.get('gate_bytes')}; took {meta['snapshot_s']:.3f} s; "
            f"memprof_held_gb {held:.4f}, gpu0_hbm_peak_gb {peak_gb:.4f}; "
            f"top site {top} | {self.smi}")
        for _, row in sites.head(4).iterrows():
            log(f"profile[ring]: site {row['bytes'] / 1e9:8.4f} GB "
                f"x{int(row['count']):5d} {row['share']:6.1%}  {row['site']}")
        state_gb = 8 * self.train_params / 1e9
        if not meta.get("wrapped"):
            raise AssertionError("the allocation trace's ring did not wrap")
        if not state_gb <= held <= 1.02 * peak_gb:
            raise AssertionError("memprof_held_gb is outside its limits "
                                 "after the ring wrapped")
        if "sofa_tpu_torch/" not in top:
            raise AssertionError(f"the top allocation site is not a line "
                                 f"of sofa_tpu_torch/: {top}")
        self.sites_without_trace(feats, sites, self.llama_sites)

    def resnet(self):
        """ResNet-50 train steps bare and under the in-process profile(),
        as the JAX package's benchmark times them, each pair in a fresh
        process (so that no bare pass follows a profiler in its process),
        with a bare pass after the profiled one; then the device passes
        over the last capture, and ``stat`` over the workload's
        ``main``."""
        import statistics

        import pandas as pd
        from scipy import stats

        from sofa_tpu_torch.analyze import sofa_analyze
        from sofa_tpu_torch.config import SofaConfig
        from sofa_tpu_torch.preprocess import sofa_preprocess

        batch, steps = RESNET_BATCH, RESNET_STEPS
        runs = []
        for i in range(RESNET_PAIRS):
            logdir = os.path.join(REPO, "build", f"chip_smoke_resnet_r{i}")
            shutil.rmtree(logdir, ignore_errors=True)
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--resnet-pass",
                 logdir], cwd=REPO, capture_output=True, text=True,
                timeout=600)
            got = [ln for ln in r.stdout.splitlines()
                   if ln.startswith("RESNET_PASS ")]
            if r.returncode or not got:
                raise AssertionError(f"the ResNet-50 process failed, rc "
                                     f"{r.returncode}: {r.stderr[-3000:]}")
            d = json.loads(got[-1].split(" ", 1)[1])
            runs.append((logdir, d))
            log(f"resnet: process {i}: {d['params']:,} params, "
                f"batch {batch}, 224x224, 1000 classes, bf16, channels_last,"
                f" warm-up {d['warmup_s']:.1f} s; bare {d['bare']:.4f} s "
                f"({steps * batch / d['bare']:.1f} images/s), profiled "
                f"{d['profiled']:.4f} s ({steps * batch / d['profiled']:.1f} "
                f"images/s), bare after it {d['after']:.4f} s "
                f"({steps * batch / d['after']:.1f} images/s), loss "
                f"{d['loss']:.4f}")
        pairs = [d for _, d in runs]
        bare = [d["bare"] for d in pairs]
        prof = [d["profiled"] for d in pairs]
        repeats = len(pairs)
        p_value = float(stats.ttest_rel(prof, bare).pvalue)
        t_bare, t_prof = statistics.median(bare), statistics.median(prof)
        overhead = max(0.0, (t_prof - t_bare) / t_bare * 100.0)

        # what a profiler leaves behind once stopped: the bare pass after
        # the profiled one against the process's first
        log("resnet: bare after the profiled pass vs before it, each "
            "process: " + ", ".join(
                f"{(d['after'] / d['bare'] - 1) * 100:+.1f}" for d in pairs)
            + " %")
        cfg = SofaConfig(logdir=runs[-1][0])
        t0 = time.perf_counter()
        # in this process, which holds a CUDA context: the parser process
        # pool (forced on) must start by forkserver or spawn, never fork
        os.environ["SOFA_PREPROCESS_POOL"] = "always"
        try:
            frames = sofa_preprocess(cfg)
        finally:
            del os.environ["SOFA_PREPROCESS_POOL"]
        feats = sofa_analyze(cfg, frames)
        from sofa_tpu_torch.pool import process_context

        self.check_manifest("resnet_api", cfg.logdir)
        log(f"resnet: in-process preprocess with the parser process pool "
            f"forced on: {process_context().get_start_method()}")
        kern = frames["gputrace"][frames["gputrace"]["copyKind"] == 0]
        conv = kern[kern["hlo_category"].isin(
            ("aten::cudnn_convolution", "aten::convolution_backward"))]
        log(f"resnet: images/s bare {steps * batch / t_bare:.1f}, profiled "
            f"{steps * batch / t_prof:.1f} (medians of {repeats}); overhead "
            f"{overhead:.2f} % (target 5 %), paired t-test p {p_value:.4g} "
            f"({repeats - 1} degree(s) of freedom); "
            f"gputrace {len(kern)} kernel rows, {len(conv)} convolution "
            f"kernels ({(conv['flops'] > 0).sum()} with flops); preprocess "
            f"and analyze {time.perf_counter() - t0:.1f} s | {self.smi}")
        # coverage guard: an overhead over an empty capture means nothing
        if kern.empty:
            raise AssertionError("coverage guard: the capture holds no CUDA "
                                 "kernel rows")
        if conv.empty or not (conv["flops"] > 0).all():
            raise AssertionError("the convolution kernels lack flops")
        want = ("roi_begin", "roi_end", "gpu_total_flops",
                "gpu_total_bytes_accessed", "gpu_fw_time", "gpu_bw_time",
                "gpu_bw_fw_ratio", "op_tree_paths", "gpu0_async_time",
                "gpu0_async_hidden_pct", "gpu0_step_gap_pct",
                "gpu0_step_h2d_pct", "gpu0_roofline_efficiency",
                "gpu0_compute_bound_time", "gpu0_memory_bound_time",
                "gpu0_arithmetic_intensity", "kernel_util_mean",
                "kernel_util_median", "tensor_util_mean", "hbm_gbps_mean",
                "gpu0_sol_distance", "gpu_step_busy_pct")
        log("resnet: features " + ", ".join(
            f"{k} {feats.get(k):.6g}" for k in want
            if feats.get(k) is not None))
        roof = pd.read_csv(cfg.path("roofline.csv"))
        for _, r in roof.head(5).iterrows():
            log(f"resnet: roofline {r['time'] * 1e3:8.3f} ms x"
                f"{int(r['count']):4d} {r['flops'] / r['time'] / 1e12:7.1f} "
                f"TFLOP/s {r['bytes_accessed'] / r['time'] / 1e9:7.1f} GB/s "
                f"efficiency {r['efficiency']:.3f} {r['bound']:7s} "
                f"{str(r['name'])[:80]}")
        cats = pd.read_csv(cfg.path("gpu_categories.csv"))
        for _, r in cats.head(8).iterrows():
            log(f"resnet: category {r['duration'] * 1e3:9.3f} ms {r['cat']}")
        # roofline.csv's efficiency is clipped at 1 (as the JAX pass's), so
        # the limits hold the ratios themselves.  No kernel beats the
        # tensor cores' peak.  A launch that moves B bytes can find at most
        # the L2's L of them there (left by the kernel before), so it reads
        # at least B - L from HBM: its bytes over the HBM rate are at most
        # B / (B - L) (B a launch, averaged over the row); a launch that
        # fits in the L2 is not held to the HBM rate at all.
        flop_ratio = roof["flops"] / (self.peaks[0] * roof["time"])
        byte_ratio = roof["bytes_accessed"] / (self.peaks[1] * roof["time"])
        per_launch = roof["bytes_accessed"] / roof["count"]
        big = per_launch > L2_BYTES
        byte_limit = 1.05 * per_launch / (per_launch - L2_BYTES)
        log(f"resnet: roofline.csv {len(roof)} rows, clipped efficiency at "
            f"most {roof['efficiency'].max():.3f}; flops over the bf16 peak "
            f"at most {flop_ratio.max():.3f} (limit 1.05); bytes over the "
            f"HBM rate at most {byte_ratio.max():.3f}, over their row's "
            f"limit at most {(byte_ratio / byte_limit)[big].max():.3f} in "
            f"the {int(big.sum())} rows whose launches move more than the "
            f"L2 holds (limit 1)")
        for i in byte_ratio[byte_ratio > 1].index:
            log(f"resnet: roofline row over the HBM rate: "
                f"{byte_ratio[i]:.3f}x, {per_launch[i] / 1e6:.2f} MB a launch, "
                f"{int(roof['count'][i])} launches, {roof['name'][i][:90]}")
        if flop_ratio.max() > 1.05 or (big & (byte_ratio > byte_limit)).any():
            raise AssertionError("a roofline row runs faster than its bound")
        if feats.get("gpu0_step_gap_pct") is None:
            raise AssertionError("no step gap was measured")
        self.resnet_light(overhead)

    def window(self):
        """``stat`` over the ResNet-50 workload's ``main`` (batch 128, 6.5
        GB of the card) at trace level 0, then once more with the trace's
        window set from that run's capture (``resnet_window``)."""
        # at batch 128 a step is bound by the card, not the host: the
        # windowed run's steps are then as long as its kernels (below); at
        # trace level 0 (under record) its warm-up is close to an untraced
        # one's, which the window's delay is doubled from
        _, logdir, _, _ = self.stat("resnet", f"{sys.executable} -m "
                                    "sofa_tpu_torch.workloads.resnet --train "
                                    "--batch 128 --steps 5", 5, [],
                                    ("--kineto_host_tracer_level", "0"))
        self.resnet_window(logdir)

    def resnet_light(self, default_overhead):
        """One more fresh-process pair at the lightest trace detail that
        keeps the kernel rows (--kineto_host_tracer_level 0: the device
        activity, its launches and the record_function ranges, no aten
        op): its overhead beside the default pairs' median, and its
        coverage guard (CUDA-kernel rows in gputrace; the flops guard is the
        default level's)."""
        from sofa_tpu_torch.config import SofaConfig
        from sofa_tpu_torch.ingest.kineto import ingest_kineto_dir
        from sofa_tpu_torch.preprocess import read_time_base

        batch, steps = RESNET_BATCH, RESNET_STEPS
        logdir = os.path.join(REPO, "build", "chip_smoke_resnet_light")
        shutil.rmtree(logdir, ignore_errors=True)
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--resnet-pass",
             logdir, "0"], cwd=REPO, capture_output=True, text=True,
            timeout=600)
        got = [ln for ln in r.stdout.splitlines()
               if ln.startswith("RESNET_PASS ")]
        if r.returncode or not got:
            raise AssertionError(f"the light ResNet-50 process failed, rc "
                                 f"{r.returncode}: {r.stderr[-3000:]}")
        d = json.loads(got[-1].split(" ", 1)[1])
        overhead = (d["profiled"] - d["bare"]) / d["bare"] * 100.0
        # the capture's ingest alone: the light run's frames go nowhere
        gpu = ingest_kineto_dir(os.path.join(logdir, "kineto"), read_time_base(
            SofaConfig(logdir=logdir)))["gputrace"]
        kern = gpu[gpu["copyKind"] == 0]
        trace_mb = sum(os.path.getsize(p) for p in glob.glob(
            os.path.join(logdir, "kineto", "*.json"))) / 1e6
        log(f"resnet[light]: host tracer level 0: bare {d['bare']:.4f} s "
            f"({steps * batch / d['bare']:.1f} images/s), profiled "
            f"{d['profiled']:.4f} s ({steps * batch / d['profiled']:.1f} "
            f"images/s): overhead {overhead:.2f} % against the default "
            f"level's median {default_overhead:.2f} % (target 5 %); "
            f"gputrace {len(kern)} kernel rows, {int(kern['flops'].isna().sum())}"
            f" without flops (absent), phase absent on "
            f"{int((kern['phase'] == '').sum())}; trace {trace_mb:.1f} MB | "
            f"{self.smi}")
        if kern.empty:
            raise AssertionError("coverage guard: the light capture holds "
                                 "no CUDA kernel rows")

    def resnet_window(self, full_logdir):
        """``stat`` of the ResNet-50 workload with the trace's window set
        from the full run's capture (the same workload, traced from
        ``import torch`` at level 0): start at twice that run's first step
        plus 2 P (P its traced step period; warm-ups, cuDNN's search among
        them, vary from process to process) and stop 4 P, at least
        WINDOW_MIN_S, later (the host-bound steps of this process slow
        several times over while the lanes beside it hold the host's
        cores); its steps, each at least the device time a traced step
        held, outlast the window: it holds some steps and not all.  Its kernels must lie
        inside the window (a 0.5 s margin), its steps be fewer than the
        run's, and its kernels keep their launch context (op_path, fw and
        bw phases)."""
        doc = json.load(open(glob.glob(os.path.join(
            full_logdir, "kineto", "*.json"))[0]))
        marks = sorted(float(e["ts"]) for e in doc["traceEvents"]
                       if str(e.get("name", "")).startswith(
                           "sofa_timebase_marker:"))
        steps = sorted((float(e["ts"]), float(e["dur"]))
                       for e in doc["traceEvents"]
                       if e.get("cat") == "user_annotation"
                       and str(e.get("name", "")).startswith("sofa_step_"))
        first = (steps[0][0] - marks[0]) / 1e6
        period = (steps[-1][0] - steps[0][0]) / 1e6 / (len(steps) - 1)
        full = frame(full_logdir, "gputrace")
        in_steps = full[(full["copyKind"] == 0) & full["module"].astype(
            str).str.match(r"sofa_step_\d+$")]
        device_step = float(in_steps["duration"].sum()) / len(steps)
        delay = 2 * first + 2 * period
        duration = max(4 * period, WINDOW_MIN_S)
        n_steps = int(math.ceil((delay + duration) / device_step))
        feats, logdir, out = self.run_stat(
            "resnet_window", f"{sys.executable} -m sofa_tpu_torch.workloads."
            f"resnet --train --batch 128 --steps {n_steps}",
            ("--kineto_delay_s", f"{delay:.3f}", "--kineto_duration_s",
             f"{duration:.3f}"))
        with open(os.path.join(logdir, "sofa_time.txt")) as f:
            time_base = float(f.read().split()[0])
        wdoc = json.load(open(glob.glob(os.path.join(
            logdir, "kineto", "*.json"))[0]))
        detail = wdoc["sofa_trace_detail"]
        t0 = detail["start_unix"] - time_base
        t1 = detail["stop_unix"] - time_base
        gpu = frame(logdir, "gputrace")
        kern = gpu[gpu["copyKind"] == 0]
        ksteps = frame(logdir, "gpusteps")
        ends = kern["timestamp"] + kern["duration"]
        margin = 0.5
        outside = int(((kern["timestamp"] < t0 - margin)
                       | (ends > t1 + margin)).sum())
        with_path = float((kern["op_path"] != "").mean()) if len(kern) else 0
        phases = sorted(set(kern["phase"]))
        log(f"resnet[window]: the full run's first step {first:.3f} s after "
            f"the trace's start, period {period * 1e3:.1f} ms, "
            f"{device_step * 1e3:.1f} ms of kernels a step; window "
            f"--kineto_delay_s {delay:.3f} --kineto_duration_s "
            f"{duration:.3f}: traced [{t0:.3f}, {t1:.3f}] s of the run "
            f"({t1 - t0:.3f} s); gputrace {len(kern)} kernel rows in "
            f"[{kern['timestamp'].min():.3f}, {ends.max():.3f}] s, {outside} "
            f"outside the window (margin {margin} s); {len(ksteps)} "
            f"sofa_step ranges of {n_steps}; op_path on "
            f"{with_path:.1%} of the kernels, phases {phases}")
        if kern.empty or outside or not 0 < len(ksteps) < n_steps:
            raise AssertionError("the windowed capture holds kernels outside "
                                 "its window, none, or every step")
        if with_path < 0.99 or not {"fw", "bw"} <= set(phases):
            raise AssertionError("the windowed capture's kernels lack their "
                                 "launch context")

    def profile_untouched_card(self):
        """A profiled torch program that never uses the card stays
        CUDA-uninitialized: the injection initializes nothing."""
        logdir = os.path.join(REPO, "build", "chip_smoke_profile_nocuda")
        shutil.rmtree(logdir, ignore_errors=True)
        cmd = (f"{sys.executable} -c \"import torch; "
               "print('cuda initialized:', torch.cuda.is_initialized())\"")
        r = subprocess.run([sys.executable, "-m", "sofa_tpu_torch", "record",
                            "--logdir", logdir, "--enable_py_stacks", cmd],
                           cwd=REPO, capture_output=True, text=True,
                           timeout=300)
        with open(os.path.join(logdir, "gpu_topo.json")) as f:
            topo = json.load(f)
        wrote = os.path.exists(os.path.join(logdir, "gpumon.txt"))
        log(f"profile[nocuda]: rc {r.returncode}, "
            f"{[ln for ln in r.stdout.splitlines() if 'cuda' in ln]}, "
            f"gpumon.txt written: {wrote}, initialized devices at exit: "
            f"{topo['devices']}")
        if r.returncode != 0 or "cuda initialized: False" not in r.stdout \
                or wrote or topo["devices"]:
            raise AssertionError("the injection initialized CUDA in a "
                                 "program that never used the card")


    # -- board ------------------------------------------------------------------
    def board(self):
        """The board over two captures the card made: ``report`` (host
        only: no card visible) over the Llama-width training capture and
        the last ResNet-50 ``api.profile()`` capture; report.js, the tile
        pyramid and the hints; ``viz`` serving every page and what the
        pages fetch; then ``clean`` on a copy of the ResNet logdir, and
        ``report`` over the copy again."""
        from sofa_tpu_torch.kernels import HOPPER

        logdirs = (
            ("llama", os.path.join(REPO, "build", "chip_smoke_profile_llama")),
            ("resnet", os.path.join(REPO, "build", "chip_smoke_resnet_r1")))
        for label, logdir in logdirs:
            # measure the tile stage cold: the earlier phases built it
            shutil.rmtree(os.path.join(logdir, "_tiles"), ignore_errors=True)
            timing = self.board_report(label, logdir)
            self.board_jobs(label, logdir)
            doc = self.board_report_js(label, logdir)
            if label == "llama":
                flash = next(s for s in doc["series"]
                             if s["name"] == "gpu_sofa_flash")
                held = {k.name: [n for n in flash["data"]["names"]
                                 if k.name in n] for k in HOPPER}
                log(f"board[llama]: gpu_sofa_flash holds {held}")
                if not all(held.values()):
                    raise AssertionError("the sofa_flash series lacks a "
                                         "flash kernel")
            elif "gputrace" not in doc["meta"].get("tiles", {}).get(
                    "series", {}):
                raise AssertionError("the ResNet-50 gputrace has no pyramid")
            leaves = self.board_leaf_rows(label, logdir, doc)
            hints = self.board_hints(label, logdir)
            if label == "resnet" and not any(
                    h.startswith("device idle inside steps on gpu0")
                    for h in hints):
                raise AssertionError("hints.txt lacks the idle-steps hint")
            self.board_viz(label, logdir)
            tiles = doc["meta"].get("tiles", {}).get("series", {})
            log(f"board[{label}]: report {timing['wall']:.3f} s wall; series "
                f"{timing['series']} s, tiles {timing['tiles']} s, report.js "
                f"{timing['report_js']} s; report.js {timing['bytes']} bytes,"
                f" {len(doc['series'])} series; tiles: " + (", ".join(
                    f"{n} {e['tile_count']} in {e['levels']} levels "
                    f"({e['bytes']} bytes)" for n, e in tiles.items())
                    or "none") + f"; gputrace rows in the deepest tiles "
                f"{leaves} | {self.smi}")
        self.board_new_passes(logdirs[1][1])
        self.board_registry(logdirs[0][1])

    def board_jobs(self, label, logdir):
        """``report --jobs 1`` after the phase's ``--jobs 4`` one: the
        passes run in waves on the pool or one by one, and features.csv
        and hints.txt must come out byte-identical."""
        def outputs():
            got = {}
            for name in ("features.csv", "hints.txt"):
                with open(os.path.join(logdir, name), "rb") as f:
                    got[name] = f.read()
            return got

        first = outputs()
        walls = []
        for jobs in ("1",):
            r, wall = self.board_cli("report", "--logdir", logdir, "--jobs",
                                     jobs)
            if r.returncode != 0 or "Complete!!" not in r.stdout:
                raise AssertionError(f"report --jobs {jobs} failed ({label})"
                                     f": {r.stderr[-3000:]}")
            walls.append(f"--jobs {jobs} {wall:.2f} s")
            if outputs() != first:
                raise AssertionError(f"report --jobs {jobs} wrote other "
                                     f"features.csv or hints.txt ({label})")
            # robust cell 4 reports this logdir again in csv, warm
            self.jobs1[label] = (wall, self.outputs(logdir))
        from sofa_tpu_torch import telemetry

        ledger = telemetry.load_manifest(logdir)["meta"]["passes"]
        log(f"board[{label}]: features.csv ({len(first['features.csv'])} "
            f"bytes) and hints.txt ({len(first['hints.txt'])} bytes) "
            f"byte-identical: " + ", ".join(walls)
            + f" (the first --jobs 4); waves "
            f"{[len(w) for w in ledger['schedule']]}, the slowest "
            "passes " + ", ".join(
                f"{n} {e['wall_s']:.3f} s" for n, e in sorted(
                    ledger["passes"].items(),
                    key=lambda kv: -kv[1].get("wall_s", 0))[:3]))

    def board_registry(self, logdir):
        """A plugin whose pass raises, over a copy of the Llama-width
        capture: ``report --skip_preprocess --plugin`` still completes, the
        manifest marks the pass ``failed`` (valid by the validator) and
        ``status`` names it and exits 1; then ``passes`` over the capture
        lists every enabled built-in pass with its last run's time and
        the gated ones skipped."""
        from sofa_tpu_torch import telemetry
        from sofa_tpu_torch.analysis import registry
        from sofa_tpu_torch.config import SofaConfig
        from sofa_tpu_torch.tools.manifest_check import validate_manifest

        plugdir = os.path.join(REPO, "build", "chip_smoke_plugin")
        os.makedirs(plugdir, exist_ok=True)
        with open(os.path.join(plugdir, "chip_smoke_boom.py"), "w") as f:
            f.write("def chip_smoke_boom(cfg):\n"
                    "    from sofa_tpu_torch.analysis.registry import "
                    "register_pass\n"
                    "    def boom(frames, cfg, features):\n"
                    "        raise KeyError('chip_smoke_boom')\n"
                    "    register_pass(boom, name='boom_pass')\n")
        copy = os.path.join(REPO, "build", "chip_smoke_board_plugin")
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(logdir, copy, ignore=shutil.ignore_patterns(
            "kineto", "_tiles", "_ingest_cache"))
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join([plugdir, REPO]))
        r = subprocess.run([sys.executable, "-m", "sofa_tpu_torch", "report",
                            "--skip_preprocess", "--no_tiles", "--logdir",
                            copy, "--plugin", "chip_smoke_boom"], cwd=REPO,
                           env=env, capture_output=True, text=True,
                           timeout=600)
        doc = telemetry.load_manifest(copy)
        ent = doc["meta"]["passes"]["passes"].get("boom_pass", {})
        st, _ = self.board_cli("status", "--logdir", copy)
        log(f"board[plugin]: report rc {r.returncode}, Complete!! "
            f"{'Complete!!' in r.stdout}; boom_pass {ent.get('status')} "
            f"({ent.get('origin')}: {ent.get('error')}); status rc "
            f"{st.returncode}: "
            + " | ".join(ln.strip() for ln in st.stdout.splitlines()
                         if "pass" in ln))
        if r.returncode != 0 or "Complete!!" not in r.stdout \
                or ent.get("status") != "failed" \
                or ent.get("origin") != "plugin:chip_smoke_boom" \
                or validate_manifest(doc) != [] or st.returncode != 1 \
                or "boom_pass failed" not in st.stdout:
            raise AssertionError("a raising plugin pass did not end as one "
                                 f"failed pass: {r.stderr[-2000:]}")
        shutil.rmtree(copy)
        r, wall = self.board_cli("passes", "--logdir", logdir)
        registry.load_builtin_passes()
        # the mining passes are gated off by default: skipped, and said so
        names = [sp.name for sp in registry.registered()
                 if sp.enabled(SofaConfig())]
        gated = [sp.name for sp in registry.registered()
                 if not sp.enabled(SofaConfig())]
        timed = [n for n in names if re.search(
            rf"^{n}  \[builtin\]  \[last run: ok [\d.]+s\]", r.stdout,
            re.M)]
        skipped = [n for n in gated if re.search(
            rf"^{n}  \[builtin\] \(gated by [\w/]+; off\)  \[last run: "
            r"skipped\]", r.stdout, re.M)]
        waves = [ln for ln in r.stdout.splitlines() if ln.startswith("wave ")]
        log(f"board[passes]: rc {r.returncode} in {wall:.2f} s; "
            f"{len(timed)} of {len(names)} built-in passes with their last "
            f"run's time, {len(skipped)} of {len(gated)} gated ones "
            f"skipped; " + "; ".join(w[:100] for w in waves))
        if r.returncode != 0 or timed != names or skipped != gated:
            raise AssertionError(
                f"passes lacks the last run of "
                f"{sorted(set(names) - set(timed))} or the skip of "
                f"{sorted(set(gated) - set(skipped))}")

    def board_cli(self, *argv):
        """``python -m sofa_tpu_torch <argv>`` with no card visible."""
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "sofa_tpu_torch", *argv],
                           cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=600)
        return r, time.perf_counter() - t0

    def board_report(self, label, logdir):
        r, wall = self.board_cli("report", "--logdir", logdir, "--jobs", "4")
        for line in (r.stdout + r.stderr).splitlines():
            if line.startswith(("[PROGRESS]", "[HINT]", "[WARNING]")):
                log(f"  | {line}")
        if r.returncode != 0 or "Complete!!" not in r.stdout:
            raise AssertionError(f"report failed ({label}), rc "
                                 f"{r.returncode}: {r.stderr[-3000:]}")
        m = re.search(r"board data: \d+ series in ([\d.]+) s, tiles in "
                      r"([\d.]+) s, report.js \((\d+) bytes\) in ([\d.]+) s",
                      r.stdout)
        if m is None:
            raise AssertionError(f"report printed no board stage times "
                                 f"({label})")
        return {"wall": wall, "series": m.group(1), "tiles": m.group(2),
                "bytes": int(m.group(3)), "report_js": m.group(4)}

    def board_report_js(self, label, logdir):
        from sofa_tpu_torch.trace import read_report_js_doc

        doc = read_report_js_doc(os.path.join(logdir, "report.js"))
        names = {s["name"] for s in doc["series"]}
        want = {"gputrace", "gpu_phase_fw", "gpu_phase_bw", "gpuutil",
                "gpusteps", "gpumon", "hosttrace"}
        if label == "llama":
            want.add("gpu_sofa_flash")
        if not want <= names:
            raise AssertionError(f"report.js lacks {sorted(want - names)} "
                                 f"({label})")
        return doc

    def board_leaf_rows(self, label, logdir, doc):
        """The gputrace rows the deepest level's tiles hold together; the
        series is the whole frame, so they must number its rows."""
        from sofa_tpu_torch.tiles import read_tile

        rows = len(frame(logdir, "gputrace", ["timestamp"]))
        ent = doc["meta"].get("tiles", {}).get("series", {}).get("gputrace")
        if ent is None:
            return f"no pyramid ({rows} rows)"
        leaf = ent["levels"] - 1
        held = 0
        for i in range(1 << leaf):
            t = read_tile(logdir, ent["path"], leaf, i)
            if t is not None:
                if not t["exact"] or len(t["xd"]) != t["count"]:
                    raise AssertionError(f"leaf tile {i} is not exact")
                held += t["count"]
        if held != rows:
            raise AssertionError(f"the deepest tiles hold {held} rows, "
                                 f"gputrace.csv {rows} ({label})")
        return f"{held} of {rows} in {ent['tiles'][leaf]} leaf tiles"

    def board_hints(self, label, logdir):
        try:
            with open(os.path.join(logdir, "hints.txt")) as f:
                hints = [h for h in f.read().splitlines() if h]
        except FileNotFoundError:
            hints = []
        for h in hints:
            log(f"board[{label}]: hint: {h}")
        if not hints:
            log(f"board[{label}]: no hint fired")
        return hints

    def board_viz(self, label, logdir, first_port=8700):
        """``viz`` in its own process (on the first free port from
        ``first_port``): every staged page and what the pages fetch, 304,
        gzip and plain tiles, nothing outside the logdir; then the server is
        stopped and must be gone."""
        import glob
        import gzip
        import re

        from sofa_tpu_torch.analyze import board_pages

        with viz_served(logdir, first_port, label) as (port, get):
            bad = []
            for name in board_pages() + ["report.js"]:
                status = get("/" + name)[0]
                if status != 200:
                    bad.append((name, status))
            fetched = set()
            for page in glob.glob(os.path.join(logdir, "*.html")):
                with open(page) as f:
                    fetched |= set(re.findall(r'"([\w.]+\.csv)"', f.read()))
            absent = []
            for name in sorted(fetched):
                want = 200 if os.path.isfile(os.path.join(logdir, name)) \
                    else 404
                status = get("/" + name)[0]
                if status != want:
                    bad.append((name, status))
                if want == 404:
                    absent.append(name)
            _s, headers, _b = get("/report.js")
            revalidated = get("/report.js",
                              {"If-None-Match": headers["ETag"]})[0]
            if revalidated != 304:
                bad.append(("report.js If-None-Match", revalidated))
            # the deepest tile of gputrace's pyramid, else of any series'
            tiles = glob.glob(os.path.join(logdir, "_tiles", "gputrace",
                                           "*", "*.json.gz")) or glob.glob(
                os.path.join(logdir, "_tiles", "*", "*", "*.json.gz"))
            if tiles:
                deep = max(tiles, key=lambda p: (
                    int(p.split(os.sep)[-2]), p))
                url = "/tiles/" + "/".join(deep.split(os.sep)[-3:])
                status, headers, body = get(url, {"Accept-Encoding": "gzip"})
                plain = get(url)
                if status != 200 or headers.get("Content-Encoding") != \
                        "gzip" or plain[0] != 200 or \
                        json.loads(plain[2]) != json.loads(
                            gzip.decompress(body)):
                    bad.append((url, status, plain[0]))
            outside = get("/../../chip_smoke.py")[0]
            if outside != 404:
                bad.append(("/../../chip_smoke.py", outside))
            log(f"board[{label}]: viz on port {port}: {len(board_pages())} "
                f"staged files, report.js, {len(fetched) - len(absent)} CSVs "
                f"200, absent (404, as expected) {absent}, 304 on "
                f"revalidation, " + ("/".join(deep.split(os.sep)[-3:])
                                      if tiles else "no tile") +
                " gzip and plain, ../ 404")
            if bad:
                raise AssertionError(f"viz answered wrongly ({label}): {bad}")

    def board_new_passes(self, logdir):
        """The concurrency breakdown and the network passes over the
        ResNet-50 capture: performance.csv, five elapsed ratios that cover
        the windows, and netrank.csv beside any nettrace."""
        import pandas as pd

        feats = pd.read_csv(os.path.join(logdir, "features.csv"))
        feats = dict(zip(feats["name"], feats["value"]))
        classes = ("gpu", "usr", "sys", "iow", "idl")
        ratios = {c: feats.get(f"elapsed_{c}_ratio") for c in classes}
        perf_csv = os.path.join(logdir, "performance.csv")
        windows = (pd.read_csv(perf_csv)["class"].value_counts().to_dict()
                   if os.path.isfile(perf_csv) else {})
        log(f"board[passes]: performance.csv {sum(windows.values())} windows "
            f"{windows}; elapsed ratios {ratios}, sum "
            f"{sum(v or 0 for v in ratios.values())!r}; breakdown_elapsed "
            f"{feats.get('breakdown_elapsed')} s; "
            + ", ".join(f"{k} {v:.4f}" for k, v in feats.items()
                        if k.startswith("corr_gpu_")))
        if not windows or None in ratios.values() \
                or abs(sum(ratios.values()) - 1.0) > 1e-9:
            raise AssertionError("the concurrency breakdown is missing or "
                                 "its ratios do not sum to 1")
        self.board_recheck_windows(logdir, feats)
        rows = len(frame(logdir, "nettrace", ["timestamp"]))
        log(f"board[passes]: nettrace {rows} rows, netrank.csv "
            f"{os.path.isfile(os.path.join(logdir, 'netrank.csv'))} (no "
            "tcpdump on this machine: the packet passes are held on the "
            "CPU); net_tx_total_bytes "
            f"{feats.get('net_tx_total_bytes')}")

    def board_recheck_windows(self, logdir, feats):
        """Recomputes performance.csv from the frames it was made of, apart
        from the pass: each window's mean of mpstat's aggregate usr, sys and
        iow and of gpuutil's kernel_util, then its class (the largest, in
        the order gpu, usr, sys, iow; idl below 1 %).  Both must equal the
        file's, and the capture, which ran on the card, must have gpu
        windows."""
        import numpy as np
        import pandas as pd

        # parsed correctly rounded, as the frames come back exactly
        perf = pd.read_csv(os.path.join(logdir, "performance.csv"),
                           float_precision="round_trip")
        mp = frame(logdir, "mpstat")
        mp = mp[mp["deviceId"] == -1]
        util = frame(logdir, "gpuutil")
        edges = perf["timestamp"].to_numpy(dtype=float)
        n = len(edges)
        window = 1.0 / round(1.0 / (edges[1] - edges[0])) if n > 1 else 0.1
        t0 = float(mp["timestamp"].min())
        t1 = float(mp["timestamp"].max())
        if edges[0] != t0 or abs(t1 - t0 - float(feats["breakdown_elapsed"])) > 1e-9:
            raise AssertionError(f"performance.csv spans {edges[0]} + "
                                 f"{feats['breakdown_elapsed']} s, mpstat "
                                 f"{t0} to {t1}")

        def means(rows):
            rows = rows[(rows["timestamp"] >= t0) & (rows["timestamp"] < t1)]
            idx = np.clip(((rows["timestamp"].to_numpy(dtype=float) - t0)
                           / window).astype(int), 0, n - 1)
            got = rows["event"].groupby(idx).mean()
            out = np.zeros(n)
            out[got.index.to_numpy()] = got.to_numpy()
            return out

        cols = {"gpu_util": means(util[util["name"] == "kernel_util"])}
        for name in ("usr", "sys", "iow"):
            cols[name] = means(mp[mp["name"] == name])
        for col, want in cols.items():
            err = float(np.max(np.abs(perf[col].to_numpy(dtype=float)
                                      - want)))
            if err > 1e-9:
                raise AssertionError(f"performance.csv {col} differs from "
                                     f"the frames' window means by {err}")
        order = ("gpu_util", "usr", "sys", "iow")
        classes = []
        for i in range(n):
            top = max(order, key=lambda c: cols[c][i])
            classes.append("idl" if cols[top][i] < 1.0
                           else top.replace("_util", ""))
        wrong = int((perf["class"].to_numpy() != np.array(classes)).sum())
        log(f"board[passes]: recomputed {n} windows of {window} s from "
            f"mpstat.csv and gpuutil.csv: {wrong} classed otherwise, "
            f"{classes.count('gpu')} gpu")
        if wrong or "gpu" not in classes:
            raise AssertionError(f"{wrong} windows classed otherwise than "
                                 "their frames say, or no gpu window")

    # -- robust -----------------------------------------------------------------
    def robust(self):
        """The supervised, self-reporting record and the logdir's
        durability, the cells that need no card (the module docstring
        lists all seven): (2) and (6), then (3) and (5) over the
        Llama-width capture once the profile phase has checked it."""
        self.cells(self.robust_sticky, self.robust_epilogue)
        self.need("llama")
        self.cells(self.robust_truncated, self.robust_durability)

    def faults(self):
        """The robust cells that run a program on the card: (1) and (7)."""
        self.cells(self.robust_faulted, self.robust_attach)

    def cache(self):
        """Robust cell (4), over the ResNet-50 capture where the board phase
        left it."""
        self.cells(self.robust_cache)

    def cells(self, *cells):
        """Runs each robust cell and logs its line."""
        for cell in cells:
            t0 = time.perf_counter()
            line = cell()
            log(f"robust[{cell.__name__[7:]}]: {line} "
                f"({time.perf_counter() - t0:.1f} s) | {self.smi}")

    def need(self, what, timeout=1200.0):
        """Waits for ``what`` of another lane (a phase, or "llama": the
        profile phase's checked Llama-width capture); raises when a lane
        has failed meanwhile, or after ``timeout`` s."""
        t0 = time.perf_counter()
        while not self.done[what].wait(1.0):
            if self.failed.is_set():
                raise AssertionError(f"gave up waiting for {what}: another "
                                     f"lane failed")
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"{what} was not done after "
                                     f"{timeout:.0f} s")

    def robust_faulted(self):
        """stat over the Llama-width training at batch 1 with procmon killed
        5 s in and the Kineto harvest wedged past a 5 s deadline."""
        from sofa_tpu_torch import kernels, telemetry

        steps = 3
        cmd = (f"{sys.executable} -m sofa_tpu_torch.workloads.transformer "
               f"--steps {steps} --batch 1 {LLAMA_WIDTH}")
        flags = ("--inject_faults", "procmon:die@5s,kineto:wedge@harvest",
                 "--collector_harvest_timeout_s", "5")
        _, logdir, out, kern = self.stat(
            "faulted", cmd, steps, [k.name for k in kernels.HOPPER], flags,
            healthy=False)
        doc, status_rc = self.check_manifest("faulted", logdir, False,
                                             cli=True)
        pm, kt = doc["collectors"]["procmon"], doc["collectors"]["kineto"]
        start = next(st["t0_unix"] for st in doc["stages"]
                     if st["name"] == "procmon.start")
        with open(os.path.join(logdir, "sofa_time.txt")) as f:
            zero = float(f.read().split()[0])
        mp = frame(logdir, "mpstat")
        after = int((mp["timestamp"] > start + 5 - zero + 0.5).sum())
        want_rc = telemetry.render_status(doc, logdir)[1]
        launches = {k.name: int(kern["name"].astype(str).str.contains(
            k.name).sum()) for k in kernels.HOPPER}
        if pm.get("restarts") != 1 or not pm.get("died") or not after:
            raise AssertionError(f"procmon was not restarted once with rows "
                                 f"after its death: {pm}, {after} rows")
        # the death hit the native daemon, and the restart started another
        native = [ln for ln in out.splitlines()
                  if ln.startswith("[INFO] procmon: ") and "/sysmon-" in ln]
        if len(native) != 2 or "Python fallback" in out:
            raise AssertionError(f"procmon did not run the native sysmon "
                                 f"twice (start, restart): {native}")
        if kt.get("status") != "timed_out" or kt.get("phase") != "harvest":
            raise AssertionError(f"kineto did not time out at harvest: {kt}")
        if "Complete!!" not in out:     # stat's analyze over the capture
            raise AssertionError(f"analyze failed: {out[-2000:]}")
        if status_rc != want_rc or want_rc != 1:
            raise AssertionError(f"status exited {status_rc}, render_status "
                                 f"says {want_rc}")
        return (f"procmon (native sysmon) died at 5 s, restarts "
                f"{pm['restarts']}, "
                f"{after} mpstat rows after the death; kineto "
                f"{kt['status']} at {kt['phase']}; launches {launches}; "
                f"analyze complete; status rc {status_rc} (render_status "
                f"{want_rc})")

    def robust_sticky(self):
        """stat over a 3-second command with procmon killed at 1 s and no
        restart budget."""
        cmd = f"{sys.executable} -c \"import time; time.sleep(3)\""
        _, logdir, _ = self.run_stat(
            "sticky", cmd, ("--collector_restarts", "0", "--inject_faults",
                            "procmon:die@1s"), healthy=False)
        doc, status_rc = self.check_manifest("sticky", logdir, False,
                                             cli=True)
        pm = doc["collectors"]["procmon"]
        with open(os.path.join(logdir, "hints.txt")) as f:
            hint = [h for h in f.read().splitlines()
                    if h.startswith("[self] collector procmon died mid-run")]
        if pm.get("status") != "died" or status_rc == 0 or not hint:
            raise AssertionError(f"the death was not sticky: {pm}, status "
                                 f"rc {status_rc}, hint {hint}")
        return f"procmon {pm['status']}, status rc {status_rc}; {hint[0]}"

    def robust_truncated(self):
        """A copy of the Llama-width capture, its Kineto JSON cut in half
        with no fault spec: quarantined by the real decoder."""
        from sofa_tpu_torch import telemetry

        import glob

        src = os.path.join(REPO, "build", "chip_smoke_profile_llama")
        copy = os.path.join(REPO, "build", "chip_smoke_robust_truncated")
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(src, copy)
        cache = os.path.join(copy, "_ingest_cache")

        def cached():
            return sorted(os.path.basename(p) for p in
                          glob.glob(os.path.join(cache, "kineto.key.json"))
                          + glob.glob(os.path.join(cache, "kineto__*")))

        r, _ = self.board_cli("preprocess", "--logdir", copy)  # warms it
        warm = cached()
        trace = sorted(os.listdir(os.path.join(copy, "kineto")))[0]
        path = os.path.join(copy, "kineto", trace)
        size = os.path.getsize(path)
        os.truncate(path, size // 2)
        r1, t1 = self.board_cli("preprocess", "--logdir", copy)
        ent = telemetry.load_manifest(copy)["sources"]["kineto"]
        left = cached()
        r2, _ = self.board_cli("analyze", "--logdir", copy)
        with open(os.path.join(copy, "hints.txt")) as f:
            hint = [h for h in f.read().splitlines()
                    if h.startswith("[self] ingest source kineto")]
        r3, _ = self.board_cli("preprocess", "--logdir", copy)
        again = telemetry.load_manifest(copy)["sources"]["kineto"]
        moved = os.path.join(copy, "_quarantine", trace)
        if r.returncode or r1.returncode or r3.returncode \
                or ent.get("status") != "quarantined" \
                or ent.get("quarantined_file") != moved \
                or not os.path.isfile(moved):
            raise AssertionError(f"the cut capture was not quarantined: "
                                 f"{ent}, {r1.stderr[-2000:]}")
        if "kineto.key.json" not in warm or len(warm) < 2 or left:
            raise AssertionError(f"the quarantine did not purge the warm "
                                 f"cache entry: {warm} before, {left} after")
        if r2.returncode or "Complete!!" not in r2.stdout or not hint:
            raise AssertionError(f"analyze gave no [self] hint: {hint}")
        if again.get("cache") == "hit":
            raise AssertionError(f"the quarantined source came back warm: "
                                 f"{again}")
        shutil.rmtree(copy, ignore_errors=True)
        return (f"{trace} cut from {size} to {size // 2} bytes: "
                f"{ent['status']} by preprocess in {t1:.3f} s "
                f"({ent['error'].rsplit(': ', 2)[-2][:60]}), its "
                f"{len(warm)} cache files purged; analyze: "
                f"{hint[0].split(' — ')[0]}; next preprocess "
                f"{again['status']} (cache {again['cache']})")

    def robust_cache(self):
        """Over the last ResNet-50 capture where the board phase left it
        (warm: its cache and chunk store): ``analyze --jobs 1`` alone over
        the store, then ``report --jobs 1`` in csv, each against the
        board's columnar report --jobs 1 of the same logdir."""
        wall, want = self.jobs1["resnet"]
        logdir = os.path.join(REPO, "build", "chip_smoke_resnet_r1")
        alone, stores = self.analyze_alone("resnet", logdir, want,
                                           ("--jobs", "1"))
        runs, _ = self.report_formats("resnet", logdir, (("csv", "warm"),),
                                      in_place=True, args=("--jobs", "1"))
        differ = sorted(k for k in set(want) | set(runs[0][1])
                        if want.get(k) != runs[0][1].get(k))
        if differ:
            raise AssertionError(f"csv and columnar reports differ: "
                                 f"{differ[:8]}")
        fmt = runs[0][2]["meta"]["ingest_cache"]["formats"]["kineto"]
        return (f"resnet: analyze --jobs 1 alone over {stores} chunk stores "
                f"{alone:.3f} s; report --jobs 1 warm, columnar {wall:.3f} s "
                f"(the board's), csv {runs[0][0]:.3f} s; cache format {fmt}; "
                f"{len(want)} files byte-identical")

    def analyze_alone(self, label, logdir, want, args=()):
        """``analyze`` in its own process over the frames preprocess left
        in ``logdir`` (each chunk store a lazy handle: every pass reads its
        declared columns only): features.csv, hints.txt, report.js and
        the tiles byte-identical to ``want``, a report's.  Returns (wall,
        the number of chunk stores)."""
        from sofa_tpu_torch.frames import frame_store_names

        stores = len(frame_store_names(logdir))
        r, wall = self.board_cli("analyze", "--logdir", logdir, *args)
        if r.returncode or "Complete!!" not in r.stdout:
            raise AssertionError(f"analyze alone over {label} failed: "
                                 f"{r.stderr[-2000:]}")
        got = self.outputs(logdir)
        differ = sorted(k for k in set(want) | set(got)
                        if want.get(k) != got.get(k))
        log(f"robust[formats]: {label} analyze alone {wall:.3f} s wall over "
            f"{stores} chunk stores; {len(got)} files, differing {differ}")
        if differ or (self.columnar and not stores):
            raise AssertionError(f"analyze alone over {label}'s chunk "
                                 f"stores ({stores}) differs from the "
                                 f"report: {differ[:8]}")
        return wall, stores

    def report_formats(self, label, src, sequence, in_place=False,
                       args=()):
        """``report`` over a cleaned copy of ``src`` (or over ``src``
        itself) once per (format, cold|warm) of ``sequence`` (cold: no
        ingest cache); every run's features.csv, hints.txt, report.js and
        tiles byte-identical to the first's, every warm run a cache hit.
        Returns ([(wall, outputs, manifest, stderr)], the logdir)."""
        from sofa_tpu_torch import telemetry

        copy = src
        if not in_place:
            copy = os.path.join(REPO, "build", f"chip_smoke_robust_{label}")
            shutil.rmtree(copy, ignore_errors=True)
            shutil.copytree(src, copy)
            self.board_cli("clean", "--logdir", copy)
        runs = []
        for fmt, kind in sequence:
            if kind == "cold":
                shutil.rmtree(os.path.join(copy, "_ingest_cache"),
                              ignore_errors=True)
            r, wall = self.board_cli("report", "--logdir", copy,
                                     "--trace_format", fmt, *args)
            if r.returncode or "Complete!!" not in r.stdout:
                raise AssertionError(f"report {label} {fmt} {kind} failed: "
                                     f"{r.stderr[-2000:]}")
            doc = telemetry.load_manifest(copy)
            fm = doc["meta"]["frames"]
            stages = {st["name"]: st["dur_s"] for st in doc["stages"]
                      if st["verb"] == "preprocess"
                      or st["name"] in ("load_frames", "passes")}
            log(f"robust[formats]: {label} report {fmt} {kind} {wall:.3f} s "
                f"wall; preprocess {doc['runs']['preprocess']['wall_s']:.3f}"
                f" s, analyze {doc['runs']['analyze']['wall_s']:.3f} s; "
                f"frames {fm['format']} ({fm['chunks']} chunks, "
                f"{fm['reused']} reused, {fm['bytes']} bytes, fallback "
                f"{fm.get('fallback')}); stages {stages}; kineto cache "
                f"{doc['sources']['kineto']['cache']}")
            if fm["format"] != (fmt if self.columnar else "csv"):
                raise AssertionError(f"meta.frames.format {fm['format']} "
                                     f"for --trace_format {fmt}")
            if kind == "warm" and doc["sources"]["kineto"]["cache"] != "hit":
                raise AssertionError(f"the warm report missed the cache "
                                     f"({label})")
            runs.append((wall, self.outputs(copy), doc, r.stderr))
        first = runs[0][1]
        for (fmt, kind), (_, got, _, _) in zip(sequence, runs):
            differ = sorted(k for k in set(first) | set(got)
                            if first.get(k) != got.get(k))
            if differ:
                raise AssertionError(f"report {label} {fmt} {kind} differs "
                                     f"from {sequence[0]}: {differ[:8]}")
        return runs, copy

    @staticmethod
    def outputs(logdir):
        """features.csv, hints.txt, report.js and the tiles, by path."""
        out = {}
        for p in sorted([os.path.join(logdir, n) for n in (
                "report.js", "features.csv", "hints.txt")]
                + glob.glob(os.path.join(logdir, "_tiles", "**", "*"),
                            recursive=True)):
            if os.path.isfile(p):
                with open(p, "rb") as f:
                    out[os.path.relpath(p, logdir)] = f.read()
        return out

    def check_clean(self, copy):
        """``clean`` removes the cache, the chunk store, the manifest, the
        self trace, the journal and the digests, and keeps the raw files
        and kineto/; returns what is left."""
        from sofa_tpu_torch.record import RAW_FILES

        r, _ = self.board_cli("clean", "--logdir", copy)
        left = set(os.listdir(copy))
        gone = {"_ingest_cache", "_frames", "run_manifest.json",
                "sofa_self_trace.json", "_journal.jsonl", "_digests.json"}
        if r.returncode or left & gone or \
                not (left & set(RAW_FILES)) or "kineto" not in left:
            raise AssertionError(f"clean left {sorted(left)}")
        return left

    # The JAX chaos matrix's kill points (tools/chaos_matrix.py:73-103): a
    # frame CSV write, a tile write, a chunk hash; the child SIGKILLs
    # itself at the n-th call, inside preprocess's derived writes.
    KILL_CHILD = (
        "import os, signal, sys\n"
        "logdir, point, n, viz = sys.argv[1], sys.argv[2], int(sys.argv[3]),"
        " int(sys.argv[4])\n"
        "from sofa_tpu_torch import frames, tiles, trace\n"
        "count = [0]\n"
        "def arm(orig):\n"
        "    def hook(*a, **kw):\n"
        "        count[0] += 1\n"
        "        if count[0] >= n:\n"
        "            os.kill(os.getpid(), signal.SIGKILL)\n"
        "        return orig(*a, **kw)\n"
        "    return hook\n"
        "if point == 'tiles':\n"
        "    tiles._write_tile = arm(tiles._write_tile)\n"
        "elif point == 'frame_chunks':\n"
        "    frames._chunk_sha = arm(frames._chunk_sha)\n"
        "else:\n"
        "    trace.write_csv = arm(trace.write_csv)\n"
        "from sofa_tpu_torch.config import SofaConfig\n"
        "from sofa_tpu_torch.preprocess import sofa_preprocess\n"
        "sofa_preprocess(SofaConfig(logdir=logdir, viz_downsample_to=viz))\n")

    def robust_durability(self):
        """The run journal, the digests and the chunk store over a copy of
        the Llama-width training capture (no card visible): (a) report in
        csv and in columnar, cold and warm, then analyze alone over the
        chunk stores, byte-identical; (b) a
        preprocess SIGKILLed at each kill point, then ``resume``; (c)
        damage of each fsck verdict, ``fsck``, ``fsck --repair``,
        ``status``; then ``clean``."""
        import contextlib
        import io

        from sofa_tpu_torch import durability
        from sofa_tpu_torch.config import SofaConfig
        from sofa_tpu_torch.kernels import HOPPER
        from sofa_tpu_torch.trace import WRITING_SENTINEL

        src = os.path.join(REPO, "build", "chip_smoke_profile_llama")
        try:
            import pyarrow
            arrow = f"pyarrow {pyarrow.__version__}"
        except ImportError:
            arrow = "no pyarrow"
        # pyramids on the frames too (the tile kill point writes tiles)
        rows = len(frame(src, "gputrace", ["timestamp"]))
        viz = min(10000, max(100, rows // 4))
        seq = (("csv", "cold"), ("csv", "warm"), ("columnar", "cold"),
               ("columnar", "warm"))
        runs, copy = self.report_formats(
            "llama", src, seq, args=("--viz_downsample_to", str(viz)))
        fmt = runs[2][2]["meta"]["frames"]["format"]
        alone, stores = self.analyze_alone(
            "llama", copy, runs[0][1], ("--viz_downsample_to", str(viz)))
        line = (f"{arrow}, columnar resolves to {fmt}; --viz_downsample_to "
                f"{viz} ({rows} gputrace rows); (a) report " + ", ".join(
                    f"{f} {c} {w:.3f} s" for (f, c), (w, _, _, _) in
                    zip(seq, runs)) + f", then analyze alone over {stores} "
                f"chunk stores {alone:.3f} s, {len(runs[0][1])} files "
                "byte-identical")
        if not self.columnar:
            if "falling back to csv" not in runs[2][3]:
                raise AssertionError("columnar without pyarrow gave no "
                                     "fallback warning")
            line += ("; without pyarrow the columnar runs warned and wrote "
                     "csv (meta.frames.format csv): no chunk store to kill "
                     "or damage")
        want_js = runs[-1][1]["report.js"]
        base = frame(copy, "gputrace")
        kills = []
        for point in ("frames", "tiles", "frame_chunks")[
                :3 if self.columnar else 2]:
            gone = {"tiles": "_tiles", "frame_chunks": "_frames"}.get(point)
            if gone:        # a warm run reuses these: make it write them
                shutil.rmtree(os.path.join(copy, gone))
            env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
            k = subprocess.run([sys.executable, "-c", self.KILL_CHILD, copy,
                                point, "3", str(viz)], cwd=REPO, env=env,
                               capture_output=True, text=True, timeout=600)
            left = os.path.exists(os.path.join(copy, WRITING_SENTINEL))
            # resume and fsck in this process (the verbs' functions; the
            # CLI's own parsing is held on the CPU), their output kept
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(out):
                res = durability.sofa_resume(
                    SofaConfig(logdir=copy, viz_downsample_to=viz))
                res_s = time.perf_counter() - t0
                fsck = durability.sofa_fsck(SofaConfig(logdir=copy))
            with open(os.path.join(copy, "report.js"), "rb") as f:
                same = f.read() == want_js
            gpu = frame(copy, "gputrace")
            held = {kk.name: int(gpu["name"].astype(str).str.contains(
                kk.name).sum()) for kk in HOPPER}
            kills.append(f"{point}: rc {k.returncode}, sentinel left "
                         f"{left}, resume rc {res} in {res_s:.1f} s, "
                         f"report.js identical {same}, fsck rc {fsck}, "
                         f"gputrace {len(gpu)} rows {held}")
            if k.returncode != -9 or not left or res or not same or fsck \
                    or len(gpu) != len(base) or not all(held.values()):
                raise AssertionError(f"resume after a kill at {point}: "
                                     f"{kills[-1]}; {k.stderr[-1500:]} "
                                     f"{out.getvalue()[-3000:]}")
        damage = self.damage(copy, self.columnar)
        bad, _ = self.board_cli("fsck", copy)
        st_bad, _ = self.board_cli("status", copy)
        named = {v: [rel for rel in rels
                     if f"{v:<9} {rel}" not in bad.stdout]
                 for v, rels in damage.items()}
        rep, rep_s = self.board_cli("fsck", copy, "--repair",
                                    "--viz_downsample_to", str(viz))
        doc, st_rc = self.check_manifest("durability", copy)
        integrity = [ln.strip() for ln in st_bad.stdout.splitlines()
                     if "integrity:" in ln]
        if bad.returncode != 1 or any(named.values()) or rep.returncode \
                or st_bad.returncode != 1 or not integrity \
                or not doc["meta"]["fsck"]["ok"]:
            raise AssertionError(f"fsck rc {bad.returncode}, unnamed "
                                 f"{named}, repair rc {rep.returncode}, "
                                 f"status rc {st_bad.returncode}: "
                                 f"{bad.stdout[-2000:]} {rep.stderr[-2000:]}")
        left = self.check_clean(copy)
        shutil.rmtree(copy, ignore_errors=True)
        return (line + "; (b) " + "; ".join(kills) + f"; (c) fsck rc 1 "
                f"naming {damage}, status rc {st_bad.returncode} "
                f"({integrity[0]}); --repair rc 0 in {rep_s:.1f} s, manifest"
                f" valid, status rc {st_rc}; clean kept {len(left)} raw "
                "entries and kineto/")

    @staticmethod
    def damage(logdir, chunk=True):
        """One artifact of each fsck verdict: a tile removed, a byte of a
        derived CSV and (``chunk``) of a chunk flipped under an unchanged
        mtime, a raw capture rewritten, a .tmp left; returns {verdict:
        [file]}."""
        def flip(rel, at):
            path = os.path.join(logdir, rel)
            st = os.stat(path)
            with open(path, "r+b") as f:
                f.seek(at(st.st_size))
                b = f.read(1)
                f.seek(-1, 1)
                f.write(bytes([b[0] ^ 1]))
            os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))

        tile = sorted(glob.glob(os.path.join(logdir, "_tiles", "*", "*",
                                             "*.json.gz")))[0]
        os.unlink(tile)
        flip("gpu_top_kernels.csv", lambda n: n // 2)
        corrupt = ["gpu_top_kernels.csv"]
        if chunk:
            corrupt.append("_frames/gputrace/000000.arrow")
            flip(corrupt[-1], lambda n: n // 3)
        trace = "kineto/" + sorted(os.listdir(os.path.join(logdir,
                                                           "kineto")))[0]
        with open(os.path.join(logdir, trace), "a") as f:
            f.write("\n")
        with open(os.path.join(logdir, "report.js.tmp"), "w") as f:
            f.write("torn")
        return {"missing": [os.path.relpath(tile, logdir)],
                "corrupt": corrupt,
                "stale": [trace], "orphaned": ["report.js.tmp"]}

    def robust_epilogue(self):
        """record --epilogue_deadline_s 5 over a child that writes a done,
        not-ok breadcrumb and sleeps 600 s."""
        logdir = os.path.join(REPO, "build", "chip_smoke_robust_epilogue")
        shutil.rmtree(logdir, ignore_errors=True)
        prog = ("import json, os, time; "
                "d = os.path.join(json.loads(os.environ['SOFA_TORCH_KINETO_"
                "OPTS'])['logdir'], '_inject'); "
                "json.dump({'pid': os.getpid(), 't': time.time(), "
                "'timeout_s': 0, 'grace_s': 0, 'done': True, 'ok': False}, "
                "open(os.path.join(d, 'atexit_stop.json'), 'w')); "
                "time.sleep(600)")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "sofa_tpu_torch", "record", "--logdir",
             logdir, "--epilogue_deadline_s", "5",
             f'{sys.executable} -c "{prog}"'], cwd=REPO,
            capture_output=True, text=True, timeout=120)
        wall = time.perf_counter() - t0
        warned = [ln for ln in r.stderr.splitlines()
                  if "trace may be partial" in ln]
        if wall > 30 or r.returncode != 143 or not warned:
            raise AssertionError(f"record did not cut the wedged epilogue: "
                                 f"{wall:.1f} s, rc {r.returncode}, "
                                 f"{r.stderr[-2000:]}")
        return f"record returned in {wall:.1f} s, rc 143; {warned[0]}"

    def robust_attach(self):
        """record --pid of an entry-forward serving run started in its own
        process; then report."""
        logdir = os.path.join(REPO, "build", "chip_smoke_robust_attach")
        shutil.rmtree(logdir, ignore_errors=True)
        target = subprocess.Popen(
            [sys.executable, "-m", "sofa_tpu_torch.entry", "--steps", "3",
             "--serve_requests", "4", "--serve_layers", "2"], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "sofa_tpu_torch", "record",
                 "--logdir", logdir, "--pid", str(target.pid)], cwd=REPO,
                capture_output=True, text=True, timeout=300)
            wall = time.perf_counter() - t0
            out, _ = target.communicate(timeout=60)
        finally:
            if target.poll() is None:
                target.kill()
                target.wait()
        with open(os.path.join(logdir, "misc.txt")) as f:
            misc = dict(ln.split(None, 1) for ln in f.read().splitlines())
        rep, _ = self.board_cli("report", "--logdir", logdir)
        mp = frame(logdir, "mpstat")
        served = [ln for ln in out.splitlines() if ln.startswith("serve:")]
        if r.returncode or int(misc["pid"]) != target.pid or not served:
            raise AssertionError(f"attach failed: rc {r.returncode}, misc "
                                 f"{misc}, {r.stderr[-2000:]}")
        if rep.returncode or "Complete!!" not in rep.stdout or mp.empty:
            raise AssertionError(f"report after attach failed: "
                                 f"{rep.stderr[-2000:]}")
        return (f"record --pid {target.pid} returned {wall:.1f} s later, "
                f"when the process exited ({served[0][:60]}...); misc.txt "
                f"pid {misc['pid']}; report complete, mpstat {len(mp)} rows")

    # -- cluster ----------------------------------------------------------------
    def cluster(self):
        """Two ``localhost`` hosts record the Llama-width training at batch
        1 on the one card at once (``record --cluster_hosts``), then
        ``report --cluster_hosts`` with no card visible merges them: each
        host's record healthy and its native sysmon running under its
        recorder, all three kernels launched as often as in the profile
        phase's run, one report.js with both hosts' series shifted by the
        difference of their time bases, and cluster_summary.csv."""
        import numpy as np
        import pandas as pd
        from sofa_tpu_torch.kernels import HOPPER
        from sofa_tpu_torch.trace import read_report_js_doc

        hosts = ["localhost", "127.0.0.1"]
        base = os.path.join(REPO, "build", "chip_smoke_cluster")
        host_dirs = {h: f"{base}-{h}" for h in hosts}
        for d in [base] + list(host_dirs.values()):
            shutil.rmtree(d, ignore_errors=True)
        steps = 3
        cmd = (f"{sys.executable} -m sofa_tpu_torch.workloads.transformer "
               f"--steps {steps} --batch 1 {LLAMA_WIDTH}")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "sofa_tpu_torch", "record",
             "--cluster_hosts", ",".join(hosts), "--logdir", base + "/",
             cmd], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        sysmons = {h: set() for h in hosts}
        lines = []
        reader = threading.Thread(target=lambda: lines.extend(proc.stdout),
                                  daemon=True)
        reader.start()
        try:
            while proc.poll() is None:
                for h, pids in self.cluster_sysmons(proc.pid, host_dirs):
                    sysmons[h] |= pids
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("the cluster record ran over 300 s")
                time.sleep(0.5)
        finally:
            if proc.poll() is None:
                proc.terminate()        # every host's recorder stops
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            reader.join(timeout=60)
        record_s = time.perf_counter() - t0
        out = "".join(lines)
        log("\n".join(f"  | {line}" for line in out.splitlines()
                      if line.startswith(("[WARNING]", "[PROGRESS]",
                                          "transformer:"))))
        log(f"cluster: record rc {proc.returncode} in {record_s:.1f} s; "
            f"sysmon pids seen under each host's recorder "
            f"{ {h: sorted(p) for h, p in sysmons.items()} }")
        if proc.returncode != 0:
            raise AssertionError(f"the cluster record failed: "
                                 f"{out[-3000:]}")
        if not all(sysmons.values()) or "Python fallback" in out:
            raise AssertionError("a host's procmon did not run the native "
                                 "sysmon under its recorder")
        for h, d in host_dirs.items():
            with open(os.path.join(d, "misc.txt")) as f:
                misc = dict(ln.split(None, 1) for ln in f.read().splitlines())
            if misc.get("rc") != "0":
                raise AssertionError(f"{h}: misc.txt says rc {misc.get('rc')}")
        t1 = time.perf_counter()
        r, _ = self.board_cli("report", "--cluster_hosts", ",".join(hosts),
                              "--logdir", base)
        report_s = time.perf_counter() - t1
        if r.returncode != 0 or r.stdout.count("Complete!!") != 2:
            raise AssertionError(f"the cluster report failed, rc "
                                 f"{r.returncode}: {r.stderr[-3000:]}")
        # each host: all three kernels, as many as the profile phase's run
        names = [k.name for k in HOPPER]
        peaks, bases, own = {}, {}, {}
        for h, d in host_dirs.items():
            # record's collectors and the report's sources, healthy
            self.check_manifest(f"cluster {h}", d)
            gpu = frame(d, "gputrace")
            kname = gpu[gpu["copyKind"] == 0]["name"].astype(str)
            got = {n: int(kname.str.contains(n).sum()) for n in names}
            feats = pd.read_csv(os.path.join(d, "features.csv"))
            feats = dict(zip(feats["name"], feats["value"]))
            peaks[h] = feats.get("gpu0_hbm_peak_gb")
            with open(os.path.join(d, "sofa_time.txt")) as f:
                bases[h] = float(f.read().split()[0])
            own[h] = read_report_js_doc(os.path.join(d, "report.js"))
            log(f"cluster[{h}]: launches {got} (profile phase "
                f"{self.llama_launches}); gpu0_hbm_peak_gb {peaks[h]}; "
                f"elapsed_time {feats.get('elapsed_time')} s; "
                f"elapsed_gpu_ratio {feats.get('elapsed_gpu_ratio')}; "
                f"gpu_step_busy_pct {feats.get('gpu_step_busy_pct')}")
            if got != self.llama_launches:
                raise AssertionError(f"{h}: flash launches {got}, the "
                                     f"profile phase's {self.llama_launches}")
        # the merged timeline
        doc = read_report_js_doc(os.path.join(base, "report.js"))
        merged = {s["name"]: s for s in doc["series"]}
        tb0 = min(bases.values())
        worst = 0.0
        for h in hosts:
            shift = bases[h] - tb0
            want = [f"{h}_{s['name']}" for s in own[h]["series"]]
            missing = [n for n in want if n not in merged]
            if missing or f"{h}_gpu_sofa_flash" not in merged:
                raise AssertionError(f"report.js lacks {missing} of {h}")
            # each merged point against its frame's rows plus the shift
            # (the merged series may be a downsampled subset)
            for name in ("gputrace", "hosttrace"):
                ts = frame(host_dirs[h], name, ["timestamp"])["timestamp"]
                expect = np.sort(ts.to_numpy() + shift)
                x = np.asarray(merged[f"{h}_{name}"]["data"]["x"])
                i = np.clip(np.searchsorted(expect, x), 1, len(expect) - 1)
                err = np.minimum(np.abs(x - expect[i - 1]),
                                 np.abs(x - expect[i]))
                worst = max(worst, float(err.max()))
        log(f"cluster: report {report_s:.1f} s; report.js meta.cluster_hosts "
            f"{doc['meta'].get('cluster_hosts')}, time_base "
            f"{doc['meta'].get('time_base')!r}, {len(merged)} series; "
            f"host time bases {bases}, shift "
            f"{bases[hosts[1]] - bases[hosts[0]]:.6f} s; merged gputrace and "
            f"hosttrace x off their host's CSV + shift by at most "
            f"{worst:.3g} s")
        if doc["meta"].get("cluster_hosts") != hosts or \
                doc["meta"].get("time_base") != tb0 or worst > 1e-6:
            raise AssertionError("the merged report.js is not the two hosts "
                                 "on one clock")
        summary = pd.read_csv(os.path.join(base, "cluster_summary.csv"))
        log("cluster: cluster_summary.csv\n" + summary.to_string(index=False))
        net_cols = [c for c in ("net_tx_total_bytes", "net_rx_total_bytes")
                    if c in summary.columns]
        # an interface that moved no bytes over the run is idle and gives
        # no netbandwidth rows (nor, as in the JAX package, net_* features)
        nics = {h: len(frame(d, "netbandwidth", ["timestamp"]))
                for h, d in host_dirs.items()}
        if list(summary["host"]) != hosts or "elapsed_time" not in summary \
                or (any(nics.values()) and len(net_cols) != 2):
            raise AssertionError(f"cluster_summary.csv is wrong: "
                                 f"{list(summary.columns)}")
        log(f"cluster: netbandwidth rows {nics}, net columns {net_cols}"
            + ("" if any(nics.values()) else ": no interface but lo (which "
               "the sampler skips) moved a byte during the run, so there "
               "are no net_* columns to check"))
        log(f"cluster: gpu0_hbm_peak_gb {peaks}; record {record_s:.1f} s, "
            f"report {report_s:.1f} s | {self.smi}")

    @staticmethod
    def cluster_sysmons(root, host_dirs):
        """(host, sysmon pids) for each host recorder under ``root``: the
        recorder is the process whose command line names the host's
        logdir, its sampler a descendant named sysmon-<hash>."""
        for pid in descendants(root):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = f.read().decode(errors="replace").split("\0")
            except OSError:
                continue
            if "record" not in argv or "--logdir" not in argv:
                continue
            logdir = argv[argv.index("--logdir") + 1].rstrip("/")
            host = next((h for h, d in host_dirs.items() if d == logdir),
                        None)
            if host is None:
                continue
            found = set()
            for child in descendants(pid):
                try:
                    with open(f"/proc/{child}/comm") as f:
                        if f.read().startswith("sysmon-"):
                            found.add(child)
                except OSError:
                    continue
            yield host, found

    # -- the single-run analysis verbs over the card's captures ---------------
    def top_probe(self, logdir):
        """While the Llama-width ``stat`` runs: once the memory sampler has
        written a device row and its card's name, ``top --once`` over the
        live logdir (no card visible); its output, rc and wall clock are
        kept for the ``verbs`` phase's cell (f)."""
        path = os.path.join(logdir, "gpumon.txt")
        t0 = time.time()
        self.live_top = None
        while time.time() - t0 < 180:
            try:
                with open(path) as f:
                    rows = [ln.split() for ln in f]
            except OSError:
                rows = []
            if os.path.isfile(path + ".meta.json") and any(
                    len(r) == 5 and r[1] == "0" for r in rows):
                break
            time.sleep(0.5)
        else:
            return
        r, wall = self.board_cli("top", "--once", "--logdir", logdir)
        self.live_top = (r.returncode, r.stdout + r.stderr, wall)

    def verbs(self):
        """The single-run analysis verbs (``diff``, ``whatif``, ``export``,
        ``top``) and the mining passes over the captures the card made,
        host only (no card visible), a line a cell: (a) AISI over the last
        ResNet-50 capture (step spans, kernel-name mining) and the
        Llama-width one; (b) HSG over the Llama-width capture; (c) ``diff``
        of the Llama-width capture (batch 4) against a cluster host's
        (batch 1), then of the serving capture against a byte copy of
        itself; (d) ``whatif`` over the ResNet-50 and the Llama-width
        captures; (e) ``export --perfetto --folded`` over the Llama-width
        capture, the native writer's file against the Python path's, and
        ``export --cluster_hosts``; (f) ``top --once`` during the
        Llama-width ``stat`` and over the finished capture; (g) no
        unattributed-kernel hint on the Llama-width capture."""
        build = os.path.join(REPO, "build")
        caps = {"llama": os.path.join(build, "chip_smoke_profile_llama"),
                "resnet": os.path.join(build, "chip_smoke_resnet_r1"),
                "self": os.path.join(build, "chip_smoke_cluster-localhost"),
                "cluster": os.path.join(build, "chip_smoke_cluster"),
                "host": os.path.join(build, "chip_smoke_cluster-127.0.0.1")}
        self.need("cluster")
        self.verb_times = {}
        for cell in (self.verbs_aisi, self.verbs_hsg, self.verbs_diff,
                     self.verbs_whatif, self.verbs_export, self.verbs_top,
                     self.verbs_hint):
            t0 = time.perf_counter()
            line = cell(caps)
            dt = time.perf_counter() - t0
            self.verb_times[cell.__name__[6:]] = dt
            log(f"verbs[{cell.__name__[6:]}]: {line} ({dt:.1f} s) | "
                f"{self.smi}")

    @staticmethod
    def viz_get(logdir, names):
        """``viz`` over ``logdir`` in its own process: the status of a GET of
        each name."""
        with viz_served(logdir, 8760, logdir) as (_port, get):
            return {name: get("/" + name)[0] for name in names}

    def verb_cli(self, label, *argv, want=0):
        """A verb with no card visible; raises unless it exits ``want``."""
        r, wall = self.board_cli(*argv)
        if r.returncode != want:
            raise AssertionError(f"{label}: `{' '.join(argv[:2])}` exited "
                                 f"{r.returncode}, expected {want}: "
                                 f"{(r.stdout + r.stderr)[-3000:]}")
        return r.stdout + r.stderr, wall

    def verbs_aisi(self, caps):
        """(a) ``analyze --enable_aisi --iterations_from steps`` over the
        ResNet-50 capture (exactly its 20 sofa_step ranges, through the
        registry), then the pass's kernel-name mining over the same frames
        in this process (20 +- 2, ``detect_iterations``' tolerance)."""
        import pandas as pd
        from sofa_tpu_torch.analysis.features import Features
        from sofa_tpu_torch.config import SofaConfig
        from sofa_tpu_torch.ml.aisi import sofa_aisi
        from sofa_tpu_torch.preprocess import load_frames

        logdir = caps["resnet"]
        _, wall = self.verb_cli("aisi steps", "analyze", "--logdir", logdir,
                                "--enable_aisi", "--iterations_from", "steps")
        steps_it = pd.read_csv(os.path.join(logdir, "iterations.csv"))
        t0 = time.perf_counter()
        # the frames the pass reads that this capture has (no strace here)
        frames = load_frames(SofaConfig(logdir=logdir), only=(
            "gputrace", "gpusteps", "hosttrace", "strace", "pystacks"))
        mined = sofa_aisi(frames, SofaConfig(logdir=logdir,
                                             iterations_from="op"),
                          Features())
        mine_s = time.perf_counter() - t0
        n_steps = len(frames["gpusteps"])
        mean_steps = float(frames["gpusteps"]["duration"].mean())
        n_s, m_s = len(steps_it), float(steps_it["step_time"].mean())
        n_o = 0 if mined is None else len(mined)
        if n_s != n_steps or n_steps != RESNET_STEPS:
            raise AssertionError(f"aisi from the steps: {n_s} iterations, "
                                 f"gpusteps {n_steps} rows")
        if abs(n_o - RESNET_STEPS) > 2:
            raise AssertionError(f"aisi by kernel-name mining: {n_o} "
                                 f"iterations, not {RESNET_STEPS} +- 2")
        return (f"ResNet-50: from the steps {n_s} iterations, mean "
                f"{m_s * 1e3:.3f} ms (analyze {wall:.1f} s); by kernel-name "
                f"mining over {len(frames['gputrace'])} device rows {n_o}, "
                f"mean {float(mined['step_time'].mean()) * 1e3:.3f} ms "
                f"({mine_s:.1f} s in process); the sofa_step ranges' mean "
                f"{mean_steps * 1e3:.3f} ms")

    def verbs_hsg(self, caps):
        """(a) and (b) over the Llama-width capture: ``analyze
        --enable_aisi --enable_hsg`` (both passes through the registry):
        iterations.csv a row per gpusteps row, every flash kernel launched
        inside a step starting inside an iteration; swarms_report.csv at
        most --num_swarms swarms; auto_caption.csv written; the
        iterations and swarms series merged into report.js."""
        import pandas as pd
        from sofa_tpu_torch.kernels import HOPPER
        from sofa_tpu_torch.trace import read_report_js_doc

        logdir = caps["llama"]
        swarms = 10
        out, wall = self.verb_cli("aisi+hsg", "analyze", "--logdir", logdir,
                                  "--enable_aisi", "--enable_hsg",
                                  "--num_swarms", str(swarms))
        it = pd.read_csv(os.path.join(logdir, "iterations.csv"))
        steps = frame(logdir, "gpusteps")
        gpu = frame(logdir, "gputrace")
        flash = gpu[gpu["name"].astype(str).str.contains("sofa_flash_")
                    & gpu["module"].astype(str).str.match(
                        r"sofa_step_\d+$")]
        ts = flash["timestamp"].to_numpy()
        inside = ((ts[:, None] >= it["begin"].to_numpy()[None, :])
                  & (ts[:, None] < it["end"].to_numpy()[None, :])).any(1)
        rep = pd.read_csv(os.path.join(logdir, "swarms_report.csv"))
        caption = os.path.join(logdir, "auto_caption.csv")
        doc = read_report_js_doc(os.path.join(logdir, "report.js"))
        names = {s["name"] for s in doc["series"]}
        per_kernel = {k.name: int(flash["name"].astype(str).str.contains(
            k.name).sum()) for k in HOPPER}
        if len(it) != len(steps) or not len(flash) or not inside.all():
            raise AssertionError(f"iterations.csv {len(it)} rows against "
                                 f"gpusteps {len(steps)}; flash kernels in "
                                 f"steps {len(flash)}, {int((~inside).sum())}"
                                 " outside every iteration")
        if not 0 < len(rep) <= swarms or not os.path.isfile(caption) \
                or "iterations" not in names \
                or not any(n.startswith("swarm_") for n in names):
            raise AssertionError(f"hsg: {len(rep)} swarms (at most "
                                 f"{swarms}), auto_caption.csv "
                                 f"{os.path.isfile(caption)}, series "
                                 f"{sorted(names)}")
        return (f"Llama width: {len(it)} iterations = gpusteps rows, "
                f"{len(flash)} flash launches in steps {per_kernel} all "
                f"inside an iteration, kernel time in the iterations "
                f"{float(it['kernel_time'].sum()) * 1e3:.1f} ms; "
                f"{len(rep)} swarms (at most {swarms}) over "
                f"{int(rep['samples'].sum())} samples, top "
                f"{str(rep['caption'].iloc[0])[:60]!r}; analyze {wall:.1f} s")

    def verbs_diff(self, caps):
        """(c) ``diff`` of the Llama-width capture at batch 4 (base) against
        a cluster host's at batch 1 (match): gpu_diff.csv holds the three
        flash kernels, each longer in the base; swarm_diff.csv and
        mem_diff.csv written; ``fsck`` 0 over the three logdirs; ``viz``
        serves diff-report.html and every CSV it names.  Then the other
        cluster host's capture against a byte copy of itself: every delta
        0."""
        import pandas as pd
        from sofa_tpu_torch.kernels import HOPPER

        out_dir = os.path.join(REPO, "build", "chip_smoke_diff")
        shutil.rmtree(out_dir, ignore_errors=True)
        _, wall = self.verb_cli("diff", "diff", "--base_logdir",
                                caps["llama"], "--match_logdir",
                                caps["host"], "--logdir", out_dir)
        gd = pd.read_csv(os.path.join(out_dir, "gpu_diff.csv"))
        rows = {}
        for k in HOPPER:
            sel = gd[gd["name"].astype(str).str.contains(k.name)]
            rows[k.name] = (float(sel["time_base"].sum()),
                            float(sel["time_match"].sum()))
        missing = [f for f in ("swarm_diff.csv", "mem_diff.csv")
                   if not os.path.isfile(os.path.join(out_dir, f))]
        if missing or not all(b > m > 0 for b, m in rows.values()):
            raise AssertionError(f"diff: flash kernel times (base, match) "
                                 f"{rows}; missing {missing}")
        fsck = {}
        for d in (caps["llama"], caps["host"], out_dir):
            r, _ = self.board_cli("fsck", d)
            fsck[os.path.basename(d)] = r.returncode
        if any(fsck.values()):
            raise AssertionError(f"fsck after diff: {fsck}")
        with open(os.path.join(out_dir, "diff-report.html")) as f:
            named = sorted(set(re.findall(r'"([\w.]+\.csv)"', f.read())))
        served = self.viz_get(out_dir, ["diff-report.html"] + named)
        if any(v != 200 for v in served.values()):
            raise AssertionError(f"viz over the diff: {served}")
        # a capture against a byte copy of itself
        copy = os.path.join(REPO, "build", "chip_smoke_diff_copy")
        self_dir = os.path.join(REPO, "build", "chip_smoke_diff_self")
        for d in (copy, self_dir):
            shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(caps["self"], copy)
        _, wall2 = self.verb_cli("diff self", "diff", "--base_logdir",
                                 caps["self"], "--match_logdir", copy,
                                 "--logdir", self_dir)
        deltas = {}
        for name, col in (("gpu_diff.csv", "delta"),
                          ("mem_diff.csv", "delta"),
                          ("swarm_diff.csv", "duration_delta")):
            t = pd.read_csv(os.path.join(self_dir, name))
            deltas[name] = (len(t), float(t[col].abs().max()))
        if any(n == 0 or d != 0 for n, d in deltas.values()):
            raise AssertionError(f"a capture against its copy: (rows, "
                                 f"max |delta|) {deltas}")
        return ("Llama width B 4 vs B 1, flash kernel ms (base, match) "
                + ", ".join(f"{n} ({b * 1e3:.2f}, {m * 1e3:.2f})"
                            for n, (b, m) in rows.items())
                + f", {len(gd)} kernels; diff {wall:.1f} s; fsck {fsck}; "
                f"viz {served}; a cluster host's capture against its copy: "
                f"(rows, max |delta|) {deltas}, diff {wall2:.1f} s")

    def verbs_whatif(self, caps):
        """(d) ``whatif --apply overlap:*,scale:*=sol`` over the ResNet-50
        capture: exit 0 calibrated (the zero-scenario identity inside the
        gate), a non-empty speed-of-light table, no predicted step longer
        than its measured one, meta.whatif and the report valid, whatif.html
        and the report served, ``fsck`` 0; over the Llama-width capture
        (3 steps): exit 1, uncalibrated for too few steps, and
        whatif_model.csv's compute classes holding the flash kernels."""
        import pandas as pd
        from sofa_tpu_torch import telemetry
        from sofa_tpu_torch.config import SofaConfig
        from sofa_tpu_torch.kernels import HOPPER
        from sofa_tpu_torch.tools.manifest_check import (validate_manifest,
                                                         validate_whatif)
        from sofa_tpu_torch.whatif.calibrate import MIN_CI_SAMPLES
        from sofa_tpu_torch.whatif.replay import load_sol_table

        logdir = caps["resnet"]
        out, wall = self.verb_cli("whatif", "whatif", logdir, "--apply",
                                  "overlap:*,scale:*=sol")
        with open(os.path.join(logdir, "whatif_report.json")) as f:
            doc = json.load(f)
        calib, pred = doc["calibration"], doc["predicted"]
        sol = load_sol_table(SofaConfig(logdir=logdir))
        longer = [s for s in doc["steps"]
                  if s["predicted_s"] > s["measured_s"]]
        probs = validate_manifest(telemetry.load_manifest(logdir)) \
            + validate_whatif(doc)
        meta = (telemetry.load_manifest(logdir).get("meta") or {}) \
            .get("whatif") or {}
        if calib["verdict"] != "calibrated" or calib["n_steps"] < \
                MIN_CI_SAMPLES or not sol or longer or probs \
                or meta.get("verdict") != "calibrated":
            raise AssertionError(f"whatif over ResNet-50: {calib}, sol "
                                 f"table {len(sol)} classes, {len(longer)} "
                                 f"steps predicted longer, problems {probs}")
        served = self.viz_get(logdir, ["whatif.html", "whatif_report.json"])
        if any(v != 200 for v in served.values()):
            raise AssertionError(f"viz over the whatif report: {served}")
        r, _ = self.board_cli("fsck", logdir)
        if r.returncode:
            raise AssertionError(f"fsck after whatif: {r.stdout[-2000:]}")
        att = ", ".join(f"{a['scenario']} {a['status']} "
                        f"{a['delta_pct']:.2f} %" for a in pred["attribution"])
        # the Llama-width capture: 3 steps, too few for the interval
        out2, wall2 = self.verb_cli("whatif llama", "whatif", caps["llama"],
                                    want=1)
        with open(os.path.join(caps["llama"], "whatif_report.json")) as f:
            reason = json.load(f)["calibration"]["reason"]
        model = pd.read_csv(os.path.join(caps["llama"], "whatif_model.csv"))
        compute = set(model.loc[model["kind"] == "compute", "cls"])
        flash = sorted(c for c in compute if c.startswith("sofa_flash_"))
        if "step sample(s)" not in reason or \
                flash != sorted(k.name for k in HOPPER):
            raise AssertionError(f"whatif over the Llama width: {reason!r}; "
                                 f"compute classes {sorted(compute)}")
        return (f"ResNet-50: {calib['verdict']}, {calib['n_steps']} steps, "
                f"identity error {calib['identity_error_pct']:.6f} %, "
                f"measured {calib['measured_mean_s'] * 1e3:.3f} ms, "
                f"predicted {pred['step_time_mean_s'] * 1e3:.3f} ms "
                f"(speedup {pred['speedup']}x; {att}; sol table {len(sol)} "
                f"classes); whatif {wall:.1f} s; viz {served}; Llama "
                f"width: exit 1, "
                f"{reason!r}; compute classes {flash} of {len(compute)}; "
                f"whatif {wall2:.1f} s")

    def verbs_export(self, caps):
        """(e) ``export --perfetto --folded`` over the Llama-width capture:
        a PDF of at least 2 pages and overview.png; trace.json.gz written
        by the native writer, with a sofa_flash_* slice per gputrace row of
        them, and byte-identical (decompressed) to the Python path's over
        the same frames; pystacks.folded and memprof.folded not empty.  Then
        ``export --cluster_hosts --perfetto``: both hosts' tracks, the
        second host's kernels shifted by the time bases' difference within
        1e-6 s."""
        import gzip

        import numpy as np
        from sofa_tpu_torch.config import SofaConfig
        from sofa_tpu_torch.export_perfetto import (PERFETTO_FRAMES,
                                                    export_perfetto)
        from sofa_tpu_torch.preprocess import load_frames

        logdir = caps["llama"]
        out, wall = self.verb_cli("export", "export", "--logdir", logdir,
                                  "--perfetto", "--folded")
        with open(os.path.join(logdir, "sofa_report.pdf"), "rb") as f:
            pages = max(int(m) for m in re.findall(rb"/Count (\d+)",
                                                   f.read()))
        png = os.path.getsize(os.path.join(logdir, "overview.png"))
        native = os.path.join(logdir, "trace.json.gz")
        with gzip.open(native, "rb") as f:
            text = f.read()
        events = json.loads(text)["traceEvents"]
        slices = sum(1 for e in events if e.get("cat") == "gpu_op"
                     and "sofa_flash_" in str(e.get("name", "")))
        gpu = frame(logdir, "gputrace", ["name"])
        rows = int(gpu["name"].astype(str).str.contains(
            "sofa_flash_").sum())
        folded = {n: os.path.getsize(os.path.join(logdir, n))
                  if os.path.isfile(os.path.join(logdir, n)) else 0
                  for n in ("pystacks.folded", "memprof.folded")}
        # the Python path over the same frames, in this process
        os.environ["SOFA_NATIVE_PERFETTO"] = "0"
        try:
            t0 = time.perf_counter()
            cfg = SofaConfig(logdir=logdir)
            export_perfetto(cfg, load_frames(cfg, only=PERFETTO_FRAMES),
                            out_name="trace.python.json.gz")
            py_s = time.perf_counter() - t0
        finally:
            del os.environ["SOFA_NATIVE_PERFETTO"]
        with gzip.open(os.path.join(logdir, "trace.python.json.gz"),
                       "rb") as f:
            same = f.read() == text
        os.unlink(os.path.join(logdir, "trace.python.json.gz"))
        if "(native writer;" not in out or not same:
            raise AssertionError(f"the native Perfetto writer did not write "
                                 f"the export, or its file differs from the "
                                 f"Python path's (same: {same}): "
                                 f"{out[-2000:]}")
        if pages < 2 or png <= 0 or slices != rows or not rows \
                or not all(folded.values()):
            raise AssertionError(f"export: {pages} PDF pages, overview.png "
                                 f"{png} bytes, {slices} sofa_flash_ slices "
                                 f"against {rows} gputrace rows, folded "
                                 f"{folded}")
        # every host on one clock
        hosts = ["localhost", "127.0.0.1"]
        base = caps["cluster"]
        _, wall_c = self.verb_cli("export cluster", "export",
                                  "--cluster_hosts", ",".join(hosts),
                                  "--logdir", base, "--perfetto")
        with gzip.open(os.path.join(base, "trace.json.gz"), "rb") as f:
            cev = json.loads(f.read())["traceEvents"]
        procs = sorted(e["args"]["name"] for e in cev
                       if e.get("name") == "process_name")
        bases = {}
        for h in hosts:
            with open(os.path.join(f"{base}-{h}", "sofa_time.txt")) as f:
                bases[h] = float(f.read().split()[0])
        shift = bases[hosts[1]] - min(bases.values())
        want = np.sort(frame(f"{base}-{hosts[1]}", "gputrace",
                             ["timestamp"])["timestamp"].to_numpy() + shift)
        got = np.sort([e["ts"] / 1e6 for e in cev
                       if e.get("cat") == "gpu_op" and e.get("pid") == 256])
        worst = float(np.abs(got - want).max()) if len(got) == len(want) \
            else float("inf")
        if not {"gpu0", "gpu256", "host0", "host1"} <= set(procs) \
                or worst > 1e-6:
            raise AssertionError(f"cluster export: processes {procs}, "
                                 f"{len(got)} kernels of the second host "
                                 f"against {len(want)}, off by {worst}")
        return (f"Llama width: {pages} PDF pages, overview.png {png} bytes, "
                f"trace.json.gz {len(events)} events ({slices} sofa_flash_ "
                f"slices = gputrace's {rows}) by the native writer, "
                f"decompressed byte-identical to the Python path's "
                f"({py_s:.2f} s in process), folded {folded}; export "
                f"{wall:.1f} s; cluster: processes {procs}, second host "
                f"shifted {shift:.6f} s, off by {worst:.3g} s; export "
                f"{wall_c:.1f} s")

    def verbs_top(self, caps):
        """(f) ``top --once`` during the Llama-width ``stat`` (the profile
        phase's probe): the device line names the card, its memory is the
        sampler's, the sample under 5 s old; then over the finished
        capture: the same device line from the files."""
        from sofa_tpu_torch.top import LIVE_S

        name = self.torch.cuda.get_device_name(0)
        total = self.torch.cuda.get_device_properties(0).total_memory
        if self.live_top is None:
            raise AssertionError("top never saw the Llama-width run's "
                                 "sampler while it ran")
        rc, live, live_wall = self.live_top
        out, wall = self.verb_cli("top", "top", "--once", "--logdir",
                                  caps["llama"])

        def gpu_line(text):
            return next((ln for ln in text.splitlines()
                         if ln.startswith("gpu0 ")), "")

        age = re.search(r"sample\s+([\d.]+)s ago", live)
        limit = f"/{total / 1e9:.2f} GB"
        with open(os.path.join(caps["llama"], "gpumon.txt")) as f:
            last = [ln.split() for ln in f if ln.split()[1:2] == ["0"]][-1]
        used = f"{int(last[2]) / 1e9:6.2f}{limit}"
        for label, text in (("live", live), ("finished", out)):
            ln = gpu_line(text)
            if name not in ln or limit not in ln:
                raise AssertionError(f"top ({label}): no device line naming "
                                     f"{name} with the sampler's memory: "
                                     f"{text[-2000:]}")
        if rc or age is None or float(age.group(1)) >= LIVE_S \
                or used not in gpu_line(out):
            raise AssertionError(f"top: live rc {rc}, sample age "
                                 f"{age and age.group(1)} s (limit {LIVE_S}); "
                                 f"finished line {gpu_line(out)!r}, the last "
                                 f"sample {used!r}")
        return (f"live: {gpu_line(live)!r}, sample {age.group(1)} s old "
                f"(top {live_wall:.1f} s); finished: {gpu_line(out)!r} "
                f"(top {wall:.1f} s)")

    def verbs_hint(self, caps):
        """(g) The unattributed-kernel rule over the Llama-width capture
        (trace level 2, every flash launch inside its cost range): no
        hint.  Logs the kernels no cost reaches by the aten op around them
        (ops costs.py does not model), which the rule leaves out."""
        import pandas as pd

        logdir = caps["llama"]
        feats = pd.read_csv(os.path.join(logdir, "features.csv"))
        feats = dict(zip(feats["name"], feats["value"]))
        hints = []
        if os.path.isfile(os.path.join(logdir, "hints.txt")):
            with open(os.path.join(logdir, "hints.txt")) as f:
                hints = f.read().splitlines()
        fired = [h for h in hints if h.startswith("unattributed kernel")]
        unattr = feats.get("gpu_unattributed_kernel_time")
        total = sum(float(v) for k, v in feats.items()
                    if re.fullmatch(r"gpu\d+_kernel_time", k))
        gpu = frame(logdir, "gputrace", ["name", "hlo_category", "flops",
                                         "duration", "copyKind", "op_path"])
        kern = gpu[gpu["copyKind"] == 0]
        flash = kern[kern["name"].astype(str).str.contains("sofa_flash_")]
        costed = bool((flash["hlo_category"].astype(str).str.startswith(
            "sofa_flash_") & (flash["flops"] > 0)).all())
        bare = kern[(kern["hlo_category"] == "kernel")
                    & (kern["flops"] <= 0)]
        op = bare["op_path"].astype(str).str.extract(
            r".*(aten::[^/]+)")[0].fillna("(no aten op)")
        by_op = bare["duration"].groupby(op).sum().sort_values(
            ascending=False)
        if fired or not costed or kern["flops"].isna().any():
            raise AssertionError(f"the unattributed-kernel hint fired "
                                 f"({fired}), a flash launch lacks its cost "
                                 f"range ({not costed}), or the trace is "
                                 "below level 2")
        return (f"gpu_unattributed_kernel_time {unattr} s of {total:.4f} s "
                f"kernel time; every one of {len(flash)} flash launches "
                f"owned by its cost range; no hint; kernels no cost reaches "
                f"inside aten ops costs.py does not model: "
                f"{float(bare['duration'].sum()) * 1e3:.1f} ms, "
                + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in
                            by_op.head(5).items()))

    # -- the ring: four ranks' hops in lockstep on the one card -------------
    # -- the archive ------------------------------------------------------------
    def archive(self):
        """The trace archive and ``regress`` over the ResNet-50 and
        Llama-width captures (no card visible; the ResNet-50 one reported
        back to the columnar store first), a line a cell: (a) each
        ingested twice into a fresh root (the second: the same run id, no
        object, no byte, one catalog line), each run doc holding the
        gputrace chunks and the Kineto trace, ``archive show`` printing
        the gpu0_ features, ``archive ls`` 2 runs in 4 ingests; (b)
        ``regress`` of the Llama-width run against itself (all noise, rc
        0), of the ResNet-50 run against it (a verdict the port's
        validate_verdict accepts, rc 1 exactly when it is regressed), and
        ``--rolling 3`` (noise: the history is short; rc 0); (c) ``fsck``
        of the root 0, then an object's byte flipped and 6 bytes written
        into an index chunk's strings: ``fsck`` 1 naming both, ``fsck
        --repair`` 0, ``fsck`` 0, ``manifest_check`` accepting the index;
        (d) an ingest of a copy of the Llama-width capture SIGKILLed at its
        ARCHIVE_KILL_AT-th stored file, ``resume`` 0: the uninterrupted
        run id in the catalog, the root's fsck clean."""
        self.need("llama")
        self.need("board")
        t_phase = time.perf_counter()
        build = os.path.join(REPO, "build")
        caps = {"resnet": os.path.join(build, "chip_smoke_resnet_r1"),
                "llama": os.path.join(build, "chip_smoke_profile_llama")}
        root = os.path.join(build, "chip_smoke_archive")
        shutil.rmtree(root, ignore_errors=True)
        # the cache phase left the ResNet-50 capture's frames in csv: back
        # to the default columnar store (warm), whose chunks get archived
        out, wall = self.archive_cli("report resnet", "report", "--logdir",
                                     caps["resnet"], "--jobs", "4")
        if "Complete!!" not in out:
            raise AssertionError(f"report resnet: {out[-2000:]}")
        log(f"archive[report]: the ResNet-50 capture back to columnar in "
            f"{wall:.1f} s | {self.smi}")
        runs = {}
        for cell in (self.archive_ingest, self.archive_regress,
                     self.archive_fsck):
            t0 = time.perf_counter()
            line = cell(caps, root, runs)
            log(f"archive[{cell.__name__[8:]}]: {line} "
                f"({time.perf_counter() - t0:.1f} s) | {self.smi}")
        t0 = time.perf_counter()
        line = self.archive_kill(caps["llama"], runs["llama"])
        log(f"archive[kill]: {line} ({time.perf_counter() - t0:.1f} s) | "
            f"{self.smi}")
        log(f"archive: phase {time.perf_counter() - t_phase:.1f} s | "
            f"{self.smi}")

    def archive_cli(self, label, *argv, want=0):
        """An archive verb with no card visible; raises unless it exits
        ``want``; returns its output and wall seconds."""
        r, wall = self.board_cli(*argv)
        if r.returncode != want:
            raise AssertionError(f"archive[{label}]: `{' '.join(argv)}` "
                                 f"exited {r.returncode}, expected {want}: "
                                 f"{(r.stdout + r.stderr)[-3000:]}")
        return r.stdout + r.stderr, wall

    def archive_ingest(self, caps, root, runs):
        """(a) two ingests of each capture, the run docs, show and ls."""
        from sofa_tpu_torch import telemetry
        from sofa_tpu_torch.archive import catalog
        from sofa_tpu_torch.archive.store import ArchiveStore

        store = ArchiveStore(root)
        walls, parts = {}, []
        for label, logdir in caps.items():
            got = []
            for i in range(2):
                lines = len(catalog.read_catalog(root))
                _out, wall = self.archive_cli(
                    f"ingest {label}", "archive", logdir, "--archive_root",
                    root, "--label", label)
                walls[f"{label}{i + 1}"] = wall
                meta = telemetry.load_manifest(logdir)["meta"]["archive"]
                if len(catalog.read_catalog(root)) != lines + 1:
                    raise AssertionError(f"{label}: the ingest did not add "
                                         "one catalog line")
                got.append(meta)
            first, second = got
            if second["run"] != first["run"] or second["new_objects"] \
                    or second["bytes_added"] or not first["new_objects"]:
                raise AssertionError(f"{label}: the second ingest is not "
                                     f"a catalog line only: {got}")
            runs[label] = first["run"]
            files = store.load_run(first["run"])["files"]
            chunks = [r for r in files
                      if r.startswith("_frames/gputrace/")
                      and r.endswith(".arrow")]
            kineto = [r for r in files if r.startswith("kineto/")]
            if not chunks or "_frames/gputrace/frame_index.json" not in \
                    files or not kineto:
                raise AssertionError(f"{label}: the run doc lacks the "
                                     "gputrace chunks or the Kineto trace")
            parts.append(
                f"{label} run {first['run'][:12]}: {first['files']} files, "
                f"{first['new_objects']} objects, {first['bytes_added']} "
                f"bytes, then {second['new_objects']} objects and "
                f"{second['bytes_added']} bytes; {len(chunks)} gputrace "
                f"chunk(s), {len(kineto)} Kineto file(s)")
        shown, _ = self.archive_cli("show", "archive", "show",
                                    runs["llama"][:12], "--archive_root",
                                    root)
        gpu = [ln.split()[0] for ln in shown.splitlines()
               if ln.strip().startswith("gpu0_")]
        if not gpu:
            raise AssertionError(f"show prints no gpu0_ feature: "
                                 f"{shown[-2000:]}")
        listed, _ = self.archive_cli("ls", "archive", "ls", "--archive_root",
                                     root)
        n_ingests = sum(1 for e in catalog.read_catalog(root)
                        if e.get("ev") == "ingest")
        if "2 run(s)" not in listed or n_ingests != 4:
            raise AssertionError(f"ls: {listed[-2000:]} ({n_ingests} "
                                 "ingests)")
        store_bytes = sum(os.path.getsize(os.path.join(d, n))
                          for d, _, ns in os.walk(root) for n in ns)
        return ("; ".join(parts) + f"; show (llama): {len(gpu)} gpu0_ "
                f"features; ls 2 runs in {n_ingests} ingests; "
                f"store {store_bytes} bytes; ingest walls "
                + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))

    def archive_regress(self, caps, root, runs):
        """(b) regress: the Llama-width run against itself, the ResNet-50
        run against it, and a rolling baseline of 3."""
        from sofa_tpu_torch.tools.manifest_check import validate_verdict

        def verdict(label, want, *argv):
            out, wall = self.archive_cli(label, "regress", *argv,
                                         "--archive_root", root, want=want)
            with open(os.path.join(root, "regress_verdict.json")) as f:
                doc = json.load(f)
            probs = validate_verdict(doc)
            if probs:
                raise AssertionError(f"regress {label}: {probs}")
            return doc, wall

        llama, resnet = runs["llama"][:12], runs["resnet"][:12]
        same, same_s = verdict("self", 0, llama, llama)
        if same["verdict"] != "noise" or any(
                r["verdict"] != "noise" for r in same["features"]):
            raise AssertionError(f"the run against itself: {same['counts']}")
        r, cross_s = self.board_cli("regress", resnet, llama,
                                    "--archive_root", root)
        with open(os.path.join(root, "regress_verdict.json")) as f:
            cross = json.load(f)
        if validate_verdict(cross) or r.returncode != (
                1 if cross["verdict"] == "regressed" else 0):
            raise AssertionError(f"ResNet-50 against Llama: rc "
                                 f"{r.returncode}, {cross['verdict']}, "
                                 f"{validate_verdict(cross)}")
        worst = [f"{x['name']} x{x['ratio']:.3g}" if isinstance(
                     x["ratio"], float) else f"{x['name']} {x['ratio']}"
                 for x in cross["features"] if x["verdict"] == "regressed"]
        rolling, rolling_s = verdict("rolling", 0, llama, "--rolling", "3")
        if rolling["verdict"] != "noise" or \
                rolling["baseline"]["mode"] != "rolling":
            raise AssertionError(f"rolling: {rolling['counts']}")
        short = {r["reason"] for r in rolling["features"]
                 if "baseline sample" in r.get("reason", "")}
        if not short:
            raise AssertionError("rolling: no verdict says the history is "
                                 "short")
        return (f"self: {same['counts']} rc 0 in {same_s:.2f} s; ResNet-50 "
                f"vs Llama: {cross['verdict']} {cross['counts']} rc "
                f"{r.returncode} in {cross_s:.2f} s, regressed e.g. "
                f"{worst[:4]}; rolling 3: {rolling['verdict']} "
                f"{rolling['counts']} ({sorted(short)[0]}) rc 0 in "
                f"{rolling_s:.2f} s")

    @staticmethod
    def archive_rot_index(root):
        """6 bytes into the middle of the feature names of the index's
        first features chunk; returns its root-relative path."""
        rel = "_index/features/000000.arrow"
        path = os.path.join(root, rel)
        with open(path, "rb") as f:
            data = f.read()
        hits = [m.start() for m in re.finditer(rb"gpu0_", data)]
        with open(path, "r+b") as f:
            f.seek(hits[len(hits) // 2] + 2)
            f.write(b"\xde\xad\xbe\xef\xde\xad")
        return rel

    def archive_fsck(self, caps, root, runs):
        """(c) fsck over the root, damage, repair."""
        from sofa_tpu_torch.archive.store import ArchiveStore
        from sofa_tpu_torch.tools.manifest_check import check_archive_index

        clean, clean_s = self.archive_cli("fsck", "fsck", root)
        store = ArchiveStore(root)
        sha = store.load_run(runs["llama"])["files"][
            "_frames/gputrace/000000.arrow"]["sha256"]
        obj = os.path.relpath(store.object_path(sha), root)
        with open(store.object_path(sha), "r+b") as f:
            f.seek(os.path.getsize(store.object_path(sha)) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 1]))
        idx = self.archive_rot_index(root)
        found, found_s = self.archive_cli("fsck damaged", "fsck", root,
                                          want=1)
        named = [f"corrupt     {obj}" in found, f"index       {idx}" in found]
        if not all(named):
            raise AssertionError(f"fsck did not name {obj} and {idx}: "
                                 f"{found[-3000:]}")
        repaired, repair_s = self.archive_cli("repair", "fsck", root,
                                              "--repair")
        after, after_s = self.archive_cli("fsck after", "fsck", root)
        probs = check_archive_index(root)
        if probs:
            raise AssertionError(f"manifest_check: {probs}")
        restored = [ln.strip() for ln in repaired.splitlines()
                    if "restored object" in ln or "rebuilt it" in ln]
        checked = [ln for ln in after.splitlines()
                   if "object(s) verified" in ln]
        return (f"fsck 0 in {clean_s:.2f} s; flipped {obj[:20]}.. and "
                f"rotted {idx}: fsck 1 naming both in {found_s:.2f} s; "
                f"--repair 0 in {repair_s:.2f} s ({len(restored)} repair "
                f"lines); fsck 0 in {after_s:.2f} s "
                f"({checked[0].split('] ')[-1] if checked else ''}); "
                "manifest_check 0")

    def archive_kill(self, src, run_id):
        """(d) a copy of the Llama-width capture, its ingest SIGKILLed at
        the ARCHIVE_KILL_AT-th stored file, then ``resume``."""
        from sofa_tpu_torch.archive import catalog
        from sofa_tpu_torch.archive.store import archive_fsck

        copy = os.path.join(REPO, "build", "chip_smoke_archive_kill")
        root = copy + "_root"
        for d in (copy, root):
            shutil.rmtree(d, ignore_errors=True)
        t0 = time.perf_counter()
        # the ingest cache is not archived, and resume replays no parse
        shutil.copytree(src, copy,
                        ignore=shutil.ignore_patterns("_ingest_cache"))
        copy_s = time.perf_counter() - t0
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        k = subprocess.run([sys.executable, "-c", self.ARCHIVE_KILL_CHILD,
                            copy, root, str(ARCHIVE_KILL_AT)], cwd=REPO,
                           env=env, capture_output=True, text=True,
                           timeout=600)
        stored = sum(len(ns) for _d, _s, ns in
                     os.walk(os.path.join(root, "objects")))
        res, res_s = self.board_cli("resume", copy)
        entries = catalog.ingest_entries(catalog.read_catalog(root))
        report = archive_fsck(root)
        damage = {v: report[v] for v in ("corrupt", "missing", "orphaned",
                                         "uncataloged", "index")
                  if report[v]} if report else {"root": "none"}
        line = (f"copy in {copy_s:.1f} s, the ingest killed at stored file "
                f"{ARCHIVE_KILL_AT} rc {k.returncode} ({stored} objects "
                f"landed), resume rc {res.returncode} in {res_s:.1f} s, "
                f"catalog {[e['run'][:12] for e in entries]} (uninterrupted "
                f"{run_id[:12]}), fsck {damage or 'clean'}")
        if k.returncode != -9 or res.returncode or \
                [e["run"] for e in entries] != [run_id] or damage:
            raise AssertionError(f"archive kill: {line}; {k.stderr[-1500:]}"
                                 f" {res.stdout[-1500:]}")
        return line

    # The JAX chaos matrix's kill-mid-archive cell
    # (tools/chaos_matrix.py:149-164, 302-352): the ingest SIGKILLs itself
    # at the n-th put_file.
    ARCHIVE_KILL_CHILD = (
        "import os, signal, sys\n"
        "logdir, root, n = sys.argv[1], sys.argv[2], int(sys.argv[3])\n"
        "from sofa_tpu_torch.archive import store\n"
        "count = [0]\n"
        "orig = store.ArchiveStore.put_file\n"
        "def hook(self, *a, **kw):\n"
        "    count[0] += 1\n"
        "    if count[0] >= n:\n"
        "        os.kill(os.getpid(), signal.SIGKILL)\n"
        "    return orig(self, *a, **kw)\n"
        "store.ArchiveStore.put_file = hook\n"
        "from sofa_tpu_torch.config import SofaConfig\n"
        "store.ingest_run(SofaConfig(logdir=logdir), root)\n")

    # -- the fleet: serve and agent -------------------------------------------
    def fleet_push(self):
        """The fleet transport over the ResNet-50 and Llama-width captures
        (no card visible; each ``serve`` and each ``agent --once`` a child
        process on loopback, each agent over copies of the captures), a
        line a cell: (a) ``agent --once`` delivers both (rc 0, the tenant's
        catalog 2 runs, each server run id its spooled one, each manifest's
        meta.agent.push pushed with meta.serve, the port's manifest_check
        accepting it); (b) again with the delivered flags cleared: rc 0, 0
        objects and 0 bytes sent, no catalog line; (c) the Llama-width copy
        with a fresh spool into a fresh tenant under
        ``service:partial@0.5`` and under ``service:conn_reset``: one run
        each, the tenant fsck-clean; (d) a service started with
        ``SOFA_SERVE_EXIT_AFTER=4`` exits 86 mid-upload, the agent rc 1,
        the spool holding the run fsck-clean, a restarted service taking
        the retry (rc 0, one run, meta.serve); (e) two agents with spools
        of their own push two copies of the Llama-width capture into one
        tenant at once: both rc 0, one run, fsck clean; (f) three WAL
        records seeded in a tenant held mid-gc, SIGTERM: the service
        drains them and exits 0 (its ``serve handled:`` line: a
        422_hash_mismatch from (c), no 500, no traceback), and ``fsck``
        of the fleet root exits 0."""
        self.need("archive")
        t_phase = time.perf_counter()
        base = os.path.join(REPO, "build", "chip_smoke_fleet")
        shutil.rmtree(base, ignore_errors=True)
        build = os.path.join(REPO, "build")
        caps = {"resnet": os.path.join(build, "chip_smoke_resnet_r1"),
                "llama": os.path.join(build, "chip_smoke_profile_llama")}
        t0 = time.perf_counter()
        watch = os.path.join(base, "watch")
        copies = {label: os.path.join(watch, label) for label in caps}
        copies["llama2"] = os.path.join(base, "llama2")
        for label, dest in copies.items():
            shutil.copytree(caps[label.rstrip("2")], dest,
                            ignore=shutil.ignore_patterns("_ingest_cache"))
        log(f"fleet[copy]: the captures copied in "
            f"{time.perf_counter() - t0:.1f} s | {self.smi}")
        root = os.path.join(base, "root")
        proc, url, slog = self.fleet_serve(root, "main")
        try:
            for cell in (self.fleet_first, self.fleet_again,
                         self.fleet_faults):
                t0 = time.perf_counter()
                line = cell(url, root, base, copies)
                log(f"fleet[{cell.__name__[6:]}]: {line} "
                    f"({time.perf_counter() - t0:.1f} s) | {self.smi}")
            t0 = time.perf_counter()
            line = self.fleet_kill(base, copies["llama"])
            log(f"fleet[kill]: {line} ({time.perf_counter() - t0:.1f} s) "
                f"| {self.smi}")
            t0 = time.perf_counter()
            line = self.fleet_concurrent(url, root, base, copies)
            log(f"fleet[concurrent]: {line} "
                f"({time.perf_counter() - t0:.1f} s) | {self.smi}")
            t0 = time.perf_counter()
            line = self.fleet_term(proc, root, slog)
            log(f"fleet[term]: {line} ({time.perf_counter() - t0:.1f} s) | "
                f"{self.smi}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        log(f"fleet_push: phase {time.perf_counter() - t_phase:.1f} s | "
            f"{self.smi}")

    FLEET_TOKEN = "chip-smoke-fleet-token"

    def tooling(self):
        """The project's own checks over the port's tree and copies of the
        Llama-width and ResNet-50 captures, cells (a)-(d) as the module
        docstring says; a line a cell, then the phase's seconds."""
        self.need("llama")
        self.need("archive")        # the last phase that rewrites a capture
        t_phase = time.perf_counter()
        base = os.path.join(REPO, "build", "chip_smoke_tooling")
        shutil.rmtree(base, ignore_errors=True)
        os.makedirs(base)

        def timed(cell):
            t0 = time.perf_counter()
            line = cell(base)
            log(f"tooling[{cell.__name__[8:]}]: {line} "
                f"({time.perf_counter() - t0:.1f} s) | {self.smi}")

        self.tooling_together([
            lambda c=cell: timed(c)
            for cell in (self.tooling_lint, self.tooling_artifacts,
                         self.tooling_protocol, self.tooling_setup)])
        log(f"tooling: phase {time.perf_counter() - t_phase:.1f} s | "
            f"{self.smi}")

    def examples(self):
        """The five examples side by side, each in its own process on the
        card, their output appended to one log; ``train_tiny`` under
        ``stat`` and ``long_context`` under ``stat --enable_aisi`` (both at
        head dim 16: the three general kernels in gputrace and no Hopper
        kernel; long_context's steps in iterations.csv); ``edr`` watching
        the log meanwhile, which fires on train_tiny's "final loss" a 2 s
        ``record`` whose ``report`` must end with Complete!!.  A line an
        example, then the phase's seconds."""
        from sofa_tpu_torch import kernels

        t_phase = time.perf_counter()
        base = os.path.join(REPO, "build", "chip_smoke_examples")
        shutil.rmtree(base, ignore_errors=True)
        os.makedirs(base)
        app_log = os.path.join(base, "examples.log")
        open(app_log, "w").close()
        host_only = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        edr = subprocess.Popen(
            [sys.executable, "-m", "sofa_tpu_torch.tools.edr", "--log",
             app_log, "--trigger", "final loss=train", "--record_seconds",
             "2", "--logdir", os.path.join(base, "edr/"), "--poll_s", "0.2",
             "--timeout_s", "600"], cwd=REPO, env=host_only,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lock = threading.Lock()

        def example(name, want):
            """One example in its own process, in the examples' directory
            (io_churn writes there) with the package importable from the
            checkout; its output goes into the log when it ends."""
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", f"sofa_tpu_torch.examples.{name}"],
                cwd=base, env=dict(os.environ, PYTHONPATH=REPO),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=300)
            with lock, open(app_log, "a") as f:
                f.write(r.stdout)
            last = (r.stdout.rstrip().splitlines() or [""])[-1]
            log(f"examples[{name}]: rc {r.returncode} in "
                f"{time.perf_counter() - t0:.1f} s: {last!r} | {self.smi}")
            if r.returncode != 0 or want not in last:
                raise AssertionError(f"example {name} failed: {last!r}")

        def general_rows(label, logdir):
            """Each kernel's gputrace rows; the general kernels must all
            be there and no Hopper kernel (head dim 16)."""
            names = frame(logdir, "gputrace")["name"].astype(str)
            launches = {k.name: int(names.str.contains(k.name).sum())
                        for k in kernels.KERNELS}
            if any(launches[k.name] == 0 for k in kernels.GENERAL) or any(
                    launches[k.name] for k in kernels.HOPPER):
                raise AssertionError(f"{label}: the capture does not hold "
                                     f"the three general kernels alone: "
                                     f"{launches}")
            return launches

        def train_tiny():
            """train_tiny under stat; its output goes into the log when it
            ends (edr fires on its "final loss")."""
            t0 = time.perf_counter()
            feats, logdir, out = self.run_stat(
                "examples_train_tiny",
                "python -m sofa_tpu_torch.examples.train_tiny")
            with lock, open(app_log, "a") as f:
                f.write(out)
            line = next((ln for ln in out.splitlines()
                         if "final loss" in ln), "")
            launches = general_rows("train_tiny", logdir)
            log(f"examples[train_tiny]: under stat in "
                f"{time.perf_counter() - t0:.1f} s: {line.strip()!r}; "
                f"gputrace rows {launches} | {self.smi}")
            if not line:
                raise AssertionError("train_tiny printed no final loss")

        try:
            # all five at once; long_context's output (a "final loss" line
            # too) goes into the log after the others', so that edr fires
            # on train_tiny's
            with ThreadPoolExecutor(max_workers=5) as pool:
                stat = pool.submit(
                    self.run_stat, "examples_long_context",
                    "python -m sofa_tpu_torch.examples.long_context",
                    flags=("--enable_aisi",))
                runs = [pool.submit(train_tiny)] + [
                    pool.submit(example, name, want) for name, want in
                    (("matmul_burn", "burns in"),
                     ("io_churn", "wrote+read 256 MiB"),
                     ("serve_tiny", "served 4 requests"))]
                for run in runs:
                    run.result()
                feats, logdir, out = stat.result()
            with open(app_log, "a") as f:
                f.write(out)
            line = next((ln for ln in out.splitlines()
                         if "final loss" in ln), "")
            launches = general_rows("long_context", logdir)
            with open(os.path.join(logdir, "iterations.csv")) as f:
                iterations = len(f.read().strip().splitlines()) - 1
            log(f"examples[long_context]: {line.strip()!r}; gputrace rows "
                f"{launches}; iterations.csv {iterations} rows; "
                f"gpu0_hbm_peak_gb {feats.get('gpu0_hbm_peak_gb')} | "
                f"{self.smi}")
            if "remat=on" not in line or iterations != 8:
                raise AssertionError("long_context: its 8 steps are missing "
                                     "from its capture")
            edr_out, _ = edr.communicate(timeout=300)
        finally:
            if edr.poll() is None:
                edr.kill()
                edr.communicate()
        edr_dir = os.path.join(base, "edr-train")
        t0 = time.perf_counter()
        rep = subprocess.run([sys.executable, "-m", "sofa_tpu_torch",
                              "report", "--logdir", edr_dir], cwd=REPO,
                             env=host_only, capture_output=True, text=True,
                             timeout=300)
        last = (rep.stdout.strip().splitlines() or [""])[-1]
        said = [ln for ln in edr_out.splitlines()
                if ln.startswith("sofa-edr:")]
        log(f"examples[edr]: rc {edr.returncode}, {said}; report of "
            f"{os.path.relpath(edr_dir, REPO)} rc "
            f"{rep.returncode} in {time.perf_counter() - t0:.1f} s, last "
            f"line {last!r}")
        if edr.returncode != 0 or "all phases captured" not in edr_out \
                or rep.returncode != 0 or last != "Complete!!":
            raise AssertionError("edr's capture of train_tiny failed")
        log(f"examples: phase {time.perf_counter() - t_phase:.1f} s | "
            f"{self.smi}")

    def chaos_tier(self):
        """``chaos_tier --smoke`` on the host: its last line "ok": true,
        the five chaos events, no problem."""
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "sofa_tpu_torch.tools.chaos_tier",
             "--smoke"], cwd=REPO, capture_output=True, text=True,
            timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        doc = json.loads(r.stdout.strip().splitlines()[-1])
        log(f"chaos_tier: rc {r.returncode} in {time.perf_counter() - t0:.1f}"
            f" s, ok {doc['ok']}, {doc['pushes']} pushes, events "
            f"{doc['events']}, metrics {doc['metrics']}, problems "
            f"{doc['problems']} | {self.smi}")
        if r.returncode != 0 or not doc["ok"] or len(doc["events"]) != 5:
            raise AssertionError(f"chaos_tier --smoke failed: "
                                 f"{r.stderr[-2000:]}")

    @staticmethod
    def tooling_together(calls):
        """Runs the zero-argument ``calls`` side by side, each on a thread
        of its own (each drives child processes independent of the
        others'); returns their results in order, or raises the first
        failure once all have ended."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=len(calls)) as pool:
            futures = [pool.submit(call) for call in calls]
        return [f.result() for f in futures]

    def tooling_cli(self, label, *argv, want=0):
        """A host-only verb (no card visible); raises unless it exits
        ``want``; returns its stdout and wall seconds."""
        r, wall = self.board_cli(*argv)
        if r.returncode != want:
            raise AssertionError(f"tooling[{label}]: `{' '.join(argv)}` "
                                 f"exited {r.returncode}, expected {want}: "
                                 f"{(r.stdout + r.stderr)[-3000:]}")
        return r.stdout, wall

    def tooling_valid(self, label, base, doc_text):
        """The port's manifest_check over a --json document, gating on
        closure (--require-healthy); returns the parsed document."""
        path = os.path.join(base, f"{label}.json")
        with open(path, "w") as f:
            f.write(doc_text)
        r = subprocess.run(
            [sys.executable, "-m", "sofa_tpu_torch.tools.manifest_check",
             path, "--require-healthy"], cwd=REPO, capture_output=True,
            text=True, timeout=120, env=dict(os.environ,
                                             CUDA_VISIBLE_DEVICES=""))
        if r.returncode != 0:
            raise AssertionError(f"tooling[{label}]: manifest_check "
                                 f"exited {r.returncode}: "
                                 f"{(r.stdout + r.stderr)[-2000:]}")
        return json.loads(doc_text)

    def tooling_lint(self, base):
        """(a) lint: exit 0 against the port's baseline, and the JSON
        report byte-identical at --jobs 1 and 4."""
        (out, wall), (j1, wall1), (j4, wall4) = self.tooling_together([
            lambda: self.tooling_cli("lint", "lint"),
            lambda: self.tooling_cli("lint", "lint", "--json", "--jobs", "1"),
            lambda: self.tooling_cli("lint", "lint", "--json", "--jobs", "4")])
        clean = [ln for ln in out.splitlines()
                 if ln.startswith("sofa-lint: clean (")]
        if not clean:
            raise AssertionError(f"tooling[lint]: no clean line: "
                                 f"{out[-2000:]}")
        if j1 != j4:
            raise AssertionError("tooling[lint]: --jobs 1 and --jobs 4 "
                                 "reports differ")
        doc = json.loads(j1)
        if doc["new"] or doc["baselined"] != doc["total"]:
            raise AssertionError(f"tooling[lint]: {doc}")
        return (f"{clean[0]}; by rule {doc['by_rule']}; --jobs 1 and 4 "
                f"JSON equal; {wall:.2f} s, --json at --jobs 1 "
                f"{wall1:.2f} s, at 4 {wall4:.2f} s (three processes side "
                f"by side)")

    def tooling_artifacts(self, base):
        """(b) the static inventory validated with full closure, and side
        by side the audit of a copy of each capture after ``report``:
        zero leaks."""
        build = os.path.join(REPO, "build")
        return "; ".join(self.tooling_together([
            lambda: self.tooling_inventory(base),
            lambda: self.tooling_audit(
                base, "llama",
                os.path.join(build, "chip_smoke_profile_llama")),
            lambda: self.tooling_audit(
                base, "resnet", os.path.join(build, "chip_smoke_resnet_r1"))
        ]))

    def tooling_inventory(self, base):
        out, wall = self.tooling_cli("artifacts", "artifacts", "--json")
        doc = self.tooling_valid("artifacts", base, out)
        if not doc["ok"] or doc["violations"]:
            raise AssertionError(f"tooling[artifacts]: {doc['violations']}")
        return (f"{doc['counts']['artifacts']} artifacts, "
                f"{doc['counts']['writers']} writers, validated "
                f"({wall:.2f} s)")

    def tooling_audit(self, base, label, src):
        copy = os.path.join(base, label)
        t0 = time.perf_counter()
        shutil.copytree(src, copy)
        t_copy = time.perf_counter() - t0
        out, t_report = self.tooling_cli(
            f"report {label}", "report", "--logdir", copy, "--jobs", "4")
        if "Complete!!" not in out:
            raise AssertionError(f"tooling[report {label}]: {out[-2000:]}")
        out, t_audit = self.tooling_cli(
            f"audit {label}", "artifacts", copy, "--json")
        audit = self.tooling_valid(f"audit_{label}", base, out)["logdir"]
        if audit["unaccounted"] or audit["files_checked"] < 50:
            raise AssertionError(f"tooling[audit {label}]: {audit}")
        return (f"{label}: {audit['files_checked']} files, 0 leaks (copy "
                f"{t_copy:.1f} s, report {t_report:.1f} s, audit "
                f"{t_audit:.2f} s)")

    def tooling_protocol(self, base):
        """(c) the protocol inventory validated, every declared route."""
        from sofa_tpu_torch.archive.protocol import ROUTES

        out, wall = self.tooling_cli("protocol", "protocol", "--json")
        doc = self.tooling_valid("protocol", base, out)
        routes = [f"{r['method']} {r['path']}" for r in doc["routes"]]
        if not doc["ok"] or routes != list(ROUTES):
            raise AssertionError(f"tooling[protocol]: ok {doc['ok']}, "
                                 f"routes {routes}")
        c = doc["counts"]
        return (f"{c['routes']} routes (ROUTES'), {c['statuses']} "
                f"statuses, {c['errors']} errors, {c['knobs']} knobs, "
                f"{c['fault_kinds']} fault kinds, validated ({wall:.2f} s)")

    def tooling_setup(self, base):
        """(d) setup on the card's host, then with no card visible."""
        import torch

        name = torch.cuda.get_device_name(0)
        parts = []
        for label, env in (("card", dict(os.environ)),
                           ("hidden", dict(os.environ,
                                           CUDA_VISIBLE_DEVICES=""))):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "sofa_tpu_torch",
                                "setup"], cwd=REPO, env=env,
                               capture_output=True, text=True, timeout=120)
            wall = time.perf_counter() - t0
            text = r.stdout + r.stderr
            problems = [ln for ln in text.splitlines()
                        if ln.startswith("[WARNING] setup:")]
            healthy = [ln for ln in text.splitlines()
                       if "setup: device backend healthy:" in ln]
            if r.returncode != (1 if problems else 0):
                raise AssertionError(f"tooling[setup {label}]: rc "
                                     f"{r.returncode} with {len(problems)} "
                                     f"problem line(s): {text[-2000:]}")
            if label == "card":
                want = f"healthy: cuda (1 device(s), {name})"
                if len(healthy) != 1 or not healthy[0].endswith(want):
                    raise AssertionError(f"tooling[setup]: no `{want}`: "
                                         f"{text[-2000:]}")
                said = healthy[0]
            else:
                failed = [ln for ln in problems
                          if "device backend init failed" in ln]
                if healthy or r.returncode != 1 or not failed:
                    raise AssertionError(f"tooling[setup hidden]: "
                                         f"{text[-2000:]}")
                said = failed[0]
            parts.append(f"{label}: rc {r.returncode}, {len(problems)} "
                         f"problem(s), `{said}` ({wall:.1f} s)")
        return "; ".join(parts)

    def fleet_serve(self, root, label, env=None):
        """``serve <root>`` on loopback port 0, a child with no card
        visible; returns the process, its URL and its log file."""
        slog = os.path.join(os.path.dirname(root), f"serve_{label}.log")
        # a quick index refresh after each ack, so that fleet_fsck's wait
        # for it is short
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   SOFA_REFRESH_MIN_INTERVAL_S="0.2", **(env or {}))
        with open(slog, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "sofa_tpu_torch", "serve", root,
                 "--serve_port", "0", "--token", self.FLEET_TOKEN],
                cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with open(slog) as f:
                m = re.search(r"fleet archive service: .* at "
                              r"http://[^:]+:(\d+)/v1/", f.read())
            if m:
                return proc, f"http://127.0.0.1:{m.group(1)}", slog
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        proc.kill()
        with open(slog) as f:
            raise AssertionError(f"serve {label} printed no URL: "
                                 f"{f.read()[-2000:]}")

    def fleet_agent(self, label, watch, url, spool, *flags, want=0,
                    tenant="smoke"):
        """``agent <watch> --once`` into ``url``, no card visible; raises
        unless it exits ``want``; returns its output and wall seconds."""
        argv = ["agent", watch, "--once", "--service", url, "--token",
                self.FLEET_TOKEN, "--spool", spool, "--tenant", tenant,
                "--settle_s", "0", "--push_backoff_s", "0.05",
                "--push_backoff_cap_s", "0.5", *flags]
        r, wall = self.board_cli(*argv)
        if r.returncode != want:
            raise AssertionError(f"fleet[{label}]: `{' '.join(argv)}` "
                                 f"exited {r.returncode}, expected {want}: "
                                 f"{(r.stdout + r.stderr)[-3000:]}")
        return r.stdout + r.stderr, wall

    @staticmethod
    def fleet_runs(root, tenant):
        from sofa_tpu_torch.archive import catalog

        troot = os.path.join(root, "tenants", tenant)
        return [e["run"] for e in
                catalog.ingest_entries(catalog.read_catalog(troot))]

    @staticmethod
    def fleet_fsck(troot):
        """The archive fsck's damage in a store ({} when clean).  A served
        tenant is first let settle: its WAL applied and its index refreshed
        (the refresher writes after the ack; an fsck racing it would read
        its stage files as orphans)."""
        from sofa_tpu_torch.archive import tier
        from sofa_tpu_torch.archive.store import archive_fsck

        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            state = tier.load_wal_state(troot)
            if tier.wal_depth(troot) == 0 and all(
                    int(state["refreshed"].get(n, 0)) >= int(off)
                    for n, off in state["applied"].items()):
                break
            time.sleep(0.05)
        else:
            return {"wal": "not settled after 60 s"}
        report = archive_fsck(troot)
        if report is None:
            return {"store": "none"}
        return {v: report[v] for v in ("corrupt", "missing", "orphaned",
                                       "uncataloged", "index") if report[v]}

    def fleet_first(self, url, root, base, copies):
        """(a) both captures delivered."""
        from sofa_tpu_torch import telemetry
        from sofa_tpu_torch.archive.spool import Spool
        from sofa_tpu_torch.tools.manifest_check import validate_manifest

        spool = os.path.join(base, "spool")
        _out, wall = self.fleet_agent("push", os.path.dirname(
            copies["resnet"]), url, spool)
        state = Spool(spool)
        runs = self.fleet_runs(root, "smoke")
        parts = []
        for label in ("resnet", "llama"):
            doc = telemetry.load_manifest(copies[label])
            meta = doc["meta"]
            push = meta["agent"]["push"]
            spooled = state.entry(copies[label]).get("run")
            probs = validate_manifest(doc)
            if push["status"] != "pushed" or "serve" not in meta or \
                    meta["serve"]["run"] != spooled or \
                    spooled not in runs or probs:
                raise AssertionError(f"push {label}: {push['status']}, "
                                     f"meta.serve {meta.get('serve')}, "
                                     f"spooled {spooled}, catalog {runs}, "
                                     f"{probs}")
            mb_s = push["bytes_sent"] / max(push["wall_s"], 1e-9) / 1e6
            parts.append(f"{label} run {spooled[:12]}: "
                         f"{push['objects_sent']} objects, "
                         f"{push['bytes_sent']} bytes in {push['wall_s']} s "
                         f"({mb_s:.1f} MB/s loopback), "
                         f"{push['attempts']} requests")
        if len(runs) != 2:
            raise AssertionError(f"the tenant holds {len(runs)} runs")
        return (f"agent rc 0 in {wall:.2f} s, the tenant 2 runs; "
                + "; ".join(parts) + "; manifest_check 0")

    def fleet_again(self, url, root, base, copies):
        """(b) both pushed again: nothing sent, no catalog line."""
        from sofa_tpu_torch import telemetry
        from sofa_tpu_torch.archive import catalog
        from sofa_tpu_torch.archive.spool import Spool

        spool = os.path.join(base, "spool")
        state = Spool(spool)
        for ent in state._state["logdirs"].values():
            ent["pushed"] = False
        state._save_state()
        troot = os.path.join(root, "tenants", "smoke")
        lines = len(catalog.read_catalog(troot))
        _out, wall = self.fleet_agent("again", os.path.dirname(
            copies["resnet"]), url, spool)
        sent = {label: telemetry.load_manifest(copies[label])["meta"][
                    "agent"]["push"] for label in ("resnet", "llama")}
        if any(p["status"] != "pushed" or p["objects_sent"]
               or p["bytes_sent"] for p in sent.values()) or \
                len(catalog.read_catalog(troot)) != lines:
            raise AssertionError(f"the re-push sent {sent} or grew the "
                                 "catalog")
        return (f"agent rc 0 in {wall:.2f} s: "
                + ", ".join(f"{k} {p['objects_sent']} objects "
                            f"{p['bytes_sent']} bytes in {p['wall_s']} s"
                            for k, p in sent.items())
                + f"; the catalog still {lines} line(s)")

    def fleet_faults(self, url, root, base, copies):
        """(c) the Llama-width copy under partial@0.5 and conn_reset."""
        from sofa_tpu_torch import telemetry

        parts = []
        for tenant, spec in (("partial", "service:partial@0.5"),
                             ("reset", "service:conn_reset")):
            _out, wall = self.fleet_agent(
                tenant, copies["llama"], url,
                os.path.join(base, f"spool_{tenant}"), "--inject_faults",
                spec, tenant=tenant)
            runs = self.fleet_runs(root, tenant)
            damage = self.fleet_fsck(os.path.join(root, "tenants", tenant))
            push = telemetry.load_manifest(copies["llama"])["meta"][
                "agent"]["push"]
            if len(runs) != 1 or damage:
                raise AssertionError(f"{spec}: runs {runs}, fsck {damage}")
            parts.append(f"{spec}: rc 0 in {wall:.2f} s, 1 run, fsck clean, "
                         f"{push['objects_sent']} objects "
                         f"{push['bytes_sent']} bytes in {push['attempts']} "
                         "requests")
        return "; ".join(parts)

    def fleet_kill(self, base, llama):
        """(d) the service dies at its 4th write; a restart takes the retry
        (the JAX chaos matrix's kill-service-mid-upload cell)."""
        from sofa_tpu_torch import telemetry
        from sofa_tpu_torch.archive import catalog

        root = os.path.join(base, "kill_root")
        spool = os.path.join(base, "spool_kill")
        proc, url, slog = self.fleet_serve(
            root, "kill", env={"SOFA_SERVE_EXIT_AFTER": "4"})
        try:
            _out, wall1 = self.fleet_agent("kill", llama, url, spool,
                                           "--push_retries", "2", want=1,
                                           tenant="default")
            rc = proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        spooled = catalog.ingest_entries(catalog.read_catalog(spool))
        damage = self.fleet_fsck(spool)
        if rc != 86 or len(spooled) != 1 or damage:
            raise AssertionError(f"the killed service rc {rc}, spool runs "
                                 f"{len(spooled)}, spool fsck {damage}")
        proc, url, slog = self.fleet_serve(root, "kill_again")
        try:
            _out, wall2 = self.fleet_agent("retry", llama, url, spool,
                                           tenant="default")
        finally:
            proc.terminate()
            proc.wait(timeout=30)
        runs = self.fleet_runs(root, "default")
        damage = self.fleet_fsck(os.path.join(root, "tenants", "default"))
        meta = telemetry.load_manifest(llama)["meta"]
        if runs != [spooled[0]["run"]] or damage or \
                meta.get("serve", {}).get("run") != runs[0]:
            raise AssertionError(f"the retry: runs {runs}, fsck {damage}, "
                                 f"meta.serve {meta.get('serve')}")
        return (f"the service exited 86 at its 4th write, agent rc 1 in "
                f"{wall1:.2f} s, the spool 1 run fsck-clean; restarted, "
                f"agent rc 0 in {wall2:.2f} s, 1 run {runs[0][:12]}, "
                f"meta.serve written, fsck clean")

    def fleet_concurrent(self, url, root, base, copies):
        """(e) two agents push two copies of one capture at once: each
        spools its copy first (no service), so that the two pushes start
        together."""
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        env.pop("SOFA_AGENT_SERVICE", None)

        def both(*service):
            procs = [subprocess.Popen(
                [sys.executable, "-m", "sofa_tpu_torch", "agent",
                 copies[label], "--once", *service, "--token",
                 self.FLEET_TOKEN, "--spool",
                 os.path.join(base, f"spool_conc{i}"), "--tenant",
                 "concurrent", "--settle_s", "0", "--push_backoff_s", "0.05",
                 "--push_backoff_cap_s", "0.5"], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for i, label in enumerate(("llama", "llama2"))]
            t0 = time.perf_counter()
            outs = [p.communicate(timeout=600)[0] for p in procs]
            rcs = [p.returncode for p in procs]
            if rcs != [0, 0]:
                raise AssertionError(f"concurrent agents rc {rcs}: "
                                     + " | ".join(o[-1500:] for o in outs))
            return time.perf_counter() - t0

        spool_s = both()
        push_s = both("--service", url)
        runs = self.fleet_runs(root, "concurrent")
        damage = self.fleet_fsck(os.path.join(root, "tenants",
                                              "concurrent"))
        if len(runs) != 1 or damage:
            raise AssertionError(f"concurrent agents: runs {runs}, fsck "
                                 f"{damage}")
        return (f"both spooled in {spool_s:.2f} s, then both pushed rc 0 "
                f"in {push_s:.2f} s, 1 run {runs[0][:12]}, fsck clean")

    def fleet_term(self, proc, root, slog):
        """(f) SIGTERM drains the seeded WAL; then fsck of the root."""
        from sofa_tpu_torch.archive import tier
        from sofa_tpu_torch.trace import derived_write_guard

        troot = os.path.join(root, "tenants", "term")
        app = tier.WalAppender(troot, worker=0)
        recs = [{"run": f"{i:02d}" + "cd" * 31, "logdir": f"/jobs/{i}/",
                 "hostname": "chip-smoke", "label": "", "tenant": "term",
                 "files": {}, "features": {}} for i in range(3)]
        with derived_write_guard(troot):
            for rec in recs:
                app.append(rec)
            time.sleep(0.2)     # drain polls the guard holds off
            depth = tier.wal_depth(troot)
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            term_s = time.perf_counter() - t0
        with open(slog) as f:
            out = f.read()
        handled = [ln for ln in out.splitlines() if "serve handled:" in ln]
        runs = self.fleet_runs(root, "term")
        depths = {t: tier.wal_depth(os.path.join(root, "tenants", t))
                  for t in sorted(os.listdir(os.path.join(root, "tenants")))}
        stats = {}
        for entry in (handled[-1].split("serve handled: ")[-1].split(", ")
                      if handled else ()):
            n, key = entry.split(" ", 1)
            stats[key] = int(n)
        if rc != 0 or depth != 3 or "drained 3 WAL record(s)" not in out \
                or any(depths.values()) or runs != [r["run"] for r in recs] \
                or not stats.get("422_hash_mismatch") \
                or any(k.startswith("500") for k in stats) \
                or "Traceback" in out:
            raise AssertionError(f"SIGTERM: rc {rc}, depth {depth} before, "
                                 f"{depths} after, runs {runs}: "
                                 f"{out[-3000:]}")
        r, fsck_s = self.board_cli("fsck", root)
        if r.returncode != 0:
            raise AssertionError(f"fsck of the fleet root rc "
                                 f"{r.returncode}: {r.stdout[-2000:]}")
        tenants = r.stdout.count("fsck: tenant ")
        return (f"3 WAL records held mid-gc, SIGTERM: rc 0 in {term_s:.2f} "
                f"s, drained 3, every tenant's WAL 0; {handled[-1].strip()}"
                f"; fsck of the root ({tenants} tenants) rc 0 in "
                f"{fsck_s:.2f} s")

    # -- the fleet tier: pool, replicas, metrics, fleet passes ----------------
    TIER_SLO = "push_p99_ms<600000,wal_depth<100000"

    def fleet_tier(self):
        """The fleet tier over the ResNet-50 and Llama-width captures (no
        card visible; each ``serve`` and each ``agent --once`` a child
        process on loopback), a line a cell: (a) ``serve --workers 4
        --slo`` (its log names SO_REUSEPORT or the dispatcher), the port's
        ``fleet_load`` (4 agents x 8 pushes over 2 tenants, 2 pollers) and
        the two captures by ``agent --once``: every push acked and
        committed, each tenant's run set the one offered, ``/v1/tier``
        naming 4 workers and each tenant's ring owner, the acks' ``tier``
        and ``metrics`` in the manifests; (b) a second pool under
        ``service:worker_die@2,service:slo_breach@2``: worker 2 exits 89
        once and is respawned, no acked push lost, every WAL at 0, one
        ``slo_breach`` catalog event, ``slo_verdict.json`` not ok and
        ``status --fleet`` exiting 1; (c) ``serve --rolling-restart``
        under load: every worker a new pid, one at a time, no acked push
        lost, no 500; (d) ``serve --replica-of`` the pool: each tenant's
        query bytes the primary's with the commit header, a write 403, a
        second pull moving nothing; under ``service:replica_stale`` the
        stale header and ``status --fleet``'s staleness line; (e)
        ``/v1/metrics``'s 304, and a served scrape loop stalled by
        ``service:scrape_stall`` for over STALE_SCRAPE_S giving the
        stale-scrape warnings; (f) ``fleet analyze`` cold, warm and again
        on a tenant's copy (no-ops, the same bytes), ``/v1/<t>/fleet``'s
        304, a rotted ``fleet_state.json`` named by ``fsck`` and dropped
        by ``--repair``, the next analyze the same bytes; a WAL append
        under ``service:disk_full@1`` answering 507 and the retry
        committing; (g) SIGTERM: every worker exits 0, every WAL at 0, no
        500 and no traceback, ``fsck`` of the root 0, and the merged fleet
        trace joining one push's spans across processes."""
        self.need("llama")
        build = os.path.join(REPO, "build")
        caps = {"resnet": os.path.join(build, "chip_smoke_resnet_r1"),
                "llama": os.path.join(build, "chip_smoke_profile_llama")}
        self.fleet_tier_cells(caps, os.path.join(build,
                                                 "chip_smoke_fleet_tier"))

    def fleet_tier_cells(self, caps, base):
        from sofa_tpu_torch import metrics

        t_phase = time.perf_counter()
        shutil.rmtree(base, ignore_errors=True)
        t0 = time.perf_counter()
        copies = {}
        for label, src in caps.items():
            for where in (("watch_a", "watch_b", "stale")
                          if label == "resnet" else ("watch_a",)):
                dest = os.path.join(base, where, label)
                shutil.copytree(src, dest, ignore=shutil.ignore_patterns(
                    "_ingest_cache"))
                copies[(where, label)] = dest
        log(f"tier[copy]: the captures copied in "
            f"{time.perf_counter() - t0:.1f} s | {self.smi}")
        # (e)'s stalled scrape loop needs STALE_SCRAPE_S of wall time: it
        # runs beside the other cells
        stale = subprocess.Popen(
            [sys.executable, "-c", self.TIER_STALE_CHILD,
             os.path.join(base, "stale_root"),
             os.path.join(base, "stale"), self.FLEET_TOKEN,
             str(metrics.STALE_SCRAPE_S + 2)],
            cwd=REPO, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        root_a = os.path.join(base, "root_a")
        pool, url, alog = self.tier_pool(root_a, "a", ["--slo",
                                                       self.TIER_SLO])
        procs = [stale, pool]
        try:
            cells = [("pool", lambda: self.tier_pool_cell(
                         url, root_a, alog, copies))]
            cells.append(("die", lambda: self.tier_die_cell(base, copies)))
            cells.append(("replica", lambda: self.tier_replica_cell(
                url, root_a, base, procs)))
            cells.append(("restart", lambda: self.tier_restart_cell(
                url, root_a, alog)))
            cells.append(("metrics", lambda: self.tier_metrics_cell(
                url, stale)))
            cells.append(("passes", lambda: self.tier_passes_cell(
                url, root_a, base)))
            cells.append(("drain", lambda: self.tier_drain_cell(
                pool, root_a, alog)))
            for name, cell in cells:
                t0 = time.perf_counter()
                line = cell()
                log(f"tier[{name}]: {line} "
                    f"({time.perf_counter() - t0:.1f} s) | {self.smi}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        log(f"fleet_tier: phase {time.perf_counter() - t_phase:.1f} s | "
            f"{self.smi}")

    def tier_pool(self, root, label, flags=(), env=None, workers=4):
        """``serve <root> --workers N`` on loopback port 0, a child with
        no card visible; returns the process, its URL and its log."""
        slog = os.path.join(os.path.dirname(root), f"pool_{label}.log")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   SOFA_REFRESH_MIN_INTERVAL_S="0.2",
                   SOFA_METRICS_SCRAPE_S="1", **(env or {}))
        with open(slog, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "sofa_tpu_torch", "serve", root,
                 "--serve_port", "0", "--token", self.FLEET_TOKEN,
                 "--workers", str(workers), *flags],
                cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            with open(slog) as f:
                m = re.search(r"fleet archive service: .* at "
                              r"http://[^:]+:(\d+)/v1/", f.read())
            if m:
                return proc, f"http://127.0.0.1:{m.group(1)}", slog
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        proc.kill()
        with open(slog) as f:
            raise AssertionError(f"pool {label} printed no URL: "
                                 f"{f.read()[-2000:]}")

    def tier_get(self, url, path, token=None, headers=None, conn=None):
        """(status, headers, body) of one GET, over ``conn`` if given."""
        import http.client
        import urllib.parse

        hdr = {"Authorization": f"Bearer {token or self.FLEET_TOKEN}",
               **(headers or {})}
        own = conn is None
        if own:
            u = urllib.parse.urlparse(url)
            conn = http.client.HTTPConnection(u.hostname, u.port,
                                              timeout=30)
        try:
            conn.request("GET", path, headers=hdr)
            r = conn.getresponse()
            return r.status, dict(r.getheaders()), r.read()
        finally:
            if own:
                conn.close()

    def tier_load(self, url, *args):
        """The port's ``fleet_load`` against ``url``; returns its result
        document (raises on an error or a failed push)."""
        r = subprocess.run(
            [sys.executable, "-m", "sofa_tpu_torch.tools.fleet_load",
             "--url", url, "--token", self.FLEET_TOKEN, *args], cwd=REPO,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            capture_output=True, text=True, timeout=600)
        lines = r.stdout.strip().splitlines()
        res = json.loads(lines[-1]) if lines else {}
        if r.returncode != 0 or res.get("error_count"):
            raise AssertionError(f"fleet_load {' '.join(args)}: rc "
                                 f"{r.returncode}, {res.get('errors')}: "
                                 f"{r.stderr[-2000:]}")
        return res

    @staticmethod
    def tier_offered(res, payload_bytes=2048):
        """tenant -> the run ids of the pushes ``fleet_load`` acked."""
        from sofa_tpu_torch.archive.store import run_content_id
        from sofa_tpu_torch.tools.fleet_load import _synthetic_run

        out = {}
        for t in res["traces"]:
            files = {rel: {"sha256": hashlib.sha256(data).hexdigest(),
                           "bytes": len(data)}
                     for rel, data in _synthetic_run(
                         t["tenant"], t["agent"], t["i"],
                         payload_bytes).items()}
            out.setdefault(t["tenant"], set()).add(run_content_id(files))
        return out

    def tier_settled(self, root):
        """Every tenant of ``root``: WAL applied and index refreshed."""
        tdir = os.path.join(root, "tenants")
        for tenant in sorted(os.listdir(tdir)):
            bad = self.fleet_fsck(os.path.join(tdir, tenant))
            if bad:
                raise AssertionError(f"tenant {tenant}: {bad}")

    def tier_pool_cell(self, url, root, slog, copies):
        """(a) the load and the captures through the pool of 4."""
        from sofa_tpu_torch import telemetry
        from sofa_tpu_torch.archive import tier
        from sofa_tpu_torch.tools.manifest_check import validate_manifest

        with open(slog) as f:
            m = re.search(r"4 workers via (SO_REUSEPORT|dispatcher)",
                          f.read())
        if m is None:
            raise AssertionError("the pool's log names no accept path")
        res = self.tier_load(url, "--agents", "4", "--pushes", "8",
                             "--pollers", "2", "--tenants", "2")
        if res["pushes"] != 32:
            raise AssertionError(f"{res['pushes']} of 32 pushes acked")
        watch = os.path.dirname(copies[("watch_a", "llama")])
        _out, wall = self.fleet_agent("tier", watch, url,
                                      os.path.join(root, "..", "spool_a"))
        self.tier_settled(root)
        offered = self.tier_offered(res)
        got = {t: set(self.fleet_runs(root, t)) for t in offered}
        if got != offered:
            raise AssertionError(f"run sets {got} != offered {offered}")
        for label in ("resnet", "llama"):
            meta = telemetry.load_manifest(copies[("watch_a",
                                                   label)])["meta"]
            mt = meta.get("tier") or {}
            if mt.get("workers") != 4 or "metrics" not in meta or \
                    meta["agent"]["push"]["status"] != "pushed" or \
                    validate_manifest({"meta": meta, **{
                        k: v for k, v in telemetry.load_manifest(
                            copies[("watch_a", label)]).items()
                        if k != "meta"}}):
                raise AssertionError(f"{label}: meta.tier {mt}, "
                                     f"{sorted(meta)}")
        if len(self.fleet_runs(root, "smoke")) != 2:
            raise AssertionError("the captures' tenant holds "
                                 f"{self.fleet_runs(root, 'smoke')}")
        _s, _h, body = self.tier_get(url, "/v1/tier")
        doc = json.loads(body)
        owners = {r["tenant"]: r["worker"] for r in doc["tenants"]}
        want = {t: tier.ring_owner(t, 4) for t in ("lt0", "lt1", "smoke")}
        if doc["workers"] != 4 or owners != want or \
                doc["reuseport"] != (m.group(1) == "SO_REUSEPORT"):
            raise AssertionError(f"/v1/tier: {doc}")
        mm = res["metrics"]
        return (f"4 workers via {m.group(1)}; fleet_load 32/32 pushes "
                f"acked, {res['queries']} queries, 0 errors in "
                f"{res['wall_s']} s: fleet_push_p50_ms "
                f"{mm['fleet_push_p50_ms']}, fleet_push_p99_ms "
                f"{mm['fleet_push_p99_ms']}, fleet_query_p50_ms "
                f"{mm['fleet_query_p50_ms']}, fleet_query_p99_ms "
                f"{mm['fleet_query_p99_ms']}, fleet_saturation_rps "
                f"{mm['fleet_saturation_rps']}; run sets as offered "
                f"({ {t: len(v) for t, v in got.items()} }); the captures "
                f"by agent rc 0 in {wall:.2f} s with meta.tier (workers 4) "
                f"and meta.metrics; /v1/tier owners {owners}")

    def tier_die_cell(self, base, copies):
        """(b) worker 2 dies once; the SLO breach fault beside it."""
        from sofa_tpu_torch.archive import catalog, tier
        from sofa_tpu_torch.archive.store import ArchiveStore

        root = os.path.join(base, "root_b")
        # the breach event lands in the tenants there are at window 2
        ArchiveStore(os.path.join(root, "tenants", "smoke"), create=True)
        proc, url, slog = self.tier_pool(root, "b", env={
            "SOFA_FAULTS": "service:worker_die@2,service:slo_breach@2"})
        try:
            res = self.tier_load(url, "--agents", "4", "--pushes", "4",
                                 "--pollers", "1", "--tenants", "2")
            watch = os.path.dirname(copies[("watch_b", "resnet")])
            self.fleet_agent("die", watch, url,
                             os.path.join(base, "spool_b"))
            self.tier_settled(root)
            offered = self.tier_offered(res)
            lost = {t: v - set(self.fleet_runs(root, t))
                    for t, v in offered.items()}
            with open(slog) as f:
                out = f.read()
            died = re.findall(r"worker (\d+) \(pid \d+\) exited (\d+)", out)
            r, _ = self.board_cli("status", "--fleet", url, "--token",
                                  self.FLEET_TOKEN)
            verdict = json.load(open(os.path.join(
                root, "_metrics", "slo_verdict.json")))
            events = [e for e in catalog.read_catalog(
                os.path.join(root, "tenants", "smoke"))
                if e.get("ev") == "slo_breach"]
            depths = {t: tier.wal_depth(os.path.join(root, "tenants", t))
                      for t in os.listdir(os.path.join(root, "tenants"))}
            if died != [("1", "89")] or any(lost.values()) or \
                    any(depths.values()) or r.returncode != 1 or \
                    "injected_fault" not in r.stdout + r.stderr or \
                    verdict["ok"] is not False or len(events) != 1 or \
                    len(self.fleet_runs(root, "smoke")) != 1:
                raise AssertionError(
                    f"worker_die: exits {died}, lost {lost}, WAL {depths}, "
                    f"status --fleet rc {r.returncode}, verdict "
                    f"{verdict.get('breaching')}, {len(events)} breach "
                    f"event(s): {(r.stdout + r.stderr)[-1500:]} "
                    f"{out[-2000:]}")
        finally:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        if rc != 0:
            raise AssertionError(f"pool b exited {rc} on SIGTERM")
        line = self.tier_disk_full(root)
        return (f"worker 1 (ordinal 2) exited 89 once and was respawned; "
                f"{res['pushes']}/16 pushes and the ResNet-50 capture acked, none "
                f"lost, every WAL 0; slo_breach@2: 1 catalog event, "
                f"slo_verdict.json ok false ({verdict['breaching']}), "
                f"status --fleet rc 1; SIGTERM rc 0; {line}")

    def tier_disk_full(self, root):
        """(f) a commit whose objects are all stored: its WAL append is
        the process's first write, under ``service:disk_full@1``."""
        from sofa_tpu_torch.archive.store import ArchiveStore

        proc, url, slog = self.fleet_serve(root, "disk_full", env={
            "SOFA_FAULTS": "service:disk_full@1"})
        try:
            store = ArchiveStore(os.path.join(root, "tenants", "smoke"))
            run = store.load_run(self.fleet_runs(root, "smoke")[0])
            files = {f"again/{rel}": ent
                     for rel, ent in run["files"].items()}
            body = json.dumps({"files": files, "logdir": "/again",
                               "hostname": "chip-smoke"}).encode()
            codes = []
            for _ in range(2):
                req = urllib.request.Request(
                    url + "/v1/smoke/commit", data=body, method="POST",
                    headers={"Authorization":
                             f"Bearer {self.FLEET_TOKEN}"})
                try:
                    with urllib.request.urlopen(req, timeout=60) as r:
                        codes.append((r.status, json.loads(r.read())))
                except urllib.error.HTTPError as e:
                    codes.append((e.code, json.loads(e.read())))
        finally:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        (c1, d1), (c2, d2) = codes
        if (c1, d1.get("error")) != (507, "no_space") or c2 != 200 or \
                not d2.get("committed") or not d2.get("new") or rc != 0:
            raise AssertionError(f"disk_full: {codes}, rc {rc}")
        return (f"disk_full@1 on the WAL append: 507 {d1['error']}, the "
                f"retry 200 committed (run {d2['run'][:12]})")

    def tier_replica_cell(self, url, root, base, procs):
        """(d) a replica of the pool, then one under replica_stale."""
        from sofa_tpu_torch.archive import tier

        def commits(u):
            doc = json.loads(self.tier_get(u, "/v1/tier")[2])
            return {r["tenant"]: r["commit_sha"] for r in doc["tenants"]}

        def replica(label, env):
            proc, rurl, _log = self.tier_replica(
                os.path.join(base, f"replica_{label}"), url, label, env)
            procs.append(proc)
            return rurl

        want = commits(url)
        rurl = replica("r1", {})
        deadline = time.monotonic() + 60
        while commits(rurl) != want and time.monotonic() < deadline:
            time.sleep(0.2)
        if commits(rurl) != want:
            raise AssertionError(f"replica {commits(rurl)} != {want}")
        same = 0
        for tenant in sorted(want):
            q = f"/v1/{tenant}/query?kind=runs"
            _s, hp, bp = self.tier_get(url, q)
            s, hr, br = self.tier_get(rurl, q)
            if s != 200 or bp != br or \
                    hr.get("X-Sofa-Replica-Commit") != want[tenant]:
                raise AssertionError(f"{tenant}: replica {s} {hr}")
            same += len(br)
        req = urllib.request.Request(
            rurl + "/v1/smoke/have", data=b'{"files": {}}', method="POST",
            headers={"Authorization": f"Bearer {self.FLEET_TOKEN}"})
        try:
            urllib.request.urlopen(req, timeout=30)
            write = 200
        except urllib.error.HTTPError as e:
            write = e.code
        puller = tier.ReplicaPuller(os.path.join(base, "replica_pull"),
                                    url, self.FLEET_TOKEN)
        first, second = puller.pull_once(), puller.pull_once()
        if write != 403 or not first["fetched_chunks"] or \
                second["fetched_chunks"] or \
                second["unchanged"] != len(want) or first["errors"]:
            raise AssertionError(f"write {write}, pulls {first} {second}")
        surl = replica("r2", {"SOFA_FAULTS": "service:replica_stale"})
        while commits(surl) != want and time.monotonic() < deadline + 60:
            time.sleep(0.2)
        res = self.tier_load(url, "--agents", "1", "--pushes", "1",
                             "--pollers", "0", "--tenants", "1",
                             "--payload_bytes", "4096")
        deadline = time.monotonic() + 60
        hdr = {}
        while time.monotonic() < deadline:
            _s, hdr, _b = self.tier_get(surl, "/v1/lt0/query?kind=runs")
            if hdr.get("X-Sofa-Replica-Stale"):
                break
            time.sleep(0.2)
        r, _ = self.board_cli("status", "--fleet", surl, "--token",
                              self.FLEET_TOKEN)
        stale_lines = [ln.strip() for ln in r.stdout.splitlines()
                       if "STALE" in ln]
        if hdr.get("X-Sofa-Replica-Stale") != "1" or not stale_lines or \
                r.returncode != 0 or res["pushes"] != 1:
            raise AssertionError(f"replica_stale: {hdr}, status rc "
                                 f"{r.returncode}: {r.stdout[-1500:]}")
        return (f"replica r1 at the primary's {len(want)} commits, "
                f"{same} query bytes identical with X-Sofa-Replica-Commit, "
                f"a write 403; pulls {first['fetched_chunks']} chunks then "
                f"0 ({second['unchanged']} unchanged); replica_stale: "
                f"X-Sofa-Replica-Behind {hdr['X-Sofa-Replica-Behind'][:12]}"
                f", status --fleet rc 0: {stale_lines[0]}")

    def tier_replica(self, root, upstream, label, env):
        slog = root + ".log"
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   SOFA_REPLICA_POLL_S="0.5", **env)
        with open(slog, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "sofa_tpu_torch", "serve", root,
                 "--serve_port", "0", "--token", self.FLEET_TOKEN,
                 "--replica-of", upstream],
                cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with open(slog) as f:
                m = re.search(r"fleet archive replica: .* at "
                              r"http://[^:]+:(\d+)/v1/", f.read())
            if m:
                return proc, f"http://127.0.0.1:{m.group(1)}", slog
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        proc.kill()
        with open(slog) as f:
            raise AssertionError(f"replica {label}: {f.read()[-2000:]}")

    def tier_restart_cell(self, url, root, slog):
        """(c) the rolling restart under load."""
        with open(slog) as f:
            before = f.read().count("handed off")
        load = subprocess.Popen(
            [sys.executable, "-m", "sofa_tpu_torch.tools.fleet_load",
             "--url", url, "--token", self.FLEET_TOKEN, "--agents", "4",
             "--pushes", "10", "--pollers", "1", "--tenants", "2",
             "--payload_bytes", "3000", "--push_interval_s", "0.5"],
            cwd=REPO, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            time.sleep(1.0)
            r, _ = self.board_cli("serve", root, "--rolling-restart")
            deadline = time.monotonic() + 180
            handed = []
            while time.monotonic() < deadline:
                with open(slog) as f:
                    handed = re.findall(
                        r"worker (\d) handed off \(pid (\d+) -> (\d+)\)",
                        f.read())[before:]
                if len(handed) == 4:
                    break
                time.sleep(0.2)
            out, err = load.communicate(timeout=600)
        finally:
            if load.poll() is None:
                load.kill()
        res = json.loads(out.strip().splitlines()[-1])
        self.tier_settled(root)
        offered = self.tier_offered(res, 3000)
        lost = {t: v - set(self.fleet_runs(root, t))
                for t, v in offered.items()}
        if r.returncode != 0 or [w for w, _o, _n in handed] != \
                ["0", "1", "2", "3"] or any(o == n for _w, o, n in handed) \
                or res["error_count"] or res["pushes"] != 40 or \
                any(lost.values()):
            raise AssertionError(f"rolling restart: rc {r.returncode}, "
                                 f"handed {handed}, {res['errors']}, lost "
                                 f"{lost}: {err[-1500:]}")
        return (f"--rolling-restart rc 0; workers 0-3 handed off in order "
                f"({', '.join(f'{o}->{n}' for _w, o, n in handed)}); under "
                f"load 40/40 pushes acked and committed, 0 errors (no 500), "
                f"push p99 {res['metrics']['fleet_push_p99_ms']} ms")

    def tier_metrics_cell(self, url, stale):
        """(e) /v1/metrics's 304; the stalled scrape loop's warnings."""
        import http.client
        import urllib.parse

        u = urllib.parse.urlparse(url)
        tries = []
        for _ in range(3):
            conn = http.client.HTTPConnection(u.hostname, u.port,
                                              timeout=30)
            try:
                s1, h1, b1 = self.tier_get(url, "/v1/metrics", conn=conn)
                s2, _h2, _b2 = self.tier_get(
                    url, "/v1/metrics", headers={"If-None-Match":
                                                 h1["ETag"]}, conn=conn)
            finally:
                conn.close()
            tries.append((s1, s2))
            if s2 == 304:
                break
        bad, _h, _b = self.tier_get(url, "/v1/metrics", token="wrong")
        doc = json.loads(b1)
        out, _ = stale.communicate(timeout=300)
        got = json.loads(out.strip().splitlines()[-1])
        if tries[-1] != (200, 304) or bad != 401 or \
                doc["schema"] != "sofa_tpu/fleet_metrics" or \
                got["agent_rc"] != 0 or not got["status_warning"] or \
                not got["fleet_warning"] or not got["stalled"]:
            raise AssertionError(f"metrics: {tries}, 401? {bad}, stale "
                                 f"child {got}")
        return (f"/v1/metrics 200 then 304 on its ETag ({len(tries)} "
                f"tr{'y' if len(tries) == 1 else 'ies'}), 401 without the "
                f"token; scrape_stall: {got['stalled']} ticks skipped, "
                f"the push's meta.metrics.scrape_age_s {got['age_s']}, "
                f"status: \"{got['status_warning'][:60]}...\", status "
                f"--fleet: \"{got['fleet_warning'][:60]}...\"")

    def tier_passes_cell(self, url, root, base):
        """(f) the fleet passes: the verb, the route, fsck."""
        troot = os.path.join(root, "tenants", "smoke")
        copy = os.path.join(base, "fleet_copy")
        shutil.copytree(troot, copy, ignore=shutil.ignore_patterns(
            "_fleet", "_wal"))
        report = os.path.join(copy, "_fleet", "fleet_report.json")
        outs, blobs, walls = [], [], []
        for _ in range(3):
            r, wall = self.board_cli("fleet", "analyze", copy)
            if r.returncode != 0:
                raise AssertionError(f"fleet analyze rc {r.returncode}: "
                                     f"{(r.stdout + r.stderr)[-2000:]}")
            outs.append(r.stdout)
            walls.append(wall)
            with open(report, "rb") as f:
                blobs.append(f.read())
        noops = ["memoized no-op" in o for o in outs]
        s1, h1, b1 = self.tier_get(url, "/v1/smoke/fleet")
        s2, _h, _b = self.tier_get(url, "/v1/smoke/fleet",
                                   headers={"If-None-Match": h1["ETag"]})
        state = os.path.join(copy, "_fleet", "fleet_state.json")
        with open(state, "r+b") as f:
            f.write(b"X")
        found, _ = self.board_cli("fsck", copy)
        fixed, _ = self.board_cli("fsck", copy, "--repair")
        r, _ = self.board_cli("fleet", "analyze", copy)
        with open(report, "rb") as f:
            rebuilt = f.read()
        doc = json.loads(blobs[0])
        if noops != [False, True, True] or len(set(blobs)) != 1 or \
                s1 != 200 or s2 != 304 or found.returncode != 1 or \
                "_fleet/fleet_state.json" not in found.stdout or \
                fixed.returncode != 0 or r.returncode != 0 or \
                rebuilt != blobs[0]:
            raise AssertionError(
                f"fleet passes: noops {noops}, {len(set(blobs))} reports, "
                f"route {s1} {s2}, fsck {found.returncode} "
                f"{fixed.returncode}: {found.stdout[-1500:]}")
        return (f"fleet analyze cold {walls[0]:.2f} s, warm {walls[1]:.2f} "
                f"s and again {walls[2]:.2f} s (memoized no-ops), one "
                f"report ({len(blobs[0])} bytes, {len(doc['order'])} "
                f"passes, {len(doc['features'])} fleet features); "
                f"/v1/smoke/fleet 200 then 304; a rotted fleet_state.json: "
                f"fsck 1 naming it, --repair 0, the next analyze the same "
                f"bytes")

    def tier_drain_cell(self, pool, root, slog):
        """(g) SIGTERM the pool; fsck; the merged fleet trace."""
        from sofa_tpu_torch import metrics, telemetry
        from sofa_tpu_torch.archive import tier

        t0 = time.perf_counter()
        pool.send_signal(signal.SIGTERM)
        rc = pool.wait(timeout=180)
        term_s = time.perf_counter() - t0
        with open(slog) as f:
            out = f.read()
        exits = re.findall(r"serve: worker (\d+) exited (\S+)", out)
        handled = [ln.split("serve handled: ")[-1] for ln in
                   out.splitlines() if "serve handled:" in ln]
        depths = {t: tier.wal_depth(os.path.join(root, "tenants", t))
                  for t in os.listdir(os.path.join(root, "tenants"))}
        r, fsck_s = self.board_cli("fsck", root)
        doc = metrics.export_fleet_trace(root)
        spans = [e for e in (doc or {}).get("traceEvents", [])
                 if e.get("ph") == "X"]
        trace = telemetry.load_manifest(os.path.join(
            os.path.dirname(root), "watch_a",
            "llama"))["meta"]["metrics"]["trace"]
        mine = [e for e in spans if (e.get("args") or {}).get("trace")
                == trace]
        names = {e["name"] for e in mine}
        if rc != 0 or sorted(exits) != [(str(w), "0") for w in range(4)] \
                or any(depths.values()) or "Traceback" in out or any(
                    re.search(r"\b500", h) for h in handled) or \
                r.returncode != 0 or \
                len({e["pid"] for e in spans}) < 2 or \
                not {"commit", "wal_apply"} <= names:
            raise AssertionError(
                f"drain: rc {rc}, exits {exits}, WAL {depths}, fsck "
                f"{r.returncode}, trace {sorted(names)}: {out[-2500:]}")
        return (f"SIGTERM: rc 0 in {term_s:.2f} s, workers {exits} exited "
                f"0, every WAL 0, {len(handled)} handled lines with no 500 "
                f"and no traceback; fsck of the root rc 0 in {fsck_s:.2f} "
                f"s; fleet trace: {len(spans)} spans from "
                f"{len({e['pid'] for e in spans})} processes, the Llama "
                f"push's trace {trace} in {sorted(names)} over "
                f"{len({e['pid'] for e in mine})} process(es)")

    # A served root whose scrape loop stalls after its first scrape: the
    # plan is installed in-process, where the loop runs; an agent then
    # pushes a capture, and ``status`` and ``status --fleet`` are read.
    TIER_STALE_CHILD = (
        "import json, os, subprocess, sys, threading, time, types\n"
        "root, watch, token, wait = sys.argv[1], sys.argv[2], "
        "sys.argv[3], float(sys.argv[4])\n"
        "os.environ['SOFA_METRICS_SCRAPE_S'] = '0.5'\n"
        "from sofa_tpu_torch import faults\n"
        "from sofa_tpu_torch.archive.service import service_url, sofa_serve\n"
        "from sofa_tpu_torch.config import SofaConfig\n"
        "cfg = SofaConfig(logdir=os.path.join(root, 'u'), serve_token=token,"
        " serve_port=0)\n"
        "httpd = sofa_serve(cfg, root=root, serve_forever=False)\n"
        "threading.Thread(target=httpd.serve_forever, daemon=True).start()\n"
        "while not httpd.metrics.last_scrape_unix:\n"
        "    time.sleep(0.05)\n"
        "faults.install_from(types.SimpleNamespace("
        "inject_faults='service:scrape_stall'))\n"
        "time.sleep(wait)\n"
        "url = service_url(httpd)\n"
        "env = dict(os.environ, CUDA_VISIBLE_DEVICES='')\n"
        "def cli(*argv):\n"
        "    return subprocess.run([sys.executable, '-m', 'sofa_tpu_torch',"
        " *argv], env=env, capture_output=True, text=True, timeout=600)\n"
        "a = cli('agent', watch, '--once', '--service', url, '--token', "
        "token, '--spool', os.path.join(root, 'spool'), '--settle_s', '0')\n"
        "logdir = os.path.join(watch, 'resnet')\n"
        "st = cli('status', logdir)\n"
        "fl = cli('status', '--fleet', url, '--token', token)\n"
        "def warn(text, key):\n"
        "    return next((ln for ln in text.splitlines() if key in ln), '')\n"
        "from sofa_tpu_torch import telemetry\n"
        "mm = telemetry.load_manifest(logdir)['meta']['metrics']\n"
        "print(json.dumps({'agent_rc': a.returncode, 'age_s': "
        "mm.get('scrape_age_s'), 'stalled': httpd.metrics.snapshot()[0]"
        ".get('scrape_stalled_total'), 'status_warning': warn(st.stdout + "
        "st.stderr, 'had not scraped'), 'fleet_warning': warn(fl.stdout + "
        "fl.stderr, 'may be stalled')}))\n"
        "httpd.shutdown()\n"
        "httpd.server_close()\n")

    # -- live ------------------------------------------------------------------
    def live(self):
        """(a) ``record`` of the training main at Llama-3-8B width cut to
        2 layers, batch 1, its Kineto window closing while it runs, with
        ``live --live_interval_s 2`` beside it until the job has exited
        and one more epoch has committed; each committed epoch's
        ``meta.live`` and the ledger are read as it lands (the run
        journal's ``commit``).  (b) ``viz`` over the logdir from the first
        commit on: every fetch of report.js 200, never 503."""
        import statistics

        from sofa_tpu_torch import telemetry
        from sofa_tpu_torch.live import OFFSETS_NAME

        width = LLAMA_WIDTH.replace("--n_layers 4",
                                    f"--n_layers {LIVE_LAYERS}")
        cmd = (f"{sys.executable} -m sofa_tpu_torch.workloads.transformer "
               f"--steps {LIVE_STEPS} --batch 1 {width}")
        logdir = os.path.join(REPO, "build", "chip_smoke_live")
        shutil.rmtree(logdir, ignore_errors=True)
        t0 = time.perf_counter()
        rec = subprocess.Popen(
            [sys.executable, "-m", "sofa_tpu_torch", "record", "--logdir",
             logdir, "--kineto_host_tracer_level", "0", "--kineto_delay_s",
             str(LIVE_KINETO[0]), "--kineto_duration_s", str(LIVE_KINETO[1]),
             cmd], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        rec_out = []
        reader = threading.Thread(target=lambda: rec_out.extend(rec.stdout),
                                  daemon=True)
        reader.start()
        # live starts once record has laid down its time base
        while not os.path.isfile(os.path.join(logdir, "sofa_time.txt")):
            if rec.poll() is not None or time.perf_counter() - t0 > 120:
                raise AssertionError("record wrote no sofa_time.txt: "
                                     + "".join(rec_out)[-3000:])
            time.sleep(0.1)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        lv = subprocess.Popen(
            [sys.executable, "-u", "-m", "sofa_tpu_torch", "live", logdir,
             "--live_interval_s", str(LIVE_INTERVAL_S), "--jobs",
             str(LIVE_JOBS)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lv_out = []
        lreader = threading.Thread(target=lambda: lv_out.extend(lv.stdout),
                                   daemon=True)
        lreader.start()
        epochs, fetches, t_exit, begun = [], [], None, {}
        stop_fetch = threading.Event()
        journal = os.path.join(logdir, "_journal.jsonl")

        def fetch_loop(get):
            while not stop_fetch.is_set():
                try:
                    status = get("/report.js")[0]
                except OSError as e:
                    status = repr(e)
                fetches.append((time.time(), status))
                time.sleep(1.0)

        def epoch_doc(e):
            # record merges its own sections into the manifest too: a
            # read racing its write may see the epoch before; read again
            for _ in range(40):
                doc = telemetry.load_manifest(logdir) or {}
                meta = (doc.get("meta") or {}).get("live") or {}
                if meta.get("epoch") == e["epoch"]:
                    with open(os.path.join(logdir, OFFSETS_NAME)) as f:
                        ledger = json.load(f)
                    return {"epoch": e["epoch"], "begun": begun[e["epoch"]],
                            "committed": e["t"], "meta": meta,
                            "wall_s": doc["runs"]["live"]["wall_s"],
                            "ledger_chunks": sum(
                                len(v["chunks"])
                                for v in ledger["sources"].values())}
                time.sleep(0.05)
            raise AssertionError(f"the manifest holds epoch "
                                 f"{meta.get('epoch')} at epoch "
                                 f"{e['epoch']}'s commit")

        try:
            with viz_served(logdir, 8790, "live") as (_port, get):
                fetcher = threading.Thread(target=fetch_loop, args=(get,),
                                           daemon=True)
                fetcher.start()
                deadline = time.perf_counter() + 300
                while True:
                    if time.perf_counter() > deadline:
                        raise AssertionError("no live epoch committed after "
                                             "the job exited")
                    if lv.poll() is not None:
                        raise AssertionError("live exited early: "
                                             + "".join(lv_out)[-3000:])
                    if t_exit is None and rec.poll() is not None:
                        t_exit = time.time()
                    entries = []
                    if os.path.isfile(journal):
                        with open(journal) as f:
                            entries = [json.loads(ln) for ln in f
                                       if '"live"' in ln
                                       and ln.endswith("\n")]
                    for e in entries:
                        if e["ev"] == "begin":
                            begun[e["epoch"]] = e["t"]
                        elif e["epoch"] > len(epochs):
                            epochs.append(epoch_doc(e))
                    if t_exit is not None and any(
                            x["begun"] > t_exit for x in epochs):
                        break
                    time.sleep(0.1)
                stop_fetch.set()
                fetcher.join(timeout=60)
        finally:
            stop_fetch.set()
            for proc in (lv, rec):
                if proc.poll() is None:
                    proc.send_signal(signal.SIGINT)
            for proc in (lv, rec):
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            reader.join(timeout=10)
            lreader.join(timeout=10)
        # (b) counts the fetches once report.js exists: after epoch 1
        fetches = [(t, st) for t, st in fetches if t > epochs[0]["committed"]]
        log("\n".join(f"  | {ln.rstrip()}" for ln in lv_out
                      if ln.startswith(("[PROGRESS] live", "[WARNING]"))))
        rec_text = "".join(rec_out)
        log("\n".join(f"  | {ln[:300]}" for ln in rec_text.splitlines()
                      if ln.startswith("transformer:")))
        if rec.returncode != 0 or lv.returncode != 0:
            raise AssertionError(f"record rc {rec.returncode}, live rc "
                                 f"{lv.returncode}: {rec_text[-3000:]} "
                                 + "".join(lv_out)[-3000:])
        self.live_logdir = logdir
        line = self.live_checks(logdir, epochs, t_exit, fetches)
        walls = [e["wall_s"] for e in epochs]
        with open(os.path.join(logdir, "gpumon.txt")) as f:
            peak = max(int(ln.split()[4]) for ln in f if ln.strip())
        log(f"live[a]: {line}; epoch wall median "
            f"{statistics.median(walls):.3f} s, max {max(walls):.3f} s over "
            f"{len(walls)} epochs; the job's peak {peak / 1e9:.3f} GB "
            f"(gpumon); phase {time.perf_counter() - t0:.1f} s | {self.smi}")

    def live_checks(self, logdir, epochs, t_exit, fetches):
        """The checks of cells (a) and (b) over the committed epochs."""
        from sofa_tpu_torch.preprocess import KINETO_FRAMES

        during = [e for e in epochs if e["committed"] < t_exit]
        streaming = [e["epoch"] for e in during
                     if e["meta"]["sources"].get("gpumon", {}).get("status")
                     == "streaming"]
        parsed = sum(e["meta"]["chunks_parsed"] for e in epochs)
        loaded = [e["meta"]["chunks_loaded"] for e in epochs]
        marks = [e["meta"]["watermark_s"] for e in epochs
                 if e["meta"]["watermark_s"] is not None]
        with open(os.path.join(logdir, "sofa_time.txt")) as f:
            tb = float(f.read().split()[0])
        with open(os.path.join(logdir, "gpumon.txt")) as f:
            last_sample = max(int(ln.split()[0]) for ln in f
                              if ln.strip()) / 1e9 - tb
        problems = []
        if [e["epoch"] for e in epochs] != list(range(1, len(epochs) + 1)):
            problems.append(f"epochs seen {[e['epoch'] for e in epochs]}")
        if len(during) < 3 or len(streaming) < 2:
            problems.append(f"{len(during)} epochs while the job ran, "
                            f"gpumon streaming in {streaming}")
        if parsed != epochs[-1]["ledger_chunks"]:
            problems.append(f"{parsed} chunks parsed, the ledger committed "
                            f"{epochs[-1]['ledger_chunks']}")
        if loaded != sorted(loaded) or loaded[-1] <= loaded[0]:
            problems.append(f"chunks_loaded {loaded}")
        if marks != sorted(marks) or not marks \
                or abs(marks[-1] - last_sample) > LIVE_WATERMARK_S:
            problems.append(f"watermarks {marks}, last gpumon sample "
                            f"{last_sample:.3f} s")
        # the capture landing: the first epoch after epoch 1 whose dirty
        # frames hold the Kineto ones, and that epoch's kernel frame.  An
        # epoch rescans the capture after its tail step, so the epoch in
        # flight when the capture landed may mark it; else the first one
        # begun after it must.  None that committed before the landing may.
        captures = sorted(glob.glob(os.path.join(logdir, "kineto", "*.json")))
        landed = min(os.path.getmtime(p) for p in captures) if captures \
            else None
        marked = [e for e in epochs[1:]
                  if set(KINETO_FRAMES) <= set(e["meta"]["dirty"])]
        first_after = next((e for e in epochs if landed is not None
                            and e["begun"] > landed), None)
        in_flight = next((e for e in epochs if landed is not None
                          and e["begun"] <= landed < e["committed"]), None)
        may_mark = {e["epoch"] for e in (in_flight, first_after) if e}
        if not marked or first_after is None \
                or marked[0]["epoch"] not in may_mark:
            problems.append(f"the capture landed at {landed}; epochs "
                            f"marking the Kineto frames "
                            f"{[e['epoch'] for e in marked]}, in flight at "
                            f"the landing "
                            f"{in_flight and in_flight['epoch']}, first "
                            f"after it {first_after and first_after['epoch']}")
        gpu = frame(logdir, "gputrace")
        kern = gpu[gpu["copyKind"] == 0]
        module = kern["module"].fillna("").astype(str)
        steps = sorted({m for m in module if re.fullmatch(r"sofa_step_\d+",
                                                          m)},
                       key=lambda m: int(m.rsplit("_", 1)[1]))
        names = ("sofa_flash_fwd", "sofa_flash_bwd_kv", "sofa_flash_bwd_dq")
        per_step = {m: tuple(int(kern.loc[module == m, "name"].astype(str)
                                 .str.contains(n).sum()) for n in names)
                    for m in steps[1:-1]}
        bad_steps = {m: c for m, c in per_step.items()
                     if c != (LIVE_LAYERS,) * 3}
        totals = {n: int(kern["name"].astype(str).str.contains(n).sum())
                  for n in names}
        if len(per_step) < 3 or bad_steps:
            problems.append(f"{len(per_step)} whole steps in the window, "
                            f"steps off the 2-layer rule {bad_steps}")
        clean = [e for e in epochs if marked and e["epoch"] > marked[0][
            "epoch"] and "gpumon" in e["meta"]["dirty"]
            and not set(KINETO_FRAMES) & set(e["meta"]["dirty"])
            and e["meta"]["passes"]["skipped_clean"] > 0
            and e["meta"]["tiles"]["rebuilt"] < e["meta"]["tiles"]["kept"]]
        statuses = sorted({st for _t, st in fetches})
        if not fetches or statuses != [200]:
            problems.append(f"report.js fetched {len(fetches)} times, "
                            f"statuses {statuses}")
        if not clean:
            problems.append("no epoch with gpumon dirty and the Kineto "
                            "frames clean skipped a pass clean with fewer "
                            "tiles rebuilt than kept")
        line = (f"{len(epochs)} epochs ({len(during)} while the job ran, "
                f"gpumon streaming in {len(streaming)}); chunks parsed "
                f"{parsed} = committed {epochs[-1]['ledger_chunks']}, loaded "
                f"{loaded[0]} -> {loaded[-1]}; watermark {marks[0]:.3f} -> "
                f"{marks[-1]:.3f} s (last gpumon sample {last_sample:.3f} s);"
                f" capture landed in epoch "
                f"{marked[0]['epoch'] if marked else None}, "
                f"{len(per_step)} whole steps of {LIVE_LAYERS} launches of "
                f"each kernel ({len(kern)} kernels, the flash ones "
                f"{json.dumps(totals)}); epoch "
                f"{clean[0]['epoch'] if clean else None}: passes "
                + (f"{clean[0]['meta']['passes']}, tiles "
                   f"{clean[0]['meta']['tiles']}" if clean else "-")
                + f"; (b) report.js fetched {len(fetches)} times, statuses "
                f"{statuses}")
        if problems:
            raise AssertionError(f"live: {problems}; {line}")
        return line

    def live_drain(self):
        """(c) over the live logdir cleaned back to its raw files (no card
        visible): one epoch with ``gpumon:tail_torn`` SIGKILLed
        inside its tile refresh, ``resume`` (meta.live.epoch up by one),
        ``live --drain`` (rc 0, active false); its report.js,
        features.csv, hints.txt and _tiles/ byte-identical to a batch
        ``preprocess`` + ``analyze`` after ``clean``; ``status`` prints the
        live line and the port's ``manifest_check --require-healthy``
        passes."""
        from sofa_tpu_torch import telemetry

        self.need("live")
        t0 = time.perf_counter()
        copy = self.live_logdir       # the live phase's checks are done
        self.check_clean(copy)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        # pyramids on every large frame (the kill point writes tiles); the
        # lanes beside it hold the host's cores
        viz = ("--viz_downsample_to", str(LIVE_VIZ), "--jobs",
               str(LIVE_JOBS))
        k = subprocess.run([sys.executable, "-c", self.LIVE_KILL_CHILD, copy,
                            "3", "gpumon:tail_torn@1", viz[1], viz[3]],
                           cwd=REPO,
                           env=env, capture_output=True, text=True,
                           timeout=600)
        before = (telemetry.load_manifest(copy) or {}).get("meta", {}) \
            .get("live", {}).get("epoch", 0)
        res, res_s = self.board_cli("resume", copy, *viz)
        after = telemetry.load_manifest(copy)["meta"]["live"]
        drain, drain_s = self.board_cli("live", copy, "--drain", *viz)
        status, _ = self.board_cli("status", copy)
        check, _ = self.board_cli_module(
            "sofa_tpu_torch.tools.manifest_check", copy, "--require-healthy")
        drained = telemetry.load_manifest(copy)["meta"]["live"]
        got = self.outputs(copy)
        self.check_clean(copy)
        batch = []
        for verb in ("preprocess", "analyze"):
            r, wall = self.board_cli(verb, "--logdir", copy, *viz)
            batch.append((verb, r.returncode, wall))
        want = self.outputs(copy)
        differ = sorted(set(got) ^ set(want)) + sorted(
            n for n in set(got) & set(want) if got[n] != want[n])
        live_line = [ln.strip() for ln in status.stdout.splitlines()
                     if ln.strip().startswith("live: epoch")]
        line = (f"(c) the killed epoch rc {k.returncode}, resume rc "
                f"{res.returncode} in {res_s:.1f} s (epoch {before} -> "
                f"{after['epoch']}), drain rc {drain.returncode} in "
                f"{drain_s:.1f} s (active {drained['active']}), status rc "
                f"{status.returncode} '{live_line[0] if live_line else ''}',"
                f" manifest_check --require-healthy rc {check.returncode}; "
                f"batch {batch}: {len(got)} files, differing {differ[:8]}")
        log(f"live[c]: {line}; phase {time.perf_counter() - t0:.1f} s | "
            f"{self.smi}")
        if k.returncode != -9 or res.returncode or after["epoch"] != \
                before + 1 or drain.returncode or drained["active"] \
                or status.returncode or not live_line or check.returncode \
                or any(rc for _v, rc, _w in batch) or differ or not got:
            raise AssertionError(f"live drain: {line}; {k.stderr[-1500:]} "
                                 f"{res.stdout[-1500:]} {drain.stdout[-1500:]}"
                                 f" {check.stdout[-1500:]}")

    # The JAX chaos matrix's live kill (tools/chaos_matrix.py:106-129): one
    # epoch with a stream fault, SIGKILLed at the n-th tile write.
    LIVE_KILL_CHILD = (
        "import os, signal, sys\n"
        "logdir, n, spec = sys.argv[1], int(sys.argv[2]), sys.argv[3]\n"
        "viz, jobs = int(sys.argv[4]), int(sys.argv[5])\n"
        "from sofa_tpu_torch import tiles\n"
        "count = [0]\n"
        "orig = tiles._write_tile\n"
        "def hook(*a, **kw):\n"
        "    count[0] += 1\n"
        "    if count[0] >= n:\n"
        "        os.kill(os.getpid(), signal.SIGKILL)\n"
        "    return orig(*a, **kw)\n"
        "tiles._write_tile = hook\n"
        "from sofa_tpu_torch.config import SofaConfig\n"
        "from sofa_tpu_torch.live import sofa_live\n"
        "sofa_live(SofaConfig(logdir=logdir, live_interval_s=0.0,\n"
        "                     inject_faults=spec, viz_downsample_to=viz,\n"
        "                     jobs=jobs),\n"
        "          epochs=1)\n")

    def board_cli_module(self, module, *argv):
        """``python -m <module> <argv>`` with no card visible."""
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                           env=env, capture_output=True, text=True,
                           timeout=600)
        return r, time.perf_counter() - t0

    def ring(self):
        """Ring and zig-zag flash attention at Llama-3-8B attention width
        (H 32, KVH 8, D 128, bf16) over four ranks, T = 4 x 2048 at B 4,
        every rank's hop bodies driven by the lockstep schedule on this
        card (the code a distributed run calls; only the rotation indexes
        a list): out and lse against the one-device forward kernel over
        the whole T, dq/dk/dv against the one-device backward kernels;
        at B 1, T = 4 x 1024, also against the plain versions; two runs
        bit-identical; each kernel launched once per (rank, hop, pair).
        Times the lockstep ring against the one-device kernels."""
        torch = self.torch
        from sofa_tpu_torch import kernels
        from sofa_tpu_torch.workloads import ring_flash as rf
        from sofa_tpu_torch.workloads.flash_cuda import (
            _flash_backward, _flash_backward_plain, _flash_forward,
            _flash_forward_plain)

        n, h, kvh, d = RING_RANKS, 32, 8, 128
        ring_counts = {}
        for b, t_local, plain in ((4, 2048, False), (1, 1024, True)):
            t = n * t_local
            q, k, v = self.flash_inputs(b, t, h, kvh, d, seed=61 + b)
            g = self.flash_inputs(b, t, h, kvh, d, seed=71 + b)[0]
            ref_out, ref_lse = _flash_forward(q, k, v, 0, True)
            refs = {"kernels": (ref_out, ref_lse, *_flash_backward(
                q, k, v, g, ref_out, ref_lse, 0, True))}
            if plain:
                p_out, p_lse = _flash_forward_plain(q, k, v, 0)
                refs["plain"] = (p_out, p_lse, *_flash_backward_plain(
                    q, k, v, g.contiguous(), p_lse,
                    (g.float() * p_out.float()).sum(-1).transpose(1, 2)
                    .contiguous(), 0))
            torch.cuda.synchronize()
            for zigzag in (False, True):
                label = (f"{'zigzag' if zigzag else 'ring'} B{b} "
                         f"T{n}x{t_local}")
                counts, got, times = self.ring_run(rf, (q, k, v, g), n,
                                                   zigzag)
                per = 3 if zigzag else 1
                want = per * n * n
                log(f"ring: {label} launches {json.dumps(counts)} ({want} "
                    f"each: {per} pair(s) x {n} hops x {n} ranks, masked "
                    f"hops included)")
                if any(counts[k.name] != want for k in kernels.HOPPER) or any(
                        counts[k.name] for k in kernels.GENERAL):
                    raise AssertionError(f"ring {label}: launches {counts}, "
                                         f"expected {want} of each Hopper "
                                         f"kernel")
                if b == 4:
                    ring_counts["zigzag" if zigzag else "ring"] = counts
                for ref_name, ref in refs.items():
                    self.ring_compare(f"{label} vs one-device {ref_name}",
                                      got, ref)
                if b == 4:
                    one = (cuda_ms(lambda: _flash_forward(q, k, v, 0, True),
                                   5),
                           cuda_ms(lambda: _flash_backward(
                               q, k, v, g, ref_out, ref_lse, 0, True), 5))
                    log(f"ring: {label} time by CUDA events: forward "
                        f"{times[0]:.3f} ms, backward {times[1]:.3f} ms for "
                        f"all {n} ranks' hops ({times[0] / n:.3f} / "
                        f"{times[1] / n:.3f} ms a rank), against the "
                        f"one-device kernels over T {t}: forward "
                        f"{one[0]:.3f} ms, backward {one[1]:.3f} ms | "
                        f"{self.smi}")
                    self.ring_trace(rf, (q, k, v, g), n, zigzag)
            if b == 4:
                # one logsumexp merge of a shard's float32 accumulator, the
                # plain PyTorch step between the ring's forward hops
                o = torch.zeros(b, t_local, h, d, device=self.dev)
                lse = torch.zeros(b, h, t_local, device=self.dev)
                o_i = q[:, :t_local].contiguous()
                merge_ms = cuda_ms(lambda: rf._lse_merge(o, lse, o_i, lse),
                                   10)
                log(f"ring: one _lse_merge at a shard's shape {tuple(o.shape)}"
                    f" {merge_ms:.3f} ms; the ring's {n * n} merges "
                    f"{n * n * merge_ms:.3f} ms | {self.smi}")
                del o, lse, o_i
            del q, k, v, g, refs, got
            torch.cuda.empty_cache()
        for kern in kernels.HOPPER:
            self.kernel_rows[kern.name]["ring_launches"] = {
                variant: c[kern.name] for variant, c in ring_counts.items()}

    def ring_shards(self, rf, qkvg, n, zigzag):
        """The ranks' shards of q, k, v, g (zig-zag chunks when
        ``zigzag``) and the inverse order (None for the plain ring)."""
        torch = self.torch
        t = qkvg[0].shape[1]
        order = (rf.zigzag_indices(t, n)[0] if zigzag else None)

        def shards(x):
            if order is not None:
                x = x[:, torch.from_numpy(order).to(x.device)]
            return [s.contiguous() for s in x.chunk(n, dim=1)]

        inv = None if order is None else torch.from_numpy(
            rf.zigzag_indices(t, n)[1]).to(qkvg[0].device)
        return (*(shards(x) for x in qkvg), inv)

    def ring_trace(self, rf, qkvg, n, zigzag):
        """One more lockstep forward, then backward, each under its own
        torch.profiler trace of the card: where each pass's span goes
        (the flash kernels, the other kernels: the plain PyTorch merges,
        accumulations, casts and state fills, memsets, copies) and the
        span's idle share, the time the host left the card empty."""
        import torch.profiler as tp

        torch = self.torch
        qs, ks, vs, gs, _ = self.ring_shards(rf, qkvg, n, zigzag)
        label = "zigzag" if zigzag else "ring"
        fwd = []
        passes = (("forward", lambda: fwd.extend(
                      rf.lockstep_forward(qs, ks, vs, zigzag))),
                  ("backward", lambda: rf.lockstep_backward(
                      qs, ks, vs, fwd[0], fwd[1], gs, zigzag)))
        for name, fn in passes:
            torch.cuda.synchronize()
            with tp.profile(activities=[tp.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            path = os.path.join(REPO, "build",
                                f"chip_smoke_ring_{label}_{name}.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                evs = [e for e in json.load(f).get("traceEvents", [])
                       if e.get("ph") == "X" and e.get("cat") in
                       ("kernel", "gpu_memset", "gpu_memcpy")]
            if not evs:
                raise AssertionError(f"ring {label} {name}: the trace holds "
                                     "no device event")
            spans = sorted((float(e["ts"]), float(e["ts"]) + float(
                e.get("dur", 0))) for e in evs)
            busy, end = 0.0, spans[0][0]
            for a, b in spans:
                busy += max(0.0, b - max(a, end))
                end = max(end, b)
            span = spans[-1][1] - spans[0][0]
            by, other = {}, {}
            for e in evs:
                nm = str(e.get("name", ""))
                cls = ("flash" if "sofa_flash" in nm else
                       "other kernels" if e["cat"] == "kernel" else
                       "memsets" if e["cat"] == "gpu_memset" else "copies")
                ms_n = by.setdefault(cls, [0.0, 0])
                ms_n[0] += float(e.get("dur", 0)) / 1e3
                ms_n[1] += 1
                if cls == "other kernels":
                    key = nm.split("<")[0].split("(")[0][-48:]
                    o = other.setdefault(key, [0.0, 0])
                    o[0] += float(e.get("dur", 0)) / 1e3
                    o[1] += 1
            top = sorted(other.items(), key=lambda x: -x[1][0])[:4]
            log(f"ring: {label} B{qs[0].shape[0]} T{n}x{qs[0].shape[1]} "
                f"{name} trace: span {span / 1e3:.3f} ms, device busy "
                f"{busy / 1e3:.3f} ms, idle share "
                f"{100 * (1 - busy / span):.1f} %; " + ", ".join(
                    f"{c} {v[0]:.3f} ms in {v[1]}" for c, v in by.items())
                + "; top other kernels " + ", ".join(
                    f"{k_} {v[0]:.3f} ms x{v[1]}" for k_, v in top)
                + f" | {self.smi}")

    def ring_run(self, rf, qkvg, n, zigzag):
        """The lockstep ring forward and backward over ``n`` shards, twice
        (bit-identical), with the launch counts of the first run (zeroed
        just before, read just after) and the second run's device times
        (the first one's include the allocator growing its pool)."""
        torch = self.torch
        from sofa_tpu_torch import kernels

        q = qkvg[0]
        qs, ks, vs, gs, inv = self.ring_shards(rf, qkvg, n, zigzag)

        def whole(parts, dim=1):
            x = torch.cat(parts, dim=dim)
            return x if inv is None else x.index_select(dim, inv)

        runs = []
        for i in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            if i == 0:
                kernels.reset_counts()
            ev[0].record()
            outs, lses = rf.lockstep_forward(qs, ks, vs, zigzag)
            ev[1].record()
            dqs, dks, dvs = rf.lockstep_backward(qs, ks, vs, outs, lses, gs,
                                                 zigzag)
            ev[2].record()
            torch.cuda.synchronize()
            if i == 0:
                counts = kernels.counts()
            times = (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]))
            runs.append((whole(outs), whole(lses, -1), whole(dqs),
                         whole(dks), whole(dvs)))
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        log(f"ring: {'zigzag' if zigzag else 'ring'} {tuple(q.shape)}: a "
            f"second run gives bit-identical out, lse, dq, dk, dv: {same}")
        if not same:
            raise AssertionError("the ring is not deterministic")
        return counts, runs[0], times

    def ring_compare(self, label, got, ref):
        """out within the forward limits, lse within LSE_ATOL, dq/dk/dv
        within GRAD_REL (max |err| over max |ref|)."""
        torch = self.torch
        out, lse, *grads = got
        r_out, r_lse, *r_grads = ref
        err = (out.float() - r_out.float()).abs()
        out_ok = bool((err <= OUT_ATOL + OUT_RTOL * r_out.float().abs()).all())
        lse_err = (lse - r_lse).abs().max().item()
        rels = {}
        for name, a, r in zip(("dq", "dk", "dv"), grads, r_grads):
            scale = r.float().abs().max().item()
            rels[name] = (a.float() - r.float()).abs().max().item() / scale
        ok = out_ok and lse_err <= LSE_ATOL and all(
            x <= GRAD_REL for x in rels.values()) and all(
            bool(torch.isfinite(x.float()).all()) for x in got)
        log(f"ring: {label}: out max|err| {err.max().item():.3e} lse "
            f"max|err| {lse_err:.3e}; max|err|/max|ref| " + " ".join(
                f"{n} {r:.3e}" for n, r in rels.items()) +
            f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the ring disagrees: {label}")

    # -- the mesh: the NCCL world of one, two gloo ranks on the card --------
    def mesh(self):
        """(1) torchrun with NCCL and one rank runs the transformer's main
        at the train phase's shape (--data 1 --seq_par 1, one step after
        the two warm-up steps) under ``stat``: its losses must equal the
        train phase's; logs what the capture
        holds for the gradient all-reduce.
        (2) two gloo ranks sharing the card at Llama width (--data 2, B 1
        each, one step after the warm-up) under ``stat``: two rank traces,
        device ids 0 and 1, both ranks' steps, gpu_step_skew.csv, the same
        loss on both ranks at every step, each flash kernel launched per
        rank as often as a one-rank run of as many steps, a merged topology
        of two ranks on one card, mesh_advice.txt,
        and comm-report.html rendered and served.  (3) the collectives
        microbench at one rank prints its single-device line."""
        # one step after the two warm-up steps (three to PR 12): the
        # losses of three passes are held to the train phase's
        steps = 1
        one = (f"{sys.executable} -m torch.distributed.run --nproc_per_node "
               f"1 --master_port {free_port()} -m "
               f"sofa_tpu_torch.workloads.transformer --steps {steps} "
               f"--batch 4 {LLAMA_WIDTH} --data 1 --seq_par 1")
        out = self.mesh_nccl_capture(one, steps)
        losses = mesh_losses(out)
        if 0 not in losses:
            raise AssertionError(f"the NCCL world of one printed no losses: "
                                 f"{out[-3000:]}")
        want = self.train_losses[:len(losses[0])]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses[0], want))
        log(f"mesh: NCCL world of one under stat: losses {losses[0]} against "
            f"the train phase's {want}: max relative difference {rel:.3e} "
            f"(limit {MESH_LOSS_REL}; exact: {losses[0] == want})")
        if len(losses[0]) != 2 + steps or rel > MESH_LOSS_REL:
            raise AssertionError("the NCCL world of one does not train as "
                                 "the unsharded step does")
        self.mesh_two_ranks(1)
        r = subprocess.run([sys.executable, "-m",
                            "sofa_tpu_torch.workloads.collectives"],
                           cwd=REPO, capture_output=True, text=True,
                           timeout=300)
        log(f"mesh: collectives at one rank: rc {r.returncode}: "
            f"{r.stdout.strip()!r}")
        if r.returncode or r.stdout.strip() != \
                "collectives: single device, nothing to do":
            raise AssertionError("the collectives microbench did not print "
                                 "its single-device line")

    def mesh_nccl_capture(self, cmd, steps):
        """``stat`` over the NCCL world of one: what the capture holds for
        the gradient all-reduce (record_param_comms rows and their
        arguments, NCCL kernels, copies) and what comm_profile makes of
        it.  Returns the run's output."""
        import glob

        feats, logdir, out = self.run_stat("mesh_nccl1", cmd)
        gpu = frame(logdir, "gputrace")
        host = frame(logdir, "hosttrace", ["name"])
        comms = int((host["name"] == "record_param_comms").sum())
        nccl = gpu[gpu["name"].astype(str).str.startswith("nccl")]
        kinds = gpu.groupby("copyKind").size().to_dict()
        args, info = None, {}
        for path in glob.glob(os.path.join(logdir, "kineto", "*.json")):
            with open(path) as f:
                doc = json.load(f)
            info = doc.get("distributedInfo") or info
            args = args or next(
                (e.get("args") for e in doc["traceEvents"]
                 if e.get("name") == "record_param_comms"), None)
        with open(os.path.join(logdir, "gpu_topo.json")) as f:
            topo = json.load(f)
        # the device work the collectives launched: rows whose launch
        # context holds a record_param_comms op
        under = gpu[gpu["op_path"].fillna("").astype(str).str.contains(
            "record_param_comms")]
        launched = under.groupby(["copyKind", "name"])["payload"].agg(
            ["count", "sum"]).reset_index().to_dict("records")
        log(f"mesh[nccl1]: device rows launched under record_param_comms "
            f"(copyKind, name, count, bytes): {launched}")
        log(f"mesh[nccl1]: {comms} record_param_comms rows; NCCL kernels "
            f"{nccl['name'].astype(str).str[:60].value_counts().to_dict()}; "
            f"gputrace rows by copyKind {kinds}; distributedInfo {info}; "
            f"one record_param_comms' args {json.dumps(args)}")
        log("mesh[nccl1]: comm_profile: " + ", ".join(
            f"{k} {v}" for k, v in feats.items() if str(k).startswith(
                ("comm_", "link_"))) + f"; comm.csv "
            + (open(os.path.join(logdir, "comm.csv")).read().strip()
               .replace("\n", " | ")
               if os.path.isfile(os.path.join(logdir, "comm.csv"))
               else "absent") + f"; topology devices {topo.get('devices')}")
        if info.get("rank") != 0 or info.get("backend") != "nccl" \
                or [d.get("id") for d in topo.get("devices", [])] != [0]:
            raise AssertionError("the NCCL capture lacks its rank or the "
                                 "rank's topology record")
        if not gpu[gpu["copyKind"] == 0]["name"].astype(str).str.contains(
                "sofa_flash").any():
            raise AssertionError("the NCCL capture lacks the flash kernels")
        return out

    def mesh_two_ranks(self, steps):
        """Two gloo ranks sharing the card under ``stat`` (--data 2) at
        Llama width, B 1 a rank, ``steps`` after the 2 warm-up steps (gloo's
        host all-reduce of these gradients takes 4-12 s a step)."""
        import pandas as pd

        from sofa_tpu_torch.kernels import HOPPER

        cmd = (f"{sys.executable} -m torch.distributed.run --nproc_per_node "
               f"2 --master_port {free_port()} -m "
               f"sofa_tpu_torch.workloads.transformer --steps {steps} "
               f"--batch 2 {LLAMA_WIDTH} --data 2 --backend gloo "
               "--share_device")
        t0 = time.perf_counter()
        feats, logdir, out = self.run_stat("mesh_gloo2", cmd)
        stat_s = time.perf_counter() - t0
        log("\n".join(f"  | {line}" for line in out.splitlines()
                      if line.startswith(("transformer:", "rank "))))
        losses = mesh_losses(out)
        traces = []
        for name in sorted(os.listdir(os.path.join(logdir, "kineto"))):
            with open(os.path.join(logdir, "kineto", name)) as f:
                info = json.load(f).get("distributedInfo")
            traces.append((name, info))
        ranked = sorted(i["rank"] for _, i in traces if i)
        gpu = frame(logdir, "gputrace")
        steps_df = frame(logdir, "gpusteps")
        names = [k.name for k in HOPPER]
        kern = gpu[gpu["copyKind"] == 0]
        per_rank = {int(dev): {n: int(rows["name"].astype(str).str.contains(
            n).sum()) for n in names} for dev, rows in kern.groupby(
            "deviceId")}
        # each kernel launches as often in every pass (warm-up or step):
        # the profile phase's measured counts, scaled to this run's passes
        want = {n: v * (2 + steps) // self.llama_passes
                for n, v in self.llama_launches.items()}
        if any(v % self.llama_passes for v in self.llama_launches.values()):
            raise AssertionError(f"the profile phase's launches "
                                 f"{self.llama_launches} are not the same "
                                 f"in each of its {self.llama_passes} passes")
        skew_path = os.path.join(logdir, "gpu_step_skew.csv")
        skew = pd.read_csv(skew_path) if os.path.isfile(skew_path) else None
        with open(os.path.join(logdir, "gpu_topo.json")) as f:
            topo = json.load(f)
        cards = {(d.get("host"), d.get("cuda_ordinal"), d.get("uuid"))
                 for d in topo.get("devices", [])}
        advice = os.path.join(logdir, "sofa_hints", "mesh_advice.txt")
        # each rank's sampler names its files by its rank in the group
        mon = sorted(f for f in os.listdir(logdir)
                     if f.startswith(("gpumon", "memprof")))
        gpumon = frame(logdir, "gpumon")
        mon_devs = sorted(gpumon[gpumon["deviceId"] >= 0]["deviceId"]
                          .unique().tolist())
        log(f"mesh[gloo2]: sampler files {mon}; gpumon device ids "
            f"{mon_devs}")
        log(f"mesh[gloo2]: stat {stat_s:.1f} s; traces "
            f"{[(n, i and i.get('rank')) for n, i in traces]}; gputrace "
            f"device ids {sorted(gpu['deviceId'].unique().tolist())}; "
            f"gpusteps per device "
            f"{steps_df.groupby('deviceId').size().to_dict()}; flash "
            f"launches per rank {per_rank} (a one-rank run of 2 + {steps} "
            f"passes: {want}); losses per rank {losses}")
        log(f"mesh[gloo2]: gpu_step_skew.csv "
            + (skew.to_string(index=False).replace("\n", " | ")
               if skew is not None else "absent")
            + f"; step_time_mean {feats.get('step_time_mean')} s, "
            f"step_skew_mean {feats.get('step_skew_mean')} s, "
            f"step_skew_max {feats.get('step_skew_max')} s; per-rank peaks "
            + ", ".join(f"{k} {v}" for k, v in feats.items()
                        if str(k).endswith("_hbm_peak_gb"))
            + f"; merged topology: {len(topo.get('devices', []))} ranks on "
            f"cards {cards} | {self.smi}")
        if os.path.isfile(advice):
            with open(advice) as f:
                log("mesh[gloo2]: mesh_advice.txt: "
                    + f.read().strip().replace("\n", " | "))
        if ranked != [0, 1] or sorted(gpu["deviceId"].unique()) != [0, 1]:
            raise AssertionError("the two-rank capture is not two ranks' "
                                 "traces on device ids 0 and 1")
        if sorted(steps_df[steps_df["deviceId"] >= 0]["deviceId"].unique()
                  ) != [0, 1] or skew is None or list(skew["count"]) != \
                [2] * steps or feats.get("step_skew_mean") is None:
            raise AssertionError("no step skew from both ranks' steps")
        if sorted(losses) != [0, 1] or losses[0] != losses[1] \
                or len(losses[0]) != 2 + steps:
            raise AssertionError(f"the ranks' losses differ: {losses}")
        self.gloo2_losses = losses[0]       # the tp phase's reference
        if any(per_rank.get(r) != want for r in (0, 1)):
            raise AssertionError(f"flash launches per rank {per_rank}, "
                                 f"expected {want}")
        if not {"gpumon.rank0.txt", "gpumon.rank1.txt"} <= set(mon) \
                or any(".pid" in f for f in mon) or "gpumon.txt" in mon \
                or mon_devs != [0, 1]:
            raise AssertionError(f"the ranks' sampler files {mon} are not "
                                 f"one per rank, or their rows are not on "
                                 f"device ids 0 and 1 ({mon_devs})")
        if len(topo.get("devices", [])) != 2 or len(cards) != 1:
            raise AssertionError("the merged topology does not name two "
                                 "ranks on one card")
        if not os.path.isfile(advice):
            raise AssertionError("no mesh_advice.txt")
        self.board_report("mesh_gloo2", logdir)
        if not os.path.isfile(os.path.join(logdir, "comm-report.html")):
            raise AssertionError("report did not stage comm-report.html")
        self.board_viz("mesh_gloo2", logdir, 8730)   # beside the board's


    # -- the rest of the multi-GPU work -------------------------------------
    def comm_capture(self, label, logdir):
        """What a gloo ranks' capture holds for its collectives: the
        ``record_param_comms`` ops (NCCL's; gloo records none) and the
        tracer's ``sofa_comms:<collective>:<ranks>`` ranges of every rank
        trace, and the gputrace rows launched under them (copyKind, name,
        groups, count, bytes), the rows the comm passes read.  Returns
        {collective: set of the groups its device rows carry}."""
        ops = {}
        for name in sorted(os.listdir(os.path.join(logdir, "kineto"))):
            with open(os.path.join(logdir, "kineto", name)) as f:
                doc = json.load(f)
            for e in doc.get("traceEvents", []):
                nm = str(e.get("name", ""))
                if nm == "record_param_comms":
                    args = e.get("args") or {}
                    nm = (f"record_param_comms:{args.get('Collective name')}"
                          f":{args.get('Process Group Ranks')}")
                elif not nm.startswith("sofa_comms:"):
                    continue
                ops[nm] = ops.get(nm, 0) + 1
        gpu = frame(logdir, "gputrace")
        path = gpu["op_path"].fillna("").astype(str)
        under = gpu[path.str.contains("record_param_comms|sofa_comms:")]
        launched = under.assign(collective=path[under.index].str.extract(
            r"sofa_comms:([a-z_]+):")[0].fillna("record_param_comms")
        ).groupby(["collective", "copyKind", "groups", "name"])[
            "payload"].agg(["count", "sum"]).reset_index()
        log(f"{label}: collectives in the rank traces (range: count) "
            f"{json.dumps(ops)}")
        log(f"{label}: gputrace rows launched under them (collective, "
            f"copyKind, groups, name, count, bytes): "
            f"{launched.to_dict('records')}; gputrace rows by copyKind "
            f"{gpu.groupby('copyKind').size().to_dict()}")
        for name in ("comm.csv", "link_matrix.csv"):
            path = os.path.join(logdir, name)
            log(f"{label}: {name} " + (open(path).read().strip().replace(
                "\n", " | ") if os.path.isfile(path) else "absent"))
        out = {}
        for row in launched.itertuples():
            if row.groups:
                out.setdefault(row.collective, set()).add(row.groups)
        return out

    def comm_links(self, label, logdir, pairs):
        """The comm passes over the capture's collectives: comm.csv counts
        them by kind, and link_matrix.csv books traffic both ways between
        the ranks of each of ``pairs`` (each pair within a group)."""
        import pandas as pd

        kinds = set(pd.read_csv(os.path.join(logdir, "comm.csv"))["kind"])
        mat = pd.read_csv(os.path.join(logdir, "link_matrix.csv"),
                          index_col=0)
        missing = [(a, b) for a, b in sorted(pairs)
                   if not (mat.loc[f"gpu{a}", f"gpu{b}"] > 0
                           or mat.loc[f"gpu{b}", f"gpu{a}"] > 0)]
        log(f"{label}: the comm passes' collective kinds "
            f"{sorted(k for k in kinds if k not in ('H2D', 'D2H', 'D2D'))}; "
            f"link_matrix.csv pairs without traffic {missing}")
        if missing or not kinds - {"H2D", "D2H", "D2D"}:
            raise AssertionError(f"the comm passes do not see the groups' "
                                 f"collectives: kinds {kinds}, pairs "
                                 f"{missing}")

    def tp(self):
        """(a) Four gloo ranks sharing the card under ``stat``: the
        training main at Llama-3-8B width (4 layers), tensor-parallel 2 x
        FSDP over data 2, B 2 (the mesh phase's global batch), one step
        after the two warm-up steps.  Every rank's losses equal, and
        within TP_LOSS_REL of the mesh phase's two data-parallel ranks;
        each rank launches each flash kernel as a one-rank run of as many
        passes does; four rank traces on device ids 0-3; the model and
        data groups apart in gputrace (the copies gloo launches inside the
        collectives carry their groups); mesh_advice.txt and
        comm-report.html."""
        from sofa_tpu_torch.kernels import HOPPER

        steps = 1
        cmd = (f"{sys.executable} -m torch.distributed.run --nproc_per_node "
               f"4 --master_port {free_port()} -m "
               f"sofa_tpu_torch.workloads.transformer --steps {steps} "
               f"--batch 2 {LLAMA_WIDTH} --data 2 --model 2 --fsdp "
               "--backend gloo --share_device")
        t0 = time.perf_counter()
        feats, logdir, out = self.run_stat("tp_fsdp4", cmd)
        stat_s = time.perf_counter() - t0
        losses = mesh_losses(out)
        gpu = frame(logdir, "gputrace")
        kern = gpu[gpu["copyKind"] == 0]
        names = [k.name for k in HOPPER]
        per_rank = {int(dev): {n: int(rows["name"].astype(str).str.contains(
            n).sum()) for n in names} for dev, rows in kern.groupby(
            "deviceId")}
        want = {n: v * (2 + steps) // self.llama_passes
                for n, v in self.llama_launches.items()}
        ranked = []
        for name in sorted(os.listdir(os.path.join(logdir, "kineto"))):
            with open(os.path.join(logdir, "kineto", name)) as f:
                info = json.load(f).get("distributedInfo") or {}
            ranked.append(info.get("rank"))
        peaks = {k: v for k, v in feats.items()
                 if str(k).endswith("_hbm_peak_gb")}
        ref = self.gloo2_losses
        rel = max((abs(a - b) / abs(b) for a, b in zip(losses.get(0, []),
                                                       ref)), default=None)
        log("\n".join(f"  | {line}" for line in out.splitlines()
                      if line.startswith(("transformer:", "rank "))))
        log(f"parallel[a]: TP 2 x FSDP 2 at Llama width, 4 gloo ranks on "
            f"the card: stat {stat_s:.1f} s; losses per rank {losses}; "
            f"the mesh phase's data-parallel pair {ref}: max relative "
            f"difference {rel} (limit {TP_LOSS_REL}); flash launches per "
            f"rank {per_rank} (a one-rank run of 2 + {steps} passes: "
            f"{want}); traces of ranks "
            f"{sorted(r for r in ranked if r is not None)}; gputrace device "
            f"ids {sorted(gpu['deviceId'].unique().tolist())}; "
            f"per-rank peaks {peaks} | {self.smi}")
        groups = self.comm_capture("parallel[a]", logdir)
        seen = set().union(*groups.values()) if groups else set()
        model_groups = {"[[0, 1]]", "[[2, 3]]"}
        data_groups = {"[[0, 2]]", "[[1, 3]]"}
        advice = os.path.join(logdir, "sofa_hints", "mesh_advice.txt")
        if os.path.isfile(advice):
            with open(advice) as f:
                log("parallel[a]: mesh_advice.txt: "
                    + f.read().strip().replace("\n", " | "))
        if sorted(losses) != [0, 1, 2, 3] or any(
                v != losses[0] for v in losses.values()) \
                or len(losses[0]) != 2 + steps:
            raise AssertionError(f"the TP ranks' losses differ: {losses}")
        if rel is None or rel > TP_LOSS_REL:
            raise AssertionError(f"the TP x FSDP losses {losses[0]} are not "
                                 f"within {TP_LOSS_REL} of the data-parallel "
                                 f"pair's {ref}")
        if any(per_rank.get(r) != want for r in range(4)):
            raise AssertionError(f"flash launches per rank {per_rank}, "
                                 f"expected {want}")
        for name in names:          # the Hopper kernels' rows
            self.kernel_rows[name]["tp_launches"] = {
                r: per_rank[r][name] for r in range(4)}
        if sorted(r for r in ranked if r is not None) != [0, 1, 2, 3] or \
                sorted(gpu["deviceId"].unique()) != [0, 1, 2, 3]:
            raise AssertionError("the TP capture is not four ranks' traces "
                                 "on device ids 0-3")
        if not (seen >= model_groups and seen >= data_groups):
            raise AssertionError(f"gputrace does not hold the model and "
                                 f"the data groups apart: {groups}")
        self.comm_links("parallel[a]", logdir, {(0, 1), (2, 3), (0, 2),
                                                (1, 3)})
        if not os.path.isfile(advice):
            raise AssertionError("no mesh_advice.txt")
        # the stat's analyze staged the board; the page reads these files
        missing = [f for f in ("comm-report.html", "comm.csv",
                               "link_matrix.csv", "commtrace.csv")
                   if not os.path.isfile(os.path.join(logdir, f))]
        if missing:
            raise AssertionError(f"the capture lacks {missing} for "
                                 f"comm-report.html")

    def tp_serve(self):
        """(b) Two gloo ranks sharing the card serve the model phase's 4
        requests (prompt 1024, 32 new) at Llama-3-8B width and depth,
        tensor-parallel 2 (``inference.main --data 1 --model 2``): both
        ranks' tokens identical, the first served token the model phase's
        one-device argmax or within SERVE_TP_LOGIT_TOL of its maximum.
        Its ranks peak at ~15 GB each while they draw the init."""
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "2", "--master_port", str(free_port()),
               "-m", "sofa_tpu_torch.workloads.inference", "--data", "1",
               "--model", "2", "--backend", "gloo", "--share_device",
               "--batch", "4", "--prompt", "1024", "--new_tokens", "32",
               "--n_layers", "32", "--d_model", "4096", "--n_heads", "32",
               "--n_kv_heads", "8", "--d_ff", "14336", "--vocab", "128256"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=900)
        secs = time.perf_counter() - t0
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("inference:")]
        log("\n".join(f"  | {ln}" for ln in lines
                      if " tokens [" not in ln))
        if r.returncode:
            raise AssertionError(f"the sharded serving failed (rc "
                                 f"{r.returncode}): {r.stderr[-3000:]}")
        import re

        # not per line: the two ranks' prints may interleave
        tokens = {int(m.group(1)): json.loads(m.group(2)) for m in
                  re.finditer(r"inference: rank (\d+) tokens "
                              r"(\[\[[\d,\s\[\]]*?\]\])", r.stdout)}
        ref = self.serve_ref
        first = [row[0] for row in tokens.get(0, [])]
        best = ref.max(-1).values
        gaps = [float(best[i] - ref[i, t]) for i, t in enumerate(first)]
        argmax = ref.argmax(-1).tolist()
        log(f"parallel[b]: sharded serving, TP 2 at Llama-3-8B width, 32 "
            f"layers, 2 gloo ranks on the card: {secs:.1f} s; tokens equal "
            f"on both ranks: {tokens.get(0) == tokens.get(1)}; first tokens "
            f"{first}, the one-device argmax {argmax}, their one-device "
            f"logits below its maximum by {gaps} (limit "
            f"{SERVE_TP_LOGIT_TOL}) | {self.smi}")
        if sorted(tokens) != [0, 1] or tokens[0] != tokens[1]:
            raise AssertionError("the serving ranks' tokens differ")
        if len(first) != 4 or any(g > SERVE_TP_LOGIT_TOL for g in gaps):
            raise AssertionError("the sharded serving's first tokens are "
                                 "not the one-device forward's argmax")

    def ep_pp(self):
        """(c) the expert-parallel MoE, (d) the lockstep pipeline, (e)
        ``dryrun_multigpu``: the small multi-rank workloads."""
        self.experts()
        self.pipeline()
        self.dryrun()

    def experts(self):
        """(c) The MoE ``main`` at its widths (vocab 8192, d 256, 2
        layers, 8 experts, B 8, T 256) on two gloo ranks sharing the card
        (--data 1 --expert 2) under ``stat``: losses that descend, equal on
        both ranks; what the capture holds for the all-to-all.  Then, in
        float32 with capacity factor 4.0 (no token dropped), each rank's
        expert-parallel logits against ``moe_ffn_dense``'s forward."""
        steps = 3
        cmd = (f"{sys.executable} -m torch.distributed.run --nproc_per_node "
               f"2 --master_port {free_port()} -m "
               "sofa_tpu_torch.workloads.moe "
               f"--steps {steps} --data 1 --expert 2 --backend gloo "
               "--share_device")
        t0 = time.perf_counter()
        feats, logdir, out = self.run_stat("moe_ep2", cmd)
        stat_s = time.perf_counter() - t0
        losses = mesh_losses(out, "moe")
        peaks = {k: v for k, v in feats.items()
                 if str(k).endswith("_hbm_peak_gb")}
        log(f"parallel[c]: MoE expert-parallel on 2 gloo ranks: stat "
            f"{stat_s:.1f} s; losses per rank {losses}; per-rank peaks "
            f"{peaks} | {self.smi}")
        groups = self.comm_capture("parallel[c]", logdir)
        if sorted(losses) != [0, 1] or losses[0] != losses[1] \
                or len(losses[0]) != 2 + steps \
                or not losses[0][-1] < losses[0][0]:
            raise AssertionError(f"the MoE losses do not descend alike: "
                                 f"{losses}")
        if groups.get("all_to_all_single") != {"[[0, 1]]"}:
            raise AssertionError(f"gputrace holds no all-to-all of the "
                                 f"expert group: {groups}")
        self.comm_links("parallel[c]", logdir, {(0, 1)})
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "2", "--master_port", str(free_port()),
               os.path.join(REPO, "chip_smoke.py"), "--moe-rank"]
        r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=600)
        rows = [json.loads(ln.split(" ", 1)[1]) for ln in
                r.stdout.splitlines() if ln.startswith("MOE_RANK ")]
        log(f"parallel[c]: float32, capacity factor 4.0: expert-parallel "
            f"logits against moe_ffn_dense's, per rank {rows} (limits atol "
            f"{MOE_ATOL}, rtol {MOE_RTOL})")
        if r.returncode or len(rows) != 2 or not all(x["ok"] for x in rows):
            raise AssertionError(f"the expert-parallel logits disagree with "
                                 f"the dense path's: {rows} "
                                 f"{r.stderr[-2000:]}")

    def pipeline(self):
        """(d) The pipeline at its main's widths (vocab 8192, d 256, 4
        heads, d_ff 512, 2 layers a stage, 4 microbatches, B 8, T 256) over
        four stages in float32, every stage's ticks in lockstep on the
        card (gloo sends no CUDA tensor, so the distributed ticks run on
        the CPU, in the tests): loss and gradients against
        ``_reference_forward``'s, remat against no remat."""
        torch = self.torch
        from sofa_tpu_torch.workloads import pipeline as pp
        from sofa_tpu_torch.workloads.transformer import param_leaves

        stages, batch, seq = 4, 8, 256
        cfg = pp.PipelineConfig(dtype=torch.float32, max_seq=seq)
        tokens = torch.randint(0, cfg.vocab, (batch, seq),
                               generator=self.gen(0), device=self.dev)

        def grads(tree):
            return {k: v.grad for k, v in zip(_leaf_names(tree),
                                              param_leaves(tree))}

        full = pp.init_params(cfg, stages * cfg.layers_per_stage, 0,
                              self.dev)
        for p in param_leaves(full):
            p.requires_grad_(True)
        logits = pp._reference_forward(full, tokens, cfg)[:, :-1]
        gold = logits.gather(-1, tokens[:, 1:, None])[..., 0]
        ref_loss = (torch.logsumexp(logits, -1) - gold).mean()
        ref_loss.backward()
        ref = grads(full)
        got = {}
        t0 = time.perf_counter()
        for remat in (False, True):
            c = dataclasses.replace(cfg, remat=remat)
            parts = [pp.stage_params(pp.init_params(
                c, stages * c.layers_per_stage, 0, self.dev), s, stages)
                for s in range(stages)]
            for part in parts:
                for p in param_leaves(part):
                    p.requires_grad_(True)
            loss = torch.stack(pp.lockstep_loss(parts, tokens, c)).sum()
            loss.backward()
            g = {}
            for name in ref:
                per = [grads(part)[name] for part in parts]
                g[name] = (torch.cat(per) if name[0] == "layers"
                           else sum(per))
            got[remat] = (loss.item(), g)
        secs = time.perf_counter() - t0
        loss, g = got[False]
        errs = {".".join(n): (g[n] - ref[n]).abs().max().item() for n in ref}
        remat_errs = {".".join(n): (got[True][1][n] - g[n]).abs().max()
                      .item() for n in ref}
        log(f"parallel[d]: lockstep GPipe, {stages} stages x "
            f"{cfg.layers_per_stage} layers, {cfg.n_microbatches} "
            f"microbatches, B {batch} T {seq}, float32, on the card: "
            f"{secs:.1f} s for both runs; loss {loss!r} against the "
            f"reference's {ref_loss.item()!r} (limit {PIPE_LOSS_TOL}); "
            f"gradients max|err| {errs} (limit {PIPE_GRAD_TOL}); remat "
            f"against no remat: loss {got[True][0]!r}, gradients "
            f"{remat_errs} (limit {PIPE_REMAT_TOL}); the distributed ticks "
            f"need P2P, which gloo refuses for CUDA tensors: held bit-equal "
            f"to the lockstep on CPU ranks by tests/test_torch_pipeline.py")
        if abs(loss - ref_loss.item()) > PIPE_LOSS_TOL or any(
                e > PIPE_GRAD_TOL for e in errs.values()):
            raise AssertionError("the lockstep pipeline disagrees with the "
                                 "reference forward")
        if abs(got[True][0] - loss) > PIPE_REMAT_TOL or any(
                e > PIPE_REMAT_TOL for e in remat_errs.values()):
            raise AssertionError("remat changes the pipeline's math")

    def dryrun(self):
        """(e) ``dryrun_multigpu`` over every card of the machine, one
        torchrun rank a card (``chip_smoke.py --dryrun``): its three lines,
        and each rank's launch counts after it: its transformer step (head
        dim 16, remat) runs the three general kernels and no Hopper
        kernel; on one card 2 layers give 4 forward launches (remat
        replays each) and 2 of each backward kernel, over more cards (a
        ring over the seq axis) each general kernel at least once a
        rank."""
        from sofa_tpu_torch import kernels

        n = self.torch.cuda.device_count()
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", str(n), "--master_port", str(free_port()),
             os.path.join(REPO, "chip_smoke.py"), "--dryrun", str(n)],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("dryrun_multigpu: ")]
        per_rank = {}
        for ln in r.stdout.splitlines():
            if ln.startswith("DRYRUN_COUNTS "):
                row = json.loads(ln.split(" ", 1)[1])
                per_rank[row.pop("rank")] = row
        log(f"parallel[e]: dryrun_multigpu({n}) in "
            f"{time.perf_counter() - t0:.1f} s: " + " | ".join(lines)
            + f"; launches per rank {per_rank}")
        if r.returncode or len(lines) != 3 or not all(
                ln.endswith(" ok") or "skipped" in ln for ln in lines):
            raise AssertionError(f"dryrun_multigpu did not print its lines: "
                                 f"{r.stderr[-2000:]}")
        want = {kernels.GEN_FWD.name: 4, kernels.GEN_BWD_KV.name: 2,
                kernels.GEN_BWD_DQ.name: 2}
        if n == 1:
            bad = any(c[name] != want.get(name, 0)
                      for c in per_rank.values() for name in c)
        else:
            bad = any(not c[name] if name in want else c[name]
                      for c in per_rank.values() for name in c)
        if sorted(per_rank) != list(range(n)) or bad:
            raise AssertionError(f"dryrun_multigpu's ranks did not run the "
                                 f"general kernels at head dim 16 as "
                                 f"{want}: {per_rank}")


def moe_rank() -> None:
    """One torchrun rank of the ``experts`` phase's float32 check: the MoE
    at its main's widths with capacity factor 4.0, the expert-parallel
    forward over (data 1, expert 2) on this rank's rows against the dense
    forward of the whole batch on the same global init; prints one JSON
    line."""
    import torch

    from sofa_tpu_torch.workloads import moe
    from sofa_tpu_torch.workloads.common import init_distributed, make_mesh

    info = init_distributed("gloo", share_device=True)
    mesh = make_mesh(("data", "expert"), (1, 2))
    cfg = moe.MoEConfig(dtype=torch.float32, capacity_factor=4.0,
                        max_seq=256)
    gen = torch.Generator(device=info.device)
    gen.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (8, 256), generator=gen,
                           device=info.device)
    with torch.no_grad():
        dense, _ = moe.forward(moe.init_params(cfg, 0, info.device), tokens,
                               cfg)
        ep, aux = moe.forward(moe.init_params(cfg, 0, info.device, mesh),
                              tokens, cfg, mesh)
    rows = moe._layout(cfg, 8, mesh).rows
    ref = dense[rows]
    err = (ep - ref).abs()
    ok = bool((err <= MOE_ATOL + MOE_RTOL * ref.abs()).all())
    print("MOE_RANK " + json.dumps({
        "rank": info.rank, "max_abs_err": err.max().item(),
        "max_rel_err": (err / ref.abs().clamp_min(1e-30)).max().item(),
        "aux": aux.item(), "ok": ok}), flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()


def dryrun_rank(n: int) -> None:
    """One torchrun rank of the ``ep_pp`` phase's ``dryrun_multigpu(n)``:
    its lines (rank 0's), then this rank's kernel launch counts as one
    JSON line."""
    from sofa_tpu_torch import kernels
    from sofa_tpu_torch.entry import dryrun_multigpu

    dryrun_multigpu(n)
    print("DRYRUN_COUNTS " + json.dumps(
        {"rank": int(os.environ["RANK"]), **kernels.counts()}), flush=True)


# The timed phases run alone, in order; then three lanes side by side, each
# a thread that runs its phases in order: the card's Llama-width runs at
# batch 4 and the multi-rank ones (up to 43 GB of the card at a time), its
# runs of at most 21 GB, and the host-only phases over the captures
# (``Smoke.need`` waits for what a phase reads from another lane).
PHASES = ("device", "kernel", "kernel_perf", "model", "train", "ring",
          "resnet")
LANES = (("profile", "cluster", "mesh", "tp", "tp_serve", "tooling",
          "examples", "chaos_tier"),
         ("live", "serve", "window", "faults", "ep_pp", "fleet_tier"),
         ("train_f32", "robust", "board", "cache", "verbs", "archive",
          "fleet_push", "live_drain"))
RESNET_BATCH, RESNET_STEPS = 32, 20      # bench.py:1180-1183's settings
# bare/profiled pairs, each in a fresh process: with two, the median is
# their mean and the paired t-test has one degree of freedom (its p-value
# is printed, not relied on; the overhead is 40 times the 5 % target)
RESNET_PAIRS = 2


def resnet_pass(logdir: str, level: int = 2) -> None:
    """One process of the ``resnet`` phase: ResNet-50 at batch 32, 224 x
    224, warmed up (the first step and cuDNN's search), then 20 train
    steps bare, 20 under ``api.profile(logdir)`` at trace detail ``level``
    with a sofa_step_N range each, and 20 bare after them; prints the
    seconds of each as one JSON line."""
    import contextlib

    import torch

    from sofa_tpu_torch import api
    from sofa_tpu_torch.config import SofaConfig
    from sofa_tpu_torch.workloads import resnet
    from sofa_tpu_torch.workloads.common import fence, step_annotation

    torch.backends.cudnn.benchmark = True
    batch, steps = RESNET_BATCH, RESNET_STEPS
    model, x = resnet.create(batch, 224, device="cuda")
    labels = torch.zeros(batch, dtype=torch.long, device=x.device)
    _, step = resnet.make_train_step(model)
    t0 = time.perf_counter()
    for _ in range(3):
        fence(step(x, labels))
    out = {"params": sum(p.numel() for p in model.parameters()),
           "warmup_s": time.perf_counter() - t0}

    def timed(annotate):
        fence(step(x, labels))      # outside the timed window
        t0 = time.perf_counter()
        for i in range(steps):
            with (step_annotation(i) if annotate
                  else contextlib.nullcontext()):
                loss = step(x, labels)
        fence(loss)
        return time.perf_counter() - t0, loss.item()

    out["bare"], _ = timed(False)
    with api.profile(logdir, cfg=SofaConfig(kineto_host_tracer_level=level)):
        out["profiled"], out["loss"] = timed(True)
    out["after"], _ = timed(False)
    print("RESNET_PASS " + json.dumps(out), flush=True)


def run_lane(smoke, phases, errors):
    """Runs ``phases`` in order on this thread.  The first failure is kept
    in ``errors`` (with its traceback logged) and stops every lane before
    its next phase."""
    for phase in phases:
        if smoke.failed.is_set():
            return
        t0 = time.perf_counter()
        log(f"=== {phase}")
        try:
            getattr(smoke, phase)()
        except BaseException as exc:
            errors.append(exc)
            smoke.failed.set()
            log(f"=== {phase} FAILED after {time.perf_counter() - t0:.1f} s\n"
                + "".join(traceback.format_exception(exc)).rstrip())
            return
        smoke.done[phase].set()
        log(f"=== {phase} ok in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--resnet-pass"]:
        resnet_pass(sys.argv[2], *map(int, sys.argv[3:4]))
        return 0
    if sys.argv[1:2] == ["--moe-rank"]:
        moe_rank()
        return 0
    if sys.argv[1:2] == ["--dryrun"]:
        dryrun_rank(int(sys.argv[2]))
        return 0
    adopted = adopt_orphans()
    smoke = Smoke()
    t_all = time.perf_counter()
    seen = {}

    def left_running(after):
        # what a phase leaves running outlives it by name here
        reap_children()
        new = {p: d for p, d in wait_descendants(2.0).items()
               if seen.get(p) != d}
        seen.update(new)
        for pid, desc in new.items():
            log(f"  still running after {after}: pid {pid} {desc}")

    try:
        for phase in PHASES:
            t0 = time.perf_counter()
            log(f"=== {phase}")
            getattr(smoke, phase)()
            log(f"=== {phase} ok in {time.perf_counter() - t0:.1f} s")
            left_running(phase)
        # the lanes' programs share the card with what this process holds
        torch.cuda.empty_cache()
        log(f"=== lanes: this process holds "
            f"{torch.cuda.memory_reserved() / 1e9:.3f} GB of the card")
        t0 = time.perf_counter()
        errors = []
        lanes = [threading.Thread(target=run_lane, args=(smoke, lane, errors),
                                  name=f"lane {i}")
                 for i, lane in enumerate(LANES, 1)]
        for lane in lanes:
            lane.start()
        for lane in lanes:
            lane.join()
        if errors:
            raise errors[0]
        log(f"=== lanes {' | '.join(' '.join(lane) for lane in LANES)} ok "
            f"in {time.perf_counter() - t0:.1f} s")
        left_running("the lanes")
    finally:
        left = stop_descendants()
        log(f"chip_smoke: {len(left)} processes still running when the "
            f"phases ended (subreaper {'set' if adopted else 'not set'}), "
            f"all stopped"
            + "".join(f"\n  pid {p} {d}" for p, d in left.items()))
    log(f"chip_smoke: all phases in {time.perf_counter() - t_all:.1f} s")
    from sofa_tpu_torch import kernels

    rows = smoke.kernel_rows
    launches = {n: r["launches"] for n, r in rows.items()}
    if sorted(rows) != sorted(k.name for k in kernels.KERNELS) or not all(
            launches.values()):
        raise AssertionError(f"the kernels line lacks a kernel or its main "
                             f"path's launches: {launches}")
    log(json.dumps({"kernels": list(rows.values())}))
    log(smoke.smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
