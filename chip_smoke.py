#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py                 # needs one CUDA card
    python3 chip_smoke.py --phases MC     # the lookup across every card
    python3 chip_smoke.py --phases MC-LM  # the sharded LMs across every card
    python3 chip_smoke.py --phases EX     # the example scripts' twins on the card

Phases (any failure raises and exits non-zero; each prints ``[phase X]
start`` and ``[phase X] ok <seconds>``, and a failed check prints ``[FAIL
X] <message>`` before it raises):

1. environment: Python/torch/CUDA versions and the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: every kernel of ``src/repro_torch/csrc`` with nvcc, in parallel;
3. main path: the port's serve entry point on full-width taobao (15 tables,
   3,142,468 rows, E=16) at batch 8192, 16,384 requests, K=8 plan cores,
   five times, with every launch counter set to 0 just before and read
   just after each run:
   A. the default EngineConfig with the paper's LIF fallback
      (``shard_rocks`` off): nine asymmetric L1 chunks through the fused
      ragged kernel, six symmetric GM-UB tables through the UB kernel;
   B. the symmetric planner priced under the ``ascend_910`` preset: GM,
      GM-UB and L1 tables through the GM, UB and L1 kernels;
   C. the serve CLI's own defaults (``shard_rocks`` on, ``degrade_after``
      left at the config's 3): a fully asymmetric plan (15 L1 chunks, no
      symmetric group) whose big regions, too large for shared memory, run
      through the fused kernel's device-memory gather;
   D. access reduction, as the JAX package's presets serve: ``zipf:1.2``
      traffic and pricing, ``access=full`` (batch dedup + the hot-row
      cache), ``tuning=sweep`` (the block-size sweep timed on the card),
      the ``a100`` cost-model preset (whose taobao plan has GM chunks to
      cache) and the CLI's ``shard_rocks``: the fused kernel's dedup,
      cache and sparse-gather modes in every served launch;
   E. path C's plan in the legacy dense stacked-slot layout
      (``layout=dense``): 15 whole-table chunks in (8, 2) slots, every slot
      padded to 1,141,737 rows (a 1.17 GB f32 buffer), through the dense
      kernel.
   Each checks the request accounting, finite logits, the launch counters
   (the join kernel, ``slot_rejoin``, launched once for each sparse lookup
   of the fused kernels the run made on the card, on every path), that its
   server has no plain fallback step, the pooled output of its
   last served batch against the same engine built on the CPU (the kernels'
   plain versions; path D's twin packs the block sizes the card's sweep
   chose), and that its served step moves the batch to the card through
   page-locked buffers: every index byte counted in
   ``index_copy_staged_bytes``, and no pageable copy to the card in the
   step's profile;
4. kernels: each kernel against its plain version on the card, in f32,
   bf16 and f16, at the shapes the main path gave it (plus every strategy
   code, padding steps, -1 and out-of-window ids for the fused kernel, and
   for its access modes a forced spill and forced one-hot and sparse
   gathers, which must agree bitwise), timed with CUDA events (``ms``) and
   by ``torch.profiler``'s device time of its own kernels (``device_ms``)
   beside its plain version and one PyTorch library call computing the
   same lookups (``F.embedding_bag``, a yardstick only, also in device
   time); the fused base kernel (K1, paths A and C and the mixed case) and
   the dense kernel (K8, path E) bitwise equal to their plain versions in
   every dtype, each call one kernel on the card (``kernels_ms``), with its
   vector or scalar path and its queries a thread, K1 with the CTAs an SM
   its vector kernel holds and also on path A with every region gathered
   (``stage_rows=0``), and both at each count of queries a thread
   (``queries_sweep``: the wrapper's pick within 10% of the best); the L1
   kernel (K4) with its mode, cluster size, rows per CTA,
   grid and CTA width, on path B's tables (table 2 must be served by a
   thread-block cluster), on one query of table 2 (the staging alone), at
   every cluster size that schedules and beyond, and on table 2 at each
   cluster size whose slice fits one CTA and on path B's smallest table
   resident, at 256 and 1024 threads a CTA (the pick); the GM kernel (K3)
   also with s=3, -1 padding and invalid ids; the dense kernel also on a
   small single-core stack with s=3, a batch tail, the zero row, an empty
   slot and ids outside [0, R]; the UB
   kernel bitwise for s=1, on a batch of one repeated row and on a batch of
   one id (the table sweep alone), each timed over the uniform batch, and
   with s=3, invalid ids and -1 padding; the dedup kernel array-equal to
   its plain op on path D's ids and on edge cases (all padding, one id,
   cap 1, a cap above the distinct count, s=3, slots wider than its bitmap
   window); the unique-row gather array-equal to its plain version in f32,
   bf16 and f16 at path D's cap and at the spill cap of 64; the access
   calls in f32 bitwise equal to their plain versions (s = 1); path D's
   served call profiled for its launches (no sort, scan or scatter kernel
   may run in it) and its device time by kernel; its vector scatter at
   each count of queries a thread (``scatter_queries``); and
   ``access_by_block_r``: path D's plan repacked on the card at each block
   size the sweep tries, the served call's device time by kernel and its
   launches beside ``F.embedding_bag``'s, each output bitwise equal to its
   plain version.  Path D's record carries the sweep's ``device_us`` for
   every candidate, and its pick must be the least.  The join
   (``slot_rejoin``, a kernel of the port's own) on path D's slot partials
   of its last served batch repeated 32 times along the batch (B =
   262,144, the benchmark's), and on paths D, C, A and E's own: bitwise
   equal to its plain version on the same card tensors and to the plain
   join it replaced (``_scatter_slots`` + ``_sparse_rejoin``), timed
   beside both, with its vector or scalar path and its bound (each
   schedule term's plane read once, each table's written once);
5. the shipped presets through the serve entry point, each at the
   preset's own batch, with the counts set to 0 just before and read just
   after each (these run last, so no profiler session of this script's own
   is open while a shadow build can run, and a sweep opens none; every
   shadow build thread is joined before the next phase):
   F. ``--preset taobao-zipf12 --drift zipf:1.2@80,hotset:0.01:0.9:-1@64
      --queries 73728`` (144 batches of 512: overlapped replans, the block-
      size sweep inside each shadow build, checksums every 64 batches);
   G. ``--preset huawei-dayparted --queries 24576`` (its day-parted
      schedule, overlapped replans, a 0.25 s deadline, adaptive batching);
   H. ``--preset tenrec-hotset --queries 65536`` (128 batches of 512, two
      cadence sweeps, null-row validation, a bounded shed-oldest queue).
   Gated only by what holds whatever the timing: every request accounted
   for, no failed, degraded or poisoned batch and no failed heal, no parity
   failure or replan error, at least one drift check and one shadow build
   on F and G, every served logit finite, the dedup kernel and the dedup
   and sparse modes launched (the presets' first plans carve no cache
   rows under the ``tpu_v5e`` preset, having no GM-coded chunk, and R's
   replans none either; path D and X gate the cache mode), and every
   engine the run built (its first and each finished rebuild) held against
   the same plan built on the CPU, under the engine's own histograms and
   block sizes (a rebuild on the card keeps the first engine's), on the
   last batch's inputs: the same packed
   schedule, the pooled output within 1e-5 and the logits within 1e-4.
   Replans and their batches, abandoned builds, sheds, deadline misses,
   latency, wall per batch, each rebuild's seconds and block size, and the
   integrity sweep's cost are recorded and not gated;
   R. F replayed deterministically (no overlap, no deadline, 128 batches)
      on the card and then on the CPU with the same seed, the CPU twin
      packing the block sizes the card's engines packed: the same replan
      batches, the last batch's pooled output within 1e-5 and its logits
      within 1e-4, served by the engine of the last swap on both;
   X. faults on taobao-zipf12's plan with a fixed fault plan and seed: a
      bit flip found by the next cadence sweep (the regions the CPU engine
      reports for the same fault) and healed bitwise; NaN rows caught by
      the output guard and healed; the bit flip again on the plan priced
      under the ``a100`` preset, whose residency cache its served batches
      launch and its heal rebuilds, then held against its CPU twin; a step
      crash failing only its batch;
      one stalled replan (overlap on) abandoned after
      ``build_timeout_batches``, the stall released only after that;
6. the two-level mesh and the scenario towers, last:
   M. the serve CLI on full-width taobao at batch 8192 (16,384 requests)
      with ``planner=hierarchical`` on a ``[2,4]`` mesh, ``access=dedup``
      and ``zipf:1.2`` priced under ``a100`` (whose plan row-shards tables
      0, 1, 3, 4 and 5 over both hosts): one card holds the whole mesh, a
      host being a group of plan cores.  Gated as the main path (the CPU
      twin included), and: two hosts and those five tables in the plan's
      mesh record, an owner core on each host for a row-sharded table, no
      cross-host send and no symmetric group, the dedup kernels launched,
      the report's host tree and mesh line, and the join on the served
      batch's slot partials bitwise equal to its plain version (the plain
      join on the card sums a table's owners in no fixed order: within
      1e-5);
   S. each registered scenario tower (dlrm, mamba2, moe, transformer) built
      by name from its registry config and served for 16 batches of 64:
      every request served, the last batch's scores bitwise equal to the
      scenario's reference forward on the card and within 1e-4 of its CPU
      twin, and every kernel whose wrapper the CPU twin's lookup calls
      launched;
7. training, T (each gate independent of the clock):
   T-grad. ``ops.embedding_bag``'s table gradient (the strategy kernel's
      forward, the ``index_add_`` scatter-add backward) on path B's three
      strategy tables of taobao (table 0 GM, 1,141,730 rows; table 1
      GM-UB, 846,812; table 2 L1, 12,978), E = 16, batch 8192, s = 1 and
      3 in f32 and table 1 at s = 3 in bf16, each within 1e-5 of autograd
      of the plain lookup; the GM, UB and L1 kernels' launches are this
      path's counts and join the kernels line;
   T-dlrm. the DLRM trained at the served width (taobao's 15 tables, batch
      8192, Adagrad) through ``training.loop.train``: 8 steps with a
      checkpoint every 4, the first 3 losses within rtol 1e-4 of a CPU
      twin's; a run failing at step 6 resumes from the step-4 checkpoint
      and ends within 1e-5 of the uninterrupted run;
   T-lm. olmo-1b at its published width, depth cut to 4 layers (the
      ``reduced`` field): 3 AdamW steps at 2 x 512 in f32, the first loss
      within 1e-4 relative of the CPU twin's; prefill 2 x 256 and 16
      teacher-forced decode steps within the JAX package's bound of the
      full forward; one train step, prefill and decode at bf16, finite;
   T-moe, T-swa, T-ssm, T-hybrid. the moe, ssm and hybrid families at
      their published widths, depth cut (``reduced``), random init: granite-
      moe-3b-a800m at 4 of 32 layers (3 AdamW steps at 2 x 512, the first
      loss and aux within 1e-4 relative of the CPU twin's; prefill 2 x 256
      and 16 decode steps within ``1e-4 * max(|ref|, 1)`` of the CPU twin's
      decode, since the forward at 256-token groups drops tokens and a
      decode step does not); mixtral-8x22b at 1 of 56 layers, serve only
      (prefill 1 x 5120, past its 4096-token window, and 16 decode steps
      through the rolling cache, timed at the published capacity with its
      drops counted; then, the capacity raised to ``n_experts`` so that
      nothing drops (the JAX package's own decode test), within its bound
      of the card's full forward over 5,136 tokens, no assignment dropped;
      the batch-split prefill at ``prefill_32k`` with 2 x 5120 against the
      unsplit one: caches within 1e-5, logits within ``1e-5 * max(|ref|,
      1)``); mamba2-780m at 4 of 48 layers and zamba2-1.2b at
      7 of 38 (one group of 6 mamba layers, the shared block, 1 trailing
      layer): 3 AdamW steps at 2 x 512 against the CPU twin's first loss,
      prefill 2 x 300 (not a multiple of the SSD chunk) and 16 decode steps
      within the JAX package's bound of the full forward.  Then a train step
      (where there is one), a prefill and a decode step at bf16, finite.
      Each model's parameters are freed before the next;
   T-encdec, T-vlm. the encdec and vlm families at their published widths:
      whisper-small whole (12 encoder and 12 decoder layers; its conv
      frontend stubbed, frames random normal): 3 AdamW steps at 2 x 512
      frames and tokens against the CPU twin's first loss, then a prefill
      of 2 x 1500 frames (30 s of audio; not a multiple of the 1024-slot KV
      block or the query chunk) with a 2 x 64-token prompt and 16 decode
      steps (80 self-attention and 1500 cross slots), within the JAX
      package's bound of the card's full forward over the same frames and
      all 80 tokens; qwen2-vl-2b at 4 of 28 layers (its vision frontend
      stubbed, embeds random normal) on Qwen2-VL's M-RoPE layout (a text
      token at index i at (i, i, i), an image of gh x gw patches from s at
      (s, s + r, s + c), the text after it from s + max(gh, gw)): 3 AdamW
      steps at 2 x 512 (64 text tokens, a 16 x 24 image, 64 text tokens;
      the second row image first) against the CPU twin's first loss, a
      prefill of 2 x 256 (32 text, a 12 x 16 image, 32 text) and 16 text
      decode steps whose positions carry on from the layout, within the
      bound of the card's full forward over the 272 embeds; then bf16,
      finite, as above;
   T-shard. T-lm's olmo-1b (4 layers, f32) with a ``ShardCtx`` on the
      single-pod production mesh shape (data 16, model 16): the embedding
      as 16 vocab shards of 3,152 rows; one AdamW step at 2 x 512, a 2 x
      256 prefill and 16 decode steps against the same with ``ctx=None``:
      the loss within 1e-6 relative, the logits within ``1e-6 * max(|ref|,
      1)``; both ways' step, prefill and decode times and the embedding's
      device time;
   T-remat. the same model at 4 x 4096: the loss and every gradient with
      and without per-layer remat within 1e-6 relative; one step each way
      timed, with its peak allocated memory above the step's start;
   T-cli. the train CLI as a subprocess on the card for the DLRM (20
      steps), qwen3-0.6b, granite-moe-3b-a800m, whisper-small and
      qwen2-vl-2b (10 steps each): exit code 0 and ``[train] done``.

   EX. the twins of the five example scripts (``python -m
      repro_torch.examples.<name>``: quickstart, autoplan, serve_dlrm,
      train_dlrm with ``--crash``, lm_smoke) on the card at small
      arguments, each a subprocess under its own time limit: exit code 0,
      "OK" (autoplan prints plans only), quickstart's lookups within 1e-5
      of the dense oracle, and quickstart's and serve_dlrm's plans
      launching K1 and one of K2-K4.  Recorded: each twin's seconds, its
      last line and its kernels' launches.

8. the partitioned lookup across cards, MC: one NCCL rank per card
   (``torch.cuda.device_count()`` of them, spawned), each holding one
   plan core, through the serve CLI's multi-rank code on taobao (C:
   huawei-25mb) at batch 8192 (16,384 requests): on one card paths A and
   B at K=1; on W cards path A at K=W with each rejoin (sparse, psum,
   ring), path B, C (huawei-25mb with ``shard_rocks`` and
   ``rock_theta=0.5``: its heaviest multi-hot tables split over four
   cards) with each rejoin, path E's dense layout and, on four, M's
   hierarchical plan at ``[2,2]`` with ``access=full``.  Gated: every
   request served, finite logits, each rank's chunk bytes 1/W of the whole
   buffer, one batch's pooled output within 1e-5 of the one-card engine of
   the same plan, every kernel the plan's lookup launches launched on
   every rank (K1 and K2 on one card; K1-K4 and K8 on more; K5-K7 and the
   dedup kernel on four), and on four cards C's rejoin adding partials
   that ranks send each other (modeled all_to_all bytes above 0).  Recorded:
   each rank's allocated bytes, its core's lookup, the rejoin's and the
   symmetric group's times by CUDA events, the whole lookup across the
   cards, and the bytes the rejoin handed the collectives beside the
   modeled ones.  Then, on two or more cards, the taobao-zipf12 preset
   across them (``MC_DRIFT``): R replays F inline (gated: the replan
   batches and parity of the one-card engine of the same plan at K=W, run
   in rank 0's process, and every served logit within 1e-5 of its), F
   overlapped (gated: replans, no replan error or abandoned build, every
   request served, K5, K7 and the dedup kernel launched on every rank; K6's
   launches a rank recorded), I is F's first 24 batches with a sweep every
   8 after rank 1 flipped a bit in its first chunk region and rank W-1 in
   its tail (gated: both found at the first sweep under their global keys
   and healed, logits after it within 1e-5 of the one-card engine).  Every
   rank ends on rank 0's generation, and every follower holds no share of
   another generation than 0 and that one.  Recorded from rank 0's op log:
   each rank's shadow build seconds, the swap points' and sweeps' times and
   each generation's cache rows; and each rank's allocated bytes.

9. the sharded LMs across cards, MC-LM: one NCCL rank per card, a
   ``ShardCtx`` over the card mesh and every leaf a ``DTensor`` placed by
   the sharding rules; every LM family at its published width in f32:
   olmo-1b, granite-moe-3b-a800m, mamba2-780m, qwen2-vl-2b and
   chatglm3-6b (2 KV heads, partial RoPE) at 4 layers, zamba2-1.2b at 7
   (its shared block runs once), whisper-small at 4 encoder and 4 decoder
   layers and mixtral-8x22b at 1 (window 4096, rolling cache), on (1, 1)
   on one card, on (1, W), (W, 1) and, on four, (2, 2) on W cards.  Each
   run, on its family's inputs (``Bundle.make_batch``: token ids; frames
   beside token ids; embeds with M-RoPE positions): a train step's loss
   and gradients, one AdamW step at 4 x 512 (remat on; mixtral's gradients
   alone on one card, where its AdamW step does not fit), a 4 x 256
   prefill (mixtral: 4 x 5112 under ``prefill_32k``, past the window) and
   16 decode steps (mixtral's through rolling slots 1016-1031).  Gated
   against the same parameters and batches unsharded on rank 0's card:
   the loss within 1e-5 relative, every gradient leaf, the prefill's and
   each decode step's logits and the cache after decode within ``1e-5 *
   max(|ref|, 1)``; an MoE prefill's capacity drops equal to one card's;
   every rank's local bytes of the parameters, AdamW's moments and the
   caches equal to ``per_device_bytes`` of their specs (fewer parameter
   bytes than one card's on more than one card); on a mesh with no data
   split, at most two all-gathers a layer in a mamba2 decode step.
   Recorded per rank: step, prefill and decode-per-token times (host
   clock around synchronized work), the all-gathers of one train step
   and one decode step (``CommDebugMode``), peak allocated memory beside
   one card's, and whether each gate held bitwise.

``--phases`` runs a subset after the build (``main`` is paths A-E and the
kernel phase; e.g. ``--phases EX``, or ``--phases MC`` or ``--phases MC-LM``
on four cards).  The last line is
``{"ok": true, "device": {...}}``; with the kernel phase, the line before
it is the JSON record of every kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# f32 sums in another order; bf16/f16 rows convert exactly to f32
TOL = dict(rtol=1e-5, atol=1e-5)
# logits pass three MLP layers whose reductions also change order
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, published
CLI_ARGS = ["--workload", "taobao", "--batch", "8192", "--queries", "16384",
            "--distribution", "uniform", "--set", "mesh_shape=[1,8]"]
MAIN_ARGS = CLI_ARGS + ["--set", "degrade_after=0"]
ZIPF = "zipf:1.2"
PATHS = {
    "A": MAIN_ARGS + ["--set", 'planner_options={"shard_rocks": false}'],
    "B": MAIN_ARGS + ["--set", "planner=symmetric", "--set", "hardware=ascend_910"],
    "C": CLI_ARGS,
    "D": ["--workload", "taobao", "--batch", "8192", "--queries", "16384",
          "--distribution", ZIPF, "--set", "mesh_shape=[1,8]", "--set", f"distribution={ZIPF}",
          "--set", "access=full", "--set", "tuning=sweep", "--set", "hardware=a100"],
    "E": CLI_ARGS + ["--set", "layout=dense"],
}
# the three shipped presets as shipped (F, G, H), F replayed without
# overlap on the card and the CPU (R), and faults on taobao-zipf12's plan (X)
F_DRIFT = "zipf:1.2@80,hotset:0.01:0.9:-1@64"
PRESETS = {
    "F": ["--preset", "taobao-zipf12", "--drift", F_DRIFT, "--queries", "73728"],
    "G": ["--preset", "huawei-dayparted", "--queries", "24576"],
    "H": ["--preset", "tenrec-hotset", "--queries", "65536"],
}
# 128 batches of 512: the hot-set phase starts at batch 80 and the replans
# land before the last batch
R_ARGS = ["--preset", "taobao-zipf12", "--drift", F_DRIFT, "--queries", "65536",
          "--set", 'drift_options={"overlap": false}', "--set", "deadline_s=null"]
FAULT_SEED = 5
# the two-level mesh (M): taobao's hierarchical plan on a 2x4 mesh, priced
# under a100, whose plan row-shards five tables over both hosts (under
# tpu_v5e every table would sit whole on one host)
M_ARGS = ["--workload", "taobao", "--batch", "8192", "--queries", "16384",
          "--distribution", ZIPF, "--set", f"distribution={ZIPF}",
          "--set", "planner=hierarchical", "--set", "mesh_shape=[2,4]",
          "--set", "access=dedup", "--set", "hardware=a100", "--set", "degrade_after=0"]
M_ROCKS = [0, 1, 3, 4, 5]
# the scenario towers (S): 16 batches of 64 each, fixed arrivals
S_BATCHES = 16
ACCESS_SRC = "src/repro_torch/csrc/embedding_access.cu"
# the join is timed on path D's slot partials repeated to the benchmark's
# batch of 262,144 too
REJOIN_TILE = 32
KERNELS = {
    # name: (wrapper module, wrapper, launch mode counted (None = every
    # launch), source, the Pallas kernel it replaces (None: a kernel of the
    # port's own))
    "multi_embedding_bag_ragged": (
        "embedding_multi", "multi_embedding_bag_ragged", "base",
        "src/repro_torch/csrc/embedding_multi.cu", "src/repro/kernels/embedding_multi.py:139"),
    "embedding_bag_ub": ("embedding_ub", "embedding_bag_ub", None,
                         "src/repro_torch/csrc/embedding_ub.cu",
                         "src/repro/kernels/embedding_ub.py:34"),
    "embedding_bag_gm": ("embedding_gm", "embedding_bag_gm", None,
                         "src/repro_torch/csrc/embedding_gm.cu",
                         "src/repro/kernels/embedding_gm.py:27"),
    "embedding_bag_l1": ("embedding_l1", "embedding_bag_l1", None,
                         "src/repro_torch/csrc/embedding_l1.cu",
                         "src/repro/kernels/embedding_l1.py:25"),
    "multi_embedding_bag_ragged[dedup]": (
        "embedding_multi", "multi_embedding_bag_ragged", "dedup", ACCESS_SRC,
        "src/repro/kernels/embedding_multi.py:190"),
    "multi_embedding_bag_ragged[cache]": (
        "embedding_multi", "multi_embedding_bag_ragged", "cache", ACCESS_SRC,
        "src/repro/kernels/embedding_multi.py:244"),
    "multi_embedding_bag_ragged[sparse]": (
        "embedding_multi", "multi_embedding_bag_ragged", "sparse", ACCESS_SRC,
        "src/repro/kernels/embedding_multi.py:205"),
    "multi_embedding_bag_dense": (
        "embedding_multi", "multi_embedding_bag_dense", None,
        "src/repro_torch/csrc/embedding_dense.cu", "src/repro/kernels/embedding_multi.py:506"),
    "batch_dedup": ("embedding_multi", "batch_dedup", None,
                    "src/repro_torch/csrc/embedding_dedup.cu",
                    "src/repro/kernels/embedding_multi.py:281"),
    "slot_rejoin": ("embedding_rejoin", "slot_rejoin", None,
                    "src/repro_torch/csrc/embedding_rejoin.cu", None),
}


class SmokeError(RuntimeError):
    pass


_PHASE = ["setup"]  # the phase running now, named in a failure's message


@contextlib.contextmanager
def phase(label: str):
    """``[phase X] start`` and ``[phase X] ok <seconds>`` around a phase,
    flushed, so that a failed run's log names the phase it stopped in."""
    _PHASE[0] = label
    print(f"[phase {label}] start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[phase {label}] ok {time.perf_counter() - t0:.1f}", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        print(f"[FAIL {_PHASE[0]}] {msg}", flush=True)
        raise SmokeError(msg)


def wrappers():
    import importlib

    return {
        name: getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), fn)
        for name, (mod, fn, _, _, _) in KERNELS.items()
    }


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        for counts in (getattr(fn, "modes", {}), getattr(fn, "paths", {})):
            for key in counts:
                counts[key] = 0


def read_counts() -> dict:
    return {name: fn.modes[KERNELS[name][2]] if KERNELS[name][2] else fn.launches
            for name, fn in wrappers().items()}


@contextlib.contextmanager
def sparse_lookups():
    """Count, while the block runs, the lookups that must launch the join
    kernel once each: one-card lookups (no mesh) of the fused kernels with
    the sparse rejoin, on a pack on the card.  Every lookup goes through
    ``EmbeddingBag.apply`` and so through the embedding module's
    ``partitioned_lookup``, wrapped here; yields ``[count]``."""
    from repro_torch.core import embedding

    inner = embedding.partitioned_lookup
    seen = [0]

    def counted(packed, indices, **kw):
        out = inner(packed, indices, **kw)
        if (kw.get("mesh") is None and kw.get("use_kernels", "fused") == "fused"
                and kw.get("reduce_mode", "sparse") == "sparse" and packed.device.type == "cuda"):
            seen[0] += 1
        return out

    embedding.partitioned_lookup = counted
    try:
        yield seen
    finally:
        embedding.partitioned_lookup = inner


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the markers around the calls of each profiler session: a spin kernel of
# ATen's that nothing else in the port launches.  A session on the card can
# lose its first records, so a long marker (~5 ms) and eight short ones
# open a session and one closes it, and a session counts only when its
# recorded markers bracket the calls
OPEN_CYCLES = (10_000_000,) + (1_000,) * 8
MARK = "spin_kernel"


def profile_calls(fn, calls: int = 10, sessions: int = 3) -> dict:
    """The card's own time for ``fn``: ``torch.profiler`` device time of the
    CUDA kernels (and copies) it launches on the current stream, per call,
    summed over them, the number of such launches per call, and the time of
    each by name.  A session whose recorded markers do not bracket the
    calls, whose launches are no multiple of the calls, or that records no
    device time, is run again, up to ``sessions`` in all; then the time is
    "not measured"."""
    import torch

    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    ours = []
    for _ in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for cycles in OPEN_CYCLES:
                torch.cuda._sleep(cycles)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1_000)
            stream.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
        marks = [e.time_range.start for e in events if MARK in e.name]
        ids = {e.device_resource_id for e in events if MARK in e.name}
        ours = [e for e in events if e.device_resource_id in ids and MARK not in e.name]
        starts = [e.time_range.start for e in ours]
        # every call launches the same kernels: a count that is no multiple
        # of the calls means the session lost some of their records
        if (len(ids) == 1 and ours and len(ours) % calls == 0
                and min(marks) <= min(starts) <= max(starts) <= max(marks)
                and sum(e.self_device_time_total for e in ours) > 0):
            break
        ours = []
    kernels: dict = {}
    for e in ours:
        kernels[e.name] = kernels.get(e.name, 0.0) + e.self_device_time_total / calls / 1e3
    return {"device_ms": sum(kernels.values()) if kernels else "not measured",
            "launches_per_call": len(ours) / calls,
            "kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1]))}


def device_times(kernel, library=None) -> dict:
    """``device_ms`` and ``kernels_per_call`` of a kernel's wrapper call, and
    ``library_device_ms`` of its PyTorch yardstick."""
    prof = profile_calls(kernel)
    rec = {"device_ms": prof["device_ms"], "kernels_per_call": prof["launches_per_call"]}
    rec["library_device_ms"] = profile_calls(library)["device_ms"] if library else None
    return rec


def host_ms(fn, iters: int = 5) -> float:
    """Median host-clock time of ``fn`` (which ends in a synchronize)."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """Least time on the card: bytes over HBM rate vs f32 adds over peak."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def environment() -> str:
    import torch

    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    return line


def build_kernels() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build()
    print(f"[build] {len(report)} kernels built in {time.perf_counter() - t0:.1f}s "
          f"into {build.build_dir()}")
    for name, rec in report.items():
        usage = [ln.split("ptxas info    : ")[-1] for ln in rec["ptxas"].splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"[build] {name} {rec['seconds']:.1f}s | " + " | ".join(usage))


def main_path(label: str, argv=None) -> dict:
    import numpy as np
    import torch

    from repro_torch import tracing
    from repro_torch.engine import InferenceEngine
    from repro_torch.launch import serve
    from repro_torch.models.dlrm import forward_packed

    argv = PATHS[label] if argv is None else argv
    print(f"[main {label}] python -m repro_torch.launch.serve {' '.join(argv)}")
    args = serve.build_parser().parse_args(argv)
    reset_counts()
    t0 = time.perf_counter()
    with sparse_lookups() as sparse:
        res = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(sparse[0] > 0 and counts["slot_rejoin"] == sparse[0],
          f"[main {label}] {counts['slot_rejoin']} join launches for {sparse[0]} sparse "
          "lookups on the card")
    l1_modes = dict(wrappers()["embedding_bag_l1"].modes)
    access_paths = dict(wrappers()["multi_embedding_bag_ragged"].paths)
    dense_paths = dict(wrappers()["multi_embedding_bag_dense"].paths)
    engine, last = res["engine"], res["last"]
    s = res["stats"][args.distribution]
    check(s["submitted"] == s["served"] == args.queries,
          f"[main {label}] submitted {s['submitted']} served {s['served']}")
    check(s["batch_failures"] == 0 and s["degraded_batches"] == 0,
          f"[main {label}] failures {s['batch_failures']} degraded {s['degraded_batches']}")
    check(res["server"].fallback_step_fn is None,
          f"[main {label}] the server on the card has a plain fallback step")
    logits = last["logits"]
    check(logits.shape == (args.batch,) and np.isfinite(logits).all(),
          f"[main {label}] bad logits")

    # the same engine on the CPU (plain versions) on the last served batch;
    # a swept engine's twin packs the block sizes the card's sweep chose
    idx = last["indices"]
    cpu_config = engine.config
    tuning = engine.plan.meta.get("tuning")
    if engine.config.tuning == "sweep":
        check(tuning and tuning["backend"] == "cuda" and tuning["compiled"],
              f"[main {label}] the block-size sweep did not time the card: {tuning}")
        best = tuning["best"]
        cpu_config = dataclasses.replace(engine.config, tuning="fixed", tuning_options={
            "block_r": best["block_r"], **({"block_b": best["block_b"]} if best["block_b"] else {})})
    cpu_engine = InferenceEngine.build(res["params"]["tables"], engine.workload,
                                       cpu_config, device="cpu")
    check(cpu_engine.packed.block_r == engine.packed.block_r
          and cpu_engine.packed.unique_cap == engine.packed.unique_cap
          and cpu_engine.packed.cache_rows == engine.packed.cache_rows
          and cpu_engine.packed.kernel_path == engine.packed.kernel_path,
          f"[main {label}] the CPU twin packed another schedule")
    got = engine.lookup(idx).cpu()
    want = cpu_engine.lookup(idx)
    pooled_err = float((got - want).abs().max())
    check(torch.allclose(got, want, **TOL), f"[main {label}] pooled max err {pooled_err}")
    cpu_params = {"tables": res["params"]["tables"],
                  "bottom": copy.deepcopy(res["params"]["bottom"]).cpu(),
                  "top": copy.deepcopy(res["params"]["top"]).cpu()}
    cpu_logits = forward_packed(res["cfg"], cpu_engine.bag, cpu_engine.packed, cpu_params,
                                {"dense": torch.from_numpy(last["dense"]), "indices": idx})
    logit_err = float(np.abs(cpu_logits.numpy() - logits).max())
    check(np.allclose(logits, cpu_logits.numpy(), **LOGIT_TOL),
          f"[main {label}] logits max err {logit_err}")
    # the served step stages its batch in page-locked memory: every index
    # byte through a staging buffer, and no pageable copy to the card
    step = res["server"].step_fn
    payloads = [{"dense": last["dense"][i], "indices": idx[:, i]} for i in range(args.batch)]
    with tracing.counting() as moved:
        step(payloads)
    check(moved["index_copy_staged_bytes"] == idx.nbytes,
          f"[main {label}] the served step staged {moved['index_copy_staged_bytes']} of "
          f"{idx.nbytes} index bytes")
    ops = profile_calls(lambda: step(payloads), calls=1)["kernels_ms"]
    pageable = [k for k in ops if "Pageable -> Device" in k]
    check(ops and not pageable,
          f"[main {label}] the served step's profile: {list(ops)[:4]}, pageable copies {pageable}")
    # one served batch's step alone: host clock around work ending in a
    # synchronize, and the device time the profiler attributes to it
    dense = torch.from_numpy(last["dense"]).to(engine.device)

    def forward():
        forward_packed(res["cfg"], engine.bag, engine.packed, res["params"],
                       {"dense": dense, "indices": idx})
        torch.cuda.synchronize()

    forward_ms = host_ms(forward)
    lookup_ms = host_ms(lambda: (engine.lookup(idx), torch.cuda.synchronize()))
    # kernel events only (as the profiler's own "Self CUDA time total")
    device_ms = profile_calls(forward, calls=1)["device_ms"]
    batches = args.queries // args.batch
    layout = engine.bag.layout_summary()
    rec = {
        "main_path": label, "served": s["served"], "batches": batches,
        "layout": {k: layout[k] for k in ("kind", "chunk_bytes", "dense_bytes",
                                          "bytes_vs_dense")},
        "wall_s": wall, "serve_wall_per_batch_ms": res["serve_wall_s"] / batches * 1e3,
        "p50_us": s["p50_us"], "p99_us": s["p99_us"],
        "forward_ms": forward_ms, "lookup_ms": lookup_ms,
        "forward_device_ms": device_ms,
        "plan": {"chunks": len(engine.plan.assignments),
                 "chunk_strategies": sorted(
                     {a.strategy.name for a in engine.plan.assignments}),
                 "symmetric": [[t, st.name] for t, st in zip(
                     engine.plan.symmetric_tables, engine.plan.symmetric_strategies)]},
        "launches": counts, "l1_modes": l1_modes, "access_paths": access_paths,
        "dense_paths": dense_paths, "sparse_lookups": sparse[0],
        "pooled_max_err": pooled_err, "logit_max_err": logit_err,
    }
    if engine.packed.unique_cap or engine.packed.cache_rows:
        rec["access"] = access_summary(engine, idx)
        rec["cache"] = engine.plan.meta["cache"]
        rec["kernel"] = engine.plan.meta["kernel"]["packed"]
    if tuning:
        rec["tuning"] = {k: tuning[k] for k in ("best", "backend", "compiled", "iters")}
        rec["tuning"]["candidates"] = [
            {k: c[k] for k in ("block_r", "n_steps", "padding_frac", "wall_us", "device_us")}
            for c in tuning["candidates"]]
        times = [c["device_us"] for c in tuning["candidates"]]
        check(all(isinstance(t, float) and t > 0 for t in times),
              f"[main {label}] a sweep candidate has no device time: {times}")
        check(tuning["best"]["device_us"] == min(times),
              f"[main {label}] the sweep's pick is not its least device time: {tuning['best']}")
    print(json.dumps(rec))
    return {"engine": engine, "indices": idx, "counts": counts, "l1_modes": l1_modes,
            "record": rec}


def access_summary(engine, idx) -> dict:
    """What the access reduction saw on one served batch: lookups, cache
    hits, distinct rows left for the gather, spilled lookups."""
    import torch

    from repro_torch.kernels.embedding_multi import dedup_indices

    lidx, hidx, _ = _access_ids(engine, idx)
    valid = int((lidx >= 0).sum()) + int((hidx >= 0).sum() if hidx is not None else 0)
    hits = int((hidx >= 0).sum()) if hidx is not None else 0
    out = {"lookups": valid, "cache_hits": hits, "cache_hit_share": hits / max(valid, 1),
           "unique_cap": engine.packed.unique_cap, "cache_rows": engine.packed.cache_rows}
    if engine.packed.unique_cap:
        uniq, _, spill = dedup_indices(lidx, engine.packed.unique_cap)
        out["unique_rows"] = int((uniq >= 0).sum())
        out["spilled_lookups"] = int((spill >= 0).sum())
        out["max_unique_per_slot"] = int((uniq >= 0).sum(dim=-1).max())
    torch.cuda.synchronize()
    return out


def _pick(engine, strategy: str, largest: bool = True) -> int:
    """The largest (or smallest) symmetric table the plan gave ``strategy``."""
    plan = engine.plan
    cands = [t for t, st in zip(plan.symmetric_tables, plan.symmetric_strategies)
             if strategy in ("any", st.name)]
    check(cands, f"the plan has no symmetric {strategy} table")
    rows = {t: engine.workload.tables[t].rows for t in cands}
    return (max if largest else min)(cands, key=lambda t: (rows[t], t))


def _sym_case(engine, idx, table):
    """A symmetric table's kernel inputs on the main path: its own rows plus
    the zero row, and the redirected (B, s) ids."""
    import torch

    packed = engine.packed
    i = packed.host["sym_table"].tolist().index(table)
    rows = int(packed.host["sym_rows"][i])
    ids = torch.as_tensor(idx[table], device=packed.device).long()
    lidx = torch.where((ids >= 0) & (ids < rows), ids, rows).to(torch.int32)
    return packed.sym_data[i, : rows + 1], lidx


def _bag_record(name, fn, table, lidx, dtype, *, bitwise=False, **kw):
    """A strategy kernel on one table (its rows plus the zero row) against
    ``bag_f32``, bitwise where ``bitwise`` (a row copy, s = 1), else within
    TOL; timed beside it and beside ``F.embedding_bag`` (ids outside the
    table go to the zero row for the library call)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ref import bag_f32

    t = table.to(dtype).contiguous()
    got = fn(t, lidx, **kw)
    torch.cuda.synchronize()
    want = bag_f32(t, lidx)
    err = float((got - want).abs().max())
    if bitwise:
        check(torch.equal(got, want), f"[kernel] {name} {dtype}: not bitwise equal, max err {err}")
    check(torch.allclose(got, want, **TOL), f"[kernel] {name} {dtype}: max err {err}")
    zero_row = t.shape[0] - 1
    ids = torch.where((lidx >= 0) & (lidx < t.shape[0]), lidx, zero_row).long()

    def kernel():
        return fn(t, lidx, **kw)

    def library():
        return F.embedding_bag(ids, t, mode="sum")

    rec = {
        "name": name, "dtype": str(dtype).replace("torch.", ""),
        "shape": {"m": t.shape[0] - 1, "E": t.shape[1], "B": lidx.shape[0], "s": lidx.shape[1]},
        "max_err": err,
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: bag_f32(t, lidx)),
        "library_ms": time_ms(library),
        **device_times(kernel, library),
    }
    uniq = int(torch.unique(ids[ids < zero_row]).numel())
    b, s = lidx.shape
    e = t.shape[1]
    rec["bound_ms"], rec["bound_by"] = bound(
        uniq * e * t.element_size() + b * s * 4 + b * e * 4, b * s * e)
    return rec


def _dense_inputs(engine, idx):
    """Path E's dense kernel inputs: the (K, S, R+1, E) stack and the
    pre-clipped (K, S, B, s) ids."""
    import torch

    from repro_torch.core.partition import _dense_ids

    packed = engine.packed
    ids = _dense_ids(packed, torch.as_tensor(idx, device=packed.device))
    return packed.chunk_data, ids.to(torch.int32)


def _ragged_inputs(engine, idx):
    import torch

    from repro_torch.core.partition import _slot_indices

    packed = engine.packed
    local, valid = _slot_indices(packed, torch.as_tensor(idx, device=packed.device))
    lidx = torch.where(valid, local, -1).to(torch.int32)
    return packed.chunk_data, lidx, packed.step_block, packed.step_runs, packed.block_r


def _one_kernel(name: str, rec: dict) -> None:
    """K1's and K8's calls are one kernel each on the card (no fill, no copy):
    ``kernels_ms`` names one kernel and the call launches at most one (the
    profiler may drop a record, never add one)."""
    check(len(rec["kernels_ms"]) == 1 and rec["kernels_per_call"] <= 1,
          f"[kernel] {name}: not one kernel a call: {rec['kernels_ms']}")


def _ragged_ctas_per_sm(dtype, queries: int, smem_bytes: int):
    """CTAs of the base kernel's vector path an SM holds at ``queries`` a
    thread and ``smem_bytes`` of staging (the card's occupancy calculator)."""
    import ctypes

    from repro_torch.kernels import build

    fn = build.c_function("embedding_multi", "rt_ragged_ctas_per_sm",
                          [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    n = ctypes.c_int(0)
    build.check_launch(fn(queries, smem_bytes, build.dtype_code(dtype), ctypes.byref(n)),
                       "rt_ragged_ctas_per_sm")
    return n.value


def _ragged_record(buffer_full, lidx, step_block, runs, block_r, dtype, *, stage_rows=None):
    """K1 at a main path's shapes against its plain version, bitwise, timed
    beside it and beside one ``F.embedding_bag`` over the same lookups;
    ``stage_rows`` defaults to the pack's (:func:`ragged_stage_rows`), 0
    gathers every region."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_multi import (
        _queries,
        multi_embedding_bag_ragged,
        multi_embedding_bag_ragged_plain,
        ragged_stage_rows,
    )

    full = buffer_full.to(dtype)
    buf = full[:, :-1]
    k, t1, e = full.shape
    zero_row = t1 - 1
    run_list = runs.tolist()
    if stage_rows is None:
        stage_rows = ragged_stage_rows(run_list, block_r, e * full.element_size())

    def kernel():
        return multi_embedding_bag_ragged(buf, lidx, step_block, runs, block_r=block_r,
                                          stage_rows=stage_rows)

    paths = dict(multi_embedding_bag_ragged.paths)
    got = kernel()
    torch.cuda.synchronize()
    path = next(p for p in paths if multi_embedding_bag_ragged.paths[p] > paths[p])
    want = multi_embedding_bag_ragged_plain(buf, lidx, step_block, runs, block_r=block_r)
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"[kernel] ragged {dtype}: not bitwise equal, max err {err}")
    # library yardstick: one embedding_bag over global buffer rows
    s_slots, b, s = lidx.shape[1:]
    flat, gl = _global_rows(full, lidx, step_block, run_list, block_r)

    def library():
        return F.embedding_bag(gl, flat, mode="sum")

    lib = library().view(k, s_slots, b, e)
    lib_err = float((lib.float() - want).abs().max())
    queries = _queries(None, path == "base_vector", b, e, full.element_size(), k * s_slots,
                       full.device)
    rec = {
        "name": "multi_embedding_bag_ragged", "dtype": str(dtype).replace("torch.", ""),
        "shape": {"K": k, "T": t1 - 1, "E": e, "S": s_slots, "B": b, "s": s,
                  "block_r": block_r, "runs": len(run_list), "stage_rows": stage_rows,
                  "codes": sorted({r[4] for r in run_list})},
        "path": path, "queries": queries,
        "ctas_per_sm": _ragged_ctas_per_sm(dtype, queries, stage_rows * e * full.element_size()),
        "max_err": err, "library_max_err": lib_err,
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: multi_embedding_bag_ragged_plain(
            buf, lidx, step_block, runs, block_r=block_r)),
        "library_ms": time_ms(library),
        **device_times(kernel, library),
        "kernels_ms": profile_calls(kernel)["kernels_ms"],
    }
    _one_kernel("ragged", rec)
    real = gl.view(k, s_slots, b, s)[[r[0] for r in run_list], [r[1] for r in run_list]]
    uniq = int(torch.unique(real[real % t1 != zero_row]).numel())
    n_runs = len(run_list)
    row_bytes = uniq * e * full.element_size()
    # the whole (K, S, B, E) output the call returns, the runs' ids, the rows
    # they hit; bound_runs_ms counts the runs' outputs only (the older figure)
    rec["bound_ms"], rec["bound_by"] = bound(
        row_bytes + n_runs * b * s * 4 + k * s_slots * b * e * 4, n_runs * b * s * e)
    rec["bound_runs_ms"] = bound(row_bytes + n_runs * b * s * 4 + n_runs * b * e * 4,
                                 n_runs * b * s * e)[0]
    return rec


def ragged_queries_sweep(buffer_full, lidx, step_block, runs, block_r) -> list:
    """K1 on path A (f32, the pack's staging) at each count of queries a
    thread (:func:`queries_sweep`)."""
    from repro_torch.kernels.embedding_multi import _launch, ragged_stage_rows

    buf = buffer_full[:, :-1]
    k, _, e = buf.shape
    stage_rows = ragged_stage_rows(runs.tolist(), block_r, e * buf.element_size())

    def call(q):
        return _launch(buf, lidx, step_block, runs, block_r, stage_rows, queries=q)

    return queries_sweep("ragged", call, call(None), lidx.shape[2], e, buf.element_size(),
                         k * lidx.shape[1])


def queries_sweep(name: str, call, want, b: int, e: int, itemsize: int, n_slots: int) -> list:
    """K1 or K8 (f32, the main path's shapes) at each count of queries a
    thread: each output bitwise equal to the wrapper's, the device time of
    its one kernel; fails unless the wrapper's pick is within 10% of the
    best."""
    import torch

    from repro_torch.kernels.embedding_multi import SCATTER_QUERIES, _queries

    pick = _queries(None, True, b, e, itemsize, n_slots, want.device)
    per_pass = 256 // (e * itemsize // 16)
    out = []
    for q in SCATTER_QUERIES:
        got = call(q)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"[kernel] {name} with {q} queries a thread differs")
        out.append({"queries": q, "picked": q == pick, "ctas": -(-b // (per_pass * q)) * n_slots,
                    "device_ms": profile_calls(lambda q=q: call(q))["device_ms"]})
    times = [r["device_ms"] for r in out]
    if all(isinstance(t, float) for t in times):
        best = min(times)
        picked = next(r["device_ms"] for r in out if r["picked"])
        check(picked <= 1.1 * best, f"[kernel] {name}: the pick ({pick} queries a thread) "
              f"is more than 10% above the best: {out}")
    return out


def _global_rows(full, lidx, step_block, run_list, block_r):
    """The fused kernel's lookups as rows of the flattened ``(K * (T+1), E)``
    buffer (invalid ones on a zero row): ``(flat, (K*S*B, s) rows)``."""
    import torch

    k, t1, e = full.shape
    zero_row = t1 - 1
    s_slots, b, s = lidx.shape[1:]
    gl = torch.full((k, s_slots, b, s), zero_row, dtype=torch.long, device=full.device)
    blocks = step_block.long()
    for core, slot, first, n, _ in run_list:
        ids = lidx[core, slot].long()
        ok = (ids >= 0) & (ids < n * block_r)
        loc = torch.where(ok, ids, 0)
        rows = blocks[core, first + loc // block_r] * block_r + loc % block_r
        gl[core, slot] = torch.where(ok, rows, zero_row)
    gl = (gl + torch.arange(k, device=full.device).view(k, 1, 1, 1) * t1).reshape(-1, s)
    return full.reshape(k * t1, e), gl


def _access_ids(engine, idx):
    """Path D's kernel inputs: the ids after the hot/cold split, the cache
    positions, and the ids before the split (every lookup on the buffer)."""
    import torch

    from repro_torch.core.partition import _fused_ids, _slot_indices

    packed = engine.packed
    ids = torch.as_tensor(idx, device=packed.device)
    lidx, hidx = _fused_ids(packed, ids)
    local, valid = _slot_indices(packed, ids)
    return lidx, hidx, torch.where(valid, local, -1).to(torch.int32)


def _access_record(case, engine, idx, dtype, *, unique_cap, cache, kpath):
    """One access-mode launch at path D's shapes against its plain version,
    timed beside it and beside one ``F.embedding_bag`` over the same
    lookups.  ``kpath``: None (no selector), "served" (the pack's own
    per-step paths), "onehot" or "sparse" (every step forced)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_multi import (
        multi_embedding_bag_ragged,
        multi_embedding_bag_ragged_plain,
    )

    packed = engine.packed
    lidx, hidx, lidx_all = _access_ids(engine, idx)
    full = packed.chunk_data.to(dtype)
    buf = full[:, :-1]
    ids = lidx if cache else lidx_all
    plain_kw = dict(block_r=packed.block_r, unique_cap=unique_cap)
    if cache:
        plain_kw.update(cache=packed.cache_data.to(dtype), hidx=hidx)
    kw = dict(plain_kw, step_slot=packed.step_slot, step_base=packed.step_base)
    if kpath == "served":
        check(packed.kernel_path != "onehot", "path D's pack has no sparse step")
        kw["step_kpath"] = packed.step_kpath
    elif kpath is not None:
        kw["step_kpath"] = torch.full_like(packed.step_kpath, int(kpath == "sparse"))
    args = (buf, ids, packed.step_block, packed.step_runs)

    def kernel():
        return multi_embedding_bag_ragged(*args, **kw)

    got = kernel()
    torch.cuda.synchronize()
    want = multi_embedding_bag_ragged_plain(*args, **plain_kw)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **TOL), f"[kernel] {case} {dtype}: max err {err}")
    k, s_slots, b, s = lidx.shape
    if dtype == torch.float32 and s == 1:  # one term per element, added in the same order
        check(torch.equal(got, want), f"[kernel] {case} f32: not bitwise equal, max err {err}")
    run_list = packed.step_runs.tolist()
    e = full.shape[-1]
    flat, gl = _global_rows(full, lidx_all, packed.step_block, run_list, packed.block_r)

    def library():
        return F.embedding_bag(gl, flat, mode="sum")

    lib = library().view(k, s_slots, b, e)
    rec = {
        "name": case, "dtype": str(dtype).replace("torch.", ""),
        "shape": {"K": k, "S": s_slots, "B": b, "s": s, "E": e, "block_r": packed.block_r,
                  "runs": len(run_list), "unique_cap": unique_cap,
                  "cache_rows": packed.cache_rows if cache else 0, "kpath": kpath},
        "max_err": err, "library_max_err": float((lib.float() - want).abs().max()),
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: multi_embedding_bag_ragged_plain(*args, **plain_kw)),
        "library_ms": time_ms(library),
        **device_times(kernel, library),
    }
    real = gl.view(k, s_slots, b, s)
    n_valid = int((lidx_all >= 0).sum())
    hit_rows = int(torch.unique(real[lidx_all >= 0]).numel())
    id_bytes = ids.numel() * 4 + (hidx.numel() * 4 if cache else 0)
    rec["bound_ms"], rec["bound_by"] = bound(
        hit_rows * e * full.element_size() + id_bytes + k * s_slots * b * e * 4, n_valid * e)
    rec["distinct_rows"] = hit_rows
    return rec, got


def _dense_record(chunks_full, lidx, dtype):
    """The dense kernel against its plain version, bitwise (both sum each
    query's rows in position order from 0.0 in f32), timed beside it and
    beside one ``F.embedding_bag`` over the same lookups."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_multi import (
        _launch_dense,
        _queries,
        multi_embedding_bag_dense,
        multi_embedding_bag_dense_plain,
    )

    chunks = chunks_full.to(dtype)
    k, s_slots, rows, e = chunks.shape
    b, s = lidx.shape[2:]

    def kernel():
        return multi_embedding_bag_dense(chunks, lidx)

    paths = dict(multi_embedding_bag_dense.paths)
    got = kernel()
    torch.cuda.synchronize()
    path = next(p for p in paths if multi_embedding_bag_dense.paths[p] > paths[p])
    want = multi_embedding_bag_dense_plain(chunks, lidx)
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"[kernel] dense {dtype}: not bitwise equal, max err {err}")
    # library yardstick: one embedding_bag over the flattened (K*S*(R+1), E) stack
    flat = chunks.reshape(k * s_slots * rows, e)
    offset = torch.arange(k * s_slots, device=lidx.device).view(k, s_slots, 1, 1) * rows
    gl = (lidx.long() + offset).reshape(-1, s)

    def library():
        return F.embedding_bag(gl, flat, mode="sum")

    lib = library().view(k, s_slots, b, e)
    rec = {
        "name": "multi_embedding_bag_dense", "dtype": str(dtype).replace("torch.", ""),
        "shape": {"K": k, "S": s_slots, "R+1": rows, "E": e, "B": b, "s": s},
        "path": path,
        "queries": _queries(None, path == "vector", b, e, chunks.element_size(), k * s_slots,
                            chunks.device),
        "max_err": err,
        "library_max_err": float((lib.float() - want).abs().max()),
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: multi_embedding_bag_dense_plain(chunks, lidx)),
        "library_ms": time_ms(library),
        **device_times(kernel, library),
        "kernels_ms": profile_calls(kernel)["kernels_ms"],
    }
    _one_kernel("dense", rec)
    if dtype == torch.float32:
        rec["queries_sweep"] = queries_sweep(
            "dense", lambda q: _launch_dense(chunks, lidx, queries=q), got, b, e,
            chunks.element_size(), k * s_slots)
    # what the data needs: the distinct rows hit (a slot's zero row R holds
    # nothing to read), the ids, the (K, S, B, E) f32 output
    uniq = int(torch.unique(gl[(gl % rows) != rows - 1]).numel())
    rec["bound_ms"], rec["bound_by"] = bound(
        uniq * e * chunks.element_size() + lidx.numel() * 4 + k * s_slots * b * e * 4,
        k * s_slots * b * s * e)
    rec["distinct_rows"] = uniq
    return rec


def dense_edge_case(dtype):
    """The dense kernel on a small single-core stack: s=3, a batch that is
    no multiple of any tile, ids at 0 and at the zero row, an all-zero-row
    (empty) slot, and ids outside [0, R], which the kernel gives zero and
    the plain version refuses."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_multi import (
        multi_embedding_bag_dense,
        multi_embedding_bag_dense_plain,
    )

    rng = np.random.default_rng(5)
    s_slots, rows, b, s = 3, 1001, 1037, 3
    chunks = torch.from_numpy(rng.standard_normal((s_slots, rows, 16)).astype(np.float32))
    chunks[:, -1] = 0
    chunks[2] = 0  # an empty slot
    lidx = rng.integers(0, rows, size=(s_slots, b, s)).astype(np.int32)
    lidx[:, ::7, 0] = 0
    lidx[:, ::5, 1] = rows - 1
    lidx[2] = rows - 1
    chunks, ids = chunks.to(dtype).to(DEVICE), torch.from_numpy(lidx).to(DEVICE)
    got = multi_embedding_bag_dense(chunks, ids)
    want = multi_embedding_bag_dense_plain(chunks[None], ids[None])[0]
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"[kernel] dense edge case {dtype}: not bitwise equal")
    check(not got[2].any(), "[kernel] dense edge case: the empty slot is not zero")
    bad = ids.clone()
    bad[:, :, 2] = torch.where(bad[:, :, 2] % 2 == 0, -5, rows + 3).to(torch.int32)
    masked = multi_embedding_bag_dense_plain(
        chunks[None], torch.where(bad < 0, rows - 1, bad).clamp(max=rows - 1)[None])[0]
    got_bad = multi_embedding_bag_dense(chunks, bad)
    torch.cuda.synchronize()
    check(torch.equal(got_bad, masked), f"[kernel] dense ids outside [0, R] {dtype}")
    return float((got - want).abs().max())


def mixed_ragged_case():
    """Every strategy code, multi-step slots, padding steps (core 0 has fewer
    steps), -1 and out-of-window ids, on taobao table sizes."""
    import numpy as np
    import torch

    from repro_torch.core.partition import pack_plan
    from repro_torch.core.strategies import ChunkAssignment, Plan, Strategy
    from repro_torch.data.workloads import get_workload

    wl = get_workload("taobao", 4096)
    chunks = [(2, 0, Strategy.GM), (7, 0, Strategy.L1),
              (5, 1, Strategy.GM_UB), (14, 1, Strategy.L1_UB), (8, 1, Strategy.L1),
              (3, 1, Strategy.L1)]
    plan = Plan(workload_name="mixed", n_cores=2,
                assignments=tuple(ChunkAssignment(t, c, 0, wl.tables[t].rows, st)
                                  for t, c, st in chunks),
                symmetric_tables=(), symmetric_strategies=())
    gen = torch.Generator().manual_seed(3)
    used = {t for t, _, _ in chunks}
    tables = [torch.randn((t.rows, t.dim), generator=gen) if i in used else None
              for i, t in enumerate(wl.tables)]
    packed = pack_plan(plan, wl.tables, tables, device=DEVICE)
    runs = packed.step_runs.cpu().numpy()
    check(sorted({int(c) for c in runs[:, 4]}) == [0, 1, 2, 3], "mixed case lacks a code")
    check(int(packed.step_slot.max()) == packed.slot_table.shape[1], "no padding steps")
    rng = np.random.default_rng(4)
    k, s_slots = packed.slot_table.shape
    lidx = np.full((k, s_slots, 4096, 2), -1, np.int32)
    for core, slot, _first, n, _code in runs.tolist():
        lidx[core, slot] = rng.integers(-3, n * packed.block_r + 9, size=(4096, 2))
    return (packed.chunk_data, torch.from_numpy(lidx).to(DEVICE), packed.step_block,
            packed.step_runs, packed.block_r)


def access_phase(path_d: dict, recs: dict) -> None:
    """K5-K7 at path D's shapes in f32, bf16 and f16: as served, with the
    gather forced one-hot and sparse (bitwise equal), with a forced spill
    (a 64-wide unique cap), and the cache alone."""
    import torch

    from repro_torch.kernels.embedding_multi import dedup_indices

    engine, idx = path_d["engine"], path_d["indices"]
    cap = engine.packed.unique_cap
    check(cap > 0 and engine.packed.cache_rows > 0, "path D packed no dedup or no cache")
    spill_cap = 64
    lidx, _, _ = _access_ids(engine, idx)
    check(int((dedup_indices(lidx, spill_cap)[2] >= 0).sum()) > 0, "the spill case spills nothing")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        rec, _ = _access_record("served (dedup + cache, planned paths)", engine, idx, dtype,
                                unique_cap=cap, cache=True, kpath="served")
        recs["multi_embedding_bag_ragged[dedup]"].append(rec)
        outs = {}
        for name, case_cap in (("", cap), (" spill", spill_cap)):
            for kpath in ("onehot", "sparse"):
                rec, outs[name, kpath] = _access_record(
                    f"forced {kpath}{name} (dedup + cache)", engine, idx, dtype,
                    unique_cap=case_cap, cache=True, kpath=kpath)
                key = "sparse" if kpath == "sparse" else "dedup"
                recs[f"multi_embedding_bag_ragged[{key}]"].append(rec)
            check(torch.equal(outs[name, "onehot"], outs[name, "sparse"]),
                  f"[kernel] one-hot and sparse gathers differ{name} ({dtype})")
        rec, _ = _access_record("cache alone", engine, idx, dtype, unique_cap=0, cache=True,
                                kpath=None)
        recs["multi_embedding_bag_ragged[cache]"].append(rec)
        for case_cap in (cap, spill_cap):
            recs["multi_embedding_bag_ragged[dedup]"].append(
                _gather_record(engine, lidx, case_cap, dtype))
    recs["batch_dedup"].append(_dedup_record("path D as served", lidx, cap))
    for case, (ids, case_cap) in dedup_edge_cases().items():
        recs["batch_dedup"].append(_dedup_record(case, ids, case_cap))
    breakdown = access_breakdown(engine, idx)
    breakdown["scatter_queries"] = scatter_sweep(engine, idx)
    print(json.dumps({"breakdown": breakdown}))
    print(json.dumps({"access_by_block_r": access_by_block_r(engine, idx)}))


def _gather_record(engine, lidx, cap, dtype):
    """The unique-row gather alone on path D's unique ids at ``cap``: array-
    equal to ``gather_unique_rows_plain``, timed beside it; its bound is
    ``rows_u`` written once, the unique ids and the distinct rows read once."""
    import torch

    from repro_torch.kernels.embedding_multi import (
        batch_dedup,
        gather_unique_rows,
        gather_unique_rows_plain,
    )

    packed = engine.packed
    buf = packed.chunk_data.to(dtype)[:, :-1]
    uniq = batch_dedup(lidx, cap)[0]
    args = (buf, uniq, packed.step_block, packed.step_runs)

    def kernel():
        return gather_unique_rows(*args, block_r=packed.block_r)

    paths = dict(gather_unique_rows.paths)
    got = kernel()
    want = gather_unique_rows_plain(*args, block_r=packed.block_r)
    torch.cuda.synchronize()
    path = next(p for p in paths if gather_unique_rows.paths[p] > paths[p])
    check(torch.equal(got, want),
          f"[kernel] gather {dtype} cap {cap}: not array-equal to gather_unique_rows_plain")
    k, s_slots, u = uniq.shape
    e = buf.shape[-1]
    rows = int((got.abs().sum(dim=-1) > 0).sum())  # entries with a row (nonzero)
    rec = {
        "name": "gather_unique_rows", "case": f"the gather alone, cap {cap}",
        "dtype": str(dtype).replace("torch.", ""), "path": path,
        "shape": {"K": k, "S": s_slots, "U": u, "E": e, "block_r": packed.block_r},
        "max_err": 0.0, "rows_copied": rows,
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: gather_unique_rows_plain(*args, block_r=packed.block_r)),
        "library_ms": None, **device_times(kernel),
    }
    rec["bound_ms"], rec["bound_by"] = bound(
        got.numel() * 4 + uniq.numel() * 4 + rows * e * buf.element_size(), 0)
    return rec


def _dedup_record(case, lidx, cap):
    """The dedup kernel against ``dedup_indices`` (array-equal uniq, rank
    and spill), timed beside it and beside ``torch.unique(ids,
    return_inverse=True)`` on each slot's ids: the library call that finds
    the same distinct ids and each id's place among them (a yardstick only;
    it has no cap and no spill)."""
    import torch

    from repro_torch.kernels.embedding_multi import DEDUP_WINDOW_BITS, batch_dedup, dedup_indices

    def kernel():
        return batch_dedup(lidx, cap)

    got = kernel()
    want = dedup_indices(lidx, cap)
    torch.cuda.synchronize()
    for name, a, b in zip(("uniq", "rank", "spill"), got, want):
        check(torch.equal(a, b), f"[kernel] batch_dedup {case}: {name} differs from dedup_indices")
    *lead, b, s = lidx.shape
    rows = lidx.numel() // max(b * s, 1)
    slots = lidx.reshape(rows, b * s)

    def library():
        return [torch.unique(ids, return_inverse=True) for ids in slots]

    rec = {
        "name": "batch_dedup", "case": case, "dtype": "int32",
        "shape": {"slots": rows, "B": b, "s": s, "unique_cap": cap,
                  "window_bits": DEDUP_WINDOW_BITS},
        "max_err": 0.0, "distinct_max": int((got[0] >= 0).sum(dim=-1).max()) if rows else 0,
        "spilled": int((got[2] >= 0).sum()),
        "ms": time_ms(kernel), "plain_ms": time_ms(lambda: dedup_indices(lidx, cap)),
        "library_ms": time_ms(library), **device_times(kernel, library),
    }
    # ids read once, rank and spill and uniq written once; a few integer
    # operations per id
    rec["bound_ms"], rec["bound_by"] = bound(3 * lidx.numel() * 4 + rows * cap * 4, lidx.numel())
    return rec


def dedup_edge_cases() -> dict:
    """The dedup kernel's edge cases: all padding, one id, a cap of 1, a
    cap above the distinct count, s = 3, and slots wider than one bitmap
    window (ids up to 2^31 - 2 with empty stretches between, and the plain
    op's padding key 2^31 - 1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(9)
    wide = rng.integers(0, 3_000_000, size=(4, 8192, 1))
    wide[:, ::5] = rng.integers(2**31 - 5000, 2**31 - 1, size=wide[:, ::5].shape)
    wide[:, ::9] = 2**31 - 1
    cases = {
        "all padding": (np.full((8, 1024, 1), -1), 64),
        "one id": (np.full((8, 8192, 1), 1234), 64),
        "cap 1": (rng.integers(-1, 100_000, size=(8, 8192, 1)), 1),
        "cap above the distinct count": (rng.integers(-1, 500, size=(8, 8192, 1)), 1856),
        "s=3": (rng.integers(-3, 20_000, size=(8, 2048, 3)), 1856),
        "wider than the bitmap": (wide, 3000),
    }
    return {k: (torch.from_numpy(v.astype(np.int32)).to(DEVICE), cap)
            for k, (v, cap) in cases.items()}


def access_breakdown(engine, idx, calls: int = 10) -> dict:
    """Where path D's served launch spends its time (f32): the device time
    of each kernel per call and the launches per call (``torch.profiler``),
    the event time of the whole wrapper call, of the dedup kernel alone and
    of its plain torch op, and the host time to enqueue one call.  Fails if
    a sort, scan or scatter kernel (the plain op's) runs in the call."""
    import torch

    from repro_torch.kernels.embedding_multi import (
        batch_dedup,
        dedup_indices,
        multi_embedding_bag_ragged,
    )

    packed = engine.packed
    args, kw = _served_args(packed, idx)
    lidx = args[1]

    def served():
        return multi_embedding_bag_ragged(*args, **kw)

    prof = profile_calls(served, calls)
    plain_ops = [k for k in prof["kernels_ms"]
                 if any(w in k.lower() for w in ("sort", "scan", "scatter"))]
    check(not plain_ops, f"[access] the served call still runs the plain dedup op: {plain_ops}")
    by_pass = _by_pass(prof["kernels_ms"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        served()
    enqueue_ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return {
        "event_ms": time_ms(served),
        "dedup_kernel_event_ms": time_ms(lambda: batch_dedup(lidx, packed.unique_cap)),
        "plain_dedup_op_event_ms": time_ms(lambda: dedup_indices(lidx, packed.unique_cap)),
        "host_enqueue_ms": enqueue_ms,
        "launches_per_call": prof["launches_per_call"],
        "device_ms": prof["device_ms"],
        **{f"{name}_device_ms": ms for name, ms in by_pass.items()},
        **_pass_bounds(packed, lidx),
        "kernels_ms": prof["kernels_ms"],
    }


def _by_pass(kernels_ms: dict) -> dict:
    """Device ms of the served access call's three kernels by pass."""
    names = {"dedup": "dedup_kernel", "gather": "gather_kernel", "scatter": "access_"}
    return {name: sum(ms for k, ms in kernels_ms.items() if key in k)
            for name, key in names.items()}


def _pass_bounds(packed, lidx) -> dict:
    """The gather's and the scatter's bounds at path D's data (f32): the
    gather writes rows_u and reads the unique ids and the distinct rows; the
    scatter writes the (K, S, B, E) output and reads the rank, spill and cache
    position of every lookup and rows_u."""
    from repro_torch.kernels.embedding_multi import dedup_indices

    k, s_slots, b, s = lidx.shape
    e = packed.chunk_data.shape[-1]
    u = packed.unique_cap
    uniq = dedup_indices(lidx, u)[0]
    distinct = int((uniq >= 0).sum())
    rows_u = k * s_slots * u * e * 4
    gather = bound(rows_u + uniq.numel() * 4 + distinct * e * 4, 0)[0]
    scatter = bound(k * s_slots * b * e * 4 + 3 * lidx.numel() * 4 + rows_u, 0)[0]
    return {"gather_bound_ms": gather, "scatter_bound_ms": scatter}


def _served_args(packed, idx):
    """The served access call's arguments for a pack: (args, kwargs)."""
    import torch

    from repro_torch.core.partition import _fused_ids

    lidx, hidx = _fused_ids(packed, torch.as_tensor(idx, device=packed.device))
    kw = dict(block_r=packed.block_r, unique_cap=packed.unique_cap, cache=packed.cache_data,
              hidx=hidx, step_slot=packed.step_slot, step_base=packed.step_base,
              step_kpath=packed.step_kpath if packed.kernel_path != "onehot" else None)
    return (packed.chunk_data[:, :-1], lidx, packed.step_block, packed.step_runs), kw


def scatter_sweep(engine, idx) -> list:
    """The vector scatter of path D's served call at each count of queries a
    thread, f32 and bf16: device time of the scatter kernel (the dedup and
    gather kernels run too, unchanged), each output bitwise equal to the
    wrapper's own pick, which is marked."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.embedding_multi import (
        SCATTER_QUERIES,
        _launch_access,
        multi_embedding_bag_ragged,
        scatter_queries,
    )

    out = []
    args, kw = _served_args(engine.packed, idx)
    for dtype in (torch.float32, torch.bfloat16):
        buf = args[0].to(dtype)
        cache = kw["cache"].to(dtype)
        b, e = args[1].shape[2], buf.shape[-1]
        pick = scatter_queries(b, e, buf.element_size(), args[1].shape[0] * args[1].shape[1],
                               build.sm_count(buf.device))
        want = multi_embedding_bag_ragged(buf, *args[1:], **dict(kw, cache=cache))
        for q in SCATTER_QUERIES:
            def call(q=q):
                return _launch_access(buf, *args[1:], kw["block_r"], kw["unique_cap"], cache,
                                      kw["hidx"], kw["step_kpath"], kw["step_slot"],
                                      kw["step_base"], queries=q)

            got = call()
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"[access] scatter with {q} queries a thread differs")
            prof = profile_calls(call)
            out.append({"dtype": str(dtype).replace("torch.", ""), "queries": q,
                        "picked": q == pick,
                        "ctas": -(-b // (256 // (e * buf.element_size() // 16) * q))
                        * args[1].shape[0] * args[1].shape[1],
                        "scatter_device_ms": _by_pass(prof["kernels_ms"])["scatter"]})
    return out


def access_by_block_r(engine, idx) -> list:
    """Path D's served access call with its plan repacked on the card at each
    block size the sweep tries (f32): device time by kernel (dedup, gather,
    scatter) and launches a call, beside ``F.embedding_bag``'s device time
    over the same lookups; fails if a candidate's output is not bitwise equal
    to its plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.autotune import _BLOCK_R_CANDIDATES
    from repro_torch.core.partition import _slot_indices
    from repro_torch.kernels.embedding_multi import (
        multi_embedding_bag_ragged,
        multi_embedding_bag_ragged_plain,
    )

    meta = copy.deepcopy(engine.plan.meta)  # pack_plan rewrites plan.meta["layout"]
    ids = torch.as_tensor(idx, device=DEVICE)
    out = []
    for br in _BLOCK_R_CANDIDATES:
        packed = engine.bag.pack(engine.table_data, block_r=br, device=DEVICE)
        check((packed.unique_cap, packed.cache_rows, packed.kernel_path)
              == (engine.packed.unique_cap, engine.packed.cache_rows, engine.packed.kernel_path),
              f"[access] the repack at block_r={br} armed other access modes")
        args, kw = _served_args(packed, idx)

        def served(args=args, kw=kw):
            return multi_embedding_bag_ragged(*args, **kw)

        got = served()
        plain_kw = {k: kw[k] for k in ("block_r", "unique_cap", "cache", "hidx")}
        want = multi_embedding_bag_ragged_plain(*args, **plain_kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"[access] block_r={br}: not bitwise equal, max err {err}")
        prof = profile_calls(served)
        local, valid = _slot_indices(packed, ids)
        full = packed.chunk_data
        flat, gl = _global_rows(full, torch.where(valid, local, -1).to(torch.int32),
                                packed.step_block, packed.step_runs.tolist(), br)
        library = profile_calls(lambda: F.embedding_bag(gl, flat, mode="sum"))
        rec = {"block_r": br, "n_steps": int(packed.step_slot.shape[-1]),
               "runs": int(packed.step_runs.shape[0]), "max_err": err,
               "device_ms": prof["device_ms"], "launches_per_call": prof["launches_per_call"],
               **{f"{name}_device_ms": ms for name, ms in _by_pass(prof["kernels_ms"]).items()},
               "library_device_ms": library["device_ms"]}
        if isinstance(rec["device_ms"], float) and isinstance(rec["library_device_ms"], float):
            rec["to_library"] = rec["device_ms"] / rec["library_device_ms"]
        out.append(rec)
        del packed, args, kw
    engine.plan.meta.clear()
    engine.plan.meta.update(meta)
    return out


def ub_cases(table, ids, uniform: dict) -> list:
    """K2's extra cases at path A's shapes: a batch whose ids are all one row
    and a batch of one id (the sweep of the table alone), both bitwise and
    timed beside the uniform batch; and s = 3 with ids outside [0, m) and -1
    padding in every dtype (within TOL)."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_ub import embedding_bag_ub

    out = []
    for case, case_ids in (("one row (every id equal)", torch.full_like(ids, int(ids[0, 0]))),
                           ("one id (the table sweep alone)", ids[:1].contiguous())):
        rec = _bag_record("embedding_bag_ub", embedding_bag_ub, table, case_ids, torch.float32,
                          bitwise=True)
        rec["case"] = case
        rec["to_uniform_ms"] = rec["ms"] / uniform["ms"]
        if isinstance(rec["device_ms"], float) and isinstance(uniform["device_ms"], float):
            rec["to_uniform_device_ms"] = rec["device_ms"] / uniform["device_ms"]
        out.append(rec)
    m, b = table.shape[0], ids.shape[0]
    rng = np.random.default_rng(11)
    s3 = rng.integers(0, m, size=(b, 3))
    s3[rng.random(s3.shape) < 0.2] = -1
    s3[::7, 1] = m + 5
    s3[::11, 2] = -9
    s3 = torch.from_numpy(s3.astype(np.int32)).to(ids.device)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        rec = _bag_record("embedding_bag_ub", embedding_bag_ub, table, s3, dtype)
        rec["case"] = "s=3, ids outside [0, m) and -1 padding"
        out.append(rec)
    return out


def _l1_record(table, lidx, dtype, case=None):
    """K4 through its wrapper, bitwise at s = 1, with the mode, cluster
    size, rows per CTA, grid and CTA width its schedule gave."""
    from repro_torch.kernels.embedding_l1 import embedding_bag_l1, schedule_for

    rec = _bag_record("embedding_bag_l1", embedding_bag_l1, table, lidx, dtype,
                      bitwise=lidx.shape[1] == 1)
    sched = schedule_for(table.to(dtype).contiguous(), lidx)
    rec.update(mode=sched.mode, cluster=sched.cluster, rows_per_cta=sched.rows_per_cta,
               grid=sched.grid, threads=sched.threads)
    if case:
        rec["case"] = case
    return rec


def l1_mode_cases() -> list:
    """K4 at every cluster size ``l1_schedule`` picks and beyond: f32 tables
    of E = 16 (a zero last row) sized to the largest each size holds within
    the slice target (C x ``CLUSTER_BYTES``), ``ascend_910``'s largest L1
    table (1 MiB + the zero row: 16 CTAs past the target), and 200,000 rows
    (12.8 MB, beyond), at path B's batch shape (B = 8192, s = 1, uniform
    ids).  A size the card does not schedule (16 may not) is reported."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_l1 import CLUSTER_BYTES, CLUSTER_SIZES, schedule_for

    rng = np.random.default_rng(21)
    cases = [(c, c * (CLUSTER_BYTES // 64), f"cluster of {c}") for c in CLUSTER_SIZES]
    cases += [(16, 16_385, "cluster of 16 (ascend_910's largest L1 table)"),
              (0, 200_000, "beyond (12.8 MB, the UB kernel)")]
    out = []
    for c, m, case in cases:
        table = torch.from_numpy(rng.standard_normal((m, 16)).astype(np.float32))
        table[-1] = 0
        table = table.to(DEVICE)
        ids = torch.from_numpy(rng.integers(0, m - 1, size=(8192, 1)).astype(np.int32)).to(DEVICE)
        sched = schedule_for(table, ids)
        if c == 16 and sched.cluster != 16:
            out.append({"name": "embedding_bag_l1", "case": f"{case}: 16 not scheduled",
                        "rows": m, "mode": sched.mode, "cluster": sched.cluster})
            continue
        check((sched.mode, sched.cluster if c else 0) == ("cluster" if c else "beyond", c),
              f"[kernel] L1 at {m} rows: {sched}")
        out.append(_l1_record(table, ids, torch.float32, case))
    return out


def l1_sweep(table, lidx, small, small_ids) -> list:
    """K4 on path B's table 2 (f32) at every cluster size whose slice fits
    one CTA's shared memory, and on its smallest L1 table resident, each at
    256 and 1024 threads a CTA (one thread per item, as many CTAs or
    clusters as that needs, at most what the card holds): each held bitwise
    against ``bag_f32`` and timed; the wrapper's own pick is marked."""
    import torch

    from repro_torch.kernels.embedding_l1 import (
        CLUSTER_SIZES,
        CTA_MAX_BYTES,
        L1Schedule,
        card_clusters,
        cluster_schedule,
        ctas_per_sm,
        launch,
        schedule_for,
    )
    from repro_torch.kernels.ref import bag_f32

    out = []
    for tab, ids in ((table, lidx), (small, small_ids)):
        t = tab.float().contiguous()
        m, e = t.shape
        b = ids.shape[0]
        want = bag_f32(t, ids)
        pick = schedule_for(t, ids)
        active = card_clusters(t.device.index, 0)
        n_sms = torch.cuda.get_device_properties(t.device).multi_processor_count
        for threads in (256, 1024):
            if pick.mode == "resident":
                grid = max(1, min(-(-b * e * 4 // 16 // threads),
                                  n_sms * ctas_per_sm(m * e * 4, threads)))
                cands = [L1Schedule("resident", 1, m, grid, m * e * 4, threads)]
            else:
                cands = []
                for c in CLUSTER_SIZES:
                    smem = -(-m // c) * e * 4
                    n = active(c, smem, threads) if smem <= CTA_MAX_BYTES else 0
                    if n >= 1:
                        cands.append(cluster_schedule(m, e * 4, b, c, n, threads))
            for sched in cands:
                got = launch(t, ids, sched)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"[kernel] L1 {sched}: not bitwise")
                out.append({
                    "rows": m, "mode": sched.mode, "cluster": sched.cluster,
                    "threads": threads, "rows_per_cta": sched.rows_per_cta, "grid": sched.grid,
                    "smem": sched.smem, "picked": sched == pick,
                    "staged_bytes": sched.grid * sched.smem,
                    "ms": time_ms(lambda: launch(t, ids, sched)),
                    "device_ms": profile_calls(lambda: launch(t, ids, sched))["device_ms"]})
    print(json.dumps({"l1_sweep": out}))
    return out


def gm_pooled_case(table, ids) -> dict:
    """K3 on path B's table 0 with s = 3: uniform ids, 20% -1 padding, ids
    at and past m, within TOL of ``bag_f32`` (f32)."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_gm import embedding_bag_gm

    m, b = table.shape[0], ids.shape[0]
    rng = np.random.default_rng(22)
    s3 = rng.integers(0, m, size=(b, 3))
    s3[rng.random(s3.shape) < 0.2] = -1
    s3[::7, 1] = m + 5
    s3[::11, 2] = -9
    s3 = torch.from_numpy(s3.astype(np.int32)).to(ids.device)
    rec = _bag_record("embedding_bag_gm", embedding_bag_gm, table, s3, torch.float32)
    rec["case"] = "s=3, ids outside [0, m) and -1 padding"
    return rec


def _rejoin_record(engine, idx, case: str, *, tile: int = 1, two_level: bool = False) -> dict:
    """The join kernel on a path's own slot partials: the fused kernel's
    (K, S, B, E) partials of the last served batch, on the card (with
    ``tile``, repeated that many times along the batch), joined by
    ``slot_rejoin``, by ``slot_rejoin_plain`` on the same card tensors
    (bitwise) and by the plain join it replaced (``_scatter_slots`` +
    ``_sparse_rejoin``: bitwise, or within ``TOL`` on a ``two_level`` plan,
    whose tables may have owners on both hosts that ``index_add_`` sums on
    the card in no fixed order).  Timed with CUDA events and the profiler
    beside both (not on a two-level plan, which only checks the order);
    bound: each term's plane read once, each table's plane written once."""
    import torch

    from repro_torch.core import partition
    from repro_torch.kernels.embedding_rejoin import slot_rejoin, slot_rejoin_plain

    packed, n = engine.packed, engine.bag.n_tables
    partials = partition._slot_partials(packed, torch.as_tensor(idx, device=packed.device),
                                        use_kernels="fused").repeat(1, 1, tile, 1)
    ptr, terms = packed.rejoin_ptr, packed.rejoin_terms
    paths = dict(slot_rejoin.paths)
    got = slot_rejoin(partials, ptr, terms)
    path = [k for k, v in slot_rejoin.paths.items() if v > paths[k]]
    plain = slot_rejoin_plain(partials, ptr, terms)

    def replaced():
        return partition._sparse_rejoin(partition._scatter_slots(packed, partials, n), packed)

    chain = replaced()
    bits = [torch.equal(got.view(torch.int32), x.view(torch.int32)) for x in (plain, chain)]
    chain_err = float((got - chain).abs().max()) if got.numel() else 0.0
    check(bits[0], f"[kernel slot_rejoin {case}] not bitwise equal to slot_rejoin_plain")
    check(torch.allclose(got, chain, **TOL) if two_level else bits[1],
          f"[kernel slot_rejoin {case}] off the plain join by {chain_err}")
    k, s_slots, b, e = partials.shape
    t = int(terms.numel())
    rec = {"kernel": "slot_rejoin", "case": case, "dtype": "float32", "K": k, "S": s_slots,
           "N": n, "B": b, "E": e, "terms": t, "path": path, "max_err": 0.0,
           "bitwise_vs_plain": bits[0], "bitwise_vs_plain_join": bits[1],
           "plain_join_max_err": chain_err}
    if two_level:
        return rec

    def kernel():
        slot_rejoin(partials, ptr, terms)

    rec.update({"ms": time_ms(kernel), "plain_ms": time_ms(
        lambda: slot_rejoin_plain(partials, ptr, terms)), "library_ms": None,
        "plain_join_ms": time_ms(replaced), **device_times(kernel),
        "plain_join_device_ms": profile_calls(replaced)["device_ms"]})
    rec["bound_ms"], rec["bound_by"] = bound((t + n) * b * e * 4, t * b * e)
    return rec


def kernel_phase(paths: dict, counts: dict) -> list:
    import torch

    from repro_torch.kernels.embedding_gm import embedding_bag_gm
    from repro_torch.kernels.embedding_ub import embedding_bag_ub

    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    recs: dict[str, list] = {name: [] for name in KERNELS}
    access_phase(paths["D"], recs)
    dense = _dense_inputs(paths["E"]["engine"], paths["E"]["indices"])
    for dtype in dtypes:
        rec = _dense_record(*dense, dtype)
        rec["edge_case_max_err"] = dense_edge_case(dtype)
        recs["multi_embedding_bag_dense"].append(rec)
    a, b, c = paths["A"], paths["B"], paths["C"]
    ragged = _ragged_inputs(a["engine"], a["indices"])
    ragged_c = _ragged_inputs(c["engine"], c["indices"])
    mixed = mixed_ragged_case()
    ub_table, ub_ids = _sym_case(a["engine"], a["indices"], _pick(a["engine"], "GM_UB"))
    l1ub_table, l1ub_ids = _sym_case(  # the smallest table, swept as one resident tile
        a["engine"], a["indices"], _pick(a["engine"], "any", largest=False))
    gm_table, gm_ids = _sym_case(b["engine"], b["indices"], _pick(b["engine"], "GM"))
    l1_big = _pick(b["engine"], "L1")
    l1_table, l1_ids = _sym_case(b["engine"], b["indices"], l1_big)
    l1r_table, l1r_ids = _sym_case(
        b["engine"], b["indices"], _pick(b["engine"], "L1", largest=False))
    for dtype in dtypes:
        recs["multi_embedding_bag_ragged"].append(
            _ragged_record(*ragged, dtype))
        recs["multi_embedding_bag_ragged"].append(dict(
            _ragged_record(*ragged_c, dtype), case="path C (shard_rocks)"))
        recs["multi_embedding_bag_ragged"].append(dict(
            _ragged_record(*mixed, dtype), case="every strategy code"))
        recs["embedding_bag_ub"].append(_bag_record(
            "embedding_bag_ub", embedding_bag_ub, ub_table, ub_ids, dtype, bitwise=True))
        recs["embedding_bag_ub"].append(dict(_bag_record(
            "embedding_bag_ub", embedding_bag_ub, l1ub_table, l1ub_ids, dtype, bitwise=True,
            persistent=True), case="persistent (L1-UB)"))
        recs["embedding_bag_gm"].append(_bag_record(
            "embedding_bag_gm", embedding_bag_gm, gm_table, gm_ids, dtype, bitwise=True))
        recs["embedding_bag_l1"].append(
            _l1_record(l1_table, l1_ids, dtype, f"path B's table {l1_big}"))
        recs["embedding_bag_l1"].append(_l1_record(l1r_table, l1r_ids, dtype, "resident"))
    head = recs["multi_embedding_bag_ragged"][0]
    gathered = dict(_ragged_record(*ragged, torch.float32, stage_rows=0),
                    case="path A, every region gathered (stage_rows=0)")
    if isinstance(gathered["device_ms"], float) and isinstance(head["device_ms"], float):
        gathered["to_staged_device_ms"] = gathered["device_ms"] / head["device_ms"]
    recs["multi_embedding_bag_ragged"].append(gathered)
    head["queries_sweep"] = ragged_queries_sweep(*ragged)
    head = recs["embedding_bag_l1"][0]
    check(head["mode"] == "cluster", f"[kernel] path B's table {l1_big} is not served by a "
          f"cluster: {head['mode']}")
    head["sweep"] = l1_sweep(l1_table, l1_ids, l1r_table, l1r_ids)
    one = _l1_record(l1_table, l1_ids[:1].contiguous(), torch.float32,
                     f"one query on table {l1_big} (the staging alone)")
    if isinstance(one["device_ms"], float) and isinstance(head["device_ms"], float):
        one["to_uniform_device_ms"] = one["device_ms"] / head["device_ms"]
    recs["embedding_bag_l1"].append(one)
    recs["embedding_bag_l1"] += l1_mode_cases()
    recs["embedding_bag_gm"].append(gm_pooled_case(gm_table, gm_ids))
    recs["embedding_bag_ub"] += ub_cases(ub_table, ub_ids, recs["embedding_bag_ub"][0])
    d = paths["D"]  # first: priced as the benchmark's taobao plan, at its batch
    recs["slot_rejoin"].append(_rejoin_record(
        d["engine"], d["indices"], f"path D repeated {REJOIN_TILE} times along the batch",
        tile=REJOIN_TILE))
    for label in ("D", "C", "A", "E"):
        recs["slot_rejoin"].append(_rejoin_record(
            paths[label]["engine"], paths[label]["indices"], f"path {label}"))
    out = []
    for name, rs in recs.items():
        for r in rs:
            r["launches"] = counts[name]
            print(json.dumps(r))
        head = rs[0]  # f32 at the main path's shapes
        _, _, _, src, replaces = KERNELS[name]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": max(r.get("max_err", 0.0) for r in rs),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "device_ms": head["device_ms"], "library_device_ms": head["library_device_ms"],
            **{k: head[k] for k in ("mode", "cluster", "rows_per_cta", "grid", "threads")
               if k in head},
        })
    return out


# --------------------------------------------------------------------------
# the shipped presets, their deterministic replay, and faults
# --------------------------------------------------------------------------


@contextlib.contextmanager
def rebuild_log(block_rs=None):
    """Record every ``InferenceEngine.rebuild`` (a drift replan's shadow
    build) while the block runs: its thread, seconds and engine.  With
    ``block_rs`` each rebuild packs the next of those block sizes instead of
    sweeping (the CPU twin follows the card's picks)."""
    import threading
    import traceback

    from repro_torch.engine import InferenceEngine

    orig = InferenceEngine.rebuild
    picks = iter(block_rs or ())
    log = []

    def rebuild(self, freqs):
        rec = {"thread": threading.current_thread().name}
        log.append(rec)
        t0 = time.perf_counter()
        try:
            if block_rs is None:
                eng = orig(self, freqs)
            else:
                config = dataclasses.replace(self.config, tuning="fixed",
                                             tuning_options={"block_r": next(picks)})
                eng = InferenceEngine.build(self.table_data, self.workload, config,
                                            device=self.device, freqs=freqs)
        except BaseException:
            rec["error"] = traceback.format_exc()
            raise
        rec["seconds"] = time.perf_counter() - t0
        rec["engine"] = eng
        return eng

    InferenceEngine.rebuild = rebuild
    try:
        yield log
    finally:
        InferenceEngine.rebuild = orig


def join_shadow_builds() -> None:
    """Wait for every shadow build thread, abandoned ones included, so that
    no build runs on into the next phase."""
    import threading

    for t in threading.enumerate():
        if t.name == "shadow-replan":
            t.join()


def _sweep_pick(engine) -> dict | None:
    tuning = engine.plan.meta.get("tuning") or {}
    if not tuning.get("best"):
        return None
    return {"best": tuning["best"]["block_r"], "backend": tuning.get("backend"),
            "device_us": {c["block_r"]: c["device_us"] for c in tuning["candidates"]},
            "cache_hit": (tuning.get("cache") or {}).get("hit")}


def _integrity_cost(engine) -> dict:
    """Host clock of one manifest build and one verify sweep of the engine's
    buffers (a copy to the host and a CRC32 per region)."""
    from repro_torch.core.integrity import IntegrityManifest

    t0 = time.perf_counter()
    IntegrityManifest.from_packed(engine.packed, engine.plan)
    t1 = time.perf_counter()
    bad = engine.verify_integrity()
    t2 = time.perf_counter()
    check(bad == [], f"a clean engine's buffers fail their manifest: {bad}")
    return {"manifest_build_ms": (t1 - t0) * 1e3, "verify_ms": (t2 - t1) * 1e3,
            "buffer_bytes": engine.bag.layout_summary()["chunk_bytes"],
            "regions": len(engine.manifest.checksums)}


def _served_checks(label: str, s: dict, logits) -> None:
    """The gates that hold whatever the timing: every request accounted
    for, no failed, degraded or poisoned batch, no failed heal, no parity
    failure or replan error, finite logits."""
    import numpy as np

    unserved = s["failed"] + s["pending"]
    check(s["submitted"] == s["served"] + s["shed"] + s["rejected"] + s["invalid"] + unserved,
          f"[{label}] request accounting: {s}")
    check(s["batch_failures"] == s["degraded_batches"] == 0,
          f"[{label}] failures {s['batch_failures']} degraded {s['degraded_batches']}")
    integ = s["integrity"]
    check(integ["poisoned_batches"] == integ["heal_failures"] == 0,
          f"[{label}] poisoned {integ['poisoned_batches']} heal failures {integ['heal_failures']}")
    if "replan" in s:
        check(s["replan"]["parity_failures"] == s["replan"]["replan_errors"] == 0,
              f"[{label}] replan events: {s['replan']['events']}")
    check(0 < len(logits) == s["served"] and np.isfinite(logits).all(),
          f"[{label}] {len(logits)} logits for {s['served']} served, or not all finite")


def _replan_record(s: dict, rebuilds: list) -> dict:
    r = s["replan"]
    return {"replans": r["replans"], "abandoned": r["abandoned"],
            "drift_checks": r["drift_checks"], "events": r["events"],
            "rebuilds": [{"thread": b["thread"], "seconds": b.get("seconds"),
                          "block_r": b["engine"].packed.block_r if "engine" in b else None,
                          **({"error": b["error"]} if "error" in b else {})}
                         for b in rebuilds]}


def _cpu_params(res) -> dict:
    return {"tables": res["params"]["tables"],
            "bottom": copy.deepcopy(res["params"]["bottom"]).cpu(),
            "top": copy.deepcopy(res["params"]["top"]).cpu()}


def _twin_check(label: str, res: dict, rebuilds: list) -> list:
    """Every engine a run built (its first and each finished rebuild, the
    one that served the last batch among them) held against the same plan
    built on the CPU (the kernels' plain versions) on the last batch's
    inputs: the same packed schedule, the pooled output within ``TOL`` and
    the logits within ``LOGIT_TOL``.  The CPU twin packs under the card
    engine's own histograms and block sizes, so the
    comparison holds whichever engine the clock let serve."""
    import numpy as np
    import torch

    from repro_torch.engine import InferenceEngine
    from repro_torch.models.dlrm import forward_packed

    engines = [res["engine"]] + [b["engine"] for b in rebuilds if "engine" in b]
    serving = res["server"].step_fn.engine
    check(any(e is serving for e in engines), f"[{label}] the serving engine was never built")
    last, cfg, cpu_params = res["last"], res["cfg"], _cpu_params(res)
    idx, dense = last["indices"], torch.from_numpy(last["dense"])
    out = []
    for i, eng in enumerate(engines):
        config = eng.config
        if config.tuning == "sweep":
            config = dataclasses.replace(config, tuning="fixed", tuning_options={
                "block_r": eng.packed.block_r,
                **({"block_b": eng.packed.block_b} if eng.packed.block_b else {})})
        cpu = InferenceEngine.build(cpu_params["tables"], eng.workload, config,
                                    device="cpu", freqs=eng.freqs)
        sched = lambda e: (e.packed.block_r, e.packed.unique_cap,  # noqa: E731
                           e.packed.cache_rows, e.packed.kernel_path)
        check(sched(cpu) == sched(eng),
              f"[{label}] engine {i}: the CPU twin packed {sched(cpu)}, the card {sched(eng)}")
        got, want = eng.lookup(idx).cpu(), cpu.lookup(idx)
        pooled_err = float((got - want).abs().max())
        check(torch.allclose(got, want, **TOL), f"[{label}] engine {i}: pooled max err {pooled_err}")
        logits = forward_packed(cfg, eng.bag, eng.packed, res["params"],
                                {"dense": dense.to(eng.device), "indices": idx},
                                use_kernels=eng._use_kernels,
                                reduce_mode=eng.config.reduce_mode).cpu().numpy()
        cpu_logits = forward_packed(cfg, cpu.bag, cpu.packed, cpu_params,
                                    {"dense": dense, "indices": idx},
                                    use_kernels=cpu._use_kernels,
                                    reduce_mode=cpu.config.reduce_mode).numpy()
        logit_err = float(np.abs(logits - cpu_logits).max())
        check(np.isfinite(logits).all() and np.allclose(logits, cpu_logits, **LOGIT_TOL),
              f"[{label}] engine {i}: logits max err {logit_err}")
        # the error beside the logits' own size (f32 reduction order scales
        # with it; tests/test_torch_logit_order.py)
        largest = float(np.abs(cpu_logits).max())
        out.append({"engine": i, "served_last": eng is serving, "schedule": sched(eng),
                    "pooled_max_err": pooled_err, "logit_max_err": logit_err,
                    "logit_rel_err": logit_err / largest if largest else 0.0,
                    "logit_max_abs": largest})
        del cpu
    return out


def preset_path(label: str) -> dict:
    """A shipped preset through the serve CLI on the card.  Gated: only
    what holds whatever the timing (``_served_checks``, drift checked and a
    shadow build started on F and G, each path's access kernels launched,
    and every engine the run built held against its CPU twin on the last
    batch, ``_twin_check``).
    Recorded and not gated: replans and their batches, abandoned builds,
    sheds, deadline misses, latency, wall per batch, the integrity sweep's
    cost and each rebuild's seconds and block size."""
    import torch

    from repro_torch.launch import serve

    args = PRESETS[label]
    print(f"[preset {label}] python -m repro_torch.launch.serve {' '.join(args)}", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    with rebuild_log() as rebuilds:
        res = serve.main(args)
        join_shadow_builds()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    (s,) = res["stats"].values()
    integ = s["integrity"]
    rec = {
        "preset_path": label, "args": args, "wall_s": wall, "batches": res["n_batches"],
        "serve_wall_per_batch_ms": res["serve_wall_s"] / res["n_batches"] * 1e3,
        "build_s": res["build_s"],
        **{k: s[k] for k in ("submitted", "served", "shed", "rejected", "invalid", "failed",
                             "pending", "deadline_misses", "batch_failures",
                             "degraded_batches", "p50_us", "p99_us", "tps")},
        "integrity": {k: integ[k] for k in ("checks", "corruptions_detected", "heals",
                                            "heal_failures", "quarantined_regions",
                                            "poisoned_batches", "events")},
        "integrity_cost": _integrity_cost(res["server"].step_fn.engine),
        "sweep": _sweep_pick(res["engine"]), "launches": counts,
    }
    if "replan" in s:
        rec["replan"] = _replan_record(s, rebuilds)
    print(json.dumps(rec, default=str), flush=True)  # before the gates, to read on a failure
    _served_checks(label, s, res["served_logits"])
    check(res["server"].fallback_step_fn is None,
          f"[{label}] the server on the card has a plain fallback step")
    if label in ("F", "G"):
        check(s["replan"]["drift_checks"] >= 1 and rebuilds,
              f"[{label}] no drift check or no shadow build: {s['replan']}")
    # the cache mode runs only where a served plan carves cache rows, and
    # the carve takes GM-coded rows: the three presets' first plans have
    # none under the tpu_v5e preset, and whether a replan's plan has some
    # depends on the histogram measured when it triggers, which follows
    # the clock under overlap; path D gates the cache mode
    for mode in ("dedup", "sparse"):
        check(counts[f"multi_embedding_bag_ragged[{mode}]"] > 0, f"[{label}] no {mode} launch")
    check(counts["batch_dedup"] > 0, f"[{label}] the dedup kernel not launched")
    twins = _twin_check(label, res, rebuilds)
    print(json.dumps({"preset_path": label, "twins": twins}), flush=True)
    return {"counts": counts}


def replay_path() -> dict:
    """F's preset and drift spec, replanned inline (no overlap, no
    deadline) over 128 batches on the card, then on the CPU with the same
    seed, the CPU twin packing the block sizes the card's engines packed
    (its first engine and each rebuild).  Gates: every request served, the same
    replan batches, the last batch's pooled output within 1e-5 and logits
    within 1e-4 of the CPU's, and the last batch served by the engine of
    the last swap, on both."""
    import numpy as np
    import torch

    from repro_torch.launch import serve

    print(f"[replay R] python -m repro_torch.launch.serve {' '.join(R_ARGS)}", flush=True)
    reset_counts()
    with rebuild_log() as card_log:
        res = serve.main(R_ARGS)
    counts = read_counts()
    (s,) = res["stats"].values()
    _served_checks("R", s, res["served_logits"])
    check(s["served"] == s["submitted"], f"[R] served {s['served']} of {s['submitted']}")
    picks = [b["engine"].packed.block_r for b in card_log]
    first = res["engine"].packed.block_r
    cpu_args = R_ARGS + ["--device", "cpu", "--set", "tuning=fixed",
                         "--set", f'tuning_options={{"block_r": {first}}}']
    with rebuild_log(picks) as cpu_log:
        cres = serve.main(cpu_args)
    (cs,) = cres["stats"].values()
    events = [(e["batch"], e["parity_ok"]) for e in s["replan"]["events"]]
    cpu_events = [(e["batch"], e["parity_ok"]) for e in cs["replan"]["events"]]
    check(events == cpu_events, f"[R] replan batches: card {events}, CPU {cpu_events}")
    check(events and events[-1][1] and events[-1][0] < res["n_batches"],
          f"[R] no swap before the last batch: {events}")
    for mode in ("dedup", "sparse"):
        check(counts[f"multi_embedding_bag_ragged[{mode}]"] > 0, f"[R] no {mode} launch")
    card_engine, cpu_engine = res["server"].step_fn.engine, cres["server"].step_fn.engine
    check(card_engine is card_log[-1]["engine"] and cpu_engine is cpu_log[-1]["engine"],
          "[R] the last batch was not served by the engine of the last swap")
    check(cpu_engine.packed.block_r == card_engine.packed.block_r
          and cpu_engine.packed.unique_cap == card_engine.packed.unique_cap
          and cpu_engine.packed.cache_rows == card_engine.packed.cache_rows,
          "[R] the CPU twin's last engine packed another schedule")
    idx = res["last"]["indices"]
    check(np.array_equal(idx, cres["last"]["indices"]), "[R] the runs served other traffic")
    got = card_engine.lookup(idx).cpu()
    want = cpu_engine.lookup(idx)
    pooled_err = float((got - want).abs().max())
    check(torch.allclose(got, want, **TOL), f"[R] pooled max err {pooled_err}")
    logits, cpu_logits = res["last"]["logits"], cres["last"]["logits"]
    logit_err = float(np.abs(logits - cpu_logits).max())
    check(logits.shape == cpu_logits.shape and np.allclose(logits, cpu_logits, **LOGIT_TOL),
          f"[R] logits max err {logit_err}")
    rec = {"replay_path": "R", "batches": res["n_batches"], "served": s["served"],
           "replan_batches": [b for b, _ in events], "block_r_picks": [first] + picks,
           "pooled_max_err": pooled_err, "logit_max_err": logit_err,
           "serve_wall_per_batch_ms": res["serve_wall_s"] / res["n_batches"] * 1e3,
           "cpu_serve_wall_per_batch_ms": cres["serve_wall_s"] / cres["n_batches"] * 1e3,
           "replan": _replan_record(s, card_log), "launches": counts}
    print(json.dumps(rec, default=str), flush=True)
    return {"counts": counts}


def _fault_engines(**overrides):
    """taobao-zipf12's plan (with ``overrides`` to its config) on the card
    and on the CPU (the card's block size pinned), without drift or
    deadline, checksummed every 4 batches, over the serve CLI's seeded
    tables."""
    import torch

    from repro_torch.configs.presets import load_preset
    from repro_torch.data.workloads import get_workload
    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.models.dlrm import DLRMConfig, init_dlrm

    preset = load_preset("taobao-zipf12")
    config = dataclasses.replace(
        EngineConfig.from_dict(preset["config"]), drift="none", drift_options={},
        deadline_s=None, integrity_options={"check_every": 4, "nan_guard": True}, **overrides)
    wl = get_workload(preset["workload"], config.max_batch)
    params = init_dlrm(DLRMConfig(arch="dlrm-taobao", workload=wl),
                       torch.Generator().manual_seed(0), "cpu")
    card = InferenceEngine.build(params["tables"], wl, config, device=DEVICE)
    best = card.plan.meta["tuning"]["best"]["block_r"]
    cpu = InferenceEngine.build(params["tables"], wl, dataclasses.replace(
        config, tuning="fixed", tuning_options={"block_r": best}), device="cpu")
    return card, cpu


def _drive(srv, wl, n_batches: int, seed: int = 0, drain: bool = True) -> list:
    import numpy as np

    from repro_torch.data.distributions import Zipf, sample_workload

    rng = np.random.default_rng(seed)
    handles = []
    for _ in range(n_batches):
        idx = sample_workload(rng, wl, Zipf(1.2), wl.batch)
        handles.extend(srv.submit_request(idx[:, q]) for q in range(wl.batch))
        srv.pump()
    if drain:
        srv.drain()
    return handles


def _buffers(engine) -> dict:
    p = engine.packed
    return {"chunk_data": p.chunk_data.clone(), "cache_data": p.cache_data.clone(),
            "sym_data": p.sym_data.clone()}


def _events(integ: dict) -> list:
    return [{k: e[k] for k in ("batch", "reason", "regions", "healed")} for e in integ["events"]]


def faults_path() -> dict:
    """Faults on taobao-zipf12's plan, each case deterministic: a bit flip
    found by the next cadence sweep (the same corrupt regions as the CPU
    engine reports for the same plan and fault) and healed bitwise; NaN rows
    caught and healed; the bit flip again on the plan priced under the
    ``a100`` preset, which carves a residency cache (the ``tpu_v5e``
    preset's plan carves none), so that its served batches launch the cache
    mode and its heal rebuilds the cache rows, then its pooled output held
    against the CPU twin's; a step crash that fails only its own batch; one
    stalled replan (overlap on) abandoned after ``build_timeout_batches``,
    the stall released only after that."""
    import torch

    from repro_torch.serving.faults import (
        FaultInjector,
        FaultPlan,
        FaultSpec,
        arm_buffer_corruption,
    )
    from repro_torch.serving.server import BatchExecutionError

    import numpy as np

    from repro_torch.data.distributions import Zipf, sample_workload

    reset_counts()
    card, cpu = _fault_engines()
    cached = _fault_engines(hardware="a100")
    check(cached[0].packed.cache_rows > 0, "[X cache] the a100 plan carves no cache rows")
    wl = card.workload
    rec = {"faults_path": "X", "block_r": card.packed.block_r}
    for case, mode, count, check_every, pair in (("bitflip", "bitflip", 3, 4, (card, cpu)),
                                                 ("nan-rows", "nan-rows", 2, 64, (card, cpu)),
                                                 ("cache", "bitflip", 3, 4, cached)):
        runs = {}
        before = read_counts()["multi_embedding_bag_ragged[cache]"]
        for name, engine in zip(("card", "cpu"), pair):
            pristine = _buffers(engine)
            inj = FaultInjector(FaultPlan(
                [FaultSpec("buffer", at_batch=8, mode=mode, count=count)], seed=FAULT_SEED))
            srv = engine.serve(max_wait_s=0.0, fault_injector=inj,
                               integrity={"check_every": check_every, "nan_guard": True})
            arm_buffer_corruption(inj, engine, srv)
            _drive(srv, wl, 16)
            s = srv.stats()
            integ = s["integrity"]
            check(integ["heals"] >= 1 and integ["heal_failures"] == 0,
                  f"[X {case} {name}] not healed: {integ}")
            check(engine.verify_integrity() == [], f"[X {case} {name}] still corrupt")
            for f, t in _buffers(engine).items():
                check(torch.equal(t, pristine[f]), f"[X {case} {name}] {f} not equal to a fresh pack")
            check(s["submitted"] == s["served"] + s["failed"] and s["degraded_batches"] == 0,
                  f"[X {case} {name}] accounting {s}")
            runs[name] = {"events": _events(integ), "poisoned": integ["poisoned_batches"],
                          "corruptions": integ["corruptions_detected"], "failed": s["failed"]}
        check(runs["card"] == runs["cpu"], f"[X {case}] card {runs['card']} CPU {runs['cpu']}")
        if case == "cache":
            launched = read_counts()["multi_embedding_bag_ragged[cache]"] - before
            check(launched > 0, "[X cache] the cache mode was not launched")
            idx = sample_workload(np.random.default_rng(FAULT_SEED), wl, Zipf(1.2), wl.batch)
            got, want = pair[0].lookup(idx).cpu(), pair[1].lookup(idx)
            pooled_err = float((got - want).abs().max())
            check(torch.allclose(got, want, **TOL), f"[X cache] pooled max err {pooled_err}")
            # a bit flipped in the cache rows themselves: found by a sweep
            # and rebuilt from the buffer bitwise, the same region on both
            found = []
            for engine in pair:
                cache = engine.packed.cache_data
                pristine = cache.clone()
                cache[0, 0, 0:1].view(torch.int32).bitwise_xor_(1 << 20)
                found.append(engine.verify_integrity())
                report = engine.heal()
                check(report["clean"] and torch.equal(engine.packed.cache_data, pristine),
                      f"[X cache] the cache rows not rebuilt bitwise: {report}")
            check(found[0] == found[1] and [k[0] for k in found[0]] == ["cache"],
                  f"[X cache] corrupt regions: card {found[0]}, CPU {found[1]}")
            runs["card"].update(cache_rows=pair[0].packed.cache_rows, cache_launches=launched,
                                pooled_max_err=pooled_err, cache_flip=found[0])
        elif mode == "bitflip":
            check(runs["card"]["events"][0]["reason"] == "cadence"
                  and runs["card"]["events"][0]["batch"] == 12 and runs["card"]["poisoned"] == 0,
                  f"[X bitflip] not found by the sweep after batch 8: {runs['card']}")
        else:
            check(runs["card"]["poisoned"] >= 1
                  and runs["card"]["events"][0]["reason"] == "poisoned-output",
                  f"[X nan-rows] not caught by the output guard: {runs['card']}")
        rec[case] = runs["card"]
    # a step crash fails only its own batch's handles
    inj = FaultInjector(FaultPlan([FaultSpec("step", at_batch=5, mode="crash")], seed=FAULT_SEED))
    srv = card.serve(max_wait_s=0.0, fault_injector=inj)
    handles = _drive(srv, wl, 8)
    s = srv.stats()
    failed = [i for i, h in enumerate(handles) if h._error is not None]
    check(s["batch_failures"] == 1 and s["failed"] == wl.batch
          and failed == list(range(4 * wl.batch, 5 * wl.batch))
          and all(isinstance(handles[i]._error, BatchExecutionError) for i in failed)
          and s["served"] == 7 * wl.batch and s["degraded_batches"] == 0,
          f"[X crash] {s['batch_failures']} failures, failed handles {failed[:3]}...")
    rec["crash"] = {"failed_handles": [failed[0], failed[-1]], "served": s["served"]}
    # one stalled replan, abandoned after build_timeout_batches
    stalled = dataclasses.replace(card.config, drift="replan", drift_options={
        "check_every": 2, "threshold": 0.0, "patience": 1, "cooldown": 100,
        "overlap": True, "build_timeout_batches": 2})
    card.config = stalled
    inj = FaultInjector(FaultPlan([FaultSpec("replan", mode="stall")], seed=FAULT_SEED))
    srv = card.serve(max_wait_s=0.0, fault_injector=inj)
    _drive(srv, wl, 10, drain=False)
    inj.release_stalls()
    srv.drain()
    join_shadow_builds()
    rp = srv.stats()["replan"]
    check(rp["abandoned"] == 1 and rp["replans"] == 0
          and [(e["batch"], e.get("abandoned")) for e in rp["events"]] == [(4, True)],
          f"[X stall] {rp}")
    check(srv.served == srv.submitted, "[X stall] not every request served")
    rec["stall"] = {"abandoned": rp["abandoned"], "events": rp["events"]}
    counts = read_counts()
    rec["launches"] = counts
    print(json.dumps(rec, default=str), flush=True)
    return {"counts": counts}


# --------------------------------------------------------------------------
# the two-level mesh and the scenario towers
# --------------------------------------------------------------------------


def mesh_path() -> dict:
    """M: the serve CLI on the hierarchical plan of a 2x4 mesh (one card
    holds the whole mesh: a host is a group of plan cores).  Gated: the
    main path's checks (accounting, the CPU twin's pooled output and
    logits, no fallback step), the plan's mesh record (two hosts, the five
    row-sharded tables), an owner on each host for a row-sharded table in
    the rejoin buckets, no cross-host send, no symmetric group, the dedup
    kernels launched and the report's host tree and mesh line.  Recorded:
    wall per batch, the lookup's device time, and the modeled cross-host
    bytes against a flat all-gather (a model priced under ``a100``)."""
    import numpy as np
    import torch

    run = main_path("M", M_ARGS)
    engine, idx, counts = run["engine"], run["indices"], run["counts"]
    mesh = engine.plan.meta["mesh"]
    check(mesh["hosts"] == 2 and mesh["cores_per_host"] == 4 and mesh["rocks"] == M_ROCKS,
          f"[M] mesh record {mesh}")
    cph = mesh["cores_per_host"]
    bucket = engine.packed.rejoin_bucket.cpu().numpy()
    split = [ti for ti in range(len(engine.workload.tables))
             if {int(c) // cph for c in np.nonzero((bucket == ti).any(axis=1))[0]} == {0, 1}]
    check(split, "[M] no table has an owner core on each host")
    rejoin = engine.plan.meta["rejoin"]
    check(rejoin["hosts"] == 2 and rejoin["cross_host_sends"] == 0, f"[M] rejoin {rejoin}")
    check(not engine.plan.symmetric_tables, "[M] the hierarchical plan has a symmetric group")
    check(counts["multi_embedding_bag_ragged[dedup]"] > 0 and counts["batch_dedup"] > 0,
          f"[M] the dedup kernels not launched: {counts}")
    join = _rejoin_record(engine, idx, "path M (owners on both hosts)", two_level=True)
    report = engine.plan_report()
    check(all(k in report for k in ("host 0", "host 1", "mesh 2x4")),
          "[M] the plan report lacks its host tree or mesh line")
    lookup = profile_calls(lambda: engine.lookup(idx))
    xh = engine.stats()["cross_host"]
    torch.cuda.synchronize()
    print(json.dumps({
        "mesh_path": "M", "serve_wall_per_batch_ms": run["record"]["serve_wall_per_batch_ms"],
        "lookup_ms": run["record"]["lookup_ms"], "lookup_device_ms": lookup["device_ms"],
        "lookup_launches": lookup["launches_per_call"], "lookup_kernels_ms": lookup["kernels_ms"],
        "chunks": len(engine.plan.assignments), "rocks": mesh["rocks"],
        "host_tables": mesh["host_tables"], "tables_on_both_hosts": split,
        "unique_cap": engine.packed.unique_cap, "rejoin": rejoin, "join": join,
        "modeled_under": engine.config.hardware, **xh}), flush=True)
    return {"counts": counts}


def kernels_called(run) -> tuple:
    """``(names, run())``: the kernels whose wrappers ``run()`` calls, named
    as their launch counts name them.  Run on a CPU engine (each wrapper's
    plain route), it shows what the executor's own dispatch reaches for a
    config, which the card's counts are then held to.  The fused kernel's
    modes are those its arguments arm, as its launch counts them: dedup
    (with the dedup kernel), a cache with rows, the sparse path, else
    base."""
    wrapped = {fn.__code__: fn.__name__ for fn in wrappers().values()}
    names = set()

    def hook(frame, event, arg):
        name = wrapped.get(frame.f_code) if event == "call" else None
        if name != "multi_embedding_bag_ragged":
            if name:
                names.add(name)
            return
        a = frame.f_locals
        cache = a["cache"]
        modes = [m for m, on in (("dedup", a["unique_cap"]),
                                 ("cache", cache is not None and cache.shape[-2]),
                                 ("sparse", a["step_kpath"] is not None)) if on]
        names.update(f"{name}[{m}]" for m in modes)
        if a["unique_cap"]:
            names.add("batch_dedup")
        if not modes:
            names.add(name)

    sys.setprofile(hook)
    try:
        out = run()
    finally:
        sys.setprofile(None)
    return sorted(names), out


def scenario_path(name: str) -> dict:
    """S: one scenario tower, built by name from its registry config on the
    card and served for ``S_BATCHES`` batches of 64 (fixed arrivals, no
    deadline, no overlap).  Gated: every request served, no failed or
    degraded batch, the last batch's served scores bitwise equal to the
    scenario's reference forward on the card (plain lookups, then the same
    tower module) and within ``LOGIT_TOL`` of its CPU twin (the same tables
    and tower values, the same config built on the CPU), and every kernel
    the CPU twin's lookup calls (:func:`kernels_called`) launched on the
    card.  Recorded: wall per batch and the tower's share of one step
    (host clock around synchronized work)."""
    import numpy as np
    import torch

    from repro_torch.data.distributions import get_distribution
    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.models.registry import SCENARIOS

    config = EngineConfig(**SCENARIOS[name].default_config)
    reset_counts()
    t0 = time.perf_counter()
    engine = InferenceEngine.build_scenario(name, config, device=DEVICE)
    build_s = time.perf_counter() - t0
    scenario = engine.scenario
    b = scenario.workload.batch
    srv = engine.serve(max_batch=b, max_wait_s=0.0)
    check(srv.fallback_step_fn is None, f"[S {name}] the server on the card has a fallback step")
    dist = get_distribution(config.distribution or "uniform")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(S_BATCHES):
        last = scenario.sample_batch(rng, dist)
        handles = [srv.submit_request(q) for q in scenario.payloads(last)]
        srv.pump()
    srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    s = srv.stats()
    check(s["submitted"] == s["served"] == S_BATCHES * b,
          f"[S {name}] submitted {s['submitted']} served {s['served']}")
    check(s["batch_failures"] == s["degraded_batches"] == 0,
          f"[S {name}] failures {s['batch_failures']} degraded {s['degraded_batches']}")
    served = np.asarray([h.result() for h in handles], np.float32)
    want = scenario.reference_forward(last)
    check(served.shape == (b,) and np.isfinite(served).all() and np.array_equal(served, want),
          f"[S {name}] served scores not bitwise equal to the reference forward: "
          f"max err {float(np.abs(served - want).max())}")
    twin = scenario.on("cpu")
    cpu = InferenceEngine.from_scenario(twin, engine.config, device="cpu")
    sched = lambda e: (e.packed.block_r, e.packed.unique_cap,  # noqa: E731
                       e.packed.cache_rows, e.packed.kernel_path)
    check(sched(cpu) == sched(engine),
          f"[S {name}] the CPU twin packed {sched(cpu)}, the card {sched(engine)}")
    cpu_scores = twin.make_step(cpu)(twin.payloads(last))
    score_err = float(np.abs(served - cpu_scores).max())
    check(np.allclose(served, cpu_scores, **LOGIT_TOL), f"[S {name}] scores max err {score_err}")
    expected, cpu_pooled = kernels_called(lambda: cpu.lookup(last["indices"]))
    pooled_err = float((engine.lookup(last["indices"]).cpu() - cpu_pooled).abs().max())
    check(expected, f"[S {name}] the CPU lookup called no kernel wrapper")
    check(all(counts[k] > 0 for k in expected),
          f"[S {name}] expected {expected} launched, counts {counts}")
    step = scenario.make_step(engine)
    payloads = scenario.payloads(last)
    idx = last["indices"]
    step_ms = host_ms(lambda: (step(payloads), torch.cuda.synchronize()))
    lookup_ms = host_ms(lambda: (engine.lookup(idx), torch.cuda.synchronize()))
    rec = {"scenario_path": name, "config": SCENARIOS[name].default_config,
           "workload": engine.workload.summary(), "build_s": build_s,
           "batches": S_BATCHES, "serve_wall_per_batch_ms": wall / S_BATCHES * 1e3,
           "p50_us": s["p50_us"], "p99_us": s["p99_us"],
           "step_ms": step_ms, "lookup_ms": lookup_ms,
           "tower_share_of_step": max(step_ms - lookup_ms, 0.0) / step_ms,
           "schedule": sched(engine), "expected_kernels": expected, "launches": counts,
           "score_max_err_vs_cpu": score_err, "pooled_max_err_vs_cpu": pooled_err,
           "max_abs_score": float(np.abs(served).max())}
    print(json.dumps(rec, default=str), flush=True)
    return {"counts": counts}


# --------------------------------------------------------------------------
# T: training on the card
# --------------------------------------------------------------------------


# T-grad: path B's three strategy tables of taobao (their rows and planned
# strategies), E = 16, batch 8192, s = 1 and 3, f32, plus table 1 in bf16
T_GRAD_TABLES = {0: "GM", 1: "GM-UB", 2: "L1"}
T_GRAD_CASES = [(t, s, "float32") for t in T_GRAD_TABLES for s in (1, 3)] + [(1, 3, "bfloat16")]
T_BATCH = 8192
T_DLRM_STEPS, T_DLRM_EVERY, T_DLRM_FAIL = 8, 4, 6
T_DLRM_LR = 0.01  # the train CLI's DLRM rate (ten times its default --lr)
T_CLI = [["--arch", "dlrm", "--steps", "20"], ["--arch", "qwen3-0.6b", "--steps", "10"],
         ["--arch", "granite-moe-3b-a800m", "--steps", "10"],
         ["--arch", "whisper-small", "--steps", "10"], ["--arch", "qwen2-vl-2b", "--steps", "10"]]
# the LM families at their published widths, depth cut:
# name -> (arch, layers kept, train batch x seq or None (serve only),
# prefill batch x seq, what the f32 decode logits are held to: "twin", the
# CPU twin's decode (a forward at the train groups drops tokens, a one-token
# decode step never does), or "forward", the card's own full forward, an
# MoE's capacity raised so that neither drops a token)
T_FAMILY = {
    "T-lm": ("olmo-1b", 4, (2, 512), (2, 256), "forward"),
    "T-moe": ("granite-moe-3b-a800m", 4, (2, 512), (2, 256), "twin"),
    "T-swa": ("mixtral-8x22b", 1, None, (1, 5120), "forward"),
    "T-ssm": ("mamba2-780m", 4, (2, 512), (2, 300), "forward"),
    "T-hybrid": ("zamba2-1.2b", 7, (2, 512), (2, 300), "forward"),
    "T-encdec": ("whisper-small", 12, (2, 512), (2, 64), "forward"),
    "T-vlm": ("qwen2-vl-2b", 4, (2, 512), (2, 256), "forward"),
}
T_FAMILY_DECODE = 16
# whisper's encoder length for 30 s of audio after its (stubbed) conv frontend
T_ENCDEC_FRAMES = 1500
# Qwen2-VL's M-RoPE layout, a row's segments: ("text", n) or ("image", gh, gw)
T_VLM_TRAIN_ROWS = ([("text", 64), ("image", 16, 24), ("text", 64)],
                    [("image", 16, 24), ("text", 128)])
T_VLM_PREFILL_ROW = [("text", 32), ("image", 12, 16), ("text", 32)]
# mixtral's batch-split prefill: serve_microbatch["prefill_32k"] = 2
T_SWA_SPLIT = ("prefill_32k", 2, 5120)
# T-remat: olmo-1b at T-lm's cut, one train step at batch x seq
T_REMAT_SHAPE = (4, 4096)


def grad_path() -> dict:
    """T-grad: ``ops.embedding_bag``'s table gradient on the card (the
    strategy kernel's forward, the ``index_add_`` backward) at path B's
    tables, each against autograd of the plain lookup in f32
    (``ref.embedding_bag_ref``) on the same card within ``TOL``; the GM, UB
    and L1 kernels' launches are this path's counts.  Recorded: the time of
    one forward + backward (CUDA events) beside the plain version's; those
    launches come after the counts are read."""
    import numpy as np
    import torch

    from repro_torch.data.workloads import get_workload
    from repro_torch.kernels import ops, ref

    wl = get_workload("taobao", T_BATCH)
    rng = np.random.default_rng(11)
    tables = {t: torch.from_numpy(rng.standard_normal((wl.tables[t].rows, wl.tables[t].dim))
                                  .astype(np.float32)).to(DEVICE) for t in T_GRAD_TABLES}
    cases = []
    reset_counts()
    for t, s, dtype_name in T_GRAD_CASES:
        dtype = getattr(torch, dtype_name)
        table = tables[t].to(dtype)
        m = table.shape[0]
        idx = torch.from_numpy(rng.integers(0, m, size=(T_BATCH, s)).astype(np.int32)).to(DEVICE)
        w = torch.from_numpy(rng.standard_normal((T_BATCH, table.shape[1]))
                             .astype(np.float32)).to(DEVICE)
        strategy = T_GRAD_TABLES[t]

        def grad(lookup, table=table, w=w):
            leaf = table.clone().requires_grad_()
            (lookup(leaf).float() * w).sum().backward()
            return leaf.grad

        kernel = lambda x, idx=idx, strategy=strategy: ops.embedding_bag(x, idx, strategy)  # noqa: E731
        # the plain lookup in f32, cast back: its backward scatters in f32
        # and casts, as the kernel path's does
        plain = lambda x, idx=idx: ref.embedding_bag_ref(x.float(), idx).to(x.dtype)  # noqa: E731
        got, want = grad(kernel), grad(plain)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        rec = {"t_grad": f"table {t} ({strategy}, m={m})", "s": s, "dtype": dtype_name,
               "max_err": err}
        cases.append((rec, grad, kernel, plain))
        check(torch.allclose(got.float(), want.float(), **TOL),
              f"[T-grad] table {t} s={s} {dtype_name}: max err {err}")
    counts = read_counts()  # the checked gradients' launches; the timing below adds none
    for name, k in (("embedding_bag_gm", "K3"), ("embedding_bag_ub", "K2"),
                    ("embedding_bag_l1", "K4")):
        check(counts[name] > 0, f"[T-grad] {k} ({name}) not launched")
    for rec, grad, kernel, plain in cases:
        rec["grad_ms"] = time_ms(lambda: grad(kernel), iters=5, warmup=1)
        rec["plain_grad_ms"] = time_ms(lambda: grad(plain), iters=5, warmup=1)
        print(json.dumps(rec), flush=True)
    return {"counts": counts}


def _dlrm_batch(wl, step: int, device) -> dict:
    import numpy as np
    import torch

    from repro_torch.data.synthetic import ctr_batch

    b = ctr_batch(np.random.default_rng(step), wl, batch=T_BATCH)
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def dlrm_train_path(tmp: Path) -> dict:
    """T-dlrm: the paper's model trained at the served width (taobao's 15
    tables, 3,142,468 rows, E = 16, f32; DLRMConfig defaults; batch 8192;
    Adagrad) through ``training.loop.train``.  Gates, none on the clock:
    the first 3 losses equal a CPU twin's (the same parameters and batches)
    within rtol 1e-4; a run with ``fail_at_step=6`` fails there, and its
    resume starts from the step-4 checkpoint and ends on the uninterrupted
    run's parameters within 1e-5; every loss finite.  Recorded:
    ``train_step_ms`` (host clock around a synchronized step, median)."""
    import numpy as np
    import torch

    from repro_torch.data.workloads import get_workload
    from repro_torch.models import dlrm
    from repro_torch.training.loop import LoopConfig, SimulatedFailure, train
    from repro_torch.training.optimizer import adagrad
    from repro_torch.tree import leaves

    wl = get_workload("taobao", T_BATCH)
    cfg = dlrm.DLRMConfig(arch="dlrm-taobao", workload=wl)
    serving = dlrm.init_dlrm(cfg, torch.Generator().manual_seed(0))
    opt = adagrad(T_DLRM_LR)
    step_fn = dlrm.make_dlrm_train_step(cfg, opt)

    def init_state(device=DEVICE):
        params = dlrm.train_params(serving, device)
        return params, opt.init(params)

    def run(name, **kw):
        loop = LoopConfig(total_steps=T_DLRM_STEPS, checkpoint_every=T_DLRM_EVERY,
                          checkpoint_dir=str(tmp / name), **kw)
        return train(loop, init_state=init_state, step_fn=step_fn,
                     batch_fn=lambda step: _dlrm_batch(wl, step, DEVICE))

    t0 = time.perf_counter()
    whole = run("whole")
    loop_s = time.perf_counter() - t0
    failed_at = None
    try:
        run("crash", fail_at_step=T_DLRM_FAIL)
    except SimulatedFailure:
        failed_at = T_DLRM_FAIL
    resumed = run("crash")
    params, state = init_state("cpu")
    twin = []
    for step in range(3):
        params, state, m = step_fn(params, state, _dlrm_batch(wl, step, "cpu"))
        twin.append(float(m["loss"]))
    params, state = init_state()
    batch = _dlrm_batch(wl, 0, DEVICE)
    step_ms = host_ms(lambda: (step_fn(params, state, batch), torch.cuda.synchronize()))
    diff = max(float((a - b).abs().max()) for a, b in zip(leaves(resumed["params"]),
                                                           leaves(whole["params"])))
    rec = {"t_dlrm": "taobao", "rows": sum(t.rows for t in wl.tables), "batch": T_BATCH,
           "optimizer": f"adagrad({T_DLRM_LR})", "steps": T_DLRM_STEPS, "losses": whole["losses"],
           "cpu_twin_losses": twin, "resumed_from": resumed["start_step"],
           "resume_max_param_diff": diff, "loop_s": loop_s, "train_step_ms": step_ms,
           "samples_per_s": T_BATCH / step_ms * 1e3}
    print(json.dumps(rec), flush=True)
    check(all(np.isfinite(whole["losses"] + resumed["losses"])), "[T-dlrm] a loss is not finite")
    check(np.allclose(whole["losses"][:3], twin, rtol=1e-4, atol=0),
          f"[T-dlrm] card losses {whole['losses'][:3]} vs CPU twin {twin}")
    check(failed_at == T_DLRM_FAIL, "[T-dlrm] the injected failure did not fire")
    check(resumed["start_step"] == T_DLRM_EVERY + 1,
          f"[T-dlrm] resumed at step {resumed['start_step']}, not after step {T_DLRM_EVERY}")
    check(diff <= 1e-5, f"[T-dlrm] resumed params differ from the uninterrupted run by {diff}")
    return {}


def family_path(name: str) -> dict:
    """T-lm, T-moe, T-swa, T-ssm, T-hybrid, T-encdec, T-vlm: one LM at its
    published width, depth cut as ``T_FAMILY`` says (the ``reduced`` field,
    empty for whisper, which runs whole), random init on the card, its
    inputs from ``_train_batch`` and ``_serve_inputs``.  At
    ``compute_dtype="float32"``: with a train shape, 3 AdamW
    steps, the first loss and aux loss within 1e-4 relative of the CPU
    twin's; a prefill and ``T_FAMILY_DECODE`` teacher-forced decode steps,
    timed, the decode logits held to the CPU twin's decode within ``1e-4 *
    max(|ref|, 1)`` or, where no MoE capacity drops a token, to the full
    forward within the JAX package's ``2e-3 * max(|ref|, 1)`` (see
    ``_decode_gate``).  T-swa also holds the batch-split prefill to
    the unsplit one: caches within 1e-5, logits within ``1e-5 *
    max(|ref|, 1)``.  Then a train step (where there is one), a
    prefill and a decode step at the published ``bfloat16``, gated only on
    finite values.  Recorded: ``train_step_ms``, ``tokens_per_s``,
    ``prefill_ms``, ``decode_ms_per_token`` (host clock around synchronized
    work, median), in f32 each one's device time, launches and the card's
    idle share (``_device_share``), the MoE's capacity drops, the parameter
    count and the peak of allocated card memory."""
    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models import registry
    from repro_torch.tree import leaves

    arch, layers, train_bs, (pb, ps), against = T_FAMILY[name]
    full = registry.build(arch).cfg
    cfg32 = dataclasses.replace(full, n_layers=layers, compute_dtype="float32")
    cfg16 = dataclasses.replace(cfg32, compute_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    bundle = registry.Bundle(cfg32)
    params = bundle.init(torch.Generator(DEVICE).manual_seed(0))
    rec = {"t_family": name, "arch": arch, "d_model": full.d_model, "n_heads": full.n_heads,
           "head_dim": full.head_dim, "d_ff": full.d_ff, "vocab": full.vocab,
           "window": full.window, "enc_layers": full.enc_layers,
           "mrope_sections": full.mrope_sections,
           "reduced": {"n_layers": [full.n_layers, layers]} if layers < full.n_layers else {},
           "moe": full.moe and dataclasses.asdict(full.moe),
           "ssm": full.ssm and dataclasses.asdict(full.ssm),
           "params": sum(int(x.numel()) for x in leaves(params))}
    if train_bs is not None:
        rec.update(_family_train(name, (cfg32, cfg16), params, bundle, train_bs))
    inputs = _serve_inputs(name, bundle, pb, ps + T_FAMILY_DECODE)
    for cfg in (cfg32, cfg16):
        serve, dec = _family_serve(name, cfg, params, inputs, ps)
        rec.setdefault(cfg.compute_dtype, {}).update(serve)
        if cfg is cfg32:
            rec["decode_gate"] = _decode_gate(name, cfg, params, inputs, ps, against, dec)
        del dec
    if name == "T-swa":
        rec["split_prefill"] = _split_prefill(cfg32, params, bundle)
    rec["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps(rec), flush=True)
    del params
    torch.cuda.empty_cache()
    return {}


def qwen2vl_positions(rows, device) -> "torch.Tensor":
    """(3, B, S) int32 M-RoPE positions of Qwen2-VL's layout, a row's
    segments ``("text", n)`` or ``("image", gh, gw)``: a text token at index
    ``i`` gets ``(i, i, i)``, an image from ``s`` gets ``(s, s + r, s + c)``
    for its patch at row ``r`` and column ``c``, and the text after it
    resumes at ``s + max(gh, gw)``."""
    import torch

    out = []
    for segments in rows:
        pos, nxt = [], 0
        for seg in segments:
            if seg[0] == "text":
                pos += [(nxt + i,) * 3 for i in range(seg[1])]
                nxt += seg[1]
            else:
                _, gh, gw = seg
                pos += [(nxt, nxt + r, nxt + c) for r in range(gh) for c in range(gw)]
                nxt += max(gh, gw)
        out.append(pos)
    return torch.tensor(out, dtype=torch.int32, device=device).permute(2, 0, 1).contiguous()


def _train_batch(bundle, shape) -> dict:
    """``make_batch``'s random batch; for an embeds config its positions
    replaced by ``T_VLM_TRAIN_ROWS``' layout."""
    import torch

    batch = bundle.make_batch(shape, torch.Generator(DEVICE).manual_seed(1))
    if bundle.cfg.input_kind == "embeds":
        batch["positions"] = qwen2vl_positions(T_VLM_TRAIN_ROWS, DEVICE)
    return batch


def _serve_inputs(name, bundle, b, seq) -> dict:
    """The prefill's and the decode steps' inputs over ``seq`` positions:
    tokens; or whisper's ``T_ENCDEC_FRAMES`` frames and ``seq`` tokens; or
    embeds on ``T_VLM_PREFILL_ROW``'s layout, then text to ``seq``."""
    import torch

    from repro_torch.configs.base import ShapeCfg

    cfg, gen = bundle.cfg, torch.Generator(DEVICE).manual_seed(2)
    if cfg.input_kind == "frames_tokens":
        batch = bundle.make_batch(ShapeCfg(name, "prefill", T_ENCDEC_FRAMES, b), gen)
        return {"frames": batch["frames"], "tokens": batch["tokens"][:, :seq]}
    batch = bundle.make_batch(ShapeCfg(name, "prefill", seq, b), gen)
    if cfg.input_kind == "embeds":
        n = sum(seg[1] if seg[0] == "text" else seg[1] * seg[2] for seg in T_VLM_PREFILL_ROW)
        batch["positions"] = qwen2vl_positions([T_VLM_PREFILL_ROW + [("text", seq - n)]] * b,
                                               DEVICE)
    return batch


def _batch_seq(inputs: dict) -> tuple[int, int]:
    """(B, S) of the tokens or the embeds (not whisper's frames)."""
    return tuple((inputs["embeds"] if "embeds" in inputs else inputs["tokens"]).shape[:2])


def _prefix(inputs: dict, n: int) -> dict:
    """The inputs of the first ``n`` positions (whisper's frames whole)."""
    return {k: v if k == "frames" else v[..., :n] if k == "positions" else v[:, :n]
            for k, v in inputs.items()}


def _step(inputs: dict, t: int) -> dict:
    """One decode step's inputs at position ``t``."""
    return {k: v[..., t:t + 1] if k == "positions" else v[:, t:t + 1]
            for k, v in inputs.items() if k != "frames"}


def _family_train(name, cfgs, params, bundle, train_bs) -> dict:
    """3 AdamW steps in f32 (the first loss and aux loss held to the CPU
    twin's forward of the same parameters and batch), then one in bf16."""
    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import adamw
    from repro_torch.tree import tree_map

    b, s = train_bs
    shape = ShapeCfg(name, "train", s, b)
    batch = _train_batch(bundle, shape)
    cfg32 = cfgs[0]
    cpu_p = tree_map(lambda x: x.cpu(), params)
    with moe_drops() as drops:
        h, aux, _ = T.forward_seq(cfg32, cpu_p, {k: v.cpu() for k, v in batch.items()
                                                 if k != "labels"})
    twin = (float(T.ce_loss(cfg32, T.lm_logits(cfg32, cpu_p, h), batch["labels"].cpu())),
            float(aux))
    del cpu_p, h
    out = {"batch": b, "seq": s, "cpu_twin_first": {"loss": twin[0], "aux": twin[1]},
           "train_moe_drops": sum(drops)}
    opt = adamw(3e-4)
    for cfg in cfgs:
        step = T.make_train_step(cfg, None, opt, shape)
        p, state, losses, auxs = params, opt.init(params), [], []
        for _ in range(3 if cfg is cfg32 else 1):
            p, state, m = step(p, state, batch)
            losses.append(float(m["loss"]))
            auxs.append(float(m["aux"]))
        check(all(abs(x) < float("inf") for x in losses + auxs),
              f"[{name}] {cfg.compute_dtype} loss or aux not finite: {losses} {auxs}")
        step_ms = host_ms(lambda: (step(params, state, batch), torch.cuda.synchronize()),
                          iters=3)
        out[cfg.compute_dtype] = {"losses": losses, "aux": auxs, "train_step_ms": step_ms,
                                  "tokens_per_s": b * s / step_ms * 1e3}
        if cfg is cfg32:
            out["train_step_device"] = _device_share(lambda: step(params, state, batch), step_ms)
        del p, state
    first = out["float32"]
    check(abs(first["losses"][0] - twin[0]) <= 1e-4 * abs(twin[0]),
          f"[{name}] first loss {first['losses'][0]} vs CPU twin {twin[0]}")
    check(abs(first["aux"][0] - twin[1]) <= 1e-4 * abs(twin[1]),
          f"[{name}] first aux {first['aux'][0]} vs CPU twin {twin[1]}")
    return out


def _decode_logits(cfg, params, inputs, s0, ctx=None):
    """Prefill the first ``s0`` positions of ``inputs``, then teacher-forced
    decode of the rest (under ``ctx``) -> (the prefill's and each step's
    logits but the last, (B, S - s0, V); the prefill step; the serve step;
    the prefill's cache)."""
    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models import transformer as T

    b, seq = _batch_seq(inputs)
    prefill = T.make_prefill_step(cfg, ctx, ShapeCfg("t-family", "decode", seq, b))
    serve = T.make_serve_step(cfg, ctx)
    logits, cache = prefill(params, _prefix(inputs, s0))
    start, dec = cache, [logits]
    for t in range(s0, seq):
        lg, cache = serve(params, cache, _step(inputs, t))
        dec.append(lg)
    return torch.cat(dec[:-1], dim=1).float(), prefill, serve, start


def _family_serve(name, cfg, params, inputs, s0) -> tuple[dict, "torch.Tensor"]:
    """The prefill and decode of ``_decode_logits`` at ``cfg``, timed, the
    MoE's capacity drops counted, the logits gated on finite values ->
    (record, the decode logits)."""
    import torch

    with moe_drops() as drops:
        dec, prefill, serve, start = _decode_logits(cfg, params, inputs, s0)
    check(bool(torch.isfinite(dec).all()), f"[{name}] {cfg.compute_dtype} decode not finite")
    first, one = _prefix(inputs, s0), _step(inputs, s0)
    frames = {"frames": list(inputs["frames"].shape)} if "frames" in inputs else {}
    rec = {"prefill": list(_batch_seq(first)), **frames,
           "decode_steps": _batch_seq(inputs)[1] - s0,
           "prefill_moe_drops": sum(drops),
           "prefill_ms": host_ms(lambda: (prefill(params, first),
                                          torch.cuda.synchronize()), iters=3),
           "decode_ms_per_token": host_ms(lambda: (serve(params, start, one),
                                                   torch.cuda.synchronize()), iters=5)}
    if cfg.compute_dtype == "float32":
        rec["prefill_device"] = _device_share(lambda: prefill(params, first), rec["prefill_ms"])
        rec["decode_device"] = _device_share(lambda: serve(params, start, one),
                                             rec["decode_ms_per_token"])
    return rec, dec


def _device_share(fn, host: float) -> dict:
    """One call of ``fn`` on the card (``profile_calls``): its device time,
    its launches, its five longest kernels by name, and the card's idle
    share of ``host``, the call's host-clock time.  Not gated: late in the
    script a session of a whole LM step can lose the card's records, and
    then it reads "not measured"."""
    prof = profile_calls(fn, calls=1)
    dev = prof["device_ms"]
    return {"device_ms": dev, "launches": prof["launches_per_call"],
            "idle_share": 1 - dev / host if isinstance(dev, float) else "not measured",
            "top_kernels_ms": dict(list(prof["kernels_ms"].items())[:5])}


def _decode_gate(name, cfg, params, inputs, s0, against, dec) -> dict:
    """The f32 decode logits held to the CPU twin's decode of the same
    config within ``1e-4 * max(|ref|, 1)`` ("twin"), or ("forward") a
    decode held to the card's full forward within the JAX package's
    ``2e-3 * max(|ref|, 1)``; an MoE config then runs with the capacity
    raised to ``n_experts`` (as the JAX package's own decode test), so
    that neither drops a token: decode = forward holds only then."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    out = {"decode_against": against}
    if against == "twin":
        cpu_p = tree_map(lambda x: x.cpu(), params)
        want = _decode_logits(cfg, cpu_p, {k: v.cpu() for k, v in inputs.items()},
                              s0)[0].to(dec.device)
        del cpu_p
        rel = 1e-4
    else:
        if cfg.moe is not None:
            with moe_drops() as drops:  # the published capacity, recorded
                T.forward_seq(cfg, params, inputs)
            out["published_forward_moe_drops"] = sum(drops)
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
            out["capacity_factor"] = cfg.moe.capacity_factor
        with moe_drops() as drops:
            dec = _decode_logits(cfg, params, inputs, s0)[0]
            h, _, _ = T.forward_seq(cfg, params, inputs)
        want = T.lm_logits(cfg, params, h)[:, s0 - 1:_batch_seq(inputs)[1] - 1]
        del h
        out["moe_drops"] = sum(drops)
        check(sum(drops) == 0, f"[{name}] the decode gate's runs dropped {drops} assignments")
        rel = 2e-3
    err, tol = float((dec - want).abs().max()), rel * max(float(want.abs().max()), 1.0)
    out.update(decode_max_err=err, decode_bound=tol)
    check(err < tol, f"[{name}] decode logits off the {against} by {err} (bound {tol})")
    return out


def _split_prefill(cfg, params, bundle) -> dict:
    """``make_prefill_step`` at ``T_SWA_SPLIT``'s shape name, whose
    ``serve_microbatch`` splits the batch in two strided halves, against
    the unsplit prefill: logits and every cache leaf within 1e-5, in the
    batch's order."""
    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models import transformer as T

    shape_name, b, s = T_SWA_SPLIT
    mb = cfg.serve_microbatch.get(shape_name, 1)
    check(mb == 2, f"[T-swa] serve_microbatch[{shape_name}] is {mb}, not 2")
    shape = ShapeCfg(shape_name, "prefill", s + T_FAMILY_DECODE, b)
    batch = {"tokens": bundle.make_batch(ShapeCfg("t-swa", "prefill", s, b),
                                         torch.Generator(DEVICE).manual_seed(3))["tokens"]}
    logits, cache = T.make_prefill_step(cfg, None, shape)(params, batch)
    whole = dataclasses.replace(cfg, serve_microbatch={})
    w_logits, w_cache = T.make_prefill_step(whole, None, shape)(params, batch)
    errs = {"logits": float((logits - w_logits).abs().max())}
    for k in ("k", "v"):
        errs[k] = float((cache[k] - w_cache[k]).abs().max())
        check(torch.allclose(cache[k], w_cache[k], **TOL),
              f"[T-swa] split prefill's {k} off the unsplit one by {errs[k]}")
    # batches of 1 and 2 run other GEMM tilings: f32 reduction order, held
    # as the other logit gates are, to the logits' scale
    scale = max(float(w_logits.abs().max()), 1.0)
    check(errs["logits"] <= 1e-5 * scale,
          f"[T-swa] split prefill's logits off the unsplit ones by {errs['logits']} "
          f"(bound {1e-5 * scale})")
    check(cache["pos"] == w_cache["pos"] == s, "[T-swa] split prefill's pos")
    return {"batch": b, "seq": s, "serve_microbatch": mb, "cache_slots": cache["k"].shape[2],
            "max_abs_err": errs, "logits_max_abs": scale}


@contextlib.contextmanager
def moe_drops():
    """Counts, for every MoE layer call of the LM stack in the block, the
    (token, expert) assignments its capacity drops: per routing group,
    each expert's top-k load beyond ``capacity``.  Yields the list of
    counts, one per call."""
    import math

    import torch
    import torch.nn.functional as F

    from repro_torch.models import transformer as T
    from repro_torch.sharding import is_dtensor

    orig, counts = T.moe_apply, []

    def counting(p, x, spec, constrain=None):
        t, d = x.shape[-2:]
        with torch.no_grad():  # a DTensor whole first (a collective: every rank calls it)
            xw, router = (v.full_tensor() if is_dtensor(v) else v for v in (x, p["router"]))
        xf = xw.reshape(-1, t, d)
        if t > spec.group_size and t % spec.group_size == 0:
            xf, t = xf.reshape(-1, spec.group_size, d), spec.group_size
        cap = max(int(math.ceil(t * spec.top_k / spec.n_experts * spec.capacity_factor)), 1)
        with torch.no_grad():
            probs = torch.softmax((xf @ router.to(x.dtype)).float(), dim=-1)
            load = F.one_hot(torch.topk(probs, spec.top_k, dim=-1).indices,
                             spec.n_experts).sum(dim=(1, 2))
            counts.append(int((load - cap).clamp(min=0).sum()))
        return orig(p, x, spec, constrain)

    T.moe_apply = counting
    try:
        yield counts
    finally:
        T.moe_apply = orig


def _lm_cut(arch: str, layers: int, enc_layers: int | None = None):
    """``arch``'s published config at ``layers`` layers (and an encoder's
    at ``enc_layers``) in f32, and the ``reduced`` record of the cut."""
    from repro_torch.models import registry

    full = registry.build(arch).cfg
    cfg = dataclasses.replace(full, n_layers=layers, compute_dtype="float32")
    reduced = {"n_layers": [full.n_layers, layers]}
    if enc_layers is not None:
        cfg = dataclasses.replace(cfg, enc_layers=enc_layers)
        reduced["enc_layers"] = [full.enc_layers, enc_layers]
    return cfg, reduced


def _rel(got, want) -> float:
    """max |got - want| over max(max |want|, 1)."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


def shard_path() -> dict:
    """T-shard: T-lm's olmo-1b (4 of 16 layers, d 2048, vocab padded to
    50,432, f32) with a ``ShardCtx`` on the single-pod production mesh shape
    (data 16, model 16): the embedding runs as 16 vocab shards of 3,152
    rows, the batch of 2 is not split (``shard_batch`` false).  One AdamW
    train step at 2 x 512 (remat on), a 2 x 256 prefill and 16 decode steps,
    each against the same work with ``ctx=None`` on the card: the loss
    within 1e-6 relative, the prefill's and decode's logits within ``1e-6 *
    max(|ref|, 1)``; whether each is bitwise equal is recorded.  Recorded
    both ways: ``train_step_ms``, ``prefill_ms``, ``decode_ms_per_token``
    (host clock around synchronized work, median) and the embedding's device
    time at the train and the decode shape (``profile_calls``)."""
    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch.dryrun import make_ctx
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import registry
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import adamw

    arch, layers, (b, s), (pb, ps), _ = T_FAMILY["T-lm"]
    cfg, reduced = _lm_cut(arch, layers)
    bundle = registry.Bundle(cfg)
    mesh = make_production_mesh()
    shape = ShapeCfg("t-shard", "train", s, b)
    ctx = make_ctx(mesh, shape, False)
    k = mesh.shape[ctx.model_axis]
    torch.cuda.reset_peak_memory_stats()
    params = bundle.init(torch.Generator(DEVICE).manual_seed(0))
    batch = _train_batch(bundle, shape)
    inputs = _serve_inputs("T-shard", bundle, pb, ps + T_FAMILY_DECODE)
    first, one = _prefix(inputs, ps), _step(inputs, ps)
    opt = adamw(3e-4)
    state = opt.init(params)
    rec = {"t_shard": arch, "mesh": mesh.shape, "vocab_padded": cfg.vocab_padded,
           "vocab_shards": k, "shard_rows": cfg.vocab_padded // k,
           "shard_batch": ctx.shard_batch, "reduced": reduced, "train": [b, s],
           "prefill": [pb, ps], "decode_steps": T_FAMILY_DECODE}
    out = {}
    for label, c in (("sharded", ctx), ("unsharded", None)):
        step = T.make_train_step(cfg, c, opt, shape)
        loss = step(params, state, batch)[2]["loss"]
        dec, prefill, serve, start = _decode_logits(cfg, params, inputs, ps, c)
        out[label] = (loss, dec)
        rec[label] = {
            "loss": float(loss),
            "train_step_ms": host_ms(lambda: (step(params, state, batch),
                                              torch.cuda.synchronize()), iters=3),
            "prefill_ms": host_ms(lambda: (prefill(params, first), torch.cuda.synchronize()),
                                  iters=3),
            "decode_ms_per_token": host_ms(lambda: (serve(params, start, one),
                                                    torch.cuda.synchronize()), iters=5),
            "embed_device_ms": {
                "train": profile_calls(lambda: T.embed_tokens(cfg, params, batch["tokens"], c),
                                       calls=5)["device_ms"],
                "decode": profile_calls(lambda: T.embed_tokens(cfg, params, one["tokens"], c),
                                        calls=5)["device_ms"]},
        }
        del start
    (loss, dec), (loss0, dec0) = out["sharded"], out["unsharded"]
    loss_rel = float((loss - loss0).abs()) / abs(float(loss0))
    logits_rel = _rel(dec, dec0)
    rec.update(loss_rel_err=loss_rel, logits_rel_err=logits_rel,
               loss_bitwise=bool(torch.equal(loss, loss0)),
               logits_bitwise=bool(torch.equal(dec, dec0)),
               max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(json.dumps(rec), flush=True)
    check(loss_rel <= 1e-6, f"[T-shard] sharded loss {float(loss)} vs {float(loss0)}")
    check(logits_rel <= 1e-6, f"[T-shard] prefill/decode logits off by {logits_rel} relative")
    del params, state, out, dec, dec0
    torch.cuda.empty_cache()
    return {}


def remat_path() -> dict:
    """T-remat: olmo-1b at T-lm's cut (4 of 16 layers, f32) at
    ``T_REMAT_SHAPE`` (4 x 4096).  The loss and every gradient of the train
    step's loss with ``forward_seq(remat=True)`` against the same loss with
    ``remat=False``: within 1e-6 relative (bitwise recorded).  Then one
    AdamW step each way, timed (host clock, median of 3): ``make_train_step``
    (remat on) and this script's own step around ``forward_seq(remat=
    False)``; each step's peak allocated card memory above what was
    allocated when it began."""
    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models import registry
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import adamw
    from repro_torch.tree import leaves, value_and_grad

    arch, layers = T_FAMILY["T-lm"][:2]
    cfg, reduced = _lm_cut(arch, layers)
    b, s = T_REMAT_SHAPE
    shape = ShapeCfg("t-remat", "train", s, b)
    bundle = registry.Bundle(cfg)
    params = bundle.init(torch.Generator(DEVICE).manual_seed(0))
    batch = _train_batch(bundle, shape)
    opt = adamw(3e-4)

    def loss_fn(remat):
        def fn(p, mb):
            h, aux, _ = T.forward_seq(cfg, p, mb, remat=remat)
            loss = T.ce_loss(cfg, T.lm_logits(cfg, p, h), mb["labels"])
            return loss + T.AUX_LOSS_WEIGHT * aux, (loss, aux)
        return fn

    # the remat gradients wait on the host while the plain backward, the
    # largest allocation of the script, runs
    (l1, _), g1 = value_and_grad(loss_fn(True), params, batch, has_aux=True)
    g1 = [x.cpu() for x in leaves(g1)]
    (l0, _), g0 = value_and_grad(loss_fn(False), params, batch, has_aux=True)
    g0 = [x.cpu() for x in leaves(g0)]
    grad_rel = max(_rel(x, y) for x, y in zip(g1, g0))
    grads_bitwise = all(torch.equal(x, y) for x, y in zip(g1, g0))
    loss_rel = float((l1 - l0).abs()) / abs(float(l0))
    rec = {"t_remat": arch, "reduced": reduced, "batch": b, "seq": s, "loss": float(l1),
           "loss_rel_err": loss_rel, "loss_bitwise": bool(torch.equal(l1, l0)),
           "grad_rel_err": grad_rel, "grads_bitwise": grads_bitwise}
    del g0, g1
    state = opt.init(params)

    def plain_step(p, st, mb):
        (_, (loss, aux)), grads = value_and_grad(loss_fn(False), p, mb, has_aux=True)
        new_p, new_st = opt.update(grads, st, p)
        return new_p, new_st, {"loss": loss, "aux": aux}

    for label, step in (("remat", T.make_train_step(cfg, None, opt, shape)),
                        ("plain", plain_step)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(params, state, batch)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        ms = host_ms(lambda: (step(params, state, batch), torch.cuda.synchronize()), iters=3)
        rec[label] = {"train_step_ms": ms, "tokens_per_s": b * s / ms * 1e3,
                      "peak_above_start_gb": peak}
    print(json.dumps(rec), flush=True)
    check(loss_rel <= 1e-6, f"[T-remat] loss with remat {float(l1)} vs without {float(l0)}")
    check(grad_rel <= 1e-6, f"[T-remat] gradients off by {grad_rel} relative")
    del params, state
    torch.cuda.empty_cache()
    return {}


def train_cli_path(tmp: Path) -> dict:
    """T-cli: the train CLI on the card as a subprocess, for the DLRM,
    qwen3-0.6b, granite-moe-3b-a800m, whisper-small and qwen2-vl-2b (their
    SMOKE configs), each into a fresh checkpoint directory.
    Gated: exit code 0 and the ``[train] done`` line."""
    import os

    recs = []
    for i, args in enumerate(T_CLI):
        argv = [sys.executable, "-m", "repro_torch.launch.train", *args,
                "--checkpoint-dir", str(tmp / f"cli{i}")]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True, timeout=300, cwd=tmp,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        done = [ln for ln in proc.stdout.splitlines() if ln.startswith("[train] done")]
        recs.append({"t_cli": " ".join(args), "rc": proc.returncode, "done": done,
                     "wall_s": time.perf_counter() - t0})
        print(json.dumps(recs[-1]), flush=True)
        check(proc.returncode == 0 and done,
              f"[T-cli] {' '.join(args)} rc={proc.returncode}: {proc.stderr[-2000:]}")
    return {}


# --------------------------------------------------------------------------
# the partitioned lookup across cards (MC)
# --------------------------------------------------------------------------

# path A's config (the LIF fallback, a symmetric group from K = 2), path B's
# (every table symmetric: the UB, GM and L1 kernels), path E's dense layout,
# and M's two-level plan at [2,2] with the whole access reduction (dedup,
# cache and sparse gather on every core under a100)
MC_A = ["--workload", "taobao", "--batch", "8192", "--queries", "16384",
        "--distribution", "uniform", "--set", 'planner_options={"shard_rocks": false}']
# huawei-25mb under the serve CLI's defaults (shard_rocks on) with a lower
# rock bound: at K = 4 its five heaviest multi-hot tables (93-166 ids a
# bag) are split over all four cards, so each owner sums partials that
# other ranks computed (A's tables each lie on one card, and taobao's are
# one-hot: its rejoins add exact zeros)
MC_C = ["--workload", "huawei-25mb", "--batch", "8192", "--queries", "16384",
        "--distribution", "uniform",
        "--set", 'planner_options={"shard_rocks": true, "rock_theta": 0.5}']
MC_CASES = {
    "A": MC_A,
    "A-psum": MC_A + ["--set", "reduce_mode=psum"],
    "A-ring": MC_A + ["--set", "reduce_mode=ring"],
    "B": CLI_ARGS[:-2] + ["--set", "planner=symmetric", "--set", "hardware=ascend_910"],
    "E": CLI_ARGS[:-2] + ["--set", "layout=dense"],
    "C": MC_C,
    "C-psum": MC_C + ["--set", "reduce_mode=psum"],
    "C-ring": MC_C + ["--set", "reduce_mode=ring"],
    "M": ["--workload", "taobao", "--batch", "8192", "--queries", "16384",
          "--distribution", ZIPF, "--set", f"distribution={ZIPF}", "--set", "planner=hierarchical",
          "--set", "mesh_shape=[2,2]", "--set", "access=full", "--set", "hardware=a100"],
}
# MC under drift and integrity on W >= 2 cards: R replays F inline, F is
# the preset overlapped, I is F's first 24 batches (its zipf phase: no
# replan) with a sweep every 8 batches after two bit flips
MC_DRIFT = {
    "R": R_ARGS,
    "F": PRESETS["F"],
    "I": PRESETS["F"] + ["--queries", "12288", "--set", 'integrity_options={"check_every": 8}'],
}
MC_FLIP_BIT = 1 << 22
MC_TIMEOUT_S = 900


def mc_cases(world: int) -> list:
    """The MC cases a job of ``world`` cards runs: A and B at K = 1 on one
    card; each rejoin of A and C, B and E at K = world on more; M at [2,2]
    on 4; then R, F and I on more than one."""
    if world == 1:
        return ["A", "B"]
    return (["A", "A-psum", "A-ring", "B", "C", "C-psum", "C-ring", "E"]
            + (["M"] if world == 4 else []) + list(MC_DRIFT))


def _mc_expected(engine) -> list:
    """The kernels the plan's lookup launches on every rank."""
    from repro_torch.core.strategies import Strategy

    packed, names = engine.packed, set()
    if engine.plan.assignments:
        if packed.layout == "dense":
            names.add("multi_embedding_bag_dense")
        elif packed.unique_cap or packed.cache_rows:
            names.update({"multi_embedding_bag_ragged[dedup]", "batch_dedup"}
                         if packed.unique_cap else set())
            names.update({"multi_embedding_bag_ragged[cache]"} if packed.cache_rows else set())
            names.update({"multi_embedding_bag_ragged[sparse]"}
                         if packed.kernel_path != "onehot" else set())
        else:
            names.add("multi_embedding_bag_ragged")
    by = {Strategy.GM: "embedding_bag_gm", Strategy.GM_UB: "embedding_bag_ub",
          Strategy.L1_UB: "embedding_bag_ub", Strategy.L1: "embedding_bag_l1"}
    names.update(by[st] for st in engine.plan.symmetric_strategies)
    return sorted(names)


def _mc_case(label: str, world: int) -> dict:
    """One MC case on this rank: the serve CLI across the job's cards, then,
    every rank together, one batch's lookup across the cards (rank 0 holds
    it against the one-card engine), each rank's core lookup, rejoin and
    symmetric-group times by CUDA events, and its allocated bytes."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.data import distributions as dist_lib
    from repro_torch.engine import InferenceEngine
    from repro_torch.launch import serve

    argv = MC_CASES[label]
    rank = dist.get_rank()
    reset_counts()
    res = serve.main(argv)
    launches = read_counts()
    engine = res["engine"]
    packed, wl = engine.packed, engine.workload
    idx = torch.from_numpy(dist_lib.sample_workload(
        np.random.default_rng(11), wl, dist_lib.Uniform(), wl.batch)).to(engine.device)
    rec = {"case": label, "rank": rank, "argv": argv, "cores": engine.plan.n_cores,
           "chunk_bytes": packed.chunk_bytes, "ranks": engine.ranks, "launches": launches,
           "allocated_bytes": torch.cuda.memory_allocated(),
           "expected": _mc_expected(engine)}
    stages = engine.lookup_stages(idx)
    dist.barrier()
    got = stages["whole"]().cpu()
    if rank == 0:
        (s,) = res["stats"].values()
        rec.update(served=s["served"], submitted=s["submitted"],
                   batch_failures=s["batch_failures"],
                   logits_finite=bool(np.isfinite(res["last"]["logits"]).all()),
                   serve_wall_per_batch_ms=res["serve_wall_s"] / res["n_batches"] * 1e3,
                   p50_us=s["p50_us"], p99_us=s["p99_us"],
                   collective_bytes_per_batch=res["collective_bytes"],
                   rejoin_modeled=engine.ranks["rejoin_modeled"])
        one = InferenceEngine.build(
            res["params"]["tables"], wl,
            dataclasses.replace(engine.config, mesh_shape=engine.config.mesh_shape
                                or (1, engine.plan.n_cores)),
            device=engine.device)
        want = one.lookup(idx).cpu()
        rec.update(pooled_max_err=float((got - want).abs().max()),
                   pooled_ok=bool(torch.allclose(got, want, **TOL)),
                   pooled_bitwise=bool(torch.equal(got, want)),
                   one_card_lookup_ms=time_ms(lambda: one.lookup(idx)))
        del one, want
        torch.cuda.empty_cache()
    # every rank at once: its own core's lookup, the rejoin, the symmetric
    # group, and the whole lookup across the cards (CUDA events)
    for key in ("lookup", "rejoin", "sym", "whole"):
        if key in stages:
            dist.barrier()
            rec[f"{'mesh_lookup' if key == 'whole' else key}_ms"] = time_ms(stages[key])
    del res, engine, packed, stages
    torch.cuda.empty_cache()
    return rec


def _mc_flip(engine, kind: str) -> list:
    """Flip ``MC_FLIP_BIT`` in the first element of the first row of this
    rank's first ``kind`` region (``chunk`` or ``tail``); returns its key."""
    import torch

    m = engine.manifest
    key = min(k for k in m.spans if k[0] == kind)
    lo, _ = m.spans[key]
    raw = engine.packed.chunk_data[key[1] - m.core, lo, 0:1].view(torch.int32)
    raw ^= MC_FLIP_BIT
    return list(key)


def _mc_drift_case(label: str, world: int) -> dict:
    """One of MC's cases under drift and integrity on this rank: the serve
    CLI across the job's cards (I: rank 1 flips a bit in its first chunk
    region and rank W-1 one in its tail before it follows rank 0), then, on
    rank 0, for R and I the one-card engine of the same plan at K = W (its
    block size pinned to the mesh's sweep pick) through the same CLI and
    traffic."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.engine import InferenceEngine
    from repro_torch.launch import serve

    argv = MC_DRIFT[label]
    rank = dist.get_rank()
    flipped, allocated = [], []
    follow = InferenceEngine.follow
    kinds = (["chunk"] * (rank == 1) + ["tail"] * (rank == world - 1)) if label == "I" else []

    def flip_then_follow(engine):
        flipped.extend(_mc_flip(engine, kind) for kind in kinds)
        allocated.append(torch.cuda.memory_allocated(engine.device))  # generation 0 built
        return follow(engine)

    InferenceEngine.follow = flip_then_follow
    reset_counts()
    try:
        res = serve.main(argv)
    finally:
        InferenceEngine.follow = follow
    rec = {"case": label, "rank": rank, "argv": argv, "launches": read_counts(),
           "flipped": flipped}
    if rank == 0:
        (s,) = res["stats"].values()
        engine, logits = res["engine"], res["served_logits"]
        rec.update(served=s["served"], submitted=s["submitted"],
                   batch_failures=s["batch_failures"], batch=engine.config.max_batch,
                   logits_finite=bool(np.isfinite(logits).all()),
                   serve_wall_per_batch_ms=res["serve_wall_s"] / res["n_batches"] * 1e3,
                   p50_us=s["p50_us"], p99_us=s["p99_us"],
                   replan={k: v for k, v in s["replan"].items() if k != "events"},
                   events=s["replan"]["events"],
                   integrity={k: s["integrity"][k] for k in (
                       "checks", "corruptions_detected", "heals", "heal_failures",
                       "quarantined_regions", "events")},
                   generation=res["server"].step_fn.engine.generation,
                   op_log=engine.op_log, block_r=engine.packed.block_r,
                   cache_rows=engine.packed.cache_rows,
                   allocated_end=torch.cuda.memory_allocated(engine.device))
        if label in ("R", "I"):
            job_mesh = serve._job_mesh
            serve._job_mesh = lambda device: None  # the one-card engine in this rank
            try:
                one = serve.main(argv + [
                    "--set", f"mesh_shape=[1,{world}]", "--set", "tuning=fixed",
                    "--set", f'tuning_options={{"block_r": {engine.packed.block_r}}}'])
            finally:
                serve._job_mesh = job_mesh
            (os_,) = one["stats"].values()
            # I: the requests served after the first sweep healed the flips
            start = (s["integrity"]["events"][0]["batch"] * rec["batch"]
                     if label == "I" and s["integrity"]["events"] else 0)
            want = one["served_logits"]
            rec.update(
                one_events=[[e["batch"], e["parity_ok"]] for e in os_["replan"]["events"]],
                compared_from=start,
                logit_max_err=float(np.abs(logits[start:] - want[start:]).max())
                if len(logits) == len(want) else None,
                logits_ok=bool(len(logits) == len(want)
                               and np.allclose(logits[start:], want[start:], **TOL)))
            del one
    else:
        rec.update(follow=res["engine"].follow_stats, cache_rows=res["engine"].packed.cache_rows,
                   allocated_start=allocated[0])
    del res
    torch.cuda.empty_cache()
    dist.barrier()
    return rec


def _mc_drift_gates(label: str, world: int, recs: list) -> None:
    """R, F and I's gates and record (rank 0's record carries each rank's
    shadow build seconds, swap-point and sweep times from its op log)."""
    lead = recs[0]
    check(lead["served"] == lead["submitted"] and not lead["batch_failures"]
          and lead["logits_finite"], f"[MC {label}] serving: {lead['served']} of "
          f"{lead['submitted']}, {lead['batch_failures']} failed batches")
    r = lead["replan"]
    check(not r["replan_errors"] and not r["abandoned"],
          f"[MC {label}] replan errors or abandoned builds: {lead['events']}")
    for rec in recs[1:]:
        f = rec["follow"]
        check(f["generation"] == lead["generation"],
              f"[MC {label}] rank {rec['rank']} serves generation "
              f"{f['generation']}, rank 0 {lead['generation']}")
        # the other generations' shares are freed on every follower
        check(f["held"] == sorted({0, lead["generation"]})
              and f["shares_alive"] == [g for g in f["held"] if g],
              f"[MC {label}] rank {rec['rank']} holds generations {f['held']}, "
              f"shares alive {f['shares_alive']}")
    if label == "R":
        events = [[e["batch"], e["parity_ok"]] for e in lead["events"]]
        check(r["replans"] >= 1 and events == lead["one_events"],
              f"[MC R] replan batches {events}, one card {lead['one_events']}")
    if label in ("R", "I"):
        check(lead["logits_ok"], f"[MC {label}] logits max err {lead['logit_max_err']} "
              "against the one-card engine")
    if label == "F":
        check(r["replans"] >= 1, f"[MC F] no replan: {lead['events']}")
        for rec in recs:
            missing = [nm for nm in ("multi_embedding_bag_ragged[dedup]",
                                     "multi_embedding_bag_ragged[sparse]", "batch_dedup")
                       if not rec["launches"][nm]]
            check(not missing, f"[MC F] rank {rec['rank']} launched no {missing}")
    if label == "I":
        flipped = [k for rec in recs for k in rec["flipped"]]
        integ = lead["integrity"]
        first = integ["events"][0] if integ["events"] else {}
        check(first.get("regions") == flipped and first.get("healed")
              and integ["corruptions_detected"] == 2 and integ["heals"] == 1
              and not integ["heal_failures"],
              f"[MC I] flipped {flipped}, integrity {integ}")
    joins = [e for e in lead["op_log"] if e["op"] == "join"]
    sweeps = [e for e in lead["op_log"] if e["op"] == "verify"]
    heals = [e for e in lead["op_log"] if e["op"] == "heal"]
    print(json.dumps({
        "mc_drift": label, "world": world, "served": lead["served"],
        "batches": lead["submitted"] // lead["batch"], "block_r": lead["block_r"],
        "replan": lead["replan"], "events": lead["events"],
        "one_card_events": lead.get("one_events"), "logit_max_err": lead.get("logit_max_err"),
        "integrity": {k: v for k, v in lead["integrity"].items() if k != "events"},
        "integrity_events": lead["integrity"]["events"][:2],
        "serve_wall_per_batch_ms": lead["serve_wall_per_batch_ms"],
        "p50_us": lead["p50_us"], "p99_us": lead["p99_us"],
        "shadow_build_s": [e["build_s"] for e in joins],
        "swap_point_ms": [e["ms"] for e in joins],
        "sweep_ms": [e["ms"] for e in sweeps][:6], "sweep_wall_ms": [e["wall_ms"] for e in sweeps][:6],
        "heal_ms": [e["ms"] for e in heals],
        "cache_launches": [rec["launches"]["multi_embedding_bag_ragged[cache]"] for rec in recs],
        # each generation's cache rows a rank (0: the built one, then each swap point's)
        "cache_rows": [[rec["cache_rows"] for rec in recs]] + [e["cache_rows"] for e in joins],
        # each follower's allocated bytes with generation 0 built and at the end
        # (generation 0 and the live one held), and rank 0's at the end
        "allocated": [[lead["allocated_end"]]] + [
            [rec["allocated_start"], rec["follow"]["allocated"]] for rec in recs[1:]],
        "shares_alive": [rec["follow"]["shares_alive"] for rec in recs[1:]],
        "per_rank_launches": [{nm: n for nm, n in rec["launches"].items() if n} for rec in recs],
    }, default=str), flush=True)


def _mc_rank(rank: int, world: int, tmp: str, labels: list) -> None:
    """One rank of MC: a NCCL process group over the job's cards, then
    every case; rank 0 writes every rank's records to ``tmp``."""
    import os

    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    from repro_torch.launch.mesh import init_card_mesh

    init_card_mesh(device_type=DEVICE, init_method=f"file://{tmp}/group", rank=rank,
                   world_size=world, timeout_s=MC_TIMEOUT_S / 2)
    records = [(_mc_drift_case if label in MC_DRIFT else _mc_case)(label, world)
               for label in labels]
    every = [None] * world
    dist.all_gather_object(every, records)
    if rank == 0:
        Path(tmp, "records.json").write_text(json.dumps(every))
    dist.destroy_process_group()


def multicard_path() -> dict:
    """MC: the partitioned lookup with each plan core on its own card, one
    NCCL rank per card (``torch.cuda.device_count()`` of them), through the
    serve CLI's multi-rank code at taobao's full width (C: huawei-25mb's;
    batch 8192, 16,384 requests).  Gated for every case: every request
    served, finite logits, each rank's chunk bytes 1/W of the whole
    buffer, the pooled output of one batch within 1e-5 of the one-card
    engine of the same plan, and every kernel the plan's lookup launches
    launched on every rank; and on
    one card K1 and K2, on more cards K1-K4 and K8, and on four K5-K7, the
    dedup kernel and partials that C's ranks send each other.  Recorded:
    each rank's allocated bytes, its core's lookup time, the rejoin's and
    the symmetric group's times (CUDA events, each rank's own stream), the
    whole lookup across the cards, the bytes the rejoin handed the
    collectives beside the modeled ones."""
    import torch

    from repro_torch.launch import serve

    world = torch.cuda.device_count()
    labels = mc_cases(world)
    torch.cuda.empty_cache()
    every = _spawn_ranks("MC", _mc_rank, world, labels)
    counts = {name: 0 for name in KERNELS}
    for i, label in enumerate(labels):
        recs = [every[r][i] for r in range(world)]
        lead = recs[0]
        for name in KERNELS:
            counts[name] += lead["launches"][name]
        if label in MC_DRIFT:
            _mc_drift_gates(label, world, recs)
            continue
        whole = lead["ranks"]["whole_chunk_bytes"]
        queries = serve.build_parser().parse_args(MC_CASES[label]).queries
        check(lead["served"] == lead["submitted"] == queries and not lead["batch_failures"]
              and lead["logits_finite"], f"[MC {label}] serving: {lead}")
        check(lead["pooled_ok"], f"[MC {label}] pooled max err {lead['pooled_max_err']} "
              "against the one-card engine")
        check(lead["cores"] == world,
              f"[MC {label}] the plan has {lead['cores']} cores on {world} cards")
        check(lead["ranks"]["chunk_bytes"] == [whole // world] * world
              and all(r["chunk_bytes"] == whole // world for r in recs),
              f"[MC {label}] chunk bytes per rank {lead['ranks']['chunk_bytes']} of {whole}")
        for r in recs:
            missing = [nm for nm in r["expected"] if not r["launches"][nm]]
            check(not missing, f"[MC {label}] rank {r['rank']} launched no {missing}")
        print(json.dumps({
            "mc_path": label, "world": world, "cores": lead["cores"],
            "whole_chunk_bytes": whole, "pooled_max_err": lead["pooled_max_err"],
            "pooled_bitwise": lead["pooled_bitwise"],
            "serve_wall_per_batch_ms": lead["serve_wall_per_batch_ms"],
            "p50_us": lead["p50_us"], "p99_us": lead["p99_us"],
            "one_card_lookup_ms": lead["one_card_lookup_ms"],
            "collective_bytes_per_batch": lead["collective_bytes_per_batch"],
            "rejoin_modeled": lead["rejoin_modeled"],
            "per_rank": [{**{k: r.get(k) for k in (
                "rank", "chunk_bytes", "allocated_bytes", "lookup_ms", "rejoin_ms", "sym_ms",
                "mesh_lookup_ms")}, "launches": {nm: n for nm, n in r["launches"].items() if n}}
                for r in recs]}), flush=True)
    launched = {label: {nm for nm, n in every[0][i]["launches"].items() if n}
                for i, label in enumerate(labels)}
    if world == 1:
        check({"multi_embedding_bag_ragged", "embedding_bag_ub"}
              <= launched["A"] | launched["B"], f"[MC] K1 or K2 not launched: {launched}")
    else:
        check({"multi_embedding_bag_ragged", "embedding_bag_ub"} <= launched["A"],
              f"[MC A] K1 or K2 not launched: {launched['A']}")
        check({"embedding_bag_ub", "embedding_bag_gm", "embedding_bag_l1"} <= launched["B"],
              f"[MC B] K2-K4 not launched: {launched['B']}")
        check("multi_embedding_bag_dense" in launched["E"], f"[MC E] K8 not launched")
    if world == 4:
        c = every[0][labels.index("C")]["rejoin_modeled"]
        check(c["sparse_all_to_all_bytes"] > 0,
              f"[MC C] no table is split over the cards, the rejoin adds no partials: {c}")
    if "M" in launched:
        want = {f"multi_embedding_bag_ragged[{m}]" for m in ("dedup", "cache", "sparse")}
        check(want | {"batch_dedup"} <= launched["M"],
              f"[MC M] K5-K7 or the dedup kernel not launched: {launched['M']}")
    return {"counts": counts}


# --------------------------------------------------------------------------
# sharded LMs across cards (MC-LM)
# --------------------------------------------------------------------------

# label -> (arch, layers kept[, encoder layers kept]): each at its published
# width in f32; zamba2's 7 run its shared block (every 6th) once; mixtral's
# 1 of 56 as in T-swa
MC_LM = {"olmo": ("olmo-1b", 4), "granite": ("granite-moe-3b-a800m", 4),
         "mamba2": ("mamba2-780m", 4), "zamba2": ("zamba2-1.2b", 7),
         "whisper": ("whisper-small", 4, 4), "qwen2vl": ("qwen2-vl-2b", 4),
         "mixtral": ("mixtral-8x22b", 1), "chatglm3": ("chatglm3-6b", 4)}
MC_LM_GATHERS_A_LAYER = 2  # a mamba decode step: the projection's output and the conv's
MC_LM_TRAIN, MC_LM_PREFILL, MC_LM_DECODE = (4, 512), (4, 256), 16
# label -> its own prefill (shape name, (batch, seq)): mixtral's 4 x 5112
# under prefill_32k (the published serve_microbatch of 2) runs past the
# window of 4096, so its cache is min(4096, 5128) = 4096 slots in the rolling
# layout and decode writes slots 1016-1031, which cross from one rank's
# 1024 slots to the next on (1, 4)
MC_LM_SERVE = {"mixtral": ("prefill_32k", (4, 5112))}
# labels whose unsharded AdamW step does not fit on one card (parameters,
# gradients, two moments and the new ones: about 58 GB of mixtral's 1 of 56
# layers, plus the MoE dispatch): their one-card reference and (1, 1) run
# take the gradients alone; AdamW runs on meshes of more than one card
MC_LM_NO_ADAMW_ON_ONE_CARD = {"mixtral"}
# label -> (cache slots, the first and last decode step's rolling slot)
MC_LM_ROLLING = {"mixtral": (4096, [1016, 1031])}
MC_LM_TOL = 1e-5


def mc_lm_meshes(world: int) -> list:
    """The ``(data, model)`` meshes MC-LM runs on ``world`` cards: (1, 1)
    on one; (1, W), (W, 1) and, on four, (2, 2) on more."""
    if world == 1:
        return [(1, 1)]
    return [(1, world), (world, 1)] + ([(2, 2)] if world == 4 else [])


def _mc_lm_inputs(cfg, device, label) -> tuple:
    """The train batch, the prefill prompt and the decode steps' batches of
    ``cfg``'s input kind (``Bundle.make_batch`` at ``label``'s train,
    prompt and decode shapes), drawn on ``device`` from seed 1 (the same on
    every rank)."""
    import torch

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models import registry

    bundle, g = registry.Bundle(cfg), torch.Generator(device).manual_seed(1)
    shape_t, _, shape_d = _mc_lm_shapes(label)
    _, (pb, ps) = MC_LM_SERVE.get(label, ("mc-lm", MC_LM_PREFILL))

    def draw(shape):
        return bundle.make_batch(shape, g, act_dtype=torch.float32)

    return (draw(shape_t), draw(ShapeCfg("mc-lm", "prefill", ps, pb)),
            [draw(shape_d) for _ in range(MC_LM_DECODE)])


def _mc_lm_shapes(label):
    """``label``'s train, prefill and decode shapes: the prefill under its
    ``MC_LM_SERVE`` shape name, the caches room for the prompt and the
    decode steps."""
    from repro_torch.configs.base import ShapeCfg

    (b, s) = MC_LM_TRAIN
    name, (pb, ps) = MC_LM_SERVE.get(label, ("mc-lm", MC_LM_PREFILL))
    cap = ps + MC_LM_DECODE
    return (ShapeCfg("mc-lm", "train", s, b), ShapeCfg(name, "prefill", cap, pb),
            ShapeCfg("mc-lm", "decode", cap, pb))


def _grads_only():
    """An optimizer whose update hands back the gradients: the train
    step's ``value_and_grad`` gradients, exactly."""
    from repro_torch.training.optimizer import Optimizer

    return Optimizer(lambda p: {}, lambda g, state, p: (g, state), "grads")


def _all_gathers(counts: dict) -> int:
    """The all-gathers among ``CommDebugMode``'s collective counts (the
    functional ``all_gather_into_tensor`` and c10d's ``allgather_``)."""
    return sum(n for op, n in counts.items() if "allgather" in str(op).replace("_", ""))


def _mc_lm_run(label, cfg, params, inputs, ctx=None, place=lambda tree, specs: tree,
               adamw_step=True) -> dict:
    """Loss and gradients of one train step, one AdamW step (with
    ``adamw_step``; else a second step of the gradients alone), the
    prefill's logits and caches (an MoE's capacity drops counted) and each
    decode step's logits at ``label``'s shapes, every input placed by
    ``place`` first.  Timed by the host clock around synchronized work:
    the second step of the run, a second prefill and the decode steps after
    the first.  The all-gathers of the first train step and the first
    decode step are counted (``CommDebugMode``)."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import sharding as sh
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import adamw

    shape_t, shape_p, shape_d = _mc_lm_shapes(label)
    n_dp = sh.dp_size(ctx.mesh) if ctx is not None else 1
    train, prompt, steps = inputs
    params = place(params, sh.param_pspecs(params, False))
    train = place(train, sh.batch_pspecs(cfg, shape_t, False, n_dp))
    prompt = place(prompt, sh.batch_pspecs(cfg, shape_p, False, n_dp))
    steps = [place(b, sh.batch_pspecs(cfg, shape_d, False, n_dp)) for b in steps]
    out = {"params": params, "gathers": {}, "step_opt": "adamw" if adamw_step else "grads"}
    with CommDebugMode() as comm:
        grads, _, m = T.make_train_step(cfg, ctx, _grads_only(), shape_t)(params, {}, train)
    out["gathers"]["train"] = _all_gathers(comm.get_comm_counts())
    out.update(loss=m["loss"], grads=grads)
    opt = adamw(3e-4) if adamw_step else _grads_only()
    state = opt.init(params)
    step = T.make_train_step(cfg, ctx, opt, shape_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, new_state, _ = step(params, state, train)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    if adamw_step:
        out["new_params"], out["state"] = new, new_state
    del new, new_state, state
    prefill = T.make_prefill_step(cfg, ctx, shape_p)
    with moe_drops() as drops:
        out["prefill"], out["cache"] = prefill(params, prompt)
    out["prefill_moe_drops"] = sum(drops) if cfg.moe is not None else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # a second prefill, warm
    prefill(params, prompt)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    serve, c, out["decode"] = T.make_serve_step(cfg, ctx), out["cache"], []
    # the attention cache's slots and the first and last decode step's slot
    cap = c["k"].shape[2] if "k" in c else None
    out["cache_slots"] = cap
    out["decode_slots"] = cap and [(c["pos"] + t) % cap if cfg.window is not None
                                   else c["pos"] + t for t in (0, len(steps) - 1)]
    for t, batch in enumerate(steps):
        if t == 1:  # the steps after the first, warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        with CommDebugMode() if t == 0 else contextlib.nullcontext() as comm:
            lg, c = serve(params, c, batch)
        if t == 0:
            out["gathers"]["decode"] = _all_gathers(comm.get_comm_counts())
        out["decode"].append(lg)
    torch.cuda.synchronize()
    out["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / (MC_LM_DECODE - 1)
    out["cache_out"] = c
    return out


def _on_host(x):
    import torch

    return x.cpu() if isinstance(x, torch.Tensor) else x


def _mc_lm_case(label: str, meshes: list) -> list:
    """``label``'s MC-LM runs on this rank, one a ``(data, model)`` card mesh
    of ``meshes``, every leaf placed by the sharding rules; rank 0 first
    runs the same parameters and batches unsharded on its card (the
    reference) and holds each sharded run against it."""
    import torch
    import torch.distributed as dist

    from repro_torch import sharding as sh
    from repro_torch.device import resolve_device
    from repro_torch.launch.dryrun import make_ctx
    from repro_torch.launch.mesh import init_card_mesh
    from repro_torch.models import registry
    from repro_torch.tree import leaves, tree_map

    rank = dist.get_rank()
    arch, *layers = MC_LM[label]
    cfg, reduced = _lm_cut(arch, *layers)
    dev = resolve_device(DEVICE)
    params = registry.Bundle(cfg).init(torch.Generator(dev).manual_seed(0))
    inputs = _mc_lm_inputs(cfg, dev, label)
    shape_t, _, shape_d = _mc_lm_shapes(label)
    one_card_adamw = label not in MC_LM_NO_ADAMW_ON_ONE_CARD
    ref, one_card = None, None
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        ref = _mc_lm_run(label, cfg, params, inputs, adamw_step=one_card_adamw)
        one_card = {k: ref.pop(k) for k in ("step_ms", "step_opt", "prefill_ms",
                                            "decode_ms_per_token", "prefill_moe_drops")}
        one_card["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        for k in ("params", "new_params", "state", "cache", "gathers"):
            ref.pop(k, None)
        # held on the host while the sharded runs need the card's memory
        ref = {k: tree_map(_on_host, v) if k in ("grads", "cache_out") else v
               for k, v in ref.items()}
    # every rank places its leaves from the host, one at a time
    params = tree_map(_on_host, params)
    torch.cuda.empty_cache()
    recs = []
    for data, model in meshes:
        dist.barrier()
        t_case = time.perf_counter()
        mesh = init_card_mesh(data, model, device_type=DEVICE)
        ctx = make_ctx(mesh, shape_t, False)
        torch.cuda.reset_peak_memory_stats()
        got = _mc_lm_run(label, cfg, params, inputs, ctx,
                         lambda tree, specs: sh.with_sharding(mesh, tree, specs),
                         adamw_step=one_card_adamw or data * model > 1)
        rec = {"mc_lm": label, "arch": arch, "family": cfg.family, "mesh": [data, model],
               "rank": rank, "n_layers": cfg.n_layers, "reduced": reduced,
               "one_card": one_card, "shard_batch": ctx.shard_batch,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               **{k: got[k] for k in ("step_ms", "step_opt", "prefill_ms",
                                      "decode_ms_per_token", "gathers", "prefill_moe_drops",
                                      "cache_slots", "decode_slots")}}
        pspecs = sh.param_pspecs(got["params"], False)
        cspecs = sh.cache_pspecs(cfg, shape_d, False, sh.dp_size(mesh))
        held = [("params", got["params"], pspecs)]
        if "state" in got:
            moments = {"m": got["state"]["m"], "v": got["state"]["v"]}
            held += [("new_params", got["new_params"], pspecs),
                     ("moments", moments, sh.opt_pspecs(moments, pspecs))]
        held += [("cache", got["cache"], cspecs), ("cache_out", got["cache_out"], cspecs)]
        rec["bytes"] = {name: [sh.local_bytes(t), sh.per_device_bytes(t, specs, mesh)]
                        for name, t, specs in held}
        cap, n_model = got["cache_slots"], mesh.size(mesh.mesh_dim_names.index("model"))
        rec["decode_slot_ranks"] = cap and sorted({s // -(-cap // n_model)  # torch.chunk's
                                                   for s in got["decode_slots"]})
        rec["whole_param_bytes"] = sum(x.numel() * x.element_size()
                                       for x in leaves(got["params"]))

        def whole(x):  # a collective: every rank calls it
            return x.full_tensor() if sh.is_dtensor(x) else x

        errs, bitwise = {}, {}

        def gate(name, g, want):
            g = whole(g)
            if ref is not None:
                want = want.to(g.device)
                errs[name] = max(errs.get(name, 0.0), _rel(g, want))
                bitwise[name] = bitwise.get(name, True) and bool(torch.equal(g, want))

        loss = float(whole(got["loss"]))
        mine = leaves(got["grads"])
        for g, w in zip(mine, leaves(ref["grads"]) if ref else mine):
            gate("grads", g, w)
        gate("prefill", got["prefill"], ref["prefill"] if ref else None)
        finite = True
        for t, g in enumerate(got["decode"]):
            gate("decode", g, ref["decode"][t] if ref else None)
            finite = finite and bool(torch.isfinite(whole(g)).all())
        for key in sorted(k for k in got["cache_out"] if k != "pos"):
            gate("cache_after_decode", got["cache_out"][key],
                 ref["cache_out"][key] if ref else None)
        if ref is not None:
            want = float(ref["loss"])
            rec.update(loss=loss, loss_ref=want, loss_rel_err=abs(loss - want) / abs(want),
                       loss_bitwise=loss == want, max_rel_err=errs, bitwise=bitwise,
                       finite=finite)
        rec["case_s"] = time.perf_counter() - t_case
        recs.append(rec)
        del got
        torch.cuda.empty_cache()
    return recs


def _mc_lm_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of MC-LM: a NCCL process group over the job's cards, then
    every model on every mesh; rank 0 writes every rank's records to
    ``tmp``."""
    import os

    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    from repro_torch.launch.mesh import init_card_mesh

    init_card_mesh(device_type=DEVICE, init_method=f"file://{tmp}/group", rank=rank,
                   world_size=world, timeout_s=MC_TIMEOUT_S / 2)
    records = [rec for label in MC_LM for rec in _mc_lm_case(label, mc_lm_meshes(world))]
    every = [None] * world
    dist.all_gather_object(every, records)
    if rank == 0:
        Path(tmp, "records.json").write_text(json.dumps(every))
    dist.destroy_process_group()


def _spawn_ranks(label: str, fn, world: int, *args) -> list:
    """``fn(rank, world, tmp, *args)`` on one spawned process per card, a
    failed or late rank failing the phase; -> what rank 0 wrote to
    ``tmp/records.json``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mc_") as tmp:
        ctx = mp.start_processes(fn, args=(world, tmp, *args), nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + MC_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
                check(time.monotonic() < deadline, f"[{label}] ranks still running after "
                      f"{MC_TIMEOUT_S}s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            check(False, f"[{label}] a rank failed: {e}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return json.loads(Path(tmp, "records.json").read_text())


def multicard_lm_path() -> dict:
    """MC-LM: every LM family sharded across the job's cards, one NCCL rank
    per card (``torch.cuda.device_count()``), a ``ShardCtx`` over the card
    mesh and every leaf placed by the sharding rules (``DTensor``): each
    model of ``MC_LM`` at its published width in f32, on each mesh of
    ``mc_lm_meshes``.  Each run: one train step's loss and gradients
    (``value_and_grad``), one AdamW step at 4 x 512 (remat on; the
    gradients alone for ``MC_LM_NO_ADAMW_ON_ONE_CARD`` on one card), a 4 x
    256 prefill (``MC_LM_SERVE``'s for mixtral) and 16 decode steps.  Gated
    against the same parameters and batches unsharded on rank 0's card:
    the loss within 1e-5 relative, every gradient leaf, the prefill's and
    every decode step's logits and every cache leaf after the last decode
    step within ``1e-5 * max(|ref|, 1)``; an MoE prefill's capacity drops
    equal to one card's; mixtral's cache slots and rolling decode slots
    (``MC_LM_ROLLING``; the ranks that hold them recorded); on every rank the
    local bytes of the parameters (before and after the step), AdamW's
    moments and the caches (after prefill and after decode) equal to
    ``per_device_bytes`` of their specs, and on more than one card fewer
    parameter bytes than one card holds; a mamba2 decode step on a mesh
    with no data split at most ``MC_LM_GATHERS_A_LAYER`` all-gathers a
    layer (with a data split the ZeRO-3 gathers of ``in_proj`` and
    ``out_proj`` add two).  Recorded per rank: the step's, prefill's and
    decode's times per token (host clock around synchronized work, each
    after a first call of the same shapes), the all-gathers of one train
    step and one decode step, the peak allocated memory beside one card's,
    and whether each gate held bitwise; per model and mesh, rank 0's
    seconds."""
    import gc

    import torch

    world = torch.cuda.device_count()
    gc.collect()  # what earlier phases left in reference cycles
    torch.cuda.empty_cache()
    print(json.dumps({"mc_lm_parent_gb": {  # this process's share of card 0
        "allocated": torch.cuda.memory_allocated() / 1e9,
        "reserved": torch.cuda.memory_reserved() / 1e9}}), flush=True)
    every = _spawn_ranks("MC-LM", _mc_lm_rank, world)
    for i in range(len(every[0])):
        recs = [every[r][i] for r in range(world)]
        lead = recs[0]
        tag = f"[MC-LM {lead['mc_lm']} {tuple(lead['mesh'])}]"
        check(lead["loss_rel_err"] <= MC_LM_TOL,
              f"{tag} loss {lead['loss']} vs {lead['loss_ref']}")
        for name, err in lead["max_rel_err"].items():
            check(err <= MC_LM_TOL, f"{tag} {name} off by {err} relative")
        check(lead["finite"], f"{tag} non-finite decode logits")
        for r in recs:
            for name, (local, per_device) in r["bytes"].items():
                check(local == per_device, f"{tag} rank {r['rank']} holds {local} bytes of "
                      f"{name}, its specs {per_device}")
            check(world == 1 or r["bytes"]["params"][0] < r["whole_param_bytes"],
                  f"{tag} rank {r['rank']} holds every parameter")
            if r["family"] == "ssm" and lead["mesh"][0] == 1:
                check(r["gathers"]["decode"] <= MC_LM_GATHERS_A_LAYER * r["n_layers"],
                      f"{tag} rank {r['rank']}: {r['gathers']['decode']} all-gathers in a "
                      f"decode step of {r['n_layers']} mamba layers")
        check(lead["prefill_moe_drops"] == lead["one_card"]["prefill_moe_drops"],
              f"{tag} the prefill dropped {lead['prefill_moe_drops']} expert assignments, "
              f"one card {lead['one_card']['prefill_moe_drops']}")
        if lead["mc_lm"] in MC_LM_ROLLING:
            cap, slots = MC_LM_ROLLING[lead["mc_lm"]]
            check([lead["cache_slots"], lead["decode_slots"]] == [cap, slots],
                  f"{tag} {lead['cache_slots']} cache slots, decode slots "
                  f"{lead['decode_slots']}, not {cap} and {slots}")
        print(json.dumps({
            "mc_lm": lead["mc_lm"], "arch": lead["arch"], "family": lead["family"],
            "mesh": lead["mesh"],
            "world": world, "reduced": lead["reduced"], "loss": lead["loss"],
            "loss_rel_err": lead["loss_rel_err"], "loss_bitwise": lead["loss_bitwise"],
            "max_rel_err": lead["max_rel_err"], "bitwise": lead["bitwise"],
            "one_card": lead["one_card"], "whole_param_bytes": lead["whole_param_bytes"],
            "case_s": lead["case_s"], "step_opt": lead["step_opt"],
            "prefill_moe_drops": lead["prefill_moe_drops"], "cache_slots": lead["cache_slots"],
            "decode_slots": lead["decode_slots"],
            "decode_slot_ranks": lead["decode_slot_ranks"],
            "per_rank": [{k: r[k] for k in ("rank", "step_ms", "prefill_ms",
                                            "decode_ms_per_token", "gathers", "peak_gb",
                                            "bytes")}
                         for r in recs]}), flush=True)
    return {}


# --------------------------------------------------------------------------
# the example twins on the card (EX)
# --------------------------------------------------------------------------

# name -> (arguments, seconds allowed); each twin runs on its default
# device, the card, in a process of its own
EX = {
    "quickstart": ([], 180),
    "autoplan": ([], 120),
    "serve_dlrm": (["--queries", "256", "--batch", "64"], 180),
    "train_dlrm": (["--steps", "40", "--scale", "0.1", "--crash"], 180),
    "lm_smoke": (["--arch", "olmo-1b", "--steps", "10"], 180),
}
EX_PLAN_KERNELS = ("quickstart", "serve_dlrm")  # whose plans reach K1-K4
# a twin's main in a process of its own, the kernels' counts set to 0
# before it and printed after it
EX_RUNNER = """
import importlib, json, sys
root, name, *argv = sys.argv[1:]
sys.path[:0] = [root, root + "/src"]
import chip_smoke
chip_smoke.reset_counts()
importlib.import_module("repro_torch.examples." + name).main(argv)
print("[EX launches] " + json.dumps(chip_smoke.read_counts()), flush=True)
"""


def examples_path() -> dict:
    """EX: each twin of ``examples/*.py`` (``repro_torch.examples``) on the
    card at ``EX``'s small arguments, as a subprocess under its own time
    limit; any non-zero exit, and a quickstart lookup off the dense oracle
    by more than 1e-5, fails the phase.  Recorded: each twin's seconds, its
    last line and its kernels' launches; quickstart's and serve_dlrm's
    plans must have launched K1 and one of K2-K4."""
    import subprocess

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ex_") as tmp:
        for name, (args, limit) in EX.items():
            if name == "train_dlrm":
                args = args + ["--ckpt-dir", str(Path(tmp, "ckpt"))]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run([sys.executable, "-c", EX_RUNNER, str(ROOT), name, *args],
                                      capture_output=True, text=True, timeout=limit, cwd=tmp)
            except subprocess.TimeoutExpired:
                check(False, f"[EX {name}] still running after {limit}s")
            seconds = time.perf_counter() - t0
            check(proc.returncode == 0, f"[EX {name}] exit {proc.returncode}: "
                  f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
            lines = proc.stdout.splitlines()
            launches = json.loads(lines[-1].removeprefix("[EX launches] "))
            rec = {"ex": name, "args": args, "seconds": seconds, "last_line": lines[-2],
                   "launches": {k: v for k, v in launches.items() if v}}
            if name == "quickstart":
                errs = [float(line.rsplit(" ", 1)[1]) for line in lines
                        if "max err vs dense oracle" in line]
                check(len(errs) == 3 and max(errs) <= 1e-5,
                      f"[EX quickstart] lookups off the dense oracle: {errs}")
                rec["max_err"] = max(errs)
            if name in EX_PLAN_KERNELS:
                k24 = sum(launches[k] for k in ("embedding_bag_ub", "embedding_bag_gm",
                                                "embedding_bag_l1"))
                check(launches["multi_embedding_bag_ragged"] > 0 and k24 > 0,
                      f"[EX {name}] launches {launches}: K1 and one of K2-K4 expected")
            if name != "autoplan":
                check(lines[-2].startswith("OK"), f"[EX {name}] ends {lines[-2]!r}, not OK")
            print(json.dumps(rec), flush=True)
            out[name] = rec
    return out


PHASES = ("main", "F", "G", "H", "R", "X", "M", "S", "T", "EX", "MC", "MC-LM")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run after the build (default: all): "
                         "main (paths A-E and the kernels), F, G, H, R, X, M, S, T, EX, MC, "
                         "MC-LM")
    phases = set(ap.parse_args(argv).phases.split(","))
    if phases - set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}; known: {PHASES}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA card",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: src/repro_torch is missing beside this script", file=sys.stderr)
        return 2
    with phase("environment"):
        card = environment()
    with phase("build"):
        build_kernels()
    runs, kernels = {}, None
    for label in PATHS if "main" in phases else ():
        with phase(label):
            runs[label] = main_path(label)
    if "main" in phases:
        main_kernels(runs)
        with phase("kernels"):
            counts = {name: sum(r["counts"][name] for r in runs.values()) for name in KERNELS}
            kernels = kernel_phase(runs, counts)
        for r in runs.values():  # the later phases need the card's memory, not these engines
            r.pop("engine", None)
            r.pop("indices", None)
        torch.cuda.empty_cache()
    # the preset paths run last: no profiler session of this script's own is
    # open while a shadow build can run
    for label in PRESETS:
        if label in phases:
            with phase(label):
                runs[label] = preset_path(label)
    for label, path in (("R", replay_path), ("X", faults_path), ("M", mesh_path)):
        if label in phases:
            with phase(label):
                runs[label] = path()
    if "S" in phases:
        from repro_torch.models.registry import list_scenarios

        with phase("S"):
            for name in list_scenarios():
                runs[f"S {name}"] = scenario_path(name)
    if "T" in phases:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_t_") as tmp:
            with phase("T-grad"):
                runs["T-grad"] = grad_path()
            with phase("T-dlrm"):
                dlrm_train_path(Path(tmp))
            for name in T_FAMILY:
                with phase(name):
                    family_path(name)
            with phase("T-shard"):
                shard_path()
            with phase("T-remat"):
                remat_path()
            with phase("T-cli"):
                train_cli_path(Path(tmp))
    if "EX" in phases:
        with phase("EX"):
            examples_path()
    if "MC" in phases:
        with phase("MC"):
            runs["MC"] = multicard_path()
    if "MC-LM" in phases:
        with phase("MC-LM"):
            multicard_lm_path()
    print(f"[card] {card}")
    if kernels is not None:
        for rec in kernels:
            rec["launches"] = sum(r["counts"][rec["name"]] for r in runs.values())
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_kernels(runs: dict) -> None:
    """The main paths' launch gates: every kernel launched where it must be."""
    with phase("main-path launches"):
        check(runs["A"]["counts"]["multi_embedding_bag_ragged"] > 0, "K1 not launched on path A")
        check(runs["C"]["counts"]["multi_embedding_bag_ragged"] > 0, "K1 not launched on path C")
        check(runs["A"]["counts"]["embedding_bag_ub"] > 0, "K2 not launched on path A")
        check(runs["B"]["counts"]["embedding_bag_gm"] > 0, "K3 not launched on path B")
        check(runs["B"]["counts"]["embedding_bag_l1"] > 0, "K4 not launched on path B")
        check(runs["B"]["l1_modes"]["cluster"] > 0 and runs["B"]["l1_modes"]["resident"] > 0,
              f"K4 on path B ran no cluster or no resident launch: {runs['B']['l1_modes']}")
        for name, k in (("dedup", "K5"), ("cache", "K6"), ("sparse", "K7")):
            check(runs["D"]["counts"][f"multi_embedding_bag_ragged[{name}]"] > 0,
                  f"{k} ({name}) not launched on path D")
        check(runs["E"]["counts"]["multi_embedding_bag_dense"] > 0, "K8 not launched on path E")
        check(runs["D"]["counts"]["batch_dedup"] > 0, "the dedup kernel not launched on path D")


if __name__ == "__main__":
    sys.exit(main())
