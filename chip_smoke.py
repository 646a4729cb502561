#!/usr/bin/env python3
"""On-card smoke test of the grl_torch port (PyTorch + CUDA, NVIDIA H100).

Run from the root of a checkout, with one GPU visible::

    python3 chip_smoke.py

Phases, printed as they run. Any failure raises and exits non-zero
before the result line is printed; no phase's failure is passed over.

1. ``env``: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, TF32 off, and the build of every CUDA source under
   ``grl_torch/csrc`` for ``sm_90a`` (one ``nvcc`` per source, all
   started together).
2. ``kernel``: K3, K1 and K2 against their plain PyTorch versions on the
   card, B=8, L=6, N in {64, 192, 256}, F in {256, 512}, float32 and
   bfloat16, DropEdge rate 0.3: bf16 K3 (N % 8 == 0 and F % 8 == 0), K1
   and K2 in ``grl_torch/csrc/dropedge_sm90.cu``, float32 K1, K2 and K3
   in ``dropedge_f32.cu`` (also at N = 230), and bf16 K3 at the ragged
   N = 230 and the odd N = 231 on ``relagg_ragged.cu``; bf16 K1/K2 also at
   F = 64 and 1536, untimed. K1/K2 and their plain versions hash
   the same mask, which is checked exactly by probing the kernels with
   identity operands; the kept share, forward/backward consistency, "K1 at
   keep 1 is K3" (bit for bit in both dtypes), the ragged K3 at N = 256
   equal to the sm90 route bit for bit, two launches of bf16 K1, K2 and
   ragged K3 and of f32 K1, K2 and K3 giving equal bits, and how many of
   each K2's clusters
   the card holds are checked too; bf16 and f32 K2 are also timed under
   every split S at the main shape. Each case is timed with CUDA events (median of single
   launches, L2 flushed before each) beside the plain version, a PyTorch
   call for the same product (``library_ms``: ``torch.matmul``, on an
   already-masked A for K1/K2), and the card's bound. K3/K1/K2 rows also
   hold ``device_ms`` (the card kept busy until the call is enqueued, so
   the host's enqueue stays outside the events; for the kernel and
   ``torch.matmul``) and ``enqueue_ms``, the host time of one wrapper call.
3. ``serve``: the serving path, ``GNNLearningWarper.predict`` ->
   ``KVInference`` -> ``GraphCNNDropEdge`` at the full sumi width
   (input_dim 4369, output_dim 53, 6 relations, net_size 256,
   ``kernel_impl: pallas``, bfloat16), batch 8, bucket 256, with random
   weights drawn from a seed. Every page's graph is built by the native
   (C++) graph builder, ``grl_torch.data.native``, which the phase checks
   by its page counts. Prints pages/s and boxes/s, the host encode seconds
   and the builder's share of them, the idle share, beside the numbers
   the port had with the Python builder (PERF.md); checks the K3 launch count, and holds the
   predictions against the plain (``kernel_impl: xla``) path with the same
   weights, in bfloat16 and in float32.
4. ``train``: the training path, ``GNNLearningWarper.train`` ->
   ``KVProcedure`` at the same width with DropEdge 0.3 and dropout 0.5,
   two epochs over 64 synthetic pages (16 steps) with 16 validation pages
   (4 batches). Checks the K1/K2/K3 launch counts, finite losses, changed
   parameters and the checkpoint, which KVInference then serves; prints
   steps/s, nodes/s, the device idle share of a traced window with K1's
   and K2's device ms a step in it, and one train step timed on the card (``_train_fn``: on the card
   a replay of the step's one-step CUDA graph). Then a learning check (20 steps on one
   batch) and two full-width steps through the kernels against the same
   steps through their plain versions, float32 and bfloat16.
   Then the same recipe at ``scan_steps: 4``: chunks of 4 steps, each
   after the first a replay of one captured CUDA graph
   (``grl_torch.trainer.captured``); checks the steps, the checkpoint,
   finite losses and the launch counts the device ran (the launches a
   capture recorded times its replays, plus the eager ones); prints the
   seconds of the warm-up chunk and of the capture; times one
   step eagerly, replayed from its one-step graph and in the chunk's graph; holds a replayed chunk, and a
   single step replayed from its one-step graph, to the same chunk or step
   run eagerly from the same state, bit for bit; adds a second bucket
   (the same pages cut to N = 192), whose graph must share the runner's
   memory pool, and holds replays of the two graphs in turn to their
   chunks run eagerly, bit for bit; and replays a chunk that
   reads back K1's and D's (dropout's) masks, which must be new at each
   replay, the hash of the seeds the replay drew, and keep their shares.
   Every train-mode forward runs D five times, and its backward as often:
   the launch counts hold D too, here and in the phases below.
   Then two paths of their own, each one epoch of 8 steps and 2
   validation batches through ``GNNLearningWarper.train`` with its launch
   counts set to 0 just before it and read just after: the same config in
   float32 (``compute_dtype`` left at its default, so float32 K1, K2 and
   K3 run), and in bfloat16 without DropEdge at ``BucketPadding`` quantum 2
   (230-node batches: every K3 takes the ragged route).
5. ``ssl``: the self-supervised family through ``GNNLearningWarper.train``
   at the same width on the train phase's pages, one epoch a leg (each
   with its launch counts set to 0 just before it and read just after),
   through the data chain of ``tests/test_procedures.py``'s
   ``make_split(ssl=True)`` (node dropping, DGI negatives, SSL labels,
   ``NumpyPadding``) with ``pairwise_similarity`` added. Pretraining
   ``SSLGCN`` (float32, ``kernel_impl: xla``, as ``grl_tpu`` builds it) on
   five tasks: no K1, K2 or K3, D 30 times a step each way, the trunk and
   the used heads changed, the checkpoint written; prints steps/s, one SSL
   step's device ms (CUDA events over 5 steps) and the host seconds a page
   of the data chain, by processor. DGI with ``node_property``, 4 steps:
   the discriminator's bilinear changes, the checkpoint holds ``encoder.*``
   and ``discriminator.*``. ``FinetuneKVProcedure`` on the flagship
   (``kernel_impl: pallas``, bf16, DropEdge 0.3, dropout 0.5) from the
   pretraining's checkpoint: the parameter count loaded
   (``FINETUNE_LOADED``), the trunk equal to the checkpoint's bit for bit,
   K1 = K2 = 3 x steps and K3 = 3 x validation batches, the learning check
   and two steps kernel against plain under ``STEP_LIMITS`` from the
   loaded state; from the DGI checkpoint nothing loads, as in ``grl_tpu``.
   The fine-tuned checkpoint served through ``KVInference`` (K3) and held
   to the plain path under ``SERVE_AGREEMENT``. ``JointTrainingProcedure``
   (as many steps as the KV loader's batches) and
   ``GraphClassificationProcedure`` (a graph-label processor registered for
   the leg, 3 classes), finite losses and their D counts.
6. ``zoo``: the dense model zoo through ``GNNLearningWarper.train`` ->
   ``KVProcedure`` and ``.predict`` at the sumi width on the train phase's
   pages, float32 on the plain path as ``grl_tpu`` builds it, one epoch a
   leg (``ZOO_LEGS``: ``RobustGCN``, ``RPGraphCNNDropEdge``, ``ModGCN``,
   ``DeepRPGCN``, ``DeepRPRobustGCN``, ``GATV2`` with V2 and V1 layers,
   ``DGCNN``, each at its own default widths), each with its launch counts
   set to 0 just before it and read just after: no K1, K2 or K3, D at
   ``ZOO_DROPOUTS`` a step each way; finite losses, every parameter with a
   nonzero gradient moved, BatchNorm's running statistics moved and equal
   in the checkpoint, which ``KVInference`` serves on 8 pages with no
   launch; the learning check (20 steps on one batch at ``ZOO_LEARN_LR``
   under ``ZOO_LEARN_SHARE``); one step with D equal to it with D's plain
   version bit for bit under deterministic algorithms (loss, parameters,
   buffers, Adam state); one step's device ms by CUDA events, the peak
   memory allocated and a traced step's device time by op.
   ``DeepRPRobustGCN`` also at ``scan_steps: 4``: a replayed chunk equal
   to the same chunk run eagerly, BatchNorm buffers and Adam state
   included. Then ``python -m grl_torch.bayes_training`` as a subprocess
   on a copy of ``configs/synthetic_kv.yaml`` at one epoch.
7. ``full_graph``: the sparse large-graph path, ``GNNLearningWarper.train``
   -> ``FullGraphProcedure`` on ``configs/arxiv_full_graph.yaml`` as it is
   (169,343 nodes, 1,184,773 edges, widths 128/256/40, bfloat16, DropEdge
   0.3, dropout 0.5) with ``kernel_impl: pallas_csr``, sparse attention,
   no ELL ``kernel_plan`` knobs, and 20 steps for the file's 200, in the
   file's chunks of ``scan_steps: 10`` (the first eager, the second a
   replay of the captured chunk): K5
   (``grl_torch/csrc/csr_spmm.cu``) aggregates forward and backward, K4
   (``grl_torch/csrc/sparse_attention.cu``) attends, K4b
   (``grl_torch/csrc/sparse_attention_bwd.cu``, two walks) takes its
   backward, and D (``grl_torch/csrc/dropout.cu``) drops out in both
   directions. Checks the launch
   counts, the replays, finite losses and changed parameters; prints
   steps/s and edges/s, one train step timed on the card eagerly and
   replayed, the device idle share of a traced eager window and of a
   traced replay, the seconds of the warm-up chunk and of the capture, and
   peak memory; holds a replayed chunk to the same
   chunk run eagerly (deterministic algorithms), bit for bit; then a
   learning check (the config's 200 steps at lr 1e-3, replayed in chunks
   of 10, timed whole: steps/s with the warm-up and the capture inside)
   and two full-width steps through the kernels against
   two through their plain versions, float32 and bfloat16; at dropout 0.5,
   two with D against its plain version (the same bits) and a plain step
   followed by a kernel step against two plain steps; beside two runs of
   the plain versions and four runs with a fault planted in K5 or K4b (its
   sender walk reading each pair one edge off; its ``sum alpha dalpha``
   term dropped from the pairs the receiver walk writes, which only the
   score projections' gradients show), which must fail the limits
   (``FULL_GRAPH_PAIRS``).

8. ``ell``: ``GNNLearningWarper.train`` -> ``FullGraphProcedure`` on
   ``configs/arxiv_full_graph.yaml`` as written (``kernel_impl: ell``, its
   ``kernel_plan``: project-first tables, arithmetic widths of quantum 2,
   the degree reorder; no attention), 20 steps for the file's 200: K6
   (``grl_torch/csrc/ell.cu``) aggregates in all four directions. The same
   checks and measurements as ``full_graph`` (and the tables' planning
   seconds), with K6 with a wrong seed or rate planted as the faults.
9. ``tile``: ``GNNLearningWarper.train`` -> ``FullGraphProcedure`` on
   ``configs/arxiv_full_graph.yaml`` with ``kernel_impl: tile``,
   ``kernel_plan: {tile_size: 128, tile_dtype: bfloat16, plan_projected:
   true}`` (the LPA order, tile's default) and the SBM at 661 communities
   (bench.py's "clustered" structure), 20 steps for the file's 200: K7
   (``grl_torch/csrc/tile.cu``) on the 3198 tiles, which must cover
   810,156 edges, and K6 on the 364,975 residual edges, in all four
   directions. The same checks and measurements as ``ell`` (and the
   planning seconds of the LPA order, the tile tables and the residual),
   with K7 under a wrong relation mix and K7's backward with its mask keyed
   on swapped endpoints planted as the faults.
10. ``tile_variants``: the ``tile`` phase's config with ``tile_dtype`` left
   out of the kernel plan (float32 tiles, the default), in two legs: the
   config's bfloat16 compute (K7 on its ``persistent_f32tiles`` route) and
   ``compute_dtype: float32`` (``persistent_tf32``, 3xTF32). Each leg is
   the ``tile`` phase's run with its checks and measurements (the launch
   counts by direction and by route, all on the leg's route and equal to
   the ``tile`` phase's by direction; a replayed chunk equal to the same
   chunk run eagerly; the replayed step's ms), and ``TILE_PAIRS`` in the
   leg's dtype.
11. ``sampled``: the sampled path, ``GNNLearningWarper.train`` ->
   ``SampledGraphProcedure`` on ``configs/arxiv_full_graph.yaml``'s graph
   with ``bench.py``'s sampled overrides (fanouts 10x10, chunks of
   ``scan_steps: 20``, Adam at lr 1e-3, the flagship at the arxiv widths
   without attention, bf16, ``kernel_impl: xla``; dropout 0.5, DropEdge
   0.3), each leg with its launch counts set to 0 just before it and read
   just after: D (``grl_torch/csrc/dropout.cu``) 5 times a step each way
   and no other kernel, the replays, finite losses and moved parameters.
   ``tree B=256``: one whole epoch (397 steps: a warm-up chunk, 18 replays,
   17 leftover steps) and its validation, the learning check
   (``SAMPLED_LEARN_ACC``), a replayed chunk equal to its eager run and two
   steps with D equal to two with plain D (deterministic algorithms), new
   DropEdge and D masks at each replay. ``tree B=512`` (3 chunks) and ``coo
   B=256`` (the COO route, 2 chunks; the two routes' eval forwards held to
   ``SERVE_AGREEMENT``). Each prints ``sampled_target_nodes_per_s`` with
   its split a step (``host_sample_ms``, ``h2d_ms``,
   ``device_dispatch_ms``), one step's device ms eager and replayed, the
   idle share of a traced replay, a traced step's device time by op and the
   tree einsums' share, the warm-up and capture seconds and peak memory.
   Then the sparse KV path: the ``train`` phase's pages and recipe with
   ``SparseBucketPadding`` (quantum 64, edge quantum 256) and ``kernel_impl:
   xla``, one epoch each with dense and with sparse attention and with dense
   at ``scan_steps: 4`` (a replayed COO chunk equal to its eager run): D
   counts and no K1/K2/K3, finite losses, moved parameters, the
   checkpoint, steps/s and one step's device ms.
12. ``demo``: the entry points as subprocesses from a scratch working
   directory: ``python -m grl_torch.demo_training`` on
   ``configs/arxiv_full_graph.yaml`` for 20 epochs and on
   ``configs/synthetic_kv.yaml`` for one, then ``python -m
   grl_torch.demo_inference`` on ``configs/synthetic_kv_infer.yaml`` with
   that checkpoint and a synthetic page: exit codes, the printed lines and
   the annotated boxes.
13. ``gather_probe``: ``grl_torch.probes.gather`` at full size, the
   counterpart of ``scripts/probe_gather.py``: index_select rates (A-D) and
   the four Pallas probes as CUDA kernels (``grl_torch/csrc/
   gather_probe.cu``), each held against its plain version (E1, E2, F
   exactly, G within 1e-5 at both grids); M rows/s and GB/s beside the HBM
   peak (G also by device time, with its cluster, warps and rows in
   flight), and the measured gather floors of K5, K6 (A rate) and K4 (C
   rate).
14. ``parallel``: the multi-device slice. A world of two ranks started
   through the ``GRL_*`` launch contract (this script with
   ``--parallel-rank``): on one card both ranks share it over gloo (P2P,
   all_gather and reduce_scatter staged through pinned host buffers), with
   two cards or more NCCL runs one rank a card. Each rank runs, in turn,
   ``dp`` (``KVProcedure`` at sumi width, bf16, DropEdge 0.3, dropout 0.5,
   ``{data: 2}``, global batch 8: one epoch stepwise and one at
   ``scan_steps: 4``; replicated parameters equal bit for bit after every
   step, K1 = K2 = 3 x steps and K3 = 3 x validation batches on each rank;
   two float32 rates-0 steps of the world against one process on the
   whole batches under ``STEP_LIMITS``), ``tp`` (``{data: 1, model: 2}``:
   the sharded serving forward against the unsharded one under
   ``SERVE_AGREEMENT`` in both dtypes, one float32 step under
   ``STEP_LIMITS``), ``partitioned`` (the arxiv config node-partitioned
   over two ranks, the ring halo exchange, bf16, 20 steps and 2 evals at
   ``scan_steps: 10``, D's launches, one float32 rates-0 step against the
   single-device port under ``FULL_GRAPH_STEP_LIMITS``, the learning check
   at lr 1e-3 over ``PARALLEL_LEARN_STEPS``) and ``sampled`` (the tree route at B = 256,
   groups 2, cut to 3 chunks, a float32 rates-0 step against one
   process) and ``ssl`` (the ssl phase's sumi-width ``SSLGCN``, float32,
   on the first 32 training pages: SSL pretraining with dgi, joint
   training and graph classification at ``{data: 2}``, SSL pretraining
   without dgi at ``{model: 2}``; one epoch each through the warper at
   dropout 0.5, D's launches a rank checked, the replicas equal bit for
   bit after every step; two float32 steps at dropout 0 (Adam eps 1e-3) of the world
   against one process under ``STEP_LIMITS``); each prints its backend,
   transport and world, each rank's step ms by CUDA events, its
   collectives' calls, MB and ms a step (the ssl leg's denominator
   all_reduce on a line of its own), the plan's ``Ec`` and padding share
   and its rate. Then ``nccl`` in this
   process: a one-rank NCCL group, the DP step with its gradient
   all_reduce and a ring of one, each eager and as a captured chunk, equal
   bit for bit.

The ``kernel`` phase also holds K5 (forward and backward, on the arxiv
graph at F = 256 and 512, and a small L = 3 graph), K4 and K4b (on the
arxiv graph at K = 16, F = 128, and a small graph with a hub and isolated
receivers; K4b against ``attend_backward`` and each of its walks against
its plain version, two launches equal to the bit, and on the arxiv graph
its rings of 2, 4 and 8 rows, equal to the bit, and groups of 8, 16 and 32
lanes, within SPARSE_TOL, timed), D (at the step's
dropout shapes, forward and backward, equal to its plain version bit for
bit, keep share within binomial bounds, beside
``torch.nn.functional.dropout``) and K6 (all four directions on the arxiv graph planned with
the config's ``kernel_plan`` at F = 256 and 512, and a small L = 3 graph
with geometric widths) against their plain versions, reads K5's keep set
back exactly with V = I, and holds K6 against K5 on one seed: within one
bf16 rounding on the arxiv graph, the keep sets equal with V = I. K5 and
K6 walk their gathered operand in column slices sized for the card's L2
(``grl_torch.ops.sparse.gather_slices``); their rows hold the plan
(``slices``, ``slice_cols``, ``l2_bytes``), ``device_ms``, and the same
kernel forced to one slice (``one_slice_ms``, ``one_slice_device_ms``),
whose output must equal the planned one bit for bit; K6 must equal its
plain version bit for bit wherever every bucket is at most 32 wide. K4
walks h in such slices too, with all of g counted beside each
(``sparse_attention.attention_launch``): its arxiv rows hold the same keys,
its layout (``group``, ``blocks``) and its in-L2 floor
(``in_l2_device_ms``: h and g folded onto rows that fit the L2,
:func:`fold`), and two launches, one slice and two must give the planned
bits. K7 runs all four directions on the clustered arxiv plan of the
``tile`` phase (F = 256 and 512, bf16 and f32 operands on bf16 and on
float32 tiles; within SPARSE_TOL of its plain version, two launches equal
to the bit; its rows hold the route and launch plan ``tile.launch_plan``
picks (``persistent``, ``persistent_f32tiles`` or ``persistent_tf32``:
``BN``, ``chunks``, ``consumers``, ``stages``, ``smem``, ``ctas``), the
time at rate 0 (``rate0_ms``, no cell hashed), ``torch.bmm`` on the
masked, gathered stacks as ``library_ms``, the simple route's kernel on
the same operands at rate 0.3 and 0 (``simple_ms``, ``simple_rate0_ms``),
and, in bf16 at F =
256, K6 over every edge of the same graph planned as the arxiv config's
ELL and over the tile plan's residual alone, with the break-even edges a
tile they give) and on a small L = 3 graph with f32 and bf16 tiles (B =
64: one consumer warpgroup, the last block ragged; the keep set with V = I
equal to the pair hash's, the same in the transposed tables, and <g, K7 V>
= <K7' g, V>).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. A fuller record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: HBM3
# bandwidth, bf16 tensor-core rate, float32 rate outside the tensor cores,
# and float32 products in 3xTF32 on the tensor cores (three TF32 products,
# at 495 TFLOP/s, for each float32 one), as the float32 K1/K3 run them, or
# in 2xTF32 where one factor is exact in TF32 (K7's bf16 tiles under
# float32 operands: two TF32 products for each float32 one).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "3xTF32": 495e12 / 3, "2xTF32": 495e12 / 2}

B, L = 8, 6
KERNEL_NS = (64, 192, 256)
KERNEL_FS = (256, 512)
# A node count TMA cannot read (230 % 8 != 0): bf16 K3 takes the ragged
# route (relagg_ragged.cu) there. Every synthetic page has 230 boxes, so it
# is also the batches' N when they are padded at quantum 2. At an odd N the
# ragged route copies A 2 bytes at a time.
RAGGED_N = 230
ODD_N = 231
# Widths bf16 K1/K2 are also held at, untimed: a single 64-wide tile, and
# F = N*L (BN 256 over six column tiles, K2 unsplit).
BF16_CHECK_FS = (64, 1536)
# Nonzero share of the heuristic graph's (N, 6, N) adjacency on the
# synthetic 230-box pages the serve phase sends (about 0.5 neighbours per
# node and relation); one denser case per dtype exercises long sums.
SPARSE_DENSITY = 0.002
DENSE_DENSITY = 0.5
# f32: both sides accumulate in float32, in a different order (~1e-6).
# bf16: both accumulate in float32 and round once to bfloat16, so they
# differ by at most one bfloat16 rounding of the output (2**-7 relative).
# The absolute term covers sums that cancel to near zero.
RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
ATOL_OF_MAX = 1e-5

PAGES = 64
SERVE_REPEATS = 3
NUM_CLASSES = 26  # output_dim = 26 * 2 key types + 1 = 53
CHARSET_SIZE = 4365  # input_dim = 4365 + 4 bbox features = 4369
NET_SIZE = 256
# Agreement of the kernel path with the plain path on the same weights.
# float32: the two differ only in summation order inside K3 (~1e-6), so
# nearly every box keeps its class. bfloat16: K3 and torch.matmul round
# their bf16 outputs at different places in the sum's last bit, and the
# difference grows through three GraphConvs, the attention and the
# 1280-wide RanPAC head; a box whose two best logits are that close can
# swap class.
SERVE_AGREEMENT = {"float32": (0.999, 1e-4), "bfloat16": (0.99, 2e-2)}

# DropEdge rate of the flagship (edge_dropout_rate), and the tolerance on
# the kept share of a dense A's 1.57M nonzero entries at N=256 (27
# standard deviations of a binomial share: only a biased mask misses it).
RATE = 0.3
KEEP_SHARE_TOL = 0.01

TRAIN_PAGES, VAL_PAGES, EPOCHS = 64, 16, 2
TRAIN_STEPS, VAL_BATCHES = EPOCHS * TRAIN_PAGES // B, EPOCHS * VAL_PAGES // B
# The procedure traces these train steps (logging.profile): the last
# four of the second epoch; the idle share is read from that trace.
PROFILE_START, PROFILE_STEPS = TRAIN_STEPS - 4, 3
TIMED_STEPS = 10
# The dense run at scan_steps 4: the same recipe, each chunk of 4 same-shape
# steps one replay of a CUDA graph (the first chunk runs eagerly as the
# warm-up, the second is captured): 16 steps are 4 chunks, 3 of them
# replays. The profiler window (steps 12..15) is one replay.
SCAN_K = 4
SCAN_REPLAYS = TRAIN_STEPS // SCAN_K - 1
# Two buckets on one chunk runner: the scan batches (N = 256) and the same
# pages cut to N = 192, a graph each in the runner's one memory pool. The
# second capture fits in the blocks the first left free: it must add less
# than this share of what the first added (graphs with pools of their own
# would add about 192/256 of it).
SECOND_CAPTURE_SHARE = 0.5
NARROW_N = 192
# Keep shares of the replayed masks: within this many binomial standard
# deviations of 1 - rate.
KEEP_SHARE_SDS = 5
# Learning check: 20 steps of the kernel path on one batch; the mean loss
# of the last 5 must fall below this share of the first step's loss. The
# first H100 run reached 0.543 (4.09 -> 2.22, with dropout and DropEdge
# on); the bound leaves room for other cards and library versions, and a
# gradient that does not fit the batch (a K2 that disagrees with K1, say)
# stays near 1 or diverges.
LEARN_STEPS, LEARN_SHARE = 20, 0.75
# Kernel path against plain path: two Adam steps at STEP_LR. Limits per
# dtype and step on (relative loss difference; largest difference of the
# held parameter entries against the largest parameter magnitude; share of
# the parameter entries the plain path moved that the two leave further
# apart than STEP_LR / 10; number of held entries further apart than that;
# relative L2 difference of the clipped gradients).
# Held entries: those whose clipped gradient is at least HELD_GRAD in both
# paths at every step so far. Adam's first update of an entry is lr * g /
# (|g| + eps): where |g| >= 10 eps in both paths and the signs agree, both
# lie within lr / 11 of lr * sign(g), so two paths that differ in summation
# order only leave no held entry lr/10 apart, while a wrong mask turns the
# sign of many. An entry whose gradient is near eps takes the paths'
# last-bit differences into its update, up to 2 lr apart for a gradient
# that changes sign: those entries are held by the share alone.
# float32: K1/K2 and their plain versions differ in summation order only
# (~1e-6 relative): the held entries stay within 1e-4 of scale and none
# drifts lr/10; the share holds the rest. (On an H100 one entry of
# 1,474,152, gradients 3.0e-9 / 7.5e-9 in the two paths, ended step 2
# 0.635 lr apart, 2.5e-4 of scale; PERF.md.)
# bfloat16: an output of K1 or K2 may round the other way in its last bit
# (2**-8 relative). Adam moves an entry by about STEP_LR a step whatever
# its gradient's size, so one near-zero gradient that changes sign moves
# that entry by 2 * STEP_LR: the largest difference is not held, the
# share of such entries is. Step 1 starts both paths from one state, so
# its gradient holds K1 and K2 closely; step 2 starts from states that
# may already differ in such entries, and its limits are looser.
# tests/test_torch_training.py::test_step_limits and
# ::test_float32_step_limits run these limits on a small model on the CPU:
# last-bit flips (0.5% of K1's or 5% of K2's bf16 outputs, half of either's
# float32 outputs) pass, a mask from another seed or a rate of 0.25 for 0.3
# in either kernel fails, in both dtypes. The first H100 run found both
# paths equal to the bit in bfloat16: the heuristic graph's rows sum a
# handful of terms.
ADAM_EPS = 1e-8
HELD_GRAD = 10 * ADAM_EPS
# Parameter names of the attention's score projections, whose gradients
# only K4b's df and dg reach.
SCORE_PROJECTIONS = ("trunk.self_atten.f.", "trunk.self_atten.g.")
STEP_LR = 5e-3
STEP_LIMITS = {
    "float32": [(1e-4, 1e-4, 1e-4, 0, 1e-3)] * 2,
    "bfloat16": [(5e-3, math.inf, 1e-2, math.inf, 2e-2), (5e-2, math.inf, 0.1, math.inf, 0.1)],
}


# Parameter tensors GraphCNNDropEdge loads from an SSL checkpoint of the
# same widths (FinetuneKVProcedure): from an SSLGCN one the trunk's 17 and
# the classifier's 2; from a DGI one none, since every name there starts
# with encoder. or discriminator. (grl_tpu merges by top-level path too).
# tests/test_torch_ssl_procedures.py holds grl_tpu's counts to these.
FINETUNE_LOADED = {"SSLGCN": 19, "DGI": 0}


# The full_graph phase: configs/arxiv_full_graph.yaml with the overrides
# below, made in memory. kernel_plan holds ELL planner knobs that the CSR
# kernel does not take (grl_tpu raises TypeError on them too). The ell
# phase reads the file as written, with the same step count.
FULL_GRAPH_YAML = os.path.join(REPO, "configs", "arxiv_full_graph.yaml")
FULL_GRAPH_MODEL = {"kernel_impl": "pallas_csr", "use_attention": True, "attention_impl": "sparse"}
FULL_GRAPH_STEPS = 20
# Evals of a 20-step run with scan_steps 10: after the first chunk and at
# the end, which is also the crossing of 20 (full_graph_procedure.py:382-386).
FULL_GRAPH_EVALS = 2
FULL_GRAPH_TIMED_STEPS = 10
# Replays of the main path's graph (scan_steps steps each) timed after it.
FULL_GRAPH_TIMED_REPLAYS = 3
FULL_GRAPH_TRACED_STEPS = 3
# K5 at the arxiv graph's widths: gcn1/gcn2 aggregate 256-wide features,
# gcn3 the 512-wide concat. K4 at K = 128 / 8 = 16 and F = 128.
K5_FS = (256, 512)
K4_K, K4_F = 16, 128
# Tolerances of K4 and K5 against their plain versions, as (relative,
# share of the output's largest magnitude). float32: both sides sum in
# float32 in another order (up to 21 terms a row on the arxiv graph; K4's
# online softmax against a two-pass one), ~1e-7 relative. bfloat16: both
# accumulate in float32 and round once, one bf16 rounding apart.
SPARSE_TOL = {"float32": (0.0, 1e-5), "bfloat16": (1e-2, 1e-5)}
# K4b's ring depths (rows in flight a lane) and group widths swept on the
# arxiv graph.
RING_DEPTHS = (2, 4, 8)
GROUP_WIDTHS = (8, 16, 32)
# Kernel path against plain path over two full-graph Adam steps, dropout 0
# and DropEdge 0.3 (one hash mask on both paths; dropout 0.5 is held from
# one state, FULL_GRAPH_PAIRS): the limits of STEP_LIMITS'
# five measures, the two on held entries not limited; the gradient limit
# also holds the gradients of the attention's score projections alone
# (step_failures' ``scores``), which only K4b's df and dg reach. The held pair runs under
# torch.use_deterministic_algorithms, where two runs of the plain path agree
# to the bit (index_add_ otherwise sums in an order that changes from run to
# run, in the plain K5, K4 and K4b), so what is left is the kernels' own
# summation order. It starts from the weights
# the learning check reached: from the main path's initial weights (logits
# in the thousands, first loss ~2e3) two runs of the plain path outside
# deterministic mode break the limits in both dtypes, as kernel against
# plain does in either mode (the first H100 run of these pairs: f32 step 2
# moved share 2.3e-2, bf16 step 1 gradient 4e-2). float32: a near-zero
# full-batch gradient entry that changes sign is moved 2 lr apart by Adam,
# as far as a wrong mask moves any entry (both 2e-3 at lr 1e-3), so the
# largest difference is not held; the share of such entries is (1e-4, where
# the two planted faults reach 0.25-0.65). bfloat16: as STEP_LIMITS; the
# faults break the moved share (0.25-0.51).
FULL_GRAPH_STEP_LIMITS = {
    "float32": [(1e-4, math.inf, 1e-4, math.inf, 1e-3)] * 2,
    "bfloat16": STEP_LIMITS["bfloat16"],
}
# Learning check: the config's own 200 steps from the main path's initial
# weights and seeds, at lr 1e-3; the validation accuracy after them must
# pass FULL_GRAPH_LEARN_ACC (chance is 1/40). At the config's lr 0.01 the
# exploding initial logits (first loss ~2e3) drive every ReLU of the trunk
# dead within ~20 steps and the loss settles at ln 40, the prior: grl_tpu
# does the same on this config (both packages reach 0.035 after 200 steps
# at 3000 nodes on the CPU), while at lr 1e-3 the port reaches 0.65 there.
# 100 steps are too few on the full_graph phase's model with attention
# (0.18 on the H100, PERF.md).
FULL_GRAPH_LEARN_STEPS = 200
FULL_GRAPH_LEARN_LR = 1e-3
FULL_GRAPH_LEARN_ACC = 0.3


def step_failures(rows, limits, scores: bool = False):
    """The steps of ``compare_steps`` whose row exceeds its limits; with
    ``scores``, also where the gradients of the attention's score
    projections differ by more than the gradient limit."""
    keys = ("loss_rel_diff", "held_max_diff_of_scale", "moved_share_beyond_lr_10", "held_beyond_lr_10",
            "grad_rel_diff")
    return [k for k, (row, limit) in enumerate(zip(rows, limits))
            if any(row[key] > bound for key, bound in zip(keys, limit))
            or scores and row["score_grad_rel_diff"] > limit[4]]


def log(message: str) -> None:
    print(message, flush=True)


def require(condition: bool, message: str) -> None:
    if not condition:
        raise AssertionError(message)


# ---------------------------------------------------------------------------
# env
# ---------------------------------------------------------------------------
def phase_env(torch) -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, TF32 off"
    )
    from grl_torch.ops import _build

    start = time.perf_counter()
    paths = _build.build(_build.SOURCES)
    build_s = time.perf_counter() - start
    log(f"[env] built {sorted(paths)} for sm_90a in {build_s:.2f} s")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            # The sources of the K1/K2/K3, K4b and P kernels in full: each kernel's name, registers and spills.
            if name in ("dropedge_sm90", "relagg_ragged", "dropedge_f32", "sparse_attention_bwd", "tile", "gather_probe") \
                    or "registers" in line or "spill" in line or "smem" in line:
                log(f"[env] ptxas {name}: {line.strip()}")
    return card


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------
# Cycles the card spins (torch.cuda._sleep) between the flush and the start
# event under ``time_ms(cover=True)``, ~1 ms: long enough for the host to
# enqueue a call's launches behind it.
HOST_COVER_CYCLES = 2_000_000


def time_ms(torch, fn, flush, reps: int = 40, cover: bool = False) -> float:
    """Median time of one call between CUDA events, L2 flushed before each
    call. By default the start event follows the flush directly, so a call
    whose host side takes longer to enqueue its kernel than the flush takes
    to run is timed with that host gap inside (the ``ms`` of every kernel
    row). ``cover=True`` keeps the card busy after the flush until the call
    is enqueued, so the events hold the device's work alone (``device_ms``)."""
    for _ in range(3):
        fn()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(reps)
    ]
    for start, end in events:
        flush.zero_()
        if cover:
            torch.cuda._sleep(HOST_COVER_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def enqueue_ms(torch, fn, reps: int = 40) -> float:
    """Median host time of one call of ``fn`` (its Python wrapper, checks
    and launches), the card kept busy meanwhile so that no call waits on
    it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(10 * HOST_COVER_CYCLES)
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        times.append(time.perf_counter() - start)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def dense_timings(torch, kernel, plain, library, flush) -> dict:
    """The timings of a K3/K1/K2 row: kernel, plain version and library
    call as every kernel row is timed, and the kernel and library call's
    device time alone, and the kernel wrapper's host enqueue time."""
    return {
        "ms": time_ms(torch, kernel, flush), "plain_ms": time_ms(torch, plain, flush),
        "library_ms": time_ms(torch, library, flush), "device_ms": time_ms(torch, kernel, flush, cover=True),
        "library_device_ms": time_ms(torch, library, flush, cover=True), "enqueue_ms": enqueue_ms(torch, kernel),
    }


def bound(peak: str, itemsize: int, N: int, F: int):
    """(bound ms, what bounds it, bytes, flops) of one K3/K1/K2 call at
    B, L: each moves A, an (N, F) panel and an (N, L, F) panel per batch
    once, for 2*B*N*L*N*F operations at ``PEAK_FLOPS[peak]``."""
    nbytes = itemsize * (B * N * L * N + B * N * F + B * N * L * F)
    flops = 2 * B * N * L * N * F
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[peak] * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations"), nbytes, flops


def bounds(dtype_name: str, forward: bool, itemsize: int, N: int, F: int):
    """The bound keys of a K3/K1/K2 row. The float32 forward runs in
    3xTF32 on the tensor cores, so its bound is taken at that rate, with
    the bound at the float32 rate outside them beside it
    (``bound_fp32_ms``); the float32 K2 runs outside them."""
    tf32 = dtype_name == "float32" and forward
    bound_ms, bound_by, nbytes, flops = bound("3xTF32" if tf32 else dtype_name, itemsize, N, F)
    row = {"bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops}
    if tf32:
        row["bound_fp32_ms"] = bound("float32", itemsize, N, F)[0]
    return row


def check_close(torch, out, ref, dtype_name: str, what: str, tol=None) -> float:
    """Max abs error of ``out`` against ``ref``; fails past the tolerance
    ``tol = (relative, share of ref's largest magnitude)``, by default
    ``(RTOL[dtype], ATOL_OF_MAX)``."""
    require(out.shape == ref.shape and out.dtype == ref.dtype, f"{what}: {out.shape} {out.dtype}")
    require(bool(torch.isfinite(out).all()), f"{what}: output is not finite")
    rtol, share = tol or (RTOL[dtype_name], ATOL_OF_MAX)
    diff = (out.float() - ref.float()).abs()
    scale = ref.float().abs()
    limit = rtol * scale + share * float(scale.max())
    max_abs_err = float(diff.max())
    require(
        float((diff - limit).max()) <= 0.0,
        f"{what} disagrees with its plain version: max_abs_err={max_abs_err:.3e}",
    )
    return max_abs_err


def device_seed(seed: int):
    """``seed`` as the one-element int32 tensor on the card that K1, K2,
    K5 and K6 read their DropEdge seed from, as the train step's
    ``Rngs.kernel_seed`` gives it (a Python int would cost each timed
    call a copy to the card)."""
    from grl_torch.ops import hashing

    return hashing.seed_tensor(seed, "cuda")


def operands(torch, dtype_name: str, N: int, F: int, density: float, seed: int):
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    V = torch.randn(B, N, F, generator=gen, device="cuda").to(dtype)
    A = (torch.rand(B, N, L, N, generator=gen, device="cuda") < density).to(dtype)
    return V, A


def kernel_case(torch, dtype_name: str, N: int, F: int, density: float, flush, seed: int):
    from grl_torch.ops.relagg import neighbor_aggregate, neighbor_aggregate_reference

    V, A = operands(torch, dtype_name, N, F, density, seed)
    before = route_counts()["K3"]
    out = neighbor_aggregate(V, A)
    torch.cuda.synchronize()
    route = next(k for k, v in route_counts()["K3"].items() if v != before[k])
    what = f"K3 {dtype_name} N={N} F={F} density={density} ({route})"
    max_abs_err = check_close(torch, out, neighbor_aggregate_reference(V, A), dtype_name, what)

    A2 = A.view(B, N * L, N)
    timings = dense_timings(torch, lambda: neighbor_aggregate(V, A), lambda: neighbor_aggregate_reference(V, A),
                            lambda: torch.matmul(A2, V), flush)
    return {
        "kernel": "K3", "route": route, "dtype": dtype_name, "B": B, "N": N, "L": L, "F": F, "density": density,
        "max_abs_err": max_abs_err, **timings, **bounds(dtype_name, True, V.element_size(), N, F),
    }


def dropedge_cases(torch, dtype_name: str, N: int, F: int, density: float, flush, seed: int):
    """K1 and K2 against their plain versions, timed; two result rows."""
    from grl_torch.ops import relagg

    V, A = operands(torch, dtype_name, N, F, density, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 500)
    g = torch.randn(B, N, L, F, generator=gen, device="cuda").to(V.dtype)
    mask_seed = device_seed(7919 * (seed + 1))
    out = relagg.dropedge_aggregate(V, A, mask_seed, RATE)
    dV = relagg.dropedge_aggregate_grad(g, A, mask_seed, RATE)
    torch.cuda.synchronize()
    what = f"{dtype_name} N={N} F={F} density={density}"
    err = {
        "K1": check_close(torch, out, relagg.dropedge_aggregate_reference(V, A, mask_seed, RATE),
                          dtype_name, f"K1 {what}"),
        "K2": check_close(torch, dV, relagg.dropedge_aggregate_grad_reference(g, A, mask_seed, RATE),
                          dtype_name, f"K2 {what}"),
    }
    # library_ms: one torch.matmul on an A already masked and rescaled (no
    # single PyTorch call fuses the mask).
    keep = relagg.keep_probability(RATE)
    A_m = (torch.where(relagg.dropedge_keep_mask(mask_seed, A.shape, RATE, A.device), A.float(), 0.0)
           / keep).to(V.dtype).view(B, N * L, N)
    g2 = g.view(B, N * L, F)
    calls = {
        "K1": (lambda: relagg.dropedge_aggregate(V, A, mask_seed, RATE),
               lambda: relagg.dropedge_aggregate_reference(V, A, mask_seed, RATE),
               lambda: torch.matmul(A_m, V)),
        "K2": (lambda: relagg.dropedge_aggregate_grad(g, A, mask_seed, RATE),
               lambda: relagg.dropedge_aggregate_grad_reference(g, A, mask_seed, RATE),
               lambda: torch.matmul(A_m.transpose(1, 2), g2)),
    }
    rows = []
    for name, (kernel, plain, library) in calls.items():
        rows.append({
            "kernel": name, "dtype": dtype_name, "B": B, "N": N, "L": L, "F": F, "density": density,
            "rate": RATE, "max_abs_err": err[name], **dense_timings(torch, kernel, plain, library, flush),
            **bounds(dtype_name, name == "K1", V.element_size(), N, F),
        })
    return rows


def mask_probe(torch, dtype_name: str, N: int, seed: int):
    """The mask K1 and K2 draw, read out exactly: with V = I, K1 returns
    A * mask / keep; with g = I over the N*L rows, K2 returns its
    transpose. Both must equal the plain hash mask on A's support.
    Returns the kept share of A's nonzero entries."""
    from grl_torch.ops import relagg

    dtype = getattr(torch, dtype_name)
    _, A = operands(torch, dtype_name, N, 8, DENSE_DENSITY, seed)
    expected = (A != 0) & relagg.dropedge_keep_mask(seed, A.shape, RATE, A.device)
    eye = torch.eye(N, device="cuda", dtype=dtype).expand(B, N, N).contiguous()
    seen_k1 = relagg.dropedge_aggregate(eye, A, device_seed(seed), RATE) != 0  # (B, N, L, N)
    g = torch.eye(N * L, device="cuda", dtype=dtype).expand(B, N * L, N * L).reshape(B, N, L, N * L)
    dV = relagg.dropedge_aggregate_grad(g.contiguous(), A, device_seed(seed), RATE)  # (B, N, N*L)
    seen_k2 = dV.view(B, N, N, L).permute(0, 2, 3, 1) != 0  # (B, n, l, m)
    torch.cuda.synchronize()
    require(torch.equal(seen_k1, expected), f"K1's mask differs from the plain hash ({dtype_name}, N={N})")
    require(torch.equal(seen_k2, expected), f"K2's mask differs from the plain hash ({dtype_name}, N={N})")
    return float(expected.sum()) / float((A != 0).sum())


def dropedge_invariants(torch):
    """Forward and backward see one mask; K1 at keep 1 is K3 bit for bit
    (float32: dropedge_f32.cu's forward with the mask on and off; bfloat16:
    dropedge_sm90.cu's); the wrapper at rate 0 launches K3; the ragged K3
    at N = 256 is the sm90 route bit for bit (V through TMA, and V copied);
    two launches of bf16 K1, K2 and ragged K3 and of f32 K1, K2 and K3 give
    equal bits."""
    from grl_torch.ops import relagg

    V, A = operands(torch, "float32", 256, 256, DENSE_DENSITY, 77)
    y = relagg.dropedge_aggregate(V, A, 5, RATE)
    dV = relagg.dropedge_aggregate_grad(torch.ones_like(y), A, 5, RATE)
    lhs, rhs = float((dV.double() * V.double()).sum()), float(y.double().sum())
    # Linear in V, so equal in real arithmetic. The float32 roundings of
    # the 3.1M outputs and 0.5M gradient entries have random signs: 9e-8 of
    # the sum on the H100. A K2 mask other than K1's moves it by more than
    # a tenth of the sum (tests/test_torch_dropedge.py).
    require(abs(lhs - rhs) <= 1e-5 * abs(rhs), f"<K2(1), V> = {lhs} but sum K1(V) = {rhs}")
    out = relagg._launch_f32_forward(A, V, 5, 1.0, mask=True)
    k3 = counts()["K3"]
    plain = relagg.dropedge_aggregate(V, A, 5, 0.0)
    torch.cuda.synchronize()
    require(counts()["K3"] == k3 + 1, "rate 0 did not launch K3")
    require(torch.equal(out, plain), "K1 at keep 1 differs from K3")
    # bf16: K3 at N % 8 == 0 is dropedge_sm90.cu's K1 with the mask compiled
    # out; at keep 1 K1 drops nothing and scales by exactly 1.
    V, A = operands(torch, "bfloat16", 256, 256, DENSE_DENSITY, 78)
    keep_one = relagg._launch_sm90(False, A, V, 5, 1.0)
    k3 = relagg.neighbor_aggregate(V, A)
    keep_one_err = float((keep_one.float() - k3.float()).abs().max())
    require(torch.equal(keep_one, k3), f"bf16 K1 at keep 1 differs from K3 (max abs err {keep_one_err:.3e})")
    # The ragged route stages the boxes TMA would and sums them with the
    # same consumer; a V 4 bytes past a 16-byte boundary is copied, not
    # read through TMA.
    shifted = torch.empty(V.numel() + 2, dtype=V.dtype, device="cuda")[2:].view(V.shape)
    shifted.copy_(V)
    ragged_err = {}
    for name, operand in (("V through TMA", V), ("V copied", shifted)):
        ragged = relagg._launch_ragged(A, operand)
        ragged_err[name] = float((ragged.float() - k3.float()).abs().max())
        require(torch.equal(ragged, k3), f"ragged K3 at N=256 ({name}) differs from the sm90 route "
                                         f"(max abs err {ragged_err[name]:.3e})")
    g = torch.randn(B, 256, L, 256, generator=torch.Generator(device="cuda").manual_seed(79),
                    device="cuda").to(torch.bfloat16)
    g32, A32, V32 = g.float(), A.float(), V.float()
    V230, A230 = operands(torch, "bfloat16", RAGGED_N, 256, DENSE_DENSITY, 80)
    for name, run in (("bf16 K1", lambda: relagg.dropedge_aggregate(V, A, 6, RATE)),
                      ("bf16 K2", lambda: relagg.dropedge_aggregate_grad(g, A, 6, RATE)),
                      ("bf16 K3 (ragged)", lambda: relagg.neighbor_aggregate(V230, A230)),
                      ("f32 K1", lambda: relagg.dropedge_aggregate(V32, A32, 6, RATE)),
                      ("f32 K2", lambda: relagg.dropedge_aggregate_grad(g32, A32, 6, RATE)),
                      ("f32 K3", lambda: relagg.neighbor_aggregate(V32, A32))):
        require(torch.equal(run(), run()), f"two launches of {name} differ")
    return {"k2_dot_v": lhs, "sum_k1": rhs, "bf16_k1_keep1_vs_k3_max_abs_err": keep_one_err,
            "ragged_vs_sm90_max_abs_err": ragged_err}


def bf16_dropedge_checks(torch):
    """bf16 K1/K2 at F = 64 and F = N*L, untimed, against their plain
    versions; how many clusters of each K2 plan of the kernel phase the
    card holds at once, bf16 and f32; and the f32 K2's capacity by S."""
    from grl_torch.ops import relagg

    checks = []
    for N in KERNEL_NS:
        for F in BF16_CHECK_FS:
            V, A = operands(torch, "bfloat16", N, F, SPARSE_DENSITY * 10, N + F)
            g = torch.randn(B, N, L, F, device="cuda").to(torch.bfloat16)
            out = relagg.dropedge_aggregate(V, A, 13, RATE)
            dV = relagg.dropedge_aggregate_grad(g, A, 13, RATE)
            torch.cuda.synchronize()
            what = f"bfloat16 N={N} F={F}"
            checks.append({
                "N": N, "F": F,
                "K1_max_abs_err": check_close(torch, out, relagg.dropedge_aggregate_reference(V, A, 13, RATE),
                                              "bfloat16", f"K1 {what}"),
                "K2_max_abs_err": check_close(torch, dV, relagg.dropedge_aggregate_grad_reference(g, A, 13, RATE),
                                              "bfloat16", f"K2 {what}"),
            })
    clusters = {}
    for N in KERNEL_NS:
        for F in KERNEL_FS + BF16_CHECK_FS:
            plan = relagg.dropedge_plan(B, N, L, F)
            blocks = math.prod(plan.backward_grid)
            clusters[f"bfloat16 N={N} F={F}"] = held = {
                "BN": plan.BN, "S": plan.splits, "blocks": blocks,
                "max_active_clusters": relagg.sm90_max_clusters(plan)}
            require(held["max_active_clusters"] > 0, f"the card holds no K2 cluster of {plan.splits} at {held}")
    capacity = relagg.f32_capacity(0)
    for N in KERNEL_NS + (RAGGED_N,):
        for F in KERNEL_FS:
            plan = relagg.dropedge_f32_plan(B, N, L, F, capacity)
            clusters[f"float32 N={N} F={F}"] = held = {
                "BN": 128, "S": plan.splits, "blocks": math.prod(plan.grid),
                "max_active_clusters": capacity[plan.splits - 1] // plan.splits}
            require(held["max_active_clusters"] > 0, f"the card holds no f32 K2 cluster of {plan.splits} at {held}")
    return checks, clusters, capacity


def k2_split_sweep(torch, flush):
    """bf16 and f32 K2 at the main shape (N=256, F = 256 and 512) under
    every split S each kernel takes (divisors of its row steps, 24 of 64
    rows or 48 of 32, at most 8), against the plain version, device time
    alone: what each planner's rule costs against the other splits."""
    import dataclasses

    from grl_torch.ops import relagg

    rows = []
    keep = relagg.keep_probability(RATE)
    for dtype_name in ("bfloat16", "float32"):
        for F in KERNEL_FS:
            V, A = operands(torch, dtype_name, 256, F, SPARSE_DENSITY, 300 + F)
            g = torch.randn(B, 256, L, F, generator=torch.Generator(device="cuda").manual_seed(F),
                            device="cuda").to(V.dtype)
            ref = relagg.dropedge_aggregate_grad_reference(g, A, 17, RATE)
            if dtype_name == "bfloat16":
                planned, launch = relagg.dropedge_plan(B, 256, L, F), functools.partial(relagg._launch_sm90, True)
            else:
                planned = relagg.dropedge_f32_plan(B, 256, L, F, relagg.f32_capacity(0))
                launch = relagg._launch_f32_grad
            for S in (s for s in range(1, 9) if planned.steps % s == 0):
                plan = dataclasses.replace(planned, splits=S)
                run = functools.partial(launch, A, g, device_seed(17), keep, plan)
                err = check_close(torch, run(), ref, dtype_name, f"{dtype_name} K2 F={F} S={S}")
                grid = plan.backward_grid if dtype_name == "bfloat16" else plan.grid
                rows.append({"dtype": dtype_name, "F": F, "S": S, "planned": S == planned.splits,
                             "blocks": math.prod(grid), "max_abs_err": err,
                             "device_ms": time_ms(torch, run, flush, cover=True)})
    return rows


# ---------------------------------------------------------------------------
# kernel: K5 and K4 on the full-graph slice's graph
# ---------------------------------------------------------------------------
def full_graph_config(tmp: str):
    """configs/arxiv_full_graph.yaml with the slice's overrides, in memory."""
    from grl_torch.config import load_config

    config = load_config(FULL_GRAPH_YAML)
    config["model"]["args"].update(FULL_GRAPH_MODEL)
    config["kernel_plan"] = {}
    config["num_epochs"] = FULL_GRAPH_STEPS
    config["output_dir"] = os.path.join(tmp, "out")
    return config


@functools.lru_cache(maxsize=None)
def arxiv_graph():
    """The slice's SBM graph (numpy), built as FullGraphProcedure builds it."""
    from grl_torch.trainer.procedures.full_graph_procedure import large_graph_from_config

    return large_graph_from_config(full_graph_config(tempfile.mkdtemp(prefix="grl_torch_graph_")))


def sparse_bound(dtype_name: str, nbytes: int, flops: int):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


def csr_library_ms(torch, layout, X, seed, flush):
    """One torch.sparse.mm of the layout's matrix, masked and scaled
    beforehand, with X: the PyTorch call for K5's product (never called by
    the port)."""
    from grl_torch.ops import csr_spmm

    values = csr_spmm.edge_coefficients(layout, seed, RATE).to(X.dtype)
    A = torch.sparse_csr_tensor(layout.rowptr.long(), layout.cols.long(), values,
                                size=(layout.num_rows, X.shape[0]))
    return time_ms(torch, lambda: torch.sparse.mm(A, X), flush)


def slice_fields(torch, module, X, layout, seed, out, flush, what: str) -> dict:
    """The column-slice plan of K5 or K6 (``module``: csr_spmm or ell) for
    X on this card, and the same kernel forced to one slice: its output
    must be ``out`` bit for bit, and its times show what slicing buys."""
    from grl_torch.ops import sparse

    l2 = sparse.l2_bytes(X.device.index)
    plan = sparse.gather_slices(layout.num_src_rows, X.shape[-1], X.element_size(), l2)
    one = [(0, X.shape[-1])]
    single = module._launch(X, layout, seed, RATE, plan=one)
    torch.cuda.synchronize()
    require(torch.equal(single, out), f"{what}: one slice and {len(plan)} slices give other bits")
    return {
        "slices": len(plan), "slice_cols": plan[0][1], "l2_bytes": l2,
        "one_slice_ms": time_ms(torch, lambda: module._launch(X, layout, seed, RATE, plan=one), flush),
        "one_slice_device_ms": time_ms(torch, lambda: module._launch(X, layout, seed, RATE, plan=one), flush,
                                       cover=True),
    }


def slicing_note(row) -> str:
    """The device time and slice plan of a K5/K6 row, for its log line."""
    if "slices" not in row:
        return ""
    group = f", groups of {row['group']} lanes" if "group" in row else ""
    in_l2 = f"; every gather in L2 {row['in_l2_device_ms']:.4f} ms" if "in_l2_device_ms" in row else ""
    return (f" (device {row['device_ms']:.4f} ms; {row['slices']} slices of {row['slice_cols']} columns for "
            f"an L2 of {row['l2_bytes']} bytes{group}; one slice {row['one_slice_ms']:.4f} ms, device "
            f"{row['one_slice_device_ms']:.4f} ms{in_l2})")


def k5_case(torch, layout, dtype_name: str, F: int, flush, seed: int, what: str):
    """K5 on one layout against its plain version, timed; one result row."""
    from grl_torch.ops import csr_spmm

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(layout.num_src_rows, F, generator=gen, device="cuda").to(dtype)
    mask_seed = device_seed(104729 * (seed + 1))
    out = csr_spmm.csr_accumulate(X, layout, mask_seed, RATE)
    ref = csr_spmm.csr_accumulate_reference(X, layout, mask_seed, RATE)
    torch.cuda.synchronize()
    err = check_close(torch, out, ref, dtype_name, f"K5 {what} {dtype_name} F={F}", SPARSE_TOL[dtype_name])
    slicing = slice_fields(torch, csr_spmm, X, layout, mask_seed, out, flush, f"K5 {what} {dtype_name} F={F}")
    kept = int((csr_spmm.edge_coefficients(layout, mask_seed, RATE) != 0).sum())
    nnz = int(layout.cols.numel())
    itemsize = X.element_size()
    # V (or g) read once, out written once, 12 bytes of edge metadata and
    # the row pointers read once; 2 FLOPs per kept edge and feature.
    nbytes = itemsize * (layout.num_src_rows + layout.num_rows) * F + 12 * nnz + 4 * (layout.num_rows + 1)
    flops = 2 * kept * F
    bound_ms, bound_by = sparse_bound(dtype_name, nbytes, flops)
    library_ms = csr_library_ms(torch, layout, X, mask_seed, flush)
    return {
        "kernel": f"K5 {what}", "dtype": dtype_name, "rows": layout.num_rows,
        "src_rows": layout.num_src_rows, "edges": nnz, "kept_edges": kept, "F": F, "rate": RATE,
        "max_abs_err": err, "differ_share": float((out != ref).float().mean()),
        "ms": time_ms(torch, lambda: csr_spmm.csr_accumulate(X, layout, mask_seed, RATE), flush),
        "device_ms": time_ms(torch, lambda: csr_spmm.csr_accumulate(X, layout, mask_seed, RATE), flush, cover=True),
        **slicing,
        "plain_ms": time_ms(torch, lambda: csr_spmm.csr_accumulate_reference(X, layout, mask_seed, RATE), flush),
        "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        # Every kept edge gathers one row of X from device memory when X
        # does not stay in the 50 MB L2: the realistic floor.
        "gather_floor_ms": (kept * F * itemsize + nbytes) / HBM_BYTES_PER_S * 1e3,
    }


def k5_mask_probe(torch, dtype_name: str):
    """K5's keep set read back exactly: with V = I each forward output row
    shows the edges kept into it, and with g = I over the N*L rows the
    transposed walk shows the same set. Unique edges, N = 64, L = 3."""
    import numpy as np

    from grl_torch.ops import csr_spmm, hashing

    N, L, E, seed = 64, 3, 3000, 2024
    rng = np.random.RandomState(5)
    cells = rng.choice(N * L * N, E, replace=False)
    receivers, rest = np.divmod(cells, L * N)
    relations, senders = np.divmod(rest, N)
    kernel = csr_spmm.CSRGraphKernel(senders, receivers, relations, np.ones(E, np.float32), N, L,
                                     device="cuda")
    dtype = getattr(torch, dtype_name)
    kept = hashing.keep_bits(torch.arange(E), seed, RATE).numpy()
    expected = np.zeros((N, L, N), bool)
    expected[receivers[kept], relations[kept], senders[kept]] = True
    fwd = csr_spmm.csr_accumulate(torch.eye(N, device="cuda", dtype=dtype), kernel.forward_layout,
                                  device_seed(seed), RATE)
    bwd = csr_spmm.csr_accumulate(torch.eye(N * L, device="cuda", dtype=dtype), kernel.backward_layout,
                                  device_seed(seed), RATE)
    torch.cuda.synchronize()
    seen_fwd = (fwd != 0).view(N, L, N).cpu().numpy()
    seen_bwd = (bwd != 0).view(N, N, L).permute(1, 2, 0).cpu().numpy()
    require(np.array_equal(seen_fwd, expected), f"K5 forward keep set differs from the plain hash ({dtype_name})")
    require(np.array_equal(seen_bwd, expected), f"K5 backward keep set differs from the plain hash ({dtype_name})")
    return float(kept.mean())


def fold(torch, plan, g, h, l2_bytes: int):
    """``(plan, g, h)`` of K4 with every sender taken modulo the rows whose
    g and h bytes fill half of the L2, and g and h cut to those rows: the
    same walk, whose every gather can hit L2 (K4's in-L2 floor, also timed
    by ``grl_torch/probes/attention.py``)."""
    row_bytes = (g.shape[-1] + h.shape[-1]) * h.element_size()
    rows = min(h.shape[0], int(l2_bytes / 2 // row_bytes))
    folded = plan._replace(senders=torch.remainder(plan.senders, rows).to(torch.int32))
    return folded, g[:rows].contiguous(), h[:rows].contiguous()


def k4_case(torch, kernel, dtype_name: str, flush, seed: int, what: str, timed: bool):
    """K4 against its plain version, with the same plan forced to one slice
    and to two (whose outputs must equal the planned one bit for bit);
    timed (on the arxiv graph) with its layout, its device time, the time
    forced to one slice and its in-L2 floor (:func:`fold`)."""
    from grl_torch.ops import sparse, sparse_attention

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    N = kernel.num_nodes
    f, g, h = (torch.randn(N, d, generator=gen, device="cuda").to(dtype) for d in (K4_K, K4_K, K4_F))
    out = sparse_attention.attend_forward(f, g, h, kernel.plan)
    again = sparse_attention.attend_forward(f, g, h, kernel.plan)
    ref = sparse_attention.attend_reference(f, g, h, kernel.plan)
    torch.cuda.synchronize()
    err = check_close(torch, out, ref, dtype_name, f"K4 {what} {dtype_name}", SPARSE_TOL[dtype_name])
    require(torch.equal(out, again), f"K4 {what} {dtype_name}: two launches give other bits")
    isolated = kernel.plan.rowptr[1:] == kernel.plan.rowptr[:-1]
    require(bool((out[isolated] == 0).all()), f"K4 {what}: a receiver with no edge got a nonzero row")
    E = kernel.num_edges
    degrees = (kernel.plan.rowptr[1:] - kernel.plan.rowptr[:-1]).max()
    itemsize = h.element_size()
    l2 = sparse.l2_bytes(0)
    planned = sparse_attention.attention_launch(N, K4_K, K4_F, itemsize, l2, sparse.sm_count(0))
    one = planned._replace(slices=[(0, K4_F)])
    half = K4_F // 2
    for forced in (one, planned._replace(slices=[(0, half), (half, K4_F - half)])):
        sliced = sparse_attention._launch(f, g, h, kernel.plan, forced)
        torch.cuda.synchronize()
        require(torch.equal(sliced, out), f"K4 {what} {dtype_name}: {len(forced.slices)} slices and "
                f"{len(planned.slices)} give other bits")
    row = {"kernel": f"K4 {what}", "dtype": dtype_name, "N": N, "edges": E, "K": K4_K, "F": K4_F,
           "max_degree": int(degrees), "isolated": int(isolated.sum()), "max_abs_err": err,
           "differ_share": float((out != ref).float().mean()), "group": planned.group,
           "blocks": planned.blocks, "slices": len(planned.slices), "slice_cols": planned.slices[0][1],
           "l2_bytes": l2}
    if not timed:
        return row
    # f, g, h read once, out written once, the CSR read once; per edge a
    # K-wide dot, an exp and an F-wide scaled add.
    nbytes = itemsize * (2 * N * K4_K + 2 * N * K4_F) + 4 * (N + 1) + 4 * E
    flops = E * (2 * K4_K + 2 * K4_F)
    bound_ms, bound_by = sparse_bound(dtype_name, nbytes, flops)
    folded, g_in, h_in = fold(torch, kernel.plan, g, h, l2)
    row.update({
        "ms": time_ms(torch, lambda: sparse_attention.attend_forward(f, g, h, kernel.plan), flush),
        "device_ms": time_ms(torch, lambda: sparse_attention.attend_forward(f, g, h, kernel.plan), flush, cover=True),
        "one_slice_ms": time_ms(torch, lambda: sparse_attention._launch(f, g, h, kernel.plan, one), flush),
        "one_slice_device_ms": time_ms(torch, lambda: sparse_attention._launch(f, g, h, kernel.plan, one), flush,
                                       cover=True),
        "in_l2_device_ms": time_ms(torch, lambda: sparse_attention._launch(f, g_in, h_in, folded, planned), flush,
                                   cover=True),
        "plain_ms": time_ms(torch, lambda: sparse_attention.attend_reference(f, g, h, kernel.plan), flush),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "gather_floor_ms": (E * (K4_K + K4_F) * itemsize + nbytes) / HBM_BYTES_PER_S * 1e3,
    })
    return row


def k4b_case(torch, kernel, dtype_name: str, flush, seed: int, what: str, timed: bool):
    """K4b against ``attend_backward`` (the plain segment form) through
    ``attend_grad``, two launches equal to the bit, and each walk against
    its plain version on the same inputs (the sender walk on the kernel's
    own pairs); zero rows where a node has no edge. Timed (on the arxiv
    graph): a row a walk, and the whole function beside its bound."""
    from grl_torch.ops import sparse
    from grl_torch.ops import sparse_attention as sa

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    plan = kernel.plan
    N, E = kernel.num_nodes, kernel.num_edges
    f, g, h, dout = (torch.randn(N, d, generator=gen, device="cuda").to(dtype) for d in (K4_K, K4_K, K4_F, K4_F))
    grads = sa.attend_grad(f, g, h, dout, plan)
    again = sa.attend_grad(f, g, h, dout, plan)
    ref = sa.attend_backward(f, g, h, dout, plan)
    df, pairs = sa._launch_receivers(f, g, h, dout, plan)
    ref_df, ref_pairs = sa.receiver_walk(f, g, h, dout, plan)
    dg, dh = sa._launch_senders(f, dout, pairs, plan)
    ref_dg, ref_dh = sa.sender_walk(f, dout, pairs, plan)
    torch.cuda.synchronize()
    tol = SPARSE_TOL[dtype_name]
    errs = {f"d{name}": check_close(torch, out, want, dtype_name, f"K4b {what} {dtype_name} d{name}", tol)
            for name, out, want in zip("fgh", grads, ref)}
    require(all(torch.equal(a, b) for a, b in zip(grads, again)), f"K4b {what} {dtype_name}: two launches give "
            "other bits")
    require(torch.equal(df, grads[0]) and torch.equal(dg, grads[1]) and torch.equal(dh, grads[2]),
            f"K4b {what} {dtype_name}: the walks launched one by one give other bits than attend_grad")
    walk_errs = {
        "pairs": check_close(torch, pairs, ref_pairs, "float32", f"K4b {what} {dtype_name} pairs",
                             SPARSE_TOL["float32"]),
        "df_walk": check_close(torch, df, ref_df, dtype_name, f"K4b {what} {dtype_name} df walk", tol),
        "dg_walk": check_close(torch, dg, ref_dg, dtype_name, f"K4b {what} {dtype_name} dg walk", tol),
        "dh_walk": check_close(torch, dh, ref_dh, dtype_name, f"K4b {what} {dtype_name} dh walk", tol),
    }
    no_in = plan.rowptr[1:] == plan.rowptr[:-1]
    no_out = plan.colptr[1:] == plan.colptr[:-1]
    require(bool((df[no_in] == 0).all()) and bool((dg[no_out] == 0).all()) and bool((dh[no_out] == 0).all()),
            f"K4b {what} {dtype_name}: a node with no edge got a nonzero gradient row")
    launch = sa.backward_launch(N, K4_K, K4_F, h.element_size(), sparse.sm_count(0))
    base = {"dtype": dtype_name, "N": N, "edges": E, "K": K4_K, "F": K4_F, "isolated": int(no_in.sum()),
            "no_out_edges": int(no_out.sum()), **errs, **walk_errs}
    if not timed:
        return [{"kernel": f"K4b {what}", **base}]
    itemsize = h.element_size()
    feat, narrow = N * K4_F * itemsize, N * K4_K * itemsize
    csr = 4 * (N + 1) + 4 * E
    # The function's own traffic: f, g, h and dout read once, df, dg and dh
    # written once, both CSRs read once. Each walk is given the share of it
    # that it alone moves: the receiver walk reads the four inputs, writes
    # df and reads the CSR; the sender walk writes dg and dh and reads the
    # transposed CSR. The two-launch design's own traffic, the 8-byte pairs
    # written and read and t_edge read, is kept out of the bound and stated
    # beside it ("design_bytes"). The float32 arithmetic (per edge: a
    # K-wide dot, an F-wide dot and a K-wide scaled add; then a K- and an
    # F-wide scaled add) at the float32 rate.
    design_bytes = {"K4b receivers": 8 * E, "K4b senders": 8 * E + 4 * E}
    walks = {
        "K4b receivers": (2 * narrow + 2 * feat + narrow + csr, E * (4 * K4_K + 2 * K4_F),
                          lambda: sa._launch_receivers(f, g, h, dout, plan),
                          lambda: sa.receiver_walk(f, g, h, dout, plan), errs["df"]),
        "K4b senders": (narrow + feat + csr, E * (2 * K4_K + 2 * K4_F),
                        lambda: sa._launch_senders(f, dout, pairs, plan),
                        lambda: sa.sender_walk(f, dout, pairs, plan), max(errs["dg"], errs["dh"])),
    }
    # The ring's depth swept on each walk (device time; the planned depth's
    # outputs must be every depth's, bit for bit).
    depths = {}
    for stages in RING_DEPTHS:
        forced = launch._replace(stages=stages)
        df_s, pairs_s = sa._launch_receivers(f, g, h, dout, plan, forced)
        dg_s, dh_s = sa._launch_senders(f, dout, pairs_s, plan, forced)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip((df_s, pairs_s, dg_s, dh_s), (df, pairs, dg, dh))),
                f"K4b {what} {dtype_name}: a ring of {stages} rows gives other bits than {launch.stages}")
        depths[stages] = (
            time_ms(torch, lambda: sa._launch_receivers(f, g, h, dout, plan, forced), flush, cover=True),
            time_ms(torch, lambda: sa._launch_senders(f, dout, pairs, plan, forced), flush, cover=True))
    # The group width swept the same way (a narrower group takes an h or
    # dout row in several passes; its sums take another order, so each is
    # held to the plain walks, not to the planned bits).
    groups = {}
    for group in GROUP_WIDTHS:
        forced = launch._replace(group=group)  # one wave of blocks at any group on this graph
        df_s, pairs_s = sa._launch_receivers(f, g, h, dout, plan, forced)
        dg_s, dh_s = sa._launch_senders(f, dout, pairs_s, plan, forced)
        torch.cuda.synchronize()
        for out, ref, what_ in ((df_s, ref_df, "df"), (pairs_s, ref_pairs, "pairs"), (dg_s, ref_dg, "dg"),
                                (dh_s, ref_dh, "dh")):
            check_close(torch, out, ref, "float32" if what_ == "pairs" else dtype_name,
                        f"K4b {what} {dtype_name} {what_} at groups of {group}",
                        SPARSE_TOL["float32" if what_ == "pairs" else dtype_name])
        groups[group] = (
            time_ms(torch, lambda: sa._launch_receivers(f, g, h, dout, plan, forced), flush, cover=True),
            time_ms(torch, lambda: sa._launch_senders(f, dout, pairs, plan, forced), flush, cover=True))
    layout = {"group": launch.group, "blocks": launch.blocks, "stages": launch.stages, "smem": launch.smem,
              "feed": "cp.async, 16 bytes a lane"}
    rows = []
    for i, (name, (nbytes, flops, kernel_fn, plain_fn, err)) in enumerate(walks.items()):
        bound_ms, bound_by = sparse_bound("float32", nbytes, flops)
        rows.append({
            "kernel": f"{name} {what}", **base, "max_abs_err": err, **layout,
            "ms": time_ms(torch, kernel_fn, flush), "device_ms": time_ms(torch, kernel_fn, flush, cover=True),
            "plain_ms": time_ms(torch, plain_fn, flush, reps=10), "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            "design_bytes": design_bytes[name],
            "stages_device_ms": {str(k): v[i] for k, v in depths.items()},
            "group_device_ms": {str(k): v[i] for k, v in groups.items()},
        })
    nbytes = sum(row["bytes"] for row in rows)
    flops = E * (6 * K4_K + 4 * K4_F)
    bound_ms, bound_by = sparse_bound("float32", nbytes, flops)
    rows.append({
        "kernel": f"K4b {what}", **base, "max_abs_err": max(errs.values()), **layout,
        "ms": time_ms(torch, lambda: sa.attend_grad(f, g, h, dout, plan), flush),
        "device_ms": time_ms(torch, lambda: sa.attend_grad(f, g, h, dout, plan), flush, cover=True),
        "plain_ms": time_ms(torch, lambda: sa.attend_backward(f, g, h, dout, plan), flush, reps=10),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        "design_bytes": sum(design_bytes.values()),
    })
    return rows


def dropout_shapes(N: int):
    """The dropout rate of the full_graph model and the (N, F) activations
    its five dropouts take in a train step, read from the model: the
    trunk's (emb1 and each GraphConv, net_size wide) and the head's (the
    RanPAC width)."""
    from grl_torch.models import create_model

    config = full_graph_config(tempfile.mkdtemp(prefix="grl_torch_shapes_"))
    model = create_model("GraphCNNDropEdge", **config["model"]["args"], device="cpu")
    return model.dropout.rate, [(N, model.net_size), (N, model.w_rand.kernel.shape[1])]


def bits(torch, t):
    """``t``'s bits as integers of its width, so that -0 and 0 differ."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def dropout_cases(torch, flush, N: int):
    """D against its plain version, bit for bit, at the step's dropout
    shapes in both dtypes, forward and backward (the same kernel on a
    gradient under the forward's seed: one mask, zero wherever the seed's
    hash drops), two launches equal, the keep share within binomial
    bounds and another seed another mask; timed beside
    ``torch.nn.functional.dropout`` on the same tensor."""
    from grl_torch.ops import dropout as D
    from grl_torch.ops import hashing

    rate, shapes = dropout_shapes(N)
    rows = []
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for shape in shapes:
            gen = torch.Generator(device="cuda").manual_seed(shape[1])
            x, dy = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(2))
            seed = device_seed(7919 * shape[1])
            other = device_seed(7919 * shape[1] + 1)
            y = D._launch(x, seed, rate)
            dx = D._launch(dy, seed, rate)
            again = D._launch(x, seed, rate)
            elsewhere = D._launch(x, other, rate)
            torch.cuda.synchronize()
            what = f"D {dtype_name} {shape}"
            require(torch.equal(bits(torch, y), bits(torch, D.dropout_reference(x, seed, rate))),
                    f"{what}: forward differs from its plain version")
            require(torch.equal(bits(torch, dx), bits(torch, D.dropout_reference(dy, seed, rate))),
                    f"{what}: backward differs from its plain version")
            require(torch.equal(bits(torch, y), bits(torch, again)), f"{what}: two launches give other bits")
            require(torch.equal(bits(torch, elsewhere), bits(torch, D.dropout_reference(x, other, rate))),
                    f"{what}: forward at another seed differs from its plain version")
            # The mask itself (randn draws an exact 0 now and then, so not y != 0).
            ids = torch.arange(y.numel(), device="cuda")
            mask = hashing.keep_bits(ids, seed, rate).view(shape)
            require(not bool(((y != 0) & ~mask).any()) and not bool(((dx != 0) & ~mask).any()),
                    f"{what}: forward or backward keeps an element the seed's mask drops")
            kept, total = int(mask.sum()), y.numel()
            require(keep_share_ok(kept, total, rate), f"{what}: keep share {kept / total}")
            require(not torch.equal(mask, hashing.keep_bits(ids, other, rate).view(shape)),
                    f"{what}: two seeds give one mask")
            del ids, mask
            nbytes = 2 * total * x.element_size()
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            for direction, t in (("forward", x), ("backward", dy)):
                rows.append({
                    "kernel": f"D {direction}", "dtype": dtype_name, "N": shape[0], "F": shape[1], "rate": rate,
                    "keep_share": kept / total, "max_abs_err": 0.0,
                    "ms": time_ms(torch, lambda: D._launch(t, seed, rate), flush, reps=20),
                    "device_ms": time_ms(torch, lambda: D._launch(t, seed, rate), flush, reps=20, cover=True),
                    "plain_ms": time_ms(torch, lambda: D.dropout_reference(t, seed, rate), flush, reps=5),
                    "library_ms": time_ms(torch, lambda: torch.nn.functional.dropout(t, rate, True), flush, reps=20),
                    "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes, "flops": 0,
                })
    for row in rows:
        log(f"[kernel] {row['kernel']} {row['dtype']:>8} ({row['N']}, {row['F']}) rate {rate}: equal to the plain "
            f"version bit for bit, keep share {row['keep_share']:.5f} | kernel {row['ms']:.4f} ms (device "
            f"{row['device_ms']:.4f}), plain {row['plain_ms']:.4f} ms, torch.nn.functional.dropout "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms (bytes)")
    return rows


def sparse_kernel_cases(torch, flush):
    """K5 and K4 rows, the K5 keep-set probes and the small-graph cases."""
    import numpy as np

    from grl_torch.ops import csr_spmm, sparse_attention

    start = time.perf_counter()
    data = arxiv_graph()
    N, E = len(data.features), len(data.senders)
    csr = csr_spmm.CSRGraphKernel(data.senders, data.receivers, data.relations, data.weights,
                                  N, data.num_relations, device="cuda")
    atten = sparse_attention.SparseAttentionKernel(data.senders, data.receivers, N, device="cuda")
    log(f"[kernel] arxiv SBM graph: {N} nodes, {E} edges, L={data.num_relations}, max in-degree "
        f"{int(np.bincount(data.receivers, minlength=N).max())}; built and planned in "
        f"{time.perf_counter() - start:.2f} s")
    rows, grad_rows = [], []
    for dtype_name in ("float32", "bfloat16"):
        for F in K5_FS:
            for layout, what in ((csr.forward_layout, "forward"), (csr.backward_layout, "backward")):
                rows.append(k5_case(torch, layout, dtype_name, F, flush, seed=F + len(rows), what=what))
        rows.append(k4_case(torch, atten, dtype_name, flush, seed=len(rows), what="arxiv", timed=True))
        grad_rows += k4b_case(torch, atten, dtype_name, flush, seed=len(rows), what="arxiv", timed=True)
    for row in rows:
        if row["kernel"].startswith("K4"):
            library = "none (no single PyTorch call)"
        else:
            library = f"torch.sparse.mm {row['library_ms']:.4f} ms"
        log(
            f"[kernel] {row['kernel']} {row['dtype']:>8} F={row['F']}: max_abs_err {row['max_abs_err']:.3e}, "
            f"outputs that differ from the plain version's {row['differ_share']:.3e} | "
            f"kernel {row['ms']:.4f} ms{slicing_note(row)}, plain {row['plain_ms']:.4f} ms, library {library}, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), gather floor {row['gather_floor_ms']:.4f} ms"
        )
    for row in grad_rows:
        sweep = row.get("stages_device_ms")
        log(
            f"[kernel] {row['kernel']} {row['dtype']:>8} K={row['K']} F={row['F']} (groups of {row['group']} "
            f"lanes, {row['blocks']} blocks, rings of {row['stages']} rows fed by {row['feed']}, {row['smem']} "
            f"bytes of shared memory a block): max abs err df {row['df']:.3e}, dg {row['dg']:.3e}, dh "
            f"{row['dh']:.3e} against attend_backward, pairs {row['pairs']:.3e} against the plain walk; two "
            f"launches equal | kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, library none (no single PyTorch call), bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, {row['bytes']} bytes)"
            + (f"; device ms by ring depth {sweep}, by group width {row['group_device_ms']}" if sweep else "")
        )
    rows += grad_rows
    # Relation folding (L = 3) and K4's hub and isolated receivers, small.
    rng = np.random.RandomState(11)
    n, e = 4096, 40000
    small = csr_spmm.CSRGraphKernel(rng.randint(0, n, e), rng.randint(0, n, e), rng.randint(0, 3, e),
                                    (rng.rand(e) + 0.5).astype(np.float32), n, 3, device="cuda")
    senders, receivers = rng.randint(0, n, e), rng.randint(0, n - 9, e)
    receivers[:500] = 7  # a hub of degree >= 500; receivers n-9.. have no edge
    hub = sparse_attention.SparseAttentionKernel(senders, receivers, n, device="cuda")
    checks = []
    for dtype_name in ("float32", "bfloat16"):
        for layout, what in ((small.forward_layout, "forward L=3"), (small.backward_layout, "backward L=3")):
            X = torch.randn(layout.num_src_rows, 256, device="cuda").to(getattr(torch, dtype_name))
            out = csr_spmm.csr_accumulate(X, layout, 3, RATE)
            ref = csr_spmm.csr_accumulate_reference(X, layout, 3, RATE)
            err = check_close(torch, out, ref, dtype_name, f"K5 {what}", SPARSE_TOL[dtype_name])
            checks.append({"kernel": f"K5 {what}", "dtype": dtype_name, "max_abs_err": err})
        checks.append(k4_case(torch, hub, dtype_name, flush, seed=99, what="hub", timed=False))
        checks += k4b_case(torch, hub, dtype_name, flush, seed=99, what="hub", timed=False)
        share = k5_mask_probe(torch, dtype_name)
        checks.append({"kernel": "K5 keep set", "dtype": dtype_name, "kept_share": share})
    for row in checks:
        log(f"[kernel] {row}")
    log("[kernel] K5 keep set = plain hash keep set exactly (forward and transposed, f32 and bf16); K4b on the "
        "hub graph within SPARSE_TOL of attend_backward, two launches equal, zero rows where a node has no edge")
    return rows, checks


def ell_library_ms(torch, tables, X, seed, flush):
    """One torch.sparse.mm of the tables' matrix (row perm[j], column idx of
    each live cell), masked and scaled beforehand, with X: the PyTorch call
    for K6's product (never called by the port)."""
    from grl_torch.ops import hashing

    first_rows = tables.buckets[:, 0].tolist()
    table_row = torch.cat([torch.arange(r0, r0 + rows, device=X.device).repeat_interleave(width)
                           for r0, (rows, width) in zip(first_rows, tables.shapes)])
    live = tables.weight != 0
    values = (tables.weight * hashing.hash_keep(tables.gid, seed, RATE))[live]
    rows, cols = tables.perm.long()[table_row][live], tables.idx.long()[live]
    order = torch.argsort(rows * X.shape[0] + cols)
    rowptr = torch.zeros(tables.num_rows + 1, dtype=torch.int64, device=X.device)
    rowptr[1:] = torch.cumsum(torch.bincount(rows, minlength=tables.num_rows), 0)
    A = torch.sparse_csr_tensor(rowptr, cols[order], values[order].to(X.dtype),
                                size=(tables.num_rows, X.shape[0]))
    return time_ms(torch, lambda: torch.sparse.mm(A, X), flush)


def k6_case(torch, tables, dtype_name: str, F: int, flush, seed: int, what: str, timed: bool = True):
    """K6 on one planned direction against its plain version (timed when
    ``timed``); one result row."""
    from grl_torch.ops import ell, hashing

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(tables.num_src_rows, F, generator=gen, device="cuda").to(dtype)
    mask_seed = device_seed(104729 * (seed + 1))
    out = ell.ell_accumulate(X, tables, mask_seed, RATE)
    ref = ell.ell_accumulate_reference(X, tables, mask_seed, RATE)
    torch.cuda.synchronize()
    err = check_close(torch, out, ref, dtype_name, f"K6 {what} {dtype_name} F={F}", SPARSE_TOL[dtype_name])
    # The plain version's arithmetic term for term, except an einsum over
    # buckets wider than 32.
    if max(width for _, width in tables.shapes) <= 32:
        require(torch.equal(out, ref), f"K6 {what} {dtype_name} F={F} is not its plain version bit for bit")
    row = {"kernel": f"K6 {what}", "dtype": dtype_name, "rows": tables.num_rows, "src_rows": tables.num_src_rows,
           "cells": tables.num_cells, "buckets": len(tables.shapes), "F": F, "rate": RATE, "max_abs_err": err,
           "differ_share": float((out != ref).float().mean())}
    if not timed:
        return row
    live = tables.weight != 0
    kept = int((live & (hashing.hash_keep(tables.gid, mask_seed, RATE) != 0)).sum())
    itemsize = X.element_size()
    # X read once, out written once, 12 bytes a table cell (padding
    # included: the tables are inputs), perm and the bucket table; 2 FLOPs
    # per kept edge and feature.
    nbytes = (itemsize * (tables.num_src_rows + tables.num_rows) * F + 12 * tables.num_cells
              + 4 * tables.num_rows + 12 * len(tables.shapes))
    bound_ms, bound_by = sparse_bound(dtype_name, nbytes, 2 * kept * F)
    row.update({
        "edges": int(live.sum()), "kept_edges": kept,
        "ms": time_ms(torch, lambda: ell.ell_accumulate(X, tables, mask_seed, RATE), flush),
        "device_ms": time_ms(torch, lambda: ell.ell_accumulate(X, tables, mask_seed, RATE), flush, cover=True),
        **slice_fields(torch, ell, X, tables, mask_seed, out, flush, f"K6 {what} {dtype_name} F={F}"),
        # The plain version takes 15-25 ms a call: the median of 10.
        "plain_ms": time_ms(torch, lambda: ell.ell_accumulate_reference(X, tables, mask_seed, RATE), flush,
                            reps=10),
        "library_ms": ell_library_ms(torch, tables, X, mask_seed, flush),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": 2 * kept * F,
        "gather_floor_ms": (kept * F * itemsize + nbytes) / HBM_BYTES_PER_S * 1e3,
    })
    return row


def ell_directions(tables):
    """(name, GatherTables) of the four planned directions of ELLTables."""
    return (("forward", tables.fwd), ("backward", tables.bwd), ("projected forward", tables.proj.fwd),
            ("projected backward", tables.proj.bwd))


def ell_kernel_cases(torch, flush):
    """K6 rows on the arxiv graph planned with the config's kernel_plan (all
    four directions, F = 256 and 512), the small L = 3 graph, and K6 against
    K5 on one seed: values within one bf16 rounding on the arxiv graph, the
    keep set exactly with V = I on a small one."""
    import numpy as np

    from grl_torch.config import load_config
    from grl_torch.ops import csr_spmm, ell

    data = arxiv_graph()
    N = len(data.features)
    plan = dict(load_config(FULL_GRAPH_YAML)["kernel_plan"])
    start = time.perf_counter()
    kernel = ell.ELLGraphKernel(data.senders, data.receivers, data.relations, data.weights, N,
                                data.num_relations, device="cuda", **plan)
    directions = ell_directions(kernel.tables)
    log(f"[kernel] arxiv graph planned as ELL ({plan}) in {time.perf_counter() - start:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in kernel.plan_seconds.items())}); node_perm "
        f"{'set' if kernel.node_perm is not None else 'none'}; "
        + "; ".join(f"{name}: {tables.num_rows} rows, {len(tables.shapes)} buckets, {tables.num_cells} cells, "
                    f"stitch {'identity' if tables.inv_perm is None else 'a permutation'}"
                    for name, tables in directions))
    rows = []
    for dtype_name in ("float32", "bfloat16"):
        for F in K5_FS:
            for name, tables in directions:
                rows.append(k6_case(torch, tables, dtype_name, F, flush, seed=F + len(rows), what=name))
    for row in rows:
        log(
            f"[kernel] {row['kernel']} {row['dtype']:>8} F={row['F']}: max_abs_err {row['max_abs_err']:.3e}, "
            f"outputs that differ from the plain version's {row['differ_share']:.3e} | kernel {row['ms']:.4f} ms"
            f"{slicing_note(row)}, plain {row['plain_ms']:.4f} ms, torch.sparse.mm {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), gather floor {row['gather_floor_ms']:.4f} ms"
        )
    checks = []
    # Relation-channelled rows and geometric widths without the reorder (L = 3).
    rng = np.random.RandomState(12)
    n, e = 4096, 40000
    small = ell.ELLGraphKernel(rng.randint(0, n, e), rng.randint(0, n - 9, e), rng.randint(0, 3, e),
                               (rng.rand(e) + 0.5).astype(np.float32), n, 3, plan_projected=True,
                               width_quantum=4, bucket_growth=2, device="cuda")
    for dtype_name in ("float32", "bfloat16"):
        for name, tables in ell_directions(small.tables):
            checks.append(k6_case(torch, tables, dtype_name, 256, flush, seed=3, what=f"{name} L=3", timed=False))
    # K6 against K5 on the arxiv graph, one seed: K5 walks the graph as
    # built, K6 the degree-reordered one, features placed through node_perm.
    csr = csr_spmm.CSRGraphKernel(data.senders, data.receivers, data.relations, data.weights, N,
                                  data.num_relations, device="cuda")
    perm = torch.from_numpy(kernel.node_perm).cuda()
    for dtype_name in ("float32", "bfloat16"):
        V = torch.randn(N, NET_SIZE, generator=torch.Generator(device="cuda").manual_seed(8), device="cuda")
        V = V.to(getattr(torch, dtype_name))
        placed = torch.empty_like(V)
        placed[perm] = V
        k5 = csr.neighbor_aggregate(V, 4242, RATE)
        k6 = kernel.neighbor_aggregate(placed, 4242, RATE)[perm]
        err = check_close(torch, k6, k5, dtype_name, f"K6 against K5 ({dtype_name})", SPARSE_TOL[dtype_name])
        checks.append({"kernel": "K6 against K5 arxiv", "dtype": dtype_name, "max_abs_err": err,
                       "differ_share": float((k6 != k5).float().mean())})
        checks.append({"kernel": "K6 keep set = K5's", "dtype": dtype_name, "kept_share": k6_k5_keep_sets(torch, dtype_name)})
    for row in checks:
        log(f"[kernel] {row}")
    log("[kernel] K6 keep set = K5 keep set exactly (V = I, degree-reordered, f32 and bf16); K6 forward = K5 "
        "forward within one bf16 rounding on the arxiv graph")
    return rows, checks


def k6_k5_keep_sets(torch, dtype_name: str) -> float:
    """V = I: K6 on the degree-reordered graph keeps exactly K5's edges on
    the graph as built, row-permuted by node_perm. Unique edges, N = 512."""
    import numpy as np

    from grl_torch.config import load_config
    from grl_torch.ops import csr_spmm, ell

    N, E, seed = 512, 6000, 2025
    rng = np.random.RandomState(6)
    receivers, senders = np.divmod(rng.choice(N * N, E, replace=False), N)
    edges = (senders, receivers, np.zeros(E, np.int64), np.ones(E, np.float32))
    k6 = ell.ELLGraphKernel(*edges, N, 1, device="cuda", **dict(load_config(FULL_GRAPH_YAML)["kernel_plan"]))
    k5 = csr_spmm.CSRGraphKernel(*edges, N, 1, device="cuda")
    require(k6.node_perm is not None, "the keep-set graph was not reordered")
    eye = torch.eye(N, device="cuda", dtype=getattr(torch, dtype_name))
    perm = torch.from_numpy(k6.node_perm).cuda()
    seen6 = (k6.neighbor_aggregate(eye, device_seed(seed), RATE) != 0)[perm][:, perm]
    seen5 = k5.neighbor_aggregate(eye, device_seed(seed), RATE) != 0
    torch.cuda.synchronize()
    require(torch.equal(seen6, seen5), f"K6's keep set differs from K5's ({dtype_name})")
    return float(seen5.sum()) / E


# K7's main case and the tile phase: configs/arxiv_full_graph.yaml's SBM
# with 661 communities (~256 nodes each, bench.py's "clustered" structure)
# planned as a tile graph: B = 128, bfloat16 tiles, the project-first
# tables, the LPA order (tile's default reorder). grl_tpu's planner makes
# 3198 tiles covering 810,156 of its 1,175,131 edges (BENCH_r05.json), and
# the port's planner equals it (tests/test_torch_tile.py).
TILE_COMMUNITIES = 661
TILE_PLAN = {"tile_size": 128, "tile_dtype": "bfloat16", "plan_projected": True}
TILE_EXPECTED = {"tiles_total": 3198, "covered_edges": 810156}
# K7's small case: L = 3, B = 64 (the last block ragged), rows of up to
# 8-16 tiles, float32 tiles under bfloat16 operands too.
K7_SMALL = {"N": 1000, "L": 3, "E": 30000, "tile_size": 64, "tile_min_edges": 40}


def tile_config(tmp: str):
    """configs/arxiv_full_graph.yaml with kernel_impl tile, TILE_PLAN and
    661 communities, 20 steps for its 200, its outputs under ``tmp``."""
    from grl_torch.config import load_config

    config = load_config(FULL_GRAPH_YAML)
    config["model"]["args"]["kernel_impl"] = "tile"
    config["kernel_plan"] = dict(TILE_PLAN)
    config["data_config"]["large_graph"]["args"]["communities"] = TILE_COMMUNITIES
    config["num_epochs"] = FULL_GRAPH_STEPS
    config["output_dir"] = os.path.join(tmp, "out")
    return config


@functools.lru_cache(maxsize=None)
def clustered_graph():
    """The tile phase's SBM graph (numpy), built as FullGraphProcedure builds it."""
    from grl_torch.trainer.procedures.full_graph_procedure import large_graph_from_config

    return large_graph_from_config(tile_config(tempfile.mkdtemp(prefix="grl_torch_graph_")))


def tile_operand(torch, plan, direction: str, F: int, dtype_name: str, seed: int):
    """A random operand of a K7 call in ``direction``: V (N, F), Vr (N*L, F),
    g (N, L*F) or g (N, F)."""
    N, L = plan.num_nodes, plan.L
    rows, cols = {"forward": (N, F), "projected forward": (N * L, F), "backward": (N, L * F),
                  "projected backward": (N, F)}[direction]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(rows, cols, generator=gen, device="cuda").to(getattr(torch, dtype_name))


def k7_library_ms(torch, plan, X, direction: str, seed, flush):
    """torch.bmm over every bucket of every relation, on tiles already
    masked and rounded and source blocks already gathered: the PyTorch
    call for K7's products (never called by the port)."""
    from grl_torch.ops import tile

    *_, blocks = tile.relation_blocks(X, plan, direction)
    mixes = [m & 0xFFFFFFFF for m in plan.rel_mix.tolist()]
    operands = [pair for r, view in enumerate(plan.relation_views()) if view is not None
                for pair in tile.bucket_operands(view[0], blocks[r], plan.B, seed, RATE, mixes[r], plan.transposed)]
    return time_ms(torch, lambda: [torch.bmm(a, b) for a, b in operands], flush)


def k7_case(torch, plan, direction: str, dtype_name: str, F: int, flush, seed: int, what: str, timed: bool = True):
    """K7 in one direction against its plain version, two launches equal to
    the bit (timed when ``timed``); one result row."""
    from grl_torch.ops import tile

    X = tile_operand(torch, plan, direction, F, dtype_name, seed)
    mask_seed = device_seed(104729 * (seed + 1))
    out = tile.tile_accumulate(X, plan, mask_seed, RATE, direction)
    again = tile.tile_accumulate(X, plan, mask_seed, RATE, direction)
    ref = tile.tile_apply_reference(X, plan, mask_seed, RATE, direction)
    torch.cuda.synchronize()
    name = f"K7 {direction}"
    require(torch.equal(out, again), f"{name} {what} {dtype_name} F={F}: two launches give other bits")
    err = check_close(torch, out, ref, dtype_name, f"{name} {what} {dtype_name} F={F}", SPARSE_TOL[dtype_name])
    layout = tile.launch_plan(plan, F, X.dtype, direction, torch.cuda.get_device_properties(0).multi_processor_count)
    row = {"kernel": name, "case": what, "dtype": dtype_name, "tile_dtype": str(plan.tiles.dtype).split(".")[-1],
           "F": F, "B": plan.B, "L": plan.L, "slots": plan.num_slots, "tiles": plan.num_tiles, "rate": RATE,
           "max_abs_err": err, "differ_share": float((out != ref).float().mean()),
           "plan_route": layout.route, "BN": layout.BN, "chunks": layout.chunks, "consumers": layout.consumers,
           "stages": layout.stages, "smem": layout.smem_bytes, "ctas": layout.ctas}
    if not timed:
        return row
    itemsize = X.element_size()
    # The real tiles and their columns read once (a padding slot adds exact
    # zeros, so the function never needs it), the row tables once, X read
    # once, out written once; 2 B^2 F operations a tile. float32 products
    # are bounded at the card's float32 product rate on the tensor cores:
    # 3xTF32 on float32 tiles, as for the f32 K1/K3, and 2xTF32 on bf16
    # tiles, whose cells are exact in TF32; the bound at the rate outside
    # them, where the simple route's f32 FMA runs, beside it (bound_fp32_ms).
    nbytes = (plan.num_tiles * (plan.B * plan.B * plan.tiles.element_size() + 4) + 12 * plan.rows.shape[0]
              + 4 * plan.row_of_block.numel() + itemsize * (X.numel() + out.numel()))
    flops = 2 * plan.B * plan.B * F * plan.num_tiles
    f32 = dtype_name == "float32"
    peak = ("2xTF32" if plan.tiles.dtype == torch.bfloat16 else "3xTF32") if f32 else dtype_name
    bound_ms, bound_by = sparse_bound(peak, nbytes, flops)
    if f32:
        row["bound_fp32_ms"] = sparse_bound("float32", nbytes, flops)[0]
    row.update({
        "ms": time_ms(torch, lambda: tile.tile_accumulate(X, plan, mask_seed, RATE, direction), flush),
        "device_ms": time_ms(torch, lambda: tile.tile_accumulate(X, plan, mask_seed, RATE, direction), flush,
                             cover=True),
        # The plain version builds every masked tile and gathered stack: the median of 5.
        "plain_ms": time_ms(torch, lambda: tile.tile_apply_reference(X, plan, mask_seed, RATE, direction), flush,
                            reps=5),
        "library_ms": k7_library_ms(torch, plan, X, direction, mask_seed, flush),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
        # No cell hashed: the staging and the products alone.
        "rate0_ms": time_ms(torch, lambda: tile.tile_accumulate(X, plan, mask_seed, 0.0, direction), flush),
    })
    # The simple route's kernel on the same operands at both rates, held
    # to the plain version too.
    simple, _ = tile._launch(X, plan, mask_seed, RATE, direction, route="simple")
    torch.cuda.synchronize()
    check_close(torch, simple, ref, dtype_name, f"{name} {what} {dtype_name} F={F} simple route",
                SPARSE_TOL[dtype_name])
    row.update({
        "simple_ms": time_ms(torch, lambda: tile._launch(X, plan, mask_seed, RATE, direction, "simple"), flush),
        "simple_rate0_ms": time_ms(torch, lambda: tile._launch(X, plan, mask_seed, 0.0, direction, "simple"),
                                   flush),
    })
    return row


def k6_direction_ms(torch, tables, F: int, flush, seed: int) -> dict:
    """K6 at F in bf16 over one planned direction: its ms and device ms."""
    from grl_torch.ops import ell

    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(tables.num_src_rows, F, generator=gen, device="cuda").to(torch.bfloat16)
    mask_seed = device_seed(seed)
    return {"ms": time_ms(torch, lambda: ell.ell_accumulate(X, tables, mask_seed, RATE), flush),
            "device_ms": time_ms(torch, lambda: ell.ell_accumulate(X, tables, mask_seed, RATE), flush, cover=True),
            "cells": tables.num_cells, "edges": int((tables.weight != 0).sum())}


def k7_keep_set(torch, kernel, dtype_name: str) -> float:
    """V = I on the small graph: K7's forward reads back the masked tiles,
    equal to its plain version bit for bit (float32 tiles under float32
    operands: 3xTF32 gives each masked cell back as its TF32 hi plus lo
    parts, within SPARSE_TOL of it); the kept cells are exactly the tiles'
    nonzero cells that the pair hash keeps under each relation's mix; the
    transposed tables keep the same edges. Returns the kept share."""
    from grl_torch.ops import hashing, tile

    N, L = kernel.num_nodes, kernel.L
    eye = torch.eye(N, device="cuda", dtype=getattr(torch, dtype_name))
    seed = device_seed(2027)
    ahead = tile.tile_accumulate(eye, kernel.tables.fwd, seed, RATE, "forward").view(N, L, N)
    full = tile.tile_accumulate(eye, kernel.tables.fwd, seed, 0.0, "forward").view(N, L, N)
    back = tile.tile_accumulate(eye, kernel.tables.bwd, seed, RATE, "projected backward").view(N, L, N)
    torch.cuda.synchronize()
    ref = tile.tile_apply_reference(eye, kernel.tables.fwd, seed, RATE)
    what = f"K7's V = I readback ({kernel.tables.fwd.tiles.dtype} tiles, {dtype_name})"
    if dtype_name == "float32" and kernel.tables.fwd.tiles.dtype == torch.float32:
        check_close(torch, ahead.view(N, L * N), ref, dtype_name, what, SPARSE_TOL[dtype_name])
    else:
        require(torch.equal(ahead.view(N, L * N), ref), f"{what} differs from its plain version")
    ids = torch.arange(N, device="cuda")
    for r in range(L):
        kept = hashing.keep_pair_bits(ids[:, None], ids[None, :], seed, RATE, tile._rel_seed_mix(r))
        require(torch.equal(ahead[:, r] != 0, (full[:, r] != 0) & kept),
                f"K7's keep set of relation {r} is not the pair hash's ({dtype_name})")
    require(torch.equal(ahead != 0, back.permute(2, 1, 0) != 0),
            f"K7's transposed tables keep other edges than its forward ({dtype_name})")
    return float((ahead != 0).sum()) / float((full != 0).sum())


def k7_adjoint(torch, plan_pair, F: int, what: str) -> dict:
    """<g, K7(V)> = <K7'(g), V> in float32, both modes, within 1e-5 of
    sum |g * K7(V)|: a backward whose mask is keyed on swapped endpoints
    breaks it."""
    from grl_torch.ops import tile

    fwd, bwd = plan_pair
    found = {}
    for forward, backward in (("forward", "backward"), ("projected forward", "projected backward")):
        V = tile_operand(torch, fwd, forward, F, "float32", 11)
        g = tile_operand(torch, fwd, backward, F, "float32", 12)
        out = tile.tile_accumulate(V, fwd, device_seed(31), RATE, forward).double()
        lhs = float((g.double() * out).sum())
        rhs = float((tile.tile_accumulate(g, bwd, device_seed(31), RATE, backward).double() * V.double()).sum())
        scale = float((g.double() * out).abs().sum())
        require(abs(lhs - rhs) <= 1e-5 * scale, f"K7 {what} {forward}: <g, K7 V> {lhs} != <K7' g, V> {rhs}")
        found[forward] = {"lhs": lhs, "rhs": rhs, "rel": abs(lhs - rhs) / scale}
    return found


def tile_kernel_cases(torch, flush):
    """K7 rows on the clustered arxiv plan (four directions, F = 256 and
    512, bf16 and f32 operands on bf16 and on float32 tiles), beside K6
    over all the graph's edges planned as the arxiv config's ELL and over
    the tile plan's residual alone; the small L = 3 graph (f32 and bf16
    tiles, both operand dtypes, untimed), its keep set, and the adjoint
    check."""
    import numpy as np

    from grl_torch.config import load_config
    from grl_torch.ops import ell, tile

    data = clustered_graph()
    N = len(data.features)
    start = time.perf_counter()
    kernel = tile.TileGraphKernel(data.senders, data.receivers, data.relations, data.weights, N,
                                  data.num_relations, device="cuda", **TILE_PLAN)
    plan_s = time.perf_counter() - start
    found = {"tiles_total": kernel.tiles_total, "covered_edges": kernel.covered_edges}
    require(found == TILE_EXPECTED, f"the clustered arxiv graph planned {found}, expected {TILE_EXPECTED}")
    fwd, bwd = kernel.tables.fwd, kernel.tables.bwd
    log(f"[kernel] clustered arxiv graph ({N} nodes, {len(data.senders)} edges, {TILE_COMMUNITIES} communities) "
        f"planned as tiles ({TILE_PLAN}) in {plan_s:.2f} s ({kernel.plan_seconds}): {kernel.tiles_total} tiles "
        f"covering {kernel.covered_edges} edges; forward buckets {fwd.shapes}, backward {bwd.shapes}; "
        f"{fwd.tiles.numel() * fwd.tiles.element_size() / 1e6:.1f} MB of tiles a direction")
    # The float32 tables of this graph without a second LPA order: its
    # weights are 1, so every cell is a small integer, which bf16 holds
    # exactly, and the bf16 tables cast to float32 are the planner's float32
    # tables.
    cells = torch.cat([fwd.tiles, bwd.tiles]).float()
    require(bool((cells == cells.round()).all()) and float(cells.max()) <= 256,
            "the clustered plan's tile cells are not small integers")
    del cells
    f32_tables = [plan._replace(tiles=plan.tiles.float(), launch_cache={}) for plan in (fwd, bwd)]
    rows = []
    for tables in ((fwd, bwd), f32_tables):
        for dtype_name in ("float32", "bfloat16"):
            for F in K5_FS:
                for direction in tile.DIRECTIONS:
                    plan = tables[1] if "backward" in direction else tables[0]
                    rows.append(k7_case(torch, plan, direction, dtype_name, F, flush, seed=F + len(rows),
                                        what="clustered arxiv"))
    del f32_tables
    # K7 plus the residual on K6 against K6 over every edge, bf16 at the
    # path's width (F = 256 in all four directions).
    all_ell = ell.ELLGraphKernel(data.senders, data.receivers, data.relations, data.weights, N, data.num_relations,
                                 device="cuda", **dict(load_config(FULL_GRAPH_YAML)["kernel_plan"]))
    versus = {}
    for name, everything, residual in zip(tile.DIRECTIONS, ell_directions(all_ell.tables),
                                          ell_directions(kernel._ell.tables)):
        versus[name] = {"all_edges": k6_direction_ms(torch, everything[1], NET_SIZE, flush, 5),
                        "residual": k6_direction_ms(torch, residual[1], NET_SIZE, flush, 6)}
    for row in rows:
        if row["dtype"] == "bfloat16" and row["F"] == NET_SIZE:
            pair = versus[row["kernel"][len("K7 "):]]
            row.update(k6_all_edges_ms=pair["all_edges"]["ms"], k6_all_edges_device_ms=pair["all_edges"]["device_ms"],
                       k6_residual_ms=pair["residual"]["ms"], k6_residual_device_ms=pair["residual"]["device_ms"])
            # Whether tiles pay: K7's time a tile against what K6 saves an
            # edge once the covered edges leave it (both device times).
            saved = (row["k6_all_edges_device_ms"] - row["k6_residual_device_ms"]) / kernel.covered_edges
            row["breakeven_edges_per_tile"] = (row["device_ms"] / row["tiles"] / saved) if saved > 0 else None
    for row in rows:
        breakeven = row.get("breakeven_edges_per_tile")
        beside = (f" | K7 + K6 residual {row['ms'] + row['k6_residual_ms']:.4f} ms (device "
                  f"{row['device_ms'] + row['k6_residual_device_ms']:.4f}) against K6 over all edges "
                  f"{row['k6_all_edges_ms']:.4f} ms (device {row['k6_all_edges_device_ms']:.4f}); break-even "
                  + (f"{breakeven:.0f} edges a tile" if breakeven is not None else "none (K6 saved no time)")
                  if "k6_residual_ms" in row else "")
        simple = f"; the simple route {row['simple_ms']:.4f} ms, at rate 0 {row['simple_rate0_ms']:.4f} ms"
        simt = row.get("bound_fp32_ms")
        log(f"[kernel] {row['kernel']} {row['dtype']:>8} F={row['F']} ({row['tiles']} tiles in {row['slots']} "
            f"slots, {row['tile_dtype']} tiles): {row['plan_route']} route (BN {row['BN']} x {row['chunks']}, "
            f"{row['consumers']} consumers, {row['stages']} stages, {row['smem']} B, {row['ctas']} CTAs): "
            f"max_abs_err {row['max_abs_err']:.3e}, differing outputs "
            f"{row['differ_share']:.3e} | kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}; at rate 0 "
            f"{row['rate0_ms']:.4f}){simple}, plain "
            f"{row['plain_ms']:.4f} ms, torch.bmm {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}{'' if simt is None else f', float32 outside the tensor cores {simt:.4f} ms'})"
            f"{beside}")
    log(f"[kernel] K6 at F={NET_SIZE} bf16 over all edges (the arxiv config's ELL plan) and over the tile plan's "
        f"residual: {versus}")
    checks = {"versus_all_ell": versus, "plan_seconds": kernel.plan_seconds, "plan_s": plan_s,
              "adjoint_clustered": k7_adjoint(torch, (fwd, bwd), NET_SIZE, "clustered arxiv")}
    del kernel, all_ell
    rng = np.random.RandomState(3)
    n, e = K7_SMALL["N"], K7_SMALL["E"]
    edges = (rng.randint(0, n, e), rng.randint(0, n, e), rng.randint(0, K7_SMALL["L"], e),
             (rng.rand(e) + 0.5).astype(np.float32))
    small_rows = []
    for tile_dtype in ("float32", "bfloat16"):
        small = tile.TileGraphKernel(*edges, n, K7_SMALL["L"], tile_size=K7_SMALL["tile_size"],
                                     tile_min_edges=K7_SMALL["tile_min_edges"], reorder="none", tile_dtype=tile_dtype,
                                     plan_projected=True, device="cuda")
        widths = sorted({w for shapes in small.tables.fwd.shapes for _, w in shapes})
        require(max(widths) >= 8, f"the small tile graph's widest bucket is {max(widths)}")
        for dtype_name in ("float32", "bfloat16"):
            for F in (64, 136):
                for direction in tile.DIRECTIONS:
                    plan = small.tables.bwd if "backward" in direction else small.tables.fwd
                    small_rows.append(k7_case(torch, plan, direction, dtype_name, F, flush, seed=F, timed=False,
                                              what=f"L=3 widths {widths}"))
        checks[f"keep_share {tile_dtype} tiles"] = {d: k7_keep_set(torch, small, d) for d in ("float32", "bfloat16")}
        checks[f"adjoint small {tile_dtype} tiles"] = k7_adjoint(torch, (small.tables.fwd, small.tables.bwd), 64,
                                                                   "small")
    checks["small"] = small_rows
    log(f"[kernel] K7 on the small L = 3 graph (B = 64, ragged last block), four directions, f32/bf16 tiles and "
        f"operands, F = 64 and 136: largest max_abs_err {max(r['max_abs_err'] for r in small_rows):.3e}; two "
        f"launches equal; keep sets = the pair hash's, the transposed tables the same: "
        f"{ {k: v for k, v in checks.items() if k.startswith('keep_share')} }; <g, K7 V> = <K7' g, V>: "
        f"{ {k: v for k, v in checks.items() if k.startswith('adjoint')} }")
    return rows, checks


def phase_kernel(torch):
    from grl_torch.ops import relagg

    # 256 MiB, five times the H100's 50 MB L2, zeroed before each timed call.
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    cases = [
        (dtype_name, N, F, SPARSE_DENSITY)
        for dtype_name in ("float32", "bfloat16")
        for N in KERNEL_NS
        for F in KERNEL_FS
    ] + [("float32", 192, 512, DENSE_DENSITY), ("bfloat16", 192, 512, DENSE_DENSITY)] + [
        ("float32", RAGGED_N, F, SPARSE_DENSITY) for F in KERNEL_FS]
    # bf16 K3 at ragged N, on relagg_ragged.cu (bf16 K1/K2 refuse them).
    ragged = [("bfloat16", N, F, SPARSE_DENSITY) for N in (RAGGED_N, ODD_N) for F in KERNEL_FS]
    results = []
    for seed, case in enumerate(cases + ragged):
        rows = [kernel_case(torch, *case, flush=flush, seed=seed)]
        if case not in ragged:
            rows += dropedge_cases(torch, *case, flush=flush, seed=seed)
        for row in rows:
            results.append(row)
            simt = row.get("bound_fp32_ms")
            log(
                f"[kernel] {row['kernel']}{' (' + row['route'] + ')' if 'route' in row else ''} "
                f"{row['dtype']:>8} B={B} N={row['N']:3d} L={L} F={row['F']} "
                f"density={row['density']}: max_abs_err {row['max_abs_err']:.3e} | "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"torch.matmul {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}"
                f"{'' if simt is None else f', float32 outside the tensor cores {simt:.4f} ms'}"
                f") | device alone: kernel {row['device_ms']:.4f} ms, torch.matmul "
                f"{row['library_device_ms']:.4f} ms; kernel wrapper enqueue {1e3 * row['enqueue_ms']:.1f} us"
            )
    shares = {}
    for dtype_name in ("float32", "bfloat16"):
        for N in KERNEL_NS:
            shares[f"{dtype_name} N={N}"] = share = mask_probe(torch, dtype_name, N, seed=31 + N)
            log(f"[kernel] K1/K2 mask = plain hash mask exactly ({dtype_name}, N={N}); kept share {share:.5f}")
            if N == 256:
                require(abs(share - (1 - RATE)) <= KEEP_SHARE_TOL,
                        f"kept share {share} is not {1 - RATE} +- {KEEP_SHARE_TOL}")
    invariants = dropedge_invariants(torch)
    log(
        f"[kernel] <K2(1), V> = {invariants['k2_dot_v']:.6f}, sum K1(V) = {invariants['sum_k1']:.6f} "
        f"(f32, need within 1e-5 of the sum); K1 at keep 1 = K3 bit for bit (f32 and bf16); rate 0 launches "
        f"K3; the ragged K3 at N=256 = the sm90 route bit for bit (V through TMA and V copied); two "
        f"launches of bf16 K1, K2, ragged K3 and f32 K1, K2, K3 give equal bits"
    )
    bf16_checks, clusters, f32_capacity = bf16_dropedge_checks(torch)
    for row in bf16_checks:
        log(f"[kernel] bf16 K1/K2 at N={row['N']} F={row['F']}: max abs err K1 {row['K1_max_abs_err']:.3e}, "
            f"K2 {row['K2_max_abs_err']:.3e}")
    sweep = k2_split_sweep(torch, flush)
    for row in sweep:
        log(f"[kernel] {row['dtype']} K2 N=256 F={row['F']} at S={row['S']} ({row['blocks']} blocks"
            f"{', planned' if row['planned'] else ''}): device {row['device_ms']:.4f} ms, "
            f"max abs err {row['max_abs_err']:.3e}")
    for shape, held in clusters.items():
        log(f"[kernel] K2 plan at {shape}: BN {held['BN']}, S {held['S']}, {held['blocks']} blocks; the card "
            f"holds {held['max_active_clusters']} clusters of {held['S']} at once")
    log(f"[kernel] f32 K2: blocks the card runs at once in clusters of S = 1..8: {f32_capacity}; f32 K1/K3: "
        f"{relagg.f32_forward_slots(0)} blocks at once")
    sparse_rows, sparse_checks = sparse_kernel_cases(torch, flush)
    dropout_rows = dropout_cases(torch, flush, len(arxiv_graph().features))
    ell_rows, ell_checks = ell_kernel_cases(torch, flush)
    tile_rows, tile_checks = tile_kernel_cases(torch, flush)
    del flush
    return results + sparse_rows + dropout_rows + ell_rows + tile_rows, {
        "kept_share": shares, **invariants, "bf16_dropedge": bf16_checks, "k2_clusters": clusters,
        "f32_k2_capacity": f32_capacity, "k2_split_sweep": sweep, "f32_forward_slots": relagg.f32_forward_slots(0),
        "sparse": sparse_checks, "ell": ell_checks, "tile": tile_checks}


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------
def write_inputs(tmp: str, seed: int):
    """classes.json (26 classes), charset.json (4365 chars) and 64 pages."""
    from grl_torch.data.synthetic import DEFAULT_CLASSES, synthetic_page

    classes = list(DEFAULT_CLASSES) + [
        f"field_{i:02d}" for i in range(NUM_CLASSES - len(DEFAULT_CLASSES))
    ]
    pages = [
        synthetic_page(seed + i, num_rows=110, noise_lines=10, classes=classes)
        for i in range(PAGES)
    ]
    chars = set("0()-.,")
    for page in pages:
        for box in page:
            chars.update(box["text"].lower())
    # Pad to the production charset size, as scripts/bench_inference.py does.
    pad = (chr(0x4E00 + i) for i in range(CHARSET_SIZE))
    while len(chars) < CHARSET_SIZE:
        chars.add(next(pad))
    classes_path = os.path.join(tmp, "classes.json")
    charset_path = os.path.join(tmp, "charset.json")
    with open(classes_path, "w") as handle:
        json.dump({"classes": classes}, handle)
    with open(charset_path, "w") as handle:
        json.dump({"charset": sorted(chars)}, handle)
    samples = [[{"location": box["location"], "text": box["text"]} for box in page] for page in pages]
    return classes_path, charset_path, samples


def serve_config(tmp, classes_path, charset_path, checkpoint, kernel_impl, compute_dtype):
    return {
        "experiment_name": f"serve-{kernel_impl}-{compute_dtype}",
        "seed": 0,
        "is_train": False,
        "output_dir": os.path.join(tmp, "out"),
        "checkpoint_path": checkpoint,
        "model": {
            "type": "GraphCNNDropEdge",
            "args": {
                "input_dim": CHARSET_SIZE + 4,
                "output_dim": NUM_CLASSES * 2 + 1,
                "num_edges": 6,
                "net_size": NET_SIZE,
                "kernel_impl": kernel_impl,
                "compute_dtype": compute_dtype,
            },
        },
        "procedure": {"type": "KVInference", "args": {"batch_size": B}},
        "inference_settings": {
            "datasets": {
                "type": "CassiaDataset",
                "args": {
                    "charset_path": charset_path,
                    "class_path": classes_path,
                    "key_types": ["key", "value"],
                    "data_process": {
                        "TextlineEncoding": {"is_normalized_text": True},
                        "HeuristicGraphBuilder": {"num_edges": 6, "edge_type": "normal_binary"},
                    },
                },
            },
            "post_processing": [],
        },
    }


def flat_predictions(pages):
    keys, confidences = [], []
    for page in pages:
        for box in page:
            keys.append((box["formal_key"], box["key_type"]))
            confidences.append(box["confidence"])
    return keys, confidences


def agree(kernel_pages, plain_pages, dtype_name: str, tag: str) -> dict:
    """The share of boxes whose class the kernel path and the plain path
    agree on and their largest confidence difference, held to
    SERVE_AGREEMENT."""
    k_keys, k_conf = flat_predictions(kernel_pages)
    p_keys, p_conf = flat_predictions(plain_pages)
    same = sum(a == b for a, b in zip(k_keys, p_keys)) / len(k_keys)
    conf_err = max(abs(a - b) for a, b in zip(k_conf, p_conf))
    min_same, max_conf_err = SERVE_AGREEMENT[dtype_name]
    log(f"{tag}, {dtype_name}: classes agree on {same:.5f} of {len(k_keys)} boxes (need >= {min_same}), max "
        f"confidence diff {conf_err:.3e} (need <= {max_conf_err})")
    require(same >= min_same and conf_err <= max_conf_err, f"{tag}: the kernel path disagrees ({dtype_name})")
    return {"class_agreement": same, "max_confidence_diff": conf_err}


def check_pages(pages, samples, valid_keys):
    require(len(pages) == len(samples), f"{len(pages)} pages back for {len(samples)} sent")
    for page, sample in zip(pages, samples):
        require(len(page) == len(sample), "a page came back with another box count")
        for box, sent in zip(page, sample):
            require(box["text"] == sent["text"], "boxes came back out of order")
            require((box["formal_key"], box["key_type"]) in valid_keys, f"unknown class {box}")
            conf = box["confidence"]
            require(conf == conf and 0.0 < conf <= 1.0, f"confidence {conf} out of (0, 1]")


# The serve phase's numbers on an NVIDIA H100 80GB HBM3 at 700 W when the
# port built every graph in Python (PERF.md): printed beside this run's,
# which builds them with the native builder.
SERVE_PYTHON_BUILDER = {"pages_per_s": 21.50, "host_encode_s": 2.840, "graph_builder_s": 2.648, "idle_share": 0.9990}


def phase_serve(torch):
    import grl_torch
    from grl_torch.data import native
    from grl_torch.models import create_model
    from grl_torch.ops import relagg
    from grl_torch.utils.checkpoint import CheckpointHandler

    tmp = tempfile.mkdtemp(prefix="grl_torch_smoke_")
    classes_path, charset_path, samples = write_inputs(tmp, seed=1000)
    boxes = sum(len(page) for page in samples)
    # Random weights from a seed, at full width, saved with the port's
    # checkpoint module: the warper loads them as a user's checkpoint.
    args = serve_config(tmp, classes_path, charset_path, "", "pallas", "bfloat16")["model"]["args"]
    model = create_model(
        "GraphCNNDropEdge", **args, device="cuda", generator=torch.Generator().manual_seed(0)
    )
    checkpoint = CheckpointHandler().save_checkpoint(
        {"model": model.state_dict()}, os.path.join(tmp, "weights")
    )
    del model

    def warper(kernel_impl, compute_dtype):
        config = serve_config(tmp, classes_path, charset_path, checkpoint, kernel_impl, compute_dtype)
        return grl_torch.GNNLearningWarper(config=config)

    main = warper("pallas", "bfloat16")
    valid_keys = set(main.inferencer.id_to_class.values())
    encoded = main.inferencer._encode_samples(samples)
    sizes = [n for _, n in encoded]
    batches = -(-PAGES // B)
    log(
        f"[serve] {PAGES} pages, {boxes} boxes, nodes per page {min(sizes)}..{max(sizes)}, "
        f"{batches} batches of {B}, input_dim {CHARSET_SIZE + 4}, output_dim {NUM_CLASSES * 2 + 1}"
    )
    main.predict(samples[:B])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    # The main path: every launch count starts at 0 here, and so do the
    # native graph builder's page counts.
    reset_counts()
    native.pages.update(native=0, python=0)
    walls = []
    for _ in range(SERVE_REPEATS):
        start = time.perf_counter()
        out = main.predict(samples)
        walls.append(time.perf_counter() - start)
    launches = counts()["K3"]
    routes = route_counts()["K3"]
    built = dict(native.pages)
    require(built == {"native": PAGES * SERVE_REPEATS, "python": 0},
            f"the graph builders built {built} pages, expected all {PAGES * SERVE_REPEATS} natively")
    expected = 3 * batches * SERVE_REPEATS
    require(
        launches == expected and routes["sm90"] == expected,
        f"K3 launched {launches} times on the main path ({routes} by route), expected {expected} "
        f"(3 GraphConvs x {batches} batches x {SERVE_REPEATS} requests), all on dropedge_sm90.cu",
    )
    check_pages(out, samples, valid_keys)
    best = min(walls)
    log(
        f"[serve] {torch.cuda.get_device_name(0)}, kernel_impl=pallas bf16: best of {SERVE_REPEATS} requests {best:.3f} s "
        f"({[round(w, 3) for w in walls]}): {PAGES / best:.2f} pages/s, "
        f"{boxes / best:.1f} boxes/s; K3 launches {launches} = 3 x {batches} x {SERVE_REPEATS} (by route {routes})"
    )

    # Where the request's time goes: the host's processors (text features,
    # the Python graph builder), padding and the copy to the card, and the
    # device time of the model forward over all batches.
    encode_s, stage_s = timed_encode(main.inferencer, samples)
    copy_s, device_ms, device_alone_ms = forward_device_ms(torch, main.inferencer, encoded)
    stages = ", ".join(f"{name} {sec:.3f} s" for name, sec in stage_s.items())
    idle = 1 - device_alone_ms / 1e3 / best
    builder_s = stage_s["HeuristicGraphBuilder"]
    log(
        f"[serve] breakdown of the {best:.3f} s request: host encode {encode_s:.3f} s ({stages}); "
        f"pad + copy to the card {copy_s:.3f} s; device forward of {batches} batches "
        f"{device_ms:.3f} ms as enqueued, {device_alone_ms:.3f} ms of device "
        f"work alone (device idle share {idle:.4f})"
    )
    log(
        f"[serve] native graph builder: {built['native']} of {PAGES * SERVE_REPEATS} pages built natively; "
        f"{PAGES / best:.2f} pages/s, host encode {encode_s:.3f} s of which the builder {builder_s:.3f} s "
        f"({builder_s / encode_s:.3f} of it), idle share {idle:.4f}; with the Python builder (NVIDIA H100 80GB "
        f"HBM3, 700 W): {SERVE_PYTHON_BUILDER['pages_per_s']} pages/s, host encode "
        f"{SERVE_PYTHON_BUILDER['host_encode_s']} s, builder {SERVE_PYTHON_BUILDER['graph_builder_s']} s, idle "
        f"{SERVE_PYTHON_BUILDER['idle_share']}"
    )

    agreement = {}
    reference = {"bfloat16": out}
    for dtype_name in ("bfloat16", "float32"):
        kernel_pages = reference.get(dtype_name) or warper("pallas", dtype_name).predict(samples)
        check_pages(kernel_pages, samples, valid_keys)
        plain_pages = warper("xla", dtype_name).predict(samples)
        check_pages(plain_pages, samples, valid_keys)
        agreement[dtype_name] = agree(kernel_pages, plain_pages, dtype_name, "[serve] pallas vs xla")

    return {
        "pages": PAGES, "boxes": boxes, "batch_size": B, "batches": batches,
        "nodes_min": min(sizes), "nodes_max": max(sizes),
        "request_s": walls, "pages_per_s": PAGES / best, "boxes_per_s": boxes / best,
        "host_encode_s": encode_s, "host_stage_s": stage_s, "pad_copy_s": copy_s, "idle_share": idle,
        "pages_built": built,
        "device_forward_ms": device_ms, "device_forward_alone_ms": device_alone_ms,
        "k3_launches": launches, "k3_routes": routes, "agreement": agreement,
    }


@contextlib.contextmanager
def timed_processors(dataset):
    """Times each host processor of ``dataset`` while the block runs;
    yields the seconds by processor name."""
    processors = dataset.data_processors
    stage_s = {type(p).__name__: 0.0 for p in processors}

    def timed(processor):
        def call(sample):
            start = time.perf_counter()
            out = processor(sample)
            stage_s[type(processor).__name__] += time.perf_counter() - start
            return out
        return call

    dataset.data_processors = [timed(p) for p in processors]
    try:
        yield stage_s
    finally:
        dataset.data_processors = processors


def timed_encode(inferencer, samples):
    """Encode a request as KVInference does, timing each host processor."""
    with timed_processors(inferencer.dataset) as stage_s:
        start = time.perf_counter()
        inferencer._encode_samples(samples)
        return time.perf_counter() - start, stage_s


# Cycles the card spins before a request's forwards (~30 ms at 1.98 GHz),
# longer than the host takes to enqueue all of them.
FORWARD_COVER_CYCLES = 60_000_000


def forward_device_ms(torch, inferencer, encoded):
    """(host seconds to pad and copy a request's batches to the card,
    milliseconds of the model forward over them between CUDA events as
    the request enqueues them, the same with the card kept busy until all
    are enqueued: the device's work alone)."""
    import numpy as np

    from grl_torch.data.collate import next_bucket

    order = sorted(range(len(encoded)), key=lambda i: encoded[i][1])
    start_s = time.perf_counter()
    tensors = []
    for begin in range(0, len(order), inferencer.batch_size):
        chunk = order[begin:begin + inferencer.batch_size]
        bucket = next_bucket(max(encoded[i][1] for i in chunk), quantum=64)
        V = np.zeros((len(chunk), bucket, encoded[chunk[0]][0]["textline_encoding"].shape[-1]), np.float32)
        A = np.zeros((len(chunk), bucket, 6, bucket), np.float32)
        for row, i in enumerate(chunk):
            sample, n = encoded[i]
            V[row, :n] = sample["textline_encoding"]
            A[row, :n, :, :n] = sample["adjacency_matrix"]
        tensors.append((torch.from_numpy(V).cuda(), torch.from_numpy(A).cuda()))
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - start_s
    times = []
    with torch.inference_mode():
        inferencer._forward(*tensors[0])
        torch.cuda.synchronize()
        for cover in (False, True):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if cover:
                torch.cuda._sleep(FORWARD_COVER_CYCLES)
            start.record()
            for V, A in tensors:
                inferencer._forward(V, A)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    return (copy_s, *times)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------
def write_training_files(tmp: str):
    """64 training and 16 validation labelled pages in cassia format, with
    26 classes and the charset of their text padded to 4365 characters,
    as ``write_inputs`` does for the serve phase."""
    from grl_torch.data.synthetic import DEFAULT_CLASSES, synthetic_page

    classes = list(DEFAULT_CLASSES) + [
        f"field_{i:02d}" for i in range(NUM_CLASSES - len(DEFAULT_CLASSES))
    ]
    chars = set("0()-.,")
    dirs = {}
    for split, count, seed0 in (("training", TRAIN_PAGES, 20_000), ("validation", VAL_PAGES, 30_000)):
        dirs[split] = os.path.join(tmp, split)
        os.makedirs(dirs[split])
        for i in range(count):
            page = synthetic_page(seed0 + i, num_rows=110, noise_lines=10, classes=classes)
            for box in page:
                chars.update(box["text"].lower())
            with open(os.path.join(dirs[split], f"page_{i:04d}.json"), "w") as handle:
                json.dump(page, handle)
    pad = (chr(0x4E00 + i) for i in range(CHARSET_SIZE))
    while len(chars) < CHARSET_SIZE:
        chars.add(next(pad))
    classes_path = os.path.join(tmp, "classes.json")
    charset_path = os.path.join(tmp, "charset.json")
    with open(classes_path, "w") as handle:
        json.dump({"classes": classes}, handle)
    with open(charset_path, "w") as handle:
        json.dump({"charset": sorted(chars)}, handle)
    return dirs, classes_path, charset_path


def train_config(tmp, dirs, classes_path, charset_path):
    """configs/synthetic_kv.yaml at the full sumi width, on the kernel path."""
    def split(kind):
        return {
            "data_path": [dirs[kind]], "class_path": classes_path, "charset_path": charset_path,
            "key_types": ["key", "value"], "batch_size": B, "shuffle": kind == "training",
            "drop_last": False,
            "data_collate": {"BucketPadding": {"quantum": 64, "only_selected_items": True}},
            "data_process": {
                "TextlineEncoding": {"is_normalized_text": True},
                "HeuristicGraphBuilder": {"num_edges": 6, "edge_type": "normal_binary"},
                "NodeLabeling": {},
            },
        }

    args = {
        "input_dim": CHARSET_SIZE + 4, "output_dim": NUM_CLASSES * 2 + 1, "num_edges": 6,
        "net_size": NET_SIZE, "kernel_impl": "pallas", "compute_dtype": "bfloat16",
        "dropout_rate": 0.5, "edge_dropout_rate": RATE,
    }
    return {
        "experiment_name": "train", "seed": 0, "is_train": True, "checkpoint_path": None,
        "output_dir": os.path.join(tmp, "out"), "num_epochs": EPOCHS, "max_grad_norm": 5.0,
        "model": {"type": "GraphCNNDropEdge", "args": args},
        "data_config": {
            "dataset": {"type": "CassiaDataset",
                        "args": {"node_label_padding_value": -100, "other_class_index": None}},
            "training": split("training"), "validation": split("validation"),
        },
        "procedure": {"type": "KVProcedure", "args": {}},
        "loss": {"type": "CrossEntropyLoss", "args": {}},
        "lr_scheduler": {"type": "DecayLearningRate", "args": {"lr": 5e-3, "factor": 0.9, "num_epochs": 100}},
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": 5e-3}},
        "parallel": {"mesh": {"data": -1}},
        "rng_impl": "rbg",
        "logging": {"use_tensorboard": False, "summary_dir_name": "summary",
                    "profile": {"start_step": PROFILE_START, "num_steps": PROFILE_STEPS}},
    }


def series(warper, path):
    """The values a run logged under ``path`` (experiment_series.jsonl)."""
    with open(os.path.join(warper.config["output_dir"], "experiment_series.jsonl")) as handle:
        return [r["value"] for r in map(json.loads, handle) if r["path"] == path]


def reset_counts() -> None:
    """Every launch count to 0 (``grl_torch.ops.launches``)."""
    from grl_torch.ops import launches

    launches.reset()


# K3's routes (relagg.k3_route) and K2's (the bf16 kernel of
# dropedge_sm90.cu or the f32 one of dropedge_f32.cu).
K3_ROUTES, K2_ROUTES = ("sm90", "ragged", "float32"), ("sm90", "float32")


def counts(names=("K3", "K1", "K2")):
    """The launches the device ran of the kernels ``names``
    (``grl_torch.ops.launches``: eager launches plus each graph's recorded
    launches times its replays)."""
    from grl_torch.ops import launches

    ran = launches.device_counts()
    return {name: ran[name] for name in names}


def route_counts():
    """K3's and K2's launches by route, as the device ran them."""
    ran = counts([f"K3 {r}" for r in K3_ROUTES] + [f"K2 {r}" for r in K2_ROUTES])
    return {kernel: {route: ran[f"{kernel} {route}"] for route in routes}
            for kernel, routes in (("K3", K3_ROUTES), ("K2", K2_ROUTES))}


def snapshot(torch, proc):
    """What a chunk of ``proc``'s train steps reads and writes, copied: the
    model's parameters and buffers, the optimizer's state and learning
    rate, the generator's state and the step count."""
    optimizer = proc.state.optimizer
    tensors = list(proc.model.state_dict().values())
    tensors += [v for state in optimizer.state.values() for v in state.values() if isinstance(v, torch.Tensor)]
    tensors += [g["lr"] for g in optimizer.param_groups if isinstance(g["lr"], torch.Tensor)]
    return tensors, [t.clone() for t in tensors], proc.rngs.device.get_state(), proc.state.step


def restore(torch, proc, snap) -> None:
    """Puts ``snapshot``'s copies back, in place: a captured graph reads
    and writes these very tensors."""
    tensors, copies, generator_state, step = snap
    with torch.no_grad():
        for tensor, copy_ in zip(tensors, copies):
            tensor.copy_(copy_)
    proc.rngs.device.set_state(generator_state)
    proc.state.step = step


def device_idle_share(trace_path: str):
    """(idle share, busy ms, window ms) of a torch.profiler Chrome trace:
    the union of kernel, copy and memset intervals on the device against
    the span of every event in the trace; (None, 0, span) if the trace
    holds no device event."""
    with open(trace_path) as handle:
        events = [e for e in json.load(handle)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    require(bool(events), f"no events in {trace_path}")
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    device = sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in events
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
    )
    busy, reach = 0.0, None
    for lo, hi in device:
        if reach is None or lo > reach:
            busy += hi - lo
            reach = hi
        elif hi > reach:
            busy += hi - reach
            reach = hi
    window = end - start
    return (1.0 - busy / window if device else None), busy / 1e3, window / 1e3


def trace_kernel_ms(trace_path: str, names):
    """{name: (device ms, launches)} of the kernels in a torch.profiler
    Chrome trace whose names contain each of ``names``."""
    with open(trace_path) as handle:
        events = [e for e in json.load(handle)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "kernel" and "dur" in e]
    found = {}
    for name in names:
        hits = [e["dur"] for e in events if name in e.get("name", "")]
        found[name] = (sum(hits) / 1e3, len(hits))
    return found


# Kernel names of bf16 K1 and K2 in a trace.
K1_BF16, K2_BF16 = "dropedge_fwd_sm90_kernel", "dropedge_bwd_sm90_kernel"
# Kernel names of K5, K6, K4, K4b's two walks, D and K7 (both routes:
# tile_apply_kernel, tile_apply_persistent_kernel) in a trace.
SPARSE_KERNELS = {"K5": "csr_accumulate_kernel", "K6": "ell_accumulate_kernel", "K4": "sparse_attention_kernel",
                  "K4b receivers": "attention_bwd_receivers_kernel", "K4b senders": "attention_bwd_senders_kernel",
                  "D": "dropout_kernel", "K7": "tile_apply"}


def params_of(model):
    return {name: p.detach().float().clone() for name, p in model.named_parameters()}


def fixed_batches(procedure, count: int):
    """The first ``count`` training batches, on the card."""
    batches = []
    for batch in procedure.train_loader:
        batches.append(procedure._prepare_batch(batch))
        if len(batches) == count:
            break
    return batches


class plain_relagg:
    """Swaps relagg's K1 and K2 launchers for their plain versions (or the
    ``float64`` ones of :func:`float64_relagg`), for the kernel-versus-plain
    comparison only; restored on exit."""

    def __init__(self, relagg, float64: bool = False):
        self.relagg = relagg
        self.swap = (float64_relagg(relagg) if float64 else
                     (relagg.dropedge_aggregate_reference, relagg.dropedge_aggregate_grad_reference))

    def __enter__(self):
        self.saved = (self.relagg._dropedge_forward, self.relagg.dropedge_aggregate_grad)
        self.relagg._dropedge_forward, self.relagg.dropedge_aggregate_grad = self.swap

    def __exit__(self, *exc):
        self.relagg._dropedge_forward, self.relagg.dropedge_aggregate_grad = self.saved


def float64_relagg(relagg):
    """Plain K1 and K2 summed in float64 and rounded once to the operand's
    dtype: the plain path in another summation order, as exact as float32
    allows, to tell the kernels' rounding from a state's sensitivity."""
    def forward(V, A, seed, rate):
        B, N, L, _ = A.shape
        masked = relagg._masked_float(A, seed, rate).double().reshape(B, N * L, N)
        out = (masked @ V.double()) / relagg.keep_probability(rate)
        return out.reshape(B, N, L, V.shape[-1]).to(V.dtype)

    def grad(g, A, seed, rate):
        B, N, L, _ = A.shape
        masked = relagg._masked_float(A, seed, rate).double().reshape(B, N * L, N)
        dV = masked.transpose(1, 2) @ g.double().reshape(B, N * L, g.shape[-1])
        return (dV / relagg.keep_probability(rate)).to(g.dtype)

    return forward, grad



def two_steps(torch, tmp, input_batches, dtype_name: str, plain: bool, state=None, float64: bool = False):
    """Two full-width train steps from seed-0 weights (or the model state
    ``state``), dropout off and DropEdge 0.3, masks from generators seeded
    7: losses, parameters before the first step and after each step, and
    each step's clipped gradients. ``plain`` swaps K1 and K2 for their
    plain versions, summed in float64 with ``float64``."""
    from grl_torch.models import Rngs, create_model
    from grl_torch.ops import relagg
    from grl_torch.trainer.procedures import BaseProcedure

    args = {
        "input_dim": CHARSET_SIZE + 4, "output_dim": NUM_CLASSES * 2 + 1, "num_edges": 6,
        "net_size": NET_SIZE, "kernel_impl": "pallas", "compute_dtype": dtype_name,
        "dropout_rate": 0.0, "edge_dropout_rate": RATE,
    }
    model = create_model("GraphCNNDropEdge", **args, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    if state is not None:
        model.load_state_dict(state)
    config = {
        "output_dir": os.path.join(tmp, f"steps-{dtype_name}-{plain}-{float64}"), "max_grad_norm": 5.0,
        "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": STEP_LR}},
        "logging": {"use_tensorboard": False},
    }
    procedure = BaseProcedure(model, config, device="cuda")
    procedure.init_state()
    step = procedure.build_train_step(NUM_CLASSES * 2 + 1, (-100,))
    rngs = Rngs.from_seed(7, torch.device("cuda"))
    dtype = getattr(torch, dtype_name)
    before = counts()
    losses, snapshots, grads = [], [params_of(model)], []
    with plain_relagg(relagg, float64) if plain else contextlib.nullcontext():
        for V, A, labels in input_batches:
            loss, _ = step(V.to(dtype), A.to(dtype), labels, rngs, 1.0)
            losses.append(float(loss))
            snapshots.append(params_of(model))
            grads.append({name: p.grad.float().clone() for name, p in model.named_parameters()})
    launched = {k: counts()[k] - before[k] for k in ("K1", "K2")}
    expected = 0 if plain else 3 * len(input_batches)
    require(launched == {"K1": expected, "K2": expected},
            f"{'plain' if plain else 'kernel'} steps launched {launched}, expected {expected} each")
    return losses, snapshots, grads


def compare_steps(kernel, plain, lr: float = STEP_LR):
    """Per step: the relative loss difference; the largest parameter
    difference, and that of the held entries (gradient at least HELD_GRAD
    in both paths at every step so far) against the largest parameter
    magnitude; of the parameter entries the plain path moved from their
    initial values, the share the two paths leave further apart than a
    tenth of the learning rate ``lr``; the held entries that far apart, with
    the tensors they lie in and the furthest of them (each with its
    gradients at every step so far, kernel then plain); the relative
    difference of the clipped gradients, and that of the gradients of the
    attention's score projections f and g alone (0 where the model has no
    attention)."""
    rows = []
    initial = plain[1][0]
    held = {n: True for n in initial}
    for step, (k_loss, p_loss, k_params, p_params, k_grads, p_grads) in enumerate(zip(
            kernel[0], plain[0], kernel[1][1:], plain[1][1:], kernel[2], plain[2])):
        held = {n: held[n] & (k_grads[n].abs() >= HELD_GRAD) & (v.abs() >= HELD_GRAD) for n, v in p_grads.items()}
        diff = {n: (k_params[n] - v).abs() for n, v in p_params.items()}
        grad_diff = math.sqrt(sum(float((k_grads[n] - v).square().sum()) for n, v in p_grads.items()))
        grad_norm = math.sqrt(sum(float(v.square().sum()) for v in p_grads.values()))
        scale = max(float(v.abs().max()) for v in p_params.values())
        worst, worst_name = max((float(d.max()), n) for n, d in diff.items())
        worst_at = int(diff[worst_name].argmax())
        held_worst = max(float((d * held[n]).max()) for n, d in diff.items())
        moved = sum(int((v != initial[n]).sum()) for n, v in p_params.items())
        far = {n: d > lr / 10 for n, d in diff.items()}
        held_far = {n: int((f & held[n]).sum()) for n, f in far.items()}
        furthest = sorted(((float(v), n, int(i)) for n, f in far.items() if held_far[n]
                           for v, i in zip(*(diff[n] * (f & held[n])).flatten().topk(min(held_far[n], 4)))),
                          reverse=True)[:8]
        scores = [n for n in p_grads if n.startswith(SCORE_PROJECTIONS)]
        score_diff = math.sqrt(sum(float((k_grads[n] - p_grads[n]).square().sum()) for n in scores))
        score_norm = math.sqrt(sum(float(p_grads[n].square().sum()) for n in scores))
        rows.append({
            "loss_kernel": k_loss, "loss_plain": p_loss,
            "loss_rel_diff": abs(k_loss - p_loss) / abs(p_loss),
            "param_max_diff": worst, "param_scale": scale, "param_max_diff_of_scale": worst / scale,
            "param_max_diff_at": [worst_name, worst_at, float(k_grads[worst_name].flatten()[worst_at]),
                                  float(p_grads[worst_name].flatten()[worst_at])],
            "held": sum(int(h.sum()) for h in held.values()), "held_max_diff_of_scale": held_worst / scale,
            "held_beyond_lr_10": sum(held_far.values()),
            "held_beyond_lr_10_in": {n: c for n, c in held_far.items() if c},
            "held_beyond_lr_10_furthest": [
                [n, i, v, [[float(g[n].flatten()[i]) for g in (k, p)] for k, p in
                           zip(kernel[2][:step + 1], plain[2][:step + 1])]] for v, n, i in furthest],
            "moved": moved, "moved_share_beyond_lr_10": sum(int(f.sum()) for f in far.values()) / max(moved, 1),
            "grad_rel_diff": grad_diff / grad_norm,
            "score_grad_rel_diff": score_diff / score_norm if score_norm else (math.inf if score_diff else 0.0),
        })
    return rows


def phase_train(torch, card: str):
    import grl_torch
    from grl_torch.models import Rngs, create_model
    from grl_torch.ops import relagg
    from grl_torch.trainer.procedures import BaseProcedure
    from grl_torch.utils.checkpoint import CheckpointHandler

    tmp = tempfile.mkdtemp(prefix="grl_torch_train_")
    dirs, classes_path, charset_path = write_training_files(tmp)
    config = train_config(tmp, dirs, classes_path, charset_path)
    warper = grl_torch.GNNLearningWarper(config=config)
    trainer = warper.trainer
    initial = params_of(warper.model)
    log(
        f"[train] {TRAIN_PAGES} training + {VAL_PAGES} validation pages, batch {B}, {EPOCHS} epochs, "
        f"kernel_impl=pallas bf16, edge_dropout_rate={RATE}, dropout_rate=0.5, Adam lr 5e-3, "
        f"max_grad_norm 5.0, DecayLearningRate"
    )

    # The main path: every launch count starts at 0 here.
    reset_counts()
    start = time.perf_counter()
    f1 = warper.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launched = counts(("K3", "K1", "K2", *D_COUNTS))
    routes = route_counts()
    single_steps = dict(trainer.single_steps)
    expected = {"K1": 3 * TRAIN_STEPS, "K2": 3 * TRAIN_STEPS, "K3": 3 * VAL_BATCHES,
                **dict.fromkeys(D_COUNTS, DROPOUTS_A_FORWARD * TRAIN_STEPS)}
    require(launched == expected and routes["K3"]["sm90"] == expected["K3"]
            and routes["K2"]["sm90"] == expected["K2"],
            f"train path launched {launched} ({routes} by route), expected {expected}, all bf16 on dropedge_sm90.cu")

    losses = series(warper, "Train/step_loss")
    nodes_per_s = series(warper, "Train/nodes_per_sec")
    val_loss = series(warper, "Validation/loss")
    require(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses + val_loss),
            f"train losses {losses}, validation losses {val_loss}")
    changed = sum(not torch.equal(initial[n], p) for n, p in params_of(warper.model).items())
    require(changed == len(initial), f"only {changed} of {len(initial)} parameter tensors changed")
    checkpoint = os.path.join(trainer.model_dir, CheckpointHandler.LATEST)
    require(os.path.exists(checkpoint), f"no checkpoint at {checkpoint}")
    # Every page has 230 boxes, so every batch is padded to the 256 bucket.
    batches = fixed_batches(trainer, 2)
    N = batches[0][0].shape[1]
    require(all(V.shape == (B, N, CHARSET_SIZE + 4) for V, _, _ in batches) and N == 256,
            f"training batches of shapes {[tuple(V.shape) for V, _, _ in batches]}")
    nodes_per_step = B * N
    steps_per_s = [v / nodes_per_step for v in nodes_per_s]
    log(
        f"[train] {card}: {TRAIN_STEPS} steps + {VAL_BATCHES} validation batches in {wall:.3f} s; "
        f"launches {launched} = 3 x steps / 3 x validation batches (D: 5 x steps each way); losses "
        f"{[round(v, 4) for v in losses]}; "
        f"validation loss {[round(v, 4) for v in val_loss]}, macro F1 {f1:.4f}"
    )
    log(
        f"[train] per epoch: nodes/s {nodes_per_s}, steps/s {[round(v, 3) for v in steps_per_s]} "
        f"({nodes_per_step} padded nodes a step; epoch 2 has steps {PROFILE_START}..{PROFILE_START + PROFILE_STEPS} "
        f"under torch.profiler)"
    )
    trace = os.path.join(warper.config["output_dir"], "traces",
                         f"steps_{PROFILE_START}_{PROFILE_START + PROFILE_STEPS}.json")
    idle, busy_ms, window_ms = device_idle_share(trace)
    # The profiler stops after step PROFILE_START + PROFILE_STEPS has run:
    # PROFILE_STEPS + 1 steps are traced.
    traced_steps = PROFILE_STEPS + 1
    traced = trace_kernel_ms(trace, (K1_BF16, K2_BF16))
    per_step = {k: {"ms": traced[name][0] / traced_steps, "launches": traced[name][1] / traced_steps}
                for k, name in (("K1", K1_BF16), ("K2", K2_BF16))}
    require(all(v["launches"] == 3 for v in per_step.values()),
            f"the {traced_steps} traced steps launched bf16 K1/K2 {per_step} times a step, expected 3 each")
    log(
        f"[train] traced steps {PROFILE_START}..{PROFILE_START + PROFILE_STEPS} (inclusive): device busy {busy_ms:.3f} ms of "
        f"{window_ms:.3f} ms, idle share "
        + ("not measured (no device events in the trace)" if idle is None else f"{idle:.4f}")
        + f"; bf16 K1 {per_step['K1']['ms']:.4f} ms and K2 {per_step['K2']['ms']:.4f} ms of device time a step "
        f"(3 launches each)"
    )

    # The checkpoint serves through the port's KVInference (K3).
    val_pages = []
    for name in sorted(os.listdir(dirs["validation"]))[:B]:
        with open(os.path.join(dirs["validation"], name)) as handle:
            val_pages.append([{"location": b["location"], "text": b["text"]} for b in json.load(handle)])
    server = grl_torch.GNNLearningWarper(
        config=serve_config(tmp, classes_path, charset_path, checkpoint, "pallas", "bfloat16")
    )
    reset_counts()
    served = server.predict(val_pages)
    torch.cuda.synchronize()
    serve_launches = counts(("K3", "K1", "K2", *D_COUNTS))
    require(serve_launches == {"K3": 3, "K1": 0, "K2": 0, "D forward": 0, "D backward": 0},
            f"serving the checkpoint launched {serve_launches}")
    check_pages(served, val_pages, set(server.inferencer.id_to_class.values()))
    log(f"[train] model_latest serves {len(val_pages)} pages through KVInference: launches {serve_launches}")

    # One full-width train step timed on the card, host data excluded.
    V, A, labels = batches[0]
    step = trainer._train_fn
    for _ in range(3):
        step(V, A, labels, trainer.rngs, 1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(TIMED_STEPS):
        step(V, A, labels, trainer.rngs, 1.0)
    end.record()
    torch.cuda.synchronize()
    step_ms = begin.elapsed_time(end) / TIMED_STEPS
    adj_per_s = 3 * B * (L + 1) * N * N / (step_ms / 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(
        f"[train] {card}: one train step (forward, backward, clip, Adam; bf16, B={B}, N={N}; replayed from its "
        f"one-step graph) "
        f"{step_ms:.3f} ms on the card (mean of {TIMED_STEPS}), of which bf16 K1 {per_step['K1']['ms']:.4f} ms "
        f"and K2 {per_step['K2']['ms']:.4f} ms (traced window); dropedge_train_dense_adj_throughput "
        f"{adj_per_s:.4e} adj_entries/s/chip; peak device memory {peak_gb:.2f} GB"
    )

    # Learning check: the kernel path fits one batch.
    model = create_model("GraphCNNDropEdge", **config["model"]["args"], device="cuda",
                         generator=torch.Generator().manual_seed(1))
    learner = BaseProcedure(model, {**config, "output_dir": os.path.join(tmp, "learn")}, device="cuda")
    learner.init_state()
    learn_step = learner.build_train_step(NUM_CLASSES * 2 + 1, (-100,))
    rngs = Rngs.from_seed(3, torch.device("cuda"))
    learn = [float(learn_step(V, A, labels, rngs, 1.0)[0]) for _ in range(LEARN_STEPS)]
    tail = sum(learn[-5:]) / 5
    log(
        f"[train] learning check, {LEARN_STEPS} steps on one batch: first loss {learn[0]:.4f}, "
        f"mean of the last 5 {tail:.4f} = {tail / learn[0]:.4f} of it (need < {LEARN_SHARE})"
    )

    # Kernel path against plain path, two full-width steps.
    comparison, failures = {}, []
    for dtype_name in ("float32", "bfloat16"):
        kernel = two_steps(torch, tmp, batches, dtype_name, plain=False)
        plain = two_steps(torch, tmp, batches, dtype_name, plain=True)
        comparison[dtype_name] = rows = compare_steps(kernel, plain)
        for k, (row, limit) in enumerate(zip(rows, STEP_LIMITS[dtype_name])):
            log(
                f"[train] kernel vs plain, {dtype_name}, step {k + 1}: loss {row['loss_kernel']:.6f} vs "
                f"{row['loss_plain']:.6f} (rel {row['loss_rel_diff']:.2e}, need <= {limit[0]}); params max diff "
                f"{row['param_max_diff']:.3e} = {row['param_max_diff_of_scale']:.2e} of scale {row['param_scale']:.3f} "
                f"(at {row['param_max_diff_at'][:2]}, whose gradients there were "
                f"{row['param_max_diff_at'][2]:.3e} / {row['param_max_diff_at'][3]:.3e}); of the {row['held']} "
                f"held entries (gradient >= {HELD_GRAD:g} in both paths at every step): max diff "
                f"{row['held_max_diff_of_scale']:.2e} of scale (need <= {limit[1]}), {row['held_beyond_lr_10']} "
                f"further apart than lr/10 (need <= {limit[3]}); of the {row['moved']} entries the plain path "
                f"moved, a share {row['moved_share_beyond_lr_10']:.2e} are further apart than lr/10 (need <= "
                f"{limit[2]}); gradient rel diff {row['grad_rel_diff']:.2e} (need <= {limit[4]})"
            )
        failures += [f"kernel vs plain {dtype_name} step {k + 1}: {rows[k]}"
                     for k in step_failures(rows, STEP_LIMITS[dtype_name])]
    require(tail < LEARN_SHARE * learn[0], f"learning check failed: {learn}")
    require(not failures, "; ".join(failures))
    scan = train_scan(torch, card, tmp, dirs, classes_path, charset_path, step_ms)

    return {
        "scan": scan,
        "train_steps": TRAIN_STEPS, "validation_batches": VAL_BATCHES, "wall_s": wall,
        "launches": launched, "routes": routes, "serve_launches": serve_launches, "losses": losses,
        "validation_loss": val_loss, "macro_f1": f1, "nodes_per_s": nodes_per_s,
        "steps_per_s": steps_per_s, "idle_share": idle, "traced_busy_ms": busy_ms,
        "traced_window_ms": window_ms, "traced_kernels_per_step": per_step, "step_ms": step_ms,
        "dropedge_train_dense_adj_throughput": adj_per_s, "peak_memory_gb": peak_gb,
        "learning_losses": learn, "kernel_vs_plain": comparison, "single_steps": single_steps,
    }


def keep_share_ok(kept: int, total: int, rate: float) -> bool:
    """The share ``kept / total`` within KEEP_SHARE_SDS binomial standard
    deviations of ``1 - rate``."""
    keep = 1.0 - rate
    return abs(kept / total - keep) <= KEEP_SHARE_SDS * math.sqrt(keep * rate / total)


def replayed_masks(torch, trainer, V_shape, A):
    """Two replays on the same inputs draw new masks: a chunk that draws a
    DropEdge seed and a dropout seed from the trainer's generator, reads
    K1's mask back on the batch's A (V = I) and D's on ones at the trunk's
    rate, run by a chunk runner of its own (the warm-up, the capture, then
    replays). Each replay's K1 and D masks must be the hash masks of the
    seeds it drew, masks of two replays must differ, and the keep shares
    must hold."""
    from grl_torch.ops import hashing, relagg
    from grl_torch.ops.dropout import apply_dropout
    from grl_torch.trainer.captured import CapturedSteps

    Bq, N, _ = V_shape
    eye = torch.eye(N, device="cuda", dtype=A.dtype).expand(Bq, N, N).contiguous()
    ones = torch.ones(Bq, N, NET_SIZE, device="cuda", dtype=A.dtype)
    trunk = trainer.model.trunk
    trunk.train()
    runner = CapturedSteps(torch.device("cuda"), [trainer.rngs.device])

    def chunk():
        seed, drop_seed = trainer.rngs.kernel_seed(), trainer.rngs.kernel_seed()
        return (seed, relagg.dropedge_aggregate(eye, A, seed, RATE) != 0, drop_seed,
                apply_dropout(ones, drop_seed, trunk.dropout.rate) != 0)

    outs = [tuple(t.clone() for t in runner.run("masks", chunk)) for _ in range(4)][1:]
    torch.cuda.synchronize()
    require(runner.replays == 3, f"the mask chunk replayed {runner.replays} times, expected 3")
    support = A != 0
    ids = torch.arange(ones.numel(), device="cuda")
    rows = []
    for seed, k1, drop_seed, drop in outs:
        expected = support & relagg.dropedge_keep_mask(seed, A.shape, RATE, A.device)
        require(torch.equal(k1, expected), "a replayed K1 mask is not the hash mask of the seed its replay drew")
        require(torch.equal(drop, hashing.keep_bits(ids, drop_seed, trunk.dropout.rate).view(drop.shape)),
                "a replayed dropout mask is not the hash mask of the seed its replay drew")
        kept, total = int(k1.sum()), int(support.sum())
        dropped_in = int(drop.sum())
        rows.append({"seed": int(seed), "k1_keep_share": kept / total, "k1_entries": total,
                     "dropout_keep_share": dropped_in / drop.numel()})
        require(keep_share_ok(kept, total, RATE), f"replayed K1 keep share {kept / total} of {total}")
        require(keep_share_ok(dropped_in, drop.numel(), trunk.dropout.rate),
                f"replayed dropout keep share {dropped_in / drop.numel()}")
    for (s0, k0, _, d0), (s1, k1, _, d1) in zip(outs, outs[1:]):
        require(int(s0) != int(s1) and not torch.equal(k0, k1) and not torch.equal(d0, d1),
                "two replays drew the same DropEdge or dropout mask")
    return rows


def train_scan(torch, card: str, tmp: str, dirs, classes_path, charset_path, eager_step_ms: float):
    """The train recipe at scan_steps 4 through ``GNNLearningWarper.train``:
    every chunk after the first a CUDA-graph replay. Checks the step count,
    finite losses, the checkpoint and the launch counts under replay; times
    a step eagerly and replayed in this call; holds a replayed chunk, and a
    single step replayed from its one-step graph, to the same chunk or step
    run eagerly from the same state, bit for bit; and shows that replays
    draw new masks."""
    import grl_torch
    from grl_torch.utils.checkpoint import CheckpointHandler

    config = train_config(tmp, dirs, classes_path, charset_path)
    config.update(scan_steps=SCAN_K, experiment_name="train_scan", output_dir=os.path.join(tmp, "out_scan"))
    warper = grl_torch.GNNLearningWarper(config=config)
    trainer = warper.trainer
    initial = params_of(warper.model)

    # The main path: every launch count starts at 0 here.
    reset_counts()
    start = time.perf_counter()
    f1 = warper.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launched, routes = counts(("K3", "K1", "K2", *D_COUNTS)), route_counts()
    runner = trainer.chunk_runner()
    require(runner.replays == SCAN_REPLAYS and len(runner.graphs) == 1,
            f"{runner.replays} replays of {len(runner.graphs)} graphs, expected {SCAN_REPLAYS} of 1")
    (key, (graph, _, recorded)), = runner.graphs.items()
    recorded = {name: recorded[name] for name in ("K1", "K2", "K3", *D_COUNTS) if recorded[name]}
    expected = {"K1": 3 * TRAIN_STEPS, "K2": 3 * TRAIN_STEPS, "K3": 3 * VAL_BATCHES,
                **dict.fromkeys(D_COUNTS, DROPOUTS_A_FORWARD * TRAIN_STEPS)}
    require(launched == expected and routes["K2"]["sm90"] == expected["K2"]
            and routes["K3"]["sm90"] == expected["K3"],
            f"scan_steps {SCAN_K} path ran {launched} launches ({routes} by route), expected {expected}")
    require(recorded == {"K1": 3 * SCAN_K, "K2": 3 * SCAN_K, **dict.fromkeys(D_COUNTS, DROPOUTS_A_FORWARD * SCAN_K)},
            f"the captured chunk recorded {recorded}, expected 3 x {SCAN_K} K1 and K2 and 5 x {SCAN_K} D each way")
    losses = series(warper, "Train/step_loss")
    nodes_per_s = series(warper, "Train/nodes_per_sec")
    require(len(losses) == TRAIN_STEPS and trainer.state.step == TRAIN_STEPS
            and all(math.isfinite(v) for v in losses), f"scan losses {losses}, step {trainer.state.step}")
    changed = sum(not torch.equal(initial[n], p) for n, p in params_of(warper.model).items())
    require(changed == len(initial), f"only {changed} of {len(initial)} parameter tensors changed")
    checkpoint = os.path.join(trainer.model_dir, CheckpointHandler.LATEST)
    require(os.path.exists(checkpoint), f"no checkpoint at {checkpoint}")
    N = 256
    steps_per_s = [v / (B * N) for v in nodes_per_s]
    trace = os.path.join(warper.config["output_dir"], "traces",
                         f"steps_{PROFILE_START}_{PROFILE_START + PROFILE_STEPS}.json")
    idle, busy_ms, window_ms = device_idle_share(trace)
    traced = trace_kernel_ms(trace, (K1_BF16, K2_BF16))
    log(
        f"[train scan] {card}: scan_steps {SCAN_K}, {TRAIN_STEPS} steps + {VAL_BATCHES} validation batches in "
        f"{wall:.3f} s; {runner.replays} replays of one graph of {SCAN_K} steps (recorded {recorded}); device "
        f"launches {launched} = 3 x steps / 3 x validation batches; losses {[round(v, 4) for v in losses]}; "
        f"macro F1 {f1:.4f}"
    )
    log(
        f"[train scan] per epoch: steps/s {[round(v, 3) for v in steps_per_s]} (scan_steps 1: the train phase); "
        f"traced replay of steps {PROFILE_START}..{PROFILE_START + PROFILE_STEPS}: device busy {busy_ms:.3f} ms "
        f"of {window_ms:.3f} ms, idle share " + ("not measured (no device events in the trace)" if idle is None
                                                 else f"{idle:.4f}")
        + f"; K1/K2 in the trace {traced}"
    )
    setup = runner.setup[key]
    log(
        f"[train scan] {card}: the first chunk of {SCAN_K} steps, eager (the warm-up), {setup['warmup_s']:.3f} s; "
        f"the capture of the second {setup['capture_s']:.3f} s, adding {setup['capture_bytes'] / 1e6:.1f} MB "
        f"of reserved device memory"
    )

    # Fixed inputs: the first SCAN_K training batches (all of N = 256).
    items = []
    for batch in trainer.train_loader:
        V, A, labels = trainer._host_batch(batch)
        items.append((V, A, labels, 1.0))
        if len(items) == SCAN_K:
            break
    require(all(tuple(V.shape) == (B, N, CHARSET_SIZE + 4) for V, *_ in items), "scan batches of other shapes")

    # One step on the card: eager back to back, replayed from the step's
    # one-step graph (the single step, _train_fn), and in the chunk's graph.
    require(key == (SCAN_K, *trainer.shape_key(*items[0][:3])), f"the graph's key {key}")
    slots = trainer._slots[key]
    V0, A0, labels0 = slots["V"][0], slots["A"][0], slots["labels"][0]
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    timed = {}
    for name, step in (("eager", trainer.build_train_step(trainer.num_classes, trainer._ignore)),
                       ("single", trainer._train_fn)):
        for _ in range(3):
            step(V0, A0, labels0, trainer.rngs, trainer._lam)
        torch.cuda.synchronize()
        begin.record()
        for _ in range(TIMED_STEPS):
            step(V0, A0, labels0, trainer.rngs, trainer._lam)
        end.record()
        torch.cuda.synchronize()
        timed[name] = begin.elapsed_time(end) / TIMED_STEPS
    eager_ms, single_ms = timed["eager"], timed["single"]
    graph.replay()
    torch.cuda.synchronize()
    replays = TIMED_STEPS
    begin.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = begin.elapsed_time(end) / (replays * SCAN_K)
    log(
        f"[train scan] {card}: one train step on the card (B={B}, N={N}, bf16): eager {eager_ms:.3f} ms (mean of "
        f"{TIMED_STEPS} back to back; the train phase's single step {eager_step_ms:.3f} ms), replayed from "
        f"its one-step graph {single_ms:.3f} ms, replayed in the chunk's {replay_ms:.3f} ms (mean over "
        f"{replays} replays of {SCAN_K} steps)"
    )

    # A replayed chunk against the same chunk run eagerly from one state,
    # and the single step, replayed from its one-step graph, against the
    # same step run eagerly.
    trainer.model.train()
    replay_losses, eager_losses = replay_against_eager(torch, trainer, items, "N=256")
    single_losses = [single_against_eager(torch, trainer, (V0, A0, labels0), "N=256")]

    # Two buckets: the same pages cut to N = 192, a second graph in the
    # runner's pool; replays of the two in turn, each against its chunk
    # run eagerly, and the device memory they take.
    narrow = [(V[:, :NARROW_N].contiguous(), A[:, :NARROW_N, :, :NARROW_N].contiguous(),
               labels[:, :NARROW_N].contiguous(), lam) for V, A, labels, lam in items]
    torch.cuda.reset_peak_memory_stats()
    trainer.run_chunk(narrow)  # the warm-up, eager
    trainer.run_chunk(narrow)  # the capture
    require(len(runner.graphs) == 2, f"{len(runner.graphs)} graphs after a second bucket")
    narrow_key = next(k for k in runner.graphs if k != key)
    second = runner.setup[narrow_key]
    for tag, bucket in (("N=256", items), ("N=192", narrow), ("N=192", narrow), ("N=256", items)):
        replay_against_eager(torch, trainer, bucket, tag)
    # The single step of N = 192: the first records its one-step graph;
    # then the two shapes' single steps between chunk replays, in one pool.
    V1, A1, labels1 = (t.cuda() for t in narrow[0][:3])
    single_losses.append(single_against_eager(torch, trainer, (V1, A1, labels1), "N=192"))
    for tag, batch, bucket in (("N=192", (V1, A1, labels1), narrow), ("N=256", (V0, A0, labels0), items)):
        single_losses.append(single_against_eager(torch, trainer, batch, tag))
        replay_against_eager(torch, trainer, bucket, tag)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(
        f"[train scan] {card}: two buckets on one runner: N=192's warm-up {second['warmup_s']:.3f} s, capture "
        f"{second['capture_s']:.3f} s adding {second['capture_bytes'] / 1e6:.1f} MB of reserved device memory "
        f"(N=256's added {setup['capture_bytes'] / 1e6:.1f} MB); replays of the two graphs in turn equal their "
        f"chunks run eagerly, bit for bit; peak device memory {peak_gb:.3f} GB"
    )
    require(0 < setup["capture_bytes"] and second["capture_bytes"] < SECOND_CAPTURE_SHARE * setup["capture_bytes"],
            f"the second bucket's capture added {second['capture_bytes']} bytes, the first's "
            f"{setup['capture_bytes']}: the graphs do not share their pool")

    masks = replayed_masks(torch, trainer, tuple(items[0][0].shape), A0)
    log(f"[train scan] replays draw new masks: {masks} (K1 and D masks = the hash of each replay's seeds, exactly)")
    return {
        "scan_steps": SCAN_K, "wall_s": wall, "launches": launched, "routes": routes, "recorded": recorded,
        "replays": runner.replays, "losses": losses, "macro_f1": f1, "nodes_per_s": nodes_per_s,
        "steps_per_s": steps_per_s, "idle_share": idle, "traced_busy_ms": busy_ms,
        "traced_window_ms": window_ms, "traced_k1_k2": traced, "eager_step_ms": eager_ms,
        "single_step_ms": single_ms, "replayed_step_ms": replay_ms,
        "replay_vs_eager_losses": [replay_losses, eager_losses], "single_vs_eager_losses": single_losses,
        "single_steps": dict(trainer.single_steps),
        "replayed_masks": masks, "setup": {str(k): v for k, v in runner.setup.items()},
        "two_bucket_peak_memory_gb": peak_gb,
    }


def grads_of(model):
    return {name: None if p.grad is None else p.grad.detach().float().clone() for name, p in model.named_parameters()}


def step_against_eager(torch, trainer, batch, lam=1.0):
    """The single step on ``batch`` (``V, A, labels`` on the card) run
    eagerly (the step's body on the runner's stream) and then through
    ``_train_fn`` from the same state (weights, buffers, Adam state,
    generator, step): (the eager (loss, cm), the step's (loss, cm), names
    of the parameters, and of the gradients they hold after the step
    (``name.grad``), that differ, whether the generator's states agree)."""
    runner = trainer.step_runner()
    snap = snapshot(torch, trainer)
    trainer._lam.fill_(lam)
    eager = [t.clone() for t in runner.eager(lambda: trainer._train_body(*batch, trainer.rngs, trainer._lam))]
    eager_params, eager_grads = params_of(trainer.model), grads_of(trainer.model)
    eager_draws = trainer.rngs.device.get_state()
    restore(torch, trainer, snap)
    trainer._lam.fill_(lam)
    step = trainer.state.step
    got = trainer._train_fn(*batch, trainer.rngs, trainer._lam)
    require(trainer.state.step == step + 1, f"the single step counted {trainer.state.step - step} steps")
    differing = [n for n, v in params_of(trainer.model).items() if not torch.equal(v, eager_params[n])]
    differing += [f"{n}.grad" for n, v in grads_of(trainer.model).items()
                  if not (v is None and eager_grads[n] is None
                          or v is not None and eager_grads[n] is not None and torch.equal(v, eager_grads[n]))]
    return eager, got, differing, torch.equal(trainer.rngs.device.get_state(), eager_draws)


def single_against_eager(torch, trainer, batch, tag: str):
    """``step_against_eager`` where ``_train_fn`` must replay the batch's
    one-step graph, or record it (the shape's first step), and equal the
    eager step bit for bit: loss, confusion matrix, parameters, their
    gradients and the generator's state. Returns (the step's loss, the
    eager loss)."""
    runner = trainer.step_runner()
    before = runner.replays, len(runner.graphs)
    (eager_loss, eager_cm), (loss, cm), differing, draws = step_against_eager(torch, trainer, batch)
    how = {(1, 0): "replayed from its one-step graph", (0, 1): "run eagerly, recording its one-step graph"}.get(
        (runner.replays - before[0], len(runner.graphs) - before[1]))
    require(how is not None, f"{tag}: the single step neither replayed nor recorded a one-step graph")
    same = torch.equal(loss, eager_loss) and torch.equal(cm, eager_cm)
    log(
        f"[train scan] {tag}: a single step {how} vs the same step eager from one state: loss {float(loss)} vs "
        f"{float(eager_loss)}, loss and confusion matrix equal: {same}; generator states equal: {draws}; "
        f"{len(differing)} parameter and gradient tensors differ {differing[:4]}"
    )
    require(same and draws and not differing, f"{tag}: a single step ({how}) differs from the same step run eagerly")
    return float(loss), float(eager_loss)


def replay_against_eager(torch, trainer, items, tag: str):
    """The chunk of ``items`` run eagerly and then replayed from the same
    state (weights, Adam state, generator, step): losses and parameters
    must be equal bit for bit. Returns (replayed losses, eager losses)."""
    runner = trainer.chunk_runner()
    snap = snapshot(torch, trainer)
    eager_losses = [float(v) for v in runner.eager(trainer.load_chunk(items)[1])[0]]
    eager_params = params_of(trainer.model)
    restore(torch, trainer, snap)
    before = runner.replays
    replay_losses = [float(v) for v in trainer.run_chunk(items)[0]]
    require(runner.replays == before + 1, f"{tag}: the chunk against its eager run did not replay the graph")
    replay_params = params_of(trainer.model)
    differing = [n for n, v in replay_params.items() if not torch.equal(v, eager_params[n])]
    log(
        f"[train scan] {tag}: replayed chunk vs the same {len(items)} steps eager from one state: losses "
        f"{replay_losses} vs {eager_losses} (equal: {replay_losses == eager_losses}); "
        f"{len(differing)} of {len(replay_params)} parameter tensors differ {differing[:4]}"
    )
    require(replay_losses == eager_losses and not differing,
            f"{tag}: a replayed chunk differs from the same chunk run eagerly")
    return replay_losses, eager_losses


# ---------------------------------------------------------------------------
# train_variants: the float32 path and the ragged-N bf16 path
# ---------------------------------------------------------------------------
VARIANT_EPOCHS = 1
VARIANT_STEPS, VARIANT_VAL_BATCHES = VARIANT_EPOCHS * TRAIN_PAGES // B, VARIANT_EPOCHS * VAL_PAGES // B
# (model args, BucketPadding quantum, launches expected, K3 and K2 launches
# by route expected) of each path.
VARIANTS = {
    # compute_dtype left at its default: float32 K1, K2 and K3
    # (dropedge_f32.cu).
    "float32": ({"compute_dtype": None}, 64,
                {"K1": 3 * VARIANT_STEPS, "K2": 3 * VARIANT_STEPS, "K3": 3 * VARIANT_VAL_BATCHES},
                {"K3": {"sm90": 0, "ragged": 0, "float32": 3 * VARIANT_VAL_BATCHES},
                 "K2": {"sm90": 0, "float32": 3 * VARIANT_STEPS}}),
    # bf16 without DropEdge, padded at quantum 2: 230-node batches, which
    # TMA cannot read, so every K3 (train and validation) takes the ragged
    # route (relagg_ragged.cu).
    "bfloat16 ragged": ({"compute_dtype": "bfloat16", "edge_dropout_rate": 0.0}, 2,
                        {"K1": 0, "K2": 0, "K3": 3 * (VARIANT_STEPS + VARIANT_VAL_BATCHES)},
                        {"K3": {"sm90": 0, "ragged": 3 * (VARIANT_STEPS + VARIANT_VAL_BATCHES), "float32": 0},
                         "K2": {"sm90": 0, "float32": 0}}),
}


def variant_config(config, tmp, name):
    """The train phase's config as the path ``name`` of VARIANTS runs it:
    one epoch, no profiler window."""
    model_args, quantum = VARIANTS[name][:2]
    config = copy.deepcopy(config)
    config.update(experiment_name=f"train-{name.replace(' ', '-')}", num_epochs=VARIANT_EPOCHS,
                  output_dir=os.path.join(tmp, name.replace(" ", "-")))
    config["model"]["args"].update(model_args)
    for split in ("training", "validation"):
        config["data_config"][split]["data_collate"]["BucketPadding"]["quantum"] = quantum
    config["logging"] = {"use_tensorboard": False, "summary_dir_name": "summary"}
    return config


def phase_train_variants(torch, card: str):
    """Each path of VARIANTS through ``GNNLearningWarper.train``, its launch
    counts set to 0 just before and read just after: the launches by route,
    the padded N, finite losses and changed parameters."""
    import grl_torch
    from grl_torch.ops import relagg

    tmp = tempfile.mkdtemp(prefix="grl_torch_variants_")
    dirs, classes_path, charset_path = write_training_files(tmp)
    base = train_config(tmp, dirs, classes_path, charset_path)
    record = {}
    for name, (_, quantum, expected, expected_routes) in VARIANTS.items():
        # Dropout 0.5 on both paths: D five times a step each way.
        expected = {**expected, **dict.fromkeys(D_COUNTS, DROPOUTS_A_FORWARD * VARIANT_STEPS)}
        warper = grl_torch.GNNLearningWarper(config=variant_config(base, tmp, name))
        initial = params_of(warper.model)
        reset_counts()
        start = time.perf_counter()
        warper.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launched, routes = counts(("K3", "K1", "K2", *D_COUNTS)), route_counts()
        require(launched == expected and routes == expected_routes,
                f"{name} path launched {launched} ({routes} by route), expected {expected} ({expected_routes})")
        losses = series(warper, "Train/step_loss")
        require(len(losses) == VARIANT_STEPS and all(math.isfinite(v) for v in losses), f"{name} losses {losses}")
        changed = sum(not torch.equal(initial[n], p) for n, p in params_of(warper.model).items())
        require(changed == len(initial), f"{name}: only {changed} of {len(initial)} parameter tensors changed")
        N = fixed_batches(warper.trainer, 1)[0][0].shape[1]
        require(N == (256 if quantum == 64 else RAGGED_N), f"{name} batches padded to N={N}")
        log(f"[train_variants] {card}, {name} (BucketPadding quantum {quantum}, N={N}): {VARIANT_STEPS} steps + "
            f"{VARIANT_VAL_BATCHES} validation batches in {wall:.3f} s; launches {launched}, by route {routes}; "
            f"losses {[round(v, 4) for v in losses]}")
        record[name] = {"N": N, "wall_s": wall, "launches": launched, "routes": routes, "losses": losses}
    return record


# ---------------------------------------------------------------------------
# ssl
# ---------------------------------------------------------------------------
# SSLLabeling's tasks in the ssl phase's data chain: make_split(ssl=True)'s
# (tests/test_procedures.py:14-80), with pairwise_similarity, which the
# pretraining leg trains, labeled and padded too.
SSL_LABELS = ["node_property", "edge_mask", "pairwise_distance", "pairwise_similarity", "graph_edit_distance",
              "dgi"]
# The tasks of the pretraining, DGI and joint legs.
SSL_TASKS = ["node_property", "edge_mask", "pairwise_distance", "pairwise_similarity", "graph_edit_distance"]
DGI_TASKS = ["dgi", "node_property"]
JOINT_TASKS = ["node_property", "edge_mask", "pairwise_distance"]
# Trunk passes of each task's loss (graph_edit_distance and dgi run the
# trunk twice, on the graph and its copy), and dropout layers a pass of
# SSLGCN (after emb1 and each GraphConv, and on the node embedding; the
# node-classification head adds one after RanPAC): D's launches a step.
SSL_TRUNK_PASSES = {"node_property": 1, "edge_mask": 1, "pairwise_distance": 1, "pairwise_similarity": 1,
                    "graph_edit_distance": 2, "dgi": 2}
SSL_DROPOUTS_A_PASS = 5
# One epoch of the train phase's pages: 8 steps, 2 validation batches; the
# DGI leg trains on the first 32 pages (4 steps).
SSL_STEPS, SSL_VAL_BATCHES = TRAIN_PAGES // B, VAL_PAGES // B
DGI_PAGES = 32
SSL_TIMED_STEPS = 5
# The pretraining epoch's steps 4..7 run under torch.profiler (the idle share).
SSL_PROFILE_START, SSL_PROFILE_STEPS = SSL_STEPS - 4, 3
# Pages of the training split whose processor chain is timed on the host.
SSL_LABEL_PAGES = 16
GRAPH_CLASSES = 3


def ssl_split(data_dir, classes_path, charset_path, shuffle):
    """A split through the self-supervised data chain: make_split(ssl=True)
    of tests/test_procedures.py:14-80 at batch B, with pairwise_similarity's
    targets labeled, kept and padded too."""
    pairs = ("edge_mask", "pairwise_distance")
    return {
        "data_path": [data_dir], "class_path": classes_path, "charset_path": charset_path,
        "key_types": ["key", "value"], "batch_size": B, "shuffle": shuffle, "drop_last": False,
        "data_collate": {
            "BucketPadding": {
                "quantum": 64, "only_selected_items": True,
                "extra_keys": {"node_property": -100, "aug_textline_encoding": 0, "aug_adjacency_matrix": 0,
                               "negative_textline_encoding": 0, "negative_adjacency_matrix": 0},
                "keep_keys": [f"{t}_{k}" for t in pairs for k in ("indices", "targets")]
                + ["graph_edit_distance", "dgi", "pairwise_similarity_indices", "pairwise_similarity_targets"],
            },
            "NumpyPadding": {
                "name_value_pairs": {**{k: v for t in pairs for k, v in ((f"{t}_indices", 0), (f"{t}_targets", -100))},
                                     "graph_edit_distance": -100, "pairwise_similarity_indices": 0,
                                     "pairwise_similarity_targets": -100},
                "only_selected_items": False,
            },
        },
        "data_process": {
            "TextlineEncoding": {"is_normalized_text": True},
            "HeuristicGraphBuilder": {"num_edges": 6, "edge_type": "normal_binary"},
            "NodeLabeling": {},
            "NodeDropAugmentor": {"drop_rate": 0.15, "seed": 0},
            "DGINegativeSampling": {"seed": 0},
            "SSLLabeling": {"tasks": list(SSL_LABELS)},
        },
        "augmentations": {},
    }


def ssl_config(base, tmp, name, model_type, model_args, procedure, training, validation, **extra):
    """The train phase's recipe (``base``: Adam 5e-3, clip 5.0, seed 0) for
    one epoch of a leg of the ssl phase."""
    config = copy.deepcopy(base)
    config.update(experiment_name=f"ssl-{name}", num_epochs=1, output_dir=os.path.join(tmp, name), **extra)
    config["model"] = {"type": model_type, "args": model_args}
    config["procedure"] = procedure
    config["data_config"]["training"], config["data_config"]["validation"] = training, validation
    config["logging"] = {"use_tensorboard": False, "summary_dir_name": "summary"}
    return config


def train_leg(torch, warper, tag: str, steps: int, expected: dict):
    """``warper.train()`` with every launch count set to 0 just before it
    and read just after: the launches (``expected``), ``steps`` finite step
    losses, and the seconds it took."""
    reset_counts()
    start = time.perf_counter()
    warper.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launched = counts(("K3", "K1", "K2", *D_COUNTS))
    require(launched == expected, f"ssl {tag} launched {launched}, expected {expected}")
    losses = series(warper, "Train/step_loss")
    val_loss = series(warper, "Validation/loss")
    require(len(losses) == steps and all(math.isfinite(v) for v in losses + val_loss),
            f"ssl {tag}: train losses {losses}, validation losses {val_loss}")
    return {"wall_s": wall, "launches": launched, "losses": losses, "validation_loss": val_loss,
            "single_steps": dict(warper.trainer.single_steps)}


def ssl_launches(d_a_step: int, steps: int, **kernels):
    """No K1, K2 or K3 but ``kernels``; D ``d_a_step`` times a step each way."""
    return {"K3": 0, "K1": 0, "K2": 0, **kernels, **dict.fromkeys(D_COUNTS, d_a_step * steps)}


GRAPH_PROCEDURE = {"type": "GraphClassificationProcedure", "args": {"n_graph_classes": GRAPH_CLASSES}}


@contextlib.contextmanager
def graph_labels():
    """``PageGraphLabel`` among the port's processors while the block runs:
    a graph label of GRAPH_CLASSES classes, the page's characters."""
    from grl_torch.data import processors

    class PageGraphLabel(processors.BaseDataProcess):
        def __call__(self, sample):
            sample["graph_label"] = sum(len(line["text"]) for line in sample["label"].values()) % GRAPH_CLASSES
            return sample

    processors.PageGraphLabel = PageGraphLabel
    try:
        yield
    finally:
        del processors.PageGraphLabel


def graph_split(split):
    """A KV split that also labels each page's graph (``graph_labels``)."""
    split = copy.deepcopy(split)
    split["data_process"]["PageGraphLabel"] = {}
    split["data_collate"]["BucketPadding"]["only_selected_items"] = False
    return split


def phase_ssl(torch, card: str):
    """The self-supervised family through ``GNNLearningWarper.train`` at the
    sumi width on the train phase's pages, each leg with its launch counts
    set to 0 just before it and read just after."""
    import grl_torch
    from grl_torch.models import Rngs, create_model
    from grl_torch.trainer.procedures import BaseProcedure
    from grl_torch.utils.checkpoint import CheckpointHandler

    import numpy as np

    # SSLLabeling samples its pairs from numpy's global generator.
    np.random.seed(0)
    tmp = tempfile.mkdtemp(prefix="grl_torch_ssl_")
    dirs, classes_path, charset_path = write_training_files(tmp)
    base = train_config(tmp, dirs, classes_path, charset_path)
    kv_train, kv_val = base["data_config"]["training"], base["data_config"]["validation"]
    ssl_train = ssl_split(dirs["training"], classes_path, charset_path, shuffle=True)
    ssl_val = ssl_split(dirs["validation"], classes_path, charset_path, shuffle=False)
    ssl_args = {key: base["model"]["args"][key] for key in ("input_dim", "output_dim", "num_edges", "net_size",
                                                            "dropout_rate")}
    ft_args = base["model"]["args"]
    record = {"launches": {}}
    log(f"[ssl] SSLGCN {ssl_args}; {TRAIN_PAGES} training + {VAL_PAGES} validation pages, batch {B}, one epoch "
        f"a leg; fine-tuned flagship {ft_args}")

    # 1. SSL pretraining: five tasks, float32, no K1/K2/K3; the epoch's last
    # SSL_PROFILE_STEPS + 1 steps traced.
    config = ssl_config(base, tmp, "pretrain", "SSLGCN", ssl_args,
                        {"type": "SSLPretrainProcedure", "args": {"tasks": SSL_TASKS}}, ssl_train, ssl_val)
    config["logging"]["profile"] = {"start_step": SSL_PROFILE_START, "num_steps": SSL_PROFILE_STEPS}
    pre = grl_torch.GNNLearningWarper(config=config)
    initial = params_of(pre.model)
    d_a_step = SSL_DROPOUTS_A_PASS * sum(SSL_TRUNK_PASSES[t] for t in SSL_TASKS)
    leg = train_leg(torch, pre, "pretrain", SSL_STEPS, ssl_launches(d_a_step, SSL_STEPS))
    trained = tuple(["trunk."] + [f"head_{t}." for t in SSL_TASKS])
    changed = {n for n, p in params_of(pre.model).items() if not torch.equal(initial[n], p)}
    require(changed == {n for n in initial if n.startswith(trained)},
            f"pretraining changed {sorted(changed)}; expected the trunk and the heads of {SSL_TASKS} exactly")
    pre_checkpoint = os.path.join(pre.trainer.model_dir, CheckpointHandler.LATEST)
    saved = CheckpointHandler().restore_checkpoint(pre_checkpoint, map_location="cuda")["model"]
    require(set(saved) == set(pre.model.state_dict()), f"the SSLGCN checkpoint holds {sorted(saved)}")
    batch = next(iter(pre.trainer.train_loader))
    N = batch["textline_encoding"].shape[1]
    require(N == 256, f"SSL batches padded to N={N}")
    steps_per_s = [v / (B * N) for v in series(pre, "Train/nodes_per_sec")]
    data = pre.trainer._task_batch(batch)
    for _ in range(2):
        pre.trainer._ssl_fn(data)
    torch.cuda.synchronize()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(SSL_TIMED_STEPS):
        pre.trainer._ssl_fn(data)
    end.record()
    torch.cuda.synchronize()
    step_ms = begin.elapsed_time(end) / SSL_TIMED_STEPS
    trace = os.path.join(pre.config["output_dir"], "traces",
                         f"steps_{SSL_PROFILE_START}_{SSL_PROFILE_START + SSL_PROFILE_STEPS}.json")
    idle, busy_ms, window_ms = device_idle_share(trace)
    traced_steps = SSL_PROFILE_STEPS + 1
    dataset = pre.trainer.train_loader.dataset
    with timed_processors(dataset) as stage_s:
        for index in range(SSL_LABEL_PAGES):
            dataset[index]
    page_s = sum(stage_s.values()) / SSL_LABEL_PAGES
    label_s = stage_s["SSLLabeling"] / SSL_LABEL_PAGES
    record["pretrain"] = {**leg, "steps_per_s": steps_per_s, "step_ms": step_ms, "idle_share": idle,
                          "traced_busy_ms_a_step": busy_ms / traced_steps,
                          "traced_window_ms_a_step": window_ms / traced_steps, "host_page_s": page_s,
                          "host_stage_s": {k: v / SSL_LABEL_PAGES for k, v in stage_s.items()},
                          "changed": len(changed)}
    record["launches"]["pretrain"] = leg["launches"]
    log(f"[ssl] pretraining {SSL_TASKS}: {SSL_STEPS} steps + {SSL_VAL_BATCHES} validation batches in "
        f"{leg['wall_s']:.3f} s, steps/s {[round(v, 3) for v in steps_per_s]} (B={B}, N={N}); launches "
        f"{leg['launches']} (D {d_a_step} a step each way); losses {[round(v, 4) for v in leg['losses']]}; "
        f"{len(changed)} parameter tensors changed (trunk and the used heads)")
    log(f"[ssl] {card}: one SSL step (6 trunk passes forward and backward, clip, Adam, the monitoring forward; "
        f"float32) {step_ms:.3f} ms on the card (CUDA events, mean of {SSL_TIMED_STEPS}); traced steps "
        f"{SSL_PROFILE_START}..{SSL_PROFILE_START + SSL_PROFILE_STEPS}: device busy {busy_ms / traced_steps:.3f} ms "
        f"of {window_ms / traced_steps:.3f} ms a step, idle share "
        + ("not measured (no device events in the trace)" if idle is None else f"{idle:.4f}")
        + f"; host data chain "
        f"{page_s:.4f} s a page, of which SSLLabeling {label_s:.4f} s "
        f"({ {k: round(v / SSL_LABEL_PAGES, 4) for k, v in stage_s.items()} } s a page, {SSL_LABEL_PAGES} pages)")

    # 2. DGI with node_property: the discriminator trains beside the encoder.
    dgi_dir = os.path.join(tmp, "dgi_training")
    os.makedirs(dgi_dir)
    for name in sorted(os.listdir(dirs["training"]))[:DGI_PAGES]:
        os.symlink(os.path.join(dirs["training"], name), os.path.join(dgi_dir, name))
    dgi = grl_torch.GNNLearningWarper(config=ssl_config(
        base, tmp, "dgi", "SSLGCN", ssl_args, {"type": "SSLPretrainProcedure", "args": {"tasks": DGI_TASKS}},
        ssl_split(dgi_dir, classes_path, charset_path, shuffle=True), ssl_val))
    bilinear = dgi.trainer.dgi.discriminator.bilinear.detach().clone()
    dgi_steps = DGI_PAGES // B
    d_a_step = SSL_DROPOUTS_A_PASS * sum(SSL_TRUNK_PASSES[t] for t in DGI_TASKS)
    leg = train_leg(torch, dgi, "dgi", dgi_steps, ssl_launches(d_a_step, dgi_steps))
    require(not torch.equal(bilinear, dgi.trainer.dgi.discriminator.bilinear), "DGI's bilinear did not change")
    dgi_checkpoint = os.path.join(dgi.trainer.model_dir, CheckpointHandler.LATEST)
    keys = set(CheckpointHandler().restore_checkpoint(dgi_checkpoint)["model"])
    require("discriminator.bilinear" in keys and all(k.startswith(("encoder.", "discriminator.")) for k in keys),
            f"the DGI checkpoint holds {sorted(keys)}")
    record["dgi"] = leg
    record["launches"]["dgi"] = leg["launches"]
    log(f"[ssl] DGI {DGI_TASKS}: {dgi_steps} steps in {leg['wall_s']:.3f} s, launches {leg['launches']}; losses "
        f"{[round(v, 4) for v in leg['losses']]}; discriminator.bilinear changed; checkpoint of "
        f"{len(keys)} encoder.* / discriminator.* tensors")

    # 3. Fine-tuning the flagship on K1/K2/K3 from the pretraining's checkpoint.
    def finetune(name, checkpoint):
        return grl_torch.GNNLearningWarper(config=ssl_config(
            base, tmp, name, "GraphCNNDropEdge", ft_args, {"type": "FinetuneKVProcedure", "args": {}}, kv_train,
            kv_val, optimize_settings={"ssl_pretrain_path": checkpoint}))

    ft = finetune("finetune", pre_checkpoint)
    ft.trainer._ensure_initialized()
    require(ft.trainer.loaded == (FINETUNE_LOADED["SSLGCN"], 1),
            f"fine-tuning loaded {ft.trainer.loaded} (parameters, buffers), expected "
            f"({FINETUNE_LOADED['SSLGCN']}, 1)")
    loaded = {k: v.clone() for k, v in ft.model.state_dict().items()}
    trunk = [k for k in loaded if k.startswith("trunk.")]
    require(all(torch.equal(loaded[k], saved[k]) for k in trunk), "the fine-tuned trunk is not the checkpoint's")
    expected = {"K1": 3 * SSL_STEPS, "K2": 3 * SSL_STEPS, "K3": 3 * SSL_VAL_BATCHES,
                **dict.fromkeys(D_COUNTS, DROPOUTS_A_FORWARD * SSL_STEPS)}
    leg = train_leg(torch, ft, "finetune", SSL_STEPS, expected)
    routes = route_counts()
    require(routes["K3"]["sm90"] == expected["K3"] and routes["K2"]["sm90"] == expected["K2"],
            f"fine-tuning ran K3/K2 by route {routes}, expected all on dropedge_sm90.cu")
    batches = fixed_batches(ft.trainer, 2)
    model = create_model("GraphCNNDropEdge", **ft_args, device="cuda", generator=torch.Generator().manual_seed(1))
    model.load_state_dict(loaded)
    learner = BaseProcedure(model, {**ft.config, "output_dir": os.path.join(tmp, "finetune-learn")}, device="cuda")
    learner.init_state()
    learn_step = learner.build_train_step(NUM_CLASSES * 2 + 1, (-100,))
    rngs = Rngs.from_seed(3, torch.device("cuda"))
    V, A, labels = batches[0]
    learn = [float(learn_step(V, A, labels, rngs, 1.0)[0]) for _ in range(LEARN_STEPS)]
    tail = sum(learn[-5:]) / 5
    log(f"[ssl] fine-tuning from the pretrained trunk ({ft.trainer.loaded[0]} parameter tensors and the RanPAC "
        f"buffer loaded, the trunk equal to the checkpoint's): {SSL_STEPS} steps + {SSL_VAL_BATCHES} validation "
        f"batches in {leg['wall_s']:.3f} s, launches {leg['launches']} (by route {routes}); losses "
        f"{[round(v, 4) for v in leg['losses']]}; learning check, {LEARN_STEPS} steps on one batch from the "
        f"loaded state: first loss {learn[0]:.4f}, mean of the last 5 {tail:.4f} = {tail / learn[0]:.4f} of it "
        f"(need < {LEARN_SHARE})")
    require(tail < LEARN_SHARE * learn[0], f"fine-tune learning check failed: {learn}")
    # Kernel against plain over two steps, under STEP_LIMITS, from the
    # weights the learning check reached (the loaded state after its 20
    # steps): from the loaded state itself (first loss in the thousands, so
    # the clip leaves most gradient entries near Adam's eps) a held entry can
    # land lr/10 apart at step 2 from summation order alone (PERF.md §6).
    # Beside it, from the loaded state, kernel against plain and the plain
    # path summed in float64 against plain, in float32, recorded.
    learned = {k: v.detach().clone() for k, v in model.state_dict().items()}
    comparison, failures = {}, []
    for dtype_name in ("float32", "bfloat16"):
        kernel = two_steps(torch, tmp, batches, dtype_name, plain=False, state=learned)
        plain = two_steps(torch, tmp, batches, dtype_name, plain=True, state=learned)
        comparison[dtype_name] = rows = compare_steps(kernel, plain)
        for k, (row, limit) in enumerate(zip(rows, STEP_LIMITS[dtype_name])):
            log(f"[ssl] fine-tune kernel vs plain from the learned weights, {dtype_name}, step {k + 1}: loss rel "
                f"{row['loss_rel_diff']:.2e} (need <= {limit[0]}); held max diff {row['held_max_diff_of_scale']:.2e} "
                f"of scale (need <= {limit[1]}), {row['held_beyond_lr_10']} held entries lr/10 apart (need <= "
                f"{limit[3]}); moved share lr/10 apart {row['moved_share_beyond_lr_10']:.2e} (need <= {limit[2]}); "
                f"gradient rel {row['grad_rel_diff']:.2e} (need <= {limit[4]})")
        failures += [f"fine-tune kernel vs plain {dtype_name} step {k + 1}: {rows[k]}"
                     for k in step_failures(rows, STEP_LIMITS[dtype_name])]
    require(not failures, "; ".join(failures))
    plain = two_steps(torch, tmp, batches, "float32", plain=True, state=loaded)
    from_loaded = {
        "kernel_vs_plain": compare_steps(two_steps(torch, tmp, batches, "float32", plain=False, state=loaded), plain),
        "plain_float64_vs_plain": compare_steps(
            two_steps(torch, tmp, batches, "float32", plain=True, state=loaded, float64=True), plain),
    }
    for name, rows in from_loaded.items():
        log(f"[ssl] from the loaded weights, float32, {name.replace('_', ' ')} (recorded): " + "; ".join(
            f"step {k + 1} held max diff {r['held_max_diff_of_scale']:.2e} of scale, {r['held_beyond_lr_10']} held "
            f"entries lr/10 apart, moved share {r['moved_share_beyond_lr_10']:.2e}, gradient rel "
            f"{r['grad_rel_diff']:.2e}, within STEP_LIMITS: {k not in step_failures(rows, STEP_LIMITS['float32'])}"
            for k, r in enumerate(rows)))
    dgi_ft = finetune("finetune-dgi", dgi_checkpoint)
    dgi_ft.trainer._ensure_initialized()
    require(dgi_ft.trainer.loaded == (FINETUNE_LOADED["DGI"], 0),
            f"fine-tuning from the DGI checkpoint loaded {dgi_ft.trainer.loaded}, expected "
            f"({FINETUNE_LOADED['DGI']}, 0) as grl_tpu")
    record["finetune"] = {**leg, "loaded": ft.trainer.loaded, "dgi_loaded": dgi_ft.trainer.loaded, "routes": routes,
                          "learning_losses": learn, "kernel_vs_plain": comparison, "from_loaded": from_loaded}
    record["launches"]["finetune"] = leg["launches"]
    log(f"[ssl] fine-tuning from the DGI checkpoint loads {dgi_ft.trainer.loaded} (parameters, buffers), as grl_tpu")

    # 4. Serving the fine-tuned checkpoint on K3, held to the plain path.
    ft_checkpoint = os.path.join(ft.trainer.model_dir, CheckpointHandler.LATEST)
    pages = []
    for name in sorted(os.listdir(dirs["validation"])):
        with open(os.path.join(dirs["validation"], name)) as handle:
            pages.append([{"location": b["location"], "text": b["text"]} for b in json.load(handle)])

    def server(kernel_impl, dtype_name):
        return grl_torch.GNNLearningWarper(
            config=serve_config(tmp, classes_path, charset_path, ft_checkpoint, kernel_impl, dtype_name))

    main = server("pallas", "bfloat16")
    reset_counts()
    served = main.predict(pages)
    torch.cuda.synchronize()
    serve_launches = counts(("K3", "K1", "K2", *D_COUNTS))
    serve_batches = -(-len(pages) // B)
    require(serve_launches == {"K3": 3 * serve_batches, "K1": 0, "K2": 0, "D forward": 0, "D backward": 0},
            f"serving the fine-tuned checkpoint launched {serve_launches}")
    valid_keys = set(main.inferencer.id_to_class.values())
    agreement = {}
    for dtype_name in ("bfloat16", "float32"):
        kernel_pages = served if dtype_name == "bfloat16" else server("pallas", dtype_name).predict(pages)
        plain_pages = server("xla", dtype_name).predict(pages)
        for out in (kernel_pages, plain_pages):
            check_pages(out, pages, valid_keys)
        agreement[dtype_name] = agree(kernel_pages, plain_pages, dtype_name,
                                      "[ssl] serving the fine-tuned checkpoint, pallas vs xla")
    record["serve"] = {"pages": len(pages), "launches": serve_launches, "agreement": agreement}
    record["launches"]["serve"] = serve_launches
    log(f"[ssl] served {len(pages)} pages from the fine-tuned checkpoint: launches {serve_launches}")

    # 5. Joint training and graph classification on SSLGCN.
    config = ssl_config(base, tmp, "joint", "SSLGCN", ssl_args,
                        {"type": "JointTrainingProcedure", "args": {"tasks": JOINT_TASKS}}, kv_train, kv_val)
    config["data_config"].update(ssl_training=ssl_train, ssl_validation=ssl_val)
    joint = grl_torch.GNNLearningWarper(config=config)
    # The supervised forward runs the node-classification head's dropout too.
    d_a_step = SSL_DROPOUTS_A_PASS * (1 + sum(SSL_TRUNK_PASSES[t] for t in JOINT_TASKS)) + 1
    leg = train_leg(torch, joint, "joint", SSL_STEPS, ssl_launches(d_a_step, SSL_STEPS))
    require(joint.trainer.state.step == len(joint.trainer.train_loader) == SSL_STEPS,
            f"joint training took {joint.trainer.state.step} steps for {len(joint.trainer.train_loader)} batches")
    record["joint"] = leg
    record["launches"]["joint"] = leg["launches"]
    log(f"[ssl] joint training {JOINT_TASKS}: {SSL_STEPS} steps (the KV loader's batches) in {leg['wall_s']:.3f} s, "
        f"launches {leg['launches']}; losses {[round(v, 4) for v in leg['losses']]}")

    with graph_labels():
        graphs = grl_torch.GNNLearningWarper(config=ssl_config(
            base, tmp, "graph-classification", "SSLGCN", {**ssl_args, "n_graph_classes": GRAPH_CLASSES},
            GRAPH_PROCEDURE, graph_split(kv_train), graph_split(kv_val)))
        leg = train_leg(torch, graphs, "graph classification", SSL_STEPS,
                        ssl_launches(SSL_DROPOUTS_A_PASS, SSL_STEPS))
    require(graphs.trainer.num_classes == GRAPH_CLASSES, f"{graphs.trainer.num_classes} graph classes")
    record["graph_classification"] = leg
    record["launches"]["graph_classification"] = leg["launches"]
    log(f"[ssl] graph classification ({GRAPH_CLASSES} classes, task mode): {SSL_STEPS} steps in "
        f"{leg['wall_s']:.3f} s, launches {leg['launches']}; losses {[round(v, 4) for v in leg['losses']]}")
    return record


# ---------------------------------------------------------------------------
# zoo
# ---------------------------------------------------------------------------
# The dense zoo's legs: (registered type, constructor arguments beyond the
# sumi widths). Each network runs at its own default widths (rp_size 10000,
# 29 layers, kk 20), float32 and the plain aggregation, as grl_tpu builds
# them.
ZOO_LEGS = {
    "RobustGCN": ("RobustGCN", {}),
    "RPGraphCNNDropEdge": ("RPGraphCNNDropEdge", {}),
    "ModGCN": ("ModGCN", {}),
    "DeepRPGCN": ("DeepRPGCN", {}),
    "DeepRPRobustGCN": ("DeepRPRobustGCN", {}),
    "GATV2": ("GATV2", {}),
    "GATV2 v1": ("GATV2", {"use_v2": False}),
    "DGCNN": ("DGCNN", {}),
}
# D's launches a train step, (forward, backward), worked out from the code:
# RobustGCN: the trunk's four (after emb1 and each GraphConv,
# gcn_family.py:125,149) and two more (:276,278); RPGraphCNNDropEdge and
# ModGCN: the trunk's four and one on the head's input (:323, :366);
# DeepRPGCN: one after emb2 (deep_gcn.py:75); DeepRPRobustGCN: after gcn3,
# gcn6, gcn9 and the attention (:124,127,130,139); GATV2: five layers of 7
# relations, each dropping its attention weights (gatv2.py:83, 133) and, in
# V2, its input too (:123), whose backward does not run in gat_in, where the
# input is the batch's features and needs no gradient; DGCNN has none.
# Validation and serving run none.
ZOO_DROPOUTS = {"RobustGCN": (6, 6), "RPGraphCNNDropEdge": (5, 5), "ModGCN": (5, 5), "DeepRPGCN": (1, 1),
                "DeepRPRobustGCN": (4, 4), "GATV2": (70, 63), "GATV2 v1": (35, 35), "DGCNN": (0, 0)}
# The learning check's limit a network: LEARN_SHARE, or grl_tpu's ratio
# plus 0.1 where grl_tpu's own run of the recipe does not get under it.
# tests/test_torch_zoo_learning.py runs the recipe in both packages on the
# CPU at small widths (RobustGCN 0.94 and ModGCN 0.96 in grl_tpu there; a
# cosine head's logits lie in [-sigma, sigma]) and holds this table to it.
ZOO_LEARN_SHARE = {**dict.fromkeys(ZOO_LEGS, LEARN_SHARE), "RobustGCN": 1.04, "ModGCN": 1.06}
# The learning check's learning rate a network: the train recipe's 5e-3,
# but 1e-3 for the GAT networks. At 5e-3 both packages' GATV2 diverge at
# the sumi shape: grl_tpu's ratio 1.51 for V2 and for V1, the port's 1.37
# and 1.83, on 2 of these pages on the CPU (``python
# tests/test_torch_zoo_learning_gat.py --pages 2 --lr 5e-3``; at 1e-3 0.42
# and 0.40, the port's 0.42 and 0.41), and the port's V2 1.87 on the H100
# (PERF.md §6), as the full-graph check runs at 1e-3 for the config's 0.01.
ZOO_LEARN_LR = {**dict.fromkeys(ZOO_LEGS, 5e-3), "GATV2": 1e-3, "GATV2 v1": 1e-3}
# The leg at scan_steps 4: its chunks replay one captured CUDA graph.
ZOO_SCAN_LEG = "DeepRPRobustGCN"
ZOO_STEPS, ZOO_VAL_BATCHES = TRAIN_PAGES // B, VAL_PAGES // B
ZOO_SERVE_PAGES = 8
ZOO_TIMED_STEPS = 5
ZOO_BAYES = ("--init-points", "2", "--n-iter", "1", "--rp-size", "128")


def zoo_args(kind: str, extra: dict) -> dict:
    """A zoo network's constructor arguments at the sumi widths."""
    if kind == "GATV2":
        return {"input_feature": CHARSET_SIZE + 4, "no_A": L, "num_classes": NUM_CLASSES * 2 + 1, **extra}
    if kind == "DGCNN":
        return {"in_channels": CHARSET_SIZE + 4, "out_channels": NUM_CLASSES * 2 + 1, **extra}
    return {"input_dim": CHARSET_SIZE + 4, "output_dim": NUM_CLASSES * 2 + 1, "num_edges": L,
            "net_size": NET_SIZE, **extra}


def model_state(torch, proc):
    """Copies of ``proc``'s model state (parameters and buffers) and of its
    optimizer's state tensors."""
    optimizer = proc.state.optimizer
    return ({k: v.detach().clone() for k, v in proc.model.state_dict().items()},
            [v.clone() for state in optimizer.state.values() for v in state.values() if isinstance(v, torch.Tensor)])


def same_state(torch, a, b):
    """The names of the model tensors that differ between two
    ``model_state``s, and whether the optimizer states are equal."""
    differ = [k for k, v in a[0].items() if not torch.equal(v, b[0][k])]
    return differ, len(a[1]) == len(b[1]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def zoo_leg(torch, card: str, tmp: str, base, dirs, classes_path, charset_path, name: str):
    """One network of the zoo: train, serve, learn, D against plain D,
    timings."""
    import grl_torch
    from grl_torch.models import Rngs, create_model
    from grl_torch.trainer.procedures import BaseProcedure
    from grl_torch.utils.checkpoint import CheckpointHandler

    kind, extra = ZOO_LEGS[name]
    args = zoo_args(kind, extra)
    tag = name.replace(" ", "_")
    config = copy.deepcopy(base)
    config.update(experiment_name=f"zoo-{tag}", num_epochs=1, output_dir=os.path.join(tmp, tag))
    config["model"] = {"type": kind, "args": args}
    config["logging"] = {"use_tensorboard": False, "summary_dir_name": "summary"}
    warper = grl_torch.GNNLearningWarper(config=config)
    trainer, model = warper.trainer, warper.model
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    buffers = [k for k, _ in model.named_buffers() if k.endswith((".mean", ".var"))]
    d_forward, d_backward = ZOO_DROPOUTS[name]

    # The main path: every launch count starts at 0 here.
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    warper.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launched = counts(("K3", "K1", "K2", *D_COUNTS))
    expected = {"K3": 0, "K1": 0, "K2": 0, "D forward": d_forward * ZOO_STEPS, "D backward": d_backward * ZOO_STEPS}
    require(launched == expected, f"zoo {name} launched {launched}, expected {expected}")
    single_steps = dict(trainer.single_steps)
    losses = series(warper, "Train/step_loss")
    val_loss = series(warper, "Validation/loss")
    require(len(losses) == ZOO_STEPS == trainer.state.step and all(math.isfinite(v) for v in losses + val_loss),
            f"zoo {name}: train losses {losses}, validation losses {val_loss}, step {trainer.state.step}")
    grads = {n: p.grad for n, p in model.named_parameters()}
    unmoved = [n for n, p in model.named_parameters()
               if grads[n] is not None and bool((grads[n] != 0).any()) and torch.equal(initial[n], p.detach())]
    require(not unmoved, f"zoo {name}: parameters with a nonzero gradient that did not move: {unmoved}")
    final = {k: v.detach().clone() for k, v in model.state_dict().items()}
    still = [k for k in buffers if torch.equal(initial[k], final[k])]
    require(not still, f"zoo {name}: BatchNorm statistics that did not move: {still}")
    checkpoint = os.path.join(trainer.model_dir, CheckpointHandler.LATEST)
    saved = CheckpointHandler().restore_checkpoint(checkpoint, map_location="cuda")["model"]
    require(all(torch.equal(saved[k], final[k]) for k in buffers) and set(saved) == set(final),
            f"zoo {name}: the checkpoint's BatchNorm statistics are not the run's last")
    steps_per_s = [v / (B * 256) for v in series(warper, "Train/nodes_per_sec")]

    # Serving the checkpoint: eval mode from its running statistics.
    pages = []
    for page_name in sorted(os.listdir(dirs["validation"]))[:ZOO_SERVE_PAGES]:
        with open(os.path.join(dirs["validation"], page_name)) as handle:
            pages.append([{"location": b["location"], "text": b["text"]} for b in json.load(handle)])
    serve = serve_config(tmp, classes_path, charset_path, checkpoint, "xla", None)
    serve.update(experiment_name=f"zoo-serve-{tag}", model={"type": kind, "args": args})
    server = grl_torch.GNNLearningWarper(config=serve)
    require(all(torch.equal(server.model.state_dict()[k], final[k]) for k in buffers),
            f"zoo {name}: the server did not load the run's BatchNorm statistics")
    reset_counts()
    served = server.predict(pages)
    torch.cuda.synchronize()
    serve_launches = counts(("K3", "K1", "K2", *D_COUNTS))
    require(not any(serve_launches.values()), f"zoo {name}: serving launched {serve_launches}")
    check_pages(served, pages, set(server.inferencer.id_to_class.values()))
    del server

    # One step's device time, eager and replayed from its one-step graph
    # (the single step, _train_fn), the peak memory and the eager step's
    # device time by op.
    V, A, labels = fixed_batches(trainer, 1)[0]
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    timed = {}
    for which, step in (("replayed", trainer._train_fn),
                        ("eager", trainer.build_train_step(trainer.num_classes, trainer._ignore))):
        for _ in range(2):
            step(V, A, labels, trainer.rngs, trainer._lam)
        torch.cuda.synchronize()
        begin.record()
        for _ in range(ZOO_TIMED_STEPS):
            step(V, A, labels, trainer.rngs, trainer._lam)
        end.record()
        torch.cuda.synchronize()
        timed[which] = begin.elapsed_time(end) / ZOO_TIMED_STEPS
    step_ms, replayed_ms = timed["eager"], timed["replayed"]
    peak_gb = max(peak_gb, torch.cuda.max_memory_allocated() / 1e9)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(V, A, labels, trainer.rngs, trainer._lam)
        torch.cuda.synchronize()
    trace = os.path.join(tmp, f"{tag}_trace.json")
    prof.export_chrome_trace(trace)
    idle, busy_ms, window_ms = device_idle_share(trace)
    by_op = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                    if getattr(e, "device_time_total", 0) > 0), key=lambda item: -item[1])
    del warper, trainer, model

    # Learning check: 20 steps on one batch from fresh weights, at the
    # network's ZOO_LEARN_LR.
    learner_model = create_model(kind, **args, device="cuda", generator=torch.Generator().manual_seed(1))
    learn_config = copy.deepcopy(config)
    learn_config["optimizer"]["args"]["lr"] = ZOO_LEARN_LR[name]
    learner = BaseProcedure(learner_model, {**learn_config, "output_dir": os.path.join(tmp, f"{tag}-learn")},
                            device="cuda")
    learner.init_state()
    learn_step = learner.build_train_step(NUM_CLASSES * 2 + 1, (-100,))
    learner.rngs = Rngs.from_seed(3, torch.device("cuda"))
    learn = [float(learn_step(V, A, labels, learner.rngs, 1.0)[0]) for _ in range(LEARN_STEPS)]
    tail = sum(learn[-5:]) / 5
    limit = ZOO_LEARN_SHARE[name]
    require(all(math.isfinite(v) for v in learn) and tail < limit * learn[0],
            f"zoo {name}: learning check failed: {learn} (need the mean of the last 5 < {limit} of the first)")

    # One step with D against the same step with D's plain version, from
    # the learned state, under deterministic algorithms: the same bits.
    snap = snapshot(torch, learner)
    runs = {}
    with deterministic(torch, True):
        for which in ("kernel", "plain"):
            restore(torch, learner, snap)
            before = counts(D_COUNTS)
            with plain_dropout() if which == "plain" else contextlib.nullcontext():
                loss = float(learn_step(V, A, labels, learner.rngs, 1.0)[0])
            ran = {k: v - before[k] for k, v in counts(D_COUNTS).items()}
            runs[which] = (loss, model_state(torch, learner), ran)
    require(runs["kernel"][2] == ({"D forward": d_forward, "D backward": d_backward})
            and not any(runs["plain"][2].values()),
            f"zoo {name}: the step launched D {runs['kernel'][2]}, its plain version {runs['plain'][2]}")
    differ, optimizer_equal = same_state(torch, runs["kernel"][1], runs["plain"][1])
    require(runs["kernel"][0] == runs["plain"][0] and not differ and optimizer_equal,
            f"zoo {name}: D's step differs from plain D's: losses {runs['kernel'][0]} / {runs['plain'][0]}, "
            f"{differ[:6]}, optimizer equal {optimizer_equal}")
    del learner, learner_model, learn_step, snap

    log(f"[zoo] {card}: {name} ({kind}{f' {extra}' if extra else ''}): {ZOO_STEPS} steps + {ZOO_VAL_BATCHES} "
        f"validation batches in {wall:.3f} s, steps/s {[round(v, 3) for v in steps_per_s]}; launches {launched} "
        f"(D {d_forward} forward "
        f"and {d_backward} backward a step); losses {[round(v, 4) for v in losses]}; "
        f"{len(buffers)} BatchNorm statistics moved and served from the checkpoint; served {len(pages)} pages "
        f"with no launch")
    log(f"[zoo] {name} learning check, {LEARN_STEPS} steps on one batch at lr {ZOO_LEARN_LR[name]}: first loss "
        f"{learn[0]:.4f}, mean of "
        f"the last 5 {tail:.4f} = {tail / learn[0]:.4f} of it (need < {limit}); one step with D equal to it with "
        f"plain D bit for bit (loss {runs['kernel'][0]:.6f}, every parameter, buffer and Adam moment)")
    log(f"[zoo] {card}: {name} one train step (forward, backward, clip, Adam; float32, B={B}, N=256) "
        f"{step_ms:.3f} ms eagerly and {replayed_ms:.3f} ms replayed from its one-step graph on the card (CUDA "
        f"events, mean of {ZOO_TIMED_STEPS}); single steps of the epoch {single_steps}; peak device memory allocated "
        f"{peak_gb:.2f} GB; one traced step: device busy {busy_ms:.3f} ms of {window_ms:.3f} ms, idle share "
        + ("not measured (no device events in the trace)" if idle is None else f"{idle:.4f}")
        + "; device time by op (ops and the kernels under them):")
    for key, ms, count in by_op[:8]:
        log(f"[zoo]   {ms:8.3f} ms in {count:4d} launches: {key[:110]}")
    torch.cuda.empty_cache()
    return {"kind": kind, "args": extra, "wall_s": wall, "steps_per_s": steps_per_s, "launches": launched,
            "losses": losses, "validation_loss": val_loss, "batchnorm_buffers": len(buffers),
            "serve_launches": serve_launches, "step_ms": step_ms, "replayed_step_ms": replayed_ms,
            "single_steps": single_steps, "peak_gb": peak_gb, "traced_busy_ms": busy_ms,
            "traced_window_ms": window_ms, "idle_share": idle,
            "by_op": by_op[:12], "learning_losses": learn, "learn_share": tail / learn[0], "learn_limit": limit,
            "learn_lr": ZOO_LEARN_LR[name],
            "d_vs_plain_loss": runs["kernel"][0]}


def zoo_scan(torch, card: str, tmp: str, base, name: str):
    """``ZOO_SCAN_LEG`` at scan_steps 4: the second chunk of the epoch a
    replay of a captured CUDA graph (BatchNorm's in-place updates and the
    one-element lambda tensors inside it), then a chunk replayed against
    the same chunk run eagerly from the same state, bit for bit:
    parameters, BatchNorm buffers and Adam state."""
    import grl_torch

    kind, extra = ZOO_LEGS[name]
    config = copy.deepcopy(base)
    config.update(experiment_name="zoo-scan", num_epochs=1, output_dir=os.path.join(tmp, "zoo-scan"), scan_steps=SCAN_K)
    config["model"] = {"type": kind, "args": zoo_args(kind, extra)}
    config["logging"] = {"use_tensorboard": False, "summary_dir_name": "summary"}
    warper = grl_torch.GNNLearningWarper(config=config)
    trainer = warper.trainer
    d_forward, d_backward = ZOO_DROPOUTS[name]
    reset_counts()
    warper.train()
    torch.cuda.synchronize()
    launched = counts(("K3", "K1", "K2", *D_COUNTS))
    runner = trainer.chunk_runner()
    expected = {"K3": 0, "K1": 0, "K2": 0, "D forward": d_forward * ZOO_STEPS, "D backward": d_backward * ZOO_STEPS}
    require(runner.replays == ZOO_STEPS // SCAN_K - 1 and len(runner.graphs) == 1 and launched == expected,
            f"zoo scan: {runner.replays} replays of {len(runner.graphs)} graphs, launches {launched} (expected "
            f"{expected})")
    losses = series(warper, "Train/step_loss")
    require(len(losses) == ZOO_STEPS and all(math.isfinite(v) for v in losses), f"zoo scan losses {losses}")
    items = []
    for batch in trainer.train_loader:
        V, A, labels = trainer._host_batch(batch)
        items.append((V, A, labels, 0.3 + 0.1 * len(items)))
        if len(items) == SCAN_K:
            break
    snap = snapshot(torch, trainer)
    eager_losses = [float(v) for v in runner.eager(trainer.load_chunk(items)[1])[0]]
    eager = model_state(torch, trainer)
    restore(torch, trainer, snap)
    before = runner.replays
    replay_losses = [float(v) for v in trainer.run_chunk(items)[0]]
    replayed = model_state(torch, trainer)
    differ, optimizer_equal = same_state(torch, eager, replayed)
    require(runner.replays == before + 1, "zoo scan: the chunk against its eager run did not replay the graph")
    require(replay_losses == eager_losses and not differ and optimizer_equal,
            f"zoo scan: a replayed chunk differs from the same chunk run eagerly: losses {replay_losses} / "
            f"{eager_losses}, {differ[:6]}, Adam state equal {optimizer_equal}")
    setup = next(iter(runner.setup.values()))
    log(f"[zoo] {name} at scan_steps {SCAN_K}: {ZOO_STEPS} steps, {runner.replays - 1} replay(s) in the epoch and one "
        f"against the eager chunk; launches {launched}; losses {[round(v, 4) for v in losses]}; the replayed chunk "
        f"(lambdas {[item[3] for item in items]}) equal to it run eagerly bit for bit: losses, "
        f"{len(eager[0])} parameters and buffers, Adam state; warm-up {setup['warmup_s']:.3f} s, capture "
        f"{setup['capture_s']:.3f} s")
    del warper, trainer, runner
    torch.cuda.empty_cache()
    return {"launches": launched, "losses": losses, "replay_losses": replay_losses, "setup": setup}


def zoo_bayes(card: str, tmp: str):
    """``python -m grl_torch.bayes_training`` as a subprocess from a scratch
    directory, on a copy of configs/synthetic_kv.yaml at one epoch."""
    import yaml

    with open(os.path.join(REPO, "configs", "synthetic_kv.yaml")) as handle:
        cfg = yaml.safe_load(handle)
    cfg["num_epochs"] = 1
    work = os.path.join(tmp, "bayes")
    os.makedirs(work)
    path = os.path.join(work, "synthetic_kv.yaml")
    with open(path, "w") as handle:
        yaml.safe_dump(cfg, handle)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    start = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "grl_torch.bayes_training", "--config", path, *ZOO_BAYES], cwd=work,
                          env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - start
    best = [line for line in done.stdout.splitlines() if line.startswith("Best parameters: lambda=")]
    log(f"[zoo] {card}: python -m grl_torch.bayes_training {' '.join(ZOO_BAYES)} (synthetic_kv, 1 epoch a probe): "
        f"exit {done.returncode} in {seconds:.2f} s; {best}")
    require(done.returncode == 0 and len(best) == 1,
            f"bayes_training exited {done.returncode}: {done.stdout[-1500:]} {done.stderr[-3000:]}")
    return {"seconds": seconds, "best": best[0]}


def phase_zoo(torch, card: str):
    """The dense zoo through ``GNNLearningWarper.train`` -> ``KVProcedure`` and
    ``GNNLearningWarper.predict`` at the sumi width on the train phase's
    pages, each leg with its launch counts set to 0 just before it and read
    just after; ``ZOO_SCAN_LEG`` at scan_steps 4; the Bayesian lambda search
    entry point."""
    import numpy as np

    np.random.seed(0)
    tmp = tempfile.mkdtemp(prefix="grl_torch_zoo_")
    dirs, classes_path, charset_path = write_training_files(tmp)
    base = train_config(tmp, dirs, classes_path, charset_path)
    log(f"[zoo] {len(ZOO_LEGS)} networks at the sumi width (input 4369, 53 classes, 6 relations, net_size "
        f"{NET_SIZE}, their own default widths), float32; {TRAIN_PAGES} training + {VAL_PAGES} validation pages, "
        f"batch {B}, one epoch a leg")
    record = {"launches": {}}
    for name in ZOO_LEGS:
        record[name] = leg = zoo_leg(torch, card, tmp, base, dirs, classes_path, charset_path, name)
        record["launches"][name] = leg["launches"]
    record["scan"] = zoo_scan(torch, card, tmp, base, ZOO_SCAN_LEG)
    record["launches"]["scan"] = record["scan"]["launches"]
    record["bayes_training"] = zoo_bayes(card, tmp)
    return record


# ---------------------------------------------------------------------------
# full_graph and ell
# ---------------------------------------------------------------------------
def sparse_counts():
    """Every kernel's launches as the device ran them (K7's by direction
    and by route too: ``tile.ROUTES``)."""
    from grl_torch.ops.ell import DIRECTIONS
    from grl_torch.ops.tile import ROUTES

    return counts(("K5 forward", "K5 backward", "K4", *K4B, *(f"K6 {d}" for d in DIRECTIONS),
                   "K7", *(f"K7 {d}" for d in DIRECTIONS), *(f"K7 {r}" for r in ROUTES), "K3", "K1", "K2",
                   *D_COUNTS))


# Launch counts of K4b's two walks and of D's two directions.
K4B = ("K4b receivers", "K4b senders")
D_COUNTS = ("D forward", "D backward")
# Dropout layers a train-mode forward of the flagship runs: after emb1, after
# each of the three GraphConvs and in the head (gcn_family.py:133,142,241).
DROPOUTS_A_FORWARD = 5


def expected_launches(trainer, steps: int, evals: int, dropout_rate=None, dtype_name=None):
    """The kernel launches of ``steps`` train steps and ``evals`` eval
    forwards of ``trainer``'s model on its planned graph: a forward runs
    three GraphConvs (gcn3 through the projected tables where the kernel
    planned them) and K4 when the graph carries it; the backward takes
    each GraphConv's input gradient (gcn1's too: emb1 is trained) and
    K4b's two walks. The tile kernel runs K7 on its tiles, every launch on
    the route of its tile dtype under the compute dtype (``dtype_name``, by
    default the model's), and K6 on its residual in each of those
    directions (K6 alone where it planned no tile). A train step's forward
    runs D five times where the dropout rate (by default the model's) is
    above 0, and its backward as often; an eval runs none."""
    import torch

    from grl_torch.ops.ell import ELLGraphKernel
    from grl_torch.ops.tile import TileGraphKernel, route_for

    expected = dict.fromkeys(sparse_counts(), 0)
    if dropout_rate is None:
        dropout_rate = trainer.model.dropout.rate
    if dropout_rate > 0:
        expected.update(dict.fromkeys(D_COUNTS, DROPOUTS_A_FORWARD * steps))
    graph = trainer.graph
    forwards = steps + evals
    if isinstance(graph.kernel, (ELLGraphKernel, TileGraphKernel)):
        plain_convs = 2 if graph.kernel.tables.proj is not None else 3
        by_direction = {"forward": plain_convs * forwards, "backward": plain_convs * steps,
                        "projected forward": (3 - plain_convs) * forwards,
                        "projected backward": (3 - plain_convs) * steps}
        tiles = isinstance(graph.kernel, TileGraphKernel) and graph.kernel.tiles_total > 0
        if not tiles or graph.kernel._ell is not None:
            expected.update({f"K6 {d}": n for d, n in by_direction.items()})
        if tiles:
            expected.update({f"K7 {d}": n for d, n in by_direction.items()})
            expected["K7"] = sum(by_direction.values())
            dtype = getattr(torch, dtype_name or trainer.model.compute_dtype or "float32")
            expected[f"K7 {route_for(graph.kernel.tables.fwd.tiles.dtype, dtype)}"] = expected["K7"]
    elif graph.kernel is not None:
        expected.update({"K5 forward": 3 * forwards, "K5 backward": 3 * steps})
    if graph.atten_kernel is not None:
        expected["K4"] = forwards
        expected.update(dict.fromkeys(K4B, steps))
    return expected


class swapped:
    """Sets module attributes for the kernel-versus-plain comparison only,
    as ``(module, name, value)`` triples; restored on exit."""

    def __init__(self, *changes):
        self.changes = changes

    def __enter__(self):
        self.saved = [(module, name, getattr(module, name)) for module, name, _ in self.changes]
        for module, name, value in self.changes:
            setattr(module, name, value)

    def __exit__(self, *exc):
        for module, name, value in self.saved:
            setattr(module, name, value)


def plain_d():
    """D's launcher, ``apply_dropout``, as the swap to its plain version."""
    from grl_torch.ops import dropout

    return dropout, "apply_dropout", lambda x, seed, rate, direction: dropout.dropout_reference(x, seed, rate)


def plain_sparse():
    """The K5, K4, K4b, K6, K7 and D launchers swapped for their plain
    versions."""
    from grl_torch.ops import csr_spmm, ell, sparse_attention, tile

    return swapped((csr_spmm, "csr_accumulate", csr_spmm.csr_accumulate_reference),
                   (sparse_attention, "attend_forward", sparse_attention.attend_reference),
                   (sparse_attention, "attend_grad", sparse_attention.attend_backward_walks),
                   (ell, "ell_accumulate", ell.ell_accumulate_reference),
                   (tile, "tile_accumulate", tile.tile_apply_reference),
                   plain_d())


def faulty(kernel: str, seed_shift: int = 0, rate=None):
    """K5 or K6 (or, on CPU tensors, its plain version) with its mask drawn
    from another seed or at another rate: a fault the step limits must
    catch."""
    from grl_torch.ops import csr_spmm, ell

    module, name = {"K5": (csr_spmm, "csr_accumulate"), "K6": (ell, "ell_accumulate")}[kernel]
    launch = getattr(module, name)

    def wrong(X, tables, seed=0, rate_=0.0):
        return launch(X, tables, seed + seed_shift, rate_ if rate is None else rate)

    return swapped((module, name, wrong))


def k7_fault(kind: str):
    """K7 (or, on CPU tensors, its plain version) with a planted fault the
    step limits must catch: ``"mix"``, every relation's mask keyed on the
    next relation's seed mix (a wrong ``_rel_seed_mix``); ``"swap"``, the
    backward's mask keyed on swapped endpoints ``(send, recv)``."""
    import torch

    from grl_torch.ops import tile

    launch = tile.tile_accumulate

    def wrong(X, plan, seed=0, rate=0.0, direction="forward"):
        if kind == "mix":
            import numpy as np

            mixes = np.array([tile._rel_seed_mix(r + 1) for r in range(plan.L)], np.uint32).view(np.int32)
            plan = plan._replace(rel_mix=torch.from_numpy(mixes).to(plan.rel_mix.device))
        elif "backward" in direction:
            plan = plan._replace(transposed=not plan.transposed)
        return launch(X, plan, seed, rate, direction)

    return swapped((tile, "tile_accumulate", wrong))


def k4b_pairs_off():
    """K4b with its sender walk gathering each edge's pair from the next
    slot of the transposed CSR (``t_edge`` rolled by one): a fault in the
    table the kernel depends on, which the step limits must catch."""
    from grl_torch.ops import sparse_attention

    launch = sparse_attention.attend_grad

    def wrong(f, g, h, dout, plan):
        return launch(f, g, h, dout, plan._replace(t_edge=plan.t_edge.roll(1)))

    return swapped((sparse_attention, "attend_grad", wrong))


def k4b_without_mean():
    """K4b with the ``sum alpha dalpha`` term dropped from dscore where the
    receiver walk writes it, once, into the pair buffer: the walk's pairs
    become ``(alpha dalpha, alpha)``, df is summed from them, and the
    sender walk (K4b's kernel on CUDA tensors, its plain version on CPU
    ones) reads them. It changes only df and dg, so it moves only the
    gradients that reach f and g, a fault the limits on the score
    projections' gradients must catch."""
    import torch

    from grl_torch.ops import sparse_attention as sa
    from grl_torch.ops.segment import segment_sum

    def wrong(f, g, h, dout, plan):
        on_card = h.device.type == "cuda"
        _, pairs = (sa._launch_receivers if on_card else sa.receiver_walk)(f, g, h, dout, plan)
        s, r, N = plan.senders.long(), plan.receivers.long(), plan.num_nodes
        alpha = pairs[:, 1]
        pairs = torch.stack([alpha * (dout.float()[r] * h.float()[s]).sum(-1), alpha], dim=-1)
        df = segment_sum(pairs[:, :1] * g.float()[s], r, N).to(f.dtype)
        dg, dh = (sa._launch_senders if on_card else sa.sender_walk)(f, dout, pairs, plan)
        return df, dg, dh

    return swapped((sa, "attend_grad", wrong))


@contextlib.contextmanager
def deterministic(torch, on: bool):
    """torch.use_deterministic_algorithms set to ``on`` (warnings only
    where an op has no deterministic version); restored on exit."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def procedure_copy(torch, trainer, seed: int, lr: float, **model_args):
    """A shallow copy of ``trainer`` (the same planned graph, features and
    labels) with a model of its own, drawn from ``seed``, a fresh Adam at
    ``lr`` and generators seeded ``seed``."""
    from grl_torch.models import Rngs, create_model
    from grl_torch.trainer.optimizers import set_learning_rate

    proc = copy.copy(trainer)
    proc.model = create_model("GraphCNNDropEdge", **{**trainer.config["model"]["args"], **model_args},
                              device=trainer.device, generator=torch.Generator().manual_seed(seed))
    proc.state = None
    proc.init_state()
    set_learning_rate(proc.state.optimizer, lr)
    proc.rngs = Rngs.from_seed(seed, trainer.device)
    return proc


def two_full_graph_steps(torch, trainer, start, dtype_name: str, lr: float, swap=None, dropout_rate: float = 0.0,
                         swapped_steps: int = 2):
    """Two full-graph train steps from the weights ``start`` at ``lr``,
    ``dropout_rate`` (0 by default) and DropEdge 0.3, masks from generators
    seeded 7, the first ``swapped_steps`` of them inside ``swap`` if given:
    losses, parameters before the first step and after each, each step's
    clipped gradients, and the sparse kernels' launches."""
    proc = procedure_copy(torch, trainer, 7, lr, compute_dtype=dtype_name,
                          dropout_rate=dropout_rate, edge_dropout_rate=RATE)
    proc.model.load_state_dict(start)
    before = sparse_counts()
    losses, snapshots, grads = [], [params_of(proc.model)], []
    for step in range(2):
        with swap if swap is not None and step < swapped_steps else contextlib.nullcontext():
            losses.append(float(proc.train_step()))
            snapshots.append(params_of(proc.model))
            grads.append({n: p.grad.float().clone() for n, p in proc.model.named_parameters()})
    launched = {k: v - before[k] for k, v in sparse_counts().items()}
    # The gradients reach through the kernels' backward to emb1 (and K4b's,
    # through dh: where a model's f and g are constant over the nodes, as in
    # a collapsed one, their gradient is zero in exact arithmetic).
    for name in ("trunk.emb1.linear.weight", "trunk.gcn1.h_weights", "trunk.self_atten.h.linear.weight"):
        require(name not in grads[0] or bool((grads[0][name] != 0).any()), f"{name} got no gradient")
    return losses, snapshots, grads, launched


def plain_dropout():
    """D's launcher alone swapped for its plain version."""
    return swapped(plain_d())


# Runs of the full-graph comparison: each is two steps, on the kernels or
# their plain versions, or with a fault planted in K5, K6 or K4b, at dropout
# 0 or, where the name says so, at the config's 0.5: (swap, dropout rate,
# the launch counts the swap takes off the kernels (ALL: every one), the
# steps it is in place for).
DROPOUT_ON = 0.5
ALL = None
FULL_GRAPH_RUNS = {
    "kernel": (lambda: None, 0.0, (), 2),
    "plain": (plain_sparse, 0.0, ALL, 2),
    "plain again": (plain_sparse, 0.0, ALL, 2),
    "kernel, dropout 0.5": (lambda: None, DROPOUT_ON, (), 2),
    "plain, dropout 0.5": (plain_sparse, DROPOUT_ON, ALL, 2),
    "plain D, dropout 0.5": (plain_dropout, DROPOUT_ON, D_COUNTS, 2),
    "plain step, then kernel step, dropout 0.5": (plain_sparse, DROPOUT_ON, ALL, 1),
    "K5 seed+1": (lambda: faulty("K5", seed_shift=1), 0.0, (), 2),
    "K5 rate 0.25": (lambda: faulty("K5", rate=0.25), 0.0, (), 2),
    "K6 seed+1": (lambda: faulty("K6", seed_shift=1), 0.0, (), 2),
    "K6 rate 0.25": (lambda: faulty("K6", rate=0.25), 0.0, (), 2),
    "K4b pairs one edge off": (k4b_pairs_off, 0.0, (), 2),
    "K4b without sum alpha dalpha": (k4b_without_mean, 0.0, K4B, 2),
    "K7 wrong relation mix": (lambda: k7_fault("mix"), 0.0, (), 2),
    "K7 backward mask on swapped endpoints": (lambda: k7_fault("swap"), 0.0, (), 2),
}
# (start, deterministic, run, reference run, what the run must do against
# the reference under FULL_GRAPH_STEP_LIMITS: "hold", "fail", "equal" (to the
# bit) or None, read only). The held pairs and the faults start from the
# learned weights; the pairs from the main path's initial weights, and the
# runs outside deterministic mode, show where the agreement of the paths is
# lost. At the config's dropout 0.5, D is held against its plain version
# with every other kernel on both sides, where the two must give the same
# bits, and all the kernels against all the plain versions for one step
# from one state: the plain path's first step, then the kernels' second
# (with Adam's moments in play) against the plain path's. Two steps of
# kernel against plain are not held there: at the first step a few emb1
# gradient entries lie within rounding of zero, below Adam's eps, and the
# summation order decides their sign, so Adam moves them apart by up to
# 0.6 lr; the second step runs from those other weights, and entries it
# holds move apart beyond lr/10. The plain path against itself, in other
# summation orders, lands on either side and breaks the limit as often
# (full_graph_spread.py; PERF.md).
FULL_GRAPH_PAIRS = [
    ("init", False, "kernel", "plain", None),
    ("init", False, "plain again", "plain", None),
    ("init", True, "kernel", "plain", None),
    ("init", True, "plain again", "plain", None),
    ("learned", False, "kernel", "plain", None),
    ("learned", False, "plain again", "plain", None),
    ("learned", True, "plain again", "plain", None),
    ("learned", True, "kernel", "plain", "hold"),
    ("learned", True, "kernel, dropout 0.5", "plain D, dropout 0.5", "equal"),
    ("learned", True, "plain step, then kernel step, dropout 0.5", "plain, dropout 0.5", "hold"),
    ("learned", True, "K5 seed+1", "plain", "fail"),
    ("learned", True, "K5 rate 0.25", "plain", "fail"),
    ("learned", True, "K4b pairs one edge off", "plain", "fail"),
    ("learned", True, "K4b without sum alpha dalpha", "plain", "fail"),
]
# The ell phase holds K6 the same way: from the learned weights in
# deterministic mode, where the plain path reproduces itself.
ELL_PAIRS = [
    ("learned", True, "plain again", "plain", None),
    ("learned", True, "kernel", "plain", "hold"),
    ("learned", True, "kernel, dropout 0.5", "plain D, dropout 0.5", "equal"),
    ("learned", True, "K6 seed+1", "plain", "fail"),
    ("learned", True, "K6 rate 0.25", "plain", "fail"),
]
# The tile phase holds K7 (with K6 on the residual) the same way, with its
# two planted faults.
TILE_PAIRS = [
    ("learned", True, "plain again", "plain", None),
    ("learned", True, "kernel", "plain", "hold"),
    ("learned", True, "kernel, dropout 0.5", "plain D, dropout 0.5", "equal"),
    ("learned", True, "K7 wrong relation mix", "plain", "fail"),
    ("learned", True, "K7 backward mask on swapped endpoints", "plain", "fail"),
]


def full_graph_comparisons(torch, trainer, starts, dtype_names=("float32", "bfloat16"), pairs=FULL_GRAPH_PAIRS,
                           tag: str = "full_graph"):
    """Every pair of ``pairs`` in each dtype, from ``starts`` (name ->
    (weights, lr)): the ``compare_steps`` rows of each pair and the failures
    of the pairs whose verdict is not what they must do."""
    results, failures = [], []
    for dtype_name in dtype_names:
        runs = {}

        def run(start, det, name):
            key = (start, det, name)
            if key not in runs:
                weights, lr = starts[start]
                swap, dropout_rate, swapped_out, swapped_steps = FULL_GRAPH_RUNS[name]
                with deterministic(torch, det):
                    runs[key] = two_full_graph_steps(torch, trainer, weights, dtype_name, lr, swap(), dropout_rate,
                                                     swapped_steps)
                expected = dict.fromkeys(sparse_counts(), 0)
                if trainer.device.type == "cuda":
                    off = expected_launches(trainer, swapped_steps, 0, dropout_rate, dtype_name)
                    expected = {k: v - off[k] if swapped_out is ALL or k in swapped_out else v
                                for k, v in expected_launches(trainer, 2, 0, dropout_rate, dtype_name).items()}
                require(runs[key][3] == expected, f"{name} full-graph steps launched {runs[key][3]}, "
                        f"expected {expected}")
            return runs[key]

        for start, det, name, reference, must in pairs:
            lr = starts[start][1]
            rows = compare_steps(run(start, det, name), run(start, det, reference), lr)
            failed = step_failures(rows, FULL_GRAPH_STEP_LIMITS[dtype_name], scores=True)
            exact = all(row["loss_rel_diff"] == row["grad_rel_diff"] == row["param_max_diff"] == 0 for row in rows)
            verdict = "equal" if must == "equal" and exact else ("fail" if failed else "hold")
            results.append({"start": start, "deterministic": det, "run": name, "reference": reference,
                            "dtype": dtype_name, "lr": lr, "must": must, "verdict": verdict, "rows": rows})
            for k, (row, limit) in enumerate(zip(rows, FULL_GRAPH_STEP_LIMITS[dtype_name])):
                log(
                    f"[{tag}] {name} vs {reference}, {dtype_name}, from {start} weights at lr {lr}, "
                    f"deterministic {det}, step {k + 1}: loss rel {row['loss_rel_diff']:.2e} (limit {limit[0]}); "
                    f"params max diff {row['param_max_diff']:.3e} = {row['param_max_diff_of_scale']:.2e} of scale "
                    f"{row['param_scale']:.3f} (held entries {row['held_max_diff_of_scale']:.2e}, limit "
                    f"{limit[1]}; {row['held_beyond_lr_10']} of {row['held']} beyond lr/10, limit {limit[3]}); moved "
                    f"share beyond lr/10 {row['moved_share_beyond_lr_10']:.2e} of {row['moved']} (limit {limit[2]}); "
                    f"gradient rel diff {row['grad_rel_diff']:.2e}, of the score projections "
                    f"{row['score_grad_rel_diff']:.2e} (limit {limit[4]})"
                )
            log(f"[{tag}] {name} vs {reference}, {dtype_name}, {start}, deterministic {det}: "
                + ("gives the same bits" if verdict == "equal" else f"{verdict}s the limits")
                + ("" if must is None else f" (must {must})"))
            if must is not None and verdict != must:
                failures.append(f"{tag} {name} vs {reference} ({dtype_name}, {start}, deterministic "
                                f"{det}) must {must} the limits: {rows}")
    return results, failures


def captured_chunk_check(torch, trainer, K: int, weights, tag: str):
    """One chunk of K steps replayed from a graph against the same K steps
    run eagerly from the same state (weights, Adam state, generator), on a
    copy of ``trainer`` from ``weights`` at lr 1e-3 with its own graph,
    under ``torch.use_deterministic_algorithms`` (outside it torch's own
    scatter-adds, such as ``index_add_``, may sum in an order that changes
    from run to run): losses and parameters must be equal bit for bit."""
    proc = procedure_copy(torch, trainer, 7, FULL_GRAPH_LEARN_LR)
    proc.model.load_state_dict(weights)
    with deterministic(torch, True):
        proc.train_steps(K)  # the warm-up, eager
        snap = snapshot(torch, proc)
        eager = [float(v) for v in proc.chunk_runner().eager(proc.chunk_body(K))]
        eager_params = params_of(proc.model)
        restore(torch, proc, snap)
        replayed = [float(v) for v in proc.train_steps(K)]
        torch.cuda.synchronize()
    require(proc.chunk_runner().replays == 1, f"{tag}: the chunk was not replayed")
    differing = [n for n, v in params_of(proc.model).items() if not torch.equal(v, eager_params[n])]
    log(f"[{tag}] replayed chunk of {K} steps vs the same steps eager from one state (deterministic "
        f"algorithms): losses equal {replayed == eager} ({replayed[-1]:.6f} / {eager[-1]:.6f}); "
        f"{len(differing)} parameter tensors differ {differing[:4]}")
    require(replayed == eager and not differing, f"{tag}: a replayed chunk differs from the same chunk run eagerly")
    return {"losses_replayed": replayed, "losses_eager": eager, "params_differing": differing}


def ell_config(tmp: str):
    """configs/arxiv_full_graph.yaml as written, 20 steps for its 200, its
    outputs under ``tmp``."""
    from grl_torch.config import load_config

    config = load_config(FULL_GRAPH_YAML)
    config["num_epochs"] = FULL_GRAPH_STEPS
    config["output_dir"] = os.path.join(tmp, "out")
    return config


def train_sparse_path(torch, card: str, tag: str, config, pairs, describe=None,
                      dtype_names=("float32", "bfloat16")):
    """``GNNLearningWarper.train`` -> ``FullGraphProcedure`` on ``config``:
    the main path with its launch counts, then a step timed on the card, a
    traced window, the learning check and the kernel-versus-plain pairs in
    each of ``dtype_names``. ``describe(trainer)``, where given, checks the
    planned graph and returns what the record keeps of it."""
    import grl_torch

    start = time.perf_counter()
    warper = grl_torch.GNNLearningWarper(config=config)
    setup_s = time.perf_counter() - start
    trainer = warper.trainer
    described = describe(trainer) if describe is not None else {}
    graph = trainer.graph
    N, E = graph.num_nodes, graph.num_edges()
    args = config["model"]["args"]
    require(type(trainer).__name__ == "FullGraphProcedure", f"the warper built {type(trainer).__name__}")
    require(graph.kernel is not None, "the graph has no planned kernel")
    require(not args.get("use_attention", True) or graph.atten_kernel is not None, "no attention kernel")
    log(
        f"[{tag}] configs/arxiv_full_graph.yaml: {N} nodes, {E} edges, L={graph.num_relations}, "
        f"input_dim {args['input_dim']}, net_size {args['net_size']}, output_dim {args['output_dim']}, "
        f"{args['compute_dtype']}, kernel_impl={args['kernel_impl']}, use_attention={args.get('use_attention')}, "
        f"kernel_plan {dict(config.get('kernel_plan') or {})}, {FULL_GRAPH_STEPS} steps (scan_steps "
        f"{config['scan_steps']}); graph built and planned in {setup_s:.2f} s"
    )
    plan_seconds = getattr(graph.kernel, "plan_seconds", None)
    if plan_seconds:
        log(f"[{tag}] planning seconds of the tables: {plan_seconds}; node_perm "
            f"{'set' if getattr(graph.kernel, 'node_perm', None) is not None else 'none'}")
    initial = params_of(warper.model)
    init_state = {k: v.detach().clone() for k, v in warper.model.state_dict().items()}

    # The main path: every launch count starts at 0 here.
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    best_acc = warper.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launched = sparse_counts()
    expected = expected_launches(trainer, FULL_GRAPH_STEPS, FULL_GRAPH_EVALS)
    require(launched == expected, f"{tag} path launched {launched}, expected {expected}")
    K = int(config["scan_steps"])
    runner = trainer.chunk_runner()
    require(runner.replays == FULL_GRAPH_STEPS // K - 1 and list(runner.graphs) == [K],
            f"{tag}: {runner.replays} replays of graphs {list(runner.graphs)}, expected "
            f"{FULL_GRAPH_STEPS // K - 1} of one graph of {K} steps")
    recorded = {name: n for name, n in runner.graphs[K][2].items() if n}
    setup = runner.setup[K]
    require(recorded == {k: v * K // FULL_GRAPH_STEPS for k, v in expected_launches(trainer, FULL_GRAPH_STEPS, 0).items()
                         if v},
            f"{tag}: the captured chunk recorded {recorded}")
    losses = [float(loss) for loss in trainer.losses]
    require(len(losses) == FULL_GRAPH_STEPS and all(math.isfinite(v) for v in losses), f"losses {losses}")
    changed = sum(not torch.equal(initial[n], p) for n, p in params_of(warper.model).items())
    require(changed == len(initial), f"only {changed} of {len(initial)} parameter tensors changed")
    log(
        f"[{tag}] {card}: {FULL_GRAPH_STEPS} steps + {FULL_GRAPH_EVALS} evals in {wall:.3f} s: "
        f"{FULL_GRAPH_STEPS / wall:.3f} steps/s, {E * FULL_GRAPH_STEPS / wall:.4e} edges/s; launches "
        f"{ {k: v for k, v in launched.items() if v} } (every other kernel 0); peak device memory "
        f"{peak_gb:.2f} GB; best val acc {best_acc:.4f}"
    )
    log(f"[{tag}] losses {[round(v, 4) for v in losses]}; chunks of {K} steps: the first eager (the warm-up), "
        f"then {runner.replays} replay(s) of one captured graph, which recorded {recorded}")
    log(f"[{tag}] {card}: the first chunk of {K} steps, eager (the warm-up), {setup['warmup_s']:.3f} s; the "
        f"capture of the second {setup['capture_s']:.3f} s, adding {setup['capture_bytes'] / 1e6:.1f} MB of "
        f"reserved device memory")

    # One train step timed on the card, back to back.
    for _ in range(3):
        trainer.train_step()
    torch.cuda.synchronize()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host = time.perf_counter()
    begin.record()
    for _ in range(FULL_GRAPH_TIMED_STEPS):
        trainer.train_step()
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - host) * 1e3 / FULL_GRAPH_TIMED_STEPS
    step_ms = begin.elapsed_time(end) / FULL_GRAPH_TIMED_STEPS

    # Device idle share and time by kernel of a traced window.
    from torch.profiler import ProfilerActivity, profile

    trace = os.path.join(config["output_dir"], f"{tag}_trace.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(FULL_GRAPH_TRACED_STEPS):
            trainer.train_step()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    idle, busy_ms, window_ms = device_idle_share(trace)
    by_kernel = sorted(
        ((e.key, e.device_time_total / 1e3 / FULL_GRAPH_TRACED_STEPS, e.count // FULL_GRAPH_TRACED_STEPS)
         for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0),
        key=lambda item: -item[1],
    )[:12]
    log(
        f"[{tag}] {card}: one train step {step_ms:.3f} ms on the card (CUDA events, mean of "
        f"{FULL_GRAPH_TIMED_STEPS} back to back; {host_ms:.3f} ms host wall); {E / (step_ms / 1e3):.4e} edges/s; "
        f"traced {FULL_GRAPH_TRACED_STEPS} steps: device busy {busy_ms:.3f} ms of {window_ms:.3f} ms, idle share "
        + ("not measured (no device events in the trace)" if idle is None else f"{idle:.4f}")
    )
    for name, ms, count in by_kernel:
        log(f"[{tag}]   {ms:8.3f} ms a step in {count:3d} launches: {name[:110]}")

    # The same steps replayed from the captured graph: timed, and traced.
    trainer.train_steps(K)
    torch.cuda.synchronize()
    host = time.perf_counter()
    begin.record()
    for _ in range(FULL_GRAPH_TIMED_REPLAYS):
        trainer.train_steps(K)
    end.record()
    torch.cuda.synchronize()
    replay_host_ms = (time.perf_counter() - host) * 1e3 / (FULL_GRAPH_TIMED_REPLAYS * K)
    replay_ms = begin.elapsed_time(end) / (FULL_GRAPH_TIMED_REPLAYS * K)
    replay_trace = os.path.join(config["output_dir"], f"{tag}_replay_trace.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_steps(K)
        torch.cuda.synchronize()
    prof.export_chrome_trace(replay_trace)
    replay_idle, replay_busy_ms, replay_window_ms = device_idle_share(replay_trace)
    log(
        f"[{tag}] {card}: one train step replayed {replay_ms:.3f} ms on the card (CUDA events, mean over "
        f"{FULL_GRAPH_TIMED_REPLAYS} replays of {K} steps; {replay_host_ms:.3f} ms host wall), "
        f"{E / (replay_ms / 1e3):.4e} edges/s; eager {step_ms:.3f} ms; traced replay of {K} steps: device busy "
        f"{replay_busy_ms:.3f} ms of {replay_window_ms:.3f} ms, idle share "
        + ("not measured (no device events in the trace)" if replay_idle is None else f"{replay_idle:.4f}")
        + " (eager: " + ("not measured" if idle is None else f"{idle:.4f}") + ")"
    )
    traced = trace_kernel_ms(trace, SPARSE_KERNELS.values())
    own = {k: {"ms": traced[name][0] / FULL_GRAPH_TRACED_STEPS, "launches": traced[name][1] / FULL_GRAPH_TRACED_STEPS}
           for k, name in SPARSE_KERNELS.items()}
    log(f"[{tag}] the port's sparse kernels a step: "
        + "; ".join(f"{k} {v['ms']:.3f} ms in {v['launches']:g} launches" for k, v in own.items() if v["launches"]))

    # Learning check: the config's 200 steps, at lr 1e-3, in chunks of
    # scan_steps: the first eager, every later one a replay.
    learner = procedure_copy(torch, trainer, int(config["seed"]), FULL_GRAPH_LEARN_LR)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(FULL_GRAPH_LEARN_STEPS // K):
        learn_loss = learner.train_steps(K)[-1]
    torch.cuda.synchronize()
    learn_wall = time.perf_counter() - start
    learn_setup = learner.chunk_runner().setup[K]
    learn_acc = float(learner.eval_step(learner.val_labels))
    require(learner.state.step == FULL_GRAPH_LEARN_STEPS
            and learner.chunk_runner().replays == FULL_GRAPH_LEARN_STEPS // K - 1,
            f"the learning check ran {learner.state.step} steps in {learner.chunk_runner().replays} replays")
    log(
        f"[{tag}] learning check, the config's {FULL_GRAPH_LEARN_STEPS} steps from the same initial weights "
        f"at lr {FULL_GRAPH_LEARN_LR}, {learner.chunk_runner().replays} replays of {K} steps: "
        f"loss {float(learn_loss):.4f}, validation accuracy {learn_acc:.4f} (need > {FULL_GRAPH_LEARN_ACC}; "
        f"chance {1 / int(args['output_dim']):.4f})"
    )
    log(
        f"[{tag}] {card}: the config's {FULL_GRAPH_LEARN_STEPS} steps in chunks of {K} (no evals) in "
        f"{learn_wall:.3f} s: {FULL_GRAPH_LEARN_STEPS / learn_wall:.3f} steps/s, "
        f"{E * FULL_GRAPH_LEARN_STEPS / learn_wall:.4e} edges/s, with the warm-up chunk "
        f"({learn_setup['warmup_s']:.3f} s) and the capture ({learn_setup['capture_s']:.3f} s) inside; the "
        f"{FULL_GRAPH_STEPS}-step main path above: {FULL_GRAPH_STEPS / wall:.3f} steps/s with its evals"
    )

    # Kernel path against plain path, two full-width steps in each dtype.
    starts = {
        "init": (init_state, float(config["optimizer"]["args"]["lr"])),
        "learned": ({k: v.detach().clone() for k, v in learner.model.state_dict().items()},
                    FULL_GRAPH_LEARN_LR),
    }
    del learner
    chunk_check = captured_chunk_check(torch, trainer, K, starts["learned"][0], tag)
    comparison, failures = full_graph_comparisons(torch, trainer, starts, dtype_names, pairs=pairs, tag=tag)
    require(learn_acc > FULL_GRAPH_LEARN_ACC, f"{tag} learning check failed: accuracy {learn_acc}")
    require(not failures, "; ".join(failures))
    return {
        **described,
        "nodes": N, "edges": E, "steps": FULL_GRAPH_STEPS, "evals": FULL_GRAPH_EVALS, "setup_s": setup_s,
        "plan_seconds": plan_seconds,
        "wall_s": wall, "steps_per_s": FULL_GRAPH_STEPS / wall, "edges_per_s": E * FULL_GRAPH_STEPS / wall,
        "launches": launched, "losses": losses, "best_val_acc": best_acc, "peak_memory_gb": peak_gb,
        "step_ms": step_ms, "step_host_ms": host_ms, "idle_share": idle, "traced_busy_ms": busy_ms,
        "scan_steps": K, "replays": runner.replays, "recorded": recorded, "replayed_step_ms": replay_ms,
        "replayed_step_host_ms": replay_host_ms, "replayed_edges_per_s": E / (replay_ms / 1e3),
        "replayed_idle_share": replay_idle, "replayed_busy_ms": replay_busy_ms,
        "replayed_window_ms": replay_window_ms, "captured_vs_eager": chunk_check,
        "traced_window_ms": window_ms, "device_ms_by_kernel": by_kernel, "sparse_kernels_a_step": own,
        "kernel_vs_plain": comparison,
        "learning_steps": FULL_GRAPH_LEARN_STEPS, "learning_val_acc": learn_acc,
        "setup": setup, "learning_wall_s": learn_wall, "learning_steps_per_s": FULL_GRAPH_LEARN_STEPS / learn_wall,
        "learning_setup": learn_setup,
    }


def phase_full_graph(torch, card: str):
    """The arxiv config with kernel_impl pallas_csr and sparse attention (K5, K4)."""
    return train_sparse_path(torch, card, "full_graph", full_graph_config(tempfile.mkdtemp(prefix="grl_torch_fg_")),
                             FULL_GRAPH_PAIRS)


def phase_ell(torch, card: str):
    """The arxiv config as written: kernel_impl ell with its kernel_plan (K6)."""
    config = ell_config(tempfile.mkdtemp(prefix="grl_torch_ell_"))
    args = config["model"]["args"]
    require(args["kernel_impl"] == "ell" and not args["use_attention"] and config["kernel_plan"]["plan_projected"],
            f"configs/arxiv_full_graph.yaml is not the file this phase expects: {args}")
    return train_sparse_path(torch, card, "ell", config, ELL_PAIRS)


def phase_tile(torch, card: str):
    """The arxiv config with kernel_impl tile, TILE_PLAN and 661 communities
    (K7 on the tiles, K6 on the residual)."""
    config = tile_config(tempfile.mkdtemp(prefix="grl_torch_tile_"))
    return train_sparse_path(torch, card, "tile", config, TILE_PAIRS, describe=describe_tiles("tile", "bfloat16"))


def describe_tiles(tag: str, tile_dtype: str):
    """The tile paths' check of the planned graph: the clustered plan's
    tiles and covered edges, in ``tile_dtype``."""

    def describe(trainer):
        from grl_torch.ops.tile import TileGraphKernel

        kernel = trainer.graph.kernel
        require(isinstance(kernel, TileGraphKernel), f"the {tag} config planned {type(kernel).__name__}")
        found = {"tiles_total": kernel.tiles_total, "covered_edges": kernel.covered_edges}
        require(found == TILE_EXPECTED, f"the {tag} phase planned {found}, expected {TILE_EXPECTED}")
        dtype = str(kernel.tables.fwd.tiles.dtype).split(".")[-1]
        require(dtype == tile_dtype, f"the {tag} phase planned {dtype} tiles, expected {tile_dtype}")
        residual = trainer.graph.num_edges() - kernel.covered_edges
        log(f"[{tag}] {kernel.tiles_total} {dtype} tiles of {kernel.tile_size} x {kernel.tile_size} (threshold "
            f"{kernel.tile_min_edges} edges) cover {kernel.covered_edges} edges, {residual} on the ELL residual; "
            f"planning seconds: {kernel.plan_seconds} (LPA, the tile tables, the residual's tables)")
        return {**found, "residual_edges": residual, "tile_min_edges": kernel.tile_min_edges, "tile_dtype": dtype,
                "forward_buckets": kernel.tables.fwd.shapes, "backward_buckets": kernel.tables.bwd.shapes}

    return describe


# The tile_variants phase's legs: the compute dtype, on float32 tiles, and
# the K7 route it takes.
TILE_VARIANTS = {"bfloat16": "persistent_f32tiles", "float32": "persistent_tf32"}


def phase_tile_variants(torch, card: str, tile_launches):
    """The tile phase's config with tile_dtype left out of its kernel plan
    (float32 tiles, the default), in the config's bf16 compute and in
    float32: every K7 launch on the leg's route (``TILE_VARIANTS``), as
    many a direction as the tile phase's ``tile_launches``."""
    from grl_torch.ops.tile import DIRECTIONS, ROUTES

    legs = {}
    for dtype_name, route in TILE_VARIANTS.items():
        config = tile_config(tempfile.mkdtemp(prefix=f"grl_torch_tile_{dtype_name}_"))
        del config["kernel_plan"]["tile_dtype"]
        config["model"]["args"]["compute_dtype"] = dtype_name
        tag = f"tile_variants {dtype_name}"
        leg = train_sparse_path(torch, card, tag, config, TILE_PAIRS, describe=describe_tiles(tag, "float32"),
                                dtype_names=(dtype_name,))
        launched = leg["launches"]
        by_route = {r: launched[f"K7 {r}"] for r in ROUTES}
        require(by_route == {r: launched["K7"] if r == route else 0 for r in ROUTES} and launched["K7"] > 0,
                f"{tag}: K7 ran {by_route} by route, expected all {launched['K7']} on {route}")
        for d in DIRECTIONS:
            require(launched[f"K7 {d}"] == tile_launches[f"K7 {d}"],
                    f"{tag}: K7 {d} ran {launched[f'K7 {d}']} times, the tile phase {tile_launches[f'K7 {d}']}")
        log(f"[{tag}] K7 by route {by_route}, by direction "
            f"{ {d: launched[f'K7 {d}'] for d in DIRECTIONS} } (the tile phase's, on bf16 tiles); one step replayed "
            f"{leg['replayed_step_ms']:.3f} ms, eager {leg['step_ms']:.3f} ms")
        legs[dtype_name] = {**leg, "route": route}
    return legs


# ---------------------------------------------------------------------------
# sampled
# ---------------------------------------------------------------------------
# The sampled path as bench.py's measure_sampled runs it (bench.py:912-934):
# fanouts 10x10, chunks of 20 steps, Adam at lr 1e-3, the flagship at the
# arxiv widths without attention, bf16, kernel_impl left at xla.
SAMPLED_FANOUTS = (10, 10)
SAMPLED_SCAN = 20
SAMPLED_LR = 1e-3
# Legs: (batch size, tree route, chunks of the training epoch (None: the
# whole epoch), validation batches (None: every one)).
SAMPLED_LEGS = {
    "tree B=256": (256, True, None, None),
    "tree B=512": (512, True, 3, 4),
    "coo B=256": (256, False, 2, 4),
}
# Chunks timed for sampled_target_nodes_per_s after one untimed chunk
# (bench.py times 2).
SAMPLED_RATE_CHUNKS = {"tree B=256": 5, "tree B=512": 2, "coo B=256": 1}
SAMPLED_TIMED_STEPS = 10
SAMPLED_TRACED_STEPS = 3
# The learning check: validation accuracy after the one epoch of the tree
# B=256 leg (chance 1/40 = 0.025), set from the first H100 run's 0.7830 as
# the full-graph limit was from its first run (PERF.md §2).
SAMPLED_LEARN_ACC = 0.4
# The sparse KV legs: the train phase's recipe with SparseBucketPadding.
SPARSE_KV_COLLATE = {"SparseBucketPadding": {"quantum": 64, "edge_quantum": 256, "only_selected_items": True}}
SPARSE_KV_LEGS = {"dense": ("dense", 1), "sparse": ("sparse", 1), "dense scan_steps 4": ("dense", SCAN_K)}


def sampled_config(tmp: str, batch_size: int, tree: bool):
    """configs/arxiv_full_graph.yaml with SampledGraphProcedure and
    bench.py's sampled overrides, one epoch, its outputs under ``tmp``."""
    from grl_torch.config import load_config

    config = load_config(FULL_GRAPH_YAML)
    config.update(
        experiment_name="sampled", seed=0, num_epochs=1, max_grad_norm=5.0, scan_steps=SAMPLED_SCAN,
        output_dir=os.path.join(tmp, "out"), procedure={"type": "SampledGraphProcedure", "args": {}},
        sampler={"fanouts": list(SAMPLED_FANOUTS), "batch_size": batch_size, "tree_aggregation": tree},
    )
    config["optimizer"]["args"]["lr"] = SAMPLED_LR
    config["model"]["args"].update(kernel_impl="xla", use_attention=False)
    return config


def cut_mask(mask, count):
    """``mask`` with only its first ``count`` nodes left on (all if None)."""
    import numpy as np

    if count is None:
        return mask
    cut = mask.copy()
    cut[np.flatnonzero(mask)[count:]] = False
    return cut


def sampled_rate(torch, trainer, chunks: int):
    """bench.py's ``sampled_target_nodes_per_s`` on ``trainer``: one
    untimed chunk, then ``chunks`` chunks of host sampling (waiting on the
    prefetch thread), staging and copies to the card (``h2d``, synchronized)
    and the replay with its loss read (``device_dispatch``); target nodes/s
    over the timed chunks, and each part's ms a step."""
    K = trainer._scan_k
    it = trainer._batches(trainer.data.train_mask)
    times = {"host_sample": 0.0, "h2d": 0.0, "device_dispatch": 0.0}
    runner = trainer.chunk_runner()
    start = None
    for chunk in range(chunks + 1):
        if chunk == 1:
            start = time.perf_counter()
        buffer = []
        for _ in range(K):
            t0 = time.perf_counter()
            buffer.append(next(it))
            times["host_sample"] += (time.perf_counter() - t0) * (chunk > 0)
        t0 = time.perf_counter()
        body = trainer.load_chunk(buffer)
        torch.cuda.synchronize()
        times["h2d"] += (time.perf_counter() - t0) * (chunk > 0)
        t0 = time.perf_counter()
        losses = runner.run(K, body).tolist()
        trainer.state.step += K
        times["device_dispatch"] += (time.perf_counter() - t0) * (chunk > 0)
        require(all(math.isfinite(v) for v in losses), f"losses {losses}")
    elapsed = time.perf_counter() - start
    it.close()
    steps = chunks * K
    rate = steps * trainer.sampler.groups * trainer.sampler.batch_size / elapsed
    return rate, {f"{k}_ms": v * 1e3 / steps for k, v in times.items()}


def sampled_masks(torch, trainer, arrays):
    """Replays draw new masks: a chunk that draws the tree's DropEdge masks
    (``drop_edge_coo``) and a D seed from the trainer's generator and reads
    D's mask back on ones of the trunk's width, run by a chunk runner of its
    own (the warm-up, the capture, then replays). D's mask must be the hash
    mask of the seed its replay drew, two replays' masks must differ, and
    every keep share must hold."""
    from grl_torch.ops import hashing
    from grl_torch.ops.dropout import apply_dropout
    from grl_torch.ops.sparse import drop_edge_coo
    from grl_torch.trainer.captured import CapturedSteps

    tree = trainer.graph(arrays)
    trunk = trainer.model.trunk
    ones = torch.ones(tree.num_nodes, NET_SIZE, device="cuda", dtype=torch.bfloat16)
    runner = CapturedSteps(torch.device("cuda"), [trainer.rngs.device])

    def chunk():
        edge_keep, self_scale = drop_edge_coo(tree, trunk.edge_dropout_rate, trainer.rngs.device)
        seed = trainer.rngs.kernel_seed()
        return edge_keep != 0, self_scale != 0, seed, apply_dropout(ones, seed, trunk.dropout.rate) != 0

    outs = [tuple(t.clone() for t in runner.run("masks", chunk)) for _ in range(4)][1:]
    torch.cuda.synchronize()
    require(runner.replays == 3, f"the mask chunk replayed {runner.replays} times, expected 3")
    ids = torch.arange(ones.numel(), device="cuda")
    rows = []
    for edge, self_mask, seed, drop in outs:
        require(torch.equal(drop, hashing.keep_bits(ids, seed, trunk.dropout.rate).view(drop.shape)),
                "a replayed D mask is not the hash mask of the seed its replay drew")
        row = {"seed": int(seed)}
        for name, mask, rate in (("edge", edge, trunk.edge_dropout_rate), ("self", self_mask, trunk.edge_dropout_rate),
                                 ("dropout", drop, trunk.dropout.rate)):
            kept, total = int(mask.sum()), mask.numel()
            row[f"{name}_keep_share"] = kept / total
            require(keep_share_ok(kept, total, rate), f"replayed {name} keep share {kept / total} of {total}")
        rows.append(row)
    for a, b in zip(outs, outs[1:]):
        require(all(not torch.equal(x, y) for x, y in zip(a, b)), "two replays drew the same DropEdge or D mask")
    return rows


def sampled_replay_check(torch, trainer, items, tag: str):
    """A chunk of ``items`` replayed from a fresh runner's graph against the
    same steps run eagerly from the same state, under deterministic
    algorithms (the warm-up and the capture too): losses and parameters
    equal bit for bit."""
    saved, trainer._steps = trainer._steps, None
    runner = trainer.chunk_runner()
    with deterministic(torch, True):
        trainer.run_chunk(items)  # the warm-up, eager
        snap = snapshot(torch, trainer)
        eager = runner.eager(trainer.load_chunk(items)).tolist()
        eager_params = params_of(trainer.model)
        restore(torch, trainer, snap)
        replayed = trainer.run_chunk(items).tolist()  # the capture, then its replay
        torch.cuda.synchronize()
    trainer._steps = saved
    differing = [n for n, v in params_of(trainer.model).items() if not torch.equal(v, eager_params[n])]
    log(f"[sampled {tag}] replayed chunk of {len(items)} steps vs the same steps eager from one state "
        f"(deterministic algorithms): losses equal {replayed == eager}; {len(differing)} parameter tensors differ "
        f"{differing[:4]}")
    require(runner.replays == 1 and replayed == eager and not differing,
            f"{tag}: a replayed chunk differs from the same chunk run eagerly ({runner.replays} replays)")
    return {"losses_replayed": replayed, "losses_eager": eager}


def sampled_d_vs_plain(torch, trainer, batches, tag: str):
    """Two eager steps with D against the same two with D's plain version,
    from the same state, under deterministic algorithms: losses,
    parameters and Adam state equal bit for bit."""
    snap = snapshot(torch, trainer)
    runs = []
    for swap in (contextlib.nullcontext(), plain_dropout()):
        restore(torch, trainer, snap)
        with deterministic(torch, True), swap:
            losses = [float(trainer.train_step(b)) for b in batches]
        runs.append((losses, params_of(trainer.model), snapshot(torch, trainer)[1]))
    (kl, kp, ks), (pl, pp, ps) = runs
    same_state = all(torch.equal(a, b) for a, b in zip(ks, ps))
    differing = [n for n in kp if not torch.equal(kp[n], pp[n])]
    log(f"[sampled {tag}] two steps with D vs with D's plain version (deterministic algorithms): losses {kl} vs "
        f"{pl}; {len(differing)} parameter tensors differ; Adam state equal {same_state}")
    require(kl == pl and not differing and same_state, f"{tag}: D's steps differ from plain D's")
    return {"losses_kernel": kl, "losses_plain": pl}


def sampled_step_times(torch, trainer, card: str, tag: str, trace_dir: str):
    """One step's device ms on the chunk's first static batch: eager (CUDA
    events over SAMPLED_TIMED_STEPS back to back) and replayed (the captured
    chunk, 3 replays); a traced eager window (device time by op, the tree
    einsums' share) and a traced replay (idle share, device time by
    kernel)."""
    from torch.profiler import ProfilerActivity, profile

    K = trainer._scan_k
    arrays = {name: t[0] for name, t in trainer._slots[K]["static"].items()}
    graph = trainer.chunk_runner().graphs[K][0]
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        trainer._step_body(arrays)
    torch.cuda.synchronize()
    host = time.perf_counter()
    begin.record()
    for _ in range(SAMPLED_TIMED_STEPS):
        trainer._step_body(arrays)
    end.record()
    torch.cuda.synchronize()
    eager_host_ms = (time.perf_counter() - host) * 1e3 / SAMPLED_TIMED_STEPS
    eager_ms = begin.elapsed_time(end) / SAMPLED_TIMED_STEPS
    begin.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = begin.elapsed_time(end) / (3 * K)
    trace = os.path.join(trace_dir, "sampled_eager_trace.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(SAMPLED_TRACED_STEPS):
            trainer._step_body(arrays)
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    idle, busy_ms, window_ms = device_idle_share(trace)
    averages = prof.key_averages()
    by_op = sorted(((e.key, getattr(e, "self_device_time_total", 0) / 1e3 / SAMPLED_TRACED_STEPS,
                     e.count // SAMPLED_TRACED_STEPS) for e in averages
                    if getattr(e, "self_device_time_total", 0) > 0), key=lambda item: -item[1])[:12]
    total = {e.key: getattr(e, "device_time_total", 0) / 1e3 / SAMPLED_TRACED_STEPS for e in averages}
    busy_step = busy_ms / SAMPLED_TRACED_STEPS
    einsum = {"aten::einsum (forward)": total.get("aten::einsum", 0.0),
              "aten::bmm (the einsums, forward and backward)": total.get("aten::bmm", 0.0)}
    replay_trace = os.path.join(trace_dir, "sampled_replay_trace.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    prof.export_chrome_trace(replay_trace)
    replay_idle, replay_busy_ms, replay_window_ms = device_idle_share(replay_trace)
    with open(replay_trace) as handle:
        kernels = [e for e in json.load(handle)["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "kernel" and "dur" in e]
    by_kernel = {}
    for e in kernels:
        by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + e["dur"] / 1e3 / K
    replay_by_kernel = sorted(by_kernel.items(), key=lambda item: -item[1])[:8]
    log(f"[sampled {tag}] {card}: one train step eager {eager_ms:.3f} ms on the card (CUDA events, mean of "
        f"{SAMPLED_TIMED_STEPS}; {eager_host_ms:.3f} ms host wall), replayed {replay_ms:.3f} ms (3 replays of {K}); "
        f"traced eager: device busy {busy_step:.3f} ms a step, idle share "
        + ("not measured" if idle is None else f"{idle:.4f}")
        + f"; traced replay of {K} steps: device busy {replay_busy_ms:.3f} ms of {replay_window_ms:.3f} ms, idle share "
        + ("not measured" if replay_idle is None else f"{replay_idle:.4f}"))
    log(f"[sampled {tag}] the tree einsums a step: "
        + "; ".join(f"{k} {v:.3f} ms = {v / max(busy_step, 1e-9):.3f} of the device busy time" for k, v in einsum.items()))
    for name, ms, count in by_op:
        log(f"[sampled {tag}]   {ms:8.3f} ms a step (self) in {count:3d} calls: {name[:110]}")
    for name, ms in replay_by_kernel:
        log(f"[sampled {tag}]   replayed: {ms:8.3f} ms a step: {name[:110]}")
    return {"eager_step_ms": eager_ms, "replayed_ms_by_kernel": replay_by_kernel, "eager_step_host_ms": eager_host_ms, "replayed_step_ms": replay_ms,
            "eager_idle_share": idle, "eager_busy_ms_a_step": busy_step, "replayed_idle_share": replay_idle,
            "replayed_busy_ms": replay_busy_ms, "replayed_window_ms": replay_window_ms,
            "einsum_ms_a_step": einsum, "device_ms_by_op": by_op}


def sampled_leg(torch, card: str, tag: str):
    """``GNNLearningWarper.train`` -> ``SampledGraphProcedure`` for one leg
    of SAMPLED_LEGS: launch counts (D 5 x steps each way, no other kernel),
    replays, finite losses, moved parameters, then the leg's measurements.
    Returns the leg's record and its procedure."""
    import grl_torch

    batch_size, tree, chunks, val_batches = SAMPLED_LEGS[tag]
    tmp = tempfile.mkdtemp(prefix="grl_torch_sampled_")
    config = sampled_config(tmp, batch_size, tree)
    start = time.perf_counter()
    warper = grl_torch.GNNLearningWarper(config=config)
    setup_s = time.perf_counter() - start
    trainer = warper.trainer
    require(type(trainer).__name__ == "SampledGraphProcedure", f"the warper built {type(trainer).__name__}")
    data, K = trainer.data, trainer._scan_k
    trainer.data = data._replace(
        train_mask=cut_mask(data.train_mask, None if chunks is None else chunks * K * batch_size),
        val_mask=cut_mask(data.val_mask, None if val_batches is None else val_batches * batch_size))
    steps = -(-int(trainer.data.train_mask.sum()) // batch_size)
    evals = -(-int(trainer.data.val_mask.sum()) // batch_size)
    sampler = trainer.sampler
    args = config["model"]["args"]
    log(f"[sampled {tag}] configs/arxiv_full_graph.yaml with SampledGraphProcedure: {len(data.features)} nodes, "
        f"{len(data.senders)} edges, L={data.num_relations}, widths {args['input_dim']}/{args['net_size']}/"
        f"{args['output_dim']}, {args['compute_dtype']}, kernel_impl {args['kernel_impl']}, dropout "
        f"{args.get('dropout_rate', 0.5)}, DropEdge {args.get('edge_dropout_rate', RATE)}; fanouts {SAMPLED_FANOUTS}, "
        f"B={batch_size}: {sampler.num_nodes} tree slots and {sampler.num_edges} edges a batch, "
        f"{'tree' if tree else 'COO'} route, head slice {trainer._head_slice}; {steps} steps in chunks of {K}, "
        f"{evals} validation batches; graph built in {setup_s:.2f} s")
    initial = params_of(warper.model)

    # The main path: every launch count starts at 0 here.
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    acc = warper.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launched = sparse_counts()
    expected = {**dict.fromkeys(launched, 0), **dict.fromkeys(D_COUNTS, DROPOUTS_A_FORWARD * steps)}
    require(launched == expected, f"sampled {tag} launched {launched}, expected {expected}")
    runner = trainer.chunk_runner()
    require(trainer.state.step == steps and runner.replays == steps // K - 1 and list(runner.graphs) == [K],
            f"sampled {tag}: {trainer.state.step} steps, {runner.replays} replays of graphs {list(runner.graphs)}")
    recorded = {name: n for name, n in runner.graphs[K][2].items() if n}
    require(recorded == dict.fromkeys(D_COUNTS, DROPOUTS_A_FORWARD * K), f"the captured chunk recorded {recorded}")
    losses = trainer.losses
    require(len(losses) == steps and all(math.isfinite(v) for v in losses), f"losses {losses}")
    changed = sum(not torch.equal(initial[n], p) for n, p in params_of(warper.model).items())
    require(changed == len(initial), f"only {changed} of {len(initial)} parameter tensors changed")
    setup = runner.setup[K]
    log(f"[sampled {tag}] {card}: {steps} steps + {evals} validation batches in {wall:.3f} s "
        f"({steps * batch_size / wall:.1f} target nodes/s with the validation); launches "
        f"{ {k: v for k, v in launched.items() if v} } (every other kernel 0); {runner.replays} replays of one "
        f"graph of {K} steps, {steps % K} leftover steps eager; validation accuracy {acc:.4f}; peak device memory "
        f"{peak_gb:.2f} GB; warm-up chunk {setup['warmup_s']:.3f} s, capture {setup['capture_s']:.3f} s adding "
        f"{setup['capture_bytes'] / 1e6:.1f} MB")
    log(f"[sampled {tag}] losses: first {[round(v, 4) for v in losses[:3]]}, last {[round(v, 4) for v in losses[-3:]]}")
    rate, split = sampled_rate(torch, trainer, SAMPLED_RATE_CHUNKS[tag])
    log(f"[sampled {tag}] {card}: sampled_target_nodes_per_s {rate:.1f} over {SAMPLED_RATE_CHUNKS[tag]} replayed "
        f"chunks of {K} after an untimed one, a step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    times = sampled_step_times(torch, trainer, card, tag, config["output_dir"])
    return {"batch_size": batch_size, "route": "tree" if tree else "coo", "steps": steps, "evals": evals,
            "scan_steps": K, "replays": runner.replays, "recorded": recorded, "launches": launched,
            "wall_s": wall, "val_acc": acc, "losses": losses, "peak_memory_gb": peak_gb, "setup": setup,
            "graph_setup_s": setup_s, "sampled_target_nodes_per_s": rate, "split": split, **times}, trainer


def sparse_kv_leg(torch, card: str, tag: str, base):
    """``GNNLearningWarper.train`` -> ``KVProcedure`` on SparseBucketPadding's
    COO batches, one epoch: D counts, no K1/K2/K3, finite losses, moved
    parameters, the checkpoint; steps/s and one step's device ms."""
    import grl_torch
    from grl_torch.trainer.procedures.kv_procedure import adjacency_leaves, adjacency_to
    from grl_torch.utils.checkpoint import CheckpointHandler

    attention_impl, scan_steps = SPARSE_KV_LEGS[tag]
    config = copy.deepcopy(base)
    config.update(num_epochs=1, scan_steps=scan_steps, experiment_name=f"sparse_kv {tag}")
    config["output_dir"] = os.path.join(base["output_dir"], tag.replace(" ", "_"))
    config["model"]["args"].update(kernel_impl="xla", attention_impl=attention_impl)
    for split in ("training", "validation"):
        config["data_config"][split]["data_collate"] = copy.deepcopy(SPARSE_KV_COLLATE)
    config["logging"].pop("profile", None)
    warper = grl_torch.GNNLearningWarper(config=config)
    trainer = warper.trainer
    initial = params_of(warper.model)
    steps, evals = TRAIN_PAGES // B, VAL_PAGES // B
    reset_counts()
    start = time.perf_counter()
    f1 = warper.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launched = sparse_counts()
    expected = {**dict.fromkeys(launched, 0), **dict.fromkeys(D_COUNTS, DROPOUTS_A_FORWARD * steps)}
    require(launched == expected, f"sparse KV {tag} launched {launched}, expected {expected}")
    losses = series(warper, "Train/step_loss")
    require(len(losses) == steps and all(math.isfinite(v) for v in losses), f"sparse KV {tag} losses {losses}")
    changed = sum(not torch.equal(initial[n], p) for n, p in params_of(warper.model).items())
    require(changed == len(initial), f"only {changed} of {len(initial)} parameter tensors changed")
    checkpoint = os.path.join(trainer.model_dir, CheckpointHandler.LATEST)
    require(os.path.exists(checkpoint), f"no checkpoint at {checkpoint}")
    items = [(*trainer._host_batch(batch), 1.0) for batch in trainer.train_loader]
    keys = [trainer.shape_key(*item[:3]) for item in items]
    buckets = sorted({tuple(adjacency_leaves(A)["senders"].shape) for _, A, _, _ in items})
    V, A, labels, _ = items[0]
    V, A, labels = V.cuda(), adjacency_to(A, torch.device("cuda")), labels.cuda()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        trainer._train_fn(V, A, labels, trainer.rngs, 1.0)
    torch.cuda.synchronize()
    begin.record()
    for _ in range(TIMED_STEPS):
        trainer._train_fn(V, A, labels, trainer.rngs, 1.0)
    end.record()
    torch.cuda.synchronize()
    step_ms = begin.elapsed_time(end) / TIMED_STEPS
    record = {"steps": steps, "evals": evals, "wall_s": wall, "steps_per_s": steps / wall, "launches": launched,
              "losses": losses, "macro_f1": f1, "step_ms": step_ms, "edge_buckets": buckets,
              "single_steps": dict(trainer.single_steps)}
    log(f"[sparse_kv {tag}] {card}: {steps} steps + {evals} validation batches in {wall:.3f} s "
        f"({steps / wall:.3f} steps/s with the validation and the host data); attention_impl {attention_impl}, "
        f"scan_steps {scan_steps}; edge buckets {buckets}; launches { {k: v for k, v in launched.items() if v} } "
        f"(no K1/K2/K3); losses {[round(v, 4) for v in losses]}; one single step (replayed from its one-step "
        f"graph) {step_ms:.3f} ms on the card (CUDA events, mean of {TIMED_STEPS}, B={B}, N={labels.shape[1]}); "
        f"single steps {record['single_steps']}")
    if scan_steps > 1:
        # The main path's chunks: batches wait by edge bucket, so how many
        # chunks replay depends on how the epoch's pages fell.
        runner = trainer.chunk_runner()
        record.update(replays=runner.replays, graphs=len(runner.graphs))
        log(f"[sparse_kv {tag}] the epoch's chunks: {len(runner.graphs)} graph(s) captured, {runner.replays} "
            f"replay(s)")
        # A chunk of one edge bucket (its batches in turn, as many as it has).
        key = max(set(keys), key=keys.count)
        same = [item for item, k in zip(items, keys) if k == key]
        chunk = [same[i % len(same)] for i in range(scan_steps)]
        saved, trainer._steps = trainer._steps, None
        with deterministic(torch, True):
            trainer.run_chunk(chunk)  # the warm-up, eager
            trainer.run_chunk(chunk)  # the capture, then its replay
            replay_losses, eager_losses = replay_against_eager(torch, trainer, chunk, f"sparse KV {tag}")
        trainer._steps = saved
        record["replay_vs_eager_losses"] = [replay_losses, eager_losses]
    return record


def phase_sampled(torch, card: str):
    """The sampled path (tree B=256 with its checks, tree B=512, COO
    B=256) and the sparse KV path (dense and sparse attention, and dense
    at scan_steps 4)."""
    import itertools

    import numpy as np

    legs = {}
    for tag in SAMPLED_LEGS:
        legs[tag], trainer = sampled_leg(torch, card, tag)
        K = trainer._scan_k
        rng = np.random.RandomState(1)
        if tag == "tree B=256":
            items = list(itertools.islice(trainer.sampler.epoch_batches(rng, trainer.data.train_mask), K))
            legs[tag]["captured_vs_eager"] = sampled_replay_check(torch, trainer, items, tag)
            legs[tag]["replayed_masks"] = masks = sampled_masks(
                torch, trainer, {name: t[0] for name, t in trainer._slots[K]["static"].items()})
            log(f"[sampled {tag}] replays draw new masks: {masks}")
            legs[tag]["d_vs_plain"] = sampled_d_vs_plain(torch, trainer, items[:2], tag)
            require(legs[tag]["val_acc"] > SAMPLED_LEARN_ACC,
                    f"sampled learning check failed: validation accuracy {legs[tag]['val_acc']}")
            log(f"[sampled {tag}] learning check: validation accuracy {legs[tag]['val_acc']:.4f} after one epoch "
                f"(need > {SAMPLED_LEARN_ACC}; chance {1 / trainer.data.num_classes:.4f})")
        if tag == "coo B=256":
            # Eval forwards of the same validation batches and weights through
            # both routes, held as serving holds bf16 (SERVE_AGREEMENT).
            routes = {True: [], False: []}
            trainer.model.eval()
            with torch.no_grad():
                for batch in itertools.islice(trainer.sampler.epoch_batches(rng, trainer.data.val_mask), 4):
                    arrays = trainer.device_arrays(batch)
                    for route in routes:
                        trainer._use_tree = route
                        routes[route].append(trainer._logits(arrays)[0].float().flatten(0, -2))
            trainer._use_tree = False
            tree, coo = (torch.cat(routes[r]) for r in (True, False))
            p_tree, p_coo = tree.softmax(-1), coo.softmax(-1)
            same = float((tree.argmax(-1) == coo.argmax(-1)).float().mean())
            conf = float((p_tree.max(-1).values - p_coo.max(-1).values).abs().max())
            diff, scale = float((coo - tree).abs().max()), float(tree.abs().max())
            min_same, max_conf = SERVE_AGREEMENT["bfloat16"]
            log(f"[sampled {tag}] eval forwards of 4 validation batches ({len(tree)} targets) through the tree and "
                f"the COO routes, same weights: classes agree on {same:.5f} (need >= {min_same}), max confidence "
                f"diff {conf:.3e} (need <= {max_conf}); max logit difference {diff:.4e} of scale {scale:.3f}")
            require(same >= min_same and conf <= max_conf, f"the tree and COO routes disagree: {same}, {conf}")
            legs[tag]["tree_vs_coo"] = {"class_agreement": same, "max_confidence_diff": conf,
                                        "max_logit_diff": diff, "logit_scale": scale}
        del trainer
    tmp = tempfile.mkdtemp(prefix="grl_torch_sparse_kv_")
    dirs, classes_path, charset_path = write_training_files(tmp)
    base = train_config(tmp, dirs, classes_path, charset_path)
    legs["sparse_kv"] = {tag: sparse_kv_leg(torch, card, tag, base) for tag in SPARSE_KV_LEGS}
    return legs


# ---------------------------------------------------------------------------
# demo
# ---------------------------------------------------------------------------
DEMO_PAGE_SEED = 3


def phase_demo(torch, card: str):
    """The port's entry points, each a subprocess run from a scratch
    working directory (the configs write their outputs relative to it, so
    nothing lands in the checkout): ``python -m grl_torch.demo_training`` on
    configs/arxiv_full_graph.yaml for 20 epochs (K6 and D on the card), on
    configs/synthetic_kv.yaml for one epoch, and ``python -m
    grl_torch.demo_inference`` on configs/synthetic_kv_infer.yaml, which
    reads that run's checkpoint, on a synthetic page."""
    from grl_torch.data.synthetic import synthetic_page

    tmp = tempfile.mkdtemp(prefix="grl_torch_demo_")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    record = {}

    def run(tag, module, *args):
        start = time.perf_counter()
        done = subprocess.run([sys.executable, "-m", module, *args], cwd=tmp, env=env, capture_output=True,
                              text=True, timeout=600)
        seconds = time.perf_counter() - start
        last = done.stdout.strip().splitlines()[-1] if done.stdout.strip() else ""
        log(f"[demo] {card}: python -m {module} {' '.join(args)}: exit {done.returncode} in {seconds:.2f} s; "
            f"last line: {last}")
        require(done.returncode == 0, f"{module} {args} exited {done.returncode}: {done.stderr[-3000:]}")
        record[tag] = {"seconds": seconds, "last_line": last}
        return done.stdout

    yaml = os.path.join(REPO, "configs")
    for tag, config, epochs in (("train arxiv", FULL_GRAPH_YAML, FULL_GRAPH_STEPS),
                                ("train synthetic_kv", os.path.join(yaml, "synthetic_kv.yaml"), 1)):
        out = run(tag, "grl_torch.demo_training", "--config", config, "--epochs", str(epochs))
        lines = [line for line in out.splitlines() if line.startswith("final macro F1: ")]
        require(len(lines) == 1, f"demo_training printed no final metric: {out[-2000:]}")
        record[tag]["final"] = value = float(lines[0].split(": ")[1])
        require(math.isfinite(value) and 0.0 <= value <= 1.0, f"demo_training's final metric {value}")
    page = [{"location": box["location"], "text": box["text"]} for box in synthetic_page(DEMO_PAGE_SEED)]
    with open(os.path.join(tmp, "page.json"), "w") as handle:
        json.dump(page, handle)
    out = run("infer synthetic_kv", "grl_torch.demo_inference", "--config", os.path.join(yaml, "synthetic_kv_infer.yaml"),
              "--input", "page.json", "--output", "out.json")
    require("wrote out.json" in out, f"demo_inference printed {out[-2000:]}")
    with open(os.path.join(tmp, "out.json")) as handle:
        boxes = json.load(handle)
    require(len(boxes) == len(page) and all(
        box["text"] == raw["text"] and {"key_type", "formal_key", "confidence"} <= set(box)
        and 0.0 <= box["confidence"] <= 1.0 for box, raw in zip(boxes, page)),
        f"demo_inference did not annotate every box: {boxes[:3]}")
    record["infer synthetic_kv"]["boxes"] = len(boxes)
    log(f"[demo] {len(boxes)} boxes annotated, e.g. {[(b['text'], b['formal_key'], b['key_type']) for b in boxes[:3]]}")
    return record


# ---------------------------------------------------------------------------
# parallel
# ---------------------------------------------------------------------------
# The parallel phase's world: two ranks started through the GRL_* launch
# contract. Where they must share a card (one GPU) the backend is gloo,
# with two cards or more NCCL, one rank a card
# (grl_torch.parallel.distributed.choose_backend).
PARALLEL_WORLD = 2
# Seconds a collective may wait (every group of the world is made with
# it), and seconds the world may take before the phase kills it and fails.
PARALLEL_COLLECTIVE_TIMEOUT_S = 120
PARALLEL_WORLD_TIMEOUT_S = 480
# Steps timed by CUDA events (and, in a second window with the collectives
# synchronized and timed, for their milliseconds) in each leg.
PARALLEL_TIMED_STEPS = 5
PARALLEL_COMM_STEPS = 3
# The sampled leg: the tree route at B = 256, cut to this many chunks.
PARALLEL_SAMPLED_B = 256
PARALLEL_SAMPLED_CHUNKS = 3
# The partitioned leg's learning check: steps at FULL_GRAPH_LEARN_LR, held
# to FULL_GRAPH_LEARN_ACC. The config's 200 took 136.5 s on one card shared by
# two ranks (0.9891 reached; a step 465 ms, the ring's 347 MB through gloo),
# over the phase's budget alone. 60 reached 0.2927; a 100-step run read
# 0.0722, 0.0927, 0.0556, 0.1302, 0.1905, 0.3220, 0.4309, 0.5255, 0.6531,
# 0.7739 at steps 10, 20, ..., 100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md):
# 80 keeps the check well past the bound inside the phase's time.
PARALLEL_LEARN_STEPS = 80
# The nccl leg's ring of one runs on an SBM of this many nodes with the
# arxiv config's widths; its chunks hold this many steps.
PARALLEL_RING_NODES = 20_000
PARALLEL_NCCL_K = 2
PARALLEL_LEGS = ("dp", "tp", "partitioned", "sampled", "ssl")


def flagship_args(dtype_name, **rates):
    """The sumi-width flagship on the kernel path."""
    return {"input_dim": CHARSET_SIZE + 4, "output_dim": NUM_CLASSES * 2 + 1, "num_edges": 6, "net_size": NET_SIZE,
            "kernel_impl": "pallas", "compute_dtype": None if dtype_name == "float32" else dtype_name,
            "dropout_rate": 0.5, "edge_dropout_rate": RATE, **rates}


def parallel_config(tmp: str, **extra):
    """The distributed block every procedure of the world reads."""
    return {"output_dir": tmp, "max_grad_norm": 5.0, "logging": {"use_tensorboard": False},
            "optimizer": {"type": "BuiltinOptimizer", "args": {"type_optimizer": "Adam", "lr": STEP_LR}},
            **extra}


def mesh_block(mesh):
    return {"mesh": mesh, "distributed": {"timeout": PARALLEL_COLLECTIVE_TIMEOUT_S}}


def events_ms(torch, fn, reps: int) -> float:
    """Milliseconds of one ``fn()`` by CUDA events over ``reps`` calls,
    after one untimed call (this rank's stream; the collectives inside
    wait for the other ranks)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def comm_window(fn, reps: int) -> dict:
    """The collectives of ``reps`` calls of ``fn`` by kind, a call: calls,
    bytes and milliseconds (each collective synchronized on both sides and
    timed on the host, so the window runs slower than the steps above)."""
    from grl_torch.parallel import distributed

    distributed.comm_stats.clear()
    distributed.timing = True
    try:
        for _ in range(reps):
            fn()
    finally:
        distributed.timing = False
    return {kind: {"calls": s["calls"] / reps, "bytes": s["bytes"] / reps, "ms": s["ms"] / reps}
            for kind, s in distributed.comm_stats.items()}


def whole_params(torch, proc):
    """``params_of`` the train state's module with the tensor-parallel
    shards all-gathered."""
    state = proc.state.state_dict()["model"]
    return {name: state[name].detach().float().clone() for name, _ in proc.state.model.named_parameters()}


def whole_grads(torch, proc):
    """The train state's parameters' (clipped) gradients, shards
    all-gathered over ``model``."""
    from grl_torch.parallel import distributed

    sharded = {id(p) for p in proc.sharded}
    return {name: (distributed.all_gather(p.grad, proc.model_group, dim=1) if id(p) in sharded else p.grad).float().clone()
            for name, p in proc.state.model.named_parameters()}


def world_and_whole_steps(torch, tmp, tag, mesh, args, batches, steps, seed=7):
    """``steps`` train steps of the world (mesh ``mesh``, each rank on its
    rows) and of the whole model in this process on the whole batches,
    from the same seed-0 weights and masks from generators seeded
    ``seed``: ``compare_steps``' inputs for both."""
    from grl_torch.models import Rngs, create_model
    from grl_torch.trainer.procedures import BaseProcedure

    runs = []
    for name, parallel in (("world", mesh_block(mesh)), ("whole", None)):
        model = create_model("GraphCNNDropEdge", **args, device="cuda", generator=torch.Generator().manual_seed(0))
        proc = BaseProcedure(model, parallel_config(os.path.join(tmp, f"{tag}-{name}"),
                                                    **({"parallel": parallel} if parallel else {})), device="cuda")
        proc.init_state()
        step = proc.build_train_step(args["output_dim"], (-100,))
        rngs = Rngs.from_seed(seed, torch.device("cuda"))
        losses, snapshots, grads = [], [whole_params(torch, proc)], []
        for V, A, labels in batches[:steps]:
            if parallel:
                rows = proc.place_batch({"V": V, "A": A, "labels": labels}, {"labels": -100})
                V, A, labels = rows["V"], rows["A"], rows["labels"]
            dtype = proc.model.trunk.dtype or torch.float32
            loss, _ = step(torch.from_numpy(V).cuda().to(dtype), torch.from_numpy(A).cuda().to(dtype),
                           torch.from_numpy(labels).cuda().long(), rngs, 1.0)
            losses.append(float(loss))
            snapshots.append(whole_params(torch, proc))
            grads.append(whole_grads(torch, proc))
        runs.append((losses, snapshots, grads))
    return runs


def global_batches(loader, count: int):
    """The first ``count`` global batches of ``loader`` as host arrays."""
    import numpy as np

    out = []
    for batch in loader:
        out.append((np.asarray(batch["textline_encoding"], np.float32), np.asarray(batch["adjacency_matrix"], np.float32),
                    np.asarray(batch["node_label"], np.int64)))
        if len(out) == count:
            break
    return out


def step_checker(proc, checks):
    """Wraps ``proc``'s step log: after each logged step (each chunk's
    steps, scanned) every rank checks its replicated parameters against the
    world's, bit for bit."""
    from grl_torch.parallel.distributed import equal_across

    logged = proc._log_train_step

    def log_and_check(scores, metrics, gstep):
        checks.append(equal_across(list(proc.model.parameters())))
        return logged(scores, metrics, gstep)

    proc._log_train_step = log_and_check


def parallel_dp(torch, tmp, pages, world):
    """KVProcedure at sumi width, bf16, DropEdge and dropout on, {data: world}:
    one epoch stepwise and one at scan_steps 4 through the warper, each
    with its launch counts set to 0 just before it; then two float32 steps
    at rates 0 against one process's. Returns the record and two global
    batches of the loader (host arrays) for the tp leg."""
    import grl_torch

    dirs, classes_path, charset_path = pages
    out = {}
    for tag, K in (("stepwise", 1), ("scan_steps 4", SCAN_K)):
        config = train_config(tmp, dirs, classes_path, charset_path)
        config.update(experiment_name=f"dp-{K}", num_epochs=1, scan_steps=K, parallel=mesh_block({"data": world}))
        config["logging"]["profile"] = {"start_step": -1, "num_steps": 0}
        warper = grl_torch.GNNLearningWarper(config=config)
        trainer = warper.trainer
        checks = []
        step_checker(trainer, checks)
        steps, evals = TRAIN_PAGES // B, VAL_PAGES // B
        reset_counts()
        start = time.perf_counter()
        f1 = warper.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launched = counts(("K3", "K1", "K2", *D_COUNTS))
        expected = {"K3": 3 * evals, "K1": 3 * steps, "K2": 3 * steps,
                    **dict.fromkeys(D_COUNTS, DROPOUTS_A_FORWARD * steps)}
        require(launched == expected, f"dp {tag} launched {launched}, expected {expected}")
        require(len(checks) == steps and all(checks), f"dp {tag}: replicated parameters differ across ranks {checks}")
        runner = trainer.chunk_runner()
        require(trainer.state.step == steps and bool(runner.graphs) == (trainer.captures and K > 1),
                f"dp {tag}: {trainer.state.step} steps, graphs {list(runner.graphs)}, captures {trainer.captures}")
        out[tag] = {"f1": f1, "wall_s": wall, "steps_per_s": steps / wall, "launches": launched,
                    "route_counts": route_counts(), "replays": runner.replays, "equal_checks": len(checks)}
        if K == 1:
            device_batches = fixed_batches(trainer, 2)
            it = iter(range(10 ** 9))

            def step():
                V, A, labels = device_batches[next(it) % 2]
                trainer._train_fn(V, A, labels, trainer.rngs, trainer._lam)

            out["step_ms"] = events_ms(torch, step, PARALLEL_TIMED_STEPS)
            out["comm"] = comm_window(step, PARALLEL_COMM_STEPS)
            batches = global_batches(trainer.train_loader, 2)
    # float32 at rates 0: the world's two steps against one process's on the
    # whole batches.
    world_run, whole_run = world_and_whole_steps(torch, tmp, "dp", {"data": world},
                                                 flagship_args("float32", dropout_rate=0.0, edge_dropout_rate=0.0),
                                                 batches, 2)
    rows = compare_steps(world_run, whole_run)
    failures = step_failures(rows, STEP_LIMITS["float32"])
    require(not failures, f"dp: the world's float32 steps break STEP_LIMITS at steps {failures}: {rows}")
    out["float32_steps"] = rows
    return out, batches


def parallel_tp(torch, tmp, world, batches):
    """{data: 1, model: world}: the serving forward at sumi width against
    the unsharded model, float32 and bfloat16 on K3, under
    SERVE_AGREEMENT; one float32 train step (DropEdge 0.3, dropout 0) of the
    sharded model against the unsharded one under STEP_LIMITS."""
    from grl_torch.models import create_model
    from grl_torch.trainer.procedures import BaseProcedure

    out = {"routes": {}}
    V, A, labels = batches[0]
    valid = torch.from_numpy(labels).cuda() != -100
    for dtype_name in ("float32", "bfloat16"):
        args = flagship_args(dtype_name)
        whole = create_model("GraphCNNDropEdge", **args, device="cuda", generator=torch.Generator().manual_seed(0))
        model = create_model("GraphCNNDropEdge", **args, device="cuda", generator=torch.Generator().manual_seed(0))
        proc = BaseProcedure(model, parallel_config(os.path.join(tmp, f"tp-{dtype_name}"),
                                                    parallel=mesh_block({"data": 1, "model": world})), device="cuda")
        proc.init_state()
        require(tuple(model.w_rand.kernel.shape) == (NET_SIZE // 2, NET_SIZE // 2 * 10 // world),
                f"w_rand not column-sharded: {tuple(model.w_rand.kernel.shape)}")
        dtype = getattr(torch, dtype_name)
        inputs = (torch.from_numpy(V).cuda().to(dtype), torch.from_numpy(A).cuda().to(dtype))
        whole.eval()
        model.eval()
        with torch.no_grad():
            p_whole = torch.softmax(whole(inputs).float(), -1)[valid]
            # The main path: the sharded forward, its launches counted alone.
            reset_counts()
            p_tp = torch.softmax(model(inputs).float(), -1)[valid]
            out["routes"][dtype_name] = route_counts()["K3"]
        same = float((p_whole.argmax(-1) == p_tp.argmax(-1)).float().mean())
        diff = float((p_whole - p_tp).abs().max())
        min_same, max_diff = SERVE_AGREEMENT[dtype_name]
        require(same >= min_same and diff <= max_diff, f"tp {dtype_name}: classes agree on {same}, max diff {diff}")
        fn = (lambda m=model: m(inputs))
        with torch.no_grad():
            ms = events_ms(torch, fn, PARALLEL_TIMED_STEPS)
            comm = comm_window(fn, PARALLEL_COMM_STEPS)
        out[dtype_name] = {"class_agreement": same, "max_prob_diff": diff, "forward_ms": ms, "comm": comm}
    sharded, whole_run = world_and_whole_steps(torch, tmp, "tp", {"data": 1, "model": world},
                                               flagship_args("float32", dropout_rate=0.0), batches, 1)
    rows = compare_steps(sharded, whole_run)
    failures = step_failures(rows, STEP_LIMITS["float32"][:1])
    require(not failures, f"tp: the sharded float32 step breaks STEP_LIMITS: {rows}")
    out["float32_step"] = rows
    return out


def partitioned_model(torch, trainer, seed: int, lr: float, **args):
    """``trainer``'s procedure with a fresh model of ``args`` drawn from
    ``seed``, its state (and, partitioned, its step) made anew at ``lr``."""
    from grl_torch.models import Rngs, create_model
    from grl_torch.trainer.optimizers import set_learning_rate

    trainer.model = create_model("GraphCNNDropEdge", **{**trainer.config["model"]["args"], **args},
                                 device="cuda", generator=torch.Generator().manual_seed(seed))
    trainer.state = None
    trainer._ensure_initialized()
    set_learning_rate(trainer.state.optimizer, lr)
    trainer.rngs = Rngs.from_seed(seed, torch.device("cuda"))
    return trainer


def index_add_share(torch, fn, reps: int) -> float:
    """The share of the device time of ``reps`` calls of ``fn`` that
    ``aten::index_add_`` takes (the ring's local sum), by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    def device_us(event, name):
        # torch >= 2.4 names the device totals device_time_*, older ones cuda_time_*.
        return getattr(event, name, None) or getattr(event, name.replace("device", "cuda"), 0) or 0

    total = sum(device_us(e, "self_device_time_total") for e in events)
    ring = sum(device_us(e, "device_time_total") for e in events if e.key == "aten::index_add_")
    return ring / total if total else float("nan")


def parallel_partitioned(torch, tmp, world):
    """configs/arxiv_full_graph.yaml at {data: world}, node-partitioned (the
    ring halo exchange), bf16, dropout 0.5, DropEdge 0.3, scan_steps 10:
    20 steps and 2 evals through the warper; a float32 rates-0 step against
    the single-device port (kernel_impl xla); the learning check."""
    import grl_torch
    from grl_torch.config import load_config
    from grl_torch.trainer.procedures import FullGraphProcedure

    config = load_config(FULL_GRAPH_YAML)
    config.update(num_epochs=FULL_GRAPH_STEPS, output_dir=os.path.join(tmp, "partitioned"),
                  parallel=mesh_block({"data": world}))
    warper = grl_torch.GNNLearningWarper(config=config)
    trainer = warper.trainer
    require(trainer._partitioned, "the arxiv config under a mesh did not partition")
    part = trainer.part
    edges, Ec = int(part.mask.sum()), int(part.senders.shape[-1])
    reset_counts()
    start = time.perf_counter()
    acc = warper.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launched = sparse_counts()
    expected = {**dict.fromkeys(launched, 0), **dict.fromkeys(D_COUNTS, DROPOUTS_A_FORWARD * FULL_GRAPH_STEPS)}
    require(launched == expected, f"partitioned launched {launched}, expected {expected}")
    require(trainer.state.step == FULL_GRAPH_STEPS and all(math.isfinite(float(v)) for v in trainer.losses),
            f"partitioned: {trainer.state.step} steps, losses {[float(v) for v in trainer.losses]}")
    step_ms = events_ms(torch, trainer.train_step, PARALLEL_TIMED_STEPS)
    comm = comm_window(trainer.train_step, PARALLEL_COMM_STEPS)
    share = index_add_share(torch, trainer.train_step, 2)
    shard_n = part.num_nodes // world
    out = {"nodes": int(part.num_nodes), "edges": edges, "Ec": Ec, "cells": list(part.mask.shape),
           "padding_share": 1 - edges / part.mask.size, "shard_n": shard_n, "wall_s": wall,
           "edges_per_s": edges * FULL_GRAPH_STEPS / wall, "val_acc": acc, "launches": launched,
           "step_ms": step_ms, "comm": comm, "index_add_share": share,
           "halo_bytes_per_shift": comm.get("shift", {}).get("bytes", 0) / max(comm.get("shift", {}).get("calls", 1), 1)}
    # float32 at rates 0: one step of the world against the single-device
    # port on the whole graph (kernel_impl xla), from the same weights.
    runs = []
    f32 = {"compute_dtype": None, "dropout_rate": 0.0, "edge_dropout_rate": 0.0}
    single_config = load_config(FULL_GRAPH_YAML)
    single_config.update(num_epochs=1, output_dir=os.path.join(tmp, "partitioned-single"))
    single_config["model"]["args"]["kernel_impl"] = "xla"
    single = FullGraphProcedure(warper.model, single_config, data=trainer.data, device="cuda")
    for proc in (trainer, single):
        proc = partitioned_model(torch, proc, 11, FULL_GRAPH_LEARN_LR, **f32)
        before = params_of(proc.model)
        loss = float(proc.train_step())
        runs.append(([loss], [before, params_of(proc.model)],
                     [{n: p.grad.float().clone() for n, p in proc.model.named_parameters()}]))
    rows = compare_steps(*runs, lr=FULL_GRAPH_LEARN_LR)
    failures = step_failures(rows, FULL_GRAPH_STEP_LIMITS["float32"][:1])
    require(not failures, f"partitioned: the float32 step breaks FULL_GRAPH_STEP_LIMITS: {rows}")
    out["float32_step"] = rows
    # The learning check: PARALLEL_LEARN_STEPS steps at lr 1e-3, the
    # accuracy at each eval read back from the first rank's summaries.
    config = load_config(FULL_GRAPH_YAML)
    config.update(num_epochs=PARALLEL_LEARN_STEPS, output_dir=os.path.join(tmp, "partitioned-learn"),
                  parallel=mesh_block({"data": world}))
    config["optimizer"]["args"]["lr"] = FULL_GRAPH_LEARN_LR
    start = time.perf_counter()
    learner = grl_torch.GNNLearningWarper(config=config)
    learn_acc = learner.train()
    out["learn"] = {"steps": PARALLEL_LEARN_STEPS, "val_acc": learn_acc, "wall_s": time.perf_counter() - start}
    summaries = os.path.join(learner.config["output_dir"], "summary", "metrics.jsonl")
    if os.path.exists(summaries):
        with open(summaries) as handle:
            out["learn"]["curve"] = [[r["step"], r["value"]] for r in map(json.loads, handle)
                                     if r["tag"] == "val_accuracy"]
    require(learn_acc > FULL_GRAPH_LEARN_ACC, f"partitioned: validation accuracy {learn_acc} after "
            f"{PARALLEL_LEARN_STEPS} steps (need > {FULL_GRAPH_LEARN_ACC})")
    return out


def parallel_sampled(torch, tmp, world):
    """SampledGraphProcedure on the arxiv graph at {data: world} (groups
    max(0, world)), the tree route at B = 256, cut to 3 chunks of 20; a
    float32 rates-0 step of the world against one process's on the same
    global batch."""
    import grl_torch
    from grl_torch.trainer.procedures import SampledGraphProcedure

    config = sampled_config(os.path.join(tmp, "sampled"), PARALLEL_SAMPLED_B, True)
    config["parallel"] = mesh_block({"data": world})
    warper = grl_torch.GNNLearningWarper(config=config)
    trainer = warper.trainer
    K, G = trainer._scan_k, trainer.sampler.groups
    require(G == world, f"sampled: {G} groups at data {world}")
    data = trainer.data
    trainer.data = data._replace(
        train_mask=cut_mask(data.train_mask, PARALLEL_SAMPLED_CHUNKS * K * PARALLEL_SAMPLED_B * G),
        val_mask=cut_mask(data.val_mask, 2 * PARALLEL_SAMPLED_B * G))
    steps = PARALLEL_SAMPLED_CHUNKS * K
    reset_counts()
    start = time.perf_counter()
    acc = warper.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launched = counts(("K3", "K1", "K2", *D_COUNTS))
    expected = {"K3": 0, "K1": 0, "K2": 0, **dict.fromkeys(D_COUNTS, DROPOUTS_A_FORWARD * steps)}
    require(launched == expected and trainer.state.step == steps, f"sampled launched {launched} in "
            f"{trainer.state.step} steps, expected {expected} in {steps}")
    batch = next(iter(trainer._batches(trainer.data.train_mask)))
    step_ms = events_ms(torch, lambda: trainer.train_step(batch), PARALLEL_TIMED_STEPS)
    comm = comm_window(lambda: trainer.train_step(batch), PARALLEL_COMM_STEPS)
    out = {"groups": G, "steps": steps, "wall_s": wall, "target_nodes_per_s": steps * G * PARALLEL_SAMPLED_B / wall,
           "val_acc": acc, "launches": launched, "step_ms": step_ms, "comm": comm}
    one = {k: v for k, v in config.items() if k != "parallel"}
    one["output_dir"] = os.path.join(tmp, "sampled-one")
    one["sampler"] = dict(config["sampler"], groups=G)
    single = SampledGraphProcedure(warper.model, one, data=trainer.data, device="cuda")
    runs = []
    f32 = {"compute_dtype": None, "dropout_rate": 0.0, "edge_dropout_rate": 0.0}
    for proc in (trainer, single):
        proc = partitioned_model(torch, proc, 13, SAMPLED_LR, **f32)
        before = params_of(proc.model)
        loss = float(proc.train_step(batch))
        runs.append(([loss], [before, params_of(proc.model)],
                     [{n: p.grad.float().clone() for n, p in proc.model.named_parameters()}]))
    rows = compare_steps(*runs, lr=SAMPLED_LR)
    failures = step_failures(rows, STEP_LIMITS["float32"][:1])
    require(not failures, f"sampled: the world's float32 step breaks STEP_LIMITS: {rows}")
    out["float32_step"] = rows
    return out


# The ssl leg: each procedure's epoch trains on the first
# PARALLEL_SSL_PAGES training pages (the ssl phase's DGI leg cut), its
# validation on the 16 validation pages. Runs: (procedure, the mesh axis
# over the world, tasks).
PARALLEL_SSL_PAGES = 32
# Adam's eps in the ssl leg's float32 comparisons, as in the CPU tests of
# these procedures (tests/test_torch_ssl_procedures.py): pretraining's
# first loss is in the tens of thousands, so the clip leaves many gradient
# entries near eps 1e-8, where Adam's step lr * g / (|g| + eps) turns the
# summation-order noise of the world's all_reduce into parameter
# differences of lr/30 at step 1 and held entries lr/10 apart at step 2
# (the first H100 run: step 1 within STEP_LIMITS, gradient rel 1.6e-7;
# PERF.md §6). At 1e-3 an entry moves by lr * g / eps, in proportion to
# its gradient, so a wrong denominator or reduce still shows at step 1.
PARALLEL_SSL_ADAM_EPS = 1e-3
PARALLEL_SSL_RUNS = {
    "pretrain": ("SSLPretrainProcedure", "data", SSL_TASKS + ["dgi"]),
    "joint": ("JointTrainingProcedure", "data", JOINT_TASKS),
    "graph classification": ("GraphClassificationProcedure", "data", None),
    "pretrain tp": ("SSLPretrainProcedure", "model", SSL_TASKS),
}


def ssl_d_a_step(kind: str, tasks) -> int:
    """D's launches a train step (each way) of an ssl-leg procedure."""
    if kind == "GraphClassificationProcedure":
        return SSL_DROPOUTS_A_PASS
    passes = sum(SSL_TRUNK_PASSES[t] for t in tasks)
    # The joint step's supervised forward runs the trunk and RanPAC's dropout too.
    return SSL_DROPOUTS_A_PASS * (passes + 1) + 1 if kind == "JointTrainingProcedure" else SSL_DROPOUTS_A_PASS * passes


def first_batches(loader, count: int):
    """The first ``count`` batches of ``loader``, drawn without its prefetch
    thread (a thread left running would draw from numpy's generator, which
    every rank must draw from alike)."""
    prefetch, loader.prefetch = loader.prefetch, 0
    try:
        out = []
        for batch in loader:
            out.append(batch)
            if len(out) == count:
                return out
        return out
    finally:
        loader.prefetch = prefetch


def ssl_step_fn(trainer, batch, ssl_batch):
    """One train step of ``trainer`` (an ssl-leg procedure) on this rank's
    rows of ``batch``, placed on the card once: the step alone, for timing."""
    if hasattr(trainer, "_ssl_fn"):
        data = trainer._task_batch(batch)
        return lambda: trainer._ssl_fn(data)
    V, A, labels = trainer._prepare_batch(batch)
    if hasattr(trainer, "_joint_fn"):
        ssl = trainer._ssl_arrays(ssl_batch)
        return lambda: trainer._joint_fn(V, A, labels, ssl)
    labels = trainer._graph_labels(batch)
    return lambda: trainer._train_fn(V, A, labels, trainer.rngs, trainer._lam)


def parallel_ssl(torch, tmp, pages, world):
    """The self-supervised, joint and graph-classification procedures on the
    mesh at the ssl phase's sumi widths (float32, the plain aggregation):
    SSL pretraining with dgi, joint training and graph classification at
    {data: world}, SSL pretraining without dgi at {model: world} (SSLGCN's
    RanPAC and classifier sharded). For each: one epoch at the recipe's
    dropout through the warper, its launch counts set to 0 just before it
    and read just after, the replicas checked bit for bit after every step;
    a rank's step ms by CUDA events and its collectives by kind; then two
    float32 steps at dropout 0 (Adam eps PARALLEL_SSL_ADAM_EPS) of the
    world against one process on the whole global batches under
    STEP_LIMITS."""
    import grl_torch
    from grl_torch.models import create_model
    from grl_torch.parallel import distributed
    from grl_torch.parallel.distributed import equal_across
    from grl_torch.parallel.mesh import sharded_parameters
    from grl_torch.trainer import procedures

    dirs, classes_path, charset_path = pages
    base = train_config(tmp, dirs, classes_path, charset_path)
    train_dir = os.path.join(tmp, f"training-rank{distributed.rank()}")
    os.makedirs(train_dir)
    for name in sorted(os.listdir(dirs["training"]))[:PARALLEL_SSL_PAGES]:
        os.symlink(os.path.join(dirs["training"], name), os.path.join(train_dir, name))
    kv_train = dict(base["data_config"]["training"], data_path=[train_dir])
    kv_val = base["data_config"]["validation"]
    ssl_train = ssl_split(train_dir, classes_path, charset_path, shuffle=True)
    ssl_val = ssl_split(dirs["validation"], classes_path, charset_path, shuffle=False)
    ssl_args = {key: base["model"]["args"][key] for key in ("input_dim", "output_dim", "num_edges", "net_size",
                                                            "dropout_rate")}
    steps = PARALLEL_SSL_PAGES // B
    out = {}

    def config(name, kind, tasks, parallel, dropout_rate):
        args = dict(ssl_args, dropout_rate=dropout_rate)
        train, val = ssl_train, ssl_val
        procedure = {"type": kind, "args": {"tasks": tasks}}
        if kind == "JointTrainingProcedure":
            train, val = kv_train, kv_val
        elif kind == "GraphClassificationProcedure":
            train, val, procedure = graph_split(kv_train), graph_split(kv_val), GRAPH_PROCEDURE
            args["n_graph_classes"] = GRAPH_CLASSES
        cfg = ssl_config(base, tmp, name, "SSLGCN", args, procedure, train, val)
        # The mesh of the world, or one process (the recipe's {data: -1} out).
        cfg["parallel"] = parallel
        if not parallel:
            del cfg["parallel"]
        if kind == "JointTrainingProcedure":
            cfg["data_config"].update(ssl_training=ssl_train, ssl_validation=ssl_val)
        return cfg

    def replicas_equal(proc):
        shards = sharded_parameters(proc.state.model)
        whole = [p for p in proc.state.model.parameters() if all(p is not s for s in shards)]
        return equal_across(whole) and (not shards or proc.mesh.axis_size("data") <= 1
                                        or equal_across(shards, proc.mesh.group("data")))

    with graph_labels():
        for name, (kind, axis, tasks) in PARALLEL_SSL_RUNS.items():
            mesh = mesh_block({axis: world})
            tag = name.replace(" ", "-")
            # The main path: one epoch through the warper at the recipe's dropout.
            warper = grl_torch.GNNLearningWarper(config=config(f"par-{tag}", kind, tasks, mesh, ssl_args["dropout_rate"]))
            trainer = warper.trainer
            losses, checks = [], []
            logged = trainer._log_train_step

            def log_and_check(scores, metrics, gstep, logged=logged, losses=losses, checks=checks, trainer=trainer):
                losses.append(scores["loss"])
                checks.append(replicas_equal(trainer))
                return logged(scores, metrics, gstep)

            trainer._log_train_step = log_and_check
            reset_counts()
            start = time.perf_counter()
            metric = warper.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launched = counts(("K3", "K1", "K2", *D_COUNTS))
            expected = ssl_launches(ssl_d_a_step(kind, tasks), steps)
            require(launched == expected, f"ssl {name} launched {launched}, expected {expected}")
            require(len(checks) == steps == trainer.state.step and all(checks) and all(map(math.isfinite, losses)),
                    f"ssl {name}: {trainer.state.step} steps, replicas equal {checks}, losses {losses}")
            batch, = first_batches(trainer.train_loader, 1)
            ssl_batch = first_batches(trainer.ssl_train_loader, 1)[0] if kind == "JointTrainingProcedure" else None
            fn = ssl_step_fn(trainer, batch, ssl_batch)
            step_ms = events_ms(torch, fn, PARALLEL_TIMED_STEPS)
            comm = comm_window(fn, PARALLEL_COMM_STEPS)
            record = {"mesh": mesh["mesh"], "tasks": tasks, "dropout_rate": ssl_args["dropout_rate"], "steps": steps,
                      "wall_s": wall, "steps_per_s": steps / wall, "metric": metric, "losses": losses, "launches": launched, "d_a_step": expected["D forward"] // steps,
                      "equal_checks": len(checks), "sharded": len(trainer.sharded), "step_ms": step_ms, "comm": comm}
            # float32 at dropout 0: the world's two steps against one process's
            # on the same global batches, from the same seed-0 weights.
            runs, batches, ssl_batches = [], None, None
            for parallel in (mesh, None):
                cfg = config(f"par-{tag}-{'world' if parallel else 'one'}", kind, tasks, parallel, 0.0)
                cfg["optimizer"]["args"]["eps"] = PARALLEL_SSL_ADAM_EPS
                model = create_model("SSLGCN", **cfg["model"]["args"], device="cuda",
                                     generator=torch.Generator().manual_seed(0))
                proc = getattr(procedures, kind)(model, cfg, device="cuda", **cfg["procedure"]["args"])
                if batches is None:
                    batches = first_batches(proc.train_loader, 2)
                    if kind == "JointTrainingProcedure":
                        ssl_batches = first_batches(proc.ssl_train_loader, 2)
                if ssl_batches is not None:
                    proc.ssl_train_loader = list(ssl_batches)
                proc._ensure_initialized()
                step_losses, snapshots, grads, equal = [], [whole_params(torch, proc)], [], []
                for b in batches:
                    step_losses.append(proc._run_train_batch(b, 0)["loss"])
                    snapshots.append(whole_params(torch, proc))
                    grads.append(whole_grads(torch, proc))
                    if parallel:
                        equal.append(replicas_equal(proc))
                runs.append((step_losses, snapshots, grads))
                if parallel:
                    require(all(equal), f"ssl {name} float32: replicas differ after the steps {equal}")
            rows = compare_steps(*runs)
            failures = step_failures(rows, STEP_LIMITS["float32"])
            require(not failures, f"ssl {name}: the world's float32 steps break STEP_LIMITS at steps {failures}: {rows}")
            record["float32_steps"] = rows
            out[name] = record
    return out


def parallel_rank(tmp: str) -> int:
    """One rank of the parallel phase's world (``chip_smoke.py
    --parallel-rank DIR``, started by :func:`phase_parallel` with the
    GRL_* variables): runs every leg of PARALLEL_LEGS in turn, each with its
    launch counts set to 0 just before its main path, and writes its record
    to ``DIR/rank<r>.json``."""
    import torch

    from grl_torch.config import ConfigDict
    from grl_torch.parallel import initialize_distributed
    from grl_torch.parallel.distributed import transport

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world, backend = initialize_distributed(
        ConfigDict({"parallel": {"distributed": {"timeout": PARALLEL_COLLECTIVE_TIMEOUT_S}}}))
    with open(os.path.join(tmp, "spec.json")) as handle:
        spec = json.load(handle)
    device = torch.cuda.current_device()
    record = {"rank": rank, "world": world, "backend": backend, "transport": transport(backend, "cuda"),
              "device": device, "ranks_a_card": -(-world // torch.cuda.device_count()), "seconds": {}}
    legs = {
        "dp": lambda: parallel_dp(torch, os.path.join(tmp, "dp"), spec["pages"], world),
        "tp": lambda: parallel_tp(torch, os.path.join(tmp, "tp"), world, batches),
        "partitioned": lambda: parallel_partitioned(torch, os.path.join(tmp, "partitioned"), world),
        "sampled": lambda: parallel_sampled(torch, os.path.join(tmp, "sampled"), world),
        "ssl": lambda: parallel_ssl(torch, os.path.join(tmp, "ssl"), spec["pages"], world),
    }
    for leg in PARALLEL_LEGS:
        start = time.perf_counter()
        record[leg] = legs[leg]()
        if leg == "dp":
            record[leg], batches = record[leg]
        record["seconds"][leg] = time.perf_counter() - start
        torch.distributed.barrier()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as handle:
        json.dump(record, handle, default=float)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def nccl_leg(torch, card: str):
    """A one-rank NCCL group on the card: the DP step with its gradient
    all_reduce over it, and the ring of one (the node-partitioned step of
    one rank, its gradients reduced over it), each run eagerly and as a
    captured chunk of PARALLEL_NCCL_K steps from the same state, equal bit
    for bit (NCCL's collectives inside a CUDA graph)."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from grl_torch.data.large_graph import sbm_relational_graph
    from grl_torch.models import Rngs, create_model
    from grl_torch.parallel import make_partitioned_model_step, partition_graph
    from grl_torch.parallel.mesh import Mesh
    from grl_torch.parallel.sharded_flagship import reduce_gradients
    from grl_torch.trainer.captured import CapturedSteps
    from grl_torch.trainer.optimizers import BuiltinOptimizer
    from grl_torch.trainer.procedures.base_procedure import apply_gradients
    from grl_torch.trainer.losses import cross_entropy

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    out = {}
    try:
        group = dist.group.WORLD
        gen = torch.Generator().manual_seed(3)
        N, F_IN = 256, CHARSET_SIZE + 4
        V = torch.rand(B, N, F_IN, generator=gen).cuda().to(torch.bfloat16)
        A = (torch.rand(B, N, L, N, generator=gen) < SPARSE_DENSITY).float().cuda().to(torch.bfloat16)
        labels = torch.randint(0, NUM_CLASSES * 2 + 1, (B, N), generator=gen).cuda()
        model = create_model("GraphCNNDropEdge", **flagship_args("bfloat16"), device="cuda",
                             generator=torch.Generator().manual_seed(0))
        params = [p for p in model.parameters() if p.requires_grad]
        optimizer = BuiltinOptimizer("Adam", STEP_LR).make(params)
        rngs = Rngs.from_seed(5, torch.device("cuda"))

        def dp_step():
            model.train()
            optimizer.zero_grad(set_to_none=True)
            loss = cross_entropy(model((V, A), rngs=rngs), labels)
            loss.backward()
            summed = reduce_gradients(params, loss.detach().reshape(1), group)
            apply_gradients(optimizer, params, 5.0)
            return summed[0]

        # The ring of one: the partitioned step on an SBM with the arxiv
        # config's widths, one rank, its gradients reduced over the group.
        sbm = sbm_relational_graph(num_nodes=PARALLEL_RING_NODES, num_classes=40, num_relations=1, avg_degree=7,
                                   feature_dim=128, seed=0)
        part = partition_graph(sbm.senders, sbm.receivers, sbm.relations, sbm.weights, len(sbm.features), 1, 1)
        mesh = Mesh({"data": 1}, 0)
        mesh.groups["data"], mesh.ranks["data"] = group, [0]
        ring_model = create_model("GraphCNNDropEdge", input_dim=128, output_dim=40, num_edges=1, net_size=NET_SIZE,
                                  use_attention=False, compute_dtype="bfloat16", device="cuda",
                                  generator=torch.Generator().manual_seed(0))
        ring_params = [p for p in ring_model.parameters() if p.requires_grad]
        ring_optimizer = BuiltinOptimizer("Adam", FULL_GRAPH_LEARN_LR).make(ring_params)
        ring_step, _ = make_partitioned_model_step(ring_model, mesh, part, ring_optimizer, max_grad_norm=5.0,
                                                   device=torch.device("cuda"))
        ring_rngs = Rngs.from_seed(6, torch.device("cuda"))
        X = torch.from_numpy(np.asarray(sbm.features, np.float32)).cuda()
        y = torch.from_numpy(np.where(sbm.train_mask, sbm.labels, -100).astype(np.int64)).cuda()

        def state_of(mod, opt, generator):
            tensors = list(mod.state_dict().values())
            tensors += [v for st in opt.state.values() for v in st.values() if isinstance(v, torch.Tensor)]
            tensors += [g["lr"] for g in opt.param_groups if isinstance(g["lr"], torch.Tensor)]
            return tensors, [t.clone() for t in tensors], generator.get_state()

        def put_back(snap, generator):
            with torch.no_grad():
                for t, c in zip(snap[0], snap[1]):
                    t.copy_(c)
            generator.set_state(snap[2])

        reset_counts()
        for tag, body, mod, opt, generator in (
                ("dp", dp_step, model, optimizer, rngs.device),
                ("ring", lambda: ring_step(X, y, ring_rngs), ring_model, ring_optimizer, ring_rngs.device)):
            runner = CapturedSteps(torch.device("cuda"), [generator])
            chunk = (lambda body=body: torch.stack([body() for _ in range(PARALLEL_NCCL_K)]))
            with deterministic(torch, True):
                runner.run(tag, chunk)  # the warm-up, eager
                snap = state_of(mod, opt, generator)
                eager_losses = runner.eager(chunk).clone()
                eager_state = [t.clone() for t in state_of(mod, opt, generator)[0]]
                put_back(snap, generator)
                start = time.perf_counter()
                replayed = runner.run(tag, chunk).clone()  # the capture, then its replay
                torch.cuda.synchronize()
                capture_s = time.perf_counter() - start
            same = torch.equal(eager_losses, replayed) and all(
                torch.equal(a, b) for a, b in zip(eager_state, state_of(mod, opt, generator)[0]))
            require(same and runner.replays == 1, f"nccl {tag}: the replayed chunk differs from the eager one")
            ms = events_ms(torch, lambda: runner.run(tag, chunk), PARALLEL_TIMED_STEPS) / PARALLEL_NCCL_K
            out[tag] = {"losses": [float(v) for v in replayed], "equal_bits": same, "capture_s": capture_s,
                        "replayed_step_ms": ms, "replays": runner.replays}
        out["launches"] = counts(("K3", "K1", "K2", *D_COUNTS))
        log(f"[parallel nccl] {card}: a one-rank NCCL group; the DP step (sumi width, bf16, K1/K2, gradient "
            f"all_reduce) and the ring of one ({PARALLEL_RING_NODES} nodes), chunks of {PARALLEL_NCCL_K} eager and "
            f"replayed equal bit for bit; replayed step ms dp {out['dp']['replayed_step_ms']:.3f}, ring "
            f"{out['ring']['replayed_step_ms']:.3f}; launches {out['launches']}")
    finally:
        dist.destroy_process_group()
    return out


def comm_line(comm: dict) -> str:
    return "; ".join(f"{kind} {s['calls']:g} a step, {s['bytes'] / 1e6:.3f} MB, {s['ms']:.3f} ms"
                     for kind, s in sorted(comm.items())) or "none"


def phase_parallel(torch, card: str):
    """The multi-device slice: a world of PARALLEL_WORLD ranks through the
    GRL_* contract (this script again, with ``--parallel-rank``), each
    running the legs dp, tp, partitioned, sampled and ssl; then the nccl
    leg in this process. A rank that fails, or a world that outlives
    PARALLEL_WORLD_TIMEOUT_S, fails the phase."""
    import socket

    tmp = tempfile.mkdtemp(prefix="grl_torch_parallel_")
    pages = write_training_files(tmp)
    with open(os.path.join(tmp, "spec.json"), "w") as handle:
        json.dump({"pages": pages}, handle)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "GRL_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "GRL_NUM_PROCESSES": str(PARALLEL_WORLD),
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(PARALLEL_WORLD)]
    start = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank", tmp], cwd=tmp,
                              env={**env, "GRL_PROCESS_ID": str(r)}, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(PARALLEL_WORLD)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, PARALLEL_WORLD_TIMEOUT_S - (time.perf_counter() - start)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for handle in logs:
            handle.close()
    world_s = time.perf_counter() - start
    for r, p in enumerate(procs):
        with open(os.path.join(tmp, f"rank{r}.log")) as handle:
            text = handle.read()
        for line in text.splitlines():
            if "WARNING" in line or "Error" in line or "error" in line:
                log(f"[parallel rank {r}] {line}")
        require(p.returncode == 0, f"parallel rank {r} exited {p.returncode} after {world_s:.1f} s:\n{text[-4000:]}")
    ranks = []
    for r in range(PARALLEL_WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as handle:
            ranks.append(json.load(handle))
    head = ranks[0]
    log(f"[parallel] {card}: world {head['world']}, backend {head['backend']} ({head['transport']}), "
        f"{head['ranks_a_card']} rank(s) a card, in {world_s:.1f} s; seconds by leg "
        f"{ {leg: round(v, 1) for leg, v in head['seconds'].items()} }")
    for r, rec in enumerate(ranks):
        dp, tp, pt, sm = rec["dp"], rec["tp"], rec["partitioned"], rec["sampled"]
        where = f"rank {r} of {rec['world']} ({rec['backend']}, {rec['ranks_a_card']} rank(s) a card)"
        log(f"[parallel dp] {where}: step {dp['step_ms']:.3f} ms (CUDA events), "
            f"{dp['stepwise']['steps_per_s']:.2f} steps/s stepwise, {dp['scan_steps 4']['steps_per_s']:.2f} at "
            f"scan_steps 4 (eager chunks: {dp['scan_steps 4']['replays']} replays); collectives a step: "
            f"{comm_line(dp['comm'])}; launches {dp['stepwise']['launches']}, scanned {dp['scan_steps 4']['launches']}; "
            f"F1 {dp['stepwise']['f1']:.4f}; float32 rates 0 vs one process: loss rel diff "
            f"{[round(row['loss_rel_diff'], 8) for row in dp['float32_steps']]}, grad rel diff "
            f"{[round(row['grad_rel_diff'], 8) for row in dp['float32_steps']]}")
        log(f"[parallel tp] {where}: forward f32 {tp['float32']['forward_ms']:.3f} ms, bf16 "
            f"{tp['bfloat16']['forward_ms']:.3f} ms; classes agree f32 {tp['float32']['class_agreement']:.5f} "
            f"(max prob diff {tp['float32']['max_prob_diff']:.2e}), bf16 {tp['bfloat16']['class_agreement']:.5f} "
            f"({tp['bfloat16']['max_prob_diff']:.2e}); collectives a bf16 forward: {comm_line(tp['bfloat16']['comm'])}; "
            f"float32 step vs unsharded: grad rel diff {tp['float32_step'][0]['grad_rel_diff']:.2e}; K3 launches "
            f"of the sharded forwards by route {tp['routes']}")
        log(f"[parallel partitioned] {where}: {pt['nodes']} nodes over {head['world']} shards of {pt['shard_n']}, "
            f"{pt['edges']} edges, cells {pt['cells']}, Ec {pt['Ec']}, padding share {pt['padding_share']:.4f}; "
            f"step {pt['step_ms']:.3f} ms (CUDA events), {pt['edges_per_s']:.0f} edges/s over "
            f"{FULL_GRAPH_STEPS} steps + {FULL_GRAPH_EVALS} evals; halo {pt['halo_bytes_per_shift'] / 1e6:.3f} MB a "
            f"shift; collectives a step: {comm_line(pt['comm'])}; index_add_ share of device time "
            f"{pt['index_add_share']:.3f}; launches {pt['launches']}; float32 step vs one device: grad rel diff "
            f"{pt['float32_step'][0]['grad_rel_diff']:.2e}; learning: val acc {pt['learn']['val_acc']:.4f} after "
            f"{pt['learn']['steps']} steps in {pt['learn']['wall_s']:.1f} s (by step: {pt['learn'].get('curve')})")
        log(f"[parallel sampled] {where}: groups {sm['groups']}, {sm['steps']} steps, {sm['target_nodes_per_s']:.1f} "
            f"target nodes/s, step {sm['step_ms']:.3f} ms; collectives a step: {comm_line(sm['comm'])}; launches "
            f"{sm['launches']}; float32 step vs one process: grad rel diff {sm['float32_step'][0]['grad_rel_diff']:.2e}")
        for name, leg in rec["ssl"].items():
            comm = dict(leg["comm"])
            denominators = comm.pop("denominator all_reduce", None)
            log(f"[parallel ssl {name}] {where}: mesh {leg['mesh']}, tasks {leg['tasks']}, {leg['sharded']} sharded "
                f"parameter(s); one epoch at dropout {leg['dropout_rate']}: {leg['steps']} steps + validation in "
                f"{leg['wall_s']:.3f} s = {leg['steps_per_s']:.3f} steps/s; step {leg['step_ms']:.3f} ms (CUDA events); "
                f"launches {leg['launches']} (D {leg['d_a_step']} a step each way); replicas equal bit for bit after "
                f"{leg['equal_checks']} steps; float32 dropout 0 vs one process: loss rel diff "
                f"{[round(row['loss_rel_diff'], 8) for row in leg['float32_steps']]}, grad rel diff "
                f"{[round(row['grad_rel_diff'], 8) for row in leg['float32_steps']]}")
            log(f"[parallel ssl {name}] {where}: collectives a step: {comm_line(comm)}")
            log(f"[parallel ssl {name}] {where}: denominator all_reduce a step: "
                + (comm_line({"denominator all_reduce": denominators}) if denominators else "none (one loss term)"))
    nccl = nccl_leg(torch, card)
    return {"world": head["world"], "backend": head["backend"], "transport": head["transport"],
            "ranks_a_card": head["ranks_a_card"], "world_s": world_s, "ranks": ranks, "nccl": nccl}


# ---------------------------------------------------------------------------
# gather_probe
# ---------------------------------------------------------------------------
def phase_gather_probe(torch, card: str, kernel_rows):
    """``grl_torch.probes.gather`` at full size (path B): the probe's
    measurement is the main path; its kernels are then held against their
    plain versions. Prints each probe's M rows/s and GB/s beside the HBM
    peak, and the measured gather floor of K5, K6 (the A rate at 512-byte
    rows) and K4 (the C rate at its 256-byte h rows)."""
    from grl_torch.probes import gather

    start = time.perf_counter()
    inputs = gather.make_inputs("cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    # The main path: every launch count starts at 0 here.
    gather.reset_launches()
    record = gather.measure(inputs)
    torch.cuda.synchronize()
    launches = {name: kernel.launches for name, kernel in gather.KERNELS.items()}
    require(all(launches.values()), f"the probe launched {launches}")
    errors = gather.check_kernels(inputs)
    for key, err in errors.items():
        record["kernels"][key]["max_abs_err"] = err
    peak_rows = record["hbm_peak_rows_per_s_f32"]
    log(f"[gather_probe] {card}: inputs made in {setup_s:.2f} s; shapes {record['shapes']}; HBM peak "
        f"{peak_rows} M rows/s of 512 B ({HBM_BYTES_PER_S / 1e9:.0f} GB/s); launches {launches}")
    for name, rate in record["results"].items():
        log(f"[gather_probe] {name}: {rate} M rows/s, {record['gb_per_s'][name]} GB/s "
            f"({record['gb_per_s'][name] * 1e9 / HBM_BYTES_PER_S:.3f} of the HBM peak)")
    for key, row in record["kernels"].items():
        log(f"[gather_probe] P-{key}: kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, max abs "
            f"err {row['max_abs_err']:.3e}")
        if key.startswith("G"):
            rate = row["rows"] / row["device_ms"] * 1e-3
            log(f"[gather_probe] P-{key}: {row['rows'] // row['chunk'] // row['cluster']} output rows, each over a "
                f"cluster of {row['cluster']} CTAs of {row['warps']} warps with {row['depth']} row copies in flight "
                f"a warp ({row['rows_in_flight']} rows, {row['rows_in_flight'] * gather.F * 4 / 1e6:.1f} MB in flight "
                f"on the card; {row['smem']} bytes of shared memory a CTA): {rate:.1f} M rows/s, "
                f"{row['bytes'] / row['device_ms'] * 1e-6:.1f} GB/s by device time ({peak_rows} M rows/s at the HBM "
                f"peak); device ms by cluster x warps x depth {row['sweep_device_ms']}")
    log("[gather_probe] E1, E2, F = plain versions exactly; G within 1e-5 of the largest sum")
    a_rate = record["results"]["A_index_select_random_f32"] * 1e6
    c_rate = record["results"]["C_index_select_random_bf16"] * 1e6
    floors = {}
    for row in kernel_rows:
        if row["dtype"] != "bfloat16" or "ms" not in row or not row["kernel"].startswith(("K4 ", "K5", "K6")):
            continue
        if row["kernel"].startswith("K4"):
            floor_ms = row["edges"] / c_rate * 1e3
        elif row["F"] == NET_SIZE:  # 512-byte bf16 rows, as A's float32 ones
            floor_ms = row["kept_edges"] / a_rate * 1e3
        else:
            continue
        floors[row["kernel"]] = {"measured_gather_floor_ms": floor_ms, "kernel_ms": row["ms"],
                                 **{key: row[key] for key in ("device_ms", "one_slice_ms", "one_slice_device_ms",
                                                              "slices", "in_l2_device_ms") if key in row}}
        log(f"[gather_probe] measured gather floor of {row['kernel']} bf16: {floor_ms:.4f} ms "
            f"({'E / C' if row['kernel'].startswith('K4') else 'kept edges / A'} rate) against the kernel's "
            f"{row['ms']:.4f} ms{slicing_note(row)} and the HBM-peak estimate {row['gather_floor_ms']:.4f} ms")
    record.update(setup_s=setup_s, launches=launches, measured_gather_floors=floors)
    return record


# ---------------------------------------------------------------------------
def write_record(record) -> None:
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as handle:
        json.dump(record, handle, indent=1)


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "grl_torch")):
        log("FAIL: the grl_torch package is not beside chip_smoke.py; run from a checkout")
        return 1
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this smoke test runs on an NVIDIA GPU")
        return 1
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--parallel-rank"]:
        # One rank of the parallel phase's world (phase_parallel starts it).
        return parallel_rank(sys.argv[2])
    torch.cuda.set_device(0)

    # The record of every phase that finished is written even when a later
    # one fails.
    record = {"phase_seconds": {}}
    clock = [time.perf_counter()]

    def timed(name):
        now = time.perf_counter()
        record["phase_seconds"][name] = now - clock[0]
        clock[0] = now

    try:
        record["card"] = card = phase_env(torch)
        timed("env")
        kernel_rows, kernel_checks = phase_kernel(torch)
        record.update(kernel_cases=kernel_rows, kernel_checks=kernel_checks)
        timed("kernel")
        record["serve"] = serve = phase_serve(torch)
        timed("serve")
        record["train"] = train = phase_train(torch, card)
        timed("train")
        record["train_variants"] = variants = phase_train_variants(torch, card)
        timed("train_variants")
        record["ssl"] = ssl = phase_ssl(torch, card)
        timed("ssl")
        record["zoo"] = zoo = phase_zoo(torch, card)
        timed("zoo")
        record["full_graph"] = full_graph = phase_full_graph(torch, card)
        timed("full_graph")
        record["ell"] = ell_path = phase_ell(torch, card)
        timed("ell")
        record["tile"] = tile_path = phase_tile(torch, card)
        timed("tile")
        record["tile_variants"] = tile_variants = phase_tile_variants(torch, card, tile_path["launches"])
        timed("tile_variants")
        record["sampled"] = sampled = phase_sampled(torch, card)
        timed("sampled")
        record["demo"] = phase_demo(torch, card)
        timed("demo")
        record["gather_probe"] = probe = phase_gather_probe(torch, card, kernel_rows)
        timed("gather_probe")
        record["parallel"] = parallel = phase_parallel(torch, card)
        timed("parallel")
    finally:
        write_record(record)
    log(f"[done] seconds by phase: { {k: round(v, 1) for k, v in record['phase_seconds'].items()} }")

    def main_row(kernel, dtype="bfloat16", **shape):
        return next(r for r in kernel_rows
                    if r["kernel"] == kernel and r["dtype"] == dtype
                    and all(r.get(k) == v for k, v in shape.items()))

    dense = {"N": 256, "F": NET_SIZE, "density": SPARSE_DENSITY}
    fg, el, tp = full_graph["launches"], ell_path["launches"], tile_path["launches"]
    f32, ragged = variants["float32"], variants["bfloat16 ragged"]
    scan = train["scan"]
    k3_replaces = "grl_tpu/ops/pallas/relagg.py:99 _agg_forward (pallas_neighbor_aggregate)"
    k1_replaces = "grl_tpu/ops/pallas/relagg.py:220 _dropedge_forward (pallas_dropedge_aggregate)"
    k2_replaces = "grl_tpu/ops/pallas/relagg.py:284 _dropedge_bwd"
    # Launches of a path per kernel: K3 and K2 by route, K1 by dtype (the
    # full-graph paths run none of them).
    sources = {
        "K3": ("K3 relational neighbor aggregation (bf16, N % 8 == 0 and F % 8 == 0)",
               "grl_torch/csrc/dropedge_sm90.cu", k3_replaces,
               {"serve": serve["k3_routes"]["sm90"], "train": train["routes"]["K3"]["sm90"],
                "train scan_steps 4": scan["routes"]["K3"]["sm90"], "ssl finetune": ssl["finetune"]["routes"]["K3"]["sm90"],
                "ssl serve": ssl["launches"]["serve"]["K3"], "full_graph": fg["K3"], "ell": el["K3"]},
               main_row("K3", **dense), "bf16 B=8 N=256 L=6 F=256"),
        "K3 ragged": ("K3 relational neighbor aggregation (bf16, other N and F: cp.async + wgmma)",
                      "grl_torch/csrc/relagg_ragged.cu",
                      k3_replaces, {"train_variants bfloat16 ragged": ragged["routes"]["K3"]["ragged"]},
                      main_row("K3", N=RAGGED_N, F=NET_SIZE), f"bf16 B=8 N={RAGGED_N} L=6 F=256"),
        "K3 f32": ("K3 relational neighbor aggregation (float32)", "grl_torch/csrc/dropedge_f32.cu", k3_replaces,
                   {"train_variants float32": f32["routes"]["K3"]["float32"]},
                   main_row("K3", "float32", **dense), "f32 B=8 N=256 L=6 F=256"),
        "K1": ("K1 DropEdge neighbor aggregation (forward, bf16)", "grl_torch/csrc/dropedge_sm90.cu", k1_replaces,
               {"train": train["launches"]["K1"], "train scan_steps 4": scan["launches"]["K1"],
                "ssl finetune": ssl["launches"]["finetune"]["K1"], "full_graph": fg["K1"], "ell": el["K1"]},
               main_row("K1", **dense), "bf16 B=8 N=256 L=6 F=256 rate=0.3"),
        "K1 f32": ("K1 DropEdge neighbor aggregation (forward, float32)", "grl_torch/csrc/dropedge_f32.cu",
                   k1_replaces,
                   {"train_variants float32": f32["launches"]["K1"]},
                   main_row("K1", "float32", **dense), "f32 B=8 N=256 L=6 F=256 rate=0.3"),
        "K2": ("K2 DropEdge neighbor aggregation (backward, dV, bf16)", "grl_torch/csrc/dropedge_sm90.cu",
               k2_replaces, {"train": train["routes"]["K2"]["sm90"], "train scan_steps 4": scan["routes"]["K2"]["sm90"],
                             "ssl finetune": ssl["finetune"]["routes"]["K2"]["sm90"], "full_graph": fg["K2"],
                             "ell": el["K2"]},
               main_row("K2", **dense), "bf16 B=8 N=256 L=6 F=256 rate=0.3"),
        "K2 f32": ("K2 DropEdge neighbor aggregation (backward, dV, float32)", "grl_torch/csrc/dropedge_f32.cu",
                   k2_replaces, {"train_variants float32": f32["routes"]["K2"]["float32"]},
                   main_row("K2", "float32", **dense), "f32 B=8 N=256 L=6 F=256 rate=0.3"),
        "K5 forward": ("K5 CSR relational aggregation with DropEdge (forward)", "grl_torch/csrc/csr_spmm.cu",
                       "grl_tpu/ops/pallas/csr_spmm.py:300 csr_accumulate",
                       {"full_graph": fg["K5 forward"], "ell": el["K5 forward"]}, main_row("K5 forward", F=NET_SIZE),
                       "bf16 N=169343 E=1184773 L=1 F=256 rate=0.3"),
        "K5 backward": ("K5 CSR relational aggregation with DropEdge (backward, transposed layout)",
                        "grl_torch/csrc/csr_spmm.cu", "grl_tpu/ops/pallas/csr_spmm.py:300 csr_accumulate",
                        {"full_graph": fg["K5 backward"], "ell": el["K5 backward"]}, main_row("K5 backward", F=NET_SIZE),
                        "bf16 N=169343 E=1184773 L=1 F=256 rate=0.3"),
        "K4": ("K4 fused sparse attention (SDDMM + softmax + SpMM)", "grl_torch/csrc/sparse_attention.cu",
               "grl_tpu/ops/pallas/sparse_attention.py:106 _bucket_forward_pallas",
               {"full_graph": fg["K4"], "ell": el["K4"]}, main_row("K4 arxiv"), "bf16 N=169343 E=1184773 K=16 F=128"),
    }
    k4b_replaces = ("grl_tpu/ops/pallas/sparse_attention.py:206-259 attend_bwd (the custom VJP of K4; XLA, a hand "
                    "kernel for XLA code)")
    for walk in ("receivers", "senders"):
        sources[f"K4b {walk}"] = (
            f"K4b K4's backward, the {walk[:-1]}-major walk", "grl_torch/csrc/sparse_attention_bwd.cu", k4b_replaces,
            {"full_graph": fg[f"K4b {walk}"], "ell": el[f"K4b {walk}"]}, main_row(f"K4b {walk} arxiv"),
            "bf16 N=169343 E=1184773 K=16 F=128")
    dropout_main = max((r for r in kernel_rows if r["kernel"] == "D forward" and r["dtype"] == "bfloat16"),
                       key=lambda r: r["F"])
    for direction in ("forward", "backward"):
        name = f"D {direction}"
        sources[name] = (
            f"D dropout with K0's hashed mask ({direction})", "grl_torch/csrc/dropout.cu",
            "grl_tpu/models/gcn_family.py:114,245 flax nn.Dropout (XLA, a hand kernel for XLA code)",
            {"train": train["launches"][name], "train scan_steps 4": scan["launches"][name],
             "train_variants float32": f32["launches"][name], "train_variants bfloat16 ragged": ragged["launches"][name],
             **{f"ssl {leg}": n[name] for leg, n in ssl["launches"].items()},
             **{f"zoo {leg}": n[name] for leg, n in zoo["launches"].items()},
             "full_graph": fg[name], "ell": el[name], "tile": tp[name],
             **{f"sampled {leg}": sampled[leg]["launches"][name] for leg in SAMPLED_LEGS},
             **{f"sparse_kv {leg}": n["launches"][name] for leg, n in sampled["sparse_kv"].items()}},
            main_row(name, F=dropout_main["F"]), f"bf16 ({dropout_main['N']}, {dropout_main['F']}) rate 0.5")
    for direction in ("forward", "backward", "projected forward", "projected backward"):
        sources[f"K6 {direction}"] = (
            f"K6 ELL gather-table aggregation with DropEdge ({direction})", "grl_torch/csrc/ell.cu",
            "grl_tpu/ops/ell.py:244-320 ell_aggregate / ell_aggregate_projected (XLA gathers; a hand kernel "
            "for XLA code)", {"ell": el[f"K6 {direction}"], "full_graph": fg[f"K6 {direction}"],
                              "tile": tp[f"K6 {direction}"]},
            main_row(f"K6 {direction}", F=NET_SIZE),
            f"bf16 N=169343 E=1184773 L=1 F=256 rate=0.3, the config's kernel_plan ({direction} tables)")
    k7_replaces = ("grl_tpu/ops/tile.py:220 _apply_tables, via tile_aggregate (:502) / tile_aggregate_projected "
                   "(:565) (XLA; a hand kernel for XLA code)")
    k7_routes = {"persistent": ("", "bfloat16", "bfloat16", {"tile": tp, "full_graph": fg, "ell": el}),
                 **{route: (f", {route} route", dtype_name, "float32",
                            {f"tile_variants {dtype_name}": tile_variants[dtype_name]["launches"]})
                    for dtype_name, route in TILE_VARIANTS.items()}}
    for route, (suffix, dtype_name, tile_dtype, paths) in k7_routes.items():
        for direction in ("forward", "backward", "projected forward", "projected backward"):
            sources[f"K7 {direction}{suffix}"] = (
                f"K7 tile-dense aggregation with the pair-hash DropEdge ({direction}; {tile_dtype} tiles under "
                f"{dtype_name} operands, the {route} route)", "grl_torch/csrc/tile.cu", k7_replaces,
                {path: launched[f"K7 {direction}"] for path, launched in paths.items()},
                main_row(f"K7 {direction}", dtype_name, F=NET_SIZE, tile_dtype=tile_dtype),
                f"{dtype_name} operands, {tile_dtype} tiles, N=169343 E=1175131 ({TILE_COMMUNITIES} communities) "
                f"L=1 F=256 rate=0.3, B=128: {TILE_EXPECTED['tiles_total']} tiles ({direction} tables)")
    pallas_lines = {"E1": ":154 vmem_take_kernel", "E2": ":177 vmem_tala_kernel", "F": ":219 windowed_kernel",
                    "G": ":285 dma_kernel"}
    shapes = probe["shapes"]
    for key, line in pallas_lines.items():
        row = probe["kernels"][key]
        sources[f"P-{key}"] = (
            f"P-{key} gather-rate probe ({row['name']})", "grl_torch/csrc/gather_probe.cu",
            f"scripts/probe_gather.py{line}", {"gather_probe": probe["launches"][key]},
            row,
            f"f32 F=128, {row['rows']} rows gathered, window {shapes['window_rows']} rows"
            + (f", {shapes['G_blocks'][0]} blocks of {shapes['G_rows_per_block']} rows" if key == "G" else ""))
    # The parallel phase's launches, rank by rank: K1/K2/K3 and D of the
    # dp leg (bf16, the sm90 route), tp's sharded forwards' K3 by route, D of
    # the partitioned, sampled and ssl legs, and the nccl leg's in this
    # process.
    for r, rank in enumerate(parallel["ranks"]):
        legs = {"dp": rank["dp"]["stepwise"]["launches"], "dp scan_steps 4": rank["dp"]["scan_steps 4"]["launches"],
                "partitioned": rank["partitioned"]["launches"], "sampled": rank["sampled"]["launches"],
                **{f"ssl {name}": leg["launches"] for name, leg in rank["ssl"].items()}}
        for leg, launched in legs.items():
            for name in ("K3", "K1", "K2", *D_COUNTS):
                if launched.get(name):
                    sources[name][3][f"parallel {leg} rank {r}"] = launched[name]
        for dtype_name, routes in rank["tp"]["routes"].items():
            for route, name in (("sm90", "K3"), ("float32", "K3 f32")):
                if routes.get(route):
                    sources[name][3][f"parallel tp {dtype_name} rank {r}"] = routes[route]
    for name in ("K1", "K2", *D_COUNTS):
        if parallel["nccl"]["launches"].get(name):
            sources[name][3]["parallel nccl"] = parallel["nccl"]["launches"][name]
    kernels = []
    for name, source, replaces, by_path, row, shape in sources.values():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "kernel_ms": row["ms"],
            "device_ms": row.get("device_ms"),
            "enqueue_ms": row.get("enqueue_ms"),
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "bound_fp32_ms": row.get("bound_fp32_ms"),
            "library_ms": row["library_ms"],
            "shape": shape,
            **{key: row[key] for key in ("slices", "slice_cols", "l2_bytes", "one_slice_ms", "one_slice_device_ms",
                                         "group", "blocks", "in_l2_device_ms", "stages", "feed", "smem",
                                         "stages_device_ms", "group_device_ms", "cluster", "warps", "depth",
                                         "rows_in_flight", "sweep_device_ms", "tiles", "slots",
                                         "k6_all_edges_ms", "k6_all_edges_device_ms", "k6_residual_ms",
                                         "k6_residual_device_ms", "plan_route", "BN", "chunks", "consumers", "ctas",
                                         "rate0_ms", "simple_ms", "simple_rate0_ms", "breakeven_edges_per_tile")
               if key in row},
        })
    record["kernels"] = kernels
    write_record(record)
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
