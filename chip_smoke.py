#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It drives the port only (never the JAX package) through these phases and
exits non-zero if any one fails:

  1. environment: build the CUDA kernels from ``src/repro_torch/csrc``
     (one nvcc per source, all started together), print the build time,
     the torch/CUDA versions, the card's name and power limit, its SM
     clocks and the cycles of one dependent shared-memory load;
  2. ragged kernel cases: every kernel against its plain PyTorch version
     on small edge-case inputs, exact equality (bsr_spmm, whose sums run
     in another order, within rtol 1e-5 / atol 1e-5, its largest error
     printed as a share of that allowance, its finite ragged shapes also
     on eight more seeds); lp_move also on
     chunks that load its phase B (no candidate; every row a candidate to
     one target, R = 4,500 and 70,001; candidates spread over ~2^21
     labels; -1 lanes anywhere in a row), each also timed beside its
     count of candidates; seg_merge on ragged lengths, ids at a key-width
     boundary, I32_MAX in one half only, negative and full-width ids, one
     key over several tiles, all records invalid, wrapping run totals
     and L = 2^22 + 1; embedding_bag at D=64 with BAG 1, 4 and 17 and
     B not a multiple of its bags per thread; bsr_spmm with +-inf and NaN
     in X (one inf met only by zero weights, which the plain version
     turns into NaN), values beyond its TF32 split's range and an inf in
     A; lp_gain on operands built by its entry point at 32 and 128 lanes;
     bal_scores on the fused round's operands (ELL ids with -1 lanes
     first or anywhere, rows with no valid lane, hub rows of 160 and 256
     lanes, K = 8192 restricted, block tables summed from the labels);
     greedy_pick at K = 1, K = 2^20, pool ids out of [0, K) and M over
     three of its 512-entry passes; lp_move and bal_scores on chunks
     with heavy rows (more arcs than the slab's 32 lanes, the rest in
     overflow: the kernels' heavy-row paths), among them a row of
     30,000 arcs, a label (block) held in both the slab and the
     overflow, a heavy row with no admissible target and one label over
     30,000 arcs; and the distributed engine's forms: lp_move's heavy
     rows in the distributed admission form (the labels' budgets in the
     slab and the overflow) and bal_scores on a PE's label table (lanes
     into [locals, ghosts, sentinel], the ghost rows empty, validity a
     prefix of the rows), with and without heavy rows;
  3. the anchor: rgg2d n=4000, k=16, eps=0.03 with the benchmark config
     (C=256, 4 chunks, 2 IP repetitions) must give cut 819, feasible,
     under ``kernel="fused"`` and ``kernel="composed"``;
  4. the main path: ``Partitioner(backend="single").run`` on rgg2d
     n=2^20, k=16, preset ``fast``, fused, must give cut 15465 (the JAX
     reference's), feasible, with every kernel launched (launch counts
     zeroed just before the run, read just after it): 120 lp_move calls
     and no heavy-row launch (rgg2d's degrees fit the 32-lane slab). The
     port has no fused-to-composed fallback: a fused call launches its
     kernel or raises. Each lp_move call's count of phase-B candidates (by the plain
     version's rule on its inputs) is printed, and each seg_merge call's
     length, key width and radix passes; so are the seconds each trace
     phase spent in the host functions permute, degree_bucket_order,
     build_move_chunks, lp.build_chunks, contract and dedup_arcs (the
     module attributes wrapped, not edited);
  5. each kernel against its plain version on the largest input the main
     path gave it (captured during phase 4), exact equality, both timed
     with CUDA events; beyond the main path, seg_merge on the 2^20
     graph's 8,378,246 arcs merged in vertex pairs and the balancer at
     the finest level (a skewed partition, its own launch counts printed
     apart). lp_move's and seg_merge's device launches per call (nodes of
     a captured CUDA graph) must be the same at the main path's largest
     call and at 67 rows / 5 records of it, at most 12, and a call must
     not wait for the stream (``set_sync_debug_mode("error")``);
     seg_merge's device time is printed L2-warm and L2-cold (four input
     copies in turn), the plain version's alike, beside one torch.sort of
     its packed keys ("sort only", a yardstick); bal_scores and
     greedy_pick, at the main path's call and at the finest level, must
     make one device launch a call and wait for nothing, their device
     times printed; the finest-level balancer prints its rounds, wall and
     peak device memory, and its last round's device time split into the
     score stage, the pool sort and greedy_pick (greedy_pick's bound is
     its M dependent steps, each one shared-memory load-to-use latency,
     measured in phase 1 by a pointer chase, at the card's maximum SM
     clock);
  6. the kernels off the main path, each through its own entry point at
     full size on the default (CUDA) device, with launch counts zeroed
     just before and read just after each: ``lp_gain`` on the 2^20 graph
     with phase 4's assignment (labels, block weights, L_max), checked
     against an edge scan; ``spmm`` on grid2d 1024x1024 with F=128,
     checked against a COO sum in f64, with its device launches per call
     (a captured CUDA graph), its device time and the share of all-zero
     A sub-tiles it skips; lp_gain's lane
     width, slab bytes, and its kernel and entry-point times at the
     reference's 128 lanes beside its default 32 (the same bits);
     ``embedding_bag`` on one dlrm-rm2
     table (V=10^6, D=64, B=65,536, BAG 1 and 4), checked against a
     sequential numpy sum. Each kernel is held to its plain version on
     the inputs its entry point gave it (exact; bsr_spmm within rtol
     1e-5 / atol 1e-5) and timed beside its bound and, for bsr_spmm and
     embedding_bag, the PyTorch library call that computes the same
     function (a yardstick the port never calls). embedding_bag's row is
     the launch path its entry point uses (indices checked on the host),
     timed over 8 index sets in turn so that the gathered rows do not
     stay in L2 (the library call alike), with the checked wrapper's
     time, its device launches per call, its device time L2-cold and
     L2-warm and the no-stream-wait check printed beside it;
  7. the unconstrained refinement tier, the baselines, the CLI and a
     session. First ``PartitionSession(devices=1, max_workers=4)
     .run_batch`` of rgg2d n=2000 (graph seeds 0-2, k=8, C=64, and seed 0
     again with ``quality="best"``) with the kernels loaded anew from a
     fresh build directory, so that the build lock meets concurrent first
     loads: nvcc must run at most once a source, every result must equal
     a solo run's and the reference's cut. Then ``Partitioner(backend=
     "single").run`` of phase 4's request with ``refine="unconstrained"``
     (launch counts zeroed just before and read just after; every
     main-path kernel launched): cut, feasibility, the per-level trace and
     every ``refine-mode`` record (penalty, repair rounds) must equal the
     JAX reference's (``benchmarks/torch_reference_anchors.py``), printed
     with its wall and per-phase times beside phase 4's and every
     rebalance call's rounds and seconds (the afterburner's), and each of the
     four kernels held to its plain version on the largest input this run
     gave it; ``Partitioner.compare`` of the same request against
     ``plain_mgp`` and ``single_level_lp`` must give the reference's cuts,
     feasible; ``python -m repro_torch.launch.partition --family rgg2d
     --n 4000 --k 16 --compare --trace`` must exit 0 with three summary
     lines of the reference CLI's cuts;
  8. serving. (a) The stacked level-0 clustering of three requests on
     phase 4's graph (request seeds 0-2, k=16, preset fast) with
     ``kernel="fused"`` must equal the composed stacked form on the card
     and three solo ``cluster(kernel="fused")`` calls, in 24 stacked
     ``lp_move`` calls and no solo one; one stacked call at the level-0
     chunk shape (S=3, R=262,144, D=32) is held to its plain version
     (exact), to the three solo calls of the same chunks, timed (wrapper
     and device time) beside those three calls, its device launches
     counted (a captured graph: as many as a solo call's) and its bound
     printed: the three requests' valid lanes over 3.35 TB/s. (b) A
     burst through ``PartitionServer(meshes=2, batch_max=8,
     batch_window_ms=50)``: rgg2d n=65,536, k=16, fast, request seeds
     0-5 twice (priorities 0/1) and seed 0 with ``quality="best"`` and a
     600 s deadline, which admission downgrades to fast: every result ok
     and equal to a solo run, the stacked kernel launched; its stats and
     launch counts printed. (c) ``PartitionSession(stack="auto")
     .submit_many`` of seed 0 fast, seed 1 fast, seed 0 best and seed 0
     fast again on phase 4's graph: cuts 15465 and 15308 for seed 0, the
     assignments of phases 4 and 7, seed 1 its solo run's, the duplicate
     coalesced, the three distinct level 0s stacked (launch counts
     checked), the batch's wall beside the solo walls. (d) ``python -m
     repro_torch.launch.serve --meshes 2 --requests 12 --n 4000 --k 8
     --verify`` must exit 0. (e) 8b's burst through a port ``FrontDoor``
     and two worker processes (``python -m repro_torch.launch.fabric
     worker``, one ``PartitionServer(meshes=1)`` each, on the card):
     every result ok in one attempt and equal to its solo run, both
     workers serving, each exiting 0 after SIGTERM; its wall beside 8b's
     and each worker process's CPU seconds;
  9. hub graphs: ``Partitioner().run`` of ba at n=2^18 and rhg at 2^17
     (both at 2^20 with ``--hubs-only``, which runs phases 1 and 9 only
     and prints no contract line; seed 17, k=16, preset fast) at
     ``kernel="auto"`` (fused, hub rows through the heavy-row paths) and
     ``kernel="composed"`` on the card: equal cuts,
     bit-identical assignments, no kernel-fallback record, every kernel
     of the fused path launched and none by composed; each run's wall,
     peak device memory and launch counts, the level-0 ELL slab and
     overflow bytes beside the CSR's (held to the ``slab_width`` rule's
     bound); the lp_move and bal_scores calls with the most heavy-row
     lanes held to their plain versions (exact) and timed beside their
     bounds (rows ``lp_move_heavy`` and ``bal_scores_heavy``);
 10. the distributed engine at P=1: ``Partitioner(backend="dist")`` with
     ``devices=1`` in a one-rank NCCL group, on phase 4's graph (rgg2d
     2^20, k=16, eps=0.03, preset fast) in both memory models (the
     default, and ``contraction="sharded"``, ``balance="dist"``,
     ``weights="owner"``), each with ``kernel="fused"`` and
     ``kernel="composed"``: the two bit-identical, and both equal to the
     JAX reference's answer on the CPU at the same request (cut, trace
     and the sha256 of the assignment, from ``benchmarks/
     torch_reference_anchors.py --dist``); each run's wall, per-phase
     trace seconds, launch counts (the distributed forms ``lp_move_dist``
     and ``bal_scores_dist`` apart), collective count and peak device
     memory printed; the fused runs must launch lp_move's distributed
     form, greedy_pick, seg_merge (sharded model) and bal_scores' table
     form (dist balancer), the composed runs nothing. Then ba at 2^18
     (seed 17) in the sharded model, fused against composed,
     bit-identical, with lp_move's heavy rows launched in the distributed
     form. The largest distributed-form call of each kernel is held to
     its plain version (exact) and timed beside its bound (rows
     ``lp_move_dist``, ``bal_scores_dist``, ``lp_move_heavy_dist`` and,
     if the hub run launched it, ``bal_scores_heavy_dist``).
 11. a mesh of rank processes: ``make_mesh_1d(1)`` spawns one rank on
     card 0 (its spawn time printed), and ``PartitionSession(devices=1,
     mesh=..., max_workers=1).run_batch`` serves phase 10's request in
     both memory models (``kernel="fused"``, the graph sent as arrays)
     and phase 4's ``single`` request (in this process): the first two
     must equal phase 10's answers (cut 5917, the assignment's sha256
     and the trace), the third phase 4's assignment. Each mesh call's
     seconds (send to answer) are printed beside phase 10's in-process
     fused wall (the difference is the mesh's transfer cost) and the
     rank's launch counts, reported back with each answer (zeroed just
     before the batch): lp_move's distributed form, greedy_pick,
     seg_merge and bal_scores' table form must have launched there.
     With two cards or more the session also runs at P=2 (skipped on a
     one-card machine). Then ``python -m repro_torch.launch.selftest
     --devices 1 --test all kernels --n 2000`` on the card: every line
     is printed and must pass.
 12. the placement engine and the models it places, forward only, TF32
     off: (a) ``gnn_placement.plan`` of phase 4's graph with its ids
     shuffled (``np.random.default_rng(0).permutation``) on 8 devices,
     ``fast_config(seed=0)``, fused: its cut and the sha256 of every
     vertex's block must be the JAX reference's, the placed graph the
     input relabelled, fewer halo bytes than the naive split; lp_move
     and seg_merge must have launched, and bal_scores with greedy_pick
     or neither: they run only for an infeasible level, and this one
     has none (the launches of the four main-path kernels printed,
     zeroed just before); (b) GAT at
     its full CONFIG on the placed graph, held (rtol = atol = 1e-5) to
     its forward on the input read through ``perm``, and on the
     full_graph_sm shape to its CPU forward; (c) SchNet, NequIP and
     DimeNet at full CONFIG on the molecule shape (128 graphs x 30 atoms
     bonded along their 64 closest pairs), held to their CPU forwards
     (1e-5, 1e-4, 1e-4), NequIP also under a random rotation; (d) DLRM
     at full CONFIG (6.66 GB of tables) at serve_p99 (held to the CPU
     over the table rows it reads) and serve_bulk, and
     ``retrieval_score`` over 10^6 candidates (top-k scores held to the
     CPU's, ids equal but where scores tie within the tolerance); (e)
     ``dlrm_placement.plan`` of (d)'s serve_bulk lookups on 4 shards and
     ``moe_placement.plan`` of synthetic top-2 routing of arctic's 128
     experts (2^20 tokens) and top-8 of granite's 32 (2^16) on 4 pods:
     feasible, and no more cross-pod traffic than the naive split.
     Forward times by CUDA events, with peak device memory.
 13. the decoder-only LMs (``models/transformer.py``), forward only, TF32
     off, bf16 products accumulated in float32; random weights from a
     seed (``lm_params``: each layer matrix at 1/sqrt of its contraction
     width). (a) qwen2-7b at its full 28-layer CONFIG: ``forward`` at
     B=1 x S=8192 and 32 greedy ``decode_step``s at B=8 over a 32768
     cache whose first 32736 positions hold random K/V; (b) gemma-2b,
     stablelm-12b and granite-moe-1b at full CONFIG and (c) arctic-480b
     at full width and 2 of its 35 layers: prefill 1 x 2048 and 16 steps
     at B=8 over a 4096 cache. Each bf16 prefill's logits are held to
     the same weights and tokens at float32 compute (granite's also,
     and arctic's only, at 1 layer): relative Frobenius error at most
     2^-4, MoE positions whose routing flipped between the two left out
     and counted; the padded
     vocab columns are -1e30; for the dense three, 16 float32 decode
     steps equal the float32 forward within 2e-4. (d) every SMOKE config
     at float32 on the card equals the CPU within 1e-4 (forward, aux, 8
     decode steps). (e) ``python -m repro_torch.launch.serve_lm --arch
     qwen2-7b --config full --batch 4 --prompt-len 12 --gen-len 20
     --max-len 64`` exits 0. Prefill and per-step times by CUDA events,
     tokens per second and peak device memory for each model; no
     partitioner kernel may launch (the counts, zeroed just before, are
     printed). ``--lm-only`` runs phases 1 and 13 (no contract line).
 14. training (``repro_torch.train``: forward and backward through
     autograd), TF32 off, bf16 products accumulated in float32: (a) GAT
     at its full CONFIG trained with AdamW (lr 3e-3) for 20 steps on
     12a's placed graph, labels the community of each placed id: the
     loss finite and falling, the first step's loss and gradient norm
     equal (1e-5 relative) to the same step on the input graph read
     through ``perm``, printed beside 12a's kernel launches; (b)
     gemma-2b's CONFIG at 2 layers, gradients with remat on and off
     equal (1e-6 of each leaf's largest) and the peak memory lower with
     it, then at full depth, AdamW, remat, B=2 x S=1024, 5 steps on one
     repeated ``lm_batch`` (weights from ``lm_params``, lr 3e-5): the loss
     falls;
     (c) granite-moe-1b at full CONFIG, Adafactor, B=4 x S=512, 5 steps:
     the loss falls and the aux loss's gradient reaches the router; (d)
     one float32 AdamW step of every SMOKE config (the five LMs, GAT,
     SchNet, NequIP, DimeNet, DLRM) and gemma-2b's at microbatches=2 on
     the card against the CPU from the same state, at the CPU tests'
     tolerances; (e) ``python -m repro_torch.launch.train --arch
     gemma-2b --steps 20 --ckpt-dir D --ckpt-every 10``, then
     ``--steps 30`` resuming at step 20, then ``python -m
     repro_torch.launch.gnn_partitioned_training``: all exit 0, the
     example's loss falls. Step times by CUDA events, tokens (nodes) per
     second and peak device memory; no partitioner kernel may launch in
     this process (the counts, zeroed just before, are printed).
     ``--train-only`` runs phases 1, 12a and 14 (no contract line).
 15. the verifier (``repro_torch.analysis``) on the card:
     ``python -m repro_torch.analysis --devices 1`` (the 19 entries
     taped, the host ones on card 0, the ``dist_*`` ones on a one-rank
     NCCL mesh; the collective, overflow, launch-limit and lint passes)
     exits 0 with no finding; its LIM001 holds at every grid point
     against the built libraries (the point count printed); every
     allowlist entry it leaves unused is a kernel's plain version, which
     the card does not run; and each of ``--fixture collective``
     (two ranks: gloo ranks on the CPU where one card is visible),
     ``overflow``, ``lint`` and ``limits`` exits 1. The five processes
     run at once. Printed: the entries traced, the ops taped, the
     collectives logged, the fused entries' kernel launches (counted in
     the verifier's processes, which start at 0) and the phase's
     seconds. ``--analysis-only`` runs phases 1 and 15 (no contract
     line).

The line before the last is the ``{"kernels": [...]}`` record, the last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
port's sources beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ANCHOR_CUT = 819          # rgg2d 4000, k=16, bench config (BENCH_api.json)
FULL_N = 1 << 20
# rgg2d 2^20, k=16, preset fast: the JAX reference's cut on this tree
# (tests/test_torch_e2e.py::test_full_size_on_gpu_matches_reference)
FULL_CUT = 15465
MAIN_LP_MOVE = 120        # lp_move calls of that run (5 levels)
# the same request with refine="unconstrained", and its comparison: the
# JAX reference's answers on the CPU (kernel="composed"), from
# benchmarks/torch_reference_anchors.py. The trace as (phase, level, n, m,
# coarse_n or blocks, W or cut); REPAIR_ROUNDS per refine-mode record
# (stage, level), each with the penalty schedule [0.0, 0.5]
UNCONSTRAINED_CUT = 15308
UNCONSTRAINED_TRACE = (
    ("coarsen", 0, 1048576, 8378246, 136674, 1966),
    ("coarsen", 1, 136674, 553112, 39641, 1966),
    ("coarsen", 2, 39641, 175650, 13227, 1966),
    ("coarsen", 3, 13227, 60980, 5129, 5242),
    ("coarsen", 4, 5129, 21072, 2343, 15728),
    ("initial", None, 2343, 6818, 2, 1050),
    ("uncoarsen", 0, 5129, 21072, 2, 986),
    ("uncoarsen", 1, 13227, 60980, 8, 6454),
    ("uncoarsen", 2, 39641, 175650, 16, 15988),
    ("uncoarsen", 3, 136674, 553112, 16, 15688),
    ("uncoarsen", 4, 1048576, 8378246, 16, 15310),
    ("final", None, 1048576, 8378246, 16, UNCONSTRAINED_CUT),
)
REPAIR_ROUNDS = {("initial", None): 0, ("uncoarsen", 0): 0,
                 ("uncoarsen", 1): 0, ("uncoarsen", 2): 2,
                 ("uncoarsen", 3): 0, ("uncoarsen", 4): 0,
                 ("final", None): 0}
BASELINE_CUTS = {"plain_mgp": 8781, "single_level_lp": 724032}
# the reference CLI: rgg2d 4000 (seed 0), k=16, --compare
CLI_CUTS = {"single": 916, "plain_mgp": 876, "single_level_lp": 2759}
# rgg2d 2000, k=8, C=64: graph seed -> the reference's cut; seed 0 with
# quality="best" gives 186
SESSION_CUTS = {0: 169, 1: 335, 2: 212}
SESSION_BEST_CUT = 186
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM, non-tensor 32-bit rate

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "lp_move": ("src/repro_torch/csrc/lp_move.cu",
                "src/repro/kernels/lp_move/lp_move.py:197"),
    # the same TPU kernel, with the request axis the reference adds by
    # jax.vmap (core/lp.py:258 cluster_iteration_stacked)
    "lp_move_stacked": ("src/repro_torch/csrc/lp_move.cu",
                        "src/repro/kernels/lp_move/lp_move.py:197"),
    "seg_merge": ("src/repro_torch/csrc/seg_merge.cu",
                  "src/repro/kernels/seg_merge/seg_merge.py:117"),
    "bal_scores": ("src/repro_torch/csrc/bal_round.cu",
                   "src/repro/kernels/bal_round/bal_round.py:120"),
    "greedy_pick": ("src/repro_torch/csrc/bal_round.cu",
                    "src/repro/kernels/bal_round/bal_round.py:182"),
    "lp_gain": ("src/repro_torch/csrc/lp_gain.cu",
                "src/repro/kernels/lp_gain/lp_gain.py:70"),
    "bsr_spmm": ("src/repro_torch/csrc/bsr_spmm.cu",
                 "src/repro/kernels/bsr_spmm/bsr_spmm.py:47"),
    "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/embedding_bag.py:35"),
    # the heavy-row paths of lp_move and bal_scores (rows wider than the
    # capped ELL slab), launched inside those kernels' calls
    "lp_move_heavy": ("src/repro_torch/csrc/lp_move.cu",
                      "src/repro/kernels/lp_move/lp_move.py:197"),
    "bal_scores_heavy": ("src/repro_torch/csrc/bal_round.cu",
                         "src/repro/kernels/bal_round/bal_round.py:120"),
    # the distributed engine's forms: lp_move's admission by the labels'
    # budgets (ncw <= nbud - vw, the reference's dist_lp.py:263-292) and
    # bal_scores over a PE's [locals, ghosts, sentinel] label table
    # (dist_balance.py:110-114)
    "lp_move_dist": ("src/repro_torch/csrc/lp_move.cu",
                     "src/repro/kernels/lp_move/lp_move.py:197"),
    "lp_move_heavy_dist": ("src/repro_torch/csrc/lp_move.cu",
                           "src/repro/kernels/lp_move/lp_move.py:197"),
    "bal_scores_dist": ("src/repro_torch/csrc/bal_round.cu",
                        "src/repro/kernels/bal_round/bal_round.py:120"),
    "bal_scores_heavy_dist": ("src/repro_torch/csrc/bal_round.cu",
                              "src/repro/kernels/bal_round/bal_round.py:120"),
}
# phase 9: the hub graphs (seed 17) and their sizes; cut to 2^19 and 2^17
# when phase 10 came, and ba to 2^18 when phase 12 came, to keep the
# whole script near 600 s; both at 2^20 with --hubs-only
HUB_SIZES = {"ba": 1 << 18, "rhg": 1 << 17}
HUB_SIZES_FULL = {"ba": 1 << 20, "rhg": 1 << 20}
MAIN_PATH = ("lp_move", "seg_merge", "bal_scores", "greedy_pick")
# phase 10: the distributed engine's memory models, and the JAX
# reference's answers at P=1 on phase 4's request (CPU, kernel="composed",
# benchmarks/torch_reference_anchors.py --dist): cut, the sha256 of the
# int64 assignment and the trace as (phase, level, n, m, coarse_n or
# blocks, W or cut, payload_bytes or balance_rounds). The reference took
# 51.4 and 53.3 s on the card machine's CPU, beside a run of phase 10
DIST_MODELS = {"default": {},
               "sharded": {"contraction": "sharded", "balance": "dist",
                           "weights": "owner"}}
DIST_ANCHORS = {
    "default": (5917, "e940c3dac7cfa3ed4f3a514af84b5675"
                "2196f02c6b8426dcb0982bc2e81a36db", (
        ("dist-coarsen", 0, 1048576, 8378246, 122695, 1966, None),
        ("dist-coarsen", 1, 122695, 498842, 34314, 1966, None),
        ("dist-coarsen", 2, 34314, 156360, 11890, 1966, None),
        ("dist-coarsen", 3, 11890, 57646, 5766, 6291, None),
        ("dist-coarsen", 4, 5766, 26680, 3816, 15728, None),
        ("initial", None, 3816, 15810, 2, 1616, None),
        ("final", None, 3816, 15810, 16, 6657, None),
        ("dist-uncoarsen", 0, 5766, 26680, 16, 6578, 1),
        ("dist-uncoarsen", 1, 11890, 57646, 16, 6317, 0),
        ("dist-uncoarsen", 2, 34314, 156360, 16, 6164, 0),
        ("dist-uncoarsen", 3, 122695, 498842, 16, 6046, 0),
        ("dist-uncoarsen", 4, 1048576, 8378246, 16, 5917, 0),
    )),
    "sharded": (5917, "e940c3dac7cfa3ed4f3a514af84b5675"
                "2196f02c6b8426dcb0982bc2e81a36db", (
        ("dist-coarsen", 0, 1048576, 8378246, 122695, 1966, 5986104),
        ("dist-coarsen", 1, 122695, 498842, 34314, 1966, 1876320),
        ("dist-coarsen", 2, 34314, 156360, 11890, 1966, 691752),
        ("dist-coarsen", 3, 11890, 57646, 5766, 6291, 320160),
        ("dist-coarsen", 4, 5766, 26680, 3816, 15728, 189720),
        ("initial", None, 3816, 15810, 2, 1616, None),
        ("final", None, 3816, 15810, 16, 6657, None),
        ("dist-uncoarsen", 0, 5766, 26680, 16, 6578, 1),
        ("dist-uncoarsen", 1, 11890, 57646, 16, 6317, 0),
        ("dist-uncoarsen", 2, 34314, 156360, 16, 6164, 0),
        ("dist-uncoarsen", 3, 122695, 498842, 16, 6046, 0),
        ("dist-uncoarsen", 4, 1048576, 8378246, 16, 5917, 0),
    )),
}
DIST_HUB = ("ba", 1 << 18)
# phase 11: the port's selftest size on the card
SELFTEST_N = 2000
DIST_FORMS = ("lp_move_dist", "lp_move_heavy_dist", "seg_merge",
              "bal_scores_dist", "bal_scores_heavy_dist", "greedy_pick")
# (rtol, atol) of a kernel against its plain version; the rest are exact
TOLERANCE = {"bsr_spmm": (1e-5, 1e-5)}
# measured in phase 1: cycles of one dependent shared-memory load, and the
# card's maximum SM clock (MHz); greedy_pick's bound reads them
CARD = {}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------

def phase_environment(torch, build):
    say("== phase 1: environment")
    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    say(f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    secs = build.build_all()
    say(f"kernel build {secs:.2f} s")
    for name in build.SOURCES:
        for line in (build.build_log(name) or "").splitlines():
            if re.search(r"Used \d+ registers|spill", line):
                say(f"  {name}: {line.strip()}")
    measure_step_latency(torch)
    return smi


def sm_clocks():
    """(maximum, current) SM clock of card 0 in MHz, as nvidia-smi reports
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    mx, cur = (float(x) for x in out.split(","))
    return mx, cur


def measure_step_latency(torch):
    """Fill CARD with what greedy_pick's bound needs: the cycles of one
    dependent shared-memory load (a pointer chase on the card, median of
    five) and the card's maximum SM clock."""
    from repro_torch.kernels.bal_round import bal_round

    dev = torch.device("cuda", 0)
    cycles = float(np.median([bal_round.smem_load_cycles(dev)
                              for _ in range(5)]))
    mx, cur = sm_clocks()
    CARD.update(smem_load_cycles=cycles, sm_clock_mhz=mx)
    say(f"shared-memory load-to-use latency {cycles:.2f} cycles (pointer "
        f"chase, median of 5); SM clock max {mx:.0f} MHz (now {cur:.0f})")


# ---------------------------------------------------------------------------
# phase 2: ragged kernel cases
# ---------------------------------------------------------------------------

def _i32(torch, x, dev):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)


def ragged_cases(torch, rng, dev):
    """(kernel, fn, plain, args) edge cases: odd row counts and widths,
    fully padded rows, sentinel lanes, duplicate and I32_MAX keys, record
    counts on both sides of the sort's shared-memory tile."""
    from repro_torch.kernels.bal_round import bal_round, ref as bal_ref
    from repro_torch.kernels.lp_move import lp_move, ref as lp_ref
    from repro_torch.kernels.seg_merge import ref as seg_ref, seg_merge

    cases = []
    for R, D, nl, W, dist in ((1, 1, 3, 2, False), (67, 5, 9, 6, False),
                              (300, 40, 30, 12, False), (129, 33, 20, 9, True),
                              (4099, 24, 500, 20, False)):
        nlab = rng.integers(0, nl, (R, D))
        nlab[rng.random((R, D)) < 0.3] = -1
        nlab = -np.sort(-nlab, axis=1)           # valid lanes first
        nlab[R - R // 5:] = -1                   # fully padded tail rows
        nw = np.where(nlab >= 0, rng.integers(1, 6, (R, D)), 0)
        ncw = np.where(nlab >= 0, rng.integers(0, 2 * W + 2, (R, D)),
                       2**31 - 1)
        own = rng.integers(0, nl, R)
        vw = rng.integers(1, 4, R)
        nbud = rng.integers(0, 2 * W + 2, (R, D)) if dist else None
        args = [_i32(torch, x, dev) for x in (nlab, nw, ncw, own, vw)]
        v0 = int(rng.integers(0, 1000))
        salt = int(rng.integers(0, 2**32))
        extra = dict(nbud=_i32(torch, nbud, dev)) if dist else {}
        cases.append(("lp_move", lp_move.lp_move_chunk,
                      lp_ref.lp_move_chunk_ref,
                      (*args, W, v0, salt, nl), extra))
    for kind, R, dist in (("none", 5000, False), ("none", 5000, True),
                          ("one_target", 4500, False),
                          ("one_target", 4500, True),
                          ("one_target", 70001, False),
                          ("spread", 20000, False), ("spread", 20000, True),
                          ("holes", 3000, False), ("holes", 3000, True)):
        nlab, nw, ncw, nbud, own, vw, W, nl = lp_move_stress(rng, kind, R,
                                                             dist)
        args = [_i32(torch, x, dev) for x in (nlab, nw, ncw, own, vw)]
        extra = dict(nbud=_i32(torch, nbud, dev)) if dist else {}
        cases.append(("lp_move", lp_move.lp_move_chunk,
                      lp_ref.lp_move_chunk_ref,
                      (*args, W, int(rng.integers(0, 1000)),
                       int(rng.integers(0, 2**32)), nl), extra,
                      f"phase B {kind}{' nbud' if dist else ''}"))
    for kind, L, span in seg_merge_cases():
        src, dst, w, max_id = seg_merge_records(rng, kind, L, span)
        cases.append(("seg_merge", seg_merge.seg_merge,
                      seg_ref.seg_merge_ref,
                      tuple(_i32(torch, x, dev) for x in (src, dst, w)),
                      dict(max_id=max_id),
                      f"{kind}, key bits {seg_ref.key_bits(max_id)}"))
    for R, D, K, restricted, what in BAL_RAGGED:
        args, kw = bal_scores_operands(torch, rng, dev, R, D, K, restricted,
                                       what)
        cases.append(("bal_scores", bal_round.bal_scores,
                      bal_ref.bal_scores_ell_ref, args, kw,
                      *([what] if what else [])))
    for M, K, what in ((128, 64, ""), (5, 3, ""), (128, 1024, ""),
                       (128, 8192, ""), (128, 1, "K=1"),
                       (128, 2**20, "K=2^20, beyond any CTA's staging"),
                       (200, 50, "ids out of [0, K)"),
                       (1300, 300, "M over three 512-entry passes")):
        vals = np.sort(rng.normal(size=M).astype(np.float32))[::-1].copy()
        vals[M - M // 4:] = -np.inf
        bw = rng.integers(0, 100, K)
        lm = rng.integers(40, 80, K)
        lo, hi = (-3, K + 3) if what.startswith("ids") else (0, K)
        cw = rng.integers(1, 10, M)
        if K == 1:        # ids beside 0, an overloaded block, weights < 0
            lo, hi, bw = -2, 3, lm + 5
            cw -= 9
        args = (torch.from_numpy(vals).to(dev),
                *(_i32(torch, x, dev) for x in (
                    rng.integers(lo, hi, M), rng.integers(lo, hi, M), cw,
                    bw, lm)))
        cases.append(("greedy_pick", bal_round.greedy_pick,
                      bal_ref.greedy_pick_ref, args, {},
                      *([what] if what else [])))
    return cases + hub_cases(torch, rng, dev) + dist_cases(
        torch, rng, dev) + micro_ragged_cases(torch, rng, dev)


# chunks with heavy rows (more arcs than the slab's D = 32 lanes, the rest
# in overflow): (R, {row: degree}, labels, what); "split" draws few labels,
# so a heavy row holds one label in its slab and its overflow; "no
# target" makes nothing admissible for row 0, which holds no own label
HUB_CASES = ((4096, {7: 30000, **{r: 33 + 9 * r for r in range(9, 209)}},
              3000, "hub rows: one of 30,000 arcs, 200 of 33-1824"),
             (1000, {0: 40, 1: 30000, 5: 700}, 12, "split labels"),
             (600, {0: 5000, 3: 64}, 50, "no target"),
             (300, {2: 30000}, 1, "one label over 30,000 arcs"))


def hub_graph(rng, R, hubs, N):
    """CSR rows of a chunk (light rows of 0-32 arcs, tail rows empty,
    ``hubs`` of their degree) over ids [0, N), and its slab of 32 lanes
    and overflow (``ops.ell_rows``)."""
    from repro_torch.kernels.lp_move import ops as lp_ops

    degs = rng.integers(0, 33, R)
    degs[R - R // 8:] = 0
    for r, d in hubs.items():
        degs[r] = d
    indptr = np.zeros(R + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(degs)
    adj = rng.integers(0, N, int(indptr[-1]))
    w = rng.integers(1, 6, int(indptr[-1]))
    idx = np.full((R, 32), -1, np.int32)
    ew = np.zeros((R, 32), np.int32)
    ov = lp_ops.ell_rows(indptr, adj, w, 0, R, idx, ew)
    check(ov is not None and sorted(ov.rows.tolist()) == sorted(hubs),
          "hub chunk: the heavy rows are not the hubs")
    return idx, ew, ov


def split_held(ov, idx, lab):
    """Whether some heavy row holds one label in its slab and its
    overflow."""
    return any(set(lab[idx[r]].tolist()) &
               set(lab[ov.idx[ov.ptr[h]:ov.ptr[h + 1]]].tolist())
               for h, r in enumerate(ov.rows))


def hub_cases(torch, rng, dev):
    """lp_move and bal_scores on chunks with heavy rows (the kernels'
    heavy-row paths), each against its plain version's split form."""
    from repro_torch.kernels.bal_round import bal_round, ops as bal_ops
    from repro_torch.kernels.bal_round import ref as bal_ref
    from repro_torch.kernels.lp_move import lp_move, ref as lp_ref

    cases = []
    for R, hubs, nl, what in HUB_CASES:
        W = 40
        idx, ew, ov = hub_graph(rng, R, hubs, 4 * R)
        lab = rng.integers(0, nl, 4 * R)
        cw = rng.integers(0, 2 * W, nl)
        own = rng.integers(0, nl, R)
        if what == "no target":
            cw[lab[idx[0]]] = W + 5
            cw[lab[ov.idx[:ov.ptr[1]]]] = W + 5
            own[0] = nl
        if what == "split labels":
            check(split_held(ov, idx, lab), "hub case: no split label")
        valid = idx >= 0
        nlab = np.where(valid, lab[np.maximum(idx, 0)], -1)
        ncw = np.where(valid, cw[np.maximum(nlab, 0)], 2**31 - 1)
        o_lab = lab[ov.idx]
        args = [_i32(torch, x, dev) for x in (nlab, ew, ncw, own,
                                              rng.integers(1, 4, R))]
        over = tuple(_i32(torch, x, dev) for x in (
            ov.rows, ov.ptr, o_lab, ov.w, cw[o_lab]))
        cases.append(("lp_move", lp_move.lp_move_chunk,
                      lp_ref.lp_move_chunk_ref,
                      (*args, W, int(rng.integers(0, 1000)),
                       int(rng.integers(0, 2**32)), nl + 1),
                      dict(overflow=over), what))
    for restricted, (R, hubs, K, what) in zip(
            (False, True, False, True),
            ((4096, {0: 30000, **{r: 40 + 11 * r for r in range(5, 150)}},
              64, "hub rows: one of 30,000 arcs, 145 of 95-1679"),
             (1000, {3: 30000, 8: 100}, 4, "split blocks"),
             (2000, {1: 2000}, 8192, "K=8192"),
             (500, {4: 30000}, 16, "one block over 30,000 arcs"))):
        idx, ew, ov = hub_graph(rng, R, hubs, R)
        n = R - R // 8
        labels = rng.integers(0, K, R)
        labels[rng.random(R) < 0.3] = 0
        if what.startswith("one block"):
            labels[:] = 0
            labels[4] = 1
        if what == "split blocks":
            check(split_held(ov, idx, labels), "hub case: no split block")
        vw = rng.integers(1, 7, R)
        bw = np.bincount(labels[:n], weights=vw[:n], minlength=K)
        lm = (bw.sum() / K * rng.uniform(0.9, 1.3, K)).astype(np.int64)
        par = rng.integers(0, max(1, K // 4), K)
        t = [_i32(torch, x, dev) for x in (idx, ew, labels, vw, bw, lm, par)]
        fb = bal_ops.fallback_table(t[4], t[6], restricted)
        kw = dict(overflow=tuple(_i32(torch, x, dev) for x in ov))
        if restricted:
            kw["parent"] = t[6]
        cases.append(("bal_scores", bal_round.bal_scores,
                      bal_ref.bal_scores_ell_ref,
                      (*t[:6], fb, n, int(rng.integers(0, 2**32))), kw,
                      what))
    return cases


# the distributed engine's bal_scores tables: (local rows, ghost rows,
# hubs, K, what); the ELL has a row for every table entry, lanes into any
# of them, the ghost rows empty
DIST_TABLES = ((3000, 700, {5: 20000, 9: 200}, 16, "hub rows"),
               (1000, 1, {3: 40}, 8, "P=1: one ghost slot"),
               (257, 4000, {0: 33}, 64, "more ghosts than local rows"))


def dist_cases(torch, rng, dev):
    """The distributed engine's kernel forms against their plain
    versions: lp_move's heavy rows admitted by the labels' budgets, and
    bal_scores on a PE's label table."""
    from repro_torch.kernels.bal_round import bal_round, ops as bal_ops
    from repro_torch.kernels.bal_round import ref as bal_ref
    from repro_torch.kernels.lp_move import lp_move, ref as lp_ref

    cases = []
    for R, hubs, nl, what in HUB_CASES:
        W = 40
        idx, ew, ov = hub_graph(rng, R, hubs, 4 * R)
        lab = rng.integers(0, nl, 4 * R)
        cw = rng.integers(0, 2 * W, nl + 1)
        bud = rng.integers(W // 2, 2 * W, nl + 1)
        bud[nl] = -2**30                  # the sentinel label never fits
        own = rng.integers(0, nl, R)
        if what == "no target":
            bud[lab[idx[0]]] = -2**30
            bud[lab[ov.idx[:ov.ptr[1]]]] = -2**30
            own[0] = nl
        valid = idx >= 0
        nlab = np.where(valid, lab[np.maximum(idx, 0)], -1)
        safe = np.maximum(nlab, 0)
        ncw = np.where(valid, cw[safe], 2**31 - 1)
        nbud = np.where(valid, bud[safe], 0)
        o_lab = lab[ov.idx]
        args = [_i32(torch, x, dev) for x in (nlab, ew, ncw, own,
                                              rng.integers(1, 4, R))]
        over = tuple(_i32(torch, x, dev) for x in (
            ov.rows, ov.ptr, o_lab, ov.w, cw[o_lab], bud[o_lab]))
        cases.append(("lp_move", lp_move.lp_move_chunk,
                      lp_ref.lp_move_chunk_ref,
                      (*args, W, int(rng.integers(0, 1000)),
                       int(rng.integers(0, 2**32)), nl + 1),
                      dict(nbud=_i32(torch, nbud, dev), overflow=over),
                      f"nbud, {what}"))
    for n_loc, n_ghost, hubs, K, what in DIST_TABLES:
        rows = n_loc + n_ghost + 1
        idx, ew, ov = hub_graph(rng, n_loc, hubs, rows)
        idx = np.concatenate([idx, np.full((rows - n_loc, 32), -1,
                                           np.int32)])
        ew = np.concatenate([ew, np.zeros((rows - n_loc, 32), np.int32)])
        n_valid = n_loc - n_loc // 8          # the padded local rows last
        tab = rng.integers(0, K, rows)
        tab[rng.random(rows) < 0.3] = 0
        tab[n_valid:n_loc + 1] = K            # padding and the sentinel
        vw = np.zeros(rows, np.int64)
        vw[:n_valid] = rng.integers(1, 7, n_valid)
        bw = np.full(K + 1, 2**31 - 1)
        bw[:K] = np.bincount(tab[:n_valid], weights=vw[:n_valid],
                             minlength=K + 1)[:K]
        lm = np.full(K + 1, 2**31 - 1)
        lm[:K] = bw[:K].sum() / K * rng.uniform(0.9, 1.3, K)
        t = [_i32(torch, x, dev) for x in (idx, ew, tab, vw, bw, lm)]
        fb = bal_ops.fallback_table(t[4], None, False)
        cases.append(("bal_scores", bal_round.bal_scores,
                      bal_ref.bal_scores_ell_ref,
                      (*t, fb, n_valid, int(rng.integers(0, 2**32))),
                      dict(overflow=tuple(_i32(torch, x, dev) for x in ov),
                           dist=True),
                      f"dist table ({n_loc} local rows, {n_ghost} ghost "
                      f"slots): {what}"))
    return cases


# bal_scores' ragged cases: (R, D, K, restricted, what); "holes" puts -1
# lanes anywhere in a row, "empty" gives a third of the rows below n no
# valid lane; D = 100 holds 4 tiles in registers, 160 and 256 walk a row's
# tiles from memory
BAL_RAGGED = ((1, 1, 4, False, ""), (77, 9, 64, False, ""),
              (513, 33, 64, True, "holes"), (2000, 20, 128, False, ""),
              (1000, 70, 32, True, "holes"), (700, 100, 64, False, "holes"),
              (300, 160, 16, False, "hub row, D=160"),
              (300, 256, 16, True, "hub row, D=256"),
              (4000, 24, 8192, True, "K=8192"),
              (3000, 32, 64, False, "empty"))


def bal_scores_operands(torch, rng, dev, R, D, K, restricted, what):
    """(args, kw) of one bal_scores call in the fused round's form: ELL ids
    (valid lanes first, or anywhere for "holes"; rows >= n padded) and
    weights, labels skewed to block 0, vertex weights, block weights
    summed from those labels, budgets that leave block 0 and some others
    overloaded, the parent groups (restricted) and the fallback table the
    fused round composes."""
    from repro_torch.kernels.bal_round import ops as bal_ops

    n = R - R // 4
    idx = rng.integers(0, R, (R, D))
    idx[rng.random((R, D)) < 0.3] = -1
    if what != "holes":
        idx = -np.sort(-idx, axis=1)             # valid lanes first
    if what.startswith("hub"):
        idx[R // 3] = rng.integers(0, R, D)      # every lane valid
    if what == "empty":
        idx[rng.random(R) < 1 / 3] = -1
    idx[n:] = -1
    w = np.where(idx >= 0, rng.integers(1, 6, (R, D)), 0)
    labels = rng.integers(0, K, R)
    labels[rng.random(R) < 0.3] = 0
    vw = rng.integers(1, 7, R)
    bw = np.bincount(labels[:n], weights=vw[:n], minlength=K)
    lm = (bw.sum() / K * rng.uniform(0.9, 1.3, K)).astype(np.int64)
    par = rng.integers(0, max(1, K // 4), K)
    t = [_i32(torch, x, dev) for x in (idx, w, labels, vw, bw, lm, par)]
    fb = bal_ops.fallback_table(t[4], t[6], restricted)
    salt = int(rng.integers(0, 2**32))
    return (*t[:6], fb, n, salt), (dict(parent=t[6]) if restricted else {})


def seg_merge_cases():
    """(kind, L, id span) of phase 2's seg_merge cases: ragged lengths
    (none a power of two but 1), ids at a key-width boundary, I32_MAX in
    one half only, negative ids, one key over several 4096-key tiles,
    all records invalid, run totals that wrap int32, L = 2^22 + 1, and
    full-width ids near 2^31 - 2."""
    return (("random", 1, 3), ("random", 3, 2), ("random", 1000, 40),
            ("random", 5000, 300), ("random", 70001, 2000),
            ("width", 3000, 128), ("one_half", 5000, 300),
            ("negative", 9999, 10000), ("long_run", 20000, 50),
            ("all_invalid", 3333, 1), ("wrap", 6000, 30),
            ("random", 2**22 + 1, 136674), ("full_width", 5000, 40),
            ("full_width_bound", 5000, 40))


def seg_merge_records(rng, kind, L, span):
    """(src, dst, w, max_id) of one seg_merge case; max_id is the bound
    the main path's caller passes (the largest valid id), None where ids
    are negative (full 32-bit key halves)."""
    I = 2**31 - 1
    src = rng.integers(0, span, L)
    dst = rng.integers(0, span, L)
    w = rng.integers(1, 9, L)
    max_id = span - 1
    if kind == "random":
        inv = rng.random(L) < 0.1
        src[inv] = dst[inv] = I
        w[inv] = 0
    elif kind == "width":          # a max id of 2^7 - 1 needs 8 bits
        src[:5] = dst[5:9] = span - 1
        dst[rng.random(L) < 0.1] = I
    elif kind == "one_half":
        src[rng.random(L) < 0.15] = I
        dst[rng.random(L) < 0.15] = I
    elif kind == "negative":
        src -= span // 2
        dst -= span // 2
        src[:7] = I
        max_id = None
    elif kind == "long_run":       # 12,000 copies of one key: 3 tiles
        take = rng.permutation(L)[:12000]
        src[take], dst[take] = 17, 4
    elif kind == "all_invalid":
        src[:] = dst[:] = I
        w[:] = 0
        max_id = 0
    elif kind == "wrap":
        w = rng.integers(2**29, 2**30, L)
    elif kind.startswith("full_width"):
        src = I - 1 - src
        dst = I - 1 - dst
        max_id = I - 1 if kind.endswith("bound") else None
    return src, dst, w, max_id


def lp_move_stress(rng, kind, R, dist):
    """An ``lp_move`` chunk that loads phase B: ``none`` has no candidate
    (W far above every cluster), ``one_target`` makes every row a mover
    to label 0 and so a candidate (one target, R of them), ``spread``
    puts many candidates on many targets among ~2^21 labels (a 52-bit
    key), ``holes`` has -1 lanes anywhere in a row, not only a suffix.
    Returns (nlab, nw, ncw, nbud, own, vw, W, num_labels); ``nbud``
    (the distributed admission form) only if ``dist``."""
    D = {"none": 16, "one_target": 4, "spread": 24, "holes": 40}[kind]
    if kind == "one_target":
        W, nl = 10, R + 1
        nlab = np.full((R, D), -1)
        nlab[:, 0] = 0
        ncw = np.where(nlab >= 0, 1, 2**31 - 1)
        nw = np.where(nlab >= 0, 3, 0)
        own = 1 + np.arange(R)
        vw = np.full(R, 2)
    else:
        W, nl = {"none": (10**6, 40), "spread": (40, 2**21 - 5),
                 "holes": (30, 50)}[kind]
        pool = rng.choice(nl, min(nl, max(2, R // 4)), replace=False)
        nlab = pool[rng.integers(0, pool.size, (R, D))]
        nlab[rng.random((R, D)) < 0.4] = -1      # holes anywhere in a row
        nlab[R - R // 8:] = -1                   # fully padded tail rows
        nw = np.where(nlab >= 0, rng.integers(1, 6, (R, D)), 0)
        lo, hi = (0, 20) if kind == "none" else (W // 2, W - 2)
        ncw = np.where(nlab >= 0, rng.integers(lo, hi, (R, D)), 2**31 - 1)
        own = pool[rng.integers(0, pool.size, R)]
        vw = rng.integers(1, 4, R)
    nbud = ncw + vw[:, None] + rng.integers(0, 2, (R, D)) if dist else None
    if dist:
        nbud = np.minimum(nbud, 2**31 - 1)
    return nlab, nw, ncw, nbud, own, vw, W, nl


def micro_ragged_cases(torch, rng, dev):
    """Edge cases of the three kernels off the main path: ``lp_gain`` with
    -1 lanes mid-row, all-padding rows, +inf target weights, budget ties
    (integer weights make ``tgt_w + vw == budget`` common) and a graph
    row cut at ``max_degree``; ``bsr_spmm`` at F=1 and F=130, one slot a
    row, zero padded blocks and a block size below 128; ``embedding_bag``
    at BAG 1 and 3, repeated indices, D=1 and D=200."""
    from repro_torch.graphs import generators
    from repro_torch.kernels.bsr_spmm import bsr_spmm, ref as bsr_ref
    from repro_torch.kernels.embedding_bag import embedding_bag as eb
    from repro_torch.kernels.embedding_bag import ref as eb_ref
    from repro_torch.kernels.lp_gain import lp_gain, ops as gain_ops
    from repro_torch.kernels.lp_gain import ref as gain_ref

    f32 = (lambda x: torch.from_numpy(
        np.ascontiguousarray(x, dtype=np.float32)).to(dev))
    cases = []
    for N, D, nl, budget, tile in ((1, 1, 3, 4, 1), (67, 5, 9, 6, 1),
                                   (96, 33, 20, 9, 32), (256, 128, 50, 8, 128),
                                   (512, 256, 40, 12, 256)):
        lab = rng.integers(0, nl, (N, D))
        lab[rng.random((N, D)) < 0.25] = -1          # -1 lanes mid-row
        lab[N - N // 6:] = -1                        # all-padding rows
        w = np.where(lab >= 0, rng.integers(1, 5, (N, D)), 0)
        cw = rng.integers(1, budget + 3, nl).astype(np.float32)
        cw[rng.random(nl) < 0.1] = np.inf            # +inf target weights
        tgt_w = np.where(lab >= 0, cw[np.maximum(lab, 0)], np.inf)
        own = rng.integers(0, nl, (N, 1))
        own[N - N // 6:] = -2
        vw = rng.integers(1, 3, (N, 1))
        args = (_i32(torch, lab, dev), f32(w), f32(tgt_w),
                _i32(torch, own, dev), f32(vw), f32([[budget]]))
        cases.append(("lp_gain", functools.partial(lp_gain.lp_gain_ell,
                                                   row_tile=tile),
                      gain_ref.lp_gain_ell_ref, args, {}))
    # the entry point's operands at both lane widths: a hub beyond 512
    # (D = 512 either way), a max degree of 139 (D = 160 against 256) and
    # a max degree near 20 (D = 32 against 128)
    for family, n, seed in (("ba", 20000, 5), ("ba", 1000, 2),
                            ("rgg2d", 5000, 3)):
        g = generators.make(family, n, 8.0, seed=seed)
        labels = rng.integers(0, 8, g.n)
        cw = np.bincount(labels, weights=g.vweights, minlength=8)
        for lanes in (32, 128):
            args = gain_ops.gain_operands(g, labels, cw,
                                          float(cw.max() - 20), 256, dev,
                                          lanes)
            cases.append(("lp_gain", lp_gain.lp_gain_ell,
                          gain_ref.lp_gain_ell_ref, args, {},
                          f"{family} {n} via gain_operands, lanes {lanes}"))
    for rb, nnz, bs, f in BSR_RAGGED:
        col, vals, x = bsr_random(rng, rb, nnz, bs, f)
        cases.append(("bsr_spmm", bsr_spmm.bsr_spmm, bsr_ref.bsr_spmm_ref,
                      (_i32(torch, col, dev), f32(vals), f32(x)),
                      dict(block_rows=rb, nnz_per_row=nnz)))
    for rb, nnz, bs, f, kind in ((4, 3, 128, 128, "scattered"),
                                 (3, 2, 128, 130, "scattered"),
                                 (5, 2, 64, 1, "scattered"),
                                 (4, 2, 128, 128, "zero_weights"),
                                 (3, 3, 99, 36, "zero_weights"),
                                 (3, 2, 128, 64, "beyond_split")):
        col, vals, x = bsr_non_finite(rng, rb, nnz, bs, f, kind)
        cases.append(("bsr_spmm", bsr_spmm.bsr_spmm, bsr_ref.bsr_spmm_ref,
                      (_i32(torch, col, dev), f32(vals), f32(x)),
                      dict(block_rows=rb, nnz_per_row=nnz),
                      f"non-finite: {kind}"))
    for B, bag, V, D in ((32, 1, 500, 64), (33, 3, 100, 200), (5, 3, 10, 1),
                         (9, 3, 4, 64), (1, 1, 1, 4), (1001, 1, 5000, 64),
                         (4099, 4, 5000, 64), (333, 17, 2000, 64),
                         (50, 2, 100, 8), (77, 3, 300, 132)):
        idx = rng.integers(0, V, (B, bag))
        idx[0] = idx[0, 0]                           # repeated indices
        table = rng.standard_normal((V, D))
        cases.append(("embedding_bag", eb.embedding_bag_1row,
                      eb_ref.embedding_bag_ref,
                      (_i32(torch, idx, dev), f32(table)), {}))
    return cases


# bsr_spmm's ragged shapes (block rows, slots a row, block size, F): F = 1
# and 130, one slot a row, a block size below 128
BSR_RAGGED = ((3, 2, 128, 1), (4, 3, 128, 130), (5, 1, 128, 64),
              (3, 2, 64, 96))


def bsr_random(rng, rb, nnz, bs, f):
    """(col, vals, x) of a bsr_spmm case: blocks 5% dense with values in
    [0, 1), about half the last slots of the rows padded (column block 0,
    all zero), X standard normal."""
    col = rng.integers(0, rb, rb * nnz)
    vals = rng.random((rb * nnz, bs, bs)) * \
        (rng.random((rb * nnz, bs, bs)) < 0.05)
    pad = (np.arange(rb * nnz) % nnz == nnz - 1) & (rng.random(rb * nnz)
                                                     < 0.5)
    col[pad] = 0                                     # zero padded blocks
    vals[pad] = 0.0
    x = rng.standard_normal((rb * bs, f))
    return col, vals, x


def bsr_non_finite(rng, rb, nnz, bs, f, kind):
    """(col, vals, x) of a bsr_spmm case whose values the kernel's TF32
    split cannot take. ``scattered``: +inf, -inf and NaN among the rows of
    X, one +inf in column block 0, which the padded all-zero slots
    multiply (0 x inf: NaN in the plain version). ``zero_weights``: a row
    of X all +inf that every block on its column block multiplies by
    zeros only, so it reaches Y as NaN and nowhere as inf. ``beyond_split``:
    finite values beyond 2^60 in X and A, and +inf in A."""
    col = rng.integers(0, rb, rb * nnz)
    vals = rng.random((rb * nnz, bs, bs)) * \
        (rng.random((rb * nnz, bs, bs)) < 0.05)
    pad = np.arange(rb * nnz) % nnz == nnz - 1
    col[pad] = 0
    vals[pad] = 0.0
    x = rng.standard_normal((rb * bs, f))
    if kind == "scattered":
        for v in (np.inf, -np.inf, np.nan):
            x[rng.integers(0, rb * bs, 2), rng.integers(0, f, 2)] = v
        x[rng.integers(0, bs), rng.integers(0, f)] = np.inf
    elif kind == "zero_weights":
        c, k = rb - 1, int(rng.integers(0, bs))
        col[0] = c
        x[c * bs + k] = np.inf
        vals[col == c, :, k] = 0.0
    else:
        x[rng.integers(0, rb * bs, 3), rng.integers(0, f, 3)] = 2.0**61
        x[rng.integers(0, rb * bs), rng.integers(0, f)] = -1e36
        vals[0, rng.integers(0, bs, 4), rng.integers(0, bs, 4)] = 3.0**40
        vals[1, rng.integers(0, bs), rng.integers(0, bs)] = np.inf
    return col, vals, x


def compare(name, got, want):
    """(max abs err, max rel err, share) of the kernel's outputs against
    the plain version's (0.0 iff bit-identical; equal infinities count as
    equal, a NaN on one side only as inf; the relative error is taken
    where the plain value is not 0; share: the largest error over its
    allowance atol + rtol |plain|, None where the kernel has no
    TOLERANCE); fails unless they are within the kernel's TOLERANCE, or
    equal where it has none."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    rtol, atol = TOLERANCE.get(name, (0.0, 0.0))
    err = rel = 0.0
    share = 0.0 if rtol or atol else None
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{name}: output shape/dtype {tuple(a.shape)}/{a.dtype} vs "
              f"{tuple(b.shape)}/{b.dtype}")
        diff = a != b
        if a.is_floating_point():
            diff &= ~(a.isnan() & b.isnan())
        if not bool(diff.any()):
            continue
        da, db = a[diff].double(), b[diff].double()
        inf = float("inf")
        d = (da - db).abs().nan_to_num(nan=inf, posinf=inf)
        err = max(err, float(d.max()))
        nz = db != 0
        if bool(nz.any()):
            rel = max(rel, float((d[nz] / db[nz].abs())
                                 .nan_to_num(nan=inf, posinf=inf).max()))
        allow = atol + rtol * db.abs()
        check(bool((d <= allow).all()),
              f"{name}: kernel != plain beyond rtol {rtol} / atol {atol}, "
              f"max abs err {err}")
        if share is not None:
            share = max(share, float((d / allow).max()))
    return err, rel, share


def share_text(share) -> str:
    return "" if share is None else f", {share:.4f} of its allowance"


def bsr_spmm_seeds(torch, dev, seeds=range(1, 9)):
    """bsr_spmm's finite ragged shapes on more seeds: the largest error
    over its allowance (1e-5 + 1e-5 |plain|) of each shape across them."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm, ref as bsr_ref

    for rb, nnz, bs, f in BSR_RAGGED:
        worst = (0.0, 0.0)
        for seed in seeds:
            col, vals, x = bsr_random(np.random.default_rng(seed), rb, nnz,
                                      bs, f)
            args = [torch.from_numpy(np.ascontiguousarray(a, dtype=t)).to(dev)
                    for a, t in ((col, np.int32), (vals, np.float32),
                                 (x, np.float32))]
            kw = dict(block_rows=rb, nnz_per_row=nnz)
            got = bsr_spmm.bsr_spmm(*args, **kw)
            torch.cuda.synchronize()
            err, _, share = compare("bsr_spmm", got,
                                    bsr_ref.bsr_spmm_ref(*args, **kw))
            worst = max(worst, (share, err))
        say(f"  bsr_spmm {(rb * nnz, bs, bs)} F={f} on seeds "
            f"{seeds.start}..{seeds.stop - 1}: {tolerance_text('bsr_spmm')} "
            f"(worst {worst[0]:.4f} of its allowance, max abs err "
            f"{worst[1]})")


def tolerance_text(name) -> str:
    rtol, atol = TOLERANCE.get(name, (0.0, 0.0))
    return f"within rtol {rtol} / atol {atol}" if rtol or atol else "exact"


def phase_ragged(torch, dev):
    say("== phase 2: ragged kernel cases against the plain versions "
        "(tolerance 0; bsr_spmm rtol 1e-5 / atol 1e-5)")
    rng = np.random.default_rng(20260)
    for name, fn, plain, args, kw, *what in ragged_cases(torch, rng, dev):
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        want = plain(*args, **kw)
        err, _, share = compare(name, got, want)
        shape = tuple(args[0].shape)
        timed = ""
        if what and name == "lp_move":   # phase-B chunks: candidates, time
            ms = cuda_ms(torch, lambda: fn(*args, **kw), 5)
            timed = (f"; {int(candidate_count(args, kw))} candidates, "
                     f"kernel {ms:.4f} ms")
        say(f"  {name} {shape}{''.join(' ' + w for w in what)}: "
            f"{tolerance_text(name)} (max abs err {err}"
            f"{share_text(share)}){timed}")
    bsr_spmm_seeds(torch, dev)


def candidate_count(args, kw):
    """The phase-B candidates of one ``lp_move`` call (rows that move to a
    target that would end above W), by the plain version's phase A and
    candidate rule on the call's inputs: a 0-d device tensor."""
    from repro_torch.kernels.lp_move import ref

    nlab, nw, ncw, own, vw, W, _, salt, num_labels = args
    mv, tgt, light = ref.move_targets_ref(nlab, nw, ncw, own, vw, W, salt,
                                          kw.get("nbud"), kw.get("overflow"))
    return ref.candidates_ref(mv, tgt, own, vw, light, W,
                              num_labels)[0].sum()


# ---------------------------------------------------------------------------
# phases 3-4: the anchor and the main path
# ---------------------------------------------------------------------------

def run_partition(api, spec, k, kernel, *, config=None, preset="fast",
                  refine=None):
    req = api.PartitionRequest(graph=spec, k=k, epsilon=0.03,
                               preset=preset, config=config, kernel=kernel,
                               refine=refine)
    return api.Partitioner(backend="single").run(req)


def phase_anchor(torch, api, deep_mgp):
    say("== phase 3: anchor rgg2d 4000, k=16, bench config")
    cfg = deep_mgp.PartitionerConfig(contraction_limit=256,
                                     ip_repetitions=2, num_chunks=4)
    spec = api.GraphSpec("rgg2d", 4000, 8.0, seed=17)
    cuts = {}
    for kernel in ("fused", "composed"):
        t0 = time.perf_counter()
        res = run_partition(api, spec, 16, kernel, config=cfg)
        torch.cuda.synchronize()
        cut = int(res.metrics["cut"])
        say(f"  {kernel}: cut {cut} feasible {res.feasible} "
            f"{time.perf_counter() - t0:.3f} s")
        check(res.feasible and cut == ANCHOR_CUT,
              f"anchor ({kernel}): cut {cut}, feasible {res.feasible}; "
              f"expected {ANCHOR_CUT}, feasible")
        cuts[kernel] = res.assignment
    check(np.array_equal(cuts["fused"], cuts["composed"]),
          "anchor: fused and composed assignments differ")


class Capture:
    """Wraps the kernel wrappers the core calls and keeps a copy of the
    largest input each one was given (the main path's shapes)."""

    def __init__(self, torch):
        self.torch = torch
        self.inputs = {}
        self._undo = []

    def wrap(self, module, attr, name, after=None, size=None):
        """Wrap ``module.attr``; ``after(args, kw)``, if given, runs after
        each call. ``size(args, kw)`` ranks the calls (default: the first
        argument's elements); a call it gives None is not kept."""
        fn = getattr(module, attr)
        # the kept call is of the unwrapped function (an attribute may be
        # wrapped twice), so that timing it copies nothing
        root = getattr(fn, "__wrapped__", fn)

        def wrapped(*args, **kw):
            n = args[0].numel() if size is None else size(args, kw)
            if n is not None and n >= self.inputs.get(name, (-1,))[0]:
                cl = (lambda x: x.clone() if isinstance(
                    x, self.torch.Tensor) else x)
                self.inputs[name] = (n, root, [cl(a) for a in args],
                                     {k: cl(v) for k, v in kw.items()})
            out = fn(*args, **kw)
            if after is not None:
                after(args, kw)
            return out

        wrapped.__wrapped__ = root
        setattr(module, attr, wrapped)
        self._undo.append((module, attr, fn))

    def restore(self):
        # the last wrap first: an attribute wrapped twice gets its own back
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo = []


class HostTimers:
    """Wall seconds of the main path's host functions, summed per trace
    phase. It wraps the module attributes the core calls them through
    (the modules are not edited) and ``deep_mgp.trace_event``, whose call
    closes a phase: permute (coarsening's and refinement's),
    degree_bucket_order, build_move_chunks, lp.build_chunks, contract
    (np.unique, dedup_arcs and from_coo inside it) and dedup_arcs."""

    def __init__(self):
        self.current = {}
        self.phases = []
        self._undo = []

    def wrap(self, module, attr, label):
        fn = getattr(module, attr)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.current[label] = self.current.get(label, 0.0) + \
                    time.perf_counter() - t0

        setattr(module, attr, timed)
        self._undo.append((module, attr, fn))

    def install(self):
        from repro_torch.core import (coarsening, contraction, deep_mgp, lp,
                                      refinement)
        from repro_torch.kernels.lp_move import ops as move_ops

        for module in (coarsening, refinement):
            self.wrap(module, "permute", "permute")
            self.wrap(module, "degree_bucket_order", "degree_bucket_order")
        self.wrap(move_ops, "build_move_chunks", "build_move_chunks")
        self.wrap(lp, "build_chunks", "lp.build_chunks")
        self.wrap(deep_mgp, "contract", "contract")
        self.wrap(contraction, "dedup_arcs", "dedup_arcs")
        trace_event = deep_mgp.trace_event

        def closing(trace, **record):
            trace_event(trace, **record)
            if "time_s" not in record:      # a refine-mode record
                return
            self.phases.append((record.get("phase"), record.get("level"),
                                record.get("n"), record.get("time_s"),
                                self.current))
            self.current = {}

        deep_mgp.trace_event = closing
        self._undo.append((deep_mgp, "trace_event", trace_event))

    def restore(self):
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo = []

    def report(self):
        for phase, level, n, secs, spent in self.phases:
            where = phase + ("" if level is None else f" level {level}")
            parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(spent.items()))
            say(f"  host s, {where} (n={n}, time_s {secs}): {parts or '-'}; "
                f"sum {sum(spent.values()) - spent.get('dedup_arcs', 0.0):.4f}"
                " (dedup_arcs counted inside contract)")


def phase_main_path(torch, api, build, candidates, seg_calls):
    say(f"== phase 4: main path rgg2d {FULL_N}, k=16, preset fast, fused")
    spec = api.GraphSpec("rgg2d", FULL_N, 8.0, seed=17)
    t0 = time.perf_counter()
    g = spec.materialize()
    say(f"  graph n={g.n} m={g.m} max_deg={int(g.degrees().max())} "
        f"({time.perf_counter() - t0:.2f} s, set-up)")
    torch.cuda.reset_peak_memory_stats()
    timers = HostTimers()
    timers.install()
    try:
        build.reset_launches()
        t0 = time.perf_counter()
        res = run_partition(api, g, 16, "fused")
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)  # the main path's run and no other
        wall = time.perf_counter() - t0
    finally:
        timers.restore()
    cut = int(res.metrics["cut"])
    say(f"  cut {cut} feasible {res.feasible} imbalance "
        f"{res.metrics.get('imbalance')} wall {wall:.3f} s peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for rec in res.trace:
        say("  trace " + json.dumps(rec, sort_keys=True))
    say(f"  launches {json.dumps(launches, sort_keys=True)}")
    counts = [int(c) for c in candidates]
    say(f"  lp_move phase-B candidates per call ({len(counts)} calls, the "
        f"plain version's rule on each call's inputs): max {max(counts)}, "
        f"more than one 1024-key tile in {sum(c > 1024 for c in counts)}; "
        f"{counts}")
    check(len(counts) == launches["lp_move"],
          "main path: a candidate count for every lp_move call")
    say(f"  seg_merge calls ({len(seg_calls)}): (records L, key bits per "
        f"half, radix passes) {seg_calls}")
    check(len(seg_calls) == launches["seg_merge"],
          "main path: an L and key width for every seg_merge call")
    timers.report()
    check(res.feasible and cut == FULL_CUT,
          f"main path: cut {cut}, feasible {res.feasible}; expected "
          f"{FULL_CUT}, feasible")
    for name in MAIN_PATH:
        check(launches[name] > 0, f"main path: {name} was never launched")
    check(launches["lp_move"] == MAIN_LP_MOVE
          and launches["lp_move_heavy"] == launches["bal_scores_heavy"] == 0,
          f"main path: {launches['lp_move']} lp_move launches and "
          f"{launches['lp_move_heavy']} / {launches['bal_scores_heavy']} "
          f"heavy-row launches; expected {MAIN_LP_MOVE} and none (rgg2d's "
          "degrees fit the slab)")
    return g, launches, res, wall


def skewed_rebalance(g, assignment, dev) -> dict:
    """Rebalance the finest level after moving 2000 vertices of block 1
    into block 0 (an overload a few pool rounds repair); returns the
    balancer's stats (rounds, time_s: its wall, host ELL build included)."""
    from repro_torch.core import balance, metrics

    part = np.asarray(assignment).copy()
    part[np.flatnonzero(part == 1)[:2000]] = 0
    l_final = metrics.l_max(g.total_vweight, 16, 0.03,
                            int(g.vweights.max()))
    stats = {}
    out = balance.rebalance(g, part, np.full(16, l_final, dtype=np.int64),
                            kernel="fused", device=dev, stats=stats)
    check(metrics.is_feasible(g, out, 16, 0.03),
          "the balancer left the skewed partition infeasible")
    return stats


def finest_balancer(torch, build, g, assignment, dev):
    """The finest-level balancer (``skewed_rebalance``), run twice: as it
    is, for its rounds, launches, wall and peak device memory; then with
    the inputs of its last round's stages captured (``fused_round_scores``,
    ``bal_scores``, ``greedy_pick``; capturing clones them, so that run is
    not measured). Prints the first; returns (stats, capture)."""
    from repro_torch.kernels.bal_round import ops as bal_ops

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    st = skewed_rebalance(g, assignment, dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stats = dict(rounds=st["rounds"], wall_s=st["time_s"],
                 launches=dict(build.LAUNCHES), peak_bytes=peak,
                 peak_above_bytes=peak - before)
    say(f"  finest-level balancer on a skewed partition: {st['rounds']} "
        f"rounds, wall {st['time_s']:.4f} s, peak device memory {peak} "
        f"bytes ({peak - before} above the {before} held before), launches "
        f"{json.dumps(stats['launches'], sort_keys=True)} (not the main "
        "path's)")
    cap = Capture(torch)
    for name in ("fused_round_scores", "bal_scores", "greedy_pick"):
        cap.wrap(bal_ops, name, name)
    try:
        skewed_rebalance(g, assignment, dev)
    finally:
        cap.restore()
    return stats, cap


def round_stages(torch, cap):
    """Device ms of the stages of the finest level's last round, on its
    captured inputs (CUDA events behind a sleep kernel): the score stage
    (``fused_round_scores``: the fallback table, ``bal_scores`` and any
    gathers around it), the pool (the stable descending sort of ``rel``
    and the pool's four gathers, as ``balance_round_fused`` does them) and
    ``greedy_pick``. The labels update and the overload check's read-back
    are not timed."""
    _, score_fn, sargs, skw = cap.inputs["fused_round_scores"]
    _, pick_fn, pargs, pkw = cap.inputs["greedy_pick"]
    rel, tgt = score_fn(*sargs, **skw)
    labels, vw, top_m = sargs[0], sargs[6], pargs[0].numel()

    def pool():
        vidx = torch.sort(rel, descending=True, stable=True).indices[:top_m]
        return rel[vidx], tgt[vidx], labels[vidx], vw[vidx]

    out = dict(score_ms=device_ms(torch, [lambda: score_fn(*sargs, **skw)],
                                  10),
               pool_ms=device_ms(torch, [pool], 10),
               pick_ms=device_ms(torch, [lambda: pick_fn(*pargs, **pkw)],
                                 50))
    say(f"  finest-level round, device ms (CUDA events behind a sleep "
        f"kernel) at R={labels.numel()}, M={top_m}: score stage "
        f"{out['score_ms']:.4f}, pool sort {out['pool_ms']:.4f}, greedy_pick "
        f"{out['pick_ms']:.4f}; sum {sum(out.values()):.4f}")
    return out


def kernel_device(torch, name, fn, args, kw, where, expect=1):
    """One call's device launches (graph nodes; fails unless ``expect``,
    if given), device ms per call (CUDA events behind a sleep kernel) and
    the no-stream-wait check."""
    call = lambda: fn(*args, **kw)          # noqa: E731
    n = say_launches(torch, name, call, where)
    check(expect is None or n == expect,
          f"{name}: {n} device launches per call {where}; expected {expect}")
    ms = device_ms(torch, [call], 50 if name == "greedy_pick" else 20)
    say(f"  {name}: device time per call {ms:.4f} ms {where} (CUDA events "
        "behind a sleep kernel)")
    no_stream_wait(torch, name, call)
    return dict(device_launches=n, device_ms=ms)


# ---------------------------------------------------------------------------
# phase 5: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(kind: str, args, kw, out):
    """(bound_ms, bound_by): the larger of bytes moved (each input read
    once, each output written once) over HBM bandwidth and the
    operations these inputs need over the card's 32-bit rate.

    The ELL kernels (lp_move, bal_scores, lp_gain) need only the valid
    lanes of their (R, D) slabs: a slab counts sum(deg) lanes, not R * D
    (bal_scores: the valid lanes of ell_idx and ell_w, then its label
    table, per-row columns and K-entry block tables once, and its
    outputs). bsr_spmm needs 2 F operations per nonzero entry of its
    blocks (the zeros inside and the all-zero padded blocks need none,
    though they are read); embedding_bag reads each distinct table row
    once.

    greedy_pick is bound by the latency of its M steps, not by bytes or
    throughput: each step's test reads the weights of two blocks that
    the step before may have written, so the M steps form one chain of
    dependent loads, and the least time a load of the chain can take is
    one shared-memory load-to-use latency (CARD, measured in phase 1 by a
    pointer chase) at the card's maximum SM clock. Its "operations" time
    is M x that latency."""
    moved, ops = bound_parts(kind, args, kw, out)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    if kind == "greedy_pick":
        t_ops = args[0].numel() * CARD["smem_load_cycles"] / (
            CARD["sm_clock_mhz"] * 1e6) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_parts(kind: str, args, kw, out):
    """(bytes moved, operations) of one call, as ``bound`` counts them. A
    stacked lp_move call counts each request's solo call: its valid
    lanes, columns, outputs and operations, summed. The distributed
    forms count as their kernels do."""
    kind = kind.replace("_dist", "")
    if kind == "lp_move_stacked":
        S = args[0].shape[0]
        pick = (lambda x, s: x[s] if hasattr(x, "shape") else x)
        parts = [bound_parts("lp_move", [pick(a, s) for a in args],
                             {k: pick(v, s) for k, v in kw.items()
                              if v is not None},
                             tuple(o[s] for o in out)) for s in range(S)]
        return sum(m for m, _ in parts), sum(o for _, o in parts)
    if kind.endswith("_heavy"):
        # the light call's count on the slab, plus each overflow arc read
        # once and ~16 operations a lane of a heavy row (table insert,
        # admission, the tie chain)
        over = kw["overflow"]
        moved, ops = bound_parts(kind[:-len("_heavy")], args,
                                 {k: v for k, v in kw.items()
                                  if k != "overflow"}, out)
        lanes = over[0].numel() * args[0].shape[1] + over[2].numel()
        return moved + nbytes(*over), ops + 16.0 * lanes
    tensors = [a for a in args if hasattr(a, "numel")]
    tensors += [v for v in kw.values() if hasattr(v, "numel")]
    outs = out if isinstance(out, tuple) else (out,)
    if kind in ("lp_move", "bal_scores", "lp_gain"):
        deg = (args[0] >= 0).sum(1).double()
        lanes = int(deg.sum())
        R, D = args[0].shape
        slabs = [t for t in tensors if tuple(t.shape) == (R, D)]
        cols = [t for t in tensors if tuple(t.shape) != (R, D)]
        moved = lanes * sum(t.element_size() for t in slabs) \
            + nbytes(*cols) + nbytes(*outs)
        # label-equality connectivity: deg^2 compare-adds per row,
        # plus ~16 ops per lane for admission and the tie chain
        ops = float((2 * deg * deg + 16 * deg).sum())
    elif kind == "seg_merge":
        moved = nbytes(*tensors) + nbytes(*outs)
        # a comparison sort needs L log2 L compares; flags and run
        # totals a few more per record
        L = args[0].numel()
        ops = float(L * max(1, (L - 1).bit_length()) + 4 * L)
    elif kind == "bsr_spmm":
        moved = nbytes(*tensors) + nbytes(*outs)
        ops = 2.0 * int((args[1] != 0).sum()) * args[2].shape[1]
    elif kind == "embedding_bag":
        idx, table = args
        rows = int(idx.unique().numel())
        moved = nbytes(idx) + rows * table.shape[1] * table.element_size() \
            + nbytes(*outs)
        ops = float(idx.numel() * table.shape[1])
    else:                                          # greedy_pick
        moved = nbytes(*tensors) + nbytes(*outs)
        ops = 0.0
    return moved, ops


def graph_launches(torch, call):
    """(launches, {kind: count}) of one call, counted exactly: the nodes
    of a CUDA graph captured around it (kernels, memsets, copies). The
    count needs no profiler, and a call that waited for the stream could
    not be captured."""
    import ctypes

    call()                          # builds, allocations, lazy set-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        call()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(1, n.value))()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    kinds = {}
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        kind = {0: "kernel", 1: "memcpy", 2: "memset"}.get(t.value,
                                                          f"type {t.value}")
        kinds[kind] = kinds.get(kind, 0) + 1
    del graph
    torch.cuda.synchronize()
    return n.value, kinds


def device_ms(torch, calls, rounds):
    """Device milliseconds per call of ``calls``, taken in turn ``rounds``
    times: CUDA events around them, queued behind a sleep kernel that
    outlasts the host's launching, so that no host time is counted."""
    for call in calls:
        call()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(50_000_000)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(rounds):
        for call in calls:
            call()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    check(host_ms < ev[0].elapsed_time(ev[1]),
          f"the host took {host_ms:.1f} ms to launch, longer than the "
          "sleep that hides it")
    return ev[1].elapsed_time(ev[2]) / (rounds * len(calls))


def profiled(torch, call):
    """{kernel or memset name: device ms} of one call, as a torch.profiler
    window around it records them (after a warm-up call), or None if the
    window recorded no device activity. On the H100 machine (torch 2.11,
    CUDA 12.8) windows lose every device record now and then: the same
    sequence of calls recorded in one process and not in the next, and
    no window after torch.sparse's Triton BSR product (phase 6's library
    call) has recorded in any run, whatever TEARDOWN_CUPTI says. So the
    launch counts come from graph_launches and the device times from
    device_ms; the profiler adds only the per-kernel breakdown."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(
                e.time_range.elapsed_us() / 1e3)
    return by_name or None


def say_launches(torch, name, call, where):
    """Print one call's device launches (graph nodes by kind) and its
    profiler breakdown; fail if the profiler, when it recorded, saw
    another count. Returns the count."""
    n, kinds = graph_launches(torch, call)
    say(f"  {name}: {n} device launches per call {where} "
        f"({', '.join(f'{c} {k}' for k, c in sorted(kinds.items()))})")
    check(n > 0, f"{name}: the captured graph holds no device launch")
    by_name = profiled(torch, call)
    if by_name is None:
        say("    the profiler window recorded no device activity")
        return n
    seen = sum(len(v) for v in by_name.values())
    check(seen == n, f"{name}: the profiler saw {seen} device launches, "
          f"the captured graph {n}")
    for kname, ms in sorted(by_name.items(), key=lambda kv: -sum(kv[1])):
        say(f"    {len(ms)} x {kname[:72]}: {sum(ms):.4f} ms on the device")
    return n


def no_stream_wait(torch, name, call):
    """Fail if ``call`` waits for the stream: it runs once under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    except RuntimeError as exc:
        raise SmokeFailure(f"{name}: the call waited for the stream: "
                           f"{exc}") from exc
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say(f"  {name}: no stream wait under set_sync_debug_mode('error')")


def lp_move_launches(torch, fn, args, kw):
    """Device launches of one lp_move call at the main path's chunk and at
    its first 67 rows (same num_labels): fail unless they are equal and
    at most 12, or if a call waits for the stream. Prints the call's
    device time."""
    rows = 67
    small = [a[:rows] if hasattr(a, "shape") else a for a in args]
    skw = {k: v[:rows] for k, v in kw.items() if v is not None}
    big = lambda: fn(*args, **kw)           # noqa: E731
    little = lambda: fn(*small, **skw)      # noqa: E731
    big_n = say_launches(torch, "lp_move", big,
                         f"at {args[0].shape[0]} rows")
    small_n = say_launches(torch, "lp_move", little,
                           f"at {rows} rows (num_labels {args[8]})")
    check(big_n == small_n <= 12,
          f"lp_move: {big_n} and {small_n} device launches per call; "
          "expected the same number, at most 12")
    say(f"  lp_move: device time per call {device_ms(torch, [big], 20):.4f} "
        "ms (CUDA events behind a sleep kernel)")
    no_stream_wait(torch, "lp_move", big)
    no_stream_wait(torch, "lp_move", little)


def synthetic_seg_merge(torch, g, dev):
    """The fine graph's 8,378,246 arcs merged in vertex pairs (``v //
    2``), unpadded, so runs of duplicates and self loops both occur. Its
    ids reach 2^19 - 1, so the key's halves are 20 bits wide."""
    src = (g.arc_tails() // 2).astype(np.int32)
    dst = (g.adjncy // 2).astype(np.int32)
    max_id = int(max(src.max(), dst.max()))
    return ([torch.from_numpy(x).to(dev) for x in
             (src, dst, g.eweights.astype(np.int32))], dict(max_id=max_id))


def seg_merge_launches_and_times(torch, fn, plain, args, kw, row):
    """seg_merge beyond its wrapper time, on the main path's largest call:
    device launches per call (graph nodes) at that L and at its first 5
    records with the same key width (must be equal, at most 12); no
    stream wait at either; device time behind a sleep kernel, L2-warm
    (one input again) and L2-cold (four input copies in turn, 4 x 12 B x
    L: 105 MB at level 0, beyond the 50 MB L2), for the kernel and the
    plain version alike; and, as a yardstick, one stable torch.sort of
    the same packed int64 keys with a gather of their int32 values ("sort
    only": no run flags, no totals). Adds them to the record row."""
    from repro_torch.kernels.seg_merge.ref import key_bits, key_halves

    L = args[0].numel()
    bits = key_bits(kw.get("max_id"))
    small = [a[:5] for a in args]
    big = lambda: fn(*args, **kw)           # noqa: E731
    little = lambda: fn(*small, **kw)       # noqa: E731
    big_n = say_launches(torch, "seg_merge", big, f"at L={L}")
    small_n = say_launches(torch, "seg_merge", little,
                           f"at L=5 (the same {bits}-bit key halves)")
    check(big_n == small_n <= 12,
          f"seg_merge: {big_n} and {small_n} device launches per call; "
          "expected the same number, at most 12")
    no_stream_wait(torch, "seg_merge", big)
    no_stream_wait(torch, "seg_merge", little)
    copies = [args] + [[a.clone() for a in args] for _ in range(3)]
    warm = device_ms(torch, [big], 20)
    cold = device_ms(torch, [functools.partial(fn, *c, **kw)
                             for c in copies], 5)
    plain_warm = device_ms(torch, [lambda: plain(*args, **kw)], 3)
    plain_cold = device_ms(torch, [functools.partial(plain, *c, **kw)
                                   for c in copies], 1)
    say(f"  seg_merge: device time per call (CUDA events behind a sleep "
        f"kernel) L2-warm {warm:.4f} ms, L2-cold {cold:.4f} ms; plain "
        f"version {plain_warm:.4f} / {plain_cold:.4f} ms; bound "
        f"{row['bound_ms']:.4f} ms")
    row.update(device_launches=big_n, device_ms=warm, device_ms_l2_cold=cold,
               plain_device_ms=plain_warm, plain_device_ms_l2_cold=plain_cold)
    if bits < 32:
        hi, lo = key_halves(args[0], args[1], bits)
        key = (hi << bits) | lo
        sort_ms = cuda_ms(torch, lambda: args[2][torch.sort(
            key, stable=True).indices], 20)
        say(f"  seg_merge yardstick, sort only: torch.sort(stable) of the "
            f"{2 * bits}-bit packed int64 keys + gather of the int32 values "
            f"{sort_ms:.4f} ms (not the whole function: no flags, no run "
            "totals)")
        row["sort_only_ms"] = sort_ms
    del copies


def phase_kernels(torch, build, capture, launches, g, assignment, dev):
    say("== phase 5: kernels against their plain versions at main-path "
        "shapes (tolerance 0: every output, rel included, bit-identical)")
    from repro_torch.kernels.bal_round import ref as bal_ref
    from repro_torch.kernels.lp_move import ref as lp_ref
    from repro_torch.kernels.seg_merge import ref as seg_ref
    from repro_torch.kernels.seg_merge import seg_merge as seg_mod

    plain = {"lp_move": lp_ref.lp_move_chunk_ref,
             "seg_merge": seg_ref.seg_merge_ref,
             "bal_scores": bal_ref.bal_scores_ell_ref,
             "greedy_pick": bal_ref.greedy_pick_ref}
    runs = [(name, *capture.inputs[name][1:]) for name in MAIN_PATH]
    # beyond the main path's own inputs (printed, not in the record):
    # seg_merge at the 2^20 graph's 8,378,246 arcs, the balancer at the
    # finest level
    sa, skw = synthetic_seg_merge(torch, g, dev)
    runs.append(("seg_merge", seg_mod.seg_merge, sa, skw))
    stats, finest = finest_balancer(torch, build, g, assignment, dev)
    runs += [(name, *finest.inputs[name][1:])
             for name in ("bal_scores", "greedy_pick")]
    rows = {}
    for name, fn, args, kw in runs:
        reps = 20 if name != "greedy_pick" else 200
        row = held_and_timed(torch, name, fn, plain[name], args, kw, reps,
                             launches[name])
        if name == "lp_move":
            lp_move_launches(torch, fn, args, kw)
        if name == "seg_merge" and name not in rows:
            seg_merge_launches_and_times(torch, fn, plain[name], args, kw,
                                         row)
        elif name == "seg_merge":
            say(f"  seg_merge at {args[0].numel()} records: device time per "
                f"call {device_ms(torch, [lambda: fn(*args, **kw)], 10):.4f}"
                " ms (L2-warm)")
        if name in ("bal_scores", "greedy_pick"):
            where = ("at the main path's call" if name not in rows
                     else "at the finest level")
            extra = kernel_device(torch, name, fn, args, kw, where)
            if name not in rows:
                row.update(extra)
        rows.setdefault(name, row)    # beyond the main path: printed only
    round_stages(torch, finest)
    del finest
    return [rows[name] for name in MAIN_PATH]


def in_turn(fn, arg_sets, kw):
    """One call of ``fn`` a call, on each of ``arg_sets`` in turn."""
    calls = itertools.cycle([functools.partial(fn, *a, **kw)
                             for a in arg_sets])
    return lambda: next(calls)()


def held_and_timed(torch, name, fn, plain, args, kw, reps, launches,
                   library=None, rotate=None):
    """Hold the kernel to its plain version on these inputs, time both
    (and the library call ``library(*args)``, if given) with CUDA events,
    and return the kernel's record row. ``rotate``: argument sets (the
    first ``args``) that the timed calls take in turn, for kernel, plain
    version and library alike."""
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    err, rel, share = compare(name, got, want)
    del want
    shape = [tuple(t.shape) for t in args if hasattr(t, "shape")]
    sets = rotate or [args]
    ms = cuda_ms(torch, in_turn(fn, sets, kw), reps)
    plain_ms = cuda_ms(torch, in_turn(plain, sets, kw), max(2, reps // 10))
    b_ms, b_by = bound(name, args, kw, got)
    lib_ms, lib_err = None, None
    if library is not None:
        lib_ms, lib_err = library_ms(torch, library, sets, got, reps)
    lib = ("n/a" if library is None else
           f"{lib_ms:.4f} ms" if lib_err is None else lib_err)
    say(f"  {name} {' '.join(map(str, shape))}: {tolerance_text(name)} "
        f"(max abs err {err}, max rel err {rel}{share_text(share)}); "
        f"kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"library {lib}")
    src, replaces = KERNELS[name]
    row = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "shape": [list(t) for t in shape]}
    if share is not None:
        row["allowance_share"] = share
    if lib_err is not None:
        row["library_error"] = lib_err
    return row


def library_ms(torch, library, sets, got, reps):
    """(ms, None) of one PyTorch library call computing the kernel's
    function, ``library(*args)`` on each of ``sets`` in turn, or (None,
    its error) if the installed torch rejects it. The call is only a
    yardstick; its largest difference from the kernel's output (on the
    first set) is printed."""
    try:
        out = library(*sets[0])
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError, ValueError) as exc:
        return None, f"{type(exc).__name__}: {exc}"
    diff = float((out - got).abs().max())
    say(f"  library call: max abs difference from the kernel {diff}")
    return cuda_ms(torch, in_turn(library, sets, {}), reps), None


# ---------------------------------------------------------------------------
# phase 6: kernels off the main path, through their own entry points
# ---------------------------------------------------------------------------

GRID_SIDE = 1024           # spmm: grid2d 1024 x 1024, the mesh family
SPMM_F = 128               # d_hidden of the repo's dimenet config
EB_V, EB_D, EB_B = 1_000_000, 64, 65_536   # one dlrm-rm2 table, train batch
EB_SETS = 8                # index sets the timed embedding_bag calls rotate
DATA_SEED = 12


def drive(torch, build, name, call):
    """Run one entry-point path with the launch counts zeroed just before
    it and read just after it; fail unless ``name`` launched."""
    build.reset_launches()
    out = call()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    say(f"  launches {json.dumps(launches, sort_keys=True)}")
    check(launches[name] > 0, f"{name}: its entry point never launched it")
    return out, launches[name]


def edge_scan_gain(g, labels, cw, budget, k):
    """(gain, target, own_conn) by a scan over the arcs: the connection
    to each label, the best admissible one (the smallest label among the
    maximisers, -1 if none), as the JAX package's lp_gain test checks
    its kernel. Admission in f32, as the kernel tests it."""
    src = g.arc_tails().astype(np.int64)
    lab = labels.astype(np.int64)
    conn = np.bincount(src * k + lab[g.adjncy], weights=g.eweights,
                       minlength=g.n * k).reshape(g.n, k)
    own = conn[np.arange(g.n), lab]
    fits = (cw.astype(np.float32)[None, :]
            + g.vweights.astype(np.float32)[:, None]
            <= np.float32(budget)) & (conn > 0)
    fits[np.arange(g.n), lab] = False
    score = np.where(fits, conn, -1.0)
    best = score.max(1)
    target = np.where(best >= 0, score.argmax(1), -1)
    gain = best.astype(np.float32) - own.astype(np.float32)
    return gain, target.astype(np.int32), own.astype(np.float32)


def lp_gain_lane_widths(torch, g, labels, cw, budget, fn, args, dev):
    """The entry point's wall time and the kernel's time at 32 lanes (its
    default) and at the reference's 128, on the same assignment: the
    outputs must be the same bits. Each width's wall is timed three times,
    the widths in turn with the first alternating (128, 32, 32, 128, 128,
    32), and its median printed beside the three."""
    from repro_torch.kernels.lp_gain import ops as gain_ops

    walls = {128: [], 32: []}
    for lanes in (128, 32, 32, 128, 128, 32):
        t0 = time.perf_counter()
        gain_ops.lp_gain(g, labels, cw, budget, lanes=lanes)
        walls[lanes].append(time.perf_counter() - t0)
    med = {k: float(np.median(v)) for k, v in walls.items()}
    wide = gain_ops.gain_operands(g, labels, cw, budget, 256, dev, lanes=128)
    narrow_out, wide_out = fn(*args), fn(*wide)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(narrow_out, wide_out)),
          "lp_gain: the 32-lane and 128-lane slabs give different outputs")
    ms = cuda_ms(torch, lambda: fn(*wide), 20)
    say(f"  lp_gain at 128 lanes (D={wide[0].shape[1]}, slabs "
        f"{nbytes(*wide[:3])} bytes): the same bits; kernel {ms:.4f} ms; "
        f"entry point wall, median of three, {med[128]:.3f} s "
        f"({', '.join(f'{t:.3f}' for t in walls[128])}) against "
        f"{med[32]:.3f} s at 32 lanes "
        f"({', '.join(f'{t:.3f}' for t in walls[32])})")
    del wide, narrow_out, wide_out


def bsr_spmm_launches_and_times(torch, args, kw):
    """bsr_spmm beyond its wrapper time, on phase 6's input: device
    launches per call (nodes of a captured CUDA graph of the kernel's
    launch path, which checks and reads back nothing), no stream wait,
    the device time (CUDA events behind a sleep kernel) and the share of
    16 x 8 A sub-tiles the kernel skips (X is finite here, so every
    all-zero one). Every call reads its 3.7 GB of inputs from HBM: they
    are 70 times the L2."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm as bsr_mod

    col, vals, xp = args
    rb, nnz = kw["block_rows"], kw["nnz_per_row"]
    bs = vals.shape[1]
    y = torch.empty(rb * bs, xp.shape[1], dtype=torch.float32,
                    device=xp.device)
    call = functools.partial(bsr_mod._launch, col, vals, xp, y, rb, nnz)
    n = say_launches(torch, "bsr_spmm", call, f"at {rb} block rows x {nnz} "
                     "slots")
    check(n == 1, f"bsr_spmm: {n} device launches per call; expected 1")
    no_stream_wait(torch, "bsr_spmm", call)
    share = None
    if bs == 128:
        nz = vals.view(-1, 8, 16, 16, 8).ne(0).any(4).any(2)
        share = 1.0 - float(nz.float().mean())
        del nz
    ms = device_ms(torch, [call], 5)
    say(f"  bsr_spmm: device time per call (CUDA events behind a sleep "
        f"kernel; L2-cold) {ms:.4f} ms; all-zero 16 x 8 A sub-tiles "
        f"skipped: {share if share is None else f'{100 * share:.4f}%'}")
    del y
    return dict(device_launches=n, device_ms_l2_cold=ms,
                zero_subtile_share=share)


def embedding_bag_row(torch, build, eb, eb_ops, eb_ref, dev):
    """embedding_bag through its entry point on one dlrm-rm2 table at the
    training batch, BAG 1 (the record's row) and 4 (printed). The timed
    calls take EB_SETS index sets in turn, whose gathered rows together
    (134 MB at BAG=1) exceed the H100's 50 MB L2, so that each call reads
    its rows from HBM as a training step does: the kernel, its plain
    version and F.embedding_bag alike. Device time is printed both so
    (cold) and for one set called again (warm, L2-resident)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(DATA_SEED)
    table = rng.standard_normal((EB_V, EB_D), dtype=np.float32)
    bags = {bag: rng.integers(0, EB_V, (EB_SETS, EB_B, bag)).astype(np.int32)
            for bag in (1, 4)}
    say(f"  embedding_bag: V={EB_V} D={EB_D} B={EB_B}, BAG 1 and 4, "
        f"{EB_SETS} index sets each ({time.perf_counter() - t0:.2f} s, "
        "set-up)")
    caps = {bag: Capture(torch) for bag in bags}

    def both_bags():
        outs = {}
        for bag, idx in bags.items():
            caps[bag].wrap(eb_ops, "_gather", "embedding_bag")
            try:
                outs[bag] = eb_ops.embedding_bag(idx[0], table)
            finally:
                caps[bag].restore()
        return outs

    outs, launches = drive(torch, build, "embedding_bag", both_bags)
    for bag, idx in bags.items():
        want = np.zeros((EB_B, EB_D), dtype=np.float32)
        for j in range(bag):
            want += table[idx[0][:, j]]
        check(np.array_equal(outs[bag], want),
              f"embedding_bag BAG={bag}: differs from the sequential sum")
        say(f"  embedding_bag BAG={bag} = sequential numpy sum (exact)")
    eb_rows = {}
    for bag in bags:
        # the entry point's launch path: indices checked on the host
        _, fn, args, kw = caps[bag].inputs["embedding_bag"]
        idx, tab = args
        sets = [(idx, tab)] + [(torch.from_numpy(x).to(dev), tab)
                               for x in bags[bag][1:]]
        gathered = EB_SETS * EB_B * bag * EB_D * 4 / 1e6
        say(f"  embedding_bag BAG={bag}: timed over the {EB_SETS} sets in "
            f"turn, {gathered:.1f} MB of gathered rows")
        eb_rows[bag] = held_and_timed(
            torch, "embedding_bag", fn, eb_ref.embedding_bag_ref, args, kw,
            200, launches, rotate=sets,
            library=lambda i, t: torch.nn.functional.embedding_bag(
                i, t, mode="sum"))
        checked_ms = cuda_ms(torch, in_turn(eb.embedding_bag_1row, sets, {}),
                             200)
        check_ms = cuda_ms(torch, in_turn(
            build.check_index_range, [("idx", i, EB_V) for i, _ in sets],
            {}), 200)
        say(f"  embedding_bag BAG={bag}: the checked wrapper "
            f"(embedding_bag_1row on device tensors) {checked_ms:.4f} ms, "
            f"of which its index range check {check_ms:.4f} ms")
        say_launches(torch, f"embedding_bag BAG={bag}",
                     lambda: fn(idx, tab), "on the launch path")
        cold = device_ms(torch, [functools.partial(fn, *a) for a in sets],
                         5)
        warm = device_ms(torch, [lambda: fn(idx, tab)], 40)
        say(f"  embedding_bag BAG={bag}: device time per call (CUDA events "
            f"behind a sleep kernel) L2-cold {cold:.4f} ms (the sets in "
            f"turn), L2-warm {warm:.4f} ms (one set again); bound "
            f"{eb_rows[bag]['bound_ms']:.4f} ms")
        eb_rows[bag]["device_ms_l2_cold"] = cold
        no_stream_wait(torch, f"embedding_bag BAG={bag}",
                       lambda: fn(idx, tab))
    return eb_rows[1]       # the config's bag size; BAG=4 printed


def phase_off_main(torch, build, g, assignment, dev):
    say("== phase 6: kernels off the main path, through their entry points "
        "on the default device")
    from repro_torch.core import metrics
    from repro_torch.graphs import generators
    from repro_torch.kernels.bsr_spmm import ops as bsr_ops, ref as bsr_ref
    from repro_torch.kernels.embedding_bag import embedding_bag as eb
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag import ref as eb_ref
    from repro_torch.kernels.lp_gain import ops as gain_ops
    from repro_torch.kernels.lp_gain import ref as gain_ref

    rows = []
    # lp_gain: the refinement gain at the finest level of phase 4's run
    k = 16
    labels = np.asarray(assignment)
    cw = np.bincount(labels, weights=g.vweights, minlength=k)
    budget = float(metrics.l_max(g.total_vweight, k, 0.03,
                                 int(g.vweights.max())))
    say(f"  lp_gain: rgg2d n={g.n}, phase 4's assignment (k={k}), "
        f"budget L_max={budget}")
    cap = Capture(torch)
    cap.wrap(gain_ops, "lp_gain_ell", "lp_gain")
    t0 = time.perf_counter()
    try:
        got, launches = drive(torch, build, "lp_gain",
                              lambda: gain_ops.lp_gain(g, labels, cw, budget))
    finally:
        cap.restore()
    say(f"  lp_gain entry point {time.perf_counter() - t0:.3f} s")
    want = edge_scan_gain(g, labels, cw, budget, k)
    for what, a, b in zip(("gain", "target", "own_conn"), got, want):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"lp_gain: {what} differs from the edge scan")
    say(f"  lp_gain = edge scan (exact); rows with an admissible target "
        f"{int((want[1] >= 0).sum())}")
    _, fn, args, kw = cap.inputs["lp_gain"]
    N, D = args[0].shape
    say(f"  lp_gain slabs: D={D} lanes, three {N} x {D} slabs of "
        f"{nbytes(*args[:3])} bytes together")
    rows.append(held_and_timed(torch, "lp_gain", fn, gain_ref.lp_gain_ell_ref,
                               args, {}, 20, launches))
    lp_gain_lane_widths(torch, g, labels, cw, budget, fn, args, dev)
    del cap, args, got, want
    torch.cuda.empty_cache()

    # bsr_spmm: GNN aggregation on the mesh family, F = dimenet's d_hidden
    t0 = time.perf_counter()
    gg = generators.grid2d(GRID_SIDE, GRID_SIDE)
    x = np.random.default_rng(DATA_SEED).standard_normal(
        (gg.n, SPMM_F), dtype=np.float32)
    say(f"  spmm: grid2d {GRID_SIDE}x{GRID_SIDE} n={gg.n} m={gg.m}, "
        f"F={SPMM_F} ({time.perf_counter() - t0:.2f} s, set-up)")
    cap = Capture(torch)
    cap.wrap(bsr_ops, "bsr_spmm", "bsr_spmm")
    t0 = time.perf_counter()
    try:
        y, launches = drive(torch, build, "bsr_spmm",
                            lambda: bsr_ops.spmm(gg, x))
    finally:
        cap.restore()
    say(f"  spmm entry point {time.perf_counter() - t0:.3f} s (host BSR "
        "build included)")
    yt = torch.from_numpy(y).to(dev).double()
    src = torch.from_numpy(gg.arc_tails().astype(np.int64)).to(dev)
    dst = torch.from_numpy(np.asarray(gg.adjncy, dtype=np.int64)).to(dev)
    w = torch.from_numpy(gg.eweights.astype(np.float64)).to(dev)
    xt = torch.from_numpy(x).to(dev).double()
    ref = torch.zeros_like(xt).index_add_(0, src, w[:, None] * xt[dst])
    d = (yt - ref).abs()
    check(bool((d <= 5e-4 + 5e-5 * ref.abs()).all()),
          f"spmm: differs from the COO sum beyond rtol 5e-5 / atol 5e-4 "
          f"(max abs {float(d.max())})")
    say(f"  spmm = COO sum in f64 within rtol 5e-5 / atol 5e-4 (max abs "
        f"{float(d.max())})")
    del yt, src, dst, w, xt, ref, d
    _, fn, args, kw = cap.inputs["bsr_spmm"]
    col, vals, xp = args
    bs = vals.shape[1]
    rb = kw["block_rows"]
    nnz = kw["nnz_per_row"]
    real = vals.flatten(1).ne(0).any(1)      # padded slots are all-zero
    say(f"  bsr: {rb} block rows x {nnz} slots, {int(real.sum())} nonzero "
        f"blocks, vals {nbytes(vals)} bytes; dense block products "
        f"{2.0 * int(real.sum()) * bs * bs * xp.shape[1]:.4g} flop "
        f"({2.0 * int(real.sum()) * bs * bs * xp.shape[1] / CUDA_CORE_OPS_PER_S * 1e3:.4f} ms "
        "at the f32 rate)")

    extra = bsr_spmm_launches_and_times(torch, args, kw)

    @functools.lru_cache(maxsize=1)
    def bsr_matrix():       # built at the first library call
        crow = torch.zeros(rb + 1, dtype=torch.int64, device=dev)
        crow[1:] = real.view(rb, nnz).sum(1).cumsum(0)
        return torch.sparse_bsr_tensor(crow, col[real].long(), vals[real],
                                       size=(rb * bs, xp.shape[0]))

    rows.append(held_and_timed(torch, "bsr_spmm", fn, bsr_ref.bsr_spmm_ref,
                               args, kw, 20, launches,
                               library=lambda *_: bsr_matrix() @ xp))
    rows[-1].update(extra)
    bsr_matrix.cache_clear()
    del cap, args, col, vals, xp, real, y
    torch.cuda.empty_cache()
    rows.append(embedding_bag_row(torch, build, eb, eb_ops, eb_ref, dev))
    return rows



# ---------------------------------------------------------------------------
# phase 7: the unconstrained tier, the baselines, the CLI and a session
# ---------------------------------------------------------------------------

def strip_times(trace):
    return [{k: v for k, v in rec.items() if k != "time_s"}
            for rec in trace]


def unconstrained_trace():
    """The reference's trace of the unconstrained run, wall times apart."""
    names = {"coarsen": ("coarse_n", "W")}
    out = []
    for phase, level, n, m, a, b in UNCONSTRAINED_TRACE:
        rec = {"phase": phase}
        if level is not None:
            rec["level"] = level
        ka, kb = names.get(phase, ("blocks", "cut"))
        rec.update({"n": n, "m": m, ka: a, kb: b})
        out.append(rec)
        if phase != "coarsen":
            mode = {"phase": "refine-mode", "stage": phase,
                    "mode": "unconstrained"}
            if level is not None:
                mode["level"] = level
            mode.update(penalty=[0.0, 0.5],
                        repair_rounds=REPAIR_ROUNDS[(phase, level)])
            out.append(mode)
    return out


class NvccRuns:
    """Records the source of every nvcc process ``kernels._build`` starts
    while it is entered."""

    def __init__(self, build):
        self.build = build
        self.sources = []
        self._popen = build.subprocess.Popen

    def __enter__(self):
        popen = self._popen

        def counted(cmd, *args, **kw):
            self.sources.append(Path(cmd[-1]).stem)
            return popen(cmd, *args, **kw)

        self.build.subprocess.Popen = counted
        return self

    def __exit__(self, *exc):
        self.build.subprocess.Popen = self._popen


def session_first_loads(torch, api, build):
    """A threaded session whose requests load every kernel anew, from a
    fresh build directory: nvcc must run at most once a source, and every
    result must equal a solo run's and the reference's cut."""
    from repro_torch.core.deep_mgp import PartitionerConfig

    fresh = build.BUILD_DIR / f"session-{os.getpid()}"
    with build._LOCK:            # forget the libraries phase 1 loaded
        build.BUILD_DIR = fresh
        build._libs.clear()
    cfg = PartitionerConfig(contraction_limit=64)
    reqs = [api.PartitionRequest(graph=api.GraphSpec("rgg2d", 2000, 8.0,
                                                     seed=s),
                                 k=8, config=cfg) for s in SESSION_CUTS]
    reqs.append(dataclasses.replace(reqs[0], quality="best"))
    with NvccRuns(build) as nvcc:
        t0 = time.perf_counter()
        with api.PartitionSession(devices=1, max_workers=4) as sess:
            batch = sess.run_batch(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    say(f"  session: {len(reqs)} requests on 4 threads, kernels loaded "
        f"from a fresh build directory, {wall:.3f} s (builds included); "
        f"nvcc runs {sorted(nvcc.sources)}")
    check(nvcc.sources and len(nvcc.sources) == len(set(nvcc.sources)),
          f"session: a library was built more than once: {nvcc.sources}")
    check(not list(fresh.glob("*.tmp")), "session: a build left a .tmp")
    solo = api.Partitioner().run_batch(reqs)
    want = [*SESSION_CUTS.values(), SESSION_BEST_CUT]
    for r, s, cut in zip(batch, solo, want):
        check(np.array_equal(r.assignment, s.assignment)
              and strip_times(r.trace) == strip_times(s.trace),
              f"session: {r.request.graph} differs from its solo run")
        check(r.feasible and r.cut == cut,
              f"session: cut {r.cut}, feasible {r.feasible}; the "
              f"reference gives {cut}, feasible")
    say(f"  session cuts {[r.cut for r in batch]} = solo runs = the "
        f"reference's; stats {sess.stats()}")


def phase_unconstrained(torch, api, build, g, lp_run, lp_wall, lp_launches):
    say(f"== phase 7: unconstrained tier at rgg2d {FULL_N}, the baselines, "
        "the CLI and a session")
    from repro_torch.core import balance, unconstrained
    from repro_torch.kernels.bal_round import ops as bal_ops
    from repro_torch.kernels.bal_round import ref as bal_ref
    from repro_torch.kernels.lp_move import ops as lp_ops
    from repro_torch.kernels.lp_move import ref as lp_ref
    from repro_torch.kernels.seg_merge import ops as seg_ops
    from repro_torch.kernels.seg_merge import ref as seg_ref

    session_first_loads(torch, api, build)

    capture = Capture(torch)
    for module, attr, name in ((lp_ops, "lp_move_chunk", "lp_move"),
                               (seg_ops, "seg_merge", "seg_merge"),
                               (bal_ops, "bal_scores", "bal_scores"),
                               (bal_ops, "greedy_pick", "greedy_pick")):
        capture.wrap(module, attr, name)
    timers = HostTimers()
    timers.install()
    # the unconstrained pass's own reorder, and every rebalance call's
    # (n, rounds, wall seconds): the afterburners and the rebalances
    # before each pass
    timers.wrap(unconstrained, "permute", "permute")
    timers.wrap(unconstrained, "degree_bucket_order", "degree_bucket_order")
    rebalances = []
    rebalance = balance.rebalance

    def timed_rebalance(g_, *args, **kw):
        kw["stats"] = stats = {} if kw.get("stats") is None else kw["stats"]
        t0 = time.perf_counter()
        out = rebalance(g_, *args, **kw)
        rebalances.append((g_.n, stats["rounds"], time.perf_counter() - t0))
        return out

    balance.rebalance = timed_rebalance
    try:
        build.reset_launches()
        t0 = time.perf_counter()
        res = run_partition(api, g, 16, "fused", refine="unconstrained")
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)  # this path's run and no other
        wall = time.perf_counter() - t0
    finally:
        balance.rebalance = rebalance
        timers.restore()
        capture.restore()
    say(f"  unconstrained: cut {res.cut} feasible {res.feasible} wall "
        f"{wall:.3f} s (lp, phase 4: cut {lp_run.cut}, wall {lp_wall:.3f} s)")
    say(f"  launches unconstrained {json.dumps(launches, sort_keys=True)}")
    say(f"  launches lp            {json.dumps(lp_launches, sort_keys=True)}")
    lp_times = {(r["phase"], r.get("level")): r["time_s"]
                for r in lp_run.trace if "time_s" in r}
    for rec in res.trace:
        if rec["phase"] == "refine-mode":
            say(f"    refine-mode {rec['stage']} level {rec.get('level')}: "
                f"penalty {rec['penalty']}, repair rounds "
                f"{rec['repair_rounds']}")
        else:
            key = (rec["phase"], rec.get("level"))
            say(f"  {key[0]} level {key[1]} n={rec['n']}: time_s "
                f"{rec['time_s']} (lp {lp_times.get(key)})")
    timers.report()
    ran = [(n, r, round(secs, 4)) for n, r, secs in rebalances if r]
    say(f"  rebalance calls {len(rebalances)}, "
        f"{sum(secs for *_, secs in rebalances):.4f} s in all; those that "
        f"ran rounds (n, rounds, s): {ran}")
    check(res.feasible and res.cut == UNCONSTRAINED_CUT,
          f"unconstrained: cut {res.cut}, feasible {res.feasible}; the "
          f"reference gives {UNCONSTRAINED_CUT}, feasible")
    check(strip_times(res.trace) == unconstrained_trace(),
          "unconstrained: the trace (refine-mode records included) differs "
          "from the reference's")
    for name in MAIN_PATH:
        check(launches[name] > 0,
              f"unconstrained path: {name} was never launched")
    plain = {"lp_move": lp_ref.lp_move_chunk_ref,
             "seg_merge": seg_ref.seg_merge_ref,
             "bal_scores": bal_ref.bal_scores_ell_ref,
             "greedy_pick": bal_ref.greedy_pick_ref}
    for name in MAIN_PATH:
        _, fn, args, kw = capture.inputs[name]
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        compare(name, got, plain[name](*args, **kw))
        ms = cuda_ms(torch, lambda: fn(*args, **kw), 20)
        shape = " ".join(str(tuple(t.shape)) for t in args
                         if hasattr(t, "shape"))
        say(f"  {name} at this path's largest call {shape}: bit-identical "
            f"to its plain version; kernel {ms:.4f} ms")
    del capture

    req = api.PartitionRequest(graph=g, k=16, epsilon=0.03, preset="fast",
                               kernel="fused", refine="unconstrained")
    build.reset_launches()
    results = api.Partitioner(backend="single").compare(
        req, list(BASELINE_CUTS))
    torch.cuda.synchronize()
    cmp_launches = dict(build.LAUNCHES)
    for r in results:
        say(f"  compare {r.backend}: cut {r.cut} feasible {r.feasible} "
            f"wall {r.time_s:.3f} s")
        check(r.feasible and r.cut == BASELINE_CUTS[r.backend],
              f"compare {r.backend}: cut {r.cut}, feasible {r.feasible}; "
              f"the reference gives {BASELINE_CUTS[r.backend]}, feasible")
    say(f"  deep MGP on the same request: lp cut {lp_run.cut} "
        f"({lp_wall:.3f} s), unconstrained {res.cut} ({wall:.3f} s); "
        "launches of the comparison "
        f"{json.dumps(cmp_launches, sort_keys=True)}")

    cmd = [sys.executable, "-m", "repro_torch.launch.partition", "--family",
           "rgg2d", "--n", "4000", "--k", "16", "--compare", "--trace"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ,
                                                 PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0,
          f"CLI exit {out.returncode}: {out.stderr[-2000:]}")
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    summaries = [x for x in lines if "backend" in x]
    cuts = {x["backend"]: x["cut"] for x in summaries}
    say(f"  CLI {' '.join(cmd[1:])}: exit 0, {len(lines)} lines, "
        f"{time.perf_counter() - t0:.2f} s; cuts {cuts}")
    check(len(summaries) == 3 and cuts == CLI_CUTS
          and all(x["feasible"] for x in summaries),
          f"CLI: summaries {summaries}; the reference CLI gives "
          f"{CLI_CUTS}, feasible")
    return {"main": lp_launches, "unconstrained": launches,
            "compare": cmp_launches}, res, wall


# ---------------------------------------------------------------------------
# phase 8: serving (the stacked level-0 clustering, a served burst, a
# served batch at the main path's size, the serve CLI)
# ---------------------------------------------------------------------------

SERVE_SEEDS = (0, 1, 2)       # 8a: request seeds of the stacked level 0
BURST_N = 1 << 16             # 8b: rgg2d n of the served burst


def stacked_level0(torch, api, build, g):
    """8a: the stacked level-0 clustering of three requests on the main
    path's graph (request seeds 0-2): fused against the composed stacked
    form on the card and three solo ``cluster(kernel="fused")`` calls,
    then one stacked ``lp_move`` call at the level-0 chunk shape against
    its plain version, timed beside the three solo calls of the same
    chunks. Returns the kernel's record row."""
    from repro_torch.core import coarsening
    from repro_torch.core.deep_mgp import level0_cluster_plan
    from repro_torch.kernels.lp_move import lp_move as lp_mod
    from repro_torch.kernels.lp_move import ops as lp_ops
    from repro_torch.kernels.lp_move import ref as lp_ref
    from repro_torch.serve import batching

    reqs = [api.PartitionRequest(graph=g, k=16, epsilon=0.03, preset="fast",
                                 seed=s) for s in SERVE_SEEDS]
    plans = [level0_cluster_plan(g, 16, r.resolve_config()) for r in reqs]
    capture = Capture(torch)
    capture.wrap(lp_ops, "lp_move_chunk_stacked", "lp_move_stacked")
    try:
        build.reset_launches()
        t0 = time.perf_counter()
        fused = batching.stacked_level0_labels([g] * len(reqs), plans,
                                               kernel="fused")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    finally:
        capture.restore()
    calls = plans[0]["num_iterations"] * plans[0]["num_chunks"]
    say(f"  8a stacked level 0, S={len(reqs)} (request seeds "
        f"{list(SERVE_SEEDS)}, W {[p['W'] for p in plans]}): {wall:.3f} s, "
        f"lp_move_stacked {launches['lp_move_stacked']} calls, lp_move "
        f"{launches['lp_move']}")
    check(launches["lp_move_stacked"] == calls and launches["lp_move"] == 0,
          f"8a: {launches['lp_move_stacked']} stacked and "
          f"{launches['lp_move']} solo lp_move calls; expected {calls} and 0")
    t0 = time.perf_counter()
    composed = batching.stacked_level0_labels([g] * len(reqs), plans,
                                              kernel="composed")
    composed_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    solo = [coarsening.cluster(g, p["W"], num_iterations=p["num_iterations"],
                               num_chunks=p["num_chunks"], seed=p["seed"],
                               kernel="fused") for p in plans]
    torch.cuda.synchronize()
    solo_wall = time.perf_counter() - t0
    for s, (a, b, c) in enumerate(zip(fused, composed, solo)):
        check(np.array_equal(a, b) and np.array_equal(a, c),
              f"8a: request {s}'s stacked labels differ from the composed "
              "stacked form or its solo cluster call")
    say(f"  8a labels bit-identical to the composed stacked form "
        f"({composed_wall:.3f} s) and to 3 solo cluster(kernel='fused') "
        f"calls ({solo_wall:.3f} s)")
    _, fn, args, kw = capture.inputs["lp_move_stacked"]
    del capture
    S, R, D = args[0].shape
    check((S, R, D) == (3, 262144, 32),
          f"8a: the stacked call's shape {(S, R, D)}; expected the level-0 "
          "chunk's (3, 262144, 32)")
    # the free-memory guard of _stacked_fused against the peak it guards,
    # on a run without the capture's copies
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    again = batching.stacked_level0_labels([g] * len(reqs), plans,
                                           kernel="fused")
    peak = torch.cuda.max_memory_allocated() - held
    need = lp_ops.stacked_bytes(S, plans[0]["num_chunks"], R, D, args[-1])
    check(all(np.array_equal(a, b) for a, b in zip(again, fused)),
          "8a: a second stacked level 0 differs from the first")
    check(0 < peak <= need,
          f"8a: the stacked level 0 peaked at {peak} device bytes; its "
          f"free-memory guard reckons {need}")
    say(f"  8a device memory: peak {peak} bytes over the stacked level 0, "
        f"guard (stacked_bytes) {need} bytes")
    row = held_and_timed(torch, "lp_move_stacked", fn,
                         lp_ref.lp_move_chunk_stacked_ref, args, kw, 20,
                         launches["lp_move_stacked"])
    call = (lambda: fn(*args, **kw))            # noqa: E731
    n_stacked = say_launches(torch, "lp_move_stacked", call,
                             f"at S={S} x {R} rows")
    nlab, nw, ncw, own, vw, W, v0, salt, num_labels = args
    Ws, v0s, salts = (x.tolist() for x in (W, v0, salt))
    solo_calls = [functools.partial(
        lp_mod.lp_move_chunk, nlab[s], nw[s], ncw[s], own[s], vw[s], Ws[s],
        v0s[s], salts[s] & 0xFFFFFFFF, num_labels) for s in range(S)]
    n_solo = say_launches(torch, "lp_move", solo_calls[0],
                          f"at {R} rows (one request's chunk)")
    check(n_stacked == n_solo <= 12,
          f"8a: {n_stacked} device launches a stacked call, {n_solo} a solo "
          "one; expected the same number, at most 12")
    dev_ms = device_ms(torch, [call], 20)
    solo_ms = cuda_ms(torch, lambda: [c() for c in solo_calls], 20)
    solo_dev = device_ms(torch, solo_calls, 20) * S
    no_stream_wait(torch, "lp_move_stacked", call)
    for s, c in enumerate(solo_calls):
        got = c()
        check(all(torch.equal(a, b[s]) for a, b in zip(got, fn(*args,
                                                                **kw))),
              f"8a: request {s}'s solo lp_move call differs from its row "
              "of the stacked call")
    say(f"  lp_move_stacked: device time per call {dev_ms:.4f} ms (CUDA "
        f"events behind a sleep kernel); the {S} solo calls of the same "
        f"chunks {solo_ms:.4f} ms back to back (wrapper), {solo_dev:.4f} ms "
        f"of device time; stacked {row['ms']:.4f} ms; bound "
        f"{row['bound_ms']:.7f} ms ({row['bound_by']})")
    row.update(device_launches=n_stacked, device_ms=dev_ms,
               solo_calls_ms=solo_ms, solo_calls_device_ms=solo_dev,
               stack=S)
    return row


class HintTimes:
    """Wall seconds of every stacked level-0 computation of a batch
    (``serve.batching._level0_hints``, the module attribute wrapped while
    entered): (distinct requests, stacked ones, seconds)."""

    def __init__(self):
        from repro_torch.serve import batching
        self.batching = batching
        self.calls = []

    def __enter__(self):
        hints = self._hints = self.batching._level0_hints

        def timed(session, requests, stack):
            t0 = time.perf_counter()
            out = hints(session, requests, stack)
            self.calls.append((len(requests),
                               sum(h is not None for h in out),
                               round(time.perf_counter() - t0, 4)))
            return out

        self.batching._level0_hints = timed
        return self

    def __exit__(self, *exc):
        self.batching._level0_hints = self._hints


def phase_seconds(results):
    """Sum of the trace's time_s per phase over ``results``."""
    out = {}
    for r in results:
        for rec in r.trace:
            if "time_s" in rec:
                out[rec["phase"]] = out.get(rec["phase"], 0.0) + \
                    rec["time_s"]
    return {k: round(v, 3) for k, v in out.items()}


def burst(torch, build, srv_cls, reqs, best, meshes):
    """The burst through ``srv_cls(meshes=meshes)``: (results, stats,
    wall, process CPU seconds, launches, stacked level-0 times)."""
    build.reset_launches()
    t0, c0 = time.perf_counter(), time.process_time()
    with HintTimes() as hints, srv_cls(meshes=meshes, batch_max=8,
                                       batch_window_ms=50.0) as srv:
        futs = [srv.submit(r, priority=i % 2) for i, r in enumerate(reqs)]
        futs.append(srv.submit(best, deadline_s=600))
        results = [f.result(timeout=900) for f in futs]
        torch.cuda.synchronize()
        stats = srv.stats()
    return (results, stats, time.perf_counter() - t0,
            time.process_time() - c0, dict(build.LAUNCHES), hints.calls)


def served_burst(torch, api, build):
    """8b: a burst of 13 requests through a one-worker and then a
    two-worker PartitionServer on the card, each result against a solo
    run; one ``quality="best"`` request with a deadline is downgraded to
    ``fast`` at admission. No attempt may fail (a failed stacked call
    would be retried solo), and the launch counts are pinned: level 0 of
    every stacked request runs in the stacked kernel, the rest of each
    distinct run in solo ``lp_move`` calls. Returns the two-worker
    burst's launch counts."""
    from repro_torch.core.deep_mgp import level0_cluster_plan
    from repro_torch.serve import PartitionServer

    spec = api.GraphSpec("rgg2d", BURST_N, 8.0, seed=17)
    base = {s: api.PartitionRequest(graph=spec, k=16, preset="fast", seed=s)
            for s in range(6)}
    reqs = [base[s] for s in range(6)] * 2
    best = dataclasses.replace(base[0], quality="best")
    solo, solo_lp, solo_wall = {}, {}, 0.0
    for s, r in base.items():
        build.reset_launches()
        t0 = time.perf_counter()
        solo[s] = api.Partitioner().run(r)
        torch.cuda.synchronize()
        solo_wall += time.perf_counter() - t0
        solo_lp[s] = build.LAUNCHES["lp_move"]
    plan = level0_cluster_plan(spec.materialize(), 16,
                               base[0].resolve_config())
    level0 = plan["num_iterations"] * plan["num_chunks"]
    keys = ("completed", "batches", "coalesced", "batch_size_max",
            "latency_p50_s", "latency_p99_s", "queue_wait_p99_s",
            "downgraded", "retried", "per_worker_served")
    for meshes in (1, 2):
        results, stats, wall, cpu, launches, hints = burst(
            torch, build, PartitionServer, reqs, best, meshes)
        tag = f"8b ({meshes} worker{'s' * (meshes > 1)})"
        for r, req in zip(results, reqs + [base[0]]):
            check(r.ok, f"{tag}: a served result is not ok: {r.error} "
                  f"{r.detail}")
            check(r.attempts == 1, f"{tag}: a request took {r.attempts} "
                  "attempts")
            check(np.array_equal(r.result.assignment,
                                 solo[req.seed].assignment),
                  f"{tag}: the served result of seed {req.seed} differs "
                  "from its solo run")
        check(results[-1].result.request.quality == "fast"
              and stats["downgraded"] == 1,
              f"{tag}: the deadline-bearing quality='best' request was not "
              "downgraded to fast")
        check(stats["retried"] == 0, f"{tag}: {stats['retried']} retries")
        served = list({id(r.result): r.result for r in results}.values())
        stacked = [c for c in hints if c[1]]
        want_stacked = level0 * len(stacked)
        want_lp = sum(solo_lp[r.request.seed] for r in served) \
            - level0 * sum(c[1] for c in stacked)
        check(stacked and launches["lp_move_stacked"] == want_stacked
              and launches["lp_move"] == want_lp,
              f"{tag}: lp_move_stacked {launches['lp_move_stacked']}, "
              f"lp_move {launches['lp_move']}; expected {want_stacked} and "
              f"{want_lp} (stacked level 0s {hints})")
        say(f"  {tag} served burst: rgg2d n={BURST_N}, k=16, fast, seeds "
            f"0-5 twice + seed 0 'best' (deadline 600 s): all ok in one "
            f"attempt, bit-identical to solo runs; wall {wall:.3f} s, "
            f"process CPU {cpu:.3f} s, throughput "
            f"{len(results) / wall:.3f} requests/s; stats "
            f"{json.dumps({k: stats[k] for k in keys})}")
        say(f"  {tag} launches {json.dumps(launches, sort_keys=True)}; "
            f"stacked level 0s (distinct, stacked, s) {hints}; trace "
            f"seconds by phase, the {len(served)} distinct served runs "
            f"{json.dumps(phase_seconds(served))}")
    say(f"  8b the 6 distinct solo runs: {solo_wall:.3f} s, lp_move "
        f"{json.dumps(solo_lp)}, trace seconds by phase "
        f"{json.dumps(phase_seconds(solo.values()))}")
    fabric_burst(api, reqs, best, solo, spec)
    return launches


def proc_cpu_s(pid: int) -> float:
    """User + system CPU seconds of process ``pid`` so far."""
    fields = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def fabric_burst(api, reqs, best, solo, spec):
    """8e: 8b's burst through a port ``FrontDoor`` and two worker
    processes (``python -m repro_torch.launch.fabric worker``: one
    ``PartitionServer(meshes=1)`` each, on the card, each with its own
    CUDA context and interpreter). Each worker first serves one small
    request (the kernels' load and the CUDA context, not timed); then the
    13 requests go in at once. Every result must be ok in one attempt and
    equal its solo run (the 'best' request with a deadline downgraded to
    fast), both workers must serve; the wall and each worker process's
    CPU seconds over the burst are printed. The workers are stopped by
    SIGTERM (a drain) and must exit 0."""
    from repro_torch.fabric import FabricClient, FrontDoor

    env = dict(os.environ, PYTHONPATH=str(SRC))
    warm = api.PartitionRequest(graph=api.GraphSpec("rgg2d", 4000, 8.0,
                                                    seed=17), k=16)
    with FrontDoor(port=0, lease_ttl_s=30.0) as fd:
        procs = {f"fw{i}": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.fabric", "worker",
             "--frontdoor", f"{fd.host}:{fd.port}", "--server-id",
             f"fw{i}", "--heartbeat-s", "1.0"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, text=True) for i in range(2)}
        try:
            t0 = time.perf_counter()
            for sid, p in procs.items():
                line = json.loads(p.stdout.readline() or "{}")
                check(line.get("server_id") == sid,
                      f"8e: worker {sid} did not start: {line}")
            while len(fd.status()["servers"]) < 2:
                check(time.perf_counter() - t0 < 120,
                      "8e: the workers never registered")
                time.sleep(0.05)
            with FabricClient(fd.host, fd.port) as client:
                w = [f.result(timeout=600) for f in
                     [client.submit(warm) for _ in procs]]
                start = time.perf_counter() - t0
                check(all(r.ok for r in w) and {r.server for r in w}
                      == set(procs), f"8e: warm-up {[r.summary() for r in w]}")
                cpu0 = {sid: proc_cpu_s(p.pid) for sid, p in procs.items()}
                t1 = time.perf_counter()
                futs = [client.submit(r, priority=i % 2)
                        for i, r in enumerate(reqs)]
                futs.append(client.submit(best, deadline_s=600))
                results = [f.result(timeout=900) for f in futs]
                wall = time.perf_counter() - t1
            cpu = {sid: proc_cpu_s(p.pid) - cpu0[sid]
                   for sid, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            codes = []
            for p in procs.values():
                try:
                    codes.append(p.wait(timeout=120))
                except subprocess.TimeoutExpired:
                    p.kill()
                    codes.append(p.wait(timeout=30))
    for r, req in zip(results, reqs + [best]):
        check(r.ok and r.attempts == 1,
              f"8e: seed {req.seed}: {r.summary()}")
        check(np.array_equal(r.assignment, solo[req.seed].assignment),
              f"8e: the fabric's result of seed {req.seed} differs from "
              "its solo run")
    served = {sid: sum(r.server == sid for r in results) for sid in procs}
    check(all(served.values()), f"8e: a worker served nothing: {served}")
    check(codes == [0, 0], f"8e: worker exit codes {codes} after SIGTERM")
    say(f"  8e fabric burst: rgg2d n={spec.n}, k=16, fast, the "
        f"{len(results)} requests of 8b through a FrontDoor and 2 worker "
        f"processes (one "
        f"PartitionServer(meshes=1) each): all ok in one attempt, "
        f"bit-identical to solo runs; wall {wall:.3f} s, throughput "
        f"{len(results) / wall:.3f} requests/s; worker CPU seconds "
        f"{json.dumps({k: round(v, 3) for k, v in cpu.items()})} (sum "
        f"{sum(cpu.values()):.3f}); served {json.dumps(served)}; workers "
        f"up and warm after {start:.2f} s; exit codes {codes}")


def served_main_size(torch, api, build, g, lp_run, lp_wall, un_run,
                     un_wall, solo_launches):
    """8c: ``submit_many`` of four requests on the main path's graph
    through a ``stack="auto"`` session on the card: seed 0 fast and best
    must give phase 4's and phase 7's assignments (the reference's cuts),
    seed 1 its solo run's, and the duplicate shares seed 0's run. Returns
    the batch's launch counts. ``solo_launches``: phases 4's and 7's."""
    from repro_torch.core.deep_mgp import level0_cluster_plan

    def req(seed, quality):
        return api.PartitionRequest(graph=g, k=16, epsilon=0.03,
                                    preset="fast", seed=seed,
                                    quality=quality)

    reqs = [req(0, "fast"), req(1, "fast"), req(0, "best"), req(0, "fast")]
    build.reset_launches()
    t0 = time.perf_counter()
    solo1 = api.Partitioner().run(reqs[1])
    torch.cuda.synchronize()
    solo1_wall = time.perf_counter() - t0
    solo1_launches = dict(build.LAUNCHES)
    build.reset_launches()
    t0 = time.perf_counter()
    with HintTimes() as hints, api.PartitionSession(stack="auto") as sess:
        out = sess.submit_many(reqs).result()
        torch.cuda.synchronize()
        served = sess.stats()["served"]
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for r, want, what in ((out[0], lp_run, "phase 4's"),
                          (out[2], un_run, "phase 7's"),
                          (out[1], solo1, "its solo run's")):
        check(np.array_equal(r.assignment, want.assignment),
              f"8c: seed {r.request.seed} {r.request.quality} differs from "
              f"{what} assignment")
    check(out[0].cut == FULL_CUT and out[2].cut == UNCONSTRAINED_CUT
          and all(r.feasible for r in out),
          f"8c: cuts {[r.cut for r in out]}; expected {FULL_CUT} (fast) "
          f"and {UNCONSTRAINED_CUT} (best), feasible")
    check(out[3] is out[0] and served == 3,
          f"8c: the duplicate did not share seed 0's run ({served} runs)")
    plan = level0_cluster_plan(g, 16, reqs[0].resolve_config())
    level0 = plan["num_iterations"] * plan["num_chunks"]
    want_solo = sum(c["lp_move"] for c in (*solo_launches, solo1_launches)) \
        - 3 * level0
    check(launches["lp_move_stacked"] == level0
          and launches["lp_move"] == want_solo,
          f"8c: lp_move_stacked {launches['lp_move_stacked']}, lp_move "
          f"{launches['lp_move']}; expected {level0} and {want_solo}: the "
          "three distinct requests' level 0 stacked, the rest solo")
    say(f"  8c submit_many (seed 0 fast, seed 1 fast, seed 0 best, seed 0 "
        f"fast again) at rgg2d {FULL_N}: cuts {[r.cut for r in out]}, "
        f"{served} runs; batch wall {wall:.3f} s against the solo walls "
        f"{lp_wall:.3f} + {solo1_wall:.3f} + {un_wall:.3f} = "
        f"{lp_wall + solo1_wall + un_wall:.3f} s (phases 4, 8c, 7)")
    say(f"  8c launches, batch {json.dumps(launches, sort_keys=True)}; solo "
        f"seed 1 {json.dumps(solo1_launches, sort_keys=True)}")
    say(f"  8c stacked level 0 (distinct, stacked, s) {hints.calls}; trace "
        f"seconds by phase, the batch's 3 runs "
        f"{json.dumps(phase_seconds(out[:3]))}, the solo runs "
        f"{json.dumps(phase_seconds([lp_run, solo1, un_run]))}")
    return launches


def phase_serving(torch, api, build, g, lp_run, lp_wall, un_run, un_wall,
                  by_path):
    say("== phase 8: serving: stacked level 0, a served burst, a served "
        "batch at the main path's size, the serve CLI")
    row = stacked_level0(torch, api, build, g)
    burst = served_burst(torch, api, build)
    main = served_main_size(torch, api, build, g, lp_run, lp_wall, un_run,
                            un_wall, (by_path["main"],
                                      by_path["unconstrained"]))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--meshes", "2",
           "--requests", "12", "--n", "4000", "--k", "8", "--verify"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ,
                                                 PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0,
          f"serve CLI exit {out.returncode}: {out.stderr[-2000:]}")
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    check({"verify": "bit-identical"} in lines
          and sum(1 for x in lines if x.get("ok")) == 12,
          f"serve CLI: {out.stdout[-2000:]}")
    stats = lines[-1]["stats"]
    say(f"  8d CLI {' '.join(cmd[1:])}: exit 0, 12 ok, verify "
        f"bit-identical, {time.perf_counter() - t0:.2f} s; batches "
        f"{stats['batches']}, coalesced {stats['coalesced']}, wall "
        f"{stats['wall_s']} s")
    row["launches"] = main["lp_move_stacked"]
    return row, {"serve_burst": burst, "serve_main": main}



# ---------------------------------------------------------------------------
# phase 9: hub graphs through the fused path (heavy rows) against composed
# ---------------------------------------------------------------------------

def heavy_lanes(args, kw):
    """The heavy-row lanes (slab and overflow) of an ``lp_move`` or
    ``bal_scores`` call, None without overflow. Its overflow tensors are
    made anew for each call, so a kept call's need no copy."""
    ov = kw.get("overflow")
    if ov is None or not ov[0].numel():
        return None
    return ov[0].numel() * args[0].shape[1] + ov[2].numel()


class BuildBytes:
    """Wraps the ELL build functions (``build_move_chunks``,
    ``build_balance_ell``) and keeps (function, n, m, shape, slab bytes,
    overflow bytes) of every build."""

    def __init__(self):
        from repro_torch.kernels.bal_round import ops as bal_ops
        from repro_torch.kernels.lp_move import ops as lp_ops

        self.builds, self._undo = [], []
        for module, attr in ((lp_ops, "build_move_chunks"),
                             (bal_ops, "build_balance_ell")):
            fn = getattr(module, attr)
            setattr(module, attr, functools.partial(self._build, attr, fn))
            self._undo.append((module, attr, fn))

    def _build(self, attr, fn, g, *args, **kw):
        out = fn(g, *args, **kw)
        if attr == "build_move_chunks":
            shape, (slab, over) = out.shape, out.nbytes
        else:
            shape, slab = out[0].shape, out[0].nbytes + out[1].nbytes
            over = 0 if out[2] is None else sum(a.nbytes for a in out[2])
        self.builds.append((attr, g.n, g.m, tuple(shape), slab, over))
        return out

    def restore(self):
        for module, attr, fn in self._undo:
            setattr(module, attr, fn)


def hub_run(torch, api, build, g, kernel):
    """One ``Partitioner().run`` of g (k=16, fast) at ``kernel``: (result,
    wall, peak device bytes, launches)."""
    build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = api.Partitioner().run(api.PartitionRequest(
        graph=g, k=16, epsilon=0.03, preset="fast", kernel=kernel))
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
            dict(build.LAUNCHES))


def phase_hubs(torch, api, build, sizes=HUB_SIZES):
    """ba and rhg at ``sizes`` (seed 17, k=16, fast) at kernel="auto" (fused:
    heavy rows through the kernels' heavy-row paths) and "composed" on the
    card: bit-identical assignments and equal cuts, each run's wall, peak
    device memory and launch counts, the level-0 slab and overflow bytes
    against the CSR's and the ``slab_width`` rule's bound; the calls with
    the most heavy-row lanes held to their plain versions and timed.
    Returns (kernel rows, launches by path)."""
    from repro_torch.kernels.bal_round import ops as bal_ops
    from repro_torch.kernels.bal_round.ref import bal_scores_ell_ref
    from repro_torch.kernels.lp_move import ops as lp_ops
    from repro_torch.kernels.lp_move.ref import lp_move_chunk_ref

    say(f"== phase 9: hub graphs {sizes}, k=16, fast: fused "
        "(kernel='auto') against composed on the card")
    by_path, heavy = {}, {}
    for fam, n in sizes.items():
        t0 = time.perf_counter()
        g = api.GraphSpec(fam, n, 8.0, seed=17).materialize()
        gen = time.perf_counter() - t0
        deg = np.diff(g.indptr)
        cap, sizes = Capture(torch), BuildBytes()
        cap.wrap(lp_ops, "lp_move_chunk", "lp_move_heavy", size=heavy_lanes)
        cap.wrap(bal_ops, "bal_scores", "bal_scores_heavy", size=heavy_lanes)
        try:
            fused, f_wall, f_peak, f_launch = hub_run(torch, api, build, g,
                                                      "auto")
        finally:
            cap.restore()
            sizes.restore()
        comp, c_wall, c_peak, c_launch = hub_run(torch, api, build, g,
                                                 "composed")
        check(np.array_equal(fused.assignment, comp.assignment)
              and fused.cut == comp.cut and fused.feasible,
              f"hub {fam}: fused cut {fused.cut} and composed cut "
              f"{comp.cut} or their assignments differ")
        check(not any(r["phase"] == "kernel-fallback" for r in fused.trace),
              f"hub {fam}: a kernel-fallback record")
        check(all(f_launch[k] > 0 for k in ("lp_move", "lp_move_heavy",
                                            "seg_merge", "bal_scores",
                                            "greedy_pick")),
              f"hub {fam}: a kernel of the fused path was not launched: "
              f"{f_launch}")
        check(not any(c_launch.values()),
              f"hub {fam}: the composed run launched kernels: {c_launch}")
        by_path[f"hub_{fam}"] = f_launch
        for name, call in cap.inputs.items():
            if call[0] > heavy.get(name, ((-1,), None))[0][0]:
                heavy[name] = (call, fam)
        say(f"  {fam} n={g.n} m={g.m} max degree {int(deg.max())} (made in "
            f"{gen:.2f} s): cut {fused.cut}, feasible, fused and composed "
            "bit-identical")
        say(f"  {fam} wall fused {f_wall:.3f} s, composed {c_wall:.3f} s; "
            f"peak device memory fused {f_peak} B, composed {c_peak} B")
        say(f"  {fam} launches fused {json.dumps(f_launch, sort_keys=True)}")
        say(f"  {fam} trace seconds by phase, fused "
            f"{json.dumps(phase_seconds([fused]))}, composed "
            f"{json.dumps(phase_seconds([comp]))}")
        # level 0's chunks and the finest level's balancer
        kept = [[b for b in sizes.builds if b[0] == attr][pick]
                for attr, pick in (("build_move_chunks", 0),
                                   ("build_balance_ell", -1))
                if any(b[0] == attr for b in sizes.builds)]
        for attr, n, m, shape, slab, over in kept:
            rows = int(np.prod(shape[:-1]))
            parts = shape[0] if attr == "build_move_chunks" else 1
            csr = 8 * m + 4 * (n + 1)
            lim = 8 * (max(32 * rows, 2 * m) + m) + 4 * (2 * n + parts)
            check(slab + over <= lim, f"hub {fam}: {attr} slab + overflow "
                  f"{slab + over} B over the slab_width rule's {lim} B")
            say(f"  {fam} {attr} n={n} m={m}: slab {shape} {slab} B, "
                f"overflow {over} B, CSR {csr} B; (slab + overflow) / CSR "
                f"{(slab + over) / csr:.3f} (rule's bound {lim} B)")
    rows = []
    for name in ("lp_move_heavy", "bal_scores_heavy"):
        check(name in heavy, f"no {name} call on the hub paths")
        (_, fn, args, kw), fam = heavy[name]
        plain = {"lp_move_heavy": lp_move_chunk_ref,
                 "bal_scores_heavy": bal_scores_ell_ref}[name]
        say(f"  {name}: the {fam} call with the most heavy-row lanes "
            f"({kw['overflow'][0].numel()} heavy rows, "
            f"{kw['overflow'][2].numel()} overflow arcs)")
        rows.append(held_and_timed(torch, name, fn, plain, list(args), kw,
                                   20, sum(c[name] for c in
                                           by_path.values())))
    return rows, by_path


# ---------------------------------------------------------------------------
# phase 10: the distributed engine at P=1 (a one-rank NCCL group)
# ---------------------------------------------------------------------------

def dist_trace(trace):
    """A trace as DIST_ANCHORS keeps it."""
    return tuple((r["phase"], r.get("level"), r["n"], r["m"],
                  r.get("coarse_n", r.get("blocks")),
                  r.get("W", r.get("cut")),
                  r.get("payload_bytes", r.get("balance_rounds")))
                 for r in trace)


def assignment_digest(a) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a, dtype=np.int64)
                          .tobytes()).hexdigest()


def dist_run(torch, api, build, pe, g, kernel, model):
    """One ``Partitioner(backend="dist").run`` of g (k=16, fast, devices=1)
    with the launch and collective counts zeroed just before and read
    just after: (result, wall, peak device bytes, launches,
    collectives)."""
    build.reset_launches()
    pe.collectives = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = api.Partitioner(backend="dist").run(api.PartitionRequest(
        graph=g, k=16, epsilon=0.03, preset="fast", devices=1,
        kernel=kernel, **model))
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
            dict(build.LAUNCHES), pe.collectives)


def dist_capture(torch):
    """Wrap the distributed engine's kernel calls, keeping the largest
    call of each distributed form: lp_move's budget admission and its
    heavy rows, bal_scores on a PE's table and its heavy rows."""
    from repro_torch.dist import dist_lp
    from repro_torch.kernels.bal_round import ops as bal_ops

    def dist_only(args, kw):
        return args[0].numel() if kw.get("dist") else None

    def heavy_dist(args, kw):
        lanes = heavy_lanes(args, kw)
        return lanes if lanes and (kw.get("dist") or
                                   kw.get("nbud") is not None) else None

    cap = Capture(torch)
    cap.wrap(dist_lp, "lp_move_chunk", "lp_move_dist")
    cap.wrap(dist_lp, "lp_move_chunk", "lp_move_heavy_dist",
             size=heavy_dist)
    cap.wrap(bal_ops, "bal_scores", "bal_scores_dist", size=dist_only)
    cap.wrap(bal_ops, "bal_scores", "bal_scores_heavy_dist",
             size=heavy_dist)
    return cap


def phase_dist(torch, api, build, g):
    """Phase 10. Returns (kernel rows, launches by path, (each model's
    fused wall, its trace seconds))."""
    import torch.distributed

    from repro_torch.api import runtime
    from repro_torch.dist import collectives
    from repro_torch.kernels.bal_round.ref import bal_scores_ell_ref
    from repro_torch.kernels.lp_move.ref import lp_move_chunk_ref

    say(f"== phase 10: the distributed engine at P=1 (one-rank NCCL "
        f"group), rgg2d {g.n}, k=16, fast, both memory models, fused "
        "against composed and the JAX reference")
    pe = runtime.pe_group(1, "cuda")
    say(f"  group: backend {pe.backend}, {pe.P} rank, device {pe.device}")
    hub = api.GraphSpec(DIST_HUB[0], DIST_HUB[1], 8.0, seed=17)
    by_path, calls, walls, traces = {}, {}, {}, {}
    for model, gm, kw in [(m, g, kw) for m, kw in DIST_MODELS.items()] + \
            [("hub", hub.materialize(), DIST_MODELS["sharded"])]:
        tag = model if model != "hub" else f"{DIST_HUB[0]} {gm.n} sharded"
        runs = {}
        for kernel in ("fused", "composed"):
            cap = dist_capture(torch) if kernel == "fused" else None
            try:
                runs[kernel] = dist_run(torch, api, build, pe, gm, kernel,
                                        kw)
            finally:
                if cap is not None:
                    cap.restore()
            for name, call in (cap.inputs.items() if cap else ()):
                if call[0] > calls.get(name, ((-1,), ""))[0][0]:
                    calls[name] = (call, tag)
        fres, fwall, _, flaunch, fcoll = runs["fused"]
        walls[model] = fwall
        traces[model] = phase_seconds([fres])
        cres, _, _, claunch, _ = runs["composed"]
        check(np.array_equal(fres.assignment, cres.assignment)
              and fres.cut == cres.cut and fres.feasible,
              f"dist {tag}: fused cut {fres.cut} and composed cut "
              f"{cres.cut} or their assignments differ")
        check(dist_trace(fres.trace) == dist_trace(cres.trace),
              f"dist {tag}: fused and composed traces differ")
        check(not any(claunch.values()),
              f"dist {tag}: the composed run launched kernels: {claunch}")
        say(f"  {tag}: cut {fres.cut}, feasible, fused and composed "
            f"bit-identical (sha256 {assignment_digest(fres.assignment)})")
        shown = DIST_FORMS + ("lp_move", "bal_scores")
        for kernel, (res, wall, peak, launch, coll) in runs.items():
            say(f"  {tag} {kernel}: wall {wall:.3f} s, peak device memory "
                f"{peak} B, collectives {coll}, trace seconds "
                f"{json.dumps(phase_seconds([res]))}")
            say(f"  {tag} {kernel} launches "
                f"{json.dumps({k: launch[k] for k in shown})}")
        for rec in fres.trace:
            say(f"  {tag} trace " + json.dumps(rec, sort_keys=True))
        need = ["lp_move_dist", "greedy_pick", "seg_merge"]
        need += ["bal_scores_dist"] if kw.get("balance") == "dist" else []
        need += ["lp_move_heavy_dist"] if model == "hub" else []
        check(all(flaunch[k] > 0 for k in need),
              f"dist {tag}: a kernel of its fused path was not launched "
              f"({need}): {flaunch}")
        check(fcoll > 0, f"dist {tag}: no collective ran")
        by_path[f"dist_{model}"] = flaunch
        if kw.get("contraction") == "sharded":
            check(any(r.get("payload_bytes") for r in fres.trace),
                  f"dist {tag}: no exchange payload")
        if model == "hub":
            continue
        got = [fres.cut, assignment_digest(fres.assignment),
               dist_trace(fres.trace)]
        want = DIST_ANCHORS[model]
        check(got == list(want),
              f"dist {tag}: cut {fres.cut}, the assignment or the trace "
              f"differs from the reference's (cut {want[0]})")
        say(f"  {tag}: equals the JAX reference (cut, trace, assignment "
            "sha256)")
    # the one-rank group ends with the phase
    collectives.forget_world_group()
    torch.distributed.destroy_process_group()
    plain = {"lp_move_dist": lp_move_chunk_ref,
             "lp_move_heavy_dist": lp_move_chunk_ref,
             "bal_scores_dist": bal_scores_ell_ref,
             "bal_scores_heavy_dist": bal_scores_ell_ref}
    rows = []
    for name in plain:
        if name not in calls:
            check(name == "bal_scores_heavy_dist", f"no {name} call")
            say(f"  {name}: not launched (no balancing round met a heavy "
                "row)")
            continue
        (_, fn, args, kw), where = calls[name]
        say(f"  {name}: the largest call, of the {where} fused run")
        rows.append(held_and_timed(torch, name, fn, plain[name], list(args),
                                   kw, 20, sum(c[name] for c in
                                               by_path.values())))
    return rows, by_path, (walls, traces)


def mesh_batch(torch, api, mesh, g, models, single):
    """Phase 11's batch on ``mesh``: the dist requests of ``models``
    (fused) and the ``single`` request, in that order, through a
    one-thread session bound to the mesh."""
    reqs = [api.PartitionRequest(graph=g, k=16, epsilon=0.03,
                                 preset="fast", devices=mesh.size,
                                 backend="dist", kernel="fused",
                                 **DIST_MODELS[m]) for m in models]
    if single:
        reqs.append(api.PartitionRequest(graph=g, k=16, epsilon=0.03,
                                         preset="fast", backend="single",
                                         kernel="fused"))
    mesh.reset_counts()
    t0 = time.perf_counter()
    with api.PartitionSession(devices=mesh.size, mesh=mesh,
                              max_workers=1) as sess:
        out = sess.run_batch(reqs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_mesh(torch, api, g, lp_run, walls, traces):
    """Phase 11. Returns the rank's launches over the batch."""
    from repro_torch.dist.dist_lp import make_mesh_1d

    t_phase = time.perf_counter()
    say(f"== phase 11: a mesh of rank processes, rgg2d {g.n}, k=16, fast: "
        "phase 10's request in both memory models and phase 4's single "
        "request through PartitionSession(devices=1, mesh=...)")
    t0 = time.perf_counter()
    mesh = make_mesh_1d(1)
    try:
        say(f"  mesh: {mesh.size} rank on {[str(d) for d in mesh.devices]}"
            f", pids {mesh.pids}, backend {mesh.backend}, spawn "
            f"{time.perf_counter() - t0:.3f} s (to every rank's ready)")
        models = list(DIST_MODELS)
        out, wall = mesh_batch(torch, api, mesh, g, models, True)
        launch = dict(mesh.launches[0])
        seconds = list(zip(mesh.call_seconds, mesh.rank_seconds))
        # the same request again on the warm rank
        (again,), _ = mesh_batch(torch, api, mesh, g, models[:1], False)
        seconds.append((mesh.call_seconds[0], mesh.rank_seconds[0]))
    finally:
        mesh.close()
    say(f"  batch of {len(out)} requests: {wall:.3f} s")
    for model, res, (secs, rank_s) in zip(models + models[:1],
                                          out[:-1] + [again], seconds):
        got = [res.cut, assignment_digest(res.assignment),
               dist_trace(res.trace)]
        check(got == list(DIST_ANCHORS[model]),
              f"mesh {model}: cut {res.cut}, the assignment or the trace "
              f"differs from phase 10's (cut {DIST_ANCHORS[model][0]})")
        say(f"  {model}: cut {res.cut}, equals phase 10's (sha256, trace); "
            f"mesh call {secs:.3f} s, on the rank {rank_s:.3f} s (transfer "
            f"cost {secs - rank_s:.3f} s), request {res.time_s:.3f} s; "
            f"phase 10's in-process fused wall {walls[model]:.3f} s "
            f"({secs - walls[model]:+.3f} s)")
        say(f"  {model} trace seconds on the rank "
            f"{json.dumps(phase_seconds([res]))}, in phase 10 "
            f"{json.dumps(traces[model])}")
    single = out[-1]
    check(single.backend == "single" and
          np.array_equal(single.assignment, lp_run.assignment),
          f"mesh session: the single request's cut {single.cut} differs "
          f"from phase 4's {lp_run.cut}")
    say(f"  single: cut {single.cut} in this process, equals phase 4's; "
        f"{single.time_s:.3f} s")
    shown = {k: v for k, v in launch.items() if v}
    say(f"  the rank's launches over the batch {json.dumps(shown)}")
    need = ["lp_move_dist", "greedy_pick", "seg_merge", "bal_scores_dist"]
    check(all(launch.get(k, 0) > 0 for k in need),
          f"mesh: a kernel of the fused path did not launch on the rank "
          f"({need}): {shown}")
    if torch.cuda.device_count() >= 2:
        with make_mesh_1d(2) as mesh2:
            (res2,), wall2 = mesh_batch(torch, api, mesh2, g, ["default"],
                                        False)
            l2 = mesh2.launches
        check(res2.feasible and all(x.get("lp_move_dist", 0) > 0
                                    for x in l2),
              f"mesh P=2: infeasible or no kernel launched: {l2}")
        say(f"  P=2 on two cards: cut {res2.cut}, {wall2:.3f} s")
    else:
        say("  P=2: one card visible, not run (P > 1 on cards is "
            "unmeasured here)")
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.selftest", "--devices",
         "1", "--test", "all", "kernels", "--n", str(SELFTEST_N)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    for x in lines:
        say(f"  selftest {json.dumps(x)}")
    check(proc.returncode == 0 and lines and all(x["pass"] for x in lines),
          f"selftest --devices 1 failed ({proc.returncode}): "
          f"{proc.stderr[-2000:]}")
    say(f"  selftest: {len(lines)} checks passed in "
        f"{time.perf_counter() - t0:.1f} s; phase 11 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launch


# ---------------------------------------------------------------------------
# phase 12: the placement engine and the models it places
# ---------------------------------------------------------------------------

# 12a: phase 4's graph with its ids shuffled (np.random.default_rng(0)
# .permutation, as tests/test_placement.py shuffles them), placed on 8
# devices by gnn_placement.plan with fast_config(seed=0). The JAX
# reference's cut and the sha256 of its int64 block of every input vertex
# (read off perm and offsets), on the card machine's CPU with
# kernel="composed" (benchmarks/torch_reference_anchors.py --placement;
# 94.8 s there, beside the port's 27.1 s on the card, build included)
PLACE_DEVICES = 8
PLACE_CUT = 6298
PLACE_SHA = ("c66b6261710d62b9f02f59d915b521691dc80be6201a33219f3d8d7cc14a"
             "ceb1")
# the CPU parity tests' tolerances (tests/test_torch_models.py), rtol = atol
MODEL_TOL = {"gat-cora": 1e-5, "schnet": 1e-5, "dlrm-rm2": 1e-5,
             "nequip": 1e-4, "dimenet": 1e-4}
# 12e: synthetic router samples: (arch, experts, top-k, tokens), 4 pods
MOE_ROUTING = (("arctic-480b", 128, 2, 1 << 20),
               ("granite-moe-1b-a400m", 32, 8, 1 << 16))
MOE_PODS = 4
DLRM_SHARDS = 4


def held(torch, what, got, want, tol):
    """``got`` (card) against ``want`` within rtol = atol = ``tol``;
    returns the largest absolute difference."""
    got, want = got.detach().cpu(), want.detach().cpu()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{what}: shape {tuple(got.shape)} (want {tuple(want.shape)}) or "
          "values not finite")
    err = float((got.double() - want.double()).abs().max())
    check(torch.allclose(got, want, rtol=tol, atol=tol),
          f"{what}: differs beyond rtol = atol = {tol} (max abs "
          f"difference {err:.3e})")
    return err


def timed_forward(torch, fn, reps=3):
    """(output, ms a call by CUDA events, peak device bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    ms = cuda_ms(torch, fn, reps)
    return out, ms, torch.cuda.max_memory_allocated()


def to_cpu(tree):
    return {k: v.cpu() for k, v in tree.items()}


def placement_blocks(plan):
    """The block of every input vertex, read off a placement."""
    return np.searchsorted(plan.offsets, plan.perm, side="right") - 1


def place_gnn(torch, build, g, dev):
    """12a. Returns (plan, launches)."""
    from repro_torch.core.partitioner import fast_config
    from repro_torch.placement import gnn_placement

    build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan = gnn_placement.plan(g, PLACE_DEVICES, fast_config(seed=0),
                              device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    sha = assignment_digest(placement_blocks(plan))
    say(f"  12a gnn_placement.plan(rgg2d {g.n} shuffled, {PLACE_DEVICES}, "
        f"fast_config(seed=0)) fused: cut {plan.cut}, wall {wall:.3f} s, "
        f"peak device memory {peak} B, sha256 {sha}")
    say(f"  12a offsets {plan.offsets.tolist()}, halo bytes "
        f"{plan.halo_bytes} against {plan.baseline_halo_bytes} for the "
        f"naive split ({plan.halo_bytes / plan.baseline_halo_bytes:.4f})")
    say("  12a launches " + json.dumps({k: launches[k] for k in MAIN_PATH}))
    check([plan.cut, sha] == [PLACE_CUT, PLACE_SHA],
          f"placement: cut {plan.cut} or the assignment differs from the "
          f"JAX reference's (cut {PLACE_CUT})")
    # the balancer's two kernels launch only for a level that is not
    # feasible; at k=8 on this graph none is (both counts 0)
    check(launches["lp_move"] > 0 and launches["seg_merge"] > 0
          and (launches["bal_scores"] > 0) == (launches["greedy_pick"] > 0),
          f"placement: a kernel of the fused path was not launched: "
          f"{launches}")
    if not launches["greedy_pick"]:
        say("  12a the balancer ran no round (no level was infeasible): "
            "bal_scores and greedy_pick not launched")
    g2 = plan.graph
    check(g2.n == g.n and g2.m == g.m and int(plan.offsets[-1]) == g.n
          and np.array_equal(np.sort(plan.perm), np.arange(g.n)),
          "placement: the placed graph is not a relabelling of the input")
    n = np.int64(g.n)
    want = np.sort(plan.perm[g.arc_tails()] * n + plan.perm[g.adjncy])
    got = np.sort(g2.arc_tails() * n + g2.adjncy.astype(np.int64))
    check(np.array_equal(got, want) and np.array_equal(
        np.sort(g2.eweights), np.sort(g.eweights)),
        "placement: the placed graph's arcs are not the input's, relabelled")
    check(plan.halo_bytes < plan.baseline_halo_bytes,
          "placement: no fewer halo bytes than the naive split")
    say("  12a equals the JAX reference (cut, sha256); the placed graph is "
        "the input relabelled by perm; fewer halo bytes than the naive "
        "split")
    return plan, launches


def gat_batch(snd, rcv, n, feat):
    from repro_torch.models.gnn.common import GraphBatch
    return GraphBatch(senders=snd, receivers=rcv, n_node=n + 1,
                      node_feat=feat)


def gat_on_placement(torch, g, plan, dev):
    """12b: GAT at full width on the placed graph and on the input."""
    from repro_torch import configs
    from repro_torch.models.common import init_params, param_count
    from repro_torch.models.gnn import gat

    cfg = configs.get("gat-cora").config
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    params = init_params(gat.build_specs(cfg), gen, device=dev)
    n = g.n
    feat = torch.randn((n + 1, cfg.d_in), generator=gen, device=dev)
    perm = torch.as_tensor(plan.perm, device=dev)

    def arcs(gr):
        return (torch.as_tensor(gr.arc_tails().astype(np.int32), device=dev),
                torch.as_tensor(gr.adjncy.astype(np.int32), device=dev))
    b_in = gat_batch(*arcs(g), n, feat)
    out_in = gat.forward(params, b_in, cfg)
    del b_in
    feat_placed = torch.empty_like(feat)
    feat_placed[perm] = feat[:n]
    feat_placed[n] = feat[n]
    del feat
    b_pl = gat_batch(*arcs(plan.graph), n, feat_placed)
    out_pl, ms, peak = timed_forward(
        torch, lambda: gat.forward(params, b_pl, cfg))
    err = held(torch, "gat on the placement", out_pl[perm], out_in[:n],
               MODEL_TOL["gat-cora"])
    say(f"  12b gat-cora CONFIG ({param_count(gat.build_specs(cfg))} "
        f"parameters, d_in {cfg.d_in}, {cfg.n_heads} heads x "
        f"{cfg.d_hidden}, {cfg.n_classes} classes) on the placed graph: "
        f"forward {ms:.3f} ms, peak device memory {peak} B; through perm "
        f"it equals the forward on the input within "
        f"{MODEL_TOL['gat-cora']} (max abs difference {err:.3e})")
    del b_pl, feat_placed, out_in, out_pl

    # full_graph_sm: 2,708 nodes, 10,556 arcs, card against the CPU
    shape = configs.get("gat-cora").shape("full_graph_sm").params
    rng = np.random.default_rng(DATA_SEED)
    n, arcs_n = shape["n_nodes"], shape["n_edges"]
    pairs = set()
    while len(pairs) < arcs_n // 2:
        a, b = (int(x) for x in rng.integers(0, n, 2))
        if a != b:
            pairs.add((min(a, b), max(a, b)))
    p = np.array(sorted(pairs), dtype=np.int32)
    snd = np.concatenate([p[:, 0], p[:, 1]])
    rcv = np.concatenate([p[:, 1], p[:, 0]])
    x = rng.standard_normal((n + 1, cfg.d_in)).astype(np.float32)
    card = gat.forward(params, gat_batch(
        torch.as_tensor(snd, device=dev), torch.as_tensor(rcv, device=dev),
        n, torch.as_tensor(x, device=dev)), cfg)
    cpu = gat.forward(to_cpu(params), gat_batch(
        torch.from_numpy(snd), torch.from_numpy(rcv), n,
        torch.from_numpy(x)), cfg)
    err = held(torch, "gat full_graph_sm", card, cpu, MODEL_TOL["gat-cora"])
    say(f"  12b gat-cora full_graph_sm ({n} nodes, {snd.size} arcs): card "
        f"equals the CPU within {MODEL_TOL['gat-cora']} (max abs "
        f"difference {err:.3e})")


def molecule_fields(rng, n_graphs, atoms, edges, triplets):
    """The molecule shape's batch: ``n_graphs`` graphs of ``atoms``
    atoms (positions ~ N(0, 1.5^2) per axis, species 1-9), each bonded
    along its ``edges`` closest pairs (both directions), with one
    sentinel node; DimeNet's triplets padded to a multiple of 512."""
    from repro_torch.models.gnn.dimenet import build_triplets

    iu, ju = np.triu_indices(atoms, 1)
    pos = rng.standard_normal((n_graphs, atoms, 3)).astype(np.float32) * 1.5
    snd, rcv = [], []
    for gi in range(n_graphs):
        d = np.linalg.norm(pos[gi][iu] - pos[gi][ju], axis=-1)
        near = np.argsort(d, kind="stable")[:edges]
        a, b = iu[near] + gi * atoms, ju[near] + gi * atoms
        snd += [a, b]
        rcv += [b, a]
    n = n_graphs * atoms
    f = dict(senders=np.concatenate(snd).astype(np.int32),
             receivers=np.concatenate(rcv).astype(np.int32), n_node=n + 1,
             species=rng.integers(1, 10, n + 1),
             positions=np.concatenate([pos.reshape(n, 3),
                                       np.zeros((1, 3), np.float32)]),
             graph_id=np.minimum(np.arange(n + 1) // atoms,
                                 n_graphs - 1).astype(np.int32),
             n_graphs=n_graphs, node_mask=np.arange(n + 1) < n)
    if triplets:
        E = f["senders"].size
        kj, _ = build_triplets(f["senders"], f["receivers"], n + 1, 16 * E)
        cap = -(-int((kj < E).sum()) // 512) * 512
        kj, ji = build_triplets(f["senders"], f["receivers"], n + 1, cap)
        f.update(trip_kj=kj, trip_ji=ji)
    return f


def molecules(torch, dev):
    """12c: SchNet, NequIP and DimeNet at full width on the molecule
    shape, the card against the CPU; NequIP's energy under a rotation."""
    from repro_torch import carry, configs
    from repro_torch.models.common import init_params, param_count
    from repro_torch.models.gnn import dimenet, nequip, schnet

    shape = configs.get("schnet").shape("molecule").params
    rng = np.random.default_rng(DATA_SEED)
    for arch, mod in (("schnet", schnet), ("nequip", nequip),
                      ("dimenet", dimenet)):
        cfg = configs.get(arch).config
        fields = molecule_fields(rng, shape["batch"], shape["n_nodes"],
                                 shape["n_edges"], arch == "dimenet")
        gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
        params = init_params(mod.build_specs(cfg), gen, device=dev)
        batch = carry.graph_batch_from(fields, device=dev)
        card, ms, peak = timed_forward(
            torch, lambda: mod.forward(params, batch, cfg))
        cpu = mod.forward(to_cpu(params),
                          carry.graph_batch_from(fields, device="cpu"), cfg)
        tol = MODEL_TOL[arch]
        err = held(torch, f"{arch} molecule", card, cpu, tol)
        trip = (f", {int((fields['trip_kj'] < fields['senders'].size).sum())}"
                f" triplets (padded to {fields['trip_kj'].size})"
                if arch == "dimenet" else "")
        say(f"  12c {arch} CONFIG ({param_count(mod.build_specs(cfg))} "
            f"parameters) on {shape['batch']} molecules of "
            f"{shape['n_nodes']} atoms, {fields['senders'].size} arcs{trip}:"
            f" forward {ms:.3f} ms, peak device memory {peak} B; card "
            f"equals the CPU within {tol} (max abs difference {err:.3e})")
        if arch == "nequip":
            from scipy.spatial.transform import Rotation
            R = torch.as_tensor(Rotation.random(random_state=7).as_matrix(),
                                dtype=torch.float32, device=dev)
            rotated = dataclasses.replace(batch,
                                          positions=batch.positions @ R.T)
            err = held(torch, "nequip under a rotation",
                       mod.forward(params, rotated, cfg), card, tol)
            say(f"  12c nequip: energies invariant under a random rotation "
                f"on the card within {tol} (max abs difference {err:.3e})")


def remapped_tables(torch, tables, sparse):
    """The rows of ``tables`` that ``sparse`` reads, on the CPU, and
    ``sparse`` renumbered into them: (small tables, indices)."""
    n_tab = tables.shape[0]
    uniq = [torch.unique(sparse[:, t]) for t in range(n_tab)]
    width = max(u.numel() for u in uniq)
    small = torch.zeros((n_tab, width, tables.shape[2]),
                        dtype=tables.dtype)
    idx = torch.empty_like(sparse, device="cpu")
    for t, u in enumerate(uniq):
        small[t, :u.numel()] = tables[t, u.long()].cpu()
        idx[:, t] = torch.searchsorted(u, sparse[:, t].contiguous()).cpu()
    return small, idx


def dlrm_phase(torch, dev):
    """12d. Returns the serve_bulk batch's sparse indices (numpy)."""
    from repro_torch import configs
    from repro_torch.models import dlrm
    from repro_torch.models.common import init_params, param_count

    entry = configs.get("dlrm-rm2")
    cfg = entry.config
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(dlrm.build_specs(cfg), gen, device=dev)
    say(f"  12d dlrm-rm2 CONFIG: {param_count(dlrm.build_specs(cfg))} "
        f"parameters, tables {tuple(params['tables'].shape)} fp32 "
        f"({params['tables'].numel() * 4} B on the card)")

    def batch(B):
        return {"dense": torch.randn((B, cfg.n_dense), generator=gen,
                                     device=dev),
                "sparse": torch.randint(0, cfg.vocab_per_table,
                                        (B, cfg.n_sparse, cfg.bag_size),
                                        generator=gen, device=dev,
                                        dtype=torch.int32)}
    small_params = {k: v.cpu() for k, v in params.items() if k != "tables"}
    for name in ("serve_p99", "serve_bulk"):
        B = entry.shape(name).params["batch"]
        b = batch(B)
        out, ms, peak = timed_forward(
            torch, lambda: dlrm.forward(params, b, cfg))
        check(out.shape == (B,) and bool(torch.isfinite(out).all()),
              f"dlrm {name}: logits of shape {tuple(out.shape)} or not "
              "finite")
        line = (f"  12d dlrm-rm2 {name} (B={B}): forward {ms:.3f} ms, peak "
                f"device memory {peak} B")
        if name == "serve_p99":
            tabs, idx = remapped_tables(torch, params["tables"], b["sparse"])
            cpu = dlrm.forward(
                dict(small_params, tables=tabs),
                {"dense": b["dense"].cpu(), "sparse": idx},
                dataclasses.replace(cfg, vocab_per_table=tabs.shape[1]))
            err = held(torch, "dlrm serve_p99", out, cpu,
                       MODEL_TOL["dlrm-rm2"])
            line += (f"; card equals the CPU over the {tabs.shape[1]}-row "
                     f"tables it reads within {MODEL_TOL['dlrm-rm2']} (max "
                     f"abs difference {err:.3e})")
        say(line)
    bulk = b["sparse"].cpu().numpy()
    shape = entry.shape("retrieval_cand").params
    q = batch(1)
    q["candidates"] = torch.randn((shape["n_candidates"], cfg.embed_dim),
                                  generator=gen, device=dev)
    (vals, ids), ms, peak = timed_forward(
        torch, lambda: dlrm.retrieval_score(params, q, cfg))
    tabs, idx = remapped_tables(torch, params["tables"], q["sparse"])
    cvals, cids = dlrm.retrieval_score(
        dict(small_params, tables=tabs),
        {"dense": q["dense"].cpu(), "sparse": idx,
         "candidates": q["candidates"].cpu()},
        dataclasses.replace(cfg, vocab_per_table=tabs.shape[1]))
    tol = MODEL_TOL["dlrm-rm2"]
    err = held(torch, "dlrm retrieval top-k scores", vals, cvals, tol)
    # ids agree except where the CPU's scores tie within the tolerance
    v = cvals.double().numpy()
    gap = np.minimum(np.abs(np.diff(v, prepend=np.inf)),
                     np.abs(np.diff(v, append=-np.inf)))
    differ = ids.cpu().numpy() != cids.numpy()
    check(not (differ & (gap > 2 * tol * (1 + np.abs(v)))).any(),
          "dlrm retrieval: top-k ids differ where the scores do not tie")
    say(f"  12d dlrm-rm2 retrieval_cand ({shape['n_candidates']} "
        f"candidates, top 100): {ms:.3f} ms, peak device memory {peak} B; "
        f"scores equal the CPU's within {tol} (max abs difference "
        f"{err:.3e}), ids equal but for {int(differ.sum())} near-ties")
    del params, q
    return bulk


def router_samples(torch, experts, k, tokens, dev):
    """Synthetic top-k routing: each token prefers one of 4 expert groups
    (shuffled ids), k distinct experts by a Gumbel top-k over biased
    logits."""
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    group = torch.randint(0, 4, (tokens,), generator=gen, device=dev)
    shuffle = torch.randperm(experts, generator=gen, device=dev)
    member = (shuffle[None, :] * 4 // experts) == group[:, None]
    u = torch.rand((tokens, experts), generator=gen, device=dev)
    logits = -torch.log(-torch.log(u.clamp_min(1e-20))) + 2.0 * member
    return torch.topk(logits, k, dim=1).indices.cpu().numpy()


def other_placements(torch, sparse, dev):
    """12e: DLRM tables on 4 shards, MoE experts on 4 pods."""
    from repro_torch import configs
    from repro_torch.core import metrics
    from repro_torch.placement import dlrm_placement, moe_placement

    cfg = configs.get("dlrm-rm2").config
    rows = np.full(cfg.n_sparse, cfg.vocab_per_table)
    t0 = time.perf_counter()
    out = dlrm_placement.plan(sparse, rows, DLRM_SHARDS, device=dev)
    wall = time.perf_counter() - t0
    check(out["feasible"] and out["assignment"].shape == (cfg.n_sparse,),
          f"dlrm placement infeasible: {out}")
    say(f"  12e dlrm_placement.plan (serve_bulk's {sparse.shape[0]} x "
        f"{sparse.shape[1]} lookups, {DLRM_SHARDS} shards): {wall:.3f} s, "
        f"cut {out['cut']}, imbalance {out['imbalance']:.4f}, tables per "
        f"shard {np.bincount(out['assignment'], minlength=DLRM_SHARDS)}")
    for arch, experts, k, tokens in MOE_ROUTING:
        samples = router_samples(torch, experts, k, tokens, dev)
        t0 = time.perf_counter()
        out = moe_placement.plan(samples, experts, MOE_PODS, device=dev)
        wall = time.perf_counter() - t0
        g = moe_placement.coactivation_graph(samples, experts)
        check(metrics.is_feasible(g, out["assignment"], MOE_PODS, 0.01)
              and out["cross_pod_fraction"]
              <= out["naive_cross_pod_fraction"],
              f"moe placement {arch}: infeasible or worse than the naive "
              f"split: {out}")
        say(f"  12e moe_placement.plan ({arch}: {experts} experts, top-{k}, "
            f"{tokens} tokens, {MOE_PODS} pods): {wall:.3f} s, cross-pod "
            f"fraction {out['cross_pod_fraction']:.4f} against "
            f"{out['naive_cross_pod_fraction']:.4f} naive, experts per pod "
            f"{out['experts_per_pod']}")


def shuffled(g0):
    """12a's input: phase 4's graph with its ids shuffled."""
    from repro_torch.graphs.format import permute
    return permute(g0, np.random.default_rng(0).permutation(g0.n))[0]


def phase_models(torch, api, build, g0, dev=None):
    """Phase 12 on ``dev`` (card 0). Returns the placement's launches,
    its input graph and the placement (phase 14 trains on it)."""
    t_phase = time.perf_counter()
    dev = dev or torch.device("cuda", 0)
    say("== phase 12: the placement engine and the models it places "
        "(full CONFIGs, forward only)")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "phase 12: TF32 matmuls are on")
    g = shuffled(g0)
    plan, launches = place_gnn(torch, build, g, dev)
    gat_on_placement(torch, g, plan, dev)
    molecules(torch, dev)
    sparse = dlrm_phase(torch, dev)
    other_placements(torch, sparse, dev)
    torch.cuda.empty_cache()
    say(f"  phase 12 {time.perf_counter() - t_phase:.1f} s")
    return launches, g, plan


# ---------------------------------------------------------------------------
# phase 13: the decoder-only LMs (forward only)
# ---------------------------------------------------------------------------

# arch, layers (None: the CONFIG's), prefill (B, S), decode (B, steps,
# cache positions). qwen2-7b's prefill_32k is cut from 32 x 32768 (319 GB
# of bf16 logits) to 1 x 8192 and its decode_32k from B=128 (a 240 GB
# cache) to 8; the others prefill 1 x 2048 and decode at B=8 from a 4096
# cache; arctic keeps its width at 2 of its 35 layers (953.7 GB)
LM_RUNS = (
    ("qwen2-7b", None, (1, 8192), (8, 32, 32768)),
    ("gemma-2b", None, (1, 2048), (8, 16, 4096)),
    ("stablelm-12b", None, (1, 2048), (8, 16, 4096)),
    ("granite-moe-1b-a400m", None, (1, 2048), (8, 16, 4096)),
    ("arctic-480b", 2, (1, 2048), (8, 16, 4096)),
)
# bf16 logits against the same model's float32 ones: relative Frobenius
# error at most 16 bf16 ulps (2^-8 each). Each layer adds some 16 bf16
# roundings of relative error <= 2^-9 (projections, rope, probabilities,
# activations, residual adds) that add up like a random walk; at reduced
# widths (d 256-512) the port measured 0.010-0.021 dense at 2-24 layers.
# MoE positions whose top-k choice flips between the two (a near-tie of
# gates), or whose choice a flip moved across the capacity cut, are left
# out of the comparison and counted
LM_BF16_FRO = 2.0 ** -4
LM_F32_TOL = 2e-4          # decode equals forward (tests/test_arch_smoke.py)
LM_F32_POSITIONS = 16
LM_SMOKE_TOL = 1e-4        # the card against the CPU, SMOKE configs
LM_SMOKE_STEPS = 8
# the serving CLI on the card: qwen2-7b's full CONFIG
LM_CLI = ["--arch", "qwen2-7b", "--config", "full", "--batch", "4",
          "--prompt-len", "12", "--gen-len", "20", "--max-len", "64"]
LM_MATRICES = ("wq", "wk", "wv", "wo", "w_in", "w_out", "router", "e_in",
               "e_out")


def lm_params(torch, T, cfg, dev):
    """Random weights for ``cfg`` from ``DATA_SEED``: the port's
    ``init_params``, with each stacked layer matrix rescaled to 1/sqrt
    of its own contraction width. The reference's init takes a leaf's
    first axis as its fan-in, which for the stacked layer weights is the
    layer count: at qwen2-7b's 28 layers a std of 0.19 where a
    unit-preserving one is 1/sqrt(3584) = 0.017, attention scores of std
    ~120 and a softmax that is a hard argmax, on which bf16 and float32
    pick different keys."""
    from repro_torch.models.common import init_params

    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    params = init_params(T.build_specs(cfg), gen, device=dev)
    for name in LM_MATRICES:
        w = params["layers"].get(name)
        if w is None:
            continue
        fan = {"wo": w.shape[1] * w.shape[2], "e_in": w.shape[2],
               "e_out": w.shape[2]}.get(name, w.shape[1])
        w.mul_(math.sqrt(cfg.n_layers / fan))
    return params


def routed(T, fn):
    """``fn()`` with every ``routing_plan`` call's choices recorded: per
    layer the (G, Tg*k) expert ids and whether each choice was dropped
    at the capacity cut. Returns (output, [(ids, dropped)])."""
    calls = []
    plan = T.routing_plan

    def record(eid, *args):
        src_tok, slot_of = plan(eid, *args)
        calls.append((eid.clone(), slot_of >= src_tok.shape[1]))
        return src_tok, slot_of
    T.routing_plan = record
    try:
        return fn(), calls
    finally:
        T.routing_plan = plan


def same_routing(torch, cfg, a, b, shape):
    """(B, S) mask of the tokens whose experts, and which of them the
    capacity cut dropped, are the same in every layer of the two
    recorded runs (a flip moves other tokens of the expert across the
    cut too)."""
    keep = torch.ones(shape, dtype=torch.bool, device=a[0][0].device)

    def choices(eid, dropped):
        eid, order = torch.sort(eid.reshape(-1, cfg.top_k), dim=1)
        return eid, torch.gather(dropped.reshape(-1, cfg.top_k), 1, order)
    for (xe, xd), (ye, yd) in zip(a, b):
        (xe, xd), (ye, yd) = choices(xe, xd), choices(ye, yd)
        keep &= ((xe == ye) & (xd == yd)).all(dim=1).reshape(shape)
    return keep


def bf16_against_f32(torch, T, params, cfg, toks):
    """The bf16 forward against the float32 one of the same weights:
    (relative Frobenius error, max error over max |f32|, share of
    positions whose argmax agrees, share left out for a flipped MoE
    routing) over the vocab's columns."""
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    (lo, _), ra = routed(T, lambda: T.forward(params, toks, cfg))
    (hi, _), rb = routed(T, lambda: T.forward(params, toks, f32))
    lo, hi = lo[..., :cfg.vocab].float(), hi[..., :cfg.vocab]
    keep = same_routing(torch, cfg, ra, rb, toks.shape) if cfg.moe else \
        torch.ones(toks.shape, dtype=torch.bool, device=toks.device)
    d = lo[keep] - hi[keep]
    fro = float(d.norm() / hi[keep].norm())
    mx = float(d.abs().max() / hi[keep].abs().max())
    agree = float((lo.argmax(-1) == hi.argmax(-1)).float().mean())
    return fro, mx, agree, 1.0 - float(keep.float().mean())


def decode_equals_forward(torch, T, params, cfg, dev):
    """Float32 decode over ``LM_F32_POSITIONS`` positions against the
    float32 forward of the same tokens; the largest difference."""
    from repro_torch.models.common import tree_map_specs

    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED + 2)
    P = LM_F32_POSITIONS
    toks = torch.randint(0, cfg.vocab, (2, P), generator=gen, device=dev)
    full, _ = T.forward(params, toks, f32)
    cache = tree_map_specs(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
        T.cache_specs(f32, 2, P))
    err = 0.0
    for t in range(P):
        lens = torch.full((2,), t, dtype=torch.int64, device=dev)
        lg, _ = T.decode_step(params, cache, toks[:, t], lens, f32)
        err = max(err, held(torch, f"{cfg.name} decode at position {t}",
                            lg[:, :cfg.vocab], full[:, t, :cfg.vocab],
                            LM_F32_TOL))
    return err


def lm_decode(torch, T, params, cfg, dev, B, steps, max_len):
    """``steps`` greedy ``decode_step``s at batch ``B`` from a cache of
    ``max_len`` positions whose first ``max_len - steps`` hold random
    K/V (the context). Returns (ms a step, tokens, peak bytes)."""
    from repro_torch.models.common import tree_map_specs

    gen = torch.Generator(device=dev).manual_seed(DATA_SEED + 1)
    cache = tree_map_specs(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
        T.cache_specs(cfg, B, max_len))
    start = max_len - steps
    for n in ("k", "v"):
        for li in range(cfg.n_layers):
            cache[n][li, :, :start].normal_(generator=gen)
    tok = torch.randint(1, cfg.vocab, (B,), generator=gen, device=dev)
    out = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for t in range(steps):
        lens = torch.full((B,), start + t, dtype=torch.int64, device=dev)
        logits, _ = T.decode_step(params, cache, tok, lens, cfg)
        tok = torch.argmax(logits[:, :cfg.vocab], dim=-1)
        out.append(tok)
    e1.record()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits[:, :cfg.vocab]).all()),
          f"{cfg.name} decode: logits not finite")
    written = cache["k"][:, :, start:].abs().amax(dim=(0, 3, 4)) > 0
    check(bool(written.all()), f"{cfg.name} decode: a step wrote no K")
    return (e0.elapsed_time(e1) / steps, torch.stack(out, 1).cpu(),
            torch.cuda.max_memory_allocated())


def lm_full(torch, arch, layers, prefill, decode, dev, failures):
    """13a-c: one LM at full width; returns its numbers."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.models.common import param_count

    entry = configs.get(arch)
    cfg = entry.config
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm_params(torch, T, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = param_count(T.build_specs(cfg))
    size = sum(v.numel() * v.element_size() for v in
               [params["embed"], params["ln_f"], params.get("head")]
               + list(params["layers"].values()) if v is not None)
    cut = "" if layers is None else \
        f", cut to {layers} of {entry.config.n_layers} layers"
    say(f"  13 {arch} CONFIG{cut}: {n} parameters, {size} B "
        f"({str(cfg.param_dtype).split('.')[-1]}) drawn in {init_s:.2f} s")
    B, S = prefill
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED + 3)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    logits, ms, peak = timed_forward(
        torch, lambda: T.forward(params, toks, cfg)[0], reps=1)
    check(tuple(logits.shape) == (B, S, cfg.vocab_pad)
          and logits.dtype == cfg.compute_dtype
          and bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          f"{arch} prefill: logits of shape {tuple(logits.shape)}, "
          f"{logits.dtype} or not finite")
    pad = torch.tensor(-1e30).to(cfg.compute_dtype)
    check(bool((logits[..., cfg.vocab:] == pad.to(dev)).all()),
          f"{arch} prefill: padded logit columns are not -1e30")
    del logits
    row = {"arch": arch, "layers": cfg.n_layers, "params": n, "bytes": size,
           "init_s": init_s, "prefill": [B, S], "prefill_ms": ms,
           "prefill_tok_s": B * S / ms * 1e3, "prefill_peak": peak}
    say(f"  13 {arch} prefill B={B} x S={S} (bf16): {ms:.3f} ms "
        f"({row['prefill_tok_s']:.0f} tok/s), peak device memory {peak} B")
    # the float32 comparison at full depth, and for the MoE archs at 1
    # layer too, where few routings flip (views into layer 0); arctic's
    # at 1 layer only, where the experts' float32 casts fit beside the
    # weights
    depths = [1] if arch == "arctic-480b" else \
        [cfg.n_layers] + ([1] if cfg.moe else [])
    row["bf16_against_f32"] = []
    for depth in depths:
        fro, mx, agree, flipped = bf16_against_f32(
            torch, T, dict(params, layers={k: v[:depth] for k, v in
                                           params["layers"].items()}),
            dataclasses.replace(cfg, n_layers=depth), toks)
        row["bf16_against_f32"].append(
            {"layers": depth, "fro": fro, "max": mx, "argmax_agree": agree,
             "routing_flipped": flipped})
        say(f"  13 {arch} bf16 against float32 ({depth} layers, same "
            f"weights and tokens): relative Frobenius error {fro:.5f} "
            f"(limit {LM_BF16_FRO}), max error / max |f32| {mx:.5f}, "
            f"argmax agrees at {agree:.4f} of positions"
            + (f", {flipped:.4f} of positions left out for a flipped "
               "routing" if cfg.moe else ""))
        if not fro <= LM_BF16_FRO:
            failures.append(f"{arch}: bf16 against float32 relative error "
                            f"{fro} at {depth} layers beyond {LM_BF16_FRO}")
    Bd, steps, max_len = decode
    step_ms, gen_ids, dpeak = lm_decode(torch, T, params, cfg, dev, Bd,
                                        steps, max_len)
    row.update(decode=[Bd, steps, max_len], decode_step_ms=step_ms,
               decode_tok_s=Bd / step_ms * 1e3, decode_peak=dpeak)
    say(f"  13 {arch} decode B={Bd}, {steps} greedy steps at positions "
        f"{max_len - steps}..{max_len - 1} of a {max_len} cache (bf16): "
        f"{step_ms:.3f} ms a step ({row['decode_tok_s']:.0f} tok/s), "
        f"peak device memory {dpeak} B; first request's ids "
        f"{gen_ids[0].tolist()}")
    if not cfg.moe:
        err = decode_equals_forward(torch, T, params, cfg, dev)
        row["decode_vs_forward_f32"] = err
        say(f"  13 {arch} float32 decode over {LM_F32_POSITIONS} positions "
            f"equals the float32 forward within {LM_F32_TOL} (max abs "
            f"difference {err:.3e})")
    del params
    torch.cuda.empty_cache()
    return row


def lm_smoke_on_card(torch, dev):
    """13d: every SMOKE config, float32 compute, the card against the
    CPU in this process: forward logits and aux, and 8 decode steps."""
    from repro_torch import carry, configs
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_map_specs

    for arch in carry.LM_ARCHS:
        cfg = dataclasses.replace(configs.get(arch).smoke_config,
                                  compute_dtype=torch.float32)
        params = lm_params(torch, T, cfg, dev)
        host = {k: (to_cpu(v) if isinstance(v, dict) else v.cpu())
                for k, v in params.items()}
        gen = torch.Generator().manual_seed(DATA_SEED)
        toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
        card, aux = T.forward(params, toks.to(dev), cfg)
        cpu, caux = T.forward(host, toks, cfg)
        err = held(torch, f"{arch} smoke forward", card, cpu, LM_SMOKE_TOL)
        held(torch, f"{arch} smoke aux", aux, caux, LM_SMOKE_TOL)

        def zeros(d):
            return tree_map_specs(
                lambda s: torch.zeros(s.shape, dtype=s.dtype, device=d),
                T.cache_specs(cfg, 2, LM_SMOKE_STEPS))
        cc, hc = zeros(dev), zeros("cpu")
        for t in range(LM_SMOKE_STEPS):
            lens = torch.full((2,), t, dtype=torch.int64)
            a, _ = T.decode_step(params, cc, toks[:, t].to(dev),
                                 lens.to(dev), cfg)
            b, _ = T.decode_step(host, hc, toks[:, t], lens, cfg)
            err = max(err, held(torch, f"{arch} smoke decode step {t}", a,
                                b, LM_SMOKE_TOL))
        say(f"  13d {arch} SMOKE (float32): the card equals the CPU within "
            f"{LM_SMOKE_TOL} over the forward, aux and {LM_SMOKE_STEPS} "
            f"decode steps (max abs difference {err:.3e})")


def lm_cli():
    """13e: the serving CLI at qwen2-7b's full CONFIG, in its own
    process on the card; its JSON summary."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_lm"]
                         + LM_CLI, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in out.stdout.splitlines():
        say(f"  13e | {line}")
    check(out.returncode == 0, f"serve_lm exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    summary = json.loads(out.stdout.splitlines()[-1])
    check(summary["ok"] and summary["device"] != "cpu",
          f"serve_lm: {summary}")
    say(f"  13e python -m repro_torch.launch.serve_lm {' '.join(LM_CLI)}: "
        f"exit 0 in {wall:.1f} s (process start and weights included)")
    return summary


def phase_lm(torch, build, dev=None):
    """Phase 13 on ``dev`` (card 0): the LMs' serving path. Returns the
    kernel launches of the phase (all 0: the path runs none of them)."""
    t_phase = time.perf_counter()
    dev = dev or torch.device("cuda", 0)
    say("== phase 13: the decoder-only LMs (full CONFIG widths, forward "
        "only)")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "phase 13: TF32 matmuls are on")
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    say(f"  13 free device memory at the start: {free} of {total} B")
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    # bf16 products accumulate in float32, as the reference's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    build.reset_launches()
    failures, rows = [], []
    try:
        for run in LM_RUNS:
            rows.append(lm_full(torch, *run, dev, failures))
        lm_smoke_on_card(torch, dev)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    say("  13 launches " + json.dumps(launches))
    check(not any(launches.values()),
          f"phase 13: the LM path launched a partitioner kernel: {launches}")
    torch.cuda.empty_cache()
    rows.append({"cli": lm_cli()})
    say("  13 record " + json.dumps(rows))
    check(not failures, "phase 13: " + "; ".join(failures))
    say(f"  phase 13 {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 14: training on the card
# ---------------------------------------------------------------------------

# 14a: the example's optimizer (AdamW, lr 3e-3) and steps on the placement
TRAIN_GAT_STEPS = 20
TRAIN_GAT_LR = 3e-3
# 14b-c: tag, arch, optimizer, (B, S), steps; one lm_batch repeated, at
# a tenth of OptConfig's lr: a first AdamW (or Adafactor) step moves each
# weight by about lr x sign(g), which moves a 2048-wide contraction's
# output by up to lr x 2048 of its scale. At the default 3e-4 gemma-2b's
# loss went 10.65 -> 9.05 in the first step, then back up to 12.47 by
# the fourth (an H100); five steps at 3e-5 move half as far as that
# first step
TRAIN_LM_LR = 3e-5
TRAIN_LM_RUNS = (
    ("14b", "gemma-2b", "adamw", (2, 1024), 5),
    ("14c", "granite-moe-1b-a400m", "adafactor", (4, 512), 5),
)
TRAIN_REMAT_LAYERS = 2
# gradients with remat on and off: the same ops, recomputed, within this
# share of each leaf's largest |gradient|
TRAIN_REMAT_SHARE = 1e-6
# 14d: the CPU tests' tolerances (tests/test_torch_train_models.py):
# gradients (here the first moment m = 0.1 g) as a share of each leaf's
# largest value; the LMs' losses relative; the card sums the GNNs' and
# DLRM's scatters and einsums in another order than the CPU, so their
# losses are held at their forward tolerances (MODEL_TOL; NequIP's
# differed by 1.2e-6 relative on an H100)
TRAIN_LOSS_REL = 1e-6
TRAIN_LM_SHARE = 1e-3
TRAIN_MODEL_TOL = 1e-4
TRAIN_SMOKE_ARCHS = ("qwen2-7b", "gemma-2b", "stablelm-12b",
                     "granite-moe-1b-a400m", "arctic-480b", "gat-cora",
                     "schnet", "nequip", "dimenet", "dlrm-rm2")
# 14e: the training CLI twice on one checkpoint directory (the second run
# resumes at step 20), then the partitioned-GAT example
TRAIN_CLI = ["--arch", "gemma-2b", "--ckpt-every", "10"]


def timed_steps(torch, step, state, batch, steps):
    """``steps`` donated train steps; (state, losses, grad norms, ms a
    step by CUDA events, peak device bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms = [], [], []
    for _ in range(steps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, met = step(state, batch, donate=True)
        e1.record()
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        ms.append(e0.elapsed_time(e1))
    return state, losses, norms, ms, torch.cuda.max_memory_allocated()


def falls(what, losses):
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{what}: the loss is not finite or did not fall: {losses}")


def train_gat_on_placement(torch, g, plan, launches, dev):
    """14a: GAT at its full CONFIG trained on 12a's placed graph; its
    first step equals the same step on the input graph read through
    ``perm``."""
    from repro_torch import configs
    from repro_torch.models.common import init_params, param_count
    from repro_torch.models.gnn import gat
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import make_train_step
    from repro_torch.train.tree import tree_map

    cfg = configs.get("gat-cora").config
    n, N = g.n, g.n + 1
    gen = torch.Generator(device=dev).manual_seed(DATA_SEED)
    params = init_params(gat.build_specs(cfg), gen, device=dev)
    perm = torch.as_tensor(plan.perm, device=dev)
    # the example's labels: the community (n_classes ranges) of each
    # placed id; a vertex of the input keeps its placed id's label
    lab_pl = torch.zeros(N, dtype=torch.int64, device=dev)
    lab_pl[:n] = torch.arange(n, device=dev) * cfg.n_classes // n
    lab_in = torch.zeros_like(lab_pl)
    lab_in[:n] = lab_pl[perm]
    mask = torch.arange(N, device=dev) < n
    feat = torch.randn((N, cfg.d_in), generator=gen, device=dev)

    def batch(gr, x, lab):
        return GraphBatch(
            senders=torch.as_tensor(gr.arc_tails().astype(np.int32),
                                    device=dev),
            receivers=torch.as_tensor(gr.adjncy.astype(np.int32),
                                      device=dev),
            n_node=N, node_feat=x, labels=lab, node_mask=mask)
    init, step = make_train_step(lambda p, b: gat.loss_fn(p, b, cfg),
                                 OptConfig(lr=TRAIN_GAT_LR))
    _, m_in = step(init(tree_map(torch.clone, params)),
                   batch(g, feat, lab_in), donate=True)
    feat_pl = torch.empty_like(feat)
    feat_pl[perm] = feat[:n]
    feat_pl[n] = feat[n]
    del feat
    _, losses, norms, ms, peak = timed_steps(
        torch, step, init(params), batch(plan.graph, feat_pl, lab_pl),
        TRAIN_GAT_STEPS)
    tol = MODEL_TOL["gat-cora"]
    l_in, n_in = float(m_in["loss"]), float(m_in["grad_norm"])
    check(abs(losses[0] - l_in) <= tol * l_in
          and abs(norms[0] - n_in) <= tol * n_in,
          f"14a: the first step on the placement (loss {losses[0]}, grad "
          f"norm {norms[0]}) differs from the input's through perm (loss "
          f"{l_in}, grad norm {n_in}) beyond {tol} relative")
    falls("14a gat on the placement", losses)
    step_ms = float(np.median(ms[1:]))
    say(f"  14a gat-cora CONFIG ({param_count(gat.build_specs(cfg))} "
        f"parameters, d_in {cfg.d_in}, {cfg.n_heads} heads) on 12a's "
        f"placed rgg2d {n} ({g.m} arcs), AdamW lr {TRAIN_GAT_LR}, "
        f"{TRAIN_GAT_STEPS} steps on the repeated batch: loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; step {step_ms:.3f} ms "
        f"(median after the first; first {ms[0]:.3f}), "
        f"{N / step_ms * 1e3:.0f} nodes/s, peak device memory {peak} B; "
        "placement launches "
        + json.dumps({k: launches[k] for k in MAIN_PATH}))
    say(f"  14a first step equals the input graph's through perm within "
        f"{tol}: loss {losses[0]:.7f} / {l_in:.7f}, grad norm "
        f"{norms[0]:.7f} / {n_in:.7f}")
    return {"arch": "gat-cora", "steps": TRAIN_GAT_STEPS, "loss": losses,
            "step_ms": ms, "nodes_per_s": N / step_ms * 1e3, "peak": peak}


def lm_train_batch(torch, cfg, B, S, dev):
    from repro_torch.train import data
    return {"tokens": torch.as_tensor(
        data.lm_batch(0, B, S, cfg.vocab, DATA_SEED)["tokens"], device=dev)}


def grads_share(got, want):
    """The largest share, over leaves, of |got - want| in the leaf's
    largest |want|."""
    from repro_torch.train.tree import leaves
    return max(float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(leaves(got), leaves(want)))


def remat_check(torch, T, dev):
    """14b: gemma-2b's CONFIG at 2 layers: gradients with remat on and
    off, and the peak memory of each."""
    from repro_torch import configs
    from repro_torch.train.trainer import value_and_grad

    base = dataclasses.replace(configs.get("gemma-2b").config,
                               n_layers=TRAIN_REMAT_LAYERS)
    params = lm_params(torch, T, base, dev)
    batch = lm_train_batch(torch, base, *TRAIN_LM_RUNS[0][3], dev)
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_bytes = torch.cuda.memory_allocated()
        loss, grads = value_and_grad(lambda p, b: T.loss_fn(p, b, cfg),
                                     params, batch)
        torch.cuda.synchronize()
        out[remat] = (float(loss), grads,
                      torch.cuda.max_memory_allocated() - held_bytes)
    share = grads_share(out[True][1], out[False][1])
    say(f"  14b gemma-2b CONFIG at {TRAIN_REMAT_LAYERS} layers, B x S = "
        f"{batch['tokens'].shape[0]} x {batch['tokens'].shape[1]}: loss "
        f"{out[True][0]:.6f} (remat on) / {out[False][0]:.6f} (off); "
        f"gradients differ by at most {share:.3e} of a leaf's largest "
        f"(limit {TRAIN_REMAT_SHARE}); peak above the weights "
        f"{out[True][2]} B with remat, {out[False][2]} B without")
    check(share <= TRAIN_REMAT_SHARE and out[True][0] == out[False][0],
          f"14b: remat changed the loss or the gradients ({share})")
    check(out[True][2] < out[False][2],
          f"14b: remat did not lower the peak memory ({out[True][2]} B "
          f"against {out[False][2]} B)")
    return {"remat_share": share, "peak_remat": out[True][2],
            "peak_no_remat": out[False][2]}


def train_lm(torch, T, tag, arch, opt, shape, steps, dev):
    """14b-c: one LM at its full CONFIG trained ``steps`` steps on one
    repeated ``lm_batch``."""
    from repro_torch import configs
    from repro_torch.models.common import param_count
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import make_train_step, value_and_grad
    from repro_torch.train.tree import leaves

    cfg = configs.get(arch).config
    B, S = shape
    n = param_count(T.build_specs(cfg))
    free = torch.cuda.mem_get_info(dev)[0]
    say(f"  {tag} {arch} CONFIG: {n} parameters; float32 weights, gradients "
        f"and {opt} state {n * 4 * (4 if opt == 'adamw' else 2)} B at most "
        f"against {free} B free")
    params = lm_params(torch, T, cfg, dev)
    batch = lm_train_batch(torch, cfg, B, S, dev)
    row = {"arch": arch, "optimizer": opt, "batch": [B, S],
           "remat": cfg.remat, "params": n}
    if cfg.moe:
        _, grads = value_and_grad(lambda p, b: T.forward(p, b, cfg)[1],
                                  params, batch["tokens"])
        router = float(grads["layers"]["router"].abs().max())
        del grads
        check(router > 0, f"{arch}: the aux loss's gradient on the router "
              "is zero")
        row["aux_router_grad_max"] = router
        say(f"  {tag} {arch}: the aux loss's gradient reaches the router "
            f"(largest |gradient| {router:.3e})")
    init, step = make_train_step(lambda p, b: T.loss_fn(p, b, cfg),
                                 OptConfig(name=opt, lr=TRAIN_LM_LR))
    state = init(params)
    del params
    state_bytes = sum(t.numel() * t.element_size() for t in leaves(state))
    state, losses, _, ms, peak = timed_steps(torch, step, state, batch,
                                             steps)
    falls(f"{tag} {arch}", losses)
    step_ms = float(np.median(ms[1:]))
    row.update(loss=losses, step_ms=ms, state_bytes=state_bytes, peak=peak,
               tokens_per_s=B * S / step_ms * 1e3)
    say(f"  {tag} {arch} CONFIG, {opt} lr {TRAIN_LM_LR}, remat {cfg.remat}, "
        f"B x S = {B} x {S}, "
        f"{steps} steps on one repeated batch: loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; step {step_ms:.1f} ms (median after the first; "
        f"first {ms[0]:.1f}), {row['tokens_per_s']:.0f} tok/s; state "
        f"{state_bytes} B, peak device memory {peak} B")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return row


def smoke_inputs(torch, arch):
    """(params, loss fn, batch) of an arch's SMOKE config on the CPU:
    float32 compute, weights from ``DATA_SEED``, the training CLI's
    batches."""
    from repro_torch import carry, configs
    from repro_torch.launch import train as cli
    from repro_torch.models.common import init_params

    entry = configs.get(arch)
    cfg = entry.smoke_config
    if entry.kind == "lm":
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
        loss, specs, mk = cli.make_lm_pipeline(cfg, 2, 16, DATA_SEED, "cpu")
    elif entry.kind == "recsys":
        loss, specs, mk = cli.make_dlrm_pipeline(cfg, 64, DATA_SEED, "cpu")
    else:
        loss, specs, mk = cli.make_gnn_pipeline(entry, cfg, DATA_SEED, "cpu")
    params = init_params(specs, torch.Generator().manual_seed(DATA_SEED),
                         device="cpu")
    share = TRAIN_LM_SHARE if arch in carry.LM_ARCHS else TRAIN_MODEL_TOL
    return params, loss, mk(0), share


def to_device(torch, batch, dev):
    if isinstance(batch, dict):
        return {k: v.to(dev) for k, v in batch.items()}
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).to(dev)
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)})


def adam_step_held(what, got, want, lr, share):
    """One AdamW step's state, card against CPU: moments and parameters
    (``tests/test_torch_train_models.py``'s rules: m and v as the
    gradients, v at twice the share; a parameter within 1e-6 of its
    leaf's largest |value| where |g| passes ``share`` of the leaf's
    largest, within 2 lr elsewhere: Adam's first step is about lr x
    sign(g)). Returns the moments' largest share of their allowance."""
    from repro_torch.train.tree import leaves_with_paths

    def paths(t):
        return {p: v.detach().cpu().float() for p, v in leaves_with_paths(t)}
    worst = 0.0
    for name, sh in (("m", share), ("v", 2 * share)):
        g, w = paths(got["opt"][name]), paths(want["opt"][name])
        for p in w:
            err = float((g[p] - w[p]).abs().max())
            lim = sh * float(w[p].abs().max())
            worst = max(worst, err / max(lim, 1e-30))
            check(err <= lim + 1e-30, f"{what} {name}/{'/'.join(p)}: "
                  f"{err} beyond {sh} x its largest")
    g, w = paths(got["params"]), paths(want["params"])
    m = paths(want["opt"]["m"])
    for p in w:
        tight = 1e-6 * max(float(w[p].abs().max()), 1.0)
        err = (g[p] - w[p]).abs()
        big = m[p].abs() > share * float(m[p].abs().max())
        check(float(err.masked_fill(~big, 0).max()) <= tight,
              f"{what} params/{'/'.join(p)}: beyond {tight} where |g| is "
              "large")
        check(float(err.max()) <= 2 * lr + tight,
              f"{what} params/{'/'.join(p)}: beyond 2 lr")
    return worst


def smoke_steps_on_card(torch, dev):
    """14d: one float32 AdamW step of every SMOKE config on the card
    against the same step on the CPU from the same state; gemma-2b also
    at microbatches=2."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import make_train_step
    from repro_torch.train.tree import tree_map

    cases = [(a, 1) for a in TRAIN_SMOKE_ARCHS] + [("gemma-2b", 2)]
    for arch, mb in cases:
        params, loss, batch, share = smoke_inputs(torch, arch)
        init, step = make_train_step(loss, OptConfig(), microbatches=mb)
        want, wm = step(init(params), batch)
        got, gm = step(init(tree_map(lambda t: t.to(dev), params)),
                       to_device(torch, batch, dev))
        what = f"14d {arch}" + (f" microbatches={mb}" if mb > 1 else "")
        l_got, l_want = float(gm["loss"]), float(wm["loss"])
        n_got, n_want = float(gm["grad_norm"]), float(wm["grad_norm"])
        rel = MODEL_TOL.get(arch, TRAIN_LOSS_REL)
        check(abs(l_got - l_want) <= rel * abs(l_want)
              and abs(n_got - n_want) <= share * n_want,
              f"{what}: loss {l_got} / {l_want} or grad norm {n_got} / "
              f"{n_want} beyond tolerance")
        worst = adam_step_held(what, got, want, OptConfig().lr, share)
        say(f"  {what} (float32): one AdamW step on the card equals the "
            f"CPU's (loss {l_got:.7f} / {l_want:.7f}, grad norm "
            f"{n_got:.6f} / {n_want:.6f}; moments at {worst:.3f} of their "
            f"allowance, share {share})")


def run_cli(module, args, what):
    """``python -m module args`` in its own process on the card: its
    output lines."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module] + args, cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    for line in out.stdout.splitlines():
        say(f"  {what} | {line}")
    check(out.returncode == 0, f"{module} exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    say(f"  {what} python -m {module} {' '.join(args)}: exit 0 in "
        f"{wall:.1f} s (process start included)")
    return out.stdout.splitlines()


def train_clis():
    """14e: the training CLI resumes from its checkpoints; the example
    trains on its placement."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        first = run_cli("repro_torch.launch.train", TRAIN_CLI + [
            "--steps", "20", "--ckpt-dir", d], "14e")
        again = run_cli("repro_torch.launch.train", TRAIN_CLI + [
            "--steps", "30", "--ckpt-dir", d], "14e")
        check(sorted(os.listdir(d)) == ["step_00000010", "step_00000020",
                                         "step_00000030"],
              f"14e: checkpoints {sorted(os.listdir(d))}")
    steps = [int(x.split()[1]) for x in again if x.startswith("  step")]
    check(first[1].split()[1] == "0" and steps[0] == 20,
          f"14e: the second run did not resume at step 20 ({steps})")
    ex = run_cli("repro_torch.launch.gnn_partitioned_training", [], "14e")
    trail = [float(x) for x in ex[-1].split("loss: ")[1].split(" -> ")]
    falls("14e the example", trail)
    check("on cpu" not in ex[-1], "14e: the example ran on the CPU")
    say("  14e the second run resumed at step 20 from the checkpoint of "
        "the first; the example's loss fell")


def phase_train(torch, build, smi, g, plan, place_launches, dev=None):
    """Phase 14 on ``dev`` (card 0): training. Returns the kernel
    launches of the phase's own process (all 0: training launches none
    of them; the placement it trains on launched ``place_launches``)."""
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    dev = dev or torch.device("cuda", 0)
    say(f"== phase 14: training on the card (forward and backward; {smi})")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "phase 14: TF32 matmuls are on")
    gc.collect()
    torch.cuda.empty_cache()
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    # bf16 products accumulate in float32, as the reference's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    build.reset_launches()
    rows = []
    try:
        rows.append(train_gat_on_placement(torch, g, plan, place_launches,
                                           dev))
        torch.cuda.empty_cache()
        rows.append(remat_check(torch, T, dev))
        gc.collect()
        torch.cuda.empty_cache()
        for run in TRAIN_LM_RUNS:
            rows.append(train_lm(torch, T, *run, dev))
        smoke_steps_on_card(torch, dev)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    say("  14 launches " + json.dumps(launches))
    check(not any(launches.values()),
          f"phase 14: training launched a partitioner kernel: {launches}")
    torch.cuda.empty_cache()
    train_clis()
    say("  14 record " + json.dumps(rows))
    say(f"  phase 14 {time.perf_counter() - t_phase:.1f} s")
    return launches


ANALYSIS_FIXTURES = ("collective", "overflow", "lint", "limits")
ANALYSIS_NOTE = re.compile(
    r"traced (\d+) entries \((\d+) ops taped, (\d+) collectives logged\), "
    r"limits grid (\d+) points and (\d+) boundary points, linted (\d+) "
    r"files")


def phase_analysis(build) -> dict:
    """Phase 15: the verifier on the card, repo and fixtures at once.
    Returns its kernel launches, by kernel."""
    import tempfile

    say("== phase 15: the verifier")
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with tempfile.TemporaryDirectory() as d:
        report = Path(d) / "analysis.json"
        runs = {"repo": ["--json", str(report)]}
        runs.update({fx: ["--fixture", fx] for fx in ANALYSIS_FIXTURES})
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis", "--devices", "1",
             *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for name, extra in runs.items()}
        outs = {}
        try:
            for name, proc in procs.items():
                out, err = proc.communicate(timeout=300)
                outs[name] = (proc.returncode, out, err)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        rc, out, err = outs["repo"]
        for line in out.splitlines():
            say(f"  15 repo | {line}")
        check(rc == 0, f"phase 15: python -m repro_torch.analysis --devices "
              f"1 exited {rc}: {err[-2000:]}")
        data = json.loads(report.read_text())
    check(data["ok"] and not data["findings"],
          f"phase 15: the verifier left findings: {data['findings']}")
    notes = data["notes"]
    m = next(filter(None, (ANALYSIS_NOTE.match(n) for n in notes)), None)
    check(m is not None, f"phase 15: no summary note in {notes}")
    entries, ops, colls, grid, boundary, files = (int(x)
                                                  for x in m.groups())
    check(entries == 19 and ops > 0 and colls > 0,
          f"phase 15: {entries} entries, {ops} ops, {colls} collectives")
    check(not any("LIM001" in n and "not run" in n for n in notes),
          "phase 15: LIM001 did not run on the card")
    check(grid > 0 and boundary > 0,
          f"phase 15: LIM001 {grid} and LIM002 {boundary} points")
    unused = [n for n in out.splitlines() if "allowlist entry unused" in n]
    check(all("src/repro_torch/kernels/" in n for n in unused),
          f"phase 15: allowlist entries unused beyond the plain kernel "
          f"versions: {unused}")
    launches = json.loads(next(n for n in notes if n.startswith(
        "kernel launches "))[len("kernel launches "):])
    for fx in ANALYSIS_FIXTURES:
        rc, out, err = outs[fx]
        tail = out.strip().splitlines()[-1:]
        say(f"  15 --fixture {fx}: exit {rc} {tail}")
        check(rc == 1, f"phase 15: --fixture {fx} exited {rc}, not 1: "
              f"{err[-2000:]}")
    by_kernel = {k: launches.get(k, 0) for k in build.LAUNCHES}
    check(all(by_kernel[k] > 0 for k in MAIN_PATH),
          f"phase 15: a fused entry launched no kernel of the path: "
          f"{launches}")
    say(f"  15 traced {entries} entries, {ops} ops taped, {colls} "
        f"collectives logged, LIM001 held at {grid} grid points against "
        f"the built libraries, LIM002 at {boundary} boundary points, "
        f"linted {files} files, "
        f"{len(unused)} allowlist entries unused on the card")
    say("  15 launches " + json.dumps(by_kernel))
    say(f"  phase 15 {time.perf_counter() - t_phase:.1f} s")
    return by_kernel


def analysis_only(torch, build) -> int:
    """``--analysis-only``: phases 1 and 15."""
    smi = phase_environment(torch, build)
    phase_analysis(build)
    say(smi)
    return 0


def hubs_only(torch, api, build) -> int:
    """``--hubs-only``: phases 1 and 9, both hub graphs at 2^20."""
    smi = phase_environment(torch, build)
    rows, _ = phase_hubs(torch, api, build, HUB_SIZES_FULL)
    say(smi)
    say(json.dumps({"kernels": rows}))
    return 0


def dist_only(torch, api, build) -> int:
    """``--dist-only``: phases 1, 2 and 10."""
    smi = phase_environment(torch, build)
    phase_ragged(torch, torch.device("cuda", 0))
    g = api.GraphSpec("rgg2d", FULL_N, 8.0, seed=17).materialize()
    rows, _, _ = phase_dist(torch, api, build, g)
    say(smi)
    say(json.dumps({"kernels": rows}))
    return 0


def mesh_only(torch, api, build) -> int:
    """``--mesh-only``: phases 1, 10 and 11, with phase 4's request run
    once for phase 11's single request."""
    smi = phase_environment(torch, build)
    g = api.GraphSpec("rgg2d", FULL_N, 8.0, seed=17).materialize()
    lp_run = run_partition(api, g, 16, "fused")
    say(f"  phase 4's request: cut {lp_run.cut}")
    rows, _, walls = phase_dist(torch, api, build, g)
    phase_mesh(torch, api, g, lp_run, *walls)
    say(smi)
    say(json.dumps({"kernels": rows}))
    return 0


def models_only(torch, api, build) -> int:
    """``--models-only``: phases 1 and 12."""
    smi = phase_environment(torch, build)
    g = api.GraphSpec("rgg2d", FULL_N, 8.0, seed=17).materialize()
    phase_models(torch, api, build, g)
    say(smi)
    return 0


def train_only(torch, api, build) -> int:
    """``--train-only``: phases 1, 12a (the placement) and 14."""
    smi = phase_environment(torch, build)
    dev = torch.device("cuda", 0)
    g = shuffled(api.GraphSpec("rgg2d", FULL_N, 8.0, seed=17).materialize())
    plan, launches = place_gnn(torch, build, g, dev)
    phase_train(torch, build, smi, g, plan, launches, dev)
    say(smi)
    return 0


def lm_only(torch, build) -> int:
    """``--lm-only``: phases 1 and 13."""
    smi = phase_environment(torch, build)
    phase_lm(torch, build)
    say(smi)
    return 0


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hubs-only", action="store_true",
                    help="only build the kernels and run phase 9, with "
                         "both hub graphs at 2^20 (no contract line)")
    ap.add_argument("--dist-only", action="store_true",
                    help="only build the kernels and run phases 2 and 10 "
                         "(no contract line)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="only build the kernels and run phases 10 and 11 "
                         "(no contract line)")
    ap.add_argument("--models-only", action="store_true",
                    help="only build the kernels and run phase 12 (no "
                         "contract line)")
    ap.add_argument("--lm-only", action="store_true",
                    help="only build the kernels and run phase 13 (no "
                         "contract line)")
    ap.add_argument("--train-only", action="store_true",
                    help="only build the kernels and run phases 12a (the "
                         "placement) and 14 (no contract line)")
    ap.add_argument("--analysis-only", action="store_true",
                    help="only build the kernels and run phase 15 (no "
                         "contract line)")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check runs only "
              "on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import api
    from repro_torch.core import deep_mgp
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.bal_round import ops as bal_ops
    from repro_torch.kernels.lp_move import ops as lp_ops
    from repro_torch.kernels.seg_merge import ops as seg_ops
    from repro_torch.kernels.seg_merge.ref import key_bits, key_passes

    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port pulled in the JAX package")
    # the plain versions' f32 products (bsr_spmm's einsum) and the
    # models' matmuls in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are still on")
    if args.hubs_only:
        return hubs_only(torch, api, build)
    if args.dist_only:
        return dist_only(torch, api, build)
    if args.mesh_only:
        return mesh_only(torch, api, build)
    if args.models_only:
        return models_only(torch, api, build)
    if args.lm_only:
        return lm_only(torch, build)
    if args.train_only:
        return train_only(torch, api, build)
    if args.analysis_only:
        return analysis_only(torch, build)
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    smi = phase_environment(torch, build)
    phase_ragged(torch, dev)
    phase_anchor(torch, api, deep_mgp)
    capture = Capture(torch)
    candidates = []
    capture.wrap(lp_ops, "lp_move_chunk", "lp_move",
                 after=lambda a, kw: candidates.append(
                     candidate_count(a, kw)))
    seg_calls = []
    capture.wrap(seg_ops, "seg_merge", "seg_merge",
                 after=lambda a, kw: seg_calls.append(
                     (a[0].numel(), key_bits(kw.get("max_id")),
                      key_passes(key_bits(kw.get("max_id"))))))
    capture.wrap(bal_ops, "bal_scores", "bal_scores")
    capture.wrap(bal_ops, "greedy_pick", "greedy_pick")
    try:
        g, launches, lp_run, lp_wall = phase_main_path(
            torch, api, build, candidates, seg_calls)
    finally:
        capture.restore()
    assignment = lp_run.assignment
    kernels = phase_kernels(torch, build, capture, launches, g, assignment,
                            dev)
    kernels += phase_off_main(torch, build, g, assignment, dev)
    by_path, un_run, un_wall = phase_unconstrained(
        torch, api, build, g, lp_run, lp_wall, launches)
    stacked_row, serve_paths = phase_serving(torch, api, build, g, lp_run,
                                             lp_wall, un_run, un_wall,
                                             by_path)
    by_path.update(serve_paths)
    kernels.insert(1, stacked_row)
    hub_rows, hub_paths = phase_hubs(torch, api, build)
    by_path.update(hub_paths)
    kernels[2:2] = hub_rows
    dist_rows, dist_paths, dist_walls = phase_dist(torch, api, build, g)
    by_path.update(dist_paths)
    kernels[4:4] = dist_rows
    by_path["mesh"] = phase_mesh(torch, api, g, lp_run, *dist_walls)
    by_path["placement"], g_placed, plan = phase_models(torch, api, build,
                                                        g)
    by_path["lm"] = phase_lm(torch, build)
    by_path["train"] = phase_train(torch, build, smi, g_placed, plan,
                                   by_path["placement"])
    del g_placed, plan
    by_path["analysis"] = phase_analysis(build)
    for row in kernels:
        if row["name"] in MAIN_PATH + ("lp_move_stacked", "lp_move_heavy",
                                       "bal_scores_heavy") + tuple(
                                           r["name"] for r in dist_rows):
            row["launches_by_path"] = {p: c[row["name"]]
                                       for p, c in by_path.items()}
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port pulled in the JAX package")
    say(f"total {time.perf_counter() - t_all:.1f} s")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
