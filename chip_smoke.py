#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives ``chiaroscuro_tpu_torch`` on the card in these phases; any failure
raises, exits non-zero and prints no result line.

1. Device and build: the card's name and power limit (nvidia-smi), torch's
   device name and count.  The CUDA sources (``csrc/intersect_dense.cu``
   K1/K2, ``csrc/cull_rows.cu`` K3, ``csrc/cull_beam.cu`` K3b (the beam
   cull), ``csrc/intersect_cluster.cu`` K4-K7,
   ``csrc/cull_rowhit.cu`` X1, ``csrc/dma_min.cu`` X2, ``csrc/bvh_traverse.cu``
   B1/B2, ``csrc/threefry.cu`` R1, and the host's ``csrc/bvh_builder.cpp``
   by g++) build in parallel, one compiler each; build seconds, registers,
   shared memory and spills are printed, and K3's, K1/K2's and R1's
   compiled instruction mixes (``cuobjdump -sass``).
2. Dense kernels vs plain: K1/K2 against their plain torch versions at
   Cornell (T = 36) and a seeded random soup (T = 4,096), B0 = 4,608 rows
   (one 768x768 wavefront) with a third of the rows dead: bitwise equal;
   the bounds on both (the tests the kernels' warp-uniform reject leaves,
   ``intersect_cuda.reject_counts``).
2e. The dense pair's own wavefronts: the primary, first-bounce and NEE
   shadow queries (and the bounce's shadow queries) of sample 0 of the
   Cornell 768x768 frame
   (``scenes/cornell.rtc``) and of the ``synthetic:atrium:4000`` 1280x720
   frame (4,040 triangles: the dense path's largest scenes), recorded as
   the integrator makes them.  K1/K2 bitwise equal to their plain versions
   on every row; each timed by CUDA events beside its bound (K2's per lane
   and per warp) and the kernel it replaced on the same rays
   (REPLACED_DENSE_US).
2b. Cluster kernels vs plain at the full atrium (481,208 triangles,
   K = 3,760 clusters of 128): the primary wavefront of the 1280x720
   ``ATRIUM_CAMERA`` frame (B0 = 7,200), one cosine-sampled bounce
   wavefront from its hits and the NEE shadow wavefront, each sorted as the
   integrator sorts it on this path.  K3 must equal its plain version
   exactly on every row (closest and shadow queries): its sweep's hit mask
   and counts equal and keys bitwise, the lists with nears and cutoff
   bitwise; the scene's route, K6/K7, must be bitwise equal to theirs on a
   seeded sample of rows plus every row that overflowed its list.  (On the
   card K4 and K6 launch one kernel, and K5 and K7 one, each counted under
   its own name: each wavefront checks and times its scene's route, and the
   card tests check that each name launches.)  X1 (the row-hit cull of the
   tool path) on every row of the primary wavefront, without tmax and with tmax = each ray's closest hit:
   exactly equal to its plain version and, sliced to K, to K3's hit mask;
   timed beside K3's sweep and the whole K3 cull on the same rays.  K3's
   sweep is also timed on 1 to 4 waves of resident blocks' worth of rows.
   Then K3b, the beam cull, on the primary, bounce and shadow wavefronts
   (``beam_checks``): its lists (one kernel: the sweep and the selection)
   bitwise equal to the plain version's and to those of the two-step it
   replaced (``beam_two_step``: its sweep kernel, held bitwise to the plain
   sweep, then the stable sort), every box K3 hits among its hits (the
   boxes whose beam entry lies above K3's counted); the trips of both
   lists; the route's visit kernel on both, every lane's answer bitwise
   equal, its per-warp visits on the beam lists equal to the replay of the
   exit rule on ROW_SAMPLE seeded rows and 32 seeded overflow rows; K3b's
   whole cull timed in turns with the two-step's (it must be faster) and
   beside K3's, with its bound, its plain version's time and the peak
   memory of one call of each, and the visits on both lists.
2c. The same at Sponza scale (``synthetic:atrium:262144``, 261,396
   triangles, K = 2,043): the same four wavefronts of its 1280x720 frame.
   The same checks on its route, K4/K5; then on every row of
   atrium(2_200, seed=5) at M = 32 with 32-wide lists, most of whose rows
   overflow, with the per-warp visit counts equal to the torch replay of
   the exit rule (``cluster_cuda._visit_walk``).  Then the 19k frame's
   (``synthetic:atrium:19000``, K = 148) primary and shadow wavefronts at
   1024x1024 in pixel order, as the integrator traces them there.  X1 as
   in 2b on every row of the 262k NEE shadow wavefront (with its tmax).
2d. The streaming route's regime: ``synthetic:atrium:3000000`` (2,999,720
   triangles, K = 23,436: a 114.4 MiB (K, 10, M) matrix, over twice the
   card's L2), its 1280x720 primary and NEE shadow wavefronts.  K3 exact on
   every row (the (B0, K) keys are ~675 MB; the peak device memory is
   printed); its route, K6/K7, bitwise equal to the plain versions on
   BIG3M_SAMPLE seeded rows plus at most BIG3M_SAMPLE seeded overflow rows
   (the plain sweep of an overflow row covers all 23k clusters), the visit
   counts equal to the replay on every row; timed on every row.  Its
   bounce wavefront, where the 3M frame spends most of its time, is
   counted (trip, overflow rows, visits a warp) and K6 timed on it
   BOUNCE_3M_TURNS times with the spread, not held to the plain version.
   K3b as in 2b on the primary, bounce and shadow wavefronts, the beam
   visit counts replayed on BIG3M_SAMPLE seeded rows that fit their list
   (an overflow row's replay would sweep up to all 23k clusters).
2f. The sample streams' kernels, R1 (``ops/threefry_cuda.py``), at
   R1_LANES (Cornell's 589,824 and the Sponza frame's 921,600 lanes, in
   rows of 128): the bounce kernel bitwise equal to
   ``prng.bounce_uniforms_plain`` (the int64 operator chain) at R1_BOUNCES
   on seeded random keys with every pair of R1_EXTREMES in the first
   lanes, and the raygen kernel to ``prng.raygen_streams_plain`` for a
   Python-int, a 0-dim and a per-lane sample.  Each timed by CUDA events
   over replays of a captured graph of launches (a launch is ~10 us, below
   the host's dispatch), in turns with the plain chain, beside two bounds:
   the counted one (R1_BOUNCE_OPS / R1_RAYGEN_OPS integer operations a lane
   at the INT32 rate, against the bytes), and the compiled one
   (``straight_line_bound``: the kernel's own SASS instructions a lane on
   the INT32 pipe, IMAD on the FMA pipe, all on the issue slots, against
   the bytes).  ptxas issues part of the integer adds as IMAD, which runs
   beside the INT32 pipe, so the counted bound is no floor for the
   compiled code; the JSON line below takes the compiled one.
3. Cornell render: the CLI's batch render of ``scenes/cornell.rtc`` at its
   768x768 and k 6, at RENDER_SPP samples, into an EXR in a temporary
   directory that is read back; finite, non-trivial, one K1 and one K2
   launch per sample x bounce.  A 128x128, 4 spp, k 6 render on the card is
   held against the same render on the CPU (the plain versions).
3b. Atrium render: the CLI renders ``synthetic:atrium`` (481k) at
   1280x720, 1 spp, k 3 with ``intersector auto`` and the ATRIUM_CAMERA view
   into an EXR that is read back: finite and lit (median over 4x4-pixel
   block means of the per-pixel max > 1e-3), on the route ``stream`` (the
   JAX package's rule, ``cluster_cuda.streams_by_budget``: 2 K3, 1 K6 and
   1 K7 per sample x bounce, no other launch), with a torch.profiler
   breakdown of one warm frame.
   Then atrium(2_200) at 160x90, 2 spp, k 2 through ``intersector
   cluster`` (resident by the rule, K4/K5) and again with ``stream=True``
   (K6/K7) on the card, each held against the CPU render, and the card's
   compacted render (spatial sort forced on) must be bitwise equal to its
   uncompacted one.  Each atrium CLI render is followed by its set-up
   seconds apart from its render, cold and warm ms per frame, useful Mray/s
   and peak device memory (with what was already held when it began: each
   earlier phase lets its scenes go first), and is then let go.  The 481k
   frame is rendered again through the CLI with ``CHIAROSCURO_BEAM_CULL=1``
   (K3b in place of K3: 2 K3b launches a bounce): pixels bitwise equal to
   the exact-cull frame's, warm ms beside it, profiled.
3c. Mid-size renders through ``intersector auto``: ``synthetic:atrium:262144``
   at 1280x720, 1 spp, k 3 (route ``resident``: 6 K3, 3 K4, 3 K5, no K6/K7
   and no dense launch; compaction on) and ``synthetic:atrium:19000`` at
   1024x1024, 1 spp, k 3 (the JAX bench's nanosuit shape; K = 148, no
   compaction), each with a torch.profiler breakdown of one warm frame.
3d. ``synthetic:atrium:3000000`` at 1280x720, 1 spp, k 3 through
   ``intersector auto`` (route ``stream``: 6 K3, 3 K6, 3 K7), as 3c; then
   with ``CHIAROSCURO_BEAM_CULL=1`` as in 3b (6 K3b, 3 K6, 3 K7).
3e. ``synthetic:atrium:4000`` at 1280x720, 1 spp, k 3 through
   ``intersector auto``: the dense pair, 3 K1 and 3 K2 launches and no
   other, reported and profiled as 3c; then the same scene at 160x90,
   2 spp, k 2 on the card and on the CPU, held to the atrium's render
   bounds.
3f. Phong, spp_batch, state and profile: (a) the builtin Cornell box
   written as an OBJ/MTL with Ks 0.5 and Ns 50 on its two blocks (checked to
   load back as the builtin scene), rendered through the CLI with
   ``specular on profile on`` at cornell.rtc's 768x768, k 6, RENDER_SPP
   samples: finite, the EXR read back, one K1 and one K2 launch per sample
   x bounce in the render, the phase report printed, the blocks' top faces
   brighter than the ``specular off`` render's; warm frames of both; then
   128x128, 4 spp, k 6 card vs CPU at phase 3's bounds.  (b) The 262k
   atrium with Ks 0.3 and Ns 40 on every non-emissive mesh through
   ``Renderer`` and ``intersector auto`` (route ``resident``: 6 K3, 3 K4,
   3 K5), warm ms beside the same scene's diffuse frame, peak memory and a
   profiled frame; atrium(2_200) with the same Ks and Ns at 160x90, 2 spp,
   k 2 through K4/K5 and K6/K7, each against the CPU at phase 3b's bounds.
   (c) fwd+bwd w.r.t. (kd, ke, ks, shininess) card vs CPU (phase 5's
   bound): glossy Cornell 64x64 x 4 spp x k 3 (K1), the glossy
   atrium(2_200) 64x36 x 2 spp x k 2 (K4).  (d) Cornell 512x512 x 16 spp
   x k 6 with ``spp_batch`` 1 and 16: equal to the CPU tests' batch bound,
   96 against 6 K1 launches, warm ms by CUDA events, peak memory.  (e)
   ``save_state``, ``load_state`` into a fresh ``Renderer`` and one more
   layer: bitwise two layers rendered straight through.
3g. The BVH path and the preview: (a) the CLI renders ``synthetic:atrium``
   (481k) at 1280x720, 1 spp, k 3 with ``intersector bvh`` (3 B1 and 3 B2
   launches, no other; the BVH built by the native builder,
   ``csrc/bvh_builder.cpp`` compiled by g++ in phase 1), reported as 3b,
   warm ms beside phase 3b's cluster frame, held against that frame by 4x4
   block means at the atrium's card-vs-CPU bound; then B1 on its primary
   and bounce wavefronts and B2 on its NEE shadow wavefront (the rays of
   phase 2b) bitwise equal to the plain walk on ROW_SAMPLE seeded rows with
   equal per-ray step and leaf-test counts, timed on the sample and on
   every row beside their bounds (per lane, and per warp: 32 consecutive
   rays each paying its longest walk, in wavefront and in a seeded random
   order, with the SIMT efficiency) and K3 + K6/K7 on the same wavefronts.
   (b) The same on the 262k's wavefronts beside K3 + K4/K5.  (c) The CLI
   renders ``synthetic:atrium:3000000`` at 1280x720, 1 spp, k 3 with
   ``intersector bvh`` (3 B1, 3 B2, native build), held by 4x4 block means
   against phase 3d's cluster frame, reported, warm ms beside that frame's,
   and profiled.  (d)
   atrium(2_200) at 160x90, 2 spp, k 2 through ``intersector bvh`` on the
   card against the CPU at 3b's bounds.  (e) The preview headless:
   ``make_state`` on Cornell (K1) and the 262k (K3 + K4) at a small size,
   the raster frame on the card against the CPU's, then R and the shown
   layer.  Two more of this phase's measurements run where their rays are
   held: (f) in phase 2e, B1/B2 on the atrium:4000 primary, bounce and
   shadow wavefronts, as (a), beside K1/K2 on the same rays; (g) in phase
   2d, on the 3M primary, bounce and shadow wavefronts with its natively
   built BVH (its MiB printed), the plain walk on BIG3M_SAMPLE rows, beside
   K3 + K6/K7.
4. Timings (CUDA events, with the card's name and power limit): every
   kernel vs its plain version in us per launch (K1/K2 on phase 2's
   queries beside their bounds and the kernels they replaced), the visits
   beside the row-wide walks they replaced (REPLACED_US),
   with visits per warp, held equal to one replay of the exit rule a
   wavefront on every row, and the bounds of the tests the rule needs, per
   warp (and for closest queries per row, a row's slowest warp), on the
   256-row sample and on every row, the occlusion kernels' lane-test
   share; K3's sweep and whole cull on every wavefront, each with its
   bound, beside the Triton K3's times where they were taken
   (TRITON_K3_US).
5. Gradients (``render_samples`` + ``backward``, the intersectors rebuilt on
   the parameter-substituted scene): (i) the card's value and gradients of
   the mean image w.r.t. kd, ke (and tri_v0 on Cornell, tex_data on the
   atrium) against the CPU's, on Cornell 64x64 x 4 spp x k 3 (K1) and
   atrium(2_200) 64x36 x 2 spp x k 2 through K4 and through K6;
   (ii) full width: fwd+bwd w.r.t. (kd, ke) on the 262k atrium at
   1280x720 x 1 spp x k 3 with ``checkpoint=True`` — finite, the lights'
   ke gradients non-zero, one S1 sum a bounce (``LAUNCHES["scatter_rows"]``)
   — the first turn records each sum's cotangent and ids, and S1 (the
   gather's backward, ``ops/scatter_cuda.py``) is held bitwise against its
   plain version and a second sum on them and timed beside its bound, its
   plain version and ATen's ``index_put_(accumulate=True)``, with the ids'
   share at id 0, longest segment and distinct ids; (iii) Cornell 512x512 x 16 spp x k 3 fwd+bwd
   through K1 (the JAX bench's 500 spp cut to 16).  ms and peak device
   memory are printed, and a torch.profiler breakdown of one 262k fwd+bwd;
   (iv) the backward's row fetch: Cornell 512x512 x 2 spp x k 3 fwd+bwd
   (checkpointed) w.r.t. (kd, ke) and w.r.t. (kd, ke) and the vertices,
   profiled in turns with the one-hot product (the default) and the gather
   forced, one-hot, gather, gather, one-hot: busy, idle, "gathers and
   scatters" and the products' device ms, the one-hot turns' gradients
   bitwise equal; the vertex gradients card vs CPU at 96x96 x 2 spp x k
   3; the 16-spp fwd+bwd with ``spp_batch=16`` (a one-hot over its 4M lanes
   would exceed the budget, so it runs in chunks): ms and peak memory.
6. The tool path: ``tools/cull_experiments.main()`` (the cull shootout on
   ``synthetic:atrium:19000`` at 1024x1024: K3, the dot-reduce and
   scan-free formulations and X1, their masks and lists checked against
   each other, and X1 against its plain version at KB = 256, padded
   columns included) and ``tools/dma_min.main()``, with the tools' launch counts
   set to 0 before and read after; X2 bitwise equal to its plain version
   at trip 0, 5, 16 and 19, and timed beside it and ``big[:trip*M].sum(0)``:
   the loop by CUDA events, and X2's and the library call's own kernel
   time by torch.profiler over the same loop.
7. The sharded path (``parallel/``): ranks spawned by
   ``parallel/scaling.run_ranks``, each building its scenes from their
   specs, run three frames through ``render_frame_sharded`` (Cornell
   ``scenes/cornell.rtc`` at 768x768, k 6, SHARD_SPP spp through ``auto``,
   K1/K2; the 481k atrium at 1280x720, 1 spp, k 3 through ``auto``, K3 +
   K6/K7 on the route ``stream``; the same atrium through ``intersector
   bvh``, B1/B2) and two gradient steps through ``sharded_value_and_grad``
   (Cornell 512x512 x 2 spp x k 6 through ``dense`` w.r.t. kd, ke and the
   vertices; the 262k atrium at 1280x720 x 1 spp x k 3 through ``cluster``,
   route ``resident``, K3 + K4/K5, w.r.t. kd and ke with
   ``checkpoint=True``), the MSE against a black target.  (a) One NCCL
   rank: each frame bitwise equal to ``render_samples`` over the whole grid
   in this process, with the rank's launches: one K1 and one K2 a sample x
   bounce, two K3 and one K6 and K7, one B1 and B2.  (b) Two gloo ranks on
   the card (NCCL refuses two ranks on one device): every rank's frame
   bitwise equal to (a)'s and each rank's launches as in (a).  (c) Their
   all-reduced losses within rtol 1e-6 and each gradient within 1e-5
   relative L1 of (a)'s (only the order of the float sums differs).  (d)
   ``entry.dryrun_multichip(1)``.  (e) One gloo rank times the frames too:
   the scaling report (``scaling.scaling_report``, what ``measure_scaling``
   returns) of each frame at 1 and 2 gloo ranks, with the NCCL rank's ms.
   Two ranks share the one card, so no report is a scaling efficiency.
   The ranks' launches in (a) and (b) count on the main path.

The line before the last is a JSON object of the kernels: for each, the
launches of its path (K1-K7, K3b, B1/B2: the main-path renders of phases 3-3g,
counts
set to 0 before each run and read after it, summed over the runs; R1: every
launch of phases 3-3g; each with phase 7's ranks' launches; X1/X2:
phase 6; S1, ``scatter_rows``: phase 5(ii)'s first 262k step), its
largest |kernel - plain|, its time (K1/K2 on phase 2's Cornell queries by
CUDA events over a loop of calls, their kernel time by torch.profiler
printed beside it in phase 4; X2 and its library call: kernel time by
torch.profiler; K4/K5 on the 262k wavefronts' sample, K6/K7 on the 481k
ones', K3b's whole cull on the 481k primary wavefront, B1/B2 on the 481k
primary and shadow wavefronts' sample; S1 and ATen's ``index_put_`` the mean
over phase 5(ii)'s three recorded sums; R1 at 589,824 lanes, phase 2f) and its
plain version's on the stated inputs, and the bound: the
larger of the FP32 operations those inputs need (K1/K2: the tests the
warp-uniform reject leaves; visits counted by the replay of the per-warp
exit rule; occlusion lanes tested only up to their first blocker; K3b:
BEAM_AXIS_OPS a definite axis of a row and BEAM_TAIL_OPS a (row, box),
against the rays and boxes read and the lists written;
B1/B2: BOX_OPS a step and MT_OPS a leaf test of the plain walk's; S1: an
add a lane and column, against the cotangent and ids read and the table
written once) over the
card's unfused FP32 rate and the bytes read and written once over its
memory rate; R1's is phase 2f's compiled bound.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B0 = 4608                  # rows of 128 lanes in one 768x768 wavefront
SOUP_TRIS = 4096           # the largest scene the dense path serves
RENDER_SPP = 16
RENDER_K = 6
ATRIUM_RES = (1280, 720)   # the bench's sponza-scale headline frame
ATRIUM_K = 3
MID_TRIS = 262_144         # synthetic:atrium:262144
NANO_TRIS = 19_000         # synthetic:atrium:19000, the nanosuit scale
BIG3M_TRIS = 3_000_000     # synthetic:atrium:3000000, the JAX bench's atrium3m
BIG3M_SAMPLE = 32          # seeded 3M rows (and at most as many overflow rows) vs plain
ROW_SAMPLE = 256           # seeded rows for the plain visit comparisons
BOUNCE_3M_TURNS = 6        # single timed launches of K6 on the 3M bounce wavefront
SMALL_LMAX = 32            # lists short enough that most atrium(2_200) rows overflow
PIXEL_ORDER_LMAX = 512     # list width for the pixel-order bounce block
NANO_RES = (1024, 1024)    # the 19k frame, bench.py's nanosuit shape
DENSE_ATRIUM_TRIS = 4000   # synthetic:atrium:4000: 4,040 triangles, the dense path
PHONG_CORNELL = (0.5, 50.0)  # Ks and Ns of the glossy Cornell blocks (phase 3f)
PHONG_ATRIUM = (0.3, 40.0)   # Ks and Ns of every non-emissive atrium mesh (phase 3f)
SHARD_SPP = 4              # samples of phase 7's Cornell frame
SHARD_GRAD_RES = (512, 512)   # phase 7's Cornell gradient frame, 2 spp x k 6

# Bounds (H100 SXM peak rates).  With
# -fmad=false every add and multiply is its own instruction, so the FP32
# rate is half the 67 TFLOP/s that counts a fused multiply-add as two.
PEAK_FP32_UNFUSED = 33.5e12    # FP32 operations/s
PEAK_BYTES = 3.35e12           # device memory bytes/s
# FP32 operations of one Moller-Trumbore test (csrc/mt_core.cuh mt_test):
# p 9, a 5, |a| test 2, f 2, s 3, u 6, q 9, v 6, t 6, acceptance 6.
MT_OPS = 54
# Of those, the part before the kernels' warp-uniform reject (mt_front and
# mt_u_ok): p 9, a 5, |a| test 2, f 2, s 3, u 6, u's two compares 2.
MT_FRONT_OPS = 29
# FP32 operations of one (lane, box) slab test of K3 (csrc/cull_rows.cu,
# planes chosen by the sign of 1/d): per axis 2 sub, 2 mul (12); near and
# far across axes 4; max(near, 0), the hit compare, the +0.0, the select and
# the lanes' minimum 5.  With tmax, 1 more.
CULL_OPS = 21
# FP32 operations of one (lane, box) row-hit test of X1
# (csrc/cull_rowhit.cu): per axis 2 sub, 2 mul, min, max (18); near/far
# across axes 4; hit 3; the row's any 1.  With tmax, 2 more.
X1_OPS = 26
# Boxes per chunk of K3's loop (csrc/cull_rows.cu kChunk), fully unrolled.
CULL_CHUNK = 64
# FP32 operations of K3b (csrc/cull_beam.cu) per (row, box): a definite
# axis 4 sub, 8 mul and the 16 min/max of the two planes' intervals and
# their combination; then the two hit compares, the entry's max and + 0.0
# and the select (one more compare with tmax).  The selection of each row's
# list is integer work and is not counted.
BEAM_AXIS_OPS = 28
BEAM_TAIL_OPS = 5
# The sample streams' kernels, R1 (csrc/threefry.cu).  Integer operations
# a lane: a Threefry-2x32 block is 2 + 5 x 3 key-schedule adds and 20
# rounds of an add, a rotate and an xor, 77; a bounce lane is four blocks,
# the key's parity word (2 xors) and seven conversions (a shift and an or;
# the exact - 1.0f is the one float operation and is not counted), 324;
# a raygen lane two blocks, two parity words and two conversions, 162.
# Bytes a lane: a bounce reads two int64 words and writes seven floats,
# 44; raygen reads the pixel (and a per-lane sample) and writes two int64
# words and two floats, 32 (40).
R1_BOUNCE_OPS = 324
R1_RAYGEN_OPS = 162
R1_BOUNCE_BYTES = 44
R1_RAYGEN_BYTES = 32           # + 8 with a sample a lane
R1_LANES = (589_824, 921_600)  # Cornell's 768x768 wavefront, the 1280x720 Sponza frame's
R1_EXTREMES = (0, 1, 2**31 - 1, 2**31, 2**32 - 1)
R1_BOUNCES = (1, 2, 6, 2**31)
R1_SEED = 3_000_000_077        # above 2^31: the seed word's top bit set
R1_REPS = {"kernel": 50, "plain": 4}   # launches a captured graph, timed by its replays
R1_REPLAYS = 5
# INT32 operations/s: 132 SMs x 64 lanes x 1.98 GHz.  Each of a SM's four
# sub-partitions issues one warp instruction a clock (twice this rate in
# lanes); its INT32 pipe (ALU_OPS) and the half of its FMA pipe that runs
# IMAD take 16 lanes a clock each.
PEAK_INT32 = 132 * 64 * 1.98e9
ALU_OPS = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "PRMT", "LEA", "IMNMX", "IABS", "FLO",
           "POPC")

# us of the Triton K3 that csrc/cull_rows.cu replaced, (sweep, whole cull),
# on the same seeded wavefronts, NVIDIA H100 80GB HBM3 at 700.00 W; None
# where it was not timed.
TRITON_K3_US = {("atrium 481k", "primary"): (10027.9, 11397.2),
                ("atrium:262144", "primary"): (None, 7566.4),
                ("atrium:262144", "shadow"): (6845.6, 7787.0)}

# us of the row-wide walks that the warp-owned walks replaced on the same
# seeded wavefronts, (256-row sample or None where not timed, all rows),
# NVIDIA H100 80GB HBM3 at 700.00 W, by this script: K4/K5 before their
# redesign (blocks read in place, a row-wide exit vote every 8 visits),
# K6/K7 before theirs (the block walking together, a block-wide vote after
# every visit, blocks staged through a two-slot cp.async buffer).
REPLACED_US = {
    ("closest_resident", "atrium:262144", "primary"): (2869.6, 15639.8),
    ("closest_resident", "atrium:262144", "bounce"): (12740.2, 69220.3),
    ("closest_resident", "atrium:262144", "bounce in pixel order"): (79642.5, 79633.7),
    ("any_resident", "atrium:262144", "shadow"): (4290.4, 21488.6),
    ("closest_cluster", "atrium 481k", "primary"): (2617.9, 14344.6),
    ("any_cluster", "atrium 481k", "shadow"): (7259.4, 23120.7),
}

KERNEL_IDS = {"closest_dense": "K1", "any_dense": "K2", "cull": "K3",
              "closest_resident": "K4", "any_resident": "K5",
              "closest_cluster": "K6", "any_cluster": "K7", "cull_rowhit": "X1",
              "cull_beam": "K3b",
              "dma_min": "X2", "bvh_closest": "B1", "bvh_any": "B2",
              "threefry_bounce": "R1", "threefry_raygen": "R1"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def sync():
    torch.cuda.synchronize()


def bits(x):
    """Bit pattern of a float tensor (bitwise comparison), else itself."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def max_err(a, b):
    finite = torch.isfinite(a.double()) & torch.isfinite(b.double())
    d = (a.double() - b.double()).abs()[finite]
    return float(d.max()) if d.numel() else 0.0


def bound(ops, nbytes):
    """(bound_ms, bound_by): the least time for ``ops`` FP32 operations and
    ``nbytes`` bytes moved once."""
    t_ops, t_bytes = ops / PEAK_FP32_UNFUSED, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def compare_kernels(ic, name, tri_rows, attrs, q):
    """Phase 2 for one scene; returns the largest |kernel - plain| seen."""
    k = ic.closest_dense(q["live"], q["o3"], q["d3"], tri_rows, attrs)
    p = ic.closest_dense_plain(q["live"], q["o3"], q["d3"], tri_rows, attrs)
    ko = ic.any_dense(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], tri_rows)
    po = ic.any_dense_plain(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], tri_rows)
    sync()
    fields = ("t", "id", "u", "v", "attrs")
    err = 0.0
    bad = []
    for f, a, b in zip(fields, k, p):
        if not torch.equal(a, b):
            bad.append(f)
        err = max(err, float((a.double() - b.double()).abs().max()))
    if not torch.equal(ko, po):
        bad.append("occluded")
    live_lanes = q["live"].bool()[:, None].expand(B0, 128)
    hit = k[0] < ic.BIG
    hit_share = float(hit[live_lanes].float().mean())
    occ_share = float(ko[live_lanes].float().mean())
    print(
        f"[kernels] {name}: T={tri_rows.shape[0]} B0={B0} live rows="
        f"{int(q['live'].sum())} hit share={hit_share:.4f} occluded share="
        f"{occ_share:.4f} max|kernel-plain|={err} mismatched={bad or 'none'}"
    )
    if bad:
        raise AssertionError(f"{name}: kernel differs from plain in {bad}")
    if not (0.01 < hit_share < 0.99 and 0.01 < occ_share < 0.99):
        raise AssertionError(f"{name}: trivial queries (hit {hit_share}, occ {occ_share})")
    if bool(hit[~live_lanes].any()) or bool(ko[~live_lanes].any()):
        raise AssertionError(f"{name}: a dead row reported a hit")
    return err


def dense_bounds(ic, tri_rows, q, closest=True, occlusion=True):
    """Bounds of K1/K2 on a query (phase 2's, or a frame's wavefront): the
    tests of lanes of live rows that the kernels' warp-uniform reject
    leaves (``ic.reject_counts``), MT_OPS operations each where run in full
    and MT_FRONT_OPS where stopped after u; for K2 only up to each lane's
    first blocker in id order (it stops there).  Bytes: rays, limits, the
    triangle rows and the attribute rows of the distinct hit triangles read
    once, the outputs written once.  Returns {"K1"/"K2": (bound_ms,
    bound_by, share of the tests stopped after u)} for the kinds asked, and
    for K2 also "K2 per warp": every lane of a warp testing up to the
    warp's last first blocker (what a warp's lanes run when they leave
    together)."""
    T = tri_rows.shape[0]
    nB0 = q["o3"].shape[1]
    R = nB0 * 128
    out = {}
    if closest:
        t, tid, *_ = ic.closest_dense(q["live"], q["o3"], q["d3"], tri_rows,
                                      torch.zeros((T, ic.ATTR_K), device=tri_rows.device))
        n_hit_tris = int(torch.unique(tid[t < ic.BIG]).numel())
        full, front = ic.reject_counts(q["live"], q["o3"], q["d3"], tri_rows)
        out["K1"] = (*bound(MT_OPS * full + MT_FRONT_OPS * front,
                            R * 24 + nB0 * 4 + T * 36 + n_hit_tris * 128 + R * 144),
                     front / max(full + front, 1))
    for name, per_warp in (("K2", False), ("K2 per warp", True)) if occlusion else ():
        full, front = ic.reject_counts(q["live"], q["o3"], q["d3"], tri_rows, q["tmax"],
                                       q["excl"], per_warp=per_warp)
        out[name] = (*bound(MT_OPS * full + MT_FRONT_OPS * front, R * 33 + nB0 * 4 + T * 36),
                     front / max(full + front, 1))
    return out


def check_wavefronts(ic, name, rows, attrs, table, waves):
    """K1 (primary, bounce) or K2 (shadow) bitwise equal to its plain
    version on every row of each wavefront; returns the largest
    |kernel - plain| and prints the live rows and hit or occluded shares."""
    err = 0.0
    for wname, q in waves.items():
        nB0 = q["o3"].shape[1]
        if "tmax" in q:
            got = ic.any_dense(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], rows, table)
            want = ic.any_dense_plain(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], rows)
            sync()
            bad = [] if torch.equal(got, want) else ["occluded"]
            share = float(got.float().mean())
        else:
            got = ic.closest_dense(q["live"], q["o3"], q["d3"], rows, attrs, table)
            want = ic.closest_dense_plain(q["live"], q["o3"], q["d3"], rows, attrs)
            sync()
            bad = [f for f, a, b in zip(("t", "id", "u", "v", "attrs"), got, want)
                   if not torch.equal(bits(a), bits(b))]
            err = max(err, max(max_err(a.float(), b.float()) for a, b in zip(got, want)))
            share = float((got[0] < ic.BIG).float().mean())
        print(f"[dense] {name} {wname}: B0={nB0} live rows {int(q['live'].sum())}, "
              f"{'occluded' if 'tmax' in q else 'hit'} share {share:.4f}; "
              f"{'K2' if 'tmax' in q else 'K1'} vs plain on every row: mismatched={bad or 'none'}")
        if bad:
            raise AssertionError(f"{name} {wname}: kernel differs from plain in {bad}")
    return err


# The K1/K2 that this design replaced (one 128-thread block a row, one ray
# a thread, the table staged through shared memory 256 triangles at a time)
# on the same seeded queries and wavefronts: (us a call by CUDA events over
# a loop of calls, its device time by torch.profiler), each the mean of two
# turns of chiaroscuro_tpu_torch/tools/dense_compare.py run on a checkout of
# that design, in turns with this one, NVIDIA H100 80GB HBM3 at 700.00 W.
REPLACED_DENSE_US = {
    ("K1", "cornell queries"): (67.4, 54.1), ("K2", "cornell queries"): (49.2, 43.2),
    ("K1", "soup queries"): (4547.5, 4533.1), ("K2", "soup queries"): (4523.2, 4502.5),
    ("K1", "cornell 768x768 primary"): (80.5, 67.4),
    ("K1", "cornell 768x768 bounce"): (76.9, 73.9),
    ("K2", "cornell 768x768 shadow"): (65.9, 62.7),
    ("K2", "cornell 768x768 bounce shadow"): (71.3, 68.3),
    ("K1", f"atrium:{DENSE_ATRIUM_TRIS} 1280x720 primary"): (9945.9, 9965.7),
    ("K1", f"atrium:{DENSE_ATRIUM_TRIS} 1280x720 bounce"): (11314.4, 11245.0),
    ("K2", f"atrium:{DENSE_ATRIUM_TRIS} 1280x720 shadow"): (9970.0, 9937.1),
    ("K2", f"atrium:{DENSE_ATRIUM_TRIS} 1280x720 bounce shadow"): (11181.1, 11113.1),
}


def time_dense(ic, card, label, rows, attrs, table, q, bounds, plain=False):
    """K1 and/or K2 (the kinds ``bounds`` holds) on one query by CUDA
    events over a loop of calls, in turns with the plain version where
    ``plain``, printed beside the kernel's own device time by
    torch.profiler (at Cornell's 36 triangles a launch takes less device
    time than the wrapper's host work, which the loop also counts), the
    bounds and the replaced kernel's loop on the same rays
    (REPLACED_DENSE_US).  Returns {kind: (the loop's us, plain us or
    None)}."""
    T = rows.shape[0]
    reps = 50 if T < 512 else 10
    args = (q["live"], q["o3"], q["d3"])
    out = {}
    for kind in ("K1", "K2"):
        if kind not in bounds:
            continue
        if kind == "K1":
            fns = {"kernel": lambda: ic.closest_dense(*args, rows, attrs, table),
                   "plain": lambda: ic.closest_dense_plain(*args, rows, attrs)}
        else:
            fns = {"kernel": lambda: ic.any_dense(*args, q["tmax"], q["excl"], rows, table),
                   "plain": lambda: ic.any_dense_plain(*args, q["tmax"], q["excl"], rows)}
        if not plain:
            del fns["plain"]
        t = time_turns(fns, {"kernel": reps, "plain": 1})
        us = t["kernel"][0]
        dev_us, n_dev = device_us(fns["kernel"], reps, "dense_kernel")
        parts = [f"kernel {us:.1f} us (turns {t['kernel'][1][0]:.1f}, {t['kernel'][1][1]:.1f}; "
                 f"device time {'not measured' if dev_us is None else f'{dev_us:.1f} us'} "
                 f"a launch, {n_dev} of {reps} launches recorded)"]
        for name in (kind, f"{kind} per warp"):
            if name in bounds:
                b_ms, b_by, stop = bounds[name]
                parts.append(f"bound{' per warp' if 'warp' in name else ''} {b_ms * 1e3:.1f} us "
                             f"({b_by}; {stop:.4f} of the tests stopped after u; "
                             f"{100 * b_ms * 1e3 / us:.1f}% of it by the loop"
                             + ("" if dev_us is None
                                else f", {100 * b_ms * 1e3 / dev_us:.1f}% by device time")
                             + ")")
        old = REPLACED_DENSE_US.get((kind, label))
        if old is not None:
            parts.append(f"the kernel it replaced {old[0]} us, device time {old[1]} us "
                         f"({old[0] / us:.2f}x this one by the loop"
                         + ("" if dev_us is None else f", {old[1] / dev_us:.2f}x by device time")
                         + f"; {100 * bounds[kind][0] * 1e3 / old[0]:.1f}% of the bound "
                         f"by its loop, {100 * bounds[kind][0] * 1e3 / old[1]:.1f}% by its "
                         "device time)")
        if plain:
            parts.append(f"plain {t['plain'][0]:.1f} us")
        print(f"[dense] {card}: {kind} {label} T={T} B0={q['o3'].shape[1]}: " + "; ".join(parts))
        out[kind] = (us, t["plain"][0] if plain else None)
    return out


def time_us(fn, reps):
    """Microseconds per call of fn over reps calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) * 1e3 / reps


def time_turns(fns, reps):
    """Microseconds per call of each named fn, CUDA events, in turns: the
    given order, then reversed (plain, kernel, kernel, plain).  Returns
    {name: (mean, (first turn, second turn))}."""
    for fn in fns.values():
        fn()
    sync()
    first = {n: time_us(f, reps[n]) for n, f in fns.items()}
    second = {n: time_us(f, reps[n]) for n, f in reversed(list(fns.items()))}
    return {n: ((first[n] + second[n]) / 2, (first[n], second[n])) for n in fns}


def assert_render_close(img, ref, what, mean_rel=1e-4, outlier_share=0.005,
                        flipped_mean_rel=None, vs="card vs cpu"):
    """The CPU tests' bound (tests/test_torch_render.py): mean |d| <=
    mean_rel x mean radiance and at most outlier_share of the pixels outside
    rtol 1e-3.  With ``flipped_mean_rel``, the mean bound holds over the
    pixels inside rtol 1e-3, and the whole image's mean |d| over all pixels
    is held to flipped_mean_rel x mean instead: there the few outside pixels
    are paths that an ulp of a CUDA vs CPU transcendental turned, which can
    carry a light's whole radiance."""
    diff = np.abs(img - ref)
    inside = np.isclose(img, ref, rtol=1e-3, atol=0.0).all(axis=-1)
    mean_abs = float(diff.mean())
    mean_in = float(diff[inside].mean())
    outside = float((~inside).mean())
    print(f"[render] {what} {vs}: mean|d|/mean={mean_abs / float(ref.mean())}, "
          f"over pixels inside rtol 1e-3 {mean_in / float(ref.mean())}; outside rtol 1e-3: "
          f"{outside} ({int((~inside).sum())} of {inside.size} pixels)")
    if flipped_mean_rel is None:
        ok = mean_abs <= mean_rel * float(ref.mean())
    else:
        ok = (mean_in <= mean_rel * float(ref.mean())
              and mean_abs <= flipped_mean_rel * float(ref.mean()))
    if not (np.isfinite(img).all() and ok and outside <= outlier_share):
        raise AssertionError(f"{what}: card render differs from the CPU render")


def reset(*counts):
    for c in counts:
        for key in c:
            c[key] = 0


# ---------------------------------------------------------------------------
# Phase 2b/2c helpers: the atrium's wavefronts and the cluster comparisons.
# ---------------------------------------------------------------------------


def atrium_wavefronts(scene, xres, yres, dev, sorted_=True, clusters=None, pixel_bounce=False):
    """The frame's primary wavefront in pixel order, the first bounce from
    its hits (cosine-sampled with the port's samplers, sorted by the
    integrator's spatial key as the cluster path sorts it, dead lanes
    parked; and a block of ROW_SAMPLE rows of it in pixel order) and the NEE
    shadow wavefront from the same hits (sorted by light and cell as
    ``_sorted_any`` sorts it).  With ``sorted_=False`` (a scene below
    COMPACT_MIN_K clusters, which the integrator neither compacts nor
    sorts) the primary and the shadow wavefront, both in pixel order.
    Returns {name: (o3, d3, tmax or None, excl or None)}, the primary hit
    share and the primary closest-hit distances (B0, 128) (BIG where a ray
    missed).  ``clusters``: the scene's prebuilt decomposition, if any.
    With ``pixel_bounce`` also "bounce, pixel order": every row of the
    bounce wavefront unsorted, as the BVH path's row interface traces it."""
    from chiaroscuro_tpu_torch.geometry import planar as P
    from chiaroscuro_tpu_torch.geometry.camera import camera_basis, primary_ray_dirs_planar
    from chiaroscuro_tpu_torch.ops import cluster_cuda as cc
    from chiaroscuro_tpu_torch.render import integrator as I
    from chiaroscuro_tpu_torch.sampling import prng
    from chiaroscuro_tpu_torch.sampling.samplers import sample_wi_diffuse_planar
    from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA as cam

    B = (xres * yres // 128, 128)
    lu, dx, dy = (torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in
                  camera_basis(cam["eye"], cam["center"], cam["up"], cam["yview"], xres, yres))
    ys, xs = torch.meshgrid(torch.arange(yres, device=dev), torch.arange(xres, device=dev),
                            indexing="ij")
    k0, k1 = prng.base_key(0, (ys * xres + xs).reshape(B), 0)
    jx, jy = prng.aa_jitter_pair(k0, k1)
    d3 = primary_ray_dirs_planar(lu, dx, dy, xs.reshape(B).float(), ys.reshape(B).float(),
                                 jx, jy).contiguous()
    o3 = torch.tensor(cam["eye"], dtype=torch.float32, device=dev)[:, None, None]
    o3 = o3.expand((3,) + B).contiguous()
    cf, _ = cc.make_cluster_intersectors(scene, stream=True, clusters=clusters)
    res = cf.planar_fn(o3, d3)
    hit, A = res.hit, res.attrs
    w = 1.0 - res.u - res.v
    point = P.pscale(w, A["v0"]) + P.pscale(res.u, A["v0"] + A["e1"]) \
        + P.pscale(res.v, A["v0"] + A["e2"])
    normal = A["normal"]
    # The plain streams, as the keys above: the renders' R1 launches count
    # alone (bitwise the same uniforms).
    un = prng.bounce_uniforms_plain(k0, k1, 1)
    wmin = scene.world_min
    wext = torch.clamp_min(scene.world_max - wmin, 1e-6)
    park_x = scene.world_max[0] + (scene.world_max[0] - wmin[0]) + 1.0
    zero = torch.zeros(B, device=dev)
    park_o = torch.stack([park_x.expand(B), zero, zero])
    park_d = torch.stack([torch.ones_like(zero), zero, zero])
    origin = P.pwhere(hit, point + I.EPS_OFFSET * normal, park_o)

    wi, _ = sample_wi_diffuse_planar(normal, un[prng.DIM_BSDF_U], un[prng.DIM_BSDF_V])
    bdir = P.pwhere(hit, wi, park_d)
    key = I._spatial_key(origin, bdir, hit, wmin, wext)
    sm = I._compact(key, torch.cat([origin.reshape(3, -1), bdir.reshape(3, -1)]), 1, B[0] * B[1])

    n_l = scene.n_lights
    li = torch.clamp_max((un[prng.DIM_LIGHT_SEL] * n_l).to(torch.int32), n_l - 1).long()
    lids = scene.light_ids.long()
    lv = [scene.tri_v0[lids][li], scene.tri_v1[lids][li], scene.tri_v2[lids][li]]
    b0 = un[prng.DIM_LIGHT_U]
    b1 = un[prng.DIM_LIGHT_V] * (1.0 - b0)
    lpoint = (lv[0] * b0[..., None] + lv[1] * b1[..., None]
              + lv[2] * (1.0 - b0 - b1)[..., None]).permute(2, 0, 1)
    to_light = lpoint - point
    dist = P.pnorm(to_light)
    sdir = P.pwhere(hit, P.pnormalize(to_light), park_d)
    skey = (((~hit).to(torch.int32) << 26) | (torch.clamp_max(li, 1023).to(torch.int32) << 16)
            | I._morton_cell(origin, wmin, wext))
    ss = I._compact(skey, torch.cat([
        origin.reshape(3, -1), sdir.reshape(3, -1), dist.reshape(1, -1),
        I._f32_bits(scene.light_ids[li]).reshape(1, -1)]), 1, B[0] * B[1])

    def planar(x):
        return x.reshape((3,) + B).contiguous()

    if not sorted_:
        waves = {"primary": (o3, d3, None, None),
                 "shadow": (origin.contiguous(), sdir.contiguous(), dist.contiguous(),
                            scene.light_ids[li].to(torch.int32).contiguous())}
        return waves, float(hit.float().mean()), res.t.contiguous()

    # A block of rows of the bounce wavefront in pixel order, as a render
    # without compaction traces it: its rows mix directions and hit ~800 of
    # the atrium's boxes, so with 512-wide lists (a width the JAX package's
    # sweep measured) they overflow and the visits' phase 2 runs at full
    # scale.
    blk = slice(max(0, B[0] // 2 - ROW_SAMPLE // 2), B[0] // 2 + ROW_SAMPLE // 2)
    waves = {
        "primary": (o3, d3, None, None),
        "bounce": (planar(sm[0:3]), planar(sm[3:6]), None, None),
        "bounce in pixel order": (origin[:, blk].contiguous(), bdir[:, blk].contiguous(),
                                  None, None, PIXEL_ORDER_LMAX),
        "shadow": (planar(ss[0:3]), planar(ss[3:6]), ss[6].reshape(B).contiguous(),
                   ss[7].view(torch.int32).reshape(B).contiguous()),
    }
    if pixel_bounce:
        waves["bounce, pixel order"] = (origin.contiguous(), bdir.contiguous(), None, None)
    return waves, float(hit.float().mean()), res.t.contiguous()


def take_rows(x, rows):
    return x[..., rows, :] if x.dim() == 3 else x[rows]


def run_visit(cc, kernel, lists, o3, d3, tmax, excl, packed, attrs, visits=None):
    if tmax is None:
        return cc._closest_visit(kernel, *lists, o3, d3, packed, attrs, visits)
    return cc._any_visit(kernel, *lists, o3, d3, tmax, excl, packed, visits)


def compare_cluster(cc, name, waves, bmin, bmax, Le, packed, attrs, rng, all_rows,
                    route, sample=ROW_SAMPLE, max_overflow=None):
    """K3 exact on every row (its sweep's hit mask and counts equal, keys
    bitwise and never -0.0; the lists, nears and cutoff bitwise); the
    route's visit kernels (K4/K5 resident, K6/K7 stream) bitwise equal to
    the plain versions on a row sample (every row when ``all_rows``; else
    ``sample`` seeded rows plus every overflow row, or ``max_overflow``
    seeded ones of them).  Returns the largest |kernel - plain| per kernel,
    the compared inputs for the timings, and the number of overflow rows
    compared."""
    errs = {"cull": 0.0, **dict.fromkeys(cc.ROUTES[route], 0.0)}
    inputs = {}
    n_overflow_sampled = 0
    for wname, (o3, d3, tmax, excl, *le) in waves.items():
        wle = min(le[0], Le) if le else Le
        sweep = cc.cull_sweep(o3, d3, bmin, bmax, tmax, hits=True)
        plain_sweep = cc.cull_sweep_plain(o3, d3, bmin, bmax, tmax)
        lists = cc.cull(o3, d3, bmin, bmax, wle, tmax=tmax)
        plain = cc._order_hits(*plain_sweep[:2], wle)
        sync()
        for field, a, b in zip(("count", "key", "hit", "meta", "ids", "nears", "cutoff"),
                               (*sweep, *lists), (*plain_sweep, *plain)):
            if not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"{name}/{wname}: K3 differs from plain in {field}")
        if bool(torch.signbit(sweep[1]).any()):
            raise AssertionError(f"{name}/{wname}: a K3 key is -0.0")
        zero_boxes = int((sweep[2] & (sweep[1] == 0.0)).sum())
        errs["cull"] = max(errs["cull"], max_err(lists[2], plain[2]))
        meta = lists[0]
        nB0 = o3.shape[1]
        overflow = torch.nonzero(meta[:, 1]).reshape(-1)
        if all_rows:
            rows = torch.arange(nB0, device=o3.device)
        else:
            pick = torch.from_numpy(rng.choice(nB0, min(sample, nB0), replace=False))
            if max_overflow is not None and overflow.numel() > max_overflow:
                keep = rng.choice(overflow.numel(), max_overflow, replace=False)
                overflow = overflow[torch.from_numpy(keep).to(o3.device)]
            rows = torch.unique(torch.cat([pick.to(o3.device), overflow]))
        n_overflow_sampled += int(meta[rows, 1].sum())
        sub = tuple(x[rows].contiguous() for x in lists)
        so3, sd3 = o3[:, rows].contiguous(), d3[:, rows].contiguous()
        closest = tmax is None
        k = cc.ROUTES[route][0 if closest else 1]
        out = run_visit(cc, k, lists, o3, d3, tmax, excl, packed, attrs)
        if closest:
            want = cc.closest_cluster_plain(*sub, so3, sd3, packed, attrs)
            fields = ("t", "id", "u", "v", "attrs")
        else:
            want = (cc.any_cluster_plain(*sub, so3, sd3, tmax[rows].contiguous(),
                                         excl[rows].contiguous(), packed),)
            fields = ("occluded",)
        sync()
        bad = []
        for f, a, b in zip(fields, out if closest else (out,), want):
            a = take_rows(a, rows)
            if not torch.equal(bits(a), bits(b)):
                bad.append(f"{KERNEL_IDS[k]} {f} vs plain")
            errs[k] = max(errs[k], max_err(a.float(), b.float()))
        share = float((out[0] < cc.BIG).float().mean()) if closest else float(out.float().mean())
        trip = meta[:, 0].float()
        print(f"[cluster] {name}/{wname}: B0={nB0} Le={wle} K3 hit (row, box) pairs "
              f"{int(sweep[0].sum())}, {zero_boxes} of them at entry +0.0; trip p50={float(trip.median())} "
              f"max={int(meta[:, 0].max())} overflow share={float(meta[:, 1].float().mean()):.5f} "
              f"({int(meta[:, 1].sum())} rows); {KERNEL_IDS[k]} vs plain on "
              f"{rows.numel()} rows ({int(meta[rows, 1].sum())} overflow): "
              f"{'hit' if closest else 'occluded'} share {share:.4f}, mismatched={bad or 'none'}")
        if bad:
            raise AssertionError(f"{name}/{wname}: {bad}")
        inputs[wname] = (o3, d3, tmax, excl, lists, wle)
    ids = "/".join(KERNEL_IDS[k] for k in cc.ROUTES[route])
    print(f"[cluster] {name}: K3 equals plain on every row (keys bitwise); {ids} bitwise on the samples "
          f"({n_overflow_sampled} overflow rows among them)")
    return errs, inputs, n_overflow_sampled


def visit_bound(lists, o3, tmax, packed, visits, tests, hit_tris):
    """Bound of one visit launch: MT_OPS per (lane, triangle) test these
    inputs need (the replay's count, :func:`replay_visits`); bytes: rays,
    lists up to trip, the distinct cluster blocks (at most the visits), the
    attribute rows of the ``hit_tris`` distinct hit triangles read once, the
    outputs written once."""
    B0_, M = o3.shape[1], packed.shape[2]
    R = B0_ * 128
    n_vis = int(visits.sum())
    nbytes = (R * 24 + B0_ * 12 + int(lists[0][:, 0].sum()) * 8
              + min(packed.shape[0], n_vis) * packed.shape[1] * M * 4)
    if tmax is None:
        nbytes += hit_tris * 128 + R * 144
    else:
        nbytes += R * 9
    return bound(MT_OPS * int(tests.sum()), nbytes)


def replay_visits(cc, lists, o3, d3, tmax, excl, packed, kernel_visits, first_out):
    """The visit kernels' exit rule replayed in torch on the card
    (``cluster_cuda._visit_walk``, per warp) on the rows given.  Every
    kernel's (B0, 4) visit counts must equal the replay exactly
    ({kernel: counts}), and the replay's answer the kernels'
    (``first_out``).  For a closest query the per-row rule (a row walking
    together, the earlier per-row bound) comes for free: a row's walk visits
    what its slowest warp visits (a warp stops early only when none of its
    lanes wants a later box of the list or the sweep: the nears ascend and
    the cutoff is at least every listed near), each visit testing every
    lane against each triangle; an occlusion query's per-row tests would
    take a replay of their own and are not replayed.  Returns
    {"warp"/"row": (visits, tests)}, each (B0, G) per group of the rule."""
    warp_v, warp_t, state = cc._visit_walk(*lists, o3, d3, packed, tmax, excl, lanes=32)
    out = {"warp": (warp_v, warp_t)}
    if tmax is None:
        row_v = warp_v.amax(1, keepdim=True)
        out["row"] = (row_v, row_v.long() * 128 * packed.shape[2])
    same = torch.equal(bits(state[0]), bits(first_out[0])) if tmax is None \
        else torch.equal(state, first_out)
    if not same:
        raise AssertionError("the per-warp replay does not reproduce the kernels' answer")
    for k, counts in kernel_visits.items():
        if not torch.equal(counts, warp_v):
            raise AssertionError(f"{KERNEL_IDS[k]}: visit counts differ from the replay of its rule")
    return out


def replay_bounds(cc, lists, o3, tmax, packed, replay, first_out, rows=None):
    """{"row"/"warp": (bound, tests, visits)} of :func:`replay_visits`'s
    replay on ``rows`` of its rows (all where None)."""
    if rows is not None:
        lists = tuple(x[rows] for x in lists)
        o3 = o3[:, rows]
        first_out = (first_out[0][rows], first_out[1][rows]) if tmax is None \
            else first_out[rows]
    hit_tris = 0
    if tmax is None:
        hit_tris = int(torch.unique(first_out[1][first_out[0] < cc.BIG]).numel())
    out = {}
    for gran, (v, t) in replay.items():
        if rows is not None:
            v, t = v[rows], t[rows]
        out[gran] = (visit_bound(lists, o3, tmax, packed, v, t, hit_tris), int(t.sum()),
                     int(v.sum()))
    return out


def check_visits(cc, name, inputs, packed, attrs, route):
    """Every row of each wavefront: the per-warp visit counts of the
    route's visit kernels against the replay of the exit rule."""
    for wname, (o3, d3, tmax, excl, lists, _) in inputs.items():
        k = cc.ROUTES[route][0 if tmax is None else 1]
        counts = torch.zeros((o3.shape[1], cc.WARPS), dtype=torch.int32, device=o3.device)
        out = run_visit(cc, k, lists, o3, d3, tmax, excl, packed, attrs, visits=counts)
        replay_visits(cc, lists, o3, d3, tmax, excl, packed, {k: counts}, out)
        print(f"[cluster] {name}/{wname}: visit counts of {KERNEL_IDS[k]} equal the replay "
              f"on every row ({int(counts.sum())} warp visits)")


def time_cluster(cc, inputs, bmin, bmax, packed, attrs, rng, route, plain_cull=True):
    """For each wavefront: K3's whole cull and its sweep alone on every row
    (against its plain version where ``plain_cull``) and the route's visit
    kernel on ROW_SAMPLE seeded rows, in turns, against the plain version
    on the primary and shadow wavefronts (the bounce ones' plain sweeps
    take seconds and are checked, not timed); the kernel also on every
    row.  Its per-warp visit counts on the sample and on every row, held to
    one :func:`replay_visits` on every row (a row's walk does not depend on
    the other rows), and the bounds per warp (and, for closest queries, per
    row) of every row and of the sample."""
    timings = {}
    for wname, (o3, d3, tmax, excl, lists, wle) in inputs.items():
        dev = o3.device
        nB0 = o3.shape[1]
        pick = torch.from_numpy(rng.choice(nB0, min(ROW_SAMPLE, nB0), replace=False)).to(dev)
        sub = tuple(x[pick].contiguous() for x in lists)
        so3, sd3 = o3[:, pick].contiguous(), d3[:, pick].contiguous()
        stm = sex = None
        if tmax is not None:
            stm, sex = tmax[pick].contiguous(), excl[pick].contiguous()
        k3_fns = {"cull": lambda: cc.cull(o3, d3, bmin, bmax, wle, tmax=tmax),
                  "sweep": lambda: cc.cull_sweep(o3, d3, bmin, bmax, tmax)}
        if plain_cull:
            k3_fns = {"plain": lambda: cc.cull_plain(o3, d3, bmin, bmax, wle, tmax=tmax),
                      **k3_fns}
        k3 = time_turns(k3_fns, {"plain": 1, "cull": 10, "sweep": 10})
        K = bmin.shape[0]
        ops = (CULL_OPS + (tmax is not None)) * nB0 * 128 * K
        # Rays and boxes read once; the lists (whole cull) or the keys and
        # counts (sweep) written once.
        reads = nB0 * 128 * (24 + (4 if tmax is not None else 0)) + K * 24
        no_plain = (None, (None, None))
        timings[("cull", wname)] = dict(
            us=k3["cull"][0], turns=k3["cull"][1], plain_us=k3.get("plain", no_plain)[0],
            plain_turns=k3.get("plain", no_plain)[1], sweep_us=k3["sweep"][0],
            sweep_turns=k3["sweep"][1],
            bound=bound(ops, reads + nB0 * (12 + 8 * wle)),
            sweep_bound=bound(ops, reads + nB0 * (4 + 4 * K)), rows=nB0)
        closest = tmax is None
        k = cc.ROUTES[route][0 if closest else 1]
        fns = {}
        if wname in ("primary", "shadow"):
            fns["plain"] = (lambda: cc.closest_cluster_plain(*sub, so3, sd3, packed, attrs)) \
                if closest else (lambda: cc.any_cluster_plain(*sub, so3, sd3, stm, sex, packed))
        fns[k] = lambda: run_visit(cc, k, sub, so3, sd3, stm, sex, packed, attrs)
        sample_t = time_turns(fns, {n: (1 if n == "plain" else 10) for n in fns})
        full_t = time_turns(
            {k: lambda: run_visit(cc, k, lists, o3, d3, tmax, excl, packed, attrs)}, {k: 10})
        vs = torch.zeros((so3.shape[1], cc.WARPS), dtype=torch.int32, device=dev)
        va = torch.zeros((nB0, cc.WARPS), dtype=torch.int32, device=dev)
        run_visit(cc, k, sub, so3, sd3, stm, sex, packed, attrs, visits=vs)
        out_all = run_visit(cc, k, lists, o3, d3, tmax, excl, packed, attrs, visits=va)
        if not torch.equal(vs, va[pick]):
            raise AssertionError(f"{KERNEL_IDS[k]} {wname}: the sample's visit counts "
                                 "differ from those of its rows in the every-row launch")
        replay = replay_visits(cc, lists, o3, d3, tmax, excl, packed, {k: va}, out_all)
        bounds = {
            "sample": replay_bounds(cc, lists, o3, tmax, packed, replay, out_all, pick),
            "all": replay_bounds(cc, lists, o3, tmax, packed, replay, out_all),
        }
        M = packed.shape[2]
        widest = bounds["all"]["warp"]
        timings[(k, wname)] = dict(
            us=sample_t[k][0], turns=sample_t[k][1],
            plain_us=sample_t.get("plain", no_plain)[0],
            plain_turns=sample_t.get("plain", no_plain)[1], full_us=full_t[k][0],
            full_turns=full_t[k][1], visits_sample=int(vs.sum()),
            visits_all=int(va.sum()),
            bounds={(rows, g): b for rows, by in bounds.items() for g, b in by.items()},
            bound=bounds["sample"]["warp"][0], all_bound=bounds["all"]["warp"][0],
            rows=nB0,
            # Tests the per-warp bound needs over those its warps ran.
            test_share=widest[1] / (32 * M * widest[2]))
        timings[("rows", wname)] = (nB0, wle, float(lists[0][:, 0].float().median()),
                                    float(sub[0][:, 0].float().median()))
    return timings


def bounce_3m(cc, card, o3, d3, bmin, bmax, packed, attrs):
    """The 3M frame's bounce wavefront, where its closest visits spend most
    of the frame: K6, the scene's route, counted and then timed on every
    row, BOUNCE_3M_TURNS launches one at a time with their spread (its
    overflow rows' plain sweeps and walk replays over 23k clusters would
    take minutes, so it is not held to the plain version here).  Prints the
    rows that overflow their list and the per-warp visits of overflow and
    other rows; returns K6's mean us."""
    lists = cc.cull(o3, d3, bmin, bmax, min(cc.DEFAULT_LMAX, bmin.shape[0]))
    visits = torch.zeros((o3.shape[1], cc.WARPS), dtype=torch.int32, device=o3.device)
    cc.closest_cluster(*lists, o3, d3, packed, attrs, visits=visits)
    sync()
    us = [time_us(lambda: cc.closest_cluster(*lists, o3, d3, packed, attrs), 1)
          for _ in range(BOUNCE_3M_TURNS)]
    mean = sum(us) / len(us)
    over = lists[0][:, 1].bool()
    trip = lists[0][:, 0].float()
    per_warp = visits.float()
    print(f"[timing] {card}: 3M bounce B0={o3.shape[1]}: trip p50 {float(trip.median())}, "
          f"overflow rows {int(over.sum())} ({float(over.float().mean()):.4f}); warp visits "
          f"mean {float(per_warp.mean()):.2f}, on overflow rows "
          f"{float(per_warp[over].mean()) if bool(over.any()) else 0.0:.2f} "
          f"({int(visits[over].sum())} of {int(visits.sum())}); K6 on all rows {mean:.1f} us "
          f"over {len(us)} launches (min {min(us):.1f}, max {max(us):.1f}, spread "
          f"{(max(us) - min(us)) / mean:.4f} of the mean): "
          + ", ".join(f"{u:.1f}" for u in us))
    return mean


def beam_ops(d3, K, with_tmax):
    """FP32 operations K3b's sweep needs on these rays: per (row, box)
    BEAM_AXIS_OPS a definite axis (the row's directions all of one sign)
    and BEAM_TAIL_OPS (one more with tmax)."""
    n_def = sum(((d3[a].amin(1) > 0) | (d3[a].amax(1) < 0)).long() for a in range(3))
    return int((BEAM_AXIS_OPS * n_def + BEAM_TAIL_OPS + with_tmax).sum()) * K


def beam_two_step(cc, o3, d3, bmin, bmax, Le, tmax=None):
    """The two-step K3b that the fused kernel replaced, kept for the A/B in
    ``beam_checks``: its sweep kernel (``cull_beam_sweep_launch``, the
    (B0, K) keys and counts), then :func:`cc._order_hits` (not where ``Le``
    is None: the sweep alone).  Returns (count, key, lists or None); not
    counted in ``cc.LAUNCHES``."""
    lib, _ = cc.build_cull_beam()
    B0, K = o3.shape[1], bmin.shape[0]
    key = torch.empty((B0, K), dtype=torch.float32, device=o3.device)
    count = torch.empty((B0,), dtype=torch.int32, device=o3.device)
    err = lib.cull_beam_sweep_launch(
        o3.data_ptr(), d3.data_ptr(), None if tmax is None else tmax.data_ptr(),
        bmin.data_ptr(), bmax.data_ptr(), B0, K, key.data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(o3.device).cuda_stream)
    cc.check_launch(lib, err, "cull_beam_sweep")
    return count, key, None if Le is None else cc._order_hits(count, key, Le)


def beam_peak_mib(fn):
    """Peak device memory one call of ``fn`` allocates beyond what was held
    before it, MiB."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fn()
    sync()
    return (torch.cuda.max_memory_allocated() - held) / 2**20


def beam_checks(cc, card, name, waves, bmin, bmax, packed, attrs, route, rng,
                replay_sample=None, plain_times=False, visit_reps=3):
    """K3b on each wavefront ({name: (o3, d3, tmax, excl)}), beside K3 on
    the same rays: its lists bitwise equal to the plain version's (the
    plain sweep, then the stable sort), and to the two-step's
    (``beam_two_step``: the sweep kernel the fused one replaced, whose keys
    are held bitwise to the plain sweep's); every box K3 finds among its
    hits (and the boxes whose beam entry lies above K3's entry counted: the
    rounding hazard of a row bound); trip mean and p50 of both lists; the
    route's visit kernel on both lists, its answers bitwise equal (any lane
    that differs fails), its per-warp visits equal to the replay of the
    exit rule on every row (where ``replay_sample = (n, n_over)`` is given,
    on n seeded rows that fit their beam list and n_over seeded rows that
    overflowed it: an overflow row's replay sweeps up to every cluster, a
    Python step a visit) and timed on both in turns (exact, beam, beam,
    exact; ``visit_reps`` launches a turn); K3b's whole cull timed in turns
    with the two-step's (new, old, old, new) and beside K3's, with its bound
    and the peak device memory of one call of each (and, where
    ``plain_times``, the plain version's time).  Returns {wavefront:
    record}, the largest |kernel - plain| of the lists' floats and the
    lanes whose beam answer differed (zero, or the check failed)."""
    out, err = {}, 0.0
    K = bmin.shape[0]
    Le = min(cc.DEFAULT_LMAX, K)
    for wname, (o3, d3, tmax, excl) in waves.items():
        t_wave = time.perf_counter()
        nB0 = o3.shape[1]
        b_lists = cc.cull_beam(o3, d3, bmin, bmax, Le, tmax=tmax)
        count, key, old_lists = beam_two_step(cc, o3, d3, bmin, bmax, Le, tmax)
        p_count, p_key = cc.cull_beam_sweep_plain(o3, d3, bmin, bmax, tmax)
        p_lists = cc._order_hits(p_count, p_key, Le)
        sync()
        if not (torch.equal(count, p_count) and torch.equal(bits(key), bits(p_key))):
            raise AssertionError(f"{name}/{wname}: the two-step's sweep differs from the plain "
                                 "sweep")
        if bool(torch.signbit(key).any()):
            raise AssertionError(f"{name}/{wname}: a K3b key is -0.0")
        for field, a, b, c in zip(("meta", "ids", "nears", "cutoff"), b_lists, p_lists,
                                  old_lists):
            if not (torch.equal(bits(a), bits(b)) and torch.equal(bits(a), bits(c))):
                raise AssertionError(f"{name}/{wname}: K3b's lists differ from plain (or the "
                                     f"two-step's) in {field}")
        err = max(err, max_err(b_lists[2], p_lists[2]), max_err(b_lists[3], p_lists[3]))
        del p_count, p_key, p_lists, old_lists
        e_count, e_key, e_hit = cc.cull_sweep(o3, d3, bmin, bmax, tmax, hits=True)
        e_lists = cc._order_hits(e_count, e_key, Le)
        if not bool(((key < cc.BIG) | ~e_hit).all()):
            raise AssertionError(f"{name}/{wname}: K3b missed a box K3 hit")
        above = int((e_hit & (key > e_key)).sum())
        del e_key, e_hit, key
        trips = {c: lists[0][:, 0].float() for c, lists in (("exact", e_lists), ("beam", b_lists))}
        over = {c: int(lists[0][:, 1].sum()) for c, lists in (("exact", e_lists), ("beam", b_lists))}
        closest = tmax is None
        k = cc.ROUTES[route][0 if closest else 1]
        visits = {c: torch.zeros((nB0, cc.WARPS), dtype=torch.int32, device=o3.device)
                  for c in ("exact", "beam")}
        res = {c: run_visit(cc, k, lists, o3, d3, tmax, excl, packed, attrs, visits=visits[c])
               for c, lists in (("exact", e_lists), ("beam", b_lists))}
        sync()
        pairs = zip(res["exact"], res["beam"]) if closest else [(res["exact"], res["beam"])]
        lanes = torch.zeros((nB0, 128), dtype=torch.bool, device=o3.device)
        for a, b in pairs:
            lanes |= (bits(a) != bits(b)).reshape(-1, nB0, 128).any(0)
        differ = int(lanes.sum())
        if differ:
            raise AssertionError(f"{name}/{wname}: {differ} lanes answer differently on K3b's "
                                 "lists than on K3's")
        if replay_sample is None:
            rows = torch.arange(nB0, device=o3.device)
        else:
            rows = []
            for n, overflowed in zip(replay_sample, (0, 1)):
                of = torch.nonzero(b_lists[0][:, 1] == overflowed).reshape(-1)
                pick = rng.choice(of.numel(), min(n, of.numel()), replace=False)
                rows.append(of[torch.from_numpy(pick).to(o3.device)])
            rows = torch.cat(rows)
        sub = tuple(x[rows].contiguous() for x in b_lists)
        sub_out = tuple(take_rows(x, rows) for x in res["beam"]) if closest else res["beam"][rows]
        replay_visits(cc, sub, o3[:, rows].contiguous(), d3[:, rows].contiguous(),
                      None if closest else tmax[rows].contiguous(),
                      None if closest else excl[rows].contiguous(), packed,
                      {k: visits["beam"][rows]}, sub_out)
        k3 = {"K3 cull": lambda: cc.cull(o3, d3, bmin, bmax, Le, tmax=tmax),
              "K3 sweep": lambda: cc.cull_sweep(o3, d3, bmin, bmax, tmax),
              "K3b cull": lambda: cc.cull_beam(o3, d3, bmin, bmax, Le, tmax=tmax),
              "two-step cull": lambda: beam_two_step(cc, o3, d3, bmin, bmax, Le, tmax),
              "two-step sweep": lambda: beam_two_step(cc, o3, d3, bmin, bmax, None, tmax)}
        reps = {n: 10 for n in k3}
        if plain_times:
            k3["K3b plain cull"] = lambda: cc.cull_beam_plain(o3, d3, bmin, bmax, Le, tmax=tmax)
            reps["K3b plain cull"] = 2
        t_cull = time_turns(k3, reps)
        peak = {"K3b cull": beam_peak_mib(k3["K3b cull"]),
                "two-step cull": beam_peak_mib(k3["two-step cull"])}
        # The visits in turns, warm from the comparison above.
        turns = {"exact": [], "beam": []}
        for c in ("exact", "beam", "beam", "exact"):
            lists = e_lists if c == "exact" else b_lists
            turns[c].append(time_us(lambda: run_visit(cc, k, lists, o3, d3, tmax, excl, packed,
                                                      attrs), visit_reps))
        t_visit = {c: (sum(t) / 2, tuple(t)) for c, t in turns.items()}
        reads = nB0 * 128 * (24 + (4 if tmax is not None else 0)) + K * 24
        ops = beam_ops(d3, K, tmax is not None)
        rec = dict(
            rows=nB0, t_cull=t_cull, t_visit=t_visit, above=above, differ=differ, over=over,
            trips={c: (float(t.mean()), float(t.median())) for c, t in trips.items()},
            visits={c: float(v.float().mean()) for c, v in visits.items()}, peak=peak,
            cull_bound=bound(ops, reads + nB0 * (12 + 8 * Le)),
            sweep_bound=bound(ops, reads + nB0 * (4 + 4 * K)),
            hits=int(count.sum()), exact_hits=int(e_count.sum()), replayed=rows.numel())
        out[wname] = rec
        fmt = lambda n: f"{t_cull[n][0]:.1f} us (turns {t_cull[n][1][0]:.1f}, {t_cull[n][1][1]:.1f})"
        c_ms, c_by = rec["cull_bound"]
        s_ms, s_by = rec["sweep_bound"]
        new_us, old_us = t_cull["K3b cull"][0], t_cull["two-step cull"][0]
        print(f"[beam] {card}: {name}/{wname} B0={nB0} K={K}: K3b's lists equal the plain "
              f"version's and the two-step's; hit (row, box) pairs K3b {rec['hits']} against K3 "
              f"{rec['exact_hits']}; beam entries above K3's {above}; trip mean/p50 exact "
              f"{rec['trips']['exact'][0]:.1f}/{rec['trips']['exact'][1]:.0f}, beam "
              f"{rec['trips']['beam'][0]:.1f}/{rec['trips']['beam'][1]:.0f}; overflow rows exact "
              f"{over['exact']}, beam {over['beam']}; {KERNEL_IDS[k]} answers on the beam lists "
              f"bitwise those on the exact lists (lanes differing: {differ}); warp visits mean "
              f"exact {rec['visits']['exact']:.2f}, beam {rec['visits']['beam']:.2f} (beam "
              f"counts equal the replay on {rows.numel()} rows"
              + (")" if replay_sample is None else
                 f", {int(b_lists[0][rows, 1].sum())} of them overflow rows)")
              + f"; {time.perf_counter() - t_wave:.1f} s")
        print(f"[timing] {card}: {name}/{wname}: K3b whole cull (one kernel) {fmt('K3b cull')}, "
              f"bound {c_ms * 1e3:.1f} us ({c_by}; {100 * c_ms * 1e3 / new_us:.1f}% of it), "
              f"peak {peak['K3b cull']:.1f} MiB; the two-step it replaced "
              f"{fmt('two-step cull')} ({old_us / new_us:.2f}x the new; "
              f"{100 * c_ms * 1e3 / old_us:.1f}% of the bound), peak "
              f"{peak['two-step cull']:.1f} MiB, its sweep {fmt('two-step sweep')} (bound "
              f"{s_ms * 1e3:.1f} us, {s_by}; {100 * s_ms * 1e3 / t_cull['two-step sweep'][0]:.1f}%"
              f"); K3 sweep {fmt('K3 sweep')}, K3 whole cull {fmt('K3 cull')}"
              + (f"; K3b plain cull {fmt('K3b plain cull')}" if plain_times else "")
              + f"; {KERNEL_IDS[k]} on all rows on the exact lists {t_visit['exact'][0]:.1f} us "
              f"(turns {t_visit['exact'][1][0]:.1f}, {t_visit['exact'][1][1]:.1f}), on the beam "
              f"lists {t_visit['beam'][0]:.1f} us (turns {t_visit['beam'][1][0]:.1f}, "
              f"{t_visit['beam'][1][1]:.1f})")
        if not new_us < old_us:
            raise AssertionError(f"{name}/{wname}: the fused K3b ({new_us:.1f} us) is not faster "
                                 f"than the two-step it replaced ({old_us:.1f} us)")
        del e_lists, b_lists, res, visits, count, e_count
    return out, err


def k3_waves(cc, card, o3, d3, bmin, bmax):
    """K3's sweep on the first n rows of (o3, d3) for n = 1 to 4 waves of
    resident blocks (16 a multiprocessor: the kernel's launch bounds) and
    the 1280x720 wavefront's 7,200 rows between them: whether a last,
    partial wave costs a whole wave's time (then splitting rows' boxes
    across blocks would pay) or its share of the rows."""
    per_wave = torch.cuda.get_device_properties(0).multi_processor_count * 16
    sizes = sorted({per_wave * w for w in (1, 2, 3, 4)} | {7200})
    parts = []
    for n in (n for n in sizes if n <= o3.shape[1]):
        so3, sd3 = o3[:, :n].contiguous(), d3[:, :n].contiguous()
        cc.cull_sweep(so3, sd3, bmin, bmax)
        sync()
        us = time_us(lambda: cc.cull_sweep(so3, sd3, bmin, bmax), 10)
        parts.append(f"{n} rows {us:.1f} us ({us * per_wave / n:.1f} per {per_wave} rows)")
    print(f"[timing] {card}: K3 sweep by rows, K={bmin.shape[0]}: " + "; ".join(parts))


def compare_x1(xc, cc, what, o3, d3, tmax, bmin, bmax, boxes):
    """X1 on every row of a wavefront: exactly equal to its plain version
    (padded columns 1.0 in every row), and ``rowhit[:, :K] > 0`` exactly
    K3's hit mask; then timed in turns beside K3's sweep and the whole K3
    cull on the same rays.  Returns the timings and the bound."""
    K, KB, nB0 = bmin.shape[0], boxes.shape[0], o3.shape[1]
    got = xc.cull_rowhit(o3, d3, boxes, tmax)
    want = xc.cull_rowhit_plain(o3, d3, boxes, tmax)
    k3_hit = xc.k3_rowhit(o3, d3, bmin, bmax, tmax)
    sync()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: X1 differs from its plain version")
    if not torch.equal(got[:, :K] > 0.0, k3_hit):
        raise AssertionError(f"{what}: X1's row hits differ from K3's hit mask")
    if not bool((got[:, K:] == 1.0).all()):
        raise AssertionError(f"{what}: a padded column of X1 is not 1.0")
    Le = min(cc.DEFAULT_LMAX, K)
    t = time_turns({
        "plain": lambda: xc.cull_rowhit_plain(o3, d3, boxes, tmax),
        "x1": lambda: xc.cull_rowhit(o3, d3, boxes, tmax),
        "k3 sweep": lambda: cc.cull_sweep(o3, d3, bmin, bmax, tmax),
        "k3 cull": lambda: cc.cull(o3, d3, bmin, bmax, Le, tmax=tmax),
    }, {"plain": 1, "x1": 10, "k3 sweep": 10, "k3 cull": 10})
    ops = (X1_OPS + (2 if tmax is not None else 0)) * nB0 * 128 * K
    nbytes = nB0 * 128 * (24 + (4 if tmax is not None else 0)) + KB * 32 + nB0 * KB * 4
    b = bound(ops, nbytes)
    print(f"[x1] {what}: B0={nB0} K={K} KB={KB} row-hit share "
          f"{float(got[:, :K].mean()):.4f}; X1 equals its plain version and K3's hit mask "
          f"exactly on every row")
    return dict(t=t, bound=b, rows=nB0, K=K, err=max_err(got, want))


def print_x1_timings(card, what, x):
    t, (b_ms, b_by) = x["t"], x["bound"]
    parts = ", ".join(f"{n} {m:.1f} us (turns {a:.1f}, {c:.1f})" for n, (m, (a, c)) in t.items())
    print(f"[timing] {card}: X1 cull_rowhit {what} B0={x['rows']} K={x['K']}: {parts}; "
          f"X1 bound {b_ms * 1e3:.1f} us ({b_by}); X1 / K3 sweep "
          f"{t['x1'][0] / t['k3 sweep'][0]:.3f}, X1 / K3 cull {t['x1'][0] / t['k3 cull'][0]:.3f}")


def print_cluster_timings(card, scene_name, ctimings):
    for (label, wname), val in ctimings.items():
        if label == "rows":
            print(f"[timing] {card}: {scene_name} {wname}: B0={val[0]} Le={val[1]}, trip p50 "
                  f"{val[2]} on all rows, {val[3]} on the timed sample")
            continue
        b_ms, b_by = val["bound"]
        if label == "cull":
            s_ms, s_by = val["sweep_bound"]
            tri = TRITON_K3_US.get((scene_name, wname))
            tri = "" if tri is None else "; the Triton K3 it replaced: sweep {}, cull {} us".format(
                *("not timed" if x is None else x for x in tri))
            plain = "not timed" if val["plain_us"] is None else (
                f"{val['plain_us']:.1f} us (turns {val['plain_turns'][0]:.1f}, "
                f"{val['plain_turns'][1]:.1f})")
            print(f"[timing] {card}: K3 {scene_name} {wname} B0={val['rows']}: sweep "
                  f"{val['sweep_us']:.1f} us (turns {val['sweep_turns'][0]:.1f}, "
                  f"{val['sweep_turns'][1]:.1f}), bound {s_ms * 1e3:.1f} us ({s_by}); whole cull "
                  f"{val['us']:.1f} us (turns {val['turns'][0]:.1f}, {val['turns'][1]:.1f}), "
                  f"bound {b_ms * 1e3:.1f} us ({b_by}); plain {plain}{tri}")
            continue
        bd = val["bounds"]

        def bounds_text(rows):
            return ", ".join(
                f"per {g} {bd[(rows, g)][0][0] * 1e3:.1f} us ({bd[(rows, g)][0][1]}, "
                f"{bd[(rows, g)][1]} lane-triangle tests)" for g in ("row", "warp")
                if (rows, g) in bd)

        old = REPLACED_US.get((label, scene_name, wname))
        old = "" if old is None else \
            f"; the row-wide walk it replaced: {old[0] or 'not timed'} us on its sample, {old[1]} on all"
        share = "" if label.startswith("closest") else \
            (f"; lane-test share {val['test_share']:.4f} (per-warp bound's tests / "
             "32 x M x warp visits)")
        plain = "not timed" if val["plain_us"] is None else (
            f"{val['plain_us']:.1f} us (turns {val['plain_turns'][0]:.1f}, "
            f"{val['plain_turns'][1]:.1f})")
        print(f"[timing] {card}: {KERNEL_IDS[label]} {label} {scene_name} {wname}, "
              f"sample of {ROW_SAMPLE} "
              f"rows: kernel {val['us']:.1f} us (turns {val['turns'][0]:.1f}, "
              f"{val['turns'][1]:.1f}), plain {plain}, "
              f"{val['visits_sample']} warp visits, bounds {bounds_text('sample')}; all "
              f"{val['rows']} rows: {val['full_us']:.1f} us (turns {val['full_turns'][0]:.1f}, "
              f"{val['full_turns'][1]:.1f}), {val['visits_all']} warp visits "
              f"({val['visits_all'] / (4 * val['rows']):.2f} per warp), bounds "
              f"{bounds_text('all')}{old}{share}")


def route_launches(cc, route, cull="cull"):
    """The launches of one 1-spp, k 3 frame on the cluster path: two culls
    (K3, or with ``cull="cull_beam"`` K3b) and one visit of each kind a
    bounce, on the route's pair."""
    closest, occlusion = cc.ROUTES[route]
    return {cull: 2 * ATRIUM_K, closest: ATRIUM_K, occlusion: ATRIUM_K}


def route_of(cc, K, M):
    """The route the JAX package's rule gives a scene's clusters."""
    return "stream" if cc.streams_by_budget(K, M) else "resident"


def cli_render(cli, repo, counts, tokens, out_name):
    """One CLI batch render into a temporary EXR; returns (renderer, the
    launches of every kernel during the run, wall seconds, (peak device
    memory, device memory already held when the run began), the EXR read
    back)."""
    from chiaroscuro_tpu_torch.render.image_io import read_exr

    with tempfile.TemporaryDirectory() as out_dir:
        exr = os.path.join(out_dir, out_name)
        sync()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset(*counts)
        t0 = time.perf_counter()
        renderer = cli.run(["chiaroscuro_tpu_torch", os.path.join(repo, "scenes", "cornell.rtc"),
                            "no-preview", *tokens, "output", exr])
        total = time.perf_counter() - t0
        launches = {k: v for c in counts for k, v in c.items()}
        sync()
        peak = torch.cuda.max_memory_allocated()
        exported = read_exr(exr)
    return renderer, launches, total, (peak, held), exported


def mem_text(mem):
    peak, held = mem
    return (f"peak device memory {peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB of it "
            "held before the run began)")


def report_frame(card, what, r, total, mem, setup="clusters + buffers"):
    """The CLI render's phases, cold frame and memory, then the same frame
    again, warm, from the CLI's renderer.  ``setup`` names what the
    intersectors' set-up built."""
    ph, rst = r.phase_seconds, r.last_stats
    print(f"[timing] {card}: {what} k3 1 spp (CLI, cold): scene {ph['scene']:.2f} s, "
          f"{setup} {ph['intersectors']:.2f} s, render {rst['seconds'] * 1e3:.1f} "
          f"ms/frame ({rst['useful_rays_per_sec'] / 1e6:.2f} useful Mray/s, occupancy "
          f"{rst['occupancy']:.3f}), export {ph['export']:.2f} s, CLI total {total:.2f} s; "
          f"{mem_text(mem)}")
    r.ray_trace(r.cfg.vp, r.cfg.la, r.cfg.up, r.cfg.yview)
    print(f"[timing] {card}: {what} frame warm: {r.last_stats['seconds'] * 1e3:.1f} "
          f"ms/frame ({r.last_stats['useful_rays_per_sec'] / 1e6:.2f} useful Mray/s)")


def route_name(closest_fn):
    """The pair's route: the cluster route, else ``bvh`` or ``dense``."""
    return getattr(closest_fn, "route", "bvh" if hasattr(closest_fn, "bvh") else "dense")


def check_atrium_render(renderer, exported, launches, want, what, res):
    img, cfg = renderer.pixels, renderer.cfg
    xres, yres = res
    blocks = img.reshape(yres // 4, 4, xres // 4, 4, 3).mean(axis=(1, 3))
    lit = float(np.median(blocks.max(axis=-1)))
    print(f"[render] {what} {cfg.xres}x{cfg.yres} k={cfg.k} spp={cfg.samples}: "
          f"launches={launches} route={route_name(renderer.intersectors[0])} "
          f"mean={float(img.mean())} "
          f"median max over 4x4 blocks={lit} (per pixel {float(np.median(img.max(axis=-1)))}, "
          f"lit pixels {float((img.max(axis=-1) > 1e-3).mean()):.3f}) "
          f"compaction={getattr(renderer.intersectors[0], 'prefers_compaction', False)}")
    if {k: launches[k] for k in want} != want or any(
            n for k, n in launches.items() if k not in want):
        raise AssertionError(f"{what} launches {launches} != {want}")
    if not (np.isfinite(img).all() and img.shape == (yres, xres, 3) and lit > 1e-3):
        raise AssertionError(f"{what} render is not finite and lit")
    if not np.allclose(exported, img, rtol=2.0**-10, atol=1e-6):
        raise AssertionError(f"the exported {what} EXR does not read back as the render")


def beam_frame(cli, cc, repo, counts, card, tokens, out_name, what, want_pixels, exact_warm,
               turns, profiled=True):
    """The CLI render of ``tokens`` with ``CHIAROSCURO_BEAM_CULL=1`` (the
    user's switch to the beam cull K3b, read when the pair is made): two
    K3b launches a bounce in place of K3's and the route's visits, pixels
    bitwise equal to ``want_pixels`` (the exact-cull frame's), cold ms and
    warm ms (median of ``turns`` frames) beside ``exact_warm``, and a
    profiled frame where ``profiled``.  Returns the run's launches."""
    os.environ["CHIAROSCURO_BEAM_CULL"] = "1"
    try:
        renderer, launches, total, mem, exported = cli_render(cli, repo, counts, tokens,
                                                              out_name)
    finally:
        del os.environ["CHIAROSCURO_BEAM_CULL"]
    route = renderer.intersectors[0].route
    check_atrium_render(renderer, exported, launches,
                        route_launches(cc, route, cull="cull_beam"), f"{what}, beam cull",
                        ATRIUM_RES)
    differ = int((renderer.pixels.view(np.uint32) != want_pixels.view(np.uint32))
                 .any(axis=-1).sum())
    if differ:
        raise AssertionError(f"{what}: {differ} pixels of the beam-culled frame differ from "
                             "the exact-culled frame's")
    cold = renderer.last_stats["seconds"] * 1e3
    print(f"[timing] {card}: {what}, beam cull (CLI, cold): render {cold:.1f} ms/frame, CLI "
          f"total {total:.2f} s; {mem_text(mem)}")
    warm = frame_ms(renderer, turns)
    print(f"[beam] {card}: {what} through K3b (CHIAROSCURO_BEAM_CULL=1, route {route}): "
          f"pixels bitwise equal to the exact-cull frame's; warm {warm[0]:.1f} ms (frames "
          + ", ".join(f"{t:.1f}" for t in warm[1]) + f") against the exact cull's "
          f"{exact_warm:.1f} ms: {warm[0] / exact_warm:.3f}x")
    if profiled:
        profile_frame(renderer, card, f"{what}, beam cull")
    del renderer, exported
    torch.cuda.empty_cache()
    return launches


def profile(fn, label, card):
    """torch.profiler over one call of ``fn``: device time by layer (CUDA
    kernel names), busy share of the profiled wall time, and the kernels'
    per-launch times.  Returns {"wall_ms", "busy_ms", "layers": {layer:
    ms}}, or None where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    layers, per_launch, n_kernels = {}, {}, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0))
        if us <= 0:
            continue
        name = e.key
        n_kernels += e.count
        if "cull_rows_kernel" in name:
            layer = "K3 cull_rows"
        elif "cull_beam_kernel" in name:
            layer = "K3b cull_beam"
        elif "closest_visits_kernel" in name:
            layer = "K4/K6 closest_visits"
        elif "any_visits_kernel" in name:
            layer = "K5/K7 any_visits"
        elif "dense_kernel" in name:
            layer = "K1 closest_dense" if "losest" in name else "K2 any_dense"
        elif "bvh_closest_kernel" in name:
            layer = "B1 bvh_closest"
        elif "bvh_any_kernel" in name:
            layer = "B2 bvh_any"
        elif "sort" in name.lower() or "radix" in name.lower():
            layer = "sorts"
        elif "index" in name.lower() or "gather" in name.lower() or "scatter" in name.lower():
            layer = "gathers and scatters"
        elif "gemm" in name.lower() or "xmma" in name.lower() or "cutlass" in name.lower():
            layer = "matrix products (one-hot fetches)"
        else:
            layer = "integrator (elementwise, Threefry, reductions, copies)"
        layers[layer] = layers.get(layer, 0.0) + us
        if layer.startswith(("K", "B")):
            n_prev = per_launch.get(layer, (0.0, 0))[1]
            per_launch[layer] = (layers[layer] / (n_prev + e.count), n_prev + e.count)
    busy = sum(layers.values()) / 1e3
    if busy <= 0:
        print(f"[profile] {card}: {label}: torch.profiler recorded no device time: not measured")
        return None
    print(f"[profile] {card}: {label}: {wall_ms:.1f} ms profiled wall, {busy:.1f} ms device "
          f"busy (idle {100 * (1 - busy / wall_ms):.1f}%), {n_kernels} device kernels")
    for layer, us in sorted(layers.items(), key=lambda kv: -kv[1]):
        extra = ""
        if layer in per_launch:
            extra = f" ({per_launch[layer][1]} launches, {per_launch[layer][0] / 1e3:.2f} ms each)"
        print(f"[profile]   {layer}: {us / 1e3:.2f} ms ({100 * us / 1e3 / busy:.1f}% of busy){extra}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "layers": {k: us / 1e3 for k, us in layers.items()}}


def sass_counts(path):
    """{function: {opcode: count}} of the library at ``path`` (``cuobjdump
    -sass``; an opcode without its modifiers), or None where that failed."""
    from chiaroscuro_tpu_torch.ops.cuda_build import nvcc

    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=120) \
        if os.path.exists(tool) else None
    if proc is None or proc.returncode != 0:
        print(f"[build] cuobjdump -sass {os.path.basename(path)} failed: not counted")
        return None
    mixes, name = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            mixes[name] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if name is not None and m:
            mixes[name][m.group(1)] = mixes[name].get(m.group(1), 0) + 1
    return mixes


def sass_mix(path, kernel, per, what="box"):
    """Print the opcode counts of each compiled variant of ``kernel`` in the
    library at ``path`` (``cuobjdump -sass``), and where ``per`` > 1 each
    count / ``per``: for K3 the kernel's loop over a chunk of ``per`` boxes
    is fully unrolled, so that is the count per box (the code outside the
    loop adds a few)."""
    mixes = sass_counts(path)
    if mixes is None:
        return
    for name, mix in mixes.items():
        if kernel not in name:
            continue
        keys = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "SEL", "FSEL", "LOP3", "ISETP",
                "REDUX", "VOTE", "LDS", "LDG", "LD", "STS", "STG", "BAR", "SYNCS", "UBLKCP",
                "CCTL", "MUFU", "FCHK", "CALL", "BRA", "SHFL", "ATOMG", "ATOMS")
        parts = ", ".join(f"{k} {mix.get(k, 0)}" + (f" ({mix.get(k, 0) / per:.2f})" if per > 1
                                                     else "") for k in keys)
        print(f"[build] sass {name}: {sum(mix.values())} instructions"
              + (f"; per {what} of {per}" if per > 1 else "") + f": {parts}")


def graph_turns(fns, reps):
    """Microseconds a call of each named fn by CUDA events over replays of
    a CUDA graph that holds ``reps[name]`` calls (the host's launch cost
    left out), in turns as :func:`time_turns`."""
    graphs = {}
    for n, fn in fns.items():
        fn()
        sync()
        graphs[n] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[n]):
            for _ in range(reps[n]):
                fn()
    t = time_turns({n: g.replay for n, g in graphs.items()}, dict.fromkeys(graphs, R1_REPLAYS))
    del graphs
    torch.cuda.empty_cache()
    return {n: (u / reps[n], tuple(x / reps[n] for x in turns)) for n, (u, turns) in t.items()}


def straight_line_bound(mix, lanes, nbytes):
    """(bound_ms, bound_by) of a kernel without loops or branches taken by
    a full lane (its every instruction runs once a lane) from its compiled
    instruction mix: the INT32 pipe's instructions (ALU_OPS), IMAD on the
    FMA pipe, every instruction on the issue slots (twice the pipes' rate),
    and the bytes moved once."""
    alu = sum(mix.get(k, 0) for k in ALU_OPS)
    issued = sum(n for k, n in mix.items() if k != "NOP")
    t = {"the INT32 pipe": alu / PEAK_INT32, "IMAD on the FMA pipe": mix.get("IMAD", 0) / PEAK_INT32,
         "issue": issued / (2 * PEAK_INT32), "bytes": nbytes / PEAK_BYTES}
    by = max(t, key=t.get)
    return t[by] * lanes * 1e3, by


def streams_phase(tc, prng, card, dev):
    """Phase 2f: R1 bitwise its plain versions, then timed beside them and
    its bounds, at each of R1_LANES.  Returns {kernel: {lanes: {"us",
    "plain_us", "err", "bound", "counted"}}}."""
    mixes = sass_counts(tc.build()[1]["path"]) or {}
    out = {"threefry_bounce": {}, "threefry_raygen": {}}
    ext = torch.tensor(R1_EXTREMES, dtype=torch.int64)
    for lanes in R1_LANES:
        rows = lanes // 128
        g = torch.Generator().manual_seed(20261019 + lanes)
        k0, k1, smp_lanes = (torch.randint(0, 2**32, (rows, 128), generator=g, dtype=torch.int64)
                             for _ in range(3))
        # Every pair of extreme words in the first lanes.
        k0.view(-1)[:ext.numel() ** 2] = ext.repeat_interleave(ext.numel())
        k1.view(-1)[:ext.numel() ** 2] = ext.repeat(ext.numel())
        k0, k1, smp_lanes = k0.to(dev), k1.to(dev), smp_lanes.to(dev)
        pix = torch.arange(lanes, dtype=torch.int64, device=dev).reshape(rows, 128)
        smp = torch.tensor(2**32 - 1, dtype=torch.int64, device=dev)
        err = dict.fromkeys(out, 0.0)
        for bounce in R1_BOUNCES:
            got = tc.bounce_uniforms(k0, k1, bounce, prng.N_BOUNCE_DIMS)
            want = prng.bounce_uniforms_plain(k0, k1, bounce)
            if got.shape != want.shape or not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"R1 bounce {bounce} at {lanes} lanes differs from "
                                     "prng.bounce_uniforms_plain")
            err["threefry_bounce"] = max(err["threefry_bounce"], max_err(got, want))
        for what, s in (("a Python int", 2**31 + 5), ("a 0-dim tensor", smp),
                        ("one a lane", smp_lanes)):
            got = tc.raygen(R1_SEED, pix, s)
            want = prng.raygen_streams_plain(R1_SEED, pix, s)
            bad = [f for f, a, b in zip(("k0", "k1", "jx", "jy"), got, want)
                   if a.dtype != b.dtype or not torch.equal(bits(a), bits(b))]
            if bad:
                raise AssertionError(f"R1 raygen at {lanes} lanes, sample {what}: {bad} differ "
                                     "from prng.raygen_streams_plain")
            err["threefry_raygen"] = max([err["threefry_raygen"]] + [
                max_err(a, b) for a, b in zip(got[2:], want[2:])])
        print(f"[streams] R1 at {lanes} lanes: bounce bitwise prng.bounce_uniforms_plain at "
              f"bounces {R1_BOUNCES} (random keys, every pair of {R1_EXTREMES} in the first "
              "lanes); raygen bitwise prng.raygen_streams_plain for a Python-int, a 0-dim "
              "and a per-lane sample")
        # Timed as the frames run them: the pass's sample as a 0-dim tensor.
        calls = {
            "threefry_bounce": (lambda: tc.bounce_uniforms(k0, k1, 3, prng.N_BOUNCE_DIMS),
                                lambda: prng.bounce_uniforms_plain(k0, k1, 3),
                                R1_BOUNCE_OPS, R1_BOUNCE_BYTES),
            "threefry_raygen": (lambda: tc.raygen(R1_SEED, pix, smp),
                                lambda: prng.raygen_streams_plain(R1_SEED, pix, smp),
                                R1_RAYGEN_OPS, R1_RAYGEN_BYTES),
        }
        for name, (kern, plain, ops, nbytes) in calls.items():
            t = graph_turns({"plain": plain, "kernel": kern}, R1_REPS)
            us = t["kernel"][0]
            t_ops, t_bytes = ops * lanes / PEAK_INT32, nbytes * lanes / PEAK_BYTES
            counted = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
            mix = next((m for f, m in mixes.items() if f"{name}_kernel" in f), None)
            sass = None if mix is None else straight_line_bound(mix, lanes, nbytes)
            parts = [f"kernel {us:.2f} us (turns {t['kernel'][1][0]:.2f}, "
                     f"{t['kernel'][1][1]:.2f})",
                     f"plain int64 chain {t['plain'][0]:.1f} us ({t['plain'][0] / us:.0f}x)",
                     f"counted bound {counted[0] * 1e3:.2f} us ({counted[1]}: {ops} integer "
                     f"operations and {nbytes} B a lane; the kernel at "
                     f"{100 * counted[0] * 1e3 / us:.1f}% of it)"]
            if mix is not None:
                issued = sum(n for k, n in mix.items() if k != "NOP")
                parts.append(
                    f"compiled: {issued} instructions a lane, {sum(mix.get(k, 0) for k in ALU_OPS)} "
                    f"on the INT32 pipe, {mix.get('IMAD', 0)} IMAD; bound {sass[0] * 1e3:.2f} us "
                    f"({sass[1]}; the kernel at {100 * sass[0] * 1e3 / us:.1f}% of it)")
            print(f"[timing] {card}: R1 {name} at {lanes} lanes (CUDA events over replays of "
                  f"a graph of {R1_REPS['kernel']} launches, {R1_REPS['plain']} plain calls): "
                  + "; ".join(parts))
            out[name][lanes] = {"us": us, "plain_us": t["plain"][0], "err": err[name],
                                "bound": counted if sass is None else sass, "counted": counted}
    return out


def device_us(fn, reps, name=None):
    """Device time of ``fn`` over ``reps`` calls by torch.profiler:
    (microseconds a kernel, the kernels recorded), over the CUDA kernels
    the calls ran (only those whose name holds ``name``, where given);
    (None, 0) where it recorded none.  The profiler can record fewer
    kernels than the calls ran, so the count is printed beside each reading
    and the mean is taken over the kernels it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and (name is None or name in e.key)]
    us = sum(float(getattr(e, "self_device_time_total", 0.0)) for e in events)
    n = sum(int(e.count) for e in events)
    return (us / n if us > 0 and n else None), n


def profile_frame(renderer, card, what=None):
    """:func:`profile` over one warm frame of a CLI renderer."""
    cfg = renderer.cfg
    profile(lambda: renderer.ray_trace(cfg.vp, cfg.la, cfg.up, cfg.yview),
            f"{what or cfg.obj_path} {cfg.xres}x{cfg.yres} k={cfg.k} spp={cfg.samples}, one "
            "warm frame", card)


# ---------------------------------------------------------------------------
# Phase 3g: the BVH walks B1/B2 and the preview.
# ---------------------------------------------------------------------------

# FP32 operations of one slab test of B1/B2 (csrc/bvh_traverse.cu box_hit):
# per axis 2 sub, 2 mul, min, max (18); near and far across axes 4; the
# three compares 3.  Its six NaN checks are not counted.
BOX_OPS = 25


def rows_of(x3):
    """(3, B0, 128) planar -> (R, 3) contiguous rows."""
    return x3.reshape(3, -1).T.contiguous()


def bvh_bytes(b):
    """Bytes the BVH holds on the card."""
    held = [getattr(b, f.name) for f in dataclasses.fields(b)]
    return sum(t.numel() * t.element_size() for t in held if isinstance(t, torch.Tensor))


def bvh_table_bytes(b, seen, hit_ids):
    """Bytes of the BVH that walks must read, from the plain walk's ``seen``
    = (node mask, slot mask): each node visited (two float4, 32 bytes), the
    leaf_start of each leaf tested (4; its first slot is tested first), each
    triangle slot tested (48), and a tri_order entry (4) for each distinct
    id in ``hit_ids`` (B1's hits; None for B2, whose blocker reads are not
    marked and so not counted)."""
    nodes, slots = seen
    leaves = nodes & (b.leaf_count > 0) & slots[b.leaf_start.clamp_min(0).long()]
    ids = 0 if hit_ids is None else torch.unique(hit_ids).numel()
    return 32 * int(nodes.sum()) + 4 * int(leaves.sum()) + 48 * int(slots.sum()) + 4 * ids


def walk_ops(steps, tests, order=None, lanes=32):
    """(per-lane, per-warp) FP32 operations of walks whose per-ray
    ``steps`` and leaf ``tests`` are given (R,) integer tensors.  Per lane:
    BOX_OPS a step and MT_OPS a test, summed over the rays.  Per warp: the
    rays taken ``lanes`` at a time in ``order`` (a permutation of the rays;
    their own order where None, the last warp padded with empty walks),
    each warp paying ``lanes x (BOX_OPS x its most steps + MT_OPS x its most
    tests)``: what a design of one thread a ray pays when a warp waits for
    its longest walk and gets no new rays meanwhile."""
    steps, tests = steps.long(), tests.long()
    lane = BOX_OPS * int(steps.sum()) + MT_OPS * int(tests.sum())
    if order is not None:
        steps, tests = steps[order], tests[order]
    pad = (-steps.numel()) % lanes
    if pad:
        zeros = torch.zeros(pad, dtype=torch.long, device=steps.device)
        steps, tests = torch.cat([steps, zeros]), torch.cat([tests, zeros])
    warp = lanes * (BOX_OPS * int(steps.view(-1, lanes).amax(1).sum())
                    + MT_OPS * int(tests.view(-1, lanes).amax(1).sum()))
    return lane, warp


def bvh_bound(n_rays, counts, table_bytes, occlusion):
    """(bound_ms, bound_by) of B1 (B2 with ``occlusion``) on ``n_rays``
    rays: the walks' per-lane operations (:func:`walk_ops` of their (steps,
    tests) ``counts``) over the unfused FP32 rate; the rays read once (B2:
    and their tmax and exclude ids), the outputs written once (B1 17 bytes
    a ray, B2 1) and ``table_bytes`` of the BVH (:func:`bvh_table_bytes`),
    over the memory rate."""
    ops, _ = walk_ops(*counts)
    ray_bytes = n_rays * ((24 + 8 + 1) if occlusion else (24 + 17))
    return bound(ops, table_bytes + ray_bytes)


def bvh_warp_bound(counts, order=None):
    """(bound_ms, SIMT efficiency) of walks with per-ray ``counts`` (steps,
    tests) per warp (:func:`walk_ops`, 32 consecutive rays in ``order``
    where given), over the unfused FP32 rate; the efficiency is the
    per-lane operations over the per-warp ones."""
    lane, warp = walk_ops(*counts, order=order)
    return warp / PEAK_FP32_UNFUSED * 1e3, lane / warp


def bvh_walks(bc, bvh_mod, b, waves, rng, card, label, beside, sample_rows=ROW_SAMPLE):
    """B1 on the primary and bounce wavefronts and B2 on the NEE shadow one
    of a frame (``atrium_wavefronts``, as rows): bitwise equal to the plain walk on
    ``sample_rows`` seeded rows of 128 rays, with equal per-ray step and
    leaf-test counts; the kernel timed on the sample and on every row, the
    plain walk on the sample, each beside its bound: the operations of the
    sample's from the plain walk's counts, of every row's from the kernel's
    (which equal them on the sample); the BVH bytes of both those that the
    sample's walks touch (every row's walks touch at least those).  Every
    row's walks are also bounded per warp (:func:`bvh_warp_bound`), in
    wavefront order and in a seeded random order.  Also the other kernels'
    times on the same wavefront (``beside``: {wavefront: text}).  Returns
    ({wavefront: {us, plain_us, bound, all_us, all_bound, warp_bound}}, the
    largest |kernel - plain|)."""
    out, err = {}, 0.0
    for wname in ("primary", "bounce", "shadow"):
        o3, d3, tmax, excl = waves[wname][:4]
        nB0 = o3.shape[1]
        pick = torch.from_numpy(rng.choice(nB0, min(sample_rows, nB0),
                                           replace=False)).to(o3.device)
        every = (rows_of(o3), rows_of(d3))
        sample = (rows_of(o3[:, pick]), rows_of(d3[:, pick]))
        occlusion = tmax is not None
        if occlusion:
            every += (tmax.reshape(-1).contiguous(), excl.reshape(-1).contiguous())
            sample += (tmax[pick].reshape(-1).contiguous(), excl[pick].reshape(-1).contiguous())

        def kern(args, counts=False):
            fn = bc.any_bvh if occlusion else bc.closest_bvh
            return fn(b, *args, counts=counts)

        def plain(args, counts=False, seen=None):
            fn = bvh_mod.bvh_any if occlusion else bvh_mod.bvh_closest
            return fn(b, *args, counts=counts, seen=seen)

        seen = (torch.zeros(b.n_nodes, dtype=torch.bool, device=b.device),
                torch.zeros(b.tri_order.shape[0], dtype=torch.bool, device=b.device))
        got, want = kern(sample, True), plain(sample, True, seen)
        sync()
        outs = ("occluded",) if occlusion else ("hit", "t", "tid", "u", "v")
        bad = [f for f, a, w in zip(outs, got[:-1], want[:-1]) if not torch.equal(bits(a), bits(w))]
        bad += [f for f, a, w in zip(("steps", "tests"), got[-1], want[-1]) if not torch.equal(a, w)]
        err = max([err] + [max_err(a.float(), w.float()) for a, w in zip(got[:-1], want[:-1])])
        kid = "B2" if occlusion else "B1"
        if bad:
            raise AssertionError(f"{kid} {label} {wname}: kernel differs from the plain walk in {bad}")
        t = time_turns({"plain": lambda: plain(sample), "kernel": lambda: kern(sample)},
                       {"plain": 1, "kernel": 10})
        t_all = time_turns({"kernel": lambda: kern(every)}, {"kernel": 5})
        all_counts = kern(every, True)[-1]
        n_s, n_all = sample[0].shape[0], every[0].shape[0]
        table_bytes = bvh_table_bytes(b, seen, None if occlusion else want[2][want[0]])
        bd = bvh_bound(n_s, want[-1], table_bytes, occlusion)
        bd_all = bvh_bound(n_all, all_counts, table_bytes, occlusion)
        warp = bvh_warp_bound(all_counts)
        warp_r = bvh_warp_bound(all_counts, torch.from_numpy(rng.permutation(n_all)).to(o3.device))
        share = float(want[0].float().mean())
        print(f"[bvh] {card}: {kid} {label} {wname}: sample of {len(pick)} rows ({n_s} rays, "
              f"{'occluded' if occlusion else 'hit'} share {share:.4f}, steps mean "
              f"{float(want[-1][0].float().mean()):.1f} max {int(want[-1][0].max())}, leaf tests "
              f"mean {float(want[-1][1].float().mean()):.1f}): kernel {t['kernel'][0]:.1f} us "
              f"(turns {t['kernel'][1][0]:.1f}, {t['kernel'][1][1]:.1f}), plain "
              f"{t['plain'][0]:.1f} us, bound {bd[0] * 1e3:.1f} us ({bd[1]}; "
              f"{100 * bd[0] * 1e3 / t['kernel'][0]:.1f}% of it); all {nB0} rows ({n_all} rays, "
              f"steps mean {float(all_counts[0].float().mean()):.1f} max {int(all_counts[0].max())}"
              f", leaf tests mean {float(all_counts[1].float().mean()):.1f}): kernel "
              f"{t_all['kernel'][0]:.1f} us (turns {t_all['kernel'][1][0]:.1f}, "
              f"{t_all['kernel'][1][1]:.1f}), bound {bd_all[0] * 1e3:.1f} us ({bd_all[1]}; "
              f"{100 * bd_all[0] * 1e3 / t_all['kernel'][0]:.1f}% of it), per warp "
              f"{warp[0] * 1e3:.1f} us ({100 * warp[0] * 1e3 / t_all['kernel'][0]:.1f}% of it; "
              f"SIMT {warp[1]:.3f}; in a random order {warp_r[0] * 1e3:.1f} us, SIMT "
              f"{warp_r[1]:.3f}); {beside.get(wname, '')}")
        out[wname] = dict(us=t["kernel"][0], plain_us=t["plain"][0], bound=bd,
                          all_us=t_all["kernel"][0], all_bound=bd_all, warp_bound=warp)
    return out, err


def cluster_beside(timings, route):
    """{wavefront: the cluster route's times on it} from a scene's phase 2b
    or 2c timings, for :func:`bvh_walks`."""
    closest, occlusion = {"stream": ("closest_cluster", "any_cluster"),
                          "resident": ("closest_resident", "any_resident")}[route]
    out = {}
    for wname, k in (("primary", closest), ("bounce", closest), ("shadow", occlusion)):
        v, cull = timings.get((k, wname)), timings.get(("cull", wname))
        if v is None or cull is None:
            continue
        out[wname] = (f"{KERNEL_IDS[k]} on the same wavefront (phase 2b/2c): {v['full_us']:.1f} us "
                      f"on all rows after K3's {cull['us']:.1f} us cull ({v['us']:.1f} us on its "
                      f"own {ROW_SAMPLE}-row sample)")
    return out


# ---------------------------------------------------------------------------
# Phase 3f: Phong, spp_batch, state and profile.
# ---------------------------------------------------------------------------


def glossy(meshes, ks, ns, only=None):
    """The meshes with Ks ``ks`` and Ns ``ns`` on every non-emissive mesh
    (on those whose name holds ``only``, where given)."""
    for m in meshes:
        if not m.is_light and (only is None or only in m.name):
            m.specular = np.full(3, ks, np.float32)
            m.shininess = float(ns)
    return meshes


def write_obj(meshes, path):
    """Write meshes as an OBJ and its MTL (one object and material per mesh,
    per-corner positions, texcoords and normals), as the OBJ loader reads
    them back: texcoords flipped to undo its FlipUVs."""
    base = os.path.splitext(path)[0]
    obj, mtl = [f"mtllib {os.path.basename(base)}.mtl"], []
    n = 0
    for i, m in enumerate(meshes):
        mtl += [f"newmtl m{i}", "Kd " + " ".join(map(repr, map(float, m.diffuse))),
                "Ke " + " ".join(map(repr, map(float, m.emissive))),
                "Ks " + " ".join(map(repr, map(float, m.specular))),
                f"Ns {float(m.shininess)!r}"]
        obj += [f"o {m.name.split(':')[0]}", f"usemtl m{i}"]
        obj += ["v " + " ".join(map(repr, map(float, p))) for p in m.positions]
        obj += [f"vt {float(u)!r} {float(1.0 - v)!r}" for u, v in m.uvs]
        obj += ["vn " + " ".join(map(repr, map(float, q))) for q in m.normals]
        obj += ["f " + " ".join(f"{n + j + 1}/{n + j + 1}/{n + j + 1}" for j in tri)
                for tri in m.indices]
        n += len(m.positions)
    with open(path, "w") as f:
        f.write("\n".join(obj) + "\n")
    with open(base + ".mtl", "w") as f:
        f.write("\n".join(mtl) + "\n")


def box_top_pixels(scene, cfg, ic):
    """(yres, xres) bool: the pixels whose centre ray first hits a block's
    top face (the glossy blocks' triangles facing +y), by the scene's
    own closest-hit query."""
    from chiaroscuro_tpu_torch.geometry.camera import camera_basis, primary_ray_dirs
    from chiaroscuro_tpu_torch.scene.scene_arrays import BRDF_PHONG

    dev = scene.device
    lu, dx, dy = (torch.from_numpy(x).to(dev) for x in camera_basis(
        cfg.vp, cfg.la, cfg.up, cfg.yview, cfg.xres, cfg.yres))
    ys, xs = torch.meshgrid(torch.arange(cfg.yres, device=dev),
                            torch.arange(cfg.xres, device=dev), indexing="ij")
    d = primary_ray_dirs(lu, dx, dy, xs.reshape(-1).float(), ys.reshape(-1).float(), 0.5, 0.5)
    o = torch.as_tensor(cfg.vp, dtype=torch.float32, device=dev).expand_as(d).contiguous()
    res = ic.make_dense_intersectors(scene)[0](o, d.contiguous())
    top = (scene.brdf_type == BRDF_PHONG) & (scene.normal[:, 1] > 0.9)
    return (res.hit & top[res.tid.long()]).reshape(cfg.yres, cfg.xres).cpu().numpy()


def frame_ms(renderer, turns=3):
    """Median ms of ``turns`` warm frames of a renderer (its own wall clock,
    which waits for the card)."""
    cfg = renderer.cfg
    times = []
    for _ in range(turns):
        renderer.ray_trace(cfg.vp, cfg.la, cfg.up, cfg.yview)
        times.append(renderer.last_stats["seconds"] * 1e3)
    return float(np.median(times)), times


# ---------------------------------------------------------------------------
# Phase 5: gradients.
# ---------------------------------------------------------------------------


def grad_run(scene, cam, res, spp, depth, fields, pair_of, checkpoint=False, counts=(),
             spp_batch=1):
    """Value and gradients of the mean image w.r.t. ``fields``, the
    intersectors rebuilt on the parameter-substituted scene by
    ``pair_of(scene)`` (``spp_batch`` samples a wavefront).  Returns (loss, {field: grad on the CPU}, launches,
    seconds, (peak device memory, device memory held when the run began) or
    (0, 0))."""
    from chiaroscuro_tpu_torch.render.renderer import render_samples
    from chiaroscuro_tpu_torch.scene.scene_arrays import params_from_numpy

    dev = scene.device
    xres, yres = res
    ys, xs = torch.meshgrid(torch.arange(yres, device=dev), torch.arange(xres, device=dev),
                            indexing="ij")
    held = 0
    if dev.type == "cuda":
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    reset(*counts)
    t0 = time.perf_counter()
    params = params_from_numpy({k: getattr(scene, k).cpu().numpy() for k in fields}, dev)
    s = scene.replace(**params)
    cf, af = pair_of(s)
    img = render_samples(s, cam["eye"], cam["center"], cam["up"], cam["yview"], xres, yres,
                         xs.reshape(-1), ys.reshape(-1), 0, spp, 0, depth, (0.0, 0.0, 0.0),
                         cf, af, checkpoint=checkpoint, spp_batch=spp_batch)
    loss = img.mean()
    loss.backward()
    grads = {k: v.grad.cpu() for k, v in params.items()}
    seconds = time.perf_counter() - t0
    launches = {k: v for c in counts for k, v in c.items() if v}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return float(loss.detach()), grads, launches, seconds, (peak, held)


def fetch_ab(ic, card, scene, pair_of, counts):
    """Phase 5(iv): Cornell 512x512 x 2 spp x k 3 fwd+bwd (checkpointed)
    w.r.t. (kd, ke) and w.r.t. (kd, ke) and the vertices, each profiled in
    turns one-hot, gather, gather, one-hot: the backward's row fetch by the
    JAX package's rule (the product: 36 triangles, 2 lights) and with the
    gather forced (``ic._BWD_ONEHOT = False``, what
    ``CHIAROSCURO_BWD_ONEHOT=0`` sets at import; the light row stays a
    product).  Prints each form's mean wall, busy and idle and its
    "gathers and scatters" and products' device ms; the one-hot turns'
    gradients must be bitwise equal.  Returns {(fields, form): summary}."""
    from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA

    summary = {}
    for label, fields in (("(kd, ke)", ("kd", "ke")),
                          ("(kd, ke, vertices)", ("kd", "ke", "tri_v0", "tri_v1", "tri_v2"))):
        runs = {"one-hot": [], "gather": []}
        for form in ("one-hot", "gather", "gather", "one-hot"):
            ic._BWD_ONEHOT = None if form == "one-hot" else False
            held = []
            try:
                prof = profile(lambda: held.append(grad_run(
                    scene, CORNELL_CAMERA, (512, 512), 2, 3, fields, pair_of,
                    checkpoint=True, counts=counts)),
                    f"cornell 512x512 x 2 spp x k3 fwd+bwd w.r.t. {label}, checkpoint=True, "
                    f"backward fetch {form}", card)
            finally:
                ic._BWD_ONEHOT = None
            runs[form].append((prof, held[0]))
        a, b = (g[1][1] for g in runs["one-hot"])
        same = all(torch.equal(bits(a[k]), bits(b[k])) for k in fields)
        g_same = all(torch.equal(bits(x[k]), bits(y[k])) for k in fields
                     for x, y in [tuple(g[1][1] for g in runs["gather"])])
        for form, rs in runs.items():
            profs = [p for p, _ in rs if p is not None]
            if not profs:
                print(f"[fetch] {card}: {label} {form}: device time not measured")
                continue
            mean = lambda f: sum(f(p) for p in profs) / len(profs)
            busy, wall = mean(lambda p: p["busy_ms"]), mean(lambda p: p["wall_ms"])
            gat = mean(lambda p: p["layers"].get("gathers and scatters", 0.0))
            mm = mean(lambda p: p["layers"].get("matrix products (one-hot fetches)", 0.0))
            summary[(label, form)] = dict(wall_ms=wall, busy_ms=busy, gathers_ms=gat,
                                          products_ms=mm, seconds=[r[1][3] for r in rs])
            print(f"[fetch] {card}: cornell 512x512 x 2 spp x k3 fwd+bwd w.r.t. {label}, "
                  f"backward fetch {form}, mean of {len(profs)} profiled turns: wall "
                  f"{wall:.1f} ms, busy {busy:.1f} ms (idle {100 * (1 - busy / wall):.1f}%), "
                  f"gathers and scatters {gat:.2f} ms ({100 * gat / busy:.1f}% of busy), "
                  f"matrix products {mm:.2f} ms; turns' wall s "
                  + ", ".join(f"{r[1][3]:.3f}" for r in rs))
        print(f"[fetch] {card}: {label}: the two one-hot turns' gradients bitwise equal: "
              f"{same}; the two gather turns': {g_same}")
        if not same:
            raise AssertionError(f"{label}: two one-hot fwd+bwd runs' gradients differ")
    return summary


def s1_checks(sc, card, calls):
    """S1 on the (cotangent, ids, rows) of each gather's backward that
    phase 5(ii) recorded: the ids' histogram; the sum bitwise equal to its
    plain version (run on the CPU) and to a second sum; in us a call by
    CUDA events, in turns, the sum as the backward calls it, its plain
    version on the card's tensors and ATen's ``index_put_(accumulate=True)``
    (the gather's backward before S1, on the cotangent's (N, W) view), and
    apart the sort and the rest (the zeroed table and the kernels).  The
    bound: the cotangent and the int32 ids read once, the table written
    once.  Returns one dict a call."""
    out = []
    for i, (ct, tid, rows) in enumerate(calls):
        W, N = ct.shape[0], tid.numel()
        ids = tid.reshape(-1)
        lids = ids.long()
        per_id = torch.bincount(lids)
        got = sc.scatter_rows_sum(ct, tid, rows)
        again = sc.scatter_rows_sum(ct, tid, rows)
        plain = sc.scatter_rows_sum_plain(ct.cpu(), tid.cpu(), rows)
        if not (torch.equal(bits(got.cpu()), bits(plain)) and torch.equal(bits(got), bits(again))):
            raise AssertionError(f"S1 on the 262k step's call {i}: not bitwise equal to its "
                                 "plain version or to a second sum")

        def library():
            return torch.zeros((rows, W), device=ct.device).index_put_(
                (lids,), ct.reshape(W, N).T, accumulate=True)

        aten = library()
        t = time_turns({"plain": lambda: sc.scatter_rows_sum_plain(ct, tid, rows),
                        "s1": lambda: sc.scatter_rows_sum(ct, tid, rows),
                        "library": library}, {"plain": 2, "s1": 20, "library": 3})
        keys, perm = torch.sort(ids, stable=True)
        sort_us = time_us(lambda: torch.sort(ids, stable=True), 20)
        rest_us = time_us(lambda: sc._sum_sorted(ct, keys, perm, rows), 20)
        bnd = bound(N * W, N * W * 4 + N * 4 + rows * W * 4)
        r = {"err": max_err(got.cpu(), plain), "us": t["s1"][0], "plain_us": t["plain"][0],
             "library_us": t["library"][0], "bound": bnd}
        out.append(r)
        print(f"[s1] {card}: the 262k step's gather backward, call {i} of {len(calls)} in "
              f"backward order: {N} lanes x {W} into {rows} rows, "
              f"{100 * float((ids == 0).float().mean()):.4f}% at id 0, longest segment "
              f"{int(per_id.max())}, {int((per_id > 0).sum())} distinct ids; bitwise equal to "
              f"its plain version (CPU) and to a second sum; sum {r['us']:.1f} us (turns "
              f"{t['s1'][1][0]:.1f}, {t['s1'][1][1]:.1f}): sort {sort_us:.1f}, the zeroed table "
              f"and the kernels {rest_us:.1f}; bound {bnd[0] * 1e3:.1f} us ({bnd[1]}: the "
              f"cotangent and ids read once, the table written once), the sum at "
              f"{100 * bnd[0] * 1e3 / r['us']:.1f}% of it; plain {r['plain_us']:.1f} us; ATen's "
              f"index_put_(accumulate=True) {r['library_us']:.1f} us, |S1 - ATen| "
              f"{max_err(got, aten)} at entries up to {float(aten.abs().max())}")
    return out


def compare_grads(what, card, cpu, rel=1e-3):
    """Card gradients against the CPU's: per field, sum |d| <= rel x sum
    |g_cpu| (a path that an ulp of a CUDA vs CPU transcendental turned moves
    a few entries, as it moves a few pixels of a render), and the loss to
    rtol 1e-4."""
    (l_card, g_card), (l_cpu, g_cpu) = card, cpu
    print(f"[grad] {what}: loss card {l_card} cpu {l_cpu}")
    ok = abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    for k, ref in g_cpu.items():
        got = g_card[k]
        d = (got.double() - ref.double()).abs()
        l1 = float(d.sum()) / max(float(ref.double().abs().sum()), 1e-30)
        print(f"[grad]   d/d{k}: sum|card-cpu|/sum|cpu|={l1}, max|card-cpu|={float(d.max())} "
              f"(max|cpu|={float(ref.abs().max())}), finite={bool(torch.isfinite(got).all())}")
        ok = ok and l1 <= rel and bool(torch.isfinite(got).all())
    if not ok:
        raise AssertionError(f"{what}: card gradients differ from the CPU's")


# ---------------------------------------------------------------------------
# Phase 7: the sharded path.
# ---------------------------------------------------------------------------


def shard_jobs(ps, RenderConfig, repo, cam):
    """Phase 7's frames and gradient steps, as ``parallel/scaling.RankJob``s."""
    atrium_tokens = ["input", "synthetic:atrium", "xres", str(ATRIUM_RES[0]), "yres",
                     str(ATRIUM_RES[1]), "samples", "1", "k", str(ATRIUM_K), *cam]
    cornell = RenderConfig.from_rtc(os.path.join(repo, "scenes", "cornell.rtc"),
                                    ["samples", str(SHARD_SPP), "no-preview"])
    frames = [ps.RankJob(cornell),
              ps.RankJob(RenderConfig.from_tokens(atrium_tokens + ["intersector", "auto"])),
              ps.RankJob(RenderConfig.from_tokens(atrium_tokens + ["intersector", "bvh"]))]
    grad_cornell = RenderConfig.from_rtc(
        os.path.join(repo, "scenes", "cornell.rtc"),
        ["samples", "2", "xres", str(SHARD_GRAD_RES[0]), "yres", str(SHARD_GRAD_RES[1]),
         "intersector", "dense", "no-preview"])
    grad_mid = RenderConfig.from_tokens(
        atrium_tokens + ["input", f"synthetic:atrium:{MID_TRIS}", "intersector", "cluster"])
    grads = [ps.RankJob(grad_cornell, fields=("kd", "ke", "tri_v0", "tri_v1", "tri_v2")),
             ps.RankJob(grad_mid, fields=("kd", "ke"), checkpoint=True)]
    return frames, grads


def shard_frame_want(cc, job):
    """The launches one rank makes for a phase 7 frame: its path's kernels
    once a sample x bounce (the cluster path culls twice), and the sample
    streams' raygen kernel once a sample, their bounce kernel once a sample
    x bounce."""
    cfg = job.cfg
    per = {"auto": {"closest": 1, "any": 1}, "bvh": {"bvh_closest": 1, "bvh_any": 1}}
    if cfg.obj_path.startswith("synthetic:") and cfg.intersector == "auto":
        closest, occlusion = cc.ROUTES["stream"]
        per["auto"] = {"cull": 2, closest: 1, occlusion: 1}
    return {**{k: m * cfg.samples * cfg.k for k, m in per[cfg.intersector].items()},
            "threefry_raygen": cfg.samples, "threefry_bounce": cfg.samples * cfg.k}


def shard_label(job):
    cfg = job.cfg
    return (f"{cfg.obj_path} {cfg.xres}x{cfg.yres} x {cfg.samples} spp x k{cfg.k} "
            f"({cfg.intersector})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from chiaroscuro_tpu_torch import cli
    from chiaroscuro_tpu_torch.accel.clusters import build_clusters
    from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
    from chiaroscuro_tpu_torch.accel import bvh as bvh_mod
    from chiaroscuro_tpu_torch.ops import bvh_cuda as bc
    from chiaroscuro_tpu_torch.ops import cluster_cuda as cc
    from chiaroscuro_tpu_torch.ops import cuda_build
    from chiaroscuro_tpu_torch.ops import intersect_cuda as ic
    from chiaroscuro_tpu_torch.ops import scatter_cuda, threefry_cuda
    from chiaroscuro_tpu_torch.render import image_io
    from chiaroscuro_tpu_torch.render.renderer import render_image, render_samples
    from chiaroscuro_tpu_torch.sampling import prng
    from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA, cornell_box
    from chiaroscuro_tpu_torch.scene.config import RenderConfig
    from chiaroscuro_tpu_torch.scene.obj_loader import load_obj
    from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors, load_scene
    from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA, atrium
    from chiaroscuro_tpu_torch.tools import cull_experiments as xc
    from chiaroscuro_tpu_torch.tools import dma_min as dm
    from chiaroscuro_tpu_torch.tools.dense_compare import (cam_tokens, dense_wavefronts,
                                                           make_queries, soup)

    t_start = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    counts = (ic.LAUNCHES, cc.LAUNCHES, bc.LAUNCHES, scatter_cuda.LAUNCHES)
    # Summed over the CLI runs; the sample streams' (R1, every render's) over
    # phases 3-3g whole and phase 7's ranks.
    main_launches = {k: 0 for c in counts + (threefry_cuda.LAUNCHES,) for k in c}

    def add_launches(launches):
        for k, n in launches.items():
            main_launches[k] += n

    lap_t = [t_start]

    def lap(phase):
        """Print the seconds since the last lap: where the smoke's time goes."""
        now = time.perf_counter()
        print(f"[smoke] {phase}: {now - lap_t[0]:.1f} s")
        lap_t[0] = now

    # --- phase 1: device and build ------------------------------------------
    print(f"[device] nvidia-smi: {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {kind} x{count}")
    t0 = time.perf_counter()
    builders = (ic.build, cc.build_cull, cc.build_cull_beam, cc.build, xc.build, dm.build,
                bc.build, scatter_cuda.build, threefry_cuda.build,
                lambda: cuda_build.build_host_library("bvh_builder"))
    with ThreadPoolExecutor(len(builders)) as pool:
        infos = [f.result()[1] for f in [pool.submit(b) for b in builders]]
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f} s (one nvcc each, and g++ "
          "for the native BVH builder, in parallel)")
    for info in infos:
        print(f"[build] {os.path.relpath(info['path'], repo)}: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {line.strip()}")
    sass_mix(cc.build_cull()[1]["path"], "cull_rows_kernel", CULL_CHUNK)
    # K3b: the whole mix of each variant (the sweep's FMNMX against its
    # FMUL and FADD; ATOMS, VOTE and BAR the selection's).
    sass_mix(cc.build_cull_beam()[1]["path"], "cull_beam_kernel", 1)
    # K1/K2: each kernel's whole instruction mix (MUFU and CALL show how 1/a
    # compiles, VOTE the warp votes).
    sass_mix(ic.build()[1]["path"], "dense_kernel", 1)
    # The visits at M = 128: the visit is inlined twice (phase 1 and phase
    # 2), each an unrolled loop body of 8 triangles (two 4-triangle loads),
    # so counts / 16 approximate the instructions a triangle (the walk adds
    # a few).
    sass_mix(cc.build()[1]["path"], "ILi128E", 16, "triangle (2 inlined visits x 8)")
    # R1: each kernel's whole mix (straight-line code: phase 2f bounds it).
    sass_mix(threefry_cuda.build()[1]["path"], "threefry_", 1)
    print(f"[build] K4/K6 at M = 128: {cc.build()[0].closest_visits_smem_bytes(128)} B of "
          "dynamic shared memory a block (its warps' rings and mbarriers); K5/K7 none")

    lap("phase 1")
    # --- phase 2: dense kernels vs plain ---------------------------------------
    rng = np.random.default_rng(20261016)
    cornell = build_scene_tensors(cornell_box(), device=dev)
    c_rows = ic._prep_tris(cornell.tri_v0, cornell.tri_v1, cornell.tri_v2)
    c_attrs = ic._prep_attrs(cornell)
    c_q = make_queries(rng, cornell.world_min.cpu().numpy(),
                       cornell.world_max.cpu().numpy(), cornell.n_tris, dev)
    (sv0, sv1, sv2, s_attrs), s_lo, s_hi = soup(rng, SOUP_TRIS, dev)
    s_rows = ic._prep_tris(sv0, sv1, sv2)
    s_q = make_queries(rng, s_lo, s_hi, SOUP_TRIS, dev)
    with torch.no_grad():
        err = max(
            compare_kernels(ic, "cornell", c_rows, c_attrs, c_q),
            compare_kernels(ic, "soup", s_rows, s_attrs, s_q),
        )
        dense_bound = dense_bounds(ic, c_rows, c_q)
        soup_bound = dense_bounds(ic, s_rows, s_q)
    for what, bd in (("cornell", dense_bound), ("soup", soup_bound)):
        print(f"[kernels] bounds on the {what} queries: " + ", ".join(
            f"{k} {b_ms * 1e3:.1f} us ({b_by}; {stop:.4f} of the tests stopped after u)"
            for k, (b_ms, b_by, stop) in bd.items()))
    print("[kernels] K1/K2 equal their plain versions bitwise")
    sync()

    lap("phase 2")
    # --- phase 2e: the dense pair's own wavefronts ---------------------------
    cam = cam_tokens(ATRIUM_CAMERA)
    bvh_errs = []     # B1/B2's largest |kernel - plain| of phases 2e and 2d
    cornell_rtc = os.path.join(repo, "scenes", "cornell.rtc")
    a4_tokens = ["input", f"synthetic:atrium:{DENSE_ATRIUM_TRIS}", "intersector", "auto",
                 "xres", str(ATRIUM_RES[0]), "yres", str(ATRIUM_RES[1]), "samples", "1",
                 "k", str(ATRIUM_K), *cam]
    with torch.no_grad():
        for label, cfg_ in (("cornell 768x768", RenderConfig.from_rtc(cornell_rtc)),
                            (f"atrium:{DENSE_ATRIUM_TRIS} 1280x720",
                             RenderConfig.from_rtc(cornell_rtc, a4_tokens))):
            sc = load_scene(cfg_, dev)
            rows_ = ic._prep_tris(sc.tri_v0, sc.tri_v1, sc.tri_v2)
            attrs_, table_ = ic._prep_attrs(sc), ic.pad_table(rows_)
            waves_ = dense_wavefronts(cfg_, sc, make_intersectors, render_samples)
            err = max(err, check_wavefronts(ic, label, rows_, attrs_, table_, waves_))
            bounds_ = {w: dense_bounds(ic, rows_, q, closest="tmax" not in q,
                                       occlusion="tmax" in q) for w, q in waves_.items()}
            print(f"[dense] {label}: T={sc.n_tris}; bounds " + ", ".join(
                f"{w} {k} {b[0] * 1e3:.1f} us ({b[1]}; {b[2]:.4f} stopped after u)"
                for w, bd in bounds_.items() for k, b in bd.items()))
            dense_t = {w: time_dense(ic, card, f"{label} {w}", rows_, attrs_, table_, q,
                                     bounds_[w])
                       for w, q in waves_.items()}
            n_dense_tris = sc.n_tris
            if label.startswith("atrium"):
                # Phase 3g(f): B1/B2 on the same rays, while they are held.
                a4_bvh = bvh_mod.build_bvh(sc)
                if a4_bvh.builder != "native":
                    raise AssertionError(f"the atrium:{DENSE_ATRIUM_TRIS} BVH was not built "
                                         "by the native builder")
                beside = {w: f"{k} on the same rays (phase 2e): {dense_t[w][k][0]:.1f} us"
                          for w, k in (("primary", "K1"), ("bounce", "K1"), ("shadow", "K2"))}
                _, a4_err = bvh_walks(bc, bvh_mod, a4_bvh, {
                    w: (q["o3"], q["d3"], q.get("tmax"), q.get("excl"))
                    for w, q in waves_.items()}, rng, card, label, beside)
                bvh_errs.append(a4_err)
                del a4_bvh
            del sc, rows_, attrs_, table_, waves_
    if n_dense_tris != 4040:
        raise AssertionError(f"synthetic:atrium:{DENSE_ATRIUM_TRIS} is no longer 4,040 triangles")
    torch.cuda.empty_cache()
    print("[dense] K1/K2 bitwise equal to their plain versions on every row of the "
          "Cornell and atrium:4000 wavefronts")

    lap("phase 2e")
    # --- phase 2b: streaming cluster kernels vs plain (481k) -------------------
    t0 = time.perf_counter()
    big = build_scene_tensors(atrium(480_000), device=dev)
    sync()
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    ca = build_clusters(*(x.cpu().numpy() for x in (big.tri_v0, big.tri_v1, big.tri_v2)))
    packed, attrs = cc.derive_buffers(big, ca)
    bmin = torch.from_numpy(ca.bbox_min).to(dev)
    bmax = torch.from_numpy(ca.bbox_max).to(dev)
    sync()
    t_clusters = time.perf_counter() - t0
    Le = min(cc.DEFAULT_LMAX, ca.K)
    print(f"[cluster] atrium: T={big.n_tris} lights={big.n_lights} K={ca.K} M={ca.M}; "
          f"route {route_of(cc, ca.K, ca.M)}; scene {t_scene:.2f} s, clusters + buffers "
          f"{t_clusters:.2f} s")
    if (big.n_tris, ca.K) != (481_208, 3_760) or route_of(cc, ca.K, ca.M) != "stream":
        raise AssertionError("the full atrium is no longer the 481,208-triangle streaming scene")
    with torch.no_grad():
        waves, primary_hits, primary_t = atrium_wavefronts(big, *ATRIUM_RES, dev, clusters=ca)
        if waves["primary"][0].shape[1] != 7200 or primary_hits < 0.99:
            raise AssertionError(f"atrium primary wavefront: B0 or hit share {primary_hits} off")
        big_errs, big_inputs, n_over = compare_cluster(
            cc, "atrium 1280x720", waves, bmin, bmax, Le, packed, attrs, rng, all_rows=False,
            route="stream")
        lap("phase 2b, scene and checks")
        ctimings = time_cluster(cc, big_inputs, bmin, bmax, packed, attrs, rng, "stream")
        lap("phase 2b, timings")
        k3_waves(cc, card, *(torch.cat([waves["primary"][i], waves["bounce"][i]], 1)
                             for i in (0, 1)), bmin, bmax)
        boxes = torch.from_numpy(xc.pack_cull_boxes(ca.bbox_min, ca.bbox_max)).to(dev)
        x1_times = {
            "481k primary": compare_x1(xc, cc, "atrium 481k primary",
                                       *waves["primary"][:3], bmin, bmax, boxes),
            "481k primary, tmax = hit t": compare_x1(
                xc, cc, "atrium 481k primary, tmax = the closest hit's t",
                *waves["primary"][:2], primary_t, bmin, bmax, boxes),
        }
        lap("phase 2b, K3 by waves and X1")
        beam_big, beam_err = beam_checks(
            cc, card, "atrium 481k", {w: waves[w][:4] for w in ("primary", "bounce", "shadow")},
            bmin, bmax, packed, attrs, "stream", rng, replay_sample=(ROW_SAMPLE, 32),
            plain_times=True)
    if n_over == 0:
        raise AssertionError("no overflow row was compared: phase 2 of K6/K7 went unchecked")
    del big, packed, attrs, waves, big_inputs, boxes, primary_t
    torch.cuda.empty_cache()
    print("[cluster] K3 exact, K6/K7 bitwise against their plain versions, visit counts "
          "equal to the replay of their exit rule; X1 exact against its plain version and "
          "K3's hit mask")

    lap("phase 2b, K3b beside K3")
    # --- phase 2c: resident cluster kernels (262k) -----------------------------
    t0 = time.perf_counter()
    mid = build_scene_tensors(atrium(MID_TRIS), device=dev)
    sync()
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    mca = build_clusters(*(x.cpu().numpy() for x in (mid.tri_v0, mid.tri_v1, mid.tri_v2)))
    m_packed, m_attrs = cc.derive_buffers(mid, mca)
    m_bmin = torch.from_numpy(mca.bbox_min).to(dev)
    m_bmax = torch.from_numpy(mca.bbox_max).to(dev)
    sync()
    t_clusters = time.perf_counter() - t0
    print(f"[cluster] atrium:{MID_TRIS}: T={mid.n_tris} lights={mid.n_lights} K={mca.K} "
          f"M={mca.M}; route {route_of(cc, mca.K, mca.M)}; scene {t_scene:.2f} s, "
          f"clusters + buffers {t_clusters:.2f} s")
    if (mid.n_tris, mca.K) != (261_396, 2_043) or route_of(cc, mca.K, mca.M) != "resident":
        raise AssertionError("atrium:262144 is no longer the 261,396-triangle resident scene")
    with torch.no_grad():
        m_waves, primary_hits, _ = atrium_wavefronts(mid, *ATRIUM_RES, dev, clusters=mca)
        if primary_hits < 0.99:
            raise AssertionError(f"atrium:{MID_TRIS} primary hit share {primary_hits} off")
        mid_errs, mid_inputs, n_over = compare_cluster(
            cc, f"atrium:{MID_TRIS} 1280x720", m_waves, m_bmin, m_bmax,
            min(cc.DEFAULT_LMAX, mca.K), m_packed, m_attrs, rng, all_rows=False,
            route="resident")
        small = build_scene_tensors(atrium(2_200, seed=5), device=dev)
        sca = build_clusters(*(x.cpu().numpy() for x in (small.tri_v0, small.tri_v1, small.tri_v2)), 32)
        s_packed, s_attrs2 = cc.derive_buffers(small, sca)
        s_waves, _, _ = atrium_wavefronts(small, 160, 96, dev)
        small_errs, s_inputs, s_over = compare_cluster(
            cc, "atrium(2_200) M=32", s_waves, torch.from_numpy(sca.bbox_min).to(dev),
            torch.from_numpy(sca.bbox_max).to(dev), SMALL_LMAX, s_packed, s_attrs2, rng,
            all_rows=True, route="resident")
        check_visits(cc, "atrium(2_200) M=32", s_inputs, s_packed, s_attrs2, "resident")
        lap("phase 2c, 262k scene and checks, atrium(2_200)")
        mtimings = time_cluster(cc, mid_inputs, m_bmin, m_bmax, m_packed, m_attrs, rng,
                                "resident")
        lap("phase 2c, 262k timings")
        # The 19k frame's wavefronts in pixel order, as the integrator
        # traces them there (K = 148 < COMPACT_MIN_K: no compaction, no sort).
        nano = build_scene_tensors(atrium(NANO_TRIS), device=dev)
        nca = build_clusters(*(x.cpu().numpy() for x in (nano.tri_v0, nano.tri_v1, nano.tri_v2)))
        n_packed, n_attrs = cc.derive_buffers(nano, nca)
        n_bmin = torch.from_numpy(nca.bbox_min).to(dev)
        n_bmax = torch.from_numpy(nca.bbox_max).to(dev)
        if nca.K != 148 or nca.K >= cc.COMPACT_MIN_K:
            raise AssertionError(f"atrium:{NANO_TRIS} has K={nca.K}, not 148")
        n_waves, _, _ = atrium_wavefronts(nano, *NANO_RES, dev, sorted_=False, clusters=nca)
        nano_errs, nano_inputs, _ = compare_cluster(
            cc, f"atrium:{NANO_TRIS} 1024x1024", n_waves, n_bmin, n_bmax,
            min(cc.DEFAULT_LMAX, nca.K), n_packed, n_attrs, rng, all_rows=False,
            route="resident")
        ntimings = time_cluster(cc, nano_inputs, n_bmin, n_bmax, n_packed, n_attrs, rng,
                                "resident")
        lap("phase 2c, 19k checks and timings")
        x1_times["262k shadow"] = compare_x1(
            xc, cc, f"atrium:{MID_TRIS} shadow", *m_waves["shadow"][:3], m_bmin,
            m_bmax, torch.from_numpy(xc.pack_cull_boxes(mca.bbox_min, mca.bbox_max)).to(dev))
    if n_over == 0 or s_over == 0:
        raise AssertionError("no overflow row was compared: phase 2 of K4/K5 went unchecked")
    # The renders and phase 5 build their own scenes: hold nothing of this
    # phase's on the card while their peak memory is read.
    del mid, m_packed, m_attrs, m_waves, mid_inputs, small, s_packed, s_attrs2, s_waves
    del s_inputs, nano, n_packed, n_attrs, n_waves, nano_inputs
    torch.cuda.empty_cache()
    print("[cluster] K3 exact, K4/K5 bitwise against their plain versions, visit counts "
          "equal to the replay of their exit rule")

    lap("phase 2c, X1")
    # --- phase 2d: the 3M atrium, whose matrix outgrows L2 -------------------
    t0 = time.perf_counter()
    huge = build_scene_tensors(atrium(BIG3M_TRIS), device=dev)
    sync()
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    hca = build_clusters(*(x.cpu().numpy() for x in (huge.tri_v0, huge.tri_v1, huge.tri_v2)))
    h_packed, h_attrs = cc.derive_buffers(huge, hca)
    h_bmin = torch.from_numpy(hca.bbox_min).to(dev)
    h_bmax = torch.from_numpy(hca.bbox_max).to(dev)
    sync()
    t_clusters = time.perf_counter() - t0
    print(f"[cluster] atrium:{BIG3M_TRIS}: T={huge.n_tris} lights={huge.n_lights} K={hca.K} "
          f"M={hca.M}; route {route_of(cc, hca.K, hca.M)}; (K, 10, M) matrix "
          f"{hca.K * cc.GEO_ROWS * hca.M * 4 / 2**20:.1f} MiB; scene {t_scene:.2f} s, "
          f"clusters + buffers {t_clusters:.2f} s")
    if (huge.n_tris, hca.K) != (2_999_720, 23_436) or route_of(cc, hca.K, hca.M) != "stream":
        raise AssertionError(f"atrium:{BIG3M_TRIS} is no longer the 2,999,720-triangle "
                             "streaming scene of 23,436 clusters")
    with torch.no_grad():
        sync()
        torch.cuda.reset_peak_memory_stats()
        h_waves, primary_hits, _ = atrium_wavefronts(huge, *ATRIUM_RES, dev, clusters=hca)
        if primary_hits < 0.99:
            raise AssertionError(f"atrium:{BIG3M_TRIS} primary hit share {primary_hits} off")
        h_bounce = h_waves["bounce"]
        h_waves = {w: h_waves[w] for w in ("primary", "shadow")}
        huge_errs, huge_inputs, h_over = compare_cluster(
            cc, f"atrium:{BIG3M_TRIS} 1280x720", h_waves, h_bmin, h_bmax,
            min(cc.DEFAULT_LMAX, hca.K), h_packed, h_attrs, rng, all_rows=False,
            route="stream", sample=BIG3M_SAMPLE, max_overflow=BIG3M_SAMPLE)
        sync()
        print(f"[cluster] atrium:{BIG3M_TRIS}: peak device memory of the checks "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB (the (B0, K) keys "
              f"{7200 * hca.K * 4 / 2**20:.1f} MiB each, kernel's and plain)")
        lap("phase 2d, 3M scene and checks")
        htimings = time_cluster(cc, huge_inputs, h_bmin, h_bmax, h_packed, h_attrs, rng,
                                "stream", plain_cull=False)
        k6_bounce_us = bounce_3m(cc, card, *h_bounce[:2], h_bmin, h_bmax, h_packed, h_attrs)
        lap("phase 2d, 3M timings")
        beam_huge, huge_beam_err = beam_checks(
            cc, card, f"atrium:{BIG3M_TRIS}", {**h_waves, "bounce": h_bounce[:4]}, h_bmin,
            h_bmax, h_packed, h_attrs, "stream", rng, replay_sample=(BIG3M_SAMPLE, 0),
            visit_reps=1)
        beam_err = max(beam_err, huge_beam_err)
        lap("phase 2d, K3b beside K3")
        # Phase 3g(g): B1/B2 on the same wavefronts, while they are held.
        h_bvh = bvh_mod.build_bvh(huge)
        if h_bvh.builder != "native":
            raise AssertionError(f"the atrium:{BIG3M_TRIS} BVH was not built by the native "
                                 "builder")
        print(f"[bvh] {card}: atrium:{BIG3M_TRIS}: {h_bvh.n_nodes} nodes, native build "
              f"{h_bvh.build_seconds:.3f} s; the BVH holds {bvh_bytes(h_bvh) / 2**20:.1f} MiB "
              "of device memory")
        beside = cluster_beside(htimings, "stream")
        beside["bounce"] = (f"K6 on the same wavefront (phase 2d): {k6_bounce_us:.1f} us on all "
                            "rows after its K3 cull (not timed on it)")
        _, h_err = bvh_walks(bc, bvh_mod, h_bvh, {**h_waves, "bounce": h_bounce}, rng, card,
                             f"atrium:{BIG3M_TRIS}", beside, sample_rows=BIG3M_SAMPLE)
        bvh_errs.append(h_err)
        del h_bvh
        lap("phase 2d, 3M B1/B2 (3g(g))")
    del huge, h_packed, h_attrs, h_waves, huge_inputs, h_bounce
    torch.cuda.empty_cache()
    cluster_errs = {k: max(e.get(k, 0.0) for e in (big_errs, mid_errs, small_errs, nano_errs,
                                                   huge_errs))
                    for k in ("cull", *cc.ROUTES["resident"], *cc.ROUTES["stream"])}
    # --- phase 2f: the sample streams' kernels (R1) vs plain -------------------
    with torch.no_grad():
        streams = streams_phase(threefry_cuda, prng, card, dev)
    lap("phase 2f")
    reset(threefry_cuda.LAUNCHES)      # from here on, the renders' own launches
    # --- phase 3: Cornell render -------------------------------------------------
    # The EXR shim the first export loads: built by g++, or (a host without
    # OpenEXR 3.1) a failed build, recorded so that a later process raises
    # at once and takes the pure-Python writer.
    t0 = time.perf_counter()
    shim = image_io._native()
    first_s = time.perf_counter() - t0
    again = "no recorded failure to read"
    if shim is None:
        t0 = time.perf_counter()
        try:
            cuda_build.build_host_library.__wrapped__("exr_io", image_io.EXR_FLAGS,
                                                      image_io.EXR_LIBS)
        except RuntimeError as e:
            if "an earlier build" not in str(e):
                raise
        again = f"a later process's recorded failure {time.perf_counter() - t0:.4f} s"
    print(f"[export] {card}: the OpenEXR shim {'built' if shim else 'unavailable'}: the "
          f"first export's shim {first_s:.3f} s; {again}")
    renderer, launches, _, mem, exported = cli_render(
        cli, repo, counts, ["samples", str(RENDER_SPP)], "cornell_768.exr")
    add_launches(launches)
    cfg, st = renderer.cfg, renderer.last_stats
    img = renderer.pixels
    print(f"[render] {cfg.xres}x{cfg.yres} k={cfg.k} spp={cfg.samples} "
          f"launches={launches} mean={float(img.mean())} max={float(img.max())}")
    if (cfg.xres, cfg.yres, cfg.k, cfg.samples) != (768, 768, RENDER_K, RENDER_SPP):
        raise AssertionError("scenes/cornell.rtc no longer renders 768x768 at k 6")
    want = {"closest": RENDER_SPP * RENDER_K, "any": RENDER_SPP * RENDER_K}
    if launches != {**dict.fromkeys(launches, 0), **want}:
        raise AssertionError(f"kernel launches {launches} != samples x k on K1/K2 only")
    if not (np.isfinite(img).all() and img.mean() > 1e-3 and (img > 1e-3).mean() > 0.5):
        raise AssertionError("render is not finite and non-trivial")
    # The EXR stores HALF floats: 2^-11 relative.
    if not np.allclose(exported, img, rtol=2.0**-10, atol=1e-6):
        raise AssertionError("the exported EXR does not read back as the render")
    del renderer

    small_cfg = ["input", "builtin:cornell_box", "xres", "128", "yres", "128",
                 "samples", "4", "k", "6", *cam_tokens(CORNELL_CAMERA)]
    imgs = {}
    for platform in ("cuda", "cpu"):
        c = RenderConfig.from_tokens(small_cfg + ["platform", platform])
        s = load_scene(c, dev if platform == "cuda" else torch.device("cpu"))
        with torch.no_grad():
            imgs[platform] = render_image(s, c).cpu().numpy()
    sync()
    assert_render_close(imgs["cuda"], imgs["cpu"], "cornell 128x128")

    lap("phase 3")
    # --- phase 3b: 481k atrium render, atrium(2_200) card vs CPU ---------------
    a_tokens = ["input", "synthetic:atrium", "intersector", "auto", "xres", str(ATRIUM_RES[0]),
                "yres", str(ATRIUM_RES[1]), "samples", "1", "k", str(ATRIUM_K), *cam]
    a_renderer, a_launches, a_total, a_mem, a_exported = cli_render(
        cli, repo, counts, a_tokens, "atrium_1280x720.exr")
    add_launches(a_launches)
    check_atrium_render(a_renderer, a_exported, a_launches, route_launches(cc, "stream"),
                        "atrium", ATRIUM_RES)
    if a_renderer.intersectors[0].route != "stream":
        raise AssertionError("the 481k atrium did not take the streaming route")
    a_pixels = a_renderer.pixels.copy()     # the CLI's layer: phase 3g holds the BVH's to it
    report_frame(card, "atrium 481k 1280x720", a_renderer, a_total, a_mem)
    profile_frame(a_renderer, card)
    a_warm = frame_ms(a_renderer)
    del a_renderer, a_exported
    torch.cuda.empty_cache()
    add_launches(beam_frame(cli, cc, repo, counts, card, a_tokens, "atrium_beam.exr",
                            "atrium 481k 1280x720", a_pixels, a_warm[0], 3))

    s_tokens = ["input", "synthetic:atrium:2200", "xres", "160", "yres", "90",
                "samples", "2", "k", "2", *cam]
    for stream in (None, True):
        s_imgs = {}
        for platform in ("cuda", "cpu"):
            c = RenderConfig.from_tokens(s_tokens + ["platform", platform])
            s = load_scene(c, dev if platform == "cuda" else torch.device("cpu"))
            pair = cc.make_cluster_intersectors(s, stream=stream)
            reset(*counts)
            with torch.no_grad():
                s_imgs[platform] = render_image(s, c, intersectors=pair).cpu().numpy()
            if platform == "cuda":
                used = {k: n for k, n in cc.LAUNCHES.items() if n}
                route = pair[0].route
                if set(used) != {"cull", *cc.ROUTES[route]}:
                    raise AssertionError(f"atrium(2_200) route {route} launched {used}")
                cf, af = pair
                cf.prefers_ray_sort = True       # the full path's spatial sorts
                ys, xs = torch.meshgrid(torch.arange(90, device=dev),
                                        torch.arange(160, device=dev), indexing="ij")
                args = (s, c.vp, c.la, c.up, c.yview, 160, 90, xs.reshape(-1), ys.reshape(-1),
                        0, 2, c.seed, 2, c.background, cf, af)
                with torch.no_grad():
                    plain_order = render_samples(*args, compact=False)
                    compacted = render_samples(*args, compact=True)
                sync()
                if not torch.equal(bits(plain_order), bits(compacted)):
                    raise AssertionError("compacted atrium render differs from the uncompacted one")
                print(f"[render] atrium(2_200) 160x90 on the card, route {route} ({used}): "
                      "compact=True (spatial sorts) bitwise equal to compact=False")
        sync()
        assert_render_close(s_imgs["cuda"], s_imgs["cpu"],
                            f"atrium(2_200) 160x90 route {route}", flipped_mean_rel=1e-3)

    lap("phase 3b")
    # --- phase 3c: mid-size renders through auto ---------------------------------
    m_renderer, m_launches, m_total, m_mem, m_exported = cli_render(
        cli, repo, counts,
        ["input", f"synthetic:atrium:{MID_TRIS}", "intersector", "auto",
         "xres", str(ATRIUM_RES[0]), "yres", str(ATRIUM_RES[1]), "samples", "1",
         "k", str(ATRIUM_K), *cam], "atrium_262k.exr")
    add_launches(m_launches)
    resident = route_launches(cc, "resident")
    check_atrium_render(m_renderer, m_exported, m_launches, resident,
                        f"atrium:{MID_TRIS}", ATRIUM_RES)
    if m_renderer.intersectors[0].route != "resident" or \
            not m_renderer.intersectors[0].prefers_compaction:
        raise AssertionError("atrium:262144 did not take the resident route with compaction")
    report_frame(card, f"atrium:{MID_TRIS} 1280x720", m_renderer, m_total, m_mem)
    profile_frame(m_renderer, card)
    del m_renderer, m_exported
    torch.cuda.empty_cache()
    n_renderer, n_launches, n_total, n_mem, n_exported = cli_render(
        cli, repo, counts,
        ["input", f"synthetic:atrium:{NANO_TRIS}", "intersector", "auto", "xres", "1024",
         "yres", "1024", "samples", "1", "k", str(ATRIUM_K), *cam], "atrium_19k.exr")
    add_launches(n_launches)
    check_atrium_render(n_renderer, n_exported, n_launches, resident,
                        f"atrium:{NANO_TRIS}", (1024, 1024))
    if n_renderer.intersectors[0].route != "resident" or \
            n_renderer.intersectors[0].prefers_compaction:
        raise AssertionError("atrium:19000 did not take the resident route without compaction")
    report_frame(card, f"atrium:{NANO_TRIS} 1024x1024", n_renderer, n_total, n_mem)
    profile_frame(n_renderer, card)
    del n_renderer, n_exported
    torch.cuda.empty_cache()

    lap("phase 3c")
    # --- phase 3d: the 3M frame through auto ------------------------------------
    h_tokens = ["input", f"synthetic:atrium:{BIG3M_TRIS}", "intersector", "auto",
                "xres", str(ATRIUM_RES[0]), "yres", str(ATRIUM_RES[1]), "samples", "1",
                "k", str(ATRIUM_K), *cam]
    h_renderer, h_launches, h_total, h_mem, h_exported = cli_render(
        cli, repo, counts, h_tokens, "atrium_3m.exr")
    add_launches(h_launches)
    check_atrium_render(h_renderer, h_exported, h_launches, route_launches(cc, "stream"),
                        f"atrium:{BIG3M_TRIS}", ATRIUM_RES)
    if h_renderer.intersectors[0].route != "stream":
        raise AssertionError(f"atrium:{BIG3M_TRIS} did not take the streaming route")
    h_pixels = h_renderer.pixels.copy()     # the CLI's layer: phase 3g holds the BVH's to it
    report_frame(card, f"atrium:{BIG3M_TRIS} 1280x720", h_renderer, h_total, h_mem)
    h_warm = h_renderer.last_stats["seconds"] * 1e3
    profile_frame(h_renderer, card)
    del h_renderer, h_exported
    torch.cuda.empty_cache()
    add_launches(beam_frame(cli, cc, repo, counts, card, h_tokens, "atrium_3m_beam.exr",
                            f"atrium:{BIG3M_TRIS} 1280x720", h_pixels, h_warm, 1,
                            profiled=False))

    lap("phase 3d")
    # --- phase 3e: the dense path's largest scene through auto ----------------
    d_renderer, d_launches, d_total, d_mem, d_exported = cli_render(
        cli, repo, counts, a4_tokens, "atrium_4000.exr")
    add_launches(d_launches)
    check_atrium_render(d_renderer, d_exported, d_launches,
                        {"closest": ATRIUM_K, "any": ATRIUM_K},
                        f"atrium:{DENSE_ATRIUM_TRIS}", ATRIUM_RES)
    report_frame(card, f"atrium:{DENSE_ATRIUM_TRIS} 1280x720", d_renderer, d_total, d_mem)
    profile_frame(d_renderer, card)
    del d_renderer, d_exported
    torch.cuda.empty_cache()
    d_tokens = ["input", f"synthetic:atrium:{DENSE_ATRIUM_TRIS}", "xres", "160", "yres", "90",
                "samples", "2", "k", "2", *cam]
    d_imgs = {}
    for platform in ("cuda", "cpu"):
        c = RenderConfig.from_tokens(d_tokens + ["platform", platform])
        s = load_scene(c, dev if platform == "cuda" else torch.device("cpu"))
        reset(*counts)
        with torch.no_grad():
            d_imgs[platform] = render_image(s, c).cpu().numpy()
        if platform == "cuda":
            used = {k: n for c_ in counts for k, n in c_.items() if n}
            if used != {"closest": 4, "any": 4}:
                raise AssertionError(f"atrium:{DENSE_ATRIUM_TRIS} 160x90 launched {used}")
    sync()
    assert_render_close(d_imgs["cuda"], d_imgs["cpu"],
                        f"atrium:{DENSE_ATRIUM_TRIS} 160x90 (dense)", flipped_mean_rel=1e-3)

    lap("phase 3e")
    # --- phase 3f: Phong, spp_batch, state and profile -------------------------
    from chiaroscuro_tpu_torch.render.renderer import Renderer
    from chiaroscuro_tpu_torch.scene.scene_arrays import BRDF_DIFFUSE, BRDF_PHONG

    # (a) Cornell with glossy blocks as an OBJ through the CLI, specular and
    # profile on, at cornell.rtc's 768x768 and k 6.
    with tempfile.TemporaryDirectory() as obj_dir:
        obj = os.path.join(obj_dir, "cornell_glossy.obj")
        write_obj(glossy(cornell_box(), PHONG_CORNELL[0], PHONG_CORNELL[1], only="block"), obj)
        loaded = build_scene_tensors(load_obj(obj), enable_specular=True, device=dev)
        for k in ("tri_v0", "tri_v1", "tri_v2", "normal", "kd", "ke", "light_areas"):
            if not torch.equal(getattr(loaded, k), getattr(cornell, k)):
                raise AssertionError(f"the written Cornell OBJ does not load as the builtin: {k}")
        if int((loaded.brdf_type == BRDF_PHONG).sum()) != 20:
            raise AssertionError("the written Cornell OBJ's blocks are not Phong")
        phong_tokens = ["input", obj, "specular", "on", "samples", str(RENDER_SPP)]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            p_renderer, p_launches, _, p_mem, p_exported = cli_render(
                cli, repo, counts, phong_tokens + ["profile", "on"], "cornell_phong.exr")
        print(out.getvalue(), end="")
        add_launches(p_launches)
        p_cfg, p_img = p_renderer.cfg, p_renderer.pixels
        # The render's own launches, which the CLI prints before the profile.
        rendered = ast.literal_eval(re.search(r"^Kernel launches: (\{.*\})$", out.getvalue(),
                                              re.M).group(1))
        want = {"closest": RENDER_SPP * RENDER_K, "any": RENDER_SPP * RENDER_K,
                "threefry_raygen": RENDER_SPP, "threefry_bounce": RENDER_SPP * RENDER_K}
        if rendered != want:
            raise AssertionError(f"Phong render launches {rendered} != {want}")
        if "phase breakdown (full" not in out.getvalue() or not p_cfg.profile:
            raise AssertionError("profile on printed no phase report")
        if not (np.isfinite(p_img).all() and np.allclose(p_exported, p_img, rtol=2.0**-10,
                                                         atol=1e-6)):
            raise AssertionError("the Phong render is not finite or its EXR does not read back")
        d_renderer, d_launches, _, _, _ = cli_render(
            cli, repo, counts, phong_tokens[:2] + ["samples", str(RENDER_SPP)],
            "cornell_diffuse.exr")
        add_launches(d_launches)
        tops = box_top_pixels(p_renderer.scene, p_cfg, ic)
        top_phong, top_diffuse = float(p_img[tops].mean()), float(d_renderer.pixels[tops].mean())
        p_warm, d_warm = frame_ms(p_renderer, 2), frame_ms(d_renderer, 2)
        print(f"[phong] {card}: cornell 768x768 k6 {RENDER_SPP} spp, glossy blocks (Ks "
              f"{PHONG_CORNELL[0]}, Ns {PHONG_CORNELL[1]}): render launches "
              f"{rendered}, CLI run's {p_launches}; {int(tops.sum())} box-top "
              f"pixels, mean {top_phong} (specular off {top_diffuse}); warm frame "
              f"{p_warm[0]:.1f} ms (turns {', '.join(f'{t:.1f}' for t in p_warm[1])}; "
              f"specular off {d_warm[0]:.1f} ms, turns "
              f"{', '.join(f'{t:.1f}' for t in d_warm[1])}); {mem_text(p_mem)}")
        if not (tops.sum() > 1000 and top_phong > top_diffuse):
            raise AssertionError("the glossy box tops are not brighter than the diffuse ones")
        del p_renderer, d_renderer
        small = {}
        for platform in ("cuda", "cpu"):
            c = RenderConfig.from_tokens(small_cfg + ["input", obj, "specular", "on",
                                                      "platform", platform])
            s_ = load_scene(c, dev if platform == "cuda" else torch.device("cpu"))
            reset(*counts)
            with torch.no_grad():
                small[platform] = render_image(s_, c).cpu().numpy()
            if platform == "cuda":
                add_launches({k: n for c_ in counts for k, n in c_.items()})
        sync()
        assert_render_close(small["cuda"], small["cpu"], "cornell Phong 128x128")

    # (b) the 262k atrium with Phong at full width through Renderer, beside
    # the same scene's diffuse frame.
    g_meshes = glossy(atrium(MID_TRIS), *PHONG_ATRIUM)
    g_scene = build_scene_tensors(g_meshes, enable_specular=True, device=dev)
    g_diffuse = dataclasses.replace(
        g_scene, has_specular=False,
        brdf_type=torch.where(g_scene.brdf_type == BRDF_PHONG, BRDF_DIFFUSE, g_scene.brdf_type))
    a_cfg = RenderConfig.from_tokens(["intersector", "auto", "xres", str(ATRIUM_RES[0]),
                                      "yres", str(ATRIUM_RES[1]), "samples", "1",
                                      "k", str(ATRIUM_K), *cam])
    g_frames = {}
    for name, sc in (("phong", g_scene), ("diffuse", g_diffuse)):
        sync()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        r = Renderer(sc, a_cfg)
        reset(*counts)
        r.ray_trace()
        launches = {k: n for c_ in counts for k, n in c_.items() if n}
        sync()
        g_mem = (torch.cuda.max_memory_allocated(), held)
        if name == "phong":
            add_launches(launches)
            if r.intersectors[0].route != "resident" or launches != resident:
                raise AssertionError(f"262k Phong frame: route {r.intersectors[0].route}, "
                                     f"launches {launches} != {resident}")
            img = r.pixels
            if not np.isfinite(img).all() or img.mean() <= 0:
                raise AssertionError("the 262k Phong frame is not finite and lit")
        g_frames[name] = (frame_ms(r), r.last_stats, g_mem, float(r.pixels.mean()))
        if name == "phong":
            profile_frame(r, card, f"atrium:{MID_TRIS} Phong")
        del r
    (pm, pt), pst, pmem, pmean = g_frames["phong"]
    (dm_, dt), _, dmem, dmean = g_frames["diffuse"]
    print(f"[phong] {card}: atrium:{MID_TRIS} 1280x720 k3 1 spp, Ks {PHONG_ATRIUM[0]} Ns "
          f"{PHONG_ATRIUM[1]} on every non-emissive mesh: warm {pm:.2f} ms/frame (turns "
          f"{', '.join(f'{t:.2f}' for t in pt)}; {pst['useful_rays_per_sec'] / 1e6:.2f} useful "
          f"Mray/s), {mem_text(pmem)}, mean {pmean}; the diffuse frame of the same scene "
          f"{dm_:.2f} ms/frame (turns {', '.join(f'{t:.2f}' for t in dt)}), {mem_text(dmem)}, "
          f"mean {dmean}; Phong costs {pm - dm_:.2f} ms ({100 * (pm / dm_ - 1):.1f}%)")
    del g_scene, g_diffuse, g_meshes
    torch.cuda.empty_cache()

    gs_tokens = ["xres", "160", "yres", "90", "samples", "2", "k", "2", *cam]
    for stream in (False, True):
        gs_imgs = {}
        for d in (dev, torch.device("cpu")):
            sc = build_scene_tensors(glossy(atrium(2_200, seed=5), *PHONG_ATRIUM),
                                     enable_specular=True, device=d)
            c = RenderConfig.from_tokens(gs_tokens)
            pair = cc.make_cluster_intersectors(sc, stream=stream)
            reset(*counts)
            with torch.no_grad():
                gs_imgs[d.type] = render_image(sc, c, intersectors=pair).cpu().numpy()
            if d.type == "cuda":
                used = {k: n for k, n in cc.LAUNCHES.items() if n}
                route = pair[0].route
                if route != ("stream" if stream else "resident") or \
                        set(used) != {"cull", *cc.ROUTES[route]}:
                    raise AssertionError(f"Phong atrium(2_200) route {route} launched {used}")
                add_launches(used)
        sync()
        assert_render_close(gs_imgs["cuda"], gs_imgs["cpu"],
                            f"Phong atrium(2_200) 160x90 route {route}", flipped_mean_rel=1e-3)

    # (c) gradients w.r.t. (kd, ke, ks, shininess), card against CPU.
    phong_fields = ("kd", "ke", "ks", "shininess")
    for what, make_scene, gcam, res, spp, depth, route in (
            ("Phong cornell 64x64 x 4 spp x k3 (K1)",
             lambda d: build_scene_tensors(glossy(cornell_box(), *PHONG_CORNELL, only="block"),
                                           enable_specular=True, device=d),
             CORNELL_CAMERA, (64, 64), 4, 3, "dense"),
            ("Phong atrium(2_200) 64x36 x 2 spp x k2 (K4)",
             lambda d: build_scene_tensors(glossy(atrium(2_200, seed=5), *PHONG_ATRIUM),
                                           enable_specular=True, device=d),
             ATRIUM_CAMERA, (64, 36), 2, 2, "resident")):
        out = {}
        for d in (dev, torch.device("cpu")):
            scene = make_scene(d)
            if route == "dense":
                def pair_of(s):
                    return make_intersectors(s, "dense")
            else:
                gca = build_clusters(*(x.cpu().numpy() for x in
                                       (scene.tri_v0, scene.tri_v1, scene.tri_v2)))

                def pair_of(s, gca=gca):
                    pair = cc.make_cluster_intersectors(s, clusters=gca, stream=False)
                    if pair[0].route != "resident":
                        raise AssertionError(f"{what}: route {pair[0].route}")
                    return pair
            loss, grads, launches, seconds, _ = grad_run(
                scene, gcam, res, spp, depth, phong_fields, pair_of, counts=counts)
            out[d.type] = (loss, grads)
            if d.type == "cuda":
                print(f"[grad] {what} on the card: launches {launches}, {seconds:.3f} s")
                if not launches.get("closest" if route == "dense" else "closest_resident"):
                    raise AssertionError(f"{what}: no closest-hit launch in fwd+bwd")
        compare_grads(what, out["cuda"], out["cpu"])
        if not all(bool(out["cpu"][1][k].abs().sum() > 0) for k in ("ks", "shininess")):
            raise AssertionError(f"{what}: no ks or shininess gradient")

    # (d) spp_batch at Cornell 512x512 x 16 spp x k6.
    sb_pair = make_intersectors(cornell, "dense")
    sys_, sxs = torch.meshgrid(torch.arange(512, device=dev), torch.arange(512, device=dev),
                               indexing="ij")
    sb_args = (cornell, CORNELL_CAMERA["eye"], CORNELL_CAMERA["center"], CORNELL_CAMERA["up"],
               CORNELL_CAMERA["yview"], 512, 512, sxs.reshape(-1), sys_.reshape(-1), 0, 16, 0,
               RENDER_K, (0.0, 0.0, 0.0), *sb_pair)
    sb_out = {}
    for sb in (1, 16):
        with torch.no_grad():
            sync()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            reset(*counts)
            img = render_samples(*sb_args, spp_batch=sb)
            launches = {k: n for c_ in counts for k, n in c_.items() if n}
            sync()
            sb_mem = (torch.cuda.max_memory_allocated(), held)
            add_launches(launches)
            ms = [time_us(lambda: render_samples(*sb_args, spp_batch=sb), 1) / 1e3
                  for _ in range(3)]
        sb_out[sb] = (img, launches, ms, sb_mem)
        print(f"[spp_batch] {card}: cornell 512x512 x 16 spp x k6, spp_batch={sb}: launches "
              f"{launches}, warm {float(np.median(ms)):.2f} ms (CUDA events, turns "
              f"{', '.join(f'{t:.2f}' for t in ms)}), {mem_text(sb_mem)}")
    ref, img = sb_out[1][0], sb_out[16][0]
    dif = (img - ref).abs()
    rel = float((dif / ref.abs().clamp_min(1e-30)).mean())
    print(f"[spp_batch] 16 against 1: mean relative {rel}, max |d| {float(dif.max())} "
          f"(max {float(ref.abs().max())})")
    if not (rel <= 1e-6 and float(dif.max()) <= 1e-5 * float(ref.abs().max())):
        raise AssertionError("spp_batch=16 differs from spp_batch=1")
    if sb_out[1][1] != {"closest": 96, "any": 96} or sb_out[16][1] != {"closest": 6, "any": 6}:
        raise AssertionError(f"spp_batch launches {sb_out[1][1]} / {sb_out[16][1]}")
    del sb_out, ref, img, dif
    torch.cuda.empty_cache()

    # (e) state: save, load into a fresh Renderer, one more layer, against
    # two layers straight through.
    st_cfg = RenderConfig.from_tokens(small_cfg + ["intersector", "dense"])
    straight = Renderer(cornell, st_cfg)
    first = Renderer(cornell, st_cfg)
    reset(*counts)
    straight.ray_trace()
    straight.ray_trace()
    first.ray_trace()
    with tempfile.TemporaryDirectory() as state_dir:
        path = os.path.join(state_dir, "state.npz")
        first.save_state(path)
        resumed = Renderer(cornell, st_cfg)
        if not resumed.load_state(path):
            raise AssertionError("load_state refused its own state file")
    resumed.ray_trace()
    add_launches({k: n for c_ in counts for k, n in c_.items()})
    if resumed._layers != 2 or not np.array_equal(resumed.pixels.view(np.int32),
                                                  straight.pixels.view(np.int32)):
        raise AssertionError("the resumed render is not bitwise two layers straight through")
    print("[state] save_state / load_state / one more layer: bitwise equal to two layers "
          "straight through (Cornell 128x128, 4 spp a layer, k 6)")
    del straight, first, resumed

    lap("phase 3f")
    # --- phase 3g: the BVH path (B1/B2) and the preview -------------------------
    from chiaroscuro_tpu_torch.preview.viewer import make_state

    # (a) The 481k frame through the CLI with intersector bvh, against the
    # cluster frame of phase 3b.
    b_renderer, b_launches, b_total, b_mem, b_exported = cli_render(
        cli, repo, counts,
        ["input", "synthetic:atrium", "intersector", "bvh", "xres", str(ATRIUM_RES[0]),
         "yres", str(ATRIUM_RES[1]), "samples", "1", "k", str(ATRIUM_K), *cam],
        "atrium_bvh_1280x720.exr")
    add_launches(b_launches)
    check_atrium_render(b_renderer, b_exported, b_launches,
                        {"bvh_closest": ATRIUM_K, "bvh_any": ATRIUM_K}, "atrium 481k (bvh)",
                        ATRIUM_RES)
    b_bvh = b_renderer.intersectors[0].bvh

    def block_means(img):
        return img.reshape(ATRIUM_RES[1] // 4, 4, ATRIUM_RES[0] // 4, 4, 3).mean(axis=(1, 3))

    # The CLI's layer, before the warm frames below accumulate onto it.
    assert_render_close(block_means(b_renderer.pixels), block_means(a_pixels),
                        "atrium 481k 1280x720 4x4 block means", flipped_mean_rel=1e-3,
                        vs="bvh vs cluster")
    if b_bvh.builder != "native":
        raise AssertionError("the 481k BVH was not built by the native builder")
    print(f"[bvh] {card}: atrium 481k: T={b_renderer.scene.n_tris}, {b_bvh.n_nodes} nodes, "
          f"leaf size {b_bvh.leaf_size}; native build {b_bvh.build_seconds:.3f} s (g++ of "
          f"csrc/bvh_builder.cpp {cuda_build.build_host_library('bvh_builder')[1]['seconds']:.2f}"
          f" s in phase 1); the BVH holds {bvh_bytes(b_bvh) / 2**20:.1f} MiB of device memory")
    report_frame(card, "atrium 481k 1280x720 (bvh)", b_renderer, b_total, b_mem,
                 setup="BVH build and upload")
    b_warm = frame_ms(b_renderer)
    print(f"[timing] {card}: atrium 481k 1280x720 k3 1 spp warm, median of 3: bvh "
          f"{b_warm[0]:.1f} ms (turns {', '.join(f'{x:.1f}' for x in b_warm[1])}) against the "
          f"cluster frame's {a_warm[0]:.1f} ms (phase 3b; turns "
          f"{', '.join(f'{x:.1f}' for x in a_warm[1])}): {b_warm[0] / a_warm[0]:.2f}x")
    profile_frame(b_renderer, card, "atrium 481k (bvh)")
    with torch.no_grad():
        b_waves, _, _ = atrium_wavefronts(b_renderer.scene, *ATRIUM_RES, dev)
        big_bvh, bvh_err = bvh_walks(bc, bvh_mod, b_bvh, b_waves, rng, card, "atrium 481k",
                                     cluster_beside(ctimings, "stream"))
    del b_renderer, b_exported, b_waves, b_bvh, a_pixels
    torch.cuda.empty_cache()
    lap("phase 3g, 481k")

    # (b) The 262k's wavefronts, beside K4/K5.
    mid = build_scene_tensors(atrium(MID_TRIS), device=dev)
    m_bvh = bvh_mod.build_bvh(mid)
    if m_bvh.builder != "native":
        raise AssertionError(f"the atrium:{MID_TRIS} BVH was not built by the native builder")
    with torch.no_grad():
        m_waves, _, _ = atrium_wavefronts(mid, *ATRIUM_RES, dev, clusters=mca)
        _, m_err = bvh_walks(bc, bvh_mod, m_bvh, m_waves, rng, card, f"atrium:{MID_TRIS}",
                             cluster_beside(mtimings, "resident"))
    bvh_err = max([bvh_err, m_err] + bvh_errs)
    del m_waves, m_bvh
    torch.cuda.empty_cache()

    # (c) The 3M frame through the CLI with intersector bvh, against the
    # cluster frame of phase 3d.
    hb_renderer, hb_launches, hb_total, hb_mem, hb_exported = cli_render(
        cli, repo, counts,
        ["input", f"synthetic:atrium:{BIG3M_TRIS}", "intersector", "bvh",
         "xres", str(ATRIUM_RES[0]), "yres", str(ATRIUM_RES[1]), "samples", "1",
         "k", str(ATRIUM_K), *cam], "atrium_3m_bvh.exr")
    add_launches(hb_launches)
    check_atrium_render(hb_renderer, hb_exported, hb_launches,
                        {"bvh_closest": ATRIUM_K, "bvh_any": ATRIUM_K},
                        f"atrium:{BIG3M_TRIS} (bvh)", ATRIUM_RES)
    assert_render_close(block_means(hb_renderer.pixels), block_means(h_pixels),
                        f"atrium:{BIG3M_TRIS} 1280x720 4x4 block means", flipped_mean_rel=1e-3,
                        vs="bvh vs cluster")
    if hb_renderer.intersectors[0].bvh.builder != "native":
        raise AssertionError(f"the atrium:{BIG3M_TRIS} BVH was not built by the native builder")
    report_frame(card, f"atrium:{BIG3M_TRIS} 1280x720 (bvh)", hb_renderer, hb_total, hb_mem,
                 setup="BVH build and upload")
    hb_warm = hb_renderer.last_stats["seconds"] * 1e3
    print(f"[timing] {card}: atrium:{BIG3M_TRIS} 1280x720 k3 1 spp warm: bvh {hb_warm:.1f} ms "
          f"against the cluster frame's {h_warm:.1f} ms (phase 3d): {hb_warm / h_warm:.2f}x")
    profile_frame(hb_renderer, card, f"atrium:{BIG3M_TRIS} (bvh)")
    del hb_renderer, hb_exported, h_pixels
    torch.cuda.empty_cache()
    lap("phase 3g, 3M frame through bvh")

    # (d) atrium(2_200) through bvh, card against CPU.
    s_imgs = {}
    for platform in ("cuda", "cpu"):
        c = RenderConfig.from_tokens(s_tokens + ["platform", platform, "intersector", "bvh"])
        s = load_scene(c, dev if platform == "cuda" else torch.device("cpu"))
        reset(*counts)
        with torch.no_grad():
            s_imgs[platform] = render_image(s, c).cpu().numpy()
        if platform == "cuda":
            used = {k: n for c_ in counts for k, n in c_.items() if n}
            if used != {"bvh_closest": 4, "bvh_any": 4}:
                raise AssertionError(f"atrium(2_200) 160x90 through bvh launched {used}")
    sync()
    assert_render_close(s_imgs["cuda"], s_imgs["cpu"], "atrium(2_200) 160x90 (bvh)",
                        flipped_mean_rel=1e-3)
    lap("phase 3g, 262k and atrium(2_200)")

    # (e) The preview, headless: make_state's raster frames on the card
    # against the CPU's (Cornell through K1, the 262k through K3 + K4), then
    # R and the tone-mapped layer.
    p_cases = (
        ("cornell 64x48", ["input", "builtin:cornell_box", "xres", "64", "yres", "48",
                           *cam_tokens(CORNELL_CAMERA)],
         lambda d: build_scene_tensors(cornell_box(), device=d), {"closest": 1}),
        (f"atrium:{MID_TRIS} 64x36", ["input", f"synthetic:atrium:{MID_TRIS}", "xres", "64",
                                      "yres", "36", "intersector", "cluster", *cam],
         lambda d: mid if d.type == "cuda" else build_scene_tensors(atrium(MID_TRIS), device=d),
         {"cull": 1, "closest_resident": 1}),
    )
    for what, tokens, make_scene, want in p_cases:
        frames = {}
        for d in (dev, torch.device("cpu")):
            pv_cfg = RenderConfig.from_tokens(tokens + ["samples", "1", "k", "2",
                                                          "platform", d.type])
            pv_r = Renderer(make_scene(d), pv_cfg)
            pv_st = make_state(pv_r)
            reset(*counts)
            frames[d.type] = pv_st.raster_fn(pv_st.camera)
            if d.type == "cuda":
                used = {k: n for c_ in counts for k, n in c_.items() if n}
                if used != want:
                    raise AssertionError(f"preview raster {what} launched {used}, not {want}")
                walk = pv_st.display_image()
                pv_st.press_r()
                shown = pv_st.display_image()
                if not (walk.shape == shown.shape == (pv_cfg.yres, pv_cfg.xres, 3)
                        and shown.dtype == np.uint8 and walk.max() > 0 and shown.max() > 0
                        and np.isfinite(pv_r.pixels).all()):
                    raise AssertionError(f"preview {what}: the frames are not the shown images")
            del pv_r, pv_st
        f_err = float(np.abs(frames["cuda"] - frames["cpu"]).max())
        print(f"[preview] {what}: raster frame on the card ({want}) against the CPU's: "
              f"max |d| {f_err}, lit share {float((frames['cpu'].sum(-1) > 0).mean()):.3f}; "
              "R rendered a layer and the display showed it")
        np.testing.assert_allclose(frames["cuda"], frames["cpu"], rtol=1e-4, atol=1e-5)
    del mid
    torch.cuda.empty_cache()
    lap("phase 3g, preview")
    add_launches(threefry_cuda.LAUNCHES)
    # --- phase 4: timings ---------------------------------------------------------
    with torch.no_grad():
        t_cornell = time_dense(ic, card, "cornell queries", c_rows, c_attrs,
                               ic.pad_table(c_rows), c_q, dense_bound, plain=True)
        time_dense(ic, card, "soup queries", s_rows, s_attrs, ic.pad_table(s_rows), s_q,
                   soup_bound, plain=True)
    print_cluster_timings(card, "atrium 481k", ctimings)
    print_cluster_timings(card, f"atrium:{BIG3M_TRIS}", htimings)
    print_cluster_timings(card, f"atrium:{MID_TRIS}", mtimings)
    print_cluster_timings(card, f"atrium:{NANO_TRIS}", ntimings)
    for what, x in x1_times.items():
        print_x1_timings(card, what, x)
    ms_per_sample = st["seconds"] * 1e3 / cfg.samples
    print(f"[timing] {card}: cornell render 768x768 k6 {cfg.samples} spp: "
          f"{st['seconds']:.3f} s, {ms_per_sample:.2f} ms/sample, "
          f"{st['useful_rays_per_sec'] / 1e6:.1f} useful Mray/s, "
          f"occupancy {st['occupancy']:.3f}; {mem_text(mem)}")

    lap("phase 4")
    # --- phase 5: gradients -------------------------------------------------------
    grad_checks = (
        ("cornell 64x64 x 4 spp x k3 (K1)", lambda d: build_scene_tensors(cornell_box(), device=d),
         CORNELL_CAMERA, (64, 64), 4, 3, ("kd", "ke", "tri_v0"), None, "dense"),
        ("atrium(2_200) 64x36 x 2 spp x k2 (K4)",
         lambda d: build_scene_tensors(atrium(2_200, seed=5), device=d),
         ATRIUM_CAMERA, (64, 36), 2, 2, ("kd", "ke", "tex_data"), False, "resident"),
        ("atrium(2_200) 64x36 x 2 spp x k2 (K6)",
         lambda d: build_scene_tensors(atrium(2_200, seed=5), device=d),
         ATRIUM_CAMERA, (64, 36), 2, 2, ("kd", "ke", "tex_data"), True, "stream"),
    )
    for what, make_scene, gcam, res, spp, depth, fields, stream, route in grad_checks:
        out = {}
        for d in (dev, torch.device("cpu")):
            scene = make_scene(d)
            if route == "dense":
                def pair_of(s):
                    return make_intersectors(s, "dense")
            else:
                gca = build_clusters(*(x.cpu().numpy() for x in
                                       (scene.tri_v0, scene.tri_v1, scene.tri_v2)))

                def pair_of(s, gca=gca, stream=stream):
                    pair = cc.make_cluster_intersectors(s, clusters=gca, stream=stream)
                    if pair[0].route != route:
                        raise AssertionError(f"{what}: route {pair[0].route} != {route}")
                    return pair
            loss, grads, launches, seconds, _ = grad_run(
                scene, gcam, res, spp, depth, fields, pair_of, counts=counts)
            out[d.type] = (loss, grads)
            if d.type == "cuda":
                print(f"[grad] {what} on the card: launches {launches}, {seconds:.3f} s")
                want_kernel = {"dense": "closest", "resident": "closest_resident",
                               "stream": "closest_cluster"}[route]
                if not launches.get(want_kernel):
                    raise AssertionError(f"{what}: no {want_kernel} launch in fwd+bwd")
        compare_grads(what, out["cuda"], out["cpu"])

    # (ii) full width: the 262k atrium, fwd+bwd w.r.t. (kd, ke), checkpointed,
    # on a scene built afresh (phase 2c's was let go before the renders).
    # The first turn records what each gather's backward hands S1.
    mid = build_scene_tensors(atrium(MID_TRIS), device=dev)
    def mid_pair(s):
        return make_intersectors(s, "cluster", clusters=mca)

    s1_calls = []

    def s1_record(ct, tid, n_rows):
        s1_calls.append((ct.clone(), tid.clone(), n_rows))
        return scatter_cuda.scatter_rows_sum(ct, tid, n_rows)

    for turn in ("first", "second"):
        if turn == "first":
            ic.scatter_rows_sum = s1_record
        try:
            loss, grads, g_launches, seconds, g_mem = grad_run(
                mid, ATRIUM_CAMERA, ATRIUM_RES, 1, ATRIUM_K, ("kd", "ke"), mid_pair,
                checkpoint=True, counts=counts)
        finally:
            ic.scatter_rows_sum = scatter_cuda.scatter_rows_sum
        if turn == "first":
            s1_launches = g_launches.get("scatter_rows", 0)
        lights = mid.light_ids.long().cpu()
        lit_ke = float(grads["ke"][lights].abs().sum())
        print(f"[grad] {card}: atrium:{MID_TRIS} 1280x720 x 1 spp x k3 fwd+bwd w.r.t. (kd, ke), "
              f"checkpoint=True, {turn}: {seconds * 1e3:.1f} ms, {mem_text(g_mem)}, "
              f"loss {loss}, launches {g_launches}; "
              f"sum|d/dke| over the lights {lit_ke}, sum|d/dkd| {float(grads['kd'].abs().sum())}")
        finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
        if not (finite and lit_ke > 0 and g_launches.get("closest_resident")
                and g_launches.get("any_resident") and g_launches.get("cull")
                and g_launches.get("scatter_rows") == ATRIUM_K):
            raise AssertionError("full-width gradients are not finite and lit, skipped "
                                 "K3/K4/K5, or ran other than one S1 sum a bounce")
    profile(lambda: grad_run(mid, ATRIUM_CAMERA, ATRIUM_RES, 1, ATRIUM_K, ("kd", "ke"),
                             mid_pair, checkpoint=True),
            f"atrium:{MID_TRIS} 1280x720 x 1 spp x k3 fwd+bwd, checkpoint=True", card)
    del mid
    s1 = s1_checks(scatter_cuda, card, s1_calls)
    del s1_calls
    torch.cuda.empty_cache()

    # (iii) Cornell 512x512 x 16 spp x k3 fwd+bwd through K1.
    for turn in ("first", "second"):
        loss, grads, g_launches, seconds, g_mem = grad_run(
            cornell, CORNELL_CAMERA, (512, 512), 16, 3, ("kd", "ke"),
            lambda s: make_intersectors(s, "dense"), checkpoint=True, counts=counts)
        print(f"[grad] {card}: cornell 512x512 x 16 spp x k3 fwd+bwd w.r.t. (kd, ke), "
              f"checkpoint=True, {turn}: {seconds * 1e3:.1f} ms, {mem_text(g_mem)}, "
              f"loss {loss}, launches {g_launches}")
        if not (all(bool(torch.isfinite(g).all()) for g in grads.values())
                and float(grads["ke"].abs().sum()) > 0 and g_launches.get("closest")):
            raise AssertionError("Cornell 512x512 gradients are not finite and lit")
    # (iv) The backward's fetch: the one-hot product against the gather
    # forced, in turns; the card against the CPU w.r.t. the vertices too;
    # spp_batch 16, where one one-hot over the wavefront would exceed the
    # budget.
    if ic._BWD_ONEHOT is not None:
        raise AssertionError("CHIAROSCURO_BWD_ONEHOT is set: phase 5(iv) measures the default")
    fetch_ab(ic, card, cornell, lambda s: make_intersectors(s, "dense"), counts)
    v_fields = ("kd", "ke", "tri_v0", "tri_v1", "tri_v2")
    out = {}
    for d in (dev, torch.device("cpu")):
        out[d.type] = grad_run(build_scene_tensors(cornell_box(), device=d), CORNELL_CAMERA,
                               (96, 96), 2, 3, v_fields,
                               lambda s: make_intersectors(s, "dense"), checkpoint=True)[:2]
    compare_grads("cornell 96x96 x 2 spp x k3 w.r.t. (kd, ke, vertices), one-hot fetch",
                  out["cuda"], out["cpu"])
    loss16, grads16 = grad_run(cornell, CORNELL_CAMERA, (512, 512), 16, 3, ("kd", "ke"),
                               lambda s: make_intersectors(s, "dense"), checkpoint=True)[:2]
    loss, grads, g_launches, seconds, g_mem = grad_run(
        cornell, CORNELL_CAMERA, (512, 512), 16, 3, ("kd", "ke"),
        lambda s: make_intersectors(s, "dense"), checkpoint=True, counts=counts, spp_batch=16)
    rels = {k: float((grads[k].double() - g.double()).abs().sum() / g.double().abs().sum())
            for k, g in grads16.items()}
    onehot_bytes = cornell.n_tris * 512 * 512 * 16 * 4
    print(f"[fetch] {card}: cornell 512x512 x 16 spp x k3 fwd+bwd w.r.t. (kd, ke), "
          f"checkpoint=True, spp_batch=16: {seconds * 1e3:.1f} ms, {mem_text(g_mem)}; one "
          f"one-hot over the wavefront would be {onehot_bytes / 2**20:.1f} MiB, the budget "
          f"{ic.ONEHOT_BUDGET_BYTES / 2**20:.0f} MiB a chunk; loss {loss} against {loss16} "
          f"at spp_batch=1, gradients' relative L1 " + ", ".join(
              f"d/d{k} {v}" for k, v in rels.items()) + f"; launches {g_launches}")
    if not (all(bool(torch.isfinite(g).all()) for g in grads.values())
            and g_launches.get("closest") in (3, 6)):
        raise AssertionError("the spp_batch=16 fwd+bwd is not finite or not one K1 a "
                             "bounce (two with the checkpoint's recompute)")

    lap("phase 5")
    # --- phase 6: the tool path (X1 in the cull shootout, X2) -------------------
    t0 = time.perf_counter()
    reset(xc.LAUNCHES, dm.LAUNCHES)
    shootout = xc.main()
    x2_out, x2_x = dm.main()
    tool_launches = {**xc.LAUNCHES, **dm.LAUNCHES}
    t_tools = time.perf_counter() - t0
    if shootout["K"] != 148 or shootout["B0"] != 8192:
        raise AssertionError(f"the shootout ran K={shootout['K']}, B0={shootout['B0']}, "
                             "not atrium:19000 at 1024x1024")
    x2_err = 0.0
    for trip in (0, 5, dm.K, dm.K + 3):
        meta = torch.tensor([[trip, 0]], dtype=torch.int32, device=dev)
        got, want = dm.dma_min(meta, x2_x), dm.dma_min_plain(meta, x2_x)
        sync()
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"X2 differs from its plain version at trip {trip}")
        x2_err = max(x2_err, max_err(got, want))
        print(f"[x2] trip {trip}: X2 bitwise equal to its plain version; column sums "
              f"{float(got.min()):.3f}..{float(got.max()):.3f}")
    if not torch.equal(bits(x2_out), bits(dm.dma_min_plain(
            torch.tensor([[dm.K, 0]], dtype=torch.int32, device=dev), x2_x))):
        raise AssertionError("the repro's X2 output differs from its plain version")
    full = torch.tensor([[dm.K, 0]], dtype=torch.int32, device=dev)
    x2_fns = {
        "plain": lambda: dm.dma_min_plain(full, x2_x),
        "x2": lambda: dm.dma_min(full, x2_x),
        "library": lambda: x2_x[:dm.K * dm.M].sum(0),
    }
    x2_t = time_turns(x2_fns, {"plain": 10, "x2": 100, "library": 100})
    # The kernels' own time over the same loops, apart from the host's
    # dispatch (which the event loop includes): X2's kernel by name, and
    # every kernel the library call runs (one a call, as the count shows).
    x2_dev = {"x2": device_us(x2_fns["x2"], 100, "dma_min_kernel"),
              "library": device_us(x2_fns["library"], 100)}
    # X2 reads trip's K distinct blocks once and adds trip x M x W values.
    x2_bound = bound(dm.K * dm.M * dm.W, 8 + dm.K * dm.M * dm.W * 4 + dm.W * 4)
    print(f"[tools] launches {tool_launches} in {t_tools:.1f} s")
    print(f"[timing] {card}: X2 dma_min trip {dm.K}, loop of calls by CUDA events: "
          + ", ".join(f"{n} {m:.2f} us (turns {a:.2f}, {c:.2f})" for n, (m, (a, c)) in x2_t.items())
          + "; kernel time by torch.profiler: "
          + ", ".join(f"{n} {'not measured' if u is None else f'{u:.2f} us'} a kernel "
                      f"({k} kernels recorded for 100 calls)" for n, (u, k) in x2_dev.items())
          + f"; bound {x2_bound[0] * 1e3:.3f} us ({x2_bound[1]})")
    lap("phase 6")
    # --- phase 7: the sharded path (parallel/) -----------------------------------
    from chiaroscuro_tpu_torch import entry as pentry
    from chiaroscuro_tpu_torch.parallel import scaling as ps
    from chiaroscuro_tpu_torch.parallel.sharding import _pixel_grid

    t7 = lap_t[0]
    frame_jobs, grad_jobs = shard_jobs(ps, RenderConfig, repo, cam)
    jobs = frame_jobs + grad_jobs
    one = ps.run_ranks(1, jobs, iters=2)                      # NCCL
    lap("phase 7a, 1 NCCL rank")
    two = ps.run_ranks(2, jobs, backend="gloo", iters=2)      # two ranks on one card
    lap("phase 7b, 2 gloo ranks")
    for rank in one + two:
        for result in rank:
            add_launches(result["launches"])
    # (a), (b): every frame against render_samples over the whole grid here.
    scenes = {}
    for j, job in enumerate(frame_jobs):
        cfg = job.cfg
        if cfg.obj_path not in scenes:
            scenes[cfg.obj_path] = load_scene(cfg, dev)
        scene = scenes[cfg.obj_path]
        cf, af = make_intersectors(scene, cfg.intersector)
        xs, ys = (torch.from_numpy(a).to(dev) for a in _pixel_grid(cfg.xres, cfg.yres))
        with torch.no_grad():
            want = render_samples(scene, cfg.vp, cfg.la, cfg.up, cfg.yview, cfg.xres,
                                  cfg.yres, xs, ys, 0, cfg.samples, cfg.seed, cfg.k,
                                  cfg.background, cf, af).reshape(cfg.yres, cfg.xres, 3).cpu()
        want_launches = shard_frame_want(cc, job)
        for run, what in ((one, "1 NCCL rank"), (two, "2 gloo ranks")):
            for r, rank in enumerate(run):
                got = rank[j]
                if not torch.equal(bits(got["frame"]), bits(want)):
                    raise AssertionError(f"{shard_label(job)}: rank {r} of {what} differs "
                                         "from render_samples over the whole grid")
                launched = {k: n for k, n in got["launches"].items() if n}
                if launched != want_launches:
                    raise AssertionError(f"{shard_label(job)}: rank {r} of {what} launched "
                                         f"{launched}, not {want_launches}")
        print(f"[shard] {shard_label(job)}: 1 NCCL rank and both of 2 gloo ranks bitwise "
              f"equal to render_samples over the whole grid; each rank launched "
              f"{want_launches} (route {one[0][j]['route'] or cfg.intersector}); mean "
              f"{float(want.mean())}")
    del scenes, scene, cf, af
    torch.cuda.empty_cache()
    # (c): the gradients of 2 gloo ranks against 1 NCCL rank's.
    for j, job in enumerate(grad_jobs, start=len(frame_jobs)):
        ref = one[0][j]
        if not (ref["launches"].get("closest") or ref["launches"].get("closest_resident")):
            raise AssertionError(f"{shard_label(job)}: the gradient step launched no "
                                 f"closest-hit kernel: {ref['launches']}")
        for r, rank in enumerate(two):
            got = rank[j]
            loss_rel = abs(float(got["loss"]) - float(ref["loss"])) / abs(float(ref["loss"]))
            rels = {}
            for k, g in ref["grads"].items():
                total = float(g.double().abs().sum())
                diff = float((got["grads"][k].double() - g.double()).abs().sum())
                rels[k] = diff / total if total else diff
                if not bool(torch.isfinite(got["grads"][k]).all()):
                    raise AssertionError(f"{shard_label(job)}: non-finite d/d{k}")
            print(f"[shard] {card}: {shard_label(job)} fwd+bwd w.r.t. {job.fields}"
                  f"{', checkpoint=True' if job.checkpoint else ''}: rank {r} of 2 gloo ranks "
                  f"against 1 NCCL rank: loss {float(got['loss'])} vs {float(ref['loss'])} "
                  f"(rel {loss_rel}); sum|d|/sum|g| "
                  + ", ".join(f"d/d{k} {v}" for k, v in rels.items())
                  + f" (sum|g| {', '.join(f'{k} {float(g.abs().sum())}' for k, g in ref['grads'].items())}); "
                  f"ms 1 NCCL rank {ref['ms']:.1f}, this rank {got['ms']:.1f}; launches of "
                  f"this rank {dict((k, n) for k, n in got['launches'].items() if n)}")
            if loss_rel > 1e-6 or any(v > 1e-5 for v in rels.values()):
                raise AssertionError(f"{shard_label(job)}: 2 ranks' gradients differ from "
                                     "1 rank's beyond the stated bounds")
    lap("phase 7c, checks")
    # (d): the dry run on the card.
    pentry.dryrun_multichip(1)
    lap("phase 7d, dryrun_multichip(1)")
    # (e): the scaling reports, 1 and 2 gloo ranks on the one card.
    gloo_one = ps.run_ranks(1, frame_jobs, backend="gloo", iters=2)
    for j, job in enumerate(frame_jobs):
        report = ps.scaling_report(job, [1, 2], [[r[j] for r in gloo_one],
                                                 [r[j] for r in two]], "cuda")
        if not report["bitwise_equal"]:
            raise AssertionError(f"{shard_label(job)}: 1 and 2 gloo ranks' frames differ")
        print(ps.format_report(report))
        print(f"[timing] {card}: phase 7 {shard_label(job)}, best of 2 frames between "
              f"barriers: 1 NCCL rank {one[0][j]['ms']:.1f} ms, 1 gloo rank "
              f"{gloo_one[0][j]['ms']:.1f} ms, 2 gloo ranks on the one card "
              f"{two[0][j]['ms']:.1f} ms")
    lap("phase 7e, 1 gloo rank and the reports")
    lap_t[0] = t7
    lap("phase 7")
    # Launches above for comparison and timing do not count: the counts
    # are the tool phase's.

    def entry(name, route, source, replaces, e, ms, plain_ms, bnd, launches=None,
              library_ms=None):
        if launches is None:
            launches = main_launches[name if name not in ("closest_dense", "any_dense")
                                     else name.split("_")[0]]
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}

    def visit_entry(name, replaces, t):
        return entry(name, "cuda", "chiaroscuro_tpu_torch/csrc/intersect_cluster.cu",
                     replaces, cluster_errs[name], t["us"] / 1e3, t["plain_us"] / 1e3, t["bound"])

    # X2 and its library call by their kernel time where the profiler gave
    # it, else by the event loop.
    x2_ms = {n: (x2_t[n][0] if u is None else u) / 1e3 for n, (u, _) in x2_dev.items()}
    ct, at = t_cornell["K1"], t_cornell["K2"]
    cull_t = ctimings[("cull", "primary")]
    beam_t = beam_big["primary"]
    x1_t = x1_times["481k primary"]
    kernels = [
        entry("closest_dense", "cuda", "chiaroscuro_tpu_torch/csrc/intersect_dense.cu",
              "chiaroscuro_tpu/ops/intersect_pallas.py:206", err, ct[0] / 1e3, ct[1] / 1e3,
              dense_bound["K1"]),
        entry("any_dense", "cuda", "chiaroscuro_tpu_torch/csrc/intersect_dense.cu",
              "chiaroscuro_tpu/ops/intersect_pallas.py:339", err, at[0] / 1e3, at[1] / 1e3,
              dense_bound["K2"]),
        entry("cull", "cuda", "chiaroscuro_tpu_torch/csrc/cull_rows.cu",
              "chiaroscuro_tpu/ops/cluster_pallas.py:310", cluster_errs["cull"],
              cull_t["us"] / 1e3, cull_t["plain_us"] / 1e3, cull_t["bound"]),
        entry("cull_beam", "cuda", "chiaroscuro_tpu_torch/csrc/cull_beam.cu",
              "chiaroscuro_tpu/ops/cluster_pallas.py:294", beam_err,
              beam_t["t_cull"]["K3b cull"][0] / 1e3,
              beam_t["t_cull"]["K3b plain cull"][0] / 1e3, beam_t["cull_bound"]),
        visit_entry("closest_resident", "chiaroscuro_tpu/ops/cluster_pallas.py:485",
                    mtimings[("closest_resident", "primary")]),
        visit_entry("any_resident", "chiaroscuro_tpu/ops/cluster_pallas.py:550",
                    mtimings[("any_resident", "shadow")]),
        visit_entry("closest_cluster", "chiaroscuro_tpu/ops/cluster_pallas.py:627",
                    ctimings[("closest_cluster", "primary")]),
        visit_entry("any_cluster", "chiaroscuro_tpu/ops/cluster_pallas.py:750",
                    ctimings[("any_cluster", "shadow")]),
        entry("bvh_closest", "cuda", "chiaroscuro_tpu_torch/csrc/bvh_traverse.cu",
              "chiaroscuro_tpu/accel/bvh.py:362", bvh_err, big_bvh["primary"]["us"] / 1e3,
              big_bvh["primary"]["plain_us"] / 1e3, big_bvh["primary"]["bound"]),
        entry("bvh_any", "cuda", "chiaroscuro_tpu_torch/csrc/bvh_traverse.cu",
              "chiaroscuro_tpu/accel/bvh.py:415", bvh_err, big_bvh["shadow"]["us"] / 1e3,
              big_bvh["shadow"]["plain_us"] / 1e3, big_bvh["shadow"]["bound"]),
        entry("cull_rowhit", "cuda", "chiaroscuro_tpu_torch/csrc/cull_rowhit.cu",
              "tools/tpu_cull_experiments.py:52", max(x["err"] for x in x1_times.values()),
              x1_t["t"]["x1"][0] / 1e3,
              x1_t["t"]["plain"][0] / 1e3, x1_t["bound"],
              launches=tool_launches["cull_rowhit"]),
        entry("dma_min", "cuda", "chiaroscuro_tpu_torch/csrc/dma_min.cu",
              "tools/_tpu_dma_min.py:9", x2_err, x2_ms["x2"], x2_t["plain"][0] / 1e3,
              x2_bound, launches=tool_launches["dma_min"], library_ms=x2_ms["library"]),
    ]
    kernels.append(entry(
        "scatter_rows", "cuda", "chiaroscuro_tpu_torch/csrc/scatter_rows.cu",
        "none: XLA's scatter-add, the VJP of chiaroscuro_tpu/ops/cluster_pallas.py:1180",
        max(r["err"] for r in s1), sum(r["us"] for r in s1) / len(s1) / 1e3,
        sum(r["plain_us"] for r in s1) / len(s1) / 1e3, max(r["bound"] for r in s1),
        launches=s1_launches, library_ms=sum(r["library_us"] for r in s1) / len(s1) / 1e3))
    for name, fused in (("threefry_bounce", "chiaroscuro_tpu/sampling/prng.py:106"),
                        ("threefry_raygen", "chiaroscuro_tpu/sampling/prng.py:87 and :99")):
        r1 = streams[name][R1_LANES[0]]
        kernels.append(entry(name, "cuda", "chiaroscuro_tpu_torch/csrc/threefry.cu",
                             f"none: XLA's fusion of {fused}", r1["err"], r1["us"] / 1e3,
                             r1["plain_us"] / 1e3, r1["bound"]))
    missing = [k["name"] for k in kernels if not k["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: {missing}")
    print(f"[smoke] main-path launches {main_launches}; tool-path launches {tool_launches}; "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
