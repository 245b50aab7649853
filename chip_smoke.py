#!/usr/bin/env python3
"""Smoke run of emg3d_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the package's CUDA kernels from ``emg3d_tpu_torch/csrc`` with
nvcc, holds each against its plain PyTorch version on the card, and
drives the port's two paths through the kernels: ``solve`` with point
smoothing on the 64³ fullspace configuration of ``bench.py`` (64³ cells
of 100 m, 1 Ω·m, 1 Hz x-source at the centre, F-cycles to tol 1e-6),
and the production configuration (semicoarsening and line relaxation,
standalone and MG-preconditioned BiCGSTAB/CGS) on the same fullspace.
Phases:

1. environment (torch, CUDA, nvcc, Triton, the card's name and power
   limit);
2. kernel build, timed, with ptxas' register/spill report;
3. each point kernel against its plain version on the same card, at
   (2,2,2), (4,4,4), (7,5,9), 8³, 16³, 32³, 64×48×48, 64³ and 128³:
   every single
   colour step and a full nu=3 sweep, each run twice (must be bitwise
   equal), within max|Δ| ≤ 1e-12·max|e| (fp64, a different summation
   order); K1 and K2 under every launch plan their levels admit
   (``point_gs.sweep_plan``), each bitwise equal to the kernel's
   ``step`` plan, and K2 from its packed node data and from direct
   reads of st and w, bitwise equal; the table of ms per nu=3
   smoothing call by kernel, plan and level, the readings behind
   ``sweep_plan``'s and ``point_gs.point_kernel``'s rules; ms per
   colour step at 64³ under each kernel's chosen plan, beside plain;
   the step plan of both kernels at 256³ and of K2 at 512×384×384
   (packed and direct), ms per colour step beside the bound;
3b. the line kernels the same way, at (3,3,3), (7,5,9), (9,7,9) and
   64³, lines along x, y and z: the factor kernel (which assembles its
   station blocks from the line state's η sums, ζ weights and widths)
   against ``smoothers.line_factor_stack`` plane by plane (all 23; run
   twice, bitwise equal), the residual kernel for each of the four colours against
   ``line_gs.residual_plain`` (``stencil.residual_parts`` restricted to
   ``line_gs.colour_edges``) into a NaN-filled buffer (twice, bitwise
   equal; every entry off the colour's edges must stay NaN), the
   Thomas kernel against ``smoothers.line_thomas_x`` on the same
   residual, every colour step through the wrapper (twice, bitwise
   equal; its residual buffer NaN-filled, the result finite) and a
   nu=2 sweep against the plain version; median ms per launch at 64³
   and the residual kernel under several slab geometries; the factor
   kernel under every block size (32-256 threads, one line each;
   bitwise equal) at 64³, sclr64's rotated levels,
   PLAN_SHAPE, 128³ and 256³ (``factor_plans``); then at 128³ (the
   question of scripts/hw_bisect_lr128.py: K3 and K4 each launched
   alone) and 256³, lines along x, the three kernels alone against
   their plain versions, with ms per launch beside plain; and the
   Thomas kernel under every launch plan (1-32 lines per block, z in
   shared or global memory) at 64³ and PLAN_SHAPE (colours 0 and 3),
   128³ and 256³ (all four), each twice (bitwise equal) against the
   plain version and timed;
4. the point path: the default solve of that configuration, CONVERGED,
   with each point kernel's launches and colour steps equal to the
   numbers enumerated from ``point_kernel`` and ``sweep_plan`` over the
   solver's own cycle (:func:`point_cycle_calls`, per cycle) times
   ``it_mg``, and the same for the fullspace on the smallest of
   LARGE_SHAPES whose finest-level factor stack does not fit the
   card's FACTOR_SHARE (K2 there whatever the rule says); then a warm
   second solve at 64³;
5. the 64³ solve twice more, with K1 and with K2 pinned on every
   level (64³ down to 2³, each under its own plans): same it_mg, field
   within a relative 1e-9 of phase 4;
6. a heterogeneous tri-axial model on stretched 64×48×40 cells, solved
   through the kernels and through the plain torch path on the card:
   same it_mg, fields within a relative 1e-9;
7. the production path ("sclr64"): the 64³ fullspace with
   semicoarsening and line relaxation, standalone, with BiCGSTAB
   (``sslsolver=True``, Simulation's default) and with CGS, each
   CONVERGED; cold solves, then warm ones, each with the host seconds
   spent building line states (factor stacks);
8. "sclr256": the same fullspace at 256³ cells, standalone, CONVERGED,
   with its peak device memory and line-state seconds;
9. the model of phase 6 with semicoarsening and line relaxation,
   through the kernels (K5, K3, K4) and through the plain torch path
   (plain elimination and plain smoother): same it_mg, fields within a
   relative 1e-9;
10. the Simulation path (:func:`simulation_problem`): 4 x-directed
   sources × 2 frequencies on the 64³ fullspace, solved as one batched
   sc+lr BiCGSTAB solve of 8 lanes (two K5 groups).  First the
   lane-gridded K3 and K4 at LINE_SHAPES: 8 lanes of 2 frequency groups
   in one launch, bitwise equal to the same kernels launched once per
   lane and within 1e-12 of the plain versions lane by lane, with ms per
   8-lane launch beside 8 one-lane launches at 64³.  Then ``compute()``
   (exit message, it_mg, it_ssl, per-lane rel_error, launches and
   device ms per kernel of the batched solve, peak memory), its warm
   wall beside 8 sequential ``solve`` calls of the same pairs (each
   lane's field within rel 10·tol of its own solve), ``misfit`` and
   ``gradient`` against data of a 2 Ω·m fullspace, and the same
   Simulation at 16³ through the kernels and under ``_build.PLAIN``
   (responses within rel 1e-9);
11. "tdem64", the time domain (:func:`tdem_problem`): one x-directed
   dipole at the origin of the same fullspace, the 16 receivers, and the
   19 frequencies (0.011-8.35 Hz) of a ``Fourier`` as one 19-lane sc+lr
   BiCGSTAB ``solve_batched``: exit message, it_mg, it_ssl and rel_error
   per lane, launches and device ms per kernel, peak memory, line-state
   seconds and whether every factor stack stayed cached (K5 launches per
   line state = groups), cold and warm ``compute()``; three lanes
   (lowest, middle, highest frequency) against their own ``solve``
   (rel 10·tol); ``Fourier.freq2time`` of every receiver, finite; the
   same survey at 16³ through the kernels and under ``_build.PLAIN``,
   frequency and time responses within rel 1e-9;
12. "diff64", autograd (:func:`diff_problem`, tests/test_diff.py's setup
   on bench64's grid): the gradient of ½‖d − d_obs‖² in log σ through
   ``diff.make_differentiable_solve(grid, 1.0, tol=1e-10)``, with the
   point smoother (K1/K2) and with sc+lr (K3/K4/K5): forward and
   backward walls, the seconds inside ``solver.solve`` and outside it,
   launches and device ms per kernel; at 16³ the gradients through the
   kernels against ``_build.PLAIN`` (rel 1e-9, each solve's exit
   message, it_mg and it_ssl equal), central
   differences on three cells (1 %) and the source's gradient against
   the adjoint field λ;
13. "cli64": phase 10's survey (with its observed data) and model
   written with ``io`` to .npz and .json; ``cli.main.main([cfg, '-f'])``
   (npz inputs) and ``'-g'`` (json inputs) on the card, their outputs
   against phase 10's ``compute()`` (with the same noise seed), data and
   gradient (rel 1e-9); a ``Simulation.to_file``/``from_file`` round trip;
14. the probes (``ops/probes.py``, ``csrc/probes.cu``), the counterparts
   of the Mosaic probes in scripts/: ``tile_copy`` (TMA with an mbarrier)
   over every grid step of ``probe``/``probe3``/``probe23``/``probe12``
   (:func:`probe_boxes`) and at COPY_LARGE's sub-boxes, the card's
   opt-in shared memory and ``smem_limit`` (probe_vmem's x[0] += 1
   through N bytes of it) at SMEM_SIZES, the opt-in and 16 bytes past
   it under each plan of SMEM_PLANS (bitwise, or refused with x
   unchanged), ``smem_sum`` (also at SUM_LARGE and SUM_ODD),
   ``tile_roll`` (also at ROLL_LARGE and ROLL_ODD), ``dyn_slice`` and
   ``station_solve`` (also at STATION_LARGE and STATION_ODD) at ty=8,
   Zp=256, each bitwise equal to its plain version (``station_solve``
   within 1e-6 of ``torch.linalg.solve``), then timed: ``tile_roll``,
   ``tile_copy``, ``smem_sum``, ``station_solve`` and ``smem_limit`` in
   turns with their library calls at the probe's shape and (but
   smem_limit) where bytes decide, beside the launch floor
   (:func:`probe_turns`), ``tile_copy`` under each plan of COPY_PLANS
   (:func:`copy_plans`), ``smem_sum``, ``station_solve`` and
   ``smem_limit`` under SUM_PLANS, STATION_PLANS and SMEM_PLANS
   (:func:`probe_plans`); ``smem_limit``'s bound is one SM's
   shared-memory rate (:func:`smem_bound`);
15. "complex64", the solve in the precision of the JAX package's
   production path (a complex64 source): (a) each kernel's complex64
   instance against its complex64 plain version at 16³, 64³ and 256³
   (K1 and K2 single colour steps and, below 256³, a nu=1 call under the
   chosen plan, at 256³ the step plan on colours 0 and 7; K5's stack, K3
   on every colour, K4 on colours 0 and 3; lines along x), both held to
   the float64 evaluation of the same float32 inputs: the kernel within
   max(TOL_C64, 2·ep) of it and of the plain version, ep the plain
   version's distance from it, each at its worst over the shape's calls
   (:func:`_check_c64`; the readings per shape in ``checks_c64``); timed
   at 64³ and 256³ beside the complex128 times and the bounds at the
   element size and the fp32 peak; K6 (``residual_ds``) at DSRES_CASES
   (16³, 64³, 256³, stretched 37×23×19 and 37×23×45, two lanes with η
   per lane at both and at 64³, and sim64's eight lanes of 64³) on a
   near-converged level (s = fl32(A64·(hi +
   lo))): its plan (``dsres.tile_plan``) twice and without the lo
   stream, each bitwise equal to the plain version (so within TOL_DS of
   it) and within TOL_DS_F64·‖r‖ of the float64 residual of the same
   float32 operator; at 64³, 256³ and eight lanes of 64³ (DSRES_TIMED)
   the plan timed, the plan at every chunk of DSRES_CHUNKS, the plain
   version, and (logged only) the operations per edge
   (:func:`dsres_ops`) with their floor at the fp32 add rate;
   (b) the main path in complex64 (counters reset before, read after:
   ``launches_c64``): bench64 cold and warm (CONVERGED, rel_error below
   1e-6, hi + lo returned in complex128 within TOL_C64_FIELD of phase 4's
   field), sclr64 BiCGSTAB (against phase 7's field), sclr256
   standalone (peak memory beside phase 8's) and sim64's 8 pairs as
   complex64 sources through one ``solve_batched`` (every lane
   CONVERGED, responses within TOL_C64_FIELD of a complex128 solve at
   tol 1e-10); bench64, sclr64 and sim64 each timed in turns with their
   complex128 solves (a cold complex64 run, then three warm pairs); (c)
   16³ complex64 solves through the kernels and ``_build.PLAIN``, point
   and sc+lr: the same exit, it_mg ±1, fields within TOL_C64_FIELD.
   Phase 15 pins float32 storage (``solver.BF16_STORAGE = False``), so
   its readings are those of the complex64 path without bfloat16.
16. bfloat16 storage of the complex64 solve (the default on the card):
   (a) K1-K5's ``_bf16`` instances at 16³, 64³ and 256³ against their
   plain versions (K1-K4 as phase 15 holds the complex64 ones, against
   the float64 evaluation of the same rounded inputs; K5's bfloat16
   stack against the rounding of its float32 instance's and of the plain
   elimination's), timed in turns with the float32-storage instances at
   64³ and 256³; (b) bench64, sclr64 standalone and sclr64 BiCGSTAB, a
   cold bfloat16 run, then three warm bfloat16 / float32 pairs in turns
   (exit, it_mg, it_ssl, walls, peak memory, fields against complex128
   within TOL_C64_FIELD), and sclr256 with bfloat16 stacks once (its
   peak beside phase 15's); (c) 16³ solves through the kernels and
   ``_build.PLAIN``, point, sc+lr, and sc+lr with every stack in
   bfloat16;
17. "sharded", ``solve(..., sharding=)`` (``emg3d_tpu_torch.parallel``):
   (a) world size 1 on NCCL, in this process: bench64 with
   ``sharding=shard_solve_options(make_mesh(1))`` against phase 4's
   solve, the same exit and it_mg, fields within TOL_SHARD_WS1, and
   sclr64 standalone and BiCGSTAB against phase 7's, the same it_mg
   and it_ssl, fields within TOL_SHARD_WS1_SCLR (every line within the
   one rank: bitwise in practice; BiCGSTAB's norms and inner products
   are all_reduces of CUDA tensors through NCCL); (b) a job of 2
   ranks, ('z',), on bench64: the point solve, sclr64 standalone and
   sclr64 BiCGSTAB (z-lines through the
   Schur-complement smoother, ``parallel.lines``), and (c) a job of 4
   ranks, ('y', 'z'), on phase 6's tri-axial 64×48×40: the point solve
   and sc+lr (y- and z-lines Schur); each rank a process
   (``torch.multiprocessing``, spawn) on this one card, the ranks joined
   by gloo: gloo moves host tensors, so every message is staged through
   the host (the transport of the backend these cases ask for).  Each
   rank solves each case twice (cold, warm) with its counters reset
   before each solve and read after: K1-K5 launches, colour steps,
   messages, gathered levels; every solve CONVERGED with the unsharded
   solve's it_mg and it_ssl, the gathered field within TOL_SHARD of it,
   and each rank's point kernels (point cases) or K3, K4 and K5 (sc+lr)
   launched.  The walls of the sharded solves are logged beside a warm
   unsharded solve of the same problem: ranks that share one card, no
   target.  Before its solves each rank holds K1 and K2 against their
   plain versions on its own slabs of the two finest levels (the
   solve's partition, random e and s, each colour step alone), and K3,
   K4 and K5 on the same slabs for lines along each axis: within the
   rank, or the Schur smoother's interior segment (K5 and K4 with
   ``stations``), within TOL_KERNEL.  (NCCL refuses two ranks on one
   card, so these cases take gloo.)  The complex64 solve over ranks
   (float32 storage pinned): at world size 1 on NCCL bench64 and
   sclr64 BiCGSTAB with complex64 sources against phase 15's (the same
   exit, it_mg and it_ssl, the field logged against phase 15's) and
   sclr256 standalone (peak memory and wall beside phase 15's), then
   sclr64 with the card's default storage (every state of a level on a
   slab in float32, bfloat16 only on replicated levels); in the job of
   2 ranks the complex64 point solve and sclr64 BiCGSTAB, CONVERGED
   with the unsharded complex64 it_mg and it_ssl ±1, the gathered hi +
   lo within TOL_C64_FIELD of the unsharded complex64 field and of the
   complex128 one, every rank launching K6 and the case's kernels; its
   ranks hold K1-K5's complex64 instances (K4/K5 on Schur segments too)
   against their plain versions on their two finest slabs by
   :func:`_check_c64`, and K6 (``ctx.residual_ds`` on the finest slab)
   against ``residual_ds_plain`` within TOL_DS.
18. "x64 off", the port's switch off (``dtypes.x64(False)``), as the
   JAX package runs with JAX's x64 flag off: (a) sim64 through the
   public API, ``Simulation.compute()`` and ``gradient`` (the misfit on
   the way), timed in turns with the complex128 Simulation of phase 10
   (a complex128 run, the cold run with the switch off, three warm
   pairs; walls and peak device memory per run); every forward and
   adjoint lane CONVERGED, hi + lo returned; the smallest and largest
   nonzero |rfield| of the adjoint sources, before and after the
   unit-norm lane scaling, within float32's range; the forward fields
   bitwise equal to ``solve_batched`` of the same sources with the
   switch off, and within TOL_C64_FIELD of phase 15's solve of the
   hand-cast complex64 sources (logged: bitwise or not); the responses,
   misfit and gradient within phase 10's own distance from a complex128
   Simulation at tol 1e-10 (what tol 1e-6 allows it) plus TOL_C64_FIELD
   of phase 10's; (b) diff64's point gradient (tol 1e-10) with the
   switch off: the field and λ complex64, the gradient float32, both
   solves CONVERGED with K6 launched in each, the gradient within
   TOL_C64_FIELD of phase 12's complex128 one.  Its launches of every
   instance (``launches_x64_off``; the ``_bf16`` instances' apart,
   ``launches_x64_off_bf16``; K6's per diff64 solve,
   ``launches_per_solve_x64_off_diff``) must include K1, K3, K4, K5 and
   K6.

The launch counters are reset just before the two point-path solves of
phase 4 and read just after them, and reset just before the three cold
solves of phase 7 and read just after them: those counts are
``launches`` in the result line; each point kernel also reports the
colour ``steps`` those launches ran and the ``plan`` it runs at 64³,
K2 its step plan at 512×384×384 (``ms_large``, ``bound_ms_large``), K5
the bound of the packed-entry design beside its own
(``bound_ms_packed``).
Phase 5's pinned solves are counted apart (``pinned_launches``),
phase 10's batched solve (reset just before its warm ``compute()``, read
just after) as ``simulation_launches``, phase 11's the same way as
``tdem_launches`` and phase 12's gradients (reset before each 64³
forward and backward, read after) as ``diff_launches``.  The probes are
on no path: their counters are reset with the point kernels' before
phase 4 and read just before phase 14, and those counts (0 unless a
path ran a probe) are ``launches`` of their entries, under ``probes`` in
the same line, beside the launches of their checks
(``probe_launches``).  Phase 15's complex64 main path is counted apart:
``launches_c64`` of each kernel, with its complex64 times (``ms_c64``,
``bound_ms_c64`` at 64³, ``..._256`` at 256³) and ``max_abs_err_c64``;
K6, on the complex64 path only, has an entry of its own
(``residual_ds``, launches = its complex64 count; ``launches_bf16`` its
launches in phase 16b's bfloat16 runs; ``launches_per_solve_c64`` per
complex64 solve of bench64, sclr64 BiCGSTAB, sclr256 and sim64;
``checks``; its time, the plan, the times by chunk, ``..._256`` at
256³, ``..._64x8`` at eight lanes of 64³).  Phase 16b's
bfloat16 runs count the launches of each kernel's ``_bf16`` instance
(``launches_bf16``), beside its bfloat16 times (``ms_bf16``,
``bound_ms_bf16`` at 64³, ``..._256`` at 256³; ``ms_f32s`` the
float32-storage instance's in the same turns), ``max_abs_err_bf16`` and
``checks_bf16``.  Phase 17's sharded solves count each kernel's
launches per solve and rank (``launches_sharded``: K1/K2 in the
world-size-1 bench64 solve and per point case, K3-K5 in the
world-size-1 sclr64 solve and per sc+lr case, each case per rank the
cold and the warm solve) and their largest max|Δ| against the plain
versions on the ranks' slabs (``max_abs_err_sharded``); its complex64
solves the same (``launches_sharded_c64``, K6 included, and
``max_abs_err_sharded_c64``).  The two
entries of scripts/hw_bisect_lr128.py (K3 and K4 alone at 128³, phase
3b) carry K3's and K4's ``launches`` of the main path.  Each kernel's
``bound_ms`` is the least time the card could take for the timed call
(its bytes over 3.35 TB/s or its fp64 operations over 34 TFLOP/s,
whichever is larger), counted from the call's shapes by the
``*_work`` functions below; the residual kernel's is that of the
colour's own edges (:func:`colour_residual_work`), with the whole
level's (:func:`residual_work`) beside it as ``bound_ms_full``.  Any
failure raises and the exit code is not 0.
The last line is ``{"ok": true, "device": {...}}``; the line before it
holds ``nvidia-smi``'s name and power limit, and before that one JSON
line with the kernels' readings.  Needs one card and no network.
"""
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

TOL_KERNEL = 1e-12     # max|Δ| / max|e|, kernel vs plain, one card
# Phase 17: a world-size-1 sharded solve against the unsharded one (the
# same kernels on the same level, launched per colour step), and a solve
# over several ranks against it (rank boundaries change the summation
# order of the residual norms only).
TOL_SHARD_WS1 = 1e-12
TOL_SHARD = 1e-10
# Phase 17's world-size-1 sclr64 (standalone and BiCGSTAB) against phase
# 7's unsharded solves: lines within the rank run the same kernels on the
# same level.
TOL_SHARD_WS1_SCLR = 1e-15
TOL_SOLVE = 1e-9       # relative field difference between two solves
# Phase 15 (complex64): a kernel's float32 result against the float64
# evaluation of the same float32 inputs and against its plain version
# (max|Δ|/max|e|; where the data's conditioning amplifies float32
# rounding above it, each within twice the plain version's own distance
# from float64: _check_c64), a complex64 solve's field against another
# solve's, and K6's double-single residual: its plain version's (bit for
# bit in practice) and the float64 evaluation of the same operator
# (tests/test_dsres.py:109).
TOL_C64 = 1e-5
TOL_C64_FIELD = 2e-5
# Phase 18: the largest distance of phase 10's tol-1e-6 responses, misfit
# and gradient from a tol-1e-10 Simulation of the same survey that still
# shows them to be of that survey (read on an H100: 3.5e-06, 1.3e-05,
# 4.3e-05).
TOL_X64_REF = 1e-3
TOL_DS = 1e-12
TOL_DS_F64 = 3e-7
C64_SHAPES = ((16, 16, 16), (64, 64, 64), (256, 256, 256))
# K6's checks in phase 15a, (shape, lanes): the C64_SHAPES, two
# stretched odd levels (the second with a partial z tile after a full
# one), two lanes with η per lane, and sim64's eight; the tiled plan
# timed at every chunk (x planes per block) of DSRES_CHUNKS in the
# DSRES_TIMED cases.
DSRES_CASES = (((16, 16, 16), 1), ((64, 64, 64), 1), ((256, 256, 256), 1),
               ((37, 23, 19), 1), ((37, 23, 19), 2), ((37, 23, 45), 1),
               ((37, 23, 45), 2), ((64, 64, 64), 2), ((64, 64, 64), 8))
DSRES_CHUNKS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
# The cases timed, with the suffix of their keys: 64³ and 256³ at one
# lane, and sim64's finest level (8 lanes of 64³, η per lane).
DSRES_TIMED = {((64, 64, 64), 1): '', ((256, 256, 256), 1): '_256',
               ((64, 64, 64), 8): '_64x8'}
SHAPES = ((2, 2, 2), (4, 4, 4), (7, 5, 9), (8, 8, 8), (16, 16, 16),
          (32, 32, 32), (64, 48, 48), (64, 64, 64), (128, 128, 128))
# K3's slab geometries timed at 64³ and 256³: (line rows, z-lines,
# stations) per block, e staged in shared memory or read directly.
RES_GEOMETRIES = ((2, 16, 1, False), (2, 16, 2, False), (2, 16, 4, False),
                  (2, 16, 2, True), (2, 16, 4, True), (2, 16, 8, True),
                  (2, 16, 16, True), (4, 8, 1, False), (4, 8, 4, True),
                  (4, 8, 16, True))
LINE_SHAPES = ((3, 3, 3), (7, 5, 9), (9, 7, 9), (64, 64, 64))
# Each line kernel alone against its plain version (lines along x) at
# 128³, the shape of scripts/hw_bisect_lr128.py, and at sclr256's finest
# level, where the kernels' int64 offsets are largest.
LR128 = (128, 128, 128)
LINE_LARGE = (LR128, (256, 256, 256))
# Short lines (32 stations) of many lines: the only shape where z of 16
# and 32 lines per block fits a block's shared memory.  K4 runs every
# launch plan here, at 64³ and at LINE_LARGE.
PLAN_SHAPE = (32, 256, 256)
POINT_SRC = 'emg3d_tpu_torch/csrc/point_gs.cu'
LINE_SRC = 'emg3d_tpu_torch/csrc/line_gs.cu'
KERNELS = {
    'factored': dict(name='point_gs_factored', source=POINT_SRC,
                     replaces='emg3d_tpu/ops/pallas_gs.py:958'),
    'fused': dict(name='point_gs_fused', source=POINT_SRC,
                  replaces='emg3d_tpu/ops/pallas_gs.py:1048'),
    'line_residual': dict(name='line_residual', source=LINE_SRC,
                          replaces='emg3d_tpu/ops/pallas_lr.py:846'),
    'line_thomas': dict(name='line_thomas', source=LINE_SRC,
                        replaces='emg3d_tpu/ops/pallas_lr.py:885'),
    'line_factor': dict(name='line_factor', source=LINE_SRC,
                        replaces='emg3d_tpu/ops/pallas_lr.py:356'),
}
# K6, the complex64 path's double-single residual (XLA on the TPU).
DSRES = dict(name='residual_ds', source='emg3d_tpu_torch/csrc/dsres.cu',
             replaces='emg3d_tpu/ops/dsres.py:170')
# The point kernels' step plan timed at sizes beyond SHAPES: 256³ (both
# kernels) and the finest level of the 512×384×384 hierarchy (K2 only:
# K1's factors there exceed FACTOR_SHARE of the card).
POINT_LARGE = ((256, 256, 256), (512, 384, 384))
# K5's block sizes (threads, one line each) timed by factor_plans.
FACTOR_BLOCKS = (32, 64, 128, 256)
# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): memory
# bandwidth, and fp64 and fp32 outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FP64 = 34e12
PEAK_FP32 = 67e12
# The H100's fp32 add rate, instructions per second (132 SMs × 128 lanes
# × 1.98 GHz): the double-single arithmetic's two-sums are adds, which
# the 67 TFLOP/s (an fma counted as two) overstates twofold.
PEAK_FP32_ADDS = 132 * 128 * 1.98e9
# Cycles per second of torch.cuda._sleep's spin (the H100's highest SM
# clock; a lower clock only spins longer).
SPIN_HZ = 1.98e9
SCLR = dict(semicoarsening=True, linerelaxation=True)
POINT_MODES = ('factored', 'fused')
LINE_KERNELS = ('line_residual', 'line_thomas', 'line_factor')
# Phase 17's multi-rank sc+lr cases and their solve options (sclr64's
# z-lines run the Schur-complement smoother on 2 ranks, tri64x48x40's
# y- and z-lines on 2×2), and the jobs of ranks that run the point and
# the sc+lr cases of one problem and mesh: ranks, mesh axes, cases.
LINE_SHARD_CASES = {'sclr64_z2': SCLR, 'tri64x48x40_sclr_yz4': SCLR,
                    'sclr64_bicgstab_z2': dict(SCLR, sslsolver=True)}
# Phase 17's complex64 cases on 2 ranks (bench64's source in complex64,
# float32 storage pinned): the point solve and sclr64 BiCGSTAB (z-lines
# Schur), held to the unsharded complex64 solves with it_mg and it_ssl
# ±1 (ROADMAP §3) and fields within TOL_C64_FIELD of them and of the
# complex128 solves.
C64_SHARD_CASES = {'bench64_c64_z2': {},
                   'sclr64_bicgstab_c64_z2': dict(SCLR, sslsolver=True)}
SHARD_JOBS = {
    'z2': (2, ('z',), ('bench64_z2', 'sclr64_z2', 'sclr64_bicgstab_z2',
                       'bench64_c64_z2', 'sclr64_bicgstab_c64_z2')),
    'yz4': (4, ('y', 'z'), ('tri64x48x40_yz4', 'tri64x48x40_sclr_yz4'))}
# Fullspace shapes (100 m cells) for the main path's second solve, in
# order of size; good multigrid numbers (p·2^k, p ≤ 3).
LARGE_SHAPES = ((512, 384, 384), (512, 512, 384), (512, 512, 512))
# Phase 10: lanes of the lane-kernel checks (two frequency groups,
# alternating), the Simulation's frequencies and its solver tolerance.
LANES = 8
SIM_FREQS = (0.5, 1.0)
SIM_TOL = 1e-6
# Phase 11: the times of the time-domain survey (its Fourier computes 19
# frequencies, 0.011-8.35 Hz).
TDEM_TIME = np.logspace(-1, 1, 21)
# Phase 12: tests/test_diff.py's unit samplers (x-edges) and its
# finite-difference cells, at 16³.
DIFF_EDGES = ((10, 8, 8), (5, 9, 7), (11, 11, 9))
DIFF_FD_CELLS = ((8, 8, 8), (10, 8, 8), (6, 9, 7))
PROBE_SRC = 'emg3d_tpu_torch/csrc/probes.cu'
# The probes' kernels in PROBE_SRC where not named as their wrapper.
PROBE_KERNELS = {'smem_limit': 'smem_stage'}
# Phase 14's shapes where bytes decide: tile_roll's tile, and tile_copy's
# array with its sub-boxes (the whole of it, timed, and one at a z
# offset of 13 floats); tile_roll's other checked tile (a width the
# shuffle plans refused); tile_copy's plans (box bytes, blocks per SM)
# timed at probe12's box and the whole array.
ROLL_LARGE = (256, 65536)
ROLL_ODD = (5, 1000)
COPY_LARGE = ((32, 46, 64, 384), [((0, 0, 0, 0), (32, 46, 64, 384)),
                                  ((1, 1, 3, 13), (30, 44, 60, 360))])
COPY_PLANS = ((8192, 2), (8192, 4), (8192, 8), (16384, 2), (16384, 4),
              (32768, 2))
# smem_sum's and station_solve's cases, each (f shape, chx, plane) or a
# tile: the probe's shape (fbuf5d's f at ty 8, Zp 256; station's (ty,
# Zp)), where bytes decide (3.09 GB f of which the sum reads 67 MB; 4.2M
# points at 200 B), and checked only: more than 256 stations (TMA's box
# limit) with ragged y and z boxes, and a point count that 4 does not
# divide.  Their plans timed: smem_sum's box bytes × blocks per SM ×
# stages at the large shape (32 blocks an SM: one box a block),
# station_solve's blocks per SM × points a thread at both (None: one
# group a thread, no grid-stride sweeps).
SUM_PROBE = ((64, 46, 8, 256), 8, 3)
SUM_LARGE = ((8, 46, 256, 8192), 8, 3)
SUM_ODD = ((300, 3, 5, 36), 300, 1)
STATION_PROBE = (8, 256)
STATION_LARGE = (64, 65536)
STATION_ODD = (5, 1001)
SUM_PLANS = ((4096, 2, 3), (8192, 2, 3), (16384, 1, 3), (16384, 2, 2),
             (16384, 2, 3), (16384, 2, 4), (16384, 4, 3), (16384, 32, 3))
STATION_PLANS = ((None, 4), (2, 4), (3, 4), (None, 1), (3, 1), (8, 1))
# The probes probe_turns times, and one SM's shared-memory rate (bytes a
# clock: 32 banks of 4 bytes), smem_limit's bound at the SM clock.
PROBES_TIMED = ('tile_roll', 'tile_copy', 'smem_sum', 'station_solve',
                'smem_limit')
SMEM_BYTES_PER_CLOCK = 128
# smem_limit's sizes: 48, 96 and 160 KB, then the card's opt-in and 16
# bytes past it (refused); its plans (bulk copies each way).
SMEM_SIZES = (48 * 1024, 96 * 1024, 160 * 1024)
SMEM_PLANS = (1, 8)
# The trace's names of the point kernels' instances (demangled or not):
# the last template argument is the kernel, 0 for K1, 1-2 for K2.
# Each instance also names its real type (double, float) last.
POINT_KERNEL_NAME = re.compile(r'point_gs_(?:sweep<\d+, ?(\d)[,>]|'
                               r'step<(\d)[,>]|'
                               r'sweepILi\dELi(\d)E|stepILi(\d)E)')
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def log(msg):
    print(msg, flush=True)


class Phase:
    """Prints one line per phase with its seconds."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== phase {self.name}: ok "
                f"({time.perf_counter() - self.t0:.2f} s)")
        return False


def nvidia_smi(query='name,power.limit', units=True):
    out = subprocess.run(
        ['nvidia-smi', f'--query-gpu={query}',
         '--format=csv,noheader' + ('' if units else ',nounits')],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_environment(torch):
    from emg3d_tpu_torch.ops import _build
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    nvcc = _build._nvcc()
    ver = subprocess.run([nvcc, '--version'], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    log(f"nvcc {nvcc}: {ver.strip().splitlines()[-1]}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not installed (not used by this package)")
    log(f"device count {torch.cuda.device_count()}, "
        f"device 0: {torch.cuda.get_device_name(0)}")
    log(nvidia_smi())


def phase_build():
    """Both libraries (solve kernels, probes) built at once: every nvcc
    of both starts together."""
    from concurrent.futures import ThreadPoolExecutor
    from emg3d_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.LIBRARIES)) as pool:
        built = list(pool.map(_build.build, _build.LIBRARIES))
    for name, (path, text) in zip(_build.LIBRARIES, built):
        _build.library(name)
        log(f"built {path}")
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line or \
                    'Compiling' in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build {time.perf_counter() - t0:.2f} s")


def _level(shape, seed, device, factored=True):
    """Level tensors of a random stretched anisotropic model."""
    import torch
    from emg3d_tpu_torch import TensorMesh, Model, VolumeModel, SourceField
    from emg3d_tpu_torch.ops import point_gs
    rng = np.random.default_rng(seed)
    grid = TensorMesh([rng.uniform(50, 150, n) for n in shape])
    model = Model(grid, *(rng.uniform(0.3, 30, shape) for _ in range(3)))
    sfield = SourceField.zeros(grid, frequency=1.0)
    vm = VolumeModel(grid, model, sfield)
    cplx = dict(dtype=torch.complex128, device=device)
    real = dict(dtype=torch.float64, device=device)
    arrays = tuple(torch.tensor(np.asarray(a), **cplx)
                   for a in (vm.eta_x, vm.eta_y, vm.eta_z)) + tuple(
        torch.tensor(np.asarray(a), **real)
        for a in (vm.zeta, *grid.h))
    edges = (grid.shape_edges_x, grid.shape_edges_y, grid.shape_edges_z)

    def rand():
        return tuple(torch.tensor(rng.standard_normal(sh)
                                  + 1j * rng.standard_normal(sh), **cplx)
                     for sh in edges)
    state = point_gs.point_state(arrays, shape, factored=factored)
    return state, rand(), rand()


def _level_fast(shape, seed, device, factored=True, dtype=None,
                storage=None):
    """Level tensors of a random stretched anisotropic model, made on
    the card (the sizes where numpy on the host would take minutes):
    η = −iωμ0·V·σ at 1 Hz, ζ = V, widths 50-150 m, σ 1/30-1/0.3 S/m;
    made in complex128/float64 and, for ``dtype`` complex64, rounded
    once to complex64/float32 (fields too); the point state's streams
    stored in ``storage``."""
    import torch
    from emg3d_tpu_torch.ops import point_gs
    g = torch.Generator(device=device).manual_seed(seed)
    real = dict(dtype=torch.float64, device=device, generator=g)

    def uni(lo, hi, *sh):
        return lo + (hi - lo) * torch.rand(*sh, **real)
    h = [uni(50, 150, n) for n in shape]
    vol = h[0][:, None, None] * h[1][None, :, None] * h[2][None, None, :]
    smu0 = -2j * math.pi * 4e-7 * math.pi
    eta = tuple(smu0 * vol / uni(0.3, 30, *shape) for _ in range(3))
    arrays = eta + (vol, *h)
    c64 = dtype == torch.complex64
    if c64:
        arrays = tuple(a.to(torch.complex64 if a.is_complex()
                            else torch.float32) for a in arrays)
    nx, ny, nz = shape
    edges = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
             (nx + 1, ny + 1, nz))

    def rand():
        return tuple(torch.complex(torch.randn(*sh, **real),
                                   torch.randn(*sh, **real))
                     .to(dtype or torch.complex128) for sh in edges)
    state = point_gs.point_state(arrays, shape, factored=factored,
                                 storage=storage)
    return state, rand(), rand()


def _maxdiff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _maxabs(a):
    return max(float(x.abs().max()) for x in a)


def bound(nbytes, flops, peak=PEAK_FP64):
    """bound_ms and bound_by of a call that must move ``nbytes`` and do
    ``flops`` operations at ``peak`` per second (fp64 by default)."""
    tb, tf = nbytes / PEAK_BYTES, flops / peak
    return {'bound_ms': max(tb, tf) * 1e3,
            'bound_by': 'bytes' if tb >= tf else 'operations'}


# Work of one call of each kernel: bytes with each input read once and
# each output written once; operations counting a complex product as 6,
# a complex sum as 2 and a complex reciprocal as 7.  ``size`` is the
# complex element's bytes (16: complex128, 8: complex64; a real one is
# half), the operations are in its precision.  ``stream`` (K1-K3: s, the
# η sums and the ζ weights) and ``fsize`` (K4, K5: the factor stack) are
# the bytes of a stored complex value where it is not ``size`` (4: a
# complex64 solve's bfloat16 storage).

def sum_work(shape, chx):
    """(bytes, flops) of smem_sum over ``chx`` stations of f ``shape``:
    the plane's chx·ty·Zp floats read, ty·Zp written; its adds are not
    counted (a fraction of an operation a byte)."""
    ty, zp = shape[2:]
    return 4 * (chx + 1) * ty * zp, 0


def station_work(tile):
    """(bytes, flops) of station_solve on a ``tile`` of points: 40
    floats read and 10 written a point; 20 complex products with a
    complex difference (8 each) and 5 products (6 each) a point, in
    fp32 (PEAK_FP32)."""
    points = int(np.prod(tile))
    return 50 * 4 * points, (20 * 8 + 5 * 6) * points


def smem_rows(nbytes):
    """probe_vmem's x for ``nbytes`` of scratch: (rows, 512) float32,
    the rows of its (rows, 512) scratch, at least the 8 it stages."""
    return max(8, nbytes // 2048), 512


def smem_work():
    """(device bytes, shared-memory bytes) of smem_limit: its 8 staged
    rows (16 KB) read from x and written back; in one SM's shared
    memory the staged rows written by the copy in and read by the copy
    out, and row 0 (2 KB) read and written by the add."""
    staged, row = 8 * 2048, 2048
    return 2 * staged, 2 * staged + 2 * row


def smem_bound(smem_bytes, mhz, nbytes=0):
    """smem_limit's bound: the larger of ``smem_bytes`` through one SM's
    shared memory at SMEM_BYTES_PER_CLOCK and ``mhz`` and ``nbytes`` of
    device memory at PEAK_BYTES."""
    ts = smem_bytes / (SMEM_BYTES_PER_CLOCK * mhz * 1e6)
    tb = nbytes / PEAK_BYTES
    return {'bound_ms': max(ts, tb) * 1e3,
            'bound_by': 'smem' if ts >= tb else 'bytes'}


def point_work(shape, mode, size=16, stream=None):
    """(bytes, flops) of one point colour step, the mean of 8 colours.

    Per active node: the six block edges' e read and written, s read,
    and 20 factors (K1, 704 B a node with the six η sums it reads) or
    its six η sums and twelve ζ face weights (K2, 480 B).  The residual
    stencil's other e values are not counted (so the bound is low).
    ~730 FLOP per node (six edge residuals, the 6×6 substitution); K2
    ~1590 with the block's assembly and LDLᵀ.
    """
    from emg3d_tpu_torch.ops import point_gs
    stream = stream or size
    nodes = sum(int(np.prod(point_gs.launch_geometry(shape, c)[1]))
                for c in range(8)) / 8
    if mode == 'factored':
        return nodes * (32 * size + 12 * stream), nodes * 730
    return nodes * (12 * size + 12 * stream + 12 * stream // 2), \
        nodes * 1590


def residual_work(shape, size=16):
    """(bytes, flops) of K3: e and s read and r written on every edge,
    η edge sums and ζ face weights read; ~76 FLOP per interior edge."""
    nx, ny, nz = shape
    edges = (nx * (ny + 1) * (nz + 1) + (nx + 1) * ny * (nz + 1)
             + (nx + 1) * (ny + 1) * nz)
    inner = ((nx * (ny - 1) * (nz - 1)) + (nx - 1) * ny * (nz - 1)
             + (nx - 1) * (ny - 1) * nz)
    faces = (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1)
    return 3 * edges * size + inner * size + faces * size // 2, inner * 76


def colour_residual_work(shape, color, size=16, stream=None):
    """(bytes, flops) of K3 on one colour of a rotated level: r written,
    s and η edge sums read at the colour's edges
    (``line_gs.colour_edges``), and every e value and ζ face weight
    their residuals need read once; ~76 FLOP per edge."""
    import torch
    from emg3d_tpu_torch.ops import line_gs
    nx, ny, nz = shape
    mx, my, mz = line_gs.colour_edge_masks(shape, color)
    n = int(mx.sum() + my.sum() + mz.sum())
    # Faces whose ζ-weighted curls the edges' residuals take.
    f1 = torch.zeros((nx + 1, ny, nz), dtype=torch.bool)
    f2 = torch.zeros((nx, ny + 1, nz), dtype=torch.bool)
    f3 = torch.zeros((nx, ny, nz + 1), dtype=torch.bool)
    f3 |= mx[:, :ny] | mx[:, 1:]
    f2 |= mx[:, :, :nz] | mx[:, :, 1:]
    f1 |= my[:, :, :nz] | my[:, :, 1:]
    f3 |= my[:nx] | my[1:]
    f2 |= mz[:nx] | mz[1:]
    f1 |= mz[:, :ny] | mz[:, 1:]
    # The e values of those curls.
    ex = torch.zeros((nx, ny + 1, nz + 1), dtype=torch.bool)
    ey = torch.zeros((nx + 1, ny, nz + 1), dtype=torch.bool)
    ez = torch.zeros((nx + 1, ny + 1, nz), dtype=torch.bool)
    for a, b in ((ez[:, :ny], f1), (ez[:, 1:], f1), (ey[:, :, :nz], f1),
                 (ey[:, :, 1:], f1), (ex[:, :, :nz], f2), (ex[:, :, 1:], f2),
                 (ez[:nx], f2), (ez[1:], f2), (ey[:nx], f3), (ey[1:], f3),
                 (ex[:, :ny], f3), (ex[:, 1:], f3)):
        a |= b
    reads = int(ex.sum() + ey.sum() + ez.sum())
    faces = int(f1.sum() + f2.sum() + f3.sum())
    stream = stream or size
    return (n * size + 2 * n * stream + reads * size + faces * stream // 2,
            n * 76)


def thomas_work(shape, color, size=16, fsize=None):
    """(bytes, flops) of K4 on one colour: per line and station 23
    factors, and 5 residuals read and 5 field values read and written
    (1 at the last station); ~530 FLOP per line-station."""
    from emg3d_tpu_torch.ops import line_gs
    nx = shape[0]
    g = line_gs.launch_geometry(shape, color)
    lines = g.counts[0] * g.counts[1]
    return (lines * (23 * nx * (fsize or size)
                     + 3 * (5 * (nx - 1) + 1) * size),
            lines * nx * 530)


def factor_work(shape, size=16, fsize=None):
    """(bytes, flops) of K5 on a rotated level: the η sums, ζ weights
    and inverse widths of the level read once, and the 23 planes of
    every line-station written once; ~430 FLOP at station 0 (the LDLᵀ),
    ~1550 at the others (five solves with C_{i-1}, the update of C_i,
    its LDLᵀ), ~100 for each station's assembly."""
    nx, ny, nz = shape
    lines = 4 * (ny // 2) * (nz // 2)
    sums = (nx * (ny - 1) * (nz - 1) + (nx - 1) * ny * (nz - 1)
            + (nx - 1) * (ny - 1) * nz)
    faces = (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1)
    return ((sums * size + (faces + nx + ny + nz) * size // 2
             + lines * nx * 23 * (fsize or size)),
            lines * (430 + 1550 * (nx - 1) + 100 * nx))


def dsres_work(shape, lanes=1):
    """(bytes, flops) of the double-single residual on a level: hi, lo
    and s read and r written at every edge (complex64), the η sums, ζ
    weights and widths read once.  Float32 operations (a two-sum 6, a
    double-single add 14, a coefficient product 11 with its fma as 2):
    150 per ζ-weighted face curl, each face an interior edge takes
    counted once (two double-single differences, three coefficient
    products, one difference), and 310 per interior edge (the second
    curl of its four faces, the η term, s − A·e, the fold).  K6 itself
    recomputes every face for each of its four edges (910 per edge);
    the bound counts what the function needs."""
    nx, ny, nz = shape
    edges = (nx * (ny + 1) * (nz + 1) + (nx + 1) * ny * (nz + 1)
             + (nx + 1) * (ny + 1) * nz)
    inner = ((nx * (ny - 1) * (nz - 1)) + (nx - 1) * ny * (nz - 1)
             + (nx - 1) * (ny - 1) * nz)
    faces = (nx + 1) * ny * nz + nx * (ny + 1) * nz + nx * ny * (nz + 1)
    used = (nx - 1) * ny * nz + nx * (ny - 1) * nz + nx * ny * (nz - 1)
    return (lanes * (4 * edges * 8 + inner * 8) + (faces + nx + ny + nz) * 4,
            lanes * (used * 150 + inner * 310))


def dsres_inner(shape):
    """Interior (non-PEC) edges of a level."""
    nx, ny, nz = shape
    return ((nx * (ny - 1) * (nz - 1)) + (nx - 1) * ny * (nz - 1)
            + (nx - 1) * (ny - 1) * nz)


def dsres_ops(shape, plan):
    """Float32 operations per interior edge that K6 does under ``plan``
    (counted as :func:`dsres_work` counts them: 150 a face curl, 22 a
    coefficient product, 310 an edge's own with its four products): it
    computes each face of its tile once per plane times the two widths
    its second curls take (194), its halo faces (u3 and u1 of the row
    below, u1 and u2 of the column below, where they exist) times the
    one they take there (172), one plane again in every chunk but the
    first, and 222 per edge (its own, less the products)."""
    nx, ny, nz = shape
    tj, tk = plan.tile
    tiles_j, tiles_k = -(-ny // tj), -(-nz // tk)
    jn, kn = min(ny + 1, tiles_j * tj), min(nz + 1, tiles_k * tk)
    main = ny * nz + jn * nz + ny * kn
    halo = (tiles_j - 1) * (kn + nz) + (tiles_k - 1) * (ny + jn)
    planes = nx + -(-nx // plan.chunk) - 1
    inner = dsres_inner(shape)
    return ((main * 194 + halo * 172) * planes + inner * 222) / inner


def factor_work_packed(shape):
    """(bytes, flops) of the first K5 design (on packed entries): per
    line 13 packed D planes read and 15 factor planes written at station
    0, 21 read and 15 written at the others."""
    nx, ny, nz = shape
    lines = 4 * (ny // 2) * (nz // 2)
    return (lines * (28 + 36 * (nx - 1)) * 16,
            lines * (430 + 1550 * (nx - 1)))


def _time_steps(torch, fn, reps=20, per=8, warm=3, prep=None):
    """Median device ms of one step, from reps calls of ``per`` steps
    each; ``prep`` runs before each call, outside the timed events.

    A spin kernel holds the stream while every call is enqueued, so the
    events time the card's work and not the host's dispatch (which
    would dominate a small level's launch).
    """
    def once():
        if prep is not None:
            prep()
        fn()
    for _ in range(warm):
        once()
    torch.cuda.synchronize()
    t = time.perf_counter()
    once()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda._sleep(int((2 * reps * host + 2e-3) * SPIN_HZ))
    events = []
    for _ in range(reps):
        if prep is not None:
            prep()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        events.append((t0, t1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) / per for a, b in events]))


def _sweep(torch, gs, e0, s, state, nu, mode, plan=None, seq=None):
    """Two runs of one smoothing call from ``e0``; bitwise equal."""
    outs = []
    for _ in range(2):
        e = tuple(t.clone() for t in e0)
        gs(e, s, state, nu, _mode=mode, _seq=seq, _plan=plan)
        outs.append(e)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError(f"{mode} {state.shape} plan {plan} seq {seq}: "
                             f"two runs differ")
    return outs[0]


def _variants(state, mode):
    """The states a kernel runs from: K1's; K2's with packed node data
    (packed here on every level, also where ``point_state`` packs none
    because the level's plan reads st and w) and without it (st and w
    read directly)."""
    from emg3d_tpu_torch.ops import point_gs
    if mode == 'factored':
        return {'': state}
    nodes = state.nodes
    if nodes is None:
        nodes = point_gs.pack_node_data(state.st, state.w, state.shape)
    return {'packed': state._replace(nodes=nodes),
            'direct': state._replace(nodes=None)}


def phase_kernels(torch, results, shapes=SHAPES, large=POINT_LARGE):
    """K1 and K2 under every plan their levels admit, against the plain
    version; each plan bitwise equal to the kernel's step plan, K2's
    packed node data bitwise equal to direct reads; the plan table (ms
    per nu=3 smoothing call) behind sweep_plan and point_kernel; the
    step plan at POINT_LARGE."""
    from emg3d_tpu_torch.ops import point_gs
    dev = torch.device('cuda')
    gs = point_gs.gauss_seidel_point
    for code in ('factored', 'fused', 'fused_packed'):
        cap = point_gs.grid_capacity(code)
        log(f"point_gs grid plan, {code}: {cap} co-resident blocks "
            f"(GRID_BLOCKS {point_gs.GRID_BLOCKS})")
        if cap < point_gs.GRID_BLOCKS:
            raise AssertionError("GRID_BLOCKS exceeds the co-resident "
                                 "blocks")
    table = {}
    for shape in shapes:
        for mode in POINT_MODES:
            state, e0, s = _level(shape, seed=sum(shape), device=dev,
                                  factored=mode == 'factored')
            plans = point_gs.plans_admitted(shape, mode)
            variants = _variants(state, mode)
            errs = []
            # Single colours, a nu=3 call and, at 8³, nu=9: more colour
            # steps than one sweep launch takes (consecutive launches).
            calls = [(1, (c,)) for c in range(8)] + [(3, None)]
            if shape == (8, 8, 8):
                calls.append((9, None))
            for nu, seq in calls:
                ref = tuple(t.clone() for t in e0)
                point_gs.gauss_seidel_point_plain(ref, s, state, nu,
                                                  _mode=mode, _seq=seq)
                base = None
                for v, st in variants.items():
                    for p in plans:
                        out = _sweep(torch, gs, e0, s, st, nu, mode, p, seq)
                        if base is None:
                            base = out       # the step plan, first variant
                        elif not all(torch.equal(a, b)
                                     for a, b in zip(out, base)):
                            raise AssertionError(
                                f"{mode} {shape} seq {seq}: plan {p} {v} "
                                f"differs from the step plan")
                errs.append((_maxdiff(base, ref), _maxabs(ref)))
            abs_err = max(a for a, _ in errs)
            worst = max(a / m for a, m in errs)
            nus = ', '.join(f"nu={nu}" for nu, seq in calls if seq is None)
            what = ' and '.join(variants) if mode == 'fused' else ''
            log(f"{KERNELS[mode]['name']} {shape}: max|Δ|/max|e| "
                f"{worst:.3e} (single colours, {nus}; plans "
                f"{', '.join(plans)}{' ' + what if what else ''} bitwise "
                f"equal to the step plan; repeat bitwise equal)")
            if not worst <= TOL_KERNEL:
                raise AssertionError(f"{mode} {shape}: {worst:.3e} > "
                                     f"{TOL_KERNEL}")
            res = results.setdefault(mode, {'max_abs_err': 0.0})
            res['max_abs_err'] = max(res['max_abs_err'], abs_err)
            ek = tuple(t.clone() for t in e0)
            first = next(iter(variants.values()))   # K1's, K2's packed
            for p in plans:
                table[shape, mode, p] = _time_steps(
                    torch, lambda: gs(ek, s, first, 3, _mode=mode, _plan=p),
                    reps=20, per=1)
            if mode == 'fused' and shape == shapes[-1]:
                # Packed node data against direct reads, chosen plan.
                direct = variants['direct']
                ms = _time_steps(torch, lambda: gs(ek, s, direct, 3),
                                 reps=20, per=1)
                pick = point_gs.sweep_plan(shape, 3, kernel=mode).plan
                log(f"point_gs_fused {shape}, {pick} plan, ms per nu=3 "
                    f"call: packed node data {table[shape, mode, pick]:.4f}"
                    f", direct reads {ms:.4f}")
                res['ms_direct_128'] = ms / 24
            if shape == (64, 64, 64):
                _time_point_64(torch, res, mode, state, e0, s)
            del state, e0, s, variants, ek
    _plan_table(table, shapes)
    for shape in large:
        _time_point_large(torch, results, shape, dev)


def _plan_table(table, shapes):
    """Log the table of ms per nu=3 call by kernel, plan and level."""
    from emg3d_tpu_torch.ops import point_gs
    plans = point_gs.PLANS
    log("ms per nu=3 smoothing call (24 colour steps), by kernel and plan;"
        " * = sweep_plan's choice; K = point_kernel's kernel on this card:")
    log("  shape          kernel  " + "".join(f"{p:>10}" for p in plans))
    for shape in shapes:
        for mode, name in zip(POINT_MODES, ('K1', 'K2')):
            pick = point_gs.sweep_plan(shape, 3, kernel=mode).plan
            cells = [f"{table[shape, mode, p]:9.4f}"
                     f"{'*' if p == pick else ' '}"
                     if (shape, mode, p) in table else f"{'-':>9} "
                     for p in plans]
            k = 'K' if point_gs.point_kernel(shape, 'cuda') == mode else ' '
            log(f"  {'x'.join(map(str, shape)):14} {name} {k}    "
                + "".join(cells))


def _time_point_64(torch, res, mode, state, e0, s):
    """ms per colour step at 64³ under the kernel's chosen plan (per
    nu=3 call / its steps), beside the plain version."""
    from emg3d_tpu_torch.ops import point_gs
    ek = tuple(t.clone() for t in e0)
    ep = tuple(t.clone() for t in e0)
    plan = point_gs.sweep_plan(state.shape, 3, kernel=mode)
    res['plan'] = plan.plan
    res['ms'] = _time_steps(torch, lambda: point_gs.gauss_seidel_point(
        ek, s, state, 3, _mode=mode), reps=20, per=plan.steps)
    res['plain_ms'] = _time_steps(torch, lambda: point_gs.
                                  gauss_seidel_point_plain(
                                      ep, s, state, 1, _mode=mode,
                                      _seq=tuple(range(8))))
    res.update(bound(*point_work(state.shape, mode)))
    log(f"{KERNELS[mode]['name']} 64³: {res['ms']:.4f} ms per colour "
        f"step ({plan.plan} plan); plain torch {res['plain_ms']:.4f} ms; "
        f"bound {res['bound_ms']:.4f} ms")


def _time_point_large(torch, results, shape, dev):
    """The step plan at a large level: ms per colour step (one nu=1
    call, 8 steps), bound and share; K2 with packed node data and with
    direct reads (bitwise equal), K1 where its factors fit."""
    from emg3d_tpu_torch.ops import point_gs
    gs = point_gs.gauss_seidel_point
    key = 'large' if shape == POINT_LARGE[-1] else 'x'.join(map(str, shape))
    for mode in POINT_MODES:
        if mode == 'factored' and not point_gs.factors_fit(shape, dev):
            continue
        state, e, s = _level_fast(shape, seed=11, device=dev,
                                  factored=mode == 'factored')
        bnd = bound(*point_work(shape, mode))['bound_ms']
        for v, st in _variants(state, mode).items():
            if mode == 'fused':
                outs = [_clone(e) for _ in range(2)]
                gs(outs[0], s, st, 1, _mode=mode, _seq=(0,), _plan='step')
                gs(outs[1], s, state._replace(nodes=None), 1, _mode=mode,
                   _seq=(0,), _plan='step')
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(*outs)):
                    raise AssertionError(f"fused {shape}: packed node data "
                                         f"differs from direct reads")
                del outs
            ek = _clone(e)
            ms = _time_steps(torch, lambda: gs(ek, s, st, 1, _mode=mode,
                                               _plan='step'),
                             reps=5, per=8, warm=1)
            log(f"{KERNELS[mode]['name']} {shape}{' ' + v if v else ''}, "
                f"step plan: {ms:.4f} ms per colour step, bound "
                f"{bnd:.4f} ms (bytes), {bnd / ms:.0%} of it")
            res = results[mode]
            if v in ('', 'packed'):
                res[f'ms_{key}'] = ms
                res[f'bound_ms_{key}'] = bnd
            else:
                res[f'ms_direct_{key}'] = ms
            del ek
        del state, e, s
        torch.cuda.empty_cache()


def _clone(f):
    return tuple(t.clone() for t in f)


def _check_kernel(name, shape, errs):
    """errs: (max|Δ|, max|ref|) pairs; returns the largest max|Δ|."""
    worst = max(a / m for a, m in errs)
    log(f"{name} {shape}: max|Δ|/max|ref| {worst:.3e}")
    if not worst <= TOL_KERNEL:
        raise AssertionError(f"{name} {shape}: {worst:.3e} > {TOL_KERNEL}")
    return max(a for a, _ in errs)


def _check_stack(shape, got, ref):
    """Per-plane max|Δ|/max|ref| of two factor stacks, each ≤ TOL_KERNEL;
    returns (worst ratio, max|Δ|)."""
    dims = (0, 2, 3, 4, 5)
    d = (got - ref).abs().amax(dim=dims).tolist()
    m = ref.abs().amax(dim=dims).tolist()
    ratios = [a / b if b > 0 else (0.0 if a == 0 else math.inf)
              for a, b in zip(d, m)]
    worst = max(ratios)
    log(f"line_factor {shape}: max over planes of max|Δ|/max|ref| "
        f"{worst:.3e} (repeat bitwise equal)")
    if not worst <= TOL_KERNEL:
        bad = [p for p, r in enumerate(ratios) if not r <= TOL_KERNEL]
        raise AssertionError(f"line_factor {shape}: planes {bad} exceed "
                             f"{TOL_KERNEL}")
    return worst, max(d)


def _factor_twice(torch, st, geometry=None):
    """K5 twice on a line state's parameters; bitwise equal."""
    from emg3d_tpu_torch.ops import line_gs
    outs = [line_gs.factor(st.st, st.w, st.ih, st.shape, geometry)
            for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(*outs):
        raise AssertionError(f"line_factor {st.shape}: two runs differ")
    return outs[0]


def factor_plans(torch, res, st, ref=None, reps=10, threads=FACTOR_BLOCKS):
    """K5 under each block size on the line state ``st``: each twice
    bitwise equal and bitwise equal to the chosen geometry (and, given
    ``ref``, within TOL_KERNEL of it), timed (ms per stack)."""
    from emg3d_tpu_torch.ops import line_gs
    shape = st.shape
    pick = line_gs.factor_geometry(shape)
    base = _factor_twice(torch, st)
    if ref is not None:
        _check_stack(shape, base, ref)
    cells = []
    for n in threads:
        g = line_gs.factor_geometry(shape, n)
        if not torch.equal(_factor_twice(torch, st, g), base):
            raise AssertionError(f"line_factor {shape}: geometry {g} "
                                 f"differs from {pick}")
        ms = _time_steps(torch, lambda: line_gs.factor(
            st.st, st.w, st.ih, shape, g), reps=reps, per=1)
        cells.append(f"{n}{'*' if g == pick else ''} {ms:.4f}")
    log(f"line_factor {'x'.join(map(str, shape))} ({pick.lines} lines), ms "
        f"per stack by threads per block (* = factor_geometry's choice; "
        f"all bitwise equal): " + ", ".join(cells))
    del base


def line_stack_shapes(shape):
    """The rotated shapes of the line states that an sc+lr solve of a
    ``shape`` fullspace builds (the solver's sc/lr schedule, by
    shapes)."""
    from emg3d_tpu_torch import solver
    from emg3d_tpu_torch.ops import smoothers
    var = solver.MGParameters(verb=0, cycle='F', sslsolver=False,
                              shape_cells=shape, **SCLR)
    out = set()
    for sc, lr in zip(var._raw_sc_cycle, var._raw_lr_cycle):
        shapes = [tuple(shape)]
        for _ in range(int(var.clevel[sc])):
            flags = solver._coarsen_flags(solver._current_sc_dir(
                sc, shapes[-1]))
            shapes.append(tuple(n // 2 if f else n
                                for n, f in zip(shapes[-1], flags)))
        for sh in shapes:
            for ax in solver._lr_axes(solver._current_lr_dir(lr, sh)):
                out.add((sh, ax))
    return sorted(out)


def phase_line_kernels(torch, results, device='cuda', shapes=LINE_SHAPES,
                       plan_shape=PLAN_SHAPE, large=LINE_LARGE):
    from emg3d_tpu_torch.ops import line_gs, smoothers, stencil
    dev = torch.device(device)
    res = {k: results.setdefault(k, {'max_abs_err': 0.0})
           for k in ('line_residual', 'line_thomas', 'line_factor')}
    for shape in shapes:
        pstate, e0, s = _level(shape, seed=sum(shape) + 1, device=dev)
        errs = {'line_residual': [], 'line_thomas': []}
        for axis in range(3):
            st = line_gs.line_state(pstate.arrays, shape, axis)
            # K5 against the plain elimination on the same card, all 23
            # planes.
            ref = smoothers.line_factor_stack(st.arrays, st.shape)
            fk = _factor_twice(torch, st)
            if not torch.equal(fk, st.factors):
                raise AssertionError(f"line_factor {shape}: line_state's "
                                     f"stack differs from K5's")
            _, dmax = _check_stack((*shape, 'axis', axis), fk, ref)
            res['line_factor']['max_abs_err'] = max(
                res['line_factor']['max_abs_err'], dmax)
            del fk, ref
            er = tuple(t.contiguous() for t in
                       smoothers.rotate_fields(e0, axis))
            sr = tuple(t.contiguous() for t in
                       smoothers.rotate_fields(s, axis))
            # K3 alone, per colour, against the restricted plain residual.
            for color in range(4):
                errs['line_residual'].append(
                    _check_residual(torch, st, er, sr, color))
            rp = stencil.residual_parts(*sr, *er, *st.arrays)
            # K4 alone against line_thomas_x, from the same residual.
            for color in range(4):
                ek = line_gs.thomas(_clone(er), rp, st.factors, st, color)
                ep = smoothers.line_thomas_x(er, rp, st.factors, color)
                torch.cuda.synchronize()
                errs['line_thomas'].append((_maxdiff(ek, ep), _maxabs(ep)))
            # Colour steps through the wrapper (K3 + K4): twice, bitwise
            # equal; against the plain version; then a nu=2 sweep.
            for seq in [(c,) for c in range(4)] + [None]:
                nu = 2 if seq is None else 1
                outs = []
                for _ in range(2):
                    e = _clone(e0)
                    line_gs.line_relaxation(e, s, st, nu, _seq=seq)
                    outs.append(e)
                ref = _clone(e0)
                line_gs.line_relaxation_plain(ref, s, st, nu, _seq=seq)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(*outs)):
                    raise AssertionError(f"line {shape} axis {axis} "
                                         f"{seq}: two runs differ")
                if not all(bool(torch.isfinite(t).all()) for t in outs[0]):
                    raise AssertionError(f"line {shape} axis {axis} {seq}: "
                                         f"non-finite field (a read of the "
                                         f"residual off the colour's edges)")
                errs['line_thomas'].append((_maxdiff(outs[0], ref),
                                            _maxabs(ref)))
            if shape == (64, 64, 64) and axis == 0:
                _time_line_64(torch, res, shape, st, e0, s, er, sr, rp)
                residual_plans(torch, st, er, sr, reps=20)
                thomas_plans(torch, res, st, er, rp, colors=(0, 3), reps=20)
        for k, v in errs.items():
            res[k]['max_abs_err'] = max(res[k]['max_abs_err'],
                                        _check_kernel(k, shape, v))
    # K5's geometries at sclr64's rotated levels (4-64 stations, 256-4096
    # lines).
    for rs in sorted({smoothers.rotate_shape(sh, ax)
                      for sh, ax in line_stack_shapes((64, 64, 64))}):
        pstate, _, _ = _level(rs, seed=sum(rs), device=dev, factored=False)
        st = line_gs.line_state(pstate.arrays, rs, 0, factors=False)
        factor_plans(torch, res['line_factor'], st,
                     ref=smoothers.line_factor_stack(st.arrays, st.shape),
                     reps=20)
        del pstate, st
    if plan_shape is not None:
        pstate, e, s = _level(plan_shape, seed=5, device=dev,
                              factored=False)
        st = line_gs.line_state(pstate.arrays, plan_shape, 0)
        factor_plans(torch, res['line_factor'], st, reps=10)
        r = stencil.residual_parts(*s, *e, *st.arrays)
        thomas_plans(torch, res, st, e, r, colors=(0, 3), reps=10)
        del pstate, e, s, st, r
    for shape in large:
        _line_kernels_large(torch, res, shape, dev)


def _nan_like(f):
    import torch
    return tuple(torch.full_like(t, complex(math.nan, math.nan)) for t in f)


def _check_residual(torch, st, e, s, color):
    """K3 on one colour into a NaN-filled buffer, twice (bitwise equal),
    against ``line_gs.residual_plain`` into one: the same entries NaN
    (nothing written off the colour's edges), the others finite.
    Returns (max|Δ|, max|ref|) over the colour's edges."""
    from emg3d_tpu_torch.ops import line_gs
    outs = [line_gs.residual(e, s, st, color, _nan_like(e))
            for _ in range(2)]
    ref = line_gs.residual_plain(e, s, st, color, _nan_like(e))
    torch.cuda.synchronize()
    where = f"line_residual {st.shape} axis {st.axis} colour {color}"
    for a, b, p in zip(*outs, ref):
        if not torch.equal(torch.isnan(a), torch.isnan(b)) or \
                not torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)]):
            raise AssertionError(f"{where}: two runs differ")
        if not torch.equal(torch.isnan(a), torch.isnan(p)):
            raise AssertionError(f"{where}: entries written are not the "
                                 f"colour's edges")
    on = [(a[~torch.isnan(p)], p[~torch.isnan(p)]) for a, p in
          zip(outs[0], ref)]
    if not all(bool(torch.isfinite(a).all()) for a, _ in on):
        raise AssertionError(f"{where}: non-finite residual")
    return (max((float((a - p).abs().max()) if a.numel() else 0.0)
                for a, p in on),
            max((float(p.abs().max()) if p.numel() else 0.0)
                for _, p in on))


def residual_plans(torch, st, e, s, reps, geometries=RES_GEOMETRIES):
    """K3 under each slab geometry on the x-line state ``st``: bitwise
    equal to the default one on every colour, and timed (median ms per
    launch over the four colours)."""
    from emg3d_tpu_torch.ops import line_gs
    shape = st.shape
    base = [line_gs.residual(e, s, st, c, _nan_like(e)) for c in range(4)]
    default = line_gs.residual_geometry(shape, 0)
    for rows, lines, xplanes, staged in geometries:
        gs = [line_gs.residual_geometry(shape, c, rows, lines, xplanes,
                                        staged) for c in range(4)]
        for c, g in enumerate(gs):
            out = line_gs.residual(e, s, st, c, _nan_like(e), g)
            torch.cuda.synchronize()
            if not all(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
                       for a, b in zip(out, base[c])):
                raise AssertionError(f"line_residual {shape} colour {c}: "
                                     f"geometry {g} differs from default")
        out = _nan_like(e)
        ms = _time_steps(torch, lambda: [line_gs.residual(e, s, st, c, out,
                                                          g)
                                         for c, g in enumerate(gs)],
                         reps=reps, per=4)
        chosen = gs[0] == default
        log(f"line_residual {shape}, {rows} rows × {lines} lines × "
            f"{xplanes} stations per block, e "
            f"{'staged' if staged else 'direct'}"
            f"{' (chosen)' if chosen else ''}: {ms:.4f} ms per launch, "
            f"{gs[0].blocks} blocks of {gs[0].threads} threads, "
            f"{gs[0].smem_bytes} B shared; bitwise equal to the default")


def _colour_bound(shape, size=16, peak=PEAK_FP64, stream=None):
    """K3's bound_ms averaged over the four colours, its bound_by, and
    the whole level's bound_ms (``bound_ms_full``)."""
    work = [bound(*colour_residual_work(shape, c, size, stream), peak)
            for c in range(4)]
    return {'bound_ms': sum(w['bound_ms'] for w in work) / 4,
            'bound_by': work[0]['bound_by'],
            'bound_ms_full': bound(*residual_work(shape, size),
                                   peak)['bound_ms']}


def _time_line_64(torch, res, shape, st, e0, s, er, sr, rp):
    """ms per launch of K3 (mean of the four colours), K4 and K5 at 64³
    (x-lines), beside plain."""
    from emg3d_tpu_torch.ops import line_gs, smoothers, stencil
    rk = _nan_like(er)
    res['line_residual']['ms'] = _time_steps(
        torch, lambda: [line_gs.residual(er, sr, st, c, rk)
                        for c in range(4)], reps=50, per=4)
    rq = _nan_like(er)
    res['line_residual']['plain_ms'] = _time_steps(
        torch, lambda: [line_gs.residual_plain(er, sr, st, c, rq)
                        for c in range(4)], reps=20, per=4)
    res['line_residual'].update(_colour_bound(shape))
    ek = _clone(er)
    zs = line_gs._scratch(st.shape, er[0])
    res['line_thomas']['ms'] = _time_steps(
        torch, lambda: line_gs.thomas(ek, rp, st.factors, st, 0, zs),
        reps=50, per=1)
    res['line_thomas']['plain_ms'] = _time_steps(
        torch, lambda: smoothers.line_thomas_x(er, rp, st.factors, 0),
        reps=5, per=1, warm=1)
    res['line_thomas'].update(bound(*thomas_work(shape, 0)))
    e = _clone(e0)
    step_ms = _time_steps(torch, lambda: line_gs.line_relaxation(
        e, s, st, 1), reps=20, per=4)
    step_plain = _time_steps(
        torch, lambda: line_gs.line_relaxation_plain(
            e, s, st, 1, _seq=(0,)), reps=5, per=1, warm=1)
    res['line_thomas']['step_ms'] = step_ms
    res['line_thomas']['step_plain_ms'] = step_plain
    res['line_factor']['ms'] = _time_steps(
        torch, lambda: line_gs.factor(st.st, st.w, st.ih, st.shape),
        reps=20, per=1)
    res['line_factor']['plain_ms'] = _time_steps(
        torch, lambda: smoothers.line_factor_stack(st.arrays, st.shape),
        reps=3, per=1, warm=1)
    res['line_factor'].update(bound(*factor_work(st.shape)))
    res['line_factor']['bound_ms_packed'] = bound(
        *factor_work_packed(st.shape))['bound_ms']
    factor_plans(torch, res['line_factor'], st, reps=20)
    log(f"64³ x-lines, ms per launch: line_factor "
        f"{res['line_factor']['ms']:.4f} (plain, entries included, "
        f"{res['line_factor']['plain_ms']:.4f}), line_residual "
        f"{res['line_residual']['ms']:.4f} per colour (plain "
        f"{res['line_residual']['plain_ms']:.4f}), line_thomas "
        f"{res['line_thomas']['ms']:.4f} (plain "
        f"{res['line_thomas']['plain_ms']:.4f}); colour step "
        f"{step_ms:.4f} (plain {step_plain:.4f}); bounds "
        f"{res['line_factor']['bound_ms']:.4f}, "
        f"{res['line_residual']['bound_ms']:.4f} (whole level "
        f"{res['line_residual']['bound_ms_full']:.4f}), "
        f"{res['line_thomas']['bound_ms']:.4f}")


def _line_kernels_large(torch, res, shape, dev):
    """K5, K3 and K4 alone against their plain versions on x-lines at
    ``shape``, K5 and K3 under every launch plan, K4 under every plan on
    all four colours, then each timed (K3 and K4 beside plain).  The
    readings land under keys ending in ``_<nx>`` (``ms_128``,
    ``plain_ms_256``, ...): ms per launch, bounds, the shape's max|Δ|
    and the launches its checks made (``check_launches_<nx>``)."""
    from emg3d_tpu_torch.ops import line_gs, smoothers, stencil
    n = f'_{shape[0]}'
    n0 = dict(line_gs.LAUNCHES)
    pstate, e, s = _level(shape, seed=7, device=dev, factored=False)
    st = line_gs.line_state(pstate.arrays, shape, 0)
    fk = _factor_twice(torch, st)
    if not torch.equal(fk, st.factors):
        raise AssertionError(f"line_factor {shape}: line_state's stack "
                             f"differs from K5's")
    del fk
    ref = smoothers.line_factor_stack(st.arrays, st.shape)
    _, dmax = _check_stack(shape, st.factors, ref)
    res['line_factor']['max_abs_err'] = max(
        res['line_factor']['max_abs_err'], dmax)
    res['line_factor']['max_abs_err' + n] = dmax
    del ref
    torch.cuda.empty_cache()
    factor_plans(torch, res['line_factor'], st, reps=5)
    torch.cuda.empty_cache()
    errs = [_check_residual(torch, st, e, s, c) for c in range(4)]
    e3 = _check_kernel('line_residual', shape, errs)
    res['line_residual']['max_abs_err'] = max(
        res['line_residual']['max_abs_err'], e3)
    res['line_residual']['max_abs_err' + n] = e3
    residual_plans(torch, st, e, s, reps=5)
    rp = stencil.residual_parts(*s, *e, *st.arrays)
    res['line_thomas']['max_abs_err' + n] = thomas_plans(
        torch, res, st, e, rp, colors=range(4), reps=5)
    for k in n0:
        res[k]['check_launches' + n] = line_gs.LAUNCHES[k] - n0[k]
    out = _nan_like(e)
    res['line_residual']['ms' + n] = _time_steps(
        torch, lambda: [line_gs.residual(e, s, st, c, out)
                        for c in range(4)], reps=10, per=4)
    res['line_residual']['plain_ms' + n] = _time_steps(
        torch, lambda: [line_gs.residual_plain(e, s, st, c, out)
                        for c in range(4)], reps=3, per=4, warm=1)
    cb = _colour_bound(shape)
    res['line_residual']['bound_ms' + n] = cb['bound_ms']
    res['line_residual']['bound_ms_full' + n] = cb['bound_ms_full']
    zs = line_gs._scratch(st.shape, e[0])
    ek = _clone(e)
    res['line_thomas']['ms' + n] = _time_steps(
        torch, lambda: line_gs.thomas(ek, rp, st.factors, st, 0, zs),
        reps=10, per=1)
    res['line_thomas']['plain_ms' + n] = _time_steps(
        torch, lambda: smoothers.line_thomas_x(e, rp, st.factors, 0),
        reps=2, per=1, warm=1)
    res['line_thomas']['bound_ms' + n] = bound(
        *thomas_work(shape, 0))['bound_ms']
    del out, zs, rp, ek
    torch.cuda.empty_cache()
    res['line_factor']['ms' + n] = _time_steps(
        torch, lambda: line_gs.factor(st.st, st.w, st.ih, st.shape),
        reps=5, per=1, warm=1)
    res['line_factor']['bound_ms' + n] = bound(
        *factor_work(st.shape))['bound_ms']
    res['line_factor']['bound_ms_packed' + n] = bound(
        *factor_work_packed(st.shape))['bound_ms']
    r3, r4, r5 = (res[k] for k in ('line_residual', 'line_thomas',
                                   'line_factor'))
    log(f"{shape} x-lines, ms per launch: line_factor {r5['ms' + n]:.4f} "
        f"(bound {r5['bound_ms' + n]:.4f}), line_residual "
        f"{r3['ms' + n]:.4f} per colour (plain {r3['plain_ms' + n]:.4f}; "
        f"bound {r3['bound_ms' + n]:.4f}; whole level "
        f"{r3['bound_ms_full' + n]:.4f}), line_thomas {r4['ms' + n]:.4f} "
        f"(plain {r4['plain_ms' + n]:.4f}; bound {r4['bound_ms' + n]:.4f})"
        f"; launches in the checks "
        f"{ {k: res[k]['check_launches' + n] for k in n0} }")
    del pstate, st, e, s
    torch.cuda.empty_cache()


def thomas_plans(torch, res, st, e, r, colors, reps):
    """K4 under every launch plan of the x-line state ``st``: 1-32 lines
    per block with z in global memory and, where it fits the block, in
    shared memory; each run twice (bitwise equal) and held against
    ``smoothers.line_thomas_x`` from the same residual ``r``, and timed
    (median ms per launch) on the first colour.  Returns the largest
    max|Δ|."""
    from emg3d_tpu_torch.ops import line_gs, smoothers
    shape = st.shape
    zs = line_gs._scratch(shape, e[0])
    errs = []
    for color in colors:
        pick = line_gs.launch_geometry(shape, color)
        ep = smoothers.line_thomas_x(e, r, st.factors, color)
        for lpb in (1, 2, 4, 8, 16, 32):
            for z_shared in (True, False):
                try:
                    g = line_gs.launch_geometry(shape, color, lpb, z_shared)
                except ValueError:       # z does not fit the block
                    continue
                outs = [line_gs.thomas(_clone(e), r, st.factors, st, color,
                                       zs, g) for _ in range(2)]
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(*outs)):
                    raise AssertionError(f"line_thomas {shape} colour "
                                         f"{color} plan {g}: two runs "
                                         f"differ")
                errs.append((_maxdiff(outs[0], ep), _maxabs(ep)))
                del outs
                msg = (f"line_thomas {shape} colour {color}, {lpb:2d} lines "
                       f"per block, z {'shared' if z_shared else 'global'}"
                       f"{' (chosen)' if g == pick else ''}: max|Δ|/max|ref| "
                       f"{errs[-1][0] / errs[-1][1]:.3e}")
                if color == colors[0]:
                    et = _clone(e)
                    ms = _time_steps(torch, lambda: line_gs.thomas(
                        et, r, st.factors, st, color, zs, g), reps=reps,
                        per=1)
                    msg += (f", {ms:.4f} ms, {g.blocks} blocks, "
                            f"{g.smem_bytes} B shared")
                    del et
                log(msg)
        del ep
    dmax = _check_kernel('line_thomas plans', shape, errs)
    res['line_thomas']['max_abs_err'] = max(
        res['line_thomas']['max_abs_err'], dmax)
    return dmax


def bench_problem(shape=(64, 64, 64)):
    """bench.py's configuration (bench.py:37-52), in the port."""
    from emg3d_tpu_torch import TensorMesh, Model, SourceField
    grid = TensorMesh([np.full(n, 100.) for n in shape])
    model = Model(grid, property_x=1.0, mapping='Resistivity')
    sfield = SourceField.zeros(grid, frequency=1.0)
    np.asarray(sfield.fx)[tuple(n // 2 for n in shape)] = 1.0
    return grid, model, sfield


def point_cycle_calls(grid, model, sfield, device='cpu', **kw):
    """(shape, nu) of every point-smoothing call of one top-level cycle.

    Runs the solver's own cycle (``solver.run_one_cycle``) on
    ``device`` on the levels it builds for this problem and options,
    with the smoother replaced by a recorder; the cycle's calls do not
    depend on the field.  :func:`point_per_cycle` turns them into each
    kernel's launches.
    """
    import torch
    from unittest import mock
    from emg3d_tpu_torch import VolumeModel, solver
    var = solver.MGParameters(verb=0, cycle=kw.pop('cycle', 'F'),
                              sslsolver=False, linerelaxation=False,
                              semicoarsening=False,
                              shape_cells=grid.shape_cells, **kw)
    vm = VolumeModel(grid, model, sfield)
    sc = int(var.sc_dir)
    levels = solver.build_levels(grid, vm, sc, int(var.clevel[sc]),
                                 torch.device(device), {'bytes': 0})
    calls = []

    def record(e, s, lev, nu, lr_dir, mode=None, storage=None):
        if nu > 0:
            calls.append((lev.shape, nu))
        return e
    e = tuple(torch.zeros(sh, dtype=torch.complex128, device=device)
              for sh in solver._edge_shapes(grid.shape_cells))
    conf = (var.nu_pre, var.nu_coarse, var.nu_post, var.cycle,
            int(var.lr_dir))
    with mock.patch.object(solver, '_smooth', record):
        solver.run_one_cycle(e, e, levels, conf)
    return calls


def point_per_cycle(calls, kernel, plan=None):
    """{kernel: (launches, colour steps)} over ``calls``, each call on
    the kernel ``kernel(shape)`` names (``point_gs.point_kernel`` on the
    card) under its ``sweep_plan``."""
    from emg3d_tpu_torch.ops import point_gs
    out = {k: [0, 0] for k in point_gs.KERNELS}
    for sh, nu in calls:
        k = kernel(sh)
        p = point_gs.sweep_plan(sh, nu, plan=plan, kernel=k)
        out[k][0] += p.launches
        out[k][1] += p.steps
    return {k: tuple(v) for k, v in out.items()}


def large_shape(torch):
    """First of LARGE_SHAPES whose finest factor stack does not fit."""
    from emg3d_tpu_torch.ops import point_gs
    for shape in LARGE_SHAPES:
        if not point_gs.factors_fit(shape, torch.device('cuda')):
            return shape
    raise AssertionError("every shape of LARGE_SHAPES fits the factored "
                         "kernel on this card")


def _rel(a, b):
    return float(np.linalg.norm(a.field - b.field) /
                 np.linalg.norm(b.field))


@contextlib.contextmanager
def _switch(module, name, value):
    """``module.name`` set to ``value`` for the block, restored after."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _plain(on=True):
    """The block runs every op's plain version, on the card too
    (``ops._build.PLAIN``)."""
    from emg3d_tpu_torch.ops import _build
    return _switch(_build, 'PLAIN', on)


def _solve(torch, grid, model, sfield, **kw):
    from emg3d_tpu_torch import solve
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e, info = solve(grid, model, sfield, cycle='F', tol=1e-6, verb=1,
                    return_info=True, device='cuda', **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if info['exit_message'] != 'CONVERGED':
        raise AssertionError(f"solve {kw}: {info['exit_message']}")
    if not all(np.isfinite(f).all() for f in (e.fx, e.fy, e.fz)):
        raise AssertionError(f"solve {kw}: non-finite field")
    return e, info, wall


def heterogeneous_problem(seed=64):
    """Tri-axial random model on stretched 64×48×40 cells."""
    from emg3d_tpu_torch import TensorMesh, Model, get_source_field
    rng = np.random.default_rng(seed)
    shape = (64, 48, 40)
    h = [100. * 1.04 ** np.abs(np.arange(n) - (n - 1) / 2) for n in shape]
    grid = TensorMesh(h, origin=tuple(-hh.sum() / 2 for hh in h))
    rho_x = 10 ** rng.uniform(0, 1, shape)
    model = Model(grid, rho_x, rho_x * rng.uniform(1, 2, shape),
                  rho_x * rng.uniform(1, 3, shape), mapping='Resistivity')
    sfield = get_source_field(grid, (-50., 50., 0., 0., 0., 0.), 1.0)
    return grid, model, sfield


class Clock:
    """Host seconds spent in ``module.attr`` while active, each call
    ending in a synchronize, the number of calls and, given ``record``,
    ``record(result)`` of each call in ``records``.  The package calls
    ``line_gs.line_state`` and ``solver.solve`` through their modules,
    so patching the module's attribute sees every call."""

    def __init__(self, module, attr, record=None):
        self._mod, self._attr, self._record = module, attr, record

    def __enter__(self):
        import torch
        self.seconds, self.calls, self.records = 0.0, 0, []
        self._real = real = getattr(self._mod, self._attr)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            if self._record is not None:
                self.records.append(self._record(out))
            return out
        setattr(self._mod, self._attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self._attr, self._real)
        return False


def line_state_clock():
    """A :class:`Clock` of the line states' builds (parameters and
    factor stacks)."""
    from emg3d_tpu_torch.ops import line_gs
    return Clock(line_gs, 'line_state')


def phase_sclr64(torch, grid, model, sfield):
    """The production path, cold (launches counted) then warm.  Returns
    the launches, the cold BiCGSTAB solve's field and the cold standalone
    and BiCGSTAB solves' (field, info)."""
    from emg3d_tpu_torch.ops import line_gs
    runs = (('standalone', False), ('bicgstab', True), ('cgs', 'cgs'))
    line_gs.reset_launches()
    cold = {}
    for name, ssl in runs:
        with line_state_clock() as clock:
            cold[name] = (*_solve(torch, grid, model, sfield, sslsolver=ssl,
                                  **SCLR), clock)
    launches = dict(line_gs.LAUNCHES)
    log(f"sclr64 launches of the three cold solves: {launches}")
    if min(launches.values()) == 0:
        raise AssertionError("the sc+lr solves launched no line kernel")
    for name, ssl in runs:
        _, info, wall, cclock = cold[name]
        with line_state_clock() as clock:
            _, winfo, warm = _solve(torch, grid, model, sfield,
                                    sslsolver=ssl, **SCLR)
        log(f"sclr64 {name}: it_mg {info['it_mg']}, it_ssl "
            f"{info['it_ssl']}, rel_error {info['rel_error']:.3e}, cold "
            f"wall {wall:.3f} s ({cclock.seconds:.4f} s in "
            f"{cclock.calls} line-state builds), warm wall {warm:.3f} s "
            f"({clock.seconds:.4f} s in {clock.calls} builds; it_mg "
            f"{winfo['it_mg']})")
    return launches, cold['bicgstab'][0], {
        name: cold[name][:2] for name in ('standalone', 'bicgstab')}


def kernel_key(name):
    """The package kernel (``KERNELS`` key) of a trace kernel name, or
    None."""
    m = POINT_KERNEL_NAME.search(name)
    if m:
        code = int(next(g for g in m.groups() if g is not None))
        return 'factored' if code == 0 else 'fused'
    return next((k for k in ('line_residual', 'line_thomas', 'line_factor')
                 if k in name), None)


def trace_times(prof, path):
    """Device readings of a ``torch.profiler`` run, from its Chrome trace
    (written to ``path``): the busy seconds (union of the kernel, memcpy
    and memset intervals), the number of device events, and
    ``{name: [ms, count]}`` per kernel name (copies as ``[cat] name``)."""
    from collections import defaultdict
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(Path(path).read_text())['traceEvents']
              if e.get('ph') == 'X' and e.get('cat') in DEVICE_CATS]
    spans, busy, end = sorted((e['ts'], e['ts'] + e['dur'])
                              for e in events), 0.0, float('-inf')
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    per = defaultdict(lambda: [0.0, 0])
    for e in events:
        key = e['name'] if e['cat'] == 'kernel' else \
            f"[{e['cat']}] {e['name']}"
        per[key][0] += e['dur'] / 1e3
        per[key][1] += 1
    return busy / 1e6, len(events), dict(per)


def _profile(torch, fn, path):
    """Run ``fn`` under torch.profiler; returns (wall, busy seconds,
    device events, {kernel key: [ms, launches]}) from its trace."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, nev, per = trace_times(prof, path)
    ms = {}
    for name, (t, n) in per.items():
        k = kernel_key(name)
        if k is not None:
            ms[k] = [ms.get(k, [0.0, 0])[0] + t, ms.get(k, [0, 0])[1] + n]
    return wall, busy, nev, ms


def _kernel_ms(ms):
    return ", ".join(f"{KERNELS[k]['name']} {t:.3f} ({n})"
                     for k, (t, n) in sorted(ms.items()))


def simulation_problem(n=64, res=1.0):
    """Phase 10's Simulation inputs: bench64's fullspace (``bench.py:
    37-52``: 100 m cells at 64³, 1 Ω·m) centred on the origin, 4
    x-directed electric point dipoles along x at y = z = 0, 400 m apart
    and centred, a line of 16 x-directed electric receivers from 2 to
    3 km along x, frequencies SIM_FREQS.  ``n`` cells per axis cover the
    same 6.4 km (400 m cells at 16³).  Returns (grid, model, survey)."""
    from emg3d_tpu_torch import TensorMesh, Model, Survey
    grid = TensorMesh([np.full(n, 6400. / n)] * 3, origin=(-3200.,) * 3)
    model = Model(grid, property_x=res, mapping='Resistivity')
    survey = Survey('phase10', ((-600., -200., 200., 600.), 0., 0., 0., 0.),
                    (np.linspace(2000., 3000., 16), 0., 0., 0., 0.),
                    SIM_FREQS, noise_floor=1e-15, relative_error=0.05)
    return grid, model, survey


def _lane_setup(torch, shape, axis, seed, dev):
    """A lane state of LANES lanes in two frequency groups (η and 2η of a
    random level: the same σ at twice the frequency) and random (LANES,
    ...) e and s in the rotated frame."""
    from emg3d_tpu_torch.ops import line_gs
    pstate, _, _ = _level(shape, seed, dev)
    ar = pstate.arrays
    arrays = tuple(torch.stack([a, 2 * a]) for a in ar[:3]) + ar[3:]
    lanes = torch.tensor([b % 2 for b in range(LANES)], dtype=torch.int32,
                         device=dev)
    st = line_gs.line_state(arrays, shape, axis, lanes=lanes)
    g = torch.Generator(device=dev).manual_seed(seed)
    nx, ny, nz = shape

    def rand():
        return tuple(torch.complex(torch.randn((LANES,) + sh, device=dev,
                                               dtype=torch.float64,
                                               generator=g),
                                   torch.randn((LANES,) + sh, device=dev,
                                               dtype=torch.float64,
                                               generator=g))
                     for sh in ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                                (nx + 1, ny + 1, nz)))
    e, s = rand(), rand()
    return st, e, s, line_gs._rotated(e, axis), line_gs._rotated(s, axis)


def _nan_equal(a, b):
    """Bitwise equal, NaN where the other is NaN."""
    import torch
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def phase_lane_kernels(torch, results, shapes=LINE_SHAPES):
    """K3 and K4 over LANES lanes of two frequency groups in one launch:
    bitwise equal to one launch per lane, within TOL_KERNEL of the plain
    versions lane by lane (at 64³ lanes 0 and 1, one per group); K5 per
    group bitwise equal to its one-lane stack; the wrapper's sweep
    against the plain one; ms per 8-lane launch at 64³ beside 8 one-lane
    launches.  Returns the 64³ readings."""
    from emg3d_tpu_torch.ops import line_gs, smoothers, stencil
    dev = torch.device('cuda')
    errs = {'line_residual': [], 'line_thomas': []}
    out = {}
    for shape in shapes:
        big = shape == (64, 64, 64)
        for axis in ((0,) if big else range(3)):
            st, e, s, er, sr = _lane_setup(torch, shape, axis,
                                           sum(shape) + 3, dev)
            groups = st.lanes.tolist()
            one = [line_gs.lane_state(st, grp) for grp in groups]
            for grp in range(2):
                if not torch.equal(_factor_twice(torch, one[grp]),
                                   st.factors[grp]):
                    raise AssertionError(f"line_factor {shape}: group {grp}"
                                         f"'s stack differs from K5's")
            plain = (0, 1) if big else range(LANES)
            rp = tuple(torch.stack(t) for t in zip(*(
                stencil.residual_parts(*(t[b] for t in sr),
                                       *(t[b] for t in er), *one[b].arrays)
                for b in range(LANES))))
            for color in range(4):
                rk = line_gs.residual(er, sr, st, color, _nan_like(er))
                ek = line_gs.thomas(_clone(er), rp, st.factors, st, color)
                torch.cuda.synchronize()
                for b in range(LANES):
                    eb = tuple(t[b] for t in er)
                    sb = tuple(t[b] for t in sr)
                    r1 = line_gs.residual(eb, sb, one[b], color,
                                          _nan_like(eb))
                    e1 = line_gs.thomas(_clone(eb), tuple(t[b] for t in rp),
                                        one[b].factors, one[b], color)
                    torch.cuda.synchronize()
                    if not all(_nan_equal(x[b], y) for x, y in zip(rk, r1)):
                        raise AssertionError(
                            f"line_residual {shape} axis {axis} colour "
                            f"{color} lane {b}: the {LANES}-lane launch "
                            f"differs from the one-lane launch")
                    if not all(torch.equal(x[b], y) for x, y in zip(ek, e1)):
                        raise AssertionError(
                            f"line_thomas {shape} axis {axis} colour {color}"
                            f" lane {b}: the {LANES}-lane launch differs "
                            f"from the one-lane launch")
                    if b not in plain:
                        continue
                    ref = line_gs.residual_plain(eb, sb, one[b], color,
                                                 _nan_like(eb))
                    fin = [~p.isnan() for p in ref]
                    errs['line_residual'].append(
                        (max(float((x[b][m] - p[m]).abs().max())
                             if m.any() else 0.0
                             for x, p, m in zip(rk, ref, fin)),
                         max(float(p[m].abs().max()) if m.any() else 0.0
                             for p, m in zip(ref, fin))))
                    ep = smoothers.line_thomas_x(
                        eb, tuple(t[b] for t in rp), one[b].factors, color)
                    errs['line_thomas'].append(
                        (_maxdiff(tuple(t[b] for t in ek), ep), _maxabs(ep)))
            if not big:
                # The wrapper's sweep (rotation, NaN buffer, 4 colours)
                # over all lanes against the plain version lane by lane.
                ek = _clone(e)
                line_gs.line_relaxation(ek, s, st, 1)
                ep = _clone(e)
                line_gs.line_relaxation_plain(ep, s, st, 1)
                torch.cuda.synchronize()
                if not all(bool(torch.isfinite(t).all()) for t in ek):
                    raise AssertionError(f"lane sweep {shape} axis {axis}: "
                                         f"non-finite field")
                errs['line_thomas'].append((_maxdiff(ek, ep), _maxabs(ep)))
            else:
                out = _time_lanes(torch, st, one, er, sr, rp)
            del st, one, e, s, er, sr, rp
        for k, v in errs.items():
            results[k]['max_abs_err'] = max(
                results[k]['max_abs_err'],
                _check_kernel(f"{k} {LANES} lanes", shape, v))
            errs[k] = []
    return out


def _time_lanes(torch, st, one, er, sr, rp):
    """ms of K3 (per colour) and K4 (colour 0) at 64³: one launch of all
    LANES lanes beside LANES one-lane launches."""
    from emg3d_tpu_torch.ops import line_gs
    rk = _nan_like(er)
    eb = [tuple(t[b] for t in er) for b in range(LANES)]
    sb = [tuple(t[b] for t in sr) for b in range(LANES)]
    rb = [tuple(t[b] for t in rk) for b in range(LANES)]
    k3 = _time_steps(torch, lambda: [line_gs.residual(er, sr, st, c, rk)
                                     for c in range(4)], reps=20, per=4)
    k3_1 = _time_steps(torch, lambda: [line_gs.residual(
        eb[b], sb[b], one[b], c, rb[b]) for c in range(4)
        for b in range(LANES)], reps=20, per=4)
    ek = _clone(er)
    ekb = [tuple(t[b] for t in ek) for b in range(LANES)]
    rpb = [tuple(t[b] for t in rp) for b in range(LANES)]
    k4 = _time_steps(torch, lambda: line_gs.thomas(ek, rp, st.factors, st,
                                                   0), reps=20, per=1)
    k4_1 = _time_steps(torch, lambda: [line_gs.thomas(
        ekb[b], rpb[b], one[b].factors, one[b], 0) for b in range(LANES)],
        reps=20, per=1)
    g3 = line_gs.residual_geometry(st.shape, 0, lanes=LANES)
    g4 = line_gs.launch_geometry(st.shape, 0, lanes=LANES)
    log(f"64³ x-lines, {LANES} lanes in one launch against {LANES} one-lane "
        f"launches (device ms): line_residual {k3:.4f} / {k3_1:.4f} per "
        f"colour ({g3.blocks}×{g3.lanes} blocks, {g3.xplanes} stations, "
        f"{'staged' if g3.staged else 'direct'}), line_thomas {k4:.4f} / "
        f"{k4_1:.4f} (colour 0, {g4.blocks}×{g4.lanes} blocks of "
        f"{g4.lines_per_block} lines, z "
        f"{'shared' if g4.z_shared else 'global'})")
    return {'line_residual': (k3, k3_1), 'line_thomas': (k4, k4_1)}


def _sim(torch, grid, model, survey, **opts):
    from emg3d_tpu_torch import Simulation
    return Simulation('phase10', survey, grid, model, gridding='same',
                      solver_opts={'device': 'cuda', 'verb': 1, **opts},
                      verb=0)


def _compute(torch, sim):
    """sim.compute() from scratch (host wall, ending in a synchronize)."""
    sim.clean('computed')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.compute()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_simulation(torch, results, out_dir):
    """Phase 10 (see the module docstring).  Returns the launches of the
    warm batched solve, the Simulation and its gradient."""
    from emg3d_tpu_torch import Model, solve
    from emg3d_tpu_torch.ops import line_gs, point_gs
    t0 = time.perf_counter()
    lane_ms = phase_lane_kernels(torch, results)
    log(f"lane kernels checked and timed in {time.perf_counter() - t0:.2f} s")
    grid, model, survey = simulation_problem()
    pairs = [(src, f) for src in survey.sources for f in SIM_FREQS]
    # Observed data: the same survey over a 2 Ω·m fullspace.
    np.random.seed(10)
    _sim(torch, grid, Model(grid, property_x=2.0, mapping='Resistivity'),
         survey).compute(observed=True)
    sim = _sim(torch, grid, model, survey)
    cold = _compute(torch, sim)
    point_gs.reset_launches()
    line_gs.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    warm = _compute(torch, sim)
    launches = {**point_gs.LAUNCHES, **line_gs.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2**30
    info = sim.get_efield_info(*pairs[0])
    rel = [sim.get_efield_info(*p)['rel_error'] for p in pairs]
    log(f"Simulation 64³, {len(pairs)} lanes, sc+lr BiCGSTAB: "
        f"{info['exit_message']}, it_mg {info['it_mg']}, it_ssl "
        f"{info['it_ssl']}, rel_error per lane "
        f"{', '.join(f'{r:.3e}' for r in rel)}; compute() cold "
        f"{cold:.3f} s, warm {warm:.3f} s; launches {launches}; peak device "
        f"memory {peak:.2f} GiB")
    if info['exit_message'] != 'CONVERGED' or not max(rel) < SIM_TOL:
        raise AssertionError("the batched Simulation solve did not converge")
    for k in ('factored', 'line_residual', 'line_thomas', 'line_factor'):
        if launches[k] == 0:
            raise AssertionError(f"the Simulation path launched no {k}")

    # Device time per kernel of the batched solve (warm, profiled).
    prof_wall, busy, nev, ms = _profile(
        torch, lambda: _compute(torch, sim),
        out_dir / 'simulation_trace.json')
    log(f"batched solve, profiled wall {prof_wall:.3f} s, device busy "
        f"{busy:.4f} s over {nev} events (idle share "
        f"{1 - busy / prof_wall:.4f}); device ms per kernel (launches): "
        + _kernel_ms(ms))

    # The same pairs as 8 sequential solves.
    opts = {k: v for k, v in sim.solver_opts.items()}
    point_gs.reset_launches()
    line_gs.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    singles, sinfo = [], []
    for src, f in pairs:
        e1, i1 = solve(grid, model, sim.get_sfield(src, f), **opts)
        singles.append(e1)
        sinfo.append(i1)
    torch.cuda.synchronize()
    seq = time.perf_counter() - t0
    single = {**point_gs.LAUNCHES, **line_gs.LAUNCHES}
    it_single = sum(i['it_mg'] for i in sinfo)
    worst = max(_rel(sim.get_efield(*p), e1) for p, e1 in zip(pairs, singles))
    log(f"{len(pairs)} sequential solves of the same pairs: {seq:.3f} s "
        f"(batched compute() warm {warm:.3f} s), it_mg "
        f"{[i['it_mg'] for i in sinfo]}, launches {single}; per MG cycle "
        f"line_residual {launches['line_residual'] / info['it_mg']:.1f} "
        f"batched, {single['line_residual'] / it_single:.1f} single; each "
        f"lane's field against its own solve: max |Δ|/|e| {worst:.3e}")
    if not all(i['exit_message'] == 'CONVERGED' for i in sinfo):
        raise AssertionError("a sequential solve did not converge")
    if not worst <= 10 * SIM_TOL:
        raise AssertionError(f"batched lanes differ from their own solves by "
                             f"{worst:.3e}")
    for k in ('line_residual', 'line_thomas'):
        b, o = launches[k] / info['it_mg'], single[k] / it_single
        if not abs(b - o) <= 0.1 * o:
            raise AssertionError(f"{k}: {b:.1f} launches per batched cycle, "
                                 f"{o:.1f} per single-solve cycle")

    misfit = sim.misfit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grad = sim.gradient
    torch.cuda.synchronize()
    gwall = time.perf_counter() - t0
    log(f"misfit {misfit:.6e}; gradient {gwall:.3f} s (adjoint batched "
        f"solve), finite {bool(np.isfinite(grad).all())}, norm "
        f"{float(np.linalg.norm(grad)):.6e}")
    if not (np.isfinite(misfit) and misfit > 0 and np.isfinite(grad).all()
            and np.any(grad)):
        raise AssertionError("misfit or gradient not finite")

    # 16³: the kernels against the plain path on the card.
    g16, m16, s16 = simulation_problem(16)
    resp, walls = [], []
    for plain in (False, True):
        with _plain(plain):
            sm = _sim(torch, g16, m16, s16)
            walls.append(_compute(torch, sm))
        resp.append(np.array(sm.data.synthetic))
    fin = np.isfinite(resp[1])
    diff = float(np.max(np.abs(resp[0][fin] - resp[1][fin])) /
                 np.max(np.abs(resp[1][fin])))
    log(f"Simulation 16³ kernels vs plain ({walls[0]:.2f} / "
        f"{walls[1]:.2f} s): {int(fin.sum())} finite responses, max "
        f"|Δ|/max|ref| {diff:.3e}")
    if not (np.array_equal(np.isfinite(resp[0]), fin) and fin.any()
            and diff <= TOL_SOLVE):
        raise AssertionError("16³ Simulation: kernels and plain differ")
    for k, (a, b) in lane_ms.items():
        results[k]['lanes_ms'] = a
        results[k]['lanes_one_by_one_ms'] = b
    return launches, sim, grad


def tdem_problem(n=64):
    """Phase 11's inputs: bench64's fullspace centred on the origin (as
    :func:`simulation_problem`), one x-directed electric point dipole at
    the origin, phase 10's 16 x-directed receivers 2-3 km along x, and
    the frequencies of ``Fourier(time=TDEM_TIME, fmin=0.01, fmax=10,
    signal=-1, ft='dlf', every_x_freq=2)``: 19, 0.011-8.35 Hz.  Returns
    (grid, model, survey, fourier)."""
    from emg3d_tpu_torch import Fourier, Survey
    fourier = Fourier(time=TDEM_TIME, fmin=0.01, fmax=10, signal=-1,
                      ft='dlf', every_x_freq=2)
    grid, model, _ = simulation_problem(n)
    survey = Survey('tdem', (0., 0., 0., 0., 0.),
                    (np.linspace(2000., 3000., 16), 0., 0., 0., 0.),
                    fourier.freq_compute, noise_floor=1e-15,
                    relative_error=0.05)
    return grid, model, survey, fourier


def time_responses(fourier, data):
    """``fourier.freq2time`` of every receiver's spectrum ((nrec, nfreq)
    data) that is finite; rows of NaN for the others."""
    out = np.full((data.shape[0], fourier.time.size), np.nan)
    for r, d in enumerate(data):
        if np.isfinite(d).all():
            out[r] = fourier.freq2time(d)
    return out


def _tdem_sim(grid, model, survey, **opts):
    from emg3d_tpu_torch import Simulation
    return Simulation('tdem', survey, grid, model, gridding='same',
                      solver_opts={'device': 'cuda', 'verb': 1, **opts},
                      verb=0)


def phase_tdem(torch, out_dir):
    """Phase 11 (see the module docstring).  Returns the launches of the
    warm 19-lane solve."""
    from emg3d_tpu_torch import solve
    from emg3d_tpu_torch.ops import line_gs, point_gs
    grid, model, survey, fourier = tdem_problem()
    freqs = [float(f) for f in fourier.freq_compute]
    src = next(iter(survey.sources))
    sim = _tdem_sim(grid, model, survey)
    with line_state_clock() as cclock:
        cold = _compute(torch, sim)
    point_gs.reset_launches()
    line_gs.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with line_state_clock() as clock:
        warm = _compute(torch, sim)
    launches = {**point_gs.LAUNCHES, **line_gs.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2**30
    infos = [sim.get_efield_info(src, f) for f in freqs]
    rel = [i['rel_error'] for i in infos]
    log(f"tdem64: {len(freqs)} frequencies {freqs[0]:.4f}-{freqs[-1]:.4f} Hz"
        f" as one {len(freqs)}-lane sc+lr BiCGSTAB solve: exit "
        f"{sorted({i['exit_message'] for i in infos})}, it_mg "
        f"{infos[0]['it_mg']}, it_ssl {infos[0]['it_ssl']}; rel_error per "
        f"lane (Hz: rel) " + ", ".join(f"{f:.4f}: {r:.3e}"
                                       for f, r in zip(freqs, rel)))
    log(f"tdem64 compute(): cold {cold:.3f} s ({cclock.seconds:.4f} s in "
        f"{cclock.calls} line-state builds), warm {warm:.3f} s "
        f"({clock.seconds:.4f} s in {clock.calls} line-state builds); "
        f"launches {launches}; peak device memory {peak:.2f} GiB")
    if any(i['exit_message'] != 'CONVERGED' for i in infos) or \
            not max(rel) < SIM_TOL:
        raise AssertionError("the time-domain batched solve did not "
                             "converge on every lane")
    for k in ('factored', 'line_residual', 'line_thomas', 'line_factor'):
        if launches[k] == 0:
            raise AssertionError(f"the time-domain path launched no {k}")
    # Each line state of the solve holds one stack per frequency group;
    # a stack outside the cache budget is rebuilt (K5 again) at every
    # smoothing call.
    per_state = launches['line_factor'] / max(clock.calls, 1)
    log(f"tdem64 factor stacks: {launches['line_factor']} K5 launches over "
        f"{clock.calls} line states of {len(freqs)} groups ("
        f"{per_state:.2f} per state; {len(freqs)} = every stack cached, "
        f"more = stacks rebuilt at each smoothing call); cache budget "
        f"{line_gs.cache_budget('cuda') / 2**30:.2f} GiB")
    log(f"tdem64 K1 (point_gs_factored, coarse levels, once per lane): "
        f"{launches['factored']} launches, "
        f"{launches['factored'] / len(freqs):.1f} per lane")

    wall, busy, nev, ms = _profile(torch, lambda: _compute(torch, sim),
                                   out_dir / 'tdem_trace.json')
    log(f"tdem64 profiled compute() {wall:.3f} s, device busy {busy:.4f} s "
        f"over {nev} events (idle share {1 - busy / wall:.4f}); device ms "
        f"per kernel (launches): {_kernel_ms(ms)}")

    # Three lanes against their own single solves.
    opts = dict(sim.solver_opts)
    for f in (freqs[0], freqs[len(freqs) // 2], freqs[-1]):
        e1, i1 = solve(grid, model, sim.get_sfield(src, f), **opts)
        d = _rel(sim.get_efield(src, f), e1)
        log(f"tdem64 lane {f:.4f} Hz against its own solve "
            f"({i1['exit_message']}, it_mg {i1['it_mg']}, it_ssl "
            f"{i1['it_ssl']}): |Δ|/|e| {d:.3e}")
        if i1['exit_message'] != 'CONVERGED' or not d <= 10 * SIM_TOL:
            raise AssertionError(f"tdem64 lane {f} Hz differs from its own "
                                 f"solve by {d:.3e}")

    data = np.array(sim.data.synthetic)[0]
    resp = time_responses(fourier, data)
    log(f"tdem64 time domain (switch-off, {fourier.time.size} times "
        f"{fourier.time[0]}-{fourier.time[-1]} s): "
        f"{int(np.isfinite(resp).all(1).sum())} of {len(resp)} receivers "
        f"finite; receiver 0 at every 5th time: "
        + ", ".join(f"{v:.4e}" for v in resp[0][::5]))
    if not (np.isfinite(data).all() and np.isfinite(resp).all()):
        raise AssertionError("tdem64: non-finite responses")

    # 16³: kernels against the plain path, frequency and time responses.
    g16, m16, s16, f16 = tdem_problem(16)
    out, walls = [], []
    for plain in (False, True):
        with _plain(plain):
            sm = _tdem_sim(g16, m16, s16)
            walls.append(_compute(torch, sm))
        d = np.array(sm.data.synthetic)[0]
        out.append((d, time_responses(f16, d)))
    (dk, tk), (dp, tp) = out
    fin, tfin = np.isfinite(dp), np.isfinite(tp)
    dd = float(np.max(np.abs(dk[fin] - dp[fin])) / np.max(np.abs(dp[fin])))
    td = float(np.max(np.abs(tk[tfin] - tp[tfin])) / np.max(np.abs(tp[tfin])))
    log(f"tdem 16³ kernels vs plain ({walls[0]:.2f} / {walls[1]:.2f}"
        f" s): {int(fin.all(1).sum())} receivers finite, frequency "
        f"responses max |Δ|/max|ref| {dd:.3e}, time responses {td:.3e}")
    if not (np.array_equal(np.isfinite(dk), fin) and fin.any()
            and np.array_equal(np.isfinite(tk), tfin) and tfin.any()
            and dd <= TOL_SOLVE and td <= TOL_SOLVE):
        raise AssertionError("tdem 16³: kernels and plain differ")
    return launches


def diff_problem(torch, n, device='cuda'):
    """Phase 12's inputs, tests/test_diff.py:16-53 at n³ cells of 100 m
    centred on the origin (its own 16³ at n = 16, bench64's grid at 64):
    the 1 Hz x-source at the origin as tensors, unit samplers of three
    interior x-edges and the σ = 3 block, both scaled by n/16.  Returns
    (grid, s, weights, sigma_true) on ``device``."""
    from emg3d_tpu_torch import TensorMesh, get_source_field
    k = n // 16
    dev = torch.device(device)
    grid = TensorMesh([np.full(n, 100.)] * 3, origin=(-50. * n,) * 3)
    sf = get_source_field(grid, (0, 0, 0, 0, 0), 1.0, strength=0)
    s = tuple(torch.tensor(np.asarray(f), device=dev)
              for f in (sf.fx, sf.fy, sf.fz))
    w = []
    for idx in DIFF_EDGES:
        wx = torch.zeros((n, n + 1, n + 1), dtype=torch.float64, device=dev)
        wx[tuple(k * i for i in idx)] = 1.0
        w.append((0, wx))
    sig = np.ones((n,) * 3)
    sig[6 * k:10 * k, 6 * k:10 * k, 6 * k:10 * k] = 3.0
    return grid, s, w, torch.tensor(sig, device=dev)


def diff_misfit(torch, grid, s, w, tol=1e-10, **opts):
    """(fsolve, data(σ), misfit(log σ, d_obs)) through the port's
    differentiable solve at 1 Hz."""
    from emg3d_tpu_torch import diff
    fsolve = diff.make_differentiable_solve(grid, 1.0, tol=tol, **opts)

    def data(sigma):
        eta, zeta = diff.eta_zeta_from_sigma(grid, sigma, 1.0)
        return diff.sample_edges(fsolve((eta, eta, eta, zeta), s), w)

    def misfit(log_sigma, d_obs):
        return 0.5 * torch.sum((data(torch.exp(log_sigma)) - d_obs).abs()
                               ** 2)
    return fsolve, data, misfit


def _diff_grad(torch, misfit, like, d_obs):
    """∂misfit/∂log σ at σ = 1, the misfit, the forward and backward
    walls and the :class:`Clock` of ``solver.solve`` over both (its
    records each solve's exit message, it_mg and it_ssl)."""
    from emg3d_tpu_torch import solver
    x = torch.zeros_like(like).requires_grad_(True)
    with Clock(solver, 'solve', record=lambda out: tuple(
            out[1][k] for k in ('exit_message', 'it_mg', 'it_ssl'))) \
            as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        L = misfit(x, d_obs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        L.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return x.grad, float(L.detach()), t1 - t0, t2 - t1, clock


def phase_diff(torch, out_dir):
    """Phase 12 (see the module docstring).  Returns the launches of the
    two 64³ gradients and the point one (phase 18's reference, on the
    host)."""
    from emg3d_tpu_torch.ops import line_gs, point_gs
    configs = (('point', {}), ('sc+lr', SCLR))
    launches = {}
    for name, opts in configs:
        grid, s, w, sig = diff_problem(torch, 64)
        _, data, misfit = diff_misfit(torch, grid, s, w, **opts)
        d_obs = data(sig).detach()
        point_gs.reset_launches()
        line_gs.reset_launches()
        g, L, fwd, bwd, clock = _diff_grad(torch, misfit, sig, d_obs)
        launches[name] = {**point_gs.LAUNCHES, **line_gs.LAUNCHES}
        if name == 'point':
            g_point = g.detach().cpu()
        wall, busy, nev, ms = _profile(
            torch, lambda: _diff_grad(torch, misfit, sig, d_obs),
            out_dir / f"diff_{name.replace('+', '')}_trace.json")
        log(f"diff64 {name}: misfit {L:.6e}, gradient norm "
            f"{float(g.norm()):.6e}; forward {fwd:.3f} s, backward "
            f"{bwd:.3f} s, of which {clock.seconds:.3f} s in {clock.calls} "
            f"solver.solve calls and {fwd + bwd - clock.seconds:.3f} s "
            f"outside them (tensor ↔ host field copies, the residual's "
            f"autograd pullback); launches {launches[name]}; profiled "
            f"forward+backward {wall:.3f} s, device busy {busy:.4f} s (idle "
            f"share {1 - busy / wall:.4f}), device ms per kernel (launches):"
            f" {_kernel_ms(ms)}")
        if not (bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)):
            raise AssertionError(f"diff64 {name}: gradient not finite")
        keys = ('line_residual', 'line_thomas', 'line_factor') \
            if opts else ('factored', 'fused')
        if any(launches[name][k] == 0 for k in keys):
            raise AssertionError(f"diff64 {name}: the gradient launched "
                                 f"none of {keys}")
        del g, s, w, sig, d_obs
    # 16³ at tol 1e-10: kernels against plain (gradients and each solve's
    # exit message and cycle counts), central differences, the source's
    # gradient.
    grid, s, w, sig = diff_problem(torch, 16)
    for name, opts in configs:
        fsolve, data, misfit = diff_misfit(torch, grid, s, w, **opts)
        d_obs = data(sig).detach()
        t0 = time.perf_counter()
        gk, _, _, _, ck = _diff_grad(torch, misfit, sig, d_obs)
        t1 = time.perf_counter()
        with _plain():
            gp, _, _, _, cp = _diff_grad(
                torch, diff_misfit(torch, grid, s, w, **opts)[2], sig, d_obs)
        t2 = time.perf_counter()
        rel = float((gk - gp).abs().max() / gp.abs().max())
        log(f"diff 16³ {name}: kernels vs plain gradients (tol "
            f"1e-10; {t1 - t0:.2f} / {t2 - t1:.2f} s) max |Δ|/max|ref| "
            f"{rel:.3e}; (exit, it_mg, it_ssl) per solve {ck.records} / "
            f"{cp.records}")
        if not rel <= TOL_SOLVE or ck.records != cp.records:
            raise AssertionError(f"diff 16³ {name}: kernels and plain differ")
        if name != 'point':
            continue
        h = 1e-5
        for cell in DIFF_FD_CELLS:
            up = torch.zeros_like(sig)
            up[cell] = h
            with torch.no_grad():
                fd = (float(misfit(up, d_obs)) - float(misfit(-up, d_obs))) \
                    / (2 * h)
            r = abs(float(gk[cell]) - fd) / max(abs(fd), 1e-30)
            log(f"diff 16³ cell {cell}: autograd {float(gk[cell]):.6e}, "
                f"central difference {fd:.6e}, rel {r:.3e}")
            if not r < 0.01:
                raise AssertionError(f"diff 16³ cell {cell}: FD {fd} vs "
                                     f"autograd {float(gk[cell])}")
        # The source's gradient is the adjoint field λ = conj(A⁻¹ conj(w)),
        # w = ∂misfit/∂e.
        from emg3d_tpu_torch import diff
        eta, zeta = diff.eta_zeta_from_sigma(grid, torch.ones_like(sig), 1.0)
        src = tuple(t.clone().requires_grad_(True) for t in s)
        e = fsolve((eta, eta, eta, zeta), src)
        L = 0.5 * torch.sum((diff.sample_edges(e, w) - d_obs).abs() ** 2)
        we = [torch.zeros_like(c) if g is None else g for c, g in zip(
            e, torch.autograd.grad(L, e, retain_graph=True,
                                   allow_unused=True))]
        gs = torch.autograd.grad(L, src)
        with torch.no_grad():
            lam = tuple(c.conj() for c in fsolve(
                (eta, eta, eta, zeta), tuple(c.conj() for c in we)))
        d = max(float((a - b).abs().max()) for a, b in zip(gs, lam)) / \
            max(float(b.abs().max()) for b in lam)
        fin = all(bool(torch.isfinite(t).all()) for t in gs)
        log(f"diff 16³ source gradient: finite {fin}, against the adjoint "
            f"field λ max |Δ|/max|λ| {d:.3e}")
        if not (fin and d <= TOL_SOLVE):
            raise AssertionError("diff 16³: the source's gradient is not λ")
    return launches, g_point


CLI_CONFIG = """[files]
path = {path}
survey = {survey}
model = {model}
output = {output}

[simulation]
gridding = same
"""


def phase_cli(torch, sim, grad, out_dir):
    """Phase 13 (see the module docstring): phase 10's survey, model and
    results through the port's io and CLI on the card."""
    from emg3d_tpu_torch import Simulation, io
    from emg3d_tpu_torch.cli import main as cli
    d = out_dir / 'cli'
    d.mkdir(parents=True, exist_ok=True)
    synthetic = np.array(sim.data.synthetic)
    observed = np.array(sim.data.observed)
    misfit = sim.misfit
    t0 = time.perf_counter()
    for ext in ('npz', 'json'):
        io.save(str(d / f'survey.{ext}'), survey=sim.survey)
        io.save(str(d / f'model.{ext}'), model=sim.model, mesh=sim.grid)
    log(f"cli64 inputs written (npz and json) in "
        f"{time.perf_counter() - t0:.2f} s")
    for ext in ('npz', 'json'):
        back = np.array(io.load(str(d / f'survey.{ext}'))['survey']
                        .data.observed)
        if not np.array_equal(back, observed, equal_nan=True):
            raise AssertionError(f"cli64: survey.{ext} does not load back")
    fname = str(d / 'simulation.npz')
    sim.to_file(fname, what='results')
    back = Simulation.from_file(fname)
    if not (np.array_equal(np.array(back.data.synthetic), synthetic,
                           equal_nan=True)
            and np.array_equal(np.array(back.data.observed), observed,
                               equal_nan=True)
            and np.array_equal(back.gradient, grad)):
        raise AssertionError("cli64: Simulation.to_file/from_file round "
                             "trip changed the data")
    log("cli64 Simulation.to_file/from_file (npz, what='results'): data and "
        "gradient equal")
    runs = {}
    for flag, ext in (('-f', 'npz'), ('-g', 'json')):
        cfg = d / f'run{flag[1]}.cfg'
        cfg.write_text(CLI_CONFIG.format(path=d, survey=f'survey.{ext}',
                                         model=f'model.{ext}',
                                         output=f'out{flag[1]}.npz'))
        np.random.seed(11)              # the forward task adds noise
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main([str(cfg), flag, '-q'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[flag] = io.load(str(d / f'out{flag[1]}.npz'))
        log(f"cli64 main([{cfg.name}, '{flag}', '-q']) from {ext} inputs: "
            f"{wall:.3f} s; output keys {sorted(runs[flag])}")
    # -f against phase 10's compute(observed=True) with the same noise
    # seed (the files above hold phase 10's own observed data).
    np.random.seed(11)
    sim.compute(observed=True)
    checks = (('-f data', runs['-f']['data'], np.array(sim.data.observed)),
              ('-g data', runs['-g']['data'], synthetic),
              ('-g gradient', runs['-g']['gradient'], grad))
    for what, got, ref in checks:
        got = np.asarray(got)
        fin = np.isfinite(ref)
        rel = float(np.max(np.abs(got[fin] - ref[fin])) /
                    np.max(np.abs(ref[fin])))
        log(f"cli64 {what}: shape {got.shape}, against phase 10 max "
            f"|Δ|/max|ref| {rel:.3e}")
        if got.shape != ref.shape or not rel <= TOL_SOLVE or \
                not np.array_equal(np.isfinite(got), fin):
            raise AssertionError(f"cli64 {what} differs from phase 10")
    if np.asarray(runs['-g']['gradient']).shape != \
            tuple(sim.grid.shape_cells):
        raise AssertionError("cli64: gradient shape")
    rm = abs(float(runs['-g']['misfit']) - misfit) / misfit
    log(f"cli64 misfit {float(runs['-g']['misfit']):.6e} (phase 10 "
        f"{misfit:.6e}, rel {rm:.3e})")
    if not rm <= TOL_SOLVE:
        raise AssertionError("cli64 misfit differs from phase 10")


def probe_boxes():
    """The sub-boxes of the tile_copy probe: {case: (array shape, [(offsets,
    lengths), ...])}, the grid steps of the Pallas probes in
    scripts/hw_probe_ztile.py (``probe`` at three z alignments and one
    odd offset step, ``probe3``, ``probe23``, ``probe12``), applied in
    order to one array each."""
    cases = {}
    for align in (128, 8, 120, 13):
        cases[f'probe z {align}'] = ((6, 20, 32, 384), [
            ((0, 0, 0, t * align), (6, 20, 32, 128))
            for t in range((384 - 128) // align + 1)])
    # probe3: dims 0 (chunks of 4), 2 (y-slabs of 16 at 8) and 3 together.
    cases['probe3'] = ((32, 46, 64, 384), [
        (((t * 2 + z) % 8 * 4, 0, t * 8, z * 128), (4, 46, 16, 256))
        for t in range(7) for z in range(2)])
    # probe23: dims 2 and 3, z tiles of 256 and 128 at 128.
    cases['probe23'] = ((6, 34, 64, 384), [
        ((0, 0, t * 8, z * 128), (6, 34, 16, tz))
        for tz in (256, 128) for t in range(7)
        for z in range((384 - tz) // 128 + 1)])
    # probe12: dims 1 (clipped, unaligned) and 2 (y tiles of 64 at 56).
    cases['probe12'] = ((6, 34, 264, 384), [
        ((0, min(max(t * 4 - 1, 0), 28), y * 56, 0), (6, 6, 64, 384))
        for t in range(8) for y in range(4)])
    return cases


def _turns(torch, kernel, library, reps=20):
    """A kernel and its library call timed in turns (kernel, library,
    library, kernel; the kernel twice where ``library`` is None), each a
    :func:`_time_steps` median of one call: (kernel ms, library ms or
    None, the turns), each ms the mean of its two."""
    order = ('kernel', 'library', 'library', 'kernel') if library else \
        ('kernel', 'kernel')
    turns = [(k, _time_steps(torch, kernel if k == 'kernel' else library,
                             reps=reps, per=1)) for k in order]
    lib = [t for k, t in turns if k == 'library']
    return (float(np.mean([t for k, t in turns if k == 'kernel'])),
            float(np.mean(lib)) if lib else None,
            [[k, t] for k, t in turns])


def launch_floor(torch):
    """Device ms of a one-element ``x.add_(1.0)`` under
    :func:`_time_steps`: what any launch reads there."""
    x = torch.zeros(1, device='cuda')
    return _time_steps(torch, lambda: x.add_(1.0), per=1)


def probe_turns(torch, probes, large=PROBES_TIMED):
    """The probes of PROBES_TIMED in ``probes`` (an ``ops/probes.py``)
    timed in turns with their library calls at the probes' shapes
    (tile_roll (8, 256) along axis 1, shift 1; tile_copy probe12's
    6×6×64×384 box; smem_sum SUM_PROBE; station_solve STATION_PROBE,
    which has no library call; smem_limit at the card's opt-in on x of
    :func:`smem_rows`, against ``x[0].add_(1.0)``) and, for the kernels
    named in ``large``, where bytes decide (ROLL_LARGE; the whole of
    COPY_LARGE's array; SUM_LARGE; STATION_LARGE; smem_limit has no
    such shape: it moves 16 KB whatever its size), each with its bound,
    its share and the launch floor (:func:`launch_floor`, read once
    first).  An ``ops/probes.py`` from before smem_limit computed
    probe_vmem's function (no ``smem_limit_plain``) has its
    ``smem_limit(optin)`` timed alone, with its own bound (2·N bytes of
    shared memory).  Returns {kernel: {suffix: readings}}, suffix '' or
    '_large'."""
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(15)
    floor = launch_floor(torch)
    out = {k: {} for k in PROBES_TIMED}

    def record(key, sfx, shape, kernel, library, work, peak=PEAK_FP64,
               **extra):
        ms, lib, turns = _turns(torch, kernel, library)
        b = work if isinstance(work, dict) else bound(*work, peak)
        out[key][sfx] = {'shape': list(shape), **extra, 'ms': ms,
                         'library_ms': lib, 'turns': turns, **b,
                         'share': b['bound_ms'] / ms,
                         'launch_floor_ms': floor}

    def cases(key, probe, big):
        return (('', probe),) + ((('_large', big),) if key in large else ())

    for sfx, shape in cases('tile_roll', (8, 256), ROLL_LARGE):
        x = torch.randn(shape, device=dev, generator=g)
        record('tile_roll', sfx, shape, lambda: probes.tile_roll(x, 1, 1),
               lambda: torch.roll(x, 1, 1), (2 * 4 * x.numel(), 0))
        del x
    shape12, boxes12 = probe_boxes()['probe12']
    for sfx, (shape, off, ln) in cases(
            'tile_copy', (shape12, *boxes12[5]),
            (COPY_LARGE[0], *COPY_LARGE[1][0])):
        x = torch.zeros(shape, device=dev)
        box = tuple(slice(o, o + k) for o, k in zip(off, ln))
        record('tile_copy', sfx, shape, lambda: probes.tile_copy(x, off, ln),
               lambda: x[box].add_(1.0), (2 * 4 * int(np.prod(ln)), 0),
               box=list(ln))
        del x
    for sfx, (shape, chx, plane) in cases('smem_sum', SUM_PROBE, SUM_LARGE):
        f = torch.randn(shape, device=dev, generator=g)
        record('smem_sum', sfx, shape,
               lambda: probes.smem_sum(f, chx, plane),
               lambda: f[:chx, plane].sum(0), sum_work(shape, chx),
               chx=chx, plane=plane)
        del f
    for sfx, tile in cases('station_solve', STATION_PROBE, STATION_LARGE):
        x = station_inputs(torch, tile, dev, g)
        record('station_solve', sfx, tile, lambda: probes.station_solve(x),
               None, station_work(tile), PEAK_FP32)
        del x
    optin = probes.smem_optin()
    mhz = float(nvidia_smi('clocks.max.sm', units=False))
    if hasattr(probes, 'smem_limit_plain'):
        x = torch.randn(smem_rows(optin), device=dev, generator=g)
        if probes.smem_limit(x, optin)[0]:
            raise AssertionError(f"smem_limit: {optin} B refused")
        nbytes, smem = smem_work()
        record('smem_limit', '', x.shape,
               lambda: probes.smem_limit(x, optin),
               lambda: x[0].add_(1.0), smem_bound(smem, mhz, nbytes),
               nbytes=optin, plan=list(probes.smem_plan(optin)),
               sm_clock_mhz=mhz)
        del x
    else:
        record('smem_limit', '', (optin,), lambda: probes.smem_limit(optin),
               None, smem_bound(2 * optin, mhz), nbytes=optin,
               sm_clock_mhz=mhz, before='a different function (fill and '
               'sum of N bytes, plus a torch.zeros)')
    torch.cuda.empty_cache()
    return out


def probe_plans(torch, probes):
    """smem_sum under each plan of SUM_PLANS (box bytes × blocks per SM ×
    the ring's stages at most) at SUM_LARGE, each bitwise equal to the
    plain sum, and station_solve
    under each of STATION_PLANS (blocks per SM × points a thread) at
    STATION_PROBE and STATION_LARGE, each within 1e-6 of max|z| of the
    default plan's z, and smem_limit at the card's opt-in under each
    plan of SMEM_PLANS (bulk copies each way) in turns (first, second,
    second, first), each bitwise equal to the plain version: the tables
    behind ``probes.SUM_BYTES``, ``SUM_STAGES``, ``TILE_BLOCKS_PER_SM``,
    ``station_plan``'s grid and points a thread and ``SMEM_PIECES``.
    Returns {'smem_sum': {'bytes×per_sm×stages': ms}, 'station_solve':
    {'per_sm×vec': [ms at STATION_PROBE, at STATION_LARGE]},
    'smem_limit': {'pieces': ms, 'turns': [[pieces, ms], ...]}}."""
    dev = torch.device('cuda')
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(16)
    shape, chx, plane = SUM_LARGE
    f = torch.randn(shape, device=dev, generator=g)
    ref = probes.smem_sum_plain(f, chx, plane)
    sums = {}
    for nbytes, per_sm, stages in SUM_PLANS:
        plan = probes.sum_plan(chx, *shape[2:], sms, nbytes, per_sm, stages)
        if not torch.equal(probes.smem_sum(f, chx, plane, _plan=plan), ref):
            raise AssertionError(f"smem_sum plan {plan}: differs from plain")
        sums[f'{nbytes}×{per_sm}×{stages}'] = _time_steps(
            torch, lambda: probes.smem_sum(f, chx, plane, _plan=plan), per=1)
    del f, ref
    stations = {f'{p}×{v}': [] for p, v in STATION_PLANS}
    for tile in (STATION_PROBE, STATION_LARGE):
        x = station_inputs(torch, tile, dev, g)
        ref = probes.station_solve(x)
        scale = float(ref.abs().max())
        for per_sm, vec in STATION_PLANS:
            plan = probes.station_plan(x[0].numel(), sms, per_sm, vec)
            err = float((probes.station_solve(x, _plan=plan) - ref)
                        .abs().max())
            if not err <= 1e-6 * scale:
                raise AssertionError(f"station_solve plan {plan}: "
                                     f"{err:.3e}")
            stations[f'{per_sm}×{vec}'].append(_time_steps(
                torch, lambda: probes.station_solve(x, _plan=plan), per=1))
        del x, ref
    optin = probes.smem_optin()
    x = torch.randn(smem_rows(optin), device=dev, generator=g)
    runs = {}
    for pieces in SMEM_PLANS:
        plan = probes.smem_plan(optin, pieces)
        xk = x.clone()
        err = probes.smem_limit(xk, optin, _plan=plan)[0]
        if err or not torch.equal(xk, probes.smem_limit_plain(x.clone())):
            raise AssertionError(f"smem_limit plan {plan}: error {err} or "
                                 f"differs from plain")
        runs[pieces] = lambda xk=xk, plan=plan: probes.smem_limit(
            xk, optin, _plan=plan)
    first, second = SMEM_PLANS
    _, _, turns = _turns(torch, runs[first], runs[second])
    pieces = {str(p): float(np.mean([t for k, t in turns
                                     if (k == 'kernel') == (p == first)]))
              for p in SMEM_PLANS}
    pieces['turns'] = [[first if k == 'kernel' else second, t]
                       for k, t in turns]
    del x
    torch.cuda.empty_cache()
    return {'smem_sum': sums, 'station_solve': stations,
            'smem_limit': pieces}


def copy_plans(torch, probes):
    """tile_copy under each plan of COPY_PLANS whose blocks fit an SM
    (box bytes, blocks per SM) at probe12's box and the whole of
    COPY_LARGE's array, each bitwise equal to the plain copy: the table
    behind ``probes.TILE_BYTES`` and ``TILE_BLOCKS_PER_SM``.  Returns
    {'bytes×per_sm': [ms at probe12's box, ms at the whole array]}."""
    dev = torch.device('cuda')
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape12, boxes12 = probe_boxes()['probe12']
    cases = ((shape12, *boxes12[5]), (COPY_LARGE[0], *COPY_LARGE[1][0]))
    table = {}
    for nbytes, per_sm in COPY_PLANS:
        row = []
        for shape, off, ln in cases:
            plan = probes.tile_plan(shape[3], off, ln, sms, nbytes, per_sm)
            if per_sm * (plan.smem + 1024) > 228 * 1024:
                break
            x = torch.randn(shape, device=dev)
            ref = probes.tile_copy_plain(x.clone(), off, ln)
            probes.tile_copy(x, off, ln, _plan=plan)
            if not torch.equal(x, ref):
                raise AssertionError(f"tile_copy plan {plan}: differs "
                                     f"from plain")
            row.append(_time_steps(torch, lambda: probes.tile_copy(
                x, off, ln, _plan=plan), per=1))
            del x, ref
        if row:
            table[f'{nbytes}×{per_sm}'] = row
    torch.cuda.empty_cache()
    return table


def phase_probes(torch, launches):
    """Phase 14 (see the module docstring): every probe checked against its
    plain version (launches counted), then timed.  Returns the probes'
    entries of the result line; ``launches`` are the probes' counts over
    phases 4-13 (no path runs them)."""
    from emg3d_tpu_torch.ops import probes
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(14)
    probes.reset_launches()
    # tile_copy: every probe's boxes in order, then the large sub-boxes
    # one by one, against the plain copy.
    cases = list(probe_boxes().items()) + [
        (f'large {off} + {ln}', (COPY_LARGE[0], [(off, ln)]))
        for off, ln in COPY_LARGE[1]]
    for case, (shape, boxes) in cases:
        x = torch.randn(shape, device=dev, generator=g)
        ref = x.clone()
        for off, ln in boxes:
            probes.tile_copy(x, off, ln)
            probes.tile_copy_plain(ref, off, ln)
        torch.cuda.synchronize()
        if not torch.equal(x, ref):
            raise AssertionError(f"tile_copy {case}: differs from plain")
        plan = probes.tile_plan(shape[3], *boxes[0], torch.cuda.
                                get_device_properties(dev)
                                .multi_processor_count)
        log(f"tile_copy {case} {shape}: {len(boxes)} sub-boxes (first: "
            f"{plan}) bitwise equal to plain")
        del x, ref
    # smem_limit: the card's opt-in limit, and launches around it, each
    # on its own x of the probe's rows for that scratch, under each plan.
    optin = probes.smem_optin()
    table = []
    for nbytes in SMEM_SIZES + (optin, optin + 16):
        x0 = torch.randn(smem_rows(nbytes), device=dev, generator=g)
        ref = probes.smem_limit_plain(x0.clone())
        for pieces in SMEM_PLANS:
            x = x0.clone()
            err, attr, _ = probes.smem_limit(
                x, nbytes, _plan=probes.smem_plan(nbytes, pieces))
            torch.cuda.synchronize()
            ok = torch.equal(x, x0 if err else ref)
            table.append((nbytes, pieces, err, attr, ok))
            log(f"smem_limit {nbytes} B, {pieces} piece(s), x "
                f"{tuple(x.shape)}: cudaFuncSetAttribute error {attr}, "
                f"launch error {err}: " + (
                    ('refused, x unchanged' if ok else 'refused, X CHANGED')
                    if err else 'bitwise equal to plain' if ok else
                    'DIFFERS FROM PLAIN'))
    if optin != 232448:
        raise AssertionError(f"opt-in shared memory {optin}, not 232448")
    if not all(ok and (err == 0) == (nbytes <= optin) and
               (attr == 0) == (nbytes <= optin)
               for nbytes, _, err, attr, ok in table):
        raise AssertionError(f"smem_limit: {table}")
    # fbuf5d, rolllane/rollsub, dynslice(_al, _al12), station at ty=8,
    # Zp=256; smem_sum also at SUM_LARGE and SUM_ODD, tile_roll at
    # ROLL_LARGE and ROLL_ODD, station_solve at STATION_LARGE and
    # STATION_ODD.
    for shape, chx, plane in (SUM_LARGE, SUM_ODD, SUM_PROBE):
        f = torch.randn(shape, device=dev, generator=g)
        if not torch.equal(probes.smem_sum(f, chx, plane),
                           probes.smem_sum_plain(f, chx, plane)):
            raise AssertionError(f"smem_sum {shape} chx {chx}: differs "
                                 f"from plain")
        plan = probes.sum_plan(chx, *shape[2:], torch.cuda.
                               get_device_properties(dev)
                               .multi_processor_count)
        log(f"smem_sum {shape} chx {chx} plane {plane} ({plan}): bitwise "
            f"equal to plain")
    for shape in ((8, 256), ROLL_LARGE, ROLL_ODD):
        xr = torch.randn(shape, device=dev, generator=g)
        for axis in (0, 1):
            for shift in (1, 3, -5):
                if not torch.equal(probes.tile_roll(xr, shift, axis),
                                   torch.roll(xr, shift, axis)):
                    raise AssertionError(f"tile_roll {shape} axis {axis} "
                                         f"shift {shift}")
    xr = torch.randn((8, 256), device=dev, generator=g)
    for ny, ty, starts in ((72, 8, [min(t * 6, 64) for t in range(4)]),
                           (48, 16, [t * 8 for t in range(4)]),
                           (48, 12, [t * 8 for t in range(4)])):
        xs = torch.randn((6, 66, ny, 256), device=dev, generator=g)
        y0 = torch.tensor(starts, dtype=torch.int32, device=dev)
        if not torch.equal(probes.dyn_slice(xs, y0, ty),
                           probes.dyn_slice_plain(xs, y0, ty)):
            raise AssertionError(f"dyn_slice ty {ty}: differs from plain")
    log(f"tile_roll ((8, 256), {ROLL_LARGE}, {ROLL_ODD}; axes 0 and 1, "
        f"shifts 1, 3, -5), dyn_slice (ty 8, 16, 12) bitwise equal to "
        f"plain")
    for tile in (STATION_LARGE, STATION_ODD, STATION_PROBE):
        xst = station_inputs(torch, tile, dev, g)
        zp = probes.station_solve_plain(xst)
        st_err = float((probes.station_solve(xst) - zp).abs().max())
        st_rel = st_err / float(zp.abs().max())
        log(f"station_solve {tile} ({probes.station_plan(xst[0].numel())}"
            f"): max |Δ|/max|ref| {st_rel:.3e} against torch.linalg.solve "
            f"(complex128)")
        if not st_rel <= 1e-6:
            raise AssertionError(f"station_solve {tile}: {st_rel:.3e} > "
                                 f"1e-6")
        del zp
    plans = copy_plans(torch, probes)
    sum_station_plans = probe_plans(torch, probes)
    n = dict(probes.LAUNCHES)
    log("tile_copy by plan (box bytes × blocks per SM: ms at probe12's "
        "box, at the whole probe3 array): " + ", ".join(
            f"{k} {' / '.join(f'{t:.4f}' for t in v)}"
            for k, v in plans.items()))
    log(f"smem_sum at {SUM_LARGE[0]} by plan (box bytes × blocks per SM "
        f"× stages, ms): " + ", ".join(f"{k} {t:.4f}" for k, t in
                             sum_station_plans['smem_sum'].items()))
    log(f"station_solve by plan (blocks per SM × points a thread: ms at "
        f"{STATION_PROBE}, at {STATION_LARGE}): " + ", ".join(
            f"{k} {' / '.join(f'{t:.4f}' for t in v)}" for k, v in
            sum_station_plans['station_solve'].items()))
    log(f"smem_limit at {optin} B by plan (bulk copies each way, ms in "
        f"turns): " + ", ".join(f"{k} {t:.4f}" for k, t in
                               sum_station_plans['smem_limit']['turns']))

    # Timings (device ms per launch), beside the plain versions;
    # PROBES_TIMED in turns with their library calls (smem_limit's bound
    # one SM's shared-memory rate at the card's highest SM clock).
    turns = probe_turns(torch, probes)
    shape, boxes = probe_boxes()['probe12']
    x = torch.zeros(shape, device=dev)
    off, ln = boxes[5]
    xv = torch.randn(smem_rows(optin), device=dev, generator=g)
    rows = (y0.clamp(0, xs.shape[2] - 12)[:, None]
            + torch.arange(12, device=dev)).reshape(-1)

    def in_turns(key, **extra):
        """The turns' readings but the entry's own (ms, library_ms and
        the bound at the probe's shape), keyed with their suffix."""
        return {**extra, **{k + sfx: v for sfx, d in turns[key].items()
                            for k, v in d.items()
                            if sfx or k not in ('ms', 'library_ms',
                                                'bound_ms', 'bound_by')}}
    # (name, replaces, key, kernel (None: timed in turns above), plain,
    # (library call, what it is) or (None, why there is none or what was
    # timed in turns), (bytes, flops) or a bound, max|Δ|, extra keys); the
    # library
    # call, one PyTorch call that computes the function, is timed and
    # used nowhere in the port.
    timed = (
        ('probe_tile_copy', 'scripts/hw_probe_ztile.py:46', 'tile_copy',
         None, lambda: probes.tile_copy_plain(x, off, ln),
         (None, 'x[box].add_(1.0)'),
         (2 * 4 * int(np.prod(ln)), 0), 0.0,
         in_turns('tile_copy', plan_ms=plans, also_replaces=[
             'scripts/hw_probe_ztile.py:95', 'scripts/hw_probe_ztile.py:134',
             'scripts/hw_probe_ztile.py:174'])),
        ('probe_smem_limit', 'scripts/hw_probe_ztile.py:209', 'smem_limit',
         None, lambda: probes.smem_limit_plain(xv),
         (None, 'x[0].add_(1.0)'),
         {k: turns['smem_limit'][''][k] for k in ('bound_ms', 'bound_by')},
         0.0, in_turns('smem_limit', optin_bytes=optin,
                       largest_launched=max(b for b, _, e, _, ok in table
                                            if ok and not e),
                       refused={str(b): e for b, _, e, _, _ in table if e},
                       plain_is='smem_limit_plain',
                       plan_ms=sum_station_plans['smem_limit'])),
        ('probe_smem_sum', 'scripts/hw_bisect_zp256.py:49', 'smem_sum',
         None, lambda: probes.smem_sum_plain(f, chx, plane),
         (None, f'f[:{chx}, {plane}].sum(0)'),
         sum_work(f.shape, chx), 0.0,
         in_turns('smem_sum', plan_ms=sum_station_plans['smem_sum'])),
        ('probe_tile_roll', 'scripts/hw_bisect_zp256.py:65', 'tile_roll',
         None, lambda: torch.roll(xr, 1, 1),
         (None, 'torch.roll(x, 1, 1)'),
         (2 * 4 * 8 * 256, 0), 0.0,
         in_turns('tile_roll', plain_is='torch.roll')),
        ('probe_dyn_slice', 'scripts/hw_bisect_zp256.py:84', 'dyn_slice',
         lambda: probes.dyn_slice(xs, y0, 12),
         lambda: probes.dyn_slice_plain(xs, y0, 12),
         (lambda: xs.index_select(2, rows),
          'x.index_select(2, rows), rows the clamped rows of y0 (built '
          'outside the timing), out laid out (A, B, T·ty, Z)'),
         (2 * 4 * 4 * 6 * 66 * 12 * 256, 0), 0.0,
         {'also_replaces': ['scripts/hw_bisect_zp256.py:108']}),
        ('probe_station_solve', 'scripts/hw_bisect_zp256.py:136',
         'station_solve', None, lambda: probes.station_solve_plain(xst),
         (None, 'none: no call takes packed LDLᵀ factors; '
                'torch.linalg.solve needs the matrices assembled (the '
                'plain version)'),
         bound(*station_work(STATION_PROBE), PEAK_FP32), st_err,
         in_turns('station_solve',
                  plan_ms=sum_station_plans['station_solve'])),
    )
    entries = []
    for name, replaces, key, fn, plain, lib, work, err, extra in timed:
        pms = _time_steps(torch, plain, per=1)
        if fn is None:
            ms, lib_ms = (turns[key][''][k] for k in ('ms', 'library_ms'))
        else:
            ms = _time_steps(torch, fn, per=1)
            lib_ms = None if lib[0] is None else _time_steps(
                torch, lib[0], per=1)
        b = work if isinstance(work, dict) else bound(*work)
        entries.append({'name': name, 'route': 'cuda', 'source': PROBE_SRC,
                        'cuda_kernel': PROBE_KERNELS.get(key, key),
                        'replaces': replaces, 'launches': launches[key],
                        'probe_launches': n[key], 'max_abs_err': err,
                        'ms': ms, 'plain_ms': pms, **b,
                        'share': b['bound_ms'] / ms,
                        'library_ms': lib_ms, 'library_call': lib[1],
                        **extra})
    for e in entries:
        lib = f"library {e['library_call']}" if e['library_ms'] is None \
            else f"library {e['library_ms']:.4f} ({e['library_call']})"
        log(f"probe {e['name']}: {e['launches']} launches in phases 4-13, "
            f"{e['probe_launches']} in the checks, {e['ms']:.4f} ms per "
            f"launch (plain {e['plain_ms']:.4f}, bound {e['bound_ms']:.6f}, "
            f"{e['bound_by']}, {e['share']:.1%} of it; {lib})")
    log_turns(turns)
    return entries


def log_turns(turns, who=''):
    """One line per reading of :func:`probe_turns`."""
    for key, r in turns.items():
        for sfx, d in r.items():
            lib = 'no library call' if d['library_ms'] is None else (
                f"library {d['library_ms']:.4f} "
                f"({d['ms'] / d['library_ms']:.2f}×)")
            log(f"{who}{key}{sfx} {d['shape']}: in turns (ms) " + ", ".join(
                f"{k} {t:.4f}" for k, t in d['turns'])
                + f"; kernel {d['ms']:.4f}, {lib}; bound "
                f"{d['bound_ms']:.6f} ({d['bound_by']}), "
                f"{d['share']:.1%} of it; launch floor "
                f"{d['launch_floor_ms']:.4f}")


def station_inputs(torch, tile, dev, g):
    """Random well-conditioned LDLᵀ factors and right-hand sides (40,
    *tile) float32: |L| ≤ 0.2, dinv of modulus 0.5-1."""
    def u(lo, hi, n):
        return lo + (hi - lo) * torch.rand((n,) + tile, device=dev,
                                           generator=g)
    x = torch.empty((40,) + tile, device=dev)
    x[0:20] = u(-0.2, 0.2, 20)
    ang = u(-0.5, 0.5, 5)
    mod = u(0.5, 1.0, 5)
    x[20:30:2], x[21:30:2] = mod * torch.cos(ang), mod * torch.sin(ang)
    x[30:40] = u(-1.0, 1.0, 10)
    return x


def lr128_entries(results, launches):
    """The result line's entries for scripts/hw_bisect_lr128.py's two
    cases, K3 and K4 built and launched apart at 128³: phase 3b's
    readings of them alone at 128³, and their main-path launches."""
    out = []
    for key, line in (('line_residual', 43), ('line_thomas', 86)):
        r = results[key]
        work = {k: v for k, v in (
            _colour_bound(LR128) if key == 'line_residual' else
            bound(*thomas_work(LR128, 0))).items()
            if k in ('bound_ms', 'bound_by')}
        out.append({'name': f'{key}_128', 'route': 'cuda',
                    'source': LINE_SRC,
                    'replaces': f'scripts/hw_bisect_lr128.py:{line}',
                    'launches': launches[key],
                    'probe_launches': r['check_launches_128'],
                    'max_abs_err': r['max_abs_err_128'],
                    'ms': r['ms_128'], 'plain_ms': r['plain_ms_128'],
                    **work, 'library_ms': None})
    return out


def _c64_source(sf):
    """A SourceField of the port in complex64."""
    from emg3d_tpu_torch import SourceField
    return SourceField(*(np.asarray(getattr(sf, c)).astype(np.complex64)
                         for c in ('fx', 'fy', 'fz')),
                       frequency=sf._frequency)


def _rel_max(out, ref):
    """(max|Δ|/max|ref|, max|Δ|) of two component sequences."""
    d = _maxdiff(out, ref)
    return d / _maxabs(ref), d


def _up(t):
    """A complex64/float32 tensor (or None, or a tuple of them) cast
    exactly to complex128/float64."""
    import torch
    if t is None:
        return None
    if isinstance(t, (tuple, list)):
        return tuple(_up(x) for x in t)
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def _upcast_state(state):
    """A point or line state with every tensor cast exactly to
    complex128/float64: the plain version on it is the float64
    evaluation of the float32 inputs."""
    return state._replace(**{k: _up(getattr(state, k)) for k in
                             ('arrays', 'st', 'w', 'ih', 'factors', 'nodes')
                             if getattr(state, k, None) is not None})


def _check_c64(name, shape, triples, tol=TOL_C64):
    """Each triple: a complex64 kernel's result, its complex64 plain
    version's and the float64 evaluation of the same float32 inputs
    (component sequences), all read as max|Δ|/max|ref| and taken at
    their worst over the triples.  The plain version's distance from the
    float64 result, ``ep``, is what float32 rounding costs on these
    inputs; the kernel rounds in another order, so it may land as far on
    the other side.  It passes where both its distance from the float64
    result and its distance from the plain version are within
    max(``tol``, 2·ep).  Logs the three readings and returns
    ``(max|kernel − plain|, readings)``."""
    worst = {'kernel_f64': 0.0, 'plain_f64': 0.0, 'kernel_plain': 0.0}
    dmax = 0.0
    for k, p, x in triples:
        m, d = _maxabs(x), _maxdiff(k, p)
        for key, v in (('kernel_f64', _maxdiff(k, x) / m),
                       ('plain_f64', _maxdiff(p, x) / m),
                       ('kernel_plain', d / m)):
            worst[key] = max(worst[key], v)
        dmax = max(dmax, d)
    log(f"{name} complex64 {shape}: max|Δ|/max|ref| against the float64 "
        f"evaluation: kernel {worst['kernel_f64']:.3e}, plain "
        f"{worst['plain_f64']:.3e}; kernel against plain "
        f"{worst['kernel_plain']:.3e}")
    limit = max(tol, 2 * worst['plain_f64'])
    if not (worst['kernel_f64'] <= limit and worst['kernel_plain'] <= limit):
        raise AssertionError(f"{name} complex64 {shape}: beyond the limit "
                             f"{limit:.3e}")
    return dmax, worst


def _record_c64(res, shape, checked):
    """Adds a _check_c64 result to a kernel's entry: the largest
    max|kernel − plain| and the readings per shape (``checks_c64``)."""
    dmax, worst = checked
    res['max_abs_err_c64'] = max(res.get('max_abs_err_c64', 0.0), dmax)
    res.setdefault('checks_c64', {})['x'.join(map(str, shape))] = worst


def _c64_point(torch, results, shape, dev):
    """K1 and K2 in complex64 against their plain versions at ``shape``
    (:func:`_check_c64`): single colour steps and (below 256³) a nu=1
    call under the chosen plan; at 256³ the step plan on colours 0 and
    7.  Times at 64³ (ms per colour step, chosen plan) and 256³ (step
    plan)."""
    from emg3d_tpu_torch.ops import point_gs
    c64 = torch.complex64
    big = shape == C64_SHAPES[-1]
    gs = point_gs.gauss_seidel_point
    plain = point_gs.gauss_seidel_point_plain
    for mode in POINT_MODES:
        res = results[mode]
        if mode == 'factored' and not point_gs.factors_fit(shape, dev, c64):
            continue
        state, e0, s = _level_fast(shape, seed=sum(shape) + 15, device=dev,
                                   factored=mode == 'factored', dtype=c64)
        state64 = _upcast_state(state)
        plan = 'step' if big else None
        calls = [(1, (c,)) for c in ((0, 7) if big else range(8))]
        if not big:
            calls.append((1, None))
        triples = []
        for nu, seq in calls:
            ref = _clone(e0)
            plain(ref, s, state, nu, _mode=mode, _seq=seq)
            ref64 = _up(e0)
            plain(ref64, _up(s), state64, nu, _mode=mode, _seq=seq)
            out = _clone(e0)
            gs(out, s, state, nu, _mode=mode, _seq=seq, _plan=plan)
            torch.cuda.synchronize()
            triples.append((out, ref, ref64))
        _record_c64(res, shape, _check_c64(KERNELS[mode]['name'], shape,
                                           triples))
        del triples, state64
        ek = _clone(e0)
        if shape == (64, 64, 64):
            p = point_gs.sweep_plan(shape, 3, kernel=mode, dtype=c64)
            res['ms_c64'] = _time_steps(torch, lambda: gs(
                ek, s, state, 3, _mode=mode), reps=20, per=p.steps)
            b = bound(*point_work(shape, mode, 8), PEAK_FP32)
            res['bound_ms_c64'] = b['bound_ms']
            log(f"{KERNELS[mode]['name']} complex64 64³: {res['ms_c64']:.4f}"
                f" ms per colour step ({p.plan} plan; complex128 "
                f"{res['ms']:.4f}), bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']}), {b['bound_ms'] / res['ms_c64']:.0%} of "
                f"it")
        elif big:
            ms = _time_steps(torch, lambda: gs(ek, s, state, 1, _mode=mode,
                                               _plan='step'),
                             reps=5, per=8, warm=1)
            b = bound(*point_work(shape, mode, 8), PEAK_FP32)
            res['ms_c64_256'] = ms
            res['bound_ms_c64_256'] = b['bound_ms']
            log(f"{KERNELS[mode]['name']} complex64 {shape}, step plan: "
                f"{ms:.4f} ms per colour step, bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']}), {b['bound_ms'] / ms:.0%} of it")
        del state, e0, s, ek
        torch.cuda.empty_cache()


def _residual_triple(torch, st, st64, e, s, color):
    """K3 on one colour into a NaN-filled buffer (twice, bitwise equal,
    the plain version's entries NaN and no others), beside the plain
    version in complex64 and in float64, at the colour's edges."""
    from emg3d_tpu_torch.ops import line_gs
    outs = [line_gs.residual(e, s, st, color, _nan_like(e))
            for _ in range(2)]
    ref = line_gs.residual_plain(e, s, st, color, _nan_like(e))
    ref64 = line_gs.residual_plain(_up(e), _up(s), st64, color,
                                   _nan_like(_up(e)))
    torch.cuda.synchronize()
    for a, b, p in zip(*outs, ref):
        if not (torch.equal(torch.isnan(a), torch.isnan(p))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))):
            raise AssertionError(f"line_residual complex64 {st.shape} "
                                 f"colour {color}: runs differ or the "
                                 f"entries written are not the colour's")
    on = [~torch.isnan(p) for p in ref]
    return tuple(tuple(t[m] for t, m in zip(x, on))
                 for x in (outs[0], ref, ref64))


def _c64_line(torch, results, shape, dev):
    """K5, K3 (every colour) and K4 (colours 0 and 3) in complex64, x-lines,
    against their plain versions (:func:`_check_c64`); times at 64³ and
    256³ (K3 mean of the four colours, K4 colour 0, K5 one stack)."""
    from emg3d_tpu_torch.ops import line_gs, smoothers, stencil
    c64 = torch.complex64
    res = {k: results[k] for k in ('line_residual', 'line_thomas',
                                   'line_factor')}
    pstate, e, s = _level_fast(shape, seed=sum(shape) + 16, device=dev,
                               factored=False, dtype=c64)
    st = line_gs.line_state(pstate.arrays, shape, 0)
    st64 = _upcast_state(st)
    ref = smoothers.line_factor_stack(st.arrays, st.shape)
    ref64 = smoothers.line_factor_stack(st64.arrays, st.shape)
    torch.cuda.synchronize()
    e5 = _check_c64('line_factor', shape, [((st.factors,), (ref,),
                                            (ref64,))])
    del ref, ref64
    e3 = _check_c64('line_residual', shape,
                    [_residual_triple(torch, st, st64, e, s, c)
                     for c in range(4)])
    rp = stencil.residual_parts(*s, *e, *st.arrays)
    triples = []
    for color in (0, 3):
        ek = line_gs.thomas(_clone(e), rp, st.factors, st, color)
        ep = smoothers.line_thomas_x(e, rp, st.factors, color)
        ex = smoothers.line_thomas_x(_up(e), _up(rp), _up(st.factors),
                                     color)
        torch.cuda.synchronize()
        triples.append((ek, ep, ex))
    e4 = _check_c64('line_thomas', shape, triples)
    del triples, st64
    for k, checked in (('line_factor', e5), ('line_residual', e3),
                       ('line_thomas', e4)):
        _record_c64(res[k], shape, checked)
    if shape[0] in (64, 256):
        n = '' if shape[0] == 64 else '_256'
        out = _nan_like(e)
        res['line_residual']['ms_c64' + n] = _time_steps(
            torch, lambda: [line_gs.residual(e, s, st, c, out)
                            for c in range(4)],
            reps=20 if not n else 5, per=4)
        res['line_residual']['bound_ms_c64' + n] = _colour_bound(
            shape, 8, PEAK_FP32)['bound_ms']
        zs = line_gs._scratch(st.shape, e[0])
        ek = _clone(e)
        res['line_thomas']['ms_c64' + n] = _time_steps(
            torch, lambda: line_gs.thomas(ek, rp, st.factors, st, 0, zs),
            reps=20 if not n else 5, per=1)
        res['line_thomas']['bound_ms_c64' + n] = bound(
            *thomas_work(shape, 0, 8), PEAK_FP32)['bound_ms']
        del out, zs, ek
        res['line_factor']['ms_c64' + n] = _time_steps(
            torch, lambda: line_gs.factor(st.st, st.w, st.ih, st.shape),
            reps=10 if not n else 3, per=1, warm=1)
        res['line_factor']['bound_ms_c64' + n] = bound(
            *factor_work(st.shape, 8), PEAK_FP32)['bound_ms']
        log(f"{shape} x-lines complex64, ms per launch (bound): "
            + ", ".join(f"{k} {res[k]['ms_c64' + n]:.4f} "
                        f"({res[k]['bound_ms_c64' + n]:.4f}; complex128 "
                        f"{res[k]['ms' + n]:.4f})" for k in res))
    del pstate, e, s, st, rp
    torch.cuda.empty_cache()


def _amat_params64(e, params):
    """A·e in complex128 of the operator given by a level's float32 η
    sums, ζ weights and widths (``dsres.ds_params``), promoted: the
    float64 evaluation of the float32 operator (stencil.amat with these
    coefficients)."""
    import torch
    st, w, ih = (tuple(t.to(torch.complex128 if t.is_complex()
                            else torch.float64) for t in g) for g in params)
    ex, ey, ez = e
    d = torch.diff
    ihx, ihy, ihz = ih[0][:, None, None], ih[1][None, :, None], \
        ih[2][None, None, :]
    u1 = (d(ez, dim=-2) * ihy - d(ey, dim=-1) * ihz) * w[0]
    u2 = (d(ex, dim=-1) * ihz - d(ez, dim=-3) * ihx) * w[1]
    u3 = (d(ey, dim=-3) * ihx - d(ex, dim=-2) * ihy) * w[2]
    rrx = d(u3[..., 1:-1] * ihy, dim=-2) - d(u2[..., 1:-1, :] * ihz, dim=-1)
    rry = d(u1[..., 1:-1, :, :] * ihz, dim=-1) - d(u3[..., 1:-1] * ihx,
                                                   dim=-3)
    rrz = d(u2[..., 1:-1, :] * ihx, dim=-3) - d(u1[..., 1:-1, :, :] * ihy,
                                                dim=-2)
    pad = torch.nn.functional.pad
    return (pad(0.5 * rrx - 0.25 * st[0] * ex[..., 1:-1, 1:-1],
                (1, 1, 1, 1, 0, 0)),
            pad(0.5 * rry - 0.25 * st[1] * ey[..., 1:-1, :, 1:-1],
                (1, 1, 0, 0, 1, 1)),
            pad(0.5 * rrz - 0.25 * st[2] * ez[..., 1:-1, 1:-1, :],
                (0, 0, 1, 1, 1, 1)))


def _dsres_inputs(torch, shape, lanes, dev):
    """A near-converged complex64 level for K6: a random stretched level
    (:func:`_level_fast`; with ``lanes`` > 1, η per lane, lane b's
    resistivities scaled by random factors in [0.5, 1.5)), a random hi
    stream per lane and a lo stream at its rounding level, s = fl32(A64·
    (hi + lo)) (the residual is pure rounding).  Returns (arrays,
    params, hi, lo, s, r64), r64 the float64 residual of the same
    float32 operator."""
    from emg3d_tpu_torch.ops import dsres
    c64 = torch.complex64
    state, hi, _ = _level_fast(shape, seed=sum(shape) + 17, device=dev,
                               factored=False, dtype=c64)
    arrays = state.arrays
    g = torch.Generator(device=dev).manual_seed(17 + lanes)
    if lanes > 1:
        arrays = tuple(torch.stack([a] + [a * (0.5 + torch.rand(
            a.shape, generator=g, device=dev)) for _ in range(lanes - 1)])
            for a in arrays[:3]) + arrays[3:]
        hi = tuple(torch.stack([h] + [torch.randn(
            h.shape, generator=g, device=dev, dtype=c64)
            for _ in range(lanes - 1)]) for h in hi)
    del state
    params = dsres.ds_params(arrays)
    lo = tuple((1e-7 * torch.complex(
        torch.randn(t.shape, generator=g, device=dev, dtype=torch.float64),
        torch.randn(t.shape, generator=g, device=dev,
                    dtype=torch.float64))).to(c64) for t in hi)
    e64 = tuple(h.to(torch.complex128) + x.to(torch.complex128)
                for h, x in zip(hi, lo))
    a64 = _amat_params64(e64, params)
    s = tuple(a.to(c64) for a in a64)
    r64 = tuple(x.to(torch.complex128) - a for x, a in zip(s, a64))
    return arrays, params, hi, lo, s, r64


def _plan_dict(plan):
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in plan._asdict().items()}


def _c64_dsres(torch, results, shape, lanes, dev):
    """K6 against its plain version on a near-converged complex64 level
    (:func:`_dsres_inputs`): its plan twice (bitwise equal), with and
    without the lo stream, each bitwise equal to the plain version (so
    within TOL_DS of it) and within TOL_DS_F64·‖r‖ of the float64
    residual of the same float32 operator.  In the DSRES_TIMED cases
    the plan timed, the plan at every chunk of DSRES_CHUNKS, and the
    plain version."""
    from emg3d_tpu_torch.ops import dsres
    arrays, params, hi, lo, s, r64 = _dsres_inputs(torch, shape, lanes, dev)
    plan = dsres.tile_plan(shape, lanes)
    outs = [dsres.residual(hi, lo, s, params) for _ in range(2)]
    ref = dsres.residual_ds_plain(hi, lo, s, arrays, params)
    out_nolo = dsres.residual(hi, None, s, params)
    ref_nolo = dsres.residual_ds_plain(hi, None, s, arrays, params)
    torch.cuda.synchronize()
    name = f"residual_ds {shape}, {lanes} lane{'s' * (lanes > 1)}"

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    checks = {'two runs': equal(*outs), 'plain': equal(outs[0], ref),
              'no lo stream': equal(out_nolo, ref_nolo)}
    worst, dmax = _rel_max(outs[0], ref)
    f64 = max(float(torch.linalg.norm(o.to(torch.complex128) - r)) /
              float(torch.linalg.norm(r)) for o, r in zip(outs[0], r64))
    log(f"{name}: plan {_plan_dict(plan)}; bitwise equal: "
        + ", ".join(f"{k} {v}" for k, v in checks.items())
        + f"; max|Δ|/max|ref| against plain {worst:.3e}, max over "
        f"components of ‖r − r64‖/‖r64‖ {f64:.3e}")
    if not (all(checks.values()) and worst <= TOL_DS and f64 <= TOL_DS_F64):
        raise AssertionError(f"{name}: {checks}, {worst:.3e} against "
                             f"plain, {f64:.3e} against float64")
    res = results.setdefault('residual_ds', {'max_abs_err': 0.0})
    res['max_abs_err'] = max(res['max_abs_err'], dmax)
    res.setdefault('checks', []).append(
        {'shape': list(shape), 'lanes': lanes, 'bitwise': checks,
         'rel_plain': worst, 'rel_f64': f64})
    del outs, ref, out_nolo, ref_nolo, r64
    if (shape, lanes) not in DSRES_TIMED:
        return
    n = DSRES_TIMED[shape, lanes]
    out = tuple(torch.empty_like(t) for t in s)
    reps = 5 if n == '_256' else 20

    def timed(p):
        return _time_steps(torch, lambda: dsres.residual(
            hi, lo, s, params, out, _plan=p), reps=reps, per=1)
    res['ms' + n] = timed(plan)
    res['plan' + n] = _plan_dict(plan)
    res['chunk_ms' + n] = {c: timed(dsres.tile_plan(shape, lanes, chunk=c))
                           for c in DSRES_CHUNKS if c <= shape[0]}
    res['plain_ms' + n] = _time_steps(torch, lambda: dsres.residual_ds_plain(
        hi, lo, s, arrays, params), reps=5 if not n else 2, per=1,
        warm=1)
    b = bound(*dsres_work(shape, lanes), PEAK_FP32)
    res['bound_ms' + n] = b['bound_ms']
    res['bound_by' + n] = b['bound_by']
    ops = dsres_ops(shape, plan)
    floor = ops * dsres_inner(shape) / PEAK_FP32_ADDS * 1e3
    log(f"{name}: {res['ms' + n]:.4f} ms per launch, plain torch "
        f"{res['plain_ms' + n]:.4f}; bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}), {b['bound_ms'] / res['ms' + n]:.0%} of it; "
        f"fp32 operations per interior edge {ops:.1f}, their floor at the "
        f"add rate {floor:.4f} ms; by chunk (ms) "
        + ", ".join(f"{c}: {t:.4f}" for c, t in res['chunk_ms' + n].items()))
    del out
    torch.cuda.empty_cache()


def phase_c64_kernels(torch, results):
    """Phase 15a: every kernel's complex64 instance against its plain
    version at C64_SHAPES, and K6 at DSRES_CASES, timed at 64³ and
    256³."""
    from emg3d_tpu_torch.ops import point_gs
    dev = torch.device('cuda')
    for code in ('factored', 'fused', 'fused_packed'):
        cap = point_gs.grid_capacity(code, torch.complex64)
        log(f"point_gs grid plan, {code} complex64: {cap} co-resident "
            f"blocks (GRID_BLOCKS {point_gs.GRID_BLOCKS})")
        if cap < point_gs.GRID_BLOCKS:
            raise AssertionError("GRID_BLOCKS exceeds the co-resident "
                                 "blocks")
    for shape in C64_SHAPES:
        _c64_point(torch, results, shape, dev)
        _c64_line(torch, results, shape, dev)
    for shape, lanes in DSRES_CASES:
        _c64_dsres(torch, results, shape, lanes, dev)
        torch.cuda.empty_cache()


def _launch_counts():
    from emg3d_tpu_torch.ops import dsres, line_gs, point_gs
    return {**point_gs.LAUNCHES, **line_gs.LAUNCHES, **dsres.LAUNCHES}


class _Counted:
    """Adds the kernels' launches made inside the block to ``counts``
    (``read``: the counters, by default every instance's)."""

    def __init__(self, counts, read=None):
        self.counts = counts
        self.read = read or _launch_counts

    def __enter__(self):
        self.t0 = self.read()
        return self

    def __exit__(self, *exc):
        for k, v in self.read().items():
            self.counts[k] = self.counts.get(k, 0) + v - self.t0[k]
        return False


# Warm complex64 / complex128 pairs timed in turns per configuration.
C64_PAIRS = 3


def _c64_pair(torch, name, counts, c128, c64, check):
    """Walls of a configuration in complex128 and complex64 in turns: a
    complex128 run, the cold complex64 run, then C64_PAIRS pairs of
    warm complex64 and complex128 runs; the complex64 runs counted in
    ``counts``.  ``check`` holds the cold complex64 result, which is
    returned."""
    walls = {'c128': [], 'c64': []}
    out = cold = None
    runs = [('c128', c128), ('c64', c64)] + \
        [r for _ in range(C64_PAIRS) for r in (('c64', c64), ('c128', c128))]
    for run, fn in runs:
        with _Counted(counts if run == 'c64' else {}):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if run == 'c64' and out is None:
            out, cold = res, wall
        else:
            walls[run].append(wall)
        del res
    check(out)
    med = {k: float(np.median(v)) for k, v in walls.items()}
    log(f"{name} walls (s): complex64 cold {cold:.3f}; in turns, "
        f"complex128 " + ", ".join(f"{w:.3f}" for w in walls['c128'])
        + "; complex64 warm " + ", ".join(f"{w:.3f}" for w in walls['c64'])
        + f"; medians complex128 {med['c128']:.3f}, complex64 "
        f"{med['c64']:.3f} ({med['c64'] / med['c128']:.2f}×)")
    return out


def phase_c64_path(torch, e4, e_sclr, peak8, sim):
    """Phase 15b: the complex64 main path through the kernels, its
    launches counted (``launches_c64``): bench64 (against phase 4's
    field), sclr64 BiCGSTAB (against phase 7's), each timed in turns with
    its complex128 solve; sclr256 standalone (peak memory against phase
    8's, returned beside the launches); sim64's 8 pairs as complex64
    sources through one solve_batched,
    timed in turns with the complex128 batched solve, every lane
    CONVERGED and its responses held to the complex128 solve at tol 1e-10
    (phase 10's, at tol 1e-6, are themselves only as accurate as their
    residual: logged beside).  Returns the launches per kernel, the
    sclr256 peak, K6's launches per solve of each configuration and the
    references of phase 17's complex64 cases: the cold (field, info) of
    bench64 and sclr64 BiCGSTAB, and sclr256's wall and peak; and sim64's
    complex64 fields (phase 18's reference)."""
    from emg3d_tpu_torch import fields, solve, solve_batched
    grid, model, sfield = bench_problem()
    src = _c64_source(sfield)
    counts = {k: 0 for k in _launch_counts()}
    kw = dict(cycle='F', tol=1e-6, verb=1, return_info=True, device='cuda')

    def check_solve(name, ref, **opts):
        def check(out):
            e, info = out
            rel = _rel(e, ref)
            log(f"{name} complex64: {info['exit_message']}, it_mg "
                f"{info['it_mg']}, it_ssl {info['it_ssl']}, rel_error "
                f"{info['rel_error']:.3e}, returned {e.field.dtype}, "
                f"|Δ|/|e| against complex128 {rel:.3e}")
            if not (info['exit_message'] == 'CONVERGED'
                    and info['rel_error'] < 1e-6
                    and e.field.dtype == np.complex128
                    and rel <= TOL_C64_FIELD):
                raise AssertionError(f"{name} complex64: {info}")
        return check

    # K6's launches per complex64 solve of each configuration.
    k6 = {}
    refs = {}

    def pair(name, *args):
        n0 = counts['residual_ds']
        refs[name] = _c64_pair(torch, name, counts, *args)
        k6[name] = (counts['residual_ds'] - n0) / (1 + C64_PAIRS)
    pair('bench64', lambda: solve(grid, model, sfield, **kw),
         lambda: solve(grid, model, src, **kw), check_solve('bench64', e4))
    log(f"bench64 complex64 launches (cold + warm): {counts}")
    pair('sclr64 bicgstab',
         lambda: solve(grid, model, sfield, sslsolver=True, **SCLR, **kw),
         lambda: solve(grid, model, src, sslsolver=True, **SCLR, **kw),
         check_solve('sclr64 bicgstab', e_sclr))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g256, m256, s256 = bench_problem((256,) * 3)
    n0 = counts['residual_ds']
    with _Counted(counts):
        e256, i256, w256 = _solve(torch, g256, m256, _c64_source(s256),
                                  **SCLR)
    k6['sclr256'] = counts['residual_ds'] - n0
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"sclr256 complex64: {i256['exit_message']}, it_mg {i256['it_mg']}, "
        f"rel_error {i256['rel_error']:.3e}, wall {w256:.3f} s; peak device "
        f"memory {peak:.2f} GiB (complex128, phase 8: {peak8:.2f} GiB)")
    if not i256['rel_error'] < 1e-6:
        raise AssertionError("sclr256 complex64 above tol")
    refs['sclr256'] = {'wall': w256, 'peak': peak, 'it_mg': i256['it_mg']}
    del e256, g256, m256, s256
    torch.cuda.empty_cache()

    # sim64: phase 10's pairs as complex64 sources, one batched solve.
    survey = sim.survey
    pairs = [(p, f) for p in survey.sources for f in SIM_FREQS]
    opts = {k: v for k, v in sim.solver_opts.items()
            if k not in ('sslsolver', 'return_info', 'log')}
    ssl = sim.solver_opts.get('sslsolver', True)
    opts['sslsolver'] = 'bicgstab' if ssl is True else ssl
    sf128 = [sim.get_sfield(*p) for p in pairs]
    sf64 = [_c64_source(x) for x in sf128]
    grid10, model10 = sim.get_grid(*pairs[0]), sim.get_model(*pairs[0])
    ref, rinfo = solve_batched(grid10, model10, sf128,
                               **{**opts, 'tol': 1e-10})
    erec = np.nonzero(survey.rec_types)[0]
    rec = tuple(np.array(survey.rec_coords)[:, erec])

    def check_sim(out):
        efs, info = out
        worst = worst10 = err10 = 0.0
        for (p, f), ef, er in zip(pairs, efs, ref):
            got = fields.get_receiver_response(grid=grid10, field=ef,
                                               rec=rec)
            acc = fields.get_receiver_response(grid=grid10, field=er,
                                               rec=rec)
            r10 = sim.data.synthetic[sim._src_index(p), erec,
                                     sim._freq_index(f)]
            # The Simulation leaves NaN where it drops a response.
            fin = np.isfinite(r10)
            if not (fin.any() and np.isfinite(got[fin]).all()
                    and np.isfinite(acc[fin]).all()):
                raise AssertionError(f"sim64 complex64 {p} {f} Hz: "
                                     f"non-finite responses")
            m = np.max(np.abs(acc[fin]))
            worst = max(worst, float(np.max(np.abs(got[fin] - acc[fin]))
                                     / m))
            worst10 = max(worst10, float(np.max(np.abs(got[fin] - r10[fin]))
                                         / m))
            err10 = max(err10, float(np.max(np.abs(r10[fin] - acc[fin]))
                                     / m))
        log(f"sim64 complex64 ({len(pairs)} lanes): {info['exit_message']}, "
            f"it_mg {info['it_mg']}, it_ssl {info['it_ssl']}, rel_error max "
            f"{info['rel_error'].max():.3e}; responses max|Δ|/max|ref| "
            f"against complex128 at tol 1e-10 (it_mg {rinfo['it_mg']}, "
            f"rel_error max {rinfo['rel_error'].max():.3e}) {worst:.3e}, "
            f"against phase 10's {worst10:.3e} (phase 10's own, against tol "
            f"1e-10: {err10:.3e})")
        if not (info['exit_message'] == 'CONVERGED'
                and np.all(info['rel_error'] < SIM_TOL)
                and all(ef.field.dtype == np.complex128 for ef in efs)
                and worst <= TOL_C64_FIELD
                and worst10 <= err10 + TOL_C64_FIELD):
            raise AssertionError("sim64 complex64 batched solve")

    pair('sim64 solve_batched',
         lambda: solve_batched(grid10, model10, sf128, **opts),
         lambda: solve_batched(grid10, model10, sf64, **opts), check_sim)
    sim_fields = refs.pop('sim64 solve_batched')[0]
    log(f"complex64 main path launches: {counts}; K6 per solve: {k6}")
    if min(counts.values()) == 0:
        raise AssertionError(f"the complex64 path launched no "
                             f"{min(counts, key=counts.get)}")
    return counts, peak, k6, refs, sim_fields


def phase_c64_plain(torch):
    """Phase 15c: complex64 solves at 16³ through the kernels and through
    ``_build.PLAIN`` (plain smoothers, plain K6): the same exit, it_mg
    ±1, fields within TOL_C64_FIELD; point and sc+lr."""
    grid, model, sfield = bench_problem((16,) * 3)
    src = _c64_source(sfield)
    for name, kw in (('point', {}), ('sc+lr', SCLR)):
        ek, ik, wk = _solve(torch, grid, model, src, **kw)
        with _plain():
            ep, ip, wp = _solve(torch, grid, model, src, **kw)
        rel = _rel(ek, ep)
        log(f"16³ complex64 {name}: kernels it_mg {ik['it_mg']} "
            f"({wk:.3f} s), plain it_mg {ip['it_mg']} ({wp:.3f} s), "
            f"|Δ|/|e| {rel:.3e}")
        if abs(ik['it_mg'] - ip['it_mg']) > 1 or not rel <= TOL_C64_FIELD:
            raise AssertionError(f"16³ complex64 {name}: kernels and plain "
                                 f"differ")


# ----------------------------------------------------------------------
# Phase 16: bfloat16 storage of the complex64 solve
# ----------------------------------------------------------------------

def _bf16_ulp(torch, x):
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    a = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _record_bf16(res, shape, checked):
    """Adds a phase-16 check to a kernel's entry: the largest
    max|kernel − plain| and the readings per shape (``checks_bf16``)."""
    dmax, worst = checked
    res['max_abs_err_bf16'] = max(res.get('max_abs_err_bf16', 0.0), dmax)
    res.setdefault('checks_bf16', {})['x'.join(map(str, shape))] = worst


def _bf16_point(torch, results, shape, dev):
    """K1 and K2's bfloat16 instances against their plain versions at
    ``shape``, as :func:`_c64_point` holds the complex64 ones: both
    against the float64 evaluation of the same rounded inputs (the
    stored η sums, ζ weights and source, widened) and each other
    (:func:`_check_c64`).  At 64³ and 256³ timed in turns with the
    float32-storage instance on the same level."""
    from emg3d_tpu_torch.dtypes import BF16, from_storage, round_to
    from emg3d_tpu_torch.ops import point_gs, smoothers
    c64 = torch.complex64
    big = shape == C64_SHAPES[-1]
    gs = point_gs.gauss_seidel_point
    plain = point_gs.gauss_seidel_point_plain
    for mode in POINT_MODES:
        res = results[mode]
        if mode == 'factored' and not point_gs.factors_fit(shape, dev, c64):
            continue
        state, e0, s = _level_fast(shape, seed=sum(shape) + 18, device=dev,
                                   factored=mode == 'factored', dtype=c64,
                                   storage=BF16)
        sw64 = (_up(tuple(from_storage(t, True) for t in state.st)),
                _up(tuple(from_storage(t) for t in state.w)), _up(state.ih))
        s64 = _up(tuple(round_to(t, BF16) for t in s))
        fact64 = None
        if mode == 'factored':
            L, dinv = point_gs._plain_fact(state)
            fact64 = ({k: _up(v) for k, v in L.items()}, _up(dinv))
        plan = 'step' if big else None
        calls = [(1, (c,)) for c in ((0, 7) if big else range(8))]
        if not big:
            calls.append((1, None))
        triples = []
        for nu, seq in calls:
            ref = _clone(e0)
            plain(ref, s, state, nu, _mode=mode, _seq=seq)
            ref64 = smoothers.color_steps(
                _up(e0), s64, _up(state.arrays),
                smoothers.color_sequence(nu) if seq is None else list(seq),
                fact=fact64, sw=sw64)
            out = _clone(e0)
            gs(out, s, state, nu, _mode=mode, _seq=seq, _plan=plan)
            torch.cuda.synchronize()
            triples.append((out, ref, ref64))
        _record_bf16(res, shape, _check_c64(
            KERNELS[mode]['name'] + ' bf16', shape, triples))
        del triples, sw64, s64, fact64
        if shape[0] in (64, 256):
            n = '_256' if big else ''
            f32 = point_gs.point_state(state.arrays, shape,
                                       factored=mode == 'factored')
            ek = _clone(e0)
            if big:
                kw, per, reps, warm = dict(_plan='step'), 8, 5, 1
                nu = 1
            else:
                nu, reps, warm = 3, 20, 3
                kw = {}
                per = point_gs.sweep_plan(shape, nu, kernel=mode, dtype=c64,
                                          storage=BF16).steps
            times = {}
            for key, st_ in (('ms_f32s', f32), ('ms_bf16', state),
                             ('ms_bf16', state), ('ms_f32s', f32)):
                times.setdefault(key, []).append(_time_steps(
                    torch, lambda: gs(ek, s, st_, nu, _mode=mode, **kw),
                    reps=reps, per=per, warm=warm))
            for key, v in times.items():
                res[key + n] = float(np.median(v))
            b = bound(*point_work(shape, mode, 8, stream=4), PEAK_FP32)
            res['bound_ms_bf16' + n] = b['bound_ms']
            log(f"{KERNELS[mode]['name']} bf16 {shape}: "
                f"{res['ms_bf16' + n]:.4f} ms per colour step (float32 "
                f"storage {res['ms_f32s' + n]:.4f}), bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}), "
                f"{b['bound_ms'] / res['ms_bf16' + n]:.0%} of it")
            del f32, ek
        del state, e0, s
        torch.cuda.empty_cache()


def _bf16_line(torch, results, shape, dev):
    """K5, K3 (every colour) and K4 (colours 0 and 3) in their bfloat16
    instances, x-lines, against their plain versions.  K3 and K4 as
    :func:`_check_c64` holds the complex64 ones (to the float64
    evaluation of the same rounded inputs and to the plain version).
    K5 stores the bfloat16 rounding of a float32 elimination: its stack
    is held to the rounding of its float32 instance's (within one
    bfloat16 ulp; bitwise where the two instances compile alike) and
    of the plain elimination's (within one ulp of their float32
    distance).  At 64³ and 256³ timed in turns with the float32-storage
    instances."""
    from emg3d_tpu_torch.dtypes import (BF16, from_storage, round_to,
                                        to_storage)
    from emg3d_tpu_torch.ops import line_gs, smoothers, stencil
    c64 = torch.complex64
    res = {k: results[k] for k in ('line_residual', 'line_thomas',
                                   'line_factor')}
    pstate, e, s = _level_fast(shape, seed=sum(shape) + 19, device=dev,
                               factored=False, dtype=c64)
    f32 = line_gs.line_state(pstate.arrays, shape, 0)
    stb = line_gs.line_state(pstate.arrays, shape, 0, storage=BF16,
                             fstorage=BF16)
    torch.cuda.synchronize()
    # K5.
    kb = from_storage(stb.factors, True)
    ref = smoothers.line_factor_stack(f32.arrays, f32.shape)
    a, b, c = (torch.view_as_real(t) for t in
               (kb, round_to(f32.factors, BF16), round_to(ref, BF16)))
    fk, fp = torch.view_as_real(f32.factors), torch.view_as_real(ref)
    same = float((a == b).double().mean())
    own = bool(((a - b).abs() <= _bf16_ulp(torch, torch.maximum(
        a.abs(), b.abs()))).all())
    vs_plain = bool(((a - c).abs() <= (fk - fp).abs() + _bf16_ulp(
        torch, torch.maximum(a.abs(), c.abs()))).all())
    d5 = float((a - c).abs().max())
    worst5 = {'bitwise_own_f32': same, 'kernel_plain': d5 / float(
        c.abs().max())}
    log(f"line_factor bf16 {shape}: {same:.6f} of the entries bitwise the "
        f"rounding of the float32 instance's (all within one ulp: {own}); "
        f"against the plain elimination's rounding max|Δ|/max|ref| "
        f"{worst5['kernel_plain']:.3e}, within one ulp of the float32 "
        f"distance: {vs_plain}")
    if not (own and vs_plain):
        raise AssertionError(f"line_factor bf16 {shape}")
    _record_bf16(res['line_factor'], shape, (d5, worst5))
    del a, b, c, fk, fp, ref
    # K3.
    sw64 = (_up(tuple(from_storage(t, True) for t in stb.st)),
            _up(tuple(from_storage(t) for t in stb.w)), _up(stb.ih))
    sb = tuple(to_storage(t, BF16) for t in s)
    r64 = stencil.residual_sw(*_up(tuple(round_to(t, BF16) for t in s)),
                              *_up(e), *sw64)
    triples = []
    for color in range(4):
        outs = [line_gs.residual(e, sb, stb, color, _nan_like(e))
                for _ in range(2)]
        ref = line_gs.residual_plain(e, s, stb, color, _nan_like(e))
        torch.cuda.synchronize()
        for x, y, p in zip(*outs, ref):
            if not (torch.equal(torch.isnan(x), torch.isnan(p))
                    and torch.equal(torch.nan_to_num(x),
                                    torch.nan_to_num(y))):
                raise AssertionError(f"line_residual bf16 {shape} colour "
                                     f"{color}: runs differ or the entries "
                                     f"written are not the colour's")
        on = [~torch.isnan(p) for p in ref]
        triples.append(tuple(tuple(t[m] for t, m in zip(x, on))
                             for x in (outs[0], ref, r64)))
    _record_bf16(res['line_residual'], shape,
                 _check_c64('line_residual bf16', shape, triples))
    del triples, r64, sw64
    # K4 on the bfloat16 stack.
    rp = stencil.residual_parts(*s, *e, *f32.arrays)
    triples = []
    for color in (0, 3):
        ek = line_gs.thomas(_clone(e), rp, stb.factors, stb, color)
        ep = smoothers.line_thomas_x(e, rp, kb, color)
        ex = smoothers.line_thomas_x(_up(e), _up(rp), _up(kb), color)
        torch.cuda.synchronize()
        triples.append((ek, ep, ex))
    _record_bf16(res['line_thomas'], shape,
                 _check_c64('line_thomas bf16', shape, triples))
    del triples, kb
    if shape[0] in (64, 256):
        n = '' if shape[0] == 64 else '_256'
        big = bool(n)
        out = _nan_like(e)
        zs = line_gs._scratch(stb.shape, e[0])
        ek = _clone(e)
        runs = {
            'line_residual': (
                lambda st_, s_: [line_gs.residual(e, s_, st_, c, out)
                                 for c in range(4)], 4, 5 if big else 20, 3),
            'line_thomas': (
                lambda st_, s_: line_gs.thomas(ek, rp, st_.factors, st_, 0,
                                               zs), 1, 5 if big else 20, 3),
            'line_factor': (
                lambda st_, s_: line_gs.factor(f32.st, f32.w, f32.ih,
                                               f32.shape,
                                               storage=st_.fstorage),
                1, 3 if big else 10, 1)}
        for k, (fn, per, reps, warm) in runs.items():
            times = {}
            for key, st_, s_ in (('ms_f32s', f32, s), ('ms_bf16', stb, sb),
                                 ('ms_bf16', stb, sb), ('ms_f32s', f32, s)):
                times.setdefault(key, []).append(_time_steps(
                    torch, lambda: fn(st_, s_), reps=reps, per=per,
                    warm=warm))
            for key, v in times.items():
                res[k][key + n] = float(np.median(v))
        res['line_residual']['bound_ms_bf16' + n] = _colour_bound(
            shape, 8, PEAK_FP32, stream=4)['bound_ms']
        res['line_thomas']['bound_ms_bf16' + n] = bound(
            *thomas_work(shape, 0, 8, fsize=4), PEAK_FP32)['bound_ms']
        res['line_factor']['bound_ms_bf16' + n] = bound(
            *factor_work(shape, 8, fsize=4), PEAK_FP32)['bound_ms']
        log(f"{shape} x-lines bf16, ms per launch (bound; float32 storage): "
            + ", ".join(f"{k} {res[k]['ms_bf16' + n]:.4f} "
                        f"({res[k]['bound_ms_bf16' + n]:.4f}; "
                        f"{res[k]['ms_f32s' + n]:.4f})" for k in res))
        del out, zs, ek
    del pstate, e, s, sb, f32, stb, rp
    torch.cuda.empty_cache()


def phase_bf16_kernels(torch, results):
    """Phase 16a: K1-K5's bfloat16 instances against their plain versions
    at C64_SHAPES, timed beside their float32-storage instances."""
    from emg3d_tpu_torch.dtypes import BF16
    from emg3d_tpu_torch.ops import point_gs
    dev = torch.device('cuda')
    for code in ('factored', 'fused', 'fused_packed'):
        cap = point_gs.grid_capacity(code, torch.complex64, BF16)
        log(f"point_gs grid plan, {code} bf16: {cap} co-resident blocks "
            f"(GRID_BLOCKS {point_gs.GRID_BLOCKS})")
        if cap < point_gs.GRID_BLOCKS:
            raise AssertionError("GRID_BLOCKS exceeds the co-resident "
                                 "blocks")
    for shape in C64_SHAPES:
        _bf16_point(torch, results, shape, dev)
        _bf16_line(torch, results, shape, dev)


def _bf16_counts():
    """The bfloat16 instances' launches of K1-K5, and K6's (complex64
    only: its launches in the bfloat16 runs)."""
    from emg3d_tpu_torch.ops import dsres, line_gs, point_gs
    return {**point_gs.BF16_LAUNCHES, **line_gs.BF16_LAUNCHES,
            **dsres.LAUNCHES}


def phase_bf16_path(torch, e4, e_sclr, peak_c64):
    """Phase 16b: the complex64 main path with bfloat16 storage (the
    default on the card) against float32 storage: bench64, sclr64
    standalone and sclr64 BiCGSTAB each a cold bfloat16 run, then
    C64_PAIRS warm bfloat16 / float32 pairs in turns (exit, it_mg,
    it_ssl, walls, peak memory, the field against complex128); sclr256
    with bfloat16 stacks once, its peak beside phase 15's float32-storage
    one.  The bfloat16 runs' launches of each kernel's bfloat16 instance
    are counted (``launches_bf16``), K6's too; returns them."""
    from emg3d_tpu_torch import solve, solver
    grid, model, sfield = bench_problem()
    src = _c64_source(sfield)
    counts = {k: 0 for k in _bf16_counts()}
    kw = dict(cycle='F', tol=1e-6, verb=1, return_info=True, device='cuda')
    configs = (('bench64', {}, e4), ('sclr64 standalone', SCLR, e_sclr),
               ('sclr64 bicgstab', dict(SCLR, sslsolver=True), e_sclr))
    for name, opts, ref in configs:
        walls = {'bf16': [], 'f32': []}
        info = {}
        runs = [('bf16', None)] + [r for _ in range(C64_PAIRS) for r in (
            ('bf16', None), ('f32', False))]
        for i, (run, flag) in enumerate(runs):
            solver.BF16_STORAGE = flag
            torch.cuda.reset_peak_memory_stats()
            with _Counted(counts if run == 'bf16' else {}, _bf16_counts):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e, inf = solve(grid, model, src, **opts, **kw)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            solver.BF16_STORAGE = None
            peak = torch.cuda.max_memory_allocated() / 2**30
            rel = _rel(e, ref)
            if i == 0:
                cold = wall
            else:
                walls[run].append(wall)
            info.setdefault(run, (inf, rel, peak))
            if not (inf['exit_message'] == 'CONVERGED'
                    and inf['rel_error'] < 1e-6
                    and e.field.dtype == np.complex128
                    and rel <= TOL_C64_FIELD):
                raise AssertionError(f"{name} complex64 {run}: {inf}, "
                                     f"|Δ|/|e| against complex128 {rel:.3e}")
        med = {k: float(np.median(v)) for k, v in walls.items()}
        for run in ('bf16', 'f32'):
            inf, rel, peak = info[run]
            log(f"{name} complex64, {run} storage: {inf['exit_message']}, "
                f"it_mg {inf['it_mg']}, it_ssl {inf['it_ssl']}, rel_error "
                f"{inf['rel_error']:.3e}, |Δ|/|e| against complex128 "
                f"{rel:.3e}, peak {peak:.3f} GiB")
        log(f"{name} walls (s): bf16 cold {cold:.3f}; in turns, bf16 "
            + ", ".join(f"{w:.3f}" for w in walls['bf16']) + "; float32 "
            + ", ".join(f"{w:.3f}" for w in walls['f32'])
            + f"; medians bf16 {med['bf16']:.3f}, float32 {med['f32']:.3f}"
            f" ({med['bf16'] / med['f32']:.2f}×)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g256, m256, s256 = bench_problem((256,) * 3)
    with _Counted(counts, _bf16_counts):
        e256, i256, w256 = _solve(torch, g256, m256, _c64_source(s256),
                                  **SCLR)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"sclr256 complex64, bf16 storage: {i256['exit_message']}, it_mg "
        f"{i256['it_mg']}, rel_error {i256['rel_error']:.3e}, wall "
        f"{w256:.3f} s; peak device memory {peak:.2f} GiB (float32 "
        f"storage, phase 15: {peak_c64:.2f} GiB)")
    if not i256['rel_error'] < 1e-6:
        raise AssertionError("sclr256 complex64 bf16 above tol")
    del e256, g256, m256, s256
    torch.cuda.empty_cache()
    log(f"bf16 main path launches of the bfloat16 instances: {counts}")
    if min(counts.values()) == 0:
        raise AssertionError(f"the bf16 path launched no "
                             f"{min(counts, key=counts.get)} bf16 instance")
    return counts, peak


def phase_bf16_plain(torch):
    """Phase 16c: complex64 solves at 16³ with bfloat16 storage through
    the kernels and under ``_build.PLAIN`` (which rounds where the
    kernels do): the same exit, it_mg ±1, fields within TOL_C64_FIELD;
    point, sc+lr, and sc+lr with every stack in bfloat16
    (``FSTACK_BYTES`` 0: K4 and K5 in bfloat16 too)."""
    from emg3d_tpu_torch import solver
    grid, model, sfield = bench_problem((16,) * 3)
    src = _c64_source(sfield)
    threshold = solver.FSTACK_BYTES
    for name, kw, fbytes in (('point', {}, threshold),
                             ('sc+lr', SCLR, threshold),
                             ('sc+lr, bf16 stacks', SCLR, 0)):
        solver.FSTACK_BYTES = fbytes
        try:
            ek, ik, wk = _solve(torch, grid, model, src, **kw)
            with _plain():
                ep, ip, wp = _solve(torch, grid, model, src, **kw)
        finally:
            solver.FSTACK_BYTES = threshold
        rel = _rel(ek, ep)
        log(f"16³ complex64 bf16 {name}: kernels it_mg {ik['it_mg']} "
            f"({wk:.3f} s), plain it_mg {ip['it_mg']} ({wp:.3f} s), "
            f"|Δ|/|e| {rel:.3e}")
        if abs(ik['it_mg'] - ip['it_mg']) > 1 or not rel <= TOL_C64_FIELD:
            raise AssertionError(f"16³ complex64 bf16 {name}: kernels and "
                                 f"plain differ")


def _free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(('127.0.0.1', 0))
        return sk.getsockname()[1]


def _shard_problem(case):
    grid, model, sfield = heterogeneous_problem() \
        if case.startswith('tri') else bench_problem()
    if case in C64_SHARD_CASES:
        sfield = _c64_source(sfield)
    return grid, model, sfield


def _slab_checks(torch, problem, opts, rank):
    """K1 and K2 against their plain versions on this rank's slabs of
    the two finest levels, as the sharded solve cuts them: every colour
    step alone on random e and s.  Returns one record per level and
    kernel (max|Δ|, max|Δ|/max|e|)."""
    from emg3d_tpu_torch import VolumeModel, solver
    from emg3d_tpu_torch.ops import point_gs
    grid, model, sfield = problem
    var = solver.MGParameters(verb=0, cycle='F', sslsolver=False,
                              linerelaxation=False, semicoarsening=False,
                              shape_cells=tuple(grid.shape_cells))
    ctx = solver._SolveContext(grid, VolumeModel(grid, model, sfield),
                               sfield, sfield, var, 'cuda',
                               solver._normalize_sharding(opts))
    rng = np.random.default_rng(100 + rank)
    out = []
    for lvl, lev in enumerate(ctx.levels(int(var.sc_dir))[:2]):
        if lev.slab is None:
            continue
        nx, ny, nz = lev.slab.shape
        edges = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                 (nx + 1, ny + 1, nz))

        def rand():
            return lev.slab.cut_field(tuple(
                torch.tensor(rng.standard_normal(sh)
                             + 1j * rng.standard_normal(sh))
                for sh in edges))
        e0 = tuple(t.cuda() for t in rand())
        s = tuple(t.cuda() for t in rand())
        for mode in POINT_MODES:
            state = point_gs.point_state(lev.arrays, lev.shape,
                                         factored=mode == 'factored')
            errs = []
            for c in range(8):
                ek = tuple(t.clone() for t in e0)
                ep = tuple(t.clone() for t in e0)
                point_gs.gauss_seidel_point(ek, s, state, 1, _mode=mode,
                                            _seq=[c])
                point_gs.gauss_seidel_point_plain(ep, s, state, 1,
                                                  _mode=mode, _seq=[c])
                errs.append((_maxdiff(ek, ep), _maxabs(ep)))
            torch.cuda.synchronize()
            out.append({'level': lvl, 'slab': list(lev.shape),
                        'kernel': mode,
                        'solve_kernel': point_gs.point_kernel(lev.shape,
                                                              'cuda'),
                        'max_abs_err': max(a for a, _ in errs),
                        'rel': max(a / m for a, m in errs)})
    return out


def _nan_diff(a, b):
    """max|a − b| where both are finite, and whether their NaNs agree."""
    same = all(bool((x.isnan() == y.isnan()).all()) for x, y in zip(a, b))
    diff = max(_finite_max(x - y) for x, y in zip(a, b))
    return diff, same


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _finite_max(t):
    """max|t| over its entries that are not NaN (0 if none)."""
    v = t[~t.isnan()]
    return float(v.abs().max()) if v.numel() else 0.0


def _slab_line_checks(torch, problem, opts, rank, device='cuda'):
    """K3, K4 and K5 against their plain versions on this rank's slabs of
    the two finest levels of the sc+lr solve's first hierarchy, as the
    sharded solve cuts them, for lines along each axis: within the rank
    (the slab's K5 stack, K3 and K4 of every colour on random rotated e,
    s), or along an axis split over ranks (the interior segment: K5 with
    ``stations``, K4 of the segment with ``stations``; K3 on the slab).
    Levels whose lines are gathered run the unflagged kernels on the
    whole level and are skipped.  Returns one record per level and axis
    (max|Δ| and max|Δ|/max|plain| of each kernel)."""
    from emg3d_tpu_torch import VolumeModel, solver
    from emg3d_tpu_torch.ops import line_gs
    from emg3d_tpu_torch.parallel import lines
    grid, model, sfield = problem
    var = solver.MGParameters(verb=0, cycle='F', sslsolver=False,
                              shape_cells=tuple(grid.shape_cells), **SCLR)
    ctx = solver._SolveContext(grid, VolumeModel(grid, model, sfield),
                               sfield, sfield, var, device,
                               solver._normalize_sharding(opts))
    g = torch.Generator(device=device).manual_seed(300 + rank)
    nan = complex(math.nan, math.nan)

    def rand(shape):
        nx, ny, nz = shape
        return tuple(torch.complex(
            torch.randn(sh, generator=g, device=device, dtype=torch.float64),
            torch.randn(sh, generator=g, device=device, dtype=torch.float64))
            for sh in ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                       (nx + 1, ny + 1, nz)))
    out = []
    for lvl, lev in enumerate(ctx.levels(int(var.sc_dir))[:2]):
        slab = lev.slab
        if slab is None:
            continue
        for ax in range(3):
            split = slab.split(ax)
            if split and not slab.line_supported(ax):
                continue
            if split:
                st = lines.schur_state(lev, ax)
                with _plain():
                    stp = lines.schur_state(lev, ax)
                state, sub, ns = st.slab, st.sub, st.stations
                fk, fp = st.fac, stp.fac
            else:
                state = line_gs.line_state(lev.arrays, lev.shape, ax)
                fk = state.factors
                with _plain():
                    fp = line_gs.line_state(lev.arrays, lev.shape,
                                            ax).factors
                sub, ns = state, state.shape[0]
            _sync(torch)
            k5 = (_maxdiff((fk,), (fp,)), _maxabs((fp,)))
            L = state.shape[0]
            er, sr = rand(state.shape), rand(state.shape)
            k3, k4 = [], []
            for c in range(4):
                rk = tuple(torch.full_like(t, nan) for t in er)
                rp = tuple(torch.full_like(t, nan) for t in er)
                line_gs.residual(er, sr, state, c, rk)
                line_gs.residual_plain(er, sr, state, c, rp)
                _sync(torch)
                diff, same = _nan_diff(rk, rp)
                if not same:
                    raise AssertionError(f"K3 wrote other edges than its "
                                         f"plain version (level {lvl}, "
                                         f"axis {ax}, colour {c})")
                k3.append((diff, max(_finite_max(t) for t in rp)))
                rs = rp if not split else (rp[0][1:], rp[1][1:L + 1],
                                           rp[2][1:L + 1])
                e0 = er if not split else (er[0][1:], er[1][1:L + 1],
                                           er[2][1:L + 1])
                ek = tuple(t.clone() for t in e0)
                ep = tuple(t.clone() for t in e0)
                line_gs.thomas(ek, rs, fp, sub, c, stations=ns)
                line_gs.thomas_plain(ep, rs, fp, c, stations=ns)
                _sync(torch)
                k4.append((_maxdiff(ek, ep), _maxabs(ep)))
            rec = {'level': lvl, 'slab': list(lev.shape), 'axis': ax,
                   'lines': 'schur' if split else 'within',
                   'stations': ns, 'nx': sub.shape[0]}
            for key, errs in (('line_factor', [k5]), ('line_residual', k3),
                              ('line_thomas', k4)):
                rec[key] = {'max_abs_err': max(a for a, _ in errs),
                            'rel': max(a / m for a, m in errs)}
            out.append(rec)
    return out


def _case_opts(case):
    """The solve options of a phase 17 case."""
    return {**LINE_SHARD_CASES, **C64_SHARD_CASES}.get(case, {})


def _c64_field(torch, shape, rng, device='cuda'):
    """Random complex64 edge fields of a level of cell shape ``shape``."""
    nx, ny, nz = shape
    return tuple(torch.tensor(rng.standard_normal(sh)
                              + 1j * rng.standard_normal(sh),
                              dtype=torch.complex64, device=device)
                 for sh in ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                            (nx + 1, ny + 1, nz)))


def _slab_checks_c64(torch, problem, opts, rank, device='cuda'):
    """K1's and K2's complex64 instances against their plain versions on
    this rank's slabs of the two finest levels of the complex64 point
    solve (every colour step alone, :func:`_check_c64`: both within
    max(TOL_C64, 2·ep) of the float64 evaluation of the same float32
    inputs), and K6 on the finest slab (``ctx.residual_ds``: hi's and
    lo's ghosts refreshed, the slab's ``ds_params``) against
    ``residual_ds_plain`` on the same slab inputs, its owned edges within
    TOL_DS.  Returns one record per level and kernel."""
    from emg3d_tpu_torch import VolumeModel, solver
    from emg3d_tpu_torch.ops import dsres, point_gs
    grid, model, sfield = problem
    var = solver.MGParameters(verb=0, cycle='F', sslsolver=False,
                              linerelaxation=False, semicoarsening=False,
                              shape_cells=tuple(grid.shape_cells))
    ctx = solver._SolveContext(grid, VolumeModel(grid, model, sfield),
                               sfield, sfield, var, device,
                               solver._normalize_sharding(opts))
    rng = np.random.default_rng(200 + rank)
    out = []
    for lvl, lev in enumerate(ctx.levels(int(var.sc_dir))[:2]):
        if lev.slab is None:
            continue
        e0, s = _c64_field(torch, lev.shape, rng, device), \
            _c64_field(torch, lev.shape, rng, device)
        for mode in POINT_MODES:
            state = point_gs.point_state(lev.arrays, lev.shape,
                                         factored=mode == 'factored')
            state64 = _upcast_state(state)
            triples = []
            for c in range(8):
                ek, ep, ex = _clone(e0), _clone(e0), _up(e0)
                point_gs.gauss_seidel_point(ek, s, state, 1, _mode=mode,
                                            _seq=[c])
                point_gs.gauss_seidel_point_plain(ep, s, state, 1,
                                                  _mode=mode, _seq=[c])
                point_gs.gauss_seidel_point_plain(ex, _up(s), state64, 1,
                                                  _mode=mode, _seq=[c])
                triples.append((ek, ep, ex))
            _sync(torch)
            dmax, worst = _check_c64(
                f"{KERNELS[mode]['name']} rank {rank} level {lvl} slab",
                lev.shape, triples)
            out.append({'level': lvl, 'slab': list(lev.shape),
                        'kernel': mode, 'max_abs_err': dmax, **worst})
        if lvl == 0:
            hi, s0 = _c64_field(torch, lev.shape, rng, device), \
                _c64_field(torch, lev.shape, rng, device)
            lo = tuple(1e-7 * t
                       for t in _c64_field(torch, lev.shape, rng, device))
            rk = ctx.residual_ds(hi, lo, s0)
            rp = dsres.residual_ds_plain(hi, lo, s0, lev.arrays,
                                         ctx._ds_params)
            _sync(torch)
            own = lev.slab.owned_view
            d = max(float((own(a, c) - own(b, c)).abs().max())
                    for c, (a, b) in enumerate(zip(rk, rp)))
            m = max(float(own(b, c).abs().max()) for c, b in enumerate(rp))
            out.append({'level': lvl, 'slab': list(lev.shape),
                        'kernel': 'residual_ds', 'max_abs_err': d,
                        'rel': d / m})
    return out


def _slab_line_checks_c64(torch, problem, opts, rank, device='cuda'):
    """K3, K4 and K5's complex64 instances against their plain versions
    on this rank's slabs of the two finest levels of the complex64 sc+lr
    solve's first hierarchy, lines along each axis (within the rank, or
    a Schur segment: K5 and K4 with ``stations``), by
    :func:`_check_c64` against the float64 evaluation of the same float32
    inputs: K5's stack, K3 of every colour (K3's own checks:
    :func:`_residual_triple`), K4 of every colour on the kernel's stack.
    Returns one record per level and axis."""
    from emg3d_tpu_torch import VolumeModel, solver
    from emg3d_tpu_torch.ops import line_gs, stencil
    from emg3d_tpu_torch.parallel import lines
    grid, model, sfield = problem
    var = solver.MGParameters(verb=0, cycle='F', sslsolver=False,
                              shape_cells=tuple(grid.shape_cells), **SCLR)
    ctx = solver._SolveContext(grid, VolumeModel(grid, model, sfield),
                               sfield, sfield, var, device,
                               solver._normalize_sharding(opts))
    rng = np.random.default_rng(400 + rank)
    out = []
    for lvl, lev in enumerate(ctx.levels(int(var.sc_dir))[:2]):
        slab = lev.slab
        if slab is None:
            continue
        for ax in range(3):
            split = slab.split(ax)
            if split and not slab.line_supported(ax):
                continue
            if split:
                st = lines.schur_state(lev, ax)
                state, sub, ns, fk = st.slab, st.sub, st.stations, st.fac
            else:
                state = line_gs.line_state(lev.arrays, lev.shape, ax)
                sub, ns, fk = state, state.shape[0], state.factors
            with _plain():
                fp = line_gs.segment_stack(sub, ns)
                f64 = line_gs.segment_stack(_upcast_state(sub), ns)
            _sync(torch)
            name = f"rank {rank} level {lvl} {'xyz'[ax]}-lines"
            rec = {'level': lvl, 'slab': list(lev.shape), 'axis': ax,
                   'lines': 'schur' if split else 'within',
                   'stations': ns, 'nx': sub.shape[0]}
            rec['line_factor'] = _check_c64(
                f"line_factor {name}", lev.shape, [((fk,), (fp,), (f64,))])
            del fp, f64
            L = state.shape[0]
            er, sr = _c64_field(torch, state.shape, rng, device), \
                _c64_field(torch, state.shape, rng, device)
            st64 = _upcast_state(state)
            rec['line_residual'] = _check_c64(
                f"line_residual {name}", lev.shape,
                [_residual_triple(torch, state, st64, er, sr, c)
                 for c in range(4)])
            rp = stencil.residual_parts(*sr, *er, *state.arrays)
            rs = rp if not split else (rp[0][1:], rp[1][1:L + 1],
                                       rp[2][1:L + 1])
            e0 = er if not split else (er[0][1:], er[1][1:L + 1],
                                       er[2][1:L + 1])
            triples = []
            for c in range(4):
                ek, ep, ex = _clone(e0), _clone(e0), _up(e0)
                line_gs.thomas(ek, rs, fk, sub, c, stations=ns)
                line_gs.thomas_plain(ep, rs, fk, c, stations=ns)
                line_gs.thomas_plain(ex, _up(rs), _up(fk), c, stations=ns)
                triples.append((ek, ep, ex))
            _sync(torch)
            rec['line_thomas'] = _check_c64(f"line_thomas {name}",
                                            lev.shape, triples)
            for k in LINE_KERNELS:
                dmax, worst = rec[k]
                rec[k] = {'max_abs_err': dmax, **worst}
            out.append(rec)
    return out


def _shard_rank(rank, world, port, job, out_dir):
    """One rank of a phase 17 job: a process on card 0, gloo between the
    ranks (the transport of ranks sharing one card, not a fallback: NCCL
    refuses two ranks on it); holds the kernels to plain on its slabs
    (their complex64 instances and K6 too where the job has complex64
    cases), solves each case of the job twice and writes the case's
    counts (and rank 0 the field) into ``out_dir``.  A kernel that does
    not build, launch or agree raises, and the job fails."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from emg3d_tpu_torch import parallel, solver
    from emg3d_tpu_torch.ops import dsres, line_gs, point_gs
    from emg3d_tpu_torch.parallel import distributed, halo, lines
    torch.cuda.set_device(0)
    distributed.init(f'127.0.0.1:{port}', world, rank, backend='gloo')
    try:
        _, axes, cases = SHARD_JOBS[job]
        problem = _shard_problem(cases[0])
        opts = parallel.shard_solve_options(parallel.make_mesh(axes=axes))
        checks = {'point': _slab_checks(torch, problem, opts, rank),
                  'line': _slab_line_checks(torch, problem, opts, rank)}
        c64 = [c for c in cases if c in C64_SHARD_CASES]
        if c64:
            p64 = _shard_problem(c64[0])
            checks['point_c64'] = _slab_checks_c64(torch, p64, opts, rank)
            checks['line_c64'] = _slab_line_checks_c64(torch, p64, opts,
                                                       rank)
        out = Path(out_dir)
        for case in cases:
            kw = _case_opts(case)
            runs = []
            # complex64: float32 storage, as the unsharded references.
            solver.BF16_STORAGE = False if case in c64 else None
            for _ in range(2):
                point_gs.reset_launches()
                line_gs.reset_launches()
                dsres.reset_launches()
                halo.reset_sends()
                lines.reset_gathered()
                e, info, wall = _solve(torch, *_shard_problem(case),
                                       sharding=opts, **kw)
                runs.append({'wall': wall, 'it_mg': info['it_mg'],
                             'it_ssl': info['it_ssl'],
                             'exit': info['exit_message'],
                             'rel_error': info['rel_error'],
                             'launches': _launch_counts(),
                             'steps': dict(point_gs.STEPS),
                             'sends': dict(halo.SENDS),
                             'gathered': [[list(k[0]), k[1], n] for k, n in
                                          sorted(lines.GATHERED.items())]})
            solver.BF16_STORAGE = None
            if rank == 0:
                np.savez(out / f'{case}.npz', fx=e.fx, fy=e.fy, fz=e.fz)
            key = ('line' if kw.get('linerelaxation') else 'point') + \
                ('_c64' if case in c64 else '')
            (out / f'{case}_rank{rank}.json').write_text(json.dumps(
                {'runs': runs, 'checks': checks[key]}))
    finally:
        distributed.shutdown()


def phase_sharded(torch, e4, info4, sclr_refs, c64_refs, out_dir):
    """Phase 17 (see the module docstring).  Returns K1-K5's
    ``launches_sharded`` and their largest max|Δ| on the ranks' slabs,
    and K1-K6's ``launches_sharded_c64`` and largest max|Δ| of their
    complex64 instances on the slabs (``c64_refs``: phase 15's)."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from emg3d_tpu_torch import parallel, solver
    from emg3d_tpu_torch.ops import line_gs, point_gs
    from emg3d_tpu_torch.parallel import distributed, halo, lines
    counts = {k: {} for k in POINT_MODES + LINE_KERNELS}
    errs = {k: 0.0 for k in POINT_MODES + LINE_KERNELS}
    k6 = ('residual_ds',)
    c64_counts = {k: {} for k in POINT_MODES + LINE_KERNELS + k6}
    c64_errs = {k: 0.0 for k in POINT_MODES + LINE_KERNELS + k6}
    grid, model, sfield = bench_problem()

    distributed.init(f'127.0.0.1:{_free_port()}', 1, 0)
    try:
        log(f"world size {dist.get_world_size()}, backend "
            f"{dist.get_backend()}")
        opts = parallel.shard_solve_options(parallel.make_mesh(1))
        walls = []
        for run in ('cold', 'warm'):
            point_gs.reset_launches()
            halo.reset_sends()
            e1, info1, wall1 = _solve(torch, grid, model, sfield,
                                      sharding=opts)
            walls.append(wall1)
            rel = _rel(e1, e4)
            log(f"bench64, world size 1, NCCL, {run}: it_mg "
                f"{info1['it_mg']}, wall {wall1:.3f} s, |Δ|/|e| vs phase 4 "
                f"{rel:.3e}, launches {dict(point_gs.LAUNCHES)}, colour "
                f"steps {dict(point_gs.STEPS)}, halo messages "
                f"{dict(halo.SENDS)}")
            if info1['it_mg'] != info4['it_mg'] or not rel <= TOL_SHARD_WS1:
                raise AssertionError("the world-size-1 sharded solve "
                                     "differs from phase 4's")
            if min(point_gs.LAUNCHES.values()) == 0:
                raise AssertionError("the world-size-1 sharded solve did not "
                                     f"launch both point kernels: "
                                     f"{dict(point_gs.LAUNCHES)}")
        for k in POINT_MODES:
            counts[k]['bench64_ws1_nccl'] = point_gs.LAUNCHES[k]
        del e1
        # sclr64 standalone: every line within the one rank, the
        # kernels of phase 7's solve on the same levels.
        e7, info7 = sclr_refs['standalone']
        for run in ('cold', 'warm'):
            point_gs.reset_launches()
            line_gs.reset_launches()
            halo.reset_sends()
            lines.reset_gathered()
            e1, info1, wall1 = _solve(torch, grid, model, sfield,
                                      sharding=opts, **SCLR)
            rel = _rel(e1, e7)
            log(f"sclr64, world size 1, NCCL, {run}: it_mg "
                f"{info1['it_mg']} (phase 7 {info7['it_mg']}), wall "
                f"{wall1:.3f} s, |Δ|/|e| vs phase 7 {rel:.3e}, launches "
                f"{dict(line_gs.LAUNCHES)} and {dict(point_gs.LAUNCHES)}, "
                f"messages {dict(halo.SENDS)}, gathered levels "
                f"{dict(lines.GATHERED)}")
            if info1['it_mg'] != info7['it_mg'] or \
                    not rel <= TOL_SHARD_WS1_SCLR:
                raise AssertionError("the world-size-1 sharded sclr64 solve "
                                     "differs from phase 7's")
            if min(line_gs.LAUNCHES.values()) == 0:
                raise AssertionError("the world-size-1 sclr64 solve did not "
                                     f"launch K3-K5: "
                                     f"{dict(line_gs.LAUNCHES)}")
        for k in LINE_KERNELS:
            counts[k]['sclr64_ws1_nccl'] = line_gs.LAUNCHES[k]
        del e1
        # sclr64 BiCGSTAB: the Krylov norms and inner products of the
        # slab, all_reduces of CUDA tensors through NCCL.
        e7, info7 = sclr_refs['bicgstab']
        halo.reset_sends()
        e1, info1, wall1 = _solve(torch, grid, model, sfield, sharding=opts,
                                  sslsolver=True, **SCLR)
        rel = _rel(e1, e7)
        log(f"sclr64 BiCGSTAB, world size 1, NCCL, cold: it_mg "
            f"{info1['it_mg']}, it_ssl {info1['it_ssl']} (phase 7 "
            f"{info7['it_mg']}, {info7['it_ssl']}), wall {wall1:.3f} s, "
            f"|Δ|/|e| vs phase 7 {rel:.3e}, messages {dict(halo.SENDS)}")
        if (info1['it_mg'], info1['it_ssl']) != (
                info7['it_mg'], info7['it_ssl']) or \
                not rel <= TOL_SHARD_WS1_SCLR:
            raise AssertionError("the world-size-1 sharded sclr64 BiCGSTAB "
                                 "solve differs from phase 7's")
        if halo.SENDS['sums'] == 0:
            raise AssertionError("the world-size-1 BiCGSTAB solve made no "
                                 "all_reduce")
        del e1
        _sharded_c64_ws1(torch, opts, c64_refs, c64_counts)
    finally:
        distributed.shutdown()

    # The unsharded solves of the same problems, warm, for the walls
    # (complex64 with float32 storage).
    refs = {}
    for _, _, cases in SHARD_JOBS.values():
        for case in cases:
            solver.BF16_STORAGE = False if case in C64_SHARD_CASES \
                else None
            try:
                if case not in LINE_SHARD_CASES:
                    _solve(torch, *_shard_problem(case))
                refs[case] = _solve(torch, *_shard_problem(case),
                                    **_case_opts(case))
            finally:
                solver.BF16_STORAGE = None
    log(f"unsharded, warm: bench64 {refs['bench64_z2'][2]:.3f} s, "
        f"world size 1 sharded {walls[1]:.3f} s; sclr64 "
        f"{refs['sclr64_z2'][2]:.3f} s, tri64x48x40 sc+lr "
        f"{refs['tri64x48x40_sclr_yz4'][2]:.3f} s, sclr64 BiCGSTAB "
        f"{refs['sclr64_bicgstab_z2'][2]:.3f} s; complex64 bench64 "
        f"{refs['bench64_c64_z2'][2]:.3f} s, sclr64 BiCGSTAB "
        f"{refs['sclr64_bicgstab_c64_z2'][2]:.3f} s ({nvidia_smi()})")
    c128 = {'bench64_c64_z2': e4,
            'sclr64_bicgstab_c64_z2': sclr_refs['bicgstab'][0]}

    jobs = {}
    for name, (n, axes, cases) in SHARD_JOBS.items():
        t0 = time.perf_counter()
        mp.start_processes(_shard_rank, args=(n, _free_port(), name,
                                              str(out_dir)),
                           nprocs=n, start_method='spawn')
        jobs[name] = time.perf_counter() - t0
        log(f"job {name} ({n} ranks, {axes}, gloo: {', '.join(cases)}): "
            f"spawn, init, checks and two solves of each case "
            f"{jobs[name]:.2f} s ({nvidia_smi()}; ranks sharing one card, "
            f"messages staged through the host by gloo)")
    for name, (n, axes, cases) in SHARD_JOBS.items():
        for case in cases:
            if case in C64_SHARD_CASES:
                _check_sharded_c64(case, n, axes, refs[case], c128[case],
                                   out_dir, c64_counts, c64_errs)
            else:
                _check_sharded_case(case, n, axes, refs[case], out_dir,
                                    counts, errs)
    return counts, errs, c64_counts, c64_errs


def _sharded_c64_ws1(torch, opts, c64_refs, counts):
    """Phase 17's complex64 solves at world size 1 on NCCL: bench64 and
    sclr64 BiCGSTAB with float32 storage against phase 15's (the same
    exit, it_mg and it_ssl; the field logged against phase 15's, bitwise
    predicted), sclr256 standalone (peak memory and wall beside phase
    15's), then sclr64 standalone with the card's default storage: every
    state of a level on a slab in float32, bfloat16 (and its launches)
    only on the replicated levels.  Adds each kernel's launches to
    ``counts``."""
    from emg3d_tpu_torch import solver
    from emg3d_tpu_torch.ops import line_gs, point_gs
    grid, model, sfield = bench_problem()
    src = _c64_source(sfield)
    solver.BF16_STORAGE = False
    try:
        for name, kw in (('bench64', {}),
                         ('sclr64 bicgstab', dict(SCLR, sslsolver=True))):
            ec, ic = c64_refs[name]
            n = {}
            with _Counted(n):
                e1, i1, w1 = _solve(torch, grid, model, src, sharding=opts,
                                    **kw)
            rel = _rel(e1, ec)
            log(f"{name} complex64, world size 1, NCCL, float32 storage: "
                f"{i1['exit_message']}, it_mg {i1['it_mg']}, it_ssl "
                f"{i1['it_ssl']} (phase 15 {ic['it_mg']}, {ic['it_ssl']}), "
                f"rel_error {i1['rel_error']:.3e}, returned "
                f"{e1.field.dtype}, wall {w1:.3f} s, |Δ|/|e| against phase "
                f"15 {rel:.3e}, launches {n}")
            if (i1['exit_message'], i1['it_mg'], i1['it_ssl']) != (
                    ic['exit_message'], ic['it_mg'], ic['it_ssl']) or \
                    e1.field.dtype != np.complex128 or \
                    not rel <= TOL_C64_FIELD:
                raise AssertionError(f"{name} complex64 at world size 1 "
                                     "differs from phase 15's")
            if n['residual_ds'] == 0:
                raise AssertionError(f"{name} complex64 at world size 1 "
                                     "launched no K6")
            for k, v in n.items():
                counts[k][name.replace(' ', '_') + '_c64_ws1_nccl'] = v
            del e1
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        g256, m256, s256 = bench_problem((256,) * 3)
        n = {}
        with _Counted(n):
            e256, i256, w256 = _solve(torch, g256, m256,
                                      _c64_source(s256), sharding=opts,
                                      **SCLR)
        del e256
        peak = torch.cuda.max_memory_allocated() / 2**30
        ref = c64_refs['sclr256']
        log(f"sclr256 complex64, world size 1, NCCL, float32 storage: "
            f"{i256['exit_message']}, it_mg {i256['it_mg']} (phase 15 "
            f"{ref['it_mg']}), rel_error {i256['rel_error']:.3e}, wall "
            f"{w256:.3f} s (phase 15 {ref['wall']:.3f} s), peak device "
            f"memory {peak:.2f} GiB (phase 15 {ref['peak']:.2f} GiB), "
            f"launches {n} ({nvidia_smi()})")
        if not i256['rel_error'] < 1e-6 or i256['it_mg'] != ref['it_mg']:
            raise AssertionError("sclr256 complex64 at world size 1")
        for k, v in n.items():
            counts[k]['sclr256_c64_ws1_nccl'] = v
        del g256, m256, s256
        torch.cuda.empty_cache()
    finally:
        solver.BF16_STORAGE = None
    # The card's default storage: bfloat16 where a level has no slab.
    seen = set()

    def spy(fn):
        def run(lev, *args, **kw):
            state = fn(lev, *args, **kw)
            seen.add((lev.slab is not None, str(state.storage),
                      str(getattr(state, 'fstorage', None))))
            return state
        return run
    real = solver._level_state, solver._line_state
    solver._level_state, solver._line_state = map(spy, real)
    point_gs.reset_launches()
    line_gs.reset_launches()
    try:
        _, info, wall = _solve(torch, grid, model, src, sharding=opts,
                               **SCLR)
    finally:
        solver._level_state, solver._line_state = real
    bf16 = {**point_gs.BF16_LAUNCHES, **line_gs.BF16_LAUNCHES}
    log(f"sclr64 complex64, world size 1, default storage: it_mg "
        f"{info['it_mg']}, wall {wall:.3f} s; states (on a slab, stream "
        f"storage, stack storage): {sorted(seen)}; bfloat16 launches "
        f"{bf16}")
    if any(on and (st != 'None' or fs != 'None') for on, st, fs in seen):
        raise AssertionError("a level on a slab stored in bfloat16")
    if sum(bf16.values()) and not any(not on and st != 'None'
                                      for on, st, _ in seen):
        raise AssertionError("bfloat16 launches without a bfloat16 state "
                             "of a replicated level")


def _check_sharded_c64(case, n, axes, ref_solve, e128, out_dir, counts,
                       errs):
    """Read, log and check one complex64 phase 17 case's ranks: every
    run CONVERGED with the unsharded complex64 solve's it_mg and it_ssl
    ±1 and rel_error < 1e-6, the gathered hi + lo (complex128) within
    TOL_C64_FIELD of the unsharded complex64 field and of the complex128
    one, every rank launched K6 and the case's kernels, and each rank's
    slab checks (K1-K5 by :func:`_check_c64`'s rule, K6 within TOL_DS).
    Adds the launches and kernel errors to ``counts`` and ``errs``."""
    from emg3d_tpu_torch import Field
    line = bool(_case_opts(case).get('linerelaxation'))
    kernels = LINE_KERNELS if line else POINT_MODES
    ref, iref, wref = ref_solve
    f = np.load(out_dir / f'{case}.npz')
    got = Field(f['fx'], f['fy'], f['fz'])
    rel, rel128 = _rel(got, ref), _rel(got, e128)
    recs = [json.loads((out_dir / f'{case}_rank{r}.json').read_text())
            for r in range(n)]
    for r, rec in enumerate(recs):
        for chk in rec['checks']:
            where = (f"{case} rank {r}, level {chk['level']} slab "
                     f"{'x'.join(map(str, chk['slab']))}")
            if line:
                where += f", {'xyz'[chk['axis']]}-lines {chk['lines']}"
            found = [(k, chk[k]) for k in LINE_KERNELS] if line else \
                [(chk['kernel'], chk)]
            for k, c in found:
                if k == 'residual_ds':
                    log(f"{where}: {DSRES['name']} (ctx.residual_ds) vs "
                        f"plain on the owned edges, max|Δ| "
                        f"{c['max_abs_err']:.3e}, max|Δ|/max|r| "
                        f"{c['rel']:.3e}")
                    ok = c['rel'] <= TOL_DS
                else:
                    limit = max(TOL_C64, 2 * c['plain_f64'])
                    log(f"{where}: {KERNELS[k]['name']} complex64 against "
                        f"float64 {c['kernel_f64']:.3e}, plain against "
                        f"float64 {c['plain_f64']:.3e}, kernel against plain "
                        f"{c['kernel_plain']:.3e} (limit {limit:.3e})")
                    ok = c['kernel_f64'] <= limit and \
                        c['kernel_plain'] <= limit
                if not ok:
                    raise AssertionError(f"{where}: {k} complex64 differs "
                                         f"from plain")
                errs[k] = max(errs[k], c['max_abs_err'])
    for r, rec in enumerate(recs):
        for run, x in zip(('cold', 'warm'), rec['runs']):
            log(f"{case} ({axes}, gloo), rank {r}, {run}: {x['exit']}, "
                f"it_mg {x['it_mg']}, it_ssl {x['it_ssl']} (unsharded "
                f"{iref['it_mg']}, {iref['it_ssl']}), rel_error "
                f"{x['rel_error']:.3e}, wall {x['wall']:.3f} s, launches "
                f"{x['launches']}, messages {x['sends']}, gathered levels "
                f"{x['gathered']}")
            if x['exit'] != 'CONVERGED' or not x['rel_error'] < 1e-6 or \
                    abs(x['it_mg'] - iref['it_mg']) > 1 or \
                    abs(x['it_ssl'] - iref['it_ssl']) > 1:
                raise AssertionError(f"{case} rank {r}: {x['exit']}, "
                                     f"it_mg/it_ssl {x['it_mg']}/"
                                     f"{x['it_ssl']}")
            if x['launches']['residual_ds'] == 0 or \
                    (line and min(x['launches'][k] for k in kernels) == 0) \
                    or sum(x['launches'][k] for k in kernels) == 0:
                raise AssertionError(f"{case}: rank {r} did not launch K6 "
                                     f"and its kernels: {x['launches']}")
    log(f"{case}: returned {got.field.dtype}, |Δ|/|e| against the "
        f"unsharded complex64 solve {rel:.3e}, against complex128 "
        f"{rel128:.3e}; warm walls per rank "
        f"{[rec['runs'][1]['wall'] for rec in recs]} s beside the "
        f"unsharded {wref:.3f} s")
    if got.field.dtype != np.complex128 or not (
            rel <= TOL_C64_FIELD and rel128 <= TOL_C64_FIELD):
        raise AssertionError(f"{case}: the sharded complex64 field differs")
    for k in kernels + ('residual_ds',):
        counts[k][case + '_gloo'] = [[rec['runs'][0]['launches'][k],
                                      rec['runs'][1]['launches'][k]]
                                     for rec in recs]


def _check_sharded_case(case, n, axes, ref_solve, out_dir, counts, errs):
    """Read, log and check one phase 17 case's ranks (see
    :func:`phase_sharded`); adds its launches and kernel errors to
    ``counts`` and ``errs``."""
    from emg3d_tpu_torch import Field
    kw = _case_opts(case)
    line = bool(kw.get('linerelaxation'))
    kernels = LINE_KERNELS if line else POINT_MODES
    ref, iref, wref = ref_solve
    f = np.load(out_dir / f'{case}.npz')
    rel = _rel(Field(f['fx'], f['fy'], f['fz']), ref)
    recs = [json.loads((out_dir / f'{case}_rank{r}.json').read_text())
            for r in range(n)]
    ranks = [rec['runs'] for rec in recs]
    for r, rec in enumerate(recs):
        for chk in rec['checks']:
            if line:
                for k in LINE_KERNELS:
                    log(f"{case} rank {r}, level {chk['level']} slab "
                        f"{'x'.join(map(str, chk['slab']))}, "
                        f"{'xyz'[chk['axis']]}-lines {chk['lines']} "
                        f"({chk['stations']} of {chk['nx']} stations): "
                        f"{KERNELS[k]['name']} vs plain, max|Δ| "
                        f"{chk[k]['max_abs_err']:.3e}, max|Δ|/max|plain| "
                        f"{chk[k]['rel']:.3e}")
                    if not chk[k]['rel'] <= TOL_KERNEL:
                        raise AssertionError(
                            f"{case} rank {r}: {k} on the level "
                            f"{chk['level']} slab differs from plain")
                    errs[k] = max(errs[k], chk[k]['max_abs_err'])
                continue
            log(f"{case} rank {r}, level {chk['level']} slab "
                f"{'x'.join(map(str, chk['slab']))} (the solve runs "
                f"{KERNELS[chk['solve_kernel']]['name']}): "
                f"{KERNELS[chk['kernel']]['name']} vs plain, each "
                f"colour step alone, max|Δ| {chk['max_abs_err']:.3e}, "
                f"max|Δ|/max|e| {chk['rel']:.3e}")
            if not chk['rel'] <= TOL_KERNEL:
                raise AssertionError(
                    f"{case} rank {r}: {chk['kernel']} on the level "
                    f"{chk['level']} slab differs from plain")
            errs[chk['kernel']] = max(errs[chk['kernel']],
                                      chk['max_abs_err'])
    for r, runs in enumerate(ranks):
        for run, rec in zip(('cold', 'warm'), runs):
            log(f"{case} ({axes}, gloo), rank {r}, {run}: "
                f"{rec['exit']}, it_mg {rec['it_mg']}, it_ssl "
                f"{rec['it_ssl']}, wall {rec['wall']:.3f} s, launches "
                f"{rec['launches']}, colour steps {rec['steps']}, "
                f"messages {rec['sends']}, gathered levels "
                f"{rec['gathered']}")
            if (rec['it_mg'], rec['it_ssl']) != (iref['it_mg'],
                                                 iref['it_ssl']):
                raise AssertionError(
                    f"{case}: it_mg/it_ssl {rec['it_mg']}/"
                    f"{rec['it_ssl']}, unsharded {iref['it_mg']}/"
                    f"{iref['it_ssl']}")
            if line and min(rec['launches'][k]
                            for k in LINE_KERNELS) == 0:
                raise AssertionError(f"{case}: rank {r} did not launch "
                                     f"K3-K5: {rec['launches']}")
            if sum(rec['launches'][k] for k in kernels) == 0:
                raise AssertionError(f"{case}: rank {r} launched no "
                                     "point kernel")
    log(f"{case}: |Δ|/|e| vs the unsharded solve {rel:.3e}; warm walls "
        f"per rank {[runs[1]['wall'] for runs in ranks]} s beside the "
        f"unsharded {wref:.3f} s")
    if not rel <= TOL_SHARD:
        raise AssertionError(f"{case}: the sharded field differs")
    for k in kernels:
        counts[k][case + '_gloo'] = [[runs[0]['launches'][k],
                                      runs[1]['launches'][k]]
                                     for runs in ranks]


# ----------------------------------------------------------------------
# Phase 18: the x64 switch off
# ----------------------------------------------------------------------

def _x64_run(torch, sim):
    """``compute()`` and ``gradient`` of ``sim`` from scratch: (compute
    wall, gradient wall, peak device GiB), host walls ending in a
    synchronize."""
    sim.clean('computed')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.compute()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim.gradient
    torch.cuda.synchronize()
    return (t1 - t0, time.perf_counter() - t1,
            torch.cuda.max_memory_allocated() / 2**30)


def _x64_values(sim):
    """(responses, misfit, gradient) of a computed Simulation."""
    return (np.array(sim.data.synthetic), float(sim.misfit),
            np.array(sim.gradient))


def _bf16_instances():
    """The launches of K1-K5's ``_bf16`` instances."""
    from emg3d_tpu_torch.ops import line_gs, point_gs
    return {**point_gs.BF16_LAUNCHES, **line_gs.BF16_LAUNCHES}


def _finite_rel(a, b):
    """max|a − b| / max|b| over b's finite entries (a finite there)."""
    fin = np.isfinite(b)
    if not (fin.any() and np.array_equal(np.isfinite(a), fin)):
        raise AssertionError("non-finite values differ")
    return float(np.max(np.abs(a[fin] - b[fin])) / np.max(np.abs(b[fin])))


def _x64_sim(torch, survey, ref10, fields15, counts, bf16, n=64,
             device='cuda'):
    """Phase 18a: sim64 through ``Simulation`` with the switch off (see
    the module docstring; ``n`` cells a side on ``device``).  Adds its
    launches to ``counts`` and ``bf16``."""
    from emg3d_tpu_torch import dtypes, solve_batched
    grid, model, _ = simulation_problem(n)
    pairs = [(s, f) for s in survey.sources for f in SIM_FREQS]
    sims = {k: _sim(torch, grid, model, survey.copy(), device=device)
            for k in ('c128', 'c64')}

    walls = {'c128': [], 'c64': []}
    cold = None
    runs = ['c128', 'c64'] + ['c64', 'c128'] * C64_PAIRS
    for i, run in enumerate(runs):
        if run == 'c64':
            with _Counted(counts), _Counted(bf16, _bf16_instances), \
                    dtypes.x64(False):
                w = _x64_run(torch, sims[run])
        else:
            w = _x64_run(torch, sims[run])
        if i == 1:
            cold = w
            sim = sims['c64']
            efs = [sim.get_efield(*p) for p in pairs]
            einfo = [sim.get_efield_info(*p) for p in pairs]
            binfo = [sim._dict_bfield_info[s][f] for s, f in pairs]
            got = _x64_values(sim)
            with dtypes.x64(False):
                rfs = [sim._get_rfield(*p) for p in pairs]
        else:
            walls[run].append(w)
    med = {k: [float(np.median([w[j] for w in v])) for j in range(3)]
           for k, v in walls.items()}
    log(f"sim64 x64 off, cold compute() {cold[0]:.3f} s, gradient "
        f"{cold[1]:.3f} s; in turns (compute, gradient, peak GiB): "
        f"complex128 {[tuple(round(x, 3) for x in w) for w in walls['c128']]}"
        f", x64 off {[tuple(round(x, 3) for x in w) for w in walls['c64']]}"
        f"; medians complex128 compute {med['c128'][0]:.3f} s, gradient "
        f"{med['c128'][1]:.3f} s, peak {med['c128'][2]:.2f} GiB; x64 off "
        f"compute {med['c64'][0]:.3f} s ({med['c64'][0] / med['c128'][0]:.2f}"
        f"×), gradient {med['c64'][1]:.3f} s "
        f"({med['c64'][1] / med['c128'][1]:.2f}×), peak {med['c64'][2]:.2f} "
        f"GiB")

    # Every forward and adjoint lane CONVERGED, in the two-float dtype.
    for what, infos in (('forward', einfo), ('adjoint', binfo)):
        log(f"sim64 x64 off {what}: {infos[0]['exit_message']}, it_mg "
            f"{infos[0]['it_mg']}, it_ssl {infos[0]['it_ssl']}, rel_error "
            f"max {max(i['rel_error'] for i in infos):.3e}")
        if not all(i['exit_message'] == 'CONVERGED' and i['rel_error']
                   < SIM_TOL for i in infos):
            raise AssertionError(f"sim64 x64 off: a {what} lane did not "
                                 f"converge")
    if not all(ef.field.dtype == np.complex128 for ef in efs):
        raise AssertionError("sim64 x64 off: fields not hi + lo")
    # The adjoint sources (conj(w·r)/sμ0): float32 ranges, before and
    # after the unit-norm scaling of the batched Krylov lanes.
    amin, amax, smin = np.inf, 0.0, np.inf
    for rf in rfs:
        a = np.abs(rf.field)
        nz = a[a > 0]
        amin, amax = min(amin, nz.min()), max(amax, nz.max())
        smin = min(smin, nz.min() / float(rf.norm()))
    log(f"sim64 x64 off adjoint sources: {rfs[0].field.dtype}, smallest "
        f"nonzero |rfield| {amin:.3e}, largest {amax:.3e}; smallest "
        f"nonzero after the unit-norm scaling {smin:.3e} (float32 "
        f"smallest normal {np.finfo(np.float32).tiny:.3e})")
    if not (np.isfinite(amax) and smin > np.finfo(np.float32).tiny):
        raise AssertionError("sim64 x64 off: adjoint sources out of "
                             "float32 range")

    # The forward fields: the same solve called directly (bitwise), and
    # phase 15's solve of the hand-cast complex64 sources.
    opts = {k: v for k, v in sims['c64'].solver_opts.items()
            if k not in ('sslsolver', 'return_info', 'log')}
    opts['sslsolver'] = 'bicgstab'
    sf128 = [sims['c64'].get_sfield(*p) for p in pairs]
    with _Counted(counts), _Counted(bf16, _bf16_instances), \
            dtypes.x64(False):
        direct, _ = solve_batched(grid, model, sf128, **opts)
    same = [all(np.array_equal(a.field, b.field) for a, b in zip(efs, o))
            for o in (direct, fields15)]
    rel_d = max(_rel(a, b) for a, b in zip(efs, direct))
    rel15 = max(_rel(a, b) for a, b in zip(efs, fields15))
    # The only input that differs from phase 15's: each lane's norm, here
    # the complex128 source's, there the cast one's (it judges
    # convergence, and its float32 inverse scales the Krylov lanes).
    refe = max(abs(float(sf.norm()) - float(_c64_source(sf).norm()))
               / float(sf.norm()) for sf in sf128)
    log(f"sim64 x64 off fields: against solve_batched of the same "
        f"complex128 sources with the switch off bitwise {same[0]} (max "
        f"|Δ|/|e| {rel_d:.3e}); against phase 15's hand-cast complex64 "
        f"sources bitwise {same[1]} (max |Δ|/|e| {rel15:.3e}; the lanes' "
        f"norms differ by up to {refe:.3e} relative)")
    if not (rel_d <= TOL_SOLVE and rel15 <= TOL_C64_FIELD):
        raise AssertionError("sim64 x64 off: fields differ")

    # Responses, misfit and gradient against phase 10's complex128 ones.
    # Both solves stop at tol 1e-6; the bound is phase 10's own distance
    # from a complex128 Simulation at tol 1e-10 (what tol 1e-6 allows
    # it) plus TOL_C64_FIELD (complex64 against complex128).  That
    # distance must itself be small (TOL_X64_REF): else phase 10's values
    # do not belong to this survey's observed data.
    sref = _sim(torch, grid, model, survey.copy(), tol=1e-10,
                device=device)
    _x64_run(torch, sref)
    acc = _x64_values(sref)
    for name, a, b, c in zip(('responses', 'misfit', 'gradient'), got,
                             ref10, acc):
        a, b, c = (np.atleast_1d(np.asarray(x)) for x in (a, b, c))
        d, d10, d64 = _finite_rel(a, b), _finite_rel(b, c), \
            _finite_rel(a, c)
        log(f"sim64 x64 off {name}: against phase 10's complex128 "
            f"{d:.3e} (bound {d10 + TOL_C64_FIELD:.3e}: phase 10's own "
            f"distance from tol 1e-10, {d10:.3e}, + {TOL_C64_FIELD}); "
            f"against tol 1e-10 {d64:.3e}"
            + (f"; x64 off {float(a[0]):.9e}, complex128 {float(b[0]):.9e}"
               if name == 'misfit' else ''))
        if not d10 <= TOL_X64_REF:
            raise AssertionError(f"sim64 x64 off: phase 10's {name} is "
                                 f"not this survey's")
        if not d <= d10 + TOL_C64_FIELD:
            raise AssertionError(f"sim64 x64 off: {name} beyond its bound")
    return {'compute': med, 'cold': cold}


def _x64_diff(torch, grad12, counts, bf16, n=64, device='cuda'):
    """Phase 18b: diff64's point gradient with the switch off (``n``
    cells a side on ``device``)."""
    from emg3d_tpu_torch import diff, dtypes, solver
    from emg3d_tpu_torch.ops import dsres
    grid, s, w, sig = diff_problem(torch, n, device)

    with dtypes.x64(False):
        s = tuple(c.to(torch.complex64) for c in s)
        w = [(c, t.float()) for c, t in w]
        sig = sig.float()
        fsolve = diff.make_differentiable_solve(grid, 1.0, tol=1e-10,
                                                device=device)

        def field(sigma, src):
            eta, zeta = diff.eta_zeta_from_sigma(grid, sigma, 1.0)
            return fsolve((eta, eta, eta, zeta), src)
        d_obs = diff.sample_edges(field(sig, s), w).detach()
        x = torch.zeros_like(sig).requires_grad_(True)
        src = tuple(t.clone().requires_grad_(True) for t in s)
        k0 = dsres.LAUNCHES['residual_ds']
        with _Counted(counts), _Counted(bf16, _bf16_instances), Clock(
                solver, 'solve', record=lambda out: (
                    out[1]['exit_message'], out[1]['it_mg'],
                    out[1]['it_ssl'], dsres.LAUNCHES['residual_ds'])) \
                as clock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e = field(torch.exp(x), src)
            loss = 0.5 * torch.sum((diff.sample_edges(e, w) - d_obs).abs()
                                   ** 2)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            gx, *lam = torch.autograd.grad(loss, (x, *src))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    k6 = np.diff([k0] + [r[3] for r in clock.records]).tolist()
    rel = float((gx.double().cpu() - grad12).abs().max()
                / grad12.abs().max())
    log(f"diff64 x64 off (point, tol 1e-10): field {e[0].dtype}, λ "
        f"{lam[0].dtype}, gradient {gx.dtype}; forward {t1 - t0:.3f} s, "
        f"backward {t2 - t1:.3f} s; (exit, it_mg, it_ssl) per solve "
        f"{[r[:3] for r in clock.records]}, K6 launches per solve {k6}; "
        f"gradient against phase 12's complex128 max|Δ|/max|ref| {rel:.3e} "
        f"(bound TOL_C64_FIELD {TOL_C64_FIELD})")
    if not (all(c.dtype == torch.complex64 for c in (*e, *lam))
            and gx.dtype == torch.float32):
        raise AssertionError("diff64 x64 off: not complex64")
    if not (all(r[0] == 'CONVERGED' for r in clock.records)
            and len(k6) == 2 and min(k6) > 0):
        raise AssertionError("diff64 x64 off: a solve did not converge or "
                             "ran no K6")
    if not rel <= TOL_C64_FIELD:
        raise AssertionError("diff64 x64 off: gradient beyond its bound")
    return k6


def phase_x64_off(torch, ref10, fields15, grad12, n=64, device='cuda'):
    """Phase 18 (see the module docstring; ``n`` cells a side on
    ``device``).  Returns the launches of the runs with the switch off
    (every instance; the ``_bf16`` ones apart) and the walls."""
    counts = {k: 0 for k in _launch_counts()}
    bf16 = {k: 0 for k in _bf16_instances()}
    survey, *values = ref10
    walls = _x64_sim(torch, survey, values, fields15, counts, bf16, n,
                     device)
    walls['diff_k6'] = _x64_diff(torch, grad12, counts, bf16, n, device)
    log(f"x64 off launches: {counts}, of them bfloat16 instances {bf16}")
    for k in ('factored', 'line_residual', 'line_thomas', 'line_factor',
              'residual_ds'):
        if counts[k] == 0:
            raise AssertionError(f"x64 off: no {k} launch")
    return counts, bf16, walls


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card.", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from emg3d_tpu_torch import solver
    from emg3d_tpu_torch.ops import line_gs, point_gs, probes

    results = {}
    with Phase('1 environment'):
        phase_environment(torch)
    with Phase('2 build'):
        phase_build()
    with Phase('3 point kernels vs plain'):
        phase_kernels(torch, results)
    with Phase('3b line kernels vs plain'):
        phase_line_kernels(torch, results)

    grid, model, sfield = bench_problem()
    big = large_shape(torch)
    big_problem = bench_problem(big)

    def card_kernel(sh):
        return point_gs.point_kernel(sh, 'cuda')
    per_cycle = point_per_cycle(point_cycle_calls(grid, model, sfield),
                                card_kernel)
    big_cycle = point_per_cycle(point_cycle_calls(*big_problem,
                                                  device='cuda'),
                                card_kernel)
    torch.cuda.empty_cache()
    point_gs.reset_launches()
    probes.reset_launches()
    with Phase('4 main path: solve 64³ and '
               f'{"x".join(map(str, big))}, default kernels'):
        e4, info4, wall_cold = _solve(torch, grid, model, sfield)
        k64 = dict(point_gs.LAUNCHES)
        s64 = dict(point_gs.STEPS)
        log(f"64³: it_mg {info4['it_mg']}, rel_error "
            f"{info4['rel_error']:.3e}, wall {wall_cold:.3f} s (first "
            f"solve), launches {k64}, colour steps {s64}; enumerated on "
            f"the CPU under point_kernel and sweep_plan, (launches, steps) "
            f"per cycle: {per_cycle}")
        for k, (n, st) in per_cycle.items():
            if (k64[k], s64[k]) != (n * info4['it_mg'], st * info4['it_mg']):
                raise AssertionError(f"64³ {k} launches or steps differ "
                                     f"from the CPU enumeration")
        eb, infob, wallb = _solve(torch, *big_problem)
        launches = dict(point_gs.LAUNCHES)
        steps = dict(point_gs.STEPS)
        kbig = {k: launches[k] - k64[k] for k in launches}
        sbig = {k: steps[k] - s64[k] for k in steps}
        log(f"{big}: it_mg {infob['it_mg']}, rel_error "
            f"{infob['rel_error']:.3e}, wall {wallb:.3f} s (first solve), "
            f"launches {kbig}, colour steps {sbig}; enumerated per cycle: "
            f"{big_cycle}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del eb
        for k, (n, st) in big_cycle.items():
            if (kbig[k], sbig[k]) != (n * infob['it_mg'],
                                      st * infob['it_mg']):
                raise AssertionError(f"{big} {k} launches or steps differ "
                                     f"from the enumeration")
        if min(launches.values()) == 0:
            raise AssertionError(f"the point solves launched no "
                                 f"{min(launches, key=launches.get)} kernel")
    with Phase('4b warm solve 64³, default kernels'):
        e4b, info4b, wall_warm = _solve(torch, grid, model, sfield)
        log(f"it_mg {info4b['it_mg']}, warm wall {wall_warm:.3f} s, "
            f"|Δ|/|e| vs phase 4 {_rel(e4b, e4):.3e}")
    pinned = {}
    with Phase('5 solve 64³ with each point kernel pinned on every level'):
        for mode in POINT_MODES:
            point_gs.reset_launches()
            with _switch(point_gs, 'FORCE_KERNEL', mode):
                e5, info5, wall5 = _solve(torch, grid, model, sfield)
            pinned[mode] = point_gs.LAUNCHES[mode]
            rel = _rel(e5, e4)
            log(f"{mode}: it_mg {info5['it_mg']}, rel_error "
                f"{info5['rel_error']:.3e}, wall {wall5:.3f} s, "
                f"|e5-e4|/|e4| {rel:.3e}, launches "
                f"{dict(point_gs.LAUNCHES)}, colour steps "
                f"{dict(point_gs.STEPS)}")
            if info5['it_mg'] != info4['it_mg'] or not rel <= TOL_SOLVE:
                raise AssertionError(f"the {mode}-pinned solve differs "
                                     f"from the default one")
            if pinned[mode] == 0 or sum(point_gs.LAUNCHES.values()) != \
                    pinned[mode]:
                raise AssertionError(f"the {mode}-pinned solve ran "
                                     f"{dict(point_gs.LAUNCHES)}")
            del e5
    with Phase('6 heterogeneous tri-axial 64x48x40: kernels vs plain'):
        hg, hm, hs = heterogeneous_problem()
        ek, ik, wk = _solve(torch, hg, hm, hs)
        with _plain():
            ep, ip, wp = _solve(torch, hg, hm, hs)
        rel = _rel(ek, ep)
        log(f"kernels: it_mg {ik['it_mg']}, rel_error "
            f"{ik['rel_error']:.3e}, wall {wk:.3f} s; plain: it_mg "
            f"{ip['it_mg']}, wall {wp:.3f} s; |Δ|/|e| {rel:.3e}")
        if ik['it_mg'] != ip['it_mg'] or not rel <= TOL_SOLVE:
            raise AssertionError("kernel and plain solves differ")
    with Phase('7 main path: sclr64 (sc+lr), standalone, bicgstab, cgs'):
        sclr_launches, e_sclr, sclr_refs = phase_sclr64(torch, grid, model,
                                                        sfield)
        launches.update(sclr_launches)
    with Phase('8 sclr256: sc+lr standalone at 256³'):
        line_gs.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with line_state_clock() as clock:
            e8, info8, wall8 = _solve(torch, *bench_problem((256,) * 3),
                                      **SCLR)
        del e8
        peak8 = torch.cuda.max_memory_allocated() / 2**30
        log(f"256³: it_mg {info8['it_mg']}, rel_error "
            f"{info8['rel_error']:.3e}, wall {wall8:.3f} s (first solve; "
            f"{clock.seconds:.4f} s in {clock.calls} line-state builds), "
            f"peak device memory {peak8:.2f} GiB, "
            f"launches {dict(line_gs.LAUNCHES)}")
    with Phase('9 heterogeneous tri-axial 64x48x40, sc+lr: kernels vs '
               'plain'):
        ek, ik, wk = _solve(torch, hg, hm, hs, **SCLR)
        with _plain():
            ep, ip, wp = _solve(torch, hg, hm, hs, **SCLR)
        rel = _rel(ek, ep)
        log(f"kernels: it_mg {ik['it_mg']}, rel_error "
            f"{ik['rel_error']:.3e}, wall {wk:.3f} s; plain: it_mg "
            f"{ip['it_mg']}, wall {wp:.3f} s; |Δ|/|e| {rel:.3e}")
        if ik['it_mg'] != ip['it_mg'] or not rel <= TOL_SOLVE:
            raise AssertionError("kernel and plain sc+lr solves differ")
    out_dir = Path(__file__).resolve().parent / 'build' / 'chip_smoke'
    out_dir.mkdir(parents=True, exist_ok=True)
    with Phase('10 Simulation 64³, sc+lr BiCGSTAB, 8 lanes'):
        sim_launches, sim10, grad10 = phase_simulation(torch, results,
                                                       out_dir)
        # Phase 18's complex128 references, before phase 13 computes new
        # observed data into sim10's survey: the survey with the observed
        # data of phase 10's misfit, its responses, misfit and gradient.
        ref10 = (sim10.survey.copy(), np.array(sim10.data.synthetic),
                 float(sim10.misfit), np.array(grad10))
    with Phase('11 tdem64: time domain, 19 frequencies, one batched solve'):
        tdem_launches = phase_tdem(torch, out_dir)
    with Phase('12 diff64: autograd gradients, point and sc+lr'):
        diff_launches, grad12 = phase_diff(torch, out_dir)
    with Phase('13 cli64: io and the command line'):
        phase_cli(torch, sim10, grad10, out_dir)
    probe_launches = dict(probes.LAUNCHES)
    with Phase('14 probes'):
        probe_entries = phase_probes(torch, probe_launches) + \
            lr128_entries(results, launches)
    with Phase('15 complex64: kernels, main path, kernels vs plain'):
        # float32 storage pinned: the complex64 path without bfloat16.
        solver.BF16_STORAGE = False
        try:
            phase_c64_kernels(torch, results)
            c64_launches, peak_c64, k6_per_solve, c64_refs, sim_c64 = \
                phase_c64_path(torch, e4, e_sclr, peak8, sim10)
            phase_c64_plain(torch)
        finally:
            solver.BF16_STORAGE = None
        del sim10, grad10
    with Phase('16 bfloat16 storage: kernels, main path, kernels vs '
               'plain'):
        phase_bf16_kernels(torch, results)
        bf16_launches, peak_bf16 = phase_bf16_path(torch, e4, e_sclr,
                                                   peak_c64)
        phase_bf16_plain(torch)
    with Phase('17 sharded: world size 1 (NCCL) bench64 and sclr64, '
               'complex64 bench64, sclr64 BiCGSTAB and sclr256; bench64 '
               'and sclr64 (standalone, BiCGSTAB; complex64 point and '
               'BiCGSTAB) on 2 ranks, tri64x48x40 point and sc+lr on 2×2 '
               '(gloo)'):
        sharded_launches, sharded_errs, c64_sharded, c64_sharded_errs = \
            phase_sharded(torch, e4, info4, sclr_refs, c64_refs, out_dir)
    with Phase('18 x64 off: sim64 compute(), misfit and gradient, and '
               'diff64, in complex64 through the public API'):
        x64_launches, x64_bf16, x64_walls = phase_x64_off(torch, ref10,
                                                          sim_c64, grad12)

    kernels = []
    for key, meta in KERNELS.items():
        r = results[key]
        entry = {'name': meta['name'], 'route': 'cuda',
                 'source': meta['source'], 'replaces': meta['replaces'],
                 'launches': launches[key],
                 'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                 'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                 'bound_by': r['bound_by'], 'library_ms': None}
        if key in pinned:
            entry['pinned_launches'] = pinned[key]
        entry['simulation_launches'] = sim_launches[key]
        entry['tdem_launches'] = tdem_launches[key]
        entry['diff_launches'] = {c: n[key] for c, n in diff_launches.items()}
        entry['launches_sharded'] = sharded_launches[key]
        entry['max_abs_err_sharded'] = sharded_errs[key]
        entry['launches_sharded_c64'] = c64_sharded[key]
        entry['max_abs_err_sharded_c64'] = c64_sharded_errs[key]
        if key in POINT_MODES:
            entry['plan'] = r['plan']
            entry['steps'] = steps[key]
        entry['launches_c64'] = c64_launches[key]
        entry['max_abs_err_c64'] = r['max_abs_err_c64']
        entry['checks_c64'] = r['checks_c64']
        entry['launches_bf16'] = bf16_launches[key]
        entry['launches_x64_off'] = x64_launches[key]
        entry['launches_x64_off_bf16'] = x64_bf16[key]
        entry['max_abs_err_bf16'] = r['max_abs_err_bf16']
        entry['checks_bf16'] = r['checks_bf16']
        entry.update({k: v for k, v in r.items()
                      if k.startswith('step') or k[-4:] in ('_128', '_256')
                      or k.endswith('_large') or k.startswith('ms_')
                      or k.startswith('bound_ms_') or k.startswith('lanes')})
        kernels.append(entry)
    r = results['residual_ds']
    kernels.append({
        'name': DSRES['name'], 'route': 'cuda', 'source': DSRES['source'],
        'replaces': DSRES['replaces'],
        'launches': c64_launches['residual_ds'],
        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
        'bound_by': r['bound_by'], 'library_ms': None,
        'launches_c64': c64_launches['residual_ds'],
        'launches_bf16': bf16_launches['residual_ds'],
        'launches_x64_off': x64_launches['residual_ds'],
        'launches_per_solve_x64_off_diff': x64_walls['diff_k6'],
        'launches_per_solve_c64': k6_per_solve, 'checks': r['checks'],
        'launches_sharded_c64': c64_sharded['residual_ds'],
        'max_abs_err_sharded_c64': c64_sharded_errs['residual_ds'],
        **{k + n: r[k + n] for n in DSRES_TIMED.values() for k in (
            'ms', 'plan', 'chunk_ms', 'plain_ms', 'bound_ms',
            'bound_by')}})
    log(f"solve 64³ F-cycle: it_mg {info4['it_mg']}, warm wall "
        f"{wall_warm:.3f} s; sclr256 complex64 peak {peak_c64:.2f} GiB "
        f"with float32 storage, {peak_bf16:.2f} GiB with bfloat16")
    print(json.dumps({'kernels': kernels, 'probes': probe_entries}))
    print(nvidia_smi())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
