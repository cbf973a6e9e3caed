#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Ten paths, the first four through ``minimize_batched(objective, x0_batch,
Lbfgs(m=10))``, the fifth through ``minimize_batched`` with the other
solvers, the sixth through L-BFGS-B and ``AugmentedLagrangian``, the
seventh through the examples and ``entry_torch.py``, the eighth through the
multi-device solves of ``parallel`` and the scaling harness, the last
through the bench's calibrations:

* the flat solve (a fresh solve without a trace), whose loop trip is one
  batched objective evaluation plus one ``flat_trip`` kernel launch;
* the iteration-granular loop (``trace=``, ``internals=``, ``resume``), whose
  iteration is one ``lbfgs_prologue`` launch, one ``mt_trip`` launch per
  evaluation of the batched line search, and one ``lbfgs_epilogue`` launch;
* path A, that loop on the batch-minor history (a ring per lane):
  ``lbfgs_prologue_t`` in place of ``lbfgs_prologue`` (routed by
  ``Lbfgs._TRANSPOSED_N_MAX``, which the script sets so that the path runs
  whatever the shipped value is);
* path B, a second-mode objective with the Hessian-condition criterion on:
  the generic loop body over ``Lbfgs.step``, whose iteration is one
  ``push_two_loop`` launch (``lbfgs_push_and_direction``), the search's
  ``mt_trip`` launches and cond(H) at the new iterate;
* path C, the public op ``two_loop_direction`` (the ``two_loop`` kernel);
* the other solvers and searches (``solvers_main``): BFGS and gradient
  descent, whose More-Thuente search runs ``mt_trip`` once per trip;
  L-BFGS with the Hager-Zhang or Armijo search, whose iteration-granular
  loop runs ``lbfgs_prologue`` and ``lbfgs_epilogue`` once per iteration
  (never ``flat_trip``); and conjugate gradient, Newton, trust-region Newton
  (dense and Hessian-free) and Nelder-Mead, which run no kernel, as in the
  JAX package;
* the constrained layer (``constrained_main``): L-BFGS-B, whose search runs
  ``mt_trip`` once per trip, and the augmented-Lagrangian outer loop, whose
  inner solve with ``Lbfgs`` runs ``lbfgs_prologue``, ``mt_trip`` and
  ``lbfgs_epilogue`` and with ``Lbfgsb`` the L-BFGS-B step (never
  ``flat_trip``); and the finite-difference checkers;
* the examples (``examples_main``): every ``examples_torch`` module's
  ``main`` on the card and on the CPU, each solve with the kernels it runs
  (the quick-start's L-BFGS and the svm primal fit ``flat_trip``; gradient
  descent, BFGS, L-BFGS-B and the dual fits ``mt_trip``; the AL solves with
  ``Lbfgs`` inside ``lbfgs_prologue``, ``mt_trip``, ``lbfgs_epilogue``),
  and ``examples_torch/pod_scale.py`` and ``entry_torch.dryrun_multichip``
  in processes of their own (``chip_smoke.py --example-world-of-one DIR``,
  ``--example-rank RANK 2 DIR``);
* the multi-device solves (``parallel_main``): ``minimize_sharded``, whose
  ranks each run the flat solve (``flat_trip``) or L-BFGS-B (``mt_trip``)
  on their block of lanes, in a world of one under NCCL and on two gloo
  ranks sharing the card (``chip_smoke.py --parallel-rank``, processes of
  their own); ``minimize_model_sharded`` on ``Lbfgs(two_loop_impl="xla")``,
  which runs no kernel, at n = 4,194,304 and 1,048,576 float64, on
  ``Lbfgsb`` at n = 1,048,576 (its Cauchy walk merged over the ranks, no
  kernel either), and on BFGS, Newton, both trust regions, Nelder-Mead and
  preconditioned L-BFGS (part (f): no kernel; its world of one in the side
  process); and
  ``two_loop_impl="xla"`` alone past the reach of q in shared memory, where
  the default ``"auto"`` runs ``flat_trip`` with q in device memory;
* the scaling harness (``scaling_main``): ``benchmarks_torch/scaling.py``
  as a user runs it, a subprocess whose ranks are processes of their own
  under NCCL, one a card, and its three legs' worlds of one in this
  process at the card sizes (``Lbfgs(two_loop_impl="xla")`` and the
  model-sharded solves: no kernel, as the JAX harness's legs take XLA's
  lowering);
* the calibrations of ``benchmarks_torch/roofline.py`` (``floors_main``):
  the trip floor, whose loop launches ``trip_floor`` once a trip, and the
  launch floor, whose chains launch ``launch_floor`` from the host and in a
  CUDA graph.

Phases (each raises on failure, so the script then exits non-zero):

1. build   compile the nine sources of ``ops/csrc/`` with nvcc for sm_90a,
           all at once, load them, and print each kernel's registers,
           spills and stack frame (ptxas -v);
2. card    print the card's name and power limit (nvidia-smi);
3. parity  flat: ~50 trips of a plain-version solve; at every trip the
           identical state goes through the kernel and through the plain
           version, and every output is compared (float64 and float32), at
           shapes that take every lane mapping of the kernel (a warp per
           lane with a ragged last block, a block per lane at a ragged n,
           the history staged on chip and streamed).
           Nested: the same for every call of the three kernels during a
           plain-version solve run to its end, at every shape the nested
           path runs at, so that done lanes, full-history pushes and the
           statuses that end a lane are compared too; the batch-minor loop
           also where n is not a multiple of four and where its lane tiles
           and slices of j are ragged, and its prologue on made-up inputs
           (chronological, and on a ring whose heads differ by lane) at
           every launch plan the solves do not take.  The fused push and
           the epilogue on made-up inputs at every mapping they take (the
           epilogue also under every mapping forced at each shape, all of
           which must give the same bits; the fused push and the bare
           two-loop also with q in device memory, bit for bit).  Reach:
           flat and warm-started nested solves cut at 10 and 30 iterations
           at (64, 16384), where the history rows are read in place (and
           again with q in device memory, bit for bit), and at (8, 65,536),
           where q is in device memory, float64 held to the exact
           short-budget contract (iterates within 1e-12 at 10 iterations;
           at 30 their distance is recorded beside the plain version's
           against itself summed in another order).  Drift: at one shape
           per kernel, each float32 kernel's and plain version's distance
           to the plain version in float64 on the same inputs, side by
           side;
4. main    flat: ``minimize_batched`` in float32 on the pairwise extended
           Rosenbrock at the throughput-grid shapes, launch counts set to 0
           just before and read just after; the result is held against the
           same solve through the plain version on the card; one float64
           solve must agree lane for lane; ``minimize`` on the 2-D
           Rosenbrock must reach (1, 1).
           Nested: a traced solve cut by ``max_iterations``, ``resume`` to
           the end and a warm start with ``internals=`` and ``trace=``, with
           launch counts that must match the iteration and trip counts; the
           result is held against the same solves through the plain versions
           on the card and against the flat path.
           Paths A, B and C: see ``nested_main(batch_minor=True)``,
           ``path_b_main`` and ``path_c_main``.  The MGH-376 suite
           (``suite_main``).  The other solvers and searches at bench.py's
           solver-leg shapes (``solvers_main``): launch counts, the host
           clock and the device-to-host reads of each solve; kernels
           against plain versions, paths without a kernel against the
           same solve on the CPU.  L-BFGS-B at bench.py's shapes (and with
           a box per lane), bench.py's AL leg and the constrained example's
           problems (``constrained_main``): launch counts, times, reads and
           Cauchy-walk passes; short float64 budgets exact against the
           plain versions and against the CPU; the checkers' booleans and
           values against the CPU's.  The examples (``examples_main``):
           each module's figures on the card against the CPU's, each
           solve's launches, pod_scale and the dry runs in their own
           processes.  The multi-device solves
           (``parallel_main``, parts (a)-(f) of the comment above
           PARALLEL_SHAPES): bit-equality with the unsharded solves,
           launch counts, the collectives inside each loop and after it
           (``parallel.comm.CollectiveLog``), walls and reads; L-BFGS-B
           and the dense solvers block against whole batch (part (b)).
           The scaling harness (``scaling_main``): its JSON line held,
           each leg's world of one bit-equal to the unsharded solve.
           The calibration kernels (``floors_main``): bit-equal to their
           plain versions after one launch and after a trip loop's or a
           chain's length, timed, then the two calibrations run once;
5. timing  CUDA events around every kernel call and evaluation, plain,
           kernel, kernel, plain, on the host clock and on the card's own
           time, a count of the bytes and operations each call's data
           needs, whole flat and nested solves side by side, and the
           iteration-granular loop on the two history layouts side by side
           (the routing measurement behind ``Lbfgs._TRANSPOSED_N_MAX``);
6. report  one JSON line per shape, the ``kernels`` line, the card line and,
           last, the device line.  ``chiprun_out/chip_smoke.json`` keeps the
           full record.

With no GPU it prints no result and exits 1; nothing runs on the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SEED = 0
M = 10
MAX_FEV = 20
# Grid shapes of the throughput benchmark that the flat path serves, plus
# (256, 4096), which records the flat kernel above n = 1024 for routing.
MAIN_SHAPES = [(1024, 32), (8192, 32), (1024, 1024), (256, 4096)]
HEADLINE_SHAPE = (1024, 1024)
# The flat kernel's lane mappings (ops/_kernel.py::lane_mapping): warp per
# lane with a ragged last block (1000, 32), a block per lane at a ragged n
# (1024, 100), staged rows (1024, 1024) and streamed rows (256, 4096); and
# the MGH-376 suite's own shapes (suite_parity: one lane per block at
# B = 6-7, n = 2-40).
PARITY_SHAPES = [(1024, 32), (1000, 32), (1024, 100), (1024, 1024),
                 (256, 4096)]
PARITY_TRIPS = 50
# The iteration-granular path: full width in float32.  Its kernels are held
# against their plain versions at these shapes and at (1024, 32).
NESTED_SHAPES = [(1024, 1024), (256, 4096)]
NESTED_PARITY_SHAPES = [(1024, 32), (1000, 32), (1024, 100)] + NESTED_SHAPES
# One more nested parity solve, for the rungs the default solve does not
# reach: lanes that start at the optimum (zero step: stall reset, x_delta),
# lanes far out (overflow in the search: the non-finite guard), a counted
# relative f_delta test in place of the plateau ring, a loose gradient-norm
# test, and an iteration limit.
EDGE_SHAPE = (1024, 32)
EDGE_LANES = 16
EDGE_STOPPING = dict(past=0, f_delta=1e-3, f_delta_violations=2,
                     f_delta_relative=True, gradient_norm=1.0,
                     max_iterations=40)
NESTED_CUT = 10                 # max_iterations of the cut solve
NESTED_TRACE = 16               # trace capacity on the main path
# Depth of the spin-padded nested solves, kernel and plain alike, and of
# the flat solve's timed plain version: 20 iterations, so that the script
# fits its time limit on a slow host with every parity shape.  At 40
# the prologue's and the epilogue's means a launch differ (PERF.md §6).
NESTED_TIMED_ITERATIONS = 20
# The batch-minor loop (path A).
T_SHAPES = [(1024, 32), (1024, 256), (1024, 1024), (512, 2048)]
# The routing measurement: the headline shape alone, whose batch-minor
# prologue the kernels line reads (lane_sweep.py times both prologues at
# every T_SHAPES shape); the other three cost 35 s on a slow host, which
# the scaling phase needs to keep the script inside its time limit.
ROUTING_SHAPES = [HEADLINE_SHAPE]
# The batch-minor loop is also held against its plain versions where n is
# not a multiple of four (mt_trip's 4-byte loads, a warp and a block per
# lane) and where a lane tile (8 lanes) and the cluster's slices of j are
# ragged.
T_PARITY_SHAPES = T_SHAPES + [(1001, 30), (1024, 102)]
# Made-up calls of the batch-minor prologue at launch plans that the solves
# above do not take: one block per tile (8192, 32), clusters of 2 (2048,
# 256), 16 elements a thread (256, 4096), a ragged tile (1001, 30).
T_MADE_UP_SHAPES = [(8192, 32), (2048, 256), (256, 4096), (1001, 30)]
PATH_A_SHAPES = [(1024, 32), (512, 2048)]
# Path B: the Hessian is (B, n, n), so n stays small; the larger shape's
# solves are cut at this many iterations.  The criterion is this factor
# times cond(H) at the optimum: lanes whose way leads through a region
# where a 2x2 block of H is near singular stop on it, the others do not.
PATH_B_SHAPES = [(1024, 32), (1024, 256)]
PATH_B_CUT = {(1024, 256): 40}
PATH_B_FACTOR = 100.0
# The larger shape's main-path solves run in float64: its criterion is 3e7,
# and float32 cannot resolve cond(H) there (cond * eps is about 4), so a
# last-bit difference in x flips the test: kernel and plain-version solves
# agreed on 71% of lanes' statuses in float32 with mean nfev 0.004 apart.
PATH_B_DTYPE = {(1024, 32): "float32", (1024, 256): "float64"}
# Past the reach of q in shared memory (n > 28,760 in float64, 57,816 in
# float32 at m = 10) the history kernels keep q in device memory
# (ROWS_DEVICE_Q): the reach phase, the fused push and the bare two-loop
# are held to their plain versions there too.
DEVICE_Q_SHAPE = (8, 65536)
# Made-up inputs for the two-loop kernels, which need no Hessian.  The
# fused push is also held where a warp holds two elements a thread with a
# ragged last block (1000, 60), where its rows are read in place
# (64, 16384) and where q is in device memory too (DEVICE_Q_SHAPE).
PUSH_SHAPES = [(1024, 32), (1024, 256), (1024, 1024), (256, 4096)]
PUSH_PARITY_SHAPES = PUSH_SHAPES + [(1000, 60), (64, 16384),
                                    DEVICE_Q_SHAPE]
# The epilogue on made-up inputs where each of its mappings is taken: a
# warp per lane (one and two elements a thread, a ragged last block), a
# block per lane with 16-byte units and with single values (n % 4 != 0),
# clusters of 2 and 4 blocks; every other mapping is forced at each shape
# too, and all must give the same bits.
EPILOGUE_SHAPES = [(1024, 32), (1000, 60), (1024, 102), (1024, 1024),
                   (256, 4096), (100, 4096), (64, 16384)]
# The card's reach in n: flat and warm-started nested solves, kernels
# against plain versions, where the history rows are read in place (n >
# 5,752 in float64, 11,563 in float32), cut at REACH_SHORT_CUT and at
# REACH_CUT iterations.  In float64 status, nfev and iterations must be
# equal at both; the iterates are held within 1e-12 at the short budget.
# At 30 iterations the problem itself parts two correct float64 solves by
# more than that (the plain version against itself with its dot products
# summed in another order, which this phase also runs), so there the
# kernel's distance is recorded beside that reordering's.
REACH_SHAPE = (64, 16384)
REACH_SHORT_CUT = 10
REACH_CUT = 30
TWO_LOOP_SHAPES = [(1024, 32), (1024, 1024), (256, 4096)]
# The bare two-loop is also held where a warp holds two elements a thread
# with a ragged last block (1000, 60), where a block streams its rows
# through the ring at a ragged n (1024, 100), where it reads them in
# place (64, 16384) and where q is in device memory too (DEVICE_Q_SHAPE);
# at every shape each other row mode that fits is forced too (q in device
# memory fits wherever a block holds a lane), and every one must give the
# shipped mapping's bits, as must push_two_loop with valid off.
TWO_LOOP_PARITY_SHAPES = TWO_LOOP_SHAPES + [(1000, 60), (1024, 100),
                                            (64, 16384), DEVICE_Q_SHAPE]
# The bare two-loop's float outputs also element by element: the tolerance
# of tests/test_torch_two_loop.py against JAX's kernel in float32.
TWO_LOOP_ELEMENT_TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
                        "float64": dict(rtol=1e-9, atol=0.0)}
# The MGH-376 suite (suite_bench.py's single solve): share of a pass's
# lanes whose status must equal the plain version's on the card (PERF.md
# §2), and the share of the 376 instances the single solve must converge
# (bench.py:46, the reference's own figure).
SUITE_STATUS_AGREEMENT = {"float64": 1.0, "float32": 0.99}
SUITE_CONVERGED_MIN = 0.95
# The other unconstrained solvers and searches (solvers_main) at bench.py's
# solver-leg shapes, and the constrained layer's legs (constrained_main):
# benchmarks_torch/legs.py holds their tables, shared with bench_torch.py.
# constrained_main also runs examples_torch/constrained.py's two problems
# from 64 starts with L-BFGS-B inside, and the checkers at n = 32 and 64.
from benchmarks_torch.legs import (  # noqa: E402
    AL_LEG, AL_LEG_BUDGET, LANE_BOXES, LBFGSB_BOX, LBFGSB_RUNS, SOLVER_RUNS,
    al_leg_problem)

AL_EXAMPLE_STARTS = 64
AL_EXAMPLE_BOX = (-3.0, 3.0)
CONSTRAINED_SHORT_LBFGSB = 5     # iterations of the float64 comparisons
CONSTRAINED_SHORT_AL = (2, 5)    # outer x inner iterations of the same
# Kernels against plain versions, float64 short budgets: x, the penalty and
# the multipliers over max(1, rho) of their lane (lambda += rho c scales the
# last bits of c by rho).
CONSTRAINED_XTOL = 1e-12
# The card against the CPU, float64 short budgets, by run: (float bound, share
# of lanes whose nfev may differ).  Spreads measured on the card (PERF.md
# §6): L-BFGS-B x 1.2e-14, nfev one apart on 1 lane of 1,024 (a point that
# lands on a bound is a last bit inside or outside it, and the step bills an
# evaluation where it is outside); the AL leg x 1.3e-13, multipliers
# 1.2e-12; the examples x 2.1e-10, multipliers 2.2e-11, nfev apart on up to
# 31 of 64 lanes (L-BFGS-B reaches the composite's minimizer and its last
# step searches at the roundoff floor).
CONSTRAINED_CPU = {"lbfgsb": (1e-12, 0.005), "bench_leg": (1e-11, 0.0),
                   "example": (1e-9, 1.0)}
# The float32 AL leg: FINISHED needs |sum(x^2) - n| <= 1e-4, below the
# float32 resolution of a sum near n = 4096 (its ulp, 4.9e-4), so which
# lanes finish is the last bit's choice (kernel and plain agreed on 50%).
# Held instead to both versions stopping on FINISHED or ITERATION_LIMIT with
# violations within AL_F32_ULPS ulps of n and x within AL_F32_XTOL of each
# other (measured: 16 ulps and 3.9e-3).
AL_F32_ULPS = 32
AL_F32_XTOL = 1e-2
CONSTRAINED_KERNELS = ("mt_trip", "lbfgs_prologue", "lbfgs_epilogue")
CHECKER_SIZES = (32, 64)
# The checkers, card against CPU, relative to the largest entry: the card
# and the CPU round f differently in its last bit, and a finite difference
# divides that by a step near 1e-8 (gradient) or its square root squared
# (Hessian): measured 1.6e-8 to 1.1e-7 at n = 32 and 64 (PERF.md §6).
CHECKER_RTOL = 1e-6
SOLVER_SHORT_BUDGET = 5       # iterations of the float64 comparisons
SOLVER_CPU_XTOL = 1e-10       # card against CPU, paths with no kernel
SOLVER_PLAIN_XTOL = 1e-12     # kernels against plain versions, float64
# One made-up call through both prologues, built to reach what no parity
# solve reaches on the card: the invalid-descent history reset.
RESET_SHAPES = [(1024, 32), (1000, 32), (1024, 1024)]
OP_TIMED_CALLS = 20
REPLACES = {
    "flat_trip": "cppnumericalsolvers_tpu/ops/flat_solve.py:109",
    "mt_trip": "cppnumericalsolvers_tpu/ops/fused_linesearch.py:255",
    "lbfgs_prologue": "cppnumericalsolvers_tpu/ops/fused_step.py:118",
    "lbfgs_epilogue": "cppnumericalsolvers_tpu/ops/fused_step.py:358",
    "lbfgs_prologue_t": "cppnumericalsolvers_tpu/ops/fused_step_t.py:103",
    "push_two_loop": "cppnumericalsolvers_tpu/ops/two_loop.py:658",
    "two_loop": "cppnumericalsolvers_tpu/ops/two_loop.py:232",
    "trip_floor": "benchmarks/roofline.py:560",
    "launch_floor": "benchmarks/roofline.py:640",
}
# Float outputs: |kernel - plain| <= RTOL * scale, where scale is the
# largest magnitude in the lane's vector (or the scalar itself).  The kernel
# sums in another order than torch.sum, so the floor is a few ulps of a
# length-n reduction amplified by the two-loop recursion.
RTOL = {"float64": 1e-9, "float32": 1e-5}
# The prologue's search direction is the end of the two-loop's 2m dependent length-n
# reductions, each a difference of like-sized terms.  Late in a float32
# solve the kernel and the plain version end up to 2e-5 (n = 1024) and
# 5e-5 (n = 4096) of the direction's largest entry apart, with every integer
# output and the whole history bit-equal; 50 trips into a solve (the flat
# phase) it is 1.3e-6.
DIRECTION_RTOL = {"float64": 1e-9, "float32": 1e-4}
# float32 lanes allowed to disagree at one trip (a comparison that flips on
# a last-bit difference of a dot product): at most 0.1%.
F32_MISMATCH_SHARE = 1e-3
# The multi-device solves (parallel_main), each with what it is held to:
# (a) minimize_sharded in a world of one (NCCL, this process) at the
#     throughput grid's shapes, bit-equal to minimize_batched;
# (b) minimize_sharded on two gloo ranks sharing the card (two processes;
#     NCCL refuses two ranks on one GPU): L-BFGS at (1024, 32) and
#     __graft_entry__.py's Lbfgsb(m=5, lower=0.5, upper=4.0) case from
#     starts in [1, 3] at the same shape, bit-equal to this process's solve
#     of each rank's block of lanes; L-BFGS-B (status, nfev, x) bit-equal
#     per lane to the whole batch solved here, after one iteration and on
#     full solves, in float32 and float64, at that shape and at
#     BLOCK_PAIR_SHAPE (few lanes, long rows) as two blocks against the
#     whole (there the first iteration is held by the full solves' trace);
#     BFGS and the trust region the same at their solver-leg shapes (one
#     iteration in both precisions), Newton recorded (its batched solve is
#     a library call); see block_checks;
# (c) minimize_model_sharded on the view-form extended Rosenbrock from
#     x = -1.2, float64, Lbfgs(m=10): at n = 4,194,304 in a world of one,
#     bit-equal to the unsharded Lbfgs(two_loop_impl="xla") solve; at n =
#     1,048,576 on two gloo ranks, status and nfev equal to the world of
#     one at that n, x within MODEL_XTOL, the value within MODEL_VALUE_RTOL
#     (tests/test_model_sharded.py's tolerances);
# (d) Lbfgs(two_loop_impl="xla") alone at (4, 65,536) float32, past the
#     reach of q in shared memory: no launch, a convergence status; the
#     default "auto" runs the flat solve's kernel there (q in device
#     memory), one launch a trip, every lane on a convergence status (its
#     statuses and x distance to "xla" recorded).
PARALLEL_SHAPES = [(8192, 32), (1024, 1024)]
PARALLEL_PAIR_SHAPE = (1024, 32)
PARALLEL_BOX = (0.5, 4.0)
PARALLEL_BOX_STARTS = (1.0, 3.0)
MODEL_N = 4_194_304
MODEL_PAIR_N = 1_048_576
MODEL_XTOL = 1e-8
MODEL_VALUE_RTOL = 1e-10
XLA_SHAPE = (4, 65536)
BLOCK_PAIR_SHAPE = (8, 4096)
#: Part (b)'s dense solvers, by label in SOLVER_RUNS; Newton's is recorded,
#: not asserted.
BLOCK_DENSE = ("bfgs", "newton", "tr")
PARALLEL_RANKS = 2
PARALLEL_RANK_TIMEOUT = 400
# The side process (``chip_smoke.py --side DIR``), started right after the
# build and run beside the parity phase on the same card: the plain
# version's passes over the MGH-376 suite that suite_main holds the
# kernel's statuses to, part (b)'s block-against-batch checks
# (block_checks) and part (f)'s world of one (dense_world_of_one).  None
# launches a kernel that a count reads.
SIDE_TIMEOUT = 900
# (e) minimize_model_sharded on Lbfgsb(m=5, lower=0.5, upper=4.0) in a world
#     of one under NCCL, the view-form extended Rosenbrock at n = 1,048,576
#     float64, cut at MODEL_LBFGSB_CUT iterations, against the unsharded
#     Lbfgsb on the card at the same cut: status, nfev and iterations equal,
#     x within MODEL_LBFGSB_XTOL; no launch, the Cauchy passes and the
#     collectives an iteration recorded.  The start is 1 everywhere (the
#     optimum: a zero gradient, so no breakpoint) but for every
#     MODEL_LBFGSB_EVERY-th pair, drawn from [1, 3] from seed 0: from [1, 3]
#     everywhere the first walk crosses all but a few of n breakpoints, one
#     pass (two collectives and one read) each (4,087 of 4,096 at n = 4096
#     on the CPU), which at n = 1,048,576 would take hours; this start
#     crosses two a drawn pair in the first iteration and none after
#     (measured on the CPU at n = 4096 and 65,536).  The same solve on
#     part (b)'s two gloo ranks (the walk's heads merged over two shards)
#     is held to the world of one: status, nfev and iterations equal, x
#     within MODEL_LBFGSB_XTOL.
MODEL_LBFGSB_N = 1_048_576
MODEL_LBFGSB_EVERY = 512
MODEL_LBFGSB_CUT = 10
MODEL_LBFGSB_XTOL = 1e-12
# (f) minimize_model_sharded on the dense solvers (DENSE_RUNS), float64:
#     in a world of one under NCCL, run in the side process after its block
#     checks, against the unsharded card solve through the plain versions
#     (the sharded solve takes the plain More-Thuente trip, as JAX's sharded
#     solve takes XLA's lowering; Newton, the trust region and Nelder-Mead
#     launch nothing either way): status, nfev, iterations and x bit-equal;
#     on part (b)'s two gloo ranks (in their processes, after part (e))
#     against the world of one at the same shape: status, nfev and
#     iterations equal, x within DENSE_XTOL.  Every sharded solve launches
#     no kernel; walls, reads and (on the two ranks) the collectives in
#     each loop are recorded.  The objective is the view-form extended
#     Rosenbrock (models.pairwise_rosenbrock's function: its strided
#     slices make DTensor all-gather x, which gloo cannot do with card
#     tensors), and BFGS's the weighted quadratic of
#     tests/test_model_sharded.py, its weights a plain constant; BFGS's
#     inverse Hessian at (4, 16,384) is 2 GiB a lane, so its two ranks
#     (gloo gathers H through the host) run at (4, 4096), which the world of
#     one also solves; the Hessian-free trust region starts from part (e)'s
#     near-optimum start, one drawn per lane; preconditioned L-BFGS from
#     the JAX test's -1.2 scaled by 1 + 0.05 k in lane k (from starts drawn
#     in [-2, 2] it takes 256-361 iterations, and two ranks part from one by
#     7.6e-3 in x at (8, 512) on the CPU, where from this start they agree
#     within 1.1e-12 at (8, 4096)).  The cuts keep the two ranks' part
#     within a minute beside the constrained and examples phases: to their
#     ends they took 29, 26, 49, 37 iterations (BFGS, Newton, the dense trust
#     region, preconditioned L-BFGS) and 59 s a rank on an H100 (gloo
#     takes every gather through the host), each equal to the world of
#     one.
DENSE_RUNS = [
    # (label, solver class, arguments, objective, mode, (B, n) in the
    #  world of one, (B, n) on the two ranks, start, iteration cut)
    ("bfgs", "Bfgs", {}, "quadratic", "first", (4, 16384), (4, 4096),
     "linspace", 10),
    ("newton", "NewtonDescent", {}, "rosenbrock", "second", (2, 4096),
     (2, 4096), "uniform", 10),
    ("tr", "TrustRegionNewton", {}, "rosenbrock", "second", (2, 4096),
     (2, 4096), "uniform", 15),
    ("tr_hessian_free", "TrustRegionNewton", {"hessian_free": True},
     "rosenbrock", "first", (4, MODEL_LBFGSB_N), (4, MODEL_LBFGSB_N),
     "near_optimum", 10),
    ("nm", "NelderMead", {}, "rosenbrock", "none", (256, 128), (256, 128),
     "uniform", 200),
    ("lbfgs_pre", "Lbfgs", {"m": 10, "use_hessian_preconditioner": True},
     "rosenbrock", "second", (8, 4096), (8, 4096), "classic", 15),
]
DENSE_XTOL = 1e-8
#: The iteration cut of the two ranks' second solve of each run, under the
#: collective log (which slows every operation): the collectives an
#: iteration come from it.
DENSE_LOG_ITERATIONS = 3
# The scaling harness (scaling_main, after part (f)): benchmarks_torch/
# scaling.py run as a user runs it (a subprocess, the default device and
# sizes: NCCL, a process a card, W = 1 up to the visible cards), its JSON
# line held (exit 0, backend "nccl", cards and sizes as the card reports,
# every rate finite and positive, the card named); then, in this process
# under a world of one (NCCL, a FileStore under build/, as parallel_main's),
# each leg's world-of-one solve at the harness's card sizes cut at
# SCALING_CUT iterations, bit-equal to the unsharded card solve: the batch
# leg to minimize_batched, the model and 2-D legs to the unsharded "xla"
# solve; status, nfev, iterations and x, and no launch on either side.
SCALING_CUT = 10
SCALING_TIMEOUT = 600
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {"float32": 67e12}  # H100 SXM, outside the tensor cores
# The calibration kernels (floors_main): launches each kernel is held to its
# plain version after (a trip loop's length, the launch chain's longer
# length), and the launches of each spin-padded timing run.
FLOOR_CHAIN = {"trip_floor": 900, "launch_floor": 1800}
FLOOR_TIMED_LAUNCHES = 200
FLOOR_TIMED_PLAIN_CALLS = 50
# Where each float32 kernel's drift from the exact answer is measured
# (float64 plain version on the same inputs upcast): the flat trip's
# direction, the prologues', the fused push's direction, the epilogue's
# pending step.
DRIFT_AT = {"flat_trip": (1024, 100), "lbfgs_prologue": (1024, 1024),
            "lbfgs_epilogue": (1024, 1024), "lbfgs_prologue_t": (512, 2048),
            "push_two_loop": (1024, 32)}


# The examples (examples_main): each examples_torch module's main("cuda"),
# held against its main("cpu"): float64 statuses equal, nfev within
# EXAMPLE_NFEV, iterations, x and f within EXAMPLE_TOL (the parity contract
# on full solves); linear_regression's float32 w within its own 5e-3 and
# statuses equal where the solve is not AL.  Each solve's launches: the
# kernels named here launch (flat_trip: once a trip), every other none.
EXAMPLE_MODULES = ("quickstart", "trust_region_rosenbrock", "expressions_tour",
                   "linear_regression", "constrained", "svm")
EXAMPLE_NFEV = 3
EXAMPLE_TOL = 1e-6
EXAMPLE_F32_TOL = 5e-3
NESTED = ("lbfgs_prologue", "mt_trip", "lbfgs_epilogue")
EXAMPLE_LAUNCHES = {
    "quickstart": {"lbfgs": ("flat_trip",), "gd": ("mt_trip",),
                   "bfgs": ("mt_trip",), "lbfgsb": ("mt_trip",)},
    # L-BFGS-B pins both of w's coordinates in its first walk, so every
    # step takes the Cauchy point with one evaluation and no search trip.
    "linear_regression": {"free": ("flat_trip",), "lbfgsb": (), "al": NESTED},
    "constrained": {"quadratic": NESTED, "circle": NESTED},
    "svm": {"primal-lbfgs": ("flat_trip",), "primal-al": NESTED,
            "dual-lbfgsb": ("mt_trip",), "dual-al": ("mt_trip",)},
}
#: The float32 examples' solves that are not AL (statuses held).
EXAMPLE_F32_STATUS = {"linear_regression": ("free", "lbfgsb")}
# pod_scale and entry_torch.dryrun_multichip(1) in a world of one under
# NCCL, dryrun_multichip(2) on two gloo ranks sharing the card: processes of
# their own, started first; what each must launch on the card.
EXAMPLE_RANK_TIMEOUT = 300
DRYRUN_LAUNCHES = {"lbfgs": ("flat_trip",), "lbfgsb": ("mt_trip",),
                   "al": NESTED, "mesh_2d": ()}


#: Where :func:`log` also writes, once ``main`` has opened it: the full log,
#: of which the GPU tool returns the last 24,000 bytes only.
LOG_PATH = os.path.join(ROOT, "chiprun_out", "chip_smoke.log")
_log_file = None


def log(msg: str) -> None:
    print(msg, flush=True)
    if _log_file is not None:
        _log_file.write(msg + "\n")
        _log_file.flush()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Mods:
    """The port's modules, imported once the GPU is known to be there."""

    def __init__(self):
        import cppnumericalsolvers_tpu_torch as cns
        from cppnumericalsolvers_tpu_torch.ops import _build, _kernel
        from cppnumericalsolvers_tpu_torch.ops import flat_solve as fs
        from cppnumericalsolvers_tpu_torch.ops import floors
        from cppnumericalsolvers_tpu_torch.ops import fused_linesearch as fl
        from cppnumericalsolvers_tpu_torch.ops import fused_step as fstep
        from cppnumericalsolvers_tpu_torch.ops import fused_step_t as ft
        from cppnumericalsolvers_tpu_torch.ops import two_loop as tl
        from cppnumericalsolvers_tpu_torch.solvers import lbfgs as lb
        from cppnumericalsolvers_tpu_torch.solvers import lbfgsb as lbb

        self.cns, self.build, self.fs, self.fl = cns, _build, fs, fl
        self.lbb = lbb
        #: The calibration kernels' wrappers and plain versions.
        self.floors = floors
        self.K = _kernel
        self.fstep, self.ft, self.tl, self.lb = fstep, ft, tl, lb
        #: Every kernel wrapper but ``flat_trip`` (each counts its launches)
        #: and its plain version, by the kernel's name.
        self.wrappers = {
            "lbfgs_prologue": fstep.lbfgs_prologue,
            "lbfgs_prologue_t": ft.lbfgs_prologue_t,
            "mt_trip": fl.mt_trip,
            "lbfgs_epilogue": fstep.lbfgs_epilogue,
            "push_two_loop": tl.lbfgs_push_and_direction,
            "two_loop": tl.two_loop_direction,
        }
        self.plain_all = {
            "lbfgs_prologue": fstep.lbfgs_prologue_reference,
            "lbfgs_prologue_t": ft.lbfgs_prologue_t_reference,
            "mt_trip": fl.mt_trip_reference,
            "lbfgs_epilogue": fstep.lbfgs_epilogue_reference,
            "push_two_loop": tl.lbfgs_push_and_direction_reference,
            "two_loop": tl.two_loop_direction_reference,
        }
        #: The nested path's three kernels, batch-major and batch-minor
        #: (path A), and path B's two.
        self.kernels, self.plain = self.pick(
            "lbfgs_prologue", "mt_trip", "lbfgs_epilogue")
        self.kernels_t, self.plain_t = self.pick(
            "lbfgs_prologue_t", "mt_trip", "lbfgs_epilogue")
        self.kernels_b, self.plain_b = self.pick("push_two_loop", "mt_trip")

    def pick(self, *names):
        return ({k: self.wrappers[k] for k in names},
                {k: self.plain_all[k] for k in names})

    def nested(self, batch_minor: bool):
        """``(kernels, plain versions, the prologue's name)`` of the
        iteration-granular loop on one history layout."""
        if batch_minor:
            return self.kernels_t, self.plain_t, "lbfgs_prologue_t"
        return self.kernels, self.plain, "lbfgs_prologue"

    @contextlib.contextmanager
    def layout(self, batch_minor: bool):
        """Route the iteration-granular loop to one history layout by
        setting the solver's class attributes, whatever they ship as."""
        cls = self.lb.Lbfgs
        old = cls._TRANSPOSED_N_MAX, cls._TRANSPOSED_B_MIN
        try:
            cls._TRANSPOSED_N_MAX = 1 << 30 if batch_minor else 0
            cls._TRANSPOSED_B_MIN = 1
            yield
        finally:
            cls._TRANSPOSED_N_MAX, cls._TRANSPOSED_B_MIN = old

    @contextlib.contextmanager
    def swapped(self, fns: dict):
        """Run the solves through ``fns`` (by kernel name) in place of the
        kernel wrappers: the plain versions, or wrappers that compare, time
        or count.  The names set are those the solver and the search look up
        at each call; a kernel that ``fns`` does not name keeps its wrapper,
        and the launch counts stay on the wrappers."""
        try:
            self._set(fns)
            yield
        finally:
            self._set({})

    def _set(self, fns: dict) -> None:
        def get(name):
            return fns.get(name, self.wrappers[name])

        self.lb.lbfgs_prologue = get("lbfgs_prologue")
        self.lb.lbfgs_prologue_t = get("lbfgs_prologue_t")
        self.lb.lbfgs_epilogue = get("lbfgs_epilogue")
        self.lb.lbfgs_push_and_direction = get("push_two_loop")
        self.fl.mt_trip = get("mt_trip")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run.",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    global _log_file
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    _log_file = open(LOG_PATH, "w")
    mods = Mods()
    cns, fs = mods.cns, mods.fs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    record = {"marks": []}
    t_start = time.perf_counter()

    def mark(label):
        """Seconds since the start at the end of each phase (the record's
        ``marks``): where the script's time limit goes."""
        record["marks"].append([label, time.perf_counter() - t_start])

    # 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    mods.build.build_all()
    for name in mods.build.KERNELS:
        mods.build.load(name)
    record["build_s"] = time.perf_counter() - t0
    log(f"[build] {', '.join(mods.build.KERNELS)}: "
        f"{record['build_s']:.2f} s")
    record["ptxas"] = {}
    for name in mods.build.KERNELS:
        for fn, regs, stores, loads, stack in mods.build.ptxas_report(name):
            record["ptxas"][fn] = [regs, stores, loads, stack]
            log(f"[build] {name} {fn}: {regs} registers, {stores} bytes "
                f"spill stores, {loads} bytes spill loads, {stack} bytes "
                "stack frame")

    mark("build")
    side = start_side()

    # 2. card ---------------------------------------------------------------
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    obj = cns.models.pairwise_rosenbrock()

    def start(b, n, dtype):
        rng = np.random.default_rng(SEED)
        x0 = rng.uniform(-2.0, 2.0, (b, n))
        return torch.from_numpy(x0).to(device=dev, dtype=dtype)

    # 3. parity, call by call -------------------------------------------------
    max_abs_err = {name: 0.0 for name in REPLACES}
    drift = {}

    def drifts(dname, b, n, *names):
        """The Drift records of ``names`` measured at (b, n) in float32."""
        if dname != "float32":
            return {}
        return {name: drift.setdefault(name, Drift(b, n))
                for name in names if DRIFT_AT[name] == (b, n)}

    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        for b, n in PARITY_SHAPES:
            r = parity(fs, obj, start(b, n, dtype), cns, dname,
                       drifts(dname, b, n, "flat_trip").get("flat_trip"))
            record[f"parity_{dname}_{b}x{n}"] = r
            check_parity("flat_trip", dname, b, n, r, max_abs_err)
            if r["launches"] < r["calls"]:
                raise AssertionError("flat_trip kernel did not launch")
        t0 = time.perf_counter()
        r = suite_parity(mods, dname)
        r["seconds"] = time.perf_counter() - t0
        record[f"suite_parity_{dname}"] = r
        check_parity("flat_trip", dname, "MGH-376", "2-40", r, max_abs_err)
        log(f"[parity] flat_trip {dname} at the suite's {len(r['shapes'])} "
            f"shapes {r['shapes']}: worst problem {r['worst_problem']}, "
            f"{r['seconds']:.1f} s")
        for b, n in NESTED_PARITY_SHAPES:
            t0 = time.perf_counter()
            nested, cover = nested_parity(
                mods, obj, start(b, n, dtype), dname,
                drift=drifts(dname, b, n, "lbfgs_prologue", "lbfgs_epilogue"))
            cover["seconds"] = time.perf_counter() - t0
            record[f"nested_parity_{dname}_{b}x{n}"] = {**nested,
                                                        "cover": cover}
            for name, r in nested.items():
                check_parity(name, dname, b, n, r, max_abs_err)
            log(f"[parity] nested {dname} ({b}, {n}) covered: "
                + json.dumps(cover))
            check_cover(cover, b, n)
        for b, n in T_PARITY_SHAPES:
            t0 = time.perf_counter()
            nested, cover = nested_parity(
                mods, obj, start(b, n, dtype), dname, batch_minor=True,
                drift=drifts(dname, b, n, "lbfgs_prologue_t"))
            cover["seconds"] = time.perf_counter() - t0
            record[f"path_a_parity_{dname}_{b}x{n}"] = {**nested,
                                                        "cover": cover}
            for name, r in nested.items():
                check_parity(name, dname, b, n, r, max_abs_err)
            log(f"[parity] batch-minor {dname} ({b}, {n}) covered: "
                + json.dumps(cover))
            check_cover(cover, b, n)
        made = [(shape, ("lbfgs_prologue", "lbfgs_prologue_t"))
                for shape in RESET_SHAPES]
        made += [(shape, ("lbfgs_prologue_t",)) for shape in T_MADE_UP_SHAPES]
        made += [(shape, ("push_two_loop",)) for shape in PUSH_PARITY_SHAPES]
        made += [(shape, ("two_loop",)) for shape in TWO_LOOP_PARITY_SHAPES]
        made += [(shape, ("lbfgs_epilogue",)) for shape in EPILOGUE_SHAPES]
        for (b, n), names in made:
            out = made_up_parity(mods, dname, b, n, names)
            record.setdefault(f"made_up_parity_{dname}_{b}x{n}", {}).update(
                out)
            for name, r in out.items():
                check_parity(name, dname, b, n, r, max_abs_err)
                if "history_resets" in r:
                    log(f"[parity] {name} {dname} ({b}, {n}) on made-up "
                        f"inputs: {r['history_resets']} invalid-descent "
                        "history resets")
                if "mappings" in r:
                    log(f"[parity] {name} {dname} ({b}, {n}) on made-up "
                        f"inputs: bit-equal under {len(r['mappings'])} "
                        f"mappings {r['mappings']}; bit-equal to the plain "
                        f"version: {r['equals_plain']}")
                if "row_modes" in r:
                    log(f"[parity] two_loop {dname} ({b}, {n}) on made-up "
                        f"inputs: shipped mapping {r['mapping']}, bit-equal "
                        f"under the row modes {r['row_modes']} and to "
                        "push_two_loop with valid off")
        for b, n in PATH_B_SHAPES:
            t0 = time.perf_counter()
            r = path_b_parity(
                mods, obj, start(b, n, dtype), dname,
                path_b_stopping(mods, obj, n, dtype,
                                PATH_B_CUT.get((b, n), 0)),
                drifts(dname, b, n, "push_two_loop").get("push_two_loop"))
            r["cover"]["seconds"] = time.perf_counter() - t0
            record[f"path_b_parity_{dname}_{b}x{n}"] = r
            check_parity("push_two_loop", dname, b, n, r, max_abs_err)
            log(f"[parity] path B {dname} ({b}, {n}) covered: "
                + json.dumps(r["cover"]))
            if min(r["cover"]["fired"], r["cover"]["full_history_pushes"],
                   r["cover"]["valid_off_lane_calls"]) <= 0:
                raise AssertionError(f"path B parity ({b}, {n}): {r}")
        b, n = EDGE_SHAPE
        x0 = start(b, n, dtype)
        x0[:EDGE_LANES] = 1.0
        x0[EDGE_LANES:2 * EDGE_LANES] *= 1e6
        x0[2 * EDGE_LANES:3 * EDGE_LANES] *= 1e9
        nested, cover = nested_parity(
            mods, obj, x0, dname,
            cns.default_stopping(dtype).replace(**EDGE_STOPPING))
        record[f"nested_parity_edge_{dname}"] = {**nested, "cover": cover}
        for name, r in nested.items():
            check_parity(name, dname, b, n, r, max_abs_err)
        log(f"[parity] nested {dname} ({b}, {n}) edge lanes covered: "
            + json.dumps(cover))
        check_cover(cover, b, n, edge=True)
        for key, shape in (("reach_parity", REACH_SHAPE),
                           ("device_q_parity", DEVICE_Q_SHAPE)):
            t0 = time.perf_counter()
            r = reach_parity(mods, obj, start(*shape, dtype), dname)
            r["seconds"] = time.perf_counter() - t0
            record[f"{key}_{dname}"] = r
            rows = {k: m["rows"] for k, m in r["mappings"].items()
                    if k in ("flat_trip", "lbfgs_prologue")}
            if (shape == DEVICE_Q_SHAPE) != all(
                    v == mods.K.ROWS_DEVICE_Q for v in rows.values()):
                raise AssertionError(f"reach ({shape}) {dname}: rows {rows}")
    mark("parity")
    record["drift"] = {name: d.result() for name, d in drift.items()}
    for name, r in record["drift"].items():
        log(f"[drift] {name} float32 {tuple(r['shape'])}: relative "
            f"distance to the float64 answer over {r['lanes']} lane-calls "
            f"({r['excluded_lane_calls']} left out): kernel median "
            f"{r['kernel_median']:.3e} worst {r['kernel_worst']:.3e}; plain "
            f"median {r['plain_median']:.3e} worst {r['plain_worst']:.3e}; "
            "kernel farther by more than 2x: median "
            f"{r['kernel_farther_2x_median']}, worst "
            f"{r['kernel_farther_2x_worst']}")

    # 4. main path ------------------------------------------------------------
    solver = cns.Lbfgs(m=M, max_linesearch_fev=MAX_FEV)
    stop32 = cns.default_stopping(torch.float32)
    main_launches = {name: 0 for name in REPLACES}
    shapes = []
    for b, n in MAIN_SHAPES:
        x0 = start(b, n, torch.float32)
        torch.cuda.synchronize()
        fs.flat_trip.launches = 0
        t0 = time.perf_counter()
        res = cns.minimize_batched(obj, x0, solver, stop32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fs.flat_trip.launches
        main_launches["flat_trip"] += launches
        if launches == 0 or launches != res.trips:
            raise AssertionError(
                f"({b}, {n}): {launches} kernel launches for {res.trips} "
                "trips")
        check_result(res, b, n, M)
        plain = fs.flat_lbfgs_solve(
            obj, obj.evaluate(x0), stop32, m=M, max_fev=MAX_FEV,
            trip=fs.flat_trip_reference,
        )
        agree = float(
            (res.progress.status == plain.progress.status)
            .float().mean())
        dnfev = abs(float(res.state.nfev.float().mean())
                    - float(plain.state.nfev.float().mean()))
        its = res.progress.num_iterations
        row = {
            "shape": [b, n], "dtype": "float32", "trips": res.trips,
            "launches": launches, "plain_trips": plain.trips,
            "status_agreement": agree, "mean_nfev_diff": dnfev,
            "batched_iterations": int(its.max()),
            "mean_iterations": float(its.float().mean()),
            "mean_nfev": float(res.state.nfev.float().mean()),
            "converged_share": converged_share(res, cns),
            "main_wall_s": wall,
            "lane_iterations_per_s": float(its.sum()) / wall,
            "mapping": vars(fs.lane_mapping("flat_trip", b, n, M, 4)),
        }
        log(f"[main] ({b}, {n}) float32: {res.trips} trips, {launches} "
            f"launches, {row['batched_iterations']} batched iterations, "
            f"status agreement {agree:.4f}, mean nfev diff {dnfev:.3f}, "
            f"converged {row['converged_share']:.4f}, wall {wall:.3f} s")
        if agree < 0.99 or dnfev >= 3.0:
            raise AssertionError(f"({b}, {n}) disagrees with plain: {row}")
        shapes.append(row)
        del res, plain

    x0 = start(256, 64, torch.float64)
    fs.flat_trip.launches = 0
    res = cns.minimize_batched(obj, x0, solver)
    main_launches["flat_trip"] += fs.flat_trip.launches
    check_result(res, 256, 64, M)
    plain = fs.flat_lbfgs_solve(
        obj, obj.evaluate(x0), cns.default_stopping(torch.float64), m=M,
        max_fev=MAX_FEV, trip=fs.flat_trip_reference,
    )
    same = {name: bool((getattr(res.progress, name)
                        == getattr(plain.progress, name)).all())
            for name in ("status", "num_iterations")}
    same["nfev"] = bool((res.state.nfev == plain.state.nfev).all())
    log(f"[main] (256, 64) float64: {res.trips} trips, equal on every lane: "
        f"{same}")
    if not all(same.values()) or fs.flat_trip.launches == 0:
        raise AssertionError("float64 main-path solve disagrees with plain")

    fs.flat_trip.launches = 0
    one = cns.minimize(cns.models.rosenbrock(),
                       torch.tensor([-1.2, 1.0], dtype=torch.float64), solver)
    main_launches["flat_trip"] += fs.flat_trip.launches
    err = float((one.state.x.cpu() - 1.0).abs().max())
    log(f"[main] minimize 2-D Rosenbrock: status "
        f"{int(one.progress.status)}, |x - 1| = {err:.2e}")
    if err > 1e-4 or fs.flat_trip.launches == 0:
        raise AssertionError("minimize did not reach the 2-D optimum")

    mark("main flat")
    nested_rows = []
    for b, n in NESTED_SHAPES:
        row = nested_main(mods, obj, start(b, n, torch.float32), solver,
                          stop32)
        for name, count in row["launches"].items():
            main_launches[name] += count
        nested_rows.append(row)

    path_a_rows = []
    for b, n in PATH_A_SHAPES:
        row = nested_main(mods, obj, start(b, n, torch.float32), solver,
                          stop32, batch_minor=True)
        for name, count in row["launches"].items():
            main_launches[name] += count
        path_a_rows.append(row)
    record["path_a"] = path_a_rows

    path_b_rows = []
    for b, n in PATH_B_SHAPES:
        dtype = getattr(torch, PATH_B_DTYPE[(b, n)])
        row = path_b_main(
            mods, obj, start(b, n, dtype), solver,
            path_b_stopping(mods, obj, n, dtype, PATH_B_CUT.get((b, n), 0)))
        for name, count in row["launches"].items():
            main_launches[name] += count
        path_b_rows.append(row)
    record["path_b"] = path_b_rows

    mark("nested, paths A and B")
    record["path_c"] = path_c_main(mods)
    for name, count in record["path_c"]["launches"].items():
        main_launches[name] += count

    t0 = time.perf_counter()
    side = wait_side(side)
    record["side_wait_s"] = time.perf_counter() - t0
    log(f"[main] waited {record['side_wait_s']:.1f} s for the side process")
    record["suite"] = suite_main(mods, side["suite_plain"])
    for name, count in record["suite"]["launches"].items():
        main_launches[name] += count

    t0 = time.perf_counter()
    record["solvers"] = [solvers_main(mods, obj, run) for run in SOLVER_RUNS]
    for row in record["solvers"]:
        for name, count in row["launches"].items():
            main_launches[name] += count
    record["solvers_phase_s"] = time.perf_counter() - t0
    log(f"[main] solvers: {record['solvers_phase_s']:.1f} s")
    mark("path C, suite, solvers")

    t0 = time.perf_counter()
    rank_procs = start_parallel_ranks()
    try:
        record["constrained"] = constrained_main(mods, dev)
        for name, count in record["constrained"]["launches"].items():
            main_launches[name] += count
        record["constrained_phase_s"] = time.perf_counter() - t0
        log(f"[main] constrained: {record['constrained_phase_s']:.1f} s")
        mark("constrained")

        t0 = time.perf_counter()
        record["examples"] = examples_main(mods, dev)
        for name, count in record["examples"]["launches"].items():
            main_launches[name] += count
        record["examples_phase_s"] = time.perf_counter() - t0
        log(f"[main] examples: {record['examples_phase_s']:.1f} s")
        mark("examples")

        t0 = time.perf_counter()
        record["parallel"] = parallel_main(mods, dev, rank_procs,
                                           side["blocks"])
    finally:
        for p in rank_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, count in record["parallel"]["launches"].items():
        main_launches[name] += count
    record["parallel_phase_s"] = time.perf_counter() - t0
    log(f"[main] parallel: {record['parallel_phase_s']:.1f} s "
        f"(waiting for the ranks {record['parallel']['ranks_s']:.1f} s)")
    mark("parallel")

    record["parallel_f"] = parallel_dense_record(
        side, record["parallel"].pop("dense_ranks"))
    mark("parallel (f)")

    t0 = time.perf_counter()
    record["scaling"] = scaling_main(mods, dev, card)
    record["scaling_phase_s"] = time.perf_counter() - t0
    log(f"[main] scaling: {record['scaling_phase_s']:.1f} s")
    mark("scaling")

    t0 = time.perf_counter()
    record["floors"] = floors_main(mods, dev)
    for name, count in record["floors"]["launches"].items():
        main_launches[name] += count
    for name, k in record["floors"]["kernels"].items():
        max_abs_err[name] = max(max_abs_err[name], k["max_abs_err"])
    record["floors_phase_s"] = time.perf_counter() - t0
    log(f"[main] floors: {record['floors_phase_s']:.1f} s")
    mark("floors")

    # 5. timing ---------------------------------------------------------------
    for row in shapes:
        b, n = row["shape"]
        row.update(timing(fs, obj, start(b, n, torch.float32), stop32))
        log(f"[time] ({b}, {n}) float32: kernel {row['ms']:.4f} ms/trip, "
            f"plain {row['plain_ms']:.4f} ms/trip, bound "
            f"{row['bound_ms']:.4f} ms/trip ({row['bound_by']}), solve "
            f"{row['solve_s']:.3f} s, {row['lane_iterations_per_s_timed']:.4g} "
            f"lane-iterations/s; per trip: evaluation {row['eval_ms']:.4f} "
            f"ms on the card, host clock {row['wall_ms_per_trip']:.4f} ms "
            f"(plain {row['plain_wall_ms_per_trip']:.4f} ms); "
            f"starved timed calls {row['starved_calls']} of "
            f"{row['padded_calls']}")
        log("[shape] " + json.dumps(row))
    record["shapes"] = shapes
    mark("flat timing")

    for row in nested_rows:
        b, n = row["shape"]
        x0 = start(b, n, torch.float32)
        row.update(nested_timing(mods, obj, x0, solver, stop32))
        row.update(path_compare(cns, obj, x0, solver, stop32))
        for name, k in row["kernels"].items():
            k["launches_per_solve"] = row[
                "nested_trips" if name == "mt_trip" else "nested_iterations"]
            log(f"[time] nested ({b}, {n}) float32 {name}: kernel "
                f"{k['ms']:.4f} ms/launch, plain {k['plain_ms']:.4f} "
                f"ms/call, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
                f"{k['launches_per_solve']} launches in a full solve")
        log(f"[time] nested ({b}, {n}) float32: evaluation "
            f"{row['eval_ms']:.4f} ms on the card; starved timed calls "
            f"{row['starved_calls']} of {row['padded_calls']}; full solve "
            f"on the host clock: nested {row['nested_solve_s']:.3f} s "
            f"({row['nested_iterations']} iterations, {row['nested_trips']} "
            f"evaluations), flat {row['flat_solve_s']:.3f} s "
            f"({row['flat_trips']} evaluations)")
        log("[nested] " + json.dumps(row))
    record["nested"] = nested_rows
    mark("nested timing")

    routing_rows = []
    for b, n in ROUTING_SHAPES:
        known = next((r for r in nested_rows
                      if tuple(r["shape"]) == (b, n)), None)
        routing_rows.append(routing(
            mods, obj, start(b, n, torch.float32), solver, stop32, known))
    record["routing"] = routing_rows
    mark("routing")

    op_rows = {"push_two_loop": [op_timing(mods, "push_two_loop", b, n)
                                 for b, n in PUSH_SHAPES],
               "two_loop": [op_timing(mods, "two_loop", b, n)
                            for b, n in TWO_LOOP_SHAPES]}
    for name, rows in op_rows.items():
        for r in rows:
            log(f"[time] {name} {tuple(r['shape'])} float32 on made-up "
                f"inputs: kernel {r['ms']:.4f} ms/launch, plain "
                f"{r['plain_ms']:.4f} ms/call, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}); starved timed calls "
                f"{r['starved_calls']} of {r['padded_calls']}")
    record["op_timing"] = op_rows
    mark("op timing")

    # 6. report ---------------------------------------------------------------
    head = next(r for r in shapes if tuple(r["shape"]) == HEADLINE_SHAPE)
    nhead = next(r for r in nested_rows if tuple(r["shape"]) == HEADLINE_SHAPE)
    timed = {"flat_trip": head, **nhead["kernels"]}
    timed["lbfgs_prologue_t"] = next(
        r for r in routing_rows if tuple(r["shape"]) == HEADLINE_SHAPE
    )["minor"]
    for name, rows in op_rows.items():
        timed[name] = next(
            r for r in rows if tuple(r["shape"]) == HEADLINE_SHAPE)
    timed.update(record["floors"]["kernels"])
    kernels = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"cppnumericalsolvers_tpu_torch/ops/csrc/{name}.cu",
        "replaces": REPLACES[name],
        "launches": main_launches[name],
        "max_abs_err": max_abs_err[name],
        "ms": timed[name]["ms"],
        "plain_ms": timed[name]["plain_ms"],
        "bound_ms": timed[name]["bound_ms"],
        "bound_by": timed[name]["bound_by"],
        "library_ms": timed[name].get("library_ms"),
        "shape": timed[name].get("shape", list(HEADLINE_SHAPE)),
        "dtype": "float32",
    } for name in REPLACES]}
    for k in kernels["kernels"]:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    record["kernels"] = kernels
    record["card"] = card
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def check_parity(name, dname, b, n, r, max_abs_err) -> None:
    """Log one kernel's parity figures and raise where they pass the stated
    tolerance: float64 no lane-call may differ, float32 at most 0.1%."""
    max_abs_err[name] = max(max_abs_err[name], r["max_abs_err"])
    log(f"[parity] {name} {dname} ({b}, {n}): {r['calls']} calls, "
        f"{r['mismatched_lane_calls']} mismatched lane-calls of "
        f"{r['lane_calls']}, max abs err {r['max_abs_err']:.3e}, "
        f"max scaled err {r['max_scaled_err']:.3e} "
        f"(worst field {r['worst_field']}), mismatches by field "
        f"{r['mismatched_by_field']}")
    if r["calls"] == 0:
        raise AssertionError(f"{name}: no call was compared")
    if dname == "float64" and r["mismatched_lane_calls"]:
        raise AssertionError(f"{name} float64 parity failed: {r}")
    if r["mismatched_lane_calls"] / r["lane_calls"] > F32_MISMATCH_SHARE:
        raise AssertionError(f"{name} float32 parity failed: {r}")


def converged_share(res, cns) -> float:
    import torch

    conv = torch.tensor(cns.CONVERGED_STATUSES, device=res.progress.status.device)
    return float(torch.isin(res.progress.status, conv).float().mean())


def check_result(res, b, n, m) -> None:
    """Finite values of the expected shapes; every lane has stopped."""
    st, pr, it = res.state, res.progress, res.internals
    shapes = {
        "x": (st.x, (b, n)), "value": (st.value, (b,)),
        "gradient": (st.gradient, (b, n)), "status": (pr.status, (b,)),
        "s_memory": (it.s_memory, (b, m, n)),
        "y_memory": (it.y_memory, (b, m, n)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise AssertionError(f"{name}: shape {tuple(t.shape)} != {shape}")
    for name in ("x", "value", "gradient"):
        if not bool(shapes[name][0].isfinite().all()):
            raise AssertionError(f"{name} is not finite")
    if bool((pr.status == 0).any()):
        raise AssertionError("a lane is still CONTINUE after the solve")


class Compare:
    """Accumulates, over many calls, the comparison of a kernel's outputs
    with its plain version's on the same inputs.  A lane-call is bad when an
    integer output differs, a non-finite value differs, or a float output is
    off by more than ``rtol`` (``rtol_of[name]`` where given) times its
    scale: the largest magnitude of the lane's vector, or the scalar itself.
    The errors reported are the largest over all lanes, bad ones included."""

    def __init__(self, rtol, rtol_of=None):
        self.rtol, self.rtol_of = rtol, rtol_of or {}
        self.calls = self.lane_calls = self.bad = 0
        self.max_abs = self.max_scaled = 0.0
        self.worst = ""
        self.bad_by_field = {}

    def add(self, b, ints, floats) -> None:
        """``ints``: name -> (kernel, plain); ``floats``: name -> (kernel,
        plain, is_vector).  Every tensor has ``b`` leading lanes."""
        import torch

        lane_bad = torch.zeros(b, dtype=torch.bool,
                               device=next(iter(ints.values()))[0].device)

        def mark(name, bad):
            nonlocal lane_bad
            lane_bad = lane_bad | bad
            count = int(bad.sum())
            if count:
                self.bad_by_field[name] = (
                    self.bad_by_field.get(name, 0) + count)

        for name, (k, p) in ints.items():
            mark(name, (k.reshape(b, -1) != p.reshape(b, -1)).any(1))
        for name, (k, p, vector) in floats.items():
            k, p = k.reshape(b, -1), p.reshape(b, -1)
            same_nonfinite = (
                (k.isnan() == p.isnan()).all(1)
                & ((k.isinf() & (k == p)) == p.isinf()).all(1))
            fin = p.isfinite() & k.isfinite()
            diff = torch.where(fin, (k - p).abs(), torch.zeros_like(p))
            mag = torch.where(fin, p.abs(), torch.zeros_like(p))
            scale = mag.amax(1, keepdim=True) if vector else mag
            scaled = diff / scale.clamp_min(torch.finfo(p.dtype).tiny)
            scaled = torch.where(diff == 0, torch.zeros_like(diff), scaled)
            rtol = self.rtol_of.get(name, self.rtol)
            mark(name, ~same_nonfinite | (scaled > rtol).any(1))
            self.max_abs = max(self.max_abs, float(diff.max()))
            sc = float(scaled.max())
            if sc > self.max_scaled:
                self.max_scaled, self.worst = sc, name
        self.bad += int(lane_bad.sum())
        self.calls += 1
        self.lane_calls += b

    def result(self, launches) -> dict:
        return {
            "calls": self.calls, "lane_calls": self.lane_calls,
            "mismatched_lane_calls": self.bad,
            "mismatched_by_field": self.bad_by_field,
            "max_abs_err": self.max_abs,
            "max_scaled_err": self.max_scaled, "worst_field": self.worst,
            "rtol": self.rtol, "launches": launches,
        }


class Drift:
    """How far a float32 kernel and its float32 plain version each land from
    the exact answer: the plain version's output on the same inputs upcast
    to float64.  Per lane-call, the largest difference over the vector
    divided by the float64 answer's largest magnitude; only lane-calls
    whose integer outputs agree across the three and whose values are
    finite count (a lane that took another branch is not a rounding
    distance)."""

    def __init__(self, b, n):
        self.shape = (b, n)
        self.kernel, self.plain, self.left_out = [], [], 0

    def add(self, kernel, plain, exact, keep) -> None:
        import torch

        b = exact.shape[0]
        k, p, e = (t.reshape(b, -1).double() for t in (kernel, plain, exact))
        keep = (keep & e.isfinite().all(1) & k.isfinite().all(1)
                & p.isfinite().all(1))
        scale = e.abs().amax(1).clamp_min(torch.finfo(torch.float64).tiny)
        self.kernel.append(((k - e).abs().amax(1) / scale)[keep])
        self.plain.append(((p - e).abs().amax(1) / scale)[keep])
        self.left_out += int((~keep).sum())

    def result(self) -> dict:
        import torch

        k, p = torch.cat(self.kernel), torch.cat(self.plain)
        out = {"shape": list(self.shape), "lanes": int(k.numel()),
               "excluded_lane_calls": self.left_out}
        for side, d in (("kernel", k), ("plain", p)):
            out[f"{side}_median"] = float(d.median()) if d.numel() else 0.0
            out[f"{side}_worst"] = float(d.max()) if d.numel() else 0.0
        for stat in ("median", "worst"):
            out[f"kernel_farther_2x_{stat}"] = (
                out[f"kernel_{stat}"] > 2 * out[f"plain_{stat}"])
        return out


def upcast(rec):
    """A copy of a record (a dataclass of tensors) with its floating-point
    fields in float64."""
    return type(rec)(**{k: v.double() if v.is_floating_point() else v.clone()
                        for k, v in vars(rec).items()})


def parity(fs, obj, x0, cns, dname, drift=None, stop=None) -> dict:
    """Feed the identical state to the kernel and the plain version at every
    trip of a plain-version flat solve (under ``stop``, by default the
    default stopping) and compare every output.  With ``drift`` (a
    :class:`Drift`) the trip also runs through the plain version on the
    inputs upcast to float64, and the lanes at an iteration boundary give the
    direction's distance to it."""
    import torch

    stop = stop or cns.default_stopping(x0.dtype)
    st, x_trial = fs.init_flat_state(obj.evaluate(x0), M, MAX_FEV)
    cmp = Compare(RTOL[dname])
    launches0 = fs.flat_trip.launches
    b = x0.shape[0]
    for _ in range(PARITY_TRIPS):
        if not bool((st.si[:, fs._I_STATUS] == 0).any()):
            break
        f_t, g_t = obj.batched_value_and_grad(x_trial)
        k_st, k_xt = st.clone(), x_trial.clone()
        fs.flat_trip(k_st, f_t, g_t, k_xt, stop, MAX_FEV)
        if drift is not None:
            d_st, d_xt = upcast(st), x_trial.double()
            fs.flat_trip_reference(d_st, f_t.double(), g_t.double(), d_xt,
                                   stop, MAX_FEV)
            its0 = st.si[:, fs._I_NUMIT].clone()
        fs.flat_trip_reference(st, f_t, g_t, x_trial, stop, MAX_FEV)
        torch.cuda.synchronize()
        if drift is not None:
            drift.add(k_st.sdir, st.sdir, d_st.sdir,
                      (st.si[:, fs._I_NUMIT] != its0)
                      & (k_st.si == st.si).all(1) & (d_st.si == st.si).all(1))
        floats = {"x_trial": (k_xt, x_trial, True)}
        for name in ("x0", "g0", "sdir", "gacc", "s", "y"):
            floats[name] = (getattr(k_st, name), getattr(st, name), True)
        floats["sf"] = (k_st.sf, st.sf, False)
        floats["ring"] = (k_st.ring, st.ring, False)
        cmp.add(b, {"si": (k_st.si, st.si)}, floats)
    return cmp.result(fs.flat_trip.launches - launches0)


def suite_parity(mods, dname) -> dict:
    """``parity`` at the MGH-376 suite's own shapes: at each of its 19
    (B, n) (B = 6-7, n = 2-40: one lane a block, a warp per lane with idle
    threads below n = 32 and a ragged second element above) the first
    problem of that shape from its starts, under the reliability stopping,
    PARITY_TRIPS trips each (all 58 problems took 117 s on an H100, this
    about a third of it).  The lane-calls of all are summed into one
    result, held to check_parity's tolerances."""
    import torch

    import suite_bench
    from cppnumericalsolvers_tpu_torch.models import mgh_benchmark_instances

    cns, fs = mods.cns, mods.fs
    dtype = getattr(torch, dname)
    stop = suite_bench.reliability_stopping(cns, dtype)
    total = {"calls": 0, "lane_calls": 0, "mismatched_lane_calls": 0,
             "mismatched_by_field": {}, "max_abs_err": 0.0,
             "max_scaled_err": 0.0, "worst_field": "", "launches": 0}
    shapes, worst = set(), ""
    for problem, starts in mgh_benchmark_instances(dtype_str=dname):
        if starts.shape in shapes:
            continue
        x0 = torch.from_numpy(starts).to(device=torch.device("cuda"),
                                         dtype=dtype)
        r = parity(fs, problem.objective, x0, cns, dname, stop=stop)
        if r["launches"] < r["calls"]:
            raise AssertionError(f"flat_trip did not launch on {problem.name}")
        shapes.add(starts.shape)
        for key in ("calls", "lane_calls", "mismatched_lane_calls",
                    "launches"):
            total[key] += r[key]
        for field, count in r["mismatched_by_field"].items():
            total["mismatched_by_field"][field] = (
                total["mismatched_by_field"].get(field, 0) + count)
        total["max_abs_err"] = max(total["max_abs_err"], r["max_abs_err"])
        if r["max_scaled_err"] > total["max_scaled_err"]:
            total["max_scaled_err"] = r["max_scaled_err"]
            total["worst_field"] = r["worst_field"]
            worst = problem.name
    total["shapes"] = sorted(shapes)
    total["problems"] = len(shapes)
    total["worst_problem"] = worst
    return total


def _clone_record(rec):
    return type(rec)(**{k: v.clone() for k, v in vars(rec).items()})


def nested_parity(mods, obj, x0, dname, stop=None, batch_minor=False,
                  drift=None):
    """During a plain-version solve of the iteration-granular path, run to
    its end under ``stop`` (the default criteria if None), every call's
    inputs go through the kernel and through the plain version, and every
    output is compared.  ``batch_minor`` takes the loop on the batch-minor
    history (``lbfgs_prologue_t``).  ``drift`` maps a kernel's name to a
    :class:`Drift`: the prologue's direction and the epilogue's pending
    step are then also measured against the plain version in float64.
    Returns the figures of each of the three kernels, and what the compared
    calls covered: lane-calls on
    done lanes (each kernel's early return), pushes into a full history,
    history resets, non-finite search results, and the statuses on which
    lanes left CONTINUE."""
    import torch

    cns, fl, fstep = mods.cns, mods.fl, mods.fstep
    b, n = x0.shape
    kernels, plain, pname = mods.nested(batch_minor)
    drift = drift or {}
    cmps = {name: Compare(RTOL[dname], {"ls_dir": DIRECTION_RTOL[dname]})
            for name in kernels}
    launches0 = {name: fn.launches for name, fn in kernels.items()}

    def rows(hist):
        """A history, in either layout, with the lanes leading."""
        return hist.t() if batch_minor else hist.reshape(b, -1)
    cover = {"prologue_done_lane_calls": 0, "full_history_pushes": 0,
             "prologue_history_resets": 0, "mt_trip_idle_lane_calls": 0,
             "epilogue_done_lane_calls": 0, "epilogue_stall_resets": 0,
             "epilogue_nonfinite_lane_calls": 0,
             "ended_on_status": {}}

    def prologue(x, g, s_mem, y_mem, count, gamma, s_new, y_new, valid, done,
                 *head):
        # The batch-minor loop passes its ring's head (path A).
        k = [t.clone() for t in (s_mem, y_mem, count, gamma, *head)]
        count0, newest0 = count.clone(), rows(s_mem)[:, -n:].clone()
        head0 = [h.clone() for h in head]
        kd, ka, kg, *_ = kernels[pname](
            x, g, *k[:4], s_new, y_new, valid, done, *k[4:])
        if pname in drift:
            up = [t.double() if t.is_floating_point() else t.clone()
                  for t in (x, g, s_mem, y_mem, count, gamma, s_new, y_new,
                            valid, done, *head)]
            exact = plain[pname](*up)
        out = plain[pname](
            x, g, s_mem, y_mem, count, gamma, s_new, y_new, valid, done,
            *head)
        torch.cuda.synchronize()
        if pname in drift:
            drift[pname].add(kd, out[0], exact[0],
                             ~done & (k[2] == count) & (up[4] == count))
        ints = {"mem_count": (k[2], count)}
        if head:
            ints["head"] = (k[4], head[0])
        cmps[pname].add(b, ints, {
            "ls_dir": (kd, out[0], True), "alpha_init": (ka, out[1], False),
            "dginit": (kg, out[2], False),
            "s_memory": (rows(k[0]), rows(s_mem), True),
            "y_memory": (rows(k[1]), rows(y_mem), True),
            "gamma": (k[3], gamma, False),
        })
        cover["prologue_done_lane_calls"] += int(done.sum())
        # A push into a full history shifts it (batch-major) or moves the
        # ring's head on (batch-minor).
        pushed = ((head[0] != head0[0]) if head
                  else (rows(s_mem)[:, -n:] != newest0).any(1))
        cover["full_history_pushes"] += int(((count0 >= M) & pushed).sum())
        cover["prologue_history_resets"] += int((count < count0).sum())
        if head:
            cover["heads_out_of_step_tiles"] = max(
                cover.get("heads_out_of_step_tiles", 0),
                mixed_tiles(head[0], done))
        return out

    def trip(x0_, sdir, f_t, g_t, st, max_fev):
        k = st.clone()
        cover["mt_trip_idle_lane_calls"] += int(
            (st.si[:, fl._I_INFO] != 0).sum())
        kernels["mt_trip"](x0_, sdir, f_t, g_t, k, max_fev)
        fl.mt_trip_reference(x0_, sdir, f_t, g_t, st, max_fev)
        torch.cuda.synchronize()
        cmps["mt_trip"].add(b, {"si": (k.si, st.si)}, {
            "x_trial": (k.x_trial, st.x_trial, True),
            "gacc": (k.gacc, st.gacc, True), "sf": (k.sf, st.sf, False),
        })

    def epilogue(state, x_ls, f_ls, g_ls, ls_nfev, count, s_pend, y_pend,
                 pvalid, done, progress, crit):
        ks, kp = _clone_record(state), _clone_record(progress)
        kc, ksp, kyp, kpv = (t.clone() for t in (count, s_pend, y_pend,
                                                 pvalid))
        count0 = count.clone()
        kernels["lbfgs_epilogue"](
            ks, x_ls, f_ls, g_ls, ls_nfev, kc, ksp, kyp, kpv, done, kp, crit)
        if "lbfgs_epilogue" in drift:
            es, ep = upcast(state), upcast(progress)
            ec, esp, eyp, epv = (t.double() if t.is_floating_point()
                                 else t.clone() for t in (count, s_pend,
                                                          y_pend, pvalid))
            fstep.lbfgs_epilogue_reference(
                es, x_ls.double(), f_ls.double(), g_ls.double(), ls_nfev, ec,
                esp, eyp, epv, done, ep, crit)
        out = fstep.lbfgs_epilogue_reference(
            state, x_ls, f_ls, g_ls, ls_nfev, count, s_pend, y_pend, pvalid,
            done, progress, crit)
        torch.cuda.synchronize()
        if "lbfgs_epilogue" in drift:
            drift["lbfgs_epilogue"].add(
                ksp, s_pend, esp, ~done & (kp.status == progress.status)
                & (ep.status == progress.status) & (ec == count))
        ints = {"nfev": (ks.nfev, state.nfev), "mem_count": (kc, count),
                "pending_valid": (kpv, pvalid)}
        for name in ("num_iterations", "x_delta_violations",
                     "f_delta_violations", "status", "past_pos"):
            ints[name] = (getattr(kp, name), getattr(progress, name))
        floats = {
            "x": (ks.x, state.x, True),
            "gradient": (ks.gradient, state.gradient, True),
            "s_pending": (ksp, s_pend, True),
            "y_pending": (kyp, y_pend, True),
            "value": (ks.value, state.value, False),
        }
        for name in ("x_delta", "f_delta", "gradient_norm", "past_ring",
                     "condition_hessian"):
            floats[name] = (getattr(kp, name), getattr(progress, name), False)
        cmps["lbfgs_epilogue"].add(b, ints, floats)
        cover["epilogue_done_lane_calls"] += int(done.sum())
        cover["epilogue_stall_resets"] += int((count < count0).sum())
        cover["epilogue_nonfinite_lane_calls"] += int(
            (~f_ls.isfinite() & ~done).sum())
        # ``done`` is the status on entry; a live lane whose status is set
        # now left CONTINUE in this call.
        ended = progress.status[~done & (progress.status != 0)]
        for code, lanes in zip(*(t.tolist() for t in
                                 ended.unique(return_counts=True))):
            name = cns.Status(code).name
            cover["ended_on_status"][name] = (
                cover["ended_on_status"].get(name, 0) + lanes)
        return out

    with mods.layout(batch_minor), mods.swapped({
            pname: prologue, "mt_trip": trip, "lbfgs_epilogue": epilogue}):
        res = cns.minimize_batched(
            obj, x0, cns.Lbfgs(m=M, max_linesearch_fev=MAX_FEV),
            stop or cns.default_stopping(x0.dtype), trace=1)
    cover["iterations"] = int(res.progress.num_iterations.max())
    cover["trips"] = res.trips
    return {name: cmps[name].result(fn.launches - launches0[name])
            for name, fn in kernels.items()}, cover


def reach_parity(mods, obj, x0, dname) -> dict:
    """The card's reach in n: at a width where the history rows are read in
    place, a flat solve and a nested solve warm-started from its end,
    through the entry points with the kernels and through the plain
    versions, cut at REACH_SHORT_CUT and at REACH_CUT iterations.  float64:
    status, nfev and iterations equal at both budgets, iterates within
    1e-12 at the short one; at the long one the largest iterate distance
    is recorded beside that of the plain flat solve against itself with
    its dot products summed in another order.  float32: the main path's
    tolerances (statuses equal on 99% of lanes, mean nfev within 3).  Where
    the shipped mode reads the rows in place with q in shared memory, the
    short solves are run again with q in device memory, bit for bit."""
    import torch

    cns, fs, K = mods.cns, mods.fs, mods.K
    b, n = x0.shape
    solver = cns.Lbfgs(m=M, max_linesearch_fev=MAX_FEV)
    want = ("flat_trip", "lbfgs_prologue", "mt_trip", "lbfgs_epilogue")
    row = {"shape": [b, n], "dtype": dname,
           "mappings": {k: vars(mods.K.lane_mapping(
               k, b, n, M, x0.element_size())) for k in want}}

    def distance(u, v):
        return float(((u - v).abs() / v.abs().clamp_min(1.0)).max())

    for cut in (REACH_SHORT_CUT, REACH_CUT):
        stop = cns.default_stopping(x0.dtype).replace(max_iterations=cut)
        torch.cuda.synchronize()
        for fn in mods.wrappers.values():
            fn.launches = 0
        fs.flat_trip.launches = 0
        flat = cns.minimize_batched(obj, x0, solver, stop)
        warm = cns.minimize_batched(obj, flat.state.x, solver, stop,
                                    internals=flat.internals)
        torch.cuda.synchronize()
        launches = {"flat_trip": fs.flat_trip.launches,
                    **{k: fn.launches for k, fn in mods.wrappers.items()
                       if fn.launches}}
        if any(launches.get(k, 0) <= 0 for k in want):
            raise AssertionError(
                f"reach ({b}, {n}) {dname}: launches {launches}")

        def plain_flat():
            return fs.flat_lbfgs_solve(obj, obj.evaluate(x0), stop, m=M,
                                       max_fev=MAX_FEV,
                                       trip=fs.flat_trip_reference)

        p_flat = plain_flat()
        with mods.swapped(mods.plain):
            p_warm = cns.minimize_batched(obj, flat.state.x, solver, stop,
                                          internals=flat.internals)
        held = dname == "float64" and cut == REACH_SHORT_CUT
        if cut == REACH_SHORT_CUT and all(
                row["mappings"][k]["rows"] == K.ROWS_DIRECT
                for k in ("flat_trip", "lbfgs_prologue")):
            # q in device memory must give the shipped mode's bits.
            with forced_rows(K, "flat_trip", K.ROWS_DEVICE_Q), \
                    forced_rows(K, "lbfgs_prologue", K.ROWS_DEVICE_Q):
                q_flat = cns.minimize_batched(obj, x0, solver, stop)
                q_warm = cns.minimize_batched(obj, q_flat.state.x, solver,
                                              stop, internals=q_flat.internals)
            row["device_q_bits"] = {
                "flat": same_bits(host_summary(q_flat), host_summary(flat)),
                "warm": same_bits(host_summary(q_warm), host_summary(warm))}
            log(f"[parity] reach ({b}, {n}) {dname}: flat and warm solves "
                "with q in device memory bit-equal to the shipped mode "
                f"{row['device_q_bits']}")
            if not all(all(v.values()) for v in row["device_q_bits"].values()):
                raise AssertionError(f"reach ({b}, {n}) {dname}: {row}")
        for label, k, p in (("flat", flat, p_flat), ("warm", warm, p_warm)):
            pairs = {"status": (k.progress.status, p.progress.status),
                     "nfev": (k.state.nfev, p.state.nfev),
                     "num_iterations": (k.progress.num_iterations,
                                        p.progress.num_iterations)}
            same = {key: bool((u == v).all())
                    for key, (u, v) in pairs.items()}
            r = {"equal": same, "max_x_err": distance(k.state.x, p.state.x),
                 "status_agreement": float(
                     (k.progress.status == p.progress.status)
                     .float().mean()),
                 "mean_nfev_diff": abs(
                     float(k.state.nfev.float().mean())
                     - float(p.state.nfev.float().mean())),
                 "iterations": int(k.progress.num_iterations.max()),
                 "launches": launches}
            if dname == "float64" and label == "flat" and not held:
                with reordered_sums(mods):
                    r["reordered_plain_max_x_err"] = distance(
                        plain_flat().state.x, p.state.x)
            row[f"{label}_{cut}"] = r
            log(f"[parity] reach ({b}, {n}) {dname} {label} solve cut at "
                f"{cut} iterations: equal {same}, largest x error "
                f"{r['max_x_err']:.3e} (relative above 1)"
                + (f", the plain solve against itself summed in another "
                   f"order {r['reordered_plain_max_x_err']:.3e}"
                   if "reordered_plain_max_x_err" in r else "")
                + f", status agreement {r['status_agreement']:.4f}, mean "
                f"nfev diff {r['mean_nfev_diff']:.3f}; launches {launches}")
            if dname == "float64" and not all(same.values()):
                raise AssertionError(f"reach parity ({b}, {n}): {row}")
            if held and r["max_x_err"] > 1e-12:
                raise AssertionError(f"reach parity ({b}, {n}): {row}")
            if r["status_agreement"] < 0.99 or r["mean_nfev_diff"] >= 3.0:
                raise AssertionError(f"reach parity ({b}, {n}): {row}")
    return row


@contextlib.contextmanager
def reordered_sums(mods):
    """The plain versions' dot products summed in another order: each of
    512 strided partial sums first, then those (the kernels' order with 512
    threads a lane) where n is a multiple of 512, else from the far end."""
    import torch

    def rdot(a, c):
        p = a * c
        n = p.shape[-1]
        if n % 512 == 0:
            return torch.sum(torch.sum(
                p.reshape(*p.shape[:-1], n // 512, 512), -2), -1)
        return torch.sum(p.flip(-1), -1)

    old = mods.fs._rdot, mods.tl._rdot
    mods.fs._rdot = mods.tl._rdot = rdot
    try:
        yield
    finally:
        mods.fs._rdot, mods.tl._rdot = old


def mixed_tiles(head, done, tile=8) -> int:
    """Tiles of ``tile`` neighbouring lanes whose live lanes' ring heads
    differ: the batch-minor prologue reads one sector per history element
    only where they agree."""
    import torch

    b = head.shape[0]
    pad = -b % tile
    h = torch.cat([head, head.new_full((pad,), -1)]).view(-1, tile)
    live = torch.cat([~done, done.new_zeros(pad)]).view(-1, tile)
    big = torch.where(live, h, torch.full_like(h, -1)).amax(1)
    small = torch.where(live, h, torch.full_like(h, 1 << 30)).amin(1)
    return int(((big >= 0) & (big != small)).sum())


def check_cover(cover, b, n, edge=False) -> None:
    """The compared calls must have reached each kernel's done-lane return,
    pushes into a full history, and every lane's end on a status; the edge
    solve also stall resets and at least three different statuses."""
    if edge and (cover["epilogue_stall_resets"] <= 0
                 or len(cover["ended_on_status"]) < 3):
        raise AssertionError(f"nested parity, edge lanes: {cover}")
    for key in ("prologue_done_lane_calls", "mt_trip_idle_lane_calls",
                "epilogue_done_lane_calls", "full_history_pushes"):
        if cover[key] <= 0:
            raise AssertionError(f"nested parity ({b}, {n}): no {key}")
    if sum(cover["ended_on_status"].values()) != b:
        raise AssertionError(
            f"nested parity ({b}, {n}): not every lane ended inside the "
            f"compared calls: {cover['ended_on_status']}")


def nested_main(mods, obj, x0, solver, stop, batch_minor=False) -> dict:
    """The iteration-granular path through its entry points: a traced solve
    cut by ``max_iterations``, ``resume`` to the end, and a warm start with
    ``internals=`` and ``trace=``.  The launch counts must match the
    iteration and trip counts; the resumed solve must equal the
    uninterrupted one bit for bit on at least 99% of lanes; statuses are
    held against the same solves through
    the plain versions on the card, and against the flat path.
    ``batch_minor`` is path A: the same on the batch-minor history, with
    the statuses also held against the batch-major loop's."""
    with mods.layout(batch_minor):
        return _nested_main(mods, obj, x0, solver, stop, batch_minor)


def _nested_main(mods, obj, x0, solver, stop, batch_minor) -> dict:
    import torch

    cns = mods.cns
    b, n = x0.shape
    kernels, plain_fns, pname = mods.nested(batch_minor)
    cut_stop = stop.replace(max_iterations=NESTED_CUT)

    def run():
        cut = cns.minimize_batched(obj, x0, solver, cut_stop,
                                   trace=NESTED_TRACE)
        return cut, cns.resume(obj, cut, solver, stop, trace=NESTED_TRACE)

    torch.cuda.synchronize()
    for fn in mods.wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    cut, res = run()
    warm = cns.minimize_batched(obj, x0, solver, stop,
                                internals=res.internals, trace=NESTED_TRACE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    other = {name: fn.launches for name, fn in mods.wrappers.items()
             if name not in kernels and fn.launches}
    if other:
        raise AssertionError(
            f"nested ({b}, {n}): kernels of another path ran: {other}")

    iterations = (
        int(cut.progress.num_iterations.max())
        + int((res.progress.num_iterations
               - cut.progress.num_iterations).max())
        + int(warm.progress.num_iterations.max()))
    trips = cut.trips + res.trips + warm.trips
    want = {pname: iterations, "mt_trip": trips,
            "lbfgs_epilogue": iterations}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(
            f"nested ({b}, {n}): launches {launches}, expected {want}")
    if not bool((cut.progress.status
                 == int(cns.Status.ITERATION_LIMIT)).any()):
        raise AssertionError("the cut solve did not stop on its limit")
    for r in (res, warm):
        check_result(r, b, n, M)
    tr = warm.trace
    if tuple(tr.value.shape) != (b, NESTED_TRACE) or not bool(
            tr.value[:, 0].isfinite().all()) or bool((tr.status[:, 0] < 0)
                                                     .any()):
        raise AssertionError(f"trace buffer is wrong: {tr.value.shape}")

    # The cut solve's trace holds its iterations, the resumed one's the
    # rest: together they are the uninterrupted solve's.  A lane may part
    # from the uninterrupted run only through the plateau ring, which lacks
    # the value of the iteration the limit fired on.
    full = cns.minimize_batched(obj, x0, solver, stop, trace=NESTED_TRACE)
    traced = cut.trace.value.where(cut.trace.status >= 0, res.trace.value)
    same_lane = ((full.state.x == res.state.x).all(1)
                 & (full.state.nfev == res.state.nfev)
                 & (full.progress.status == res.progress.status)
                 & ((full.trace.value == traced)
                    | (full.trace.value.isnan() & traced.isnan())).all(1))
    resumed_equal = float(same_lane.float().mean())
    with mods.swapped(plain_fns):
        _, plain = run()
    flat = cns.minimize_batched(obj, x0, solver, stop)
    if batch_minor:
        with mods.layout(False):
            _, major = run()

    def against(other):
        agree = float((res.progress.status == other.progress.status)
                      .float().mean())
        dnfev = abs(float(res.state.nfev.float().mean())
                    - float(other.state.nfev.float().mean()))
        return agree, dnfev

    agree, dnfev = against(plain)
    flat_agree, flat_dnfev = against(flat)
    row = {
        "shape": [b, n], "dtype": "float32", "launches": launches,
        "layout": "batch-minor" if batch_minor else "batch-major",
        "iterations": iterations, "trips": trips,
        "cut_iterations": int(cut.progress.num_iterations.max()),
        "resumed_equals_uninterrupted": resumed_equal,
        "status_agreement": agree, "mean_nfev_diff": dnfev,
        "flat_status_agreement": flat_agree,
        "flat_mean_nfev_diff": flat_dnfev,
        "mean_nfev": float(res.state.nfev.float().mean()),
        "converged_share": converged_share(res, cns),
        "warm_iterations": int(warm.progress.num_iterations.max()),
        "main_wall_s": wall,
    }
    if batch_minor:
        row["major_status_agreement"], row["major_mean_nfev_diff"] = against(
            major)
        if not isinstance(res.internals, mods.lb.LbfgsInternals):
            raise AssertionError("path A returned batch-minor internals")
        log(f"[main] path A ({b}, {n}): against the batch-major loop: "
            f"status agreement {row['major_status_agreement']:.4f}, mean "
            f"nfev diff {row['major_mean_nfev_diff']:.3f}")
        if (row["major_status_agreement"] < 0.99
                or row["major_mean_nfev_diff"] >= 3.0):
            raise AssertionError(
                f"path A ({b}, {n}) disagrees with the batch-major loop: "
                f"{row}")
    log(f"[main] nested {row['layout']} ({b}, {n}) float32: cut at "
        f"{row['cut_iterations']} iterations, resumed and warm-started: "
        f"{iterations} iterations, {trips} search trips, launches "
        f"{launches}; resumed equals uninterrupted on "
        f"{resumed_equal:.4f} of lanes; "
        f"against the plain versions: status agreement {agree:.4f}, mean "
        f"nfev diff {dnfev:.3f}; against the flat path: status agreement "
        f"{flat_agree:.4f}, mean nfev diff {flat_dnfev:.3f}; converged "
        f"{row['converged_share']:.4f}, wall {wall:.3f} s")
    if resumed_equal < 0.99:
        raise AssertionError(f"nested ({b}, {n}): resume changed the solve")
    if agree < 0.99 or dnfev >= 3.0:
        raise AssertionError(f"nested ({b}, {n}) disagrees with plain: {row}")
    return row


class Timed:
    """Records CUDA events around each call of ``fn``.  With ``pad_cycles``
    a spin kernel (``torch.cuda._sleep``) goes before each call and keeps
    the card busy while the host enqueues the work, so the events measure
    the work and not the host's launch gaps; a call whose start event had
    already passed when its work was enqueued is counted as starved."""

    def __init__(self, fn, pad_cycles):
        self.fn, self.pad, self.events, self.starved = fn, pad_cycles, [], 0

    def __call__(self, *args):
        import torch

        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        if self.pad:
            torch.cuda._sleep(self.pad)
        a.record()
        out = self.fn(*args)
        if self.pad and a.query():
            self.starved += 1
        z.record()
        self.events.append((a, z))
        return out

    def mean_ms(self):
        return sum(a.elapsed_time(z) for a, z in self.events) / len(
            self.events)


class TimedObjective:
    """``obj`` with its batched evaluation timed."""

    def __init__(self, obj, pad_cycles):
        self.mode, self.evaluate = obj.mode, obj.evaluate
        self.batched_value_and_grad = Timed(obj.batched_value_and_grad,
                                            pad_cycles)


# About 10 ms and 50 ms of spin at the H100's clock: several times what the
# host takes to enqueue an evaluation or a kernel call (about 2 ms) and a
# plain call (about 13 ms).
KERNEL_PAD, PLAIN_PAD = 20_000_000, 100_000_000


def nested_timing(mods, obj, x0, solver, stop, batch_minor=False,
                  with_plain=True) -> dict:
    """Device time per call of the three nested-path kernels and of their
    plain versions (spin-padded solves cut at NESTED_TIMED_ITERATIONS, in
    the order plain, kernel, kernel, plain), and the least time each call's
    data needs on this card.  ``batch_minor`` times the loop on the
    batch-minor history; ``with_plain=False`` leaves the plain solves out."""
    with mods.layout(batch_minor):
        return _nested_timing(mods, obj, x0, solver, stop, batch_minor,
                              with_plain)


def _nested_timing(mods, obj, x0, solver, stop, batch_minor, with_plain):
    import torch

    cns = mods.cns
    kernels, plain_fns, _ = mods.nested(batch_minor)
    cut = stop.replace(max_iterations=NESTED_TIMED_ITERATIONS)

    def solve(fns, pad):
        timed = {name: Timed(fn, pad) for name, fn in fns.items()}
        tobj = TimedObjective(obj, KERNEL_PAD)
        with mods.swapped(timed):
            res = cns.minimize_batched(tobj, x0, solver, cut, trace=1)
        torch.cuda.synchronize()
        ev = tobj.batched_value_and_grad
        calls = list(timed.values()) + [ev]
        return {
            **{name: t.mean_ms() for name, t in timed.items()},
            "eval_ms": ev.mean_ms(), "trips": res.trips,
            "starved": sum(t.starved for t in calls),
            "calls": sum(len(t.events) for t in calls),
        }

    runs = {"plain": [], "kernel": []}
    order = ("plain", "kernel", "kernel", "plain") if with_plain else (
        "kernel", "kernel")
    for which in order:
        plain = which == "plain"
        runs[which].append(solve(plain_fns if plain else kernels,
                                 PLAIN_PAD if plain else KERNEL_PAD))
    work = nested_work(mods, obj, x0, solver, cut, batch_minor)

    def mean(which, key):
        if not runs[which]:
            return None
        return sum(r[key] for r in runs[which]) / len(runs[which])

    every = runs["plain"] + runs["kernel"]
    return {
        "kernels": {name: {
            "ms": mean("kernel", name), "plain_ms": mean("plain", name),
            "ms_runs": [r[name] for r in runs["kernel"]],
            **work[name],
        } for name in kernels},
        "eval_ms": mean("kernel", "eval_ms"),
        "timed_iterations": NESTED_TIMED_ITERATIONS,
        "starved_calls": sum(r["starved"] for r in every),
        "padded_calls": sum(r["calls"] for r in every),
    }


def nested_work(mods, obj, x0, solver, stop, batch_minor=False) -> dict:
    """Bytes and operations the calls of one nested solve need, lane by
    lane, each input read once and each output written once.

    ``mt_trip``: a searching lane reads g_t, the direction and x0 and writes
    the accepted gradient and the trial point; a lane whose search is over
    reads its info code.  ``lbfgs_prologue``: a live lane reads x, g and the
    pending pair, reads the history rows its two-loop uses, writes the rows
    that changed (one, or all m when a full history shifts) and the
    direction; a done lane writes a zero direction.  ``lbfgs_prologue_t``:
    the same, but its history is a ring, so an accepted pair writes one row
    pair whether or not the history is full, and a live lane reads and
    writes its head; the count with a shifting history is kept beside it
    (``bound_ms_shift``).  ``lbfgs_epilogue``: a
    live lane reads x0, g0 and the search's x and g and writes x, g and the
    pending pair; a done lane reads its flag.  Scalars count for live lanes."""
    import torch

    cns, fl = mods.cns, mods.fl
    n = x0.shape[1]
    w = x0.element_size()
    eps = torch.finfo(x0.dtype).eps
    kernels, _, pname = mods.nested(batch_minor)
    tot = {name: {"bytes": 0.0, "ops": 0.0, "calls": 0}
           for name in (*kernels, "shift")}

    def add(name, byts, ops):
        tot[name]["bytes"] += float(byts.sum())
        tot[name]["ops"] += float(ops.sum())
        tot[name]["calls"] += 1

    def prologue(x, g, s_mem, y_mem, count, gamma, s_new, y_new, valid, done,
                 *head):
        live = ~done
        sy, s2, y2 = ((a * c).sum(1) for a, c in
                      ((s_new, y_new), (s_new, s_new), (y_new, y_new)))
        accept = valid & live & (sy > eps * s2.sqrt() * y2.sqrt())
        c0 = count.long()
        full = c0 >= M
        c1 = torch.where(accept & ~full, c0 + 1, c0)
        hist_read = 2 * n * (c1 - accept.long()).clamp(min=0)
        shift_write = torch.where(
            accept, torch.where(full, 2 * M * n, 2 * n), 0)
        # The batch-minor history is a ring (a head read and written per
        # live lane): an accepted pair writes one row pair.  The
        # batch-major history shifts.
        hist_write = torch.where(accept, 2 * n, 0) if head else shift_write
        scal = torch.where(live, 4 * w + 2 * 4 + 2 + (8 if head else 0),
                           2 * w + 1)
        ops = torch.where(live, 14 * n + 10 * n * c1, 0)
        add(pname, torch.where(live, 5 * n + hist_read + hist_write, n) * w
            + scal, ops)
        if head:
            add("shift", torch.where(
                live, 5 * n + hist_read + shift_write, n) * w + scal, ops)
        return kernels[pname](
            x, g, s_mem, y_mem, count, gamma, s_new, y_new, valid, done,
            *head)

    def trip(x0_, sdir, f_t, g_t, st, max_fev):
        active = st.si[:, fl._I_INFO] == 0
        scal = (2 * fl._NF + 1) * w + 2 * fl._NI * 4
        add("mt_trip", torch.where(active, 5 * n * w + scal, 4),
            torch.where(active, 4 * n, 0))
        kernels["mt_trip"](x0_, sdir, f_t, g_t, st, max_fev)

    def epilogue(state, x_ls, f_ls, g_ls, ls_nfev, count, s_pend, y_pend,
                 pvalid, done, progress, crit):
        live = ~done
        scal = (2 + 3 + 2 * 8) * w + 12 * 4 + 2
        add("lbfgs_epilogue", torch.where(live, 8 * n * w + scal, 1),
            torch.where(live, 8 * n, 0))
        return kernels["lbfgs_epilogue"](
            state, x_ls, f_ls, g_ls, ls_nfev, count, s_pend, y_pend, pvalid,
            done, progress, crit)

    with mods.layout(batch_minor), mods.swapped({
            pname: prologue, "mt_trip": trip, "lbfgs_epilogue": epilogue}):
        cns.minimize_batched(obj, x0, solver, stop, trace=1)
    dname = str(x0.dtype).split(".")[1]
    out = {}
    for name, t in tot.items():
        if not t["calls"]:
            continue
        bytes_ms = t["bytes"] / t["calls"] / HBM_BYTES_PER_S * 1e3
        ops_ms = t["ops"] / t["calls"] / PEAK_OPS_PER_S[dname] * 1e3
        out[name] = {
            "bytes_per_call": t["bytes"] / t["calls"],
            "ops_per_call": t["ops"] / t["calls"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
    if "shift" in out:
        # The same calls counted with a shifting history, as before the
        # batch-minor history became a ring.
        shift = out.pop("shift")
        out[pname]["bytes_per_call_shift"] = shift["bytes_per_call"]
        out[pname]["bound_ms_shift"] = shift["bound_ms"]
    return out


def path_compare(cns, obj, x0, solver, stop) -> dict:
    """Whole solves to the end on the host clock, flat, nested, nested,
    flat: the same algorithm through the two loops."""
    import torch

    def solve(nested):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cns.minimize_batched(obj, x0, solver, stop,
                                   trace=1 if nested else 0)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    walls = {False: [], True: []}
    for nested in (False, True, True, False):
        res, wall = solve(nested)
        walls[nested].append(wall)
        if nested:
            nres = res
        else:
            fres = res
    its = nres.progress.num_iterations
    mean = {k: sum(v) / len(v) for k, v in walls.items()}
    return {
        "nested_solve_s": mean[True], "flat_solve_s": mean[False],
        "nested_solve_s_runs": walls[True], "flat_solve_s_runs": walls[False],
        "nested_iterations": int(its.max()), "nested_trips": nres.trips,
        "flat_trips": fres.trips,
        "nested_lane_iterations_per_s": float(its.sum()) / mean[True],
        "flat_lane_iterations_per_s": float(
            fres.progress.num_iterations.sum()) / mean[False],
    }


def timing(fs, obj, x0, stop) -> dict:
    """Per-trip time of the kernel and of the plain version, each solve run
    in the order plain, kernel, kernel, plain, and the least time each
    trip's data needs on this card.  The kernel's solves run to their end;
    the plain version's are cut at NESTED_TIMED_ITERATIONS iterations (its
    trip takes about 20 ms of host time and, spin-padded, 50 ms of the
    card's: whole plain solves cost the script about 110 s at the four
    shapes).

    Two kinds of solve.  Host-clock solves time whole trips as a user sees
    them.  Device solves give the card's own time (spin-padded, see
    :class:`Timed`); the device figures hold only where the count of starved
    calls is 0."""
    import torch

    def solve(trip, device_time):
        state0 = obj.evaluate(x0)
        plain = trip is fs.flat_trip_reference
        pad = (PLAIN_PAD if plain else KERNEL_PAD) if device_time else 0
        trip, tobj = Timed(trip, pad), TimedObjective(obj, pad and KERNEL_PAD)
        cut = (stop.replace(max_iterations=NESTED_TIMED_ITERATIONS) if plain
               else stop)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fs.flat_lbfgs_solve(tobj, state0, cut, m=M, max_fev=MAX_FEV,
                                  trip=trip)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev = tobj.batched_value_and_grad
        return {
            "trip_ms": trip.mean_ms(), "eval_ms": ev.mean_ms(), "wall": wall,
            "wall_ms_per_trip": wall / res.trips * 1e3,
            "lane_iterations": float(res.progress.num_iterations.sum()),
            "starved": trip.starved + ev.starved,
            "calls": len(trip.events) + len(ev.events),
        }

    runs = {}
    for device_time in (False, True):
        for which in ("plain", "kernel", "kernel", "plain"):
            trip = fs.flat_trip if which == "kernel" else fs.flat_trip_reference
            runs.setdefault((which, device_time), []).append(
                solve(trip, device_time))
    from benchmarks_torch.roofline import trip_work

    work = trip_work(obj, x0, stop, m=M, max_fev=MAX_FEV)
    del work["trips"]  # the row has the solve's own

    def mean(which, device_time, key):
        rs = runs[(which, device_time)]
        return sum(r[key] for r in rs) / len(rs)

    padded = [r for k, rs in runs.items() if k[1] for r in rs]
    return {
        "starved_calls": sum(r["starved"] for r in padded),
        "padded_calls": sum(r["calls"] for r in padded),
        # Device time per trip (spin-padded solves).
        "ms": mean("kernel", True, "trip_ms"),
        "plain_ms": mean("plain", True, "trip_ms"),
        "kernel_ms_runs": [r["trip_ms"] for r in runs[("kernel", True)]],
        "plain_ms_runs": [r["trip_ms"] for r in runs[("plain", True)]],
        "eval_ms": mean("kernel", True, "eval_ms"),
        # Host clock (unpadded solves): whole trips and whole solves.
        "wall_ms_per_trip": mean("kernel", False, "wall_ms_per_trip"),
        "plain_wall_ms_per_trip": mean("plain", False, "wall_ms_per_trip"),
        "kernel_span_ms": mean("kernel", False, "trip_ms"),
        "eval_span_ms": mean("kernel", False, "eval_ms"),
        "solve_s": mean("kernel", False, "wall"),
        "plain_timed_iterations": NESTED_TIMED_ITERATIONS,
        "lane_iterations_per_s_timed": (
            mean("kernel", False, "lane_iterations")
            / mean("kernel", False, "wall")),
        **work,
    }


def made_up(b, n, dtype, dev, seed=SEED):
    """Made-up inputs for the prologue and two-loop kernels, from a seed:
    histories as a solve leaves them (``y`` near ``s``), with counts 0,
    partly filled and full, rows whose ``s.y`` is 0 (the recursion skips
    them), pending pairs that the curvature gate rejects, zero pairs, lanes
    with ``valid`` off, done lanes, and live lanes with a zero or a NaN
    gradient (no descent direction: the history resets)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=dev, dtype=dt)

    lanes = np.arange(b)
    count = rng.integers(0, M + 1, b)
    count[lanes % 7 == 0] = M
    count[lanes % 7 == 1] = 0
    s = 0.1 * rng.standard_normal((b, M, n))
    y = s + 0.05 * rng.standard_normal((b, M, n))
    y[lanes % 11 == 3, 0] = 0.0  # |s.y| < eps on the oldest row
    s_new = 0.1 * rng.standard_normal((b, n))
    y_new = s_new + 0.02 * rng.standard_normal((b, n))
    y_new[lanes % 5 == 2] *= -1.0  # negative curvature: rejected
    s_new[lanes % 13 == 4] = 0.0
    y_new[lanes % 13 == 4] = 0.0
    g = rng.standard_normal((b, n))
    done = lanes % 4 == 1
    g[lanes % 16 == 2] = 0.0
    g[lanes % 64 == 6, 0] = np.nan
    return {
        "x": t(rng.standard_normal((b, n))), "g": t(g), "s": t(s), "y": t(y),
        "count": t(count, torch.int32), "gamma": t(rng.uniform(0.5, 2.0, b)),
        "s_new": t(s_new), "y_new": t(y_new),
        "valid": t(rng.random(b) < 0.8, torch.bool),
        "done": t(done, torch.bool),
    }


def made_up_parity(mods, dname, b, n, names) -> dict:
    """Each kernel of ``names`` against its plain version on one call with
    made-up inputs; the prologues must have reset histories, the fused push
    must have kept every bit of its ``valid = False`` lanes."""
    import torch

    dev = torch.device("cuda")
    a = made_up(b, n, getattr(torch, dname), dev)
    ft = mods.ft
    out = {}

    def compare(name, ints, floats):
        if name not in cmps:
            cmps[name] = Compare(RTOL[dname], {
                "ls_dir": DIRECTION_RTOL[dname],
                "direction": DIRECTION_RTOL[dname]})
        torch.cuda.synchronize()
        cmps[name].add(b, ints, floats)
        out[name] = cmps[name].result(cmps[name].calls)

    cmps = {}
    for name in names:
        if name in ("lbfgs_prologue", "lbfgs_prologue_t"):
            minor = name == "lbfgs_prologue_t"
            conv = ft.history_rows_to_t if minor else torch.clone
            rows = (lambda h: h.t()) if minor else (
                lambda h: h.reshape(b, -1))
            # The batch-minor op runs chronological (no head) and on a
            # ring whose heads differ from lane to lane.
            heads = [()]
            if minor:
                heads.append((torch.arange(b, device=dev, dtype=torch.int32)
                              * 7 % M,))
            resets = 0
            first = None
            for head in heads:
                k = [conv(a["s"]), conv(a["y"]), a["count"].clone(),
                     a["gamma"].clone(), *(h.clone() for h in head)]
                p = [conv(a["s"]), conv(a["y"]), a["count"].clone(),
                     a["gamma"].clone(), *(h.clone() for h in head)]
                rest = (a["s_new"], a["y_new"], a["valid"], a["done"])
                kd, ka, kg, *_ = mods.wrappers[name](
                    a["x"], a["g"], *k[:4], *rest, *k[4:])
                pd, pa, pg, *_ = mods.plain_all[name](
                    a["x"], a["g"], *p[:4], *rest, *p[4:])
                first = first or (kd, ka, kg)
                ints = {"mem_count": (k[2], p[2])}
                if head:
                    ints["head"] = (k[4], p[4])
                compare(name, ints, {
                    "ls_dir": (kd, pd, True), "alpha_init": (ka, pa, False),
                    "dginit": (kg, pg, False),
                    "s_memory": (rows(k[0]), rows(p[0]), True),
                    "y_memory": (rows(k[1]), rows(p[1]), True),
                    "gamma": (k[3], p[3], False)})
                resets += int(
                    ((k[2] == 0) & (a["count"] > 0) & ~a["done"]).sum())
                frozen = all(bool((rows(new)[a["done"]] == rows(conv(old))[
                    a["done"]]).all()) for new, old in zip(k[:2], (a["s"],
                                                                   a["y"])))
                if head:
                    frozen &= bool((k[4] == head[0])[a["done"]].all())
                if not frozen or not bool((kd[a["done"]] == 0).all()):
                    raise AssertionError(
                        f"{name} {dname} ({b}, {n}) on made-up inputs: done "
                        "lanes not frozen")
            out[name]["history_resets"] = resets
            if minor:
                # The batch-minor kernel adds its sums in the batch-major
                # kernel's order: on the same (chronological) inputs the two
                # agree bit for bit (recorded, not required).
                k = [a["s"].clone(), a["y"].clone(), a["count"].clone(),
                     a["gamma"].clone()]
                md, ma, mg, *_ = mods.wrappers["lbfgs_prologue"](
                    a["x"], a["g"], *k, *rest)
                torch.cuda.synchronize()
                out[name]["equals_batch_major_kernel"] = all(
                    bool(((u == v) | (u.isnan() & v.isnan())).all())
                    for u, v in zip(first, (md, ma, mg)))
                log(f"[parity] {name} {dname} ({b}, {n}) on made-up inputs "
                    "(chronological) bit-equal to lbfgs_prologue: "
                    f"{out[name]['equals_batch_major_kernel']}")
            if resets <= 0:
                raise AssertionError(
                    f"{name} {dname} ({b}, {n}) on made-up inputs: no "
                    "history reset")
        elif name == "push_two_loop":
            k = [t.clone() for t in (a["s"], a["y"], a["count"], a["gamma"])]
            p = [t.clone() for t in (a["s"], a["y"], a["count"], a["gamma"])]
            rest = (a["s_new"], a["y_new"], a["valid"])
            kd, *_ = mods.wrappers[name](a["g"], *k, *rest)
            pd, *_ = mods.plain_all[name](a["g"], *p, *rest)
            compare(name, {"mem_count": (k[2], p[2])}, {
                "direction": (kd, pd, True), "s_memory": (k[0], p[0], True),
                "y_memory": (k[1], p[1], True), "gamma": (k[3], p[3], False)})
            if mods.K.lane_mapping(name, b, n, M,
                                   kd.element_size()).threads_per_lane > 32:
                # q in device memory must give the shipped mode's bits.
                q = [t.clone() for t in (a["s"], a["y"], a["count"],
                                         a["gamma"])]
                with forced_rows(mods.K, name, mods.K.ROWS_DEVICE_Q):
                    qd, *_ = mods.wrappers[name](a["g"], *q, *rest)
                torch.cuda.synchronize()
                same = all(torch.equal(bits(u), bits(v))
                           for u, v in zip((qd, *q), (kd, *k)))
                out[name]["device_q_bits"] = same
                if not same:
                    raise AssertionError(
                        f"push_two_loop {dname} ({b}, {n}): q in device "
                        "memory differs from the shipped mode")
            off = ~a["valid"]
            kept = all(bool((new[off] == old[off]).all()) for new, old in zip(
                k, (a["s"], a["y"], a["count"], a["gamma"])))
            if not kept or not bool(off.any()):
                raise AssertionError(
                    f"push_two_loop {dname} ({b}, {n}): a lane with valid "
                    "off did not keep every bit")
        elif name == "two_loop":
            args = (a["g"], a["s"], a["y"], a["count"], a["gamma"])
            kd = mods.wrappers[name](*args)
            pd = mods.plain_all[name](*args)
            compare(name, {"mem_count": (a["count"], a["count"])},
                    {"direction": (kd, pd, True)})
            fin = pd.isfinite()
            if not (torch.equal(fin, kd.isfinite()) and torch.allclose(
                    kd[fin], pd[fin], **TWO_LOOP_ELEMENT_TOL[dname])):
                raise AssertionError(
                    f"two_loop {dname} ({b}, {n}): outside rtol/atol "
                    f"{TWO_LOOP_ELEMENT_TOL[dname]} of the plain version")
            out[name].update(two_loop_bits(mods, a, kd, b, n))
        elif name == "lbfgs_epilogue":
            dtype = getattr(torch, dname)
            stop = mods.cns.default_stopping(dtype)
            equal = True
            for crit in (stop.replace(max_iterations=10),
                         stop.replace(**EDGE_STOPPING)):
                r = epilogue_made_up(mods, b, n, dtype, crit)
                compare(name, r["ints"], r["floats"])
                equal = equal and r["equals_plain"]
            out[name].update(mappings=r["mappings"], equals_plain=equal)
    return out


@contextlib.contextmanager
def forced_rows(K, op, rows):
    """``lane_mapping(op, ...)`` keeps its lane groups but reads the rows by
    ``rows`` (a ``ROWS_*`` mode); other ops keep theirs."""
    shipped = K._pick

    def pick(op_, b, n, m, w):
        lpb, tpl, shipped_rows, smem, cl = shipped(op_, b, n, m, w)
        if op_ != op:
            return lpb, tpl, shipped_rows, smem, cl
        return lpb, tpl, rows, K.lane_smem_bytes(m, n, w, rows, lpb,
                                                 tpl == 32), cl

    K._pick = pick
    try:
        yield
    finally:
        K._pick = shipped


def two_loop_bits(mods, a, kd, b, n) -> dict:
    """The bare two-loop's direction ``kd`` (shipped mapping) against the
    same call under every other row mode that fits a block with the same
    lane groups, and against ``push_two_loop`` with ``valid`` off on the
    same history: each must give the same bits (the same threads add the
    same products in the same order; the rows are only read elsewhere)."""
    import torch

    K = mods.K
    w = a["g"].element_size()
    args = (a["g"], a["s"], a["y"], a["count"], a["gamma"])
    shipped = K.lane_mapping("two_loop", b, n, M, w)
    warp = shipped.threads_per_lane == 32
    modes = [K.ROWS_STREAM, K.ROWS_DIRECT]
    modes += [K.ROWS_REGISTERS] if warp else [K.ROWS_RING, K.ROWS_DEVICE_Q]
    tried = [shipped.rows]
    for rows in modes:
        if rows == shipped.rows or K.lane_smem_bytes(
                M, n, w, rows, shipped.lanes_per_block, warp) > K.SMEM_LIMIT:
            continue
        with forced_rows(K, "two_loop", rows):
            other = mods.wrappers["two_loop"](*args)
        torch.cuda.synchronize()
        if not torch.equal(bits(other), bits(kd)):
            raise AssertionError(
                f"two_loop ({b}, {n}) {kd.dtype}: rows mode {rows} differs "
                f"from the shipped mode {shipped.rows}")
        tried.append(rows)
    hist = [t.clone() for t in (a["s"], a["y"], a["count"], a["gamma"])]
    pd, *_ = mods.wrappers["push_two_loop"](
        a["g"], *hist, a["s_new"], a["y_new"], torch.zeros_like(a["valid"]))
    torch.cuda.synchronize()
    if not torch.equal(bits(pd), bits(kd)):
        raise AssertionError(
            f"two_loop ({b}, {n}) {kd.dtype}: differs from push_two_loop "
            "with valid off")
    return {"row_modes": tried, "mapping": vars(shipped),
            "equals_push_two_loop": True}


def made_up_epilogue(cns, b, n, dtype, dev, seed=SEED) -> dict:
    """Made-up inputs for the epilogue, from a seed: a search's result near
    the iterate with zero steps (the stall reset and the x_delta rung), a
    NaN in the search's point, non-finite values (the guard), unchanged
    values (f_delta 0), done lanes, and progress records at every stage
    (iteration counts about the limit, counters, plateau rings and their
    positions).  ``lbfgs_epilogue``'s arguments, in order, but the
    criteria; ``lane_sweep.py`` feeds the same inputs to another
    checkout's kernel."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(v, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device=dev,
                                                            dtype=dt)

    lanes = np.arange(b)
    x = rng.standard_normal((b, n))
    g = rng.standard_normal((b, n))
    x_ls = x + 1e-2 * rng.standard_normal((b, n))
    g_ls = g + 1e-1 * rng.standard_normal((b, n))
    x_ls[lanes % 9 == 5] = x[lanes % 9 == 5]
    x_ls[lanes % 17 == 3, n // 2] = np.nan
    f0 = rng.uniform(0.0, 10.0, b)
    f_ls = f0 - rng.uniform(0.0, 1e-3, b)
    f_ls[lanes % 7 == 2] = f0[lanes % 7 == 2]
    f_ls[lanes % 11 == 4] = np.inf
    f_ls[lanes % 13 == 6] = np.nan
    done = lanes % 4 == 1
    status = np.where(done, rng.integers(1, 5, b), 0)
    state = cns.FunctionState(x=t(x), value=t(f0), gradient=t(g),
                              nfev=t(rng.integers(0, 500, b), torch.int32))
    progress = cns.ProgressState(
        num_iterations=t(rng.integers(0, 12, b), torch.int32),
        x_delta=t(rng.uniform(0.0, 1.0, b)),
        x_delta_violations=t(rng.integers(0, 2, b), torch.int32),
        f_delta=t(rng.uniform(0.0, 1.0, b)),
        f_delta_violations=t(rng.integers(0, 2, b), torch.int32),
        gradient_norm=t(rng.uniform(0.0, 1.0, b)),
        condition_hessian=t(rng.uniform(1.0, 1e3, b)),
        status=t(status, torch.int32),
        past_ring=t(f0[:, None] + rng.uniform(0.0, 1e-4, (b, 8))),
        past_pos=t(rng.integers(0, 3, b), torch.int32))
    return {
        "state": state, "x_ls": t(x_ls), "f_ls": t(f_ls), "g_ls": t(g_ls),
        "ls_nfev": t(rng.integers(0, 20, b), torch.int32),
        "count": t(rng.integers(0, M + 1, b), torch.int32),
        "s_pend": t(rng.standard_normal((b, n))),
        "y_pend": t(rng.standard_normal((b, n))),
        "pvalid": t(rng.random(b) < 0.5, torch.bool),
        "done": t(done, torch.bool), "progress": progress,
    }


def epilogue_call(fn, a, crit):
    """``fn`` (the epilogue's wrapper or plain version) on fresh copies of
    the made-up inputs ``a``; returns every output tensor by name."""
    state, progress = _clone_record(a["state"]), _clone_record(a["progress"])
    count, s_pend, y_pend, pvalid = (a[k].clone() for k in (
        "count", "s_pend", "y_pend", "pvalid"))
    fn(state, a["x_ls"], a["f_ls"], a["g_ls"], a["ls_nfev"], count, s_pend,
       y_pend, pvalid, a["done"], progress, crit)
    return {**{f"state.{k}": v for k, v in vars(state).items()},
            **{f"progress.{k}": v for k, v in vars(progress).items()},
            "count": count, "s_pend": s_pend, "y_pend": y_pend,
            "pvalid": pvalid}


def bits(t):
    """A tensor's bits: floats viewed as integers of their width, so that
    NaNs compare by payload and -0 differs from +0."""
    import torch

    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def epilogue_mappings(K, b, n, itemsize) -> list:
    """``None`` (the shipped mapping) and the ones forced at (b, n):
    ``(lanes per block, threads per lane, cluster)``."""
    if n <= 64:
        forced = [(1, 32, 1), (8, 32, 1), (1, 64, 1)]
    else:
        forced = []
        for cl in (1, 2, 4):
            for bt in (K.lane_threads(-(-n // cl)), 64, 512):
                forced.append((1, cl * max(32, bt), cl))
    shipped = K.lane_mapping("lbfgs_epilogue", b, n, M, itemsize)
    ship = (shipped.lanes_per_block, shipped.threads_per_lane,
            shipped.cluster)
    return [None] + sorted({v for v in forced if v != ship})


@contextlib.contextmanager
def forced_mapping(K, op, v):
    """``lane_mapping(op, ...)`` gives ``v`` = (lanes per block, threads per
    lane, cluster), rows read in place; other ops keep theirs."""
    shipped = K._pick
    if v is None:
        yield
        return

    def pick(op_, b, n, m, w):
        if op_ != op:
            return shipped(op_, b, n, m, w)
        return v[0], v[1], K.ROWS_DIRECT, 0, v[2]

    K._pick = pick
    try:
        yield
    finally:
        K._pick = shipped


def epilogue_made_up(mods, b, n, dtype, crit) -> dict:
    """The epilogue on made-up inputs under every mapping it can take at
    (b, n): every mapping must give the same bits (only maxima are
    reduced); the plain version's outputs are compared (``ints`` and
    ``floats`` for :class:`Compare`) and its bit-equality recorded."""
    import torch

    a = made_up_epilogue(mods.cns, b, n, dtype, torch.device("cuda"))
    plain = epilogue_call(mods.plain_all["lbfgs_epilogue"], a, crit)
    runs, names = [], []
    w = torch.finfo(dtype).bits // 8
    for v in epilogue_mappings(mods.K, b, n, w):
        with forced_mapping(mods.K, "lbfgs_epilogue", v):
            runs.append(epilogue_call(mods.wrappers["lbfgs_epilogue"], a,
                                      crit))
        names.append(list(v) if v else "shipped")
    torch.cuda.synchronize()
    first = runs[0]
    for v, r in zip(names, runs):
        for key in first:
            if not torch.equal(bits(r[key]), bits(first[key])):
                raise AssertionError(
                    f"lbfgs_epilogue ({b}, {n}) on made-up inputs: {key} "
                    f"differs under mapping {v} from the shipped one")
    frozen = a["done"]
    for key, value in first.items():
        old = (a[key] if key in a else getattr(
            a["state"] if key.startswith("state.") else a["progress"],
            key.split(".")[1]))
        if not torch.equal(bits(value[frozen]), bits(old[frozen])):
            raise AssertionError(
                f"lbfgs_epilogue ({b}, {n}): a done lane's {key} changed")
    ints, floats = {}, {}
    for key, value in first.items():
        if value.is_floating_point():
            floats[key] = (value, plain[key], value.dim() == 2 and key
                           != "progress.past_ring")
        else:
            ints[key] = (value, plain[key])
    return {"ints": ints, "floats": floats, "mappings": names,
            "equals_plain": all(torch.equal(bits(first[k]), bits(plain[k]))
                                for k in first)}


def path_b_stopping(mods, obj, n, dtype, cut=0):
    """Path B's criteria: the default ones with the Hessian-condition
    criterion at PATH_B_FACTOR times cond(H) at the optimum (1, ..., 1)."""
    import torch

    cns = mods.cns
    opt = torch.ones((1, n), dtype=torch.float64,
                     device=torch.device("cuda"))
    cond = float(cns.utils.frobenius_condition(obj.hessian(opt))[0])
    stop = cns.default_stopping(dtype).replace(
        condition_hessian=PATH_B_FACTOR * cond)
    return stop.replace(max_iterations=cut) if cut else stop


def path_b_parity(mods, obj, x0, dname, stop, drift=None) -> dict:
    """``push_two_loop`` against its plain version at every call of a
    plain-version path-B solve; with ``drift`` (a :class:`Drift`) also the
    direction's distance to the plain version in float64."""
    import torch

    cns = mods.cns
    b = x0.shape[0]
    cmp = Compare(RTOL[dname], {"direction": DIRECTION_RTOL[dname]})
    launches0 = mods.wrappers["push_two_loop"].launches
    cover = {"valid_off_lane_calls": 0, "full_history_pushes": 0}

    def push(g, s_mem, y_mem, count, gamma, s_new, y_new, valid):
        k = [t.clone() for t in (s_mem, y_mem, count, gamma)]
        count0, newest0 = count.clone(), s_mem[:, -1].clone()
        kd, *_ = mods.wrappers["push_two_loop"](g, *k, s_new, y_new, valid)
        if drift is not None:
            up = [t.double() if t.is_floating_point() else t.clone()
                  for t in (g, s_mem, y_mem, count, gamma, s_new, y_new,
                            valid)]
            exact = mods.plain_all["push_two_loop"](*up)
        out = mods.plain_all["push_two_loop"](
            g, s_mem, y_mem, count, gamma, s_new, y_new, valid)
        torch.cuda.synchronize()
        if drift is not None:
            drift.add(kd, out[0], exact[0], (k[2] == count) & (up[3] == count))
        cmp.add(b, {"mem_count": (k[2], count)}, {
            "direction": (kd, out[0], True), "s_memory": (k[0], s_mem, True),
            "y_memory": (k[1], y_mem, True), "gamma": (k[3], gamma, False)})
        cover["valid_off_lane_calls"] += int((~valid).sum())
        cover["full_history_pushes"] += int(
            ((count0 >= M) & (s_mem[:, -1] != newest0).any(1)).sum())
        return out

    with mods.swapped({"push_two_loop": push,
                       "mt_trip": mods.plain_all["mt_trip"]}):
        res = cns.minimize_batched(
            obj, x0, cns.Lbfgs(m=M, max_linesearch_fev=MAX_FEV), stop)
    cover["iterations"] = int(res.progress.num_iterations.max())
    cover["fired"] = int((res.progress.status == int(
        cns.Status.HESSIAN_CONDITION_VIOLATION)).sum())
    r = cmp.result(mods.wrappers["push_two_loop"].launches - launches0)
    r["cover"] = cover
    return r


def path_b_main(mods, obj, x0, solver, stop) -> dict:
    """Path B through its entry points: ``minimize_batched`` of a
    second-mode objective with the Hessian-condition criterion on (traced,
    and fresh), and ``minimize`` for a batch of one.  The criterion must
    fire on some lanes and not on others; ``push_two_loop`` must launch once
    per iteration and ``mt_trip`` once per search trip, and no other kernel;
    statuses are held against the same solve through the plain versions."""
    import torch

    cns = mods.cns
    b, n = x0.shape
    hcv = int(cns.Status.HESSIAN_CONDITION_VIOLATION)
    torch.cuda.synchronize()
    for fn in mods.wrappers.values():
        fn.launches = 0
    mods.fs.flat_trip.launches = 0
    t0 = time.perf_counter()
    res = cns.minimize_batched(obj, x0, solver, stop, trace=NESTED_TRACE)
    fresh = cns.minimize_batched(obj, x0, solver, stop)
    one = cns.minimize(obj, x0[0], solver, stop)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in mods.wrappers.items()
                if fn.launches}
    iterations = sum(int(r.progress.num_iterations.max())
                     for r in (res, fresh, one))
    trips = res.trips + fresh.trips + one.trips
    want = {"push_two_loop": iterations, "mt_trip": trips}
    if launches != want or mods.fs.flat_trip.launches:
        raise AssertionError(
            f"path B ({b}, {n}): launches {launches} (flat_trip "
            f"{mods.fs.flat_trip.launches}), expected {want}")
    fired = int((res.progress.status == hcv).sum())
    if not 0 < fired < b:
        raise AssertionError(
            f"path B ({b}, {n}): the criterion fired on {fired} of {b} lanes")
    cond = res.progress.condition_hessian
    if not bool((cond[res.progress.status == hcv]
                 > stop.condition_hessian).all()):
        raise AssertionError("a lane stopped on cond(H) below the criterion")
    if not bool((fresh.progress.status == res.progress.status).all()):
        raise AssertionError("path B: traced and fresh solves disagree")
    check_result(res, b, n, M)
    if one.state.x.shape != (n,) or int(one.progress.status) == 0:
        raise AssertionError("path B: minimize did not finish")
    with mods.swapped(mods.plain_b):
        plain = cns.minimize_batched(obj, x0, solver, stop)
    agree = float((res.progress.status == plain.progress.status)
                  .float().mean())
    dnfev = abs(float(res.state.nfev.float().mean())
                - float(plain.state.nfev.float().mean()))
    dname = str(x0.dtype).split(".")[1]
    row = {
        "shape": [b, n], "dtype": dname, "launches": launches,
        "iterations": iterations, "trips": trips,
        "condition_hessian": stop.condition_hessian,
        "max_iterations": stop.max_iterations,
        "fired_lanes": fired, "status_agreement": agree,
        "mean_nfev_diff": dnfev,
        "mean_nfev": float(res.state.nfev.float().mean()),
        "converged_share": converged_share(res, cns), "main_wall_s": wall,
    }
    log(f"[main] path B ({b}, {n}) {dname}: criterion "
        f"{stop.condition_hessian:.4g}, fired on {fired} of {b} lanes; "
        f"{iterations} iterations, {trips} search trips, launches "
        f"{launches}; against the plain versions: status agreement "
        f"{agree:.4f}, mean nfev diff {dnfev:.3f}; wall {wall:.3f} s")
    if agree < 0.99 or dnfev >= 3.0:
        raise AssertionError(f"path B ({b}, {n}) disagrees with plain: {row}")
    return row


def path_c_main(mods) -> dict:
    """Path C: the public op ``two_loop_direction`` on the card, batched at
    every shape and once un-batched.  One launch per call; each result is
    finite where its gradient is and agrees with the plain version in
    float64 on the same inputs within DIRECTION_RTOL of float32."""
    import torch

    cns = mods.cns
    dev = torch.device("cuda")
    cases = [made_up(b, n, torch.float32, dev) for b, n in TWO_LOOP_SHAPES]
    torch.cuda.synchronize()
    for fn in mods.wrappers.values():
        fn.launches = 0
    outs = [cns.solvers.two_loop_direction(
        a["g"], a["s"], a["y"], a["count"], a["gamma"]) for a in cases]
    a = cases[0]
    single = cns.solvers.two_loop_direction(
        a["g"][0], a["s"][0], a["y"][0], a["count"][0], a["gamma"][0])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in mods.wrappers.items()
                if fn.launches}
    if launches != {"two_loop": len(cases) + 1}:
        raise AssertionError(f"path C: launches {launches}")
    worst = 0.0
    for a, out in zip(cases, outs):
        ref = mods.plain_all["two_loop"](
            a["g"].double(), a["s"].double(), a["y"].double(), a["count"],
            a["gamma"].double())
        fin = ref.isfinite().all(1)
        if tuple(out.shape) != tuple(a["g"].shape) or not bool(
                (out.isfinite().all(1) == fin).all()):
            raise AssertionError("path C: wrong shape or non-finite values")
        err = ((out.double() - ref)[fin].abs().amax(1)
               / ref[fin].abs().amax(1).clamp_min(1e-300))
        worst = max(worst, float(err.max()))
    if not bool((single == outs[0][0]).all()):
        raise AssertionError("path C: the un-batched call differs")
    if worst > DIRECTION_RTOL["float32"]:
        raise AssertionError(f"path C: error {worst:.3e} against float64")
    log(f"[main] path C: two_loop_direction at {TWO_LOOP_SHAPES} and one "
        f"un-batched call, launches {launches}, worst error against the "
        f"float64 plain version {worst:.3e}")
    return {"launches": launches, "max_scaled_err_vs_float64": worst}


def suite_plain(mods, dname, indices=None) -> dict:
    """The plain version's solve of the MGH-376 suite's problems
    ``indices`` (every one: None) in ``dname``, as ``suite_bench``'s single
    solve runs them but with ``flat_trip_reference`` for the kernel: by
    problem index, the lanes' statuses and whether each succeeded."""
    import torch

    import suite_bench
    from cppnumericalsolvers_tpu_torch.models import (
        mgh_benchmark_instances, success_mask)

    cns, fs = mods.cns, mods.fs
    dtype = getattr(torch, dname)
    solver = suite_bench.reliability_solver(cns)
    stop = suite_bench.reliability_stopping(cns, dtype)
    batches = (mgh_benchmark_instances(dtype_str="float32")
               if dname == "float32" else mgh_benchmark_instances())
    out = {}
    for i, (problem, starts) in enumerate(batches):
        if indices is not None and i not in indices:
            continue
        x0 = torch.from_numpy(starts).to(device=torch.device("cuda"),
                                         dtype=dtype)
        pres = fs.flat_lbfgs_solve(
            problem.objective, problem.objective.evaluate(x0), stop,
            m=solver.m, max_fev=solver.max_linesearch_fev,
            trip=fs.flat_trip_reference)
        out[i] = (pres.progress.status.cpu().numpy(), success_mask(
            problem, pres.state.value.double().cpu().numpy(),
            pres.state.gradient.abs().amax(-1).double().cpu().numpy(),
            pres.state.x.abs().amax(-1).double().cpu().numpy()))
    return out


def suite_plain_passes(mods) -> dict:
    """The side process's share of ``suite_main``: :func:`suite_plain` in
    float32 over every problem, then in float64 over the problems with a
    lane that failed in float32 (the single solve's rule, on the plain
    version's lanes; ``suite_main`` solves any other problem the kernel's
    pass sent to float64 itself)."""
    f32 = suite_plain(mods, "float32")
    again = {i for i, (_, ok) in f32.items() if not ok.all()}
    return {"float32": f32, "float64": suite_plain(mods, "float64", again)}


def suite_main(mods, plain) -> dict:
    """The MGH-376 suite through ``suite_bench.single_solve`` (every
    instance a fresh ``minimize_batched`` in float32, the problems with a
    failed instance again in float64), launch counts set to 0 just before
    and read just after: only ``flat_trip`` may launch, once per trip.  Then
    each pass's problems through the plain version on the card (``plain``:
    :func:`suite_plain_passes`, from the side process): the kernel's
    statuses must equal the plain version's on every float64 lane and on
    at least 99% of the float32 lanes, and the single solve must converge
    on at least SUITE_CONVERGED_MIN of the 376."""
    import torch

    import suite_bench

    fs = mods.fs
    torch.cuda.synchronize()
    fs.flat_trip.launches = 0
    for fn in mods.wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    run = suite_bench.single_solve("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flat_trip": fs.flat_trip.launches,
                **{name: fn.launches for name, fn in mods.wrappers.items()
                   if fn.launches}}
    trips = sum(r["trips"] for r in run["float32"]) + sum(
        r["trips"] for r in run["float64"].values())
    if launches != {"flat_trip": trips} or trips == 0:
        raise AssertionError(f"suite: launches {launches} for {trips} trips")
    records = run["records"]
    total = sum(r["ok"].size for r in records)
    converged = sum(int(r["ok"].sum()) for r in records)
    row = {"wall_s": wall, "f32_pass_s": run["f32_wall_s"],
           "f64_pass_s": run["f64_wall_s"], "launches": launches,
           "instances": total, "converged_single_solve": converged,
           "solved_in_float32": sum(int(r["ok"].sum())
                                    for r in run["float32"]),
           "problems_in_float64": len(run["float64"])}
    from cppnumericalsolvers_tpu_torch.models import mgh_benchmark_instances

    names = [p.name for p, _ in mgh_benchmark_instances(dtype_str="float32")]
    missing = set(run["float64"]) - set(plain["float64"])
    row["float64_solved_here"] = sorted(missing)
    plain = {"float32": plain["float32"],
             "float64": {**plain["float64"],
                         **suite_plain(mods, "float64", missing)}}
    passes = {"float32": dict(enumerate(run["float32"])),
              "float64": run["float64"]}
    for dname, recs in passes.items():
        lanes = mism = plain_ok = 0
        differing = []
        for i, rec in recs.items():
            ps, ok = plain[dname][i]
            lanes += ps.size
            mism += int((rec["status"] != ps).sum())
            plain_ok += int(ok.sum())
            if (rec["status"] != ps).any():
                differing.append(names[i])
        agree = 1.0 - mism / max(lanes, 1)
        row[dname] = {"lanes": lanes, "status_mismatches": mism,
                      "status_agreement": agree,
                      "kernel_converged": sum(int(r["ok"].sum())
                                              for r in recs.values()),
                      "plain_converged": plain_ok,
                      "problems_differing": differing}
        log(f"[main] suite {dname}: {lanes} lanes of {len(recs)} problems; "
            f"kernel against plain: {mism} statuses differ (agreement "
            f"{agree:.4f}); converged kernel "
            f"{row[dname]['kernel_converged']}, plain {plain_ok}; problems "
            f"differing {differing}")
        if agree < SUITE_STATUS_AGREEMENT[dname]:
            raise AssertionError(f"suite {dname}: {row[dname]}")
    row["phase_wall_s"] = time.perf_counter() - t0
    log(f"[main] suite: single solve converged {converged}/{total} "
        f"({row['solved_in_float32']} in float32, {len(run['float64'])} "
        f"problems again in float64), launches {launches}, wall "
        f"{wall:.1f} s; the phase with the plain versions "
        f"{row['phase_wall_s']:.1f} s (float64 plain solves of "
        f"{len(missing)} problems here, the rest in the side process)")
    if converged < SUITE_CONVERGED_MIN * total:
        raise AssertionError(f"suite: converged {converged}/{total}")
    return row


def solvers_main(mods, obj, run) -> dict:
    """One solver or search of SOLVER_RUNS on the pairwise extended
    Rosenbrock from starts uniform in [-2, 2] (seed 0), through
    ``minimize_batched``:

    * the float32 solve (cut where the run says), launch counts and the
      device-to-host reads (``any_lane.reads``) set to 0 just before and
      read just after: a path with kernels launches ``mt_trip`` once per
      search trip (gradient descent, BFGS) or ``lbfgs_prologue`` and
      ``lbfgs_epilogue`` once per iteration and never ``flat_trip``
      (L-BFGS with Hager-Zhang or Armijo), and nothing else; a path with
      none launches nothing.  Finite values, every lane stopped;
    * a path with kernels: the same float32 solve through the plain
      versions on the card (statuses equal on at least 99% of lanes), and
      a float64 solve cut at SOLVER_SHORT_BUDGET iterations with kernels
      and with plain versions: status, nfev and num_iterations equal on
      every lane, iterates within SOLVER_PLAIN_XTOL;
    * a path without: the float64 solve cut at SOLVER_SHORT_BUDGET on the
      card against the same solve on the CPU: status and nfev equal on
      every lane, iterates within SOLVER_CPU_XTOL."""
    import numpy as np
    import torch

    from cppnumericalsolvers_tpu_torch.core.tree import any_lane

    cns, fs = mods.cns, mods.fs
    label, cls, kw, (b, n), mode, conservative, cut, names = run
    solver = getattr(cns, cls)(**kw)
    tobj = obj if mode == "second" else obj.with_mode(mode)
    x_np = np.random.default_rng(SEED).uniform(-2.0, 2.0, (b, n))

    def stopping(dtype, budget=0):
        crit = (cns.conservative_stopping(dtype) if conservative
                else solver.default_stopping(dtype))
        return crit.replace(max_iterations=budget) if budget else crit

    def solve(dtype, budget=0, device="cuda"):
        x0 = torch.from_numpy(x_np).to(device=device, dtype=dtype)
        return cns.minimize_batched(tobj, x0, solver,
                                    stopping(dtype, budget), device=device)

    counted = {"flat_trip": fs.flat_trip, **mods.wrappers}
    torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    any_lane.reads = 0
    t0 = time.perf_counter()
    res = solve(torch.float32, cut)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reads = any_lane.reads
    launches = {k: fn.launches for k, fn in counted.items() if fn.launches}
    iterations = int(res.progress.num_iterations.max())
    want = {k: (res.trips if k == "mt_trip" else iterations) for k in names}
    if launches != want:
        raise AssertionError(
            f"solvers {label} ({b}, {n}): launches {launches}, expected "
            f"{want} ({iterations} iterations, {res.trips} trips)")
    for field in ("x", "value"):
        if not bool(getattr(res.state, field).isfinite().all()):
            raise AssertionError(f"solvers {label}: {field} not finite")
    if bool((res.progress.status == 0).any()):
        raise AssertionError(f"solvers {label}: a lane did not stop")
    row = {
        "label": label, "solver": f"{cls}({kw})", "shape": [b, n],
        "dtype": "float32", "cut": cut, "launches": launches,
        "batched_iterations": iterations,
        "mean_iterations": float(res.progress.num_iterations.float().mean()),
        "trips": res.trips, "host_reads": reads,
        "reads_per_iteration": reads / max(iterations, 1),
        "wall_s": wall, "mean_nfev": float(res.state.nfev.float().mean()),
        "converged_share": converged_share(res, cns),
        "statuses": torch.bincount(res.progress.status.cpu(),
                                   minlength=7).tolist(),
    }

    def short(a, bres):
        same = {f: bool((getattr(a.progress, f).cpu()
                         == getattr(bres.progress, f).cpu()).all())
                for f in ("status", "num_iterations")}
        same["nfev"] = bool((a.state.nfev.cpu() == bres.state.nfev.cpu())
                            .all())
        dx = float((a.state.x.cpu() - bres.state.x.cpu()).abs().max())
        return same, dx

    if names:
        plain = {k: mods.plain_all[k] for k in names}
        t1 = time.perf_counter()
        with mods.swapped(plain):
            pres = solve(torch.float32, cut)
        torch.cuda.synchronize()
        row["plain_wall_s"] = time.perf_counter() - t1
        row["status_agreement"] = float(
            (res.progress.status == pres.progress.status).float().mean())
        kres = solve(torch.float64, SOLVER_SHORT_BUDGET)
        with mods.swapped(plain):
            pres = solve(torch.float64, SOLVER_SHORT_BUDGET)
        same, dx = short(kres, pres)
        row["float64_short"] = {"against": "plain versions on the card",
                                "equal": same, "max_abs_x_diff": dx}
        ok = (row["status_agreement"] >= 0.99 and all(same.values())
              and dx <= SOLVER_PLAIN_XTOL)
    else:
        cres = solve(torch.float64, SOLVER_SHORT_BUDGET)
        hres = solve(torch.float64, SOLVER_SHORT_BUDGET, device="cpu")
        same, dx = short(cres, hres)
        row["float64_short"] = {"against": "the same solve on the CPU",
                                "equal": same, "max_abs_x_diff": dx}
        ok = all(same.values()) and dx <= SOLVER_CPU_XTOL
    log(f"[main] solvers {label} ({b}, {n}) float32"
        f"{f' cut at {cut}' if cut else ''}: {iterations} batched "
        f"iterations, {res.trips} trips, {reads} host reads "
        f"({row['reads_per_iteration']:.1f} an iteration), launches "
        f"{launches}, wall {wall:.3f} s, converged "
        f"{row['converged_share']:.4f}"
        + (f", status agreement with plain {row['status_agreement']:.4f}"
           f" (plain {row['plain_wall_s']:.3f} s)" if names else "")
        + f"; float64 {SOLVER_SHORT_BUDGET} iterations against "
        f"{row['float64_short']['against']}: equal {same}, max |dx| "
        f"{dx:.3e}")
    if not ok:
        raise AssertionError(f"solvers {label} ({b}, {n}): {row}")
    return row


def _counted_run(mods, run, plain=False):
    """Run ``run()`` with the launch counts, the device-to-host reads
    (``any_lane.reads``) and the Cauchy walk's passes set to 0 just before
    and read just after, through wrappers that count the calls made to
    ``mt_trip``, ``lbfgs_prologue`` and ``lbfgs_epilogue`` and pass them on
    to the kernel wrappers (or, with ``plain``, to the plain versions).
    Returns the result and the figures."""
    import torch

    from cppnumericalsolvers_tpu_torch.core.tree import any_lane

    counted = {"flat_trip": mods.fs.flat_trip, **mods.wrappers}
    calls = dict.fromkeys(CONSTRAINED_KERNELS, 0)

    def counting(name):
        target = (mods.plain_all if plain else mods.wrappers)[name]

        def fn(*args, **kwargs):
            calls[name] += 1
            return target(*args, **kwargs)

        return fn

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    for fn in counted.values():
        fn.launches = 0
    any_lane.reads = 0
    mods.lbb.generalized_cauchy_point.passes = 0
    t0 = time.perf_counter()
    with mods.swapped({k: counting(k) for k in calls}):
        res = run()
    if cuda:
        torch.cuda.synchronize()
    return res, {
        "wall_s": time.perf_counter() - t0,
        "calls": dict(calls),
        "launches": {k: fn.launches for k, fn in counted.items()
                     if fn.launches},
        "host_reads": any_lane.reads,
        "cauchy_passes": mods.lbb.generalized_cauchy_point.passes,
    }


def _same_short(a, b, al=False) -> dict:
    """Status, num_iterations and nfev equal on every lane, and the largest
    distance of the iterates (and, for AL results, of the multipliers and
    the penalty)."""
    out = {f: bool((getattr(a.progress, f).cpu()
                    == getattr(b.progress, f).cpu()).all())
           for f in ("status", "num_iterations")}
    dnfev = (a.state.nfev.cpu() - b.state.nfev.cpu()).abs()
    out["nfev"] = bool((dnfev == 0).all())
    out["nfev_mismatched_lanes"] = int((dnfev != 0).sum())
    out["nfev_max_diff"] = int(dnfev.max())
    pairs = [("x", a.state.x, b.state.x)]
    if al:
        # The update lambda += rho c multiplies what a last-bit difference
        # leaves in c by rho: the multipliers are compared over max(1, rho)
        # of their lane.
        rho = b.state.penalty.cpu().abs().clamp_min(1.0)[:, None]
        ma, mb = a.state.multipliers, b.state.multipliers
        pairs += [("penalty", a.state.penalty, b.state.penalty),
                  ("equality_over_rho", ma.equality.cpu() / rho,
                   mb.equality.cpu() / rho),
                  ("inequality_over_rho", ma.inequality.cpu() / rho,
                   mb.inequality.cpu() / rho)]
    out["max_abs_diff"] = {
        name: (float((p.cpu() - q.cpu()).abs().max()) if p.numel() else 0.0)
        for name, p, q in pairs}
    return out


def _short_ok(same, tol, nfev_lanes=0) -> bool:
    """Statuses and iterations equal on every lane, floats within ``tol``,
    nfev equal on all but ``nfev_lanes`` lanes."""
    return (same["status"] and same["num_iterations"]
            and same["nfev_mismatched_lanes"] <= nfev_lanes
            and max(same["max_abs_diff"].values()) <= tol)


def constrained_main(mods, dev) -> dict:
    """L-BFGS-B, the augmented-Lagrangian layer and the finite-difference
    checkers on the card (the ``constrained_main`` phase):

    * ``Lbfgsb(m=5, lower=-2, upper=0.9)`` on the pairwise extended
      Rosenbrock at bench.py's L-BFGS-B shapes (1024, 32) and (256, 256),
      float32, starts uniform in [-2, 2] from seed 0, each to its own stop,
      and at (1024, 32) with a box per lane from ``make_internals`` (half
      the lanes [-2, 0.9], half [-1.5, 1.5]);
    * ``AugmentedLagrangian(inner_solver=Lbfgs(m=10))`` on bench.py's AL
      leg, 64 lanes at n = 4096, float32, 10 outer iterations of at most 40
      inner ones;
    * ``AugmentedLagrangian(inner_solver=Lbfgsb(m=5, lower=-3, upper=3))``
      on examples_torch/constrained.py's two problems (``problems()``, the
      JAX example's), 64 starts each, float64,
      to their own stop: every lane on the analytic optimum within 1e-3;
    * the checkers on the pairwise Rosenbrock at n = 32 and 64, float64.

    Checks, each raising: (1) kernels against plain versions on the card:
    float64 at a short budget (L-BFGS-B 5 iterations, AL 2 outer x 5
    inner) status, nfev and num_iterations equal on every lane and iterates
    (with multipliers and penalty) within CONSTRAINED_XTOL; float32
    L-BFGS-B statuses equal on at least 99% of lanes, the float32 AL leg
    held as AL_F32_ULPS says, the float64 examples' statuses equal on every
    lane; (2) the same short budgets on the card against the CPU: statuses
    and iterations equal on every lane, floats and nfev as CONSTRAINED_CPU
    says; (3) launch counts: ``mt_trip`` once per search trip,
    ``lbfgs_prologue`` and ``lbfgs_epilogue`` once per inner iteration of
    the ``Lbfgs``-inner AL solve and never otherwise, ``flat_trip`` never;
    (4) the checkers: the CPU's booleans, and values within CHECKER_RTOL of
    the largest entry.  Times, iterations, trips, reads and Cauchy passes
    go to the record."""
    import numpy as np
    import torch

    cns = mods.cns
    obj = cns.models.pairwise_rosenbrock()
    rows, launches = [], {}

    def add_launches(st):
        for k, v in st["launches"].items():
            launches[k] = launches.get(k, 0) + v

    def starts(b, n, lo=-2.0, hi=2.0):
        return np.random.default_rng(SEED).uniform(lo, hi, (b, n))

    def check_launches(label, st, want):
        if "flat_trip" in st["launches"]:
            raise AssertionError(f"{label}: flat_trip launched")
        got = {k: st["launches"].get(k, 0) for k in CONSTRAINED_KERNELS}
        if got != want or got != st["calls"] or got["mt_trip"] == 0:
            raise AssertionError(
                f"{label}: launches {got}, calls {st['calls']}, expected "
                f"{want}")

    # L-BFGS-B --------------------------------------------------------------
    for label, (b, n) in LBFGSB_RUNS:
        solver = cns.Lbfgsb(m=5, lower=LBFGSB_BOX[0], upper=LBFGSB_BOX[1])
        x_np = starts(b, n)

        def solve(dtype, budget=0, device=dev, solver=solver, x_np=x_np,
                  label=label, b=b, n=n):
            x0 = torch.from_numpy(x_np).to(device=device, dtype=dtype)
            stop = solver.default_stopping(dtype)
            if budget:
                stop = stop.replace(max_iterations=budget)
            internals = None
            if label == "lane_boxes":
                half = torch.arange(b, device=device)[:, None] < b // 2
                lo = torch.where(half, LANE_BOXES[0][0], LANE_BOXES[1][0])
                up = torch.where(half, LANE_BOXES[0][1], LANE_BOXES[1][1])
                internals = solver.make_internals(
                    n, dtype, lo.expand(b, n), up.expand(b, n),
                    device=device)
            return cns.minimize_batched(obj, x0, solver, stop,
                                        internals=internals, device=device)

        res, st = _counted_run(mods, lambda: solve(torch.float32))
        add_launches(st)
        iters = int(res.progress.num_iterations.max())
        trips = st["calls"]["mt_trip"]
        check_launches(f"lbfgsb {label} ({b}, {n})", st,
                       {"mt_trip": trips, "lbfgs_prologue": 0,
                        "lbfgs_epilogue": 0})
        if trips > res.trips:
            raise AssertionError("more search trips than evaluations")
        for field in ("x", "value"):
            if not bool(getattr(res.state, field).isfinite().all()):
                raise AssertionError(f"lbfgsb {label}: {field} not finite")
        if bool((res.progress.status == 0).any()):
            raise AssertionError(f"lbfgsb {label}: a lane did not stop")
        lo_box = res.internals.lower
        up_box = res.internals.upper
        if bool(((res.state.x < lo_box) | (res.state.x > up_box)).any()):
            raise AssertionError(f"lbfgsb {label}: x left its box")
        pres, pst = _counted_run(mods, lambda: solve(torch.float32),
                                 plain=True)
        agree = float((res.progress.status == pres.progress.status)
                      .float().mean())
        kshort, _ = _counted_run(
            mods, lambda: solve(torch.float64, CONSTRAINED_SHORT_LBFGSB))
        pshort, _ = _counted_run(
            mods, lambda: solve(torch.float64, CONSTRAINED_SHORT_LBFGSB),
            plain=True)
        cshort = solve(torch.float64, CONSTRAINED_SHORT_LBFGSB, "cpu")
        row = {
            "solve": f"Lbfgsb(m=5) {label}", "shape": [b, n],
            "dtype": "float32", "wall_s": st["wall_s"],
            "plain_wall_s": pst["wall_s"], "iterations": iters,
            "evaluations": res.trips, "search_trips": trips,
            "host_reads": st["host_reads"],
            "reads_per_iteration": st["host_reads"] / max(iters, 1),
            "cauchy_passes": st["cauchy_passes"],
            "cauchy_passes_per_iteration": st["cauchy_passes"]
            / max(iters, 1),
            "launches": st["launches"], "status_agreement": agree,
            "converged_share": converged_share(res, cns),
            "statuses": torch.bincount(res.progress.status.cpu(),
                                       minlength=7).tolist(),
            "float64_short_plain": _same_short(kshort, pshort),
            "float64_short_cpu": _same_short(kshort, cshort),
        }
        rows.append(row)
        log(f"[main] constrained {row['solve']} ({b}, {n}) float32: "
            f"{iters} iterations, {res.trips} evaluations ({trips} search "
            f"trips), {st['host_reads']} host reads "
            f"({row['reads_per_iteration']:.1f} an iteration), "
            f"{st['cauchy_passes']} Cauchy passes "
            f"({row['cauchy_passes_per_iteration']:.1f} an iteration), "
            f"wall {st['wall_s']:.3f} s (plain {pst['wall_s']:.3f} s), "
            f"status agreement {agree:.4f}, converged "
            f"{row['converged_share']:.4f}; float64 "
            f"{CONSTRAINED_SHORT_LBFGSB} iterations against plain "
            f"{row['float64_short_plain']}, against the CPU "
            f"{row['float64_short_cpu']}")
        cpu_tol, cpu_lanes = CONSTRAINED_CPU["lbfgsb"]
        if (agree < 0.99
                or not _short_ok(row["float64_short_plain"],
                                 CONSTRAINED_XTOL)
                or not _short_ok(row["float64_short_cpu"], cpu_tol,
                                 cpu_lanes * b)):
            raise AssertionError(f"lbfgsb {label} ({b}, {n}): {row}")

    # Augmented Lagrangian -----------------------------------------------------
    b, n = AL_LEG
    leg = al_leg_problem(cns, n)
    outer, inner_cap = AL_LEG_BUDGET

    def al_runs():
        yield ("bench_leg_lbfgs", leg, cns.Lbfgs(m=M), starts(b, n), outer,
               inner_cap, torch.float32, None)
        from examples_torch import constrained

        for name, (problem, optimum) in constrained.problems().items():
            yield (f"example_{name}_lbfgsb", problem,
                   cns.Lbfgsb(m=5, lower=AL_EXAMPLE_BOX[0],
                              upper=AL_EXAMPLE_BOX[1]),
                   starts(AL_EXAMPLE_STARTS, 2), 0, 0, torch.float64,
                   optimum)

    for label, problem, inner, x_np, cap, icap, dtype, optimum in al_runs():
        al = cns.AugmentedLagrangian(inner_solver=inner)
        lbfgs_inner = isinstance(inner, cns.Lbfgs)

        def solve(dtype, cap=cap, icap=icap, device=dev, al=al,
                  problem=problem, x_np=x_np, inner=inner):
            x0 = torch.from_numpy(x_np).to(device=device, dtype=dtype)
            stop = cns.default_stopping(dtype)
            istop = inner.default_stopping(dtype)
            if cap:
                stop = stop.replace(max_iterations=cap)
            if icap:
                istop = istop.replace(max_iterations=icap)
            return al.minimize_batched(problem, x0, stopping=stop,
                                       inner_stopping=istop, device=device)

        res, st = _counted_run(mods, lambda: solve(dtype))
        add_launches(st)
        outer_its = int(res.progress.num_iterations.max())
        feasible = float(res.state.max_violation.max())
        trips = st["calls"]["mt_trip"]
        per_iteration = res.inner_iterations if lbfgs_inner else 0
        check_launches(f"al {label}", st,
                       {"mt_trip": trips, "lbfgs_prologue": per_iteration,
                        "lbfgs_epilogue": per_iteration})
        if lbfgs_inner and trips != res.trips:
            raise AssertionError(f"al {label}: {trips} search trips, "
                                 f"{res.trips} evaluations")
        if not bool(res.state.x.isfinite().all()):
            raise AssertionError(f"al {label}: x not finite")
        if bool((res.progress.status == 0).any()):
            raise AssertionError(f"al {label}: a lane did not stop")
        pres, pst = _counted_run(mods, lambda: solve(dtype), plain=True)
        agree = float((res.progress.status == pres.progress.status)
                      .float().mean())
        plain_dx = float((res.state.x - pres.state.x).abs().max())
        plain_feasible = float(pres.state.max_violation.max())
        short = (CONSTRAINED_SHORT_AL if cap == 0
                 else (min(cap, CONSTRAINED_SHORT_AL[0]),
                       min(icap, CONSTRAINED_SHORT_AL[1])))
        kshort, _ = _counted_run(
            mods, lambda: solve(torch.float64, *short))
        pshort, _ = _counted_run(
            mods, lambda: solve(torch.float64, *short), plain=True)
        cshort = solve(torch.float64, *short, device="cpu")
        row = {
            "solve": f"AugmentedLagrangian({type(inner).__name__}) {label}",
            "shape": list(x_np.shape), "dtype": str(dtype).split(".")[1],
            "budget": [cap, icap], "wall_s": st["wall_s"],
            "plain_wall_s": pst["wall_s"], "outer_iterations": outer_its,
            "inner_iterations": res.inner_iterations,
            "evaluations": res.trips, "search_trips": trips,
            "host_reads": st["host_reads"],
            "reads_per_inner_iteration": st["host_reads"]
            / max(res.inner_iterations, 1),
            "cauchy_passes": st["cauchy_passes"],
            "cauchy_passes_per_inner_iteration": st["cauchy_passes"]
            / max(res.inner_iterations, 1),
            "launches": st["launches"], "status_agreement": agree,
            "statuses": torch.bincount(res.progress.status.cpu(),
                                       minlength=7).tolist(),
            "max_violation": feasible, "plain_max_violation": plain_feasible,
            "max_abs_x_diff_plain": plain_dx,
            "float64_short_budget": list(short),
            "float64_short_plain": _same_short(kshort, pshort, al=True),
            "float64_short_cpu": _same_short(kshort, cshort, al=True),
        }
        if dtype == torch.float32:
            stopped = (1, 6)  # ITERATION_LIMIT, FINISHED
            limit = AL_F32_ULPS * torch.finfo(dtype).eps * x_np.shape[1]
            ok = (all(torch.isin(r.progress.status.cpu(),
                                 torch.tensor(stopped)).all()
                      for r in (res, pres))
                  and max(feasible, plain_feasible) <= limit
                  and plain_dx <= AL_F32_XTOL)
        else:
            ok = agree == 1.0
        if optimum is not None:
            err = float((res.state.x.cpu()
                         - torch.tensor(optimum, dtype=dtype)).abs().max())
            row["max_abs_error_to_optimum"] = err
            ok = ok and err <= 1e-3
        cpu_tol, cpu_lanes = CONSTRAINED_CPU[
            "bench_leg" if optimum is None else "example"]
        ok = (ok and _short_ok(row["float64_short_plain"], CONSTRAINED_XTOL)
              and _short_ok(row["float64_short_cpu"], cpu_tol,
                            cpu_lanes * len(x_np)))
        rows.append(row)
        log(f"[main] constrained {row['solve']} {tuple(x_np.shape)} "
            f"{row['dtype']}: {outer_its} outer, {res.inner_iterations} "
            f"inner iterations, {res.trips} evaluations ({trips} search "
            f"trips), {st['host_reads']} host reads "
            f"({row['reads_per_inner_iteration']:.1f} an inner iteration), "
            f"{st['cauchy_passes']} Cauchy passes, wall {st['wall_s']:.3f} s "
            f"(plain {pst['wall_s']:.3f} s), status agreement {agree:.4f}, "
            f"max violation {feasible:.3e} (plain {plain_feasible:.3e}), "
            f"max |x - x_plain| {plain_dx:.3e}"
            + (f", max |x - x*| {row['max_abs_error_to_optimum']:.2e}"
               if optimum is not None else "")
            + f"; float64 {short[0]} x {short[1]} against plain "
            f"{row['float64_short_plain']}, against the CPU "
            f"{row['float64_short_cpu']}")
        if not ok:
            raise AssertionError(f"al {label}: {row}")

    # Finite-difference checkers -------------------------------------------------
    utils = cns.utils
    checkers = []
    for n in CHECKER_SIZES:
        x_np = starts(1, n)[0]
        xs = {d: torch.from_numpy(x_np).to(d) for d in (dev, "cpu")}
        t0 = time.perf_counter()
        row = {"n": n, "gradient_rel_err": {}, "hessian_rel_err": {}}
        flags = {}
        for d, x in xs.items():
            flags[str(d)] = (
                [utils.is_gradient_correct(obj, x, a) for a in range(4)]
                + [utils.is_hessian_correct(obj, x, a) for a in range(2)])
        for acc in range(4):
            g = {d: utils.compute_finite_gradient(obj.fn, x, acc).cpu()
                 for d, x in xs.items()}
            row["gradient_rel_err"][acc] = _rel_err(g[dev], g["cpu"])
        for acc in range(2):
            h = {d: utils.compute_finite_hessian(obj.fn, x, acc).cpu()
                 for d, x in xs.items()}
            row["hessian_rel_err"][acc] = _rel_err(h[dev], h["cpu"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        row["seconds"] = time.perf_counter() - t0
        row["flags"] = flags[str(dev)]
        row["flags_equal"] = flags[str(dev)] == flags["cpu"]
        worst = max(list(row["gradient_rel_err"].values())
                    + list(row["hessian_rel_err"].values()))
        log(f"[main] constrained checkers n = {n} float64: flags "
            f"{row['flags']} (equal to the CPU's: {row['flags_equal']}), "
            f"card against CPU relative to the largest entry: gradient "
            f"{row['gradient_rel_err']}, Hessian {row['hessian_rel_err']}, "
            f"{row['seconds']:.2f} s")
        checkers.append(row)
        if not (row["flags_equal"] and all(row["flags"])
                and worst <= CHECKER_RTOL):
            raise AssertionError(f"checkers n = {n}: {row}")
    return {"solves": rows, "checkers": checkers, "launches": launches}


def _rel_err(a, b) -> float:
    """Largest |a - b| over the largest |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def op_timing(mods, name, b, n) -> dict:
    """Device time per call of ``push_two_loop`` or ``two_loop`` and of its
    plain version on made-up float32 inputs (spin-padded, fresh copies of
    the inputs for every call, in the order plain, kernel, kernel, plain),
    and the least time the call's data needs on this card: a lane reads g
    (and the pair), reads the history rows its recursion uses, writes the
    rows that change (one, or all m when a full history shifts) and the
    direction."""
    import torch

    dev = torch.device("cuda")
    a = made_up(b, n, torch.float32, dev)
    w = 4
    eps = torch.finfo(torch.float32).eps
    c0 = a["count"].long()
    if name == "push_two_loop":
        sy, s2, y2 = ((p * q).sum(1) for p, q in (
            (a["s_new"], a["y_new"]), (a["s_new"], a["s_new"]),
            (a["y_new"], a["y_new"])))
        accept = a["valid"] & (sy > eps * s2.sqrt() * y2.sqrt())
        full = c0 >= M
        c1 = torch.where(accept & ~full, c0 + 1, c0)
        hist_read = 2 * n * (c1 - accept.long()).clamp(min=0)
        hist_write = torch.where(
            accept, torch.where(full, 2 * M * n, 2 * n), 0)
        byts = (4 * n + hist_read + hist_write) * w + 2 * w + 2 * 4 + 1
        ops = 6 * n + 10 * n * c1
        keys = ("g", "s", "y", "count", "gamma", "s_new", "y_new", "valid")
    else:
        byts = (2 * n + 2 * n * c0) * w + w + 4
        ops = n + 10 * n * c0
        keys = ("g", "s", "y", "count", "gamma")

    starved = [0]

    def run(fn, pad):
        spans = []
        for _ in range(OP_TIMED_CALLS):
            args = [a[k].clone() for k in keys]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(pad)
            start.record()
            fn(*args)
            starved[0] += bool(start.query())
            end.record()
            spans.append((start, end))
        torch.cuda.synchronize()
        return sum(p.elapsed_time(q) for p, q in spans) / len(spans)

    runs = {"plain": [], "kernel": []}
    run(mods.wrappers[name], KERNEL_PAD)  # warm up
    for which in ("plain", "kernel", "kernel", "plain"):
        plain = which == "plain"
        runs[which].append(run(
            mods.plain_all[name] if plain else mods.wrappers[name],
            PLAIN_PAD if plain else KERNEL_PAD))
    bytes_ms = float(byts.sum()) / HBM_BYTES_PER_S * 1e3
    ops_ms = float(ops.sum()) / PEAK_OPS_PER_S["float32"] * 1e3
    return {
        "shape": [b, n], "ms": sum(runs["kernel"]) / 2,
        "plain_ms": sum(runs["plain"]) / 2, "ms_runs": runs["kernel"],
        "bytes_per_call": float(byts.sum()), "ops_per_call": float(ops.sum()),
        "starved_calls": starved[0], "padded_calls": 5 * OP_TIMED_CALLS,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def routing(mods, obj, x0, solver, stop, major_timing=None) -> dict:
    """The iteration-granular loop on the two history layouts side by side
    at one shape: device time per launch of the two prologues (spin-padded
    solves, as ``nested_timing``) and whole traced solves to the end on the
    host clock, batch-major, batch-minor, batch-minor, batch-major."""
    import torch

    cns = mods.cns
    b, n = x0.shape
    major = major_timing or nested_timing(mods, obj, x0, solver, stop,
                                          with_plain=False)
    minor = nested_timing(mods, obj, x0, solver, stop, batch_minor=True,
                          with_plain=(b, n) == HEADLINE_SHAPE)
    walls = {False: [], True: []}
    results = {}
    for batch_minor in (False, True, True, False):
        with mods.layout(batch_minor):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[batch_minor] = cns.minimize_batched(
                obj, x0, solver, stop, trace=1)
            torch.cuda.synchronize()
            walls[batch_minor].append(time.perf_counter() - t0)
    agree = float((results[True].progress.status
                   == results[False].progress.status).float().mean())
    row = {
        "shape": [b, n], "dtype": "float32",
        "major": major["kernels"]["lbfgs_prologue"],
        "minor": minor["kernels"]["lbfgs_prologue_t"],
        "minor_kernels": minor["kernels"],
        "major_solve_s_runs": walls[False], "minor_solve_s_runs": walls[True],
        "major_solve_s": sum(walls[False]) / 2,
        "minor_solve_s": sum(walls[True]) / 2,
        "iterations": {
            "major": int(results[False].progress.num_iterations.max()),
            "minor": int(results[True].progress.num_iterations.max())},
        "status_agreement": agree,
        "starved_calls": minor["starved_calls"] + (
            0 if major_timing else major["starved_calls"]),
    }
    log(f"[routing] ({b}, {n}) float32: lbfgs_prologue "
        f"{row['major']['ms']:.4f} ms/launch (bound "
        f"{row['major']['bound_ms']:.4f}), lbfgs_prologue_t "
        f"{row['minor']['ms']:.4f} ms/launch (bound "
        f"{row['minor']['bound_ms']:.4f}); traced solve on the host clock: "
        f"batch-major {row['major_solve_s']:.3f} s {walls[False]}, "
        f"batch-minor {row['minor_solve_s']:.3f} s {walls[True]}; status "
        f"agreement {agree:.4f}")
    mt = minor["kernels"]["mt_trip"]
    row["plan"] = mods.ft.prologue_t_launch_plan(b, M, n, x0.element_size())
    row["mt_mapping"] = vars(mods.fs.lane_mapping("mt_trip", b, n, M, 4))
    log(f"[routing] ({b}, {n}) float32 batch-minor: lbfgs_prologue_t plan "
        f"{json.dumps(row['plan'])}, byte bound with a shifting history "
        f"{row['minor']['bound_ms_shift']:.4f} ms; mt_trip "
        f"{mt['ms']:.4f} ms/launch (bound {mt['bound_ms']:.4f}, mapping "
        f"{json.dumps(row['mt_mapping'])})")
    return row


def rosenbrock_view(x):
    """The pairwise extended Rosenbrock written so that DTensor keeps it
    sharded over n: ``view(-1, 2)`` splits every shard into whole pairs."""
    import torch

    p = x.view(-1, 2)
    return torch.sum(100.0 * (p[:, 1] - p[:, 0] ** 2) ** 2
                     + (1.0 - p[:, 0]) ** 2)


def launch_counts(mods) -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    out = {name: w.launches for name, w in mods.wrappers.items()}
    out["flat_trip"] = mods.fs.flat_trip.launches
    return out


def zero_launches(mods) -> None:
    for w in mods.wrappers.values():
        w.launches = 0
    mods.fs.flat_trip.launches = 0


def uniform_start(b, n, lo, hi, dtype, dev):
    import numpy as np
    import torch

    x0 = np.random.default_rng(SEED).uniform(lo, hi, (b, n))
    return torch.from_numpy(x0).to(device=dev, dtype=dtype)


def timed_call(fn):
    """``(fn(), host seconds)`` between two synchronises."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def host_summary(res) -> dict | None:
    """A result's per-lane tensors, on the host, and its trips."""
    if res is None:
        return None
    out = {"x": res.state.x, "value": res.state.value,
           "nfev": res.state.nfev, "status": res.progress.status,
           "iterations": res.progress.num_iterations}
    out = {k: v.detach().cpu() for k, v in out.items()}
    out["trips"] = res.trips
    return out


def same_bits(got, want, keys=("status", "nfev", "iterations", "x")) -> dict:
    import torch

    return {k: bool(torch.equal(got[k], want[k])) for k in keys}


def logged_call(fn):
    """``fn()`` under the port's collective log: ``(result, collectives)``,
    the collectives by ``kind:elements``, split into those issued inside
    the solve's loop (before its last predicate read) and after it."""
    import torch

    from cppnumericalsolvers_tpu_torch.core.tree import any_lane
    from cppnumericalsolvers_tpu_torch.parallel.comm import CollectiveLog

    with CollectiveLog() as clog:
        out = fn()
        torch.cuda.synchronize()
    last = any_lane.reads
    split = {"in_loop": {}, "after": {}}
    for e in clog.entries:
        key = f"{e['kind']}:{e['numel']}"
        part = split["in_loop" if e["reads"] < last else "after"]
        part[key] = part.get(key, 0) + 1
    return out, split


def pair_cases(cns, dev):
    """Part (b)'s solves: (label, solver, global starts)."""
    import torch

    b, n = PARALLEL_PAIR_SHAPE
    return [
        ("lbfgs", cns.Lbfgs(m=M, max_linesearch_fev=MAX_FEV),
         uniform_start(b, n, -2.0, 2.0, torch.float32, dev)),
        ("lbfgsb", cns.Lbfgsb(m=5, lower=PARALLEL_BOX[0],
                              upper=PARALLEL_BOX[1]),
         uniform_start(b, n, *PARALLEL_BOX_STARTS, torch.float32, dev)),
    ]


def parallel_rank(rank: int, world: int, where: str) -> int:
    """One of part (b)'s gloo ranks (``chip_smoke.py --parallel-rank RANK
    WORLD DIR``), on card 0 with every other rank: the batch-sharded solves
    of :func:`pair_cases`, then the model-sharded solves of part (c) at
    MODEL_PAIR_N, of part (e) (:func:`model_lbfgsb_case`) and of part (f)
    (DENSE_RUNS at their two-rank shapes), each timed, then again under the
    collective log.  Writes its record to
    ``DIR/rank{RANK}.pt``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    mods = Mods()
    cns = mods.cns
    from cppnumericalsolvers_tpu_torch import parallel
    from cppnumericalsolvers_tpu_torch.core.tree import any_lane
    from cppnumericalsolvers_tpu_torch.parallel.comm import rank_device

    parallel.initialize_distributed(
        backend="gloo", rank=rank, world_size=world,
        store=dist.FileStore(os.path.join(where, "store"), world))
    dev = rank_device()
    obj = cns.models.pairwise_rosenbrock()
    stop32 = cns.default_stopping(torch.float32)
    rec = {"rank": rank, "device": str(dev)}
    try:
        mesh = parallel.make_mesh(axis="batch", device=dev)
        # A first solve warms the process (kernel libraries, allocator).
        warm = pair_cases(cns, dev)[0]
        parallel.minimize_sharded(obj, warm[2][:64], warm[1], stop32,
                                  mesh=mesh, device=dev)
        for label, solver, x0 in pair_cases(cns, dev):
            zero_launches(mods)
            res, wall = timed_call(lambda: parallel.minimize_sharded(
                obj, x0, solver, stop32, mesh=mesh, device=dev))
            rec[label] = {"result": host_summary(res),
                          "launches": launch_counts(mods), "wall_s": wall}
        model_mesh = parallel.make_mesh(axis="model", device=dev)
        x0 = torch.full((MODEL_PAIR_N,), -1.2, dtype=torch.float64,
                        device=dev)

        def model_solve():
            return parallel.minimize_model_sharded(
                cns.objective(rosenbrock_view), x0, cns.Lbfgs(m=M),
                mesh=model_mesh, device=dev)

        zero_launches(mods)
        reads0 = any_lane.reads
        res, wall = timed_call(model_solve)
        rec["model"] = {"result": host_summary(res),
                        "launches": launch_counts(mods), "wall_s": wall,
                        "reads": any_lane.reads - reads0}
        del res
        _, rec["model"]["collectives"] = logged_call(model_solve)

        x0, _, solver, stop = model_lbfgsb_case(cns, dev)

        def lbfgsb_solve():
            return parallel.minimize_model_sharded(
                cns.objective(rosenbrock_view), x0, solver, stop,
                mesh=model_mesh, device=dev)

        zero_launches(mods)
        reads0 = any_lane.reads
        passes0 = mods.lbb.generalized_cauchy_point.passes
        res, wall = timed_call(lbfgsb_solve)
        rec["model_lbfgsb"] = {
            "result": host_summary(res), "launches": launch_counts(mods),
            "wall_s": wall, "reads": any_lane.reads - reads0,
            "passes": mods.lbb.generalized_cauchy_point.passes - passes0}
        del res
        _, rec["model_lbfgsb"]["collectives"] = logged_call(lbfgsb_solve)
        dense = dense_mesh(world, dev)
        rec["dense"] = {run[0]: dense_sharded(mods, run, run[6], dense, dev,
                                              log=True)
                        for run in DENSE_RUNS}
    finally:
        dist.destroy_process_group()
    torch.save(rec, os.path.join(where, f"rank{rank}.pt"))
    return 0


PARALLEL_RANKS_DIR = os.path.join(ROOT, "build", "parallel_ranks")


def start_parallel_ranks(where: str = PARALLEL_RANKS_DIR) -> list:
    """Start PARALLEL_RANKS rank processes (:func:`parallel_rank`) on card
    0; :func:`wait_parallel_ranks` collects them.  ``main`` starts them
    with the constrained phase, so that their minute and a half overlaps
    it and the examples phase (whose processes also run beside it): the
    walls of both phases are taken beside them."""
    import shutil

    shutil.rmtree(where, ignore_errors=True)
    os.makedirs(where)
    env = {**os.environ, "LOCAL_RANK": "0", "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank",
         str(r), str(PARALLEL_RANKS), where],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(PARALLEL_RANKS)]


def wait_parallel_ranks(procs, where: str = PARALLEL_RANKS_DIR) -> list:
    """Wait for the rank processes and return their records.  A rank that
    fails or outlasts PARALLEL_RANK_TIMEOUT fails the phase; every process
    is stopped before this returns."""
    import torch

    outs = []
    deadline = time.perf_counter() + PARALLEL_RANK_TIMEOUT
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        for r in failed:
            log(f"[parallel] rank {r} exited {procs[r].returncode}:\n"
                + (outs[r] if r < len(outs) else "")[-4000:])
        raise AssertionError(f"parallel ranks {failed} failed")
    return [torch.load(os.path.join(where, f"rank{r}.pt"),
                       weights_only=False) for r in range(PARALLEL_RANKS)]


SIDE_DIR = os.path.join(ROOT, "build", "side")


def side_process(where: str) -> int:
    """The side process (``chip_smoke.py --side DIR``; see SIDE_TIMEOUT):
    :func:`suite_plain_passes`, then :func:`block_checks`, then part (f)'s
    world of one (:func:`dense_world_of_one`), each raising on failure;
    writes ``DIR/side.pt``."""
    import torch

    sys.path.insert(0, ROOT)
    mods = Mods()
    rec = {}
    t0 = time.perf_counter()
    rec["suite_plain"] = suite_plain_passes(mods)
    rec["suite_plain_s"] = time.perf_counter() - t0
    log(f"[side] the plain version's suite passes: "
        f"{rec['suite_plain_s']:.1f} s")
    t0 = time.perf_counter()
    rec["blocks"] = block_checks(mods, torch.device("cuda"))
    rec["blocks_s"] = time.perf_counter() - t0
    log(f"[side] block checks: {rec['blocks_s']:.1f} s")
    t0 = time.perf_counter()
    rec["dense"] = dense_world_of_one(mods, where)
    rec["dense_s"] = time.perf_counter() - t0
    log(f"[side] (f) world of one: {rec['dense_s']:.1f} s")
    torch.save(rec, os.path.join(where, "side.pt"))
    return 0


def start_side(where: str = SIDE_DIR):
    """Start the side process on card 0, its output to ``DIR/side.log``;
    it is stopped at exit if :func:`wait_side` has not collected it."""
    import atexit
    import shutil

    shutil.rmtree(where, ignore_errors=True)
    os.makedirs(where)
    out = open(os.path.join(where, "side.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--side", where],
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"}, stdout=out,
        stderr=subprocess.STDOUT, text=True)
    out.close()
    proc.started = time.perf_counter()

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc


def wait_side(proc, where: str = SIDE_DIR) -> dict:
    """The side process's record, once it has ended (SIDE_TIMEOUT after it
    started at the latest), its log repeated here; raises if it failed."""
    import torch

    try:
        proc.wait(timeout=max(1.0, proc.started + SIDE_TIMEOUT
                              - time.perf_counter()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(os.path.join(where, "side.log")) as f:
        text = f.read()
    for line in text.splitlines():
        if line.startswith("["):
            log(line)
    if proc.returncode != 0:
        log(f"[side] exited {proc.returncode}:\n" + text[-4000:])
        raise AssertionError("the side process failed")
    return torch.load(os.path.join(where, "side.pt"), weights_only=False)


def quadratic_whole(x):
    """tests/test_model_sharded.py's weighted quadratic, its weights built
    from x's own width (a plain constant: DTensor takes it as replicated,
    and the second-order evaluations on the gathered x as it is)."""
    import torch

    n = x.shape[-1]
    scale = 1.0 + torch.arange(n, dtype=x.dtype, device=x.device) / n
    return torch.sum(scale * x * x)


def dense_problem(cns, run, shape, dev):
    """``(objective, x0, solver, stopping)`` of one of DENSE_RUNS at
    ``shape``, float64."""
    import numpy as np
    import torch

    _, cls, kw, fn, mode, _, _, start, cut = run
    b, n = shape
    solver = getattr(cns, cls)(**kw)
    stop = solver.default_stopping(torch.float64)
    if cut:
        stop = stop.replace(max_iterations=cut)
    if start == "uniform":
        x0 = uniform_start(b, n, -2.0, 2.0, torch.float64, dev)
    elif start == "classic":
        x0 = torch.full((b, n), -1.2, dtype=torch.float64) * (
            1.0 + 0.05 * torch.arange(b, dtype=torch.float64))[:, None]
    elif start == "linspace":
        x0 = (torch.linspace(-2.0, 2.0, n, dtype=torch.float64)[None]
              * (1.0 + 0.25 * torch.arange(b, dtype=torch.float64))[:, None])
    else:  # part (e)'s start, one draw a lane
        x = np.ones((b, n))
        pairs = np.arange(0, n // 2, MODEL_LBFGSB_EVERY)
        x.reshape(b, -1, 2)[:, pairs] = np.random.default_rng(SEED).uniform(
            *PARALLEL_BOX_STARTS, (b, len(pairs), 2))
        x0 = torch.from_numpy(x)
    obj = cns.objective(rosenbrock_view if fn == "rosenbrock"
                        else quadratic_whole, mode)
    return obj, x0.to(dev), solver, stop


def dense_mesh(world, dev):
    """A (1, world) ("batch", "model") mesh: the runs' x0 are (B, n)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, (1, world),
                            mesh_dim_names=("batch", "model"))


def dense_sharded(mods, run, shape, mesh, dev, log=False) -> dict:
    """One model-sharded solve of ``run`` at ``shape``: its host summary,
    wall, launches and reads; with ``log`` also the collectives of a second
    solve cut at DENSE_LOG_ITERATIONS under the collective log and its
    iterations."""
    from cppnumericalsolvers_tpu_torch import parallel
    from cppnumericalsolvers_tpu_torch.core.tree import any_lane

    obj, x0, solver, stop = dense_problem(mods.cns, run, shape, dev)

    def solve(stop=stop):
        return parallel.minimize_model_sharded(
            obj, x0, solver, stop, mesh=mesh, batch_axis="batch",
            device=dev)

    zero_launches(mods)
    reads0 = any_lane.reads
    res, wall = timed_call(solve)
    out = {"result": host_summary(res), "wall_s": wall,
           "launches": launch_counts(mods), "reads": any_lane.reads - reads0}
    del res
    if log:
        cut, out["collectives"] = logged_call(lambda: solve(stop.replace(
            max_iterations=DENSE_LOG_ITERATIONS)))
        out["log_iterations"] = int(cut.progress.num_iterations.max())
    return out


def dense_world_of_one(mods, where, dev=None) -> dict:
    """Part (f) in a world of one under NCCL (the side process): each of
    DENSE_RUNS sharded at its world-of-one shape against the unsharded
    card solve through the plain versions, bit for bit, and, where the
    two ranks' shape differs, sharded at that shape too.  Raises on a
    difference or a launch."""
    import dataclasses

    import torch
    import torch.distributed as dist

    cns = mods.cns
    dev = torch.device("cuda") if dev is None else dev
    store = os.path.join(where, "dense_store")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    rows = {}
    try:
        mesh = dense_mesh(1, dev)
        for run in DENSE_RUNS:
            label, shape, pair_shape = run[0], run[5], run[6]
            obj, x0, solver, stop = dense_problem(cns, run, shape, dev)
            if hasattr(solver, "two_loop_impl"):
                solver = dataclasses.replace(solver, two_loop_impl="xla")
            zero_launches(mods)
            with mods.swapped({"mt_trip": mods.fl.mt_trip_reference}):
                ref, ref_wall = timed_call(lambda: cns.minimize_batched(
                    obj, x0, solver, stop, device=dev))
            ref_launches = launch_counts(mods)
            ref = host_summary(ref)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            got = dense_sharded(mods, run, shape, mesh, dev)
            res = got["result"]
            its = int(res["iterations"].max())
            row = {"shape": list(shape), "dtype": "float64", "ranks": 1,
                   "backend": "nccl", "wall_s": got["wall_s"],
                   "unsharded_wall_s": ref_wall,
                   "unsharded_launches": ref_launches,
                   "launches": got["launches"],
                   "iterations": its, "nfev": int(res["nfev"].sum()),
                   "reads_per_iteration": got["reads"] / max(its, 1),
                   "status": res["status"].tolist(),
                   "bit_equal": same_bits(res, ref),
                   "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                                if dev.type == "cuda" else None),
                   "result": res}
            if tuple(pair_shape) != tuple(shape):
                row["pair_width"] = dense_sharded(
                    mods, run, pair_shape, mesh, dev)
            rows[label] = row
            log(f"[side] (f) model-sharded {label} {tuple(shape)} float64, "
                f"world of one, NCCL: {its} iterations, nfev "
                f"{row['nfev']} over the lanes, wall {row['wall_s']:.3f} s "
                f"(unsharded {ref_wall:.3f} s), "
                f"{row['reads_per_iteration']:.1f} reads an iteration, peak "
                f"{row['peak_gib']} GiB; bit-equal to the unsharded solve "
                f"{row['bit_equal']}")
            if not all(row["bit_equal"].values()) or any(
                    got["launches"].values()) or any(ref_launches.values()):
                raise AssertionError(f"(f) {label}: {row}")
            del got
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        os.remove(store)
    return rows


def parallel_dense_record(side, ranks) -> dict:
    """Part (f): its world of one ran in the side process (``side``'s
    ``dense`` rows), its two ranks in part (b)'s rank processes (``ranks``:
    each rank's part (f) records); holds them to each other
    (:func:`parallel_dense_check`) and returns what the record keeps."""
    one = side["dense"]
    return {"world_of_one": {label: {k: v for k, v in row.items()
                                     if k not in ("result", "pair_width")}
                             for label, row in one.items()},
            "world_of_one_s": side["dense_s"],
            "two_ranks": parallel_dense_check(ranks, one)}


def parallel_dense_check(ranks, one) -> list:
    """Part (f) on part (b)'s two gloo ranks (``ranks``: each rank's part
    (f) records, by label) against the world of one (``one``:
    :func:`dense_world_of_one`'s rows) at the same shape:
    status, nfev and iterations equal on every rank, x within DENSE_XTOL,
    no launch; the collectives in each loop, per iteration of the logged
    solve, recorded."""
    rows = []
    for run in DENSE_RUNS:
        label, pair_shape = run[0], run[6]
        ref = one[label]
        want = (ref["pair_width"] if "pair_width" in ref else ref)["result"]
        recs = [r[label] for r in ranks]
        got = recs[0]["result"]
        its = int(got["iterations"].max())
        in_loop = recs[0]["collectives"]["in_loop"]
        log_its = recs[0]["log_iterations"]
        row = {"case": label, "shape": list(pair_shape), "dtype": "float64",
               "ranks": PARALLEL_RANKS, "backend": "gloo",
               "iterations": its, "nfev": int(got["nfev"].sum()),
               "same": {k: all(bool((r["result"][k] == want[k]).all())
                               for r in recs)
                        for k in ("status", "nfev", "iterations")},
               "x_max_abs_diff": max(
                   float((r["result"]["x"] - want["x"]).abs().max())
                   for r in recs),
               "wall_s_by_rank": [r["wall_s"] for r in recs],
               "reads_per_iteration": recs[0]["reads"] / max(its, 1),
               "launches_by_rank": [r["launches"] for r in recs],
               "collectives_per_iteration": {
                   k: v / max(log_its, 1) for k, v in in_loop.items()}}
        per_iteration = {k: round(v, 2) for k, v in
                         row["collectives_per_iteration"].items()}
        log(f"[parallel] (f) model-sharded {label} {tuple(pair_shape)} "
            f"float64, {PARALLEL_RANKS} gloo ranks on one card: {its} "
            f"iterations, nfev {row['nfev']} over the lanes, same as the "
            f"world of one {row['same']}, |x - x1| "
            f"{row['x_max_abs_diff']:.3e}, walls by rank "
            f"{[round(w, 3) for w in row['wall_s_by_rank']]} s, "
            f"{row['reads_per_iteration']:.1f} reads and collectives "
            f"{per_iteration} an iteration")
        launched = [c for c in row["launches_by_rank"] if any(c.values())]
        if (not all(row["same"].values()) or launched
                or row["x_max_abs_diff"] > DENSE_XTOL):
            raise AssertionError(f"(f) {label} on two ranks: {row}")
        rows.append(row)
    return rows


def _lane_leaves(res) -> int:
    """The tensor leaves of a result's state, progress and internals: one
    gather each."""
    from cppnumericalsolvers_tpu_torch.core.tree import tree_map

    leaves = []
    for part in (res.state, res.progress, res.internals):
        tree_map(leaves.append, part)
    return len(leaves)


def parallel_batch_world_of_one(mods, mesh, b, n, dev) -> dict:
    """Part (a) at one shape; see PARALLEL_SHAPES."""
    import torch

    from cppnumericalsolvers_tpu_torch import parallel

    cns = mods.cns
    obj = cns.models.pairwise_rosenbrock()
    solver = cns.Lbfgs(m=M, max_linesearch_fev=MAX_FEV)
    stop32 = cns.default_stopping(torch.float32)
    x0 = uniform_start(b, n, -2.0, 2.0, torch.float32, dev)

    def batched():
        return cns.minimize_batched(obj, x0, solver, stop32)

    def sharded():
        return parallel.minimize_sharded(obj, x0, solver, stop32, mesh=mesh,
                                         device=dev)

    # In turns: batched, sharded, sharded, batched; the first sharded solve
    # is the one whose launches count.
    ref, ref_wall = timed_call(batched)
    leaves = _lane_leaves(ref)
    ref = host_summary(ref)
    zero_launches(mods)
    res, wall = timed_call(sharded)
    launches = launch_counts(mods)
    got = host_summary(res)
    del res
    walls = [wall, timed_call(sharded)[1]]
    ref_walls = [ref_wall, timed_call(batched)[1]]
    _, coll = logged_call(lambda: parallel.minimize_sharded(
        obj, x0, solver, stop32, mesh=mesh, device=dev))
    row = {"shape": [b, n], "dtype": "float32", "trips": got["trips"],
           "launches": launches, "bit_equal": same_bits(got, ref),
           "sharded_wall_s": walls, "minimize_batched_wall_s": ref_walls,
           "batched_iterations": int(got["iterations"].max()),
           "collectives": coll, "gathered_leaves": leaves}
    log(f"[parallel] (a) world of one, NCCL, ({b}, {n}) float32: "
        f"{got['trips']} trips, flat_trip launches {launches['flat_trip']}, "
        f"bit-equal to minimize_batched {row['bit_equal']}, walls "
        f"{walls} s against {ref_walls} s; collectives in the loop "
        f"{coll['in_loop']}, after it {coll['after']}")
    if not all(row["bit_equal"].values()):
        raise AssertionError(f"(a) ({b}, {n}) differs: {row}")
    if launches["flat_trip"] != got["trips"] or got["trips"] <= 0 or any(
            v for k, v in launches.items() if k != "flat_trip"):
        raise AssertionError(f"(a) ({b}, {n}) launches: {launches}")
    if coll["in_loop"] or sum(
            v for k, v in coll["after"].items()
            if k.startswith("all_gather:")) != leaves or coll["after"].get(
            "all_reduce:1") != 1 or len(
            [k for k in coll["after"] if not k.startswith("all_gather:")
             ]) != 1:
        raise AssertionError(f"(a) ({b}, {n}) collectives: {coll}")
    return row


def parallel_pair_check(mods, ranks, dev) -> list:
    """Part (b): every rank holds the same whole result, equal bit for bit
    to this process's solve of each rank's block of lanes; launches per
    rank."""
    import torch

    cns = mods.cns
    obj = cns.models.pairwise_rosenbrock()
    stop32 = cns.default_stopping(torch.float32)
    rows = []
    for label, solver, x0 in pair_cases(cns, dev):
        got = ranks[0][label]["result"]
        agree_ranks = all(all(same_bits(r[label]["result"], got).values())
                          for r in ranks[1:])
        lanes = x0.shape[0] // PARALLEL_RANKS
        blocks = [host_summary(cns.minimize_batched(
            obj, x0[i * lanes:(i + 1) * lanes], solver, stop32))
            for i in range(PARALLEL_RANKS)]
        want = {k: torch.cat([blk[k] for blk in blocks])
                for k in ("x", "value", "nfev", "status", "iterations")}
        whole = host_summary(cns.minimize_batched(obj, x0, solver, stop32))
        # Whether the objective's bits at the start depend on the batch it
        # is evaluated in (the reductions' launch shapes differ).
        f_all, g_all = obj.batched_value_and_grad(x0)
        f_blk, g_blk = obj.batched_value_and_grad(x0[:lanes])
        eval_same = bool(torch.equal(f_all[:lanes], f_blk)
                         and torch.equal(g_all[:lanes], g_blk))
        # And those of a batched product of L-BFGS-B's kind, W^T W of its
        # (B, 2m, n) W at m = 5 (cuBLAS picks its algorithm by the batch).
        hist = uniform_start(x0.shape[0] * 10, x0.shape[1], -1.0, 1.0,
                             x0.dtype, dev).view(x0.shape[0], 10, -1)
        gram = hist @ hist.transpose(-1, -2)
        gram_blk = hist[:lanes] @ hist[:lanes].transpose(-1, -2)
        gemm_same = bool(torch.equal(gram[:lanes], gram_blk))
        # How far the block and the whole batch are apart after one
        # iteration: [lanes whose x differs, largest |dx|] by precision.
        first = {}
        for dt in (torch.float32, torch.float64):
            one = cns.default_stopping(dt).replace(max_iterations=1)
            xw = cns.minimize_batched(obj, x0.to(dt), solver, one).state.x
            xb = cns.minimize_batched(obj, x0[:lanes].to(dt), solver,
                                      one).state.x
            first[str(dt).split(".")[1]] = [
                int((xw[:lanes] != xb).any(-1).sum()),
                float((xw[:lanes] - xb).abs().max())]
        launches = [r[label]["launches"] for r in ranks]
        kernel = "flat_trip" if label == "lbfgs" else "mt_trip"
        row = {"case": label, "shape": list(x0.shape), "dtype": "float32",
               "ranks": PARALLEL_RANKS, "backend": "gloo",
               "trips": got["trips"],
               "bit_equal_to_blocks": same_bits(got, want),
               "ranks_agree": agree_ranks,
               "status_agreement_whole_batch": float(
                   (got["status"] == whole["status"]).double().mean()),
               "x_max_abs_diff_whole_batch": float(
                   (got["x"] - whole["x"]).abs().max()),
               "whole_batch_converged_share": float(torch.isin(
                   whole["status"],
                   torch.tensor(cns.CONVERGED_STATUSES)).double().mean()),
               "evaluation_bit_equal_in_a_block": eval_same,
               "batched_product_bit_equal_in_a_block": gemm_same,
               "one_iteration_lanes_apart": first,
               "launches_by_rank": launches,
               "wall_s_by_rank": [r[label]["wall_s"] for r in ranks],
               "converged_share": float(torch.isin(
                   got["status"],
                   torch.tensor(cns.CONVERGED_STATUSES)).double().mean())}
        log(f"[parallel] (b) {PARALLEL_RANKS} gloo ranks on one card, "
            f"{label} {tuple(x0.shape)} float32: {got['trips']} trips; "
            f"{kernel} launches by rank "
            f"{[c[kernel] for c in launches]}; bit-equal to the blocks "
            f"solved here {row['bit_equal_to_blocks']}; status agreement "
            f"with the whole batch solved here "
            f"{row['status_agreement_whole_batch']:.4f} (x within "
            f"{row['x_max_abs_diff_whole_batch']:.3e}; converged "
            f"{row['converged_share']:.4f} against "
            f"{row['whole_batch_converged_share']:.4f}; the start evaluated "
            f"in a block bit-equal to the whole batch's: {eval_same}; a "
            f"batched product's: {gemm_same}; after one iteration [lanes "
            f"apart of {lanes}, largest |dx|]: {first})")
        if not (agree_ranks and all(row["bit_equal_to_blocks"].values())):
            raise AssertionError(f"(b) {label} differs: {row}")
        if label == "lbfgsb":
            # A lane's bits do not depend on the batch it is solved in
            # (its products are per-lane contractions in a fixed order).
            row["bit_equal_to_whole_batch"] = same_bits(
                got, whole, ("status", "nfev", "x"))
            if not all(row["bit_equal_to_whole_batch"].values()) or any(
                    apart for apart, _ in first.values()):
                raise AssertionError(f"(b) lbfgsb against the whole batch: "
                                     f"{row}")
        if min(c[kernel] for c in launches) <= 0 or (
                label == "lbfgs"
                and max(c[kernel] for c in launches) != got["trips"]):
            raise AssertionError(f"(b) {label} launches: {launches}")
        if label == "lbfgsb" and not bool(
                ((got["x"] >= PARALLEL_BOX[0])
                 & (got["x"] <= PARALLEL_BOX[1])).all()):
            raise AssertionError("(b) lbfgsb left its box")
        rows.append(row)
    return rows


def block_against_batch(cns, obj, solver, x0, stop, blocks=2) -> dict:
    """Solve ``x0`` whole and as ``blocks`` contiguous blocks of lanes, each
    solve tracing its first iteration: the lanes whose status, nfev or x at
    the end differ in any bit, those whose first iteration's trace (value,
    gradient and step norms, status) differs, the largest |dx|, and the
    seconds of the solves."""
    import torch

    def summary(res):
        out = host_summary(res)
        out["first"] = torch.stack([
            getattr(res.trace, f)[:, 0].double().cpu()
            for f in ("value", "gradient_norm", "x_delta", "status")], -1)
        return out

    t0 = time.perf_counter()
    whole = summary(cns.minimize_batched(obj, x0, solver, stop, trace=1))
    lanes = x0.shape[0] // blocks
    parts = [summary(cns.minimize_batched(
        obj, x0[i * lanes:(i + 1) * lanes], solver, stop, trace=1))
        for i in range(blocks)]
    got = {k: torch.cat([p[k] for p in parts])
           for k in ("status", "nfev", "x", "first")}

    def apart(k):
        a, b = got[k], whole[k]
        differ = (a != b) & ~(a.isnan() & b.isnan())  # unwritten trace: NaN
        return int(differ.reshape(a.shape[0], -1).any(-1).sum())

    return {
        "status": apart("status"), "nfev": apart("nfev"), "x": apart("x"),
        "first_iteration": apart("first"),
        "max_abs_dx": float((got["x"] - whole["x"]).abs().max()),
        "seconds": time.perf_counter() - t0,
    }


def block_checks(mods, dev) -> list:
    """Part (b)'s block-against-batch checks beyond the two ranks' solve,
    each as two blocks against the whole batch, every lane bit-equal at
    the end (status, nfev, x) and after its first iteration (the trace):
    L-BFGS-B at PARALLEL_PAIR_SHAPE to its end in float64 (float32, and one
    iteration's x in both precisions, beside the two ranks); L-BFGS-B at
    BLOCK_PAIR_SHAPE (8 lanes of n = 4096, where PyTorch splits a long
    row's sum by the number of rows) to its end in both precisions; then
    BLOCK_DENSE at their SOLVER_RUNS shapes, one iteration in both
    precisions (their full solves, 40 s more, were bit-equal by block on
    the card: PERF.md §6), BFGS and the trust region held to it, Newton
    recorded (its batched solve is a library call)."""
    import torch

    cns = mods.cns
    obj = cns.models.pairwise_rosenbrock()
    rows = []

    def check(label, solver, x0, tobj, dname, budget, hold):
        dtype = getattr(torch, dname)
        stop = solver.default_stopping(dtype)
        if budget:
            stop = stop.replace(max_iterations=budget)
        row = {"case": label, "shape": list(x0.shape), "dtype": dname,
               "iterations": budget or "to the end", "held": hold,
               "lanes_apart": block_against_batch(
                   cns, tobj, solver, x0.to(dtype), stop)}
        rows.append(row)
        apart = row["lanes_apart"]
        log(f"[parallel] (b) block against whole batch, {label} "
            f"{tuple(x0.shape)} {dname}, {row['iterations']} iterations: "
            f"lanes apart in status {apart['status']}, nfev "
            f"{apart['nfev']}, x {apart['x']} (largest |dx| "
            f"{apart['max_abs_dx']:.3e}), first iteration "
            f"{apart['first_iteration']}; {apart['seconds']:.1f} s")
        if hold and any(apart[k] for k in ("status", "nfev", "x",
                                           "first_iteration")):
            raise AssertionError(f"(b) {label} parts by block: {row}")

    box = cns.Lbfgsb(m=5, lower=PARALLEL_BOX[0], upper=PARALLEL_BOX[1])
    b, n = PARALLEL_PAIR_SHAPE
    x0 = uniform_start(b, n, *PARALLEL_BOX_STARTS, torch.float64, dev)
    check("lbfgsb", box, x0, obj, "float64", 0, True)
    b, n = BLOCK_PAIR_SHAPE
    x0 = uniform_start(b, n, *PARALLEL_BOX_STARTS, torch.float64, dev)
    for dname in ("float32", "float64"):
        check("lbfgsb", box, x0, obj, dname, 0, True)
    for run in SOLVER_RUNS:
        label, cls, kw, (b, n), mode = run[:5]
        if label not in BLOCK_DENSE:
            continue
        solver = getattr(cns, cls)(**kw)
        tobj = obj if mode == "second" else obj.with_mode(mode)
        x0 = uniform_start(b, n, -2.0, 2.0, torch.float64, dev)
        for dname in ("float32", "float64"):
            check(label, solver, x0, tobj, dname, 1, label != "newton")
    return rows


def parallel_model_world_of_one(mods, mesh, n, dev, unsharded):
    """Part (c) in this process's world of one at ``n``: the model-sharded
    solve (timed, then under the collective log) and, with ``unsharded``,
    the plain ``minimize`` it must equal bit for bit.  Returns the record
    and the result's host summary."""
    import torch

    from cppnumericalsolvers_tpu_torch import parallel
    from cppnumericalsolvers_tpu_torch.core.tree import any_lane

    cns = mods.cns
    mobj = cns.objective(rosenbrock_view)
    x0 = torch.full((n,), -1.2, dtype=torch.float64, device=dev)
    row = {"n": n, "dtype": "float64", "ranks": 1, "backend": "nccl"}
    if unsharded:
        zero_launches(mods)
        ref, row["unsharded_wall_s"] = timed_call(lambda: cns.minimize(
            mobj, x0, cns.Lbfgs(m=M, two_loop_impl="xla")))
        row["unsharded_launches"] = launch_counts(mods)
        ref = host_summary(ref)

    def solve():
        return parallel.minimize_model_sharded(
            mobj, x0, cns.Lbfgs(m=M), mesh=mesh, device=dev)

    zero_launches(mods)
    reads0 = any_lane.reads
    res, row["wall_s"] = timed_call(solve)
    row["reads"] = any_lane.reads - reads0
    row["launches"] = launch_counts(mods)
    got = host_summary(res)
    del res
    _, row["collectives"] = logged_call(solve)
    its = int(got["iterations"])
    row.update(iterations=its, nfev=int(got["nfev"]),
               status=int(got["status"]), value=float(got["value"]),
               reads_per_iteration=row["reads"] / max(its, 1),
               all_reduces_per_iteration=sum(
                   row["collectives"]["in_loop"].values()) / max(its, 1))
    if unsharded:
        row["bit_equal"] = same_bits(got, ref)
    log(f"[parallel] (c) world of one, NCCL, n = {n} float64: "
        f"{its} iterations, nfev {row['nfev']}, status {row['status']}, "
        f"wall {row['wall_s']:.3f} s, {row['reads_per_iteration']:.2f} "
        f"reads an iteration, collectives in the loop "
        f"{row['collectives']['in_loop']}"
        + (f"; bit-equal to the unsharded solve {row['bit_equal']} (its "
           f"wall {row['unsharded_wall_s']:.3f} s)" if unsharded else ""))
    bad = [k for k in row["collectives"]["in_loop"] if k != "all_reduce:1"]
    if bad or any(row["launches"].values()) or (
            unsharded and (not all(row["bit_equal"].values())
                           or any(row["unsharded_launches"].values()))):
        raise AssertionError(f"(c) n = {n}: {row}")
    return row, got


def parallel_model_pair_check(ranks, one) -> dict:
    """Part (c) on two gloo ranks against the world of one at the same n."""
    import numpy as np

    got = ranks[0]["model"]["result"]
    its = int(got["iterations"])
    row = {"n": MODEL_PAIR_N, "dtype": "float64", "ranks": PARALLEL_RANKS,
           "backend": "gloo", "iterations": its, "nfev": int(got["nfev"]),
           "status": int(got["status"]),
           "x_max_abs_diff": float((got["x"] - one["x"]).abs().max()),
           "value_rel_diff": abs(float(got["value"]) - float(one["value"]))
           / max(abs(float(one["value"])), 1e-300),
           "wall_s_by_rank": [r["model"]["wall_s"] for r in ranks],
           "reads_per_iteration": ranks[0]["model"]["reads"] / max(its, 1),
           "launches_by_rank": [r["model"]["launches"] for r in ranks],
           "collectives_by_rank": [r["model"]["collectives"]
                                   for r in ranks]}
    row["all_reduces_per_iteration"] = sum(
        ranks[0]["model"]["collectives"]["in_loop"].values()) / max(its, 1)
    same = (row["status"] == int(one["status"])
            and row["nfev"] == int(one["nfev"])
            and all(int(r["model"]["result"]["nfev"]) == row["nfev"]
                    for r in ranks))
    close = (row["x_max_abs_diff"] <= MODEL_XTOL
             and np.isclose(float(got["value"]), float(one["value"]),
                            rtol=MODEL_VALUE_RTOL, atol=1e-12))
    bad = [k for r in ranks for k in r["model"]["collectives"]["in_loop"]
           if k != "all_reduce:1"]
    launched = [c for c in row["launches_by_rank"] if any(c.values())]
    log(f"[parallel] (c) {PARALLEL_RANKS} gloo ranks on one card, n = "
        f"{MODEL_PAIR_N} float64: {its} iterations, nfev {row['nfev']} "
        f"(world of one {int(one['nfev'])}), status {row['status']}, |x - "
        f"x1| {row['x_max_abs_diff']:.3e}, value rel diff "
        f"{row['value_rel_diff']:.3e}, {row['all_reduces_per_iteration']:.1f}"
        f" all-reduces an iteration, collectives in the loop "
        f"{ranks[0]['model']['collectives']['in_loop']}")
    if not (same and close) or bad or launched:
        raise AssertionError(f"(c) two ranks: {row}")
    return row


def parallel_xla_alone(mods, dev) -> dict:
    """Part (d); see XLA_SHAPE."""
    import torch

    from cppnumericalsolvers_tpu_torch.core.tree import any_lane

    cns, K = mods.cns, mods.K
    obj = cns.models.pairwise_rosenbrock()
    stop32 = cns.default_stopping(torch.float32)
    b, n = XLA_SHAPE
    x0 = uniform_start(b, n, -2.0, 2.0, torch.float32, dev)
    zero_launches(mods)
    reads0 = any_lane.reads
    res, wall = timed_call(lambda: cns.minimize_batched(
        obj, x0, cns.Lbfgs(m=M, two_loop_impl="xla"), stop32))
    launches = launch_counts(mods)
    row = {"shape": [b, n], "dtype": "float32", "wall_s": wall,
           "trips": res.trips, "reads": any_lane.reads - reads0,
           "launches": launches,
           "iterations": res.progress.num_iterations.tolist(),
           "status": res.progress.status.tolist(),
           "converged_share": converged_share(res, cns)}
    want = host_summary(res)
    del res
    # The default "auto" runs the flat solve's kernel here, q in device
    # memory: one flat_trip launch a trip and nothing else.
    row["auto_rows"] = K.lane_mapping("flat_trip", b, n, M, 4).rows
    zero_launches(mods)
    auto, row["auto_wall_s"] = timed_call(lambda: cns.minimize_batched(
        obj, x0, cns.Lbfgs(m=M), stop32))
    row["auto_launches"] = {k: v for k, v in launch_counts(mods).items()
                            if v}
    got = host_summary(auto)
    row.update(auto_trips=got["trips"],
               auto_iterations=got["iterations"].tolist(),
               auto_status=got["status"].tolist(),
               auto_converged_share=converged_share(auto, cns),
               auto_status_agreement=float(
                   (got["status"] == want["status"]).float().mean()),
               auto_x_max_abs_diff=float((got["x"] - want["x"]).abs().max()))
    del auto
    log(f"[parallel] (d) Lbfgs(two_loop_impl='xla') at ({b}, {n}) float32: "
        f"statuses {row['status']}, iterations {row['iterations']}, "
        f"{want['trips']} trips, wall {wall:.3f} s, launches "
        f"{sum(launches.values())}; 'auto' (rows mode {row['auto_rows']}): "
        f"statuses {row['auto_status']}, iterations "
        f"{row['auto_iterations']}, {row['auto_trips']} trips, launches "
        f"{row['auto_launches']}, wall {row['auto_wall_s']:.3f} s, largest "
        f"|x - x_xla| {row['auto_x_max_abs_diff']:.3e}")
    if any(launches.values()) or row["converged_share"] < 1.0 or (
            row["auto_converged_share"] < 1.0
            or row["auto_rows"] != K.ROWS_DEVICE_Q
            or row["auto_launches"] != {"flat_trip": row["auto_trips"]}):
        raise AssertionError(f"(d): {row}")
    return row


def padded_ms(fn, calls=FLOOR_TIMED_LAUNCHES, pad=KERNEL_PAD):
    """Device ms a call of ``fn()`` over ``calls`` calls enqueued behind a
    spin kernel (see :class:`Timed`), and whether the card had run dry
    before the last was enqueued (starved)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(pad)
    a.record()
    for _ in range(calls):
        fn()
    starved = a.query()
    z.record()
    torch.cuda.synchronize()
    return a.elapsed_time(z) / calls, bool(starved)


def floors_main(mods, dev) -> dict:
    """The calibration kernels of ``benchmarks_torch/roofline.py`` (the
    ``floors_main`` phase), on the calibration's (8, 128) float32 buffers
    from seed 0:

    * each kernel against its plain version, bit for bit, after one launch
      and after FLOOR_CHAIN's launches (``trip_floor`` in place on 8
      buffers, as many times as the trip floor's longer loop runs;
      ``launch_floor`` chained as the launch floor's longer chain);
    * device ms a launch, spin-padded, of the kernel, of its plain version
      and, for ``launch_floor``, of ``torch.add(x, 1.0, out=o)`` (the one
      PyTorch call that computes it), in the order plain, kernel, kernel,
      plain, library; the bound: bytes at 3.35 TB/s;
    * the two calibrations, once each, with the launch counts set to 0
      just before and read just after: the trip floor (host and device
      microseconds a trip) and the launch floor (host and graph
      microseconds a launch).

    Raises on a difference or where a kernel did not launch."""
    import numpy as np
    import torch

    from benchmarks_torch import roofline

    F = mods.floors
    shape = roofline.FLOOR_SHAPE
    rng = np.random.default_rng(SEED)

    def seeded():
        return torch.from_numpy(rng.uniform(-2.0, 2.0, shape)).to(
            device=dev, dtype=torch.float32)

    rec = {"kernels": {}}
    bufs = [seeded() for _ in range(F.TRIP_FLOOR_BUFFERS)]
    x0 = seeded()
    kern = [b.clone() for b in bufs]
    plain = [b.clone() for b in bufs]
    ka, kb = x0.clone(), torch.empty_like(x0)
    px = x0.clone()
    same = {"trip_floor": {}, "launch_floor": {}}
    done = 0
    for upto in (1, max(FLOOR_CHAIN.values())):
        while done < upto:
            if done < FLOOR_CHAIN["trip_floor"]:
                F.trip_floor(kern)
                F.trip_floor_reference(plain)
            F.launch_floor(ka, out=kb)
            ka, kb = kb, ka
            px = F.launch_floor_reference(px)
            done += 1
        torch.cuda.synchronize()
        same["trip_floor"][min(upto, FLOOR_CHAIN["trip_floor"])] = all(
            torch.equal(k, p) for k, p in zip(kern, plain))
        same["launch_floor"][upto] = bool(torch.equal(ka, px))
    errs = {"trip_floor": max(float((k - p).abs().max())
                              for k, p in zip(kern, plain)),
            "launch_floor": float((ka - px).abs().max())}

    out = torch.empty_like(x0)
    calls = {
        "trip_floor": (lambda: F.trip_floor(kern),
                       lambda: F.trip_floor_reference(plain), None),
        "launch_floor": (lambda: F.launch_floor(x0, out=out),
                         lambda: F.launch_floor_reference(x0),
                         lambda: torch.add(x0, 1.0, out=out)),
    }
    item = x0.element_size()
    work = {"trip_floor": (2 * F.TRIP_FLOOR_BUFFERS * x0.numel() * item,
                           2 * F.TRIP_FLOOR_BUFFERS * x0.numel()),
            "launch_floor": (2 * x0.numel() * item, x0.numel())}
    for name, (kfn, pfn, lfn) in calls.items():
        runs = {"plain": [], "kernel": [], "library": []}
        starved = []
        order = ["plain", "kernel", "kernel", "plain"] + (
            ["library"] if lfn else [])
        for which in order:
            fn = {"plain": pfn, "kernel": kfn, "library": lfn}[which]
            if which == "plain":
                ms, dry = padded_ms(fn, FLOOR_TIMED_PLAIN_CALLS, PLAIN_PAD)
            else:
                ms, dry = padded_ms(fn)
            runs[which].append(ms)
            if dry:
                starved.append(which)
        byts, ops = work[name]
        bytes_ms = byts / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS_PER_S["float32"] * 1e3
        rec["kernels"][name] = {
            "shape": list(shape), "dtype": "float32",
            "bit_equal_after": same[name], "max_abs_err": errs[name],
            "ms": sum(runs["kernel"]) / 2,
            "plain_ms": sum(runs["plain"]) / 2,
            "library_ms": runs["library"][0] if lfn else None,
            "kernel_ms_runs": runs["kernel"], "plain_ms_runs": runs["plain"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "starved_timed_runs": starved,
        }

    F.trip_floor.launches = F.launch_floor.launches = 0
    t0 = time.perf_counter()
    rec["trip"] = roofline.measure_loop_trip_overhead_us(device=dev)
    rec["launch"] = roofline.measure_launch_overhead_us(device=dev)
    rec["calibration_s"] = time.perf_counter() - t0
    rec["launches"] = {"trip_floor": F.trip_floor.launches,
                       "launch_floor": F.launch_floor.launches}
    rec["calibration"] = {
        "trip_floor_host_us": rec["trip"]["host_us"],
        "trip_floor_device_us": rec["trip"]["device_us"],
        "launch_host_us": rec["launch"]["host_us"],
        "launch_graph_us": rec["launch"]["graph_us"],
    }
    for name, k in rec["kernels"].items():
        log(f"[floors] {name} {tuple(shape)} float32: bit-equal to the "
            f"plain version after {k['bit_equal_after']} launches, kernel "
            f"{k['ms']:.4f} ms/launch, plain {k['plain_ms']:.4f} ms/call, "
            + (f"torch.add {k['library_ms']:.4f} ms/call, "
               if k["library_ms"] is not None else "")
            + f"bound {k['bound_ms']:.6f} ms ({k['bound_by']}); starved "
            f"timed runs {k['starved_timed_runs']}")
    cal = rec["calibration"]
    device_us = cal["trip_floor_device_us"]
    log(f"[floors] calibration ({rec['calibration_s']:.1f} s): trip floor "
        f"{cal['trip_floor_host_us']:.2f} us a trip on the host clock, "
        + (f"{device_us:.2f} us" if device_us is not None
           else "not measured")
        + f" of the card's busy time; launch {cal['launch_host_us']:.3f} us "
        f"from the host, {cal['launch_graph_us']:.3f} us in a CUDA graph; "
        f"launches {rec['launches']} | {card_line()}")
    for name, k in rec["kernels"].items():
        if not all(k["bit_equal_after"].values()) or k["max_abs_err"]:
            raise AssertionError(f"floors: {name} differs from plain: {k}")
        if rec["launches"][name] <= 0:
            raise AssertionError(f"floors: {name} never launched")
    return rec


def model_lbfgsb_case(cns, dev):
    """Part (e)'s solve: ``(x0, drawn pairs, solver, stopping)``; see
    MODEL_LBFGSB_N."""
    import numpy as np
    import torch

    n = MODEL_LBFGSB_N
    x = np.ones(n)
    pairs = np.arange(0, n // 2, MODEL_LBFGSB_EVERY)
    x.reshape(-1, 2)[pairs] = np.random.default_rng(SEED).uniform(
        *PARALLEL_BOX_STARTS, (len(pairs), 2))
    solver = cns.Lbfgsb(m=5, lower=PARALLEL_BOX[0], upper=PARALLEL_BOX[1])
    stop = solver.default_stopping(torch.float64).replace(
        max_iterations=MODEL_LBFGSB_CUT)
    return torch.from_numpy(x).to(dev), len(pairs), solver, stop


@contextlib.contextmanager
def walk_passes(lbb):
    """The Cauchy passes of each walk that ``Lbfgsb.step`` runs inside the
    context, in order (a list filled as the walks end)."""
    walk = lbb.generalized_cauchy_point
    walks = []

    def counted(*args, **kwargs):
        # The walk's body counts its passes on the module's name for it,
        # which is this function inside the context.
        start = counted.passes
        out = walk(*args, **kwargs)
        walks.append(counted.passes - start)
        return out

    counted.passes = walk.passes
    lbb.generalized_cauchy_point = counted
    try:
        yield walks
    finally:
        walk.passes = counted.passes
        lbb.generalized_cauchy_point = walk


def parallel_model_lbfgsb(mods, mesh, dev):
    """Part (e); see MODEL_LBFGSB_N.  Returns the record and the model-
    sharded result's host summary."""
    import torch

    from cppnumericalsolvers_tpu_torch import parallel
    from cppnumericalsolvers_tpu_torch.core.tree import any_lane

    cns, lbb = mods.cns, mods.lbb
    n = MODEL_LBFGSB_N
    x0, drawn, solver, stop = model_lbfgsb_case(cns, dev)
    mobj = cns.objective(rosenbrock_view)
    row = {"n": n, "dtype": "float64", "ranks": 1, "backend": "nccl",
           "drawn_pairs": drawn, "cut": MODEL_LBFGSB_CUT}

    def counted(fn):
        zero_launches(mods)
        passes0, reads0 = lbb.generalized_cauchy_point.passes, any_lane.reads
        out, wall = timed_call(fn)
        return (host_summary(out), wall, launch_counts(mods),
                lbb.generalized_cauchy_point.passes - passes0,
                any_lane.reads - reads0)

    ref, row["unsharded_wall_s"], row["unsharded_launches"], \
        row["unsharded_passes"], row["unsharded_reads"] = counted(
            lambda: cns.minimize(mobj, x0, solver, stop))

    def solve():
        return parallel.minimize_model_sharded(
            mobj, x0, solver, stop, mesh=mesh, device=dev)

    with walk_passes(lbb) as walks:
        got, row["wall_s"], row["launches"], row["passes"], row["reads"] = (
            counted(solve))
    row["passes_by_walk"] = walks
    _, row["collectives"] = logged_call(solve)
    its = int(got["iterations"])
    in_loop = row["collectives"]["in_loop"]
    row.update(
        iterations=its, nfev=int(got["nfev"]), status=int(got["status"]),
        value=float(got["value"]),
        unsharded=dict(iterations=int(ref["iterations"]),
                       nfev=int(ref["nfev"]), status=int(ref["status"])),
        x_max_abs_diff=float((got["x"] - ref["x"]).abs().max()),
        passes_per_iteration=row["passes"] / max(its, 1),
        passes_first_iteration=walks[0],
        passes_per_later_iteration=sum(walks[1:]) / max(len(walks) - 1, 1),
        reads_per_iteration=row["reads"] / max(its, 1),
        all_reduces_per_iteration=sum(
            v for k, v in in_loop.items() if k.startswith("all_reduce"))
        / max(its, 1),
        all_gathers_per_iteration=sum(
            v for k, v in in_loop.items() if k.startswith("all_gather"))
        / max(its, 1))
    log(f"[parallel] (e) model-sharded Lbfgsb, world of one, NCCL, n = {n} "
        f"float64, cut {MODEL_LBFGSB_CUT}: {its} iterations, nfev "
        f"{row['nfev']}, status {row['status']} (unsharded {row['unsharded']}"
        f"), |x - x_unsharded| {row['x_max_abs_diff']:.3e}; "
        f"{row['passes']} Cauchy passes ({row['passes_per_iteration']:.1f} an "
        f"iteration: {walks[0]} in the first, "
        f"{row['passes_per_later_iteration']:.2f} in each of the "
        f"{len(walks) - 1} others; unsharded {row['unsharded_passes']}), "
        f"{row['all_reduces_per_iteration']:.1f} all-reduces and "
        f"{row['all_gathers_per_iteration']:.1f} all-gathers an iteration, "
        f"{row['reads_per_iteration']:.1f} reads an iteration; wall "
        f"{row['wall_s']:.3f} s (unsharded {row['unsharded_wall_s']:.3f} s, "
        f"launches {row['unsharded_launches']}); collectives in the loop "
        f"{in_loop}")
    same = (row["status"] == row["unsharded"]["status"]
            and row["nfev"] == row["unsharded"]["nfev"]
            and its == row["unsharded"]["iterations"])
    if (not same or row["x_max_abs_diff"] > MODEL_LBFGSB_XTOL
            or any(row["launches"].values()) or row["passes"] == 0
            or row["unsharded_launches"]["mt_trip"] == 0
            or sum(walks) != row["passes"]):
        raise AssertionError(f"(e): {row}")
    return row, got


def parallel_model_lbfgsb_pair_check(ranks, one) -> dict:
    """Part (e) on part (b)'s two gloo ranks against the world of one
    (``one``, its host summary): status, nfev and iterations equal on every
    rank, x within MODEL_LBFGSB_XTOL, no launch, and in the loop only the
    walk's all-gathers and the all-reduces."""
    got = ranks[0]["model_lbfgsb"]["result"]
    its = int(got["iterations"])
    in_loop = ranks[0]["model_lbfgsb"]["collectives"]["in_loop"]
    row = {"n": MODEL_LBFGSB_N, "dtype": "float64", "ranks": PARALLEL_RANKS,
           "backend": "gloo", "iterations": its, "nfev": int(got["nfev"]),
           "status": int(got["status"]),
           "x_max_abs_diff": max(
               float((r["model_lbfgsb"]["result"]["x"] - one["x"])
                     .abs().max()) for r in ranks),
           "passes": ranks[0]["model_lbfgsb"]["passes"],
           "wall_s_by_rank": [r["model_lbfgsb"]["wall_s"] for r in ranks],
           "reads_per_iteration": ranks[0]["model_lbfgsb"]["reads"]
           / max(its, 1),
           "launches_by_rank": [r["model_lbfgsb"]["launches"]
                                for r in ranks],
           "collectives_by_rank": [r["model_lbfgsb"]["collectives"]
                                   for r in ranks]}
    row["all_reduces_per_iteration"] = sum(
        v for k, v in in_loop.items() if k.startswith("all_reduce")) / max(
            its, 1)
    row["all_gathers_per_iteration"] = sum(
        v for k, v in in_loop.items() if k.startswith("all_gather")) / max(
            its, 1)
    same = all(
        int(r["model_lbfgsb"]["result"][k]) == int(one[k])
        for r in ranks for k in ("status", "nfev", "iterations"))
    bad = [k for r in ranks for k in r["model_lbfgsb"]["collectives"][
        "in_loop"] if not k.startswith(("all_reduce", "all_gather"))]
    launched = [c for c in row["launches_by_rank"] if any(c.values())]
    log(f"[parallel] (e) {PARALLEL_RANKS} gloo ranks on one card, n = "
        f"{MODEL_LBFGSB_N} float64, cut {MODEL_LBFGSB_CUT}: {its} "
        f"iterations, nfev {row['nfev']} (world of one {int(one['nfev'])}), "
        f"status {row['status']}, |x - x1| {row['x_max_abs_diff']:.3e}; "
        f"{row['passes']} Cauchy passes, "
        f"{row['all_reduces_per_iteration']:.1f} all-reduces and "
        f"{row['all_gathers_per_iteration']:.1f} all-gathers an iteration, "
        f"walls by rank {row['wall_s_by_rank']}; collectives in the loop "
        f"{in_loop}")
    if (not same or row["x_max_abs_diff"] > MODEL_LBFGSB_XTOL or bad
            or launched or row["passes"] == 0):
        raise AssertionError(f"(e) two ranks: {row}")
    return row


def _example_launches(label, counts, want) -> None:
    """Raise unless exactly the kernels ``want`` launched (each at least
    once) in ``counts``."""
    got = {k for k, v in counts.items() if v}
    if got != set(want):
        raise AssertionError(f"{label}: launched {counts}, expected {want}")


def _examples_close(label, card, cpu, f32_status=None) -> dict:
    """The figures of one solve on the card against the CPU's (see
    EXAMPLE_TOL); returns the distances."""
    import numpy as np

    out = {"status_equal": card.get("status") == cpu.get("status"),
           "nfev_diff": abs(card.get("nfev", 0) - cpu.get("nfev", 0)),
           "iterations_diff": abs(card.get("iterations", 0)
                                  - cpu.get("iterations", 0))}
    floats = {k: (np.asarray(card[k], np.float64),
                  np.asarray(cpu[k], np.float64))
              for k in card
              if k not in ("status", "nfev", "iterations", "trips",
                           "callback")
              and isinstance(card[k], (float, list))}
    out["max_abs_diff"] = {k: float(np.abs(a - b).max()) if a.size else 0.0
                           for k, (a, b) in floats.items()
                           if a.shape == b.shape}
    if f32_status is None:
        ok = (out["status_equal"] and out["nfev_diff"] <= EXAMPLE_NFEV
              and out["iterations_diff"] <= EXAMPLE_NFEV
              and all(v <= EXAMPLE_TOL for k, v in
                      out["max_abs_diff"].items()
                      if k in ("x", "f")))
    else:
        ok = ((out["status_equal"] or not f32_status)
              and out["max_abs_diff"].get("x", 0.0) <= EXAMPLE_F32_TOL)
    if not ok:
        raise AssertionError(f"example {label}: card {card}, cpu {cpu}, "
                             f"{out}")
    return out


def example_world_of_one(where: str) -> int:
    """``chip_smoke.py --example-world-of-one DIR``: examples_torch/
    pod_scale.py's ``main("cuda")`` and ``entry_torch.dryrun_multichip(1)``
    in a world of one under NCCL (each joins and leaves it), with their
    launches; writes ``DIR/world_of_one.pt``."""
    import torch

    sys.path.insert(0, ROOT)
    mods = Mods()
    import entry_torch
    from examples_torch import pod_scale

    rec = {}
    zero_launches(mods)
    t0 = time.perf_counter()
    rec["pod_scale"] = pod_scale.main("cuda")
    rec["pod_scale_s"] = time.perf_counter() - t0
    rec["pod_scale_launches"] = launch_counts(mods)
    rec["dryrun"], rec["dryrun_launches"], rec["dryrun_s"] = _dryrun(
        mods, entry_torch, 1, "cuda")
    fn, args = entry_torch.entry("cuda")
    zero_launches(mods)
    out = fn(*args)
    rec["entry"] = {"shape": list(out.shape), "dtype": str(out.dtype),
                    "finite": bool(out.isfinite().all()),
                    "launches": launch_counts(mods)}
    torch.save(rec, os.path.join(where, "world_of_one.pt"))
    return 0


def _dryrun(mods, entry_torch, world, device):
    """``dryrun_multichip(world)`` with each part's launches: the parts run
    one after the other, so the counts are read by wrapping the solves'
    entry points."""
    from cppnumericalsolvers_tpu_torch import parallel

    counts = {}
    names = iter(("lbfgs", "lbfgsb"))
    real = parallel.minimize_sharded

    def sharded(*args, **kwargs):
        zero_launches(mods)
        out = real(*args, **kwargs)
        counts[next(names)] = launch_counts(mods)
        return out

    real_al = entry_torch._al_sharded

    def al(*args, **kwargs):
        zero_launches(mods)
        out = real_al(*args, **kwargs)
        counts["al"] = launch_counts(mods)
        return out

    real_model = parallel.minimize_model_sharded

    def model(*args, **kwargs):
        zero_launches(mods)
        out = real_model(*args, **kwargs)
        counts["mesh_2d"] = launch_counts(mods)
        return out

    t0 = time.perf_counter()
    parallel.minimize_sharded = sharded
    parallel.minimize_model_sharded = model
    entry_torch._al_sharded = al
    try:
        parts = entry_torch.dryrun_multichip(world, device)
    finally:
        parallel.minimize_sharded = real
        parallel.minimize_model_sharded = real_model
        entry_torch._al_sharded = real_al
    return parts, counts, time.perf_counter() - t0


def example_rank(rank: int, world: int, where: str) -> int:
    """``chip_smoke.py --example-rank RANK WORLD DIR``: one of two gloo
    ranks sharing card 0 (``LOCAL_RANK=0``) for
    ``entry_torch.dryrun_multichip(2)``; writes ``DIR/rank{RANK}.pt``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    mods = Mods()
    import entry_torch
    from cppnumericalsolvers_tpu_torch import parallel
    from cppnumericalsolvers_tpu_torch.parallel.comm import rank_device

    parallel.initialize_distributed(
        backend="gloo", rank=rank, world_size=world,
        store=dist.FileStore(os.path.join(where, "store"), world))
    try:
        dev = rank_device()
        rec = {"rank": rank, "device": str(dev)}
        rec["dryrun"], rec["dryrun_launches"], rec["dryrun_s"] = _dryrun(
            mods, entry_torch, world, dev)
    finally:
        dist.destroy_process_group()
    torch.save(rec, os.path.join(where, f"rank{rank}.pt"))
    return 0


def _start_example_processes(where: str) -> list:
    """Start the world of one and the two gloo ranks of examples_main."""
    import shutil

    shutil.rmtree(where, ignore_errors=True)
    os.makedirs(where)
    env = {**os.environ, "LOCAL_RANK": "0", "OMP_NUM_THREADS": "1"}
    script = os.path.abspath(__file__)
    cmds = [[script, "--example-world-of-one", where]]
    cmds += [[script, "--example-rank", str(r), "2", where]
             for r in range(2)]
    return [subprocess.Popen(
        [sys.executable] + c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for c in cmds]


def _wait_example_processes(procs, where: str):
    import torch

    outs = []
    deadline = time.perf_counter() + EXAMPLE_RANK_TIMEOUT
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed:
        for i in failed:
            log(f"[examples] process {i} exited {procs[i].returncode}:\n"
                + (outs[i] if i < len(outs) else "")[-4000:])
        raise AssertionError(f"example processes {failed} failed")
    one = torch.load(os.path.join(where, "world_of_one.pt"),
                     weights_only=False)
    pair = [torch.load(os.path.join(where, f"rank{r}.pt"),
                       weights_only=False) for r in range(2)]
    return one, pair


def _check_dryrun(label, parts, counts, world) -> None:
    want = dict(DRYRUN_LAUNCHES)
    if world < 2:
        want.pop("mesh_2d")
    if set(parts) != set(want):
        raise AssertionError(f"{label}: parts {sorted(parts)}")
    for part, kernels in want.items():
        _example_launches(f"{label} {part}", counts[part], kernels)
        if not bool(parts[part]["x"].isfinite().all()):
            raise AssertionError(f"{label} {part}: x not finite")
    x = parts["lbfgsb"]["x"]
    if bool(((x < PARALLEL_BOX[0] - 1e-5) | (x > PARALLEL_BOX[1] + 1e-5))
            .any()):
        raise AssertionError(f"{label}: L-BFGS-B left its box")


def examples_main(mods, dev) -> dict:
    """The examples (the ``examples_main`` phase): see EXAMPLE_MODULES and
    EXAMPLE_LAUNCHES.  The world-of-one and two-rank processes run while
    this process runs each module on the card (launch counts set to 0 just
    before each solve and read just after it) and on the CPU."""
    import importlib

    import torch

    rec = {"modules": {}}
    launches = {name: 0 for name in REPLACES}
    where = os.path.join(ROOT, "build", "example_ranks")
    t0 = time.perf_counter()
    procs = _start_example_processes(where)
    try:
        for name in EXAMPLE_MODULES:
            mod = importlib.import_module(f"examples_torch.{name}")
            counts = {}
            real = getattr(mod, "solve", None)

            def counted(solve_name, device=None, real=real, counts=counts):
                zero_launches(mods)
                out = real(solve_name, device)
                torch.cuda.synchronize()
                counts[solve_name] = launch_counts(mods)
                return out

            zero_launches(mods)
            t1 = time.perf_counter()
            if real is not None:
                mod.solve = counted
            try:
                card = mod.main("cuda")
            finally:
                if real is not None:
                    mod.solve = real
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            if real is None:
                counts["main"] = launch_counts(mods)
            t1 = time.perf_counter()
            cpu = mod.main("cpu")
            cpu_wall = time.perf_counter() - t1
            row = {"wall_s": wall, "cpu_wall_s": cpu_wall,
                   "launches": counts, "compared": {}}
            expected = EXAMPLE_LAUNCHES.get(name, {})
            for solve_name, c in counts.items():
                _example_launches(f"{name} {solve_name}", c,
                                  expected.get(solve_name, ()))
                if "flat_trip" in expected.get(solve_name, ()):
                    if c["flat_trip"] != card[solve_name]["trips"]:
                        raise AssertionError(
                            f"{name} {solve_name}: {c['flat_trip']} "
                            f"flat_trip launches for "
                            f"{card[solve_name]['trips']} trips")
                for k, v in c.items():
                    launches[k] += v
            if name == "expressions_tour":
                row["compared"]["main"] = _examples_close(
                    name, {k: v for k, v in card.items() if k != "mode"},
                    {k: v for k, v in cpu.items() if k != "mode"})
            else:
                f32 = EXAMPLE_F32_STATUS.get(name)
                for solve_name in card:
                    row["compared"][solve_name] = _examples_close(
                        f"{name} {solve_name}", card[solve_name],
                        cpu[solve_name],
                        None if f32 is None else solve_name in f32)
            rec["modules"][name] = row
            log(f"[examples] {name}: card {wall:.2f} s, CPU {cpu_wall:.2f} "
                f"s; launches by solve {counts}; card against CPU "
                f"{row['compared']}")
        one, pair = _wait_example_processes(procs, where)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    pod = one["pod_scale"]
    _example_launches("pod_scale", one["pod_scale_launches"],
                      ("flat_trip",))
    if (pod["metrics"]["total_instances"] != 128
            or one["pod_scale_launches"]["flat_trip"] != pod["trips"]
            or not bool(pod["x"].isfinite().all())):
        raise AssertionError(f"pod_scale: {pod['metrics']}")
    _check_dryrun("dryrun_multichip(1)", one["dryrun"],
                  one["dryrun_launches"], 1)
    for r in pair:
        _check_dryrun(f"dryrun_multichip(2) rank {r['rank']}", r["dryrun"],
                      r["dryrun_launches"], 2)
        if not torch.equal(r["dryrun"]["lbfgs"]["x"],
                           pair[0]["dryrun"]["lbfgs"]["x"]):
            raise AssertionError("dryrun_multichip(2): ranks disagree")
    entry = one["entry"]
    if not entry["finite"] or entry["shape"] != [256, 32]:
        raise AssertionError(f"entry(): {entry}")
    for counts in ([one["pod_scale_launches"]]
                   + list(one["dryrun_launches"].values())
                   + [c for r in pair
                      for c in r["dryrun_launches"].values()]):
        for k, v in counts.items():
            launches[k] += v
    rec["pod_scale"] = {"metrics": pod["metrics"], "wall_s": pod["wall_s"],
                        "trips": pod["trips"],
                        "launches": one["pod_scale_launches"]}
    rec["dryrun_1"] = {"launches": one["dryrun_launches"],
                       "wall_s": one["dryrun_s"]}
    rec["dryrun_2"] = [{"launches": r["dryrun_launches"],
                        "wall_s": r["dryrun_s"]} for r in pair]
    rec["entry"] = entry
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    log(f"[examples] pod_scale world of one: {pod['metrics']}, wall "
        f"{pod['wall_s']:.3f} s, launches {one['pod_scale_launches']}; "
        f"dryrun_multichip(1) {one['dryrun_s']:.2f} s launches "
        f"{one['dryrun_launches']}; dryrun_multichip(2) on two gloo ranks "
        f"{[round(r['dryrun_s'], 2) for r in pair]} s launches "
        f"{pair[0]['dryrun_launches']}; entry() {entry}")
    return rec


def scaling_harness(card) -> dict:
    """benchmarks_torch/scaling.py as a user runs it, its line held; see
    SCALING_CUT."""
    import math

    import torch

    cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmarks_torch", "scaling.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=SCALING_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"scaling.py exited {proc.returncode}:\n"
                             + proc.stderr[-4000:])
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    sizes = [w for w in (1, 2, 4, 8) if w <= cards]
    rates = [line["mesh_2d_batch_x_model"]["lane_iters_per_s"]]
    for axis in ("batch_axis", "model_axis"):
        for stat in line[axis]["iters_per_s"].values():
            rates += [stat["mean"], stat["min"], stat["max"]]
    one = (line["batch_axis"]["iters_per_s"]["1"]["mean"],
           line["model_axis"]["iters_per_s"]["1"]["mean"],
           line["mesh_2d_batch_x_model"]["lane_iters_per_s"])
    log(f"[scaling] benchmarks_torch/scaling.py, NCCL, worlds "
        f"{line['sizes']} of {line['cards']} cards, {wall:.1f} s: one card "
        f"batch ({line['per_device_batch']}, {line['dim']}) {one[0]:.1f} "
        f"iterations/s, model n = {line['model_axis']['dim']} {one[1]:.2f} "
        f"iterations/s, 2-D {line['mesh_2d_batch_x_model']['mesh']} mesh "
        f"({line['mesh_2d_batch_x_model']['batch']}, "
        f"{line['mesh_2d_batch_x_model']['n']}) {one[2]:.1f} "
        f"lane-iterations/s; metric {line['metric']} = {line['value']} | "
        f"{card}")
    log("[scaling] " + json.dumps(line))
    if (line["backend"] != "nccl" or line["cards"] != cards
            or line["sizes"] != sizes or line["device"] != card
            or not all(math.isfinite(r) and r > 0 for r in rates)
            or (line["value"] is None) != (sizes[-1] == 1)):
        raise AssertionError(f"scaling.py's line: {line}")
    return {"line": line, "wall_s": wall}


def scaling_world_of_one(mods, dev) -> dict:
    """Each harness leg's world-of-one solve at the card sizes, cut at
    SCALING_CUT, against the unsharded card solve; see SCALING_CUT.  Runs
    inside a world of one."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from benchmarks_torch import scaling
    from cppnumericalsolvers_tpu_torch import parallel

    cns, sizes = mods.cns, scaling.CARD_SIZES
    obj = scaling.objective()
    stop = scaling.fixed_iter_stopping(torch.float32, SCALING_CUT)
    xla = cns.Lbfgs(m=M, two_loop_impl="xla")
    batch_mesh = parallel.make_mesh(1, axis="batch", device=dev)
    model_mesh = parallel.make_mesh(1, axis="model", device=dev)
    mesh_2d = init_device_mesh(dev.type, (1, 1),
                               mesh_dim_names=("batch", "model"))
    xb = torch.from_numpy(scaling.batch_starts(1, sizes, count=1)[0]).to(dev)
    xm = torch.from_numpy(scaling.model_starts(1, sizes, count=1)[0]).to(dev)
    x2 = torch.from_numpy(scaling.mesh_2d_start(sizes)).to(dev)
    cases = [
        ("batch", tuple(xb.shape),
         lambda: parallel.minimize_sharded(obj, xb, xla, stop,
                                           mesh=batch_mesh, device=dev),
         lambda: cns.minimize_batched(obj, xb, xla, stop)),
        ("model", tuple(xm.shape),
         lambda: parallel.minimize_model_sharded(
             obj, xm, cns.Lbfgs(m=M), stop, mesh=model_mesh, device=dev),
         lambda: cns.minimize(obj, xm, xla, stop)),
        ("mesh_2d", tuple(x2.shape),
         lambda: parallel.minimize_model_sharded(
             obj, x2, cns.Lbfgs(m=M), stop, mesh=mesh_2d,
             batch_axis="batch", device=dev),
         lambda: cns.minimize_batched(obj, x2, xla, stop)),
    ]
    rows = {}
    for label, shape, sharded, unsharded in cases:
        zero_launches(mods)
        res, wall = timed_call(sharded)
        launches = launch_counts(mods)
        got = host_summary(res)
        del res
        zero_launches(mods)
        res, plain_wall = timed_call(unsharded)
        plain_launches = launch_counts(mods)
        want = host_summary(res)
        del res
        row = {"shape": list(shape), "dtype": "float32",
               "iterations": int(got["iterations"].max()),
               "bit_equal": same_bits(got, want), "wall_s": wall,
               "unsharded_wall_s": plain_wall, "launches": launches,
               "unsharded_launches": plain_launches}
        log(f"[scaling] {label} leg, world of one, NCCL, {shape} float32 "
            f"cut at {SCALING_CUT}: {row['iterations']} iterations, "
            f"bit-equal to the unsharded solve {row['bit_equal']}, wall "
            f"{wall:.3f} s (unsharded {plain_wall:.3f} s), launches "
            f"{sum(launches.values())} and {sum(plain_launches.values())}")
        if (not all(row["bit_equal"].values()) or any(launches.values())
                or any(plain_launches.values())):
            raise AssertionError(f"scaling {label} leg: {row}")
        rows[label] = row
    return rows


def scaling_main(mods, dev, card) -> dict:
    """The scaling phase: the harness in a subprocess, then its legs'
    worlds of one in this process; see SCALING_CUT."""
    import torch
    import torch.distributed as dist

    torch.cuda.empty_cache()  # leave the harness's ranks the card
    rec = scaling_harness(card)
    store = os.path.join(ROOT, "build", f"scaling_store_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        rec["world_of_one"] = scaling_world_of_one(mods, dev)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):  # the store's last user may remove it
            os.remove(store)
    return rec


def parallel_main(mods, dev, rank_procs, blocks) -> dict:
    """The multi-device solves (the ``parallel_main`` phase): parts (a)-(e)
    of the comment above PARALLEL_SHAPES, each raising on failure, and the
    ranks' records of part (f) (``dense_ranks``, which ``main`` holds to
    the side process's world of one).  Part
    (b)'s block checks (``blocks``) ran in the side process.  Part (b)'s,
    (c)'s and (e)'s two ranks (``rank_procs``, started by ``main`` with the
    constrained phase) are waited for first; then
    this process joins a world of one under NCCL (a ``FileStore`` under
    ``build/``) for (a), (c) and (e), and leaves it before (d).  Times of two
    ranks sharing one card say nothing of scaling; they are kept only as
    what they are."""
    import torch
    import torch.distributed as dist

    from cppnumericalsolvers_tpu_torch import parallel

    rec = {}
    t0 = time.perf_counter()
    ranks = wait_parallel_ranks(rank_procs)
    rec["ranks_s"] = time.perf_counter() - t0
    store = os.path.join(ROOT, "build", f"parallel_store_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh(axis="batch", device=dev)
        model_mesh = parallel.make_mesh(axis="model", device=dev)
        zero_launches(mods)
        rec["a"] = [parallel_batch_world_of_one(mods, mesh, b, n, dev)
                    for b, n in PARALLEL_SHAPES]
        rec["c_world_of_one"], _ = parallel_model_world_of_one(
            mods, model_mesh, MODEL_N, dev, unsharded=True)
        rec["c_world_of_one_pair_n"], one = parallel_model_world_of_one(
            mods, model_mesh, MODEL_PAIR_N, dev, unsharded=False)
        rec["e"], one_lbfgsb = parallel_model_lbfgsb(mods, model_mesh, dev)
    finally:
        dist.destroy_process_group()
        os.remove(store)
    rec["b"] = parallel_pair_check(mods, ranks, dev)
    rec["b_blocks"] = blocks
    rec["c_two_ranks"] = parallel_model_pair_check(ranks, one)
    rec["e_two_ranks"] = parallel_model_lbfgsb_pair_check(ranks, one_lbfgsb)
    rec["dense_ranks"] = [r["dense"] for r in ranks]
    rec["d"] = parallel_xla_alone(mods, dev)
    launches = {name: 0 for name in REPLACES}
    for row in rec["a"]:
        for name, count in row["launches"].items():
            launches[name] += count
    for name, count in rec["e"]["unsharded_launches"].items():
        launches[name] += count
    for r in ranks:
        for label in ("lbfgs", "lbfgsb"):
            for name, count in r[label]["launches"].items():
                launches[name] += count
    rec["launches"] = launches
    return rec


if __name__ == "__main__":
    if sys.argv[1:2] in (["--parallel-rank"], ["--example-rank"],
                         ["--example-world-of-one"], ["--side"]):
        import faulthandler

        faulthandler.enable()  # a rank that crashes says where
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4]))
    if sys.argv[1:2] == ["--example-rank"]:
        sys.exit(example_rank(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4]))
    if sys.argv[1:2] == ["--example-world-of-one"]:
        sys.exit(example_world_of_one(sys.argv[2]))
    if sys.argv[1:2] == ["--side"]:
        sys.exit(side_process(sys.argv[2]))
    sys.exit(main())
