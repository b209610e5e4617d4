#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (slampp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line with its result and time; any failure ends
the run with a non-zero exit code and no result line:

  1. device   a CUDA card must be present (no CPU continuation);
  2. build    the hand-written kernels from slampp_tpu_torch/csrc;
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes, in float32 and float64, with frozen
              pivots; the Cholesky in each of its three forms (resident,
              streaming, large), at the exact mode's f64 shapes, the first
              M on each side of its resident / streaming boundary and of
              its streaming / large crossover, the separators (1, 3952) in
              both dtypes and (1, 6400) in f64, K = 2 at M = 2048,
              the TRSMs in each of their three forms (cluster, separator,
              columns: each line says which) on both sides of each
              crossover, with frozen pivots at a separator M, K = 2 at a
              large M and an M beyond the cluster form's old cap; timed
              against the plain version and the library call
              (torch.linalg.cholesky_ex for the Cholesky; the TRSMs' plain
              version is torch.linalg.solve_triangular) with CUDA events
              around 20 calls (ms, host launch path included) and as device
              time per launch from torch.profiler (device_ms), beside the
              bound (bound_ms: the card's least time for the call's bytes or
              FLOPs at its peak rates); then one separator-form TRSM captured
              in a CUDA graph and replayed on new right-hand sides
              (trsm-graph), and one large-form Cholesky at (1, 1472) f64
              replayed on two new matrices, each within TOL_F64 of the plain
              version and equal bit for bit to an eager launch (chol-graph);
              then the BA reprojection kernel (ops/ba_kernels.py), both
              forms, at venice871's 2,792,206 observations against its
              plain version: each output within 1e-12 of the plain one's
              largest entry, chi2 the same bits over repeated calls, device
              ms beside the byte bound and the plain version's ms
              (ba-kernels); then the Sim(3) xyz G edge kernel
              (ops/sim3_kernels.py), both forms, at venice871_sim3's
              2,792,206 edges (the same scene in Sim(3)) in the landmark
              order, held and timed the same way against the generic path
              the CPU keeps (sim3-kernels); then the sparse Schur engine's
              slot-sum kernel (ops/schur_kernels.py) on the engine's table
              and terms of the benchmark's venice871_sim3 scene against
              its plain version: each entry within the any-order bound
              (n_s + 3) 2^-52 S of its slot's n_s terms (S the sum of
              their absolute values; 3 for each pair's dot product), the
              same bits over repeated calls, device ms beside the byte
              bound and the plain version's ms (schur-kernels);
  4. main     manhattan3500, mixed precision, chain mode, target 64,
              refine 0, 5 fused GN iterations; chi2 within 5e-3 of the f64
              oracle 404.504, every kernel launched by that run;
  5. dense    the same graph through the dense-frame branch (ch_ok=0);
  6. exact    manhattan500 in float64 end to end; chi2 within 1e-6 of 26.095453;
  7-11.       the batch solvers on manhattan3500 as the JAX package's CLI
              builds them, one optimize with its defaults (5 iterations, min
              |dx| 0.01; apps/manhattan.run_solver): gn (GaussNewtonSolver,
              native v1 engine, f64), lm and dl (LevenbergMarquardtSolver /
              DoglegSolver, dense f64, H 10500 x 10500), lm-v3 and dl-v3 (the
              partitioned engine, mixed, refine_iters=2).  chi2 against the
              JAX package's (JAX_REF): f64 within 1e-6 with the same
              iterations applied, mixed within 5e-3.  The v3 phases must
              launch all three kernels, the native and dense ones none;
  12. prior   one PartitionedSolver.gn_step_prior (mixed, refine 2, 14
              scattered vertices forced into the separator, a seeded SPD
              prior) against the dense f64 solve of (H + P) dx = -(g + p) on
              the card (apps/manhattan.run_prior): relative residual within
              1e-5, |dx| within 1e-4; all three kernels launched.
  13-15.      the incremental solvers on the seed-0 Manhattan graph, streamed
              through the parser's on_edge hook (apps/incremental
              .run_incremental), against the JAX package's run (JAX_REF),
              in a child process (chip_smoke.py --incremental) whose BLAS
              and OpenMP run one thread, as the bench row's child does;
              the phases above keep the threads they had:
              fastl        FastLSolver at 800 poses, every-vertex cadence (the
                           bench row manhattan3500_incremental_steps_per_sec):
                           the same solves, freezes, refreezes and chunk
                           relinearizations, streamed and final chi2 within
                           1e-6 relative, the same optimize() return; all
                           three kernels launched in the final optimize, in
                           float64;
              windowed-v3  WindowedIncrementalSolver on the same graph with
                           the v3 live engine: the same freezes and
                           refreezes, streamed and final chi2 within 1e-6,
                           the same optimize() return, v3 full solves, and
                           all three kernels launched in float64;
              every-n      IncrementalSolver on manhattan500, solve_period 10,
                           3 iterations: chi2 within 1e-6, the same solves.
  (after prior, before the incremental child)
  native      NativeBlockSolver on manhattan3500, 5 chained f64 GN
              iterations (apps/manhattan.run_native), each twice from the
              same start: v1 at panel 8 eager, v2 at panels 1 and 8 eager
              and as optimize_fused's CUDA graph.  chi2 within 1e-6 of the
              JAX package's (JAX_REF), the graph's states equal to the eager
              run's within 1e-12, no dense-kernel launch;
  marginals   manhattan3500 after 5 fused GN iterations (v2, panel 8): the
              dense update_batch (H 10500 x 10500 f64 on the card) against
              the recursive update_batch_sparse (v2 factor, block Takahashi;
              apps/manhattan.run_marginals): every block within 1e-5 of
              the dense one, relative to its largest entry (lambda's
              condition number ~7.6e12 sets the scale; TOL_MARG), and
              vertex 0's block and the sum of the block traces within 1e-6
              of the JAX package's dense ones;
  eigen       the largest and the smallest eigenvalue of manhattan3500's
              lambda (80 Lanczos iterations each; the smallest by shift-
              invert through the f64 v3 factorization) and the condition
              number (apps/manhattan.run_eigen): within 5e-4 (largest) and
              1e-4 (smallest) of the JAX package's, all three kernels
              launched, in float64 only; the kernel phase checks and times
              each of its f64 shapes.
  (after eigen: the SE(3) sphere graph, apps/sphere, against JAX_REF)
  sphere      sphere2500 (make_sphere defaults: 50 rings), v3, mixed, dense
              frames, 5 fused GN iterations, a first call and 3 repeats:
              chi2 within 5e-3 of the JAX package's, the plan K = 40, Ms =
              3952, all three kernels launched;
  sphere-f64  the same graph through the v3 engine in float64 (separator
              (1, 3952, 3952) f64, the Cholesky's large form): chi2 within
              1e-8 of the JAX package's f64 optimum, all launches f64;
  sphere-exact  sphere1000 (20 rings), v3 in float64: chi2 within 1e-6;
  sphere-lm-v3, sphere-dl-v3  the batch solvers on sphere2500 on the v3
              engine (mixed, refine 2): chi2 within 5e-3 and the same
              iterations applied as JAX's, kernels launched; dogleg runs to
              its minimum |dx| (at most 20 iterations);
  sphere-dl-v3-5  dogleg after the CLI's 5 iterations: 5 applied, kernels
              launched, chi2 within 5e-3 of JAX's with float32 Jacobians
              rounded from float64 (see SPHERE_SOLVER_PHASES);
  sphere-gn   sphere2500 through -nls lambda (GaussNewtonSolver, the native
              v1 engine: the CLI's default) and the v2 engine eager and as
              optimize_fused's CUDA graph: chi2 within 1e-6 of JAX's and the
              same iterations applied, the graph's states within 1e-12 of
              the eager run's, no dense-kernel launch;
  robust      sphere2500, lambda-lm on v3 with every edge rebound to its
              Cauchy variant on the whitened error (the CLI's --robust):
              chi2 within 5e-3, the same iterations applied, some IRLS
              weights below 1;
  sphere-landmarks  make_sphere_landmarks' defaults (300 poses, 6 x 6 and 3 x 3
              blocks), lambda-lm on the dense engine: chi2 within 1e-6 and
              the same iterations applied;
  fastl-se3   (in the incremental child) FastLSolver on sphere500 (10
              rings), every vertex, through the torch kernel adapter: the
              same solves, freezes and refreezes as the JAX package's, the
              chunk relinearizations within 5% and the chi2 after the final
              optimize within 1e-3 (TOL_FASTL_SE3: the trajectory follows
              the kernels' rounding, in the JAX package too); the streamed
              chi2 and optimize()'s return printed beside JAX's.
  (after sphere-landmarks: bundle adjustment, apps/ba, against JAX_REF)
  ba-venice   bench_venice's loop on the port: the seed-0 venice871-class
              scene (871 cameras, 110,000 points, mean track 10), the
              observation-driven Schur LM (BigBASolver, float32 SC), a first
              step and 5 LM iterations with min_dx_norm 0: the JAX package's
              accepted steps, chi2 within 5e-3 of its CPU run;
  ba-venice-f64  the same with the float64 SC of float64 pair products:
              within 1e-6 (with float32 pair products the float64 SC's run
              follows their rounding, in the JAX package too: TOL_BA);
  ba-schur    LM with the dense Schur engine (use_schur) on make_ba_scene
              (20 cameras, 500 points): chi2 within 1e-6, the same applied;
  city-schur-sparse  cityTrees10k (make_city_trees(10000, 100)) with
              dogleg "auto", which takes the sparse Schur engine: chi2
              within 5e-3, the same applied, all three kernels launched;
  ba-marginals  the Schur marginals of make_ba_scene's Hessian + 1e-2 I:
              traces and camera 0's / landmark 0's blocks within 1e-6.
  (after ba-marginals: Sim(3), ROCV, Spheron and the A and SPCG solvers,
  apps/sim3 and apps/manhattan.run_solver, against JAX_REF)
  sim3-venice the venice871-class scene (871 cameras, 110,000 points, mean
              track 10: 1,107,724 observations) embedded in Sim(3) and
              optimized by LM with use_schur: the sparse Schur engine, its
              reduced camera system (7 x 7 blocks) on the v3 engine, mixed,
              5 iterations with min_dx_norm 0; then the same from the same
              start with the engine in float64.  The JAX package's engine
              refuses this system at its separator gate (763 of 871 blocks
              against 0.85), so the mixed run is held to the f64 run within
              1e-5 with the same accepted count, chi2 at the start to the
              JAX package's within 1e-9; schur_sparse taken, all three
              kernels launched in both runs at shapes the kernel phase
              checked; in each run's LM loop of n iterations alone, the
              Sim(3) edge kernel's terms form launched 1 + n times (the
              initial damping, each step), its chi2 form n + 1 (the
              start, each candidate) and the slot-sum kernel n times (a
              damped step each);
  sim3-venice-ref  the same procedure at 871 cameras and 30,000 points
              (300,046 observations), which the JAX package takes: chi2
              within 5e-3 of its CPU run, the same accepted count;
  sim3-small  ref_parity.py's sim3_ba_10cam_200pts (dense LM, 20
              iterations, f64): chi2 within 1e-8, the same applied;
  rocv        make_rocv(1000, 8), dense f64 GN, 15 iterations: chi2 within
              1e-6 (the JAX package's own result moves 1e-7 to 2.6e-7 with
              its start states scaled by 1 + 1e-15 N(0, 1): TOL_SIM3);
  spheron     make_spheron(64, 2000) (2,064 vertices, 128,000
              observations), GN with use_schur: the sparse Schur engine at
              6 x 6 blocks, mixed; chi2 within 5e-3, the same applied, all
              three kernels launched at checked shapes;
  a-solver    ASolver on manhattan3500 (f64): chi2 within 1e-8 of the JAX
              package's lambda solver, the same applied;
  spcg        SPCGSolver on manhattan3500: chi2 within 1e-6 of the JAX
              package's, the same applied and CG iterations per step (each
              step takes the 200-iteration cap in both);
  sim3-invdist-venice  the benchmark cell venice871_sim3_invdist.lm's solve
              at full size (seed 0; the scene of venice871_sim3 with
              local inverse-distance landmarks: ternary LO edges on the
              sparse Schur engine): its counts (2,264,792 LO edges,
              13,909,180 kept pairs), the inverse-distance edge kernel
              (ops/invdist_kernels.py), all four forms, on the cell's
              start graph against the generic path the CPU keeps (each
              output within 1e-12 of the generic one's largest entry,
              chi2 the same bits over repeated calls, device ms beside
              the byte bound and the generic path's ms: invdist-kernels),
              the slot-sum kernel at (7, 1) against its plain version,
              the device ms of each layer per LM iteration, iterations/s
              (each form launched 1 + 5 times a solve), the peak device
              memory, and the final states against the plain reference
              (portbench/reference/sim3_invdist_lm.py) under the cell's
              limits.
  (after spcg: the slam_plus_plus CLI, apps/main.py, run in-process in a
  temporary directory on g2o text written there, as a user runs it)
  cli-gn      -i manhattan3500.g2o --json -dm -dsm -ns -nb (GN, the native
              v1 engine): chi2 within 1e-6 of JAX_REF["gn"] with the same
              iterations, system.mtx reads back to 10500 x 10500,
              marginals.txt has 3500 finite positive rows;
  cli-city    -i cityTrees10k.g2o -nls lambda-dl --json -ns -nb (dogleg
              "auto": the sparse Schur engine): chi2 within 5e-3 of
              JAX_REF["city-schur-sparse"] with the same iterations, all
              three kernels launched at checked shapes;
  cli-inc-ba  the CONSISTENCY_MARKER path (-nsp 1 -mnsi 2) on
              make_ba_scene_incremental(6, 50, 4, seed=1): chi2 within 1e-6
              of the JAX CLI's, the same iterations and markers;
  regression  apps/regression.py's five goldens (scripts/regression_goldens
              .json): md5 equal, chi2 within 1e-6;
  examples    simple_example and ba_interface_example on the card: final
              chi2 within 1e-6 of the JAX package's examples' printed values.
  (after examples: the multi-rank paths, apps/distributed.py and
  graft_entry.py, each rank a process spawned on this card; NCCL at one
  rank, gloo for two ranks on the one card, staging through the host)
  dist-gn     NCCL, 1 rank: 5 edge-sharded distributed_gn_steps on
              manhattan3500 (dense H 10500 x 10500 f64, 882 MB all-reduced
              per step): chi2 at each step's input within 1e-6 and after
              the last step within 1e-8 of the JAX package's
              distributed_gn_step on a 1-device CPU mesh (TOL_DIST);
  dist-ba-venice  NCCL, 1 rank: DistributedBigBASolver on the venice871-class
              scene (871 / 110,000 / track 10, SC 5226 x 5226 f64, 218 MB
              all-reduced per step), 5 LM iterations: chi2 within 1e-6 of
              JAX_REF["ba-venice-f64"] and 1e-8 of this run's ba-venice-f64,
              5 accepted, chi2 at the start within 1e-9, the BA
              reprojection kernel launched (p2c_launches);
  dist-ba-venice-2  2 gloo ranks on the card, the same scene: within 1e-9
              of dist-ba-venice, the same accepted count, both ranks on cuda;
  dist-marginals  NCCL, 1 rank: distributed_big_ba_marginals at 871 / 30,000
              / track 10, alpha 1e-2: largest entries, trace sums, first /
              middle / last blocks and seeded combinations of every block
              against the JAX package's (with exact segment sums): landmark
              blocks within 1e-8 and camera blocks within 1e-6 of the
              largest entry (TOL_DIST);
  dist-chunks eliminate_chunks_mesh on 64 chunks of D = 96 (f64), NCCL at 1
              rank and gloo at 2: within 1e-10 of a NumPy sequential
              elimination;
  dryrun-multichip  graft_entry.dryrun_multichip at 1 rank (NCCL) and 2
              (gloo): every result finite.
  No dist phase launches a kernel of the kernel phase (the replicated SC
  and chunk factors are torch.linalg's, as lax.linalg's in the JAX package).
Each phase's launches are counted from zero over that phase alone.  The
whole script takes about ten minutes on an H100, the kernels' build
included, and prints its seconds before the summary.  The kernel summary gives each kernel's times at the main path's
shape and, under "shapes", at every timed shape.

Then the kernel summary (JSON), the card's name and power limit, and the
last line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --kernels

runs phases 1-3 alone (the CLI's -rmb) and writes kernel_bench.csv (kernel,
shape, dtype, device ms, library ms, bound ms of every timed case) into the
working directory.

    python3 chip_smoke.py --sim3-invdist

runs phases 1-2 and sim3-invdist-venice alone.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()

# f64 chi2 oracles of the seed-0 Manhattan graphs after 5 GN iterations
# (bench.py _MANHATTAN_F64_CHI2, scripts/tpu_smoke.py)
CHI2_3500, TOL_3500 = 404.504, 5e-3
CHI2_500, TOL_500 = 26.095453, 1e-6
# (chi2 after optimize, iterations applied) of the JAX package's batch
# solvers on the seed-0 manhattan3500 graph, run on the CPU with the port's
# chain-mode configuration (SLAMPP_CHAIN_SEP_XLA=0) by
#   python tests/_torch_jax_util.py 3500
JAX_REF = {
    "gn": (404.5038446353009, 5),
    "lm": (6933.51111952435, 5),
    "lm-v3": (6933.505879193458, 5),
    "dl": (377994.0042546363, 5),
    "dl-v3": (24395.493175597476, 5),
    # the incremental phases: streamed and final chi2, counters and the
    # final optimize()'s return, by
    #   OPENBLAS_NUM_THREADS=1 python tests/_torch_jax_util.py --incremental
    "fastl": {"n_poses": 800, "chi2_stream": 41.080355532004305, "n_solves": 799,
              "n_freezes": 10, "n_refreezes": 0, "n_relin": 33, "optimize_return": 2,
              "chi2_final": 41.080355531223475},
    "windowed-v3": {"n_poses": 800, "chi2_stream": 41.084904358273, "n_solves": 799,
                    "n_freezes": 10, "n_refreezes": 0, "n_relin": 186, "optimize_return": 3,
                    "chi2_final": 41.08053263804514},
    "every-n": {"n_poses": 500, "chi2_stream": 26.09545575608572, "n_solves": 50,
                "optimize_return": 63, "chi2_final": 26.09545575608572},
    # the native, marginals and eigen phases, by
    #   python tests/_torch_jax_util.py --native 3500
    # native: chi2 after 5 chained f64 GN iterations; marginals: the dense
    # update_batch after 5 fused GN iterations (v2, panel 8), vertex 0's
    # block and the sum of the block traces; eigen: the initial lambda's
    # extremal eigenvalues, 80 Lanczos iterations each
    "native": {"v1-p8": 404.5038446353005, "v2-p1": 404.50384463530065,
               "v2-p8": 404.5038446353007},
    "marginals": {
        "block0": [[0.9999999999968521, 5.014725793416286e-15, 5.043837065094325e-10],
                   [5.0368987484116464e-15, 1.0000000000003504, -1.6025789208721784e-10],
                   [5.04388019078567e-10, -1.602586803057551e-10, 0.9999999298083165]],
        "trace_sum": 39483164.53090722,
    },
    "eigen": {"lmax": 183974.89469745193, "lmin": 2.418037302982734e-08,
              "cond": 7608439062148.149},
    # the sphere phases (apps/sphere, apps/incremental --graph sphere), by
    #   OPENBLAS_NUM_THREADS=1 python tests/_torch_jax_util.py --sphere
    # sphere: v3 mixed; sphere-exact: v3 f64; the solvers: (chi2, applied;
    # dogleg with at most 20 iterations)
    "sphere": {"n_poses": 2500, "chi2_init": 14892690.995111257,
               "chi2_final": 14658.562084637077,
               "plan": {"K": 40, "M": 320, "S": 174, "SB": 658, "Ms": 3952, "ch_ok": 0}},
    "sphere-exact": {"n_poses": 1000, "chi2_init": 6924463.3877691515,
                     "chi2_final": 5650.462888464239},
    "sphere-lm-v3": (21608.201136959546, 5),
    "sphere-dl-v3": (14658.562068876383, 10),
    # dogleg after the CLI's 5 iterations, the JAX package's float32
    # Jacobians rounded from float64 (tests/_torch_jax_util.jax_jacobians)
    "sphere-dl-v3-5": (2818619.226708726, 5),
    "sphere-gn": (14658.562139146195, 5),
    # sphere2500 v3 GN in float64 (the f64 separator (1, 3952, 3952)): the
    # JAX package's f64 optimum
    "sphere-f64": 14658.562139146195,
    "sphere-gn-v2": 14658.562139146192,
    "robust": (19837.69389440896, 5),
    "sphere-landmarks": (4007.8272884259663, 5),
    "fastl-se3": {"n_poses": 500, "chi2_stream": 2719.5259211599614, "n_solves": 499,
                  "n_freezes": 5, "n_refreezes": 0, "n_relin": 622, "optimize_return": 3,
                  "chi2_final": 2633.8160198909923},
    # the BA phases (apps/ba), by
    #   python tests/_torch_jax_util.py --ba
    # (on an 8-core CPU beside other work: the venice runs 40 and 64 s,
    # cpu_seconds; the cityTrees10k dogleg a few minutes).  ba-venice / ba-venice-f64: bench_venice's loop (a first
    # step, 5 LM iterations with min_dx_norm 0) on the seed-0 venice871-class
    # scene (871 cameras, 110,000 points, mean track 10: 1,107,724
    # observations) with a float32 SC of float32 pair products and a
    # float64 SC of float64 pair products; ba-schur: LM with the
    # dense Schur engine on make_ba_scene(20, 500); city-schur-sparse:
    # dogleg ("auto": the sparse Schur engine) on cityTrees10k; ba-marginals:
    # the Schur marginals of make_ba_scene(20, 500)'s Hessian + 1e-2 I
    "ba-venice": {"chi2_init": 16411352.833137445, "chi2_final": 1879060.347260055,
                  "lm_accepted": 5, "n_obs": 1107724, "cpu_seconds": 40.21},
    "ba-venice-f64": {"chi2_init": 16411352.833137445, "chi2_final": 1879036.4422342293,
                      "lm_accepted": 5, "n_obs": 1107724, "cpu_seconds": 63.63},
    "ba-schur": (4240.130092158383, 4),
    "city-schur-sparse": (104151331.26338468, 5),
    "ba-marginals": {
        "trace_cc": 29.487038212680858, "trace_ll": 613.7855155315043,
        "cam0": [[1.0642624986974345, -0.008332810600925486, 0.19469640433920857, 7.76305281174254e-05, -0.004263149018864655, 0.002070013252340921],
                 [-0.008332810600925162, 0.162747950651233, -0.002208547210923629, 0.004541394059338843, -1.2444616303848816e-05, 0.0037398040194631423],
                 [0.19469640433920854, -0.0022085472109236643, 0.20368657978930793, -0.001920281370029835, -0.003394419362282155, 1.931757371513359e-05],
                 [7.763052811742608e-05, 0.004541394059338842, -0.001920281370029833, 0.024640573189452057, 0.00011897378328424087, 0.00016934371747312355],
                 [-0.0042631490188646684, -1.2444616303845277e-05, -0.003394419362282156, 0.00011897378328424073, 0.023976409877114482, -0.00023004292223938568],
                 [0.00207001325234091, 0.0037398040194631427, 1.9317573715133918e-05, 0.00016934371747312073, -0.0002300429222393865, 0.026013441460315184]],
        "lm0": [[0.19180305723413046, 0.0022470673468091406, -0.005677517319831059],
                 [0.002247067346808979, 0.19386623545774703, 0.004756912316509452],
                 [-0.005677517319831015, 0.004756912316509411, 0.18296280562022726]]},
    # the Sim(3), ROCV, Spheron and SPCG phases, by
    #   python tests/_torch_jax_util.py --sim3
    # (the JAX package's sparse Schur engine raises at full venice size:
    # "separator has 763/871 blocks"; its chi2 at the start is the
    # embedded scene's, before the engine's symbolic phase; the 871 / 30,000
    # run took 129 s on the CPU); a-solver holds "gn" above
    "sim3-venice": {"chi2_init": 16411352.833137304, "n_obs": 1107724},
    "sim3-venice-ref": {"n_cams": 871, "n_points": 30000, "n_obs": 300046,
                        "chi2_init": 3145927.9440838383, "chi2_final": 620022.2014362162,
                        "lm_accepted": 5},
    "sim3-small": (1768.7399733602556, 5),
    "rocv": (54389.48382278988, 15),
    "spheron": (3788.3532351084714, 1),
    "spcg": {"chi2": 404.5038446353168, "applied": 5, "cg_counts": [200, 200, 200, 200, 200]},
    # the CLI phases: cli-gn holds "gn" (the CLI's -nls lambda builds the
    # same solver), cli-city "city-schur-sparse" (its -nls lambda-dl the same
    # dogleg); the marker path's --json line from the JAX CLI, by
    #   python tests/_torch_jax_util.py --cli
    "cli-inc-ba": {"problem": "ba", "solver": "lambda-lm", "chi2": 224.8577282066047,
                   "iterations": 0, "incremental_solves": 5},
    # the final chi2 that examples/simple_example.py and
    # examples/ba_interface_example.py print on the CPU
    "examples": {"simple_example": 0.026236778263065454,
                 "ba_interface_example": 737.1501359124949},
    # the distributed phases, by
    #   python tests/_torch_jax_util.py --dist
    # dist-gn: JAX's distributed_gn_step iterated 5 times on a 1-device CPU
    # mesh on manhattan3500 (chi2 at each step's input, then after the
    # last); dist-marginals: JAX's distributed_big_ba_marginals on a 1-device
    # CPU mesh on the venice-class scene at 871 / 30,000 / track 10, alpha
    # 1e-2, with exact segment sums (its prefix sums lie prefix_sum_rel_err
    # from them: twice the largest landmark entry), summarized by
    # apps/distributed.marginals_summary; dist-ba-venice holds
    # "ba-venice-f64" above
    "dist-gn": {"n_poses": 3500, "chi2": [1321146.3686662614, 107722.32962442987, 6597.694643355835, 406.42464700130415, 404.5039355737421], "chi2_final": 404.5038446353009},
    "dist-marginals": {
        "n_cams": 871,
        "n_points": 29996,
        "alpha": 0.01,
        "prefix_sum_rel_err": {"cam": 2.071425801243961e-08, "lm": 1.995041035379643},
        "cam_max": 0.03057133673799702,
        "lm_max": 55.8371521406997,
        "cam_trace": 29.075803655143506,
        "lm_trace": 90035.08422002128,
        "cam_blocks": {
            "0": [[0.019620109011949653, 4.297253751953121e-06, 0.0031890376104000795, -1.1890949402890892e-06, 1.249186140651194e-06, -3.7221730989630593e-06], [4.297253751953121e-06, 0.003635333982576748, -3.873111890418833e-06, -2.023353194919181e-06, -3.9737435365869446e-07, -1.5325097171102872e-06], [0.0031890376104000795, -3.873111890418833e-06, 0.0039009544546006634, 1.237164956913206e-06, 1.346951460730083e-06, 1.4017115554630737e-07], [-1.1890949402890892e-06, -2.023353194919181e-06, 1.237164956913206e-06, 0.00018107002801049187, 4.245261598633385e-07, 5.8639004848295636e-08], [1.249186140651194e-06, -3.9737435365869446e-07, 1.346951460730083e-06, 4.245261598633385e-07, 0.0001800449417421937, -3.608844361885402e-07], [-3.7221730989630593e-06, -1.5325097171102872e-06, 1.4017115554630737e-07, 5.8639004848295636e-08, -3.608844361885402e-07, 0.00010915824270331533]],
            "435": [[0.03056566064153065, 0.00036330209006843895, -0.005619759940399803, 4.6606223786046953e-07, 4.4114970031639664e-07, -1.2967103902539758e-06], [0.00036330209006843895, 0.003687190163850893, -8.441624835935283e-05, -2.0086594157867943e-06, -4.568847914559243e-07, -3.5559857355379446e-06], [-0.005619759940399803, -8.441624835935283e-05, 0.004449496957942909, 1.3768409039710432e-06, 1.2101791515919464e-06, 5.062300433031687e-07], [4.6606223786046953e-07, -2.0086594157867943e-06, 1.3768409039710432e-06, 0.0001813425453839284, 3.5395786848190475e-07, 5.659372395754501e-07], [4.4114970031639664e-07, -4.568847914559243e-07, 1.2101791515919464e-06, 3.5395786848190475e-07, 0.00018023373768993287, -3.7833858392426613e-07], [-1.2967103902539758e-06, -3.5559857355379446e-06, 5.062300433031687e-07, 5.659372395754501e-07, -3.7833858392426613e-07, 0.00011135403752587259]],
            "870": [[0.01966112034149908, -0.00020362701097812705, 0.003190909577723238, -1.9597337385255283e-07, 1.3008331816545755e-06, -2.156004676972794e-06], [-0.00020362701097812705, 0.0036443341602728405, -4.0905527477709917e-05, -2.1379705585085703e-06, -4.163303909426643e-07, -3.4390408666251343e-06], [0.003190909577723238, -4.0905527477709917e-05, 0.003900404989597336, 1.4932468535974307e-06, 1.3717156335437539e-06, 3.850616354636731e-07], [-1.9597337385255283e-07, -2.1379705585085703e-06, 1.4932468535974307e-06, 0.0001810746187529532, 4.134536439434183e-07, 2.7364894909429103e-08], [1.3008331816545755e-06, -4.163303909426643e-07, 1.3717156335437539e-06, 4.134536439434183e-07, 0.0001799210282656789, -3.791427996756463e-07], [-2.156004676972794e-06, -3.4390408666251343e-06, 3.850616354636731e-07, 2.7364894909429103e-08, -3.791427996756463e-07, 0.00010912573845133281]],
        },
        "lm_blocks": {
            "0": [[0.006980064540335756, -0.011952198559630091, -0.002065157376322831], [-0.011952198559631063, 0.05184682220130411, 0.00810595052298168], [-0.00206515737632299, 0.008105950522981643, 0.004865936727534925]],
            "14998": [[0.00752129419311226, -0.013144558702059432, -0.003776395553797785], [-0.013144558702057052, 0.05099981208400885, 0.013624846787590027], [-0.0037763955537976164, 0.013624846787591856, 0.007501971786441966]],
            "29995": [[0.014003609146210289, -0.003419976272631827, 0.0015569203223926996], [-0.003419976272629842, 0.016761622994387458, -0.002026823121433063], [0.0015569203223966342, -0.0020268231214382493, 0.019301791416886163]],
        },
        "cam_mix": [[0.00031562228232386827, 0.00032639400255915924, 5.9692191741433675e-05, 2.2252823240129044e-08, -9.524169805622027e-08, 1.8693171005039153e-08], [0.00032639400255915924, -0.0007557100662279742, 3.7608593027049845e-06, 3.2137570867113056e-08, -6.582412677635583e-09, 5.985250889953682e-08], [5.9692191741433675e-05, 3.7608593027049845e-06, -8.833276073033644e-05, -2.0852456195073878e-08, -2.1865164363663935e-08, 7.073098848376461e-09], [2.2252823240129044e-08, 3.2137570867113056e-08, -2.0852456195073878e-08, -4.413508397415036e-06, -1.0307235607722545e-08, -2.9347839841657937e-09], [-9.524169805622027e-08, -6.582412677635583e-09, -2.1865164363663935e-08, -1.0307235607722545e-08, -4.390719368077518e-06, 1.865838569083741e-09], [1.8693171005039153e-08, 5.985250889953682e-08, 7.073098848376461e-09, -2.9347839841657937e-09, 1.865838569083741e-09, -2.6409952537668764e-06]],
        "lm_mix": [[-0.02873641145492214, -0.00423607650978818, 0.0007750636412498938], [-0.004236076509669162, -0.0036972676053987994, 0.0027193520789743505], [0.0007750636412395815, 0.0027193520789763953, -0.0022635303436928673]],
    },
}
# the CLI phases: cli-gn and cli-inc-ba are float64 (TOL_SOLVER_F64),
# cli-city the mixed sparse Schur engine (TOL_3500); the regression goldens
# and the examples 1e-6
TOL_CLI = {"cli-gn": 1e-6, "cli-city": 5e-3, "cli-inc-ba": 1e-6, "regression": 1e-6,
           "examples": 1e-6}
# the native phase: (run, engine, panel, as optimize_fused's CUDA graph)
NATIVE_RUNS = (("v1-p8", "v1", 8, False), ("v2-p1", "v2", 1, False), ("v2-p1", "v2", 1, True),
               ("v2-p8", "v2", 8, False), ("v2-p8", "v2", 8, True))
TOL_NATIVE, TOL_GRAPH = 1e-6, 1e-12
# sparse against dense marginals (largest block difference over the block's
# largest entry), vertex 0's block and the trace sum against JAX's, and the
# eigenvalues against JAX's (tests/test_aux.py:152-160).  The CPU tests hold
# sparse to dense at 1e-7 on 82 poses.  manhattan3500's lambda has condition
# number ~7.6e12 (the eigen phase), so cond * eps ~ 8e-4 bounds what f64 can
# promise; the two algorithms differ there by 2.6e-7 on a CPU and 1.1e-6 on
# the H100, by as much with exact per-segment sums in place of the prefix
# sums, and the dense result moves 1.5e-7 when the GN states move by their
# rounding (scripts/marginals_segsum_ab.py): the bound is 1e-5
TOL_MARG, TOL_MARG_REF = 1e-5, 1e-6
TOL_EIG_MAX, TOL_EIG_MIN = 5e-4, 1e-4
# the incremental phases: (engine, solver keywords, counters that must equal
# the JAX package's); chi2 within TOL_SOLVER_F64 relative
INC_PHASES = (
    ("fastl", "fastl", {}, ("n_solves", "n_freezes", "n_refreezes", "n_relin")),
    ("windowed-v3", "windowed", {"live_engine": "v3"}, ("n_solves", "n_freezes", "n_refreezes")),
    ("every-n", "every-n", {"solve_period": 10, "max_iterations": 3}, ("n_solves",)),
    ("fastl-se3", "fastl", {"graph": "sphere"}, ("n_solves", "n_freezes", "n_refreezes")),
)
# FastL on sphere500 follows its kernels' rounding, in the JAX package too:
# with its Jacobians scaled by 1 +- 1e-14 the chunk relinearizations move
# from 622 to 606-618 and the final chi2 by up to 2.1e-4
# (tests/_torch_jax_util.py --fastl-se3); under a seeded per-entry change
# of 1e-15 of its Jacobians, 3 of 13 runs stream to chi2 1.2e4-3.0e5 and
# end up to 7.2% high.  The port on the JAX kernels gives JAX's counters
# and chi2 to 1.2e-15; on its own it gives JAX's final chi2 to 2.9e-7 on
# the card's host and ends 67% high on another CPU (ROADMAP.md queue 3).
# So fastl-se3 holds the structural counters exactly, the relinearizations
# within 5% and the chi2 after the final optimize within 1e-3, and prints
# the streamed chi2, optimize()'s return and the relinearizations beside
# JAX's (vs_jax)
TOL_FASTL_SE3 = {"n_relin": 0.05, "chi2_final": 1e-3}
# the sphere's batch-solver phases: (phase, -nls, engine, robust, -mnsi,
# chi2 tolerance), each holding the iterations applied to JAX's.  Dogleg
# after the CLI's 5 iterations (chi2 2.8e6, every step on the trust
# region's boundary) is held against JAX with its float32 Jacobians rounded
# from float64 at 5e-3: a seeded per-entry float32-sized change of those
# Jacobians moves the JAX package's own result by 1.9e-3 to 1.09e-2 (6
# seeds), and the card read 2.1e-2 while the f32 separator Cholesky
# subtracted each product in turn (5.0e-5 with the plain Cholesky, 2.5e-3
# with the repaired kernel: scripts/sphere_dogleg_ab.py, PERF.md).  Run to
# its minimum |dx| (20 iterations at most; 10 applied) it is held to 5e-3
SPHERE_SOLVER_PHASES = (("sphere-lm-v3", "lambda-lm", "v3", None, 5, TOL_3500),
                        ("sphere-dl-v3-5", "lambda-dl", "v3", None, 5, TOL_3500),
                        ("sphere-dl-v3", "lambda-dl", "v3", None, 20, TOL_3500),
                        ("robust", "lambda-lm", "v3", ("cauchy", True), 5, TOL_3500))
# sphere2500 v3 GN in float64 against the JAX package's f64 optimum
TOL_SPHERE_F64 = 1e-8
SOLVER_PHASES = (("gn", "lambda", None), ("lm", "lambda-lm", None), ("lm-v3", "lambda-lm", "v3"),
                 ("dl", "lambda-dl", None), ("dl-v3", "lambda-dl", "v3"))
TOL_SOLVER_F64 = 1e-6
# prior step against its dense f64 oracle: the relative residual of its dx in
# (H + P) dx = -(g + p), the mixed-mode bound of tests/test_torch_partitioned.py
# (raw dx is not compared: the mixed solve leaves the near-null gauge
# direction inexact), and |dx| relative
TOL_PRIOR_RES, TOL_PRIOR_DX = 1e-5, 1e-4
# kernel-against-plain tolerances: f64 max |kernel - plain| over max |plain|;
# f32 relative residual (|L L^T - A| over |A|, |L X - B| over |B|), since the
# kernels round in another order than the panel-blocked plain versions
TOL_F64 = 1e-10
TOL_F32 = 1e-4

SOURCE = "slampp_tpu_torch/csrc/dense_kernels.cu"
REPLACES = {
    "chol_batched": "slampp_tpu/ops/dense_kernels.py:184",
    "trsm_lower_batched": "slampp_tpu/ops/dense_kernels.py:215",
    "trsm_lower_t_batched": "slampp_tpu/ops/dense_kernels.py:236",
}
# the BA reprojection and Sim(3) edge kernels replace no Pallas kernel:
# their source, what they replace, the phases whose launches the summary
# gives and the key of those phases' counts
FUSED = {
    "p2c": ("slampp_tpu_torch/csrc/ba_kernels.cu",
            "none: slampp_tpu/linear/ba_schur.py:304 and :600, XLA-fused",
            ("ba-venice", "ba-venice-f64"), "p2c_launches"),
    "sim3_g": ("slampp_tpu_torch/csrc/sim3_kernels.cu",
               "none: slampp_tpu/models/sim3.py _g_jacobians and "
               "slampp_tpu/core/assembly.py edge_chi2, XLA-fused",
               ("sim3-venice", "sim3-venice-ref"), "sim3_launches"),
    "slot": ("slampp_tpu_torch/csrc/schur_kernels.cu",
             "none: slampp_tpu/linear/schur_sparse.py pair corrections and slot sums, "
             "an XLA einsum and segment sum",
             ("sim3-venice", "sim3-venice-ref"), "slot_launches"),
}


class Failure(Exception):
    pass


# (kernel, K, M, S, dtype) of every case the kernel phase held to its plain
# version; a path phase may require that its launches stayed within them
CHECKED: set = set()
# a phase's result that a later phase is held to (ba-venice-f64 for
# dist-ba-venice)
RESULTS: dict = {}


def _line(phase: str, ok: bool, t: float, **info) -> None:
    print(f"[{phase}] {'ok' if ok else 'FAIL'} {t:.3f}s " + json.dumps(info), flush=True)
    if not ok:
        raise Failure(phase)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _reps(fn, budget_s: float = 0.5) -> int:
    """How many calls of ``fn`` (1 to 20) fit in about ``budget_s``, from one
    timed call (which also warms it up)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return max(1, min(20, int(budget_s / max(time.perf_counter() - t0, 1e-6))))


def _device_ms(fn, reps: int = 20, warmup: int = 3):
    """Device time per call of ``fn`` and where it came from: from the
    device events (kernels, copies, memsets) that ``reps`` calls leave in a
    torch.profiler trace.  Unlike CUDA events around the calls, it leaves
    out the host's time between launches.  The card's traces lose device
    events now and then (at any kernel length).  Where every kind of event
    occurs at most once per call (a port kernel: its kernel and, for the
    separator-form TRSM, its workspace memset; torch.linalg.solve_triangular),
    the time is the sum over the kinds of each kind's mean over the events
    the trace kept ("trace", or "trace, k of n events" when it lost some).
    Otherwise (the plain Cholesky, cholesky_ex: several events of a kind per
    call) the summed duration over ``reps`` counts when the number of events
    is a multiple of the calls, a trace that lost some is taken again, and
    after three such traces CUDA events around the calls, host gaps
    included, stand in ("events")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.count]
        n = sum(e.count for e in events)
        if n and all(e.count <= reps for e in events):
            per_call = sum(e.self_device_time_total / e.count for e in events) / 1000.0
            full = reps * len(events)
            return per_call, "trace" if n == full else f"trace, {n} of {full} events"
        if n and n % reps == 0:  # a lost event leaves a count off the multiple
            return sum(e.self_device_time_total for e in events) / 1000.0 / reps, "trace"
    return _time_ms(fn, reps, warmup=0), "events"


# peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM
# bytes/s, and the card's FLOP/s for each dtype: float32 outside the tensor
# cores, float64 on its tensor cores (FP64 Tensor Core, 67 TFLOP/s; 34
# outside them), whether or not the kernel uses them
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}


def _bound(name, K, M, S, dtype):
    """Least time (ms) the card could take for one call, and what bounds it:
    the larger of the bytes (the lower triangle read once, B read once, the
    output written once) over the memory rate and the FLOPs (Cholesky M^3/3,
    triangular solve M^2 S per matrix) over the peak rate of the dtype."""
    size = 4 if dtype == "float32" else 8
    tri = M * (M + 1) // 2
    if name == "chol_batched":
        flops, nbytes = K * M ** 3 / 3, K * (tri + M * M) * size
    else:
        flops, nbytes = K * M * M * S, K * (tri + 2 * M * S) * size
    t_bytes, t_flops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def _check_kernels(dev):
    """Phase 3: every kernel against its plain version at the path's shapes.
    Returns {kernel: {...}}: the largest |kernel - plain| over the unfrozen
    cases, and the times and bound at the main path's own shape (the float32
    separator)."""
    import torch

    from slampp_tpu_torch.ops import dense_kernels as dk

    gen = torch.Generator(device=dev).manual_seed(0)

    def spd(K, M, zero_rows=()):
        """K seeded SPD matrices (float64, on the card: a numpy product at M
        = 6400 would take seconds), whole rows and columns zero at
        ``zero_rows`` (exactly zero pivots in any precision)."""
        G = torch.randn(K, M, M, device=dev, dtype=torch.float64, generator=gen)
        G[:, list(zero_rows), :] = 0.0
        A = G @ G.transpose(1, 2)
        keep = [i for i in range(M) if i not in zero_rows]
        A[:, keep, keep] += M
        return A

    f32, f64 = torch.float32, torch.float64
    both, timed32, timed64 = (f32, f64), {f32}, {f64}
    res32, res64 = dk.chol_resident_max_m(f32), dk.chol_resident_max_m(f64)
    cases = [  # (kernel, K, M, S, frozen pivots, dtypes, timed dtypes).
        # Cholesky: the dense frames' part blocks (resident in shared
        # memory), the separator (the large form), the exact mode's f64
        # shapes and the first M on each side of the resident / streaming
        # boundary (both stream at K = 2).
        # TRSMs: M = 1096 is beyond the cluster form's resident slab size
        # in both precisions; from M = 544 (bwd), 672 (f64 fwd) and 1152
        # (f32 fwd) one matrix takes the separator form
        ("chol_batched", 55, 192, None, (), both, timed32),
        ("chol_batched", 55, 192, None, (5, 100, 191), both, ()),
        ("chol_batched", 1, 488, None, (), both, both),
        ("chol_batched", 1, 488, None, (5, 200, 487), both, ()),
        ("chol_batched", 8, 192, None, (), (f64,), timed64),
        ("chol_batched", 1, 48, None, (), (f64,), timed64),
        ("chol_batched", 2, res32, None, (), (f32,), ()),
        ("chol_batched", 2, res32 + 8, None, (), (f32,), ()),
        ("chol_batched", 2, res64, None, (), (f64,), ()),
        ("chol_batched", 2, res64 + 8, None, (), (f64,), ()),
        ("trsm_lower_batched", 55, 192, 48, (), both, timed32),
        ("trsm_lower_batched", 55, 192, 8, (), both, timed32),
        ("trsm_lower_batched", 1, 488, 8, (), both, timed32),
        ("trsm_lower_batched", 1, 488, 8, (5, 200, 487), both, ()),
        ("trsm_lower_batched", 1, 1096, 8, (), both, ()),
        ("trsm_lower_batched", 1, 3104, 8, (), both, ()),
        ("trsm_lower_t_batched", 55, 192, 8, (), both, timed32),
        ("trsm_lower_t_batched", 1, 488, 8, (), both, timed32),
        ("trsm_lower_t_batched", 1, 488, 8, (5, 200, 487), both, ()),
        ("trsm_lower_t_batched", 1, 1096, 8, (), both, ()),
        ("trsm_lower_t_batched", 1, 3104, 8, (), both, ()),
        # the exact f64 mode's TRSMs (manhattan500: K=8, M=192, S+1 padded
        # to 24; separator Ms=48)
        ("trsm_lower_batched", 8, 192, 24, (), (f64,), timed64),
        ("trsm_lower_batched", 1, 48, 8, (), (f64,), timed64),
        ("trsm_lower_t_batched", 8, 192, 8, (), (f64,), timed64),
        ("trsm_lower_t_batched", 1, 48, 8, (), (f64,), timed64),
        # the incremental phases' f64 shapes (manhattan800): the windowed v3
        # live engine's largest separator (Ms = 80) and a live part frame
        # (K = 6, M = 96; S + 1 padded to 24), and the final optimize's part
        # frames (K = 13, M = 192; S + 1 padded to 32)
        ("chol_batched", 1, 80, None, (), (f64,), timed64),
        ("chol_batched", 6, 96, None, (), (f64,), timed64),
        ("chol_batched", 13, 192, None, (), (f64,), timed64),
        ("trsm_lower_batched", 1, 80, 8, (), (f64,), timed64),
        ("trsm_lower_batched", 6, 96, 24, (), (f64,), timed64),
        ("trsm_lower_batched", 13, 192, 32, (), (f64,), timed64),
        ("trsm_lower_t_batched", 1, 80, 8, (), (f64,), timed64),
        ("trsm_lower_t_batched", 6, 96, 8, (), (f64,), timed64),
        ("trsm_lower_t_batched", 13, 192, 8, (), (f64,), timed64),
        # the eigen phase's f64 shapes (manhattan3500, target 64, through
        # SparseSystemOperator.solve_shifted): part frames K = 55, M = 192
        # (factor, S = 48; solves, S = 8) and the separator M = 488 (its
        # Cholesky is timed in f64 above)
        ("chol_batched", 55, 192, None, (), (f64,), timed64),
        ("trsm_lower_batched", 55, 192, 48, (), (f64,), timed64),
        ("trsm_lower_batched", 55, 192, 8, (), (f64,), timed64),
        ("trsm_lower_batched", 1, 488, 8, (), (f64,), timed64),
        ("trsm_lower_t_batched", 55, 192, 8, (), (f64,), timed64),
        ("trsm_lower_t_batched", 1, 488, 8, (), (f64,), timed64),
        # the sphere phases' shapes (6 x 6 blocks, dense frames): sphere2500
        # (K = 40, M = 320, S = 174, its rhs column padded to 176; separator
        # Ms = 3952; the part frames stream, the separator takes the large
        # form) in float32 and float64; sphere1000 in float64 (K = 17, S =
        # 150 + 1 -> 152, separator Ms = 1472); an f64 M beyond 3952 (the
        # one-CTA kernel stopped at 3104) and the large form with frozen
        # pivots
        ("chol_batched", 40, 320, None, (), both, both),
        ("chol_batched", 3, 320, None, (5, 200, 319), both, ()),
        ("chol_batched", 1, 3952, None, (), both, both),
        ("chol_batched", 1, 3952, None, (7, 2000, 3951), both, ()),
        ("chol_batched", 1, 6400, None, (), (f64,), timed64),
        ("trsm_lower_batched", 40, 320, 176, (), both, both),
        ("trsm_lower_batched", 40, 320, 8, (), both, both),
        ("trsm_lower_batched", 1, 3952, 8, (), both, both),
        ("trsm_lower_t_batched", 40, 320, 8, (), both, both),
        ("trsm_lower_t_batched", 1, 3952, 8, (), both, both),
        ("chol_batched", 17, 320, None, (), (f64,), timed64),
        ("chol_batched", 1, 1472, None, (), (f64,), timed64),
        ("trsm_lower_batched", 17, 320, 152, (), (f64,), timed64),
        ("trsm_lower_batched", 17, 320, 8, (), (f64,), timed64),
        ("trsm_lower_batched", 1, 1472, 8, (), (f64,), timed64),
        ("trsm_lower_t_batched", 17, 320, 8, (), (f64,), timed64),
        ("trsm_lower_t_batched", 1, 1472, 8, (), (f64,), timed64),
        # cityTrees10k's reduced pose system through the sparse Schur engine
        # (SE(2) 3 x 3 blocks, mixed): part frames K = 157, M = 192, S = 402
        # (+ 1 -> 408); separator Ms = 3952 (above)
        ("chol_batched", 157, 192, None, (), (f32,), timed32),
        ("trsm_lower_batched", 157, 192, 408, (), (f32,), timed32),
        ("trsm_lower_batched", 157, 192, 8, (), (f32,), timed32),
        ("trsm_lower_t_batched", 157, 192, 8, (), (f32,), timed32),
        # Sim(3) bundle adjustment at venice871 scale through the sparse
        # Schur engine (camsim3: 7 x 7 blocks, dense frames): part frames
        # K = 11, M = 200, S = 952 (+ 1 -> 960); separator Ms = 5344 (763
        # blocks); mixed, and in float64 in the f64 run.  The JAX-size run
        # (871 cameras, 30,000 points): K = 12, M = 232, S = 826 -> 832,
        # Ms = 4968.  Spheron (64 poses, 6 x 6 blocks): every pose in the
        # separator, Ms = 384, beside one padding part frame of M = 8
        ("chol_batched", 11, 200, None, (), both, both),
        ("trsm_lower_batched", 11, 200, 960, (), both, both),
        ("trsm_lower_batched", 11, 200, 8, (), both, both),
        ("trsm_lower_t_batched", 11, 200, 8, (), both, both),
        ("chol_batched", 1, 5344, None, (), both, both),
        ("trsm_lower_batched", 1, 5344, 8, (), both, both),
        ("trsm_lower_t_batched", 1, 5344, 8, (), both, both),
        ("chol_batched", 12, 232, None, (), (f32,), timed32),
        ("trsm_lower_batched", 12, 232, 832, (), (f32,), timed32),
        ("trsm_lower_batched", 12, 232, 8, (), (f32,), timed32),
        ("trsm_lower_t_batched", 12, 232, 8, (), (f32,), timed32),
        ("chol_batched", 1, 4968, None, (), (f32,), timed32),
        ("trsm_lower_batched", 1, 4968, 8, (), (f32,), timed32),
        ("trsm_lower_t_batched", 1, 4968, 8, (), (f32,), timed32),
        ("chol_batched", 1, 384, None, (), both, both),
        ("chol_batched", 1, 8, None, (), both, both),
        # the Cholesky's crossovers (chol_large_from: the streaming form below,
        # the large form from f32 M = 392, 440 at K >= 40; f64 296, 392 at
        # K >= 40), each side ((1, 384) f32 above), and the large form at K = 2
        ("chol_batched", 1, 392, None, (), (f32,), timed32),
        ("chol_batched", 40, 432, None, (), (f32,), timed32),
        ("chol_batched", 40, 440, None, (), (f32,), timed32),
        ("chol_batched", 1, 288, None, (), (f64,), timed64),
        ("chol_batched", 1, 296, None, (), (f64,), timed64),
        ("chol_batched", 40, 384, None, (), (f64,), timed64),
        ("chol_batched", 40, 392, None, (), (f64,), timed64),
        ("chol_batched", 2, 2048, None, (), both, ()),
        ("trsm_lower_batched", 1, 384, 8, (), both, both),
        ("trsm_lower_batched", 1, 8, 8, (), both, both),
        ("trsm_lower_t_batched", 1, 384, 8, (), both, both),
        ("trsm_lower_t_batched", 1, 8, 8, (), both, both),
        # the TRSM forms' crossovers (plan_trsm: separator_from and
        # columns_first), each side, and the separator form with frozen
        # pivots, at K = 2 and beyond the cluster form's old cap (f32 12288)
        ("trsm_lower_batched", 1, 1144, 8, (), (f32,), timed32),
        ("trsm_lower_batched", 1, 1152, 8, (), (f32,), timed32),
        ("trsm_lower_batched", 1, 664, 8, (), (f64,), timed64),
        ("trsm_lower_batched", 1, 672, 8, (), (f64,), timed64),
        ("trsm_lower_t_batched", 1, 536, 8, (), both, both),
        ("trsm_lower_t_batched", 1, 544, 8, (), both, both),
        ("trsm_lower_t_batched", 17, 320, 8, (), both, both),
        ("trsm_lower_batched", 40, 320, 8, (), (f64,), ()),
        ("trsm_lower_batched", 13, 192, 32, (), (f32,), timed32),
        ("trsm_lower_batched", 32, 192, 16, (), (f32,), timed32),
        ("trsm_lower_t_batched", 1, 3952, 8, (7, 2000, 3951), both, ()),
        ("trsm_lower_batched", 2, 5344, 8, (), both, ()),
        ("trsm_lower_t_batched", 2, 5344, 8, (), both, ()),
        ("trsm_lower_t_batched", 1, 12296, 8, (), (f32,), timed32),
        ("trsm_lower_t_batched", 40, 320, 176, (), (f64,), ()),
    ]
    main_shape = (1, 488, f32)
    plain = {"chol_batched": dk.chol_batched_plain,
             "trsm_lower_batched": dk.trsm_lower_batched_plain,
             "trsm_lower_t_batched": dk.trsm_lower_t_batched_plain}
    summary = {k: {"max_abs_err": 0.0, "shapes": []} for k in plain}
    for name, K, M, S, zero_rows, dtypes, timed in cases:
        A64 = spd(K, M, zero_rows)
        B64 = (torch.randn(K, M, S, device=dev, dtype=torch.float64, generator=gen)
               if S else None)
        for dtype in dtypes:
            t0 = time.perf_counter()
            A = A64.to(dtype)
            if name == "chol_batched":
                args = (A,)
            else:
                # the TRSMs' input, not under test: the plain factor where
                # pivots freeze, else the library's (the plain Cholesky at
                # M = 3952 takes seconds)
                L = (dk.chol_batched_plain(A) if zero_rows
                     else torch.linalg.cholesky(A64).to(dtype).contiguous())
                args = (L, B64.to(dtype))
            kern = getattr(dk, name)
            out = kern(*args)
            ref = plain[name](*args)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(out).all())
            err = float((out - ref).abs().max())
            keep = [i for i in range(M) if i not in zero_rows]
            # scale of the entries without frozen pivots (those are 1e10)
            scale = float((ref[:, keep][:, :, keep] if S is None else ref).abs().max())
            if dtype == torch.float64:
                rel, tol = err / scale, TOL_F64
            elif name == "chol_batched":
                LLt = (out @ out.transpose(1, 2))[:, keep][:, :, keep]
                Ak = A[:, keep][:, :, keep]
                rel, tol = float((LLt - Ak).abs().max() / Ak.abs().max()), TOL_F32
            else:
                L, B = args
                Lop = L if name == "trsm_lower_batched" else L.transpose(1, 2)
                rel, tol = float((Lop @ out - B).abs().max() / B.abs().max()), TOL_F32
            dt = str(dtype).split(".")[1]
            info = {"kernel": name, "shape": [K, M, S] if S else [K, M, M], "dtype": dt,
                    "frozen": list(zero_rows), "max_abs_err": err, "rel_err": rel, "tol": tol}
            if name == "chol_batched":
                info["form"] = dk.chol_form(dtype, K, M)
            else:
                info["form"] = dk.trsm_form(dtype, K, M, S, name == "trsm_lower_t_batched")
            if dtype in timed:
                # 20 calls each, fewer where a call is long (the sphere
                # separator, the plain Cholesky's ~150 launches per 8 columns)
                rk, rp = _reps(lambda: kern(*args)), _reps(lambda: plain[name](*args))
                info["ms"] = _time_ms(lambda: kern(*args), rk, 3 if rk == 20 else 1)
                info["plain_ms"] = _time_ms(lambda: plain[name](*args), rp, 3 if rp == 20 else 1)
                info["device_ms"], info["device_ms_source"] = _device_ms(
                    lambda: kern(*args), rk, 3 if rk == 20 else 1)
                # (a plain Cholesky over 0.1 s is ~10^4-10^5 launches,
                # whose trace takes 5-60 s to read: its CUDA-event time
                # stands alone, except at the main path's shape, traced
                # twice; the plain TRSM, solve_triangular, is always traced)
                info["plain_device_ms"], info["plain_device_ms_source"] = (None, None)
                if rp >= 5 or (K, M, dtype) == main_shape or name != "chol_batched":
                    info["plain_device_ms"], info["plain_device_ms_source"] = _device_ms(
                        lambda: plain[name](*args),
                        2 if name == "chol_batched" else max(2, rp), warmup=1)
                if name == "chol_batched":  # cuSOLVER's: a yardstick, never called by the port
                    info["library_ms"] = _time_ms(lambda: torch.linalg.cholesky_ex(A))
                    info["library_device_ms"], info["library_device_ms_source"] = _device_ms(
                        lambda: torch.linalg.cholesky_ex(A))
                else:  # the plain TRSM is the library call, torch.linalg.solve_triangular
                    info["library_ms"] = info["plain_ms"]
                    info["library_device_ms"] = info["plain_device_ms"]
                    info["library_device_ms_source"] = info["plain_device_ms_source"]
                info["bound_ms"], info["bound_by"] = _bound(name, K, M, S, dt)
                summary[name]["shapes"].append({k: info[k] for k in (
                    "shape", "dtype", "form", "ms", "device_ms", "device_ms_source", "plain_ms",
                    "plain_device_ms", "library_ms", "library_device_ms", "bound_ms", "bound_by",
                    "max_abs_err", "rel_err") if k in info})
                if (K, M, dtype) == main_shape:
                    summary[name].update({k: info[k] for k in (
                        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "device_ms",
                        "device_ms_source", "plain_device_ms", "plain_device_ms_source",
                        "library_device_ms", "library_device_ms_source")})
            if not zero_rows:
                summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], err)
            _line("kernels", finite and rel <= tol, time.perf_counter() - t0, **info)
            CHECKED.add((name, K, M, S, dt))
    return summary


TOL_FUSED_KERNEL = 1e-12


def _p2c_bound(name, m, n_c, n_l):
    """Least time (ms) of one call of the BA reprojection kernel at m
    observations: every input and output byte once at the memory rate
    (indices, uv and the information per observation, points and cameras
    once; linearize writes r, Jp, Jc, WJp, WJc: 38 doubles an observation)."""
    nbytes = m * (2 * 8 + 2 * 8 + 4 * 8) + n_l * 3 * 8 + n_c * 11 * 8
    if name == "p2c_linearize":
        nbytes += m * 38 * 8
    return 1e3 * nbytes / PEAK_BYTES


def _check_fused_forms(phase, forms, ops, bound, summary, **shape) -> None:
    """Each of ``forms`` ((name, kernel, plain), each returning a tuple with
    chi2 last) against its plain version on ``ops``: every output within
    TOL_FUSED_KERNEL of the plain one's largest entry, chi2 the same bits
    over repeated calls; timed beside the plain version and ``bound(name)``
    (bytes); one ``phase`` line a form, and the form in ``summary``."""
    import torch

    m = ops[2].shape[0]
    t0 = time.perf_counter()
    for name, kern, plain in forms:
        got, want = kern(*ops), plain(*ops)
        torch.cuda.synchronize()
        rel = [float((g - w).abs().max() / max(float(w.abs().max()), 1.0))
               for g, w in zip(got, want)]
        chi2 = got[-1]
        same_bits = all(torch.equal(kern(*ops)[-1], chi2) for _ in range(3))
        del got, want
        info_line = {"kernel": name, "shape": [m], "dtype": "float64", **shape, "rel_err": rel,
                     "tol": TOL_FUSED_KERNEL, "chi2": float(chi2), "chi2_same_bits": same_bits}
        info_line["ms"] = _time_ms(lambda: kern(*ops))
        info_line["device_ms"], info_line["device_ms_source"] = _device_ms(lambda: kern(*ops))
        rp = _reps(lambda: plain(*ops))
        info_line["plain_ms"] = _time_ms(lambda: plain(*ops), rp, 1)
        info_line["plain_device_ms"], info_line["plain_device_ms_source"] = _device_ms(
            lambda: plain(*ops), max(2, rp), warmup=1)
        info_line["bound_ms"] = bound(name)
        info_line["bound_by"] = "bytes"
        info_line["bound_share"] = info_line["bound_ms"] / info_line["device_ms"]
        summary[name] = {"shapes": [{"library_device_ms": None, **{k: info_line[k] for k in (
            "shape", "dtype", "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
            "bound_by")}}]}
        _line(phase, max(rel) <= TOL_FUSED_KERNEL and same_bits, time.perf_counter() - t0,
              **info_line)
        CHECKED.add((name, m, None, None, "float64"))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()


def _venice871_arrays():
    """The benchmark's venice871 scene (871 cameras, 527,480 points, mean
    track 5.1, seed 0; the cameras moved off their poses as the
    benchmark's), observations sorted by landmark."""
    import numpy as np

    from slampp_tpu_torch.io.datasets import make_venice_ba_arrays

    cams, lms, oc, ol, uv, info, _ = make_venice_ba_arrays(
        n_cams=871, n_points=527_480, mean_track=5.1, seed=0)
    rng = np.random.default_rng(0)
    cams[:, 0:3] += rng.normal(0, 0.03, (len(cams), 3))
    cams[:, 3:6] += rng.normal(0, 0.002, (len(cams), 3))
    return cams, lms, oc, ol, uv, info


def _check_ba_kernels(dev, summary) -> None:
    """The BA reprojection kernel's two forms against their plain versions
    at venice871's shape (``_venice871_arrays``, sorted by landmark as the
    engine's plan keeps them), timed beside the plain version and the byte
    bound; adds both to ``summary``."""
    import torch

    from slampp_tpu_torch.ops import ba_kernels as bak

    cams, lms, oc, ol, uv, info = _venice871_arrays()
    ops = tuple(torch.as_tensor(a, device=dev) for a in (cams, lms, oc, ol, uv, info))
    forms = (("p2c_linearize", bak.p2c_linearize, bak.p2c_linearize_plain),
             ("p2c_chi2", lambda *a: (bak.p2c_chi2(*a),), lambda *a: (bak.p2c_chi2_plain(*a),)))
    _check_fused_forms("ba-kernels", forms, ops,
                       lambda name: _p2c_bound(name, len(oc), len(cams), len(lms)), summary,
                       n_cams=len(cams), n_points=len(lms))


def _sim3_g_bound(name, m, n_c, n_l):
    """Least time (ms) of one call of the Sim(3) edge kernel at m edges:
    every input and output byte once at the memory rate (the (point,
    camera) indices, z, the information and valid per edge; the terms form
    its order index too and writes Hpp, gp, Dl, gl, B: 89 doubles an edge;
    points and cameras once)."""
    nbytes = m * (2 * 8 + 2 * 8 + 4 * 8 + 1) + n_l * 3 * 8 + n_c * 12 * 8
    if name == "sim3_g_terms":
        nbytes += m * (8 + 89 * 8)
    return 1e3 * nbytes / PEAK_BYTES


def _check_sim3_kernels(dev, summary) -> None:
    """The Sim(3) xyz G edge kernel's two forms against the generic path on
    the card (``schur_sparse.pl_terms`` gathered into the landmark order, as
    the engine did; ``assembly.edge_chi2`` on ``error_fn``) at
    venice871_sim3's shape: ``_venice871_arrays`` embedded in Sim(3) as
    ``models/sim3.embed_ba_system_sim3`` embeds them (each world-to-camera
    pose inverted, scale 1), the terms form in the landmark order; timed
    beside the generic path and the byte bound; adds both to ``summary``."""
    import dataclasses

    import numpy as np
    import torch

    from slampp_tpu_torch.core import assembly
    from slampp_tpu_torch.geometry import sim3
    from slampp_tpu_torch.graph.system import EdgeArrays
    from slampp_tpu_torch.graph.types import TYPE_REGISTRY, get_edge_type
    from slampp_tpu_torch.linear.schur_sparse import pl_terms
    from slampp_tpu_torch.ops import sim3_kernels as sk

    name = "edge_p2c_xyz_sim3_g"
    et = get_edge_type(name)
    cams, lms, oc, ol, uv, info = _venice871_arrays()
    w2c = torch.as_tensor(np.concatenate([cams[:, 0:6], np.ones((len(cams), 1))], 1))
    cams12 = torch.cat([sim3.sim3_log(sim3.inverse_tRs(w2c)), torch.as_tensor(cams[:, 6:11])], 1)
    ops = tuple(torch.as_tensor(a, device=dev) for a in (
        lms, cams12, np.stack([ol, oc], 1), uv, info, np.ones(len(oc), bool)))
    order = torch.argsort(ops[2][:, 0], stable=True)

    def generic(points, cams, idx, meas, sigma_inv, valid):
        return ({"xyz": points, "camsim3": cams},
                EdgeArrays(idx, torch.zeros_like(idx), meas, sigma_inv, valid))

    def generic_terms(*a):
        states, ea = generic(*a)
        terms = pl_terms(et, 0, ea, states)
        return (*(t[order] for t in terms[:5]), terms[5])

    def generic_chi2(*a):
        states, ea = generic(*a)
        return (assembly.edge_chi2(name, ea, states),)

    forms = (("sim3_g_terms", lambda *a: sk.sim3_g_terms(*a, order), generic_terms),
             ("sim3_g_chi2", lambda *a: (sk.sim3_g_chi2(*a),), generic_chi2))
    # the type without its fused forms, so that edge_chi2 takes error_fn
    TYPE_REGISTRY["edge"][name] = dataclasses.replace(et, fused_terms=None, fused_chi2=None)
    try:
        _check_fused_forms("sim3-kernels", forms, ops,
                           lambda k: _sim3_g_bound(k, len(oc), len(cams), len(lms)), summary,
                           n_cams=len(cams), n_points=len(lms))
    finally:
        TYPE_REGISTRY["edge"][name] = et


def _invdist_bound(name, m, n_c, n_l):
    """Least time (ms) of one call of a form of the inverse-distance edge
    kernel at m edges: every input and output byte once at the memory rate
    (LO: the three indices, z, the information and valid per edge, the
    cameras once; the terms form writes 177 doubles an edge. LS: the index,
    the 7-wide z, the information and valid; the terms form writes 2
    doubles; the landmarks once)."""
    lo = name.startswith("invdist_lo")
    nbytes = m * ((3 * 8 + 2 * 8) if lo else (8 + 7 * 8)) + m * (4 * 8 + 1) + n_l * 4 * 8
    if lo:
        nbytes += n_c * 12 * 8
    if name.endswith("terms"):
        nbytes += m * (177 if lo else 2) * 8
    return 1e3 * nbytes / PEAK_BYTES


def _check_invdist_kernels(graph, summary) -> None:
    """The inverse-distance edge kernel's four forms against the generic
    path on the card (``schur_sparse.generic_terms``, the LO edge's two
    couplings concatenated as the engine did; ``assembly.edge_chi2`` on
    ``error_fn``) on ``graph``'s LO and LS edges (the benchmark cell
    venice871_sim3_invdist.lm's start graph); timed beside the generic path
    and the byte bound; adds each form to ``summary``."""
    import dataclasses

    import torch

    from slampp_tpu_torch.core import assembly
    from slampp_tpu_torch.graph.system import EdgeArrays
    from slampp_tpu_torch.graph.types import TYPE_REGISTRY, get_edge_type
    from slampp_tpu_torch.linear.schur_sparse import generic_terms
    from slampp_tpu_torch.models.sim3 import _invdist_lo_operands, _invdist_ls_operands
    from slampp_tpu_torch.ops import invdist_kernels as ik

    lo, ls = "edge_p2c_invdist_sim3_lo", "edge_p2c_invdist_sim3_ls"
    types = {t: get_edge_type(t) for t in (lo, ls)}
    n_c, n_l = graph.states["camsim3"].shape[0], graph.states["invdist"].shape[0]

    def generic(ops):
        states = {"invdist": ops[0]}
        if len(ops) == 6:
            states["camsim3"] = ops[1]
        idx, meas, info, valid = ops[-4:]
        return states, EdgeArrays(idx, torch.zeros_like(idx), meas, info, valid)

    def lo_terms(*ops):
        t = generic_terms(types[lo], "ter", 0, *generic(ops)[::-1])
        return (*t[:7], torch.cat([t[7], t[8]]), t[9])

    def ls_terms(*ops):
        return generic_terms(types[ls], "u_lm", None, *generic(ops)[::-1])

    def chi2(name):
        return lambda *ops: (assembly.edge_chi2(name, generic(ops)[1], generic(ops)[0]),)

    # the types without their fused forms, so that edge_chi2 takes error_fn
    for t, et in types.items():
        TYPE_REGISTRY["edge"][t] = dataclasses.replace(et, fused_terms=None, fused_chi2=None)
    try:
        for name, ops, forms in (
                (lo, _invdist_lo_operands(graph.edges[lo], graph.states),
                 (("invdist_lo_terms", ik.invdist_lo_terms, lo_terms),
                  ("invdist_lo_chi2", lambda *a: (ik.invdist_lo_chi2(*a),), chi2(lo)))),
                (ls, _invdist_ls_operands(graph.edges[ls], graph.states),
                 (("invdist_ls_terms", ik.invdist_ls_terms, ls_terms),
                  ("invdist_ls_chi2", lambda *a: (ik.invdist_ls_chi2(*a),), chi2(ls))))):
            m = ops[-1].shape[0]
            _check_fused_forms("invdist-kernels", forms, ops,
                               lambda k, m=m: _invdist_bound(k, m, n_c, n_l), summary,
                               n_cams=n_c, n_landmarks=n_l, edge_type=name)
    finally:
        TYPE_REGISTRY["edge"].update(types)


def _check_schur_kernel(dev, summary) -> None:
    """The sparse Schur engine's slot-sum kernel against its plain version
    at venice871_sim3's shape: the benchmark's scene
    (``_venice871_arrays``) embedded in Sim(3) as the benchmark's route
    embeds it, the engine's table and edge terms and BD = B Dinv at damping
    1e-3; each entry within (n_s + dl) 2^-52 S (its slot's n_s terms, S the
    sum of their absolute values, dl for each pair's dot product;
    tests/test_torch_schur_kernels.py), the same bits over repeated calls;
    timed beside the plain version and the byte bound (every head block, BD
    and B row and table entry read once, every slot block written once);
    adds the kernel to ``summary``."""
    import torch

    from slampp_tpu_torch.apps.sim3 import ba_system_from_arrays
    from slampp_tpu_torch.linear.schur_sparse import SparseSchurSolver
    from slampp_tpu_torch.models.sim3 import embed_ba_system_sim3
    from slampp_tpu_torch.ops import schur_kernels as sk
    from slampp_tpu_torch.ops.segments import grouped_segsum_first
    from slampp_tpu_torch.ops.small_blocks import inverse_spd_small

    t0 = time.perf_counter()
    system = embed_ba_system_sim3(ba_system_from_arrays(*_venice871_arrays()))
    ss = SparseSchurSolver(system, device=dev)
    ss.symbolic()
    t_setup = time.perf_counter() - t0
    terms = ss._edge_terms(system.snapshot(dev))
    p, B = ss.plan, terms[9]
    D = grouped_segsum_first(terms[7], p.lm_grp) + 1e-3 * torch.eye(3, dtype=B.dtype, device=dev)
    BD = torch.einsum("eij,ejk->eik", B, inverse_spd_small(D)[p.pl_lm])
    ops, table = (terms[0], terms[1], terms[2], terms[5], BD, B), p.slots
    del terms, D
    t0 = time.perf_counter()
    got = sk.slot_sums(*ops, table)
    want = sk.slot_sums_plain(*ops, table)
    z = [torch.zeros_like(t) for t in ops]
    S = (sk.slot_sums_plain(*(t.abs() for t in ops[:4]), *z[4:], table)
         - sk.slot_sums_plain(*z[:4], *(t.abs() for t in ops[4:]), table))
    n_s = torch.zeros(table.out.shape[0], dtype=torch.float64, device=dev)
    n_s[table.out.long()] = (torch.diff(table.hptr) + torch.diff(table.pptr)).double()
    bound = (n_s[:, None, None] + B.shape[2]) * 2.0 ** -52 * S
    excess = float(((got - want).abs() - bound).max())
    rel = float((got - want).abs().max() / want.abs().max())
    same_bits = all(torch.equal(sk.slot_sums(*ops, table), got) for _ in range(3))
    del want, S, z, bound
    torch.cuda.empty_cache()
    n_pl, bs, dl = B.shape
    n_hit, n_heads, n_pairs = table.out.shape[0], table.heads.shape[0], table.pair_e.shape[0]
    nbytes = (8 * (n_heads * bs * bs + 2 * n_pl * bs * dl + n_hit * bs * bs)
              + 4 * (3 * n_hit + 2 + n_heads + 2 * n_pairs))
    info = {"kernel": "slot_sums", "shape": [n_hit, bs, dl], "dtype": "float64",
            "n_slots": n_hit, "n_heads": n_heads, "n_pairs": n_pairs, "n_obs": n_pl,
            "setup_s": t_setup, "max_excess_over_bound": excess, "rel_err": rel,
            "same_bits": same_bits, "ms": _time_ms(lambda: sk.slot_sums(*ops, table))}
    info["device_ms"], info["device_ms_source"] = _device_ms(lambda: sk.slot_sums(*ops, table))
    rp = _reps(lambda: sk.slot_sums_plain(*ops, table))
    info["plain_ms"] = _time_ms(lambda: sk.slot_sums_plain(*ops, table), rp, 1)
    info["plain_device_ms"], info["plain_device_ms_source"] = _device_ms(
        lambda: sk.slot_sums_plain(*ops, table), max(2, rp), warmup=1)
    info.update(bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes")
    info["bound_share"] = info["bound_ms"] / info["device_ms"]
    summary["slot_sums"] = {"shapes": [{"library_device_ms": None, **{k: info[k] for k in (
        "shape", "dtype", "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
        "bound_by")}}]}
    _line("schur-kernels", excess <= 0.0 and same_bits, time.perf_counter() - t0, **info)
    CHECKED.add(("slot_sums", n_hit, bs, dl, "float64"))
    del ss, system, ops, got
    torch.cuda.empty_cache()


def _trsm_graph(dev) -> None:
    """One separator-form TRSM (its workspace zeroed on the stream, then one
    launch) captured in a CUDA graph at sphere-f64's separator shape and
    replayed on two new right-hand sides, each held to the plain version
    (f64: max |kernel - plain| over max |plain| within TOL_F64)."""
    import torch

    from slampp_tpu_torch.ops import dense_kernels as dk

    t0 = time.perf_counter()
    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(7)
    M = 3952
    G = torch.randn(1, M, M, device=dev, dtype=f64, generator=gen)
    L = torch.linalg.cholesky(G @ G.transpose(1, 2) + M * torch.eye(M, device=dev, dtype=f64))
    L = L.contiguous()
    B = torch.randn(1, M, 8, device=dev, dtype=f64, generator=gen)
    form = dk.trsm_form(f64, 1, M, 8, True)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        dk.trsm_lower_t_batched(L, B)  # the plan and the kernel's attributes, before capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        X = dk.trsm_lower_t_batched(L, B)
    rels = []
    for _ in range(2):
        B.copy_(torch.randn(1, M, 8, device=dev, dtype=f64, generator=gen))
        graph.replay()
        ref = dk.trsm_lower_t_batched_plain(L, B)
        torch.cuda.synchronize()
        rels.append(float((X - ref).abs().max() / ref.abs().max()))
    ok = form == "separator" and bool(torch.isfinite(X).all()) and max(rels) < TOL_F64
    _line("trsm-graph", ok, time.perf_counter() - t0, kernel="trsm_lower_t_batched",
          shape=[1, M, 8], dtype="float64", form=form, rel_err=rels, tol=TOL_F64)


def _chol_graph(dev) -> None:
    """One large-form Cholesky (its workspace zeroed on the stream, then one
    launch: no cooperative launch, no grid barrier) captured in a CUDA graph
    at sphere-exact's separator shape and replayed on two new matrices, each
    held to the plain version (f64: max |kernel - plain| over max |plain|
    within TOL_F64) and bit for bit to an eager launch of the kernel."""
    import torch

    from slampp_tpu_torch.ops import dense_kernels as dk

    t0 = time.perf_counter()
    f64 = torch.float64
    gen = torch.Generator(device=dev).manual_seed(11)
    M = 1472
    eye = torch.eye(M, device=dev, dtype=f64)

    def new_matrix():
        G = torch.randn(1, M, M, device=dev, dtype=f64, generator=gen)
        return G @ G.transpose(1, 2) / M + eye

    A = new_matrix()
    form = dk.chol_form(f64, 1, M)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        dk.chol_batched(A)  # the plan and the kernel's attributes, before capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        L = dk.chol_batched(A)
    rels, same = [], []
    for _ in range(2):
        A.copy_(new_matrix())
        graph.replay()
        ref = dk.chol_batched_plain(A)
        eager = dk.chol_batched(A)
        torch.cuda.synchronize()
        rels.append(float((L - ref).abs().max() / ref.abs().max()))
        same.append(bool(torch.equal(L, eager)))
    ok = (form == "large" and bool(torch.isfinite(L).all()) and max(rels) < TOL_F64
          and all(same))
    _line("chol-graph", ok, time.perf_counter() - t0, kernel="chol_batched", shape=[1, M, M],
          dtype="float64", form=form, rel_err=rels, equal_to_eager=same, tol=TOL_F64)


# pose vertex type -> its state width
POSE_DIMS = {"pose2d": 3, "pose3d": 6}


def _states_ok(states, n_poses) -> bool:
    """Every state finite, and one pose per vertex of the graph's pose type."""
    import torch

    (pose,) = [t for t in states if t in POSE_DIMS]
    return (all(bool(torch.isfinite(s).all()) for s in states.values())
            and states[pose].shape == (n_poses, POSE_DIMS[pose]))


def _run_path(phase, run, dev, n_poses, expected, tol, ok=True, **kw):
    t0 = time.perf_counter()
    res = run(n_poses, dev, **kw)
    states = res.pop("states")
    rel = abs(res["chi2_final"] - expected) / expected
    _line(phase, ok and rel < tol and _states_ok(states, n_poses), time.perf_counter() - t0,
          expected=expected, rel_err=rel, tol=tol, **res)
    return res


def _solver_phase(phase, nls, engine, dev):
    """One batch solver on manhattan3500 against the JAX package's result;
    its kernel launches counted from zero."""
    from slampp_tpu_torch.apps import manhattan
    from slampp_tpu_torch.ops import dense_kernels as dk

    expected, applied_ref = JAX_REF[phase]
    t0 = time.perf_counter()
    dk.reset_launches()
    res = manhattan.run_solver(3500, dev, nls, engine)
    launches = dict(dk.launches)
    states = res.pop("states")
    rel = abs(res["chi2_final"] - expected) / expected
    exact = engine is None
    tol = TOL_SOLVER_F64 if exact else TOL_3500
    ok = rel <= tol and _states_ok(states, 3500)
    if exact:
        ok = ok and res["applied"] == applied_ref and not any(launches.values())
    else:
        ok = ok and all(v > 0 for v in launches.values())
    iters = res["iterations"]
    _line(phase, ok, time.perf_counter() - t0, expected=expected, applied_ref=applied_ref,
          rel_err=rel, tol=tol, launches_per_iter={k: v / iters for k, v in launches.items()},
          **res)
    return {k: v / iters for k, v in launches.items()}


def _prior_phase(dev):
    import torch

    from slampp_tpu_torch.apps import manhattan
    from slampp_tpu_torch.ops import dense_kernels as dk

    t0 = time.perf_counter()
    dk.reset_launches()
    res = manhattan.run_prior(3500, dev)
    launches = dict(dk.launches)
    states = res.pop("states")
    dx_rel = abs(res["dx_norm"] - res["dx_norm_ref"]) / res["dx_norm_ref"]
    ok = (res["residual"] <= TOL_PRIOR_RES and dx_rel <= TOL_PRIOR_DX
          and abs(res["chi2"] - res["chi2_ref"]) <= 1e-9 * res["chi2_ref"]
          and all(bool(torch.isfinite(s).all()) for s in states.values())
          and all(v > 0 for v in launches.values()))
    _line("prior", ok, time.perf_counter() - t0, dx_rel_err=dx_rel,
          tol_residual=TOL_PRIOR_RES, tol_dx=TOL_PRIOR_DX, **res)
    return launches


def _native_phase(dev):
    """The native engines at manhattan3500 (apps/manhattan.run_native), each
    run's launches counted from zero; the graph runs against the eager run
    of the same engine and panel."""
    from slampp_tpu_torch.apps import manhattan
    from slampp_tpu_torch.ops import dense_kernels as dk

    eager = {}
    for name, engine, panel, fused in NATIVE_RUNS:
        t0 = time.perf_counter()
        dk.reset_launches()
        res = manhattan.run_native(3500, dev, engine, panel, fused=fused)
        launches = dict(dk.launches)
        states = res.pop("states")
        expected = JAX_REF["native"][name]
        rel = abs(res["chi2_final"] - expected) / expected
        ok = rel <= TOL_NATIVE and not any(launches.values()) and _states_ok(states, 3500)
        info = {}
        if fused:
            ref = eager[name]
            info["graph_vs_eager"] = max(float((states[t] - ref[t]).abs().max()) for t in ref)
            ok = ok and info["graph_vs_eager"] <= TOL_GRAPH
        else:
            eager[name] = states
        _line(f"native-{name}{'-graph' if fused else ''}", ok, time.perf_counter() - t0,
              expected=expected, rel_err=rel, tol=TOL_NATIVE, tol_graph=TOL_GRAPH, **info, **res)


def _marginals_phase(dev):
    import numpy as np

    from slampp_tpu_torch.apps import manhattan
    from slampp_tpu_torch.ops import dense_kernels as dk

    ref = JAX_REF["marginals"]
    t0 = time.perf_counter()
    dk.reset_launches()
    res = manhattan.run_marginals(3500, dev)
    b0, rb0 = np.asarray(res["block0"]), np.asarray(ref["block0"])
    rel = {"block0": float(np.abs(b0 - rb0).max() / np.abs(rb0).max()),
           "trace_sum": abs(res["trace_sum"] - ref["trace_sum"]) / ref["trace_sum"]}
    ok = (res["same_vertices"] and res["max_rel_block_diff"] <= TOL_MARG
          and all(v <= TOL_MARG_REF for v in rel.values()) and not any(dk.launches.values()))
    _line("marginals", ok, time.perf_counter() - t0, rel_err_jax=rel, tol=TOL_MARG,
          tol_jax=TOL_MARG_REF, launches=dict(dk.launches), **res)


def _eigen_phase(dev):
    """The eigenvalue analysis at manhattan3500; returns its launches per
    solve_shifted that reuses the factor."""
    from slampp_tpu_torch.apps import manhattan
    from slampp_tpu_torch.ops import dense_kernels as dk

    ref = JAX_REF["eigen"]
    t0 = time.perf_counter()
    dk.reset_launches()
    res = manhattan.run_eigen(3500, dev)
    launches = dict(dk.launches)
    rel = {k: abs(res[k] - ref[k]) / abs(ref[k]) for k in ("lmax", "lmin")}
    dtypes = {s[4] for s in res["kernel_shapes"]}
    ok = (rel["lmax"] <= TOL_EIG_MAX and rel["lmin"] <= TOL_EIG_MIN
          and all(v > 0 for v in res["launches"].values()) and dtypes == {"float64"})
    _line("eigen", ok, time.perf_counter() - t0, rel_err=rel, tol_max=TOL_EIG_MAX,
          tol_min=TOL_EIG_MIN, reference=ref, launches_phase=launches, **res)
    return res["solve_shifted"]["solve"]["launches"]


def _sphere_phases(dev) -> dict:
    """The SE(3) sphere phases (apps/sphere) against JAX_REF, each one's
    launches counted from zero; returns the launches per GN / solver
    iteration of those that launch the kernels."""
    from slampp_tpu_torch.apps import sphere
    from slampp_tpu_torch.ops import dense_kernels as dk

    per_iter = {}
    ref = JAX_REF["sphere"]
    dk.reset_launches()
    res = _run_path("sphere", sphere.run, dev, 2500, ref["chi2_final"], TOL_3500, n_rep=3)
    launches = dict(dk.launches)
    _line("sphere-launches", all(res["plan"][k] == v for k, v in ref["plan"].items())
          and all(v > 0 for v in launches.values()), 0.0, plan=res["plan"], launches=launches,
          kernel_shapes=sorted(dk.launch_shapes, key=lambda s: (s[0], s[1], s[2], s[3] or 0)))
    per_iter["sphere"] = {k: v / (res["n_iters"] * (1 + res["n_rep"]))
                          for k, v in launches.items()}

    # exact f64 at sphere2500: the (1, 3952, 3952) f64 separator takes the
    # large form (the one-CTA kernel stopped at M = 3104)
    dk.reset_launches()
    res = _run_path("sphere-f64", sphere.run, dev, 2500, JAX_REF["sphere-f64"], TOL_SPHERE_F64,
                    mixed_precision=False, n_rep=1)
    launches = dict(dk.launches)
    _line("sphere-f64-launches", all(v > 0 for v in launches.values())
          and {s[4] for s in dk.launch_shapes} == {"float64"}
          and ("chol_batched", 1, 3952, None, "float64") in dk.launch_shapes, 0.0,
          plan=res["plan"], launches=launches)
    per_iter["sphere-f64"] = {k: v / (res["n_iters"] * (1 + res["n_rep"]))
                              for k, v in launches.items()}

    ref = JAX_REF["sphere-exact"]
    dk.reset_launches()
    res = _run_path("sphere-exact", sphere.run, dev, 1000, ref["chi2_final"], TOL_500,
                    mixed_precision=False, n_rep=2)
    launches = dict(dk.launches)
    _line("sphere-exact-launches", all(v > 0 for v in launches.values())
          and {s[4] for s in dk.launch_shapes} == {"float64"}, 0.0, plan=res["plan"],
          launches=launches)
    per_iter["sphere-exact"] = {k: v / (res["n_iters"] * (1 + res["n_rep"]))
                                for k, v in launches.items()}

    for phase, nls, engine, robust, max_iters, tol in SPHERE_SOLVER_PHASES:
        expected, applied_ref = JAX_REF[phase]
        t0 = time.perf_counter()
        dk.reset_launches()
        res = sphere.run_solver(2500, dev, nls, engine, robust, max_iters=max_iters)
        launches = dict(dk.launches)
        states = res.pop("states")
        rel = abs(res["chi2_final"] - expected) / expected
        ok = (rel <= tol and res["applied"] == applied_ref
              and _states_ok(states, 2500) and all(v > 0 for v in launches.values()))
        if robust is not None:
            ok = ok and res["robust"]["share_below_1"] > 0
        per_iter[phase] = {k: v / res["iterations"] for k, v in launches.items()}
        _line(phase, ok, time.perf_counter() - t0, expected=expected, applied_ref=applied_ref,
              rel_err=rel, tol=tol, launches_per_iter=per_iter[phase], **res)

    # -nls lambda (native v1, f64), then v2 eager and as the CUDA graph
    expected, applied_ref = JAX_REF["sphere-gn"]
    t0 = time.perf_counter()
    dk.reset_launches()
    res = sphere.run_solver(2500, dev, "lambda")
    states = res.pop("states")
    rel = abs(res["chi2_final"] - expected) / expected
    _line("sphere-gn", rel <= TOL_SOLVER_F64 and res["applied"] == applied_ref
          and _states_ok(states, 2500) and not any(dk.launches.values()),
          time.perf_counter() - t0, expected=expected, applied_ref=applied_ref, rel_err=rel,
          tol=TOL_SOLVER_F64, **res)
    expected = JAX_REF["sphere-gn-v2"]
    eager = None
    for fused in (False, True):
        t0 = time.perf_counter()
        dk.reset_launches()
        res = sphere.run_native(2500, dev, "v2", panel=1, fused=fused)
        states = res.pop("states")
        rel = abs(res["chi2_final"] - expected) / expected
        ok = rel <= TOL_NATIVE and not any(dk.launches.values()) and _states_ok(states, 2500)
        info = {}
        if fused:
            info["graph_vs_eager"] = max(float((states[t] - eager[t]).abs().max())
                                         for t in eager)
            ok = ok and info["graph_vs_eager"] <= TOL_GRAPH
        else:
            eager = states
        _line(f"sphere-gn-v2{'-graph' if fused else ''}", ok, time.perf_counter() - t0,
              expected=expected, rel_err=rel, tol=TOL_NATIVE, tol_graph=TOL_GRAPH, **info, **res)

    expected, applied_ref = JAX_REF["sphere-landmarks"]
    t0 = time.perf_counter()
    dk.reset_launches()
    res = sphere.run_solver(300, dev, "lambda-lm", n_rings=10, landmarks=True)
    states = res.pop("states")
    rel = abs(res["chi2_final"] - expected) / expected
    _line("sphere-landmarks", rel <= TOL_SOLVER_F64 and res["applied"] == applied_ref
          and _states_ok(states, 300) and states["landmark3d"].shape[1] == 3,
          time.perf_counter() - t0, expected=expected, applied_ref=applied_ref, rel_err=rel,
          tol=TOL_SOLVER_F64, **res)
    return per_iter


# the BA phases: venice with the float32 SC of float32 pair products (the
# bench's setting) within 5e-3 of the JAX package's CPU run, with the
# float64 SC of float64 pair products within 1e-6.  (The JAX package's
# float64 SC of float32 pair products is no reference: its LM run follows
# their rounding, rejecting a step at iteration 3 (chi2 9.87e6) that the
# port, rounding otherwise, accepts: 4 against 5 accepted, 3.9e-4 apart;
# with float64 pair products both accept 5 and agree to 3.9e-11, PERF.md.)
# The dense Schur LM (float64) within 1e-6; cityTrees10k's dogleg through
# the sparse Schur engine (mixed v3) within 5e-3; the marginals within 1e-6
TOL_BA = {"ba-venice": 5e-3, "ba-venice-f64": 1e-6, "ba-schur": 1e-6,
          "city-schur-sparse": 5e-3, "ba-marginals": 1e-6}
# the Sim(3) phases: the mixed venice run against its own f64 run (the JAX
# package's engine refuses that size), the JAX-size run against the JAX
# package's mixed run as ba-venice is held, the dense f64 LM as the f64
# solver phases.  ROCV's range-only GN oscillates (chi2 2e5 -> 5e4 with
# |dx| ~ 200 each step) on a system so ill-conditioned that the JAX
# package's own chi2 after one step moves 7e-8 and after 15 steps 1e-7 to
# 2.6e-7 when its start states are scaled by 1 + 1e-15 N(0, 1)
# (python tests/_torch_jax_util.py --sensitivity): 1e-6.  Spheron and SPCG
# as the mixed and f64 phases
TOL_SIM3 = {"sim3-venice": 1e-5, "sim3-venice-ref": 5e-3, "sim3-small": 1e-8, "rocv": 1e-6,
            "spheron": 5e-3, "a-solver": 1e-8, "spcg": 1e-6}


def _ba_phases(dev) -> dict:
    """The BA phases (apps/ba) against JAX_REF, each one's launches counted
    from zero; returns the sparse Schur dogleg's launches per iteration."""
    import numpy as np
    import torch

    from slampp_tpu_torch.apps import ba
    from slampp_tpu_torch.ops import ba_kernels as bak
    from slampp_tpu_torch.ops import dense_kernels as dk

    for phase, sc_f64 in (("ba-venice", False), ("ba-venice-f64", True)):
        ref, tol = JAX_REF[phase], TOL_BA[phase]
        t0 = time.perf_counter()
        dk.reset_launches()
        bak.reset_launches()
        res = ba.run_venice(871, 110_000, 10, dev, sc_f64=sc_f64, pair_f32=not sc_f64)
        res["p2c_launches"] = dict(bak.launches)
        rel = abs(res["chi2_final"] - ref["chi2_final"]) / ref["chi2_final"]
        ok = (rel <= tol and res["lm_accepted"] == ref["lm_accepted"]
              and res["n_obs"] == ref["n_obs"] and not any(dk.launches.values())
              and all(v > 0 for v in bak.launches.values())
              and abs(res["chi2_init"] - ref["chi2_init"]) <= 1e-9 * ref["chi2_init"])
        _line(phase, ok, time.perf_counter() - t0, reference=ref, rel_err=rel, tol=tol, **res)
        RESULTS[phase] = res

    expected, applied_ref = JAX_REF["ba-schur"]
    t0 = time.perf_counter()
    res = ba.run_ba_scene(20, 500, dev)
    states = res.pop("states")
    rel = abs(res["chi2_final"] - expected) / expected
    _line("ba-schur", rel <= TOL_BA["ba-schur"] and res["applied"] == applied_ref
          and all(bool(torch.isfinite(s).all()) for s in states.values()),
          time.perf_counter() - t0, expected=expected, applied_ref=applied_ref, rel_err=rel,
          tol=TOL_BA["ba-schur"], **res)

    expected, applied_ref = JAX_REF["city-schur-sparse"]
    t0 = time.perf_counter()
    res = ba.run_city_schur(10000, 100, dev)
    states = res.pop("states")
    rel = abs(res["chi2_final"] - expected) / expected
    ok = (rel <= TOL_BA["city-schur-sparse"] and res["applied"] == applied_ref
          and res["engine"] == "schur_sparse" and all(v > 0 for v in res["launches"].values())
          and all(bool(torch.isfinite(s).all()) for s in states.values()))
    _line("city-schur-sparse", ok, time.perf_counter() - t0, expected=expected,
          applied_ref=applied_ref, rel_err=rel, tol=TOL_BA["city-schur-sparse"], **res)
    per_iter = {k: v / res["iterations"] for k, v in res["launches"].items()}

    ref = JAX_REF["ba-marginals"]
    t0 = time.perf_counter()
    res = ba.run_ba_marginals(20, 500, dev)
    rel = {k: abs(res[k] - ref[k]) / abs(ref[k]) for k in ("trace_cc", "trace_ll")}
    for k in ("cam0", "lm0"):
        got, want = np.asarray(res[k]), np.asarray(ref[k])
        rel[k] = float(np.abs(got - want).max() / np.abs(want).max())
    _line("ba-marginals", res["finite"] and all(v <= TOL_BA["ba-marginals"] for v in rel.values()),
          time.perf_counter() - t0, rel_err=rel, tol=TOL_BA["ba-marginals"], **res)
    return {"city-schur-sparse": per_iter}


def _sim3_phases(dev) -> dict:
    """The Sim(3), ROCV, Spheron, A and SPCG phases (apps/sim3,
    apps/manhattan.run_solver) against JAX_REF, each one's launches counted
    from zero; returns their kernel launches per iteration."""
    import torch

    from slampp_tpu_torch.apps import manhattan, sim3
    from slampp_tpu_torch.ops import dense_kernels as dk

    def rel(a, b):
        return abs(a - b) / abs(b)

    def launched_checked(launches, shapes):
        return all(v > 0 for v in launches.values()) and set(map(tuple, shapes)) <= CHECKED

    def sim3_launched(run):
        # the LM loop of n iterations alone: the terms form for the initial
        # damping and each step, the chi2 form for the start and each
        # candidate, the slot sums once a damped step
        n = run["lm_iterations"]
        return (run["sim3_launches"] == {"sim3_g_terms": 1 + n, "sim3_g_chi2": n + 1}
                and run["slot_launches"] == {"slot_sums": n})

    per_iter = {}
    ref, tol = JAX_REF["sim3-venice"], TOL_SIM3["sim3-venice"]
    t0 = time.perf_counter()
    dk.reset_launches()
    res = sim3.run_sim3_venice(871, 110_000, 10, dev, f64_check=True)
    f64 = res["f64"]
    err = {"vs_f64": rel(res["chi2_final"], f64["chi2_final"]),
           "chi2_init_vs_jax": rel(res["chi2_init"], ref["chi2_init"])}
    ok = (res["engine"] == "schur_sparse" and res["n_obs"] == ref["n_obs"]
          and err["vs_f64"] <= tol and err["chi2_init_vs_jax"] <= 1e-9
          and res["lm_accepted"] == f64["lm_accepted"]
          and launched_checked(res["launches_per_iter"], res["kernel_shapes"])
          and launched_checked(f64["launches_per_iter"], f64["kernel_shapes"])
          and {s[4] for s in f64["kernel_shapes"]} == {"float64"}
          and sim3_launched(res) and sim3_launched(f64))
    _line("sim3-venice", ok, time.perf_counter() - t0, reference=ref, rel_err=err, tol=tol,
          launches_phase=dict(dk.launches), **res)
    RESULTS["sim3-venice"] = res
    per_iter["sim3-venice"] = res["launches_per_iter"]
    per_iter["sim3-venice-f64"] = f64["launches_per_iter"]
    torch.cuda.empty_cache()

    ref, tol = JAX_REF["sim3-venice-ref"], TOL_SIM3["sim3-venice-ref"]
    t0 = time.perf_counter()
    dk.reset_launches()
    res = sim3.run_sim3_venice(ref["n_cams"], ref["n_points"], 10, dev)
    err = {"chi2_final": rel(res["chi2_final"], ref["chi2_final"]),
           "chi2_init": rel(res["chi2_init"], ref["chi2_init"])}
    ok = (res["engine"] == "schur_sparse" and res["n_obs"] == ref["n_obs"]
          and err["chi2_final"] <= tol and err["chi2_init"] <= 1e-9
          and res["lm_accepted"] == ref["lm_accepted"]
          and launched_checked(res["launches_per_iter"], res["kernel_shapes"])
          and sim3_launched(res))
    _line("sim3-venice-ref", ok, time.perf_counter() - t0, reference=ref, rel_err=err, tol=tol,
          **res)
    RESULTS["sim3-venice-ref"] = res
    per_iter["sim3-venice-ref"] = res["launches_per_iter"]
    torch.cuda.empty_cache()

    for phase, run in (("sim3-small", lambda: sim3.run_sim3_small(dev)),
                       ("rocv", lambda: sim3.run_rocv(1000, 8, dev)),
                       ("spheron", lambda: sim3.run_spheron(64, 2000, dev)),
                       ("a-solver", lambda: manhattan.run_solver(3500, dev, "A")),
                       ("spcg", lambda: manhattan.run_solver(3500, dev, "spcg"))):
        t0 = time.perf_counter()
        dk.reset_launches()
        res = run()
        launches = dict(dk.launches)
        states = res.pop("states")
        if phase == "spcg":
            ref = JAX_REF["spcg"]
            expected, applied_ref = ref["chi2"], ref["applied"]
        else:
            expected, applied_ref = JAX_REF["gn" if phase == "a-solver" else phase]
        err = rel(res["chi2_final"], expected)
        ok = (err <= TOL_SIM3[phase] and res["applied"] == applied_ref
              and all(bool(torch.isfinite(s).all()) for s in states.values()))
        if phase == "spheron":
            ok = (ok and res["engine"] == "schur_sparse"
                  and launched_checked(launches, res["kernel_shapes"]))
            per_iter[phase] = {k: v / res["iterations"] for k, v in launches.items()}
        else:  # the dense, native and v2 paths launch no dense kernel
            ok = ok and not any(launches.values())
        if phase == "spcg":
            ok = ok and res["cg_counts"] == ref["cg_counts"]
        if phase == "rocv":
            ok = ok and res["problem"] == "rocv"
        _line(phase, ok, time.perf_counter() - t0, expected=expected, applied_ref=applied_ref,
              rel_err=err, tol=TOL_SIM3[phase], launches_phase=launches, **res)
    return per_iter


# the benchmark cell venice871_sim3_invdist.lm's seed-0 counts (the
# configuration's "assumed" counts: LO edges, kept pairs of (landmark,
# camera) rows, which equal venice871_sim3's observation pairs)
INVDIST_COUNTS = {"n_ternary": 2_264_792, "n_pairs": 13_909_180}
INVDIST_SPANS = ("ss.edge_terms", "ss.rows", "ss.landmarks", "ss.pairs", "ss.assemble",
                 "v3.factor", "ss.backsub", "lm.chi2")


def _sim3_invdist_phase(dev) -> None:
    """sim3-invdist-venice: the cell venice871_sim3_invdist.lm's solve at
    its full size (seed 0) through its benchmark route: the plan's counts
    against INVDIST_COUNTS; the inverse-distance edge kernel's four forms on
    the start graph (``_check_invdist_kernels``); the slot-sum kernel at (7, 1) against its plain
    version on the engine's own terms (each entry within (n_s + dl) 2^-52 S,
    as schur-kernels); one warm solve traced for the device ms of each layer
    per LM iteration, three timed (one slot-sum launch a damped step); the
    final states against the plain reference
    (portbench/reference/sim3_invdist_lm.py) under the cell's limits; the
    peak device memory."""
    import torch

    from portbench import harness, traces
    from portbench.reference import sim3_invdist_lm as ref_mod
    from portbench.routes.sim3_invdist_lm import Route
    from slampp_tpu_torch.ops import invdist_kernels as ik
    from slampp_tpu_torch.ops import schur_kernels as sk
    from slampp_tpu_torch.ops.segments import grouped_segsum_first
    from slampp_tpu_torch.ops.small_blocks import inverse_spd_small

    cell, config = harness.cell_files("venice871_sim3_invdist.lm")
    t0 = time.perf_counter()
    route = Route(config, cell["solve"], 0, dev)
    setup_s = time.perf_counter() - t0
    ss = route.lm._ss_solver()
    p = ss.plan
    counts = {"n_ternary": p.n_ternary, "n_rows": p.n_rows, "n_pairs": p.n_pairs,
              "n_heads": p.n_heads, "n_landmarks": p.n_l, "n_obs": route.lm.system.n_edges}
    _check_invdist_kernels(route.start, {})
    torch.cuda.empty_cache()

    # the slot sums at (7, 1) on the engine's terms, kernel against plain
    terms = ss._edge_terms(route.start)
    B = grouped_segsum_first(terms[9], p.rows)
    D = grouped_segsum_first(terms[7], p.lm_grp) + 1e-3
    ops = (terms[0], terms[1], terms[2], terms[5],
           torch.einsum("eij,ejk->eik", B, inverse_spd_small(D)[p.row_lm]), B)
    del terms, D
    got = sk.slot_sums(*ops, p.slots)
    want = sk.slot_sums_plain(*ops, p.slots)
    z = [torch.zeros_like(t) for t in ops]
    S = (sk.slot_sums_plain(*(t.abs() for t in ops[:4]), *z[4:], p.slots)
         - sk.slot_sums_plain(*z[:4], *(t.abs() for t in ops[4:]), p.slots))
    n_s = torch.zeros(p.slots.out.shape[0], dtype=torch.float64, device=dev)
    n_s[p.slots.out.long()] = (torch.diff(p.slots.hptr) + torch.diff(p.slots.pptr)).double()
    excess = float(((got - want).abs() - (n_s[:, None, None] + 1) * 2.0 ** -52 * S).max())
    slot = {"shape": list(got.shape), "max_excess_over_bound": excess,
            "same_bits": all(torch.equal(sk.slot_sums(*ops, p.slots), got) for _ in range(2))}
    slot["device_ms"], slot["device_ms_source"] = _device_ms(lambda: sk.slot_sums(*ops, p.slots))
    del got, want, z, S, ops, B
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)  # the solves' peak, not the plain check's

    # one warm solve, one traced, three timed
    route.solve()
    torch.cuda.synchronize(dev)
    iters = []

    def traced():
        iters.append(route.solve()[1])
        torch.cuda.synchronize(dev)

    view = traces.capture(traced, dev)
    layers = {name: 1e3 * sec / iters[0] for name in INVDIST_SPANS
              if (sec := view.range_device_s(name)) is not None}
    sk.reset_launches()
    ik.reset_launches()
    t1 = time.perf_counter()
    n_it = 0
    for _ in range(3):
        raw, it = route.solve()
        n_it += it
    torch.cuda.synchronize(dev)
    rate = n_it / (time.perf_counter() - t1)
    launches = dict(sk.launches)  # the slot sums once a damped step
    # each inverse-distance form: the damping scale's terms or the start's
    # chi2, then once an iteration
    invdist_launches = dict(ik.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    out = route.output(raw)
    out = {k: v.clone() for k, v in out.items()}
    inputs = route.inputs()
    route.release()
    del route, ss, p, raw
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    ref = ref_mod.run(inputs, cell["solve"], dev)
    nums = ref_mod.compare(ref, out)
    reference_s = time.perf_counter() - t2
    within = {k: nums[k] <= lim for k, lim in cell["limits"].items()}
    ok = (counts["n_ternary"] == INVDIST_COUNTS["n_ternary"]
          and counts["n_pairs"] == INVDIST_COUNTS["n_pairs"]
          and excess <= 0.0 and slot["same_bits"] and launches == {"slot_sums": n_it}
          and invdist_launches == {k: 3 + n_it for k in invdist_launches}
          and all(within.values()))
    _line("sim3-invdist-venice", ok, time.perf_counter() - t0, counts=counts, setup_s=setup_s,
          slot_sums=slot, layer_device_ms=layers, idle_pct=view.idle_pct(),
          lm_iters_per_s=rate, iterations=n_it, slot_launches=launches,
          invdist_launches=invdist_launches,
          memory_peak_bytes=peak, checks=nums,
          limits=cell["limits"], within=within, reference=ref_mod.summary(ref),
          reference_s=reference_s)
    if not ok:
        raise Failure("sim3-invdist-venice")
    del ref, out
    torch.cuda.empty_cache()


# the distributed phases.  dist-gn: chi2 at each step's input within 1e-6 of
# JAX's distributed_gn_step on a 1-device CPU mesh and after the last step
# within 1e-8; manhattan3500's H has condition number ~7.6e12 (the eigen
# phase), so the f64 Cholesky's rounding moves the intermediate states:
# the port on the CPU reads 9.6e-8 from JAX after the first step, the card
# 3.0e-7, and both meet JAX's optimum to 1e-15; JAX's own chi2 there moves
# 1.9e-8 to 1.1e-7 when its start states are scaled by 1 + 1e-15 N(0, 1)
# (tests/_torch_jax_util.py --dist-sensitivity, 3 seeds).  dist-ba-venice: against JAX's f64 BigBASolver (the same math and
# LM loop: TOL_BA's f64 bound) and within 1e-8 of this run's own
# ba-venice-f64; the 2-rank run within 1e-9 of the 1-rank one (only the
# reduction's summation order differs).  dist-marginals: the landmark
# blocks within 1e-8 of the largest landmark entry; the camera blocks, the
# diagonal of SC^-1 with SC's condition number 5.4e9 at alpha 1e-2
# (cond * eps = 6e-7), within 1e-6 of the largest camera entry (the port
# reads 1.4e-7 on the CPU; JAX's own move 5.8e-8 to 9.5e-8 under the same
# start noise, its landmark blocks 6e-11 to 1.2e-10).  The chunk eliminations against NumPy within
# 1e-10
TOL_DIST = {"dist-gn": 1e-6, "dist-gn-final": 1e-8, "dist-ba-venice": 1e-6,
            "dist-ba-venice-own": 1e-8, "dist-ba-venice-2": 1e-9, "dist-marginals-cam": 1e-6,
            "dist-marginals-lm": 1e-8, "dist-chunks": 1e-10}


def _dist_phases(dev) -> dict:
    """The multi-rank phases (apps/distributed, graft_entry), each rank a
    spawned process on this card: NCCL at one rank, gloo for two ranks on
    the one card.  Returns each phase's kernel launches (counted in its
    ranks)."""
    import numpy as np
    import torch

    from slampp_tpu_torch import graft_entry
    from slampp_tpu_torch.apps import distributed as ad

    torch.cuda.empty_cache()  # the ranks are processes of their own on this card
    launches = {}

    def none_launched(phase, res):
        launches[phase] = {k: res["launches"].get(k, 0) for k in REPLACES}
        return not any(launches[phase].values())

    ref = JAX_REF["dist-gn"]
    t0 = time.perf_counter()
    res = ad.run_dist_gn(3500, 1, "nccl", dev, timeout_s=300)
    states = res.pop("states")
    rel = [abs(a - b) / b for a, b in zip(res["chi2"] + [res["chi2_final"]],
                                          ref["chi2"] + [ref["chi2_final"]])]
    ok = (max(rel[:-1]) <= TOL_DIST["dist-gn"] and rel[-1] <= TOL_DIST["dist-gn-final"]
          and res["backend"] == "nccl"
          and all(bool(np.isfinite(v).all()) for v in states.values()))
    _line("dist-gn", none_launched("dist-gn", res) and ok, time.perf_counter() - t0, reference=ref,
          rel_err=rel, tol=[TOL_DIST["dist-gn"], TOL_DIST["dist-gn-final"]], **res)

    # one scene for both venice phases
    t0 = time.perf_counter()
    scene = tuple(ad.venice_scene(871, 110_000, 10))
    t_gen = time.perf_counter() - t0
    ref, own = JAX_REF["ba-venice-f64"], RESULTS["ba-venice-f64"]["chi2_final"]
    res = ad.run_dist_venice(world=1, backend="nccl", device=dev, scene=scene, timeout_s=300)
    res["t_generate_s"] = t_gen
    rel = abs(res["chi2_final"] - ref["chi2_final"]) / ref["chi2_final"]
    rel_own = abs(res["chi2_final"] - own) / own
    ok = (rel <= TOL_DIST["dist-ba-venice"] and rel_own <= TOL_DIST["dist-ba-venice-own"]
          and res["lm_accepted"] == ref["lm_accepted"] and res["n_obs"] == ref["n_obs"]
          and abs(res["chi2_init"] - ref["chi2_init"]) <= 1e-9 * ref["chi2_init"]
          and res["backend"] == "nccl" and res["p2c_launches"]["p2c_linearize"] > 0)
    _line("dist-ba-venice", none_launched("dist-ba-venice", res) and ok,
          time.perf_counter() - t0, reference=ref, rel_err=rel, rel_err_own=rel_own,
          chi2_own=own, tol=TOL_DIST["dist-ba-venice"], **res)
    one = res

    t0 = time.perf_counter()
    res = ad.run_dist_venice(world=2, backend="gloo", device=dev, scene=scene, timeout_s=400)
    rel = abs(res["chi2_final"] - one["chi2_final"]) / one["chi2_final"]
    ok = (rel <= TOL_DIST["dist-ba-venice-2"] and res["lm_accepted"] == one["lm_accepted"]
          and res["world"] == 2 and res["backend"] == "gloo"
          and all(d.startswith("cuda") for d in res["rank_devices"]))
    _line("dist-ba-venice-2", none_launched("dist-ba-venice-2", res) and ok,
          time.perf_counter() - t0, rel_err_vs_world1=rel, tol=TOL_DIST["dist-ba-venice-2"],
          **res)
    del scene

    ref = JAX_REF["dist-marginals"]
    t0 = time.perf_counter()
    res = ad.run_dist_marginals(871, 30_000, 10, 1, "nccl", dev, alpha=ref["alpha"],
                                timeout_s=300)
    got = ad.marginals_summary(res.pop("cam_cov"), res.pop("lm_cov"))
    # blocks and their combinations over the largest camera / landmark
    # entry; the largest entries and the trace sums relative
    rel = {}
    for k, v in got.items():
        scale = ref["cam_max" if k.startswith("cam") else "lm_max"]
        if isinstance(v, dict):
            for i, blk in v.items():
                rel[f"{k}[{i}]"] = float(np.abs(np.asarray(blk) - ref[k][i]).max() / scale)
        elif isinstance(v, list):
            rel[k] = float(np.abs(np.asarray(v) - ref[k]).max() / scale)
        else:
            rel[k] = abs(v - ref[k]) / abs(ref[k])
    tol = {k: TOL_DIST["dist-marginals-" + k[:k.index("_")]] for k in rel}
    ok = (all(rel[k] <= tol[k] for k in rel) and res["n_points"] == ref["n_points"]
          and bool(np.isfinite(got["cam_trace"]) and np.isfinite(got["lm_trace"])))
    _line("dist-marginals", none_launched("dist-marginals", res) and ok,
          time.perf_counter() - t0, rel_err=rel, tol=tol,
          cam_trace=got["cam_trace"], lm_trace=got["lm_trace"], **res)

    t0 = time.perf_counter()
    runs = {f"{backend}-{world}": ad.run_dist_chunks(64, 96, world, backend, dev, timeout_s=120)
            for world, backend in ((1, "nccl"), (2, "gloo"))}
    ok = all(r["finite"] and max(r["err_sc"], r["err_rhs"]) <= TOL_DIST["dist-chunks"]
             and all(d.startswith("cuda") for d in r["rank_devices"]) for r in runs.values())
    _line("dist-chunks", ok, time.perf_counter() - t0, tol=TOL_DIST["dist-chunks"], runs=runs)

    t0 = time.perf_counter()
    runs = {f"{backend}-{world}": graft_entry.dryrun_multichip(world, backend, dev, timeout_s=180)
            for world, backend in ((1, "nccl"), (2, "gloo"))}
    _line("dryrun-multichip", all(d.startswith("cuda") for r in runs.values() for d in
                                  (x["device"] for x in r)), time.perf_counter() - t0, runs=runs)
    return launches


def _cli(argv, workdir):
    """The port's CLI, ``main(argv)`` in-process in ``workdir``: (return
    code, its stdout lines, the --json line)."""
    import contextlib
    import io

    from slampp_tpu_torch.apps.main import main as cli_main

    out = io.StringIO()
    with contextlib.chdir(workdir), contextlib.redirect_stdout(out):
        rc = cli_main(list(argv))
    lines = out.getvalue().splitlines()
    return rc, lines, json.loads(lines[-1])


def _cli_phases(dev) -> dict:
    """The CLI phases, each in a temporary directory of its own with its g2o
    text written there, launches counted from zero over the phase; returns
    cli-city's launches per iteration."""
    import tempfile

    import numpy as np
    import scipy.io

    from slampp_tpu_torch.apps import regression
    from slampp_tpu_torch.examples import ba_interface_example, simple_example
    from slampp_tpu_torch.io import datasets
    from slampp_tpu_torch.ops import dense_kernels as dk

    def rel(a, b):
        return abs(a - b) / abs(b)

    def timings(res, lines):
        return {"t_parse": res["t_parse"], "t_build": res["t_build"], "t_solve": res["t_solve"],
                "phases": res["phases"], "printed": [ln for ln in lines if ln.startswith(
                    ("done.", "denormalized", "system matrix"))]}

    per_iter = {}
    # cli-gn: batch GN (native v1) with the marginals and the matrix dump
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = os.path.join(d, "manhattan3500.g2o")
        with open(path, "w") as f:
            f.write(datasets.make_manhattan(n_poses=3500, loop_prob=0.1, seed=0)[0])
        t_gen = time.perf_counter() - t0
        dk.reset_launches()
        rc, lines, res = _cli(["-i", path, "--json", "-dm", "-dsm", "-ns", "-nb"], d)
        launches = dict(dk.launches)
        expected, iters_ref = JAX_REF["gn"]
        H = scipy.io.mmread(os.path.join(d, "system.mtx"))
        marg = np.loadtxt(os.path.join(d, "marginals.txt"))
        err = rel(res["chi2"], expected)
        ok = (rc == 0 and err <= TOL_CLI["cli-gn"] and res["iterations"] == iters_ref
              and res["solver"] == "lambda" and res["problem"] == "se2"
              and H.shape == (10500, 10500) and marg.shape == (3500, 3)
              and bool(np.isfinite(marg).all() and (marg > 0).all()))
        _line("cli-gn", ok, time.perf_counter() - t0, expected=expected, rel_err=err,
              tol=TOL_CLI["cli-gn"], iterations=res["iterations"], iterations_ref=iters_ref,
              system_mtx=list(H.shape), system_mtx_nnz=int(H.nnz), marginals_rows=marg.shape[0],
              t_generate_s=t_gen, launches=launches, **timings(res, lines))

    # cli-city: dogleg "auto" on cityTrees10k, the sparse Schur engine and
    # its v3 pose solve through the three kernels
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = os.path.join(d, "cityTrees10k.g2o")
        with open(path, "w") as f:
            f.write(datasets.make_city_trees(n_poses=10000, n_landmarks=100, seed=0)[0])
        t_gen = time.perf_counter() - t0
        dk.reset_launches()
        rc, lines, res = _cli(["-i", path, "-nls", "lambda-dl", "--json", "-ns", "-nb"], d)
        launches = dict(dk.launches)
        shapes = sorted(dk.launch_shapes, key=lambda x: (x[0], x[1], x[2], x[3] or 0))
        expected, iters_ref = JAX_REF["city-schur-sparse"]
        err = rel(res["chi2"], expected)
        ok = (rc == 0 and err <= TOL_CLI["cli-city"] and res["iterations"] == iters_ref
              and res["solver"] == "lambda-dl"
              and any(k.startswith("schur_sparse") for k in res["phases"])
              and all(v > 0 for v in launches.values()) and set(map(tuple, shapes)) <= CHECKED)
        per_iter["cli-city"] = {k: v / max(res["iterations"], 1) for k, v in launches.items()}
        _line("cli-city", ok, time.perf_counter() - t0, expected=expected, rel_err=err,
              tol=TOL_CLI["cli-city"], iterations=res["iterations"], iterations_ref=iters_ref,
              t_generate_s=t_gen, launches=launches, kernel_shapes=shapes, **timings(res, lines))

    # cli-inc-ba: LM at every CONSISTENCY_MARKER, then the final optimize
    ref = JAX_REF["cli-inc-ba"]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = os.path.join(d, "inc_ba.g2o")
        with open(path, "w") as f:
            f.write(datasets.make_ba_scene_incremental(n_cams=6, n_points=50, obs_per_point=4,
                                                       seed=1)[0])
        dk.reset_launches()
        rc, lines, res = _cli(["-i", path, "-nsp", "1", "-mnsi", "2", "--json", "-ns", "-nb",
                               "--no-detailed-timing"], d)
        err = rel(res["chi2"], ref["chi2"])
        ok = rc == 0 and err <= TOL_CLI["cli-inc-ba"] and all(
            res[k] == ref[k] for k in ("problem", "solver", "iterations", "incremental_solves"))
        _line("cli-inc-ba", ok, time.perf_counter() - t0, reference=ref, rel_err=err,
              tol=TOL_CLI["cli-inc-ba"], launches=dict(dk.launches), **timings(res, lines))

    t0 = time.perf_counter()
    dk.reset_launches()
    res = regression.run(dev)
    _line("regression", all(r["ok"] for r in res.values()), time.perf_counter() - t0,
          tol=regression.TOL_CHI2, launches=dict(dk.launches),
          cases={k: {f: r[f] for f in ("md5_ok", "chi2", "chi2_rel_err", "iterations")}
                 for k, r in res.items()})

    for name, module in (("simple_example", simple_example),
                         ("ba_interface_example", ba_interface_example)):
        import contextlib
        import io

        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            ret = module.main(["--device", "cuda"])
        chi2 = ret if name == "simple_example" else ret.chi2()
        expected = JAX_REF["examples"][name]
        err = rel(chi2, expected)
        _line(f"examples-{name}", err <= TOL_CLI["examples"] and math.isfinite(chi2),
              time.perf_counter() - t0, chi2=chi2, expected=expected, rel_err=err,
              tol=TOL_CLI["examples"], printed=out.getvalue().splitlines()[-3:])
    return per_iter


def _kernel_bench(summary, path="kernel_bench.csv") -> None:
    """kernel_bench.csv (the CLI's -rmb): every timed case of the kernel
    phase, device ms and the library's device ms beside the bound."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["kernel", "shape", "dtype", "device_ms", "library_ms", "bound_ms", "bound_by"])
        for name, v in summary.items():
            for sh in v["shapes"]:
                w.writerow([name, "x".join(str(x) for x in sh["shape"]), sh["dtype"],
                            sh["device_ms"], sh["library_device_ms"], sh["bound_ms"],
                            sh["bound_by"]])


def _incremental_phase(phase, engine, kw, counters, dev):
    """One incremental solver streamed over its graph and then
    optimized, against the JAX package's run; its kernel launches counted
    from zero.  Returns the launches per kernel-launching step: per v3 full
    solve while streaming, per final-optimize iteration, or per GN
    iteration for every-n."""
    from slampp_tpu_torch.apps import incremental
    from slampp_tpu_torch.ops import dense_kernels as dk

    ref = JAX_REF[phase]
    t0 = time.perf_counter()
    dk.reset_launches()
    res = incremental.run_incremental(ref["n_poses"], dev, engine, **kw)
    launches = dict(dk.launches)
    states = res.pop("states")
    rel = {k: abs(res[k] - ref[k]) / ref[k] for k in ("chi2_stream", "chi2_final")}
    ok = all(res["counters"][k] == ref[k] for k in counters) and _states_ok(states, ref["n_poses"])
    if phase == "fastl-se3":
        rel["n_relin"] = abs(res["counters"]["n_relin"] - ref["n_relin"]) / ref["n_relin"]
        tol = TOL_FASTL_SE3
        ok = ok and all(rel[k] <= v for k, v in tol.items())
        # what the gate does not hold, (port, JAX) side by side
        res["vs_jax"] = {"chi2_stream": [res["chi2_stream"], ref["chi2_stream"]],
                         "optimize_return": [res["optimize_return"], ref["optimize_return"]],
                         "n_relin": [res["counters"]["n_relin"], ref["n_relin"]]}
    else:
        tol = TOL_SOLVER_F64
        ok = (ok and all(v <= tol for v in rel.values())
              and res["optimize_return"] == ref["optimize_return"])
    f64_launched = {s[0] for s in res["kernel_shapes"] if s[4] == "float64"}
    if engine == "fastl":
        ok = (ok and all(v > 0 for v in res["launches_optimize"].values())
              and f64_launched == set(launches))
        per = {k: v / res["optimize_return"] for k, v in res["launches_optimize"].items()}
    elif phase == "windowed-v3":
        ok = (ok and res["full_solves"]["v3"] > 0 and res["full_solves"]["v3_fallback"] == 0
              and all(v > 0 for v in res["launches_stream"].values())
              and f64_launched == set(launches))
        per = {k: v / res["full_solves"]["v3"] for k, v in res["launches_stream"].items()}
    else:
        per = {k: v / res["counters"]["n_iterations"] for k, v in launches.items()}
    _line(phase, ok, time.perf_counter() - t0, rel_err=rel, tol=tol,
          reference=ref, launches=launches, **res)
    return per


def main(kernels_only: bool = False, invdist_only: bool = False) -> int:
    if not (ROOT / SOURCE).exists():
        print("FAIL: chip_smoke.py must run from a checkout of the repository", flush=True)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    # 1. device
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("[device] FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    dev = torch.device("cuda")
    smi = _smi()
    _line("device", True, time.perf_counter() - t0, name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda)

    # 2. build
    from slampp_tpu_torch.ops import _cuda, dense_kernels as dk

    t0 = time.perf_counter()
    _cuda.load()
    regs = [ln.strip() for ln in _cuda.build_info["log"].splitlines() if "registers" in ln]
    _line("build", True, time.perf_counter() - t0, nvcc_s=_cuda.build_info["seconds"],
          library=_cuda.build_info["path"], ptxas=regs)

    if invdist_only:
        _sim3_invdist_phase(dev)
        return 0

    # 3. kernels against their plain versions
    summary = _check_kernels(dev)
    _trsm_graph(dev)
    _chol_graph(dev)
    _check_ba_kernels(dev, summary)
    _check_sim3_kernels(dev, summary)
    _check_schur_kernel(dev, summary)
    if kernels_only:
        _kernel_bench(summary)
        print(json.dumps({"seconds": time.perf_counter() - T_START,
                          "kernel_bench": os.path.abspath("kernel_bench.csv")}), flush=True)
        return 0

    from slampp_tpu_torch.apps import manhattan

    # 4. main path: launch counts read from this run only
    dk.reset_launches()
    main = _run_path("main", manhattan.run, dev, 3500, CHI2_3500, TOL_3500)
    launches = dict(dk.launches)
    _line("launches", all(v > 0 for v in launches.values()), 0.0, **launches)

    # 5. dense frames on the same graph: (55, 192, 192) part frames + separator
    dense = _run_path("dense", manhattan.run, dev, 3500, CHI2_3500, TOL_3500, dense_frames=True,
                      n_rep=2)
    calls = dense["n_iters"] * (1 + dense["n_rep"])
    _line("dense-launches",
          dense["plan"]["K"] == 55 and dense["launches"]["chol_batched"] == 2 * calls, 0.0,
          plan=dense["plan"], launches=dense["launches"])

    # 6. exact float64 mode
    _run_path("exact", manhattan.run, dev, 500, CHI2_500, TOL_500, mixed_precision=False, n_rep=2)

    # 7-12. the batch solvers and the prior step, launches per iteration
    iters = main["n_iters"] * (1 + main["n_rep"])  # GN iterations in the main phase
    per_iter = {"main": {k: v / iters for k, v in launches.items()}}
    for phase, nls, engine in SOLVER_PHASES:
        per_iter[phase] = _solver_phase(phase, nls, engine, dev)
    per_iter["prior"] = _prior_phase(dev)

    # the native engines, the marginals and the eigenvalue analysis
    _native_phase(dev)
    _marginals_phase(dev)
    per_iter["eigen"] = _eigen_phase(dev)

    # the SE(3) sphere graph and the robust losses
    per_iter.update(_sphere_phases(dev))

    # bundle adjustment: venice871 class, the Schur engines, cityTrees10k
    per_iter.update(_ba_phases(dev))

    # Sim(3) bundle adjustment at venice871 scale, ROCV, Spheron, A, SPCG
    per_iter.update(_sim3_phases(dev))
    _sim3_invdist_phase(dev)

    # the slam_plus_plus CLI as a user runs it, the regression goldens, two
    # examples
    per_iter.update(_cli_phases(dev))

    # the multi-rank paths: NCCL at one rank, two gloo ranks on this card
    per_iter.update(_dist_phases(dev))

    # 13-15. the incremental solvers, in a child process of their own
    per_iter.update(_incremental_child())

    print(json.dumps({"seconds": time.perf_counter() - T_START}))
    print(json.dumps({"main_path": {
        "metric": "manhattan3500_gn_iters_per_sec", "value": main["iters_per_sec"],
        "chi2_final": main["chi2_final"], "chi2_ok": True, "card": smi}}))
    print(json.dumps({"kernels": _kernel_summary(summary, launches, iters, per_iter)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _kernel_summary(summary, launches, iters, per_iter) -> list:
    """The closing kernel summary: each kernel's timed cases (``summary``)
    with its launches on the main path (``launches`` over ``iters``) and
    per iteration of each phase (``per_iter``); the BA reprojection
    kernel's launches in the ba-venice phases, the Sim(3) edge kernel's and
    the slot-sum kernel's in the sim3-venice phases' LM loops (a solve
    each)."""
    out = []
    for k, v in summary.items():
        if k in REPLACES:
            out.append({"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
                        "launches": launches[k], "launches_per_iter": launches[k] / iters,
                        "launches_per_iter_by_phase": {ph: d[k] for ph, d in per_iter.items()},
                        **v})
        else:
            source, replaces, phases, key = FUSED[k.rsplit("_", 1)[0]]
            out.append({"name": k, "route": "cuda", "source": source, "replaces": replaces,
                        "launches_by_phase": {ph: RESULTS[ph][key][k] for ph in phases}, **v})
    return out


def _incremental_child() -> dict:
    """Phases 13-15 in a child process (``chip_smoke.py --incremental``), so
    that their one-thread BLAS and OpenMP leave the earlier phases' threads
    as they were.  Passes the child's phase lines through and returns its
    launches per step by phase."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--incremental"],
                         stdout=subprocess.PIPE, text=True, timeout=900)
    lines = out.stdout.splitlines()
    for ln in lines[:-1]:
        print(ln, flush=True)
    if out.returncode != 0 or not lines:
        print(lines[-1] if lines else "", flush=True)
        raise Failure("incremental")
    return json.loads(lines[-1])["per_iter"]


def incremental_main() -> int:
    """Phases 13-15 alone (the child of ``main``); prints one line per phase,
    then ``{"per_iter": {...}}``."""
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("[incremental] FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    dev = torch.device("cuda")
    per_iter = {phase: _incremental_phase(phase, engine, kw, counters, dev)
                for phase, engine, kw, counters in INC_PHASES}
    print(json.dumps({"per_iter": per_iter}), flush=True)
    return 0


if __name__ == "__main__":
    entry = main
    if sys.argv[1:] == ["--kernels"]:
        entry = lambda: main(kernels_only=True)  # noqa: E731
    if sys.argv[1:] == ["--sim3-invdist"]:
        entry = lambda: main(invdist_only=True)  # noqa: E731
    if sys.argv[1:] == ["--incremental"]:
        # the incremental solvers' host path is many small LAPACK calls,
        # which threaded OpenBLAS slows down: one thread, set before the
        # first import of numpy or torch, as bench.py does
        os.environ["OPENBLAS_NUM_THREADS"] = "1"
        os.environ["OMP_NUM_THREADS"] = "1"
        entry = incremental_main
    try:
        sys.exit(entry())
    except Failure as exc:
        print(f"chip_smoke: phase {exc} failed", file=sys.stderr)
        sys.exit(1)
