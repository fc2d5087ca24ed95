#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py            # every phase, one GPU, a few minutes

Drives ``blf_tpu_torch`` only (nothing of JAX). It builds the CUDA kernels from
the sources in this checkout (all at once, one ``nvcc`` each), holds each
kernel against its plain PyTorch version on the card, and runs the port's two
paths through the entry points a user calls:

* the warm-started push-recovery fleet tick at batch 98304, horizon 32, 50
  ADMM iterations, float32, ``backend="cuda"`` (kernel ``admm_stage``), and
  the same tick in bench.py's own mode, ``backend="cuda_delta"`` (kernel
  ``admm_stage_tc``, the tensor-core form of the stage's bf16 modes), held to
  its plain version and to ``"cuda"`` one tick from the same state;
* the 100 Hz whole-body-control loop of the 23-DoF humanoid over a fleet of
  4096 lanes, 30 ticks, 150 iterations in stages of 25, float32,
  ``solve_qp(backend="cuda")`` (kernels ``admm_lane_stage`` and
  ``cholesky_inverse_lane``, six launches of each a tick);
* the whole control stack (DCM-MPC, whole-body QP, stiff ROS2-W plant,
  momentum observer and RLS) over a push-recovery fleet of 4096 humanoids,
  10 outer ticks of 10 inner ticks in the ``STACK_R05`` configuration (the
  MPC ``"cuda_delta"``, as ``STACK_r05.json`` recorded it: kernel
  ``admm_stage_tc`` at (48, 32); the WBC ``"cuda"``: ``admm_lane_stage``,
  ``cholesky_inverse_lane`` at n = 64 and 29, ``cholesky_solve_lane``), and on
  256 lanes the stiff plant against 40-substep RK4 and the MPC's backends
  against each other from the same warm state (``"cuda"`` on ``admm_stage``
  at (48, 32) against the plain-tensor one; ``"cuda_delta"`` against its
  plain version and against ``"cuda"``);
* BASELINE config 2 (kernel ``foot_rollout_fused``): the Monte-Carlo
  spring-damper foot rollout of 65536 lanes over 1000 Euler steps,
  ``foot_rollout(backend="cuda")``, one launch a rollout; and the contact
  identification of 65536 lanes, each with its own (k, b): the foot rolled
  out in 200 segments of 10 steps (one launch each), the wrench measured
  after each, and (k, b) identified by three forms of RLS.
* BASELINE config 3: the 10-step gait planned for 4096 initial DCMs on one
  shared QP of (960, 384), 100 iterations, float32: ``plan_gait(shared=True,
  backend="cuda")`` (kernel ``admm_stage_l2``, exact f32) and in bench.py's
  own mode, ``backend="cuda_delta"`` (kernel ``admm_stage_tc_l2``, the
  tensor-core stage past shared memory), ``"cuda_split"`` beside it.
* the time-varying DCM planner (BASELINE's north star): 4096 pushed initial
  DCMs planned over 28 knots by the batched SQP in float32 (no kernel of
  its own: the reference computes it with plain operations too), held to
  the reference tests' limits on every lane and to a float64 plan on the
  CPU; its parallel backward pass and ``solve_lqr`` in both forms beside it.
* checkpoint and resume of the fleet tick at full width
  (examples/05_fleet_sweep.py's check, bitwise).
* the multi-device paths on a world of one nccl rank (one GPU holds one):
  the fleet tick through ``make_fleet_step(mesh=make_mesh())`` with a
  disturbance ensemble of 2 members folded into one solve of 196608 lanes
  (kernel ``admm_stage_tc``, ``"cuda_delta"``), held to the K = 1 tick; the
  row-sharded QP, the horizon-sharded LQR, the stream-sharded RLS and a
  one-stage pipeline against their single-device forms.
* ``python -m blf_tpu_torch.utils.profiling``'s speed-of-light table: the DCM
  QP's factorization, K1 in its three modes at horizons 16 and 32 over 98304
  lanes and 50 iterations a launch, the factored solve in ``"cuda_delta"``,
  and the foot rollout of 16384 lanes over 200 steps on both backends, each
  scored against the card's roofline.

It checks each result and shows that each path went through its kernels by
their launch counts, set to 0 just before the path and read just after. Each
phase prints one JSON line; no phase's failure is caught, so any exception or
failed check ends the run with a non-zero exit code. The last JSON line but
one lists every kernel at the shape of each path, with its launches there.

Each kernel's bound is its cost model in ``blf_tpu_torch/utils/profiling.py``
at the detected card's ceilings (``detect_chip``: on the H100 SXM, NVIDIA's
data sheet, 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s bf16
dense on them, 3.35 TB/s device memory), labelled so. Phase ``sol`` prints
that module's speed-of-light table of the port's hot programs.

The sizes are fixed (the constants below): a run at another width would prove
nothing about the port. ``--phases`` runs a subset while developing (and then
exits 4: a partial run is never a pass); ``--profile`` and
``--study-factorization`` add diagnostics to the full run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

import blf_tpu_torch.mpc.dcm as dcm_module
import blf_tpu_torch.mpc.qp as qp_module
import blf_tpu_torch.mpc.sqp as sqp_module
import blf_tpu_torch.mpc.stack as stack_module
from blf_tpu_torch.models import rigid_body as rb
from blf_tpu_torch.models.contact import ContactState, contact_wrench
from blf_tpu_torch.models.foot import foot_rollout
from blf_tpu_torch.models.kinematics import forward_kinematics
from blf_tpu_torch.mpc.dcm import build_dcm_qp
from blf_tpu_torch.mpc.dcm_planner import DCMPlannerLimits, plan_time_varying_dcm_batch
from blf_tpu_torch.mpc.riccati import LQRSolution, solve_lqr
from blf_tpu_torch.mpc.sqp import SQPConfig
from blf_tpu_torch.mpc.qp import SharedQPFactors, factor_shared_qp, solve_qp, solve_qp_lanes
from blf_tpu_torch.mpc.wholebody import build_wholebody_qp
from blf_tpu_torch.ops.cuda import _build
from blf_tpu_torch.ops.cuda import admm as admm_kernel
from blf_tpu_torch.ops.cuda import admm_lane as lane_kernel
from blf_tpu_torch.ops.cuda import linalg as chol_kernel
from blf_tpu_torch.ops.cuda import rollout as rollout_kernel
from blf_tpu_torch.parallel.sweep import init_fleet, make_fleet_step
from blf_tpu_torch.problems import WBC_CHECK_EVERY as WBC_STAGE
from blf_tpu_torch.problems import WBC_ITERATIONS as WBC_ITERS
from blf_tpu_torch import native
from blf_tpu_torch.convert import lipm_params_from_numpy
from blf_tpu_torch.planners.contacts import lower_contact_schedule
from blf_tpu_torch.planners.gait import (footstep_plan, gait_horizon, gait_references,
                                         plan_gait, support_polygons)
from blf_tpu_torch.problems import (GAIT_ITERATIONS, IDENTIFY_PARTS, IDENTIFY_STEPS_PER_SAMPLE,
                                    STACK_R05, apply_solution, balance_task,
                                    contact_identification_fleet, dcm_planner_fleet,
                                    foot_drop_fleet, gait_fleet, identify_contacts,
                                    push_recovery_stack, random_lqr_batch, stack_fleet_step,
                                    standing_fleet, stationary_push_recovery, wbc_balance_step)
from blf_tpu_torch.utils.checkpoint import checkpoint_step, load_checkpoint, save_checkpoint
from blf_tpu_torch.utils.containers import tree_leaves
from blf_tpu_torch.utils.status import SolverStatus, status_counts
from blf_tpu_torch.utils import profiling
from blf_tpu_torch.utils.profiling import FOOT_OPS_PER_LANE_STEP
from blf_tpu_torch.utils.telemetry import TelemetryStream

# the card's roofline ceilings, which every bound below divides by
SPEC = profiling.detect_chip()

BATCH = 98304     # lanes of the fleet
TICKS = 20        # ticks per scan
SCANS = 3         # timed scans, after one warm-up scan
SEED = 0          # of the numpy generator that draws the disturbances
CROSS_LANES = 4096
CROSS_TICKS = 10
STUDY_LANES = 16384
HORIZON = 32
M, N = 6 * HORIZON, 4 * HORIZON          # (192, 128)
STAGE_ITERS = 25
ALPHA = 1.6
REL_TOL = 1e-5   # f32, other summation order and FMA contraction than the plain version
# admm_lane_stage on the whole-body loop's own operators: K^-1 of an
# equality-stiffened KKT matrix amplifies the rounding of Kinv (A'w - q), so
# two float32 evaluation orders differ by more than on drawn operators; each
# is then also held to the float64 recursion on the same float32 inputs
REAL_OPERATOR_TOL = 1e-4
# phase `cross`: absolute, in the plan's metres (and the duals' units)
SAME_STATE_TOL = 1e-5     # one tick from the same state: every tick, every lane;
#                           independent fleets: every tick outside PARTED_TICKS
PARTED_TICKS = range(4, 10)   # independent fleets part here (a few lanes miss eps)
PARTED_TOL = 5e-4             # ... by no more than this, on every lane
PARTED_SHARE = 0.01           # ... with at most this share of lanes unconverged
# the whole-body-control loop: 23-DoF humanoid, two soles
WBC_LANES = 4096
WBC_SCANS, WBC_TICKS = 3, 10          # 30 ticks at 100 Hz, timed in 3 scans
# (150 iterations in stages of 25: WBC_ITERS and WBC_STAGE are the loop's own)
WBC_EPS = 1e-4                        # the float32 tolerance of the control stack
WBC_M, WBC_N = 86, 64                 # rows and unknowns of the whole-body QP
# float32 convergence of the loop, as both the port and the JAX package show it
# (the study in tests/test_torch_wbc_loop.py, 64 lanes on the CPU: every lane inside
# eps for the first 18 ticks, then the penalty multiplier sinks and 55 of 64
# lanes are left at tick 30): held to 99 % on ticks 1-15 and 80 % on tick 30
WBC_SETTLED_TICKS, WBC_SETTLED_SHARE, WBC_LAST_SHARE = 15, 0.99, 0.80
WBC_CROSS_LANES = 512
WBC_CROSS_TOL = 5e-3                  # absolute, on x: the float32 limit of the two paths
CHOL_SIZES = (1, 5, 29, 35, 64)        # 64: the loop's KKT; 29: the humanoid's mass matrix
# the control stack: 23-DoF humanoid, STACK_R05 (horizon 8, 10 inner ticks,
# MPC 100 iterations in stages of 25, WBC 150 in one stage)
STACK_LANES = 4096
STACK_WARM_TICKS, STACK_TIMED_TICKS = 5, 5            # 1 s of simulated time
STACK_M, STACK_N = 6 * STACK_R05.horizon, 4 * STACK_R05.horizon      # (48, 32)
STACK_MPC_STAGES = -(-STACK_R05.mpc_iterations // STAGE_ITERS)     # 4 K1 launches a tick
STACK_INNER = STACK_R05.wbc_per_mpc                                 # 10 inner ticks
NV = 29                                                             # the humanoid's nu
# 6: the stack's wrench attribution; N_REG and N_REG + 1: the last size solved
# one thread a matrix and the first one warp a matrix
SOLVE_SIZES = (1, 6, chol_kernel.SOLVE_N_REG, chol_kernel.SOLVE_N_REG + 1, 29)
SOLVE_RAW_LAUNCHES = 100              # raw launches between two events
SOLVE_HOST_CALLS = 400                # wrapper calls timed on the host clock
# the reference's contracts (tests/test_control_stack.py:129-141), every lane
STACK_UPRIGHT, STACK_TWIST, STACK_DCM = 0.98, 0.6, 0.06
STACK_EST_REL, STACK_EST_ABS = 0.3, 3.0
# float32 convergence of the stack as the port and the JAX package both show it
# (the study of tests/test_torch_stack.py run as a script, 64 lanes on the CPU:
# converged lanes by outer tick 0, 51, 64, 8, 64, 57-58, 64, 64, 56, 64 on both
# sides, the MPC every lane on every tick; what is lost is the WBC's all-ten-
# inner-ticks flag): the MPC held to 99 % on every tick, the stack's status to
# 99 % on the last tick and on at least STACK_SETTLED_TICKS of the ticks after
# the cold first one
STACK_CONVERGED_SHARE = 0.99
STACK_SETTLED_TICKS = 4
# the MPC runs the delta mode (STACK_r05.json: "pallas"): the float32 study at 256 lanes
# (tests/test_torch_stack.py as a script; PERF.md section 6) converged 256, 250, 256, 256,
# 255, 256, 256, 256, 256, 256 lanes by tick in the port, and blf_tpu's delta MPC run on
# the same inputs 256, 251, 256, 256, 256, 255, 256, 256, 256, 256: held to
# STACK_MPC_SHARE on every tick. On the last tick, the quality
# STACK_r05.json recorded (every WBC lane converged, max primal residual 1.4e-2, max dual
# 4.0e-4; the study 1.4e-2 and 3.9e-4 at 256 lanes), with room for 4096 lanes' maxima
STACK_MPC_SHARE = 0.95
STACK_LAST_RP, STACK_LAST_RD = 2e-2, 6e-4
STACK_CROSS_LANES, STACK_CROSS_TICKS = 256, 4
STACK_CROSS_DCM, STACK_CROSS_EST = 3e-3, 1.5     # tests/test_control_stack.py:292-346
STACK_PLAN_TOL = 1e-5
# stack_cross: the delta MPC's kernel against its plain version from the same warm state:
# the study's two float32 orders part by 2.0e-7 (plan) and 2.2e-5 (duals), on 9 of 256
# lanes' converged flag; against "cuda", the reference's contract of cross_delta
STACK_DELTA_TOL = 2e-4
STACK_DELTA_MISMATCH = 0.10
# BASELINE config 2: the foot rollout fleet (benchmarks/rollout_bench.py's workload)
FOOT_LANES, FOOT_STEPS = 65536, 1000
FOOT_RUNS = 7                         # timed rollouts, after one warm-up
FOOT_SETTLE_STEPS = 4000
FOOT_ODD_LANES = 65533
FOOT_CHECK_STEPS = (10, 300, 1000)   # the fleet still moving at 10 and 300, settled at 1000
FOOT_NAN_STEPS = 300
FOOT_TOL = 2e-5       # absolute, every field: the reference's own (tests/test_foot_rollout.py)
# the settled state the reference's test requires (tests/test_foot_rollout.py:47-62)
FOOT_SINK_TOL, FOOT_V_TOL, FOOT_W_TOL, FOOT_R_TOL = 1e-4, 1e-4, 1e-3, 1e-3
# the contact identification fleet (examples/02_contact_identification.py, batched)
IDENT_LANES, IDENT_SAMPLES = 65536, 200
IDENT_STEPS = IDENTIFY_STEPS_PER_SAMPLE   # Euler steps a sample, a kernel launch each
IDENT_CROSS_LANES = 256
IDENT_FORMS_TOL = 1e-4    # relative, per lane: rls_fit and rls_parallel against rls_scan
IDENT_CROSS_TOL = 1e-4    # relative, per lane: backend "cuda" against "torch"
# against the truth, every RLS form; from the float32 study of both packages on the CPU
# (tests/test_torch_identification.py run as a script, 4096 lanes: k within 1 % on
# 4092 lanes, b on 3989-3990, medians 1.24e-3 and 2.65e-3, max 1.31e-2 and 1.99e-2)
IDENT_SHARE_K, IDENT_SHARE_B = 0.995, 0.96      # lanes within 1 % of the truth
IDENT_MEDIAN_K, IDENT_MEDIAN_B = 2.5e-3, 5e-3   # median relative error
IDENT_MAX = 5e-2                                # max relative error, k and b
# BASELINE config 3: the 10-step gait over a fleet (problems.gait_fleet, plan_gait), and
# examples/03_full_gait.py's single plan; held to TestFullGait.test_ten_step_gait_plan's
# checks with its float32 limit on the ZMP margin
GAIT_LANES = 4096
GAIT_RUNS = 3                  # timed plans, after one warm-up
GAIT_CPU_LANES = 64            # lanes planned again in float64 on the CPU (the plain path)
GAIT_EXAMPLE_ITERS = 2000
GAIT_MARGIN_TOL = 5e-4
GAIT_FINAL_DCM, GAIT_FINAL_TOL = (0.75, 0.0), 0.02
GAIT_RMSE_TOL = 1e-3           # m, BASELINE config 1's acceptance limit on the DCM
# K1's streaming f32 kernel (csrc/admm_stage_l2.cu): the 10-step gait's shape, the
# 6-step gait's, and the fleet tick's transcription at horizon 40, the first shapes past
# the resident kernel's shared memory
L2_SHAPES = ((960, 384, "gait10"), (640, 256, "gait6"), (240, 160, "tick_h40"))
# the tensor-core kernel of K1's modes "split" and "delta" (csrc/admm_stage_tc.cu).
# Tolerances relative to the largest |entry|, from the CPU study of
# tests/test_torch_admm_stage_tc.py run as a script: the plain version in two float32
# summation orders, 4096 lanes (PERF.md section 6)
TC_MODES = ("split", "delta")
TC_BATCHES = (1, 1000, 4096, BATCH)
TC_SPLIT_TOL = 2e-4       # split, 25 iterations, and delta's 3-pass first: study 3.0e-5 at most
TC_STEP_TOL = 2e-2        # delta's first increment from the cold random iterate: study 3.9e-3
TC_WARM_TOL = 2e-4        # delta, 25 iterations on the fleet tick's own stages once it has
#                           settled (tick 10): study 1.0e-5
TC_WARM_TICK = 10
# the fleet tick in bench.py's own mode: on the cold first tick the delta mode leaves
# lanes above eps, in both packages alike (the study of tests/test_torch_admm_stage_tc.py,
# 4096 lanes on the CPU: blf_tpu 3937, the port 3934), so that tick is held to
# TICK_DELTA_FIRST_SHARE and to within TICK_DELTA_FIRST_SLACK of the lanes the same cold
# tick converges with the stage's plain version; every later tick to 99 %
TICK_DELTA_FIRST_SHARE = 0.95
TICK_DELTA_FIRST_SLACK = 0.005
# phase cross_delta: the kernel against the plain version from the same state; study:
# 1.6e-6 (plan), 6.1e-7 (dcm), 4.5e-5 (warm_y) at most, and on the cold first tick
# 238 of 4096 lanes of differing status (a flag at eps), none after
CROSS_DELTA_TOL = 2e-4                # absolute, every lane, every tick
CROSS_DELTA_FIRST_MISMATCH = 0.10     # share of lanes of differing status on tick 1
# ... and "cuda_delta" against "cuda": the reference's contract for the reduced modes
# (tests/test_pallas_admm.py:57-74: converged counts within 25 of 256, the plan within
# 5e-4 where both converged)
CROSS_F32_SHARE, CROSS_F32_TOL = 25 / 256, 5e-4
# K1's streaming tensor-core kernel (csrc/admm_stage_tc_l2.cu), modes "split" and "delta"
# at the shapes the resident one refuses: the 10-step gait's, the 6-step's and the 2-step's
# on their plans' own stages, the fleet tick's transcription at horizon 40 on stage_inputs,
# and two random shared QPs, one with n > m and one with m not a multiple of 16; held
# with the resident tensor-core kernel's limits (TC_*_TOL), "delta" on a warm stage (the
# gaits' last, the fleet tick's at TC_WARM_TICK, the last of a TC_SETTLE_ITERS-iteration
# exact solve of the random QPs) to TC_WARM_TOL
TC_L2_SHAPES = ((960, 384, "gait10"), (640, 256, "gait6"), (320, 128, "gait2"),
                (240, 160, "tick_h40"), (100, 150, "qp_n_gt_m"), (250, 97, "qp_m_odd"))
TC_SETTLE_ITERS = 400
# K1's f32 kernels at an n that is not a multiple of 4 (padded at the wrapper): the
# resident one and, past its shared memory, the streaming one; random shared QPs
F32_ODD_SHAPES = ((150, 97), (400, 201))
# config 3 in bench.py's own mode ("cuda_delta", the reference's "pallas") and in
# "cuda_split": the converged count within GAIT_DELTA_SLACK of the lanes the same plan
# converges with the stage's plain version on the card
GAIT_DELTA_SLACK = 0.005
# the time-varying DCM planner over a fleet (problems.dcm_planner_fleet: tests/test_sqp.py's
# push-recovery problem, 28 knots), float32, the planner's default SQPConfig(10, 5); held
# on every lane to tests/test_sqp.py's float32 limits (test_push_recovery_respects_polygons_
# and_terminal), to config 1's DCM RMSE against the port's own float64 plan of
# PLAN_CPU_LANES lanes on the CPU, and, at PLAN_PARALLEL_HORIZON, the parallel backward
# pass to the sequential one (TestParallelBackward's float32 limits and budget)
PLAN_LANES = 4096
PLAN_HORIZON = 30
PLAN_RUNS = 3                  # timed plans, after one warm-up
PLAN_CPU_LANES = 64
PLAN_VIOLATION_TOL = 2e-4      # max_violation and every ZMP's polygon margin
PLAN_FINAL_TOL = 2e-3          # final DCM against the goal, every component
PLAN_OMEGA_TOL = 5e-2          # |omega_T - omega_nom|
PLAN_PARALLEL_HORIZON = 16
PLAN_PARALLEL_SQP = dict(iterations=8, al_iterations=3, penalty_init=10.0)
PLAN_PARALLEL_TOL, PLAN_PARALLEL_VIOLATION_TOL = 5e-3, 5e-4
PLAN_SECONDS = 90              # the whole phase
# solve_lqr on random stable LQ problems of tests/test_riccati.py's shape (nx 4, nu 2),
# float32: sequential against parallel within that file's float32 tolerance
LQR_LANES, LQR_HORIZON, LQR_TOL = 4096, 32, 3e-4
# resume: examples/05_fleet_sweep.py's check on the card: 3 ticks, a checkpoint, 2 more;
# the checkpoint loaded onto the card and the same 2 ticks again, every leaf bitwise equal
RESUME_TICKS = (3, 2)
# mesh: the fleet tick of tick_delta through a device mesh (a world of one nccl rank) with a
# disturbance ensemble of MESH_K members folded into the lanes of one solve
MESH_K = 2
MESH_SAME_TOL = 1e-6            # relative: identical draws against the K = 1 tick
MESH_WARM_TICKS = 10            # ticks with MESH_K distinct draws, from the cold fleet
MESH_TIMED_TICKS = 5            # ticks timed in turns with the K = 1 tick
MESH_MARGIN_TOL = 1e-3          # worst ZMP margin, tests/test_sharding.py's limit
MESH_DCM_BOUND = 0.1            # |DCM| after the warm ticks, the same test's limit
MESH_NAN_LANE = 12345
MESH_QP_LANES, MESH_QP_ITERATIONS = 4096, 150
MESH_QP_TOL = 8e-3              # x, float32: tests/test_sharding.py's row-sharded QP limit
MESH_RLS_STEPS, MESH_RLS_LANES = 256, 4096
MESH_RLS_TOL = 1e-6             # relative: one shard runs rls_parallel's own scan
MESH_SECONDS = 90
# sol: python -m blf_tpu_torch.utils.profiling's table (profiling.sol_rows, the
# reference's rows and sizes); K1 runs at the DCM QP's shape of horizons 16 and 32
SOL_M, SOL_N = 6 * 16, 4 * 16                     # (96, 64)
SOL_ITERS = 50              # K1's iterations a launch in the table's stage rows
SOL_BATCHES = (1, 1000, BATCH)    # lanes of the table's stage inputs held to the plain version
SOL_FRAC_MAX = 1.05         # a row scored by a cost model may not pass its bound by more
SOL_SECONDS = 60
SOL_MATMUL = 4096           # sol_report's own check: a float32 matmul, TF32 off
# K1's resident kernels, f32 and tensor-core, are built at these shapes
RESIDENT_SHAPES = ((M, N, ""), (STACK_M, STACK_N, "_stack"), (SOL_M, SOL_N, "_sol"))
DEVICE = torch.device("cuda")
PHASES = ("device", "build", "kernels", "tick", "cross", "tick_delta", "cross_delta", "wbc",
          "wbc_cross", "stack", "stack_cross", "foot", "identify", "gait", "gait_delta",
          "dcm_planner", "resume", "mesh", "sol")


START = time.perf_counter()


def emit(phase: str, **fields) -> dict:
    """Print one phase's JSON line, with the seconds since the script began."""
    record = {"phase": phase, **fields, "at_s": round(time.perf_counter() - START, 1)}
    print(json.dumps(record), flush=True)
    return record


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def time_cuda(fn, warmup: int, reps: int) -> list:
    """Milliseconds of each of ``reps`` calls, by CUDA events."""
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
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device() -> dict:
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-2:]
    props = torch.cuda.get_device_properties(0)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return emit(
        "device", nvidia_smi=nvidia_smi_line(), sm_count=props.multi_processor_count,
        max_sm_clock_mhz=float(clock),
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=" | ".join(nvcc), numpy=np.__version__,
        capability=list(torch.cuda.get_device_capability(0)),
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def phase_build() -> dict:
    """Build every kernel library of both paths, one ``nvcc`` each, all
    started together; then load them through their wrappers."""
    jobs = [(f"admm_stage{tag}", admm_kernel.SOURCE, {"ADMM_M": m, "ADMM_N": n})
            for m, n, tag in RESIDENT_SHAPES]
    jobs += [("admm_lane", lane_kernel.SOURCE, {"ADMM_M": WBC_M, "ADMM_N": WBC_N})]
    jobs += [(f"admm_stage_tc_{mode}{tag}", admm_kernel.TC_SOURCE,
              admm_kernel.tc_defines(m, n, mode))
             for m, n, tag in RESIDENT_SHAPES for mode in TC_MODES]
    jobs += [(f"chol_lane_n{n}", chol_kernel.SOURCE, {"CHOL_N": n}) for n in CHOL_SIZES]
    jobs += [(f"chol_solve_n{n}", chol_kernel.SOLVE_SOURCE, {"CHOL_N": n})
             for n in SOLVE_SIZES]
    jobs += [("foot_rollout", rollout_kernel.SOURCE, {})]
    jobs += [(f"admm_stage_l2_{name}", admm_kernel.L2_SOURCE, {"ADMM_M": m, "ADMM_N": n})
             for m, n, name in L2_SHAPES + ((M, N, "tick"),)]
    jobs += [(f"admm_stage_tc_l2_{mode}_{name}", admm_kernel.TC_L2_SOURCE,
              admm_kernel.tc_l2_defines(m, n, mode))
             for m, n, name in TC_L2_SHAPES for mode in TC_MODES]
    odd = [(m, n + (-n % 4)) for m, n in F32_ODD_SHAPES]
    jobs += [(f"admm_stage{'_l2' if admm_kernel.streams_operator(m, n) else ''}_odd_{m}x{n}",
              admm_kernel.L2_SOURCE if admm_kernel.streams_operator(m, n) else admm_kernel.SOURCE,
              {"ADMM_M": m, "ADMM_N": n}) for m, n in odd]

    def build(job):
        t0 = time.perf_counter()
        _build.build_library(job[1], job[2])
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        seconds = list(pool.map(build, jobs))
    for m, n, _ in RESIDENT_SHAPES:
        admm_kernel.build_admm_stage(m, n)
        for mode in TC_MODES:
            admm_kernel.build_admm_stage_tc(m, n, mode)
    lane_kernel.build_admm_lane(WBC_M, WBC_N)
    for n in CHOL_SIZES:
        chol_kernel.build_chol_lane(n)
    for n in SOLVE_SIZES:
        chol_kernel.build_chol_solve(n)
    rollout_kernel.build_foot_rollout()
    for m, n, _ in L2_SHAPES + ((M, N, "tick"),):
        admm_kernel.build_admm_stage_l2(m, n)
    for m, n, _ in TC_L2_SHAPES:
        for mode in TC_MODES:
            admm_kernel.build_admm_stage_tc_l2(m, n, mode)
    for m, n in odd:
        (admm_kernel.build_admm_stage_l2 if admm_kernel.streams_operator(m, n)
         else admm_kernel.build_admm_stage)(m, n)
    wall = time.perf_counter() - t0
    shared = {"admm_lane": lane_kernel.lane_shared_bytes(WBC_M, WBC_N)}
    shared.update({f"admm_stage{tag}": admm_kernel.stage_shared_bytes(m, n)
                   for m, n, tag in RESIDENT_SHAPES})
    shared.update({f"admm_stage_tc_{mode}{tag}": admm_kernel.stage_tc_shared_bytes(m, n, mode)
                   for m, n, tag in RESIDENT_SHAPES for mode in TC_MODES})
    shared.update({f"chol_lane_n{n}": chol_kernel.inverse_shared_bytes(n)
                   for n in CHOL_SIZES})
    shared.update({f"chol_solve_n{n}": chol_kernel.solve_shared_bytes(n)
                   for n in SOLVE_SIZES})
    shared["foot_rollout"] = 0
    shared.update({f"admm_stage_l2_{name}": admm_kernel.stage_l2_shared_bytes(m, n)
                   for m, n, name in L2_SHAPES + ((M, N, "tick"),)})
    shared.update({f"admm_stage_tc_l2_{mode}_{name}":
                   admm_kernel.stage_tc_l2_shared_bytes(m, n, mode)
                   for m, n, name in TC_L2_SHAPES for mode in TC_MODES})
    shared.update({f"admm_stage{'_l2' if admm_kernel.streams_operator(m, n) else ''}_odd_{m}x{n}":
                   (admm_kernel.stage_l2_shared_bytes(m, n) if admm_kernel.streams_operator(m, n)
                    else admm_kernel.stage_shared_bytes(m, n)) for m, n in odd})
    libraries = []
    for (name, source, defines), sec in zip(jobs, seconds):
        log = _build.last_build_log(source, defines)
        libraries.append({
            "name": name, "source": "blf_tpu_torch/csrc/" + source, "defines": defines,
            "seconds": round(sec, 2), "shared_bytes": shared[name],
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]})
    return emit("build", seconds=round(wall, 2), libraries=libraries)


def stage_operators(problem):
    """(P, A, is_eq, factors) of the problem's transcription's shared operator
    (the production one at the tick's horizon)."""
    dcm0 = problem.dcm0[None, :]
    P, _, A, _, _ = build_dcm_qp(problem.params, problem.dt, dcm0, problem.dcm_ref,
                                 problem.zmp_ref, problem.poly_A, problem.poly_b)
    is_eq = torch.arange(A.shape[0], device=DEVICE) < 2 * problem.zmp_ref.shape[0]
    return P, A, is_eq, factor_shared_qp(P, A, is_eq)


def stage_inputs(problem, factors, B: int, seed: int):
    """Stage inputs at the shapes the tick gives the kernel (at the problem's
    horizon): scaled bounds of the transcription (polygon rows have l = -inf)
    for random initial DCMs, a random iterate, s spread over [1e-2, 1e2]."""
    rng = np.random.default_rng(seed)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
    dcm0 = as_t(rng.normal(0, 0.02, (B, 2)))
    _, q, _, l, u = build_dcm_qp(problem.params, problem.dt, dcm0, problem.dcm_ref,
                                 problem.zmp_ref, problem.poly_A, problem.poly_b)
    f = factors
    m, n = f.A_s.shape
    lb = (f.E * l).contiguous()
    ub = (f.E * u).contiguous()
    q = q + as_t(rng.normal(0, 0.05, (B, n)))
    gq = ((f.c * (q * f.D)) @ f.W).contiguous()
    v = as_t(rng.normal(0, 0.1, (B, m)))
    tau = torch.zeros((B, n), dtype=torch.float32, device=DEVICE)
    s = as_t(10.0 ** rng.uniform(-2, 2, (B, 1)))
    return v, tau, s, gq, lb, ub, f.G2.contiguous(), f.d, f.base_rho


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


F32_PEAK = f"{SPEC.peak_flops_f32 / 1e12:g} TFLOP/s f32"
BF16_PEAK = f"{SPEC.peak_flops_bf16 / 1e12:g} TFLOP/s bf16 dense"
HBM_RATE = f"{SPEC.hbm_bytes_per_s / 1e12:g} TB/s"


def bound_source(*peaks: str) -> str:
    return f"{SPEC.name} data sheet: " + ", ".join(peaks)


def fma_bound(cost: profiling.KernelCost) -> dict:
    """The least time in ms of a kernel on the FMA units: its cost model's
    float32 operations at the f32 peak against its bytes (each input read
    once, each output written once) at the memory rate."""
    units = cost.unit_seconds(SPEC)
    ops_ms, bytes_ms = 1e3 * units["fma"], 1e3 * units["memory"]
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
            "bound_source": bound_source(F32_PEAK, HBM_RATE)}


def f32_stage_bound(m: int, n: int, B: int, iters: int) -> dict:
    """The least time of an exact-f32 stage at (m, n, B, iters) on the FMA
    units, which csrc/admm_stage.cu uses (``profiling.admm_stage_cost``, mode
    "f32"). Beside it, the bound of the reference's own f32 algorithm on the
    tensor cores, 6 bf16 passes a product at the bf16 peak (PERF.md section 6:
    a kernel of them cost the fleet tick converged lanes, so the port runs
    none)."""
    return {**fma_bound(profiling.admm_stage_cost(B, m, n, iters, "f32")),
            "bound_six_pass_ms": 1e3 * iters * 2 * 6 * 2 * m * n * B / SPEC.peak_flops_bf16,
            "bound_source": bound_source(F32_PEAK, BF16_PEAK, HBM_RATE)}


def ptxas_residency(source: str, defines: dict) -> dict:
    """Registers a thread and spilled bytes ``nvcc -Xptxas -v`` reported."""
    log = _build.last_build_log(source, defines)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    check(bool(regs), f"the build log of {source} {defines} reports its registers")
    return {"registers": max(regs), "spill_bytes": ptxas_spill_bytes(source, defines)}


def kernels_admm_stage(problem) -> dict:
    """K1 against its plain version at the fleet tick's shapes."""
    batch = BATCH
    _, _, _, factors = stage_operators(problem)
    kw = dict(iters=STAGE_ITERS, alpha=ALPHA)
    cases = []
    max_rel = 0.0
    max_abs = 0.0
    for B in (4096, 1000, 1):
        args = stage_inputs(problem, factors, B, seed=B)
        check(bool(torch.isinf(args[4]).any()), "bounds include -inf rows")
        v_k, tau_k = admm_kernel.admm_stage(*args, **kw)
        torch.cuda.synchronize()
        v_p, tau_p = admm_kernel.admm_stage_reference(*args, **kw)
        check(bool(torch.isfinite(v_k).all() and torch.isfinite(tau_k).all()),
              f"kernel output finite at B={B}")
        ev, et = rel_err(v_k, v_p), rel_err(tau_k, tau_p)
        ea = max(float((v_k - v_p).abs().max()), float((tau_k - tau_p).abs().max()))
        cases.append({"B": B, "rel_err_v": ev, "rel_err_tau": et, "max_abs_err": ea})
        max_rel = max(max_rel, ev, et)
        max_abs = max(max_abs, ea)
        check(ev <= REL_TOL and et <= REL_TOL,
              f"kernel agrees with the plain version to {REL_TOL} at B={B}: v {ev}, tau {et}")

    # a poisoned lane stays non-finite and poisons no other lane, whether the
    # NaN enters through the iterate or through a bound
    B, lane = 1000, 137
    args = list(stage_inputs(problem, factors, B, seed=7))
    clean_v, clean_tau = admm_kernel.admm_stage(*args, **kw)
    others = torch.ones(B, dtype=torch.bool, device=DEVICE)
    others[lane] = False
    for where in ("v", "bounds"):
        bad = [a.clone() for a in args]
        if where == "v":
            bad[0][lane, 5] = float("nan")
        else:
            bad[4][lane, 0] = float("nan")
            bad[5][lane, 0] = float("nan")
        nan_v, nan_tau = admm_kernel.admm_stage(*bad, **kw)
        torch.cuda.synchronize()
        check(not bool(torch.isfinite(nan_v[lane]).all()),
              f"NaN in {where}: the lane's v is non-finite")
        check(not bool(torch.isfinite(nan_tau[lane]).all()),
              f"NaN in {where}: the lane's tau is non-finite")
        check(bool(torch.equal(nan_v[others], clean_v[others])
                   and torch.equal(nan_tau[others], clean_tau[others])),
              f"NaN in {where}: every other lane equals the clean run bit for bit")
        ref_v, _ = admm_kernel.admm_stage_reference(*bad, **kw)
        check(not bool(torch.isfinite(ref_v[lane]).all()),
              f"NaN in {where}: the plain version poisons the lane too")

    # the main path's own shape: compare once more, then time
    args = stage_inputs(problem, factors, batch, seed=1)
    v_k, tau_k = admm_kernel.admm_stage(*args, **kw)
    v_p, tau_p = admm_kernel.admm_stage_reference(*args, **kw)
    ev, et = rel_err(v_k, v_p), rel_err(tau_k, tau_p)
    ea = max(float((v_k - v_p).abs().max()), float((tau_k - tau_p).abs().max()))
    cases.append({"B": batch, "rel_err_v": ev, "rel_err_tau": et, "max_abs_err": ea})
    max_rel, max_abs = max(max_rel, ev, et), max(max_abs, ea)
    check(ev <= REL_TOL and et <= REL_TOL,
          f"kernel agrees with the plain version to {REL_TOL} at B={batch}: v {ev}, tau {et}")
    # the streaming kernel at this shape too, where admm_stage runs the resident one:
    # whether the resident kernel still earns its place beside it
    v_l, tau_l = l2_launch(args, kw)
    el = max(rel_err(v_l, v_p), rel_err(tau_l, tau_p))
    check(el <= REL_TOL, f"admm_stage_l2 at ({M}, {N}) agrees with the plain version to"
          f" {REL_TOL} at B={batch}: {el}")
    del v_k, tau_k, v_p, tau_p, v_l, tau_l
    kernel_ms = statistics.median(
        time_cuda(lambda: admm_kernel.admm_stage(*args, **kw), warmup=2, reps=7))
    plain_ms = statistics.median(
        time_cuda(lambda: admm_kernel.admm_stage_reference(*args, **kw),
                  warmup=1, reps=3))
    # in turns: resident (above), streaming, streaming, resident
    l2_ms = [median_ms(lambda: l2_launch(args, kw), 2, 7) for _ in range(2)]
    resident_again_ms = median_ms(lambda: admm_kernel.admm_stage(*args, **kw), 2, 7)
    bound = f32_stage_bound(M, N, batch, STAGE_ITERS)
    return {
        "name": "admm_stage", "shape": [M, N], "iters": STAGE_ITERS,
        "batch_timed": batch, "cases": cases, "nan_lane": "confined",
        **ptxas_residency(admm_kernel.SOURCE, {"ADMM_M": M, "ADMM_N": N}),
        "shared_bytes": admm_kernel.stage_shared_bytes(M, N),
        "max_rel_err": max_rel, "max_abs_err": max_abs, "tolerance_rel": REL_TOL,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, **bound,
        "fraction_of_bound": bound["bound_ms"] / kernel_ms,
        "tflops": STAGE_ITERS * 2 * (2 * M * N) * batch / (kernel_ms * 1e-3) / 1e12,
        "library_ms": None,
        "streaming_kernel_here": {
            "kernel": "admm_stage_l2", "rel_err": el, "kernel_ms_in_turns": l2_ms,
            "resident_ms_in_turns": [kernel_ms, resident_again_ms],
            "streaming_over_resident": statistics.median(l2_ms)
            / statistics.median([kernel_ms, resident_again_ms])},
    }


def l2_launch(args, kw):
    """K1's streaming kernel called through its library at a shape where
    ``admm_stage`` runs the resident one (so outside every count); returns
    ``(v, tau)``."""
    v, tau, s, gq, l, u, G2, d, rho = args
    (B, m), n = v.shape, G2.shape[1]
    check(G2.data_ptr() % 16 == 0 and gq.data_ptr() % 16 == 0, "G2 and gq 16-byte aligned")
    lib = admm_kernel.build_admm_stage_l2(m, n)
    v_out, tau_out = torch.empty_like(v), torch.empty_like(tau)
    code = lib.blf_admm_stage_l2(
        v.data_ptr(), s.data_ptr(), gq.data_ptr(), l.data_ptr(), u.data_ptr(),
        G2.data_ptr(), d.data_ptr(), rho.data_ptr(), v_out.data_ptr(), tau_out.data_ptr(),
        B, m, n, int(kw["iters"]), float(kw["alpha"]), torch.cuda.current_stream().cuda_stream)
    check(code == 0, f"admm_stage_l2 launched at ({m}, {n}): {code}")
    return v_out, tau_out


def median_ms(fn, warmup: int, reps: int) -> float:
    return statistics.median(time_cuda(fn, warmup=warmup, reps=reps))


def ptxas_spill_bytes(source: str, defines: dict) -> int:
    """Bytes of spill stores ``nvcc -Xptxas -v`` reported for the library."""
    spills = re.findall(r"(\d+) bytes spill stores", _build.last_build_log(source, defines))
    check(bool(spills), f"the build log of {source} {defines} reports its spills")
    return max(int(b) for b in spills)


def wbc_step(fleet, state, warm):
    return wbc_balance_step(fleet, state, warm, backend="cuda", eps=WBC_EPS)


def capture_wbc_stage_inputs(lanes: int):
    """What ``solve_qp_lanes`` hands the two kernel wrappers on the first tick
    of the whole-body-control loop: one K and one argument tuple a stage."""
    seen = {"chol": [], "lane": []}

    def chol(K):
        seen["chol"].append(K)
        return chol_kernel.cholesky_inverse_lane(K)

    def lane(*args, **kw):
        seen["lane"].append((args, kw))
        return lane_kernel.admm_lane_stage(*args, **kw)

    fleet = standing_fleet(lanes, seed=SEED, device=DEVICE, dtype=torch.float32)
    with mock.patch.object(qp_module, "cholesky_inverse_lane", chol), \
            mock.patch.object(qp_module, "admm_lane_stage", lane):
        wbc_step(fleet, fleet.state, None)
    torch.cuda.synchronize()
    check(len(seen["chol"]) == len(seen["lane"]) == WBC_ITERS // WBC_STAGE,
          "one K3 and one K2 call a stage")
    return seen


def random_lane_inputs(B: int, seed: int):
    """A random per-lane stage at the whole-body shape: 41 equality rows,
    22 rows with l = -inf, 23 boxed rows; K^-1 from the K3 kernel."""
    m, n, n_eq, n_inf = WBC_M, WBC_N, 41, 22
    rng = np.random.default_rng(seed)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                     device=DEVICE)
    A = as_t(rng.normal(size=(B, m, n)) / 8)
    G = as_t(rng.normal(size=(B, n, n)))
    P = G @ G.transpose(1, 2) / n + 0.1 * torch.eye(n, device=DEVICE)
    rho = as_t(10.0 ** rng.uniform(-1, 1, (B, 1)) * np.where(np.arange(m) < n_eq, 30.0, 1.0))
    K = (P + A.transpose(1, 2) @ (rho[..., None] * A)).contiguous()
    lo = rng.normal(-1, 0.5, (B, m))
    hi = lo + np.abs(rng.normal(0, 1, (B, m)))
    hi[:, :n_eq] = lo[:, :n_eq]
    lo[:, n_eq:n_eq + n_inf] = -np.inf
    return (as_t(rng.normal(0, 1, (B, m))), rho, A, chol_kernel.cholesky_inverse_lane(K),
            as_t(rng.normal(0, 1, (B, n))), as_t(lo), as_t(hi))


def lanes_of(args, B: int):
    return tuple(a[:B].contiguous() for a in args)


def lane_kernel_residency(m: int, n: int) -> dict:
    """K2's registers a thread, local and spilled bytes and lanes an SM."""
    return {**lane_kernel.kernel_attributes(m, n),
            "spill_bytes": ptxas_spill_bytes(lane_kernel.SOURCE, {"ADMM_M": m, "ADMM_N": n})}


def chol_kernel_residency(n: int) -> dict:
    """K3's registers a thread, local and spilled bytes and matrices an SM."""
    return {**chol_kernel.inverse_kernel_attributes(n),
            "spill_bytes": ptxas_spill_bytes(chol_kernel.SOURCE, {"CHOL_N": n})}


def kernels_admm_lane(seen, sm_clock_hz: float, sm_count: int) -> dict:
    """K2 against its plain version: on the operators of the first tick's real
    whole-body QP (first and last stage) and on random ones, at several batch
    sizes; NaN-lane locality; then timed at the path's shape."""
    kw = dict(iters=WBC_STAGE, alpha=ALPHA)
    cases, max_rel, max_abs = [], 0.0, 0.0
    sources = {"wbc_stage_1": seen["lane"][0][0], "wbc_stage_6": seen["lane"][-1][0],
               "random": random_lane_inputs(WBC_LANES, seed=11)}
    for name, full in sources.items():
        check(bool(torch.isneginf(full[5]).any()), f"{name}: bounds include -inf rows")
        check(bool((full[5] == full[6]).any()), f"{name}: bounds include equality rows")
        for B in (4096, 512, 1000, 1):
            args = lanes_of(full, B)
            v_k, x_k = lane_kernel.admm_lane_stage(*args, **kw)
            torch.cuda.synchronize()
            v_p, x_p = lane_kernel.admm_lane_stage_reference(*args, **kw)
            v_e, x_e = lane_kernel.admm_lane_stage_reference(
                *(a.double() for a in args), **kw)       # the same inputs in float64
            check(bool(torch.isfinite(v_k).all() and torch.isfinite(x_k).all()),
                  f"{name}: kernel output finite at B={B}")
            ev, ex = rel_err(v_k, v_p), rel_err(x_k, x_p)
            ea = max(float((v_k - v_p).abs().max()), float((x_k - x_p).abs().max()))
            exact_k = max(rel_err(v_k.double(), v_e), rel_err(x_k.double(), x_e))
            exact_p = max(rel_err(v_p.double(), v_e), rel_err(x_p.double(), x_e))
            tol = REL_TOL if name == "random" else REAL_OPERATOR_TOL
            cases.append({"inputs": name, "B": B, "rel_err_v": ev, "rel_err_x": ex,
                          "max_abs_err": ea, "tolerance_rel": tol,
                          "rel_err_vs_float64": exact_k,
                          "plain_rel_err_vs_float64": exact_p})
            max_rel, max_abs = max(max_rel, ev, ex), max(max_abs, ea)
            check(ev <= tol and ex <= tol,
                  f"admm_lane_stage agrees with the plain version to {tol} on {name}"
                  f" at B={B}: v {ev}, x {ex}")
            check(exact_k <= 2 * exact_p + REL_TOL,
                  f"{name}, B={B}: the kernel is as close to the float64 recursion as"
                  f" the plain version: kernel {exact_k}, plain {exact_p}")

    # a poisoned lane stays non-finite and poisons no other lane
    B, lane = 1000, 137
    args = list(lanes_of(sources["wbc_stage_1"], B))
    clean_v, clean_x = lane_kernel.admm_lane_stage(*args, **kw)
    others = torch.ones(B, dtype=torch.bool, device=DEVICE)
    others[lane] = False
    for where in ("v", "bounds", "Kinv"):
        bad = [a.clone() for a in args]
        if where == "v":
            bad[0][lane, 5] = float("nan")
        elif where == "bounds":
            bad[5][lane, 0] = float("nan")
            bad[6][lane, 0] = float("nan")
        else:
            bad[3][lane] = float("nan")
        nan_v, nan_x = lane_kernel.admm_lane_stage(*bad, **kw)
        torch.cuda.synchronize()
        check(not bool(torch.isfinite(nan_v[lane]).all())
              and not bool(torch.isfinite(nan_x[lane]).all()),
              f"NaN in {where}: the lane's v and x are non-finite")
        check(bool(torch.equal(nan_v[others], clean_v[others])
                   and torch.equal(nan_x[others], clean_x[others])),
              f"NaN in {where}: every other lane equals the clean run bit for bit")
        ref_v, _ = lane_kernel.admm_lane_stage_reference(*bad, **kw)
        check(not bool(torch.isfinite(ref_v[lane]).all()),
              f"NaN in {where}: the plain version poisons the lane too")

    args = sources["wbc_stage_6"]
    B, m, n = WBC_LANES, WBC_M, WBC_N
    kernel_ms = median_ms(lambda: lane_kernel.admm_lane_stage(*args, **kw), 2, 9)
    plain_ms = median_ms(lambda: lane_kernel.admm_lane_stage_reference(*args, **kw), 1, 3)
    cost = profiling.admm_lane_cost(B, m, n, WBC_STAGE)
    bound = fma_bound(cost)
    # what the register-resident design still reads from shared memory an
    # iteration, at 128 bytes a clock an SM: the words each warp reads (a
    # broadcast counted once) of w, of r, of the warps' x partials and of x,
    # the row owners' reads of the warps' A x partials, and any operator rows
    # kept in shared memory
    plan = lane_kernel.lane_plan(m, n)
    w, cw, rl = plan.warps, plan.cols, plan.rows
    words = (64 * w * rl + 2 * w * cw + w * w * cw
             + w * 32 * cw * (2 * (rl - plan.rows_in_registers)
                              + (plan.outs - plan.outs_in_registers)))
    reread = 4 * B * WBC_STAGE * words
    shared_rate = sm_count * 128 * sm_clock_hz
    return {
        "name": "admm_lane_stage", "shape": [m, n], "iters": WBC_STAGE, "batch_timed": B,
        "plan": plan._asdict(), **lane_kernel_residency(m, n),
        "cases": cases, "nan_lane": "confined", "max_rel_err": max_rel,
        "max_abs_err": max_abs, "tolerance_rel": REL_TOL,
        "tolerance_rel_real_operators": REAL_OPERATOR_TOL, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, **bound, "fraction_of_bound": bound["bound_ms"] / kernel_ms,
        "shared_memory_reread_bytes": reread,
        "shared_memory_bytes_per_s": shared_rate,
        "shared_memory_ms": 1e3 * reread / shared_rate,
        "shared_memory_rate_source": f"{sm_count} SMs x 128 B/clk x max SM clock",
        "gflops": cost.fma_flops / (kernel_ms * 1e-3) / 1e9, "library_ms": None,
    }


def spd_batch(B: int, n: int, seed: int) -> torch.Tensor:
    """Well-conditioned SPD matrices, as the reference's own kernel test draws
    them: ``0.09 G G' + 2 I``."""
    G = np.random.default_rng(seed).normal(size=(B, n, n)).astype(np.float32) * 0.3
    K = G @ np.swapaxes(G, -1, -2) + np.eye(n, dtype=np.float32) * 2
    return torch.as_tensor(K, device=DEVICE)


def kernels_chol_lane(seen) -> dict:
    """K3 against its plain version at n in CHOL_SIZES and on the first tick's
    real KKT matrices; NaN and non-SPD lanes stay local; timed at n = 64
    beside the one library call that computes the same inverse."""
    cases, max_rel, max_abs = [], 0.0, 0.0
    for n in CHOL_SIZES:
        for B in (4096, 1000, 1):
            K = spd_batch(B, n, seed=n)
            out = chol_kernel.cholesky_inverse_lane(K)
            torch.cuda.synchronize()
            ref = chol_kernel.cholesky_inverse_lane_reference(K)
            e = rel_err(out, ref)
            e64 = rel_err(out.double(), torch.linalg.inv(K.double()))
            cases.append({"inputs": "spd", "n": n, "B": B, "rel_err": e,
                          "rel_err_vs_float64": e64,
                          "max_abs_err": float((out - ref).abs().max())})
            max_rel, max_abs = max(max_rel, e), max(max_abs, float((out - ref).abs().max()))
            check(e <= REL_TOL and e64 <= REL_TOL,
                  f"cholesky_inverse_lane agrees with the plain version to {REL_TOL} at"
                  f" n={n}, B={B}: {e} (against float64: {e64})")
            check(bool(torch.equal(out, out.transpose(1, 2))), f"n={n}: symmetric bit for bit")
    # the whole-body loop's own KKT matrices: they are worse conditioned than
    # the drawn ones, so the float32 kernel and the float32 plain version each
    # sit some cond(K) eps from the float64 inverse; the kernel is held to the
    # plain version's own distance from float64 (x4), and both are reported
    real = []
    for stage, K in ((1, seen["chol"][0]), (6, seen["chol"][-1])):
        out = chol_kernel.cholesky_inverse_lane(K)
        ref = chol_kernel.cholesky_inverse_lane_reference(K)
        exact = torch.linalg.inv(K.double())
        e, ek, ep = rel_err(out, ref), rel_err(out.double(), exact), rel_err(ref.double(), exact)
        real.append({"inputs": f"wbc_stage_{stage}", "n": WBC_N, "B": K.shape[0],
                     "rel_err": e, "rel_err_vs_float64": ek,
                     "plain_rel_err_vs_float64": ep})
        check(bool(torch.isfinite(out).all()), f"stage {stage}: real K inverts finitely")
        check(e <= REL_TOL, f"stage {stage}: real K agrees with the plain version to"
                            f" {REL_TOL}, got {e}")
        check(ek <= 4 * ep + REL_TOL,
              f"stage {stage}: on the real K the kernel is as close to float64 as the"
              f" plain version: kernel {ek}, plain {ep}")

    # NaN lane and non-SPD lane: NaN in their whole output, nothing else moves
    B, n = 1000, WBC_N
    K = spd_batch(B, n, seed=3)
    clean = chol_kernel.cholesky_inverse_lane(K)
    for where, lane in (("nan", 137), ("not_spd", 500)):
        bad = K.clone()
        if where == "nan":
            bad[lane, 7, 3] = float("nan")
            bad[lane, 3, 7] = float("nan")
        else:
            bad[lane, 40, 40] = -1.0
        out = chol_kernel.cholesky_inverse_lane(bad)
        torch.cuda.synchronize()
        others = torch.ones(B, dtype=torch.bool, device=DEVICE)
        others[lane] = False
        check(bool(torch.isnan(out[lane]).all()), f"{where} lane: NaN in its whole output")
        check(bool(torch.equal(out[others], clean[others])),
              f"{where} lane: every other lane equals the clean run bit for bit")
        check(bool(torch.isnan(chol_kernel.cholesky_inverse_lane_reference(bad)[lane]).all()),
              f"{where} lane: the plain version gives NaN in the whole lane too")

    K = seen["chol"][-1]
    B, n = K.shape[0], K.shape[1]
    kernel_ms = median_ms(lambda: chol_kernel.cholesky_inverse_lane(K), 2, 9)
    plain_ms = median_ms(lambda: chol_kernel.cholesky_inverse_lane_reference(K), 1, 3)
    library_ms = median_ms(
        lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(K)[0]), 2, 9)
    bound = fma_bound(profiling.cholesky_inverse_cost(B, n))
    return {
        "name": "cholesky_inverse_lane", "shape": [n, n], "batch_timed": B,
        **chol_kernel_residency(n), "fraction_of_bound": bound["bound_ms"] / kernel_ms,
        "cases": cases + real, "nan_lane": "confined", "not_spd_lane": "confined",
        "max_rel_err": max_rel, "max_abs_err": max_abs, "tolerance_rel": REL_TOL,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": "torch.linalg.cholesky_ex + torch.cholesky_inverse", **bound,
    }


# --------------------------------------------------------------------------
# the control stack's kernels: K1 at (48, 32), K2 at 150 iterations, K3 at
# n = 29, K4 at n = 6, on what the stack's own ticks hand them
# --------------------------------------------------------------------------

def capture_stack_inputs(lanes: int) -> dict:
    """What the stack's two first outer ticks (cold, then warm) hand every
    kernel wrapper: the MPC's stage arguments (K1), the WBC's stage arguments
    (K2) and KKT matrices (K3, n = 64), the plant's mass matrices (K3, n = 29)
    and the attribution's normal equations (K4)."""
    seen = {"mpc": [], "lane": [], "kkt": [], "minv": [], "solve": []}

    def record(key, fn):
        def wrapped(*args, **kw):
            seen[key].append((args, kw))
            return fn(*args, **kw)
        return wrapped

    problem = push_recovery_stack(lanes, seed=SEED, device=DEVICE, dtype=torch.float32)
    step = stack_fleet_step(problem)
    with mock.patch.object(qp_module, "admm_stage", record("mpc", admm_kernel.admm_stage)), \
            mock.patch.object(qp_module, "admm_lane_stage",
                              record("lane", lane_kernel.admm_lane_stage)), \
            mock.patch.object(qp_module, "cholesky_inverse_lane",
                              record("kkt", chol_kernel.cholesky_inverse_lane)), \
            mock.patch.object(stack_module, "cholesky_inverse_lane",
                              record("minv", chol_kernel.cholesky_inverse_lane)), \
            mock.patch.object(stack_module, "spd_solve_lane",
                              record("solve", chol_kernel.spd_solve_lane)):
        state, _ = step(problem.state, problem.pushes, *problem.refs)
        step(state, problem.pushes, *problem.refs)
    torch.cuda.synchronize()
    expected = {"mpc": 2 * STACK_MPC_STAGES, "lane": 2 * STACK_INNER,
                "kkt": 2 * STACK_INNER, "minv": 2, "solve": 2 * STACK_INNER}
    check({k: len(v) for k, v in seen.items()} == expected,
          f"the stack's two ticks call each wrapper as configured: {expected}")
    return seen


def f64_distance(kernel_out, plain_out, exact) -> tuple:
    return rel_err(kernel_out.double(), exact), rel_err(plain_out.double(), exact)


def kernels_admm_stage_stack(seen) -> dict:
    """K1 at the stack MPC's (48, 32) against its plain version, on the stage
    inputs of the cold tick's first stage and the warm tick's last one."""
    cases, max_rel, max_abs = [], 0.0, 0.0
    sources = {"stack_tick1_stage1": seen["mpc"][0], "stack_tick2_stage4": seen["mpc"][-1]}
    for name, (full, kw) in sources.items():
        kw = dict(iters=kw["iters"], alpha=kw["alpha"])      # the f32 mode, not the stack's
        check(bool(torch.isinf(full[4]).any()), f"{name}: bounds include -inf rows")
        for B in (STACK_LANES, 1000, 1):
            args = lanes_of(full[:6], B) + tuple(full[6:])
            v_k, tau_k = admm_kernel.admm_stage(*args, **kw)
            torch.cuda.synchronize()
            v_p, tau_p = admm_kernel.admm_stage_reference(*args, **kw)
            v_e, _ = admm_kernel.admm_stage_reference(*(a.double() for a in args), **kw)
            ev, et = rel_err(v_k, v_p), rel_err(tau_k, tau_p)
            ea = max(float((v_k - v_p).abs().max()), float((tau_k - tau_p).abs().max()))
            ek, ep = f64_distance(v_k, v_p, v_e)
            cases.append({"inputs": name, "B": B, "rel_err_v": ev, "rel_err_tau": et,
                          "max_abs_err": ea, "rel_err_vs_float64": ek,
                          "plain_rel_err_vs_float64": ep})
            max_rel, max_abs = max(max_rel, ev, et), max(max_abs, ea)
            check(ev <= REL_TOL and et <= REL_TOL,
                  f"admm_stage at ({STACK_M}, {STACK_N}) agrees with the plain version to"
                  f" {REL_TOL} on {name} at B={B}: v {ev}, tau {et}")
    args, kw = seen["mpc"][-1]
    kw = dict(iters=kw["iters"], alpha=kw["alpha"])
    kernel_ms = median_ms(lambda: admm_kernel.admm_stage(*args, **kw), 3, 11)
    plain_ms = median_ms(lambda: admm_kernel.admm_stage_reference(*args, **kw), 1, 3)
    B, m, n, iters = args[0].shape[0], STACK_M, STACK_N, kw["iters"]
    bound = f32_stage_bound(m, n, B, iters)
    return {
        "name": "admm_stage", "path": "stack", "shape": [m, n], "iters": iters,
        "batch_timed": B, "cases": cases, "max_rel_err": max_rel, "max_abs_err": max_abs,
        **ptxas_residency(admm_kernel.SOURCE, {"ADMM_M": m, "ADMM_N": n}),
        "shared_bytes": admm_kernel.stage_shared_bytes(m, n),
        "tolerance_rel": REL_TOL, "kernel_ms": kernel_ms, "plain_ms": plain_ms, **bound,
        "fraction_of_bound": bound["bound_ms"] / kernel_ms, "library_ms": None,
    }


def gait_stages(lanes: int, num_steps: int) -> list:
    """The stage arguments ``plan_gait(shared=True, backend="cuda")`` hands
    K1 on ``gait_fleet(lanes, num_steps)``, every stage, in order."""
    fleet = gait_fleet(lanes, num_steps=num_steps, seed=SEED, device=DEVICE,
                       dtype=torch.float32)
    seen = []

    def record(*args, **kw):
        seen.append((args, kw))
        return admm_kernel.admm_stage(*args, **kw)

    with mock.patch.object(qp_module, "admm_stage", record):
        plan_gait(*fleet, iterations=GAIT_ITERATIONS, shared=True, backend="cuda")
    torch.cuda.synchronize()
    return seen


def with_free_rows(args, seed: int):
    """The stage ``args`` with a random iterate, s spread over [1e-2, 1e2] and
    a quarter of the rows free above (u = +inf) besides the -inf lower
    bounds of the polygon rows."""
    rng = np.random.default_rng(seed)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
    v, tau, _, gq, lb, ub = args[:6]
    B, m = v.shape
    free = torch.as_tensor(rng.random(m) < 0.25, device=DEVICE)
    ub = torch.where(free, float("inf"), ub).contiguous()
    return (as_t(rng.normal(0, 0.1, (B, m))), tau, as_t(10.0 ** rng.uniform(-2, 2, (B, 1))),
            gq, lb, ub) + tuple(args[6:])


def l2_compare(args, kw, what: str) -> dict:
    """The streaming kernel against its plain version on ``args``, and both
    against the plain version in float64."""
    v_k, tau_k = admm_kernel.admm_stage(*args, **kw)
    torch.cuda.synchronize()
    v_p, tau_p = admm_kernel.admm_stage_reference(*args, **kw)
    v_e, _ = admm_kernel.admm_stage_reference(*(a.double() for a in args), **kw)
    check(bool(torch.isfinite(v_k).all() and torch.isfinite(tau_k).all()),
          f"admm_stage_l2 output finite on {what}")
    ev, et = rel_err(v_k, v_p), rel_err(tau_k, tau_p)
    ea = max(float((v_k - v_p).abs().max()), float((tau_k - tau_p).abs().max()))
    ek, ep = f64_distance(v_k, v_p, v_e)
    m, n = args[6].shape
    check(ev <= REL_TOL and et <= REL_TOL,
          f"admm_stage_l2 at ({m}, {n}) agrees with the plain version to {REL_TOL} on {what}"
          f" at B={v_k.shape[0]}: v {ev}, tau {et}")
    return {"shape": [m, n], "inputs": what, "B": v_k.shape[0], "iters": kw["iters"],
            "rel_err_v": ev, "rel_err_tau": et, "max_abs_err": ea,
            "rel_err_vs_float64": ek, "plain_rel_err_vs_float64": ep}


def kernels_admm_stage_l2() -> dict:
    """K1's streaming kernel (csrc/admm_stage_l2.cu) against the plain version
    at L2_SHAPES: on the stage inputs the gait fleet's plan hands it (the cold
    first stage and the warm last one) at the 10-step and 6-step gaits, and on
    random iterates with rows free above; the tick's transcription at horizon
    40 on random iterates; B in (GAIT_LANES, 1000, 1); a NaN lane confined at
    each shape. Timed at each shape on GAIT_LANES lanes, 25 iterations (the
    10-step gait's warm stage, the others' random ones), and on half of them."""
    cases, shapes = [], {}
    for m, n, name in L2_SHAPES:
        check(admm_kernel.streams_operator(m, n),
              f"({m}, {n}) is past the resident kernel's shared memory")
        if name.startswith("gait"):
            stages = gait_stages(GAIT_LANES, int(name[4:]))
            check(all(a[0].shape[1] == m and a[6].shape[1] == n for a, _ in stages),
                  f"the {name} plan runs K1 at ({m}, {n})")
            sources = {f"{name}_stage1_cold": stages[0][0], f"{name}_stage{len(stages)}_warm":
                       stages[-1][0]}
            check(not bool(sources[f"{name}_stage1_cold"][0].any()),
                  "the first stage starts cold (v = 0)")
            del stages
        else:
            problem = stationary_push_recovery(GAIT_LANES, n // 4, seed=SEED, device=DEVICE,
                                               dtype=torch.float32)
            sources = {f"{name}_random": stage_inputs(problem, stage_operators(problem)[3],
                                                      GAIT_LANES, seed=m)}
        timed = list(sources.values())[-1]
        sources[f"{name}_free_rows"] = with_free_rows(timed, seed=n)
        kw = dict(iters=STAGE_ITERS, alpha=ALPHA)
        for what, full in sources.items():
            check(bool(torch.isinf(full[4]).any()), f"{what}: bounds include -inf rows")
            for B in (GAIT_LANES, 1000, 1):
                cases.append(l2_compare(lanes_of(full[:6], B) + tuple(full[6:]), kw, what))
        nan_confined(lanes_of(sources[f"{name}_free_rows"][:6], 1000) + tuple(timed[6:]),
                     kw, "f32", f"admm_stage_l2 on {name}")
        kernel_ms = median_ms(lambda: admm_kernel.admm_stage(*timed, **kw), 2, 7)
        plain_ms = median_ms(lambda: admm_kernel.admm_stage_reference(*timed, **kw), 1, 3)
        # half the lanes: every block still has an SM of its own, and the operator
        # traffic from L2 halves; a time that halves too says L2 binds, one that
        # stays says each SM's own work does
        half = lanes_of(timed[:6], GAIT_LANES // 2) + tuple(timed[6:])
        half_ms = median_ms(lambda: admm_kernel.admm_stage(*half, **kw), 2, 7)
        defines = {"ADMM_M": m, "ADMM_N": n}
        residency = ptxas_residency(admm_kernel.L2_SOURCE, defines)
        check(residency["spill_bytes"] == 0, f"admm_stage_l2 at ({m}, {n}) spills nothing:"
              f" {residency}")
        bound = f32_stage_bound(m, n, GAIT_LANES, STAGE_ITERS)
        # the operator, re-read from L2 by each 32-lane block once a pass, iters + 1 passes
        operator_gb = (STAGE_ITERS + 1) * m * n * 4 * -(-GAIT_LANES // 32) / 1e9
        rows, splits, columns = admm_kernel.l2_plan(m, n)
        shapes[name] = {"shape": [m, n], "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                        "plan": {"lanes_a_tile": 32, "chunk_rows": 32, "u_tile": [rows, 4],
                                 "u_splits": splits, "t_tile": [columns, 4]},
                        **residency, "shared_bytes": admm_kernel.stage_l2_shared_bytes(m, n),
                        **bound, "fraction_of_bound": bound["bound_ms"] / kernel_ms,
                        "tflops": STAGE_ITERS * 4 * m * n * GAIT_LANES / (kernel_ms * 1e-3) / 1e12,
                        "operator_reads_gb": operator_gb,
                        # v, l, u read and v written over m, gq read over n, a lane an
                        # iteration, through device memory: the design's floor by bytes
                        "bytes_floor_ms": 1e3 * 4 * GAIT_LANES * STAGE_ITERS * (4 * m + n)
                        / SPEC.hbm_bytes_per_s,
                        "operator_read_gb_per_s": operator_gb / (kernel_ms * 1e-3),
                        "kernel_ms_half_lanes": half_ms, "half_lanes_ratio": half_ms / kernel_ms}
        del sources, timed
    main = shapes[L2_SHAPES[0][2]]
    return {
        "name": "admm_stage_l2", "path": "gait", "shape": main["shape"], "iters": STAGE_ITERS,
        "batch_timed": GAIT_LANES, "cases": cases, "nan_lane": "confined", "shapes": shapes,
        "max_rel_err": max(max(c["rel_err_v"], c["rel_err_tau"]) for c in cases),
        "max_abs_err": max(c["max_abs_err"] for c in cases), "tolerance_rel": REL_TOL,
        **{k: main[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                "registers", "spill_bytes", "shared_bytes", "plan",
                                "operator_reads_gb", "bytes_floor_ms", "fraction_of_bound",
                                "tflops")},
        "library_ms": None,
    }


def random_qp(m: int, n: int, B: int, seed: int):
    """A random feasible shared QP at (m, n) over B lanes, factored as the
    solver factors it: ``(factors, q, l, u)``. P = X X^T / n + 0.1 I, A ~
    N(0, 1/n); each lane's bounds around A x0 of its own x0, an eighth of the
    rows equalities and a quarter of the others free below (l = -inf); its
    own q."""
    rng = np.random.default_rng(seed)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                     device=DEVICE)
    X, A = rng.normal(size=(n, n)), rng.normal(size=(m, n)) / np.sqrt(n)
    eq = np.arange(m) < max(1, m // 8)
    f = factor_shared_qp(as_t(X @ X.T / n + 0.1 * np.eye(n)), as_t(A),
                         torch.as_tensor(eq, device=DEVICE))
    c0 = rng.normal(0, 0.5, (B, n)) @ A.T
    lo, hi = c0 - np.abs(rng.normal(0.2, 0.1, (B, m))), c0 + np.abs(rng.normal(0.2, 0.1, (B, m)))
    lo[:, eq], hi[:, eq] = c0[:, eq], c0[:, eq]
    lo[:, ~eq & (rng.random(m) < 0.25)] = -np.inf
    return f, as_t(rng.normal(0, 1, (B, n))), as_t(lo), as_t(hi)


def random_qp_stage(m: int, n: int, B: int, seed: int):
    """Stage inputs of :func:`random_qp` (scaled bounds, gq as the solver
    forms them), a random iterate and s spread over [1e-2, 1e2]; and the QP."""
    rng = np.random.default_rng(seed + 1)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
    f, q, lo, hi = qp = random_qp(m, n, B, seed)
    return (as_t(rng.normal(0, 0.1, (B, m))), torch.zeros((B, n), device=DEVICE),
            as_t(10.0 ** rng.uniform(-2, 2, (B, 1))), ((f.c * (q * f.D)) @ f.W).contiguous(),
            (f.E * lo).contiguous(), (f.E * hi).contiguous(), f.G2.contiguous(), f.d,
            f.base_rho), qp


def solve_stages(factors, q, l, u, iterations: int) -> list:
    """The stage arguments ``solve_qp_factored(backend="cuda")`` hands K1 over
    an exact solve of (q, l, u) against ``factors``, every stage, in order:
    the last is warm, its lanes near their fixed points at their adapted s."""
    seen = []

    def record(*args, **kw):
        seen.append(args)
        return admm_kernel.admm_stage(*args, **kw)

    with mock.patch.object(qp_module, "admm_stage", record):
        qp_module.solve_qp_factored(factors, q, l, u, iterations=iterations, backend="cuda")
    torch.cuda.synchronize()
    return seen


def tc_l2_traffic(m: int, n: int, B: int, iters: int, matmul: str) -> dict:
    """What csrc/admm_stage_tc_l2.cu moves beside the stage's own bytes: each
    tile of lanes reads both operators' bf16 pairs (the tiles within m) from
    L2 once a pass, one product each in ``iters`` passes; and the per-lane
    state through device memory (floats a lane an iteration: "split" v, l, u
    read and v written over m, the stage's two gains read over n; "delta"
    also u_acc and t_acc read and written). The state's bytes at the memory
    rate are this design's floor (``bytes_floor_ms``)."""
    lanes, _ = admm_kernel.tc_l2_plan(m, n)
    tiles = -(-B // lanes)
    operator = tiles * iters * 2 * (-(-m // 64)) * (-(-n // 64)) * 4 * 64 * 64
    per_iter = 4 * m + 2 * n if matmul == "split" else 6 * m + 4 * n
    state = 4 * B * iters * per_iter
    return {"operator_l2_gb": operator / 1e9, "state_gb": state / 1e9,
            "bytes_floor_ms": 1e3 * state / SPEC.hbm_bytes_per_s}


def kernels_admm_stage_tc_l2() -> dict:
    """K1's streaming tensor-core kernel (csrc/admm_stage_tc_l2.cu) against its
    plain version at TC_L2_SHAPES, both modes: "split" over 25 iterations,
    "delta"'s 3-pass first iteration and its first increment from a cold
    iterate on the gait plans' cold first stages (the tick's and the random
    QPs' random iterates); "delta" and "split" over 25 iterations of a warm
    stage: the gait plans' last, the fleet tick's (in "cuda_delta", on this
    kernel) at tick TC_WARM_TICK, and the last of a TC_SETTLE_ITERS-iteration
    exact solve of each random QP. B in (GAIT_LANES, 1000, 1) at
    (960, 384), (GAIT_LANES, 1) elsewhere; the cases at GAIT_LANES also
    against the plain version's math in float64. A NaN lane confined at
    (960, 384) and at the random QPs' shapes. Both modes timed at every shape
    on GAIT_LANES lanes, 25 iterations of the warm stage."""
    cases, shapes = [], {}
    kw = dict(iters=STAGE_ITERS, alpha=ALPHA)
    for m, n, name in TC_L2_SHAPES:
        check(admm_kernel.tc_streams_operator(m, n),
              f"({m}, {n}) is past what the resident tensor-core kernel takes")
        if name.startswith("gait"):
            stages = gait_stages(GAIT_LANES, int(name[4:]))
            check(all(a[0].shape[1] == m and a[6].shape[1] == n for a, _ in stages),
                  f"the {name} plan runs K1 at ({m}, {n})")
            cold = stages[0][0]
            check(not bool(cold[0].any()), "the first stage starts cold (v = 0)")
            sources = {f"{name}_stage1_cold": cold,
                       f"{name}_stage{len(stages)}_warm": stages[-1][0]}
            del stages
        elif name == "tick_h40":
            problem = stationary_push_recovery(GAIT_LANES, n // 4, seed=SEED, device=DEVICE,
                                               dtype=torch.float32)
            warm = capture_tick_stages(problem, TC_WARM_TICK, GAIT_LANES, n // 4)[-1][0]
            sources = {f"{name}_random": stage_inputs(problem, stage_operators(problem)[3],
                                                      GAIT_LANES, seed=m),
                       f"{name}_tick{TC_WARM_TICK}_warm": warm}
        else:
            args, qp = random_qp_stage(m, n, GAIT_LANES, seed=m + n)
            sources = {f"{name}_random": args,
                       f"{name}_solve_warm": solve_stages(*qp, TC_SETTLE_ITERS)[-1]}
        batches = (GAIT_LANES, 1000, 1) if name == "gait10" else (GAIT_LANES, 1)
        for what, full in sources.items():
            check(bool(torch.isinf(full[4]).any()), f"{what}: bounds include -inf rows")
            for B in batches:
                args = lanes_of(full[:6], B) + tuple(full[6:])
                exact = B == GAIT_LANES
                if what.endswith("_warm"):
                    cases.append(tc_compare(args, kw, "delta", TC_WARM_TOL, what, exact=exact))
                    cases.append(tc_compare(args, kw, "split", TC_SPLIT_TOL, what, exact=exact))
                    continue
                cases.append(tc_compare(args, kw, "split", TC_SPLIT_TOL, what, exact=exact))
                cases.append(tc_compare(args, dict(kw, iters=1), "delta", TC_SPLIT_TOL, what))
                cases.append(tc_compare(args, dict(kw, iters=2), "delta", TC_STEP_TOL, what))
        first = next(iter(sources.values()))
        if name in ("gait10", "qp_n_gt_m", "qp_m_odd"):
            for matmul in TC_MODES:
                nan_confined(lanes_of(first[:6], 1000) + tuple(first[6:]), kw, matmul,
                             f"admm_stage_tc_l2 {matmul} on {name}")
        timed = list(sources.values())[-1]
        modes = {}
        for matmul in TC_MODES:
            defines = admm_kernel.tc_l2_defines(m, n, matmul)
            residency = ptxas_residency(admm_kernel.TC_L2_SOURCE, defines)
            check(residency["spill_bytes"] == 0,
                  f"admm_stage_tc_l2 {matmul} at ({m}, {n}) spills nothing: {residency}")
            kernel_ms = median_ms(
                lambda: admm_kernel.admm_stage(*timed, **kw, matmul=matmul), 2, 7)
            plain_ms = median_ms(
                lambda: admm_kernel.admm_stage_reference(*timed, **kw, matmul=matmul), 1, 3)
            bound = tc_bound(m, n, GAIT_LANES, STAGE_ITERS, matmul)
            modes[matmul] = {"kernel_ms": kernel_ms, "plain_ms": plain_ms, **residency,
                             # one block a cluster: two sharing each tile measured no faster
                             "plan": {"cluster": 1, "lanes_a_tile": defines["ADMM_LANES"],
                                      "ring_slots": defines["ADMM_STAGES"],
                                      "operator_tile": [64, 64]}, **bound,
                             "fraction_of_bound": bound["bound_ms"] / kernel_ms,
                             "tflops_tensor": bound["passes"] * 2 * m * n * GAIT_LANES
                             / (kernel_ms * 1e-3) / 1e12,
                             **tc_l2_traffic(m, n, GAIT_LANES, STAGE_ITERS, matmul)}
        shapes[name] = {"shape": [m, n], "timed_on": list(sources)[-1],
                        "shared_bytes": admm_kernel.stage_tc_l2_shared_bytes(m, n, "delta"),
                        "operator_scratch_bytes": admm_kernel.tc_l2_operator_bytes(m, n),
                        "modes": modes}
        del sources, timed, first
    main = shapes[TC_L2_SHAPES[0][2]]
    delta = main["modes"]["delta"]
    held = [c for c in cases if c["tolerance_rel"] is not None]
    return {
        "name": "admm_stage_tc_l2", "path": "gait_delta", "shape": main["shape"],
        "iters": STAGE_ITERS, "batch_timed": GAIT_LANES, "cases": cases, "nan_lane": "confined",
        "shapes": shapes, "modes": main["modes"],
        "max_rel_err": max(max(c["rel_err_v"], c["rel_err_tau"]) for c in held),
        "max_abs_err": max(c["max_abs_err"] for c in held),
        "kernel_ms": delta["kernel_ms"], "plain_ms": delta["plain_ms"],
        "bound_ms": delta["bound_ms"], "bound_by": delta["bound_by"],
        "registers": delta["registers"], "spill_bytes": delta["spill_bytes"],
        "shared_bytes": main["shared_bytes"], "plan": delta["plan"],
        "operator_l2_gb": delta["operator_l2_gb"], "bytes_floor_ms": delta["bytes_floor_ms"],
        "library_ms": None, "library": "none: no PyTorch call computes the stage",
    }


def f32_odd_n_cases() -> dict:
    """Mode "f32" at an n that is not a multiple of 4 (F32_ODD_SHAPES, random
    shared QPs, GAIT_LANES and 1 lanes): the wrapper pads n for the kernel the
    padded shape picks, which is held to the plain version at the shape as
    given; keyed by that kernel."""
    out = {"admm_stage": [], "admm_stage_l2": []}
    kw = dict(iters=STAGE_ITERS, alpha=ALPHA)
    for m, n in F32_ODD_SHAPES:
        check(n % 4 != 0, f"n = {n} is not a multiple of 4")
        streams = admm_kernel.streams_operator(m, n + (-n % 4))
        full = random_qp_stage(m, n, GAIT_LANES, seed=m * n)[0]
        for B in (GAIT_LANES, 1):
            args = lanes_of(full[:6], B) + tuple(full[6:])
            admm_kernel.reset_counts()
            v_k, tau_k = admm_kernel.admm_stage(*args, **kw)
            launched = (admm_kernel.l2_launch_count() if streams else admm_kernel.launch_count(),
                        admm_kernel.reference_count())
            torch.cuda.synchronize()
            v_p, tau_p = admm_kernel.admm_stage_reference(*args, **kw)
            check(launched == (1, 0), f"({m}, {n}) ran its kernel once: {launched}")
            check(tuple(tau_k.shape) == (B, n) and tau_k.is_contiguous(),
                  f"tau cut back to ({B}, {n}): {tuple(tau_k.shape)}")
            ev, et = rel_err(v_k, v_p), rel_err(tau_k, tau_p)
            check(ev <= REL_TOL and et <= REL_TOL,
                  f"f32 at the odd n of ({m}, {n}) agrees with the plain version to {REL_TOL}"
                  f" at B={B}: v {ev}, tau {et}")
            out["admm_stage_l2" if streams else "admm_stage"].append(
                {"shape": [m, n], "padded_n": n + (-n % 4), "B": B, "rel_err_v": ev,
                 "rel_err_tau": et,
                 "max_abs_err": max(float((v_k - v_p).abs().max()),
                                    float((tau_k - tau_p).abs().max()))})
    return out


def tc_compare(args, kw, matmul: str, tol: float, what: str, hold: bool = True,
               exact: bool = False) -> dict:
    """A tensor-core kernel (the shape picks which) against its plain version
    on the same inputs; with ``exact``, both against the plain version's math
    in float64."""
    m, n = args[6].shape
    name = "admm_stage_tc_l2" if admm_kernel.tc_streams_operator(m, n) else "admm_stage_tc"
    v_k, tau_k = admm_kernel.admm_stage(*args, **kw, matmul=matmul)
    torch.cuda.synchronize()
    v_p, tau_p = admm_kernel.admm_stage_reference(*args, **kw, matmul=matmul)
    check(bool(torch.isfinite(v_k).all() and torch.isfinite(tau_k).all()),
          f"{name} {matmul}: kernel output finite on {what}")
    ev, et = rel_err(v_k, v_p), rel_err(tau_k, tau_p)
    ea = max(float((v_k - v_p).abs().max()), float((tau_k - tau_p).abs().max()))
    if hold:
        check(ev <= tol and et <= tol,
              f"{name} {matmul} agrees with its plain version to {tol} on {what} at ({m}, {n}):"
              f" v {ev}, tau {et}")
    case = {"matmul": matmul, "inputs": what, "B": args[0].shape[0], "iters": kw["iters"],
            "rel_err_v": ev, "rel_err_tau": et, "max_abs_err": ea,
            "tolerance_rel": tol if hold else None}
    if exact:
        v_e, _ = admm_kernel.admm_stage_reference(*(a.double() for a in args), **kw,
                                                  matmul=matmul)
        case["rel_err_vs_float64"], case["plain_rel_err_vs_float64"] = f64_distance(v_k, v_p, v_e)
    return case


def tc_bound(m: int, n: int, B: int, iters: int, matmul: str) -> dict:
    """The least time of a tensor-core stage at (m, n, B, iters)
    (``profiling.admm_stage_cost`` in mode "split" or "delta"): the tensor
    cores' passes of 2 m n B flop at the bf16 peak, against the f32
    elementwise operations counted from csrc/admm_stage_tc.cu at the f32 peak
    and the bytes at the memory rate."""
    cost = profiling.admm_stage_cost(B, m, n, iters, matmul)
    units = cost.unit_seconds(SPEC)
    times = {"tensor": 1e3 * units["tensor"], "elementwise": 1e3 * units["fma"],
             "bytes": 1e3 * units["memory"]}
    by = max(times, key=times.get)
    return {"bound_ms": times[by], "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_basis": by, "bound_tensor_ms": times["tensor"],
            "bound_elementwise_ms": times["elementwise"], "bound_bytes_ms": times["bytes"],
            "passes": round(cost.tensor_flops / (2 * m * n * B)),
            "bound_source": bound_source(BF16_PEAK, F32_PEAK, HBM_RATE)}


def capture_tick_stages(problem, ticks: int, lanes: int = BATCH, horizon: int = HORIZON) -> list:
    """The stage arguments the fleet tick in mode "cuda_delta" hands the
    kernel on its ``ticks``-th tick (both stages), at the full batch (or
    ``lanes``) and the problem's horizon."""
    seen = []

    def record(*args, **kw):
        seen[:] = seen[-1:] + [(args, kw)]
        return admm_kernel.admm_stage(*args, **kw)

    state = init_fleet(lanes, horizon, problem.num_constraints, problem.dcm0, problem.com0,
                       device=DEVICE, dtype=torch.float32)
    step = make_fleet_step(problem.params, problem.dt, iterations=2 * STAGE_ITERS,
                           backend="cuda_delta", device=DEVICE)
    refs = (problem.dcm_ref, problem.zmp_ref, problem.poly_A, problem.poly_b)
    with mock.patch.object(qp_module, "admm_stage", record):
        for _ in range(ticks):
            state, _ = step(state, problem.disturbance, *refs)
    torch.cuda.synchronize()
    check(all(kw.get("matmul") == "delta" for _, kw in seen), "the tick runs the delta mode")
    return seen


def nan_confined(args, kw, matmul: str, what: str) -> None:
    """A poisoned lane stays non-finite and poisons no other lane, whether the
    NaN enters through the iterate or through a bound."""
    B, lane = args[0].shape[0], 137
    clean_v, clean_tau = admm_kernel.admm_stage(*args, **kw, matmul=matmul)
    others = torch.ones(B, dtype=torch.bool, device=DEVICE)
    others[lane] = False
    for where in ("v", "bounds"):
        bad = [a.clone() for a in args]
        if where == "v":
            bad[0][lane, 5] = float("nan")
        else:
            bad[4][lane, 0] = float("nan")
            bad[5][lane, 0] = float("nan")
        nan_v, nan_tau = admm_kernel.admm_stage(*bad, **kw, matmul=matmul)
        torch.cuda.synchronize()
        case = f"{what}, NaN in {where}"
        check(not bool(torch.isfinite(nan_v[lane]).all())
              and not bool(torch.isfinite(nan_tau[lane]).all()),
              f"{case}: the lane's v and tau are non-finite")
        check(bool(torch.equal(nan_v[others], clean_v[others])
                   and torch.equal(nan_tau[others], clean_tau[others])),
              f"{case}: every other lane equals the clean run bit for bit")
        ref_v, _ = admm_kernel.admm_stage_reference(*bad, **kw, matmul=matmul)
        check(not bool(torch.isfinite(ref_v[lane]).all()),
              f"{case}: the plain version poisons the lane too")


def tc_entry(cases: list, timed_args, kw, shape, path=None) -> dict:
    """Times both modes on ``timed_args``; the entry's top-level numbers are
    those of "delta", the mode of the path (bench.py's), and of all cases."""
    m, n = shape
    B = timed_args[0].shape[0]
    modes = {}
    for matmul in TC_MODES:
        kernel_ms = median_ms(lambda: admm_kernel.admm_stage(*timed_args, **kw, matmul=matmul),
                              2, 7)
        plain_ms = median_ms(
            lambda: admm_kernel.admm_stage_reference(*timed_args, **kw, matmul=matmul), 1, 3)
        bound = tc_bound(m, n, B, kw["iters"], matmul)
        modes[matmul] = {"kernel_ms": kernel_ms, "plain_ms": plain_ms, **bound,
                         "fraction_of_bound": bound["bound_ms"] / kernel_ms,
                         "tflops_tensor": bound["passes"] * 2 * m * n * B / (kernel_ms * 1e-3)
                         / 1e12}
    held = [c for c in cases if c["tolerance_rel"] is not None]
    delta = modes["delta"]
    entry = {"name": "admm_stage_tc", "shape": [m, n], "iters": kw["iters"], "batch_timed": B,
             "cases": cases, "nan_lane": "confined", "modes": modes,
             "max_rel_err": max(max(c["rel_err_v"], c["rel_err_tau"]) for c in held),
             "max_abs_err": max(c["max_abs_err"] for c in held),
             "kernel_ms": delta["kernel_ms"], "plain_ms": delta["plain_ms"],
             "bound_ms": delta["bound_ms"], "bound_by": delta["bound_by"],
             "library_ms": None}
    if path:
        entry["path"] = path
    return entry


def kernels_admm_stage_tc(problem) -> dict:
    """The tensor-core kernel at the fleet tick's (192, 128) against its plain
    version, both modes, B in TC_BATCHES: "split" over 25 iterations of
    stage_inputs; "delta" over its 3-pass first iteration and its first
    increment there, and over 25 iterations of the tick's own stages once it
    has settled (its increments from a cold random iterate are as large as the
    iterate, and two float32 orders part there by up to 0.21: reported, not
    held); a NaN lane confined in both modes; both modes timed at B 98304."""
    _, _, _, factors = stage_operators(problem)
    kw = dict(iters=STAGE_ITERS, alpha=ALPHA)
    cases = []
    for B in TC_BATCHES:
        args = stage_inputs(problem, factors, B, seed=B)
        check(bool(torch.isinf(args[4]).any()), "bounds include -inf rows")
        cases.append(tc_compare(args, kw, "split", TC_SPLIT_TOL, "stage_inputs"))
        cases.append(tc_compare(args, dict(kw, iters=1), "delta", TC_SPLIT_TOL, "stage_inputs"))
        cases.append(tc_compare(args, dict(kw, iters=2), "delta", TC_STEP_TOL, "stage_inputs"))
        if B == 4096:
            cases.append(tc_compare(args, kw, "delta", None, "stage_inputs", hold=False))
        del args
    for stage, (full, skw) in enumerate(capture_tick_stages(problem, TC_WARM_TICK), start=1):
        check(bool(torch.isinf(full[4]).any()), "the tick's bounds include -inf rows")
        for B in TC_BATCHES:
            args = lanes_of(full[:6], B) + tuple(full[6:])
            cases.append(tc_compare(args, dict(iters=skw["iters"], alpha=skw["alpha"]), "delta",
                                    TC_WARM_TOL, f"tick{TC_WARM_TICK}_stage{stage}"))
    del full
    nan_args = list(stage_inputs(problem, factors, 1000, seed=7))
    for matmul in TC_MODES:
        nan_confined(nan_args, kw, matmul, f"admm_stage_tc {matmul}")
    timed = stage_inputs(problem, factors, BATCH, seed=1)
    return tc_entry(cases, timed, kw, (M, N))


def kernels_admm_stage_tc_stack(seen) -> dict:
    """The tensor-core kernel at the stack MPC's (48, 32) against its plain
    version on the stack's own stage inputs (the cold tick's first stage, the
    warm tick's last): "split" over 25 iterations of both, "delta" over its
    first two iterations of the cold one and 25 of the warm one; timed on the
    warm one at the stack's width."""
    cases = []
    cold, warm = seen["mpc"][0], seen["mpc"][-1]
    for B in (STACK_LANES, 1000, 1):
        for name, (full, kw) in (("stack_tick1_stage1", cold), ("stack_tick2_stage4", warm)):
            args = lanes_of(full[:6], B) + tuple(full[6:])
            kw = dict(iters=kw["iters"], alpha=kw["alpha"])
            cases.append(tc_compare(args, kw, "split", TC_SPLIT_TOL, name))
            if name == "stack_tick1_stage1":
                cases.append(tc_compare(args, dict(kw, iters=1), "delta", TC_SPLIT_TOL, name))
                cases.append(tc_compare(args, dict(kw, iters=2), "delta", TC_STEP_TOL, name))
            else:
                cases.append(tc_compare(args, kw, "delta", TC_WARM_TOL, name))
    full, kw = warm
    return tc_entry(cases, full, dict(iters=kw["iters"], alpha=kw["alpha"]),
                    (STACK_M, STACK_N), path="stack")


def kernels_admm_lane_stack(seen) -> dict:
    """K2 on the stack WBC's own operators: one stage of 150 iterations."""
    cases, max_rel, max_abs = [], 0.0, 0.0
    for name, (full, kw) in {"stack_tick1_inner1": seen["lane"][0],
                             "stack_tick2_inner10": seen["lane"][-1]}.items():
        for B in (STACK_LANES, 1000, 1):
            args = lanes_of(full, B)
            v_k, x_k = lane_kernel.admm_lane_stage(*args, **kw)
            torch.cuda.synchronize()
            v_p, x_p = lane_kernel.admm_lane_stage_reference(*args, **kw)
            v_e, x_e = lane_kernel.admm_lane_stage_reference(*(a.double() for a in args), **kw)
            ev, ex = rel_err(v_k, v_p), rel_err(x_k, x_p)
            ea = max(float((v_k - v_p).abs().max()), float((x_k - x_p).abs().max()))
            ek = max(rel_err(v_k.double(), v_e), rel_err(x_k.double(), x_e))
            ep = max(rel_err(v_p.double(), v_e), rel_err(x_p.double(), x_e))
            cases.append({"inputs": name, "B": B, "rel_err_v": ev, "rel_err_x": ex,
                          "max_abs_err": ea, "rel_err_vs_float64": ek,
                          "plain_rel_err_vs_float64": ep})
            max_rel, max_abs = max(max_rel, ev, ex), max(max_abs, ea)
            check(bool(torch.isfinite(v_k).all() and torch.isfinite(x_k).all()),
                  f"{name}: kernel output finite at B={B}")
            check(ev <= REAL_OPERATOR_TOL and ex <= REAL_OPERATOR_TOL,
                  f"admm_lane_stage agrees with the plain version to {REAL_OPERATOR_TOL} on"
                  f" {name} at B={B}: v {ev}, x {ex}")
            # 150 iterations carry each order's rounding six times as far as
            # the loop's stages of 25: both are held to the float64 recursion
            # at the tolerance of the real operators
            check(max(ek, ep) <= REAL_OPERATOR_TOL,
                  f"{name}, B={B}: kernel and plain version within {REAL_OPERATOR_TOL} of"
                  f" the float64 recursion: kernel {ek}, plain {ep}")
    args, kw = seen["lane"][-1]
    kernel_ms = median_ms(lambda: lane_kernel.admm_lane_stage(*args, **kw), 2, 9)
    plain_ms = median_ms(lambda: lane_kernel.admm_lane_stage_reference(*args, **kw), 1, 3)
    B, m, n, iters = args[0].shape[0], WBC_M, WBC_N, kw["iters"]
    bound = fma_bound(profiling.admm_lane_cost(B, m, n, iters))
    return {
        "name": "admm_lane_stage", "path": "stack", "shape": [m, n], "iters": iters,
        **lane_kernel_residency(m, n), "fraction_of_bound": bound["bound_ms"] / kernel_ms,
        "batch_timed": B, "cases": cases, "max_rel_err": max_rel, "max_abs_err": max_abs,
        "tolerance_rel": REAL_OPERATOR_TOL, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        **bound, "library_ms": None,
    }


def kernels_chol_inverse_stack(seen) -> dict:
    """K3 at n = 29 on the stack plant's own mass matrices (cold and warm
    tick), held as on the whole-body loop's KKT matrices; timed beside the
    library pair."""
    cases, max_rel, max_abs = [], 0.0, 0.0
    for tick, ((K,), _) in enumerate(seen["minv"], start=1):
        out = chol_kernel.cholesky_inverse_lane(K)
        torch.cuda.synchronize()
        ref = chol_kernel.cholesky_inverse_lane_reference(K)
        ek, ep = f64_distance(out, ref, torch.linalg.inv(K.double()))
        e, ea = rel_err(out, ref), float((out - ref).abs().max())
        cases.append({"inputs": f"stack_mass_matrix_tick{tick}", "n": NV, "B": K.shape[0],
                      "rel_err": e, "rel_err_vs_float64": ek,
                      "plain_rel_err_vs_float64": ep, "max_abs_err": ea})
        max_rel, max_abs = max(max_rel, e), max(max_abs, ea)
        check(bool(torch.isfinite(out).all()), f"tick {tick}: M inverts finitely")
        check(e <= REL_TOL, f"tick {tick}: the stack's M^-1 agrees with the plain version"
                            f" to {REL_TOL}, got {e}")
        check(ek <= 4 * ep + REL_TOL, f"tick {tick}: on the stack's M the kernel is as close"
                                      f" to float64 as the plain version: {ek}, {ep}")
        check(bool(torch.equal(out, out.transpose(1, 2))), "symmetric bit for bit")
    (K,), _ = seen["minv"][-1]
    B, n = K.shape[0], K.shape[1]
    kernel_ms = median_ms(lambda: chol_kernel.cholesky_inverse_lane(K), 3, 11)
    plain_ms = median_ms(lambda: chol_kernel.cholesky_inverse_lane_reference(K), 1, 3)
    library_ms = median_ms(
        lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(K)[0]), 2, 9)
    bound = fma_bound(profiling.cholesky_inverse_cost(B, n))
    return {
        "name": "cholesky_inverse_lane", "path": "stack", "shape": [n, n], "batch_timed": B,
        **chol_kernel_residency(n), "fraction_of_bound": bound["bound_ms"] / kernel_ms,
        "cases": cases, "max_rel_err": max_rel, "max_abs_err": max_abs,
        "tolerance_rel": REL_TOL, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library_call": "torch.linalg.cholesky_ex + torch.cholesky_inverse", **bound,
    }


def raw_launch_ms(launch, count: int = SOLVE_RAW_LAUNCHES, reps: int = 7) -> float:
    """Device milliseconds of one launch: ``count`` launches back to back
    between two events, the median of ``reps``. A sleeping kernel holds the
    stream while the host enqueues them, so the host's launch rate is not
    what is timed."""
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(count):
            launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / count)
    return statistics.median(times)


def host_us_per_call(fn, calls: int = SOLVE_HOST_CALLS) -> float:
    """Host microseconds a call of ``fn``, on the host clock, with no
    synchronisation inside the timed calls."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def solve_timings(K, b) -> dict:
    """K4 at (K, b): one wrapper call between events, the raw kernel and the
    empty launch with its grid (each ``SOLVE_RAW_LAUNCHES`` back to back), and
    the wrapper's host microseconds a call."""
    B, n = K.shape[0], K.shape[1]
    lib = chol_kernel.build_chol_solve(n)
    out = torch.empty_like(b)
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        check(lib.blf_chol_solve_f32(K.data_ptr(), b.data_ptr(), out.data_ptr(), B, n,
                                     stream) == 0, "raw K4 launch")

    def empty():
        check(lib.blf_chol_solve_empty(B, stream) == 0, "empty launch")

    return {"kernel_ms": median_ms(lambda: chol_kernel.cholesky_solve_lane(K, b), 5, 21),
            "raw_ms": raw_launch_ms(raw), "launch_floor_ms": raw_launch_ms(empty),
            "host_us_per_call": host_us_per_call(lambda: chol_kernel.cholesky_solve_lane(K, b))}


def kernels_chol_solve(seen) -> dict:
    """K4 against its plain version at n in SOLVE_SIZES and on the stack's own
    normal equations; NaN and non-SPD lanes stay local; timed at the stack's
    (4096, 6, 6) beside the library pair, and at B = 1 (launch latency): one
    wrapper call between events, the raw kernel, the empty launch of its grid
    (the launch floor) and the wrapper's host time a call."""
    cases, max_rel, max_abs = [], 0.0, 0.0

    def compare(K, b, inputs, exact_factor):
        nonlocal max_rel, max_abs
        out = chol_kernel.cholesky_solve_lane(K, b)
        torch.cuda.synchronize()
        ref = chol_kernel.cholesky_solve_lane_reference(K, b)
        exact = torch.linalg.solve(K.double(), b.double()[..., None])[..., 0]
        e, ea = rel_err(out, ref), float((out - ref).abs().max())
        ek, ep = f64_distance(out, ref, exact)
        cases.append({"inputs": inputs, "n": K.shape[1], "B": K.shape[0], "rel_err": e,
                      "rel_err_vs_float64": ek, "plain_rel_err_vs_float64": ep,
                      "max_abs_err": ea})
        max_rel, max_abs = max(max_rel, e), max(max_abs, ea)
        check(bool(torch.isfinite(out).all()), f"{inputs}: solve finite")
        check(e <= REL_TOL, f"cholesky_solve_lane agrees with the plain version to {REL_TOL}"
                            f" on {inputs}, n={K.shape[1]}, B={K.shape[0]}: {e}")
        check(ek <= exact_factor * ep + REL_TOL,
              f"{inputs}: the kernel is as close to float64 as the plain version: {ek}, {ep}")

    for n in SOLVE_SIZES:
        for B in (STACK_LANES, 1000, 1):
            K = spd_batch(B, n, seed=100 + n)
            b = torch.as_tensor(np.random.default_rng(n).normal(size=(B, n)).astype(np.float32),
                                device=DEVICE)
            compare(K, b, "spd", 1.0)
    for inner in (0, len(seen["solve"]) - 1):
        (K, b), _ = seen["solve"][inner]
        compare(K, b, f"stack_attribution_{inner + 1}", 4.0)

    B, n = 1000, 6
    K = spd_batch(B, n, seed=3)
    b = torch.ones((B, n), device=DEVICE)
    clean = chol_kernel.cholesky_solve_lane(K, b)
    for where, lane in (("nan", 137), ("not_spd", 500)):
        bad = K.clone()
        if where == "nan":
            bad[lane, 4, 1] = float("nan")
            bad[lane, 1, 4] = float("nan")
        else:
            bad[lane, 3, 3] = -1.0
        out = chol_kernel.cholesky_solve_lane(bad, b)
        torch.cuda.synchronize()
        others = torch.ones(B, dtype=torch.bool, device=DEVICE)
        others[lane] = False
        check(bool(torch.isnan(out[lane]).all()), f"{where} lane: NaN in its whole x")
        check(bool(torch.equal(out[others], clean[others])),
              f"{where} lane: every other lane equals the clean run bit for bit")
        check(bool(torch.isnan(chol_kernel.cholesky_solve_lane_reference(bad, b)[lane]).all()),
              f"{where} lane: the plain version gives NaN in the whole lane too")

    (K, b), _ = seen["solve"][-1]
    B, n = K.shape[0], K.shape[1]
    plain_runs = chol_kernel.solve_reference_count()
    full = solve_timings(K, b)
    one = solve_timings(K[:1].contiguous(), b[:1].contiguous())
    check(chol_kernel.solve_reference_count() == plain_runs, "K4's timings ran the kernel only")
    plain_ms = median_ms(lambda: chol_kernel.cholesky_solve_lane_reference(K, b), 1, 5)
    library_ms = median_ms(lambda: torch.cholesky_solve(
        b[..., None], torch.linalg.cholesky_ex(K)[0])[..., 0], 3, 11)
    residency = {}
    for size in SOLVE_SIZES:
        attrs = chol_kernel.solve_kernel_attributes(size)
        spill = ptxas_spill_bytes(chol_kernel.SOLVE_SOURCE, {"CHOL_N": size})
        residency[size] = {"kernel_path": chol_kernel.solve_plan(size).path, **attrs,
                           "spill_bytes": spill}
        check(attrs["local_bytes"] == 0 and spill == 0, f"K4 at n = {size} spills nothing")
    return {
        "name": "cholesky_solve_lane", "path": "stack", "shape": [n, n], "batch_timed": B,
        "cases": cases, "nan_lane": "confined", "not_spd_lane": "confined",
        "max_rel_err": max_rel, "max_abs_err": max_abs, "tolerance_rel": REL_TOL,
        "plan": chol_kernel.solve_plan(n)._asdict(), **residency[n],
        "residency_by_n": residency,
        "kernel_ms": full["kernel_ms"], "raw_ms": full["raw_ms"],
        "launch_floor_ms": full["launch_floor_ms"], "host_us_per_call": full["host_us_per_call"],
        "kernel_ms_batch_1": one["kernel_ms"], "raw_ms_batch_1": one["raw_ms"],
        "launch_floor_ms_batch_1": one["launch_floor_ms"],
        "host_us_per_call_batch_1": one["host_us_per_call"], "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library_call": "torch.linalg.cholesky_ex + torch.cholesky_solve",
        **fma_bound(profiling.cholesky_solve_cost(B, n)),
    }


def foot_max_abs(a, b) -> float:
    """Largest absolute difference of two foot states over every field."""
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def foot_bound(fleet, steps: int) -> dict:
    """The least time of one rollout of ``fleet`` (``profiling.foot_rollout_cost``):
    each lane's state read and written once, the operands the kernel takes
    read once."""
    _, _, _, _, p0, R0, k, b, scal, _ = rollout_kernel.rollout_operands(
        fleet.cparams, fleet.fparams, fleet.state, fleet.null_position, fleet.null_rotation,
        fleet.dt)
    return fma_bound(profiling.foot_rollout_cost(
        fleet.state.position.shape[0], steps,
        operand_floats=sum(t.numel() for t in (p0, R0, k, b, scal))))


def foot_identify_segments(lanes: int = IDENT_LANES) -> dict:
    """K5 against its plain version on every input the identification path
    gives it: the fleet of ``identify`` (dt 0.1 ms, rho 1, per-lane (k, b),
    one (3,) null position), walked through its IDENT_SAMPLES segments of
    IDENT_STEPS steps by the kernel. At each segment the plain version runs
    from the kernel's state (``max_abs_err``), and the plain version's own
    walk along the path is held to the kernel's record (``path_max_abs``).
    The lanes are still moving, so each segment starts from a new state."""
    fleet = contact_identification_fleet(lanes, samples=IDENT_SAMPLES, seed=SEED,
                                         device=DEVICE, dtype=torch.float32)
    params = (fleet.cparams, fleet.fparams)
    null = (fleet.null_position, fleet.null_rotation)
    per_lane = rollout_kernel.rollout_operands(*params, fleet.state, *null, fleet.dt)[-1]
    check(per_lane == (False, False, True, True),
          f"identify's operands: one null pose for every lane, (k, b) per lane: {per_lane}")
    segment = lambda fn, state: fn(*params, state, *null, dt=fleet.dt, steps=IDENT_STEPS)
    state = alone = fleet.state
    worst, path, moved = 0.0, 0.0, 0.0
    for _ in range(IDENT_SAMPLES):
        out = segment(rollout_kernel.foot_rollout_fused, state)
        torch.cuda.synchronize()
        ref = segment(rollout_kernel.foot_rollout_fused_reference, state)
        alone = segment(rollout_kernel.foot_rollout_fused_reference, alone)
        check(all(bool(torch.isfinite(t).all()) for t in out), "identify: every lane finite")
        worst = max(worst, foot_max_abs(out, ref))
        path = max(path, foot_max_abs(out, alone))
        moved = max(moved, float(out.linear_velocity.abs().max()))
        state = out
    return {"inputs": "identify_segments", "B": lanes, "steps": IDENT_STEPS,
            "segments": IDENT_SAMPLES, "max_abs_err": worst, "path_max_abs": path,
            "max_linear_velocity": moved}


def kernels_foot_rollout() -> dict:
    """K5 against its plain version at the foot fleet's width, 10, 300 and
    1000 steps, scalar and per-lane (k, b), at an odd batch, and on every
    segment of the identification path; a NaN lane stays in its lane; timed
    at (65536, 1000) and (65536, 10)."""
    fleet = foot_drop_fleet(FOOT_LANES, seed=SEED, device=DEVICE, dtype=torch.float32)
    rng = np.random.default_rng(3)
    per_lane = fleet._replace(cparams=fleet.cparams._replace(
        spring_coeff=torch.as_tensor(rng.uniform(1e5, 3e5, (FOOT_LANES, 1)),
                                     dtype=torch.float32, device=DEVICE),
        damper_coeff=torch.as_tensor(rng.uniform(1e3, 3e3, (FOOT_LANES, 1)),
                                     dtype=torch.float32, device=DEVICE)))
    odd = per_lane._replace(
        cparams=per_lane.cparams._replace(
            spring_coeff=per_lane.cparams.spring_coeff[:FOOT_ODD_LANES],
            damper_coeff=per_lane.cparams.damper_coeff[:FOOT_ODD_LANES]),
        state=type(fleet.state)(*(t[:FOOT_ODD_LANES] for t in fleet.state)),
        null_position=fleet.null_position[:FOOT_ODD_LANES],
        null_rotation=fleet.null_rotation[:FOOT_ODD_LANES])

    def args(f):
        return f.cparams, f.fparams, f.state, f.null_position, f.null_rotation

    cases, max_abs = [], 0.0
    for name, f in (("scalar_kb", fleet), ("per_lane_kb", per_lane), ("odd_batch", odd)):
        for steps in FOOT_CHECK_STEPS:
            out = rollout_kernel.foot_rollout_fused(*args(f), dt=f.dt, steps=steps)
            torch.cuda.synchronize()
            ref = rollout_kernel.foot_rollout_fused_reference(*args(f), dt=f.dt, steps=steps)
            err = foot_max_abs(out, ref)
            cases.append({"inputs": name, "B": f.state.position.shape[0], "steps": steps,
                          "max_abs_err": err})
            max_abs = max(max_abs, err)
            check(all(bool(torch.isfinite(t).all()) for t in out),
                  f"{name}, {steps} steps: every lane finite")
            check(err <= FOOT_TOL, f"foot_rollout_fused agrees with the plain version to"
                                   f" {FOOT_TOL} on every field: {name}, {steps} steps: {err}")
    ident = foot_identify_segments()
    cases.append(ident)
    max_abs = max(max_abs, ident["max_abs_err"], ident["path_max_abs"])
    check(max(ident["max_abs_err"], ident["path_max_abs"]) <= FOOT_TOL,
          f"foot_rollout_fused agrees with the plain version to {FOOT_TOL} on every field"
          f" of every identify segment, and along the whole path: {ident}")

    lane = FOOT_LANES // 3
    bad_state = type(fleet.state)(*(t.clone() for t in fleet.state))
    bad_state.rotation[lane, 2, 2] = float("nan")
    bad = per_lane._replace(state=bad_state)
    clean = rollout_kernel.foot_rollout_fused(*args(per_lane), dt=fleet.dt, steps=FOOT_NAN_STEPS)
    poisoned = rollout_kernel.foot_rollout_fused(*args(bad), dt=fleet.dt, steps=FOOT_NAN_STEPS)
    torch.cuda.synchronize()
    others = torch.ones(FOOT_LANES, dtype=torch.bool, device=DEVICE)
    others[lane] = False
    for a, b in zip(poisoned, clean):
        check(bool(torch.isnan(a[lane]).all()), "NaN lane: NaN in every field of its state")
        check(bool(torch.equal(a[others], b[others])),
              "NaN lane: every other lane equals the clean run bit for bit")

    kernel_ms = median_ms(lambda: rollout_kernel.foot_rollout_fused(
        *args(fleet), dt=fleet.dt, steps=FOOT_STEPS), 2, 11)
    short_ms = median_ms(lambda: rollout_kernel.foot_rollout_fused(
        *args(fleet), dt=fleet.dt, steps=IDENT_STEPS), 5, 21)
    # the same launches without the wrapper: its operands made once, the
    # library called directly (what the card takes; the rest is host work)
    tensors, scalars, k_value, b_value, flags = rollout_kernel.launch_operands(
        *args(fleet), fleet.dt)
    lib = rollout_kernel.build_foot_rollout()
    raw_out = torch.empty(18 * FOOT_LANES, device=DEVICE)

    def raw(steps):
        check(lib.blf_foot_rollout_f32(
            *[None if t is None else t.data_ptr() for t in tensors], scalars, k_value, b_value,
            raw_out.data_ptr(), FOOT_LANES, steps, *map(int, flags),
            torch.cuda.current_stream().cuda_stream) == 0, "raw K5 launch")

    raw_ms = median_ms(lambda: raw(FOOT_STEPS), 2, 11)
    raw_short_ms = median_ms(lambda: raw(IDENT_STEPS), 5, 21)
    plain_ms = median_ms(lambda: rollout_kernel.foot_rollout_fused_reference(
        *args(fleet), dt=fleet.dt, steps=FOOT_STEPS), 0, 3)
    bound = foot_bound(fleet, FOOT_STEPS)
    ops = FOOT_LANES * FOOT_STEPS * FOOT_OPS_PER_LANE_STEP
    return {
        "name": "foot_rollout_fused", "path": "foot", "shape": [FOOT_LANES, FOOT_STEPS],
        "cases": cases, "nan_lane": "confined", "max_abs_err": max_abs, "max_rel_err": None,
        "tolerance_abs": FOOT_TOL, "kernel_ms": kernel_ms, "kernel_ms_10_steps": short_ms,
        "raw_launch_ms": raw_ms, "raw_launch_ms_10_steps": raw_short_ms,
        **ptxas_residency(rollout_kernel.SOURCE, {}), "shared_bytes": 0,
        "plain_ms": plain_ms, "library_ms": None,
        **bound, "bound_ms_10_steps": foot_bound(fleet, IDENT_STEPS)["bound_ms"],
        "ops_per_lane_step": FOOT_OPS_PER_LANE_STEP,
        "tops": ops / (kernel_ms * 1e-3) / 1e12,
        "lane_steps_per_s": FOOT_LANES * FOOT_STEPS / (kernel_ms * 1e-3),
    }


def phase_kernels(problem, device: dict) -> dict:
    """Every kernel of every path against its plain version on the card, at
    each path's shapes; keyed ``name`` (the fleet tick's and the whole-body
    loop's shapes) or ``name@stack``."""
    seen = capture_wbc_stage_inputs(WBC_LANES)
    entries = [kernels_admm_stage(problem), kernels_admm_stage_tc(problem),
               kernels_admm_lane(seen, device["max_sm_clock_mhz"] * 1e6, device["sm_count"]),
               kernels_chol_lane(seen)]
    del seen
    stack_seen = capture_stack_inputs(STACK_LANES)
    entries += [kernels_admm_stage_stack(stack_seen), kernels_admm_stage_tc_stack(stack_seen),
                kernels_admm_lane_stack(stack_seen), kernels_chol_inverse_stack(stack_seen),
                kernels_chol_solve(stack_seen)]
    del stack_seen
    entries.append(kernels_foot_rollout())
    entries.append(kernels_admm_stage_l2())
    entries.append(kernels_admm_stage_tc_l2())
    for name, odd in f32_odd_n_cases().items():
        next(e for e in entries if e["name"] == name and e.get("path") != "stack")["odd_n"] = odd
    emit("kernels", kernels=entries)
    return {e["name"] + ("@stack" if e.get("path") == "stack" else ""): e for e in entries}


def all_finite(state) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in state)


def stage_counts() -> dict:
    """Launches of K1's resident kernels (the tensor-core one by mode), of its
    streaming tensor-core one by mode, and plain runs."""
    return {"f32": admm_kernel.launch_count(), "tc_delta": admm_kernel.tc_launch_count("delta"),
            "tc_split": admm_kernel.tc_launch_count("split"),
            "tc_l2_delta": admm_kernel.tc_l2_launch_count("delta"),
            "tc_l2_split": admm_kernel.tc_l2_launch_count("split"),
            "plain": admm_kernel.reference_count() + admm_kernel.tc_reference_count()}


def phase_tick(problem, kernel_ms: float, profile: bool, backend: str = "cuda") -> dict:
    """bench.py's workload, BATCH lanes, 20 warm-up ticks and SCANS timed scans
    of TICKS: phase ``tick`` on the f32 kernel (``backend="cuda"``, the
    reference's "pallas_f32"), phase ``tick_delta`` in bench.py's own mode
    (``"cuda_delta"``, the reference's "pallas", on the tensor-core kernel)."""
    phase = "tick" if backend == "cuda" else "tick_delta"
    counted = "f32" if backend == "cuda" else "tc_delta"
    batch, ticks, scans = BATCH, TICKS, SCANS
    torch.cuda.reset_peak_memory_stats()      # the tick's own peak, not the kernels phase's
    state = init_fleet(batch, HORIZON, problem.num_constraints, problem.dcm0,
                       problem.com0, device=DEVICE, dtype=torch.float32)
    step = make_fleet_step(problem.params, problem.dt, iterations=2 * STAGE_ITERS,
                           backend=backend, device=DEVICE)
    refs = (problem.dcm_ref, problem.zmp_ref, problem.poly_A, problem.poly_b)

    converged_by_tick = []

    def run(state, n):
        result = None
        for _ in range(n):
            state, result = step(state, problem.disturbance, *refs)
            converged_by_tick.append(result.stats.num_converged)
        return state, result

    admm_kernel.reset_counts()            # counts of the main path start here
    state, result = run(state, ticks)     # warm-up: reach the warm-started steady state
    torch.cuda.synchronize()
    scan_ms = []   # per tick, one entry a scan
    for _ in range(scans):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, result = run(state, ticks)
        end.record()
        torch.cuda.synchronize()
        scan_ms.append(start.elapsed_time(end) / ticks)
    counts = stage_counts()                # read just after the main path
    launches = counts[counted]
    n_ticks = ticks * (1 + scans)

    telemetry = TelemetryStream(sink=sys.stderr, name="chip_smoke_fleet")
    record = telemetry.publish({
        "scenarios": result.stats.num_scenarios,
        "converged": result.stats.num_converged,
        "max_primal_residual": result.stats.max_primal_residual,
        "max_dual_residual": result.stats.max_dual_residual,
        "mean_objective": result.stats.mean_objective,
        "worst_margin": result.worst_margin,
        "quarantined": result.num_quarantined,
    }, step=n_ticks)
    statuses = status_counts(result.status)

    check(all_finite(state), "every state field is finite")
    check(record["quarantined"] == 0, f"no lane quarantined, got {record['quarantined']}")
    check(record["scenarios"] == batch, "num_scenarios equals the batch")
    check(record["converged"] >= 0.99 * batch,
          f"at least 99% of lanes converged on the last tick, got {record['converged']}/{batch}")
    by_tick = [int(c) for c in torch.stack(converged_by_tick).tolist()]
    first_ticks = by_tick[:ticks]
    min_timed = min(by_tick[ticks:])
    worst_tick = min(range(n_ticks), key=by_tick.__getitem__)
    if backend == "cuda":
        check(by_tick[worst_tick] >= 0.99 * batch,
              f"at least 99% of lanes converged on every one of the {n_ticks} ticks, the"
              f" first included: worst is tick {worst_tick + 1} with"
              f" {by_tick[worst_tick]}/{batch}; first ticks {first_ticks}")
    else:
        # the cold first tick again, with the stage's plain version swapped in
        # (after the main path's counts were read)
        with mock.patch.object(qp_module, "admm_stage", admm_kernel.admm_stage_reference):
            cold = init_fleet(batch, HORIZON, problem.num_constraints, problem.dcm0,
                              problem.com0, device=DEVICE, dtype=torch.float32)
            plain_first = int(step(cold, problem.disturbance, *refs)[1].stats.num_converged)
        later = min(range(1, n_ticks), key=by_tick.__getitem__)
        check(by_tick[0] >= TICK_DELTA_FIRST_SHARE * batch,
              f"at least {TICK_DELTA_FIRST_SHARE:.0%} of lanes converged on the cold first"
              f" tick, got {by_tick[0]}/{batch}")
        check(by_tick[0] >= plain_first - TICK_DELTA_FIRST_SLACK * batch,
              f"the cold first tick converges as many lanes as with the stage's plain"
              f" version, less {TICK_DELTA_FIRST_SLACK:.1%}: {by_tick[0]} against {plain_first}")
        check(by_tick[later] >= 0.99 * batch,
              f"at least 99% of lanes converged on every one of ticks 2-{n_ticks}: worst is"
              f" tick {later + 1} with {by_tick[later]}/{batch}; first ticks {first_ticks}")
    check(launches == 2 * n_ticks,
          f"exactly 2 kernel launches per tick: {launches} in {n_ticks} ticks")
    check(sum(counts.values()) == launches,
          f"no other kernel of K1 launched and no plain version ran: {counts}")
    check(tuple(result.consensus_zmp0.shape) == (batch, 2), "consensus plan shape")

    # where the tick's time goes: the factorization alone (host clock, it ends
    # in a synchronising eigh), the kernel (2 launches, timed in `kernels`)
    P, A, is_eq, _ = stage_operators(problem)
    factor_ms = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        factor_shared_qp(P, A, is_eq)
        torch.cuda.synchronize()
        factor_ms.append(1e3 * (time.perf_counter() - t0))
    tick_ms = sum(scan_ms) / scans    # all timed milliseconds over all timed ticks
    factor = statistics.median(factor_ms[2:])
    out = {
        "batch": batch, "horizon": HORIZON, "admm_iterations": 2 * STAGE_ITERS,
        "dtype": "float32", "backend": backend, "ticks_per_scan": ticks, "scans": scans,
        "tick_ms": tick_ms, "tick_ms_scan_median": statistics.median(scan_ms),
        "tick_ms_min": min(scan_ms), "tick_ms_max": max(scan_ms),
        "solves_per_s": batch / (tick_ms * 1e-3),
        "kernel_ms_per_tick": 2 * kernel_ms, "factor_ms_per_tick": factor,
        "share_kernel": 2 * kernel_ms / tick_ms, "share_factor": factor / tick_ms,
        "share_rest": 1.0 - (2 * kernel_ms + factor) / tick_ms,
        "num_converged": record["converged"], "num_quarantined": record["quarantined"],
        "max_primal_residual": record["max_primal_residual"],
        "max_dual_residual": record["max_dual_residual"],
        "worst_margin": record["worst_margin"], "status_counts": statuses,
        "converged_first_ticks": first_ticks, "converged_min_timed_ticks": min_timed,
        "converged_min_all_ticks": by_tick[worst_tick], "worst_tick": worst_tick + 1,
        "kernel_launches": launches, "launches_per_tick": launches / n_ticks,
        "stage_counts": counts,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if backend != "cuda":
        out["converged_first_tick_plain_version"] = plain_first
    if profile:
        out["profile"] = profile_ticks(run, state)
        out["device_idle_share"] = 1.0 - out["profile"]["device_ms_per_tick"] / tick_ms
    emit(phase, **out)
    return out


def profile_ticks(run, state) -> dict:
    """Device time by kernel over two ticks, if the profiler can see the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(state, 2)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    # rows of the device itself (kernels, copies), not of the operators above them
    rows = [(e.key, e.self_device_time_total / 2e3, e.count / 2)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return {"device_ms_per_tick": sum(r[1] for r in rows),
            "kernels_per_tick": sum(r[2] for r in rows),
            "top": [{"name": k[:60], "ms": round(ms, 3), "calls": c}
                    for k, ms, c in rows[:8]]}


def lane_diffs(state_a, result_a, state_b, result_b) -> dict:
    """Per-lane max |difference| of the plan, the advanced DCM and the duals."""
    return {
        "consensus_zmp0": (result_a.consensus_zmp0 - result_b.consensus_zmp0).abs().amax(dim=-1),
        "dcm": (state_a.dcm - state_b.dcm).abs().amax(dim=-1),
        "warm_y": (state_a.warm_y - state_b.warm_y).abs().amax(dim=-1),
    }


def phase_cross(problem) -> dict:
    """The kernel backend against the plain-tensor backend, both on the card.

    Two comparisons over ``CROSS_TICKS`` ticks of ``CROSS_LANES`` lanes:

    * *one tick from the same state*: at every tick the plain-tensor backend
      takes one step from the very state the kernel fleet is in, and the two
      results are compared on every lane. This isolates what the backend
      changes in a tick from what the fleets' histories differ by.
    * *independent fleets*: each backend runs its own fleet from the same cold
      start, and the fleets are compared tick by tick.

    From the same state the two backends are one computation in two
    evaluation orders, so that comparison is held on every tick, on every
    lane, converged or not: ``SAME_STATE_TOL`` absolute and identical per-lane
    status. The independent fleets are held to the same, with every lane
    converged, on every tick outside ``PARTED_TICKS``. On ticks 4 and 5 a few
    lanes of 4096 miss the tolerance within 50 iterations, and where such a
    lane stops depends on rounding-level differences of the state it started
    from, so the fleets part by up to 1e-4 (in ``warm_y``) and the closed loop
    then draws them together again, under 1e-5 from tick 9. There they are
    held to ``PARTED_TOL`` on every lane with at most ``PARTED_SHARE`` of the
    lanes unconverged or of differing status.
    """
    lanes, ticks = CROSS_LANES, CROSS_TICKS
    refs = (problem.dcm_ref, problem.zmp_ref, problem.poly_A, problem.poly_b)
    dist = problem.disturbance[:lanes].contiguous()

    def fleet(backend, **extra):
        state = init_fleet(lanes, HORIZON, problem.num_constraints, problem.dcm0,
                           problem.com0, device=DEVICE, dtype=torch.float32)
        step = make_fleet_step(problem.params, problem.dt, iterations=2 * STAGE_ITERS,
                               backend=backend, device=DEVICE, **extra)
        return state, step

    state_c, step_c = fleet("cuda")
    state_t, step_t = fleet("torch", refine=False)
    per_tick = []
    for k in range(1, ticks + 1):
        same_state, same_result = step_t(state_c, dist, *refs)   # from the kernel fleet's state
        state_c, result_c = step_c(state_c, dist, *refs)
        state_t, result_t = step_t(state_t, dist, *refs)
        rec = {"tick": k}
        for name, (st, rt) in (("same_state", (same_state, same_result)),
                               ("independent", (state_t, result_t))):
            diffs = lane_diffs(state_c, result_c, st, rt)
            both = (result_c.status == 0) & (rt.status == 0)
            rec[name] = {
                "max_abs_diff": {n: float(d.max()) for n, d in diffs.items()},
                "max_abs_diff_both_converged": {
                    n: float(d[both].max()) if bool(both.any()) else 0.0
                    for n, d in diffs.items()},
                "both_converged": int(both.sum()),
                "status_mismatches": int((result_c.status != rt.status).sum()),
                "converged": [int((r.status == 0).sum()) for r in (result_c, rt)],
                "finite": all_finite(state_c) and all_finite(st),
            }
        rec["max_dual_residual"] = [float(r.stats.max_dual_residual)
                                    for r in (result_c, result_t)]
        per_tick.append(rec)
    out = emit("cross", lanes=lanes, ticks=per_tick, tolerance_abs_same_state=SAME_STATE_TOL,
               tolerance_abs_independent=SAME_STATE_TOL,
               parted_ticks=[PARTED_TICKS.start, PARTED_TICKS.stop - 1],
               tolerance_abs_independent_parted=PARTED_TOL,
               status_counts=status_counts(result_c.status))
    for rec in per_tick:
        k = rec["tick"]
        for name in ("same_state", "independent"):
            cmp, what = rec[name], f"tick {k}, {name}"
            parted = name == "independent" and k in PARTED_TICKS
            tol = PARTED_TOL if parted else SAME_STATE_TOL
            check(cmp["finite"], f"{what}: both states finite")
            for field, dv in cmp["max_abs_diff"].items():
                check(dv <= tol, f"{what}: every lane agrees on {field} to {tol}, got {dv}")
            if parted:
                check(cmp["status_mismatches"] <= PARTED_SHARE * lanes
                      and min(cmp["converged"]) >= (1 - PARTED_SHARE) * lanes,
                      f"{what}: at most {PARTED_SHARE:.0%} of lanes unconverged or of"
                      f" differing status")
            else:
                check(cmp["status_mismatches"] == 0, f"{what}: identical per-lane status")
            if name == "independent" and not parted:
                check(cmp["converged"] == [lanes, lanes], f"{what}: every lane converged")
    return out


def phase_cross_delta(problem) -> dict:
    """bench.py's mode against its plain version and against the f32 kernel,
    one tick from the same state: CROSS_TICKS ticks of CROSS_LANES lanes, the
    fleet advanced by ``"cuda_delta"`` on the tensor-core kernel. At every tick
    the same mode with the stage's plain version swapped in, and
    ``backend="cuda"``, each take one step from that very state.

    * Kernel against plain version: one computation in two float32 summation
      orders, held on every lane of every tick to CROSS_DELTA_TOL on the plan,
      the advanced DCM and the duals, with identical per-lane status from tick
      2 on; on the cold first tick the delta mode leaves lanes at eps, where
      the flag flips between two orders (at most CROSS_DELTA_FIRST_MISMATCH).
    * "cuda_delta" against "cuda": the reference's contract for its reduced
      modes, converged counts within CROSS_F32_SHARE of the lanes and the plan
      within CROSS_F32_TOL on every lane where both converged.
    """
    lanes, ticks = CROSS_LANES, CROSS_TICKS
    refs = (problem.dcm_ref, problem.zmp_ref, problem.poly_A, problem.poly_b)
    dist = problem.disturbance[:lanes].contiguous()
    state = init_fleet(lanes, HORIZON, problem.num_constraints, problem.dcm0, problem.com0,
                       device=DEVICE, dtype=torch.float32)
    step_of = lambda backend: make_fleet_step(problem.params, problem.dt,
                                              iterations=2 * STAGE_ITERS, backend=backend,
                                              device=DEVICE)
    delta, exact = step_of("cuda_delta"), step_of("cuda")
    per_tick = []
    for k in range(1, ticks + 1):
        admm_kernel.reset_counts()
        nxt, res = delta(state, dist, *refs)
        kernel_counts = stage_counts()
        with mock.patch.object(qp_module, "admm_stage", admm_kernel.admm_stage_reference):
            plain_state, plain_res = delta(state, dist, *refs)
        f32_state, f32_res = exact(state, dist, *refs)
        diffs = lane_diffs(nxt, res, plain_state, plain_res)
        both = (res.status == 0) & (f32_res.status == 0)
        f32_plan = (res.consensus_zmp0 - f32_res.consensus_zmp0).abs().amax(dim=-1)
        per_tick.append({
            "tick": k, "kernel_counts": kernel_counts,
            "plain": {"max_abs_diff": {n: float(d.max()) for n, d in diffs.items()},
                      "status_mismatches": int((res.status != plain_res.status).sum()),
                      "converged": [int((r.status == 0).sum()) for r in (res, plain_res)]},
            "f32": {"converged": [int((r.status == 0).sum()) for r in (res, f32_res)],
                    "both_converged": int(both.sum()),
                    "max_abs_diff_plan_both_converged":
                        float(f32_plan[both].max()) if bool(both.any()) else 0.0},
            "finite": all_finite(nxt) and all_finite(plain_state) and all_finite(f32_state),
        })
        state = nxt
    out = emit("cross_delta", lanes=lanes, ticks=per_tick, tolerance_abs_plain=CROSS_DELTA_TOL,
               first_tick_status_mismatch_share=CROSS_DELTA_FIRST_MISMATCH,
               f32_converged_share=CROSS_F32_SHARE, tolerance_abs_f32=CROSS_F32_TOL,
               status_counts=status_counts(res.status))
    for rec in per_tick:
        k, cmp = rec["tick"], rec["plain"]
        check(rec["finite"], f"cross_delta tick {k}: every state finite")
        check(rec["kernel_counts"] == {"f32": 0, "tc_delta": 2, "tc_split": 0, "tc_l2_delta": 0,
                                       "tc_l2_split": 0, "plain": 0},
              f"cross_delta tick {k}: the fleet's step is 2 tensor-core launches")
        for field, dv in cmp["max_abs_diff"].items():
            check(dv <= CROSS_DELTA_TOL,
                  f"cross_delta tick {k}: the kernel agrees with the plain version on {field}"
                  f" to {CROSS_DELTA_TOL} on every lane, got {dv}")
        allowed = CROSS_DELTA_FIRST_MISMATCH * lanes if k == 1 else 0
        check(cmp["status_mismatches"] <= allowed,
              f"cross_delta tick {k}: at most {allowed:.0f} lanes of differing status against"
              f" the plain version, got {cmp['status_mismatches']}")
        conv = rec["f32"]["converged"]
        check(conv[0] >= conv[1] - CROSS_F32_SHARE * lanes,
              f"cross_delta tick {k}: 'cuda_delta' converges within {CROSS_F32_SHARE:.1%} of"
              f" the lanes of 'cuda': {conv}")
        dv = rec["f32"]["max_abs_diff_plan_both_converged"]
        check(dv <= CROSS_F32_TOL,
              f"cross_delta tick {k}: the plan within {CROSS_F32_TOL} of 'cuda' where both"
              f" converged, got {dv}")
    return out


def phase_wbc(kernels: dict, profile: bool) -> dict:
    """The whole-body-control loop: WBC_LANES humanoids balance for 30 ticks at
    100 Hz; every tick builds each lane's QP, solves it warm-started on the
    two kernels and advances the plant by RK4."""
    lanes, n_ticks = WBC_LANES, WBC_SCANS * WBC_TICKS
    stages = WBC_ITERS // WBC_STAGE
    torch.cuda.reset_peak_memory_stats()
    fleet = standing_fleet(lanes, seed=SEED, device=DEVICE, dtype=torch.float32)
    state, warm, sol = fleet.state, None, None
    converged, trace, scan_ms = [], [], []

    lane_kernel.reset_counts()            # counts of this path start here
    chol_kernel.reset_counts()
    for _ in range(WBC_SCANS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(WBC_TICKS):
            state, sol, warm = wbc_step(fleet, state, warm)
            converged.append(sol.qp.converged.sum())
            trace.append(torch.stack([
                sol.qp.primal_residual.max(), sol.qp.primal_residual.median(),
                sol.qp.dual_residual.max(), sol.qp.dual_residual.median(),
                sol.qp.rho_scale.min(), sol.qp.rho_scale.max()]))
        end.record()
        torch.cuda.synchronize()
        scan_ms.append(start.elapsed_time(end) / WBC_TICKS)
    launches = {"admm_lane_stage": lane_kernel.launch_count(),     # read just after the path
                "cholesky_inverse_lane": chol_kernel.launch_count()}
    plain_runs = lane_kernel.reference_count() + chol_kernel.reference_count()

    by_tick = [int(c) for c in torch.stack(converged).tolist()]
    poses = forward_kinematics(fleet.tree, state.base_position, state.base_rotation,
                               state.joint_positions)
    com_drift = float((rb.com_position(fleet.tree, poses) - fleet.com_ref).abs().max())
    max_twist = float(state.base_twist.abs().max())
    min_upright = float(state.base_rotation[:, 2, 2].min())
    rp, rd = sol.qp.primal_residual, sol.qp.dual_residual

    check(all_finite(state) and bool(torch.isfinite(sol.qp.x).all()),
          "every state field and the last solution are finite on every lane")
    # what the reference's own closed-loop test asserts, on every lane
    check(com_drift < 0.02, f"every lane's CoM within 0.02 m of its start, got {com_drift}")
    check(max_twist < 0.5, f"every lane's base twist under 0.5, got {max_twist}")
    check(min_upright > 0.99, f"every lane's base upright (R[2,2] > 0.99), got {min_upright}")
    check(launches == {"admm_lane_stage": stages * n_ticks,
                       "cholesky_inverse_lane": stages * n_ticks},
          f"exactly {stages} launches of each kernel a tick: {launches} in {n_ticks} ticks")
    check(plain_runs == 0, "the plain versions never ran on this path")
    check(tuple(sol.torques.shape) == (lanes, 23) and tuple(sol.wrenches.shape) == (lanes, 2, 6),
          "solution shapes")

    # where the tick's time goes: the three parts alone, from the last state
    task = balance_task(fleet, state)
    qp = build_wholebody_qp(fleet.tree, fleet.params, state, task)
    solve = lambda: solve_qp(*qp, iterations=WBC_ITERS, check_every=WBC_STAGE,
                             x0=warm.x, y0=warm.y, s0=warm.s, eps_abs=WBC_EPS,
                             eps_rel=WBC_EPS, backend="cuda")
    build_ms = median_ms(
        lambda: build_wholebody_qp(fleet.tree, fleet.params, state, balance_task(fleet, state)),
        1, 3)
    solve_ms = median_ms(solve, 1, 3)
    plant_ms = median_ms(lambda: apply_solution(fleet, state, sol), 1, 3)
    k2 = stages * kernels["admm_lane_stage"]["kernel_ms"]
    k3 = stages * kernels["cholesky_inverse_lane"]["kernel_ms"]
    tick_ms = statistics.median(scan_ms)
    out = {
        "lanes": lanes, "robot": "humanoid_23dof", "qp_shape": [WBC_M, WBC_N],
        "ticks": n_ticks, "iterations": WBC_ITERS, "stage": WBC_STAGE, "eps": WBC_EPS,
        "dtype": "float32", "backend": "cuda",
        "tick_ms": tick_ms, "tick_ms_min": min(scan_ms), "tick_ms_max": max(scan_ms),
        "lane_ticks_per_s": lanes / (tick_ms * 1e-3),
        "build_ms": build_ms, "solve_ms": solve_ms, "plant_ms": plant_ms,
        "solve_k2_ms": k2, "solve_k3_ms": k3, "solve_rest_ms": solve_ms - k2 - k3,
        "share_build": build_ms / tick_ms, "share_solve": solve_ms / tick_ms,
        "share_plant": plant_ms / tick_ms,
        "converged_by_tick": by_tick, "converged_last_tick": by_tick[-1],
        "by_tick_columns": ["max_rp", "median_rp", "max_rd", "median_rd", "min_s", "max_s"],
        "by_tick": [[float(f"{v:.3g}") for v in row] for row in torch.stack(trace).tolist()],
        "wbc_max_rp": float(rp.max()), "wbc_median_rp": float(rp.median()),
        "wbc_max_rd": float(rd.max()), "wbc_median_rd": float(rd.median()),
        "com_drift_m": com_drift, "max_base_twist": max_twist, "min_upright": min_upright,
        "kernel_launches": launches, "launches_per_tick": stages, "plain_version_runs": plain_runs,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if profile:
        def run(st, n):
            w = warm
            for _ in range(n):
                st, _, w = wbc_step(fleet, st, w)
            return st, None
        out["profile"] = profile_ticks(run, state)
        out["device_idle_share"] = 1.0 - out["profile"]["device_ms_per_tick"] / tick_ms
    emit("wbc", **out)
    check(min(by_tick[:WBC_SETTLED_TICKS]) >= WBC_SETTLED_SHARE * lanes,
          f"at least {WBC_SETTLED_SHARE:.0%} of lanes converged on each of the first"
          f" {WBC_SETTLED_TICKS} ticks, got {by_tick[:WBC_SETTLED_TICKS]}")
    check(by_tick[-1] >= WBC_LAST_SHARE * lanes,
          f"at least {WBC_LAST_SHARE:.0%} of lanes converged on the last tick,"
          f" got {by_tick[-1]}/{lanes}")
    return out


def phase_wbc_cross() -> dict:
    """One ``solve_qp_lanes`` call from the same inputs on the card (the two
    kernels) and on the CPU (their plain versions), float32: the first tick's
    whole-body QP of WBC_CROSS_LANES lanes, cold. One solve from one state, not
    a trajectory: two float32 fleets part where lanes miss the tolerance."""
    lanes = WBC_CROSS_LANES
    fleet = standing_fleet(lanes, seed=SEED + 1, device=DEVICE, dtype=torch.float32)
    qp = build_wholebody_qp(fleet.tree, fleet.params, fleet.state,
                            balance_task(fleet, fleet.state))
    kw = dict(iterations=WBC_ITERS, check_every=WBC_STAGE, eps_abs=WBC_EPS, eps_rel=WBC_EPS)
    card = solve_qp_lanes(*qp, **kw)
    torch.cuda.synchronize()
    before = lane_kernel.reference_count()
    host = solve_qp_lanes(*(t.cpu() for t in qp), **kw)
    check(lane_kernel.reference_count() == before + WBC_ITERS // WBC_STAGE,
          "the CPU solve ran the plain versions")
    both = card.converged.cpu() & host.converged
    dx = (card.x.cpu() - host.x).abs().amax(dim=-1)
    n_card, n_host, n_both = int(card.converged.sum()), int(host.converged.sum()), int(both.sum())
    out = emit(
        "wbc_cross", lanes=lanes, iterations=WBC_ITERS, eps=WBC_EPS,
        converged_card=n_card, converged_cpu=n_host, converged_both=n_both,
        max_abs_dx_both_converged=float(dx[both].max()) if n_both else None,
        max_abs_dx_all_lanes=float(dx.max()), tolerance_abs=WBC_CROSS_TOL,
        max_rp=[float(card.primal_residual.max()), float(host.primal_residual.max())],
        max_rd=[float(card.dual_residual.max()), float(host.dual_residual.max())])
    check(bool(torch.isfinite(card.x).all()) and bool(torch.isfinite(host.x).all()),
          "both solutions finite")
    check(n_both >= 0.9 * lanes, f"most lanes converged on both, got {n_both}/{lanes}")
    check(abs(n_card - n_host) <= 0.01 * lanes,
          f"converged counts within 1% of each other: card {n_card}, CPU {n_host}")
    check(float(dx[both].max()) <= WBC_CROSS_TOL,
          f"x agrees to {WBC_CROSS_TOL} on every lane converged on both,"
          f" got {float(dx[both].max())}")
    return out


def part_ms(log: profiling.Recording, prefix: str, parts) -> dict:
    """Device milliseconds of each span ``<prefix>.<part>`` of a recording
    (``profiling.recording``: CUDA events at both ends), summed over its calls."""
    summary = log.summary()
    return {part: summary.get(f"{prefix}.{part}", {"device_ms": 0.0})["device_ms"]
            for part in parts}


def stack_tick_record(trace) -> dict:
    """One outer tick's convergence, as tensors (read after the timed run)."""
    return {"status": trace.status, "mpc": trace.mpc_converged.sum(),
            "wbc": trace.wbc_converged.sum(),
            "rp": torch.stack([trace.wbc_max_rp.max(), trace.wbc_max_rp.median()]),
            "rd": torch.stack([trace.wbc_max_rd.max(), trace.wbc_max_rd.median()])}


def phase_stack(profile: bool) -> dict:
    """The control stack over STACK_LANES pushed humanoids: STACK_WARM_TICKS
    outer ticks, then STACK_TIMED_TICKS more, each timed alone by CUDA events
    with the split by part; 1 s of simulated time in all, as the JAX
    package's stack bench runs it."""
    torch.cuda.reset_peak_memory_stats()
    problem = push_recovery_stack(STACK_LANES, seed=SEED, device=DEVICE, dtype=torch.float32)
    step = stack_fleet_step(problem)
    state, records, tick_ms = problem.state, [], []
    counted = (admm_kernel, lane_kernel, chol_kernel)
    for module in counted:                # counts of this path start here
        module.reset_counts()
    for _ in range(STACK_WARM_TICKS):
        state, trace = step(state, problem.pushes, *problem.refs)
        records.append(stack_tick_record(trace))
    with profiling.recording() as log:
        for _ in range(STACK_TIMED_TICKS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, trace = step(state, problem.pushes, *problem.refs)
            end.record()
            records.append(stack_tick_record(trace))
            torch.cuda.synchronize()
            tick_ms.append(start.elapsed_time(end))
    launches = {"admm_stage_tc": admm_kernel.tc_launch_count("delta"),   # just after the path
                "admm_stage_tc_split": admm_kernel.tc_launch_count("split"),
                "admm_stage": admm_kernel.launch_count(),
                "admm_lane_stage": lane_kernel.launch_count(),
                "cholesky_inverse_lane_n64": chol_kernel.launch_count(WBC_N),
                "cholesky_inverse_lane_n29": chol_kernel.launch_count(NV),
                "cholesky_solve_lane": chol_kernel.solve_launch_count()}
    plain_runs = (sum(m.reference_count() for m in counted) + admm_kernel.tc_reference_count()
                  + chol_kernel.solve_reference_count())
    n_ticks = STACK_WARM_TICKS + STACK_TIMED_TICKS
    expected = {"admm_stage_tc": STACK_MPC_STAGES * n_ticks, "admm_stage_tc_split": 0,
                "admm_stage": 0,
                "admm_lane_stage": STACK_INNER * n_ticks,
                "cholesky_inverse_lane_n64": STACK_INNER * n_ticks,
                "cholesky_inverse_lane_n29": n_ticks,
                "cholesky_solve_lane": STACK_INNER * n_ticks}
    split = {part: ms / STACK_TIMED_TICKS
             for part, ms in part_ms(log, "stack", stack_module.PARTS).items()}

    lanes = STACK_LANES
    statuses = torch.stack([r["status"] for r in records]).cpu()         # (ticks, lanes)
    converged = [int((row == 0).sum()) for row in statuses]
    quarantined = [int((row == 2).sum()) for row in statuses]
    p = state.plant
    est_err = (state.push_theta - problem.pushes).abs()
    est_limit = STACK_EST_REL * problem.pushes.abs() + STACK_EST_ABS
    dcm_err = float((trace.dcm - problem.stance).abs().max())
    upright = float(p.base_rotation[:, 2, 2].min())
    twist = float(p.base_twist.abs().max())
    med_ms = statistics.median(tick_ms)
    out = {
        "lanes": lanes, "robot": "humanoid_23dof", "config": "STACK_R05",
        "config_fields": problem.config._asdict(),
        "dtype": "float32", "ticks": n_ticks, "timed_ticks": STACK_TIMED_TICKS,
        "outer_tick_ms": med_ms, "outer_tick_ms_min": min(tick_ms),
        "outer_tick_ms_max": max(tick_ms), "outer_tick_ms_each": tick_ms,
        "outer_lane_ticks_per_s": lanes / (med_ms * 1e-3),
        "split_ms_per_tick": split, "split_sum_ms": sum(split.values()),
        "converged_by_tick": converged,
        "mpc_converged_by_tick": [int(r["mpc"]) for r in records],
        "wbc_converged_by_tick": [int(r["wbc"]) for r in records],
        "status_counts_by_tick": [status_counts(row) for row in statuses],
        "wbc_rp_max_median_by_tick": [[float(f"{v:.3g}") for v in r["rp"].tolist()]
                                      for r in records],
        "wbc_rd_max_median_by_tick": [[float(f"{v:.3g}") for v in r["rd"].tolist()]
                                      for r in records],
        "push_estimate_err_max_n": float(est_err.max()),
        "push_estimate_err_median_n": float(est_err.median()),
        "push_estimate_worst_margin_n": float((est_limit - est_err).min()),
        "dcm_err_max_m": dcm_err, "min_upright": upright, "max_base_twist": twist,
        "launches": launches, "launches_expected": expected, "plain_version_runs": plain_runs,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if profile:
        def run(st, n):
            for _ in range(n):
                st, _ = step(st, problem.pushes, *problem.refs)
            return st, None
        out["profile"] = profile_ticks(run, state)
        out["device_idle_share"] = 1.0 - out["profile"]["device_ms_per_tick"] / med_ms
    emit("stack", **out)
    check(all(all_finite(leaf) for leaf in (p, state.observer))
          and bool(torch.isfinite(state.push_theta).all()),
          "every lane's plant, observer and estimate finite")
    check(max(quarantined) == 0, f"no lane quarantined on any tick: {quarantined}")
    check(launches == expected, f"kernel launches as the configuration implies: {launches}"
                                f" against {expected}")
    check(plain_runs == 0, "the plain versions never ran on this path")
    # what the reference's own closed-loop test asserts, on every lane
    check(upright > STACK_UPRIGHT, f"every lane upright (R[2,2] > {STACK_UPRIGHT}): {upright}")
    check(twist < STACK_TWIST, f"every lane's base twist under {STACK_TWIST}: {twist}")
    check(bool((est_err <= est_limit).all()),
          f"every push estimate within {STACK_EST_REL:.0%} + {STACK_EST_ABS} N of the push:"
          f" worst margin {out['push_estimate_worst_margin_n']}")
    check(dcm_err < STACK_DCM, f"every lane's DCM within {STACK_DCM} m of the stance: {dcm_err}")
    mpc = out["mpc_converged_by_tick"]
    check(min(mpc) >= STACK_MPC_SHARE * lanes,
          f"the MPC converged on {STACK_MPC_SHARE:.0%} of lanes on every tick: {mpc}")
    last = records[-1]
    rp_max, rd_max = float(last["rp"][0]), float(last["rd"][0])
    check(out["wbc_converged_by_tick"][-1] == lanes and rp_max <= STACK_LAST_RP
          and rd_max <= STACK_LAST_RD,
          f"the last tick as STACK_r05.json recorded it: every WBC lane converged, max primal"
          f" residual <= {STACK_LAST_RP}, max dual <= {STACK_LAST_RD}:"
          f" {out['wbc_converged_by_tick'][-1]}, {rp_max}, {rd_max}")
    settled = [c >= STACK_CONVERGED_SHARE * lanes for c in converged]
    check(settled[-1] and sum(settled[1:]) >= STACK_SETTLED_TICKS,
          f"{STACK_CONVERGED_SHARE:.0%} of lanes CONVERGED on the last tick and on at least"
          f" {STACK_SETTLED_TICKS} ticks after the first: {converged}")
    return out


def phase_stack_cross() -> dict:
    """The stack's two accuracy contracts on the card, STACK_CROSS_LANES lanes:
    (a) the production plant (ROS2-W, 2 substeps, lagged M^-1, stiff-path
    operator) against RK4 in 40 substeps with the exact M, over
    STACK_CROSS_TICKS outer ticks from the same state and pushes; (b) one
    outer tick from the same warm state with the MPC on other backends: the
    f32 kernel (``"cuda"``) against the plain-tensor backend (with and without
    its refinement pass), to STACK_PLAN_TOL with identical status; the
    configuration's ``"cuda_delta"`` against its plain version (two float32
    orders), to STACK_DELTA_TOL with at most STACK_DELTA_MISMATCH of the lanes'
    converged flags apart; and ``"cuda_delta"`` against ``"cuda"`` under the
    reference's contract for its reduced modes."""
    problem = push_recovery_stack(STACK_CROSS_LANES, seed=SEED, device=DEVICE,
                                  dtype=torch.float32)
    rk4 = problem.config._replace(plant_method="rk4", physics_per_wbc=40,
                                  plant_lagged_minv=False, ros_op_stiff=False)
    runs, seconds = {}, {}
    for name, config in (("ros2w", problem.config), ("rk4", rk4)):
        t0 = time.perf_counter()
        step = stack_fleet_step(problem, config)
        state, traces = problem.state, []
        for _ in range(STACK_CROSS_TICKS):
            state, trace = step(state, problem.pushes, *problem.refs)
            traces.append(trace)
        runs[name] = (state, traces)
        seconds[name] = time.perf_counter() - t0
    (s_ros, tr_ros), (s_rk, tr_rk) = runs["ros2w"], runs["rk4"]
    dcm_by_tick = [float((a.dcm - b.dcm).abs().max()) for a, b in zip(tr_ros, tr_rk)]
    com_by_tick = [float((a.com - b.com).abs().max()) for a, b in zip(tr_ros, tr_rk)]
    est = float((s_ros.push_theta - s_rk.push_theta).abs().max())

    # (b) from the production run's warm state after one tick
    warm, _ = stack_fleet_step(problem)(problem.state, problem.pushes, *problem.refs)

    def mpc_tick(backend, refine=None, plain=False):
        solve = dcm_module.solve_dcm_mpc if refine is None else functools.partial(
            dcm_module.solve_dcm_mpc, refine=refine)
        with contextlib.ExitStack() as patches:
            patches.enter_context(mock.patch.object(stack_module, "solve_dcm_mpc", solve))
            if plain:
                patches.enter_context(mock.patch.object(qp_module, "admm_stage",
                                                        admm_kernel.admm_stage_reference))
            st, tr = stack_fleet_step(problem, problem.config._replace(mpc_backend=backend))(
                warm, problem.pushes, *problem.refs)
        return st.warm_zmp, st.warm_y, tr.mpc_converged

    admm_kernel.reset_counts()            # the f32 kernel's launches on this path
    plans = {"cuda": mpc_tick("cuda")}
    f32_launches = admm_kernel.launch_count()
    plans.update(torch=mpc_tick("torch"), torch_no_refine=mpc_tick("torch", refine=False),
                 cuda_delta=mpc_tick("cuda_delta"),
                 cuda_delta_plain=mpc_tick("cuda_delta", plain=True))

    def pair(a, b):
        both = plans[a][2] & plans[b][2]
        plan = (plans[a][0] - plans[b][0]).abs().amax(dim=(-2, -1))
        return {"plan": float(plan.max()),
                "duals": float((plans[a][1] - plans[b][1]).abs().max()),
                "mpc_status_mismatches": int((plans[a][2] != plans[b][2]).sum()),
                "mpc_converged": [int(plans[a][2].sum()), int(plans[b][2].sum())],
                "plan_both_converged": float(plan[both].max()) if bool(both.any()) else 0.0}

    diff = {name: pair(name, "cuda") for name in ("torch", "torch_no_refine")}
    delta_plain, delta_f32 = pair("cuda_delta", "cuda_delta_plain"), pair("cuda_delta", "cuda")
    out = emit("stack_cross", lanes=STACK_CROSS_LANES, ticks=STACK_CROSS_TICKS,
               dcm_diff_by_tick_m=dcm_by_tick, com_diff_by_tick_m=com_by_tick,
               push_estimate_diff_n=est, tolerance_dcm_m=STACK_CROSS_DCM,
               tolerance_estimate_n=STACK_CROSS_EST,
               rk4_status_counts=status_counts(tr_rk[-1].status),
               ros2w_status_counts=status_counts(tr_ros[-1].status),
               seconds_by_plant=seconds, mpc_backends=diff, tolerance_plan=STACK_PLAN_TOL,
               mpc_converged_cuda=int(plans["cuda"][2].sum()),
               delta_against_plain=delta_plain, tolerance_delta_plain=STACK_DELTA_TOL,
               delta_status_mismatch_share=STACK_DELTA_MISMATCH,
               delta_against_cuda=delta_f32, f32_converged_share=CROSS_F32_SHARE,
               tolerance_delta_cuda=CROSS_F32_TOL, admm_stage_launches=f32_launches)
    check(all(all_finite(s.plant) for s in (s_ros, s_rk)), "both plants finite")
    check(max(dcm_by_tick) <= STACK_CROSS_DCM,
          f"ROS2-W within {STACK_CROSS_DCM} m of RK4 on the DCM at every tick: {dcm_by_tick}")
    check(est <= STACK_CROSS_EST, f"push estimates within {STACK_CROSS_EST} N: {est}")
    for name, d in diff.items():
        check(d["plan"] <= STACK_PLAN_TOL and d["mpc_status_mismatches"] == 0,
              f"MPC plan on {name} within {STACK_PLAN_TOL} of the kernel's, identical"
              f" status: {d}")
    check(f32_launches == STACK_MPC_STAGES, f"the 'cuda' MPC ran the f32 kernel: {f32_launches}")
    d = delta_plain
    check(d["plan"] <= STACK_DELTA_TOL and d["duals"] <= STACK_DELTA_TOL
          and d["mpc_status_mismatches"] <= STACK_DELTA_MISMATCH * STACK_CROSS_LANES,
          f"the delta MPC's kernel within {STACK_DELTA_TOL} of its plain version, at most"
          f" {STACK_DELTA_MISMATCH:.0%} of lanes of differing status: {d}")
    d = delta_f32
    check(d["mpc_converged"][0] >= d["mpc_converged"][1] - CROSS_F32_SHARE * STACK_CROSS_LANES
          and d["plan_both_converged"] <= CROSS_F32_TOL,
          f"'cuda_delta' converges within {CROSS_F32_SHARE:.1%} of the lanes of 'cuda' and its"
          f" plan lies within {CROSS_F32_TOL} where both converged: {d}")
    return out


def phase_foot() -> dict:
    """The foot rollout fleet of ``benchmarks/rollout_bench.py``: FOOT_LANES
    lanes, FOOT_STEPS Euler steps, ``backend="cuda"``, one warm-up and
    FOOT_RUNS timed rollouts, then FOOT_SETTLE_STEPS steps that must settle
    every lane; the plain-tensor backend at the same width beside it."""
    torch.cuda.reset_peak_memory_stats()
    fleet = foot_drop_fleet(FOOT_LANES, seed=SEED, device=DEVICE, dtype=torch.float32)
    args = (fleet.cparams, fleet.fparams, fleet.state, fleet.null_position,
            fleet.null_rotation, fleet.dt)
    rollout_kernel.reset_counts()                 # counts of this path start here
    rollout = lambda steps: foot_rollout(*args, steps, backend="cuda")
    times = time_cuda(lambda: rollout(FOOT_STEPS), warmup=1, reps=FOOT_RUNS)
    out = rollout(FOOT_STEPS)
    settled = rollout(FOOT_SETTLE_STEPS)
    torch.cuda.synchronize()
    launches = rollout_kernel.launch_count()      # read just after the path
    plain_runs = rollout_kernel.reference_count()
    expected = 1 + FOOT_RUNS + 2
    peak = torch.cuda.max_memory_allocated() / 1e9

    t0 = time.perf_counter()
    plain = foot_rollout(*args, FOOT_STEPS, backend="torch")
    torch.cuda.synchronize()
    torch_ms = 1e3 * (time.perf_counter() - t0)
    parted = foot_max_abs(out, plain)

    cp, fp = fleet.cparams, fleet.fparams
    sink = float(fp.mass) * 9.81 / (float(cp.spring_coeff) * float(cp.length * cp.width))
    sink_err = float((settled.position[:, 2] + sink).abs().max())
    v_max = float(settled.linear_velocity.abs().max())
    w_max = float(settled.angular_velocity.abs().max())
    r_err = float((settled.rotation - torch.eye(3, device=DEVICE)).abs().max())
    wrench = contact_wrench(cp, ContactState(*settled, null_position=fleet.null_position,
                                             null_rotation=fleet.null_rotation))
    weight_err = float((wrench[:, 2] / (float(fp.mass) * 9.81) - 1.0).abs().max())
    med = statistics.median(times)
    record = emit(
        "foot", lanes=FOOT_LANES, steps=FOOT_STEPS, dt=fleet.dt, dtype="float32",
        backend="cuda", rollout_ms=med, rollout_ms_min=min(times), rollout_ms_max=max(times),
        rollout_ms_each=times, lane_steps_per_s=FOOT_LANES * FOOT_STEPS / (med * 1e-3),
        torch_backend_ms=torch_ms, cuda_vs_torch_max_abs=parted,
        settle_steps=FOOT_SETTLE_STEPS, settled_sink_err_m=sink_err,
        settled_max_linear_velocity=v_max, settled_max_angular_velocity=w_max,
        settled_max_rotation_err=r_err, settled_weight_rel_err=weight_err,
        mean_final_pz=float(out.position[:, 2].mean()),
        launches=launches, launches_expected=expected, plain_version_runs=plain_runs,
        peak_memory_gb=peak)
    check(launches == expected, f"one kernel launch a rollout: {launches}, not {expected}")
    check(plain_runs == 0, "the plain version never ran on this path")
    check(all(bool(torch.isfinite(t).all()) for t in out),
          "every lane finite")
    check(parted <= FOOT_TOL, f"backend torch agrees with cuda to {FOOT_TOL}: {parted}")
    check(sink_err < FOOT_SINK_TOL, f"every lane sinks to -mg/(kA) within {FOOT_SINK_TOL} m:"
                                    f" {sink_err}")
    check(v_max < FOOT_V_TOL and w_max < FOOT_W_TOL,
          f"every lane at rest: |v| {v_max} < {FOOT_V_TOL}, |w| {w_max} < {FOOT_W_TOL}")
    check(r_err < FOOT_R_TOL, f"every lane's rotation within {FOOT_R_TOL} of I: {r_err}")
    return record


def relative_errors(estimate, true) -> dict:
    rel = ((estimate.double() - true.double()).abs() / true.double()).cpu()
    return {"within_1pct_k": int((rel[:, 0] <= 0.01).sum()),
            "within_1pct_b": int((rel[:, 1] <= 0.01).sum()),
            "median_rel_k": float(rel[:, 0].median()), "median_rel_b": float(rel[:, 1].median()),
            "max_rel_k": float(rel[:, 0].max()), "max_rel_b": float(rel[:, 1].max())}


def max_rel_parted(a, b) -> float:
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def phase_identify() -> dict:
    """Contact identification over IDENT_LANES lanes with their own (k, b):
    IDENT_SAMPLES segments of IDENT_STEPS Euler steps on the kernel, the
    wrench measured after each, three RLS forms; one warm-up run, then one
    run counted and timed by part. Then IDENT_CROSS_LANES lanes on both
    backends."""
    problem = contact_identification_fleet(IDENT_LANES, samples=IDENT_SAMPLES, seed=SEED,
                                           device=DEVICE, dtype=torch.float32)
    run = lambda p, backend="cuda": identify_contacts(p, backend=backend)
    run(problem)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rollout_kernel.reset_counts()                  # counts of this path start here
    t0 = time.perf_counter()
    with profiling.recording() as log:
        result = run(problem)
    torch.cuda.synchronize()
    total_ms = 1e3 * (time.perf_counter() - t0)
    launches = rollout_kernel.launch_count()       # read just after the path
    plain_runs = rollout_kernel.reference_count()
    peak = torch.cuda.max_memory_allocated() / 1e9
    split = part_ms(log, "identify", IDENTIFY_PARTS)

    accuracy = {form: relative_errors(getattr(result, form), result.true)
                for form in ("scan", "fit", "parallel")}
    forms = {"fit_vs_scan": max_rel_parted(result.fit, result.scan),
             "parallel_vs_scan": max_rel_parted(result.parallel, result.scan)}
    small = contact_identification_fleet(IDENT_CROSS_LANES, samples=IDENT_SAMPLES, seed=SEED,
                                         device=DEVICE, dtype=torch.float32)
    on_kernel, on_torch = run(small), run(small, backend="torch")
    cross = {form: max_rel_parted(getattr(on_kernel, form), getattr(on_torch, form))
             for form in ("scan", "fit", "parallel")}
    record = emit(
        "identify", lanes=IDENT_LANES, samples=IDENT_SAMPLES, steps_per_sample=IDENT_STEPS,
        dt=problem.dt, dtype="float32", backend="cuda", total_ms=total_ms,
        split_ms=split, split_sum_ms=sum(split.values()),
        lane_identifications_per_s=IDENT_LANES / (total_ms * 1e-3),
        accuracy=accuracy, forms_max_rel=forms, cross_lanes=IDENT_CROSS_LANES,
        cuda_vs_torch_max_rel=cross, launches=launches, launches_expected=IDENT_SAMPLES,
        plain_version_runs=plain_runs, peak_memory_gb=peak)
    check(launches == IDENT_SAMPLES, f"one kernel launch a segment: {launches}")
    check(plain_runs == 0, "the plain version never ran on this path")
    for form, a in accuracy.items():
        check(a["within_1pct_k"] >= IDENT_SHARE_K * IDENT_LANES
              and a["within_1pct_b"] >= IDENT_SHARE_B * IDENT_LANES,
              f"{form}: k within 1 % on {IDENT_SHARE_K:.1%} of lanes and b on"
              f" {IDENT_SHARE_B:.0%}: {a}")
        check(a["median_rel_k"] <= IDENT_MEDIAN_K and a["median_rel_b"] <= IDENT_MEDIAN_B,
              f"{form}: median relative error within {IDENT_MEDIAN_K} (k), {IDENT_MEDIAN_B}"
              f" (b): {a}")
        check(max(a["max_rel_k"], a["max_rel_b"]) <= IDENT_MAX,
              f"{form}: every lane within {IDENT_MAX} of the truth: {a}")
    check(max(forms.values()) <= IDENT_FORMS_TOL,
          f"rls_fit and rls_parallel agree with rls_scan to {IDENT_FORMS_TOL}: {forms}")
    check(max(cross.values()) <= IDENT_CROSS_TOL,
          f"{IDENT_CROSS_LANES} lanes: backend cuda and torch agree to {IDENT_CROSS_TOL}:"
          f" {cross}")
    return record


def native_schedule_check(lists, dt: float) -> dict:
    """The gait's schedule and support polygons through the native library's
    batch functions, against the planners' own (exact; hulls to 1e-12)."""
    T = gait_horizon(lists, dt)
    names = sorted(lists)
    C = max(len(lists[k]) for k in names)
    act, deact = np.zeros((1, len(names), C)), np.zeros((1, len(names), C))
    counts, pos = np.zeros((1, len(names)), np.int32), np.zeros((1, len(names), C, 3))
    for e, name in enumerate(names):
        for c, contact in enumerate(lists[name]):
            act[0, e, c], deact[0, e, c] = contact.activation_time, contact.deactivation_time
            pos[0, e, c] = contact.position
        counts[0, e] = len(lists[name])
    available = native.available()                # builds the library at first call
    native.reset_counts()
    t0 = time.perf_counter()
    active, index, foot = native.lower_schedules_batch(act, deact, counts, pos, T, dt)
    A, b = native.support_polygons_batch(active, foot[..., :2], 0.07, 0.04)
    native_ms = 1e3 * (time.perf_counter() - t0)
    schedule = lower_contact_schedule(lists, dt=dt, horizon=T)
    A_ref, b_ref = support_polygons(schedule, device="cpu", dtype=torch.float64)
    check(bool(np.array_equal(active[0], schedule.active)
               and np.array_equal(index[0], schedule.contact_index)
               and np.array_equal(foot[0], schedule.position)),
          "native lowering equals lower_contact_schedule")
    hull_err = max(float(np.abs(A[0] - A_ref.numpy()).max()),
                   float(np.abs(b[0] - b_ref.numpy()).max()))
    check(hull_err <= 1e-12, f"native support polygons within 1e-12 of the planners': {hull_err}")
    return {"available": bool(available), "native_calls": native.native_count(),
            "python_runs": native.python_count(), "host_ms": native_ms,
            "hull_max_abs_err": hull_err, "knots": T, "build_reason": available.reason}


def gait_checks(plan, poly_A, poly_b) -> dict:
    """What TestFullGait.test_ten_step_gait_plan asks of a plan (every lane of
    a batch): the worst ZMP margin against each knot's polygon, the final DCM
    against [0.75, 0], the CoM's end and lateral sway."""
    margins = torch.einsum("kfa,...ka->...kf", poly_A, plan.zmp) - poly_b
    final = plan.dcm[..., -1, :] - torch.as_tensor(GAIT_FINAL_DCM, device=plan.dcm.device,
                                                   dtype=plan.dcm.dtype)
    return {"worst_zmp_margin": float(margins.max()),
            "final_dcm_max_dev": float(final.abs().max()),
            "com_final_x_min": float(plan.com[..., -1, 0].min()),
            "com_lateral_max": float(plan.com[..., 1].abs().max()),
            "finite": bool(torch.isfinite(plan.com).all() and torch.isfinite(plan.zmp).all())}


def hold_gait(checks: dict, what: str) -> None:
    check(checks["worst_zmp_margin"] <= GAIT_MARGIN_TOL,
          f"{what}: every ZMP inside its hull to {GAIT_MARGIN_TOL}: {checks}")
    check(checks["final_dcm_max_dev"] <= GAIT_FINAL_TOL,
          f"{what}: the final DCM within {GAIT_FINAL_TOL} of {GAIT_FINAL_DCM}: {checks}")
    check(checks["com_final_x_min"] > 0.6 and checks["com_lateral_max"] < 0.12
          and checks["finite"], f"{what}: the CoM walks forward and stays bounded: {checks}")


def phase_gait() -> dict:
    """BASELINE config 3 over a fleet: ``plan_gait`` of the 10-step gait for
    GAIT_LANES initial DCMs in float32, ``shared=True, backend="cuda"`` (K1's
    streaming kernel at (960, 384)); one warm-up plan, then GAIT_RUNS timed,
    counted from the last. The factorization timed apart; GAIT_CPU_LANES lanes
    planned again in float64 on the CPU by the plain path; the schedule and
    polygons through the native library; and examples/03_full_gait.py's single
    plan (per-lane solver, ``"torch"``: no kernel on that path in either
    package)."""
    fleet = gait_fleet(GAIT_LANES, seed=SEED, device=DEVICE, dtype=torch.float32)
    run = lambda: plan_gait(*fleet, iterations=GAIT_ITERATIONS, shared=True, backend="cuda")
    run()                                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(GAIT_RUNS):
        admm_kernel.reset_counts()                  # counts of this path start here
        t0 = time.perf_counter()
        plan, schedule = run()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    counts = {"l2": admm_kernel.l2_launch_count(), **stage_counts()}   # read just after
    peak = torch.cuda.max_memory_allocated() / 1e9
    poly_A, poly_b = support_polygons(schedule, device=DEVICE, dtype=torch.float32)
    checks = gait_checks(plan, poly_A, poly_b)
    converged = int(plan.qp.converged.sum())

    T = schedule.active.shape[1]
    zmp_ref, dcm_ref = gait_references(fleet.params, schedule, fleet.dt)
    P, _, A, _, _ = build_dcm_qp(fleet.params, fleet.dt, fleet.dcm0[:1], dcm_ref, zmp_ref,
                                 poly_A, poly_b)
    is_eq = torch.arange(A.shape[0], device=DEVICE) < 2 * T
    factor_ms = median_ms(lambda: factor_shared_qp(P, A, is_eq), 1, 3)

    dcm_rmse = gait_rmse_vs_cpu(plan)

    natively = native_schedule_check(fleet.lists, fleet.dt)

    example_params = lipm_params_from_numpy(0.9, 9.81, device=DEVICE, dtype=torch.float32)
    zero = torch.zeros(2, dtype=torch.float32, device=DEVICE)
    admm_kernel.reset_counts()
    t0 = time.perf_counter()
    single, single_schedule = plan_gait(example_params, footstep_plan(10, 0.15), 0.1, zero,
                                        zero, iterations=GAIT_EXAMPLE_ITERS)
    torch.cuda.synchronize()
    single_ms = 1e3 * (time.perf_counter() - t0)
    single_checks = gait_checks(single, *support_polygons(single_schedule, device=DEVICE,
                                                          dtype=torch.float32))
    single_counts = stage_counts()

    record = emit(
        "gait", lanes=GAIT_LANES, knots=T, shape=list(A.shape), iterations=GAIT_ITERATIONS,
        dtype="float32", backend="cuda", plan_ms=statistics.median(times),
        plan_ms_min_max=[min(times), max(times)], plans_per_s=GAIT_LANES / (
            statistics.median(times) * 1e-3), factor_ms=factor_ms, converged=converged,
        max_primal_residual=float(plan.qp.primal_residual.max()),
        max_dual_residual=float(plan.qp.dual_residual.max()), **checks,
        cpu_lanes=GAIT_CPU_LANES, dcm_rmse_vs_cpu_float64=dcm_rmse,
        launches=counts, peak_memory_gb=peak, native=natively,
        example={"iterations": GAIT_EXAMPLE_ITERS, "backend": "torch", "plan_ms": single_ms,
                 "converged": bool(single.qp.converged), "knots": single.zmp.shape[0],
                 **single_checks, "launches": single_counts})
    check(counts["l2"] == GAIT_ITERATIONS // STAGE_ITERS,
          f"one streaming-kernel launch a stage: {counts}")
    check(counts["plain"] == 0 and counts["f32"] == 0, f"no other stage ran: {counts}")
    check(converged == GAIT_LANES, f"every lane converged: {converged} of {GAIT_LANES}")
    hold_gait(checks, "the fleet")
    check(dcm_rmse <= GAIT_RMSE_TOL,
          f"DCM within {GAIT_RMSE_TOL} RMSE of the float64 CPU plan: {dcm_rmse}")
    check(natively["python_runs"] == 0 and natively["available"],
          f"the native library served the schedule: {natively}")
    check(bool(single.qp.converged) and single.zmp.shape[0] == 96,
          "examples/03_full_gait.py's plan converged over 96 knots")
    hold_gait(single_checks, "examples/03_full_gait.py's plan")
    return record


@functools.lru_cache(maxsize=None)
def gait_cpu_plan():
    """The first GAIT_CPU_LANES lanes of the gait fleet planned in float64 on
    the CPU by the plain path (``backend="torch"``)."""
    fleet = gait_fleet(GAIT_LANES, seed=SEED, device=DEVICE, dtype=torch.float32)
    return plan_gait(lipm_params_from_numpy(0.9, 9.81, device="cpu", dtype=torch.float64),
                     fleet.lists, fleet.dt, fleet.dcm0[:GAIT_CPU_LANES].cpu().double(),
                     fleet.com0[:GAIT_CPU_LANES].cpu().double(), iterations=GAIT_ITERATIONS,
                     shared=True, backend="torch")[0]


def gait_rmse_vs_cpu(plan) -> float:
    """DCM RMSE (m) of a fleet plan's first lanes against :func:`gait_cpu_plan`."""
    cpu = gait_cpu_plan()
    return float((plan.dcm[:GAIT_CPU_LANES].cpu().double() - cpu.dcm).pow(2).mean().sqrt())


def phase_gait_delta() -> dict:
    """BASELINE config 3 in bench.py's own mode: ``plan_gait`` of the 10-step
    gait for GAIT_LANES initial DCMs in float32, ``shared=True,
    backend="cuda_delta"`` (the reference's "pallas": K1's streaming
    tensor-core kernel at (960, 384), one launch a stage); one warm-up plan,
    then GAIT_RUNS timed in turns with the f32 plan (``"cuda"``, K1-L),
    counted from the last. Held: the launches, TestFullGait's checks on every
    lane, the DCM RMSE against the float64 CPU plan of GAIT_CPU_LANES lanes,
    and the converged count against the same plan with the stage's plain
    version on the card (at most GAIT_DELTA_SLACK of the lanes fewer). The
    factorization timed apart; ``"cuda_split"`` planned once beside it."""
    fleet = gait_fleet(GAIT_LANES, seed=SEED, device=DEVICE, dtype=torch.float32)
    run = lambda backend: plan_gait(*fleet, iterations=GAIT_ITERATIONS, shared=True,
                                    backend=backend)
    for backend in ("cuda_delta", "cuda"):          # warm-up
        run(backend)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {"cuda_delta": [], "cuda": []}
    for _ in range(GAIT_RUNS):
        for backend in ("cuda_delta", "cuda"):      # in turns
            admm_kernel.reset_counts()              # counts of this path start here
            t0 = time.perf_counter()
            plan, schedule = run(backend)
            torch.cuda.synchronize()
            times[backend].append(1e3 * (time.perf_counter() - t0))
            if backend == "cuda_delta":
                counts = {"l2": admm_kernel.l2_launch_count(), **stage_counts()}   # just after
                delta_plan = plan
    peak = torch.cuda.max_memory_allocated() / 1e9
    poly_A, poly_b = support_polygons(schedule, device=DEVICE, dtype=torch.float32)
    checks = gait_checks(delta_plan, poly_A, poly_b)
    converged = int(delta_plan.qp.converged.sum())
    dcm_rmse = gait_rmse_vs_cpu(delta_plan)

    # the same plan with the stage's plain version on the card, same inputs
    with mock.patch.object(qp_module, "admm_stage", admm_kernel.admm_stage_reference):
        plain_plan = run("cuda_delta")[0]
    converged_plain = int(plain_plan.qp.converged.sum())
    dcm_vs_plain = float((delta_plan.dcm - plain_plan.dcm).abs().max())
    del plain_plan

    T = schedule.active.shape[1]
    zmp_ref, dcm_ref = gait_references(fleet.params, schedule, fleet.dt)
    P, _, A, _, _ = build_dcm_qp(fleet.params, fleet.dt, fleet.dcm0[:1], dcm_ref, zmp_ref,
                                 poly_A, poly_b)
    is_eq = torch.arange(A.shape[0], device=DEVICE) < 2 * T
    factor_ms = median_ms(lambda: factor_shared_qp(P, A, is_eq), 1, 3)

    admm_kernel.reset_counts()
    t0 = time.perf_counter()
    split_plan = run("cuda_split")[0]
    torch.cuda.synchronize()
    split_ms = 1e3 * (time.perf_counter() - t0)
    split_counts = {"l2": admm_kernel.l2_launch_count(), **stage_counts()}
    split_checks = gait_checks(split_plan, poly_A, poly_b)
    split = {"plan_ms": split_ms, "converged": int(split_plan.qp.converged.sum()),
             "launches": split_counts, **split_checks,
             "dcm_rmse_vs_cpu_float64": gait_rmse_vs_cpu(split_plan)}

    med = {k: statistics.median(v) for k, v in times.items()}
    record = emit(
        "gait_delta", lanes=GAIT_LANES, knots=T, shape=list(A.shape), iterations=GAIT_ITERATIONS,
        dtype="float32", backend="cuda_delta", plan_ms=med["cuda_delta"],
        plan_ms_min_max=[min(times["cuda_delta"]), max(times["cuda_delta"])],
        plans_per_s=GAIT_LANES / (med["cuda_delta"] * 1e-3),
        f32_plan_ms_in_turns=med["cuda"], f32_plan_ms_min_max=[min(times["cuda"]),
                                                                max(times["cuda"])],
        factor_ms=factor_ms, converged=converged, converged_with_plain_stage=converged_plain,
        dcm_max_abs_vs_plain_stage=dcm_vs_plain,
        max_primal_residual=float(delta_plan.qp.primal_residual.max()),
        max_dual_residual=float(delta_plan.qp.dual_residual.max()), **checks,
        cpu_lanes=GAIT_CPU_LANES, dcm_rmse_vs_cpu_float64=dcm_rmse, launches=counts,
        peak_memory_gb=peak, split=split)
    stages = GAIT_ITERATIONS // STAGE_ITERS
    check(counts["tc_l2_delta"] == stages,
          f"one streaming tensor-core launch a stage: {counts}")
    check(sum(counts.values()) == stages, f"no other stage ran: {counts}")
    check(converged >= converged_plain - GAIT_DELTA_SLACK * GAIT_LANES,
          f"converged within {GAIT_DELTA_SLACK} of the lanes of the plan with the plain"
          f" stage: {converged} against {converged_plain}")
    hold_gait(checks, "the fleet in cuda_delta")
    check(dcm_rmse <= GAIT_RMSE_TOL,
          f"DCM within {GAIT_RMSE_TOL} RMSE of the float64 CPU plan: {dcm_rmse}")
    check(split_counts["tc_l2_split"] == stages and sum(split_counts.values()) == stages,
          f"cuda_split: one streaming tensor-core launch a stage: {split_counts}")
    check(split_checks["finite"], f"cuda_split's plan is finite: {split_checks}")
    return record


KERNEL_MODULES = (admm_kernel, lane_kernel, chol_kernel, rollout_kernel)


def reset_all_counts() -> None:
    for module in KERNEL_MODULES:
        module.reset_counts()


def all_launches() -> int:
    """Launches of every hand-written kernel, and their plain runs, since the
    counts were last set to 0."""
    return (sum(stage_counts().values()) + admm_kernel.l2_launch_count()
            + lane_kernel.launch_count() + lane_kernel.reference_count()
            + chol_kernel.launch_count() + chol_kernel.reference_count()
            + chol_kernel.solve_launch_count() + chol_kernel.solve_reference_count()
            + rollout_kernel.launch_count() + rollout_kernel.reference_count())


def plan_checks(plan, fleet) -> dict:
    """What tests/test_sqp.py's push-recovery case asks of a plan, on every
    lane: finite, max_violation, every ZMP inside its polygon, the final DCM
    at the goal, omega settled and within its bounds."""
    margins = torch.einsum("tmi,bti->btm", fleet.poly_A, plan.zmp) - fleet.poly_b
    omega_nom = torch.sqrt(fleet.params.gravity / fleet.params.com_height)
    return {
        "finite": bool(all(torch.isfinite(t).all() for t in plan if t.dtype.is_floating_point)),
        "max_violation": float(plan.max_violation.max()),
        "worst_zmp_margin": float(margins.max()),
        "final_dcm_max_dev": float((plan.dcm[:, -1] - fleet.dcm_goal).abs().max()),
        "final_omega_max_dev": float((plan.omega[:, -1] - omega_nom).abs().max()),
        "omega_min_max": [float(plan.omega.min()), float(plan.omega.max())],
        "converged": int(plan.converged.sum())}


def profile_plan(run) -> dict:
    """Device work of one plan by ``torch.profiler`` (device activity only,
    read from the raw trace: parsing some 10^5 events into the profiler's
    event tree takes a minute): device operations launched (kernels, copies,
    fills), device-busy time and the idle share of the profiled plan. A
    record, not a check."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in device) / 1e6
    by_name = Counter(e.name()[:60] for e in device)
    return {"device_ops": len(device), "device_busy_ms": busy, "wall_ms_profiled": wall_ms,
            "idle_share": 1.0 - busy / wall_ms,
            "top_by_count": [{"name": k, "count": c} for k, c in by_name.most_common(8)]}


def phase_dcm_planner() -> dict:
    """The time-varying DCM planner over PLAN_LANES lanes in float32
    (``plan_time_varying_dcm_batch`` on ``dcm_planner_fleet``): one warm-up
    plan, PLAN_RUNS timed; one more under CUDA events by part of the SQP
    (``sqp.PARTS``), one under ``torch.profiler`` (the launch count), one
    under ``set_sync_debug_mode("error")`` (no host sync may happen). Held on
    every lane to the reference tests' float32 limits, and to the port's
    float64 plan of PLAN_CPU_LANES lanes on the CPU (DCM RMSE). Beside it:
    the parallel backward pass against the sequential one at
    PLAN_PARALLEL_HORIZON, and ``solve_lqr`` in both forms on LQR_LANES
    random LQ problems. No kernel of its own: it launches no hand-written
    kernel (counted: 0)."""
    start = time.perf_counter()
    seconds = {}                                    # of each step of the phase

    def lap(name):
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start - sum(seconds.values())

    fleet = dcm_planner_fleet(PLAN_LANES, PLAN_HORIZON, seed=SEED, device=DEVICE,
                              dtype=torch.float32)
    run = lambda: plan_time_varying_dcm_batch(*fleet)
    run()                                           # warm-up
    lap("warm_up")
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    times = []
    for _ in range(PLAN_RUNS):
        t0 = time.perf_counter()
        plan = run()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    kernels_launched = all_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    checks = plan_checks(plan, fleet)
    lap("timed")

    with profiling.recording() as log:
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        run()
        end.record()
        torch.cuda.synchronize()
    split = {"plan_ms": begin.elapsed_time(end),
             "parts_ms": part_ms(log, "sqp", sqp_module.PARTS)}
    lap("split")
    profiled = profile_plan(run)
    lap("profile")

    torch.cuda.set_sync_debug_mode("error")
    try:
        synced = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sync_vs_timed = float((synced.dcm - plan.dcm).abs().max())
    lap("sync_debug")

    cpu = plan_time_varying_dcm_batch(
        lipm_params_from_numpy(0.9, 9.81, device="cpu", dtype=torch.float64), fleet.dt,
        fleet.dcm0[:PLAN_CPU_LANES].cpu().double(), fleet.omega0[:PLAN_CPU_LANES].cpu().double(),
        *(t.cpu().double() for t in fleet[4:]))
    lanes = plan.dcm[:PLAN_CPU_LANES].cpu().double()
    rmse = float((lanes - cpu.dcm).pow(2).mean().sqrt())
    card_flags, cpu_flags = plan.converged[:PLAN_CPU_LANES].cpu(), cpu.converged
    converged_cpu = {"card": int(card_flags.sum()), "cpu_float64": int(cpu_flags.sum()),
                     "same_flag": int((card_flags == cpu_flags).sum())}
    lap("cpu_float64")

    short = dcm_planner_fleet(PLAN_LANES, PLAN_PARALLEL_HORIZON, seed=SEED, device=DEVICE,
                              dtype=torch.float32)
    seq = plan_time_varying_dcm_batch(*short, sqp=SQPConfig(**PLAN_PARALLEL_SQP))
    par = plan_time_varying_dcm_batch(*short, sqp=SQPConfig(parallel_backward=True,
                                                             **PLAN_PARALLEL_SQP))
    parallel = {"knots": short.zmp_ref.shape[0],
                "dcm_max_abs": float((par.dcm - seq.dcm).abs().max()),
                "zmp_max_abs": float((par.zmp - seq.zmp).abs().max()),
                "max_violation_max_abs": float((par.max_violation - seq.max_violation).abs().max()),
                "converged": [int(seq.converged.sum()), int(par.converged.sum())]}
    lap("parallel_backward")

    problems = random_lqr_batch(LQR_LANES, LQR_HORIZON, seed=SEED, device=DEVICE,
                                dtype=torch.float32)
    lqr = {}
    for form in (False, True):
        solve_lqr(*problems, parallel=form)         # warm-up
        t0 = time.perf_counter()
        lqr[form] = solve_lqr(*problems, parallel=form)
        torch.cuda.synchronize()
        lqr[f"ms_{'parallel' if form else 'sequential'}"] = 1e3 * (time.perf_counter() - t0)
    lqr_err = {f: float((getattr(lqr[True], f) - getattr(lqr[False], f)).abs().max())
               for f in ("value_matrices", "value_vectors", "gains", "controls")}
    lqr_finite = all(bool(torch.isfinite(t).all()) for t in lqr[True] + lqr[False])
    lap("lqr")
    total = time.perf_counter() - start

    med = statistics.median(times)
    record = emit(
        "dcm_planner", lanes=PLAN_LANES, knots=fleet.zmp_ref.shape[0], dtype="float32",
        sqp=dict(SQPConfig(iterations=10, al_iterations=5)._asdict()),
        plan_ms=med, plan_ms_min_max=[min(times), max(times)], plans_per_s=PLAN_LANES / (
            med * 1e-3), peak_memory_gb=peak, **checks, split=split, profile=profiled,
        sync_debug_error_mode="no host sync", dcm_max_abs_sync_run_vs_timed=sync_vs_timed,
        kernels_launched=kernels_launched,
        cpu_lanes=PLAN_CPU_LANES, dcm_rmse_vs_cpu_float64=rmse, converged_vs_cpu=converged_cpu,
        parallel_backward=parallel,
        lqr={"lanes": LQR_LANES, "horizon": LQR_HORIZON, "dtype": "float32",
             "ms_sequential": lqr["ms_sequential"], "ms_parallel": lqr["ms_parallel"],
             "parallel_vs_sequential_max_abs": lqr_err, "finite": lqr_finite},
        phase_seconds=total, seconds_by_step=seconds)
    check(checks["finite"], f"every output of every lane is finite: {checks}")
    check(checks["max_violation"] <= PLAN_VIOLATION_TOL,
          f"max_violation within {PLAN_VIOLATION_TOL} on every lane: {checks}")
    check(checks["worst_zmp_margin"] <= PLAN_VIOLATION_TOL,
          f"every ZMP inside its polygon within {PLAN_VIOLATION_TOL}: {checks}")
    check(checks["final_dcm_max_dev"] <= PLAN_FINAL_TOL,
          f"the final DCM within {PLAN_FINAL_TOL} of the goal on every lane: {checks}")
    check(checks["final_omega_max_dev"] < PLAN_OMEGA_TOL,
          f"omega_T within {PLAN_OMEGA_TOL} of nominal on every lane: {checks}")
    limits = DCMPlannerLimits()
    check(limits.omega_min - 1e-6 <= checks["omega_min_max"][0]
          and checks["omega_min_max"][1] <= limits.omega_max + 1e-6,
          f"omega within its bounds: {checks}")
    check(rmse <= GAIT_RMSE_TOL, f"DCM within {GAIT_RMSE_TOL} RMSE of the float64 CPU plan: {rmse}")
    check(kernels_launched == 0,
          f"the planner runs no hand-written kernel nor its plain version: {kernels_launched}")
    check(parallel["dcm_max_abs"] <= PLAN_PARALLEL_TOL
          and parallel["zmp_max_abs"] <= PLAN_PARALLEL_TOL
          and parallel["max_violation_max_abs"] <= PLAN_PARALLEL_VIOLATION_TOL,
          f"the parallel backward pass agrees with the sequential one: {parallel}")
    check(lqr_finite and max(lqr_err.values()) <= LQR_TOL,
          f"solve_lqr: parallel within {LQR_TOL} of sequential: {lqr_err}")
    check(total < PLAN_SECONDS, f"the phase took {total:.1f} s, over {PLAN_SECONDS}: {seconds}")
    return record


def phase_resume(problem) -> dict:
    """examples/05_fleet_sweep.py's checkpoint check on the card: the fleet
    tick at full width (BATCH, HORIZON, ``backend="cuda"``) for RESUME_TICKS[0]
    ticks, ``save_checkpoint``, RESUME_TICKS[1] more; then
    ``load_checkpoint`` onto the card and the same ticks again: every leaf of
    the state must be bitwise equal."""
    state = init_fleet(BATCH, HORIZON, problem.num_constraints, problem.dcm0, problem.com0,
                       device=DEVICE, dtype=torch.float32)
    step = make_fleet_step(problem.params, problem.dt, iterations=2 * STAGE_ITERS,
                           backend="cuda", device=DEVICE)
    refs = (problem.dcm_ref, problem.zmp_ref, problem.poly_A, problem.poly_b)

    def run(state, ticks):
        for _ in range(ticks):
            state, _ = step(state, problem.disturbance, *refs)
        return state

    admm_kernel.reset_counts()                      # counts of this path start here
    before, after = RESUME_TICKS
    state = run(state, before)
    with tempfile.TemporaryDirectory(prefix="blf_ckpt_") as tmp:
        path = os.path.join(tmp, "fleet.npz")
        t0 = time.perf_counter()
        save_checkpoint(path, state, step=before)
        save_s = time.perf_counter() - t0
        final = run(state, after)
        t0 = time.perf_counter()
        resumed = load_checkpoint(path, state)
        load_s = time.perf_counter() - t0
        saved_step = checkpoint_step(path)
        size_mb = os.path.getsize(path) / 1e6
    refinal = run(resumed, after)
    launches = stage_counts()["f32"]                # read just after
    pairs = list(zip(tree_leaves(final), tree_leaves(refinal)))
    same = [bool(torch.equal(a, b)) for a, b in pairs]
    on_card = all(t.device.type == "cuda" for t in tree_leaves(resumed))
    record = emit("resume", lanes=BATCH, horizon=HORIZON, backend="cuda", ticks=list(RESUME_TICKS),
                  leaves=len(pairs), bitwise_equal_leaves=sum(same), step=saved_step,
                  checkpoint_mb=size_mb, save_s=save_s, load_s=load_s, launches=launches,
                  deterministic_algorithms=torch.are_deterministic_algorithms_enabled())
    check(all(same), f"the resumed fleet is bitwise equal, leaf by leaf: {same}")
    check(on_card and saved_step == before, "loaded onto the card, with the step recorded")
    check(launches == (before + 2 * after) * 2, f"two K1 launches a tick: {launches}")
    return record


def tick_diffs(state_a, result_a, state_b, result_b) -> dict:
    """Relative difference of every state field, the consensus plan and every
    statistic of two ticks."""
    out = {f"state.{k}": rel_err(a, b) for k, a, b in zip(state_a._fields, state_a, state_b)}
    out["consensus_zmp0"] = rel_err(result_a.consensus_zmp0, result_b.consensus_zmp0)
    out.update({f"stats.{k}": rel_err(a, b) for k, a, b in
                zip(result_a.stats._fields, result_a.stats, result_b.stats)})
    out["worst_margin"] = rel_err(result_a.worst_margin, result_b.worst_margin)
    out["status_equal"] = bool(torch.equal(result_a.status, result_b.status))
    return out


def phase_mesh(problem) -> dict:
    """The multi-device slice on the card's world of one.

    ``init_distributed()`` and ``make_mesh()`` (nccl, one rank); the fleet tick
    of ``tick_delta`` (BATCH lanes, horizon 32, 50 iterations, float32,
    ``"cuda_delta"``) through ``make_fleet_step(mesh=...)`` with an ensemble
    of MESH_K members on the local axis, one solve of MESH_K * BATCH lanes:
    (a) identical draws against the K = 1 tick from one warm state; (b)
    MESH_WARM_TICKS ticks with MESH_K distinct seeded draws from the cold
    fleet, held to tick_delta's limits and tests/test_sharding.py's; (c) K1's
    launches on that path (one a stage, each of MESH_K * BATCH lanes); (d)
    the tick timed in turns with the K = 1 tick, and its peak memory; (e) a
    NaN in member 1 of one lane. Then each sharded function against its
    single-device counterpart: the row-sharded QP, the horizon-sharded LQR,
    the stream-sharded RLS and a pipeline of one stage. The process group is
    destroyed at the end."""
    import torch.distributed as dist

    from blf_tpu_torch.estimators.rls import RLSParams, RLSState
    from blf_tpu_torch.estimators.rls_parallel import rls_parallel, rls_parallel_sharded
    from blf_tpu_torch.mpc.qp import (shard_factors_rows, solve_qp_factored,
                                      solve_qp_factored_rowsharded)
    from blf_tpu_torch.mpc.riccati import solve_lqr_sharded
    from blf_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from blf_tpu_torch.parallel.pipeline import pipeline_stages

    start = time.perf_counter()
    rank = init_distributed()
    try:
        mesh = make_mesh()
        world = {"rank": rank, "dist_backend": dist.get_backend(),
                 "world_size": dist.get_world_size(),
                 "nccl": ".".join(map(str, torch.cuda.nccl.version()))
                 if isinstance(torch.cuda.nccl.version(), tuple) else str(torch.cuda.nccl.version()),
                 "mesh": {"shape": list(mesh.mesh.shape), "axes": list(mesh.mesh_dim_names)}}
        check(world["dist_backend"] == "nccl" and world["world_size"] == 1,
              f"a world of one nccl rank: {world}")
        refs = (problem.dcm_ref, problem.zmp_ref, problem.poly_A, problem.poly_b)
        kw = dict(iterations=2 * STAGE_ITERS, backend="cuda_delta", device=DEVICE)
        single = make_fleet_step(problem.params, problem.dt, **kw)
        ensemble = make_fleet_step(problem.params, problem.dt, mesh=mesh, **kw)
        cold = lambda: init_fleet(BATCH, HORIZON, problem.num_constraints, problem.dcm0,
                                  problem.com0, device=DEVICE, dtype=torch.float32)
        draws = stationary_push_recovery(BATCH, HORIZON, seed=SEED, ensemble=MESH_K,
                                         device=DEVICE, dtype=torch.float32).disturbance
        same = problem.disturbance.expand(BATCH, MESH_K, 2).contiguous()

        # (a) identical draws against K = 1, one tick from a warm state
        warm = cold()
        for _ in range(3):
            warm, _ = single(warm, problem.disturbance, *refs)
        one = single(warm, problem.disturbance, *refs)
        two = ensemble(warm, same, *refs)
        identical = tick_diffs(*two, *one)

        # (b, c) MESH_WARM_TICKS ticks with distinct draws; K1's launches and lanes
        lanes_seen = []
        real_stage = qp_module.admm_stage

        def spy(v, *args, **kwargs):
            lanes_seen.append(v.shape[0])
            return real_stage(v, *args, **kwargs)

        state, by_tick = cold(), []
        with mock.patch.object(qp_module, "admm_stage", spy):
            reset_all_counts()                      # counts of the main path start here
            for _ in range(MESH_WARM_TICKS):
                state, result = ensemble(state, draws, *refs)
                by_tick.append(result.stats.num_converged)
            torch.cuda.synchronize()
            counts = stage_counts()                 # read just after
            launches_all = all_launches()
        by_tick = [int(c) for c in torch.stack(by_tick).tolist()]
        warm_record = {
            "converged_by_tick": by_tick, "finite": all_finite(state),
            "num_quarantined": float(result.num_quarantined),
            "worst_margin": float(result.worst_margin),
            "dcm_abs_max": float(state.dcm.abs().max()),
            "max_primal_residual": float(result.stats.max_primal_residual),
            "max_dual_residual": float(result.stats.max_dual_residual)}

        # (d) the tick timed in turns with the K = 1 tick, each from its own warm state
        s1, s2 = state, state
        times = {"k1": [], "ensemble": []}
        torch.cuda.reset_peak_memory_stats()
        for _ in range(MESH_TIMED_TICKS):
            for name, fn, d in (("k1", single, problem.disturbance), ("ensemble", ensemble, draws)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == "k1":
                    s1, _ = fn(s1, d, *refs)
                else:
                    s2, _ = fn(s2, d, *refs)
                torch.cuda.synchronize()
                times[name].append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated() / 1e9

        # (e) a NaN in member 1 of one lane, against the clean tick from the same state
        poisoned = draws.clone()
        poisoned[MESH_NAN_LANE, 1, 0] = float("nan")
        clean_state, clean = ensemble(state, draws, *refs)
        bad_state, bad = ensemble(state, poisoned, *refs)
        others = torch.arange(BATCH, device=DEVICE) != MESH_NAN_LANE
        confined = all(bool(torch.equal(a[others], b[others]))
                       for a, b in zip(tuple(clean_state) + (clean.consensus_zmp0, clean.status),
                                       tuple(bad_state) + (bad.consensus_zmp0, bad.status)))
        nan_record = {"lane_status": int(bad.status[MESH_NAN_LANE]),
                      "num_quarantined": float(bad.num_quarantined),
                      "other_lanes_bit_identical": confined, "finite": all_finite(bad_state),
                      "max_primal_residual": float(bad.stats.max_primal_residual)}

        # the sharded functions on the world of one, each against its single-device form
        group = mesh.get_group("model")
        P, A, is_eq, factors = stage_operators(problem)
        dcm0s = problem.dcm0 + problem.disturbance[:MESH_QP_LANES, 0]
        _, q, _, l, u = build_dcm_qp(problem.params, problem.dt, dcm0s, problem.dcm_ref,
                                     problem.zmp_ref, problem.poly_A, problem.poly_b)
        rowsharded = solve_qp_factored_rowsharded(shard_factors_rows(factors, 0, 1), q, l, u,
                                                  group=group, iterations=MESH_QP_ITERATIONS)
        plain = solve_qp_factored(factors, q, l, u, iterations=MESH_QP_ITERATIONS,
                                  backend="torch", refine=False)
        qp_record = {"m": A.shape[0], "n": A.shape[1], "lanes": MESH_QP_LANES,
                     "x_max_abs": float((rowsharded.x - plain.x).abs().max()),
                     "converged": [int(rowsharded.converged.sum()), int(plain.converged.sum())]}
        lqr_problem = [t[0] for t in random_lqr_batch(1, LQR_HORIZON, seed=SEED, device=DEVICE,
                                                      dtype=torch.float32)]
        sharded_lqr = solve_lqr_sharded(*lqr_problem, mesh, "model")
        serial_lqr = solve_lqr(*lqr_problem)
        lqr_record = {f: float((getattr(sharded_lqr, f) - getattr(serial_lqr, f)).abs().max())
                      for f in LQRSolution._fields}
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        regs = torch.randn((MESH_RLS_STEPS, MESH_RLS_LANES, 2, 3), generator=gen, device=DEVICE)
        meas = regs @ torch.tensor([0.3, -0.2, 0.5], device=DEVICE) + 0.1 * torch.randn(
            (MESH_RLS_STEPS, MESH_RLS_LANES, 2), generator=gen, device=DEVICE)
        rls_args = (RLSParams(torch.tensor(0.98, device=DEVICE), 0.01 * torch.eye(2, device=DEVICE)),
                    RLSState(torch.zeros((MESH_RLS_LANES, 3), device=DEVICE),
                             10.0 * torch.eye(3, device=DEVICE).expand(MESH_RLS_LANES, 3, 3)),
                    regs, meas)
        sh_final, sh_thetas = rls_parallel_sharded(*rls_args, mesh, "model")
        one_final, one_thetas = rls_parallel(*rls_args)
        rls_record = {"thetas_rel": rel_err(sh_thetas, one_thetas),
                      "covariance_rel": rel_err(sh_final.covariance, one_final.covariance)}
        W = torch.randn((64, 64), generator=gen, device=DEVICE) * 0.2
        stage = lambda x: torch.tanh(x @ W)
        micro = torch.randn((8, 4096, 64), generator=gen, device=DEVICE)
        piped = pipeline_stages([stage], mesh, "model")(micro)
        serial = torch.stack([stage(x) for x in micro])
        pipe_record = {"bit_identical": bool(torch.equal(piped, serial)),
                       "max_abs": float((piped - serial).abs().max())}
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - start

    record = emit(
        "mesh", nvidia_smi=nvidia_smi_line(), **world, lanes=BATCH, ensemble=MESH_K,
        solve_lanes=MESH_K * BATCH, horizon=HORIZON, admm_iterations=2 * STAGE_ITERS,
        dtype="float32", backend="cuda_delta", identical_draws_vs_k1=identical,
        warm_ticks=warm_record, launches=counts, kernel_lanes_per_launch=sorted(set(lanes_seen)),
        launches_all_kernels=launches_all,
        tick_ms={k: statistics.median(v) for k, v in times.items()},
        tick_ms_min_max={k: [min(v), max(v)] for k, v in times.items()},
        peak_memory_gb=peak, nan_member=nan_record, rowsharded_qp=qp_record,
        sharded_lqr=lqr_record, sharded_rls=rls_record, pipeline_one_stage=pipe_record,
        phase_seconds=seconds)
    worst_same = max(v for k, v in identical.items() if k != "status_equal")
    check(worst_same <= MESH_SAME_TOL and identical["status_equal"],
          f"identical draws give the K = 1 tick within {MESH_SAME_TOL}: {identical}")
    check(warm_record["finite"] and warm_record["num_quarantined"] == 0,
          f"the ensemble's fleet stays finite, none quarantined: {warm_record}")
    check(by_tick[0] >= TICK_DELTA_FIRST_SHARE * BATCH,
          f"at least {TICK_DELTA_FIRST_SHARE:.0%} of lanes converged on the cold first tick: {by_tick}")
    check(min(by_tick[1:]) >= 0.99 * BATCH,
          f"at least 99% of lanes converged on every later tick: {by_tick}")
    check(warm_record["worst_margin"] <= MESH_MARGIN_TOL
          and warm_record["dcm_abs_max"] < MESH_DCM_BOUND,
          f"worst margin <= {MESH_MARGIN_TOL}, |DCM| < {MESH_DCM_BOUND}: {warm_record}")
    stages = 2 * MESH_WARM_TICKS
    check(counts["tc_delta"] == stages and launches_all == stages,
          f"one K1 launch a stage and no other kernel or plain run: {counts}, {launches_all}")
    check(lanes_seen == [MESH_K * BATCH] * stages,
          f"each launch carries all {MESH_K * BATCH} lanes of the ensemble: {sorted(set(lanes_seen))}")
    check(nan_record["lane_status"] == int(SolverStatus.NUMERICAL_ERROR)
          and nan_record["num_quarantined"] == 1 and confined and nan_record["finite"],
          f"the NaN member's lane is quarantined, every other lane untouched: {nan_record}")
    check(qp_record["x_max_abs"] <= MESH_QP_TOL
          and qp_record["converged"][0] >= qp_record["converged"][1] - 1,
          f"the row-sharded QP agrees with solve_qp_factored: {qp_record}")
    check(max(lqr_record.values()) <= LQR_TOL, f"solve_lqr_sharded agrees with solve_lqr: {lqr_record}")
    check(max(rls_record.values()) <= MESH_RLS_TOL,
          f"rls_parallel_sharded agrees with rls_parallel: {rls_record}")
    check(pipe_record["bit_identical"], f"the pipeline is the serial composition: {pipe_record}")
    check(seconds < MESH_SECONDS, f"the phase took {seconds:.1f} s, over {MESH_SECONDS}")
    return record


def record_stage_calls(run):
    """Runs ``run()`` with every call of K1's wrapper (``admm_stage``, as
    ``sol_rows`` and ``solve_qp_factored`` reach it) recorded: by (m, n, mode,
    iterations), the calls and the first and last call's arguments. Returns
    ``(run(), seen)``."""
    original, seen = admm_kernel.admm_stage, {}

    def record(*args, **kw):
        m, n = args[6].shape
        key = (m, n, kw.get("matmul", "f32"), kw["iters"])
        calls = seen.setdefault(key, {"calls": 0, "first": (args, kw)})
        calls["calls"] += 1
        calls["last"] = (args, kw)
        return original(*args, **kw)

    with mock.patch.object(admm_kernel, "admm_stage", record), \
            mock.patch.object(qp_module, "admm_stage", record):
        out = run()
    torch.cuda.synchronize()
    return out, seen


def sol_stage_cases(seen, m: int, n: int):
    """K1 at (m, n) against its plain version on the inputs the table handed
    it, B in SOL_BATCHES: the f32 kernel on the rows' first (cold) and last
    (settled) chained tick, to REL_TOL; "split" on both, to TC_SPLIT_TOL;
    "delta" over its 3-pass first iteration and its first increment of the
    cold tick and of the solves' first stage (as ``kernels_admm_stage_tc``),
    and over all iterations of the settled tick, to TC_WARM_TOL (its cold
    runs and the solves' last stage reported, not held); a NaN lane confined
    in every mode. Returns ``(f32 cases, tensor-core cases, the rows' cold
    arguments and keywords)``."""
    f32, tc = [], []
    cold, cold_kw = seen[(m, n, "f32", SOL_ITERS)]["first"]
    kw = dict(iters=cold_kw["iters"], alpha=cold_kw["alpha"])
    for where in ("first", "last"):
        args, _ = seen[(m, n, "f32", SOL_ITERS)][where]
        for B in SOL_BATCHES:
            sub = lanes_of(args[:6], B) + tuple(args[6:])
            v_k, tau_k = admm_kernel.admm_stage(*sub, **kw)
            torch.cuda.synchronize()
            v_p, tau_p = admm_kernel.admm_stage_reference(*sub, **kw)
            check(bool(torch.isfinite(v_k).all() and torch.isfinite(tau_k).all()),
                  f"admm_stage f32 at ({m}, {n}): kernel output finite on the {where} tick")
            ev, et = rel_err(v_k, v_p), rel_err(tau_k, tau_p)
            ea = max(float((v_k - v_p).abs().max()), float((tau_k - tau_p).abs().max()))
            f32.append({"inputs": f"sol_{where}_tick", "B": B, "iters": kw["iters"],
                        "rel_err_v": ev, "rel_err_tau": et, "max_abs_err": ea})
            check(ev <= REL_TOL and et <= REL_TOL,
                  f"admm_stage f32 agrees with its plain version to {REL_TOL} on the sol table's"
                  f" {where} tick at ({m}, {n}), B={B}: v {ev}, tau {et}")
    for where, tol in (("first", TC_SPLIT_TOL), ("last", TC_SPLIT_TOL)):
        args, _ = seen[(m, n, "split", SOL_ITERS)][where]
        for B in SOL_BATCHES:
            sub = lanes_of(args[:6], B) + tuple(args[6:])
            tc.append(tc_compare(sub, kw, "split", tol, f"sol_{where}_tick"))
    for key, name in (((m, n, "delta", SOL_ITERS), "sol_tick"),
                      ((m, n, "delta", STAGE_ITERS), "sol_solve_stage")):
        first, first_kw = seen[key]["first"]
        last, last_kw = seen[key]["last"]
        skw = dict(iters=first_kw["iters"], alpha=first_kw["alpha"])
        settled = name == "sol_tick"       # the chain's last tick, after 9 of 50 iterations
        for B in SOL_BATCHES:
            sub = lanes_of(first[:6], B) + tuple(first[6:])
            tc.append(tc_compare(sub, dict(skw, iters=1), "delta", TC_SPLIT_TOL, f"{name}_first"))
            tc.append(tc_compare(sub, dict(skw, iters=2), "delta", TC_STEP_TOL, f"{name}_first"))
            tc.append(tc_compare(sub, skw, "delta", None, f"{name}_first", hold=False))
            sub = lanes_of(last[:6], B) + tuple(last[6:])
            tc.append(tc_compare(sub, dict(iters=last_kw["iters"], alpha=last_kw["alpha"]),
                                 "delta", TC_WARM_TOL, f"{name}_last", hold=settled))
    nan_args = list(lanes_of(cold[:6], 1000) + tuple(cold[6:]))
    for matmul in ("f32",) + TC_MODES:
        nan_confined(nan_args, kw, matmul, f"admm_stage {matmul} at ({m}, {n}) on the sol table")
    return f32, tc, (cold, kw)


def f32_entry(cases: list, timed_args, kw, shape, path: str) -> dict:
    """The f32 kernel's entry at ``shape``: ``cases`` and its times on
    ``timed_args``."""
    m, n = shape
    B = timed_args[0].shape[0]
    kernel_ms = median_ms(lambda: admm_kernel.admm_stage(*timed_args, **kw), 2, 7)
    plain_ms = median_ms(lambda: admm_kernel.admm_stage_reference(*timed_args, **kw), 1, 3)
    bound = f32_stage_bound(m, n, B, kw["iters"])
    return {"name": "admm_stage", "path": path, "shape": [m, n], "iters": kw["iters"],
            "batch_timed": B, "cases": cases, "nan_lane": "confined",
            "max_rel_err": max(max(c["rel_err_v"], c["rel_err_tau"]) for c in cases),
            "max_abs_err": max(c["max_abs_err"] for c in cases), "tolerance_rel": REL_TOL,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, **bound,
            "fraction_of_bound": bound["bound_ms"] / kernel_ms, "library_ms": None}


def phase_sol() -> dict:
    """``python -m blf_tpu_torch.utils.profiling``'s speed-of-light table on
    the card (``profiling.sol_rows``), one JSON line a row: every time
    positive, every row scored by a kernel's cost model within its bound,
    K1 launched in all three modes and K5 with no plain run, and the spec
    detected from the card's name. Then K1 at both of the table's shapes
    against its plain version on the inputs the table handed it
    (``sol_stage_cases``), and its entries at (SOL_M, SOL_N), a shape no
    other path runs."""
    kind = torch.cuda.get_device_name(0)
    check(SPEC == profiling.spec_for_name(kind), f"the spec follows the card's name {kind!r}")
    if kind == "NVIDIA H100 80GB HBM3":
        check(SPEC.name == "H100 SXM", f"{kind} is scored as the H100 SXM, not {SPEC}")
    reset_all_counts()
    t0 = time.perf_counter()
    with profiling.trace("sol_rows"):          # an NVTX range on the card
        rows, seen = record_stage_calls(profiling.sol_rows)
    seconds = time.perf_counter() - t0
    counts = stage_counts()
    launches = {"f32": counts["f32"], "tc_delta": counts["tc_delta"],
                "tc_split": counts["tc_split"], "foot": rollout_kernel.launch_count(),
                "plain": counts["plain"] + rollout_kernel.reference_count()}
    # K1's launches by shape: the wrapper's calls by shape, which add up to its counts
    shapes = sorted({key[:2] for key in seen})
    check(shapes == sorted([(SOL_M, SOL_N), (M, N)]),
          f"the table runs K1 at ({SOL_M}, {SOL_N}) and ({M}, {N}): {shapes}")
    by_shape = {f"{m}x{n}": {f"tc_{mode}" if mode != "f32" else mode:
                             sum(c["calls"] for key, c in seen.items()
                                 if key[:3] == (m, n, mode))
                             for mode in ("f32",) + TC_MODES} for m, n in shapes}
    for mode in ("f32", "tc_delta", "tc_split"):
        check(sum(s[mode] for s in by_shape.values()) == launches[mode],
              f"K1's {mode} launches add up by shape: {by_shape}, {launches}")
    # measure (CUDA events), cost_analysis and the spec of the arguments' device
    x = torch.randn((SOL_MATMUL, SOL_MATMUL), device=DEVICE)
    matmul = profiling.sol_report(torch.matmul, x, x, label=f"matmul {SOL_MATMUL} f32")
    check(matmul["flops"] == 2 * SOL_MATMUL ** 3 and matmul["bound"] == "compute"
          and 0 < matmul["sol_frac"] <= SOL_FRAC_MAX and matmul["chip"] == SPEC.name,
          f"sol_report of a float32 matmul: {matmul}")
    del x
    for row in rows + [matmul]:
        print(json.dumps({"sol_row": row}), flush=True)
    for row in rows:
        check(row["time_s"] > 0, f"{row['label']}: a positive time")
        if "tensor_core_util" in row:     # scored by a KernelCost
            check(0 < row["sol_frac"] <= SOL_FRAC_MAX,
                  f"{row['label']}: within its bound, sol_frac {row['sol_frac']}")
    check(min(launches[k] for k in ("f32", "tc_delta", "tc_split", "foot")) > 0
          and launches["plain"] == 0, f"the table ran K1 in every mode and K5, no plain run:"
                                      f" {launches}")
    check(seconds < SOL_SECONDS, f"the table in {seconds:.1f} s (limit {SOL_SECONDS})")

    # K1 against its plain version on the table's own inputs, after the counts were read
    entries, held = [], {}
    for m, n in shapes:
        f32, tc, (cold, kw) = sol_stage_cases(seen, m, n)
        if (m, n) == (SOL_M, SOL_N):
            entries += [f32_entry(f32, cold, kw, (m, n), "sol"),
                        tc_entry(tc, cold, kw, (m, n), path="sol")]
        else:
            held_tc = [c for c in tc if c["tolerance_rel"] is not None]
            held[f"{m}x{n}"] = {
                "admm_stage": {"max_rel_err": max(max(c["rel_err_v"], c["rel_err_tau"])
                                                  for c in f32),
                               "max_abs_err": max(c["max_abs_err"] for c in f32)},
                "admm_stage_tc": {"max_rel_err": max(max(c["rel_err_v"], c["rel_err_tau"])
                                                     for c in held_tc),
                                  "max_abs_err": max(c["max_abs_err"] for c in held_tc)},
                "cases": f32 + tc}
    del seen, cold
    return emit("sol", spec=dataclasses.asdict(SPEC), rows=len(rows), launches=launches,
                launches_by_shape=by_shape, table_seconds=round(seconds, 1),
                held_at_other_shapes=held, entries=entries,
                seconds=round(time.perf_counter() - t0, 1))


def study_factorization(problem, lanes: int = STUDY_LANES, ticks: int = 8) -> dict:
    """Diagnostic, off by default: where the factorization is computed, and in
    which precision, against the fleet's convergence over the first ticks.

    The tick factors its shared operator in float64 on the card and casts the
    factors to float32 (``factor_shared_qp``). This runs the same ticks with
    the factorization forced to float32 on the card (what the port did at
    first, and what the reference does in its working dtype), with what the
    tick does, and with float32 on the CPU (LAPACK), and reports the converged
    lanes and the max dual residual per tick for each.
    """
    defaults = dict(rho=1.0, sigma=1e-6, rho_eq_scale=30.0, scaling_iters=10)

    def forced_float32(P, A, is_eq, reuse=None, **kw):
        # the factorization body in the working dtype, without the widening;
        # every tick factors (nothing is reused)
        return qp_module._factor_shared_qp(P, A, is_eq, **{**defaults, **kw})

    def on_cpu(P, A, is_eq, reuse=None, **kw):
        f = forced_float32(P.cpu(), A.cpu(), is_eq.cpu(), **kw)
        return SharedQPFactors(*(None if t is None else t.to(DEVICE) for t in f))

    refs = (problem.dcm_ref, problem.zmp_ref, problem.poly_A, problem.poly_b)
    dist = problem.disturbance[:lanes].contiguous()
    rows = {}
    for name, fn in (("card_float32_forced", forced_float32),
                     ("card_float64_cast", factor_shared_qp), ("cpu_float32", on_cpu)):
        with mock.patch.object(dcm_module, "factor_shared_qp", fn):
            state = init_fleet(lanes, HORIZON, problem.num_constraints, problem.dcm0,
                               problem.com0, device=DEVICE, dtype=torch.float32)
            step = make_fleet_step(problem.params, problem.dt, iterations=2 * STAGE_ITERS,
                                   backend="cuda", device=DEVICE)
            conv, dual = [], []
            for _ in range(ticks):
                state, result = step(state, dist, *refs)
                conv.append(int(result.stats.num_converged))
                dual.append(float(result.stats.max_dual_residual))
        rows[name] = {"converged": conv, "max_dual_residual": dual}
    return emit("factor_study", lanes=lanes, backend="cuda", by_factorization=rows)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="also profile two ticks with torch.profiler")
    ap.add_argument("--study-factorization", action="store_true",
                    help="also compare float32/float64/CPU factorizations over 8 ticks")
    opts = ap.parse_args()
    phases = opts.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    t0 = time.perf_counter()
    device = phase_device()
    problem = stationary_push_recovery(BATCH, HORIZON, seed=SEED,
                                       device=DEVICE, dtype=torch.float32)
    if "build" in phases:
        phase_build()
    kernels = phase_kernels(problem, device) if "kernels" in phases else None
    tick = tick_delta = wbc = stack = stack_cross = None
    if "tick" in phases:
        check(kernels is not None, "the tick phase needs the kernels phase's timing")
        tick = phase_tick(problem, kernels["admm_stage"]["kernel_ms"], opts.profile)
    if "cross" in phases:
        phase_cross(problem)
    if "tick_delta" in phases:
        check(kernels is not None, "the tick_delta phase needs the kernels phase's timing")
        tick_delta = phase_tick(problem, kernels["admm_stage_tc"]["kernel_ms"], opts.profile,
                                backend="cuda_delta")
    if "cross_delta" in phases:
        phase_cross_delta(problem)
    if "wbc" in phases:
        check(kernels is not None, "the wbc phase needs the kernels phase's timing")
        wbc = phase_wbc(kernels, opts.profile)
    if "wbc_cross" in phases:
        phase_wbc_cross()
    if "stack" in phases:
        stack = phase_stack(opts.profile)
    if "stack_cross" in phases:
        stack_cross = phase_stack_cross()
    foot = phase_foot() if "foot" in phases else None
    ident = phase_identify() if "identify" in phases else None
    gait = phase_gait() if "gait" in phases else None
    gait_delta = phase_gait_delta() if "gait_delta" in phases else None
    if "dcm_planner" in phases:
        phase_dcm_planner()
    resume = phase_resume(problem) if "resume" in phases else None
    mesh = phase_mesh(problem) if "mesh" in phases else None
    sol = phase_sol() if "sol" in phases else None
    if opts.study_factorization:
        study_factorization(problem)

    print(device["nvidia_smi"], flush=True)
    if kernels is not None:
        # launches of each kernel on each path, counted from 0 just before it
        none = {}
        wbc_l = wbc["kernel_launches"] if wbc else none
        stack_l = stack["launches"] if stack else none
        k1_none = {"f32": 0, "tc_delta": 0, "tc_split": 0}
        sol_k1 = sol["launches_by_shape"].get(f"{M}x{N}", k1_none) if sol else k1_none
        sol_small = sol["launches_by_shape"].get(f"{SOL_M}x{SOL_N}", k1_none) if sol else k1_none
        if sol:
            # the table's K1 entries at its own shape, and its agreement at the tick's
            kernels.update({e["name"] + "@sol": e for e in sol["entries"]})
            for name, err in sol["held_at_other_shapes"].get(f"{M}x{N}", {}).items():
                if name in kernels:
                    for key in ("max_rel_err", "max_abs_err"):
                        kernels[name][key] = max(kernels[name][key], err[key])
        by_path = {
            "admm_stage": {"tick": tick["kernel_launches"] if tick else 0,
                           "resume": resume["launches"] if resume else 0,
                           "sol": sol_k1["f32"]},
            "admm_stage_tc": {"tick_delta": tick_delta["kernel_launches"] if tick_delta else 0,
                              "mesh": mesh["launches"]["tc_delta"] if mesh else 0,
                              "sol_delta": sol_k1["tc_delta"], "sol_split": sol_k1["tc_split"]},
            "admm_stage@sol": {"sol": sol_small["f32"]},
            "admm_stage_tc@sol": {"sol_delta": sol_small["tc_delta"],
                                  "sol_split": sol_small["tc_split"]},
            "admm_stage@stack": {"stack": stack_l.get("admm_stage", 0),
                                 "stack_cross": stack_cross["admm_stage_launches"]
                                 if stack_cross else 0},
            "admm_stage_tc@stack": {"stack": stack_l.get("admm_stage_tc", 0)},
            "admm_lane_stage": {"wbc": wbc_l.get("admm_lane_stage", 0)},
            "admm_lane_stage@stack": {"stack": stack_l.get("admm_lane_stage", 0)},
            "cholesky_inverse_lane": {"wbc": wbc_l.get("cholesky_inverse_lane", 0),
                                      "stack": stack_l.get("cholesky_inverse_lane_n64", 0)},
            "cholesky_inverse_lane@stack": {
                "stack": stack_l.get("cholesky_inverse_lane_n29", 0)},
            "cholesky_solve_lane@stack": {"stack": stack_l.get("cholesky_solve_lane", 0)},
            "foot_rollout_fused": {"foot": foot["launches"] if foot else 0,
                                   "identify": ident["launches"] if ident else 0,
                                   "sol": sol["launches"]["foot"] if sol else 0},
            "admm_stage_l2": {"gait": gait["launches"]["l2"] if gait else 0},
            "admm_stage_tc_l2": {
                "gait_delta": gait_delta["launches"]["tc_l2_delta"] if gait_delta else 0,
                "gait_split": gait_delta["split"]["launches"]["tc_l2_split"]
                if gait_delta else 0},
        }
        origin = {"admm_stage": (admm_kernel.SOURCE, admm_kernel.REPLACES),
                  "admm_stage_l2": (admm_kernel.L2_SOURCE, admm_kernel.L2_REPLACES),
                  "admm_stage_tc": (admm_kernel.TC_SOURCE, admm_kernel.TC_REPLACES),
                  "admm_stage_tc_l2": (admm_kernel.TC_L2_SOURCE, admm_kernel.TC_L2_REPLACES),
                  "admm_lane_stage": (lane_kernel.SOURCE, lane_kernel.REPLACES),
                  "cholesky_inverse_lane": (chol_kernel.SOURCE, chol_kernel.REPLACES),
                  "cholesky_solve_lane": (chol_kernel.SOLVE_SOURCE, chol_kernel.SOLVE_REPLACES),
                  "foot_rollout_fused": (rollout_kernel.SOURCE, rollout_kernel.REPLACES)}
        print(json.dumps({"kernels": [{
            "name": k["name"], "route": "cuda", "shape": k["shape"],
            "source": "blf_tpu_torch/csrc/" + origin[k["name"]][0],
            "replaces": origin[k["name"]][1],
            "launches": sum(by_path[key].values()), "launches_by_path": by_path[key],
            "max_abs_err": k["max_abs_err"], "max_rel_err": k["max_rel_err"],
            "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            **({"ms_by_mode": {mode: v["kernel_ms"] for mode, v in k["modes"].items()}}
               if "modes" in k else {}),
        } for key, k in kernels.items() if key in by_path],
            "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    ran_all = set(phases) == set(PHASES)
    print(json.dumps({"ok": ran_all, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    if not ran_all:
        raise SystemExit(4)   # a partial run is never a pass


if __name__ == "__main__":
    main()
