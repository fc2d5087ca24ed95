#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py            # every phase, one GPU, a few minutes

Drives ``blf_tpu_torch`` only (nothing of JAX). It builds the CUDA kernels from
the sources in this checkout at first use, holds each kernel against its plain
PyTorch version on the card, runs the port's main path (the warm-started
push-recovery fleet tick at batch 98304, horizon 32, 50 ADMM iterations,
float32, ``backend="cuda"``) through the entry points a user calls, checks the
result, and shows that the path went through the kernels by their launch
counts. Each phase prints one JSON line; no phase's failure is caught, so any
exception or failed check ends the run with a non-zero exit code.

Bounds are derived from NVIDIA's H100 SXM data sheet (67 TFLOP/s float32
outside the tensor cores, 3.35 TB/s device memory) and are labelled so.

The size is fixed (``BATCH``, ``TICKS``, ``SCANS``, ``SEED`` below): a run at
another width would prove nothing about the port. ``--phases`` runs a subset
while developing (and then exits 4: a partial run is never a pass);
``--profile`` and ``--study-factorization`` add diagnostics to the full run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

from blf_tpu_torch.mpc.dcm import build_dcm_qp
from blf_tpu_torch.mpc.qp import factor_shared_qp
from blf_tpu_torch.ops.cuda import _build
from blf_tpu_torch.ops.cuda import admm as admm_kernel
from blf_tpu_torch.parallel.sweep import init_fleet, make_fleet_step
from blf_tpu_torch.problems import stationary_push_recovery
from blf_tpu_torch.utils.status import status_counts
from blf_tpu_torch.utils.telemetry import TelemetryStream

# NVIDIA H100 SXM data sheet
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

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
# phase `cross`: absolute, in the plan's metres (and the duals' units)
SAME_STATE_TOL = 1e-5     # one tick from the same state: every tick, every lane
SETTLED_FROM_TICK = 6     # independent fleets: all converged, identical status
REJOINED_FROM_TICK = 9    # independent fleets: every lane within REJOINED_TOL
REJOINED_TOL = 1e-4
DEVICE = torch.device("cuda")
PHASES = ("device", "build", "kernels", "tick", "cross")


def emit(phase: str, **fields) -> dict:
    record = {"phase": phase, **fields}
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
    return emit(
        "device", nvidia_smi=nvidia_smi_line(),
        kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=" | ".join(nvcc), numpy=np.__version__,
        capability=list(torch.cuda.get_device_capability(0)),
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def phase_build() -> dict:
    t0 = time.perf_counter()
    admm_kernel.build_admm_stage(M, N)
    seconds = time.perf_counter() - t0
    log = _build.last_build_log(admm_kernel.SOURCE, {"ADMM_M": M, "ADMM_N": N})
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    return emit("build", seconds=round(seconds, 2), shape=[M, N],
                shared_bytes=admm_kernel.stage_shared_bytes(M, N), ptxas=ptxas)


def stage_operators(problem):
    """(P, A, is_eq, factors) of the production transcription's shared operator."""
    dcm0 = problem.dcm0[None, :]
    P, _, A, _, _ = build_dcm_qp(problem.params, problem.dt, dcm0, problem.dcm_ref,
                                 problem.zmp_ref, problem.poly_A, problem.poly_b)
    is_eq = torch.arange(A.shape[0], device=DEVICE) < 2 * HORIZON
    return P, A, is_eq, factor_shared_qp(P, A, is_eq)


def stage_inputs(problem, factors, B: int, seed: int):
    """Stage inputs at the shapes the tick gives the kernel: scaled bounds of
    the transcription (polygon rows have l = -inf) for random initial DCMs, a
    random iterate, s spread over [1e-2, 1e2]."""
    rng = np.random.default_rng(seed)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
    dcm0 = as_t(rng.normal(0, 0.02, (B, 2)))
    _, q, _, l, u = build_dcm_qp(problem.params, problem.dt, dcm0, problem.dcm_ref,
                                 problem.zmp_ref, problem.poly_A, problem.poly_b)
    f = factors
    lb = (f.E * l).contiguous()
    ub = (f.E * u).contiguous()
    q = q + as_t(rng.normal(0, 0.05, (B, N)))
    gq = ((f.c * (q * f.D)) @ f.W).contiguous()
    v = as_t(rng.normal(0, 0.1, (B, M)))
    tau = torch.zeros((B, N), dtype=torch.float32, device=DEVICE)
    s = as_t(10.0 ** rng.uniform(-2, 2, (B, 1)))
    return v, tau, s, gq, lb, ub, f.G2.contiguous(), f.d, f.base_rho


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def phase_kernels(problem) -> dict:
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
    del v_k, tau_k, v_p, tau_p
    kernel_ms = statistics.median(
        time_cuda(lambda: admm_kernel.admm_stage(*args, **kw), warmup=2, reps=7))
    plain_ms = statistics.median(
        time_cuda(lambda: admm_kernel.admm_stage_reference(*args, **kw),
                  warmup=1, reps=3))
    flops = STAGE_ITERS * 2 * (2 * M * N) * batch
    nbytes = 4 * (batch * ((3 * M + 2 * N + 1) + (M + N)) + M * N + M + N)
    ops_ms, bytes_ms = 1e3 * flops / PEAK_F32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    entry = {
        "name": "admm_stage", "shape": [M, N], "iters": STAGE_ITERS,
        "batch_timed": batch, "cases": cases, "nan_lane": "confined",
        "max_rel_err": max_rel, "max_abs_err": max_abs, "tolerance_rel": REL_TOL,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
        "bound_source": "H100 SXM data sheet: 67 TFLOP/s f32, 3.35 TB/s",
        "tflops": flops / (kernel_ms * 1e-3) / 1e12,
        "launches_this_phase": admm_kernel.launch_count(),
    }
    emit("kernels", kernels=[entry])
    return entry


def all_finite(state) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in state)


def phase_tick(problem, kernel_ms: float, profile: bool) -> dict:
    batch, ticks, scans = BATCH, TICKS, SCANS
    state = init_fleet(batch, HORIZON, problem.num_constraints, problem.dcm0,
                       problem.com0, device=DEVICE, dtype=torch.float32)
    step = make_fleet_step(problem.params, problem.dt, iterations=2 * STAGE_ITERS,
                           backend="cuda", device=DEVICE)
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
    launches = admm_kernel.launch_count()  # read just after the main path
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
    counts = status_counts(result.status)

    check(all_finite(state), "every state field is finite")
    check(record["quarantined"] == 0, f"no lane quarantined, got {record['quarantined']}")
    check(record["scenarios"] == batch, "num_scenarios equals the batch")
    check(record["converged"] >= 0.99 * batch,
          f"at least 99% of lanes converged on the last tick, got {record['converged']}/{batch}")
    first_ticks = [int(c) for c in torch.stack(converged_by_tick[:ticks]).tolist()]
    min_timed = int(torch.stack(converged_by_tick[ticks:]).min())
    check(min_timed >= 0.99 * batch,
          f"at least 99% of lanes converged on every timed tick, worst {min_timed}/{batch}")
    check(launches == 2 * n_ticks,
          f"exactly 2 kernel launches per tick: {launches} in {n_ticks} ticks")
    check(admm_kernel.reference_count() == 0, "the plain version never ran on the main path")
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
        "dtype": "float32", "backend": "cuda", "ticks_per_scan": ticks, "scans": scans,
        "tick_ms": tick_ms, "tick_ms_scan_median": statistics.median(scan_ms),
        "tick_ms_min": min(scan_ms), "tick_ms_max": max(scan_ms),
        "solves_per_s": batch / (tick_ms * 1e-3),
        "kernel_ms_per_tick": 2 * kernel_ms, "factor_ms_per_tick": factor,
        "share_kernel": 2 * kernel_ms / tick_ms, "share_factor": factor / tick_ms,
        "share_rest": 1.0 - (2 * kernel_ms + factor) / tick_ms,
        "num_converged": record["converged"], "num_quarantined": record["quarantined"],
        "max_primal_residual": record["max_primal_residual"],
        "max_dual_residual": record["max_dual_residual"],
        "worst_margin": record["worst_margin"], "status_counts": counts,
        "converged_first_ticks": first_ticks, "converged_min_timed_ticks": min_timed,
        "kernel_launches": launches, "launches_per_tick": launches / n_ticks,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if profile:
        out["profile"] = profile_ticks(run, state)
        out["device_idle_share"] = 1.0 - out["profile"]["device_ms_per_tick"] / tick_ms
    emit("tick", **out)
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
    status. The independent fleets are held so on ticks 1 and 2 (the cold
    solve and the first warm-started one). On ticks 3 to 5 most lanes miss the
    tolerance within 50 iterations (the float32 factorization's transient) and
    where such a lane stops depends on rounding-level differences of the state
    it started from, so the fleets part by up to 2e-3 m and the closed loop
    then draws them together again, roughly halving the gap each tick. They
    are held to identical status with every lane converged from tick
    ``SETTLED_FROM_TICK`` on, and on every lane to ``REJOINED_TOL`` from tick
    ``REJOINED_FROM_TICK`` on.
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
               tolerance_abs_independent_ticks_1_2=SAME_STATE_TOL,
               settled_from_tick=SETTLED_FROM_TICK, rejoined_from_tick=REJOINED_FROM_TICK,
               tolerance_abs_independent_rejoined=REJOINED_TOL,
               status_counts=status_counts(result_c.status))
    for rec in per_tick:
        k = rec["tick"]
        for name in ("same_state", "independent"):
            cmp, what = rec[name], f"tick {k}, {name}"
            check(cmp["finite"], f"{what}: both states finite")
            if name == "same_state" or k <= 2:
                tol = SAME_STATE_TOL
            elif k >= REJOINED_FROM_TICK:
                tol = REJOINED_TOL
            else:
                tol = None
            if tol is not None:
                for field, dv in cmp["max_abs_diff"].items():
                    check(dv <= tol, f"{what}: every lane agrees on {field} to {tol}, got {dv}")
            if tol is not None or k >= SETTLED_FROM_TICK:
                check(cmp["status_mismatches"] == 0, f"{what}: identical per-lane status")
            if k <= 2 or k >= SETTLED_FROM_TICK:
                check(cmp["converged"] == [lanes, lanes], f"{what}: every lane converged")
    return out


def study_factorization(problem, lanes: int = STUDY_LANES, ticks: int = 8) -> dict:
    """Diagnostic, off by default: where the factorization is computed, and in
    which precision, against the fleet's convergence over the first ticks.

    The tick factors its shared operator in float32 on the card. This runs the
    same ticks with the factorization made in float64 on the card and cast to
    float32, and made in float32 on the CPU (LAPACK), and reports the converged
    lanes and the max dual residual per tick for each.
    """
    from unittest import mock

    import blf_tpu_torch.mpc.dcm as dcm_module
    from blf_tpu_torch.mpc.qp import SharedQPFactors

    def in_float64(P, A, is_eq, **kw):
        f = factor_shared_qp(P.double(), A.double(), is_eq, **kw)
        return SharedQPFactors(*(t.float() for t in f))

    def on_cpu(P, A, is_eq, **kw):
        f = factor_shared_qp(P.cpu(), A.cpu(), is_eq.cpu(), **kw)
        return SharedQPFactors(*(t.to(DEVICE) for t in f))

    refs = (problem.dcm_ref, problem.zmp_ref, problem.poly_A, problem.poly_b)
    dist = problem.disturbance[:lanes].contiguous()
    rows = {}
    for name, fn in (("card_float32", factor_shared_qp), ("card_float64_cast", in_float64),
                     ("cpu_float32", on_cpu)):
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
    kernel = phase_kernels(problem) if "kernels" in phases else None
    tick = None
    if "tick" in phases:
        check(kernel is not None, "the tick phase needs the kernels phase's timing")
        tick = phase_tick(problem, kernel["kernel_ms"], opts.profile)
    if "cross" in phases:
        phase_cross(problem)
    if opts.study_factorization:
        study_factorization(problem)

    print(device["nvidia_smi"], flush=True)
    if kernel is not None:
        print(json.dumps({"kernels": [{
            "name": "admm_stage", "route": "cuda",
            "source": "blf_tpu_torch/csrc/" + admm_kernel.SOURCE,
            "replaces": admm_kernel.REPLACES,
            "launches": tick["kernel_launches"] if tick else 0,
            "max_abs_err": kernel["max_abs_err"], "max_rel_err": kernel["max_rel_err"],
            "ms": kernel["kernel_ms"], "plain_ms": kernel["plain_ms"],
            "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
            "library_ms": None,
        }], "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    ran_all = set(phases) == set(PHASES)
    print(json.dumps({"ok": ran_all, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    if not ran_all:
        raise SystemExit(4)   # a partial run is never a pass


if __name__ == "__main__":
    main()
