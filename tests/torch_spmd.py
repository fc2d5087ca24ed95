"""The ranks of the port's multi-device tests: a ``gloo`` world of spawned
processes on the CPU.

A test file starts one :class:`World` in a module fixture: ``size`` ranks,
each running one function of this module (``mesh_cases`` or
``sharding_cases``) on the same payload of numpy arrays, meeting through a
``FileStore`` under the test's temporary directory (test workers run side
by side, so no TCP port is shared). Each rank runs every case of its file and
writes what it found, numpy arrays only, to a file of its own; the test
process meanwhile runs the JAX references and then compares.

This module imports torch, numpy and ``blf_tpu_torch`` only: a spawned rank
imports it to find its function, and a rank must not load JAX. Every
collective of a world has a timeout, and the world as a whole a deadline
after which every rank is killed; a rank that fails ends the world at once.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import pickle
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

WORLD = 4
COLLECTIVE_TIMEOUT_S = 60      # every collective of a world
DEADLINE_S = 150               # a world, from the start of its processes to its last result

# the fleet tick of the mesh tests: small, float64, as tests/test_sharding.py's
FLEET = dict(B=16, H=8, TICKS=3, DT=0.1, QP=dict(iterations=100, polish_iters=25))
NAN_LANE, NAN_MEMBER_LANE = 9, 5     # a lane of rank 2 on (4, 1); a lane of data shard 0 on (2, 2)


class World:
    """``size`` spawned ranks running ``cases`` on ``payload``; :meth:`results`
    waits for them (up to the deadline) and returns each rank's record."""

    def __init__(self, cases: str, payload, tmp_path: Path, size: int = WORLD,
                 deadline_s: float = DEADLINE_S):
        ctx = multiprocessing.get_context("spawn")
        self.out = Path(tmp_path)
        self.size = size
        # the payload goes by file: handed over the start pipe it would hold
        # each start until that rank had imported torch
        with open(self.out / "payload.pkl", "wb") as f:
            pickle.dump(payload, f)
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(rank, size, str(self.out / "store"), cases,
                                        str(self.out)))
                      for rank in range(size)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + deadline_s
        self._results = None

    def _stop(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5)

    def results(self):
        if self._results is not None:
            return self._results
        try:
            while any(p.is_alive() for p in self.procs):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"the world did not finish within {DEADLINE_S} s")
                if any(p.exitcode not in (None, 0) for p in self.procs):
                    break                                   # a rank failed: end the world now
                time.sleep(0.05)
        finally:
            self._stop()
        records = []
        for rank in range(self.size):
            path = self.out / f"rank{rank}.pkl"
            if not path.exists():
                records.append({"error": f"rank {rank} left no record"
                                         f" (exit code {self.procs[rank].exitcode})"})
                continue
            with open(path, "rb") as f:
                records.append(pickle.load(f))
        errors = [f"rank {r}: {rec['error']}" for r, rec in enumerate(records) if rec.get("error")]
        if errors:
            raise RuntimeError("\n".join(errors))
        self._results = [rec["cases"] for rec in records]
        return self._results


def _rank_main(rank: int, size: int, store: str, cases: str, out: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from blf_tpu_torch.parallel.mesh import init_distributed

    record = {"cases": {}, "error": None}
    try:
        with open(os.path.join(out, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        init_distributed(f"file://{store}", size, rank, device="cpu",
                         timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        globals()[cases](payload, record["cases"])
    except BaseException:                                   # recorded, then the rank exits 1
        record["error"] = traceback.format_exc()
    tmp = os.path.join(out, f"rank{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(record, f)
    os.replace(tmp, os.path.join(out, f"rank{rank}.pkl"))
    if record["error"]:
        os._exit(1)                                         # the others may wait in a collective
    dist.destroy_process_group()


@contextlib.contextmanager
def world_of_one(**mesh_kw):
    """A world of one in this process (an in-process store, ``gloo``) and its
    mesh of one; the world is ended on exit if this call started it."""
    import torch.distributed as dist

    from blf_tpu_torch.parallel.mesh import make_mesh

    started = not dist.is_initialized()
    try:
        yield make_mesh(1, device="cpu", **mesh_kw)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def numpy_tree(tree):
    """Every tensor of a (nested) NamedTuple, tuple, list or dict as numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: numpy_tree(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [numpy_tree(v) for v in tree]
    return tree


def raised(fn, exc=ValueError):
    """The message of the ``exc`` that ``fn()`` raised, or None."""
    try:
        fn()
    except exc as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# tests/test_torch_mesh.py: the mesh, the tree reductions, the fleet tick
# ---------------------------------------------------------------------------

def members_of(t: torch.Tensor, mesh) -> torch.Tensor:
    """A rank's block of a global (B, K, ...) ensemble tensor: its data shard
    of the lanes and its model shard of the members."""
    from blf_tpu_torch.parallel.mesh import axis_index, axis_size, shard_batch

    lanes = shard_batch(t, mesh)
    k = lanes.shape[1] // axis_size(mesh, "model")
    i = axis_index(mesh, "model")
    return lanes[:, i * k:(i + 1) * k]


def tick_record(state, result):
    return {"state": numpy_tree(state), "result": numpy_tree(result)}


def mesh_cases(payload, rec) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from blf_tpu_torch.convert import fleet_state_from_numpy
    from blf_tpu_torch.parallel import mesh as M
    from blf_tpu_torch.parallel.collectives import pmax_tree, psum_tree, reduce_fleet_stats
    from blf_tpu_torch.parallel.sweep import make_fleet_step
    from blf_tpu_torch.problems import stationary_push_recovery

    rank = dist.get_rank()
    rec["rank"] = rank
    rec["init_again"] = M.init_distributed(device="cpu")          # idempotent

    # --- the mesh ---------------------------------------------------------
    mesh22 = M.make_mesh(4, model_axis=2, device="cpu")
    mesh41 = M.make_mesh(4, device="cpu")
    mesh1 = M.make_mesh(1, device="cpu")                          # rank 0 alone; all build it
    rec["mesh22"] = {"shape": tuple(mesh22.mesh.shape), "names": mesh22.mesh_dim_names,
                     "coordinate": mesh22.get_coordinate(),
                     "sizes": (M.axis_size(mesh22, "data"), M.axis_size(mesh22, "model"))}
    rec["mesh1_coordinate"] = mesh1.get_coordinate()
    rec["raises"] = {"model_axis_3": raised(lambda: M.make_mesh(4, model_axis=3, device="cpu")),
                     "1024": raised(lambda: M.make_mesh(1024, device="cpu"))}
    x = torch.arange(64.0).reshape(16, 4)
    sharded, replicated = M.data_parallel_specs(mesh22)
    rec["placement"] = {
        "shard41": M.shard_batch(x, mesh41).numpy(),
        "shard22": M.shard_batch({"x": x, "y": (x[:, 0],)}, mesh22)["x"].numpy(),
        "replicate": M.replicate(np.ones(3), mesh41).numpy(),
        "gathered": M.gather_batch(M.shard_batch(x, mesh41), mesh41).numpy(),
        "dtensor_sharded": distribute_tensor(x, mesh22, sharded).to_local().numpy(),
        "dtensor_replicated": distribute_tensor(x, mesh22, replicated).to_local().numpy(),
        "specs": (repr(sharded), repr(replicated)),
        "outside": raised(lambda: M.shard_batch(x, mesh1)) if rank else None}

    # --- the tree reductions: NaN kept whatever rank holds it -------------
    group = mesh41.get_group("data")
    vals = torch.tensor([1.0 + rank, float("nan") if rank == 2 else -rank,
                         float("nan") if rank == 0 else 2.0, float("-inf")], dtype=torch.float64)
    tree = {"v": vals, "i": torch.tensor([rank, 3 - rank], dtype=torch.int32),
            "e": torch.ones(2, dtype=torch.float64).expand(3, 2)}
    before = numpy_tree(tree)
    rec["reductions"] = {"pmax": numpy_tree(pmax_tree(tree, group)),
                         "psum": numpy_tree(psum_tree(tree, group)),
                         "inputs_after": numpy_tree(tree), "inputs_before": before}

    # --- reduce_fleet_stats over the data axis ----------------------------
    lanes = payload["stats_lanes"]
    from blf_tpu_torch.mpc.qp import QPSolution
    sol = QPSolution(*(None,) * 3, *(M.shard_batch(torch.as_tensor(lanes[k]), mesh41)
                                     for k in ("primal_residual", "dual_residual",
                                               "converged", "objective")))
    rec["stats"] = numpy_tree(reduce_fleet_stats(sol, group))

    # --- the fleet tick ---------------------------------------------------
    f = payload["fleet"]
    dtype = getattr(torch, payload["dtype"].split(".")[-1])
    pr = stationary_push_recovery(FLEET["B"], FLEET["H"], device="cpu", dtype=dtype)
    refs = (pr.dcm_ref, pr.zmp_ref, pr.poly_A, pr.poly_b)
    state0 = fleet_state_from_numpy(f["state0"], device="cpu", dtype=dtype)
    build = lambda mesh: make_fleet_step(pr.params, FLEET["DT"], device="cpu", mesh=mesh,
                                         **FLEET["QP"])

    def run(mesh, dists, state=state0):
        step, st, out = build(mesh), M.shard_batch(state, mesh), []
        for d in dists:
            st, result = step(st, members_of(torch.as_tensor(d), mesh), *refs)
            out.append(tick_record(st, result))
        return out

    rec["tick22"] = run(mesh22, f["dist22"])
    rec["tick41"] = run(mesh41, f["dist41"])
    poisoned = state0._replace(dcm=state0.dcm.clone())
    poisoned.dcm[NAN_LANE] = float("nan")
    rec["nan41"] = run(mesh41, f["dist41"][:1], poisoned)[0]
    rec["nan22"] = run(mesh22, f["dist22_nan"][:1])[0]
    rec["tick1"] = run(mesh1, f["dist12"]) if rank == 0 else None
    rec["outside_tick"] = raised(lambda: build(mesh1)) if rank else None


# ---------------------------------------------------------------------------
# tests/test_torch_sharding.py: the row-sharded QP, the sharded LQR and RLS,
# the pipeline
# ---------------------------------------------------------------------------

def pytree_stages():
    return [lambda c: {"x": c["x"] + 1.0, "y": c["y"]},
            lambda c: {"x": c["x"], "y": c["y"] * 2.0},
            lambda c: {"x": c["x"] * c["y"], "y": c["y"]},
            lambda c: {"x": c["x"] - c["y"], "y": c["y"]}]


def mpc_stages(nx: int = 4):
    """Rollout -> linearize -> factor -> solve: ``tests/test_pipeline.py``'s
    MPC-flavoured stages in torch ops."""
    def rollout(c):
        A, x, rhs = c
        for _ in range(3):
            x = torch.tanh(A @ x)
        return (A, x, rhs)

    def linearize(c):
        A, x, rhs = c
        return (A * (1.0 - torch.tanh(A @ x)[:, None] ** 2), x, rhs)

    def factor(c):
        J, x, rhs = c
        return (J @ J.T + torch.eye(nx, dtype=J.dtype), x, rhs)

    def solve(c):
        K, x, rhs = c
        return (K, torch.linalg.solve(K, rhs), rhs)

    return [rollout, linearize, factor, solve]


def tanh_stages(mats):
    return [lambda x, W=torch.as_tensor(W): torch.tanh(x @ W) for W in mats]


def sharding_cases(payload, rec) -> None:
    import torch.distributed as dist

    from blf_tpu_torch.convert import factors_from_numpy, lqr_problem_from_numpy
    from blf_tpu_torch.estimators.rls import RLSParams, RLSState
    from blf_tpu_torch.estimators.rls_parallel import rls_parallel_sharded
    from blf_tpu_torch.mpc.qp import shard_factors_rows, solve_qp_factored_rowsharded
    from blf_tpu_torch.mpc.riccati import solve_lqr_sharded
    from blf_tpu_torch.parallel import mesh as M
    from blf_tpu_torch.parallel.pipeline import pipeline_stages

    rec["rank"] = dist.get_rank()
    t = lambda a: torch.as_tensor(np.asarray(a))
    meshes = {s: M.make_mesh(s, model_axis=s, device="cpu") for s in (2, 4)}
    stages = {s: M.make_mesh(s, model_axis=s, axis_names=("data", "stage"), device="cpu")
              for s in (2, 4)}

    qp = payload["qp"]
    factors = factors_from_numpy(qp["factors"], device="cpu", dtype=torch.float64)
    lqr = lqr_problem_from_numpy(*payload["lqr"], device="cpu", dtype=torch.float64)
    rls = payload["rls"]
    rls_args = (RLSParams(t(rls["lam"]), t(rls["R"])), RLSState(t(rls["theta0"]), t(rls["P0"])),
                t(rls["A"]), t(rls["y"]))
    for s, mesh in meshes.items():
        if mesh.get_coordinate() is None:
            continue
        idx = M.axis_index(mesh, "model")
        m_loc = factors.A_s.shape[0] // s
        rows = slice(idx * m_loc, (idx + 1) * m_loc)
        sol = solve_qp_factored_rowsharded(
            shard_factors_rows(factors, idx, s), t(qp["q"]), t(qp["l"])[:, rows],
            t(qp["u"])[:, rows], group=mesh.get_group("model"), iterations=qp["iterations"])
        rec[f"qp{s}"] = numpy_tree(sol)
        rec[f"lqr{s}"] = numpy_tree(solve_lqr_sharded(*lqr, mesh, "model"))
        final, thetas = rls_parallel_sharded(*rls_args, mesh, "model")
        rec[f"rls{s}"] = {"final": numpy_tree(final), "thetas": thetas.numpy()}

    pipe = payload["pipeline"]
    for s, M_ in ((2, 5), (4, 7)):
        if stages[s].get_coordinate() is not None:
            piped = pipeline_stages(tanh_stages(pipe[f"mats{s}"]), stages[s], "stage")
            rec[f"pipe{s}x{M_}"] = piped(t(pipe[f"xs{s}"])).numpy()
    rec["pipe_pytree"] = numpy_tree(pipeline_stages(pytree_stages(), stages[4], "stage")(
        {k: t(v) for k, v in pipe["pytree"].items()}))
    rec["pipe_mpc"] = numpy_tree(pipeline_stages(mpc_stages(), stages[4], "stage")(
        tuple(t(a) for a in pipe["mpc"])))
    rec["pipe_count"] = raised(lambda: pipeline_stages([lambda x: x] * 3, stages[4], "stage"))
    rec["indivisible"] = {   # T = 14 over 4 ranks
        "lqr": raised(lambda: solve_lqr_sharded(*(a[:14] for a in lqr[:5]), *lqr[5:],
                                                meshes[4], "model")),
        "rls": raised(lambda: rls_parallel_sharded(*rls_args[:2], rls_args[2][:14],
                                                   rls_args[3][:14], meshes[4], "model"))}
