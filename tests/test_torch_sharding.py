"""The port's sharded solvers and pipeline across ranks
(``mpc/qp.py::solve_qp_factored_rowsharded``, ``mpc/riccati.py::
solve_lqr_sharded``, ``estimators/rls_parallel.py::rls_parallel_sharded``,
``parallel/pipeline.py``) against ``blf_tpu`` on its 8-device CPU mesh.

One ``gloo`` world of four spawned ranks (``torch_spmd.sharding_cases``)
runs every case of this file at 2 shards (ranks 0 and 1) and at 4, while the
test process runs the references under ``shard_map`` on meshes of the same
shapes: ``tests/test_sharding.py``'s row-sharded QP (handed the reference's
factors), the horizon-sharded LQR at T = 16, the stream-sharded RLS, and
``tests/test_pipeline.py``'s pipelines (its (8, 3) case needs 8 ranks and
stays with the reference's own test). Float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from blf_tpu.estimators import rls as jrls
from blf_tpu.estimators import rls_parallel as jpar
from blf_tpu.models.lipm import LIPMParams as JLIPMParams
from blf_tpu.models.lipm import dcm_backward_recursion
from blf_tpu.mpc import riccati as jric
from blf_tpu.mpc.dcm import build_dcm_qp
from blf_tpu.mpc.qp import QPSolution as JQPSolution
from blf_tpu.mpc.qp import factor_shared_qp as jfactor_shared_qp
from blf_tpu.mpc.qp import shard_factors_rows as jshard_factors_rows
from blf_tpu.mpc.qp import solve_qp_factored_rowsharded as jrowsharded
from blf_tpu.parallel.pipeline import pipeline_stages as jpipeline_stages
from blf_tpu_torch.convert import factors_from_numpy
from blf_tpu_torch.mpc import qp as tqp
from test_torch_riccati import random_lqr
from test_torch_wbc_loop import in_background, reference_jit, run_reference
from torch_spmd import World, mpc_stages, pytree_stages, tanh_stages

torch.set_num_threads(1)

SHARDS = (2, 4)
QP_ITERATIONS = 150
N = 16                                      # tests/test_sharding.py's horizon
PIPES = ((2, 5), (4, 7))                    # (stages, microbatches)
TOL = dict(rtol=1e-9, atol=1e-9)


def qp_problem(B=8):
    """``tests/test_sharding.py::TestRowShardedQP._problem``: the walking
    reference's transcription, B perturbed initial DCMs; the reference's
    factors of its shared operator (one program)."""
    def transcribe(dcm0s, steps):
        params = JLIPMParams(jnp.asarray(0.9), jnp.asarray(9.81))
        zmp_ref = jnp.repeat(steps, 4, axis=0)
        dcm_ref = dcm_backward_recursion(params, zmp_ref, steps[-1], 0.1)
        poly_A = jnp.tile(jnp.asarray([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]]), (N, 1, 1))
        poly_b = jnp.stack([zmp_ref[:, 0] + 0.07, -(zmp_ref[:, 0] - 0.07),
                            zmp_ref[:, 1] + 0.04, -(zmp_ref[:, 1] - 0.04)], -1)
        Pm, q, A, l, u = build_dcm_qp(params, 0.1, dcm0s, dcm_ref, zmp_ref, poly_A, poly_b)
        return jfactor_shared_qp(Pm, A, jnp.arange(A.shape[-2]) < 2 * N), q, l, u

    dcm0s = np.random.default_rng(0).normal(0.05, 0.02, (B, 2))
    steps = np.array([[0.0, -0.1], [0.2, 0.1], [0.4, -0.1], [0.6, 0.1]])
    return jax.tree_util.tree_map(np.asarray, run_reference(transcribe, dcm0s, steps))


def reference_rowsharded(factors, q, l, u, shards):
    """The reference's row-sharded solve under shard_map over ``shards`` devices."""
    mesh = Mesh(np.array(jax.devices()[:shards]), ("model",))
    factors = jax.tree_util.tree_map(jnp.asarray, factors)

    def solve(lT, uT):
        f_loc = jshard_factors_rows(factors, jax.lax.axis_index("model"), shards)
        return jrowsharded(f_loc, jnp.asarray(q), lT, uT, axis_name="model",
                           iterations=QP_ITERATIONS)

    rows = P(None, "model")
    spec = JQPSolution(x=P(), y=rows, z=rows, primal_residual=P(), dual_residual=P(),
                       converged=P(), objective=P(), rho_scale=P(), refined=P())
    solved = reference_jit(shard_map(solve, mesh=mesh, in_specs=(rows, rows), out_specs=spec,
                                     check_vma=False))(jnp.asarray(l), jnp.asarray(u))
    return jax.tree_util.tree_map(np.asarray, solved)


def rls_problem(T=64, p=3, m=2, batch=(3,), lam=0.98):
    """``tests/test_rls_parallel.py``'s draws: a batch of streams."""
    rng = np.random.default_rng(7)
    theta_true = rng.normal(size=(p,))
    A = rng.normal(size=(T,) + batch + (m, p))
    y = A @ theta_true + 0.1 * rng.normal(size=(T,) + batch + (m,))
    return {"lam": np.asarray(lam), "R": 0.01 * np.eye(m), "theta0": np.zeros(batch + (p,)),
            "P0": np.broadcast_to(10.0 * np.eye(p), batch + (p, p)).copy(), "A": A, "y": y}


def reference_sharded(fn, shards, *args):
    """``fn(*args, mesh, axis)`` of the reference on a mesh of ``shards`` devices."""
    mesh = Mesh(np.array(jax.devices()[:shards]), ("seq",))
    out = reference_jit(lambda *a: fn(*a, mesh, "seq"))(*args)
    return jax.tree_util.tree_map(np.asarray, out)


def pipeline_payload():
    out = {}
    for s, M in PIPES:
        rng = np.random.default_rng(s)          # tests/test_pipeline.py's draws
        out[f"mats{s}"] = [rng.normal(size=(6, 6)) * 0.4 for _ in range(s)]
        out[f"xs{s}"] = rng.normal(size=(M, 6))
    out["pytree"] = {"x": np.arange(6.0)[:, None] * np.ones((6, 4)), "y": np.ones((6, 4))}
    rng = np.random.default_rng(0)
    out["mpc"] = (rng.normal(size=(6, 4, 4)) * 0.3, rng.normal(size=(6, 4)),
                  rng.normal(size=(6, 4)))
    return out


def reference_pipeline(mats, xs):
    fns = [lambda x, W=jnp.asarray(W): jnp.tanh(x @ W) for W in mats]
    mesh = Mesh(np.array(jax.devices()[:len(mats)]), ("stage",))
    return np.asarray(reference_jit(jpipeline_stages(fns, mesh, "stage"))(jnp.asarray(xs)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks' records and the references, computed side by side."""
    factors, q, l, u = qp_problem()
    lqr = random_lqr(16, 4, 2, np.random.default_rng(5))
    rls = rls_problem()
    pipes = pipeline_payload()
    payload = {"qp": {"factors": factors._asdict(), "q": q, "l": l, "u": u,
                      "iterations": QP_ITERATIONS},
               "lqr": lqr, "rls": rls, "pipeline": pipes}
    world = World("sharding_cases", payload, tmp_path_factory.mktemp("sharding_world"))
    rls_args = (jrls.RLSParams(jnp.asarray(rls["lam"]), jnp.asarray(rls["R"])),
                jrls.RLSState(jnp.asarray(rls["theta0"]), jnp.asarray(rls["P0"])),
                jnp.asarray(rls["A"]), jnp.asarray(rls["y"]))
    refs = {}
    for s in SHARDS:
        refs[f"qp{s}"] = in_background(reference_rowsharded, factors, q, l, u, s)
        refs[f"lqr{s}"] = in_background(reference_sharded, jric.solve_lqr_sharded, s,
                                        *map(jnp.asarray, lqr))
        refs[f"rls{s}"] = in_background(reference_sharded, jpar.rls_parallel_sharded, s,
                                        *rls_args)
    for s, M in PIPES:
        refs[f"pipe{s}x{M}"] = in_background(reference_pipeline, pipes[f"mats{s}"],
                                             pipes[f"xs{s}"])
    refs = {k: v() for k, v in refs.items()}
    return {"ranks": world.results(), "ref": refs, "payload": payload}


def group_of(world, shards):
    """The records of the ranks of a mesh of ``shards`` (ranks 0 .. shards - 1)."""
    return world["ranks"][:shards]


@pytest.mark.parametrize("shards", SHARDS)
def test_row_sharded_qp_matches_the_reference(world, shards):
    """One solve's 96 constraint rows over 2 or 4 ranks, the reference's
    factors, 150 iterations: the same iterates as the reference's row-sharded
    solve to summation order; x, residuals and flags the same on every rank,
    y and z each rank's own rows."""
    ref = world["ref"][f"qp{shards}"]
    recs = [r[f"qp{shards}"] for r in group_of(world, shards)]
    for name in ("x", "primal_residual", "dual_residual", "objective", "rho_scale"):
        np.testing.assert_allclose(recs[0][name], getattr(ref, name), err_msg=name, **TOL)
        for rec in recs[1:]:
            np.testing.assert_array_equal(rec[name], recs[0][name], err_msg=name)
    for name in ("y", "z"):
        np.testing.assert_allclose(np.concatenate([r[name] for r in recs], -1),
                                   getattr(ref, name), err_msg=name, **TOL)
    np.testing.assert_array_equal(recs[0]["converged"], ref.converged)
    assert not recs[0]["refined"]


def test_row_sharded_qp_matches_the_single_device_solve(world):
    """The same iteration as ``solve_qp_factored`` (no refinement) on one
    device: ``tests/test_sharding.py``'s bounds, tighter in float64."""
    qp = world["payload"]["qp"]
    t = lambda a: torch.as_tensor(np.asarray(a))
    one = tqp.solve_qp_factored(factors_from_numpy(qp["factors"], device="cpu",
                                                   dtype=torch.float64),
                                t(qp["q"]), t(qp["l"]), t(qp["u"]),
                                iterations=QP_ITERATIONS, refine=False)
    for shards in SHARDS:
        recs = [r[f"qp{shards}"] for r in group_of(world, shards)]
        np.testing.assert_allclose(recs[0]["x"], one.x.numpy(), atol=2e-5)
        np.testing.assert_allclose(np.concatenate([r["y"] for r in recs], -1), one.y.numpy(),
                                   atol=1e-3)
        assert recs[0]["converged"].sum() >= int(one.converged.sum()) - 1


def test_shard_factors_rows_cuts_the_row_members():
    factors, *_ = qp_problem()
    port = factors_from_numpy(factors._asdict(), device="cpu", dtype=torch.float64)
    ref = jshard_factors_rows(jax.tree_util.tree_map(jnp.asarray, factors), 2, 4)
    cut = tqp.shard_factors_rows(port, 2, 4)
    for name, value in cut._asdict().items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(ref, name)), name)
    with pytest.raises(ValueError, match="not divisible"):
        tqp.shard_factors_rows(port, 0, 5)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_lqr_matches_the_reference(world, shards):
    ref = world["ref"][f"lqr{shards}"]
    for rec in group_of(world, shards):
        for name, value in rec[f"lqr{shards}"].items():
            np.testing.assert_allclose(value, getattr(ref, name), err_msg=name, **TOL)


def test_sharded_solvers_reject_an_indivisible_horizon(world):
    for rec in world["ranks"]:
        assert rec["indivisible"]["lqr"] == "horizon 14 not divisible by 4 shards"
        assert rec["indivisible"]["rls"] == "stream length 14 not divisible by 4"


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_rls_matches_the_reference(world, shards):
    ref_final, ref_thetas = world["ref"][f"rls{shards}"]
    for rec in group_of(world, shards):
        got = rec[f"rls{shards}"]
        np.testing.assert_allclose(got["thetas"], ref_thetas, rtol=1e-10, atol=1e-10)
        for name, value in got["final"].items():
            np.testing.assert_allclose(value, getattr(ref_final, name), rtol=1e-10,
                                       atol=1e-10, err_msg=name)


@pytest.mark.parametrize("stages, microbatches", PIPES)
def test_pipeline_matches_the_reference_and_the_serial_composition(world, stages,
                                                                    microbatches):
    pipes = world["payload"]["pipeline"]
    want = torch.as_tensor(pipes[f"xs{stages}"])
    for f in tanh_stages(pipes[f"mats{stages}"]):
        want = f(want)
    ref = world["ref"][f"pipe{stages}x{microbatches}"]
    for rec in group_of(world, stages):
        got = rec[f"pipe{stages}x{microbatches}"]
        np.testing.assert_allclose(got, ref, atol=1e-12)
        np.testing.assert_allclose(got, want.numpy(), atol=1e-12)


def test_pipeline_pytree_carrier(world):
    c = {k: torch.as_tensor(v) for k, v in world["payload"]["pipeline"]["pytree"].items()}
    for f in pytree_stages():
        c = f(c)
    for rec in world["ranks"]:
        for name in ("x", "y"):
            np.testing.assert_allclose(rec["pipe_pytree"][name], c[name].numpy(), atol=1e-12)


def test_pipeline_stage_count_mismatch(world):
    for rec in world["ranks"]:
        assert rec["pipe_count"] == "3 stage fns for a 4-device 'stage' axis"


def test_pipeline_mpc_flavored_stages(world):
    """Rollout -> linearize -> factor -> solve on a shared carrier, each
    microbatch against the serial composition."""
    mbs = [torch.as_tensor(a) for a in world["payload"]["pipeline"]["mpc"]]
    for rec in world["ranks"]:
        got = rec["pipe_mpc"]
        for m in range(mbs[0].shape[0]):
            want = tuple(a[m] for a in mbs)
            for f in mpc_stages():
                want = f(want)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[m], w.numpy(), atol=1e-10)
