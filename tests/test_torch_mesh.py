"""The port's device mesh, tree reductions and fleet tick across ranks
(``parallel/{mesh,collectives,sweep}.py``) against ``blf_tpu`` on its
8-device CPU mesh.

One ``gloo`` world of four spawned ranks (``torch_spmd.mesh_cases``) runs
every case of this file while the test process runs the references on a
mesh of the same shape: ``tests/test_sharding.py``'s ``TestMesh``, the tree
reductions with a NaN on one rank, the fleet tick on (2, 2) with an ensemble
of K = 2 (three warm ticks), on (4, 1) against the port's own tick on one
device, on a world of one with both members local against the reference's
(1, 2) mesh, and the NaN-lane quarantine across ranks. Float64, B = 16,
horizon 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from conftest import F32_LANE, tol

from blf_tpu.models.lipm import LIPMParams as JLIPMParams
from blf_tpu.mpc.qp import QPSolution as JQPSolution
from blf_tpu.parallel import collectives as jcoll
from blf_tpu.parallel import sweep as jsweep
from blf_tpu.parallel.mesh import make_mesh as jmake_mesh
from blf_tpu.parallel.mesh import shard_batch as jshard_batch
from blf_tpu_torch.convert import fleet_state_from_numpy, fleet_state_to_numpy
from blf_tpu_torch.parallel import sweep as tsweep
from blf_tpu_torch.problems import stationary_push_recovery
from blf_tpu_torch.utils.status import SolverStatus
from test_torch_wbc_loop import in_background, reference_jit
from torch_spmd import FLEET, NAN_LANE, NAN_MEMBER_LANE, WORLD, World

torch.set_num_threads(1)

NP_DTYPE = np.float32 if F32_LANE else np.float64
T_DTYPE = torch.float32 if F32_LANE else torch.float64
B, H, TICKS, DT, QP = FLEET["B"], FLEET["H"], FLEET["TICKS"], FLEET["DT"], FLEET["QP"]
ATOL = tol(1e-10, 1e-3)
BAD = int(SolverStatus.NUMERICAL_ERROR)


def fleet_payload():
    pr = stationary_push_recovery(B, H, device="cpu", dtype=T_DTYPE)
    state0 = tsweep.init_fleet(B, H, pr.num_constraints, pr.dcm0, pr.com0, device="cpu",
                               dtype=T_DTYPE)
    rng = np.random.default_rng(14)
    draw = lambda k: rng.normal(0, 0.004, (TICKS, B, k, 2)).astype(NP_DTYPE)
    dist22, dist41, dist12 = draw(2), draw(1), draw(2)
    dist22_nan = dist22[:1].copy()
    dist22_nan[0, NAN_MEMBER_LANE, 1, 0] = np.nan
    return pr, {"state0": fleet_state_to_numpy(state0), "dist22": dist22, "dist41": dist41,
                "dist12": dist12, "dist22_nan": dist22_nan}


def stats_lanes():
    """Per-lane solver results of a fleet of 16, one residual NaN (rank 2's)."""
    rng = np.random.default_rng(3)
    primal = rng.uniform(0, 1e-3, 16)
    primal[10] = np.nan
    return {"primal_residual": primal, "dual_residual": rng.uniform(0, 1e-3, 16),
            "converged": rng.uniform(size=16) < 0.7, "objective": rng.normal(size=16)}


def reference_ticks(pr, n, model_axis, runs):
    """``blf_tpu``'s tick on ``make_mesh(n, model_axis)``: its shard_map
    program compiled once (``reference_jit``), ticked from each run's state
    over the run's draws."""
    mesh = jmake_mesh(n, model_axis=model_axis)
    pj = JLIPMParams(jnp.asarray(0.9, NP_DTYPE), jnp.asarray(9.81, NP_DTYPE))
    tick = reference_jit(jsweep.make_fleet_step(mesh, pj, DT, **QP).sharded_fn)
    refs = tuple(jnp.asarray(r.numpy()) for r in (pr.dcm_ref, pr.zmp_ref, pr.poly_A, pr.poly_b))
    out = []
    for state0, dists in runs:
        st = jshard_batch(jsweep.FleetState(**{k: jnp.asarray(v) for k, v in state0.items()}),
                          mesh)
        out.append([])
        for d in dists:
            st, result = tick(st, jnp.asarray(d), *refs)
            out[-1].append(jax.tree_util.tree_map(np.asarray, (st, result)))
    return out


def reference_reductions(per_rank, lanes):
    """The reference's psum_tree/pmax_tree and reduce_fleet_stats under
    shard_map over four devices, on the ranks' inputs."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("d",))
    stacked = {k: jnp.asarray(np.concatenate([r[k] for r in per_rank])) for k in per_rank[0]}
    tree = shard_map(lambda t: (jcoll.pmax_tree(t, "d"), jcoll.psum_tree(t, "d")), mesh=mesh,
                     in_specs=P("d"), out_specs=P())(stacked)
    sol = JQPSolution(*(jnp.zeros((16, 1)),) * 3,
                      *(jnp.asarray(lanes[k]) for k in ("primal_residual", "dual_residual",
                                                        "converged", "objective")))
    spec = JQPSolution(P("d"), P("d"), P("d"), P("d"), P("d"), P("d"), P("d"))
    stats = shard_map(lambda s: jcoll.reduce_fleet_stats(s, "d"), mesh=mesh,
                      in_specs=(spec,), out_specs=P(), check_vma=False)(sol)
    return jax.tree_util.tree_map(np.asarray, (tree, stats))


def rank_inputs():
    """What each rank of ``mesh_cases`` hands the tree reductions."""
    out = []
    for rank in range(WORLD):
        out.append({"v": np.array([1.0 + rank, np.nan if rank == 2 else -rank,
                                   np.nan if rank == 0 else 2.0, -np.inf]),
                    "i": np.array([rank, 3 - rank], np.int32), "e": np.ones((3, 2))})
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks' records and the references, computed side by side."""
    pr, fleet = fleet_payload()
    lanes = stats_lanes()
    world = World("mesh_cases", {"fleet": fleet, "stats_lanes": lanes, "dtype": str(T_DTYPE)},
                  tmp_path_factory.mktemp("mesh_world"))
    poisoned = dict(fleet["state0"], dcm=fleet["state0"]["dcm"].copy())
    poisoned["dcm"][NAN_LANE] = np.nan
    refs = {
        "tick22": in_background(reference_ticks, pr, 4, 2, [
            (fleet["state0"], fleet["dist22"]), (fleet["state0"], fleet["dist22_nan"])]),
        "tick12": in_background(reference_ticks, pr, 2, 2, [(fleet["state0"], fleet["dist12"])]),
        "nan41": in_background(reference_ticks, pr, 4, 1, [(poisoned, fleet["dist41"][:1])]),
    }
    reductions = reference_reductions(rank_inputs(), lanes)
    # the port's own tick on one device, over the whole fleet
    step = tsweep.make_fleet_step(pr.params, DT, device="cpu", **QP)
    st, single = fleet_state_from_numpy(fleet["state0"], device="cpu", dtype=T_DTYPE), []
    for d in fleet["dist41"]:
        st, result = step(st, torch.as_tensor(d), pr.dcm_ref, pr.zmp_ref, pr.poly_A, pr.poly_b)
        single.append((fleet_state_to_numpy(st), result))
    ranks = world.results()
    return {"ranks": ranks, "ref": {k: v() for k, v in refs.items()},
            "reductions": reductions, "single": single}


def rows(rank_shape, rank):
    """The global lanes a rank holds on a (data, model) mesh of ``rank_shape``."""
    data = rank // rank_shape[1]
    per = B // rank_shape[0]
    return slice(data * per, (data + 1) * per)


#: the maxima a NaN lane turns to NaN in the port; the reference's pmax on this
#: CPU backend drops the NaN (ROADMAP.md section 3), so there they are not compared
NAN_MAXIMA = ("max_primal_residual", "max_dual_residual", "worst_margin")


def compare_tick(got, ref_state, ref_result, lanes, what, nan_lane=False):
    for name, ref in ref_state._asdict().items():
        np.testing.assert_allclose(got["state"][name], np.asarray(ref)[lanes], atol=ATOL,
                                   rtol=ATOL, err_msg=f"{what}: {name}")
    res = got["result"]
    ref_values = dict(ref_result.stats._asdict(), worst_margin=ref_result.worst_margin)
    got_values = dict(res["stats"], worst_margin=res["worst_margin"])
    for name, ref in ref_values.items():
        if nan_lane and name in NAN_MAXIMA:
            assert np.isnan(got_values[name]), (what, name)
            continue
        np.testing.assert_allclose(got_values[name], ref, atol=ATOL, rtol=ATOL,
                                   err_msg=f"{what}: {name}")
    for name in ("num_scenarios", "num_converged"):
        assert res["stats"][name] == ref_result.stats._asdict()[name], (what, name)
    np.testing.assert_allclose(res["consensus_zmp0"], ref_result.consensus_zmp0[lanes],
                               atol=ATOL, rtol=ATOL, err_msg=what)
    np.testing.assert_array_equal(res["status"], ref_result.status[lanes], err_msg=what)
    assert res["num_quarantined"] == ref_result.num_quarantined, what


def test_mesh_shapes_and_axis_names(world):
    ref = jmake_mesh(4, model_axis=2)
    for rank, rec in enumerate(world["ranks"]):
        assert rec["rank"] == rank and rec["init_again"] == rank   # init_distributed is idempotent
        m = rec["mesh22"]
        assert m["shape"] == ref.devices.shape == (2, 2)
        assert m["names"] == ref.axis_names == ("data", "model")
        assert m["coordinate"] == (rank // 2, rank % 2) and m["sizes"] == (2, 2)
        assert rec["raises"]["model_axis_3"] and "divisible" in rec["raises"]["model_axis_3"]
        assert rec["raises"]["1024"] == "requested 1024 devices, have 4"
        # a mesh smaller than the world: every rank built it, rank 0 alone is in it
        assert rec["mesh1_coordinate"] == ((0, 0) if rank == 0 else None)


def test_shard_batch_replicate_and_the_specs(world):
    x = np.arange(64.0).reshape(16, 4)
    ref41 = jshard_batch(jnp.asarray(x), jmake_mesh(4))
    ref_rows = {s.device.id: np.asarray(s.data) for s in ref41.addressable_shards}
    for rank, rec in enumerate(world["ranks"]):
        p = rec["placement"]
        np.testing.assert_array_equal(p["shard41"], x[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(p["shard41"], ref_rows[rank])
        np.testing.assert_array_equal(p["shard22"], x[rows((2, 2), rank)])
        np.testing.assert_array_equal(p["replicate"], np.ones(3))
        np.testing.assert_array_equal(p["gathered"], x)
        # the placements name the same layout as shard_batch
        np.testing.assert_array_equal(p["dtensor_sharded"], p["shard22"])
        np.testing.assert_array_equal(p["dtensor_replicated"], x)
        assert p["specs"] == ("(Shard(dim=0), Replicate())", "(Replicate(), Replicate())")
        assert (p["outside"] is None) == (rank == 0)
        if rank:
            assert "not in the mesh" in p["outside"]


def test_tree_reductions_keep_a_nan_and_leave_their_inputs(world):
    """gloo's MAX drops a NaN by operand order; pmax_tree keeps it on every
    rank (numpy's max of the ranks' inputs); psum_tree sums; neither touches
    its input. The reference's pmax on this CPU backend drops the NaN too
    (ROADMAP.md section 3): it is held only where no rank holds one."""
    (ref_max, ref_sum), _ = world["reductions"]
    inputs = rank_inputs()
    for rank, rec in enumerate(world["ranks"]):
        red = rec["reductions"]
        for name in ("v", "i", "e"):
            stacked = np.stack([r[name] for r in inputs])
            np.testing.assert_array_equal(red["pmax"][name], stacked.max(0), name)
            np.testing.assert_array_equal(red["psum"][name], stacked.sum(0), name)
            np.testing.assert_array_equal(red["psum"][name], np.asarray(ref_sum[name]), name)
            kept = ~np.isnan(stacked).any(0)
            np.testing.assert_array_equal(red["pmax"][name][kept], np.asarray(ref_max[name])[kept])
            np.testing.assert_array_equal(red["inputs_after"][name], red["inputs_before"][name])
            np.testing.assert_array_equal(red["inputs_before"][name], inputs[rank][name])
        assert np.isnan(red["pmax"]["v"][1:3]).all()


def test_reduce_fleet_stats_over_the_data_axis(world):
    """Sums and maxima over four ranks' lanes, one of them NaN: the port's
    maximum is NaN on every rank, the reference's on this backend is not."""
    _, ref = world["reductions"]
    for rec in world["ranks"]:
        for name, value in ref._asdict().items():
            if name != "max_primal_residual":
                np.testing.assert_allclose(rec["stats"][name], value, rtol=1e-15, err_msg=name)
        assert np.isnan(rec["stats"]["max_primal_residual"])


def test_ensemble_tick_on_2x2_matches_the_reference(world):
    """Mesh (2, 2), K = 2 (one member a model rank): three warm ticks."""
    ref = world["ref"]["tick22"][0]
    for rank, rec in enumerate(world["ranks"]):
        for tick in range(TICKS):
            compare_tick(rec["tick22"][tick], *ref[tick], rows((2, 2), rank),
                         f"rank {rank}, tick {tick}")
        assert rec["tick22"][-1]["result"]["num_quarantined"] == 0
        assert rec["tick22"][-1]["result"]["stats"]["num_converged"] == B


def test_a_model_group_holds_identical_copies(world):
    """Ranks of one model group keep bit-identical state and results; the
    reduced statistics are bit-identical on every rank."""
    ranks = world["ranks"]
    for tick in range(TICKS):
        for a, b in ((0, 1), (2, 3)):
            ta, tb = ranks[a]["tick22"][tick], ranks[b]["tick22"][tick]
            for name in ta["state"]:
                np.testing.assert_array_equal(ta["state"][name], tb["state"][name], name)
            np.testing.assert_array_equal(ta["result"]["consensus_zmp0"],
                                          tb["result"]["consensus_zmp0"])
            np.testing.assert_array_equal(ta["result"]["status"], tb["result"]["status"])
        for rec in ranks[1:]:
            for key in ("stats", "worst_margin", "num_quarantined"):
                assert (str(rec["tick22"][tick]["result"][key])
                        == str(ranks[0]["tick22"][tick]["result"][key])), key


def test_data_parallel_tick_matches_the_single_device_tick(world):
    """Mesh (4, 1), K = 1, against the port's own tick on one device."""
    for rank, rec in enumerate(world["ranks"]):
        lanes = rows((4, 1), rank)
        for tick in range(TICKS):
            state, result = world["single"][tick]
            got = rec["tick41"][tick]
            for name, value in state.items():
                np.testing.assert_allclose(got["state"][name], value[lanes], atol=ATOL,
                                           rtol=ATOL, err_msg=f"tick {tick}: {name}")
            for name, value in result.stats._asdict().items():
                np.testing.assert_allclose(got["result"]["stats"][name], value.numpy(),
                                           atol=ATOL, rtol=ATOL, err_msg=name)
            np.testing.assert_array_equal(got["result"]["status"], result.status[lanes].numpy())
            np.testing.assert_allclose(got["result"]["worst_margin"],
                                       result.worst_margin.numpy(), atol=ATOL)


def test_local_ensemble_is_the_mesh_ensemble(world):
    """A world of one (rank 0's mesh of one) with both members of K = 2
    local, against the reference's (1, 2) mesh with one member a device."""
    ref = world["ref"]["tick12"][0]
    ranks = world["ranks"]
    for tick in range(TICKS):
        compare_tick(ranks[0]["tick1"][tick], *ref[tick], slice(0, B), f"tick {tick}")
    for rec in ranks[1:]:
        assert rec["tick1"] is None and "not in the mesh" in rec["outside_tick"]


def test_nan_lane_is_quarantined_across_ranks(world):
    """``TestStatusAndQuarantine``'s NaN lane on (4, 1), on rank 2: the NaN
    reaches every rank's statistics, the lane is flagged and reset, every
    other lane is the clean tick's, bit for bit."""
    (ref_state, ref_result), = world["ref"]["nan41"][0]
    ranks = world["ranks"]
    for rank, rec in enumerate(ranks):
        got, clean = rec["nan41"], rec["tick41"][0]
        lanes = rows((4, 1), rank)
        compare_tick(got, ref_state, ref_result, lanes, f"rank {rank}", nan_lane=True)
        assert got["result"]["num_quarantined"] == 1
        others = np.arange(B)[lanes] != NAN_LANE
        assert (got["result"]["status"][~others] == BAD).all()
        assert (got["result"]["status"][others] != BAD).all()
        for name in got["state"]:
            assert np.isfinite(got["state"][name]).all(), name
            np.testing.assert_array_equal(got["state"][name][others], clean["state"][name][others])
    lane = {k: v[NAN_LANE % 4] for k, v in ranks[2]["nan41"]["state"].items()}
    np.testing.assert_array_equal(lane["warm_zmp"], 0.0)
    np.testing.assert_array_equal(lane["warm_s"], 1.0)
    np.testing.assert_array_equal(lane["offset_cov"], 10.0 * np.eye(2))


def test_nan_member_is_quarantined_across_the_model_axis(world):
    """A NaN in member 1 of one lane on (2, 2): the rank holding member 0
    flags and resets the lane too (the worst status over the ensemble)."""
    (ref_state, ref_result), = world["ref"]["tick22"][1]
    for rank, rec in enumerate(world["ranks"]):
        got, clean = rec["nan22"], rec["tick22"][0]
        lanes = rows((2, 2), rank)
        compare_tick(got, ref_state, ref_result, lanes, f"rank {rank}", nan_lane=True)
        assert got["result"]["num_quarantined"] == 1
        others = np.arange(B)[lanes] != NAN_MEMBER_LANE
        if rank < 2:
            assert (got["result"]["status"][~others] == BAD).all()
        for name in got["state"]:
            assert np.isfinite(got["state"][name]).all(), name
            np.testing.assert_array_equal(got["state"][name][others], clean["state"][name][others])
