"""Port parity of the slice as a whole: the warm-started fleet tick.

Five ticks of the stationary push-recovery fleet (B = 64, horizon 8, 100
iterations + 25 of polish, K = 1) through the JAX package's
``make_fleet_step`` on a (1, 1) mesh and through the port's on
``device="cpu"``, from the same numpy inputs. The port runs its own
factorization; state, plan, statistics, status and quarantine are compared.
An ensemble of K = 2 on one device is held to the reference's (1, 2) mesh;
the ticks across ranks are ``tests/test_torch_mesh.py``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import F32_LANE, tol

from blf_tpu.models.lipm import LIPMParams as JLIPMParams
from blf_tpu.parallel import sweep as jsweep
from blf_tpu.parallel.mesh import make_mesh
from blf_tpu.parallel.mesh import shard_batch as jshard_batch
from blf_tpu_torch.convert import (fleet_state_from_numpy, fleet_state_to_numpy,
                                   lipm_params_from_numpy)
from blf_tpu_torch.parallel import sweep as tsweep
from blf_tpu_torch.problems import stationary_push_recovery
from blf_tpu_torch.utils.status import SolverStatus, status_counts
from test_torch_wbc_loop import in_background, reference_jit

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

NP_DTYPE = np.float32 if F32_LANE else np.float64
T_DTYPE = torch.float32 if F32_LANE else torch.float64
J_DTYPE = jnp.dtype(NP_DTYPE)
B, H, TICKS, DT = 64, 8, 5, 0.1
QP = dict(iterations=100, polish_iters=25)
ATOL = tol(1e-7, 1e-3)
BAD_LANE, BAD_TICK = 7, 2


class Fleet:
    """Both tick functions and the shared inputs, built once."""

    _cache = {}

    @classmethod
    def get(cls):
        if not cls._cache:
            pr = stationary_push_recovery(B, H, seed=0, device="cpu", dtype=T_DTYPE)
            refs_t = (pr.dcm_ref, pr.zmp_ref, pr.poly_A, pr.poly_b)
            refs_j = tuple(jnp.asarray(r.numpy()) for r in refs_t)
            pj = JLIPMParams(jnp.asarray(0.9, J_DTYPE), jnp.asarray(9.81, J_DTYPE))
            pt = lipm_params_from_numpy(0.9, 9.81, device="cpu", dtype=T_DTYPE)
            cls._cache.update(
                pr=pr, refs_t=refs_t, refs_j=refs_j,
                step_j=jsweep.make_fleet_step(make_mesh(1, model_axis=1), pj, DT, **QP),
                step_t=tsweep.make_fleet_step(pt, DT, device="cpu", **QP),
                state_j=jsweep.init_fleet(B, H, pr.num_constraints,
                                          jnp.asarray([0.01, -0.01], J_DTYPE),
                                          jnp.asarray([0.01, -0.01], J_DTYPE),
                                          dtype=J_DTYPE),
            )
        return cls._cache


def run_both(poison: bool):
    """Tick both sides TICKS times; returns the per-tick (state, result) pairs."""
    c = Fleet.get()
    pr = c["pr"]
    sj = c["state_j"]
    st = fleet_state_from_numpy(sj, device="cpu", dtype=T_DTYPE)
    dist_j = jnp.asarray(pr.disturbance.numpy())
    history = []
    for tick in range(TICKS):
        if poison and tick == BAD_TICK:
            sj = sj._replace(dcm=sj.dcm.at[BAD_LANE, 0].set(jnp.nan))
            dcm = st.dcm.clone()
            dcm[BAD_LANE, 0] = float("nan")
            st = st._replace(dcm=dcm)
        sj, rj = c["step_j"](sj, dist_j, *c["refs_j"])
        st, rt = c["step_t"](st, pr.disturbance, *c["refs_t"])
        history.append((sj, rj, st, rt))
    return history


def compare_tick(sj, rj, st, rt, tick):
    out = fleet_state_to_numpy(st)
    for name in tsweep.FleetState._fields:
        ref = np.asarray(getattr(sj, name))
        assert out[name].shape == ref.shape and out[name].dtype == NP_DTYPE, name
        if F32_LANE and name == "warm_s":
            # in float32 the penalty rule moves s by a ratio of residuals at
            # the rounding floor: s is not reproducible between two evaluation
            # orders, only bounded (the plans it leads to are compared below)
            assert np.all((out[name] >= 1e-4) & (out[name] <= 1e4))
            continue
        np.testing.assert_allclose(out[name], ref, atol=ATOL, rtol=ATOL,
                                   err_msg=f"tick {tick}: {name}")
    np.testing.assert_allclose(rt.consensus_zmp0.numpy(), np.asarray(rj.consensus_zmp0),
                               atol=ATOL, err_msg=f"tick {tick}: consensus_zmp0")
    for name in rt.stats._fields:
        np.testing.assert_allclose(
            float(getattr(rt.stats, name)), float(getattr(rj.stats, name)),
            atol=ATOL, err_msg=f"tick {tick}: stats.{name}")
    np.testing.assert_allclose(float(rt.worst_margin), float(rj.worst_margin), atol=ATOL)
    assert float(rt.num_quarantined) == float(rj.num_quarantined)
    assert rt.status.dtype == torch.int32
    if not F32_LANE:
        np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))


def test_five_ticks_match_the_jax_fleet_step():
    history = run_both(poison=False)
    for tick, (sj, rj, st, rt) in enumerate(history):
        compare_tick(sj, rj, st, rt, tick)
    _, _, st, rt = history[-1]
    assert float(rt.stats.num_scenarios) == B and float(rt.num_quarantined) == 0
    assert all(bool(torch.isfinite(t).all()) for t in st)
    assert status_counts(rt.status)["numerical_error"] == 0
    # the warm start works: the last tick converges the whole fleet
    assert float(rt.stats.num_converged) == B


def test_poisoned_lane_is_quarantined_alike():
    history = run_both(poison=True)
    sj, rj, st, rt = history[BAD_TICK]
    bad = int(SolverStatus.NUMERICAL_ERROR)
    assert int(rt.status[BAD_LANE]) == bad == int(rj.status[BAD_LANE])
    assert float(rt.num_quarantined) == 1 == float(rj.num_quarantined)
    assert int((rt.status == bad).sum()) == 1
    # the same reset on both sides: a sanitized last-good state, cleared warm
    # starts, a fresh estimator prior
    lane = {k: v[BAD_LANE] for k, v in fleet_state_to_numpy(st).items()}
    np.testing.assert_array_equal(lane["dcm"][0], 0.0)       # NaN sanitized to 0
    np.testing.assert_array_equal(lane["warm_zmp"], 0.0)
    np.testing.assert_array_equal(lane["warm_y"], 0.0)
    np.testing.assert_array_equal(lane["offset_theta"], 0.0)
    np.testing.assert_array_equal(lane["offset_cov"], 10.0 * np.eye(2))
    np.testing.assert_array_equal(lane["warm_s"], 1.0)
    for name, val in lane.items():
        np.testing.assert_allclose(val, np.asarray(getattr(sj, name))[BAD_LANE],
                                   atol=ATOL, err_msg=name)
    # no other lane was touched, and the fleet goes on finite afterwards
    others = np.arange(B) != BAD_LANE
    clean = run_both(poison=False)[BAD_TICK][2]
    for name in tsweep.FleetState._fields:
        np.testing.assert_array_equal(getattr(st, name).numpy()[others],
                                      getattr(clean, name).numpy()[others], err_msg=name)
    for tick in range(BAD_TICK, TICKS):
        compare_tick(*history[tick], tick)
        assert all(bool(torch.isfinite(t).all()) for t in history[tick][2])


def test_kernel_backend_runs_the_same_tick():
    """backend="cuda" on CPU tensors goes through the stage wrapper (its plain
    version) and lands on the same trajectory as the refined plain path."""
    c = Fleet.get()
    pr = c["pr"]
    pt = lipm_params_from_numpy(0.9, 9.81, device="cpu", dtype=T_DTYPE)
    step = tsweep.make_fleet_step(pt, DT, device="cpu", backend="cuda", **QP)
    st = fleet_state_from_numpy(c["state_j"], device="cpu", dtype=T_DTYPE)
    ref = run_both(poison=False)
    for tick in range(3):
        st, rt = step(st, pr.disturbance, *c["refs_t"])
        np.testing.assert_allclose(rt.consensus_zmp0.numpy(),
                                   ref[tick][3].consensus_zmp0.numpy(),
                                   atol=tol(1e-6, 1e-3))
    assert float(rt.num_quarantined) == 0


def test_ensemble_and_device_rules(monkeypatch):
    """The local ensemble (K = 2, both members on one device): two identical
    draws give the K = 1 tick, bit for bit; two distinct draws give the
    reference's tick on a (1, 2) mesh, one member a device. Then the device
    rule."""
    c = Fleet.get()
    pr = c["pr"]
    st = fleet_state_from_numpy(c["state_j"], device="cpu", dtype=T_DTYPE)
    two = stationary_push_recovery(B, H, seed=0, ensemble=2, device="cpu", dtype=T_DTYPE)
    pj = JLIPMParams(jnp.asarray(0.9, J_DTYPE), jnp.asarray(9.81, J_DTYPE))
    mesh12 = make_mesh(2, model_axis=2)
    ref = in_background(reference_jit(jsweep.make_fleet_step(mesh12, pj, DT, **QP).sharded_fn),
                        jshard_batch(c["state_j"], mesh12),
                        jnp.asarray(two.disturbance.numpy()), *c["refs_j"])
    one_state, one = c["step_t"](st, pr.disturbance, *c["refs_t"])
    same_state, same = c["step_t"](st, pr.disturbance.expand(B, 2, 2), *c["refs_t"])
    for a, b in zip(one_state + (one.consensus_zmp0, one.status) + tuple(one.stats),
                    same_state + (same.consensus_zmp0, same.status) + tuple(same.stats)):
        assert torch.equal(a, b)
    st2, r2 = c["step_t"](st, two.disturbance, *c["refs_t"])
    sj, rj = ref()
    compare_tick(sj, rj, st2, r2, 0)
    assert float(r2.stats.num_scenarios) == B and float(r2.num_quarantined) == 0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsweep.make_fleet_step(pr.params, DT)               # device=None
    with pytest.raises(RuntimeError, match="CUDA"):
        tsweep.init_fleet(4, H, 6 * H, [0.0, 0.0], [0.0, 0.0])


def test_fleet_state_round_trips_through_numpy():
    st = tsweep.init_fleet(6, H, 6 * H, [0.01, -0.01], [0.0, 0.0],
                           device="cpu", dtype=T_DTYPE)
    arrays = fleet_state_to_numpy(st)
    assert set(arrays) == set(tsweep.FleetState._fields)
    back = fleet_state_from_numpy(arrays, device="cpu", dtype=T_DTYPE)
    assert all(torch.equal(a, b) for a, b in zip(st, back))
    np.testing.assert_array_equal(arrays["offset_cov"][2], 10.0 * np.eye(2))
    del arrays["warm_s"]
    with pytest.raises(ValueError, match="warm_s"):
        fleet_state_from_numpy(arrays, device="cpu", dtype=T_DTYPE)


def test_carry_dtype_is_authoritative():
    """float64 parameters must not promote a float32 fleet across the tick."""
    pr = stationary_push_recovery(8, H, device="cpu", dtype=torch.float32)
    p64 = lipm_params_from_numpy(0.9, 9.81, device="cpu", dtype=torch.float64)
    step = tsweep.make_fleet_step(p64, DT, device="cpu", iterations=25)
    st = tsweep.init_fleet(8, H, pr.num_constraints, pr.dcm0, pr.com0,
                           device="cpu", dtype=torch.float32)
    st2, res = step(st, pr.disturbance, pr.dcm_ref, pr.zmp_ref, pr.poly_A, pr.poly_b)
    assert all(t.dtype == torch.float32 for t in st2)
    assert res.consensus_zmp0.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_reused_factors_change_no_output_of_the_tick(dtype):
    """A step keeps its last tick's factorization and reuses it while the
    operator is unchanged: four ticks of one step (backend="torch") against a
    fresh step a tick, fed the same state, which factors every tick. Every
    field of the state and of the result is bitwise equal, and the one step
    reused its factors on every tick after the first."""
    from blf_tpu_torch.utils import profiling

    pr = stationary_push_recovery(16, H, seed=0, device="cpu", dtype=dtype)
    pt = lipm_params_from_numpy(0.9, 9.81, device="cpu", dtype=dtype)
    make = lambda: tsweep.make_fleet_step(pt, DT, device="cpu", iterations=50, backend="torch")
    refs = (pr.dcm_ref, pr.zmp_ref, pr.poly_A, pr.poly_b)
    step = make()
    state = tsweep.init_fleet(16, H, pr.num_constraints, [0.01, -0.01], [0.01, -0.01],
                              device="cpu", dtype=dtype)
    flat = lambda s, r: (tuple(s) + tuple(r.stats)
                         + (r.worst_margin, r.consensus_zmp0, r.status, r.num_quarantined))
    names = (tsweep.FleetState._fields + tuple(f"stats.{n}" for n in tsweep.FleetStats._fields)
             + tsweep.TickResult._fields[1:])
    with profiling.recording() as log:
        for tick in range(4):
            fresh_state, fresh = make()(state, pr.disturbance, *refs)
            state, result = step(state, pr.disturbance, *refs)
            for name, a, b in zip(names, flat(state, result), flat(fresh_state, fresh),
                                  strict=True):
                assert a.dtype == b.dtype and torch.equal(a, b), (tick, name)
    counts = log.summary()
    assert counts["dcm.factor"]["count"] == 8 and counts["dcm.factor_reused"]["count"] == 3
    assert counts["sync.eigh"]["count"] == 5
