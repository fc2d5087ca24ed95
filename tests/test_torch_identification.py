"""BASELINE config 2 as a whole: contact identification over a fleet, the
port's ``problems.identify_contacts`` against the same composition written
with ``blf_tpu``.

Both sides start from the same numpy draws (``contact_identification_fleet``):
per-lane (k, b), the dropped foot's state and the wrench noise. The JAX side
rolls the foot out with ``foot_rollout(backend="xla")`` in segments, takes
``regressor`` and ``contact_wrench`` (plus the same noise) along the record
and runs ``rls_scan``, ``rls_fit`` and ``rls_parallel`` from
``init_from_handler``, in the order of ``examples/02_contact_identification.py``.
Float64, 32 lanes, 50 samples of 10 Euler steps: every lane's three estimates
agree to 1e-8 relative (the filters' information matrices reach 1e10 and are
inverted; the rollouts agree to 1e-15).

Run as a script, the file is the float32 study behind ``chip_smoke.py``'s
``identify`` limits: 4096 lanes, 200 samples, both packages on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_identification.py
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.estimators.rls import init_from_handler as j_init
from blf_tpu.estimators.rls import rls_scan as j_rls_scan
from blf_tpu.estimators.rls_parallel import rls_fit as j_rls_fit
from blf_tpu.estimators.rls_parallel import rls_parallel as j_rls_parallel
from blf_tpu.models import contact as jcontact
from blf_tpu.models.foot import FootParams as JFootParams
from blf_tpu.models.foot import FootState as JFootState
from blf_tpu.models.foot import foot_rollout as j_foot_rollout
from blf_tpu.utils.params import ParametersHandler as JHandler
from blf_tpu_torch.estimators.rls import init_from_handler, rls_scan
from blf_tpu_torch.models import contact as tcontact
from blf_tpu_torch.ops.cuda import rollout as rollout_kernel
from blf_tpu_torch.ops.lie import so3_exp
from blf_tpu_torch.problems import (IDENTIFY_STEPS_PER_SAMPLE, contact_identification_fleet,
                                    identify_contacts)
from blf_tpu_torch.utils.params import ParametersHandler
from test_torch_wbc_loop import reference_jit

torch.set_num_threads(1)

LANES, SAMPLES = 32, 50
STEPS = IDENTIFY_STEPS_PER_SAMPLE
REL_TOL = 1e-8


def reference_identification(fleet, samples: int, steps: int, jdtype):
    """The composition of ``identify_contacts`` written with ``blf_tpu``, on
    the fleet's own numbers: ``(scan, fit, parallel)`` estimates, (B, 2)."""
    a = lambda t: jnp.asarray(t.cpu().numpy(), jdtype)
    cp = jcontact.ContactParams(*(a(x) for x in fleet.cparams))
    fp = JFootParams(*(a(x) for x in fleet.fparams))
    p0, R0 = a(fleet.null_position), a(fleet.null_rotation)
    segment = reference_jit(lambda s: j_foot_rollout(cp, fp, s, p0, R0, fleet.dt, steps,
                                                     backend="xla"))
    state, record = JFootState(*(a(x) for x in fleet.state)), []
    for _ in range(samples):
        state = segment(state)
        record.append(state)
    traj = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *record)
    noise = a(fleet.noise[:samples])
    handler = JHandler(fleet.handler.to_dict())

    def estimate(traj, noise):
        shape = traj.position.shape
        cstates = jcontact.ContactState(
            *traj, null_position=jnp.broadcast_to(p0, shape),
            null_rotation=jnp.broadcast_to(R0, shape + (3,)))
        regressors = jcontact.regressor(cp, cstates)
        wrenches = jcontact.contact_wrench(cp, cstates) + noise
        params, rls0 = jax.tree_util.tree_map(lambda x: x.astype(jdtype), j_init(handler))
        rls0 = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, shape[1:2] + x.shape),
                                      rls0)                 # one filter a lane
        scan = j_rls_scan(params, rls0, regressors, wrenches)
        fit = j_rls_fit(params, rls0, regressors, wrenches)
        par, _ = j_rls_parallel(params, rls0, regressors, wrenches)
        return scan.theta, fit.theta, par.theta

    return tuple(np.asarray(x) for x in reference_jit(estimate)(traj, noise))


@pytest.fixture(scope="module")
def fleet_and_reference():
    fleet = contact_identification_fleet(LANES, samples=SAMPLES, seed=0, device="cpu",
                                         dtype=torch.float64)
    return fleet, reference_identification(fleet, SAMPLES, STEPS, jnp.float64)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_identification_matches_the_reference(fleet_and_reference, backend):
    """Every lane's ``rls_scan``, ``rls_fit`` and ``rls_parallel`` estimate
    agrees with the reference's to 1e-8 relative; on CPU tensors ``"cuda"``
    runs K5's plain version, once a segment."""
    fleet, ref = fleet_and_reference
    rollout_kernel.reset_counts()
    out = identify_contacts(fleet, backend=backend)
    assert rollout_kernel.reference_count() == (SAMPLES if backend == "cuda" else 0)
    assert rollout_kernel.launch_count() == 0
    for name, expected in zip(("scan", "fit", "parallel"), ref):
        np.testing.assert_allclose(getattr(out, name).numpy(), expected, rtol=REL_TOL,
                                   atol=0, err_msg=name)
    true = torch.cat([fleet.cparams.spring_coeff, fleet.cparams.damper_coeff], -1)
    assert torch.equal(out.true, true)


def test_identify_contacts_checks_the_noise_it_was_given():
    """The fleet's noise sets the number of samples: one segment, one
    measurement and one filter step each."""
    fleet = contact_identification_fleet(2, samples=3, device="cpu", dtype=torch.float64)
    rollout_kernel.reset_counts()
    out = identify_contacts(fleet, backend="cuda")
    assert rollout_kernel.reference_count() == 3
    assert out.scan.shape == out.fit.shape == out.parallel.shape == (2, 2)


class TestContactIdentification:
    """``tests/test_rls.py::TestContactIdentification`` on the port: RLS on
    the contact regressor identifies (k, b) from noisy wrenches of a
    wandering frame."""

    def test_identifies_spring_damper_from_wrench(self):
        true_k, true_b = 2000.0, 100.0
        rng = np.random.default_rng(0)
        T = 2000
        draws = dict(position=rng.uniform(-0.02, 0.02, (T, 3)),
                     rotvec=rng.uniform(-0.2, 0.2, (T, 3)),
                     linear_velocity=rng.uniform(-1, 1, (T, 3)),
                     angular_velocity=rng.uniform(-1, 1, (T, 3)))
        noise = rng.normal(0, 0.05, (T, 6))
        keys = {"lambda": 1.0, "measurement_covariance": [0.05 ** 2] * 6,
                "state": [0.0, 0.0], "state_covariance": [1e6, 1e6]}
        t = lambda x: torch.as_tensor(x, dtype=torch.float64)
        cparams = tcontact.ContactParams(t(0.12), t(0.09), t(true_k), t(true_b))
        states = tcontact.ContactState(
            position=t(draws["position"]), rotation=so3_exp(t(draws["rotvec"])),
            linear_velocity=t(draws["linear_velocity"]),
            angular_velocity=t(draws["angular_velocity"]),
            null_position=torch.zeros((T, 3), dtype=torch.float64),
            null_rotation=torch.eye(3, dtype=torch.float64).expand(T, 3, 3))
        regressors = tcontact.regressor(cparams, states)
        wrenches = tcontact.contact_wrench(cparams, states) + t(noise)
        params, state0 = init_from_handler(ParametersHandler(keys), device="cpu",
                                           dtype=torch.float64)
        final = rls_scan(params, state0, regressors, wrenches)
        np.testing.assert_allclose(final.theta.numpy(), [true_k, true_b], rtol=1e-2)


def study(lanes: int = 4096, samples: int = 200) -> dict:
    """Float32 on the CPU, both packages, the fleet ``chip_smoke.py`` runs
    cut to ``lanes``: the share of lanes within 1 % of the truth, the median
    and max relative error of each RLS form, and how far the forms and the
    packages part lane by lane."""
    fleet = contact_identification_fleet(lanes, samples=samples, seed=0, device="cpu",
                                         dtype=torch.float32)
    t0 = time.perf_counter()
    ref = reference_identification(fleet, samples, STEPS, jnp.float32)
    t1 = time.perf_counter()
    port = identify_contacts(fleet, backend="cuda")
    t2 = time.perf_counter()
    true = port.true.double().numpy()

    def accuracy(est):
        rel = np.abs(np.asarray(est, np.float64) - true) / true
        return {"within_1pct_k": int((rel[:, 0] <= 0.01).sum()),
                "within_1pct_b": int((rel[:, 1] <= 0.01).sum()),
                "median_rel_k": float(np.median(rel[:, 0])),
                "median_rel_b": float(np.median(rel[:, 1])),
                "max_rel_k": float(rel[:, 0].max()), "max_rel_b": float(rel[:, 1].max())}

    def parted(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float((np.abs(a - b) / np.abs(b)).max())

    out = {"lanes": lanes, "samples": samples, "steps_per_sample": STEPS,
           "dtype": "float32", "seconds_blf_tpu": t1 - t0, "seconds_port": t2 - t1}
    for side, (scan, fit, par) in (("blf_tpu", ref), ("port", (port.scan, port.fit,
                                                              port.parallel))):
        out[side] = {"scan": accuracy(scan), "fit": accuracy(fit), "parallel": accuracy(par),
                     "fit_vs_scan_max_rel": parted(fit, scan),
                     "parallel_vs_scan_max_rel": parted(par, scan)}
    out["port_vs_blf_tpu_scan_max_rel"] = parted(port.scan, ref[0])
    return out


if __name__ == "__main__":
    print(json.dumps(study(), indent=1))
