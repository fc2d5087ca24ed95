"""Driver of the push-recovery fleet tick: ``blf_tpu_torch.parallel.sweep.
make_fleet_step``'s ``step``, closed loop, one card.

A unit is one tick: the call of ``step`` from the last tick's state, until
the per-lane status and the first-knot consensus plan are on the host. Every
scenario keeps its own K push draws on every tick (member k from seed + k).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from blf_tpu_torch.models.lipm import LIPMParams
from blf_tpu_torch.mpc.dcm import DCMWeights
from blf_tpu_torch.parallel.sweep import init_fleet, make_fleet_step

from portbench import generate
from portbench.paths.base import Driver
from portbench.reference import fleet_tick as reference

__all__ = ["FleetTick", "DRIVER"]


class Tick(NamedTuple):
    state_in: object           # the program's FleetState before the tick
    result: object             # its TickResult
    state_out: object          # its FleetState after the tick


def program_step(config: dict, device, mesh=None):
    """``make_fleet_step`` as the configuration states it."""
    params = LIPMParams(torch.tensor(config["com_height"], dtype=torch.float32),
                        torch.tensor(config["gravity"], dtype=torch.float32))
    return make_fleet_step(
        params, config["dt"], DCMWeights(**config["weights"]),
        iterations=int(config["iterations"]), rls_lambda=config["rls"]["lambda"],
        meas_noise=config["rls"]["meas_noise"], device=device, mesh=mesh,
        backend=config["backend"], check_every=int(config["check_every"]), **config["qp"])


class FleetTick(Driver):
    def __init__(self, config, traffic, seed, device, world=None):
        super().__init__(config, traffic, seed, device, world)
        lanes, K = int(traffic["lanes"]), int(traffic["ensemble"])
        mesh, data, shards, member, members = None, 0, 1, 0, 1
        if "mesh" in traffic:
            # a (data, model) mesh: ``lanes`` scenarios a data shard, the K
            # members of the ensemble split over the model axis
            from blf_tpu_torch.parallel.mesh import axis_index, axis_size, make_mesh

            mesh = make_mesh(int(traffic["mesh"]["devices"]),
                             model_axis=int(traffic["mesh"]["model_axis"]), device=device.type)
            data, shards = axis_index(mesh, "data"), axis_size(mesh, "data")
            member, members = axis_index(mesh, "model"), axis_size(mesh, "model")
        self.K, self.K_local, self.scenarios = K, K // members, lanes * shards
        self.lanes_per_unit = lanes * self.K_local
        self.problem = generate.push_problem(config, device)
        # the whole ensemble of this data shard (the reference's), and this
        # rank's members of it (the program's)
        self.push_all = generate.push_draws(lanes * shards, K, float(traffic["push_sigma"]),
                                            seed, device)[data * lanes:(data + 1) * lanes]
        self.push = self.push_all[:, member * self.K_local:(member + 1) * self.K_local].contiguous()
        self.own_members = slice(member * self.K_local, (member + 1) * self.K_local)
        self.mesh = mesh
        self.step = program_step(config, device, mesh)
        pb = self.problem
        self.refs = (pb.dcm_ref, pb.zmp_ref, pb.poly_A, pb.poly_b)
        self.state = init_fleet(lanes, int(config["horizon"]), pb.num_constraints,
                                pb.dcm0, pb.com0, device=device, dtype=torch.float32)
        self._reference = None

    def unit(self):
        state_in = self.state
        state, result = self.step(state_in, self.push, *self.refs)
        status = result.status.cpu().numpy()
        result.consensus_zmp0.cpu()
        self.state = state
        self._record(Tick(state_in, result, state))
        return self.lanes_per_unit, self.K_local * int(np.count_nonzero(status))

    def release(self):
        self.state = self.step = self.mesh = None

    def compare(self, precision="float64") -> Dict[str, float]:
        """Per tick: the first-knot plan and the advanced state (DCM, CoM, RLS
        estimate) over the scenarios the reference converges, the same over
        those it does not (0 where there are none: such a lane's QP has no
        point the fixed iteration count reaches, so its gap is apart), and
        the share of scenarios whose status differs."""
        if self._reference is None:
            self._reference = reference.prepare(self.config)
        names = ("plan_gap_m", "state_gap_m", "unconverged_gap_m", "status_mismatch_share",
                 "converged_share_gap")
        gaps = [self._judge(t, precision) for t in self.checked()]
        out = {name: max(g[i] for g in gaps) for i, name in enumerate(names)}
        # the cold tick from the initial state: the reference converges every
        # lane there, so it has no unconverged gap
        cold = self._judge(self.cold, precision)
        out.update({"cold_" + name: cold[i] for i, name in enumerate(names) if i != 2})
        return out

    def _judge(self, tick: Tick, precision: str):
        s = tick.state_in
        inp = reference.TickInput(s.dcm, s.com, s.warm_zmp, s.warm_y, s.offset_theta,
                                  s.offset_cov, s.warm_s, self.push_all)
        ref = reference.tick(self._reference, inp, "float64")
        if precision == "float64":
            out, r = tick.state_out, tick.result
            got = (r.consensus_zmp0, out.dcm, out.com, out.offset_theta, r.status,
                   float(r.stats.num_converged))
        else:
            c = reference.tick(self._reference, inp, precision)
            got = (c.zmp0, c.dcm, c.com, c.theta, c.status,
                   self._fleet_converged(c.converged))
        lane = lambda a, b: torch.nan_to_num((a.double() - b).abs(), nan=torch.inf).amax(-1)
        plan = lane(got[0], ref.zmp0)
        state = torch.stack([lane(got[1], ref.dcm), lane(got[2], ref.com),
                             lane(got[3], ref.theta)]).amax(0)
        converged = ref.status == 0
        worst = lambda t, mask: float(t[mask].max()) if bool(mask.any()) else 0.0
        mismatch = float((got[4].to(ref.status) != ref.status).double().mean())
        stats = abs(got[5] - self._fleet_converged(ref.converged)) / self.scenarios
        return (worst(plan, converged), worst(state, converged),
                worst(torch.maximum(plan, state), ~converged), mismatch, stats)

    def _fleet_converged(self, converged: torch.Tensor) -> float:
        """The fleet statistic ``num_converged`` from per-member flags of
        this data shard ``(B, K)``: this rank's members' converged lanes,
        summed over every rank, over K (the mean over the ensemble)."""
        own = float(converged[:, self.own_members].sum())
        total = own if self.world is None else self.world.sum([own])[0]
        return total / self.K


DRIVER = FleetTick
