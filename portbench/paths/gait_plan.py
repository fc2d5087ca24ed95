"""Driver of the full-gait planner: ``blf_tpu_torch.planners.gait.plan_gait``
with ``shared=True``, one card.

A unit is one plan: the call of ``plan_gait`` over the next set of initial
DCMs of the pool (made on the device from the seed in set-up, cycled), until
its per-lane converged flags are on the host. The program is handed the
configuration's frozen stance windows as its own ``ContactList``s.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

import blf_tpu_torch.planners.gait as gait_module
from blf_tpu_torch.models.lipm import LIPMParams
from blf_tpu_torch.mpc.dcm import DCMWeights
from blf_tpu_torch.planners.contacts import ContactList

from portbench import generate
from portbench.paths.base import Driver
from portbench.reference import gait_plan as reference

__all__ = ["GaitPlan", "DRIVER", "contact_lists"]


class Planned(NamedTuple):
    draw: int                  # which set of the pool
    dcm: torch.Tensor          # the program's (B, N+1, 2)
    zmp: torch.Tensor          # (B, N, 2)
    converged: torch.Tensor    # (B,)


def contact_lists(config: dict) -> dict:
    """The program's ``ContactList``s of the configuration's stance windows."""
    lists = {}
    for foot, steps in generate.footsteps(config).items():
        lst = ContactList(default_name=foot)
        for st in steps:
            if not lst.add_contact(position=np.array(st.position),
                                   activation_time=st.activation_time,
                                   deactivation_time=st.deactivation_time):
                raise ValueError(f"the {foot} window {st} is rejected")
        lists[foot] = lst
    return lists


class GaitPlan(Driver):
    def __init__(self, config, traffic, seed, device, world=None):
        super().__init__(config, traffic, seed, device, world)
        f32 = dict(dtype=torch.float32, device=device)
        self.params = LIPMParams(torch.tensor(config["com_height"], **f32),
                                 torch.tensor(config["gravity"], **f32))
        self.lists = contact_lists(config)
        self.pool = generate.dcm0_pool(int(traffic["pool"]), int(traffic["lanes"]),
                                       float(traffic["dcm0_half_width"]), seed, device)
        self.count = 0
        cfg = config
        self.kwargs = dict(half_length=cfg["foot_half_length"], half_width=cfg["foot_half_width"],
                           weights=DCMWeights(**cfg["weights"]), iterations=int(cfg["iterations"]),
                           shared=True, backend=cfg["backend"], check_every=int(cfg["check_every"]),
                           **cfg["qp"])
        self._reference = None

    def unit(self):
        draw = self.count % self.pool.shape[0]
        self.count += 1
        d0 = self.pool[draw]
        plan, _ = gait_module.plan_gait(self.params, self.lists, self.config["dt"], d0, d0,
                                        **self.kwargs)
        converged = plan.qp.converged.cpu().numpy()
        self._record(Planned(draw, plan.dcm, plan.zmp, plan.qp.converged))
        return self.lanes_per_unit, self.lanes_per_unit - int(np.count_nonzero(converged))

    def release(self):
        self.params = None

    def compare(self, precision="float64") -> Dict[str, float]:
        if self._reference is None:
            self._reference = reference.prepare(self.config)
        gaps = [self._judge(p, precision) for p in self.checked()]
        return {name: max(g[i] for g in gaps) for i, name in
                enumerate(("dcm_gap_m", "zmp_gap_m", "converged_mismatch_share"))}

    def _judge(self, planned: Planned, precision: str):
        d0 = self.pool[planned.draw]
        ref = reference.plan(self._reference, d0, "float64")
        got = planned if precision == "float64" else reference.plan(self._reference, d0, precision)
        gap = lambda a, b: float(torch.nan_to_num((a.double() - b).abs(), nan=torch.inf).max())
        return (gap(got.dcm, ref.dcm), gap(got.zmp, ref.zmp),
                float((got.converged.cpu() != ref.converged.cpu()).double().mean()))


DRIVER = GaitPlan
