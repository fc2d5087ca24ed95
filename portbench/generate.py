"""Frozen traffic generators: what every run hands the program and the reference.

Copies, frozen here so that a change to the program cannot change the
yardstick, of ``blf_tpu_torch.problems.stationary_push_recovery`` (the push
fleet), of ``gait_fleet``'s initial DCMs, and of the footstep numbers of
``blf_tpu_torch.planners.gait.footstep_plan(10, 0.15)`` (which the
configuration file ``configs/full_gait.json`` carries as data). The random
draws are made on the device with a ``torch.Generator`` seeded from the run's
seed, where the program's own generators draw with numpy on the host: the
same distributions, not the same numbers. Everything else is built from the
configuration and traffic files alone. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

__all__ = ["generator", "PushProblem", "push_problem", "push_draws",
           "dcm0_pool", "Footstep", "footsteps"]


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number; taken
    modulo 2**64, as ``manual_seed`` wants)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


class PushProblem(NamedTuple):
    """The stationary push-recovery problem: every lane stands on one stance
    (references at the origin, one support box) and is pushed by its own
    draws each tick."""

    dcm_ref: torch.Tensor      # (N+1, 2)
    zmp_ref: torch.Tensor      # (N, 2)
    poly_A: torch.Tensor       # (N, 4, 2)
    poly_b: torch.Tensor       # (N, 4)
    dcm0: torch.Tensor         # (2,)
    com0: torch.Tensor         # (2,)
    num_constraints: int       # 2N dynamics rows + 4N polygon rows


_BOX = [[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]]


def push_problem(config: dict, device, dtype=torch.float32) -> PushProblem:
    """The shared part of the push-recovery fleet from its configuration."""
    N = int(config["horizon"])
    new = dict(dtype=dtype, device=device)
    start = torch.as_tensor(config["start"], **new)
    return PushProblem(
        dcm_ref=torch.zeros((N + 1, 2), **new),
        zmp_ref=torch.zeros((N, 2), **new),
        poly_A=torch.as_tensor(_BOX, **new).repeat(N, 1, 1),
        poly_b=torch.as_tensor(config["support_box"], **new).repeat(N, 1),
        dcm0=start, com0=start.clone(),
        num_constraints=2 * N + 4 * N)


def push_draws(lanes: int, ensemble: int, sigma: float, seed: int, device,
               dtype=torch.float32) -> torch.Tensor:
    """``(lanes, ensemble, 2)`` pushes N(0, sigma): member k from seed + k, so
    member 0 is the draw of an ensemble of one."""
    return torch.stack(
        [sigma * torch.randn((lanes, 2), generator=generator(seed + k, device),
                             device=device, dtype=torch.float32)
         for k in range(ensemble)], dim=1).to(dtype)


def dcm0_pool(sets: int, lanes: int, half_width: float, seed: int, device,
              dtype=torch.float32) -> torch.Tensor:
    """``(sets, lanes, 2)`` initial DCMs drawn U(-half_width, half_width) per
    axis, made in one call on the device."""
    u = torch.rand((sets, lanes, 2), generator=generator(seed, device), device=device,
                   dtype=torch.float32)
    return ((2.0 * u - 1.0) * half_width).to(dtype)


class Footstep(NamedTuple):
    """One stance window of one foot: its ground position and its times."""

    position: tuple            # (x, y, z)
    activation_time: float
    deactivation_time: float


def footsteps(config: dict) -> Dict[str, list]:
    """The gait's stance windows by foot, as the configuration file states
    them (``[x, y, z, on, off]`` each), sorted by foot name."""
    return {foot: [Footstep(tuple(float(v) for v in w[:3]), float(w[3]), float(w[4]))
                   for w in windows]
            for foot, windows in sorted(config["footsteps"].items())}
